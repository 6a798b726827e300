"""Bytes one call of the batch decode attention (one layer, one frame of
every stream) has to read: the K and V of each stream's valid cache rows,
the rows its query may attend to, whatever read limit or capacity the call
is given. int8 rows carry one float32 scale each for K and for V."""

KERNEL = "decode_attention_kernel"  # the CUDA kernel's name in the trace


def row_bytes(model: dict, kv_int8: bool) -> int:
    E = model["flow_lm"]["transformer"]["d_model"]
    return 2 * (E + 4) if kv_int8 else 2 * 2 * E


def call_bytes(model: dict, kv_int8: bool, valid_rows: float) -> float:
    """Bytes of one call whose streams hold `valid_rows` valid rows in all."""
    return valid_rows * row_bytes(model, kv_int8)
