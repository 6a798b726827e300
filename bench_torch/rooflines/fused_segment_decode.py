"""Bytes one frame of the B=1 segment kernel has to read: every weight of
the backbone (int8 matrices, float32 row scales and norm rows) and of the
flow head (bf16 matrices, float32 biases), once per frame since frame f+1
needs frame f's latent, plus the K and V rows (bf16) of every layer that
the frame's attention covers. Counted from the configuration's shapes."""

KERNEL = "segment_decode_kernel"  # the CUDA kernel's name in the trace


def weight_bytes(model: dict) -> int:
    t, fl = model["flow_lm"]["transformer"], model["flow_lm"]["flow"]
    E, L, F = t["d_model"], t["num_layers"], t["d_model"] * t["hidden_scale"]
    mc, depth = fl["dim"], fl["depth"]
    ld = model["mimi"]["quantizer"]["dimension"]
    backbone = L * (4 * E * E + 2 * E * F) + E * ld  # int8 codes
    backbone += 4 * (L * (3 * E + E + F + E) + E)  # float32 row scales
    backbone += 4 * (L * 4 * E + 2 * E + E + 1 + ld)  # norm rows, EOS row and bias, BOS
    head = 2 * (mc * E + mc * ld + (depth * 3 * mc + 2 * mc) * mc + 2 * depth * mc * mc + ld * mc)  # bf16
    head += 4 * (mc + mc + mc + depth * 3 * mc + 2 * mc + 2 * depth * mc + 2 * depth * mc + ld)  # float32 rows
    return backbone + head


def frame_bytes(model: dict, valid_rows: float) -> float:
    """Bytes of one frame whose attention covers `valid_rows` cache rows."""
    t = model["flow_lm"]["transformer"]
    return weight_bytes(model) + valid_rows * t["num_layers"] * 2 * t["d_model"] * 2
