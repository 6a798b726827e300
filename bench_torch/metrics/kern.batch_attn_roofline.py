"""batch_decode_attention's device time per call against its byte bound
(rooflines/batch_decode_attention.py: the K and V of each stream's valid
rows) at the card's HBM peak, over the generate_audio_batch calls that the
trace holds: their mean call's bound over the mean record's time. A call of
the API decodes F frames of every stream, one kernel launch per layer and
frame (F from the kernel's launch counter), though stream b needs only its
own frames, min(F, max_frames of its tokens); its attention at frame f
covers the voice prompt, its text and f + 1 frames, and a frame past its
own needs none."""

from common import HERE, load_module, peak


def hook(ctx, system):
    from pocket_tts_tpu_torch.ops.batch_attention import batch_decode_attention

    model = system["model"]
    api = model.generate_audio_batch
    calls = ctx.counters["attn_calls"] = []

    def counted(voice, texts, *args, **kwargs):
        before = batch_decode_attention.launches
        out = api(voice, texts, *args, **kwargs)
        calls.append((list(texts), batch_decode_attention.launches - before, ctx.tracer.stopped))
        return out

    model.generate_audio_batch = counted


def read(ctx):
    roof = load_module(HERE / "rooflines" / "batch_decode_attention.py")
    ref = load_module(HERE / "references" / f"{ctx.config['reference']}.py")
    t, bw = ctx.tracer, peak(ctx, "hbm_bytes_per_s")
    times = t.kernel_times(roof.KERNEL)
    cfg = ctx.config["model"]
    layers = cfg["flow_lm"]["transformer"]["num_layers"]
    tok = ref.HashTokenizer(cfg["flow_lm"]["lookup_table"]["n_bins"])
    prompt = ctx.config["voice"]["prompt_frames"]
    rows = launches = 0
    for texts, n, after_trace in ctx.counters.get("attn_calls", []):
        if after_trace or n <= 0:
            continue
        frames = n // layers
        for x in texts:
            tokens = len(tok.encode(x))
            own = min(frames, ref.max_frames(tokens, cfg["mimi"]["frame_rate"]))
            rows += layers * (own * (prompt + tokens) + own * (own + 1) // 2)
        launches += n
    if bw is None or not times or not launches:
        return None
    per_call = roof.call_bytes(cfg, ctx.config["serving"]["kv_int8"], rows / launches)
    return 100.0 * per_call / bw / (sum(times) / len(times))
