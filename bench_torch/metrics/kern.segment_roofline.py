"""fused_segment_decode's device time per frame against its byte bound
(rooflines/fused_segment_decode.py) at the card's HBM peak: the mean
frame's bound over the mean record's time per frame, in the traced window.
Frames and launches in the window come from the kernel's own counters."""

from common import HERE, load_module, peak, request_rows


def hook(ctx, system):
    from pocket_tts_tpu_torch.ops.fused_segment import fused_segment_decode

    ctx.tracer.probes["segment_frames"] = lambda: fused_segment_decode.frames
    ctx.tracer.probes["segment_launches"] = lambda: fused_segment_decode.launches


def read(ctx):
    roof = load_module(HERE / "rooflines" / "fused_segment_decode.py")
    t, bw = ctx.tracer, peak(ctx, "hbm_bytes_per_s")
    frames, launches = t.delta("segment_frames"), t.delta("segment_launches")
    times = t.kernel_times(roof.KERNEL)
    if bw is None or not frames or not launches or not times:
        return None
    # The mean attention rows of the window's frames.
    rows = [n for r in ctx.window_requests() for n, _ in request_rows(ctx, r)]
    mean_rows = sum(rows) / len(rows)
    per_frame = sum(times) / len(times) * launches / frames
    return 100.0 * roof.frame_bytes(ctx.config["model"], mean_rows) / bw / per_frame
