"""Device timing of a chain of calls for the port's measurement entry points
(bw_probe, attn_micro) and for chip_smoke.py's graph walls.

On the card the chain is captured once in a CUDA graph and each timing is
CUDA events around one replay, so the host's time to issue the calls (tens
of microseconds per Python wrapper call, often longer than a kernel) stays
out of the measurement, as it does in the JAX scripts, whose chains are one
jitted program. On the CPU the chain runs as it is, timed on the host
clock.
"""

from __future__ import annotations

import time

import torch


def best_seconds(run, repeats: int, device: torch.device, counted=()) -> float:
    """Best wall time of `repeats` runs of run() (after one warm-up run).

    On the card run() is captured once in a CUDA graph, replayed once
    untimed, then `repeats` times between CUDA events. The kernel wrappers
    count no launch while the graph is captured (ops/_cuda.count_launch);
    every replay launches what one run() launched, so each replay adds to
    every wrapper in `counted` the launches it counted in the warm-up run."""
    best = float("inf")
    if device.type != "cuda":
        run()
        for _ in range(repeats):
            t0 = time.monotonic()
            run()
            best = min(best, time.monotonic() - t0)
        return best
    before = [wrapper.launches for wrapper in counted]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # first use: builds the kernels, warms the allocator
    torch.cuda.current_stream().wait_stream(side)
    per_run = [wrapper.launches - n for wrapper, n in zip(counted, before)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()

    def replay():
        graph.replay()
        for wrapper, n in zip(counted, per_run):
            wrapper.launches += n

    replay()
    torch.cuda.synchronize()
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best
