"""The device trace of a traced run: torch.profiler with CUDA activity only
(CUPTI's kernel, copy and set records; no host operator records, which
would slow the host-bound paths several times), over the first
`trace_seconds` of the window. Timestamps are epoch nanoseconds, the clock
of the benchmark's spans (time.time_ns()), so each idle gap is named by the
span the host was in."""

from __future__ import annotations

import time
from collections import defaultdict


class Tracer:
    """Traces `seconds` of the window from its opening, or with at_end the
    last `seconds` of it (the traffic driver then stops it at the close)."""

    def __init__(self, torch, seconds: float, at_end: bool = False, on_card: bool = True):
        self.torch, self.seconds, self.at_end, self.on_card = torch, float(seconds), at_end, on_card
        self.prof = None
        self.stop_span = (0.0, 0.0)  # monotonic seconds the stopping of the trace took
        self.start_at = float("inf")  # time.time_ns() at which the trace starts
        self.t0_ns = self.t1_ns = 0
        self.stopped = False
        self.marks: dict = {}  # counter snapshots at start and stop, by name
        self.probes: dict = {}  # name -> function returning a counter's value

    def prime(self) -> None:
        """Trace a moment before the window: the profiler's first start sets
        CUPTI up, which takes seconds, so the window's start is quick."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA if self.on_card else ProfilerActivity.CPU]):
            self.torch.zeros(1, device="cuda" if self.on_card else "cpu").add_(1)
            if self.on_card:
                self.torch.cuda.synchronize()

    def paused(self, window: tuple[float, float]) -> float:
        """Seconds of `window` (monotonic) spent stopping the trace."""
        a, b = self.stop_span
        return max(0.0, min(b, window[1]) - max(a, window[0]))

    def open(self, window_seconds: float) -> None:
        """The window opens: start now, or schedule the start."""
        self.start_at = time.time_ns() + (max(0.0, window_seconds - self.seconds) * 1e9 if self.at_end else 0)
        self.poll()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # A rehearsal off the card traces the host operators instead.
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.on_card else ProfilerActivity.CPU])
        self.prof.start()
        self._snapshot("start")
        self.t0_ns = time.time_ns()

    def poll(self) -> None:
        if self.prof is None and time.time_ns() >= self.start_at:
            self.start()
        elif self.prof is not None and not self.stopped and time.time_ns() - self.t0_ns >= self.seconds * 1e9:
            self.stop()

    def stop(self) -> None:
        if self.stopped or self.prof is None:
            return
        t = time.monotonic()
        if self.on_card:
            self.torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._snapshot("stop")
        self.prof.stop()
        self.stopped = True
        self.stop_span = (t, time.monotonic())

    def _snapshot(self, when: str) -> None:
        for name, probe in self.probes.items():
            self.marks[(name, when)] = probe()

    def delta(self, name: str):
        """A probed counter's change over the traced window, or None."""
        a, b = self.marks.get((name, "start")), self.marks.get((name, "stop"))
        return None if a is None or b is None else b - a

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def device_events(self) -> list[tuple[str, int, int]]:
        """(name, start ns, end ns) of every device record in the window."""
        if not hasattr(self, "_events"):
            device = self.torch.autograd.DeviceType.CUDA if self.on_card else self.torch.autograd.DeviceType.CPU
            events = []
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() == device and e.duration_ns() > 0:
                    s = e.start_ns()
                    events.append((e.name(), s, s + e.duration_ns()))
            events.sort(key=lambda x: x[1])
            self._events = events
        return self._events

    def kernel_times(self, name: str) -> list[float]:
        """Seconds of each record of the kernels whose name holds `name`."""
        return [(e - s) / 1e9 for n, s, e in self.device_events() if name in n]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of device records, clipped to the window."""
        out: list[list[int]] = []
        for _, s, e in self.device_events():
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        gaps, t = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1_ns > t:
            gaps.append((t, self.t1_ns))
        return gaps

    def breakdown(self, spans: list[tuple[str, int, int]]) -> dict:
        """The 10 device operations that took most time, and the 10 longest
        idle gaps, each named by the innermost benchmark span around its
        middle ("no span" outside them)."""
        by_name: dict = defaultdict(float)
        for n, s, e in self.device_events():
            by_name[n] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            inside = [(n, a, b) for n, a, b in spans if a <= mid <= b]
            name = min(inside, key=lambda x: x[2] - x[1])[0] if inside else "no span"
            named.append([name, (e - s) / 1e9])
        return {"device_ops": [[n[:200], t] for n, t in ops], "idle_gaps": named}
