"""The readers of the program's spans (program_spans.py and the metrics
that call it) on known records, on a stand-in port without the span
recorder, and in a traced run of each cell on the CPU at a tiny size."""

import sys
import time
import types

import pytest
import torch

import program_spans
from common import HERE, Context, Request, load_module

from pocket_tts_tpu_torch.utils.trace import Record

NEW_METRICS = {  # the cells whose traced run reads each metric
    "engine.queue_wait_p95_ms": "engine64-poisson",
    "engine.launch_ms": "engine64-poisson",
    "engine.wait_ms": "engine64-poisson",
    "generate.launch_us_per_frame": "stream-b1",
    "clone.read_ms": "clone-stream",
}
MS = 1_000_000  # ns


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py")


def ctx_with(recs, window=(10.0, 20.0), trace=(15 * 10**9, 18 * 10**9)):
    """A finished run's context: `recs` recorded, the window in monotonic
    seconds (the clocks' offset 0, so second s is s * 1e9 ns), a trace over
    `trace` ns with no idle gap, whose stopping took half a second more."""
    ctx = Context({"params": {}}, {}, 1, 10.0, True, torch.device("cpu"), time.monotonic())
    ctx.window = window
    ctx.tracer = types.SimpleNamespace(t0_ns=trace[0], t1_ns=trace[1], stopped=False,
                                       stop_span=(trace[1] / 1e9, trace[1] / 1e9 + 0.5))
    ctx.counters.update({"program_spans": list(recs), "program_span_ids": set(), "epoch_of_monotonic_ns": 0})
    return ctx


def rec(name, start_ms, end_ms, id_, parent=None, **attrs):
    return Record(name, start_ms * MS, end_ms * MS, 1, id_, parent, attrs)


def test_engine_tick_parts_over_the_ticks_before_the_trace():
    # Two ticks inside the window before the trace (10 s .. 15 s), one before the window, one under the trace.
    recs = [rec("engine.tick", 9_000, 9_100, 1), rec("engine.apply", 9_000, 9_090, 2, 1),
            rec("engine.tick", 11_000, 11_100, 3), rec("engine.admit", 11_000, 11_002, 4, 3),
            rec("engine.apply", 11_002, 11_062, 5, 3), rec("engine.op.segment", 11_010, 11_060, 6, 5),
            rec("engine.fetch", 11_062, 11_082, 7, 3), rec("engine.deliver", 11_082, 11_090, 8, 3),
            rec("engine.tick", 12_000, 12_200, 9), rec("engine.apply", 12_000, 12_100, 10, 9),
            rec("engine.fetch", 12_100, 12_140, 11, 9),
            rec("engine.tick", 16_000, 16_300, 12), rec("engine.apply", 16_000, 16_250, 13, 12)]
    ctx = ctx_with(recs)
    n, parts = program_spans.tick_parts_ms(ctx, recs)
    assert n == 2
    assert parts == pytest.approx({"engine.tick": 150.0, "engine.admit": 1.0, "engine.apply": 80.0,
                                   "engine.fetch": 30.0, "engine.deliver": 4.0})
    assert reader("engine.launch_ms").read(ctx) == pytest.approx(80.0)
    assert reader("engine.wait_ms").read(ctx) == pytest.approx(30.0)
    assert reader("engine.launch_ms").read(ctx_with(recs[:2])) is None  # no tick in the window


def queue_ctx(waits, dues, drained_at):
    """A context whose engine handles waited `waits` seconds (None: never
    admitted), due at `dues` (monotonic seconds), the first not in the window."""
    ctx = ctx_with([])
    handles = []
    for i, (wait, due) in enumerate(zip(waits, dues)):
        r = Request(f"text {i}", "alba", due=due, in_window=i >= 1)
        handles.append(types.SimpleNamespace(text=r.text, submit_time=due,
                                             admit_time=None if wait is None else due + wait))
        ctx.requests.append(r)
    ctx.drained_at = drained_at
    ctx.counters["engine_handles"] = handles
    return ctx


def p95(values):
    v = sorted(values)
    pos = (len(v) - 1) * 0.95
    return v[int(pos)] + (v[int(pos) + 1] - v[int(pos)]) * (pos - int(pos))


def test_queue_wait_p95_counts_a_request_never_admitted_until_the_drain():
    dues = [10.0 + 0.2 * i for i in range(20)]  # all before the trace (15 s)
    ctx = queue_ctx([0.001 * i for i in range(19)] + [None], dues, drained_at=dues[-1] + 0.5)
    expected = 1e3 * p95([0.001 * i for i in range(1, 19)] + [0.5])  # the last waited 500 ms, never admitted
    assert reader("engine.queue_wait_p95_ms").read(ctx) == pytest.approx(expected)
    ctx.counters["engine_handles"][3].text = "another text"  # the handles are not the requests': nothing is read
    assert reader("engine.queue_wait_p95_ms").read(ctx) is None


def test_queue_wait_p95_leaves_the_traced_tail_out():
    """Requests due under the trace (15 s to the window's close) wait long,
    as the profiler slows the host: the p95 is the one before them."""
    waits, dues = [0.001 * i for i in range(30)], [10.0 + 0.16 * i for i in range(30)]
    before = reader("engine.queue_wait_p95_ms").read(queue_ctx(waits, dues, drained_at=30.0))
    tail = [15.0 + 0.1 * i for i in range(40)]
    slow = queue_ctx(waits + [2.0] * 40, dues + tail, drained_at=30.0)
    assert before == pytest.approx(1e3 * p95([w for w, d in zip(waits[1:], dues[1:]) if d < 15.0]))
    assert reader("engine.queue_wait_p95_ms").read(slow) == pytest.approx(before)


def test_launch_per_frame_over_the_untraced_segments():
    recs = [rec("generate.segment", 14_000, 14_004, 1, S=8),  # before the trace
            rec("generate.segment", 15_000, 15_002, 2, S=1), rec("segment.flow", 15_000, 15_001, 3, 2),
            rec("generate.segment", 15_010, 15_016, 4, S=32), rec("generate.fetch", 15_016, 15_020, 5),
            rec("generate.segment", 17_999, 18_001, 6, S=8),  # across the trace's end
            rec("generate.segment", 18_200, 18_203, 7, S=8),  # while the trace stops
            rec("generate.segment", 19_000, 19_005, 8, S=16),  # after it
            rec("generate.segment", 20_500, 20_502, 9, S=8)]  # past the window
    ctx = ctx_with(recs)
    assert reader("generate.launch_us_per_frame").read(ctx) == pytest.approx(9_000 / 24)
    assert reader("generate.launch_us_per_frame").read(ctx_with(recs[1:5])) is None  # only traced segments


def test_clone_read_mean_in_the_window():
    recs = [rec("clone.read", 9_990, 9_999, 1), rec("clone.read", 10_100, 10_106, 2),
            rec("clone.encode", 10_106, 10_115, 3), rec("clone.read", 12_000, 12_010, 4),
            rec("clone.read", 16_000, 16_050, 5)]  # under the trace
    assert reader("clone.read_ms").read(ctx_with(recs)) == pytest.approx(8.0)


def test_idle_by_innermost_span_and_kind():
    program = [("engine.tick", 0, 100), ("engine.apply", 10, 60), ("engine.op.segment", 20, 50)]
    bench = [("submit", 70, 90), ("stream", 200, 300)]
    spans = program + bench
    gaps = [(30, 40), (60, 70), (75, 85), (210, 220), (400, 410)]
    by_name, by_kind = program_spans.idle_by_span(gaps, spans, {id(x) for x in program})
    assert dict(by_name) == {"engine.op.segment": 10, "engine.tick": 10, "submit": 10, "stream": 10,
                             "no span": 10}
    assert by_kind == {"program": 30, "benchmark": 10, "none": 10}
    assert program_spans.idle_by_span(gaps[:2], [], set())[1] == {"program": 0, "benchmark": 0, "none": 20}


def test_summary_lines(capsys):
    recs = [rec("engine.tick", 11_000, 11_100, 1), rec("engine.apply", 11_000, 11_090, 2, 1)]
    ctx = ctx_with(recs)
    ctx.spans = [(r.name, r.start_ns, r.end_ns) for r in recs]
    ctx.counters["program_span_ids"] = {id(x) for x in ctx.spans}
    ctx.tracer = types.SimpleNamespace(t0_ns=15_000 * MS, t1_ns=18_000 * MS, stopped=True, window_s=3.0,
                                       idle_gaps=lambda: [(15_000 * MS, 15_500 * MS)], on_card=True,
                                       device_events=lambda: [("kernel", 15_500 * MS, 18_000 * MS)])
    ctx.counters["program_trace"] = types.SimpleNamespace(disable=lambda: None)
    assert program_spans.records(ctx) is ctx.counters["program_spans"]
    program_spans.records(ctx)  # printed once
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 4
    assert "idle 0.500000 s of the 3.000000 s traced window; by innermost span: no span 0.500000 s" in err[0]
    assert err[1].endswith("program 0.0%, benchmark 0.0%, none 100.0%")
    assert err[2].endswith("less its children: ")  # no span in the traced window
    assert "engine.tick 100.000 = engine.admit 0.000 + engine.apply 90.000" in err[3] and "the rest 10.000" in err[3]


@pytest.mark.parametrize("on_card", [True, False])
def test_a_card_trace_with_copies_and_no_kernel_fails_the_run(on_card):
    copies = [("Memcpy HtoD (Pageable -> Device)", 1, 2), ("Memset (Device)", 3, 4)]
    for name in NEW_METRICS:
        ctx = ctx_with([])
        ctx.tracer.stopped, ctx.tracer.on_card = True, on_card
        ctx.tracer.device_events = lambda: copies
        if on_card:
            with pytest.raises(RuntimeError, match="2 copy records and no kernel record"):
                reader(name).read(ctx)
        else:  # a rehearsal's trace holds host operators: not checked
            reader(name).read(ctx)
        ctx.tracer.on_card = True
        ctx.tracer.device_events = lambda: [*copies, ("batch_decode_attention_kernel", 2, 3)]
        reader(name).read(ctx)  # a kernel record: the run goes on
        ctx.tracer.device_events = lambda: []
        reader(name).read(ctx)


def test_self_time_clipped_to_the_window():
    recs = [rec("engine.tick", 0, 100, 1), rec("engine.apply", 10, 60, 2, 1), rec("engine.op.segment", 20, 50, 3, 2),
            rec("engine.fetch", 60, 70, 4, 1), rec("generate.segment", 200, 300, 5)]
    got = program_spans.self_time(recs, 40 * MS, 250 * MS)
    assert dict(got) == {"engine.tick": 30 * MS, "engine.apply": 10 * MS, "engine.op.segment": 10 * MS,
                         "engine.fetch": 10 * MS, "generate.segment": 50 * MS}


@pytest.fixture
def port_without_recorder(tmp_path, monkeypatch):
    """The port as its parent commit has it: no utils/trace.py."""
    utils = tmp_path / "pocket_tts_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    (utils.parent / "__init__.py").write_text("")
    (utils / "__init__.py").write_text("")
    for name in [m for m in sys.modules if m == "pocket_tts_tpu_torch" or m.startswith("pocket_tts_tpu_torch.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(tmp_path))


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_hook_and_read_on_a_port_without_the_recorder(name, port_without_recorder):
    ctx = ctx_with([])
    del ctx.counters["program_spans"]
    submit = lambda *args, **kwargs: None  # noqa: E731
    engine = types.SimpleNamespace(submit=submit)
    m = reader(name)
    m.hook(ctx, {"engine": engine, "model": object()})
    assert m.read(ctx) is None
    assert "program_spans" not in ctx.counters and ctx.spans == []
    assert engine.submit is submit  # the engine is left as it was


@pytest.mark.parametrize("cell", ["engine64-poisson", "stream-b1", "batch64-offline", "clone-stream"])
def test_traced_rehearsal_reads_the_program_spans(cell, monkeypatch, capsys):
    """A traced run of each cell on the CPU reads its new metrics, names
    its idle gaps by the program's spans, and turns the recorder off. The
    window is long enough for work clear of the trace (3 s; 1 s in
    batch64-offline) and of its stopping, which the readers read: here the
    trace holds the host operators, and stopping it takes seconds."""
    import run
    import test_rehearsal
    from pocket_tts_tpu_torch.utils import trace

    parse = run.parse
    seconds = "4.5" if cell == "engine64-poisson" else "9"
    monkeypatch.setattr(run, "parse", lambda argv: parse([*argv[:-4], "--seconds", seconds, *argv[-2:]]))
    result = test_rehearsal.rehearse(cell, trace=1)
    assert result["correct"], result["check"]
    want = {n for n, c in NEW_METRICS.items() if c == cell or (cell == "batch64-offline" and n.startswith("gen"))}
    assert want <= set(result["rehearsal"]), result["rehearsal"]
    assert all(result["rehearsal"][n]["value"] >= 0 for n in want)
    err = capsys.readouterr().err
    assert err.count("traced window; by innermost span") == 1 and "inside a program span" in err
    assert trace.span("x") is trace.OFF
