"""Mean host time per engine tick spent enqueuing the tick's plan (the
program's engine.apply span: the prefill, the row moves and the segment's
launches), over the engine.tick spans that engine.tick_ms reads: from the
window's opening to the trace's start."""

import program_spans


def hook(ctx, system):
    program_spans.attach(ctx)


def read(ctx):
    recs = program_spans.records(ctx)
    if not recs:
        return None
    n, parts = program_spans.tick_parts_ms(ctx, recs)
    return parts.get("engine.apply", 0.0) if n else None
