"""Host time to enqueue a decode segment (the program's generate.segment
span: the noise draw and run_segment's launches) per frame it decodes (its
S attribute), summed over the segments in the window and clear of the
trace: the profiler slows each launch, so the traced seconds are left out."""

import program_spans


def hook(ctx, system):
    program_spans.attach(ctx)


def read(ctx):
    recs = program_spans.records(ctx)
    if not recs:
        return None
    return program_spans.per_frame_us(program_spans.untraced(ctx, recs, "generate.segment"))
