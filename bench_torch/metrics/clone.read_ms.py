"""Mean wall of the program's clone.read span in the window and clear of
the trace: reading a voice WAV and resampling it on the host, before the
Mimi encoder."""

import program_spans


def hook(ctx, system):
    program_spans.attach(ctx)


def read(ctx):
    recs = program_spans.records(ctx)
    if not recs:
        return None
    reads = program_spans.untraced(ctx, recs, "clone.read")
    return sum(r.end_ns - r.start_ns for r in reads) / 1e6 / len(reads) if reads else None
