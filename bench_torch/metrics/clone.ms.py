"""Mean wall of get_state_for_audio_prompt(path) in the window (read,
resampling, Mimi encoder, speaker projection, prefill), between device
synchronisations: the benchmark's span around each clone."""


def read(ctx):
    spans = ctx.span_seconds("clone")
    return 1e3 * sum(spans) / len(spans) if spans else None
