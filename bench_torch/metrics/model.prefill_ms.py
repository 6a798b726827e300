"""Mean wall of FlowLMModel.prefill in the window (the text prefill of each
request), between device synchronisations: the benchmark's span around it."""


def hook(ctx, system):
    flow_lm = system["model"].flow_lm
    prefill = flow_lm.prefill

    def spanned(*args, **kwargs):
        with ctx.span("prefill", sync=True):
            return prefill(*args, **kwargs)

    object.__setattr__(flow_lm, "prefill", spanned)  # a frozen dataclass: set on the instance


def read(ctx):
    spans = ctx.span_seconds("prefill")
    return 1e3 * sum(spans) / len(spans) if spans else None
