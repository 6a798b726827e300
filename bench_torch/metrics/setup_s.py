"""Set-up time: process start to the window's opening (imports, the kernels'
builds or loads, the model, the warm-up)."""


def read(ctx):
    return ctx.setup_s
