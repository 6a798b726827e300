"""Mean wall of the engine's ticks (TTSEngine.tick_walls) in the window
before the trace starts: the trace (the window's last seconds) slows the
host, so the ticks under it are left out."""


def hook(ctx, system):
    engine = system["engine"]
    ctx.tracer.probes["engine_ticks"] = lambda: len(engine.tick_walls)


def read(ctx):
    engine, a = ctx.counters.get("engine"), ctx.counters.get("engine_start")
    b = ctx.tracer.marks.get(("engine_ticks", "start"))
    if engine is None or a is None or b is None or b <= a[0]:
        return None
    walls = engine.tick_walls[a[0]:b]
    return 1e3 * sum(walls) / len(walls)
