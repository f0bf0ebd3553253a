"""Share of the traced window in which no kernel, copy or memset runs: the
union of their intervals, not their sum."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None and t.window_s > 0 else None
