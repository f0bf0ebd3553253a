"""Device ms a round: the kernels' traced time in the traced window over the
rounds served in it."""


def read(ctx):
    t, w = ctx.trace, ctx.traced
    return 1e3 * t.device_s / w["rounds"] if t is not None and w and w.get("rounds") and t.device_s > 0 else None
