"""Device ms a chunk: the kernels' traced time in the traced window over the
chunks scanned in it."""


def read(ctx):
    t, w = ctx.trace, ctx.traced
    return 1e3 * t.device_s / w["chunks"] if t is not None and w and w.get("chunks") and t.device_s > 0 else None
