"""Host ms of ``MultiStreamSession.dispatch`` a round (the benchmark's own
span around the call), the mean over the window."""


def read(ctx):
    d = ctx.window.get("dispatch")
    return 1e3 * sum(d) / len(d) if d else None
