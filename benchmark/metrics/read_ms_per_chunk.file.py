"""Host ms a chunk spends in the streaming loop's read (WAV bytes off the
file), from the detector's ``last_run_stats`` summed over the window."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["read_s"] / w["chunks"] if w.get("chunks") else None
