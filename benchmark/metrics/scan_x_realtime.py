"""Audio seconds the window scanned over its wall seconds (host clock): every
recording begun in the window is scanned whole and counted, and the window
ends when the last one ends."""


def read(ctx):
    w = ctx.window
    return w["audio_s"] / w["wall_s"] if w.get("chunks") else None
