"""Host ms a station's row spends in the bank's staging copy ("pack" of
``models/bank.py::dispatch_phase_seconds``), over the window."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["pack_s"] / w["rows"] if w.get("rows") else None
