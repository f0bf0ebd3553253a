"""Flagged-row resolutions a round, counted by the program where the bank
counts its routes (the counter ``flagged_rows``: each row rerun, class
rerun, escalated row and host-path row), over the traced window's rounds
(round ids with a ``session.collect`` span). None where the program counts
no ``flagged_rows``."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counted = profiling.counters()
    rounds = {s.round for s in profiling.spans() if s.name == "session.collect" and s.round >= 0}
    if "flagged_rows" not in counted or not rounds:
        return None
    return counted["flagged_rows"] / len(rounds)
