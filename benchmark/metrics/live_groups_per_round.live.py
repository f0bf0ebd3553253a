"""(Row, group) pairs a round whose verify tail ran, counted by the program
at ``collect.unpack`` from the payload (the counter ``live_groups``: a
group with a position below the sentinel), over the traced window's rounds
(round ids with a ``session.collect`` span). None where the program counts
nothing."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    rounds = {s.round for s in profiling.spans() if s.name == "session.collect" and s.round >= 0}
    if not rounds:
        return None
    return profiling.counters().get("live_groups", 0) / len(rounds)
