"""Host ms a round spends resolving flagged rows inside ``collect`` (the
spans ``collect.flagged``: the wide reruns and the exact host path, every
route), over the traced window's rounds (round ids with a
``session.collect`` span); 0 where no row was flagged. None where the
program records no ``session.collect`` spans."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    rounds = {s.round for s in spans if s.name == "session.collect" and s.round >= 0}
    if not rounds:
        return None
    flagged = sum(s.end_ns - s.start_ns for s in spans if s.name == "collect.flagged" and s.round in rounds)
    return 1e-6 * flagged / len(rounds)
