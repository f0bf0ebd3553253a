"""Host ms a round waits in ``collect`` for its payload (the spans
``collect.wait``: the CUDA event's synchronize), over the traced window's
rounds (round ids with a ``session.collect`` span). None where the program
records no spans."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    rounds = {s.round for s in spans if s.name == "session.collect" and s.round >= 0}
    if not rounds:
        return None
    wait = sum(s.end_ns - s.start_ns for s in spans if s.name == "collect.wait" and s.round in rounds)
    return 1e-6 * wait / len(rounds)
