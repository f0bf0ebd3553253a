"""Host ms a round spends loading and replaying its captured class steps
(the spans ``step.load`` and ``step.replay``: the copies into the static
inputs, the graph launches and the payloads' copy out), over the traced
window's rounds (round ids with a ``session.collect`` span). None where the
program records no spans."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    rounds = {s.round for s in spans if s.name == "session.collect" and s.round >= 0}
    if not rounds:
        return None
    launch = sum(s.end_ns - s.start_ns for s in spans
                 if s.name in ("step.load", "step.replay") and s.round in rounds)
    return 1e-6 * launch / len(rounds)
