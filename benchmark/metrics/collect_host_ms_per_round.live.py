"""Host ms a round spends in ``collect`` besides waiting for its payload:
the spans ``session.collect`` less their ``collect.wait`` children (the
unpack, the flagged rows, the timestamps), over the traced window's rounds
(round ids with a ``session.collect`` span). None where the program records
no spans."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    collects = {s.index: s for s in spans if s.name == "session.collect" and s.round >= 0}
    if not collects:
        return None
    total = sum(s.end_ns - s.start_ns for s in collects.values())
    wait = sum(s.end_ns - s.start_ns for s in spans if s.name == "collect.wait" and s.parent in collects)
    return 1e-6 * (total - wait) / len({s.round for s in collects.values()})
