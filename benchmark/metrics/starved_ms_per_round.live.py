"""Host ms a round leaves the card with nothing queued: from the end of
round r's last ``collect.wait`` (its payload on the host, the card's work
done) to the start of the next round's first ``step.replay``, summed over
the traced window's consecutive rounds and divided by its rounds (round ids
with a ``session.collect`` span). None where the program records no spans."""


def read(ctx):
    from audio_pattern_detector_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    rounds = sorted({s.round for s in spans if s.name == "session.collect" and s.round >= 0})
    if not rounds:
        return None
    waited, replayed = {}, {}
    for s in spans:
        if s.name == "collect.wait":
            waited[s.round] = max(waited.get(s.round, s.end_ns), s.end_ns)
        elif s.name == "step.replay":
            replayed[s.round] = min(replayed.get(s.round, s.start_ns), s.start_ns)
    starved = sum(max(0, replayed[b] - waited[a]) for a, b in zip(rounds, rounds[1:])
                  if a in waited and b in replayed)
    return 1e-6 * starved / len(rounds)
