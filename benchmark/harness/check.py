"""Whether what the timed path produced is correct: its events against the
plain reference's on a sample of the chunks the window served, drawn from
the seed. The driver of the cell (``benchmark/drivers/``) says what the
sample is drawn from and pairs each sampled item's events.

A reference event (clip, seconds) matches the program's nearest event of
the same clip within ``MATCH_S``. Three numbers are compared, each with
its limit (PERF.md gives the readings each was set from):

* ``unmatched_events``: reference events with no program event, plus the
  program's events with no reference event (inside the interior the
  driver gives, where it gives one: a recording's chunk edges hold the
  neighbouring chunks' lookback detections).
* ``max_gap_ms``: the largest distance between matched events.
* ``events_compared``: reference events compared, at least one, so that a
  run whose sample holds no event cannot pass unseen.
"""

from __future__ import annotations

MATCH_S = 0.05
SAMPLE_SEED_TAG = 9  # the sample's generator is seeded with (seed, this)
LIMITS = {"unmatched_events": 0, "max_gap_ms": 0.0625}
MIN_EVENTS = 1

Events = list[tuple[str, float]]


def match(ref: Events, prog: Events, interior: tuple[float, float] | None) -> tuple[int, list[float]]:
    """(unmatched, gaps in seconds) of one sampled chunk."""
    used: set[int] = set()
    gaps: list[float] = []
    unmatched = 0
    for clip, t in ref:
        best, gap = None, None
        for j, (c2, t2) in enumerate(prog):
            if c2 == clip and j not in used and abs(t2 - t) <= MATCH_S and (gap is None or abs(t2 - t) < gap):
                best, gap = j, abs(t2 - t)
        if best is None:
            unmatched += 1
        else:
            used.add(best)
            gaps.append(gap)
    for j, (_, t2) in enumerate(prog):
        if j not in used and (interior is None or interior[0] <= t2 <= interior[1]):
            unmatched += 1
    return unmatched, gaps


def judge(pairs: list[tuple[Events, Events, tuple[float, float] | None]]) -> tuple[bool, dict]:
    """(correct, checks): each number compared beside its limit."""
    unmatched = 0
    gaps: list[float] = []
    compared = 0
    for ref, prog, interior in pairs:
        u, g = match(ref, prog, interior)
        unmatched += u
        gaps += g
        compared += len(ref)
    max_gap_ms = 1e3 * max(gaps, default=0.0)
    checks = {
        "unmatched_events": {"value": unmatched, "limit": LIMITS["unmatched_events"], "rule": "<="},
        "max_gap_ms": {"value": max_gap_ms, "limit": LIMITS["max_gap_ms"], "rule": "<="},
        "events_compared": {"value": compared, "limit": MIN_EVENTS, "rule": ">="},
    }
    correct = (unmatched <= LIMITS["unmatched_events"] and max_gap_ms <= LIMITS["max_gap_ms"]
               and compared >= MIN_EVENTS)
    return correct, checks


def lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})" for name, c in checks.items()]


def stratified(rng, every: list, marked: list, k: int, k_marked: int) -> list:
    """``k`` of ``every``, drawn from the seed's generator ``rng``: up to
    ``k_marked`` from ``marked`` (where airings lie), the rest from all the
    others."""
    picked: list = []
    if marked:
        idx = rng.choice(len(marked), size=min(k_marked, len(marked)), replace=False)
        picked = [marked[i] for i in sorted(idx)]
    taken = set(picked)
    rest = [x for x in every if x not in taken]
    idx = rng.choice(len(rest), size=min(k - len(picked), len(rest)), replace=False)
    return sorted(picked + [rest[i] for i in sorted(idx)])


def draw(rng, traffic, population: tuple[list, list]) -> list:
    """The sample the check compares: ``traffic``'s ``check`` counts drawn
    from a driver's ``population`` (every item, and those where airings
    lie) with the seed's generator ``rng``."""
    every, marked = population
    return stratified(rng, every, marked, traffic.check_chunks, traffic.check_marked)
