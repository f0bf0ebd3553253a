"""The readers of the program's spans and counters, on spans a CPU session
recorded: three rounds of ``flagship64.live16`` at a test's size, its class
steps captured on a stand-in for the CUDA graph backend, under a CPU
``torch.profiler`` session as the traced window runs under the card's."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_support import tiny_cell
from harness.cell import metric_reader, reference_clips
from harness.traffic import generate

READERS = ("collect_wait_ms_per_round.live", "collect_host_ms_per_round.live", "launch_ms_per_round.live",
           "starved_ms_per_round.live", "live_groups_per_round.live")
ROUNDS = 3


class StandInGraphs:
    """A captured step's backend on any device: the capture runs the step
    once for its static output, a replay runs it again into it; nodes read
    their predicate where the step runs."""

    conditional_route = "stand-in"

    @staticmethod
    def check(device) -> None:
        pass

    def warm_up(self, device, fn):
        return fn()

    def capture(self, device, fn):
        from audio_pattern_detector_tpu_torch.models import captured

        out = fn()

        def replay() -> None:
            counted = {w: w.launches for w in captured.COUNTED}
            for static, new in zip(captured._tensors(out), captured._tensors(fn())):
                static.copy_(new)
            for w, n in counted.items():
                w.launches = n

        return replay, out

    def conditional(self, pred, body) -> None:
        if bool(pred):
            body()

    def cond(self, pred, then_, else_) -> None:
        (then_ if bool(pred) else else_)()

    def while_loop(self, pred, body) -> None:
        while bool(pred):
            body()


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """(the readers' values, the spans, the counters) of three profiled rounds."""
    from torch.profiler import ProfilerActivity, profile

    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.utils import profiling

    cell = tiny_cell("flagship64.live16")
    cell.traffic["engine"] = {"capture": True}
    clips = reference_clips(cell.config, 2**31 + 11)
    traffic = generate(cell.traffic, 2**31 + 11, 8000, 60, clips, cell.data_dir)
    backend, captured.StepGraphs.backend = captured.StepGraphs.backend, StandInGraphs
    try:
        driver = cell.driver.Driver(cell, traffic, clips, "cpu", tmp_path_factory.mktemp("spans"))
        driver.warm()
        with profile(activities=[ProfilerActivity.CPU]):
            lat = [driver.round(r)[0] for r in range(ROUNDS)]
    finally:
        captured.StepGraphs.backend = backend
    ctx = SimpleNamespace(setup_s=1.0, window={}, trace=None, traced={"latencies": lat}, launch_bounds={})
    return {name: metric_reader(name)(ctx) for name in READERS}, profiling.spans(), profiling.counters()


def _ms(spans, *names):
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans if s.name in names)


def test_every_reader_reads_a_value(recorded) -> None:
    values, spans, counters = recorded
    assert all(values[name] is not None for name in READERS), values
    assert len({s.round for s in spans if s.name == "session.collect"}) == ROUNDS
    assert values["live_groups_per_round.live"] == counters["live_groups"] / ROUNDS
    assert values["live_groups_per_round.live"] > 0


def test_the_readers_agree_with_the_spans(recorded) -> None:
    values, spans, _ = recorded
    assert values["collect_wait_ms_per_round.live"] == pytest.approx(_ms(spans, "collect.wait") / ROUNDS)
    assert values["launch_ms_per_round.live"] == pytest.approx(_ms(spans, "step.load", "step.replay") / ROUNDS)
    assert values["launch_ms_per_round.live"] > 0
    # Wait and host time make up collect.
    both = values["collect_wait_ms_per_round.live"] + values["collect_host_ms_per_round.live"]
    assert both == pytest.approx(_ms(spans, "session.collect") / ROUNDS, rel=0.01)
    # Starved: the payload's arrival to the next round's first replay, twice
    # in three rounds, inside the host's time between the two rounds.
    waits = sorted((s.round, s.end_ns) for s in spans if s.name == "collect.wait")
    firsts = {}
    for s in spans:
        if s.name == "step.replay":
            firsts.setdefault(s.round, s.start_ns)
    gaps = [firsts[b] - end for (a, end), b in zip(waits, sorted(firsts)[1:])]
    assert all(g > 0 for g in gaps) and len(gaps) == ROUNDS - 1
    assert values["starved_ms_per_round.live"] == pytest.approx(1e-6 * sum(gaps) / ROUNDS)


def test_without_spans_the_readers_read_nothing(monkeypatch) -> None:
    """A program without the recorder (the parent of the change that added
    it) gives the readers nothing to read, and they say so."""
    from audio_pattern_detector_tpu_torch.utils import profiling

    for attr in ("spans", "counters"):
        monkeypatch.delattr(profiling, attr)
    ctx = SimpleNamespace(setup_s=1.0, window={}, trace=None, traced={}, launch_bounds={})
    assert all(metric_reader(name)(ctx) is None for name in READERS)
