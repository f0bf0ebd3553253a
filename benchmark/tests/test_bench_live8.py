"""``hk_radio.live8``: the upstream's own bank served live to eight stations
over its broadcast captures, through the ``live_cluster`` driver.

At a test's size (three stations on a pool of four chunks of the same
captures, one insert of each kind: the CBS intro, the rainbow intro and an
opening beep) the program's events equal the reference's on every row, and
the bfloat16 control fails the same check. At the cell's own size the
traffic is a function of the seed that carries the same inserts on every
seed. The three readers the cell adds read what they should from synthetic
spans, counters and trace summaries, and nothing where a program (the
parent of the counter's change) or a trace gives them nothing."""

from __future__ import annotations

import copy
from types import SimpleNamespace

import numpy as np
import pytest

from bench_support import BENCH_DIR  # noqa: F401  (puts the harness on the path)
from harness import check, port
from harness.cell import load_benchmark, load_cell, metric_reader, reference_clips
from harness.reference import ReferenceDetector
from harness.trace import TraceSummary
from harness.traffic import generate, read_wav_int16

import control

CELL = "hk_radio.live8"
ROUNDS = 4  # every chunk of the test's pool, at every station
NEW_READERS = ("correlate_cluster_roofline.live", "flagged_rows_per_round.live", "flagged_ms_per_round.live")
CLUSTER = "void (anonymous namespace)::correlate_os_kernel<true>((anonymous namespace)::Args)"
ONE_CTA = "void (anonymous namespace)::correlate_os_kernel<false>((anonymous namespace)::Args)"


def tiny_live8():
    """The cell at a CPU test's size. ``bench_support.tiny_cell`` cuts a
    cell by its planted airings, which this traffic has none of: here the
    inserts are cut to one of each kind."""
    cell = copy.deepcopy(load_cell(CELL))
    t = cell.traffic
    t["stations"], t["recording_seconds"] = 3, 240
    t["inserts"] = {"captures": t["inserts"]["captures"][:3], "counts": [[1], [1], [1]]}
    t["check"] = {"chunks": 12, "marked": 12}
    return cell


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(cell, traffic, driver, clips) after ``ROUNDS`` rounds served."""
    cell = tiny_live8()
    seed = 2**31 + 24
    clips = reference_clips(cell.config, seed)
    traffic = generate(cell.traffic, seed, 8000, 60, clips, cell.data_dir)
    driver = cell.driver.Driver(cell, traffic, clips, "cpu", tmp_path_factory.mktemp("live8"))
    driver.warm()
    for r in range(ROUNDS):
        driver.results.append(driver.round(r)[2])
    return cell, traffic, driver, clips


def test_the_cell_reports_its_metrics() -> None:
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "live_cluster"
    assert [m["name"] for m in cell.end_to_end] == ["live_p95_ms", "setup_s"]
    live = [m["name"] for m in load_benchmark()["per_layer"] if m["name"].endswith(".live")]
    assert [m["name"] for m in cell.per_layer] == live
    assert live[-3:] == list(NEW_READERS) and len(live) == 14


def test_the_warm_up_runs_every_clips_row_rerun(served) -> None:
    """The driver's warm-up runs each clip's row rerun once, so that the
    window builds nothing a rerun needs at its first use: the bank holds
    every clip's one-row constants."""
    bank = served[2].session._bank
    clips = {(sw, gi, ci) for sw, cls in bank.classes.items()
             for gi, g in enumerate(cls["groups"]) for ci in range(len(g.names))}
    assert len(clips) == 5 and clips <= set(bank._row_consts)


def test_the_live_driver_on_the_bank_equals_the_reference(served) -> None:
    cell, traffic, driver, clips = served
    every, marked = cell.driver.population(traffic, driver.served())
    assert len(every) == 3 * ROUNDS and marked
    pairs = driver.pairs(every, ReferenceDetector(clips, 8000, 60))
    correct, checks = check.judge(pairs)
    assert correct, check.lines(checks)
    # Every kind of insert aired and was found: the two intros and a beep.
    found = {c for _, prog, _ in pairs for c, _ in prog}
    assert {"cbs_news", "rainbow_intro"} <= found and found & {"rthk_beep", "881_beep", "903_beep"}


def test_the_bf16_control_fails_the_check() -> None:
    readings = control.control_readings(tiny_live8(), seed=2**31 + 24, rounds=ROUNDS)
    assert readings["correct"] is False
    assert readings["unmatched_events"] > 0 or readings["max_gap_ms"] > check.LIMITS["max_gap_ms"]


def test_the_driver_names_the_cluster_groups(served) -> None:
    _, _, driver, _ = served
    bounds = driver.launch_bounds()
    bank = driver.session._bank
    lens = sorted(int(g.corr.fft_len) for c in bank.classes.values() for g in c["groups"])
    assert lens == [32_768] * 4 + [131_072]
    # One group past one CTA (the rainbow intro's 4 s class), among the
    # correlation's five; the live driver's families unchanged.
    assert len(bounds["correlate_cluster"]) == 1 and bounds["correlate_cluster"][0] in bounds["correlate"]
    assert len(bounds["correlate"]) == 5
    assert {k: v for k, v in bounds.items() if k != "correlate_cluster"} == port.launch_bounds(bank, rows=1)


def _capture_count(stream: np.ndarray, x: np.ndarray) -> int:
    cand = np.flatnonzero(stream[: len(stream) - len(x) + 1] == x[0])
    for j in range(1, 64):
        cand = cand[stream[cand + j] == x[j]]
    return sum(np.array_equal(stream[p:p + len(x)], x) for p in cand)


def test_every_seed_carries_the_same_inserts_at_the_cells_size() -> None:
    cell = load_cell(CELL)
    clips = reference_clips(cell.config, 1)
    a = generate(cell.traffic, 2**32 + 7, 8000, 60, clips, cell.data_dir)
    again = generate(cell.traffic, 2**32 + 7, 8000, 60, clips, cell.data_dir)
    b = generate(cell.traffic, 2**31 + 3, 8000, 60, clips, cell.data_dir)
    assert np.array_equal(a.streams[0].samples, again.streams[0].samples)
    assert np.array_equal(a.order, again.order) and a.streams[0].marked == again.streams[0].marked
    assert not np.array_equal(a.streams[0].samples, b.streams[0].samples)
    assert len(a.pool) == len(b.pool) == 128 and a.order.shape == b.order.shape == (8, 128)
    inserts = cell.traffic["inserts"]
    want = [c[0] for c in inserts["counts"]]
    assert want == [8, 8, 1, 1, 1, 1, 1, 1]
    for t in (a, b):
        got = [_capture_count(t.streams[0].samples, read_wav_int16(cell.data_dir / name)[0])
               for name in inserts["captures"]]
        assert got == want


# ── The readers on synthetic inputs ──


def _ctx(kernels=None, bounds=None):
    trace = None if kernels is None else TraceSummary(window_s=1.5, busy_s=0.5, kernels=kernels)
    return SimpleNamespace(setup_s=1.0, window={}, trace=trace, traced={}, launch_bounds=bounds or {})


def test_the_cluster_roofline_reads_only_the_cluster_launches() -> None:
    read = metric_reader("correlate_cluster_roofline.live")
    bounds = {"correlate": [(1e-6, "bytes")] * 4 + [(3e-6, "bytes")], "correlate_cluster": [(3e-6, "bytes")]}
    kernels = {ONE_CTA: [80, 0.004], CLUSTER: [20, 0.0003]}
    assert read(_ctx(kernels, bounds)) == pytest.approx(100.0 * 20 * 3e-6 / 0.0003)
    # The accepted reader keeps taking both instances against every group.
    both = metric_reader("correlate_roofline.live")(_ctx(kernels, bounds))
    assert both == pytest.approx(100.0 * 100 * 1.4e-6 / 0.0043)


@pytest.mark.parametrize("case", ["no_trace", "no_cluster_launch", "no_cluster_group", "empty_trace"])
def test_the_cluster_roofline_reads_nothing_without_its_input(case: str) -> None:
    read = metric_reader("correlate_cluster_roofline.live")
    bounds = {"correlate": [(1e-6, "bytes")], "correlate_cluster": [(3e-6, "bytes")]}
    ctx = {"no_trace": _ctx(None, bounds),
           "no_cluster_launch": _ctx({ONE_CTA: [80, 0.004]}, bounds),
           "no_cluster_group": _ctx({ONE_CTA: [80, 0.004], CLUSTER: [20, 0.0003]},
                                    {"correlate": bounds["correlate"]}),
           "empty_trace": _ctx({}, bounds)}[case]
    assert read(ctx) is None


def _record(rounds: int, flagged: dict[int, list[int]], counted: int | None) -> None:
    """A stretch of ``rounds`` rounds on a made-up clock: a ``session.collect``
    a round, with a ``collect.flagged`` of each given length (ns) inside it,
    and ``flagged_rows`` counted as ``counted`` (not at all for None)."""
    from audio_pattern_detector_tpu_torch.utils import profiling

    rec = profiling.RECORDER
    with profiling.recording():
        for r in range(rounds):
            rid = rec.next_round()
            t = 10_000_000 * (r + 1)
            root = rec.open("session.collect", t=t, round=rid, root=True)
            for k, length in enumerate(flagged.get(r, [])):
                span = rec.open("collect.flagged", t=t + 1000 * (k + 1))
                rec.close(span, t=t + 1000 * (k + 1) + length)
            rec.close(root, t=t + 5_000_000)
        if counted is not None:
            rec.count("flagged_rows", counted)
        rec.open("session.dispatch", t=10_000_000 * (rounds + 1), round=rec.next_round(), root=True)


def test_the_flagged_readers_read_the_counter_and_the_spans() -> None:
    _record(4, {1: [2_000_000], 3: [500_000, 250_000]}, counted=3)
    ctx = _ctx()
    assert metric_reader("flagged_rows_per_round.live")(ctx) == 3 / 4
    assert metric_reader("flagged_ms_per_round.live")(ctx) == pytest.approx(2.75 / 4)


def test_with_no_flagged_row_the_readers_read_zero() -> None:
    _record(3, {}, counted=0)
    assert metric_reader("flagged_rows_per_round.live")(_ctx()) == 0
    assert metric_reader("flagged_ms_per_round.live")(_ctx()) == 0


def test_a_program_without_the_counter_gives_spans_but_no_count() -> None:
    """The parent of the counter's change records ``collect.flagged`` and
    counts no ``flagged_rows``."""
    _record(2, {0: [1_000_000]}, counted=None)
    assert metric_reader("flagged_rows_per_round.live")(_ctx()) is None
    assert metric_reader("flagged_ms_per_round.live")(_ctx()) == pytest.approx(0.5)


def test_without_rounds_or_the_recorder_the_flagged_readers_read_nothing(monkeypatch) -> None:
    from audio_pattern_detector_tpu_torch.utils import profiling

    _record(0, {}, counted=2)
    assert all(metric_reader(n)(_ctx()) is None for n in NEW_READERS[1:])
    for attr in ("spans", "counters"):
        monkeypatch.delattr(profiling, attr)
    assert all(metric_reader(n)(_ctx()) is None for n in NEW_READERS)
