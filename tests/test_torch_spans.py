"""The port's span recorder (``utils/profiling.py``) on the CPU.

Off, a layer boundary records nothing and reads no clock beyond the
bank's own five (``dispatch_phase_seconds`` grows as it always has). On,
under a CPU ``torch.profiler`` session, one round of a three-station
``MultiStreamSession`` (captured steps on the stand-in backend of
tests/test_torch_capture.py) gives the span tree the benchmark's readers
walk, one round id from dispatch to collect, covering the round's host
wall. Besides: the ring's bound and ``dropped``, a new stretch per
profiler session, ``python.gc``, the server loop's ``serve.*`` spans, and
``device_trace``'s Chrome trace holding the spans on the profiler's own
timeline.
"""

import gc
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from audio_pattern_detector_tpu_torch.models import bank as bank_module
from audio_pattern_detector_tpu_torch.models import captured
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.serve import PatternServer
from audio_pattern_detector_tpu_torch.utils import profiling
from audio_pattern_detector_tpu_torch.utils.profiling import Recorder
from tests.test_torch_capture import CHUNK_S, SR, RecordingBackend, _audio, _clips, _pcm16

torch.set_num_threads(1)

CHUNK = CHUNK_S * SR
STATIONS = 3


def _chunks(r):
    """Round ``r`` of three stations: int16 chunks, two with hits."""
    audio = [_audio(10 + s, 3 * CHUNK_S, normal=(4.0 + s,), marker=(16.0 + s,)) for s in range(STATIONS)]
    return [_pcm16(a[r * CHUNK : (r + 1) * CHUNK]) for a in audio]


@pytest.fixture
def session(monkeypatch):
    """A warmed three-station session whose steps are captured (stand-in)."""
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)
    det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S, capture=True)
    sess = MultiStreamSession(det, STATIONS)
    sess.feed(_chunks(0))
    return sess


def _round(sess, r):
    chunks = _chunks(r)
    t0 = time.perf_counter_ns()
    out = sess.collect(sess.dispatch(chunks))
    return out, t0, time.perf_counter_ns()


def test_off_records_nothing_and_the_dispatch_stages_grow_as_before(session, monkeypatch):
    assert not profiling.RECORDER.on
    with profiling.recording():
        pass
    assert profiling.spans() == []
    ticks = iter(range(0, 10**12, 1000))
    monkeypatch.setattr(bank_module.time, "perf_counter_ns", lambda: next(ticks))
    before = dict(bank_module.dispatch_phase_seconds)
    session.collect(session.dispatch(_chunks(1)))
    # One class of three rows in the scan schedule: the sections and the
    # prefetch once, the pack, upload and launch once a row, each between
    # two of the bank's 2 + 3 x 3 + 1 readings of the clock (1,000 ns
    # apart), and no reading besides.
    per_row = ("pack", "upload", "launch")
    assert {k: v - before[k] for k, v in bank_module.dispatch_phase_seconds.items()} == pytest.approx(
        {k: (STATIONS if k in per_row else 1) * 1e-6 for k in before}, abs=1e-12)
    assert next(ticks) == (3 + 3 * STATIONS) * 1000
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_profiled_round_gives_the_span_tree_with_one_round_id(session):
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.RECORDER.on
        out, t0, t1 = _round(session, 1)
    assert not profiling.RECORDER.on
    spans = profiling.spans()
    by_index = {s.index: s for s in spans}
    names = [s.name for s in spans]
    (disp,) = [s for s in spans if s.name == "session.dispatch"]
    (coll,) = [s for s in spans if s.name == "session.collect"]
    assert disp.parent == coll.parent == -1 and disp.round == coll.round >= 0
    assert {s.round for s in spans} == {disp.round}

    def parent(s):
        return by_index[s.parent].name

    (sw,) = session._bank.classes
    for name in ("bank.sections", "bank.prefetch"):
        (s,) = [s for s in spans if s.name == name]
        assert parent(s) == "session.dispatch" and (s.a, s.b) == (STATIONS, sw)
    for name in ("bank.pack", "bank.upload", "bank.launch"):  # the scan schedule: once a row
        rows = [s for s in spans if s.name == name]
        assert len(rows) == STATIONS
        assert all(parent(s) == "session.dispatch" and (s.a, s.b) == (1, sw) for s in rows)
    for name in ("step.load", "step.replay"):  # the scan schedule: the 1-row key, a row at a time
        steps = [s for s in spans if s.name == name]
        assert len(steps) == STATIONS
        assert all(parent(s) == "bank.launch" and (s.a, s.b) == (1, sw) for s in steps)
    assert "step.capture" not in names
    # Off a card a scan class's payload comes back whole: one wait, and one
    # batch of rows to unpack and to convert to times.
    for name in ("collect.wait", "collect.unpack", "collect.times"):
        got = [s for s in spans if s.name == name]
        assert len(got) == 1 and all(parent(s) == "session.collect" for s in got)
        if name != "collect.wait":
            assert (got[0].a, got[0].b) == (STATIONS, sw)
    assert profiling.counters()["rows_decoded_early"] == 0
    # The dispatch's children in order, and within it.
    kids = [s for s in spans if s.parent == disp.index]
    assert [s.name for s in kids] == ["bank.sections",
                                      *["bank.pack", "bank.upload", "bank.launch"] * STATIONS,
                                      "bank.prefetch"]
    # Each row's launch holds that row's load and replay, and every row
    # after the first is packed once the one before it is on its way.
    launches = [s for s in kids if s.name == "bank.launch"]
    assert [[by_index[s.parent] for s in spans if s.name == n] for n in ("step.load", "step.replay")] == [
        launches, launches]
    assert profiling.counters()["overlapped_rows"] == STATIONS - 1
    assert all(disp.start_ns <= s.start_ns <= s.end_ns <= disp.end_ns for s in kids)
    assert disp.end_ns <= coll.start_ns
    # The two roots cover the round's host wall.
    assert (disp.end_ns - disp.start_ns) + (coll.end_ns - coll.start_ns) >= 0.9 * (t1 - t0)
    # Stations 0 and 1 carry a marker tone in round 1: some group had a live lane.
    assert profiling.counters()["live_groups"] >= 1
    assert out[0] and out[1]


def test_first_use_of_a_key_is_a_capture_span(monkeypatch):
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)
    det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S, capture=True)
    sess = MultiStreamSession(det, STATIONS)
    with profiling.recording():
        sess.feed(_chunks(0))
    names = [s.name for s in profiling.spans()]
    # The class step's key, and the key of each flagged row's wide rerun
    # (the marker tone floods its clip's row): each first use a capture,
    # each later use a replay.
    bank = sess._bank
    (step,) = bank.graphs.steps()
    steps = [step, *bank.rerun_graphs.steps()]
    assert step.replays == STATIONS - 1
    assert names.count("step.capture") == len(steps)
    assert names.count("step.replay") == sum(s.replays for s in steps)


def test_flagged_rows_are_spans_by_route(session):
    bank = session._bank
    (sw,) = bank.classes
    section = _audio(3, CHUNK_S, marker=(4.0,)).astype(np.float32)

    def reruns():
        return bank.row_reruns + bank.class_reruns + bank.host_path_rows

    before = reruns()
    with profiling.recording():
        bank.resolve_flagged_rows(sw, [(1, 0, False), (0, 0, True)], section)
    flagged = [s for s in profiling.spans() if s.name == "collect.flagged"]
    routes = [bank_module.FLAGGED_ROUTES[s.a] for s in flagged]  # the reruns, then the host path
    assert routes[0] == "row" and routes[-1] == "host" and len(routes) == reruns() - before


ROUTE_COUNTS = ("row_reruns", "class_reruns", "escalated_reruns", "host_path_rows")


def _route_counts(bank):
    return sum(getattr(bank, k) for k in ROUTE_COUNTS)


def _force_flag(monkeypatch, host):
    """Every group's clip 0 of row 0 in a round's payload comes back
    flagged: for the host path (``host``) or for a wide rerun (whose own
    one-row payload is read as it is)."""
    original = bank_module.group_flags

    def flags(packed, k_verify):
        host_fb, needs_full = original(packed, k_verify)
        if packed.ndim == 3:
            host_fb, needs_full = host_fb.copy(), needs_full.copy()
            (host_fb if host else needs_full)[0, 0] = True
        return host_fb, needs_full

    monkeypatch.setattr(bank_module, "group_flags", flags)


@pytest.mark.parametrize("host", [False, True], ids=["rerun", "host_path"])
def test_flagged_rows_counts_what_the_route_counts_add(session, monkeypatch, host):
    bank = session._bank
    _force_flag(monkeypatch, host)
    before = _route_counts(bank)
    with profiling.recording():
        _round(session, 1)
    moved = _route_counts(bank) - before
    assert moved == len(bank.classes[next(iter(bank.classes))]["groups"]) == 2
    assert profiling.counters()["flagged_rows"] == moved
    flagged = [s for s in profiling.spans() if s.name == "collect.flagged"]
    assert {bank_module.FLAGGED_ROUTES[s.a] for s in flagged} == {"host" if host else "row"}


def test_flagged_rows_is_present_and_zero_on_a_collect_with_none(session):
    bank = session._bank
    before = _route_counts(bank)
    with profiling.recording():
        _round(session, 1)
    assert _route_counts(bank) == before
    assert profiling.counters()["flagged_rows"] == 0


def test_flagged_rows_is_not_counted_with_the_recorder_off(session, monkeypatch):
    bank = session._bank
    _force_flag(monkeypatch, False)
    with profiling.recording():
        pass
    before = _route_counts(bank)
    _round(session, 1)
    assert _route_counts(bank) - before == 2
    assert profiling.counters() == {} and profiling.spans() == []


def test_the_ring_keeps_the_newest_spans_and_counts_the_dropped():
    rec = Recorder(size=8)
    with rec.recording():
        root = rec.open("root", round=7)
        for k in range(20):
            rec.add("leaf", k + 1, k + 2, a=k)
        rec.close(root)
    spans = rec.spans()
    assert rec.recorded == 21 and rec.dropped == 13
    assert [s.name for s in spans] == ["leaf"] * 8 and [s.a for s in spans] == list(range(12, 20))
    assert all(s.round == 7 for s in spans)  # inherited from the root the ring overwrote
    with rec.recording():  # a new stretch
        rec.add("x", 1, 2)
    assert [s.name for s in rec.spans()] == ["x"] and rec.dropped == 0


PROFILERS = {
    "torch.profiler": lambda: profile(activities=[ProfilerActivity.CPU]),
    "autograd.profiler": lambda: torch.autograd.profiler.profile(),
}


@pytest.mark.parametrize("kind", sorted(PROFILERS))
def test_a_profiler_session_turns_the_recorder_on(kind):
    """The recorder follows the flag torch sets for every profiler session;
    a torch that stopped setting it so would leave the recorder off, and
    the benchmark's readers with nothing to read."""
    assert not profiling.RECORDER.on
    with PROFILERS[kind]():
        assert profiling.RECORDER.on and torch.autograd.profiler._is_profiler_enabled
        profiling.RECORDER.add("inside", 1, 2)
    assert not profiling.RECORDER.on
    assert [s.name for s in profiling.spans() if s.name != "python.gc"] == ["inside"]


def test_each_profiler_session_is_a_stretch_and_a_span_outliving_it_is_ignored():
    rec = profiling.RECORDER
    with profile(activities=[ProfilerActivity.CPU]):
        rec.add("first", 1, 2)
        left_open = rec.open("open")
    assert [s.name for s in profiling.spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        inner = rec.open("second")
        rec.close(left_open)
        rec.close(inner)
    assert [s.name for s in profiling.spans()] == ["second"]
    assert gc.callbacks.count(rec._gc) == 0


def test_garbage_collections_are_spans_while_recording():
    with profiling.recording():
        gc.collect()
    (span,) = [s for s in profiling.spans() if s.name == "python.gc" and s.a == 2]
    assert span.end_ns >= span.start_ns


def test_the_server_loop_phases_are_spans():
    from tests.test_torch_serve import RTHK, run_client

    srv = PatternServer(_clips(), port=0, max_streams=1, device="cpu", seconds_per_chunk=CHUNK_S)
    srv.warmup()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    with profiling.recording():
        thread.start()
        raw = run_client(srv.address[1], open(RTHK, "rb").read())
        srv.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive() and raw.rstrip().endswith(b"}")
    spans = profiling.spans()
    by_index = {s.index: s for s in spans}
    names = {s.name for s in spans}
    assert {"serve.select", "serve.sockets", "serve.collect", "serve.dispatch", "serve.take",
            "serve.finish"} <= names
    assert not hasattr(srv, "phase_seconds")
    disp = [s for s in spans if s.name == "session.dispatch"]
    assert disp and all(by_index[s.parent].name == "serve.dispatch" for s in disp)
    assert srv.rounds_dispatched >= 1


def test_device_trace_holds_the_spans_on_the_profiler_timeline(session, tmp_path, monkeypatch):
    pack_row = bank_module.PatternBank._pack_row

    def probed(*args):
        time.sleep(0.002)
        with record_function("probe.pack"):
            pack_row(*args)
        time.sleep(0.002)

    monkeypatch.setattr(bank_module.PatternBank, "_pack_row", staticmethod(probed))
    with profiling.device_trace(str(tmp_path), "cpu"):
        _round(session, 1)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    probes = sorted((e["ts"], e["dur"]) for e in events if e.get("name") == "probe.pack" and e.get("ph") == "X")
    packs = sorted((e["ts"], e["dur"]) for e in events
                   if e.get("name") == "bank.pack" and e.get("cat") == "apd_span")
    assert len(probes) == len(packs) == STATIONS  # a row at a time
    for (p0, pd), (s0, sd) in zip(probes, packs):
        assert s0 <= p0 and p0 + pd <= s0 + sd
    spans = [e for e in events if e.get("cat") == "apd_span"]
    assert {"session.dispatch", "session.collect", "step.replay"} <= {e["name"] for e in spans}
    assert len({e["pid"] for e in spans}) == 1 and spans[0]["pid"] != os.getpid()
