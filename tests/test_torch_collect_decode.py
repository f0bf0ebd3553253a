"""collect's host decode of a round against the per-(row, clip) loops it
replaced, which are written out here as oracles.

* ``PatternBank._collect_rows`` reads a class payload's flags and
  selections as arrays and converts positions only where a row selected
  some. The oracle walks every (row, clip) pair. Both run on seeded
  payloads at the flagship bank's shapes (two groups of 32 clips, k_verify
  65 and 248), on an empty round, with every lane selected, with each
  flag, with the bank-sharded path's padded rows, and on a real round of
  a small bank on the CPU. The results must be equal, types and key order
  included. The flagged lists handed to ``resolve_flagged_rows`` must be
  equal too, and come in the same order.
* ``TorchAudioPatternDetector.peaks_to_times`` must give the same
  timestamps bit for bit, and a clamped time must stay the int ``0``.
* The counters ``live_groups`` and ``decoded_pairs`` move only while
  recording.
* A scan class whose payload comes back row by row (``RowPayloads``) is
  decoded in batches of the rows finished so far: for every way of cutting
  16 rows into contiguous batches the results, the counters and the
  flagged rows' resolution equal the whole-class decode's, and
  ``MultiStreamSession.collect``, which converts a row's times as soon as
  its results are final, gives the output it gave, tiled rounds included.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu_torch import native
from audio_pattern_detector_tpu_torch.models.bank import _BIG, PatternBank, RowPayloads, _split_fused, unpack_group
from audio_pattern_detector_tpu_torch.models.detector import MARKER_TONE_STRATEGY, TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.utils import profiling
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
from tests.test_torch_capture import CHUNK, CHUNK_S, SR, _audio, _clips, _pcm16
from tests.test_torch_isolation import _same

torch.set_num_threads(1)

SW = 1
K_VERIFY = (65, 248)  # the flagship bank's groups (models/bank.py)
CLIPS = 32


def _old_collect_rows(self, sw, flat_np, raws, rows=None):
    """The per-(row, clip) loop that ``_collect_rows`` replaced."""
    groups = self.classes[sw]["groups"]
    results = [dict() for _ in raws]
    flagged_by_bi = {}
    for gi, (g, packed) in enumerate(zip(groups, _split_fused(flat_np, groups, rows))):
        pos, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
        for bi in range(len(raws)):
            for ci, name in enumerate(g.names):
                if host_fb[bi, ci] or needs_full[bi, ci]:
                    flagged_by_bi.setdefault(bi, []).append((gi, ci, bool(host_fb[bi, ci])))
                else:
                    results[bi][name] = [int(p) for p in pos[bi, ci][sel[bi, ci]]]
    for bi, flagged in flagged_by_bi.items():
        raw = raws[bi]
        section = native.pcm16_to_f32_mono(raw) if raw.dtype == np.int16 else raw
        for (gi, ci), hits in self.resolve_flagged_rows(sw, flagged, section).items():
            results[bi][groups[gi].names[ci]] = hits
    return results


def _old_peaks_to_times(self, clip_peaks, index, had_prev):
    """The per-clip loop that ``peaks_to_times`` replaced."""
    sr = self.target_sample_rate
    out = {}
    for audio_clip in self.audio_clips:
        name = audio_clip.name
        sliding_window = self._clip_datas[name]["sliding_window"]
        clip_seconds = len(self._clip_datas[name]["clip"]) / sr
        subtract = sliding_window if had_prev else 0
        times = []
        for pos in clip_peaks.get(name, []):
            t = pos / sr - subtract + index * self.seconds_per_chunk
            t -= clip_seconds
            times.append(t if t >= 0 else 0)
        out[name] = times
    return out


def _same_in_order(a, b):
    """``_same``, and every dict's keys in the same order."""
    _same(a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_in_order(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _same_in_order(x, y)


def _recording_bank(monkeypatch, bank=None, clips=CLIPS, k_verify=K_VERIFY):
    """A bank (by default one with only the flagship class's two groups, of
    ``clips`` clips and ``k_verify`` lanes) whose ``resolve_flagged_rows``
    records each call. The stand-in answers in reverse order, so that a
    row's keys depend on the order it was given."""
    if bank is None:
        bank = PatternBank.__new__(PatternBank)
        groups = [SimpleNamespace(names=[f"{kind}{i:02d}" for i in range(clips)], k_verify=k)
                  for kind, k in zip(("jingle", "marker"), k_verify)]
        bank.classes = {SW: {"groups": groups}}
        bank._staging, bank._row_payloads = {}, {}

        def resolve(sw, flagged, raw_section):
            return {(gi, ci): [gi * 1000 + ci, int(host), len(raw_section)]
                    for gi, ci, host in reversed(flagged)}
    else:
        resolve = bank.resolve_flagged_rows
    calls = []

    def recorded(sw, flagged, raw_section):
        calls.append((sw, list(flagged), np.array(raw_section)))
        return resolve(sw, flagged, raw_section)

    monkeypatch.setattr(bank, "resolve_flagged_rows", recorded)
    return bank, calls


def _payload(seed, b, *, live=0.05, selected=0.3, flag1=0.0, flag2=0.0, host=0.0, rows=None,
             clips=CLIPS, k_verify=K_VERIFY):
    """A seeded (b, total) class payload: per group, positions (dead lanes at
    the sentinel), selections among the live lanes, the flag column (1 or 2)
    and the host column. ``rows`` pads each group as the bank-sharded path
    does, with padded rows that are live, selected and flagged (sliced off
    unread)."""
    rng = np.random.default_rng(seed)
    parts = []
    for gi, k in enumerate(k_verify):
        n = rows[gi] if rows is not None else clips
        p = np.zeros((b, n, 2 * k + 2), np.float32)
        alive = rng.random((b, n, k)) < live
        p[..., :k] = np.where(alive, rng.integers(0, 488_000, (b, n, k)), _BIG)
        p[..., k : 2 * k] = alive & (rng.random((b, n, k)) < selected)
        p[..., 2 * k] = np.where(rng.random((b, n)) < flag1, 1.0,
                                 np.where(rng.random((b, n)) < flag2, 2.0, 0.0))
        p[..., 2 * k + 1] = rng.random((b, n)) < host
        p[:, clips:] = 1.0
        parts.append(p.reshape(b, -1))
    return np.concatenate(parts, axis=-1)


def _raws(b):
    """Raw sections of distinct lengths, int16 and f32 in turn."""
    rng = np.random.default_rng(b)
    return [(rng.standard_normal(100 + bi) * 3000).astype(np.int16) if bi % 2
            else rng.standard_normal(100 + bi).astype(np.float32) for bi in range(b)]


CASES = {
    "seeded_b1": dict(seed=2**31 + 11, b=1, live=0.1, flag1=0.05, flag2=0.05),
    "seeded_b16": dict(seed=2**31 + 12, b=16, live=0.02, flag1=0.01, flag2=0.01, host=0.01),
    "empty_round": dict(seed=3, b=16, live=0.0),
    "every_lane_selected": dict(seed=4, b=4, live=1.0, selected=1.0),
    "flag_1": dict(seed=5, b=16, flag1=0.2),
    "flag_2": dict(seed=6, b=16, flag2=0.2),
    "host_column": dict(seed=7, b=16, host=0.2),
    "sharded_rows_padded": dict(seed=8, b=8, flag1=0.05, flag2=0.05, rows=(36, 40)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_the_per_pair_loop(case, monkeypatch):
    spec = dict(CASES[case])
    bank, calls = _recording_bank(monkeypatch)
    flat = _payload(**spec)
    raws = _raws(spec["b"])
    rows = spec.get("rows")
    want = _old_collect_rows(bank, SW, flat, raws, rows)
    want_calls = list(calls)
    calls.clear()
    got = bank._collect_rows(SW, flat, raws, rows)
    _same_in_order(got, want)
    _same_in_order(calls, want_calls)
    # Every clip has a list of its own.
    lists = [v for row in got for v in row.values()]
    assert len({id(v) for v in lists}) == len(lists)
    # Each case reaches what it was made for.
    if case == "empty_round":
        assert not calls and all(v == [] for row in got for v in row.values())
    if case == "every_lane_selected":
        assert all(len(v) == k for row in got for v, k in zip(row.values(), np.repeat(K_VERIFY, CLIPS)))
    if case.startswith(("flag", "host", "sharded")):
        assert calls


def test_decode_of_a_real_round_equals_the_per_pair_loop(monkeypatch):
    """A small bank's round on the CPU: hits, a row flooded past the lean
    tier's lanes (a flagged row, rerun for real), int16 and f32 rows, and an
    idle row."""
    det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S)
    bank, calls = _recording_bank(monkeypatch, det._ensure_bank())
    flood = _audio(21, 2 * CHUNK_S, normal=[10.3 + 0.62 * k for k in range(15)]).astype(np.float32)
    hits = _audio(22, 2 * CHUNK_S, normal=(3.0, 14.0), marker=(6.0, 17.0))
    rows = [(flood[CHUNK:], flood[:CHUNK]), (_pcm16(hits[CHUNK:]), _pcm16(hits[:CHUNK])),
            (hits[:CHUNK].astype(np.float32), None), (np.zeros(0, np.float32), None)]
    dispatched = bank.dispatch_chunks_batch([c for c, _ in rows], None, prev_tails=[t for _, t in rows])
    ((sw, handle, raws, _b, _staged),) = dispatched
    flat = handle.numpy()
    want = _old_collect_rows(bank, sw, flat, raws)
    want_calls = list(calls)
    calls.clear()
    got = bank._collect_rows(sw, flat, raws)
    _same_in_order(got, want)
    _same_in_order(calls, want_calls)
    assert calls and got[0]["c"] and got[1]["c"] and got[1]["m"] and got[3] == {"c": [], "m": []}


def _detector():
    """Clips of 1 s, a quarter second and 1.5 s (sliding windows 1, 1, 2)."""
    t = np.arange(int(1.5 * SR)) / SR
    long = (0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(len(t))).astype(np.float32)
    return TorchAudioPatternDetector(
        [*_clips(), AudioClip(name="long", audio=long, sample_rate=SR),
         AudioClip(name="tone", audio=np.sin(2 * np.pi * 1000.0 * t[: SR // 4]).astype(np.float32),
                   sample_rate=SR, strategy=MARKER_TONE_STRATEGY,
                   strategy_params={"dominant_frequency_hz": 1000.0})],
        device="cpu", seconds_per_chunk=CHUNK_S)


@pytest.mark.parametrize("had_prev", [False, True])
@pytest.mark.parametrize("index", [0, 123_456_789])
def test_peaks_to_times_equals_the_per_clip_loop_bit_for_bit(had_prev, index):
    det = _detector()
    # "tone" is absent; "m" is empty; position 100 is before the clip's
    # end (clamped to 0 in the first chunk, and with a lookback).
    peaks = {"c": [100, 4_800, 87_999], "m": [], "long": [7, 12_000, 80_000, 88_001], "stray": [5]}
    got = det.peaks_to_times(peaks, index, had_prev)
    want = _old_peaks_to_times(det, peaks, index, had_prev)
    _same_in_order(got, want)
    assert list(got) == ["c", "m", "long", "tone"] and got["tone"] == [] and got["m"] == []
    assert all(got[k] is not peaks.get(k) for k in got)

    def bits(times):
        return [(type(t).__name__, t.hex() if isinstance(t, float) else t) for t in times]

    assert {k: bits(v) for k, v in got.items()} == {k: bits(v) for k, v in want.items()}
    if index == 0:
        assert got["c"][0] == 0 and type(got["c"][0]) is int
        assert got["long"][0] == 0 and type(got["long"][0]) is int
    else:
        assert all(type(t) is float for v in got.values() for t in v)


def _known_payload():
    """Two rows. Group 0: row 0 clips 3 and 7 select 2 positions and 1, row 0
    clip 4 has a live lane it does not select, row 1 clip 5 is host-flagged
    with a selected lane. Group 1: row 1 clip 0 selects one position, row 0
    has no live lane. So 3 (row, group) pairs have a live lane, and 3
    unflagged (row, clip) pairs selected a position."""
    parts = []
    for k in K_VERIFY:
        p = np.zeros((2, CLIPS, 2 * k + 2), np.float32)
        p[..., :k] = _BIG
        parts.append(p)
    (k0, k1), (g0, g1) = K_VERIFY, parts
    g0[0, 3, :3] = (10, 20, 25)
    g0[0, 3, k0 : k0 + 2] = 1
    g0[0, 4, 0] = 30
    g0[0, 7, 1] = 35
    g0[0, 7, k0 + 1] = 1
    g0[1, 5, 0] = 40
    g0[1, 5, k0] = 1
    g0[1, 5, 2 * k0] = 1
    g1[1, 0, 0] = 50
    g1[1, 0, k1] = 1
    return np.concatenate([p.reshape(2, -1) for p in parts], axis=-1)


def test_the_decode_counters_move_only_while_recording(monkeypatch):
    bank, calls = _recording_bank(monkeypatch)
    flat, raws = _known_payload(), _raws(2)
    with profiling.recording():
        got = bank._collect_rows(SW, flat, raws)
        counted = profiling.counters()
        (span,) = [s for s in profiling.spans() if s.name == "collect.unpack"]
    # ``flagged_rows`` is present at 0: the stand-in resolves the flagged
    # row without a rerun or the host path, which would count it.
    assert counted == {"live_groups": 3, "decoded_pairs": 3, "flagged_rows": 0}
    assert (span.a, span.b) == (2, SW)
    assert got[0]["jingle03"] == [10, 20] and got[1]["marker00"] == [50] and got[0]["jingle04"] == []
    assert got[0]["jingle07"] == [35]
    assert got[1]["jingle05"] == [5, 1, len(raws[1])] and [c[1] for c in calls] == [[(0, 5, True)]]
    assert not profiling.RECORDER.on
    bank._collect_rows(SW, flat, raws)
    assert profiling.counters() == counted


# ── A scan class decoded in batches as its rows finish (RowPayloads) ──

SPLIT_ROWS = 16
SPLIT_SHAPES = dict(clips=4, k_verify=(3, 6))  # small groups: every split of 16 rows is run


def _splits(n, k):
    """Every way of cutting ``n`` rows into ``k`` contiguous batches, as the
    batches' sizes."""
    for cuts in itertools.combinations(range(1, n), k - 1):
        ends = (0, *cuts, n)
        yield [hi - lo for lo, hi in zip(ends, ends[1:])]


class _Card:
    """A stand-in card that finishes a class's rows batch by batch: the first
    batch's rows are on the host when collect starts, and a wait for a row
    finishes the rest of its batch. ``event()`` is a row's event, the rows
    taken in the order their events are made."""

    def __init__(self, sizes):
        self.ends = np.cumsum(sizes).tolist()
        self.done = self.ends[0]
        self.made = self.waits = 0

    def event(self):
        self.made += 1
        return _RowEvent(self, self.made - 1)


class _RowEvent:
    def __init__(self, card, row):
        self.card, self.row = card, row

    def record(self):
        pass

    def query(self):
        return self.row < self.card.done

    def synchronize(self):
        self.card.waits += 1
        if not self.query():
            self.card.done = next(e for e in self.card.ends if e > self.row)


class _Slices:
    """``bank._unpack_rows`` with each slice of rows decoded once: a split
    that holds the same slice reuses it (fresh dicts), and the counters its
    decode added are added again. ``sizes`` logs the rows of each call."""

    def __init__(self, bank):
        self._unpack = bank._unpack_rows
        self._done = {}
        self.sizes = []

    def __call__(self, sw, flat_np, n, rows=None, lo=0):
        self.sizes.append(n)
        key = (lo, n)
        if key in self._done:
            (results, flagged), added = self._done[key]
            for k, v in added.items():
                profiling.RECORDER.count(k, v)
        else:
            before = profiling.counters()
            results, flagged = self._unpack(sw, flat_np, n, rows, lo=lo)
            added = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
            self._done[key] = ((results, flagged), added)
        return [dict(r) for r in results], flagged


@pytest.mark.parametrize("batches", range(1, SPLIT_ROWS + 1))
def test_a_class_decoded_in_ready_batches_equals_the_whole_class_decode(batches, monkeypatch):
    """For every way of cutting a 16-row class into ``batches`` contiguous
    batches: the results (types and key order included), the counters'
    sums and the flagged rows handed to ``resolve_flagged_rows`` (the same
    sections, lists and order, so the same routes) are the whole-class
    decode's; each batch is one unpack after one wait (none before the
    first, which waits for its last row alone when it is the only one, so
    that the class's payload on the host ends a wait), rows before the last batch count as ``rows_decoded_early``, and
    ``on_final`` gets each batch's unflagged rows, then the flagged rows
    once resolved, every row once. Each slice of rows is decoded once and
    reused by the splits that hold it (``_Slices``)."""
    bank, calls = _recording_bank(monkeypatch, **SPLIT_SHAPES)
    flat = _payload(2**31 + 27, SPLIT_ROWS, live=0.4, flag1=0.06, flag2=0.06, host=0.03,
                    **SPLIT_SHAPES)
    raws = _raws(SPLIT_ROWS)
    with profiling.recording():
        want = bank._collect_rows(SW, flat, raws)
        want_counted = profiling.counters()
    want_calls = [(sw, fl, raw.tobytes()) for sw, fl, raw in calls]
    flagged = list(dict.fromkeys(bi for got in bank._unpack_rows(SW, flat, SPLIT_ROWS)[1]
                                 for bi, _, _ in got))
    assert len(flagged) >= 4 and len({bi // 4 for bi in flagged}) >= 3  # in several batches
    slices = _Slices(bank)
    monkeypatch.setattr(bank, "_unpack_rows", slices)
    staged = np.zeros((SPLIT_ROWS, 1), np.float32)
    for sizes in _splits(SPLIT_ROWS, batches):
        calls.clear()
        slices.sizes.clear()
        card = _Card(sizes)
        handle = RowPayloads(torch.from_numpy(flat), [card.event() for _ in raws])
        handed = []
        handle.on_final = lambda rows, results: handed.append(list(rows))
        with profiling.recording():
            got = bank.collect_chunks_batch([(SW, handle, raws, SPLIT_ROWS, staged)])
            counted = profiling.counters()
        assert got == want and [(sw, fl, raw.tobytes()) for sw, fl, raw in calls] == want_calls, sizes
        assert counted == {**want_counted, "rows_decoded_early": SPLIT_ROWS - sizes[-1]}, sizes
        assert slices.sizes == sizes and card.waits == max(batches - 1, 1)
        ends = np.cumsum([0, *sizes]).tolist()
        batch_rows = [[bi for bi in range(lo, hi) if bi not in flagged] for lo, hi in zip(ends, ends[1:])]
        assert handed == [rows for rows in batch_rows if rows] + [flagged], sizes
    _same_in_order(got, want)


class _LaggingEvent:
    """A stand-in row event (``PatternBank._row_event``) of which every third
    one made finds itself unfinished at its first poll after each record (a
    wait finishes it), so that a class's rows come back in several
    batches."""

    made = itertools.count()

    def __init__(self):
        self.lag = next(self.made) % 3 == 0

    def record(self):
        self.left = self.lag

    def query(self):
        if self.left:
            self.left = False
            return False
        return True

    def synchronize(self):
        self.left = False


def _jax_session_collect(sess, handle):
    """The JAX module's ``MultiStreamSession.collect``, which the port's
    was until it converted rows as they finish, run on the port's session:
    every dispatch collected, the rows scattered to their slots, then each
    converted."""
    from audio_pattern_detector_tpu.models.multistream import MultiStreamSession

    return MultiStreamSession.collect(sess, handle[:3])


SESSION_CASES = {"untiled": dict(), "tiled": dict(tile=4)}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_collect_converts_rows_as_they_finish_with_the_same_output(case, monkeypatch):
    """Two sessions of six stations over four rounds with idle stations: one
    whose scan classes come back row by row through stand-in events that
    finish in several batches, one whose payloads come back whole and whose
    rounds the JAX module's collect converts. The outputs are equal bit for bit, the
    tiled session's compacted rounds (widths 4, 2 and 1) included, and the
    row-wise session converted its times in more than one batch a round."""
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession

    stations = 6
    audio = [_audio(70 + s, 4 * CHUNK_S, normal=(3.0 + s, 27.0), marker=(15.0 + s,)) for s in range(stations)]
    sessions = []
    for row_event in (_LaggingEvent, None):
        monkeypatch.setattr(PatternBank, "_row_event", lambda self, e=row_event: e)
        det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S)
        det._ensure_bank()
        sessions.append(MultiStreamSession(det, stations, **SESSION_CASES[case]))
    rowwise, whole = sessions
    for r in range(4):
        chunks = [None if (s + r) % 4 == 3 else _pcm16(a[r * CHUNK : (r + 1) * CHUNK])
                  for s, a in enumerate(audio)]
        monkeypatch.setattr(PatternBank, "_row_event", lambda self: _LaggingEvent)
        handle = rowwise.dispatch(chunks)
        assert all(isinstance(rec[1], RowPayloads) for d in handle[0] for rec in d)
        with profiling.recording():
            got = rowwise.collect(handle)
        times = [s for s in profiling.spans() if s.name == "collect.times"]
        monkeypatch.setattr(PatternBank, "_row_event", lambda self: None)
        want = _jax_session_collect(whole, whole.dispatch(chunks))
        _same(got, want)
        _same_in_order(got, want)
        assert len(times) > len(handle[0]) and sum(s.a for s in times) == sum(c is not None for c in chunks)
    assert any(any(v) for v in got)
