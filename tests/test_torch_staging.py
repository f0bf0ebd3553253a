"""The upload staging of the port's bank: rows of 16-bit PCM cross as
int16, rows are staged in recycled buffers, and ``dispatch_phase_seconds``
splits a dispatch's host time.

The JAX bank packs rows of 16-bit PCM into half the upload bytes
(``models/bank.py`` with ``ops/packing``); the port uploads rows that
arrive as int16 as int16, and f32 rows as f32 without testing them for the
PCM grid (a source of 16-bit PCM hands int16 on). The device decode of an
int16 row is bitwise the host decode, so payloads are compared for bit
equality: with the upload the f32 form of the same samples took, with the
row dispatched alone, between the two schedules, and (results) with the
JAX bank on the same rows. The host library's ``pack_pcm16_into`` is held
against the JAX package's pack.

The staging pool is the JAX bank's ``_payload_pool``: a dispatch takes a
(B, S) buffer by (dtype, B, S), writes each row and zeroes only the tail
past the row, and the buffer comes back at collect, once the payload (every
shard's) is on the host; at most 4 are kept a key. On a CUDA bank the
buffers are pinned (tests/test_torch_cuda.py); here they are plain.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models import bank as jbank_module
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector as JaxDetector
from audio_pattern_detector_tpu.ops import packing as jpacking
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import AudioClip, AudioPatternDetector, native
from audio_pattern_detector_tpu_torch.models import bank as tbank_module
from audio_pattern_detector_tpu_torch.models.bank import PatternBank, PayloadHandle
from audio_pattern_detector_tpu_torch.models.detector import MARKER_TONE_STRATEGY
from audio_pattern_detector_tpu_torch.ops import packing as tpacking
from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, RowSharding, make_mesh

torch.set_num_threads(1)

SR = 8000
CHUNK_S = 10
CHUNK = CHUNK_S * SR


def _clips():
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tm = np.arange(int(0.25 * SR)) / SR
    return [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(name="m", audio=np.sin(2 * np.pi * 941.0 * tm).astype(np.float32),
                  sample_rate=SR, strategy=MARKER_TONE_STRATEGY,
                  strategy_params={"dominant_frequency_hz": 941.0}),
    ]


def _audio(seed, seconds, normal=(), marker=()):
    clip, tone = (c.audio for c in _clips())
    audio = 0.01 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
    for s in normal:
        o = int(s * SR)
        audio[o : o + len(clip)] += clip
    for s in marker:
        o = int(s * SR)
        audio[o : o + len(tone)] += 0.8 * tone
    return audio


def _on_grid(audio):
    """f32 samples as a decoder of 16-bit PCM gives them."""
    pcm = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    return native.pcm16_to_f32_mono(pcm), pcm


@pytest.fixture(scope="module")
def env():
    bank = AudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()
    exact, pcm = _on_grid(_audio(1, 20, normal=(4.0, 13.0), marker=(7.0,)))
    off_grid = _audio(2, 20, normal=(12.0,), marker=(3.0,)).astype(np.float32)
    return bank, exact, pcm, off_grid


def _uploads(monkeypatch):
    """Record the dtype and bytes of every section upload of the bank."""
    seen = []
    upload = tbank_module.upload_rows

    def recording(rows, device):
        seen.append((rows.dtype, rows.nbytes))
        return upload(rows, device)

    monkeypatch.setattr(tbank_module, "upload_rows", recording)
    return seen


def _payloads(dispatched):
    return [rec[1].numpy() for rec in dispatched]


def test_int16_rows_upload_as_int16_with_the_f32_payload(env, monkeypatch):
    bank, exact, pcm, _ = env
    seen = _uploads(monkeypatch)
    raw = _payloads(bank.dispatch_chunks_batch(
        [pcm[:CHUNK], pcm[CHUNK:]], None, prev_tails=[None, pcm[:CHUNK]]))
    assert [d for d, _ in seen] == [np.int16] * len(bank.classes)
    # The same samples decoded on the host go up as f32: twice the bytes,
    # the same payload bit for bit.
    rows, tails = [exact[:CHUNK], exact[CHUNK:]], [None, exact[:CHUNK]]
    plain = _payloads(bank.dispatch_chunks_batch(rows, None, prev_tails=tails))
    assert [d for d, _ in seen[len(raw):]] == [np.float32] * len(bank.classes)
    assert seen[len(raw)][1] == 2 * seen[0][1]
    for a, b in zip(raw, plain):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rows_of", ["off_grid", "pcm_grid"])
def test_f32_rows_upload_as_f32(env, monkeypatch, rows_of):
    """f32 rows go up as they are, whether or not they lie on the PCM grid:
    the round makes no pass over them to find out."""
    bank, exact, _, off_grid = env
    audio = off_grid if rows_of == "off_grid" else exact
    seen = _uploads(monkeypatch)
    monkeypatch.setattr(native, "pack_pcm16_into", lambda *a: pytest.fail("rows were tested"))
    bank.dispatch_chunks_batch([audio[:CHUNK], audio[CHUNK:]], None)
    bank.dispatch_chunk(audio[:CHUNK], None)
    assert [d for d, _ in seen] == [np.float32] * (2 * len(bank.classes))


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_a_mixed_round_gives_each_row_the_payload_it_has_alone(env, monkeypatch, mode):
    """An f32 row on the PCM grid, an off-grid row, an int16 row and an
    idle row in one round: the round goes up as f32, and every row's
    payload equals that row dispatched alone (where the int16 row goes up
    as int16), in both schedules; the int16 row's equals its f32 twin's."""
    bank, exact, pcm, off_grid = env
    seen = _uploads(monkeypatch)
    rows = [exact[CHUNK:], off_grid[:CHUNK], pcm[CHUNK:], np.zeros(0, np.float32)]
    tails = [exact[:CHUNK], None, pcm[:CHUNK], None]
    mixed = _payloads(bank.dispatch_chunks_batch(rows, None, mode=mode, prev_tails=tails))
    assert {d for d, _ in seen} == {np.dtype(np.float32)}
    del seen[:]
    for bi, (row, tail) in enumerate(zip(rows, tails)):
        alone = _payloads(bank.dispatch_chunks_batch([row], None, mode=mode, prev_tails=[tail]))
        for a, b in zip(mixed, alone):
            assert a[bi].tobytes() == b[0].tobytes(), f"row {bi}"
    n = len(bank.classes)
    assert [d for d, _ in seen] == [
        dt for dt in (np.float32, np.float32, np.int16, np.int16) for _ in range(n)]
    for a in mixed:
        assert a[0].tobytes() == a[2].tobytes()
    other = "scan" if mode == "vmap" else "vmap"
    again = _payloads(bank.dispatch_chunks_batch(rows, None, mode=other, prev_tails=tails))
    for a, b in zip(mixed, again):
        assert a.tobytes() == b.tobytes()


def test_results_equal_the_jax_bank_on_packed_and_plain_rows(env):
    bank, exact, _, off_grid = env
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jbank = JaxDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()
    for audio in (exact, off_grid):
        chunks = [audio[:CHUNK], audio[CHUNK:]]
        got = bank.process_chunks_batch(chunks, None)
        assert got == jbank.process_chunks_batch(chunks, None)
        assert any(v for r in got for v in r.values())
        assert bank.process_chunk(chunks[1], chunks[0]) == got[1]


PACK_CASES = {
    "pcm_grid": lambda: _on_grid(_audio(5, 3))[0],
    "full_scale": lambda: np.array([-1.0, 32767 / 32768, 0.0, -0.0, 1 / 32768], np.float32),
    "off_grid": lambda: _audio(6, 3).astype(np.float32),
    "one_over": lambda: np.array([0.5, 1.0], np.float32),
    "empty": lambda: np.zeros(0, np.float32),
}


@pytest.mark.parametrize("library", [True, False], ids=["with_library", "numpy"])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_pcm16_into_agrees_with_the_jax_pack(case, library, monkeypatch):
    """The host library's pack (what a caller holding f32 samples of 16-bit
    PCM uses to hand int16 on): same verdict as ``try_pack_pcm16``; when
    exact, the int16 row decodes on the device to the input's values and
    the tail is zero. Without the library it declines (None)."""
    x = PACK_CASES[case]()
    out = np.full(len(x) + 6, 77, dtype=np.int16)
    if not library:
        monkeypatch.setattr(native, "_load", lambda: None)
        assert native.pack_pcm16_into(x, out) is None
        return
    if not native.native_available():
        pytest.skip("the native host library could not be built here")
    ok = native.pack_pcm16_into(x, out)
    even = x if len(x) % 2 == 0 else np.append(x, np.float32(0))
    assert ok == (jpacking.try_pack_pcm16(even) is not None)
    if ok:
        decoded = tpacking.pcm16_to_f32(torch.from_numpy(out)).numpy()
        assert np.array_equal(decoded[: len(x)], x) and not out[len(x):].any()
        assert np.array_equal(decoded[: len(x)], native.pcm16_to_f32_mono(out[: len(x)]))


def test_dispatch_phase_seconds_has_the_jax_keys_and_grows(env):
    bank, exact, _, _ = env
    phases = tbank_module.dispatch_phase_seconds
    assert list(phases) == list(jbank_module.dispatch_phase_seconds)
    before = dict(phases)
    bank.collect_chunks_batch(bank.dispatch_chunks_batch([exact[:CHUNK], exact[CHUNK:]], None))
    assert all(phases[k] > before[k] for k in phases)
    assert isinstance(bank, PatternBank)


# ── The staging pool ──


def _fresh_bank():
    return AudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()


@pytest.fixture(scope="module")
def jax_bank():
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    return JaxDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()


def _pooled(bank):
    return [buf for bufs in bank._staging.values() for buf in bufs]


def test_payload_staging_buffers_recycle():
    """The twin of the JAX package's test of the same name
    (tests/test_offline_scan.py): repeated batch scans reuse pooled
    buffers, and a recycled buffer carries each scan's own samples, so each
    scan finds its own hit and not the other's; the detections are the
    JAX detector's."""
    rng = np.random.default_rng(9)
    clip = AudioClip(name="c", audio=(0.4 * rng.standard_normal(SR)).astype(np.float32),
                     sample_rate=SR)
    det = AudioPatternDetector(audio_clips=[clip], device="cpu", seconds_per_chunk=5)
    bank = det._ensure_bank()
    audio1 = (0.01 * rng.standard_normal(30 * SR)).astype(np.float32)
    audio1[12 * SR : 13 * SR] += clip.audio
    audio2 = (0.01 * rng.standard_normal(30 * SR)).astype(np.float32)
    audio2[21 * SR : 22 * SR] += clip.audio

    r1, _ = det.find_clip_in_array(audio1, batch_size=3)
    assert bank._staging, "no staging buffers returned to the pool"
    pooled = {k: [id(b) for b in v] for k, v in bank._staging.items()}
    r2, _ = det.find_clip_in_array(audio2, batch_size=3)
    assert any(abs(t - 12.0) < 0.01 for t in r1["c"]), r1
    assert any(abs(t - 21.0) < 0.01 for t in r2["c"]), r2
    assert not any(abs(t - 12.0) < 0.01 for t in r2["c"]), r2
    reused = any(id(b) in ids for k, ids in pooled.items() for b in bank._staging.get(k, []))
    assert reused, "second scan did not reuse any pooled staging buffer"
    jdet = JaxDetector([jclip.AudioClip(**dataclasses.asdict(clip))], seconds_per_chunk=5)
    assert (r1, r2) == tuple(jdet.find_clip_in_array(a, batch_size=3)[0]
                             for a in (audio1, audio2))


@pytest.mark.parametrize("mode", ["vmap", "scan"])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_a_recycled_buffer_keeps_nothing_of_the_last_round(env, jax_bank, mode, dtype):
    """A round of two full rows, collected, then a round of a short row and
    a zero-length row: the second round gets the first's buffer back, its
    tails past each row are zero, and its payloads are a fresh bank's bit
    for bit; its results are the JAX bank's."""
    _, exact, pcm, off_grid = env
    audio = pcm if dtype == "int16" else off_grid
    bank, fresh = _fresh_bank(), _fresh_bank()
    bank.collect_chunks_batch(bank.dispatch_chunks_batch(
        [audio[CHUNK:]] * 2, None, mode=mode, prev_tails=[audio[:CHUNK]] * 2))
    (buf,) = _pooled(bank)
    s_len = buf.shape[1]
    assert buf.dtype == (np.int16 if dtype == "int16" else np.float32)
    assert (buf != 0).mean() > 0.9, "the first round left no samples to go stale"
    rows, tails = [audio[: 3 * SR], audio[:0]], [None, None]
    dispatched = bank.dispatch_chunks_batch(rows, None, mode=mode, prev_tails=tails)
    assert all(rec[4] is buf for rec in dispatched) and not _pooled(bank)
    assert not buf[0, 3 * SR :].any() and not buf[1].any() and buf.shape == (2, s_len)
    want = fresh.dispatch_chunks_batch(rows, None, mode=mode, prev_tails=tails)
    for a, b in zip(_payloads(dispatched), _payloads(want)):
        assert a.tobytes() == b.tobytes()
    got = bank.collect_chunks_batch(dispatched)
    assert got == fresh.collect_chunks_batch(want)
    assert got == jax_bank.collect_chunks_batch(
        jax_bank.dispatch_chunks_batch(rows, None, mode=mode, prev_tails=tails))
    assert _pooled(bank) == [buf]


def test_rounds_in_flight_hold_distinct_buffers(env):
    """Two rounds dispatched before either is collected stage in two
    buffers; collected in the other order, each gives its own results, and
    both buffers come back."""
    _, exact, _, off_grid = env
    bank = _fresh_bank()
    first, second = [exact[:CHUNK], exact[CHUNK:]], [off_grid[:CHUNK], off_grid[CHUNK:]]
    d1 = bank.dispatch_chunks_batch(first, None)
    d2 = bank.dispatch_chunks_batch(second, None)
    assert d1[0][4] is not d2[0][4] and not _pooled(bank)
    assert bank.collect_chunks_batch(d2) == _fresh_bank().process_chunks_batch(second, None)
    assert bank.collect_chunks_batch(d1) == _fresh_bank().process_chunks_batch(first, None)
    assert {id(b) for b in _pooled(bank)} == {id(d1[0][4]), id(d2[0][4])}


def test_the_pool_keeps_at_most_four_buffers_a_key(env):
    """Six rounds in flight take six buffers; collected, four stay."""
    _, exact, _, _ = env
    bank = _fresh_bank()
    chunks = [exact[:CHUNK], exact[CHUNK:]]
    rounds = [bank.dispatch_chunks_batch(chunks, None) for _ in range(6)]
    assert len({id(d[0][4]) for d in rounds}) == 6
    for d in rounds:
        bank.collect_chunks_batch(d)
    assert [len(v) for v in bank._staging.values()] == [4]
    # A round of another size is another key.
    bank.collect_chunks_batch(bank.dispatch_chunks_batch(chunks[:1], None))
    assert sorted(len(v) for v in bank._staging.values()) == [1, 4]


def test_single_chunk_dispatch_recycles_at_collect(env):
    """``dispatch_chunk`` stages through the same pool: the buffer is out
    while the chunk is in flight and back after its collect."""
    _, exact, _, _ = env
    bank = _fresh_bank()
    dispatched = bank.dispatch_chunk(exact[CHUNK:], exact[:CHUNK])
    assert not _pooled(bank)
    assert bank.collect_chunk(dispatched) == bank.process_chunk(exact[CHUNK:], exact[:CHUNK])
    assert [id(b) for b in _pooled(bank)] == [id(dispatched[0][3])]


@pytest.mark.parametrize("path", ["row_sharding", "bank_shards"])
def test_a_sharded_round_recycles_only_after_every_part(env, monkeypatch, path):
    """A round spread over two logical shards (``sharding=``), and a chunk
    over a 2-shard bank (``BankShardedBank``): the staging buffer goes
    back only after every shard's payload has reached the host."""
    _, exact, _, off_grid = env
    bank = _fresh_bank()
    log = []
    numpy, put = PayloadHandle.numpy, PatternBank._pool_put

    def logging_numpy(self):
        log.append("part")
        return numpy(self)

    def logging_put(self, buf):
        log.append("put")
        return put(self, buf)

    monkeypatch.setattr(PayloadHandle, "numpy", logging_numpy)
    monkeypatch.setattr(PatternBank, "_pool_put", logging_put)
    mesh = make_mesh({"stream": 2}, devices=["cpu"] * 2)
    if path == "row_sharding":
        rows = [exact[:CHUNK], exact[CHUNK:], off_grid[:CHUNK], off_grid[CHUNK:]]
        got = bank.collect_chunks_batch(
            bank.dispatch_chunks_batch(rows, None, sharding=RowSharding(mesh)))
        seen = list(log)
        assert got == _fresh_bank().process_chunks_batch(rows, None)
    else:
        sharded = BankShardedBank(bank, make_mesh({"bank": 2}, devices=["cpu"] * 2))
        got = sharded.collect_chunk(sharded.dispatch_chunk(exact[CHUNK:], exact[:CHUNK]))
        seen = list(log)
        assert got == _fresh_bank().process_chunk(exact[CHUNK:], exact[:CHUNK])
    assert seen == ["part", "part", "put"] * len(bank.classes)
    assert len(_pooled(bank)) == len(bank.classes)


# ── The scan schedule: each row staged, copied up and launched in turn ──


def _station_rows(n, kind, seed=20):
    """``n`` independent stations' (chunk, lookback tail) rows, every third
    row idle (zero length), the others each with a normal hit and a marker
    tone: int16 rows, f32 rows off the PCM grid, or the two in turn
    (``mixed``)."""
    rows = []
    for i in range(n):
        if i % 3 == 2:
            rows.append((np.zeros(0, np.float32), None))
            continue
        audio = _audio(seed + i, 2 * CHUNK_S, normal=(3.0 + 0.37 * i,),
                       marker=(CHUNK_S + 2.0 + 0.29 * i,))
        if kind == "int16" or (kind == "mixed" and i % 2):
            audio = _on_grid(audio)[1]
        else:
            audio = audio.astype(np.float32)
        rows.append((audio[CHUNK:], audio[:CHUNK] if i % 2 == 0 else None))
    return rows


def _dispatch(bank, rows, mode):
    return bank.dispatch_chunks_batch([c for c, _ in rows], None, mode=mode,
                                      prev_tails=[t for _, t in rows])


@pytest.fixture
def captured_bank(monkeypatch):
    """A bank whose class steps are captured on the stand-in backend of
    tests/test_torch_capture.py: a scan round replays the one-row graph."""
    from audio_pattern_detector_tpu_torch.models import captured
    from tests.test_torch_capture import RecordingBackend

    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)
    return AudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S,
                                capture=True)._ensure_bank()


SCAN_CASES = [(1, "int16"), (1, "f32"), (3, "int16"), (3, "f32"), (3, "mixed"), (16, "mixed")]


@pytest.mark.parametrize("n,kind", SCAN_CASES, ids=[f"{n}_{k}" for n, k in SCAN_CASES])
def test_a_row_by_row_scan_round_is_the_whole_round_bit_for_bit(captured_bank, jax_bank, n, kind):
    """A scan round staged, copied up and replayed row by row: its payload
    is bit for bit the vmap round's and the eager step's on the same rows
    staged whole, in the dtype the whole round decides (int16 only where
    every non-empty row is int16; an idle row does not count), and its
    results are the JAX bank's."""
    bank, eager = captured_bank, _fresh_bank()
    rows = _station_rows(n, kind)
    scan = _dispatch(bank, rows, "scan")
    assert {rec[4].dtype for rec in scan} == {np.dtype(np.int16 if kind == "int16" else np.float32)}
    vmap = _dispatch(eager, rows, "vmap")
    for (sw, handle, raws, _, staged), (_, want, *_) in zip(scan, vmap):
        got = handle.numpy()
        assert got.shape[0] == n and got.tobytes() == want.numpy().tobytes()
        whole = eager._staged_sections(eager.classes[sw]["section_len"],
                                       [eager._section_parts(sw, c, t) for c, t in rows])[0]
        assert whole.tobytes() == staged.tobytes()
        each = torch.stack([eager.step(sw, torch.from_numpy(whole[bi]), len(raws[bi]))
                            for bi in range(n)])
        assert each.numpy().tobytes() == got.tobytes()
    assert [s.key.rows for s in bank.graphs.steps()] == [1] * len(bank.classes)
    got = bank.collect_chunks_batch(scan)
    assert got == eager.collect_chunks_batch(vmap)
    assert got == jax_bank.collect_chunks_batch(_dispatch(jax_bank, rows, "scan"))
    assert any(v for r in got for v in r.values())


def test_two_scan_rounds_in_flight_recycle_their_buffers_only_at_collect(captured_bank, jax_bank):
    """A collected round leaves its buffer in the pool; the next two scan
    rounds, both dispatched before either is collected, take that buffer
    and a new one, each row staged in its own round's buffer; each buffer
    comes back only at its own round's collect, and each round's results
    are its own (the JAX bank's)."""
    bank = captured_bank
    warm, first, second = (_station_rows(4, "int16", seed) for seed in (40, 50, 60))
    bank.collect_chunks_batch(_dispatch(bank, warm, "scan"))
    (recycled,) = _pooled(bank)
    d1, d2 = _dispatch(bank, first, "scan"), _dispatch(bank, second, "scan")
    assert d1[0][4] is recycled and d2[0][4] is not recycled and not _pooled(bank)
    want = [jax_bank.collect_chunks_batch(_dispatch(jax_bank, r, "scan")) for r in (first, second)]
    assert bank.collect_chunks_batch(d2) == want[1]
    assert _pooled(bank) == [d2[0][4]]
    assert bank.collect_chunks_batch(d1) == want[0]
    assert {id(b) for b in _pooled(bank)} == {id(recycled), id(d2[0][4])}


def test_a_scan_round_replays_its_first_row_before_it_packs_its_last(captured_bank, monkeypatch):
    """Recording a warmed 4-row scan round on the stand-in capture backend:
    each row is packed, uploaded and launched before the next is packed
    (the packs and the replays themselves alternate), so the round's first
    ``step.replay`` starts before its last ``bank.pack`` ends; the three
    rows packed behind a launch count as ``overlapped_rows``."""
    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.utils import profiling

    bank = captured_bank
    rows = _station_rows(4, "int16")
    bank.collect_chunks_batch(_dispatch(bank, rows, "scan"))  # the key's capture
    log = []
    pack_row, run = PatternBank._pack_row, captured.CapturedStep.run

    def logged_pack(buf, bi, parts):
        log.append(("pack", bi))
        pack_row(buf, bi, parts)

    def logged_run(self):
        log.append(("run",))
        return run(self)

    monkeypatch.setattr(PatternBank, "_pack_row", staticmethod(logged_pack))
    monkeypatch.setattr(captured.CapturedStep, "run", logged_run)
    with profiling.recording():
        bank.collect_chunks_batch(_dispatch(bank, rows, "scan"))
    assert log == [e for bi in range(4) for e in (("pack", bi), ("run",))]
    spans = [s for s in profiling.spans() if s.name.startswith(("bank.", "step."))]
    replays = [s for s in spans if s.name == "step.replay"]
    packs = [s for s in spans if s.name == "bank.pack"]
    assert len(replays) == len(packs) == 4 and "step.capture" not in {s.name for s in spans}
    assert replays[0].start_ns < packs[-1].end_ns
    assert [s.name for s in spans if s.name != "step.load"] == [
        "bank.sections", *["bank.pack", "bank.upload", "bank.launch", "step.replay"] * 4,
        "bank.prefetch"]
    for pack, replay in zip(packs[1:], replays):
        assert replay.end_ns <= pack.start_ns
    assert profiling.counters()["overlapped_rows"] == 3


def _two_class_bank():
    """The bank of ``_clips`` with a 1.6 s clip besides, in a window class
    of its own (2 s)."""
    t = np.arange(int(1.6 * SR)) / SR
    long = (0.4 * np.sin(2 * np.pi * 420.0 * t) * np.hanning(len(t))).astype(np.float32)
    clips = [*_clips(), AudioClip(name="long", audio=long, sample_rate=SR)]
    return AudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_overlapped_rows_is_b_less_one_a_class_in_scan_and_0_in_vmap(env, mode):
    from audio_pattern_detector_tpu_torch.utils import profiling

    _, _, pcm, _ = env
    bank = _two_class_bank()
    assert len(bank.classes) == 2
    for n in (1, 4):
        rows = [(pcm[CHUNK:], pcm[:CHUNK])] * n
        with profiling.recording():
            bank.collect_chunks_batch(_dispatch(bank, rows, mode))
        assert profiling.counters()["overlapped_rows"] == (2 * (n - 1) if mode == "scan" else 0)
    counted = profiling.counters()
    bank.collect_chunks_batch(_dispatch(bank, rows, mode))  # the recorder off: nothing counted
    assert profiling.counters() == counted


def test_dispatch_phase_seconds_keeps_its_keys_and_sums_the_rows_in_scan(env):
    """In the scan schedule pack, upload and launch come once a row: each
    phase grows by the sum of its rows' spans, so ``pack`` over the rows
    is still the pack a row; the keys stay the JAX bank's."""
    from audio_pattern_detector_tpu_torch.utils import profiling

    _, _, pcm, _ = env
    bank = _two_class_bank()
    phases = tbank_module.dispatch_phase_seconds
    before = dict(phases)
    with profiling.recording():
        bank.collect_chunks_batch(_dispatch(bank, [(pcm[CHUNK:], pcm[:CHUNK])] * 3, "scan"))
    assert list(phases) == list(jbank_module.dispatch_phase_seconds)
    spans = profiling.spans()
    for key in phases:
        got = [s for s in spans if s.name == f"bank.{key}"]
        assert len(got) == (3 if key in ("pack", "upload", "launch") else 1) * len(bank.classes)
        assert phases[key] - before[key] == pytest.approx(
            1e-9 * sum(s.end_ns - s.start_ns for s in got), rel=1e-6, abs=1e-12)
