"""The upload staging of the port's bank: rows of 16-bit PCM cross as
int16, and ``dispatch_phase_seconds`` splits a dispatch's host time.

The JAX bank packs rows of 16-bit PCM into half the upload bytes
(``models/bank.py`` with ``ops/packing``); the port uploads rows that
arrive as int16 as int16, and f32 rows as f32 without testing them for the
PCM grid (a source of 16-bit PCM hands int16 on). The device decode of an
int16 row is bitwise the host decode, so payloads are compared for bit
equality: with the upload the f32 form of the same samples took, with the
row dispatched alone, between the two schedules, and (results) with the
JAX bank on the same rows. The host library's ``pack_pcm16_into`` is held
against the JAX package's pack.
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
from audio_pattern_detector_tpu_torch.models.bank import PatternBank
from audio_pattern_detector_tpu_torch.models.detector import MARKER_TONE_STRATEGY
from audio_pattern_detector_tpu_torch.ops import packing as tpacking

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
