"""The port's batched class step (``mode="vmap"``) against the JAX package
and against the port's own scan schedule.

Inputs come from numpy seeds; sections are a few seconds long and banks
hold two clips. Three references:

* the JAX ops under ``jax.vmap`` and the JAX bank's vmap program (with
  the XLA mask and with the Pallas kernel in interpret mode): LUFS within
  1e-3 LU, normalised correlation within atol 1e-5 (values in [0, 1]),
  normalised sections bitwise on the same LUFS, payloads exact (they hold
  only integer-valued fields: positions, selected bits, flags, overflow
  bits, all far from a threshold on this audio);
* the port's scan schedule on the same rows: payloads bitwise, results
  and flagged-row routes equal. Between the port's batched and single-row
  ops the f32 intermediates agree within 1e-5 LU and atol 1e-6;
* the JAX serial engine for detections, and the CLI's stdout in scan mode
  for the CLI's vmap runs (byte-identical).

On the CPU the candidate scan is its plain version in both schedules; the
kernel's batched shapes run on a card (tests/test_torch_cuda.py).
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.ops import correlate as jcorr
from audio_pattern_detector_tpu.ops import hostref
from audio_pattern_detector_tpu.ops import loudness as jloud
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import cli
from audio_pattern_detector_tpu_torch.models import bank as tbank_module
from audio_pattern_detector_tpu_torch.models.bank import (
    PatternBank,
    _split_fused,
    class_step,
    class_step_fused,
    unpack_group,
)
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.ops import correlate as tcorr
from audio_pattern_detector_tpu_torch.ops import loudness as tloud
from audio_pattern_detector_tpu_torch.ops import verify as tverify
from audio_pattern_detector_tpu_torch.ops.consts import consts_from_numpy
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")
CHUNK_S = 10
CHUNK = CHUNK_S * SR
LUFS_ATOL = 1e-3  # torch against JAX
CORR_ATOL = 1e-5
SCHEDULE_LUFS_ATOL = 1e-5  # the port's batched against its single-row form
SCHEDULE_ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")
RTHK = os.path.join(AUDIO, "rthk_section_with_beep.wav")
RTHK_TOML = os.path.join(AUDIO, "clips", "rthk_beep.apd.toml")
CBS = os.path.join(AUDIO, "cbs_news_audio_section.wav")
CBS_CLIP = os.path.join(AUDIO, "clips", "cbs_news.wav")


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(c):
    fields = {
        f.name: getattr(c, f.name) if f.metadata.get("static") else np.asarray(getattr(c, f.name))
        for f in dataclasses.fields(c)
    }
    return consts_from_numpy(type(c).__name__, fields, CPU)


def _pcm16(audio):
    return np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)


def _clips():
    """A 0.6 s normal clip and a 941 Hz marker tone (tests/test_torch_engine.py)."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tm = np.arange(int(0.25 * SR)) / SR
    marker = np.sin(2 * np.pi * 941.0 * tm).astype(np.float32)
    return [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(
            name="m", audio=marker, sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY, strategy_params={"dominant_frequency_hz": 941.0},
        ),
    ]


def _audio(seed, seconds, normal=(), marker=(), flood_at=None):
    clip, tone = (c.audio for c in _clips())
    audio = 0.01 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
    starts = list(normal)
    if flood_at is not None:  # 18 copies 0.62 s apart: past the 16 lean lanes
        starts += [flood_at + 0.62 * k for k in range(18)]
    for s in starts:
        o = int(s * SR)
        audio[o : o + len(clip)] += clip
    for s in marker:
        o = int(s * SR)
        audio[o : o + len(tone)] += 0.8 * tone
    return audio


def _torch_det(height_min=None):
    kwargs = {} if height_min is None else {"height_min": height_min}
    return TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S, **kwargs)


def _torch_stream(samples):
    return AudioStream(
        name="s", audio_stream=io.BytesIO(samples.tobytes()), sample_rate=SR,
        sample_dtype=samples.dtype,
    )


@pytest.fixture(scope="module")
def env():
    """Three streams (int16 with hits in several chunks and a short last
    chunk; f32; int16 with a flooded second chunk), a JAX detector over the
    same clips, and each stream's detections from the JAX serial engine."""
    audios = [
        _pcm16(_audio(1, 37.5, normal=(4.0, 9.8, 33.0), marker=(17.0,))),
        _audio(2, 25.0, normal=(12.0,), marker=(21.0,)).astype(np.float32),
        _pcm16(_audio(4, 30.0, normal=(25.0,), flood_at=9.05)),
    ]
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jdet = AudioPatternDetector(jclips, seconds_per_chunk=CHUNK_S)
    serial = [
        jdet.find_clip_in_audio(jclip.AudioStream(
            name="s", audio_stream=io.BytesIO(a.tobytes()), sample_rate=SR, sample_dtype=a.dtype,
        ))
        for a in audios
    ]
    return audios, jdet, serial


def _chunked(audio):
    return [audio[o : o + CHUNK] for o in range(0, len(audio), CHUNK)]


def _round_rows(audios):
    """One round of independent rows: int16 with an int16 tail, f32 with
    no tail (a first chunk), a zero-length idle row, the flooded int16
    chunk with its tail, a short f32 row with an f32 tail."""
    i16, f32, flood = audios
    return [
        (i16[CHUNK : 2 * CHUNK], i16[:CHUNK]),
        (f32[:CHUNK], None),
        (np.zeros(0, np.float32), None),
        (flood[CHUNK : 2 * CHUNK], flood[:CHUNK]),
        (f32[2 * CHUNK :], f32[CHUNK : 2 * CHUNK]),
    ]


# ── Batched ops against the JAX ops under jax.vmap ──


def _loud_sections(s_len):
    """(B, S) sections and their lengths: full, short path (3,000 samples),
    zero length, half (gated), full length of silence."""
    lens = np.array([s_len, 3000, 0, s_len // 2, s_len], dtype=np.int32)
    sections = np.zeros((len(lens), s_len), np.float32)
    for bi, n in enumerate(lens[:4]):
        rng = np.random.default_rng(100 + bi)
        t = np.arange(n) / SR
        sections[bi, :n] = (0.1 + 0.05 * bi) * (
            np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
            + 0.3 * rng.standard_normal(n)
        ).astype(np.float32)
    return sections, lens


@pytest.mark.parametrize("s_len", [3 * SR, 21 * SR], ids=["single_fft", "overlap_save"])
def test_batched_loudness_against_jax_vmap(s_len):
    sections, lens = _loud_sections(s_len)
    jc = jloud.build_loudness_consts(s_len, SR)
    tc = tloud.build_loudness_consts(s_len, SR, CPU)
    want = np.asarray(jax.vmap(jloud.integrated_loudness_device, in_axes=(0, 0, None))(
        jnp.asarray(sections), jnp.asarray(lens), jc))
    got_t = tloud.integrated_loudness_device(_t(sections), _t(lens), tc)
    got = got_t.numpy()
    assert got.shape == (5,) and got.dtype == np.float32
    silent = np.isneginf(want)
    assert silent.tolist() == [False, False, True, False, True]
    np.testing.assert_array_equal(np.isneginf(got), silent)
    np.testing.assert_allclose(got[~silent], want[~silent], rtol=0, atol=LUFS_ATOL)
    single = np.array([
        float(tloud.integrated_loudness_device(_t(sections[bi]), int(lens[bi]), tc))
        for bi in range(5)
    ], dtype=np.float32)
    np.testing.assert_array_equal(np.isneginf(single), silent)
    np.testing.assert_allclose(got[~silent], single[~silent], rtol=0, atol=SCHEDULE_LUFS_ATOL)
    print("max |LUFS batched - single|", np.abs(got[~silent] - single[~silent]).max())
    # Normalisation on the same LUFS: bitwise the JAX op's, row for row.
    jn = np.asarray(jax.vmap(jloud.loudness_normalize_device)(jnp.asarray(sections), jnp.asarray(want)))
    tn = tloud.loudness_normalize_device(_t(sections), _t(want)).numpy()
    np.testing.assert_array_equal(tn, jn)
    assert not np.isnan(tn).any() and not tn[2].any()


def _self_corr(clips):
    cc = np.stack([np.abs(hostref.fft_correlate_1d(c, c, mode="full")) for c in clips])
    smax = cc.max(axis=1)
    return (cc / smax[:, None]).astype(np.float32), smax


@pytest.mark.parametrize("chunk_s", [2, 9], ids=["single_fft", "overlap_save"])
def test_batched_bank_correlate_against_jax_vmap(chunk_s):
    s_len = (1 + chunk_s) * SR
    rng = np.random.default_rng(chunk_s)
    lens = np.array([s_len, s_len - 3333, 0], dtype=np.int32)
    sections = (0.05 * rng.standard_normal((3, s_len))).astype(np.float32)
    geom = jcorr.class_overlap_save_geometry(s_len, [SR, 2000])
    assert (geom is None) == (chunk_s == 2)
    banks = [
        (0.3 * np.random.default_rng(seed).standard_normal((2, m))).astype(np.float32)
        for m, seed in ((SR, 7), (2000, 8))
    ]
    for clips in banks:  # a hit of each bank's second clip in row 0
        sections[0, SR + 500 : SR + 500 + clips.shape[1]] += 0.8 * clips[1]
    for bi, n in enumerate(lens):
        sections[bi, n:] = 0.0
    seg = None
    for clips in banks:
        m = clips.shape[1]
        _, smax = _self_corr(clips)
        jc = jcorr.build_correlation_bank(clips, smax, s_len, shared_geometry=geom)
        tc = _carry(jc)
        if geom is not None and seg is None:
            seg = tcorr.section_segment_spectra(_t(sections), tc)
            assert seg.shape[:2] == (3, tc.num_segments)
        want, wl = jax.vmap(lambda s, n: jcorr.bank_correlate(s, n, jc))(
            jnp.asarray(sections), jnp.asarray(lens))
        got, vl = tcorr.bank_correlate(_t(sections), _t(lens), tc, seg)
        assert got.shape == (3, 2, s_len + m - 1)
        np.testing.assert_array_equal(vl.numpy(), np.asarray(wl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CORR_ATOL)
        raw, _ = tcorr.bank_correlate_abs(_t(sections), _t(lens), tc, seg)
        for bi, n in enumerate(lens):
            assert np.all(got.numpy()[bi, :, n + m - 1 :] == 0.0)
            one, one_vl = tcorr.bank_correlate(_t(sections[bi]), int(n), tc)
            assert one_vl == int(vl[bi])
            np.testing.assert_allclose(got[bi].numpy(), one.numpy(), rtol=0, atol=SCHEDULE_ATOL)
            one_raw, _ = tcorr.bank_correlate_abs(_t(sections[bi]), int(n), tc)
            scale = max(float(one_raw.max()), 1e-30)
            np.testing.assert_allclose(raw[bi].numpy() / scale, one_raw.numpy() / scale,
                                       rtol=0, atol=SCHEDULE_ATOL)
        assert not got.numpy()[2].any()


def test_batched_verifiers_equal_each_round_alone():
    """R = B * G round-major rows: row r reads section r // G and clip
    r % G's constants, so a round's rows equal that round verified alone."""
    rng = np.random.default_rng(5)
    b, k = 3, 6
    m, freq = 2000, 941.0
    tone = np.sin(2 * np.pi * freq * np.arange(m) / SR).astype(np.float32)
    sections = (0.01 * rng.standard_normal((b, 4 * SR))).astype(np.float32)
    offs = [SR + 77, 2 * SR, 3 * SR - 500]
    for bi, o in enumerate(offs):
        sections[bi, o : o + m] += 0.8 * tone
    mc = tverify.build_marker_verify_consts(m, SR, np.array([freq, 1040.0]), [{}, {}], CPU)
    pos = rng.integers(0, 4 * SR + m - 1, (b * 2, k))
    for bi, o in enumerate(offs):
        pos[2 * bi : 2 * bi + 2, 0] = o + m - 1
    alive = rng.random((b * 2, k)) < 0.9
    alive[:, 0] = True
    got = tverify.verify_marker(_t(sections), _t(pos), _t(alive), mc)
    assert got.shape == (b * 2, k)
    for bi in range(b):
        rows = slice(2 * bi, 2 * bi + 2)
        alone = tverify.verify_marker(_t(sections[bi]), _t(pos[rows]), _t(alive[rows]), mc)
        assert torch.equal(got[rows], alone)
    assert got[::2, 0].all() and not got[1::2, 0].any()  # clip 0 hits, clip 1 (1040 Hz) never

    clips = (0.3 * rng.standard_normal((2, SR))).astype(np.float32)
    cc, smax = _self_corr(clips)
    s_len = 5 * SR
    secs = (0.01 * rng.standard_normal((b, s_len))).astype(np.float32)
    for bi in range(b):
        secs[bi, (bi + 1) * SR : (bi + 2) * SR] += clips[bi % 2]
    cbank = tcorr.build_correlation_bank(clips, smax, s_len, CPU)
    corr, _ = tcorr.bank_correlate(_t(secs), torch.full((b,), s_len, dtype=torch.int32), cbank)
    nc = tverify.build_normal_verify_consts(cc, SR, SR, CPU)
    pos = rng.integers(0, corr.shape[-1], (b * 2, k))
    for bi in range(b):
        pos[2 * bi + bi % 2, 0] = (bi + 1) * SR + SR - 1
    alive = np.ones((b * 2, k), bool)
    acc, sim, r = tverify.verify_normal(corr.reshape(b * 2, -1), _t(pos), _t(alive), nc)
    for bi in range(b):
        rows = slice(2 * bi, 2 * bi + 2)
        a1, s1, r1 = tverify.verify_normal(corr[bi], _t(pos[rows]), _t(alive[rows]), nc)
        assert torch.equal(acc[rows], a1)
        np.testing.assert_allclose(sim[rows].numpy(), s1.numpy(), rtol=0, atol=SCHEDULE_ATOL)
        np.testing.assert_allclose(r[rows].numpy(), r1.numpy(), rtol=0, atol=SCHEDULE_ATOL)
        assert acc[2 * bi + bi % 2, 0]
    assert int(acc.sum()) == b


# ── The bank's vmap program against the JAX bank's ──


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_xla_mask", "jax_pallas_interpret"])
def test_vmap_dispatch_payloads_identical_to_the_jax_bank(env, pallas):
    """``dispatch_chunks_batch(mode="vmap")`` on consecutive int16 chunks
    (a first chunk, full chunks with hits, a short last chunk): the (B,
    total) payload of the port equals the JAX bank's vmap program's."""
    audios, jdet, _ = env
    jbank = jdet._ensure_bank()
    tbank = _torch_det()._ensure_bank()
    assert jbank._metas == tbank._metas
    chunks = _chunked(audios[0])
    if pallas:  # the Pallas interpreter is slow: the two hit-bearing chunks
        chunks, tail = chunks[1:3], chunks[0]
    else:
        tail = None
    jbank._pallas = pallas
    try:
        want = jbank.dispatch_chunks_batch(chunks, tail, mode="vmap")
    finally:
        jbank._pallas = False
    got = tbank.dispatch_chunks_batch(chunks, tail, mode="vmap")
    assert [sw for sw, *_ in got] == [sw for sw, *_ in want]
    hit_rows = near_rows = 0
    for (sw, jflat, *_), (_, handle, *_) in zip(want, got):
        payload, jpayload = handle.numpy(), np.asarray(jflat)
        groups = tbank.classes[sw]["groups"]
        for g, packed, jpacked in zip(
            groups, _split_fused(payload, groups), _split_fused(jpayload, groups)
        ):
            k = g.k_verify
            _, sel, _, _ = unpack_group(packed, k)
            hit_rows += int(sel.any(axis=-1).sum())
            if not pallas:
                # The port's lean tier is the Pallas tier's port: it also
                # sends near-collapse rows to the wide rerun (flag 2),
                # which the XLA mask's tier does not know. Such a row keeps
                # its other fields and collects the same detections.
                near = (packed[..., 2 * k] == 2.0) & (jpacked[..., 2 * k] == 0.0)
                near_rows += int(near.sum())
                packed = packed.copy()
                packed[near, 2 * k] = 0.0
            np.testing.assert_array_equal(packed, jpacked)
    assert near_rows <= 1
    # 4.0 s, 9.8 s (in chunk 0 and in chunk 1's lookback), 17 s marker, 33 s.
    assert hit_rows + near_rows == (2 if pallas else 5)
    assert tbank.collect_chunks_batch(got) == jbank.collect_chunks_batch(want)


def test_batch_validation_messages_equal_the_jax_bank(env):
    _, jdet, _ = env
    jbank, tbank = jdet._ensure_bank(), _torch_det()._ensure_bank()
    chunk = [np.zeros(10, np.float32)]

    def error(fn):
        with pytest.raises(ValueError) as exc:
            fn()
        return str(exc.value)

    for call in (
        lambda b: b.dispatch_chunks_batch(chunk, None, mode="pmap"),
        lambda b: b.process_chunks_batch(chunk, None, mode="pmap"),
        lambda b: b.dispatch_chunks_batch(chunk, None, mode="scan", sharding=object()),
        lambda b: b.dispatch_chunks_batch(chunk * 2, None, prev_tails=[None]),
    ):
        assert error(lambda: call(tbank)) == error(lambda: call(jbank))
    assert tbank.process_chunks_batch([], None) == jbank.process_chunks_batch([], None) == []
    import inspect

    for name in ("dispatch_chunks_batch", "process_chunks_batch"):
        jsig = inspect.signature(getattr(jbank, name))
        tsig = inspect.signature(getattr(tbank, name))
        assert list(jsig.parameters) == list(tsig.parameters)
        assert jsig.parameters["mode"].default == tsig.parameters["mode"].default == "vmap"


# ── Inside the port: vmap against scan ──


def _dispatch_both(bank, rows):
    chunks, tails = [c for c, _ in rows], [t for _, t in rows]
    out = {}
    for mode in ("scan", "vmap"):
        before = (bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows)
        dispatched = bank.dispatch_chunks_batch(chunks, None, mode=mode, prev_tails=tails)
        payload = {sw: handle.numpy().copy() for sw, handle, *_ in dispatched}
        results = bank.collect_chunks_batch(dispatched)
        after = (bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows)
        out[mode] = (payload, results, tuple(a - b for a, b in zip(after, before)))
    return out


@pytest.mark.parametrize("case", ["mixed", "int16", "height_min_0"])
def test_vmap_payload_bitwise_equals_scan(env, case):
    """Rounds with a first chunk, a short chunk, a zero-length row, hits,
    a flooded row, and int16 and f32 rows together (uploaded as f32) or
    int16 rows only (uploaded as int16): every payload field equal, the
    flooded row rerun once per schedule, the idle row empty and unflagged."""
    audios, _, _ = env
    rows = _round_rows(audios)
    if case == "int16":
        i16 = audios[0]
        rows = [rows[0], (i16[:CHUNK], None), (np.zeros(0, np.int16), None), rows[3],
                (i16[3 * CHUNK :], i16[2 * CHUNK : 3 * CHUNK])]
    bank = _torch_det(height_min=0.0 if case == "height_min_0" else None)._ensure_bank()
    out = _dispatch_both(bank, rows)
    (pay_s, res_s, routes_s), (pay_v, res_v, routes_v) = out["scan"], out["vmap"]
    for sw in pay_s:
        np.testing.assert_array_equal(pay_v[sw].view(np.int32), pay_s[sw].view(np.int32))
        groups = bank.classes[sw]["groups"]
        for g, packed in zip(groups, _split_fused(pay_v[sw][2], groups)):
            _, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
            assert not (sel.any() or host_fb.any() or needs_full.any())
    assert res_v == res_s and routes_v == routes_s
    assert res_v[2] == {"c": [], "m": []} and len(res_v[3]["c"]) >= 16
    if case != "height_min_0":  # the general-plateau tier captures k_detect lanes: no rerun
        assert routes_v[0] >= 1
    assert sum(len(v) for r in res_v for v in r.values()) >= 18


def test_vmap_rows_do_not_depend_on_their_round(env):
    """A row's payload in a batched round equals the row dispatched alone,
    and the round's rows in another order give the same rows."""
    audios, _, _ = env
    rows = _round_rows(audios)
    bank = _torch_det()._ensure_bank()
    chunks, tails = [c for c, _ in rows], [t for _, t in rows]
    batch = bank.dispatch_chunks_batch(chunks, None, mode="vmap", prev_tails=tails)
    order = [3, 0, 4, 2, 1]
    shuffled = bank.dispatch_chunks_batch(
        [chunks[i] for i in order], None, mode="vmap", prev_tails=[tails[i] for i in order]
    )
    for (sw, hb, *_), (_, hs, *_) in zip(batch, shuffled):
        np.testing.assert_array_equal(hs.numpy().view(np.int32), hb.numpy()[order].view(np.int32))
    for bi, (chunk, tail) in enumerate(rows):
        alone = bank.dispatch_chunk(chunk, tail)
        for (sw, ha, *_), (_, hb, *_) in zip(alone, batch):
            np.testing.assert_array_equal(ha.numpy().view(np.int32), hb.numpy()[bi].view(np.int32))


def test_batched_class_step_groups_and_wide_tier(env):
    """``class_step`` on a (B, S) batch returns round-major (B * G, 2K+2)
    payloads per group that equal each section's own step, in the lean
    tier and in the wide tier; f32 intermediates within the stated
    tolerance."""
    audios, _, _ = env
    bank = _torch_det()._ensure_bank()
    (sw, cls), = bank.classes.items()
    s_len = cls["section_len"]
    consts = tuple((g.corr, g.verify) for g in cls["groups"])
    raws = [bank._raw_section(sw, c, t) for c, t in _round_rows(audios)]
    sections = torch.from_numpy(
        bank._section_rows(s_len, raws).astype(np.float32)
    )
    n_valids = torch.tensor([len(r) for r in raws], dtype=torch.int32)
    kw = dict(metas=bank._metas[sw], height_min=bank.height_min)
    for wide in (False, True):
        outs = class_step(sections, n_valids, cls["loud"], consts, wide=wide, **kw)
        for gi, (g, out) in enumerate(zip(cls["groups"], outs)):
            assert out.shape == (len(raws) * len(g.names), 2 * g.k_verify + 2)
        for bi, raw in enumerate(raws):
            one = class_step(sections[bi], len(raw), cls["loud"], consts, wide=wide, **kw)
            for g, out, o in zip(cls["groups"], outs, one):
                n = len(g.names)
                assert torch.equal(out[bi * n : (bi + 1) * n].view(torch.int32), o.view(torch.int32))
    fused = class_step_fused(sections, n_valids, cls["loud"], consts, **kw)
    assert fused.shape == (len(raws), sum(len(g.names) * (2 * g.k_verify + 2) for g in cls["groups"]))
    lufs = tloud.integrated_loudness_device(sections, n_valids, cls["loud"])
    norm = tloud.loudness_normalize_device(sections, lufs)
    for bi, raw in enumerate(raws):
        l1 = tloud.integrated_loudness_device(sections[bi], len(raw), cls["loud"])
        n1 = tloud.loudness_normalize_device(sections[bi], l1)
        if len(raw):
            assert abs(float(lufs[bi]) - float(l1)) <= SCHEDULE_LUFS_ATOL
        np.testing.assert_allclose(norm[bi].numpy(), n1.numpy(), rtol=0, atol=SCHEDULE_ATOL)


def test_batched_lean_step_makes_no_host_sync(env, monkeypatch):
    """Nothing in the batched lean step reads a tensor's value on the
    host: ``item``, ``tolist``, ``bool()``, ``int()``, ``float()``, an
    index conversion, ``cpu`` and ``numpy`` all raise while it runs."""
    audios, _, _ = env
    bank = _torch_det()._ensure_bank()
    (sw, cls), = bank.classes.items()
    raws = [bank._raw_section(sw, c, t) for c, t in _round_rows(audios)]
    sections = torch.from_numpy(bank._section_rows(cls["section_len"], raws).astype(np.float32))
    n_valids = torch.tensor([len(r) for r in raws], dtype=torch.int32)
    want = bank.step(sw, sections, n_valids)

    def forbidden(name):
        def raise_(*a, **k):
            raise AssertionError(f"the batched lean step called Tensor.{name}")
        return raise_

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    got = bank.step(sw, sections, n_valids)
    monkeypatch.undo()
    assert torch.equal(got, want)


# ── Twins of the JAX tests that pin the two modes ──


@pytest.mark.parametrize("tile", [None, 2])
def test_scan_and_vmap_modes_identical(env, tile):
    """tests/test_multistream.py::test_scan_and_vmap_modes_identical: the
    two sessions agree round by round, and each stream equals the JAX
    serial engine."""
    audios, _, serial = env
    sess_s = MultiStreamSession(_torch_det(), 3, tile=tile)  # default: scan
    sess_v = MultiStreamSession(_torch_det(), 3, tile=tile, batch_mode="vmap")
    assert sess_s._batch_mode == "scan" and sess_v._batch_mode == "vmap"
    per_stream = [_chunked(a) for a in audios]
    acc = [{"c": [], "m": []} for _ in audios]
    for r in range(max(len(c) for c in per_stream)):
        feed = [c[r] if r < len(c) else None for c in per_stream]
        out = sess_v.feed(list(feed))
        assert sess_s.feed(feed) == out, f"round {r}"
        for a, res in zip(acc, out):
            for name, ts in res.items():
                a[name].extend(ts)
    for i, (peaks, total) in enumerate(serial):
        assert acc[i] == peaks and sess_v.total_time(i) == total
    assert sess_v._bank.row_reruns == sess_s._bank.row_reruns >= 1
    assert sess_v._bank.host_path_rows == sess_s._bank.host_path_rows


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_stream_batch_modes_serial_identical(env, mode):
    """tests/test_stream_batch.py: 3 chunks per launch (a padded final
    batch) equals the serial loop, and the JAX serial engine."""
    audios, _, serial = env
    det = _torch_det()
    batched, total = det.find_clip_in_audio(
        _torch_stream(audios[0]), stream_batch=3, stream_batch_mode=mode
    )
    assert (batched, total) == _torch_det().find_clip_in_audio(_torch_stream(audios[0]))
    assert (batched, total) == serial[0]
    assert [round(t, 3) for t in batched["c"]] == [4.0, 9.8, 33.0]


def test_scan_mode_matches_vmap_and_streaming(env):
    """tests/test_offline_scan.py: ``find_clip_in_array`` in both modes
    equals the streaming loop; the padded rows of the last batch add
    nothing."""
    audios, _, serial = env
    for audio, want in zip(audios[:2], serial[:2]):
        vmapped = _torch_det().find_clip_in_array(audio, batch_size=3, batch_mode="vmap")
        scanned = _torch_det().find_clip_in_array(audio, batch_size=3, batch_mode="scan")
        assert scanned == vmapped == want


def test_offline_batch_int16_and_f32_identical(env):
    """tests/test_int16_passthrough.py::test_offline_batch_identical and
    tests/test_packing.py::test_batched_packed_equals_unpacked: an int16
    array (uploaded as int16, decoded on the device) and its f32 decode
    give the same detections in both modes."""
    audios, _, serial = env
    i16 = audios[0]
    f32 = i16.astype(np.float32) / np.float32(32768.0)
    runs = [
        _torch_det().find_clip_in_array(a, batch_size=2, batch_mode=mode)
        for a in (i16, f32) for mode in ("vmap", "scan")
    ]
    assert all(r == runs[0] for r in runs) and runs[0] == serial[0]


def test_padded_rows_come_back_empty_and_unflagged():
    """The last batch of ``find_clip_in_array`` is padded with zero chunks:
    they run (the batch keeps its shape) and select and flag nothing."""
    bank = _torch_det()._ensure_bank()
    real = _audio(9, CHUNK_S, normal=(4.0,)).astype(np.float32)
    padded = [real, np.zeros(CHUNK, np.float32), np.zeros(CHUNK, np.float32)]
    dispatched = bank.dispatch_chunks_batch(padded, None, mode="vmap")
    for sw, handle, *_ in dispatched:
        groups = bank.classes[sw]["groups"]
        for g, packed in zip(groups, _split_fused(handle.numpy()[1:], groups)):
            _, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
            assert not (sel.any() or host_fb.any() or needs_full.any())
    results = bank.collect_chunks_batch(dispatched)
    assert results[1] == results[2] == {"c": [], "m": []} and len(results[0]["c"]) == 1


def _cli_stdout(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def test_cli_vmap_modes_print_the_scan_modes_stdout():
    """tests/test_cli_multifile.py runs the JAX CLI with
    ``offline_batch_mode="vmap"``: two files, one bank, the golden
    timestamps per block. The port's stdout in vmap mode is byte-identical
    to its scan mode's, for ``--offline-batch`` and ``--stream-batch``."""
    base = ["match", "--device", "cpu", "--pattern-file", RTHK_TOML, "--pattern-file", CBS_CLIP]
    offline = {
        mode: _cli_stdout([*base, "--offline-batch", "2", "--offline-batch-mode", mode, RTHK, CBS])
        for mode in ("vmap", "scan")
    }
    assert offline["vmap"] == offline["scan"]
    events = [json.loads(x) for x in offline["vmap"].splitlines()]
    blocks = [[e.get("timestamp_ms", e.get("total_time_ms")) for e in events[i:j]]
              for i, j in ((1, 4), (5, 7))]
    assert [e["type"] for e in events] == [
        "start", "pattern_detected", "pattern_detected", "end", "start", "pattern_detected", "end"]
    assert blocks == [[1408, 2420, 4078], [25899, 32122]]
    stream = {
        mode: _cli_stdout([*base[:5], "--chunk-seconds", "2", "--stream-batch", "4",
                           "--stream-batch-mode", mode, RTHK])
        for mode in ("vmap", "scan")
    }
    assert stream["vmap"] == stream["scan"]
    got = [json.loads(x) for x in stream["vmap"].splitlines()]
    assert [e["timestamp_ms"] for e in got if e["type"] == "pattern_detected"] == [1408, 2420]


def test_engine_options_carry_vmap_to_the_bank(monkeypatch):
    """``TorchEngineOptions`` with both modes set to vmap reaches the
    bank's batched step through ``match_pattern``."""
    from audio_pattern_detector_tpu_torch.match import match_pattern

    seen = []
    dispatch = PatternBank.dispatch_chunks_batch

    def spy(self, chunks, previous_tail, mode="vmap", **kw):
        seen.append((mode, len(chunks)))
        return dispatch(self, chunks, previous_tail, mode, **kw)

    monkeypatch.setattr(tbank_module.PatternBank, "dispatch_chunks_batch", spy)
    common = dict(seconds_per_chunk=2, device="cpu")
    # 2 s chunks: the 1408 ms beep is found again in the next section's 1 s
    # lookback, as in the serial engine.
    want = match_pattern(RTHK, [RTHK_TOML], **common)
    assert [round(t * 1000) for t in want[0]["rthk_beep"]] == [1408, 1408, 2420] and not seen
    got = match_pattern(RTHK, [RTHK_TOML], offline_batch=2, offline_batch_mode="vmap", **common)
    assert got == want and seen == [("vmap", 2), ("vmap", 2)]
    seen.clear()
    got = match_pattern(RTHK, [RTHK_TOML], stream_batch=3, stream_batch_mode="vmap", **common)
    assert got == want and seen == [("vmap", 3)]
