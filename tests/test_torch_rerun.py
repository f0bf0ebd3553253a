"""The port's full tier: wide rerun and general-plateau payloads against
the JAX package's, lean against wide inside the port, and the routing of
flagged rows.

Payloads hold only integer-valued fields (positions, selected bits,
flags), and on this audio every decision that sets them sits far from a
threshold, so they are compared exactly, as in tests/test_torch_engine.py.
Inside the port, lean and wide payloads of an unflagged row are equal bit
for bit by construction (both compare the same f32 quotients). Routing
results are held to ``hostpath.process_section_host`` exactly, with the
bank's counters naming the route each row took.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu import native
from audio_pattern_detector_tpu.models import hostpath
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.models.bank import (
    class_step,
    lean_group_packed,
    unpack_group,
    wide_group_packed,
)
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan_reference
from audio_pattern_detector_tpu_torch.ops.consts import consts_from_numpy
from audio_pattern_detector_tpu_torch.ops.verify import build_normal_verify_consts
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")


def _carry(c):
    fields = {
        f.name: getattr(c, f.name) if f.metadata.get("static") else np.asarray(getattr(c, f.name))
        for f in dataclasses.fields(c)
    }
    return consts_from_numpy(type(c).__name__, fields, CPU)


def _hit_audio():
    """A 0.6 s normal clip and a 941 Hz marker tone; 36 s of int16 audio
    with normal hits at 4 s and 31 s, a marker hit at 10 s, and a burst of
    18 normal copies from 15 s, one every 0.62 s, that floods the normal
    row past the lean tier's 16 survivor lanes."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tm = np.arange(int(0.25 * SR)) / SR
    marker = np.sin(2 * np.pi * 941.0 * tm).astype(np.float32)
    clips = [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(
            name="m", audio=marker, sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY, strategy_params={"dominant_frequency_hz": 941.0},
        ),
    ]
    rng = np.random.default_rng(23)
    audio = 0.01 * rng.standard_normal(36 * SR)
    for o in (4 * SR, 31 * SR, *(int((15.0 + 0.62 * k) * SR) for k in range(18))):
        audio[o : o + len(clip)] += clip
    audio[10 * SR : 10 * SR + len(marker)] += 0.8 * marker
    return clips, np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def hit_env():
    """JAX and port banks over the same clips (15 s sections) and the
    f32 sections of the hit audio's chunks."""
    clips, audio = _hit_audio()
    chunk_s = 14
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in clips]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=chunk_s)._ensure_bank()
    tbank = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=chunk_s)._ensure_bank()
    (sw, jcls), = jbank.classes.items()
    chunks = [audio[o : o + chunk_s * SR] for o in range(0, len(audio), chunk_s * SR)]
    sections = []
    for i, chunk in enumerate(chunks):
        raw = jbank._raw_section(sw, chunk, chunks[i - 1] if i else None)
        section = np.zeros(jcls["section_len"], np.float32)
        section[: len(raw)] = native.pcm16_to_f32_mono(raw)
        sections.append((section, len(raw)))
    consts = (
        _carry(jcls["loud"]),
        tuple((_carry(g.corr), _carry(g.verify)) for g in jcls["groups"]),
    )
    return jbank, tbank, sw, jcls, sections, consts


def _jax_payloads(jbank, sw, jcls, section, n_valid, metas, height_min, wide):
    from audio_pattern_detector_tpu.models.bank import _class_step_jit

    outs = _class_step_jit(
        jnp.asarray(section), jnp.float32(n_valid), jcls["loud"],
        tuple((g.corr, g.verify) for g in jcls["groups"]),
        metas=metas, height_min=height_min, lean=True, wide=wide,
    )
    return [np.asarray(o["packed"]) for o in outs]


# ── The wide and general-plateau tiers against JAX ──


@pytest.mark.parametrize("capped", [True, False], ids=["capped_1024", "full_k_detect"])
def test_wide_payload_identical_to_jax(hit_env, capped):
    jbank, tbank, sw, jcls, sections, (loud, group_consts) = hit_env
    metas = tbank._wide_metas(sw, capped)
    assert metas == jbank._wide_metas(sw, capped)
    selected = 0
    for i, (section, n_valid) in enumerate(sections):
        want = _jax_payloads(jbank, sw, jcls, section, n_valid, metas, jbank.height_min, True)
        got = class_step(
            torch.from_numpy(section), n_valid, loud, group_consts,
            metas=metas, height_min=tbank.height_min, wide=True,
        )
        for g, w, t in zip(jcls["groups"], want, got):
            np.testing.assert_array_equal(t.numpy(), w, err_msg=f"chunk {i} group {g.kind}")
            k = g.k_verify
            selected += int((w[:, k : 2 * k] != 0).sum())
    assert selected >= 3


def test_height_min_zero_payload_identical_to_jax_rich_tier(hit_env):
    jbank, tbank, sw, jcls, sections, (loud, group_consts) = hit_env
    for i, (section, n_valid) in enumerate(sections[:2]):
        want = _jax_payloads(jbank, sw, jcls, section, n_valid, jbank._metas[sw], 0.0, False)
        got = class_step(
            torch.from_numpy(section), n_valid, loud, group_consts,
            metas=tbank._metas[sw], height_min=0.0,
        )
        for g, w, t in zip(jcls["groups"], want, got):
            np.testing.assert_array_equal(t.numpy(), w, err_msg=f"chunk {i} group {g.kind}")


def test_port_lean_equals_wide_on_unflagged_rows(hit_env):
    """Rows neither tier flags carry the same payload. (The wide tier
    host-flags a row whose raw candidates outnumber its lanes, as a
    640 Hz clip's comb does here; the lean tier's survivor greedy has no
    such limit.)"""
    _, tbank, sw, _, sections, (loud, group_consts) = hit_env
    unflagged = flagged = 0
    for section, n_valid in sections:
        kw = dict(metas=tbank._metas[sw], height_min=tbank.height_min)
        lean = class_step(torch.from_numpy(section), n_valid, loud, group_consts, **kw)
        wide = class_step(torch.from_numpy(section), n_valid, loud, group_consts, wide=True, **kw)
        for g, a, b in zip(tbank.classes[sw]["groups"], lean, wide):
            flag = 2 * g.k_verify
            rows = (a[:, flag] == 0) & (b[:, flag] == 0)
            unflagged += int(rows.sum())
            flagged += int((a[:, flag] == 2).sum())
            assert torch.equal(a[rows], b[rows])
    assert unflagged >= 3 and flagged >= 1


class TestLeanEqualsWideByConstruction:
    """Port of tests/test_two_tier_detect.py's row-shape cases: rows that
    used to need ulp guards, hit-shaped combs and a tie at the 16-lane
    capture boundary leave the lean tier unflagged, with the wide tier's
    payload bit for bit."""

    M = 257

    @pytest.fixture(scope="class")
    def run(self):
        m = self.M
        rng = np.random.default_rng(7)
        cc = np.abs(rng.standard_normal((1, 2 * m - 1))).astype(np.float32)
        cc /= cc.max()
        consts = build_normal_verify_consts(cc, m, SR, CPU)
        norm = torch.zeros(8)
        one = torch.ones(1)

        def run(x, valid_len):
            corr = torch.from_numpy(x[None, :].astype(np.float32))
            lean = lean_group_packed(
                norm, corr, valid_len, "normal", m, 64, 16, 0.25, consts, one,
                candidate_scan_reference,
            )
            # bank_correlate's output for this row: zeros past valid_len,
            # divided by max(self_corr_max = 1, observed max <= 1) = 1.
            corr_n = torch.where(torch.arange(corr.shape[1]) < valid_len, corr, 0.0)
            wide = wide_group_packed(norm, corr_n, valid_len, "normal", m, 64, 16, 0.25, consts)
            return lean[0].numpy(), wide[0].numpy()

        return run

    @staticmethod
    def _row(length, peaks):
        x = np.full(length, 1e-4, dtype=np.float32)
        for pos, h in peaks:
            x[pos - 1], x[pos], x[pos + 1] = h * 0.6, h, h * 0.6
        return x

    @staticmethod
    def _comb(center, n_teeth, top=0.9, step=0.02, spacing=12):
        peaks = [(center, top)]
        for k in range(1, n_teeth):
            side = 1 if k % 2 else -1
            peaks.append((center + side * spacing * ((k + 1) // 2), top - step * k))
        return peaks

    @pytest.mark.parametrize(
        "name",
        ["clear_margin", "threshold", "near_ulp", "tail_reading", "near_tail", "comb", "tie"],
    )
    def test_row_shapes(self, run, name):
        length, vl, m = 6000, 5900, self.M
        h = float(np.float32(0.25) + np.float32(0.25) * np.float32(1.19e-7))
        tie = self._comb(1500, 16)[:16] + [(1600, float(np.float32(0.9 - 0.02 * 15)))]
        peaks = {
            "clear_margin": [(1000, 0.9)],
            "threshold": [(1000, 0.25)],
            "near_ulp": [(1000, h)],
            "tail_reading": [(vl - m + 3, 0.9)],
            "near_tail": [(vl - m, 0.9)],
            "comb": self._comb(1500, 25),
            "tie": tie,
        }[name]
        x = self._row(length, peaks)
        x[vl:] = 0.0
        lean, wide = run(x, vl)
        assert lean[32] == 0.0 and wide[32] == 0.0
        np.testing.assert_array_equal(lean, wide)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_combs(self, run, seed):
        rng = np.random.default_rng(100 + seed)
        length = 24000
        x = np.full(length, 1e-4, dtype=np.float32)
        for c in rng.integers(400, length - 400, size=rng.integers(1, 4)):
            n = int(rng.integers(18, 30))
            top = float(rng.uniform(0.5, 1.0))
            sp = int(rng.integers(6, 18))
            for k in range(n):
                side = 1 if k % 2 else -1
                p = int(c) + side * sp * ((k + 1) // 2)
                hk = top * float(rng.uniform(0.35, 0.99)) if k else top
                x[p - 1], x[p], x[p + 1] = hk * 0.6, hk, hk * 0.6
        lean, wide = run(x, length - 100)
        if lean[32] == 0.0:
            np.testing.assert_array_equal(lean, wide)
        else:
            assert wide[32] in (0.0, 1.0)

    def test_survivor_overflow_flags_for_the_rerun(self, run):
        peaks = [(300 + 600 * k, 0.9 - 0.01 * k) for k in range(20)]
        lean, wide = run(self._row(20000, peaks), 19900)
        assert lean[32] == 2.0 and wide[32] == 0.0
        assert int(wide[16:32].sum()) == 0  # the verify rejects noise slices
        np.testing.assert_array_equal(np.sort(wide[:16]), wide[:16])


# ── Routing of flagged rows ──


def _host_expected(bank, g, ci, section):
    return hostpath.process_section_host(
        audio_section=section,
        clip=g.clips_np[ci],
        correlation_clip=g.corr_clips_np[ci],
        correlation_clip_absolute_max=float(g.self_max_np[ci]),
        sr=SR,
        height_min=bank.height_min,
        is_short_clip=g.clip_len / SR < 0.5,
        tone_frequency=g.tone_freqs[ci],
        verification_params=g.verification_params[ci],
    )


def _routes(bank):
    return bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows


def _chunk_with_copies(clip_audio, n_copies, seconds, seed):
    rng = np.random.default_rng(seed)
    audio = (0.004 * rng.standard_normal(seconds * SR)).astype(np.float32)
    for k in range(n_copies):
        o = int((0.3 + 1.05 * k) * SR)
        audio[o : o + SR] += clip_audio[: min(SR, len(audio) - o)]
    return audio


def _noise_clip_bank():
    rng = np.random.default_rng(3)
    clip = AudioClip(name="c", audio=(0.4 * rng.standard_normal(SR)).astype(np.float32), sample_rate=SR)
    bank = TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=20)._ensure_bank()
    return bank, bank.classes[1]["groups"][0]


def _marker_bank():
    t = np.arange(int(0.25 * SR)) / SR
    tone = (0.8 * np.sin(2 * np.pi * 1040.0 * t)).astype(np.float32)
    clip = AudioClip(name="m", audio=tone, sample_rate=SR, strategy="marker_tone")
    bank = TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=20)._ensure_bank()
    return bank, bank.classes[1]["groups"][0], tone


def _marker_hits(tone, weak, amp, seed=5):
    """20 s: one hit at 1 s and ``weak`` hits at ``amp`` every 0.6 s from 2 s."""
    rng = np.random.default_rng(seed)
    audio = (0.002 * rng.standard_normal(20 * SR)).astype(np.float32)
    audio[SR : SR + len(tone)] += tone
    for k in range(weak):
        o = int((2.0 + 0.6 * k) * SR)
        audio[o : o + len(tone)] += amp * tone
    return audio


def test_single_dense_row_takes_a_row_rerun():
    bank, g = _noise_clip_bank()
    audio = _chunk_with_copies(g.clips_np[0], 18, 20, seed=21)
    got = bank.process_chunk(audio, None)["c"]
    assert got == _host_expected(bank, g, 0, audio) and len(got) == 18
    assert _routes(bank) == (1, 0, 0, 0)


def test_many_flagged_rows_take_one_class_rerun():
    rng = np.random.default_rng(31)
    base = (0.4 * rng.standard_normal(SR)).astype(np.float32)
    clips = [AudioClip(name=f"c{i}", audio=base * (0.8 + 0.04 * i), sample_rate=SR) for i in range(6)]
    bank = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=24)._ensure_bank()
    g = bank.classes[1]["groups"][0]
    audio = _chunk_with_copies(base, 20, 24, seed=32)
    got = bank.process_chunk(audio, None)
    for ci, name in enumerate(g.names):
        assert got[name] == _host_expected(bank, g, ci, audio)
    assert _routes(bank) == (0, 1, 0, 0)


def test_marker_comb_hit_clears_without_a_rerun():
    bank, g, tone = _marker_bank()
    audio = _marker_hits(tone, weak=0, amp=0.0)
    assert bank.process_chunk(audio, None)["m"] == _host_expected(bank, g, 0, audio)
    assert _routes(bank) == (0, 0, 0, 0)


@pytest.mark.parametrize(
    "amp,routes",
    [
        (0.25, (1, 0, 0, 0)),  # the capped rerun holds every candidate
        (0.3, (2, 0, 1, 0)),  # past 1024 candidates: escalated, resolved on the device
        (0.35, (2, 0, 1, 1)),  # past k_detect too: escalated, then the host path
    ],
)
def test_dense_marker_row_escalates_past_the_lane_cap(amp, routes):
    bank, g, tone = _marker_bank()
    assert g.k_detect > bank._WIDE_RERUN_CAP
    audio = _marker_hits(tone, weak=18, amp=amp)
    got = bank.process_chunk(audio, None)["m"]
    assert got == _host_expected(bank, g, 0, audio) and len(got) == 19
    assert _routes(bank) == routes


def test_batched_collect_resolves_flagged_rows_like_single_chunks():
    bank, g = _noise_clip_bank()
    sparse = _chunk_with_copies(g.clips_np[0], 2, 20, seed=13)
    dense = _chunk_with_copies(g.clips_np[0], 18, 20, seed=14)
    single = [bank.process_chunk(c, p) for c, p in ((sparse, None), (dense, sparse), (sparse, dense))]
    batched = bank.collect_chunks_batch(bank.dispatch_chunks_batch([sparse, dense, sparse], None))
    assert batched == single
    assert bank.row_reruns == 2 and bank.host_path_rows == 0


def test_row_rerun_uses_the_class_geometry():
    bank, g = _noise_clip_bank()
    row_corr, _ = bank._row_consts_for(1, 0, 0)
    for f in ("fft_len", "step", "pad_left", "num_segments", "out_offset", "full_len"):
        assert getattr(row_corr, f) == getattr(g.corr, f), f
    audio = _chunk_with_copies(g.clips_np[0], 18, 20, seed=21)
    row = bank._full_tier_row(1, 0, 0, audio)
    (cls_payload,) = bank._full_tier_packed(1, audio)
    np.testing.assert_array_equal(row, cls_payload[0])
    _, sel, host, _ = unpack_group(cls_payload, g.k_verify)
    assert not host.any() and int(sel.sum()) == 18
