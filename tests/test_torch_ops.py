"""The port's device ops against the JAX package's, on the same inputs.

Inputs come from numpy seeds and go to both packages as numpy arrays.
Tolerances, by op:

* constants, slicing, int16 decode, the peak masks and the greedy: no
  FFT and no float sum, so bitwise equality (ints and masks exactly,
  f32 compared as bit patterns);
* correlation and loudness: ``torch.fft`` against XLA-CPU's FFT, and
  sums in another order. Normalised correlation agrees within atol 1e-5
  (values are in [0, 1]); LUFS within 1e-3 LU;
* verifiers on identical (corr, pos, alive): accept bits identical,
  similarity and Pearson r within 1e-5 (f32 means over about 16k terms).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu import native
from audio_pattern_detector_tpu.ops import correlate as jcorr
from audio_pattern_detector_tpu.ops import loudness as jloud
from audio_pattern_detector_tpu.ops import packing as jpack
from audio_pattern_detector_tpu.ops import peaks as jpeaks
from audio_pattern_detector_tpu.ops import slicing as jslice
from audio_pattern_detector_tpu.ops import verify as jverify
from audio_pattern_detector_tpu.ops import hostref
from audio_pattern_detector_tpu_torch.ops import correlate as tcorr
from audio_pattern_detector_tpu_torch.ops import loudness as tloud
from audio_pattern_detector_tpu_torch.ops import packing as tpack
from audio_pattern_detector_tpu_torch.ops import peaks as tpeaks
from audio_pattern_detector_tpu_torch.ops import slicing as tslice
from audio_pattern_detector_tpu_torch.ops import verify as tverify
from audio_pattern_detector_tpu_torch.ops.consts import consts_from_numpy

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")
CORR_ATOL = 1e-5
LUFS_ATOL = 1e-3
VERIFY_ATOL = 1e-5


def _fields(c):
    """A JAX consts dataclass as {field: np.asarray(leaf) or static}."""
    out = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out[f.name] = v if f.metadata.get("static") else np.asarray(v)
    return out


def _carry(c):
    return consts_from_numpy(type(c).__name__, _fields(c), CPU)


def _assert_consts_equal(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            if x.is_complex():
                x, y = torch.view_as_real(x), torch.view_as_real(y)
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def _t(a):
    return torch.from_numpy(np.array(a))


def _clips(g, m, seed):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((g, m))).astype(np.float32)


def _self_corr(clips):
    cc = np.stack([np.abs(hostref.fft_correlate_1d(c, c, mode="full")) for c in clips])
    smax = cc.max(axis=1)
    return (cc / smax[:, None]).astype(np.float32), smax


# ── Constants carried across ──


@pytest.mark.parametrize(
    "section_len,clip_lens",
    [(3 * SR, [SR]), (10 * SR, [SR, 2000]), (6 * SR, [4800, 2000])],
)
def test_correlation_consts_carried_equal_port_builder(section_len, clip_lens):
    geom = jcorr.class_overlap_save_geometry(section_len, clip_lens)
    assert geom == tcorr.class_overlap_save_geometry(section_len, clip_lens)
    for i, m in enumerate(clip_lens):
        clips = _clips(2, m, i)
        smax = np.array([12.5, 7.25])
        jax_c = jcorr.build_correlation_bank(clips, smax, section_len, shared_geometry=geom)
        port = tcorr.build_correlation_bank(clips, smax, section_len, CPU, shared_geometry=geom)
        _assert_consts_equal(_carry(jax_c), port)


@pytest.mark.parametrize("section_len", [3000, 3 * SR, 61 * SR])
def test_loudness_consts_carried_equal_port_builder(section_len):
    jax_c = jloud.build_loudness_consts(section_len, SR)
    _assert_consts_equal(_carry(jax_c), tloud.build_loudness_consts(section_len, SR, CPU))


@pytest.mark.parametrize("m", [SR, 2000])  # normal and short clips
def test_normal_verify_consts_carried_equal_port_builder(m):
    cc, _ = _self_corr(_clips(3, m, 5))
    jax_c = jverify.build_normal_verify_consts(cc, m, SR)
    _assert_consts_equal(_carry(jax_c), tverify.build_normal_verify_consts(cc, m, SR, CPU))


def test_marker_verify_consts_carried_equal_port_builder():
    dom = np.array([941.0, 1040.0])
    params = [{}, {"minimum_band_purity": 0.9, "minimum_longest_active_run": 7}]
    jax_c = jverify.build_marker_verify_consts(2000, SR, dom, params)
    port = tverify.build_marker_verify_consts(2000, SR, dom, params, CPU)
    _assert_consts_equal(_carry(jax_c), port)


# ── Slicing and upload ──


def test_window_slicing_bitwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 700)).astype(np.float32)
    starts = rng.integers(0, 700 - 40, (3, 5)).astype(np.int32)
    want = np.asarray(jslice.slice_rows_windows(jnp.asarray(x), jnp.asarray(starts), 40))
    np.testing.assert_array_equal(tslice.slice_rows_windows(_t(x), _t(starts), 40).numpy(), want)


def test_int16_decode_bitwise():
    pcm = np.array([-32768, -32767, -1, 0, 1, 12345, 32767, -4096], dtype=np.int16)
    pcm = np.concatenate([pcm, np.random.default_rng(1).integers(-32768, 32768, 998, dtype=np.int16)])
    got = tpack.as_f32(tpack.upload_rows(pcm[None], CPU))[0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), native.pcm16_to_f32_mono(pcm).view(np.int32))
    jax_dev = np.asarray(jpack.unpack_pcm16(jnp.asarray(pcm.view(np.float32))))
    np.testing.assert_array_equal(got.view(np.int32), jax_dev.view(np.int32))
    f32 = tpack.upload_rows(got[None], CPU)
    assert tpack.as_f32(f32) is f32
    with pytest.raises(TypeError):
        tpack.upload_rows(pcm.astype(np.int32)[None], CPU)


# ── Peak masks and the greedy (bitwise) ──


def _tied_rows(g, l, seed):
    """Rows on a coarse value grid: plenty of equal runs of every length."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 6, (g, l)) / 5.0).astype(np.float32)
    x[:, -rng.integers(1, 9):] = -np.inf  # -inf tail as past valid_len
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peak_masks_bitwise(seed):
    x = _tied_rows(3, 997, seed)
    xj, xt = jnp.asarray(x), _t(x)
    np.testing.assert_array_equal(
        tpeaks.short_run_local_maxima_mask(xt).numpy(),
        np.asarray(jpeaks.short_run_local_maxima_mask(xj)),
    )
    for h in (0.39, 0.6):
        np.testing.assert_array_equal(
            tpeaks.long_plateau_present(xt, h).numpy(),
            np.asarray(jpeaks.long_plateau_present(xj, h)),
        )
    per_row = np.array([[0.3], [0.7], [0.9]], np.float32)
    np.testing.assert_array_equal(
        tpeaks.long_plateau_present(xt, _t(per_row)).numpy(),
        np.asarray(jpeaks.long_plateau_present(xj, jnp.asarray(per_row))),
    )
    shifts = [jpeaks._shift(xj, d) for d in (-2, -1, 1, 2)]
    left = jnp.arange(x.shape[1])[None, :] > 1
    want = jpeaks.plateau_run_mask(xj, *shifts, jnp.isfinite(shifts[2]), jnp.isfinite(shifts[3]), left)
    tshifts = [tpeaks._shift(xt, d) for d in (-2, -1, 1, 2)]
    got = tpeaks.plateau_run_mask(
        xt, *tshifts, torch.isfinite(tshifts[2]), torch.isfinite(tshifts[3]),
        torch.arange(x.shape[1])[None, :] > 1,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for d in (-2, -1, 1, 2, 3):
        np.testing.assert_array_equal(tpeaks._shift(xt, d).numpy(), np.asarray(jpeaks._shift(xj, d)))


def _scored(g, l, seed, density):
    """Candidate rows (heights on a coarse grid for exact ties, else -inf)."""
    rng = np.random.default_rng(seed)
    heights = (rng.integers(1, 8, (g, l)) / 7.0).astype(np.float32)
    return np.where(rng.random((g, l)) < density, heights, -np.inf).astype(np.float32)


@pytest.mark.parametrize(
    "seed,l,m,density,r_max",
    [(0, 5000, 300, 0.01, 16), (1, 4100, 50, 0.05, 16), (2, 3000, 1200, 0.002, 4), (3, 700, 100, 0.0, 8)],
)
@pytest.mark.parametrize("unroll", [True, False])
def test_greedy_survivors_bitwise(seed, l, m, density, r_max, unroll):
    block = 512
    scored = _scored(3, l, seed, density)
    want = jpeaks.greedy_survivors_blockwise(jnp.asarray(scored), m, r_max, block, unroll=unroll)

    nb = -(-l // block)
    padded = np.pad(scored, ((0, 0), (0, nb * block - l)), constant_values=-np.inf)
    pt = _t(padded)
    bwork0 = pt.reshape(3, nb, block).amax(dim=2)
    offs = torch.arange(block)[None, :]

    def gather(b_idx):
        idx = b_idx[:, None] * block + offs
        return torch.gather(pt, 1, idx), idx

    got = tpeaks.greedy_survivors_from_blocks(bwork0, gather, m, r_max, block)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32), np.asarray(want[1]).view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ── Correlation and loudness (FFT tolerance) ──


def _section(n, seed, hits=()):
    rng = np.random.default_rng(seed)
    s = (0.05 * rng.standard_normal(n)).astype(np.float32)
    for off, clip in hits:
        s[off : off + len(clip)] += clip
    return s


@pytest.mark.parametrize(
    "chunk_s,n_valid_off", [(2, 0), (4, 3333), (9, 0)]  # single FFT, overlap-save
)
def test_bank_correlate_within_tolerance(chunk_s, n_valid_off):
    s_len = (1 + chunk_s) * SR
    clips = [_clips(2, SR, 7), _clips(3, 2000, 8)]
    geom = jcorr.class_overlap_save_geometry(s_len, [SR, 2000])
    section = _section(s_len, 3, hits=[(SR + 500, clips[0][1] * 0.8)])
    n_valid = s_len - n_valid_off
    section[n_valid:] = 0.0
    seg = None
    for clip in clips:
        cc, smax = _self_corr(clip)
        jc = jcorr.build_correlation_bank(clip, smax, s_len, shared_geometry=geom)
        tc = _carry(jc)
        if geom is not None and seg is None:
            seg = tcorr.section_segment_spectra(_t(section), tc)
            jseg = jcorr.section_segment_spectra(jnp.asarray(section), jc)
            np.testing.assert_allclose(seg.numpy(), np.asarray(jseg), atol=1e-3, rtol=1e-5)
        want, wl = jcorr.bank_correlate(jnp.asarray(section), jnp.int32(n_valid), jc)
        got, vl = tcorr.bank_correlate(_t(section), n_valid, tc, seg)
        assert vl == int(wl) == n_valid + clip.shape[1] - 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CORR_ATOL)
        assert np.all(got.numpy()[:, vl:] == 0.0)
        raw, _ = tcorr.bank_correlate_abs(_t(section), n_valid, tc, seg)
        jraw, _ = jcorr.bank_correlate_abs(jnp.asarray(section), jnp.int32(n_valid), jc)
        scale = float(np.asarray(jraw).max())
        np.testing.assert_allclose(raw.numpy() / scale, np.asarray(jraw) / scale, rtol=0, atol=CORR_ATOL)


@pytest.mark.parametrize(
    "n,s_len,amp",
    [(3000, 3 * SR, 0.1), (2 * SR, 3 * SR, 0.2), (3 * SR, 3 * SR, 0.05), (20 * SR, 21 * SR, 0.3),
     (5 * SR, 6 * SR, 0.0)],  # short path, gated (single FFT / overlap-save), silence
)
def test_loudness_within_tolerance(n, s_len, amp):
    rng = np.random.default_rng(n)
    section = np.zeros(s_len, np.float32)
    t = np.arange(n) / SR
    section[:n] = amp * (np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
                         + 0.3 * rng.standard_normal(n)).astype(np.float32)
    jc = jloud.build_loudness_consts(s_len, SR)
    tc = tloud.build_loudness_consts(s_len, SR, CPU)
    want = float(jloud.integrated_loudness_device(jnp.asarray(section), jnp.int32(n), jc))
    got = float(tloud.integrated_loudness_device(_t(section), n, tc))
    if amp == 0.0:
        assert got == want == -np.inf
    else:
        assert abs(got - want) <= LUFS_ATOL
        host = hostref.integrated_loudness(section[:n], SR, block_size=n / SR if n < SR // 2 else 0.4)
        assert abs(got - host) <= LUFS_ATOL
    jn = np.asarray(jloud.loudness_normalize_device(jnp.asarray(section), jnp.float32(want)))
    tn = tloud.loudness_normalize_device(_t(section), torch.tensor(want, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(tn, jn)


# ── Verifiers on identical inputs ──


def _hit_corr(m, seed):
    """A normalised correlation with one true hit, from the JAX ops."""
    clips = _clips(2, m, seed)
    cc, smax = _self_corr(clips)
    s_len = 5 * SR
    off = 2 * SR + 123
    section = _section(s_len, seed, hits=[(off, clips[0])])
    jc = jcorr.build_correlation_bank(clips, smax, s_len, shared_geometry=None)
    corr, _ = jcorr.bank_correlate(jnp.asarray(section), jnp.int32(s_len), jc)
    return np.asarray(corr), cc, off + m - 1


@pytest.mark.parametrize("m", [SR, 2000])  # normal and short-clip verifiers
def test_verify_normal_agrees(m):
    corr, cc, hit = _hit_corr(m, 11)
    rng = np.random.default_rng(m)
    pos = np.sort(rng.integers(0, corr.shape[1], (2, 16)), axis=1).astype(np.int32)
    pos[:, 3] = hit + np.array([0, 1])  # the true hit (row 0), one sample off (row 1)
    pos[:, 4] = [0, corr.shape[1] - 1]  # the edges
    alive = rng.random((2, 16)) < 0.8
    alive[:, 3] = True
    jc = jverify.build_normal_verify_consts(cc, m, SR)
    ja, js, jr = (np.asarray(a) for a in jverify.verify_normal(
        jnp.asarray(corr), jnp.asarray(pos), jnp.asarray(alive), jc))
    ta, ts, tr = (a.numpy() for a in tverify.verify_normal(
        _t(corr), _t(pos).long(), _t(alive), _carry(jc)))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, rtol=0, atol=VERIFY_ATOL)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=VERIFY_ATOL)
    assert ta[0, 3]


def test_verify_marker_agrees():
    m, freq = 2000, 941.0
    t = np.arange(m) / SR
    tone = np.sin(2 * np.pi * freq * t).astype(np.float32)
    section = _section(4 * SR, 2, hits=[(SR + 77, 0.8 * tone)])
    hit = SR + 77 + m - 1
    rng = np.random.default_rng(9)
    pos = rng.integers(0, 4 * SR + m - 1, (2, 12)).astype(np.int32)
    pos[0, :3] = [hit, hit - 40, hit + 3]
    pos[1, 0] = hit
    alive = np.ones((2, 12), bool)
    alive[1, 5] = False
    jc = jverify.build_marker_verify_consts(m, SR, np.array([freq, 1040.0]), [{}, {}])
    want = np.asarray(jverify.verify_marker(jnp.asarray(section), jnp.asarray(pos), jnp.asarray(alive), jc))
    got = tverify.verify_marker(_t(section), _t(pos).long(), _t(alive), _carry(jc)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] and not got[1, 0]  # the tone passes only its own clip's row
