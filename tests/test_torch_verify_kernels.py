"""The two verifiers' wrappers on the CPU: the normal verifier
(``ops/verify_normal.py``) and the marker verifier (``ops/verify_marker.py``).

On a CUDA card each wrapper launches its kernel (``csrc/verify_normal.cu``;
``csrc/verify_marker.cu``, one fused kernel that makes live lanes' spectra
itself); on the CPU it runs its plain version, and it never falls back from
one to the other. Here, on the CPU:

* each plain version against the JAX package's function on the same numpy
  inputs (``chip_smoke.VERIFY_NORMAL_CASES`` / ``VERIFY_MARKER_CASES``):
  a normal (0.5 s) and a short (0.25 s) clip, lanes at both row ends,
  dead lanes holding garbage positions, every lane live, zero-variance
  windows, marker clips without frames, R = B x G round-major rows; the
  normal verifier without and with ``normalise`` (one length and per-row
  lengths), the marker verifier with the FFT's and the DFT-GEMM's spectra;
* a numpy transliteration of each kernel's own order of arithmetic
  (``chip_smoke.np_verify_normal``; ``np_marker_spectra`` and
  ``np_marker_decisions``, the fused marker kernel's transforms and
  decisions) against the plain version, on the named cases and on
  hypothesis inputs (its transforms alone: tests/test_torch_marker_fft.py);
* the binned-maximum identity the normal kernel rests on, on the bank's
  own ``seg_a`` / ``seg_b`` and on ``build_normal_verify_consts``' at
  other clip lengths;
* the routing: CPU tensors take the plain version and count no launch; a
  library whose launch returns a CUDA error makes a wrapper raise; what a
  kernel does not take is refused before a launch;
* a captured step's verify bodies counted from the payload: one launch
  of the group's verifier exactly where it shows a live lane of the group;
* ``chip_smoke``'s bound of the normal verifier reads the constants of the
  clips with a live lane only.

Tolerance: accept bits are equal. On live lanes the similarity agrees
within a relative 1e-5 (``SIM_RTOL``; 1e-9 absolute near 0) and r within
1e-5 absolute (``R_ATOL``): element values are bitwise, sums are taken in
another order. The kernels against their plain versions on the card:
tests/test_torch_cuda.py (``-k verify``) and ``chip_smoke.py``'s
``verify_kernels`` phase.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_pattern_detector_tpu.ops import verify as jverify
from audio_pattern_detector_tpu_torch.kernels import _build
from audio_pattern_detector_tpu_torch.models import bank as tbank_module
from audio_pattern_detector_tpu_torch.ops import verify as tverify
from audio_pattern_detector_tpu_torch.ops import verify_marker as tvm
from audio_pattern_detector_tpu_torch.ops import verify_normal as tvn
from audio_pattern_detector_tpu_torch.ops.verify import (
    build_marker_verify_consts,
    build_normal_verify_consts,
)
from chip_smoke import (
    HBM_BYTES_PER_S,
    MARKER_52S,
    MARKER_SPECTRA_RTOL,
    VERIFY_MARKER_CASES,
    VERIFY_NORMAL_CASES,
    VERIFY_PATH_LAUNCHES,
    counted_verify_launches,
    np_marker_decisions,
    np_marker_spectra,
    np_verify_normal,
    self_correlations,
    verify_marker_case,
    verify_marker_inputs,
    verify_normal_bound,
    verify_normal_case,
    verify_normal_inputs,
)
from tests.test_torch_skip_verify import SECTIONS, _bank, _live, _section, stand_in  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIM_ATOL = 1e-9  # beside SIM_RTOL, for similarities near 0


def _close(sim, r, want_sim, want_r, live):
    np.testing.assert_allclose(sim[live], want_sim[live], rtol=tvn.SIM_RTOL, atol=SIM_ATOL)
    np.testing.assert_allclose(r[live], want_r[live], rtol=0, atol=tvn.R_ATOL)


def _normalised(case) -> np.ndarray:
    """The rows as the JAX verifier takes them: zeros at and past each
    row's valid length, divided by the row's normaliser (f32)."""
    corr = case["corr"]
    if case["denom"] is None:
        return corr
    lim = np.broadcast_to(np.asarray(case["valid_len"]), (corr.shape[0],))
    inside = np.arange(corr.shape[1])[None, :] < lim[:, None]
    return (np.where(inside, corr, np.float32(0)) / case["denom"][:, None]).astype(np.float32)


# ── The normal verifier ──


@pytest.mark.parametrize("name", VERIFY_NORMAL_CASES)
def test_plain_verify_normal_equals_jax(name):
    case = verify_normal_case(name)
    corr, pos, alive, consts, normalise = verify_normal_inputs(case, CPU)
    before = tvn.verify_normal.launches
    got = [t.numpy() for t in tverify.verify_normal(corr, pos, alive, consts, normalise)]
    assert tvn.verify_normal.launches == before  # the plain version counts nothing
    jc = jverify.build_normal_verify_consts(case["cc"], case["m"], case["sr"])
    g = case["cc"].shape[0]
    rows = _normalised(case)
    live = case["alive"]
    jpos = np.where(live, case["pos"], 0).astype(np.int32)  # garbage dead positions past int32
    want = [np.concatenate(x) for x in zip(*(
        [np.asarray(a) for a in jverify.verify_normal(
            jnp.asarray(rows[b:b + g]), jnp.asarray(jpos[b:b + g]), jnp.asarray(live[b:b + g]),
            jc)]
        for b in range(0, rows.shape[0], g)))]
    np.testing.assert_array_equal(got[0], want[0])
    # An all-zero window: XLA on the CPU flushes the subnormal 1e-38 clamp
    # to zero (0 / 0, a NaN similarity); torch keeps it (the zero window's
    # similarity). Both refuse the lane, with r = 0.
    zero = live & np.isnan(want[1])
    assert not got[0][zero].any() and (got[2][zero] == 0).all() and (want[2][zero] == 0).all()
    _close(got[1], got[2], want[1], want[2], live & ~zero)
    # What each case is for: hits accepted, a plateau refused.
    assert got[0][:, 0].any() and not got[0][:, 2].any()
    if name == "row_ends":
        assert got[0][:, 3:5].all()  # hits whose windows reach past both row ends
    if name == "zero_variance":
        assert (got[2][1][live[1]] == 0).all() and got[2][0, 3] == 0


@pytest.mark.parametrize("name", VERIFY_NORMAL_CASES)
def test_normal_transliteration_equals_the_plain_version(name):
    case = verify_normal_case(name)
    corr, pos, alive, consts, normalise = verify_normal_inputs(case, CPU)
    want = [t.numpy() for t in tvn.verify_normal_reference(corr, pos, alive, consts, normalise)]
    got = np_verify_normal(case["corr"], case["pos"], case["alive"], consts, case["valid_len"],
                           case["denom"])
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1], got[2], want[1], want[2], case["alive"])
    assert np.isnan(got[1][~case["alive"]]).all()


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    m=st.integers(260, 700),
    short=st.booleans(),
    g=st.integers(1, 3),
    b=st.integers(1, 2),
    k=st.integers(1, 5),
    norm=st.sampled_from(["none", "scalar", "per_row"]),
)
def test_normal_transliteration_on_hypothesis_inputs(seed, m, short, g, b, k, norm):
    """Clips short and normal, rows a little longer or much longer than a
    window, lanes anywhere in and past the row, hits planted on some, with
    and without a normaliser."""
    rng = np.random.default_rng(seed)
    sr = 8000 if short else 500
    cc = self_correlations(rng.standard_normal((g, m)).astype(np.float32))
    r_rows = b * g
    l = int(rng.integers(m, 4 * m))
    corr = (np.abs(rng.standard_normal((r_rows, l))) * rng.choice([0.002, 0.05, 0.5])
            ).astype(np.float32)
    pos = rng.integers(-m, l + m, (r_rows, k)).astype(np.int64)
    for r in range(r_rows):
        if rng.random() < 0.6:
            p = int(rng.integers(0, l))
            lo, hi = p - (m - 1), p + m
            corr[r, max(lo, 0):min(hi, l)] = cc[r % g, max(0, -lo):(2 * m - 1) - max(0, hi - l)]
            pos[r, 0] = p
    alive = rng.random((r_rows, k)) < 0.8
    valid_len = denom = None
    if norm != "none":
        denom = rng.uniform(0.2, 3.0, r_rows).astype(np.float32)
        valid_len = (rng.integers(0, l + 1, r_rows).astype(np.int32) if norm == "per_row"
                     else int(rng.integers(0, l + 1)))
    consts = build_normal_verify_consts(cc, m, sr, CPU)
    assert consts.is_short == short
    normalise = None if denom is None else (
        torch.from_numpy(valid_len) if isinstance(valid_len, np.ndarray) else valid_len,
        torch.from_numpy(denom))
    want = [t.numpy() for t in tvn.verify_normal_reference(
        torch.from_numpy(corr), torch.from_numpy(pos), torch.from_numpy(alive), consts,
        normalise)]
    got = np_verify_normal(corr, pos, alive, consts, valid_len, denom)
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1], got[2], want[1], want[2], alive)


@pytest.mark.parametrize("m, sr", [(2000, 8000), (4000, 8000), (8000, 8000), (80_000, 8000),
                                   (4000, 16000), (11025, 44100), (260, 500)])
def test_binned_maximum_identity(m, sr):
    """The plain version's max(f[seg_a], f[seg_b]) over a 2^k sliding
    maximum equals the maximum over [seg_a, seg_b + 2^k), the bin itself:
    every bin is at least 2^k and at most 2^(k + 1) wide. Held on windows
    with ties and plateaus."""
    rng = np.random.default_rng(m + sr)
    cc = self_correlations(rng.standard_normal((1, min(m, 3000))).astype(np.float32))
    cc = np.resize(cc, (1, 2 * m - 1)).astype(np.float32)  # the bins follow the length alone
    consts = build_normal_verify_consts(cc, m, sr, CPU)
    _assert_binned_identity(consts, rng)


def _assert_binned_identity(consts, rng):
    seg_a, seg_b = consts.seg_a.numpy(), consts.seg_b.numpy()
    win = 1 << consts.k_level
    widths = seg_b + win - seg_a
    assert (widths >= win).all() and (widths <= 2 * win).all()
    n = consts.win_hi - consts.win_lo
    assert seg_a[0] >= 0 and seg_b[-1] + win <= n  # every bin inside the centre window
    for _ in range(3):
        x = rng.choice(np.float32([0.0, 0.25, 0.5, 0.5, 1.0]), n) + np.float32(
            rng.random() < 0.5) * rng.random(n).astype(np.float32)
        f = torch.nn.functional.max_pool1d(torch.from_numpy(x)[None, None], win, stride=1)[0, 0]
        plain = torch.maximum(f[consts.seg_a], f[consts.seg_b]).numpy()
        direct = np.array([x[a:b + win].max() for a, b in zip(seg_a, seg_b)], dtype=np.float32)
        np.testing.assert_array_equal(plain.view(np.int32), direct.view(np.int32))


def test_binned_maximum_identity_on_the_bank_constants():
    """The same identity on the bank's own normal groups' seg_a / seg_b."""
    bank = _bank(capture=False)
    groups = [g for cls in bank.classes.values() for g in cls["groups"] if g.kind == "normal"]
    assert groups
    rng = np.random.default_rng(5)
    for group in groups:
        _assert_binned_identity(group.verify, rng)


# ── The marker verifier ──


@pytest.mark.parametrize("spectra", ["fft", "gemm"])
@pytest.mark.parametrize("name", VERIFY_MARKER_CASES)
def test_plain_verify_marker_equals_jax(monkeypatch, name, spectra):
    monkeypatch.setenv("APD_MARKER_GEMM", "1" if spectra == "gemm" else "0")
    case = verify_marker_case(name)
    section, pos, alive, consts = verify_marker_inputs(case, CPU)
    before = tvm.verify_marker.launches
    got = tverify.verify_marker(section, pos, alive, consts).numpy()
    assert tvm.verify_marker.launches == before
    sp = tvm.marker_spectra(section, pos, consts)
    # The DFT-GEMM runs up to _GEMM_MAX_N points: the long marker's FFT either way.
    assert sp.whole_is_magnitude == (spectra == "fft" or case["m"] > tvm._GEMM_MAX_N)
    assert (sp.frames is None) == (name == "no_frames")
    jc = jverify.build_marker_verify_consts(case["m"], case["sr"], case["dom"], case["params"])
    sections = case["section"].reshape(-1, case["section"].shape[-1])
    g = len(case["dom"])
    live = case["alive"]
    jpos = np.where(live, case["pos"], 0).astype(np.int32)
    want = np.concatenate([np.asarray(jverify.verify_marker(
        jnp.asarray(sections[bi]), jnp.asarray(jpos[bi * g:(bi + 1) * g]),
        jnp.asarray(live[bi * g:(bi + 1) * g]), jc)) for bi in range(len(sections))])
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[~live].any()


@pytest.mark.parametrize("spectra", ["fft", "gemm"])
@pytest.mark.parametrize("name", VERIFY_MARKER_CASES)
def test_marker_transliteration_equals_the_plain_version(monkeypatch, name, spectra):
    """The fused kernel in numpy (its spectra, ``np_marker_spectra``, then
    its decisions) against the plain verifier with either spectra; and its
    decisions alone on the plain version's spectra. The spectra within
    1e-5 of each window's largest bin of torch's rfft."""
    monkeypatch.setenv("APD_MARKER_GEMM", "1" if spectra == "gemm" else "0")
    case = verify_marker_case(name)
    section, pos, alive, consts = verify_marker_inputs(case, CPU)
    sp = tvm.marker_spectra(section, pos, consts)
    want = tvm.marker_decisions_reference(sp, alive, consts).numpy()
    np.testing.assert_array_equal(np_marker_decisions(sp, case["alive"], consts), want)
    np.testing.assert_array_equal(tvm.verify_marker_reference(section, pos, alive, consts).numpy(),
                                  want)
    fused = np_marker_spectra(case["section"], case["pos"], consts)
    np.testing.assert_array_equal(np_marker_decisions(fused, case["alive"], consts), want)
    with monkeypatch.context() as mp:
        mp.setenv("APD_MARKER_GEMM", "0")
        plain = tvm.marker_spectra(section, pos, consts)
    for a, b in ((fused.whole, plain.whole), (fused.frames, plain.frames)):
        if b is not None:
            err = ((a - b).abs().amax(-1) / b.amax(-1).clamp_min(1e-30)).max()
            assert float(err) <= MARKER_SPECTRA_RTOL


@settings(max_examples=30, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    m=st.integers(40, 700),
    sr=st.sampled_from([2000, 8000]),
    g=st.integers(1, 3),
    b=st.integers(1, 2),
    k=st.integers(1, 4),
    magnitude=st.booleans(),
)
def test_marker_transliteration_on_hypothesis_spectra(seed, m, sr, g, b, k, magnitude):
    """Spectra made directly: noise, a peak at or near each clip's
    frequency in the match window and in most frames, flanks quiet or not,
    ties in the argmaxes, zero-energy frames; magnitudes or powers; 0 to
    26 frames."""
    rng = np.random.default_rng(seed)
    dom = rng.uniform(150, sr / 2 - 150, g)
    params = [{} if rng.random() < 0.5 else {
        "minimum_band_purity": float(rng.choice([0.5, 0.9])),
        "minimum_active_frame_ratio": float(rng.choice([0.0, 0.5])),
        "minimum_longest_active_run": int(rng.integers(0, 4)),
        "minimum_active_frame_mean_purity": float(rng.choice([0.0, 0.6]))} for _ in range(g)]
    consts = build_marker_verify_consts(m, sr, dom, params, CPU)
    fw, n_frames = m // 2 + 1, consts.frame_count
    ff = consts.frame_len // 2 + 1
    freqs_w, freqs_f = consts.freqs_whole.numpy(), consts.freqs_frame.numpy()

    def spectrum(shape, freqs, loud):
        x = (np.abs(rng.standard_normal(shape)) * 0.05).astype(np.float32)
        for idx in np.ndindex(*shape[:-1]):
            if loud[idx]:
                gi = idx[1]
                peak = int(np.argmin(np.abs(freqs - dom[gi]))) + int(rng.integers(-1, 2))
                x[idx][np.clip(peak, 0, shape[-1] - 1)] = np.float32(rng.choice([5.0, 20.0]))
            if rng.random() < 0.05:
                x[idx][:] = 0.0
        x[..., -1] = np.where(rng.random(shape[:-1]) < 0.1, x.max(axis=-1), x[..., -1])  # ties
        return x if magnitude else (x * x).astype(np.float32)

    whole = spectrum((b, g, k, 3, fw), freqs_w, rng.random((b, g, k, 3)) < [0.2, 0.9, 0.2])
    frames = None
    if n_frames:
        frames = torch.from_numpy(spectrum((b, g, k, n_frames, ff), freqs_f,
                                           rng.random((b, g, k, n_frames)) < 0.9))
    sp = tvm.MarkerSpectra(torch.from_numpy(whole), magnitude, frames, magnitude)
    alive = rng.random((b * g, k)) < 0.8
    want = tvm.marker_decisions_reference(sp, torch.from_numpy(alive), consts).numpy()
    np.testing.assert_array_equal(np_marker_decisions(sp, alive, consts), want)


# ── Routing and no fallback ──


def test_the_cpu_takes_the_plain_versions():
    case = verify_normal_case("hit_and_misses")
    args = verify_normal_inputs(case, CPU)
    before = (tvn.verify_normal.launches, tvm.verify_marker.launches)
    for got, want in zip(tvn.verify_normal(*args), tvn.verify_normal_reference(*args)):
        assert torch.equal(got.view(torch.int32) if got.is_floating_point() else got,
                           want.view(torch.int32) if want.is_floating_point() else want)
    margs = verify_marker_inputs(verify_marker_case("tone_hits"), CPU)
    assert torch.equal(tvm.verify_marker(*margs), tvm.verify_marker_reference(*margs))
    assert (tvn.verify_normal.launches, tvm.verify_marker.launches) == before
    assert tverify.verify_normal is tvn.verify_normal
    assert tverify.verify_marker is tvm.verify_marker


def _stub(monkeypatch, code: int):
    lib = types.SimpleNamespace(apd_verify_normal=lambda *a: code,
                                apd_verify_marker=lambda *a: code)
    monkeypatch.setattr(_build, "load_kernels", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(multi_processor_count=132))


def test_a_launch_that_returns_a_cuda_error_raises(monkeypatch):
    """The launch paths with a library whose entry points return a CUDA
    error (700, an illegal address): each wrapper raises, counts no launch
    and runs no plain version in its place; a launch that succeeds counts
    one."""
    _stub(monkeypatch, 700)
    monkeypatch.setattr(tvn, "verify_normal_reference", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(tvm, "verify_marker_reference", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(tvm, "marker_spectra", lambda *a: pytest.fail("fell back"))
    nargs = verify_normal_inputs(verify_normal_case("rounds"), CPU)
    margs = verify_marker_inputs(verify_marker_case("tone_hits"), CPU)
    long_args = verify_marker_inputs(verify_marker_case("long_marker"), CPU)
    before = (tvn.verify_normal.launches, tvm.verify_marker.launches)
    with pytest.raises(RuntimeError, match="verify_normal kernel launch failed: CUDA error 700"):
        tvn._launch(*nargs)
    for args in (margs, long_args):  # the shared-memory and the global-workspace forms
        with pytest.raises(RuntimeError, match="verify_marker kernel launch failed: CUDA error 700"):
            tvm._launch(*args)
    assert (tvn.verify_normal.launches, tvm.verify_marker.launches) == before
    _stub(monkeypatch, 0)
    tvn._launch(*nargs)
    tvm._launch(*margs)
    assert (tvn.verify_normal.launches, tvm.verify_marker.launches) == (
        before[0] + 1, before[1] + 1)
    tvn.verify_normal.launches, tvm.verify_marker.launches = before


def test_a_52_second_marker_clip_is_admitted(monkeypatch):
    """A 52 s marker clip at 8 kHz (4,158 frames, more than the kernel keeps
    in shared memory) reaches the library, its per-frame results in each
    CTA's workspace slot; the decisions from the kernel's transliterated
    spectra equal the plain verifier's, a near miss refused among them."""
    calls = []
    _stub(monkeypatch, 0)
    lib = types.SimpleNamespace(apd_verify_marker=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(_build, "load_kernels", lambda: types.SimpleNamespace(lib=lib))
    case = verify_marker_case(MARKER_52S)
    section, pos, alive, consts = verify_marker_inputs(case, CPU)
    assert consts.frame_count == 4158
    before = tvm.verify_marker.launches
    tvm._launch(section, pos, alive, consts)
    assert tvm.verify_marker.launches == before + 1
    tvm.verify_marker.launches = before
    (args,) = calls
    lay = tvm.marker_plan(consts.clip_len, consts.frame_len, consts.frame_count, CPU).layout
    on_chip, frames_on_chip, workspace, grid = args[18:22]
    assert (on_chip, frames_on_chip, grid) == (0, 0, int(alive.numel()))
    assert workspace is not None and lay.slot == lay.window + 2 * lay.buffer + 2 * 4158
    want = tvm.verify_marker_reference(section, pos, alive, consts).numpy()
    spectra = np_marker_spectra(case["section"], case["pos"], consts)
    np.testing.assert_array_equal(np_marker_decisions(spectra, case["alive"], consts), want)
    assert want[:, 0].all() and not want.all()


def test_what_the_kernels_do_not_take_is_refused_before_a_launch(monkeypatch):
    """Wrong types, shapes and layouts, rows that are not whole rounds,
    more bins than the normal kernel's shared memory holds, frames off the
    marker clip's grid and an unsupported device raise ValueError without
    reaching the library."""
    _stub(monkeypatch, 0)
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("reached the library"))
    corr, pos, alive, consts, normalise = verify_normal_inputs(verify_normal_case("rounds"), CPU)
    with pytest.raises(ValueError, match="corr must be"):
        tvn._launch(corr.double(), pos, alive, consts, normalise)
    with pytest.raises(ValueError, match="pos must be"):
        tvn._launch(corr, pos.int(), alive, consts, normalise)
    with pytest.raises(ValueError, match="alive must be"):
        tvn._launch(corr, pos, alive[:, :3], consts, normalise)
    with pytest.raises(ValueError, match="whole rounds"):
        tvn._launch(corr[:5], pos[:5], alive[:5], consts, None)
    with pytest.raises(ValueError, match="per-row valid_len"):
        tvn._launch(corr, pos, alive, consts, (normalise[0].long(), normalise[1]))
    with pytest.raises(ValueError, match="denom must be"):
        tvn._launch(corr, pos, alive, consts, (normalise[0], normalise[1][:2]))
    big = types.SimpleNamespace(**{**consts.__dict__, "ds_clip": torch.zeros((2, 20_000)),
                                   "seg_a": torch.zeros(20_000, dtype=torch.int64),
                                   "seg_b": torch.zeros(20_000, dtype=torch.int64)})
    with pytest.raises(ValueError, match="shared memory"):
        tvn._launch(corr, pos, alive, big, normalise)
    section, mpos, malive, mconsts = verify_marker_inputs(verify_marker_case("tone_hits"), CPU)
    with pytest.raises(ValueError, match="alive must be"):
        tvm._launch(section, mpos, malive[:, :2], mconsts)
    with pytest.raises(ValueError, match="section must be"):
        tvm._launch(section.double(), mpos, malive, mconsts)
    with pytest.raises(ValueError, match="rounds"):
        tvm._launch(section, mpos[:1], malive[:1], mconsts)
    many = types.SimpleNamespace(**{**mconsts.__dict__, "frame_count": 7000})
    with pytest.raises(ValueError, match="frames"):
        tvm._launch(section, mpos, malive, many)
    skewed = types.SimpleNamespace(**{**mconsts.__dict__, "frame_starts": (0, 100, 250)})
    with pytest.raises(ValueError, match="frames must start"):
        tvm._launch(section, mpos, malive, skewed)
    with pytest.raises(ValueError, match="unsupported device"):
        tvn.verify_normal(corr.to("meta"), pos, alive, consts)
    with pytest.raises(ValueError, match="unsupported device"):
        tvm.verify_marker(section.to("meta"), mpos, malive, mconsts)


def test_the_full_branch_in_one_block_gives_the_same_accept_bits():
    """Every lane in one call (each verifier on a card, where
    ``_verify_accept`` takes no two-tier cond) against
    ``_two_tier_accept``'s blocks of 16 (the plain versions): the same
    accept bits, each lane's verdict reading only its own window."""
    case = verify_normal_case("all_live")
    corr, pos, alive, consts, _ = verify_normal_inputs(case, CPU)
    wide_pos = pos.repeat(1, 3)  # 48 lanes: the full branch runs
    wide_alive = alive.repeat(1, 3)

    def verify_accept(p, a):
        return tvn.verify_normal(corr, p.contiguous(), a.contiguous(), consts)[0]

    blocks = tbank_module._two_tier_accept(verify_accept, wide_pos, wide_alive)
    whole = verify_accept(wide_pos, wide_alive)
    assert torch.equal(blocks, whole) and whole.any()


# ── Launch accounting of captured steps ──


@pytest.mark.parametrize("rounds", [1, 3])
def test_a_captured_step_counts_verify_bodies_where_the_payload_has_a_live_lane(
        stand_in, monkeypatch, rounds):  # noqa: F811
    """The verifiers' launches in a captured lean step: its eager first use
    verifies every group; a replay adds no verify launch of its own, and
    each group's if-node body (one launch of its verifier, recorded at the
    capture) ran where the payload shows a live lane of the group, as
    ``chip_smoke.counted_verify_launches`` counts it. (On the CPU the
    wrappers count nothing, so counting stand-ins take their place.)"""
    def counting(wrapper, plain):
        def run(*a, **kw):
            wrapper.launches += 1
            return plain(*a, **kw)
        return run

    monkeypatch.setattr(tbank_module, "verify_normal",
                        counting(tvn.verify_normal, tvn.verify_normal_reference))
    monkeypatch.setattr(tbank_module, "verify_marker",
                        counting(tvm.verify_marker, tvm.verify_marker_reference))
    bank = _bank()
    (sw, cls), = bank.classes.items()
    groups = cls["groups"]
    saved = (tvn.verify_normal.launches, tvm.verify_marker.launches)
    want = {"normal": 0, "marker": 0}
    path = f"stand_in_{rounds}"
    # The first use (eager, then the capture) has hits in both groups, so
    # the capture records what each body launches.
    with counted_verify_launches(path, lambda: [bank]):
        for i, kind in enumerate(["both", "none", "normal", "marker", "none", "both"]):
            section = torch.from_numpy(_section(kind))
            if rounds > 1:
                section = section[None].repeat(rounds, 1)
                section[0] = torch.from_numpy(_section("none"))
                out = bank.step(sw, section,
                                torch.full((rounds,), section.shape[1], dtype=torch.int32))
            else:
                out = bank.step(sw, section, section.shape[0])
            live = _live(out, groups)
            assert live == SECTIONS[kind][1]
            for g in groups:  # the first use is eager: every group verifies
                want[g.kind] += 1 if i == 0 or g.kind in live else 0
    got = {kind: VERIFY_PATH_LAUNCHES[f"verify_{kind}"].pop(path) for kind in want}
    tvn.verify_normal.launches, tvm.verify_marker.launches = saved
    step, = bank.graphs.steps()
    assert step.replays == 5
    assert step.kernel_launches[tvn.verify_normal] == step.kernel_launches[tvm.verify_marker] == 0
    assert step.body_launches == [{tvn.verify_normal if g.kind == "normal" else tvm.verify_marker: 1}
                                  for g in groups]
    assert got == want


@pytest.mark.parametrize("name", VERIFY_NORMAL_CASES)
def test_the_normal_bound_reads_the_constants_of_clips_with_a_live_lane(name):
    """``chip_smoke``'s bound of the normal verifier counts a clip's
    partitions and downsampled window once for each clip that has a live
    lane (row r's clip is r % G), not for every clip of the call; with one
    live lane, one clip's."""
    args = verify_normal_inputs(verify_normal_case(name), CPU)
    corr, pos, alive, consts, normalise = args
    g = consts.ds_clip.shape[0]
    clip_bytes = (10 * consts.partition_size + consts.ds_clip.shape[1]) * 4
    rows = np.flatnonzero(alive.numpy().any(axis=1))
    got = verify_normal_bound(args)
    assert (got["live_clips"], got["clips"]) == (len({r % g for r in rows}), g)
    one = torch.zeros_like(alive)
    one[rows[-1], int(np.flatnonzero(alive[rows[-1]].numpy())[0])] = True
    single = verify_normal_bound((corr, pos, one, consts, normalise))
    lane_bytes = consts.corr_len * 4 + 8
    extra = ((got["live_lanes"] - 1) * lane_bytes + (got["live_clips"] - 1) * clip_bytes)
    assert single["live_clips"] == 1
    row_bytes = 0 if normalise is None else 4 + (0 if isinstance(normalise[0], int) else 4)
    extra += (len(rows) - 1) * row_bytes
    assert got["bound_ms"] - single["bound_ms"] == pytest.approx(
        extra / HBM_BYTES_PER_S * 1e3, rel=1e-9)
