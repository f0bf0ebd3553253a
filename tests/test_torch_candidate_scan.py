"""The port's candidate scan against the JAX package's Pallas kernel.

``candidate_scan_reference`` (the plain torch version the CUDA kernel is
held to) must be bitwise equal to ``ops/pallas_peaks.py::candidate_scan``
run in interpret mode, as tests/test_pallas_peaks.py runs it: the scan
has no float sum, so there is no tolerance. The port's ``bmax`` is
``ceil(L/512)`` wide; JAX's fixed 1024 columns past that must be -inf.
The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.ops.pallas_peaks import candidate_scan as jax_candidate_scan
from audio_pattern_detector_tpu_torch.kernels import _build
from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
    BLOCK,
    candidate_scan,
    candidate_scan_reference,
    num_blocks,
)

torch.set_num_threads(1)

V = np.float32(0.6)


def _ulp_below(v, n=1):
    for _ in range(n):
        v = np.nextafter(v, np.float32(0.0), dtype=np.float32)
    return v


def _noise(g, l, seed):
    rng = np.random.default_rng(seed)
    corr = (np.abs(rng.standard_normal((g, l))) * 0.1).astype(np.float32)
    for gi in range(g):
        pos = rng.choice(np.arange(10, l - 10), size=7, replace=False)
        corr[gi, pos] = rng.uniform(0.5, 1.0, 7).astype(np.float32)
    return corr


def _plateaus(g, l):
    corr = np.zeros((g, l), np.float32)
    for gi in range(g):
        base = 37 * gi
        corr[gi, base + 100] = V  # length 1
        corr[gi, base + 200 : base + 202] = V  # length 2 (midpoint 200)
        corr[gi, base + 300 : base + 303] = V  # length 3 (midpoint 301)
        corr[gi, base + 400 : base + 404] = V  # length 4 -> plateau flag
        corr[gi, base + 600 : base + 605] = np.float32(0.1)  # length 5 below thr
        corr[gi, 510 + gi : 514 + gi] = np.float32(0.7)  # straddles a block edge
        corr[gi, 1022 : 1025] = np.float32(0.8)  # length 3 across block 1/2
        corr[gi, 1 : 4] = np.float32(0.9)  # length 3 touching the left edge
    return corr


def _near(g, l):
    corr = np.zeros((g, l), np.float32)
    corr[0, 500], corr[0, 499] = V, _ulp_below(V)  # partner 1 ulp below
    corr[1, 300], corr[1, 302] = V, _ulp_below(V, 8)  # partner at distance 2, 8 ulp
    corr[1, 299] = corr[1, 301] = np.float32(0.3)
    corr[1, 800:802] = np.float32(0.7)  # exact plateau: no hazard
    corr[2, 700], corr[2, 699] = np.float32(0.1), _ulp_below(np.float32(0.1))  # below thr
    if g > 3:
        corr[3, 900], corr[3, 901] = V, _ulp_below(V, 10)  # just outside 2^-20 * V
    return corr


def _edges(g, l):
    corr = np.zeros((g, l), np.float32)
    corr[:, 0] = 1.0  # array edge: never a peak
    corr[:, l - 1] = 1.0
    corr[0, l - 6 : l - 3] = np.float32(0.7)  # plateau cut by valid_len
    corr[1, l - 5] = np.float32(0.8)  # last valid sample
    return corr


CASES = {
    "noise_full": (lambda: _noise(3, 6001, 0), 6001),
    "noise_cut": (lambda: _noise(3, 6001, 1), 6001 - 777),
    "noise_unaligned": (lambda: _noise(2, 1537, 2), 1500),
    "plateaus": (lambda: _plateaus(3, 4096), 4096),
    "near_collapse": (lambda: _near(4, 2048), 2048),
    "edges": (lambda: _edges(2, 2048), 2048 - 4),
    "empty_valid": (lambda: _noise(2, 1024, 3), 0),
}


def _jax_scan(corr, thr, valid_len):
    return [
        np.asarray(a)
        for a in jax_candidate_scan(
            jnp.asarray(corr), jnp.asarray(thr), jnp.int32(valid_len), interpret=True
        )
    ]


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_bitwise_equals_pallas_interpret(case):
    make, valid_len = CASES[case]
    corr = make()
    g, l = corr.shape
    thr = np.linspace(0.25, 0.35, g).astype(np.float32)
    jb, jc, jp, jo, jn = _jax_scan(corr, thr, valid_len)
    tb, tc, tp, to, tn = (
        t.numpy() for t in candidate_scan_reference(torch.from_numpy(corr), torch.from_numpy(thr), valid_len)
    )
    nb = num_blocks(l)
    assert tb.shape == (g, nb)
    np.testing.assert_array_equal(tb.view(np.int32), jb[:, :nb].view(np.int32))
    assert np.all(np.isneginf(jb[:, nb:]))
    np.testing.assert_array_equal(tc.astype(np.float32), jc)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(to.view(np.int32), jo.view(np.int32))
    np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("case", ["noise_cut", "plateaus", "near_collapse", "edges"])
def test_reference_bitwise_equals_pallas_interpret_at_thresholds_up_to_zero(case):
    """Thresholds of 0 and below put every finite sample at or above
    them, so every sample counts toward count, plateau and near."""
    make, valid_len = CASES[case]
    corr = make()
    g, l = corr.shape
    thr = np.resize(np.float32([0.0, -0.5, 0.3]), g)
    want = _jax_scan(corr, thr, valid_len)
    got = [t.numpy() for t in candidate_scan_reference(torch.from_numpy(corr), torch.from_numpy(thr), valid_len)]
    nb = num_blocks(l)
    np.testing.assert_array_equal(got[0].view(np.int32), want[0][:, :nb].view(np.int32))
    np.testing.assert_array_equal(got[1].astype(np.float32), want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3].view(np.int32), want[3].view(np.int32))
    np.testing.assert_array_equal(got[4], want[4])


def test_flags_fire_where_expected():
    corr = _near(4, 2048)
    thr = np.full(4, 0.25, np.float32)
    _, count, plateau, omax, near = candidate_scan_reference(
        torch.from_numpy(corr), torch.from_numpy(thr), 2048
    )
    assert near.tolist() == [True, True, False, False]
    assert not plateau.any()
    corr = _plateaus(1, 4096)
    _, count, plateau, omax, _ = candidate_scan_reference(
        torch.from_numpy(corr), torch.from_numpy(np.full(1, 0.25, np.float32)), 4096
    )
    assert plateau.tolist() == [True]
    assert float(omax[0]) == float(np.float32(0.9))
    # len-1, len-2, len-3 midpoints and the block-edge runs; not the edge run.
    assert int(count[0]) == 5


def test_cpu_tensors_use_the_plain_version_without_counting_launches():
    corr = torch.from_numpy(_noise(2, 3000, 4))
    thr = torch.full((2,), 0.3)
    before = candidate_scan.launches
    got = candidate_scan(corr, thr, 2900)
    want = candidate_scan_reference(corr, thr, 2900)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert candidate_scan.launches == before
    assert got[0].shape == (2, -(-3000 // BLOCK))


def test_unsupported_device_raises():
    corr = torch.zeros((1, 600), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        candidate_scan(corr, torch.zeros(1, device="meta"), 600)


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_kernels()


def test_build_key_follows_sources_and_flags():
    sources = _build._sources()
    assert [s.name for s in sources] == ["candidate_scan.cu", "graph_conditional.cu"]
    key = _build._digest(sources)
    assert key == _build._digest(sources) and len(key) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS


PER_ROW_CASES = {
    # (corr, per-row valid lengths): a full row, cut rows, an empty row and
    # a cut through a length-3 plateau and a block edge.
    "noise": (lambda: _noise(4, 3001, 5), [3001, 2999, 0, 1537]),
    "plateaus": (lambda: _plateaus(3, 4096), [4096, 302, 1024]),
    "edges": (lambda: _edges(2, 2048), [2048 - 4, 2048 - 5]),
    # Two rounds of a 3-clip group folded into the row axis (round-major),
    # as the batched class step sends them: a full round, then an idle one
    # whose zero section leaves only the m - 1 lead-in positions valid.
    "folded_rounds": (lambda: _noise(6, 3001, 7), [3001, 3001, 3001, 599, 599, 599]),
    # Every row another length: a first chunk, short last chunks, an empty row.
    "folded_unequal": (lambda: _plateaus(5, 4096), [4096, 3500, 0, 1, 2049]),
}


@pytest.mark.parametrize("case", sorted(PER_ROW_CASES))
def test_per_row_valid_len_equals_pallas_interpret_row_by_row(case):
    """The (G,) int32 form: row g equals the JAX kernel run at row g's own
    scalar valid_len, bitwise."""
    make, lens = PER_ROW_CASES[case]
    corr = make()
    g, l = corr.shape
    thr = np.linspace(0.25, 0.35, g).astype(np.float32)
    got = [
        t.numpy()
        for t in candidate_scan_reference(
            torch.from_numpy(corr), torch.from_numpy(thr), torch.tensor(lens, dtype=torch.int32)
        )
    ]
    nb = num_blocks(l)
    for gi, vl in enumerate(lens):
        jb, jc, jp, jo, jn = _jax_scan(corr, thr, vl)
        np.testing.assert_array_equal(got[0][gi].view(np.int32), jb[gi, :nb].view(np.int32))
        assert got[1][gi] == jc[gi] and got[2][gi] == jp[gi] and got[4][gi] == jn[gi]
        assert got[3][gi].view(np.int32) == jo[gi].view(np.int32)


@pytest.mark.parametrize("valid_len", [0, 1, 2777, 3001])
def test_per_row_valid_len_equals_the_scalar_form(valid_len):
    corr = torch.from_numpy(_noise(3, 3001, 6))
    thr = torch.full((3,), 0.3)
    scalar = candidate_scan(corr, thr, valid_len)
    per_row = candidate_scan(corr, thr, torch.full((3,), valid_len, dtype=torch.int32))
    for a, b in zip(scalar, per_row):
        assert torch.equal(a, b)
