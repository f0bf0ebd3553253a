"""The port's full-tier peak ops against the JAX package's.

Every output of these ops is an integer or a mask, so each is held to
identity with JAX on the same f32 input (no tolerance). Inputs come from
numpy seeds: rows with planted plateaus of length 1-5, planted equal
heights, rows with more candidates than lanes, and lane counts on both
sides of the 2048 threshold between the parallel and sequential greedy.
``topk_sparse``'s contract covers only finite lanes (dead lanes carry
unspecified positions), so lanes are compared where the height is finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.ops import peaks as jpeaks
from audio_pattern_detector_tpu_torch.ops import peaks as tpeaks

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _plateau_rows(g, l, seed, valid_len):
    """Noise rows with plateaus of length 1-5 at seeded heights, some tied
    across plateaus, and -inf from ``valid_len`` on."""
    rng = np.random.default_rng(seed)
    x = (0.2 * rng.random((g, l))).astype(np.float32)
    levels = rng.uniform(0.3, 1.0, 6).astype(np.float32)
    for gi in range(g):
        for p in rng.choice(np.arange(4, l - 12, 9), size=min(40, l // 20), replace=False):
            run = int(rng.integers(1, 6))
            x[gi, p : p + run] = levels[rng.integers(0, len(levels))]
    x[:, valid_len:] = -np.inf
    return x


@pytest.mark.parametrize("seed,l,valid_len", [(0, 600, 600), (1, 900, 850), (2, 2000, 1500)])
def test_plateau_local_maxima_mask_identical(seed, l, valid_len):
    x = _plateau_rows(3, l, seed, valid_len)
    want = np.asarray(jpeaks.plateau_local_maxima_mask(jnp.asarray(x)))
    got = tpeaks.plateau_local_maxima_mask(_t(x)).numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_plateau_mask_in_row_passes_identical_to_jax():
    """More rows than one pass takes (two full passes and a short one),
    each row with its own valid length: JAX's mask, row for row."""
    g = 2 * tpeaks._PLATEAU_ROWS + 5
    x = _plateau_rows(g, 700, 7, 700)
    for gi in range(g):
        x[gi, 400 + gi:] = -np.inf
    want = np.asarray(jpeaks.plateau_local_maxima_mask(jnp.asarray(x)))
    got = tpeaks.plateau_local_maxima_mask(_t(x)).numpy()
    assert want[: tpeaks._PLATEAU_ROWS].any() and want[-5:].any()
    np.testing.assert_array_equal(got, want)


def _scored(g, l, n_cand, seed, tie_levels=None):
    """(G, L) -inf rows with ``n_cand`` finite entries each; with
    ``tie_levels`` every height is drawn from that small set (many ties)."""
    rng = np.random.default_rng(seed)
    x = np.full((g, l), -np.inf, dtype=np.float32)
    for gi in range(g):
        pos = rng.choice(l, size=n_cand, replace=False)
        if tie_levels is None:
            x[gi, pos] = rng.uniform(0.25, 1.0, n_cand).astype(np.float32)
        else:
            x[gi, pos] = rng.choice(np.float32(tie_levels), n_cand)
    return x


@pytest.mark.parametrize(
    "l,k,n_cand,ties",
    [
        (20_000, 16, 12, True),  # hierarchical JAX branch, ties, under k
        (20_000, 64, 64, True),  # exactly k finite entries
        (3_000, 1024, 700, True),  # flat JAX branch, ties
        (20_000, 16, 200, False),  # more candidates than lanes, no ties
        (3_000, 256, 900, False),
    ],
)
def test_topk_sparse_finite_lanes_identical(l, k, n_cand, ties):
    x = _scored(3, l, n_cand, seed=l + k, tie_levels=[0.3, 0.5, 0.5, 0.9] if ties else None)
    jh, jp = (np.asarray(a) for a in jpeaks.topk_sparse(jnp.asarray(x), k))
    th, tp = (a.numpy() for a in tpeaks.topk_sparse(_t(x), k))
    np.testing.assert_array_equal(th, jh)  # dead lanes are -inf in both
    fin = np.isfinite(jh)
    np.testing.assert_array_equal(tp[fin], jp[fin])
    assert fin.sum(axis=1).min() == min(k, n_cand)


def test_topk_sparse_orders_planted_ties_by_position():
    x = np.full((1, 5000), -np.inf, dtype=np.float32)
    x[0, [4000, 17, 2500, 900]] = 0.5
    x[0, [3000, 10]] = 0.75
    h, p = tpeaks.topk_sparse(_t(x), 8)
    assert p[0, :6].tolist() == [10, 3000, 17, 900, 2500, 4000]
    assert h[0, :6].tolist() == [0.75, 0.75, 0.5, 0.5, 0.5, 0.5]


@pytest.mark.parametrize("l,k,n_cand,ties", [(5_000, 16, 10, True), (5_000, 64, 90, False)])
def test_select_candidates_identical(l, k, n_cand, ties):
    # Over k, equal heights straddling the k-th lane may pick other lanes
    # (outside the contract; such rows are flagged), so that case has none.
    x = _scored(2, l, n_cand, seed=7, tie_levels=[0.4, 0.6, 0.8] if ties else None)
    mask = np.isfinite(x)
    xs = np.where(mask, x, np.float32(0.1))
    want = jpeaks.select_candidates(jnp.asarray(xs), jnp.asarray(mask), k)
    got = tpeaks.select_candidates(_t(xs), _t(mask), k)
    alive = np.asarray(want.alive)
    np.testing.assert_array_equal(got.alive.numpy(), alive)
    np.testing.assert_array_equal(got.height.numpy(), np.asarray(want.height))
    np.testing.assert_array_equal(got.pos.numpy()[alive], np.asarray(want.pos)[alive])
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))


def _candidates(g, k, n_alive, l, seed):
    """Height-sorted candidate lanes (ties included), alive prefix of
    ``n_alive[g]`` lanes, positions dense enough for long suppression
    chains."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((g, k), dtype=np.int32)
    height = np.full((g, k), -np.inf, dtype=np.float32)
    for gi in range(g):
        n = n_alive[gi]
        pos[gi] = rng.choice(l, size=k, replace=False)
        h = rng.choice(np.float32([0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]), n)
        order = np.lexsort((pos[gi, :n], -h))  # height desc, then position
        height[gi, :n] = h[order]
        pos[gi, :n] = pos[gi, :n][order]
    alive = np.isfinite(height)
    return pos, height, alive


@pytest.mark.parametrize(
    "k,n_alive,l,m",
    [
        (64, [40, 64, 0], 4000, 90),
        (2048, [300, 2048], 200_000, 600),  # parallel: the largest K it takes
        (2049, [2049, 700], 200_000, 600),  # sequential: the smallest K it takes
        (3000, [1200, 90], 100_000, 300),
    ],
)
def test_greedy_distance_filter_identical(k, n_alive, l, m):
    pos, height, alive = _candidates(len(n_alive), k, n_alive, l, seed=k)
    jc = jpeaks.PeakCandidates(
        jnp.asarray(pos), jnp.asarray(height), jnp.asarray(alive),
        jnp.zeros(len(n_alive), dtype=bool),
    )
    tc = tpeaks.PeakCandidates(
        _t(pos).long(), _t(height), _t(alive), torch.zeros(len(n_alive), dtype=torch.bool)
    )
    want = np.asarray(jpeaks.greedy_distance_filter(jc, m))
    np.testing.assert_array_equal(tpeaks.greedy_distance_filter(tc, m).numpy(), want)
    assert want.sum() > 0 and (want.sum(axis=1) < alive.sum(axis=1)).any()
    if k <= 2048:  # the other variant must agree as well
        np.testing.assert_array_equal(tpeaks._greedy_distance_sequential(tc, m).numpy(), want)
    else:
        np.testing.assert_array_equal(tpeaks._greedy_distance_parallel(tc, m).numpy(), want)


@pytest.mark.parametrize("height_min", [0.0, -0.5, 0.25, 0.45])
@pytest.mark.parametrize("seed", [3, 4])
def test_find_peaks_device_identical(height_min, seed):
    l, valid_len, k, m = 3000, 2600, 64, 40
    x = _plateau_rows(2, l, seed, l)
    x[:, 100:140] = 0.0  # a long zero plateau: a candidate only when height_min <= 0
    x[:, 99] = x[:, 140] = -0.1
    corr = np.where(np.arange(l) < valid_len, x, np.float32(0.0)).astype(np.float32)
    jcand, jflag = jpeaks.find_peaks_device_fast(jnp.asarray(corr), jnp.int32(valid_len), height_min, m, k)
    tcand, tflag = tpeaks.find_peaks_device_fast(_t(corr), valid_len, height_min, m, k)
    alive = np.asarray(jcand.alive)
    assert alive.any()
    np.testing.assert_array_equal(tcand.alive.numpy(), alive)
    np.testing.assert_array_equal(tcand.pos.numpy()[alive], np.asarray(jcand.pos)[alive])
    np.testing.assert_array_equal(tcand.height.numpy(), np.asarray(jcand.height))
    np.testing.assert_array_equal(tcand.overflow.numpy(), np.asarray(jcand.overflow))
    np.testing.assert_array_equal(tflag.numpy(), np.asarray(jflag))
    if height_min <= 0:
        assert tpeaks.plateau_local_maxima_mask(_t(x[:, :valid_len]))[:, 119].all()
        plain = tpeaks.find_peaks_device(_t(corr), valid_len, height_min, m, k)
        np.testing.assert_array_equal(plain.alive.numpy(), alive)
