"""The two greedy filters' wrappers on the CPU: the lane greedy
(``ops/lane_greedy.py``) and the lean block-wise survivors
(``ops/lean_greedy.py``).

On a CUDA card each wrapper launches its kernel (``csrc/lane_greedy.cu``,
``csrc/lean_greedy.cu``); on the CPU it runs its plain version, and it
never falls back from one to the other. Here, on the CPU:

* each wrapper equals its plain version (both loop forms) and the JAX
  package's function on the same numpy inputs: the JAX
  ``greedy_distance_filter`` at K = 64, 2048, 2049 and 4,728 with dense
  clusters and dead lanes holding garbage positions; the JAX lean group
  (``_lean_group_packed_pallas``, its candidate scan in interpret mode, as
  the JAX tests run it, stopped at its greedy's outputs) on the named
  cases of ``chip_smoke.LEAN_GREEDY_CASES`` at m = 40 and 700: no
  candidate, fewer than ``r_max``, exactly ``r_max``, overflow, a refused
  round, rows finishing apart, rows shorter than the 516-sample window,
  ``valid_len`` at a block edge and one either side, plateaus of 2 and 3
  samples at the threshold, edges in the seed's own block, m past the row
  and edges past both row ends;
* a numpy transliteration of each kernel's per-row algorithm, kept here
  and not in the package, against the plain version on hypothesis inputs
  and named cases: the lane greedy's position order and warp walk (with
  its worst cases, ``chip_smoke.LANE_WORST_CASES``), the lean greedy's
  windows made once a round and its maximum per 32 blocks (with the row's
  own exit at exhaustion or at its first refused round);
* a library whose launch returns a CUDA error makes the wrapper raise, and
  what does not fit the kernel's shared memory is refused before a launch.

Tolerance: none. Every output is an integer, a mask, or a height that is a
quotient rounded as IEEE division, held bit for bit. The kernels against
their plain versions on the card: tests/test_torch_cuda.py and
``chip_smoke.py``'s ``greedy_kernels`` phase.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_pattern_detector_tpu.models import bank as jbank
from audio_pattern_detector_tpu.ops import pallas_peaks as jpallas
from audio_pattern_detector_tpu.ops import peaks as jpeaks
from audio_pattern_detector_tpu_torch.kernels import _build
from audio_pattern_detector_tpu_torch.ops import lane_greedy as tlane
from audio_pattern_detector_tpu_torch.ops import lean_greedy as tlean
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan_reference
from chip_smoke import (
    LANE_WORST_CASES,
    LEAN_GREEDY_CASES,
    LEAN_GREEDY_MS,
    lane_greedy_input,
    lane_worst_case,
    lean_greedy_case,
    lean_greedy_inputs,
    random_lean_greedy_case,
)
from tests.test_torch_capture import RecordingBackend

torch.set_num_threads(1)

SENTINEL = 2**30
BLOCK, WINDOW = 512, 516


# ── Numpy transliterations of the kernels' per-row algorithms ──


def np_lane_greedy(pos: np.ndarray, alive: np.ndarray, m: int) -> np.ndarray:
    """csrc/lane_greedy.cu row by row: the alive lanes compacted in lane
    order, their int32 positions less the row's smallest sorted by a stable
    LSD radix sort of 4-bit digits (as many passes as the span needs); each
    lane's neighbour range [lo, hi) of that order; then the warp's walk,
    32 compact lanes a chunk: a ballot of the open flags, and each open lane
    with a neighbour, lowest first, kept and its higher neighbours cleared
    (in the chunk's word, or in the flags of later chunks)."""
    keep = np.zeros(alive.shape, dtype=bool)
    full = 0xFFFFFFFF
    for r in range(pos.shape[0]):
        lanes = np.flatnonzero(alive[r])
        n = len(lanes)
        if n == 0:
            continue
        p = pos[r, lanes].astype(np.int32).astype(np.int64)  # the kernel's int32 positions
        key = p - p.min()
        val = np.arange(n)
        for shift in range(0, int(key.max()).bit_length(), 4):
            order = np.argsort((key >> shift) & 15, kind="stable")
            key, val = key[order], val[order]
        lo, hi = np.empty(n, dtype=np.int64), np.empty(n, dtype=np.int64)
        lo[val] = np.searchsorted(key, key - (m - 1), side="left")
        hi[val] = np.searchsorted(key, key + (m - 1), side="right")
        open_ = np.ones(n, dtype=bool)
        for base in range(0, n, 32):
            chunk = range(base, min(base + 32, n))
            word = sum(1 << (c - base) for c in chunk if open_[c])
            sweepers = sum(1 << (c - base) for c in chunk if open_[c] and hi[c] > lo[c] + 1)
            todo = word & sweepers
            while todo:
                b = (todo & -todo).bit_length() - 1
                i = base + b
                cleared = 0
                for j in val[lo[i]:hi[i]].tolist():
                    if j > i:
                        if j < base + 32:
                            cleared |= 1 << (j - base)
                        else:
                            open_[j] = False
                word &= ~cleared
                todo = word & sweepers & (full << (b + 1)) & full
            for c in chunk:
                open_[c] = bool(word >> (c - base) & 1)
        keep[r, lanes] = open_
    return keep


def np_lean_greedy(corr, valid_len, bmax, denom, hm, m, r_max):
    """csrc/lean_greedy.cu row by row: the seeds from a maximum per 32
    blocks (first maxima); each round's windows (the seed block's and the
    two candidate blocks of each edge, one per distinct start) made before
    the round reads any, the suppression test against the slots filled so
    far (and the sentinel while a slot is unfilled), and only the
    second-level entries of the span between the edge blocks refreshed;
    rounds until the row is exhausted, a round is refused or ``r_max``
    rounds ran."""
    g, l = corr.shape
    nb = bmax.shape[1]
    ng = -(-nb // 32)
    lens = np.broadcast_to(np.asarray(valid_len, dtype=np.int64), (g,))
    pos = np.full((g, r_max), SENTINEL, dtype=np.int64)
    height = np.full((g, r_max), -np.inf, dtype=np.float32)
    overflow = np.zeros(g, dtype=bool)
    hm = np.float32(hm)
    neg = np.float32(-np.inf)

    def first_max(v, idx):
        j = int(np.argmax(v))
        return v[j], idx[j]

    for r in range(g):
        d = np.float32(denom[r])
        q = (bmax[r] / d).astype(np.float32)
        bwork = np.where(q >= hm, q, neg).astype(np.float32)

        def group_max(k):
            b = np.arange(32 * k, min(32 * k + 32, nb))
            return first_max(bwork[b], b)

        gmax = [group_max(k) for k in range(ng)]

        def window_start(b):
            return min(max(b * BLOCK - 2, 0), max(l - WINDOW, 0))

        def window(start):
            c = start + np.arange(WINDOW)
            x = np.where(c < l, corr[r, np.minimum(c, l - 1)], np.float32(0))
            return np.where(c < lens[r], (x / d).astype(np.float32), neg)

        def candidates(xq, start, b, slots, unfilled):
            c = start + np.arange(WINDOW)
            pad = np.full(2, -np.inf, dtype=np.float32)
            ext = np.concatenate([pad, xq, pad])
            xm2, xm1, xp1, xp2 = ext[:-4], ext[1:-3], ext[3:-1], ext[4:]
            fin1, fin2 = np.isfinite(xp1), np.isfinite(xp2)
            runs = (((xm1 < xq) & (xp1 < xq) & fin1)
                    | ((xm1 < xq) & (xp1 == xq) & (xp2 < xq) & fin2)
                    | ((xm2 < xq) & (xm1 == xq) & (xp1 == xq) & (xp2 < xq) & fin2 & (c > 1)))
            mask = (runs & (c >= b * BLOCK) & (c < (b + 1) * BLOCK) & (c > 0)
                    & np.isfinite(xq) & (xq >= hm))
            near = list(slots) + ([SENTINEL] if unfilled else [])
            supp = (np.abs(c[:, None] - np.array(near, dtype=np.int64)[None, :]) < m).any(axis=1)
            return np.where(mask & ~supp, xq, neg)

        def clamp(b):
            return min(max(b, 0), nb - 1)

        for k in range(r_max):
            bh, bi = first_max(np.array([v for v, _ in gmax], dtype=np.float32),
                               np.array([i for _, i in gmax]))
            if not bh > -np.inf:
                break  # exhausted
            bi = int(bi)
            a_lo, a_hi = (bi * BLOCK - (m - 1)) // BLOCK, (bi * BLOCK + (m - 1)) // BLOCK
            blocks = (bi, clamp(a_lo), clamp(a_lo + 1), clamp(a_hi), clamp(a_hi + 1))
            windows = {window_start(b): window(window_start(b)) for b in blocks}
            assert len(windows) <= 5
            start = window_start(bi)
            v = candidates(windows[start], start, bi, pos[r, :k], True)
            j = int(np.argmax(v))  # the first maximum
            if v[j] != bh:
                break  # refused: the state stays, so the round would repeat
            p = start + j
            pos[r, k], height[r, k] = p, v[j]
            lo, hi = p - (m - 1), p + (m - 1)
            be = [clamp(lo // BLOCK), clamp(hi // BLOCK)]
            edge_max = []
            for b in be:  # its window was copied with the seed's
                w = window_start(b)
                edge_max.append(candidates(windows[w], w, b, pos[r, :k + 1], k + 1 < r_max).max())
            b0 = np.arange(nb) * BLOCK
            full_in = (b0 >= lo) & (b0 + BLOCK - 1 <= hi)
            b_first, b_last = min(be), max(be)
            assert not full_in[:b_first].any() and not full_in[b_last + 1:].any()
            bwork[full_in] = neg
            for b, mv in zip(be, edge_max):
                bwork[b] = min(bwork[b], mv)
            for kk in range(b_first // 32, b_last // 32 + 1):
                gmax[kk] = group_max(kk)
        overflow[r] = any(v > -np.inf for v, _ in gmax)
    return pos, height, overflow


# ── The lane greedy ──


def _jax_lane(pos, alive, m):
    height = np.where(alive, np.float32(1.0), np.float32(-np.inf))
    jc = jpeaks.PeakCandidates(jnp.asarray(pos), jnp.asarray(height), jnp.asarray(alive),
                               jnp.zeros(pos.shape[0], dtype=bool))
    return np.asarray(jpeaks.greedy_distance_filter(jc, m))


LANE_CASES = {
    # k: (alive counts per row, row length, m)
    64: ([40, 64, 0], 4000, 90),
    2048: ([300, 2048], 60_000, 200),  # the parallel form's largest K
    2049: ([2049, 700], 60_000, 200),  # the sequential form's smallest K
    4728: ([4728, 1500], 200_000, 400),  # the flagship marker group's lanes
}


@pytest.mark.parametrize("k", sorted(LANE_CASES))
def test_lane_greedy_equals_its_plain_version_and_jax(k):
    n_alive, l, m = LANE_CASES[k]
    pos, alive = lane_greedy_input(len(n_alive), k, n_alive, l, m, seed=k)
    want = _jax_lane(pos, alive, m)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(alive)
    before = tlane.lane_greedy.launches
    got = tlane.lane_greedy(tp, ta, m)
    assert tlane.lane_greedy.launches == before  # the plain version counts nothing
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tlane.lane_greedy_reference(tp, ta, m).numpy(), want)
    backend = RecordingBackend()
    np.testing.assert_array_equal(
        tlane.lane_greedy(tp, ta, m, loop=backend.while_loop).numpy(), want)
    assert backend.loops == 1
    np.testing.assert_array_equal(np_lane_greedy(pos, alive, m), want)
    # Suppression ran, every kept lane is alive, and a dead row keeps nothing.
    assert not (want & ~alive).any()
    assert (want.sum(axis=1) < alive.sum(axis=1))[np.array(n_alive) > 0].all()


@pytest.mark.parametrize("name", LANE_WORST_CASES)
def test_lane_greedy_worst_cases(name):
    """The kernel's named worst cases (``chip_smoke.LANE_WORST_CASES``, timed
    on the card by phase 20): the transliteration, the wrapper and both
    plain forms against the JAX filter (on the int32 positions both take),
    with what each case is for. One cluster holds all 4,728 lanes of its
    first row; the others are 3 rows of 300 lanes."""
    k = 4728 if name == "one_cluster" else 300
    pos, alive, m = lane_worst_case(name, 3, k, seed=1)
    want = _jax_lane(pos.astype(np.int32), alive, m)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(alive)
    np.testing.assert_array_equal(np_lane_greedy(pos, alive, m), want)
    np.testing.assert_array_equal(tlane.lane_greedy(tp, ta, m).numpy(), want)
    np.testing.assert_array_equal(tlane._greedy_distance_parallel(tp, ta, m).numpy(), want)
    np.testing.assert_array_equal(tlane._greedy_distance_sequential(tp, ta, m).numpy(), want)
    kept = want.sum(axis=1)
    if name in ("one_position", "one_cluster"):
        assert kept.tolist() == [1, 1, 1]
    elif name == "min_distance_0":
        np.testing.assert_array_equal(want, alive)
    elif name == "min_distance_1":
        distinct = [len(np.unique(pos[r][alive[r]])) for r in range(3)]
        assert kept.tolist() == distinct and (kept < alive.sum(axis=1)).all()
    else:  # dead lanes' garbage changes nothing
        assert (~alive).sum(axis=1).tolist() == [0, 50, 100]
        clean = np.where(alive, pos, 0)
        np.testing.assert_array_equal(np_lane_greedy(clean, alive, m), want)


@settings(max_examples=60, deadline=None)
@given(
    g=st.integers(1, 4),
    k=st.integers(1, 100),
    m=st.integers(0, 40),
    l=st.integers(8, 300),
    data=st.data(),
)
def test_lane_transliteration_equals_the_plain_version(g, k, m, l, data):
    """The position order and the warp's ballot walk (up to four chunks of
    32 lanes) against the plain version in both forms (parallel and
    sequential, whatever K), on prefixes of alive lanes at positions that
    may repeat and cluster, min_distance 0 included."""
    n_alive = data.draw(st.lists(st.integers(0, k), min_size=g, max_size=g))
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    pos = rng.integers(-2**31, 2**31 - 1, size=(g, k), dtype=np.int64)
    alive = np.arange(k)[None, :] < np.array(n_alive)[:, None]
    pos[alive] = rng.integers(0, l, size=int(alive.sum()))
    want = np_lane_greedy(pos, alive, m)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(alive)
    np.testing.assert_array_equal(tlane.lane_greedy(tp, ta, m).numpy(), want)
    np.testing.assert_array_equal(tlane._greedy_distance_parallel(tp, ta, m).numpy(), want)
    np.testing.assert_array_equal(tlane._greedy_distance_sequential(tp, ta, m).numpy(), want)


# ── The lean block-wise survivors ──


class _Stop(Exception):
    pass


def _jax_lean(case: dict, valid_len: int, rows: slice, monkeypatch) -> list[np.ndarray]:
    """The JAX lean group on ``rows`` of the case with one valid length:
    its candidate scan in interpret mode (the case's block-maximum edits
    applied to what it returns), its greedy's (pos, height, overflow); the
    group stops there, before its verify tail."""
    scan = jpallas.candidate_scan
    greedy = jpeaks.greedy_survivors_from_blocks
    lo = rows.start
    got = {}

    def edited_scan(corr, thr, vl, **kw):
        out = scan(corr, thr, vl, **kw)
        bmax = np.asarray(out[0]).copy()
        for row, b, v in case["edits"]:
            if rows.start <= row < rows.stop:
                bmax[row - lo, b] = v
        return (jnp.asarray(bmax), *out[1:])

    def recorded(*args, **kwargs):
        got["out"] = [np.asarray(x) for x in greedy(*args, **kwargs)]
        raise _Stop

    with monkeypatch.context() as mp:
        mp.setattr(jpallas, "candidate_scan", edited_scan)
        mp.setattr(jpeaks, "greedy_survivors_from_blocks", recorded)
        with pytest.raises(_Stop):
            jbank._lean_group_packed_pallas(
                None, jnp.asarray(case["corr"][rows]), jnp.int32(valid_len), "normal",
                case["m"], 64, 64, case["hm"], None, jnp.asarray(case["scm"][rows]))
    return got["out"]


def _jax_lean_rows(case: dict, monkeypatch) -> list[np.ndarray]:
    """The JAX lean group's greedy outputs for every row: in one call with
    the case's one valid length, or row by row with each row's own."""
    g = case["corr"].shape[0]
    vl = case["valid_len"]
    if not isinstance(vl, np.ndarray):
        return _jax_lean(case, vl, slice(0, g), monkeypatch)
    parts = [_jax_lean(case, int(vl[r]), slice(r, r + 1), monkeypatch) for r in range(g)]
    return [np.concatenate(x) for x in zip(*parts)]


def _as_np(out) -> list[np.ndarray]:
    return [t.numpy() for t in out]


def _same(got: list[np.ndarray], want: list[np.ndarray]) -> None:
    pos, height, overflow = got
    np.testing.assert_array_equal(pos, want[0].astype(np.int64))
    np.testing.assert_array_equal(height.view(np.int32), want[1].astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(overflow, want[2])


@pytest.mark.parametrize("m", LEAN_GREEDY_MS)
@pytest.mark.parametrize("name", LEAN_GREEDY_CASES)
def test_lean_greedy_equals_its_plain_version_and_the_jax_lean_group(monkeypatch, name, m):
    case = lean_greedy_case(name, m)
    args = lean_greedy_inputs(case, torch.device("cpu"), candidate_scan_reference)
    want = _jax_lean_rows(case, monkeypatch)
    before = tlean.lean_greedy.launches
    got = _as_np(tlean.lean_greedy(*args))
    assert tlean.lean_greedy.launches == before  # the plain version counts nothing
    _same(got, want)
    _same(_as_np(tlean.lean_greedy_reference(*args)), want)
    backend = RecordingBackend()
    _same(_as_np(tlean.lean_greedy(*args, loop=backend.while_loop)), want)
    corr, valid_len, bmax, denom, hm, _, r_max = args
    vl = valid_len.numpy() if isinstance(valid_len, torch.Tensor) else valid_len
    _same(list(np_lean_greedy(corr.numpy(), vl, bmax.numpy(), denom.numpy(), hm, m, r_max)),
          want)
    pos, height, overflow = got
    kept = np.isfinite(height).sum(axis=1)
    assert (pos[~np.isfinite(height)] == SENTINEL).all()
    # What each case is for.
    if name == "no_candidate":
        assert kept.tolist() == [0, 0] and not overflow.any()
    elif name == "exactly_r_max":
        assert kept[0] == case["r_max"] and not overflow[0]
    elif name == "overflow":
        assert kept[0] == case["r_max"] and overflow.tolist() == [True, False]
    elif name == "refused_round":
        assert kept[0] == 1 and overflow.tolist() == [True, False]
    elif name == "rows_finish_apart":
        assert kept.tolist() == [0, 2, 7] and not overflow.any()
    elif name == "fewer_than_r_max":
        assert kept.tolist() == [3, 1]
    elif name == "plateaus_at_hm":
        assert {100, 301, 511, 1024} <= set(pos[0].tolist()) if m < 512 else kept[0] >= 1
        assert not {1, 500, 701} & set(pos[0].tolist())
    elif name == "valid_len_at_block_edge":
        assert 1022 not in pos[0] and 1022 in pos[1] and 1022 in pos[2]
    elif name == "edges_in_seed_window":
        assert kept.tolist() == ([2, 2] if m < 100 else [1, 1]) and not overflow.any()
        assert pos[:, 0].tolist() == [1300, 1812]
    elif name == "row_shorter_than_m":  # m = 700 past the row: one survivor a row
        assert kept.tolist() == ([3, 3] if m < 300 else [1, 1]) and not overflow.any()
    elif name == "edges_at_row_ends":
        assert kept.tolist() == [3, 3] and {3, 4093} <= set(pos[0].tolist())
    else:  # rows shorter than the window
        assert (kept >= 1).all()


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    g=st.integers(1, 3),
    l=st.integers(3, 2200),
    m=st.integers(1, 900),
    r_max=st.integers(1, 5),
    per_row=st.booleans(),
    edits=st.integers(0, 2),
)
def test_lean_transliteration_equals_the_plain_version(seed, g, l, m, r_max, per_row, edits):
    """The kernel's per-row rounds (the row's own exit at exhaustion or at
    its first refused round) against the plain version in both forms, on
    rows of planted peaks and short plateaus at a few heights (ties in
    both argmaxes), per-row lengths, and block maxima that are the scan's
    or, now and then, raised or lowered (refused rounds)."""
    case = random_lean_greedy_case(seed, g, l, m, r_max, per_row, edits)
    args = lean_greedy_inputs(case, torch.device("cpu"), candidate_scan_reference)
    corr, valid_len, bmax, denom, hm, _, _ = args
    vl = valid_len.numpy() if isinstance(valid_len, torch.Tensor) else valid_len
    want = np_lean_greedy(corr.numpy(), vl, bmax.numpy(), denom.numpy(), hm, m, r_max)
    for out in (tlean.lean_greedy(*args),
                tlean.lean_greedy(*args, loop=RecordingBackend().while_loop)):
        _same(_as_np(out), list(want))


# ── No fallback ──


def _stub(monkeypatch, code: int):
    lib = types.SimpleNamespace(apd_lane_greedy=lambda *a: code, apd_lean_greedy=lambda *a: code)
    monkeypatch.setattr(_build, "load_kernels", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def test_a_launch_that_returns_a_cuda_error_raises(monkeypatch):
    """The launch path with a library whose entry points return a CUDA
    error (700, an illegal address): each wrapper raises, counts no launch
    and runs no plain version in its place."""
    _stub(monkeypatch, 700)
    monkeypatch.setattr(tlane, "lane_greedy_reference", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(tlean, "lean_greedy_reference", lambda *a: pytest.fail("fell back"))
    pos, alive = lane_greedy_input(2, 64, [40, 10], 4000, 90, seed=1)
    before = (tlane.lane_greedy.launches, tlean.lean_greedy.launches)
    with pytest.raises(RuntimeError, match="lane_greedy kernel launch failed: CUDA error 700"):
        tlane._launch(torch.from_numpy(pos), torch.from_numpy(alive), 90)
    case = lean_greedy_case("fewer_than_r_max", 40)
    args = lean_greedy_inputs(case, torch.device("cpu"), candidate_scan_reference)
    with pytest.raises(RuntimeError, match="lean_greedy kernel launch failed: CUDA error 700"):
        tlean._launch(*args)
    assert (tlane.lane_greedy.launches, tlean.lean_greedy.launches) == before
    _stub(monkeypatch, 0)  # a launch that succeeds is counted
    tlane._launch(torch.from_numpy(pos), torch.from_numpy(alive), 90)
    tlean._launch(*args)
    assert (tlane.lane_greedy.launches, tlean.lean_greedy.launches) == (
        before[0] + 1, before[1] + 1)
    tlane.lane_greedy.launches, tlean.lean_greedy.launches = before


def test_what_the_kernels_do_not_take_is_refused_before_a_launch(monkeypatch):
    """Shared memory past what a block may take (K = 46,285 lanes; 20,000
    survivor lanes), wrong types, shapes and layouts, and lengths outside
    the row raise ValueError without touching the library; an unsupported
    device raises too."""
    _stub(monkeypatch, 0)
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("reached the library"))
    for k in (46_285, tlane.MAX_LANES + 1):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            tlane._launch(torch.zeros((1, k), dtype=torch.int64), torch.zeros((1, k), dtype=bool),
                          5)
    assert tlane.MAX_LANES >= 16_384  # k_detect's cap (models/bank.py)
    tlane_ok = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        tlane._launch(tlane_ok.int(), torch.zeros((2, 8), dtype=bool), 5)
    with pytest.raises(ValueError, match="alive"):
        tlane._launch(tlane_ok, torch.zeros((2, 4), dtype=bool), 5)
    case = lean_greedy_case("fewer_than_r_max", 40)
    corr, valid_len, bmax, denom, hm, m, _ = lean_greedy_inputs(
        case, torch.device("cpu"), candidate_scan_reference)
    with pytest.raises(ValueError, match="shared memory"):
        tlean._launch(corr, valid_len, bmax, denom, hm, m, 20_000)
    with pytest.raises(ValueError, match="bmax"):
        tlean._launch(corr, valid_len, bmax[:, :-1], denom, hm, m, 16)
    with pytest.raises(ValueError, match="valid_len"):
        tlean._launch(corr, corr.shape[1] + 1, bmax, denom, hm, m, 16)
    with pytest.raises(ValueError, match="per-row valid_len"):
        tlean._launch(corr, torch.zeros(2, dtype=torch.int64), bmax, denom, hm, m, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        tlane.lane_greedy(tlane_ok.to("meta"), torch.zeros((2, 8), dtype=bool, device="meta"), 5)
    with pytest.raises(ValueError, match="unsupported device"):
        tlean.lean_greedy(corr.to("meta"), 5, bmax, denom, hm, m, 16)



def test_the_lean_greedy_takes_every_row_a_detector_admits(monkeypatch):
    """Both detectors refuse a configuration whose positions reach 2**24
    (``seconds_per_chunk=3400`` at 8 kHz) with the same message, so no row
    the lean tier is given is as long as 2**24 samples; a (1, 2**24 - 1)
    row at the lean tier's r_max = 16 fits the kernel's shared memory and
    reaches the library."""
    from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
    from audio_pattern_detector_tpu.utils.clip import AudioClip as JaxClip
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    clip = np.sin(np.arange(8000) * 0.3).astype(np.float32)
    errors = []
    for make in (lambda: AudioPatternDetector([JaxClip(name="c", audio=clip, sample_rate=8000)],
                                              seconds_per_chunk=3400),
                 lambda: TorchAudioPatternDetector([AudioClip(name="c", audio=clip,
                                                              sample_rate=8000)],
                                                   device="cpu", seconds_per_chunk=3400)):
        with pytest.raises(ValueError, match="2\\*\\*24") as exc:
            make()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]

    calls = []
    lib = types.SimpleNamespace(apd_lean_greedy=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(_build, "load_kernels", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    l = 2**24 - 1
    nb = -(-l // BLOCK)
    assert 16 * 12 + nb * 4 + -(-nb // tlean.GROUP) * 8 <= tlean._MAX_SMEM
    corr = torch.empty((1, l), dtype=torch.float32)
    bmax, denom = torch.zeros((1, nb), dtype=torch.float32), torch.ones(1, dtype=torch.float32)
    before = tlean.lean_greedy.launches
    pos, height, overflow = tlean._launch(corr, l, bmax, denom, 0.5, 8000, 16)
    assert len(calls) == 1 and calls[0][3] == l and calls[0][6] == nb
    assert pos.shape == height.shape == (1, 16) and overflow.shape == (1,)
    assert tlean.lean_greedy.launches == before + 1
    tlean.lean_greedy.launches = before
