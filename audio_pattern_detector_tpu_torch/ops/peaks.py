"""Peak masks, candidate capture and the greedy distance filters
(port of audio_pattern_detector_tpu/ops/peaks.py).

No FFT and no float sum: every output here is an integer or a mask and
is identical to its JAX counterpart on the same f32 input.

Two tiers, as in the JAX package:

* lean (every launch): the short-run masks and the block-wise greedy
  ``greedy_survivors_from_blocks``, run as ``r_max`` statically unrolled
  rounds (the JAX ``APD_GREEDY_UNROLL=1`` branch, identical results). Its
  while-loop exit test is not ported: in eager torch it would cost a
  device-to-host sync every round.
* full (the wide rerun of flagged rows and the ``height_min <= 0`` tier):
  the general plateau mask, top-k capture and the lane greedy. Each
  ``while_loop`` is one body over state in tensors updated in place, run
  by a ``loop(pred, body)`` hook (:data:`Loop`): a captured class step
  passes its backend's CUDA while node (``models/captured.py``), and the
  loop stays on the device. Without the hook the host runs the same
  body: the parallel filter syncs once per round (:func:`host_loop`), the
  sequential one once, to read its pass count. That is the eager step's
  form (the CPU, ``capture=False``, and the wide rerun, which runs at
  collect time, after the payload has reached the host).

The mask lean tier of ``APD_PALLAS=0`` seeds the same block-wise greedy
from the full (G, L) candidate mask (:func:`greedy_survivors_blockwise`).
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from audio_pattern_detector_tpu_torch.ops.slicing import slice_rows_windows

SURVIVOR_POS_SENTINEL = 2**30  # dead survivor slots


class PeakCandidates(NamedTuple):
    pos: torch.Tensor  # (G, K) int64, 'full' correlation indices
    height: torch.Tensor  # (G, K) f32
    alive: torch.Tensor  # (G, K) bool
    overflow: torch.Tensor  # (G,) bool: more raw candidates than K


# Rows per pass of the plateau mask: its run bounds are (rows, L) int64
# temporaries (cummax and cummin index in int64), a dozen of them live at
# once. All 512 rows of a 16-row flagship round at once made them the
# round's largest allocations (scripts/probe_general_memory.py).
_PLATEAU_ROWS = 64


def plateau_local_maxima_mask(x: torch.Tensor) -> torch.Tensor:
    """Plateau-midpoint local maxima of any run length (scipy semantics):
    a maximal run of equal values with strictly smaller neighbours on both
    sides flags its floor midpoint. ``x`` is (G, L) f32 with -inf at and
    after each row's valid length. Rows are independent: they run
    _PLATEAU_ROWS at a time."""
    g, l = x.shape
    if g > _PLATEAU_ROWS:
        out = torch.empty((g, l), dtype=torch.bool, device=x.device)
        for lo in range(0, g, _PLATEAU_ROWS):
            out[lo : lo + _PLATEAU_ROWS] = plateau_local_maxima_mask(x[lo : lo + _PLATEAU_ROWS])
        return out
    idx = torch.arange(l, device=x.device)[None, :]
    edge = torch.ones((g, 1), dtype=torch.bool, device=x.device)
    neq_prev = torch.cat([edge, x[:, 1:] != x[:, :-1]], dim=1)
    neq_next = torch.cat([x[:, :-1] != x[:, 1:], edge], dim=1)
    # Start of the equal-value run holding i (cummax), and its end (a
    # cummin over the flipped row).
    run_start = torch.cummax(torch.where(neq_prev, idx, 0), dim=1).values
    run_end = torch.cummin(torch.where(neq_next, idx, l - 1).flip(1), dim=1).values.flip(1)
    prev_val = torch.gather(x, 1, (run_start - 1).clamp_min(0))
    next_val = torch.gather(x, 1, (run_end + 1).clamp_max(l - 1))
    # A finite right neighbour is required: the last true sample before the
    # -inf sentinel is the array edge, and scipy never reports edges.
    return (
        (run_start > 0)
        & (run_end < l - 1)
        & (idx == torch.div(run_start + run_end, 2, rounding_mode="floor"))
        & (prev_val < x)
        & (next_val < x)
        & torch.isfinite(x)
        & torch.isfinite(next_val)
    )


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x[:, i + offset] with -inf beyond both ends (same shape as x)."""
    if offset == 0:
        return x
    if abs(offset) >= x.shape[1]:
        return torch.full_like(x, -math.inf)
    pad =torch.full((x.shape[0], abs(offset)), -math.inf, dtype=x.dtype, device=x.device)
    if offset > 0:
        return torch.cat([x[:, offset:], pad], dim=1)
    return torch.cat([pad, x[:, :offset]], dim=1)


def plateau_run_mask(
    x: torch.Tensor,
    xm2: torch.Tensor,
    xm1: torch.Tensor,
    xp1: torch.Tensor,
    xp2: torch.Tensor,
    fin_p1: torch.Tensor,
    fin_p2: torch.Tensor,
    left_ok: torch.Tensor,
) -> torch.Tensor:
    """Plateau-midpoint comparisons for runs of length 1-3, given shifted
    neighbours (the one comparison chain every caller shares)."""
    len1 = (xm1 < x) & (xp1 < x) & fin_p1
    len2 = (xm1 < x) & (xp1 == x) & (xp2 < x) & fin_p2
    len3 = (xm2 < x) & (xm1 == x) & (xp1 == x) & (xp2 < x) & fin_p2 & left_ok
    return len1 | len2 | len3


def short_run_local_maxima_mask(x: torch.Tensor) -> torch.Tensor:
    """Local-maxima mask handling plateau runs of length 1-3 exactly (floor
    midpoint flagged; runs touching either array edge excluded)."""
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    xp1, xp2 = _shift(x, 1), _shift(x, 2)
    runs = plateau_run_mask(
        x, _shift(x, -2), _shift(x, -1), xp1, xp2,
        fin_p1=torch.isfinite(xp1),
        fin_p2=torch.isfinite(xp2),
        left_ok=idx > 1,
    )
    interior = (idx > 0) & (idx < x.shape[1] - 1)
    return runs & interior & torch.isfinite(x)


def long_plateau_present(
    x: torch.Tensor, height_min: "float | torch.Tensor"
) -> torch.Tensor:
    """(G,) bool: any equal-value run of length >= 4 at or above
    ``height_min`` (a float or a (G, 1) per-row threshold)."""
    quad = (
        (x[:, :-3] == x[:, 1:-2])
        & (x[:, 1:-2] == x[:, 2:-1])
        & (x[:, 2:-1] == x[:, 3:])
        & (x[:, :-3] >= height_min)
        & torch.isfinite(x[:, :-3])
    )
    return quad.any(dim=1)


GatherScored = Callable[[torch.Tensor], "tuple[torch.Tensor, torch.Tensor]"]


def greedy_survivors_from_blocks(
    bwork0: torch.Tensor,  # (G, nb) per-block max of the scored rows
    gather_scored: GatherScored,  # (G,) block ids -> ((G, W) vals, (G, W) positions)
    min_distance: int,
    r_max: int,
    block: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact greedy tallest-first distance survivors over a block summary.

    ``bwork0[g, b]`` is the max candidate value in block ``b`` (-inf if
    none); ``gather_scored`` returns each row's candidate values and their
    ascending global positions for one block (-inf outside it). Per round:
    argmax over blocks, argmax inside the winning block (ties to the lower
    index, as ``torch.argmax`` and ``jnp.argmax`` both resolve them), keep,
    drop fully suppressed blocks, recompute the <= 2 boundary blocks. A
    gathered max that disagrees with the seed refuses the round for that
    row, which then ends with ``overflow``.

    Returns (pos (G, r_max) int64 in descending height order with the
    sentinel past each row's survivors, height (G, r_max) with -inf
    sentinels, overflow (G,) bool: more than r_max survivors).
    """
    g, nb = bwork0.shape
    dev = bwork0.device
    barange = torch.arange(nb, device=dev)[None, :]
    m = min_distance
    neg_inf = torch.full((), -math.inf, dtype=bwork0.dtype, device=dev)
    sentinel = torch.full((), SURVIVOR_POS_SENTINEL, dtype=torch.int64, device=dev)

    def masked_vals(b_idx: torch.Tensor, kept_pos: torch.Tensor):
        vals, offs = gather_scored(b_idx)
        supp = ((offs[:, None, :] - kept_pos[:, :, None]).abs() < m).any(dim=1)
        return torch.where(supp, neg_inf, vals), offs

    kept_pos = torch.full((g, r_max), SURVIVOR_POS_SENTINEL, dtype=torch.int64, device=dev)
    kept_h = torch.full((g, r_max), -math.inf, dtype=bwork0.dtype, device=dev)
    bwork = bwork0
    for r in range(r_max):
        bi = bwork.argmax(dim=1)
        bh = bwork.gather(1, bi[:, None])[:, 0]
        blkm, offs = masked_vals(bi, kept_pos)
        j = blkm.argmax(dim=1)
        p = offs.gather(1, j[:, None])[:, 0]
        h = blkm.amax(dim=1)
        alive = (bh > -math.inf) & (h == bh)
        kept_pos[:, r] = torch.where(alive, p, sentinel)
        kept_h[:, r] = torch.where(alive, h, neg_inf)

        lo = p - (m - 1)
        hi = p + (m - 1)
        full_in = (barange * block >= lo[:, None]) & ((barange + 1) * block - 1 <= hi[:, None])
        bwork = torch.where(alive[:, None] & full_in, neg_inf, bwork)
        for edge in (lo, hi):
            b_edge = torch.div(edge, block, rounding_mode="floor").clamp(0, nb - 1)
            mv, _ = masked_vals(b_edge, kept_pos)
            cur = bwork.gather(1, b_edge[:, None])[:, 0]
            upd = torch.where(alive, torch.minimum(cur, mv.amax(dim=1)), cur)
            bwork = torch.where(barange == b_edge[:, None], upd[:, None], bwork)
    overflow = (bwork > -math.inf).any(dim=1)
    return kept_pos, kept_h, overflow


_BLOCK = 512  # the JAX package's _TOPK_BLOCK


def greedy_survivors_blockwise(
    scored: torch.Tensor,  # (G, L) candidates at their height, else -inf
    min_distance: int,
    r_max: int,
    block: int = _BLOCK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact greedy-distance survivors for any raw candidate count, over a
    materialised (G, L) scored array: its block maxima seed
    :func:`greedy_survivors_from_blocks` and each round gathers its blocks
    from it. Same returns as that function."""
    g, l = scored.shape
    nb = -(-l // block)
    padded = torch.nn.functional.pad(scored, (0, nb * block - l), value=-math.inf)
    offs = torch.arange(block, device=scored.device)[None, :]

    def gather_block(b_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        starts = b_idx * block
        return slice_rows_windows(padded, starts[:, None], block)[:, 0, :], starts[:, None] + offs

    return greedy_survivors_from_blocks(
        padded.reshape(g, nb, block).amax(dim=2), gather_block, min_distance, r_max, block
    )


# ── Full tier: top-k capture and the lane greedy ──


def f32(value: float) -> float:
    """``value`` rounded to f32, as JAX rounds a Python float threshold
    against an f32 array."""
    return float(np.float32(value))


def topk_sparse(scored: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(height, pos), both (G, k): the k largest entries of each row of
    ``scored`` (non-candidates -inf), in (height descending, position
    ascending) order.

    The contract of the JAX ``topk_sparse``: whenever a row holds <= k
    finite entries, its finite lanes are bitwise ``lax.top_k``'s, which
    puts the lower index first among equal values. ``torch.topk`` promises
    no order for ties, so its lanes are re-sorted: by position, then by a
    stable descending sort on the height. Dead lanes (height -inf) carry
    unspecified positions; callers gate every use of ``pos`` on
    ``isfinite(height)``."""
    height, pos = torch.topk(scored, k, dim=1)
    order = torch.argsort(pos, dim=1)
    height, pos = height.gather(1, order), pos.gather(1, order)
    height, order = torch.sort(height, dim=1, descending=True, stable=True)
    return height, pos.gather(1, order)


def select_candidates(x: torch.Tensor, peak_mask: torch.Tensor, k: int) -> PeakCandidates:
    """Top-k candidates by height, ties to the lower index."""
    height, pos = topk_sparse(torch.where(peak_mask, x, -math.inf), k)
    return PeakCandidates(pos, height, torch.isfinite(height), peak_mask.sum(dim=1) > k)


# Above this lane count the (G, K, K) conflict matrix of the parallel
# filter outweighs the sequential loop (the JAX package's threshold).
PARALLEL_GREEDY_MAX_K = 2048

# ``loop(pred, body)``: run ``body()`` while the 0-d device bool ``pred``
# holds, ``body`` rewriting ``pred`` in place (``lax.while_loop``; on the
# device ``CudaGraphBackend.while_loop``, on the host :func:`host_loop`).
Loop = Callable[[torch.Tensor, Callable[[], None]], None]


def host_loop(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """The host's :data:`Loop`: one sync a pass, to read ``pred``."""
    while bool(pred):
        body()


def _greedy_distance_sequential(
    cand: PeakCandidates, min_distance: int, loop: "Loop | None" = None
) -> torch.Tensor:
    """Sequential greedy over height-sorted lanes. Each row's alive lanes
    are a prefix, so the loop runs ``while i < n_alive``, the bank-wide
    alive maximum, lane ``i`` selected by a device index; without ``loop``
    the host reads ``n_alive`` once and runs the body that many times.

    The state is one int32 array: a lane's position while it is alive and
    kept, SURVIVOR_POS_SENTINEL once it is dead or suppressed. A lane at the
    sentinel is near no real position, so a dropped lane ``i`` suppresses
    nothing, and a pass of the body is 8 kernels."""
    dev = cand.pos.device
    kept_pos = torch.where(cand.alive, cand.pos.to(torch.int32), SURVIVOR_POS_SENTINEL)
    n_alive = (cand.alive.sum(dim=1).amax() if cand.alive.numel()
               else torch.zeros((), dtype=torch.int64, device=dev))
    i = torch.zeros((), dtype=torch.int64, device=dev)
    go = i < n_alive

    def body() -> None:
        at = i.view(1)
        near = (kept_pos - kept_pos.index_select(1, at)).abs_() < min_distance
        near.index_fill_(1, at, False)
        kept_pos.masked_fill_(near, SURVIVOR_POS_SENTINEL)
        i.add_(1)
        torch.lt(i, n_alive, out=go)

    if loop is None:
        for _ in range(int(n_alive)):
            body()
    else:
        loop(go, body)
    return kept_pos != SURVIVOR_POS_SENTINEL


def _greedy_distance_parallel(
    cand: PeakCandidates, min_distance: int, loop: "Loop | None" = None
) -> torch.Tensor:
    """Parallel fixed point of the greedy recurrence: keep(c) = alive(c)
    and no higher-priority kept candidate within ``min_distance``,
    iterated from S = alive ``while changed``, S updated in place
    (``loop``, by default :func:`host_loop`)."""
    pos = cand.pos.to(torch.int32)
    k = pos.shape[1]
    lanes = torch.arange(k, device=pos.device)
    higher = lanes[None, :] < lanes[:, None]  # (K, K): j < i
    conflict = ((pos[:, :, None] - pos[:, None, :]).abs() < min_distance) & higher[None]
    conflict &= cand.alive[:, None, :]
    s = cand.alive & ~(conflict & cand.alive[:, None, :]).any(dim=2)
    changed = torch.ones((), dtype=torch.bool, device=pos.device)

    def body() -> None:
        s_new = cand.alive & ~(conflict & s[:, None, :]).any(dim=2)
        torch.any(s_new != s, out=changed)
        s.copy_(s_new)

    (loop or host_loop)(changed, body)
    return s & cand.alive


def greedy_distance_filter(
    cand: PeakCandidates, min_distance: int, loop: "Loop | None" = None
) -> torch.Tensor:
    """Greedy tallest-first suppression over height-sorted lanes (scipy's
    distance filter); the surviving-alive mask. ``loop`` as in the
    filters."""
    if cand.pos.shape[1] <= PARALLEL_GREEDY_MAX_K:
        return _greedy_distance_parallel(cand, min_distance, loop)
    return _greedy_distance_sequential(cand, min_distance, loop)


ValidLen = "int | torch.Tensor"  # one length for every row, or a (G,) integer tensor


def row_limit(valid_len: ValidLen) -> "int | torch.Tensor":
    """``valid_len`` as it compares against (G, K) positions: the int
    itself, or the per-row lengths as a (G, 1) column."""
    return valid_len[:, None] if isinstance(valid_len, torch.Tensor) else valid_len


def _masked(corr: torch.Tensor, valid_len: ValidLen) -> torch.Tensor:
    idx = torch.arange(corr.shape[1], device=corr.device)[None, :]
    return torch.where(idx < row_limit(valid_len), corr, -math.inf)


def find_peaks_device(
    corr: torch.Tensor,  # (G, L) normalised correlation, zeros >= valid_len
    valid_len: ValidLen,
    height_min: float,
    distance: int,
    k: int,
    loop: "Loop | None" = None,
) -> PeakCandidates:
    """find_peaks(height=height_min, distance=distance) over a bank, with
    -inf at and after ``valid_len`` (no run extends into the padding).
    ``loop`` as in :func:`greedy_distance_filter`."""
    x = _masked(corr, valid_len)
    mask = plateau_local_maxima_mask(x) & (x >= f32(height_min))
    cand = select_candidates(x, mask, k)
    keep = greedy_distance_filter(cand, distance, loop)
    return PeakCandidates(cand.pos, cand.height, keep, cand.overflow)


def find_peaks_device_fast(
    corr: torch.Tensor,
    valid_len: ValidLen,
    height_min: float,
    distance: int,
    k: int,
    loop: "Loop | None" = None,
) -> tuple[PeakCandidates, torch.Tensor]:
    """:func:`find_peaks_device` with the short-run mask when
    ``height_min > 0``, plus a per-row flag for an equal run of length
    >= 4 at or above the threshold (the one case where that mask could
    differ from scipy). ``height_min <= 0`` takes the general mask and
    never flags. ``loop`` as in :func:`greedy_distance_filter`."""
    if height_min <= 0:
        cand = find_peaks_device(corr, valid_len, height_min, distance, k, loop)
        return cand, torch.zeros(corr.shape[0], dtype=torch.bool, device=corr.device)
    hm = f32(height_min)
    x = _masked(corr, valid_len)
    cand = select_candidates(x, short_run_local_maxima_mask(x) & (x >= hm), k)
    keep = greedy_distance_filter(cand, distance, loop)
    return PeakCandidates(cand.pos, cand.height, keep, cand.overflow), long_plateau_present(x, hm)
