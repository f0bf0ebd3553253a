"""Peak masks and the block-wise greedy distance filter
(port of the lean-path subset of audio_pattern_detector_tpu/ops/peaks.py).

No FFT and no float sum: every function here is bitwise equal to its JAX
counterpart on the same input. The greedy runs ``r_max`` statically
unrolled rounds (the JAX ``APD_GREEDY_UNROLL=1`` branch, identical
results); the while-loop exit test is not ported because in eager torch
it would cost a device-to-host sync every round.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch

SURVIVOR_POS_SENTINEL = 2**30  # dead survivor slots


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x[:, i + offset] with -inf beyond both ends (same shape as x)."""
    if offset == 0:
        return x
    pad = torch.full((x.shape[0], abs(offset)), -math.inf, dtype=x.dtype, device=x.device)
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
