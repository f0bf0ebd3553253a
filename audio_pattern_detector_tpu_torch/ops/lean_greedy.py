"""The lean tier's block-wise greedy survivors: CUDA kernel and plain version.

Counterpart of the JAX package's lean greedy, ``ops/peaks.py::
greedy_survivors_from_blocks`` with the window gather of
``models/bank.py::_lean_group_packed_pallas`` (``gather_scored``), which XLA
compiles into the class step's program. From the candidate scan's block
maxima of raw |correlation| and each row's normaliser:

* ``bwork0 = where(bmax / denom >= hm, bmax / denom, -inf)``;
* up to ``r_max`` rounds of the exact greedy: the block argmax, the
  candidate mask re-derived on a +-2-halo window of 516 samples in quotient
  space (``corr / denom``, -inf at and past ``valid_len``), suppression
  against the kept lanes, the in-block argmax (ties to the lower index in
  both), a refusal when the gathered maximum is not the seed, the drop of
  fully suppressed blocks and the recomputed edge blocks.

Returns ``pos`` (G, r_max) int64 (``SURVIVOR_POS_SENTINEL`` past each row's
survivors), ``height`` (G, r_max) f32 (-inf past them) and ``overflow``
(G,) bool (a candidate left after the rounds).

:func:`lean_greedy` launches ``csrc/lean_greedy.cu`` for CUDA tensors (one
launch a group, one CTA a row, each row ending with its own candidates; a
round copies its seed window and its edge blocks' windows together and
waits on device memory once, and reads its seed from a maximum per 32
blocks)
and runs :func:`lean_greedy_reference` for CPU tensors; it never falls back
from one to the other. The plain version keeps both JAX forms of the
rounds (a while loop through ``loop``, else ``r_max`` unrolled rounds),
which give identical results and so one kernel. Every output is an integer, a mask or a
quotient rounded as IEEE division, so the kernel and its plain version are
held to bitwise equality.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops.devices import device_guard
from audio_pattern_detector_tpu_torch.ops.loops import Loop
from audio_pattern_detector_tpu_torch.ops.peaks import (
    ValidLen,
    greedy_survivors_from_blocks,
    plateau_run_mask,
    row_limit,
)
from audio_pattern_detector_tpu_torch.ops.slicing import slice_rows_windows

BLOCK = 512  # the candidate scan's block
WINDOW = BLOCK + 4  # a block and a 2-sample halo a side

# Dynamic shared memory the kernel may take (csrc/lean_greedy.cu: the
# 227 KB of a block less its static shared memory, five windows and the
# reductions).
_MAX_SMEM = 232448 - 12288
GROUP = 32  # blocks under one entry of the kernel's second-level maxima

GreedyOutputs = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def lean_greedy_reference(
    corr: torch.Tensor,  # (G, L) raw |correlation|
    valid_len: ValidLen,
    bmax: torch.Tensor,  # (G, ceil(L/512)) block maxima of the scan
    denom: torch.Tensor,  # (G,) f32 normaliser
    hm: float,  # f32 height threshold in quotient space
    min_distance: int,
    r_max: int,
    loop: "Loop | None" = None,
) -> GreedyOutputs:
    """The kernel's function in plain torch ops (any device). ``loop`` runs
    the rounds as a while loop (``greedy_survivors_from_blocks``); without
    it they are unrolled."""
    g, l = corr.shape
    dev = corr.device
    lim = row_limit(valid_len)
    neg_inf = torch.full((), -math.inf, device=dev)
    qb = bmax / denom[:, None]
    bwork0 = torch.where(qb >= hm, qb, neg_inf)

    w = WINDOW
    corr_w = F.pad(corr, (0, w - l)) if l < w else corr  # windows must fit the row
    woffs = torch.arange(w, device=dev)[None, :]
    neg1 = torch.full((g, 1), -math.inf, device=dev)
    neg2 = torch.full((g, 2), -math.inf, device=dev)

    def gather_scored(b_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        start = (b_idx * BLOCK - 2).clamp(0, max(l - w, 0))
        xw = slice_rows_windows(corr_w, start[:, None], w)[:, 0, :]
        c = start[:, None] + woffs  # global positions, ascending
        xq = torch.where(c < lim, xw / denom[:, None], neg_inf)
        xm1 = torch.cat([neg1, xq[:, :-1]], dim=1)
        xm2 = torch.cat([neg2, xq[:, :-2]], dim=1)
        xp1 = torch.cat([xq[:, 1:], neg1], dim=1)
        xp2 = torch.cat([xq[:, 2:], neg2], dim=1)
        runs = plateau_run_mask(
            xq, xm2, xm1, xp1, xp2, torch.isfinite(xp1), torch.isfinite(xp2), left_ok=c > 1
        )
        lo = b_idx[:, None] * BLOCK
        mask = runs & (c >= lo) & (c < lo + BLOCK) & (c > 0) & torch.isfinite(xq) & (xq >= hm)
        return torch.where(mask, xq, neg_inf), c

    return greedy_survivors_from_blocks(bwork0, gather_scored, min_distance, r_max, BLOCK, loop)


def _launch(corr, valid_len, bmax, denom, hm, min_distance, r_max) -> GreedyOutputs:
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    if corr.dtype != torch.float32 or corr.dim() != 2 or not corr.is_contiguous():
        raise ValueError("lean_greedy: corr must be a contiguous (G, L) float32 tensor")
    g, l = corr.shape
    nb = -(-l // BLOCK)
    dev = corr.device
    for name, t, shape in (("bmax", bmax, (g, nb)), ("denom", denom, (g,))):
        if (t.shape != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"lean_greedy: {name} must be a contiguous {shape} float32 tensor on corr's device")
    if l >= 2**31 or g >= 2**31 or not 0 <= min_distance < 2**31 or not 0 <= r_max < 2**31:
        raise ValueError(f"lean_greedy: shape ({g}, {l}), min_distance {min_distance} or "
                         f"r_max {r_max} outside int32")
    if isinstance(valid_len, torch.Tensor):
        if (valid_len.shape != (g,) or valid_len.dtype != torch.int32
                or valid_len.device != dev or not valid_len.is_contiguous()):
            raise ValueError("lean_greedy: a per-row valid_len must be a contiguous (G,) int32 "
                             "tensor on corr's device")
        lens_ptr, scalar = valid_len.data_ptr(), 0
    elif 0 <= valid_len <= l:
        lens_ptr, scalar = None, int(valid_len)
    else:
        raise ValueError(f"lean_greedy: valid_len {valid_len} outside [0, {l}]")
    smem = r_max * 12 + nb * 4 + -(-nb // GROUP) * 8
    if smem > _MAX_SMEM:
        raise ValueError(f"lean_greedy: {nb} blocks and {r_max} lanes need {smem} bytes of "
                         f"shared memory, past the {_MAX_SMEM} a block may take")
    lib = load_kernels().lib
    with device_guard(dev):
        pos = torch.empty((g, r_max), dtype=torch.int64, device=dev)
        height = torch.empty((g, r_max), dtype=torch.float32, device=dev)
        overflow = torch.empty((g,), dtype=torch.bool, device=dev)
        if g == 0:
            return pos, height, overflow
        err = lib.apd_lean_greedy(
            corr.data_ptr(), lens_ptr, g, l, scalar, bmax.data_ptr(), nb, denom.data_ptr(),
            float(hm), min_distance, r_max, pos.data_ptr(), height.data_ptr(),
            overflow.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lean_greedy kernel launch failed: CUDA error {err}")
    lean_greedy.launches += 1
    return pos, height, overflow


def lean_greedy(
    corr: torch.Tensor,  # (G, L) raw |correlation|
    valid_len: ValidLen,  # an int, or a (G,) int32 tensor of per-row lengths
    bmax: torch.Tensor,
    denom: torch.Tensor,
    hm: float,
    min_distance: int,
    r_max: int,
    loop: "Loop | None" = None,
) -> GreedyOutputs:
    """(pos, height, overflow): the CUDA kernel for CUDA tensors (``loop``
    is not needed there: every round runs in the one launch), the plain
    version with ``loop`` for CPU tensors."""
    if corr.device.type == "cuda":
        return _launch(corr, valid_len, bmax, denom, hm, int(min_distance), int(r_max))
    if corr.device.type == "cpu":
        return lean_greedy_reference(corr, valid_len, bmax, denom, hm, min_distance, r_max, loop)
    raise ValueError(f"lean_greedy: unsupported device {corr.device}")


# Kernels the card ran: one per launch of the wrapper, and for each replay
# of a captured class step the launches its graph holds
# (models/captured.py). The plain version counts nothing.
lean_greedy.launches = 0
