"""Single-pass candidate scan of the lean tier: CUDA kernel and plain version.

Port of audio_pattern_detector_tpu/ops/pallas_peaks.py::candidate_scan.
The kernel (csrc/candidate_scan.cu) reads each |correlation| row once and
returns only per-block and per-row summaries:

* ``bmax`` (G, ceil(L/512)) f32: per-512-sample block max of the
  unthresholded plateau-midpoint local maxima (runs of length <= 3),
  -inf for blocks without one;
* ``count`` (G,) int32: those local maxima at or above ``thr_min``;
* ``plateau`` (G,) bool: an equal-value run of length >= 4 at or above
  ``thr_min``;
* ``omax`` (G,) f32: the observed max (floor 0);
* ``near`` (G,) bool: a sample at or above ``thr_min`` with a strictly
  unequal neighbour within 2 samples inside 8 ulp relative.

Everything at or past ``valid_len`` counts as -inf: one int for every
row (the scan schedule's class step), or a (G,) int32 tensor on corr's
device with one length per row (values clamp to [0, L]; the batched class
step, whose G is rounds times clips). ``thr_min`` is the
host-static lower bound ``height_min * self_corr_max`` of the true
threshold (see the JAX module's docstring for why that is sound).

:func:`candidate_scan` launches the kernel for CUDA tensors and runs
:func:`candidate_scan_reference` for CPU tensors; it never falls back
from one to the other. The outputs are bitwise deterministic (every
reduction is a max, an or or an integer sum), so the kernel and its plain
version are held to bitwise equality.
"""

from __future__ import annotations

import math

import torch

from audio_pattern_detector_tpu_torch.ops.devices import device_guard
from audio_pattern_detector_tpu_torch.ops.peaks import (
    ValidLen,
    _shift,
    plateau_run_mask,
    row_limit,
)

BLOCK = 512
_NEAR_TOL = 8.0 * 1.1920928955078125e-07  # 8 ulp at 1.0 (exact in f32)

ScanOutputs = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def num_blocks(length: int) -> int:
    return -(-length // BLOCK)


def candidate_scan_reference(
    corr: torch.Tensor, thr_min: torch.Tensor, valid_len: ValidLen
) -> ScanOutputs:
    """The kernel's function in plain torch ops (any device)."""
    g, l = corr.shape
    idx = torch.arange(l, device=corr.device)[None, :]
    x = torch.where(idx < row_limit(valid_len), corr, -math.inf)
    xm2, xm1 = _shift(x, -2), _shift(x, -1)
    xp1, xp2, xp3 = _shift(x, 1), _shift(x, 2), _shift(x, 3)
    finite = x != -math.inf
    runs = plateau_run_mask(
        x, xm2, xm1, xp1, xp2, xp1 != -math.inf, xp2 != -math.inf, left_ok=idx > 1
    )
    cand = runs & (idx > 0) & finite
    above = x >= thr_min[:, None]

    nb = num_blocks(l)
    scored = torch.where(cand, x, -math.inf)
    scored = torch.nn.functional.pad(scored, (0, nb * BLOCK - l), value=-math.inf)
    bmax = scored.reshape(g, nb, BLOCK).amax(dim=2)
    count = (cand & above).sum(dim=1, dtype=torch.int32)
    quad = (x == xp1) & (xp1 == xp2) & (xp2 == xp3) & above & finite
    omax = torch.where(finite, x, 0.0).amax(dim=1)
    tol = _NEAR_TOL * x
    pair_near = torch.zeros_like(finite)
    for n in (xm2, xm1, xp1, xp2):
        pair_near |= (n != x) & (n != -math.inf) & ((x - n).abs() <= tol)
    near = (above & finite & pair_near).any(dim=1)
    return bmax, count, quad.any(dim=1), omax, near


def _launch(corr: torch.Tensor, thr_min: torch.Tensor, valid_len: ValidLen) -> ScanOutputs:
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    if corr.dtype != torch.float32 or corr.dim() != 2 or not corr.is_contiguous():
        raise ValueError("candidate_scan: corr must be a contiguous (G, L) float32 tensor")
    g, l = corr.shape
    if thr_min.shape != (g,) or thr_min.dtype != torch.float32 or thr_min.device != corr.device:
        raise ValueError("candidate_scan: thr_min must be (G,) float32 on corr's device")
    # The kernel takes G, L and each length as int32 and forms every flat
    # offset (up to G * L) in 64 bits.
    if l >= 2**31 or g >= 2**31:
        raise ValueError(f"candidate_scan: shape ({g}, {l}) does not fit int32 extents")
    if isinstance(valid_len, torch.Tensor):
        if (
            valid_len.shape != (g,) or valid_len.dtype != torch.int32
            or valid_len.device != corr.device or not valid_len.is_contiguous()
        ):
            raise ValueError(
                "candidate_scan: a per-row valid_len must be a contiguous (G,) int32 "
                "tensor on corr's device"
            )
        lens_ptr, scalar = valid_len.data_ptr(), 0
    elif 0 <= valid_len <= l:
        lens_ptr, scalar = None, int(valid_len)
    else:
        raise ValueError(f"candidate_scan: valid_len {valid_len} outside [0, {l}]")
    lib = load_kernels().lib
    thr = thr_min.contiguous()
    nb = num_blocks(l)
    dev = corr.device
    # The C entry point launches on the process's current device (it reads
    # it with cudaGetDevice), so corr's device is made current around the
    # launch: a tensor on cuda:1 while cuda:0 is current must not launch
    # in cuda:0's context.
    with device_guard(dev):
        bmax = torch.empty((g, nb), dtype=torch.float32, device=dev)
        # The row stats, zeroed in one launch: count and omax bits (int32),
        # then plateau and near as bool bytes.
        stats = torch.zeros(3 * g, dtype=torch.int32, device=dev)
        flags = stats[2 * g :].view(torch.bool)
        ptr = stats.data_ptr()
        err = lib.apd_candidate_scan(
            corr.data_ptr(), thr.data_ptr(), lens_ptr, g, l, scalar, bmax.data_ptr(), nb,
            ptr, ptr + 4 * g, ptr + 8 * g, ptr + 9 * g,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"candidate_scan kernel launch failed: CUDA error {err}")
    candidate_scan.launches += 1
    return bmax, stats[:g], flags[:g], stats[g : 2 * g].view(torch.float32), flags[g : 2 * g]


def candidate_scan(
    corr: torch.Tensor,  # (G, L) |correlation|, unnormalised
    thr_min: torch.Tensor,  # (G,) f32
    valid_len: ValidLen,
) -> ScanOutputs:
    """(bmax, count, plateau, omax, near): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``valid_len`` is an int,
    or a (G,) int32 tensor of per-row lengths."""
    if corr.device.type == "cuda":
        return _launch(corr, thr_min, valid_len)
    if corr.device.type == "cpu":
        return candidate_scan_reference(corr, thr_min, valid_len)
    raise ValueError(f"candidate_scan: unsupported device {corr.device}")


# Kernels the card ran: one per launch of the wrapper, and for each replay
# of a captured class step the launches its graph holds
# (models/captured.py). The plain version counts nothing.
candidate_scan.launches = 0
