"""The normal (and short-clip) verifier: CUDA kernel and plain version.

Counterpart of the JAX package's ``ops/verify.py::verify_normal`` (with
``_pearson_batched``), which XLA fuses into the class step's program. For
each lane (r, k) of (R, K), row r against clip r % G (rows round-major,
R = B * G): the zero-padded correlation window of 2m - 1 samples around
``pos``, renormalised by its maximum (after ``normalise``'s divisor, when
given), the 10-partition MSE against the clip's self-correlation, the
window maxima of the centre window's bins and their Pearson r against the
clip's downsampled window. Returns (accept, similarity, pearson_r), each
(R, K).

:func:`verify_normal` launches ``csrc/verify_normal.cu`` for CUDA tensors,
one launch a call, and runs :func:`verify_normal_reference` for CPU
tensors; it never falls back from one to the other. The kernel computes
only live lanes: a dead lane's accept is False and its similarity and r are
NaN (the plain version computes them for every lane). On live lanes the
accept bits are equal, and similarity and r agree within
:data:`SIM_RTOL` / :data:`R_ATOL`: the element values are bitwise the plain
version's, the sums are taken in another order (the kernel's header states
its order; ``tests/test_torch_verify_kernels.py`` transliterates it).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops.devices import device_guard

if TYPE_CHECKING:
    from audio_pattern_detector_tpu_torch.ops.verify import NormalVerifyConsts

# f32-rounded thresholds: the comparisons then agree with JAX's f32
# compares whichever precision torch computes a scalar compare in.
SIMILARITY_HARD_LIMIT = float(np.float32(0.02))
PEARSON_R_THRESHOLD = float(np.float32(0.90))
WINDOW_PAD = 8  # slack covering the +-5 candidate bound overshoot (both verifiers)

# How far the kernel's similarity and r may lie from the plain version's
# on a live lane: the f32 rounding of sums of up to 10^5 terms taken in
# another order (relative, of the similarity), and of the Pearson moments'
# cancellation over 101-505 bins (absolute, of r).
SIM_RTOL = 1e-5
R_ATOL = 1e-5

# Shared memory the kernel's bin maxima take: ds_n floats, within the
# 48 KB a block has without opting in.
_MAX_DS_N = 48 * 1024 // 4


def _pearson_batched(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson r along the last axis; 0 where either side has no variance."""
    dx = x - x.mean(dim=-1, keepdim=True)
    dy = y - y.mean(dim=-1, keepdim=True)
    cov = (dx * dy).sum(dim=-1)
    denom = torch.sqrt((dx * dx).sum(dim=-1) * (dy * dy).sum(dim=-1))
    return torch.where(denom > 0.0, cov / denom.clamp_min(1e-38), 0.0)


Normalise = "tuple[int | torch.Tensor, torch.Tensor] | None"


def verify_normal_reference(
    corr: torch.Tensor,  # (R, L) normalised correlation, zeros >= valid_len
    pos: torch.Tensor,  # (R, K) candidate 'full' indices
    alive: torch.Tensor,  # (R, K) bool
    consts: "NormalVerifyConsts",
    normalise: Normalise = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops (any device), for every
    lane.

    Each lane's window of the row zero-padded on both sides is gathered
    from the row itself, with no padded copy in memory. ``normalise`` =
    (valid_len, denom) takes ``corr`` as raw |corr| and normalises only
    the windows read: zero at and past each row's ``valid_len`` (an int or
    an (R,) tensor), divided by the row's ``denom``, bitwise the values of
    the whole row normalised so."""
    r_rows, k = pos.shape
    g = consts.ds_clip.shape[0]
    lead = (r_rows // g, g, k)  # the per-clip constants broadcast over B and K
    m, lc, ps = consts.clip_len, consts.corr_len, consts.partition_size

    front = WINDOW_PAD + m - 1  # zeros before the row; WINDOW_PAD + m after it
    l = corr.shape[1]
    start = (pos - (m - 1) + front).clamp(0, l + front + WINDOW_PAD + m - lc)
    valid_len, denom = (l, None) if normalise is None else normalise
    idx = (start - front)[..., None] + torch.arange(lc, device=corr.device)  # (R, K, lc)
    limit = valid_len[:, None, None] if isinstance(valid_len, torch.Tensor) else valid_len
    outside = (idx < 0) | (idx >= l) | (idx >= limit)
    # In place where it can be: these (R, K, lc) arrays are the verify's
    # largest.
    slices = torch.gather(corr[:, None, :].expand(r_rows, k, l), 2, idx.clamp_(0, l - 1))
    slices.masked_fill_(outside, 0.0)
    if denom is not None:
        slices.div_(denom[:, None, None])
    slices = slices / slices.amax(dim=-1, keepdim=True).clamp_min(1e-38)

    diffs = slices[:, :, : 10 * ps].reshape(*lead, 10, ps) - consts.corr_clip_partitions[:, None]
    mse = (diffs * diffs).mean(dim=-1)  # (B, G, K, 10)
    sim_whole = mse.mean(dim=-1)
    sim = sim_whole if consts.is_short else torch.minimum(sim_whole, mse[..., 4:6].mean(dim=-1))

    window = slices[:, :, consts.win_lo : consts.win_hi]  # (R, K, n)
    n = window.shape[-1]
    win = 1 << consts.k_level
    f = F.max_pool1d(window.reshape(r_rows * k, 1, n), kernel_size=win, stride=1)
    f = f.reshape(*lead, n - win + 1)  # seg_a / seg_b index only this valid range
    ds_slice = torch.maximum(f[..., consts.seg_a], f[..., consts.seg_b])  # (B, G, K, ds_n)
    r = _pearson_batched(ds_slice, consts.ds_clip[:, None, :]).reshape(r_rows, k)
    sim = sim.reshape(r_rows, k)

    accept = alive & (sim <= SIMILARITY_HARD_LIMIT) & (r >= PEARSON_R_THRESHOLD)
    return accept, sim, r


def check_operand(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
                  device: torch.device, kernel: str = "verify_normal") -> None:
    """Raise unless ``t`` is a contiguous tensor of that shape, type and
    device: what a verify kernel's pointers assume (both verifiers')."""
    if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{kernel}: {name} must be a contiguous {shape} {dtype} tensor on "
                         f"{device}")


def _launch(corr: torch.Tensor, pos: torch.Tensor, alive: torch.Tensor,
            consts: "NormalVerifyConsts", normalise: Normalise):
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    if corr.dtype != torch.float32 or corr.dim() != 2 or not corr.is_contiguous():
        raise ValueError("verify_normal: corr must be a contiguous (R, L) float32 tensor")
    dev = corr.device
    r_rows, l = corr.shape
    if pos.dim() != 2 or pos.shape[0] != r_rows:
        raise ValueError(f"verify_normal: pos must be (R, K) with R = {r_rows}")
    # A block of lanes (the two-tier verify's) is a column slice: copied
    # to its own rows, a few bytes a lane.
    pos, alive = pos.contiguous(), alive.contiguous()
    k = pos.shape[1]
    check_operand("pos", pos, (r_rows, k), torch.int64, dev)
    check_operand("alive", alive, (r_rows, k), torch.bool, dev)
    g, ds_n = consts.ds_clip.shape
    m, ps = consts.clip_len, consts.partition_size
    if r_rows % g:
        raise ValueError(f"verify_normal: {r_rows} rows are not whole rounds of {g} clips")
    check_operand("corr_clip_partitions", consts.corr_clip_partitions, (g, 10, ps),
                  torch.float32, dev)
    check_operand("ds_clip", consts.ds_clip, (g, ds_n), torch.float32, dev)
    check_operand("seg_a", consts.seg_a, (ds_n,), torch.int64, dev)
    check_operand("seg_b", consts.seg_b, (ds_n,), torch.int64, dev)
    if ds_n > _MAX_DS_N:
        raise ValueError(f"verify_normal: {ds_n} bins need {ds_n * 4} bytes of shared memory, "
                         f"past the {_MAX_DS_N * 4} the kernel takes")
    if consts.corr_len >= 2**31 or k >= 2**31 or g >= 2**31:
        raise ValueError(f"verify_normal: a window of {consts.corr_len} samples or {k} lanes "
                         "outside int32")
    lens_ptr, scalar, denom_ptr = None, l, None
    if normalise is not None:
        valid_len, denom = normalise
        check_operand("denom", denom, (r_rows,), torch.float32, dev)
        denom_ptr = denom.data_ptr()
        if isinstance(valid_len, torch.Tensor):
            check_operand("a per-row valid_len", valid_len, (r_rows,), torch.int32, dev)
            lens_ptr = valid_len.data_ptr()
        else:
            scalar = int(valid_len)
    lib = load_kernels().lib
    with device_guard(dev):
        accept = torch.empty((r_rows, k), dtype=torch.bool, device=dev)
        sim = torch.empty((r_rows, k), dtype=torch.float32, device=dev)
        r = torch.empty((r_rows, k), dtype=torch.float32, device=dev)
        if r_rows == 0 or k == 0:
            return accept, sim, r
        err = lib.apd_verify_normal(
            corr.data_ptr(), r_rows, l, lens_ptr, scalar, denom_ptr, pos.data_ptr(),
            alive.data_ptr(), k, g, m, ps, consts.corr_clip_partitions.data_ptr(),
            consts.ds_clip.data_ptr(), consts.seg_a.data_ptr(), consts.seg_b.data_ptr(),
            consts.win_lo, ds_n, consts.k_level, int(consts.is_short), SIMILARITY_HARD_LIMIT,
            PEARSON_R_THRESHOLD, accept.data_ptr(), sim.data_ptr(), r.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"verify_normal kernel launch failed: CUDA error {err}")
    verify_normal.launches += 1
    return accept, sim, r


def verify_normal(
    corr: torch.Tensor,  # (R, L) normalised correlation, zeros >= valid_len
    pos: torch.Tensor,  # (R, K) candidate 'full' indices
    alive: torch.Tensor,  # (R, K) bool
    consts: "NormalVerifyConsts",
    normalise: Normalise = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (accept, similarity, pearson_r), each (R, K): the CUDA
    kernel for CUDA tensors (similarity and r NaN on dead lanes), the plain
    version for CPU tensors. The rows are the group's G clips, or B rounds
    of them (R = B * G, round-major): row r is held against the constants
    of clip r % G. ``normalise`` as in :func:`verify_normal_reference`."""
    if corr.device.type == "cuda":
        return _launch(corr, pos, alive, consts, normalise)
    if corr.device.type == "cpu":
        return verify_normal_reference(corr, pos, alive, consts, normalise)
    raise ValueError(f"verify_normal: unsupported device {corr.device}")


# Kernels the card ran: one per launch of the wrapper, and for each replay
# of a captured class step the launches its graph holds, a conditional
# body's only where the body ran (models/captured.py). The plain version
# counts nothing.
verify_normal.launches = 0
