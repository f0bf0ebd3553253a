"""BS.1770 loudness and normalisation (port of audio_pattern_detector_tpu/ops/loudness.py).

K-weighting is an overlap-save FFT convolution against the truncated
impulse response ``hostref.k_weighting_fir`` (f64 on the host); gating
blocks are fixed windows masked to the valid length. The host tables,
including ``block_thr`` (the f64 block count as thresholds), come from
the same numpy expressions as the JAX package's, so the gating geometry
is bitwise shared.

Every function takes one section ``(S,)`` with a host integer ``n_valid``
(the short/gated choice is then a Python branch) or a batch ``(B, S)`` with
a ``(B,)`` integer tensor of lengths on the section's device (both forms
are computed and selected per row, with no host sync).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops import hostref
from audio_pattern_detector_tpu_torch.ops.correlate import next_pow2
from audio_pattern_detector_tpu_torch.ops.peaks import row_limit
from audio_pattern_detector_tpu_torch.ops.slicing import slice_shared_windows

LUFS_OFFSET = -0.691
ABSOLUTE_GATE_LUFS = -70.0
DEFAULT_TARGET_LUFS = -16.0
_FIR_TAPS = 4096


@dataclass(frozen=True)
class LoudnessConsts:
    """Host-precomputed constants for a (section_len, sample_rate) pair."""

    fir_spec: torch.Tensor  # (fft_len//2 + 1,) complex64
    block_lo: torch.Tensor  # (max_blocks,) int64 block starts
    block_end: torch.Tensor  # (max_blocks,) int64 block ends (pre-clamp)
    # block_thr[j]: smallest n with hostref.num_gating_blocks(n) >= j + 1.
    block_thr: torch.Tensor  # (max_blocks,) int64
    section_len: int
    sample_rate: int
    fft_len: int
    window_width: int  # >= max block width
    short_threshold: int  # single-block path below
    num_segments: int = 1  # overlap-save convolution segments


def build_loudness_consts(
    section_len: int, sample_rate: int, device: torch.device, overlap_save: bool = True
) -> LoudnessConsts:
    """``overlap_save=False`` convolves in one full-length FFT (the bank's
    ``APD_NO_OVERLAP_SAVE``)."""
    rate = float(sample_rate)
    t_g = 0.4
    fir = hostref.k_weighting_fir(rate, _FIR_TAPS)
    whole = next_pow2(section_len + _FIR_TAPS - 1)
    fft_len = next_pow2(4 * _FIR_TAPS)
    if fft_len >= whole or not overlap_save:
        fft_len, num_segments = whole, 1
    else:
        num_segments = -(-section_len // (fft_len - _FIR_TAPS + 1))
    spec = np.fft.rfft(fir, fft_len).astype(np.complex64)

    max_blocks = max(hostref.num_gating_blocks(section_len, rate, t_g), 1)
    window_samples = t_g * rate
    hop_samples = window_samples * 0.25
    j = np.arange(max_blocks, dtype=np.float64)
    lo = (j * hop_samples).astype(np.int64)
    end = (j * hop_samples + window_samples).astype(np.int64)
    block_thr = np.empty(max_blocks, dtype=np.int64)
    for k in range(max_blocks):
        n = max(int((0.1 * (k - 0.5) + t_g) * rate) - 8, 0)
        while hostref.num_gating_blocks(n, rate, t_g) < k + 1:
            n += 1
        block_thr[k] = n

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return LoudnessConsts(
        fir_spec=dev(spec),
        block_lo=dev(lo),
        block_end=dev(end),
        block_thr=dev(block_thr),
        section_len=section_len,
        sample_rate=sample_rate,
        fft_len=fft_len,
        window_width=int((end - lo).max()),
        short_threshold=int(math.ceil(0.5 * sample_rate)),
        num_segments=num_segments,
    )


def _k_weighted_conv(section: torch.Tensor, consts: LoudnessConsts) -> torch.Tensor:
    """K-weighting FIR convolution along the last axis, whole-signal or
    overlap-save."""
    s, n = consts.section_len, consts.fft_len
    if consts.num_segments == 1:
        spec = torch.fft.rfft(section, n=n)
        return torch.fft.irfft(spec * consts.fir_spec, n=n)[..., :s]
    taps = _FIR_TAPS
    step = n - taps + 1
    ns = consts.num_segments
    padded = F.pad(section, (taps - 1, ns * step + n - (s + taps - 1)))
    segments = padded.unfold(-1, n, step)[..., :ns, :]
    z = torch.fft.irfft(torch.fft.rfft(segments) * consts.fir_spec, n=n)
    return z[..., taps - 1 :].reshape(*section.shape[:-1], ns * step)[..., :s]


def _lufs(ms: torch.Tensor) -> torch.Tensor:
    return LUFS_OFFSET + 10.0 * torch.log10(ms)


def integrated_loudness_device(
    section: torch.Tensor, n_valid: "int | torch.Tensor", consts: LoudnessConsts
) -> torch.Tensor:
    """Gated integrated loudness (f32 LUFS; -inf for silence) of
    ``section[..., :n_valid]``: 0-d for one section, (B,) for a batch.
    Samples at and beyond ``n_valid`` must be zero."""
    s = consts.section_len
    dev = section.device
    batched = isinstance(n_valid, torch.Tensor)
    lim = row_limit(n_valid)  # against the last axis
    filtered = _k_weighted_conv(section, consts)
    idx = torch.arange(s, device=dev)
    sq = torch.where(idx < lim, filtered * filtered, 0.0)
    neg_inf = torch.full((), -math.inf, device=dev)

    short = None
    if batched or n_valid < consts.short_threshold:
        # One gating block spanning the whole signal
        # (reference: audio_pattern_detector.py:416-418).
        n = n_valid.clamp_min(1).to(torch.float32) if batched else float(max(n_valid, 1))
        ms = sq.sum(dim=-1) / n
        lufs = torch.where(ms > 0.0, _lufs(ms), neg_inf)
        short = torch.where(lufs >= ABSOLUTE_GATE_LUFS, lufs, neg_inf)
        if not batched:
            return short

    nblk = consts.block_lo.shape[0]
    w = consts.window_width
    num_blocks = (consts.block_thr <= lim).sum(dim=-1, keepdim=True)
    hi = consts.block_end.clamp(max=lim)  # (nblk,) or (B, nblk)
    starts = consts.block_lo.clamp_max(s - 1)
    gathered = slice_shared_windows(F.pad(sq, (0, w)), starts, w)  # (..., nblk, W)
    win_idx = starts[:, None] + torch.arange(w, device=dev)[None, :]
    block_sum = torch.where(win_idx < hi[..., None], gathered, 0.0).sum(dim=-1)
    count = (hi - consts.block_lo).to(torch.float32)
    block_valid = (
        (torch.arange(nblk, device=dev) < num_blocks)
        & (consts.block_lo < hi)
        & (block_sum > 0.0)
    )
    ms = block_sum / count.clamp_min(1.0)
    loud = _lufs(ms.clamp_min(1e-38))

    abs_mask = block_valid & (loud >= ABSOLUTE_GATE_LUFS)
    abs_count = abs_mask.sum(dim=-1)
    z_avg = torch.where(abs_mask, ms, 0.0).sum(dim=-1) / abs_count.clamp_min(1)
    gamma_r = _lufs(z_avg.clamp_min(1e-38)) - 10.0

    rel_mask = abs_mask & (loud > gamma_r[..., None])
    rel_count = rel_mask.sum(dim=-1)
    z_final = torch.where(rel_mask, ms, 0.0).sum(dim=-1) / rel_count.clamp_min(1)
    lufs = _lufs(z_final.clamp_min(1e-38))
    gated = torch.where((abs_count > 0) & (rel_count > 0), lufs, neg_inf)
    if batched:
        return torch.where(n_valid < consts.short_threshold, short, gated)
    return gated


def loudness_normalize_device(
    section: torch.Tensor,
    lufs: torch.Tensor,
    target_lufs: float = DEFAULT_TARGET_LUFS,
) -> torch.Tensor:
    """Gain to target LUFS, hard clip to [-1, 1], NaN scrubbed to zero
    (-inf loudness: non-zero samples saturate, zeros stay zero). ``lufs``
    is 0-d for one section or (B,) for a (B, S) batch."""
    gain = torch.pow(torch.full((), 10.0, device=section.device), (target_lufs - lufs) / 20.0)
    y = (section * gain[..., None]).clamp(-1.0, 1.0)
    return torch.where(torch.isnan(y), 0.0, y)
