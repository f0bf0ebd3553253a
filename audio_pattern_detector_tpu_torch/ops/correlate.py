"""Bank-batched FFT cross-correlation (port of audio_pattern_detector_tpu/ops/correlate.py).

The section is transformed once, multiplied against the precomputed
conjugate bank spectra and inverse-transformed for the whole bank, in the
'full' correlation ordering (index k = lag + m - 1). Overlap-save splits
long sections into segments of ``fft_len`` shared by every group of a
sliding-window class. Spectra are held as complex64 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from numpy.typing import NDArray


def next_pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


@dataclass(frozen=True)
class CorrelationBankConsts:
    """Precomputed spectra for one clip group (uniform clip length m)."""

    bank_rfft_conj: torch.Tensor  # (G, fft_len//2 + 1) complex64
    self_corr_max: torch.Tensor  # (G,) f32
    clip_len: int  # m
    section_len: int  # S
    fft_len: int
    full_len: int  # L = S + m - 1
    num_segments: int = 1  # 1 = single-FFT mode
    step: int = 0  # 0 -> fft_len - clip_len + 1
    pad_left: int = -1  # -1 -> clip_len - 1
    out_offset: int = 0  # m_max - m under a class-shared geometry


def _overlap_save_geometry(section_len: int, m: int) -> tuple[int, int, int]:
    """(fft_len, step, num_segments) for overlap-save correlation."""
    fft_len = next_pow2(max(4 * m, 8192))
    whole = next_pow2(section_len + m - 1)
    if fft_len >= whole:
        return whole, 0, 1
    step = fft_len - m + 1
    full_len = section_len + m - 1
    num_segments = -(-full_len // step)
    return fft_len, step, num_segments


def class_overlap_save_geometry(
    section_len: int, clip_lens: list[int]
) -> "tuple[int, int, int, int] | None":
    """Shared (fft_len, step, num_segments, m_max) for one class's groups,
    or None when the single-FFT mode applies."""
    m_max = max(clip_lens)
    fft_len, step, num_segments = _overlap_save_geometry(section_len, m_max)
    if num_segments <= 1:
        return None
    return fft_len, step, num_segments, m_max


def build_correlation_bank(
    clips: NDArray[np.float32],  # (G, m) loudness-normalised clips
    self_corr_max: NDArray[np.floating],
    section_len: int,
    device: torch.device,
    shared_geometry: "tuple[int, int, int, int] | None" = None,
    overlap_save: bool = True,
) -> CorrelationBankConsts:
    """``overlap_save=False`` takes one full-length FFT whatever the
    section's length (the bank's ``APD_NO_OVERLAP_SAVE``)."""
    g, m = clips.shape
    step, pad_left, out_offset = 0, -1, 0
    if shared_geometry is not None and overlap_save:
        fft_len, step, num_segments, m_max = shared_geometry
        if m > m_max:
            raise ValueError(f"clip length {m} exceeds the class geometry's {m_max}")
        pad_left = m_max - 1
        out_offset = m_max - m
    elif overlap_save:
        fft_len, _, num_segments = _overlap_save_geometry(section_len, m)
    else:
        fft_len, num_segments = next_pow2(section_len + m - 1), 1
    bank = np.fft.rfft(clips.astype(np.float64), n=fft_len, axis=1).conj()
    return CorrelationBankConsts(
        bank_rfft_conj=torch.from_numpy(bank.astype(np.complex64)).to(device),
        self_corr_max=torch.from_numpy(
            np.asarray(self_corr_max, dtype=np.float32)
        ).to(device),
        clip_len=m,
        section_len=section_len,
        fft_len=fft_len,
        full_len=section_len + m - 1,
        num_segments=num_segments,
        step=step,
        pad_left=pad_left,
        out_offset=out_offset,
    )


def section_segment_spectra(
    section: torch.Tensor, consts: CorrelationBankConsts
) -> torch.Tensor:
    """rfft of the overlap-save segments of a section (S,) or a batch of
    sections (B, S): (..., ns, N//2+1) complex64."""
    n = consts.fft_len
    step = consts.step or (n - consts.clip_len + 1)
    pad_left = consts.pad_left if consts.pad_left >= 0 else consts.clip_len - 1
    ns = consts.num_segments
    padded = F.pad(section, (pad_left, ns * step + n - (section.shape[-1] + pad_left)))
    segments = padded.unfold(-1, n, step)[..., :ns, :]
    return torch.fft.rfft(segments)


def _correlate_raw(
    section: torch.Tensor,
    consts: CorrelationBankConsts,
    seg_spec: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """|full cross-correlation|, unnormalised: (G, L) for a section (S,),
    (B, G, L) for a batch (B, S)."""
    m, n, l = consts.clip_len, consts.fft_len, consts.full_len
    if consts.num_segments == 1:
        spec = torch.fft.rfft(section, n=n)
        z = torch.fft.irfft(spec[..., None, :] * consts.bank_rfft_conj, n=n)
        return torch.roll(z, m - 1, dims=-1)[..., :l].abs()
    step = consts.step or (n - m + 1)
    ns = consts.num_segments
    if seg_spec is None:
        seg_spec = section_segment_spectra(section, consts)
    y = torch.fft.irfft(
        seg_spec[..., None, :, :] * consts.bank_rfft_conj[:, None, :], n=n
    )  # (..., G, ns, N)
    flat = y[..., :step].reshape(*y.shape[:-2], ns * step)
    off = consts.out_offset
    return flat[..., off : off + l].abs()


def bank_correlate(
    section: torch.Tensor,  # (S,) or (B, S) f32 normalised, zero-padded
    n_valid: "int | torch.Tensor",  # int, or (B,) with a batch
    consts: CorrelationBankConsts,
    seg_spec: "torch.Tensor | None" = None,
) -> "tuple[torch.Tensor, int | torch.Tensor]":
    """(corr, valid_len): |correlation| normalised by max(self_corr_max,
    observed max), zeroed at positions >= valid_len = n_valid + m - 1."""
    corr = _correlate_raw(section, consts, seg_spec)
    valid_len = n_valid + consts.clip_len - 1
    lim = valid_len[:, None, None] if isinstance(valid_len, torch.Tensor) else valid_len
    in_range = torch.arange(consts.full_len, device=corr.device) < lim
    corr = torch.where(in_range, corr, 0.0)
    denom = torch.maximum(consts.self_corr_max, corr.amax(dim=-1))
    return corr / denom.clamp_min(1e-38)[..., None], valid_len


def bank_correlate_abs(
    section: torch.Tensor,
    n_valid: "int | torch.Tensor",
    consts: CorrelationBankConsts,
    seg_spec: "torch.Tensor | None" = None,
) -> "tuple[torch.Tensor, int | torch.Tensor]":
    """(|correlation|, valid_len) with no normalising pass: the candidate
    scan derives the observed max itself (ops/candidate_scan.py)."""
    return _correlate_raw(section, consts, seg_spec), n_valid + consts.clip_len - 1
