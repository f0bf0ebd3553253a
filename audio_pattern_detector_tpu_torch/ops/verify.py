"""Step-2 verifiers (port of audio_pattern_detector_tpu/ops/verify.py).

Each clip group's candidates verify as one fixed-shape tensor program
over (bank, candidate); dead lanes are masked, never branched on.

* Normal path: zero-padded correlation slice around the peak,
  renormalised; 10-partition MSE against the clip's self-correlation;
  max-preserving downsample of the centre window and Pearson r against
  the downsampled clip window; accept iff similarity <= 0.02 and
  r >= 0.90.
* Marker-tone path: matched segment and both flanks as one 3m slice;
  whole-window Hann band purity per segment; 25 ms / 50 %-hop framed
  spectra over the matched segment with per-frame frequency lock and
  purity; six per-clip thresholds.

Per-clip static structure is built here, on the host in f64 with the same
numpy expressions as the JAX package. The two verifiers live beside their
CUDA kernels and are re-exported here: ``ops/verify_normal.py``
(``csrc/verify_normal.cu``) and ``ops/verify_marker.py`` (one fused kernel,
``csrc/verify_marker.cu``, that makes live lanes' spectra and decides; its
plain version takes the spectra from ``torch.fft`` or under
``APD_MARKER_GEMM=1`` the DFT-GEMM). Each launches its kernel for CUDA
tensors, under every switch, and runs its plain version for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.ops import hostref
from audio_pattern_detector_tpu_torch.ops.tone import frame_grid
from audio_pattern_detector_tpu_torch.ops.verify_marker import verify_marker  # noqa: F401
from audio_pattern_detector_tpu_torch.ops.verify_normal import verify_normal  # noqa: F401

# Default marker-tone thresholds (reference: audio_pattern_detector.py:698-705).
_MARKER_DEFAULTS = {
    "minimum_band_purity": 0.95,
    "minimum_active_frame_ratio": 0.80,
    "minimum_longest_active_run": 9,
    "minimum_active_frame_mean_purity": 0.92,
    "maximum_min_flank_purity": 0.25,
    "maximum_max_flank_purity": 0.65,
}


def _dev(a: NDArray, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


# ── Normal (MSE + Pearson) verifier ──────────────────────────────────


@dataclass(frozen=True)
class NormalVerifyConsts:
    """Static structure for the normal/short-clip verifier of one group."""

    corr_clip_partitions: torch.Tensor  # (G, 10, ps) f32
    ds_clip: torch.Tensor  # (G, ds_n) f32 host-downsampled clip window
    # Window-max resample as a sparse table: bin max = max(f[a], f[b]) with
    # f[i] = max over [i, i + 2^k_level).
    seg_a: torch.Tensor  # (ds_n,) int64
    seg_b: torch.Tensor  # (ds_n,) int64
    clip_len: int  # m
    corr_len: int  # 2m - 1
    is_short: bool
    partition_size: int  # corr_len // 10
    win_lo: int  # centre-window bounds (Python round)
    win_hi: int
    ds_n: int  # downsample target (101 normal / 505 short)
    k_level: int


def build_normal_verify_consts(
    correlation_clips: NDArray[np.float32],  # (G, 2m-1) normalised self-corr
    clip_len: int,
    sample_rate: int,
    device: torch.device,
) -> NormalVerifyConsts:
    g, lc = correlation_clips.shape
    if lc != 2 * clip_len - 1:
        raise ValueError(f"correlation clips have length {lc}, want {2 * clip_len - 1}")
    is_short = clip_len / sample_rate < 0.5
    ps = lc // 10
    ds_base = 101
    if is_short:
        wl, wr, ds_n = 0, 10, round(ds_base * 10 / 2)
    else:
        wl, wr, ds_n = 4, 6, ds_base
    lo = round(lc * wl / 10)
    hi = round(lc * wr / 10)
    ds_clip = np.stack(
        [hostref.resample_preserve_maxima(cc[lo:hi], ds_n) for cc in correlation_clips]
    )
    starts, ends = hostref.resample_preserve_maxima_bounds(hi - lo, ds_n)
    k_level = int(np.floor(np.log2(max(int((ends - starts).min()), 1))))
    return NormalVerifyConsts(
        corr_clip_partitions=_dev(
            correlation_clips[:, : 10 * ps].reshape(g, 10, ps), np.float32, device
        ),
        ds_clip=_dev(ds_clip, np.float32, device),
        seg_a=_dev(starts, np.int64, device),
        seg_b=_dev(ends - (1 << k_level), np.int64, device),
        clip_len=clip_len,
        corr_len=lc,
        is_short=is_short,
        partition_size=ps,
        win_lo=lo,
        win_hi=hi,
        ds_n=ds_n,
        k_level=k_level,
    )


# ── Marker-tone verifier ─────────────────────────────────────────────


@dataclass(frozen=True)
class MarkerVerifyConsts:
    """Static structure for the marker-tone verifier of one group."""

    hann_whole: torch.Tensor  # (m,) f32
    freqs_whole: torch.Tensor  # (m//2 + 1,) f32
    band_whole: torch.Tensor  # (G, m//2 + 1) bool
    dom_freq: torch.Tensor  # (G,) f32
    lock_hz: torch.Tensor  # (G,) f32
    hann_frame: torch.Tensor  # (wl,) f32
    freqs_frame: torch.Tensor  # (wl//2 + 1,) f32
    band_frame: torch.Tensor  # (G, wl//2 + 1) bool
    thresholds: torch.Tensor  # (G, 6) f32 ordered as _MARKER_DEFAULTS keys
    clip_len: int  # m
    sample_rate: int
    frame_len: int
    frame_count: int
    frame_starts: tuple  # (F,) static sample offsets


def build_marker_verify_consts(
    clip_len: int,
    sample_rate: int,
    dominant_frequencies: NDArray[np.float64],  # (G,)
    verification_params: "list[dict[str, float | int]]",  # per clip overrides
    device: torch.device,
) -> MarkerVerifyConsts:
    m = clip_len
    g = len(dominant_frequencies)
    dom = np.asarray(dominant_frequencies, dtype=np.float64)
    band_hz = np.maximum(40.0, dom * 0.08)
    lock_hz = np.maximum(20.0, dom * 0.04)
    freqs_whole = np.fft.rfftfreq(m, d=1.0 / sample_rate)
    band_whole = np.abs(freqs_whole[None, :] - dom[:, None]) <= band_hz[:, None]
    wl, hop, f_count = frame_grid(m, sample_rate)
    freqs_frame = np.fft.rfftfreq(wl, d=1.0 / sample_rate)
    band_frame = np.abs(freqs_frame[None, :] - dom[:, None]) <= band_hz[:, None]
    thresholds = np.empty((g, 6), dtype=np.float64)
    for i, params in enumerate(verification_params):
        v = params if isinstance(params, dict) else {}
        for j, key in enumerate(_MARKER_DEFAULTS):
            thresholds[i, j] = float(v.get(key, _MARKER_DEFAULTS[key]))
    return MarkerVerifyConsts(
        hann_whole=_dev(np.hanning(m), np.float32, device),
        freqs_whole=_dev(freqs_whole, np.float32, device),
        band_whole=_dev(band_whole, np.bool_, device),
        dom_freq=_dev(dom, np.float32, device),
        lock_hz=_dev(lock_hz, np.float32, device),
        hann_frame=_dev(np.hanning(wl), np.float32, device),
        freqs_frame=_dev(freqs_frame, np.float32, device),
        band_frame=_dev(band_frame, np.bool_, device),
        thresholds=_dev(thresholds, np.float32, device),
        clip_len=m,
        sample_rate=sample_rate,
        frame_len=wl,
        frame_count=f_count,
        frame_starts=tuple(int(s) for s in np.arange(f_count, dtype=np.int64) * hop),
    )
