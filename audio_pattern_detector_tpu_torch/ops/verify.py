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

Per-clip static structure is built on the host in f64 with the same
numpy expressions as the JAX package. Spectra come from ``torch.fft``, or,
under ``APD_MARKER_GEMM=1``, the marker verifier's power spectra come from
one real-DFT matrix product each (the JAX package's DFT-GEMM, on by default
only on a TPU, so off here). The port reads the variable at each call; the
JAX package reads it when it traces.
"""

from __future__ import annotations

import contextlib
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.ops import hostref
from audio_pattern_detector_tpu_torch.ops.tone import frame_grid
from audio_pattern_detector_tpu_torch.ops.slicing import slice_rows_windows

# f32-rounded thresholds: the comparisons then agree with JAX's f32
# compares whichever precision torch computes a scalar compare in.
SIMILARITY_HARD_LIMIT = float(np.float32(0.02))
PEARSON_R_THRESHOLD = float(np.float32(0.90))
_PAD = 8  # slack covering the +-5 candidate bound overshoot

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


def _pearson_batched(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson r along the last axis; 0 where either side has no variance."""
    dx = x - x.mean(dim=-1, keepdim=True)
    dy = y - y.mean(dim=-1, keepdim=True)
    cov = (dx * dy).sum(dim=-1)
    denom = torch.sqrt((dx * dx).sum(dim=-1) * (dy * dy).sum(dim=-1))
    return torch.where(denom > 0.0, cov / denom.clamp_min(1e-38), 0.0)


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


def verify_normal(
    corr: torch.Tensor,  # (R, L) normalised correlation, zeros >= valid_len
    pos: torch.Tensor,  # (R, K) candidate 'full' indices
    alive: torch.Tensor,  # (R, K) bool
    consts: NormalVerifyConsts,
    normalise: "tuple[int | torch.Tensor, torch.Tensor] | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (accept, similarity, pearson_r), each (R, K). The rows are
    the group's G clips, or B rounds of them (R = B * G, round-major): row
    r is held against the constants of clip r % G.

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

    front = _PAD + m - 1  # zeros before the row; _PAD + m after it
    l = corr.shape[1]
    start = (pos - (m - 1) + front).clamp(0, l + front + _PAD + m - lc)
    valid_len, denom = (l, None) if normalise is None else normalise
    idx = (start - front)[..., None] + torch.arange(lc, device=corr.device)  # (R, K, lc)
    limit = valid_len[:, None, None] if isinstance(valid_len, torch.Tensor) else valid_len
    outside = (idx < 0) | (idx >= l) | (idx >= limit)
    # In place where it can be: these (R, K, lc) arrays are the verify's
    # largest, and a captured body keeps their peak in its pool.
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


# The DFT-GEMM runs only up to this transform length: its (n, n + 2)
# matrix grows quadratically (67 MB at 4,096).
_GEMM_MAX_N = 4096


# The DFT matrices that captured CUDA graphs read (models/captured.py): a
# graph holds the matrix's address, so a matrix read while a graph is
# captured stays here for the life of the process, whatever the cache below
# evicts.
_CAPTURED_DFT: dict[tuple[int, torch.device], torch.Tensor] = {}


@functools.lru_cache(maxsize=16)
def _dft_matrix(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2F) f32 [cos | sin] real-DFT matrix, F = n // 2 + 1, built in
    f64 with the JAX package's expression."""
    f = n // 2 + 1
    idx = np.arange(n, dtype=np.float64)[:, None] * np.arange(f, dtype=np.float64)
    ang = -2.0 * np.pi * idx / n
    mat = np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(mat).to(device)


def _rfft_power_gemm(x: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(x)|^2 along the last axis as one real-DFT matrix product.

    Not bitwise the FFT's (another summation order); the marker verifier
    decides on thresholds, not on spectrum bits. The product runs at full
    f32 whatever the process allows for matmuls (JAX asks for
    ``Precision.HIGHEST``): TF32 is switched off around it and the
    process's setting restored. Callers gate on ``n <= _GEMM_MAX_N``."""
    f = n // 2 + 1
    mat = _dft_matrix(n, x.device)
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        _CAPTURED_DFT[(n, x.device)] = mat
    with _full_f32_matmul():
        proj = x.reshape(-1, n) @ mat
    re, im = proj[:, :f], proj[:, f:]
    return (re * re + im * im).reshape(*x.shape[:-1], f)


@contextlib.contextmanager
def _full_f32_matmul():
    """CUDA f32 matmuls at IEEE f32, not TF32, inside the block. Through
    the CUDA backend's own setting (``fp32_precision``, where torch has
    it), which leaves the process-wide getters as they were: mixing it with
    the legacy ``allow_tf32`` flag makes ``get_float32_matmul_precision``
    raise."""
    matmul = torch.backends.cuda.matmul
    name, off = ("fp32_precision", "ieee") if hasattr(matmul, "fp32_precision") else (
        "allow_tf32", False)
    saved = getattr(matmul, name)
    setattr(matmul, name, off)
    try:
        yield
    finally:
        setattr(matmul, name, saved)


def _marker_gemm_enabled() -> bool:
    """DFT-GEMM marker spectra: ``APD_MARKER_GEMM=1`` turns them on, any
    other value or none leaves the FFT (the JAX package's default off a
    TPU). Read at each call."""
    return os.environ.get("APD_MARKER_GEMM") == "1"


def _band_purity(power: torch.Tensor, band: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(purity, energy) of power spectra (..., F) against a band mask."""
    energy = power.sum(dim=-1)
    band_energy = torch.where(band, power, 0.0).sum(dim=-1)
    purity = torch.where(energy > 0.0, band_energy / energy.clamp_min(1e-38), 0.0)
    return purity, energy


def verify_marker(
    section: torch.Tensor,  # (S,) or (B, S) normalised, NaN-scrubbed
    pos: torch.Tensor,  # (R, K) candidate 'full' indices
    alive: torch.Tensor,  # (R, K) bool
    consts: MarkerVerifyConsts,
) -> torch.Tensor:
    """Returns the accept mask (R, K). The rows are the group's G clips
    over one section, or B rounds of them over a (B, S) batch (R = B * G,
    round-major): row r reads section r // G and the constants of clip
    r % G."""
    r_rows, k = pos.shape
    m = consts.clip_len
    sections = section.reshape(-1, section.shape[-1])
    b = sections.shape[0]
    g = r_rows // b
    # [lag - m, lag + 2m) holds left flank, match and right flank.
    lag = pos - (m - 1)
    secp = F.pad(sections, (m + _PAD, m + _PAD))
    start = (lag + _PAD).clamp(0, secp.shape[1] - 3 * m)
    # (B, G, K, 3, m): the per-clip constants broadcast over B and K.
    seg3 = slice_rows_windows(secp, start.reshape(b, g * k), 3 * m).reshape(b, g, k, 3, m)
    gemm = _marker_gemm_enabled()

    if gemm and m <= _GEMM_MAX_N:
        # argmax and the purity ratios need only the power spectrum.
        power = _rfft_power_gemm(seg3 * consts.hann_whole, m)
        match_arg = power[..., 1, :].argmax(dim=-1)
    else:
        spec = torch.fft.rfft(seg3 * consts.hann_whole, dim=-1).abs()
        power = spec * spec
        # argmax on the magnitude, not its square: squaring can collapse
        # near-tied f32 magnitudes and shift the tie-break index.
        match_arg = spec[..., 1, :].argmax(dim=-1)
    purity, _ = _band_purity(power, consts.band_whole[:, None, None, :])
    purity_left, purity_match, purity_right = purity.unbind(dim=-1)

    detected = consts.freqs_whole[match_arg]  # (B, G, K)
    dom = consts.dom_freq[:, None]
    freq_ok = (detected - dom).abs() <= 0.05 * torch.maximum(detected.abs(), dom)

    if consts.frame_count > 0:
        wl = consts.frame_len
        seg_match = seg3[..., 1, :]
        frames = torch.stack(
            [seg_match[..., s0 : s0 + wl] for s0 in consts.frame_starts], dim=-2
        ) * consts.hann_frame  # (B, G, K, F, wl)
        if gemm and wl <= _GEMM_MAX_N:
            fpow = _rfft_power_gemm(frames, wl)
            ffreq_arg = fpow.argmax(dim=-1)
        else:
            fspec = torch.fft.rfft(frames, dim=-1).abs()
            fpow = fspec * fspec
            ffreq_arg = fspec.argmax(dim=-1)
        fpur, fenergy = _band_purity(fpow, consts.band_frame[:, None, None, :])
        nonzero = fenergy > 0.0
        ffreq = consts.freqs_frame[ffreq_arg]
        locked = (ffreq - dom[..., None]).abs() <= consts.lock_hz[:, None, None]
        active = nonzero & locked & (fpur >= float(np.float32(0.55)))

        frame_count = nonzero.sum(dim=-1)  # (B, G, K)
        active_count = active.sum(dim=-1)
        # Longest consecutive active run: distance to the last inactive frame.
        fpos = torch.arange(consts.frame_count, device=section.device)
        last_inactive = torch.cummax(torch.where(~active, fpos, -1), dim=-1).values
        longest_run = torch.where(active, fpos - last_inactive, 0).amax(dim=-1)
        mean_purity = torch.where(
            active_count > 0,
            torch.where(active, fpur, 0.0).sum(dim=-1) / active_count.clamp_min(1),
            0.0,
        )
        ratio = torch.where(
            frame_count > 0, active_count / frame_count.clamp_min(1), 0.0
        )
    else:
        ratio = torch.zeros((b, g, k), device=section.device)
        longest_run = torch.zeros((b, g, k), dtype=torch.int64, device=section.device)
        mean_purity = torch.zeros((b, g, k), device=section.device)

    t = consts.thresholds[:, None, :]  # (G, 1, 6)
    min_flank = torch.minimum(purity_left, purity_right)
    max_flank = torch.maximum(purity_left, purity_right)
    embedded = (
        (purity_match >= t[..., 0])
        & (ratio >= t[..., 1])
        & (longest_run >= t[..., 2])
        & (mean_purity >= t[..., 3])
        & (min_flank <= t[..., 4])
        & (max_flank <= t[..., 5])
    )
    return alive & (freq_ok & embedded).reshape(r_rows, k)
