"""Exact host-side numeric ops (numpy, f64 accumulation).

This module is the host-precision anchor of the framework. It provides the
same API surface as the reference's native helper module
``audio_pattern_detector._native`` (reference: native-helper/src/python.rs:183-206)
plus the Step-1 FFT correlation (reference: external ``fft-correlation``
package, used at audio_pattern_detector.py:375-376,487-491), implemented
from the documented semantics:

* ``find_peaks``            — scipy.signal.find_peaks semantics for
                              height/distance/prominence
                              (reference: native-helper/src/lib.rs:380-643)
* ``resample``              — scipy.signal.resample spectrum-slice rule
                              (reference: native-helper/src/lib.rs:235-275)
* ``resample_preserve_maxima`` — window-max downsample
                              (reference: native-helper/src/lib.rs:283-318)
* ``simpson``               — composite Simpson 1/3 + Cartwright correction
                              (reference: native-helper/src/lib.rs:327-363)
* ``integrated_loudness``   — ITU-R BS.1770-4 gated loudness
                              (reference: native-helper/src/lib.rs:128-214)
* ``loudness_normalize``    — gain to target LUFS with hard clip
                              (reference: native-helper/src/lib.rs:220-227)
* ``pearson_correlation``   — f64-accumulated Pearson r
                              (reference: native-helper/src/lib.rs:651-675)
* ``fft_correlate_1d``      — full linear cross-correlation via FFT

These run at init time (clips are short) and as the exactness fallback for
the streaming path; the per-chunk hot path lives on device (see sibling
modules).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
from numpy.typing import NDArray

__all__ = [
    "find_peaks",
    "resample",
    "resample_preserve_maxima",
    "simpson",
    "integrated_loudness",
    "loudness_normalize",
    "pearson_correlation",
    "fft_correlate_1d",
    "k_weighting_coefficients",
    "k_weighting_fir",
]


# ── Peak finding ─────────────────────────────────────────────────────


def _local_maxima_plateau(x: NDArray[np.floating[Any]]) -> NDArray[np.int64]:
    """Strict local maxima with plateau-midpoint indices (scipy semantics).

    A peak is a maximal run of equal values strictly greater than both
    neighbouring samples; its reported index is the floor midpoint of the run.
    Vectorised: for every rising step, find the next non-flat step; it is a
    peak iff that step falls.
    """
    n = len(x)
    if n < 3:
        return np.empty(0, dtype=np.int64)
    d = np.diff(x.astype(np.float64, copy=False))
    nz = np.flatnonzero(d != 0)  # positions of non-flat steps
    if len(nz) == 0:
        return np.empty(0, dtype=np.int64)
    rising = nz[d[nz] > 0]  # rising step at p means x[p] < x[p+1]
    if len(rising) == 0:
        return np.empty(0, dtype=np.int64)
    # Next non-flat step strictly after each rising step.
    j = np.searchsorted(nz, rising, side="right")
    has_next = j < len(nz)
    rising = rising[has_next]
    nxt = nz[j[has_next]]
    falls = d[nxt] < 0
    left_edge = rising[falls] + 1
    right_edge = nxt[falls]
    return ((left_edge + right_edge) // 2).astype(np.int64)


def _greedy_distance_filter(
    values: NDArray[np.floating[Any]],
    peaks: NDArray[np.int64],
    min_distance: int,
) -> NDArray[np.int64]:
    """Greedy tallest-first suppression, ties broken by lower index.

    Matches the reference helper's priority order
    (reference: native-helper/src/lib.rs:437-485). scipy breaks equal-height
    ties the other way; real-valued signals make ties measure-zero.
    """
    if len(peaks) == 0 or min_distance <= 0:
        return peaks
    heights = values[peaks]
    order = np.lexsort((np.arange(len(peaks)), -heights))
    keep = np.ones(len(peaks), dtype=bool)
    positions = peaks
    for idx in order:
        if not keep[idx]:
            continue
        lo = idx
        while lo > 0 and positions[idx] - positions[lo - 1] < min_distance:
            lo -= 1
            keep[lo] = False
        hi = idx
        while hi + 1 < len(peaks) and positions[hi + 1] - positions[idx] < min_distance:
            hi += 1
            keep[hi] = False
    return peaks[keep]


def _prominences(
    x: NDArray[np.floating[Any]], peaks: NDArray[np.int64]
) -> NDArray[np.float64]:
    """Prominence per scipy: peak − max(left-base min, right-base min).

    The scan on each side stops at the first sample strictly greater than the
    peak (or the array boundary), and the base is the minimum over that span.
    """
    x64 = x.astype(np.float64, copy=False)
    out = np.empty(len(peaks), dtype=np.float64)
    for k, p in enumerate(peaks):
        pv = x64[p]
        left_min = pv
        j = p - 1
        while j >= 0 and x64[j] <= pv:
            left_min = min(left_min, x64[j])
            j -= 1
        right_min = pv
        j = p + 1
        while j < len(x64) and x64[j] <= pv:
            right_min = min(right_min, x64[j])
            j += 1
        out[k] = pv - max(left_min, right_min)
    return out


def find_peaks(
    data: NDArray[np.floating[Any]],
    *,
    height: float | None = None,
    distance: int | None = None,
    prominence: float | None = None,
) -> tuple[NDArray[np.int64], dict[str, Any]]:
    """scipy.signal.find_peaks-compatible peak finding (subset of filters).

    Returns (sorted int64 indices, empty properties dict) matching the
    reference binding (reference: native-helper/src/python.rs:79-104).
    """
    x = np.ascontiguousarray(data, dtype=np.float32)
    peaks = _local_maxima_plateau(x)
    if height is not None:
        peaks = peaks[x[peaks] >= height]
    if distance is not None:
        peaks = _greedy_distance_filter(x, peaks, int(distance))
    if prominence is not None:
        proms = _prominences(x, peaks)
        peaks = peaks[proms >= prominence]
    return peaks.astype(np.int64), {}


# ── Resampling ───────────────────────────────────────────────────────


def resample(data: NDArray[np.floating[Any]], num_samples: int) -> NDArray[np.float32]:
    """FFT resample with the reference's spectrum-slice rule.

    Full complex FFT; copy ``(N+1)//2`` positive and ``(N-1)//2`` negative
    bins where ``N = min(len, num)``; inverse FFT scaled by ``1/len``
    (reference: native-helper/src/lib.rs:253-273). f64 throughout.

    Nyquist handling: when ``N`` is even this slice DROPS the Nyquist bin
    (index N/2) entirely, whereas ``scipy.signal.resample`` folds/splits
    it — so outputs deviate from scipy on even-N resamples of signals
    with energy at/near Nyquist (measured up to ~0.27 amplitude on white
    noise at 101→50). This matches the REFERENCE exactly — its own
    binding test allows atol=0.2 vs scipy for precisely this reason
    (reference: native-helper/tests/test_python_bindings.py:161-173
    "slightly different Nyquist handling") — and detection parity is
    pinned against the reference, not scipy.
    """
    n = len(data)
    m = int(num_samples)
    if n == 0 or m == 0:
        return np.zeros(m, dtype=np.float32)
    if n == m:
        return np.asarray(data, dtype=np.float32).copy()
    spectrum = np.fft.fft(np.asarray(data, dtype=np.float64))
    n_common = min(n, m)
    pos = (n_common + 1) // 2
    neg = (n_common - 1) // 2
    new_spectrum = np.zeros(m, dtype=np.complex128)
    new_spectrum[:pos] = spectrum[:pos]
    if neg > 0:
        new_spectrum[m - neg:] = spectrum[n - neg:]
    out = np.fft.ifft(new_spectrum) * (m / n)
    return out.real.astype(np.float32)


def resample_preserve_maxima_bounds(
    source_len: int, target_len: int
) -> tuple[NDArray[np.int64], NDArray[np.int64]]:
    """Window bounds for ``resample_preserve_maxima``.

    For output i: start = trunc(i*step), end = trunc((i+1)*step), forced to at
    least one sample, clamped into [0, source_len)
    (reference: native-helper/src/lib.rs:283-318). Exposed so the device path
    can bake the same static bounds into segment reductions.
    """
    step = source_len / target_len
    i = np.arange(target_len, dtype=np.float64)
    start = (i * step).astype(np.int64)
    end = ((i + 1) * step).astype(np.int64)
    end = np.maximum(end, start + 1)
    start = np.minimum(start, source_len - 1)
    end = np.minimum(end, source_len)
    return start, end


def resample_preserve_maxima(
    data: NDArray[np.floating[Any]], num_samples: int
) -> NDArray[np.float32]:
    """Window-max resample; output length is exactly ``num_samples``."""
    if num_samples <= 0:
        raise ValueError("num_samples must be greater than 0")
    x = np.ascontiguousarray(data, dtype=np.float32)
    if len(x) == 0:
        raise ValueError("input must be non-empty")
    start, end = resample_preserve_maxima_bounds(len(x), int(num_samples))
    return np.array(
        [x[s:e].max() for s, e in zip(start, end)], dtype=np.float32
    )


# ── Simpson integration ──────────────────────────────────────────────


def simpson(y: NDArray[np.floating[Any]]) -> float:
    """Composite Simpson 1/3 with Cartwright correction, dx=1.

    Matches scipy.integrate.simpson on uniformly spaced data
    (reference: native-helper/src/lib.rs:327-363).
    """
    v = np.asarray(y, dtype=np.float64)
    n = len(v)
    if n < 2:
        return 0.0
    if n == 2:
        return float((v[0] + v[1]) / 2.0)

    def simpson_13(a: NDArray[np.float64]) -> float:
        k = len(a)
        s = a[0] + a[k - 1] + 4.0 * a[1:k - 1:2].sum() + 2.0 * a[2:k - 1:2].sum()
        return float(s / 3.0)

    if n % 2 == 1:
        return simpson_13(v)
    base = simpson_13(v[: n - 1])
    correction = (5.0 / 12.0) * v[n - 1] + (8.0 / 12.0) * v[n - 2] - (1.0 / 12.0) * v[n - 3]
    return base + float(correction)


# ── BS.1770 loudness ─────────────────────────────────────────────────

LUFS_OFFSET = -0.691
ABSOLUTE_GATE_LUFS = -70.0
BLOCK_OVERLAP = 0.75


def k_weighting_coefficients(
    rate: float,
) -> tuple[NDArray[np.float64], NDArray[np.float64], NDArray[np.float64], NDArray[np.float64]]:
    """ITU-R BS.1770 K-weighting biquad coefficients for ``rate``.

    High shelf (G=4 dB, Q=1/sqrt(2), fc=1500 Hz) followed by a high pass
    (Q=0.5, fc=38 Hz); standard RBJ audio-EQ-cookbook biquad formulas
    (reference: native-helper/src/lib.rs:13-53).
    """
    # High shelf
    g, q, fc = 4.0, 1.0 / math.sqrt(2.0), 1500.0
    a_val = 10.0 ** (g / 40.0)
    w0 = 2.0 * math.pi * fc / rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    tsa = 2.0 * math.sqrt(a_val) * alpha
    b0 = a_val * ((a_val + 1.0) + (a_val - 1.0) * cw + tsa)
    b1 = -2.0 * a_val * ((a_val - 1.0) + (a_val + 1.0) * cw)
    b2 = a_val * ((a_val + 1.0) + (a_val - 1.0) * cw - tsa)
    a0 = (a_val + 1.0) - (a_val - 1.0) * cw + tsa
    a1 = 2.0 * ((a_val - 1.0) - (a_val + 1.0) * cw)
    a2 = (a_val + 1.0) - (a_val - 1.0) * cw - tsa
    b_shelf = np.array([b0 / a0, b1 / a0, b2 / a0])
    a_shelf = np.array([1.0, a1 / a0, a2 / a0])

    # High pass
    q2, fc2 = 0.5, 38.0
    w0 = 2.0 * math.pi * fc2 / rate
    alpha = math.sin(w0) / (2.0 * q2)
    cw = math.cos(w0)
    hb0 = (1.0 + cw) / 2.0
    hb1 = -(1.0 + cw)
    hb2 = (1.0 + cw) / 2.0
    ha0 = 1.0 + alpha
    ha1 = -2.0 * cw
    ha2 = 1.0 - alpha
    b_hp = np.array([hb0 / ha0, hb1 / ha0, hb2 / ha0])
    a_hp = np.array([1.0, ha1 / ha0, ha2 / ha0])
    return b_shelf, a_shelf, b_hp, a_hp


def _biquad(b: NDArray[np.float64], a: NDArray[np.float64], x: NDArray[np.float64]) -> NDArray[np.float64]:
    """Direct-form II transposed biquad with zero initial state (lfilter).

    Three tiers, ALL bit-identical (same recurrence, same op order as
    scipy's C `_linear_filter`): the C++ native export first (no scipy
    import — importing scipy.signal costs ~2 s of CLI cold start), then
    scipy, then a pure-python loop. Bit-identity of native vs scipy is
    pinned by tests/test_native.py::test_biquad_bitwise.
    """
    from audio_pattern_detector_tpu_torch import native as _native  # lazy: avoid cycle

    out = _native.biquad_f64(b, a, np.asarray(x, dtype=np.float64))
    if out is not None:
        return out
    try:  # scipy is present in dev/test environments; pure-python fallback below
        from scipy.signal import lfilter  # type: ignore

        return np.asarray(lfilter(b, a, x), dtype=np.float64)
    except Exception:
        # scipy's exact DF2T op order (y = z0 + b0*x first, then the
        # states, each expression evaluated left to right).
        out = np.empty_like(x)
        z0 = 0.0
        z1 = 0.0
        b0, b1, b2 = b
        _, a1, a2 = a
        for i, xi in enumerate(x):
            y = z0 + b0 * xi
            z0 = z1 + b1 * xi - a1 * y
            z1 = b2 * xi - a2 * y
            out[i] = y
        return out


def k_weighted_signal(data: NDArray[np.floating[Any]], sample_rate: float) -> NDArray[np.float64]:
    """Apply the BS.1770 K-weighting filter cascade (f64, zero initial state)."""
    b_s, a_s, b_h, a_h = k_weighting_coefficients(float(sample_rate))
    x = np.asarray(data, dtype=np.float64)
    return _biquad(b_h, a_h, _biquad(b_s, a_s, x))


def k_weighting_fir(sample_rate: float, num_taps: int = 4096) -> NDArray[np.float64]:
    """Truncated impulse response of the K-weighting cascade.

    The cascade's slowest pole (38 Hz high-pass, Q=0.5) decays the impulse
    response below ~1e-12 within a few thousand samples at audio rates, so a
    truncated FIR reproduces the IIR to float32 precision. The device path
    replaces the sequential scan with an FFT convolution against this kernel.
    """
    impulse = np.zeros(num_taps, dtype=np.float64)
    impulse[0] = 1.0
    return k_weighted_signal(impulse, sample_rate)


def _round_half_away(x: float) -> int:
    """Round half away from zero (Rust f64::round semantics)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def num_gating_blocks(n: int, rate: float, t_g: float) -> int:
    """Number of 75%-overlap gating blocks for an n-sample signal."""
    t = n / rate
    return _round_half_away((t - t_g) / (t_g * (1.0 - BLOCK_OVERLAP))) + 1


def _block_mean_squares(
    squared_prefix: NDArray[np.float64],
    n: int,
    rate: float,
    t_g: float,
    num_blocks: int,
) -> NDArray[np.float64]:
    """Mean square per 75%-overlapped gating block (truncated-index bounds)."""
    window_samples = t_g * rate
    hop_samples = window_samples * (1.0 - BLOCK_OVERLAP)
    out = []
    for j in range(num_blocks):
        lo = int(j * hop_samples)
        hi = min(int(j * hop_samples + window_samples), n)
        if lo >= hi:
            continue
        out.append((squared_prefix[hi] - squared_prefix[lo]) / (hi - lo))
    return np.asarray(out, dtype=np.float64)


def integrated_loudness(
    data: NDArray[np.floating[Any]], sample_rate: int, block_size: float = 0.4
) -> float:
    """ITU-R BS.1770-4 integrated gated loudness in LUFS (may be -inf).

    K-weight, 400 ms blocks at 75% overlap, absolute gate at -70 LUFS then
    relative gate at (mean - 10) LUFS; signals shorter than one block use the
    plain mean square (reference: native-helper/src/lib.rs:128-214).
    """
    x = np.asarray(data, dtype=np.float32)
    n = len(x)
    if n == 0:
        return float("-inf")
    filtered = k_weighted_signal(x, sample_rate)
    prefix = np.concatenate(([0.0], np.cumsum(filtered * filtered)))

    rate = float(sample_rate)
    t_g = float(block_size)
    num_blocks = num_gating_blocks(n, rate, t_g)
    if num_blocks <= 0:
        # Shorter than one block: plain mean square.
        ms = prefix[n] / n
        if ms <= 0.0:
            return float("-inf")
        return LUFS_OFFSET + 10.0 * math.log10(ms)

    block_ms = _block_mean_squares(prefix, n, rate, t_g, num_blocks)
    block_ms = block_ms[block_ms > 0.0]
    if len(block_ms) == 0:
        return float("-inf")
    block_loudness = LUFS_OFFSET + 10.0 * np.log10(block_ms)

    abs_mask = block_loudness >= ABSOLUTE_GATE_LUFS
    if not abs_mask.any():
        return float("-inf")
    z_avg = block_ms[abs_mask].mean()
    gamma_r = LUFS_OFFSET + 10.0 * math.log10(z_avg) - 10.0

    rel_mask = (block_loudness > gamma_r) & abs_mask
    if not rel_mask.any():
        return float("-inf")
    return LUFS_OFFSET + 10.0 * math.log10(block_ms[rel_mask].mean())


def loudness_normalize(
    data: NDArray[np.floating[Any]], current_lufs: float, target_lufs: float
) -> NDArray[np.float32]:
    """Apply gain from ``current_lufs`` to ``target_lufs``; hard clip [-1, 1].

    NaN propagates through the clip (matching Rust f64::clamp), so silence
    normalised from -inf LUFS yields NaN that callers scrub to zero
    (reference: native-helper/src/lib.rs:220-227 and
    audio_pattern_detector.py:489-490).
    """
    gain = 10.0 ** ((target_lufs - current_lufs) / 20.0)
    y = np.asarray(data, dtype=np.float64) * gain
    return np.clip(y, -1.0, 1.0).astype(np.float32)


# ── Pearson correlation ──────────────────────────────────────────────


def pearson_correlation(
    x: NDArray[np.floating[Any]], y: NDArray[np.floating[Any]]
) -> float:
    """Pearson r with f64 accumulation; 0.0 for empty or zero-variance input."""
    if len(x) != len(y):
        raise ValueError("arrays must have the same length")
    if len(x) == 0:
        return 0.0
    a = np.asarray(x, dtype=np.float64)
    b = np.asarray(y, dtype=np.float64)
    da = a - a.mean()
    db = b - b.mean()
    denom = math.sqrt(float((da * da).sum()) * float((db * db).sum()))
    if denom == 0.0:
        return 0.0
    return float((da * db).sum()) / denom


# ── FFT cross-correlation ────────────────────────────────────────────


def fft_correlate_1d(
    a: NDArray[np.floating[Any]],
    v: NDArray[np.floating[Any]],
    mode: str = "full",
) -> NDArray[np.float32]:
    """Full linear cross-correlation via FFT, float32 output.

    Same contract as the reference's external ``fft-correlation`` package
    (used at reference audio_pattern_detector.py:375-376,487-491):
    ``out[k] = sum_i a[i] * v[i - (k - len(v) + 1)]`` with length
    ``len(a) + len(v) - 1`` — i.e. numpy.correlate(a, v, 'full') ordering.
    """
    if mode != "full":
        raise ValueError(f"only mode='full' is supported, got {mode!r}")
    n, m = len(a), len(v)
    if n == 0 or m == 0:
        return np.zeros(max(n + m - 1, 0), dtype=np.float32)
    size = 1
    while size < n + m - 1:
        size *= 2
    fa = np.fft.rfft(np.asarray(a, dtype=np.float64), size)
    fv = np.fft.rfft(np.asarray(v, dtype=np.float64), size)
    # Lag-domain circular correlation: z[l] = sum_i a[i + l] v[i].
    z = np.fft.irfft(fa * np.conj(fv), size)
    # Reorder to 'full' layout: index k corresponds to lag k - (m - 1).
    out = np.concatenate((z[size - (m - 1):] if m > 1 else z[:0], z[: n]))
    return out.astype(np.float32)
