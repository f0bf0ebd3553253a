"""Pure-tone analysis (host reference implementation).

Semantics parity with the reference tone analyser
(reference: audio_pattern_detector/detection_utils.py). The device fast
path re-implements the same math as batched tensor programs in
``ops/verify.py``; this host version anchors differential tests and serves
the exactness fallback path and init-time tone derivation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.ops import hostref


@dataclass(frozen=True)
class PureToneMetrics:
    """Frequency-domain metrics for validating a pure-tone candidate window."""

    detected_frequency: float
    overall_band_purity: float
    active_frame_ratio: float
    longest_active_run: int
    active_frame_mean_purity: float


def get_pure_tone_frequency(
    audio_data: NDArray[np.float32], sample_rate: int
) -> float | None:
    """Dominant frequency if the audio is a pure tone, else None.

    Pure iff the normalised rfft magnitude has exactly one peak at
    prominence 0.05 and that peak matches the argmax bin within 1%.
    """
    magnitude = np.abs(np.fft.rfft(audio_data))
    top = int(np.argmax(magnitude))
    if magnitude[top] == 0.0:
        return None
    peaks, _ = hostref.find_peaks(
        (magnitude / magnitude[top]).astype(np.float32), prominence=0.05
    )
    if len(peaks) != 1:
        return None
    freqs = np.fft.rfftfreq(len(audio_data), d=1 / sample_rate)
    dominant = float(freqs[top])
    return (
        dominant
        if math.isclose(float(freqs[peaks[0]]), dominant, rel_tol=0.01)
        else None
    )


def frame_grid(clip_length: int, sample_rate: int) -> tuple[int, int, int]:
    """(window_len, hop, frame_count) of the 25 ms / 50%-hop frame loop.

    The range ``range(0, clip_length - window_len, hop)`` excludes a final
    partial frame and excludes a frame starting exactly at
    ``clip_length - window_len`` (half-open upper bound) — boundary semantics
    the device path must reproduce (reference: detection_utils.py:87).
    """
    window_len = max(int(round(0.025 * sample_rate)), 32)
    hop = max(window_len // 2, 1)
    frame_count = len(range(0, clip_length - window_len, hop))
    return window_len, hop, frame_count


def _isclose_abs(values: NDArray[np.float64], target: float, abs_tol: float) -> NDArray[np.bool_]:
    """Vectorised ``math.isclose(v, target, abs_tol=...)`` — including the
    default rel_tol=1e-9 term, so thresholds flip on exactly the same
    inputs as the scalar stdlib call."""
    tol = np.maximum(1e-9 * np.maximum(np.abs(values), abs(target)), abs_tol)
    return np.abs(values - target) <= tol


def analyze_pure_tone_candidate(
    audio_data: NDArray[np.float32],
    sample_rate: int,
    dominant_frequency: float,
) -> PureToneMetrics:
    """How strongly a candidate window behaves like a single pure tone.

    Whole-window Hann rfft band purity within ±max(40 Hz, 8%·f), then 25 ms
    frames at 50% hop with per-frame dominant-frequency lock
    (±max(20 Hz, 4%·f)) and frame purity ≥ 0.55 driving active-frame stats.

    Unlike the reference's sequential frame loop
    (reference: detection_utils.py:87-112), all frames transform in one
    batched rfft, with the run-length bookkeeping done as prefix scans —
    the same shape as the device implementation in ``ops/verify.py``.
    """
    if len(audio_data) == 0:
        return PureToneMetrics(0.0, 0.0, 0.0, 0, 0.0)

    band_hz = max(40.0, dominant_frequency * 0.08)
    lock_hz = max(20.0, dominant_frequency * 0.04)

    spectrum = np.abs(np.fft.rfft(audio_data * np.hanning(len(audio_data))))
    freqs = np.fft.rfftfreq(len(audio_data), d=1 / sample_rate)
    detected_frequency = float(freqs[int(np.argmax(spectrum))])

    total_energy = float(np.sum(spectrum**2))
    if total_energy == 0.0:
        return PureToneMetrics(detected_frequency, 0.0, 0.0, 0, 0.0)

    in_band = np.abs(freqs - dominant_frequency) <= band_hz
    overall_band_purity = float(np.sum(spectrum[in_band] ** 2)) / total_energy

    window_len, hop, n_frames = frame_grid(len(audio_data), sample_rate)
    if n_frames == 0:
        return PureToneMetrics(detected_frequency, overall_band_purity, 0.0, 0, 0.0)

    # (F, W) frame matrix -> one batched rfft for every frame at once.
    frames = np.lib.stride_tricks.sliding_window_view(audio_data, window_len)[
        ::hop
    ][:n_frames]
    specs = np.abs(np.fft.rfft(frames * np.hanning(window_len), axis=1))
    powers = specs**2

    frame_freqs = np.fft.rfftfreq(window_len, d=1 / sample_rate)
    frame_band = np.abs(frame_freqs - dominant_frequency) <= band_hz

    energies = np.sum(powers, axis=1)  # (F,)
    nonzero = energies != 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        purities = np.where(
            nonzero, np.sum(powers[:, frame_band], axis=1) / energies, 0.0
        )
    locked = _isclose_abs(
        frame_freqs[np.argmax(specs, axis=1)], dominant_frequency, lock_hz
    )
    active = nonzero & locked & (purities >= 0.55)

    # Longest consecutive-active run via a last-reset prefix scan: a
    # zero-energy or inactive frame resets, exactly like the serial loop.
    idx = np.arange(n_frames)
    last_reset = np.maximum.accumulate(np.where(active, -1, idx))
    run_lengths = np.where(active, idx - last_reset, 0)

    frame_count = int(np.sum(nonzero))
    active_count = int(np.sum(active))
    return PureToneMetrics(
        detected_frequency=detected_frequency,
        overall_band_purity=overall_band_purity,
        active_frame_ratio=active_count / frame_count if frame_count else 0.0,
        longest_active_run=int(run_lengths.max(initial=0)),
        active_frame_mean_purity=(
            float(np.mean(purities[active])) if active_count else 0.0
        ),
    )


def extract_padded_segment(
    audio_data: NDArray[np.float32], start: int, length: int
) -> NDArray[np.float32]:
    """Fixed-length segment with zero padding at out-of-bounds edges."""
    out = np.zeros(length, dtype=np.float32)
    src_lo = max(0, start)
    src_hi = min(len(audio_data), start + length)
    if src_hi > src_lo:
        out[src_lo - start : src_hi - start] = audio_data[src_lo:src_hi]
    return out


def max_distance(sorted_data: list[float]) -> float:
    """Maximum gap between consecutive elements of sorted data."""
    if len(sorted_data) < 2:
        return 0
    return float(np.max(np.diff(np.asarray(sorted_data))))
