"""Exact host-side chunk processing (numpy, f64 where the reference is).

Replicates the reference's per-clip chunk flow
(reference: audio_pattern_detector.py:389-903) on the host using the
hostref ops. Used as:

* the exactness fallback when a chunk produces more raw peak candidates
  than the device program's static candidate capacity (adversarial inputs;
  never real program material), and
* the golden model for differential tests of the device engine.
"""

from __future__ import annotations

from typing import Any

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.ops import hostref
from audio_pattern_detector_tpu_torch import native
from audio_pattern_detector_tpu_torch.ops.tone import (
    analyze_pure_tone_candidate,
    extract_padded_segment,
)
from audio_pattern_detector_tpu_torch.utils.audio_io import slicing_with_zero_padding

SIMILARITY_HARD_LIMIT = 0.02
PEARSON_R_THRESHOLD = 0.90

# Default marker-tone thresholds (reference: audio_pattern_detector.py:698-705).
MARKER_THRESHOLD_DEFAULTS = {
    "minimum_band_purity": 0.95,
    "minimum_active_frame_ratio": 0.80,
    "minimum_longest_active_run": 9,
    "minimum_active_frame_mean_purity": 0.92,
    "maximum_min_flank_purity": 0.25,
    "maximum_max_flank_purity": 0.65,
}


def normalize_section(audio_section: NDArray[np.float32], sr: int) -> NDArray[np.float32]:
    """Loudness-normalise a section to -16 LUFS and scrub NaN to zero
    (reference: audio_pattern_detector.py:414-420, 489-490)."""
    seconds = len(audio_section) / sr
    block = seconds if seconds < 0.5 else 0.4
    loudness = native.integrated_loudness(audio_section, sr, block_size=block)
    normalized = native.loudness_normalize(audio_section, loudness, -16.0)
    return np.nan_to_num(normalized, nan=0.0)


def _verify_normal_host(
    correlation_clip: NDArray[np.float32],
    correlation_slice: NDArray[np.float32],
    is_short_clip: bool,
    debug_detail: "dict[str, Any] | None" = None,
) -> tuple[bool, float, float]:
    """10-partition MSE + centre-window Pearson
    (reference: audio_pattern_detector.py:752-903).

    Returns (accept, similarity, pearson_r). When ``debug_detail`` is given
    it is filled with the per-window breakdown (all three Pearson windows,
    as the reference computes in debug mode).
    """
    partition_count = 10
    ps = len(correlation_clip) // partition_count
    mses = np.array(
        [
            np.mean(
                (
                    correlation_clip[i * ps : (i + 1) * ps]
                    - correlation_slice[i * ps : (i + 1) * ps]
                )
                ** 2
            )
            for i in range(partition_count)
        ],
        dtype=np.float32,
    )
    similarity_middle = float(np.mean(mses[4:6]))
    similarity_whole = float(np.mean(mses))
    similarity = similarity_whole if is_short_clip else min(similarity_whole, similarity_middle)
    if debug_detail is not None:
        debug_detail["whole"] = similarity_whole
        debug_detail["middle"] = similarity_middle

    if similarity > SIMILARITY_HARD_LIMIT:
        return False, similarity, -1.0

    ds_base = 101
    if is_short_clip:
        pearson_windows = [(0, 10, round(ds_base * 10 / 2))]
        center_idx = 0
    else:
        pearson_windows = [
            (0, 5, round(ds_base * 5 / 2)),
            (4, 6, ds_base),
            (5, 10, round(ds_base * 5 / 2)),
        ]
        center_idx = 1
    # Fast path computes only the decision-relevant centre window; debug
    # computes all three like the reference's debug graphs.
    windows = pearson_windows if debug_detail is not None else [pearson_windows[center_idx]]
    if debug_detail is None:
        center_idx = 0

    lc = len(correlation_clip)
    r_center = -1.0
    best_r, best_idx = -1.0, 0
    win_dump = []
    for wi, (wl, wr, ds_n) in enumerate(windows):
        lo, hi = round(lc * wl / 10), round(lc * wr / 10)
        ds_clip = native.resample_preserve_maxima(correlation_clip[lo:hi], ds_n)
        ds_slice = native.resample_preserve_maxima(correlation_slice[lo:hi], ds_n)
        r = native.pearson_correlation(ds_clip, ds_slice)
        if wi == center_idx:
            r_center = r
        if r > best_r:
            best_r, best_idx = r, wi
        if debug_detail is not None:
            debug_detail[f"pearson_w{wl}_{wr}"] = r
            win_dump.append((wl, wr, ds_slice, ds_clip, r))
    if debug_detail is not None:
        debug_detail["pearson_r"] = r_center
        debug_detail["best_window_idx"] = best_idx
        debug_detail["windows"] = win_dump
    return r_center >= PEARSON_R_THRESHOLD, similarity, r_center


def _verify_marker_host(
    audio_section: NDArray[np.float32],
    peak: int,
    clip_length: int,
    dominant_frequency: float,
    sr: int,
    verification: dict[str, Any],
) -> bool:
    """Marker-tone verification (reference: audio_pattern_detector.py:642-750)."""
    import math

    match_start = peak - clip_length + 1
    matched = extract_padded_segment(audio_section, match_start, clip_length)
    left = extract_padded_segment(audio_section, match_start - clip_length, clip_length)
    right = extract_padded_segment(audio_section, match_start + clip_length, clip_length)
    metrics = analyze_pure_tone_candidate(matched, sr, dominant_frequency)
    left_m = analyze_pure_tone_candidate(left, sr, dominant_frequency)
    right_m = analyze_pure_tone_candidate(right, sr, dominant_frequency)

    if not isinstance(verification, dict):
        verification = {}
    d = MARKER_THRESHOLD_DEFAULTS
    min_band = float(verification.get("minimum_band_purity", d["minimum_band_purity"]))
    min_ratio = float(
        verification.get("minimum_active_frame_ratio", d["minimum_active_frame_ratio"])
    )
    min_run = int(
        verification.get("minimum_longest_active_run", d["minimum_longest_active_run"])
    )
    min_mean = float(
        verification.get(
            "minimum_active_frame_mean_purity", d["minimum_active_frame_mean_purity"]
        )
    )
    max_min_flank = float(
        verification.get("maximum_min_flank_purity", d["maximum_min_flank_purity"])
    )
    max_max_flank = float(
        verification.get("maximum_max_flank_purity", d["maximum_max_flank_purity"])
    )

    if not math.isclose(metrics.detected_frequency, dominant_frequency, rel_tol=0.05):
        return False

    min_flank = min(left_m.overall_band_purity, right_m.overall_band_purity)
    max_flank = max(left_m.overall_band_purity, right_m.overall_band_purity)
    return (
        metrics.overall_band_purity >= min_band
        and metrics.active_frame_ratio >= min_ratio
        and metrics.longest_active_run >= min_run
        and metrics.active_frame_mean_purity >= min_mean
        and min_flank <= max_min_flank
        and max_flank <= max_max_flank
    )


def process_section_host(
    audio_section: NDArray[np.float32],
    clip: NDArray[np.float32],
    correlation_clip: NDArray[np.float32],
    correlation_clip_absolute_max: float,
    sr: int,
    height_min: float,
    is_short_clip: bool,
    tone_frequency: float | None,
    verification_params: dict[str, Any],
    debug: "Any | None" = None,  # models.debug.DebugSink
    clip_name: str = "",
    index: int = 0,
    section_ts: str = "",
) -> list[int]:
    """Full Step-1 + Step-2 for one clip over one (raw) audio section.

    Returns accepted peak positions ('full' correlation indices, ascending).
    With a DebugSink attached, emits the reference's debug artifacts
    (correlation graphs, candidate WAV/slice dumps, JSON peak dumps).
    """
    import sys

    section = normalize_section(audio_section, sr)
    correlation = np.abs(hostref.fft_correlate_1d(section, clip, mode="full"))
    absolute_max = np.max(correlation)
    max_choose = max(correlation_clip_absolute_max, absolute_max)
    correlation = correlation / max_choose

    if debug is not None:
        print("---", file=sys.stderr)
        print(f"section_ts: {section_ts}, index {index}", file=sys.stderr)
        debug.dump_chunk_correlation(clip_name, correlation, index, section_ts)

    clip_length = len(clip)
    peaks, _ = native.find_peaks(correlation, height=height_min, distance=clip_length)

    peaks_final: list[int] = []
    seconds: list[float] = []
    similarities: list[Any] = []
    half = len(correlation_clip) // 2
    for peak in peaks:
        peak = int(peak)
        if peak + half > len(correlation) + 5:
            continue
        if peak - half < -5:
            continue
        if tone_frequency is not None:
            accepted = _verify_marker_host(
                section, peak, clip_length, tone_frequency, sr, verification_params
            )
            if accepted:
                peaks_final.append(peak)
        else:
            correlation_slice = slicing_with_zero_padding(
                correlation, len(correlation_clip), peak
            )
            correlation_slice = correlation_slice / np.max(correlation_slice)
            if len(correlation_slice) != len(correlation_clip):
                raise ValueError(
                    f"correlation_slice length {len(correlation_slice)} not equal to "
                    f"correlation_clip length {len(correlation_clip)}"
                )
            detail: "dict[str, Any] | None" = {} if debug is not None else None
            accepted, similarity, r = _verify_normal_host(
                correlation_clip, correlation_slice, is_short_clip, detail
            )
            if debug is not None and detail is not None:
                seconds.append(peak / sr)
                debug.record_similarity(clip_name, index, similarity)
                if similarity > SIMILARITY_HARD_LIMIT:
                    similarities.append(
                        (similarity, {"whole": detail["whole"], "middle": detail["middle"]}, None)
                    )
                    print(
                        f"failed verification for {section_ts} due to similarity "
                        f"{similarity} > {SIMILARITY_HARD_LIMIT}",
                        file=sys.stderr,
                    )
                else:
                    print(f"similarity {similarity} pearson_r {r}", file=sys.stderr)
                    debug.dump_candidate_slice(
                        clip_name, correlation_slice, correlation_clip,
                        similarity, index, section_ts, peak,
                    )
                    debug.dump_pearson_windows(
                        clip_name, detail["windows"], index, section_ts, peak,
                        detail["best_window_idx"],
                    )
                    similarities.append(
                        (
                            similarity,
                            {"whole": detail["whole"], "middle": detail["middle"]},
                            {
                                k: v
                                for k, v in detail.items()
                                if k.startswith("pearson") or k == "pearson_r"
                            },
                        )
                    )
                    if not accepted:
                        print(
                            f"failed verification for {section_ts} due to similarity "
                            f"{similarity} pearson_r {r}",
                            file=sys.stderr,
                        )
            if accepted:
                peaks_final.append(peak)

        if debug is not None:
            debug.dump_candidate_audio(
                clip_name, section, peak, clip_length, index, section_ts
            )

    if debug is not None and len(peaks) > 0:
        debug.dump_peaks_json(clip_name, peaks, seconds, similarities, index, section_ts)
        print("---", file=sys.stderr)

    return peaks_final
