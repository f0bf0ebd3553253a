"""Debug observability: graphs, candidate audio dumps, JSON peak dumps.

Artifact-for-artifact parity with the reference's debug mode
(reference: audio_pattern_detector.py:177-202, 333-370, 498-513, 563-581,
848-895), which is the project's deep observability system:

* ``graph/clip_correlation/<clip>.png`` and
  ``graph/cross_correlation_slice_original/<clip>/<clip>.png`` — the
  clip's self-correlation at init;
* ``graph/cross_correlation/<clip>/..._<index>_<ts>.png`` — per-chunk
  cross-correlation;
* ``graph/cross_correlation_slice/<clip>/...png`` and
  ``graph/pearson_downsampled/<clip>/...png`` — per-candidate slice and
  Pearson windows;
* ``audio_section/<clip>/..._<peak>.wav`` — candidate audio dumps;
* ``debug/cross_correlation_<clip>/<index>_<ts>.txt`` — JSON peak dumps;
* ``graph/mean_squared_error_similarity/<clip>/<audio>.png`` — post-run
  similarity scatter.

matplotlib is an optional dependency: graphs are skipped (with one stderr
notice) when it is unavailable; JSON and WAV dumps always work.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.utils.numpy_encoder import NumpyEncoder
from audio_pattern_detector_tpu_torch.utils.audio_io import write_wav_file

_warned_no_mpl = False


def _plt():
    global _warned_no_mpl
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:  # noqa: BLE001
        if not _warned_no_mpl:
            print("debug: matplotlib unavailable, skipping graphs", file=sys.stderr)
            _warned_no_mpl = True
        return None


class DebugSink:
    """Collects and writes debug artifacts for one detector run."""

    def __init__(self, debug_dir: str, sample_rate: int) -> None:
        self.debug_dir = debug_dir
        self.sample_rate = sample_rate
        # clip_name -> list[(chunk_index, similarity)]
        self.similarity_log: dict[str, list[tuple[int, float]]] = {}

    # ── init-time ──

    def dump_clip_correlation(self, clip_name: str, correlation_clip: NDArray) -> None:
        plt = _plt()
        if plt is None:
            return
        graph_dir = f"{self.debug_dir}/graph/clip_correlation"
        os.makedirs(graph_dir, exist_ok=True)
        plt.figure(figsize=(10, 4))
        plt.plot(correlation_clip)
        plt.title("Cross-correlation of the audio clip itself")
        plt.xlabel("Lag")
        plt.ylabel("Correlation coefficient")
        plt.savefig(f"{graph_dir}/{clip_name}.png")
        plt.close()

        orig_dir = f"{self.debug_dir}/graph/cross_correlation_slice_original/{clip_name}"
        os.makedirs(orig_dir, exist_ok=True)
        plt.figure(figsize=(10, 4))
        plt.plot(correlation_clip, color="orange")
        plt.title("Cross-correlation of the audio clip itself (original pattern)")
        plt.xlabel("Lag")
        plt.ylabel("Correlation coefficient")
        plt.savefig(f"{orig_dir}/{clip_name}.png")
        plt.close()

    # ── per-chunk ──

    def dump_chunk_correlation(
        self, clip_name: str, correlation: NDArray, index: int, section_ts: str
    ) -> None:
        plt = _plt()
        if plt is None:
            return
        graph_dir = f"{self.debug_dir}/graph/cross_correlation/{clip_name}"
        os.makedirs(graph_dir, exist_ok=True)
        plt.figure(figsize=(10, 4))
        plt.plot(correlation)
        plt.title("Cross-correlation between the audio clip and full track before slicing")
        plt.xlabel("Lag")
        plt.ylabel("Correlation coefficient")
        plt.savefig(f"{graph_dir}/{clip_name}_{index}_{section_ts}.png")
        plt.close()

    def dump_candidate_audio(
        self,
        clip_name: str,
        audio_section: NDArray[np.float32],
        peak: int,
        clip_len: int,
        index: int,
        section_ts: str,
    ) -> None:
        audio_dir = f"{self.debug_dir}/audio_section/{clip_name}"
        os.makedirs(audio_dir, exist_ok=True)
        seg = np.clip(audio_section[max(0, peak - clip_len) : peak + clip_len], -1.0, 1.0)
        write_wav_file(
            f"{audio_dir}/{clip_name}_{index}_{section_ts}_{peak}.wav",
            seg.astype(np.float32),
            self.sample_rate,
        )

    def dump_candidate_slice(
        self,
        clip_name: str,
        correlation_slice: NDArray,
        correlation_clip: NDArray,
        similarity: float,
        index: int,
        section_ts: str,
        peak: int,
    ) -> None:
        plt = _plt()
        if plt is None or similarity > 0.1:
            return
        graph_dir = f"{self.debug_dir}/graph/cross_correlation_slice/{clip_name}"
        os.makedirs(graph_dir, exist_ok=True)
        plt.figure(figsize=(10, 4))
        plt.plot(correlation_slice)
        plt.plot(correlation_clip, alpha=0.7)
        plt.title("Cross-correlation between the audio clip and full track before slicing")
        plt.xlabel("Lag")
        plt.ylabel("Correlation coefficient")
        plt.savefig(f"{graph_dir}/{clip_name}_{index}_{section_ts}_{peak}.png")
        plt.close()

    def dump_pearson_windows(
        self,
        clip_name: str,
        windows: list[tuple[int, int, NDArray, NDArray, float]],
        index: int,
        section_ts: str,
        peak: int,
        best_idx: int,
    ) -> None:
        """windows: [(wl, wr, ds_slice, ds_clip, r)]"""
        plt = _plt()
        if plt is None:
            return
        ds_dir = f"{self.debug_dir}/graph/pearson_downsampled/{clip_name}"
        os.makedirs(ds_dir, exist_ok=True)
        for wi, (wl, wr, ds_s, ds_c, r) in enumerate(windows):
            marker = " *best*" if wi == best_idx else ""
            plt.figure(figsize=(10, 4))
            plt.plot(ds_s)
            plt.plot(ds_c, alpha=0.7)
            plt.title(f"Partitions {wl}-{wr} (pearson_r={r:.4f}){marker}")
            plt.xlabel("Sample")
            plt.ylabel("Correlation coefficient")
            plt.savefig(f"{ds_dir}/{clip_name}_{index}_{section_ts}_{peak}_w{wl}_{wr}.png")
            plt.close()

    def dump_peaks_json(
        self,
        clip_name: str,
        peaks: Any,
        seconds: list[float],
        similarities: list[Any],
        index: int,
        section_ts: str,
    ) -> None:
        peak_dir = f"{self.debug_dir}/debug/cross_correlation_{clip_name}"
        os.makedirs(peak_dir, exist_ok=True)
        with open(f"{peak_dir}/{index}_{section_ts}.txt", "w") as f:
            print(
                json.dumps(
                    {"peaks": peaks, "seconds": seconds, "similarities": similarities},
                    indent=2,
                    cls=NumpyEncoder,
                ),
                file=f,
            )

    def record_similarity(self, clip_name: str, index: int, similarity: float) -> None:
        self.similarity_log.setdefault(clip_name, []).append((index, similarity))

    # ── post-run ──

    def dump_similarity_scatter(self, clip_names: list[str], audio_name: str) -> None:
        plt = _plt()
        if plt is None:
            return
        for clip_name in clip_names:
            graph_dir = f"{self.debug_dir}/graph/mean_squared_error_similarity/{clip_name}"
            os.makedirs(graph_dir, exist_ok=True)
            entries = self.similarity_log.get(clip_name, [])
            x = [i for i, _ in entries]
            y = [s for _, s in entries]
            plt.figure(figsize=(10, 4))
            plt.scatter(x, y)
            ylimit = max(0.01, float(np.median(y))) if y else 0.01
            plt.ylim(0, ylimit)
            plt.title("Scatter Plot for Similarity")
            # The swapped/odd axis labels (x IS the chunk index, y IS the
            # similarity) replicate the reference artifact byte-for-byte
            # (reference: audio_pattern_detector.py:364-365) — debug
            # artifacts are parity surfaces, quirks included.
            plt.xlabel("Value")
            plt.ylabel("Sublist Index")
            plt.savefig(f"{graph_dir}/{audio_name}.png")
            plt.close()
