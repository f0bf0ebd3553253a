"""Library entry points of the port: ``match_pattern``, ``match_pattern_many``
and ``match_pattern_many_parallel``.

Ports of audio_pattern_detector_tpu/match.py's entry points of the same
names. The JAX functions build a plain ``EngineOptions``, whose detector
is the JAX one, so they cannot be reused; everything under them is
(pattern loading, the file-mode launch plan, the WAV and stdin stream
wrappers, checkpoint files, the offline batch scan, ``_scan``), with
``TorchEngineOptions`` choosing the port's detector and device. The
parallel multi-file scan reuses the JAX ``_scan_group_parallel`` without a
mesh: its slot recycling and callbacks are host code, and its session
dispatches through the port detector's bank.

``trace_dir`` wraps the run in the port's torch.profiler trace; the
reused ``_scan`` always gets ``trace_dir=None``, because its own trace is
``jax.profiler``'s. The mesh options are not ported.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable
from dataclasses import dataclass

from audio_pattern_detector_tpu.match import (
    EngineOptions,
    _auto_perf_chunk_seconds,
    _auto_perf_plan,
    _load_pattern_clips,
    _match_pattern_file,
    _match_pattern_wav_stdin,
    _opts_for_source,
    _scan_file_source,
    _scan_group_parallel,
)
from audio_pattern_detector_tpu.models.detector import PatternDetectedCallback
from audio_pattern_detector_tpu.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu.utils.clip import AudioClip
from audio_pattern_detector_tpu_torch.utils.profiling import device_trace


@dataclass
class TorchEngineOptions(EngineOptions):
    """EngineOptions whose detector runs on a torch device."""

    device: str = "cuda"

    def build_detector(self, clips: list[AudioClip]):
        from audio_pattern_detector_tpu_torch.models.detector import (
            TorchAudioPatternDetector,
        )

        return TorchAudioPatternDetector(
            audio_clips=clips,
            device=self.device,
            debug_mode=self.debug_mode,
            seconds_per_chunk=self.seconds_per_chunk,
            target_sample_rate=self.target_sample_rate,
            debug_dir=self.debug_dir,
            height_min=self.height_min,
        )


def match_pattern(
    audio_source: str | None,
    pattern_files: list[str],
    debug_mode: bool = False,
    on_pattern_detected: PatternDetectedCallback | None = None,
    accumulate_results: bool = True,
    seconds_per_chunk: int | None = 60,
    chunk_seconds_auto_perf: bool = False,
    from_stdin: bool = False,
    target_sample_rate: int | None = None,
    debug_dir: str = "./tmp",
    height_min: float | None = None,
    profile: bool = False,
    trace_dir: str | None = None,
    offline_batch: int | None = None,
    offline_batch_mode: str = "scan",
    pipeline_depth: int | None = None,
    stream_batch: int = 1,
    stream_batch_mode: str = "scan",
    checkpoint_file: str | None = None,
    device: str = "cuda",
) -> tuple[dict[str, list[float]] | None, float]:
    """Find pattern matches in an audio file or a WAV stream on stdin.

    The JAX ``match_pattern``'s contract (its docstring describes every
    option) on the torch ``device``: ``cuda`` (default; raises without a
    card) or ``cpu``."""
    if not from_stdin:
        if audio_source is None or not os.path.exists(audio_source):
            raise ValueError(f"Audio {audio_source} does not exist")

    sr = target_sample_rate if target_sample_rate is not None else DEFAULT_TARGET_SAMPLE_RATE
    opts = TorchEngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_seconds_auto_perf,
        target_sample_rate=sr,
        debug_mode=debug_mode,
        debug_dir=debug_dir,
        height_min=height_min,
        profile=profile,
        offline_batch=offline_batch,
        offline_batch_mode=offline_batch_mode,
        pipeline_depth=pipeline_depth,
        stream_batch=stream_batch,
        stream_batch_mode=stream_batch_mode,
        checkpoint_file=checkpoint_file,
        device=device,
    )
    opts.validate(from_stdin)
    pattern_clips = _load_pattern_clips(pattern_files, sr)

    with device_trace(trace_dir, device):
        if from_stdin:
            return _match_pattern_wav_stdin(
                pattern_clips, opts, on_pattern_detected, accumulate_results
            )
        assert audio_source is not None
        return _match_pattern_file(
            audio_source, pattern_clips, opts, on_pattern_detected, accumulate_results
        )


def match_pattern_many(
    audio_sources: list[str],
    pattern_files: list[str],
    on_pattern_detected: PatternDetectedCallback | None = None,
    on_file_start: Callable[[str], None] | None = None,
    on_file_end: Callable[[str, float], None] | None = None,
    accumulate_results: bool = True,
    seconds_per_chunk: int | None = 60,
    chunk_seconds_auto_perf: bool = False,
    target_sample_rate: int | None = None,
    height_min: float | None = None,
    profile: bool = False,
    trace_dir: str | None = None,
    offline_batch: int | None = None,
    offline_batch_mode: str = "scan",
    pipeline_depth: int | None = None,
    stream_batch: int = 1,
    stream_batch_mode: str = "scan",
    device: str = "cuda",
) -> list[tuple[dict[str, list[float]] | None, float]]:
    """Scan several audio files against one pattern bank, one after
    another, in one process: the JAX ``match_pattern_many``'s contract on
    the torch ``device``. Clips load and the bank builds once; the
    launch plan is sized from the longest file."""
    if not audio_sources:
        raise ValueError("No audio sources passed")
    for src in audio_sources:
        if src is None or not os.path.exists(src):
            raise ValueError(f"Audio {src} does not exist")

    sr = target_sample_rate if target_sample_rate is not None else DEFAULT_TARGET_SAMPLE_RATE
    opts = TorchEngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_seconds_auto_perf,
        target_sample_rate=sr,
        height_min=height_min,
        profile=profile,
        offline_batch=offline_batch,
        offline_batch_mode=offline_batch_mode,
        pipeline_depth=pipeline_depth,
        stream_batch=stream_batch,
        stream_batch_mode=stream_batch_mode,
        device=device,
    )
    opts.validate(from_stdin=False)
    pattern_clips = _load_pattern_clips(pattern_files, sr)

    if opts.chunk_auto_perf and opts.offline_batch is None:
        # One chunk size and batch width for the whole run, so every file
        # shares one bank (results are chunk-size- and batch-invariant).
        plans = [_auto_perf_plan(src, pattern_clips, sr) for src in audio_sources]
        opts.seconds_per_chunk = max(c for c, _ in plans)
        if opts.stream_batch == 1:
            opts.stream_batch = max(b for _, b in plans)

    # At most two detectors: the ffmpeg (non-WAV) path drops --height-min
    # (_opts_for_source).
    detectors: dict[float | None, object] = {}
    results: list[tuple[dict[str, list[float]] | None, float]] = []
    with device_trace(trace_dir, device):
        for src in audio_sources:
            src_opts = _opts_for_source(opts, src)
            if src_opts.height_min not in detectors:
                detectors[src_opts.height_min] = src_opts.build_detector(pattern_clips)
            if on_file_start is not None:
                on_file_start(src)
            result = _scan_file_source(
                src, detectors[src_opts.height_min], src_opts, on_pattern_detected,
                accumulate_results,
            )
            if on_file_end is not None:
                on_file_end(src, result[1])
            results.append(result)
    return results


def match_pattern_many_parallel(
    audio_sources: list[str],
    pattern_files: list[str],
    mesh_stream: int = 1,
    *,
    on_file_start: "Callable[[int, str], None] | None" = None,
    on_file_detect: "Callable[[int, str, str, float], None] | None" = None,
    on_file_end: "Callable[[int, str, float], None] | None" = None,
    accumulate_results: bool = True,
    seconds_per_chunk: int | None = 60,
    chunk_seconds_auto_perf: bool = False,
    target_sample_rate: int | None = None,
    height_min: float | None = None,
    pipeline_depth: int | None = None,
    n_slots: int | None = None,
    device: str = "cuda",
) -> list[tuple[dict[str, list[float]] | None, float]]:
    """Scan several audio files concurrently on the torch ``device``: the
    JAX ``match_pattern_many_parallel``'s contract on one device.

    One chunk from every in-flight file joins each round of a
    multi-stream session of ``n_slots`` rows on the port's bank (default
    ``min(n_files, 8)``); files take slots in input order and a finished
    file frees its slot for the next. Results equal the sequential scan
    of each file. Callbacks carry the file's input index and path and
    fire as rounds complete, so they interleave across files.
    ``pipeline_depth`` rounds stay in flight (default 3). Only
    ``mesh_stream=1`` runs: sharding rows across devices is not ported."""
    if mesh_stream != 1:
        raise ValueError("mesh_stream other than 1 is not supported by the torch port yet")
    if not audio_sources:
        raise ValueError("No audio sources passed")
    for src in audio_sources:
        if src is None or not os.path.exists(src):
            raise ValueError(f"Audio {src} does not exist")
    sr = target_sample_rate if target_sample_rate is not None else DEFAULT_TARGET_SAMPLE_RATE
    opts = TorchEngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_seconds_auto_perf,
        target_sample_rate=sr,
        height_min=height_min,
        pipeline_depth=pipeline_depth,
        device=device,
    )
    opts.validate(from_stdin=False)
    pattern_clips = _load_pattern_clips(pattern_files, sr)
    if opts.chunk_auto_perf:
        opts.seconds_per_chunk = max(
            _auto_perf_chunk_seconds(src, pattern_clips, sr) for src in audio_sources
        )
    slots = n_slots if n_slots is not None else min(len(audio_sources), 8)
    if slots < 1:
        raise ValueError(f"n_slots ({slots}) must be a positive multiple of mesh_stream (1)")
    depth = 3 if pipeline_depth is None else pipeline_depth

    # At most two detector variants: the ffmpeg (non-WAV) path drops
    # --height-min (_opts_for_source). Each runs its own session, files
    # grouped in input order.
    groups: dict[float | None, list[tuple[int, str]]] = {}
    for idx, src in enumerate(audio_sources):
        groups.setdefault(_opts_for_source(opts, src).height_min, []).append((idx, src))
    results: list[tuple[dict[str, list[float]] | None, float]] = [(None, 0.0)] * len(
        audio_sources
    )
    for hm, items in groups.items():
        detector = dataclasses.replace(opts, height_min=hm).build_detector(pattern_clips)
        _scan_group_parallel(
            detector, items, slots, None, depth, on_file_start, on_file_detect, on_file_end,
            accumulate_results, results,
        )
    return results

