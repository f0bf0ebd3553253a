"""The streaming detector on a torch device.

A subclass of the JAX package's ``AudioPatternDetector``. The clip
preprocessing (host, f64), the offline ``find_clip_in_array``, the
timestamp algebra and the exact debug path are reused unchanged; the bank
is the port's (``_ensure_bank``) and so is the streaming loop
(``find_clip_in_audio``): the JAX loop decodes int16 checkpoint tails and
debug chunks through the JAX bank module, which imports jax. The device
is explicit and never silently replaced: asking for ``cuda`` without a
CUDA device raises.
"""

from __future__ import annotations

import sys
from collections import defaultdict, deque
from collections.abc import Callable
from typing import Any

import numpy as np
import torch
from numpy.typing import NDArray

from audio_pattern_detector_tpu import native
from audio_pattern_detector_tpu.models.detector import (
    AudioPatternDetector,
    PatternDetectedCallback,
    StreamCheckpoint,
    _dispatched_ready,
)
from audio_pattern_detector_tpu.utils.clip import AudioClip, AudioStream
from audio_pattern_detector_tpu.utils.profiling import RunStats, Stopwatch
from audio_pattern_detector_tpu_torch.models.bank import PatternBank


def resolve_device(device: "torch.device | str") -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False (pass device='cpu' to run the plain torch path)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def _f32_copy(samples: NDArray[Any]) -> NDArray[np.float32]:
    """An owned f32 array: int16 decodes bitwise as the device does."""
    return native.pcm16_to_f32_mono(samples) if samples.dtype == np.int16 else samples.copy()


class TorchAudioPatternDetector(AudioPatternDetector):
    """Two-step streaming pattern detector running its device work in torch."""

    def __init__(
        self,
        audio_clips: list[AudioClip],
        *,
        device: "torch.device | str",
        **kwargs,
    ) -> None:
        self.device = resolve_device(device)
        super().__init__(audio_clips, **kwargs)

    def _ensure_bank(self) -> PatternBank:
        if self._bank is None:
            self._bank = PatternBank(
                clip_datas=self._clip_datas,
                tone_frequencies=self._tone_frequencies,
                strategy_params=self._clip_strategy_params,
                sample_rate=self.target_sample_rate,
                chunk_samples=int(self.seconds_per_chunk * self.target_sample_rate),
                height_min=self.height_min if self.height_min is not None else 0.25,
                device=self.device,
            )
        return self._bank

    def find_clip_in_audio(
        self,
        audio_stream: AudioStream,
        on_pattern_detected: PatternDetectedCallback | None = None,
        accumulate_results: bool = True,
        checkpoint: "StreamCheckpoint | None" = None,
        on_checkpoint: "Callable[[StreamCheckpoint], None] | None" = None,
        pipeline_depth: int = 1,
        stream_batch: int = 1,
        stream_batch_mode: str = "scan",
    ) -> tuple[dict[str, list[float]] | None, float]:
        """Find clip occurrences in the audio stream: the JAX loop's
        contract (models/detector.py ``find_clip_in_audio``), with the same
        pipelining, stream batching, checkpoint emission, callback order
        and ``last_run_stats``.

        Returns (peak times per clip, or None when ``accumulate_results``
        is False; total stream time in seconds). Up to ``pipeline_depth``
        chunks (or batches of ``stream_batch`` chunks) stay in flight,
        collected eagerly in order. ``checkpoint``/``on_checkpoint`` give
        O(1) resume with checkpoints byte-identical to the JAX loop's.

        In debug mode each chunk runs the exact host path serially and
        writes its artifacts, as in the JAX loop; the port also runs the
        chunk through the device bank and reports on stderr any clip whose
        device positions differ from the host path's.
        """
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if stream_batch < 1:
            raise ValueError(f"stream_batch must be >= 1, got {stream_batch}")
        if stream_batch_mode not in ("scan", "vmap"):
            raise ValueError(
                f"stream_batch_mode must be 'scan' or 'vmap', got {stream_batch_mode!r}"
            )
        if audio_stream.sample_rate != self.target_sample_rate:
            raise ValueError(
                f"full_streaming_audio_clip {audio_stream.name} needs to be "
                f"{self.target_sample_rate} sample rate"
            )

        bank = self._ensure_bank()
        sr = self.target_sample_rate

        previous_chunk: NDArray[Any] | None = None
        total_time = 0.0
        i = 0
        if checkpoint is not None:
            if checkpoint.chunk_index < 0:
                raise ValueError(
                    f"checkpoint chunk_index must be >= 0, got {checkpoint.chunk_index}"
                )
            if checkpoint.chunk_index > 0 and checkpoint.previous_tail is None:
                # Without the tail the overlap-save subtract would be lost
                # and every timestamp would shift by sliding_window seconds.
                raise ValueError(
                    "checkpoint at chunk_index > 0 must carry the previous "
                    "chunk's lookback tail"
                )
            previous_chunk = checkpoint.previous_tail
            total_time = checkpoint.total_time
            i = checkpoint.chunk_index

        all_peak_times: dict[str, list[float]] | None = (
            {c.name: [] for c in self.audio_clips} if accumulate_results else None
        )
        stdout = audio_stream.audio_stream
        self._similarity_debug = defaultdict(list)
        max_sw = max((cd["sliding_window"] for cd in self._clip_datas.values()), default=1)
        # A stream of raw 16-bit PCM keeps its chunks int16 through dispatch
        # (the device decodes); only checkpoint tails, whose contract is f32
        # samples, and debug chunks decode on the host.
        sample_dtype = (
            audio_stream.resolved_dtype()
            if hasattr(audio_stream, "resolved_dtype")
            else np.dtype(np.float32)
        )
        read_bytes = (self._chunk_size // 4) * sample_dtype.itemsize
        tail_samples = int(max_sw * sr)

        stats = RunStats()
        watch = Stopwatch(stats)
        self.last_run_stats = stats

        def emit(index: int, had_prev: bool, clip_peaks: dict[str, list[int]]) -> None:
            chunk_matches: list[tuple[float, str]] = []
            for name, peak_times in self.peaks_to_times(clip_peaks, index, had_prev).items():
                if on_pattern_detected and peak_times:
                    chunk_matches.extend((t, name) for t in peak_times)
                if all_peak_times is not None:
                    all_peak_times[name].extend(peak_times)
            if on_pattern_detected and chunk_matches:
                chunk_matches.sort(key=lambda x: x[0])
                for timestamp, clip_name in chunk_matches:
                    on_pattern_detected(clip_name, timestamp)
            stats.detections += sum(len(v) for v in clip_peaks.values())

        # Single-chunk mode: (index, had_prev, dispatched, tail, cum_time)
        # per chunk in flight.
        pending: "deque[tuple[int, bool, Any, NDArray[np.float32] | None, float]]" = deque()

        def drain_one() -> None:
            p_i, p_prev, p_disp, p_tail, p_time = pending.popleft()
            with watch.segment("collect"):
                emit(p_i, p_prev, bank.collect_chunk(p_disp))
            if on_checkpoint is not None:
                on_checkpoint(StreamCheckpoint(p_i + 1, p_tail, p_time))

        # Batch mode: (chunk, had_prev, cum_time) buffered per batch, and
        # (dispatched, base index, buffered meta) per batch in flight.
        batch_buf: "list[tuple[NDArray[Any], bool, float]]" = []
        in_flight: "list[tuple[Any, int, list]]" = []
        chunk_samples = self._chunk_size // 4

        def drain_batch() -> None:
            dispatched, base_i, meta = in_flight.pop(0)
            with watch.segment("collect"):
                results = bank.collect_chunks_batch(dispatched)
            for k, (chunk_k, had_prev_k, time_k) in enumerate(meta):
                emit(base_i + k, had_prev_k, results[k])
                if on_checkpoint is not None:
                    on_checkpoint(
                        StreamCheckpoint(base_i + k + 1, _f32_copy(chunk_k[-tail_samples:]), time_k)
                    )

        def flush_batch() -> None:
            nonlocal previous_chunk
            if not batch_buf:
                return
            chunks = [c for c, _, _ in batch_buf]
            n_real = len(chunks)
            # A short final batch is zero-padded in the stream's dtype; the
            # padding's results are discarded.
            chunks += [
                np.zeros(chunk_samples, dtype=chunks[-1].dtype)
                for _ in range(stream_batch - n_real)
            ]
            with watch.segment("dispatch"):
                dispatched = bank.dispatch_chunks_batch(
                    chunks, previous_chunk if batch_buf[0][1] else None, mode=stream_batch_mode
                )
            in_flight.append((dispatched, i - n_real, list(batch_buf)))
            previous_chunk = batch_buf[-1][0]
            batch_buf.clear()
            while len(in_flight) > 1 and _dispatched_ready(in_flight[0][0]):
                drain_batch()
            if len(in_flight) > pipeline_depth:
                drain_batch()

        while True:
            with watch.segment("read"):
                in_bytes = stdout.read(read_bytes)
            if not in_bytes:
                break
            chunk = np.frombuffer(in_bytes, dtype=sample_dtype)
            total_time += len(chunk) / sr
            stats.chunks += 1
            stats.audio_seconds += len(chunk) / sr

            if self.debug_mode:
                if chunk.dtype == np.int16:
                    chunk = native.pcm16_to_f32_mono(chunk)
                host = self._process_chunk_debug(chunk, previous_chunk, i)
                self._report_device_disagreement(
                    i, host, bank.process_chunk(chunk, previous_chunk)
                )
                emit(i, previous_chunk is not None, host)
                previous_chunk = chunk
            elif stream_batch > 1:
                had_prev = previous_chunk is not None or bool(batch_buf)
                batch_buf.append((chunk, had_prev, total_time))
                i += 1
                if len(batch_buf) == stream_batch:
                    flush_batch()
                continue
            else:
                with watch.segment("dispatch"):
                    dispatched = bank.dispatch_chunk(chunk, previous_chunk)
                tail = _f32_copy(chunk[-tail_samples:]) if on_checkpoint is not None else None
                pending.append((i, previous_chunk is not None, dispatched, tail, total_time))
                # Eager in-order drain of every chunk already done, then the
                # in-flight cap.
                while len(pending) > 1 and _dispatched_ready(pending[0][2]):
                    drain_one()
                if len(pending) > pipeline_depth:
                    drain_one()
                previous_chunk = chunk
            i += 1

        flush_batch()
        while in_flight:
            drain_batch()
        while pending:
            drain_one()
        watch.finish()

        if self.debug_mode:
            self._debug_sink().dump_similarity_scatter(
                [c.name for c in self.audio_clips], audio_stream.name
            )
        return all_peak_times, total_time

    @staticmethod
    def _report_device_disagreement(
        index: int, host: dict[str, list[int]], device: dict[str, list[int]]
    ) -> None:
        for name, positions in host.items():
            if device.get(name) != positions:
                print(
                    f"debug: chunk {index} clip {name}: device positions "
                    f"{device.get(name)} differ from the host path's {positions}",
                    file=sys.stderr,
                )
