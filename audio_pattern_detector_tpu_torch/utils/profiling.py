"""Per-run performance counters and an optional device trace on ``torch.profiler``.

Port of audio_pattern_detector_tpu/utils/profiling.py: per-stage
wall-clock accounting (host read/decode, device dispatch, result
collection + emission) and a trace directory, here a ``torch.profiler``
Chrome trace instead of a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Iterator
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class RunStats:
    """Wall-clock accounting for one detector run."""

    chunks: int = 0
    audio_seconds: float = 0.0
    read_seconds: float = 0.0  # host I/O + PCM decode + resample
    dispatch_seconds: float = 0.0  # section assembly + device enqueue
    collect_seconds: float = 0.0  # blocking on device results + emission
    wall_seconds: float = 0.0
    detections: int = 0

    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "chunks": self.chunks,
            "audio_seconds": round(self.audio_seconds, 6),
            "read_seconds": round(self.read_seconds, 6),
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "collect_seconds": round(self.collect_seconds, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "detections": self.detections,
            "realtime_factor": round(self.realtime_factor(), 2),
        }


class Stopwatch:
    """Accumulates named wall-clock segments onto a RunStats."""

    def __init__(self, stats: RunStats) -> None:
        self.stats = stats
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            setattr(
                self.stats,
                f"{name}_seconds",
                getattr(self.stats, f"{name}_seconds") + time.perf_counter() - t,
            )

    def finish(self) -> None:
        self.stats.wall_seconds = time.perf_counter() - self._t0


@contextlib.contextmanager
def device_trace(trace_dir: "str | None", device: "torch.device | str" = "cuda") -> Iterator[None]:
    """Trace the enclosed run with torch.profiler and write it to
    ``trace_dir`` as a Chrome trace (``apd_torch_<time>_<pid>.json``); a
    no-op when ``trace_dir`` is None. On a CUDA device the trace holds the
    device's kernels and copies beside the host's ops."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = f"apd_torch_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(trace_dir, name))
