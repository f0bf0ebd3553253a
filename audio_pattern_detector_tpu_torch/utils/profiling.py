"""Optional device trace around a run, on ``torch.profiler``.

Port of audio_pattern_detector_tpu/utils/profiling.py::device_trace, which
wraps a run in a ``jax.profiler`` trace. The per-stage wall-clock counters
of that module (``RunStats``, ``Stopwatch``) are jax-free and reused as
they are.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Iterator

import torch


@contextlib.contextmanager
def device_trace(trace_dir: "str | None", device: "torch.device | str" = "cpu") -> Iterator[None]:
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
