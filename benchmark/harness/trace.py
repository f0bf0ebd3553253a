"""The device trace of a traced window, reduced to what the metrics read.

``torch.profiler`` records the window's device activity alone (CUPTI:
kernels, copies, memsets and the CUDA runtime calls that issued them; no
operator events, whose cost on the host would stretch the window); its
Chrome trace is read
back and reduced to: the window's length (the benchmark's own annotation
around it), the device's busy time (the union of kernel, copy and memset
intervals inside the window, not their sum), each kernel's launches and
time, and the idle gaps labelled by what the host was doing in each.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW_LABEL = "bench_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver", "cpu_op", "user_annotation"}
LABELLED_GAPS = 400


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict[str, list[float]] = field(default_factory=dict)  # name -> [launches, seconds]
    device_ops: list[list] = field(default_factory=list)
    idle_gaps: list[list] = field(default_factory=list)

    def kernel_time(self, substring: str) -> tuple[int, float]:
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if substring in name:
                n += int(c)
                s += t
        return n, s

    @property
    def device_s(self) -> float:
        """Kernel time summed (launches that overlap count each)."""
        return sum(t for _, t in self.kernels.values())


def record(fn) -> tuple[TraceSummary, object]:
    """Run ``fn()`` under the profiler inside the window annotation and
    reduce its trace. Returns (summary, what ``fn`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_LABEL):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events), out


def reduce(events: list[dict]) -> TraceSummary:
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if not timed:
        raise RuntimeError("the trace holds no event")
    win = [e for e in timed if e.get("name") == WINDOW_LABEL and e.get("cat") == "user_annotation"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:  # device activity only: the window is the span of everything traced
        w0 = min(float(e["ts"]) for e in timed)
        w1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    starts = np.array([float(e["ts"]) for e in dev])
    ends = starts + np.array([float(e.get("dur", 0.0)) for e in dev])
    keep = (ends > w0) & (starts < w1)
    starts, ends = np.clip(starts[keep], w0, w1), np.clip(ends[keep], w0, w1)
    dev = [e for e, k in zip(dev, keep) if k]
    kernels: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    by_op: dict[str, float] = defaultdict(float)
    for e, s, t in zip(dev, starts, ends):
        name = e["name"][:160]
        by_op[name] += (t - s) * 1e-6
        if e["cat"] == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += (t - s) * 1e-6
    busy, gaps = _union(starts, ends, w0, w1)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy * 1e-6,
        kernels=dict(kernels),
        device_ops=[[n, s] for n, s in top],
        idle_gaps=_label_gaps(gaps, events),
    )


def _union(starts: np.ndarray, ends: np.ndarray, w0: float, w1: float):
    """Busy microseconds of the intervals' union, and the idle gaps
    [(start, length)] between them inside [w0, w1]."""
    if len(starts) == 0:
        return 0.0, [(w0, w1 - w0)]
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    seg_s = s[idx]
    seg_e = np.append(reach[idx[1:] - 1], reach[-1])
    busy = float(np.sum(seg_e - seg_s))
    gaps = [(w0, seg_s[0] - w0)] if seg_s[0] > w0 else []
    gaps += [(a, b - a) for a, b in zip(seg_e[:-1], seg_s[1:])]
    if seg_e[-1] < w1:
        gaps.append((seg_e[-1], w1 - seg_e[-1]))
    return busy, gaps


def _label_gaps(gaps, events) -> list[list]:
    """The longest idle gaps, summed by the innermost host event running at
    each one's midpoint (a CUDA runtime call; "host (no traced call)" where
    the host ran its own code between calls)."""
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW_LABEL]
    hs = np.array([float(e["ts"]) for e in host]) if host else np.zeros(0)
    he = hs + np.array([float(e.get("dur", 0.0)) for e in host]) if host else np.zeros(0)
    order = np.argsort(hs)
    hs, he = hs[order], he[order]
    names = [host[i]["name"] for i in order]
    longest = sorted(gaps, key=lambda g: -g[1])[:LABELLED_GAPS]
    by_label: dict[str, float] = defaultdict(float)
    for start, length in longest:
        mid = start + length / 2
        k = int(np.searchsorted(hs, mid, side="right"))
        label, best = "host (no traced call)", None
        for j in range(k - 1, max(k - 4000, 0) - 1, -1):
            if he[j] > mid and (best is None or he[j] - hs[j] < best):
                label, best = names[j][:120], he[j] - hs[j]
        by_label[label] += length * 1e-6
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]
