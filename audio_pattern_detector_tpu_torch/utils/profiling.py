"""Per-run performance counters, the port's span recorder, and an optional
device trace on ``torch.profiler``.

Port of audio_pattern_detector_tpu/utils/profiling.py: per-stage
wall-clock accounting (host read/decode, device dispatch, result
collection + emission) and a trace directory, here a ``torch.profiler``
Chrome trace instead of a ``jax.profiler`` one.

**Spans.** :data:`RECORDER` keeps spans (name, start and end on
``time.perf_counter_ns``, parent span, round id, two small integer
attributes) in a ring of fixed size, and named integer counters. It records
while a ``torch.profiler`` session runs (the CLI's ``--trace-dir``, a
benchmark's traced window, a user's ``profile()``) and inside
:func:`recording`; each time recording starts, a new stretch begins and the
ring is cleared, so :func:`spans` returns the last stretch's spans. The
port's layer boundaries test one flag, ``RECORDER.on``, and do nothing else
while it is false::

    span = RECORDER.open("collect.unpack") if RECORDER.on else -1
    ...
    if span >= 0:
        RECORDER.close(span)

A stretch takes one anchor pair (``perf_counter_ns``, ``time_ns``), which
puts its spans on the profiler's Chrome-trace timeline
(:meth:`Recorder.chrome_events`); :func:`device_trace` appends them to the
trace it writes, on a track of their own. The spans of a round:
``session.dispatch`` (the round's root) with, for each window class,
``bank.sections``, ``bank.pack``, ``bank.upload``, ``bank.launch``
(holding ``step.load`` and ``step.replay``, or ``step.capture`` at a key's
first use; in the "scan" schedule these three come once a row, in turn)
and ``bank.prefetch``; ``session.collect`` (a root with the dispatch's round
id) with ``collect.wait``, ``collect.unpack``, ``collect.flagged`` and
``collect.times``. Besides: ``file.read``, ``file.dispatch`` and
``file.collect`` (:class:`Stopwatch`), the ``serve.*`` phases of the
server's event loop, and ``python.gc`` for each collection while recording.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import time
from collections import deque
from collections.abc import Iterator
from dataclasses import dataclass
from typing import Any, NamedTuple

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


class Span(NamedTuple):
    """One recorded span. ``index`` numbers the process's spans in the
    order they started; ``parent`` is its parent's, -1 for a root."""

    index: int
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    parent: int
    round: int  # round id, -1 outside a round
    a: int  # the span's attributes (rows, a window, a route, a generation)
    b: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Recorder:
    """Spans and counters of the last stretch of recording, the newest
    ``size`` spans kept; ``dropped`` counts the spans the ring let go.

    ``on`` is the one flag a boundary reads: it holds while a
    ``torch.profiler`` session runs or a :func:`recording` context is
    open. A span opened while ``on`` is closed even if recording stops
    before it ends; one opened in an earlier stretch is ignored. One thread
    drives the port's layers at a time; the garbage collector's spans may
    interleave with any of them."""

    def __init__(self, size: int = 65536) -> None:
        self.size = size
        self.on = False
        self._profiler = False
        self._forced = 0
        self._rounds = itertools.count()
        self._next = itertools.count()
        self._gc_start = 0
        self._begin()

    # ── stretches ──

    def _begin(self) -> None:
        # A span is a list [index, name, start, end, parent, round, a, b]
        # (the fields of Span), its end 0 until it is closed.
        self._ring: deque[list] = deque(maxlen=self.size)
        self._open: list[list] = []
        self.recorded = 0  # spans of the stretch, those the ring let go included
        self.counters: dict[str, int] = {}
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def _update(self) -> None:
        on = self._profiler or self._forced > 0
        if on and not self.on:
            self._begin()
            gc.callbacks.append(self._gc)
        elif self.on and not on:
            gc.callbacks.remove(self._gc)
        self.on = on

    def profiler(self, enabled: bool) -> None:
        """``torch.profiler`` started or stopped (see :func:`_watch_profiler`)."""
        self._profiler = enabled
        self._update()

    @contextlib.contextmanager
    def recording(self) -> Iterator["Recorder"]:
        """Record inside the block (a new stretch unless already recording)."""
        self._forced += 1
        self._update()
        try:
            yield self
        finally:
            self._forced -= 1
            self._update()

    # ── boundaries (call only while ``on``) ──

    def next_round(self) -> int:
        """A round id, unique within the process."""
        return next(self._rounds)

    def open(self, name: str, t: "int | None" = None, round: "int | None" = None,
             a: int = 0, b: int = 0, root: bool = False) -> int:
        """Start a span at ``t`` (``perf_counter_ns``, now by default), a
        child of the innermost open span, or a root with ``root`` (which
        also forgets spans an exception left open). ``round`` defaults to
        the parent's. Returns its index."""
        if root:
            self._open.clear()
        span = self._store(name, time.perf_counter_ns() if t is None else t, 0, round, a, b)
        self._open.append(span)
        return span[0]

    def close(self, i: int, t: "int | None" = None) -> None:
        """End span ``i`` at ``t`` (now by default)."""
        end = time.perf_counter_ns() if t is None else t
        for k in range(len(self._open) - 1, -1, -1):
            if self._open[k][0] == i:
                self._open.pop(k)[3] = end
                return

    def add(self, name: str, t0: int, t1: int, a: int = 0, b: int = 0) -> None:
        """A finished span, a child of the innermost open span."""
        self._store(name, t0, t1, None, a, b)

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _store(self, name: str, t0: int, t1: int, round: "int | None", a: int, b: int) -> list:
        parent = self._open[-1] if self._open else None
        if round is None:
            round = parent[5] if parent else -1
        span = [next(self._next), name, t0, t1, parent[0] if parent else -1, round, a, b]
        self._ring.append(span)
        self.recorded += 1
        return span

    def _gc(self, phase: str, info: dict) -> None:
        if not self.on:
            return
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
        elif self._gc_start:
            self.add("python.gc", self._gc_start, time.perf_counter_ns(), info.get("generation", -1))
            self._gc_start = 0

    # ── reading ──

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._ring)

    def spans(self) -> list[Span]:
        """The stretch's finished spans in the ring, in the order they started."""
        return [Span(*span) for span in self._ring if span[3]]

    def wall_ns(self, t: int) -> int:
        """``perf_counter_ns`` reading ``t`` of this stretch as ``time_ns``."""
        perf0, wall0 = self.anchor
        return wall0 + (t - perf0)

    def chrome_events(self, base_ns: int) -> list[dict]:
        """The spans as Chrome-trace complete events on the timeline of a
        trace whose ``baseTimeNanoseconds`` is ``base_ns`` (a
        ``torch.profiler`` trace: an event's ``ts`` is microseconds from
        it), on one track of their own."""
        pid = "apd spans"
        events: list[dict] = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                               "args": {"name": "apd host spans"}}]
        for s in self.spans():
            events.append({
                "ph": "X", "cat": "apd_span", "name": s.name, "pid": pid, "tid": 0,
                "ts": (self.wall_ns(s.start_ns) - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"index": s.index, "parent": s.parent, "round": s.round, "a": s.a, "b": s.b},
            })
        return events


RECORDER = Recorder()


def spans() -> list[Span]:
    """The spans of the last stretch of recording (see :class:`Recorder`)."""
    return RECORDER.spans()


def counters() -> dict[str, int]:
    """The counters of the last stretch of recording."""
    return dict(RECORDER.counters)


def recording() -> "contextlib.AbstractContextManager[Recorder]":
    """Record spans and counters inside the block, with or without a profiler."""
    return RECORDER.recording()


def _watch_profiler() -> None:
    """Let :data:`RECORDER` follow ``torch.profiler``: every profiler
    session (whatever its activities) sets and clears
    ``torch.autograd.profiler._is_profiler_enabled`` through
    ``_set_is_profiler_enabled``, which is wrapped here once a process."""
    from torch.autograd import profiler as autograd_profiler

    setter = getattr(autograd_profiler, "_set_is_profiler_enabled", None)
    if setter is None or getattr(setter, "apd_recorder", None) is RECORDER:
        return

    def set_enabled(enable: bool) -> None:
        setter(enable)
        RECORDER.profiler(bool(enable))

    set_enabled.apd_recorder = RECORDER  # type: ignore[attr-defined]
    autograd_profiler._set_is_profiler_enabled = set_enabled
    RECORDER.profiler(bool(getattr(autograd_profiler, "_is_profiler_enabled", False)))


_watch_profiler()


class Stopwatch:
    """Accumulates named wall-clock segments onto a RunStats; while
    recording, each segment is also a span ``file.<name>``."""

    def __init__(self, stats: RunStats) -> None:
        self.stats = stats
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        span = RECORDER.open(f"file.{name}") if RECORDER.on else -1
        try:
            yield
        finally:
            if span >= 0:
                RECORDER.close(span)
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
    device's kernels and copies beside the host's ops, and the run's spans
    on a track of their own ("apd host spans"), on the same timeline."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:  # which turns the recorder on
        yield
    name = f"apd_torch_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    path = os.path.join(trace_dir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(RECORDER.chrome_events(int(doc["baseTimeNanoseconds"])))
    with open(path, "w") as f:
        json.dump(doc, f)
