"""Recordings scanned one after another, as ``match`` scans a folder: a
detector built once with the options the flag-free CLI sets for a WAV
(``_auto_perf_plan``'s chunks and launch width, pipeline depth 3, batch
mode scan), then ``_scan_file_source`` a file at a time. A traffic file's
``engine`` object sets ``TorchEngineOptions`` fields beyond those (for
example ``height_min``); nothing else is passed, so a change of a default
is measured.

A driver module gives the harness a ``Driver`` (set-up, warm-up, the
window, the program's outputs for the check) and, for the check and its
control alike, ``population`` (what a sample is drawn from), ``inputs``
(the samples one sampled item covers) and ``served_whole`` (what the
control takes as served).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np

from harness import port
from harness.cell import Cell
from harness.traffic import Traffic, write_wav_int16


def served_whole(traffic: Traffic, rounds: int) -> list[int]:
    """Every recording, as the control takes them."""
    return list(range(len(traffic.streams)))


def population(traffic: Traffic, served: list[int]) -> tuple[list, list]:
    """(recording, chunk) pairs of the recordings ``served``: all of them,
    and those holding an airing."""
    n_chunks = len(traffic.streams[0].samples) // traffic.chunk_samples
    every = [(f, i) for f in served for i in range(n_chunks)]
    marked = [(f, i) for f in served for i in sorted(traffic.streams[f].marked) if i < n_chunks]
    return every, marked


def inputs(traffic: Traffic, item: tuple[int, int]) -> tuple[np.ndarray, np.ndarray | None, int]:
    """(chunk, the chunk before it or None, its index) of a sampled pair."""
    f, i = item
    return traffic.chunk(f, i), traffic.chunk(f, i - 1) if i > 0 else None, i


class Driver:
    """Recordings written as WAVs under ``workdir``, scanned in turn."""

    def __init__(self, cell: Cell, traffic: Traffic, ref_clips: list, device: str, workdir: Path) -> None:
        from audio_pattern_detector_tpu_torch import match as apd_match

        self._match = apd_match
        sr = traffic.rate
        self.traffic = traffic
        self.paths = []
        for i, s in enumerate(traffic.streams):
            path = workdir / f"recording_{i:02d}.wav"
            write_wav_int16(path, s.samples, sr)
            self.paths.append(str(path))
        # Flushed in set-up, so that the kernel's writeback of the recordings
        # does not run inside the window and take the scan's memory traffic.
        for p in self.paths:
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        clips = port.program_clips(cell, ref_clips)
        opts = apd_match.TorchEngineOptions(
            **{"seconds_per_chunk": int(cell.config["chunk_seconds"]), "chunk_auto_perf": True,
               "target_sample_rate": sr, "device": device, **port.engine_options(cell)})
        opts.validate(from_stdin=False)
        if opts.chunk_auto_perf:
            plans = [apd_match._auto_perf_plan(p, clips, sr) for p in self.paths]
            opts.seconds_per_chunk = max(c for c, _ in plans)
            if opts.stream_batch == 1:
                opts.stream_batch = max(b for _, b in plans)
        self.opts = opts
        self.detector = opts.build_detector(clips)
        self.passes: dict[int, list[list[tuple[str, float]]]] = {}
        self.next_file = 0

    def scan_one(self, keep: bool = True) -> tuple[int, float, float]:
        """Scan the next recording; (chunks, audio seconds, read seconds)."""
        i = self.next_file % len(self.paths)
        self.next_file += 1
        events: list[tuple[str, float]] = []
        self._match._scan_file_source(self.paths[i], self.detector, self.opts,
                                      lambda name, t: events.append((name, t)), True)
        if keep:
            self.passes.setdefault(i, []).append(events)
        st = self.detector.last_run_stats
        return st.chunks, st.audio_seconds, st.read_seconds

    def warm(self) -> None:
        """Every shape a scan uses: the first chunk without lookback, full
        launches and the padded last launch, in the recordings' int16."""
        self.scan_one(keep=False)
        self.next_file = 0

    def run(self, seconds: float) -> dict:
        """Recordings, whole, until ``seconds`` have passed; the window ends
        when the last recording begun ends."""
        chunks = 0
        audio = read = 0.0
        pack0 = port.pack_seconds()
        bank = self.detector._ensure_bank()
        reruns0 = port.reruns(bank)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        files = 0
        per_file = []
        while time.perf_counter() < deadline:
            t = time.perf_counter()
            c, a, r = self.scan_one()
            per_file.append(time.perf_counter() - t)
            chunks += c
            audio += a
            read += r
            files += 1
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "chunks": chunks, "audio_s": audio, "read_s": read,
                "pack_s": port.pack_seconds() - pack0, "files": files, "attempted": chunks, "per_file": per_file,
                "reruns": port.delta(port.reruns(bank), reruns0)}

    def launch_bounds(self) -> dict:
        return port.launch_bounds(self.detector._ensure_bank(), rows=1)

    def served(self) -> list[int]:
        return sorted(self.passes)

    def close(self) -> None:
        """Frees the program's state; the events the window emitted stay."""
        for p in self.paths:
            Path(p).unlink(missing_ok=True)
        self.detector = None

    def pairs(self, sample: list[tuple[int, int]], ref) -> list:
        """Each sampled (recording, chunk) against every pass the window
        made over that recording. Of a pass only events in the chunk's
        interior count as its own: its edges hold the neighbouring chunks'
        lookback detections."""
        chunk_s = self.traffic.chunk_samples / self.traffic.rate
        edge = ref.max_sw + max(len(p.clip.audio) for p in ref.prepared) / ref.rate + 1.0
        out = []
        for f, i in sample:
            expected = ref.detect(*inputs(self.traffic, (f, i)))
            lo, hi = i * chunk_s, (i + 1) * chunk_s
            for events in self.passes.get(f, []):
                near = [e for e in events if lo - edge - 1.0 <= e[1] <= hi + 1.0]
                out.append((expected, near, (lo + 1.0, hi - edge)))
        return out
