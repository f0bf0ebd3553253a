"""Stations served as ``serve --max-streams N`` builds its session (serve's
own defaults: the tile of ``min(16, N)`` rows, batch mode scan), one
``dispatch`` and its ``collect`` a round, which is what ``feed`` runs,
round after round. A traffic file's ``engine`` object sets the detector's
options beyond its defaults (for example ``height_min``), its ``session``
object ``MultiStreamSession``'s (``tile``, ``batch_mode``).

The module's functions are those every driver gives (see
``drivers/file_scan.py``).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from harness import port
from harness.cell import Cell
from harness.traffic import Traffic


def served_whole(traffic: Traffic, rounds: int) -> int:
    """``rounds`` rounds, as the control takes them."""
    return rounds


def population(traffic: Traffic, rounds: int) -> tuple[list, list]:
    """(station, round) pairs of ``rounds`` rounds: all of them, and those
    whose chunk holds an airing."""
    order, p = traffic.order, len(traffic.pool)
    marked_pool = traffic.streams[0].marked
    every = [(s, r) for r in range(rounds) for s in range(order.shape[0])]
    marked = [(s, r) for s, r in every if order[s][r % p] in marked_pool]
    return every, marked


def _chunk(traffic: Traffic, station: int, r: int) -> np.ndarray:
    return traffic.chunk(0, int(traffic.order[station][r % traffic.order.shape[1]]))


def inputs(traffic: Traffic, item: tuple[int, int]) -> tuple[np.ndarray, np.ndarray | None, int]:
    """(chunk, the station's chunk before it or None, the round) of a
    sampled (station, round)."""
    s, r = item
    return _chunk(traffic, s, r), _chunk(traffic, s, r - 1) if r > 0 else None, r


class Driver:
    """``stations`` stations fed from the pool in their seeded orders."""

    def __init__(self, cell: Cell, traffic: Traffic, ref_clips: list, device: str, workdir: Path) -> None:
        from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
        from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession

        self.traffic = traffic
        self.n = int(traffic.order.shape[0])
        detector = TorchAudioPatternDetector(audio_clips=port.program_clips(cell, ref_clips), device=device,
                                             **port.engine_options(cell))
        session = {"tile": min(16, self.n), **cell.traffic.get("session", {})}
        self.session = MultiStreamSession(detector, self.n, **session)
        self.results: list[list[dict[str, list[float]]]] = []
        self.latencies: list[float] = []
        self.dispatch_s: list[float] = []

    def round(self, r: int) -> tuple[float, float, list]:
        chunks = [_chunk(self.traffic, s, r) for s in range(self.n)]
        t0 = time.perf_counter()
        handle = self.session.dispatch(chunks)
        t1 = time.perf_counter()
        res = self.session.collect(handle)
        t2 = time.perf_counter()
        return t2 - t0, t1 - t0, res

    def warm(self) -> None:
        """The cell's one key (a full round of int16 rows), twice, then every
        station back at its start."""
        for r in range(2):
            self.round(r)
        for s in range(self.n):
            self.session.reset(s)

    def run(self, seconds: float) -> dict:
        pack0 = port.pack_seconds()
        reruns0 = port.reruns(self.session._bank)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        start = len(self.results)
        while time.perf_counter() < deadline:
            lat, disp, res = self.round(len(self.results))
            self.latencies.append(lat)
            self.dispatch_s.append(disp)
            self.results.append(res)
        wall = time.perf_counter() - t0
        rounds = len(self.results) - start
        return {"wall_s": wall, "rounds": rounds, "rows": rounds * self.n,
                "latencies": self.latencies[start:], "dispatch": self.dispatch_s[start:],
                "pack_s": port.pack_seconds() - pack0, "attempted": rounds * self.n,
                "reruns": port.delta(port.reruns(self.session._bank), reruns0)}

    def launch_bounds(self) -> dict:
        return port.launch_bounds(self.session._bank, rows=1)

    def served(self) -> int:
        return len(self.results)

    def close(self) -> None:
        """Frees the program's state; what ``collect`` returned stays."""
        self.session = None

    def pairs(self, sample: list[tuple[int, int]], ref) -> list:
        """Each sampled (station, round): the reference on that station's
        chunk with the chunk before it, against what ``collect`` returned
        for it."""
        out = []
        for s, r in sample:
            prog = [(c, t) for c, ts in self.results[r][s].items() for t in ts]
            out.append((ref.detect(*inputs(self.traffic, (s, r))), sorted(prog, key=lambda e: (e[1], e[0])), None))
        return out
