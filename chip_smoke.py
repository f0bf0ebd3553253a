#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's main paths, file-mode ``match`` and live serving, on the
card and checks them:

1. device: card name and power limit (nvidia-smi), torch and CUDA
   versions, the kernel build from the sources in this checkout;
2. the candidate-scan kernel against its plain torch version on the card,
   at the flagship shapes (32 x 495,999 and 32 x 489,999), bitwise, with
   one valid length and with per-row lengths; the median ms per call of
   each over 5 CUDA-event pairs, each around 30 back-to-back calls, the
   kernel's own device time from torch.profiler, its time with the L2
   flushed (a 128 MB write before each call), its device time and
   bitwise equality at a threshold of 0 (every sample at or above it: the
   kernel's slowest input), the share of samples at or above the
   threshold, and its bound (bytes over 3.35 TB/s) and share of the bound;
   then bitwise at the edge shapes (L of 1, 3, 4,095-4,098, 8,193, 8,194;
   G of 1, 3, 64; and the shapes of EDGE_WIDE, where each CTA walks
   several tiles and rows; valid_len 0, 1, 2, L-1, L and mixed per-row
   lengths; thresholds few samples reach and thresholds every one does);
3. the flagship step (64-clip bank, one 60 s section at 8 kHz) through
   the port's class step with the kernel and with the plain scan:
   identical payloads, ms per step (alternating kernel and plain);
   2b. the kernel at the shapes a batched round of 16 sections gives it,
   (512, 495,999) and (512, 489,999), with per-row lengths that mix full,
   short, lead-in-only (m - 1) and zero rows: bitwise equal to the plain
   version, probed rows equal to the same row scanned alone, wrapper ms,
   device ms and share of the bound for the mixed lengths and for every
   row full; then bitwise at 4,416 rows of 495,999 samples (flat offsets
   past 32 bits; the plain version 32 rows at a time);
   3b. the batched flagship step (the same bank, 16 sections) as one
   ``mode="vmap"`` step against 16 ``scan`` steps: payloads bitwise equal
   row for row, with the kernel and with the plain scan; 2 kernel launches
   a round against 32; the schedules' f32 intermediates bitwise equal
   (LUFS, normalised sections, every row's correlation; their largest
   differences printed, each 0); ms per round of both in turns
   (vmap, scan, scan, vmap, twice; 3 rounds each), median and range; peak
   memory of both; the kernel, bitwise and timed, on the round's own two
   launches;
   3d. rows that do not depend on their round (``round_invariance``): on
   the flagship bank, 17 sections of 61 s (phase 7's route sections, a
   half-length and a zero-length row, noise), each row's LUFS, normalised
   section and correlation in rounds of 1, 5, 16 and 17 rows, and its
   payload there in both schedules, eager and captured, bitwise its
   single-section results; the row rerun's correlation and payload bitwise
   the class step's row and the class rerun's; one cuFFT plan at each of
   the class step's call sites giving a transform the same bits at every
   index of its fixed batch and on every call; the loudness gate
   (``csrc/loudness_gate.cu``, a row's pieces over ceil(P / 8) CTAs)
   bitwise its plain version on the round's rows and on silent, short and
   partial-length rows, each also alone, and on pools of 64 rows at 8 kHz
   and 6,004 Hz in rounds of 1, 3, 16, 17 and 64 rows, each row also
   alone; its device ms, wrapper ms, plain ms and byte bound on the 16-row
   round and one row, its CTAs a row, and its launches on the phase's
   paths and on file mode (phases 4-5);
   3e. the class step's device time split by stage
   (``scripts/profile_stages_torch.py``: the K-weighting, the gate, the
   normalisation, the segment spectra, each group's correlation, scan,
   lean greedy and lean tail, beside the whole eager step) on file mode's
   one-clip step, the flagship step and the 16-row flagship round;
   3f. the correlation kernel (``correlate_kernel``,
   ``csrc/correlate_os.cu``: the bank product, the inverse transforms in
   shared memory, a CTA a transform up to fft_len 32,768 and a cluster of
   CTAs past it, and the kept samples' ``abs``) on the same three shapes'
   own inputs and on the rainbow intro clip's file-mode step (fft_len
   131,072), each group: sampled transforms bitwise its numpy
   transliteration (``np_correlate_transforms``), the whole output within
   1e-5 of each row's maximum of the plain version (the cuFFT route), on
   sampled rows its error against the f64 correlation no more than twice
   the cuFFT route's; in turns its device ms and the plain version's (a
   graph of 20 calls), its wrapper ms, ``torch.fft.irfft`` over the same
   products (the library call), bound and share, cluster size and CTAs an
   SM; every fft_len from
   8,192 to 262,144 on seeded spectra, sampled transforms bitwise and the
   output within 1e-5 of the cuFFT route's; on the round a row bitwise the
   same in rounds of 1, 5, 16 and 17 rows and a graph replay bitwise the
   eager call; its launches on the captured flagship step and round in
   both schedules and on file mode (phases 4-5), with no call of the cuFFT
   route at the correlation site;
   3g. the rainbow intro clip's classes on the card (``correlate_flows``):
   its golden flow and the mixed bank's 3 x 3 matrix
   (tests/test_integration_matching.py:115-117) through the port's
   ``match``, stdout byte-identical to the CPU run, each pattern's
   detections, the correlation kernel launched and the cuFFT route never
   called;
4. file mode through the port's CLI, in-process: the golden JSONL flows
   (.claude/skills/verify/SKILL.md), including the zero-detection checks;
5. the scan-batch path: cbs_news_audio_section.wav tiled 15 times
   (about 482 s, 60 s chunks, 5 per launch) gives 15 detections, equal to
   an unbatched run of the same file; x-realtime of both runs;
6. the kernel's launch count over the flag-free runs of phases 4-5 (reset
   just before phase 4, read just after the batched run) and the flagged
   rows that took the exact host path; then the kernel, bitwise and timed,
   on the inputs of the flagship step's two launches (phase 3) and of the
   unbatched file-mode run's first launch (phase 5), with the share of
   their samples at or above the threshold;
7. the wide rerun of flagged rows on the flagship bank (64 clips, 61 s
   sections built from numpy seeds): a section per route (one flooded
   normal row: a row rerun; six: a class rerun; a dense marker row past
   the 1,024-lane cap: an escalated rerun; one marker hit: no rerun). Every
   flagged row's detections must equal the exact host path's; the route
   counters must show each route. Prints the ms of a row and a class
   rerun, of a capped and an escalated marker row beside PR 11's, the lane
   greedy's launches over the routes (on the kernels line); a row rerun's
   payload must equal the same row of a class rerun bit for bit (G = 1
   clip against the class's G, phase 3d);
8. every single-process entry point of the port's CLI in a subprocess
   (``--stdin``, ``--multiplexed-stdin``, ``--offline-batch 4`` and
   ``--stream-batch 4``, each in ``scan`` and in ``vmap`` mode,
   ``--checkpoint-file`` run to the end and resumed after an interrupted
   run, ``--debug``, ``--trace-dir``, two files, ``--height-min 0``): stdout
   byte-identical to the JAX CLI's (pinned; a vmap run's equals its scan
   twin's), at least one kernel launch (4 for a scan batch of 4 rows, 1
   for its vmap twin), and jax never imported;
9. the serving session (``MultiStreamSession``) on the flagship detector,
   16 slots, tile 16, 2 rounds in flight, once with ``batch_mode="scan"``
   and once with ``"vmap"``: 12 seeded streams of 60 s chunks (one int16,
   one ending after its first chunk, one starting in the second round,
   one carrying phase 7's flooded row) give each stream the serial
   engine's detections exactly; the first round runs tiles of 8, 2 and 1
   rows; the flooded row takes a row rerun and no row the host path; the
   kernel launches once per row and group in scan and once per dispatch
   and group in vmap (each counted from 0 around its run). The kernel
   equals its plain version bitwise on a round's zero-length, short and
   full rows, one at a time and as one batched step. Prints ms per 16-row
   round and the aggregate x-realtime of both modes, timed in turns
   (vmap, scan, scan, vmap; 3 pipelined rounds each), and the peak memory,
   then, in turns (4 each), the host time of one 16-row scan round's
   dispatch and collect beside 16 single-chunk dispatches and their
   collects on the same bank;
10. the port's ``serve`` in a subprocess (4 slots, the RTHK toml and the
   CBS clip): 4 concurrent clients (RTHK, CBS, CBS tiled 15 times, RTHK)
   get the pinned JAX ``match --stdin`` events, the tiled file the port's
   own ``match --stdin`` events (15 detections); a 5th client gets
   "server full"; after SIGINT the server reports a kernel launch and no
   jax. Prints the wall time per client;
   3c. the general-plateau tier (``height_min = 0``) as a captured step,
   its lane greedy one kernel launch a group and each verifier one launch
   of every lane, against its eager step on the same bank: the 16-row flagship
   round in both batch modes, payloads bit for bit; in turns, host ms until
   the dispatch returns and until the payload is on the host (a captured
   vmap dispatch must return in under half the time to its payload), the
   device span of the dispatch, beside PR 11's; the key's capture seconds,
   first-use peak and kept graph pools, the eager round's peak, one scan
   and one lane greedy launch per group per replay (on the kernels line),
   profiled device-busy ms of a captured and an eager vmap round, the lean
   tier's captured round;
   8 also runs the mesh entry points on logical shards of the card
   (``APD_TORCH_LOGICAL_DEVICES``): ``--mesh-time 4``, ``--mesh-time 2
   --mesh-bank 2`` and ``--mesh-stream 2`` over two files, stdout
   byte-identical to the pinned text with the predicted kernel launches,
   and ``--mesh-time 64`` failing with the JAX message;
   9 also reads the bank's ``dispatch_phase_seconds`` over the steady
   rounds of both modes (sections, pack, upload, launch, prefetch; ms a
   round and share of the round), once more with raw int16 rows (half the
   upload bytes), and drives the 12 streams through
   ``MultiStreamSession(mesh=make_mesh({"stream": 2}))`` on two logical
   shards: the serial engine's detections, the unsharded run's routes, one
   launch per round, shard and group;
   10 runs a second time as ``serve --mesh-stream 2``;
11. the device mesh on logical shards of the card (every shard's work runs
   on the one card, one after another; with more cards the same code
   spreads over them): 11a. time sharding at full width: the flagship
   bank plus the CBS clip (65 clips, 3 groups), ``make_mesh({"time": 4})``,
   the 482 s tiled file as one stream of 60 s chunks (two full slabs and a
   short one): detections equal to the serial engine's (15 of the CBS
   clip), the same run with the plain scan substituted gives every cell's
   payload bit for bit, one kernel launch per active cell and group (27),
   wall time beside the serial engine's, peak memory; 11b. ``bank x time``
   and ``stream x time`` (2 x 2 each) over two of phase 9's streams, equal
   to the serial engine; 11c. ``flagship.dryrun_multichip(8)``: the bank on
   a ``bank x stream x time`` mesh (2 x 2 x 2), one slab, and a sharded
   serving round, equal to the serial engine and the unsharded round;
12. the mesh paths in two processes on the card (a gloo group over
   127.0.0.1; each process runs from a fresh copy of the package, so the
   two build the kernel library at once): ``MultiStreamSession`` over a
   ``stream`` mesh of 2 spanning the processes, 8 local streams each of
   60 s chunks on the flagship bank, 3 rounds, every stream equal to one
   process's 16-row vmap session; ``ShardedDetector`` ``stream(2) x
   time(2)``, one stream of the tiled file a process with the 65-clip bank
   of 11a, equal to the serial engine; kernel launches per process and
   their sum, wall per process beside the one-process run;
13. the class-step switches of the JAX package that the port reads
   (``APD_PALLAS=0``, ``APD_MARKER_GEMM``), each set around its bank's construction and run,
   on a 16-row round of int16 chunks and on phase 9's streams: payloads
   and detections equal to the default's (the mask tier has no
   near-collapse flag), f32 intermediates within tolerance, the DFT-GEMM
   (the plain marker verifier's spectra) at f32 with TF32 allowed; on the
   card ``APD_MARKER_GEMM`` runs the same fused marker kernel as the
   default (its launches and keys recorded); ms per round beside the
   default's, kernel launches (0 under ``APD_PALLAS=0``);
14. the captured class step (``models/captured.py``; every phase above
   runs it, the port's default on the card) against the eager one on the
   same bank (its ``capture`` switched off): payloads bit for bit on the
   flagship step, the 16-row flagship round in both modes, the mask tier's
   round and a bank-sharded chunk on 2 logical shards; detections, routes
   and stream times on phase 9's session in both modes and on a 2-shard
   stream mesh; ms in turns (eager, captured, captured, eager, twice) for
   the step, both rounds, the session and file mode's x-realtime on the
   tiled 482 s file; launch calls, graph launches and device-busy share
   under torch.profiler; each key's capture seconds, replays and kernel
   launches a replay; the memory a key's first use took and what the graph
   pools kept;
16. candidate-free groups skip the captured verify tail (a CUDA
   conditional node) and the pinned staging pool: a flagship detector's
   captured step against its eager step, payloads
   bit for bit on the flagship step's candidate-free section, phase 7's
   sections and one with hits in both groups, a candidate-free 16-row round
   and one with a single hit-bearing row (both modes), a chunk on 2 bank
   shards; detections, routes and stream times on phase 9's session in
   both modes, with accepted hits in both groups of one section (so both
   bodies ran); the node's route; under torch.profiler the kernels only the
   verifiers launch (the eager step's that a candidate-free replay does not
   run), and how many of them the trace of a replay with hits in both
   groups records; profiled device-busy ms for the step and the rounds; the
   pinned host allocations of a first and of a steady 16-row serving round
   (none in a steady one). A node that cannot be captured raises. It runs
   before 15;
17. rounds wider than a graph: a key's graph is at most ``GRAPH_ROWS``
   (W) rows, and a wider round is ceil(B / W) replays of it (the eager
   step runs it in the same W-row steps). On the flagship bank,
   general-plateau vmap rounds of 96 and 112 rows and a lean one of 128:
   each eager round first (its peak memory), then captured twice, payloads
   bit for bit the eager round's, one kernel launch per group per replay,
   the peak memory reserved with the pools included and what the pools
   keep; then in each tier, captured, in turns, W + 1 rows against W rows
   and B = 4W as one graph of B rows against 4 replays, host ms to the
   payload and the dispatch's device span. Nothing falls back to the eager
   step;
18. the lean greedy in the captured step (its kernel on the card):
   payloads bit for bit between the default bank, a bank whose while nodes
   count their passes and the eager step, on the flagship step's
   candidate-free section and a hit-bearing one, and on 16-row rounds
   without and with a hit-bearing row; no graph holds a while node, one
   lean greedy launch per group per replay; the default bank's device ms
   from CUDA events beside PR 11's while-node and unrolled forms;
19. the 17 real broadcast captures of ``sample_audios/regressions/``
   (tests/test_real_data_regressions.py's cases, read from its source)
   through ``match_pattern`` on the card and on the CPU: equal detections
   and totals, flagged rows by route, the share of scanned samples at or
   above the threshold, the lean greedy's launches and inputs;
20. the greedy kernels (``greedy_kernels``): the lean greedy
   (``csrc/lean_greedy.cu``) and the lane greedy (``csrc/lane_greedy.cu``)
   bitwise against their plain versions on the flagship step's and a 16-row
   round's own launches with and without hits (the lean tier's, and the
   general-plateau tier's at ``height_min = 0``), the CPU tests' named
   cases, phase 19's regression captures and K = 1,024, 4,728 and 16,384
   lanes; device ms (CUDA events around a graph of calls), wrapper ms,
   plain ms, the bound from each input's own work and its share, and each
   kernel's launches on the paths that run it (phases 3b, 3c, 4-5, 7, 18,
   19, counted from 0 around each);
21. the verify kernels (``verify_kernels``): ``csrc/verify_normal.cu`` and
   the fused ``csrc/verify_marker.cu`` (spectra and decisions) against
   their plain versions on the flagship step's and a 16-row round's own
   hit-bearing calls (both schedules, each captured against eager), the
   general-plateau round's, the escalated marker row's, phase 19's
   regression captures' and the CPU tests' named cases (the marker's under
   both ``APD_MARKER_GEMM`` values of the plain version, a 2 s marker in
   the kernel's global-workspace form, and a 52 s marker whose 4,158
   frames' results sit in that workspace too): accept bitwise, similarity and r
   within tolerance on live lanes, the marker kernel's magnitudes within
   1e-5 of each window's largest bin of the exact (f64) rfft (torch's
   own error beside it); device ms (a graph of
   20 calls), wrapper ms, plain ms, bound (bytes or operations) and share,
   and for the marker kernel ``torch.fft.rfft`` over the live lanes'
   windows; the hit-bearing round's verify tail in device ms split between
   the verifiers, with the kernels and with the plain versions; each
   kernel's launches on the paths that run it (phases 3b, 3c, 4-5, 7, 18,
   19; a replay's conditional bodies counted from its payload);
15. isolation: no file under ``audio_pattern_detector_tpu/`` changed during
   the run, and no subprocess imported jax or the JAX package.

Every phase line starts with ``seconds``: the wall seconds since the
previous phase line.

``python3 chip_smoke.py --profile DIR`` adds phases that run the
flagship step, the flagship round and one 16-row serving round in both
batch modes, and the batched file-mode run under torch.profiler, print
wall time, device time, kernel and launch counts, and write each op table
to DIR.

Any mismatch raises, and the script exits non-zero. Without a CUDA card
it exits 2 before printing any result. The last two lines of stdout are
a JSON line of per-kernel numbers (the candidate scan, the lane greedy, the
lean greedy, the two verifiers, the loudness gate and the correlation) and
the JSON status line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.append(str(ROOT / "scripts"))

from kernel_bounds import (  # noqa: E402  (the bounds the stage split shares)
    HBM_BYTES_PER_S,
    lean_greedy_bound,
    scan_bound_ms,
)

AUDIO = ROOT / "sample_audios"
CLIPS = AUDIO / "clips"
KERNEL_SOURCE = "audio_pattern_detector_tpu_torch/csrc/candidate_scan.cu"
KERNEL_REPLACES = "audio_pattern_detector_tpu/ops/pallas_peaks.py:154"
SCAN_SHAPES = ((32, 495_999), (32, 489_999))  # flagship normal / marker groups
TIMED_RUNS = 30


_PHASE_CLOCK = [time.perf_counter()]


def phase(name: str, **numbers) -> None:
    """One phase line: its name and JSON numbers, led by ``seconds``, the
    wall seconds since the previous phase line (or the script's start)."""
    now = time.perf_counter()
    seconds, _PHASE_CLOCK[0] = now - _PHASE_CLOCK[0], now
    print(f"[{name}] " + json.dumps({"seconds": seconds, **numbers}), flush=True)


def make_scan_input(g: int, l: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded |corr| noise with injected plateaus of length 2, 3 and 4,
    exact-equal neighbours and pairs within 8 ulp; per-row thresholds."""
    rng = np.random.default_rng(seed)
    corr = (np.abs(rng.standard_normal((g, l))) * 0.1).astype(np.float32)
    for gi in range(g):
        slots = np.arange(8, max(l - 16, 9), 24)
        pos = rng.choice(slots, size=min(64, len(slots)), replace=False)
        for k, p in enumerate(pos):
            v = np.float32(rng.uniform(0.6, 1.0))
            kind = k % 4
            if kind < 3:  # plateau of length 2, 3 or 4
                corr[gi, p : p + kind + 2] = v
            elif gi % 2 == 0:  # pair within 8 ulp (near-collapse)
                corr[gi, p] = v
                corr[gi, p + 1] = np.nextafter(np.nextafter(v, 0), 0, dtype=np.float32)
            corr[gi, p - 1] = corr[gi, p + 6] = np.float32(0.05)
    thr = rng.uniform(0.2, 0.4, g).astype(np.float32)
    return corr, thr


EDGE_LENGTHS = (1, 3, 4095, 4096, 4097, 4098, 8193, 8194)  # every L mod 4
EDGE_ROWS = (1, 3, 64)
# (G, L) with more 4096-sample tiles than an H100 holds CTAs of the kernel
# (132 SMs x at most 8), so each CTA walks several tiles: it reuses ring
# stages, crosses row ends and, at L = 100, flushes the stats of several
# rows. Every CTA range starts at a tile edge, where features are planted.
EDGE_WIDE = ((1024, 4097), (512, 8193), (4096, 100))


def make_edge_scan_input(g: int, l: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded |corr| noise with plateaus of length 1-4, exact-equal runs
    and pairs within 8 ulp planted at each row's start and end and across
    every 4096-sample tile edge (the kernel's tile, stage and CTA-range
    boundaries); row 1 of three or more is all -inf. Per-row thresholds
    that few samples reach."""
    rng = np.random.default_rng(seed)
    corr = (np.abs(rng.standard_normal((g, l))) * 0.1).astype(np.float32)
    anchors = [0, 2, l - 5, l - 2, *range(4096, l + 4, 4096)]
    for gi in range(g):
        for a in anchors:
            p = int(a + rng.integers(-4, 4))
            kind = int(rng.integers(0, 6))
            v = np.float32(rng.uniform(0.6, 1.0))
            lo, hi = max(p, 0), min(p + 5, l)
            if lo >= hi:
                continue
            if kind < 4:  # an equal run of length 1-4
                corr[gi, lo : min(lo + kind + 1, hi)] = v
            elif kind == 4:  # a pair within 8 ulp
                corr[gi, lo] = v
                if lo + 1 < l:
                    corr[gi, lo + 1] = np.nextafter(np.nextafter(v, 0), 0, dtype=np.float32)
            else:  # a dip between equal values
                corr[gi, lo:hi] = v
                corr[gi, (lo + hi) // 2] = np.float32(0.05)
    if g >= 3:
        corr[1] = -np.inf
    thr = rng.uniform(0.2, 0.4, g).astype(np.float32)
    return corr, thr


def edge_valid_lens(g: int, l: int, seed: int) -> np.ndarray:
    """Mixed per-row valid lengths: 0, 1, 2, L-1, L, one past each end
    (they clamp), and random ones."""
    fixed = [0, 1, 2, l - 1, l, -1, l + 2]
    rng = np.random.default_rng(seed)
    lens = [fixed[i] if i < len(fixed) else int(rng.integers(0, l + 1)) for i in range(g)]
    return np.array(lens, dtype=np.int32)


def low_thresholds(thr: np.ndarray) -> np.ndarray:
    """Rows alternate a threshold of 0, one below 0 (every finite sample
    at or above it, so the kernel runs every test on every sample) and the
    row's own."""
    k = np.arange(len(thr)) % 3
    return np.where(k == 0, 0.0, np.where(k == 1, -0.5, thr)).astype(np.float32)


# ── The greedy kernels' inputs (phase greedy_kernels and the tests) ──

LANE_GREEDY_KS = (1024, 4728, 16384)  # a capped rerun, the flagship marker group, the widest


def lane_greedy_input(g: int, k: int, n_alive: list[int], l: int, m: int,
                      seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(pos (G, K) int64, alive (G, K) bool) as the full tier hands them to
    the lane greedy: row r's first ``n_alive[r]`` lanes alive, in priority
    order (height descending, ties to the lower position), at distinct
    positions in [0, l) packed in clusters (lanes within ``m`` of each
    other, so suppression chains run); the dead lanes hold garbage int32
    positions."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-2**31, 2**31 - 1, size=(g, k), dtype=np.int64)
    alive = np.zeros((g, k), dtype=bool)
    for r, n in enumerate(n_alive):
        centers = rng.integers(0, l, size=n // 4 + 1)
        near = centers[:, None] + rng.integers(-m, m + 1, size=(len(centers), 6))
        spots = np.unique(np.clip(near, 0, l - 1))
        if len(spots) < n:
            spots = np.union1d(spots, rng.choice(l, size=n, replace=False))
        p = rng.choice(spots, size=n, replace=False)
        h = rng.choice(np.float32([0.3, 0.5, 0.7, 0.9]), n)
        order = np.lexsort((p, -h))
        pos[r, :n] = p[order]
        alive[r, :n] = True
    return pos, alive


# The lane greedy's worst cases for its position-ordered walk, by name:
# every alive lane at one position; every alive lane within min_distance of
# each other (one cluster); min_distance 0 (nothing suppresses: every alive
# lane kept) and 1 (only equal positions suppress); dead lanes at the
# extremes of int32 and of int64, and at alive lanes' positions plus 2^32
# (the same int32), which must not count.
LANE_WORST_CASES = ("one_position", "one_cluster", "min_distance_0", "min_distance_1",
                    "dead_lanes_extreme")


def lane_worst_case(name: str, g: int, k: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """(pos (G, K) int64, alive (G, K) bool, min_distance) of the named worst
    case: row r's first K - r * (K // 2G) lanes alive (a prefix, in priority
    order; the last row about half), the rest dead with garbage positions."""
    rng = np.random.default_rng(seed + len(name))
    pos = rng.integers(-2**31, 2**31 - 1, size=(g, k), dtype=np.int64)
    alive = np.arange(k)[None, :] < (k - np.arange(g) * (k // (2 * g)))[:, None]
    m = 2000
    for r in range(g):
        n = int(alive[r].sum())
        if name == "one_position":
            p = np.full(n, 1000 + 37 * r)
        elif name == "one_cluster":
            p = 250_000 + rng.integers(0, m, size=n)  # every pair within m
        elif name == "min_distance_0":
            p = rng.integers(0, 495_999, size=n)
        elif name == "min_distance_1":
            p = rng.integers(0, max(n // 4, 1), size=n)  # about four lanes a position
        else:  # dead_lanes_extreme: alive lanes spread over the row
            p = rng.choice(495_999, size=n, replace=False)
        pos[r, :n] = p
        if name == "dead_lanes_extreme" and n < k:
            extremes = np.array([-2**63, 2**63 - 1, -2**31, 2**31 - 1, -2**31 + 1, 2**31 - 2])
            dead = np.concatenate([extremes, p[: k - n] + 2**32, p[: k - n] - 2**32])
            pos[r, n:] = rng.choice(dead, size=k - n)
    return pos, alive, {"min_distance_0": 0, "min_distance_1": 1}.get(name, m)


# The lean greedy's named inputs: each case is held at both clip lengths
# (m below and above the 512-sample block).
LEAN_GREEDY_CASES = (
    "no_candidate", "fewer_than_r_max", "exactly_r_max", "overflow", "refused_round",
    "rows_finish_apart", "short_row_300", "short_row_40", "valid_len_at_block_edge",
    "plateaus_at_hm", "edges_in_seed_window", "row_shorter_than_m", "edges_at_row_ends",
)
LEAN_GREEDY_MS = (40, 700)
LEAN_HM = 0.25  # exact in f32
LEAN_R_MAX = 16  # the lean tier's lanes (models/bank.py::_SMALL_TIER)


def lean_greedy_case(name: str, m: int) -> dict:
    """One named input of the lean greedy: raw |corr| rows (seeded noise
    below the threshold, candidates planted), ``valid_len`` (an int, or a
    (G,) int32 array), the rows' self-correlation maxima ``scm`` (the
    normaliser is max(scm, observed max)), ``hm``, ``m``, ``r_max`` and
    ``edits``: (row, block, raw value) writes into the scan's block maxima
    (a seed its block does not hold refuses the round)."""
    rng = np.random.default_rng(len(name) * 1000 + m)
    gap = 2 * m + 60  # peaks this far apart all survive
    l = {"short_row_300": 300, "short_row_40": 40, "valid_len_at_block_edge": 4096,
         "plateaus_at_hm": 4096, "row_shorter_than_m": 600,
         "edges_at_row_ends": 4096}.get(name, max(8192, 21 * gap + 700))
    rows = {"rows_finish_apart": 3, "valid_len_at_block_edge": 3}.get(name, 2)
    corr = (np.abs(rng.standard_normal((rows, l))) * 0.02).astype(np.float32)
    scm = np.full(rows, 0.7, dtype=np.float32)
    valid_len: "int | np.ndarray" = l
    edits: list[tuple[int, int, float]] = []

    def spread(row: int, n: int, start: int = 300) -> None:
        for i in range(n):
            corr[row, start + i * gap] = np.float32(0.95 - 0.02 * i)

    if name == "fewer_than_r_max":
        spread(0, 3)
        spread(1, 1, start=1000)
    elif name == "exactly_r_max":
        spread(0, LEAN_R_MAX)
    elif name == "overflow":
        spread(0, LEAN_R_MAX + 4)
        spread(1, 2)
    elif name == "refused_round":
        spread(0, 3)
        spread(1, 2)
        # A block without a candidate seeded between the first and second
        # peaks: round 0 keeps a survivor, round 1 is refused.
        edits.append((0, (300 + 5 * gap) // 512 + 1, 0.94))
    elif name == "rows_finish_apart":
        spread(1, 2)
        spread(2, 7)
        for i in range(3):  # shorter neighbours within m: suppressed
            corr[2, 300 + i * gap + max(m // 2, 2)] = np.float32(0.6)
    elif name in ("short_row_300", "short_row_40"):
        for row in range(rows):
            for p, h in ((5, 0.9), (l // 2, 0.8), (l - 3, 0.7)):
                corr[row, p] = np.float32(h - 0.1 * row)
    elif name == "valid_len_at_block_edge":  # the block edge at 1024, and one either side
        for row in range(rows):
            corr[row, 1022] = np.float32(0.9)
            corr[row, 1026] = np.float32(0.8)
            corr[row, 3000] = np.float32(0.7)
        corr[2, 1023:1025] = np.float32(0.5)  # a run of 2 ending at the last valid sample
        valid_len = np.array([1023, 1024, 1025], dtype=np.int32)
    elif name == "edges_in_seed_window":
        # A peak mid-block and a lower one 100 samples on: at m = 40 both
        # edges of each fall in its own block, whose window the round has.
        for row in range(rows):
            corr[row, 1300 + 512 * row] = np.float32(0.9)
            corr[row, 1400 + 512 * row] = np.float32(0.8)
    elif name == "row_shorter_than_m":  # m = 700 reaches past the 600-sample row
        for row in range(rows):
            for p, h in ((5, 0.9), (300, 0.8), (590, 0.7)):
                corr[row, p] = np.float32(h - 0.1 * row)
    elif name == "edges_at_row_ends":  # lo edge below block 0, hi edge past block nb - 1
        for row in range(rows):
            for p, h in ((3, 0.9), (l - 3, 0.8), (2000, 0.7)):
                corr[row, p] = np.float32(h - 0.1 * row)
    elif name == "plateaus_at_hm":
        scm[:] = 1.0  # the normaliser is 1: quotients are the samples
        v = np.float32(LEAN_HM)
        for row in range(rows):
            corr[row, 0:3] = v  # run of 3 from index 0: its midpoint 1 is no candidate
            corr[row, 100:102] = v  # run of 2: candidate 100
            corr[row, 300:303] = v  # run of 3: candidate 301
            corr[row, 500] = np.nextafter(v, 0, dtype=np.float32)  # below hm
            corr[row, 700:704] = v  # run of 4: none
            corr[row, 511:513] = v  # run of 2 across a block edge: candidate 511
            corr[row, 1023:1026] = v  # run of 3 across a block edge: candidate 1024
            corr[row, 2000 + 200 * row] = np.float32(0.9)
    return {"corr": corr, "valid_len": valid_len, "scm": scm, "hm": LEAN_HM, "m": m,
            "r_max": LEAN_R_MAX, "edits": edits}


def random_lean_greedy_case(seed: int, g: int, l: int, m: int, r_max: int,
                            per_row: bool, edits: int) -> dict:
    """A seeded lean greedy input in :func:`lean_greedy_case`'s form: rows of
    low noise with peaks and runs of 2-3 equal samples at a few heights
    (ties in both argmaxes), lengths per row or one for all, and ``edits``
    random writes into the block maxima (seeds raised or lowered: refused
    rounds)."""
    rng = np.random.default_rng(seed)
    levels = np.float32([0.2, 0.25, 0.5, 0.5, 0.75, 1.0])
    corr = (np.abs(rng.standard_normal((g, l))) * 0.05).astype(np.float32)
    for r in range(g):
        for p in rng.integers(0, l, size=int(rng.integers(0, 12))):
            corr[r, p : p + int(rng.integers(1, 4))] = rng.choice(levels)
    lens = rng.integers(0, l + 1, size=g).astype(np.int32)
    nb = -(-l // 512)
    return {"corr": corr, "valid_len": lens if per_row else int(lens[0]),
            "scm": rng.choice(np.float32([0.3, 0.7, 1.0]), size=g),
            "hm": float(rng.choice(np.float32([0.25, 0.5]))), "m": m, "r_max": r_max,
            "edits": [(int(rng.integers(0, g)), int(rng.integers(0, nb)),
                       float(rng.choice(levels))) for _ in range(edits)]}


def lean_greedy_inputs(case: dict, dev, scan) -> tuple:
    """(corr, valid_len, bmax, denom, hm, m, r_max) on ``dev`` for the lean
    greedy, its block maxima and observed maxima from ``scan`` (the
    candidate scan or its plain version), ``case``'s edits applied."""
    import torch

    corr = torch.from_numpy(case["corr"]).to(dev)
    vl = case["valid_len"]
    valid_len = torch.from_numpy(vl).to(dev) if isinstance(vl, np.ndarray) else vl
    scm = torch.from_numpy(case["scm"]).to(dev)
    bmax, _count, _plateau, omax, _near = scan(corr, case["hm"] * scm, valid_len)
    for row, b, v in case["edits"]:
        bmax[row, b] = v
    denom = torch.maximum(scm, omax).clamp_min(1e-38)
    return corr, valid_len, bmax, denom, case["hm"], case["m"], case["r_max"]


def greedy_outputs_equal(a, b) -> bool:
    """Bitwise: every output of one greedy against another's (float as bits)."""
    import torch

    a = [a] if isinstance(a, torch.Tensor) else list(a)
    b = [b] if isinstance(b, torch.Tensor) else list(b)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


# ── The verify kernels' inputs and arithmetic (phase verify_kernels and the tests) ──

VERIFY_SR = 8000
# Named inputs of each verifier (verify_normal_case, verify_marker_case).
VERIFY_NORMAL_CASES = ("hit_and_misses", "short_clip", "row_ends", "dead_lanes", "all_live",
                       "zero_variance", "rounds")
VERIFY_MARKER_CASES = ("tone_hits", "no_frames", "row_ends", "dead_lanes", "all_live", "rounds",
                       "long_marker")
# A 52 s marker clip (4,158 frames, past the frames the marker kernel keeps
# in shared memory): its own case, run with the FFT spectra only (the
# DFT-GEMM's matrix of a 416,000-sample window does not fit a card).
MARKER_52S = "marker_52s"
# Threads of a CTA in csrc/verify_normal.cu and csrc/verify_marker.cu: the
# order of their sums (np_block_sum).
VERIFY_NORMAL_THREADS = 512
VERIFY_MARKER_THREADS = 256


def self_correlations(clips: np.ndarray) -> np.ndarray:
    """(G, 2m - 1) f32: each clip's |full self-correlation| over its
    maximum, the form of the bank's correlation clips."""
    cc = np.stack([np.abs(np.correlate(c.astype(np.float64), c.astype(np.float64), "full"))
                   for c in clips])
    return (cc / cc.max(axis=1, keepdims=True)).astype(np.float32)


def verify_normal_case(name: str) -> dict:
    """One named input of the normal verifier at 8 kHz: ``corr`` (R, L) f32
    rows (noise, with clips' self-correlations planted as hits), ``pos``
    (R, K) int64, ``alive`` (R, K), the clips' ``cc``, ``m``, and the
    normaliser (``valid_len``: None, an int or an (R,) int32 array;
    ``denom``: None or (R,) f32, ``corr`` then raw). Lanes 0-2 of each row
    are a hit, one sample off it and a plateau. Rows are round-major:
    R = B * G, row r against clip r % G. Clips are 0.5 s (m = 4,000, the
    normal verifier) or, for ``short_clip``, 0.25 s (the short-clip
    verifier)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    m = 2000 if name == "short_clip" else 4000
    g, k = 2, 16
    b = 3 if name == "rounds" else 1
    r_rows = b * g
    cc = self_correlations(rng.standard_normal((g, m)).astype(np.float32))
    l = 3 * VERIFY_SR + 2 * m - 1  # the 'full' correlation of a 3 s section
    noise = 0.002 if name == "short_clip" else 0.05  # a short clip's r reads its whole window
    corr = (np.abs(rng.standard_normal((r_rows, l))) * noise).astype(np.float32)
    pos = rng.integers(m, l - m, (r_rows, k)).astype(np.int64)
    alive = rng.random((r_rows, k)) < 0.7

    def plant(r: int, p: int, clip: int, scale: float = 0.9) -> None:
        lo, hi = p - (m - 1), p + m
        src = cc[clip, max(0, -lo): (2 * m - 1) - max(0, hi - l)]
        corr[r, max(lo, 0): min(hi, l)] = np.maximum(corr[r, max(lo, 0): min(hi, l)],
                                                     scale * src)

    for r in range(r_rows):
        hit = int(rng.integers(2 * m, l - 2 * m))
        plant(r, hit, r % g)
        miss = hit + 3 * m // 2 if hit + 3 * m // 2 < l - m else hit - 3 * m // 2
        pos[r, :3] = [hit, hit + 1, miss]  # the hit, one off, a miss
        corr[r, miss - m // 2: miss + m // 2] = 0.9  # a plateau, not the clip's shape: refused
        alive[r, :3] = True
    valid_len: "int | np.ndarray | None" = None
    denom = None
    if name == "row_ends":
        # Windows clipped at both ends of the row, hits at both ends.
        for r in range(r_rows):
            plant(r, m - 1, r % g)
            plant(r, l - m, r % g)
            pos[r, 3:10] = [m - 1, l - m, 0, 1, l - 1, l + 3, -3]
            alive[r, 3:10] = True
        valid_len = l - 5
        denom = np.float32([1.7, 0.4])
        corr *= denom[:, None]
    elif name == "dead_lanes":
        alive[:, 1:] = False
        alive[0, 5] = True
        pos[~alive] = rng.integers(-2**40, 2**40, int((~alive).sum()))  # garbage
    elif name == "all_live":
        alive[:] = True
    elif name == "zero_variance":
        corr[1] = 0.0  # every window of row 1 is zero: smax clamps, r is 0
        corr[0, 5000:5000 + 2 * m] = 0.0
        pos[0, 3] = 5000 + m
        alive[:, 3] = True
    elif name == "rounds":
        valid_len = rng.integers(l // 2, l + 1, r_rows).astype(np.int32)
        valid_len[3] = 0
        valid_len[4] = pos[4, 0] + 10  # cuts the hit's window
        denom = rng.uniform(0.3, 2.0, r_rows).astype(np.float32)
        corr *= denom[:, None]
    return {"corr": corr, "pos": pos, "alive": alive, "cc": cc, "m": m, "sr": VERIFY_SR,
            "valid_len": valid_len, "denom": denom}


def verify_normal_inputs(case: dict, dev) -> tuple:
    """(corr, pos, alive, consts, normalise) on ``dev`` for the normal
    verifier, its constants built by the port from the case's clips."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.verify import build_normal_verify_consts

    consts = build_normal_verify_consts(case["cc"], case["m"], case["sr"], dev)
    normalise = None
    if case["denom"] is not None:
        vl = case["valid_len"]
        normalise = (torch.from_numpy(vl).to(dev) if isinstance(vl, np.ndarray) else int(vl),
                     torch.from_numpy(case["denom"]).to(dev))
    return (torch.from_numpy(case["corr"]).to(dev), torch.from_numpy(case["pos"]).to(dev),
            torch.from_numpy(case["alive"]).to(dev), consts, normalise)


def np_block_sum(terms: np.ndarray, threads: int) -> np.float32:
    """The f32 sum a CTA of ``threads`` takes in the verify kernels: thread
    t adds terms t, t + threads, ... in turn; each warp folds its 32 sums
    by xor shuffles (16, 8, 4, 2, 1: lane i adds lane i + half); the warp
    sums, zero-padded to 32, fold the same way."""
    terms = np.asarray(terms, dtype=np.float32).ravel()
    rows = max(-(-len(terms) // threads), 1)
    padded = np.zeros(rows * threads, dtype=np.float32)
    padded[: len(terms)] = terms
    acc = np.zeros(threads, dtype=np.float32)
    for row in padded.reshape(rows, threads):
        acc = acc + row
    return np_warp_fold(np_warp_fold(acc.reshape(-1, 32)))[0]


def np_warp_fold(v: np.ndarray) -> np.ndarray:
    """Each row of 32 lanes (zero-padded to 32) folded as a warp's xor
    shuffles fold it: (rows,) f32."""
    v = np.asarray(v, dtype=np.float32)
    if v.ndim == 1:
        v = np.concatenate([v, np.zeros(32 - len(v), np.float32)])[None, :]
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v[:, 0]


def np_verify_normal(corr, pos, alive, consts, valid_len=None, denom=None):
    """csrc/verify_normal.cu lane by lane in numpy, in its order of
    arithmetic: (accept, sim, r), sim and r NaN on dead lanes."""
    f32 = np.float32
    t = VERIFY_NORMAL_THREADS
    ccp = consts.corr_clip_partitions.cpu().numpy()
    ds_clip = consts.ds_clip.cpu().numpy()
    seg_a, seg_b = consts.seg_a.cpu().numpy(), consts.seg_b.cpu().numpy()
    g_n, ds_n = ds_clip.shape
    m, lc, ps = consts.clip_len, consts.corr_len, consts.partition_size
    r_rows, k = pos.shape
    l = corr.shape[1]
    front = 8 + m - 1
    upper = l + front + 8 + m - lc
    accept = np.zeros((r_rows, k), dtype=bool)
    sim = np.full((r_rows, k), np.nan, dtype=np.float32)
    r_out = np.full((r_rows, k), np.nan, dtype=np.float32)
    for r in range(r_rows):
        g = r % g_n
        lim = l if valid_len is None else int(np.broadcast_to(valid_len, (r_rows,))[r])
        hi = min(lim, l)
        dn = None if denom is None else f32(denom[r])
        for j in range(k):
            if not alive[r, j]:
                continue
            start = min(max(int(pos[r, j]) - (m - 1) + front, 0), upper)
            idx = start - front + np.arange(lc)
            inside = (idx >= 0) & (idx < hi)
            raw = np.where(inside, corr[r, np.clip(idx, 0, l - 1)], f32(0))
            smax = max(_np_div(raw.max(), dn), f32(1e-38))
            v = (_np_div(raw, dn) / smax).astype(f32)
            sums = []
            for p in range(10):
                d = (v[p * ps:(p + 1) * ps] - ccp[g, p]).astype(f32)
                sums.append(np_block_sum(d * d, t))
            mse = [f32(s / f32(ps)) for s in sums]
            whole = f32(0)
            for x in mse:
                whole = f32(whole + x)
            whole = f32(whole / f32(10))
            mid = f32(f32(mse[4] + mse[5]) / f32(2))
            s_val = whole if consts.is_short else min(whole, mid)
            lo = consts.win_lo + seg_a
            hi_b = consts.win_lo + seg_b + (1 << consts.k_level)
            bm = np.array([raw[a:b].max() for a, b in zip(lo, hi_b)], dtype=np.float32)
            x = (_np_div(bm, dn) / smax).astype(f32)
            y = ds_clip[g]
            mx = f32(np_block_sum(x, t) / f32(ds_n))
            my = f32(np_block_sum(y, t) / f32(ds_n))
            dx, dy = (x - mx).astype(f32), (y - my).astype(f32)
            cov, sxx, syy = (np_block_sum(a, t) for a in (dx * dy, dx * dx, dy * dy))
            den = np.sqrt(f32(sxx * syy))
            rv = f32(cov / max(den, f32(1e-38))) if den > 0 else f32(0)
            sim[r, j], r_out[r, j] = s_val, rv
            accept[r, j] = bool(s_val <= f32(0.02)) and bool(rv >= f32(0.9))
    return accept, sim, r_out


def _np_div(x, dn):
    """x / dn in f32, or x where there is no divisor."""
    x = np.asarray(x, dtype=np.float32)
    return x if dn is None else (x / dn).astype(np.float32)


def verify_marker_case(name: str) -> dict:
    """One named input of the marker verifier at 8 kHz: ``section`` (S,) or
    (B, S) f32, ``pos`` (R, K) int64, ``alive`` (R, K), the clips'
    ``dom`` frequencies, their ``params`` and ``m``. Clips are 0.25 s tones
    (m = 2,000: 18 frames of 25 ms), or for ``no_frames`` 20 ms (m = 160,
    shorter than one frame), or for ``long_marker`` 2 s (m = 16,000: a work
    area past the kernel's shared memory, its global-workspace form), or for
    ``marker_52s`` 52 s (m = 416,000: 4,158 frames, their results in the
    workspace too; five lanes a clip, the last half a clip before the hit,
    a near miss the second clip refuses). Tones of each clip's frequency are planted; lanes
    sit on them, one sample off and elsewhere."""
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    m = {"no_frames": 160, "long_marker": 16_000, MARKER_52S: 52 * VERIFY_SR}.get(name, 2000)
    dom = np.array([941.0, 1040.0])
    g, k = 2, 5 if name == MARKER_52S else 12
    b = 3 if name == "rounds" else 1
    s_len = max(4 * VERIFY_SR, 2 * (m + VERIFY_SR))
    sections = (0.01 * rng.standard_normal((b, s_len))).astype(np.float32)
    pos = rng.integers(0, s_len + m - 1, (b * g, k)).astype(np.int64)
    alive = rng.random((b * g, k)) < 0.7
    t = np.arange(m) / VERIFY_SR
    for bi in range(b):
        for gi in range(g):
            off = VERIFY_SR // 2 + gi * (s_len // 2) + 97 * bi
            sections[bi, off:off + m] += (0.8 * np.sin(2 * np.pi * dom[gi] * t)).astype(np.float32)
            hit = off + m - 1
            r = bi * g + gi
            pos[r, :3] = [hit, hit - 40, hit + 3]
            alive[r, :3] = True
            pos[bi * g + (gi + 1) % g, 3] = hit  # the other clip's tone: refused
            alive[bi * g + (gi + 1) % g, 3] = True
    if name == MARKER_52S:
        for gi in range(g):
            hit = VERIFY_SR // 2 + gi * (s_len // 2) + m - 1
            pos[gi, 4], alive[gi, 4] = hit - m // 2, True
    elif name == "row_ends":
        pos[:, 4:8] = [0, 1, s_len + m - 2, s_len + m + 4]
        alive[:, 4:8] = True
    elif name == "dead_lanes":
        alive[:, 2:] = False
        pos[~alive] = rng.integers(-2**40, 2**40, int((~alive).sum()))
    elif name == "all_live":
        alive[:] = True
    params = [{}, {"minimum_band_purity": 0.9, "minimum_longest_active_run": 6}]
    if name == "no_frames":  # clip 1 accepts without frames
        params[1] = {"minimum_active_frame_ratio": 0.0, "minimum_longest_active_run": 0,
                     "minimum_active_frame_mean_purity": 0.0}
    return {"section": sections[0] if b == 1 else sections, "pos": pos, "alive": alive,
            "dom": dom, "params": params, "m": m, "sr": VERIFY_SR}


def verify_marker_inputs(case: dict, dev) -> tuple:
    """(section, pos, alive, consts) on ``dev`` for the marker verifier."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.verify import build_marker_verify_consts

    consts = build_marker_verify_consts(case["m"], case["sr"], case["dom"], case["params"], dev)
    return (torch.from_numpy(case["section"]).to(dev), torch.from_numpy(case["pos"]).to(dev),
            torch.from_numpy(case["alive"]).to(dev), consts)


def np_marker_decisions(spectra, alive, consts) -> np.ndarray:
    """csrc/verify_marker.cu lane by lane in numpy, in its order of
    arithmetic, from :class:`MarkerSpectra` (any device): accept (R, K)."""
    f32 = np.float32
    t = VERIFY_MARKER_THREADS
    whole = spectra.whole.cpu().numpy()
    b, g_n, k, _, fw = whole.shape
    whole = whole.reshape(b * g_n, k, 3, fw)
    frames = None if spectra.frames is None else spectra.frames.cpu().numpy()
    if frames is not None:
        frames = frames.reshape(b * g_n, k, *frames.shape[3:])
    band_whole = consts.band_whole.cpu().numpy()
    band_frame = consts.band_frame.cpu().numpy()
    freqs_whole, freqs_frame = consts.freqs_whole.cpu().numpy(), consts.freqs_frame.cpu().numpy()
    dom_all, lock_all = consts.dom_freq.cpu().numpy(), consts.lock_hz.cpu().numpy()
    thr_all = consts.thresholds.cpu().numpy()

    def purity(band_e, e):
        return f32(band_e / max(e, f32(1e-38))) if e > 0 else f32(0)

    accept = np.zeros(alive.shape, dtype=bool)
    for r in range(b * g_n):
        g = r % g_n
        dom = dom_all[g]
        for j in range(k):
            if not alive[r, j]:
                continue
            pur = []
            for s in range(3):
                x = whole[r, j, s]
                p = (x * x).astype(f32) if spectra.whole_is_magnitude else x
                pur.append(purity(np_block_sum(np.where(band_whole[g], p, f32(0)), t),
                                  np_block_sum(p, t)))
            detected = freqs_whole[np.argmax(whole[r, j, 1])]  # the first maximum
            freq_ok = abs(f32(detected - dom)) <= f32(f32(0.05) * max(abs(detected), dom))
            n_frames = 0 if frames is None else frames.shape[2]
            frame_count = active_count = run = longest = 0
            pur_sum = f32(0)
            for fi in range(n_frames):
                x = frames[r, j, fi]
                p = (x * x).astype(f32) if spectra.frames_is_magnitude else x
                e = np_warp_sum(p)
                fp = purity(np_warp_sum(np.where(band_frame[g], p, f32(0))), e)
                locked = abs(f32(freqs_frame[np.argmax(x)] - dom)) <= lock_all[g]
                if e > 0:
                    frame_count += 1
                if e > 0 and locked and fp >= f32(0.55):
                    active_count += 1
                    pur_sum = f32(pur_sum + fp)
                    run += 1
                    longest = max(longest, run)
                else:
                    run = 0
            mean_purity = f32(pur_sum / f32(active_count)) if active_count else f32(0)
            ratio = f32(f32(active_count) / f32(frame_count)) if frame_count else f32(0)
            th = thr_all[g]
            accept[r, j] = bool(freq_ok and pur[1] >= th[0] and ratio >= th[1]
                                and f32(longest) >= th[2] and mean_purity >= th[3]
                                and min(pur[0], pur[2]) <= th[4] and max(pur[0], pur[2]) <= th[5])
    return accept


def np_warp_sum(terms: np.ndarray) -> np.float32:
    """The f32 sum of one warp in csrc/verify_marker.cu: lane l adds terms
    l, l + 32, ... in turn, then the xor fold of np_warp_fold."""
    terms = np.asarray(terms, dtype=np.float32)
    rows = max(-(-len(terms) // 32), 1)
    padded = np.zeros(rows * 32, dtype=np.float32)
    padded[: len(terms)] = terms
    acc = np.zeros(32, dtype=np.float32)
    for row in padded.reshape(rows, 32):
        acc = acc + row
    return np_warp_fold(acc[None, :])[0]


def _np_cmul(ar, ai, br, bi):
    """A complex product in f32, each product rounded: (a.x b.x - a.y b.y,
    a.x b.y + a.y b.x)."""
    f32 = np.float32
    ar, ai, br, bi = (np.asarray(x, dtype=f32) for x in (ar, ai, br, bi))
    return (ar * br - ai * bi).astype(f32), (ar * bi + ai * br).astype(f32)


def np_stockham(re, im, radices, twiddles):
    """csrc/verify_marker.cu's Stockham passes over (batch, L) f32 complex
    values: pass with radix R after p points reads x_r = in[i + r L / R],
    k = i mod p, multiplies x_r by W[r k L / (p R)], takes the R-point DFT
    (radix 2 and 4 exact add/sub, others y_s = x_0 + sum_r x_r W[(r s mod R)
    L / R] in r order) and writes out[(i - k) R + k + s p]."""
    f32 = np.float32
    L = re.shape[1]
    wr, wi = twiddles[0::2], twiddles[1::2]
    p = 1
    for R in radices:
        T = L // R
        i = np.arange(T)
        k = i % p
        xr = [re[:, i + r * T] for r in range(R)]
        xi = [im[:, i + r * T] for r in range(R)]
        for r in range(1, R):
            t = r * k * (L // (p * R))
            xr[r], xi[r] = _np_cmul(xr[r], xi[r], wr[t], wi[t])
        yr, yi = [None] * R, [None] * R
        if R == 2:
            yr[0], yi[0] = xr[0] + xr[1], xi[0] + xi[1]
            yr[1], yi[1] = xr[0] - xr[1], xi[0] - xi[1]
        elif R == 4:
            t0r, t0i, t1r, t1i = xr[0] + xr[2], xi[0] + xi[2], xr[0] - xr[2], xi[0] - xi[2]
            t2r, t2i, t3r, t3i = xr[1] + xr[3], xi[1] + xi[3], xr[1] - xr[3], xi[1] - xi[3]
            yr[0], yi[0], yr[2], yi[2] = t0r + t2r, t0i + t2i, t0r - t2r, t0i - t2i
            yr[1], yi[1], yr[3], yi[3] = t1r + t3i, t1i - t3r, t1r - t3i, t1i + t3r
        else:
            for s_ in range(R):
                ar, ai = xr[0], xi[0]
                for r in range(1, R):
                    t = ((r * s_) % R) * T
                    pr, pi_ = _np_cmul(xr[r], xi[r], wr[t], wi[t])
                    ar, ai = (ar + pr).astype(f32), (ai + pi_).astype(f32)
                yr[s_], yi[s_] = ar, ai
        j = (i - k) * R + k
        re, im = np.empty_like(re), np.empty_like(im)
        for s_ in range(R):
            re[:, j + s_ * p], im[:, j + s_ * p] = yr[s_], yi[s_]
        p *= R
    return re, im


def np_rfft_magnitudes(x: np.ndarray, plan) -> np.ndarray:
    """The fused marker kernel's magnitude rfft of (batch, n) f32 windowed
    samples on an ``ops/marker_fft.py`` plan, in its order of arithmetic
    (csrc/verify_marker.cu ``rfft_magnitudes``): (batch, n // 2 + 1) f32."""
    from audio_pattern_detector_tpu_torch.ops.marker_fft import plan_tables

    f32 = np.float32
    x = np.asarray(x, dtype=f32)
    tables = plan_tables(plan)
    w = tables["twiddles"]
    n_, L = plan.size, plan.work
    zr, zi = (x[:, 0::2], x[:, 1::2]) if plan.half else (x, np.zeros_like(x))
    re = np.zeros((x.shape[0], L), f32)
    im = np.zeros((x.shape[0], L), f32)
    if plan.bluestein:
        c = tables["chirp"]
        re[:, :n_], im[:, :n_] = _np_cmul(zr, zi, c[0::2], c[1::2])
        re, im = np_stockham(re, im, plan.radices, w)
        cs = tables["chirp_spectrum"]
        re, im = _np_cmul(re, im, cs[0::2], cs[1::2])
        im = -im
        re, im = np_stockham(re, im, plan.radices, w)
        zr, zi = _np_cmul(c[0::2], c[1::2], re[:, :n_], -im[:, :n_])
    else:
        re[:, :n_], im[:, :n_] = zr, zi
        zr, zi = np_stockham(re, im, plan.radices, w)
    k = np.arange(plan.bins)
    if plan.half:
        ur, ui = zr[:, k % n_], zi[:, k % n_]
        vr, vi = zr[:, (n_ - k) % n_], -zi[:, (n_ - k) % n_]
        er, ei = ur + vr, ui + vi
        post = tables["post"]
        tr, ti = _np_cmul(post[0::2][k], post[1::2][k], ur - vr, ui - vi)
        xr, xi = ((er + ti) * f32(0.5)).astype(f32), ((ei - tr) * f32(0.5)).astype(f32)
    else:
        xr, xi = zr[:, : plan.bins], zi[:, : plan.bins]
    return np.sqrt((xr * xr + xi * xi).astype(f32)).astype(f32)


def np_marker_spectra(section, pos, consts):
    """The fused marker kernel's spectra of every lane in numpy, as a
    :class:`MarkerSpectra` of magnitudes (torch tensors on the CPU): the
    window of the zero-padded section, the Hann products and the
    transforms of ``np_rfft_magnitudes`` on the kernel's plans."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.marker_fft import real_plan
    from audio_pattern_detector_tpu_torch.ops.verify_marker import MarkerSpectra

    f32 = np.float32
    sections = np.asarray(section, dtype=f32).reshape(-1, np.shape(section)[-1])
    pos = np.asarray(pos)
    b, s_len = sections.shape
    r_rows, k = pos.shape
    g = r_rows // b
    m, wl = consts.clip_len, consts.frame_len
    pad = 8 + m
    secp = np.pad(sections, ((0, 0), (pad, pad)))
    start = np.minimum(np.maximum(pos - (m - 1) + 8, 0), secp.shape[1] - 3 * m)
    rows = np.repeat(np.arange(b), g * k).reshape(r_rows, k)
    seg3 = secp[rows[..., None], start[..., None] + np.arange(3 * m)]  # (R, K, 3m)
    hann_whole = consts.hann_whole.cpu().numpy()
    whole = np_rfft_magnitudes((seg3.reshape(-1, m) * hann_whole).astype(f32), real_plan(m))
    whole = whole.reshape(b, g, k, 3, -1)
    frames = None
    if consts.frame_count > 0:
        match = seg3[..., m:2 * m]
        starts = np.asarray(consts.frame_starts)
        stacked = match[..., starts[:, None] + np.arange(wl)]  # (R, K, F, wl)
        stacked = (stacked * consts.hann_frame.cpu().numpy()).astype(f32)
        frames = np_rfft_magnitudes(stacked.reshape(-1, wl), real_plan(wl))
        frames = torch.from_numpy(frames.reshape(b, g, k, consts.frame_count, -1))
    return MarkerSpectra(torch.from_numpy(whole), True, frames, True)


def np_correlate_transforms(seg, bank, n: int) -> np.ndarray:
    """csrc/correlate_os.cu's arithmetic on T transforms in numpy: rows of
    segment spectra and of conjugate clip spectra (T, n / 2 + 1) complex64,
    pair by pair, give each transform's |y| / n (T, n) f32: the product
    P = seg * bank, A[k] = (E.x + t.y, E.y - t.x) with u = conj P[k],
    v = P[n/2 - k], E = u + v, t = w^k (u - v), the Stockham passes of
    ``np_stockham`` on the plan's radices, then |y| * (1 / n) of the
    result's floats."""
    from audio_pattern_detector_tpu_torch.ops.correlate_os import correlation_radices
    from audio_pattern_detector_tpu_torch.ops.marker_fft import RealPlan, plan_tables

    f32 = np.float32
    h = n // 2
    radices = correlation_radices(h)
    tables = plan_tables(RealPlan(n, True, h, 0, radices))
    seg, bank = np.asarray(seg, np.complex64), np.asarray(bank, np.complex64)
    pr, pi_ = _np_cmul(seg.real, seg.imag, bank.real, bank.imag)
    k = np.arange(h)
    ur, ui = pr[:, k], -pi_[:, k]
    vr, vi = pr[:, h - k], pi_[:, h - k]
    er, ei = ur + vr, ui + vi
    post = tables["post"]
    tr, ti = _np_cmul(post[0::2][k], post[1::2][k], ur - vr, ui - vi)
    re, im = np_stockham((er + ti).astype(f32), (ei - tr).astype(f32), radices,
                         tables["twiddles"])
    y = np.stack([re, im], axis=-1).reshape(len(seg), n)
    return (np.abs(y) * f32(1.0 / n)).astype(f32)


def np_correlate_os(seg_spec, bank_conj, n: int, step: int, off: int,
                    full_len: int) -> np.ndarray:
    """The kernel's output in numpy (``ops/correlate_os.py::correlate_os``):
    segment spectra (B, ns, n / 2 + 1) (or (ns, ...)) against a group's
    (G, n / 2 + 1) give (B, G, L) (or (G, L)) f32, each transform by
    :func:`np_correlate_transforms` and its first ``step`` samples laid end
    to end from ``off``."""
    seg = np.asarray(seg_spec)
    single = seg.ndim == 2
    seg = seg[None] if single else seg
    bank = np.asarray(bank_conj)
    b, ns, bins = seg.shape
    g = bank.shape[0]
    pairs_seg = np.broadcast_to(seg[:, None], (b, g, ns, bins)).reshape(-1, bins)
    pairs_bank = np.broadcast_to(bank[None, :, None], (b, g, ns, bins)).reshape(-1, bins)
    y = np_correlate_transforms(pairs_seg, pairs_bank, n).reshape(b, g, ns, n)
    out = y[..., :step].reshape(b, g, ns * step)[..., off : off + full_len]
    return out[0] if single else out


def check_scan_edges(dev, shapes) -> int:
    """The kernel against its plain version at each (G, L) of ``shapes``,
    at valid_len 0, 1, 2, L-1 and L and with mixed per-row lengths, under
    the input's thresholds and under low ones. Raises on any
    difference; returns the number of cases."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    cases = 0
    for g, l in shapes:
        corr_np, thr_np = make_edge_scan_input(g, l, seed=7 * l + g)
        corr = torch.from_numpy(corr_np).to(dev)
        lens = torch.from_numpy(edge_valid_lens(g, l, seed=l + g)).to(dev)
        for kind, t in (("few above", thr_np), ("all above", low_thresholds(thr_np))):
            thr = torch.from_numpy(t).to(dev)
            for valid_len in sorted({min(v, l) for v in (0, 1, 2, l - 1, l)}) + [lens]:
                got = candidate_scan(corr, thr, valid_len)
                want = candidate_scan_reference(corr, thr, valid_len)
                if corr.is_cuda:
                    torch.cuda.synchronize()
                try:
                    check_scan_equal(got, want)
                except AssertionError as e:
                    form = "per-row" if isinstance(valid_len, torch.Tensor) else valid_len
                    raise AssertionError(
                        f"G={g} L={l} valid_len={form} thresholds {kind}: {e}") from None
                cases += 1
    return cases


def edge_shapes(lengths=EDGE_LENGTHS) -> list[tuple[int, int]]:
    return [(g, l) for l in lengths for g in EDGE_ROWS]


@contextlib.contextmanager
def captured_scan_inputs(limit: int):
    """Inside the block, a copy of the inputs of the first ``limit``
    candidate-scan kernel launches, (corr, thr_min, valid_len) each, lands
    in the yielded list. The launches and their count are unchanged. A
    replayed class step calls no wrapper, so only eager steps (a captured
    key's first use among them) are recorded."""
    from audio_pattern_detector_tpu_torch.ops import candidate_scan as scan_module

    import torch

    launch, seen = scan_module._launch, []

    def recording(corr, thr_min, valid_len):
        # A launch being captured into a CUDA graph runs nothing yet.
        if len(seen) < limit and not torch.cuda.is_current_stream_capturing():
            seen.append((corr.clone(), thr_min.clone(), valid_len))
        return launch(corr, thr_min, valid_len)

    scan_module._launch = recording
    try:
        yield seen
    finally:
        scan_module._launch = launch


def share_above(corr, thr, valid_len) -> float:
    """The share of a scan's valid samples at or above the row's threshold:
    the samples that take the kernel's threshold-side tests. ``valid_len``
    is an int or a (G,) tensor of per-row lengths."""
    import torch

    if isinstance(valid_len, torch.Tensor):
        valid = torch.arange(corr.shape[1], device=corr.device)[None, :] < valid_len[:, None]
        n_valid = int(valid_len.clamp(0, corr.shape[1]).sum())
        return float((valid & (corr >= thr[:, None])).sum()) / max(n_valid, 1)
    valid = corr[:, :valid_len]
    return float((valid >= thr[:, None]).sum()) / max(valid.numel(), 1)


def tree_snapshot(path: Path) -> dict[str, tuple[int, int]]:
    """(size, mtime_ns) of every file under ``path``."""
    return {str(p.relative_to(path)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(path.rglob("*")) if p.is_file()}


def cuda_ms(fn, runs: int, reps: int = 5) -> float:
    """Median over ``reps`` of the milliseconds per call of ``fn``, each rep
    one CUDA-event pair around ``runs`` back-to-back calls (so the host's
    enqueue of one call overlaps the device work of the one before)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return float(np.median(times))


def device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_device_ms(fn, kernel: str, runs: int, between=None) -> "float | None":
    """Median device milliseconds of the kernels whose name contains
    ``kernel`` over ``runs`` calls of ``fn``, from torch.profiler; None if
    the profiler records no device time for it. ``between`` runs before
    each call (an L2 flush, for a cold-cache time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in device_events(prof) if kernel in e.name]
    return float(np.median(us)) / 1e3 if us else None


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def profile_run(fn, table: Path) -> dict:
    """One call of ``fn`` under torch.profiler: wall seconds, summed device
    event time, device event, kernel-launch and graph-launch counts, and the
    launch calls' share of the host's self time. The op table goes to
    ``table``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = device_events(prof)
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    launch = [e for e in host if e.name in LAUNCH_CALLS]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    host_self_us = sum(e.self_cpu_time_total for e in host)
    table.write_text(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=80))
    return {
        "profiled_wall_s": wall, "device_events": len(dev), "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / 1e3 / wall, "kernel_launch_calls": len(launch),
        "graph_launch_calls": sum(e.name in GRAPH_LAUNCH_CALLS for e in host),
        "launch_share_of_host_self_time":
            sum(e.self_cpu_time_total for e in launch) / host_self_us if host_self_us else None,
    }


def check_scan_equal(a, b) -> float:
    """Raise unless the five scan outputs are bitwise equal; max |a - b|."""
    import torch

    names = ("bmax", "count", "plateau", "omax", "near")
    for name, x, y in zip(names, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}: {x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        xb = x.view(torch.int32) if x.dtype == torch.float32 else x
        yb = y.view(torch.int32) if y.dtype == torch.float32 else y
        if not torch.equal(xb, yb):
            raise AssertionError(f"candidate_scan kernel and plain version differ in {name}")
    err = 0.0
    for x, y in ((a[0], b[0]), (a[3], b[3])):
        fin = torch.isfinite(x) & torch.isfinite(y)
        if fin.any():
            err = max(err, float((x[fin] - y[fin]).abs().max()))
    return err


def cli_stdout(argv: list[str]) -> str:
    """The port's CLI in-process; its stdout."""
    from audio_pattern_detector_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def run_cli(argv: list[str]) -> list[dict]:
    """The port's CLI in-process; its JSONL events."""
    return [json.loads(line) for line in cli_stdout(argv).splitlines() if line.startswith("{")]


def detections(events: list[dict]) -> list[tuple[str, int]]:
    return [(e["clip_name"], e["timestamp_ms"]) for e in events if e["type"] == "pattern_detected"]


def expect_events(argv_tail: list[str], audio: Path, want: list[tuple[str, int]], end_ms: int) -> None:
    events = run_cli(["match", *argv_tail, str(audio)])
    got_types = [e["type"] for e in events]
    if got_types[0] != "start" or events[0]["source"] != str(audio) or got_types[-1] != "end":
        raise AssertionError(f"bad event framing: {events}")
    if detections(events) != want or events[-1]["total_time_ms"] != end_ms:
        raise AssertionError(f"{argv_tail}: got {events}, want {want} and end {end_ms}")


def routes(bank) -> tuple[int, int, int, int]:
    return bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows


def rerun_sections(bank) -> dict[str, np.ndarray]:
    """61 s sections, one per route of a flagged row (numpy seeds 1-4):
    20 copies of the normal_0 clip 1.05 s apart (more than 16 greedy
    survivors on one row: a row rerun); the same with normal_0..5 summed
    (six rows: a class rerun); one 900 Hz hit and 18 weaker ones (marker_0's
    row: past the 1,024-lane cap, within k_detect: an escalated rerun);
    one 900 Hz hit (cleared by the lean tier: no rerun)."""
    sr = bank.sample_rate
    length = bank.classes[1]["section_len"]
    normal = next(g for g in bank.classes[1]["groups"] if g.kind == "normal")

    def noise(seed: int) -> np.ndarray:
        return (0.004 * np.random.default_rng(seed).standard_normal(length)).astype(np.float32)

    def copies(rows, seed: int) -> np.ndarray:
        audio = noise(seed)
        for k in range(20):
            o = int((0.3 + 1.05 * k) * sr)
            for ci in rows:
                audio[o : o + sr] += normal.clips_np[ci]
        return audio

    def tone_hits(weak: int, seed: int) -> np.ndarray:
        audio = noise(seed)
        tone = (0.8 * np.sin(2 * np.pi * 900.0 * np.arange(2000) / sr)).astype(np.float32)
        audio[sr : sr + 2000] += tone
        for k in range(weak):
            o = int((2.0 + 0.6 * k) * sr)
            audio[o : o + 2000] += 0.3 * tone
        return audio

    return {
        "row": copies([0], 1), "class": copies(range(6), 2),
        "escalated": tone_hits(18, 3), "clear": tone_hits(0, 4),
    }


# Sample audio and the JAX CLI's stdout on it (``python -m
# audio_pattern_detector_tpu match ...`` with the same arguments; the stdin
# wrapper reads 4.089 s where the file wrapper reads 4.078 s).
RTHK = AUDIO / "rthk_section_with_beep.wav"
RTHK_TOML = CLIPS / "rthk_beep.apd.toml"
CBS = AUDIO / "cbs_news_audio_section.wav"
CBS_CLIP = CLIPS / "cbs_news.wav"
RTHK_HITS = [("rthk_beep", 1408, "00:00:01.408"), ("rthk_beep", 2420, "00:00:02.420")]
CBS_HITS = [("cbs_news", 25899, "00:00:25.899")]
RTHK_HITS_MS = [(name, ms) for name, ms, _ in RTHK_HITS]


def jsonl_block(source: str, hits, end_ms: int, end_fmt: str) -> str:
    lines = [{"type": "start", "source": source}]
    lines += [{"type": "pattern_detected", "clip_name": n, "timestamp_ms": ms,
               "timestamp_formatted": f} for n, ms, f in hits]
    lines.append({"type": "end", "total_time_ms": end_ms, "total_time_formatted": end_fmt})
    return "".join(json.dumps(x, ensure_ascii=False) + "\n" for x in lines)


# The port's CLI in a subprocess; afterwards stderr's last line reports its
# kernel launches and whether jax or the JAX package was imported.
ENTRY = (
    "import json, sys\n"
    "from audio_pattern_detector_tpu_torch.cli import main\n"
    "from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan\n"
    "try:\n"
    "    main(sys.argv[1:])\n"
    "finally:\n"
    "    jax = [m for m in sys.modules if m.split('.')[0] in ('jax', 'audio_pattern_detector_tpu')]\n"
    "    print(json.dumps({'jax_imported': bool(jax),\n"
    "                      'launches': candidate_scan.launches}), file=sys.stderr, flush=True)\n"
)


def entry_command(args: list[str]) -> list[str]:
    return [sys.executable, "-c", ENTRY, "match", *args]


LOGICAL_DEVICES_ENV = "APD_TORCH_LOGICAL_DEVICES"  # parallel/mesh.py reads it


def entry_env(logical: "int | None" = None) -> dict:
    """The subprocesses' environment; ``logical`` multiplies the card into
    that many logical devices for the mesh entry points."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop(LOGICAL_DEVICES_ENV, None)
    if logical is not None:
        env[LOGICAL_DEVICES_ENV] = str(logical)
    return env


def run_entry(args: list[str], stdin: "bytes | None" = None,
              logical: "int | None" = None) -> tuple[str, dict, float]:
    """(stdout, {jax_imported, launches}, wall s) of one CLI subprocess."""
    t = time.perf_counter()
    proc = subprocess.run(entry_command(args), input=stdin, capture_output=True, cwd=ROOT,
                          env=entry_env(logical), timeout=300)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"{args}: exit {proc.returncode}: {proc.stderr.decode()[-3000:]}")
    report = json.loads(proc.stderr.decode().strip().splitlines()[-1])
    return proc.stdout.decode(), report, wall


def interrupted_stdin_run(wav: bytes, ck: Path, device_args: list[str]) -> str:
    """An ``--stdin --checkpoint-file`` run killed once the checkpoint of
    its first 2 s chunk is on disk: the stream's first two chunks are
    written and stdin is held open, so the run waits for a third. Returns
    the events it printed before the kill."""
    data = wav.index(b"data") + 8
    proc = subprocess.Popen(
        entry_command([*device_args, "--stdin", "--chunk-seconds", "2", "--pipeline-depth", "1",
                       "--checkpoint-file", str(ck), "--pattern-file", str(RTHK_TOML)]),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        cwd=ROOT, env=entry_env(),
    )
    try:
        assert proc.stdin is not None
        proc.stdin.write(wav[: data + 2 * 2 * 8000 * 2])  # two 2 s chunks of int16
        proc.stdin.flush()
        deadline = time.monotonic() + 240
        while not ck.exists():
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("the interrupted run wrote no checkpoint")
            time.sleep(0.2)
    finally:
        proc.kill()
        out, _ = proc.communicate(timeout=60)
    return out.decode()


def write_tiled(path: Path, pcm: np.ndarray, rate: int, copies: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.tile(pcm, copies).tobytes())


ROUND_ROWS = 16  # rows of a batched round: the serving tile and the flagship round
BATCHED_SCAN_SHAPES = tuple((ROUND_ROWS * g, l) for g, l in SCAN_SHAPES)
SECTION_LEN = 488_000  # the flagship class's 61 s section at 8 kHz
# Rows past 2**31 samples in all: flat offsets must be 64-bit.
WIDE_ROWS = 4_416


def batched_scan_input(g: int, l: int, seed: int, dev):
    """The (32, l) input of :func:`make_scan_input` as 16 rounds on the
    card, round r scaled by 1 - r / 64 (equal runs stay equal), and the
    per-row lengths a serving round mixes, one kind per round of 32 rows
    in turn: full rows, short rows (seeded, anywhere in the row), the
    m - 1 lead-in of an idle row (l less the section) and zero."""
    import torch

    corr_np, thr_np = make_scan_input(g // ROUND_ROWS, l, seed)
    scale = 1.0 - torch.arange(ROUND_ROWS, device=dev, dtype=torch.float32) / 64.0
    corr = (torch.from_numpy(corr_np).to(dev)[None] * scale[:, None, None]).reshape(g, l)
    thr = torch.from_numpy(np.tile(thr_np, ROUND_ROWS)).to(dev)
    rng = np.random.default_rng(seed)
    kinds = np.repeat(np.arange(ROUND_ROWS) % 4, g // ROUND_ROWS)
    lens = np.select(
        [kinds == 0, kinds == 1, kinds == 2], [l, rng.integers(1, l, g), l - SECTION_LEN], 0
    ).astype(np.int32)
    return corr.contiguous(), thr, torch.from_numpy(lens).to(dev)


def reference_in_row_chunks(corr, thr, lens, rows: int):
    """The plain scan over ``rows`` rows at a time (its temporaries are
    about twelve times its input), concatenated."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan_reference

    parts = [candidate_scan_reference(corr[i : i + rows], thr[i : i + rows], lens[i : i + rows])
             for i in range(0, corr.shape[0], rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


def phase_scan_batched(dev, smi: str) -> list[tuple]:
    """Phase 2b: the kernel against its plain version at the shapes a
    batched round gives it, (512, 495,999) and (512, 489,999), with per-row
    lengths that mix full, short, lead-in-only and zero rows; then at
    4,416 rows of 495,999 samples (2.19e9 samples, past 32-bit flat
    offsets; the plain version in chunks of 32 rows). Returns one
    (g, l, err, ms, plain_ms, bound_ms) per batched shape."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    rows = []
    for seed, (g, l) in enumerate(BATCHED_SCAN_SHAPES):
        corr, thr, lens = batched_scan_input(g, l, seed, dev)
        torch.cuda.reset_peak_memory_stats()
        got = candidate_scan(corr, thr, lens)
        want = candidate_scan_reference(corr, thr, lens)
        torch.cuda.synchronize()
        err = check_scan_equal(got, want)
        # A row's stats must not depend on its neighbours' lengths: every
        # row again, alone in its launch, at its own scalar length.
        for gi in (0, 33, 70, 100, g - 1):
            alone = candidate_scan(corr[gi : gi + 1], thr[gi : gi + 1], int(lens[gi]))
            check_scan_equal(alone, tuple(o[gi : gi + 1] for o in got))
        if not (bool(want[2].any()) and bool(want[4].any())):
            raise AssertionError("batched scan input did not exercise the plateau and near flags")
        ms = cuda_ms(lambda: candidate_scan(corr, thr, lens), 10)
        plain_ms = cuda_ms(lambda: candidate_scan_reference(corr, thr, lens), 3, reps=3)
        dev_ms = kernel_device_ms(lambda: candidate_scan(corr, thr, lens),
                                  "candidate_scan_kernel", 10)
        full = torch.full_like(lens, l)
        full_ms = kernel_device_ms(lambda: candidate_scan(corr, thr, full),
                                   "candidate_scan_kernel", 10)
        bound_ms, full_bound_ms = scan_bound_ms(g, l, lens), scan_bound_ms(g, l, full)
        phase("scan_batched", card=smi, shape=[g, l], bitwise_equal=True, max_abs_err=err,
              lengths={"full": int((lens == l).sum()), "zero": int((lens == 0).sum()),
                       "lead_in_only": int((lens == l - SECTION_LEN).sum()),
                       "valid_share": float(lens.sum()) / (g * l)},
              rows_alone_bitwise=True, ms=ms, plain_ms=plain_ms, kernel_device_ms=dev_ms,
              bound_ms=bound_ms, share_of_bound=bound_ms / dev_ms if dev_ms else None,
              kernel_device_ms_all_rows_full=full_ms, bound_ms_all_rows_full=full_bound_ms,
              share_of_bound_all_rows_full=full_bound_ms / full_ms if full_ms else None,
              share_above_threshold=share_above(corr, thr, lens),
              tiles=g * -(-l // 4096), plain_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows.append((g, l, err, ms, plain_ms, bound_ms))
        del corr, thr, lens, got, want, full

    g, l = WIDE_ROWS, SCAN_SHAPES[0][1]
    corr_np, thr_np = make_scan_input(32, l, seed=9)
    corr = torch.from_numpy(corr_np).to(dev).repeat(g // 32, 1)
    thr = torch.from_numpy(np.tile(thr_np, g // 32)).to(dev)
    lens = torch.from_numpy(
        np.random.default_rng(9).integers(0, l + 1, g).astype(np.int32)).to(dev)
    got = candidate_scan(corr, thr, lens)
    err = check_scan_equal(got, reference_in_row_chunks(corr, thr, lens, 32))
    phase("scan_past_int32", shape=[g, l], samples=g * l, past_int32=g * l > 2**31,
          bitwise_equal=True, max_abs_err=err, input_gb=corr.numel() * 4 / 1e9)
    del corr, got
    return rows


def turns_ms(run, n: int = 2) -> dict[str, list[float]]:
    """``run(mode)`` timed in turns (vmap, scan, scan, vmap), ``n`` times."""
    times: dict[str, list[float]] = {"vmap": [], "scan": []}
    for mode in ("vmap", "scan", "scan", "vmap") * n:
        times[mode].append(run(mode))
    return times


def median_and_range(xs: list[float]) -> list[float]:
    return [float(np.median(xs)), float(min(xs)), float(max(xs))]


def phase_flagship_round(dev, smi: str) -> tuple[int, list]:
    """Phase 3b: the batched flagship step (64 clips, 16 sections of 60 s)
    as one ``vmap`` step against 16 ``scan`` steps: payloads equal row for
    row with the kernel and with the plain scan, 2 kernel launches a round,
    ms per round in turns, peak memory, the f32 intermediates' largest
    differences, and the kernel on the round's own two launches. Returns
    the counted launches and the (g, l, err, device ms, bound ms) rows of
    those two launches."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import flagship_round
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy
    from audio_pattern_detector_tpu_torch.ops.correlate import bank_correlate_abs
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    step, bank, sections = flagship_round(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    candidate_scan.launches = lean_greedy.launches = 0
    with counted_verify_launches("flagship_round_vmap", lambda: [bank]):
        pv = step("vmap")
        torch.cuda.synchronize()
    launches = candidate_scan.launches
    GREEDY_PATH_LAUNCHES["lean_greedy"]["flagship_round_vmap"] = lean_greedy.launches
    peak = torch.cuda.max_memory_allocated()
    pv_bytes = pv.numel() * pv.element_size()
    torch.cuda.reset_peak_memory_stats()
    candidate_scan.launches = lean_greedy.launches = 0
    ps = step("scan")
    torch.cuda.synchronize()
    scan_launches = candidate_scan.launches
    if (lean_greedy.launches, GREEDY_PATH_LAUNCHES["lean_greedy"]["flagship_round_vmap"]) != (
            scan_launches, launches):
        raise AssertionError("the lean greedy did not launch once per scan launch in a round")
    scan_peak = torch.cuda.max_memory_allocated() - pv_bytes  # the vmap payload is still held
    # A replay calls no Python of the kernel's wrapper: the eager step on
    # the same bank records the launches' inputs (phase 14 holds the two
    # steps bitwise equal).
    bank.capture = False
    with captured_scan_inputs(limit=2) as round_scans:
        step("vmap")
    bank.capture = True
    if launches != 2 or scan_launches != 2 * ROUND_ROWS:
        raise AssertionError(f"kernel launches a round: vmap {launches} (want 2), "
                             f"scan {scan_launches} (want {2 * ROUND_ROWS})")
    plain = step("vmap", candidate_scan_reference)
    for name, other in (("scan schedule", ps), ("plain scan", plain)):
        if pv.shape != other.shape or not torch.equal(pv.view(torch.int32), other.view(torch.int32)):
            bad = (pv != other).nonzero()
            raise AssertionError(f"batched payload differs from the {name} at {bad[:5].tolist()}")

    # The f32 intermediates of the two schedules over the whole round:
    # bitwise (a row's results do not depend on its round; phase 3d).
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s = cls["section_len"]
    n_valids = torch.full((ROUND_ROWS,), s, dtype=torch.int32, device=dev)
    lufs_b = integrated_loudness_device(sections, n_valids, cls["loud"])
    lufs_s = torch.stack([integrated_loudness_device(sections[i], s, cls["loud"])
                          for i in range(ROUND_ROWS)])
    norm_b = loudness_normalize_device(sections, lufs_b)
    norm_s = torch.stack([loudness_normalize_device(sections[i], lufs_s[i])
                          for i in range(ROUND_ROWS)])
    corr_diff, corr_bitwise = [], True
    for g in cls["groups"]:
        cb, _ = bank_correlate_abs(norm_b, n_valids, g.corr)
        worst = 0.0
        for i in range(ROUND_ROWS):
            ci, _ = bank_correlate_abs(norm_s[i], s, g.corr)
            worst = max(worst, float((cb[i] - ci).abs().max() / ci.max()))
            corr_bitwise = corr_bitwise and bitwise(cb[i], ci)
        corr_diff.append(worst)
        del cb, ci
    diffs = {"lufs_max_abs": float((lufs_b - lufs_s).abs().max()),
             "normalised_section_max_abs": float((norm_b - norm_s).abs().max()),
             "correlation_max_abs_over_max": corr_diff,
             "bitwise": bitwise(lufs_b, lufs_s) and bitwise(norm_b, norm_s) and corr_bitwise}
    if not diffs["bitwise"]:
        raise AssertionError(f"the schedules' f32 intermediates differ: {diffs}")
    del lufs_b, lufs_s, norm_b, norm_s

    def round_ms(mode: str) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            step(mode)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 3 * 1e3

    round_ms("vmap")
    times = turns_ms(round_ms)
    phase("flagship_round", card=smi, clips=64, rows=ROUND_ROWS, section_s=60,
          payload_equal_to_scan_schedule=True, payload_equal_with_plain_scan=True,
          differing_fields=0, kernel_launches_vmap=launches,
          kernel_launches_scan=scan_launches, f32_differences=diffs,
          ms_per_round_vmap_median_min_max=median_and_range(times["vmap"]),
          ms_per_round_scan_median_min_max=median_and_range(times["scan"]),
          turns=len(times["vmap"]), peak_mem_gb_vmap=(peak - base_mem) / 1e9,
          peak_mem_gb_scan=(scan_peak - base_mem) / 1e9, resident_gb=base_mem / 1e9)

    kernel_rows = []
    for corr, thr, valid_len in round_scans:
        g, l = corr.shape
        err = check_scan_equal(candidate_scan(corr, thr, valid_len),
                               candidate_scan_reference(corr, thr, valid_len))
        dev_ms = kernel_device_ms(lambda: candidate_scan(corr, thr, valid_len),
                                  "candidate_scan_kernel", 10)
        bound_ms = scan_bound_ms(g, l, valid_len)
        phase("scan_main_path_input", source="flagship_round", shape=[g, l],
              valid_len="per row", bitwise_equal=True, max_abs_err=err,
              share_above_threshold=share_above(corr, thr, valid_len),
              kernel_device_ms=dev_ms, bound_ms=bound_ms,
              share_of_bound=bound_ms / dev_ms if dev_ms else None)
        kernel_rows.append((g, l, err, dev_ms, bound_ms))
    if len(round_scans) != 2:
        raise AssertionError("the batched round's scan inputs were not captured")
    del round_scans, step, bank, sections, pv, ps, plain
    return launches, kernel_rows


def timed_dispatch(bank, chunks: list, mode: str) -> tuple[list, float, float, float]:
    """(payloads, ms until ``dispatch_chunks_batch`` returns, ms until the
    payloads are on the host, device ms between CUDA events around the
    dispatch)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    dispatched = bank.dispatch_chunks_batch(chunks, None, mode=mode)
    end.record()
    t1 = time.perf_counter()
    payloads = [rec[1].numpy().copy() for rec in dispatched]
    t2 = time.perf_counter()
    end.synchronize()
    return payloads, (t1 - t0) * 1e3, (t2 - t0) * 1e3, start.elapsed_time(end)


def arrays_equal(a: list, b: list) -> bool:
    """Two lists of host payloads equal bit for bit."""
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.view(np.int32), y.view(np.int32))
        for x, y in zip(a, b))


def pools_gb(backend) -> "dict[str, float] | None":
    """GB reserved in a graph backend's graph pool and its bodies' pool, from
    the allocator's segments (None where they carry no pool id)."""
    import torch

    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    by_pool: dict = {}
    for seg in segments:
        key = tuple(seg["segment_pool_id"])
        by_pool[key] = by_pool.get(key, 0) + seg["total_size"]
    return {name: sum(by_pool.get(tuple(pool), 0) for pool, _ in held.values()) / 1e9
            for name, held in (("graph", backend._devices), ("bodies", backend._bodies))}


# ── Rows that do not depend on their round (phase 3d and the card tests) ──

# Widths of the rounds a row is held across: one row, a scan-batch launch's
# few, a graph's 16 and one past it (16 + 1 replays).
INVARIANCE_WIDTHS = (1, 5, 16, 17)
INVARIANCE_ROWS = max(INVARIANCE_WIDTHS)
LOUDNESS_GATE_SOURCE = "audio_pattern_detector_tpu_torch/csrc/loudness_gate.cu"
LOUDNESS_GATE_REPLACES = "audio_pattern_detector_tpu/ops/loudness.py:143"


def _bits(t):
    """``t``'s bits as int32 (a complex tensor's real and imaginary parts)."""
    import torch

    return (torch.view_as_real(t) if t.is_complex() else t).contiguous().view(torch.int32)


def bitwise(a, b) -> bool:
    """The same shape and bits."""
    import torch

    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def fft_batch_probe(dev, loud, corr, probes: int = 3) -> dict:
    """One cuFFT plan at each call site of the class step (the K-weighting's
    rfft and irfft, the segment spectra's rfft, the correlation's irfft, at
    their fixed transforms a call) gives a transform the same bits at every
    index of its batch and on every call: seeded transforms, each copied to
    every index of one call, then placed at the first, second, middle and
    last index among other transforms, then through the wrapper as one row
    (a call filled up with zero transforms). Raises on a difference;
    returns each site's length, transforms a call and indices checked."""
    import torch

    from audio_pattern_detector_tpu_torch.ops import correlate as correlate_mod
    from audio_pattern_detector_tpu_torch.ops import cufft_plans
    from audio_pattern_detector_tpu_torch.ops import loudness as loudness_mod

    sites = {"loudness_rfft": (False, loud.fft_len, loudness_mod.FFT_POINTS),
             "loudness_irfft": (True, loud.fft_len, loudness_mod.FFT_POINTS),
             "segment_rfft": (False, corr.fft_len, correlate_mod.SEGMENT_FFT_POINTS),
             "correlation_irfft": (True, corr.fft_len, correlate_mod.CORRELATION_FFT_POINTS)}
    rng = np.random.default_rng(11)
    out = {}
    for name, (inverse, n, points) in sites.items():
        per_call = cufft_plans.transforms_per_call(points, n)

        def inputs(count: int):
            x = torch.from_numpy(rng.standard_normal((count, n)).astype(np.float32)).to(dev)
            return torch.fft.rfft(x) if inverse else x

        def call(rows):
            rows = rows.contiguous().clone()  # C2R overwrites its input
            res = torch.empty((per_call, n if inverse else n // 2 + 1),
                              dtype=torch.float32 if inverse else torch.complex64, device=dev)
            cufft_plans._exec(inverse, n, per_call, rows, res)
            return res

        x, fill = inputs(probes), inputs(per_call)
        indices = sorted({0, 1, per_call // 2, per_call - 1} & set(range(per_call)))
        for k in range(probes):
            same = call(x[k : k + 1].expand(per_call, -1))
            ref = same[0]
            if not bool((_bits(same) == _bits(ref)[None]).all()):
                raise AssertionError(f"cuFFT {name}: one transform at every index of a "
                                     f"{per_call}-batch gives other bits")
            if not bitwise(call(x[k : k + 1].expand(per_call, -1))[0], ref):
                raise AssertionError(f"cuFFT {name}: a second call gives other bits")
            for j in indices:
                mixed = fill.clone()
                mixed[j] = x[k]
                if not bitwise(call(mixed)[j], ref):
                    raise AssertionError(f"cuFFT {name}: index {j} among other transforms "
                                         "gives other bits")
            one = (cufft_plans.irfft(x[k : k + 1], n, points=points)[0] if inverse
                   else cufft_plans.rfft(x[k : k + 1], points=points)[0])
            if not bitwise(one, ref.mul(1.0 / n) if inverse else ref):
                raise AssertionError(f"cuFFT {name}: one row through the wrapper differs")
        out[name] = {"n": n, "transforms_per_call": per_call, "probes": probes,
                     "indices_checked": per_call}
    return out


def gate_edge_rows(s: int, sr: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Sections (8, s) and lengths for the gating's edges: silent (length 0,
    and a full-length row of zeros), short (300 ms; 450 ms, past one block
    but under the short form's 500 ms), exactly one block (400 ms), half a
    second, a partial last block, one sample short of the section."""
    lens = np.array([0, s, int(0.3 * sr), int(0.45 * sr), int(0.4 * sr), sr // 2,
                     s // 2 + 333, s - 1], dtype=np.int32)
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(lens), s), np.float32)
    for i, n in enumerate(lens):
        if i != 1:
            rows[i, :n] = (0.02 * (i + 1) * rng.standard_normal(n)).astype(np.float32)
    return rows, lens


GATE_WIDTHS = (1, 3, 16, 17, 64)  # rounds the gating kernel is held bitwise in
GATE_POOL_ROWS = max(GATE_WIDTHS)
GATE_DESIGN = ("a row's pieces over ceil(P / 8) CTAs of 256 threads, a warp a piece; the "
               "row's last CTA (an atomic ticket after a fence) finishes blocks, gates and "
               "the short form")


def gate_pool(dev, sr: int, s: int, rows=None, lens=None):
    """(consts, K-weighted rows, lengths) of :data:`GATE_POOL_ROWS` rows of
    ``s`` samples at ``sr``: ``rows`` with ``lens`` where given, then
    :func:`gate_edge_rows`, then seeded noise at levels from -66 to -14
    dBFS, full length."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.loudness import _k_weighted_conv, build_loudness_consts

    consts = build_loudness_consts(s, sr, dev)
    edges, edge_lens = gate_edge_rows(s, sr, seed=sr)
    parts = ([] if rows is None else [np.stack(rows)]) + [edges]
    all_lens = ([] if lens is None else [np.asarray(lens, np.int32)]) + [edge_lens]
    rest = GATE_POOL_ROWS - sum(len(p) for p in parts)
    rng = np.random.default_rng(sr + 1)
    parts.append((rng.uniform(0.001, 0.2, (rest, 1)) * rng.standard_normal((rest, s))
                  ).astype(np.float32))
    all_lens.append(np.full(rest, s, np.int32))
    x = torch.from_numpy(np.concatenate(parts)).to(dev)
    return consts, _k_weighted_conv(x, consts), torch.from_numpy(np.concatenate(all_lens)).to(dev)


def check_gate_widths(filtered, lens, consts, widths=GATE_WIDTHS) -> dict:
    """The gating kernel on ``filtered`` rows in consecutive rounds of each
    width: each round bitwise the plain version, each row bitwise the row
    gated alone. Raises on a difference; returns the rounds a width."""
    from audio_pattern_detector_tpu_torch.ops.loudness import loudness_gate, loudness_gate_reference

    rows = filtered.shape[0]
    alone = [loudness_gate(filtered[i : i + 1], lens[i : i + 1], consts)[0] for i in range(rows)]
    rounds = {}
    for w in widths:
        rounds[w] = 0
        for lo in range(0, rows, w):
            x, n = filtered[lo : lo + w], lens[lo : lo + w]
            got = loudness_gate(x, n, consts)
            if not bitwise(got, loudness_gate_reference(x, n, consts)):
                raise AssertionError(f"loudness_gate: a {w}-row round at row {lo} differs from "
                                     "its plain version")
            if not all(bitwise(got[i], alone[lo + i]) for i in range(x.shape[0])):
                raise AssertionError(f"loudness_gate: a row of the {w}-row round at row {lo} "
                                     "differs from the row alone")
            rounds[w] += 1
    return rounds


def phase_round_invariance(dev, smi: str, num_normal: int = 32, num_marker: int = 32) -> dict:
    """Phase 3d: a row's results do not depend on its round. On the flagship
    bank, 17 sections of 61 s (phase 7's four route sections, a half-length
    row, a zero-length row, seeded noise): each row's LUFS, normalised
    section and |correlation| of each group in rounds of 1, 5, 16 and 17
    rows bitwise its single-section results, and its payload in those
    rounds, eager and captured ("vmap"; 17 rows are 16 + 1 replays), and
    in the captured "scan" schedule (the one-row graph), bitwise the eager
    single-section step's; the row rerun's correlation and payload bitwise
    the class step's row and the class rerun's; the cuFFT probe
    (:func:`fft_batch_probe`); ``csrc/loudness_gate.cu`` bitwise its plain
    version on the round's K-weighted rows and on :func:`gate_edge_rows`,
    each row also alone; and on pools of 64 rows at 8 kHz and 6,004 Hz in
    rounds of every width of :data:`GATE_WIDTHS`. Times the kernel on the
    16-row round (device ms from a graph of calls, wrapper ms, plain ms, its
    byte bound) and on one row, full and silent (its fixed cost: the
    memset, the launch, the ticket and the short form). Returns the gate's
    numbers for the kernels line."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_bank
    from audio_pattern_detector_tpu_torch.ops.correlate import bank_correlate, bank_correlate_abs
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        _k_weighted_conv,
        gate_ctas_per_row,
        integrated_loudness_device,
        loudness_gate,
        loudness_gate_reference,
        loudness_normalize_device,
    )

    bank = make_bank(num_normal, num_marker, chunk_seconds=60, device=dev)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s, loud, groups = cls["section_len"], cls["loud"], cls["groups"]
    routes = rerun_sections(bank)
    rows = [routes[k] for k in ("row", "class", "escalated", "clear")]
    rows += [(0.05 * np.random.default_rng(40 + i).standard_normal(s)).astype(np.float32)
             for i in range(INVARIANCE_ROWS - len(rows))]
    lens = [s] * INVARIANCE_ROWS
    lens[4], lens[5] = s // 2 + 333, 0
    for i, n in enumerate(lens):
        rows[i][n:] = 0.0
    sections = torch.from_numpy(np.stack(rows)).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)

    def intermediates(x, n):
        lufs = integrated_loudness_device(x, n, loud)
        norm = loudness_normalize_device(x, lufs)
        return lufs, norm, [bank_correlate_abs(norm, n, g.corr)[0] for g in groups]

    loudness_gate.launches = 0
    bank.capture = False
    ref = [intermediates(sections[i], lens[i]) for i in range(INVARIANCE_ROWS)]
    ref_payload = [bank.step(sw, sections[i], lens[i]) for i in range(INVARIANCE_ROWS)]
    compared = {"intermediates": 0, "payload_rows": 0}
    for w in INVARIANCE_WIDTHS:
        lufs, norm, corr = intermediates(sections[:w], lens_t[:w])
        for i in range(w):
            r_lufs, r_norm, r_corr = ref[i]
            if not (bitwise(lufs[i], r_lufs) and bitwise(norm[i], r_norm)
                    and all(bitwise(c[i], rc) for c, rc in zip(corr, r_corr))):
                raise AssertionError(f"row {i} of a {w}-row round: its f32 intermediates "
                                     "differ from its single-section ones")
            compared["intermediates"] += 1
        del lufs, norm, corr
        for capture in (False, True):
            bank.capture = capture
            payload = bank.step(sw, sections[:w], lens_t[:w])
            for i in range(w):
                if not bitwise(payload[i], ref_payload[i]):
                    raise AssertionError(f"row {i} of a {w}-row "
                                         f"{'captured' if capture else 'eager'} vmap round: "
                                         "its payload differs from its eager single step's")
                compared["payload_rows"] += 1
    bank.capture = True
    for i in range(INVARIANCE_ROWS):  # the captured scan schedule: the one-row graph
        if not bitwise(bank.step(sw, sections[i], lens[i]), ref_payload[i]):
            raise AssertionError(f"row {i}: the captured scan step's payload differs")
        compared["payload_rows"] += 1
    torch.cuda.synchronize()
    path_launches = loudness_gate.launches
    graph_widths = sorted({s_.key.rows for s_ in bank.graphs.steps()})
    del ref, ref_payload

    # The row rerun (one clip's constants, G = 1) against the class step's
    # row and the class rerun's.
    raw = routes["row"]
    norm = loudness_normalize_device(sections[0], integrated_loudness_device(sections[0], s, loud))
    class_rerun = bank._full_tier_packed(sw, raw)
    reruns = 0
    for gi, g in enumerate(groups):
        for ci in (0, len(g.names) - 1):
            row_consts, _ = bank._row_consts_for(sw, gi, ci)
            for correlate in (bank_correlate, bank_correlate_abs):
                if not bitwise(correlate(norm, s, row_consts)[0][0],
                               correlate(norm, s, g.corr)[0][ci]):
                    raise AssertionError(f"row rerun of group {gi} clip {ci}: its correlation "
                                         "differs from the class step's row")
            if not bitwise(torch.from_numpy(bank._full_tier_row(sw, gi, ci, raw)),
                           torch.from_numpy(class_rerun[gi][ci])):
                raise AssertionError(f"row rerun of group {gi} clip {ci}: its payload differs "
                                     "from the class rerun's row")
            reruns += 1
    del class_rerun, norm

    probe = fft_batch_probe(dev, loud, groups[0].corr)

    # The gating kernel against its plain version, bitwise: the round's rows
    # and the edge rows, then pools of 64 K-weighted rows at 8 kHz (the
    # phase's rows, the edges, noise) and at 6,004 Hz (edges, noise) in
    # rounds of every width of GATE_WIDTHS, each row also alone.
    gate_rows = 0
    edge_np, edge_lens = gate_edge_rows(s, bank.sample_rate, seed=5)
    edges = torch.from_numpy(edge_np).to(dev)
    edge_lens_t = torch.from_numpy(edge_lens).to(dev)
    round_rows = sections[:ROUND_ROWS]
    for x, n in ((round_rows, lens_t[:ROUND_ROWS]), (edges, edge_lens_t)):
        filtered = _k_weighted_conv(x, loud)
        got = loudness_gate(filtered, n, loud)
        want = loudness_gate_reference(filtered, n, loud)
        if not bitwise(got, want):
            raise AssertionError(f"loudness_gate: the kernel differs from its plain version: "
                                 f"{got.tolist()} against {want.tolist()}")
        for i in range(x.shape[0]):
            if not bitwise(loudness_gate(filtered[i : i + 1], n[i : i + 1], loud)[0], got[i]):
                raise AssertionError(f"loudness_gate: row {i} alone differs from its round")
        gate_rows += x.shape[0]
    edge_lufs = loudness_gate(_k_weighted_conv(edges, loud), edge_lens_t, loud).tolist()
    if not (math.isinf(edge_lufs[0]) and math.isinf(edge_lufs[1])
            and all(math.isfinite(v) for v in edge_lufs[2:])):
        raise AssertionError(f"loudness_gate on the edge rows: {edge_lufs}")
    gate_widths = {}
    for sr in (bank.sample_rate, 6004):
        own = sr == bank.sample_rate  # the phase's own rows lead the pool
        rate_loud, pool, pool_lens = gate_pool(dev, sr, s if own else 61 * sr,
                                               rows if own else None, lens if own else None)
        gate_widths[sr] = check_gate_widths(pool, pool_lens, rate_loud)
        del pool
    del edges

    filtered = _k_weighted_conv(round_rows, loud)
    n16 = lens_t[:ROUND_ROWS].contiguous()
    one, n1 = filtered[:1], n16[:1]
    n0 = torch.zeros_like(n1)  # a silent row: no sample read, the short form
    torch.cuda.synchronize()
    timing = {
        "ms": graph_ms(lambda: loudness_gate(filtered, n16, loud)),
        "plain_ms": graph_ms(lambda: loudness_gate_reference(filtered, n16, loud)),
        "wrapper_ms": cuda_ms(lambda: loudness_gate(filtered, n16, loud), TIMED_RUNS),
        "one_row_ms": graph_ms(lambda: loudness_gate(one, n1, loud)),
        "one_row_plain_ms": graph_ms(lambda: loudness_gate_reference(one, n1, loud)),
        "one_row_silent_ms": graph_ms(lambda: loudness_gate(one, n0, loud)),
    }
    valid = int(lens_t[:ROUND_ROWS].clamp(0, s).sum())
    bound_ms = (valid * 4 + ROUND_ROWS * 8) / HBM_BYTES_PER_S * 1e3
    one_bound_ms = (s * 4 + 8) / HBM_BYTES_PER_S * 1e3
    ctas_per_row = gate_ctas_per_row(loud.piece_bounds.shape[0] - 1)
    loudness_gate.launches = path_launches  # measurement launches do not count
    phase("round_invariance", card=smi, clips=num_normal + num_marker, section_len=s,
          widths=list(INVARIANCE_WIDTHS), rows_compared=compared, graph_widths=graph_widths,
          schedules=["vmap eager", "vmap captured", "scan eager", "scan captured"],
          row_reruns_equal_class_step=reruns, cufft=probe, bitwise=True,
          loudness_gate_rows_bitwise=gate_rows, edge_row_lufs=edge_lufs,
          loudness_gate_widths_bitwise=gate_widths,
          loudness_gate_launches=path_launches, **timing, bound_ms=bound_ms,
          share_of_bound=bound_ms / timing["ms"], one_row_bound_ms=one_bound_ms,
          one_row_share_of_bound=one_bound_ms / timing["one_row_ms"],
          ctas_per_row=ctas_per_row)
    del bank, sections, filtered
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_by_path": {"round_invariance": path_launches}, "max_abs_err": 0.0,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": [ROUND_ROWS, s], **timing, "one_row_bound_ms": one_bound_ms,
            "ctas_per_row": ctas_per_row, "design": GATE_DESIGN}


def phase_stage_split(dev, smi: str) -> list[dict]:
    """Phase 3e: the class step's device time split by stage
    (``scripts/profile_stages_torch.py``) on file mode's one-clip step, the
    flagship step and the 16-row flagship round: each stage's device ms,
    bound and share of the whole eager step, the stages' sum beside the
    step. Raises where a stage or a step reads no device time. Its launches
    are measurements: the main path's counts start again at phase 4."""
    from profile_stages_torch import stage_split

    records = stage_split(dev)
    for record in records:
        if not (record["step_device_ms"] > 0
                and all(st["device_ms"] > 0 for st in record["stages"])):
            raise AssertionError(f"stage split of {record['shape']}: a stage read no device "
                                 "time")
        phase("stage_split", card=smi, **record)
    return records


CORRELATE_SOURCE = "audio_pattern_detector_tpu_torch/csrc/correlate_os.cu"
CORRELATE_REPLACES = "audio_pattern_detector_tpu/ops/correlate.py:159"
# The stage split's three shapes (fft_len 32,768) and file mode's step of
# the 29,488-sample rainbow intro clip (fft_len 131,072: cuFFT's before the
# cluster form).
CORRELATE_SHAPES = ("one_clip_file_mode", "flagship_step", "flagship_round", "rainbow_file_mode")
CORRELATE_LENGTHS = tuple(1 << e for e in range(13, 19))  # seeded spectra, 8,192 to 262,144
CORRELATE_WIDTHS = (1, 5, 16, 17)  # rounds a row's |correlation| is held bitwise in
CORRELATE_PICKS = 6  # transforms a group held bitwise to the transliteration
CORRELATE_RTOL = 1e-5  # of a row's largest |correlation|: the kernel against the cuFFT route
CORRELATE_DESIGN = ("a CTA a transform (b, g, s) up to fft_len 32,768, past it a cluster of C = "
                    "N / 32,768 CTAs over distributed shared memory, 16,384 complex values each "
                    "(ops/correlate_os.py::cluster_size): the product formed as the spectra "
                    "load, the Hermitian half spectrum folded into an N/2-point complex spectrum "
                    "stored into the CTA of the first passes, in-place Stockham passes in shared "
                    "memory, one pass exchanging the values between the cluster's CTAs, only the "
                    "kept samples' magnitudes written")


def correlate_picks(b: int, g: int, ns: int, count: int, seed: int) -> list[tuple[int, int, int]]:
    """``count`` transforms (b, g, s) of a (B, G, ns) launch: the first, the
    last and seeded others."""
    rng = np.random.default_rng(seed)
    picks = {(0, 0, 0), (b - 1, g - 1, ns - 1)}
    while len(picks) < min(count, b * g * ns):
        picks.add((int(rng.integers(b)), int(rng.integers(g)), int(rng.integers(ns))))
    return sorted(picks)


def check_correlate_transforms(out, seg, bank, n: int, step: int, off: int, full_len: int,
                               picks) -> int:
    """The kept samples of each picked transform (b, g, s) in the kernel's
    output ``out`` (B, G, L), bitwise :func:`np_correlate_transforms` of the
    same spectra ``seg`` (B, ns, n / 2 + 1) and ``bank`` (G, n / 2 + 1).
    Raises on a difference; returns the samples compared."""
    seg_np, bank_np = seg.cpu().numpy(), bank.cpu().numpy()
    y = np_correlate_transforms(np.stack([seg_np[b, s] for b, _, s in picks]),
                                np.stack([bank_np[g] for _, g, _ in picks]), n)
    compared = 0
    for i, (b, g, s) in enumerate(picks):
        lo = s * step - off
        t_lo, t_hi = max(0, -lo), min(step, full_len - lo)
        if t_hi <= t_lo:
            continue
        got = out[b, g, lo + t_lo : lo + t_hi].cpu().numpy()
        want = y[i, t_lo:t_hi]
        differ = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
        if differ.size:
            t = t_lo + differ[0]
            raise AssertionError(f"correlate_os: transform (b {b}, g {g}, s {s}) differs from "
                                 f"its transliteration at {differ.size} samples, first t = {t}: "
                                 f"{got[differ[0]]!r} against {want[differ[0]]!r}")
        compared += t_hi - t_lo
    return compared


def correlate_bound(b: int, g: int, ns: int, n: int, full_len: int) -> tuple[float, str]:
    """(ms, what bounds it) of one correlation call on the card: the bytes
    it must move (the segment spectra and the group's spectra read once, the
    (B, G, L) f32 output written once) over the memory rate, or its
    transforms' 2.5 N log2 N operations each over the f32 rate, whichever
    is larger."""
    bins = n // 2 + 1
    bytes_ms = (b * ns * bins * 8 + g * bins * 8 + b * g * full_len * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = b * g * ns * 2.5 * n * math.log2(n) / PEAK_SCALAR_OPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_correlate_kernel(dev, smi: str) -> dict:
    """Phase 3f (``correlate_kernel``): ``csrc/correlate_os.cu`` on the
    inputs the class step gives it, on file mode's one-clip step, the
    flagship step and the 16-row flagship round (``scripts/
    profile_stages_torch.py``'s shapes), each group: sampled transforms
    bitwise :func:`np_correlate_transforms`; the whole output within
    :data:`CORRELATE_RTOL` of each row's largest value of the plain version
    (the cuFFT route); on sampled rows, each route's largest error against
    the exact correlation (numpy's f64 transforms of the same spectra), the
    kernel's no more than twice the cuFFT route's; in turns (kernel, plain,
    plain, kernel) the kernel's and the plain version's device ms (a graph
    of 20 calls), the wrapper's ms, ``torch.fft.irfft`` over the same
    products (the library call), the bound and the share of it. On the
    round, a row's output bitwise the same in rounds of 1, 5, 16 and 17
    rows, and a graph replay bitwise the eager call. Then the launches on
    the flagship step and round (captured, both schedules), counted from 0
    around each, with no call of the cuFFT route
    (``ops/correlate.py::cufft_correlation``). Returns the kernels line's
    entry."""
    import torch

    from profile_stages_torch import shape_inputs

    from audio_pattern_detector_tpu_torch.flagship import flagship_round, flagship_step
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos
    from audio_pattern_detector_tpu_torch.ops.correlate import (
        cufft_correlation,
        section_segment_spectra,
    )
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    counted_before = tos.correlate_os.launches
    records, max_abs_err, compared = [], 0.0, 0
    for name in CORRELATE_SHAPES:
        bank, sw, sections, lens = shape_inputs(name, dev)
        cls = bank.classes[sw]
        norm = loudness_normalize_device(
            sections, integrated_loudness_device(sections, lens, cls["loud"]))
        for gi, grp in enumerate(cls["groups"]):
            c = grp.corr
            seg = section_segment_spectra(norm, c)
            n, step = c.fft_len, c.step or c.fft_len - c.clip_len + 1
            args = (seg, c.bank_rfft_conj, n, step, c.out_offset, c.full_len)
            if not tos.kernel_takes(n):
                raise AssertionError(f"correlate_os: {name} group {gi} (fft_len {n}) does not "
                                     "take the kernel")
            b, ns = seg.shape[:2]
            g = c.bank_rfft_conj.shape[0]
            out = tos.correlate_os(*args)
            plain = tos.correlate_os_reference(*args)
            torch.cuda.synchronize()
            compared += check_correlate_transforms(out, seg, c.bank_rfft_conj, *args[2:],
                                                   correlate_picks(b, g, ns, CORRELATE_PICKS,
                                                                   seed=gi))
            diff = (out - plain).abs()
            abs_err = float(diff.max())
            rel_err = float((diff / plain.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
            if not rel_err <= CORRELATE_RTOL:
                raise AssertionError(f"correlate_os: {name} group {gi} lies {rel_err} of a row's "
                                     f"maximum from the cuFFT route (limit {CORRELATE_RTOL})")
            max_abs_err = max(max_abs_err, abs_err)
            del diff
            # Against the exact correlation on sampled rows: f64 transforms
            # of the same spectra.
            seg64 = seg.cpu().numpy().astype(np.complex128)
            bank64 = c.bank_rfft_conj.cpu().numpy().astype(np.complex128)
            errs = {"kernel": 0.0, "cufft": 0.0}
            for rb in sorted({0, b - 1}):
                for rg in sorted({0, g // 2, g - 1}):
                    y = np.abs(np.fft.irfft(seg64[rb] * bank64[rg], n=n)[:, :step]).reshape(-1)
                    exact = y[c.out_offset : c.out_offset + c.full_len]
                    top = exact.max()
                    for key, got in (("kernel", out), ("cufft", plain)):
                        row = got[rb, rg].cpu().numpy().astype(np.float64)
                        errs[key] = max(errs[key], float(np.abs(row - exact).max() / top))
            if not errs["kernel"] <= 2 * errs["cufft"]:
                raise AssertionError(f"correlate_os: {name} group {gi} errs {errs['kernel']} of a "
                                     f"row's maximum against f64, over twice the cuFFT route's "
                                     f"{errs['cufft']}")
            if name == "flagship_round":
                for w in CORRELATE_WIDTHS:
                    rows = [i % b for i in range(w)]
                    got = tos.correlate_os(seg[rows].contiguous(), *args[1:])
                    if not all(bitwise(got[i], out[r]) for i, r in enumerate(rows)):
                        raise AssertionError(f"correlate_os: a row of a {w}-row round differs "
                                             "from the 16-row round's")
                    del got
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    replayed = tos.correlate_os(*args)
                for _ in range(2):
                    graph.replay()
                    torch.cuda.synchronize()
                    if not bitwise(replayed, out):
                        raise AssertionError("correlate_os: a graph replay differs from the "
                                             "eager call")
                del graph, replayed
            del out, plain
            prod = seg[..., None, :, :] * c.bank_rfft_conj[:, None, :]
            turns = {"kernel": [], "plain": []}
            for which in ("kernel", "plain", "plain", "kernel"):
                fn = tos.correlate_os if which == "kernel" else tos.correlate_os_reference
                turns[which].append(graph_ms(lambda fn=fn: fn(*args)))
            timing = {"ms": float(np.median(turns["kernel"])),
                      "plain_ms": float(np.median(turns["plain"])),
                      "kernel_turns_ms": turns["kernel"], "plain_turns_ms": turns["plain"],
                      "wrapper_ms": cuda_ms(lambda: tos.correlate_os(*args), TIMED_RUNS),
                      "library_ms": cuda_ms(lambda: torch.fft.irfft(prod, n=n), 10)}
            del prod
            bound_ms, bound_by = correlate_bound(b, g, ns, n, c.full_len)
            cluster, ctas, threads, smem = tos.launch_geometry(b, g, ns, n)
            ctas_per_sm, clusters = tos.residency(n)
            record = {"shape": name, "group": gi, "rows": b, "clips": g, "segments": ns,
                      "fft_len": n, "step": step, "out_offset": c.out_offset,
                      "full_len": c.full_len, "cluster": cluster, "ctas": ctas,
                      "threads": threads, "shared_bytes": smem, "ctas_per_sm": ctas_per_sm,
                      "clusters_resident": clusters,
                      "radices": list(tos.correlation_plan(n, dev).radices),
                      "max_abs_err": abs_err, "max_rel_err_vs_cufft": rel_err,
                      "rel_err_vs_f64": errs["kernel"], "cufft_rel_err_vs_f64": errs["cufft"],
                      **timing, "bound_ms": bound_ms, "bound_by": bound_by,
                      "share_of_bound": bound_ms / timing["ms"]}
            phase("correlate_kernel", card=smi, **record)
            records.append(record)
            torch.cuda.synchronize()
        del bank, sections, lens, norm, seg, args
        gc.collect()
        torch.cuda.empty_cache()

    # Every length from 8,192 to 262,144 on seeded spectra of real signals
    # (2 rows, 3 clips, 3 segments): sampled transforms bitwise, the whole
    # output within CORRELATE_RTOL of the cuFFT route's.
    lengths = []
    rng = np.random.default_rng(19)
    for n in CORRELATE_LENGTHS:
        bins, ns = n // 2 + 1, 3
        step = n - n // 8 + 1
        spectra = rng.standard_normal((2, ns + 1, bins, 2)).astype(np.float32)
        spectra[:, :, [0, -1], 1] = 0.0  # real signals' spectra: real at 0 and N / 2
        spectra = torch.from_numpy(spectra)
        seg = torch.view_as_complex(spectra[:, :ns].contiguous()).to(dev)
        bank_c = torch.view_as_complex(spectra[:, ns, :, :].contiguous()).to(dev)
        bank_c = torch.cat([bank_c, bank_c[:1] * 0.5]).contiguous()  # 3 clips
        args = (seg, bank_c, n, step, 3, ns * step - 8)
        out = tos.correlate_os(*args)
        plain = tos.correlate_os_reference(*args)
        torch.cuda.synchronize()
        samples = check_correlate_transforms(out, seg, bank_c, *args[2:],
                                             correlate_picks(2, 3, ns, CORRELATE_PICKS, seed=n))
        compared += samples
        rel_err = float(((out - plain).abs() / plain.amax(dim=-1, keepdim=True)).max())
        if not rel_err <= CORRELATE_RTOL:
            raise AssertionError(f"correlate_os: fft_len {n} lies {rel_err} of a row's maximum "
                                 f"from the cuFFT route (limit {CORRELATE_RTOL})")
        max_abs_err = max(max_abs_err, float((out - plain).abs().max()))
        cluster, ctas, threads, smem = tos.launch_geometry(2, 3, ns, n)
        lengths.append({"fft_len": n, "cluster": cluster, "threads": threads,
                        "shared_bytes": smem, "ctas_per_sm": tos.residency(n)[0],
                        "samples_bitwise": samples, "max_rel_err_vs_cufft": rel_err})
        del seg, bank_c, out, plain, args
    phase("correlate_kernel_lengths", card=smi, lengths=lengths)

    # The main path's launches: every group of a flagship step and of a
    # 16-row round, captured, takes the kernel and never the cuFFT route.
    tos.correlate_os.launches = counted_before
    launches, cufft_calls = {}, {}
    step, bank = flagship_step(dev)
    tos.correlate_os.launches = cufft_correlation.launches = 0
    for _ in range(2):
        step()
    launches["flagship_step"] = tos.correlate_os.launches
    cufft_calls["flagship_step"] = cufft_correlation.launches
    del step, bank
    round_step, bank, _ = flagship_round(dev)
    for mode in ("vmap", "scan"):
        tos.correlate_os.launches = cufft_correlation.launches = 0
        for _ in range(2):
            round_step(mode)
        launches[f"flagship_round_{mode}"] = tos.correlate_os.launches
        cufft_calls[f"flagship_round_{mode}"] = cufft_correlation.launches
    torch.cuda.synchronize()
    del round_step, bank
    want = {"flagship_step": 2 * 2, "flagship_round_vmap": 2 * 2, "flagship_round_scan": 2 * 32}
    if any(cufft_calls.values()) or any(launches[k] < v for k, v in want.items()):
        raise AssertionError(f"correlate_os on the flagship paths: launches {launches} (want at "
                             f"least {want}), calls of the cuFFT route {cufft_calls}")
    phase("correlate_kernel_launches", card=smi, launches_by_path=launches,
          cufft_route_calls_by_path=cufft_calls, transliteration_samples_bitwise=compared,
          widths_bitwise=list(CORRELATE_WIDTHS), replay_bitwise=True, design=CORRELATE_DESIGN)
    tos.correlate_os.launches = cufft_correlation.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    main = next(r for r in records if r["shape"] == "flagship_step")
    return {"launches_by_path": launches, "cufft_route_calls_by_path": cufft_calls,
            "max_abs_err": max_abs_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "wrapper_ms": main["wrapper_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shapes": [{k: r[k] for k in ("shape", "group", "fft_len", "cluster", "ctas_per_sm",
                                           "ms", "plain_ms", "library_ms", "bound_ms",
                                           "share_of_bound")} for r in records],
            "lengths": [r["fft_len"] for r in lengths], "design": CORRELATE_DESIGN}


RAINBOW_CLIP = "天空下的彩虹intro.wav"
RAINBOW_AUDIO = "am1430_section_with_rainbow_intro.wav"
# tests/test_integration_matching.py's mixed bank (:115-117): each section
# against the RTHK marker, the CBS clip and the rainbow intro clip, with
# the detections each pattern must give.
MIXED_BANK = ("rthk_beep.apd.toml", "cbs_news.wav", RAINBOW_CLIP)
MIXED_COUNTS = {"rthk_section_with_beep.wav": {"rthk_beep": 2},
                "cbs_news_audio_section.wav": {"cbs_news": 1},
                RAINBOW_AUDIO: {"天空下的彩虹intro": 1}}


def phase_correlate_flows(dev, smi: str) -> dict[str, int]:
    """Phase 3g (``correlate_flows``): the classes of the 29,488-sample
    rainbow intro clip (fft_len 131,072) on the card. Its golden flow
    (``am1430_section_with_rainbow_intro.wav``, one detection at 13,848 ms)
    and the mixed bank's 3 x 3 matrix (tests/test_integration_matching.py:
    115-117) through the port's ``match`` on the card and on the CPU:
    stdout byte-identical, the detections each pattern must give, the
    correlation kernel launched and the cuFFT route never called on the
    card (counted from 0 around the card runs). Returns the launches by
    run for the kernels line."""
    from audio_pattern_detector_tpu_torch.ops.correlate import cufft_correlation
    from audio_pattern_detector_tpu_torch.ops.correlate_os import correlate_os

    flows = {"rainbow_golden": ([RAINBOW_CLIP], RAINBOW_AUDIO)}
    flows.update({f"mixed_{Path(audio).stem}": (list(MIXED_BANK), audio)
                  for audio in MIXED_COUNTS})
    launches = {}
    for name, (patterns, audio) in flows.items():
        argv = ["match"]
        for pattern in patterns:
            argv += ["--pattern-file", str(CLIPS / pattern)]
        argv.append(str(AUDIO / audio))
        cpu = cli_stdout(argv[:1] + ["--device", "cpu"] + argv[1:])
        correlate_os.launches = cufft_correlation.launches = 0
        card = cli_stdout(argv)
        launches[name] = correlate_os.launches
        if cufft_correlation.launches or not correlate_os.launches:
            raise AssertionError(f"{name}: {correlate_os.launches} correlation kernel launches, "
                                 f"{cufft_correlation.launches} calls of the cuFFT route")
        if card != cpu:
            raise AssertionError(f"{name}: the card's stdout differs from the CPU's:\n{card}\n"
                                 f"{cpu}")
        events = [json.loads(line) for line in card.splitlines() if line.startswith("{")]
        found = detections(events)
        want = MIXED_COUNTS[audio] if name.startswith("mixed") else {"天空下的彩虹intro": 1}
        counts = {p: sum(1 for clip, _ in found if clip == p) for p in want}
        if counts != want or len(found) != sum(want.values()):
            raise AssertionError(f"{name}: detections {found}, want {want}")
        if name == "rainbow_golden" and found != [("天空下的彩虹intro", 13848)]:
            raise AssertionError(f"rainbow golden flow: {found}")
        phase("correlate_flows", card=smi, flow=name, detections=found, stdout_equal_cpu=True,
              correlate_os_launches=launches[name], cufft_route_calls=0)
    correlate_os.launches = cufft_correlation.launches = 0
    return launches


def phase_general_plateau(dev, smi: str, num_normal: int = 32, num_marker: int = 32,
                          profile: "Path | None" = None) -> dict[str, int]:
    """Phase 3c: the general-plateau tier (``height_min = 0``) as a captured
    step, on the flagship round (16 sections of 60 s, seeds 1-16) in both
    batch modes. Its lane greedy is one kernel launch a group
    (``csrc/lane_greedy.cu``) and each verifier one launch of every lane
    (the kernels compute only live lanes), so neither the captured step
    nor the eager one (the same bank with ``capture`` off) makes a host
    sync for them. In turns (eager, captured, captured, eager; twice in vmap),
    after an eager reference run and the key's first use: the host ms
    until ``dispatch_chunks_batch`` returns and until the payload is on
    the host, and the device span of the dispatch (CUDA
    events around it: the device's work, or its wait for the host); every
    payload bitwise the eager reference's. Also the key's capture seconds,
    the memory its first use peaked at and what the graph pools keep with
    the cache emptied (the graph's and the bodies' apart), the eager
    round's peak allocated and reserved, the launches of each kernel in one
    captured round (the scan and the lane greedy, one per group per replay:
    the kernels line's counts, from 0), the profiled device-busy ms of a
    captured and an eager vmap round, the lean tier's captured round, timed
    first, and PR 11's time to the payload beside this run's. Nothing is
    collected: at a threshold of 0 every row of noise is flagged, and
    resolving them is the host path's time, not the tier's. Returns the
    launches by mode."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy

    tables = Path(tempfile.mkdtemp()) if profile is None else profile
    sr = 8000
    chunks = noise_chunks(ROUND_ROWS)
    gen = make_detector(num_normal, num_marker, 60, dev, sr, height_min=0.0)._ensure_bank()
    groups = sum(len(c["groups"]) for c in gen.classes.values())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()

    def dispatch(bank, mode: str) -> tuple[list, float, float, float]:
        return timed_dispatch(bank, chunks, mode)

    equal = arrays_equal

    out: dict = {"node_route": captured.CudaGraphBackend.conditional_route,
                 "two_way_cond": "two if-nodes, on pred and on ~pred",
                 "resident_gb": resident / 1e9}
    # The lean tier's captured round first, for scale; its bank and graph
    # pools go before the general tier's 16-row key is captured.
    lean = make_detector(num_normal, num_marker, 60, dev, sr)._ensure_bank()
    lean_ms = {}
    for mode in ("vmap", "scan"):
        lean.dispatch_chunks_batch(chunks, None, mode=mode)  # the key's first use
        lean_ms[mode] = [dispatch(lean, mode)[2] for _ in range(2)]
    del lean
    torch.cuda.empty_cache()
    launches: dict[str, int] = {}
    for mode in ("vmap", "scan"):
        rows = ROUND_ROWS if mode == "vmap" else 1
        times: dict[str, list] = {"eager": [], "captured": []}
        gen.capture = False
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eager_reserved = torch.cuda.memory_reserved()
        ref, *t = dispatch(gen, mode)
        if mode == "scan":  # a vmap round's first run makes its cuFFT plans: not a turn
            times["eager"].append(t)
        eager_peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        eager_peak_reserved = (torch.cuda.max_memory_reserved() - eager_reserved) / 1e9
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        gen.capture = True
        first, _, first_ms, _ = dispatch(gen, mode)
        first_peak = (torch.cuda.max_memory_allocated() - alloc) / 1e9
        torch.cuda.empty_cache()
        pool_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
        split = pools_gb(gen.graphs._backend)
        if not equal(first, ref):
            raise AssertionError(f"general tier, {mode}: the captured first use differs from eager")
        turns = ("captured", "captured", "eager") if mode == "scan" else (
            ("eager", "captured", "captured", "eager") * 2)
        path = f"general_plateau_{mode}"
        for name in turns:
            gen.capture = name == "captured"
            candidate_scan.launches = lane_greedy.launches = 0
            counting = contextlib.nullcontext()
            if gen.capture:  # one captured round's launches, as the lane greedy's
                for counts in VERIFY_PATH_LAUNCHES.values():
                    counts.pop(path, None)
                counting = counted_verify_launches(path, lambda: [gen])
            with counting:
                got, *t = dispatch(gen, mode)
            if name == "captured":
                launches[mode] = candidate_scan.launches
                lane = GREEDY_PATH_LAUNCHES["lane_greedy"][f"general_plateau_{mode}"] = (
                    lane_greedy.launches)
                if launches[mode] != groups * (ROUND_ROWS // rows) or lane != launches[mode]:
                    raise AssertionError(
                        f"general tier, {mode}: {launches[mode]} scan and {lane} lane greedy "
                        "launches in a captured round, want one each per group per replay")
            if not equal(got, ref):
                raise AssertionError(f"general tier, {mode}: {name} payload differs from eager")
            times[name].append(t)
        (key,) = [s for s in gen.graphs.steps() if s.key.rows == rows]
        if not key.key.general:
            raise AssertionError("the general tier's key does not name its tier")
        entry = {
            **{f"{name}_{field}": [t[i] for t in v] for name, v in times.items()
               for i, field in enumerate(("dispatch_returns_ms", "payload_on_host_ms",
                                          "device_span_ms"))},
            "captured_first_use_ms": first_ms, "capture_s": key.capture_seconds,
            "replays_a_round": ROUND_ROWS // rows, "kernel_launches_a_round": launches[mode],
            "lane_greedy_launches_a_round":
                GREEDY_PATH_LAUNCHES["lane_greedy"][f"general_plateau_{mode}"],
            "pr11_captured_payload_on_host_ms": PR11_MS[f"general_plateau_{mode}_payload_on_host"],
            "first_use_peak_gb": first_peak, "pool_gb": pool_gb, "pools_gb_by_pool": split,
            "eager_peak_gb": eager_peak, "eager_peak_reserved_gb": eager_peak_reserved,
            "lean_captured_payload_on_host_ms": lean_ms[mode],
        }
        # The repaired fault: a captured dispatch returns long before its
        # payload reaches the host (eager: within the final copy's time).
        share = max(a / b for a, b, _ in times["captured"])
        entry["captured_dispatch_share_of_payload_max"] = share
        if mode == "vmap":
            gen.capture = True
            entry["profile_captured"] = profile_run(
                lambda: dispatch(gen, mode), tables / "general_plateau_vmap_captured.txt")
            gen.capture = False
            entry["profile_eager"] = profile_run(
                lambda: dispatch(gen, mode), tables / "general_plateau_vmap_eager.txt")
            gen.capture = True
            if share >= 0.5:
                raise AssertionError(f"general tier, vmap: a captured dispatch took {share:.2f} "
                                     "of the time to its payload")
        out[mode] = entry
    phase("general_plateau", card=smi, clips=num_normal + num_marker, rows=ROUND_ROWS,
          section_s=60, payloads_equal_to_eager=True, **out)
    del gen, key
    gc.collect()  # the bank's graphs and their pools, tens of GB for the 16-row key
    torch.cuda.empty_cache()
    return launches


def cbs_pcm() -> tuple[np.ndarray, int]:
    """The CBS sample as int16 PCM, and its rate."""
    with wave.open(str(CBS), "rb") as w:
        rate, frames = w.getframerate(), w.readframes(w.getnframes())
    return np.frombuffer(frames, dtype=np.int16), rate


def sharded_scan(sd, audio: np.ndarray, scan=None):
    """``audio`` (B, T) through a ShardedDetector slab by slab with ``scan``
    as every cell's candidate scan: (timestamps, per-slab payloads, kernel
    launches, wall s). The launches are counted from 0."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    sd.scan = scan or candidate_scan
    sess = sd.session()
    times = {c.name: [[] for _ in audio] for c in sd._detector.audio_clips}
    payloads = []
    candidate_scan.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for start in range(0, audio.shape[1], sd.slab_samples):
        for name, per in sess.feed(audio[:, start : start + sd.slab_samples]).items():
            for b, ts in enumerate(per):
                times[name][b].extend(ts)
        payloads.append({sw: [p.copy() for p in ps] for sw, ps in sess.last_payloads.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sd.scan = candidate_scan
    return times, payloads, candidate_scan.launches, wall


def serial_scan(det, row: np.ndarray) -> tuple[dict, float]:
    """One f32 stream through the serial engine: (timestamps, wall s)."""
    import torch

    from audio_pattern_detector_tpu_torch.utils.clip import AudioStream

    torch.cuda.synchronize()
    t = time.perf_counter()
    peaks, _ = det.find_clip_in_audio(AudioStream(
        name="s", audio_stream=io.BytesIO(row.tobytes()), sample_rate=det.target_sample_rate))
    torch.cuda.synchronize()
    return peaks, time.perf_counter() - t


def phase_mesh(dev, smi: str, num_normal: int = 32, num_marker: int = 32) -> dict[str, int]:
    """Phase 11: the device mesh on logical shards of ``dev`` at the
    flagship width, each path against the serial engine (a smaller bank of
    the same clips rehearses it on the CPU). Returns the kernel launches
    of each path, counted from 0."""
    import torch

    from audio_pattern_detector_tpu_torch import native
    from audio_pattern_detector_tpu_torch.flagship import dryrun_multichip, make_detector
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )
    from audio_pattern_detector_tpu_torch.parallel import ShardedDetector, make_mesh
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    launches: dict[str, int] = {}

    # ── 11a. Time sharding: the flagship bank and the CBS clip over the
    # tiled file, 4 time shards of 60 s (slabs of 240 s, 240 s and 1.8 s) ──
    pcm, rate = cbs_pcm()
    audio = native.pcm16_to_f32_mono(np.tile(pcm, 15))[None]
    cbs_clip = AudioClip.from_audio_file(str(CBS_CLIP), sample_rate=rate)
    on_card = dev.type == "cuda"
    det = make_detector(num_normal, num_marker, 60, dev, rate, extra_clips=(cbs_clip,))
    bank = det._ensure_bank()
    groups = sum(len(c["groups"]) for c in bank.classes.values())
    sd = ShardedDetector(det.audio_clips, make_mesh({"time": 4}, devices=[dev] * 4),
                         chunk_seconds=60, detector=det)
    n_chunks = -(-audio.shape[1] // sd.chunk_samples)
    want_launches = n_chunks * groups  # one cell per chunk, one launch per group
    sharded_scan(sd, audio[:, : sd.slab_samples])  # first use: replicas, cuFFT plans
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    walls: dict[str, list[float]] = {"sharded": [], "serial": []}
    for name in ("sharded", "serial", "serial", "sharded"):
        if name == "sharded":
            times, payloads, n_launches, wall = sharded_scan(sd, audio)
            peak = torch.cuda.max_memory_allocated()
        else:
            serial, wall = serial_scan(det, audio[0])
        walls[name].append(wall)
    got = {name: sorted(per[0]) for name, per in times.items()}
    if got != serial or len(serial[cbs_clip.name]) != 15:
        raise AssertionError(f"time mesh: sharded {got} != serial {serial}")
    if on_card and n_launches != want_launches:
        raise AssertionError(f"time mesh: kernel launches {n_launches}, want {want_launches}")
    plain_times, plain_payloads, plain_launches, _ = sharded_scan(
        sd, audio, candidate_scan_reference)
    cells = 0
    for slab, other in zip(payloads, plain_payloads):
        for sw in slab:
            for a, b in zip(slab[sw], other[sw]):
                if a.tobytes() != b.tobytes():
                    raise AssertionError("time mesh: a cell's payload differs between the kernel "
                                         "and the plain scan")
                cells += a.shape[0] * a.shape[1]
    if plain_times != times or plain_launches != 0:
        raise AssertionError(f"time mesh with the plain scan: launches {plain_launches}")
    launches["mesh_time_4"] = n_launches
    audio_s = audio.shape[1] / rate
    phase("mesh_time", card=smi, logical_shards=True, time_shards=4, clips=len(det.audio_clips),
          groups=groups, audio_s=audio_s, chunk_s=60, slabs=len(payloads), chunks=n_chunks,
          detections=len(serial[cbs_clip.name]), equal_to_serial_engine=True,
          payloads_bit_equal_with_plain_scan=True, cells_compared=cells // len(bank.classes),
          kernel_launches=n_launches, predicted_launches=want_launches,
          sharded_wall_s=walls["sharded"], serial_wall_s=walls["serial"],
          sharded_x_realtime=audio_s / float(np.median(walls["sharded"])),
          serial_x_realtime=audio_s / float(np.median(walls["serial"])),
          peak_mem_gb=(peak - resident) / 1e9, resident_gb=resident / 1e9)
    del sd, det, bank, payloads, plain_payloads

    # ── 11b. bank x time and stream x time, 2 x 2, on the flagship bank ──
    det = make_detector(num_normal, num_marker, 60, dev, rate)
    audios, _, _ = serving_streams(det, rate)
    pair = np.stack([audios[0], audios[1]])  # two 180 s streams: a full slab and a 60 s one
    serials = [serial_scan(det, row) for row in pair]
    for name, axes, batch in (("mesh_bank_2_time_2", {"bank": 2, "time": 2}, pair[:1]),
                              ("mesh_stream_2_time_2", {"stream": 2, "time": 2}, pair)):
        sd = ShardedDetector(det.audio_clips, make_mesh(axes, devices=[dev] * 4),
                             chunk_seconds=60, detector=det)
        times, _, n_launches, wall = sharded_scan(sd, batch)
        for b, (serial, _) in enumerate(serials[: len(batch)]):
            got = {n: sorted(per[b]) for n, per in times.items()}
            if got != serial:
                raise AssertionError(f"{name}, stream {b}: sharded {got} != serial {serial}")
        cells = 3 * axes.get("stream", 1) * axes.get("bank", 1)  # 3 chunks a stream
        if on_card and n_launches != cells * 2:
            raise AssertionError(f"{name}: kernel launches {n_launches}, want {cells * 2}")
        launches[name] = n_launches
        phase(name, card=smi, logical_shards=True, axes=axes, streams=len(batch), audio_s=180,
              equal_to_serial_engine=True, kernel_launches=n_launches, sharded_wall_s=wall,
              serial_wall_s=[w for _, w in serials[: len(batch)]],
              detections=sum(len(ts) for per in times.values() for ts in per))
        del sd
    del det

    # ── 11c. bank x stream x time: the dry run of 8 shards ──
    candidate_scan.launches = 0
    t = time.perf_counter()
    report = dryrun_multichip(8, dev, num_normal, num_marker)
    launches["dryrun_multichip_8"] = candidate_scan.launches
    phase("dryrun_multichip", card=smi, equal_to_serial_engine=True,
          kernel_launches=candidate_scan.launches, wall_s=time.perf_counter() - t, **report)
    return launches


def phase_wide_rerun(dev, smi: str, num_normal: int = 32, num_marker: int = 32) -> None:
    """Phase 7: every route of a flagged row on the flagship bank (a
    smaller bank of the same clips rehearses it on the CPU)."""
    from audio_pattern_detector_tpu_torch.models import hostpath
    from audio_pattern_detector_tpu_torch.flagship import make_bank
    from audio_pattern_detector_tpu_torch.models.bank import _split_fused, unpack_group
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy

    bank = make_bank(num_normal, num_marker, chunk_seconds=60, device=dev)
    groups = bank.classes[1]["groups"]
    want_route = {"row": 0, "class": 1, "escalated": 2, "clear": None}
    candidate_scan.launches = lane_greedy.launches = 0
    sections = rerun_sections(bank)
    with counted_verify_launches("wide_rerun", lambda: [bank]):
        for name, audio in sections.items():
            before = routes(bank)
            dispatched = bank.dispatch_chunk(audio, None)
            flat = dispatched[0][1].numpy()
            flagged = []
            for g, packed in zip(groups, _split_fused(flat, groups)):
                _, _, host_fb, needs_full = unpack_group(packed, g.k_verify)
                flagged += [(g, ci) for ci in np.flatnonzero(host_fb | needs_full)]
            t = time.perf_counter()
            got = bank.collect_chunk(dispatched)
            collect_s = time.perf_counter() - t
            delta = tuple(a - b for a, b in zip(routes(bank), before))
            host_ms = []
            for g, ci in flagged:
                t = time.perf_counter()
                want = hostpath.process_section_host(
                    audio_section=audio, clip=g.clips_np[ci], correlation_clip=g.corr_clips_np[ci],
                    correlation_clip_absolute_max=float(g.self_max_np[ci]), sr=bank.sample_rate,
                    height_min=bank.height_min, is_short_clip=g.clip_len / bank.sample_rate < 0.5,
                    tone_frequency=g.tone_freqs[ci], verification_params=g.verification_params[ci],
                )
                host_ms.append((time.perf_counter() - t) * 1e3)
                if got[g.names[ci]] != want:
                    raise AssertionError(f"{name}: {g.names[ci]} {got[g.names[ci]]} != host {want}")
            route = want_route[name]
            if delta[3] != 0 or (route is None and (flagged or any(delta))) or (
                route is not None and delta[route] < 1
            ) or (name == "row" and delta[1] != 0):
                raise AssertionError(f"{name}: routes (row, class, escalated, host) {delta}")
            phase("wide_rerun_route", section=name, flagged_rows=[g.names[ci] for g, ci in flagged],
                  routes_row_class_escalated_host=delta, collect_s=collect_s,
                  host_path_ms_per_row=float(np.median(host_ms)) if host_ms else None,
                  detections={k: len(v) for k, v in got.items() if v}, equal_to_host_path=True)
    lean_launches = candidate_scan.launches
    lane = GREEDY_PATH_LAUNCHES["lane_greedy"]["wide_rerun"] = lane_greedy.launches
    if lane < 3:  # a row, a class and an escalated rerun, at least one group each
        raise AssertionError(f"the reruns launched the lane greedy {lane} times")

    normal = next(gi for gi, g in enumerate(groups) if g.kind == "normal")
    marker = next(gi for gi, g in enumerate(groups) if g.kind == "marker")
    row_vs_class = {}
    for name, gi in (("row", normal), ("escalated", marker)):
        row = bank._full_tier_row(1, gi, 0, sections[name])
        whole = bank._full_tier_packed(1, sections[name])[gi][0]
        row_vs_class[groups[gi].names[0]] = bool(np.array_equal(row.view(np.int32),
                                                                whole.view(np.int32)))
    if not all(row_vs_class.values()):
        raise AssertionError(f"a row rerun's payload differs from the class rerun's row: "
                             f"{row_vs_class}")
    reps = dict(runs=3, reps=3)
    phase("wide_rerun", card=smi, clips=num_normal + num_marker, section_s=61,
          row_rerun_ms=cuda_ms(lambda: bank._full_tier_row(1, normal, 0, sections["row"]), **reps),
          marker_row_rerun_ms=cuda_ms(
              lambda: bank._full_tier_row(1, marker, 0, sections["escalated"]), **reps),
          escalated_row_rerun_ms=cuda_ms(
              lambda: bank._full_tier_row(1, marker, 0, sections["escalated"], capped=False),
              **reps),
          class_rerun_ms=cuda_ms(lambda: bank._full_tier_packed(1, sections["class"]), **reps),
          row_payload_bitwise_equal_to_class_rerun=row_vs_class,
          lean_kernel_launches=lean_launches, lane_greedy_launches=lane,
          host_path_rows=bank.host_path_rows,
          pr11_escalated_row_rerun_ms=PR11_MS["wide_rerun_escalated_row"],
          pr11_marker_row_rerun_ms=PR11_MS["wide_rerun_marker_row"])
    del bank, sections


def phase_entry_points(dev) -> None:
    """Phase 8: the port's CLI in subprocesses on ``dev`` (on a CUDA card
    each run must launch the kernel and the trace must hold device
    kernels)."""
    on_card = dev.type == "cuda"
    device_args = ["--device", str(dev.type)]
    rthk_wav, cbs_wav, cbs_clip = RTHK.read_bytes(), CBS.read_bytes(), CBS_CLIP.read_bytes()
    mux = (struct.pack("<II", 1, 8) + b"cbs_news" + struct.pack("<I", len(cbs_clip)) + cbs_clip
           + cbs_wav)
    rthk_out = jsonl_block(str(RTHK), RTHK_HITS, 4078, "00:00:04.078")
    cbs_out = jsonl_block(str(CBS), CBS_HITS, 32122, "00:00:32.122")
    with tempfile.TemporaryDirectory() as tmp:
        tmpd = Path(tmp)
        rthk_args = ["--pattern-file", str(RTHK_TOML), str(RTHK)]
        cases = {
            "stdin": (["--stdin", "--pattern-file", str(RTHK_TOML)], rthk_wav,
                      jsonl_block("stdin", RTHK_HITS, 4089, "00:00:04.089")),
            "multiplexed_stdin": (["--multiplexed-stdin"], mux,
                                  jsonl_block("multiplexed-stdin", CBS_HITS, 32122, "00:00:32.122")),
            "offline_batch": (["--offline-batch", "4", *rthk_args], None, rthk_out),
            "offline_batch_vmap": (["--offline-batch", "4", "--offline-batch-mode", "vmap",
                                    *rthk_args], None, rthk_out),
            "stream_batch": (["--stream-batch", "4", *rthk_args], None, rthk_out),
            "stream_batch_vmap": (["--stream-batch", "4", "--stream-batch-mode", "vmap",
                                   *rthk_args], None, rthk_out),
            "checkpoint_file": (["--chunk-seconds", "2", "--checkpoint-file", str(tmpd / "ck"),
                                 *rthk_args], None, rthk_out),
            "debug": (["--debug", "--debug-dir", str(tmpd / "debug"), *rthk_args], None, rthk_out),
            "trace_dir": (["--trace-dir", str(tmpd / "trace"), *rthk_args], None, rthk_out),
            "two_files": (["--pattern-file", str(RTHK_TOML), "--pattern-file", str(CBS_CLIP),
                           str(RTHK), str(CBS)], None, rthk_out + cbs_out),
            "height_min_0": (["--height-min", "0", "--pattern-file", str(CBS_CLIP), str(CBS)],
                             None, cbs_out),
        }
        two_files = ["--pattern-file", str(RTHK_TOML), "--pattern-file", str(CBS_CLIP),
                     str(RTHK), str(CBS)]
        # The mesh entry points on logical shards of the device, with the
        # kernel launches each must make: one per active cell and group.
        # The 4 s file fills one time shard of one slab; --mesh-bank 2 pads
        # the one-clip group to 2 rows, one per bank shard; --mesh-stream 2
        # runs the two files as one round of 2 rows over 2 shards, each
        # launching both groups.
        mesh_cases = {
            "mesh_time_4": (["--mesh-time", "4", *rthk_args], 4, rthk_out, 1),
            "mesh_time_2_bank_2": (["--mesh-time", "2", "--mesh-bank", "2", *rthk_args], 4,
                                   rthk_out, 2),
            "mesh_stream_2": (["--mesh-stream", "2", *two_files], 2, rthk_out + cbs_out, 4),
        }
        entry_rows = {}
        for name, (args, stdin, want) in cases.items():
            out, report, wall = run_entry([*device_args, *args], stdin)
            if out != want or report["jax_imported"] or report["launches"] < on_card:
                raise AssertionError(f"{name}: {report}, stdout {out!r}, want {want!r}")
            entry_rows[name] = (report["launches"], wall)
        for name, (args, logical, want, want_launches) in mesh_cases.items():
            out, report, wall = run_entry([*device_args, *args], logical=logical)
            if out != want or report["jax_imported"] or (
                    on_card and report["launches"] != want_launches):
                raise AssertionError(f"{name}: {report} (want {want_launches} launches), "
                                     f"stdout {out!r}, want {want!r}")
            entry_rows[name] = (report["launches"], wall)
        refused = subprocess.run(
            entry_command([*device_args, "--mesh-time", "64", *rthk_args]), capture_output=True,
            cwd=ROOT, env=entry_env(4), timeout=300)
        if refused.returncode == 0 or b"mesh needs 64 devices, only 4 available" not in (
                refused.stderr) or b"pattern_detected" in refused.stdout:
            raise AssertionError(f"--mesh-time 64: exit {refused.returncode}: "
                                 f"{refused.stderr.decode()[-2000:]}")
        # A vmap run's stdout equals its scan twin's (both equal the pinned
        # text above); its 4 rows, 3 of them padding, are one launch.
        for name in ("offline_batch", "stream_batch"):
            scan_n, vmap_n = entry_rows[name][0], entry_rows[name + "_vmap"][0]
            if on_card and (scan_n, vmap_n) != (4, 1):
                raise AssertionError(f"{name}: kernel launches scan {scan_n}, vmap {vmap_n}; "
                                     "want 4 and 1")
        if (tmpd / "ck").exists() or not list((tmpd / "debug").rglob("*.txt")):
            raise AssertionError("checkpoint file left behind, or no debug artifacts")
        traces = list((tmpd / "trace").glob("*.json"))
        trace = json.loads(traces[0].read_text()) if len(traces) == 1 else {}
        device_ops = [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]
        if not trace.get("traceEvents") or (on_card and not device_ops):
            raise AssertionError(f"trace {traces} holds no device kernels")

        # Resume: the rerun of an interrupted run's command skips the chunk
        # it checkpointed; its first section looks back 1 s into that
        # chunk, so the 1408 ms beep is found again there.
        ck = tmpd / "resume.ck"
        head = interrupted_stdin_run(rthk_wav, ck, device_args)
        out, report, wall = run_entry(
            [*device_args, "--stdin", "--chunk-seconds", "2", "--checkpoint-file", str(ck),
             "--pattern-file", str(RTHK_TOML)], rthk_wav)
        head_hits = detections([json.loads(x) for x in head.splitlines()])
        tail_hits = detections([json.loads(x) for x in out.splitlines()])
        if (head_hits != RTHK_HITS_MS[:1] or tail_hits != RTHK_HITS_MS or ck.exists()
                or report["jax_imported"] or report["launches"] < on_card):
            raise AssertionError(f"resume: head {head_hits}, resumed {tail_hits}, {report}")
        entry_rows["checkpoint_resume"] = (report["launches"], wall)
        phase("entry_points", golden_stdout=True, jax_imported=False,
              mesh_time_64_refused=True,
              kernel_launches={k: v[0] for k, v in entry_rows.items()},
              wall_s={k: round(v[1], 2) for k, v in entry_rows.items()},
              trace_kernel_events=len(device_ops))


def serving_streams(det, sr: int) -> tuple[list[np.ndarray], list[list], list[list]]:
    """Phase 9's streams and their rounds (numpy seeds 10-21; 60 s chunks).

    Streams 0-10 start in round 1 and carry 3 chunks each, except stream 9,
    which ends after its first. Each has seeded noise, copies of the bank's
    normal clip ``normal_<i mod 32>`` at 7 s + 50 s k and a 900 Hz tone (the
    ``marker_0`` clip's frequency) at 31 s + 60 s k. Stream 3's second
    chunk's section is phase 7's "row" flood section (a row rerun inside
    a round); stream 5 is int16. Stream 11 starts in round 2 with 3
    chunks. Rounds 1-3 hold 11 rows, round 4 one. Returns the streams,
    the rounds (16 slots) and each stream's planted (clip, second) pairs
    outside the flood."""
    bank = det._ensure_bank()
    normal = next(g for g in bank.classes[1]["groups"] if g.kind == "normal")
    tone = (0.8 * np.sin(2 * np.pi * 900.0 * np.arange(2000) / sr)).astype(np.float32)
    audios = []
    for i in range(12):
        secs = 60 if i == 9 else 180
        audio = (0.004 * np.random.default_rng(10 + i).standard_normal(secs * sr)).astype(np.float32)
        for t in range(7, secs, 50):
            audio[t * sr : (t + 1) * sr] += normal.clips_np[i % len(normal.names)]
        for t in range(31, secs, 60):
            audio[t * sr : t * sr + len(tone)] += tone
        audios.append(audio)
    audios[3][59 * sr : 120 * sr] = rerun_sections(bank)["row"]
    audios[5] = np.clip(np.round(audios[5] * 16384), -32768, 32767).astype(np.int16)
    planted = [
        [(normal.names[i % len(normal.names)], t) for t in range(7, len(a) // sr, 50)
         if not (i == 3 and 59 <= t < 120)]
        for i, a in enumerate(audios)
    ]
    chunk = 60 * sr
    chunks = [[a[o : o + chunk] for o in range(0, len(a), chunk)] for a in audios]
    rounds = []
    for r in range(4):
        row = [c[r] if r < len(c) else None for c in chunks[:11]]
        row.append(chunks[11][r - 1] if r else None)
        rounds.append(row + [None] * 4)
    return audios, rounds, planted


def drive_session(session, rounds: list, in_flight: int) -> tuple[list[dict], list[float]]:
    """Dispatch the rounds with ``in_flight`` kept in flight; each slot's
    accumulated detections and the host time of each collect's end."""
    acc = [{c.name: [] for c in session.detector.audio_clips} for _ in range(session.n_streams)]
    pending, done = [], []

    def collect() -> None:
        for a, res in zip(acc, session.collect(pending.pop(0))):
            for name, ts in res.items():
                a[name].extend(ts)
        done.append(time.perf_counter())

    for chunks in rounds:
        pending.append(session.dispatch(chunks))
        if len(pending) >= in_flight:
            collect()
    while pending:
        collect()
    return acc, done


def phase_multistream(
    dev, smi: str, num_normal: int = 32, num_marker: int = 32, profile: "Path | None" = None
) -> dict[str, int]:
    """Phase 9: the serving session on the flagship detector (16 slots,
    tile 16, 2 rounds in flight) in both batch modes against the serial
    engine, the kernel's launches (one per row and group in ``scan``, one
    per dispatch and group in ``vmap``), the kernel against its plain
    version on a round's zero-length and short rows, and the steady-state
    round time of both modes in turns (with ``profile``, one 16-row round
    of each under torch.profiler, its op table written there). Returns the
    kernel launches of each mode's counted session run."""
    import torch

    from audio_pattern_detector_tpu_torch.utils.clip import AudioStream
    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models.bank import class_step, dispatch_phase_seconds
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    on_card = dev.type == "cuda"
    det = make_detector(num_normal, num_marker, chunk_seconds=60, device=dev)
    bank = det._ensure_bank()
    sr = bank.sample_rate
    audios, rounds, planted = serving_streams(det, sr)
    groups = sum(len(c["groups"]) for c in bank.classes.values())
    serial = [
        det.find_clip_in_audio(AudioStream(
            name=f"s{i}", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=sr,
            sample_dtype=audio.dtype,
        ))
        for i, audio in enumerate(audios)
    ]
    dispatch = bank.dispatch_chunks_batch

    def counted_run(batch_mode: str) -> dict:
        session = MultiStreamSession(det, 16, tile=16, batch_mode=batch_mode)
        widths: list[list[int]] = []
        modes = set()

        def recording_dispatch(chunks, *a, **kw):
            widths[-1].append(len(chunks))
            modes.add(kw["mode"])
            return dispatch(chunks, *a, **kw)

        bank.dispatch_chunks_batch = recording_dispatch
        original_session_dispatch = session.dispatch

        def session_dispatch(chunks):
            widths.append([])
            return original_session_dispatch(chunks)

        session.dispatch = session_dispatch
        before = routes(bank)
        candidate_scan.launches = 0
        t = time.perf_counter()
        try:
            acc, _ = drive_session(session, rounds, in_flight=2)
        finally:
            bank.dispatch_chunks_batch = dispatch
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = candidate_scan.launches
        delta = tuple(a - b for a, b in zip(routes(bank), before))
        rows = sum(sum(w) for w in widths)
        dispatches = sum(len(w) for w in widths)
        if widths[0] != [8, 2, 1] or rows != 34 or modes != {batch_mode}:
            raise AssertionError(
                f"{batch_mode}: tile widths per round {widths} in modes {modes}, "
                "want [8, 2, 1] first and 34 rows")
        want = (rows if batch_mode == "scan" else dispatches) * groups
        if on_card and launches != want:
            raise AssertionError(f"{batch_mode}: kernel launches {launches}, want {want}")
        if delta[0] < 1 or delta[3] != 0:
            raise AssertionError(
                f"{batch_mode}: routes (row, class, escalated, host) {delta}: "
                "want a row rerun, no host")
        for i, (want_peaks, total) in enumerate(serial):
            if acc[i] != want_peaks or session.total_time(i) != total:
                raise AssertionError(
                    f"{batch_mode}, stream {i}: session {acc[i]} != serial {want_peaks}")
            for name, sec in planted[i]:
                if not any(abs(x - sec) < 0.01 for x in acc[i][name]):
                    raise AssertionError(
                        f"{batch_mode}, stream {i}: {name} at {sec} s not detected: {acc[i][name]}")
        return {"widths": widths, "rows": rows, "dispatches": dispatches, "launches": launches,
                "routes": delta, "wall_s": wall,
                "detections": sum(len(v) for a in acc[:12] for v in a.values())}

    counted = {mode: counted_run(mode) for mode in ("scan", "vmap")}

    # ── The same streams with each round's rows split over a stream mesh
    # of two logical shards of the device (an untiled 16-row "vmap" round,
    # 8 rows a shard, idle slots as zero-length rows) ──
    def mesh_run() -> dict:
        from audio_pattern_detector_tpu_torch.parallel import make_mesh

        mesh = make_mesh({"stream": 2}, devices=[dev] * 2)
        session = MultiStreamSession(det, 16, mesh=mesh)
        before = routes(bank)
        candidate_scan.launches = 0
        t = time.perf_counter()
        acc, _ = drive_session(session, rounds, in_flight=2)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = candidate_scan.launches
        delta = tuple(a - b for a, b in zip(routes(bank), before))
        want = len(rounds) * mesh.shape["stream"] * groups
        if on_card and launches != want:
            raise AssertionError(f"stream mesh: kernel launches {launches}, want {want}")
        if session._batch_mode != "vmap" or delta != counted["vmap"]["routes"]:
            raise AssertionError(f"stream mesh: mode {session._batch_mode}, routes {delta}, "
                                 f"unsharded {counted['vmap']['routes']}")
        for i, (want_peaks, total) in enumerate(serial):
            if acc[i] != want_peaks or session.total_time(i) != total:
                raise AssertionError(
                    f"stream mesh, stream {i}: session {acc[i]} != serial {want_peaks}")
        return {"launches": launches, "routes": delta, "wall_s": wall,
                "detections": sum(len(v) for a in acc[:12] for v in a.values())}

    counted["mesh"] = mesh_run()
    if counted["mesh"]["detections"] != counted["vmap"]["detections"]:
        raise AssertionError(f"stream mesh detections {counted['mesh']['detections']}")

    # ── The kernel on a zero-length and a short row of an untiled round ──
    short = audios[0][: 7 * sr]
    full = audios[1][:60 * sr]
    want_rows = [det.peaks_to_times(bank.process_chunk(short, None), 0, False), {}, {},
                 det.peaks_to_times(bank.process_chunk(full, None), 0, False)]
    for mode in ("scan", "vmap"):
        untiled = MultiStreamSession(det, 4, batch_mode=mode)
        if untiled.feed([short, np.zeros(0, np.float32), None, full]) != want_rows:
            raise AssertionError(
                f"{mode}: an untiled round with idle rows differs from single chunks")
    cls = bank.classes[1]
    consts = tuple((g.corr, g.verify) for g in cls["groups"])
    errs = []

    def checked_scan(corr, thr, valid_len):
        got = candidate_scan(corr, thr, valid_len)
        errs.append(check_scan_equal(got, candidate_scan_reference(corr, thr, valid_len)))
        return got

    step_kw = dict(metas=bank._metas[1], height_min=bank.height_min, scan=checked_scan)
    idle = [short, np.zeros(0, np.float32), full]
    batch = torch.zeros((len(idle), cls["section_len"]), device=dev)
    for bi, raw in enumerate(idle):
        batch[bi, : len(raw)] = torch.from_numpy(raw).to(dev)
        class_step(batch[bi], len(raw), cls["loud"], consts, **step_kw)
    # The same three rows as one batched step: one launch per group, with
    # a short, a zero-length and a full row in it.
    lens = torch.tensor([len(raw) for raw in idle], dtype=torch.int32, device=dev)
    class_step(batch, lens, cls["loud"], consts, **step_kw)
    if on_card:
        torch.cuda.synchronize()

    # ── Steady state: 16 full rows per round, both modes in turns ──
    rng = np.random.default_rng(30)
    n_rounds = 3
    timed = {mode: MultiStreamSession(det, 16, tile=16, batch_mode=mode)
             for mode in ("scan", "vmap")}
    full_rounds = [[(0.004 * rng.standard_normal(60 * sr)).astype(np.float32) for _ in range(16)]
                   for _ in range(n_rounds + 1)]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for session in timed.values():
        session.feed(full_rounds[0])

    # The host time of each dispatch stage (the bank's process-wide clock),
    # summed per mode over the timed rounds.
    split: dict[str, dict[str, float]] = {}

    def steady_ms(mode: str, rounds_of=full_rounds) -> float:
        before = dict(dispatch_phase_seconds)
        t = time.perf_counter()
        drive_session(timed[mode], rounds_of[1:], in_flight=2)
        ms = (time.perf_counter() - t) / n_rounds * 1e3
        acc = split.setdefault(mode, dict.fromkeys(dispatch_phase_seconds, 0.0))
        for k in acc:
            acc[k] += dispatch_phase_seconds[k] - before[k]
        return ms

    steady = turns_ms(steady_ms, n=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    turns_n = len(steady["vmap"]) * n_rounds
    split_ms = {mode: {k: v / turns_n * 1e3 for k, v in acc.items()}
                for mode, acc in split.items()}
    split_share = {mode: {k: v / float(np.median(steady[mode])) for k, v in ms.items()}
                   for mode, ms in split_ms.items()}
    # The same rounds as raw int16 rows (what a source of 16-bit PCM hands
    # on): they upload as int16, half the bytes. One round untimed first, so
    # that every timed row's lookback is int16 too.
    pcm_rounds = [[np.round(c * 32768 * 32).astype(np.int16) for c in chunks]
                  for chunks in full_rounds]
    for session in timed.values():
        session.feed(pcm_rounds[0])
    split.clear()
    pcm = {mode: [steady_ms(mode, pcm_rounds) for _ in range(2)] for mode in ("vmap", "scan")}
    pcm_split_ms = {mode: {k: v / (2 * n_rounds) * 1e3 for k, v in acc.items()}
                    for mode, acc in split.items()}
    for session in timed.values():
        session.feed(full_rounds[0])

    # ── One round's dispatch and collect against 16 single-chunk
    # dispatches, in turns (round, singles, singles, round, twice) ──
    def session_round(chunks) -> tuple[float, float]:
        t0 = time.perf_counter()
        handle = timed["scan"].dispatch(chunks)
        t1 = time.perf_counter()
        timed["scan"].collect(handle)
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    def single_dispatches(chunks) -> tuple[float, float]:
        t0 = time.perf_counter()
        handles = [bank.dispatch_chunk(c, p) for c, p in zip(chunks, full_rounds[0])]
        t1 = time.perf_counter()
        for h in handles:
            bank.collect_chunk(h)
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    turns: dict[str, list[tuple[float, float]]] = {"round": [], "singles": []}
    for name in ("round", "singles", "singles", "round") * 2:
        run = session_round if name == "round" else single_dispatches
        turns[name].append(run(full_rounds[1 + len(turns[name]) % n_rounds]))
    scan_run, vmap_run = counted["scan"], counted["vmap"]
    phase("multistream", card=smi, clips=num_normal + num_marker, slots=16, tile=16,
          in_flight=2, streams=12, rounds=len(rounds), tile_widths_per_round=scan_run["widths"],
          rows=scan_run["rows"], groups=groups, kernel_launches=scan_run["launches"],
          routes_row_class_escalated_host=scan_run["routes"],
          detections=scan_run["detections"], equal_to_serial_engine=True,
          session_wall_s=scan_run["wall_s"],
          vmap_dispatches=vmap_run["dispatches"], vmap_kernel_launches=vmap_run["launches"],
          vmap_routes_row_class_escalated_host=vmap_run["routes"],
          vmap_detections=vmap_run["detections"], vmap_equal_to_serial_engine=True,
          vmap_session_wall_s=vmap_run["wall_s"],
          kernel_equal_plain_on_short_and_empty_rows=True, scan_checks=len(errs),
          max_abs_err=max(errs), steady_rows_per_round=16, steady_rounds=n_rounds,
          ms_per_round_median=float(np.median(steady["scan"])),
          aggregate_x_realtime=16 * 60 / (float(np.median(steady["scan"])) / 1e3),
          ms_per_round_scan=steady["scan"], ms_per_round_vmap=steady["vmap"],
          vmap_ms_per_round_median=float(np.median(steady["vmap"])),
          vmap_aggregate_x_realtime=16 * 60 / (float(np.median(steady["vmap"])) / 1e3),
          steady_peak_mem_gb=peak_gb,
          round_dispatch_collect_ms=turns["round"],
          singles_dispatch_collect_ms=turns["singles"])
    mesh = counted["mesh"]
    phase("multistream_stream_mesh", card=smi, stream_shards=2, logical_shards=True, slots=16,
          rounds=len(rounds), kernel_launches=mesh["launches"],
          routes_row_class_escalated_host=mesh["routes"], detections=mesh["detections"],
          equal_to_serial_engine=True, session_wall_s=mesh["wall_s"],
          unsharded_vmap_session_wall_s=vmap_run["wall_s"])
    phase("dispatch_phase_split", card=smi, rows=16, rounds_timed=turns_n,
          ms_per_round=split_ms, share_of_round=split_share,
          int16_rows_ms_per_round=pcm_split_ms,
          int16_rows_round_ms={m: float(np.median(v)) for m, v in pcm.items()},
          upload_bytes_per_round={"f32": 16 * SECTION_LEN * 4, "int16": 16 * SECTION_LEN * 2})
    if profile is not None:
        for mode in ("scan", "vmap"):
            phase("profile_serving_round", mode=mode, rows=16, audio_s=16 * 60,
                  **profile_run(lambda: timed[mode].feed(full_rounds[1]),
                                profile / f"serving_round_{mode}.txt"))
    del det, bank, timed
    return {mode: run["launches"] for mode, run in counted.items()}


# The JSONL events after ``start`` that ``python -m audio_pattern_detector_tpu
# match --stdin --pattern-file <rthk toml> --pattern-file <cbs clip>`` prints
# for each sample WAV (the stdin read of the RTHK file includes the bytes
# after its data chunk: 4.089 s).
SERVE_GOLDEN = {
    "rthk": jsonl_block("-", RTHK_HITS, 4089, "00:00:04.089").split("\n", 1)[1],
    "cbs": jsonl_block("-", CBS_HITS, 32122, "00:00:32.122").split("\n", 1)[1],
}


def serve_client(sock, payload: bytes) -> tuple[str, float]:
    """Send a WAV on a connected socket, half-close, read every event;
    (events after the start line, wall seconds)."""
    t = time.perf_counter()
    sock.sendall(payload)
    sock.shutdown(socket.SHUT_WR)
    buf = b""
    while True:
        data = sock.recv(1 << 16)
        if not data:
            break
        buf += data
    sock.close()
    return buf.decode(), time.perf_counter() - t


def phase_serve(dev, smi: str, mesh_stream: "int | None" = None) -> None:
    """Phase 10: the port's ``serve`` in a subprocess on ``dev`` (4 slots),
    4 concurrent clients and a refused 5th, then SIGINT. With
    ``mesh_stream``, as ``serve --mesh-stream N`` on that many logical
    shards of the device."""
    import threading

    on_card = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        tiled = Path(tmp) / "cbs_x15.wav"
        write_tiled(tiled, *cbs_pcm(), 15)
        tiled_wav = tiled.read_bytes()
    patterns = ["--pattern-file", str(RTHK_TOML), "--pattern-file", str(CBS_CLIP)]
    stdin_out, _, _ = run_entry(["--device", dev.type, "--stdin", *patterns], tiled_wav)
    tiled_want = stdin_out.split("\n", 1)[1]
    if sum('"cbs_news"' in x for x in tiled_want.splitlines()) != 15:
        raise AssertionError(f"match --stdin on the tiled file: {stdin_out}")

    t = time.perf_counter()
    mesh_args = ["--mesh-stream", str(mesh_stream)] if mesh_stream else []
    proc = subprocess.Popen(
        [sys.executable, "-c", ENTRY, "serve", "--device", dev.type, "--port", "0",
         "--max-streams", "4", *mesh_args, *patterns],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, cwd=ROOT,
        env=entry_env(mesh_stream),
    )
    try:
        assert proc.stderr is not None
        head = b""
        deadline = time.monotonic() + 300
        while b" pattern(s) on " not in head:
            left = deadline - time.monotonic()
            ready = select.select([proc.stderr], [], [], max(left, 0))[0]
            data = os.read(proc.stderr.fileno(), 4096) if ready else b""
            if not data:
                raise AssertionError(f"serve did not start: {head.decode()[-3000:]}")
            head += data
        ready_s = time.perf_counter() - t
        if mesh_stream and f"Serving over a {mesh_stream}-device stream mesh" not in head.decode():
            raise AssertionError(f"serve --mesh-stream did not announce its mesh: {head.decode()}")
        line = next(x for x in head.decode().splitlines() if " pattern(s) on " in x)
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        names = ["rthk", "cbs", "cbs_x15", "rthk_again"]
        payloads = [RTHK.read_bytes(), CBS.read_bytes(), tiled_wav, RTHK.read_bytes()]
        socks = [socket.create_connection(("127.0.0.1", port), timeout=300) for _ in names]
        for s in socks:
            start = json.loads(s.recv(1 << 16).decode().splitlines()[0])
            if start["type"] != "start":
                raise AssertionError(f"no start event: {start}")
        fifth = socket.create_connection(("127.0.0.1", port), timeout=60)
        refused = fifth.recv(1 << 16).decode()
        fifth.close()
        if json.loads(refused) != {"type": "error",
                                   "error": "server full: 4 streams already connected"}:
            raise AssertionError(f"5th client: {refused!r}")
        results: dict[str, tuple[str, float]] = {}
        threads = [threading.Thread(target=lambda n=n, s=s, p=p: results.__setitem__(
            n, serve_client(s, p))) for n, s, p in zip(names, socks, payloads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        want = {"rthk": SERVE_GOLDEN["rthk"], "cbs": SERVE_GOLDEN["cbs"],
                "cbs_x15": tiled_want, "rthk_again": SERVE_GOLDEN["rthk"]}
        for n in names:
            if n not in results or results[n][0] != want[n]:
                raise AssertionError(f"{n}: {results.get(n)}, want {want[n]!r}")
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    report = json.loads(err.decode().strip().splitlines()[-1])
    if proc.returncode != 0 or report["jax_imported"] or report["launches"] < on_card:
        raise AssertionError(f"serve exit {proc.returncode}, {report}: {err.decode()[-3000:]}")
    phase("serve_mesh_stream" if mesh_stream else "serve", card=smi, slots=4, clients=4,
          mesh_stream=mesh_stream, golden_events=True, refused_fifth=True,
          tiled_detections=15, equal_to_match_stdin=True, jax_imported=False,
          kernel_launches=report["launches"], ready_s=ready_s,
          wall_s_per_client={n: results[n][1] for n in names})


MP_STREAMS = 16  # phase 12's streams, 8 a process
MP_ROUNDS = 3


def multi_process_streams(det, sr: int) -> list[np.ndarray]:
    """Phase 12's 16 streams of 180 s (numpy seeds 40-55): seeded noise,
    the bank's normal clip ``normal_<i mod 32>`` at 7 s + 50 s k and the
    tone of ``marker_<i mod 32>`` at 31 s + 60 s k."""
    bank = det._ensure_bank()
    normal = next(g for g in bank.classes[1]["groups"] if g.kind == "normal")
    audios = []
    for i in range(MP_STREAMS):
        audio = (0.004 * np.random.default_rng(40 + i).standard_normal(180 * sr)).astype(np.float32)
        tone = (0.8 * np.sin(2 * np.pi * (900.0 + 7 * (i % 32)) * np.arange(2000) / sr))
        for t in range(7, 180, 50):
            audio[t * sr : (t + 1) * sr] += normal.clips_np[i % len(normal.names)]
        for t in range(31, 180, 60):
            audio[t * sr : t * sr + 2000] += tone.astype(np.float32)
        audios.append(audio)
    return audios


def multi_process_worker(rank: int, port: int, out: Path, device: str, clips: str) -> int:
    """One of phase 12's two processes: a gloo group over 127.0.0.1,
    ``device`` (the card) as this process's cell(s). Drives the session (a
    stream mesh of 2, one cell a process, 8 local streams) and the sharded
    detector (stream 2 x time 2, two logical shards a process, one stream
    of the tiled file) on a bank of ``clips`` ("normal,marker") seeded
    clips; writes timestamps, kernel launches and wall times to ``out``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from audio_pattern_detector_tpu_torch import native
    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.parallel import ShardedDetector, make_mesh
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=timedelta(seconds=300))
    dev = torch.device(device)
    num_normal, num_marker = (int(n) for n in clips.split(","))
    on_card = dev.type == "cuda"
    report: dict = {"rank": rank, "kernel_build_s": None}
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        report["kernel_build_s"] = load_kernels().build_seconds  # both start with nothing built

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    det = make_detector(num_normal, num_marker, 60, dev)
    sr = det.target_sample_rate
    mine = multi_process_streams(det, sr)[8 * rank : 8 * rank + 8]
    session = MultiStreamSession(det, 8, mesh=make_mesh({"stream": 2}, devices=[dev]))
    chunk = 60 * sr
    acc = [{c.name: [] for c in det.audio_clips} for _ in mine]
    dist.barrier()
    candidate_scan.launches = 0
    t = time.perf_counter()
    for r in range(MP_ROUNDS):
        for a, res in zip(acc, session.feed([s[r * chunk : (r + 1) * chunk] for s in mine])):
            for name, ts in res.items():
                a[name].extend(ts)
    sync()
    report.update(session_wall_s=time.perf_counter() - t, session_launches=candidate_scan.launches,
                  session_times=acc, session_totals=[session.total_time(i) for i in range(8)])

    pcm, rate = cbs_pcm()
    audio = native.pcm16_to_f32_mono(np.tile(pcm, 15))[None]
    cbs_clip = AudioClip.from_audio_file(str(CBS_CLIP), sample_rate=rate)
    det65 = make_detector(num_normal, num_marker, 60, dev, rate, extra_clips=(cbs_clip,))
    sd = ShardedDetector(det65.audio_clips, make_mesh({"stream": 2, "time": 2}, devices=[dev] * 2),
                         chunk_seconds=60, detector=det65)
    dist.barrier()
    candidate_scan.launches = 0
    t = time.perf_counter()
    res = sd.detect(audio)
    sync()
    report.update(sharded_wall_s=time.perf_counter() - t,
                  sharded_launches=candidate_scan.launches,
                  sharded_times={n: per[0] for n, per in res.items()},
                  local_streams=sd.local_streams)
    out.write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_multi_process(dev, smi: str, num_normal: int = 32, num_marker: int = 32) -> dict[str, int]:
    """Phase 12: the mesh paths in two processes on the card, against one
    process and the serial engine (a smaller bank rehearses it on the CPU).
    The processes run from a fresh copy of the package (nothing built),
    started together, so both build the kernel library at once into the
    same directory. Returns the kernel launches of each path, summed over
    the processes."""
    import shutil
    import torch

    from audio_pattern_detector_tpu_torch import native
    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp)
        shutil.copytree(ROOT / "audio_pattern_detector_tpu_torch",
                        copy / "audio_pattern_detector_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
        (copy / "scripts").mkdir()
        shutil.copy(ROOT / "scripts" / "kernel_bounds.py", copy / "scripts" / "kernel_bounds.py")
        (copy / "pyproject.toml").write_text("")  # builds go to the copy's build/
        (copy / "sample_audios").symlink_to(AUDIO)
        port = free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(copy / "chip_smoke.py"), "--multi-process-worker", str(rank),
             str(port), str(copy / f"rank{rank}.json"), dev.type, f"{num_normal},{num_marker}"],
            cwd=copy, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"process {rank} exit {p.returncode}:\n{log[-4000:]}")
        reports = [json.loads((copy / f"rank{rank}.json").read_text()) for rank in range(2)]
        built = sorted(q.name for q in (copy / "build" / "apd_torch_kernels").glob("*.so"))

    # One process: the same 16 streams as one 16-row vmap session, and the
    # serial engine on the tiled file.
    on_card = dev.type == "cuda"
    det = make_detector(num_normal, num_marker, 60, dev)
    sr = det.target_sample_rate
    streams = multi_process_streams(det, sr)
    groups = sum(len(c["groups"]) for c in det._ensure_bank().classes.values())
    single = MultiStreamSession(det, MP_STREAMS, batch_mode="vmap")
    acc = [{c.name: [] for c in det.audio_clips} for _ in streams]
    chunk = 60 * sr
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in range(MP_ROUNDS):
        for a, res in zip(acc, single.feed([s[r * chunk : (r + 1) * chunk] for s in streams])):
            for name, ts in res.items():
                a[name].extend(ts)
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t
    pcm, rate = cbs_pcm()
    audio = native.pcm16_to_f32_mono(np.tile(pcm, 15))
    cbs_clip = AudioClip.from_audio_file(str(CBS_CLIP), sample_rate=rate)
    det65 = make_detector(num_normal, num_marker, 60, dev, rate, extra_clips=(cbs_clip,))
    serial, serial_wall = serial_scan(det65, audio)

    for rep in reports:
        rank = rep["rank"]
        for i, got in enumerate(rep["session_times"]):
            if got != acc[8 * rank + i] or rep["session_totals"][i] != single.total_time(8 * rank + i):
                raise AssertionError(f"process {rank}, stream {i}: {got} != one process's "
                                     f"{acc[8 * rank + i]}")
        if rep["sharded_times"] != serial or len(serial[cbs_clip.name]) != 15:
            raise AssertionError(f"process {rank}: sharded {rep['sharded_times']} != serial {serial}")
        if rep["local_streams"] != [rank]:
            raise AssertionError(f"process {rank} owns streams {rep['local_streams']}")
        # 3 rounds x 1 cell x the groups; 9 chunks x the 65-clip bank's groups.
        if on_card and (rep["session_launches"] != MP_ROUNDS * groups
                        or rep["sharded_launches"] != 9 * 3):
            raise AssertionError(f"process {rank}: kernel launches {rep['session_launches']} / "
                                 f"{rep['sharded_launches']}, want {MP_ROUNDS * groups} / 27")
    if on_card and len(built) != 1:
        raise AssertionError(f"the two processes left {built} in the build directory")
    launches = {"multi_process_session": sum(r["session_launches"] for r in reports),
                "multi_process_sharded": sum(r["sharded_launches"] for r in reports)}
    phase("multi_process", card=smi, processes=2, backend="gloo", clips=num_normal + num_marker,
          streams=MP_STREAMS,
          local_streams=8, rounds=MP_ROUNDS, session_equal_to_one_process=True,
          sharded_axes={"stream": 2, "time": 2}, sharded_clips=len(det65.audio_clips),
          sharded_audio_s=len(audio) / rate,
          sharded_equal_to_serial_engine=True, detections=len(serial[cbs_clip.name]),
          kernel_build_s_per_process=[r["kernel_build_s"] for r in reports], libraries_built=built,
          session_launches_per_process=[r["session_launches"] for r in reports],
          sharded_launches_per_process=[r["sharded_launches"] for r in reports],
          launches_sum=launches, session_wall_s_per_process=[r["session_wall_s"] for r in reports],
          one_process_session_wall_s=single_wall,
          sharded_wall_s_per_process=[r["sharded_wall_s"] for r in reports],
          serial_engine_wall_s=serial_wall, processes_wall_s=wall)
    del det, det65, single
    return launches


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def switches(values: dict[str, str]):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


VARIANTS = (  # phase 13: each of the JAX package's class-step switches the port reads
    ("mask", {"APD_PALLAS": "0"}),
    ("marker_gemm", {"APD_MARKER_GEMM": "1"}),
)
GEMM_RTOL = 1e-5  # of the largest power: the DFT-GEMM against the FFT's power


def phase_variants(dev, smi: str, num_normal: int = 32, num_marker: int = 32) -> int:
    """Phase 13: the flagship 16-row round (16 seeded 60 s chunks as int16
    PCM, one vmap dispatch) and phase 9's streams (tile 16, vmap, 2 rounds
    in flight) under each class-step switch, against the default. Payloads:
    every field equal, except that the mask tier has no near-collapse
    flag (a default row with flag 2 may read 0 there); detections equal.
    f32 intermediates within stated tolerances; the DFT-GEMM at f32 with
    TF32 allowed process-wide (a smaller bank rehearses it on the CPU).
    Returns the kernel launches of the counted runs (0 under
    ``APD_PALLAS=0``)."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models.bank import _split_fused
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.ops import verify_marker
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    chunks = [np.clip(np.round(0.05 * np.random.default_rng(1 + i).standard_normal(480_000)
                               * 32768), -32768, 32767).astype(np.int16) for i in range(ROUND_ROWS)]

    def round_payload(bank) -> np.ndarray:
        (sw, handle, *_), = bank.dispatch_chunks_batch(
            chunks, None, mode="vmap", prev_tails=[None] * ROUND_ROWS)
        return handle.numpy().copy()

    def run(name: str, values: dict[str, str]) -> dict:
        tf32 = name == "marker_gemm"  # the GEMM's run allows TF32 process-wide
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with switches(values):
                det = make_detector(num_normal, num_marker, 60, dev)
                bank = det._ensure_bank()
                candidate_scan.launches = 0
                marker_before = verify_marker.verify_marker.launches
                payload = round_payload(bank)  # the key's first use: eager, then the capture
                marker_launches = verify_marker.verify_marker.launches - marker_before
                _audios, rounds, _ = serving_streams(det, det.target_sample_rate)
                session = MultiStreamSession(det, 16, tile=16, batch_mode="vmap")
                torch.cuda.synchronize()
                t = time.perf_counter()
                acc, _ = drive_session(session, rounds, in_flight=2)
                torch.cuda.synchronize()
                session_wall = time.perf_counter() - t
                launches = candidate_scan.launches
                ms = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    round_payload(bank)
                    ms.append((time.perf_counter() - t) * 1e3)
                out = {"payload": payload, "acc": acc, "launches": launches,
                       "totals": [session.total_time(i) for i in range(16)],
                       "routes": routes(bank), "kernel_tier": bank.kernel_tier,
                       "upload_dtype": str(bank._staged_sections(10, [chunks[0][:10]])[0].dtype),
                       "ms_per_round": float(np.median(ms[1:])), "session_wall_s": session_wall,
                       "marker_kernel_launches_first_use": marker_launches,
                       "key_marker_gemm": sorted({st.key.marker_gemm
                                                  for st in bank.graphs.steps()}),
                       "bank": bank, "det": det}
                if tf32 and not torch.backends.cuda.matmul.allow_tf32:
                    raise AssertionError("the DFT-GEMM left TF32 switched off process-wide")
                return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    base = run("default", {})
    groups = base["bank"].classes[1]["groups"]
    results: dict[str, dict] = {}
    total_launches = base["launches"]
    for name, values in VARIANTS:
        res = run(name, values)
        mask = values.get("APD_PALLAS") == "0"
        got, want = res["payload"], base["payload"]
        near = 0
        if mask:
            got, want = got.copy(), want.copy()
            for g, pv, pb in zip(groups, _split_fused(got, groups), _split_fused(want, groups)):
                k = g.k_verify
                hide = (pb[..., 2 * k] == 2.0) & (pv[..., 2 * k] == 0.0)
                near += int(hide.sum())
                pb[hide, 2 * k] = 0.0
        if got.shape != want.shape or not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"{name}: the round's payload differs from the default's")
        if res["acc"] != base["acc"] or res["totals"] != base["totals"]:
            raise AssertionError(f"{name}: phase 9's streams differ from the default run")
        if dev.type == "cuda" and (res["launches"] == 0) != mask:
            raise AssertionError(f"{name}: {res['launches']} kernel launches")
        if dev.type == "cuda" and name == "marker_gemm" and (
                res["key_marker_gemm"] != [False] or res["marker_kernel_launches_first_use"]
                != base["marker_kernel_launches_first_use"] or
                res["marker_kernel_launches_first_use"] < 1):
            # On a card the marker verifier is its fused kernel whatever the
            # switch says: the same launches, the same key, the same payload.
            raise AssertionError(f"marker_gemm: key {res['key_marker_gemm']}, "
                                 f"{res['marker_kernel_launches_first_use']} marker kernel "
                                 f"launches against the default's "
                                 f"{base['marker_kernel_launches_first_use']}")
        results[name] = res
        if not mask:
            total_launches += res["launches"]
        res["near_flags_hidden"] = near
        if name == "mask":
            mask_bank = res["bank"]
        del res["bank"], res["det"]
        torch.cuda.empty_cache()

    # The kernel tier (the default) and the mask tier on the same round, in
    # turns (kernel, mask, mask, kernel, twice; 2 rounds each).
    def tier_ms(bank) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2):
            round_payload(bank)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 2 * 1e3

    tier_turns: dict[str, list[float]] = {"kernel": [], "mask": []}
    for tier in ("kernel", "mask", "mask", "kernel") * 2:
        tier_turns[tier].append(tier_ms(base["bank"] if tier == "kernel" else mask_bank))
    del mask_bank

    # f32 intermediates on the round's first 4 rows, against the default bank.
    bank = base["bank"]
    cls = bank.classes[1]
    rows = torch.stack([torch.from_numpy(c[:480_000].astype(np.float32) / 32768) for c in
                        chunks[:4]]).to(dev)
    sections = torch.nn.functional.pad(rows, (0, cls["section_len"] - rows.shape[1]))
    lens = torch.full((4,), 480_000, dtype=torch.int32, device=dev)
    norm = loudness_normalize_device(sections, integrated_loudness_device(sections, lens, cls["loud"]))
    m = 2000  # the marker clips' length; windows of the round, Hann-weighted
    x = norm[:, : norm.shape[1] // m * m].reshape(-1, m) * torch.hann_window(
        m, periodic=False, device=dev)
    exact = torch.from_numpy(np.abs(np.fft.rfft(x.cpu().double().numpy(), axis=-1)) ** 2)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gemm = verify_marker._rfft_power_gemm(x, m).cpu().double()
        precision_kept = torch.backends.cuda.matmul.allow_tf32
        mat = verify_marker._dft_matrix(m, x.device)
        proj = (x @ mat).cpu().double()  # the same product with TF32 allowed, unguarded
        tf32 = proj[:, : m // 2 + 1] ** 2 + proj[:, m // 2 + 1 :] ** 2
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    scale = float(exact.max())
    gemm_err = float((gemm - exact).abs().max()) / scale
    tf32_err = float((tf32 - exact).abs().max()) / scale
    if gemm_err > GEMM_RTOL or not precision_kept:
        raise AssertionError(f"variant intermediates: GEMM {gemm_err} (TF32 kept {precision_kept})")
    phase("variants", card=smi, clips=num_normal + num_marker, round_rows=ROUND_ROWS, round="16 int16 chunks of 60 s",
          session="phase 9's streams, tile 16, vmap, 2 in flight",
          equal_to_default=True, default_ms_per_round=base["ms_per_round"],
          default_session_wall_s=base["session_wall_s"], default_launches=base["launches"],
          default_routes_row_class_escalated_host=base["routes"],
          variants={name: {"ms_per_round": r["ms_per_round"], "session_wall_s": r["session_wall_s"],
                           "kernel_launches": r["launches"], "kernel_tier": r["kernel_tier"],
                           "upload_dtype": r["upload_dtype"], "routes": r["routes"],
                           "near_flags_hidden": r["near_flags_hidden"],
                           "marker_kernel_launches_first_use":
                               r["marker_kernel_launches_first_use"],
                           "key_marker_gemm": r["key_marker_gemm"]}
                    for name, r in results.items()},
          default_marker_kernel_launches_first_use=base["marker_kernel_launches_first_use"],
          marker_gemm_on_card="the fused marker kernel, as the default: the switch picks only "
                              "the plain version's spectra",
          mask_tier_kernel_launches="0: APD_PALLAS=0 runs no kernel, by the caller's choice",
          gemm_with_tf32_allowed_rel_err=gemm_err,
          unguarded_tf32_product_rel_err=tf32_err, gemm_tolerance=GEMM_RTOL,
          kernel_vs_mask_tier_ms_per_round_in_turns=tier_turns)
    del base, bank
    torch.cuda.empty_cache()
    return total_launches


def payloads_equal(a, b) -> bool:
    """Two payloads (a tensor, or a list of them) equal bit for bit."""
    import torch

    a, b = ([a], [b]) if isinstance(a, torch.Tensor) else (a, b)
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def in_turns(run, n: int = 2) -> dict[str, list[float]]:
    """``run(capture)`` timed in turns (eager, captured, captured, eager), ``n`` times."""
    times: dict[str, list[float]] = {"eager": [], "captured": []}
    for name in ("eager", "captured", "captured", "eager") * n:
        times[name].append(run(name == "captured"))
    return times


def phase_captured(dev, smi: str, num_normal: int = 32, num_marker: int = 32,
                   profile: "Path | None" = None) -> None:
    """Phase 14: the captured class step (``models/captured.py``) against
    the eager one, on the same bank with its ``capture`` switched: payloads
    bit for bit on the flagship step, the 16-row flagship round in both
    modes, the mask tier's round, a bank shard's chunk on 2 logical shards,
    and detections, routes and stream times on phase 9's session (both
    modes and on a 2-shard stream mesh); ms in turns (eager, captured,
    captured, eager) for the step, both rounds, the session and file mode's
    x-realtime on the tiled 482 s file; launch calls, graph launches and
    device-busy share under torch.profiler; each key's capture seconds and
    the memory its first use took. The kernel launches here are not on the
    kernels line."""
    import torch

    from audio_pattern_detector_tpu_torch import cli
    from audio_pattern_detector_tpu_torch.flagship import (
        flagship_round,
        flagship_step,
        make_detector,
    )
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh

    tables = Path(tempfile.mkdtemp()) if profile is None else profile
    out: dict = {}

    def keys(bank) -> list[dict]:
        cls = bank.classes
        own = {sw: (id(c["loud"]), *(id(x) for g in c["groups"] for x in (g.corr, g.verify)))
               for sw, c in cls.items()}
        return [{"sw": s.key.sw, "rows": s.key.rows, "dtype": str(s.key.dtype).split(".")[1],
                 "fused": s.key.fused, "bank_consts": s.key.consts == own[s.key.sw],
                 "capture_s": s.capture_seconds, "replays": s.replays,
                 "kernel_launches_a_replay": s.launches} for s in bank.graphs.steps()]

    def first_use(bank, fn) -> tuple:
        """Eager, then the captured first use (its capture) and a replay:
        (eager, [first, replay], peak GB allocated above what was held,
        GB that stay reserved once the cache is emptied: the new graph's
        pool, which no ``empty_cache`` returns while the graph lives)."""
        bank.capture = False
        eager = fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        bank.capture = True
        got = [fn(), fn()]
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - alloc) / 1e9
        torch.cuda.empty_cache()
        kept = (torch.cuda.memory_reserved() - reserved) / 1e9
        return eager, got, peak, kept

    def timed(bank, fn, reps: int):
        def run(capture: bool) -> float:
            bank.capture = capture
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / reps * 1e3
        times = in_turns(run)
        bank.capture = True
        return {k: median_and_range(v) for k, v in times.items()}

    def profiled(bank, fn, name: str) -> dict:
        res = {}
        for capture in (False, True):
            bank.capture = capture
            fn()
            res["captured" if capture else "eager"] = profile_run(
                fn, tables / f"captured_{name}_{'captured' if capture else 'eager'}.txt")
        return res

    # ── The flagship step (one 60 s section, each group's payload) ──
    step, bank = flagship_step(dev)
    eager, got, peak, kept = first_use(bank, step)
    if not all(payloads_equal(g, eager) for g in got):
        raise AssertionError("flagship step: captured payload differs from the eager one")
    out["flagship_step"] = {"ms_median_min_max": timed(bank, step, 5),
                            "profile": profiled(bank, step, "flagship_step"),
                            "first_use_peak_gb": peak, "pool_gb": kept, "keys": keys(bank)}
    del step, bank, eager, got

    # ── The 16-row flagship round in both modes ──
    round_step, bank, _ = flagship_round(dev)
    out["flagship_round"] = {}
    for mode in ("vmap", "scan"):
        eager, got, peak, kept = first_use(bank, lambda: round_step(mode))
        if not all(payloads_equal(g, eager) for g in got):
            raise AssertionError(f"flagship round, {mode}: captured payload differs from eager")
        out["flagship_round"][mode] = {
            "ms_median_min_max": timed(bank, lambda: round_step(mode), 3 if mode == "vmap" else 1),
            "profile": profiled(bank, lambda: round_step(mode), f"round_{mode}"),
            "first_use_peak_gb": peak, "pool_gb": kept}
    out["flagship_round"]["keys"] = keys(bank)
    del round_step, bank, eager, got

    # ── The mask tier (APD_PALLAS=0) on the same round ──
    with switches({"APD_PALLAS": "0"}):
        round_step, bank, _ = flagship_round(dev)
    eager, got, peak, kept = first_use(bank, lambda: round_step("vmap"))
    if bank.kernel_tier or not all(payloads_equal(g, eager) for g in got):
        raise AssertionError("mask tier: captured payload differs from the eager one")
    out["mask_tier_round_vmap"] = {
        "ms_median_min_max": timed(bank, lambda: round_step("vmap"), 3),
        "first_use_peak_gb": peak, "pool_gb": kept}
    del round_step, bank, eager, got

    # ── Phase 9's session, both modes and on a stream mesh; a bank shard ──
    det = make_detector(num_normal, num_marker, chunk_seconds=60, device=dev)
    bank = det._ensure_bank()
    _audios, rounds, _ = serving_streams(det, bank.sample_rate)

    def session_run(make) -> dict:
        session = make()
        before = routes(bank)
        torch.cuda.synchronize()
        t = time.perf_counter()
        acc, _ = drive_session(session, rounds, in_flight=2)
        torch.cuda.synchronize()
        return {"acc": acc, "totals": [session.total_time(i) for i in range(16)],
                "routes": tuple(a - b for a, b in zip(routes(bank), before)),
                "wall_s": time.perf_counter() - t}

    sessions = {
        "scan": lambda: MultiStreamSession(det, 16, tile=16, batch_mode="scan"),
        "vmap": lambda: MultiStreamSession(det, 16, tile=16, batch_mode="vmap"),
        "stream_mesh_2": lambda: MultiStreamSession(
            det, 16, mesh=make_mesh({"stream": 2}, devices=[dev] * 2)),
    }
    out["session"] = {}
    for name, make in sessions.items():
        runs = {}
        for capture in (False, True):
            bank.capture = capture
            runs[capture] = session_run(make)
        e, c = runs[False], runs[True]
        if (c["acc"], c["totals"], c["routes"]) != (e["acc"], e["totals"], e["routes"]):
            raise AssertionError(f"session {name}: captured {c['routes']} differs from eager "
                                 f"{e['routes']}")
        entry = {"detections": sum(len(v) for a in c["acc"][:12] for v in a.values()),
                 "routes_row_class_escalated_host": c["routes"]}
        if name != "stream_mesh_2":
            def run(capture: bool, make=make) -> float:
                bank.capture = capture
                return session_run(make)["wall_s"]
            entry["wall_s_median_min_max"] = {
                k: median_and_range(v) for k, v in in_turns(run).items()}
        out["session"][name] = entry
    bank.capture = True
    sharded = BankShardedBank(bank, make_mesh({"bank": 2}, devices=[dev] * 2))
    chunk, prev = rounds[1][3], rounds[0][3]  # phase 7's flooded row, with its lookback
    shard_payloads = {}
    for capture in (False, True, True):
        bank.capture = capture
        shard_payloads.setdefault(capture, []).append(
            [rec[1].numpy().copy() for rec in sharded.dispatch_chunk(chunk, prev)])
    if not all(all(np.array_equal(a.view(np.int32), b.view(np.int32)) for a, b in zip(p, shard_payloads[False][0]))
               for p in shard_payloads[True]):
        raise AssertionError("bank shards: captured payload differs from the eager one")
    out["bank_shards_2"] = {"payload_equal": True}
    out["session"]["keys"] = keys(bank)
    bank.capture = True
    del det, bank, sharded

    # ── File mode on the tiled 482 s file (the CLI, flag-free) ──
    pcm, rate = cbs_pcm()
    audio_s = 15 * len(pcm) / rate
    build_detector = cli.TorchEngineOptions.build_detector
    with tempfile.TemporaryDirectory() as tmp:
        tiled = Path(tmp) / "cbs_x15.wav"
        write_tiled(tiled, pcm, rate, 15)
        found: dict[bool, list] = {}

        def file_mode(capture: bool) -> float:
            def build(self, clips):
                self.capture = capture
                return build_detector(self, clips)

            cli.TorchEngineOptions.build_detector = build
            try:
                t = time.perf_counter()
                events = run_cli(["match", "--device", dev.type, "--pattern-file", str(CBS_CLIP),
                                  str(tiled)])
                wall = time.perf_counter() - t
            finally:
                cli.TorchEngineOptions.build_detector = build_detector
            found.setdefault(capture, detections(events))
            return audio_s / wall

        file_mode(True)
        x = in_turns(file_mode)
    if found[True] != found[False] or len(found[True]) != 15:
        raise AssertionError(f"file mode: captured {found[True]} against eager {found[False]}")
    out["file_mode_x_realtime_median_min_max"] = {k: median_and_range(v) for k, v in x.items()}
    phase("captured", card=smi, clips=num_normal + num_marker, equal_to_eager=True, **out)
    torch.cuda.empty_cache()


def kernel_names(fn) -> "Counter[str]":
    """The device kernels of one call of ``fn`` under torch.profiler, by
    name (copies and fills left out)."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in device_events(prof)
                   if not e.name.startswith(("Memcpy", "Memset")))


HOST_ALLOC_CALLS = ("cudaHostAlloc", "cudaMallocHost", "cuMemHostAlloc")


def host_allocs(fn) -> int:
    """Pinned host allocations (``cudaHostAlloc`` and its kin) made by one
    call of ``fn``, from torch.profiler's runtime-call events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name in HOST_ALLOC_CALLS for e in prof.events()
               if e.device_type == DeviceType.CPU)


def phase_skip_verify_and_staging(dev, smi: str, num_normal: int = 32, num_marker: int = 32,
                                  profile: "Path | None" = None) -> None:
    """Phase 16: candidate-free groups skip the captured verify tail (a
    CUDA conditional node), and the pinned staging pool. A flagship
    detector's captured step against its eager step, which always
    verifies. Payloads bit for bit on the flagship step's candidate-free
    section, phase 7's sections and a section with hits in both groups
    (single-section graphs), a 16-row round with no candidates and one with
    a single hit-bearing row (both modes), and a bank-sharded chunk on 2
    logical shards; detections, routes and stream times on phase 9's
    session in both modes, captured against eager; accepted hits in both
    groups of one section, so both bodies ran there. Under torch.profiler
    a candidate-free replay holds none of the kernels only the verifiers
    launch (those the eager step runs and the replay does not); the phase
    reports how many of them the trace of a replay with hits in both groups
    records. Profiled device-busy ms of the flagship step and the rounds,
    captured. The pool: pinned host allocations in a first and in a steady
    16-row serving round (cudaHostAlloc). A node that cannot be captured
    raises: nothing falls back."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, make_detector
    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.models.bank import _split_fused
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh

    tables = Path(tempfile.mkdtemp()) if profile is None else profile
    det = make_detector(num_normal, num_marker, chunk_seconds=60, device=dev)
    bank = det._ensure_bank()
    sw, sr = 1, bank.sample_rate
    s_len = bank.classes[sw]["section_len"]
    groups = bank.classes[sw]["groups"]
    out: dict = {"node_route": captured.CudaGraphBackend.conditional_route}

    def live_groups(payload) -> list[bool]:
        """Per group: did any row keep a live lane (a position below the
        dead-lane sentinel)? Those are the groups whose body runs."""
        flat = payload.reshape(-1, payload.shape[-1]) if payload.dim() > 1 else payload[None]
        parts = _split_fused(flat.cpu().numpy(), groups)
        return [bool((p[..., : g.k_verify] < 2**30).any()) for g, p in zip(groups, parts)]

    def two_ways(run) -> dict:
        """``run(bank)`` on the node's graph and on the eager step:
        payloads bit for bit."""
        bank.capture = True
        got = [run(bank) for _ in range(2)]  # first use, then a replay
        bank.capture = False
        want = run(bank)
        bank.capture = True
        if not all(payloads_equal(p, want) for p in got):
            raise AssertionError("the captured step's payload differs from the eager step's")
        return want

    rng = np.random.default_rng(1)
    flagship = torch.from_numpy((0.05 * rng.standard_normal(s_len)).astype(np.float32)).to(dev)
    # Phase 7's sections, and its marker hit with a normal clip added.
    flooded = rerun_sections(bank)
    flooded["both"] = flooded["clear"].copy()
    flooded["both"][20 * sr : 21 * sr] += next(g for g in groups if g.kind == "normal").clips_np[0]
    sections = {"flagship": flagship,
                **{name: torch.from_numpy(sec).to(dev) for name, sec in flooded.items()}}
    live, selected = {}, {}
    for name, sec in sections.items():
        payload = two_ways(lambda b, sec=sec: b.step(sw, sec, s_len))
        live[name] = live_groups(payload)
        parts = _split_fused(payload[None].cpu().numpy(), groups)
        selected[name] = [int((p[..., g.k_verify : 2 * g.k_verify] != 0).sum())
                          for g, p in zip(groups, parts)]
    # Accepted hits in both groups, bitwise the eager step's: both bodies ran.
    if any(live["flagship"]) or not all(live["both"]) or not all(selected["both"]):
        raise AssertionError(f"live groups per section: {live}; selected lanes {selected}")
    out["sections_live_groups"] = live
    out["sections_selected_lanes_per_group"] = selected

    # A round with no candidate, and one whose row 5 (of 16) has hits in both groups.
    rows = torch.stack([
        torch.from_numpy((0.05 * np.random.default_rng(1 + i).standard_normal(s_len))
                         .astype(np.float32)) for i in range(ROUND_ROWS)]).to(dev)
    mixed = rows.clone()
    mixed[ROUND_ROWS // 3] = sections["both"]
    n_valids = torch.full((ROUND_ROWS,), s_len, dtype=torch.int32, device=dev)

    def round_of(rows_):
        def run(b, mode):
            if mode == "vmap":
                return b.step(sw, rows_, n_valids)
            return torch.stack([b.step(sw, rows_[i], s_len) for i in range(ROUND_ROWS)])
        return run

    out["rounds_live_groups"] = {}
    for rname, rows_ in (("candidate_free", rows), ("one_hit_row", mixed)):
        for mode in ("vmap", "scan"):
            payload = two_ways(lambda b, m=mode, r=round_of(rows_): r(b, m))
            out["rounds_live_groups"][f"{rname}_{mode}"] = live_groups(payload)
    if any(out["rounds_live_groups"]["candidate_free_vmap"]) or not all(
            out["rounds_live_groups"]["one_hit_row_vmap"]):
        raise AssertionError(f"live groups per round: {out['rounds_live_groups']}")

    # A bank-sharded chunk (phase 7's flooded row, with its lookback).
    _audios, rounds, _ = serving_streams(det, sr)
    chunk, prev = rounds[1][3], rounds[0][3]
    shard_payloads, shard_results = {}, {}
    for name, capture in (("node", True), ("eager", False)):
        bank.capture = capture
        sharded = BankShardedBank(bank, make_mesh({"bank": 2}, devices=[dev] * 2))
        recs = sharded.dispatch_chunk(chunk, prev)
        shard_payloads[name] = [rec[1].numpy().copy() for rec in recs]
        shard_results[name] = sharded.collect_chunk(recs)
    bank.capture = True
    if shard_results["node"] != shard_results["eager"] or not all(
            np.array_equal(a.view(np.int32), e.view(np.int32))
            for a, e in zip(shard_payloads["node"], shard_payloads["eager"])):
        raise AssertionError("bank shards: payload differs from the eager step's")
    out["bank_shards_2"] = {"payload_equal": True}

    # ── Phase 9's session, captured and eager, both modes ──
    def session_run(capture: bool, mode: str) -> dict:
        bank.capture = capture
        try:
            session = MultiStreamSession(det, 16, tile=16, batch_mode=mode)
            before = routes(bank)
            torch.cuda.synchronize()
            t = time.perf_counter()
            acc, _ = drive_session(session, rounds, in_flight=2)
            torch.cuda.synchronize()
        finally:
            bank.capture = True
        return {"acc": acc, "totals": [session.total_time(i) for i in range(16)],
                "routes": tuple(a - b for a, b in zip(routes(bank), before)),
                "wall_s": time.perf_counter() - t}

    out["session"] = {}
    for mode in ("scan", "vmap"):
        a, b = session_run(True, mode), session_run(False, mode)
        if (a["acc"], a["totals"], a["routes"]) != (b["acc"], b["totals"], b["routes"]):
            raise AssertionError(f"session {mode}: the captured run differs from the eager one")
        out["session"][mode] = {
            "detections": sum(len(v) for x in a["acc"][:12] for v in x.values()),
            "routes_row_class_escalated_host": a["routes"], "wall_s": a["wall_s"]}

    # ── The node in the trace: no verifier kernel in a candidate-free replay ──
    def replay(sec):
        bank.step(sw, sec, s_len)
        return lambda: bank.step(sw, sec, s_len)

    seen = {sec: kernel_names(replay(sections[sec])) for sec in ("flagship", "both")}
    bank.capture = False
    eager = kernel_names(lambda: bank.step(sw, sections["flagship"], s_len))
    bank.capture = True
    # Kernels of the eager step, which always verifies, that a
    # candidate-free replay does not run: the verifiers' own, a name each.
    # The profiler does not record every kernel of an if-node's body in
    # every process (PERF.md, PR 9): the bodies' running is held by the
    # payload above, and the replay with hits is traced up to 3 times and
    # the most complete trace kept.
    verifier_only = set(eager) - set(seen["flagship"])
    if not verifier_only:
        raise AssertionError("the trace does not show the skip: a candidate-free replay runs "
                             "every kernel the eager step runs")

    def verifier_kernels(counts) -> int:
        return sum(counts[k] for k in verifier_only)

    for _ in range(2):
        if verifier_kernels(seen["both"]) >= verifier_kernels(eager):
            break
        again = kernel_names(replay(sections["both"]))
        if verifier_kernels(again) > verifier_kernels(seen["both"]):
            seen["both"] = again
    out["trace"] = {
        "kernels_a_replay_candidate_free": sum(seen["flagship"].values()),
        "kernels_a_replay_hits_in_both_groups": sum(seen["both"].values()),
        "kernels_eager_candidate_free": sum(eager.values()),
        "verifier_only_kernel_names": len(verifier_only),
        "verifier_only_kernels_a_replay_hits_in_both_groups": verifier_kernels(seen["both"]),
        "verifier_only_examples": sorted(k[:90] for k in verifier_only)[:6],
        "node_handle_kernels_a_replay": sum(v for k, v in seen["both"].items()
                                            if "set_if_handle" in k)}

    # ── Profiled, captured ──
    paths = {
        "flagship_step": lambda: bank.step(sw, flagship, s_len, fused=False),
        "round_vmap_candidate_free": lambda: round_of(rows)(bank, "vmap"),
        "round_scan_candidate_free": lambda: round_of(rows)(bank, "scan"),
        "round_scan_one_hit_row": lambda: round_of(mixed)(bank, "scan"),
    }
    out["profiled_device_busy_ms"] = {}
    for pname, fn in paths.items():
        fn()
        out["profiled_device_busy_ms"][pname] = profile_run(
            fn, tables / f"skip_{pname}.txt")["device_busy_ms"]

    # ── The staging pool: pinned allocations in a first and a steady round ──
    steady = [[(0.004 * rng.standard_normal(60 * sr)).astype(np.float32) for _ in range(16)]
              for _ in range(3)]
    session = MultiStreamSession(det, 16, tile=16, batch_mode="vmap")
    bank._staging.clear()
    out["pinned_host_allocs_a_round"] = {
        "first": host_allocs(lambda: session.feed(steady[0])),
        "steady": [host_allocs(lambda c=c: session.feed(c)) for c in steady[1:]]}
    if any(out["pinned_host_allocs_a_round"]["steady"]):
        raise AssertionError(f"a steady round allocated pinned memory: "
                             f"{out['pinned_host_allocs_a_round']}")
    out["staging_pool"] = {f"{dt} {b}x{s}": len(v) for (dt, b, s), v in bank._staging.items()}
    phase("skip_empty_verify_and_staging", card=smi, clips=num_normal + num_marker,
          payloads_equal_node_eager=True, **out)
    del det, bank, session
    torch.cuda.empty_cache()


def noise_chunks(rows: int, seconds: int = 60, sr: int = 8000) -> list[np.ndarray]:
    """``rows`` 60 s chunks of seeded noise (numpy seeds 1..rows), as phase
    3c and ``scripts/probe_general_memory.py`` make them: no candidate in the
    lean tier, every row flagged at a threshold of 0."""
    return [(0.05 * np.random.default_rng(1 + i).standard_normal(seconds * sr))
            .astype(np.float32) for i in range(rows)]


SPLIT_WIDTHS = {"general": (96, 112), "lean": (128,)}  # phase 17's captured rounds


def phase_split_rounds(dev, smi: str, num_normal: int = 32, num_marker: int = 32
                       ) -> dict[str, int]:
    """Phase 17: rounds wider than a graph. A key keeps its graph pools for
    its bank's life, so no graph is wider than ``GRAPH_ROWS`` (W) and a
    round of B > W rows is ceil(B / W) replays of the W-row key; the eager
    step runs it in the same W-row steps. On the flagship bank, in each
    tier (general: ``height_min = 0``), vmap rounds of seeded noise rows:
    every eager round first (its peak allocated and reserved); then the
    captured round twice (the key's first use, then replays), payloads bit
    for bit the eager round's, the peak memory reserved while it ran (the
    pools included), what the pools keep, and one kernel launch per group
    per replay. The widths: 96 and 112 rows in the general tier (the
    captured one-graph round ran out of memory there before the split), 128
    in the lean tier (the widest eager one-batch round of
    ``scripts/probe_general_memory.py``'s table; one graph of 128 rows ran
    out). Then, captured, in turns (W, W + 1, W + 1, W, twice): W + 1 rows
    (a replay and one of a single row and W - 1 idle rows) against W rows;
    and B = 4W as one graph of B rows (W raised for its calls; bitwise the
    eager round as one batch of B rows) against 4 replays of the W-row
    graph (bitwise the eager round) on the same bank (one, split, split,
    one, twice): host ms to the payload and the device span of the
    dispatch (CUDA events). Returns the kernel launches of the captured
    split rounds by tier and width."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models import bank as bank_module
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    w = bank_module.GRAPH_ROWS
    b = 4 * w

    def dispatch(bank, chunks: list, width: int = w) -> tuple:
        bank_module.GRAPH_ROWS = width
        try:
            return timed_dispatch(bank, chunks, "vmap")
        finally:
            bank_module.GRAPH_ROWS = w

    def turns(bank, names: tuple, chunks: dict, widths: dict, want: dict) -> dict:
        times: dict = {name: [] for name in names}
        for name in (names[0], names[1], names[1], names[0]) * 2:
            payloads, _, ms, span = dispatch(bank, chunks[name], widths[name])
            if not arrays_equal(payloads, want[name]):
                raise AssertionError(f"split rounds, {name}: payload differs from the eager "
                                     "round of its schedule")
            times[name].append((ms, span))
        return {name: {"payload_on_host_ms": median_and_range([t[0] for t in v]),
                       "device_span_ms": median_and_range([t[1] for t in v])}
                for name, v in times.items()}

    out: dict = {}
    launches: dict[str, int] = {}
    for tier, widths in SPLIT_WIDTHS.items():
        general = tier == "general"
        bank = make_detector(num_normal, num_marker, 60, dev,
                             height_min=0.0 if general else None)._ensure_bank()
        groups = sum(len(c["groups"]) for c in bank.classes.values())
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        entry: dict = {"graph_rows": w, "resident_gb": resident / 1e9}
        chunks = {rows: noise_chunks(rows) for rows in (*widths, w, w + 1, b)}
        eager: dict = {}
        # Every eager round first: a captured key's pools stay until the
        # bank goes.
        bank.capture = False
        for rows in (*widths, w, w + 1, b):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reserved = torch.cuda.memory_reserved()
            eager[rows], _, ms, span = dispatch(bank, chunks[rows])
            entry[f"eager_{rows}"] = {
                "payload_on_host_ms": ms, "device_span_ms": span,
                "peak_allocated_gb": (torch.cuda.max_memory_allocated() - resident) / 1e9,
                "peak_reserved_gb": (torch.cuda.max_memory_reserved() - reserved) / 1e9}
        one_batch = dispatch(bank, chunks[b], b)[0]
        torch.cuda.empty_cache()
        bank.capture = True
        for rows in widths:
            torch.cuda.reset_peak_memory_stats()
            first, _, first_ms, _ = dispatch(bank, chunks[rows])
            candidate_scan.launches = 0
            got, _, ms, span = dispatch(bank, chunks[rows])
            launches[f"{tier}_{rows}"] = candidate_scan.launches
            replays = -(-rows // w)
            if not (arrays_equal(first, eager[rows]) and arrays_equal(got, eager[rows])):
                raise AssertionError(f"split round, {tier}, {rows} rows: payload differs from "
                                     "the eager round")
            if candidate_scan.launches != groups * replays:
                raise AssertionError(f"split round, {tier}, {rows} rows: {candidate_scan.launches}"
                                     f" kernel launches, want {groups * replays}")
            torch.cuda.empty_cache()
            entry[f"captured_{rows}"] = {
                "replays": replays, "first_use_ms": first_ms, "payload_on_host_ms": ms,
                "device_span_ms": span, "kernel_launches": candidate_scan.launches,
                "equal_to_eager": True,
                "peak_reserved_gb_pools_included": torch.cuda.max_memory_reserved() / 1e9,
                "reserved_gb_after": torch.cuda.memory_reserved() / 1e9,
                "pools_gb": pools_gb(bank.graphs._backend)}
        # W + 1 rows against W rows: the cost of a remainder of one row.
        names = {f"rows_{w}": w, f"rows_{w + 1}": w + 1}
        entry[f"rows_{w + 1}_vs_{w}"] = turns(
            bank, tuple(names), {n: chunks[r] for n, r in names.items()},
            dict.fromkeys(names, w), {n: eager[r] for n, r in names.items()})
        # B = 4W: one graph of B rows against 4 replays of the W-row graph.
        dispatch(bank, chunks[b], b)  # the B-row key's first use
        entry[f"rows_{b}_one_graph_vs_{b // w}_replays"] = turns(
            bank, ("one_graph", "split"), {"one_graph": chunks[b], "split": chunks[b]},
            {"one_graph": b, "split": w}, {"one_graph": one_batch, "split": eager[b]})
        torch.cuda.empty_cache()
        entry[f"rows_{b}_pools_gb_both_keys"] = pools_gb(bank.graphs._backend)
        entry["keys_rows"] = sorted(s.key.rows for s in bank.graphs.steps())
        out[tier] = entry
        del bank
        gc.collect()
        torch.cuda.empty_cache()
    phase("split_rounds", card=smi, clips=num_normal + num_marker, section_s=60,
          payloads_equal_to_eager=True, falls_back_to_eager=False, **out)
    return launches


def pass_counting_backend():
    """A ``CudaGraphBackend`` whose while nodes count their passes on the
    device: each node's body adds one to a counter of its own after the
    body's work (one more small kernel a pass). The graph zeroes its
    counters before its nodes (a counter made without a kernel would share
    its memory with the graph's earlier temporaries), so ``passes()``
    reads each node's passes in its graph's last replay."""
    import torch

    from audio_pattern_detector_tpu_torch.models.captured import CudaGraphBackend

    class PassCounting(CudaGraphBackend):
        def __init__(self) -> None:
            super().__init__()
            self.counters: list = []

        def while_loop(self, pred, body) -> None:
            passes = torch.zeros((), dtype=torch.int64, device=pred.device)
            self.counters.append(passes)

            def counted() -> None:
                body()
                passes.add_(1)

            super().while_loop(pred, counted)

        def passes(self) -> list[int]:
            torch.cuda.synchronize()
            return [int(c) for c in self.counters]

    return PassCounting


def phase_greedy_forms(dev, smi: str, num_normal: int = 32, num_marker: int = 32) -> dict:
    """Phase 18: the lean greedy in the captured step. The kernel tier runs
    the greedy's kernel (``csrc/lean_greedy.cu``, one launch a group), so
    its graph holds no while node. Two flagship banks: the default and one
    on a backend whose while nodes count their passes
    (``pass_counting_backend``). Payloads bit for bit between the two and
    the eager step on the flagship step's candidate-free section, a section
    with hits in both groups (phase 16's), a candidate-free 16-row vmap
    round and one whose row 5 is the hit-bearing section; no graph holds a
    while node; the lean greedy's launches a replay; the default bank's
    device ms a call from CUDA events around 5 calls (3 for a round), 4
    times, beside PR 11's while-node and unrolled forms. Returns the kernel
    launches of the timed calls."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, make_detector
    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy

    banks = {"default": make_detector(num_normal, num_marker, 60, dev)._ensure_bank()}
    saved = captured.StepGraphs.backend
    captured.StepGraphs.backend = pass_counting_backend()
    try:
        banks["counted"] = make_detector(num_normal, num_marker, 60, dev)._ensure_bank()
    finally:
        captured.StepGraphs.backend = saved
    bank = banks["default"]
    sw, sr = 1, bank.sample_rate
    s_len = bank.classes[sw]["section_len"]
    groups = bank.classes[sw]["groups"]
    rng = np.random.default_rng(1)
    flagship = torch.from_numpy((0.05 * rng.standard_normal(s_len)).astype(np.float32)).to(dev)
    both = rerun_sections(bank)["clear"].copy()
    both[20 * sr : 21 * sr] += next(g for g in groups if g.kind == "normal").clips_np[0]
    both = torch.from_numpy(both).to(dev)
    rows = torch.stack([
        torch.from_numpy((0.05 * np.random.default_rng(1 + i).standard_normal(s_len))
                         .astype(np.float32)) for i in range(ROUND_ROWS)]).to(dev)
    mixed = rows.clone()
    mixed[ROUND_ROWS // 3] = both
    n_valids = torch.full((ROUND_ROWS,), s_len, dtype=torch.int32, device=dev)
    paths = {
        "flagship_step_candidate_free": (lambda b: b.step(sw, flagship, s_len), 5),
        "flagship_step_hits_in_both_groups": (lambda b: b.step(sw, both, s_len), 5),
        "round_vmap_candidate_free": (lambda b: b.step(sw, rows, n_valids), 3),
        "round_vmap_one_hit_row": (lambda b: b.step(sw, mixed, n_valids), 3),
    }
    out: dict = {}
    launches = 0
    lean_launches = 0
    for pname, (fn, reps) in paths.items():
        bank.capture = False
        want = fn(bank)
        bank.capture = True
        for name, b in banks.items():
            if not all(payloads_equal(fn(b), want) for _ in range(2)):  # first use, then a replay
                raise AssertionError(f"{pname}, {name}: payload differs from the eager step's")

        def ms() -> float:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(bank)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps

        times = []
        for _ in range(4):
            before = (candidate_scan.launches, lean_greedy.launches)
            with counted_verify_launches("greedy_forms", lambda: list(banks.values())):
                times.append(ms())
            launches += candidate_scan.launches - before[0]
            lean_launches += lean_greedy.launches - before[1]
        out[pname] = {"device_ms_median_min_max": median_and_range(times),
                      "pr11_while_node_ms": PR11_MS["greedy_forms_while_node"][pname],
                      "pr11_unrolled_ms": PR11_MS["greedy_forms_unrolled"][pname]}
    if banks["counted"].graphs._backend.counters:
        raise AssertionError("a kernel-tier graph holds a while node")
    per_replay = {f"rows_{s.key.rows}": s.kernel_launches[lean_greedy]
                  for s in bank.graphs.steps()}
    if any(n != len(groups) for n in per_replay.values()) or lean_launches != launches:
        raise AssertionError(f"lean greedy launches a replay {per_replay}, timed {lean_launches}, "
                             f"scans {launches}: want one per group per replay")
    GREEDY_PATH_LAUNCHES["lean_greedy"]["greedy_forms"] = lean_launches
    phase("greedy_forms", card=smi, clips=num_normal + num_marker, payloads_equal=True,
          while_nodes=0, lean_greedy_launches_a_replay=per_replay, **out)
    del banks, bank
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Launches of each greedy kernel on the paths that run it, each counted
# from 0 around its run (phases 3b, 3c, 4-5, 7, 18, 19): the kernels line.
GREEDY_PATH_LAUNCHES: dict[str, dict[str, int]] = {"lean_greedy": {}, "lane_greedy": {}}

# PR 11's figures of the paths this slice's kernels run on (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md §6), printed beside this run's.
PR11_MS = {
    "general_plateau_vmap_payload_on_host": [351.0, 362.0],
    "general_plateau_scan_payload_on_host": [1667.0, 1688.0],
    "wide_rerun_escalated_row": [211.0, 580.0],
    "wide_rerun_marker_row": 33.6,
    "greedy_forms_while_node": {"flagship_step_candidate_free": 1.47,
                                "flagship_step_hits_in_both_groups": 3.26,
                                "round_vmap_candidate_free": 13.74,
                                "round_vmap_one_hit_row": 24.39},
    "greedy_forms_unrolled": {"flagship_step_candidate_free": 15.49,
                              "flagship_step_hits_in_both_groups": 13.56,
                              "round_vmap_candidate_free": 34.64,
                              "round_vmap_one_hit_row": 43.30},
}
PEAK_SCALAR_OPS = 67e12  # H100 SXM, f32 outside the tensor cores: the issue rate bound


@contextlib.contextmanager
def recorded_greedy_inputs(limit: int = 10**6):
    """Inside the block, copies of the inputs of the first ``limit``
    launches of each greedy kernel land in the yielded dict, by kernel
    name: (corr, valid_len, bmax, denom, hm, m, r_max) for the lean
    greedy, (pos, alive, min_distance) for the lane greedy. The launches
    and their counts are unchanged; a replay calls no wrapper, so only
    eager steps (a key's first use among them) are recorded."""
    import torch

    from audio_pattern_detector_tpu_torch.ops import lane_greedy as lane_module
    from audio_pattern_detector_tpu_torch.ops import lean_greedy as lean_module

    seen: dict[str, list] = {"lean_greedy": [], "lane_greedy": []}
    launches = {"lean_greedy": lean_module._launch, "lane_greedy": lane_module._launch}

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def recorder(name: str):
        def recording(*args):
            if len(seen[name]) < limit and not torch.cuda.is_current_stream_capturing():
                seen[name].append(tuple(copy(a) for a in args))
            return launches[name](*args)
        return recording

    lean_module._launch, lane_module._launch = recorder("lean_greedy"), recorder("lane_greedy")
    try:
        yield seen
    finally:
        lean_module._launch = launches["lean_greedy"]
        lane_module._launch = launches["lane_greedy"]


# Launches of each verify kernel on the paths that run it, each counted
# from 0 around its run (phases 3b, 3c, 4-5, 7, 18, 19): the kernels line.
VERIFY_PATH_LAUNCHES: dict[str, dict[str, int]] = {"verify_normal": {}, "verify_marker": {}}


def verify_counts() -> dict[str, int]:
    """Each verify kernel's launches its wrapper counted so far: eager
    steps', and replays' outside conditional bodies."""
    from audio_pattern_detector_tpu_torch.ops.verify_marker import verify_marker
    from audio_pattern_detector_tpu_torch.ops.verify_normal import verify_normal

    return {"verify_normal": verify_normal.launches, "verify_marker": verify_marker.launches}


def replay_body_launches(step, payload, groups) -> dict[str, int]:
    """The verify launches one replay of the captured ``step`` made inside
    its conditional bodies, read from the payload it returned. A lean
    group's if-node body ran where the group has a live lane (a position
    below the sentinel). The general tier holds no verify body on a card:
    each verifier is one launch of every lane in its graph. A body's
    launches are those its capture recorded (``CapturedStep.body_launches``)."""
    from audio_pattern_detector_tpu_torch.models.bank import _BIG, _split_fused

    if step.key.fused:
        flat = payload.cpu().numpy()
        per_group = _split_fused(flat.reshape(-1, flat.shape[-1]), groups)
    else:
        per_group = [p.cpu().numpy() for p in payload]
    bodies = iter(step.body_launches)
    ran = []
    for g, p in zip(groups, per_group):
        live = (p.reshape(-1, 2 * g.k_verify + 2)[:, : g.k_verify] < _BIG).sum(axis=1)
        if not step.key.general and not step.key.wide_lanes:  # the lean tail's if-nodes
            body = next(bodies)
            if live.any():
                ran.append(body)
    if next(bodies, None) is not None:
        raise AssertionError("a captured step holds more conditional bodies than its groups")
    counts = {"verify_normal": 0, "verify_marker": 0}
    for body in ran:
        for wrapper, n in body.items():
            counts[wrapper.__name__] += n
    return counts


@contextlib.contextmanager
def counted_verify_launches(path: str, banks):
    """Adds each verify kernel's launches inside the block to
    VERIFY_PATH_LAUNCHES[kernel][path]: those its wrapper counted, and
    those of the conditional bodies each replay ran, from the payload the
    replay returned (:func:`replay_body_launches`). ``banks()`` gives the
    banks whose steps run in the block."""
    from audio_pattern_detector_tpu_torch.models.captured import CapturedStep

    replays = []
    run = CapturedStep.run

    def recording_run(self):
        replay = self._replay is not None
        out = run(self)
        if replay:
            replays.append((self, out))
        return out

    before = verify_counts()
    CapturedStep.run = recording_run
    try:
        yield
    finally:
        CapturedStep.run = run
    counts = {name: n - before[name] for name, n in verify_counts().items()}
    for step, out in replays:
        groups = next(b.classes[step.key.sw]["groups"] for b in banks()
                      if step in b.graphs.steps())
        for name, n in replay_body_launches(step, out, groups).items():
            counts[name] += n
    for name, n in counts.items():
        VERIFY_PATH_LAUNCHES[name][path] = VERIFY_PATH_LAUNCHES[name].get(path, 0) + n


@contextlib.contextmanager
def recorded_verify_inputs(limit: int = 4):
    """Inside the block, the inputs of the first ``limit`` calls of each
    verifier that have a live lane land in the yielded dict, by kernel
    name, as the bank calls them: (corr, pos, alive, consts, normalise) and
    (section, pos, alive, consts). The calls run as they would; a replay
    calls no Python, so only eager steps (a key's first use among them) are
    recorded."""
    import torch

    from audio_pattern_detector_tpu_torch.models import bank as bank_module

    seen: dict[str, list] = {"verify_normal": [], "verify_marker": []}
    calls = {"verify_normal": bank_module.verify_normal,
             "verify_marker": bank_module.verify_marker}

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return tuple(copy(y) for y in x) if isinstance(x, tuple) else x

    def recorder(name: str):
        def recording(*args):
            alive = args[2]
            capturing = alive.is_cuda and torch.cuda.is_current_stream_capturing()
            if len(seen[name]) < limit and not capturing and bool(alive.any()):
                seen[name].append(tuple(copy(a) for a in args))
            return calls[name](*args)
        return recording

    bank_module.verify_normal = recorder("verify_normal")
    bank_module.verify_marker = recorder("verify_marker")
    try:
        yield seen
    finally:
        bank_module.verify_normal = calls["verify_normal"]
        bank_module.verify_marker = calls["verify_marker"]


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """The device milliseconds of one call of ``fn``: CUDA events around
    replays of a graph of ``calls`` back-to-back calls (no host time
    between them), median of ``reps`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def lane_greedy_bound(pos, alive, m: int, keep) -> tuple[float, str, int]:
    """(bound ms, what bounds it, compares) of one lane greedy call: the
    larger of its bytes (positions and alive flags read once, the mask
    written once) over the memory rate and of the compares this input
    needs (each kept lane against the other alive lanes of its row within
    ``m`` of it: the lanes it must clear) over the card's scalar rate."""
    import torch

    g, k = pos.shape
    p = pos.to(torch.int32).to(torch.int64)
    ordered = torch.where(alive, p, torch.iinfo(torch.int64).max).sort(dim=1).values
    lo = torch.searchsorted(ordered, p - (m - 1))
    hi = torch.searchsorted(ordered, p + (m - 1), right=True)
    compares = int(torch.where(keep, (hi - lo - 1).clamp_min(0), 0).sum()) if k else 0
    by_bytes = g * k * 10 / HBM_BYTES_PER_S * 1e3
    by_ops = compares / PEAK_SCALAR_OPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", compares


def lane_inputs_from_lean(args, k: int = 4096) -> tuple:
    """Lane greedy inputs from a lean greedy input's rows, as the general
    tier would make them at a threshold of 0: the normalised rows (-inf at
    and past the valid length), their general plateau maxima at or above
    0, the ``k`` tallest in priority order."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.peaks import (
        plateau_local_maxima_mask,
        row_limit,
        select_candidates,
    )

    corr, valid_len, _bmax, denom, _hm, m, _r = args
    idx = torch.arange(corr.shape[1], device=corr.device)[None, :]
    x = torch.where(idx < row_limit(valid_len), corr / denom[:, None], -math.inf)
    cand = select_candidates(x, plateau_local_maxima_mask(x) & (x >= 0.0), min(k, x.shape[1]))
    return cand.pos.contiguous(), cand.alive.contiguous(), m


def phase_greedy_kernels(dev, smi: str, corpus_inputs: list, num_normal: int = 32,
                         num_marker: int = 32) -> dict:
    """Phase 20 (``greedy_kernels``): each greedy kernel bitwise against its
    plain version on the card, on the inputs the paths give it:

    * the lean greedy (``csrc/lean_greedy.cu``) on the flagship step's and
      the 16-row round's own launches (eager steps of the flagship bank
      record them), candidate-free and with hits (phase 18's sections), on
      the named cases of the CPU tests at m = 40 and 700, and on phase 19's
      regression captures (every launch of their card runs' eager steps);
    * the lane greedy (``csrc/lane_greedy.cu``) on the general-plateau
      tier's flagship step and 16-row round (``height_min = 0``, without
      and with hits), on lanes made from the regression captures' rows as
      that tier would make them, at K = 1,024, 4,728 and 16,384 lanes of
      32 rows of clustered positions, and on its worst cases
      (``LANE_WORST_CASES``, 32 rows of 4,728 lanes).

    For the timed inputs: the kernel's device ms (CUDA events around a
    graph of 20 calls), the wrapper's ms (events around 20 eager calls),
    the plain version's ms, the bound and its share (bytes over 3.35 TB/s,
    or compares over the card's scalar rate, from this input's own work:
    the lane greedy's kept lanes against their neighbours within m),
    and the kernel's launches on the paths that run it (counted there).
    Measurement launches are not counted. Returns the kernels line's
    numbers by kernel."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy, lane_greedy_reference
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy, lean_greedy_reference

    counts = (lane_greedy.launches, lean_greedy.launches)
    sr = 8000
    out: dict = {"lean_greedy": {}, "lane_greedy": {}}
    line: dict = {}

    def sections(bank) -> dict:
        s_len = bank.classes[1]["section_len"]
        groups = bank.classes[1]["groups"]
        rng = np.random.default_rng(1)
        silent = torch.from_numpy((0.05 * rng.standard_normal(s_len)).astype(np.float32)).to(dev)
        both = rerun_sections(bank)["clear"].copy()
        both[20 * sr : 21 * sr] += next(g for g in groups if g.kind == "normal").clips_np[0]
        both = torch.from_numpy(both).to(dev)
        rows = torch.stack([
            torch.from_numpy((0.05 * np.random.default_rng(1 + i).standard_normal(s_len))
                             .astype(np.float32)) for i in range(ROUND_ROWS)]).to(dev)
        mixed = rows.clone()
        mixed[ROUND_ROWS // 3] = both
        lens = torch.full((ROUND_ROWS,), s_len, dtype=torch.int32, device=dev)
        return {"flagship_step_candidate_free": (silent, s_len),
                "flagship_step_hits_in_both_groups": (both, s_len),
                "round_vmap_candidate_free": (rows, lens),
                "round_vmap_one_hit_row": (mixed, lens)}

    def path_inputs(height_min: "float | None") -> dict:
        bank = make_detector(num_normal, num_marker, 60, dev, sr,
                             height_min=height_min)._ensure_bank()
        bank.capture = False  # eager steps call the wrappers: their inputs are recorded
        got = {}
        for name, (section, n_valid) in sections(bank).items():
            with recorded_greedy_inputs() as seen:
                bank.step(1, section, n_valid)
                torch.cuda.synchronize()
            got[name] = seen
        del bank
        gc.collect()
        torch.cuda.empty_cache()
        return got

    def check(kernel: str, source: str, args: tuple, timed: bool) -> dict:
        wrapper, plain = ((lean_greedy, lean_greedy_reference) if kernel == "lean_greedy"
                          else (lane_greedy, lane_greedy_reference))
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not greedy_outputs_equal(got, want):
            raise AssertionError(f"{kernel}, {source}: the kernel differs from its plain version")
        if kernel == "lean_greedy":
            bound, by, work = lean_greedy_bound(args, got)
            shape = list(args[0].shape)
            entry = {"shape": shape, "survivors": int(torch.isfinite(got[1]).sum()),
                     "overflow_rows": int(got[2].sum()), "windows_read": work}
        else:
            bound, by, work = lane_greedy_bound(args[0], args[1], args[2], got)
            entry = {"shape": list(args[0].shape), "alive": int(args[1].sum()),
                     "kept": int(got.sum()), "compares": work}
        entry.update(bitwise_equal=True, bound_ms=bound, bound_by=by)
        if timed:
            dev_ms = graph_ms(lambda: wrapper(*args))
            plain_big = kernel == "lane_greedy" and args[0].shape[1] > 2048
            entry.update(
                device_ms=dev_ms, share_of_bound=bound / dev_ms if dev_ms else None,
                wrapper_ms=cuda_ms(lambda: wrapper(*args), 20),
                plain_ms=cuda_ms(lambda: plain(*args), 1 if plain_big else 5,
                                 reps=1 if plain_big else 5))
        return entry

    # The lean greedy on the flagship paths' own launches, then its named
    # cases and the regression captures.
    recorded = path_inputs(None)  # the detector's default threshold: the lean tier
    for name, seen in recorded.items():
        for gi, args in enumerate(seen["lean_greedy"]):
            out["lean_greedy"][f"{name}_group_{gi}"] = check("lean_greedy", name, args, True)
        if seen["lane_greedy"]:
            raise AssertionError(f"{name}: the lean tier ran the lane greedy")
    del recorded
    named = 0
    for case in LEAN_GREEDY_CASES:
        for m in LEAN_GREEDY_MS:
            args = lean_greedy_inputs(lean_greedy_case(case, m), dev, candidate_scan)
            check("lean_greedy", case, args, False)
            named += 1
    out["lean_greedy"]["named_cases_bitwise"] = named
    for args in corpus_inputs:
        check("lean_greedy", "regression capture", args, False)
        check("lane_greedy", "regression capture", lane_inputs_from_lean(args), False)
    out["lean_greedy"]["regression_launches_bitwise"] = len(corpus_inputs)
    out["lane_greedy"]["regression_rows_bitwise"] = len(corpus_inputs)
    del corpus_inputs

    # The lane greedy on the general-plateau tier's own launches.
    recorded = path_inputs(0.0)
    for name, seen in recorded.items():
        for gi, args in enumerate(seen["lane_greedy"]):
            out["lane_greedy"][f"{name}_group_{gi}"] = check("lane_greedy", name, args, True)
    del recorded
    gc.collect()
    torch.cuda.empty_cache()
    for k in LANE_GREEDY_KS:
        n_alive = [k if r % 2 == 0 else k // 3 for r in range(32)]
        pos, alive = lane_greedy_input(32, k, n_alive, 495_999, 2000, seed=k)
        args = (torch.from_numpy(pos).to(dev), torch.from_numpy(alive).to(dev), 2000)
        out["lane_greedy"][f"k_{k}"] = check("lane_greedy", f"K = {k}", args, True)
    for name in LANE_WORST_CASES:  # the walk's worst cases, 32 rows of 4,728 lanes
        pos, alive, m = lane_worst_case(name, 32, 4728)
        args = (torch.from_numpy(pos).to(dev), torch.from_numpy(alive).to(dev), m)
        out["lane_greedy"][f"worst_{name}"] = check("lane_greedy", name, args, True)

    lane_greedy.launches, lean_greedy.launches = counts  # measurement launches do not count
    for kernel in ("lean_greedy", "lane_greedy"):
        paths = GREEDY_PATH_LAUNCHES[kernel]
        out[kernel]["launches_by_path"] = paths
        if not paths or min(paths.values()) < 1:
            raise AssertionError(f"{kernel}: a path that runs it launched it no time: {paths}")
    phase("greedy_kernels", card=smi, clips=num_normal + num_marker, tolerance="bitwise",
          **out)
    # The kernels line: each kernel at the hit-bearing 16-row round's own
    # launch that does the most work (the group with the most windows read,
    # or the most compares).
    for kernel, work in (("lean_greedy", "windows_read"), ("lane_greedy", "compares")):
        e = max((v for k, v in out[kernel].items() if k.startswith("round_vmap_one_hit_row")),
                key=lambda v: v[work])
        line[kernel] = {"launches": sum(GREEDY_PATH_LAUNCHES[kernel].values()), "ms": e["device_ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "shape": e["shape"],
                        "wrapper_ms": e["wrapper_ms"],
                        "launches_by_path": GREEDY_PATH_LAUNCHES[kernel]}
    return line


def verify_normal_bound(args) -> dict:
    """The normal verifier's bound from one call's inputs: the bytes it must
    move over the memory rate, at the call's own live lanes and with every
    lane live. A live lane reads its window of lc samples and its position;
    the clips with a live lane (row r's clip is r % G) read their
    partitions and downsampled window once, the bin bounds once, the rows
    with a live lane their length and normaliser once; every lane reads its
    flag and writes accept, similarity and r. Its operations (a few a window
    sample) are below that."""
    corr, pos, alive, consts, normalise = args
    r_rows, k = pos.shape
    g, ds_n = consts.ds_clip.shape
    lc, ps = consts.corr_len, consts.partition_size
    row_bytes = 0 if normalise is None else 4 + (0 if isinstance(normalise[0], int) else 4)

    def ms(lanes: int, rows: int, clips: int) -> float:
        moved = (lanes * (lc * 4 + 8) + clips * (10 * ps + ds_n) * 4
                 + (2 * ds_n * 8 if lanes else 0) + rows * row_bytes + r_rows * k * (1 + 9))
        return moved / HBM_BYTES_PER_S * 1e3

    live_rows = alive.any(dim=1)
    live_clips = int(live_rows.reshape(-1, g).any(dim=0).sum())
    live = int(alive.sum())
    return {"live_lanes": live, "lanes": r_rows * k, "live_clips": live_clips, "clips": g,
            "bound_ms": ms(live, int(live_rows.sum()), live_clips),
            "bound_ms_every_lane_live": ms(r_rows * k, r_rows, g),
            "bound_by": "bytes"}


def verify_marker_bound(args) -> dict:
    """The fused marker verifier's bound from one call's inputs: the larger
    of the bytes it must move over the memory rate and its transforms'
    operations over the f32 rate. Bytes: each live lane's 3m-sample window
    and position read once; the band masks, thresholds, lock and frequency
    of the clips with a live lane (row r's clip is r % G), the Hann
    windows, frequency grids and FFT tables read once; every lane's flag
    read and accept written once. Operations: 5 n log2 n for each of a live
    lane's three m-sample windows and F frames of wl samples (the decisions,
    a few a bin, are below)."""
    import math

    from audio_pattern_detector_tpu_torch.ops.marker_fft import marker_layout, plan_tables

    _section, pos, alive, consts = args
    r_rows, k = pos.shape
    g = consts.dom_freq.shape[0]
    m, wl, n_frames = consts.clip_len, consts.frame_len, consts.frame_count
    fw, ff = m // 2 + 1, (wl // 2 + 1 if n_frames else 0)
    live = int(alive.sum())
    live_clips = int(alive.any(dim=1).reshape(-1, g).any(dim=0).sum())
    lay = marker_layout(m, wl, n_frames)
    tables = sum(len(t) for plan in (lay.whole, lay.frame) if plan is not None
                 for t in plan_tables(plan).values())
    once = (m + (wl if n_frames else 0) + fw + ff + tables) * 4 if live else 0
    moved = (live * (3 * m * 4 + 8) + live_clips * (fw + ff + 6 * 4 + 8) + once
             + 2 * r_rows * k)
    ops = live * (3 * 5 * m * math.log2(m) + n_frames * 5 * wl * math.log2(max(wl, 2)))
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_SCALAR_OPS * 1e3
    return {"live_lanes": live, "lanes": r_rows * k, "live_clips": live_clips, "clips": g,
            "bytes": moved, "operations": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "work_area": "shared" if lay.on_chip else "global"}


def marker_live_windows(args):
    """The live lanes' Hann-weighted windows (L, 3, m) and frames (L, F,
    wl), gathered as the plain version gathers every lane's: the yardstick
    inputs of ``torch.fft.rfft``."""
    import torch

    section, pos, alive, consts = args
    m, wl = consts.clip_len, consts.frame_len
    sections = section.reshape(-1, section.shape[-1])
    g = pos.shape[0] // sections.shape[0]
    rows, lanes = torch.nonzero(alive, as_tuple=True)
    secp = torch.nn.functional.pad(sections, (m + 8, m + 8))
    start = (pos[rows, lanes] - (m - 1) + 8).clamp(0, secp.shape[1] - 3 * m)
    idx = start[:, None] + torch.arange(3 * m, device=pos.device)
    seg3 = secp[(rows // g)[:, None], idx].reshape(-1, 3, m)
    frames = None
    if consts.frame_count > 0:
        starts = torch.tensor(consts.frame_starts, device=pos.device)
        fidx = m + starts[:, None] + torch.arange(wl, device=pos.device)
        frames = seg3.reshape(-1, 3 * m)[:, fidx] * consts.hann_frame
    return seg3 * consts.hann_whole, frames


MARKER_SPECTRA_RTOL = 1e-5  # of a window's largest magnitude: the kernel's FFT against the exact


def normal_plain_in_blocks(corr, pos, alive, consts, normalise, block: int = 16):
    """The normal verifier's plain version run 16 lanes at a time (as the
    CPU's two-tier verify runs it): its (R, K, lc) arrays stay a block's."""
    import torch

    from audio_pattern_detector_tpu_torch.ops.verify_normal import verify_normal_reference

    parts = [verify_normal_reference(corr, pos[:, lo:lo + block].contiguous(),
                                     alive[:, lo:lo + block].contiguous(), consts, normalise)
             for lo in range(0, pos.shape[1], block)]
    return tuple(torch.cat(x, dim=1) for x in zip(*parts))


@contextlib.contextmanager
def timed_verify_calls():
    """Inside the block, CUDA events around every verifier call the bank
    makes, and around the plain marker verifier's spectra and decisions
    (where the plain version runs); yields a function that returns the
    device ms of each (after a sync)."""
    import torch

    from audio_pattern_detector_tpu_torch.models import bank as bank_module
    from audio_pattern_detector_tpu_torch.ops import verify_marker as vm

    spans: dict[str, list] = {"verify_normal": [], "verify_marker": [], "marker_spectra": [],
                              "marker_decisions_reference": []}
    saved = {"verify_normal": (bank_module, bank_module.verify_normal),
             "verify_marker": (bank_module, bank_module.verify_marker),
             "marker_spectra": (vm, vm.marker_spectra),
             "marker_decisions_reference": (vm, vm.marker_decisions_reference)}

    def timed(name: str, fn):
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    for name, (module, fn) in saved.items():
        setattr(module, name, timed(name, fn))

    def totals() -> dict[str, float]:
        torch.cuda.synchronize()
        return {f"{k}_ms": sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()} | {
            f"{k}_calls": len(v) for k, v in spans.items()}

    try:
        yield totals
    finally:
        for name, (module, fn) in saved.items():
            setattr(module, name, fn)


def phase_verify_kernels(dev, smi: str, corpus_inputs: dict, num_normal: int = 32,
                         num_marker: int = 32) -> dict:
    """Phase 21 (``verify_kernels``): each verify kernel against its plain
    version on the card, on the inputs the paths give it:

    * the flagship bank's hit-bearing step (hits in both groups) and a
      16-row round whose row 5 is that section, in both schedules (``vmap``
      one step, ``scan`` row by row), each captured and eager (payloads
      bitwise; the eager steps' verifier calls are recorded);
    * the general-plateau tier's (``height_min = 0``) 16-row round with the
      hit-bearing row, the escalated marker row of phase 7 at its full
      4,728 lanes, phase 19's regression captures (their eager steps'
      calls), and the named cases of the CPU tests (the plain marker
      verifier with the FFT's and the DFT-GEMM's spectra; the long marker
      in the kernel's global-workspace form).

    Gates: accept bitwise, similarity and r within ``SIM_RTOL`` / ``R_ATOL``
    on live lanes, the marker kernel's magnitudes of live lanes (its test
    probe) within ``MARKER_SPECTRA_RTOL`` of the exact (f64) rfft of the
    same windows, torch's rfft's own error recorded beside it. For the
    hit-bearing inputs: the kernel's device ms (CUDA events around a graph
    of 20 calls), the wrapper's ms (events around 20 eager calls), the
    plain version's ms, the bound at the call's own live lanes (and, for
    the normal verifier, at every lane live) and the share; for the marker
    kernel also ``torch.fft.rfft`` over the live lanes' gathered windows
    and frames (the library call for its spectra part). Then the device ms
    of the hit-bearing 16-row round's verify tail split between the
    verifiers (CUDA events around each call of an eager round; the plain
    marker's spectra and decisions apart), with the kernels and with the
    plain versions in their place, beside the round's own. Returns the
    kernels line's numbers by kernel."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_bank, make_detector
    from audio_pattern_detector_tpu_torch.models import bank as bank_module
    from audio_pattern_detector_tpu_torch.ops import verify_marker as vm
    from audio_pattern_detector_tpu_torch.ops import verify_normal as vn

    counts = verify_counts()
    out: dict = {"verify_normal": {}, "verify_marker": {}}
    errs = {"verify_normal": 0.0, "verify_marker": 0.0}
    sr = 8000

    def check_normal(source: str, args, timed: bool) -> dict:
        corr, pos, alive, consts, normalise = args
        got = vn.verify_normal(*args)
        want = (normal_plain_in_blocks(*args) if pos.shape[1] > 16
                else vn.verify_normal_reference(*args))
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"verify_normal, {source}: accept differs from the plain version")
        sim_err = float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30))[alive].max()) \
            if bool(alive.any()) else 0.0
        r_err = float((got[2] - want[2]).abs()[alive].max()) if bool(alive.any()) else 0.0
        if sim_err > vn.SIM_RTOL or r_err > vn.R_ATOL:
            raise AssertionError(f"verify_normal, {source}: similarity {sim_err} or r {r_err} "
                                 "past the tolerance")
        errs["verify_normal"] = max(errs["verify_normal"], r_err)
        entry = {"shape": [*pos.shape, consts.corr_len], "accepted": int(got[0].sum()),
                 "sim_rel_err": sim_err, "r_abs_err": r_err, **verify_normal_bound(args)}
        if timed:
            dev_ms = graph_ms(lambda: vn.verify_normal(*args))
            plain = (lambda: normal_plain_in_blocks(*args)) if pos.shape[1] > 16 else (
                lambda: vn.verify_normal_reference(*args))
            entry.update(device_ms=dev_ms, share_of_bound=entry["bound_ms"] / dev_ms,
                         wrapper_ms=cuda_ms(lambda: vn.verify_normal(*args), 20),
                         plain_ms=cuda_ms(plain, 3, reps=3))
        return entry

    def check_marker(source: str, args, timed: bool) -> dict:
        section, pos, alive, consts = args
        got = vm.verify_marker(*args)
        want = vm.verify_marker_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"verify_marker, {source}: accept differs from the plain version")
        entry = {"shape": [*pos.shape, consts.clip_len], "frames": consts.frame_count,
                 "accepted": int(got.sum()), **verify_marker_bound(args)}
        # The kernel's spectra of live lanes (its test probe) against the
        # exact (f64) rfft of the same f32 windows, where the probe fits a
        # gigabyte; torch's rfft (the plain version's) is held to the same
        # and reported, not gated: cuFFT's own error reaches 3e-2 of a small
        # window's largest bin at m = 1,827 on the card.
        fw, ff = consts.clip_len // 2 + 1, consts.frame_len // 2 + 1
        width = 3 * fw + consts.frame_count * ff
        if bool(alive.any()) and pos.numel() * width * 4 <= 2**30:
            probe = torch.zeros((*pos.shape, width), device=dev)
            vm._launch(*args, probe=probe)
            w3, frames = marker_live_windows(args)
            mags = probe[alive].cpu().double()
            kernel = [mags[:, : 3 * fw].reshape(len(mags), 3, fw)]
            windows = [w3]
            if frames is not None:
                kernel.append(mags[:, 3 * fw:].reshape(len(mags), -1, ff))
                windows.append(frames)
            exact = [torch.from_numpy(np.abs(np.fft.rfft(w.cpu().double().numpy(), axis=-1)))
                     for w in windows]
            plain = [torch.fft.rfft(w, dim=-1).abs().cpu().double() for w in windows]

            def rel(xs, refs) -> float:
                return max(float(((x - r).abs().amax(-1) / r.amax(-1).clamp_min(1e-30)).max())
                           for x, r in zip(xs, refs))

            abs_err = max(float((x - r).abs().max()) for x, r in zip(kernel, exact))
            rel_err = rel(kernel, exact)
            if rel_err > MARKER_SPECTRA_RTOL:
                raise AssertionError(f"verify_marker, {source}: the kernel's spectra lie "
                                     f"{rel_err} of a window's largest bin from the exact rfft")
            errs["verify_marker"] = max(errs["verify_marker"], abs_err)
            entry.update(spectra_max_abs_err=abs_err, spectra_rel_err=rel_err,
                         plain_spectra_rel_err=rel(plain, exact),
                         kernel_vs_plain_spectra_rel_err=rel(kernel, plain))
            del probe, mags
        if timed:
            dev_ms = graph_ms(lambda: vm.verify_marker(*args))
            w3, frames = marker_live_windows(args)

            def library():
                torch.fft.rfft(w3, dim=-1)
                if frames is not None:
                    torch.fft.rfft(frames, dim=-1)

            entry.update(device_ms=dev_ms, share_of_bound=entry["bound_ms"] / dev_ms,
                         wrapper_ms=cuda_ms(lambda: vm.verify_marker(*args), 20),
                         plain_ms=cuda_ms(lambda: vm.verify_marker_reference(*args), 5),
                         plain_spectra_ms=cuda_ms(lambda: vm.marker_spectra(section, pos, consts),
                                                  5),
                         library_rfft_live_lanes_ms=cuda_ms(library, 5))
        return entry

    def check_all(source: str, seen: dict, timed: bool) -> None:
        for i, args in enumerate(seen["verify_normal"]):
            out["verify_normal"][f"{source}_{i}"] = check_normal(source, args, timed)
        for i, args in enumerate(seen["verify_marker"]):
            out["verify_marker"][f"{source}_{i}"] = check_marker(source, args, timed)

    # The flagship bank's hit-bearing step and round, both schedules,
    # captured against eager.
    bank = make_detector(num_normal, num_marker, 60, dev, sr)._ensure_bank()
    s_len = bank.classes[1]["section_len"]
    groups = bank.classes[1]["groups"]
    both = rerun_sections(bank)["clear"].copy()
    both[20 * sr: 21 * sr] += next(g for g in groups if g.kind == "normal").clips_np[0]
    both_t = torch.from_numpy(both).to(dev)
    rows = torch.stack([torch.from_numpy((0.05 * np.random.default_rng(1 + i).standard_normal(
        s_len)).astype(np.float32)) for i in range(ROUND_ROWS)]).to(dev)
    rows[ROUND_ROWS // 3] = both_t
    lens = torch.full((ROUND_ROWS,), s_len, dtype=torch.int32, device=dev)
    paths = {"flagship_step": lambda: bank.step(1, both_t, s_len),
             "round_vmap": lambda: bank.step(1, rows, lens),
             "round_scan": lambda: [bank.step(1, rows[i], s_len) for i in range(ROUND_ROWS)]}
    captured_equal = {}
    for name, fn in paths.items():
        bank.capture = False
        with recorded_verify_inputs() as seen:
            want = fn()
            torch.cuda.synchronize()
        bank.capture = True
        got = [fn() for _ in range(2)]  # the first use, then a replay
        captured_equal[name] = all(payloads_equal(g, want) for g in got)
        if not captured_equal[name]:
            raise AssertionError(f"verify_kernels, {name}: captured payload differs from eager")
        if not (seen["verify_normal"] and seen["verify_marker"]):
            raise AssertionError(f"verify_kernels, {name}: a verifier saw no live lane")
        check_all(name, seen, timed=name != "round_scan")
        del seen

    # The verify tail's device time in an eager hit-bearing round, split
    # between the verifiers, with the kernels and with the plain versions.
    bank.capture = False
    split = {}
    for form in ("kernels", "plain", "kernels", "plain"):
        if form == "plain":
            bank_module.verify_normal = vn.verify_normal_reference
            bank_module.verify_marker = vm.verify_marker_reference
        try:
            with timed_verify_calls() as totals:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                bank.step(1, rows, lens)
                end.record()
                t = totals()
        finally:
            bank_module.verify_normal = vn.verify_normal
            bank_module.verify_marker = vm.verify_marker
        t["round_ms"] = start.elapsed_time(end)
        split.setdefault(form, []).append(t)
    del bank, rows, both_t
    gc.collect()
    torch.cuda.empty_cache()

    # The general-plateau round, the escalated marker row, the regression
    # captures and the named cases.
    gen = make_detector(num_normal, num_marker, 60, dev, sr, height_min=0.0)._ensure_bank()
    gen.capture = False
    grows = torch.stack([torch.from_numpy((0.05 * np.random.default_rng(1 + i).standard_normal(
        s_len)).astype(np.float32)) for i in range(ROUND_ROWS)]).to(dev)
    grows[ROUND_ROWS // 3] = torch.from_numpy(both).to(dev)
    with recorded_verify_inputs(limit=2) as seen:
        gen.step(1, grows, lens)
        torch.cuda.synchronize()
    check_all("general_round_vmap", seen, timed=True)
    del gen, grows, seen
    gc.collect()
    torch.cuda.empty_cache()
    rb = make_bank(num_normal, num_marker, chunk_seconds=60, device=dev)
    marker_gi = next(gi for gi, g in enumerate(rb.classes[1]["groups"]) if g.kind == "marker")
    escalated = rerun_sections(rb)["escalated"]
    with recorded_verify_inputs(limit=3) as seen:
        rb._full_tier_row(1, marker_gi, 0, escalated, capped=False)
        torch.cuda.synchronize()
    check_all("escalated_marker_row", seen, timed=True)
    del rb, seen
    check_all("corpus", corpus_inputs, timed=False)
    named = 0
    for name in VERIFY_NORMAL_CASES:
        check_normal(name, verify_normal_inputs(verify_normal_case(name), dev), False)
        named += 1
    for spectra in ("0", "1"):
        with switches({"APD_MARKER_GEMM": spectra}):
            for name in VERIFY_MARKER_CASES:
                check_marker(name, verify_marker_inputs(verify_marker_case(name), dev), False)
                named += 1
    with switches({"APD_MARKER_GEMM": "0"}):
        out["verify_marker"][MARKER_52S] = check_marker(
            MARKER_52S, verify_marker_inputs(verify_marker_case(MARKER_52S), dev), False)
        named += 1
    gc.collect()
    torch.cuda.empty_cache()

    vn.verify_normal.launches = counts["verify_normal"]  # measurement launches do not count
    vm.verify_marker.launches = counts["verify_marker"]
    for kernel in ("verify_normal", "verify_marker"):
        paths_seen = VERIFY_PATH_LAUNCHES[kernel]
        out[kernel]["launches_by_path"] = paths_seen
        if not paths_seen or min(paths_seen.values()) < 1:
            raise AssertionError(f"{kernel}: a path that runs it launched it no time: {paths_seen}")
    phase("verify_kernels", card=smi, clips=num_normal + num_marker,
          accept="bitwise", sim_rtol=vn.SIM_RTOL, r_atol=vn.R_ATOL,
          captured_equals_eager=captured_equal, named_cases=named,
          corpus_launches={k: len(v) for k, v in corpus_inputs.items()},
          hit_bearing_round_verify_tail_device_ms=split, **out)
    # The kernels line: each kernel at the hit-bearing 16-row round's own
    # launch (vmap).
    # The marker kernel's library call is torch.fft.rfft over the live
    # lanes' gathered windows (its spectra part); no PyTorch call computes
    # the normal verifier. max_abs_err: the normal verifier's r, the marker
    # kernel's magnitudes against the exact rfft (accept bits are equal).
    line = {}
    for kernel in ("verify_normal", "verify_marker"):
        e = out[kernel]["round_vmap_0"]
        line[kernel] = {"launches": sum(VERIFY_PATH_LAUNCHES[kernel].values()),
                        "ms": e["device_ms"], "plain_ms": e["plain_ms"],
                        "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                        "library_ms": e.get("library_rfft_live_lanes_ms"),
                        "shape": e["shape"], "live_lanes": e["live_lanes"],
                        "wrapper_ms": e["wrapper_ms"], "max_abs_err": errs[kernel],
                        "launches_by_path": VERIFY_PATH_LAUNCHES[kernel]}
    return line


def regression_cases() -> list[tuple[str, str]]:
    """(pattern, audio) of the 17 cases of tests/test_real_data_regressions.py,
    read from that file's module-level assignments (importing it would
    import the JAX package), evaluated with ``os`` and the corpus root."""
    import ast

    tree = ast.parse((ROOT / "tests" / "test_real_data_regressions.py").read_text())
    names: dict = {"os": os, "SAMPLE_AUDIOS": str(AUDIO)}
    for node in tree.body:
        if isinstance(node, ast.Assign) and all(isinstance(t, ast.Name) for t in node.targets):
            exec(compile(ast.Module(body=[node], type_ignores=[]), "cases", "exec"), names)
    return [(pattern, audio) for pattern, audio, _ in names["CASES"]]


def phase_corpus(dev) -> tuple[int, list, dict]:
    """Phase 19: the 17 real broadcast captures of ``sample_audios/regressions/``
    (tests/test_real_data_regressions.py's cases) through the port's
    ``match_pattern`` on the card and on the CPU in this process: each
    case's detections and total equal. (tests/test_torch_corpus.py holds the
    CPU run to the JAX package, exactly.) Prints each case's detections,
    the flagged rows of the card runs by route (row rerun, class rerun,
    escalated, host path) and the share of the scan's valid samples at or
    above the row's threshold over the kernel launches of the card runs
    (each case's first chunk is its key's eager first use; replays of
    later chunks call no wrapper and are not counted there). Returns the
    card runs' candidate-scan launches and the inputs of the lean greedy's
    launches in the same eager steps (phase 20 holds the kernels to their
    plain versions on them); the lean greedy's launches go to the kernels
    line."""
    import torch

    from audio_pattern_detector_tpu_torch import match as match_module
    from audio_pattern_detector_tpu_torch.match import match_pattern
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy

    built: list = []
    build_detector = match_module.TorchEngineOptions.build_detector

    def recording_build(self, clips):
        det = build_detector(self, clips)
        built.append(det)
        return det

    cases, above, valid = [], 0, 0
    launches = lean_launches = 0
    lean_inputs: list = []
    verify_inputs: dict[str, list] = {"verify_normal": [], "verify_marker": []}
    for pattern, audio in regression_cases():
        cpu = match_pattern(audio, [pattern], device="cpu")
        match_module.TorchEngineOptions.build_detector = recording_build
        try:
            with captured_scan_inputs(limit=10**6) as scans, recorded_greedy_inputs() as greedy, \
                    recorded_verify_inputs(limit=64) as verify, \
                    counted_verify_launches("corpus_regressions",
                                            lambda: [d._bank for d in built]):
                before = (candidate_scan.launches, lean_greedy.launches)
                card = match_pattern(audio, [pattern], device=dev.type)
                torch.cuda.synchronize()
                launches += candidate_scan.launches - before[0]
                lean_launches += lean_greedy.launches - before[1]
            lean_inputs += greedy["lean_greedy"]
            for kernel, calls in verify.items():
                verify_inputs[kernel] += calls
        finally:
            match_module.TorchEngineOptions.build_detector = build_detector
        if card != cpu:
            raise AssertionError(f"{audio}: the card's {card} differs from the CPU's {cpu}")
        for corr, thr, valid_len in scans:
            lens = (valid_len.to(torch.int64) if isinstance(valid_len, torch.Tensor) else
                    torch.full((corr.shape[0],), valid_len, dtype=torch.int64, device=corr.device))
            mask = torch.arange(corr.shape[1], device=corr.device)[None, :] < lens[:, None]
            above += int((mask & (corr >= thr[:, None])).sum())
            valid += int(lens.clamp(0, corr.shape[1]).sum())
        scans.clear()
        bank = built[-1]._bank
        cases.append({"audio": os.path.relpath(audio, AUDIO),
                      "pattern": os.path.basename(pattern),
                      "detections_s": sorted(t for ts in card[0].values() for t in ts),
                      "routes_row_class_escalated_host": routes(bank)})
    totals = [sum(c["routes_row_class_escalated_host"][i] for c in cases) for i in range(4)]
    # A verifier whose kind of clip no capture's bank holds runs on no path here.
    kinds = {g.kind for det in built for cls in det._bank.classes.values() for g in cls["groups"]}
    for kind in ("normal", "marker"):
        if kind not in kinds:
            del VERIFY_PATH_LAUNCHES[f"verify_{kind}"]["corpus_regressions"]
    if lean_launches != launches:
        raise AssertionError(f"corpus: {lean_launches} lean greedy launches, {launches} scans")
    GREEDY_PATH_LAUNCHES["lean_greedy"]["corpus_regressions"] = lean_launches
    phase("corpus_regressions", cases=len(cases), equal_to_cpu=True, kernel_launches=launches,
          lean_greedy_launches=lean_launches, flagged_rows_row_class_escalated_host=totals,
          share_of_samples_at_or_above_threshold=above / max(valid, 1),
          samples_scanned=valid,
          verify_launches={k: v.get("corpus_regressions") for k, v in VERIFY_PATH_LAUNCHES.items()},
          per_case=cases)
    return launches, lean_inputs, verify_inputs


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the torch port on one CUDA card.")
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="also profile the flagship step, the flagship and serving rounds in "
                         "both batch modes and the batched file-mode run; op tables go to DIR")
    ap.add_argument("--multi-process-worker", nargs=5,
                    metavar=("RANK", "PORT", "OUT", "DEVICE", "CLIPS"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.multi_process_worker:  # phase 12's processes
        rank, port, out, device, clips = args.multi_process_worker
        return multi_process_worker(int(rank), int(port), Path(out), device, clips)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)  # phase 3c writes there first

    from audio_pattern_detector_tpu_torch.match import _auto_perf_plan, _load_pattern_clips
    from audio_pattern_detector_tpu_torch import cli
    from audio_pattern_detector_tpu_torch.flagship import flagship_round, flagship_step
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )
    from audio_pattern_detector_tpu_torch.ops.correlate import cufft_correlation
    from audio_pattern_detector_tpu_torch.ops.correlate_os import correlate_os
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy
    from audio_pattern_detector_tpu_torch.ops.loudness import loudness_gate
    from audio_pattern_detector_tpu_torch.ops.verify_marker import verify_marker
    from audio_pattern_detector_tpu_torch.ops.verify_normal import verify_normal

    dev = torch.device("cuda")
    # The run must write nothing into the JAX package (compared at the end).
    jax_pkg = ROOT / "audio_pattern_detector_tpu"
    jax_pkg_before = tree_snapshot(jax_pkg) if jax_pkg.is_dir() else {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ── 1. Device and build ──
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    kern = load_kernels()
    phase("device", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
          kernel_build_s=kern.build_seconds, kernel_load_s=time.perf_counter() - t0,
          library=str(kern.path.relative_to(ROOT)))
    for line in kern.compiler_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # ── 2. Kernel against its plain version at flagship shapes ──
    kernel_rows = []
    for seed, (g, l) in enumerate(SCAN_SHAPES):
        corr_np, thr_np = make_scan_input(g, l, seed)
        corr = torch.from_numpy(corr_np).to(dev)
        thr = torch.from_numpy(thr_np).to(dev)
        valid_len = l - 1234
        got = candidate_scan(corr, thr, valid_len)
        want = candidate_scan_reference(corr, thr, valid_len)
        torch.cuda.synchronize()
        err = check_scan_equal(got, want)
        if not (bool(want[2].any()) and bool(want[4].any()) and not bool(want[4].all())):
            raise AssertionError("scan input did not exercise the plateau and near flags")
        # The per-row form: lengths spread over [L/2, L], bitwise too.
        lens = torch.from_numpy(np.linspace(l // 2, l, g).astype(np.int32)).to(dev)
        err = max(err, check_scan_equal(candidate_scan(corr, thr, lens),
                                        candidate_scan_reference(corr, thr, lens)))
        ms = cuda_ms(lambda: candidate_scan(corr, thr, valid_len), TIMED_RUNS)
        plain_ms = cuda_ms(lambda: candidate_scan_reference(corr, thr, valid_len), TIMED_RUNS)
        dev_ms = kernel_device_ms(lambda: candidate_scan(corr, thr, valid_len),
                                  "candidate_scan_kernel", TIMED_RUNS)
        # L2-cold: a 128 MB write (more than the 50 MB L2) before each call.
        flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
        cold_ms = kernel_device_ms(lambda: candidate_scan(corr, thr, valid_len),
                                   "candidate_scan_kernel", TIMED_RUNS,
                                   between=lambda: flush.fill_(1.0))
        del flush
        # A threshold of 0 puts every finite sample at or above it, so every
        # sample runs the threshold-side tests: the kernel's slowest input.
        zero = torch.zeros_like(thr)
        err = max(err, check_scan_equal(candidate_scan(corr, zero, valid_len),
                                        candidate_scan_reference(corr, zero, valid_len)))
        zero_ms = kernel_device_ms(lambda: candidate_scan(corr, zero, valid_len),
                                   "candidate_scan_kernel", TIMED_RUNS)
        bound_ms = scan_bound_ms(g, l, valid_len)
        phase("scan", shape=[g, l], valid_len=valid_len, bitwise_equal=True,
              per_row_valid_len_bitwise=True, threshold_zero_bitwise=True,
              max_abs_err=err, ms=ms, plain_ms=plain_ms, kernel_device_ms=dev_ms,
              bound_ms=bound_ms, share_of_bound=bound_ms / dev_ms if dev_ms else None,
              kernel_device_ms_l2_cold=cold_ms,
              share_of_bound_l2_cold=bound_ms / cold_ms if cold_ms else None,
              share_above_threshold=share_above(corr, thr, valid_len),
              kernel_device_ms_threshold_zero=zero_ms,
              share_of_bound_threshold_zero=bound_ms / zero_ms if zero_ms else None,
              read_gb_per_s=corr_np.nbytes / (dev_ms * 1e-3) / 1e9 if dev_ms else None,
              candidates=int(want[1].sum()), plateau_rows=int(want[2].sum()),
              near_rows=int(want[4].sum()))
        kernel_rows.append((g, l, err, ms, plain_ms, bound_ms))
        del corr, got, want
    edge_cases = check_scan_edges(dev, edge_shapes() + list(EDGE_WIDE))
    phase("scan_edges", cases=edge_cases, lengths=list(EDGE_LENGTHS), rows=list(EDGE_ROWS),
          walking_shapes=[list(s) for s in EDGE_WIDE], thresholds=["few above", "all above"],
          bitwise_equal=True)

    # ── 3. The flagship step, kernel against plain scan ──
    step, bank = flagship_step(dev)
    with captured_scan_inputs(limit=2) as step_scans:
        pk = step(candidate_scan)
    pp = step(candidate_scan_reference)
    torch.cuda.synchronize()
    for a, b in zip(pk, pp):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("flagship payloads differ between kernel and plain scan")
    flags = sum(int((p[:, -2] != 0).sum()) for p in pk)

    def step_ms(scan) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            step(scan)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 5 * 1e3

    step_ms(candidate_scan)
    times: dict[str, list[float]] = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")) * 3:
        for name in order:
            times[name].append(step_ms(candidate_scan if name == "kernel"
                                       else candidate_scan_reference))
    phase("flagship_step", clips=64, section_s=60, payloads_identical=True,
          flagged_rows=flags, ms_per_step_kernel=float(np.median(times["kernel"])),
          ms_per_step_plain=float(np.median(times["plain"])),
          kernel_ahead_pairs=sum(k < p for k, p in zip(times["kernel"], times["plain"])),
          pairs=len(times["kernel"]), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del step, bank, pk, pp

    # ── 2b, 3b. The batched shapes: the kernel alone, then the flagship round ──
    batched_rows = phase_scan_batched(dev, smi)
    round_launches, round_kernel_rows = phase_flagship_round(dev, smi)
    gate_line = phase_round_invariance(dev, smi)
    phase_stage_split(dev, smi)
    correlate_line = phase_correlate_kernel(dev, smi)
    flow_launches = phase_correlate_flows(dev, smi)
    correlate_line["launches_by_path"].update(flow_launches)
    correlate_line["cufft_route_calls_by_path"].update(dict.fromkeys(flow_launches, 0))
    general_launches = phase_general_plateau(dev, smi, profile=args.profile)

    # ── 4-5. The main path: flag-free file mode through the CLI ──
    built = []
    build_detector = cli.TorchEngineOptions.build_detector

    def recording_build(self, clips):
        det = build_detector(self, clips)
        built.append(det)
        return det

    cli.TorchEngineOptions.build_detector = recording_build
    candidate_scan.launches = lean_greedy.launches = lane_greedy.launches = 0
    verify_normal.launches = verify_marker.launches = loudness_gate.launches = 0
    correlate_os.launches = cufft_correlation.launches = 0
    # The verifiers' launches of the golden flows and the batched run.
    file_mode_verify = contextlib.ExitStack()
    file_mode_verify.enter_context(
        counted_verify_launches("file_mode", lambda: [d._bank for d in built]))

    rthk = AUDIO / "rthk_section_with_beep.wav"
    expect_events(["--pattern-file", str(CLIPS / "rthk_beep.apd.toml")], rthk,
                  [("rthk_beep", 1408), ("rthk_beep", 2420)], 4078)
    expect_events(["--pattern-file", str(CLIPS / "cbs_news.wav")],
                  AUDIO / "cbs_news_audio_section.wav", [("cbs_news", 25899)], 32122)
    for fp in ("881_beep.apd.toml", "903_beep.apd.toml"):
        expect_events(["--pattern-file", str(CLIPS / fp)], rthk, [], 4078)
    golden_launches = candidate_scan.launches
    phase("golden_cli", flows=4, exact=True, kernel_launches=golden_launches)

    pcm, rate = cbs_pcm()
    copies = 15
    period_ms = len(pcm) / rate * 1e3
    audio_s = copies * len(pcm) / rate
    pattern = ["--pattern-file", str(CLIPS / "cbs_news.wav")]
    with tempfile.TemporaryDirectory() as tmp:
        tiled = Path(tmp) / "cbs_x15.wav"
        write_tiled(tiled, pcm, rate, copies)
        chunk_s, batch = _auto_perf_plan(
            str(tiled), _load_pattern_clips([str(CLIPS / "cbs_news.wav")], rate), rate
        )
        t = time.perf_counter()
        batched = run_cli(["match", *pattern, str(tiled)])
        wall = time.perf_counter() - t
        main_path_launches = candidate_scan.launches
        main_path_greedy = {"lean_greedy": lean_greedy.launches,
                            "lane_greedy": lane_greedy.launches}
        gate_line["launches_by_path"]["file_mode"] = loudness_gate.launches
        correlate_line["launches_by_path"]["file_mode"] = correlate_os.launches
        file_mode_cufft = correlate_line["cufft_route_calls_by_path"]["file_mode"] = (
            cufft_correlation.launches)
        GREEDY_PATH_LAUNCHES["lean_greedy"]["file_mode"] = lean_greedy.launches
        file_mode_verify.close()
        batched_launches = main_path_launches - golden_launches
        groups = sum(len(c["groups"]) for c in built[-1]._bank.classes.values())
        # An explicit --chunk-seconds turns the file-mode batching off
        # (an explicit --stream-batch 1 alone reads as unset). Not the main
        # path: its launches are left out of the count above.
        with captured_scan_inputs(limit=1) as file_scans:
            t = time.perf_counter()
            single = run_cli(["match", *pattern, "--chunk-seconds", "60", "--stream-batch", "1",
                              str(tiled)])
            single_wall = time.perf_counter() - t
        got = detections(batched)
        want = [25899 + period_ms * k for k in range(copies)]
        if len(got) != copies or any(abs(ms - w) > 1.0 for (_, ms), w in zip(got, want)):
            raise AssertionError(f"tiled file: got {got}, want about {want}")
        if got != detections(single):
            raise AssertionError(f"batched {got} != unbatched {detections(single)}")
        n_chunks = -(-len(pcm) * copies // (chunk_s * rate))
        n_launches = -(-n_chunks // batch)
        phase("scan_batch", audio_s=audio_s, chunk_s=chunk_s, chunks=n_chunks, batch=batch,
              launches_per_class=n_launches, detections=len(got), batch_invariant=True,
              wall_s=wall, x_realtime=audio_s / wall,
              unbatched_wall_s=single_wall, unbatched_x_realtime=audio_s / single_wall)

        # ── 6. Kernel use on the main path ──
        cli.TorchEngineOptions.build_detector = build_detector
        # The scan runs once per group for each of the batch's rows, a
        # zero-padded final row included.
        want_batched = groups * n_launches * batch
        if golden_launches <= 0 or batched_launches != want_batched:
            raise AssertionError(
                f"kernel launches: {golden_launches} in the golden flows, "
                f"{batched_launches} in the batched run (want {want_batched})"
            )
        # The lean greedy runs in every lean group step, beside the scan (the
        # lane greedy only where a flagged row reruns).
        if main_path_greedy["lean_greedy"] != main_path_launches:
            raise AssertionError(f"greedy launches on the main path: {main_path_greedy}, "
                                 f"scan launches {main_path_launches}")
        # The loudness gate runs once in every class step.
        if gate_line["launches_by_path"]["file_mode"] < 1:
            raise AssertionError("the loudness gate launched no time on the main path")
        # The correlation kernel runs in every group step, beside the scan,
        # and the cuFFT route at no correlation site.
        if (correlate_line["launches_by_path"]["file_mode"] < main_path_launches
                or file_mode_cufft):
            raise AssertionError(
                f"correlation on the main path: {correlate_line['launches_by_path']['file_mode']} "
                f"kernel launches for {main_path_launches} group steps, {file_mode_cufft} "
                "calls of the cuFFT route")
        host_rows = sum(d._bank.host_path_rows for d in built if d._bank is not None)
        phase("kernel_use", candidate_scan_launches=main_path_launches,
              greedy_launches=main_path_greedy,
              loudness_gate_launches=gate_line["launches_by_path"]["file_mode"],
              correlate_os_launches=correlate_line["launches_by_path"]["file_mode"],
              correlation_cufft_route_calls=file_mode_cufft,
              golden_launches=golden_launches, batched_launches=batched_launches,
              host_path_rows=host_rows, detectors=len(built))

        # ── 6b. The kernel on the correlations the main path gives it ──
        for source, scans in (("flagship_step", step_scans), ("file_mode", file_scans)):
            for corr, thr, valid_len in scans:
                g, l = corr.shape
                err = check_scan_equal(candidate_scan(corr, thr, valid_len),
                                       candidate_scan_reference(corr, thr, valid_len))
                dev_ms = kernel_device_ms(lambda: candidate_scan(corr, thr, valid_len),
                                          "candidate_scan_kernel", TIMED_RUNS)
                bound_ms = scan_bound_ms(g, l, valid_len)
                phase("scan_main_path_input", source=source, shape=[g, l],
                      valid_len=valid_len if isinstance(valid_len, int) else "per row",
                      bitwise_equal=True, max_abs_err=err,
                      share_above_threshold=share_above(corr, thr, valid_len),
                      kernel_device_ms=dev_ms, bound_ms=bound_ms,
                      share_of_bound=bound_ms / dev_ms if dev_ms else None)
        if len(step_scans) != 2 or len(file_scans) != 1:
            raise AssertionError("the main path's scan inputs were not captured")
        del step_scans, file_scans

        # ── Optional: where the time goes ──
        if args.profile is not None:
            step, bank = flagship_step(dev)
            step()
            phase("profile_flagship_step",
                  **profile_run(step, args.profile / "flagship_step.txt"))
            del step, bank
            round_step, bank, _ = flagship_round(dev)
            round_step("vmap")
            for mode in ("vmap", "scan"):
                phase("profile_flagship_round", mode=mode, rows=ROUND_ROWS,
                      **profile_run(lambda: round_step(mode),
                                    args.profile / f"flagship_round_{mode}.txt"))
            del round_step, bank
            phase("profile_file_mode", audio_s=audio_s,
                  **profile_run(lambda: run_cli(["match", *pattern, str(tiled)]),
                                args.profile / "file_mode.txt"))

    phase_wide_rerun(dev, smi)
    phase_entry_points(dev)
    serving_launches = phase_multistream(dev, smi, profile=args.profile)
    phase_serve(dev, smi)
    phase_serve(dev, smi, mesh_stream=2)
    mesh_launches = phase_mesh(dev, smi)
    multi_process_launches = phase_multi_process(dev, smi)
    variant_launches = phase_variants(dev, smi)
    phase_captured(dev, smi, profile=args.profile)
    phase_skip_verify_and_staging(dev, smi, profile=args.profile)
    split_launches = phase_split_rounds(dev, smi)
    greedy_launches = phase_greedy_forms(dev, smi)
    corpus_launches, corpus_lean_inputs, corpus_verify_inputs = phase_corpus(dev)
    greedy_line = phase_greedy_kernels(dev, smi, corpus_lean_inputs)
    del corpus_lean_inputs
    verify_line = phase_verify_kernels(dev, smi, corpus_verify_inputs)
    del corpus_verify_inputs

    jax_pkg_after = tree_snapshot(jax_pkg) if jax_pkg.is_dir() else {}
    if jax_pkg_after != jax_pkg_before:
        changed = sorted(set(jax_pkg_after.items()) ^ set(jax_pkg_before.items()))
        raise AssertionError(f"the run wrote into the JAX package: {changed}")
    phase("isolation", jax_package_untouched=True, files=len(jax_pkg_after))

    g, l, err, ms, plain_ms, bound_ms = kernel_rows[0]
    bg, bl, berr, bms, bplain_ms, bbound_ms = batched_rows[0]
    # Launches of the counted main-path runs, each counted from 0: file
    # mode (phases 4-5), the batched flagship round (phase 3b), one
    # captured general-plateau round in each mode (phase 3c), the serving
    # session in both batch modes and on a stream mesh (phase 9),
    # the mesh paths (phase 11), the two processes' paths (phase 12, summed
    # over the processes), the class-step switches that keep the kernel
    # tier (phase 13; the mask tier launches none), the captured split
    # rounds (phase 17), the greedy's timed calls (phase 18) and the
    # regression corpus on the card (phase 19). ``ms``, ``plain_ms``
    # and ``bound_ms`` are phase 2's at (32, 495,999); the batched shape's
    # stand beside them. No single PyTorch call computes the scan's five
    # outputs, so no library time. The greedy kernels' numbers are phase
    # 20's on a 16-row round's own launch, their launches those of the paths
    # that run them (GREEDY_PATH_LAUNCHES); no PyTorch call computes either.
    launches = {"file_mode": main_path_launches, "flagship_round_vmap": round_launches,
                "general_plateau_vmap": general_launches["vmap"],
                "general_plateau_scan": general_launches["scan"],
                "serving_scan": serving_launches["scan"], "serving_vmap": serving_launches["vmap"],
                "serving_stream_mesh": serving_launches["mesh"], **mesh_launches,
                **multi_process_launches, "variants": variant_launches,
                **{f"split_round_{k}": v for k, v in split_launches.items()},
                "greedy_forms": greedy_launches,
                "corpus_regressions": corpus_launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a path of the run launched no kernel: {launches}")
    greedy_sources = {"lean_greedy": ("audio_pattern_detector_tpu_torch/csrc/lean_greedy.cu",
                                      "audio_pattern_detector_tpu/ops/peaks.py:459"),
                      "lane_greedy": ("audio_pattern_detector_tpu_torch/csrc/lane_greedy.cu",
                                      "audio_pattern_detector_tpu/ops/peaks.py:327"),
                      "verify_normal": ("audio_pattern_detector_tpu_torch/csrc/verify_normal.cu",
                                        "audio_pattern_detector_tpu/ops/verify.py:154"),
                      "verify_marker": ("audio_pattern_detector_tpu_torch/csrc/verify_marker.cu",
                                        "audio_pattern_detector_tpu/ops/verify.py:324")}
    print(json.dumps({"kernels": [{
        "name": "candidate_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(launches.values()),
        "max_abs_err": max(r[2] for r in kernel_rows + batched_rows + round_kernel_rows),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None, "launches_by_path": launches,
        "batched_shape": [bg, bl], "batched_ms": bms, "batched_plain_ms": bplain_ms,
        "batched_bound_ms": bbound_ms,
    }, *({"name": name, "route": "cuda", "source": greedy_sources[name][0],
          "replaces": greedy_sources[name][1], "max_abs_err": 0.0, "library_ms": None,
          **greedy_line[name]} for name in ("lane_greedy", "lean_greedy")),
        *({"name": name, "route": "cuda", "source": greedy_sources[name][0],
           "replaces": greedy_sources[name][1], **verify_line[name]}
          for name in ("verify_normal", "verify_marker")),
        {"name": "loudness_gate", "route": "cuda", "source": LOUDNESS_GATE_SOURCE,
         "replaces": LOUDNESS_GATE_REPLACES,
         "launches": sum(gate_line["launches_by_path"].values()), **gate_line},
        {"name": "correlate_os", "route": "cuda", "source": CORRELATE_SOURCE,
         "replaces": CORRELATE_REPLACES,
         "launches": sum(correlate_line["launches_by_path"].values()),
         "cufft_route_calls": sum(correlate_line["cufft_route_calls_by_path"].values()),
         **correlate_line}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
