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
   a round against 32; the largest differences of the schedules' f32
   intermediates (LUFS within 1e-4 LU, normalised sections within 1e-5,
   correlation within 1e-5 of its max); ms per round of both in turns
   (vmap, scan, scan, vmap, twice; 3 rounds each), median and range; peak
   memory of both; the kernel, bitwise and timed, on the round's own two
   launches;
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
   rerun and whether a row rerun's payload equals the same row of a class
   rerun bit for bit (cuFFT at batch 1 and batch G);
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
   its lane greedy's while loops and its two-tier cond CUDA conditional
   nodes, against its eager step (host loops) on the same bank: the 16-row
   flagship round in both batch modes, payloads bit for bit; in turns, host
   ms until the dispatch returns and until the payload is on the host (a
   captured vmap dispatch must return in under half the time to its
   payload), the device span of the dispatch; the key's capture seconds,
   first-use peak and kept graph pools, the eager round's peak, one kernel
   launch per group per replay (on the kernels line), profiled device-busy
   ms of a captured and an eager vmap round, the lean tier's captured round;
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
   (``APD_PALLAS=0``, ``APD_NO_OVERLAP_SAVE``, ``APD_PACKED_UPLOAD=0``,
   ``APD_MARKER_GEMM``), each set around its bank's construction and run,
   on a 16-row round of int16 chunks and on phase 9's streams: payloads
   and detections equal to the default's (the mask tier has no
   near-collapse flag), f32 intermediates within tolerance, the DFT-GEMM
   at f32 with TF32 allowed; ms per round beside the default's,
   kernel launches (0 under ``APD_PALLAS=0``);
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
   conditional node, ``APD_SKIP_EMPTY_VERIFY``) and the pinned staging
   pool: a flagship detector with the node (the default) against one built
   with ``APD_SKIP_EMPTY_VERIFY=0`` and against the eager step, payloads
   bit for bit on the flagship step's candidate-free section, phase 7's
   sections and one with hits in both groups, a candidate-free 16-row round
   and one with a single hit-bearing row (both modes), a chunk on 2 bank
   shards; detections, routes and stream times on phase 9's session in
   both modes, with accepted hits in both groups of one section (so both
   bodies ran); the node's route; under torch.profiler the kernels only the
   verifiers launch, absent from a candidate-free replay, and how many of
   them the trace of a replay with hits in both groups records; ms in turns (node, none, none, node, twice) and
   profiled device-busy ms for the step, the rounds and the session; the
   pinned host allocations of a first and of a steady 16-row serving round
   (none in a steady one). A node that cannot be captured raises. It runs
   before 15;
15. isolation: no file under ``audio_pattern_detector_tpu/`` changed during
   the run, and no subprocess imported jax or the JAX package.

``python3 chip_smoke.py --profile DIR`` adds phases that run the
flagship step, the flagship round and one 16-row serving round in both
batch modes, and the batched file-mode run under torch.profiler, print
wall time, device time, kernel and launch counts, and write each op table
to DIR.

Any mismatch raises, and the script exits non-zero. Without a CUDA card
it exits 2 before printing any result. The last two lines of stdout are
a JSON line of per-kernel numbers and the JSON status line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
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
AUDIO = ROOT / "sample_audios"
CLIPS = AUDIO / "clips"
KERNEL_SOURCE = "audio_pattern_detector_tpu_torch/csrc/candidate_scan.cu"
KERNEL_REPLACES = "audio_pattern_detector_tpu/ops/pallas_peaks.py:154"
SCAN_SHAPES = ((32, 495_999), (32, 489_999))  # flagship normal / marker groups
TIMED_RUNS = 30


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + json.dumps(numbers), flush=True)


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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate


def scan_bound_ms(g: int, l: int, valid_len) -> float:
    """The least time of one scan on the card: the bytes the function needs
    (each row's valid samples and the thresholds read once, and the lengths
    where they are per row; the block maxima and four (G,) stats written
    once) over the memory rate. Its operations (a few compares a sample)
    bound it far lower. ``valid_len`` is an int or a (G,) tensor."""
    if isinstance(valid_len, int):
        n_read = g * min(valid_len, l) * 4 + g * 4
    else:
        n_read = int(valid_len.clamp(0, l).sum()) * 4 + 2 * g * 4
    n_written = g * -(-l // 512) * 4 + 4 * g * 4
    return (n_read + n_written) / HBM_BYTES_PER_S * 1e3


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


def run_cli(argv: list[str]) -> list[dict]:
    """The port's CLI in-process; its JSONL events."""
    from audio_pattern_detector_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


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
    from audio_pattern_detector_tpu_torch.ops.correlate import bank_correlate_abs
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    step, bank, sections = flagship_round(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    candidate_scan.launches = 0
    pv = step("vmap")
    torch.cuda.synchronize()
    launches = candidate_scan.launches
    peak = torch.cuda.max_memory_allocated()
    pv_bytes = pv.numel() * pv.element_size()
    torch.cuda.reset_peak_memory_stats()
    candidate_scan.launches = 0
    ps = step("scan")
    torch.cuda.synchronize()
    scan_launches = candidate_scan.launches
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

    # The f32 intermediates of the two schedules, row 0 and the whole round.
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
    corr_diff = []
    for g in cls["groups"]:
        cb, _ = bank_correlate_abs(norm_b, n_valids, g.corr)
        c0, _ = bank_correlate_abs(norm_s[0], s, g.corr)
        corr_diff.append(float((cb[0] - c0).abs().max() / c0.max()))
        del cb, c0
    diffs = {"lufs_max_abs": float((lufs_b - lufs_s).abs().max()),
             "normalised_section_max_abs": float((norm_b - norm_s).abs().max()),
             "correlation_row0_max_abs_over_max": corr_diff}
    if diffs["lufs_max_abs"] > 1e-4 or diffs["normalised_section_max_abs"] > 1e-5 or max(
            corr_diff) > 1e-5:
        raise AssertionError(f"the schedules' f32 intermediates differ past tolerance: {diffs}")
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


def phase_general_plateau(dev, smi: str, num_normal: int = 32, num_marker: int = 32,
                          profile: "Path | None" = None) -> dict[str, int]:
    """Phase 3c: the general-plateau tier (``height_min = 0``) as a captured
    step, on the flagship round (16 sections of 60 s, seeds 1-16) in both
    batch modes. Its lane greedy's while loops and its two-tier verify's
    cond are CUDA conditional nodes of the graph (``csrc/graph_conditional.cu``);
    the eager step (the same bank with ``capture`` off) drives the same
    bodies from the host, syncing once per greedy and per fixed-point
    round. In turns (eager, captured, captured, eager; twice in vmap),
    after an eager reference run and the key's first use: the host ms
    until ``dispatch_chunks_batch`` returns and until the payload is on
    the host, and the device span of the dispatch (CUDA
    events around it: the device's work, or its wait for the host); every
    payload bitwise the eager reference's. Also the key's capture seconds,
    the memory its first use peaked at and what the graph pools keep with
    the cache emptied (the graph's and the bodies' apart), the eager
    round's peak allocated and reserved, the kernel launches of one
    captured round (one per group per replay: the kernels line's count,
    from 0), the profiled device-busy ms of a captured and an eager vmap
    round (a scan round's trace would hold about a million while-node
    kernels), and the lean tier's captured round, timed first. Nothing is
    collected: at a threshold of 0 every row of noise is flagged, and
    resolving them is the host path's time, not the tier's. Returns the
    launches by mode."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    tables = Path(tempfile.mkdtemp()) if profile is None else profile
    sr, chunk = 8000, 60 * 8000
    chunks = [(0.05 * np.random.default_rng(1 + i).standard_normal(chunk)).astype(np.float32)
              for i in range(ROUND_ROWS)]
    gen = make_detector(num_normal, num_marker, 60, dev, sr, height_min=0.0)._ensure_bank()
    groups = sum(len(c["groups"]) for c in gen.classes.values())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()

    def dispatch(bank, mode: str) -> tuple[list, float, float, float]:
        """(payloads, ms until the dispatch returns, ms until the payloads
        are on the host, device ms between events around the dispatch)."""
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

    def equal(a: list, b: list) -> bool:
        return len(a) == len(b) and all(
            x.shape == y.shape and np.array_equal(x.view(np.int32), y.view(np.int32))
            for x, y in zip(a, b))

    def pools_gb(backend) -> "dict[str, float] | None":
        """GB reserved in the backend's graph pool and its bodies' pool, from
        the allocator's segments (None where they carry no pool id)."""
        segments = torch.cuda.memory_snapshot()
        if not segments or "segment_pool_id" not in segments[0]:
            return None
        by_pool: dict = {}
        for seg in segments:
            key = tuple(seg["segment_pool_id"])
            by_pool[key] = by_pool.get(key, 0) + seg["total_size"]
        return {name: sum(by_pool.get(tuple(pool), 0) for pool, _ in held.values()) / 1e9
                for name, held in (("graph", backend._devices), ("bodies", backend._bodies))}

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
        for name in turns:
            gen.capture = name == "captured"
            candidate_scan.launches = 0
            got, *t = dispatch(gen, mode)
            if name == "captured":
                launches[mode] = candidate_scan.launches
                if launches[mode] != groups * (ROUND_ROWS // rows):
                    raise AssertionError(f"general tier, {mode}: {launches[mode]} kernel launches "
                                         f"in a captured round, want one per group per replay")
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

    bank = make_bank(num_normal, num_marker, chunk_seconds=60, device=dev)
    groups = bank.classes[1]["groups"]
    want_route = {"row": 0, "class": 1, "escalated": 2, "clear": None}
    candidate_scan.launches = 0
    sections = rerun_sections(bank)
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

    normal = next(gi for gi, g in enumerate(groups) if g.kind == "normal")
    marker = next(gi for gi, g in enumerate(groups) if g.kind == "marker")
    row_vs_class = {}
    for name, gi in (("row", normal), ("escalated", marker)):
        row = bank._full_tier_row(1, gi, 0, sections[name])
        whole = bank._full_tier_packed(1, sections[name])[gi][0]
        row_vs_class[groups[gi].names[0]] = bool(np.array_equal(row.view(np.int32),
                                                                whole.view(np.int32)))
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
          lean_kernel_launches=lean_launches, host_path_rows=bank.host_path_rows)
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
    ("no_overlap_save", {"APD_NO_OVERLAP_SAVE": "1"}),
    ("packed_upload_0", {"APD_PACKED_UPLOAD": "0"}),
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
    from audio_pattern_detector_tpu_torch.ops import verify
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.correlate import bank_correlate
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
                payload = round_payload(bank)
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
                       "upload_dtype": str(bank._section_rows(10, [chunks[0][:10]]).dtype),
                       "ms_per_round": float(np.median(ms[1:])), "session_wall_s": session_wall,
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
    consts = [g.corr for g in cls["groups"]]
    with switches({"APD_NO_OVERLAP_SAVE": "1"}):
        whole = make_detector(num_normal, num_marker, 60, dev)._ensure_bank().classes[1]
    lufs_os = integrated_loudness_device(sections, lens, cls["loud"])
    lufs_whole = integrated_loudness_device(sections, lens, whole["loud"])
    whole_err = max(
        float((bank_correlate(norm, lens, gw.corr)[0] - bank_correlate(norm, lens, c)[0]).abs().max())
        for gw, c in zip(whole["groups"], consts))
    del whole
    m = 2000  # the marker clips' length; windows of the round, Hann-weighted
    x = norm[:, : norm.shape[1] // m * m].reshape(-1, m) * torch.hann_window(
        m, periodic=False, device=dev)
    exact = torch.from_numpy(np.abs(np.fft.rfft(x.cpu().double().numpy(), axis=-1)) ** 2)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gemm = verify._rfft_power_gemm(x, m).cpu().double()
        precision_kept = torch.backends.cuda.matmul.allow_tf32
        mat = verify._dft_matrix(m, x.device)
        proj = (x @ mat).cpu().double()  # the same product with TF32 allowed, unguarded
        tf32 = proj[:, : m // 2 + 1] ** 2 + proj[:, m // 2 + 1 :] ** 2
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    scale = float(exact.max())
    gemm_err = float((gemm - exact).abs().max()) / scale
    tf32_err = float((tf32 - exact).abs().max()) / scale
    lufs_err = float((lufs_os - lufs_whole).abs().max())
    if whole_err > 1e-5 or lufs_err > 1e-4 or gemm_err > GEMM_RTOL or not precision_kept:
        raise AssertionError(f"variant intermediates: no-overlap-save {whole_err} / {lufs_err} "
                             f"LU, GEMM {gemm_err} (TF32 kept {precision_kept})")
    phase("variants", card=smi, clips=num_normal + num_marker, round_rows=ROUND_ROWS, round="16 int16 chunks of 60 s",
          session="phase 9's streams, tile 16, vmap, 2 in flight",
          equal_to_default=True, default_ms_per_round=base["ms_per_round"],
          default_session_wall_s=base["session_wall_s"], default_launches=base["launches"],
          default_routes_row_class_escalated_host=base["routes"],
          variants={name: {"ms_per_round": r["ms_per_round"], "session_wall_s": r["session_wall_s"],
                           "kernel_launches": r["launches"], "kernel_tier": r["kernel_tier"],
                           "upload_dtype": r["upload_dtype"], "routes": r["routes"],
                           "near_flags_hidden": r["near_flags_hidden"]}
                    for name, r in results.items()},
          mask_tier_kernel_launches="0: APD_PALLAS=0 runs no kernel, by the caller's choice",
          no_overlap_save_corr_max_abs_err=whole_err,
          no_overlap_save_lufs_max_abs_err=lufs_err, gemm_with_tf32_allowed_rel_err=gemm_err,
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
    CUDA conditional node; ``APD_SKIP_EMPTY_VERIFY``), and the pinned
    staging pool. Two flagship detectors, one built with the switch unset
    (the node) and one with ``APD_SKIP_EMPTY_VERIFY=0`` (no node), and the
    first's eager step. Payloads bit for bit between all three on the
    flagship step's candidate-free section, phase 7's sections and a
    section with hits in both groups (single-section graphs), a 16-row
    round with no candidates and one with a single hit-bearing row (both
    modes), and a bank-sharded chunk on 2 logical shards; detections,
    routes and stream times on phase 9's session in both modes; accepted
    hits in both groups of one section, so both bodies ran there. Under
    torch.profiler a candidate-free replay holds none of the kernels only
    the verifiers launch; the phase reports how many of them the trace of a
    replay with hits in both groups records. Timed in turns (node,
    none, none, node, twice): the flagship step, both rounds, the session;
    profiled device-busy ms of each. The pool: pinned host allocations in
    a first and in a steady 16-row serving round (cudaHostAlloc). A node
    that cannot be captured raises: nothing falls back."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, make_detector
    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.models.bank import _split_fused
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh

    tables = Path(tempfile.mkdtemp()) if profile is None else profile
    det = {"node": make_detector(num_normal, num_marker, chunk_seconds=60, device=dev)}
    banks = {"node": det["node"]._ensure_bank()}
    with switches({"APD_SKIP_EMPTY_VERIFY": "0"}):
        det["none"] = make_detector(num_normal, num_marker, chunk_seconds=60, device=dev)
        banks["none"] = det["none"]._ensure_bank()
    if not banks["node"].skip_empty_verify or banks["none"].skip_empty_verify:
        raise AssertionError("APD_SKIP_EMPTY_VERIFY was not read at the bank's construction")
    bank = banks["node"]
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

    def three_ways(run) -> dict:
        """``run(bank)`` on the node's graph, the graph without it and the
        eager step: payloads bit for bit."""
        got = {}
        for name in ("node", "none"):
            banks[name].capture = True
            got[name] = [run(banks[name]) for _ in range(2)]  # first use, then a replay
        bank.capture = False
        got["eager"] = [run(bank)]
        bank.capture = True
        want = got["eager"][0]
        for name in ("node", "none"):
            if not all(payloads_equal(p, want) for p in got[name]):
                raise AssertionError(f"{name}: payload differs from the eager step's")
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
        payload = three_ways(lambda b, sec=sec: b.step(sw, sec, s_len))
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
            payload = three_ways(lambda b, m=mode, r=round_of(rows_): r(b, m))
            out["rounds_live_groups"][f"{rname}_{mode}"] = live_groups(payload)
    if any(out["rounds_live_groups"]["candidate_free_vmap"]) or not all(
            out["rounds_live_groups"]["one_hit_row_vmap"]):
        raise AssertionError(f"live groups per round: {out['rounds_live_groups']}")

    # A bank-sharded chunk (phase 7's flooded row, with its lookback).
    _audios, rounds, _ = serving_streams(det["node"], sr)
    chunk, prev = rounds[1][3], rounds[0][3]
    shard_payloads, shard_results = {}, {}
    for name, capture in (("node", True), ("none", True), ("eager", False)):
        b = banks["none" if name == "none" else "node"]
        b.capture = capture
        sharded = BankShardedBank(b, make_mesh({"bank": 2}, devices=[dev] * 2))
        recs = sharded.dispatch_chunk(chunk, prev)
        shard_payloads[name] = [rec[1].numpy().copy() for rec in recs]
        shard_results[name] = sharded.collect_chunk(recs)
    bank.capture = True
    for name in ("node", "none"):
        if shard_results[name] != shard_results["eager"] or not all(
                np.array_equal(a.view(np.int32), e.view(np.int32))
                for a, e in zip(shard_payloads[name], shard_payloads["eager"])):
            raise AssertionError(f"bank shards, {name}: payload differs from the eager step's")
    out["bank_shards_2"] = {"payload_equal": True}

    # ── Phase 9's session on both banks, both modes ──
    def session_run(name: str, mode: str) -> dict:
        session = MultiStreamSession(det[name], 16, tile=16, batch_mode=mode)
        before = routes(banks[name])
        torch.cuda.synchronize()
        t = time.perf_counter()
        acc, _ = drive_session(session, rounds, in_flight=2)
        torch.cuda.synchronize()
        return {"acc": acc, "totals": [session.total_time(i) for i in range(16)],
                "routes": tuple(a - b for a, b in zip(routes(banks[name]), before)),
                "wall_s": time.perf_counter() - t}

    out["session"] = {}
    for mode in ("scan", "vmap"):
        runs = {name: session_run(name, mode) for name in ("node", "none")}
        a, b = runs["node"], runs["none"]
        if (a["acc"], a["totals"], a["routes"]) != (b["acc"], b["totals"], b["routes"]):
            raise AssertionError(f"session {mode}: the node's run differs from the run without")
        out["session"][mode] = {
            "detections": sum(len(v) for x in a["acc"][:12] for v in x.values()),
            "routes_row_class_escalated_host": a["routes"]}

    # ── The node in the trace: no verifier kernel in a candidate-free replay ──
    def replay(name: str, sec):
        banks[name].step(sw, sec, s_len)
        return lambda: banks[name].step(sw, sec, s_len)

    seen = {(name, sec): kernel_names(replay(name, sections[sec]))
            for name in ("node", "none") for sec in ("flagship", "both")}
    # Kernels of the graph without the node that a candidate-free replay
    # with the node does not run: the verifiers' own, a name each. The
    # profiler does not record every kernel of an if-node's body in every
    # process (PERF.md, PR 9): the bodies' running is held by the payload
    # above, and the replay with hits is traced up to 3 times and the most
    # complete trace kept.
    verifier_only = set(seen["none", "flagship"]) - set(seen["node", "flagship"])
    if not verifier_only:
        raise AssertionError("the trace does not show the skip: a candidate-free replay with "
                             "the node runs every kernel the graph without it runs")

    def verifier_kernels(counts) -> int:
        return sum(counts[k] for k in verifier_only)

    for _ in range(2):
        if verifier_kernels(seen["node", "both"]) >= verifier_kernels(seen["none", "both"]):
            break
        again = kernel_names(replay("node", sections["both"]))
        if verifier_kernels(again) > verifier_kernels(seen["node", "both"]):
            seen["node", "both"] = again
    out["trace"] = {
        "kernels_a_replay_candidate_free": {n: sum(seen[n, "flagship"].values())
                                            for n in ("node", "none")},
        "kernels_a_replay_hits_in_both_groups": {n: sum(seen[n, "both"].values())
                                                 for n in ("node", "none")},
        "verifier_only_kernel_names": len(verifier_only),
        "verifier_only_kernels_a_replay_hits_in_both_groups": {
            n: verifier_kernels(seen[n, "both"]) for n in ("node", "none")},
        "verifier_only_examples": sorted(k[:90] for k in verifier_only)[:6],
        "node_handle_kernels_a_replay": sum(v for k, v in seen["node", "both"].items()
                                            if "set_if_handle" in k)}

    # ── Timed in turns, and profiled ──
    def in_turns_node(run, n: int = 2) -> dict:
        times: dict[str, list[float]] = {"node": [], "none": []}
        for name in ("node", "none", "none", "node") * n:
            times[name].append(run(name))
        return {k: median_and_range(v) for k, v in times.items()}

    def ms_of(fn, reps: int):
        def run(name: str) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn(name)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / reps * 1e3
        return run

    paths = {
        "flagship_step": (lambda name: banks[name].step(sw, flagship, s_len, fused=False), 5),
        "round_vmap_candidate_free": (lambda name: round_of(rows)(banks[name], "vmap"), 3),
        "round_scan_candidate_free": (lambda name: round_of(rows)(banks[name], "scan"), 1),
        "round_scan_one_hit_row": (lambda name: round_of(mixed)(banks[name], "scan"), 1),
    }
    out["ms_median_min_max"] = {}
    out["profiled_device_busy_ms"] = {}
    for pname, (fn, reps) in paths.items():
        for name in ("node", "none"):
            fn(name)
        out["ms_median_min_max"][pname] = in_turns_node(ms_of(fn, reps))
        out["profiled_device_busy_ms"][pname] = {
            name: profile_run(lambda: fn(name), tables / f"skip_{pname}_{name}.txt")[
                "device_busy_ms"] for name in ("node", "none")}
    for mode in ("scan", "vmap"):
        out["session"][mode]["wall_s_median_min_max"] = in_turns_node(
            lambda name, mode=mode: session_run(name, mode)["wall_s"])
        out["session"][mode]["profiled_device_busy_ms"] = {
            name: profile_run(lambda: session_run(name, mode),
                              tables / f"skip_session_{mode}_{name}.txt")["device_busy_ms"]
            for name in ("node", "none")}

    # ── The staging pool: pinned allocations in a first and a steady round ──
    steady = [[(0.004 * rng.standard_normal(60 * sr)).astype(np.float32) for _ in range(16)]
              for _ in range(3)]
    session = MultiStreamSession(det["node"], 16, tile=16, batch_mode="vmap")
    bank._staging.clear()
    out["pinned_host_allocs_a_round"] = {
        "first": host_allocs(lambda: session.feed(steady[0])),
        "steady": [host_allocs(lambda c=c: session.feed(c)) for c in steady[1:]]}
    if any(out["pinned_host_allocs_a_round"]["steady"]):
        raise AssertionError(f"a steady round allocated pinned memory: "
                             f"{out['pinned_host_allocs_a_round']}")
    out["staging_pool"] = {f"{dt} {b}x{s}": len(v) for (dt, b, s), v in bank._staging.items()}
    phase("skip_empty_verify_and_staging", card=smi, clips=num_normal + num_marker,
          payloads_equal_node_none_eager=True, **out)
    del det, banks, bank, session
    torch.cuda.empty_cache()


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

    from audio_pattern_detector_tpu_torch.match import _auto_perf_plan, _load_pattern_clips
    from audio_pattern_detector_tpu_torch import cli
    from audio_pattern_detector_tpu_torch.flagship import flagship_round, flagship_step
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

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
        if "registers" in line or "spill" in line:
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
    general_launches = phase_general_plateau(dev, smi, profile=args.profile)

    # ── 4-5. The main path: flag-free file mode through the CLI ──
    built = []
    build_detector = cli.TorchEngineOptions.build_detector

    def recording_build(self, clips):
        det = build_detector(self, clips)
        built.append(det)
        return det

    cli.TorchEngineOptions.build_detector = recording_build
    candidate_scan.launches = 0

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
        host_rows = sum(d._bank.host_path_rows for d in built if d._bank is not None)
        phase("kernel_use", candidate_scan_launches=main_path_launches,
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
            args.profile.mkdir(parents=True, exist_ok=True)
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
    # over the processes) and the class-step switches that keep the kernel
    # tier (phase 13; the mask tier launches none). ``ms``, ``plain_ms``
    # and ``bound_ms`` are phase 2's at (32, 495,999); the batched shape's
    # stand beside them. No single PyTorch call computes the scan's five
    # outputs, so no library time.
    launches = {"file_mode": main_path_launches, "flagship_round_vmap": round_launches,
                "general_plateau_vmap": general_launches["vmap"],
                "general_plateau_scan": general_launches["scan"],
                "serving_scan": serving_launches["scan"], "serving_vmap": serving_launches["vmap"],
                "serving_stream_mesh": serving_launches["mesh"], **mesh_launches,
                **multi_process_launches, "variants": variant_launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a path of the run launched no kernel: {launches}")
    print(json.dumps({"kernels": [{
        "name": "candidate_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(launches.values()),
        "max_abs_err": max(r[2] for r in kernel_rows + batched_rows + round_kernel_rows),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None, "launches_by_path": launches,
        "batched_shape": [bg, bl], "batched_ms": bms, "batched_plain_ms": bplain_ms,
        "batched_bound_ms": bbound_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
