#!/usr/bin/env python3
"""Device memory of the general-plateau tier's vmap round, by width, on the card.

    python3 scripts/probe_general_memory.py [--rows 16 24 32] [--attribute 16]
                                            [--checkout DIR ...]

For each checkout (default: this one) and each width B, one subprocess,
run from the checkout's own directory, builds the flagship detector (64
clips, 60 s chunks) at ``height_min = 0`` and dispatches one vmap round of
B seeded 60 s chunks (numpy seeds 1..B, as chip_smoke phase 3c): first
eager (``capture`` off), then captured (the key's first use). It prints one
JSON line: the eager round's peak allocated and reserved GB, the GB that
the captured key's graph pool and bodies' pool keep with the cache
emptied (from the allocator's segments), the capture seconds, and whether
the captured payload is bitwise the eager one. A width that runs out of
device memory reports where (``oom``: "eager" or "captured") instead.

With ``--attribute B``, the width-B run also records the allocator's
history during the captured first use and sums the segments it created in
each pool by the line of the port that asked for them (the innermost
frame in ``audio_pattern_detector_tpu_torch``): the ten largest sites of
the graph's pool (the capture stream) and of the bodies' pool (the side
stream).

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r'''
import json, sys, time
from collections import defaultdict
import numpy as np
import torch
from audio_pattern_detector_tpu_torch.flagship import make_detector

rows, attribute = int(sys.argv[1]), sys.argv[2] == "1"
dev = torch.device("cuda")
sr, chunk = 8000, 60 * 8000
chunks = [(0.05 * np.random.default_rng(1 + i).standard_normal(chunk)).astype(np.float32)
          for i in range(rows)]
bank = make_detector(32, 32, 60, dev, sr, height_min=0.0)._ensure_bank()
torch.cuda.synchronize()
resident = torch.cuda.memory_allocated()
out = {"rows": rows, "resident_gb": resident / 1e9}


def run():
    payloads = [rec[1].numpy().copy() for rec in bank.dispatch_chunks_batch(chunks, None, "vmap")]
    torch.cuda.synchronize()
    return payloads


def pools(backend):
    by_pool = defaultdict(int)
    for seg in torch.cuda.memory_snapshot():
        by_pool[tuple(seg["segment_pool_id"])] += seg["total_size"]
    return {name: sum(by_pool[tuple(pool)] for pool, _ in held.values()) / 1e9
            for name, held in (("graph", backend._devices), ("bodies", backend._bodies))}


def sites(snapshot, streams):
    """GB of segments created on each stream, by the port's line."""
    per = {name: defaultdict(int) for name in streams}
    for entry in snapshot["device_traces"][dev.index or 0]:
        if entry["action"] != "segment_alloc":
            continue
        name = next((n for n, s in streams.items() if s == entry["stream"]), None)
        if name is None:
            continue
        frame = next((f for f in entry.get("frames", [])
                      if "audio_pattern_detector_tpu_torch" in f["filename"]), None)
        where = ("%s:%d %s" % (f["filename"].split("audio_pattern_detector_tpu_torch/")[-1],
                               f["line"], f["name"]) if (f := frame) else "?")
        per[name][where] += entry["size"]
    return {name: [[w, round(b / 1e9, 3)] for w, b in sorted(d.items(), key=lambda x: -x[1])[:10]]
            for name, d in per.items()}


try:
    bank.capture = False
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    eager = run()
    out["eager_peak_allocated_gb"] = (torch.cuda.max_memory_allocated() - resident) / 1e9
    out["eager_peak_reserved_gb"] = (torch.cuda.max_memory_reserved() - reserved) / 1e9
except torch.cuda.OutOfMemoryError:
    out["oom"] = "eager"
    print(json.dumps(out), flush=True)
    sys.exit(0)
bank.capture = True
torch.cuda.empty_cache()
try:
    if attribute:
        torch.cuda.memory._record_memory_history(stacks="python", max_entries=1_000_000)
    t = time.perf_counter()
    first = run()
    out["first_use_s"] = time.perf_counter() - t
    if attribute:
        snapshot = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
    torch.cuda.empty_cache()
    backend = bank.graphs._backend
    out["pools_gb"] = pools(backend)
    (step,) = bank.graphs.steps()
    out["capture_s"] = step.capture_seconds
    out["captured_bitwise_eager"] = all(
        a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
        for a, b in zip(first, eager))
    again = run()
    out["replay_bitwise_eager"] = all(
        np.array_equal(a.view(np.int32), b.view(np.int32)) for a, b in zip(again, eager))
    if attribute:
        (_, capture_stream), = backend._devices.values()
        (_, side_stream), = backend._bodies.values()
        streams = {"graph": capture_stream.cuda_stream, "bodies": side_stream.cuda_stream}
        out["segments_by_site_gb"] = sites(snapshot, streams)
except (torch.cuda.OutOfMemoryError, RuntimeError) as err:
    if "out of memory" not in str(err):
        raise
    out["oom"] = "captured"
print(json.dumps(out), flush=True)
'''


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[16, 24, 32])
    parser.add_argument("--attribute", type=int, default=None,
                        help="record the allocator's history at this width")
    parser.add_argument("--checkout", action="append", default=None,
                        help="a checkout of the repo to probe (repeatable; default: this one)")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: no card", flush=True)
    failed = 0
    for checkout in args.checkout or [str(ROOT)]:
        for rows in args.rows:
            proc = subprocess.run(
                [sys.executable, "-c", PROBE, str(rows), "1" if rows == args.attribute else "0"],
                cwd=checkout, capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            if proc.returncode or not lines:
                failed += 1
                print(json.dumps({"checkout": checkout, "rows": rows, "rc": proc.returncode,
                                  "stderr": proc.stderr[-2000:]}), flush=True)
                continue
            print(json.dumps({"checkout": checkout, **json.loads(lines[-1])}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
