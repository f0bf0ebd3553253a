#!/usr/bin/env python3
"""Time the eager full tier in two checkouts, in turns, on one CUDA card.

    python3 scripts/turns_eager_full_tier.py PARENT_DIR [CHANGE_DIR] [--turns 1]

CHANGE_DIR defaults to this checkout. Each turn runs one subprocess per
checkout in the order parent, change, change, parent, each from its own
directory. A subprocess builds the flagship bank (64 clips, 60 s chunks)
and times, after a warm-up, the two eager forms of the full tier's host
loops (the lane greedy's while loops and the two-tier verify's cond):

* the escalated marker-row rerun of chip_smoke phase 7
  (``_full_tier_row(..., capped=False)`` on its "escalated" section: one
  marker row at 4,728 lanes, the sequential greedy): the median ms of 5
  CUDA-event pairs around 3 calls;
* the eager general-plateau vmap round (``height_min = 0``, ``capture``
  off, 16 seeded 60 s chunks as in chip_smoke phase 3c): the median of 3
  walls until the payload is on the host.

Each subprocess prints one JSON line with the payloads' digests, which must
agree across checkouts; a summary line gives each checkout's medians.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

TIMING = r'''
import hashlib, json, time
import numpy as np
import torch
from chip_smoke import cuda_ms, rerun_sections
from audio_pattern_detector_tpu_torch.flagship import make_bank, make_detector

dev = torch.device("cuda")
bank = make_bank(32, 32, 60, dev)
groups = bank.classes[1]["groups"]
marker = next(gi for gi, g in enumerate(groups) if g.kind == "marker")
section = rerun_sections(bank)["escalated"]
row = bank._full_tier_row(1, marker, 0, section, capped=False)
out = {"escalated_row_rerun_ms": cuda_ms(
    lambda: bank._full_tier_row(1, marker, 0, section, capped=False), runs=3),
    "escalated_row_digest": hashlib.sha1(np.asarray(row).tobytes()).hexdigest()}
del bank
torch.cuda.empty_cache()

chunks = [(0.05 * np.random.default_rng(1 + i).standard_normal(60 * 8000)).astype(np.float32)
          for i in range(16)]
gen = make_detector(32, 32, 60, dev, height_min=0.0)._ensure_bank()
gen.capture = False


def round_ms():
    torch.cuda.synchronize()
    t = time.perf_counter()
    payloads = [rec[1].numpy().copy() for rec in gen.dispatch_chunks_batch(chunks, None, "vmap")]
    return (time.perf_counter() - t) * 1e3, payloads


_, payloads = round_ms()
out["eager_general_vmap_round_ms"] = float(np.median([round_ms()[0] for _ in range(3)]))
out["eager_general_round_digest"] = hashlib.sha1(
    b"".join(p.tobytes() for p in payloads)).hexdigest()
print(json.dumps(out), flush=True)
'''


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent")
    parser.add_argument("change", nargs="?", default=str(ROOT))
    parser.add_argument("--turns", type=int, default=1)
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: no card", flush=True)
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for _ in range(args.turns):
        for name in ("parent", "change", "change", "parent"):
            proc = subprocess.run([sys.executable, "-c", TIMING], cwd=getattr(args, name),
                                  capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            if proc.returncode or not lines:
                print(json.dumps({"checkout": name, "rc": proc.returncode,
                                  "stderr": proc.stderr[-2000:]}), flush=True)
                return 1
            runs[name].append(json.loads(lines[-1]))
            print(json.dumps({"checkout": name, **runs[name][-1]}), flush=True)
    digests = {k for r in runs["parent"] + runs["change"] for k in r.items() if "digest" in k[0]}
    summary = {name: {key: float(np.median([r[key] for r in rs]))
                      for key in ("escalated_row_rerun_ms", "eager_general_vmap_round_ms")}
               for name, rs in runs.items()}
    summary["payloads_agree"] = len(digests) == 2
    print(json.dumps(summary), flush=True)
    return 0 if summary["payloads_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
