#!/usr/bin/env python3
"""Time the verify tail in two checkouts, in turns, on one CUDA card.

    python3 scripts/turns_verify_tail.py PARENT_DIR [CHANGE_DIR] [--turns 1]

CHANGE_DIR defaults to this checkout. Each turn runs one subprocess per
checkout in the order parent, change, change, parent (``--turns`` repeats
that sequence), each from its own directory so it builds and loads its own
kernels and imports its own ``chip_smoke``. A subprocess builds the
flagship bank (32 normal and 32 marker clips, 60 s sections) and times,
after each path's first use (eager, then the capture) and a replay:

* chip_smoke phase 18's four captured paths: the flagship step with no
  candidate and with hits in both groups, a 16-row vmap round with no
  candidate and one whose row 5 is the hit-bearing section; device ms a
  call from CUDA events around 5 calls (3 for a round), 4 times;
* the verifiers' own calls of that hit-bearing round (recorded from its
  eager step): the marker verifier whole (the parent's spectra and
  decisions kernel, or the change's fused kernel) and the normal
  verifier, each the device ms of one call in a graph of 20
  (``chip_smoke.graph_ms``), 3 times;
* the general-plateau tier (``height_min = 0``): its captured 16-row vmap
  round with the hit-bearing row (CUDA events around 3 rounds, 4 times),
  and each kind of group's whole verify of that round's eager step (each
  ``_verify_accept`` call of a marker, or a normal, group: both tiers of
  its two-tier verify, every block; CUDA events around 3 replays of the
  calls, 3 times).

Prints the card's name and power limit, one JSON line per subprocess and a
summary line with each checkout's medians over its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

TIMING = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, make_detector
from audio_pattern_detector_tpu_torch.models import bank as bank_module

dev = torch.device("cuda")
out = {}


def events_ms(fn, reps):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


bank = make_detector(32, 32, 60, dev)._ensure_bank()
sw, sr = 1, bank.sample_rate
s_len = bank.classes[sw]["section_len"]
groups = bank.classes[sw]["groups"]
rng = np.random.default_rng(1)
flagship = torch.from_numpy((0.05 * rng.standard_normal(s_len)).astype(np.float32)).to(dev)
both = cs.rerun_sections(bank)["clear"].copy()
both[20 * sr: 21 * sr] += next(g for g in groups if g.kind == "normal").clips_np[0]
both = torch.from_numpy(both).to(dev)
rows = torch.stack([torch.from_numpy((0.05 * np.random.default_rng(1 + i).standard_normal(s_len))
                                     .astype(np.float32)) for i in range(ROUND_ROWS)]).to(dev)
mixed = rows.clone()
mixed[ROUND_ROWS // 3] = both
lens = torch.full((ROUND_ROWS,), s_len, dtype=torch.int32, device=dev)
paths = {
    "flagship_step_candidate_free": (lambda: bank.step(sw, flagship, s_len), 5),
    "flagship_step_hits_in_both_groups": (lambda: bank.step(sw, both, s_len), 5),
    "round_vmap_candidate_free": (lambda: bank.step(sw, rows, lens), 3),
    "round_vmap_one_hit_row": (lambda: bank.step(sw, mixed, lens), 3),
}
for name, (fn, reps) in paths.items():
    fn(); fn()
    out[name] = [events_ms(fn, reps) for _ in range(4)]

bank.capture = False
with cs.recorded_verify_inputs() as seen:
    bank.step(sw, mixed, lens)
    torch.cuda.synchronize()
for kernel in ("verify_marker", "verify_normal"):
    args = seen[kernel][0]
    fn = getattr(bank_module, kernel)
    out[f"round_{kernel}_call_ms"] = [cs.graph_ms(lambda: fn(*args)) for _ in range(3)]
    out[f"round_{kernel}_live_lanes"] = int(args[2].sum())
del seen, bank
torch.cuda.empty_cache()

gen = make_detector(32, 32, 60, dev, height_min=0.0)._ensure_bank()
gfn = lambda: gen.step(sw, mixed, lens)
gfn(); gfn()
out["general_round_vmap_ms"] = [events_ms(gfn, 3) for _ in range(4)]
gen.capture = False
calls = []
verify_accept = bank_module._verify_accept


def recording(kind, *args, **kwargs):
    calls.append((kind, args, kwargs))
    return verify_accept(kind, *args, **kwargs)


bank_module._verify_accept = recording
try:
    gfn()
    torch.cuda.synchronize()
finally:
    bank_module._verify_accept = verify_accept
for kind in ("marker", "normal"):
    mine = [(a, kw) for k, a, kw in calls if k == kind]
    out[f"general_round_{kind}_verify_calls"] = len(mine)
    out[f"general_round_{kind}_live_lanes"] = sum(int(a[4].sum()) for a, _ in mine)  # valive
    run = lambda: [verify_accept(kind, *a, **kw) for a, kw in mine]
    run()
    out[f"general_round_{kind}_verify_ms"] = [events_ms(run, 3) for _ in range(3)]
print("TIMING " + json.dumps(out), flush=True)
'''


def run_one(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", TIMING], cwd=checkout, capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": str(checkout)})
    lines = [l for l in proc.stdout.splitlines() if l.startswith("TIMING ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("TIMING "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for _ in range(args.turns):
        for name in ("parent", "change", "change", "parent"):
            res = run_one((args.parent if name == "parent" else args.change).resolve())
            runs[name].append(res)
            print(json.dumps({"checkout": name, **res}), flush=True)
    summary = {}
    for name, results in runs.items():
        keys = [k for k, v in results[0].items() if isinstance(v, list)]
        summary[name] = {k: float(np.median([x for r in results for x in r[k]])) for k in keys}
        summary[name].update({f"{k}_min_max": [min(x for r in results for x in r[k]),
                                               max(x for r in results for x in r[k])]
                              for k in keys})
    print(json.dumps({"card": smi, "medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
