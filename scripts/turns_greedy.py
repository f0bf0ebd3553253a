#!/usr/bin/env python3
"""Time the two greedy kernels in two checkouts, in turns, on one CUDA card.

    python3 scripts/turns_greedy.py PARENT_DIR [CHANGE_DIR] [--turns 1]

CHANGE_DIR defaults to this checkout. Each turn runs one subprocess per
checkout in the order parent, change, change, parent (``--turns`` repeats
that sequence), each from its own directory so it builds and loads its own
kernels and imports its own ``chip_smoke``. The inputs are the same on both
sides (seeded; the lane greedy's worst cases come from CHANGE_DIR's
``chip_smoke.lane_worst_case``). A subprocess times, after each path's
first use (eager, then the capture) and a replay:

* the lean greedy (``csrc/lean_greedy.cu``) on its own launches of chip_smoke
  phase 20's inputs (recorded from eager steps of the flagship bank: the
  flagship step with hits in both groups and the 16-row vmap round whose
  row 5 is hit-bearing, a launch a group), each the device ms of one call
  in a graph of 20 (``chip_smoke.graph_ms``), 3 times;
* the lane greedy (``csrc/lane_greedy.cu``) on its own launches of the
  general-plateau tier (``height_min = 0``: the flagship step with hits and
  the hit-bearing 16-row vmap round, a launch a group), at K = 1,024 /
  4,728 / 16,384 lanes of 32 rows, and on its worst cases (32 rows of 4,728
  lanes), the same way;
* the captured lean 16-row vmap rounds, candidate-free and hit-bearing
  (CUDA events around 3 rounds, 4 times), and the flagship step, both kinds
  (around 5 steps, 4 times);
* the captured general-plateau 16-row round of noise (phase 3c's) to the
  payload on the host, in vmap (3 times) and in scan (2 times);
* the escalated marker row (phase 7's ``_full_tier_row`` of the 900 Hz
  section with 18 weak hits, uncapped): CUDA events around 3 calls, 3 times.

Prints the card's name and power limit, one JSON line per subprocess and a
summary line with each checkout's medians and ranges over its runs.
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
import importlib.util, json, os, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, make_bank, make_detector
from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy
from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy

spec = importlib.util.spec_from_file_location("change_smoke", os.environ["CHANGE_SMOKE"])
change_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(change_smoke)

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


def kernel_ms(name, wrapper, args):
    out[f"{name}_ms"] = [cs.graph_ms(lambda: wrapper(*args)) for _ in range(3)]


def sections(bank):
    sw, sr = 1, bank.sample_rate
    s_len = bank.classes[sw]["section_len"]
    groups = bank.classes[sw]["groups"]
    rng = np.random.default_rng(1)
    flagship = torch.from_numpy((0.05 * rng.standard_normal(s_len)).astype(np.float32)).to(dev)
    both = cs.rerun_sections(bank)["clear"].copy()
    both[20 * sr: 21 * sr] += next(g for g in groups if g.kind == "normal").clips_np[0]
    both = torch.from_numpy(both).to(dev)
    rows = torch.stack([torch.from_numpy((0.05 * np.random.default_rng(1 + i)
                                          .standard_normal(s_len)).astype(np.float32))
                        for i in range(ROUND_ROWS)]).to(dev)
    mixed = rows.clone()
    mixed[ROUND_ROWS // 3] = both
    lens = torch.full((ROUND_ROWS,), s_len, dtype=torch.int32, device=dev)
    return s_len, flagship, both, rows, mixed, lens


def recorded(bank, runs, kernel):
    """The greedy kernel's inputs of eager steps of ``bank``, by run name."""
    bank.capture = False
    got = {}
    for name, fn in runs.items():
        with cs.recorded_greedy_inputs() as seen:
            fn()
            torch.cuda.synchronize()
        got[name] = seen[kernel]
    bank.capture = True
    return got


sw = 1
bank = make_detector(32, 32, 60, dev)._ensure_bank()
s_len, flagship, both, rows, mixed, lens = sections(bank)
for name, args_list in recorded(bank, {"step_hits": lambda: bank.step(sw, both, s_len),
                                       "round_one_hit_row": lambda: bank.step(sw, mixed, lens)},
                                "lean_greedy").items():
    for gi, args in enumerate(args_list):
        kernel_ms(f"lean_{name}_group_{gi}", lean_greedy, args)
paths = {
    "flagship_step_candidate_free": (lambda: bank.step(sw, flagship, s_len), 5),
    "flagship_step_hits_in_both_groups": (lambda: bank.step(sw, both, s_len), 5),
    "round_vmap_candidate_free": (lambda: bank.step(sw, rows, lens), 3),
    "round_vmap_one_hit_row": (lambda: bank.step(sw, mixed, lens), 3),
}
for name, (fn, reps) in paths.items():
    fn(); fn()
    out[name] = [events_ms(fn, reps) for _ in range(4)]
del bank
torch.cuda.empty_cache()

gen = make_detector(32, 32, 60, dev, height_min=0.0)._ensure_bank()
for name, args_list in recorded(gen, {"step_hits": lambda: gen.step(sw, both, s_len),
                                      "round_one_hit_row": lambda: gen.step(sw, mixed, lens)},
                                "lane_greedy").items():
    for gi, args in enumerate(args_list):
        out[f"lane_{name}_group_{gi}_shape"] = list(args[0].shape)
        kernel_ms(f"lane_{name}_group_{gi}", lane_greedy, args)
for k in cs.LANE_GREEDY_KS:
    n_alive = [k if r % 2 == 0 else k // 3 for r in range(32)]
    pos, alive = cs.lane_greedy_input(32, k, n_alive, 495_999, 2000, seed=k)
    kernel_ms(f"lane_k_{k}", lane_greedy,
              (torch.from_numpy(pos).to(dev), torch.from_numpy(alive).to(dev), 2000))
for name in change_smoke.LANE_WORST_CASES:
    pos, alive, m = change_smoke.lane_worst_case(name, 32, 4728)
    kernel_ms(f"lane_worst_{name}", lane_greedy,
              (torch.from_numpy(pos).to(dev), torch.from_numpy(alive).to(dev), m))
chunks = cs.noise_chunks(ROUND_ROWS)
for mode, reps in (("vmap", 3), ("scan", 2)):
    cs.timed_dispatch(gen, chunks, mode)  # the key's first use
    out[f"general_round_{mode}_ms"] = [cs.timed_dispatch(gen, chunks, mode)[2]
                                       for _ in range(reps)]
del gen
torch.cuda.empty_cache()

rb = make_bank(32, 32, chunk_seconds=60, device=dev)
marker = next(gi for gi, g in enumerate(rb.classes[1]["groups"]) if g.kind == "marker")
escalated = cs.rerun_sections(rb)["escalated"]
row = lambda: rb._full_tier_row(1, marker, 0, escalated, capped=False)
row()
out["escalated_marker_row_ms"] = [events_ms(row, 3) for _ in range(3)]
print("TIMING " + json.dumps(out), flush=True)
'''


def run_one(checkout: Path, change: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(checkout),
           "CHANGE_SMOKE": str(change / "chip_smoke.py")}
    proc = subprocess.run([sys.executable, "-c", TIMING], cwd=checkout, capture_output=True,
                          text=True, env=env)
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
    change = args.change.resolve()
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for _ in range(args.turns):
        for name in ("parent", "change", "change", "parent"):
            res = run_one((args.parent if name == "parent" else change).resolve(), change)
            runs[name].append(res)
            print(json.dumps({"checkout": name, **res}), flush=True)
    summary = {}
    for name, results in runs.items():
        keys = [k for k, v in results[0].items()
                if isinstance(v, list) and not k.endswith("_shape")]
        summary[name] = {k: float(np.median([x for r in results for x in r[k]])) for k in keys}
        summary[name].update({f"{k}_min_max": [min(x for r in results for x in r[k]),
                                               max(x for r in results for x in r[k])]
                              for k in keys})
    print(json.dumps({"card": smi, "medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
