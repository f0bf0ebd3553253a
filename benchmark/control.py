#!/usr/bin/env python3
"""The control of the correctness check: the plain reference computed in
bfloat16, the nearest precision below the float32 the configurations
state, put in the program's place and judged by the same comparison.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--rounds R]

prints one JSON line a seed with each compared number and whether the
control came out correct (it must not). It needs no card: it makes the
cell's traffic from the seed at the cell's own size, draws the sample a run
would draw (over every chunk of the recordings, or ``--rounds`` rounds of
the stations), and runs both precisions of the reference on it. Benchmark
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR)]

import numpy as np  # noqa: E402

from harness import check  # noqa: E402
from harness.cell import Cell, load_cell, reference_clips  # noqa: E402
from harness.reference import ReferenceDetector  # noqa: E402
from harness.traffic import generate  # noqa: E402


def control_readings(cell: Cell, seed: int, rounds: int = 600) -> dict:
    """The compared numbers of the bfloat16 reference judged against the
    reference, on the sample a run of ``cell`` with ``seed`` would check."""
    config = cell.config
    sr, chunk_s = int(config["sample_rate"]), int(config["chunk_seconds"])
    clips = reference_clips(config, seed)
    traffic = generate(cell.traffic, seed, sr, chunk_s, clips, cell.data_dir)
    rng = np.random.default_rng(np.random.SeedSequence([seed, check.SAMPLE_SEED_TAG]))
    ref = ReferenceDetector(clips, sr, chunk_s)
    low = ReferenceDetector(clips, sr, chunk_s, precision="bf16")
    driver = cell.driver
    sample = check.draw(rng, traffic, driver.population(traffic, driver.served_whole(traffic, rounds)))
    pairs = [(ref.detect(*driver.inputs(traffic, item)), low.detect(*driver.inputs(traffic, item)), None)
             for item in sample]
    correct, checks = check.judge(pairs)
    return {"seed": seed, "correct": correct, **{k: v["value"] for k, v in checks.items()}}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rounds", type=int, default=600)
    args = p.parse_args()
    cell = load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, **control_readings(cell, seed, args.rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
