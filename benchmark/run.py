#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name: ``BENCHMARK.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, the driver that file names (``drivers/<driver>.py``)
and ``metrics/<metric>.py`` under this folder.
Set-up makes the bank and the traffic from the seed and warms every shape
the window uses; the window then drives the port for ``--seconds``; with
``--trace 1`` the per-layer metrics are read, the device ones from a traced
window of ``TRACE_SECONDS`` after it. Once the windows have closed and the
program's state is freed, a sample of what the window produced is compared
with the plain reference (``harness/reference.py``). The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.

Exits 2, printing no result, without as many CUDA devices as the cell asks
for, and 3 if JAX or the JAX package is loaded when the result would be
printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

from harness import check, trace  # noqa: E402
from harness.cell import Cell, load_cell, metric_reader, reference_clips  # noqa: E402
from harness.reference import ReferenceDetector  # noqa: E402
from harness.traffic import generate  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_pattern_detector_tpu")
TRACE_SECONDS = 1.5
_IMPORTED_AT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (interpreter start included)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def summarize(window: dict) -> str:
    """The window's counts, its flagged rows by route, and the spread of its
    recordings' or rounds' times."""
    import numpy as np

    parts = [f"{k} {window[k]:.6g}" for k in ("wall_s", "files", "chunks", "rounds", "audio_s") if k in window]
    if "reruns" in window:
        parts.append("flagged rows " + " ".join(f"{k} {v}" for k, v in window["reruns"].items()))
    per_file = window.get("per_file")
    if per_file:
        q = np.percentile(np.asarray(per_file) * 1e3, [0, 25, 50, 75, 100])
        parts.append("file ms min/q1/p50/q3/max " + "/".join(f"{v:.2f}" for v in q))
    lat = window.get("latencies")
    if lat:
        q = np.percentile(np.asarray(lat) * 1e3, [0, 50, 90, 95, 99, 100])
        parts.append("round ms min/p50/p90/p95/p99/max " + "/".join(f"{v:.3f}" for v in q))
    return ", ".join(parts)


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def device_memory() -> tuple[int, int]:
    """(free, total) bytes of the card, as the CUDA driver reports them."""
    import torch

    return torch.cuda.mem_get_info()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str) -> tuple[dict, list[str]]:
    """One run of ``cell``: (the result object, the check lines)."""
    import numpy as np
    import torch

    cuda = device.startswith("cuda")
    config = cell.config
    sr, chunk_s = int(config["sample_rate"]), int(config["chunk_seconds"])
    marks = {"start": process_age_s()}
    ref_clips = reference_clips(config, seed)
    traffic = generate(cell.traffic, seed, sr, chunk_s, ref_clips, cell.data_dir)
    marks["traffic"] = process_age_s()
    # The card's memory in use before the port loads (the CUDA context's),
    # so that what the cell holds beside the caching allocator is seen.
    free0 = device_memory()[0] if cuda else 0
    driver_mod = cell.driver
    workdir = Path(tempfile.mkdtemp(prefix="apd_bench_"))
    try:
        driver = driver_mod.Driver(cell, traffic, ref_clips, device, workdir)
        marks["program"] = process_age_s()
        driver.warm()
        if cuda:
            torch.cuda.synchronize()
        setup_s = process_age_s()
        marks["warm"] = setup_s
        print("setup split (s from process start): " + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()),
              file=sys.stderr)
        window = driver.run(seconds)
        print("window: " + summarize(window), file=sys.stderr)
        memory_peak = 0
        if cuda:
            torch.cuda.synchronize()
            held = free0 - device_memory()[0]
            reserved = torch.cuda.max_memory_reserved()
            memory_peak = max(held, reserved)
            print(f"device memory: allocated peak {torch.cuda.max_memory_allocated()}, reserved peak {reserved}, "
                  f"held beyond the context at the window's close {held}", file=sys.stderr)
        summary, traced_window = (trace.record(lambda: driver.run(TRACE_SECONDS)) if traced
                                  else (None, None))
        ctx = SimpleNamespace(setup_s=setup_s, window=window, trace=summary, traced=traced_window,
                              launch_bounds=driver.launch_bounds())
        metrics = {}
        for m in (cell.per_layer if traced else cell.end_to_end):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

        rng = np.random.default_rng(np.random.SeedSequence([seed, check.SAMPLE_SEED_TAG]))
        sample = check.draw(rng, traffic, driver_mod.population(traffic, driver.served()))
        driver.close()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        correct, checks = check.judge(driver.pairs(sample, ReferenceDetector(ref_clips, sr, chunk_s)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(window["attempted"]), "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return result, check.lines(checks)


def emit(result: dict, lines: list[str]) -> int:
    """Print the numbers compared and the result line, unless JAX or the JAX
    package has been loaded by anything of the run (the window, the trace,
    the metric readers, the reference): then name it and print no result."""
    found = forbidden_modules()
    if found:
        print(f"loaded by the run: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    cache_dirs()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    return emit(result, lines)


if __name__ == "__main__":
    sys.exit(main())
