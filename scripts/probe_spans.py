#!/usr/bin/env python3
"""The span recorder (``utils/profiling.py``) on a card, on one of the
benchmark's live cells (``flagship64.live16`` unless ``--cell`` names
another; its bank, traffic and driver, from the seed):

1. ``flag``: a ``torch.profiler`` session with CUDA activity alone, as the
   benchmark's traced window runs it, turns the recorder on.
2. ``traced_window``: the benchmark's own traced window
   (``benchmark/harness/trace.py``) and the readers of the program's spans;
   beside them the window's mean round latency against
   ``session.dispatch`` + ``collect.wait`` + the rest of ``session.collect``,
   the idle time the starved stretches account for, and the starved
   stretch of a round split by span.
3. ``shared_clock``: a ``--trace-dir`` trace (``profiling.device_trace``)
   of a window: how far each ``cudaGraphLaunch`` lies outside the
   ``step.replay`` span around it, and each round's last
   ``cudaEventSynchronize`` outside its ``collect.wait`` (microseconds; 0
   inside).
4. ``slowest_rounds``: a window with recording on; its slowest rounds
   split by span, the garbage collections among them, each round's
   ``overlapped_rows`` (its rows packed after their class's first replay
   was enqueued, read from the spans), the time from its
   ``session.dispatch`` start to its first ``step.replay``, its
   ``rows_decoded_early`` (the counter, read around each ``collect``), the
   time from its last ``collect.wait``'s end to its ``session.collect``'s
   end, and its ``bank.launch`` a row; then the window's medians of these
   and its counters a round.
5. ``cost``: rounds with recording forced on against off, in turns.

    python3 scripts/probe_spans.py [--cell flagship64.live16] [--seed N] [--turns 3] [--seconds 4]

Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

SPAN_READERS = ("collect_wait_ms_per_round.live", "collect_host_ms_per_round.live",
                "launch_ms_per_round.live", "starved_ms_per_round.live", "live_groups_per_round.live")
# What a synchronous round does between its payload's arrival and its next
# first replay, by span; the rest is the caller's own time between calls.
STARVED_PARTS = ("collect.unpack", "collect.flagged", "collect.times", "bank.sections", "bank.pack",
                 "bank.upload", "step.load", "python.gc")


def _card() -> dict:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip()}


def _driver(name: str, seed: int, workdir: Path):
    from harness.cell import load_cell, reference_clips
    from harness.traffic import generate

    cell = load_cell(name)
    config = cell.config
    clips = reference_clips(config, seed)
    traffic = generate(cell.traffic, seed, int(config["sample_rate"]), int(config["chunk_seconds"]), clips,
                       cell.data_dir)
    driver = cell.driver.Driver(cell, traffic, clips, "cuda", workdir)
    driver.warm()
    return driver


def _by_round(spans) -> dict:
    rounds: dict = defaultdict(list)
    for s in spans:
        if s.round >= 0:
            rounds[s.round].append(s)
    return rounds


def _overlap(s, lo: int, hi: int) -> int:
    return max(0, min(s.end_ns, hi) - max(s.start_ns, lo))


def _per_round(spans) -> dict:
    """Mean ms a round by span name, over the rounds with a ``session.collect``."""
    rounds = {s.round for s in spans if s.name == "session.collect" and s.round >= 0}
    total: dict = defaultdict(int)
    for s in spans:
        if s.round in rounds:
            total[s.name] += s.end_ns - s.start_ns
    return {k: round(1e-6 * v / len(rounds), 4) for k, v in sorted(total.items())} if rounds else {}


def _starved_split(spans) -> dict:
    """Mean ms a round, by span, of the stretches from a round's last
    ``collect.wait`` end to the next round's first ``step.replay`` start."""
    rounds = _by_round(spans)
    ids = sorted(r for r, ss in rounds.items() if any(s.name == "session.collect" for s in ss))
    parts: dict = defaultdict(int)
    n = 0
    for a, b in zip(ids, ids[1:]):
        waits = [s.end_ns for s in rounds[a] if s.name == "collect.wait"]
        replays = [s.start_ns for s in rounds[b] if s.name == "step.replay"]
        if not waits or not replays:
            continue
        lo, hi = max(waits), min(replays)
        n += 1
        parts["stretch"] += hi - lo
        covered = 0
        for s in spans:
            if s.name in STARVED_PARTS:
                ov = _overlap(s, lo, hi)
                parts[s.name] += ov
                covered += ov if s.name != "python.gc" else 0
        roots = [s for s in spans if s.name in ("session.dispatch", "session.collect")]
        inside = sum(_overlap(s, lo, hi) for s in roots)
        parts["session (other)"] += inside - covered
        parts["caller, between calls"] += (hi - lo) - inside
    return {k: round(1e-6 * v / n, 4) for k, v in parts.items()} if n else {}


def traced_window(driver, seconds: float) -> dict:
    from harness import trace
    from harness.cell import metric_reader

    from audio_pattern_detector_tpu_torch.utils import profiling

    summary, traced = trace.record(lambda: driver.run(seconds))
    ctx = SimpleNamespace(setup_s=0.0, window=traced, trace=summary, traced=traced, launch_bounds={})
    values = {name: metric_reader(name)(ctx) for name in SPAN_READERS + ("device_idle_pct.live",)}
    spans = profiling.spans()
    rounds = len({s.round for s in spans if s.name == "session.collect"})
    dispatch = [s.ms for s in spans if s.name == "session.dispatch"]
    latency = 1e3 * statistics.mean(traced["latencies"])
    inside = statistics.mean(dispatch) + values["collect_wait_ms_per_round.live"] + \
        values["collect_host_ms_per_round.live"]
    idle_ms = 1e3 * (summary.window_s - summary.busy_s)
    return {"readers": values, "rounds": rounds, "driver_rounds": traced["rounds"],
            "mean_latency_ms": latency, "session_dispatch_ms": statistics.mean(dispatch),
            "dispatch_wait_host_over_latency": inside / latency,
            "window_s": summary.window_s, "idle_ms": idle_ms,
            "starved_share_of_idle": values["starved_ms_per_round.live"] * rounds / idle_ms,
            "idle_gaps": summary.idle_gaps[:5], "starved_split_ms": _starved_split(spans),
            "by_span_ms_per_round": _per_round(spans),
            "dropped": profiling.RECORDER.dropped}


def _outside(t0: float, t1: float, starts: list, spans: list) -> float:
    """Microseconds [t0, t1] lies outside the nearest span that could hold it."""
    k = bisect.bisect_right(starts, t0)
    best = float("inf")
    for j in range(max(0, k - 3), min(len(spans), k + 3)):
        s0, s1 = spans[j]
        best = min(best, max(0.0, s0 - t0) + max(0.0, t1 - s1))
    return best


def shared_clock(driver, seconds: float) -> dict:
    from audio_pattern_detector_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory(prefix="apd_spans_") as out_dir:
        with profiling.device_trace(out_dir, "cuda"):
            driver.run(seconds)
        (path,) = Path(out_dir).glob("apd_torch_*.json")
        doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    apd = [e for e in events if e.get("cat") == "apd_span"]

    def spans_named(name):
        got = sorted((e["ts"], e["ts"] + e["dur"]) for e in apd if e["name"] == name)
        return [s for s, _ in got], got

    def runtime(name):
        return sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                      if e.get("cat") == "cuda_runtime" and e["name"].startswith(name))

    starts, replays = spans_named("step.replay")
    launches = runtime("cudaGraphLaunch")
    launch_off = [_outside(a, b, starts, replays) for a, b in launches]
    syncs = runtime("cudaEventSynchronize")
    by_round: dict = defaultdict(dict)
    for e in apd:
        r = e["args"]["round"]
        if e["name"] in ("session.collect", "collect.wait"):
            by_round[r].setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    sync_off = []
    for r, d in by_round.items():
        if "session.collect" not in d or "collect.wait" not in d:
            continue
        c0, c1 = d["session.collect"][0]
        inside = [s for s in syncs if c0 - 50 <= s[0] <= c1 + 50]
        if inside:
            a, b = inside[-1]
            waits = sorted(d["collect.wait"])
            sync_off.append(_outside(a, b, [w[0] for w in waits], waits))
    return {"base_time_ns_present": "baseTimeNanoseconds" in doc,
            "graph_launches": len(launches), "launch_outside_replay_us_max": max(launch_off, default=None),
            "launches_beyond_20us": sum(x > 20 for x in launch_off),
            "rounds": len(sync_off), "last_sync_outside_wait_us_max": max(sync_off, default=None),
            "syncs_beyond_20us": sum(x > 20 for x in sync_off)}


def _dispatch_overlap(ss) -> "tuple[int, float] | None":
    """(overlapped rows, ms from the dispatch's start to its first
    ``step.replay``) of one round's spans: a row counts where its
    ``bank.pack`` starts once a ``step.replay`` of its class (attribute
    ``b``, the window) inside the round's ``session.dispatch`` has ended."""
    d = [s for s in ss if s.name == "session.dispatch"]
    if not d:
        return None
    d0, d1 = d[0].start_ns, d[0].end_ns
    replays = [s for s in ss if s.name == "step.replay" and d0 <= s.start_ns <= d1]
    if not replays:
        return None
    first_end: dict = {}
    for s in replays:
        first_end[s.b] = min(first_end.get(s.b, s.end_ns), s.end_ns)
    overlapped = sum(1 for s in ss if s.name == "bank.pack" and s.b in first_end
                     and s.start_ns >= first_end[s.b])
    return overlapped, 1e-6 * (min(s.start_ns for s in replays) - d0)


def _after_last_wait(ss) -> "float | None":
    """ms from a round's last ``collect.wait`` end to its ``session.collect`` end."""
    c = [s for s in ss if s.name == "session.collect"]
    waits = [s.end_ns for s in ss if s.name == "collect.wait"]
    return 1e-6 * (c[0].end_ns - max(waits)) if c and waits else None


def _launch_per_row(ss) -> "float | None":
    """Mean ms of a round's one-row ``bank.launch`` spans (load, replay and
    the row's copy back), the host's time a row beside the card's."""
    rows = [s.ms for s in ss if s.name == "bank.launch" and s.a == 1]
    return statistics.mean(rows) if rows else None


def _median(values) -> "float | None":
    values = [v for v in values if v is not None]
    return round(statistics.median(values), 4) if values else None


def slowest_rounds(driver, seconds: float, k: int = 5) -> list:
    from audio_pattern_detector_tpu_torch.utils import profiling

    # The counter rows_decoded_early a round: read around each collect.
    session = driver.session
    collect = session.collect
    early: dict = {}

    def counted_collect(handle):
        before = profiling.RECORDER.counters.get("rows_decoded_early", 0)
        out = collect(handle)
        early[handle[3]] = profiling.RECORDER.counters.get("rows_decoded_early", 0) - before
        return out

    session.collect = counted_collect
    try:
        with profiling.recording():
            driver.run(seconds)
    finally:
        del session.collect
    spans = profiling.spans()
    rounds = _by_round(spans)
    lat = {}
    for r, ss in rounds.items():
        d = [s for s in ss if s.name == "session.dispatch"]
        c = [s for s in ss if s.name == "session.collect"]
        if d and c:
            lat[r] = c[0].end_ns - d[0].start_ns
    out = []
    for r in sorted(lat, key=lat.get, reverse=True)[:k]:
        names: dict = defaultdict(int)
        for s in rounds[r]:
            names[s.name] += s.end_ns - s.start_ns
        overlap = _dispatch_overlap(rounds[r])
        out.append({"round": r, "ms": round(lat[r] * 1e-6, 3),
                    "by_span_ms": {n: round(v * 1e-6, 3) for n, v in sorted(names.items())},
                    "gc": [(s.a, round(s.ms, 3)) for s in rounds[r] if s.name == "python.gc"],
                    "overlapped_rows": overlap and overlap[0],
                    "dispatch_to_first_replay_ms": overlap and round(overlap[1], 3),
                    "rows_decoded_early": early.get(r),
                    "after_last_wait_ms": _after_last_wait(rounds[r]),
                    "launch_ms_per_row": _launch_per_row(rounds[r])})
    all_gc = [s for s in spans if s.name == "python.gc"]
    overlaps = [o for o in (_dispatch_overlap(rounds[r]) for r in lat) if o is not None]
    out.append({"rounds": len(lat), "median_ms": round(1e-6 * statistics.median(lat.values()), 3),
                "overlapped_rows_median": statistics.median(o[0] for o in overlaps) if overlaps else None,
                "dispatch_to_first_replay_ms_median":
                    round(statistics.median(o[1] for o in overlaps), 4) if overlaps else None,
                "rows_decoded_early_median": _median(early.get(r) for r in lat),
                "after_last_wait_ms_median": _median(_after_last_wait(rounds[r]) for r in lat),
                "launch_ms_per_row_median": _median(_launch_per_row(rounds[r]) for r in lat),
                "by_span_ms_per_round": _per_round(spans), "starved_split_ms": _starved_split(spans),
                "gc_count": len(all_gc), "gc_ms_total": round(sum(s.ms for s in all_gc), 3),
                "gc_max_ms": round(max((s.ms for s in all_gc), default=0.0), 3),
                "counters_per_round": {name: n / len(lat) for name, n in sorted(profiling.counters().items())}})
    return out


def cost(driver, turns: int, seconds: float) -> dict:
    from audio_pattern_detector_tpu_torch.utils import profiling

    runs = []
    for t in range(turns):
        for mode in (("off", "on") if t % 2 == 0 else ("on", "off")):
            if mode == "on":
                with profiling.recording():
                    w = driver.run(seconds)
            else:
                w = driver.run(seconds)
            lat = [1e3 * x for x in w["latencies"]]
            runs.append({"mode": mode, "rounds": len(lat), "p50_ms": statistics.median(lat),
                         "mean_ms": statistics.mean(lat),
                         "dispatch_ms": 1e3 * statistics.mean(w["dispatch"])})
    summary = {m: statistics.median(r["p50_ms"] for r in runs if r["mode"] == m) for m in ("off", "on")}
    return {"runs": runs, "p50_median_off_ms": summary["off"], "p50_median_on_ms": summary["on"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", default="flagship64.live16", help="a live cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, default=2**31 + 977)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_pattern_detector_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("probe_spans needs a CUDA device", file=sys.stderr)
        return 2
    out: dict = {"cell": args.cell, "seed": args.seed, "card": _card()}
    with profile(activities=[ProfilerActivity.CUDA]):
        from torch.autograd import profiler as autograd_profiler

        out["flag"] = {"torch_flag": bool(autograd_profiler._is_profiler_enabled),
                       "recorder_on": profiling.RECORDER.on}
    out["flag"]["recorder_off_after"] = not profiling.RECORDER.on
    with tempfile.TemporaryDirectory(prefix="apd_probe_") as work:
        driver = _driver(args.cell, args.seed, Path(work))
        out["traced_window"] = traced_window(driver, 1.5)
        out["shared_clock"] = shared_clock(driver, 1.5)
        out["slowest_rounds"] = slowest_rounds(driver, 10.0)
        out["cost"] = cost(driver, args.turns, args.seconds)
        driver.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
