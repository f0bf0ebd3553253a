#!/usr/bin/env python3
"""Time the port's main path in two checkouts, in turns, on one CUDA card.

    python3 scripts/turns_parent_vs_change.py PARENT_DIR [CHANGE_DIR] [--turns 2]

CHANGE_DIR defaults to this checkout. Each turn runs one subprocess per
checkout in the order parent, change, change, parent (``--turns`` repeats
that sequence), each from its own directory so it builds and loads its own
kernels. A subprocess times, after a warm-up:

* the flagship step (64-clip bank, one 60 s section, the candidate-scan
  kernel): median ms of 5 timed groups of 5 synchronised steps;
* the flagship round (the same bank, 16 sections), where the checkout has
  it: ms per round as one ``vmap`` step and as 16 ``scan`` steps, in turns
  (vmap, scan, scan, vmap, twice), the median of 4 timings of 2 rounds;
* chip_smoke phase 9's steady serving round, where the checkout has it:
  ``MultiStreamSession`` on the flagship detector, 16 slots of seeded 60 s
  f32 chunks, tile 16, 2 rounds in flight, in ``vmap`` and in ``scan`` in
  turns (vmap, scan, scan, vmap, twice; 3 rounds a turn after a warm-up
  round): the median ms per round, and the host ms per round of each
  dispatch stage (``dispatch_phase_seconds``: sections, pack, upload,
  launch, prefetch) over the 12 rounds of each mode;
* file mode: ``match`` through the CLI on cbs_news_audio_section.wav tiled
  15 times (about 482 s), the median wall of 5 runs, and its x-realtime;
* the candidate-scan wrapper at (32, 495,999) on chip_smoke's phase-2
  input: ms per call, the median of 5 CUDA-event pairs around 30
  back-to-back calls (host enqueue and device work overlapped);
* the candidate-scan kernel's device time (torch.profiler, median of 30
  calls) on that input, on it with a threshold of 0 (every sample at or
  above it), and on the inputs of the flagship step's two launches.

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
import contextlib, io, json, sys, tempfile, time, wave
from pathlib import Path
import numpy as np
import torch
from audio_pattern_detector_tpu_torch.cli import main
from audio_pattern_detector_tpu_torch.flagship import flagship_step

dev = torch.device("cuda")
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
step, _ = flagship_step(dev)
step_scans = []

def recording(corr, thr, valid_len):
    step_scans.append((corr.clone(), thr.clone(), valid_len))
    return candidate_scan(corr, thr, valid_len)

step(scan=recording)
for _ in range(3):
    step()
groups = []
for _ in range(5):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    groups.append((time.perf_counter() - t) / 5 * 1e3)
del step

# The batched round (16 sections): one vmap step against 16 scan steps, in
# turns. A checkout from before the batched class step has no twin for it.
round_ms = {}
try:
    from audio_pattern_detector_tpu_torch.flagship import flagship_round
except ImportError:
    flagship_round = None
if flagship_round is not None:
    round_step, _, _ = flagship_round(dev)
    round_step("vmap")
    times = {"vmap": [], "scan": []}
    for mode in ("vmap", "scan", "scan", "vmap") * 2:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2):
            round_step(mode)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t) / 2 * 1e3)
    round_ms = {f"flagship_round_{mode}_ms": float(np.median(v)) for mode, v in times.items()}
    del round_step
    torch.cuda.empty_cache()

# Phase 9's steady serving round (16 full rows, 2 rounds in flight).
serve_ms = {}
try:
    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models.bank import dispatch_phase_seconds
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
except ImportError:
    MultiStreamSession = None
if MultiStreamSession is not None:
    det = make_detector(32, 32, chunk_seconds=60, device=dev)
    rng = np.random.default_rng(30)
    rounds = [[(0.004 * rng.standard_normal(60 * 8000)).astype(np.float32) for _ in range(16)]
              for _ in range(4)]
    sessions = {m: MultiStreamSession(det, 16, tile=16, batch_mode=m) for m in ("vmap", "scan")}
    for session in sessions.values():
        session.feed(rounds[0])
    times = {"vmap": [], "scan": []}
    split = {m: dict.fromkeys(dispatch_phase_seconds, 0.0) for m in times}
    for mode in ("vmap", "scan", "scan", "vmap") * 2:
        session, pending = sessions[mode], []
        before = dict(dispatch_phase_seconds)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for chunks in rounds[1:]:
            pending.append(session.dispatch(chunks))
            if len(pending) >= 2:
                session.collect(pending.pop(0))
        while pending:
            session.collect(pending.pop(0))
        times[mode].append((time.perf_counter() - t) / 3 * 1e3)
        for k in split[mode]:
            split[mode][k] += dispatch_phase_seconds[k] - before[k]
    for mode, v in times.items():
        serve_ms[f"serving_round_{mode}_ms"] = float(np.median(v))
        for k, sec in split[mode].items():
            serve_ms[f"serving_round_{mode}_{k}_ms"] = sec / (3 * len(v)) * 1e3
    del det, sessions
    torch.cuda.empty_cache()

audio = Path("sample_audios")
with wave.open(str(audio / "cbs_news_audio_section.wav"), "rb") as w:
    rate, frames = w.getframerate(), w.readframes(w.getnframes())
pcm = np.frombuffer(frames, dtype=np.int16)
walls = []
with tempfile.TemporaryDirectory() as tmp:
    tiled = Path(tmp) / "cbs_x15.wav"
    with wave.open(str(tiled), "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(rate)
        w.writeframes(np.tile(pcm, 15).tobytes())
    argv = ["match", "--pattern-file", str(audio / "clips" / "cbs_news.wav"), str(tiled)]
    for k in range(6):
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv)
        if k:
            walls.append(time.perf_counter() - t)
audio_s = 15 * len(pcm) / rate

from chip_smoke import kernel_device_ms, make_scan_input
corr_np, thr_np = make_scan_input(32, 495_999, 0)
corr, thr = torch.from_numpy(corr_np).to(dev), torch.from_numpy(thr_np).to(dev)
for _ in range(3):
    candidate_scan(corr, thr, 495_999 - 1234)
torch.cuda.synchronize()
scan = []
for _ in range(5):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(30):
        candidate_scan(corr, thr, 495_999 - 1234)
    end.record()
    end.synchronize()
    scan.append(start.elapsed_time(end) / 30)

def device_ms(c, t, v):
    return kernel_device_ms(lambda: candidate_scan(c, t, v), "candidate_scan_kernel", 30)

kernel = {"scan_device_ms": device_ms(corr, thr, 495_999 - 1234),
          "scan_device_ms_threshold_zero": device_ms(corr, torch.zeros_like(thr), 495_999 - 1234)}
for k, (c, t, v) in enumerate(step_scans):
    kernel[f"scan_device_ms_step_launch_{k}"] = device_ms(c, t, v)
print(json.dumps({"flagship_step_ms": float(np.median(groups)),
                  "file_mode_wall_s": float(np.median(walls)),
                  "file_mode_x_realtime": audio_s / float(np.median(walls)),
                  "scan_wrapper_ms": float(np.median(scan)), **kernel, **round_ms, **serve_ms}))
'''


def run(checkout: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", TIMING], cwd=checkout, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(checkout)}, timeout=900,
    )
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for _ in range(args.turns):
        for name in ("parent", "change", "change", "parent"):
            out = run(getattr(args, name).resolve())
            runs[name].append(out)
            print(json.dumps({"checkout": name, **out}), flush=True)
    summary = {
        name: {key: float(np.median([r[key] for r in rs])) for key in rs[0]}
        for name, rs in runs.items()
    }
    print(json.dumps({"card": smi, "medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
