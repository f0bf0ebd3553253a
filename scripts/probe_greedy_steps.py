#!/usr/bin/env python3
"""Where the two greedy kernels' time goes, step by step, on one CUDA card.

    python3 scripts/probe_greedy_steps.py

Builds copies of ``csrc/lane_greedy.cu`` and ``csrc/lean_greedy.cu`` with
``clock64()`` stamps at their steps into ``build/greedy_probe/`` and runs
them on seeded inputs, each checked bitwise against its plain version:

* the lane greedy (stamps by thread 0 of each CTA: the staging, the chunk
  counts and compaction, the sort, the neighbour ranges, the walk, the
  keep write) on 32 rows of 4,728 clustered lanes (``lane_greedy_input``,
  m = 2,000, every lane alive), on ``LANE_WORST_CASES`` (32 rows of 4,728)
  and on 512 rows of clustered lanes (the general round's width);
* the lean greedy (a barrier and a stamp after each phase of a round:
  the seed, the windows' copy and quotients, the seed's candidates, the
  edges' candidates, the refresh; the setup before the first round and the
  exit after the last) on 512 rows of noise with one hit-bearing row (three
  peaks 100,000 samples apart, m = 2,000) and on 32 rows with two.

Prints the card's name, power limit and SM clock, then one JSON line per
input: the median cycles of each step over the CTAs (the lean greedy's hit
rows and a candidate-free row apart), and the milliseconds a launch of the
instrumented copy (CUDA events around 20 launches; its stamps cost a
little).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from audio_pattern_detector_tpu_torch.kernels import _build  # noqa: E402
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan  # noqa: E402
from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy_reference  # noqa: E402
from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy_reference  # noqa: E402

LANE_STEPS = ("stage", "count_and_compact", "sort", "ranges", "walk", "keep")
LANE_SUBS = [
    ("int K, int min_distance, unsigned char* __restrict__ keep) {",
     "int K, int min_distance, unsigned char* __restrict__ keep, long long* stamps) {\n"
     "  long long* st = stamps + blockIdx.x * 8;\n"
     "  if (threadIdx.x == 0) st[0] = clock64();"),
    ("  __syncthreads();\n  const int ek =",
     "  if (threadIdx.x == 0) st[1] = clock64();\n  __syncthreads();\n  const int ek ="),
    ("  // 2. Stable LSD radix sort", "  if (threadIdx.x == 0) st[2] = clock64();\n  // 2."),
    ("  // 3. Each lane's neighbour range", "  if (threadIdx.x == 0) st[3] = clock64();\n  // 3."),
    ("  // 4. The walk", "  if (threadIdx.x == 0) st[4] = clock64();\n  // 4."),
    ("  // 5. keep, lane by lane", "  if (threadIdx.x == 0) st[5] = clock64();\n  // 5."),
    ("  for (int i = t; i < K; i += kThreads) keep[row + i] = static_cast<unsigned char>(stage[i]);\n",
     "  for (int i = t; i < K; i += kThreads) keep[row + i] = static_cast<unsigned char>(stage[i]);\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) st[6] = clock64();\n"),
    ("unsigned char* keep, void* stream) {", "unsigned char* keep, void* stream, long long* stamps) {"),
    ("pos, alive, K, min_distance, keep);", "pos, alive, K, min_distance, keep, stamps);"),
]
LEAN_PHASES = ("setup", "seed", "windows", "seed_candidates", "edges", "refresh", "exit")
LEAN_SUBS = [
    ("unsigned char* __restrict__ overflow) {",
     "unsigned char* __restrict__ overflow, long long* stamps) {\n"
     "  long long* st = stamps + blockIdx.x * 8;\n"
     "  long long t_last = clock64();\n"
     "  auto mark = [&](int i) {\n"
     "    __syncthreads();\n"
     "    if (threadIdx.x == 0) {\n"
     "      const long long now = clock64();\n"
     "      st[i] += now - t_last;\n"
     "      t_last = now;\n"
     "    }\n"
     "  };"),
    ("    // The seed, on every warp alike.", "    mark(0);\n    // The seed"),
    ("    // The windows: the seed's", "    mark(1);\n    // The windows"),
    ("    // The seed block's suppressed candidates.", "    mark(2);\n    // The seed block's"),
    ("    // Both edge blocks' suppressed maxima", "    mark(3);\n    // Both edge blocks'"),
    ("    refresh(b_first / kGroup, b_last / kGroup, lo, hi, be_lo, be_hi, m_lo, m_hi, true);\n"
     "    __syncthreads();",
     "    mark(4);\n"
     "    refresh(b_first / kGroup, b_last / kGroup, lo, hi, be_lo, be_hi, m_lo, m_hi, true);\n"
     "    mark(5);"),
    ("  const long long o = static_cast<long long>(g) * r_max;",
     "  mark(6);\n  const long long o = static_cast<long long>(g) * r_max;"),
    ("unsigned char* overflow, void* stream) {",
     "unsigned char* overflow, void* stream, long long* stamps) {"),
    ("r_max, pos, height,\n      overflow);", "r_max, pos, height,\n      overflow, stamps);"),
]


def build(name: str, subs: list[tuple[str, str]], entry: str) -> ctypes.CDLL:
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not in the source")
        src = src.replace(old, new, 1)
    out = ROOT / "build" / "greedy_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    so = out / f"{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o",
                           str(so), str(out / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = [*_build._SIGNATURES[entry][0], ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def timed(call) -> float:
    if call():
        raise SystemExit("launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 20


def lane(lib, name: str, pos: np.ndarray, alive: np.ndarray, m: int) -> dict:
    p, a = torch.from_numpy(pos).cuda(), torch.from_numpy(alive).cuda()
    g, k = p.shape
    keep = torch.empty((g, k), dtype=torch.bool, device="cuda")
    stamps = torch.zeros((g, 8), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = timed(lambda: lib.apd_lane_greedy(p.data_ptr(), a.data_ptr(), g, k, m, keep.data_ptr(),
                                           stream, stamps.data_ptr()))
    if not torch.equal(keep, lane_greedy_reference(p, a, m)):
        raise SystemExit(f"lane greedy, {name}: differs from its plain version")
    steps = np.median(np.diff(stamps.cpu().numpy()[:, :7], axis=1), axis=0)
    return {"kernel": "lane_greedy", "input": name, "shape": [g, k], "min_distance": m,
            "kept_a_row": float(keep.sum()) / g, "ms_a_launch": ms,
            "cycles": dict(zip(LANE_STEPS, (int(x) for x in steps)))}


def lean(lib, name: str, g: int, hit_rows: list[int]) -> dict:
    rng = np.random.default_rng(3)
    l = 489_999
    corr = (np.abs(rng.standard_normal((g, l))) * 0.02).astype(np.float32)
    for r in hit_rows:
        for q, h in ((100_000, 0.95), (200_000, 0.9), (300_000, 0.85)):
            corr[r, q] = h
    case = {"corr": corr, "valid_len": l, "scm": np.full(g, 0.7, dtype=np.float32), "hm": 0.25,
            "m": 2000, "r_max": 16, "edits": []}
    args = cs.lean_greedy_inputs(case, torch.device("cuda"), candidate_scan)
    c, vl, bmax, denom, hm, m, r_max = args
    pos = torch.empty((g, r_max), dtype=torch.int64, device="cuda")
    height = torch.empty((g, r_max), device="cuda")
    overflow = torch.empty((g,), dtype=torch.bool, device="cuda")
    stamps = torch.zeros((g, 8), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call() -> int:
        return lib.apd_lean_greedy(c.data_ptr(), None, g, l, vl, bmax.data_ptr(), bmax.shape[1],
                                   denom.data_ptr(), hm, m, r_max, pos.data_ptr(),
                                   height.data_ptr(), overflow.data_ptr(), stream,
                                   stamps.data_ptr())

    call()
    torch.cuda.synchronize()
    if not cs.greedy_outputs_equal((pos, height, overflow), lean_greedy_reference(*args)):
        raise SystemExit(f"lean greedy, {name}: differs from its plain version")
    stamps.zero_()
    ms = timed(call)
    per = stamps.cpu().numpy() / 21  # every launch of ``timed`` added to the stamps
    free = next(r for r in range(g) if r not in hit_rows)
    phases = lambda r: dict(zip(LEAN_PHASES, (int(x) for x in per[r, :7])))
    return {"kernel": "lean_greedy", "input": name, "shape": [g, l], "min_distance": m,
            "survivors": int(torch.isfinite(height).sum()), "ms_a_launch": ms,
            "cycles_hit_rows": [phases(r) for r in hit_rows],
            "cycles_candidate_free_row": phases(free)}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_greedy_steps: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    lane_lib = build("lane_greedy", LANE_SUBS, "apd_lane_greedy")
    pos, alive = cs.lane_greedy_input(32, 4728, [4728] * 32, 495_999, 2000, seed=5)
    print(json.dumps(lane(lane_lib, "clustered", pos, alive, 2000)), flush=True)
    for name in cs.LANE_WORST_CASES:
        print(json.dumps(lane(lane_lib, name, *cs.lane_worst_case(name, 32, 4728))), flush=True)
    pos, alive = cs.lane_greedy_input(512, 4728, [4728] * 512, 495_999, 2000, seed=7)
    print(json.dumps(lane(lane_lib, "clustered_512_rows", pos, alive, 2000)), flush=True)
    lean_lib = build("lean_greedy", LEAN_SUBS, "apd_lean_greedy")
    print(json.dumps(lean(lean_lib, "one_hit_row_of_512", 512, [5])), flush=True)
    print(json.dumps(lean(lean_lib, "two_hit_rows_of_32", 32, [0, 7])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
