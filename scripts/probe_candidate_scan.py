#!/usr/bin/env python3
"""Where the candidate-scan kernel's time goes, on one CUDA card.

    python3 scripts/probe_candidate_scan.py

Builds variants of ``audio_pattern_detector_tpu_torch/csrc/candidate_scan.cu``
(the source with one constant or one line replaced) into ``build/scan_probe/``
and times each at the flagship normal group's shape (32 x 495,999, valid to
L - 1234), on chip_smoke's phase-2 input, on the same input with a
threshold no sample reaches (no sample runs the threshold-side tests) and
with a threshold of 0 (every sample runs them: the kernel's slowest input).
``load_only`` keeps the copy ring and drops the scan: the loader's own rate.
``threads_128`` and ``stages_4`` change the CTA's width and the ring's depth.
``no_skip`` copies and scans the tiles past a row's valid length too. Then
``as_built`` and ``no_skip`` run at the shape of a batched round of 16
sections (512 x 495,999, chip_smoke's phase-2b input) with every row full
and with its mixed per-row lengths (a quarter each full, short,
lead-in-only and zero).
Each time is the median of 5 CUDA-event pairs around 50 back-to-back
launches, so it includes the gaps between launches. Prints one JSON line per
variant, with the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from audio_pattern_detector_tpu_torch.kernels import _build  # noqa: E402
from chip_smoke import batched_scan_input, make_scan_input, scan_bound_ms  # noqa: E402

OCCUPANCY = r'''
extern "C" int probe_ctas_per_sm() {
  int n = 0;
  cudaFuncSetAttribute(candidate_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kSmemBytes));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, candidate_scan_kernel, kThreads, kSmemBytes);
  return n;
}
'''
THREADS = "constexpr int kThreads = 256;"
STAGES = "constexpr int kStages = 2;"
VARIANTS = {
    "as_built": [],
    "load_only": [("    scan_tile(s, d, t0,",
                   "    if (s[threadIdx.x] == 12345.f) om = 1.f;\n    if (false) scan_tile(s, d, t0,")],
    "threads_128": [(THREADS, "constexpr int kThreads = 128;")],
    "stages_4": [(STAGES, "constexpr int kStages = 4;")],
    "no_skip": [("    return (item % tiles_per_row) * kTile >= row_limit(",
                 "    return false && (item % tiles_per_row) * kTile >= row_limit(")],
}


def build(name: str, subs: list[tuple[str, str]]) -> tuple[ctypes.CDLL, str]:
    src = (_build.CSRC_DIR / "candidate_scan.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    src = src.replace("}  // namespace\n", "}  // namespace\n" + OCCUPANCY, 1)
    out = ROOT / "build" / "scan_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    so = out / f"{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(out / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    lib.apd_candidate_scan.argtypes, lib.apd_candidate_scan.restype = _build._SIGNATURES[
        "apd_candidate_scan"]
    log = proc.stdout + proc.stderr
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return lib, (regs[0] if regs else "?") + (f", {spills[0]} B spilled" if spills else "")


def ms_per_call(lib, corr: torch.Tensor, thr: torch.Tensor, valid_len, runs: int = 50) -> float:
    """``valid_len`` is an int, or a (G,) int32 tensor of per-row lengths."""
    g, l = corr.shape
    lens_ptr, scalar = (None, valid_len) if isinstance(valid_len, int) else (valid_len.data_ptr(), 0)
    nb = -(-l // 512)
    bmax = torch.empty((g, nb), device="cuda")
    stats = torch.zeros(3 * g, dtype=torch.int32, device="cuda")  # left unzeroed between calls
    ptr = stats.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def call() -> None:
        err = lib.apd_candidate_scan(corr.data_ptr(), thr.data_ptr(), lens_ptr, g, l, scalar,
                                     bmax.data_ptr(), nb, ptr, ptr + 4 * g, ptr + 8 * g,
                                     ptr + 9 * g, stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_candidate_scan: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    g, l = 32, 495_999
    valid_len = l - 1234
    corr_np, thr_np = make_scan_input(g, l, 0)
    corr = torch.from_numpy(corr_np).cuda()
    thr = torch.from_numpy(thr_np).cuda()
    unreached = torch.full((g,), 10.0, device="cuda")
    zero = torch.zeros(g, device="cuda")
    libs = {}
    for name, subs in VARIANTS.items():
        lib, regs = libs[name] = build(name, subs)
        print(json.dumps({
            "variant": name, "registers": regs, "ctas_per_sm": lib.probe_ctas_per_sm(),
            "ms_phase2_input": ms_per_call(lib, corr, thr, valid_len),
            "ms_no_sample_above_threshold": ms_per_call(lib, corr, unreached, valid_len),
            "ms_threshold_zero": ms_per_call(lib, corr, zero, valid_len),
            "bound_ms": scan_bound_ms(g, l, valid_len),
        }), flush=True)
    del corr
    g, l = 512, 495_999
    corr, thr, lens = batched_scan_input(g, l, 0, torch.device("cuda"))
    full = torch.full_like(lens, l)
    for name in ("as_built", "no_skip"):
        lib, regs = libs[name]
        print(json.dumps({
            "variant": name, "shape": [g, l], "registers": regs,
            "ms_every_row_full": ms_per_call(lib, corr, thr, full, runs=10),
            "bound_ms_every_row_full": scan_bound_ms(g, l, full),
            "ms_mixed_lengths": ms_per_call(lib, corr, thr, lens, runs=10),
            "bound_ms_mixed_lengths": scan_bound_ms(g, l, lens),
            "valid_share_mixed": float(lens.sum()) / (g * l),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
