#!/usr/bin/env python3
"""The correlation kernel (``csrc/correlate_os.cu``) by length and launch size, on the card.

    python3 scripts/probe_correlate_cluster.py                  # every length, three launches
    python3 scripts/probe_correlate_cluster.py --turns 4 --batch 16 8 6

For every fft_len from 8,192 to 262,144 (one CTA a transform up to 32,768,
a cluster of N / 32,768 CTAs past it, ``ops/correlate_os.py::cluster_size``)
and each launch (rows, clips, segments; by default 1 x 1 x 6, a long clip's
file-mode step; 16 x 1 x 6, that class in a 16-row round; 16 x 8 x 6, a
bank of eight long clips in a 16-row round), on seeded spectra of real
signals:

* sampled transforms bitwise ``chip_smoke.np_correlate_transforms``;
* in turns (kernel, cuFFT route, cuFFT route, kernel, ...), the kernel's and
  the cuFFT route's (``correlate_os_reference``) device ms of one call, from
  CUDA events around replays of a CUDA graph of 10 calls;
* ``torch.fft.irfft`` over the same products (the library call), the byte
  bound (``chip_smoke.correlate_bound``) and the kernel's share of it, the
  cluster size and the CTAs an SM.

Prints the card's name and power limit and the build's ptxas lines for the
kernel, then one JSON line a length and launch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

BATCHES = ((1, 1, 6), (16, 1, 6), (16, 8, 6))
PICKS = 6  # transforms of a launch held bitwise to the transliteration


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2, help="kernel-route-route-kernel rounds")
    ap.add_argument("--batch", nargs=3, type=int, action="append",
                    metavar=("ROWS", "CLIPS", "SEGMENTS"),
                    help="a launch to time (repeatable; default the three of BATCHES)")
    ap.add_argument("--min-len", type=int, default=8192, help="the shortest fft_len timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_correlate_cluster: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import check_correlate_transforms, correlate_bound, correlate_picks
    from profile_stages_torch import _timer

    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    lines = load_kernels().compiler_log.splitlines()
    for i, line in enumerate(lines):
        if "correlate_os_kernel" in line:
            for info in lines[i:i + 4]:
                if "registers" in info or "spill" in info or "correlate_os_kernel" in info:
                    print("  ptxas:", info.strip(), flush=True)
    timer = _timer(dev)
    rng = np.random.default_rng(5)
    for rows, clips, segments in args.batch or BATCHES:
        for e in range(max(2, args.min_len.bit_length() - 1), 19):
            n = 1 << e
            bins, step = n // 2 + 1, n - n // 8 + 1
            spectra = rng.standard_normal((rows * segments + clips, bins, 2)).astype(np.float32)
            spectra[:, [0, -1], 1] = 0.0  # real signals' spectra: real at 0 and N / 2
            spectra = torch.view_as_complex(torch.from_numpy(spectra)).to(dev)
            seg = spectra[: rows * segments].reshape(rows, segments, bins).contiguous()
            bank = spectra[rows * segments :].contiguous()
            call = (seg, bank, n, step, 3, segments * step - 8)
            out = tos.correlate_os(*call)
            torch.cuda.synchronize()
            compared = check_correlate_transforms(
                out, seg, bank, *call[2:], correlate_picks(rows, clips, segments, PICKS, seed=e))
            del out
            turns = {"kernel": [], "cufft_route": []}
            for _ in range(args.turns):
                for which in ("kernel", "cufft_route", "cufft_route", "kernel"):
                    fn = tos.correlate_os if which == "kernel" else tos.correlate_os_reference
                    turns[which].append(timer(lambda fn=fn: fn(*call)))
            prod = seg[..., None, :, :] * bank[:, None, :]
            library_ms = timer(lambda: torch.fft.irfft(prod, n=n))
            del prod
            ms = float(np.median(turns["kernel"]))
            bound_ms, bound_by = correlate_bound(rows, clips, segments, n, call[-1])
            cluster, ctas, threads, smem = tos.launch_geometry(rows, clips, segments, n)
            ctas_per_sm, clusters = tos.residency(n)
            print(json.dumps({
                "card": card, "fft_len": n, "rows": rows, "clips": clips, "segments": segments,
                "transforms": rows * clips * segments, "cluster": cluster, "ctas": ctas,
                "threads": threads, "shared_bytes": smem, "ctas_per_sm": ctas_per_sm,
                "clusters_resident": clusters, "transliteration_samples_bitwise": compared,
                "ms": ms, "cufft_route_ms": float(np.median(turns["cufft_route"])),
                "library_ms": library_ms, "turns_ms": turns, "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms}), flush=True)
            del seg, bank, spectra, call
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
