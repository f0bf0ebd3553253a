#!/usr/bin/env python3
"""Time the class step's transforms at fixed batches on one CUDA card.

    python3 scripts/probe_fft_batch.py [--rows 1 16]

The port runs each call site's cuFFT transforms in calls of a fixed number
of transforms (``ops/cufft_plans.py``): the points a call holds over the
length, set by ``ops/loudness.py::FFT_POINTS``,
``ops/correlate.py::SEGMENT_FFT_POINTS`` and ``CORRELATION_FFT_POINTS``.
On the flagship bank (64 clips, 61 s sections at 8 kHz) this times, for
each site and several points a call, the site's transforms of a round of
``--rows`` sections, in device ms from CUDA events around replays of a
graph of 4 calls (``chip_smoke.graph_ms``):

* the K-weighting (rfft, product, irfft of 40 segments of 16,384 points
  a row);
* the segment spectra (rfft of 21 segments of 32,768 points a row);
* the correlation's cuFFT route (``ops/correlate.py::cufft_correlation``:
  product, inverse transforms, slice and ``abs``) of one group (32 clips x
  21 segments a row) and of the row rerun's one clip: on a card the class
  step runs its kernel for these lengths, and the cuFFT route only past
  32,768 points and in the single-FFT branch.

Runs chip_smoke's cuFFT probe first (each site's plan gives a transform
the same bits at every index of its batch). Prints the card's name and
power limit and one JSON line per site and setting.
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

SETTINGS = {
    "loudness": (18, 19, 20, 21, 22),  # log2 of the points a call
    "segment": (19, 20, 21, 22),
    "correlation": (20, 21, 22, 23, 24),
}


def main() -> int:
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_bank
    from audio_pattern_detector_tpu_torch.ops import correlate, cufft_plans, loudness
    from chip_smoke import fft_batch_probe, graph_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    for line in load_kernels().compiler_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)
    dev = torch.device("cuda")
    bank = make_bank(32, 32, chunk_seconds=60, device=dev)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s, loud, group = cls["section_len"], cls["loud"], cls["groups"][0]
    row_consts, _ = bank._row_consts_for(sw, 0, 0)
    print(json.dumps({"probe": fft_batch_probe(dev, loud, group.corr)}), flush=True)
    rng = np.random.default_rng(1)
    sections = torch.from_numpy(
        (0.05 * rng.standard_normal((max(args.rows), s))).astype(np.float32)).to(dev)
    defaults = {"loudness": loudness.FFT_POINTS, "segment": correlate.SEGMENT_FFT_POINTS,
                "correlation": correlate.CORRELATION_FFT_POINTS}

    for rows in args.rows:
        x = sections[:rows]
        spec = correlate.section_segment_spectra(x, group.corr)
        sites = {
            "loudness": lambda: loudness._k_weighted_conv(x, loud),
            "segment": lambda: correlate.section_segment_spectra(x, group.corr),
            "correlation": lambda: correlate.cufft_correlation(x, group.corr, spec),
            "correlation_row_rerun": lambda: correlate.cufft_correlation(x, row_consts, spec),
        }
        for site, fn in sites.items():
            key = site.split("_")[0]
            for log2 in SETTINGS[key]:
                points = 1 << log2
                loudness.FFT_POINTS = points if key == "loudness" else defaults["loudness"]
                correlate.SEGMENT_FFT_POINTS = (points if key == "segment"
                                                else defaults["segment"])
                correlate.CORRELATION_FFT_POINTS = (points if key == "correlation"
                                                    else defaults["correlation"])
                n = loud.fft_len if key == "loudness" else group.corr.fft_len
                ms = graph_ms(fn, calls=4)
                print(json.dumps({"site": site, "rows": rows, "points": points,
                                  "transforms_per_call": cufft_plans.transforms_per_call(points, n),
                                  "default": points == defaults[key], "device_ms": ms}),
                      flush=True)
                torch.cuda.empty_cache()
        loudness.FFT_POINTS = defaults["loudness"]
        correlate.SEGMENT_FFT_POINTS = defaults["segment"]
        correlate.CORRELATION_FFT_POINTS = defaults["correlation"]
        del spec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
