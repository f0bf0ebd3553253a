#!/usr/bin/env python3
"""Where a round of B rows and the same rows in W-row pieces part, on the card.

    python3 scripts/probe_split_schedule.py [--rows 96 112] [--width 16]
                                            [--tier general|lean]

A round wider than the widest graph runs as W-row steps, captured or eager
(``models/captured.py::SplitRound``). For each width B, on the flagship
detector (64 clips, 60 s chunks; ``general``: ``height_min = 0``), this
runs B consecutive seeded 60 s noise chunks (numpy seeds 1..B, as
chip_smoke phase 17) through the eager vmap step as one batch of B rows
(``models/bank.py::GRAPH_ROWS`` raised to B) and in W-row pieces
(``GRAPH_ROWS`` = W), and prints one JSON line: the rows whose
payloads differ, per group the payload fields that differ (positions,
selected lanes, flag, verify overflow), and, per piece, the largest
difference of the class step's f32 intermediates between the two
schedules on the same sections: LUFS, the normalised section, and each
group's |correlation| over its largest value.

Prints the card's name and power limit first.
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[96, 112])
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--tier", choices=("general", "lean"), default="general")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: no card", flush=True)

    import torch

    from chip_smoke import noise_chunks
    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models import bank as bank_module
    from audio_pattern_detector_tpu_torch.models.bank import _split_fused
    from audio_pattern_detector_tpu_torch.ops.correlate import (
        bank_correlate_abs,
        section_segment_spectra,
    )
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    dev = torch.device("cuda")
    bank = make_detector(32, 32, 60, dev,
                         height_min=0.0 if args.tier == "general" else None)._ensure_bank()
    bank.capture = False
    (sw, cls), = bank.classes.items()
    groups = cls["groups"]

    def intermediates(rows: torch.Tensor, lens: torch.Tensor):
        lufs = integrated_loudness_device(rows, lens, cls["loud"])
        norm = loudness_normalize_device(rows, lufs)
        spec = section_segment_spectra(norm, groups[0].corr)
        return lufs, norm, [bank_correlate_abs(norm, lens, g.corr, spec)[0] for g in groups]

    def eager_round(chunks: list, width: int) -> list:
        bank_module.GRAPH_ROWS = width
        payloads = [rec[1].numpy().copy()
                    for rec in bank.dispatch_chunks_batch(chunks, None, "vmap")]
        torch.cuda.empty_cache()
        return payloads

    for b in args.rows:
        chunks = noise_chunks(b)
        one, pieces = eager_round(chunks, b), eager_round(chunks, args.width)
        out: dict = {"tier": args.tier, "rows": b, "width": args.width, "rows_differing": sorted(
            {int(i) for x, y in zip(one, pieces)
             for i in np.nonzero((x.view(np.int32) != y.view(np.int32)).any(axis=1))[0]})}
        for gi, (g, x, y) in enumerate(zip(groups, _split_fused(one[0], groups),
                                           _split_fused(pieces[0], groups))):
            _, _, col = np.nonzero(x.view(np.int32) != y.view(np.int32))
            k = g.k_verify
            out[f"group_{gi}_{g.kind}_fields"] = sorted(
                {"position" if c < k else "selected" if c < 2 * k else
                 "flag" if c == 2 * k else "verify_overflow" for c in col})
        raws = [bank._raw_section(sw, c, chunks[i - 1] if i else None)
                for i, c in enumerate(chunks)]
        rows = torch.from_numpy(bank._section_rows(cls["section_len"], raws).copy()).to(dev)
        lens = torch.tensor([len(r) for r in raws], dtype=torch.int32, device=dev)
        with torch.no_grad():
            lufs_a, norm_a, corr_a = intermediates(rows, lens)
            diffs: dict = {"lufs": [], "normalised_section": [],
                           **{f"correlation_{g.kind}_over_max": [] for g in groups}}
            for lo in range(0, b, args.width):
                hi = min(lo + args.width, b)
                lufs_b, norm_b, corr_b = intermediates(rows[lo:hi], lens[lo:hi])
                diffs["lufs"].append(float((lufs_a[lo:hi] - lufs_b).abs().max()))
                diffs["normalised_section"].append(float((norm_a[lo:hi] - norm_b).abs().max()))
                for g, ca, cb in zip(groups, corr_a, corr_b):
                    diffs[f"correlation_{g.kind}_over_max"].append(
                        float((ca[lo:hi] - cb).abs().max() / cb.abs().max()))
            del lufs_a, norm_a, corr_a
        out["max_difference_by_piece"] = diffs
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
