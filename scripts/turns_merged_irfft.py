#!/usr/bin/env python3
"""Time the JAX package's merged inverse FFT (``APD_MERGED_IRFFT``) against
the port's per-group transforms, in turns, on one CUDA card.

    python3 scripts/turns_merged_irfft.py [--turns 3]

The flagship round (64-clip bank, 16 seeded 60 s sections,
``flagship.flagship_round``) runs with the port's class step as it is (one
inverse FFT per group on the class's shared section spectra) and with
every group of the class through one batched inverse FFT, the JAX
package's ``_multi_group_abs`` (``ops/correlate.py:246-313`` there),
copied here and put in place of ``bank_correlate_abs`` for the run. The
order is merged, per-group, per-group, merged, repeated ``--turns``
times. Each timing is the mean of 2 synchronised rounds after a warm-up;
``vmap`` (one batched step a round) and ``scan`` (16 steps a round) are
timed in the same turns. Also reported: whether the payloads of the two
forms are bitwise equal, the largest difference of the raw correlations
relative to their max, and the peak memory of a round above the resident
bank. The port keeps the per-group form (PERF.md, section 6).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audio_pattern_detector_tpu_torch.flagship import flagship_round  # noqa: E402
from audio_pattern_detector_tpu_torch.models import bank as bank_mod  # noqa: E402
from audio_pattern_detector_tpu_torch.ops import correlate  # noqa: E402


def multi_group_abs(consts_list, seg_spec):
    """Every group of a shared-geometry class through one batched inverse
    FFT: each group's raw |corr|, (G, L) or (B, G, L), in group order."""
    first = consts_list[0]
    n, ns, step = first.fft_len, first.num_segments, first.step
    cat = torch.cat([c.bank_rfft_conj for c in consts_list], dim=0)  # (sum G, N//2+1)
    y = torch.fft.irfft(seg_spec[..., None, :, :] * cat[:, None, :], n=n)  # (..., sum G, ns, N)
    flat = y[..., :step].reshape(*y.shape[:-2], ns * step)
    out, g0 = [], 0
    for c in consts_list:
        g = c.bank_rfft_conj.shape[0]
        out.append(flat[..., g0 : g0 + g, c.out_offset : c.out_offset + c.full_len].abs())
        g0 += g
    return out


def merged_for(consts_list):
    """A stand-in for ``bank_correlate_abs`` in the class step: its first
    call on a section's spectra correlates every group of the class at
    once; the other groups' calls on the same spectra take their part."""
    held: dict = {}

    def merged_abs(section, n_valid, consts, seg_spec=None):
        if held.get("spec") is not seg_spec:
            held.clear()
            held["spec"] = seg_spec
            held["parts"] = dict(zip(map(id, consts_list), multi_group_abs(consts_list, seg_spec)))
        return held["parts"].pop(id(consts)), n_valid + consts.clip_len - 1

    return merged_abs


PER_GROUP = correlate.bank_correlate_abs


def use(fn) -> None:
    bank_mod.bank_correlate_abs = fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    step, bank, sections = flagship_round(dev)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    consts = [g.corr for g in cls["groups"]]
    forms = {"merged": merged_for(consts), "per_group": PER_GROUP}

    payloads, peak_gb = {}, {}
    for name, form in forms.items():
        use(form)
        step("vmap")  # warm-up: cuFFT plans of this batch
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        payloads[name] = {mode: step(mode).cpu() for mode in ("vmap", "scan")}
        peak_gb[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    equal = all(
        torch.equal(payloads["merged"][m].view(torch.int32), payloads["per_group"][m].view(torch.int32))
        for m in ("vmap", "scan")
    )

    # The raw correlations of the two forms on the round's normalised sections.
    lens = torch.full((sections.shape[0],), cls["section_len"], dtype=torch.int32, device=dev)
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    norm = loudness_normalize_device(sections, integrated_loudness_device(sections, lens, cls["loud"]))
    seg = correlate.section_segment_spectra(norm, consts[0])
    rel_err = max(
        float((a - PER_GROUP(None, lens, c, seg)[0]).abs().max() / a.max())
        for c, a in zip(consts, multi_group_abs(consts, seg))
    )
    del norm, seg

    def round_ms(mode: str) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2):
            step(mode)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 2 * 1e3

    times: dict[str, dict[str, list[float]]] = {f: {"vmap": [], "scan": []} for f in forms}
    for name in ("merged", "per_group", "per_group", "merged") * args.turns:
        use(forms[name])
        for mode in ("vmap", "scan"):
            times[name][mode].append(round_ms(mode))
    use(PER_GROUP)
    ahead = {
        mode: sum(m < p for m, p in zip(times["merged"][mode], times["per_group"][mode]))
        for mode in ("vmap", "scan")
    }
    print(json.dumps({
        "card": smi, "rows": sections.shape[0], "clips": sum(len(g.names) for g in cls["groups"]),
        "payloads_bitwise_equal": equal, "corr_max_rel_err": rel_err,
        "vmap_peak_gb_above_bank": peak_gb,
        "ms_per_round": {f: {m: float(np.median(v)) for m, v in t.items()} for f, t in times.items()},
        "ms_per_round_all": times, "merged_ahead_in_pairs": ahead,
        "pairs": 2 * args.turns,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
