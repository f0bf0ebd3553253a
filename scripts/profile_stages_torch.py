#!/usr/bin/env python3
"""The class step's device time split by stage, on the port (the torch
twin of ``scripts/profile_stages.py``).

    python3 scripts/profile_stages_torch.py                  # on the card
    python3 scripts/profile_stages_torch.py --device cpu     # CPU smoke size
    python3 scripts/profile_stages_torch.py --checkout DIR   # another checkout's port

Runs the lean class step of ``models/bank.py::class_step`` stage by stage
on the inputs the step gives each stage, and times each stage alone:

* ``k_weighting``: ``ops/loudness.py::_k_weighted_conv``'s transforms;
* ``gate``: ``loudness_gate`` (``csrc/loudness_gate.cu``);
* ``normalize``: ``loudness_normalize_device``;
* ``segment_spectra``: ``ops/correlate.py::section_segment_spectra``;
* per group (``<g>_<kind>``, its index and kind): ``correlation_<g>_<kind>``
  (the bank product, the inverse transforms and ``abs``), ``scan_<g>_<kind>``
  (the candidate scan), ``lean_greedy_<g>_<kind>`` and ``lean_tail_<g>_<kind>``
  (bounds, compaction, the verify and the payload, as the eager step runs
  them: every group verifies);

and the whole eager step. On a card each time is the device ms of one call
from CUDA events around replays of a CUDA graph of repeated calls (the
eager step does the captured step's device work, less the verify a
captured candidate-free group skips); on the CPU it is host ms per call,
named ``cpu_ms``, which says nothing of a card. Beside each stage: its
bound (the bytes it must move, each input read once and each output
written once, over 3.35 TB/s, or for the transforms 2.5 N log2 N
operations a real transform over 67 T/s, whichever is larger) and its
share of the whole step. Three shapes:

* ``one_clip_file_mode``: file mode's one-clip bank (the CBS clip, G = 1),
  one 60 s chunk's section;
* ``flagship_step``: the 64-clip flagship bank, one seeded 60 s section
  (candidate-free);
* ``flagship_round``: the same bank, 16 such sections as one batched step;

and, named with ``--shapes``, ``rainbow_file_mode``: file mode's bank of the
29,488-sample rainbow intro clip, one 60 s chunk's section (fft_len
131,072).

The CPU smoke size cuts the chunks to 4 s, the flagship bank to 2 + 2
clips and the round to 3 rows. Prints the card's name and power limit,
then one JSON line a shape. ``chip_smoke.py`` runs :func:`stage_split` as
a phase.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_bounds import HBM_BYTES_PER_S, lean_greedy_bound, scan_bound_ms  # noqa: E402

PEAK_F32_OPS = 67e12  # H100 SXM f32 outside the tensor cores
SHAPES = ("one_clip_file_mode", "flagship_step", "flagship_round")
# One-clip banks, file mode's: the CBS clip (8,000 samples: fft_len 32,768)
# and, off the default shapes, the 29,488-sample rainbow intro clip
# (fft_len 131,072: 6 segments of a 60 s section).
ONE_CLIP_FILES = {"one_clip_file_mode": "cbs_news.wav",
                  "rainbow_file_mode": "天空下的彩虹intro.wav"}
CALLS = 10  # calls a timed graph holds
REPS = 5  # timed replays, median


def _bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _fft_ms(transforms: int, n: int) -> float:
    return transforms * 2.5 * n * math.log2(n) / PEAK_F32_OPS * 1e3


def _bound(nbytes: float, ops_ms: float = 0.0) -> tuple[float, str]:
    b = _bytes_ms(nbytes)
    return (b, "bytes") if b >= ops_ms else (ops_ms, "operations")


def _timer(device):
    """ms of one call of ``fn``: device ms from CUDA events around replays
    of a graph of :data:`CALLS` calls on a card, host ms on the CPU."""
    import torch

    if device.type != "cuda":
        def host_ms(fn) -> float:
            fn()
            times = []
            for _ in range(REPS):
                t = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t) * 1e3)
            return float(np.median(times))
        return host_ms

    def device_ms(fn) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CALLS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        del graph
        return float(np.median(times))
    return device_ms


def split_step(bank, sw: int, section, n_valid, timer) -> dict:
    """Each stage of the lean class step of class ``sw`` on ``section``
    (B, S) with lengths ``n_valid`` (B,): {stage: (ms, bound ms, bound
    by)}, and the whole eager step's ms."""
    import torch

    from audio_pattern_detector_tpu_torch.models.bank import _SMALL_TIER, _lean_tail, class_step
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.correlate import (
        _correlate_raw,
        section_segment_spectra,
    )
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        _k_weighted_conv,
        loudness_gate,
        loudness_normalize_device,
    )
    from audio_pattern_detector_tpu_torch.ops.peaks import f32

    if not (bank.height_min > 0 and bank.kernel_tier):
        raise ValueError("the stage split follows the lean kernel tier")
    cls = bank.classes[sw]
    loud, groups = cls["loud"], cls["groups"]
    group_consts = tuple((g.corr, g.verify) for g in groups)
    metas = bank._metas[sw]
    b, s = section.shape
    valid = int(n_valid.clamp(0, s).sum())
    stages: dict[str, tuple[float, float, str]] = {}

    def stage(name: str, fn, bound):
        """Run ``fn`` once, time it, and record it beside ``bound(out)``."""
        out = fn()
        stages[name] = (timer(fn), *bound(out))
        return out

    segs = loud.num_segments
    filtered = stage("k_weighting", lambda: _k_weighted_conv(section, loud), lambda _: _bound(
        2 * b * s * 4 + loud.fir_spec.numel() * 8, _fft_ms(2 * b * segs, loud.fft_len)))
    lufs = stage("gate", lambda: loudness_gate(filtered, n_valid, loud),
                 lambda _: _bound(valid * 4 + b * 8))
    norm = stage("normalize", lambda: loudness_normalize_device(section, lufs),
                 lambda _: _bound(2 * b * s * 4 + b * 4))
    c0 = group_consts[0][0]
    spec = None
    if len({(c.fft_len, c.step, c.pad_left, c.num_segments) for c, _ in group_consts}) == 1 and all(
            c.num_segments > 1 and c.pad_left >= 0 and c.step > 0 for c, _ in group_consts):
        spec = stage("segment_spectra", lambda: section_segment_spectra(norm, c0),
                     lambda out: _bound(b * s * 4 + out.numel() * 8,
                                        _fft_ms(b * c0.num_segments, c0.fft_len)))
    hm = f32(bank.height_min)
    for gi, ((kind, m, k_detect, k_verify), (cc, verify_consts)) in enumerate(
            zip(metas, group_consts)):
        g, tag = cc.bank_rfft_conj.shape[0], f"{gi}_{kind}"
        corr = stage(f"correlation_{tag}", lambda: _correlate_raw(norm, cc, spec),
                     lambda out: _bound(b * cc.num_segments * (cc.fft_len // 2 + 1) * 8
                                        + cc.bank_rfft_conj.numel() * 8 + out.numel() * 4,
                                        _fft_ms(b * g * cc.num_segments, cc.fft_len)))
        corr = corr.reshape(b * g, -1)
        valid_len = (n_valid.to(torch.int32) + m - 1)[:, None].expand(b, g).reshape(b * g)
        valid_len = valid_len.contiguous()
        self_corr_max = cc.self_corr_max.repeat(b)
        thr = hm * self_corr_max
        bmax, _count, plateau_min, omax, near = stage(
            f"scan_{tag}", lambda: candidate_scan(corr, thr, valid_len),
            lambda _: (scan_bound_ms(b * g, corr.shape[1], valid_len), "bytes"))
        denom = torch.maximum(self_corr_max, omax).clamp_min(1e-38)
        args = (corr, valid_len, bmax, denom, hm, m, min(_SMALL_TIER, k_detect))
        pos, height, overflow = stage(f"lean_greedy_{tag}", lambda: lean_greedy(*args),
                                      lambda out: lean_greedy_bound(args, out)[:2])
        needs_full = ~plateau_min & (overflow | near)
        flag = torch.where(plateau_min, 1.0, torch.where(needs_full, 2.0, 0.0))

        def tail_bound(payload, k_verify=k_verify, m=m, pos=pos):
            # The lane arrays read, the payload written, and each live
            # lane's window and clip read once.
            live = int((payload[:, :k_verify] < 2**30).sum())
            return _bound(pos.numel() * (pos.element_size() + 8) + payload.numel() * 4
                          + live * 2 * m * 4)

        stage(f"lean_tail_{tag}",
              lambda: _lean_tail(norm, corr, valid_len, kind, m, k_verify, verify_consts, pos,
                                 height, flag, args[-1], denom=denom), tail_bound)
    step_ms = timer(lambda: class_step(section, n_valid, loud, group_consts, metas=metas,
                                       height_min=bank.height_min))
    return {"stages": stages, "step_ms": step_ms}


def shape_inputs(name: str, device, smoke: bool = False):
    """(bank, sw, sections (B, S), lengths (B,)) of one shape."""
    import torch

    from audio_pattern_detector_tpu_torch.flagship import make_bank
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.utils.audio_io import load_wave_file
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    chunk = 60 if not smoke else 10 if name == "rainbow_file_mode" else 4  # the clip is 3.7 s
    if name in ONE_CLIP_FILES:
        clip = load_wave_file(str(ROOT / "sample_audios" / "clips" / ONE_CLIP_FILES[name]), 8000)
        named = AudioClip(name=Path(ONE_CLIP_FILES[name]).stem, audio=clip, sample_rate=8000)
        bank = TorchAudioPatternDetector([named], device=device,
                                         seconds_per_chunk=chunk)._ensure_bank()
        seeds = (2,)
    else:
        bank = make_bank(2, 2, chunk, device) if smoke else make_bank(32, 32, chunk, device)
        seeds = (1,) if name == "flagship_step" else tuple(range(1, (3 if smoke else 16) + 1))
    sw = sorted(bank.classes)[0]
    s = bank.classes[sw]["section_len"]
    rows = np.stack([(0.05 * np.random.default_rng(k).standard_normal(s)).astype(np.float32)
                     for k in seeds])
    return (bank, sw, torch.from_numpy(rows).to(device),
            torch.full((len(seeds),), s, dtype=torch.int32, device=device))


def stage_split(device, shapes=SHAPES, smoke: bool = False) -> list[dict]:
    """One record a shape: each stage's ms (``device_ms`` on a card,
    ``cpu_ms`` on the CPU), bound and share of the whole step, the sum of
    the stages and the whole step's ms."""
    import gc

    import torch

    device = torch.device(device)
    timer = _timer(device)
    key = "device_ms" if device.type == "cuda" else "cpu_ms"
    out = []
    for name in shapes:
        bank, sw, sections, lens = shape_inputs(name, device, smoke)
        split = split_step(bank, sw, sections, lens, timer)
        step_ms = split["step_ms"]
        stages = [{"stage": stage, key: ms, "bound_ms": bound, "bound_by": by,
                   "share_of_bound": bound / ms if ms > 0 else None,
                   "share_of_step": ms / step_ms if step_ms > 0 else None}
                  for stage, (ms, bound, by) in split["stages"].items()]
        out.append({"shape": name, "rows": int(sections.shape[0]),
                    "clips": sum(len(g.names) for g in bank.classes[sw]["groups"]),
                    "section_len": int(sections.shape[1]), "stages": stages,
                    f"sum_of_stages_{key}": sum(st[key] for st in stages),
                    f"step_{key}": step_ms})
        del bank, sections, lens, split
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return out


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (smoke size)")
    ap.add_argument("--checkout", type=Path, default=ROOT,
                    help="the checkout whose port is split (default: this one)")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=SHAPES + ("rainbow_file_mode",))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.checkout.resolve()))

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("profile_stages_torch: no CUDA card (use --device cpu for the smoke size)",
                  file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    print(card, flush=True)
    for record in stage_split(args.device, args.shapes, smoke=args.device != "cuda"):
        print(json.dumps({"card": card, "checkout": str(args.checkout), **record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
