"""The flagship detection step, a twin of ``__graft_entry__.py::entry``.

A 64-clip bank (32 one-second normal clips of seeded noise, 32 quarter-
second marker tones at 900 + 7i Hz, numpy seed 0) scanning one 60 s chunk
section at 8 kHz (seeded noise, numpy seed 1): the same clips, bank
geometry and section as the JAX package's entry, built by the port.
:func:`flagship_round` is its batched twin: 16 such sections as one round.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from audio_pattern_detector_tpu_torch.models.detector import MARKER_TONE_STRATEGY
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
from audio_pattern_detector_tpu_torch.models.bank import PatternBank, class_step, class_step_fused
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan


def make_detector(
    num_normal: int,
    num_marker: int,
    chunk_seconds: int,
    device: "torch.device | str",
    sr: int = 8000,
) -> TorchAudioPatternDetector:
    """A detector over a mixed normal/marker clip bank (the serving path
    needs the detector: ``peaks_to_times`` and the clip metadata live
    there)."""
    rng = np.random.default_rng(0)
    clips = []
    for i in range(num_normal):
        audio = (0.4 * rng.standard_normal(sr)).astype(np.float32)  # 1 s
        clips.append(AudioClip(name=f"normal_{i}", audio=audio, sample_rate=sr))
    m = round(0.25 * sr)
    t = np.arange(m) / sr
    for i in range(num_marker):
        freq = 900.0 + 7.0 * i
        clips.append(
            AudioClip(
                name=f"marker_{i}",
                audio=np.sin(2 * np.pi * freq * t).astype(np.float32),
                sample_rate=sr,
                strategy=MARKER_TONE_STRATEGY,
                strategy_params={"dominant_frequency_hz": freq},
            )
        )
    return TorchAudioPatternDetector(clips, device=device, seconds_per_chunk=chunk_seconds)


def make_bank(
    num_normal: int,
    num_marker: int,
    chunk_seconds: int,
    device: "torch.device | str",
    sr: int = 8000,
) -> PatternBank:
    """The PatternBank of :func:`make_detector`'s detector."""
    return make_detector(num_normal, num_marker, chunk_seconds, device, sr)._ensure_bank()


def flagship_step(
    device: "torch.device | str",
) -> tuple[Callable[..., list[torch.Tensor]], PatternBank]:
    """(step, bank): ``step(scan=candidate_scan)`` runs the class step of
    the flagship bank over the seeded 60 s section and returns each
    group's packed payload."""
    bank = make_bank(num_normal=32, num_marker=32, chunk_seconds=60, device=device)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s = cls["section_len"]
    rng = np.random.default_rng(1)
    section = torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32)).to(bank.device)
    group_consts = tuple((g.corr, g.verify) for g in cls["groups"])

    def step(scan=candidate_scan) -> list[torch.Tensor]:
        return class_step(
            section, s, cls["loud"], group_consts,
            metas=bank._metas[sw], height_min=bank.height_min, scan=scan,
        )

    return step, bank


ROUND_ROWS = 16


def flagship_round(
    device: "torch.device | str",
) -> tuple[Callable[..., torch.Tensor], PatternBank, torch.Tensor]:
    """(step, bank, sections): ``step(mode, scan=candidate_scan)`` runs the
    flagship bank's class step over a round of 16 seeded 60 s sections
    (numpy seeds 1-16; row 0 is :func:`flagship_step`'s section), the
    (16, S) ``sections``, and returns the fused (16, total) payload:
    ``mode="vmap"`` as one batched step, ``"scan"`` as 16 steps one after
    another."""
    bank = make_bank(num_normal=32, num_marker=32, chunk_seconds=60, device=device)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s = cls["section_len"]
    sections = torch.from_numpy(np.stack([
        (0.05 * np.random.default_rng(1 + i).standard_normal(s)).astype(np.float32)
        for i in range(ROUND_ROWS)
    ])).to(bank.device)
    n_valids = torch.full((ROUND_ROWS,), s, dtype=torch.int32, device=bank.device)
    group_consts = tuple((g.corr, g.verify) for g in cls["groups"])

    def step(mode: str, scan=candidate_scan) -> torch.Tensor:
        def fused(section, n_valid) -> torch.Tensor:
            return class_step_fused(
                section, n_valid, cls["loud"], group_consts,
                metas=bank._metas[sw], height_min=bank.height_min, scan=scan,
            )

        if mode == "vmap":
            return fused(sections, n_valids)
        return torch.stack([fused(sections[i], s) for i in range(ROUND_ROWS)])

    return step, bank, sections
