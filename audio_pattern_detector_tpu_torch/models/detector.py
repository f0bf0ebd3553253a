"""The streaming detector on a torch device.

A subclass of the JAX package's ``AudioPatternDetector`` that overrides
only ``_ensure_bank``: the clip preprocessing (host, f64), the streaming
loop ``find_clip_in_audio`` with its pipelining and stream batching, the
offline ``find_clip_in_array`` and the timestamp algebra are reused
unchanged. The device is explicit and never silently replaced: asking
for ``cuda`` without a CUDA device raises.
"""

from __future__ import annotations

import torch

from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils.clip import AudioClip
from audio_pattern_detector_tpu_torch.models.bank import PatternBank


def resolve_device(device: "torch.device | str") -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False (pass device='cpu' to run the plain torch path)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


class TorchAudioPatternDetector(AudioPatternDetector):
    """Two-step streaming pattern detector running its device work in torch."""

    def __init__(
        self,
        audio_clips: list[AudioClip],
        *,
        device: "torch.device | str",
        debug_mode: bool = False,
        **kwargs,
    ) -> None:
        if debug_mode:
            raise NotImplementedError(
                "debug mode runs the JAX package's host path; the torch port "
                "does not support it yet"
            )
        self.device = resolve_device(device)
        super().__init__(audio_clips, debug_mode=False, **kwargs)

    def _ensure_bank(self) -> PatternBank:
        if self._bank is None:
            self._bank = PatternBank(
                clip_datas=self._clip_datas,
                tone_frequencies=self._tone_frequencies,
                strategy_params=self._clip_strategy_params,
                sample_rate=self.target_sample_rate,
                chunk_samples=int(self.seconds_per_chunk * self.target_sample_rate),
                height_min=self.height_min if self.height_min is not None else 0.25,
                device=self.device,
            )
        return self._bank
