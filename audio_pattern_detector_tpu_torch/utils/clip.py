"""Clip and stream models.

Functional parity with the reference clip layer
(reference: audio_pattern_detector/audio_clip.py): a frozen ``AudioClip``
value object carrying float32 audio plus an optional verification strategy,
and ``AudioStream`` — any named readable byte stream of float32 mono PCM.

Construction is organised as free loader functions returning
(name, audio, strategy, params) tuples, dispatched on extension, with the
dataclass itself kept as a pure value type.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Protocol

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.utils.audio_io import (
    DEFAULT_TARGET_SAMPLE_RATE,
    load_wav_from_bytes,
    load_wave_file,
    resample_audio,
)
from audio_pattern_detector_tpu_torch.utils.pattern_config import APD_EXTENSION, load_apd_file


class ReadableStream(Protocol):
    """Anything with a bytes ``read(size)``."""

    def read(self, size: int, /) -> bytes: ...


def _resampled_to(
    audio: NDArray[np.float32], source_sr: int, target_sr: int
) -> NDArray[np.float32]:
    return audio if source_sr == target_sr else resample_audio(audio, source_sr, target_sr)


def _load_pattern_clip(path: "str | Path", sample_rate: int) -> "AudioClip":
    # Strip the compound extension ("x.apd.toml" -> "x").
    name = Path(str(path)[: -len(APD_EXTENSION)]).name
    cfg = load_apd_file(path, sample_rate=sample_rate)
    return AudioClip(
        name=name,
        audio=cfg.audio,
        sample_rate=sample_rate,
        strategy=cfg.strategy,
        strategy_params=cfg.strategy_params,
    )


def _load_audio_clip(path: "str | Path", sample_rate: int) -> "AudioClip":
    return AudioClip(
        name=Path(path).stem,
        audio=load_wave_file(str(path), expected_sample_rate=sample_rate),
        sample_rate=sample_rate,
    )


@dataclass(frozen=True)
class AudioClip:
    name: str
    audio: NDArray[np.float32]
    sample_rate: int
    # Non-None when loaded from an `.apd.toml` pattern config; selects the
    # Step-2 verification path (e.g. "marker_tone").
    strategy: str | None = None
    strategy_params: dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_audio_file(
        clip_path: "str | Path", sample_rate: int | None = None
    ) -> "AudioClip":
        """Load a clip; `.apd.toml` files parse as pattern configs, other
        extensions decode as audio."""
        rate = DEFAULT_TARGET_SAMPLE_RATE if sample_rate is None else sample_rate
        loader = (
            _load_pattern_clip
            if str(clip_path).lower().endswith(APD_EXTENSION)
            else _load_audio_clip
        )
        return loader(clip_path, rate)

    @staticmethod
    def from_wav_bytes(
        wav_bytes: bytes, name: str, sample_rate: int | None = None
    ) -> "AudioClip":
        """Load a clip from in-memory WAV bytes, resampling to target rate."""
        rate = DEFAULT_TARGET_SAMPLE_RATE if sample_rate is None else sample_rate
        audio, source_sr = load_wav_from_bytes(wav_bytes, name)
        return AudioClip(
            name=name, audio=_resampled_to(audio, source_sr, rate), sample_rate=rate
        )

    def clip_length_seconds(self) -> float:
        return len(self.audio) / self.sample_rate


@dataclass(frozen=True)
class AudioStream:
    """A named readable byte stream of mono PCM at ``sample_rate``.

    Bytes are float32 samples by default. A source that yields raw 16-bit
    PCM can stream int16 bytes instead (``sample_dtype`` int16, or an
    ``output_dtype`` attribute on the wrapped reader): the engine then
    skips the host f32 decode AND the f32→int16 re-quantise of the packed
    upload — the int16 passthrough fast path, bit-identical results (the
    device unpack IS the pinned int16→f32 decode; ops/packing.py)."""

    name: str
    audio_stream: ReadableStream  # raw mono PCM bytes at sample_rate
    sample_rate: int
    # None = auto: the wrapped reader's ``output_dtype`` attribute if
    # present, else float32.
    sample_dtype: "Any" = None

    def resolved_dtype(self) -> np.dtype:
        """The dtype of the bytes ``audio_stream.read`` yields."""
        if self.sample_dtype is not None:
            return _validate_stream_dtype(self.sample_dtype)
        return resolve_reader_dtype(self.audio_stream)


def _validate_stream_dtype(d: Any) -> np.dtype:
    d = np.dtype(d)
    if d not in (np.dtype(np.float32), np.dtype(np.int16)):
        raise ValueError(f"unsupported stream sample dtype {d}")
    return d


def resolve_reader_dtype(reader: Any) -> np.dtype:
    """Sample dtype a raw reader yields (its ``output_dtype`` attribute,
    default float32) — the ONE validated resolver every engine path uses
    (AudioStream.resolved_dtype and the parallel multi-file scan)."""
    return _validate_stream_dtype(
        getattr(reader, "output_dtype", np.float32)
    )
