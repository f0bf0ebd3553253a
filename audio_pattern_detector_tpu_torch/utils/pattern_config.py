"""Loader for `.apd.toml` pattern config files.

Schema parity with the reference loader
(reference: audio_pattern_detector/pattern_config.py): a TOML document with

* ``[clip]`` — Step-1 audio source: ``source = "sine"`` (synthesised at the
  target rate from frequency/duration/amplitude, Nyquist-checked) or
  ``source = "wav_base64"`` (inline WAV, whitespace-tolerant base64,
  resampled to the target rate).
* ``[verification]`` — Step-2 strategy (currently ``marker_tone``) with an
  optional declared dominant frequency and per-strategy thresholds.

Unknown fields are rejected at every level so configs stay versionable.

The implementation is table-driven: each section is described by a field
table (allowed keys, expected types, coercions) and walked by one generic
validator, so adding a schema field is a one-line table edit.
"""

from __future__ import annotations

import base64
import binascii
import tomllib
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
from numpy.typing import NDArray


APD_EXTENSION = ".apd.toml"

VALID_STRATEGIES: frozenset[str] = frozenset({"marker_tone"})
VALID_CLIP_SOURCES: frozenset[str] = frozenset({"sine", "wav_base64"})

_NUMBER: tuple[type, ...] = (int, float)

# ── Field tables ────────────────────────────────────────────────────────
# key -> accepted TOML types. One generic walker enforces these; the
# "unknown field" checks derive their valid-key lists from the same tables.

_CLIP_FIELDS_BY_SOURCE: dict[str, dict[str, tuple[type, ...]]] = {
    "sine": {
        "frequency_hz": _NUMBER,
        "duration_seconds": _NUMBER,
        "amplitude": _NUMBER,
    },
    "wav_base64": {
        "data": (str,),
    },
}

# threshold key -> coercion applied after type checking.
_THRESHOLD_COERCE: dict[str, Any] = {
    "minimum_band_purity": float,
    "minimum_active_frame_ratio": float,
    "minimum_longest_active_run": int,
    "minimum_active_frame_mean_purity": float,
    "maximum_min_flank_purity": float,
    "maximum_max_flank_purity": float,
}

VALID_VERIFICATION_THRESHOLDS: frozenset[str] = frozenset(_THRESHOLD_COERCE)

_VERIFICATION_FIELDS: frozenset[str] = VALID_VERIFICATION_THRESHOLDS | frozenset(
    {"strategy", "dominant_frequency_hz"}
)

_TOP_LEVEL_FIELDS: frozenset[str] = frozenset({"description", "clip", "verification"})


@dataclass(frozen=True)
class PatternConfig:
    """Parsed .apd.toml file."""

    strategy: str
    strategy_params: dict[str, Any]
    audio: NDArray[np.float32]


# ── Generic table walking ───────────────────────────────────────────────


def _typename(kind: "type | tuple[type, ...]") -> str:
    if isinstance(kind, type):
        return kind.__name__
    return "/".join(k.__name__ for k in kind)


def _field(
    table: dict[str, Any],
    key: str,
    kind: "type | tuple[type, ...]",
    path: str,
    *,
    required: bool = True,
) -> Any:
    """Fetch + type-check one field; ``None`` when optional and absent."""
    if key not in table:
        if required:
            raise ValueError(f"{path}: missing required field '{key}'")
        return None
    value = table[key]
    # bool is an int subclass, so `frequency_hz = true` would otherwise
    # pass every numeric check and synthesise a 1 Hz "tone" silently —
    # reject it explicitly (no schema field is boolean). The reference
    # validator shares the gotcha (reference: pattern_config.py:95); this
    # is stricter, in the spirit of its reject-at-every-level contract.
    if isinstance(value, bool) or not isinstance(value, kind):
        raise ValueError(
            f"{path}: field '{key}' must be {_typename(kind)}, "
            f"got {type(value).__name__}"
        )
    return value


def _reject_unknown(
    present: "set[str] | frozenset[str]",
    allowed: "set[str] | frozenset[str]",
    label: str,
    path: str,
    note: str = "",
) -> None:
    unknown = sorted(present - allowed)
    if unknown:
        raise ValueError(
            f"{path}: unknown {label} field(s): {unknown}. "
            f"Valid fields: {sorted(allowed)}{note}"
        )


# ── Clip sources ────────────────────────────────────────────────────────


def _synthesise_sine(
    table: dict[str, Any], sample_rate: int, path: str
) -> NDArray[np.float32]:
    frequency_hz = float(_field(table, "frequency_hz", _NUMBER, path))
    duration_seconds = float(_field(table, "duration_seconds", _NUMBER, path))
    amplitude_raw = _field(table, "amplitude", _NUMBER, path, required=False)
    amplitude = 0.9 if amplitude_raw is None else float(amplitude_raw)

    for name, value, ok in (
        ("frequency_hz", frequency_hz, frequency_hz > 0),
        ("duration_seconds", duration_seconds, duration_seconds > 0),
    ):
        if not ok:
            raise ValueError(f"{path}: {name} must be positive, got {value}")
    if frequency_hz * 2 >= sample_rate:
        raise ValueError(
            f"{path}: frequency_hz {frequency_hz} exceeds Nyquist "
            f"({sample_rate / 2}) for sample_rate {sample_rate}"
        )

    n = int(round(duration_seconds * sample_rate))
    # f32 time grid; the angular coefficient is computed in f64 but the
    # product/sin/scale all run in f32 (the f64 scalar is a weak type
    # against the f32 array) — BITWISE identical to the reference
    # synthesiser's expression (reference: pattern_config.py:106-108,
    # verified elementwise).
    t = np.arange(n, dtype=np.float32) / np.float32(sample_rate)
    wave = np.sin((2.0 * np.pi * frequency_hz) * t)
    return (amplitude * wave).astype(np.float32)


def _decode_wav_base64(
    table: dict[str, Any], sample_rate: int, path: str
) -> NDArray[np.float32]:
    from audio_pattern_detector_tpu_torch.utils.audio_io import (
        load_wav_from_bytes,
        resample_audio,
    )

    # Whitespace-tolerant so TOML triple-quoted strings can wrap the data.
    compact = "".join(str(_field(table, "data", str, path)).split())
    try:
        wav_bytes = base64.b64decode(compact, validate=True)
    except binascii.Error as e:
        raise ValueError(f"{path}: invalid base64 in [clip].data: {e}") from e

    audio, source_sr = load_wav_from_bytes(wav_bytes, name=path)
    return (
        audio
        if source_sr == sample_rate
        else resample_audio(audio, source_sr, sample_rate)
    )


_CLIP_BUILDERS = {
    "sine": _synthesise_sine,
    "wav_base64": _decode_wav_base64,
}


def _load_clip_audio(
    table: dict[str, Any], sample_rate: int, path: str
) -> NDArray[np.float32]:
    source = _field(table, "source", str, path)
    if source not in VALID_CLIP_SOURCES:
        raise ValueError(
            f"{path}: unknown [clip].source '{source}'. "
            f"Valid sources: {sorted(VALID_CLIP_SOURCES)}"
        )
    fields = _CLIP_FIELDS_BY_SOURCE[source]
    unknown = sorted(set(table) - set(fields) - {"source"})
    if unknown:
        raise ValueError(
            f"{path}: unknown [clip] field(s) for source='{source}': {unknown}. "
            f"Valid fields: {sorted(fields)}"
        )
    return _CLIP_BUILDERS[source](table, sample_rate, path)


# ── Verification section ────────────────────────────────────────────────


def _parse_verification(
    table: dict[str, Any], clip_table: dict[str, Any], clip_source: str, path: str
) -> tuple[str, dict[str, Any]]:
    _reject_unknown(set(table), _VERIFICATION_FIELDS, "[verification]", path)

    strategy = _field(table, "strategy", str, path)
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"{path}: unknown strategy '{strategy}'. "
            f"Valid strategies: {sorted(VALID_STRATEGIES)}"
        )

    params: dict[str, Any] = {}
    declared = _field(table, "dominant_frequency_hz", _NUMBER, path, required=False)
    if declared is not None:
        params["dominant_frequency_hz"] = float(declared)
    elif clip_source == "sine":
        # The declared generator frequency is authoritative for sine clips;
        # loaded audio otherwise gets its tone frequency derived on load.
        params["dominant_frequency_hz"] = float(clip_table["frequency_hz"])

    thresholds = {
        key: coerce(
            _field(table, key, (int,) if coerce is int else _NUMBER, path)
        )
        for key, coerce in sorted(_THRESHOLD_COERCE.items())
        if key in table
    }
    if thresholds:
        params["verification"] = thresholds
    return strategy, params


# ── Entry point ─────────────────────────────────────────────────────────


def load_apd_file(path: "str | Path", sample_rate: int) -> PatternConfig:
    """Parse an `.apd.toml` file into clip audio + strategy metadata."""
    source_path = str(path)
    with open(path, "rb") as f:
        try:
            doc = tomllib.load(f)
        except tomllib.TOMLDecodeError as e:
            raise ValueError(f"{source_path}: invalid TOML: {e}") from e

    _reject_unknown(
        set(doc),
        _TOP_LEVEL_FIELDS,
        "top-level",
        source_path,
        note=" (note: 'strategy' moved into [verification] in the v2 schema)",
    )

    clip_table: dict[str, Any] = _field(doc, "clip", dict, source_path)
    audio = _load_clip_audio(clip_table, sample_rate, source_path)

    verification: dict[str, Any] = _field(doc, "verification", dict, source_path)
    strategy, strategy_params = _parse_verification(
        verification, clip_table, str(clip_table["source"]), source_path
    )

    return PatternConfig(strategy=strategy, strategy_params=strategy_params, audio=audio)
