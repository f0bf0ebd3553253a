"""Carry the JAX package's constants across to the port.

``consts_from_numpy(kind, fields, device)`` takes the fields of one JAX
consts dataclass (``CorrelationBankConsts``, ``LoudnessConsts``,
``NormalVerifyConsts`` or ``MarkerVerifyConsts``) with every array leaf
already converted by ``np.asarray``, and returns the port's dataclass of
the same name. It undoes the JAX package's transfer encodings: stacked
(re, im) f32 spectra become complex64, integers and masks uploaded as f32
become int64 and bool. The port's own builders give equal constants; this
converter is how the tests hold them to that.

``consts_to_device(consts, device)`` copies any of those dataclasses to
another torch device (the per-device replicas of a bank on a device mesh);
on the device the tensors already live on it returns the object itself.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from audio_pattern_detector_tpu_torch.ops.correlate import CorrelationBankConsts
from audio_pattern_detector_tpu_torch.ops.devices import canonical_device
from audio_pattern_detector_tpu_torch.ops.loudness import LoudnessConsts, gate_tables
from audio_pattern_detector_tpu_torch.ops.verify import (
    MarkerVerifyConsts,
    NormalVerifyConsts,
)


def _t(a: Any, dtype: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _complex(ri: np.ndarray, device: torch.device) -> torch.Tensor:
    ri = np.asarray(ri, dtype=np.float32)
    z = np.empty(ri.shape[1:], dtype=np.complex64)
    z.real, z.imag = ri[0], ri[1]
    return _t(z, np.complex64, device)


def consts_from_numpy(kind: str, fields: Mapping[str, Any], device: torch.device):
    f = fields
    if kind == "CorrelationBankConsts":
        return CorrelationBankConsts(
            bank_rfft_conj=_complex(f["bank_rfft_conj_ri"], device),
            self_corr_max=_t(f["self_corr_max"], np.float32, device),
            **{k: int(f[k]) for k in (
                "clip_len", "section_len", "fft_len", "full_len",
                "num_segments", "step", "pad_left", "out_offset",
            )},
        )
    if kind == "LoudnessConsts":
        lo, end = (np.array(f[k], dtype=np.int64) for k in ("block_lo", "block_end"))
        return LoudnessConsts(
            fir_spec=_complex(f["fir_rfft_ri"], device),
            block_lo=_t(lo, np.int64, device),
            block_end=_t(end, np.int64, device),
            block_thr=_t(f["block_thr"], np.int64, device),
            **gate_tables(int(f["section_len"]), lo, end, int(f["sample_rate"]), device),
            **{k: int(f[k]) for k in (
                "section_len", "sample_rate", "fft_len", "short_threshold", "num_segments",
            )},
        )
    if kind == "NormalVerifyConsts":
        return NormalVerifyConsts(
            corr_clip_partitions=_t(f["corr_clip_partitions"], np.float32, device),
            ds_clip=_t(f["ds_clip"], np.float32, device),
            seg_a=_t(np.asarray(f["seg_a"]), np.int64, device),
            seg_b=_t(np.asarray(f["seg_b"]), np.int64, device),
            is_short=bool(f["is_short"]),
            **{k: int(f[k]) for k in (
                "clip_len", "corr_len", "partition_size", "win_lo", "win_hi",
                "ds_n", "k_level",
            )},
        )
    if kind == "MarkerVerifyConsts":
        return MarkerVerifyConsts(
            band_whole=_t(np.asarray(f["band_whole"]) != 0, np.bool_, device),
            band_frame=_t(np.asarray(f["band_frame"]) != 0, np.bool_, device),
            frame_starts=tuple(int(s) for s in f["frame_starts"]),
            **{k: _t(f[k], np.float32, device) for k in (
                "hann_whole", "freqs_whole", "dom_freq", "lock_hz",
                "hann_frame", "freqs_frame", "thresholds",
            )},
            **{k: int(f[k]) for k in (
                "clip_len", "sample_rate", "frame_len", "frame_count",
            )},
        )
    raise ValueError(f"unknown consts kind {kind!r}")


def consts_to_device(consts: Any, device: torch.device) -> Any:
    """A consts dataclass with every tensor on ``device``; the object
    itself when nothing has to move."""
    device = canonical_device(device)
    moved = {
        f.name: getattr(consts, f.name).to(device)
        for f in dataclasses.fields(consts)
        if isinstance(getattr(consts, f.name), torch.Tensor)
        and getattr(consts, f.name).device != device
    }
    return dataclasses.replace(consts, **moved) if moved else consts
