"""Section upload with on-device int16 decode.

Port of the decode half of audio_pattern_detector_tpu/ops/packing.py. A
CUDA device takes int16 uploads as they are, so 16-bit PCM rows cross as
int16 (half the bytes of f32) and decode on the device. The decode is a
cast and then a power-of-two scale, bitwise equal to
``native.pcm16_to_f32_mono`` and to the JAX package's in-graph unpack.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.typing import NDArray

PCM_SCALE = 32768.0


def pcm16_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int16 samples -> f32 in [-1, 1)."""
    return x.to(torch.float32) * (1.0 / PCM_SCALE)


def upload_rows(rows: NDArray, device: torch.device) -> torch.Tensor:
    """Host rows (int16 or f32) -> device tensor of the same dtype, copied
    on the current stream of ``device`` with ``non_blocking``. From pinned
    memory (the bank's staging pool) the copy returns at once and runs in
    stream order, so the caller must leave the rows unchanged until that
    stream has passed it; from pageable memory it returns once the rows
    are read. On the CPU the tensor shares the rows' memory."""
    if rows.dtype not in (np.int16, np.float32):
        raise TypeError(f"section rows must be int16 or float32, got {rows.dtype}")
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device, non_blocking=True)


def as_f32(x: torch.Tensor) -> torch.Tensor:
    """An uploaded row in f32: int16 rows decode, f32 rows pass through."""
    return pcm16_to_f32(x) if x.dtype == torch.int16 else x
