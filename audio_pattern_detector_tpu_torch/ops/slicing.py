"""Contiguous-window extraction (port of audio_pattern_detector_tpu/ops/slicing.py).

Starts are clamped to ``[0, L - width]`` as ``lax.dynamic_slice`` clamps
them, so callers that pre-clip see identical windows in both packages.
"""

from __future__ import annotations

import torch


def slice_rows_windows(
    x: torch.Tensor,  # (G, L)
    starts: torch.Tensor,  # (G, K) integer
    width: int,
) -> torch.Tensor:  # (G, K, width)
    """Per-row contiguous windows: out[g, k] = x[g, starts[g, k]:+width]."""
    g, l = x.shape
    s = starts.to(torch.int64).clamp(0, l - width)
    idx = s[..., None] + torch.arange(width, device=x.device)
    return torch.gather(x[:, None, :].expand(g, s.shape[1], l), 2, idx)


def slice_shared_windows(
    x: torch.Tensor,  # (L,) or (B, L)
    starts: torch.Tensor,  # (...,) integer
    width: int,
) -> torch.Tensor:  # (*starts.shape, width), after x's leading axes
    """Contiguous windows of a shared signal at arbitrary starts; a batch
    of signals takes the same windows of every row."""
    s = starts.to(torch.int64).clamp(0, x.shape[-1] - width)
    return x[..., s[..., None] + torch.arange(width, device=x.device)]
