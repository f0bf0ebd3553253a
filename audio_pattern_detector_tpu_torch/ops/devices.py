"""Explicit torch devices: comparing them and making one current.

The port has no global device. Every tensor op runs where its inputs
live, but two things follow the process's *current* CUDA device instead:
a raw kernel launch through ctypes, and ``torch.cuda.current_stream()``.
Code that enqueues work on a device other than the bank's own (the shards
of a device mesh) does so under :func:`device_guard`.
"""

from __future__ import annotations

import contextlib

import torch


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


def canonical_device(device: "torch.device | str") -> torch.device:
    """``device`` with its index filled in (``cuda`` -> the current CUDA
    device), so that it compares equal to ``tensor.device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_guard(device: "torch.device | str"):
    """Context manager that makes a CUDA ``device`` current (and restores
    the previous one); nothing to do for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
