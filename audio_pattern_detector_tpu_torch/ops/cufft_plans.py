"""The class step's real FFTs: cuFFT plans the port holds on a card,
``torch.fft`` on the CPU.

A captured CUDA graph replays the kernels of the cuFFT plans its capture
used, and those kernels read device memory that each plan owns. torch
keeps its plans in its cuFFT plan cache, which any code in the process can
clear (``torch.backends.cuda.cufft_plan_cache[i].clear()``) or evict by
making transforms of other sizes; a replay after that reads freed memory
and can fault. So :func:`rfft` and :func:`irfft` run on a card through
plans made here (``csrc/cufft_plans.cu``): cached by (direction, length,
batch, device), and a plan used while a graph is captured stays in
``_CAPTURED`` for the life of the process, whatever the cache evicts. Each
call takes its cuFFT work area from torch's allocator (a capture's from
the graph's pool, which the graph holds).

The transforms are along the last axis, as ``torch.fft.rfft(x, n=n)`` and
``torch.fft.irfft(x, n=n)`` compute them ("backward" normalisation: the
inverse scaled by 1 / n). CPU tensors go to ``torch.fft``; the card never
falls back to it, and a cuFFT error raises.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict

import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops.devices import device_guard

# Plans the cache keeps beyond those captured graphs replay.
CACHE_SIZE = 64

_lock = threading.Lock()
_cache: "OrderedDict[tuple, tuple[int, int]]" = OrderedDict()
# (inverse, n, batch, device) -> (handle, work bytes) of the plans captured
# graphs replay: never destroyed.
_CAPTURED: dict[tuple, tuple[int, int]] = {}


def _lib():
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    return load_kernels().lib


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def plan(inverse: bool, n: int, batch: int, device: torch.device) -> tuple[int, int]:
    """(handle, work bytes) of the plan of ``batch`` transforms of n points
    on ``device``: the cached one, else a new one (the least recently used
    plan past :data:`CACHE_SIZE` destroyed, unless a graph replays it). One
    used while a graph is captured is kept for the life of the process."""
    key = (bool(inverse), int(n), int(batch), device)
    with _lock:
        found = _CAPTURED.get(key) or _cache.get(key)
        if found is None:
            handle, work = ctypes.c_longlong(), ctypes.c_ulonglong()
            with device_guard(device):
                err = _lib().apd_fft_plan(int(inverse), n, batch, ctypes.byref(handle),
                                          ctypes.byref(work))
            if err != 0:
                raise RuntimeError(f"cuFFT plan of {batch} x {n} points "
                                   f"({'C2R' if inverse else 'R2C'}) failed: cufftResult {err}")
            found = (handle.value, work.value)
        if key not in _CAPTURED:
            _cache[key] = found
            _cache.move_to_end(key)
            if _capturing(device):
                _CAPTURED[key] = _cache.pop(key)
        while len(_cache) > CACHE_SIZE:
            _, (old, _) = _cache.popitem(last=False)
            _lib().apd_fft_destroy(old)
        return found


def clear_cache() -> None:
    """Destroys the cached plans that no captured graph replays."""
    with _lock:
        while _cache:
            _, (handle, _) = _cache.popitem()
            _lib().apd_fft_destroy(handle)


def _exec(inverse: bool, n: int, rows: torch.Tensor, out: torch.Tensor) -> None:
    device = rows.device
    handle, work_bytes = plan(inverse, n, rows.shape[0], device)
    with device_guard(device):
        work = torch.empty(max(work_bytes, 1), dtype=torch.uint8, device=device)
        err = _lib().apd_fft_exec(handle, int(inverse), rows.data_ptr(), out.data_ptr(),
                                  work.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuFFT {'C2R' if inverse else 'R2C'} of {rows.shape[0]} x {n} "
                           f"points failed: cufftResult {err}")


def rfft(x: torch.Tensor, n: "int | None" = None) -> torch.Tensor:
    """``torch.fft.rfft(x, n=n)`` along the last axis of a float32 ``x``:
    (..., n // 2 + 1) complex64."""
    if not x.is_cuda:
        return torch.fft.rfft(x, n=n)
    if x.dtype != torch.float32:
        raise ValueError(f"rfft: float32 input, got {x.dtype}")
    n = x.shape[-1] if n is None else n
    if n != x.shape[-1]:
        x = F.pad(x, (0, n - x.shape[-1])) if n > x.shape[-1] else x[..., :n]
    lead = x.shape[:-1]
    rows = x.reshape(-1, n).contiguous()
    out = torch.empty((*lead, n // 2 + 1), dtype=torch.complex64, device=x.device)
    if rows.shape[0]:
        _exec(False, n, rows, out)
    return out


def irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.fft.irfft(x, n=n)`` along the last axis of a complex64
    ``x`` of n // 2 + 1 bins: (..., n) float32."""
    if not x.is_cuda:
        return torch.fft.irfft(x, n=n)
    bins = n // 2 + 1
    if x.dtype != torch.complex64 or x.shape[-1] != bins:
        raise ValueError(f"irfft: complex64 input of {bins} bins for n = {n}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    lead = x.shape[:-1]
    # cuFFT's C2R overwrites its input: it transforms a copy.
    rows = x.reshape(-1, bins).clone(memory_format=torch.contiguous_format)
    out = torch.empty((*lead, n), dtype=torch.float32, device=x.device)
    if rows.shape[0]:
        _exec(True, n, rows, out)
    return out.mul_(1.0 / n)
