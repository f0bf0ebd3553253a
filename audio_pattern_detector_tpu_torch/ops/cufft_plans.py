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

A row's bits do not depend on the round it rides in. cuFFT picks its
algorithm per plan, and a plan's batch is part of it, so each call site
runs its transforms in calls of a fixed number of transforms
(:func:`transforms_per_call`: a number of points the site names, over the
length), never the number of rows it was given: rows past the last whole
call are staged with zero transforms behind them. One plan gives a
transform the same bits at every index of its batch and on every call
(chip_smoke's ``round_invariance`` phase checks it).

The transforms are along the last axis, as ``torch.fft.rfft(x, n=n)`` and
``torch.fft.irfft(x, n=n)`` compute them ("backward" normalisation: the
inverse scaled by 1 / n). CPU tensors go to ``torch.fft``, which transforms
each row alone; the card never falls back to it, and a cuFFT error raises.
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
# Points a call holds where the caller names no call site's own.
DEFAULT_POINTS = 1 << 22

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


def transforms_per_call(points: int, n: int) -> int:
    """The fixed batch of a call site that gives each cuFFT call about
    ``points`` points: ``points // n`` transforms of n points, at least 1."""
    return max(1, points // n)


def _exec(inverse: bool, n: int, per_call: int, rows: torch.Tensor, out: torch.Tensor) -> None:
    """Transforms ``rows`` (a whole number of calls' rows) into ``out`` in
    calls of ``per_call`` transforms on one plan."""
    device = rows.device
    handle, work_bytes = plan(inverse, n, per_call, device)
    step_in = per_call * rows.shape[1] * rows.element_size()
    step_out = per_call * out.shape[1] * out.element_size()
    with device_guard(device):
        work = torch.empty(max(work_bytes, 1), dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        for call in range(rows.shape[0] // per_call):
            err = _lib().apd_fft_exec(handle, int(inverse), rows.data_ptr() + call * step_in,
                                      out.data_ptr() + call * step_out, work.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"cuFFT {'C2R' if inverse else 'R2C'} of {per_call} x {n} "
                                   f"points failed: cufftResult {err}")


def rfft(x: torch.Tensor, n: "int | None" = None, *, points: int = DEFAULT_POINTS) -> torch.Tensor:
    """``torch.fft.rfft(x, n=n)`` along the last axis of a float32 ``x``:
    (..., n // 2 + 1) complex64. On a card the transforms run in calls of
    ``transforms_per_call(points, n)``, the last call filled up with zero
    transforms."""
    if not x.is_cuda:
        return torch.fft.rfft(x, n=n)
    if x.dtype != torch.float32:
        raise ValueError(f"rfft: float32 input, got {x.dtype}")
    n = x.shape[-1] if n is None else n
    if n != x.shape[-1]:
        x = F.pad(x, (0, n - x.shape[-1])) if n > x.shape[-1] else x[..., :n]
    lead = x.shape[:-1]
    rows = x.reshape(-1, n).contiguous()
    r = rows.shape[0]
    per_call = transforms_per_call(points, n)
    whole = r - r % per_call
    out = torch.empty((-(-r // per_call) * per_call, n // 2 + 1), dtype=torch.complex64,
                      device=x.device)
    if whole:
        _exec(False, n, per_call, rows[:whole], out[:whole])
    if whole < r:
        tail = torch.zeros((per_call, n), dtype=torch.float32, device=x.device)
        tail[: r - whole] = rows[whole:]
        _exec(False, n, per_call, tail, out[whole:])
    return out[:r].view(*lead, n // 2 + 1)


def irfft(x: torch.Tensor, n: int, *, points: int = DEFAULT_POINTS) -> torch.Tensor:
    """``torch.fft.irfft(x, n=n)`` along the last axis of a complex64
    ``x`` of n // 2 + 1 bins: (..., n) float32. On a card the transforms run
    in calls of ``transforms_per_call(points, n)``, the last call filled up
    with zero transforms."""
    if not x.is_cuda:
        return torch.fft.irfft(x, n=n)
    bins = n // 2 + 1
    if x.dtype != torch.complex64 or x.shape[-1] != bins:
        raise ValueError(f"irfft: complex64 input of {bins} bins for n = {n}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    lead = x.shape[:-1]
    rows = x.reshape(-1, bins)
    r = rows.shape[0]
    per_call = transforms_per_call(points, n)
    padded = -(-r // per_call) * per_call
    # cuFFT's C2R overwrites its input: it transforms a copy.
    staged = torch.empty((padded, bins), dtype=torch.complex64, device=x.device)
    staged[:r] = rows
    staged[r:] = 0
    out = torch.empty((padded, n), dtype=torch.float32, device=x.device)
    if r:
        _exec(True, n, per_call, staged, out)
    return out[:r].view(*lead, n).mul_(1.0 / n)
