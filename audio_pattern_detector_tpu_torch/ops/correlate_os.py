"""The overlap-save correlation's second half: the bank product, the inverse
transforms and the kept samples' ``abs`` (``csrc/correlate_os.cu``).

Given a section batch's segment spectra (B, ns, N/2 + 1) (or one section's,
(ns, N/2 + 1)), a group's conjugate clip spectra (G, N/2 + 1) and the
class geometry (N = ``fft_len``, ``step``, ``off`` = ``out_offset``, L =
``full_len``), :func:`correlate_os` returns (B, G, L) (or (G, L)) f32::

    out[b, g, k] = |y_{b,g,s}[t]|   for k + off = s step + t, 0 <= t < step
    y_{b,g,s}    = irfft_N(seg[b, s] * bank[g])   ("backward" scaling, 1 / N)

On a CUDA tensor it launches the kernel: one CTA a transform up to N =
32,768, past it a cluster of :func:`cluster_size` CTAs over distributed
shared memory; the product formed as the spectra load, the Hermitian half
spectrum folded into an N/2-point complex spectrum and transformed by
Stockham passes in shared memory (radix 4, two passes at a time in
registers; in a cluster one pass exchanges the values between its CTAs),
only the kept samples' magnitudes written. It takes N a
power of two up to :data:`MAX_FFT_LEN` and raises for any other, as it
does if the kernel does not build or launch; it never carries on in
another route. A CPU tensor takes the plain version, whose transforms are
``torch.fft``'s.

Which geometries reach it on a card is ``ops/correlate.py::_correlate_raw``'s
rule: the overlap-save branch at the lengths :func:`kernel_takes`, the
29,488-sample rainbow intro clip's 131,072 points among them. The
single-FFT branch and a larger N stay on cuFFT there, and count their
calls.

The plain version (:func:`correlate_os_reference`) is the port's code
before the kernel: the product in device memory, ``ops/cufft_plans.py``'s
inverse transforms in calls of ``ops/correlate.py::CORRELATION_FFT_POINTS``
points, the slice and ``abs``. The kernel's bits are not cuFFT's; each
transform is computed alone and the same way at any index and cluster size,
so a row's bits do not depend on its round. ``chip_smoke.np_correlate_os``
transliterates the kernel's arithmetic in numpy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from audio_pattern_detector_tpu_torch.ops.cufft_plans import irfft
from audio_pattern_detector_tpu_torch.ops.devices import device_guard
from audio_pattern_detector_tpu_torch.ops.marker_fft import RealPlan, plan_tables

# The largest fft_len the kernel takes: N / 2 complex values over a cluster
# of MAX_CLUSTER CTAs, MAX_LOCAL a CTA (128 KB of shared memory).
MAX_CLUSTER = 8  # the portable cluster size
MAX_LOCAL = 1 << 14
MAX_FFT_LEN = 2 * MAX_LOCAL * MAX_CLUSTER
# Complex values a thread holds across a pass (csrc/correlate_os.cu
# kPerThread): a CTA has MAX_LOCAL / PER_THREAD = 1,024 threads at most.
PER_THREAD = 16


def kernel_takes(fft_len: int) -> bool:
    """Whether the kernel computes a geometry of ``fft_len`` points on a
    card: a power of two from 4 to :data:`MAX_FFT_LEN`."""
    return 4 <= fft_len <= MAX_FFT_LEN and fft_len & (fft_len - 1) == 0


def cluster_size(n: int) -> int:
    """The CTAs a transform of ``n`` points takes, as ``apd_correlate_os``
    derives them: one while its N/2 complex values fit one CTA
    (:data:`MAX_LOCAL`, N up to 32,768), past that N/2 / :data:`MAX_LOCAL`
    CTAs of 128 KB each (2 at 65,536 points, 4 at 131,072, 8 at 262,144).
    A function of N alone, never of the round or the group."""
    return max(1, n // 2 // MAX_LOCAL)


def launch_geometry(b: int, g: int, ns: int, n: int) -> tuple[int, int, int, int]:
    """(cluster size C, CTAs, threads a CTA, dynamic shared-memory bytes a
    CTA) of a launch, as ``apd_correlate_os`` sets them: a cluster of
    :func:`cluster_size` CTAs a transform, each holding N / (2 C) complex
    values, :data:`PER_THREAD` a thread (at least a warp)."""
    c = cluster_size(n)
    local = n // 2 // c
    return c, b * g * ns * c, max(32, local // PER_THREAD), local * 8


def residency(n: int) -> tuple[int, int]:
    """(CTAs an SM, clusters the card) that a launch of ``n`` points keeps
    resident at once, by the CUDA occupancy calculator on the current
    card."""
    import ctypes

    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = load_kernels().lib.apd_correlate_os_residency(n, ctypes.byref(ctas),
                                                        ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"correlate_os residency query failed: CUDA error {err}")
    return ctas.value, clusters.value


def correlation_radices(half: int) -> tuple[int, ...]:
    """The Stockham radices of the kernel's N/2-point transform: 4s, then
    one 2 where ``half`` is not a power of 4 (the kernel derives the same
    plan from N/2 and runs two radix-4 passes in a row in registers)."""
    if half < 2 or half & (half - 1):
        raise ValueError(f"correlate_os: a transform of {half} points, not a power of two >= 2")
    out = []
    while half % 4 == 0:
        out.append(4)
        half //= 4
    return tuple(out) + ((2,) if half == 2 else ())


@dataclass(frozen=True)
class CorrelationPlan:
    """The kernel's plan for one fft_len: its radices and its tables (one
    f32 tensor on the device, complex values interleaved; see
    :func:`correlation_tables`)."""

    n: int
    radices: tuple
    tables: torch.Tensor


def correlation_tables(n: int, radices: tuple) -> np.ndarray:
    """The kernel's f32 tables for fft_len ``n``: the N/2 + 1 separation
    twiddles exp(-2 pi i k / N) of ``ops/marker_fft.py::plan_tables`` (f64,
    stored as f32), then for each pass (radix R after p points) the
    twiddles it multiplies by, W[r k N / (2 p R)] at k (R - 1) + r - 1 for
    k < p and 1 <= r < R, W[t] = exp(-2 pi i t / (N/2)) as ``plan_tables``
    rounds it, gathered so a pass reads them contiguously."""
    half = n // 2
    tables = plan_tables(RealPlan(n, True, half, 0, radices))
    w = tables["twiddles"].reshape(-1, 2)
    parts, p = [tables["post"]], 1
    for r in radices:
        at = np.arange(1, r)[None, :] * np.arange(p)[:, None] * (half // (p * r))
        parts.append(w[at.reshape(-1)].reshape(-1))
        p *= r
    return np.concatenate(parts)


def _build(n: int, device: torch.device) -> CorrelationPlan:
    radices = correlation_radices(n // 2)
    return CorrelationPlan(n, radices, torch.from_numpy(correlation_tables(n, radices)).to(device))


@functools.lru_cache(maxsize=16)
def _cached(n: int, device: torch.device) -> CorrelationPlan:
    return _build(n, device)


# The plans whose tables captured CUDA graphs read (models/captured.py),
# kept for the life of the process: a graph holds the tables' address.
_CAPTURED_PLANS: dict[tuple, CorrelationPlan] = {}


def correlation_plan(n: int, device: torch.device) -> CorrelationPlan:
    """The cached plan of ``n`` points on ``device``; one read while a graph
    is captured is kept past the cache's eviction."""
    key = (n, device)
    plan = _CAPTURED_PLANS.get(key) or _cached(*key)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        _CAPTURED_PLANS[key] = plan
    return plan


def correlate_os_reference(
    seg_spec: torch.Tensor, bank_conj: torch.Tensor, n: int, step: int, off: int, full_len: int
) -> torch.Tensor:
    """The plain version on any device: the product (..., G, ns, N/2 + 1),
    the inverse transforms (cuFFT in calls of a fixed batch on a card,
    ``torch.fft`` on the CPU), the kept samples and ``abs``."""
    from audio_pattern_detector_tpu_torch.ops.correlate import CORRELATION_FFT_POINTS

    ns = seg_spec.shape[-2]
    y = irfft(seg_spec[..., None, :, :] * bank_conj[:, None, :], n=n,
              points=CORRELATION_FFT_POINTS)  # (..., G, ns, N)
    flat = y[..., :step].reshape(*y.shape[:-2], ns * step)
    return flat[..., off : off + full_len].abs()


def _launch(
    seg_spec: torch.Tensor, bank_conj: torch.Tensor, n: int, step: int, off: int, full_len: int
) -> torch.Tensor:
    """One launch of ``csrc/correlate_os.cu`` (CUDA tensors; it raises on
    anything the kernel does not take and on a CUDA error)."""
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    dev = seg_spec.device
    bins = n // 2 + 1
    if not kernel_takes(n):
        raise ValueError(f"correlate_os: the kernel takes fft_len a power of two from 4 to "
                         f"{MAX_FFT_LEN}, got {n}")
    if (seg_spec.dtype != torch.complex64 or seg_spec.dim() not in (2, 3)
            or seg_spec.shape[-1] != bins or not seg_spec.is_contiguous()):
        raise ValueError(f"correlate_os: segment spectra must be contiguous complex64 (..., ns, "
                         f"{bins}), got {seg_spec.dtype} {tuple(seg_spec.shape)}")
    if (bank_conj.dtype != torch.complex64 or bank_conj.dim() != 2
            or bank_conj.shape[-1] != bins or not bank_conj.is_contiguous()
            or bank_conj.device != dev):
        raise ValueError(f"correlate_os: the bank must be contiguous complex64 (G, {bins}) on "
                         f"{dev}, got {bank_conj.dtype} {tuple(bank_conj.shape)} on "
                         f"{bank_conj.device}")
    ns = seg_spec.shape[-2]
    if not (1 <= step <= n and off >= 0 and ns * step >= full_len + off and full_len >= 0):
        raise ValueError(f"correlate_os: geometry step {step}, off {off}, {ns} segments does not "
                         f"cover {full_len} samples of fft_len {n}")
    b = seg_spec.shape[0] if seg_spec.dim() == 3 else 1
    g = bank_conj.shape[0]
    plan = correlation_plan(n, dev)
    lib = load_kernels().lib
    with device_guard(dev):
        out = torch.empty((b, g, full_len), dtype=torch.float32, device=dev)
        if b * g * full_len:
            err = lib.apd_correlate_os(
                seg_spec.data_ptr(), b, ns, bank_conj.data_ptr(), g, n, step, off, full_len,
                plan.tables.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"correlate_os kernel launch failed: CUDA error {err}")
            correlate_os.launches += 1
    return out if seg_spec.dim() == 3 else out[0]


def correlate_os(
    seg_spec: torch.Tensor, bank_conj: torch.Tensor, n: int, step: int, off: int, full_len: int
) -> torch.Tensor:
    """|overlap-save correlation| (..., G, L) f32 from segment spectra
    (..., ns, N/2 + 1) and a group's conjugate spectra (G, N/2 + 1): the
    kernel for CUDA tensors (it raises for an fft_len it does not take,
    :func:`kernel_takes`), the plain version for CPU tensors."""
    if seg_spec.device.type == "cuda":
        return _launch(seg_spec, bank_conj, n, step, off, full_len)
    if seg_spec.device.type == "cpu":
        return correlate_os_reference(seg_spec, bank_conj, n, step, off, full_len)
    raise ValueError(f"correlate_os: unsupported device {seg_spec.device}")


# Kernels the card ran: one per launch of the wrapper, and for each replay
# of a captured class step the launches its graph holds
# (models/captured.py). The plain version counts nothing.
correlate_os.launches = 0
