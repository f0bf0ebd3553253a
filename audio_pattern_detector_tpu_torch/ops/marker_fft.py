"""The FFT plans of the fused marker-verifier kernel (``csrc/verify_marker.cu``).

The kernel makes the magnitude rfft of a live lane's three m-sample
windows and of its match window's F frames of ``wl`` samples itself, in
shared memory (or, where a lane's work area does not fit there, in a
global workspace of one slot per resident CTA). m is any integer, so a
real transform of length n runs as:

* a complex transform of n / 2 points where n is even (the even samples as
  the real part, the odd ones as the imaginary part), then one pass that
  separates the two halves' spectra (:data:`post` twiddles), else a
  complex transform of n points with a zero imaginary part;
* that complex transform as a mixed-radix Stockham FFT (radix 8, 4 and 2,
  then 3, 5, 7 and every odd prime up to :data:`MAX_PRIME`), or, for a
  length with a larger prime factor, Bluestein's chirp-z transform through
  a power-of-two FFT of M >= 2N - 1 points.

A plan's tables are built on the host in f64 and stored as f32, complex
values interleaved: the twiddles of the transform that runs (exp(-2 pi i
t / L), L = N or M), the separation twiddles exp(-2 pi i k / n), and for
Bluestein the chirp exp(-i pi (j^2 mod 2N) / N) (the square reduced in
integers, the angle taken in f64) and its spectrum over M, FFT_M(b) / M
with b the conjugate chirp wrapped around M. :func:`marker_plan` caches a
lane layout and its tables by (m, wl, frame count, device); a table that a
captured CUDA graph reads (the graph holds its address) stays in
``_CAPTURED_PLANS`` for the life of the process, whatever the cache evicts.

``chip_smoke.np_marker_fft`` transliterates the kernel's arithmetic on a
plan in numpy; ``tests/test_torch_marker_fft.py`` holds it against
``np.fft.rfft`` and its decisions against the plain verifier.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

# The odd primes a Stockham pass takes as a radix (a generic butterfly of
# R^2 complex products); a length with a larger prime factor is Bluestein's.
MAX_PRIME = 31
_RADICES = (8, 4, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31)
# Passes a plan may hold (csrc/verify_marker.cu kMaxRadices).
MAX_RADICES = 24

# Shared memory a lane's work area may take: the window, two work buffers
# and the per-frame results, within the 227 KB a block may opt in to, less
# the lane list and the reductions' static arrays.
SMEM_BUDGET = 208 * 1024
# Frames whose per-frame results (2 floats a frame) stay in shared memory
# (csrc/verify_marker.cu kMaxFrames); a clip with more (past 51 s at 8 or
# 16 kHz) keeps them in its global workspace slot.
MAX_FRAMES = 4096


def radices(n: int) -> "tuple[int, ...] | None":
    """The Stockham radix sequence of a complex length n (8s, 4s and 2s
    first, then the odd primes in order), or None where n has a prime factor
    past :data:`MAX_PRIME`."""
    if n < 1:
        raise ValueError(f"a transform of {n} points")
    out = []
    for r in _RADICES:
        while n % r == 0:
            out.append(r)
            n //= r
    return tuple(out) if n == 1 else None


@dataclass(frozen=True)
class RealPlan:
    """How the kernel transforms a real window of ``n`` samples."""

    n: int
    half: bool  # n even: a complex transform of n / 2 points
    size: int  # N, the complex transform's length
    bluestein: int  # M, 0 for a direct Stockham transform of N points
    radices: tuple  # of N, or of M under Bluestein

    @property
    def work(self) -> int:
        """Complex values one transform's work area holds: N or M."""
        return self.bluestein or self.size

    @property
    def bins(self) -> int:
        return self.n // 2 + 1


def real_plan(n: int) -> RealPlan:
    """The plan of a real transform of n samples (n >= 2)."""
    if n < 2:
        raise ValueError(f"a real transform of {n} samples")
    half = n % 2 == 0
    size = n // 2 if half else n
    rad = radices(size)
    if rad is not None:
        return RealPlan(n, half, size, 0, rad)
    m = 1 << (2 * size - 2).bit_length()  # the least power of two >= 2N - 1
    return RealPlan(n, half, size, m, radices(m))


def _interleave(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).reshape(-1).astype(np.float32)


def _roots(length: int, count: "int | None" = None) -> np.ndarray:
    """exp(-2 pi i t / length), t = 0 .. count - 1, in f64."""
    t = np.arange(length if count is None else count, dtype=np.float64)
    return np.exp(-2j * np.pi * t / length)


def chirp(size: int) -> np.ndarray:
    """exp(-i pi (j^2 mod 2N) / N), j < N, in f64: the square reduced in
    integers, so the angle never loses the low bits of j^2."""
    j = np.arange(size, dtype=np.int64)
    return np.exp(-1j * np.pi * ((j * j) % (2 * size)).astype(np.float64) / size)


def plan_tables(plan: RealPlan) -> dict[str, np.ndarray]:
    """A plan's f32 tables, complex values interleaved: ``twiddles`` (L),
    ``post`` (n / 2 + 1, even n only), ``chirp`` (N) and ``chirp_spectrum``
    (M) under Bluestein."""
    tables = {"twiddles": _interleave(_roots(plan.work))}
    if plan.half:
        tables["post"] = _interleave(_roots(plan.n, plan.n // 2 + 1))
    if plan.bluestein:
        c = chirp(plan.size)
        b = np.zeros(plan.bluestein, dtype=np.complex128)
        b[: plan.size] = np.conj(c)
        b[plan.bluestein - plan.size + 1:] = np.conj(c[1:])[::-1]
        tables["chirp"] = _interleave(c)
        tables["chirp_spectrum"] = _interleave(np.fft.fft(b) / plan.bluestein)
    return tables


class PlanDesc(ctypes.Structure):
    """One real plan as the kernel reads it (csrc/verify_marker.cu
    ``RealPlan``): offsets are in floats into the launch's table."""

    _fields_ = [("n", ctypes.c_int), ("half", ctypes.c_int), ("size", ctypes.c_int),
                ("bluestein", ctypes.c_int), ("nrad", ctypes.c_int),
                ("rad", ctypes.c_int * MAX_RADICES), ("off_twiddles", ctypes.c_int),
                ("off_post", ctypes.c_int), ("off_chirp", ctypes.c_int),
                ("off_chirp_spectrum", ctypes.c_int)]


@dataclass(frozen=True)
class MarkerLayout:
    """A lane's work area in the fused kernel, in floats: the raw 3m-sample
    window, then two work buffers of ``buffer`` floats each. The three
    whole windows are transformed ``whole_batch`` at a time (3 or 1), the
    frames ``frame_batch`` at a time; ``on_chip`` False puts the work area
    in a global workspace of one slot per resident CTA, and
    ``frames_on_chip`` False the per-frame results after it in the slot."""

    whole: RealPlan
    frame: "RealPlan | None"
    frame_count: int
    whole_batch: int
    frame_batch: int
    buffer: int
    on_chip: bool
    frames_on_chip: bool = True

    @property
    def window(self) -> int:
        """Floats of the raw window, 3m rounded up to 4 (the buffers'
        complex values stay 16-byte aligned)."""
        return -(-3 * self.whole.n // 4) * 4

    @property
    def frame_floats(self) -> int:
        """Floats of the per-frame results."""
        return 2 * self.frame_count

    @property
    def slot(self) -> int:
        """Floats of one lane's work area (the window and two buffers, and
        the per-frame results where they are not on the chip)."""
        return self.window + 2 * self.buffer + (0 if self.frames_on_chip else self.frame_floats)

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory a CTA takes: the work area where it is on
        the chip, and the per-frame results where they are."""
        return 4 * ((self.slot if self.on_chip else 0)
                    + (self.frame_floats if self.frames_on_chip else 0))


def _buffer(whole: RealPlan, frame: "RealPlan | None", wb: int, fb: int) -> int:
    need = wb * 2 * whole.work
    if frame is not None:
        need = max(need, fb * 2 * frame.work)
    return -(-need // 4) * 4


def marker_layout(m: int, wl: int, frame_count: int) -> MarkerLayout:
    """The layout of a lane of clip length m with ``frame_count`` frames of
    wl samples: all three whole windows at once where that fits the shared
    memory budget, else one at a time, else a global workspace; the frames
    in batches of at most the whole windows' buffer, their results in
    shared memory up to :data:`MAX_FRAMES` frames, else in the workspace."""
    if frame_count > m:  # frames start a sample apart at the least
        raise ValueError(f"verify_marker: {frame_count} frames, more than the clip's {m} "
                         "samples")
    whole = real_plan(m)
    frame = real_plan(wl) if frame_count > 0 else None
    for wb in (3, 1) if frame_count <= MAX_FRAMES else ():
        fb = 0
        if frame is not None:
            fb = min(frame_count, max(1, wb * whole.work // frame.work))
        buf = _buffer(whole, frame, wb, fb)
        layout = MarkerLayout(whole, frame, frame_count, wb, fb, buf, True)
        if layout.shared_bytes <= SMEM_BUDGET:
            return layout
    fb = frame_count if frame is not None else 0
    return MarkerLayout(whole, frame, frame_count, 3, fb, _buffer(whole, frame, 3, fb), False,
                        frame_count <= MAX_FRAMES)


def _desc(plan: RealPlan, offsets: dict[str, int]) -> PlanDesc:
    if len(plan.radices) > MAX_RADICES:
        raise ValueError(f"verify_marker: {len(plan.radices)} passes, past {MAX_RADICES}")
    d = PlanDesc(n=plan.n, half=int(plan.half), size=plan.size, bluestein=plan.bluestein,
                 nrad=len(plan.radices))
    for i, r in enumerate(plan.radices):
        d.rad[i] = r
    d.off_twiddles = offsets["twiddles"]
    d.off_post = offsets.get("post", -1)
    d.off_chirp = offsets.get("chirp", -1)
    d.off_chirp_spectrum = offsets.get("chirp_spectrum", -1)
    return d


@dataclass(frozen=True)
class MarkerPlan:
    """A lane layout, the two plans' descriptors and their tables (one f32
    tensor on the device)."""

    layout: MarkerLayout
    whole: PlanDesc
    frame: PlanDesc
    tables: torch.Tensor


def _build(m: int, wl: int, frame_count: int, device: torch.device) -> MarkerPlan:
    layout = marker_layout(m, wl, frame_count)
    parts: list[np.ndarray] = []
    descs = []
    for plan in (layout.whole, layout.frame):
        if plan is None:
            descs.append(PlanDesc())
            continue
        offsets = {}
        for name, table in plan_tables(plan).items():
            offsets[name] = sum(len(p) for p in parts)
            parts.append(table)
        descs.append(_desc(plan, offsets))
    tables = torch.from_numpy(np.concatenate(parts)).to(device)
    return MarkerPlan(layout, descs[0], descs[1], tables)


@functools.lru_cache(maxsize=16)
def _cached(m: int, wl: int, frame_count: int, device: torch.device) -> MarkerPlan:
    return _build(m, wl, frame_count, device)


# The plans whose tables captured CUDA graphs read (models/captured.py),
# kept for the life of the process: a graph holds the tables' address.
_CAPTURED_PLANS: dict[tuple, MarkerPlan] = {}


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def marker_plan(m: int, wl: int, frame_count: int, device: torch.device) -> MarkerPlan:
    """The cached plan of a clip length, frame length and frame count on
    ``device``; one read while a graph is captured is kept past the
    cache's eviction."""
    key = (m, wl, frame_count, device)
    plan = _CAPTURED_PLANS.get(key) or _cached(*key)
    if _capturing(device):
        _CAPTURED_PLANS[key] = plan
    return plan
