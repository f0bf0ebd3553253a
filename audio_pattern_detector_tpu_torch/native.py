"""Native host runtime bindings (ctypes) with pure-numpy fallback.

Drop-in equivalent of the reference's ``audio_pattern_detector._native``
module surface (reference: native-helper/src/python.rs:183-206, stubs at
native-helper/native_helper.pyi): ``find_peaks``, ``resample``,
``resample_preserve_maxima``, ``simpson``, ``integrated_loudness``,
``loudness_normalize``, ``pearson_correlation``.

Sequential/branchy ops dispatch to the C++ library (the package's
``csrc/apd_native.cpp``), which g++ builds at first use into
``build/apd_native/`` at the root of a checkout (the user's cache directory
for an installed copy, ``kernels/_build.py::build_root``), keyed by a hash
of the source and flags. FFT-based resampling stays in numpy f64
(ops/hostref.py). When the library cannot be built or loaded everything
takes the exact numpy implementations, so the package works source-only:
that path is host code with the same results, not a device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.kernels._build import build_root
from audio_pattern_detector_tpu_torch.ops import hostref

__all__ = [
    "find_peaks",
    "resample",
    "resample_preserve_maxima",
    "simpson",
    "integrated_loudness",
    "loudness_normalize",
    "biquad_f64",
    "pack_pcm16_into",
    "pearson_correlation",
    "pcm16_to_f32_mono",
    "pcm32_to_f32_mono",
    "native_available",
    "build_native",
]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "apd_native.cpp"
BUILD_DIR = build_root() / "apd_native"
# -ffp-contract=off keeps apd_biquad_f64 bitwise equal to scipy's lfilter
# (FMA contraction would change the rounding of its recurrence);
# -fno-math-errno lets gcc inline nearbyintf/rint without changing results.
CXX_FLAGS = (
    "-O3", "-march=native", "-fno-math-errno", "-Wall", "-Wextra",
    "-ffp-contract=off", "-fPIC", "-std=c++17", "-fvisibility=hidden", "-shared",
)
_lib: "ctypes.CDLL | None" = None
_unavailable = False  # a build or load failed; numpy serves every call


def _so_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"apd_native_{h.hexdigest()[:16]}.so"

_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_f64p = ctypes.POINTER(ctypes.c_double)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_i16p = ctypes.POINTER(ctypes.c_int16)
_c_i32p = ctypes.POINTER(ctypes.c_int32)


def build_native(force: bool = False) -> bool:
    """Compile the C++ runtime with g++ into ``BUILD_DIR``. Returns success."""
    target = _so_path()
    if target.exists() and not force:
        return True
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename: concurrent first uses
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                check=True, capture_output=True,
            )
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


def _load() -> "ctypes.CDLL | None":
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    # One attempt per process: without g++ every call takes numpy.
    _unavailable = True
    if not build_native():
        return None
    try:
        lib = ctypes.CDLL(str(_so_path()))
    except OSError:
        return None
    lib.apd_abi_version.restype = ctypes.c_int64
    if lib.apd_abi_version() != 1:
        return None
    lib.apd_integrated_loudness.restype = ctypes.c_double
    lib.apd_integrated_loudness.argtypes = [
        _c_f32p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
    ]
    lib.apd_loudness_normalize.restype = None
    lib.apd_loudness_normalize.argtypes = [
        _c_f32p, ctypes.c_int64, ctypes.c_double, ctypes.c_double, _c_f32p,
    ]
    lib.apd_find_peaks.restype = ctypes.c_int64
    lib.apd_find_peaks.argtypes = [
        _c_f32p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double,
        _c_i64p, ctypes.c_int64,
    ]
    lib.apd_pearson.restype = ctypes.c_double
    lib.apd_pearson.argtypes = [_c_f32p, _c_f32p, ctypes.c_int64]
    lib.apd_simpson.restype = ctypes.c_double
    lib.apd_simpson.argtypes = [_c_f64p, ctypes.c_int64]
    lib.apd_resample_preserve_maxima.restype = None
    lib.apd_resample_preserve_maxima.argtypes = [
        _c_f32p, ctypes.c_int64, _c_f32p, ctypes.c_int64,
    ]
    lib.apd_pcm16_to_f32_mono.restype = None
    lib.apd_pcm16_to_f32_mono.argtypes = [
        _c_i16p, ctypes.c_int64, ctypes.c_int, _c_f32p,
    ]
    lib.apd_pcm32_to_f32_mono.restype = None
    lib.apd_pcm32_to_f32_mono.argtypes = [
        _c_i32p, ctypes.c_int64, ctypes.c_int, _c_f32p,
    ]
    # apd_biquad_f64 / apd_pack_pcm16 are later additions within ABI 1 —
    # a stale .so simply lacks the symbols, in which case the scipy /
    # numpy paths take over (same bits).
    if hasattr(lib, "apd_biquad_f64"):
        lib.apd_biquad_f64.restype = None
        lib.apd_biquad_f64.argtypes = [
            _c_f64p, _c_f64p, _c_f64p, ctypes.c_int64, _c_f64p,
        ]
    if hasattr(lib, "apd_pack_pcm16"):
        lib.apd_pack_pcm16.restype = ctypes.c_int
        lib.apd_pack_pcm16.argtypes = [
            _c_f32p, ctypes.c_int64, ctypes.c_int64, _c_i16p,
        ]
    _lib = lib
    _unavailable = False
    return _lib


def native_available() -> bool:
    return _load() is not None


def _as_f32(x: NDArray[Any]) -> NDArray[np.float32]:
    return np.ascontiguousarray(x, dtype=np.float32)


# ── API (reference _native surface) ──────────────────────────────────


def find_peaks(
    data: NDArray[Any],
    *,
    height: "float | None" = None,
    distance: "int | None" = None,
    prominence: "float | None" = None,
) -> tuple[NDArray[np.int64], dict[str, Any]]:
    lib = _load()
    if lib is None:
        return hostref.find_peaks(
            data, height=height, distance=distance, prominence=prominence
        )
    x = _as_f32(data)
    cap = max(len(x) // 2 + 1, 16)
    out = np.empty(cap, dtype=np.int64)
    n = lib.apd_find_peaks(
        x.ctypes.data_as(_c_f32p),
        len(x),
        int(height is not None), float(height or 0.0),
        int(distance is not None), int(distance or 0),
        int(prominence is not None), float(prominence or 0.0),
        out.ctypes.data_as(_c_i64p), cap,
    )
    if n < 0:  # capacity overflow cannot happen with cap = n/2+1, but be safe
        return hostref.find_peaks(
            data, height=height, distance=distance, prominence=prominence
        )
    return out[:n].copy(), {}


def resample(data: NDArray[Any], num_samples: int) -> NDArray[np.float32]:
    # FFT path: exact numpy f64 implementation (scipy slice rule).
    return hostref.resample(data, num_samples)


def resample_preserve_maxima(data: NDArray[Any], num_samples: int) -> NDArray[np.float32]:
    if num_samples <= 0:
        raise ValueError("num_samples must be greater than 0")
    lib = _load()
    x = _as_f32(data)
    if len(x) == 0:
        raise ValueError("input must be non-empty")
    if lib is None:
        return hostref.resample_preserve_maxima(x, num_samples)
    out = np.empty(num_samples, dtype=np.float32)
    lib.apd_resample_preserve_maxima(
        x.ctypes.data_as(_c_f32p), len(x), out.ctypes.data_as(_c_f32p), num_samples
    )
    return out


def simpson(y: NDArray[Any]) -> float:
    lib = _load()
    if lib is None:
        return hostref.simpson(y)
    v = np.ascontiguousarray(y, dtype=np.float64)
    return float(lib.apd_simpson(v.ctypes.data_as(_c_f64p), len(v)))


def integrated_loudness(
    data: NDArray[Any], sample_rate: int, block_size: float = 0.4
) -> float:
    lib = _load()
    if lib is None:
        return hostref.integrated_loudness(data, sample_rate, block_size)
    x = _as_f32(data)
    return float(
        lib.apd_integrated_loudness(
            x.ctypes.data_as(_c_f32p), len(x), float(sample_rate), float(block_size)
        )
    )


def loudness_normalize(
    data: NDArray[Any], current_lufs: float, target_lufs: float
) -> NDArray[np.float32]:
    lib = _load()
    if lib is None:
        return hostref.loudness_normalize(data, current_lufs, target_lufs)
    x = _as_f32(data)
    out = np.empty_like(x)
    lib.apd_loudness_normalize(
        x.ctypes.data_as(_c_f32p), len(x), float(current_lufs), float(target_lufs),
        out.ctypes.data_as(_c_f32p),
    )
    return out


def biquad_f64(
    b: NDArray[np.float64], a: NDArray[np.float64], x: NDArray[np.float64]
) -> "NDArray[np.float64] | None":
    """Order-2 lfilter (zero state), bit-identical to scipy's DF2T.

    Returns None when the native library (or the symbol, on a stale
    build) is unavailable — callers fall back to scipy / pure python.
    Exists so the CLI's per-clip BS.1770 preparation (models/detector.py
    init) never pays the ~2 s scipy.signal import at cold start.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "apd_biquad_f64"):
        return None
    bv = np.ascontiguousarray(b, dtype=np.float64)
    av = np.ascontiguousarray(a, dtype=np.float64)
    xv = np.ascontiguousarray(x, dtype=np.float64)
    if len(bv) != 3 or len(av) != 3 or av[0] != 1.0:
        return None
    out = np.empty_like(xv)
    lib.apd_biquad_f64(
        bv.ctypes.data_as(_c_f64p),
        av.ctypes.data_as(_c_f64p),
        xv.ctypes.data_as(_c_f64p),
        len(xv),
        out.ctypes.data_as(_c_f64p),
    )
    return out


def pack_pcm16_into(
    x: NDArray[np.float32], out: NDArray[np.int16]
) -> "bool | None":
    """Quantise f32 samples onto the int16/32768 grid into ``out``
    (zero-filling the tail past ``len(x)``), single C++ pass.

    Returns True/False for exact/lossy, or None when the native library
    (or symbol) is unavailable — callers use the numpy path then.
    Semantics match ops/packing.py::try_pack_pcm16 exactly.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "apd_pack_pcm16"):
        return None
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        x = np.ascontiguousarray(x, dtype=np.float32)
    # Real checks (not assert): these guard a raw C write — under
    # python -O an undersized/wrong-dtype out buffer would corrupt the
    # heap (the C++ side zero-fills out[n:total]).
    if out.dtype != np.int16 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous int16 array")
    if len(x) > len(out):
        raise ValueError(f"len(x)={len(x)} exceeds len(out)={len(out)}")
    return bool(
        lib.apd_pack_pcm16(
            x.ctypes.data_as(_c_f32p),
            len(x),
            len(out),
            out.ctypes.data_as(_c_i16p),
        )
    )


def pearson_correlation(x: NDArray[Any], y: NDArray[Any]) -> float:
    if len(x) != len(y):
        raise ValueError("arrays must have the same length")
    lib = _load()
    if lib is None:
        return hostref.pearson_correlation(x, y)
    a, b = _as_f32(x), _as_f32(y)
    return float(lib.apd_pearson(a.ctypes.data_as(_c_f32p), b.ctypes.data_as(_c_f32p), len(a)))


# ── PCM conversion (data loader) ─────────────────────────────────────


def pcm16_to_f32_mono(raw: NDArray[np.int16], channels: int = 1) -> NDArray[np.float32]:
    """Interleaved int16 PCM -> float32 mono mean-mix."""
    x = np.ascontiguousarray(raw, dtype=np.int16)
    frames = len(x) // channels
    lib = _load()
    if lib is None:
        f = x[: frames * channels].astype(np.float32) / 32768.0
        return f.reshape(-1, channels).mean(axis=1).astype(np.float32) if channels > 1 else f
    out = np.empty(frames, dtype=np.float32)
    lib.apd_pcm16_to_f32_mono(
        x.ctypes.data_as(_c_i16p), frames, channels, out.ctypes.data_as(_c_f32p)
    )
    return out


def pcm32_to_f32_mono(raw: NDArray[np.int32], channels: int = 1) -> NDArray[np.float32]:
    """Interleaved int32 PCM -> float32 mono mean-mix."""
    x = np.ascontiguousarray(raw, dtype=np.int32)
    frames = len(x) // channels
    lib = _load()
    if lib is None:
        f = x[: frames * channels].astype(np.float32) / 2147483648.0
        return f.reshape(-1, channels).mean(axis=1).astype(np.float32) if channels > 1 else f
    out = np.empty(frames, dtype=np.float32)
    lib.apd_pcm32_to_f32_mono(
        x.ctypes.data_as(_c_i32p), frames, channels, out.ctypes.data_as(_c_f32p)
    )
    return out
