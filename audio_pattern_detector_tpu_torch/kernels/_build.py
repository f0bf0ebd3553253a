"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``audio_pattern_detector_tpu_torch/csrc/`` are
compiled by ``nvcc`` for ``sm_90a`` into one shared library with a plain
C interface, loaded with ``ctypes``. The build runs at first use and is
keyed by a hash of the sources and flags: a changed source builds a new
library, an unchanged one is loaded as built. There is no fallback: a
missing ``nvcc`` or a failed build raises.

Where the libraries go (:func:`build_root`) follows from where the package
sits. In a checkout (a ``pyproject.toml`` beside the package) it is
``build/`` at the checkout's root, so ``build/apd_torch_kernels/`` here. An
installed copy sits in ``site-packages``, which it must not write into:
it builds into the user's cache directory (``$XDG_CACHE_HOME`` or
``~/.cache``, under ``audio_pattern_detector_tpu_torch/``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"


def build_root() -> Path:
    """The directory the package's libraries build into: ``build/`` of a
    checkout, the user's cache directory for an installed copy."""
    if (_PKG_DIR.parent / "pyproject.toml").is_file():
        return _PKG_DIR.parent / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / _PKG_DIR.name


BUILD_DIR = build_root() / "apd_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas=-v",
)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int

# C signatures of the library's entry points (csrc/*.cu ``extern "C"``).
_SIGNATURES = {
    "apd_candidate_scan": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_int,
         _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],
        ctypes.c_int,
    ),
    "apd_graph_if_begin": ([_c_ptr, _c_ptr, _c_ptr], ctypes.c_int),
    "apd_graph_if_end": ([_c_ptr], ctypes.c_int),
    "apd_graph_while_begin": ([_c_ptr, _c_ptr, _c_ptr], ctypes.c_int),
    "apd_graph_while_end": ([_c_ptr], ctypes.c_int),
}


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was loaded
    compiler_log: str  # nvcc's output (ptxas register/shared-memory report)


_loaded: "KernelLibrary | None" = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
        "kernels of audio_pattern_detector_tpu_torch need the CUDA toolkit"
    )


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_kernels() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = [s for s in _sources() if s.suffix == ".cu"]
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    target = BUILD_DIR / f"apd_torch_kernels_{_digest(_sources())}.so"
    build_seconds = 0.0
    log = ""
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename: concurrent first uses
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, target)
    _loaded = KernelLibrary(_bind(target), target, build_seconds, log)
    return _loaded
