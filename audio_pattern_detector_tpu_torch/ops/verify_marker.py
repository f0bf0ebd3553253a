"""The marker-tone verifier: one fused CUDA kernel, and its plain version.

Counterpart of the JAX package's ``ops/verify.py::verify_marker``. The
matched segment and both flanks are one 3m slice of the section; their
whole-window Hann spectra and the matched segment's 25 ms / 50 %-hop frame
spectra decide, with six per-clip thresholds, whether a lane is a marker
tone.

On a CUDA device :func:`verify_marker` is one launch of
``csrc/verify_marker.cu``, which makes the spectra of live lanes itself (its
FFT plans: ``ops/marker_fft.py``) and decides on them; nothing but the
accept bits leaves it. On the CPU it runs the plain version,
:func:`verify_marker_reference`: :func:`marker_spectra` for every lane
(``torch.fft.rfft``, the JAX package's ``jnp.fft.rfft``, or under
``APD_MARKER_GEMM=1`` the power spectra from one real-DFT matrix product
each, the JAX package's DFT-GEMM, on by default only on a TPU; read at each
call), then :func:`marker_decisions_reference`. It never falls back from
one to the other. The kernel's spectra are not torch's bits (another FFT);
its accept bits are held equal to the plain version's.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops.devices import device_guard
from audio_pattern_detector_tpu_torch.ops.marker_fft import marker_plan
from audio_pattern_detector_tpu_torch.ops.slicing import slice_rows_windows
from audio_pattern_detector_tpu_torch.ops.verify_normal import WINDOW_PAD, check_operand

if TYPE_CHECKING:
    from audio_pattern_detector_tpu_torch.ops.verify import MarkerVerifyConsts

# The DFT-GEMM runs only up to this transform length: its (n, n + 2)
# matrix grows quadratically (67 MB at 4,096).
_GEMM_MAX_N = 4096


@functools.lru_cache(maxsize=16)
def _dft_matrix(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2F) f32 [cos | sin] real-DFT matrix, F = n // 2 + 1, built in
    f64 with the JAX package's expression."""
    f = n // 2 + 1
    idx = np.arange(n, dtype=np.float64)[:, None] * np.arange(f, dtype=np.float64)
    ang = -2.0 * np.pi * idx / n
    mat = np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(mat).to(device)


def _rfft_power_gemm(x: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(x)|^2 along the last axis as one real-DFT matrix product.

    Not bitwise the FFT's (another summation order); the marker verifier
    decides on thresholds, not on spectrum bits. The product runs at full
    f32 whatever the process allows for matmuls (JAX asks for
    ``Precision.HIGHEST``): TF32 is switched off around it and the
    process's setting restored. Callers gate on ``n <= _GEMM_MAX_N``."""
    f = n // 2 + 1
    mat = _dft_matrix(n, x.device)
    with _full_f32_matmul():
        proj = x.reshape(-1, n) @ mat
    re, im = proj[:, :f], proj[:, f:]
    return (re * re + im * im).reshape(*x.shape[:-1], f)


@contextlib.contextmanager
def _full_f32_matmul():
    """CUDA f32 matmuls at IEEE f32, not TF32, inside the block. Through
    the CUDA backend's own setting (``fp32_precision``, where torch has
    it), which leaves the process-wide getters as they were: mixing it with
    the legacy ``allow_tf32`` flag makes ``get_float32_matmul_precision``
    raise."""
    matmul = torch.backends.cuda.matmul
    name, off = ("fp32_precision", "ieee") if hasattr(matmul, "fp32_precision") else (
        "allow_tf32", False)
    saved = getattr(matmul, name)
    setattr(matmul, name, off)
    try:
        yield
    finally:
        setattr(matmul, name, saved)


def _marker_gemm_enabled() -> bool:
    """DFT-GEMM marker spectra: ``APD_MARKER_GEMM=1`` turns them on, any
    other value or none leaves the FFT (the JAX package's default off a
    TPU). Read at each call."""
    return os.environ.get("APD_MARKER_GEMM") == "1"


class MarkerSpectra(NamedTuple):
    """The spectra the decisions read, for every lane of (B, G, K) lanes.

    ``whole`` (B, G, K, 3, m//2 + 1): left flank, match, right flank;
    ``frames`` (B, G, K, F, wl//2 + 1) of the match, None without frames.
    Each is a magnitude (``*_is_magnitude``: the FFT's, whose power is its
    square) or a power spectrum (the DFT-GEMM's)."""

    whole: torch.Tensor
    whole_is_magnitude: bool
    frames: "torch.Tensor | None"
    frames_is_magnitude: bool


def marker_spectra(
    section: torch.Tensor,  # (S,) or (B, S) normalised, NaN-scrubbed
    pos: torch.Tensor,  # (R, K) candidate 'full' indices
    consts: "MarkerVerifyConsts",
) -> MarkerSpectra:
    """The window gather, the Hann products and the transforms of every
    lane: row r reads section r // G (R = B * G, round-major)."""
    r_rows, k = pos.shape
    m = consts.clip_len
    sections = section.reshape(-1, section.shape[-1])
    b = sections.shape[0]
    g = r_rows // b
    # [lag - m, lag + 2m) holds left flank, match and right flank.
    lag = pos - (m - 1)
    secp = F.pad(sections, (m + WINDOW_PAD, m + WINDOW_PAD))
    start = (lag + WINDOW_PAD).clamp(0, secp.shape[1] - 3 * m)
    # (B, G, K, 3, m): the per-clip constants broadcast over B and K.
    seg3 = slice_rows_windows(secp, start.reshape(b, g * k), 3 * m).reshape(b, g, k, 3, m)
    gemm = _marker_gemm_enabled()

    if gemm and m <= _GEMM_MAX_N:
        # argmax and the purity ratios need only the power spectrum.
        whole, whole_mag = _rfft_power_gemm(seg3 * consts.hann_whole, m), False
    else:
        whole, whole_mag = torch.fft.rfft(seg3 * consts.hann_whole, dim=-1).abs(), True
    frames, frames_mag = None, True
    if consts.frame_count > 0:
        wl = consts.frame_len
        seg_match = seg3[..., 1, :]
        stacked = torch.stack(
            [seg_match[..., s0 : s0 + wl] for s0 in consts.frame_starts], dim=-2
        ) * consts.hann_frame  # (B, G, K, F, wl)
        if gemm and wl <= _GEMM_MAX_N:
            frames, frames_mag = _rfft_power_gemm(stacked, wl), False
        else:
            frames = torch.fft.rfft(stacked, dim=-1).abs()
    return MarkerSpectra(whole, whole_mag, frames, frames_mag)


def _band_purity(power: torch.Tensor, band: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(purity, energy) of power spectra (..., F) against a band mask."""
    energy = power.sum(dim=-1)
    band_energy = torch.where(band, power, 0.0).sum(dim=-1)
    purity = torch.where(energy > 0.0, band_energy / energy.clamp_min(1e-38), 0.0)
    return purity, energy


def marker_decisions_reference(
    spectra: MarkerSpectra, alive: torch.Tensor, consts: "MarkerVerifyConsts"
) -> torch.Tensor:
    """The kernel's decisions in plain torch ops (any device), for every
    lane: the accept mask (R, K) from the spectra of (B, G, K) lanes."""
    whole = spectra.whole
    b, g, k = whole.shape[:3]
    # argmax on the input as given: for the FFT the magnitude, not its
    # square (squaring can collapse near-tied f32 magnitudes and shift the
    # tie-break index).
    match_arg = whole[..., 1, :].argmax(dim=-1)
    power = whole * whole if spectra.whole_is_magnitude else whole
    purity, _ = _band_purity(power, consts.band_whole[:, None, None, :])
    purity_left, purity_match, purity_right = purity.unbind(dim=-1)

    detected = consts.freqs_whole[match_arg]  # (B, G, K)
    dom = consts.dom_freq[:, None]
    freq_ok = (detected - dom).abs() <= 0.05 * torch.maximum(detected.abs(), dom)

    if spectra.frames is not None:
        fspec = spectra.frames
        ffreq_arg = fspec.argmax(dim=-1)
        fpow = fspec * fspec if spectra.frames_is_magnitude else fspec
        fpur, fenergy = _band_purity(fpow, consts.band_frame[:, None, None, :])
        nonzero = fenergy > 0.0
        ffreq = consts.freqs_frame[ffreq_arg]
        locked = (ffreq - dom[..., None]).abs() <= consts.lock_hz[:, None, None]
        active = nonzero & locked & (fpur >= float(np.float32(0.55)))

        frame_count = nonzero.sum(dim=-1)  # (B, G, K)
        active_count = active.sum(dim=-1)
        # Longest consecutive active run: distance to the last inactive frame.
        fpos = torch.arange(fspec.shape[-2], device=whole.device)
        last_inactive = torch.cummax(torch.where(~active, fpos, -1), dim=-1).values
        longest_run = torch.where(active, fpos - last_inactive, 0).amax(dim=-1)
        mean_purity = torch.where(
            active_count > 0,
            torch.where(active, fpur, 0.0).sum(dim=-1) / active_count.clamp_min(1),
            0.0,
        )
        ratio = torch.where(
            frame_count > 0, active_count / frame_count.clamp_min(1), 0.0
        )
    else:
        ratio = torch.zeros((b, g, k), device=whole.device)
        longest_run = torch.zeros((b, g, k), dtype=torch.int64, device=whole.device)
        mean_purity = torch.zeros((b, g, k), device=whole.device)

    t = consts.thresholds[:, None, :]  # (G, 1, 6)
    min_flank = torch.minimum(purity_left, purity_right)
    max_flank = torch.maximum(purity_left, purity_right)
    embedded = (
        (purity_match >= t[..., 0])
        & (ratio >= t[..., 1])
        & (longest_run >= t[..., 2])
        & (mean_purity >= t[..., 3])
        & (min_flank <= t[..., 4])
        & (max_flank <= t[..., 5])
    )
    return alive & (freq_ok & embedded).reshape(b * g, k)


def verify_marker_reference(
    section: torch.Tensor, pos: torch.Tensor, alive: torch.Tensor, consts: "MarkerVerifyConsts"
) -> torch.Tensor:
    """The whole verifier in plain torch ops (any device): the spectra and
    the plain decisions."""
    return marker_decisions_reference(marker_spectra(section, pos, consts), alive, consts)


def _launch(section: torch.Tensor, pos: torch.Tensor, alive: torch.Tensor,
            consts: "MarkerVerifyConsts", probe: "torch.Tensor | None" = None) -> torch.Tensor:
    """The accept mask (R, K): one launch of ``csrc/verify_marker.cu`` (CUDA
    tensors only; it raises on anything else and on a CUDA error).
    ``probe``, a (R, K, 3 Fw + F Ff) f32 tensor, receives the kernel's
    magnitudes of live lanes (for tests; no path passes it)."""
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    dev = section.device
    if section.dtype != torch.float32 or section.dim() not in (1, 2) or not section.is_contiguous():
        raise ValueError("verify_marker: section must be a contiguous (S,) or (B, S) float32 "
                         "tensor")
    sections = section.reshape(-1, section.shape[-1])
    b, s_len = sections.shape
    if pos.dim() != 2:
        raise ValueError("verify_marker: pos must be (R, K)")
    # A block of lanes is a column slice: copied to its own rows.
    pos, alive = pos.contiguous(), alive.contiguous()
    r_rows, k = pos.shape
    g = consts.dom_freq.shape[0]
    if r_rows != b * g:
        raise ValueError(f"verify_marker: {r_rows} rows are not {b} rounds of {g} clips")
    check_operand("pos", pos, (r_rows, k), torch.int64, dev, "verify_marker")
    check_operand("alive", alive, (r_rows, k), torch.bool, dev, "verify_marker")
    m, wl, n_frames = consts.clip_len, consts.frame_len, consts.frame_count
    fw, ff = m // 2 + 1, wl // 2 + 1
    check_operand("hann_whole", consts.hann_whole, (m,), torch.float32, dev, "verify_marker")
    check_operand("freqs_whole", consts.freqs_whole, (fw,), torch.float32, dev, "verify_marker")
    check_operand("band_whole", consts.band_whole, (g, fw), torch.bool, dev, "verify_marker")
    check_operand("dom_freq", consts.dom_freq, (g,), torch.float32, dev, "verify_marker")
    check_operand("lock_hz", consts.lock_hz, (g,), torch.float32, dev, "verify_marker")
    check_operand("thresholds", consts.thresholds, (g, 6), torch.float32, dev, "verify_marker")
    if n_frames > 0:
        check_operand("hann_frame", consts.hann_frame, (wl,), torch.float32, dev, "verify_marker")
        check_operand("freqs_frame", consts.freqs_frame, (ff,), torch.float32, dev,
                      "verify_marker")
        check_operand("band_frame", consts.band_frame, (g, ff), torch.bool, dev, "verify_marker")
        hop = consts.frame_starts[1] - consts.frame_starts[0] if n_frames > 1 else 0
        if tuple(consts.frame_starts) != tuple(i * hop for i in range(n_frames)) or (
                consts.frame_starts[-1] + wl > m):
            raise ValueError("verify_marker: the frames must start at 0, hop, 2 hop, ... "
                             "inside the match window")
    else:
        hop = 0
    if r_rows * k >= 2**31:
        raise ValueError(f"verify_marker: {r_rows * k} lanes, past the kernel's int32 ranks")
    if probe is not None:
        check_operand("probe", probe, (r_rows, k, 3 * fw + n_frames * ff), torch.float32, dev,
                      "verify_marker")
    plan = marker_plan(m, wl, n_frames, dev)  # raises past the clip's frames or the passes
    lay = plan.layout
    lib = load_kernels().lib
    with device_guard(dev):
        accept = torch.empty((r_rows, k), dtype=torch.bool, device=dev)
        if r_rows == 0 or k == 0:
            return accept
        grid, workspace = 0, None
        if not lay.on_chip:
            # One slot per resident CTA: a CTA a streaming multiprocessor.
            grid = min(r_rows * k, torch.cuda.get_device_properties(dev).multi_processor_count)
            workspace = torch.empty(grid * lay.slot, dtype=torch.float32, device=dev)
        hann_frame = consts.hann_frame if n_frames > 0 else consts.hann_whole
        freqs_frame = consts.freqs_frame if n_frames > 0 else consts.freqs_whole
        band_frame = consts.band_frame if n_frames > 0 else consts.band_whole
        err = lib.apd_verify_marker(
            sections.data_ptr(), b, s_len, pos.data_ptr(), alive.data_ptr(), r_rows, k, g, m,
            hop, n_frames, ctypes.addressof(plan.whole), ctypes.addressof(plan.frame),
            plan.tables.data_ptr(), lay.window, lay.whole_batch, lay.frame_batch, lay.buffer,
            int(lay.on_chip), int(lay.frames_on_chip),
            None if workspace is None else workspace.data_ptr(), grid,
            consts.hann_whole.data_ptr(), hann_frame.data_ptr(), consts.freqs_whole.data_ptr(),
            consts.band_whole.data_ptr(), consts.dom_freq.data_ptr(), consts.lock_hz.data_ptr(),
            freqs_frame.data_ptr(), band_frame.data_ptr(), consts.thresholds.data_ptr(),
            accept.data_ptr(), None if probe is None else probe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"verify_marker kernel launch failed: CUDA error {err}")
    verify_marker.launches += 1
    return accept


def verify_marker(
    section: torch.Tensor,  # (S,) or (B, S) normalised, NaN-scrubbed
    pos: torch.Tensor,  # (R, K) candidate 'full' indices
    alive: torch.Tensor,  # (R, K) bool
    consts: "MarkerVerifyConsts",
) -> torch.Tensor:
    """Returns the accept mask (R, K). The rows are the group's G clips
    over one section, or B rounds of them over a (B, S) batch (R = B * G,
    round-major): row r reads section r // G and the constants of clip
    r % G. The fused CUDA kernel for CUDA tensors (spectra and decisions
    of live lanes), the plain version for CPU tensors."""
    if section.device.type == "cuda":
        return _launch(section, pos, alive, consts)
    if section.device.type == "cpu":
        return verify_marker_reference(section, pos, alive, consts)
    raise ValueError(f"verify_marker: unsupported device {section.device}")


# Kernels the card ran: one per launch (_launch), and for each
# replay of a captured class step the launches its graph holds, a
# conditional body's only where the body ran (models/captured.py). The
# plain version counts nothing.
verify_marker.launches = 0
