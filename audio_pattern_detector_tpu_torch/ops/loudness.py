"""BS.1770 loudness and normalisation (port of audio_pattern_detector_tpu/ops/loudness.py).

K-weighting is an overlap-save FFT convolution against the truncated
impulse response ``hostref.k_weighting_fir`` (f64 on the host); gating
blocks are fixed windows masked to the valid length. The host tables,
including ``block_thr`` (the f64 block count as thresholds), come from
the same numpy expressions as the JAX package's, so the gating geometry
is bitwise shared.

Every function takes one section ``(S,)`` with a host integer ``n_valid``
or a batch ``(B, S)`` with a ``(B,)`` integer tensor of lengths on the
section's device. Both forms go through the same per-row arithmetic, so a
row's LUFS does not depend on the round it rides in:

* the K-weighting's transforms run in calls of a fixed number of
  transforms (``ops/cufft_plans.py``, :data:`FFT_POINTS`);
* the gating (:func:`loudness_gate`, from the K-weighted rows to LUFS) sums
  in fixed trees set by the row's length and the block geometry alone.
  The row is cut into *pieces* at every block start and end (100 ms
  quarter blocks where the hop is a whole number of samples), each piece
  summed by :func:`_lane_fold` over (K, 128) chunks of its squares; a
  block is the in-order fold of its pieces, and the whole row (the short
  form) and the two gates' sums are such folds of the pieces and of the
  blocks. ``csrc/loudness_gate.cu`` computes the same trees on a card,
  a row's pieces spread over :func:`gate_ctas_per_row` CTAs and the rest
  of the row on the last of them to finish; the plain version computes
  them with element-wise adds, on any device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops import hostref
from audio_pattern_detector_tpu_torch.ops.correlate import next_pow2
from audio_pattern_detector_tpu_torch.ops.cufft_plans import irfft, rfft
from audio_pattern_detector_tpu_torch.ops.devices import device_guard

LUFS_OFFSET = -0.691
ABSOLUTE_GATE_LUFS = -70.0
DEFAULT_TARGET_LUFS = -16.0
_FIR_TAPS = 4096
# Points a cuFFT call of the K-weighting transforms holds, whatever the
# round's width: 128 transforms of 16,384 points (at 8 kHz 40 a row;
# scripts/probe_fft_batch.py times the alternatives).
FFT_POINTS = 1 << 21
# The fold's chunk: 32 lanes of 4 values (csrc/loudness_gate.cu).
_CHUNK = 128
# Pieces a CTA of the gating kernel sums, a warp a piece (its kPiecesPerCta).
GATE_PIECES_PER_CTA = 8


@dataclass(frozen=True)
class LoudnessConsts:
    """Host-precomputed constants for a (section_len, sample_rate) pair."""

    fir_spec: torch.Tensor  # (fft_len//2 + 1,) complex64
    block_lo: torch.Tensor  # (max_blocks,) int64 block starts
    block_end: torch.Tensor  # (max_blocks,) int64 block ends (pre-clamp)
    # block_thr[j]: smallest n with hostref.num_gating_blocks(n) >= j + 1.
    block_thr: torch.Tensor  # (max_blocks,) int64
    # The gating trees' geometry (gate_tables): the row cut at every block
    # start and end, and each block as a run of those pieces.
    piece_bounds: torch.Tensor  # (P + 1,) int64 piece starts, then the last end
    block_first: torch.Tensor  # (max_blocks,) int64 a block's first piece
    block_pieces: torch.Tensor  # (max_blocks,) int64 its piece count
    section_len: int
    sample_rate: int
    fft_len: int
    short_threshold: int  # single-block path below
    num_segments: int = 1  # overlap-save convolution segments
    piece_chunks: int = 1  # 128-sample chunks of the widest piece
    piece_end: int = 0  # piece_bounds[-1]
    max_block_pieces: int = 1


def gate_tables(
    section_len: int, block_lo: np.ndarray, block_end: np.ndarray, sample_rate: int,
    device: torch.device,
) -> dict:
    """The gating trees' fields of :class:`LoudnessConsts`: pieces bounded
    by every block start and end and by the 100 ms grid ``int(k * hop)``
    (as the block starts are computed) up to the section's end; each block
    the run of pieces between its start and end."""
    hop = 0.4 * float(sample_rate) * 0.25  # build_loudness_consts's hop_samples
    n = int(section_len / hop) + 2
    while int((n - 1) * hop) < section_len:
        n += 1
    grid = (np.arange(n, dtype=np.float64) * hop).astype(np.int64)
    bounds = np.unique(np.concatenate([[0], grid, block_lo, block_end]))
    first = np.searchsorted(bounds, block_lo)
    last = np.searchsorted(bounds, block_end)
    widths = np.diff(bounds)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return dict(
        piece_bounds=dev(bounds),
        block_first=dev(first),
        block_pieces=dev(last - first),
        piece_chunks=max(1, -(-int(widths.max()) // _CHUNK)),
        piece_end=int(bounds[-1]),
        max_block_pieces=max(1, int((last - first).max())),
    )


def build_loudness_consts(
    section_len: int, sample_rate: int, device: torch.device
) -> LoudnessConsts:
    """The class's loudness constants: the K-weighting filter convolves in
    overlap-save segments wherever the section is longer than one FFT."""
    rate = float(sample_rate)
    t_g = 0.4
    fir = hostref.k_weighting_fir(rate, _FIR_TAPS)
    whole = next_pow2(section_len + _FIR_TAPS - 1)
    fft_len = next_pow2(4 * _FIR_TAPS)
    if fft_len >= whole:
        fft_len, num_segments = whole, 1
    else:
        num_segments = -(-section_len // (fft_len - _FIR_TAPS + 1))
    spec = np.fft.rfft(fir, fft_len).astype(np.complex64)

    max_blocks = max(hostref.num_gating_blocks(section_len, rate, t_g), 1)
    window_samples = t_g * rate
    hop_samples = window_samples * 0.25
    j = np.arange(max_blocks, dtype=np.float64)
    lo = (j * hop_samples).astype(np.int64)
    end = (j * hop_samples + window_samples).astype(np.int64)
    block_thr = np.empty(max_blocks, dtype=np.int64)
    for k in range(max_blocks):
        n = max(int((0.1 * (k - 0.5) + t_g) * rate) - 8, 0)
        while hostref.num_gating_blocks(n, rate, t_g) < k + 1:
            n += 1
        block_thr[k] = n

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return LoudnessConsts(
        fir_spec=dev(spec),
        block_lo=dev(lo),
        block_end=dev(end),
        block_thr=dev(block_thr),
        section_len=section_len,
        sample_rate=sample_rate,
        fft_len=fft_len,
        short_threshold=int(math.ceil(0.5 * sample_rate)),
        num_segments=num_segments,
        **gate_tables(section_len, lo, end, sample_rate, device),
    )


def _k_weighted_conv(section: torch.Tensor, consts: LoudnessConsts) -> torch.Tensor:
    """K-weighting FIR convolution along the last axis, whole-signal or
    overlap-save."""
    s, n = consts.section_len, consts.fft_len
    if consts.num_segments == 1:
        spec = rfft(section, n=n, points=FFT_POINTS)
        return irfft(spec * consts.fir_spec, n=n, points=FFT_POINTS)[..., :s]
    taps = _FIR_TAPS
    step = n - taps + 1
    ns = consts.num_segments
    padded = F.pad(section, (taps - 1, ns * step + n - (s + taps - 1)))
    segments = padded.unfold(-1, n, step)[..., :ns, :]
    z = irfft(rfft(segments, points=FFT_POINTS) * consts.fir_spec, n=n, points=FFT_POINTS)
    return z[..., taps - 1 :].reshape(*section.shape[:-1], ns * step)[..., :s]


def _lufs(ms: torch.Tensor) -> torch.Tensor:
    return LUFS_OFFSET + 10.0 * torch.log10(ms)


def _lane_fold(x: torch.Tensor) -> torch.Tensor:
    """The sum of (..., K, 128) over its last two axes in the kernel's
    order: each of the 128 columns folded over K in order, each lane's
    four columns (4l .. 4l + 3) as (c0 + c1) + (c2 + c3), then the 32
    lanes halved pairwise (lane i + lane i + h, h = 16, 8, 4, 2, 1)."""
    acc = x[..., 0, :]
    for t in range(1, x.shape[-2]):
        acc = acc + x[..., t, :]
    quad = acc.unflatten(-1, (_CHUNK // 4, 4))
    acc = (quad[..., 0] + quad[..., 1]) + (quad[..., 2] + quad[..., 3])
    h = _CHUNK // 8
    while h:
        acc = acc[..., :h] + acc[..., h : 2 * h]
        h //= 2
    return acc[..., 0]


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """:func:`_lane_fold` of the last axis zero-padded to whole chunks."""
    k = max(1, -(-v.shape[-1] // _CHUNK))
    return _lane_fold(F.pad(v, (0, k * _CHUNK - v.shape[-1])).unflatten(-1, (k, _CHUNK)))


def loudness_gate_reference(
    filtered: torch.Tensor, n_valid: torch.Tensor, consts: LoudnessConsts
) -> torch.Tensor:
    """BS.1770 gating of K-weighted rows (B, S) with lengths ``n_valid``
    (B,): (B,) f32 LUFS, -inf for silence, in plain torch ops (any device),
    in the trees :func:`loudness_gate`'s kernel takes."""
    s = consts.section_len
    dev = filtered.device
    lim = n_valid.to(torch.int64)[:, None]
    sq = torch.where(torch.arange(s, device=dev) < lim, filtered * filtered, 0.0)
    # Piece sums: (B, P) folds of each piece's (K, 128) chunks.
    bounds = consts.piece_bounds
    width = consts.piece_chunks * _CHUNK
    idx = bounds[:-1, None] + torch.arange(width, device=dev)
    padded = F.pad(sq, (0, consts.piece_end + width - s))
    chunks = torch.where(idx < bounds[1:, None], padded[:, idx], 0.0)
    pieces = _lane_fold(chunks.unflatten(-1, (consts.piece_chunks, _CHUNK)))
    # Block sums: each block's pieces folded in order (past its count, + 0).
    first, count = consts.block_first, consts.block_pieces
    block_sum = pieces[:, first]
    for t in range(1, consts.max_block_pieces):
        nxt = pieces[:, (first + t).clamp_max(pieces.shape[1] - 1)]
        block_sum = block_sum + torch.where(t < count, nxt, 0.0)

    neg_inf = torch.full((), -math.inf, device=dev)
    # One gating block spanning the whole signal below the short threshold
    # (reference: audio_pattern_detector.py:416-418).
    ms_short = _lane_sum(pieces) / n_valid.clamp_min(1).to(torch.float32)
    lufs_short = torch.where(ms_short > 0.0, _lufs(ms_short), neg_inf)
    short = torch.where(lufs_short >= ABSOLUTE_GATE_LUFS, lufs_short, neg_inf)

    hi = consts.block_end.clamp(max=lim)  # (B, nblk)
    # block_thr rises with the block index: the first num_blocks blocks are
    # those whose threshold the length reaches.
    block_valid = (consts.block_thr <= lim) & (consts.block_lo < hi) & (block_sum > 0.0)
    ms = block_sum / (hi - consts.block_lo).to(torch.float32).clamp_min(1.0)
    loud = _lufs(ms.clamp_min(1e-38))

    abs_mask = block_valid & (loud >= ABSOLUTE_GATE_LUFS)
    abs_count = abs_mask.sum(dim=-1)
    z_avg = _lane_sum(torch.where(abs_mask, ms, 0.0)) / abs_count.clamp_min(1)
    gamma_r = _lufs(z_avg.clamp_min(1e-38)) - 10.0

    rel_mask = abs_mask & (loud > gamma_r[:, None])
    rel_count = rel_mask.sum(dim=-1)
    z_final = _lane_sum(torch.where(rel_mask, ms, 0.0)) / rel_count.clamp_min(1)
    lufs = _lufs(z_final.clamp_min(1e-38))
    gated = torch.where((abs_count > 0) & (rel_count > 0), lufs, neg_inf)
    return torch.where(n_valid < consts.short_threshold, short, gated)


def gate_ctas_per_row(pieces: int) -> int:
    """CTAs the gating kernel gives a row of ``pieces`` pieces: a function
    of the row's geometry alone, whatever the round's width."""
    return -(-pieces // GATE_PIECES_PER_CTA)


def gate_cta_pieces(block: int, pieces: int) -> tuple[int, range]:
    """(row, pieces) of the gating kernel's CTA ``block`` (its blockIdx.x):
    the grid holds :func:`gate_ctas_per_row` CTAs for each row in turn,
    each summing up to :data:`GATE_PIECES_PER_CTA` consecutive pieces."""
    row, cta = divmod(block, gate_ctas_per_row(pieces))
    first = cta * GATE_PIECES_PER_CTA
    return row, range(first, min(pieces, first + GATE_PIECES_PER_CTA))


def _launch(filtered: torch.Tensor, n_valid: torch.Tensor, consts: LoudnessConsts) -> torch.Tensor:
    """The LUFS (B,): a memset of the row tickets and one launch of
    ``csrc/loudness_gate.cu`` (CUDA tensors only; it raises on anything
    else and on a CUDA error)."""
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    dev = filtered.device
    b, s = filtered.shape
    if (filtered.dtype != torch.float32 or s != consts.section_len or filtered.stride(1) != 1
            or (b > 1 and filtered.stride(0) < s)):
        raise ValueError(f"loudness_gate: rows must be (B, {consts.section_len}) float32 with "
                         f"contiguous rows, got {filtered.dtype} {tuple(filtered.shape)} strides "
                         f"{filtered.stride()}")
    if n_valid.shape != (b,) or n_valid.device != dev:
        raise ValueError(f"loudness_gate: n_valid must be ({b},) on {dev}")
    tables = (consts.piece_bounds, consts.block_lo, consts.block_end, consts.block_thr,
              consts.block_first, consts.block_pieces)
    if any(t.dtype != torch.int64 or t.device != dev or not t.is_contiguous() for t in tables):
        raise ValueError("loudness_gate: the gating tables must be contiguous int64 on the rows' "
                         "device")
    pieces, blocks = consts.piece_bounds.shape[0] - 1, consts.block_lo.shape[0]
    lib = load_kernels().lib
    with device_guard(dev):
        lens = n_valid.to(torch.int32).contiguous()
        out = torch.empty((b,), dtype=torch.float32, device=dev)
        if b == 0:
            return out
        workspace = torch.empty((b, pieces + 2 * blocks), dtype=torch.float32, device=dev)
        tickets = torch.empty((b,), dtype=torch.int32, device=dev)  # zeroed by the call
        err = lib.apd_loudness_gate(
            filtered.data_ptr(), b, s, filtered.stride(0), lens.data_ptr(),
            consts.piece_bounds.data_ptr(), pieces, consts.piece_chunks,
            gate_ctas_per_row(pieces), consts.block_lo.data_ptr(), consts.block_end.data_ptr(),
            consts.block_thr.data_ptr(), consts.block_first.data_ptr(),
            consts.block_pieces.data_ptr(), blocks, consts.short_threshold,
            workspace.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"loudness_gate kernel launch failed: CUDA error {err}")
    loudness_gate.launches += 1
    return out


def loudness_gate(
    filtered: torch.Tensor, n_valid: torch.Tensor, consts: LoudnessConsts
) -> torch.Tensor:
    """Gated integrated loudness (B,) f32 of K-weighted rows (B, S) with
    lengths ``n_valid`` (B,) (samples at and past a row's length are
    ignored): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if filtered.device.type == "cuda":
        return _launch(filtered, n_valid, consts)
    if filtered.device.type == "cpu":
        return loudness_gate_reference(filtered, n_valid, consts)
    raise ValueError(f"loudness_gate: unsupported device {filtered.device}")


# Kernels the card ran: one per launch of the wrapper, and for each replay
# of a captured class step the launches its graph holds
# (models/captured.py). The plain version counts nothing.
loudness_gate.launches = 0


def integrated_loudness_device(
    section: torch.Tensor, n_valid: "int | torch.Tensor", consts: LoudnessConsts
) -> torch.Tensor:
    """Gated integrated loudness (f32 LUFS; -inf for silence) of
    ``section[..., :n_valid]``: 0-d for one section, (B,) for a batch.
    Samples at and beyond ``n_valid`` must be zero."""
    filtered = _k_weighted_conv(section, consts)
    if isinstance(n_valid, torch.Tensor):
        return loudness_gate(filtered, n_valid, consts)
    lens = torch.full((1,), n_valid, dtype=torch.int32, device=section.device)
    return loudness_gate(filtered[None], lens, consts)[0]


def loudness_normalize_device(
    section: torch.Tensor,
    lufs: torch.Tensor,
    target_lufs: float = DEFAULT_TARGET_LUFS,
) -> torch.Tensor:
    """Gain to target LUFS, hard clip to [-1, 1], NaN scrubbed to zero
    (-inf loudness: non-zero samples saturate, zeros stay zero). ``lufs``
    is 0-d for one section or (B,) for a (B, S) batch."""
    gain = torch.pow(torch.full((), 10.0, device=section.device), (target_lufs - lufs) / 20.0)
    y = (section * gain[..., None]).clamp(-1.0, 1.0)
    return torch.where(torch.isnan(y), 0.0, y)
