"""The full tier's lane greedy: CUDA kernel and plain version.

Counterpart of the JAX package's ``ops/peaks.py::greedy_distance_filter``
(its ``lax.while_loop`` forms ``_greedy_distance_sequential`` and
``_greedy_distance_parallel``), which XLA compiles into the class step's
program. Given (G, K) lanes in priority order (height descending, ties to
the lower position), with positions ``pos`` (G, K) int64 (a dead lane's
position is unspecified) and ``alive`` (G, K) bool, a prefix of each row,
``keep[g, i]`` holds when lane i is alive and no kept lane of higher
priority lies within ``min_distance``: scipy's distance filter.

:func:`lane_greedy` launches ``csrc/lane_greedy.cu`` for CUDA tensors, one
launch a group with one CTA a row (its alive lanes sorted by position, so
that a kept lane visits only the lanes within ``min_distance``; one warp
walks them in priority order), at every K up to :data:`MAX_LANES`, and runs
:func:`lane_greedy_reference` for CPU tensors; it never falls back from one
to the other. The plain version keeps the JAX package's two forms, chosen
by lane count as JAX chooses them: the parallel fixed point up to
:data:`PARALLEL_GREEDY_MAX_K` lanes, the sequential walk above. The
sequential greedy is the unique fixed point of the parallel recurrence, so
the two forms and the kernel give one mask, and the kernel is held to it
bit for bit.
"""

from __future__ import annotations

import torch

from audio_pattern_detector_tpu_torch.ops.devices import device_guard
from audio_pattern_detector_tpu_torch.ops.loops import Loop, host_loop

# Above this lane count the (G, K, K) conflict matrix of the parallel
# filter outweighs the sequential loop (the JAX package's threshold).
PARALLEL_GREEDY_MAX_K = 2048

# Dynamic shared memory the kernel may take (csrc/lane_greedy.cu: the 227 KB
# of a block less room for its static shared memory) and what a row needs:
# 13 bytes a lane (two sort keys, two compact indices, an open flag) and a
# table of 16 x 256 16-bit digit counts.
_MAX_SMEM = 232448 - 1024
_LANE_BYTES = 13
_COUNT_BYTES = 16 * 256 * 2
MAX_LANES = (_MAX_SMEM - _COUNT_BYTES) // _LANE_BYTES  # 17,171: k_detect's cap of 16,384 fits

_DROPPED = 2**30  # the sequential form's position of a dead or suppressed lane


def _greedy_distance_sequential(
    pos: torch.Tensor, alive: torch.Tensor, min_distance: int, loop: "Loop | None" = None
) -> torch.Tensor:
    """Sequential greedy over height-sorted lanes. Each row's alive lanes
    are a prefix, so the loop runs ``while i < n_alive``, the bank-wide
    alive maximum, lane ``i`` selected by a device index; without ``loop``
    the host reads ``n_alive`` once and runs the body that many times.

    The state is one int32 array: a lane's position while it is alive and
    kept, _DROPPED once it is dead or suppressed. A lane at _DROPPED is
    near no real position, so a dropped lane ``i`` suppresses nothing, and
    a pass of the body is 8 kernels."""
    dev = pos.device
    kept_pos = torch.where(alive, pos.to(torch.int32), _DROPPED)
    n_alive = (alive.sum(dim=1).amax() if alive.numel()
               else torch.zeros((), dtype=torch.int64, device=dev))
    i = torch.zeros((), dtype=torch.int64, device=dev)
    go = i < n_alive

    def body() -> None:
        at = i.view(1)
        near = (kept_pos - kept_pos.index_select(1, at)).abs_() < min_distance
        near.index_fill_(1, at, False)
        kept_pos.masked_fill_(near, _DROPPED)
        i.add_(1)
        torch.lt(i, n_alive, out=go)

    if loop is None:
        for _ in range(int(n_alive)):
            body()
    else:
        loop(go, body)
    return kept_pos != _DROPPED


def _greedy_distance_parallel(
    pos: torch.Tensor, alive: torch.Tensor, min_distance: int, loop: "Loop | None" = None
) -> torch.Tensor:
    """Parallel fixed point of the greedy recurrence: keep(c) = alive(c)
    and no higher-priority kept candidate within ``min_distance``,
    iterated from S = alive ``while changed``, S updated in place
    (``loop``, by default :func:`host_loop`)."""
    pos = pos.to(torch.int32)
    k = pos.shape[1]
    lanes = torch.arange(k, device=pos.device)
    higher = lanes[None, :] < lanes[:, None]  # (K, K): j < i
    conflict = ((pos[:, :, None] - pos[:, None, :]).abs() < min_distance) & higher[None]
    conflict &= alive[:, None, :]
    s = alive & ~(conflict & alive[:, None, :]).any(dim=2)
    changed = torch.ones((), dtype=torch.bool, device=pos.device)

    def body() -> None:
        s_new = alive & ~(conflict & s[:, None, :]).any(dim=2)
        torch.any(s_new != s, out=changed)
        s.copy_(s_new)

    (loop or host_loop)(changed, body)
    return s & alive


def lane_greedy_reference(
    pos: torch.Tensor, alive: torch.Tensor, min_distance: int, loop: "Loop | None" = None
) -> torch.Tensor:
    """The kernel's function in plain torch ops (any device): the JAX
    package's form for the lane count. ``loop`` runs its while loop (a
    captured step's while node, or the stand-in of the CPU tests); without
    it the host drives the body."""
    if pos.shape[1] <= PARALLEL_GREEDY_MAX_K:
        return _greedy_distance_parallel(pos, alive, min_distance, loop)
    return _greedy_distance_sequential(pos, alive, min_distance, loop)


def _launch(pos: torch.Tensor, alive: torch.Tensor, min_distance: int) -> torch.Tensor:
    from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

    if pos.dtype != torch.int64 or pos.dim() != 2 or not pos.is_contiguous():
        raise ValueError("lane_greedy: pos must be a contiguous (G, K) int64 tensor")
    g, k = pos.shape
    if (alive.shape != (g, k) or alive.dtype != torch.bool or alive.device != pos.device
            or not alive.is_contiguous()):
        raise ValueError(
            "lane_greedy: alive must be a contiguous (G, K) bool tensor on pos's device")
    if g >= 2**31 or not 0 <= min_distance < 2**31:
        raise ValueError(f"lane_greedy: {g} rows or min_distance {min_distance} outside int32")
    if k > MAX_LANES:
        raise ValueError(
            f"lane_greedy: {k} lanes need {_COUNT_BYTES + k * _LANE_BYTES} bytes of shared "
            f"memory, past the {_MAX_SMEM} a block may take ({MAX_LANES} lanes)"
        )
    lib = load_kernels().lib
    dev = pos.device
    with device_guard(dev):
        keep = torch.empty((g, k), dtype=torch.bool, device=dev)
        if g == 0 or k == 0:
            return keep
        err = lib.apd_lane_greedy(pos.data_ptr(), alive.data_ptr(), g, k, min_distance,
                                  keep.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_greedy kernel launch failed: CUDA error {err}")
    lane_greedy.launches += 1
    return keep


def lane_greedy(
    pos: torch.Tensor,  # (G, K) int64, priority order
    alive: torch.Tensor,  # (G, K) bool, a prefix of each row
    min_distance: int,
    loop: "Loop | None" = None,
) -> torch.Tensor:
    """(G, K) bool: the surviving alive lanes. The CUDA kernel for CUDA
    tensors (``loop`` is not needed there: the whole walk is one launch),
    the plain version with ``loop`` for CPU tensors."""
    if pos.device.type == "cuda":
        return _launch(pos, alive, int(min_distance))
    if pos.device.type == "cpu":
        return lane_greedy_reference(pos, alive, min_distance, loop)
    raise ValueError(f"lane_greedy: unsupported device {pos.device}")


# Kernels the card ran: one per launch of the wrapper, and for each replay
# of a captured class step the launches its graph holds
# (models/captured.py). The plain version counts nothing.
lane_greedy.launches = 0
