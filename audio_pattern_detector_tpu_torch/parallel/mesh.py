"""Device mesh construction helpers.

Port of audio_pattern_detector_tpu/parallel/mesh.py. A mesh is a named
grid of ``torch.device``s: every shard's work is enqueued on its own
device and the results are stitched on the host.

**One process, or one process per host.** Without a ``torch.distributed``
process group a mesh is driven from one process, which holds every cell.
When the caller has initialised a group (``init_process_group``, as a JAX
program calls ``jax.distributed.initialize``), ``make_mesh`` lays the grid
out process-major, as ``jax.devices()`` orders devices: each process
contributes its own device list, and the first cells go to process 0. A
process holds real devices for its own cells only (``Mesh.is_local``);
the other cells record their owner (``Mesh.process_of``). The mesh paths
then run in lockstep, one collective per round or slab that agrees on the
round (:func:`lockstep`); no row data crosses processes. The group must
carry CPU tensors (gloo): only a few int64 values are ever exchanged.

**Logical shards.** The device list may name one device several times;
shards that share a device run one after another on it. That is how the
mesh paths run on a machine with one card (or on the CPU): the algebra
of the shards is the same, only nothing overlaps. For a subprocess of the
CLI, ``APD_TORCH_LOGICAL_DEVICES=N`` multiplies the default device list
by N; it is read here and nowhere else, and only when the caller passes
no device list.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from audio_pattern_detector_tpu_torch.ops.devices import resolve_device

LOGICAL_DEVICES_ENV = "APD_TORCH_LOGICAL_DEVICES"


def process_count() -> int:
    """Processes of the caller's ``torch.distributed`` group; 1 without one
    (the counterpart of ``jax.process_count()``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in that group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A grid of torch devices with named axes.

    ``process_indices`` (same shape as ``devices``) names the process that
    owns each cell; ``devices`` holds None at the cells of other processes.
    Without it every cell is this process's. ``local_device_count`` is the
    length of the device list this process gave the mesh (its counterpart
    of ``jax.local_device_count()``)."""

    def __init__(
        self,
        devices: Any,
        axis_names: "tuple[str, ...]",
        process_indices: Any = None,
        local_device_count: "int | None" = None,
    ) -> None:
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"device grid has {grid.ndim} axes for {len(axis_names)} axis names"
            )
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self.process_index = process_index()
        self.process_count = process_count()
        if process_indices is None:
            process_indices = np.full(grid.shape, self.process_index, dtype=np.int64)
        self.process_indices = np.asarray(process_indices, dtype=np.int64).reshape(grid.shape)
        self.local_device_count = (
            int(grid.size) if local_device_count is None else local_device_count
        )

    def _index(self, coords: dict[str, int]) -> tuple[int, ...]:
        return tuple(coords.get(name, 0) for name in self.axis_names)

    def device_at(self, **coords: int) -> torch.device:
        """The device at the named coordinates; axes the mesh lacks (or
        the caller leaves out) read as 0. Raises for another process's
        cell."""
        device = self.devices[self._index(coords)]
        if device is None:
            raise ValueError(
                f"mesh cell {coords} belongs to process {self.process_of(**coords)}, "
                f"not to this process ({self.process_index})"
            )
        return device

    def process_of(self, **coords: int) -> int:
        """The process that owns the cell at the named coordinates."""
        return int(self.process_indices[self._index(coords)])

    def is_local(self, **coords: int) -> bool:
        """Whether this process owns the cell at the named coordinates."""
        return self.process_of(**coords) == self.process_index

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def lockstep(what: str, **values: int) -> None:
    """Agree on a round across the processes of the group: an all_gather
    of ``values`` (a few int64 numbers: round index, lengths, rows). Where
    any value differs between processes, every process raises the same
    ValueError, naming the values of each process. Nothing to do in one
    process. A process that stops calling is bounded by the group's own
    timeout, which the caller set in ``init_process_group``."""
    n = process_count()
    if n == 1:
        return
    mine = torch.tensor(list(values.values()), dtype=torch.int64)
    table = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(table, mine)
    rows = torch.stack(table)
    differ = [name for i, name in enumerate(values) if bool((rows[:, i] != rows[0, i]).any())]
    if differ:
        per_process = {name: rows[:, list(values).index(name)].tolist() for name in differ}
        raise ValueError(
            f"processes disagree on {what}: {per_process} (one value per process, "
            "by rank); every process must feed the same round in lockstep"
        )


@dataclass(frozen=True)
class RowSharding:
    """Rows of a batch split contiguously over one axis of a mesh (the
    ``sharding=`` of ``PatternBank.dispatch_chunks_batch``); along the
    mesh's other axes the rows stay on coordinate 0."""

    mesh: Mesh
    axis: str = "stream"


def default_devices(device: "torch.device | str" = "cuda") -> list[torch.device]:
    """Every visible CUDA device when the run is on the card (raises
    without one), one CPU device when ``device`` is the CPU; times
    ``APD_TORCH_LOGICAL_DEVICES``."""
    if resolve_device(device).type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    logical = os.environ.get(LOGICAL_DEVICES_ENV)
    if logical:
        n = int(logical)
        if n < 1:
            raise ValueError(f"{LOGICAL_DEVICES_ENV} must be >= 1, got {logical!r}")
        devices = [d for d in devices for _ in range(n)]
    return devices


def make_mesh(
    axis_sizes: "dict[str, int] | None" = None,
    devices: "list | None" = None,
    device: "torch.device | str" = "cuda",
) -> Mesh:
    """Build a Mesh over the available devices.

    ``axis_sizes`` maps axis name -> size, e.g. {"stream": 2, "time": 4}.
    Defaults to a 1-D "time" mesh over all devices. ``devices`` is the
    device list (one device may appear several times: logical shards);
    without it the list is every visible device of ``device``'s type:
    the cards by default, which raises when there is none, or the one CPU
    device when the caller asks for ``device="cpu"``.

    Under a process group ``devices`` is this process's own list, every
    process calls ``make_mesh`` with the same axes (one all_gather of the
    list lengths), and the grid takes the processes' lists in rank order.
    """
    if devices is None:
        devices = default_devices(device)
    devices = [torch.device(d) for d in devices]
    n_procs, rank = process_count(), process_index()
    if n_procs > 1:
        mine = torch.tensor([len(devices)], dtype=torch.int64)
        counts = [torch.empty_like(mine) for _ in range(n_procs)]
        dist.all_gather(counts, mine)
        per_process = [int(c) for c in counts]
    else:
        per_process = [len(devices)]
    if axis_sizes is None:
        axis_sizes = {"time": sum(per_process)}
    shape = tuple(axis_sizes.values())
    total = int(np.prod(shape))
    if total > sum(per_process):
        raise ValueError(
            f"mesh needs {total} devices, only {sum(per_process)} available"
        )
    # Process-major global order: every process's devices, by rank.
    owners = [p for p, count in enumerate(per_process) for _ in range(count)][:total]
    grid = np.empty(total, dtype=object)
    first = sum(per_process[:rank])
    for i, p in enumerate(owners):
        if p == rank:
            grid[i] = devices[i - first]
    return Mesh(grid.reshape(shape), tuple(axis_sizes.keys()),
                np.asarray(owners, dtype=np.int64).reshape(shape), len(devices))
