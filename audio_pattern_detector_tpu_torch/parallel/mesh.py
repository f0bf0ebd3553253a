"""Device mesh construction helpers.

Port of audio_pattern_detector_tpu/parallel/mesh.py. A mesh is a named
grid of ``torch.device``s driven from one process: every shard's work is
enqueued on its own device and the results are stitched on the host.

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

from audio_pattern_detector_tpu_torch.ops.devices import resolve_device

LOGICAL_DEVICES_ENV = "APD_TORCH_LOGICAL_DEVICES"


class Mesh:
    """A grid of torch devices with named axes."""

    def __init__(self, devices: Any, axis_names: "tuple[str, ...]") -> None:
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"device grid has {grid.ndim} axes for {len(axis_names)} axis names"
            )
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: dict[str, int] = dict(zip(self.axis_names, grid.shape))

    def device_at(self, **coords: int) -> torch.device:
        """The device at the named coordinates; axes the mesh lacks (or
        the caller leaves out) read as 0."""
        return self.devices[tuple(coords.get(name, 0) for name in self.axis_names)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


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
    """
    if devices is None:
        devices = default_devices(device)
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = {"time": len(devices)}
    shape = tuple(axis_sizes.values())
    total = int(np.prod(shape))
    if total > len(devices):
        raise ValueError(
            f"mesh needs {total} devices, only {len(devices)} available"
        )
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape(shape), tuple(axis_sizes.keys()))
