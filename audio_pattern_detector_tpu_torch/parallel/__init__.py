"""Scale-out over several devices: device meshes, sequence parallelism,
bank sharding.

Port of audio_pattern_detector_tpu/parallel/. The reference is a
single-threaded streaming pipeline (reference:
audio_pattern_detector.py:295-331); its only sequence-scaling mechanism is
overlap-save chunking with a per-clip lookback window. This package
distributes exactly that algebra over a mesh of ``torch.device``s, driven
by one process or, under a ``torch.distributed`` group the caller
initialised, by one process per host in lockstep (each process feeds and
reads only its own streams' rows):

* ``sequence``: a long stream is sharded along time; each device prepends
  a halo of ``sliding_window`` seconds copied from its left neighbour,
  making every device's section identical to the serial engine's chunk
  section. A ``stream`` mesh axis adds data parallelism over independent
  streams.
* ``bankshard``: the clip bank (the "model" dimension) is sharded across
  devices when it outgrows one device's memory.
* ``mesh``: the device grid, with logical shards for machines that have
  one device, its layout over the processes of a group, and the lockstep
  agreement on each round.
"""

from audio_pattern_detector_tpu_torch.parallel.bankshard import (
    BankShardedBank,
    pad_group_consts,
    shard_group_consts,
)
from audio_pattern_detector_tpu_torch.parallel.mesh import Mesh, RowSharding, make_mesh
from audio_pattern_detector_tpu_torch.parallel.sequence import (
    ShardedDetector,
    ShardedStreamSession,
    detections_from_sharded,
)

__all__ = [
    "BankShardedBank",
    "Mesh",
    "RowSharding",
    "make_mesh",
    "pad_group_consts",
    "shard_group_consts",
    "ShardedDetector",
    "ShardedStreamSession",
    "detections_from_sharded",
]
