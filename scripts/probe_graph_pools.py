#!/usr/bin/env python3
"""Graph memory around CUDA conditional nodes, on the card.

    python3 scripts/probe_graph_pools.py

Each case captures one small graph with ``models/captured.py``'s
``CudaGraphBackend`` (the backend of the captured class steps) and prints,
as one JSON line, the GB that the backend's graph pool and its bodies' pool
keep afterwards (from the allocator's segments), beside the GB that the
case's tensors need at once. What the cases ask: does a block freed on the
capture stream get reused after a node, after a body read it, and does a
body reuse what an earlier body freed?

* ``plain``: 1 GB allocated, freed, 1 GB allocated again; no node.
* ``after_node``: the same with an if-node (empty body) between the two.
* ``read_in_body``: the first 1 GB is read by an if-node's body, then freed;
  then 1 GB again.
* ``two_bodies``: two if-nodes whose bodies each make a 1 GB temporary.
* ``while_body``: a while node whose body makes a 1 GB temporary, three
  passes at replay.

Every graph is replayed once and its result checked.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audio_pattern_detector_tpu_torch.models.captured import CudaGraphBackend  # noqa: E402

GB = 2**30 // 4  # f32 elements in 1 GiB


def pools(backend: CudaGraphBackend) -> dict[str, float]:
    by_pool: dict = {}
    for seg in torch.cuda.memory_snapshot():
        key = tuple(seg["segment_pool_id"])
        by_pool[key] = by_pool.get(key, 0) + seg["total_size"]
    return {name: sum(by_pool.get(tuple(pool), 0) for pool, _ in held.values()) / 2**30
            for name, held in (("graph_gib", backend._devices), ("bodies_gib", backend._bodies))}


def case(name: str, fn, check) -> None:
    dev = torch.device("cuda")
    backend = CudaGraphBackend()
    replay, out = backend.capture(dev, lambda: fn(dev, backend))
    replay()
    torch.cuda.synchronize()
    ok = bool(check(out))
    torch.cuda.empty_cache()
    print(json.dumps({"case": name, **pools(backend), "result_ok": ok}), flush=True)
    del replay, out, backend
    torch.cuda.empty_cache()


def plain(dev, backend):
    a = torch.ones(GB, device=dev)
    s = a.amax()
    del a
    b = torch.full((GB,), 2.0, device=dev)
    return torch.stack([s, b.amax()])


def after_node(dev, backend):
    a = torch.ones(GB, device=dev)
    s = a.amax()
    del a
    backend.conditional(torch.ones((), dtype=torch.bool, device=dev), lambda: None)
    b = torch.full((GB,), 2.0, device=dev)
    return torch.stack([s, b.amax()])


def read_in_body(dev, backend):
    a = torch.ones(GB, device=dev)
    s = torch.zeros((), device=dev)
    backend.conditional(torch.ones((), dtype=torch.bool, device=dev), lambda: s.copy_(a.amax()))
    del a
    b = torch.full((GB,), 2.0, device=dev)
    return torch.stack([s, b.amax()])


def two_bodies(dev, backend):
    s = torch.zeros(2, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)
    backend.conditional(go, lambda: s[0].copy_(torch.ones(GB, device=dev).amax()))
    backend.conditional(go, lambda: s[1].copy_(torch.full((GB,), 2.0, device=dev).amax()))
    return s


def while_body(dev, backend):
    i = torch.zeros((), dtype=torch.int64, device=dev)
    s = torch.zeros((), device=dev)
    go = i < 3

    def body():
        s.add_(torch.ones(GB, device=dev).amax())
        i.add_(1)
        torch.lt(i, 3, out=go)

    backend.while_loop(go, body)
    return s


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_graph_pools: needs a CUDA card", file=sys.stderr)
        return 2
    case("plain", plain, lambda o: o.tolist() == [1.0, 2.0])
    case("after_node", after_node, lambda o: o.tolist() == [1.0, 2.0])
    case("read_in_body", read_in_body, lambda o: o.tolist() == [1.0, 2.0])
    case("two_bodies", two_bodies, lambda o: o.tolist() == [1.0, 2.0])
    case("while_body", while_body, lambda o: o.item() == 3.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
