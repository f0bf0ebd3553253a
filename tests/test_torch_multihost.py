"""The port's mesh paths in one process per host: 2 processes, one mesh.

Twin of tests/test_multihost.py and tests/multihost_worker.py. Two CPU
processes join a ``torch.distributed`` group on gloo (the CPU stand-in for
the hosts' network), each with 2 logical shards of its CPU device:

* ``ShardedDetector`` over ``stream(2) x time(2)``: each process feeds only
  its own stream, two slabs, with a hit straddling the slab boundary;
* ``MultiStreamSession`` over ``stream(4)``: 2 local slots a process,
  3 rounds in lockstep;
* slabs of different lengths, and session rounds of different widths, on
  the two processes: both raise ValueError, neither hangs;
* the JAX package's multi-host validations, with its error strings.

Each worker holds its results to the port's serial engine and prints
them; this test holds them to the JAX serial engine on the same audio.
The workers never import jax. The worker is this file:
``python tests/test_torch_multihost.py <rank> <port>``.
"""

from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np

SR = 8000
CHUNK_S = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

# The JAX package's messages (parallel/sequence.py:136-153,
# models/multistream.py:146-173) for the meshes the worker builds, and the
# port's own for a time-outermost mesh, whose device counts agree but whose
# streams each span both processes (process ``rank`` meets first the cell
# of its stream 0 that the other process owns).
EXPECTED_ERRORS = {
    "detector_stream_not_divisible": "multi-host mesh needs the stream axis (3) divisible by "
                                     "the process count (2)",
    "detector_count_mismatch": "multi-host mesh places 2 devices per process but 4 are local; "
                               "order the mesh stream-outermost with time x bank within one host",
    "detector_time_outermost": "multi-host mesh: cell {{'stream': 0, 'time': {other}}} of stream 0 "
                               "belongs to process {other}, but this process ({rank}) holds other "
                               "cells of that stream; each process must own whole time x bank "
                               "slices of its streams (order the mesh stream-outermost)",
    "session_not_1d": "multi-host MultiStreamSession requires a 1-D 'stream' mesh, got axes "
                      "('stream', 'time')",
    "session_stream_not_divisible": "stream axis (3) must be divisible by the process count (2)",
    "session_not_contiguous": "multi-host mesh: stream-axis device order must be "
                              "process-contiguous",
    "session_slots_not_divisible": "n_streams 3 (local) must be divisible by this process's "
                                   "stream-axis devices (2)",
}


def _clip_audio() -> np.ndarray:
    """The 1 s clip both processes (and the parent) build from seed 0."""
    return (0.4 * np.random.default_rng(0).standard_normal(SR)).astype(np.float32)


def _sharded_audio(rank: int) -> np.ndarray:
    """8 s for one process's stream: two slabs of time(2) x 2 s; hits at
    a rank-specific offset, across the 4 s slab boundary and in slab 2."""
    clip = _clip_audio()
    audio = (0.01 * np.random.default_rng(100 + rank).standard_normal(8 * SR)).astype(np.float32)
    for off in (1.0 + 0.5 * rank, 3.5, 5.25):
        o = int(off * SR)
        audio[o : o + SR] += clip
    return audio


def _session_audio(rank: int) -> list[np.ndarray]:
    """Each of a process's 2 local streams: 3 chunks, hits in chunk 0 and
    one running into chunk 2's lookback."""
    clip = _clip_audio()
    streams = []
    for si in range(2):
        a = (0.01 * np.random.default_rng(200 + 10 * rank + si).standard_normal(3 * CHUNK_S * SR))
        a = a.astype(np.float32)
        for off in (0.5 + 0.25 * si + 0.1 * rank, 3.75):
            o = int(off * SR)
            a[o : o + SR] += clip
        streams.append(a)
    return streams


# ── The worker: one process of the group ──


def _worker(rank: int, port: int) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.parallel.mesh import Mesh, make_mesh
    from audio_pattern_detector_tpu_torch.parallel.sequence import ShardedDetector
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
        timeout=timedelta(seconds=60),
    )
    cpu = torch.device("cpu")
    clip = AudioClip(name="c", audio=_clip_audio(), sample_rate=SR)
    det = TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=CHUNK_S)

    def serial(audio: np.ndarray) -> tuple[dict, float]:
        return det.find_clip_in_audio(
            AudioStream(name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR)
        )

    def report(tag: str, value) -> None:
        print(f"{tag} {rank} {json.dumps(value)}", flush=True)

    # ── ShardedDetector over stream(2) x time(2): this process's stream ──
    mesh = make_mesh({"stream": 2, "time": 2}, devices=[cpu] * 2)
    owned = [int(p) for p in mesh.process_indices.flat]
    assert owned == [0, 0, 1, 1], owned
    sd = ShardedDetector([clip], mesh, chunk_seconds=CHUNK_S, detector=det)
    assert sd.process_count == 2 and sd.local_streams == [rank], sd.local_streams
    audio = _sharded_audio(rank)
    res = sd.detect(audio[None, :])
    want, _ = serial(audio)
    assert res["c"][0] == sorted(want["c"]), (rank, res, want)
    assert len(res["c"][0]) >= 3, (rank, res)
    report("SHARDED", res["c"][0])

    # ── MultiStreamSession over stream(4): 2 local slots, 3 rounds ──
    ms_mesh = make_mesh({"stream": 4}, devices=[cpu] * 2)
    session = MultiStreamSession(det, n_streams=2, mesh=ms_mesh)
    streams = _session_audio(rank)
    chunk = CHUNK_S * SR
    got: list[list[float]] = [[], []]
    for r in range(3):
        out = session.feed([s[r * chunk : (r + 1) * chunk] for s in streams])
        for si in range(2):
            got[si].extend(out[si].get("c", []))
    totals = []
    for si in range(2):
        peaks, total = serial(streams[si])
        assert sorted(got[si]) == sorted(peaks["c"]), (rank, si, got[si], peaks)
        assert len(got[si]) >= 2, (rank, si, got)
        assert session.total_time(si) == total, (session.total_time(si), total)
        totals.append(total)
    report("SESSION", {"times": [sorted(g) for g in got], "totals": totals})

    # ── Slabs of different lengths: both processes raise ──
    lengths = [sd.slab_samples, sd.slab_samples - SR]
    try:
        sd.session().feed(audio[None, : lengths[rank]])
    except ValueError as exc:
        report("MISMATCH", str(exc))
    else:
        raise AssertionError("slabs of different lengths were accepted")

    # ── Session rounds of different widths: both processes raise ──
    try:
        session.feed([s[:chunk] for s in streams][: 2 - rank])
    except ValueError as exc:
        report("ROUND_MISMATCH", str(exc))
    else:
        raise AssertionError("rounds of different widths were accepted")

    # ── The multi-host validations ──
    def error(name: str, build) -> None:
        try:
            build()
        except ValueError as exc:
            report("ERROR", [name, str(exc)])
        else:
            raise AssertionError(f"{name}: no error")

    three = make_mesh({"stream": 3}, devices=[cpu] * 2)
    three_st = make_mesh({"stream": 3, "time": 1}, devices=[cpu] * 2)
    time_outer = make_mesh({"time": 2, "stream": 2}, devices=[cpu] * 2)
    four_local = make_mesh({"stream": 2, "time": 2}, devices=[cpu] * 4)  # 2 cells each, 4 listed
    two_d = make_mesh({"stream": 2, "time": 2}, devices=[cpu] * 2)
    grid = np.array([cpu if p == rank else None for p in (0, 1, 0, 1)], dtype=object)
    interleaved = Mesh(grid, ("stream",), process_indices=[0, 1, 0, 1], local_device_count=2)
    error("detector_stream_not_divisible",
          lambda: ShardedDetector([clip], three_st, chunk_seconds=CHUNK_S, detector=det))
    error("detector_count_mismatch",
          lambda: ShardedDetector([clip], four_local, chunk_seconds=CHUNK_S, detector=det))
    error("detector_time_outermost",
          lambda: ShardedDetector([clip], time_outer, chunk_seconds=CHUNK_S, detector=det))
    error("session_not_1d", lambda: MultiStreamSession(det, n_streams=2, mesh=two_d))
    error("session_stream_not_divisible", lambda: MultiStreamSession(det, n_streams=2, mesh=three))
    error("session_not_contiguous", lambda: MultiStreamSession(det, n_streams=2, mesh=interleaved))
    error("session_slots_not_divisible", lambda: MultiStreamSession(det, n_streams=3, mesh=ms_mesh))

    dist.barrier()
    dist.destroy_process_group()
    report("DONE", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "audio_pattern_detector_tpu")))


# ── The test ──


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reports(out: str) -> dict[str, list]:
    found: dict[str, list] = {}
    for line in out.splitlines():
        parts = line.split(" ", 2)
        if len(parts) == 3 and parts[0].isupper() and parts[1].isdigit():
            found.setdefault(parts[0], []).append(json.loads(parts[2]))
    return found


def _jax_serial(audio: np.ndarray, jdet) -> tuple[list[float], float]:
    from audio_pattern_detector_tpu.utils.clip import AudioStream

    peaks, total = jdet.find_clip_in_audio(
        AudioStream(name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR)
    )
    return sorted(peaks["c"]), total


def test_two_processes_match_the_serial_engines():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_", "APD_"))}
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
    from audio_pattern_detector_tpu.utils.clip import AudioClip as JaxClip

    jdet = AudioPatternDetector(
        [JaxClip(name="c", audio=_clip_audio(), sample_rate=SR)], seconds_per_chunk=CHUNK_S
    )
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
        found = _reports(out)
        assert found.get("DONE") == [[]], out  # no jax, nothing of the JAX package
        want, _ = _jax_serial(_sharded_audio(rank), jdet)
        assert found["SHARDED"] == [want], (rank, found["SHARDED"], want)
        session, = found["SESSION"]
        for si, stream in enumerate(_session_audio(rank)):
            times, total = _jax_serial(stream, jdet)
            assert session["times"][si] == times, (rank, si, session, times)
            assert session["totals"][si] == total
        mismatch, = found["MISMATCH"]
        assert mismatch.startswith("processes disagree on a slab: {'length': [32000, 24000]}")
        round_mismatch, = found["ROUND_MISMATCH"]
        assert round_mismatch.startswith("processes disagree on a round: {'rows': [2, 1]}")
        want_errors = {name: msg.format(rank=rank, other=1 - rank)
                       for name, msg in EXPECTED_ERRORS.items()}
        assert dict(found["ERROR"]) == want_errors


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
