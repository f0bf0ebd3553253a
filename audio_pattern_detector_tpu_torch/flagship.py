"""The flagship detection step, a twin of ``__graft_entry__.py::entry``.

A 64-clip bank (32 one-second normal clips of seeded noise, 32 quarter-
second marker tones at 900 + 7i Hz, numpy seed 0) scanning one 60 s chunk
section at 8 kHz (seeded noise, numpy seed 1): the same clips, bank
geometry and section as the JAX package's entry, built by the port.
:func:`flagship_round` is its batched twin: 16 such sections as one round.
:func:`dryrun_multichip` is the twin of ``__graft_entry__.py::dryrun_multichip``:
the same bank on a bank x stream x time mesh, one slab, against the serial
engine.
"""

from __future__ import annotations

import io
from collections.abc import Callable

import numpy as np
import torch

from audio_pattern_detector_tpu_torch.models.detector import MARKER_TONE_STRATEGY
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream
from audio_pattern_detector_tpu_torch.models.bank import PatternBank
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan


def make_detector(
    num_normal: int,
    num_marker: int,
    chunk_seconds: int,
    device: "torch.device | str",
    sr: int = 8000,
    height_min: "float | None" = None,
    extra_clips: "tuple[AudioClip, ...]" = (),
) -> TorchAudioPatternDetector:
    """A detector over a mixed normal/marker clip bank (the serving path
    needs the detector: ``peaks_to_times`` and the clip metadata live
    there). ``extra_clips`` join the bank after the seeded ones;
    ``height_min`` as the detector takes it."""
    rng = np.random.default_rng(0)
    clips = []
    for i in range(num_normal):
        audio = (0.4 * rng.standard_normal(sr)).astype(np.float32)  # 1 s
        clips.append(AudioClip(name=f"normal_{i}", audio=audio, sample_rate=sr))
    m = round(0.25 * sr)
    t = np.arange(m) / sr
    for i in range(num_marker):
        freq = 900.0 + 7.0 * i
        clips.append(
            AudioClip(
                name=f"marker_{i}",
                audio=np.sin(2 * np.pi * freq * t).astype(np.float32),
                sample_rate=sr,
                strategy=MARKER_TONE_STRATEGY,
                strategy_params={"dominant_frequency_hz": freq},
            )
        )
    return TorchAudioPatternDetector(
        [*clips, *extra_clips], device=device, seconds_per_chunk=chunk_seconds,
        height_min=height_min,
    )


def make_bank(
    num_normal: int,
    num_marker: int,
    chunk_seconds: int,
    device: "torch.device | str",
    sr: int = 8000,
) -> PatternBank:
    """The PatternBank of :func:`make_detector`'s detector."""
    return make_detector(num_normal, num_marker, chunk_seconds, device, sr)._ensure_bank()


def flagship_step(
    device: "torch.device | str",
) -> tuple[Callable[..., list[torch.Tensor]], PatternBank]:
    """(step, bank): ``step(scan=candidate_scan)`` runs the class step of
    the flagship bank over the seeded 60 s section and returns each
    group's packed payload."""
    bank = make_bank(num_normal=32, num_marker=32, chunk_seconds=60, device=device)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s = cls["section_len"]
    rng = np.random.default_rng(1)
    section = torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32)).to(bank.device)

    def step(scan=candidate_scan) -> list[torch.Tensor]:
        return bank.step(sw, section, s, scan=scan, fused=False)

    return step, bank


ROUND_ROWS = 16


def flagship_round(
    device: "torch.device | str",
) -> tuple[Callable[..., torch.Tensor], PatternBank, torch.Tensor]:
    """(step, bank, sections): ``step(mode, scan=candidate_scan)`` runs the
    flagship bank's class step over a round of 16 seeded 60 s sections
    (numpy seeds 1-16; row 0 is :func:`flagship_step`'s section), the
    (16, S) ``sections``, and returns the fused (16, total) payload:
    ``mode="vmap"`` as one batched step, ``"scan"`` as 16 steps one after
    another."""
    bank = make_bank(num_normal=32, num_marker=32, chunk_seconds=60, device=device)
    sw = sorted(bank.classes)[0]
    cls = bank.classes[sw]
    s = cls["section_len"]
    sections = torch.from_numpy(np.stack([
        (0.05 * np.random.default_rng(1 + i).standard_normal(s)).astype(np.float32)
        for i in range(ROUND_ROWS)
    ])).to(bank.device)
    n_valids = torch.full((ROUND_ROWS,), s, dtype=torch.int32, device=bank.device)

    def step(mode: str, scan=candidate_scan) -> torch.Tensor:
        if mode == "vmap":
            return bank.step(sw, sections, n_valids, scan=scan)
        return torch.stack([bank.step(sw, sections[i], s, scan=scan) for i in range(ROUND_ROWS)])

    return step, bank, sections


def dryrun_multichip(
    n_devices: int,
    device: "torch.device | str",
    num_normal: int = 32,
    num_marker: int = 32,
    chunk_seconds: int = 60,
) -> dict:
    """Run the full multi-device detection step on an ``n_devices`` mesh and
    hold it against the serial engine.

    Shardings exercised: DP over independent streams ("stream" axis),
    sequence parallelism over time with the halo copied from the left
    neighbour ("time" axis), and, on meshes of 8 or more, the clip bank
    sharded over a "bank" axis (groups auto-padded to divisible sizes).
    When ``device``'s kind offers fewer than ``n_devices`` devices the mesh
    is made of logical shards: the visible devices named in turn until the
    mesh is full. One slab of ``time x chunk_seconds`` seconds per stream
    (seeded noise with one normal clip and one marker tone planted) goes
    through ``ShardedDetector.detect`` and, stream by stream, through the
    serial engine: the timestamps must be identical. Then one round of a
    ``MultiStreamSession`` on a stream mesh, against the same round
    unsharded. Returns the mesh axes and the detection counts."""
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.parallel import ShardedDetector, make_mesh
    from audio_pattern_detector_tpu_torch.parallel.mesh import default_devices

    visible = default_devices(device)
    devices = [visible[i % len(visible)] for i in range(n_devices)]
    if n_devices % 8 == 0:
        axes = {"bank": 2, "stream": 2, "time": n_devices // 4}
    elif n_devices % 2 == 0 and n_devices > 2:
        axes = {"stream": 2, "time": n_devices // 2}
    else:
        axes = {"time": n_devices}
    mesh = make_mesh(axes, devices=devices)

    det = make_detector(num_normal, num_marker, chunk_seconds, device)
    sr = det.target_sample_rate
    sd = ShardedDetector(det.audio_clips, mesh, chunk_seconds=chunk_seconds, detector=det)
    batch = mesh.shape.get("stream", 1)
    total = mesh.shape["time"] * chunk_seconds * sr
    rng = np.random.default_rng(3)
    audio = (0.01 * rng.standard_normal((batch, total))).astype(np.float32)
    normal, marker = det.audio_clips[0], det.audio_clips[num_normal]
    normal_at = (total // 4) // sr
    marker_at = (total // 2) // sr
    for b in range(batch):
        o = (normal_at + b) * sr
        audio[b, o : o + len(normal.audio)] += normal.audio
        o = marker_at * sr
        audio[b, o : o + len(marker.audio)] += 0.7 * marker.audio

    results = sd.detect(audio)
    if set(results) != {c.name for c in det.audio_clips}:
        raise AssertionError(f"sharded results name {sorted(results)}")
    for b in range(batch):
        serial, _ = det.find_clip_in_audio(
            AudioStream(name=f"s{b}", audio_stream=io.BytesIO(audio[b].tobytes()), sample_rate=sr)
        )
        for name, per_stream in results.items():
            if per_stream[b] != serial[name]:
                raise AssertionError(
                    f"stream {b}, {name}: sharded {per_stream[b]} != serial {serial[name]}"
                )
        if not any(abs(ts - (normal_at + b)) < 0.01 for ts in results[normal.name][b]):
            raise AssertionError(f"stream {b}: planted {normal.name} not found: {results}")

    # Mesh-sharded live serving (serve --mesh-stream): one chunk round of N
    # independent streams with the batch rows partitioned across a
    # "stream" axis.
    serve_axis = min(n_devices, 4)
    serve_mesh = make_mesh({"stream": serve_axis}, devices=devices[:serve_axis])
    chunk = (0.01 * rng.standard_normal(chunk_seconds * sr)).astype(np.float32)
    chunk[sr : sr + len(normal.audio)] += normal.audio
    sharded_round = MultiStreamSession(det, n_streams=serve_axis, mesh=serve_mesh).feed(
        [chunk] * serve_axis
    )
    plain_round = MultiStreamSession(det, n_streams=serve_axis, batch_mode="vmap").feed(
        [chunk] * serve_axis
    )
    if sharded_round != plain_round or not all(r[normal.name] for r in sharded_round):
        raise AssertionError(f"sharded serving round {sharded_round} != unsharded {plain_round}")
    return {
        "axes": axes, "logical_shards": len(visible) < n_devices, "streams": batch,
        "slab_s": mesh.shape["time"] * chunk_seconds,
        "detections": sum(len(ts) for per in results.values() for ts in per),
        "serve_axis": serve_axis,
        "serve_detections": sum(len(ts) for r in sharded_round for ts in r.values()),
    }
