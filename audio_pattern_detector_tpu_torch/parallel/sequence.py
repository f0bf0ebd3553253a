"""Sequence-parallel detection: one long stream sharded across the mesh.

Port of audio_pattern_detector_tpu/parallel/sequence.py. The serial engine
scans a stream as overlapping sections (chunk + ``sliding_window`` seconds
of lookback; reference: audio_pattern_detector.py:400-412). Here every
device owns one chunk-sized time slice of the stream and receives its
lookback halo from the left neighbour by a device-to-device copy, so each
device's section is bit-identical to the section the serial loop would
have built for that chunk index: the FFT-correlation equivalent of ring
attention's halo exchange. A second mesh axis ("stream") runs independent
streams in parallel (DP); a third ("bank") splits every group's clips.

The controller is one process. For every (stream, time, bank) cell of the
mesh and every sliding-window class it places the cell's block on the
cell's device, builds the section there and enqueues the batched class
step under that device's guard; every cell of every class is enqueued
before any payload is awaited. The candidate-scan kernel runs in every
cell, on that cell's rows. With logical shards (one device named several
times, ``parallel/mesh.py``) the cells run one after another on it and the
halo "copy" is a slice.

Unbounded streams scan in successive slabs: a :class:`ShardedStreamSession`
carries the lookback tail from one slab to the next (time shard 0 of slab
k+1 takes its halo from the host-carried tail), and a short final slab is
zero-padded with per-device validity masking: the distributed equivalents
of the serial loop's ``previous_chunk`` carry and final-short-chunk
handling. Candidate-capacity overflow on any (stream, device, clip) cell
re-runs that cell's exact section (wide device rerun or host path),
preserving the serial engine's exactness contract
(reference: audio_pattern_detector.py:520-546).

Timestamp algebra on the host matches the serial engine exactly: the
stream's first chunk is lookback-free, every other chunk subtracts its
sliding-window seconds.

On a mesh that spans processes (one process per host, a
``torch.distributed`` group; ``parallel/mesh.py``) the "stream" axis
splits over the processes and each process owns whole (time x bank)
slices of its streams, so the halo copy and the payload unpack stay inside
the process. Each process feeds only its own streams' rows and gets their
results; every process feeds every slab, and the processes agree on the
slab (index, length, rows) with one small collective before it runs.
Nothing else crosses processes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.models.bank import (
    PatternBank,
    PayloadHandle,
    unpack_group,
)
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
from audio_pattern_detector_tpu_torch.ops.consts import consts_to_device
from audio_pattern_detector_tpu_torch.ops.devices import canonical_device, device_guard
from audio_pattern_detector_tpu_torch.parallel.bankshard import (
    pad_group_consts,
    slice_group_consts,
)
from audio_pattern_detector_tpu_torch.parallel.mesh import Mesh, lockstep
from audio_pattern_detector_tpu_torch.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip


class ShardedDetector:
    """Detector over a (stream, time) device mesh.

    ``detect(audio)`` takes a (B, T) float32 batch of equal-length streams
    of any positive length, shards B over the optional "stream" axis and
    time over the "time" axis (one chunk per time-device, looping over
    slabs for long streams), and returns per-stream, per-clip timestamps
    identical to running the serial engine with ``seconds_per_chunk =
    chunk_seconds`` on each stream. ``session()`` exposes the incremental
    slab-feeding form for unbounded streams.

    The bank lives on ``detector``'s device, or, when the detector is
    built here, on ``device`` (default: this process's first cell's
    device); the cells work against replicas on their own devices.

    On a mesh that spans processes, B counts this process's streams and
    the results are theirs; every process feeds the same slab lengths in
    lockstep.
    """

    def __init__(
        self,
        audio_clips: list[AudioClip],
        mesh: Mesh,
        chunk_seconds: int,
        target_sample_rate: "int | None" = None,
        height_min: "float | None" = None,
        detector: "TorchAudioPatternDetector | None" = None,
        device: "torch.device | str | None" = None,
    ) -> None:
        if "time" not in mesh.axis_names:
            raise ValueError("mesh must have a 'time' axis")
        self.mesh = mesh
        self.time_size = mesh.shape["time"]
        self.stream_size = mesh.shape.get("stream", 1)
        self.bank_size = mesh.shape.get("bank", 1)
        self.chunk_seconds = chunk_seconds
        # This process's streams of the mesh (all of them in one process).
        self.local_streams = [
            s for s in range(self.stream_size)
            if any(mesh.is_local(stream=s, time=d, bank=k)
                   for d in range(self.time_size) for k in range(self.bank_size))
        ]

        # Multi-host contract: the "stream" axis spans processes
        # (process-contiguous rows: make_mesh lays the grid out
        # process-major), and every process owns whole (time × bank)
        # slices so the halo copy and the payload unpack stay in the
        # process. Each process then feeds only its own streams' rows;
        # nothing but the lockstep agreement crosses processes.
        self.process_count = mesh.process_count
        if self.process_count > 1:
            if self.stream_size % self.process_count != 0:
                raise ValueError(
                    f"multi-host mesh needs the stream axis "
                    f"({self.stream_size}) divisible by the process count "
                    f"({self.process_count})"
                )
            local_slices = (
                (self.stream_size // self.process_count)
                * self.time_size
                * self.bank_size
            )
            if local_slices != mesh.local_device_count:
                raise ValueError(
                    f"multi-host mesh places {local_slices} devices per "
                    f"process but {mesh.local_device_count} are local; "
                    "order the mesh stream-outermost with time x bank "
                    "within one host"
                )
            # The counts agree, but the halo copy and the unpack also need
            # every (time x bank) cell of this process's streams.
            for s in self.local_streams:
                for d in range(self.time_size):
                    for k in range(self.bank_size):
                        if not mesh.is_local(stream=s, time=d, bank=k):
                            cell = {a: c for a, c in (("stream", s), ("time", d), ("bank", k))
                                    if a in mesh.axis_names}
                            raise ValueError(
                                f"multi-host mesh: cell {cell} of stream {s} belongs to "
                                f"process {mesh.process_of(**cell)}, but this process "
                                f"({mesh.process_index}) holds other cells of that stream; "
                                "each process must own whole time x bank slices of its "
                                "streams (order the mesh stream-outermost)"
                            )

        # Slab bound first, before the serial detector's own per-chunk
        # f32-exactness guard, so oversized mesh configs get the error
        # that names the mesh knob (time axis), not just chunk size.
        sr = (
            detector.target_sample_rate
            if detector is not None
            else (target_sample_rate or DEFAULT_TARGET_SAMPLE_RATE)
        )
        if self.time_size * chunk_seconds * sr >= 2**31:
            # Device-side sample counts are int32.
            raise ValueError(
                f"slab of {self.time_size * chunk_seconds * sr} samples "
                "exceeds the int32 sample-index range; reduce "
                "chunk_seconds or the time axis"
            )

        if detector is not None:
            # Reuse a caller-built serial detector (the CLI mesh path) so
            # clip validation / chunk resolution run once, not twice.
            if detector.seconds_per_chunk != chunk_seconds:
                raise ValueError(
                    "detector.seconds_per_chunk "
                    f"{detector.seconds_per_chunk} != chunk_seconds {chunk_seconds}"
                )
            self._detector = detector
        else:
            self._detector = TorchAudioPatternDetector(
                audio_clips=audio_clips,
                device=device if device is not None else mesh.device_at(stream=self.local_streams[0]),
                seconds_per_chunk=chunk_seconds,
                target_sample_rate=target_sample_rate,
                height_min=height_min,
            )
        self.sample_rate = self._detector.target_sample_rate
        self.chunk_samples = chunk_seconds * self.sample_rate
        self.slab_samples = self.time_size * self.chunk_samples
        self.bank: PatternBank = self._detector._ensure_bank()
        self.max_halo = max(
            sw * self.sample_rate for sw in self.bank.classes
        )
        # The candidate scan of every cell's class step: the kernel
        # wrapper; a probe may substitute the plain version.
        self.scan = candidate_scan
        # Per-class group consts, padded to a bank-axis-divisible clip
        # count when the mesh has a "bank" axis (2-D bank × time sharding;
        # padded rows duplicate clip 0 and are sliced off on unpack).
        self._class_consts: dict[int, tuple] = {}
        for sw, cls in self.bank.classes.items():
            consts = []
            for g in cls["groups"]:
                g_real = len(g.names)
                g_pad = -(-g_real // self.bank_size) * self.bank_size
                consts.append(pad_group_consts(g.corr, g.verify, g_pad))
            self._class_consts[sw] = tuple(consts)
        # (sliding_window, bank shard, device) -> (loud, group_consts)
        self._cell_consts: dict[tuple[int, int, torch.device], tuple] = {}

    # ── device program ──

    def _consts_for(self, sw: int, k: int, dev: torch.device) -> tuple:
        """(loud, group_consts) of bank shard ``k`` of class ``sw`` on
        ``dev``, built once per device."""
        key = (sw, k, dev)
        if key not in self._cell_consts:
            if self.bank_size == 1:
                loud, groups = self.bank.replica(sw, dev)
            else:
                # A bank shard holds its slice only: the whole class's
                # group constants never go to its device.
                loud = self.bank.replica_loud(sw, dev)
                groups = tuple(
                    tuple(
                        consts_to_device(c, dev)
                        for c in slice_group_consts(corr, verify, k, self.bank_size)
                    )
                    for corr, verify in self._class_consts[sw]
                )
            self._cell_consts[key] = (loud, groups)
        return self._cell_consts[key]

    def _dispatch_class(
        self,
        sw: int,
        blocks: NDArray[np.float32],  # (B, Dt, chunk) host slab
        prev_tail: "NDArray[np.float32] | None",  # (B, halo), None at the stream head
        owned_d: NDArray[np.int64],  # (Dt,) samples each time shard owns
    ) -> "list[tuple[int, int, int, PayloadHandle]]":
        """Enqueue one class's step on every active cell; (stream shard,
        time shard, bank shard, payload handle) per cell. Time shards that
        own no sample of a short slab are not run."""
        halo = sw * self.sample_rate
        b_local = blocks.shape[0] // len(self.local_streams)
        on_dev: dict[tuple[torch.device, int, int], torch.Tensor] = {}

        def cell_device(s: int, d: int, k: int) -> torch.device:
            return canonical_device(self.mesh.device_at(stream=s, time=d, bank=k))

        def block_on(dev: torch.device, s: int, d: int) -> torch.Tensor:
            key = (dev, s, d)
            if key not in on_dev:
                rows = blocks[s * b_local : (s + 1) * b_local, d]
                on_dev[key] = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
            return on_dev[key]

        # ``s`` numbers this process's streams of the mesh, ``gs`` is the
        # stream axis's coordinate.
        cells = []
        for s, gs in enumerate(self.local_streams):
            for d in range(self.time_size):
                owned = int(owned_d[d])
                if owned == 0:
                    continue
                for k in range(self.bank_size):
                    dev = cell_device(gs, d, k)
                    local = block_on(dev, s, d)
                    if d > 0:
                        # The left neighbour's last ``halo`` samples: a copy
                        # between the two devices (ordered against both
                        # devices' current streams), a slice on one device.
                        left = block_on(cell_device(gs, d - 1, k), s, d - 1)
                        section = torch.cat([left[:, -halo:].to(dev), local], dim=1)
                        n_valid = owned + halo
                    elif prev_tail is not None:
                        tail = prev_tail[s * b_local : (s + 1) * b_local]
                        carried = torch.from_numpy(np.ascontiguousarray(tail)).to(dev)
                        section = torch.cat([carried, local], dim=1)
                        n_valid = owned + halo
                    else:
                        # The stream head has no lookback.
                        section = torch.cat([local, local.new_zeros((b_local, halo))], dim=1)
                        n_valid = owned
                    with device_guard(dev):
                        lens = torch.full((b_local,), n_valid, dtype=torch.int32, device=dev)
                        fused = self.bank.step(
                            sw, section, lens, self._consts_for(sw, k, dev), scan=self.scan
                        )
                        cells.append((s, d, k, PayloadHandle(fused)))
        return cells

    # ── host API ──

    def session(self) -> "ShardedStreamSession":
        """Start an incremental scan: feed slab after slab of one stream
        batch; results are serial-engine-identical across slab boundaries."""
        return ShardedStreamSession(self)

    def detect(self, audio: NDArray[np.float32]) -> dict[str, list[list[float]]]:
        """Scan a (B, T) batch of streams of any length T > 0; returns
        name -> per-stream sorted timestamp lists (serial-engine-identical
        algebra). Long streams loop over mesh-sized slabs internally."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        B, T = audio.shape
        if T <= 0:
            raise ValueError("stream length must be positive")

        sess = self.session()
        results: dict[str, list[list[float]]] = {
            name: [[] for _ in range(B)]
            for cls in self.bank.classes.values()
            for g in cls["groups"]
            for name in g.names
        }
        for start in range(0, T, self.slab_samples):
            slab = audio[:, start : start + self.slab_samples]
            part = sess.feed(slab)
            for name, per_stream in part.items():
                for b in range(B):
                    results[name][b].extend(per_stream[b])
        for name in results:
            for b in range(B):
                results[name][b].sort()
        return results


class ShardedStreamSession:
    """Carries lookback state between successive slabs of one stream batch.

    Every ``feed`` must supply a full slab (``time_axis × chunk_samples``
    samples per stream) except the last, which may be shorter; after a
    short slab the stream is finished and further feeds are rejected:
    the same contract as the serial loop, where only the final chunk may
    be short.
    """

    def __init__(self, sd: ShardedDetector) -> None:
        self._sd = sd
        self._carry: NDArray[np.float32] | None = None  # (B, max_halo)
        self._base = 0  # global chunk index of the next slab's device 0
        self._batch: int | None = None
        self._finished = False
        # The last slab's payloads as the host unpacked them: per class,
        # per group, a (B, Dt, G, 2K+2) array (rows of time shards that
        # owned nothing are zero).
        self.last_payloads: dict[int, list[NDArray[np.float32]]] = {}

    def feed(self, slab: NDArray[np.float32]) -> dict[str, list[list[float]]]:
        """One slab; returns name -> per-stream timestamp lists.

        Multi-host: every process calls feed in lockstep with the SAME
        slab length but only its OWN streams' rows (the same count on each
        process); the returned results cover this process's streams."""
        sd = self._sd
        slab = np.asarray(slab, dtype=np.float32)
        if slab.ndim == 1:
            slab = slab[None, :]
        B, t_actual = slab.shape
        if sd.process_count > 1:
            lockstep("a slab", slab=self._base // sd.time_size, length=t_actual, rows=B)
        if self._finished:
            raise ValueError(
                "stream already finished: a short slab must be the last"
            )
        if self._batch is None:
            local_groups = len(sd.local_streams)
            if B % local_groups != 0:
                raise ValueError(
                    f"batch {B} must be divisible by this process's share "
                    f"of the stream axis ({local_groups})"
                )
            self._batch = B
        elif B != self._batch:
            raise ValueError(f"batch changed between slabs: {self._batch} -> {B}")
        if t_actual <= 0 or t_actual > sd.slab_samples:
            raise ValueError(
                f"slab length {t_actual} must be in (0, {sd.slab_samples}]"
            )
        if t_actual < sd.slab_samples:
            self._finished = True

        padded = slab
        if t_actual < sd.slab_samples:
            padded = np.zeros((B, sd.slab_samples), dtype=np.float32)
            padded[:, :t_actual] = slab
        blocks = padded.reshape(B, sd.time_size, sd.chunk_samples)

        has_prev = self._carry is not None
        sr = sd.sample_rate
        chunk = sd.chunk_samples
        results: dict[str, list[list[float]]] = {}

        # Per-device stream algebra, shared by every class below.
        d_idx = np.arange(sd.time_size)
        owned_d = np.clip(t_actual - d_idx * chunk, 0, chunk)  # (Dt,)
        active_d = owned_d > 0
        index_d = self._base + d_idx

        # Phase 1: enqueue EVERY class's cells back-to-back (each
        # payload's copy to the host enqueued with it) so no class waits
        # on an earlier class's blocking unpack before its work is even
        # enqueued.
        dispatched = []
        for sw, cls in sd.bank.classes.items():
            halo = sw * sr
            if has_prev:
                assert self._carry is not None
                prev_tail = np.ascontiguousarray(self._carry[:, -halo:])
            else:
                prev_tail = np.zeros((B, halo), dtype=np.float32)
            cells = sd._dispatch_class(
                sw, blocks, prev_tail if has_prev else None, owned_d
            )
            dispatched.append((sw, cls, halo, prev_tail, cells))

        # Phase 2: blocking unpack + flag resolution per class.
        for sw, cls, halo, prev_tail, cells in dispatched:
            subtract_d = np.where((d_idx > 0) | has_prev, sw, 0.0)  # (Dt,)
            outs = _stitch_cells(sd, cls, B, cells)
            self.last_payloads[sw] = outs

            # Pass 1 (vectorised): clean timestamps per group + flagged
            # cells collected per (b, d) section.
            group_arrays = []
            flagged_cells: dict[tuple[int, int], list[tuple[int, int, bool]]] = {}
            for gi, (g, out) in enumerate(zip(cls["groups"], outs)):
                g_real = len(g.names)
                packed = out[:, :, :g_real, :]
                pos, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
                clip_seconds = g.clip_len / sr

                # Vectorised timestamp algebra over (B, Dt, G, K):
                # t = pos/sr - subtract + index*chunk_s - clip_s, clamped.
                t_all = np.maximum(
                    pos / sr
                    - subtract_d[None, :, None, None]
                    + index_d[None, :, None, None] * sd.chunk_seconds
                    - clip_seconds,
                    0.0,
                )
                flagged = host_fb | needs_full  # (B, Dt, G)
                clean = (
                    sel
                    & ~flagged[..., None]
                    & active_d[None, :, None, None]
                )
                group_arrays.append((g, t_all, clean, clip_seconds))
                for b, d, ci in np.argwhere(
                    flagged & active_d[None, :, None]
                ):
                    flagged_cells.setdefault((int(b), int(d)), []).append(
                        (gi, int(ci), bool(host_fb[b, d, ci]))
                    )

            # Pass 2 (rare): resolve flagged cells exactly: row-granular
            # wide-tier DEVICE reruns (whole-class rerun above the row
            # threshold), host path only for flag-1 / rerun overflow.
            cell_times: dict[tuple[int, int, int], list[float]] = {}
            for (b, d), triples in flagged_cells.items():
                raw = _device_section(
                    slab, prev_tail, b, d, chunk, halo,
                    int(owned_d[d]), has_prev,
                )
                resolved = sd.bank.resolve_flagged_rows(sw, triples, raw)
                for (gi, ci), hits in resolved.items():
                    clip_seconds = group_arrays[gi][3]
                    cell_times.setdefault((gi, b, ci), []).extend(
                        max(
                            p / sr
                            - subtract_d[d]
                            + index_d[d] * sd.chunk_seconds
                            - clip_seconds,
                            0.0,
                        )
                        for p in hits
                    )

            # Pass 3: assemble per-clip per-stream sorted lists. One
            # nonzero + lexsort + searchsorted per group replaces a
            # per-(clip, stream) boolean-mask/sort loop: the surviving
            # Python work is only the required list construction per cell.
            for gi, (g, t_all, clean, _cs) in enumerate(group_arrays):
                n_clips = len(g.names)
                b_f, _d_f, c_f, _k_f = np.nonzero(clean)
                t_f = t_all[clean]
                # lexsort: last key is primary → grouped by clip, then
                # stream, time-ascending within each (clip, stream) cell.
                order = np.lexsort((t_f, b_f, c_f))
                t_sorted = t_f[order]
                cell_key = c_f[order] * B + b_f[order]
                bounds = np.searchsorted(
                    cell_key, np.arange(n_clips * B + 1)
                )
                for ci, name in enumerate(g.names):
                    per_stream: list[list[float]] = []
                    for b in range(B):
                        cell = ci * B + b
                        times = t_sorted[bounds[cell] : bounds[cell + 1]].tolist()
                        extra = cell_times.get((gi, b, ci))
                        if extra:
                            times = sorted(times + extra)
                        per_stream.append(times)
                    results[name] = per_stream
        # Advance carry/base for the next slab. A full slab always covers
        # the carry: the detector invariant chunk >= 2*sliding_window gives
        # slab_samples >= chunk_samples >= 2*max_halo.
        if not self._finished:
            self._carry = np.ascontiguousarray(slab[:, -sd.max_halo :])
            self._base += sd.time_size
        return results


def _stitch_cells(
    sd: ShardedDetector,
    cls: dict[str, Any],
    batch: int,
    cells: "list[tuple[int, int, int, PayloadHandle]]",
) -> list[NDArray[np.float32]]:
    """Wait for a class's cells and lay their fused payloads out as one
    (B, Dt, G_padded, 2K+2) array per group (zeros where no cell ran)."""
    b_local = batch // len(sd.local_streams)
    shapes = []
    for g in cls["groups"]:
        g_pad = -(-len(g.names) // sd.bank_size) * sd.bank_size
        shapes.append((g_pad // sd.bank_size, 2 * g.k_verify + 2))
    outs = [
        np.zeros((batch, sd.time_size, g_local * sd.bank_size, w), dtype=np.float32)
        for g_local, w in shapes
    ]
    for s, d, k, handle in cells:
        flat = handle.numpy()  # (b_local, total of this bank shard)
        off = 0
        for out, (g_local, w) in zip(outs, shapes):
            part = flat[:, off : off + g_local * w].reshape(b_local, g_local, w)
            out[s * b_local : (s + 1) * b_local, d, k * g_local : (k + 1) * g_local] = part
            off += g_local * w
    return outs


def _device_section(
    slab: NDArray[np.float32],
    prev_tail: NDArray[np.float32],
    b: int,
    d: int,
    chunk: int,
    halo: int,
    owned: int,
    has_prev: bool,
) -> NDArray[np.float32]:
    """Reconstruct the exact raw section device (b, d) scanned: the
    input of the rerun and of the host path for flagged cells."""
    start = d * chunk
    end = start + owned
    if d == 0:
        if has_prev:
            return np.concatenate([prev_tail[b, -halo:], slab[b, :end]])
        return np.ascontiguousarray(slab[b, :end])
    return np.ascontiguousarray(slab[b, start - halo : end])


def detections_from_sharded(
    results: dict[str, list[list[float]]], stream_index: int = 0
) -> dict[str, list[float]]:
    """Flatten a ShardedDetector result to the serial engine's dict shape."""
    return {name: per_stream[stream_index] for name, per_stream in results.items()}
