"""Multi-stream serving on one torch device: N live streams, one dispatch per round.

Port of audio_pattern_detector_tpu/models/multistream.py. Each round
batches one chunk from every active stream through the port bank's
independent-lookback batch dispatch
(``PatternBank.dispatch_chunks_batch(prev_tails=...)``): per-stream
lookback, timestamp algebra and flagged-row resolution are the serial
engine's, so each stream's detections equal its serial run's. Streams may
end at different times: pass ``None`` for a stream without data (its row
is not dispatched on a tiled session, or runs a zero-length section).

The round logic is the JAX session's: ``feed``, ``dispatch``/``collect``
with any number of rounds in flight, ``round_ready``, the compacted
tile-width ladder, int16 chunks riding through raw, zero-length chunks as
idle rounds, ``total_time`` and ``reset``, and both batch modes
(``batch_mode="scan"``, the default, or ``"vmap"``: one set of launches
per class for all rows of a dispatch). ``mesh=`` (a mesh with a "stream"
axis, ``parallel/mesh.py``) spreads each round's rows over the axis's
devices, in one process or, on a mesh that spans a ``torch.distributed``
group, in one process per host: each process then serves its own slots on
its own cells, and every process runs every round in lockstep.
"""

from __future__ import annotations

import functools
from collections.abc import Sequence
from typing import Any

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.models.bank import RowPayloads
from audio_pattern_detector_tpu_torch.models.detector import (
    StreamCheckpoint,
    TorchAudioPatternDetector,
    _dispatched_ready,
    _f32_copy,
)
from audio_pattern_detector_tpu_torch.utils.profiling import RECORDER


class MultiStreamSession:
    """Batch one chunk from each of N independent streams per dispatch.

    ``feed`` takes one chunk (or ``None``) per stream and returns each
    stream's ``{clip_name: [timestamps]}``; ``dispatch``/``collect`` keep
    several rounds in flight. Chunks are f32 (or raw int16) mono at the
    detector's target sample rate, at most ``seconds_per_chunk`` long. With
    ``tile`` set, a round's active rows dispatch as a greedy decomposition
    over the tile and every power of two below it, and ``collect``
    scatters the rows back to their slots.

    On a CUDA device each dispatch replays the bank's captured class step
    for its width (``models/captured.py``): every width of the tile
    ladder, in each upload dtype, is captured at its first use (``serve``
    warms them all before its first client).
    """

    def __init__(
        self,
        detector: TorchAudioPatternDetector,
        n_streams: int,
        mesh: Any = None,
        batch_mode: str | None = None,
        tile: int | None = None,
    ) -> None:
        if not isinstance(detector, TorchAudioPatternDetector):
            raise TypeError(
                f"the torch port's session needs a TorchAudioPatternDetector, "
                f"got {type(detector).__name__}"
            )
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if tile is not None and tile < 1:
            raise ValueError(f"tile must be >= 1, got {tile}")
        if tile is not None and mesh is not None:
            raise ValueError(
                "tile and mesh are mutually exclusive (a sharded round "
                "must batch all rows for the static row→device layout)"
            )
        if batch_mode not in (None, "scan", "vmap"):
            raise ValueError(
                f"batch_mode must be 'scan' or 'vmap', got {batch_mode!r}"
            )
        # Rows are independent in both schedules, so the mode only chooses
        # how a dispatch's rows reach the device. Default: "scan" on one
        # device; "vmap" when a mesh shards the rows (only the batched
        # step has a row axis to split).
        if batch_mode == "scan" and mesh is not None:
            raise ValueError(
                "batch_mode='scan' cannot shard rows across a mesh; "
                "use 'vmap' (or omit batch_mode) with a mesh"
            )
        self._batch_mode = batch_mode or ("vmap" if mesh is not None else "scan")
        # Serving-capacity tiling: a round's rows dispatch in tiles of at
        # most ``tile`` rows, so device working memory is bounded by the
        # tile, not the slot count. None = one full-width dispatch per
        # round. Tiled rounds compact: only active rows dispatch, as a
        # greedy decomposition over the width ladder (the tile plus every
        # power of two below it), so a partial round never pads and device
        # time and upload bytes follow the active rows.
        self._tile = min(tile, n_streams) if tile is not None else None
        self._tile_widths: list[int] | None = None
        if self._tile is not None:
            widths = {self._tile}
            w = 1
            while w < self._tile:
                widths.add(w)
                w *= 2
            self._tile_widths = sorted(widths, reverse=True)
        self.detector = detector
        self.n_streams = n_streams
        self._bank = detector._ensure_bank()
        sr = detector.target_sample_rate
        self._sr = sr
        self._chunk_samples = int(detector.seconds_per_chunk * sr)
        self._max_sw = max(
            d["sliding_window"] for d in detector._clip_datas.values()
        )
        self._tails: list[NDArray[np.float32] | None] = [None] * n_streams
        self._indices = [0] * n_streams
        self._times = [0.0] * n_streams
        self._empty = np.zeros(0, dtype=np.float32)
        # Optional data parallelism over streams: a mesh with a "stream"
        # axis partitions the batch rows across devices (rows are
        # independent, so nothing crosses devices), and N devices serve
        # N × (n_streams / stream_axis) live stations with the same
        # per-round semantics. Rounds always batch all n_streams rows
        # (idle slots run zero-length sections), so the row→device
        # assignment is static.
        #
        # A mesh that spans processes (one process per host, a
        # torch.distributed group) works too: ``n_streams`` then counts THIS
        # process's local slots, each process feeds only its own rows to
        # its own cells and unpacks only its own payload rows. Contract: all
        # processes call dispatch/collect in lockstep; dispatch agrees on
        # the round with one small collective (``parallel.mesh.lockstep``).
        self._sharding = None
        self._rounds = 0  # rounds dispatched, the index the processes agree on
        if mesh is not None:
            if "stream" not in mesh.axis_names:
                raise ValueError("mesh must have a 'stream' axis")
            stream_size = mesh.shape["stream"]
            n_procs = mesh.process_count
            if n_procs > 1:
                if tuple(mesh.axis_names) != ("stream",):
                    raise ValueError(
                        "multi-host MultiStreamSession requires a 1-D "
                        f"'stream' mesh, got axes {mesh.axis_names}"
                    )
                if stream_size % n_procs:
                    raise ValueError(
                        f"stream axis ({stream_size}) must be divisible "
                        f"by the process count ({n_procs})"
                    )
                # Local rows stitch back in order only when each
                # process's cells form ONE contiguous run along the
                # stream axis.
                procs_seen: list[int] = []
                for p in mesh.process_indices.flat:
                    if not procs_seen or procs_seen[-1] != p:
                        if p in procs_seen:
                            raise ValueError(
                                "multi-host mesh: stream-axis device "
                                "order must be process-contiguous"
                            )
                        procs_seen.append(p)
                local_devs = stream_size // n_procs
                if n_streams % local_devs:
                    raise ValueError(
                        f"n_streams {n_streams} (local) must be divisible "
                        f"by this process's stream-axis devices "
                        f"({local_devs})"
                    )
            elif n_streams % stream_size != 0:
                raise ValueError(
                    f"n_streams {n_streams} must be divisible by the "
                    f"mesh's stream axis ({stream_size})"
                )
            from audio_pattern_detector_tpu_torch.parallel.mesh import RowSharding

            self._sharding = RowSharding(mesh, "stream")

    def feed(
        self, chunks: Sequence[NDArray[np.float32] | None]
    ) -> list[dict[str, list[float]]]:
        """Process one chunk round; returns per-stream detection times.

        ``chunks[i] is None`` means stream ``i`` has no data this round
        (ended or stalled); its result is ``{}`` and its state is
        untouched. Timestamps are stream-local (seconds from that
        stream's start), computed with the reference algebra.

        Synchronous convenience: use :meth:`dispatch` / :meth:`collect`
        to keep several rounds in flight (the per-round launch, transfer
        and unpack otherwise serialize against device compute).
        """
        return self.collect(self.dispatch(chunks))

    def dispatch(
        self, chunks: Sequence[NDArray[np.float32] | None]
    ) -> Any:
        """Enqueue one chunk round (async); pair with :meth:`collect`.

        Stream state (lookback tails, indices, times) advances at
        dispatch time — the next round's lookback is host-known — so any
        number of rounds can be in flight before the first collect.

        While recording (``utils/profiling.py``) the call is the span
        ``session.dispatch``, the root of a new round id that the handle
        carries to ``session.collect`` (attributes: chunks, and the
        session's count of rounds dispatched before it).
        """
        rid = span = -1
        if RECORDER.on:
            rid = RECORDER.next_round()
            span = RECORDER.open("session.dispatch", round=rid, a=len(chunks), b=self._rounds)
        self._lockstep(chunks)
        if len(chunks) != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} chunks, got {len(chunks)}"
            )
        batch: list[NDArray[np.float32]] = []
        tails: list[NDArray[np.float32] | None] = []
        rounds: list[NDArray[np.float32] | None] = []
        for i, chunk in enumerate(chunks):
            if chunk is not None:
                # int16 chunks ride through raw: the bank's batch
                # dispatch bit-packs them into upload lanes without ever
                # materialising f32 on the host (bit-identical results —
                # the device unpack IS the int16 -> f32 decode).
                if np.asarray(chunk).dtype == np.int16:
                    chunk = np.ascontiguousarray(chunk)
                else:
                    chunk = np.ascontiguousarray(chunk, dtype=np.float32)
                if chunk.ndim != 1 or len(chunk) > self._chunk_samples:
                    raise ValueError(
                        f"stream {i}: chunk must be 1-D with at most "
                        f"{self._chunk_samples} samples, got shape {chunk.shape}"
                    )
                # A zero-length chunk is an idle round, same as None — it
                # must not advance the chunk index or replace the lookback
                # tail with an empty array (that would shift every later
                # timestamp for the stream).
                if len(chunk) == 0:
                    chunk = None
            rounds.append(chunk)
            if chunk is None:
                batch.append(self._empty)
                tails.append(None)
            else:
                batch.append(chunk)
                tails.append(self._tails[i])

        if self._tile is None:
            dispatched = [
                self._bank.dispatch_chunks_batch(
                    batch, None, mode=self._batch_mode, prev_tails=tails,
                    sharding=self._sharding,
                )
            ]
            active = None
        else:
            # Compacted tiled round: gather the ACTIVE rows (slot order
            # preserved) and dispatch them as a greedy width-ladder
            # decomposition — largest tile width that fits the remaining
            # rows each step. The ladder contains every power of two up
            # to the tile, so the decomposition is exact: no idle-row
            # padding, device time and h2d bytes scale with the round's
            # real occupancy. collect() scatters rows back to slots via
            # the recorded gather order.
            active = [
                i for i in range(self.n_streams) if rounds[i] is not None
            ]
            assert self._tile_widths is not None
            dispatched = []
            k = 0
            while k < len(active):
                rem = len(active) - k
                w = next(
                    width for width in self._tile_widths if width <= rem
                )
                slots = active[k : k + w]
                k += w
                dispatched.append(
                    self._bank.dispatch_chunks_batch(
                        [batch[i] for i in slots],
                        None,
                        mode=self._batch_mode,
                        prev_tails=[tails[i] for i in slots],
                    )
                )
        # (stream_active, index, had_prev) snapshot for collect-time
        # timestamp conversion; then advance state for the next round.
        meta = []
        for i, chunk in enumerate(rounds):
            if chunk is None:
                meta.append(None)
                continue
            meta.append((self._indices[i], self._tails[i] is not None))
            self._tails[i] = batch[i][int(-self._max_sw * self._sr):].copy()
            self._indices[i] += 1
            self._times[i] += len(batch[i]) / self._sr
        if span >= 0:
            RECORDER.close(span)
        return (dispatched, meta, active, rid)

    def _lockstep(self, chunks: Sequence[Any]) -> None:
        """On a mesh that spans processes, agree on the round (its index
        and width) with the other processes before it is dispatched
        (``parallel.mesh.lockstep``): the port's counterpart of the JAX
        session's global program. Nothing to agree on otherwise."""
        if self._sharding is not None and self._sharding.mesh.process_count > 1:
            from audio_pattern_detector_tpu_torch.parallel.mesh import lockstep

            lockstep("a round", round=self._rounds, rows=len(chunks))
        self._rounds += 1

    def collect(self, handle: Any) -> list[dict[str, list[float]]]:
        """Block on a dispatched round; per-stream detection times. A
        stream's positions become times as soon as its row's results are
        final: where a dispatch's last class comes back row by row (the
        scan schedule on a card), while collect decodes the rows that have
        finished and the card runs the rest (``on_final`` of
        ``models/bank.py::RowPayloads``); else once the dispatch is
        collected. While recording, the call is the span
        ``session.collect``, a root with the dispatch's round id
        (attribute: streams), and each batch of rows converted a span
        ``collect.times`` (attributes: rows, window)."""
        dispatched, meta, active, rid = handle
        span = RECORDER.open("session.collect", round=rid, a=self.n_streams) if RECORDER.on else -1
        # Compacted tiled rounds scatter their rows back to their slots;
        # an idle slot's result is {} (on a tiled session it never
        # dispatched a row).
        slots = range(self.n_streams) if active is None else active
        out: list[dict[str, list[float]] | None] = [{} if m is None else None for m in meta]
        offset = 0
        for d in dispatched:
            if not d:
                continue
            times = functools.partial(self._to_times, out, meta, slots, offset, d[-1][0])
            if isinstance(d[-1][1], RowPayloads):
                d[-1][1].on_final = times
            rows = self._bank.collect_chunks_batch(d)
            times(range(len(rows)), rows)
            offset += len(rows)
        if span >= 0:
            RECORDER.close(span)
        return out  # type: ignore[return-value]

    def _to_times(
        self,
        out: list[dict[str, list[float]] | None],
        meta: list[tuple[int, bool] | None],
        slots: Sequence[int],
        offset: int,
        sw: int,
        rows: Sequence[int],
        results: list[dict[str, list[int]]],
    ) -> None:
        """The stream times of a dispatch's ``rows`` (from ``offset`` in the
        round's rows) that are still to convert, into ``out`` by slot."""
        todo = [(slots[offset + bi], bi) for bi in rows
                if offset + bi < len(slots) and out[slots[offset + bi]] is None]
        if not todo:
            return
        span = RECORDER.open("collect.times", a=len(todo), b=sw) if RECORDER.on else -1
        for slot, bi in todo:
            index, had_prev = meta[slot]  # type: ignore[misc]
            out[slot] = self.detector.peaks_to_times(results[bi], index, had_prev)
        if span >= 0:
            RECORDER.close(span)

    def round_ready(self, handle: Any) -> bool:
        """Non-blocking: a dispatched round's payloads all completed."""
        return all(_dispatched_ready(d) for d in handle[0])

    def checkpoint(self, stream: int) -> StreamCheckpoint:
        """O(1) resume state for one stream. An int16 tail (the raw
        serving path) decodes to the f32 samples ``StreamCheckpoint``
        holds, bitwise as the device decodes it."""
        tail = self._tails[stream]
        return StreamCheckpoint(
            self._indices[stream],
            None if tail is None else _f32_copy(tail),
            self._times[stream],
        )

    def total_time(self, stream: int) -> float:
        """Seconds of audio processed so far for one stream."""
        return self._times[stream]

    def reset(self, stream: int) -> None:
        """Reclaim one slot for a fresh stream.

        The serving layer (serve.py) reuses session slots across client
        connections; resetting restores the slot to its initial state
        (no lookback tail, chunk index 0) without touching any other
        stream or recompiling the batch program.
        """
        self._tails[stream] = None
        self._indices[stream] = 0
        self._times[stream] = 0.0
