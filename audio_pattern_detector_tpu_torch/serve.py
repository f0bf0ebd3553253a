"""TCP JSONL serving on one torch device: N live audio streams, one session.

Port of audio_pattern_detector_tpu/serve.py. Up to ``max_streams``
concurrent TCP clients each send a WAV stream in exactly the
``match --stdin`` wire format (mono 16/32-bit PCM or 32-bit float,
pre-resampled to the target rate) and receive the JSONL events the CLI
prints on the same bytes (``start`` / ``pattern_detected`` / ``end``) on
their own socket. Every serving round batches one chunk from each ready
stream through :class:`MultiStreamSession` on the port's bank, with up to
``pipeline_depth`` rounds in flight.

Per-stream results equal piping the same bytes through ``match --stdin``:
header validation, sample decode, chunk/lookback algebra and event fields
are the same code paths (match.py), multiplexed. Stream slots are recycled
across connections (:meth:`MultiStreamSession.reset`). The event loop,
wire protocol, error strings, inbound backpressure, dispatch hold-back,
idle and end-drain timeouts and the stats line are the JAX server's. The
detector runs on an explicit torch device. ``mesh=`` (``serve
--mesh-stream N``) spreads each round's rows over the "stream" axis of a
device mesh (``parallel/mesh.py``), one event loop driving every device.

Single-threaded by design: one Python thread drives the device and a
``selectors`` loop drives the sockets; socket reads never block the
device and device rounds overlap socket ingest through dispatch/collect
pipelining.
"""

from __future__ import annotations

import contextlib
import json
import selectors
import socket
import sys
import time
from typing import Any

import numpy as np
import torch
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.match import (
    _SAMPLE_CODECS,
    _collect_pattern_files,
    _decode_samples,
    _emit_jsonl_end,
    _load_pattern_clips,
    _make_jsonl_callback,
    _validate_wav_header,
)
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
from audio_pattern_detector_tpu_torch.utils.profiling import RECORDER

# Pre-data WAV metadata (fmt + LIST/INFO/cover art) rarely exceeds a few
# hundred KB; a stream that hasn't reached its data chunk after this many
# bytes is treated as not-a-WAV. `match --stdin` itself has no such bound
# (it skips metadata chunks of any size) — this is a deliberate server-side
# guard so a garbage stream can't buffer unbounded header bytes per slot.
_MAX_HEADER_BYTES = 1024 * 1024

# Outbound JSONL a healthy client drains in microseconds; megabytes of
# backlog mean the client stopped reading, and an unbounded buffer would
# let one stalled consumer grow the server's memory without limit.
_DEFAULT_MAX_OUTBOUND = 8 * 1024 * 1024

# Inbound backpressure: stop recv()-ing once a connection has this many
# chunks' worth of undecoded samples buffered. The TCP window then fills
# and the sender blocks — the socket itself is the backpressure channel,
# like the reference's stdin pipe. Without a cap, a client that uploads a
# whole file at line rate would buffer it all in server memory.
_INBOUND_CAP_CHUNKS = 4

# After the ``end`` event, a client gets this long to drain any remaining
# buffered events before the slot is reclaimed. Without a bound, a client
# that half-closes and never reads again (its events stuck behind a full
# TCP send buffer) would hold its stream slot forever — the idle-timeout
# reaper deliberately exempts half-closed connections, and the
# slow-consumer byte cap only fires on NEW emits, of which there are none
# after ``end``.
_END_DRAIN_TIMEOUT = 60.0

# A connection without a dispatchable chunk holds dispatch back (see
# _dispatch_round) only while bytes arrived within this horizon. Active
# uploads (loopback, LAN, live pipes) deliver continuously at ms
# granularity, so a genuinely-progressing straggler always qualifies; a
# silent one (port scan, stalled client) stops taxing rounds after one
# horizon. Kept above typical WAN jitter; a transient gap only means one
# partial round (latency-correct, slightly lower occupancy), never
# wrong results.
_STRAGGLER_RX_HORIZON = 0.25


class _NeedMoreData(Exception):
    """Header parse paused: the buffer doesn't hold the full header yet."""


class _ExactReader:
    """Replay a byte buffer to the WAV header walker, pausing on shortfall.

    ``_validate_wav_header`` consumes a ``.read(n)``-style stream and
    treats short reads as fatal truncation. Over a socket, a short read
    just means the rest hasn't arrived: this reader raises
    :class:`_NeedMoreData` instead, so the caller can retry the parse
    when more bytes land (real format errors still raise ValueError
    with the reference error strings).
    """

    def __init__(self, data: bytearray) -> None:
        self._data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self._data):
            raise _NeedMoreData
        out = bytes(self._data[self.pos : self.pos + n])
        self.pos += n
        return out


class _Conn:
    """One client stream: socket state + WAV decode state + slot binding."""

    def __init__(self, sock: socket.socket, addr: Any, slot: int) -> None:
        self.sock = sock
        self.addr = addr
        self.slot = slot
        self.buf = bytearray()  # raw inbound bytes (header, then samples)
        self.outbound = bytearray()  # JSONL bytes awaiting send
        self.header_done = False
        self.dtype: np.dtype | None = None
        self.scale = 1.0
        self.eof = False  # client half-closed (finished sending)
        self.registered = True  # currently in the selector
        # Idle-timeout / drain-timeout clock: last time bytes moved in
        # EITHER direction (recv progress or send progress).
        self.last_activity = time.monotonic()
        # Inbound-only clock for the dispatch hold-back: a conn counts
        # as a round straggler only while bytes are actively ARRIVING
        # (connect counts — a fresh conn gets one horizon to deliver
        # its header + first chunk). Outbound sends must not refresh
        # this, or a stalled client still draining events would tax
        # every round.
        self.last_rx = time.monotonic()
        self.pending = 0  # dispatched rounds not yet collected
        self.samples_fed = 0
        self.ended = False  # end event emitted; close when outbound drains
        self.dead = False  # dropped (error/disconnect); discard collects
        self.callback: Any = None  # dedup'd pattern_detected emitter

    @property
    def itemsize(self) -> int:
        return 4 if self.dtype is None else self.dtype.itemsize


class PatternServer:
    """Serve a pattern bank on a torch device to concurrent TCP audio streams.

    Protocol per connection (all server->client traffic is JSONL):
      1. client connects; server sends ``{"type": "start", ...}`` (or
         ``{"type": "error", "error": "server full..."}`` and closes
         when all ``max_streams`` slots are busy);
      2. client streams a WAV (``match --stdin`` format) and half-closes
         its write side (``shutdown(SHUT_WR)``) at end of audio;
      3. server streams ``pattern_detected`` events as chunks process,
         then ``{"type": "end", ...}`` and closes.

    Detection semantics/config mirror ``match --stdin``: fixed
    ``seconds_per_chunk`` cadence (live stream — no auto-perf chunk
    sizing), same timestamp formats, same error strings.

    ``device`` (``cuda``, the default, raises without a card; or ``cpu``)
    is where a detector built from ``pattern_clips`` runs; a prebuilt
    ``detector`` must be a ``TorchAudioPatternDetector`` and carries its
    own device. ``mesh`` (a mesh with a "stream" axis) partitions each
    serving round's rows across its devices; the round is then the static
    full width, not tiled.
    """

    def __init__(
        self,
        pattern_clips: list[AudioClip] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_streams: int = 8,
        seconds_per_chunk: int | None = None,
        target_sample_rate: int | None = None,
        timestamp_format: str = "both",
        height_min: float | None = None,
        pipeline_depth: int = 2,
        detector: TorchAudioPatternDetector | None = None,
        idle_timeout: float | None = None,
        max_outbound: int = _DEFAULT_MAX_OUTBOUND,
        mesh: Any = None,
        stats_interval: float | None = None,
        dispatch_defer_ms: float = 50.0,
        tile: int | None = None,
        device: "torch.device | str" = "cuda",
        capture: bool | None = None,
    ) -> None:
        if max_streams < 1:
            raise ValueError(f"max_streams must be >= 1, got {max_streams}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}"
            )
        if (pattern_clips is None) == (detector is None):
            raise ValueError(
                "pass exactly one of pattern_clips or a prebuilt detector"
            )
        if detector is not None:
            # A prebuilt detector carries its own config (and possibly an
            # already-compiled bank, shared with other sessions).
            if seconds_per_chunk is not None or target_sample_rate is not None or height_min is not None:
                raise ValueError(
                    "detector carries its own config; don't also pass "
                    "seconds_per_chunk/target_sample_rate/height_min"
                )
            if not isinstance(detector, TorchAudioPatternDetector):
                raise TypeError(
                    f"the torch port's server needs a TorchAudioPatternDetector, "
                    f"got {type(detector).__name__}"
                )
            self.detector = detector
        else:
            kwargs: dict[str, Any] = {}
            if seconds_per_chunk is not None:
                kwargs["seconds_per_chunk"] = seconds_per_chunk
            if target_sample_rate is not None:
                kwargs["target_sample_rate"] = target_sample_rate
            if height_min is not None:
                kwargs["height_min"] = height_min
            self.detector = TorchAudioPatternDetector(
                audio_clips=pattern_clips, device=device, capture=capture, **kwargs
            )
        self.sr = self.detector.target_sample_rate
        self.chunk_samples = int(self.detector.seconds_per_chunk * self.sr)
        if idle_timeout is not None and idle_timeout <= 0:
            raise ValueError(
                f"idle_timeout must be positive or None, got {idle_timeout}"
            )
        self.max_streams = max_streams
        self.timestamp_format = timestamp_format
        self.pipeline_depth = pipeline_depth
        self.idle_timeout = idle_timeout
        self.max_outbound = max_outbound
        # With a mesh (a "stream" axis), each serving round's batch rows
        # are partitioned across devices: N devices serve N× the streams
        # at identical per-stream semantics (models/multistream.py).
        #
        # ``tile``: a round's rows dispatch as a compacted width-ladder
        # decomposition of tiles (models/multistream.py) rather than one
        # fixed full-width batch, so device memory is bounded by the tile
        # and device time and upload bytes follow the round's occupancy.
        # Default: 16-row tiles (the slot count caps the tile below 16);
        # meshes need the static full-width row→device layout instead.
        if tile is None and mesh is None:
            tile = min(16, max_streams)
        self.session = MultiStreamSession(
            self.detector, max_streams, mesh=mesh, tile=tile
        )

        self._sel = selectors.DefaultSelector()
        self._listener = socket.create_server((host, port))
        self._listener.setblocking(False)
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._stopping = False
        self._free_slots = list(range(max_streams))
        self._conns: dict[socket.socket, _Conn] = {}
        # FIFO of in-flight rounds: (session handle, per-slot conn map)
        self._inflight: list[tuple[Any, dict[int, _Conn]]] = []
        # Dispatch hold-back (see _dispatch_round): a round that would
        # leave mid-chunk streams out waits up to this long for them to
        # fill, so device rounds run at full slot occupancy. 0 disables.
        if dispatch_defer_ms < 0:
            raise ValueError(
                f"dispatch_defer_ms must be >= 0, got {dispatch_defer_ms}"
            )
        self.dispatch_defer = dispatch_defer_ms / 1e3
        self._defer_start: float | None = None
        # Periodic ops stats (one JSON line to stderr per interval):
        # aggregate audio throughput, rounds, detections over the window.
        if stats_interval is not None and stats_interval <= 0:
            raise ValueError(
                f"stats_interval must be positive or None, got {stats_interval}"
            )
        self.stats_interval = stats_interval
        self._stat_window_start = time.monotonic()
        self._stat_rounds = 0
        self._stat_samples = 0
        self._stat_detections = 0
        # Cumulative dispatched round count / active-row count — read by
        # probes to attribute round occupancy (rows/round vs slots).
        # Deliberately separate from _stat_rounds, which RESETS every
        # stats window when --stats-interval is set.
        self.rounds_dispatched = 0
        self.rows_dispatched = 0

    @property
    def address(self) -> tuple[str, int]:
        """Bound (host, port) — resolves port 0 to the real port."""
        return self._listener.getsockname()[:2]

    def warmup(self) -> None:
        """Two rounds per width the session dispatches (the tile's width
        ladder; just the slot width on a mesh) before the first client, one
        of int16 rows (a 16-bit PCM client's) and one of f32 rows (an IEEE
        float client's), so no client's round pays a first use: on the
        card, the kernel library's build and load, the cuFFT plans and the
        capture of each width's class step in each upload dtype."""
        rng = np.random.default_rng(0)
        for w in self.session._tile_widths or [self.max_streams]:
            for dtype in (np.int16, np.float32):
                chunks: list[Any] = [None] * self.max_streams
                for r in range(w):
                    chunk = 0.01 * rng.standard_normal(self.chunk_samples)
                    chunks[r] = (np.round(chunk * 32768).astype(np.int16) if dtype == np.int16
                                 else chunk.astype(np.float32))
                self.session.feed(chunks)
                for r in range(w):
                    self.session.reset(r)

    def shutdown(self) -> None:
        """Stop ``serve_forever`` from any thread (idempotent)."""
        self._stopping = True
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # ------------------------------------------------------------------
    # event loop

    def serve_forever(self) -> None:
        """The event loop, with the detector's CUDA device made current in
        the calling thread (a server may run in any thread)."""
        dev = self.detector.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            self._serve_loop()

    def _serve_loop(self) -> None:
        host, port = self.address
        print(
            f"Serving {len(self.detector.audio_clips)} pattern(s) on "
            f"{host}:{port} ({self.max_streams} stream slots, "
            f"{self.detector.seconds_per_chunk}s chunks)",
            file=sys.stderr,
        )
        # Each phase of the loop is a span while recording
        # (utils/profiling.py), a root: the session's spans nest in it.
        phases = (
            ("serve.select", lambda: self._sel.select(self._poll_timeout())),
            ("serve.sockets", self._service_sockets),
            ("serve.collect", self._collect_ready),
            ("serve.dispatch", self._dispatch_round),
            ("serve.finish", self._finish_streams),
        )
        try:
            while not self._stopping:
                for name, phase in phases:
                    span = RECORDER.open(name, root=True) if RECORDER.on else -1
                    phase()
                    if span >= 0:
                        RECORDER.close(span)
                self._maybe_emit_stats()
        finally:
            self._teardown()

    def _poll_timeout(self) -> float:
        if self._defer_start is not None:
            # Mid hold-back: wake promptly for straggler bytes without
            # spinning the loop hot for the whole defer window.
            return 0.002
        if any(self._round_bytes(c) for c in self._conns.values()):
            # A round can dispatch right now — or, at pipeline depth,
            # _collect_ready will block on the oldest round (waiting on
            # the device, not spinning) and then dispatch.
            return 0.0
        if self._inflight:
            return 0.01  # device busy; poll for completion
        return 0.2

    def _service_sockets(self) -> None:
        # select() again with timeout 0: the timed select in the loop
        # already fired; this pass drains every currently-ready socket.
        for key, mask in self._sel.select(0):
            if key.data == "accept":
                self._accept()
            elif key.data == "wake":
                try:
                    self._wake_r.recv(4096)
                except OSError:
                    pass
            else:
                conn = key.data
                if mask & selectors.EVENT_WRITE:
                    self._flush(conn)
                if mask & selectors.EVENT_READ:
                    self._ingest(conn)

    def _accept(self) -> None:
        try:
            sock, addr = self._listener.accept()
        except OSError:
            return
        sock.setblocking(False)
        if not self._free_slots:
            # Reject at the protocol layer so clients get a parseable
            # reason rather than a bare close.
            msg = (
                json.dumps(
                    {
                        "type": "error",
                        "error": (
                            f"server full: {self.max_streams} streams "
                            "already connected"
                        ),
                    }
                )
                + "\n"
            )
            try:
                sock.sendall(msg.encode())
            except OSError:
                pass
            sock.close()
            print(f"Rejected {addr}: server full", file=sys.stderr)
            return
        slot = self._free_slots.pop()
        conn = _Conn(sock, addr, slot)
        conn.callback = _make_jsonl_callback(
            self.timestamp_format,
            emit=lambda et, **kw: self._emit(conn, et, **kw),
        )
        self._conns[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)
        self._emit(conn, "start", source=f"tcp:{addr[0]}:{addr[1]}")
        print(f"Stream {slot}: connected from {addr}", file=sys.stderr)

    def _inbound_cap(self, conn: _Conn) -> int:
        # A deep pipeline drains faster than the 4-chunk default refills
        # over a paused socket; keep one chunk of headroom past depth.
        chunks = max(_INBOUND_CAP_CHUNKS, self.pipeline_depth + 1)
        return chunks * self.chunk_samples * conn.itemsize

    def _rx_paused(self, conn: _Conn) -> bool:
        return conn.header_done and len(conn.buf) >= self._inbound_cap(conn)

    def _update_mask(self, conn: _Conn) -> None:
        """Sync selector interest to what the conn can actually consume.

        Reads pause while the undecoded backlog sits at the inbound cap
        (and permanently after EOF); writes register only while JSONL is
        queued. A conn needing neither leaves the selector entirely —
        a paused-readable socket would otherwise wake every ``select``
        and spin the loop hot.
        """
        if conn.dead:
            return
        mask = 0
        if not conn.eof and not self._rx_paused(conn):
            mask |= selectors.EVENT_READ
        if conn.outbound:
            mask |= selectors.EVENT_WRITE
        if mask and conn.registered:
            self._sel.modify(conn.sock, mask, conn)
        elif mask:
            self._sel.register(conn.sock, mask, conn)
            conn.registered = True
        elif conn.registered:
            self._sel.unregister(conn.sock)
            conn.registered = False

    def _ingest(self, conn: _Conn) -> None:
        while not conn.dead:
            if self._rx_paused(conn):
                # Leave the rest in the kernel socket buffer: the TCP
                # window closes and the sender blocks until rounds drain
                # conn.buf below the cap (reads re-register then — the
                # socket itself is the backpressure channel, like the
                # reference's stdin pipe).
                self._update_mask(conn)
                return
            try:
                data = conn.sock.recv(1 << 16)
            except BlockingIOError:
                return
            except OSError:
                self._drop(conn, "connection reset")
                return
            if not data:
                conn.eof = True
                if not conn.header_done:
                    self._fail(conn, "Unexpected EOF in WAV header")
                else:
                    # An EOF'd socket stays readable forever; drop read
                    # interest so it stops waking the select loop.
                    self._update_mask(conn)
                return
            conn.last_activity = time.monotonic()
            conn.last_rx = conn.last_activity
            conn.buf += data
            if not conn.header_done:
                self._try_parse_header(conn)
                if conn.dead:
                    return

    def _try_parse_header(self, conn: _Conn) -> None:
        reader = _ExactReader(conn.buf)
        try:
            audio_format, bits = _validate_wav_header(reader, self.sr)
        except _NeedMoreData:
            if len(conn.buf) > _MAX_HEADER_BYTES:
                self._fail(conn, "WAV header too large (not a WAV stream?)")
            return
        except ValueError as e:
            self._fail(conn, str(e))
            return
        del conn.buf[: reader.pos]
        conn.dtype, conn.scale = _SAMPLE_CODECS[(audio_format, bits)]
        conn.header_done = True
        fmt_name = "float32" if audio_format == 3 else f"int{bits}"
        print(
            f"Stream {conn.slot}: WAV {self.sr}Hz, mono, {fmt_name}",
            file=sys.stderr,
        )

    # ------------------------------------------------------------------
    # device rounds

    def _round_bytes(self, conn: _Conn) -> int:
        """Decodable payload bytes if this conn can join a round now."""
        if conn.dead or conn.ended or not conn.header_done:
            return 0
        need = self.chunk_samples * conn.itemsize
        if len(conn.buf) >= need:
            return need
        if conn.eof:
            return len(conn.buf) - len(conn.buf) % conn.itemsize
        return 0

    def _take_chunk(self, conn: _Conn) -> NDArray[np.float32] | None:
        n_bytes = self._round_bytes(conn)
        if n_bytes <= 0:
            return None
        raw = bytes(conn.buf[:n_bytes])
        was_paused = self._rx_paused(conn)
        del conn.buf[:n_bytes]
        if was_paused and not self._rx_paused(conn):
            self._update_mask(conn)  # backlog drained: resume reads
            # The client may have been blocked on the TCP window the
            # whole paused stretch; restart its idle clock so it isn't
            # reaped before it gets a chance to send again (and its rx
            # clock, so the hold-back gives it the same grace).
            conn.last_activity = time.monotonic()
            conn.last_rx = conn.last_activity
        assert conn.dtype is not None
        if conn.dtype == np.int16:
            # int16 fast path: hand the raw samples through — the batch
            # dispatch bit-packs int16 pairs into f32 upload lanes with a
            # zero-cost view (ops/packing.py semantics), so the f32
            # decode here would be pure waste (~30 ms/width-8 round of
            # host work, scripts/dev/serve_probe.py). Device results are
            # bit-identical either way (the in-graph unpack IS the
            # decode: int16 -> f32 exact).
            samples: NDArray[np.float32] = np.frombuffer(
                raw, dtype=np.int16
            )  # type: ignore[assignment]
        else:
            samples = _decode_samples(raw, conn.dtype, conn.scale)
        conn.samples_fed += len(samples)
        return samples

    def _dispatch_round(self) -> None:
        if self._inflight and len(self._inflight) >= self.pipeline_depth:
            return
        ready = sum(1 for c in self._conns.values() if self._round_bytes(c))
        if not ready:
            self._defer_start = None
            return
        if self.dispatch_defer > 0:
            # Hold the round back (bounded) while other live streams are
            # mid-chunk: a width-B device round costs the same at any
            # slot occupancy, so dispatching a 2-of-8 round wastes ~4x
            # device time vs waiting a few ms for the stragglers.
            # Measured (scripts/dev/serve_probe.py, width 8, 4 chunks
            # per stream): 11 rounds -> 4-5 full rounds. Live streams at
            # chunk cadence lose at most dispatch_defer_ms of latency.
            # Only streams actively DELIVERING bytes count as
            # stragglers (last_rx within _STRAGGLER_RX_HORIZON): holding
            # a round only pays off when the straggler will finish its
            # chunk within the window, which requires inbound progress.
            # This excludes connections that never finish their WAV
            # header (port scans, health checks) and header-complete
            # clients that stalled mid-chunk — either would otherwise
            # tax every round the full defer window indefinitely (the
            # idle reaper is off by default). A header-incomplete but
            # actively-uploading fresh connection DOES hold the round:
            # at fleet start all N clients are mid-header/mid-chunk for
            # a few ms, and dispatching 1-of-N rounds then wastes ~N x
            # device time (measured: aggregate 1747x -> 316x when a
            # header_done guard stopped counting them).
            now = time.monotonic()
            waiting = any(
                not c.dead and not c.ended and not c.eof
                and not self._round_bytes(c)
                and now - c.last_rx <= _STRAGGLER_RX_HORIZON
                for c in self._conns.values()
            )
            if waiting:
                if self._defer_start is None:
                    self._defer_start = now
                if now - self._defer_start < self.dispatch_defer:
                    return
        self._defer_start = None
        chunks: list[NDArray[np.float32] | None] = [None] * self.max_streams
        members: dict[int, _Conn] = {}
        span = RECORDER.open("serve.take") if RECORDER.on else -1
        for conn in self._conns.values():
            chunk = self._take_chunk(conn)
            if chunk is not None and len(chunk):
                chunks[conn.slot] = chunk
                members[conn.slot] = conn
        if span >= 0:
            RECORDER.close(span)
        if not members:
            return
        handle = self.session.dispatch(chunks)
        for conn in members.values():
            conn.pending += 1
        self._inflight.append((handle, members))
        self._stat_rounds += 1
        self.rounds_dispatched += 1
        self.rows_dispatched += len(members)
        self._stat_samples += sum(
            len(c) for c in chunks if c is not None
        )

    def _input_exhausted(self) -> bool:
        """True when no connection can contribute another round (all
        dead/ended, or EOF with nothing dispatchable left in the buffer)
        — in-flight rounds are then the only work, so collecting may
        block on the device instead of polling at select granularity.
        A new connection's accept waits at most one round."""
        return all(
            c.dead or c.ended or (c.eof and not self._round_bytes(c))
            for c in self._conns.values()
        )

    def _collect_ready(self, block: bool = False) -> None:
        # When input is exhausted, block on the OLDEST round only, then
        # return to the select loop between rounds — otherwise a new
        # client's accept would stall behind ALL in-flight rounds.
        exhausted = self._input_exhausted()
        while self._inflight:
            handle, members = self._inflight[0]
            must = (
                block
                or len(self._inflight) >= self.pipeline_depth
                or exhausted
            )
            exhausted = False
            if not must and not self.session.round_ready(handle):
                return
            self._inflight.pop(0)
            results = self.session.collect(handle)
            for slot, conn in members.items():
                conn.pending -= 1
                if conn.dead:
                    continue
                for clip_name, times in results[slot].items():
                    self._stat_detections += len(times)
                    for t in times:
                        conn.callback(clip_name, t)

    def _finish_streams(self) -> None:
        now = time.monotonic()
        for conn in list(self._conns.values()):
            if conn.dead:
                continue
            if (
                self.idle_timeout is not None
                and not conn.eof
                # Backpressured ≠ idle: while reads are paused at the
                # inbound cap, last_activity legitimately stalls. A partial
                # header/chunk below the cap, though, IS idle — rounds
                # can't consume it, so only the timeout reclaims the slot.
                and not self._rx_paused(conn)
                and now - conn.last_activity > self.idle_timeout
            ):
                # A connection sending nothing holds a stream slot other
                # clients could use.
                self._fail(
                    conn,
                    f"idle timeout: no data received for "
                    f"{self.idle_timeout:g}s",
                )
                continue
            if (
                not conn.ended
                and conn.eof
                and conn.header_done
                and conn.pending == 0
                and self._round_bytes(conn) <= 0
            ):
                _emit_jsonl_end(
                    conn.samples_fed / self.sr,
                    self.timestamp_format,
                    emit=lambda et, **kw: self._emit(conn, et, **kw),
                )
                conn.ended = True
                print(
                    f"Stream {conn.slot}: ended after "
                    f"{conn.samples_fed / self.sr:.1f}s",
                    file=sys.stderr,
                )
            if conn.ended and not conn.outbound:
                self._release(conn)
            elif (
                conn.ended
                and now - conn.last_activity > _END_DRAIN_TIMEOUT
            ):
                # Half-closed client with its remaining events stuck
                # behind a full TCP send buffer and no send progress:
                # without this bound the slot would leak forever (the
                # idle reaper exempts eof'd connections, and the
                # slow-consumer cap only fires on new emits).
                print(
                    f"Stream {conn.slot}: dropped (events not drained "
                    f"{_END_DRAIN_TIMEOUT:g}s after end)",
                    file=sys.stderr,
                )
                conn.outbound.clear()
                self._drop(conn, "slow consumer")

    def _maybe_emit_stats(self) -> None:
        """One JSON ops line to stderr per ``stats_interval``: window
        throughput (audio seconds scanned / wall = aggregate realtime
        factor), rounds, detections, live streams, pipeline occupancy.

        stderr, not stdout: per-client sockets carry the JSONL event
        contract; operator diagnostics follow the CLI's stream separation
        (reference: match.py stderr discipline)."""
        if self.stats_interval is None:
            return
        now = time.monotonic()
        elapsed = now - self._stat_window_start
        if elapsed < self.stats_interval:
            return
        audio_s = self._stat_samples / self.sr
        print(
            json.dumps(
                {
                    "type": "stats",
                    "window_seconds": round(elapsed, 3),
                    "streams": len(self._conns),
                    "rounds": self._stat_rounds,
                    "audio_seconds": round(audio_s, 3),
                    "x_realtime": round(audio_s / elapsed, 1),
                    "detections": self._stat_detections,
                    "rounds_in_flight": len(self._inflight),
                }
            ),
            file=sys.stderr,
            flush=True,
        )
        self._stat_window_start = now
        self._stat_rounds = 0
        self._stat_samples = 0
        self._stat_detections = 0

    # ------------------------------------------------------------------
    # outbound / lifecycle

    def _emit(self, conn: _Conn, event_type: str, **kwargs: Any) -> None:
        if conn.dead:
            return
        event = {"type": event_type, **kwargs}
        conn.outbound += (
            json.dumps(event, ensure_ascii=False) + "\n"
        ).encode()
        self._flush(conn)
        if len(conn.outbound) > self.max_outbound and not conn.dead:
            # The client stopped reading; don't let its backlog grow the
            # server without bound (and don't bother flushing it on
            # close — the socket buffer is already full).
            print(
                f"Stream {conn.slot}: dropped (slow consumer: "
                f"{len(conn.outbound)} bytes of undelivered events)",
                file=sys.stderr,
            )
            conn.outbound.clear()
            self._drop(conn, "slow consumer")

    def _flush(self, conn: _Conn) -> None:
        if conn.dead:
            return
        while conn.outbound:
            try:
                sent = conn.sock.send(conn.outbound)
            except BlockingIOError:
                break
            except OSError:
                self._drop(conn, "connection reset")
                return
            del conn.outbound[:sent]
            if sent:
                conn.last_activity = time.monotonic()
        self._update_mask(conn)

    def _fail(self, conn: _Conn, message: str) -> None:
        """Protocol error: tell the client why, then drop the stream."""
        self._emit(conn, "error", error=message)
        print(f"Stream {conn.slot}: error: {message}", file=sys.stderr)
        self._drop(conn, message)

    def _drop(self, conn: _Conn, reason: str) -> None:
        if conn.dead:
            return
        if not conn.ended:
            print(
                f"Stream {conn.slot}: dropped ({reason})", file=sys.stderr
            )
        conn.dead = True
        self._release(conn)

    def _release(self, conn: _Conn) -> None:
        """Close the socket and recycle the stream slot."""
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.registered = False
        if conn.outbound:
            # Best-effort: land any queued events (e.g. the error line
            # that triggered the drop) before the close.
            try:
                conn.sock.settimeout(1.0)
                conn.sock.sendall(conn.outbound)
            except OSError:
                pass
            conn.outbound.clear()
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.pop(conn.sock, None)
        conn.dead = True
        # In-flight rounds hold dispatch-time metadata, so resetting the
        # slot now is safe: their collects don't read current state, and
        # a new connection reusing the slot starts from index 0.
        self.session.reset(conn.slot)
        if conn.slot not in self._free_slots:
            self._free_slots.append(conn.slot)

    def _teardown(self) -> None:
        self._collect_ready(block=True)
        self._finish_streams()
        for conn in list(self._conns.values()):
            self._release(conn)
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._sel.close()


def cmd_serve(args: Any) -> None:
    """The JAX ``cmd_serve`` on the port: the same usage errors and exit
    codes, and the server on ``args.device`` (with ``--mesh-stream N``,
    on a stream mesh of N of its devices)."""
    pattern_files = _collect_pattern_files(args)
    if not pattern_files:
        print("Please provide either --pattern-file or --pattern-folder", file=sys.stderr)
        sys.exit(1)
    clips = _load_pattern_clips(
        pattern_files, args.target_sample_rate or DEFAULT_TARGET_SAMPLE_RATE
    )
    mesh = None
    mesh_stream = getattr(args, "mesh_stream", None)
    try:
        if mesh_stream:
            from audio_pattern_detector_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh({"stream": mesh_stream}, device=args.device)
            print(f"Serving over a {mesh_stream}-device stream mesh", file=sys.stderr)
        server = PatternServer(
            clips,
            host=args.host,
            port=args.port,
            max_streams=args.max_streams,
            seconds_per_chunk=args.chunk_seconds,
            target_sample_rate=args.target_sample_rate,
            timestamp_format=args.timestamp_format,
            height_min=args.height_min,
            pipeline_depth=args.pipeline_depth,
            idle_timeout=args.idle_timeout or None,
            mesh=mesh,
            stats_interval=args.stats_interval or None,
            dispatch_defer_ms=args.dispatch_defer_ms,
            tile=args.tile,
            device=args.device,
        )
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    print("Warming up the device, one round per tile width...", file=sys.stderr)
    server.warmup()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
