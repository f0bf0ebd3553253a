"""TCP JSONL serving on one torch device: N live audio streams, one session.

Port of audio_pattern_detector_tpu/serve.py. Clients send a WAV stream in
the ``match --stdin`` wire format and receive the JSONL events
``match --stdin`` prints on the same bytes (``start`` / ``pattern_detected``
/ ``end``). The JAX server's event loop is host code and is reused by
subclass: the wire protocol, error strings, slot recycling, inbound
backpressure, the dispatch hold-back, idle and end-drain timeouts, the
stats line and ``phase_seconds``. The port supplies the device side: a
``TorchAudioPatternDetector`` on an explicit device, the port's
:class:`MultiStreamSession`, and a warm-up that runs one round per tile
width. Stream sharding over a mesh (``mesh=``, ``--mesh-stream N``) is not
ported and is refused.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any

import numpy as np
import torch

from audio_pattern_detector_tpu.match import _collect_pattern_files, _load_pattern_clips
from audio_pattern_detector_tpu.serve import (
    _DEFAULT_MAX_OUTBOUND,
    PatternServer as _JaxPatternServer,
)
from audio_pattern_detector_tpu.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu.utils.clip import AudioClip
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession


class PatternServer(_JaxPatternServer):
    """Serve a pattern bank on a torch device to concurrent TCP streams.

    The JAX ``PatternServer``'s protocol and options, plus ``device``
    (``cuda``, the default, raises without a card; or ``cpu``), used when
    the detector is built from ``pattern_clips``. A prebuilt
    ``detector`` must be a ``TorchAudioPatternDetector`` and carries its
    own device. ``mesh`` is refused.
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
    ) -> None:
        if mesh is not None:
            raise ValueError("mesh is not supported by the torch port yet")
        if (pattern_clips is None) == (detector is None):
            raise ValueError("pass exactly one of pattern_clips or a prebuilt detector")
        if pattern_clips is not None:
            config = {
                "seconds_per_chunk": seconds_per_chunk,
                "target_sample_rate": target_sample_rate,
                "height_min": height_min,
            }
            detector = TorchAudioPatternDetector(
                pattern_clips, device=device,
                **{k: v for k, v in config.items() if v is not None},
            )
            seconds_per_chunk = target_sample_rate = height_min = None
        elif not isinstance(detector, TorchAudioPatternDetector):
            raise TypeError(
                f"the torch port's server needs a TorchAudioPatternDetector, "
                f"got {type(detector).__name__}"
            )
        super().__init__(
            host=host, port=port, max_streams=max_streams,
            seconds_per_chunk=seconds_per_chunk, target_sample_rate=target_sample_rate,
            timestamp_format=timestamp_format, height_min=height_min,
            pipeline_depth=pipeline_depth, detector=detector, idle_timeout=idle_timeout,
            max_outbound=max_outbound, stats_interval=stats_interval,
            dispatch_defer_ms=dispatch_defer_ms, tile=tile,
        )
        # The JAX constructor builds the JAX session around the port's
        # detector (host code only, no dispatch) and owns the tile policy;
        # the port's session takes that session's tile and replaces it
        # before any round runs.
        self.session = MultiStreamSession(self.detector, self.max_streams, tile=self.session._tile)

    def warmup(self) -> None:
        """One round per width the session dispatches (the tile's width
        ladder) before the first client, so no client's round pays a
        first use: on the card, the kernel library's build and load and
        the cuFFT plans."""
        rng = np.random.default_rng(0)
        for w in self.session._tile_widths:
            chunks: list[Any] = [None] * self.max_streams
            for r in range(w):
                chunks[r] = (0.01 * rng.standard_normal(self.chunk_samples)).astype(np.float32)
            self.session.feed(chunks)
            for r in range(w):
                self.session.reset(r)

    def serve_forever(self) -> None:
        """The JAX event loop, with the detector's CUDA device made current
        in the calling thread (a server may run in any thread)."""
        dev = self.detector.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            super().serve_forever()


def cmd_serve(args: Any) -> None:
    """The JAX ``cmd_serve`` on the port: the same usage errors and exit
    codes, and the server on ``args.device``. The port's CLI refuses
    ``--mesh-stream N`` (N != 1) before it gets here."""
    pattern_files = _collect_pattern_files(args)
    if not pattern_files:
        print("Please provide either --pattern-file or --pattern-folder", file=sys.stderr)
        sys.exit(1)
    clips = _load_pattern_clips(
        pattern_files, args.target_sample_rate or DEFAULT_TARGET_SAMPLE_RATE
    )
    try:
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
