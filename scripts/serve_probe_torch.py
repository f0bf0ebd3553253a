"""What does the port's TCP serving stack cost on top of raw multi-stream rounds?

End-to-end measurement of the port's PatternServer
(``audio_pattern_detector_tpu_torch/serve.py``) on the flagship 64-clip
bank: N loopback TCP clients blast 16-bit WAV audio faster-than-realtime;
the probe reports the aggregate realtime factor from first byte sent to
last ``end`` event received — socket ingest + header walk + int16 decode +
batched device rounds + JSONL emission, the whole serving path. The warm
pass runs under ``utils/profiling.py``'s recorder, and the probe reports
its host seconds by span: the event loop's phases (``serve.*``), the
session's dispatch and collect and the bank's stages (``bank.*``). Compare
against the raw MultiStreamSession numbers: the difference is the serving
layer's overhead. (``scripts/dev/serve_probe.py`` is the same probe of the
JAX reference server.)

Run on a card: python scripts/serve_probe_torch.py
Env: APD_PROBE_WIDTHS=1,4,8  APD_PROBE_SECONDS=240  APD_PROBE_DEPTH=2
     APD_PROBE_DEVICE=cuda
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from collections import defaultdict

import numpy as np

from audio_pattern_detector_tpu_torch.flagship import make_detector
from audio_pattern_detector_tpu_torch.serve import PatternServer
from audio_pattern_detector_tpu_torch.utils import profiling

SR = 8000
CHUNK_SECONDS = 60
WIDTHS = [int(w) for w in os.environ.get("APD_PROBE_WIDTHS", "1,4,8").split(",")]
STREAM_SECONDS = int(os.environ.get("APD_PROBE_SECONDS", "240"))
DEPTH = int(os.environ.get("APD_PROBE_DEPTH", "2"))
DEVICE = os.environ.get("APD_PROBE_DEVICE", "cuda")


def wav_payload(audio: np.ndarray) -> bytes:
    data = (
        np.clip(np.round(audio * 32768.0), -32768, 32767)
        .astype("<i2")
        .tobytes()
    )
    fmt = struct.pack("<HHIIHH", 1, 1, SR, SR * 2, 2, 16)
    return (
        b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        + b"fmt " + struct.pack("<I", 16) + fmt
        + b"data" + struct.pack("<I", len(data)) + data
    )


def client(port: int, payload: bytes, out: list, i: int) -> None:
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    sock.sendall(payload)
    sock.shutdown(socket.SHUT_WR)
    sock.settimeout(600)
    buf = b""
    while True:
        d = sock.recv(1 << 16)
        if not d:
            break
        buf += d
    sock.close()
    events = [json.loads(line) for line in buf.decode().splitlines()]
    assert events[-1]["type"] == "end", events[-1]
    out[i] = events


def span_seconds(spans: list) -> dict:
    """Host seconds by span name."""
    out: dict = defaultdict(float)
    for s in spans:
        out[s.name] += (s.end_ns - s.start_ns) * 1e-9
    return {k: round(v, 3) for k, v in sorted(out.items())}


def measure(det, width: int) -> dict:
    # Prebuilt detector: every width shares the bank (only the width's
    # captured steps differ).
    server = PatternServer(
        detector=det,
        max_streams=width,
        timestamp_format="ms",
        pipeline_depth=DEPTH,
    )
    server.warmup()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.address[1]

    rng = np.random.default_rng(11)
    audio = np.asarray(
        np.round(0.05 * rng.standard_normal(STREAM_SECONDS * SR) * 32768)
        / 32768,
        dtype=np.float32,
    )
    payload = wav_payload(audio)

    def fleet() -> float:
        results: list = [None] * width
        threads = [
            threading.Thread(target=client, args=(port, payload, results, i))
            for i in range(width)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            assert not t.is_alive()
        wall = time.perf_counter() - t0
        for ev in results:
            assert ev is not None
            assert ev[-1]["total_time_ms"] == STREAM_SECONDS * 1000
        return wall

    # Two passes: the second reuses recycled slots with everything warm,
    # separating steady-state serving cost from first-window effects
    # (shared-chip variance shows up as cold/warm disagreement).
    cold = fleet()
    rounds0 = server.rounds_dispatched
    rows0 = server.rows_dispatched
    with profiling.recording():
        warm = fleet()
    spans = profiling.spans()
    rounds = server.rounds_dispatched - rounds0
    rows = server.rows_dispatched - rows0
    server.shutdown()
    thread.join(timeout=30)

    total_audio = width * STREAM_SECONDS
    return {
        "width": width,
        "wall_cold_s": round(cold, 2),
        "wall_warm_s": round(warm, 2),
        "aggregate_x_realtime": round(total_audio / warm, 1),
        "per_stream_x_realtime": round(STREAM_SECONDS / warm, 1),
        "warm_rounds": rounds,
        "warm_rows": rows,
        "warm_rows_per_round": round(rows / max(rounds, 1), 2),
        "warm_span_seconds": span_seconds(spans),
        "warm_spans_dropped": profiling.RECORDER.dropped,
    }


def main() -> None:
    det = make_detector(32, 32, CHUNK_SECONDS, DEVICE)
    rows = []
    for width in WIDTHS:
        row = measure(det, width)
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"probe": "serve", "depth": DEPTH, "rows": rows}))


if __name__ == "__main__":
    main()
