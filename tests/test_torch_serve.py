"""The port's TCP server, its ``serve`` CLI and the parallel multi-file scan
against the JAX package.

Each client's events after ``start`` are byte-identical to the JAX CLI's
``match --stdin`` output on the same WAV bytes and patterns. Those outputs
are pinned below (taken from the JAX CLI once, on the CPU) rather than
rerun per case. The server runs in a background thread on the CPU, and
once as ``serve`` in a subprocess that must never import jax.
"""

import io
import json
import os
import re
import select
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.match import _validate_wav_header
from audio_pattern_detector_tpu.match import (
    match_pattern_many_parallel as jax_match_pattern_many_parallel,
)
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import cli
from audio_pattern_detector_tpu_torch.match import (
    match_pattern_many,
    match_pattern_many_parallel,
)
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.serve import PatternServer
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

torch.set_num_threads(1)

SR = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")
RTHK = os.path.join(AUDIO, "rthk_section_with_beep.wav")
RTHK_TOML = os.path.join(AUDIO, "clips", "rthk_beep.apd.toml")
CBS = os.path.join(AUDIO, "cbs_news_audio_section.wav")
CBS_CLIP = os.path.join(AUDIO, "clips", "cbs_news.wav")
PATTERNS = [RTHK_TOML, CBS_CLIP]


def float_wav(path):
    """The int16 WAV's samples / 32768 as an IEEE-float (format 3) WAV."""
    with wave.open(path, "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    data = (pcm.astype(np.float32) / np.float32(32768)).tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, SR, SR * 4, 4, 32)
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
            + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)) + data)


def _events(hits, end_ms, end_fmt):
    lines = [{"type": "pattern_detected", "clip_name": n, "timestamp_ms": ms,
              "timestamp_formatted": f} for n, ms, f in hits]
    lines.append({"type": "end", "total_time_ms": end_ms, "total_time_formatted": end_fmt})
    return "".join(json.dumps(x, ensure_ascii=False) + "\n" for x in lines).encode()


RTHK_HITS = [("rthk_beep", 1408, "00:00:01.408"), ("rthk_beep", 2420, "00:00:02.420")]
# Stdout after the start line of `python -m audio_pattern_detector_tpu match
# --stdin --pattern-file <rthk toml> --pattern-file <cbs clip>` on each payload
# (the int16 RTHK WAV's stdin read includes the bytes after its data chunk).
PAYLOADS = {
    "rthk_int16": (lambda: open(RTHK, "rb").read(), _events(RTHK_HITS, 4089, "00:00:04.089")),
    "rthk_float32": (lambda: float_wav(RTHK), _events(RTHK_HITS, 4078, "00:00:04.078")),
    "cbs_int16": (lambda: open(CBS, "rb").read(),
                  _events([("cbs_news", 25899, "00:00:25.899")], 32122, "00:00:32.122")),
}


def _clips():
    return [AudioClip.from_audio_file(p, sample_rate=SR) for p in PATTERNS]


def run_client(port, payload):
    """Send a WAV, half-close, read every event line; raw bytes."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
    except OSError:
        pass  # the server already closed (refused or failed): read on
    sock.settimeout(120)
    buf = b""
    while True:
        try:
            data = sock.recv(1 << 16)
        except ConnectionResetError:
            break
        if not data:
            break
        buf += data
    sock.close()
    return buf


def after_start(raw):
    first, _, rest = raw.partition(b"\n")
    assert json.loads(first)["type"] == "start" and json.loads(first)["source"].startswith("tcp:")
    return rest


class _Running:
    """A server's ``serve_forever`` in a background thread."""

    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def server():
    srv = PatternServer(_clips(), port=0, max_streams=3, device="cpu")
    srv.warmup()
    running = _Running(srv)
    yield srv
    running.stop()


def test_three_concurrent_clients_get_the_jax_stdin_events(server):
    assert type(server.session) is MultiStreamSession
    assert server.session._tile_widths == [3, 2, 1]
    results = {}

    def client(name, payload):
        results[name] = run_client(server.address[1], payload)

    threads = [threading.Thread(target=client, args=(name, make()))
               for name, (make, _) in PAYLOADS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    for name, (_, want) in PAYLOADS.items():
        assert after_start(results[name]) == want, name
    assert server.rows_dispatched >= 3


def test_bad_header_gets_the_jax_error_string(server):
    bad = b"RIFX" + bytes(40)
    with pytest.raises(ValueError) as exc:
        _validate_wav_header(io.BytesIO(bad), SR)
    events = [json.loads(x) for x in run_client(server.address[1], bad).splitlines()]
    assert events[0]["type"] == "start"
    assert events[1:] == [{"type": "error", "error": str(exc.value)}]
    truncated = [json.loads(x) for x in run_client(server.address[1], b"RIFF").splitlines()]
    assert truncated[1:] == [{"type": "error", "error": "Unexpected EOF in WAV header"}]


def test_server_full_then_slot_recycled():
    srv = PatternServer(_clips(), port=0, max_streams=1, device="cpu")
    running = _Running(srv)
    try:
        port = srv.address[1]
        holder = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            assert b'"start"' in holder.recv(1 << 16)
            rejected = [json.loads(x) for x in run_client(port, b"").splitlines()]
            assert rejected == [
                {"type": "error", "error": "server full: 1 streams already connected"}
            ]
        finally:
            holder.close()
        make, want = PAYLOADS["rthk_int16"]
        deadline = time.monotonic() + 30
        while True:  # the server notices the closed holder on its next pass
            raw = run_client(port, make())
            if b'"start"' in raw.partition(b"\n")[0]:
                break
            assert time.monotonic() < deadline, raw
            time.sleep(0.2)
        assert after_start(raw) == want
    finally:
        running.stop()


def test_constructor_contract():
    clips = _clips()
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=2)
    srv = PatternServer(detector=det, max_streams=2)
    try:
        assert srv.detector is det and srv.chunk_samples == 2 * SR
        assert type(srv.session) is MultiStreamSession and srv.session._tile_widths == [2, 1]
    finally:
        srv._teardown()
    with pytest.raises(ValueError, match="exactly one"):
        PatternServer()
    from audio_pattern_detector_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="mesh must have a 'stream' axis"):
        PatternServer(clips, mesh=make_mesh({"time": 2}, devices=["cpu"] * 2), device="cpu")
    with pytest.raises(ValueError, match="tile and mesh are mutually exclusive"):
        PatternServer(clips, mesh=make_mesh({"stream": 2}, devices=["cpu"] * 2), tile=2,
                      max_streams=2, device="cpu")
    with pytest.raises(TypeError, match="TorchAudioPatternDetector"):
        PatternServer(detector=AudioPatternDetector(
            [jclip.AudioClip.from_audio_file(p, sample_rate=SR) for p in PATTERNS]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PatternServer(clips)


def _read_until(stream, needle, deadline):
    """stderr bytes up to and including the first line holding ``needle``."""
    buf = b""
    while needle not in buf:
        left = deadline - time.monotonic()
        assert left > 0, buf.decode()
        ready, _, _ = select.select([stream], [], [], left)
        if ready:
            chunk = os.read(stream.fileno(), 4096)
            assert chunk, buf.decode()  # the server exited
            buf += chunk
    return buf


def test_serve_subprocess_answers_a_client_and_never_imports_jax():
    code = (
        "import sys\n"
        "from audio_pattern_detector_tpu_torch.cli import main\n"
        "try:\n"
        "    main(sys.argv[1:])\n"
        "finally:\n"
        "    print('JAX_IMPORTED', 'jax' in sys.modules, file=sys.stderr, flush=True)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve", "--device", "cpu", "--port", "0",
         "--max-streams", "1", "--pattern-file", RTHK_TOML, "--pattern-file", CBS_CLIP],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    try:
        head = _read_until(proc.stderr, b"Serving ", time.monotonic() + 240).decode()
        line = next(x for x in head.splitlines() if x.startswith("Serving "))
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        make, want = PAYLOADS["rthk_int16"]
        assert after_start(run_client(port, make())) == want
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == 0
    assert err.decode().strip().splitlines()[-1] == "JAX_IMPORTED False"


def test_serve_parser_takes_every_jax_serve_option(capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "audio_pattern_detector_tpu", "serve", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    jax_options = set(re.findall(r"--[a-z][a-z-]*", proc.stdout))
    with pytest.raises(SystemExit):
        cli.main(["serve", "--help"])
    port_options = set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))
    assert "--mesh-stream" in jax_options and "--tile" in jax_options
    assert jax_options <= port_options and "--device" in port_options


def _parallel_scan(fn, files, **kw):
    """``fn``'s results and its full callback sequence, in firing order."""
    events = []
    results = fn(
        files, PATTERNS, n_slots=2,
        on_file_start=lambda i, src: events.append(("start", i, src)),
        on_file_detect=lambda i, src, name, t: events.append(("detect", i, src, name, t)),
        on_file_end=lambda i, src, total: events.append(("end", i, src, total)),
        **kw,
    )
    return results, events


def test_parallel_multi_file_scan_equals_the_sequential_scan():
    files = [RTHK, CBS, RTHK]
    got, events = _parallel_scan(match_pattern_many_parallel, files, device="cpu")
    want, want_events = _parallel_scan(jax_match_pattern_many_parallel, files)
    assert got == want == match_pattern_many(files, PATTERNS, device="cpu")
    assert events == want_events
    assert [e[1] for e in events if e[0] == "start"] == [0, 1, 2]  # slot 0 recycles for file 2
    assert sum(e[0] == "detect" for e in events) == 5
    # Without enough devices a stream mesh is refused with the JAX message.
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 1 available"):
        match_pattern_many_parallel(files, PATTERNS, mesh_stream=2, device="cpu")


def test_parallel_scan_recycles_slots_across_rounds_like_the_jax_scan():
    """10 s chunks: the CBS file spans 4 rounds while the RTHK files take
    turns in the other slot. One round in flight makes the callback order
    independent of when a round completes, so the sequences must match."""
    files = [RTHK, CBS, RTHK, RTHK]
    kw = {"seconds_per_chunk": 10, "pipeline_depth": 1}
    got, events = _parallel_scan(match_pattern_many_parallel, files, device="cpu", **kw)
    want, want_events = _parallel_scan(jax_match_pattern_many_parallel, files, **kw)
    assert got == want
    assert events == want_events
    starts = [e[1] for e in events if e[0] == "start"]
    first_end = next(k for k, e in enumerate(events) if e[0] == "end")
    assert starts == [0, 1, 2, 3] and events.index(("start", 2, RTHK)) > first_end


def test_parallel_scan_never_imports_jax():
    """The port reuses the JAX package's host-only slot loop; with no mesh
    neither it nor the session it builds loads jax."""
    code = (
        "import sys\n"
        "from audio_pattern_detector_tpu_torch.match import match_pattern_many_parallel\n"
        f"res = match_pattern_many_parallel([{RTHK!r}, {CBS!r}], {PATTERNS!r}, n_slots=2, "
        "device='cpu')\n"
        "print(sorted(res[0][0]['rthk_beep']), round(res[1][1], 3))\n"
        "print('JAX_IMPORTED', 'jax' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["[1.407875, 2.419625] 32.122", "JAX_IMPORTED False"]
