"""Every surface of the port that takes a device mesh, on logical shards
of the one CPU device, against the JAX package on its virtual CPU devices
and against the port's own unsharded runs.

* ``MultiStreamSession(mesh=)``: each stream's detections equal the JAX
  session's with a mesh, the port's unsharded session's and the serial
  engine's; every error message equals JAX's.
* ``PatternBank.dispatch_chunks_batch(sharding=)``: the stitched payload
  is bit-equal, row by row, to the unsharded ``"vmap"`` round.
* ``match_pattern_many_parallel(mesh_stream=2)``, ``PatternServer(mesh=)``
  with two TCP clients, and the CLI in subprocesses with
  ``APD_TORCH_LOGICAL_DEVICES`` (``--mesh-time``, ``--mesh-bank``,
  ``--stdin --mesh-time``, ``--mesh-stream``): stdout byte-identical to the
  port's serial CLI, which ``tests/test_torch_stream.py`` pins to the JAX
  CLI's; the usage errors carry the JAX messages.

Nothing here has a tolerance: payloads, timestamps and stdout are compared
exactly.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import wave

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.match import (
    match_pattern_many_parallel as jax_match_pattern_many_parallel,
)
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector as JaxDetector
from audio_pattern_detector_tpu.models.multistream import (
    MultiStreamSession as JaxMultiStreamSession,
)
from audio_pattern_detector_tpu.parallel import make_mesh as jax_make_mesh
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import (
    AudioClip,
    AudioPatternDetector,
    AudioStream,
    MultiStreamSession,
    PatternServer,
)
from audio_pattern_detector_tpu_torch.match import (
    TorchEngineOptions,
    match_pattern,
    match_pattern_many,
    match_pattern_many_parallel,
)
from audio_pattern_detector_tpu_torch.parallel import RowSharding, make_mesh
from audio_pattern_detector_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV
from audio_pattern_detector_tpu_torch.utils.audio_io import load_wave_file

torch.set_num_threads(1)

SR = 8000
CHUNK_S = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")
RTHK = os.path.join(AUDIO, "rthk_section_with_beep.wav")
RTHK_TOML = os.path.join(AUDIO, "clips", "rthk_beep.apd.toml")
CBS = os.path.join(AUDIO, "cbs_news_audio_section.wav")
CBS_CLIP = os.path.join(AUDIO, "clips", "cbs_news.wav")
PATTERNS = [RTHK_TOML, CBS_CLIP]


def stream_mesh(n):
    return make_mesh({"stream": n}, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def clips():
    return [AudioClip.from_audio_file(p, sample_rate=SR) for p in PATTERNS]


@pytest.fixture(scope="module")
def stream_audios():
    rng = np.random.default_rng(11)
    return [
        load_wave_file(RTHK, SR),
        load_wave_file(CBS, SR)[: 12 * SR],
        (0.05 * rng.standard_normal(9 * SR)).astype(np.float32),
    ]


def _chunked(audio):
    n = CHUNK_S * SR
    return [audio[o : o + n] for o in range(0, len(audio), n)]


def _drive(session, per_stream_chunks, names):
    acc = [{n: [] for n in names} for _ in per_stream_chunks]
    for r in range(max(len(c) for c in per_stream_chunks)):
        feed = [chunks[r] if r < len(chunks) else None for chunks in per_stream_chunks]
        for i, res in enumerate(session.feed(feed)):
            for name, times in res.items():
                acc[i][name].extend(times)
    return acc


# ── MultiStreamSession(mesh=) ──


def test_mesh_sharded_streams_equal_jax_unsharded_and_serial(clips, stream_audios):
    """Four slots over a 2-shard "stream" mesh (slot 3 replays stream 0):
    the JAX session on a 2-device mesh, the port's unsharded session and
    the port's serial engine all give each stream the same detections."""
    names = [c.name for c in clips]
    audios = stream_audios + [stream_audios[0]]
    per_stream_chunks = [_chunked(a) for a in audios]
    det = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    session = MultiStreamSession(det, n_streams=4, mesh=stream_mesh(2))
    assert session._batch_mode == "vmap" and session._tile is None
    got = _drive(session, per_stream_chunks, names)

    assert got == _drive(MultiStreamSession(det, n_streams=4), per_stream_chunks, names)
    jdet = JaxDetector([jclip.AudioClip(**dataclasses.asdict(c)) for c in clips],
                       seconds_per_chunk=CHUNK_S)
    jsession = JaxMultiStreamSession(jdet, n_streams=4, mesh=jax_make_mesh({"stream": 2}))
    assert got == _drive(jsession, per_stream_chunks, names)
    for i, audio in enumerate(audios):
        serial, total = det.find_clip_in_audio(
            AudioStream(name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR))
        assert got[i] == serial, f"stream {i}"
        assert session.total_time(i) == pytest.approx(total)
    assert len(set(got[0]["rthk_beep"])) == 2 and got[0] == got[3]


def test_pipelined_mesh_rounds_equal_synchronous(clips, stream_audios):
    """Three rounds in flight on the mesh give what synchronous feeds give,
    and ``round_ready`` answers for the stitched payload."""
    names = [c.name for c in clips]
    per_stream_chunks = [_chunked(a) for a in stream_audios[:2]]
    det = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    want = _drive(MultiStreamSession(det, 2, mesh=stream_mesh(2)), per_stream_chunks, names)
    session = MultiStreamSession(det, 2, mesh=stream_mesh(2))
    acc = [{n: [] for n in names} for _ in range(2)]
    pending = []
    for r in range(max(len(c) for c in per_stream_chunks)):
        pending.append(session.dispatch(
            [chunks[r] if r < len(chunks) else None for chunks in per_stream_chunks]))
        assert session.round_ready(pending[0])
        if len(pending) == 3:
            for a, res in zip(acc, session.collect(pending.pop(0))):
                for name, ts in res.items():
                    a[name].extend(ts)
    for handle in pending:
        for a, res in zip(acc, session.collect(handle)):
            for name, ts in res.items():
                a[name].extend(ts)
    assert acc == want


def _error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("case", ["no_stream_axis", "tile_and_mesh", "scan_and_mesh", "indivisible"])
def test_mesh_validation_messages_equal_jax(clips, case):
    det = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    jdet = JaxDetector([jclip.AudioClip(**dataclasses.asdict(c)) for c in clips],
                       seconds_per_chunk=CHUNK_S)

    def attempt(cls, d, mesh_of):
        return {
            "no_stream_axis": lambda: cls(d, 4, mesh=mesh_of({"time": 2})),
            "tile_and_mesh": lambda: cls(d, 4, mesh=mesh_of({"stream": 2}), tile=2),
            "scan_and_mesh": lambda: cls(d, 4, mesh=mesh_of({"stream": 2}), batch_mode="scan"),
            "indivisible": lambda: cls(d, 3, mesh=mesh_of({"stream": 2})),
        }[case]

    got = _error(attempt(MultiStreamSession, det,
                         lambda axes: make_mesh(axes, devices=["cpu"] * 2)))
    assert got == _error(attempt(JaxMultiStreamSession, jdet, jax_make_mesh))


# ── dispatch_chunks_batch(sharding=) ──


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_round_payload_is_bit_equal_row_by_row(clips, stream_audios, shards):
    """A round of independent rows (a first chunk, a chunk with an int16
    lookback, a zero-length idle row, a short chunk) through the stream
    axis: each class's stitched payload equals the unsharded "vmap"
    round's, and so do the results."""
    bank = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()
    rthk, cbs, noise = stream_audios
    pcm = np.clip(np.round(cbs * 32768), -32768, 32767).astype(np.int16)
    n = CHUNK_S * SR
    rows = [rthk[:n], pcm[n : 2 * n], np.zeros(0, np.float32), noise[4 * n :]]
    tails = [None, pcm[:n], None, noise[3 * n : 4 * n]]
    plain = bank.dispatch_chunks_batch(rows, None, mode="vmap", prev_tails=tails)
    sharded = bank.dispatch_chunks_batch(
        rows, None, mode="vmap", prev_tails=tails, sharding=RowSharding(stream_mesh(shards)))
    assert len(plain) == len(sharded) == len(bank.classes)
    for (sw, handle, _, b, _), (sw2, handle2, _, b2, _) in zip(plain, sharded):
        assert (sw, b) == (sw2, b2) and handle2.is_ready()
        want, got = handle.numpy(), handle2.numpy()
        assert got.shape == want.shape == (4, want.shape[1])
        for r in range(4):
            assert got[r].tobytes() == want[r].tobytes(), f"class {sw} row {r}"
    assert bank.collect_chunks_batch(sharded) == bank.collect_chunks_batch(plain)


# ── match_pattern(..., mesh_time=, mesh_bank=) and the engine options ──


def test_match_pattern_mesh_time_and_bank_equal_serial(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "4")
    want = match_pattern(RTHK, [RTHK_TOML], device="cpu")
    assert [round(t * 1000) for t in want[0]["rthk_beep"]] == [1408, 2420]
    events = []
    got = match_pattern(RTHK, [RTHK_TOML], device="cpu", mesh_time=4,
                        on_pattern_detected=lambda n, t: events.append((n, t)))
    assert got == want and [t for _, t in events] == want[0]["rthk_beep"]
    assert match_pattern(RTHK, PATTERNS, device="cpu", mesh_time=2, mesh_bank=2,
                         seconds_per_chunk=8) == match_pattern(
        RTHK, PATTERNS, device="cpu", seconds_per_chunk=8)
    many = match_pattern_many([RTHK, CBS], PATTERNS, device="cpu", mesh_time=2)
    assert many == match_pattern_many([RTHK, CBS], PATTERNS, device="cpu")


OPTION_ERRORS = {
    "mesh_bank_alone": dict(mesh_bank=2),
    "mesh_bank_zero": dict(mesh_bank=0),
    "mesh_time_zero": dict(mesh_time=0),
    "mesh_time_with_batches": dict(mesh_time=2, offline_batch=2, stream_batch=2, pipeline_depth=2),
    "mesh_time_debug": dict(mesh_time=2, debug_mode=True),
    "mesh_stream_zero": dict(mesh_stream=0),
    "mesh_stream_with_all": dict(mesh_stream=2, debug_mode=True, profile=True, trace_dir="t",
                                 offline_batch=2, stream_batch=2, mesh_time=2,
                                 checkpoint_file="ck"),
    "checkpoint_with_mesh_time": dict(mesh_time=2, checkpoint_file="ck"),
}


@pytest.mark.parametrize("case", sorted(OPTION_ERRORS))
def test_engine_option_errors_equal_jax(case):
    from audio_pattern_detector_tpu.match import EngineOptions

    kwargs = OPTION_ERRORS[case]
    for from_stdin in (False, True):
        got = _error(lambda: TorchEngineOptions(**kwargs).validate(from_stdin))
        assert got == _error(lambda: EngineOptions(**kwargs).validate(from_stdin))


# ── match_pattern_many_parallel(mesh_stream=) ──


def _parallel_scan(fn, files, **kw):
    events = []
    results = fn(
        files, PATTERNS,
        on_file_start=lambda i, src: events.append(("start", i, src)),
        on_file_detect=lambda i, src, name, t: events.append(("detect", i, src, name, t)),
        on_file_end=lambda i, src, total: events.append(("end", i, src, total)),
        **kw,
    )
    return results, events


def test_parallel_scan_over_a_stream_mesh_equals_jax_and_sequential(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "2")
    files = [RTHK, CBS, RTHK]
    kw = {"mesh_stream": 2, "seconds_per_chunk": 10, "pipeline_depth": 1}
    got, events = _parallel_scan(match_pattern_many_parallel, files, device="cpu", **kw)
    want, want_events = _parallel_scan(jax_match_pattern_many_parallel, files, **kw)
    assert got == want and events == want_events
    assert got == match_pattern_many(files, PATTERNS, seconds_per_chunk=10, device="cpu")
    assert sum(e[0] == "detect" for e in events) == 5
    message = _error(lambda: match_pattern_many_parallel(
        files, PATTERNS, mesh_stream=2, n_slots=3, device="cpu"))
    assert message == _error(lambda: jax_match_pattern_many_parallel(
        files, PATTERNS, mesh_stream=2, n_slots=3))


# ── PatternServer(mesh=) ──


def _client(port, payload):
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall(payload)
    sock.shutdown(socket.SHUT_WR)
    sock.settimeout(120)
    buf = b""
    while True:
        data = sock.recv(1 << 16)
        if not data:
            break
        buf += data
    sock.close()
    return buf


def test_server_on_a_stream_mesh_answers_two_clients_like_the_plain_server(clips):
    """Two concurrent clients of a server on a 2-shard stream mesh get,
    after ``start``, the events a server without a mesh sends them (which
    tests/test_torch_serve.py pins to the JAX ``match --stdin`` output)."""
    payloads = {"rthk": open(RTHK, "rb").read(), "cbs": open(CBS, "rb").read()}

    def serve(**kw):
        srv = PatternServer(clips, port=0, max_streams=2, seconds_per_chunk=10, device="cpu", **kw)
        srv.warmup()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        results = {}
        clients = [threading.Thread(target=lambda n=n, p=p: results.__setitem__(
            n, _client(srv.address[1], p))) for n, p in payloads.items()]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=180)
            assert not t.is_alive()
        srv.shutdown()
        thread.join(timeout=60)
        assert not thread.is_alive()
        return srv, {n: raw.partition(b"\n")[2] for n, raw in results.items()}

    meshed, got = serve(mesh=stream_mesh(2))
    assert meshed.session._tile_widths is None and meshed.session._sharding is not None
    plain, want = serve()
    assert plain.session._tile_widths == [2, 1]
    assert got == want
    hits = [json.loads(x) for x in got["rthk"].splitlines()]
    assert [e.get("timestamp_ms") for e in hits[:-1]] == [1408, 2420]
    assert json.loads(got["cbs"].splitlines()[0])["timestamp_ms"] == 25899


# ── The CLI, in subprocesses ──


def run_cli(args, stdin=None, logical=None):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop(LOGICAL_DEVICES_ENV, None)
    if logical is not None:
        env[LOGICAL_DEVICES_ENV] = str(logical)
    return subprocess.run(
        [sys.executable, "-m", "audio_pattern_detector_tpu_torch", "match", "--device", "cpu",
         *args],
        input=stdin, capture_output=True, cwd=REPO, env=env, timeout=600,
    )


@pytest.fixture(scope="module")
def serial_rthk_stdout():
    proc = run_cli(["--pattern-file", RTHK_TOML, RTHK])
    assert proc.returncode == 0, proc.stderr.decode()
    events = [json.loads(x) for x in proc.stdout.decode().splitlines()]
    assert [e["type"] for e in events] == ["start", "pattern_detected", "pattern_detected", "end"]
    return proc.stdout


def test_cli_mesh_time_stdout_is_byte_identical_to_serial(serial_rthk_stdout):
    sharded = run_cli(["--mesh-time", "4", "--pattern-file", RTHK_TOML, RTHK], logical=4)
    assert sharded.returncode == 0, sharded.stderr.decode()
    assert sharded.stdout == serial_rthk_stdout


def test_cli_mesh_bank_times_time_stdout_is_byte_identical(serial_rthk_stdout):
    sharded = run_cli(["--mesh-time", "2", "--mesh-bank", "2", "--pattern-file", RTHK_TOML, RTHK],
                      logical=4)
    assert sharded.returncode == 0, sharded.stderr.decode()
    assert sharded.stdout == serial_rthk_stdout


def test_cli_stdin_mesh_time_on_a_multi_slab_stream():
    """The RTHK section tiled 40 times (about 163 s) in 20 s chunks: the
    detections land in three slabs of a 4-shard time mesh."""
    with wave.open(RTHK, "rb") as w:
        pcm = w.readframes(w.getnframes())
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm * 40)
    base = ["--stdin", "--chunk-seconds", "20", "--pattern-file", RTHK_TOML]
    serial = run_cli(base, stdin=buf.getvalue())
    sharded = run_cli([*base, "--mesh-time", "4"], stdin=buf.getvalue(), logical=4)
    assert serial.returncode == 0, serial.stderr.decode()
    assert sharded.returncode == 0, sharded.stderr.decode()
    assert sharded.stdout == serial.stdout
    hits = sum(b'"pattern_detected"' in x for x in serial.stdout.splitlines())
    assert hits >= 40  # about 2 beeps per tiled section (the ms dedup may merge)


def test_cli_mesh_stream_over_two_files_is_byte_identical_to_sequential():
    args = ["--pattern-file", RTHK_TOML, "--pattern-file", CBS_CLIP, RTHK, CBS]
    serial = run_cli(args)
    sharded = run_cli(["--mesh-stream", "2", *args], logical=2)
    assert serial.returncode == 0, serial.stderr.decode()
    assert sharded.returncode == 0, sharded.stderr.decode()
    assert sharded.stdout == serial.stdout
    assert [json.loads(x)["type"] for x in sharded.stdout.decode().splitlines()] == [
        "start", "pattern_detected", "pattern_detected", "end", "start", "pattern_detected", "end"]


USAGE_ERRORS = {
    "incompatible_with_batch_flags": (["--mesh-time", "4", "--offline-batch", "2"], 8,
                                      b"mesh sharding is incompatible with: offline_batch"),
    "mesh_bank_requires_mesh_time": (["--mesh-bank", "2"], 8, b"mesh_bank requires mesh_time"),
    "needs_enough_devices": (["--mesh-time", "64"], 8, b"mesh needs 64 devices, only 8 available"),
    "no_logical_devices": (["--mesh-time", "64"], None, b"mesh needs 64 devices, only 1 available"),
}


@pytest.mark.parametrize("case", sorted(USAGE_ERRORS))
def test_cli_mesh_usage_errors_carry_the_jax_messages(case):
    extra, logical, message = USAGE_ERRORS[case]
    proc = run_cli([*extra, "--pattern-file", RTHK_TOML, RTHK], logical=logical)
    assert proc.returncode != 0
    assert message in proc.stderr
    assert b"pattern_detected" not in proc.stdout


def test_cli_mesh_stream_guards(capsys):
    """The argument checks of the JAX ``cmd_match``: message and exit 1."""
    from audio_pattern_detector_tpu_torch import cli

    for argv, message in (
        (["--mesh-stream", "2", "--stdin"], "--mesh-stream requires file mode"),
        (["--mesh-stream", "2", RTHK], "--mesh-stream parallelises across MULTIPLE audio files"),
        (["--mesh-stream", "2", "--stream-batch", "2", RTHK, CBS],
         "mesh_stream is incompatible with: stream_batch"),
    ):
        with pytest.raises(SystemExit) as exc:
            cli.main(["match", "--device", "cpu", "--pattern-file", RTHK_TOML, *argv])
        assert exc.value.code == 1
        captured = capsys.readouterr()
        assert f"Error: {message}" in captured.err and "pattern_detected" not in captured.out
