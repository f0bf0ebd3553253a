"""The port's streaming loop and CLI surfaces against the JAX package's.

* Loop: ``TorchAudioPatternDetector.find_clip_in_audio`` against
  ``AudioPatternDetector.find_clip_in_audio`` on the same stream: the same
  detections in the same order, byte-identical ``StreamCheckpoint``s, and
  a resume from one of them that continues the full run exactly. The
  detections are integer positions turned into timestamps by the same
  host algebra, so they are compared exactly.
* CLI: stdout of every flag this slice ports is byte-identical to the JAX
  CLI's on the same arguments. The JAX outputs are pinned below (taken
  from the JAX CLI once) rather than rerun per case. Guards give the JAX
  CLI's messages and exit codes. Two runs in subprocesses check that the
  port never imports jax.
"""

import contextlib
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import cli
from audio_pattern_detector_tpu_torch.match import match_pattern, match_pattern_many
from audio_pattern_detector_tpu_torch.models.detector import (
    StreamCheckpoint,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream

torch.set_num_threads(1)

SR = 8000
CHUNK_S = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")
RTHK = os.path.join(AUDIO, "rthk_section_with_beep.wav")
RTHK_TOML = os.path.join(AUDIO, "clips", "rthk_beep.apd.toml")
CBS = os.path.join(AUDIO, "cbs_news_audio_section.wav")
CBS_CLIP = os.path.join(AUDIO, "clips", "cbs_news.wav")


# ── The streaming loop ──


def _clip_and_audio():
    """A 0.6 s clip and 37.5 s of int16 audio (the last chunk short) with
    hits at 4 s, 9.8 s (across the first chunk boundary) and 33 s."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    rng = np.random.default_rng(41)
    audio = 0.01 * rng.standard_normal(int(37.5 * SR))
    for s in (4.0, 9.8, 33.0):
        o = int(s * SR)
        audio[o : o + len(clip)] += clip
    pcm = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    return AudioClip(name="c", audio=clip, sample_rate=SR), pcm


def _run(det, samples, checkpoint=None, **kw):
    """One loop run: a log of ("det", name, t) and ("ck", bytes) entries in
    the order the callbacks fired, the accumulated peaks and total time."""
    log = []
    stream_cls = AudioStream if isinstance(det, TorchAudioPatternDetector) else jclip.AudioStream
    stream = stream_cls(
        name="s", audio_stream=io.BytesIO(samples.tobytes()), sample_rate=SR,
        sample_dtype=samples.dtype,
    )
    peaks, total = det.find_clip_in_audio(
        stream,
        on_pattern_detected=lambda name, t: log.append(("det", name, t)),
        on_checkpoint=lambda ck: log.append(("ck", ck.to_bytes())),
        checkpoint=checkpoint,
        **kw,
    )
    return log, peaks, total


@pytest.fixture(scope="module")
def detectors():
    clip, pcm = _clip_and_audio()
    return (
        AudioPatternDetector([jclip.AudioClip(**dataclasses.asdict(clip))], seconds_per_chunk=CHUNK_S),
        TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=CHUNK_S),
        pcm,
    )


@pytest.mark.parametrize(
    "stream_batch,pipeline_depth,dtype",
    [
        (1, 1, "int16"),
        (1, 3, "int16"),
        (2, 1, "int16"),
        (2, 3, "int16"),
        (1, 3, "float32"),
        (2, 3, "float32"),
    ],
)
def test_loop_matches_jax_events_and_checkpoint_bytes(detectors, stream_batch, pipeline_depth, dtype):
    jdet, tdet, pcm = detectors
    samples = pcm if dtype == "int16" else (pcm / np.float32(32768)).astype(np.float32)
    kw = dict(stream_batch=stream_batch, pipeline_depth=pipeline_depth)
    want = _run(jdet, samples, **kw)
    got = _run(tdet, samples, **kw)
    assert got == want
    log, peaks, total = got
    assert [round(t, 3) for t in peaks["c"]] == [4.0, 9.8, 33.0] and total == 37.5
    cks = [StreamCheckpoint.from_bytes(e[1]) for e in log if e[0] == "ck"]
    assert [c.chunk_index for c in cks] == [1, 2, 3, 4]
    assert all(c.previous_tail.dtype == np.float32 for c in cks)
    assert tdet.last_run_stats.chunks == 4 and tdet.last_run_stats.detections == 3


@pytest.mark.parametrize("stream_batch", [1, 2])
def test_resume_from_a_port_checkpoint_continues_the_jax_run(detectors, stream_batch):
    jdet, tdet, pcm = detectors
    full, _, full_total = _run(jdet, pcm, stream_batch=stream_batch)
    ck_at = next(i for i, e in enumerate(full) if e[0] == "ck" and
                 StreamCheckpoint.from_bytes(e[1]).chunk_index == 2)
    ck = StreamCheckpoint.from_bytes(full[ck_at][1])
    rest = pcm[2 * CHUNK_S * SR :]
    resumed, _, total = _run(tdet, rest, checkpoint=ck, stream_batch=stream_batch)
    assert resumed == full[ck_at + 1 :]
    assert total == full_total
    assert [e[1] for e in resumed if e[0] == "det"] == ["c"]  # the 33 s hit


def test_debug_mode_runs_the_host_path_and_the_device(tmp_path, capsys, monkeypatch):
    from audio_pattern_detector_tpu_torch.models.bank import PatternBank

    device_chunks = []
    process_chunk = PatternBank.process_chunk
    monkeypatch.setattr(
        PatternBank, "process_chunk",
        lambda self, *a: device_chunks.append(1) or process_chunk(self, *a),
    )
    clip, pcm = _clip_and_audio()
    det = TorchAudioPatternDetector(
        [clip], device="cpu", seconds_per_chunk=60, debug_mode=True, debug_dir=str(tmp_path)
    )
    stream = AudioStream(name="s", audio_stream=io.BytesIO(pcm.tobytes()), sample_rate=SR,
                         sample_dtype=np.int16)
    peaks, _ = det.find_clip_in_audio(stream)
    assert [round(t, 3) for t in peaks["c"]] == [4.0, 9.8, 33.0]
    assert os.listdir(tmp_path / "debug" / "cross_correlation_c") == ["0_00:00:00.txt"]
    assert "differ from the host path" not in capsys.readouterr().err
    assert device_chunks == [1]  # the device ran the chunk too


# ── The CLI ──


def _line(obj):
    return json.dumps(obj, ensure_ascii=False)


def _block(source, hits, end_ms, end_fmt):
    out = [_line({"type": "start", "source": source})]
    out += [
        _line({"type": "pattern_detected", "clip_name": name, "timestamp_ms": ms,
               "timestamp_formatted": fmt})
        for name, ms, fmt in hits
    ]
    out.append(_line({"type": "end", "total_time_ms": end_ms, "total_time_formatted": end_fmt}))
    return "\n".join(out) + "\n"


RTHK_HITS = [("rthk_beep", 1408, "00:00:01.408"), ("rthk_beep", 2420, "00:00:02.420")]
CBS_HITS = [("cbs_news", 25899, "00:00:25.899")]
# The JAX CLI's stdout for each case (`python -m audio_pattern_detector_tpu
# match ...` with the same arguments, on the CPU).
JAX_STDOUT = {
    "stdin": _block("stdin", RTHK_HITS, 4089, "00:00:04.089"),
    "multiplexed_stdin": _block("multiplexed-stdin", CBS_HITS, 32122, "00:00:32.122"),
    "offline_batch": _block(RTHK, RTHK_HITS, 4078, "00:00:04.078"),
    "checkpoint_file": _block(RTHK, RTHK_HITS, 4078, "00:00:04.078"),
    "debug": _block(RTHK, RTHK_HITS, 4078, "00:00:04.078"),
    "trace_dir": _block(RTHK, RTHK_HITS, 4078, "00:00:04.078"),
    "two_files": _block(RTHK, RTHK_HITS, 4078, "00:00:04.078")
    + _block(CBS, CBS_HITS, 32122, "00:00:32.122"),
    "height_min_0": _block(CBS, CBS_HITS, 32122, "00:00:32.122"),
}


def _multiplexed_input():
    data = open(CBS_CLIP, "rb").read()
    name = b"cbs_news"
    head = struct.pack("<II", 1, len(name)) + name + struct.pack("<I", len(data))
    return head + data + open(CBS, "rb").read()


class _Stdin:
    def __init__(self, data):
        self.buffer = io.BytesIO(data)


def _run_cli(argv, stdin_bytes=None, monkeypatch=None):
    if stdin_bytes is not None:
        monkeypatch.setattr(sys, "stdin", _Stdin(stdin_bytes))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["match", "--device", "cpu", *argv])
    return out.getvalue()


@pytest.mark.parametrize("case", sorted(JAX_STDOUT))
def test_cli_stdout_identical_to_jax(case, tmp_path, monkeypatch):
    stdin = None
    args = {
        "stdin": ["--stdin", "--pattern-file", RTHK_TOML],
        "multiplexed_stdin": ["--multiplexed-stdin"],
        "offline_batch": ["--offline-batch", "4", "--pattern-file", RTHK_TOML, RTHK],
        "checkpoint_file": ["--chunk-seconds", "2", "--checkpoint-file", str(tmp_path / "ck"),
                            "--pattern-file", RTHK_TOML, RTHK],
        "debug": ["--debug", "--debug-dir", str(tmp_path / "dbg"), "--pattern-file", RTHK_TOML, RTHK],
        "trace_dir": ["--trace-dir", str(tmp_path / "tr"), "--pattern-file", RTHK_TOML, RTHK],
        "two_files": ["--pattern-file", RTHK_TOML, "--pattern-file", CBS_CLIP, RTHK, CBS],
        "height_min_0": ["--height-min", "0", "--pattern-file", CBS_CLIP, CBS],
    }[case]
    if case == "stdin":
        stdin = open(RTHK, "rb").read()
    elif case == "multiplexed_stdin":
        stdin = _multiplexed_input()
    assert _run_cli(args, stdin, monkeypatch) == JAX_STDOUT[case]
    if case == "checkpoint_file":
        assert not os.path.exists(tmp_path / "ck")
    elif case == "debug":
        assert (tmp_path / "dbg" / "debug" / "cross_correlation_rthk_beep" / "0_00:00:00.txt").exists()
    elif case == "trace_dir":
        (trace,) = os.listdir(tmp_path / "tr")
        assert trace.endswith(".json") and json.load(open(tmp_path / "tr" / trace))["traceEvents"]


def test_cli_resumes_from_an_interrupted_runs_checkpoint(tmp_path, capsys):
    """A checkpoint after the first 2 s chunk (as an interrupted run leaves
    it) makes a rerun of the same command skip that chunk. The resumed
    run's first section looks back 1 s into the skipped chunk, so the
    1408 ms beep there is found again: together the two runs give the
    uninterrupted run's detections, as in the JAX CLI."""
    clip = AudioClip.from_audio_file(RTHK_TOML, sample_rate=SR)
    det = TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=2)
    from audio_pattern_detector_tpu.utils.audio_io import load_wave_file

    audio = load_wave_file(RTHK, SR)[: 2 * SR]
    cks = []
    head, _ = det.find_clip_in_audio(
        AudioStream(name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR),
        on_checkpoint=cks.append,
    )
    ck = tmp_path / "ck"
    ck.write_bytes(cks[-1].to_bytes())
    events = [json.loads(x) for x in _run_cli(
        ["--chunk-seconds", "2", "--timestamp-format", "ms", "--checkpoint-file", str(ck),
         "--pattern-file", RTHK_TOML, RTHK]
    ).splitlines()]
    assert [round(t * 1000) for t in head["rthk_beep"]] == [1408]
    assert [e.get("timestamp_ms") for e in events if e["type"] == "pattern_detected"] == [1408, 2420]
    assert events[-1] == {"type": "end", "total_time_ms": 4078} and not ck.exists()
    assert "Resuming from checkpoint" in capsys.readouterr().err


@pytest.mark.parametrize(
    "argv",
    [
        ["--stdin", "--pattern-file", RTHK_TOML, RTHK],
        ["--multiplexed-stdin", RTHK],
        ["--offline-batch", "2", "--stdin", "--pattern-file", RTHK_TOML],
        ["--checkpoint-file", "ck", "--pattern-file", RTHK_TOML, RTHK, CBS],
        ["--debug", "--pattern-file", RTHK_TOML, RTHK, CBS],
        ["--pattern-file", RTHK_TOML],
        [RTHK],
    ],
    ids=["files_and_stdin", "files_and_multiplexed", "offline_and_stdin",
         "checkpoint_with_two_files", "debug_with_two_files", "no_audio", "no_patterns"],
)
def test_cli_guards_match_jax(argv, capsys, monkeypatch):
    from audio_pattern_detector_tpu.cli import main as jax_main

    monkeypatch.setenv("APD_COMPILE_CACHE", "off")
    monkeypatch.setattr(sys, "argv", ["audio-pattern-detector-tpu", "match", *argv])
    with pytest.raises(SystemExit) as jax_exit:
        jax_main()
    want = capsys.readouterr()
    with pytest.raises(SystemExit) as port_exit:
        cli.main(["match", "--device", "cpu", *argv])
    got = capsys.readouterr()
    assert port_exit.value.code == jax_exit.value.code == 1
    assert got.err == want.err and got.err.startswith(("Error: ", "Please provide"))
    assert got.out == want.out


def test_library_entry_points_match_the_cli(tmp_path):
    peaks, total = match_pattern(RTHK, [RTHK_TOML], device="cpu", offline_batch=2)
    assert [round(t * 1000) for t in peaks["rthk_beep"]] == [1408, 2420] and round(total * 1000) == 4078
    seen = []
    results = match_pattern_many(
        [RTHK, CBS], [RTHK_TOML, CBS_CLIP], device="cpu", chunk_seconds_auto_perf=True,
        on_file_start=seen.append, trace_dir=str(tmp_path),
    )
    assert seen == [RTHK, CBS]
    assert [round(t * 1000) for t in results[1][0]["cbs_news"]] == [25899]
    assert results[0][0]["cbs_news"] == [] and len(os.listdir(tmp_path)) == 1


def _subprocess(argv, stdin_bytes=None):
    code = (
        "import sys\n"
        "from audio_pattern_detector_tpu_torch.cli import main\n"
        "main(sys.argv[1:])\n"
        "print('JAX_IMPORTED', 'jax' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, "match", "--device", "cpu", *argv],
        cwd=REPO, input=stdin_bytes, capture_output=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr.decode()
    return proc.stdout.decode().splitlines()


def test_stdin_checkpoint_run_never_imports_jax(tmp_path):
    ck = tmp_path / "ck"
    lines = _subprocess(
        ["--stdin", "--chunk-seconds", "2", "--checkpoint-file", str(ck),
         "--pattern-file", RTHK_TOML],
        open(RTHK, "rb").read(),
    )
    assert lines[-1] == "JAX_IMPORTED False"
    assert "\n".join(lines[:-1]) + "\n" == JAX_STDOUT["stdin"] and not ck.exists()


def test_two_file_run_never_imports_jax():
    lines = _subprocess(["--pattern-file", RTHK_TOML, "--pattern-file", CBS_CLIP, RTHK, CBS])
    assert lines[-1] == "JAX_IMPORTED False"
    assert "\n".join(lines[:-1]) + "\n" == JAX_STDOUT["two_files"]
