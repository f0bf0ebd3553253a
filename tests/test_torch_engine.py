"""The port's engine against the JAX package: class-step payloads,
detections, the CLI surface, and the no-jax guarantee.

Payload parity is exact: the packed payload holds only integer-valued
fields (positions, selected bits, flags), and every decision that sets
them sits far from a threshold on this audio, so the FFT differences
between torch and XLA (about 1e-7 relative) do not reach them. Detection
timestamps are the values the JAX package's own tests pin.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu import native
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import cli
from audio_pattern_detector_tpu_torch.match import _opts_for_source, _WavFileStreamWrapper
from audio_pattern_detector_tpu_torch.models.bank import PatternBank, class_step
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream
from audio_pattern_detector_tpu_torch.ops.consts import consts_from_numpy

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")
RTHK = os.path.join(AUDIO, "rthk_section_with_beep.wav")
RTHK_TOML = os.path.join(AUDIO, "clips", "rthk_beep.apd.toml")


def _hit_clips():
    """The normal clip and marker tone of tests/test_pallas_peaks.py's
    hit-bearing scan-batch identity test."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    freq = 941.0
    tm = np.arange(int(0.25 * SR)) / SR
    marker = np.sin(2 * np.pi * freq * tm).astype(np.float32)
    return [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(
            name="m", audio=marker, sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY, strategy_params={"dominant_frequency_hz": freq},
        ),
    ], clip, marker


def _hit_audio_i16():
    """40 s with two normal hits (4 s, 33 s) and a marker hit (17 s)."""
    rng = np.random.default_rng(23)
    clips, clip, marker = _hit_clips()
    audio = 0.01 * rng.standard_normal(40 * SR)
    audio[4 * SR : 4 * SR + len(clip)] += clip
    audio[17 * SR : 17 * SR + len(marker)] += 0.8 * marker
    audio[33 * SR : 33 * SR + len(clip)] += clip
    return clips, np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)


def _fields(c):
    return {
        f.name: getattr(c, f.name) if f.metadata.get("static") else np.asarray(getattr(c, f.name))
        for f in dataclasses.fields(c)
    }


def _carry(c):
    return consts_from_numpy(type(c).__name__, _fields(c), CPU)


# ── Payloads of the class step ──


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_xla_lean", "jax_pallas_interpret"])
def test_class_step_payload_identical_to_jax(pallas):
    from audio_pattern_detector_tpu.models.bank import _class_step_jit

    clips, audio = _hit_audio_i16()
    chunk_s = 9  # 10 s sections
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in clips]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=chunk_s)._ensure_bank()
    tbank = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=chunk_s)._ensure_bank()
    (sw, jcls), = jbank.classes.items()
    assert jbank._metas == tbank._metas
    loud = _carry(jcls["loud"])
    group_consts = tuple((_carry(g.corr), _carry(g.verify)) for g in jcls["groups"])
    chunks = [audio[o : o + chunk_s * SR] for o in range(0, len(audio), chunk_s * SR)]
    hit_rows = 0
    for i, chunk in enumerate(chunks):
        if pallas and i == 4:  # hit-free; the Pallas interpreter is slow
            continue
        raw = jbank._raw_section(sw, chunk, chunks[i - 1] if i else None)
        section = np.zeros(jcls["section_len"], np.float32)
        section[: len(raw)] = native.pcm16_to_f32_mono(raw)
        want = _class_step_jit(
            jnp.asarray(section), jnp.float32(len(raw)), jcls["loud"],
            tuple((g.corr, g.verify) for g in jcls["groups"]),
            metas=jbank._metas[sw], height_min=jbank.height_min, lean=True, pallas=pallas,
        )
        got = class_step(
            torch.from_numpy(section), len(raw), loud, group_consts,
            metas=tbank._metas[sw], height_min=tbank.height_min,
        )
        for g, w, t in zip(jcls["groups"], want, got):
            w, t = np.asarray(w["packed"]), t.numpy()
            np.testing.assert_array_equal(t, w, err_msg=f"chunk {i} group {g.kind}")
            k = g.k_verify
            hit_rows += int((t[:, k : 2 * k] != 0).any(axis=1).sum())
    # Both normal hits, and the marker hit twice: at 17 s it lies in chunk 1
    # and in chunk 2's 1 s lookback (the detector dedups it later).
    assert hit_rows == 4


def test_scan_batch_and_streaming_detect_the_planted_hits():
    clips, audio = _hit_audio_i16()
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=10)
    batched, total = det.find_clip_in_array(audio, batch_size=2, batch_mode="scan")
    stream = AudioStream(
        name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR, sample_dtype=np.int16
    )
    streamed, total_s = det.find_clip_in_audio(stream)
    assert total == total_s == 40.0
    assert batched == streamed
    assert [round(t, 3) for t in batched["c"]] == [4.0, 33.0]
    assert [round(t, 3) for t in batched["m"]] == [17.0]
    assert det._bank.host_path_rows == 0


def test_rthk_detections_match_pinned_values():
    clip = AudioClip.from_audio_file(RTHK_TOML, sample_rate=SR)
    det = TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=60)
    wrapper = _WavFileStreamWrapper(RTHK, SR)
    try:
        peaks, total = det.find_clip_in_audio(
            AudioStream(name="rthk", audio_stream=wrapper, sample_rate=SR)
        )
    finally:
        wrapper.close()
    assert [round(t * 1000) for t in peaks["rthk_beep"]] == [1408, 2420]
    assert round(total * 1000) == 4078


def test_flagged_rows_take_the_exact_host_path():
    """> 16 distance-spaced survivors flag the row; the port resolves it
    with the exact host path's result, through the wide rerun on the
    device (tests/test_torch_rerun.py covers every route)."""
    from audio_pattern_detector_tpu.models import hostpath

    rng = np.random.default_rng(3)
    clip = (0.4 * rng.standard_normal(SR)).astype(np.float32)
    det = TorchAudioPatternDetector(
        [AudioClip(name="c", audio=clip, sample_rate=SR)], device="cpu", seconds_per_chunk=24
    )
    bank = det._ensure_bank()
    g = bank.classes[1]["groups"][0]
    audio = (0.004 * rng.standard_normal(24 * SR)).astype(np.float32)
    for k in range(20):
        o = int((0.3 + 1.05 * k) * SR)
        audio[o : o + SR] += clip[: min(SR, len(audio) - o)]
    expected = hostpath.process_section_host(
        audio_section=audio, clip=g.clips_np[0], correlation_clip=g.corr_clips_np[0],
        correlation_clip_absolute_max=float(g.self_max_np[0]), sr=SR,
        height_min=bank.height_min, is_short_clip=False,
        tone_frequency=None, verification_params={},
    )
    assert bank.process_chunk(audio, None)["c"] == expected
    assert len(expected) == 20 and bank.row_reruns == 1 and bank.host_path_rows == 0


def test_flag_free_path_never_decodes_int16_tails(monkeypatch):
    """The JAX streaming loop decodes int16 checkpoint tails through the
    JAX bank; the port's loop must never reach it, checkpoints included."""
    stub = types.ModuleType("audio_pattern_detector_tpu.models.bank")

    def _forbidden(raw):
        raise AssertionError("the port's main path reached the JAX bank")

    stub._pcm16_to_f32 = _forbidden
    monkeypatch.setitem(sys.modules, "audio_pattern_detector_tpu.models.bank", stub)
    clips, audio = _hit_audio_i16()
    det = TorchAudioPatternDetector(clips[:1], device="cpu", seconds_per_chunk=10)
    for batch in (1, 2):
        stream = AudioStream(
            name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR,
            sample_dtype=np.int16,
        )
        cks = []
        peaks, _ = det.find_clip_in_audio(stream, stream_batch=batch, on_checkpoint=cks.append)
        assert len(peaks["c"]) == 2
        assert len(cks) == 4 and cks[-1].previous_tail.dtype == np.float32


# ── Bank contract ──


def test_bank_refuses_what_it_does_not_port():
    clips, _ = _hit_audio_i16()
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=10)
    bank = det._ensure_bank()
    with pytest.raises(ValueError, match=r"^mode must be 'vmap' or 'scan', got 'pmap'$"):
        bank.dispatch_chunks_batch([np.zeros(10 * SR, np.float32)], None, mode="pmap")
    with pytest.raises(ValueError, match=r"^sharding requires mode='vmap'$"):
        bank.dispatch_chunks_batch([np.zeros(10, np.float32)], None, mode="scan", sharding=object())
    assert bank.dispatch_chunks_batch([], None) == []
    general = PatternBank(det._clip_datas, det._tone_frequencies, {}, SR, 10 * SR, 0.0, CPU)
    assert general.height_min == 0.0 and general._metas == bank._metas


def test_flagship_twin_matches_jax_geometry():
    sys.path.insert(0, REPO)
    from __graft_entry__ import _make_bank

    from audio_pattern_detector_tpu_torch.flagship import flagship_step

    jbank, _ = _make_bank(num_normal=32, num_marker=32, chunk_seconds=60)
    step, tbank = flagship_step("cpu")
    assert tbank._metas == jbank._metas
    (sw, jcls), = jbank.classes.items()
    tcls = tbank.classes[sw]
    assert tcls["section_len"] == jcls["section_len"] == 61 * SR
    for jg, tg in zip(jcls["groups"], tcls["groups"]):
        assert jg.names == tg.names
        for f in ("fft_len", "full_len", "num_segments", "step", "pad_left", "out_offset"):
            assert getattr(jg.corr, f) == getattr(tg.corr, f), f
    payloads = step()
    assert [p.shape for p in payloads] == [(32, 2 * g.k_verify + 2) for g in tcls["groups"]]
    assert all(bool(torch.isfinite(p).all()) for p in payloads)


# ── CLI ──


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def test_cli_golden_flows_on_cpu():
    events = _run_cli(["match", "--device", "cpu", "--pattern-file", RTHK_TOML, RTHK])
    assert events == [
        {"type": "start", "source": RTHK},
        {"type": "pattern_detected", "clip_name": "rthk_beep", "timestamp_ms": 1408,
         "timestamp_formatted": "00:00:01.408"},
        {"type": "pattern_detected", "clip_name": "rthk_beep", "timestamp_ms": 2420,
         "timestamp_formatted": "00:00:02.420"},
        {"type": "end", "total_time_ms": 4078, "total_time_formatted": "00:00:04.078"},
    ]
    for fp in ("881_beep.apd.toml", "903_beep.apd.toml"):
        events = _run_cli(["match", "--device", "cpu", "--timestamp-format", "ms",
                           "--pattern-file", os.path.join(AUDIO, "clips", fp), RTHK])
        assert [e["type"] for e in events] == ["start", "end"]
        assert events[-1] == {"type": "end", "total_time_ms": 4078}


def test_cli_process_never_imports_jax():
    code = (
        "import sys\n"
        "from audio_pattern_detector_tpu_torch.cli import main\n"
        f"main(['match', '--device', 'cpu', '--pattern-file', {RTHK_TOML!r}, {RTHK!r}])\n"
        "print('JAX_IMPORTED', 'jax' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "JAX_IMPORTED False"
    assert [json.loads(x)["timestamp_ms"] for x in lines if '"pattern_detected"' in x] == [1408, 2420]


@pytest.mark.parametrize(
    "extra,flag,ends_as",
    [
        (["--mesh-time", "2"], "mesh needs 2 devices, only 1 available", ValueError),
        (["--mesh-bank", "2"], "mesh_bank requires mesh_time", ValueError),
        (["--mesh-stream", "2"], "--mesh-stream parallelises across MULTIPLE audio files",
         SystemExit),
    ],
)
def test_cli_rejects_what_is_not_ported(extra, flag, ends_as, capsys, monkeypatch):
    """The mesh flags are ported; what is still rejected, with the JAX
    package's messages and each as the JAX CLI ends it: a mesh larger than
    the visible devices (here one CPU device and no logical shards) and a
    bank axis without a time axis leave ``match`` as the ValueError (a
    traceback and a non-zero exit for the process), a stream mesh over a
    single file is a usage error: ``Error: ...`` on stderr and exit 1."""
    monkeypatch.delenv("APD_TORCH_LOGICAL_DEVICES", raising=False)
    with pytest.raises(ends_as) as exc:
        cli.main(["match", "--device", "cpu", "--pattern-file", RTHK_TOML, RTHK, *extra])
    captured = capsys.readouterr()
    if ends_as is SystemExit:
        assert exc.value.code == 1 and f"Error: {flag}" in captured.err
    else:
        assert str(exc.value) == flag
    assert '"pattern_detected"' not in captured.out


def test_cli_serve_is_refused(capsys, monkeypatch):
    """``serve --mesh-stream`` runs on the port (tests/test_torch_mesh_surfaces.py);
    a mesh larger than the visible devices is a usage error: the JAX
    message on stderr and exit 1, before any device work."""
    monkeypatch.delenv("APD_TORCH_LOGICAL_DEVICES", raising=False)
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--device", "cpu", "--mesh-stream", "2", "--pattern-file", RTHK_TOML])
    assert exc.value.code == 1
    captured = capsys.readouterr()
    assert "Error: mesh needs 2 devices, only 1 available" in captured.err and not captured.out


def test_cli_cuda_without_a_card_raises_before_any_event(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["match", "--pattern-file", RTHK_TOML, RTHK])
    assert capsys.readouterr().out == ""


def test_cli_show_config(capsys):
    cli.main(["show-config", RTHK_TOML])
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["sample_rate"] == SR and "rthk_beep" in cfg["clips"]


def test_engine_options_keep_the_device_through_replace():
    opts = cli.TorchEngineOptions(height_min=0.3, device="cpu")
    out = _opts_for_source(opts, "x.mp3")
    assert type(out) is cli.TorchEngineOptions
    assert out.device == "cpu" and out.height_min is None
