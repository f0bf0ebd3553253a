"""The port stands alone, and its copies of the JAX package's host modules
compute what the originals compute.

* Static: no ``.py`` file of ``audio_pattern_detector_tpu_torch/``, nor
  ``chip_smoke.py``, imports jax or anything of ``audio_pattern_detector_tpu``.
* Run: a subprocess that refuses those imports (a ``sys.meta_path`` finder)
  imports every module of the port (``parallel/`` included), runs the RTHK
  golden flow through the port's CLI on the CPU, serially and on a time
  mesh of logical shards, and builds a ``PatternServer``.
* Differential: each copied host module against the JAX package's module on
  seeded inputs and on ``sample_audios/``. The code is the same numpy, so
  the results must be equal exactly (arrays bit for bit).
* Shared code: the functions and methods that the port's ``match.py``,
  ``serve.py``, ``models/multistream.py`` and ``parallel/sequence.py`` took
  over unchanged are the JAX modules' code, statement for statement (their
  syntax trees without docstrings, the package name apart); the mesh
  branches of ``EngineOptions.validate`` among them. The one statement the
  port adds at the head of ``MultiStreamSession.dispatch``, the lockstep
  of a round across processes, is held to be there and set aside.
  ``MultiStreamSession.collect`` is the port's own (it converts a row's
  times as soon as the row's results are final); run on the port's
  session, the JAX module's ``collect`` gives what it gives
  (tests/test_torch_collect_decode.py).
"""

import ast
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from audio_pattern_detector_tpu import match as jmatch
from audio_pattern_detector_tpu import native as jnative
from audio_pattern_detector_tpu.models import hostpath as jhostpath
from audio_pattern_detector_tpu.ops import hostref as jhostref
from audio_pattern_detector_tpu.ops import tone as jtone
from audio_pattern_detector_tpu.utils import audio_io as jaudio_io
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu.utils import pattern_config as jpattern_config
from audio_pattern_detector_tpu.utils import timefmt as jtimefmt
from audio_pattern_detector_tpu_torch import match as tmatch
from audio_pattern_detector_tpu_torch import native as tnative
from audio_pattern_detector_tpu_torch.models import hostpath as thostpath
from audio_pattern_detector_tpu_torch.ops import hostref as thostref
from audio_pattern_detector_tpu_torch.ops import tone as ttone
from audio_pattern_detector_tpu_torch.utils import audio_io as taudio_io
from audio_pattern_detector_tpu_torch.utils import clip as tclip
from audio_pattern_detector_tpu_torch.utils import pattern_config as tpattern_config
from audio_pattern_detector_tpu_torch.utils import timefmt as ttimefmt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "audio_pattern_detector_tpu_torch")
AUDIO = os.path.join(REPO, "sample_audios")
RTHK = os.path.join(AUDIO, "rthk_section_with_beep.wav")
RTHK_TOML = os.path.join(AUDIO, "clips", "rthk_beep.apd.toml")
SR = 8000


def _port_sources() -> list[str]:
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _refused(module: str) -> bool:
    return module.split(".")[0] in ("jax", "audio_pattern_detector_tpu")


@pytest.mark.parametrize("path", _port_sources())
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    tree = ast.parse(open(os.path.join(REPO, path), encoding="utf-8").read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _refused(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _refused(node.module):
                found.append(node.module)
    assert not found, f"{path} imports {found}"


RUN_ISOLATED = f"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "audio_pattern_detector_tpu"):
            raise ImportError(f"refused: {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
import audio_pattern_detector_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print("MODULES", len(names))
from audio_pattern_detector_tpu_torch.cli import main
main(["match", "--device", "cpu", "--timestamp-format", "ms", "--pattern-file", {RTHK_TOML!r},
      {RTHK!r}])
import os
os.environ["APD_TORCH_LOGICAL_DEVICES"] = "2"
main(["match", "--device", "cpu", "--mesh-time", "2", "--timestamp-format", "ms",
      "--pattern-file", {RTHK_TOML!r}, {RTHK!r}])
from audio_pattern_detector_tpu_torch.match import _load_pattern_clips
from audio_pattern_detector_tpu_torch.serve import PatternServer
server = PatternServer(_load_pattern_clips([{RTHK_TOML!r}], 8000), port=0, max_streams=2,
                       device="cpu")
print("SERVER", server.address[1] > 0, server.session.n_streams)
server._teardown()
print("REFUSED_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "audio_pattern_detector_tpu")))
"""


def test_port_runs_with_jax_and_the_jax_package_refused():
    proc = subprocess.run(
        [sys.executable, "-c", RUN_ISOLATED], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert int(lines[0].split()[1]) >= 30
    assert "audio_pattern_detector_tpu_torch/parallel/sequence.py" in _port_sources()
    assert [x for x in lines if x.startswith("{")] == [
        '{"type": "start", "source": "%s"}' % RTHK,
        '{"type": "pattern_detected", "clip_name": "rthk_beep", "timestamp_ms": 1408}',
        '{"type": "pattern_detected", "clip_name": "rthk_beep", "timestamp_ms": 2420}',
        '{"type": "end", "total_time_ms": 4078}',
    ] * 2  # the serial run, then the same file on a 2-shard time mesh
    assert lines[-2:] == ["SERVER True 2", "REFUSED_LOADED []"]


# ── Shared code ──


# Statements the port adds at the head of a shared function, each held to
# be there and then set aside: the agreement on a round between the
# processes of a group, which JAX gets from its global program.
PORT_HEADS = {"MultiStreamSession.dispatch": "self._lockstep(chunks)"}


def _drop_port_head(name: str, node: ast.FunctionDef) -> None:
    body = node.body
    first = 1 if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                  and isinstance(body[0].value.value, str)) else 0
    assert ast.unparse(body[first]) == PORT_HEADS[name], f"{name}: no {PORT_HEADS[name]!r} at its head"
    del body[first]


# Statements each side adds to a shared function for its own timing, each
# held to be there (once) and then set aside, or put back as the other side
# has it: the port's span recorder (utils/profiling.py) with the round id
# that a session's handle carries, and the JAX server's ``phase_seconds``
# clock readings, which the port's spans replace.
PORT_INSTRUMENTATION = {
    "MultiStreamSession.dispatch": [
        ("rid = span = -1", None),
        ("if RECORDER.on:\n    rid = RECORDER.next_round()\n"
         "    span = RECORDER.open('session.dispatch', round=rid, a=len(chunks), b=self._rounds)", None),
        ("if span >= 0:\n    RECORDER.close(span)", None),
        ("return (dispatched, meta, active, rid)", "return (dispatched, meta, active)"),
    ],
    "PatternServer._dispatch_round": [
        ("span = RECORDER.open('serve.take') if RECORDER.on else -1", None),
        ("if span >= 0:\n    RECORDER.close(span)", None),
    ],
}
JAX_INSTRUMENTATION = {
    "PatternServer._dispatch_round": [
        ("t_take = time.monotonic()", None),
        ("t_disp = time.monotonic()", None),
        ("self.phase_seconds['take'] = self.phase_seconds.get('take', 0.0) + t_disp - t_take", None),
        ("self.phase_seconds['enqueue'] = self.phase_seconds.get('enqueue', 0.0) + time.monotonic() - t_disp",
         None),
    ],
}


def _set_aside(name: str, node: ast.FunctionDef, table: dict) -> None:
    """Drop (or replace) each of ``table[name]``'s statements in ``node``,
    asserting that each is there exactly once."""
    for text, replacement in table.get(name, ()):
        hits = [(stmts, i) for n in ast.walk(node)
                for stmts in (getattr(n, f, None) for f in ("body", "orelse", "finalbody"))
                if isinstance(stmts, list)
                for i, stmt in enumerate(stmts) if ast.unparse(stmt) == text]
        assert len(hits) == 1, f"{name}: {text!r} found {len(hits)} times"
        stmts, i = hits[0]
        stmts[i:i + 1] = [] if replacement is None else ast.parse(replacement).body


def _definitions(path: str, rename: bool) -> dict[str, str]:
    """name -> dump of the syntax tree, docstrings dropped, of every
    top-level function and every method of ``path``, each side's
    instrumentation set aside; with ``rename`` (the port's side) the
    ``PORT_HEADS`` statements set aside too."""
    src = open(os.path.join(REPO, path), encoding="utf-8").read()
    if rename:
        src = (src.replace("audio_pattern_detector_tpu_torch", "audio_pattern_detector_tpu")
               .replace("TorchEngineOptions", "EngineOptions")
               .replace("TorchAudioPatternDetector", "AudioPatternDetector"))

    def dump(node: ast.AST) -> str:
        for n in ast.walk(node):
            body = getattr(n, "body", None)
            if (isinstance(n, (ast.FunctionDef, ast.ClassDef)) and body
                    and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                n.body = body[1:] or [ast.Pass()]
        return ast.dump(node)

    table = PORT_INSTRUMENTATION if rename else JAX_INSTRUMENTATION
    out = {}
    for node in ast.parse(src, path).body:
        if isinstance(node, ast.FunctionDef):
            _set_aside(node.name, node, table)
            out[node.name] = dump(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    name = f"{node.name}.{sub.name}"
                    _set_aside(name, sub, table)
                    if rename and name in PORT_HEADS:
                        _drop_port_head(name, sub)
                    out[name] = dump(sub)
    return out


SHARED = {
    "match.py": [
        "EngineOptions.validate", "_emit_jsonl", "_read_uint32",
        "_read_patterns_from_multiplexed_stdin", "_seek_riff_chunk", "_validate_wav_header",
        "_decode_samples", "_WavStdinStreamWrapper.__init__", "_WavStdinStreamWrapper.read",
        "_WavFileStreamWrapper.__init__", "_WavFileStreamWrapper._validate_first_chunk",
        "_WavFileStreamWrapper.read", "_WavFileStreamWrapper.close", "_load_checkpoint_file",
        "_skip_stream_samples", "_checkpoint_writer", "_drain_stream", "_read_full",
        "_probe_duration_seconds", "_auto_perf_chunk_seconds", "_auto_perf_plan",
        "_load_pattern_clips", "_opts_for_source", "_match_pattern_file",
        "_match_pattern_wav_stdin", "_match_pattern_multiplexed_stdin", "_make_jsonl_callback",
        "_emit_jsonl_end", "_parse_chunk_seconds", "_int_or", "_collect_pattern_files",
    ],
    "serve.py": [
        "_ExactReader.read", "PatternServer.shutdown", "PatternServer._service_sockets",
        "PatternServer._accept", "PatternServer._ingest", "PatternServer._try_parse_header",
        "PatternServer._take_chunk", "PatternServer._dispatch_round",
        "PatternServer._collect_ready", "PatternServer._finish_streams", "PatternServer._emit",
        "PatternServer._flush", "PatternServer._release", "PatternServer._teardown",
    ],
    "models/multistream.py": [
        "MultiStreamSession.feed", "MultiStreamSession.dispatch", "MultiStreamSession.total_time",
        "MultiStreamSession.reset",
    ],
    "parallel/sequence.py": [
        "ShardedDetector.session", "ShardedDetector.detect", "_device_section",
        "detections_from_sharded",
    ],
}


@pytest.mark.parametrize("module", sorted(SHARED))
def test_shared_functions_are_the_jax_modules_code(module):
    theirs = _definitions(os.path.join("audio_pattern_detector_tpu", module), rename=False)
    ours = _definitions(os.path.join("audio_pattern_detector_tpu_torch", module), rename=True)
    for name in SHARED[module]:
        assert name in theirs and name in ours, name
        assert ours[name] == theirs[name], f"{module}: {name} differs from the JAX module's"


# ── Differential cases ──


def _same(a, b, where="result"):
    """Exact equality, arrays bit for bit (dtype and shape too)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


def _signal(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


def _tone(freq, seconds, amp=0.8):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


HOSTREF = {
    "find_peaks": lambda m: m.find_peaks(_signal(4000, 1), height=0.2, distance=7, prominence=0.1),
    "find_peaks_plain": lambda m: m.find_peaks(np.repeat(_signal(500, 2), 3)),
    "resample": lambda m: m.resample(_signal(8000, 3), 5513),
    "resample_preserve_maxima": lambda m: m.resample_preserve_maxima(np.abs(_signal(6001, 4)), 997),
    "simpson": lambda m: m.simpson(np.abs(_signal(1001, 5)).astype(np.float64)),
    "integrated_loudness": lambda m: m.integrated_loudness(_signal(3 * SR, 6), SR),
    "loudness_normalize": lambda m: m.loudness_normalize(_signal(SR, 7), -23.5, -16.0),
    "pearson_correlation": lambda m: m.pearson_correlation(_signal(777, 8), _signal(777, 9)),
    "fft_correlate_1d": lambda m: m.fft_correlate_1d(_signal(5000, 10), _signal(800, 11), mode="full"),
    "k_weighting_fir": lambda m: m.k_weighting_fir(SR),
}


@pytest.mark.parametrize("case", sorted(HOSTREF))
def test_hostref_equals_the_jax_module(case):
    _same(HOSTREF[case](thostref), HOSTREF[case](jhostref), case)


TONE = {
    "pure_tone": lambda m: m.get_pure_tone_frequency(_tone(941.0, 0.25), SR),
    "noise": lambda m: m.get_pure_tone_frequency(_signal(SR // 4, 12), SR),
    "frame_grid": lambda m: m.frame_grid(2000, SR),
    "analyze_tone": lambda m: m.analyze_pure_tone_candidate(
        _tone(1040.0, 0.3) + 0.05 * _signal(int(0.3 * SR), 13), SR, 1040.0
    ),
    "max_distance": lambda m: m.max_distance([0.1, 0.4, 0.45, 1.3]),
}


@pytest.mark.parametrize("case", sorted(TONE))
def test_tone_equals_the_jax_module(case):
    _same(TONE[case](ttone), TONE[case](jtone), case)


NATIVE = {
    "find_peaks": lambda m: m.find_peaks(_signal(4000, 21), height=0.1, distance=5, prominence=0.05),
    "resample_preserve_maxima": lambda m: m.resample_preserve_maxima(np.abs(_signal(5003, 22)), 401),
    "simpson": lambda m: m.simpson(np.abs(_signal(999, 23))),
    "integrated_loudness": lambda m: m.integrated_loudness(_signal(2 * SR, 24), SR),
    "loudness_normalize": lambda m: m.loudness_normalize(_signal(SR, 25), -20.0, -16.0),
    "pearson_correlation": lambda m: m.pearson_correlation(_signal(600, 26), _signal(600, 27)),
    "pcm16": lambda m: m.pcm16_to_f32_mono(
        (np.random.default_rng(28).integers(-32768, 32768, 3000)).astype(np.int16), channels=2
    ),
    "pcm32": lambda m: m.pcm32_to_f32_mono(
        (np.random.default_rng(29).integers(-2**31, 2**31, 3000)).astype(np.int32)
    ),
    "biquad": lambda m: m.biquad_f64(
        np.array([1.5, -2.7, 1.2]), np.array([1.0, -1.7, 0.73]), _signal(2000, 30).astype(np.float64)
    ),
}


@pytest.mark.parametrize("library", [True, False], ids=["with_library", "numpy"])
@pytest.mark.parametrize("case", sorted(NATIVE))
def test_native_equals_the_jax_module(case, library, monkeypatch):
    if library:
        if not (tnative.native_available() and jnative.native_available()):
            pytest.skip("the native host library could not be built here")
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    _same(NATIVE[case](tnative), NATIVE[case](jnative), case)


def test_native_builds_outside_the_jax_package():
    if not tnative.native_available():
        pytest.skip("g++ could not build the native host library here")
    path = tnative._so_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert os.path.commonpath([str(path), os.path.join(REPO, "audio_pattern_detector_tpu")]) != \
        os.path.join(REPO, "audio_pattern_detector_tpu")


def _section_with(clip, starts, seconds, seed):
    audio = 0.01 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
    for s in starts:
        o = int(s * SR)
        audio[o : o + len(clip)] += clip
    return audio.astype(np.float32)


def _host_case(clip, section, tone_frequency, height_min=0.25):
    def run(m):
        ref = jhostref if m is jhostpath else thostref
        loud = ref.integrated_loudness(clip, SR, block_size=0.4 if len(clip) >= SR // 2 else len(clip) / SR)
        c = ref.loudness_normalize(clip, loud, -16.0)
        corr = np.abs(ref.fft_correlate_1d(c, c, mode="full"))
        return m.process_section_host(
            audio_section=section, clip=c, correlation_clip=corr / corr.max(),
            correlation_clip_absolute_max=float(corr.max()), sr=SR, height_min=height_min,
            is_short_clip=len(clip) / SR < 0.5, tone_frequency=tone_frequency,
            verification_params={},
        )

    return run


_NORMAL = (0.5 * np.sin(2 * np.pi * 640.0 * np.arange(int(0.6 * SR)) / SR)
           * np.hanning(int(0.6 * SR))).astype(np.float32)
HOSTPATH = {
    "normal": _host_case(_NORMAL, _section_with(_NORMAL, (1.0, 4.3, 7.9), 10, 31), None),
    "normal_height_0": _host_case(_NORMAL, _section_with(_NORMAL, (2.0,), 6, 32), None, 0.0),
    "marker": _host_case(_tone(941.0, 0.25), _section_with(_tone(941.0, 0.25), (1.5, 5.0), 8, 33),
                         941.0),
}


@pytest.mark.parametrize("case", sorted(HOSTPATH))
def test_hostpath_process_section_host_equals_the_jax_module(case):
    got = HOSTPATH[case](thostpath)
    _same(got, HOSTPATH[case](jhostpath), case)
    if case != "normal_height_0":
        assert got  # the planted clips are found


WAVS = sorted(
    os.path.relpath(os.path.join(root, n), AUDIO)
    for root, _, names in os.walk(AUDIO) for n in names if n.endswith(".wav")
)


@pytest.mark.parametrize("wav", WAVS)
def test_audio_io_loaders_equal_the_jax_module(wav):
    path = os.path.join(AUDIO, wav)
    data, rate = taudio_io.load_wav_file(path)
    _same((data, rate), jaudio_io.load_wav_file(path), wav)
    _same(taudio_io.load_wave_file(path, rate), jaudio_io.load_wave_file(path, rate), wav)
    raw = open(path, "rb").read()
    _same(taudio_io.load_wav_from_bytes(raw, wav), jaudio_io.load_wav_from_bytes(raw, wav), wav)


TOMLS = sorted(
    os.path.relpath(os.path.join(root, n), AUDIO)
    for root, _, names in os.walk(AUDIO) for n in names if n.endswith(".apd.toml")
)


@pytest.mark.parametrize("toml", TOMLS)
def test_load_apd_file_equals_the_jax_module(toml):
    path = os.path.join(AUDIO, toml)
    _same(tpattern_config.load_apd_file(path, SR), jpattern_config.load_apd_file(path, SR), toml)
    _same(tclip.AudioClip.from_audio_file(path, sample_rate=SR),
          jclip.AudioClip.from_audio_file(path, sample_rate=SR), toml)


DURATIONS = [None, 0.5, 59.9, 60.0, 60.1, 119.0, 481.8, 540.0, 541.0, 3600.0, 7201.5]


@pytest.mark.parametrize("long_clip", [False, True], ids=["rthk", "with_35s_clip"])
def test_auto_perf_plan_equals_the_jax_module(long_clip, monkeypatch):
    tclips = [tclip.AudioClip.from_audio_file(RTHK_TOML, sample_rate=SR)]
    jclips = [jclip.AudioClip.from_audio_file(RTHK_TOML, sample_rate=SR)]
    if long_clip:
        audio = _signal(35 * SR, 40)
        tclips.append(tclip.AudioClip(name="long", audio=audio, sample_rate=SR))
        jclips.append(jclip.AudioClip(name="long", audio=audio, sample_rate=SR))
    for duration in DURATIONS:
        monkeypatch.setattr(tmatch, "_probe_duration_seconds", lambda _src, d=duration: d)
        monkeypatch.setattr(jmatch, "_probe_duration_seconds", lambda _src, d=duration: d)
        _same(tmatch._auto_perf_plan("x.wav", tclips, SR), jmatch._auto_perf_plan("x.wav", jclips, SR),
              f"plan at {duration}")
        _same(tmatch._auto_perf_chunk_seconds("x.wav", tclips, SR),
              jmatch._auto_perf_chunk_seconds("x.wav", jclips, SR), f"chunk at {duration}")


@pytest.mark.parametrize("decimals", [True, False])
def test_seconds_to_time_equals_the_jax_module(decimals):
    for s in [0.0, 0.0004, 0.0005, 1.408, 59.9995, 61.25, 3599.999, 3600.0, 86399.5, 90061.123]:
        _same(ttimefmt.seconds_to_time(s, include_decimals=decimals),
              jtimefmt.seconds_to_time(s, include_decimals=decimals), str(s))
