"""The port's library surface: the twin of ``tests/test_detector_api.py``
on ``audio_pattern_detector_tpu_torch``'s exports.

The package exports what ``audio_pattern_detector_tpu`` exports, under the
same names. The engine contract (callback order, types and immediacy,
``accumulate_results``, ``get_config``) is checked on the port and, where
a case has a result to compare, held equal to the JAX detector's on the
same seeded input: timestamps come from integer positions by the same
float64 algebra, so they are compared exactly. Importing the package
builds and loads nothing; a copy of the package outside a checkout builds
its host library into a directory it may write.
"""

import dataclasses
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import audio_pattern_detector_tpu as jax_package
import audio_pattern_detector_tpu_torch as port
from audio_pattern_detector_tpu_torch import (
    DEFAULT_SECONDS_PER_CHUNK,
    AudioClip,
    AudioPatternDetector,
    AudioStream,
    MultiStreamSession,
    StreamCheckpoint,
    TorchAudioPatternDetector,
    __version__,
)

torch.set_num_threads(1)

SR = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = os.path.join(REPO, "sample_audios", "clips")


def make_clip(seconds=1.0, name="clip"):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    audio = (
        0.5 * np.sin(2 * np.pi * 523 * t) * np.sin(2 * np.pi * 3.0 * t)
        + 0.2 * np.sin(2 * np.pi * 880 * t)
    ).astype(np.float32)
    return AudioClip(name=name, audio=audio, sample_rate=SR)


def make_audio(clip, offsets, total_seconds, seed=0):
    rng = np.random.default_rng(seed)
    audio = (0.01 * rng.standard_normal(int(total_seconds * SR))).astype(np.float32)
    for off in offsets:
        o = int(off * SR)
        audio[o : o + len(clip.audio)] += clip.audio
    return audio


def stream_of(audio, cls=AudioStream):
    return cls(name="synth", audio_stream=io.BytesIO(audio.astype(np.float32).tobytes()),
               sample_rate=SR)


def detector(clips, **kw):
    return AudioPatternDetector(audio_clips=clips, device="cpu", **kw)


def jax_detector(clips, **kw):
    jclips = [jax_package.AudioClip(**dataclasses.asdict(c)) for c in clips]
    return jax_package.AudioPatternDetector(audio_clips=jclips, **kw)


# ── The exports ──


def test_exports_are_the_jax_packages():
    assert set(jax_package.__all__) <= set(port.__all__)
    assert set(port.__all__) - set(jax_package.__all__) == {"TorchAudioPatternDetector"}
    for name in jax_package.__all__:
        assert getattr(port, name) is not None, name
    assert AudioPatternDetector is TorchAudioPatternDetector
    assert __version__ == jax_package.__version__
    assert DEFAULT_SECONDS_PER_CHUNK == jax_package.DEFAULT_SECONDS_PER_CHUNK == 60
    assert port.SHORT_CLIP_DURATION_THRESHOLD == jax_package.SHORT_CLIP_DURATION_THRESHOLD
    assert port.MARKER_TONE_STRATEGY == jax_package.MARKER_TONE_STRATEGY
    assert port.PatternDetectedCallback == jax_package.PatternDetectedCallback
    assert MultiStreamSession.__module__ == "audio_pattern_detector_tpu_torch.models.multistream"
    assert port.PatternServer.__module__ == "audio_pattern_detector_tpu_torch.serve"
    with pytest.raises(AttributeError, match="has no attribute 'nothing_here'"):
        port.nothing_here


def test_importing_the_package_loads_no_kernel_and_touches_no_cuda():
    code = (
        "import sys\n"
        "from audio_pattern_detector_tpu_torch import (AudioPatternDetector, AudioClip,\n"
        "    MultiStreamSession, StreamCheckpoint, __version__)\n"
        "import torch\n"
        "from audio_pattern_detector_tpu_torch import native\n"
        "from audio_pattern_detector_tpu_torch.kernels import _build\n"
        "print('SERVE_LOADED', 'audio_pattern_detector_tpu_torch.serve' in sys.modules)\n"
        "print('NATIVE_LOADED', native._lib is not None, 'KERNELS_LOADED', _build._loaded is not None)\n"
        "print('CUDA_INITIALISED', torch.cuda.is_initialized())\n"
        "print('JAX_IMPORTED', 'jax' in sys.modules)\n"
        "from audio_pattern_detector_tpu_torch import PatternServer\n"
        "print('SERVER', PatternServer.__name__, 'audio_pattern_detector_tpu_torch.serve' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "SERVE_LOADED False", "NATIVE_LOADED False KERNELS_LOADED False",
        "CUDA_INITIALISED False", "JAX_IMPORTED False", "SERVER PatternServer True",
    ]


def test_a_copy_outside_a_checkout_builds_its_host_library_where_it_may_write(tmp_path):
    """A copy of the package with no ``pyproject.toml`` beside it (as in
    ``site-packages``) builds ``apd_native`` into the user's cache directory,
    not beside itself, and loads it."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler here")
    site = tmp_path / "site-packages"
    shutil.copytree(os.path.join(REPO, "audio_pattern_detector_tpu_torch"),
                    site / "audio_pattern_detector_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cache = tmp_path / "cache"
    code = (
        "import numpy as np\n"
        "from audio_pattern_detector_tpu_torch import native\n"
        "from audio_pattern_detector_tpu_torch.kernels import _build\n"
        "print(native.native_available())\n"
        "print(native._so_path())\n"
        "print(_build.BUILD_DIR)\n"
        "print(native.pcm16_to_f32_mono(np.array([16384, -32768], np.int16)).tolist())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600,
                          env={**env, "PYTHONPATH": str(site), "XDG_CACHE_HOME": str(cache)})
    assert proc.returncode == 0, proc.stderr
    available, so_path, kernel_dir, decoded = proc.stdout.splitlines()
    assert available == "True" and decoded == "[0.5, -1.0]"
    root = cache / "audio_pattern_detector_tpu_torch"
    assert os.path.dirname(so_path) == str(root / "apd_native") and os.path.isfile(so_path)
    assert kernel_dir == str(root / "apd_torch_kernels")
    assert not (tmp_path / "build").exists() and not (site / "build").exists()


def test_a_checkout_builds_into_its_own_build_directory():
    from audio_pattern_detector_tpu_torch import native
    from audio_pattern_detector_tpu_torch.kernels import _build

    assert _build.build_root() == _build._PKG_DIR.parent / "build"
    assert str(native.BUILD_DIR) == os.path.join(REPO, "build", "apd_native")
    assert str(_build.BUILD_DIR) == os.path.join(REPO, "build", "apd_torch_kernels")


def test_pyproject_names_the_console_script_and_the_sources():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    assert scripts["audio-pattern-detector-tpu-torch"] == "audio_pattern_detector_tpu_torch.cli:main"
    assert scripts["audio-pattern-detector-tpu"] == "audio_pattern_detector_tpu.cli:main"
    data = project["tool"]["setuptools"]["package-data"]["audio_pattern_detector_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cpp" in data
    from audio_pattern_detector_tpu_torch.cli import build_parser

    assert build_parser().prog == "audio-pattern-detector-tpu-torch"


def test_the_detector_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        AudioPatternDetector(audio_clips=[make_clip()])
    assert detector([make_clip()]).device == torch.device("cpu")


# ── The engine contract, against the JAX detector ──


RUNS = {
    "one_hit": (lambda: [make_clip()], [5.0], 70, {}),
    "four_chunks": (lambda: [make_clip()], [5.0, 30.0, 65.0, 100.0], 130, {}),
    "two_hits_30s_chunks": (lambda: [make_clip()], [5.0, 65.0], 130, {"seconds_per_chunk": 30}),
    "no_match": (lambda: [make_clip()], [], 70, {}),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_callbacks_and_results_equal_the_jax_detector(case):
    make, offsets, seconds, kw = RUNS[case]
    clips = make()
    audio = make_audio(clips[0], offsets, seconds, seed=3)
    events, jevents = [], []
    peaks, total = detector(clips, **kw).find_clip_in_audio(
        stream_of(audio), on_pattern_detected=lambda n, t: events.append((n, t)))
    jpeaks, jtotal = jax_detector(clips, **kw).find_clip_in_audio(
        stream_of(audio, jax_package.AudioStream),
        on_pattern_detected=lambda n, t: jevents.append((n, t)))
    assert (peaks, total) == (jpeaks, jtotal) and events == jevents
    assert len(events) == len(offsets) and total == float(seconds)
    assert all(isinstance(n, str) and isinstance(t, float) for n, t in events)
    assert [t for _, t in events] == sorted(t for _, t in events)
    # Callback values are the accumulated ones, not approximations of them.
    assert sorted(events) == sorted((n, t) for n, ts in peaks.items() for t in ts)
    assert set(peaks) == {"clip"}


def test_accumulate_false_returns_none_but_callbacks_fire():
    clip = make_clip()
    events = []
    peaks, total = detector([clip]).find_clip_in_audio(
        stream_of(make_audio(clip, [5.0], 70)),
        on_pattern_detected=lambda n, t: events.append(t), accumulate_results=False)
    assert peaks is None and len(events) == 1 and total == 70.0
    peaks, total = detector([clip]).find_clip_in_audio(
        stream_of(make_audio(clip, [], 70, seed=3)), accumulate_results=False)
    assert peaks is None and total == 70.0


def test_multi_clip_callbacks_sorted_within_chunk():
    a = make_clip(name="a")
    t = np.arange(SR) / SR
    b_audio = (0.5 * np.sin(2 * np.pi * 700 * t) * np.sin(2 * np.pi * 5.0 * t)).astype(np.float32)
    b = AudioClip(name="b", audio=b_audio, sample_rate=SR)
    audio = make_audio(a, [20.0], 70)
    audio[10 * SR : 11 * SR] += b_audio
    events = []
    detector([a, b]).find_clip_in_audio(
        stream_of(audio), on_pattern_detected=lambda nm, ts: events.append((ts, nm)))
    assert [e[1] for e in events] == ["b", "a"] == [e[1] for e in sorted(events)]


class CountingStream:
    """BytesIO wrapper counting read() calls, to pin streaming emission."""

    def __init__(self, audio):
        self._io = io.BytesIO(audio.astype(np.float32).tobytes())
        self.reads = 0

    def read(self, n=-1):
        self.reads += 1
        return self._io.read(n)


def test_events_fire_during_streaming_not_at_end():
    """A match in chunk 0 of a 4-chunk stream is emitted while the stream
    is still being consumed: by the read of chunk 1, not at the end."""
    clip = make_clip()
    raw = CountingStream(make_audio(clip, [5.0], 240))
    fired_at = []
    detector([clip], seconds_per_chunk=60).find_clip_in_audio(
        AudioStream(name="synth", audio_stream=raw, sample_rate=SR),
        on_pattern_detected=lambda n, t: fired_at.append(raw.reads))
    assert fired_at and fired_at[0] <= 2, f"emission deferred to read {fired_at}"


def test_oversize_chunk_message_equals_jax():
    t = np.arange(44100) / 44100
    clip = AudioClip(name="c", audio=(0.5 * np.sin(2 * np.pi * 523 * t)).astype(np.float32),
                     sample_rate=44100)
    kw = dict(seconds_per_chunk=400, target_sample_rate=44100)
    with pytest.raises(ValueError, match="float32 exactness") as got:
        detector([clip], **kw)
    with pytest.raises(ValueError) as want:
        jax_detector([clip], **kw)
    assert str(got.value) == str(want.value)
    assert detector([clip], seconds_per_chunk=370, target_sample_rate=44100).seconds_per_chunk == 370


CONFIGS = {
    "one_clip_auto_chunk": (lambda: [make_clip(2.5, "c1")], {"seconds_per_chunk": None}),
    "two_clips": (lambda: [make_clip(1.0, "a"), make_clip(4.2, "b")], {}),
    "three_clips": (lambda: [make_clip(0.3, "s"), make_clip(3.7, "l"), make_clip(1.9, "m")], {}),
    "chunk_30": (lambda: [make_clip(2.5)], {"seconds_per_chunk": 30}),
    "corpus": (lambda: [AudioClip.from_audio_file(os.path.join(CLIPS, rel)) for rel in
                        ("rthk_beep.apd.toml", "cbs_news.wav", "天空下的彩虹intro.wav")], {}),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_get_config_equals_the_jax_detector(case):
    make, kw = CONFIGS[case]
    clips = make()
    cfg = detector(clips, **kw).get_config()
    assert cfg == jax_detector(clips, **kw).get_config()
    assert cfg["default_seconds_per_chunk"] == DEFAULT_SECONDS_PER_CHUNK and cfg["sample_rate"] == SR
    assert set(cfg["clips"]) == {c.name for c in clips}
    assert cfg["min_chunk_size_seconds"] == max(
        2 * c["sliding_window_seconds"] for c in cfg["clips"].values())
    for c in cfg["clips"].values():
        assert isinstance(c["duration_seconds"], float)
        assert isinstance(c["sliding_window_seconds"], int)


def test_stream_checkpoint_round_trips_like_the_jax_class():
    tail = (0.1 * np.random.default_rng(0).standard_normal(SR)).astype(np.float32)
    ck = StreamCheckpoint(3, tail, 180.0)
    raw = ck.to_bytes()
    assert raw == jax_package.StreamCheckpoint(3, tail, 180.0).to_bytes()
    back = StreamCheckpoint.from_bytes(raw)
    assert (back.chunk_index, back.total_time) == (3, 180.0)
    assert np.array_equal(back.previous_tail, tail)
