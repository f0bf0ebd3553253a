"""The port's ``parallel/sequence.py`` against the JAX ``ShardedDetector``
and against the port's own serial engine.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port runs on logical shards of the one CPU device (``make_mesh(...,
devices=["cpu"] * N)``) with the plain version of the candidate scan.
Inputs are the JAX tests' own fixtures (``tests/test_parallel.py``): 1 s
seeded-noise clips and a quarter-second tone at 8 kHz, chunks of 4 to 20 s,
and one section of the golden corpus.

Each case is held (i) to the JAX sharded detector: identical timestamp
lists per clip per stream; (ii) to the port's serial engine: identical
timestamps, and every cell's payload bit-equal to the payload the serial
class step gives for that cell's section. No tolerance: payloads hold
integer-valued fields and timestamps come from them by the same float64
algebra.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu import AudioPatternDetector as JaxDetector
from audio_pattern_detector_tpu.models import hostpath as jhostpath
from audio_pattern_detector_tpu.parallel import ShardedDetector as JaxShardedDetector
from audio_pattern_detector_tpu.parallel import make_mesh as jax_make_mesh
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import AudioClip, AudioPatternDetector, AudioStream
from audio_pattern_detector_tpu_torch.models import hostpath as thostpath
from audio_pattern_detector_tpu_torch.models.bank import _split_fused
from audio_pattern_detector_tpu_torch.ops.packing import as_f32, upload_rows
from audio_pattern_detector_tpu_torch.parallel import (
    ShardedDetector,
    ShardedStreamSession,
    detections_from_sharded,
    make_mesh,
)
from audio_pattern_detector_tpu_torch.parallel import sequence as tsequence
from audio_pattern_detector_tpu_torch.parallel.sequence import _device_section
from audio_pattern_detector_tpu_torch.utils.audio_io import load_wave_file

torch.set_num_threads(1)

SR = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")


def make_clip(name="c", seed=42):
    rng = np.random.default_rng(seed)
    return AudioClip(
        name=name, audio=(0.4 * rng.standard_normal(SR)).astype(np.float32), sample_rate=SR
    )


def make_marker(name="beep", freq=1000.0):
    t = np.arange(SR // 4) / SR
    return AudioClip(
        name=name, audio=np.sin(2 * np.pi * freq * t).astype(np.float32), sample_rate=SR,
        strategy="marker_tone", strategy_params={"dominant_frequency_hz": freq},
    )


def make_audio(clip, offsets, total_seconds, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    audio = (0.01 * rng.standard_normal(int(total_seconds * SR))).astype(np.float32)
    for off in offsets:
        o = int(off * SR)
        audio[o : o + len(clip.audio)] += scale * clip.audio
    return audio


def _jax_clips(clips):
    return [jclip.AudioClip(**dataclasses.asdict(c)) for c in clips]


def logical_mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def serial_times(clips, audio, chunk_s):
    det = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=chunk_s)
    res, _ = det.find_clip_in_audio(
        AudioStream(name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR)
    )
    return res


# ── The cases: (clips, (B, T) audio, mesh axes, chunk seconds) ──


def _case_time4():
    clip = make_clip()
    return [clip], make_audio(clip, [3.0, 19.5, 21.25, 33.0], 40)[None], {"time": 4}, 5


def _case_time8():
    clip = make_clip()
    return [clip], make_audio(clip, [3.0, 25.5, 47.25, 69.0], 80)[None], {"time": 8}, 10


def _case_stream_time():
    clip = make_clip()
    a0 = make_audio(clip, [3.0, 47.25], 80, seed=1)
    a1 = make_audio(clip, [15.5, 62.0], 80, seed=2)
    return [clip], np.stack([a0, a1]), {"stream": 2, "time": 2}, 20


def _case_bank_time():
    """Three normal clips (a group of 3 over 2 bank shards pads to 4) and a
    marker tone (a group of 1 pads to 2); 24 s in slabs of 2 x 4 s."""
    clips = [make_clip("n0", 42), make_clip("n1", 43), make_clip("n2", 44), make_marker()]
    audio = make_audio(clips[0], [1.5, 13.0], 24, seed=5)
    audio[6 * SR : 7 * SR] += clips[2].audio
    for off in (3.0, 9.5, 17.25):
        o = int(off * SR)
        audio[o : o + SR // 4] += 0.7 * clips[3].audio
    return clips, audio[None], {"bank": 2, "time": 2}, 4


def _case_short_final_slab():
    """27 s on a 4 x 5 s mesh: slab 1 full, slab 2 is 7 s: one full chunk,
    a 2 s short chunk and two time shards that own nothing."""
    clip = make_clip()
    return [clip], make_audio(clip, [3.0, 21.0, 25.5], 27)[None], {"time": 4}, 5


def _case_corpus_rthk():
    clips = [
        AudioClip.from_audio_file(os.path.join(AUDIO, "clips", rel), SR)
        for rel in ("rthk_beep.apd.toml", "cbs_news.wav", "天空下的彩虹intro.wav")
    ]
    audio = load_wave_file(os.path.join(AUDIO, "rthk_section_with_beep.wav"), SR)
    return clips, audio.astype(np.float32)[None], {"time": 4}, 8


CASES = {
    "time4": _case_time4, "time8": _case_time8, "stream2_time2": _case_stream_time,
    "bank2_time2": _case_bank_time, "short_final_slab": _case_short_final_slab,
    "corpus_rthk": _case_corpus_rthk,
}
_RUNS: dict = {}


def run_case(name):
    """The case through the port's sharded detector, slab by slab: its
    timestamps, and for every active cell the sharded payload beside the
    serial class step's payload of that cell's exact section."""
    if name in _RUNS:
        return _RUNS[name]
    clips, audio, axes, chunk_s = CASES[name]()
    sd = ShardedDetector(clips, logical_mesh(axes), chunk_seconds=chunk_s, device="cpu")
    bank = sd.bank
    sess = sd.session()
    B = audio.shape[0]
    times = {c.name: [[] for _ in range(B)] for c in clips}
    cells = []  # (slab, sw, b, d, sharded per-group payloads, serial per-group payloads)
    for si, start in enumerate(range(0, audio.shape[1], sd.slab_samples)):
        slab = audio[:, start : start + sd.slab_samples]
        has_prev = sess._carry is not None
        carry = None if not has_prev else sess._carry.copy()
        part = sess.feed(slab)
        for n, per_stream in part.items():
            for b in range(B):
                times[n][b].extend(per_stream[b])
        owned = np.clip(slab.shape[1] - np.arange(sd.time_size) * sd.chunk_samples,
                        0, sd.chunk_samples)
        for sw, cls in bank.classes.items():
            halo = sw * SR
            prev_tail = carry[:, -halo:] if has_prev else np.zeros((B, halo), np.float32)
            for b in range(B):
                for d in np.flatnonzero(owned):
                    raw = _device_section(slab, prev_tail, b, int(d), sd.chunk_samples, halo,
                                          int(owned[d]), has_prev)
                    rows = upload_rows(bank._section_rows(cls["section_len"], [raw]), bank.device)
                    flat = bank.step(sw, as_f32(rows[0]), len(raw)).numpy()
                    serial = _split_fused(flat, cls["groups"])
                    sharded = [p[b, d, : len(g.names)] for p, g in
                               zip(sess.last_payloads[sw], cls["groups"])]
                    cells.append((si, sw, b, int(d), sharded, serial))
    for per in times.values():
        for ts in per:
            ts.sort()
    _RUNS[name] = (clips, audio, axes, chunk_s, times, cells)
    return _RUNS[name]


@pytest.mark.parametrize("case", sorted(CASES))
def test_timestamps_equal_the_jax_sharded_detector(case):
    clips, audio, axes, chunk_s, times, _ = run_case(case)
    jsd = JaxShardedDetector(_jax_clips(clips), jax_make_mesh(axes), chunk_seconds=chunk_s)
    want = jsd.detect(audio)
    assert times == want
    assert any(ts for per in times.values() for ts in per)


@pytest.mark.parametrize("case", sorted(CASES))
def test_timestamps_equal_the_ports_serial_engine(case):
    clips, audio, _, chunk_s, times, _ = run_case(case)
    for b in range(audio.shape[0]):
        assert detections_from_sharded(times, b) == serial_times(clips, audio[b], chunk_s)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_cell_payload_is_bit_equal_to_the_serial_sections(case):
    cells = run_case(case)[5]
    assert cells
    for slab, sw, b, d, sharded, serial in cells:
        for gi, (got, want) in enumerate(zip(sharded, serial)):
            assert got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (
                f"slab {slab} class {sw} stream {b} time shard {d} group {gi}")


def test_indivisible_groups_are_padded_and_sliced_back():
    clips, _, axes, chunk_s, times, cells = run_case("bank2_time2")
    sd = ShardedDetector(clips, logical_mesh(axes), chunk_seconds=chunk_s, device="cpu")
    rows = [c.self_corr_max.shape[0] for c, _ in sd._class_consts[1]]
    assert sorted(rows) == [2, 4]  # groups of 1 and 3 clips over 2 shards
    assert times["n0"][0] and times["n2"][0] and times["beep"][0]


# ── Slab streaming ──


def test_two_slabs_through_feed_equal_serial_and_jax():
    clips, audio, axes, chunk_s = _case_time4()
    sess = ShardedDetector(clips, logical_mesh(axes), chunk_seconds=chunk_s, device="cpu").session()
    assert isinstance(sess, ShardedStreamSession)
    r1 = sess.feed(audio[:, : 20 * SR])
    r2 = sess.feed(audio[:, 20 * SR :])
    jsess = JaxShardedDetector(_jax_clips(clips), jax_make_mesh(axes), chunk_seconds=chunk_s).session()
    j1 = jsess.feed(audio[:, : 20 * SR])
    j2 = jsess.feed(audio[:, 20 * SR :])
    assert (r1, r2) == (j1, j2)
    assert sorted(r1["c"][0] + r2["c"][0]) == serial_times(clips, audio[0], chunk_s)["c"]
    assert r1["c"][0] and r2["c"][0]


def _error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_feed_contract_errors_equal_jax():
    clip = make_clip()

    def attempts(sd_cls, clips, mesh):
        sd = sd_cls(clips, mesh, chunk_seconds=5)
        short = sd.session()
        short.feed(np.zeros((1, 7 * SR), np.float32))
        batch = sd.session()
        batch.feed(np.zeros((1, 20 * SR), np.float32))
        return [
            _error(lambda: short.feed(np.zeros((1, 20 * SR), np.float32))),
            _error(lambda: batch.feed(np.zeros((2, 20 * SR), np.float32))),
            _error(lambda: sd.session().feed(np.zeros((1, 21 * SR), np.float32))),
            _error(lambda: sd.detect(np.zeros((1, 0), np.float32))),
        ]

    got = attempts(lambda c, m, **kw: ShardedDetector(c, m, device="cpu", **kw), [clip],
                   logical_mesh({"time": 4}))
    want = attempts(JaxShardedDetector, _jax_clips([clip]), jax_make_mesh({"time": 4}))
    assert got == want
    assert "finished" in got[0] and "positive" in got[3]


def test_constructor_errors_equal_jax():
    clip = make_clip()
    jclips = _jax_clips([clip])
    # 8 time shards x 2^28 s x 8 kHz is far past 2^31 samples a slab.
    got = _error(lambda: ShardedDetector([clip], logical_mesh({"time": 8}),
                                         chunk_seconds=2**28, device="cpu"))
    assert got == _error(lambda: JaxShardedDetector(jclips, jax_make_mesh({"time": 8}),
                                                    chunk_seconds=2**28))
    assert "int32" in got
    got = _error(lambda: ShardedDetector([clip], logical_mesh({"stream": 2}),
                                         chunk_seconds=5, device="cpu"))
    assert got == _error(lambda: JaxShardedDetector(jclips, jax_make_mesh({"stream": 2}),
                                                    chunk_seconds=5))
    det = AudioPatternDetector([clip], device="cpu", seconds_per_chunk=6)
    jdet = JaxDetector(jclips, seconds_per_chunk=6)
    got = _error(lambda: ShardedDetector([clip], logical_mesh({"time": 2}), chunk_seconds=5,
                                         detector=det))
    assert got == _error(lambda: JaxShardedDetector(jclips, jax_make_mesh({"time": 2}),
                                                    chunk_seconds=5, detector=jdet))


def test_sample_counts_past_2_24_reach_the_cells_exactly(monkeypatch):
    """A slab of 2^24 + 1 samples on 8 time shards of 300 s: every cell gets
    its valid length as an int32 tensor holding the exact count (the JAX
    module splits the slab's count into two f32 halves for its transfer; an
    int32 tensor needs no split)."""
    clip = make_clip()
    sd = ShardedDetector([clip], logical_mesh({"time": 8}), chunk_seconds=300, device="cpu")
    t_actual = 2**24 + 1
    seen = []

    def recording_step(sw, section, lens, consts, scan=None):
        seen.append((section.shape, lens.clone()))
        width = sum(c.self_corr_max.shape[0] * (2 * kv + 2)
                    for (c, _), (_, _, _, kv) in zip(consts[1], sd.bank._metas[sw]))
        return torch.zeros((section.shape[0], width))

    monkeypatch.setattr(sd.bank, "step", recording_step)
    out = sd.session().feed(np.zeros((1, t_actual), np.float32))
    assert out == {"c": [[]]}
    chunk = 300 * SR
    owned = [min(chunk, t_actual - d * chunk) for d in range(8) if t_actual - d * chunk > 0]
    assert sum(owned) == t_actual and len(seen) == len(owned) == 7
    for d, (shape, lens) in enumerate(seen):
        assert shape == (1, chunk + SR) and lens.dtype == torch.int32
        assert lens.tolist() == [owned[d] + (SR if d else 0)]


# ── Flagged cells ──


def test_overflowing_cell_reroutes_to_the_host_path(monkeypatch):
    """Verify-tier overflow on a (stream, device, clip) cell re-runs that
    cell's exact section on the host path, in the port as in JAX; the
    sharded scan stays equal to the serial engine."""
    rng = np.random.default_rng(0)
    clip = make_clip()
    audio = (0.01 * rng.standard_normal(20 * SR)).astype(np.float32)
    for k in range(24):
        o = int((0.2 + 0.75 * k) * SR)
        audio[o : o + SR] += clip.audio[: min(SR, 20 * SR - o)]

    def shrink(bank):
        # Shrink the verify tier below the survivor count so it overflows.
        g = bank.classes[1]["groups"][0]
        g.k_detect, g.k_verify = 8, 2
        bank._metas[1] = (("normal", g.clip_len, 8, 2),)

    def spy_on(module):
        calls, original = [], module.process_section_host

        def spy(*args, **kwargs):
            calls.append(1)
            return original(*args, **kwargs)

        monkeypatch.setattr(module, "process_section_host", spy)
        return calls

    sd = ShardedDetector([clip], logical_mesh({"time": 4}), chunk_seconds=5, device="cpu")
    shrink(sd.bank)
    calls = spy_on(thostpath)
    got = detections_from_sharded(sd.detect(audio))
    assert calls, "sharded overflow did not reroute to the host path"

    jsd = JaxShardedDetector(_jax_clips([clip]), jax_make_mesh({"time": 4}), chunk_seconds=5)
    shrink(jsd.bank)
    jcalls = spy_on(jhostpath)
    want = detections_from_sharded(jsd.detect(audio))
    assert jcalls
    assert got == want

    det = AudioPatternDetector([clip], device="cpu", seconds_per_chunk=5)
    serial, _ = det.find_clip_in_audio(
        AudioStream(name="s", audio_stream=io.BytesIO(audio.tobytes()), sample_rate=SR)
    )
    assert got["c"] == serial["c"] and len(got["c"]) >= 10


def test_dense_cell_takes_the_device_rerun_not_the_host_path():
    """18 copies inside time shard 1's chunk flood the 16 lean lanes there
    (flag 2): the cell re-derives through the wide tier on the device."""
    rng = np.random.default_rng(11)
    clip = AudioClip(name="c", audio=(0.4 * rng.standard_normal(SR)).astype(np.float32),
                     sample_rate=SR)
    chunk_s = 20
    audio = (0.004 * rng.standard_normal(4 * chunk_s * SR)).astype(np.float32)
    for k in range(18):
        o = int((chunk_s + 0.3 + 1.05 * k) * SR)
        audio[o : o + SR] += clip.audio
    o = int((3 * chunk_s + 5.0) * SR)
    audio[o : o + SR] += clip.audio
    sd = ShardedDetector([clip], logical_mesh({"time": 4}), chunk_seconds=chunk_s, device="cpu")
    got = detections_from_sharded(sd.detect(audio[None]))
    assert got["c"] == serial_times([clip], audio, chunk_s)["c"] and len(got["c"]) >= 19
    assert sd.bank.row_reruns + sd.bank.class_reruns >= 1 and sd.bank.host_path_rows == 0
    jsd = JaxShardedDetector(_jax_clips([clip]), jax_make_mesh({"time": 4}), chunk_seconds=chunk_s)
    assert got == detections_from_sharded(jsd.detect(audio[None]))


# ── Devices ──


def test_every_cell_steps_under_its_devices_guard(monkeypatch):
    """Each cell's class step (and its payload's copy back) is enqueued
    inside ``device_guard(<the cell's device>)``: a raw kernel launch goes
    to the process's current device, so the guard is what sends a cell's
    launch to the cell's card."""
    clips, audio, axes, chunk_s = _case_bank_time()
    mesh = logical_mesh(axes)
    sd = ShardedDetector(clips, mesh, chunk_seconds=chunk_s, device="cpu")
    current, steps = [], []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    step = sd.bank.step

    def guarded_step(sw, section, *args, **kwargs):
        steps.append((section.device, current[-1] if current else None))
        return step(sw, section, *args, **kwargs)

    monkeypatch.setattr(tsequence, "device_guard", Guard)
    monkeypatch.setattr(sd.bank, "step", guarded_step)
    sd.session().feed(audio[:, : sd.slab_samples])
    cells = mesh.devices.size * len(sd.bank.classes)
    assert len(steps) == cells and not current
    assert all(guard is not None and guard == dev for dev, guard in steps)


def test_make_mesh_defaults_and_errors(monkeypatch):
    from audio_pattern_detector_tpu_torch.parallel import mesh as tmesh

    monkeypatch.delenv(tmesh.LOGICAL_DEVICES_ENV, raising=False)
    # The default is the card: with none, the mesh raises and never lands
    # on the CPU on its own.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_mesh, lambda: make_mesh({"time": 2}), tmesh.default_devices):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available\\(\\) is False"):
            build()
    one = make_mesh(device="cpu")
    assert one.axis_names == ("time",) and one.shape == {"time": 1}
    assert one.devices.tolist() == [torch.device("cpu")]
    got = _error(lambda: make_mesh({"time": 64}, device="cpu"))
    assert got == "mesh needs 64 devices, only 1 available"
    assert got == _error(lambda: jax_make_mesh({"time": 64})).replace("only 8", "only 1")
    monkeypatch.setenv(tmesh.LOGICAL_DEVICES_ENV, "4")
    grid = make_mesh({"bank": 2, "time": 2}, device="cpu")
    assert grid.shape == {"bank": 2, "time": 2} and grid.devices.shape == (2, 2)
    assert grid.device_at(bank=1, time=1, stream=0) == torch.device("cpu")
    assert make_mesh(device="cpu").shape == {"time": 4}
    # An explicit device list is taken as it is.
    assert make_mesh(devices=["cpu"] * 3).shape == {"time": 3}
    monkeypatch.setenv(tmesh.LOGICAL_DEVICES_ENV, "0")
    assert "must be >= 1" in _error(lambda: make_mesh(device="cpu"))
