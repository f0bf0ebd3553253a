"""The class-step variants behind the JAX package's switches, against the
JAX package with the same switch.

Op level:

* the marker DFT-GEMM (``_rfft_power_gemm``) against the JAX op within
  1e-5 of the spectrum's max power, and the marker verifier's accept bits
  with it on, exactly; the process's matmul precision comes back unchanged;
* ``greedy_survivors_blockwise`` (the mask tier's greedy) exactly, on
  seeded rows with tone combs, plateaus, ties and empty rows;
* the sequential lane greedy against the parallel one, exactly.

Bank level, one case per switch the port reads (``APD_PALLAS=0``,
``APD_MARKER_GEMM``), one with none, and one for each of
``APD_NO_OVERLAP_SAVE`` and ``APD_PACKED_UPLOAD=0``, which the port does not
read (its one form against the JAX package's other one): a round of
independent rows with hits, an idle row and a flooded row through the
port's and the JAX bank's vmap dispatch, and the golden corpus through both
serial engines. Payload rules: the port's mask tier is the
JAX package's CPU tier, so its payloads are equal bit for bit; the port's
kernel tier has a near-collapse flag (2) that the mask tier lacks, so
there every field but that flag is equal; under ``APD_NO_OVERLAP_SAVE`` the
JAX bank correlates in one FFT and the port in its segments, so only the
detections are compared. Detections are equal in every
case. JAX reads ``APD_MARKER_GEMM`` when it traces, so in that case its
side may be a program traced without it; the op-level test holds the
switch against the JAX op.

Each of the JAX package's switches the port does not read leaves the
port's captured step as it is: the same keys, payloads and nodes.

With no ``APD_*`` variable set (or ``APD_PALLAS=1``) every path of the port
runs the kernel tier (the plain scan on the CPU); ``APD_PALLAS=0`` runs
none of it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.match import _load_pattern_clips as jload_clips
from audio_pattern_detector_tpu.match import _WavFileStreamWrapper as JaxWavWrapper
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.ops import peaks as jpeaks
from audio_pattern_detector_tpu.ops import verify as jverify
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.match import _load_pattern_clips, _WavFileStreamWrapper
from audio_pattern_detector_tpu_torch.models import captured
from audio_pattern_detector_tpu_torch.models.bank import _split_fused, unpack_group
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.ops import candidate_scan as tscan
from audio_pattern_detector_tpu_torch.ops import lane_greedy as tlane
from audio_pattern_detector_tpu_torch.ops import peaks as tpeaks
from audio_pattern_detector_tpu_torch.ops import verify as tverify
from audio_pattern_detector_tpu_torch.ops import verify_marker as tverify_marker
from audio_pattern_detector_tpu_torch.ops.consts import consts_from_numpy
from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, ShardedDetector, make_mesh
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream
from tests.test_torch_capture import RecordingBackend

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")
CHUNK_S = 10
CHUNK = CHUNK_S * SR
GEMM_RTOL = 1e-5  # of the largest power in the spectrum
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")
GOLDEN_PATTERNS = [os.path.join(AUDIO, "clips", "rthk_beep.apd.toml"),
                   os.path.join(AUDIO, "clips", "cbs_news.wav")]
GOLDEN_FILES = [os.path.join(AUDIO, "rthk_section_with_beep.wav"),
                os.path.join(AUDIO, "cbs_news_audio_section.wav")]
SWITCHES = ("APD_PALLAS", "APD_BLOCK_LEAN", "APD_MERGED_IRFFT", "APD_NO_OVERLAP_SAVE",
            "APD_PACKED_UPLOAD", "APD_MARKER_GEMM", "APD_SEQ_GREEDY", "APD_SKIP_EMPTY_VERIFY",
            "APD_GREEDY_UNROLL")  # the JAX bank's


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    """Every test starts with none of the switches set, and leaves none."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(c):
    fields = {
        f.name: getattr(c, f.name) if f.metadata.get("static") else np.asarray(getattr(c, f.name))
        for f in dataclasses.fields(c)
    }
    return consts_from_numpy(type(c).__name__, fields, CPU)


# ── The marker DFT-GEMM ──


@pytest.mark.parametrize("shape", [(2, 3, 3, 2000), (2, 4, 17, 200)], ids=["whole", "frames"])
def test_rfft_power_gemm_within_tolerance(shape):
    x = (np.random.default_rng(shape[-1]).standard_normal(shape)).astype(np.float32)
    n = shape[-1]
    want = np.asarray(jverify._rfft_power_gemm(jnp.asarray(x), n))
    matmul = torch.backends.cuda.matmul
    allowed = matmul.allow_tf32
    matmul.allow_tf32 = True  # a process that allows TF32
    try:
        got = tverify_marker._rfft_power_gemm(_t(x), n).numpy()
        # The setting comes back, and the process-wide getter still reads it.
        assert matmul.allow_tf32 and torch.get_float32_matmul_precision() == "high"
    finally:
        matmul.allow_tf32 = allowed
    assert got.shape == want.shape == shape[:-1] + (n // 2 + 1,)
    scale = float(want.max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=GEMM_RTOL)
    exact = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
    np.testing.assert_allclose(got / scale, exact / scale, rtol=0, atol=GEMM_RTOL)


def test_marker_gemm_switch_and_verifier(monkeypatch):
    assert not tverify_marker._marker_gemm_enabled()
    monkeypatch.setenv("APD_MARKER_GEMM", "0")
    assert not tverify_marker._marker_gemm_enabled()
    m, freq = 2000, 941.0
    tone = np.sin(2 * np.pi * freq * np.arange(m) / SR).astype(np.float32)
    section = (0.01 * np.random.default_rng(2).standard_normal(4 * SR)).astype(np.float32)
    section[SR + 77 : SR + 77 + m] += 0.8 * tone
    hit = SR + 77 + m - 1
    rng = np.random.default_rng(9)
    pos = rng.integers(0, 4 * SR + m - 1, (2, 12)).astype(np.int32)
    pos[0, :3] = [hit, hit - 40, hit + 3]
    pos[1, 0] = hit
    alive = np.ones((2, 12), bool)
    jc = jverify.build_marker_verify_consts(m, SR, np.array([freq, 1040.0]), [{}, {}])
    fft = tverify.verify_marker(_t(section), _t(pos).long(), _t(alive), _carry(jc)).numpy()
    monkeypatch.setenv("APD_MARKER_GEMM", "1")
    assert tverify_marker._marker_gemm_enabled() and jverify._marker_gemm_enabled()
    calls = []
    gemm = tverify_marker._rfft_power_gemm
    monkeypatch.setattr(tverify_marker, "_rfft_power_gemm",  # where the marker spectra call it
                        lambda x, n: calls.append(n) or gemm(x, n))
    want = np.asarray(jverify.verify_marker(jnp.asarray(section), jnp.asarray(pos),
                                            jnp.asarray(alive), jc))
    got = tverify.verify_marker(_t(section), _t(pos).long(), _t(alive), _carry(jc)).numpy()
    assert sorted(set(calls)) == [200, m]  # the whole window and the 25 ms frames
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fft)
    assert got[0, 0] and not got[1, 0]


# ── The greedy variants ──


def _greedy_rows(l, seed):
    """Normalised rows (values in [0, 1]) with a tone comb, equal runs of
    length 2-5, ties on a coarse grid, an empty row and a zero row."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((6, l), np.float32)
    t = np.arange(l)
    comb = 0.5 + 0.5 * np.cos(2 * np.pi * t / 9.0) * np.exp(-(((t - l // 2) / (l / 6)) ** 2))
    rows[0] = (comb + 0.002 * rng.standard_normal(l)).clip(0, 1)
    rows[1] = np.round(rng.random(l) * 6) / 6  # ties and runs everywhere
    plateau = (0.3 * rng.random(l)).astype(np.float32)
    for start, run in ((400, 2), (900, 3), (1500, 4), (2100, 5), (l - 6, 3)):
        plateau[start : start + run] = 0.8
    rows[2] = plateau
    rows[3] = np.abs(rng.standard_normal(l)) / 4
    rows[3, 1000] = 1.0
    rows[4] = 0.0  # no candidate at all
    rows[5] = (0.2 * rng.random(l)).clip(0, 0.24)  # every candidate below the threshold
    valid = np.array([l, l - 37, l, l - 600, l, l], dtype=np.int32)
    for g, n in enumerate(valid):
        rows[g, n:] = 0.0
    return rows, valid


@pytest.mark.parametrize("l,m,r_max", [(3001, 40, 16), (5000, 300, 16), (2500, 9, 4)])
def test_greedy_survivor_variants_exact(l, m, r_max):
    """The mask tier's block-wise greedy against the JAX op, exactly."""
    hm = 0.25
    rows, valid = _greedy_rows(l, l)
    x = np.where(np.arange(l)[None, :] < valid[:, None], rows, -np.inf).astype(np.float32)
    xj = jnp.asarray(x)
    scored = np.asarray(jnp.where(jpeaks.short_run_local_maxima_mask(xj) & (xj >= hm), xj, -jnp.inf))
    want = jpeaks.greedy_survivors_blockwise(jnp.asarray(scored), m, r_max)
    got = tpeaks.greedy_survivors_blockwise(_t(scored), m, r_max)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32), np.asarray(want[1]).view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    kept = np.isfinite(got[1].numpy()).sum(axis=1)
    assert kept[0] > 0 and kept[4] == kept[5] == 0 and not got[2].numpy()[4:].any()


def _candidates(g, k, n_alive, l, seed):
    rng = np.random.default_rng(seed)
    pos = np.zeros((g, k), dtype=np.int32)
    height = np.full((g, k), -np.inf, dtype=np.float32)
    for gi in range(g):
        n = n_alive[gi]
        pos[gi] = rng.choice(l, size=k, replace=False)
        h = rng.choice(np.float32([0.3, 0.5, 0.7, 0.9]), n)
        order = np.lexsort((pos[gi, :n], -h))
        height[gi, :n] = h[order]
        pos[gi, :n] = pos[gi, :n][order]
    return pos, height, np.isfinite(height)


@pytest.mark.parametrize("k,n_alive,l,m", [(64, [40, 64, 0], 4000, 90), (1024, [700, 33], 50_000, 400)])
def test_sequential_greedy_equals_parallel(monkeypatch, k, n_alive, l, m):
    pos, height, alive = _candidates(len(n_alive), k, n_alive, l, seed=k)
    jc = jpeaks.PeakCandidates(jnp.asarray(pos), jnp.asarray(height), jnp.asarray(alive),
                               jnp.zeros(len(n_alive), dtype=bool))
    tc = tpeaks.PeakCandidates(_t(pos).long(), _t(height), _t(alive),
                               torch.zeros(len(n_alive), dtype=torch.bool))
    want = np.asarray(jpeaks._greedy_distance_parallel(jc, m))
    np.testing.assert_array_equal(np.asarray(jpeaks._greedy_distance_sequential(jc, m)), want)
    for form in (tlane._greedy_distance_parallel, tlane._greedy_distance_sequential):
        np.testing.assert_array_equal(form(tc.pos, tc.alive, m).numpy(), want)
    routes = []
    for name in ("_greedy_distance_sequential", "_greedy_distance_parallel"):
        fn = getattr(tlane, name)
        monkeypatch.setattr(tlane, name, lambda p, a, d, loop=None, fn=fn, name=name:
                            routes.append(name) or fn(p, a, d, loop))
    np.testing.assert_array_equal(tpeaks.greedy_distance_filter(tc, m).numpy(), want)
    assert routes == ["_greedy_distance_parallel"]  # k is within PARALLEL_GREEDY_MAX_K
    assert 0 < want.sum() < alive.sum()


# ── Bank level ──


def _clips():
    """A 0.6 s normal clip and a 941 Hz marker tone (tests/test_torch_vmap.py)."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tm = np.arange(int(0.25 * SR)) / SR
    marker = np.sin(2 * np.pi * 941.0 * tm).astype(np.float32)
    return [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(name="m", audio=marker, sample_rate=SR, strategy=MARKER_TONE_STRATEGY,
                  strategy_params={"dominant_frequency_hz": 941.0}),
    ]


def _audio(seed, seconds, normal=(), marker=(), flood_at=None):
    clip, tone = (c.audio for c in _clips())
    audio = 0.01 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
    starts = list(normal)
    if flood_at is not None:  # 18 copies 0.62 s apart: past the 16 lean lanes
        starts += [flood_at + 0.62 * k for k in range(18)]
    for s in starts:
        audio[int(s * SR) : int(s * SR) + len(clip)] += clip
    for s in marker:
        audio[int(s * SR) : int(s * SR) + len(tone)] += 0.8 * tone
    return audio


def _pcm16(audio):
    return np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)


def _round_rows():
    """Independent rows: int16 with hits and an int16 tail, f32 with a
    marker hit and no tail, a zero-length idle row, the flooded int16
    chunk with its tail, a short f32 row."""
    i16 = _pcm16(_audio(1, 30.0, normal=(13.0,), marker=(17.0,)))
    f32 = _audio(2, 25.0, normal=(4.0,), marker=(7.0,)).astype(np.float32)
    flood = _pcm16(_audio(4, 30.0, flood_at=9.05))
    return [
        (i16[CHUNK : 2 * CHUNK], i16[:CHUNK]),
        (f32[:CHUNK], None),
        (np.zeros(0, np.float32), None),
        (flood[CHUNK : 2 * CHUNK], flood[:CHUNK]),
        (f32[2 * CHUNK :], f32[CHUNK : 2 * CHUNK]),
    ]


# case -> (variables, the port's tier[, height_min])
CASES = {
    "default": ({}, "kernel"),
    "mask": ({"APD_PALLAS": "0"}, "mask"),
    "mask_height_min_0": ({"APD_PALLAS": "0"}, "mask", 0.0),  # the general-plateau tier
    "no_overlap_save": ({"APD_NO_OVERLAP_SAVE": "1"}, "kernel"),
    "packed_upload_0": ({"APD_PACKED_UPLOAD": "0"}, "kernel"),
    "marker_gemm": ({"APD_MARKER_GEMM": "1"}, "kernel"),
}


def _golden(det, wrapper_type):
    out = []
    for path in GOLDEN_FILES:
        wrapper = wrapper_type(path, SR)
        try:
            peaks, total = det.find_clip_in_audio(
                (AudioStream if wrapper_type is _WavFileStreamWrapper else jclip.AudioStream)(
                    name="g", audio_stream=wrapper, sample_rate=SR))
        finally:
            wrapper.close()
        out.append(({k: [round(t * 1000) for t in v] for k, v in peaks.items()}, total))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_switch_matches_the_jax_bank(monkeypatch, case):
    variables, tier, *height_min = CASES[case]
    kwargs = {"height_min": height_min[0]} if height_min else {}
    for name, value in variables.items():
        monkeypatch.setenv(name, value)
    jdet = AudioPatternDetector([jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()],
                                seconds_per_chunk=CHUNK_S, **kwargs)
    tdet = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S, **kwargs)
    jbank, tbank = jdet._ensure_bank(), tdet._ensure_bank()
    assert not jbank._pallas and jbank._metas == tbank._metas
    assert tbank.kernel_tier == (tier == "kernel")
    same_geometry = case != "no_overlap_save"
    for sw, cls in tbank.classes.items():
        jcls = jbank.classes[sw]
        assert all(g.corr.num_segments > 1 for g in cls["groups"])  # the port's one form
        if not same_geometry:
            assert jcls["loud"].num_segments == 1
            assert all(jg.corr.num_segments == 1 for jg in jcls["groups"])
            continue
        assert cls["loud"].num_segments == jcls["loud"].num_segments
        for g, jg in zip(cls["groups"], jcls["groups"]):
            assert (g.corr.fft_len, g.corr.num_segments) == (jg.corr.fft_len, jg.corr.num_segments)

    routes = {"gemm": 0, "sequential": 0, "scan": 0}
    for key, module, name in (("gemm", tverify_marker, "_rfft_power_gemm"),
                              ("sequential", tlane, "_greedy_distance_sequential"),
                              ("scan", tscan, "candidate_scan_reference")):
        fn = getattr(module, name)

        def spy(*a, fn=fn, key=key):
            routes[key] += 1
            return fn(*a)

        monkeypatch.setattr(module, name, spy)

    rows = _round_rows()
    chunks, tails = [c for c, _ in rows], [t for _, t in rows]
    # int16 rows upload as int16 whatever APD_PACKED_UPLOAD says; the
    # device decode is bitwise the JAX bank's host decode.
    assert tbank._staged_sections(CHUNK, [chunks[0], chunks[3]])[0].dtype == np.int16
    want = jbank.dispatch_chunks_batch(chunks, None, mode="vmap", prev_tails=tails)
    got = tbank.dispatch_chunks_batch(chunks, None, mode="vmap", prev_tails=tails)
    hit_rows = near_rows = 0
    for (sw, jflat, *_), (_, handle, *_) in zip(want, got):
        payload, jpayload = handle.numpy(), np.asarray(jflat)
        groups = tbank.classes[sw]["groups"]
        for g, packed, jpacked in zip(groups, _split_fused(payload, groups),
                                      _split_fused(jpayload, groups)):
            k = g.k_verify
            hit_rows += int(unpack_group(packed, k)[1].any(axis=-1).sum())
            if tier == "kernel":  # the kernel tier's near-collapse flag
                near = (packed[..., 2 * k] == 2.0) & (jpacked[..., 2 * k] == 0.0)
                near_rows += int(near.sum())
                packed = packed.copy()
                packed[near, 2 * k] = 0.0
            if same_geometry:
                np.testing.assert_array_equal(packed, jpacked)
    assert near_rows <= 1
    assert hit_rows + near_rows >= 4  # 13 s, 17 s marker, 4 s, 7 s marker
    assert tbank.collect_chunks_batch(got) == jbank.collect_chunks_batch(want)
    if not height_min:  # the general-plateau tier captures k_detect lanes: no rerun
        assert tbank.row_reruns + tbank.class_reruns >= 1  # the flooded row

    # The golden corpus through both serial engines.
    clips_t = _load_pattern_clips(GOLDEN_PATTERNS, SR)
    clips_j = jload_clips(GOLDEN_PATTERNS, SR)
    golden_t = _golden(TorchAudioPatternDetector(clips_t, device="cpu", seconds_per_chunk=60),
                       _WavFileStreamWrapper)
    golden_j = _golden(AudioPatternDetector(clips_j, seconds_per_chunk=60), JaxWavWrapper)
    assert golden_t == golden_j
    assert golden_t[0][0]["rthk_beep"] == [1408, 2420] and golden_t[1][0]["cbs_news"] == [25899]

    assert (routes["scan"] > 0) == (tier == "kernel")
    assert (routes["gemm"] > 0) == (case == "marker_gemm")
    if not height_min:  # there a marker group's k_detect lanes take the sequential greedy
        assert routes["sequential"] == 0


@pytest.mark.parametrize("pallas", [None, "1", "0"], ids=["unset", "pallas_1", "pallas_0"])
def test_every_path_runs_the_kernel_tier_unless_asked(monkeypatch, pallas):
    """Unset (or ``APD_PALLAS=1``), every path's class step runs the kernel
    tier's scan (its plain version on the CPU); ``APD_PALLAS=0`` leaves it
    on every path, by the caller's choice only."""
    if pallas is not None:
        monkeypatch.setenv("APD_PALLAS", pallas)
    calls = []
    plain = tscan.candidate_scan_reference
    monkeypatch.setattr(tscan, "candidate_scan_reference",
                        lambda *a: calls.append(1) or plain(*a))
    det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S)
    bank = det._ensure_bank()
    assert bank.kernel_tier == (pallas != "0")
    rows = _round_rows()
    chunks, tails = [c for c, _ in rows], [t for _, t in rows]
    two = make_mesh({"stream": 2}, devices=[CPU] * 2)
    audio = _audio(6, 2 * CHUNK_S, normal=(3.0,)).astype(np.float32)
    paths = {
        "single": lambda: bank.process_chunk(chunks[1], None),
        "scan": lambda: bank.process_chunks_batch(chunks[:2], None, mode="scan"),
        "vmap": lambda: bank.process_chunks_batch(chunks[:2], None, mode="vmap"),
        "stream_mesh": lambda: MultiStreamSession(det, 2, mesh=two).feed(chunks[:2]),
        "time_mesh": lambda: ShardedDetector(
            det.audio_clips, make_mesh({"time": 2}, devices=[CPU] * 2), CHUNK_S, detector=det,
        ).detect(audio),
        "bank_mesh": lambda: BankShardedBank(
            bank, make_mesh({"bank": 2}, devices=[CPU] * 2)).process_chunk(chunks[1], None),
    }
    for name, run in paths.items():
        calls.clear()
        run()
        assert (len(calls) > 0) == (pallas != "0"), (name, len(calls))


@pytest.mark.parametrize("switch", [
    "APD_PACKED_UPLOAD=0", "APD_SKIP_EMPTY_VERIFY=0", "APD_GREEDY_UNROLL=1",
    "APD_NO_OVERLAP_SAVE=1", "APD_BLOCK_LEAN=1", "APD_MERGED_IRFFT=1", "APD_SEQ_GREEDY=1",
])
def test_a_jax_switch_the_port_does_not_read_leaves_its_step_unchanged(monkeypatch, switch):
    """A bank built under one of the JAX package's switches that pick
    another form of the same class step, which the port does not read, on
    the stand-in graph backend: the round of :func:`_round_rows` in both
    schedules and its collection give the same step keys (their constants'
    ids aside), the same payload bits, the same detections and the same
    nodes run (verify bodies, loops, loop passes) as a bank built with no
    switch set."""
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)
    rows = _round_rows()
    chunks, tails = [c for c, _ in rows], [t for _, t in rows]

    def run():
        bank = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S,
                                         capture=True)._ensure_bank()
        payloads, results = [], []
        for mode in ("vmap", "scan"):
            dispatched = bank.dispatch_chunks_batch(chunks, None, mode=mode, prev_tails=tails)
            payloads += [handle.numpy().view(np.int32).copy() for _, handle, *_ in dispatched]
            results.append(bank.collect_chunks_batch(dispatched))
        steps = bank.graphs.steps() + bank.rerun_graphs.steps()
        backend = bank.graphs._backend
        nodes = (backend.captures, backend.bodies, backend.skipped, backend.loops,
                 backend.iterations)
        return {s.key._replace(consts=()) for s in steps}, payloads, results, nodes

    keys, payloads, results, nodes = run()
    name, value = switch.split("=")
    monkeypatch.setenv(name, value)
    got_keys, got_payloads, got_results, got_nodes = run()
    assert got_keys == keys and len(keys) >= 3  # rows 5 and 1, and a row rerun
    assert len(got_payloads) == len(payloads)
    for got, want in zip(got_payloads, payloads):
        np.testing.assert_array_equal(got, want)
    assert got_results == results and results[0] == results[1]
    assert got_nodes == nodes and nodes[1] > 0 and nodes[3] > 0
