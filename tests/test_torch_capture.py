"""Captured class steps (``models/captured.py``) on the CPU.

A CUDA graph needs a card, so these tests put a stand-in in its place
(``StepGraphs.backend``): its capture records the step's callable and runs
it once for the static output, its replay runs it again and copies the
result into that output. Everything around the graph is the port's own:
the cache and its keys, the static inputs and their copies, the payload
copied out of the static output, the launch accounting, and the two
schedules, "vmap" (one replay of the (B) graph a round) and "scan" (the
B = 1 graph replayed once per row). Payloads are held bit for bit:

* against the eager step on the same bank (``capture`` off), and
* against the JAX package's ``_class_step_scan_jit`` on the same rows
  (with its XLA mask, which has no near-collapse flag, as in
  tests/test_torch_vmap.py, and with the Pallas kernel in interpret mode).

The real graphs run on the card (tests/test_torch_cuda.py, chip_smoke.py's
``captured`` phase). Also here: the CPU default is eager and
``capture=True`` raises there, and the lean step, warmed, reads nothing on
the host and uploads nothing (the no-host-sync guard of
tests/test_torch_vmap.py at B = 1 and in the mask tier).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models import bank as jbank_module
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.models import captured
from audio_pattern_detector_tpu_torch.models.bank import PatternBank, _split_fused
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
    candidate_scan,
    candidate_scan_reference,
)
from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")
CHUNK_S = 10
CHUNK = CHUNK_S * SR


def _clips():
    """A 0.6 s normal clip and a 941 Hz marker tone (tests/test_torch_vmap.py)."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tm = np.arange(int(0.25 * SR)) / SR
    marker = np.sin(2 * np.pi * 941.0 * tm).astype(np.float32)
    return [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(
            name="m", audio=marker, sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY, strategy_params={"dominant_frequency_hz": 941.0},
        ),
    ]


def _audio(seed, seconds, normal=(), marker=()):
    clip, tone = (c.audio for c in _clips())
    audio = 0.01 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
    for s in normal:
        o = int(s * SR)
        audio[o : o + len(clip)] += clip
    for s in marker:
        o = int(s * SR)
        audio[o : o + len(tone)] += 0.8 * tone
    return audio


def _pcm16(audio):
    return np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)


# A round of four rows: an f32 first chunk with a hit, the next chunk with
# its tail and a marker hit, a short f32 last chunk, a zero-length idle row.
F32 = _audio(1, 27.0, normal=(4.0, 12.3, 23.0), marker=(16.0,)).astype(np.float32)
ROWS = [(F32[:CHUNK], None), (F32[CHUNK : 2 * CHUNK], F32[:CHUNK]),
        (F32[2 * CHUNK :], F32[CHUNK : 2 * CHUNK]), (np.zeros(0, np.float32), None)]
I16 = _pcm16(_audio(2, 20.0, normal=(3.0, 15.5)))
I16_ROWS = [(I16[:CHUNK], None), (I16[CHUNK:], I16[:CHUNK])]


# A predicate as the node's handle kernel reads it: kept aside, so that a
# test that forbids host reads of tensors leaves the stand-in's nodes alone.
_read_pred = torch.Tensor.__bool__


class RecordingBackend:
    """Stand-in for ``captured.CudaGraphBackend`` on any device: the
    capture records the callable and runs it once for the static output;
    a replay runs it again into that output. Its ``conditional``,
    ``cond`` and ``while_loop`` read the predicate where the step runs, at
    capture and at each replay, as a node's handle is set at replay, and
    count the bodies and branches they ran and skipped and the loop
    iterations."""

    conditional_route = "stand-in"

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.bodies = 0
        self.skipped = 0
        self.then_taken = 0
        self.else_taken = 0
        self.loops = 0
        self.iterations = 0

    @staticmethod
    def _check(pred):
        assert pred.dim() == 0 and pred.dtype == torch.bool

    def conditional(self, pred, body):
        self._check(pred)
        if _read_pred(pred):
            self.bodies += 1
            body()
        else:
            self.skipped += 1

    def cond(self, pred, then_, else_):
        self._check(pred)
        if _read_pred(pred):
            self.then_taken += 1
            then_()
        else:
            self.else_taken += 1
            else_()

    def while_loop(self, pred, body):
        self._check(pred)
        self.loops += 1
        while _read_pred(pred):
            self.iterations += 1
            body()

    @staticmethod
    def check(device):
        pass

    def warm_up(self, device, fn):
        return fn()

    def capture(self, device, fn):
        out = fn()
        self.captures += 1

        def replay():
            # A graph's replay calls no kernel wrapper: undo what the
            # step's Python counts as it runs again.
            self.replays += 1
            counted = {w: w.launches for w in captured.COUNTED}
            for static, new in zip(captured._tensors(out), captured._tensors(fn())):
                static.copy_(new)
            for w, n in counted.items():
                w.launches = n

        return replay, out


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)


def _bank(capture=None, **kw):
    return TorchAudioPatternDetector(
        _clips(), device="cpu", seconds_per_chunk=CHUNK_S, capture=capture, **kw
    )._ensure_bank()


def _bank_args():
    det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S)
    return dict(clip_datas=det._clip_datas, tone_frequencies=det._tone_frequencies,
                strategy_params=det._clip_strategy_params, sample_rate=SR, chunk_samples=CHUNK,
                height_min=0.25, device="cpu")


def _dispatch(bank, rows, mode):
    chunks, tails = [c for c, _ in rows], [t for _, t in rows]
    return bank.dispatch_chunks_batch(chunks, None, mode=mode, prev_tails=tails)


def _payloads(dispatched):
    return {sw: handle.numpy().copy() for sw, handle, *_ in dispatched}


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _sections(bank, sw, rows):
    raws = [bank._raw_section(sw, c, t) for c, t in rows]
    return torch.from_numpy(bank._staged_sections(bank.classes[sw]["section_len"], raws)[0]), \
        torch.tensor([len(r) for r in raws], dtype=torch.int32)


# ── Default and refusal ──


def test_cpu_default_is_eager_and_capture_true_raises():
    bank = _bank()
    assert bank.capture is False
    _payloads(_dispatch(bank, ROWS, "vmap"))
    assert bank.graphs.steps() == []
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        _bank(capture=True)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        PatternBank(**{**_bank_args(), "capture": True})
    # Switched on later, the first step refuses too: no eager fallback.
    bank.capture = True
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        _dispatch(bank, ROWS, "vmap")


# ── Keys ──


def test_keys_follow_class_rows_dtype_and_the_banks_switches(stand_in):
    bank = _bank(capture=True)
    (sw, cls), = bank.classes.items()
    _dispatch(bank, ROWS, "vmap")
    _dispatch(bank, I16_ROWS, "vmap")
    _dispatch(bank, ROWS, "scan")
    _dispatch(bank, ROWS, "vmap")  # a key seen before: no new graph
    own = (id(cls["loud"]), *(id(c) for g in cls["groups"] for c in (g.corr, g.verify)))
    keys = {s.key for s in bank.graphs.steps()}
    assert {(k.sw, k.rows, k.dtype) for k in keys} == {
        (sw, 4, torch.float32), (sw, 2, torch.int16), (sw, 1, torch.float32)}
    for k in keys:
        assert (k.device, k.fused, k.scan, k.general, k.kernel_tier, k.marker_gemm,
                k.consts) == (CPU, True, candidate_scan, False, True, False, own)
    assert bank.graphs._backend.captures == 3


@pytest.mark.parametrize("switch,field,value", [
    ("APD_PALLAS=0", "kernel_tier", False),
    ("APD_MARKER_GEMM=1", "marker_gemm", True),
])
def test_a_switch_is_part_of_the_key(stand_in, monkeypatch, switch, field, value):
    """Each of the JAX package's switches the bank reads lands in the key
    (the bank's when it is built, ``APD_MARKER_GEMM`` at each call), and
    the captured round equals the eager one under the same switch."""
    name, setting = switch.split("=")
    monkeypatch.setenv(name, setting)
    bank, eager = _bank(capture=True), _bank(capture=False)
    payload = _payloads(_dispatch(bank, I16_ROWS, "vmap"))
    want = _payloads(_dispatch(eager, I16_ROWS, "vmap"))
    assert all(np.array_equal(_bits(want[sw]), _bits(payload[sw])) for sw in payload)
    (step,) = bank.graphs.steps()
    assert getattr(step.key, field) is value
    assert step.key.dtype == torch.int16
    monkeypatch.delenv(name)
    _dispatch(bank, I16_ROWS, "vmap")
    keys = {getattr(s.key, field) for s in bank.graphs.steps()}
    # Read at each call, APD_MARKER_GEMM gives the same bank another key.
    assert keys == ({True, False} if name == "APD_MARKER_GEMM" else {value})


def test_a_replica_or_a_bank_shard_never_reuses_another_graph(stand_in):
    """Constants of the same values in other objects (a replica made on
    another device, a bank shard's slice) get graphs of their own, and
    each graph holds the constants it reads."""
    bank = _bank(capture=True)
    (sw, cls), = bank.classes.items()
    sections, lens = _sections(bank, sw, ROWS)
    own = bank.step(sw, sections, lens)
    replica = (dataclasses.replace(cls["loud"]),
               tuple((dataclasses.replace(g.corr), dataclasses.replace(g.verify))
                     for g in cls["groups"]))
    other = bank.step(sw, sections, lens, consts=replica)
    assert torch.equal(own.view(torch.int32), other.view(torch.int32))
    steps = bank.graphs.steps()
    assert len(steps) == 2 and steps[0].key.consts != steps[1].key.consts
    assert steps[1].consts[0] is replica[0] and steps[1].consts[1] is replica[1]
    assert bank.step(sw, sections, lens, consts=bank.replica(sw, CPU)) is not None
    assert len(bank.graphs.steps()) == 2  # the bank's own tensors on its own device

    sharded = BankShardedBank(bank, make_mesh({"bank": 2}, devices=[CPU, CPU]))
    want = bank.process_chunk(ROWS[1][0], ROWS[1][1])
    assert sharded.process_chunk(ROWS[1][0], ROWS[1][1]) == want
    shard_keys = [s.key for s in bank.graphs.steps()
                  if s.key.consts not in {t.key.consts for t in steps}]
    assert len(shard_keys) == 2 and shard_keys[0].consts != shard_keys[1].consts
    assert {k.rows for k in shard_keys} == {1} and want["c"] and want["m"]


# ── Static inputs, payloads, accounting ──


def test_static_inputs_hold_the_calls_rows_and_lengths(stand_in):
    bank = _bank(capture=True)
    (sw, cls), = bank.classes.items()
    for rows in (ROWS, ROWS[2:]):
        _dispatch(bank, rows, "vmap")
        step = next(s for s in bank.graphs.steps() if s.key.rows == len(rows))
        sections, lens = _sections(bank, sw, rows)
        assert torch.equal(step.section, sections) and torch.equal(step.n_valid, lens)
    _dispatch(bank, I16_ROWS, "scan")  # the last row stays in the one-row graph's inputs
    step = next(s for s in bank.graphs.steps() if s.key.rows == 1)
    sections, lens = _sections(bank, sw, I16_ROWS)
    assert step.section.dtype == torch.int16
    assert torch.equal(step.section[0], sections[-1]) and int(step.n_valid[0]) == lens[-1]


def test_a_returned_payload_is_not_the_static_output(stand_in):
    """A second replay with other rows leaves the first payload as it
    was: every call's payload is copied out of the static output."""
    bank = _bank(capture=True)
    (sw, _), = bank.classes.items()
    first_rows, second_rows = _sections(bank, sw, ROWS[:2]), _sections(bank, sw, ROWS[1:3])
    bank.step(sw, *first_rows)  # first use: the eager run's payload
    first = bank.step(sw, *first_rows)
    kept = first.clone()
    second = bank.step(sw, *second_rows)
    (step,) = bank.graphs.steps()
    assert step.replays == 2
    assert torch.equal(first.view(torch.int32), kept.view(torch.int32))
    assert first.data_ptr() != step._out.data_ptr() != second.data_ptr()
    assert not torch.equal(first, second)
    bank.capture = False
    assert torch.equal(bank.step(sw, *second_rows).view(torch.int32), second.view(torch.int32))


def test_replays_add_the_launches_their_graph_holds(stand_in):
    """The kernel counter counts kernels run: the first call's eager run
    counts, the capture adds nothing, each replay adds its graph's
    launches (one per group here), whatever Python ran meanwhile."""

    def counting(corr, thr, valid_len):
        candidate_scan.launches += 1
        return candidate_scan_reference(corr, thr, valid_len)

    bank = _bank(capture=True)
    (sw, cls), = bank.classes.items()
    groups = len(cls["groups"])
    sections, lens = _sections(bank, sw, ROWS)
    before = candidate_scan.launches
    for n in range(1, 4):
        bank.step(sw, sections, lens, scan=counting)
        assert candidate_scan.launches - before == n * groups
    (step,) = bank.graphs.steps()
    assert step.launches == groups and step.replays == 2 and step.key.scan is counting
    bank.capture = False
    bank.step(sw, sections, lens, scan=counting)
    assert candidate_scan.launches - before == 4 * groups


# ── The two schedules against eager and against the JAX package ──


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_xla_mask", "jax_pallas_interpret"])
def test_scan_is_one_row_replays_equal_to_eager_and_the_jax_scan_program(stand_in, pallas):
    """A "scan" round runs the B = 1 graph once per row (its first call
    the eager run that precedes the capture): payloads bit for bit the
    eager scan schedule's, the "vmap" round's, and the JAX package's
    ``_class_step_scan_jit`` on the same f32 sections."""
    rows = ROWS[1:3] if pallas else ROWS  # the Pallas interpreter is slow
    bank = _bank(capture=True)
    (sw, cls), = bank.classes.items()
    got = {}
    for n in range(2):
        got[n] = _payloads(_dispatch(bank, rows, "scan"))
    (step,) = bank.graphs.steps()
    assert step.key.rows == 1 and step.replays == 2 * len(rows) - 1
    vmapped = _payloads(_dispatch(bank, rows, "vmap"))
    bank.capture = False
    eager = _payloads(_dispatch(bank, rows, "scan"))
    assert np.array_equal(_bits(got[0][sw]), _bits(eager[sw]))
    assert np.array_equal(_bits(got[1][sw]), _bits(eager[sw]))
    assert np.array_equal(_bits(vmapped[sw]), _bits(eager[sw]))

    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()
    assert jbank._metas == bank._metas
    sections, lens = _sections(bank, sw, rows)
    jcls = jbank.classes[sw]
    want = np.asarray(jbank_module._class_step_scan_jit(
        jnp.asarray(sections.numpy()), jnp.asarray(lens.numpy().astype(np.float32)),
        jcls["loud"], tuple((g.corr, g.verify) for g in jcls["groups"]),
        metas=jbank._metas[sw], height_min=jbank.height_min, pallas=pallas,
    ))
    hits = 0
    for g, packed, jpacked in zip(cls["groups"], _split_fused(got[1][sw], cls["groups"]),
                                  _split_fused(want, cls["groups"])):
        k = g.k_verify
        hits += int((packed[..., k : 2 * k] != 0).any(axis=-1).sum())
        if not pallas:
            # The XLA mask's tier has no near-collapse flag (tests/test_torch_vmap.py).
            packed = packed.copy()
            packed[(packed[..., 2 * k] == 2.0) & (jpacked[..., 2 * k] == 0.0), 2 * k] = 0.0
        np.testing.assert_array_equal(packed, jpacked)
    assert hits >= (2 if pallas else 4)


def test_vmap_round_is_one_replay_equal_to_eager(stand_in):
    """A "vmap" round is one replay of its (B) graph, for int16 rows too,
    and collects the eager round's results."""
    bank = _bank(capture=True)
    for rows in (ROWS, I16_ROWS):
        got = [_dispatch(bank, rows, "vmap") for _ in range(3)]
        bank.capture = False
        eager = _dispatch(bank, rows, "vmap")
        bank.capture = True
        for d in got:
            for (sw, h, *_), (_, e, *_) in zip(d, eager):
                assert np.array_equal(_bits(h.numpy()), _bits(e.numpy()))
        assert bank.collect_chunks_batch(got[-1]) == bank.collect_chunks_batch(eager)
    assert [s.replays for s in bank.graphs.steps()] == [2, 2]


def test_the_general_plateau_tier_is_captured_and_the_wide_rerun_stays_eager(stand_in):
    """``height_min <= 0`` captures its step too (its lane greedy's loops
    and its two-tier cond are nodes of the graph: one key, its payload the
    eager step's); a flooded row's wide rerun, which runs at collect time,
    stays out of the class steps' keys: a row rerun is a key of its own,
    of one row and its lanes, beside the captured lean step, and its
    results are the eager rerun's."""
    general = _bank(capture=True, height_min=0.0)
    got = [_payloads(_dispatch(general, ROWS, "vmap")) for _ in range(2)]
    (step,) = general.graphs.steps()
    assert step.key.general and step.replays == 1
    general.capture = False
    eager = _payloads(_dispatch(general, ROWS, "vmap"))
    assert all(np.array_equal(_bits(g[sw]), _bits(eager[sw])) for g in got for sw in eager)
    bank = _bank(capture=True)
    # 18 copies 0.62 s apart: more than the lean tier's 16 lanes.
    flood = _audio(4, 30.0, normal=[9.05 + 0.62 * k for k in range(18)]).astype(np.float32)
    chunks = [flood[CHUNK : 2 * CHUNK], F32[:CHUNK]]
    results = bank.process_chunks_batch(chunks, flood[:CHUNK], mode="vmap")
    assert bank.row_reruns + bank.class_reruns >= 1 and len(results[0]["c"]) >= 16
    assert {s.key.general for s in bank.graphs.steps()} == {False}
    assert {s.key.wide_lanes for s in bank.graphs.steps()} == {()}
    assert all(s.key.rows == 1 and s.key.wide_lanes for s in bank.rerun_graphs.steps())
    bank.capture = False
    assert bank.process_chunks_batch(chunks, flood[:CHUNK], mode="vmap") == results


# ── A flagged row's wide rerun ──


def _rerun_bank(clip, capture):
    return TorchAudioPatternDetector([clip], device="cpu", seconds_per_chunk=20,
                                     capture=capture)._ensure_bank()


def _rerun_routes(bank):
    return bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows


def _rerun_case(case):
    """(clip, 20 s chunk, routes): a noise clip copied 18 times (more than
    the lean tier's 16 lanes: one row rerun at the capped width), or a
    1,040 Hz marker hit with 18 weak ones past the cap's 1,024 candidates
    (the capped rerun, then the rerun escalated to the group's k_detect).
    The routes as ``tests/test_torch_rerun.py`` holds them on the eager
    bank."""
    rng = np.random.default_rng(3 if case == "row" else 5)
    audio = (0.004 if case == "row" else 0.002) * rng.standard_normal(20 * SR)
    if case == "row":
        clip = AudioClip(name="c", audio=(0.4 * np.random.default_rng(3).standard_normal(SR)).astype(
            np.float32), sample_rate=SR)
        for k in range(18):
            o = int((0.3 + 1.05 * k) * SR)
            audio[o : o + SR] += clip.audio[: min(SR, len(audio) - o)]
        return clip, audio.astype(np.float32), (1, 0, 0, 0)
    t = np.arange(int(0.25 * SR)) / SR
    tone = (0.8 * np.sin(2 * np.pi * 1040.0 * t)).astype(np.float32)
    audio[SR : SR + len(tone)] += tone
    for k in range(18):
        o = int((2.0 + 0.6 * k) * SR)
        audio[o : o + len(tone)] += 0.3 * tone
    return (AudioClip(name="m", audio=tone, sample_rate=SR, strategy="marker_tone"),
            audio.astype(np.float32), (2, 0, 1, 0))


@pytest.mark.parametrize("case", ["row", "escalated"])
def test_a_row_rerun_is_one_key_a_clip_and_width_its_results_the_eager_reruns(stand_in, case):
    """With capture on, a row rerun is the captured step of its own key (one
    row, the clip's constants, its lanes: the capped width, then the
    group's k_detect where it escalates), made at its first use and
    replayed after it, apart from the class steps; what the chunk returns,
    and the routes its rows take, are the eager bank's, twice over."""
    clip, audio, routes = _rerun_case(case)
    eager = _rerun_bank(clip, capture=False)
    want = eager.process_chunk(audio, None)
    assert _rerun_routes(eager) == routes and eager.rerun_graphs.steps() == []
    bank = _rerun_bank(clip, capture=True)
    assert [bank.process_chunk(audio, None) for _ in range(2)] == [want, want]
    assert _rerun_routes(bank) == tuple(2 * n for n in routes)
    (g,) = bank.classes[1]["groups"]
    lanes = [(min(g.k_detect, bank._WIDE_RERUN_CAP),)] + ([(g.k_detect,)] if case == "escalated" else [])
    steps = bank.rerun_graphs.steps()
    assert [s.key.wide_lanes for s in steps] == lanes
    assert all(s.key.rows == 1 and s.replays == 1 for s in steps)
    assert all(s.key.wide_lanes == () for s in bank.graphs.steps())


def test_a_captured_row_rerun_payload_is_the_eager_ones_bit_for_bit(stand_in):
    """The row rerun's payload itself, captured (one row of a (1, S) batch
    with its length tensor) against eager (one (S,) section with its int
    length), on a section shorter than the class's, whose padding the
    static input must zero again after a longer one."""
    clip, audio, _ = _rerun_case("row")
    eager, bank = _rerun_bank(clip, capture=False), _rerun_bank(clip, capture=True)
    for section in (audio, audio[: 15 * SR], audio):
        np.testing.assert_array_equal(_bits(bank._full_tier_row(1, 0, 0, section)),
                                      _bits(eager._full_tier_row(1, 0, 0, section)))
    (step,) = bank.rerun_graphs.steps()
    assert step.replays == 2


# ── The warmed lean step reads nothing on the host and uploads nothing ──


def _forbid_host_reads(monkeypatch, what):
    """Make every host read of a tensor's value (``item``, ``tolist``,
    ``bool()``, ``int()``, ``float()``, an index conversion, ``cpu``,
    ``numpy``) and every host tensor made for the device
    (``torch.tensor``, ``torch.from_numpy``, ``torch.as_tensor``,
    ``pin_memory``) raise: what a CUDA graph capture refuses."""

    def forbidden(name):
        def raise_(*a, **k):
            raise AssertionError(f"{what} called {name}")
        return raise_

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu",
                 "numpy", "pin_memory"):
        monkeypatch.setattr(torch.Tensor, name, forbidden(f"Tensor.{name}"))
    for name in ("tensor", "from_numpy", "as_tensor"):
        monkeypatch.setattr(torch, name, forbidden(f"torch.{name}"))


@pytest.mark.parametrize("tier", ["kernel", "mask"])
@pytest.mark.parametrize("rows", [1, 4])
def test_warmed_lean_step_makes_no_host_sync_or_upload(monkeypatch, tier, rows):
    """The batched lean step at B = 1 and B = 4, kernel and mask tier,
    after a first run: no tensor value read on the host and no host tensor
    made for the device (:func:`_forbid_host_reads`)."""
    if tier == "mask":
        monkeypatch.setenv("APD_PALLAS", "0")
    bank = _bank()
    monkeypatch.delenv("APD_PALLAS", raising=False)
    (sw, _), = bank.classes.items()
    sections, lens = _sections(bank, sw, ROWS[:rows])
    want = bank.step(sw, sections, lens)
    _forbid_host_reads(monkeypatch, "the warmed lean step")
    got = bank.step(sw, sections, lens)
    monkeypatch.undo()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bank.kernel_tier is (tier == "kernel")


@pytest.mark.parametrize("tier", ["kernel", "mask"])
@pytest.mark.parametrize("rows", [1, 4])
def test_warmed_general_step_makes_no_host_sync_or_upload(stand_in, monkeypatch, tier, rows):
    """The general-plateau step (``height_min = 0``) at B = 1 and B = 4,
    kernel and mask tier, captured and warmed: a replay reads no tensor on
    the host and makes no host tensor for the device
    (:func:`_forbid_host_reads`) outside the graph's nodes, whose
    predicates the stand-in reads as a node's handle kernel does on the
    card. Its eager step loops on the host; the replay's payload is its
    payload."""
    if tier == "mask":
        monkeypatch.setenv("APD_PALLAS", "0")
    bank = _bank(capture=True, height_min=0.0)
    monkeypatch.delenv("APD_PALLAS", raising=False)
    (sw, _), = bank.classes.items()
    sections, lens = _sections(bank, sw, ROWS[:rows])
    want = bank.step(sw, sections, lens)  # first use: eager, then the capture
    _forbid_host_reads(monkeypatch, "the warmed general step")
    got = bank.step(sw, sections, lens)
    monkeypatch.undo()
    (step,) = bank.graphs.steps()
    assert step.key.general and step.replays == 1
    assert bank.graphs._backend.iterations > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    bank.capture = False
    with pytest.raises(AssertionError, match="the eager general step called Tensor"):
        _forbid_host_reads(monkeypatch, "the eager general step")
        bank.step(sw, sections, lens)
    monkeypatch.undo()
    assert bank.kernel_tier is (tier == "kernel")


@pytest.mark.parametrize("rows", [1, 4])
def test_the_batched_step_hands_the_scan_what_the_kernel_takes(rows):
    """At B = 1 (the one-row graph's form) and B = 4, every scan call of
    the batched lean step gets what the CUDA wrapper accepts: contiguous
    (R, L) float32 rows, (R,) float32 thresholds and a contiguous (R,)
    int32 length tensor (a stride-0 view of one length is refused)."""
    seen = []

    def checking(corr, thr_min, valid_len):
        seen.append((corr.is_contiguous(), corr.dtype, thr_min.shape == (corr.shape[0],),
                     valid_len.dtype, valid_len.shape == (corr.shape[0],),
                     valid_len.is_contiguous()))
        return candidate_scan_reference(corr, thr_min, valid_len)

    # Two normal clips in one group: R = B * 2 rows of one length each.
    clips = _clips()
    clips.append(AudioClip(name="c2", audio=0.7 * clips[0].audio[::-1].copy(), sample_rate=SR))
    bank = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()
    (sw, cls), = bank.classes.items()
    assert max(len(g.names) for g in cls["groups"]) == 2
    bank.step(sw, *_sections(bank, sw, ROWS[:rows]), scan=checking)
    assert seen == [(True, torch.float32, True, torch.int32, True, True)] * len(cls["groups"])
