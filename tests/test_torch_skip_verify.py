"""Candidate-free groups skip the captured verify tail, on the CPU.

The JAX lean tail runs each group's verifier under
``lax.cond(jnp.any(valive), verify, zeros)`` (JAX ``models/bank.py:1306-
1330``, on by default). The port's captured step puts the verify of each
lean group in the body of a CUDA conditional node; here the stand-in graph
backend of tests/test_torch_capture.py takes the card's place, and its
``conditional`` reads the predicate at every replay, as the node's handle
is set at replay. The tests count the bodies that ran and the verifier
calls, and hold every payload bit for bit against the eager step on the
same bank and against the JAX package's ``_class_step_scan_jit`` (with its
XLA mask, which has no near-collapse flag, as in tests/test_torch_vmap.py,
and with the Pallas kernel in interpret mode):

* a candidate-free section runs no body;
* a section with hits in one group runs exactly that group's body;
* hits in both groups run both;
* a round (B > 1) runs a group's body when any of its rows has a live
  lane there; the "scan" schedule decides row by row;
* the mask tier (``APD_PALLAS=0``) skips in the same way.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models import bank as jbank_module
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.models import bank as tbank_module
from audio_pattern_detector_tpu_torch.models import captured
from audio_pattern_detector_tpu_torch.models.bank import _split_fused
from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
from tests.test_torch_capture import CHUNK_S, SR, RecordingBackend, _audio, _bits, _clips

torch.set_num_threads(1)

SECTION_S = CHUNK_S + 1  # the class's section: the chunk and a 1 s lookback
# Sections and the groups each should leave a live lane in.
SECTIONS = {
    "none": (dict(seed=11), set()),
    "normal": (dict(seed=12, normal=(4.0,)), {"normal"}),
    "marker": (dict(seed=13, marker=(6.0,)), {"marker"}),
    "both": (dict(seed=14, normal=(3.0,), marker=(7.5,)), {"normal", "marker"}),
}


def _section(kind):
    kw, _ = SECTIONS[kind]
    return _audio(seconds=SECTION_S, **kw).astype(np.float32)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)


@pytest.fixture
def verifies(monkeypatch):
    """The number of verifier calls the lean tails make, by a counter."""
    calls = []
    real = tbank_module._verify_accept

    def counting(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tbank_module, "_verify_accept", counting)
    return calls


def _bank(capture=True):
    return TorchAudioPatternDetector(
        _clips(), device="cpu", seconds_per_chunk=CHUNK_S, capture=capture
    )._ensure_bank()


def _live(payload, groups):
    """Per group kind: does any row keep a live lane (a position below the
    dead-lane sentinel)?"""
    flat = payload.numpy().reshape(-1, payload.shape[-1])
    return {g.kind for g, p in zip(groups, _split_fused(flat, groups))
            if (p[..., : g.k_verify] < 2**30).any()}


def _replay(bank, fn, verifies):
    """``fn()`` as a replay of a captured key (its first use first): its
    payload, and the bodies run, bodies skipped and verifier calls of the
    replay alone."""
    fn()
    backend = bank.graphs._backend
    before = backend.bodies, backend.skipped, len(verifies)
    out = fn()
    return out, (backend.bodies - before[0], backend.skipped - before[1],
                 len(verifies) - before[2])


def _jax_payload(bank, sections, lens, pallas):
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()
    assert jbank._metas == bank._metas
    (sw, jcls), = jbank.classes.items()
    return np.asarray(jbank_module._class_step_scan_jit(
        jnp.asarray(sections), jnp.asarray(np.asarray(lens, np.float32)),
        jcls["loud"], tuple((g.corr, g.verify) for g in jcls["groups"]),
        metas=jbank._metas[sw], height_min=jbank.height_min, pallas=pallas,
    ))


def _assert_jax_equal(payload, want, groups, kernel_tier):
    for g, got, jgot in zip(groups, _split_fused(payload.numpy().reshape(want.shape), groups),
                            _split_fused(want, groups)):
        k = g.k_verify
        if kernel_tier:
            # The XLA mask's tier has no near-collapse flag (tests/test_torch_vmap.py).
            got = got.copy()
            got[(got[..., 2 * k] == 2.0) & (jgot[..., 2 * k] == 0.0), 2 * k] = 0.0
        np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("kind", sorted(SECTIONS))
def test_a_replay_verifies_only_the_groups_with_a_live_lane(stand_in, verifies, kind):
    """One section through the one-row graph: a body runs for each group
    with a live lane and for no other, each body one verifier call; the
    payload is the eager step's and the JAX scan program's (whose cond is
    on, as by default)."""
    assert jbank_module._SKIP_EMPTY_VERIFY
    bank = _bank()
    (sw, cls), = bank.classes.items()
    raw = _section(kind)
    sec = torch.from_numpy(raw)
    got, (ran, skipped, calls) = _replay(bank, lambda: bank.step(sw, sec, len(raw)), verifies)
    live = _live(got, cls["groups"])
    assert live == SECTIONS[kind][1]
    assert (ran, skipped, calls) == (len(live), len(cls["groups"]) - len(live), len(live))
    (step,) = bank.graphs.steps()
    assert step.key.rows == 1
    bank.capture = False
    eager = bank.step(sw, sec, len(raw))
    assert np.array_equal(_bits(got), _bits(eager))
    want = _jax_payload(bank, raw[None], [len(raw)], pallas=False)
    _assert_jax_equal(got, want, cls["groups"], kernel_tier=True)


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_xla_mask", "jax_pallas_interpret"])
def test_a_round_skips_a_group_only_where_no_row_is_live(stand_in, verifies, pallas):
    """A round of a candidate-free row, a row with a normal hit, a short
    candidate-free row and a zero-length row. "vmap" (one replay of the
    (B) graph) tests all its rows at once: the normal group's body runs,
    the marker group's does not. "scan" replays the one-row graph per row
    and runs one body in all. Payloads bit for bit: vmap, scan, eager and
    the JAX scan program."""
    bank = _bank()
    (sw, cls), = bank.classes.items()
    s_len = cls["section_len"]
    raws = [_section("none"), _section("normal"), _section("none")[: 3 * SR],
            np.zeros(0, np.float32)]
    rows = np.zeros((len(raws), s_len), np.float32)
    for bi, raw in enumerate(raws):
        rows[bi, : len(raw)] = raw
    lens = [len(raw) for raw in raws]
    sections, n_valid = torch.from_numpy(rows), torch.tensor(lens, dtype=torch.int32)

    vmap, (ran, skipped, calls) = _replay(bank, lambda: bank.step(sw, sections, n_valid),
                                          verifies)
    assert _live(vmap, cls["groups"]) == {"normal"}
    assert (ran, skipped, calls) == (1, len(cls["groups"]) - 1, 1)
    scan, (ran, skipped, calls) = _replay(
        bank, lambda: torch.stack([bank.step(sw, sections[bi], lens[bi])
                                   for bi in range(len(raws))]), verifies)
    assert (ran, calls) == (1, 1) and skipped == len(raws) * len(cls["groups"]) - 1
    assert {s.key.rows for s in bank.graphs.steps()} == {1, len(raws)}
    bank.capture = False
    eager = bank.step(sw, sections, n_valid)
    assert np.array_equal(_bits(vmap), _bits(eager))
    assert np.array_equal(_bits(scan), _bits(eager))
    want = _jax_payload(bank, rows, lens, pallas=pallas)
    _assert_jax_equal(vmap, want, cls["groups"], kernel_tier=not pallas)


@pytest.mark.parametrize("kind", ["none", "both"])
def test_the_mask_tier_skips_too(stand_in, verifies, monkeypatch, kind):
    """Under ``APD_PALLAS=0`` (the mask lean tier) the same node wraps the
    verify: no body for a candidate-free section, both for hits in both
    groups; the payload is the eager step's and the JAX XLA-mask
    program's, field for field (neither tier has a near-collapse flag)."""
    monkeypatch.setenv("APD_PALLAS", "0")
    bank = _bank()
    monkeypatch.delenv("APD_PALLAS")
    assert bank.kernel_tier is False
    (sw, cls), = bank.classes.items()
    raw = _section(kind)
    sec = torch.from_numpy(raw)
    got, (ran, skipped, calls) = _replay(bank, lambda: bank.step(sw, sec, len(raw)), verifies)
    live = _live(got, cls["groups"])
    assert live == SECTIONS[kind][1]
    assert (ran, skipped, calls) == (len(live), len(cls["groups"]) - len(live), len(live))
    bank.capture = False
    assert np.array_equal(_bits(got), _bits(bank.step(sw, sec, len(raw))))
    want = _jax_payload(bank, raw[None], [len(raw)], pallas=False)
    _assert_jax_equal(got, want, cls["groups"], kernel_tier=False)


def test_the_eager_step_never_branches(stand_in, verifies):
    """Eager (``capture=False``, the CPU's default) has no node: it never
    calls the backend's conditional and verifies every group, candidates
    or none; the first use of a captured key verifies every group in its
    eager run too (so that what the body replays exists before capture)."""
    bank = _bank(capture=False)
    (sw, cls), = bank.classes.items()
    raw = _section("none")
    bank.step(sw, torch.from_numpy(raw), len(raw))
    assert len(verifies) == len(cls["groups"]) and bank.graphs.steps() == []
    captured_bank = _bank()
    del verifies[:]
    captured_bank.step(sw, torch.from_numpy(raw), len(raw))  # eager run, then the capture
    backend = captured_bank.graphs._backend
    assert len(verifies) == len(cls["groups"]) and backend.skipped == len(cls["groups"])
