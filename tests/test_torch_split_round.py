"""Captured rounds wider than a graph (``models/captured.py::SplitRound``),
on the CPU.

A captured key keeps its graph pools for as long as its bank lives, so the
bank caps a graph's rows (``models/bank.py::GRAPH_ROWS``) and runs a round
of B > W rows as ceil(B / W) replays of the W-row key, the last replay's
spare rows idle (zero-length) and dropped; the eager step runs a wide round
in the same W-row steps. Rows are independent, so the payload must be the
B-row round's. Here W is cut to 2 or 3 and the stand-in graph backend of
tests/test_torch_capture.py takes the card's place; every payload is held
bit for bit against the eager round in W-row steps and as one batch of B
rows on the same bank and against the JAX package's
``_class_step_batch_jit`` (the vmap program) on the same f32 sections:

* B = 5 and 7 in the lean kernel tier, the mask tier (``APD_PALLAS=0``) and
  the general-plateau tier (``height_min = 0``), the plain greedies as
  while loops;
* through ``dispatch_chunks_batch(mode="vmap")`` (the round above), a
  ``RowSharding`` shard of more than W rows, and a ``MultiStreamSession``
  whose tile is wider than W;
* one key of W rows, whatever B; no eager step runs in a replay's place.
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
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.parallel import make_mesh
from audio_pattern_detector_tpu_torch.parallel.mesh import RowSharding
from tests.test_torch_capture import (
    CHUNK,
    CHUNK_S,
    CPU,
    ROWS,
    RecordingBackend,
    _audio,
    _bank,
    _bits,
    _clips,
    _dispatch,
    _payloads,
    _sections,
)

torch.set_num_threads(1)

# Three more independent rows beside ROWS' four: a first chunk with a marker
# hit, its successor with a normal hit, and a short last chunk.
F2 = _audio(21, 24.0, normal=(13.1,), marker=(5.2, 21.0)).astype(np.float32)
ROWS7 = ROWS + [(F2[:CHUNK], None), (F2[CHUNK : 2 * CHUNK], F2[:CHUNK]),
                (F2[2 * CHUNK :], F2[CHUNK : 2 * CHUNK])]

TIERS = {  # environment and height_min of each tier
    "kernel": ({}, None),
    "mask": ({"APD_PALLAS": "0"}, None),
    "general": ({}, 0.0),
}


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)


@pytest.fixture(scope="module")
def jax_vmap():
    """The JAX package's vmap program by (rows, height_min): payloads of
    the same f32 sections."""
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()
    (sw, jcls), = jbank.classes.items()
    cache = {}

    def payload(sections, lens, metas, height_min):
        key = (sections.shape[0], height_min)
        if key not in cache:
            assert jbank._metas[sw] == metas
            cache[key] = np.asarray(jbank_module._class_step_batch_jit(
                jnp.asarray(sections.numpy()), jnp.asarray(lens.numpy().astype(np.float32)),
                jcls["loud"], tuple((g.corr, g.verify) for g in jcls["groups"]),
                metas=metas, height_min=jbank.height_min if height_min is None else height_min,
            ))
        return cache[key]

    return payload


def _width(monkeypatch, w):
    monkeypatch.setattr(tbank_module, "GRAPH_ROWS", w)


def _tier_bank(monkeypatch, tier, capture=True):
    env, height_min = TIERS[tier]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    bank = _bank(capture=capture, **({} if height_min is None else {"height_min": height_min}))
    for name in env:
        monkeypatch.delenv(name)
    return bank


def _hold_to_jax(got, want, groups, tier):
    """Bit for bit, save that the XLA mask's tier has no near-collapse
    flag: a flag 2 the kernel tier sets where JAX's mask sets none is
    cleared first (tests/test_torch_vmap.py)."""
    for g, packed, jpacked in zip(groups, _split_fused(got, groups), _split_fused(want, groups)):
        k = g.k_verify
        if tier == "kernel":
            packed = packed.copy()
            packed[(packed[..., 2 * k] == 2.0) & (jpacked[..., 2 * k] == 0.0), 2 * k] = 0.0
        np.testing.assert_array_equal(packed, jpacked)


@pytest.mark.parametrize("rows", [5, 7])
@pytest.mark.parametrize("tier", ["kernel", "mask", "general"],
                         ids=["kernel_while_loop", "mask_while_loop", "general"])
def test_a_round_wider_than_its_graph_is_replays_equal_to_eager_and_jax(
        stand_in, monkeypatch, jax_vmap, tier, rows):
    """B = 5 or 7 rows through ``dispatch_chunks_batch(mode="vmap")`` on
    graphs of W = 2 (lean tiers) or 3 (general tier) rows: ceil(B / W)
    replays of one W-row key a round (its first use the eager W-row run),
    payloads bit for bit the eager round's in W-row steps and as one batch
    of B rows and the JAX vmap program's, collected detections equal. The
    plain greedies' rounds run as while loops in every tier."""
    width = 3 if tier == "general" else 2
    _width(monkeypatch, width)
    bank = _tier_bank(monkeypatch, tier)
    eager = _tier_bank(monkeypatch, tier, capture=False)
    (sw, cls), = bank.classes.items()
    rounds = [_dispatch(bank, ROWS7[:rows], "vmap") for _ in range(2)]
    want = _dispatch(eager, ROWS7[:rows], "vmap")
    _width(monkeypatch, rows)
    one_batch = _payloads(_dispatch(eager, ROWS7[:rows], "vmap"))[sw]
    assert np.array_equal(_bits(one_batch), _bits(want[0][1].numpy()))
    (step,) = bank.graphs.steps()
    replays = -(-rows // width)
    assert step.key.rows == width
    assert step.replays == 2 * replays - 1  # the first replay of all is the eager run
    backend = bank.graphs._backend
    assert backend.captures == 1 and backend.loops > 0
    got = [_payloads(d)[sw] for d in rounds]
    for payload in got:
        assert payload.shape == (rows, want[0][1].numpy().shape[1])
        assert np.array_equal(_bits(payload), _bits(want[0][1].numpy()))
    sections, lens = _sections(bank, sw, ROWS7[:rows])
    jax_payload = jax_vmap(sections, lens, bank._metas[sw], TIERS[tier][1])
    _hold_to_jax(got[-1], jax_payload, cls["groups"], tier)
    if tier != "general":  # at a threshold of 0 every noise row takes the host path
        results = bank.collect_chunks_batch(rounds[-1])
        assert results == eager.collect_chunks_batch(want)
        assert sum(len(ts) for r in results for ts in r.values()) >= 4


@pytest.mark.parametrize("tier", ["kernel", "general"])
def test_a_row_shard_wider_than_its_graph_equals_eager_and_jax(stand_in, monkeypatch,
                                                                jax_vmap, tier):
    """A round of 6 rows over a stream mesh of two logical CPU shards: each
    shard's 3 rows are two replays of the 2-row graph, which the shards
    share; the stitched payload is the eager round's and the JAX vmap
    program's."""
    _width(monkeypatch, 2)
    bank = _tier_bank(monkeypatch, tier)
    (sw, cls), = bank.classes.items()
    rows = ROWS7[:6]
    streams = RowSharding(make_mesh({"stream": 2}, devices=[CPU, CPU]), "stream")

    def run():
        return _payloads(bank.dispatch_chunks_batch(
            [c for c, _ in rows], None, mode="vmap", prev_tails=[t for _, t in rows],
            sharding=streams))[sw]

    bank.capture = False
    eager = run()
    bank.capture = True
    got = [run(), run()]
    for payload in got:
        assert np.array_equal(_bits(payload), _bits(eager))
    (step,) = bank.graphs.steps()
    assert step.key.rows == 2 and step.replays == 2 * 2 * 2 - 1
    sections, lens = _sections(bank, sw, rows)
    _hold_to_jax(got[-1], jax_vmap(sections, lens, bank._metas[sw], TIERS[tier][1]),
                 cls["groups"], tier)


def _session_streams():
    """Five streams of three 10 s chunks (a short last one), hits spread
    over them."""
    hits = [dict(normal=(4.0,)), dict(marker=(12.5,)), dict(normal=(21.0,), marker=(3.3,)),
            dict(), dict(normal=(9.6,))]
    return [_audio(30 + i, 27.0, **kw).astype(np.float32) for i, kw in enumerate(hits)]


def _drive(session, audios):
    names = [c.name for c in session.detector.audio_clips]
    acc = [{name: [] for name in names} for _ in audios]
    for k in range(3):
        chunks = [a[k * CHUNK : (k + 1) * CHUNK] for a in audios]
        for a, res in zip(acc, session.collect(session.dispatch(chunks))):
            for name, ts in res.items():
                a[name].extend(ts)
    return acc


def test_a_session_tile_wider_than_the_graph_equals_eager(stand_in, monkeypatch):
    """A vmap ``MultiStreamSession`` of 5 streams, tile 5, on graphs of 2
    rows: every round is three replays of one 2-row key, and each stream's
    detections equal the eager session's."""
    _width(monkeypatch, 2)
    audios = _session_streams()
    got = {}
    for capture in (True, False):
        det = TorchAudioPatternDetector(_clips(), device="cpu", seconds_per_chunk=CHUNK_S,
                                        capture=capture)
        got[capture] = _drive(MultiStreamSession(det, 5, batch_mode="vmap", tile=5), audios)
        if capture:
            (step,) = det._ensure_bank().graphs.steps()
            assert step.key.rows == 2 and step.replays == 3 * 3 - 1
    assert got[True] == got[False]
    assert sum(len(ts) for s in got[True] for ts in s.values()) >= 5


def test_program_returns_one_graph_width_or_the_split(stand_in, monkeypatch):
    """``program`` hands back the captured step itself up to W rows and a
    ``SplitRound`` of it past W; the eager step is never the answer to a
    wide round on a captured bank. With ``capture`` off, the eager step up
    to W rows and a ``SplitRound`` of a W-row eager step past it."""
    _width(monkeypatch, 3)
    bank = _bank(capture=True)
    (sw, _), = bank.classes.items()
    assert isinstance(bank.program(sw, CPU, 3), captured.CapturedStep)
    wide = bank.program(sw, CPU, 8)
    assert isinstance(wide, captured.SplitRound) and (wide.rows, wide.width) == (8, 3)
    assert wide.step is bank.program(sw, CPU, 3) and wide.step.key.rows == 3
    bank.capture = False
    assert isinstance(bank.program(sw, CPU, 3), captured.EagerStep)
    wide = bank.program(sw, CPU, 8)
    assert isinstance(wide, captured.SplitRound) and (wide.rows, wide.width) == (8, 3)
    assert isinstance(wide.step, captured.EagerStep) and wide.step.rows == 3


@pytest.mark.parametrize("tier", ["kernel", "general"])
def test_an_eager_round_wider_than_w_runs_in_w_row_steps(monkeypatch, jax_vmap, tier):
    """With ``capture`` off, a round of 5 rows on W = 2 runs three eager
    steps of 2 rows each, the last with one idle zero-length row, as the
    captured split runs it; the payload is bit for bit the one-batch eager
    round's and the JAX vmap program's."""
    bank = _tier_bank(monkeypatch, tier, capture=False)
    (sw, cls), = bank.classes.items()
    rows = ROWS7[:5]
    one_batch = _payloads(_dispatch(bank, rows, "vmap"))[sw]
    _width(monkeypatch, 2)
    shapes = []
    run = captured.EagerStep.run

    def spy(step):
        shapes.append((tuple(step._section.shape[:1]), step._n_valid.tolist()))
        return run(step)

    monkeypatch.setattr(captured.EagerStep, "run", spy)
    got = _payloads(_dispatch(bank, rows, "vmap"))[sw]
    assert [s for s, _ in shapes] == [(2,)] * 3 and shapes[-1][1][1] == 0
    assert np.array_equal(_bits(got), _bits(one_batch))
    sections, lens = _sections(bank, sw, rows)
    _hold_to_jax(got, jax_vmap(sections, lens, bank._metas[sw], TIERS[tier][1]),
                 cls["groups"], tier)


@pytest.mark.parametrize("per_row", [False, True], ids=["one_length", "per_row_lengths"])
def test_normal_verify_of_raw_windows_equals_the_normalised_row(per_row):
    """``verify_normal(..., normalise=(valid_len, denom))`` reads raw
    |corr| and normalises only its windows (the lean tail's form, which
    keeps no normalised or padded copy of the rows in a verify body's
    pool): accept, similarity and Pearson r bit for bit those of the row
    normalised whole (``_normalised``) and zero-padded, lanes at both edges,
    past the valid length and at the hit included."""
    from tests.test_torch_ops import SR as OPS_SR
    from tests.test_torch_ops import _carry, _hit_corr

    from audio_pattern_detector_tpu.ops import verify as jverify
    from audio_pattern_detector_tpu_torch.ops import verify as tverify

    m = OPS_SR
    corr, cc, hit = _hit_corr(m, 11)
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(corr * rng.uniform(0.5, 3.0, (corr.shape[0], 1)).astype(np.float32))
    l = raw.shape[1]
    valid_len = (torch.tensor([l - 3000, l - 17], dtype=torch.int32) if per_row else l - 500)
    denom = torch.from_numpy(rng.uniform(0.7, 2.0, corr.shape[0]).astype(np.float32))
    pos = np.sort(rng.integers(0, l, (2, 16)), axis=1)
    pos[:, 3] = hit + np.array([0, 1])
    pos[:, 4] = [0, l - 1]
    pos[:, 5] = [l - 200, l - 2]  # past the valid length
    alive = torch.from_numpy(rng.random((2, 16)) < 0.8)
    consts = _carry(jverify.build_normal_verify_consts(cc, m, OPS_SR))
    whole = tverify.verify_normal(tbank_module._normalised(raw, valid_len, denom),
                                  torch.from_numpy(pos), alive, consts)
    windows = tverify.verify_normal(raw, torch.from_numpy(pos), alive, consts,
                                    normalise=(valid_len, denom))
    for a, b in zip(whole, windows):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert bool(whole[0].any())
