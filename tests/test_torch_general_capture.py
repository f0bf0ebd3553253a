"""The general-plateau tier (``height_min <= 0``) as a captured step, on
the CPU.

The JAX tier keeps its control flow inside the jitted class step: the lane
greedy's ``lax.while_loop`` (JAX ``ops/peaks.py:282`` sequential, ``:323``
parallel fixed point) and the two-tier verify's ``lax.cond`` (JAX
``models/bank.py:111-133``). The port's captured step makes each a CUDA
conditional node: ``loop(pred, body)`` a while node, ``cond(pred, then_,
else_)`` two if-nodes. A card is needed for those, so the stand-in graph
backend of tests/test_torch_capture.py takes its place: its ``while_loop``
and ``cond`` read the predicate at every replay, as a node's handle is set
at replay, and count iterations and branches.

* The hooked greedy filters against their host loops and against JAX, on
  the cases of tests/test_torch_peaks_full.py, past 2,048 lanes (the
  sequential filter), with no alive lane (no iteration) and on a chain that
  takes the fixed point several rounds.
* ``_two_tier_accept`` with each branch taken (every lane in blocks of 16),
  and its warm-up form.
* At ``height_min = 0``, B = 1 and B = 4, both schedules, the kernel and the
  mask tier: the captured payload bit for bit the eager step's and the JAX
  package's ``_class_step_scan_jit`` / ``_class_step_batch_jit``.
* The other paths that call ``program`` at ``height_min = 0``: a replica's
  constants, a bank-sharded chunk and a stream-sharded round, each against
  eager and the JAX vmap program.

The warmed general step's freedom from host reads is tested beside the
lean step's, in tests/test_torch_capture.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models import bank as jbank_module
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.ops import peaks as jpeaks
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.models import bank as tbank_module
from audio_pattern_detector_tpu_torch.models import captured
from audio_pattern_detector_tpu_torch.ops import lane_greedy as tlane
from audio_pattern_detector_tpu_torch.ops import peaks as tpeaks
from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh
from audio_pattern_detector_tpu_torch.parallel.mesh import RowSharding
from tests.test_torch_capture import (
    CHUNK_S,
    CPU,
    ROWS,
    RecordingBackend,
    _bank,
    _bits,
    _clips,
    _dispatch,
    _payloads,
    _sections,
)
from tests.test_torch_peaks_full import _candidates, _t

torch.set_num_threads(1)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)


# ── The loop hooks alone ──


def _chain(k, links, m):
    """One row whose first ``links`` lanes form a suppression chain (each
    lane within ``m`` of the next, heights falling along it), so the
    parallel fixed point settles one link a round; the other lanes alive
    and far apart."""
    pos = np.zeros((1, k), dtype=np.int32)
    pos[0, :links] = np.arange(links) * (m - 1)
    pos[0, links:] = links * m + np.arange(k - links) * 3 * m
    height = np.linspace(1.0, 0.3, k, dtype=np.float32)[None, :]
    return pos, height, np.ones((1, k), dtype=bool)


CASES = {
    "parallel": lambda: _candidates(3, 64, [40, 64, 0], 4000, seed=64) + (90,),
    "parallel_largest_k": lambda: _candidates(2, 2048, [300, 2048], 200_000, seed=2048) + (600,),
    "sequential": lambda: _candidates(2, 2049, [2049, 700], 200_000, seed=2049) + (600,),
    "sequential_k3000": lambda: _candidates(2, 3000, [1200, 90], 100_000, seed=3000) + (300,),
    "sequential_no_alive": lambda: _candidates(2, 2100, [0, 0], 50_000, seed=5) + (300,),
    "parallel_no_alive": lambda: _candidates(2, 64, [0, 0], 4000, seed=6) + (90,),
    "parallel_chain": lambda: _chain(40, 12, 50) + (50,),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_hook_greedy_identical_to_host_loop_and_jax(case):
    """The filter with the stand-in's while loop gives the host loop's
    survivors and the JAX filter's, in as many iterations as the JAX loop
    takes: the bank-wide alive count for the sequential filter (none when
    no lane is alive), the rounds to the fixed point for the parallel one."""
    pos, height, alive, m = CASES[case]()
    g, k = pos.shape
    jc = jpeaks.PeakCandidates(jnp.asarray(pos), jnp.asarray(height), jnp.asarray(alive),
                               jnp.zeros(g, dtype=bool))
    tc = tpeaks.PeakCandidates(_t(pos).long(), _t(height), _t(alive), torch.zeros(g, dtype=bool))
    want = np.asarray(jpeaks.greedy_distance_filter(jc, m))
    backend = RecordingBackend()
    hooked = tpeaks.greedy_distance_filter(tc, m, loop=backend.while_loop)
    np.testing.assert_array_equal(hooked.numpy(), want)
    np.testing.assert_array_equal(tpeaks.greedy_distance_filter(tc, m).numpy(), want)
    assert backend.loops == 1
    if k > tlane.PARALLEL_GREEDY_MAX_K:
        assert backend.iterations == alive.sum(axis=1).max()
    else:
        assert backend.iterations >= 1  # the JAX loop's state starts "changed"
    if case == "parallel_chain":
        assert backend.iterations >= 6
        assert want[0, :12].tolist() == [True, False] * 6
    if alive.any():
        assert want.sum() > 0 and (want.sum(axis=1) < alive.sum(axis=1)).any()
    else:
        assert not want.any()
    # The other filter agrees through its hook as well.
    other = (tlane._greedy_distance_parallel if k > tlane.PARALLEL_GREEDY_MAX_K
             else tlane._greedy_distance_sequential)
    np.testing.assert_array_equal(
        other(tc.pos, tc.alive, m, loop=RecordingBackend().while_loop).numpy(), want)


@pytest.mark.parametrize("height_min", [0.0, -0.5])
def test_find_peaks_device_with_the_loop_hook_identical_to_jax(height_min):
    """The general tier's peak finder, past 2,048 lanes and below it, with
    the hook: JAX's alive mask and positions."""
    rng = np.random.default_rng(9)
    l, valid_len, m = 30_000, 27_000, 5
    corr = np.where(np.arange(l) < valid_len, rng.random((2, l)), 0.0).astype(np.float32)
    for k in (256, 3000):
        jcand, _ = jpeaks.find_peaks_device_fast(jnp.asarray(corr), jnp.int32(valid_len),
                                                 height_min, m, k)
        backend = RecordingBackend()
        tcand, _ = tpeaks.find_peaks_device_fast(_t(corr), valid_len, height_min, m, k,
                                                 loop=backend.while_loop)
        alive = np.asarray(jcand.alive)
        assert alive.any() and backend.iterations >= 1
        np.testing.assert_array_equal(tcand.alive.numpy(), alive)
        np.testing.assert_array_equal(tcand.pos.numpy()[alive], np.asarray(jcand.pos)[alive])


# ── The two-tier cond ──


def _verify_lanes(blocks):
    """A verifier that records each call's lanes as (first lane, width)
    (row 0's positions are 7 * lane + 1) and accepts positions not
    divisible by 3."""
    def verify_accept(p, a):
        blocks.append((int(p[0, 0]) // 7, p.shape[1]))
        return a & (p % 3 != 0)

    return verify_accept


@pytest.mark.parametrize("live", [5, 16, 17, 40], ids=lambda n: f"{n}_live")
def test_two_tier_accept_takes_each_branch(live):
    """Up to 16 live lanes in every row the small tier runs (``then_``),
    more in some row every lane, 16 at a time, the last block short
    (``else_``); the cond's accept bits equal the host decision's, and the
    warm-up form (both branches, the taken one last) gives the same
    bits."""
    kv = 40
    vpos = torch.arange(2 * kv, dtype=torch.int64).reshape(2, kv) * 7 + 1
    valive = torch.zeros((2, kv), dtype=torch.bool)
    valive[0, :live] = True
    valive[1, : min(live, 3)] = True
    host_blocks, hook_blocks, warm_blocks = [], [], []
    want = tbank_module._two_tier_accept(_verify_lanes(host_blocks), vpos, valive)
    backend = RecordingBackend()
    got = tbank_module._two_tier_accept(_verify_lanes(hook_blocks), vpos, valive,
                                        cond=backend.cond)
    warm = tbank_module._two_tier_accept(_verify_lanes(warm_blocks), vpos, valive,
                                         cond=captured.both_branches)
    small = live <= 16
    small_tier, every_lane = [(0, 16)], [(0, 16), (16, 16), (32, 8)]
    assert torch.equal(got, want) and torch.equal(warm, want)
    assert (backend.then_taken, backend.else_taken) == ((1, 0) if small else (0, 1))
    assert host_blocks == hook_blocks == (small_tier if small else every_lane)
    assert warm_blocks == (every_lane + small_tier if small else small_tier + every_lane)
    assert int(want.sum()) == len([p for p in vpos[valive].tolist() if p % 3])


# ── The captured general step against eager and JAX ──


@pytest.fixture(scope="module")
def jax_general():
    """The JAX package's scan and vmap programs at ``height_min = 0``, by
    (schedule, rows): payloads of the same f32 sections."""
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()
    cache = {}

    def payload(mode, sections, lens, metas):
        key = (mode, sections.shape[0])
        if key not in cache:
            (sw, jcls), = jbank.classes.items()
            assert jbank._metas[sw] == metas
            program = (jbank_module._class_step_scan_jit if mode == "scan"
                       else jbank_module._class_step_batch_jit)
            cache[key] = np.asarray(program(
                jnp.asarray(sections.numpy()), jnp.asarray(lens.numpy().astype(np.float32)),
                jcls["loud"], tuple((g.corr, g.verify) for g in jcls["groups"]),
                metas=metas, height_min=0.0,
            ))
        return cache[key]

    return payload


@pytest.mark.parametrize("tier", ["kernel", "mask"])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("rows", [1, 4])
def test_captured_general_step_equals_eager_and_jax(stand_in, monkeypatch, jax_general, tier,
                                                     mode, rows):
    """A bank at ``height_min = 0`` captures its general-plateau step:
    first use, then replays (the stand-in's loops and conds evaluated at
    each), payloads bit for bit the eager step's on the same bank and the
    JAX program of the same schedule. Every group's greedy runs a loop and
    its verify a two-way cond."""
    if tier == "mask":
        monkeypatch.setenv("APD_PALLAS", "0")
    bank = _bank(capture=True, height_min=0.0)
    monkeypatch.delenv("APD_PALLAS", raising=False)
    (sw, cls), = bank.classes.items()
    groups = len(cls["groups"])
    got = [_payloads(_dispatch(bank, ROWS[:rows], mode)) for _ in range(3)]
    (step,) = bank.graphs.steps()
    backend = bank.graphs._backend
    assert step.key.general and step.key.kernel_tier is (tier == "kernel")
    assert step.key.rows == (rows if mode == "vmap" else 1)
    replays = 3 * (rows if mode == "scan" else 1) - 1
    assert step.replays == backend.replays == replays and backend.captures == 1
    # One loop and one cond a group, at capture and at every replay.
    assert backend.loops == groups * (1 + replays)
    assert backend.then_taken + backend.else_taken == groups * (1 + replays)
    assert backend.iterations > 0
    bank.capture = False
    eager = _payloads(_dispatch(bank, ROWS[:rows], mode))
    assert all(np.array_equal(_bits(g[sw]), _bits(eager[sw])) for g in got)
    sections, lens = _sections(bank, sw, ROWS[:rows])
    want = jax_general(mode, sections, lens, bank._metas[sw])
    np.testing.assert_array_equal(got[-1][sw], want)
    # At a threshold of 0 every row of noise outnumbers its lanes.
    flags = [p[..., 2 * g.k_verify] for p, g in zip(
        tbank_module._split_fused(got[-1][sw], cls["groups"]), cls["groups"])]
    assert all((f == 1.0).any() for f in flags)


def test_captured_general_replica_and_shards_equal_eager_and_jax(stand_in, jax_general):
    """At ``height_min = 0``, the paths that hand ``program`` other
    constants or rows: a replica's constants (its own graph), a chunk over
    a bank sharded in two (a graph per shard's slice, each group padded to
    two rows) and a round over a stream mesh of two (the shards share the
    bank's graph). Each, eager and then captured (first use, then a
    replay), gives bit for bit the eager payload and the JAX vmap
    program's rows; the while loops and conds run at every replay."""
    bank = _bank(capture=True, height_min=0.0)
    (sw, cls), = bank.classes.items()
    groups = cls["groups"]
    sections, lens = _sections(bank, sw, ROWS)
    want = jax_general("vmap", sections, lens, bank._metas[sw])
    replica = (dataclasses.replace(cls["loud"]),
               tuple((dataclasses.replace(g.corr), dataclasses.replace(g.verify))
                     for g in groups))
    sharded = BankShardedBank(bank, make_mesh({"bank": 2}, devices=[CPU, CPU]))
    streams = RowSharding(make_mesh({"stream": 2}, devices=[CPU, CPU]), "stream")

    def bank_shards():
        dispatched = sharded.dispatch_chunk(ROWS[1][0], ROWS[1][1])
        (_, handle, *_), = dispatched
        parts = tbank_module._split_fused(handle.numpy(), groups, sharded._padded_rows[sw])
        sharded.collect_chunk(dispatched)
        return np.concatenate([p.reshape(-1) for p in parts])

    paths = {
        "replica": (lambda: bank.step(sw, sections, lens, consts=replica).numpy().copy(), want),
        "bank_shards": (bank_shards, want[1]),
        "stream_shards": (lambda: _payloads(bank.dispatch_chunks_batch(
            [c for c, _ in ROWS], None, mode="vmap", prev_tails=[t for _, t in ROWS],
            sharding=streams))[sw], want),
    }
    for name, (run, jax_payload) in paths.items():
        bank.capture = False
        eager = run()
        bank.capture = True
        loops = bank.graphs._backend.loops if bank.graphs.steps() else 0
        got = [run(), run()]
        for g in got:
            assert np.array_equal(_bits(g), _bits(eager)), name
        np.testing.assert_array_equal(got[-1], jax_payload, err_msg=name)
        assert bank.graphs._backend.loops > loops, name
    steps = bank.graphs.steps()
    assert all(s.key.general for s in steps)
    # The replica's (B = 4) graph, one per bank shard (B = 1), and the
    # bank's own (B = 2) graph, which both stream shards replay.
    assert sorted((s.key.rows, s.replays) for s in steps) == [(1, 1), (1, 1), (2, 3), (4, 1)]
    assert len({s.key.consts for s in steps}) == 4
