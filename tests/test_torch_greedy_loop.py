"""The lean greedy's ``lax.while_loop`` as a while node, on the CPU.

The JAX lean tier runs the block-wise greedy's rounds in a
``lax.while_loop`` by default (``APD_GREEDY_UNROLL`` unset or "0", JAX
``ops/peaks.py:542-565``): it exits once every row is exhausted or
``r_max`` rounds have run. ``APD_GREEDY_UNROLL=1`` unrolls the ``r_max``
rounds, with identical results. The port's
``greedy_survivors_from_blocks`` takes a ``loop(pred, body)`` hook for the
first form (a captured lean step always passes a CUDA while node) and runs
the second without it (the eager step); the port does not read the
switch. Here the stand-in graph backend of
tests/test_torch_capture.py takes the card's place; its ``while_loop``
reads the predicate at every pass and counts the passes.

* The greedy alone, hooked and unrolled, against the JAX function with
  ``unroll=False`` and ``unroll=True``: no candidate in any row (no pass),
  fewer survivors than ``r_max`` (a pass a survivor), exactly ``r_max``,
  overflow, a refused round (a seed the gathered block does not reach) and
  rows that finish at different rounds.
* The captured lean step at B = 1 and B = 4, both schedules, the kernel and
  the mask tier, built under ``APD_GREEDY_UNROLL`` "0" and "1": payloads
  bit for bit the eager step's and the JAX ``_class_step_scan_jit`` /
  ``_class_step_batch_jit`` under the same switch; either value gives the
  port's bank the same key and the while loop; a candidate-free section
  passes the loop no time.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models import bank as jbank_module
from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.ops import peaks as jpeaks
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.models import captured
from audio_pattern_detector_tpu_torch.models.bank import _split_fused
from audio_pattern_detector_tpu_torch.ops import peaks as tpeaks
from tests.test_torch_capture import (
    CHUNK_S,
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

R_MAX, M, BLOCK, L = 4, 40, 64, 1024


def _scored(rows_peaks, seed=0):
    """(G, L) scored rows: -inf but at each row's (position, height)
    candidates, plus a little seeded jitter on the heights."""
    rng = np.random.default_rng(seed)
    scored = np.full((len(rows_peaks), L), -np.inf, dtype=np.float32)
    for g, peaks in enumerate(rows_peaks):
        for pos, h in peaks:
            scored[g, pos] = np.float32(h + 1e-3 * rng.random())
    return scored


def _spread(n, start=10, gap=2 * M):
    """n candidates ``gap`` apart, falling heights: n survivors."""
    return [(start + i * gap, 1.0 - 0.05 * i) for i in range(n)]


# name: (rows' candidates, passes of the loop)
CASES = {
    "no_candidate": ([[], []], 0),
    "fewer_than_r_max": ([_spread(2), _spread(1, start=300)], 2),
    "exactly_r_max": ([_spread(R_MAX)], R_MAX),
    "overflow": ([_spread(R_MAX + 3), _spread(1)], R_MAX),
    # Each row's last survivor suppresses its neighbours: row 0 keeps 3 of 5
    # candidates, row 1 keeps 1 of 2, so they finish at rounds 3 and 1.
    "rows_finish_apart": ([[(100, 0.9), (120, 0.5), (300, 0.8), (330, 0.4), (700, 0.7)],
                           [(500, 0.6), (510, 0.3)]], 3),
}


def _jax_gather(padded):
    def gather(b_idx):
        vals = jnp.take_along_axis(padded.reshape(padded.shape[0], -1, BLOCK),
                                   b_idx[:, None, None], axis=1)[:, 0]
        return vals, b_idx[:, None] * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)[None, :]
    return gather


def _torch_gather(padded):
    def gather(b_idx):
        vals = padded.reshape(padded.shape[0], -1, BLOCK)[torch.arange(padded.shape[0]), b_idx]
        return vals, b_idx[:, None] * BLOCK + torch.arange(BLOCK)[None, :]
    return gather


def _both_forms_and_jax(bwork0, scored):
    """(hooked, unrolled, backend, jax unroll=False, jax unroll=True) of
    ``greedy_survivors_from_blocks`` over ``scored``'s blocks, each
    (pos, height, overflow) as numpy."""
    t, j = torch.from_numpy(scored), jnp.asarray(scored)
    backend = RecordingBackend()
    hooked = tpeaks.greedy_survivors_from_blocks(
        torch.from_numpy(bwork0), _torch_gather(t), M, R_MAX, BLOCK, loop=backend.while_loop)
    unrolled = tpeaks.greedy_survivors_from_blocks(
        torch.from_numpy(bwork0), _torch_gather(t), M, R_MAX, BLOCK)
    jax_forms = [jpeaks.greedy_survivors_from_blocks(
        jnp.asarray(bwork0), _jax_gather(j), M, R_MAX, BLOCK, unroll=unroll)
        for unroll in (False, True)]
    as_np = lambda out: tuple(np.asarray(x) for x in out)  # noqa: E731
    return as_np(hooked), as_np(unrolled), backend, *map(as_np, jax_forms)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.astype(np.int64) if x.dtype != np.float32 else x,
                                      y.astype(np.int64) if y.dtype != np.float32 else y)


@pytest.mark.parametrize("case", list(CASES))
def test_hooked_greedy_equals_unrolled_and_both_jax_forms(case):
    """The while-loop form against the unrolled one and against JAX's
    ``lax.while_loop`` and unrolled rounds: survivors, heights, sentinels
    past each row's last survivor, overflow; the stand-in's passes are the
    JAX loop's (none without a candidate)."""
    rows_peaks, passes = CASES[case]
    scored = _scored(rows_peaks)
    bwork0 = scored.reshape(len(rows_peaks), -1, BLOCK).max(axis=2)
    hooked, unrolled, backend, jax_loop, jax_unrolled = _both_forms_and_jax(bwork0, scored)
    for form in (unrolled, jax_loop, jax_unrolled):
        _same(hooked, form)
    pos, height, overflow = hooked
    assert backend.loops == 1 and backend.iterations == passes
    kept = np.isfinite(height)
    assert (pos[~kept] == tpeaks.SURVIVOR_POS_SENTINEL).all()
    counts = kept.sum(axis=1).tolist()
    want = {"no_candidate": [0, 0], "fewer_than_r_max": [2, 1], "exactly_r_max": [R_MAX],
            "overflow": [R_MAX, 1], "rows_finish_apart": [3, 1]}[case]
    assert counts == want
    assert overflow.tolist() == [case == "overflow" and g == 0 for g in range(len(rows_peaks))]


def test_a_refused_round_runs_to_r_max_with_overflow():
    """A seed the gathered block does not reach (row 0's second block says
    more than its candidates hold) refuses that row's round: it keeps
    nothing there and suppresses nothing, its block stays finite, and the
    loop runs all ``r_max`` passes, ending with ``overflow`` on that row
    only, as in both JAX forms."""
    scored = _scored([_spread(1, start=10) + [(BLOCK + 5, 0.5)], _spread(2, start=200)])
    bwork0 = scored.reshape(2, -1, BLOCK).max(axis=2)
    bwork0[0, 1] = np.float32(0.75)  # the block's true max is 0.5
    hooked, unrolled, backend, jax_loop, jax_unrolled = _both_forms_and_jax(bwork0, scored)
    for form in (unrolled, jax_loop, jax_unrolled):
        _same(hooked, form)
    pos, height, overflow = hooked
    assert backend.iterations == R_MAX
    assert overflow.tolist() == [True, False]
    assert np.isfinite(height[0]).sum() == 1 and np.isfinite(height[1]).sum() == 2


def test_the_blockwise_greedy_passes_the_hook_on():
    """``greedy_survivors_blockwise`` (the mask tier's) with the hook: the
    unrolled survivors and JAX's, one pass a survivor."""
    scored = _scored([_spread(3), _spread(1, start=600)])
    backend = RecordingBackend()
    hooked = tpeaks.greedy_survivors_blockwise(torch.from_numpy(scored), M, R_MAX, BLOCK,
                                               loop=backend.while_loop)
    unrolled = tpeaks.greedy_survivors_blockwise(torch.from_numpy(scored), M, R_MAX, BLOCK)
    want = jpeaks.greedy_survivors_blockwise(jnp.asarray(scored), M, R_MAX, BLOCK, unroll=False)
    _same(tuple(np.asarray(x) for x in hooked), tuple(np.asarray(x) for x in unrolled))
    _same(tuple(np.asarray(x) for x in hooked), tuple(np.asarray(x) for x in want))
    assert backend.iterations == 3


# ── The captured lean step under each form ──


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(captured.StepGraphs, "backend", RecordingBackend)


@pytest.fixture(scope="module")
def jax_programs():
    """The JAX scan and vmap programs by (schedule, rows, APD_GREEDY_UNROLL):
    each traced anew under its switch, which JAX reads at trace time."""
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in _clips()]
    jbank = AudioPatternDetector(jclips, seconds_per_chunk=CHUNK_S)._ensure_bank()
    (sw, jcls), = jbank.classes.items()
    cache = {}
    programs = {"scan": jbank_module._class_step_scan_jit,
                "vmap": jbank_module._class_step_batch_jit}

    def payload(mode, sections, lens, metas, unroll, monkeypatch):
        key = (mode, sections.shape[0], unroll)
        if key not in cache:
            assert jbank._metas[sw] == metas
            monkeypatch.setenv("APD_GREEDY_UNROLL", unroll)
            programs[mode].clear_cache()
            cache[key] = np.asarray(programs[mode](
                jnp.asarray(sections.numpy()), jnp.asarray(lens.numpy().astype(np.float32)),
                jcls["loud"], tuple((g.corr, g.verify) for g in jcls["groups"]),
                metas=metas, height_min=jbank.height_min,
            ))
            programs[mode].clear_cache()
            monkeypatch.delenv("APD_GREEDY_UNROLL")
        return cache[key]

    return payload


@pytest.mark.parametrize("unroll", ["0", "1"], ids=["while_loop", "unrolled"])
@pytest.mark.parametrize("tier", ["kernel", "mask"])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("rows", [1, 4])
def test_captured_lean_step_under_each_form_equals_eager_and_jax(
        stand_in, monkeypatch, jax_programs, tier, mode, rows, unroll):
    """First use, then replays: payloads bit for bit the eager step's and
    the JAX program's of the same schedule under ``unroll``, the JAX
    program's form (the kernel tier's near-collapse flag aside, which the
    XLA mask lacks). The port's bank, built under the same switch, does not
    read it: its step passes each group's loop at capture and at every
    replay."""
    monkeypatch.setenv("APD_GREEDY_UNROLL", unroll)
    if tier == "mask":
        monkeypatch.setenv("APD_PALLAS", "0")
    bank = _bank(capture=True)
    monkeypatch.delenv("APD_PALLAS", raising=False)
    monkeypatch.delenv("APD_GREEDY_UNROLL")
    (sw, cls), = bank.classes.items()
    groups = len(cls["groups"])
    got = [_payloads(_dispatch(bank, ROWS[:rows], mode)) for _ in range(3)]
    (step,) = bank.graphs.steps()
    assert not step.key.general
    assert step.key.kernel_tier is (tier == "kernel")
    replays = 3 * (rows if mode == "scan" else 1) - 1
    backend = bank.graphs._backend
    assert step.replays == backend.replays == replays
    assert backend.loops == groups * (1 + replays)
    assert backend.iterations > 0
    bank.capture = False
    eager = _payloads(_dispatch(bank, ROWS[:rows], mode))
    assert all(np.array_equal(_bits(g[sw]), _bits(eager[sw])) for g in got)
    sections, lens = _sections(bank, sw, ROWS[:rows])
    want = jax_programs(mode, sections, lens, bank._metas[sw], unroll, monkeypatch)
    hits = 0
    for g, packed, jpacked in zip(cls["groups"], _split_fused(got[-1][sw], cls["groups"]),
                                  _split_fused(want, cls["groups"])):
        k = g.k_verify
        hits += int((packed[..., k : 2 * k] != 0).any(axis=-1).sum())
        if tier == "kernel":
            packed = packed.copy()
            packed[(packed[..., 2 * k] == 2.0) & (jpacked[..., 2 * k] == 0.0), 2 * k] = 0.0
        np.testing.assert_array_equal(packed, jpacked)
    assert hits >= 1


def test_one_process_builds_both_forms_and_a_silent_section_passes_no_round(
        stand_in, monkeypatch):
    """Two banks built under each value of the JAX switch capture one key
    (their constants aside), both with the while loop, and the same
    payloads; a section without a candidate passes each group's loop no
    time, and one with hits passes it once a survivor at least."""
    banks = {}
    for unroll in ("0", "1"):
        monkeypatch.setenv("APD_GREEDY_UNROLL", unroll)
        banks[unroll] = _bank(capture=True)
    monkeypatch.delenv("APD_GREEDY_UNROLL")
    (sw, _), = banks["0"].classes.items()
    silent = _audio(11, CHUNK_S + 1.0).astype(np.float32)
    hits = _audio(14, CHUNK_S + 1.0, normal=(3.0,), marker=(7.5,)).astype(np.float32)
    payloads = {}
    for unroll, bank in banks.items():
        bank.step(sw, torch.from_numpy(silent), len(silent))  # first use: eager, capture
        backend = bank.graphs._backend
        before = (backend.loops, backend.iterations)
        payloads[unroll] = [bank.step(sw, torch.from_numpy(x), len(x)) for x in (silent, hits)]
        # The silent replay's loops pass no time; the hit-bearing one's do.
        assert backend.loops - before[0] == 2 * 2
        assert backend.iterations - before[1] >= 2
    (k0,), (k1,) = banks["0"].graphs.steps(), banks["1"].graphs.steps()
    assert k0.key._replace(consts=()) == k1.key._replace(consts=())
    for a, b in zip(payloads["0"], payloads["1"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # The silent section alone: a replay passes no round in either group.
    for bank in banks.values():
        backend = bank.graphs._backend
        before = (backend.loops, backend.iterations)
        bank.step(sw, torch.from_numpy(silent), len(silent))
        assert (backend.loops - before[0], backend.iterations - before[1]) == (2, 0)
    assert not math.isnan(float(payloads["0"][0].sum()))
