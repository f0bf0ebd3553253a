"""The gating kernel's launch around its arithmetic, on the CPU.

``csrc/loudness_gate.cu`` runs only on a card (``tests/test_torch_cuda.py``
holds it bitwise to its plain version there). What decides its results
besides the sum trees is plain Python or can be modelled in it:

* the launch geometry (``ops/loudness.py::gate_ctas_per_row``,
  ``gate_cta_pieces``): every piece of every row summed by exactly one
  CTA, and how a row is split set by its piece count alone, whatever the
  round's width;
* the row ticket: whatever order the CTAs finish in, exactly one of a row's
  CTAs finishes it, the last to arrive (a model of the kernel's
  ``atomicAdd`` after the memset that starts every call);
* the plain version (the trees the kernel computes): a row's LUFS the same
  at every index of rounds of width 1 to 17;
* the wrapper (a stand-in library): the geometry and buffers it passes,
  launches counted only where the library reports success, a CUDA error
  raised with no plain version run in its place.
"""

import functools
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_pattern_detector_tpu_torch.kernels import _build
from audio_pattern_detector_tpu_torch.ops import loudness as tl

torch.set_num_threads(1)

# Piece counts: fewer than one CTA sums, one CTA exactly, one over, 8 kHz
# and 44.1 kHz at 61 s, 6,004 Hz at 61 s, a 420 s section.
PIECE_COUNTS = (1, 6, 8, 9, 611, 651, 4205)
WIDTHS = (1, 3, 17, 64)


def _covered(pieces: int, rows: int) -> np.ndarray:
    """How often the kernel's grid sums each (row, piece)."""
    seen = np.zeros((rows, pieces), np.int64)
    for block in range(tl.gate_ctas_per_row(pieces) * rows):
        row, own = tl.gate_cta_pieces(block, pieces)
        assert 1 <= len(own) <= tl.GATE_PIECES_PER_CTA
        seen[row, own.start : own.stop] += 1
    return seen


@pytest.mark.parametrize("pieces", PIECE_COUNTS)
def test_the_grid_sums_every_piece_once(pieces):
    cpr = tl.gate_ctas_per_row(pieces)
    assert (cpr - 1) * tl.GATE_PIECES_PER_CTA < pieces <= cpr * tl.GATE_PIECES_PER_CTA
    for rows in WIDTHS:
        assert (_covered(pieces, rows) == 1).all()


@settings(max_examples=60, deadline=None)
@given(pieces=st.integers(1, 5000), rows=st.integers(1, 70), row=st.integers(0, 69))
def test_a_rows_split_depends_on_its_pieces_alone(pieces, rows, row):
    """The CTAs of row ``row`` hold the same pieces in the same order in a
    round of any width: the split is the one-row round's."""
    row %= rows
    cpr = tl.gate_ctas_per_row(pieces)
    alone = [tl.gate_cta_pieces(c, pieces)[1] for c in range(cpr)]
    in_round = [tl.gate_cta_pieces(row * cpr + c, pieces) for c in range(cpr)]
    assert in_round == [(row, own) for own in alone]
    assert [p for own in alone for p in own] == list(range(pieces))


def _atomic_add(tickets: np.ndarray, row: int) -> int:
    """CUDA's atomicAdd(&tickets[row], 1): returns the old value."""
    old = int(tickets[row])
    tickets[row] = old + 1
    return old


@pytest.mark.parametrize("pieces,rows", [(6, 1), (9, 3), (611, 17), (651, 64)])
def test_the_last_cta_of_a_row_finishes_it_in_any_order(pieces, rows):
    cpr = tl.gate_ctas_per_row(pieces)
    rng = np.random.default_rng(pieces)
    tickets = np.full(rows, 7, np.int64)  # a buffer an earlier call left
    for _ in range(5):  # calls on the same buffer (a graph's replays)
        tickets[:] = 0  # the memset before every launch
        order = rng.permutation(cpr * rows)
        finishers, arrived = {}, np.zeros(rows, np.int64)
        for block in order:
            row, _ = tl.gate_cta_pieces(int(block), pieces)
            arrived[row] += 1
            if _atomic_add(tickets, row) == cpr - 1:
                assert row not in finishers
                finishers[row] = arrived[row]
        assert sorted(finishers) == list(range(rows))
        assert all(n == cpr for n in finishers.values())  # every piece written before
        assert (tickets == cpr).all()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), width=st.integers(1, 17), data=st.data())
def test_the_plain_version_gives_a_row_the_same_lufs_at_every_index(seed, width, data):
    """Rows of 2 s at 8 kHz with lengths from 0 to the whole section (the
    short form under 0.5 s, partial blocks above it): the row at any index
    of a round of ``width`` rows gets the LUFS it gets alone."""
    sr, s = 8000, 16_000
    consts = _consts(s, sr)
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, s + 1, width).astype(np.int32)
    lens[rng.random(width) < 0.3] = s
    x = (rng.uniform(0.001, 0.3, (width, 1)) * rng.standard_normal((width, s))).astype(np.float32)
    x[np.arange(s)[None, :] >= lens[:, None]] = 0.0
    filtered = tl._k_weighted_conv(torch.from_numpy(x), consts)
    n = torch.from_numpy(lens)
    got = tl.loudness_gate_reference(filtered, n, consts).numpy()
    index = data.draw(st.integers(0, width - 1))
    alone = tl.loudness_gate_reference(filtered[index : index + 1], n[index : index + 1], consts)
    assert alone.numpy().tobytes() == got[index : index + 1].tobytes()


@functools.cache
def _consts(s: int, sr: int) -> tl.LoudnessConsts:
    return tl.build_loudness_consts(s, sr, torch.device("cpu"))


def _stub(monkeypatch, code: int) -> list:
    """A stand-in library whose gate returns ``code``; the calls' arguments."""
    calls = []

    def gate(*args):
        calls.append(args)
        return code

    lib = types.SimpleNamespace(apd_loudness_gate=gate)
    monkeypatch.setattr(_build, "load_kernels", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("rows", WIDTHS)
def test_the_wrapper_passes_the_geometry_and_its_buffers(monkeypatch, rows):
    """The launch path with a stand-in library: ceil(P / 8) CTAs a row,
    the workspace of (P + 2 nblk) floats a row and a ticket a row, each its
    own buffer, the row stride; one launch counted."""
    consts = _consts(61 * 8000, 8000)
    calls = _stub(monkeypatch, 0)
    filtered = torch.zeros((rows, consts.section_len))
    n = torch.full((rows,), consts.section_len, dtype=torch.int32)
    before = tl.loudness_gate.launches
    out = tl._launch(filtered, n, consts)
    assert out.shape == (rows,) and tl.loudness_gate.launches == before + 1
    (args,) = calls
    pieces, blocks = consts.piece_bounds.shape[0] - 1, consts.block_lo.shape[0]
    assert (pieces, blocks, tl.gate_ctas_per_row(pieces)) == (611, 607, 77)
    assert args[1:4] == (rows, consts.section_len, consts.section_len)
    assert args[6:9] == (pieces, consts.piece_chunks, 77) and args[14] == blocks
    assert len({args[16], args[17], args[18]}) == 3  # workspace, tickets, out apart
    assert args[18] == out.data_ptr()
    tl.loudness_gate.launches = before


def test_a_failed_launch_raises_and_runs_no_plain_version(monkeypatch):
    consts = _consts(16_000, 8000)
    _stub(monkeypatch, 700)
    monkeypatch.setattr(tl, "loudness_gate_reference", lambda *a: pytest.fail("fell back"))
    before = tl.loudness_gate.launches
    with pytest.raises(RuntimeError, match="loudness_gate kernel launch failed: CUDA error 700"):
        tl._launch(torch.zeros((2, 16_000)), torch.zeros(2, dtype=torch.int32), consts)
    assert tl.loudness_gate.launches == before
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("reached the library"))
    with pytest.raises(ValueError, match="rows must be"):
        tl._launch(torch.zeros((2, 15_999)), torch.zeros(2, dtype=torch.int32), consts)
    with pytest.raises(ValueError, match="n_valid"):
        tl._launch(torch.zeros((2, 16_000)), torch.zeros(3, dtype=torch.int32), consts)
    with pytest.raises(ValueError, match="unsupported device"):
        tl.loudness_gate(torch.zeros((2, 16_000), device="meta"),
                         torch.zeros(2, dtype=torch.int32, device="meta"), consts)
