"""A row's results do not depend on the round it rides in.

The JAX package's tiers give one row the same bits in scan, vmap and
streaming (``tests/test_offline_scan.py``). The port holds every
floating-point result of its class step to that, per row, whatever the
round: its width, its schedule ("scan" runs one section at a time in the
single-section form, "vmap" the batched form), the row's index in it, and
the number of clips the call carries (the class step against the row
rerun). On the CPU, with no tolerance:

* one row's LUFS, normalised section, |correlation| of each group and
  payload, alone and at every index of rounds of 3 and 17 rows, equal the
  row's single-section results bit for bit;
* the same row dispatched through the bank in "scan" and in "vmap" gives
  the payload of the row dispatched alone;
* the row rerun's correlation row (one clip's constants) equals the class
  step's row of that clip, and its wide-tier payload equals the class
  rerun's row;
* the gating's plain version (``ops/loudness.py::loudness_gate_reference``,
  the trees of ``csrc/loudness_gate.cu``) against the JAX
  ``integrated_loudness_device`` at ``LUFS_ATOL`` on silent, short
  (< 400 ms, < 500 ms) and partial-block rows, at 8 and 16 kHz and at a
  rate whose blocks do not fall on a 100 ms grid.

What makes it hold on a card, where cuFFT picks its algorithm per plan and
the gating is a kernel: ``ops/cufft_plans.py`` and chip_smoke's
``round_invariance`` phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.ops import loudness as jloud
from audio_pattern_detector_tpu_torch.models.bank import class_step
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.ops import correlate as tcorr
from audio_pattern_detector_tpu_torch.ops import loudness as tloud
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

torch.set_num_threads(1)

SR = 8000
CHUNK_S = 4
LUFS_ATOL = 1e-3  # the port's gating against the JAX op (tests/test_torch_ops.py)
WIDTHS = (1, 3, 17)


def _clips():
    """Two groups of two clips: 0.6 s normal clips and 0.25 s marker tones."""
    t = np.arange(int(0.6 * SR)) / SR
    tm = np.arange(int(0.25 * SR)) / SR
    clips = [
        AudioClip(name=f"c{f}", sample_rate=SR, audio=(
            0.5 * np.sin(2 * np.pi * f * t) * np.hanning(len(t))).astype(np.float32))
        for f in (640.0, 880.0)
    ]
    return clips + [
        AudioClip(name=f"m{f}", audio=np.sin(2 * np.pi * f * tm).astype(np.float32),
                  sample_rate=SR, strategy=MARKER_TONE_STRATEGY,
                  strategy_params={"dominant_frequency_hz": f})
        for f in (941.0, 1040.0)
    ]


@pytest.fixture(scope="module")
def bank():
    return TorchAudioPatternDetector(_clips(), device="cpu",
                                     seconds_per_chunk=CHUNK_S)._ensure_bank()


def _rows(s_len, count, seed):
    """``count`` seeded sections of ``s_len`` samples: row 0 holds a hit of
    each clip; the others vary in level and length (full, partial, short,
    silent), zero past their lengths."""
    clip, tone = (_clips()[i].audio for i in (0, 2))
    rng = np.random.default_rng(seed)
    lens = [s_len] + [int(x) for x in rng.choice(
        [s_len, s_len - 1, s_len // 2 + 77, 3000, 0, 2500], size=count - 1)]
    rows = np.zeros((count, s_len), np.float32)
    for i, n in enumerate(lens):
        rows[i, :n] = (rng.uniform(0.002, 0.05) * rng.standard_normal(n)).astype(np.float32)
    rows[0, SR : SR + len(clip)] += clip
    rows[0, 3 * SR : 3 * SR + len(tone)] += 0.8 * tone
    return rows, np.array(lens, dtype=np.int32)


def _step(bank, sections, n_valid):
    """LUFS, normalised section, each group's |correlation| and payload of a
    single section (``n_valid`` an int) or a round (a (B,) tensor)."""
    (sw, cls), = bank.classes.items()
    consts = tuple((g.corr, g.verify) for g in cls["groups"])
    lufs = tloud.integrated_loudness_device(sections, n_valid, cls["loud"])
    norm = tloud.loudness_normalize_device(sections, lufs)
    spec = tcorr.section_segment_spectra(norm, consts[0][0])
    corr = [tcorr.bank_correlate_abs(norm, n_valid, c, spec)[0] for c, _ in consts]
    payload = class_step(sections, n_valid, cls["loud"], consts, metas=bank._metas[sw],
                         height_min=bank.height_min)
    return lufs, norm, corr, payload


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("width", WIDTHS)
def test_a_row_is_the_same_at_every_width_and_index(bank, width):
    (sw, cls), = bank.classes.items()
    s_len = cls["section_len"]
    pool, lens = _rows(s_len, max(WIDTHS), seed=width)
    alone = [_step(bank, torch.from_numpy(pool[i]), int(lens[i])) for i in range(width)]
    assert np.isfinite(float(alone[0][0])) and np.isneginf(
        [float(a[0]) for a, n in zip(alone, lens) if n == 0]).all()
    for index in range(width):
        order = list(range(1, width))
        order.insert(index, 0)  # row 0, the hit-bearing row, at ``index``
        sections = torch.from_numpy(pool[order])
        lufs, norm, corr, payload = _step(bank, sections, torch.from_numpy(lens[order]))
        for at, row in enumerate(order):
            l1, n1, c1, p1 = alone[row]
            assert _same(lufs[at], l1) and _same(norm[at], n1)
            for c, one in zip(corr, c1):
                assert _same(c[at], one)
            for p, one, g in zip(payload, p1, cls["groups"]):
                n = len(g.names)
                assert _same(p[at * n : (at + 1) * n], one)


@pytest.mark.parametrize("width", WIDTHS)
def test_a_rows_payload_is_the_same_in_both_schedules(bank, width):
    """The bank's dispatch of a round of int16 chunks (the first a first
    chunk, the rest with a tail) in "scan" and "vmap": every row's payload
    is the row's dispatched alone."""
    (sw, cls), = bank.classes.items()
    chunk = CHUNK_S * SR
    rng = np.random.default_rng(7 + width)
    audio = (0.01 * rng.standard_normal(chunk * (width + 1))).astype(np.float32)
    clip = _clips()[0].audio
    audio[chunk + 1234 : chunk + 1234 + len(clip)] += clip
    pcm = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    chunks = [pcm[i * chunk : (i + 1) * chunk] for i in range(width)]
    tails = [None] + chunks[:-1]
    alone = [bank.dispatch_chunk(c, t) for c, t in zip(chunks, tails)]
    for mode in ("scan", "vmap"):
        got = bank.dispatch_chunks_batch(chunks, None, mode=mode, prev_tails=tails)
        for bi, one in enumerate(alone):
            for (_, ha, *_), (_, hb, *_) in zip(one, got):
                np.testing.assert_array_equal(ha.numpy().view(np.int32),
                                              hb.numpy()[bi].view(np.int32))


def test_the_row_rerun_correlates_as_the_class_step(bank):
    """The row rerun correlates one clip with constants of its own (G = 1):
    its row equals the class step's row of that clip, raw and normalised,
    and its wide-tier payload equals the class rerun's row."""
    (sw, cls), = bank.classes.items()
    s_len = cls["section_len"]
    rows, lens = _rows(s_len, 2, seed=3)
    raw = rows[0, : lens[0]]
    class_rerun = bank._full_tier_packed(sw, raw)
    n_valid, section = int(lens[0]), torch.from_numpy(rows[0])
    norm = tloud.loudness_normalize_device(
        section, tloud.integrated_loudness_device(section, n_valid, cls["loud"]))
    for gi, g in enumerate(cls["groups"]):
        for ci in range(len(g.names)):
            row_consts, _ = bank._row_consts_for(sw, gi, ci)
            for correlate in (tcorr.bank_correlate, tcorr.bank_correlate_abs):
                whole, _ = correlate(norm, n_valid, g.corr)
                one, _ = correlate(norm, n_valid, row_consts)
                assert one.shape[0] == 1 and _same(one[0], whole[ci])
            packed = bank._full_tier_row(sw, gi, ci, raw)
            np.testing.assert_array_equal(packed.view(np.int32),
                                          class_rerun[gi][ci].view(np.int32))


@pytest.mark.parametrize("sr", [8000, 16000, 6004])
def test_the_gating_plain_version_against_jax(sr):
    """At 6,004 Hz some blocks end a sample off the 100 ms grid, so a block
    is 4 or 5 pieces. Rows: full, silent, partial blocks, 300 ms and 450 ms
    (the short form's single block), and a row shorter than one block."""
    s_len = 5 * sr
    jc = jloud.build_loudness_consts(s_len, sr)
    tc = tloud.build_loudness_consts(s_len, sr, torch.device("cpu"))
    bounds = tc.piece_bounds.numpy()
    first, count = tc.block_first.numpy(), tc.block_pieces.numpy()
    np.testing.assert_array_equal(bounds[first], tc.block_lo.numpy())
    np.testing.assert_array_equal(bounds[first + count], tc.block_end.numpy())
    assert set(count.tolist()) == ({4} if sr % 10 == 0 else {4, 5})
    lens = np.array([s_len, 0, s_len // 2 + 333, int(0.3 * sr), int(0.45 * sr), s_len - 1,
                     int(0.35 * sr) + 600, s_len], dtype=np.int32)
    rng = np.random.default_rng(sr)
    rows = np.zeros((len(lens), s_len), np.float32)
    for i, n in enumerate(lens[:-1]):
        rows[i, :n] = (0.05 * (i + 1) * rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(jax.vmap(jloud.integrated_loudness_device, in_axes=(0, 0, None))(
        jnp.asarray(rows), jnp.asarray(lens), jc))
    filtered = tloud._k_weighted_conv(torch.from_numpy(rows), tc)
    got = tloud.loudness_gate_reference(filtered, torch.from_numpy(lens), tc).numpy()
    silent = np.isneginf(want)
    assert silent.tolist() == [False, True] + [False] * 5 + [True]
    np.testing.assert_array_equal(np.isneginf(got), silent)
    np.testing.assert_allclose(got[~silent], want[~silent], rtol=0, atol=LUFS_ATOL)
    # The wrapper takes the plain version for CPU tensors, and a row's LUFS
    # is its own whatever rows ride beside it.
    assert _same(tloud.loudness_gate(filtered, torch.from_numpy(lens), tc), torch.from_numpy(got))
    for i in range(len(lens)):
        one = tloud.loudness_gate(filtered[i : i + 1], torch.from_numpy(lens[i : i + 1]), tc)
        assert _same(one[0], torch.from_numpy(got)[i])
