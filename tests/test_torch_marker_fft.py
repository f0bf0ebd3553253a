"""The fused marker kernel's transforms on the CPU (``ops/marker_fft.py``,
``csrc/verify_marker.cu``).

The kernel makes a live lane's spectra itself: a real window of n samples
is a complex transform of n / 2 points (n even) or n points, as a
mixed-radix Stockham FFT or, past the radices' primes, Bluestein's
chirp-z transform. Here, with the kernel's arithmetic transliterated in
numpy (``chip_smoke.np_rfft_magnitudes``, ``np_marker_spectra``):

* the plan ``real_plan`` gives a length (its radix sequence, or Bluestein
  with its power-of-two length) against an independent numpy
  factorisation, at every clip length the repo's marker clips give at 8
  and 16 kHz (1,223 / 1,224 / 1,827 / 2,000 and their doubles), their
  frame lengths (200, 400) and a hypothesis range of m from 32 to 20,000;
* the transliterated magnitudes against ``np.fft.rfft`` in f64, within
  ``RTOL`` (1e-5) of each window's largest bin: f32 rounding over a dozen
  passes, about 3e-7 on these inputs;
* the lane layouts (shared memory or a global workspace) and the plan
  tables a captured graph reads surviving the plan cache's eviction;
* accept bits decided from the transliterated spectra equal to the plain
  verifier's on every marker lane the regression corpus's captures verify.

Every test runs in seconds on the CPU. On the card the kernel's own
magnitudes are held to the exact rfft by ``chip_smoke.py``'s
``verify_kernels`` phase and to the transliteration by
``tests/test_torch_cuda.py -k verify_marker``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_pattern_detector_tpu_torch.ops import marker_fft
from audio_pattern_detector_tpu_torch.ops import verify_marker as tvm
from audio_pattern_detector_tpu_torch.ops.tone import frame_grid
from chip_smoke import (
    np_marker_decisions,
    np_marker_spectra,
    np_rfft_magnitudes,
    recorded_verify_inputs,
    regression_cases,
)

torch.set_num_threads(1)

RTOL = 1e-5  # of a window's largest magnitude
REPO_LENGTHS = (1223, 1224, 1827, 2000, 2446, 2448, 3654, 4000, 200, 400)


def np_plan(n: int) -> tuple:
    """(half, N, M, radices) of a real length n, from a factorisation of
    its own: N = n / 2 for even n; the power of two in N as 8s, then a 4 or
    a 2, then N's odd primes in ascending order; Bluestein (M the least
    power of two at or past 2N - 1, its radices by the same rule) where N
    has a prime factor past 31."""
    half = n % 2 == 0
    size = n // 2 if half else n

    def split(x: int) -> "list[int] | None":
        twos = 0
        while x % 2 == 0:
            x //= 2
            twos += 1
        out = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
        p = 3
        while x > 1:
            while x % p == 0:
                out.append(p)
                x //= p
            p += 2
        return out if all(r <= 31 for r in out) else None

    rad = split(size)
    if rad is not None:
        return half, size, 0, tuple(rad)
    m = 1
    while m < 2 * size - 1:
        m *= 2
    return half, size, m, tuple(split(m))


def _windows(n: int, rng, count: int = 3) -> np.ndarray:
    """Hann-weighted noise and a tone, as the verifier's windows are."""
    t = np.arange(n)
    x = rng.standard_normal((count, n)) * 0.05
    x[0] += 0.8 * np.sin(2 * np.pi * rng.uniform(0.01, 0.49) * t)
    return (x * np.hanning(n)).astype(np.float32)


def _assert_magnitudes(n: int, rng) -> None:
    x = _windows(n, rng)
    got = np_rfft_magnitudes(x, marker_fft.real_plan(n)).astype(np.float64)
    want = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1))
    err = np.abs(got - want).max(axis=-1) / want.max(axis=-1)
    assert (err <= RTOL).all(), (n, err)


@pytest.mark.parametrize("n", REPO_LENGTHS)
def test_the_repo_lengths_plan_and_transform(n):
    """The marker clips' lengths at 8 and 16 kHz and their frame lengths:
    ``real_plan`` equals the factorisation, and the transliterated
    magnitudes equal np.fft.rfft's within RTOL. 1,223 (a prime) and 2,446
    take Bluestein through 4,096 points; 1,224 and 1,827 radices of 17 and
    29."""
    plan = marker_fft.real_plan(n)
    assert (plan.half, plan.size, plan.bluestein, plan.radices) == np_plan(n)
    expect = {1223: (4096, (8, 8, 8, 8)), 2446: (4096, (8, 8, 8, 8)),
              1224: (0, (4, 3, 3, 17)), 1827: (0, (3, 3, 7, 29)), 2000: (0, (8, 5, 5, 5)),
              200: (0, (4, 5, 5))}
    if n in expect:
        assert (plan.bluestein, plan.radices) == expect[n]
    _assert_magnitudes(n, np.random.default_rng(n))


@settings(max_examples=40, deadline=None)
@given(m=st.integers(32, 20_000), seed=st.integers(0, 2**32 - 1))
def test_any_clip_length_plans_and_transforms(m, seed):
    """Any clip length from 32 to 20,000 samples, and its frame length at
    8 and 16 kHz: the same plan as the factorisation, magnitudes within
    RTOL of np.fft.rfft's."""
    rng = np.random.default_rng(seed)
    for n in (m, frame_grid(m, 8000)[0], frame_grid(m, 16000)[0]):
        plan = marker_fft.real_plan(n)
        assert (plan.half, plan.size, plan.bluestein, plan.radices) == np_plan(n)
        assert len(plan.radices) <= marker_fft.MAX_RADICES
    _assert_magnitudes(m, rng)


def test_the_lane_layouts():
    """Every repo length's lane fits shared memory (the three whole windows
    at once, or for 2,446's Bluestein buffers one at a time), a 2 s clip
    (m = 16,000) takes the global workspace, a 52 s clip (4,158 frames)
    keeps its per-frame results there too, and the buffers hold a batch's
    work areas and magnitudes, 16-byte aligned. More frames than a clip
    has samples are refused."""
    for m, sr in [(m, 8000) for m in REPO_LENGTHS[:4]] + [(m, 16000) for m in REPO_LENGTHS[4:8]]:
        wl, _hop, frames = frame_grid(m, sr)
        lay = marker_fft.marker_layout(m, wl, frames)
        assert lay.on_chip and lay.shared_bytes <= marker_fft.SMEM_BUDGET
        assert lay.whole_batch == (1 if m == 2446 else 3)
        assert lay.frame_batch == frames
    wl, _hop, frames = frame_grid(16_000, 8000)
    long = marker_fft.marker_layout(16_000, wl, frames)
    assert not long.on_chip and long.shared_bytes == 8 * frames
    assert long.frames_on_chip and long.slot == long.window + 2 * long.buffer
    wl, _hop, frames = frame_grid(52 * 8000, 8000)
    assert frames == 4158 > marker_fft.MAX_FRAMES
    longest = marker_fft.marker_layout(52 * 8000, wl, frames)
    assert not longest.on_chip and not longest.frames_on_chip and longest.shared_bytes == 0
    assert longest.slot == longest.window + 2 * longest.buffer + 2 * frames
    for lay in (long, longest, marker_fft.marker_layout(2446, 400, 18)):
        assert lay.buffer >= lay.whole_batch * 2 * lay.whole.work
        assert lay.buffer >= lay.frame_batch * 2 * lay.frame.work
        assert lay.window >= 3 * lay.whole.n and lay.window % 4 == 0 and lay.buffer % 4 == 0
    with pytest.raises(ValueError, match="frames"):
        marker_fft.marker_layout(2000, 200, marker_fft.MAX_FRAMES + 1)


def test_bluestein_tables_take_the_chirp_angle_from_integers():
    """The chirp's angle pi (j^2 mod 2N) / N, the square reduced in
    integers, against the f64 angle pi j^2 / N where that is exact, and
    the wrapped conjugate chirp's spectrum over M."""
    size = 1223
    c = marker_fft.chirp(size)
    j = np.arange(size, dtype=np.float64)
    np.testing.assert_allclose(c, np.exp(-1j * np.pi * j * j / size), atol=1e-9)
    tables = marker_fft.plan_tables(marker_fft.real_plan(size))
    m = 4096
    b = np.zeros(m, dtype=np.complex128)
    b[:size] = np.conj(c)
    b[m - size + 1:] = np.conj(c[1:])[::-1]
    spec = tables["chirp_spectrum"].astype(np.float64)
    np.testing.assert_allclose(spec[0::2] + 1j * spec[1::2], np.fft.fft(b) / m, atol=1e-7)


def test_plan_tables_a_captured_graph_reads_survive_the_cache(monkeypatch):
    """A plan read while a graph is captured stays in ``_CAPTURED_PLANS``:
    after the cache has evicted it (sixteen other plans made since), the
    same tables, at the same address, are what the next call gets, while
    the cache itself would build new ones."""
    cpu = torch.device("cpu")
    key = (2446, 400, 18, cpu)
    marker_fft._cached.cache_clear()
    monkeypatch.setattr(marker_fft, "_capturing", lambda device: True)
    try:
        plan = marker_fft.marker_plan(*key)
        monkeypatch.setattr(marker_fft, "_capturing", lambda device: False)
        for m in range(40, 40 + 17):
            marker_fft.marker_plan(m, 50, 1, cpu)
        assert marker_fft._cached(*key) is not plan  # evicted, built anew
        again = marker_fft.marker_plan(*key)
        assert again is plan and again.tables.data_ptr() == plan.tables.data_ptr()
    finally:
        marker_fft._CAPTURED_PLANS.pop(key, None)
        marker_fft._cached.cache_clear()


def test_the_corpus_marker_lanes_accept_as_the_plain_verifier():
    """Every marker verify call with a live lane in the regression corpus's
    captures (their CPU runs, the calls as the bank makes them): the
    accept bits decided from the kernel's transliterated spectra equal the
    plain verifier's."""
    from audio_pattern_detector_tpu_torch.match import match_pattern

    calls = 0
    for pattern, audio in regression_cases():
        with recorded_verify_inputs(limit=64) as seen:
            match_pattern(audio, [pattern], device="cpu")
        for section, pos, alive, consts in seen["verify_marker"]:
            want = tvm.verify_marker_reference(section, pos, alive, consts).numpy()
            spectra = np_marker_spectra(section.numpy(), pos.numpy(), consts)
            got = np_marker_decisions(spectra, alive.numpy(), consts)
            np.testing.assert_array_equal(got, want)
            calls += 1
    assert calls >= 16  # one capture (no opening beep) verifies no live lane
