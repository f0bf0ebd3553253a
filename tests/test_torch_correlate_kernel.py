"""The correlation kernel's arithmetic and launch on the CPU
(``ops/correlate_os.py``, ``csrc/correlate_os.cu``).

The kernel runs only on a card (``tests/test_torch_cuda.py -k correlate``
holds it bitwise to its numpy transliteration there). Here:

* the transliteration (``chip_smoke.np_correlate_os``) against the JAX
  package's ``_correlate_raw`` and against the plain version, at
  fft_len 8,192 and 32,768, clip lengths 1, 2, 700, 2,000 and 8,000, a
  group's own geometry (``out_offset`` 0) and a class-shared one
  (``out_offset`` > 0), three segments or more: within :data:`RTOL` of each
  row's largest value (f32 rounding over the transforms' passes, about
  2e-7 on these inputs);
* its error against the exact correlation (numpy's f64 transforms of the
  same spectra) no more than twice the plain version's;
* a row's bits the same at every index of rounds of 1, 3 and 17 rows and
  any number of clips beside it;
* the transliteration against JAX at the long clips' lengths: the
  29,488-sample rainbow intro clip's 131,072 points and 65,536;
* the plan: its radices and its tables against their exact f64 values;
* the cluster form: ``launch_geometry`` at every power of two from 4 to
  262,144, and a numpy model of the kernel's data movement over C CTAs
  (which CTA folds which bins and holds which values at each pass, the
  exchange, the runs each CTA writes), by the kernel's own indexing,
  bitwise the transliteration for every cluster size at 64 to 262,144
  points;
* the route rule of ``ops/correlate.py::_correlate_raw`` (the kernel's
  wrapper, or the counted cuFFT route ``cufft_correlation``);
* the wrapper with a stand-in library: the geometry and buffers it passes
  at every length class (the library derives the cluster size from N, as
  it derives its plan), a failed launch raising with no plain version run,
  malformed inputs and lengths past 262,144 refused before the library,
  CPU tensors taking the plain version.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.ops import correlate as jcorr
from audio_pattern_detector_tpu_torch.kernels import _build
from audio_pattern_detector_tpu_torch.ops import correlate as tcorr
from audio_pattern_detector_tpu_torch.ops import correlate_os as tos
from chip_smoke import np_correlate_os

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-6  # of a row's largest |correlation|
# (clip length, the class's longest clip or None for the group's own
# geometry, section length): fft_len 8,192 for clips up to 2,048 samples,
# 32,768 for the 8,000-sample clip and for any clip of its class.
CASES = [(m, None, 30_000) for m in (1, 2, 700, 2000)] + [(8000, None, 60_000)] + [
    (m, 2000, 30_000) for m in (1, 2, 700)] + [(m, 8000, 60_000) for m in (1, 2, 700, 2000, 8000)]


@functools.cache
def _case(m: int, m_max, s: int, rows: int = 2, clips: int = 3):
    """(section rows (rows, s), clips (clips, m), the port's and JAX's
    correlation constants, the port's segment spectra)."""
    rng = np.random.default_rng(m + s)
    clip = rng.standard_normal((clips, m)).astype(np.float32)
    sections = (0.1 * rng.standard_normal((rows, s))).astype(np.float32)
    geom = None if m_max is None else tcorr.class_overlap_save_geometry(s, [m_max, m])
    smax = np.ones(clips)
    port = tcorr.build_correlation_bank(clip, smax, s, CPU, shared_geometry=geom)
    jax_c = jcorr.build_correlation_bank(clip, smax, s, shared_geometry=geom)
    seg = tcorr.section_segment_spectra(torch.from_numpy(sections), port)
    return sections, clip, port, jax_c, seg


def _kernel(seg, c) -> np.ndarray:
    return np_correlate_os(seg.numpy(), c.bank_rfft_conj.numpy(), c.fft_len,
                           c.step or c.fft_len - c.clip_len + 1, c.out_offset, c.full_len)


def _exact(seg, c) -> np.ndarray:
    """The correlation in f64 from the same spectra."""
    n, step = c.fft_len, c.step or c.fft_len - c.clip_len + 1
    prod = seg.numpy().astype(np.complex128)[:, None] * c.bank_rfft_conj.numpy()[None, :, None]
    y = np.abs(np.fft.irfft(prod, n=n)[..., :step])
    return y.reshape(*y.shape[:2], -1)[..., c.out_offset : c.out_offset + c.full_len]


def _rel_err(got, want) -> float:
    return float((np.abs(got - want) / want.max(axis=-1, keepdims=True)).max())


@pytest.mark.parametrize("m,m_max,s", CASES)
def test_the_transliteration_matches_jax_and_the_plain_version(m, m_max, s):
    sections, _, port, jax_c, seg = _case(m, m_max, s)
    assert port.num_segments >= 3 and port.fft_len == (8192 if (m_max or m) <= 2048 else 32768)
    assert (port.out_offset > 0) == (m_max not in (None, m))
    got = _kernel(seg, port)
    assert got.shape == (2, 3, port.full_len) and got.dtype == np.float32
    plain = tcorr._correlate_raw(torch.from_numpy(sections), port, seg).numpy()
    assert _rel_err(got, plain) <= RTOL
    for b in range(2):
        want = np.asarray(jcorr._correlate_raw(jnp.asarray(sections[b]), jax_c))
        assert _rel_err(got[b], want) <= RTOL


@pytest.mark.parametrize("m,m_max,s", [(2000, None, 30_000), (700, 2000, 30_000),
                                       (8000, None, 60_000), (700, 8000, 60_000)])
def test_the_transliteration_errs_no_more_than_twice_the_plain_version(m, m_max, s):
    sections, _, port, _, seg = _case(m, m_max, s)
    exact = _exact(seg, port)
    kernel_err = _rel_err(_kernel(seg, port), exact)
    plain_err = _rel_err(tcorr._correlate_raw(torch.from_numpy(sections), port, seg).numpy(),
                         exact)
    assert kernel_err <= 2 * plain_err, (kernel_err, plain_err)


@pytest.mark.parametrize("rows", [1, 3, 17])
@pytest.mark.parametrize("m,m_max,s", [(700, 2000, 30_000), (2000, 8000, 60_000)])
def test_a_rows_bits_do_not_depend_on_its_round(rows, m, m_max, s):
    """Each (row, clip) of a round of ``rows`` sections against 3 clips is
    bitwise the row alone against its clip alone."""
    _, _, port, _, seg = _case(m, m_max, s, rows=max(rows, 2))
    seg = seg[:rows]
    got = _kernel(seg, port)
    n, step = port.fft_len, port.step
    for b in {0, rows // 2, rows - 1}:
        for g in range(3):
            alone = np_correlate_os(seg[b].numpy(), port.bank_rfft_conj[g : g + 1].numpy(), n,
                                    step, port.out_offset, port.full_len)
            assert alone.shape == (1, port.full_len)
            assert np.array_equal(got[b, g].view(np.int32), alone[0].view(np.int32))


@pytest.mark.parametrize("n,radices", [(8192, (4,) * 6), (16384, (4,) * 6 + (2,)),
                                       (32768, (4,) * 7), (64, (4, 4, 2)), (4, (2,))])
def test_the_plan_is_its_radices_and_the_exact_roots_rounded_once(n, radices):
    plan = tos.correlation_plan(n, CPU)
    assert plan.radices == tos.correlation_radices(n // 2) == radices
    assert int(np.prod(radices)) == n // 2
    tables = plan.tables.numpy()
    h = n // 2
    # The separation twiddles, then each pass's W[r k h / (p R)] at
    # k (R - 1) + r - 1, as the kernel reads them (its C entry's offsets).
    parts, p = [np.exp(-2j * np.pi * np.arange(h + 1) / n)], 1
    for r in radices:
        kk, rr = np.meshgrid(np.arange(p), np.arange(1, r), indexing="ij")
        parts.append(np.exp(-2j * np.pi * (rr * kk * (h // (p * r))).reshape(-1) / h))
        p *= r
    exact = np.concatenate(parts)
    exact = np.stack([exact.real, exact.imag], axis=-1).reshape(-1)
    assert tables.dtype == np.float32 and tables.shape == exact.shape
    assert tables.shape[0] == 2 * (h + 1) + 2 * sum(
        int(np.prod(radices[:q])) * (r - 1) for q, r in enumerate(radices))
    assert np.abs(tables.astype(np.float64) - exact).max() <= 2.0**-24
    assert np.array_equal(tables, exact.astype(np.float32))


def _np_dft4(x):
    """The exact radix-4 DFT of csrc/fft_common.cuh on (re, im) f32 pairs."""
    (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i) = x
    t0r, t0i, t1r, t1i = x0r + x2r, x0i + x2i, x0r - x2r, x0i - x2i
    t2r, t2i, t3r, t3i = x1r + x3r, x1i + x3i, x1r - x3r, x1i - x3i
    return [(t0r + t2r, t0i + t2i), (t1r + t3i, t1i - t3r), (t0r - t2r, t0i - t2i),
            (t1r - t3i, t1i + t3r)]


def _np_pass_pair4(re, im, p: int, twiddles):
    """csrc/correlate_os.cu's pass_pair4 in numpy, by its own indexing:
    thread g takes group (j, k0) = (g / p, g mod p), the first pass's four
    butterflies (j + r' H / (16 p)) p + k0 and the second pass's four
    butterflies j 4p + s p + k0, written to (4 j + s') 4p + s p + k0."""
    from chip_smoke import _np_cmul

    h = re.shape[-1]
    t, big_j = h // 4, h // (16 * p)
    g = np.arange(h // 16)
    j, k0 = g // p, g % p
    wr, wi = twiddles[0::2], twiddles[1::2]
    x = []
    for rr in range(4):
        i = (j + rr * big_j) * p + k0
        row = [(re[:, i + r * t], im[:, i + r * t]) for r in range(4)]
        row = [row[0]] + [_np_cmul(*row[r], wr[r * k0 * (h // (4 * p))],
                                   wi[r * k0 * (h // (4 * p))]) for r in range(1, 4)]
        x.append(_np_dft4(row))
    out_re, out_im = np.empty_like(re), np.empty_like(im)
    for s in range(4):
        k = s * p + k0
        z = [x[0][s]] + [_np_cmul(*x[rr][s], wr[rr * k * (h // (16 * p))],
                                  wi[rr * k * (h // (16 * p))]) for rr in range(1, 4)]
        for s2, (yr, yi) in enumerate(_np_dft4(z)):
            out_re[:, j * 16 * p + k + s2 * 4 * p], out_im[:, j * 16 * p + k + s2 * 4 * p] = yr, yi
    return out_re, out_im


@pytest.mark.parametrize("h", [16, 256, 4096])
def test_two_radix_4_passes_in_registers_are_two_stockham_passes(h):
    """The kernel's pass_pair4 (its groups of 16 values, their twiddles and
    where they are written) gives two Stockham radix-4 passes' bits, pass
    pair after pass pair from p = 1."""
    from chip_smoke import np_stockham
    from audio_pattern_detector_tpu_torch.ops.marker_fft import _interleave, _roots

    rng = np.random.default_rng(h)
    re, im = (rng.standard_normal((3, h)).astype(np.float32) for _ in range(2))
    radices = tos.correlation_radices(h)
    assert set(radices) == {4} and len(radices) % 2 == 0
    twiddles = _interleave(_roots(h))
    got_re, got_im, p = re, im, 1
    for _ in range(len(radices) // 2):
        got_re, got_im = _np_pass_pair4(got_re, got_im, p, twiddles)
        p *= 16
    want_re, want_im = np_stockham(re, im, radices, twiddles)
    assert np.array_equal(got_re.view(np.int32), want_re.view(np.int32))
    assert np.array_equal(got_im.view(np.int32), want_im.view(np.int32))


def test_the_plan_refuses_lengths_the_kernel_does_not_take():
    assert [tos.kernel_takes(n) for n in (2, 4, 8192, 32768, 65536, 131072, 262144, 524288,
                                          24576)] == [
        False, True, True, True, True, True, True, False, False]
    with pytest.raises(ValueError, match="not a power of two"):
        tos.correlation_radices(12288)


@pytest.mark.parametrize("on_card", [False, True])
def test_the_route_follows_the_device_and_the_length(monkeypatch, on_card):
    """``_correlate_raw``'s rule, by shape and device alone: the
    overlap-save branch takes the wrapper on the CPU at any fft_len and on a
    card up to 262,144 points (the rainbow clip's 131,072 among them); past
    that on a card, and in the single-FFT branch everywhere,
    ``cufft_correlation``."""
    calls = []
    monkeypatch.setattr(tos, "correlate_os", lambda *a: calls.append(("kernel", a[2])))
    monkeypatch.setattr(tcorr, "cufft_correlation",
                        lambda section, c, seg: calls.append(("cufft", c.fft_len)))
    section = types.SimpleNamespace(is_cuda=on_card)  # the rule reads only its device
    for n, ns in ((8192, 3), (32768, 21), (65536, 9), (131072, 5), (262144, 3), (524288, 2),
                  (8192, 1), (131072, 1)):
        c = types.SimpleNamespace(fft_len=n, num_segments=ns, clip_len=700, step=0,
                                  out_offset=0, full_len=10, bank_rfft_conj=None)
        tcorr._correlate_raw(section, c, "spectra")
    past = "cufft" if on_card else "kernel"
    assert calls == [("kernel", 8192), ("kernel", 32768), ("kernel", 65536), ("kernel", 131072),
                     ("kernel", 262144), (past, 524288), ("cufft", 8192), ("cufft", 131072)]


def test_the_single_fft_branch_keeps_cufft(monkeypatch):
    """A section short enough for one transform, or constants built without
    overlap-save, never reaches the wrapper; an
    overlap-save geometry does, with its step and offset."""
    rng = np.random.default_rng(3)
    clip = rng.standard_normal((2, 700)).astype(np.float32)
    section = torch.from_numpy((0.1 * rng.standard_normal(20_000)).astype(np.float32))
    monkeypatch.setattr(tos, "correlate_os", lambda *a: pytest.fail("reached correlate_os"))
    counted = tcorr.cufft_correlation.launches
    for s, overlap_save in ((4000, True), (20_000, False)):
        c = tcorr.build_correlation_bank(clip, np.ones(2), s, CPU, overlap_save=overlap_save)
        assert c.num_segments == 1
        assert tcorr._correlate_raw(section[:s], c).shape == (2, c.full_len)
    assert tcorr.cufft_correlation.launches == counted  # calls on a card only
    calls = []
    monkeypatch.setattr(tos, "correlate_os", lambda *a: calls.append(a[2:]) or "out")
    c = tcorr.build_correlation_bank(clip, np.ones(2), 20_000, CPU)
    assert c.num_segments > 1 and tcorr._correlate_raw(section, c) == "out"
    assert calls == [(8192, 8192 - 700 + 1, 0, c.full_len)]


def _stub(monkeypatch, code: int) -> list:
    """A stand-in library whose kernel returns ``code``; the calls' arguments."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return code

    lib = types.SimpleNamespace(apd_correlate_os=kernel)
    monkeypatch.setattr(_build, "load_kernels", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("rows", [None, 1, 16])
def test_the_wrapper_passes_the_geometry_and_its_buffers(monkeypatch, rows):
    """The launch path with a stand-in library at the flagship geometry
    (fft_len 32,768, 21 segments, 495,999 samples): the spectra, the bank,
    the plan's tables, one output (B, G, L) (or (G, L) for one
    section's spectra); one CTA a transform, 1,024 threads and 128 KB; one
    launch counted."""
    n, ns, step, off, l, g = 32768, 21, 24769, 0, 495_999, 32
    seg = torch.zeros((ns, n // 2 + 1) if rows is None else (rows, ns, n // 2 + 1),
                      dtype=torch.complex64)
    bank = torch.zeros((g, n // 2 + 1), dtype=torch.complex64)
    calls = _stub(monkeypatch, 0)
    before = tos.correlate_os.launches
    out = tos._launch(seg, bank, n, step, off, l)
    assert tos.correlate_os.launches == before + 1
    b = 1 if rows is None else rows
    assert out.shape == ((g, l) if rows is None else (b, g, l)) and out.dtype == torch.float32
    (args,) = calls
    plan = tos.correlation_plan(n, CPU)
    assert args[0] == seg.data_ptr() and args[3] == bank.data_ptr()
    assert (args[1], args[2], args[4], args[5], args[6], args[7], args[8]) == (
        b, ns, g, n, step, off, l)
    assert len(args) == 12 and plan.radices == (4,) * 7
    assert args[9] == plan.tables.data_ptr() and args[10] == out.data_ptr()
    assert tos.launch_geometry(b, g, ns, n) == (1, b * g * ns, 1024, 131072)
    tos.correlate_os.launches = before


def test_a_failed_launch_raises_and_runs_no_plain_version(monkeypatch):
    n = 8192
    seg = torch.zeros((2, 4, n // 2 + 1), dtype=torch.complex64)
    bank = torch.zeros((3, n // 2 + 1), dtype=torch.complex64)
    _stub(monkeypatch, 700)
    monkeypatch.setattr(tos, "correlate_os_reference", lambda *a: pytest.fail("fell back"))
    before = tos.correlate_os.launches
    with pytest.raises(RuntimeError, match="correlate_os kernel launch failed: CUDA error 700"):
        tos._launch(seg, bank, n, 6193, 0, 20_000)
    assert tos.correlate_os.launches == before


def test_malformed_inputs_are_refused_before_the_library(monkeypatch):
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("reached the library"))
    n, bins = 8192, 4097
    seg = torch.zeros((2, 4, bins), dtype=torch.complex64)
    bank = torch.zeros((3, bins), dtype=torch.complex64)
    bad = [
        ((seg, bank, 524288, 6193, 0, 20_000), "takes fft_len"),
        ((seg, bank, 12288, 6193, 0, 20_000), "takes fft_len"),
        ((seg.real.contiguous(), bank, n, 6193, 0, 20_000), "segment spectra"),
        ((seg[..., :-1], bank, n, 6193, 0, 20_000), "segment spectra"),
        ((seg.transpose(0, 1), bank, n, 6193, 0, 20_000), "segment spectra"),
        ((seg[0, 0], bank, n, 6193, 0, 20_000), "segment spectra"),
        ((seg, bank[:, :-1], n, 6193, 0, 20_000), "the bank"),
        ((seg, bank.to(torch.complex128), n, 6193, 0, 20_000), "the bank"),
        ((seg, bank[None], n, 6193, 0, 20_000), "the bank"),
        ((seg, bank, n, 0, 0, 20_000), "does not cover"),
        ((seg, bank, n, 8193, 0, 20_000), "does not cover"),
        ((seg, bank, n, 6193, 0, 4 * 6193 + 1), "does not cover"),
        ((seg, bank, n, 6193, 1300, 4 * 6193 - 1299), "does not cover"),
        ((seg, bank, n, 6193, -1, 20_000), "does not cover"),
    ]
    for args, message in bad:
        with pytest.raises(ValueError, match=message):
            tos._launch(*args)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    _, _, port, _, seg = _case(700, 2000, 30_000)
    monkeypatch.setattr(tos, "_launch", lambda *a: pytest.fail("launched on the CPU"))
    before = tos.correlate_os.launches
    args = (port.bank_rfft_conj, port.fft_len, port.step, port.out_offset, port.full_len)
    got = tos.correlate_os(seg, *args)
    assert torch.equal(got, tos.correlate_os_reference(seg, *args))
    assert torch.equal(tos.correlate_os(seg[0], *args), got[0])
    assert tos.correlate_os.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tos.correlate_os(seg.to("meta"), *args)


# -- The cluster form ---------------------------------------------------------

ALL_LENGTHS = [1 << e for e in range(2, 19)]  # every power of two the kernel takes


def _pass_stages(half: int) -> list[tuple[int, int]]:
    """The kernel's stages for an N/2-point transform, (log2 p, log2 of the
    stage's radix): radix-4 pass pairs (16) while 16 p <= N/2, then one
    radix-4 pass where 4 p <= N/2, then one radix 2 where 2 p <= N/2."""
    h = half.bit_length() - 1
    stages, lp = [], 0
    while lp + 4 <= h:
        stages.append((lp, 4))
        lp += 4
    for d in (2, 1):
        if lp + d <= h:
            stages.append((lp, d))
            lp += d
    return stages


def _cluster_plan(n: int, cluster: int) -> tuple[int, int]:
    """``csrc/correlate_os.cu::cluster_plan`` for ``n`` points over
    ``cluster`` CTAs: (the stage whose writes cross CTAs, the last whose
    butterfly index i / p keeps log2 C bits with the next stage's log2 p at
    least log2 C; the bit a at which the rank sits in a value's index after
    it, that log2 p less log2 C). One CTA: the stage count and log2 (N/2)."""
    half = n // 2
    h, c = half.bit_length() - 1, cluster.bit_length() - 1
    stages = _pass_stages(half)
    if c == 0:
        return len(stages), h
    for s in range(len(stages) - 1, -1, -1):
        lp, d = stages[s]
        nxt = stages[s + 1][0] if s + 1 < len(stages) else h
        if h - d - lp >= c and nxt >= c:
            return s, nxt - c
    raise ValueError(f"no exchange for {n} points over {cluster} CTAs")


@pytest.mark.parametrize("n", ALL_LENGTHS)
def test_the_launch_geometry_at_every_length(n):
    """A cluster of at most 8 CTAs a transform, at most 128 KB and 1,024
    threads a CTA, whose shares of the N/2 complex values make the whole;
    one CTA up to 32,768 points (the one-CTA form kept there), then N/2 /
    16,384 CTAs of 128 KB: 2 at 65,536, 4 at 131,072, 8 at 262,144; the
    size a function of N alone, with an exchange stage in the kernel's
    plan."""
    cluster, ctas, threads, smem = tos.launch_geometry(2, 3, 5, n)
    local = smem // 8
    assert cluster == tos.cluster_size(n) and cluster in (1, 2, 4, 8)
    assert smem <= 128 * 1024 and local * cluster == n // 2 and ctas == 2 * 3 * 5 * cluster
    assert threads == max(32, local // tos.PER_THREAD) <= 1024
    assert cluster == max(1, n // 32768) and (cluster == 1 or local == tos.MAX_LOCAL)
    assert all(tos.launch_geometry(b, g, 7, n)[0] == cluster for b in (1, 16, 17) for g in (1, 32))
    exchange, a = _cluster_plan(n, cluster)
    assert 0 <= a and a + cluster.bit_length() - 1 <= (n // 2).bit_length() - 1
    assert (exchange == len(_pass_stages(n // 2))) == (cluster == 1)


@pytest.mark.parametrize("n", [524288, 24576, 2, 393216])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, n):
    """Past 262,144 points, a length not a power of two (below or above the
    cap), or one below 4: refused before the library."""
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("reached the library"))
    bins = n // 2 + 1
    seg = torch.zeros((1, 2, bins), dtype=torch.complex64)
    bank = torch.zeros((1, bins), dtype=torch.complex64)
    with pytest.raises(ValueError, match="takes fft_len"):
        tos._launch(seg, bank, n, n // 2, 0, n // 2)


@pytest.mark.parametrize("n", [8192, 32768, 65536, 131072, 262144])
def test_the_wrapper_launches_every_length_class(monkeypatch, n):
    """One CTA a transform (8,192, 32,768) and clusters of 2, 4 and 8
    (65,536 to 262,144): the stand-in library gets the geometry, the plan's
    tables, the output and the stream, and no cluster size (the library
    derives it from N); one launch counted."""
    ns, g = 2, 3
    step = n - n // 4 + 1
    seg = torch.zeros((ns, n // 2 + 1), dtype=torch.complex64)
    bank = torch.zeros((g, n // 2 + 1), dtype=torch.complex64)
    calls = _stub(monkeypatch, 0)
    before = tos.correlate_os.launches
    out = tos._launch(seg, bank, n, step, 5, 2 * step - 5)
    assert tos.correlate_os.launches == before + 1
    assert out.shape == (g, 2 * step - 5)
    (args,) = calls
    assert len(args) == 12 and args[9] == tos.correlation_plan(n, CPU).tables.data_ptr()
    assert args[:9] == (seg.data_ptr(), 1, ns, bank.data_ptr(), g, n, step, 5, 2 * step - 5)
    assert args[10] == out.data_ptr() and args[11] == 0
    tos.correlate_os.launches = before


@pytest.mark.parametrize("m,s,n", [(12_000, 80_000, 65536), (29_488, 110_000, 131072)])
def test_the_transliteration_matches_jax_at_long_clips(m, s, n):
    """A clip of 12,000 samples (fft_len 65,536) and the rainbow intro
    clip's length, 29,488 (131,072), against 2 clips on a seeded section:
    the transliteration within :data:`RTOL` of each row's largest value of
    JAX's ``_correlate_raw`` on the CPU (f32 rounding over 8 passes, about
    3e-7 here)."""
    rng = np.random.default_rng(m)
    clips = rng.standard_normal((2, m)).astype(np.float32)
    section = (0.1 * rng.standard_normal(s)).astype(np.float32)
    port = tcorr.build_correlation_bank(clips, np.ones(2), s, CPU)
    jax_c = jcorr.build_correlation_bank(clips, np.ones(2), s)
    assert (port.fft_len, port.num_segments, jax_c.fft_len) == (n, 2, n)
    seg = tcorr.section_segment_spectra(torch.from_numpy(section), port)
    got = _kernel(seg, port)
    want = np.asarray(jcorr._correlate_raw(jnp.asarray(section), jax_c))
    assert got.shape == want.shape == (2, s + m - 1)
    assert _rel_err(got, want) <= RTOL


def _np_cluster_kernel(seg, bank, n: int, cluster: int) -> np.ndarray:
    """csrc/correlate_os.cu for one transform over ``cluster`` CTAs, in
    numpy by the kernel's own indexing: each CTA's buffer of N/2 / C values
    at swizzled places; the fold of CTA r's range of pairs (k, H - k),
    A[k] stored in CTA k mod C at k / C; each stage's loads from the CTA's
    own buffer and its stores (at the exchange into the CTA that holds the
    value next); the runs of output floats each CTA writes. Every place is
    written exactly once. Returns |y| / N (N,) f32."""
    from chip_smoke import _np_cmul

    f32 = np.float32
    h = n // 2
    c = cluster.bit_length() - 1
    hl = h >> c
    exchange, a = _cluster_plan(n, cluster)
    tables = tos.correlation_tables(n, tos.correlation_radices(h))
    post, tws, at, p = tables[: 2 * (h + 1)], [], 2 * (h + 1), 1
    while p < h:
        r = 4 if 4 * p <= h else 2
        tws.append(tables[at : at + 2 * p * (r - 1)])
        at += 2 * p * (r - 1)
        p *= r

    def sw(idx):
        return idx ^ ((idx >> 4) & 15)

    def fresh():
        return [np.full((hl, 2), np.nan, f32) for _ in range(cluster)], [
            np.zeros(hl, int) for _ in range(cluster)]

    def store(bufs, counts, to, loc, vr, vi):
        for r in range(cluster):
            sel = to == r
            bufs[r][sw(loc[sel]), 0], bufs[r][sw(loc[sel]), 1] = vr[sel], vi[sel]
            np.add.at(counts[r], sw(loc[sel]), 1)

    def dft(x):
        if len(x) == 2:
            (x0r, x0i), (x1r, x1i) = x
            return [(x0r + x1r, x0i + x1i), (x0r - x1r, x0i - x1i)]
        return _np_dft4(x)

    def cmul_tw(x, tw, t):
        return _np_cmul(*x, tw[0::2][t], tw[1::2][t])

    seg, bank = np.asarray(seg, np.complex64), np.asarray(bank, np.complex64)
    pr, pi_ = _np_cmul(seg.real, seg.imag, bank.real, bank.imag)

    def fold(k, m):  # A[k] = (E.x + t.y, E.y - t.x)
        ur, ui, vr, vi = pr[k], -pi_[k], pr[m], pi_[m]
        tr, ti = _np_cmul(post[0::2][k], post[1::2][k], ur - vr, ui - vi)
        return (ur + vr + ti).astype(f32), (ui + vi - tr).astype(f32)

    bufs, counts = fresh()
    per, span = (h // 2) >> c, 32 << c
    for rank in range(cluster):
        # The kernel's e -> k: in each span of 32 C pairs, round w / 32 and
        # lane w mod 32 take k = start + lane C + round (one CTA a warp's
        # stores); the plain order where a CTA's pairs are not whole spans.
        e = np.arange(per)
        w = e & (span - 1)
        k = rank * per + ((e - w + ((w & 31) << c) + (w >> 5)) if cluster > 1
                          and per % span == 0 else e)
        assert np.array_equal(np.sort(k), np.arange(rank * per, (rank + 1) * per))
        if cluster > 1 and per % span == 0:
            assert all(len(set(k[i : i + 32] & (cluster - 1))) == 1 for i in range(0, per, 32))
        store(bufs, counts, k & (cluster - 1), k >> c, *fold(k, h - k))
        k = k[k > 0]
        store(bufs, counts, (h - k) & (cluster - 1), (h - k) >> c, *fold(h - k, k))
    half = np.array([h // 2])
    store(bufs, counts, half & (cluster - 1), half >> c, *fold(half, half))
    assert all((cnt == 1).all() for cnt in counts)

    def run_stage(stage, p, radix, tw):
        after, crossing = stage > exchange, stage == exchange
        pl = p >> c if after else p
        new, written = fresh()
        for rank in range(cluster):
            def k_of(kl):
                if not after:
                    return kl
                return (kl & ((1 << a) - 1)) | (rank << a) | ((kl >> a) << (a + c))

            def put(dst, j, width, v):
                if crossing:  # the exchange: into the CTA that holds the value next
                    g = dst + (j * (cluster - 1) + rank) * width
                    to = (g >> a) & (cluster - 1)
                    dst = (g & ((1 << a) - 1)) | ((g >> (a + c)) << a)
                else:
                    to = np.full(dst.shape, rank)
                store(new, written, to, dst, *v)

            buf = bufs[rank]
            load = lambda i: (buf[sw(i), 0], buf[sw(i), 1])  # noqa: E731
            if radix == 16:  # pass_pair4
                t_, j_ = hl // 4, hl // (16 * pl)
                gi = np.arange(hl // 16)
                j, k0l = gi // pl, gi & (pl - 1)
                k0 = k_of(k0l)
                x = []
                for rr in range(4):
                    row = [load((j + rr * j_) * pl + k0l + r * t_) for r in range(4)]
                    x.append(dft([row[0]] + [cmul_tw(row[r], tw[0], k0 * 3 + r - 1)
                                             for r in range(1, 4)]))
                for s_ in range(4):
                    kk = s_ * p + k0
                    z = [x[0][s_]] + [cmul_tw(x[rr][s_], tw[1], kk * 3 + rr - 1)
                                      for rr in range(1, 4)]
                    for s2, v in enumerate(dft(z)):
                        put(j * 16 * pl + s_ * pl + k0l + s2 * 4 * pl, j, 16 * p, v)
            else:
                t_ = hl // radix
                i = np.arange(t_)
                kl = i & (pl - 1)
                k = k_of(kl)
                x = [load(i)] + [cmul_tw(load(i + r * t_), tw[0], k * (radix - 1) + r - 1)
                                 for r in range(1, radix)]
                for s_, v in enumerate(dft(x)):
                    put((i - kl) * radix + kl + s_ * pl, i // pl, radix * p, v)
        assert all((cnt == 1).all() for cnt in written), stage
        return new

    p, q, stage = 1, 0, 0
    while 16 * p <= h:
        bufs = run_stage(stage, p, 16, (tws[q], tws[q + 1]))
        p, q, stage = p * 16, q + 2, stage + 1
    for radix in (4, 2):
        if radix * p <= h:
            bufs = run_stage(stage, p, radix, (tws[q],))
            p, q, stage = p * radix, q + 1, stage + 1
    # The write: CTA r's local float lf is float t of the transform, its
    # runs of 2^ls floats (run index r mod C) laid end to end.
    out = np.full(n, np.nan, f32)
    ls = a + 1

    def first_local(t, rank):
        q = t >> ls
        if q % cluster == rank:
            return ((q // cluster) << ls) + (t & ((1 << ls) - 1))
        return (q // cluster + (q % cluster > rank)) << ls

    for rank in range(cluster):
        y = bufs[rank].reshape(-1)
        lf = np.arange(first_local(0, rank), first_local(n, rank))
        t = (lf & ((1 << ls) - 1)) + ((((lf >> ls) << c) + rank) << ls)
        assert np.isnan(out[t]).all()
        out[t] = (np.abs(y[2 * sw(lf >> 1) + (lf & 1)]) * f32(1.0 / n)).astype(f32)
    return out


@pytest.mark.parametrize("n,cluster", [
    (64, 2), (256, 8), (8192, 1), (16384, 2), (32768, 1), (32768, 2), (32768, 4), (32768, 8),
    (65536, 2), (65536, 8), (131072, 4), (131072, 8), (262144, 8)])
def test_the_cluster_kernels_data_movement_gives_the_transliterations_bits(n, cluster):
    """Every cluster size computes the one-CTA form's bits: the kernel's
    data movement over C CTAs (:func:`_np_cluster_kernel`) on seeded
    spectra is bitwise ``chip_smoke.np_correlate_transforms``, every
    output sample written once."""
    from chip_smoke import np_correlate_transforms

    rng = np.random.default_rng(n + cluster)
    seg, bank = (
        (rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(n // 2 + 1)).astype(
            np.complex64) for _ in range(2))
    got = _np_cluster_kernel(seg, bank, n, cluster)
    want = np_correlate_transforms(seg[None], bank[None], n)[0]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
