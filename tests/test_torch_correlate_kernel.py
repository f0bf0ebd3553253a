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
* the plan: its radices and its tables against their exact f64 values;
* the route rule of ``ops/correlate.py::_correlate_raw`` (the kernel's
  wrapper, or the counted cuFFT route ``cufft_correlation``);
* the wrapper with a stand-in library: the geometry and buffers it passes,
  a failed launch raising with no plain version run, malformed inputs
  refused before the library, CPU tensors taking the plain version.
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
    assert [tos.kernel_takes(n) for n in (2, 4, 8192, 32768, 65536, 131072, 24576)] == [
        False, True, True, True, False, False, False]
    with pytest.raises(ValueError, match="not a power of two"):
        tos.correlation_radices(12288)


@pytest.mark.parametrize("on_card", [False, True])
def test_the_route_follows_the_device_and_the_length(monkeypatch, on_card):
    """``_correlate_raw``'s rule, by shape and device alone: the
    overlap-save branch takes the wrapper on the CPU at any fft_len and on a
    card up to 32,768 points; past that on a card, and in the single-FFT
    branch everywhere, ``cufft_correlation``."""
    calls = []
    monkeypatch.setattr(tos, "correlate_os", lambda *a: calls.append(("kernel", a[2])))
    monkeypatch.setattr(tcorr, "cufft_correlation",
                        lambda section, c, seg: calls.append(("cufft", c.fft_len)))
    section = types.SimpleNamespace(is_cuda=on_card)  # the rule reads only its device
    for n, ns in ((8192, 3), (32768, 21), (65536, 9), (131072, 5), (8192, 1)):
        c = types.SimpleNamespace(fft_len=n, num_segments=ns, clip_len=700, step=0,
                                  out_offset=0, full_len=10, bank_rfft_conj=None)
        tcorr._correlate_raw(section, c, "spectra")
    past = "cufft" if on_card else "kernel"
    assert calls == [("kernel", 8192), ("kernel", 32768), (past, 65536), (past, 131072),
                     ("cufft", 8192)]


def test_the_single_fft_branch_keeps_cufft(monkeypatch):
    """A section short enough for one transform, or a bank built without
    overlap-save (``APD_NO_OVERLAP_SAVE``), never reaches the wrapper; an
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
    section's spectra); a CTA a transform of 1,024 threads and 128 KB; one
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
    assert tos.launch_geometry(b, g, ns, n) == (b * g * ns, 1024, 131072)
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
        ((seg, bank, 65536, 6193, 0, 20_000), "takes fft_len"),
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
