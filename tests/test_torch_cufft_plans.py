"""``ops/cufft_plans.py`` on the CPU: the class step's real FFTs.

On a card :func:`rfft` / :func:`irfft` run through cuFFT plans the port
holds (``csrc/cufft_plans.cu``), so a captured graph's plans outlive
torch's cuFFT plan cache; ``tests/test_torch_cuda.py`` holds them against
``torch.fft`` there and replays captured rounds after both caches are
emptied. Here: CPU tensors go to ``torch.fft`` unchanged, and the plan
registry (with a stand-in library, since the CPU has no cuFFT) keeps what
a capture used past every eviction, destroys the rest, and raises on a
cuFFT error.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu_torch.ops import cufft_plans


@pytest.mark.parametrize("shape, n", [((7,), None), ((3, 100), 256), ((2, 4, 64), 64),
                                      ((5, 33), 40)])
def test_cpu_transforms_are_torch_fft(shape, n):
    x = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(shape)
                         .astype(np.float32))
    spec = cufft_plans.rfft(x, n=n)
    assert torch.equal(spec, torch.fft.rfft(x, n=n))
    size = n or shape[-1]
    assert torch.equal(cufft_plans.irfft(spec, n=size), torch.fft.irfft(spec, n=size))


class _Library:
    """A stand-in for the kernel library's cuFFT entry points: plan handles
    1, 2, ...; records what it made and destroyed."""

    def __init__(self, fail: int = 0):
        self.made: list[tuple] = []
        self.destroyed: list[int] = []
        self.fail = fail

    def apd_fft_plan(self, inverse, n, batch, handle, work):
        if self.fail:
            return self.fail
        self.made.append((inverse, n, batch))
        handle._obj.value = len(self.made)
        work._obj.value = 1000 * n
        return 0

    def apd_fft_destroy(self, handle):
        self.destroyed.append(handle)
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cufft_plans, "_lib", lambda: lib)
    monkeypatch.setattr(cufft_plans, "_cache", type(cufft_plans._cache)())
    monkeypatch.setattr(cufft_plans, "_CAPTURED", {})
    return lib


def test_a_captured_plan_outlives_every_eviction(library, monkeypatch):
    """A plan read while a graph is captured stays (and is never destroyed)
    through the cache's eviction and its clearing; the others are made
    once, reused, and destroyed when evicted or cleared."""
    dev = torch.device("cpu")
    capturing = {"on": False}
    monkeypatch.setattr(cufft_plans, "_capturing", lambda device: capturing["on"])
    monkeypatch.setattr(cufft_plans, "CACHE_SIZE", 2)
    eager = cufft_plans.plan(False, 4096, 3, dev)
    assert eager == (1, 4_096_000) and cufft_plans.plan(False, 4096, 3, dev) == eager
    capturing["on"] = True
    held = cufft_plans.plan(False, 4096, 3, dev)  # the capture reads the eager run's plan
    assert held == eager and library.made == [(0, 4096, 3)]
    capturing["on"] = False
    for n in (100, 200, 300):  # past CACHE_SIZE: 100 is evicted
        cufft_plans.plan(True, n, 1, dev)
    assert library.destroyed == [2]
    cufft_plans.clear_cache()
    assert sorted(library.destroyed) == [2, 3, 4] and held[0] not in library.destroyed
    assert cufft_plans.plan(False, 4096, 3, dev) == held
    assert len(library.made) == 4  # no plan made again for the captured key


def test_a_plan_that_fails_raises_and_is_not_cached(monkeypatch):
    lib = _Library(fail=5)
    monkeypatch.setattr(cufft_plans, "_lib", lambda: lib)
    monkeypatch.setattr(cufft_plans, "_cache", type(cufft_plans._cache)())
    with pytest.raises(RuntimeError, match="cufftResult 5"):
        cufft_plans.plan(True, 512, 2, torch.device("cpu"))
    assert not cufft_plans._cache
