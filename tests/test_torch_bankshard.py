"""The port's ``parallel/bankshard.py`` against the JAX ``BankShardedBank``
and against the port's unsharded bank.

The bank is the JAX test's (``tests/test_bankshard.py``): eight 1 s noise
clips and eight quarter-second marker tones at 8 kHz, 10 s chunks. The JAX
side shards over the virtual CPU devices of ``tests/conftest.py``, the port
over logical shards of the one CPU device. Results (accepted positions per
clip) must be equal exactly, the stitched payload bit-equal to the
unsharded bank's, and the padded and sliced constants equal to JAX's array
by array.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models.detector import AudioPatternDetector as JaxDetector
from audio_pattern_detector_tpu.parallel import BankShardedBank as JaxBankShardedBank
from audio_pattern_detector_tpu.parallel import bankshard as jbankshard
from audio_pattern_detector_tpu.parallel import make_mesh as jax_make_mesh
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch import AudioClip, AudioPatternDetector
from audio_pattern_detector_tpu_torch.models.detector import MARKER_TONE_STRATEGY
from audio_pattern_detector_tpu_torch.ops.consts import consts_from_numpy
from audio_pattern_detector_tpu_torch.parallel import (
    BankShardedBank,
    make_mesh,
    pad_group_consts,
    shard_group_consts,
)

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")


def build_clips():
    rng = np.random.default_rng(0)
    clips = [
        AudioClip(name=f"n{i}", audio=(0.4 * rng.standard_normal(SR)).astype(np.float32),
                  sample_rate=SR)
        for i in range(8)
    ]
    t = np.arange(SR // 4) / SR
    for i in range(8):
        f = 900.0 + 13 * i
        clips.append(AudioClip(
            name=f"m{i}", audio=np.sin(2 * np.pi * f * t).astype(np.float32), sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY, strategy_params={"dominant_frequency_hz": f},
        ))
    return clips


@pytest.fixture(scope="module")
def env():
    clips = build_clips()
    bank = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=10)._ensure_bank()
    jclips = [jclip.AudioClip(**dataclasses.asdict(c)) for c in clips]
    jbank = JaxDetector(audio_clips=jclips, seconds_per_chunk=10)._ensure_bank()
    return clips, bank, jbank


def logical_mesh(n):
    return make_mesh({"bank": n}, devices=["cpu"] * n)


def _chunk(seed, plant=()):
    audio = (0.01 * np.random.default_rng(seed).standard_normal(10 * SR)).astype(np.float32)
    for second, clip, scale in plant:
        o = int(second * SR)
        audio[o : o + len(clip.audio)] += scale * clip.audio
    return audio


def _payloads(dispatched):
    return [handle.numpy() for _, handle, *_ in dispatched]


CASES = {
    # (shards, chunk, previous chunk, clips that must be found)
    "eight_shards": (8, lambda c: _chunk(1, [(3, c[2], 1.0), (6, c[11], 0.7)]), None, ("n2", "m3")),
    "lookback": (8, lambda c: _chunk(22, [(2, c[5], 1.0)]), lambda c: _chunk(2), ("n5",)),
    "indivisible_3_shards": (3, lambda c: _chunk(3, [(3, c[7], 1.0)]), None, ("n7",)),
    "two_shards": (2, lambda c: _chunk(5, [(4, c[0], 1.0), (7, c[15], 0.8)]), None, ("n0", "m7")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_bank_equals_unsharded_and_jax(env, case):
    clips, bank, jbank = env
    n, chunk_fn, prev_fn, found = CASES[case]
    chunk = chunk_fn(clips)
    prev = prev_fn(clips) if prev_fn else None
    ref = bank.process_chunk(chunk, prev)
    sharded = BankShardedBank(bank, logical_mesh(n))
    assert sharded.process_chunk(chunk, prev) == ref
    for name in found:
        assert ref[name]
    jgot = JaxBankShardedBank(jbank, jax_make_mesh({"bank": n})).process_chunk(chunk, prev)
    assert ref == jgot


@pytest.mark.parametrize("n", [2, 3, 8])
def test_stitched_payload_is_bit_equal_to_the_unsharded_payload(env, n):
    clips, bank, _ = env
    chunk = _chunk(1, [(3, clips[2], 1.0), (6, clips[11], 0.7)])
    sharded = BankShardedBank(bank, logical_mesh(n))
    want = _payloads(bank.dispatch_chunk(chunk, None))
    got = _payloads(sharded.dispatch_chunk(chunk, None))
    for (sw, cls), g, w in zip(bank.classes.items(), got, want):
        rows = sharded._padded_rows[sw]
        off_g = off_w = 0
        for grp, gr in zip(cls["groups"], rows):
            width = 2 * grp.k_verify + 2
            real = len(grp.names) * width
            assert g[off_g : off_g + real].tobytes() == w[off_w : off_w + real].tobytes()
            # Padded rows duplicate clip 0.
            pad = g[off_g + real : off_g + gr * width].reshape(-1, width)
            assert (pad == g[off_g : off_g + width]).all()
            off_g += gr * width
            off_w += real
        assert off_g == len(g) and off_w == len(w)


def test_dispatch_collect_async_pair(env):
    """Two chunks in flight give what synchronous processing gives."""
    clips, bank, _ = env
    c0 = _chunk(4, [(2, clips[1], 1.0)])
    c1 = _chunk(44, [(5, clips[9], 0.8)])
    sharded = BankShardedBank(bank, logical_mesh(8))
    d0 = sharded.dispatch_chunk(c0, None)
    d1 = sharded.dispatch_chunk(c1, c0)  # in flight behind d0
    assert all(h.is_ready() for _, h, *_ in d0)
    assert sharded.collect_chunk(d0) == bank.process_chunk(c0, None)
    assert sharded.collect_chunk(d1) == bank.process_chunk(c1, c0)


@pytest.mark.parametrize("path", ["bank_sharded_bank", "sharded_detector"])
def test_a_bank_shard_never_receives_the_whole_classes_groups(monkeypatch, path):
    """Bank sharding is for banks that outgrow one device: of the whole
    class only the loudness constants go to a shard's device; the group
    constants copied there are the shard's own slice."""
    from audio_pattern_detector_tpu_torch.models import bank as tbank
    from audio_pattern_detector_tpu_torch.ops.consts import LoudnessConsts
    from audio_pattern_detector_tpu_torch.parallel import ShardedDetector
    from audio_pattern_detector_tpu_torch.parallel import bankshard as tbankshard
    from audio_pattern_detector_tpu_torch.parallel import sequence as tsequence

    clips = build_clips()
    full = {8}  # both groups of build_clips() hold 8 clips
    copied = []  # (module, type name, leading size of the G-leading tensors)

    def recording(module):
        real = module.consts_to_device

        def record(consts, device):
            g = None if isinstance(consts, LoudnessConsts) else int(consts.self_corr_max.shape[0]) \
                if hasattr(consts, "self_corr_max") else None
            copied.append((module.__name__.rsplit(".", 1)[-1], type(consts).__name__, g))
            return real(consts, device)

        monkeypatch.setattr(module, "consts_to_device", record)

    for module in (tbank, tbankshard, tsequence):
        recording(module)
    chunk = _chunk(1, [(3, clips[2], 1.0), (6, clips[11], 0.7)])
    if path == "bank_sharded_bank":
        bank = AudioPatternDetector(clips, device="cpu", seconds_per_chunk=10)._ensure_bank()
        got = BankShardedBank(bank, logical_mesh(2)).process_chunk(chunk, None)
    else:
        mesh = make_mesh({"bank": 2, "time": 2}, devices=["cpu"] * 4)
        sd = ShardedDetector(clips, mesh, chunk_seconds=5, device="cpu")
        bank = sd.bank
        got = {n: per[0] for n, per in sd.detect(chunk[None]).items()}
    assert got["n2"] and got["m3"]
    assert bank._replica_groups == {}
    assert {name for mod, name, _ in copied if mod == "bank"} == {"LoudnessConsts"}
    sizes = {g for _, name, g in copied if name == "CorrelationBankConsts"}
    assert sizes == {4} and not sizes & full


def test_axis_errors_equal_jax(env):
    _, bank, jbank = env
    with pytest.raises(ValueError) as got:
        BankShardedBank(bank, make_mesh({"time": 2}, devices=["cpu"] * 2))
    with pytest.raises(ValueError) as want:
        JaxBankShardedBank(jbank, jax_make_mesh({"time": 2}))
    assert str(got.value) == str(want.value) == "mesh has no axis 'bank'"


# ── The constants, array by array ──


def _carry(c):
    fields = {
        f.name: getattr(c, f.name) if f.metadata.get("static") else np.asarray(getattr(c, f.name))
        for f in dataclasses.fields(c)
    }
    return consts_from_numpy(type(c).__name__, fields, CPU)


def _same_consts(a, b, where):
    assert type(a) is type(b), where
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f"{where}.{f.name}"
            assert torch.equal(x, y), f"{where}.{f.name}"
        else:
            assert x == y, f"{where}.{f.name}"


@pytest.mark.parametrize("g_pad", [8, 9, 12])
def test_pad_group_consts_equals_jax(env, g_pad):
    _, _, jbank = env
    for gi, g in enumerate(jbank.classes[1]["groups"]):
        jc, jv = jbankshard.pad_group_consts(g.corr, g.verify, g_pad)
        tc, tv = pad_group_consts(_carry(g.corr), _carry(g.verify), g_pad)
        _same_consts(tc, _carry(jc), f"group {gi} corr")
        _same_consts(tv, _carry(jv), f"group {gi} verify")
        assert tc.self_corr_max.shape == (g_pad,)
    with pytest.raises(ValueError) as got:
        pad_group_consts(_carry(g.corr), _carry(g.verify), 4)
    with pytest.raises(ValueError) as want:
        jbankshard.pad_group_consts(g.corr, g.verify, 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_group_consts_equals_jax_shards(env, n):
    """Shard k of the port holds what JAX places on device k of the bank
    axis (the k-th contiguous slice of every G-leading array) and a replica
    of the shared structure."""
    _, _, jbank = env
    jmesh = jax_make_mesh({"bank": n})
    for gi, g in enumerate(jbank.classes[1]["groups"]):
        jc, jv = jbankshard.shard_group_consts(jmesh, "bank", g.corr, g.verify)
        shards = shard_group_consts(logical_mesh(n), "bank", _carry(g.corr), _carry(g.verify))
        assert len(shards) == n

        def on_device(consts, k):
            """JAX's consts as device k of the bank axis holds them."""
            fields = {}
            for f in dataclasses.fields(consts):
                v = getattr(consts, f.name)
                if f.metadata.get("static"):
                    fields[f.name] = v
                    continue
                shard = next(s for s in v.addressable_shards if s.device == jmesh.devices[k])
                fields[f.name] = np.asarray(shard.data)
            return consts_from_numpy(type(consts).__name__, fields, CPU)

        for k, (tc, tv) in enumerate(shards):
            _same_consts(tc, on_device(jc, k), f"group {gi} shard {k} corr")
            _same_consts(tv, on_device(jv, k), f"group {gi} shard {k} verify")
            assert tc.self_corr_max.shape == (8 // n,)
