"""The port on a CUDA card: the candidate-scan kernel and the main path.

Every test here carries the ``cuda`` marker and skips without a card. The
file imports no jax, so it runs where jax is not installed:

    APD_TPU_TESTS=1 python -m pytest tests/test_torch_cuda.py -m cuda

(``APD_TPU_TESTS=1`` keeps tests/conftest.py from importing jax.) The
kernel is held bitwise to its plain torch version: the scan has no float
sum, and every cross-block reduction is a max, an or or an integer sum.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from chip_smoke import (
    BATCHED_SCAN_SHAPES,
    EDGE_LENGTHS,
    EDGE_WIDE,
    WIDE_ROWS,
    batched_scan_input,
    check_scan_edges,
    check_scan_equal,
    edge_shapes,
    make_scan_input,
    reference_in_row_chunks,
)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(REPO, "sample_audios")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "g,l,valid_len",
    [
        (3, 6001, 6001),
        (3, 6001, 5224),
        (2, 1537, 1500),  # L not a multiple of the 512-sample block
        (4, 2048, 2044),
        (2, 1024, 0),  # nothing valid
        (1, 40, 40),  # shorter than one tile
        (32, 495_999, 494_765),  # the flagship normal group
    ],
)
def test_kernel_bitwise_equals_plain_version(cuda, g, l, valid_len):
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    corr_np, thr_np = make_scan_input(g, l, seed=l)
    corr = torch.from_numpy(corr_np).to(cuda)
    thr = torch.from_numpy(thr_np).to(cuda)
    before = candidate_scan.launches
    got = candidate_scan(corr, thr, valid_len)
    want = candidate_scan_reference(corr, thr, valid_len)
    torch.cuda.synchronize()
    assert candidate_scan.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("l", EDGE_LENGTHS)
def test_kernel_bitwise_at_edge_shapes(cuda, l):
    """G in (1, 3, 64), valid_len in (0, 1, 2, L-1, L) and mixed per-row
    lengths, with plateaus and 8-ulp pairs across every tile edge and at
    both row ends, and an all -inf row; thresholds few samples reach and
    thresholds every sample reaches."""
    assert check_scan_edges(cuda, edge_shapes(lengths=(l,))) > 0


@pytest.mark.parametrize("g,l", EDGE_WIDE)
def test_kernel_bitwise_where_ctas_walk_several_tiles(cuda, g, l):
    """More tiles than the card holds CTAs: each CTA reuses ring stages,
    crosses row ends and flushes several rows' stats."""
    assert check_scan_edges(cuda, [(g, l)]) > 0


@pytest.mark.parametrize("g,l", [(3, 6001), (32, 495_999)])
def test_kernel_bitwise_at_threshold_zero(cuda, g, l):
    """A threshold of 0 puts every finite sample at or above it: every
    sample runs the threshold-side tests."""
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    corr_np, _ = make_scan_input(g, l, seed=l)
    corr = torch.from_numpy(corr_np).to(cuda)
    zero = torch.zeros(g, device=cuda)
    for a, b in zip(candidate_scan(corr, zero, l - 3), candidate_scan_reference(corr, zero, l - 3)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("g,l", [(32, 495_999), (32, 489_999)])
def test_kernel_per_row_valid_len_at_flagship_shapes(cuda, g, l):
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    corr_np, thr_np = make_scan_input(g, l, seed=l)
    corr = torch.from_numpy(corr_np).to(cuda)
    thr = torch.from_numpy(thr_np).to(cuda)
    lens = torch.from_numpy(np.linspace(0, l, g).astype(np.int32)).to(cuda)
    for a, b in zip(candidate_scan(corr, thr, lens), candidate_scan_reference(corr, thr, lens)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("g,l", BATCHED_SCAN_SHAPES)
def test_kernel_bitwise_at_the_batched_round_shapes(cuda, g, l):
    """16 rounds of a flagship group as one launch, (512, L), with per-row
    lengths mixing full, short, lead-in-only and zero rows; each probed
    row equals the same row scanned alone at its own length."""
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    corr, thr, lens = batched_scan_input(g, l, seed=l, dev=cuda)
    before = candidate_scan.launches
    got = candidate_scan(corr, thr, lens)
    assert candidate_scan.launches == before + 1
    check_scan_equal(got, candidate_scan_reference(corr, thr, lens))
    for gi in range(0, g, 37):
        alone = candidate_scan(corr[gi : gi + 1], thr[gi : gi + 1], int(lens[gi]))
        check_scan_equal(alone, tuple(o[gi : gi + 1] for o in got))


def test_kernel_bitwise_past_32_bit_flat_offsets(cuda):
    """4,416 rows of 495,999 samples: 2.19e9 samples, so a 32-bit flat
    offset would wrap. The plain version runs 32 rows at a time."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    g, l = WIDE_ROWS, 495_999
    assert g * l > 2**31
    corr_np, thr_np = make_scan_input(32, l, seed=9)
    corr = torch.from_numpy(corr_np).to(cuda).repeat(g // 32, 1)
    thr = torch.from_numpy(np.tile(thr_np, g // 32)).to(cuda)
    lens = torch.from_numpy(np.random.default_rng(9).integers(0, l + 1, g).astype(np.int32)).to(cuda)
    check_scan_equal(candidate_scan(corr, thr, lens), reference_in_row_chunks(corr, thr, lens, 32))


def test_flagship_round_vmap_equals_scan_on_the_card(cuda):
    """The batched flagship step: 2 kernel launches a round, its payload
    bitwise the 16 single steps' (every field is integer-valued)."""
    from audio_pattern_detector_tpu_torch.flagship import flagship_round
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    step, _, _ = flagship_round(cuda)
    before = candidate_scan.launches
    batched = step("vmap")
    assert candidate_scan.launches == before + 2
    rows = step("scan")
    assert candidate_scan.launches == before + 2 + 32
    assert torch.equal(batched.view(torch.int32), rows.view(torch.int32))


@pytest.mark.parametrize("height_min", [None, 0.0])
def test_vmap_round_on_card_equals_scan_and_cpu(cuda, height_min):
    """A round with a first chunk, hits, a short chunk with an int16 tail
    and a zero-length row, in the lean tier and at ``height_min`` 0: the
    vmap payload on the card equals the scan schedule's bit for bit, the
    results equal the CPU's, and vmap launches the kernel once per group."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    sr = 8000
    t = np.arange(int(0.6 * sr)) / sr
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tone = np.sin(2 * np.pi * 941.0 * np.arange(2000) / sr).astype(np.float32)
    clips = [
        AudioClip(name="c", audio=clip, sample_rate=sr),
        AudioClip(name="m", audio=tone, sample_rate=sr, strategy="marker_tone",
                  strategy_params={"dominant_frequency_hz": 941.0}),
    ]
    audio = 0.01 * np.random.default_rng(3).standard_normal(25 * sr)
    for s0 in (4.0, 9.8, 18.0):
        audio[int(s0 * sr) : int(s0 * sr) + len(clip)] += clip
    audio[13 * sr : 13 * sr + 2000] += 0.8 * tone
    f32 = audio.astype(np.float32)
    i16 = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    chunk = 10 * sr
    rows = [(f32[:chunk], None), (f32[chunk : 2 * chunk], f32[:chunk]),
            (np.zeros(0, np.float32), None), (f32[2 * chunk :], i16[chunk : 2 * chunk])]
    chunks, tails = [c for c, _ in rows], [p for _, p in rows]
    kwargs = {} if height_min is None else {"height_min": height_min}
    out = {}
    for dev in ("cpu", cuda):
        bank = TorchAudioPatternDetector(
            clips, device=dev, seconds_per_chunk=10, **kwargs)._ensure_bank()
        for mode in ("scan", "vmap"):
            before = candidate_scan.launches
            d = bank.dispatch_chunks_batch(chunks, None, mode=mode, prev_tails=tails)
            payload = [h.numpy().copy() for _, h, *_ in d]
            out[str(dev), mode] = (payload, bank.collect_chunks_batch(d))
            if dev != "cpu":
                assert candidate_scan.launches - before >= (2 if mode == "vmap" else 8)
    (pv, rv), (ps, rs) = out[str(cuda), "vmap"], out[str(cuda), "scan"]
    for a, b in zip(pv, ps):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    assert rv == rs == out["cpu", "vmap"][1] == out["cpu", "scan"][1]
    # 'full' positions: the clip planted at 4.0 s ends at 4.0 * sr + m - 1.
    assert 4 * sr + len(clip) - 1 in rv[0]["c"] and rv[2] == {"c": [], "m": []}


def test_kernel_launches_on_two_streams_and_after_a_wider_launch(cuda):
    """Launches interleaved on two streams, a wide G after a narrow one and
    the narrow one again all equal the plain version: each launch zeroes
    its own outputs on its own stream."""
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    side = torch.cuda.Stream()
    for g, l in ((2, 9001), (64, 5000), (2, 9001)):
        corr_np, thr_np = make_scan_input(g, l, seed=g + l)
        corr = torch.from_numpy(corr_np).to(cuda)
        thr = torch.from_numpy(thr_np).to(cuda)
        want = candidate_scan_reference(corr, thr, l - 7)
        got = [candidate_scan(corr, thr, l - 7)]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got.append(candidate_scan(corr, thr, l - 7))
        got.append(candidate_scan(corr, thr, l - 7))
        torch.cuda.synchronize()
        for outs in got:
            for a, b in zip(outs, want):
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    corr = torch.rand((2, 3000), device=cuda)
    thr = torch.full((2,), 0.5, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        candidate_scan(corr.t().contiguous().t(), thr, 3000)
    with pytest.raises(ValueError, match="float32"):
        candidate_scan(corr.double(), thr, 3000)
    with pytest.raises(ValueError, match="thr_min"):
        candidate_scan(corr, thr[:1], 3000)
    with pytest.raises(ValueError, match="valid_len"):
        candidate_scan(corr, thr, 3001)
    with pytest.raises(ValueError, match="valid_len"):
        candidate_scan(corr, thr, torch.full((2,), 5, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="valid_len"):
        candidate_scan(corr, thr, torch.full((3,), 5, dtype=torch.int32, device=cuda))


def _cli_events(argv):
    from audio_pattern_detector_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]


def test_cli_on_card_gives_the_golden_events_through_the_kernel(cuda):
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    before = candidate_scan.launches
    rthk = os.path.join(AUDIO, "rthk_section_with_beep.wav")
    events = _cli_events([
        "match", "--timestamp-format", "ms",
        "--pattern-file", os.path.join(AUDIO, "clips", "rthk_beep.apd.toml"), rthk,
    ])
    assert events == [
        {"type": "start", "source": rthk},
        {"type": "pattern_detected", "clip_name": "rthk_beep", "timestamp_ms": 1408},
        {"type": "pattern_detected", "clip_name": "rthk_beep", "timestamp_ms": 2420},
        {"type": "end", "total_time_ms": 4078},
    ]
    assert candidate_scan.launches > before


def test_file_mode_on_card_equals_cpu(cuda):
    argv = [
        "match", "--timestamp-format", "ms",
        "--pattern-file", os.path.join(AUDIO, "clips", "cbs_news.wav"),
        os.path.join(AUDIO, "cbs_news_audio_section.wav"),
    ]
    on_card = _cli_events(argv[:1] + ["--device", "cuda"] + argv[1:])
    assert on_card == _cli_events(argv[:1] + ["--device", "cpu"] + argv[1:])
    assert [e.get("timestamp_ms") for e in on_card if e["type"] == "pattern_detected"] == [25899]


def test_flagship_payloads_kernel_equal_plain(cuda):
    from audio_pattern_detector_tpu_torch.flagship import flagship_step
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )

    step, _ = flagship_step(cuda)
    for a, b in zip(step(candidate_scan), step(candidate_scan_reference)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_topk_sparse_orders_ties_on_the_card(cuda):
    """``torch.topk`` promises no order among equal values on CUDA; the
    port's capture must still give (height descending, position ascending)
    on the finite lanes, as on the CPU."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops.peaks import topk_sparse

    rng = np.random.default_rng(5)
    x = np.full((4, 200_000), -np.inf, dtype=np.float32)
    for row in x:
        pos = rng.choice(len(row), size=900, replace=False)
        row[pos] = rng.choice(np.float32([0.3, 0.5, 0.5, 0.9]), len(pos))
    got_h, got_p = topk_sparse(torch.from_numpy(x).to(cuda), 1024)
    want_h, want_p = topk_sparse(torch.from_numpy(x), 1024)
    fin = torch.isfinite(want_h)
    assert torch.equal(got_h.cpu(), want_h)
    assert torch.equal(got_p.cpu()[fin], want_p[fin])
    for h, p in zip(want_h, want_p):
        n = int(torch.isfinite(h).sum())
        key = list(zip((-h[:n]).tolist(), p[:n].tolist()))
        assert n == 900 and key == sorted(key)


def _host_expected(bank, g, ci, section):
    from audio_pattern_detector_tpu_torch.models import hostpath

    return hostpath.process_section_host(
        audio_section=section, clip=g.clips_np[ci], correlation_clip=g.corr_clips_np[ci],
        correlation_clip_absolute_max=float(g.self_max_np[ci]), sr=8000,
        height_min=bank.height_min, is_short_clip=g.clip_len / 8000 < 0.5,
        tone_frequency=g.tone_freqs[ci], verification_params=g.verification_params[ci],
    )


@pytest.mark.parametrize("route", ["row", "class", "escalated"])
def test_wide_rerun_on_the_card_equals_the_host_path(cuda, route):
    """The three device routes of a flag-2 row (the CPU twins are in
    tests/test_torch_rerun.py): detections equal the exact host path's and
    no row reaches it."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    sr = 8000
    rng = np.random.default_rng(31)
    if route == "escalated":
        tone = (0.8 * np.sin(2 * np.pi * 1040.0 * np.arange(2000) / sr)).astype(np.float32)
        clips = [AudioClip(name="m", audio=tone, sample_rate=sr, strategy="marker_tone")]
        audio = (0.002 * np.random.default_rng(5).standard_normal(20 * sr)).astype(np.float32)
        audio[sr : sr + 2000] += tone
        for k in range(18):
            o = int((2.0 + 0.6 * k) * sr)
            audio[o : o + 2000] += 0.3 * tone
        want_routes = (2, 0, 1, 0)
    else:
        base = (0.4 * rng.standard_normal(sr)).astype(np.float32)
        n = 1 if route == "row" else 6
        clips = [AudioClip(name=f"c{i}", audio=base * (0.8 + 0.04 * i), sample_rate=sr)
                 for i in range(n)]
        audio = (0.004 * rng.standard_normal(24 * sr)).astype(np.float32)
        for k in range(20):
            o = int((0.3 + 1.05 * k) * sr)
            audio[o : o + sr] += base
        want_routes = (1, 0, 0, 0) if route == "row" else (0, 1, 0, 0)
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=24)._ensure_bank()
    got = bank.process_chunk(audio, None)
    g = bank.classes[1]["groups"][0]
    for ci, name in enumerate(g.names):
        assert got[name] == _host_expected(bank, g, ci, audio)
    routes = (bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows)
    assert routes == want_routes


def test_multistream_session_on_card_equals_cpu(cuda):
    """Tiled and untiled rounds with an int16 stream, an f32 stream that
    starts late and a zero-length chunk: every round's output on the card
    equals the CPU's, and the kernel launches once per dispatched row."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    sr = 8000
    t = np.arange(int(0.6 * sr)) / sr
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    rng = np.random.default_rng(7)
    streams = []
    for k in range(3):
        audio = 0.01 * rng.standard_normal(25 * sr)
        for s in (3.0 + k, 9.8, 18.0 + k):
            audio[int(s * sr) : int(s * sr) + len(clip)] += clip
        streams.append(audio)
    streams[0] = np.clip(np.round(streams[0] * 32768), -32768, 32767).astype(np.int16)
    streams[1] = streams[1].astype(np.float32)
    streams[2] = streams[2].astype(np.float32)
    chunks = [[s[o : o + 10 * sr] for o in range(0, len(s), 10 * sr)] for s in streams]
    rounds = [
        [chunks[0][r] if r < 3 else None, chunks[1][r - 1] if 0 < r <= 3 else None,
         {0: chunks[2][0], 1: np.zeros(0, np.float32)}.get(r, chunks[2][r - 1])]
        for r in range(4)
    ]
    clips = [AudioClip(name="c", audio=clip, sample_rate=sr)]
    for tile in (None, 2):
        outs = {}
        for dev in ("cpu", cuda):
            det = TorchAudioPatternDetector(clips, device=dev, seconds_per_chunk=10)
            session = MultiStreamSession(det, 3, tile=tile)
            before = candidate_scan.launches
            outs[str(dev)] = [session.feed(r) for r in rounds]
            launched = candidate_scan.launches - before
        active = sum(c is not None and len(c) > 0 for r in rounds for c in r)
        assert launched == (active if tile else 3 * len(rounds))
        assert outs["cpu"] == outs[str(cuda)]
        # 9 planted hits; the one at 19 s lies in the next section's 1 s
        # lookback too, and is reported there again, as the serial engine does.
        assert sum(len(ts) for out in outs["cpu"] for r in out for ts in r.values()) == 10


# ── The device mesh on logical shards of the card ──


def _mesh_clips(np):
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    sr = 8000
    clips = [
        AudioClip(name=f"n{i}", audio=(0.4 * np.random.default_rng(42 + i).standard_normal(sr))
                  .astype(np.float32), sample_rate=sr)
        for i in range(3)
    ]
    t = np.arange(sr // 4) / sr
    clips.append(AudioClip(
        name="beep", audio=np.sin(2 * np.pi * 1000.0 * t).astype(np.float32), sample_rate=sr,
        strategy="marker_tone", strategy_params={"dominant_frequency_hz": 1000.0}))
    audio = (0.01 * np.random.default_rng(5).standard_normal((2, 44 * sr))).astype(np.float32)
    for b, offsets in enumerate(([1.5, 13.0, 33.25], [6.0, 21.5, 40.0])):
        for off in offsets:
            audio[b, int(off * sr) : int(off * sr) + sr] += clips[b].audio
        audio[b, 9 * sr + b * sr // 2 : 9 * sr + b * sr // 2 + sr // 4] += 0.7 * clips[3].audio
    return clips, audio


@pytest.mark.parametrize(
    "axes", [{"time": 4}, {"stream": 2, "time": 2}, {"bank": 2, "time": 2}],
    ids=["time4", "stream2_time2", "bank2_time2"],
)
def test_sharded_detector_on_logical_shards_of_the_card(cuda, axes):
    """Two 44 s streams in 5 s chunks (two full slabs and a short one on a
    4-shard time mesh): the sharded scan on logical shards of the card
    equals the serial engine on the card and the sharded scan on the CPU;
    with the plain scan substituted the cells' payloads are bit-equal; the
    kernel launches once per active cell and group."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import (
        candidate_scan,
        candidate_scan_reference,
    )
    from audio_pattern_detector_tpu_torch.parallel import ShardedDetector, make_mesh
    from audio_pattern_detector_tpu_torch.utils.clip import AudioStream

    clips, audio = _mesh_clips(np)
    n = int(np.prod(list(axes.values())))
    batch = audio[: axes.get("stream", 1)]

    def run(dev, scan=None):
        sd = ShardedDetector(clips, make_mesh(axes, devices=[dev] * n), chunk_seconds=5,
                             device=dev)
        if scan is not None:
            sd.scan = scan
        sess, payloads, times = sd.session(), [], {c.name: [[] for _ in batch] for c in clips}
        for start in range(0, batch.shape[1], sd.slab_samples):
            for name, per in sess.feed(batch[:, start : start + sd.slab_samples]).items():
                for b, ts in enumerate(per):
                    times[name][b].extend(ts)
            payloads.append({sw: [p.copy() for p in ps] for sw, ps in sess.last_payloads.items()})
        return sd, times, payloads

    candidate_scan.launches = 0
    sd, times, payloads = run(cuda)
    launches = candidate_scan.launches
    groups = sum(len(c["groups"]) for c in sd.bank.classes.values())
    chunks = -(-batch.shape[1] // sd.chunk_samples)
    assert launches == chunks * axes.get("stream", 1) * axes.get("bank", 1) * groups
    _, cpu_times, _ = run("cpu")
    assert times == cpu_times
    _, plain_times, plain_payloads = run(cuda, candidate_scan_reference)
    assert plain_times == times
    for slab, other in zip(payloads, plain_payloads):
        for sw in slab:
            for a, b in zip(slab[sw], other[sw]):
                assert a.tobytes() == b.tobytes()
    det = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=5)
    for b, row in enumerate(batch):
        serial, _ = det.find_clip_in_audio(AudioStream(
            name="s", audio_stream=io.BytesIO(row.tobytes()), sample_rate=8000))
        assert {name: sorted(per[b]) for name, per in times.items()} == serial
    assert times["n0"][0] and times["beep"][0]


def test_bank_sharded_bank_and_stream_mesh_on_the_card(cuda):
    """``BankShardedBank`` on 3 logical shards (groups of 3 and 1 pad to
    3 and 3) and a 4-slot session on a 2-shard stream mesh, on the card:
    equal to the unsharded bank and session, payloads bit for bit."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
    from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh

    clips, audio = _mesh_clips(np)
    sr = 8000
    det = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)
    bank = det._ensure_bank()
    c0, c1 = audio[0, : 10 * sr], audio[0, 10 * sr : 20 * sr]
    sharded = BankShardedBank(bank, make_mesh({"bank": 3}, devices=[cuda] * 3))
    want = [rec[1].numpy().copy() for rec in bank.dispatch_chunk(c1, c0)]
    got = [rec[1].numpy() for rec in sharded.dispatch_chunk(c1, c0)]
    for (sw, cls), g, w in zip(bank.classes.items(), got, want):
        off_g = off_w = 0
        for grp, rows in zip(cls["groups"], sharded._padded_rows[sw]):
            width = 2 * grp.k_verify + 2
            real = len(grp.names) * width
            assert g[off_g : off_g + real].tobytes() == w[off_w : off_w + real].tobytes()
            off_g, off_w = off_g + rows * width, off_w + real
    assert sharded.process_chunk(c1, c0) == bank.process_chunk(c1, c0)

    mesh = make_mesh({"stream": 2}, devices=[cuda] * 2)
    rounds = [[audio[0, :10 * sr], audio[1, :10 * sr], None, audio[1, 20 * sr : 23 * sr]],
              [audio[0, 10 * sr : 20 * sr], np.zeros(0, np.float32), audio[1, :10 * sr], None]]
    meshed = MultiStreamSession(det, 4, mesh=mesh)
    plain = MultiStreamSession(det, 4, batch_mode="vmap")
    for chunks in rounds:
        assert meshed.feed(chunks) == plain.feed(chunks)


def test_kernel_wrapper_launches_under_the_tensors_device(cuda):
    """The wrapper makes corr's device current around the launch; with one
    card that is the device already current, and the launch count, the
    outputs' device and the bitwise result stay what they were."""
    from audio_pattern_detector_tpu_torch.ops import candidate_scan as scan_module

    corr_np, thr_np = make_scan_input(3, 6001, seed=1)
    corr = torch.from_numpy(corr_np).to("cuda:0")
    thr = torch.from_numpy(thr_np).to("cuda:0")
    guards = []
    guard = scan_module.device_guard

    def recording(dev):
        guards.append(dev)
        return guard(dev)

    scan_module.device_guard = recording
    try:
        got = scan_module.candidate_scan(corr, thr, 6001)
    finally:
        scan_module.device_guard = guard
    assert guards == [corr.device] and all(o.device == corr.device for o in got)
    check_scan_equal(got, scan_module.candidate_scan_reference(corr, thr, 6001))


def test_marker_gemm_runs_at_f32_with_tf32_allowed(cuda):
    """The marker DFT-GEMM switches TF32 off around its product: with TF32
    allowed process-wide it stays within f32 error of the f64 spectrum,
    and the process's setting comes back unchanged."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops.verify import _rfft_power_gemm

    x = np.random.default_rng(5).standard_normal((512, 2000)).astype(np.float32)
    exact = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = _rfft_power_gemm(torch.from_numpy(x).to(cuda), 2000).cpu().double().numpy()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    assert np.abs(got - exact).max() <= 1e-5 * exact.max()


@pytest.mark.parametrize("switch", ["APD_PALLAS=0", "none", "APD_NO_OVERLAP_SAVE=1",
                                    "APD_MARKER_GEMM=1"])
def test_class_step_switch_on_card_equals_cpu(cuda, switch, monkeypatch):
    """A vmap round with hits under one of the JAX package's switches, or
    none (the default path): the card's results equal the CPU's with the
    same switch, and the mask tier (``APD_PALLAS=0``) launches no kernel."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    if switch != "none":
        name, value = switch.split("=")
        monkeypatch.setenv(name, value)
    sr = 8000
    t = np.arange(int(0.6 * sr)) / sr
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tone = np.sin(2 * np.pi * 941.0 * np.arange(2000) / sr).astype(np.float32)
    clips = [
        AudioClip(name="c", audio=clip, sample_rate=sr),
        AudioClip(name="m", audio=tone, sample_rate=sr, strategy="marker_tone",
                  strategy_params={"dominant_frequency_hz": 941.0}),
    ]
    audio = 0.01 * np.random.default_rng(3).standard_normal(25 * sr)
    for s0 in (4.0, 9.8, 18.0):
        audio[int(s0 * sr) : int(s0 * sr) + len(clip)] += clip
    audio[13 * sr : 13 * sr + 2000] += 0.8 * tone
    f32 = audio.astype(np.float32)
    chunk = 10 * sr
    chunks = [f32[:chunk], f32[chunk : 2 * chunk], f32[2 * chunk :]]
    out = {}
    for dev in ("cpu", cuda):
        bank = TorchAudioPatternDetector(clips, device=dev, seconds_per_chunk=10)._ensure_bank()
        before = candidate_scan.launches
        out[str(dev)] = bank.process_chunks_batch(chunks, None, mode="vmap")
        launched = candidate_scan.launches - before
    assert launched == (0 if switch == "APD_PALLAS=0" else 2)
    assert out[str(cuda)] == out["cpu"]
    assert 4 * sr + len(clip) - 1 in out["cpu"][0]["c"] and out["cpu"][1]["m"]


# ── Captured class steps (models/captured.py) against the eager step ──


def _eager_then_captured(bank, fn, calls=2):
    """``fn()`` with the bank's step eager, then ``calls`` times captured
    (the key's first use, then replays), on the same bank."""
    bank.capture = False
    eager = fn()
    bank.capture = True
    got = [fn() for _ in range(calls)]
    torch.cuda.synchronize()
    return eager, got


def _bitwise(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_captured_flagship_step_equals_eager(cuda):
    """The flagship step (one section, each group's payload) as a replay of
    its one-row graph: bitwise the eager step's; the first use counts its
    eager run's launches, each replay its graph's two."""
    from audio_pattern_detector_tpu_torch.flagship import flagship_step
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    step, bank = flagship_step(cuda)
    assert bank.capture is True
    before = candidate_scan.launches
    eager, got = _eager_then_captured(bank, step, calls=3)
    assert candidate_scan.launches - before == 2 * 4
    assert all(_bitwise(g, eager) for g in got)
    (captured,) = bank.graphs.steps()
    assert (captured.key.rows, captured.key.fused, captured.launches, captured.replays) == (
        1, False, 2, 2)


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_captured_flagship_round_equals_eager(cuda, mode):
    """The 16-row flagship round: "vmap" one replay of the 16-row graph,
    "scan" 16 replays of the one-row graph; bitwise the eager round's."""
    from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, flagship_round

    step, bank, _ = flagship_round(cuda)
    eager, got = _eager_then_captured(bank, lambda: step(mode))
    assert all(_bitwise(g, eager) for g in got)
    (captured,) = bank.graphs.steps()
    assert captured.key.rows == (ROUND_ROWS if mode == "vmap" else 1)
    assert captured.replays == (1 if mode == "vmap" else 2 * ROUND_ROWS - 1)


def test_captured_mask_tier_equals_eager(cuda, monkeypatch):
    """``APD_PALLAS=0``: the mask tier's round captured, bitwise the eager
    round's, with no kernel in its graph."""
    from audio_pattern_detector_tpu_torch.flagship import flagship_round
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan

    monkeypatch.setenv("APD_PALLAS", "0")
    step, bank, _ = flagship_round(cuda)
    monkeypatch.delenv("APD_PALLAS")
    before = candidate_scan.launches
    eager, got = _eager_then_captured(bank, lambda: step("vmap"))
    assert candidate_scan.launches == before and not bank.kernel_tier
    assert all(_bitwise(g, eager) for g in got)
    assert [s.key.kernel_tier for s in bank.graphs.steps()] == [False]


@pytest.mark.parametrize("height_min", [None, 0.0], ids=["lean", "general"])
def test_captured_bank_and_stream_shards_equal_eager(cuda, height_min):
    """A bank-sharded chunk on 3 logical shards (a graph per shard's slice)
    and a stream-sharded round on 2 (the shards share the bank's graph):
    payloads bitwise the eager ones, in the lean tier and in the
    general-plateau tier, whose while and if bodies read the shard's
    sliced constants."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.parallel import BankShardedBank, make_mesh
    from audio_pattern_detector_tpu_torch.parallel.mesh import RowSharding

    clips, audio = _mesh_clips(np)
    sr = 8000
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10,
                                     height_min=height_min)._ensure_bank()
    c0, c1 = audio[0, : 10 * sr], audio[0, 10 * sr : 20 * sr]
    sharded = BankShardedBank(bank, make_mesh({"bank": 3}, devices=[cuda] * 3))
    eager, got = _eager_then_captured(
        bank, lambda: [rec[1].numpy().copy() for rec in sharded.dispatch_chunk(c1, c0)])
    assert all(_bitwise(g, eager) for g in got)
    assert len({s.key.consts for s in bank.graphs.steps()}) == 3 * len(bank.classes)
    assert {s.key.general for s in bank.graphs.steps()} == {height_min == 0.0}

    rows = RowSharding(make_mesh({"stream": 2}, devices=[cuda] * 2), "stream")
    chunks = [audio[0, : 10 * sr], audio[1, : 10 * sr], np.zeros(0, np.float32),
              audio[1, 20 * sr : 23 * sr]]
    eager, got = _eager_then_captured(bank, lambda: [
        rec[1].numpy().copy() for rec in bank.dispatch_chunks_batch(
            chunks, None, mode="vmap", prev_tails=[None] * 4, sharding=rows)])
    assert all(_bitwise(g, eager) for g in got)


def _capture_clips():
    import numpy as np

    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    sr = 8000
    t = np.arange(int(0.6 * sr)) / sr
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tone = np.sin(2 * np.pi * 941.0 * np.arange(2000) / sr).astype(np.float32)
    clips = [
        AudioClip(name="c", audio=clip, sample_rate=sr),
        AudioClip(name="m", audio=tone, sample_rate=sr, strategy="marker_tone",
                  strategy_params={"dominant_frequency_hz": 941.0}),
    ]
    rounds = []
    for seed in range(3):
        audio = 0.01 * np.random.default_rng(40 + seed).standard_normal(40 * sr)
        for s0 in (4.0 + seed, 14.5, 27.0 + seed):
            audio[int(s0 * sr) : int(s0 * sr) + len(clip)] += clip
        audio[(21 + seed) * sr : (21 + seed) * sr + 2000] += 0.8 * tone
        rounds.append([audio[o : o + 10 * sr].astype(np.float32) for o in range(0, 40 * sr, 10 * sr)])
    return clips, rounds


def test_replays_take_new_inputs_with_rounds_in_flight(cuda):
    """Three different rounds dispatched back to back through one graph,
    none collected before the last is enqueued: each payload is its own
    round's, bitwise the eager one's."""
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()
    bank.capture = False
    eager = [[h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(r, None)]
             for r in rounds]
    bank.capture = True
    for order in ([0, 1, 2], [2, 0, 1]):
        in_flight = [bank.dispatch_chunks_batch(rounds[i], None) for i in order]
        for i, dispatched in zip(order, in_flight):
            assert _bitwise([h.numpy() for _, h, *_ in dispatched], eager[i])
    assert len(eager[0]) == len(bank.classes)
    assert [s.replays for s in bank.graphs.steps()] == [5] * len(bank.classes)


def test_replays_match_after_the_caches_evict(cuda, monkeypatch):
    """After capture, the DFT-matrix cache and torch's cuFFT plan cache are
    emptied, other transforms made and the freed memory filled with NaN:
    replays still equal the eager round (the graph holds what it reads)."""
    import gc

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.ops import verify

    monkeypatch.setenv("APD_MARKER_GEMM", "1")
    clips, rounds = _capture_clips()
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()

    def run():
        return [h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(rounds[0], None)]

    eager, got = _eager_then_captured(bank, run)
    assert all(_bitwise(g, eager) for g in got)
    assert [s.key.marker_gemm for s in bank.graphs.steps()] == [True] * len(bank.classes)
    verify._dft_matrix.cache_clear()
    torch.backends.cuda.cufft_plan_cache[cuda.index or 0].clear()
    gc.collect()
    torch.cuda.empty_cache()
    for n in (1000, 3001, 5000, 12_345, 40_000):
        torch.fft.irfft(torch.fft.rfft(torch.randn(32, n, device=cuda)), n=n)
    free, _ = torch.cuda.mem_get_info()
    junk = torch.full((int(free * 0.5) // 4,), float("nan"), device=cuda)
    again = run()
    del junk
    assert _bitwise(again, eager)


@pytest.mark.parametrize("hits", ["none", "both_groups"])
def test_captured_verify_node_equals_no_node_and_eager(cuda, monkeypatch, hits):
    """``APD_SKIP_EMPTY_VERIFY``: the captured one-row and round graphs
    with the conditional node (the default) against a bank built with the
    switch at 0 and against the eager step, on rounds with no candidate and
    with hits in both groups: payloads bit for bit."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    if hits == "none":
        rng = np.random.default_rng(7)
        rounds = [[(0.01 * rng.standard_normal(10 * 8000)).astype(np.float32)
                   for _ in range(4)]]
    node = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()
    monkeypatch.setenv("APD_SKIP_EMPTY_VERIFY", "0")
    none = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()
    monkeypatch.delenv("APD_SKIP_EMPTY_VERIFY")
    assert node.skip_empty_verify and not none.skip_empty_verify
    for mode in ("vmap", "scan"):
        def run(bank, mode=mode):
            return [h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(
                rounds[0], None, mode=mode)]

        eager, got = _eager_then_captured(node, lambda: run(node))
        assert all(_bitwise(g, eager) for g in got)
        assert all(_bitwise(run(none), eager) for _ in range(2))
    assert {s.key.skip_empty_verify for s in node.graphs.steps()} == {True}
    assert {s.key.skip_empty_verify for s in none.graphs.steps()} == {False}


def test_staging_buffers_are_pinned_and_recycled_on_the_card(cuda):
    """A CUDA bank stages its rows in pinned host memory, uploads them
    without blocking, and takes the same buffer again once the round is
    collected; results equal the CPU bank's."""
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()
    cpu = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=10)._ensure_bank()
    first = bank.dispatch_chunks_batch(rounds[0], None)
    buffers = [rec[4] for rec in first]
    assert all(torch.from_numpy(b).is_pinned() for b in buffers)
    assert bank.collect_chunks_batch(first) == cpu.process_chunks_batch(rounds[0], None)
    second = bank.dispatch_chunks_batch(rounds[1], None)
    assert all(rec[4] is b for rec, b in zip(second, buffers))
    assert bank.collect_chunks_batch(second) == cpu.process_chunks_batch(rounds[1], None)


# ── The general-plateau tier's conditional nodes (csrc/graph_conditional.cu) ──


def test_while_node_runs_zero_one_and_many_iterations(cuda):
    """A captured ``CudaGraphBackend.while_loop`` whose body counts up to a
    limit set between replays: no pass for a limit of 0, then 1, 2 and
    1,000 passes, the state updated in place."""
    from audio_pattern_detector_tpu_torch.models.captured import CudaGraphBackend

    backend = CudaGraphBackend()
    limit = torch.zeros((), dtype=torch.int64, device=cuda)

    def step():
        i = torch.zeros((), dtype=torch.int64, device=cuda)
        total = torch.zeros((), dtype=torch.int64, device=cuda)
        go = i < limit

        def body():
            i.add_(1)
            total.add_(i * i)
            torch.lt(i, limit, out=go)

        backend.while_loop(go, body)
        return torch.stack([i, total])

    replay, out = backend.capture(cuda, step)
    for n in (0, 1, 2, 1000, 0):
        limit.fill_(n)
        replay()
        torch.cuda.synchronize()
        assert out.tolist() == [n, sum(k * k for k in range(1, n + 1))]


def test_two_way_cond_takes_each_side(cuda):
    """A captured ``CudaGraphBackend.cond``: each replay runs the side its
    predicate names (each side's body an FFT and an element-wise op, as
    the verifiers' are), never both."""
    from audio_pattern_detector_tpu_torch.models.captured import CudaGraphBackend

    backend = CudaGraphBackend()
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    x = torch.randn(8, 512, device=cuda)
    torch.fft.rfft(x)  # the plan exists before the capture

    def step():
        out = torch.full((8, 257), -1.0, device=cuda)
        backend.cond(flag, lambda: out.copy_(torch.fft.rfft(x).abs()),
                     lambda: out.copy_(torch.fft.rfft(x).angle()))
        return out

    replay, out = backend.capture(cuda, step)
    for side in (True, False, False, True):
        flag.fill_(side)
        replay()
        torch.cuda.synchronize()
        spectrum = torch.fft.rfft(x)
        assert torch.equal(out, spectrum.abs() if side else spectrum.angle())


@pytest.mark.parametrize("tier", ["kernel", "mask"])
@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_captured_general_step_equals_eager(cuda, monkeypatch, tier, mode):
    """``height_min = 0``: ``program`` gives the captured step, whose graph
    holds the lane greedy's while nodes and the two-tier verify's if-nodes;
    its round is bitwise the eager round, also after torch's cuFFT plan
    cache is emptied, and on the CPU's results."""
    from audio_pattern_detector_tpu_torch.models.captured import CapturedStep
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    if tier == "mask":
        monkeypatch.setenv("APD_PALLAS", "0")
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10,
                                     height_min=0.0)._ensure_bank()
    cpu = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=10,
                                    height_min=0.0)._ensure_bank()
    monkeypatch.delenv("APD_PALLAS", raising=False)
    (sw,) = bank.classes
    assert isinstance(bank.program(sw, cuda, 4), CapturedStep)

    def run(r=0):
        return [h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(
            rounds[r], None, mode=mode)]

    eager, got = _eager_then_captured(bank, run)
    assert all(_bitwise(g, eager) for g in got)
    assert {(s.key.general, s.key.kernel_tier) for s in bank.graphs.steps()} == {
        (True, tier == "kernel")}
    torch.backends.cuda.cufft_plan_cache[cuda.index or 0].clear()
    torch.cuda.empty_cache()
    assert _bitwise(run(), eager)
    other = bank.dispatch_chunks_batch(rounds[1], None, mode=mode)
    assert bank.collect_chunks_batch(other) == cpu.process_chunks_batch(rounds[1], None)
