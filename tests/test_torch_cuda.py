"""The port on a CUDA card: its kernels and the main path.

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
    LANE_GREEDY_KS,
    LANE_WORST_CASES,
    LEAN_GREEDY_CASES,
    LEAN_GREEDY_MS,
    MARKER_52S,
    VERIFY_MARKER_CASES,
    VERIFY_NORMAL_CASES,
    WIDE_ROWS,
    batched_scan_input,
    bitwise,
    check_scan_edges,
    check_scan_equal,
    edge_shapes,
    greedy_outputs_equal,
    lane_greedy_input,
    lane_worst_case,
    lean_greedy_case,
    lean_greedy_inputs,
    make_scan_input,
    marker_live_windows,
    random_lean_greedy_case,
    MARKER_SPECTRA_RTOL,
    np_marker_decisions,
    np_marker_spectra,
    np_verify_normal,
    reference_in_row_chunks,
    verify_marker_case,
    verify_marker_inputs,
    verify_normal_case,
    verify_normal_inputs,
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


@pytest.mark.parametrize("route", ["row", "escalated"])
def test_a_captured_row_rerun_on_the_card_is_the_eager_one_bit_for_bit(cuda, route):
    """A row rerun on a capturing bank is a graph of its own (one row, the
    clip's constants, its lanes), made at its first use and replayed after
    it: its payload equals the eager rerun's bit for bit, on the section and
    on a shorter one after it, and the chunk's detections and routes are the
    eager bank's."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    sr = 8000
    if route == "escalated":
        clip = AudioClip(name="m", audio=(0.8 * np.sin(2 * np.pi * 1040.0 * np.arange(2000) / sr)).astype(
            np.float32), sample_rate=sr, strategy="marker_tone")
        audio = (0.002 * np.random.default_rng(5).standard_normal(20 * sr)).astype(np.float32)
        audio[sr : sr + 2000] += clip.audio
        for k in range(18):
            o = int((2.0 + 0.6 * k) * sr)
            audio[o : o + 2000] += 0.3 * clip.audio
    else:
        rng = np.random.default_rng(31)
        clip = AudioClip(name="c", audio=(0.4 * rng.standard_normal(sr)).astype(np.float32), sample_rate=sr)
        audio = (0.004 * rng.standard_normal(20 * sr)).astype(np.float32)
        for k in range(18):
            o = int((0.3 + 1.05 * k) * sr)
            audio[o : o + sr] += clip.audio[: min(sr, len(audio) - o)]
    banks = [TorchAudioPatternDetector([clip], device=cuda, seconds_per_chunk=20, capture=c)._ensure_bank()
             for c in (False, True)]
    eager, bank = banks
    assert bank.capture and not eager.capture
    got = [b.process_chunk(audio, None) for b in banks]
    assert got[0] == got[1] == bank.process_chunk(audio, None)
    routes = [(b.row_reruns, b.class_reruns, b.escalated_reruns, b.host_path_rows) for b in banks]
    assert routes[1] == tuple(2 * n for n in routes[0]) and routes[0][0] >= 1
    steps = bank.rerun_graphs.steps()
    assert len(steps) == (2 if route == "escalated" else 1) and all(s.replays == 1 for s in steps)
    for section in (audio, audio[: 15 * sr]):
        for capped in (True, False):
            a, b = (x._full_tier_row(1, 0, 0, section, capped=capped) for x in banks)
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


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

    from audio_pattern_detector_tpu_torch.ops.verify_marker import _rfft_power_gemm

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


@pytest.mark.parametrize("switch", ["APD_PALLAS=0", "none", "APD_MARKER_GEMM=1"])
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
    eager run's launches, each replay its graph's seven (the loudness gate,
    and the correlation, the scan and the lean greedy a group each)."""
    from audio_pattern_detector_tpu_torch.flagship import flagship_step
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.correlate import cufft_correlation
    from audio_pattern_detector_tpu_torch.ops.correlate_os import correlate_os
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy
    from audio_pattern_detector_tpu_torch.ops.loudness import loudness_gate
    from audio_pattern_detector_tpu_torch.ops.verify_marker import verify_marker
    from audio_pattern_detector_tpu_torch.ops.verify_normal import verify_normal

    step, bank = flagship_step(cuda)
    assert bank.capture is True
    before = (candidate_scan.launches, lean_greedy.launches)
    eager, got = _eager_then_captured(bank, step, calls=3)
    assert (candidate_scan.launches - before[0], lean_greedy.launches - before[1]) == (
        2 * 4, 2 * 4)
    assert all(_bitwise(g, eager) for g in got)
    (captured,) = bank.graphs.steps()
    assert (captured.key.rows, captured.key.fused, captured.launches, captured.replays) == (
        1, False, 7, 2)
    # The verifiers launch inside each group's conditional body, which a
    # replay runs where the group has a live lane: counted from the payload
    # (chip_smoke.counted_verify_launches), not by a replay.
    assert captured.kernel_launches == {candidate_scan: 2, lane_greedy: 0, lean_greedy: 2,
                                        verify_normal: 0, verify_marker: 0, loudness_gate: 1,
                                        correlate_os: 2, cufft_correlation: 0}
    assert sorted(len(b) for b in captured.body_launches) == [1, 1]
    assert {w: n for b in captured.body_launches for w, n in b.items()} == {
        verify_normal: 1, verify_marker: 1}


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
    """After capture, the marker kernel's FFT-plan cache, the port's cuFFT
    plan cache and torch's are emptied, other transforms made and the freed
    memory filled with NaN: replays still equal the eager round (the graph
    holds what it reads, the cuFFT plans it replays among them).
    ``APD_MARKER_GEMM=1`` changes nothing on a card: its keys say so."""
    import gc

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector
    from audio_pattern_detector_tpu_torch.ops import cufft_plans, marker_fft

    monkeypatch.setenv("APD_MARKER_GEMM", "1")
    clips, rounds = _capture_clips()
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()

    def run():
        return [h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(rounds[0], None)]

    eager, got = _eager_then_captured(bank, run)
    assert all(_bitwise(g, eager) for g in got)
    assert [s.key.marker_gemm for s in bank.graphs.steps()] == [False] * len(bank.classes)
    marker_fft._cached.cache_clear()
    cufft_plans.clear_cache()
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


@pytest.mark.parametrize("shape, n", [((3, 4096), None), ((2, 5, 6001), 8192),
                                      ((16, 65_536), None), ((4, 3, 1000), 1000)])
def test_held_cufft_plans_agree_with_torch_fft(cuda, shape, n):
    """``ops/cufft_plans.py``'s rfft and irfft against ``torch.fft`` on the
    same inputs: within 1e-6 of the largest magnitude (the same library's
    transforms; equal bit for bit where both pick the same kernels)."""
    from audio_pattern_detector_tpu_torch.ops import cufft_plans

    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    size = n or shape[-1]
    spec, want = cufft_plans.rfft(x, n=n), torch.fft.rfft(x, n=n)
    assert spec.shape == want.shape and spec.dtype == torch.complex64
    assert float((spec - want).abs().max()) <= 1e-6 * float(want.abs().max())
    back, back_want = cufft_plans.irfft(want, n=size), torch.fft.irfft(want, n=size)
    assert back.shape == back_want.shape
    assert float((back - back_want).abs().max()) <= 1e-6 * float(back_want.abs().max())


@pytest.mark.parametrize("hits", ["none", "both_groups"])
def test_captured_verify_node_equals_eager(cuda, hits):
    """The captured one-row and round graphs with the conditional node
    against the eager step, which always verifies, on rounds with no
    candidate and with hits in both groups: payloads bit for bit."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    if hits == "none":
        rng = np.random.default_rng(7)
        rounds = [[(0.01 * rng.standard_normal(10 * 8000)).astype(np.float32)
                   for _ in range(4)]]
    node = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10)._ensure_bank()
    for mode in ("vmap", "scan"):
        def run(mode=mode):
            return [h.numpy().copy() for _, h, *_ in node.dispatch_chunks_batch(
                rounds[0], None, mode=mode)]

        eager, got = _eager_then_captured(node, run)
        assert all(_bitwise(g, eager) for g in got)
    assert {s.key.rows for s in node.graphs.steps()} == {1, 4}


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


def test_a_flagship_scan_round_staged_row_by_row_is_the_whole_upload_and_vmap_bit_for_bit(cuda):
    """On the flagship bank (64 clips, 60 s int16 chunks at 8 kHz), a
    captured 16-row scan round, each row packed, copied up and replayed
    before the next is packed, gives the payload of the same rows uploaded
    whole and then loaded and replayed row by row, and of the vmap round,
    bit for bit: with a zero-length idle row, a short row and rows with and
    without a lookback tail, from pinned staging buffers that the second
    round takes back from the pool; results equal the vmap round's."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.flagship import ROUND_ROWS, make_bank
    from audio_pattern_detector_tpu_torch.ops.packing import upload_rows

    sr, n = 8000, 60 * 8000
    bank = make_bank(num_normal=32, num_marker=32, chunk_seconds=60, device=cuda)
    assert bank.capture
    (sw,) = bank.classes
    rng = np.random.default_rng(0)  # make_detector's clips
    normal = [0.4 * rng.standard_normal(sr) for _ in range(32)]
    t = np.arange(round(0.25 * sr)) / sr

    def station_rows(seed):
        g = np.random.default_rng(seed)
        rows = []
        for i in range(ROUND_ROWS):
            if i == 5:
                rows.append((np.zeros(0, np.int16), None))
                continue
            audio = 0.05 * g.standard_normal(2 * n)
            o = n + int(g.integers(sr, n // 2 - 2 * sr))
            audio[o : o + sr] += normal[i]
            o = n + int(g.integers(sr, n // 2 - 2 * sr))
            audio[o : o + len(t)] += 0.8 * np.sin(2 * np.pi * (900.0 + 7.0 * i) * t)
            pcm = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
            rows.append((pcm[n : n + n // 2] if i == 11 else pcm[n:], pcm[:n] if i % 2 == 0 else None))
        return rows

    def dispatch(rows, mode):
        return bank.dispatch_chunks_batch([c for c, _ in rows], None, mode=mode,
                                          prev_tails=[p for _, p in rows])

    prog = bank.program(sw, cuda, dtype=torch.int16)
    seen: set = set()
    for seed in (1, 2):
        rows = station_rows(seed)
        (scan,) = dispatch(rows, "scan")
        _, handle, raws, _, staged = scan
        assert staged.dtype == np.int16 and torch.from_numpy(staged).is_pinned()
        assert (id(staged) in seen) == (seed == 2)
        whole = upload_rows(staged, cuda)
        replayed = []
        for bi in range(ROUND_ROWS):
            prog.load(whole[bi], len(raws[bi]))
            replayed.append(prog.run().reshape(-1))
        once = torch.stack(replayed).cpu().numpy()
        (vmap,) = dispatch(rows, "vmap")
        seen |= {id(staged), id(vmap[4])}
        got = handle.numpy().copy()
        assert got.shape[0] == ROUND_ROWS
        assert _bitwise(got, once) and _bitwise(got, vmap[1].numpy())
        results = bank.collect_chunks_batch([scan])
        assert results == bank.collect_chunks_batch([vmap])
        assert sum(len(v) for r in results for v in r.values()) >= ROUND_ROWS - 1
    assert {s.key.rows for s in bank.graphs.steps()} == {1, ROUND_ROWS}


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
    holds the lane greedy's launches and each verifier's one launch of
    every lane; its round is bitwise the eager round, also after torch's cuFFT plan
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


# ── Captured rounds wider than a graph, and the lean greedy's while node ──


def test_captured_general_round_wider_than_its_graph_equals_eager(cuda):
    """``height_min = 0``, a vmap round of ``GRAPH_ROWS`` + 3 rows: two
    replays of the W-row graph (the second with W - 3 idle rows), one key,
    bitwise the eager round's (in the same W-row steps); no eager step runs
    in a replay's place."""
    from audio_pattern_detector_tpu_torch.models import bank as bank_module
    from audio_pattern_detector_tpu_torch.models.captured import SplitRound
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    w = bank_module.GRAPH_ROWS
    chunks = [c for r in rounds * (w // 12 + 2) for c in r][: w + 3]
    bank = TorchAudioPatternDetector(clips, device=cuda, seconds_per_chunk=10,
                                     height_min=0.0)._ensure_bank()
    (sw,) = bank.classes
    assert isinstance(bank.program(sw, cuda, w + 3), SplitRound)

    def run():
        return [h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(
            chunks, None, mode="vmap", prev_tails=[None] * len(chunks))]

    eager, got = _eager_then_captured(bank, run)
    assert all(_bitwise(g, eager) for g in got)
    (step,) = bank.graphs.steps()
    assert step.key.general and step.key.rows == w and step.replays == 2 * 2 - 1


def test_lean_while_node_equals_unrolled_and_passes_no_round_on_silence(cuda, monkeypatch):
    """The lean greedy captured, a one-row and a 4-row graph, on a silent
    round and on one with hits: in the kernel tier it is the lean greedy's
    kernel (no while node in any graph) and in the mask tier
    (``APD_PALLAS=0``) its rounds are a while node; payloads bitwise equal
    to the eager step's, whose rounds are unrolled. The mask tier's 4-row
    graph's while nodes pass no round on the silent round and some on the
    other (counted on the device, a replay at a time)."""
    import numpy as np

    from chip_smoke import pass_counting_backend

    from audio_pattern_detector_tpu_torch.models import captured
    from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector

    clips, rounds = _capture_clips()
    rng = np.random.default_rng(7)
    silent = [(0.01 * rng.standard_normal(10 * 8000)).astype(np.float32) for _ in range(4)]
    banks = {}
    for name, switches in (("kernel", {}), ("mask", {"APD_PALLAS": "0"})):
        with monkeypatch.context() as mp:
            for var, value in switches.items():
                mp.setenv(var, value)
            mp.setattr(captured.StepGraphs, "backend", pass_counting_backend())
            banks[name] = TorchAudioPatternDetector(clips, device=cuda,
                                                    seconds_per_chunk=10)._ensure_bank()
    for mode in ("vmap", "scan"):
        for name, chunks in (("silent", silent), ("hits", rounds[0])):
            def run(bank, chunks=chunks, mode=mode):
                return [h.numpy().copy() for _, h, *_ in bank.dispatch_chunks_batch(
                    chunks, None, mode=mode, prev_tails=[None] * 4)]

            for tier in ("kernel", "mask"):
                eager, got = _eager_then_captured(banks[tier], lambda: run(banks[tier]))
                assert all(_bitwise(g, eager) for g in got)
            if mode == "vmap":  # the mask tier's 4-row key's two greedies: its last two counters
                passes = sum(banks["mask"].graphs._backend.passes()[-2:])
                assert (passes == 0) if name == "silent" else (passes > 0), (name, passes)
    assert banks["kernel"].graphs._backend.counters == []  # no while node
    assert banks["mask"].graphs._backend.counters != []


# ── The greedy kernels against their plain versions ──


@pytest.mark.parametrize("m", LEAN_GREEDY_MS)
@pytest.mark.parametrize("name", LEAN_GREEDY_CASES)
def test_lean_greedy_kernel_bitwise_equals_plain_version(cuda, name, m):
    """``csrc/lean_greedy.cu`` on the named cases (the CPU tests hold the
    plain version to the JAX lean group on the same ones): one launch,
    every output bitwise the plain version's on the same device inputs."""
    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import (
        lean_greedy,
        lean_greedy_reference,
    )

    args = lean_greedy_inputs(lean_greedy_case(name, m), cuda, candidate_scan)
    before = lean_greedy.launches
    got = lean_greedy(*args)
    torch.cuda.synchronize()
    assert lean_greedy.launches == before + 1
    assert greedy_outputs_equal(got, lean_greedy_reference(*args))


def test_lean_greedy_kernel_bitwise_on_seeded_inputs(cuda):
    """60 seeded inputs of the CPU tests' random form (short and long rows,
    m up to 900, r_max 1-16, per-row lengths, raised and lowered seeds)."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import (
        lean_greedy,
        lean_greedy_reference,
    )

    rng = np.random.default_rng(12)
    for seed in range(60):
        case = random_lean_greedy_case(
            seed, int(rng.integers(1, 40)), int(rng.choice([3, 40, 515, 516, 517, 2200, 20_000])),
            int(rng.integers(1, 900)), int(rng.integers(1, 17)), bool(seed % 2),
            int(rng.integers(0, 3)))
        args = lean_greedy_inputs(case, cuda, candidate_scan)
        assert greedy_outputs_equal(lean_greedy(*args), lean_greedy_reference(*args)), seed


@pytest.mark.parametrize("k", [1, 64, 2048, 2049, *LANE_GREEDY_KS])
def test_lane_greedy_kernel_bitwise_equals_plain_version(cuda, k):
    """``csrc/lane_greedy.cu`` on clustered lanes (a full row, a third, none;
    dead lanes with garbage positions): one launch, the plain version's
    mask in both of its forms."""
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import (
        _greedy_distance_parallel,
        _greedy_distance_sequential,
        lane_greedy,
        lane_greedy_reference,
    )

    pos, alive = lane_greedy_input(3, k, [k, k // 3, 0], max(40 * k, 4000), 300, seed=k)
    pos_d, alive_d = torch.from_numpy(pos).to(cuda), torch.from_numpy(alive).to(cuda)
    before = lane_greedy.launches
    got = lane_greedy(pos_d, alive_d, 300)
    torch.cuda.synchronize()
    assert lane_greedy.launches == before + 1
    assert torch.equal(got, lane_greedy_reference(pos_d, alive_d, 300))
    if k <= 4728:
        other = _greedy_distance_sequential if k <= 2048 else _greedy_distance_parallel
        assert torch.equal(got, other(pos_d, alive_d, 300))
    if k > 1:
        assert 0 < int(got.sum()) < int(alive.sum())


@pytest.mark.parametrize("name,k", [*((n, 4728) for n in LANE_WORST_CASES),
                                    ("one_cluster", 16_384), ("min_distance_0", 16_384)])
def test_lane_greedy_kernel_bitwise_on_worst_cases(cuda, name, k):
    """``csrc/lane_greedy.cu`` on its walk's worst cases (every alive lane at
    one position, one cluster within min_distance, min_distance 0 and 1,
    dead lanes at int32's and int64's extremes): 32 rows of 4,728 lanes, and
    4 rows at k_detect's cap of 16,384 where a row keeps one lane or all."""
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import (
        lane_greedy,
        lane_greedy_reference,
    )

    pos, alive, m = lane_worst_case(name, 32 if k == 4728 else 4, k)
    pos_d, alive_d = torch.from_numpy(pos).to(cuda), torch.from_numpy(alive).to(cuda)
    before = lane_greedy.launches
    got = lane_greedy(pos_d, alive_d, m)
    torch.cuda.synchronize()
    assert lane_greedy.launches == before + 1
    assert torch.equal(got, lane_greedy_reference(pos_d, alive_d, m))


def test_greedy_kernels_refuse_what_does_not_fit_and_count_no_launch(cuda):
    """Past the shared memory a block may take, each wrapper raises
    ValueError before a launch; the lane greedy takes k_detect's cap of
    16,384 lanes and up to its own limit."""
    from audio_pattern_detector_tpu_torch.ops.lane_greedy import (
        MAX_LANES,
        lane_greedy,
        lane_greedy_reference,
    )
    from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy

    before = (lane_greedy.launches, lean_greedy.launches)
    for k in (46_285, MAX_LANES + 1):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            lane_greedy(torch.zeros((1, k), dtype=torch.int64, device=cuda),
                        torch.zeros((1, k), dtype=torch.bool, device=cuda), 5)
    pos, alive = lane_greedy_input(2, MAX_LANES, [MAX_LANES, 9000], 700_000, 300, seed=3)
    pos_d, alive_d = torch.from_numpy(pos).to(cuda), torch.from_numpy(alive).to(cuda)
    got = lane_greedy(pos_d, alive_d, 300)
    torch.cuda.synchronize()
    assert lane_greedy.launches == before[0] + 1
    assert torch.equal(got, lane_greedy_reference(pos_d, alive_d, 300))
    lane_greedy.launches = before[0]
    corr = torch.zeros((1, 1024), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        lean_greedy(corr, 1024, torch.zeros((1, 2), device=cuda), torch.ones(1, device=cuda),
                    0.25, 5, 20_000)
    assert (lane_greedy.launches, lean_greedy.launches) == before


# ── The verify kernels against their plain versions ──


@pytest.mark.parametrize("name", VERIFY_NORMAL_CASES)
def test_verify_normal_kernel_equals_plain_version(cuda, name):
    """``csrc/verify_normal.cu`` on the named cases (the CPU tests hold the
    plain version to the JAX verifier on the same ones): one launch, accept
    bitwise the plain version's, similarity and r within its tolerance on
    live lanes and bitwise the numpy transliteration of the kernel's order,
    NaN on dead lanes."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops import verify_normal as vn

    case = verify_normal_case(name)
    args = verify_normal_inputs(case, cuda)
    before = vn.verify_normal.launches
    got = [t.cpu().numpy() for t in vn.verify_normal(*args)]
    assert vn.verify_normal.launches == before + 1
    want = [t.cpu().numpy() for t in vn.verify_normal_reference(*args)]
    live = case["alive"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1][live], want[1][live], rtol=vn.SIM_RTOL, atol=1e-9)
    np.testing.assert_allclose(got[2][live], want[2][live], rtol=0, atol=vn.R_ATOL)
    assert np.isnan(got[1][~live]).all() and np.isnan(got[2][~live]).all()
    order = np_verify_normal(case["corr"], case["pos"], live, args[3], case["valid_len"],
                             case["denom"])
    np.testing.assert_array_equal(got[0], order[0])
    for a, b in zip(got[1:], order[1:]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("spectra", ["fft", "gemm"])
@pytest.mark.parametrize("name", VERIFY_MARKER_CASES)
def test_verify_marker_kernel_equals_plain_version(cuda, monkeypatch, name, spectra):
    """The fused ``csrc/verify_marker.cu`` on the named cases (the long
    marker's in its global-workspace form): one launch, accept bitwise the
    plain verifier's with the FFT's and with the DFT-GEMM's spectra and the
    numpy transliteration's; its magnitudes of live lanes (the test probe)
    bitwise the transliteration's and within 1e-5 of each window's largest
    bin of the exact (f64) rfft of the same windows."""
    monkeypatch.setenv("APD_MARKER_GEMM", "1" if spectra == "gemm" else "0")
    _check_marker_kernel(cuda, name)


def test_a_52_second_marker_clip_verifies_as_the_plain_version(cuda, monkeypatch):
    """A 52 s marker clip at 8 kHz (m = 416,000, 4,158 frames: their
    results in the global workspace): the checks above with the FFT
    spectra, a hit and a near miss the second clip refuses among the
    lanes."""
    monkeypatch.setenv("APD_MARKER_GEMM", "0")
    got = _check_marker_kernel(cuda, MARKER_52S)
    assert not bool(got.all())


def _check_marker_kernel(cuda, name):
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops import verify_marker as vm

    case = verify_marker_case(name)
    section, pos, alive, consts = verify_marker_inputs(case, cuda)
    before = vm.verify_marker.launches
    got = vm.verify_marker(section, pos, alive, consts)
    assert vm.verify_marker.launches == before + 1
    assert torch.equal(got, vm.verify_marker_reference(section, pos, alive, consts))
    order = np_marker_spectra(case["section"], case["pos"], consts)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np_marker_decisions(order, case["alive"], consts))
    fw, ff, n_frames = consts.clip_len // 2 + 1, consts.frame_len // 2 + 1, consts.frame_count
    probe = torch.zeros((*pos.shape, 3 * fw + n_frames * ff), device=cuda)
    vm._launch(section, pos, alive, consts, probe=probe)
    live = case["alive"].reshape(-1)
    mags = probe.cpu().numpy().reshape(live.size, -1)[live]
    want = [order.whole.numpy().reshape(live.size, -1)[live]]
    if n_frames:
        want.append(order.frames.numpy().reshape(live.size, -1)[live])
    np.testing.assert_array_equal(mags.view(np.int32), np.concatenate(want, axis=1).view(np.int32))
    w3, _frames = marker_live_windows((section, pos, alive, consts))
    ref = np.abs(np.fft.rfft(w3.cpu().double().numpy(), axis=-1))
    err = np.abs(mags[:, : 3 * fw].reshape(-1, 3, fw) - ref).max(-1) / ref.max(-1).clip(1e-30)
    assert err.max() <= MARKER_SPECTRA_RTOL
    assert bool(got.any())
    return got


def test_verify_kernels_refuse_what_they_do_not_take_and_count_no_launch(cuda):
    """A per-row length of another type and frames off the marker clip's
    grid raise ValueError before a launch."""
    from audio_pattern_detector_tpu_torch.ops import verify_marker as vm
    from audio_pattern_detector_tpu_torch.ops import verify_normal as vn

    before = (vn.verify_normal.launches, vm.verify_marker.launches)
    corr, pos, alive, consts, (lens, denom) = verify_normal_inputs(verify_normal_case("rounds"),
                                                                   cuda)
    with pytest.raises(ValueError, match="per-row valid_len"):
        vn.verify_normal(corr, pos, alive, consts, (lens.long(), denom))
    import types

    section, mpos, malive, mconsts = verify_marker_inputs(verify_marker_case("tone_hits"), cuda)
    many = types.SimpleNamespace(**{**mconsts.__dict__, "frame_count": 7000})
    with pytest.raises(ValueError, match="frames"):
        vm.verify_marker(section, mpos, malive, many)
    assert (vn.verify_normal.launches, vm.verify_marker.launches) == before


@pytest.mark.parametrize("rows", [1, 16])
def test_verify_kernels_in_the_captured_verify_node(cuda, rows):
    """The verify kernels launched inside the if-node bodies of a captured
    lean step: payloads bitwise the eager step's on sections with hits in
    both groups, in one group and in none; a replay adds no verify launch
    of its own, and counted from the payloads each verifier's body ran
    (one launch) where its group shows a live lane."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.flagship import make_detector
    from audio_pattern_detector_tpu_torch.models.bank import _split_fused
    from audio_pattern_detector_tpu_torch.ops import verify_marker as vm
    from audio_pattern_detector_tpu_torch.ops import verify_normal as vn
    from chip_smoke import VERIFY_PATH_LAUNCHES, counted_verify_launches, rerun_sections

    bank = make_detector(6, 4, 60, cuda)._ensure_bank()  # rerun_sections reads 6 normal clips
    sw = 1
    s_len = bank.classes[sw]["section_len"]
    groups = bank.classes[sw]["groups"]
    rng = np.random.default_rng(3)
    quiet = (0.05 * rng.standard_normal(s_len)).astype(np.float32)
    both = rerun_sections(bank)["clear"].copy()
    both[20 * 8000: 21 * 8000] += next(g for g in groups if g.kind == "normal").clips_np[0]
    sections = {"both": both, "quiet": quiet}

    def run(section):
        if rows == 1:
            return bank.step(sw, torch.from_numpy(section).to(cuda), s_len)
        batch = np.stack([quiet] * (rows - 1) + [section])
        return bank.step(sw, torch.from_numpy(batch).to(cuda),
                         torch.full((rows,), s_len, dtype=torch.int32, device=cuda))

    bank.capture = False
    want = {k: run(v) for k, v in sections.items()}
    bank.capture = True
    run(both)  # the key's first use: eager, then the capture
    (step,) = bank.graphs.steps()
    assert step.kernel_launches[vn.verify_normal] == step.kernel_launches[vm.verify_marker] == 0
    assert step.body_launches == [{vn.verify_normal if g.kind == "normal" else vm.verify_marker: 1}
                                  for g in groups]
    before = (vn.verify_normal.launches, vm.verify_marker.launches)
    expect = {"normal": 0, "marker": 0}
    path = f"card_test_{rows}"
    with counted_verify_launches(path, lambda: [bank]):
        for name in ("both", "quiet", "both", "quiet"):
            got = run(sections[name])
            assert torch.equal(got.view(torch.int32), want[name].view(torch.int32)), name
            flat = got.cpu().numpy().reshape(-1, got.shape[-1])
            for g, p in zip(groups, _split_fused(flat, groups)):
                expect[g.kind] += int((p[..., : g.k_verify] < 2**30).any())
    assert (vn.verify_normal.launches, vm.verify_marker.launches) == before
    counted = tuple(VERIFY_PATH_LAUNCHES[f"verify_{k}"].pop(path) for k in ("normal", "marker"))
    assert counted == (expect["normal"], expect["marker"]) and min(counted) >= 2



# ── Rows that do not depend on their round ──


@pytest.mark.parametrize("sr", [8000, 6004, 44100])
def test_loudness_gate_kernel_equals_plain_version(cuda, sr):
    """``csrc/loudness_gate.cu`` on 64 K-weighted 61 s rows
    (``chip_smoke.gate_pool``: the gating edges, silent, short, one block,
    partial blocks, and noise) at 8 kHz, at a rate whose blocks end off the
    100 ms grid (651 pieces of 5 chunks) and at 44.1 kHz (611 pieces of 35
    chunks): a row's pieces over ceil(P / 8) CTAs. In rounds of 1, 3, 17
    and 64 rows each launch's LUFS are bitwise the plain version's on the
    card, and each row alone is bitwise its value in every round."""
    from audio_pattern_detector_tpu_torch.ops import loudness as tl
    from chip_smoke import check_gate_widths, gate_pool

    consts, filtered, n = gate_pool(cuda, sr, 61 * sr)
    assert tl.gate_ctas_per_row(consts.piece_bounds.shape[0] - 1) > 1
    before = tl.loudness_gate.launches
    rounds = check_gate_widths(filtered, n, consts, widths=(1, 3, 17, 64))
    assert tl.loudness_gate.launches == before + 64 + sum(rounds.values())
    assert rounds == {1: 64, 3: 22, 17: 4, 64: 1}
    lufs = tl.loudness_gate(filtered, n, consts)
    # The pool's first two rows are the edges' silent ones (length 0, and a
    # full-length row of zeros).
    assert bool(torch.isneginf(lufs[:2]).all()) and bool(torch.isfinite(lufs[2:]).all())


@pytest.mark.parametrize("seconds,sr", [(0.5, 8000), (0.85, 8000), (420, 8000)])
def test_loudness_gate_kernel_at_short_and_long_sections(cuda, seconds, sr):
    """Sections of 6 pieces (one CTA a row, two of its warps idle), 9 pieces
    (a second CTA with one piece) and 420 s (4,205 pieces over 526 CTAs a
    row, the finisher's block loop several passes of its threads): bitwise
    the plain version at lengths 0 to the whole section."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops import loudness as tl
    from chip_smoke import bitwise

    s = int(seconds * sr)
    consts = tl.build_loudness_consts(s, sr, cuda)
    rng = np.random.default_rng(s)
    lens = np.array([0, 1, s // 3, s - 1, s, s, sr // 2 - 1, sr // 2], np.int32)
    x = (0.05 * rng.standard_normal((len(lens), s))).astype(np.float32)
    x[np.arange(s)[None, :] >= lens[:, None]] = 0.0
    rows = torch.from_numpy(x).to(cuda)
    filtered = tl._k_weighted_conv(rows, consts)
    n = torch.from_numpy(lens).to(cuda)
    got = tl.loudness_gate(filtered, n, consts)
    assert bitwise(got, tl.loudness_gate_reference(filtered, n, consts)), got.tolist()
    for i in range(len(lens)):
        assert bitwise(tl.loudness_gate(filtered[i : i + 1], n[i : i + 1], consts)[0], got[i])
    # The single-section form (a 0-d result) takes the same launch.
    assert bitwise(tl.integrated_loudness_device(rows[3], int(lens[3]), consts), got[3])


@pytest.mark.parametrize("width", [1, 16])
def test_loudness_gate_replays_give_the_eager_bits(cuda, width):
    """The gate captured in a CUDA graph (the memset of its row tickets and
    its launch), replayed twice: each replay's LUFS bitwise the eager
    call's, so the tickets start clean on every replay."""
    from audio_pattern_detector_tpu_torch.ops import loudness as tl
    from chip_smoke import bitwise, gate_pool

    consts, filtered, n = gate_pool(cuda, 8000, 61 * 8000)
    filtered, n = filtered[-width:], n[-width:]  # noise rows
    eager = tl.loudness_gate(filtered, n, consts)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tl.loudness_gate(filtered, n, consts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tl.loudness_gate(filtered, n, consts)
    for _ in range(2):
        out.fill_(0.5)
        graph.replay()
        torch.cuda.synchronize()
        assert bitwise(out, eager), (out.tolist(), eager.tolist())


def test_fixed_batch_transforms_give_a_transform_the_same_bits(cuda):
    """chip_smoke's cuFFT probe at the flagship geometry: each call site's
    plan gives a transform the same bits at every index of its fixed batch,
    on every call and through the wrapper as one row."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops import correlate as tc
    from audio_pattern_detector_tpu_torch.ops import loudness as tl
    from chip_smoke import fft_batch_probe

    s = 61 * 8000
    clip = np.random.default_rng(0).standard_normal((1, 8000)).astype(np.float32)
    corr = tc.build_correlation_bank(clip, np.ones(1), s, cuda,
                                     tc.class_overlap_save_geometry(s, [8000, 2000]))
    sites = fft_batch_probe(cuda, tl.build_loudness_consts(s, 8000, cuda), corr)
    assert set(sites) == {"loudness_rfft", "loudness_irfft", "segment_rfft", "correlation_irfft"}


def _correlate_inputs(device, rows: int, m: int, m_max=None, clips: int = 3, seed: int = 0):
    """A group's correlation constants at the class geometry of clips of
    ``m`` samples beside a longest of ``m_max`` (its own geometry where
    None) on 61 s sections at 8 kHz, and ``rows`` seeded sections' segment
    spectra (rows, ns, fft_len / 2 + 1), on ``device``."""
    import numpy as np

    from audio_pattern_detector_tpu_torch.ops import correlate as tc

    s = 61 * 8000
    rng = np.random.default_rng(seed)
    clip = rng.standard_normal((clips, m)).astype(np.float32)
    geom = tc.class_overlap_save_geometry(s, [m_max or m, m])
    c = tc.build_correlation_bank(clip, np.ones(clips), s, device, shared_geometry=geom)
    sections = torch.from_numpy((0.05 * rng.standard_normal((rows, s))).astype(np.float32))
    return c, tc.section_segment_spectra(sections.to(device), c)


def _correlate_args(c, seg) -> tuple:
    return (seg, c.bank_rfft_conj, c.fft_len, c.step or c.fft_len - c.clip_len + 1,
            c.out_offset, c.full_len)


@pytest.mark.parametrize("m,m_max", [(8000, None), (700, 8000), (2000, None), (700, 2000),
                                     (12_000, None), (29_488, None), (700, 29_488),
                                     (40_000, None)])
def test_correlate_kernel_bitwise_equals_its_transliteration(cuda, m, m_max):
    """``csrc/correlate_os.cu`` at fft_len 32,768 and 8,192 (one CTA a
    transform) and 65,536, 131,072 (the rainbow intro clip's) and 262,144
    (a cluster of CTAs), out_offset 0 and past it: 12 sampled transforms of
    2 rows against 3 clips bitwise chip_smoke.np_correlate_transforms, one
    launch counted."""
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos
    from chip_smoke import check_correlate_transforms, correlate_picks

    c, seg = _correlate_inputs(cuda, 2, m, m_max, seed=m)
    args = _correlate_args(c, seg)
    before = tos.correlate_os.launches
    out = tos.correlate_os(*args)
    torch.cuda.synchronize()
    assert tos.correlate_os.launches == before + 1
    assert out.shape == (2, 3, c.full_len) and out.dtype == torch.float32
    b, ns = seg.shape[:2]
    picks = correlate_picks(b, 3, ns, 12, seed=m)
    assert check_correlate_transforms(out, seg, c.bank_rfft_conj, *args[2:], picks) > 0


@pytest.fixture(scope="module")
def flagship_correlation():
    """The flagship bank's groups and the 16-row round's normalised sections'
    segment spectra (flagship.flagship_round's sections), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    from audio_pattern_detector_tpu_torch.flagship import flagship_round
    from audio_pattern_detector_tpu_torch.ops.correlate import section_segment_spectra
    from audio_pattern_detector_tpu_torch.ops.loudness import (
        integrated_loudness_device,
        loudness_normalize_device,
    )

    _, bank, sections = flagship_round(torch.device("cuda"))
    cls = bank.classes[sorted(bank.classes)[0]]
    lens = torch.full((sections.shape[0],), sections.shape[1], dtype=torch.int32,
                      device=sections.device)
    norm = loudness_normalize_device(sections, integrated_loudness_device(sections, lens,
                                                                          cls["loud"]))
    groups = [g.corr for g in cls["groups"]]
    return groups, section_segment_spectra(norm, groups[0])


@pytest.mark.parametrize("rows", [1, 16])
def test_correlate_kernel_within_tolerance_of_the_cufft_route(cuda, flagship_correlation, rows):
    """The flagship step's (1 row) and the 16-row round's correlations of
    both groups: the kernel within chip_smoke.CORRELATE_RTOL of each row's
    largest value of the plain version (the cuFFT route)."""
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos
    from chip_smoke import CORRELATE_RTOL

    groups, seg = flagship_correlation
    for c in groups:
        args = _correlate_args(c, seg[:rows])
        got, want = tos.correlate_os(*args), tos.correlate_os_reference(*args)
        rel = ((got - want).abs() / want.amax(dim=-1, keepdim=True)).max().item()
        assert got.shape == (rows, c.bank_rfft_conj.shape[0], c.full_len)
        assert rel <= CORRELATE_RTOL, rel


def test_correlate_kernel_rows_are_the_same_at_widths_1_5_16_17(cuda, flagship_correlation):
    """A row's |correlation| bitwise the same in rounds of 1, 5, 16 and 17
    rows (17 = the 16 and row 0 again), against the 16-row round's."""
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos

    groups, seg = flagship_correlation
    for c in groups:
        args = _correlate_args(c, seg)
        ref = tos.correlate_os(*args)
        for w in (1, 5, 16, 17):
            rows = [i % seg.shape[0] for i in range(w)]
            got = tos.correlate_os(seg[rows].contiguous(), *args[1:])
            assert all(bitwise(got[i], ref[r]) for i, r in enumerate(rows)), w


def test_correlate_kernel_replays_give_the_eager_bits(cuda, flagship_correlation):
    """A graph of one call on the 16-row round's inputs, replayed twice:
    bitwise the eager call; the plan's tables kept past the cache."""
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos

    groups, seg = flagship_correlation
    args = _correlate_args(groups[0], seg)
    eager = tos.correlate_os(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tos.correlate_os(*args)
    assert (args[2], seg.device) in tos._CAPTURED_PLANS
    tos._cached.cache_clear()
    for _ in range(2):
        out.fill_(0.5)
        graph.replay()
        torch.cuda.synchronize()
        assert bitwise(out, eager)


def test_correlate_takes_the_cufft_route_past_32768_points(cuda):
    """Since the cluster form, a 29,488-sample clip's geometry (fft_len
    131,072) takes the kernel on the card: one launch and no call of the
    cuFFT route (``ops/correlate.py::cufft_correlation``), within
    chip_smoke.CORRELATE_RTOL of the plain version. A 70,000-sample clip's
    (524,288, past the kernel's 262,144) takes the cuFFT route: no launch,
    the plain version's bits, one call counted; the wrapper refuses it."""
    from audio_pattern_detector_tpu_torch.ops import correlate as tc
    from audio_pattern_detector_tpu_torch.ops import correlate_os as tos
    from chip_smoke import CORRELATE_RTOL

    c, seg = _correlate_inputs(cuda, 2, 29_488, clips=2)
    assert c.fft_len == 131_072 and tos.kernel_takes(c.fft_len)
    args = _correlate_args(c, seg)
    section = torch.zeros((2, 61 * 8000), device=cuda)  # its spectra are seg
    before, calls = tos.correlate_os.launches, tc.cufft_correlation.launches
    got, want = tc._correlate_raw(section, c, seg), tos.correlate_os_reference(*args)
    assert ((got - want).abs() / want.amax(dim=-1, keepdim=True)).max().item() <= CORRELATE_RTOL
    assert tos.correlate_os.launches == before + 1
    assert tc.cufft_correlation.launches == calls
    del c, seg, args, got, want
    c, seg = _correlate_inputs(cuda, 1, 70_000, clips=1)
    assert c.fft_len == 524_288 and not tos.kernel_takes(c.fft_len)
    args = _correlate_args(c, seg)
    before, calls = tos.correlate_os.launches, tc.cufft_correlation.launches
    assert bitwise(tc._correlate_raw(section[:1], c, seg), tos.correlate_os_reference(*args))
    assert tos.correlate_os.launches == before
    assert tc.cufft_correlation.launches == calls + 1
    with pytest.raises(ValueError, match="takes fft_len"):
        tos.correlate_os(*args)
