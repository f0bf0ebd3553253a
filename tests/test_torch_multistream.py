"""The port's multi-stream session and independent-row batch dispatch
against the JAX package.

* Session: each stream's detections, timestamps and total time equal the
  JAX serial engine's (``AudioPatternDetector.find_clip_in_audio``) on
  that stream alone, exactly: the detections are integer positions turned
  into timestamps by the same host algebra. Streams of different lengths
  share rounds: one ends early, one starts late, one sends a zero-length
  chunk, int16 and f32 streams mix, and one stream floods its row past
  the lean tier's lanes so a row rerun runs inside a round. Untiled and
  tiled rounds, synchronous and pipelined, all give the same.
* The JAX session itself is a third reference, round by round.
* Checkpoints are byte-identical to the JAX serial loop's and resume
  exactly; validation messages equal the JAX session's and bank's.
* A subprocess checks that the session never imports jax.
"""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_pattern_detector_tpu.models.detector import AudioPatternDetector
from audio_pattern_detector_tpu.models.multistream import (
    MultiStreamSession as JaxMultiStreamSession,
)
from audio_pattern_detector_tpu.utils import clip as jclip
from audio_pattern_detector_tpu_torch.models.bank import _split_fused, unpack_group
from audio_pattern_detector_tpu_torch.models.detector import (
    MARKER_TONE_STRATEGY,
    StreamCheckpoint,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream

torch.set_num_threads(1)

SR = 8000
CHUNK_S = 10
CHUNK = CHUNK_S * SR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clips():
    """A 0.6 s normal clip and a 941 Hz marker tone (tests/test_torch_engine.py)."""
    t = np.arange(int(0.6 * SR)) / SR
    clip = (0.5 * np.sin(2 * np.pi * 640.0 * t) * np.hanning(len(t))).astype(np.float32)
    tm = np.arange(int(0.25 * SR)) / SR
    marker = np.sin(2 * np.pi * 941.0 * tm).astype(np.float32)
    return [
        AudioClip(name="c", audio=clip, sample_rate=SR),
        AudioClip(
            name="m", audio=marker, sample_rate=SR,
            strategy=MARKER_TONE_STRATEGY, strategy_params={"dominant_frequency_hz": 941.0},
        ),
    ]


def _jax_clips(clips):
    """The same clips as the JAX package's AudioClip values."""
    return [jclip.AudioClip(**dataclasses.asdict(c)) for c in clips]


def _pcm16(audio):
    return np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)


def _stream(seed, seconds, normal=(), marker=(), flood_at=None):
    clip, tone = (c.audio for c in _clips())
    audio = 0.01 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
    starts = list(normal)
    if flood_at is not None:  # 18 copies 0.62 s apart: past the 16 lean lanes
        starts += [flood_at + 0.62 * k for k in range(18)]
    for s in starts:
        o = int(s * SR)
        audio[o : o + len(clip)] += clip
    for s in marker:
        o = int(s * SR)
        audio[o : o + len(tone)] += 0.8 * tone
    return audio


def _streams():
    """Four streams and their chunk per round (None: no data):
    0: int16, 37.5 s, rounds 0-3 (a short last chunk);
    1: f32, 25 s, starts late (rounds 1-3);
    2: f32, 12 s, ends early (rounds 0-1);
    3: int16, 30 s, a zero-length chunk in round 1, a flooded second chunk.
    Every round has three active streams."""
    audios = [
        _pcm16(_stream(1, 37.5, normal=(4.0, 9.8, 33.0), marker=(17.0,))),
        _stream(2, 25.0, normal=(12.0,), marker=(21.0,)).astype(np.float32),
        _stream(3, 12.0, normal=(3.0, 10.5)).astype(np.float32),
        _pcm16(_stream(4, 30.0, normal=(25.0,), flood_at=9.05)),
    ]
    chunks = [[a[o : o + CHUNK] for o in range(0, len(a), CHUNK)] for a in audios]
    empty = np.zeros(0, dtype=np.int16)
    rounds = [
        [chunks[0][r], chunks[1][r - 1] if r else None, chunks[2][r] if r < 2 else None,
         {0: chunks[3][0], 1: empty}.get(r, chunks[3][r - 1])]
        for r in range(4)
    ]
    return audios, rounds


def _serial_jax(det, samples):
    cks = []
    stream = jclip.AudioStream(
        name="s", audio_stream=io.BytesIO(samples.tobytes()), sample_rate=SR,
        sample_dtype=samples.dtype,
    )
    peaks, total = det.find_clip_in_audio(stream, on_checkpoint=lambda ck: cks.append(ck.to_bytes()))
    return peaks, total, cks


def _routes(bank):
    return bank.row_reruns, bank.class_reruns, bank.escalated_reruns, bank.host_path_rows


@pytest.fixture(scope="module")
def env():
    """Clips, streams, rounds, a JAX detector, each stream's JAX serial run
    (peaks, total, checkpoint bytes), and the flagged-row routes of the
    port's serial engine over all four streams."""
    clips = _clips()
    audios, rounds = _streams()
    jdet = AudioPatternDetector(_jax_clips(clips), seconds_per_chunk=CHUNK_S)
    serial = [_serial_jax(jdet, a) for a in audios]
    tdet = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    for a in audios:
        tdet.find_clip_in_audio(AudioStream(
            name="s", audio_stream=io.BytesIO(a.tobytes()), sample_rate=SR, sample_dtype=a.dtype
        ))
    return clips, audios, rounds, jdet, serial, _routes(tdet._bank)


def _run_session(session, rounds, in_flight):
    """Feed the rounds keeping ``in_flight`` dispatched; per-stream
    accumulated detections and the per-round outputs."""
    names = [c.name for c in session.detector.audio_clips]
    acc = [{name: [] for name in names} for _ in range(session.n_streams)]
    outs, pending = [], []

    def collect():
        res = session.collect(pending.pop(0))
        outs.append(res)
        for a, r in zip(acc, res):
            for name, ts in r.items():
                a[name].extend(ts)

    for chunks in rounds:
        pending.append(session.dispatch(chunks))
        if len(pending) >= in_flight:
            collect()
    while pending:
        collect()
    return acc, outs


@pytest.mark.parametrize("tile", [None, 2])
@pytest.mark.parametrize("in_flight", [1, 2])
def test_streams_equal_the_jax_serial_engine(env, tile, in_flight):
    clips, audios, rounds, _, serial, _ = env
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    session = MultiStreamSession(det, 4, tile=tile)
    bank = det._ensure_bank()
    widths = []
    dispatch = bank.dispatch_chunks_batch

    def spy(chunks, *a, **kw):
        widths.append(len(chunks))
        return dispatch(chunks, *a, **kw)

    bank.dispatch_chunks_batch = spy
    acc, _ = _run_session(session, rounds, in_flight)
    for i, (peaks, total, _) in enumerate(serial):
        assert acc[i] == peaks, f"stream {i}"
        assert session.total_time(i) == total
    assert [round(t, 3) for t in serial[0][0]["c"]] == [4.0, 9.8, 33.0]
    assert len(serial[0][0]["m"]) == 1 and len(serial[3][0]["c"]) > 16
    # Every round has 3 active rows: tiles of 2 + 1, or one untiled
    # dispatch of all 4 slots (idle slots as zero-length rows).
    assert widths == ([2, 1] * 4 if tile == 2 else [4] * 4)
    # Flagged rows take the routes they take in the port's serial engine.
    assert _routes(bank) == env[5] and bank.row_reruns >= 1


def test_rounds_equal_the_jax_session(env):
    """Width 2, an int16 and an f32 stream in each round: each round's
    output equals the JAX session's."""
    clips, _, rounds, jdet, _, _ = env
    two = [[r[0], r[1]] for r in rounds]
    want = _run_session(JaxMultiStreamSession(jdet, 2), two, 1)[1]
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    got = _run_session(MultiStreamSession(det, 2), two, 1)[1]
    assert got == want
    assert sum(len(ts) for out in got for r in out for ts in r.values()) >= 4


def test_checkpoints_equal_the_jax_loop_and_resume(env):
    """After each round, the int16 stream's checkpoint bytes equal the JAX
    serial loop's after the same chunk (the tail as f32); a resume from
    the port's checkpoint continues the JAX run exactly."""
    clips, audios, rounds, jdet, serial, _ = env
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    session = MultiStreamSession(det, 4, tile=2)
    cks = []
    for chunks in rounds:
        session.feed(chunks)
        cks.append(session.checkpoint(0))
    assert all(ck.previous_tail.dtype == np.float32 for ck in cks)
    assert [ck.to_bytes() for ck in cks] == serial[0][2]
    assert session.checkpoint(3).chunk_index == 3  # the zero-length round did not count

    ck = StreamCheckpoint.from_bytes(cks[1].to_bytes())
    rest = audios[0][2 * CHUNK :]
    peaks, total = det.find_clip_in_audio(
        AudioStream(name="s", audio_stream=io.BytesIO(rest.tobytes()), sample_rate=SR,
                    sample_dtype=np.int16),
        checkpoint=ck,
    )
    full, full_total, _ = serial[0]
    assert peaks == {name: [t for t in ts if t >= 19.0] for name, ts in full.items()}
    assert total == full_total


def test_reset_recycles_a_slot(env):
    clips, audios, _, _, serial, _ = env
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    session = MultiStreamSession(det, 1)
    runs = []
    for _ in range(2):
        acc, _ = _run_session(session, [[audios[2][:CHUNK]], [audios[2][CHUNK:]]], 1)
        runs.append((acc[0], session.total_time(0)))
        session.reset(0)
        assert session.checkpoint(0) == StreamCheckpoint(0, None, 0.0)
    assert runs[0] == runs[1] == serial[2][:2]
    # A slot reset between dispatch and collect (a client dropped with a
    # round in flight) does not change what that round collects.
    first = session.feed([audios[2][:CHUNK]])
    session.reset(0)
    handle = session.dispatch([audios[2][:CHUNK]])
    session.reset(0)
    assert session.collect(handle) == first and first[0]["c"]


def _error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize(
    "case",
    ["n_streams", "tile", "batch_mode", "chunk_count", "chunk_too_long", "chunk_2d"],
)
def test_validation_messages_equal_the_jax_sessions(env, case):
    clips, _, _, jdet, _, _ = env
    tdet = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)

    def attempt(cls, det):
        if case == "n_streams":
            return lambda: cls(det, 0)
        if case == "tile":
            return lambda: cls(det, 2, tile=0)
        if case == "batch_mode":
            return lambda: cls(det, 2, batch_mode="bogus")
        chunks = {
            "chunk_count": [np.zeros(10, np.float32)],
            "chunk_too_long": [np.zeros(CHUNK + 1, np.float32), None],
            "chunk_2d": [np.zeros((2, 10), np.float32), None],
        }[case]
        return lambda: cls(det, 2).dispatch(chunks)

    want = _error(attempt(JaxMultiStreamSession, jdet))
    assert _error(attempt(MultiStreamSession, tdet)) == want


def test_mesh_and_vmap_are_refused_by_name(env):
    clips = env[0]
    det = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)
    from audio_pattern_detector_tpu_torch.parallel import make_mesh

    # A mesh is taken now (tests/test_torch_mesh_surfaces.py); one without
    # a stream axis is refused by name, and it makes "vmap" the default.
    with pytest.raises(ValueError, match="mesh must have a 'stream' axis"):
        MultiStreamSession(det, 2, mesh=make_mesh({"time": 2}, devices=["cpu"] * 2))
    stream_mesh = make_mesh({"stream": 2}, devices=["cpu"] * 2)
    assert MultiStreamSession(det, 2, mesh=stream_mesh)._batch_mode == "vmap"
    assert MultiStreamSession(det, 2, batch_mode="vmap")._batch_mode == "vmap"
    assert MultiStreamSession(det, 2)._batch_mode == "scan"
    with pytest.raises(TypeError, match="TorchAudioPatternDetector"):
        MultiStreamSession(env[3], 2)


def test_bank_prev_tails_mismatch_and_sharding(env):
    clips, _, _, jdet, _, _ = env
    tbank = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()
    chunks = [np.zeros(10, np.float32)] * 2
    want = _error(lambda: jdet._ensure_bank().dispatch_chunks_batch(chunks, None, prev_tails=[None]))
    assert _error(lambda: tbank.dispatch_chunks_batch(chunks, None, prev_tails=[None])) == want
    from audio_pattern_detector_tpu_torch.parallel import RowSharding, make_mesh

    sharding = RowSharding(make_mesh({"stream": 2}, devices=["cpu"] * 2))
    want = _error(lambda: jdet._ensure_bank().dispatch_chunks_batch(
        chunks, None, mode="scan", sharding=object()))
    assert _error(lambda: tbank.dispatch_chunks_batch(
        chunks, None, mode="scan", sharding=sharding)) == want == "sharding requires mode='vmap'"
    assert "does not divide" in _error(
        lambda: tbank.dispatch_chunks_batch(chunks + chunks[:1], None, sharding=sharding)
    )


def test_independent_rows_equal_rows_sent_alone(env):
    """One batch of independent rows (int16 with an int16 tail, f32 with
    none, a zero-length idle row, int16 with an f32 tail, a short f32 row
    with an int16 tail) gives each row the payload and the results of that
    row dispatched alone, bit for bit; the idle row is unflagged and
    empty."""
    clips, audios, _, _, _, _ = env
    bank = TorchAudioPatternDetector(clips, device="cpu", seconds_per_chunk=CHUNK_S)._ensure_bank()
    i16, f32 = audios[0], audios[1]
    rows = [
        (i16[CHUNK : 2 * CHUNK], i16[:CHUNK]),
        (f32[:CHUNK], None),
        (np.zeros(0, np.float32), None),
        (i16[2 * CHUNK : 3 * CHUNK], f32[:CHUNK]),
        (f32[CHUNK : CHUNK + 3 * SR], i16[:CHUNK]),
    ]
    dispatched = bank.dispatch_chunks_batch(
        [c for c, _ in rows], None, prev_tails=[t for _, t in rows]
    )
    payload = {sw: handle.numpy() for sw, handle, *_ in dispatched}
    batch = bank.collect_chunks_batch(dispatched)
    for bi, (chunk, tail) in enumerate(rows):
        alone = bank.dispatch_chunk(chunk, tail)
        for sw, handle, *_ in alone:
            assert np.array_equal(handle.numpy().view(np.int32), payload[sw][bi].view(np.int32))
        assert bank.collect_chunk(alone) == batch[bi]
    assert batch[2] == {"c": [], "m": []} and any(batch[0].values())
    groups = bank.classes[1]["groups"]
    for g, packed in zip(groups, _split_fused(payload[1][2], groups)):
        _, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
        assert not (sel.any() or host_fb.any() or needs_full.any())


def test_session_with_an_int16_checkpoint_never_imports_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from audio_pattern_detector_tpu_torch.utils.clip import AudioClip\n"
        "from audio_pattern_detector_tpu_torch.models.detector import TorchAudioPatternDetector\n"
        "from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession\n"
        "t = np.arange(4800) / 8000\n"
        "clip = (0.5 * np.sin(2 * np.pi * 640 * t) * np.hanning(4800)).astype(np.float32)\n"
        "det = TorchAudioPatternDetector([AudioClip(name='c', audio=clip, sample_rate=8000)],\n"
        "                                device='cpu', seconds_per_chunk=10)\n"
        "s = MultiStreamSession(det, 2, tile=2)\n"
        "pcm = (np.random.default_rng(0).standard_normal(80000) * 300).astype(np.int16)\n"
        "pcm[32000:36800] += (clip * 32767).astype(np.int16)\n"
        "out = s.feed([pcm, None])\n"
        "ck = s.checkpoint(0)\n"
        "print(round(out[0]['c'][0], 3), ck.previous_tail.dtype, ck.chunk_index)\n"
        "print('JAX_IMPORTED', 'jax' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["4.0 float32 1", "JAX_IMPORTED False"]
