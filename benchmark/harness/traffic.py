"""The one traffic generator: a traffic file's parameters and a seed give
the int16 audio a cell feeds the port, and where its airings lie.

A traffic file gives ``recordings`` recordings of ``recording_seconds``
each and, where it names ``stations``, a seeded order of recording 0's
chunks for each station (the live pool). Which entry of the port the
window drives with them is the file's ``driver``, a module of
``benchmark/drivers/`` found by that name; its ``engine`` options (and
the configuration's) reach the port through the driver.

A recording is a run of background pieces (seeded noise
blocks, whole captures or capture stretches, in a seeded order), with an
optional opening capture first and capture inserts at seeded places, and
optionally the bank's own clips planted (mixed) at seeded places. Captures
are used as recorded: never resampled, re-levelled or edited. Every
size and count is fixed by the traffic file; the seed only chooses order,
placement and noise, so all seeds carry the same audio and airings in
amount: the counts of airings are dealt out to the recordings in a seeded
order, half of the planted ones jingles and half marker tones.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

@dataclass
class Stream:
    """One recording (for stations, the pool laid end to end)."""

    samples: np.ndarray  # int16
    # chunks holding an airing whose events the check samples first: a
    # planted marker tone (its timestamp is the one a lower precision moves),
    # an opening or an insert
    marked: set[int] = field(default_factory=set)


@dataclass
class Traffic:
    rate: int
    chunk_samples: int
    streams: list[Stream]
    order: np.ndarray | None = None  # stations: (stations, pool chunks) pool indices
    check_chunks: int = 8  # chunks (or rows) the correctness check samples
    check_marked: int = 4  # of them, at most this many that hold an airing

    def chunk(self, stream: int, index: int) -> np.ndarray:
        s = self.streams[stream].samples
        return s[index * self.chunk_samples:(index + 1) * self.chunk_samples]

    @property
    def pool(self) -> list[np.ndarray]:
        """Recording 0's chunks in order: the stations' pool."""
        n = len(self.streams[0].samples) // self.chunk_samples
        return [self.chunk(0, i) for i in range(n)]


def read_wav_int16(path: Path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: want mono 16-bit PCM")
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").copy(), w.getframerate()


def write_wav_int16(path: Path, samples: np.ndarray, rate: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.ascontiguousarray(samples, dtype="<i2").tobytes())


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *tags]))


def _to_int16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def _pieces(spec: dict, rate: int, data_dir: Path, rng: np.random.Generator, cache: dict) -> list[np.ndarray]:
    """The background pieces a stream draws from."""
    source = spec["source"]
    if source == "noise":
        n = int(spec["block_seconds"] * rate)
        rms = 10.0 ** (spec["rms_dbfs"] / 20.0)
        if "noise" not in cache:
            cache["noise"] = [_to_int16(rms * rng.standard_normal(n)) for _ in range(spec["pool_blocks"])]
        return cache["noise"]
    if source == "captures":
        return [_capture(data_dir / c, rate, cache) for c in spec["captures"]]
    if source == "stretches":
        out = []
        for name, lo, hi in spec["stretches"]:
            x = _capture(data_dir / name, rate, cache)
            out.append(x[int(round(lo * rate)):int(round(hi * rate))])
        return out
    raise ValueError(f"unknown background source {source!r}")


def _capture(path: Path, rate: int, cache: dict) -> np.ndarray:
    key = str(path)
    if key not in cache:
        x, r = read_wav_int16(path)
        if r != rate:
            raise ValueError(f"{path}: {r} Hz, the configuration runs at {rate} Hz")
        cache[key] = x
    return cache[key]


def _lay_out(spec: dict, n: int, rate: int, data_dir: Path, rng: np.random.Generator,
             noise_rng: np.random.Generator, cache: dict, chunk: int, insert_counts: list[int]) -> Stream:
    """Background pieces in a seeded order (whole cycles of a permutation),
    the opening first, ``insert_counts[k]`` copies of the k-th insert
    between pieces, cut to ``n`` samples."""
    pieces = _pieces(spec["background"], rate, data_dir, noise_rng, cache)
    with_replacement = spec["background"]["source"] == "noise"
    seq: list[tuple[np.ndarray, bool]] = []
    if "opening" in spec:
        names = spec["opening"]["captures"]
        seq.append((_capture(data_dir / names[rng.integers(len(names))], rate, cache), True))
    inserts: list[np.ndarray] = []
    for name, count in zip(spec.get("inserts", {}).get("captures", []), insert_counts):
        inserts += [_capture(data_dir / name, rate, cache)] * int(count)
    total = sum(len(p) for p, _ in seq) + sum(len(x) for x in inserts)
    body: list[np.ndarray] = []
    while total < n:
        idx = rng.integers(len(pieces), size=len(pieces)) if with_replacement else rng.permutation(len(pieces))
        for i in idx:
            body.append(pieces[i])
            total += len(pieces[i])
            if total >= n:
                break
    slots = sorted(rng.choice(len(body) + 1, size=len(inserts), replace=True).tolist())
    order = rng.permutation(len(inserts))
    k = 0
    for i, piece in enumerate(body):
        while k < len(slots) and slots[k] == i:
            seq.append((inserts[order[k]], True))
            k += 1
        seq.append((piece, False))
    while k < len(slots):
        seq.append((inserts[order[k]], True))
        k += 1
    out = np.empty(n, dtype=np.int16)
    marked: set[int] = set()
    pos = 0
    for piece, mark in seq:
        take = min(len(piece), n - pos)
        out[pos:pos + take] = piece[:take]
        if mark and take > 0:
            marked.update(range(pos // chunk, (pos + take - 1) // chunk + 1))
        pos += take
        if pos >= n:
            break
    return Stream(out, marked)


def _plant(stream: Stream, spec: dict, count: int, clips: list, rate: int, rng: np.random.Generator,
           chunk: int, bg_rms: float) -> None:
    """Mix ``count`` airings of the bank's clips into the stream, half of them
    jingles (normal clips) and half marker tones, each clip and place drawn
    from the seed. A jingle is mixed over the background at
    ``normal_gain_db`` against the background's level; a marker tone airs
    as stations air it, in a momentary quiet: the background under it
    ducked by ``marker_duck_db`` and the tone at ``marker_gain_db``."""
    x = stream.samples
    kinds = {False: [c for c in clips if c.strategy != "marker_tone"],
             True: [c for c in clips if c.strategy == "marker_tone"]}
    for k in range(count):
        marker = bool(k % 2) and bool(kinds[True]) or not kinds[False]
        pool = kinds[marker]
        clip = pool[rng.integers(len(pool))]
        m = len(clip.audio)
        pos = int(rng.integers(rate, len(x) - m - rate))
        g_lo, g_hi = spec["marker_gain_db" if marker else "normal_gain_db"]
        target = bg_rms * 10.0 ** (rng.uniform(g_lo, g_hi) / 20.0)
        rms = float(np.sqrt(np.mean(np.square(clip.audio, dtype=np.float64))))
        under = x[pos:pos + m].astype(np.float64) / 32768.0
        if marker:
            under *= 10.0 ** (-spec["marker_duck_db"] / 20.0)
        x[pos:pos + m] = _to_int16(under + clip.audio * (target / rms))
        if marker:
            stream.marked.update(range(pos // chunk, (pos + m - 1) // chunk + 1))


def generate(spec: dict, seed: int, rate: int, chunk_seconds: int, clips: list, data_dir: Path) -> Traffic:
    """The traffic ``spec`` (a traffic file's object) for ``seed``. ``clips``
    are the bank's patterns (``reference.Clip``), which ``plant`` mixes in;
    ``data_dir`` holds the captures that ``spec`` names."""
    chunk = int(chunk_seconds * rate)
    cache: dict = {}
    noise_rng = _rng(seed, 1)
    bg = spec["background"]
    bg_rms = 10.0 ** (bg["rms_dbfs"] / 20.0) if bg["source"] == "noise" else None
    check = int(spec["check"]["chunks"])
    check_marked = int(spec["check"]["marked"])
    # Counts are the traffic file's, one per recording, dealt out in a
    # seeded order: every seed carries the same airings in all.
    n_streams = int(spec["recordings"])
    deal = _rng(seed, 5)
    plant_counts = deal.permutation(spec["plant"]["counts"]) if "plant" in spec else [0] * n_streams
    insert_counts = ([deal.permutation(c) for c in spec["inserts"]["counts"]] if "inserts" in spec else [])
    if len(plant_counts) != n_streams or any(len(c) != n_streams for c in insert_counts):
        raise ValueError("a traffic file gives one airing count a recording")
    n = int(spec["recording_seconds"] * rate)
    streams = []
    for f in range(n_streams):
        s = _lay_out(spec, n, rate, data_dir, _rng(seed, 2, f), noise_rng, cache, chunk,
                     [c[f] for c in insert_counts])
        if "plant" in spec:
            _plant(s, spec["plant"], int(plant_counts[f]), clips, rate, _rng(seed, 3, f), chunk, bg_rms)
        streams.append(s)
    order = None
    if "stations" in spec:
        p = n // chunk
        order_rng = _rng(seed, 4)
        order = np.stack([order_rng.permutation(p) for _ in range(int(spec["stations"]))])
    return Traffic(rate, chunk, streams, order=order, check_chunks=check, check_marked=check_marked)
