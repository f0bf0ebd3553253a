"""The plain reference detector the benchmark judges the port against.

NumPy and SciPy only; it imports nothing of the port and nothing of JAX.
It is a frozen copy of the detection semantics that the upstream
audio-pattern-detector defines and the port's host modules restate
(``ops/hostref.py``, ``ops/tone.py``, ``models/hostpath.py`` and the
timestamp algebra of ``models/detector.py`` at the time this benchmark was
written): per 60 s chunk and clip, the section is the previous chunk's last
``sliding_window`` seconds and the chunk, loudness-normalised to -16 LUFS
(ITU-R BS.1770, 400 ms gated blocks), cross-correlated with the normalised
clip, divided by the larger of the clip's autocorrelation peak and the
section's own; peaks at or above 0.25 at least a clip length apart are
verified (normal clips: partitioned MSE and a centre-window Pearson r;
marker tones: band purity of the window and its flanks) and turned into
stream timestamps.

``precision="reference"`` computes as the upstream does: f64 filters and
transforms, the correlation handed on as f32. ``precision="bf16"`` is the
control: the same steps with the normalised audio, the clips, their
spectra, the spectra's products and the correlation rounded to bfloat16
and the transforms in f32, the nearest precision below the float32 that
the configurations state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
from scipy import fft as sfft
from scipy.signal import lfilter

PRECISIONS = ("reference", "bf16")
HEIGHT_MIN = 0.25
TARGET_LUFS = -16.0
SHORT_CLIP_SECONDS = 0.5
SIMILARITY_HARD_LIMIT = 0.02
PEARSON_R_THRESHOLD = 0.90
MARKER_STRATEGY = "marker_tone"
MARKER_DEFAULTS = {
    "minimum_band_purity": 0.95,
    "minimum_active_frame_ratio": 0.80,
    "minimum_longest_active_run": 9,
    "minimum_active_frame_mean_purity": 0.92,
    "maximum_min_flank_purity": 0.25,
    "maximum_max_flank_purity": 0.65,
}
LUFS_OFFSET = -0.691
ABSOLUTE_GATE_LUFS = -70.0
BLOCK_OVERLAP = 0.75
FFT_WORKERS = 8
BLOCK = 8  # clips whose correlations one batched transform computes


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), kept as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = ((b >> 16) & 1) + np.uint32(0x7FFF)
    return ((b + r) & np.uint32(0xFFFF0000)).view(np.float32)


def pcm16_to_f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.int16).astype(np.float32) / np.float32(32768.0)


# ── BS.1770 loudness ─────────────────────────────────────────────────


def _k_weighting(rate: float) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """High shelf (4 dB, Q 1/sqrt 2, 1,500 Hz) then high pass (Q 0.5, 38 Hz),
    RBJ cookbook biquads."""
    g, q, fc = 4.0, 1.0 / math.sqrt(2.0), 1500.0
    a_val = 10.0 ** (g / 40.0)
    w0 = 2.0 * math.pi * fc / rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    tsa = 2.0 * math.sqrt(a_val) * alpha
    b0 = a_val * ((a_val + 1.0) + (a_val - 1.0) * cw + tsa)
    b1 = -2.0 * a_val * ((a_val - 1.0) + (a_val + 1.0) * cw)
    b2 = a_val * ((a_val + 1.0) + (a_val - 1.0) * cw - tsa)
    a0 = (a_val + 1.0) - (a_val - 1.0) * cw + tsa
    a1 = 2.0 * ((a_val - 1.0) - (a_val + 1.0) * cw)
    a2 = (a_val + 1.0) - (a_val - 1.0) * cw - tsa
    shelf = (np.array([b0, b1, b2]) / a0, np.array([1.0, a1 / a0, a2 / a0]))
    q2, fc2 = 0.5, 38.0
    w0 = 2.0 * math.pi * fc2 / rate
    alpha = math.sin(w0) / (2.0 * q2)
    cw = math.cos(w0)
    ha0 = 1.0 + alpha
    hp = (np.array([(1.0 + cw) / 2.0, -(1.0 + cw), (1.0 + cw) / 2.0]) / ha0,
          np.array([1.0, -2.0 * cw / ha0, (1.0 - alpha) / ha0]))
    return shelf[0], shelf[1], hp[0], hp[1]


def _round_half_away(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def integrated_loudness(data: np.ndarray, rate: int, block_size: float = 0.4) -> float:
    """Gated integrated loudness in LUFS (may be -inf)."""
    x = np.asarray(data, dtype=np.float32)
    n = len(x)
    if n == 0:
        return float("-inf")
    b_s, a_s, b_h, a_h = _k_weighting(float(rate))
    y = lfilter(b_h, a_h, lfilter(b_s, a_s, x.astype(np.float64)))
    prefix = np.concatenate(([0.0], np.cumsum(y * y)))
    t_g = float(block_size)
    num_blocks = _round_half_away((n / rate - t_g) / (t_g * (1.0 - BLOCK_OVERLAP))) + 1
    if num_blocks <= 0:
        ms = prefix[n] / n
        return LUFS_OFFSET + 10.0 * math.log10(ms) if ms > 0.0 else float("-inf")
    window = t_g * rate
    hop = window * (1.0 - BLOCK_OVERLAP)
    j = np.arange(num_blocks, dtype=np.float64)
    lo = (j * hop).astype(np.int64)
    hi = np.minimum((j * hop + window).astype(np.int64), n)
    keep = lo < hi
    block_ms = (prefix[hi[keep]] - prefix[lo[keep]]) / (hi[keep] - lo[keep])
    block_ms = block_ms[block_ms > 0.0]
    if len(block_ms) == 0:
        return float("-inf")
    block_loudness = LUFS_OFFSET + 10.0 * np.log10(block_ms)
    abs_mask = block_loudness >= ABSOLUTE_GATE_LUFS
    if not abs_mask.any():
        return float("-inf")
    gamma_r = LUFS_OFFSET + 10.0 * math.log10(block_ms[abs_mask].mean()) - 10.0
    rel_mask = (block_loudness > gamma_r) & abs_mask
    if not rel_mask.any():
        return float("-inf")
    return LUFS_OFFSET + 10.0 * math.log10(block_ms[rel_mask].mean())


def normalize(data: np.ndarray, rate: int) -> np.ndarray:
    """Gain to -16 LUFS, hard clip to [-1, 1], NaN (silence) to 0."""
    seconds = len(data) / rate
    loud = integrated_loudness(data, rate, seconds if seconds < 0.5 else 0.4)
    with np.errstate(invalid="ignore", over="ignore"):
        gain = 10.0 ** ((TARGET_LUFS - loud) / 20.0)
        y = np.clip(np.asarray(data, dtype=np.float64) * gain, -1.0, 1.0).astype(np.float32)
    return np.nan_to_num(y, nan=0.0)


# ── Peaks ────────────────────────────────────────────────────────────


def _plateau_maxima(x: np.ndarray) -> np.ndarray:
    """Maximal runs of equal values strictly above both neighbours; the
    floor midpoint of each run."""
    if len(x) < 3:
        return np.empty(0, dtype=np.int64)
    d = np.diff(x.astype(np.float64))
    nz = np.flatnonzero(d != 0)
    if len(nz) == 0:
        return np.empty(0, dtype=np.int64)
    rising = nz[d[nz] > 0]
    j = np.searchsorted(nz, rising, side="right")
    ok = j < len(nz)
    rising, nxt = rising[ok], nz[j[ok]]
    falls = d[nxt] < 0
    return ((rising[falls] + 1 + nxt[falls]) // 2).astype(np.int64)


def find_peaks(x: np.ndarray, height: float, distance: int) -> np.ndarray:
    """Peaks at or above ``height``, then tallest first (ties: lower index)
    suppressing neighbours closer than ``distance``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if len(x) == 0 or not (x.max() >= height):
        return np.empty(0, dtype=np.int64)
    peaks = _plateau_maxima(x)
    peaks = peaks[x[peaks] >= height]
    if len(peaks) == 0 or distance <= 0:
        return peaks
    order = np.lexsort((np.arange(len(peaks)), -x[peaks]))
    keep = np.ones(len(peaks), dtype=bool)
    for idx in order:
        if not keep[idx]:
            continue
        lo = idx
        while lo > 0 and peaks[idx] - peaks[lo - 1] < distance:
            lo -= 1
            keep[lo] = False
        hi = idx
        while hi + 1 < len(peaks) and peaks[hi + 1] - peaks[idx] < distance:
            hi += 1
            keep[hi] = False
    return peaks[keep]


# ── Verification ─────────────────────────────────────────────────────


def resample_preserve_maxima(x: np.ndarray, num: int) -> np.ndarray:
    """Window maxima: window i is [trunc(i step), trunc((i + 1) step)), at
    least one sample, clamped to the input."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    step = len(x) / num
    i = np.arange(num, dtype=np.float64)
    start = (i * step).astype(np.int64)
    end = np.maximum(((i + 1) * step).astype(np.int64), start + 1)
    start = np.minimum(start, len(x) - 1)
    end = np.minimum(end, len(x))
    return np.array([x[s:e].max() for s, e in zip(start, end)], dtype=np.float32)


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    da, db = a - a.mean(), b - b.mean()
    denom = math.sqrt(float((da * da).sum()) * float((db * db).sum()))
    return 0.0 if denom == 0.0 else float((da * db).sum()) / denom


def centre_slice(x: np.ndarray, width: int, middle: int) -> np.ndarray:
    beg = int(middle - math.floor(width / 2))
    end = int(middle + math.ceil(width / 2))
    out = np.zeros(end - beg, dtype=x.dtype)
    lo, hi = max(beg, 0), min(end, len(x))
    if hi > lo:
        out[lo - beg: hi - beg] = x[lo:hi]
    return out


def verify_normal(corr_clip: np.ndarray, corr_slice: np.ndarray, short: bool) -> bool:
    parts = 10
    ps = len(corr_clip) // parts
    mses = np.array([np.mean((corr_clip[i * ps:(i + 1) * ps] - corr_slice[i * ps:(i + 1) * ps]) ** 2)
                     for i in range(parts)], dtype=np.float32)
    whole = float(np.mean(mses))
    similarity = whole if short else min(whole, float(np.mean(mses[4:6])))
    if similarity > SIMILARITY_HARD_LIMIT:
        return False
    wl, wr, ds_n = (0, 10, round(101 * 10 / 2)) if short else (4, 6, 101)
    lc = len(corr_clip)
    lo, hi = round(lc * wl / 10), round(lc * wr / 10)
    r = pearson(resample_preserve_maxima(corr_clip[lo:hi], ds_n),
                resample_preserve_maxima(corr_slice[lo:hi], ds_n))
    return r >= PEARSON_R_THRESHOLD


def padded_segment(x: np.ndarray, start: int, length: int) -> np.ndarray:
    out = np.zeros(length, dtype=np.float32)
    lo, hi = max(0, start), min(len(x), start + length)
    if hi > lo:
        out[lo - start: hi - start] = x[lo:hi]
    return out


@dataclass(frozen=True)
class ToneMetrics:
    frequency: float
    band_purity: float
    active_ratio: float
    longest_run: int
    active_mean_purity: float


def _isclose_abs(v: np.ndarray, target: float, abs_tol: float) -> np.ndarray:
    tol = np.maximum(1e-9 * np.maximum(np.abs(v), abs(target)), abs_tol)
    return np.abs(v - target) <= tol


def tone_metrics(x: np.ndarray, rate: int, f0: float) -> ToneMetrics:
    """Hann-window band purity within max(40 Hz, 8 % f0), and 25 ms frames
    at half hop that lock to f0 within max(20 Hz, 4 % f0) at purity 0.55."""
    if len(x) == 0:
        return ToneMetrics(0.0, 0.0, 0.0, 0, 0.0)
    band = max(40.0, f0 * 0.08)
    lock = max(20.0, f0 * 0.04)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), d=1 / rate)
    detected = float(freqs[int(np.argmax(spec))])
    total = float(np.sum(spec ** 2))
    if total == 0.0:
        return ToneMetrics(detected, 0.0, 0.0, 0, 0.0)
    purity = float(np.sum(spec[np.abs(freqs - f0) <= band] ** 2)) / total
    win = max(int(round(0.025 * rate)), 32)
    hop = max(win // 2, 1)
    starts = range(0, len(x) - win, hop)
    if len(starts) == 0:
        return ToneMetrics(detected, purity, 0.0, 0, 0.0)
    frames = np.stack([x[s:s + win] for s in starts])
    fspec = np.abs(np.fft.rfft(frames * np.hanning(win), axis=1))
    power = fspec ** 2
    ffreq = np.fft.rfftfreq(win, d=1 / rate)
    energy = power.sum(axis=1)
    nonzero = energy != 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        fp = np.where(nonzero, power[:, np.abs(ffreq - f0) <= band].sum(axis=1) / energy, 0.0)
    active = nonzero & _isclose_abs(ffreq[np.argmax(fspec, axis=1)], f0, lock) & (fp >= 0.55)
    run = best = 0
    for a in active:
        run = run + 1 if a else 0
        best = max(best, run)
    n_frames, n_active = int(nonzero.sum()), int(active.sum())
    return ToneMetrics(detected, purity, n_active / n_frames if n_frames else 0.0, best,
                       float(np.mean(fp[active])) if n_active else 0.0)


def verify_marker(section: np.ndarray, peak: int, m: int, f0: float, rate: int,
                  thresholds: dict[str, Any]) -> bool:
    start = peak - m + 1
    t = {k: thresholds.get(k, v) for k, v in MARKER_DEFAULTS.items()}
    mid = tone_metrics(padded_segment(section, start, m), rate, f0)
    left = tone_metrics(padded_segment(section, start - m, m), rate, f0)
    right = tone_metrics(padded_segment(section, start + m, m), rate, f0)
    if not math.isclose(mid.frequency, f0, rel_tol=0.05):
        return False
    lo_f = min(left.band_purity, right.band_purity)
    hi_f = max(left.band_purity, right.band_purity)
    return (mid.band_purity >= float(t["minimum_band_purity"])
            and mid.active_ratio >= float(t["minimum_active_frame_ratio"])
            and mid.longest_run >= int(t["minimum_longest_active_run"])
            and mid.active_mean_purity >= float(t["minimum_active_frame_mean_purity"])
            and lo_f <= float(t["maximum_min_flank_purity"])
            and hi_f <= float(t["maximum_max_flank_purity"]))


# ── The detector ─────────────────────────────────────────────────────


@dataclass
class Clip:
    """A pattern as a configuration gives it: raw mono f32 audio at the
    bank's rate, and for a marker tone its frequency and thresholds."""

    name: str
    audio: np.ndarray
    strategy: str | None = None
    tone_hz: float | None = None
    thresholds: dict[str, Any] = field(default_factory=dict)


@dataclass
class _Prepared:
    clip: Clip
    norm: np.ndarray
    sliding_window: int
    corr_clip: np.ndarray
    corr_clip_max: float


def _correlate_full(spec: np.ndarray, size: int, v: np.ndarray, n: int, f32: bool) -> np.ndarray:
    """|correlate(a, v, "full")| from a's rfft of ``size`` points."""
    fv = sfft.rfft(v.astype(np.float32 if f32 else np.float64), size, workers=FFT_WORKERS)
    return _from_lags(sfft.irfft(spec * np.conj(fv), size, workers=FFT_WORKERS), size, len(v), n)


def _from_lags(z: np.ndarray, size: int, m: int, n: int) -> np.ndarray:
    """The 'full' layout (lag k - (m - 1) at index k) of circular lags ``z``
    along the last axis, as |f32|."""
    out = np.concatenate((z[..., size - (m - 1):] if m > 1 else z[..., :0], z[..., :n]), axis=-1)
    return np.abs(out.astype(np.float32))


class ReferenceDetector:
    """Detections of one chunk of a stream, from the raw samples alone."""

    def __init__(self, clips: list[Clip], rate: int, chunk_seconds: int,
                 precision: str = "reference") -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.rate = rate
        self.chunk_seconds = chunk_seconds
        self.precision = precision
        self.prepared: list[_Prepared] = []
        for c in clips:
            norm = self._q(normalize(c.audio, rate))
            seconds = len(c.audio) / rate
            size = _pow2(2 * len(norm) - 1)
            spec = sfft.rfft(self._t(norm), size, workers=FFT_WORKERS)
            cc = _correlate_full(spec, size, norm, len(norm), self._f32)
            top = float(np.max(cc))
            self.prepared.append(_Prepared(c, norm, math.ceil(seconds), cc / np.float32(top), top))
        self.max_sw = max(p.sliding_window for p in self.prepared)
        self._spectra: dict = {}

    @property
    def _f32(self) -> bool:
        return self.precision == "bf16"

    def _q(self, x: np.ndarray) -> np.ndarray:
        return bf16(x) if self.precision == "bf16" else np.asarray(x, dtype=np.float32)

    def _qc(self, z: np.ndarray) -> np.ndarray:
        """A spectrum as the precision holds it: bfloat16 parts in the control."""
        if self.precision != "bf16":
            return z
        return (bf16(z.real) + 1j * bf16(z.imag)).astype(np.complex64)

    def _t(self, x: np.ndarray) -> np.ndarray:
        return x.astype(np.float32 if self._f32 else np.float64)

    def detect(self, chunk: np.ndarray, previous: np.ndarray | None, index: int) -> list[tuple[str, float]]:
        """(clip, seconds from the stream's start) of every detection in
        chunk ``index`` (int16 or f32 samples), ``previous`` the chunk before
        it or None for the first."""
        rate = self.rate
        chunk = pcm16_to_f32(chunk) if chunk.dtype == np.int16 else np.asarray(chunk, np.float32)
        if previous is not None and previous.dtype == np.int16:
            previous = pcm16_to_f32(previous)
        events: list[tuple[str, float]] = []
        for sw in sorted({p.sliding_window for p in self.prepared}):
            raw = chunk if previous is None else np.concatenate((previous[int(-sw * rate):], chunk))
            section = self._q(normalize(raw, rate))
            group = [p for p in self.prepared if p.sliding_window == sw]
            size = _pow2(len(section) + max(len(p.norm) for p in group) - 1)
            spec = self._qc(sfft.rfft(self._t(section), size, workers=FFT_WORKERS))
            subtract = sw if previous is not None else 0
            for block in self._blocks(group):
                m = len(block[0].norm)
                lags = sfft.irfft(self._qc(spec[None, :] * self._conj_spectra(block, size)), size,
                                  axis=-1, workers=FFT_WORKERS)
                for p, corr in zip(block, _from_lags(lags, size, m, len(section))):
                    top = max(p.corr_clip_max, float(np.max(corr)))
                    corr = self._q(corr / np.float32(top))
                    for peak in self._accepted(section, corr, p):
                        t = peak / rate - subtract + index * self.chunk_seconds - m / rate
                        events.append((p.clip.name, t if t >= 0 else 0))
        events.sort(key=lambda e: (e[1], e[0]))
        return events

    def _blocks(self, group: list[_Prepared]) -> list[list[_Prepared]]:
        """The class's clips in blocks of one length, at most ``BLOCK`` each."""
        by_len: dict[int, list[_Prepared]] = {}
        for p in group:
            by_len.setdefault(len(p.norm), []).append(p)
        return [ps[i:i + BLOCK] for _, ps in sorted(by_len.items()) for i in range(0, len(ps), BLOCK)]

    def _conj_spectra(self, block: list[_Prepared], size: int) -> np.ndarray:
        key = (size, tuple(id(p) for p in block))
        if key not in self._spectra:
            clips = np.stack([self._t(p.norm) for p in block])
            self._spectra[key] = self._qc(np.conj(sfft.rfft(clips, size, axis=-1, workers=FFT_WORKERS)))
        return self._spectra[key]

    def _accepted(self, section: np.ndarray, corr: np.ndarray, p: _Prepared) -> list[int]:
        m = len(p.norm)
        half = len(p.corr_clip) // 2
        out = []
        for peak in find_peaks(corr, HEIGHT_MIN, m):
            peak = int(peak)
            if peak + half > len(corr) + 5 or peak - half < -5:
                continue
            if p.clip.strategy == MARKER_STRATEGY and p.clip.tone_hz is not None:
                ok = verify_marker(section, peak, m, p.clip.tone_hz, self.rate, p.clip.thresholds)
            else:
                sl = centre_slice(corr, len(p.corr_clip), peak)
                sl = self._q(sl / sl.max())
                ok = verify_normal(p.corr_clip, sl, m / self.rate < SHORT_CLIP_SECONDS)
            if ok:
                out.append(peak)
        return out


def _pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size
