"""Pattern bank on a torch device: the lean kernel path of
audio_pattern_detector_tpu/models/bank.py.

Clips group by (sliding_window, clip_len, strategy); each sliding-window
class runs one class step per chunk section:

  1. upload the section (int16 rows decode on the device) and
     loudness-normalise it;
  2. correlate it against every group's bank (overlap-save FFT, one
     section spectrum per class);
  3. run the candidate-scan kernel over each group's |correlation| and
     the exact block-wise greedy seeded from its block maxima;
  4. verify the survivors and pack a (G, 2K+2) f32 decision payload.

Only the payload crosses back to the host. Its copy into pinned host
memory is enqueued at dispatch time; the dispatch record's element [1]
is a :class:`PayloadHandle` whose ``is_ready()`` polls a CUDA event, so
the detector's pipelined loops collect without blocking.

Flag semantics per payload row (column 2K): 0 = exact as returned;
1 = host path required (a >= 4 plateau at the conservative threshold);
2 = wide rerun required (> 16 greedy survivors or a near-collapse row).
In this port both flagged kinds take the exact host path
(``hostpath.process_section_host``); the wide device rerun is not
ported yet. ``host_path_rows`` counts the rows sent there.

Batched dispatch runs the JAX package's scan schedule as a Python loop
over the rows on the current stream, one chunk's memory at a time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from numpy.typing import NDArray

from audio_pattern_detector_tpu import native
from audio_pattern_detector_tpu.models import hostpath
from audio_pattern_detector_tpu_torch.ops.candidate_scan import BLOCK, candidate_scan
from audio_pattern_detector_tpu_torch.ops.correlate import (
    CorrelationBankConsts,
    bank_correlate_abs,
    build_correlation_bank,
    class_overlap_save_geometry,
    section_segment_spectra,
)
from audio_pattern_detector_tpu_torch.ops.loudness import (
    LoudnessConsts,
    build_loudness_consts,
    integrated_loudness_device,
    loudness_normalize_device,
)
from audio_pattern_detector_tpu_torch.ops.packing import as_f32, upload_rows
from audio_pattern_detector_tpu_torch.ops.peaks import (
    greedy_survivors_from_blocks,
    plateau_run_mask,
)
from audio_pattern_detector_tpu_torch.ops.slicing import slice_rows_windows
from audio_pattern_detector_tpu_torch.ops.verify import (
    MarkerVerifyConsts,
    NormalVerifyConsts,
    build_marker_verify_consts,
    build_normal_verify_consts,
    verify_marker,
    verify_normal,
)

_BIG = 2**30  # dead-lane position (== ops/peaks.SURVIVOR_POS_SENTINEL)
_SMALL_TIER = 16  # greedy survivor lanes of the lean tier


@dataclass
class ClipGroup:
    """Clips sharing (sliding_window, clip_len, strategy): one device batch."""

    names: list[str]
    clip_len: int
    kind: str  # 'normal' | 'marker'
    k_detect: int
    k_verify: int
    corr: CorrelationBankConsts
    verify: "NormalVerifyConsts | MarkerVerifyConsts"
    # Host-side data for the exact host path.
    clips_np: NDArray[np.float32]  # (G, m) normalised clips
    corr_clips_np: NDArray[np.float32]  # (G, 2m-1)
    self_max_np: NDArray[np.float64]  # (G,)
    tone_freqs: list[float | None]
    verification_params: list[dict[str, Any]]


class PayloadHandle:
    """A dispatched payload on its way to the host.

    On CUDA the device-to-host copy into pinned memory is enqueued on the
    current stream at construction and a CUDA event marks its end;
    ``is_ready()`` polls the event and ``numpy()`` waits for it."""

    def __init__(self, payload: torch.Tensor) -> None:
        if payload.device.type == "cuda":
            self._host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
            self._host.copy_(payload, non_blocking=True)
            self._event: "torch.cuda.Event | None" = torch.cuda.Event()
            self._event.record()
        else:
            self._host = payload
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> NDArray[np.float32]:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class PatternBank:
    """Device pattern bank for one detector configuration."""

    def __init__(
        self,
        clip_datas: dict[str, dict[str, Any]],
        tone_frequencies: dict[str, float],
        strategy_params: dict[str, dict[str, Any]],
        sample_rate: int,
        chunk_samples: int,
        height_min: float,
        device: "torch.device | str",
    ) -> None:
        if not height_min > 0:
            raise NotImplementedError(
                f"height_min {height_min} <= 0 needs the general plateau "
                "tier, which the torch port does not have yet"
            )
        self.device = torch.device(device)
        self.sample_rate = sample_rate
        self.height_min = float(height_min)
        self.host_path_rows = 0  # flagged rows resolved on the exact host path

        grouped: dict[tuple[int, int, str], list[str]] = {}
        for name, cd in clip_datas.items():
            kind = "marker" if name in tone_frequencies else "normal"
            grouped.setdefault((cd["sliding_window"], len(cd["clip"]), kind), []).append(name)
        class_clip_lens: dict[int, list[int]] = {}
        for sw, m, _ in grouped:
            class_clip_lens.setdefault(sw, []).append(m)
        shared_geoms = {
            sw: class_overlap_save_geometry(sw * sample_rate + chunk_samples, ms)
            for sw, ms in class_clip_lens.items()
        }

        self.classes: dict[int, dict[str, Any]] = {}
        for (sw, m, kind), names in sorted(grouped.items()):
            section_len = sw * sample_rate + chunk_samples
            cls = self.classes.setdefault(
                sw, {"section_len": section_len, "loud": None, "groups": []}
            )
            if cls["loud"] is None:
                cls["loud"] = build_loudness_consts(section_len, sample_rate, self.device)
            clips_np = np.stack([clip_datas[n]["clip"] for n in names])
            corr_clips_np = np.stack([clip_datas[n]["correlation_clip"] for n in names])
            self_max_np = np.array(
                [float(clip_datas[n]["correlation_clip_absolute_max"]) for n in names]
            )
            corr = build_correlation_bank(
                clips_np, self_max_np, section_len, self.device, shared_geoms[sw]
            )
            full_len = corr.full_len
            # The JAX bank's lane sizing. k_verify bounds the post-distance
            # survivors (full_len // m + 1); k_detect sizes the wide rerun,
            # which is not ported, and enters the lean tier only as
            # min(_SMALL_TIER, k_detect) greedy lanes.
            k_verify = min(1024, full_len // m + 4)
            k_detect = max(min(4096, max(64, 4 * (full_len // m) + 16)), k_verify)
            verify: "NormalVerifyConsts | MarkerVerifyConsts"
            if kind == "marker":
                dom = np.array([tone_frequencies[n] for n in names])
                vparams = [strategy_params.get(n, {}).get("verification", {}) for n in names]
                verify = build_marker_verify_consts(m, sample_rate, dom, vparams, self.device)
                tone_freqs: list[float | None] = [tone_frequencies[n] for n in names]
                comb = int(np.ceil(2.0 * m * float(dom.max()) / sample_rate))
                k_detect = min(16384, max(k_detect, 8 * comb + 256))
            else:
                verify = build_normal_verify_consts(corr_clips_np, m, sample_rate, self.device)
                vparams = [{} for _ in names]
                tone_freqs = [None for _ in names]
            cls["groups"].append(
                ClipGroup(
                    names=names, clip_len=m, kind=kind,
                    k_detect=k_detect, k_verify=k_verify, corr=corr, verify=verify,
                    clips_np=clips_np, corr_clips_np=corr_clips_np,
                    self_max_np=self_max_np, tone_freqs=tone_freqs,
                    verification_params=vparams,
                )
            )
        self._metas = {
            sw: tuple((g.kind, g.clip_len, g.k_detect, g.k_verify) for g in cls["groups"])
            for sw, cls in self.classes.items()
        }

    # ── Sections ──

    def _raw_section(
        self,
        sw: int,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> NDArray[Any]:
        """Prepend the last ``sw`` seconds of the previous chunk (the
        overlap-save lookback; reference: audio_pattern_detector.py:400-412).
        A mixed int16/f32 pair decodes the int16 side first."""
        if previous_chunk is None:
            return chunk
        tail = previous_chunk[int(-sw * self.sample_rate):]
        if tail.dtype != chunk.dtype:
            if tail.dtype == np.int16:
                tail = native.pcm16_to_f32_mono(tail)
            if chunk.dtype == np.int16:
                chunk = native.pcm16_to_f32_mono(chunk)
        return np.concatenate((tail, chunk))

    @staticmethod
    def _section_rows(section_len: int, raws: list[NDArray[Any]]) -> NDArray[Any]:
        """(B, S) zero-padded host rows: int16 when every row is int16,
        else f32 with int16 rows decoded on the host (bitwise the device
        decode)."""
        as_i16 = all(r.dtype == np.int16 for r in raws)
        rows = np.zeros((len(raws), section_len), dtype=np.int16 if as_i16 else np.float32)
        for bi, raw in enumerate(raws):
            if not as_i16 and raw.dtype == np.int16:
                raw = native.pcm16_to_f32_mono(raw)
            rows[bi, : len(raw)] = raw
        return rows

    def _section_step(self, sw: int, section: torch.Tensor, n_valid: int) -> torch.Tensor:
        cls = self.classes[sw]
        return class_step_fused(
            section, n_valid, cls["loud"],
            tuple((g.corr, g.verify) for g in cls["groups"]),
            metas=self._metas[sw], height_min=self.height_min,
        )

    # ── Single-chunk dispatch ──

    def dispatch_chunk(
        self,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> list[tuple[int, PayloadHandle, NDArray[Any]]]:
        """Enqueue one stream chunk; returns per-class records."""
        dispatched = []
        for sw, cls in self.classes.items():
            raw = self._raw_section(sw, chunk, previous_chunk)
            rows = upload_rows(self._section_rows(cls["section_len"], [raw]), self.device)
            flat = self._section_step(sw, as_f32(rows[0]), len(raw))
            dispatched.append((sw, PayloadHandle(flat), raw))
        return dispatched

    def collect_chunk(
        self, dispatched: list[tuple[int, PayloadHandle, NDArray[Any]]]
    ) -> dict[str, list[int]]:
        """Wait for a dispatched chunk; accepted 'full'-index peak positions
        per clip name (ascending)."""
        results: dict[str, list[int]] = {}
        for sw, handle, raw in dispatched:
            batch = self._collect_rows(sw, handle.numpy()[None], [raw])
            results.update(batch[0])
        return results

    def process_chunk(
        self,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> dict[str, list[int]]:
        return self.collect_chunk(self.dispatch_chunk(chunk, previous_chunk))

    # ── Batched dispatch (the scan schedule) ──

    def dispatch_chunks_batch(
        self,
        chunks: list[NDArray[Any]],
        previous_tail: "NDArray[Any] | None",
        mode: str = "scan",
    ) -> list[tuple[int, PayloadHandle, list[NDArray[Any]], int, None]]:
        """Enqueue consecutive chunks (chunk i's lookback is chunk i-1,
        ``previous_tail`` seeding the first). The rows run one after
        another on the current stream; the payload copies back once per
        class."""
        if mode != "scan":
            raise ValueError(f"the torch port runs mode='scan' only, got {mode!r}")
        if not chunks:
            return []
        b = len(chunks)
        dispatched = []
        for sw, cls in self.classes.items():
            raws = [
                self._raw_section(sw, chunk, chunks[bi - 1] if bi else previous_tail)
                for bi, chunk in enumerate(chunks)
            ]
            rows = upload_rows(self._section_rows(cls["section_len"], raws), self.device)
            payload = torch.stack(
                [self._section_step(sw, as_f32(rows[bi]), len(raws[bi])) for bi in range(b)]
            )
            dispatched.append((sw, PayloadHandle(payload), raws, b, None))
        return dispatched

    def collect_chunks_batch(
        self,
        dispatched: list[tuple[int, PayloadHandle, list[NDArray[Any]], int, None]],
    ) -> list[dict[str, list[int]]]:
        """Wait for a dispatched batch; per-chunk result dicts."""
        if not dispatched:
            return []
        results: list[dict[str, list[int]]] = [dict() for _ in range(dispatched[0][3])]
        for sw, handle, raws, _b, _ in dispatched:
            for bi, res in enumerate(self._collect_rows(sw, handle.numpy(), raws)):
                results[bi].update(res)
        return results

    def _collect_rows(
        self, sw: int, flat_np: NDArray[np.float32], raws: list[NDArray[Any]]
    ) -> list[dict[str, list[int]]]:
        """Unpack a (B, total) class payload; flagged rows take the host path."""
        groups = self.classes[sw]["groups"]
        results: list[dict[str, list[int]]] = [dict() for _ in raws]
        for g, packed in zip(groups, _split_fused(flat_np, groups)):
            pos, sel, host_fb, needs_full = unpack_group(packed, g.k_verify)
            for bi, raw in enumerate(raws):
                for ci, name in enumerate(g.names):
                    if host_fb[bi, ci] or needs_full[bi, ci]:
                        section = native.pcm16_to_f32_mono(raw) if raw.dtype == np.int16 else raw
                        results[bi][name] = self._host_fallback(g, ci, section)
                    else:
                        results[bi][name] = [int(p) for p in pos[bi, ci][sel[bi, ci]]]
        return results

    def _host_fallback(
        self, g: ClipGroup, ci: int, raw_section: NDArray[np.float32]
    ) -> list[int]:
        """Exact host path for a flagged row."""
        self.host_path_rows += 1
        return hostpath.process_section_host(
            audio_section=raw_section,
            clip=g.clips_np[ci],
            correlation_clip=g.corr_clips_np[ci],
            correlation_clip_absolute_max=float(g.self_max_np[ci]),
            sr=self.sample_rate,
            height_min=self.height_min,
            is_short_clip=g.clip_len / self.sample_rate < 0.5,
            tone_frequency=g.tone_freqs[ci],
            verification_params=g.verification_params[ci],
        )


def _split_fused(
    flat: NDArray[np.float32], groups: list[ClipGroup]
) -> list[NDArray[np.float32]]:
    """Split a fused payload (..., total) into per-group (..., G, 2K+2) views."""
    out = []
    off = 0
    for g in groups:
        gn = len(g.names)
        w = 2 * g.k_verify + 2
        out.append(flat[..., off : off + gn * w].reshape(*flat.shape[:-1], gn, w))
        off += gn * w
    return out


def unpack_group(
    packed: NDArray[np.float32], k_verify: int
) -> tuple[NDArray[np.int32], NDArray[np.bool_], NDArray[np.bool_], NDArray[np.bool_]]:
    """(pos, selected, host_fallback, needs_full_tier) of a packed group
    payload (..., 2K+2); leading batch axes pass through."""
    pos = packed[..., :k_verify].astype(np.int32)
    sel = packed[..., k_verify : 2 * k_verify] != 0
    flag = packed[..., 2 * k_verify]
    host_fallback = (flag == 1.0) | (packed[..., 2 * k_verify + 1] != 0)
    needs_full = flag == 2.0
    return pos, sel, host_fallback, needs_full


# ── The class step ──


def lean_group_packed(
    norm: torch.Tensor,  # (S,) normalised section
    corr: torch.Tensor,  # (G, L) |correlation|, unnormalised
    valid_len: int,
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts: "NormalVerifyConsts | MarkerVerifyConsts",
    self_corr_max: torch.Tensor,  # (G,) f32
    scan=candidate_scan,
) -> torch.Tensor:
    """Lean tier of one group: candidate scan, in-program greedy, verify.

    Port of ``_lean_group_packed_pallas``. The scan's block maxima of raw
    |corr| seed the exact greedy; each greedy round re-derives the
    candidate mask on a +-2-halo window in normalised (quotient) space,
    the space every tier compares in, so unflagged rows are bitwise the
    full tier's. The scan's near-collapse flag routes the rows where f32
    division could make the two spaces disagree.
    """
    hm = float(np.float32(height_min))  # compares as JAX's f32 threshold
    g, l = corr.shape
    dev = corr.device
    neg_inf = torch.full((), -math.inf, device=dev)
    bmax, _count, plateau_min, omax, near = scan(corr, hm * self_corr_max, valid_len)
    denom = torch.maximum(self_corr_max, omax).clamp_min(1e-38)
    qb = bmax / denom[:, None]
    bwork0 = torch.where(qb >= hm, qb, neg_inf)

    w = BLOCK + 4
    corr_w = F.pad(corr, (0, w - l)) if l < w else corr  # windows must fit the row
    woffs = torch.arange(w, device=dev)[None, :]
    neg1 = torch.full((g, 1), -math.inf, device=dev)
    neg2 = torch.full((g, 2), -math.inf, device=dev)

    def gather_scored(b_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        start = (b_idx * BLOCK - 2).clamp(0, max(l - w, 0))
        xw = slice_rows_windows(corr_w, start[:, None], w)[:, 0, :]
        c = start[:, None] + woffs  # global positions, ascending
        xq = torch.where(c < valid_len, xw / denom[:, None], neg_inf)
        xm1 = torch.cat([neg1, xq[:, :-1]], dim=1)
        xm2 = torch.cat([neg2, xq[:, :-2]], dim=1)
        xp1 = torch.cat([xq[:, 1:], neg1], dim=1)
        xp2 = torch.cat([xq[:, 2:], neg2], dim=1)
        runs = plateau_run_mask(
            xq, xm2, xm1, xp1, xp2, torch.isfinite(xp1), torch.isfinite(xp2), left_ok=c > 1
        )
        lo = b_idx[:, None] * BLOCK
        mask = runs & (c >= lo) & (c < lo + BLOCK) & (c > 0) & torch.isfinite(xq) & (xq >= hm)
        return torch.where(mask, xq, neg_inf), c

    k_lanes = min(_SMALL_TIER, k_detect)
    pos, height, overflow = greedy_survivors_from_blocks(
        bwork0, gather_scored, m, k_lanes, BLOCK
    )
    needs_full = ~plateau_min & (overflow | near)
    flag = torch.where(plateau_min, 1.0, torch.where(needs_full, 2.0, 0.0))

    # The verifier reads the normalised correlation, exact zeros past valid_len.
    in_range = torch.arange(l, device=dev)[None, :] < valid_len
    corr_n = torch.where(in_range, corr, 0.0) / denom[:, None]
    return _lean_tail(
        norm, corr_n, valid_len, kind, m, k_verify, verify_consts, pos, height, flag, k_lanes
    )


def _lean_tail(
    norm, corr, valid_len, kind, m, k_verify, verify_consts, pos, height, flag, k_lanes
) -> torch.Tensor:
    """Bounds -> compact ascending -> verify -> packed (G, 2K+2) payload.
    The lanes already are the greedy survivors. The verify runs for every
    group, even a candidate-free one (its ``sel`` is zero either way)."""
    keep = torch.isfinite(height)
    # Candidate bound checks (reference: audio_pattern_detector.py:531-546).
    half = (2 * m - 1) // 2
    keep = keep & ~(pos + half > valid_len + 5) & ~(pos - half < -5)
    kv = min(k_verify, k_lanes)
    score = torch.where(keep, -pos, -_BIG)
    sv = torch.topk(score, kv, dim=1).values  # distinct live values, descending
    vpos = -sv
    valive = sv > -_BIG
    verify_overflow = keep.sum(dim=1) > kv
    if kind == "marker":
        accept = verify_marker(norm, vpos, valive, verify_consts)
    else:
        accept = verify_normal(corr, vpos, valive, verify_consts)[0]
    sel = (valive & accept).to(torch.float32)
    vposf = vpos.to(torch.float32)
    if kv < k_verify:
        vposf = F.pad(vposf, (0, k_verify - kv), value=float(_BIG))
        sel = F.pad(sel, (0, k_verify - kv))
    return torch.cat(
        [vposf, sel, flag[:, None].to(torch.float32), verify_overflow[:, None].to(torch.float32)],
        dim=1,
    )


def class_step(
    section: torch.Tensor,  # (S,) f32
    n_valid: int,
    loud: LoudnessConsts,
    group_consts: tuple,
    *,
    metas: tuple,
    height_min: float,
    scan=candidate_scan,
) -> list[torch.Tensor]:
    """One sliding-window class over one section: packed payload per group.

    ``scan`` is the candidate scan (the kernel wrapper by default; the
    plain version to compare against it on the same device)."""
    lufs = integrated_loudness_device(section, n_valid, loud)
    norm = loudness_normalize_device(section, lufs)

    # One section-segment FFT for the class when every group shares its
    # overlap-save geometry.
    shared_spec = None
    geoms = {(c.fft_len, c.step, c.pad_left, c.num_segments) for c, _ in group_consts}
    if len(geoms) == 1 and all(
        c.num_segments > 1 and c.pad_left >= 0 and c.step > 0 for c, _ in group_consts
    ):
        shared_spec = section_segment_spectra(norm, group_consts[0][0])

    outs = []
    for (kind, m, k_detect, k_verify), (corr_consts, verify_consts) in zip(metas, group_consts):
        corr, valid_len = bank_correlate_abs(norm, n_valid, corr_consts, shared_spec)
        outs.append(
            lean_group_packed(
                norm, corr, valid_len, kind, m, k_detect, k_verify, height_min,
                verify_consts, corr_consts.self_corr_max, scan,
            )
        )
    return outs


def class_step_fused(section, n_valid, loud, group_consts, *, metas, height_min, scan=candidate_scan):
    """:func:`class_step` with every group's payload flattened into one vector."""
    outs = class_step(
        section, n_valid, loud, group_consts, metas=metas, height_min=height_min, scan=scan
    )
    return torch.cat([o.reshape(-1) for o in outs])
