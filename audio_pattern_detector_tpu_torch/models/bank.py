"""Pattern bank on a torch device: port of
audio_pattern_detector_tpu/models/bank.py (lean tier, full tier, rerun).

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
Flag-2 rows re-derive on the device through the wide tier at collect
time (:meth:`PatternBank.resolve_flagged_rows`): one row at a time when
few, the whole class when many, first at a capped lane width and then,
for rows past the cap, at the group's full ``k_detect``. Flag-1 rows, and
rows the wide tier itself flags, take the exact host path
(``hostpath.process_section_host``). Counters on the bank say which
route each row took.

``height_min <= 0`` runs the general-plateau tier (:func:`rich_group_packed`)
in place of the lean one.

The class step has one form, the one the card runs: int16 rows upload as
int16 wherever every part of the round is int16; each class correlates
through its overlap-save segments wherever its geometry has them; in a
captured lean step a group none of whose rows has a live lane skips its
verify tail (the JAX ``lax.cond`` in ``_lean_tail``) through a CUDA
conditional node (``models/captured.py``), which needs no host sync, and
the plain block-wise greedy runs its ``r_max`` rounds as the body of a
while loop that exits once every row is exhausted
(``ops/peaks.py::greedy_survivors_from_blocks``), so a candidate-free group
runs none. The eager step, which has no node, always verifies and runs the
rounds unrolled; the payload is the same either way. The plain greedy runs
on the CPU and in the mask tier; the kernel tier on a card runs the
greedy's CUDA kernel (``ops/lean_greedy.py``), one launch a group. The JAX
bank's ``APD_PACKED_UPLOAD``, ``APD_NO_OVERLAP_SAVE``,
``APD_SKIP_EMPTY_VERIFY`` and ``APD_GREEDY_UNROLL`` pick other forms of the
same step with the same detections; the port does not read them, since no
caller selects them and none was faster on the card.

Two of the JAX bank's switches do pick a form here:

* ``APD_PALLAS=0``, read when the bank is built: the mask lean tier
  (:func:`mask_group_packed`), the JAX package's default off the TPU: the
  candidate mask over the normalised correlation, no kernel. Unset or any
  other value keeps the kernel tier; nothing else leaves it, and a kernel
  that fails to build or launch raises.
* ``APD_MARKER_GEMM``, read at each call (``ops/verify_marker.py``): the
  plain marker verifier's spectra, which the CPU runs; on a card the
  marker verifier is one fused kernel that makes its own spectra, whatever
  the switch says.

:meth:`PatternBank.step` runs a class step under the bank's switches: the
dispatch paths, the mesh paths and the flagship probes all go through it.

Batched dispatch has the JAX package's two schedules, with identical
results. ``mode="scan"`` runs the class step row after row on the current
stream, one chunk's memory at a time. ``mode="vmap"`` runs one class step
over all B rows of the round: the rows are a leading axis of every op,
folded into the clip axis where an op is row-wise ((B, G, L) correlations
as (B * G, L) rows with per-row lengths), so the candidate-scan kernel
launches once per group per round and memory is B times a step's.

On a CUDA device every class step runs as a replay of a captured CUDA
graph, the counterpart of the JAX bank's jitted class-step programs
(``models/captured.py``): one graph per (device, class, B, upload dtype,
tier, constants), the batched form with B = 1 for one section.
"scan" replays the B = 1 graph once per row, "vmap" the (B) graph once per
round. A graph keeps its memory pools for as long as its bank lives, about
twice the eager round's peak, so no graph is wider than :data:`GRAPH_ROWS`:
a round of more rows runs as replays of that width
(:class:`models.captured.SplitRound`), each writing its rows of the round's
payload, the last one's spare rows idle (zero-length). The eager step runs
a wide round in the same W-row steps, so the two agree bit for bit at
every width (cuFFT may round a batch of B rows otherwise than W-row ones).
The two greedy filters are CUDA kernels on a card, one launch a group
(``ops/lean_greedy.py``, ``ops/lane_greedy.py``); the mask tier's lean
greedy and the verify tail's skip are CUDA conditional nodes inside the
graph, and the general-plateau tier verifies every lane in one launch of
each verifier's kernel, so no dispatch makes a host sync.
``capture=False`` (a constructor argument, and the ``capture`` attribute)
runs the eager step instead, whose mask-tier greedy runs its rounds
unrolled; the plain verifiers' two-tier cond reads its predicate on the host;
the CPU has only the eager step, whose plain greedies drive their loops
from the host. The wide rerun and
the host path run at collect time, sync with the host and stay eager.

A ``"vmap"`` round can also be spread over a device mesh (``sharding=``):
its rows split contiguously over the mesh's stream axis, each shard's rows
run the batched class step on that shard's device against a replica of the
class's constants (:meth:`PatternBank.replica`), and the shards' payloads
are stitched in row order on the host at collect. Every shard is enqueued
before any payload is awaited.

A dispatch writes each section, lookback and chunk, straight into a host
buffer from the bank's pool (the JAX bank's ``_payload_pool``), pinned on a
CUDA bank so that the upload is an asynchronous copy on the current stream;
the dispatch record's raw sections are views of that buffer. A buffer
returns to the pool only when its dispatch is collected: its payload is
then on the host, so the step that read the upload has run, and its
flagged rows have been resolved. A dispatch that is never collected keeps
its buffer.
"""

from __future__ import annotations

import functools
import math
import os
import time
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch import native
from audio_pattern_detector_tpu_torch.models import hostpath
from audio_pattern_detector_tpu_torch.models.captured import (
    CapturedStep,
    EagerStep,
    SplitRound,
    StepGraphs,
    StepKey,
)
from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
from audio_pattern_detector_tpu_torch.ops.consts import consts_to_device
from audio_pattern_detector_tpu_torch.ops.correlate import (
    CorrelationBankConsts,
    bank_correlate,
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
from audio_pattern_detector_tpu_torch.ops.devices import canonical_device, device_guard
from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy
from audio_pattern_detector_tpu_torch.ops.packing import upload_rows
from audio_pattern_detector_tpu_torch.ops.peaks import (
    Loop,
    PeakCandidates,
    ValidLen,
    f32,
    find_peaks_device_fast,
    greedy_distance_filter,
    greedy_survivors_blockwise,
    long_plateau_present,
    row_limit,
    short_run_local_maxima_mask,
    topk_sparse,
)
from audio_pattern_detector_tpu_torch.ops.verify import (
    MarkerVerifyConsts,
    NormalVerifyConsts,
    build_marker_verify_consts,
    build_normal_verify_consts,
    verify_marker,
    verify_normal,
)
from audio_pattern_detector_tpu_torch.ops.verify_marker import _marker_gemm_enabled
from audio_pattern_detector_tpu_torch.utils.profiling import RECORDER

_BIG = 2**30  # dead-lane position (== ops/peaks.SURVIVOR_POS_SENTINEL)
_SMALL_TIER = 16  # greedy survivor lanes of the lean tier

# The widest round one class step runs. A captured key keeps its graph
# pools, about twice its eager round's peak, for as long as its bank lives
# (scripts/probe_general_memory.py); a wider round, captured or eager, is
# steps of this width.
GRAPH_ROWS = 16
# branch(pred, body): run body() where the 0-d device bool ``pred`` holds
# (models/captured.py; the lean tail's skip of candidate-free groups).
Branch = Callable[[torch.Tensor, Callable[[], Any]], None]
# cond(pred, then_, else_): run then_() where the 0-d device bool ``pred``
# holds, else else_() (the two-tier verify's lax.cond; on the device
# models/captured.py, on the host host_cond).
Cond = Callable[[torch.Tensor, Callable[[], Any], Callable[[], Any]], None]


def host_cond(pred: torch.Tensor, then_: Callable[[], Any], else_: Callable[[], Any]) -> None:
    """The host's :data:`Cond`: one sync, to read ``pred``."""
    (then_ if bool(pred) else else_)()


# Cumulative host seconds per dispatch_chunks_batch stage, process-wide:
# each row's section parts (lookback and chunk), their copy into the
# zero-padded staging rows ("pack", the JAX bank's key), the upload, the
# enqueue of the class step's launches, and the enqueue of the payload's
# copy back. In the "scan" schedule pack, upload and launch come once a
# row, and each adds the sum of its rows. Probes read and reset it to say
# where a round's dispatch time goes (chip_smoke.py). While recording, the
# same clock readings make the spans ``bank.<stage>``
# (utils/profiling.py).
dispatch_phase_seconds: dict[str, float] = {
    "sections": 0.0,
    "pack": 0.0,
    "upload": 0.0,
    "launch": 0.0,
    "prefetch": 0.0,
}

# The routes of a flagged row, each rerun's span ``collect.flagged`` holding
# its index as its first attribute (:meth:`PatternBank.resolve_flagged_rows`).
# While recording, the counter ``flagged_rows`` moves wherever one of the
# bank's four route counts does, by as much: each row rerun, class rerun,
# escalated row and host-path row is one.
FLAGGED_ROUTES = ("row", "class", "escalated", "host")
_route = FLAGGED_ROUTES.index


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
    current stream of the payload's device at construction and a CUDA
    event of that device marks its end; ``is_ready()`` polls the event and
    ``numpy()`` waits for it."""

    def __init__(self, payload: torch.Tensor) -> None:
        if payload.device.type == "cuda":
            with device_guard(payload.device):
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
        span = RECORDER.open("collect.wait") if RECORDER.on else -1
        if self._event is not None:
            self._event.synchronize()
        if span >= 0:
            RECORDER.close(span)
        return self._host.numpy()


class RowPayloads:
    """A scan class's (B, total) payload on its way to the host row by row
    (:meth:`PatternBank._dispatch_rows` on a card): each row's step output
    is copied into its row of a pinned host buffer on the current stream
    behind that row's step, and an event a row marks the copy's end, so
    collect decodes the rows that have finished while the card runs the
    rest (:meth:`PatternBank.collect_chunks_batch`).

    ``finished()`` polls the rows' events in turn (one stream completes
    them in order) and returns how many leading rows are on the host;
    ``wait(i)`` waits for row ``i``. ``is_ready()`` polls the last row's
    event and ``numpy()`` waits for it, as :class:`PayloadHandle`'s do.
    The buffer and its events come from the bank's pool and go back to it
    at collect (``release()``). ``on_final``, where the caller sets it on
    its round's last class, is handed each batch of rows whose results are
    final, as (row indices, the round's result dicts)."""

    def __init__(self, host: torch.Tensor, events: list) -> None:
        self._host = host
        self._rows = host.numpy()
        self._events = events
        self._done = 0  # leading rows known to be on the host
        self.on_final: "Callable[[list[int], list[dict[str, list[int]]]], None] | None" = None

    def copy_row(self, bi: int, out: torch.Tensor) -> None:
        """Enqueue row ``bi``'s copy from the device and its event on the
        current stream."""
        self._host[bi].copy_(out.reshape(-1), non_blocking=True)
        self._events[bi].record()

    def finished(self) -> int:
        while self._done < len(self._events) and self._events[self._done].query():
            self._done += 1
        return self._done

    def wait(self, i: int) -> int:
        """Wait for row ``i``; then :meth:`finished`. While recording, the
        wait is the span ``collect.wait``."""
        span = RECORDER.open("collect.wait") if RECORDER.on else -1
        self._events[i].synchronize()
        if span >= 0:
            RECORDER.close(span)
        self._done = max(self._done, i + 1)
        return self.finished()

    def rows(self, lo: int, hi: int) -> NDArray[np.float32]:
        return self._rows[lo:hi]

    def is_ready(self) -> bool:
        return self._events[-1].query()

    def numpy(self) -> NDArray[np.float32]:
        self.wait(len(self._events) - 1)
        return self._rows

    def release(self) -> tuple[torch.Tensor, list]:
        """(host buffer, events) for the pool; the handle holds neither."""
        held = (self._host, self._events)
        self._host = self._rows = self._events = None  # type: ignore[assignment]
        return held


class StitchedPayload:
    """The payloads of one class step that ran as several shards, each a
    :class:`PayloadHandle` on its own device; ``numpy()`` waits for all of
    them and returns ``stitch(parts)``, the payload the unsharded step
    would have given."""

    def __init__(
        self,
        parts: list[PayloadHandle],
        stitch: "Callable[[list[NDArray[np.float32]]], NDArray[np.float32]]",
    ) -> None:
        self._parts = parts
        self._stitch = stitch

    def is_ready(self) -> bool:
        return all(p.is_ready() for p in self._parts)

    def numpy(self) -> NDArray[np.float32]:
        return self._stitch([p.numpy() for p in self._parts])


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
        capture: "bool | None" = None,
    ) -> None:
        self.device = torch.device(device)
        self.sample_rate = sample_rate
        self.height_min = float(height_min)
        # Routes of flagged rows. A row rerun is one launch for one row; a
        # class rerun one launch for every row of the class; an escalated
        # row is one the capped rerun sent on to the full k_detect width
        # (its launch counts as a row or class rerun too).
        self.row_reruns = 0
        self.class_reruns = 0
        self.escalated_reruns = 0
        self.host_path_rows = 0  # flagged rows resolved on the exact host path
        # The JAX bank's tier switch (module docstring), read once here.
        self.kernel_tier = os.environ.get("APD_PALLAS") != "0"
        # Staging buffers by (dtype, B, S), recycled at collect time.
        self._staging: dict[tuple[np.dtype, int, int], list[NDArray[Any]]] = {}
        # A scan class's host payload rows and their events (RowPayloads)
        # by (dtype, B, total), recycled at collect time.
        self._row_payloads: dict[tuple[torch.dtype, int, int], list[tuple[torch.Tensor, list]]] = {}
        # Captured class steps (models/captured.py): the default on a CUDA
        # device; ``capture`` may be switched off and on again between
        # calls, to hold the two against each other.
        self.graphs = StepGraphs()
        # A flagged row's wide rerun, captured as the class steps are, one
        # graph per clip and lane width that has flagged, in a pool apart
        # from theirs (:meth:`_row_rerun_step`).
        self.rerun_graphs = StepGraphs()
        self.capture = self.device.type == "cuda" if capture is None else bool(capture)
        if self.capture:
            self.graphs.check(self.device)

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
            # survivors (full_len // m + 1); k_detect sizes the wide rerun
            # and enters the lean tier only as min(_SMALL_TIER, k_detect)
            # greedy lanes. A marker hit floods |corr| with a comb of up to
            # 2 m f / sr candidates, so marker groups size k_detect for
            # about 8 hits: hit-bearing rows then rerun on the device.
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
        # Class geometries, and the single-row consts of the row rerun
        # built on first use.
        self._shared_geoms = shared_geoms
        self._row_consts: dict[tuple[int, int, int], tuple] = {}
        # Each class's host row for a rerun's section (:meth:`_rerun_section`).
        self._rerun_rows: dict[int, torch.Tensor] = {}
        # Replicas of a class's constants on other devices, built on first
        # use (the shards of a device mesh).
        self._replica_loud: dict[tuple[int, torch.device], LoudnessConsts] = {}
        self._replica_groups: dict[tuple[int, torch.device], tuple] = {}

    def replica_loud(self, sw: int, device: "torch.device | str") -> LoudnessConsts:
        """The loudness constants of class ``sw`` on ``device`` (all that a
        bank shard needs of the whole class: its group constants are its own
        slice, and the full groups never go to its device)."""
        key = (sw, canonical_device(device))
        if key not in self._replica_loud:
            self._replica_loud[key] = consts_to_device(self.classes[sw]["loud"], key[1])
        return self._replica_loud[key]

    def replica(self, sw: int, device: "torch.device | str") -> tuple[LoudnessConsts, tuple]:
        """(loud, group_consts) of class ``sw`` on ``device``: the bank's own
        tensors on the bank's own device, else a copy made once and kept."""
        key = (sw, canonical_device(device))
        if key not in self._replica_groups:
            self._replica_groups[key] = tuple(
                (consts_to_device(g.corr, key[1]), consts_to_device(g.verify, key[1]))
                for g in self.classes[sw]["groups"]
            )
        return self.replica_loud(sw, device), self._replica_groups[key]

    # ── Sections ──

    def _section_parts(
        self,
        sw: int,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> tuple[NDArray[Any], ...]:
        """A chunk's section as its parts in order: the last ``sw`` seconds
        of the previous chunk (the overlap-save lookback; reference:
        audio_pattern_detector.py:400-412), then the chunk. A mixed
        int16/f32 pair decodes the int16 side first."""
        if previous_chunk is None:
            return (chunk,)
        tail = previous_chunk[int(-sw * self.sample_rate):]
        if tail.dtype != chunk.dtype:
            if tail.dtype == np.int16:
                tail = native.pcm16_to_f32_mono(tail)
            if chunk.dtype == np.int16:
                chunk = native.pcm16_to_f32_mono(chunk)
        return (tail, chunk)

    def _raw_section(
        self,
        sw: int,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> NDArray[Any]:
        """The section of :meth:`_section_parts` as one array."""
        parts = self._section_parts(sw, chunk, previous_chunk)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    _POOL_BOUND = 4  # buffers kept a key: pipeline depth plus margin, as in JAX

    def _pool_get(self, dtype: type, b: int, s: int) -> NDArray[Any]:
        """A recycled staging buffer of (B, S) ``dtype``, else a new one:
        pinned on a CUDA bank (a numpy view of a pinned host tensor, which
        it keeps alive), plain on the CPU."""
        pooled = self._staging.get((np.dtype(dtype), b, s))
        if pooled:
            return pooled.pop()
        if self.device.type == "cuda":
            torch_dtype = torch.int16 if dtype == np.int16 else torch.float32
            return torch.empty((b, s), dtype=torch_dtype, pin_memory=True).numpy()
        return np.empty((b, s), dtype=dtype)

    def _pool_put(self, buf: NDArray[Any]) -> None:
        """Return a staging buffer whose dispatch has been collected."""
        pooled = self._staging.setdefault((buf.dtype, *buf.shape), [])
        if len(pooled) < self._POOL_BOUND:
            pooled.append(buf)

    def _row_event(self) -> "Callable[[], Any] | None":
        """The event a scan row's copy back records, None where a scan
        class's payload comes back whole (off a card)."""
        return torch.cuda.Event if self.device.type == "cuda" else None

    def _rows_get(self, out: torch.Tensor, b: int, event: "Callable[[], Any]") -> RowPayloads:
        """A :class:`RowPayloads` for a class of ``b`` rows of ``out``'s
        size and dtype: a recycled host buffer (pinned on a card) and its
        ``b`` events, else new ones."""
        key = (out.dtype, b, out.numel())
        pooled = self._row_payloads.get(key)
        if pooled:
            return RowPayloads(*pooled.pop())
        host = torch.empty((b, out.numel()), dtype=out.dtype, pin_memory=self.device.type == "cuda")
        return RowPayloads(host, [event() for _ in range(b)])

    def _rows_put(self, handle: RowPayloads) -> None:
        """Return a collected :class:`RowPayloads`' buffer and events."""
        host, events = handle.release()
        pooled = self._row_payloads.setdefault((host.dtype, *host.shape), [])
        if len(pooled) < self._POOL_BOUND:
            pooled.append((host, events))

    def _stage(
        self,
        section_len: int,
        sections: "list[NDArray[Any] | tuple[NDArray[Any], ...]]",
    ) -> tuple[NDArray[Any], list[NDArray[Any]], list[tuple[NDArray[Any], ...]]]:
        """(rows, raws, parts) for the upload of ``sections`` (each an
        array, or its parts in order, as :meth:`_section_parts` gives
        them), with nothing written yet: a (B, S) buffer of the staging
        pool, one row per section, each row's section as a view of its row
        (int16 rows stay int16; a row decoded for an f32 round is f32), and
        each row's parts, which :meth:`_pack_row` writes into it. The
        buffer is int16 when every non-empty part arrived as int16 (half
        the bytes of f32), else f32 with int16 parts decoded on the host,
        so its dtype is known before the first row is packed. The device
        decode of an int16 row is bitwise the host decode, so a row's
        payload does not depend on which form its round took. f32 rows are not tested for lying on the PCM grid:
        a source of 16-bit PCM hands its samples on as int16 (``match.py``'s
        stream wrappers, ``serve``), and the test costs a round more host
        time than the smaller upload saves. The views hold the sections
        until the buffer goes back to the pool, at collect."""
        rows_parts = [s if isinstance(s, tuple) else (s,) for s in sections]
        as_i16 = all(p.dtype == np.int16 or not len(p) for parts in rows_parts for p in parts)
        rows = self._pool_get(np.int16 if as_i16 else np.float32, len(sections), section_len)
        raws = [rows[bi, : sum(len(p) for p in ps)] for bi, ps in enumerate(rows_parts)]
        return rows, raws, rows_parts

    @staticmethod
    def _pack_row(rows: NDArray[Any], bi: int, parts: tuple[NDArray[Any], ...]) -> None:
        """Write row ``bi`` of a staging buffer part by part and zero only
        its tail past the row's length, so a recycled buffer keeps nothing
        of an earlier round and no section is assembled anywhere else."""
        o = 0
        for p in parts:
            if rows.dtype != np.int16 and p.dtype == np.int16:
                p = native.pcm16_to_f32_mono(p)
            rows[bi, o : o + len(p)] = p
            o += len(p)
        rows[bi, o:] = 0

    def _staged_sections(
        self,
        section_len: int,
        parts: "list[NDArray[Any] | tuple[NDArray[Any], ...]]",
    ) -> tuple[NDArray[Any], list[NDArray[Any]]]:
        """(rows, raws) of :meth:`_stage` with every row packed: the
        whole round staged before it goes up at once."""
        rows, raws, rows_parts = self._stage(section_len, parts)
        for bi, ps in enumerate(rows_parts):
            self._pack_row(rows, bi, ps)
        return rows, raws

    def program(
        self,
        sw: int,
        device: "torch.device | str",
        rows: "int | None" = None,
        dtype: torch.dtype = torch.float32,
        consts: "tuple[LoudnessConsts, tuple] | None" = None,
        scan=candidate_scan,
        fused: bool = True,
    ) -> "CapturedStep | SplitRound | EagerStep":
        """The class step of class ``sw`` on ``device`` under the bank's
        switches, as an object to ``load(section, n_valid)`` and ``run()``:
        a (B, S) batch of ``rows`` sections with a (B,) length tensor, or
        one (S,) section with an int length (``rows=None``), in the upload
        ``dtype``. With ``capture`` on, the captured step of its key
        (``models/captured.py``), in the lean and the general-plateau tier
        (``height_min <= 0``) alike; else the eager step. For more rows
        than :data:`GRAPH_ROWS`, a :class:`SplitRound` of steps of that
        width, captured or eager as above: no width falls back to the eager
        step, and both run a round in the same W-row steps. ``consts``
        replaces the class's own (loud, group_consts): a replica on another
        device, or a bank shard's slice. ``scan`` as in :func:`class_step`;
        ``fused=False`` returns each group's payload."""
        cls = self.classes[sw]
        loud, group_consts = consts if consts is not None else (
            cls["loud"], tuple((g.corr, g.verify) for g in cls["groups"])
        )
        fn = functools.partial(
            class_step_fused if fused else class_step, loud=loud, group_consts=group_consts,
            metas=self._metas[sw], height_min=self.height_min, scan=scan,
            kernel_tier=self.kernel_tier,
        )
        device = canonical_device(device)
        rows = 1 if rows is None else rows
        width = min(rows, GRAPH_ROWS)
        if not self.capture:
            step = EagerStep(fn, device, width)
        else:
            key = StepKey(
                device=device, sw=sw, rows=width, dtype=dtype, fused=fused, scan=scan,
                general=self.height_min <= 0, kernel_tier=self.kernel_tier,
                marker_gemm=_marker_gemm_enabled() and device.type != "cuda",
                consts=(id(loud), *(id(c) for pair in group_consts for c in pair)),
            )
            step = self.graphs.get(key, fn, (loud, group_consts), cls["section_len"])
        return step if width == rows else SplitRound(step, rows, width, fused)

    def step(
        self,
        sw: int,
        section: torch.Tensor,
        n_valid: "int | torch.Tensor",
        consts: "tuple[LoudnessConsts, tuple] | None" = None,
        scan=candidate_scan,
        fused: bool = True,
    ) -> "torch.Tensor | list[torch.Tensor]":
        """The class step of class ``sw`` under the bank's switches on
        ``section``'s device: the fused payload of one section (S,) with its
        int length, or (B, total) payloads of a (B, S) batch with a (B,)
        length tensor (``fused=False``: each group's payload, as
        :func:`class_step` returns them). Sections may be int16 (they
        decode in the step). ``consts``, ``scan`` as in :meth:`program`."""
        batched = section.dim() == 2
        prog = self.program(
            sw, section.device, section.shape[0] if batched else None, section.dtype, consts,
            scan, fused,
        )
        prog.load(section, n_valid)
        out = prog.run()
        return out if batched or not fused else out.reshape(-1)

    # ── Single-chunk dispatch ──

    def dispatch_chunk(
        self,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> list[tuple[int, PayloadHandle, NDArray[Any], NDArray[Any]]]:
        """Enqueue one stream chunk; returns per-class records (class,
        payload, raw section, staging buffer)."""
        dispatched = []
        for sw, cls in self.classes.items():
            staged, (raw,) = self._staged_sections(
                cls["section_len"], [self._section_parts(sw, chunk, previous_chunk)])
            rows = upload_rows(staged, self.device)
            dispatched.append((sw, PayloadHandle(self.step(sw, rows[0], len(raw))), raw, staged))
        return dispatched

    def collect_chunk(
        self,
        dispatched: list[tuple[int, Any, NDArray[Any], NDArray[Any]]],
        padded_rows: "dict[int, tuple[int, ...]] | None" = None,
    ) -> dict[str, list[int]]:
        """Wait for a dispatched chunk; accepted 'full'-index peak positions
        per clip name (ascending). ``padded_rows`` maps a class's sliding
        window to its per-group payload row counts where they were padded
        (the bank-sharded dispatch)."""
        results: dict[str, list[int]] = {}
        for sw, handle, raw, staged in dispatched:
            if RECORDER.on:
                RECORDER.count("rows_decoded_early", 0)
            rows = padded_rows.get(sw) if padded_rows else None
            results.update(self._collect_rows(sw, handle.numpy()[None], [raw], rows)[0])
            self._pool_put(staged)
        return results

    def process_chunk(
        self,
        chunk: NDArray[Any],
        previous_chunk: "NDArray[Any] | None",
    ) -> dict[str, list[int]]:
        return self.collect_chunk(self.dispatch_chunk(chunk, previous_chunk))

    # ── Batched dispatch ──

    def process_chunks_batch(
        self,
        chunks: list[NDArray[Any]],
        previous_tail: "NDArray[Any] | None",
        mode: str = "vmap",
    ) -> list[dict[str, list[int]]]:
        """Process consecutive stream chunks as one batch: ``chunks[0]``'s
        lookback is ``previous_tail`` (None at the stream head), later
        chunks take theirs from their predecessor. Per-chunk result dicts,
        as :meth:`process_chunk` returns them. ``mode`` as in
        :meth:`dispatch_chunks_batch`; identical results."""
        return self.collect_chunks_batch(
            self.dispatch_chunks_batch(chunks, previous_tail, mode)
        )

    def dispatch_chunks_batch(
        self,
        chunks: list[NDArray[Any]],
        previous_tail: "NDArray[Any] | None",
        mode: str = "vmap",
        prev_tails: "list[NDArray[Any] | None] | None" = None,
        sharding: Any = None,
    ) -> list[tuple[int, "PayloadHandle | StitchedPayload", list[NDArray[Any]], int, NDArray[Any]]]:
        """Enqueue a chunk batch. By default the chunks are consecutive
        (chunk i's lookback is chunk i-1, ``previous_tail`` seeding the
        first); ``prev_tails`` (one per chunk, None = no lookback) makes
        the rows independent streams, the multi-stream serving path
        (models/multistream.py). Each row keeps its own length, so a first
        chunk, a short final chunk and a zero-length idle row share a
        batch.

        ``mode`` is an execution schedule; sections are assembled on the
        host either way and no state crosses rows, so both modes serve
        consecutive chunks and independent streams with identical results.
        "scan" runs the rows one after another on the current stream (one
        chunk's memory), each row staged, copied up and launched before
        the next is staged (:meth:`_dispatch_rows`); "vmap" runs every row
        through one set of launches per class (B times the memory), so the
        whole round is staged and copied up first (:meth:`_dispatch_round`).
        The payload copies back once per class in "vmap", and on a card
        once a row in "scan" (a :class:`RowPayloads`, which collect decodes
        as its rows finish); off a card a scan class's rows are joined and
        copied back once.

        ``sharding`` (an object with a ``mesh`` and the name of its row
        ``axis``, e.g. ``parallel.mesh.RowSharding``) spreads a "vmap" round
        over a device mesh: the rows split contiguously over the axis, each
        shard runs on its own device against a replica of the class's
        constants, every shard is enqueued before any is awaited, and the
        payload reads back in row order. B must be divisible by the axis.

        On a mesh that spans processes (``parallel/mesh.py``) each process
        passes only its own rows, they split over its own cells of the
        axis, and collect returns only them: the JAX bank's ``_place`` and
        ``_host_rows``, with no row data crossing processes. The caller
        keeps the processes in lockstep (``MultiStreamSession.dispatch``)."""
        if mode not in ("vmap", "scan"):
            raise ValueError(f"mode must be 'vmap' or 'scan', got {mode!r}")
        if sharding is not None and mode != "vmap":
            raise ValueError("sharding requires mode='vmap'")
        if prev_tails is not None and len(prev_tails) != len(chunks):
            raise ValueError(
                f"prev_tails has {len(prev_tails)} entries for {len(chunks)} chunks"
            )
        if not chunks:
            return []
        b = len(chunks)
        if prev_tails is None:
            prev_tails = [previous_tail, *chunks[:-1]]
        shards: "list[tuple[torch.device, int, int]]"
        if sharding is None:
            shards = [(self.device, 0, b)]
        else:
            mesh, axis = sharding.mesh, sharding.axis
            # On a mesh that spans processes the rows are this process's
            # own, and they go to its own cells of the axis.
            own = [i for i in range(mesh.shape[axis]) if mesh.is_local(**{axis: i})]
            if len(own) * mesh.process_count != mesh.shape[axis]:
                raise ValueError(
                    f"the mesh's {axis!r} axis ({mesh.shape[axis]}) must split evenly "
                    f"over the {mesh.process_count} processes"
                )
            n = len(own)
            if b % n:
                raise ValueError(
                    f"a round of {b} rows does not divide over the mesh's "
                    f"{axis!r} axis ({n})"
                )
            per = b // n
            shards = [
                (mesh.device_at(**{axis: i}), j * per, (j + 1) * per) for j, i in enumerate(own)
            ]
        dispatched = []
        clock, ns = time.perf_counter_ns, 1e-9
        t0 = clock()
        for sw, cls in self.classes.items():
            parts = [self._section_parts(sw, chunk, prev) for chunk, prev in zip(chunks, prev_tails)]
            t1 = clock()
            dispatch_phase_seconds["sections"] += (t1 - t0) * ns
            if RECORDER.on:
                RECORDER.add("bank.sections", t0, t1, b, sw)
            handle: "PayloadHandle | RowPayloads | StitchedPayload"
            if mode == "scan":
                host_rows, raws, handle, t4 = self._dispatch_rows(sw, cls["section_len"], parts, t1)
            else:
                host_rows, raws, payloads, t4 = self._dispatch_round(
                    sw, cls["section_len"], parts, shards, sharding, t1)
                handles = [PayloadHandle(p) for p in payloads]
                handle = handles[0] if sharding is None else StitchedPayload(handles, np.concatenate)
            dispatched.append((sw, handle, raws, b, host_rows))
            t0 = clock()
            dispatch_phase_seconds["prefetch"] += (t0 - t4) * ns
            if RECORDER.on:
                RECORDER.add("bank.prefetch", t4, t0, b, sw)
        return dispatched

    def _dispatch_rows(
        self, sw: int, section_len: int, parts: "list[tuple[NDArray[Any], ...]]", t: int,
    ) -> tuple[NDArray[Any], list[NDArray[Any]], "RowPayloads | PayloadHandle", int]:
        """The "scan" schedule of one class, from clock reading ``t``: row
        after row, each row is packed into its row of the staging buffer,
        copied up on the current stream and run (the B = 1 graph's load
        and replay, or the eager single-section step) before the next is
        packed, so the device runs a row while the host packs the next.
        The dtype is the round's, chosen before the first row is packed,
        and the rows, lengths and step are the whole-round staging's, so
        the payload is too, bit for bit. On a card each row's output goes
        straight from the step's static output into its row of a
        :class:`RowPayloads` behind the row's step (no device copy of it);
        off a card the rows' payloads are joined into one
        :class:`PayloadHandle`. Returns (staging buffer, raws, payload
        handle, the last clock reading). Each row adds to the phases
        ``pack``, ``upload`` and ``launch`` and, while recording, is the
        spans ``bank.pack``, ``bank.upload`` and ``bank.launch``
        (attributes: 1 row, window; the copy back is in ``bank.launch``);
        the rows packed after the class's first launch count as
        ``overlapped_rows``."""
        clock, ns = time.perf_counter_ns, 1e-9
        host_rows, raws, rows_parts = self._stage(section_len, parts)
        prog = self.program(
            sw, self.device, dtype=torch.int16 if host_rows.dtype == np.int16 else torch.float32)
        event = self._row_event()
        handle: "RowPayloads | None" = None
        payloads = []
        overlapped = 0
        for bi, ps in enumerate(rows_parts):
            overlapped += bi > 0
            self._pack_row(host_rows, bi, ps)
            t2 = clock()
            row = upload_rows(host_rows[bi], self.device)
            t3 = clock()
            launch = -1
            if RECORDER.on:
                RECORDER.add("bank.pack", t, t2, 1, sw)
                RECORDER.add("bank.upload", t2, t3, 1, sw)
                launch = RECORDER.open("bank.launch", t3, a=1, b=sw)
            with device_guard(prog.device):
                prog.load(row, len(raws[bi]))
                if event is None:
                    payloads.append(prog.run().reshape(-1))
                else:
                    out = prog.run(owned=False)
                    if handle is None:
                        handle = self._rows_get(out, len(rows_parts), event)
                    handle.copy_row(bi, out)
            t4 = clock()
            if launch >= 0:
                RECORDER.close(launch, t4)
            dispatch_phase_seconds["pack"] += (t2 - t) * ns
            dispatch_phase_seconds["upload"] += (t3 - t2) * ns
            dispatch_phase_seconds["launch"] += (t4 - t3) * ns
            t = t4
        if RECORDER.on:
            RECORDER.count("overlapped_rows", overlapped)
        return host_rows, raws, PayloadHandle(torch.stack(payloads)) if handle is None else handle, t

    def _dispatch_round(
        self,
        sw: int,
        section_len: int,
        parts: "list[tuple[NDArray[Any], ...]]",
        shards: "list[tuple[torch.device, int, int]]",
        sharding: Any,
        t1: int,
    ) -> tuple[NDArray[Any], list[NDArray[Any]], list[torch.Tensor], int]:
        """The "vmap" schedule of one class, from clock reading ``t1``: the
        whole round packed, then uploaded once per shard, then one set of
        launches per shard, since each needs every one of its rows. Returns
        (staging buffer, raws, each shard's payload, the last clock
        reading); each phase and, while recording, each span ``bank.*``
        once (attributes: rows, window)."""
        clock, ns = time.perf_counter_ns, 1e-9
        b = len(parts)
        host_rows, raws = self._staged_sections(section_len, parts)
        t2 = clock()
        dispatch_phase_seconds["pack"] += (t2 - t1) * ns
        n_valids = torch.tensor([len(raw) for raw in raws], dtype=torch.int32)
        if self.device.type == "cuda":
            # Pinned, so that loading the lengths does not wait for the
            # rounds in flight, as a pageable copy would.
            n_valids = n_valids.pin_memory()
        # The round's rows go up once per shard. Each step then copies its
        # rows and lengths into its inputs just before it runs (two logical
        # shards of one device may share one captured step).
        steps = []
        for dev, lo, hi in shards:
            rows = upload_rows(host_rows[lo:hi], dev)
            consts = None if sharding is None else self.replica(sw, dev)
            steps.append((self.program(sw, dev, hi - lo, rows.dtype, consts), rows,
                          n_valids[lo:hi]))
        t3 = clock()
        dispatch_phase_seconds["upload"] += (t3 - t2) * ns
        launch = -1
        if RECORDER.on:
            RECORDER.add("bank.pack", t1, t2, b, sw)
            RECORDER.add("bank.upload", t2, t3, b, sw)
            RECORDER.count("overlapped_rows", 0)
            launch = RECORDER.open("bank.launch", t3, a=b, b=sw)
        payloads = []
        for prog, rows, n_valid in steps:
            with device_guard(prog.device):
                prog.load(rows, n_valid)
                payloads.append(prog.run())
        t4 = clock()
        dispatch_phase_seconds["launch"] += (t4 - t3) * ns
        if launch >= 0:
            RECORDER.close(launch, t4)
        return host_rows, raws, payloads, t4

    def collect_chunks_batch(
        self,
        dispatched: list[tuple[int, Any, list[NDArray[Any]], int, NDArray[Any]]],
    ) -> list[dict[str, list[int]]]:
        """Wait for a dispatched batch; per-chunk result dicts. The classes
        are collected in turn. A class whose payload comes back row by row
        (:class:`RowPayloads`) is decoded in batches: every row already on
        the host at once, then, after a wait for the next row, every row
        finished by then, and so on to its last row; its flagged rows are
        resolved after its last batch, in the order the whole class's
        decode gives them. Where its handle has ``on_final`` (a caller sets
        it on its round's last class), each batch's unflagged rows are
        handed to it once decoded, then the flagged rows once resolved.
        Each class's staging buffer (and a row-wise payload's host buffer)
        goes back to the pool once its payload (every shard's) is on the
        host and its flagged rows, which read the raw sections in it, are
        resolved. While recording, the
        counter ``rows_decoded_early`` adds a class's rows whose decode
        began before its last row had finished on the card (0 for a
        payload that comes back whole), so that it is present for every
        collect."""
        if not dispatched:
            return []
        results: list[dict[str, list[int]]] = [dict() for _ in range(dispatched[0][3])]
        for sw, handle, raws, _b, staged in dispatched:
            if isinstance(handle, RowPayloads):
                self._collect_row_batches(sw, handle, raws, results)
                self._rows_put(handle)
            else:
                if RECORDER.on:
                    RECORDER.count("rows_decoded_early", 0)
                for bi, res in enumerate(self._collect_rows(sw, handle.numpy(), raws)):
                    results[bi].update(res)
            self._pool_put(staged)
        return results

    def _collect_row_batches(
        self,
        sw: int,
        handle: RowPayloads,
        raws: list[NDArray[Any]],
        results: list[dict[str, list[int]]],
    ) -> None:
        """:meth:`collect_chunks_batch` of one row-wise class, into the
        round's ``results``."""
        on_final = handle.on_final
        b = len(raws)
        flagged: list[list[tuple[int, int, bool]]] = [[] for _ in self.classes[sw]["groups"]]
        early = lo = 0
        while lo < b:
            hi = handle.finished()
            if hi <= lo or hi == b:
                # Wait for the next row; the class's last row is always
                # waited for too (at once where a poll found it), so that
                # its payload on the host ends a ``collect.wait``, as a
                # whole payload's does.
                hi = handle.wait(lo if hi <= lo else b - 1)
            if hi < b:
                early += hi - lo
            decoded, batch_flagged = self._unpack_rows(sw, handle.rows(lo, hi), hi - lo, lo=lo)
            for bi, res in enumerate(decoded, lo):
                results[bi].update(res)
            for acc, got in zip(flagged, batch_flagged):
                acc.extend(got)
            if on_final is not None:
                held = {bi for got in batch_flagged for bi, _, _ in got}
                final = [bi for bi in range(lo, hi) if bi not in held]
                if final:
                    on_final(final, results)
            lo = hi
        if RECORDER.on:
            RECORDER.count("rows_decoded_early", early)
        resolved = self._resolve_rows(sw, flagged, raws, results)
        if on_final is not None and resolved:
            on_final(resolved, results)

    def _collect_rows(
        self,
        sw: int,
        flat_np: NDArray[np.float32],
        raws: list[NDArray[Any]],
        rows: "tuple[int, ...] | None" = None,
    ) -> list[dict[str, list[int]]]:
        """Unpack a (B, total) class payload (:meth:`_unpack_rows`); flagged
        rows of each section go to :meth:`resolve_flagged_rows`. ``rows``
        as in :func:`_split_fused`."""
        results, flagged = self._unpack_rows(sw, flat_np, len(raws), rows)
        self._resolve_rows(sw, flagged, raws, results)
        return results

    def _resolve_rows(
        self,
        sw: int,
        flagged: list[list[tuple[int, int, bool]]],
        raws: list[NDArray[Any]],
        results: list[dict[str, list[int]]],
    ) -> list[int]:
        """Resolve each group's flagged (row, clip, host flag) triples
        (:meth:`_unpack_rows`) a section at a time, rows in the order the
        groups first flag them, into ``results`` (indexed as ``raws``).
        Returns the rows resolved."""
        groups = self.classes[sw]["groups"]
        flagged_by_bi: dict[int, list[tuple[int, int, bool]]] = {}
        for gi, got in enumerate(flagged):
            for bi, ci, host in got:
                flagged_by_bi.setdefault(bi, []).append((gi, ci, host))
        for bi, flagged_rows in flagged_by_bi.items():
            raw = raws[bi]
            section = native.pcm16_to_f32_mono(raw) if raw.dtype == np.int16 else raw
            for (gi, ci), hits in self.resolve_flagged_rows(sw, flagged_rows, section).items():
                results[bi][groups[gi].names[ci]] = hits
        return list(flagged_by_bi)

    def _unpack_rows(
        self,
        sw: int,
        flat_np: NDArray[np.float32],
        n: int,
        rows: "tuple[int, ...] | None" = None,
        lo: int = 0,
    ) -> tuple[list[dict[str, list[int]]], list[list[tuple[int, int, bool]]]]:
        """Decode the first ``n`` rows of a (B, total) class payload, rows
        ``lo`` to ``lo + n`` of their class: (each row's unflagged clips
        with their accepted positions, and each group's flagged (row,
        clip, host flag) triples, rows counted from the class's first).
        ``rows`` as in :func:`_split_fused`. The flags and selections are
        read as arrays, so Python converts positions only where a row
        selected some: every other unflagged clip gets an empty list.
        While recording, the unpack is the span ``collect.unpack``
        (attributes: rows, window); the counter ``live_groups`` adds the
        (row, group) pairs with a position below the sentinel, those whose
        verify tail ran (a captured lean step's if-node body, one a row in
        the scan schedule), and ``decoded_pairs`` the unflagged (row, clip)
        pairs that selected a position; ``flagged_rows`` is counted here
        too, by 0, so that it is present for every collect, flagged or
        not."""
        groups = self.classes[sw]["groups"]
        flagged: list[list[tuple[int, int, bool]]] = []
        span = RECORDER.open("collect.unpack", a=n, b=sw) if RECORDER.on else -1
        unpacked = []
        for g, packed in zip(groups, _split_fused(flat_np[:n], groups, rows)):
            host_fb, needs_full = group_flags(packed, g.k_verify)
            unpacked.append((g, packed, host_fb, host_fb | needs_full))
        # A row's unflagged clips, each with a fresh empty list, in the
        # groups' order; flagged ones join after resolve_flagged_rows.
        names = [name for g in groups for name in g.names]
        results: list[dict[str, list[int]]] = [
            {name: [] for name, f in zip(names, row) if not f}
            for row in np.concatenate([f for *_, f in unpacked], axis=-1).tolist()
        ]
        for g, packed, host_fb, flags in unpacked:
            k = g.k_verify
            # ``any`` tests the selection lanes ``!= 0``, without a copy.
            live_bi, live_ci = np.nonzero(packed[..., k : 2 * k].any(axis=-1) & ~flags)
            if span >= 0:
                alive = (packed[..., :k] < _BIG).any(axis=(-2, -1))
                RECORDER.count("live_groups", int(np.count_nonzero(alive)))
                RECORDER.count("decoded_pairs", len(live_bi))
                RECORDER.count("flagged_rows", 0)
            for bi, ci in zip(live_bi.tolist(), live_ci.tolist()):
                lanes = packed[bi, ci]
                results[bi][g.names[ci]] = lanes[:k][lanes[k : 2 * k] != 0].astype(np.int32).tolist()
            flag_bi, flag_ci = np.nonzero(flags)
            flagged.append(list(zip((flag_bi + lo).tolist(), flag_ci.tolist(),
                                    host_fb[flag_bi, flag_ci].tolist())))
        if span >= 0:
            RECORDER.close(span)
        return results, flagged

    # ── Flagged rows: the wide rerun ──

    # Lane cap of the first wide rerun. A marker group's comb-sized k_detect
    # (thousands of lanes) prices its top-k and greedy far above what one
    # hit needs; rows whose raw count exceeds the cap come back host-flagged
    # and escalate to the full width, then to the host path.
    _WIDE_RERUN_CAP = 1024
    # Above this many device-flagged rows in one class, one class rerun
    # replaces the per-row launches.
    _ROW_RERUN_MAX = 4

    def _wide_metas(self, sw: int, capped: bool) -> tuple:
        if not capped:
            return self._metas[sw]
        return tuple(
            (kind, m, min(kd, self._WIDE_RERUN_CAP), kv) for kind, m, kd, kv in self._metas[sw]
        )

    def _rerun_section(self, sw: int, raw_section: NDArray[np.float32]) -> torch.Tensor:
        """``raw_section`` zero-padded to its class's length, in a host
        buffer of the class's own that every rerun reuses: pinned on a card,
        so that its copy up is one DMA and a rerun allocates nothing. A
        rerun's copy up is synchronous, so the next one may overwrite it."""
        buf = self._rerun_rows.get(sw)
        if buf is None:
            buf = self._rerun_rows[sw] = torch.empty(
                self.classes[sw]["section_len"], dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        host[: len(raw_section)] = raw_section
        host[len(raw_section) :] = 0
        return buf

    def _full_tier_packed(
        self, sw: int, raw_section: NDArray[np.float32], capped: bool = True
    ) -> list[NDArray[np.float32]]:
        """Re-derive one section through the wide tier for every group of
        the class: per-group (G, 2K+2) payloads."""
        cls = self.classes[sw]
        self.class_reruns += 1
        span = -1
        if RECORDER.on:
            span = RECORDER.open("collect.flagged", a=_route("class" if capped else "escalated"), b=sw)
            RECORDER.count("flagged_rows", 1)
        outs = class_step(
            self._rerun_section(sw, raw_section).to(self.device), len(raw_section), cls["loud"],
            tuple((g.corr, g.verify) for g in cls["groups"]),
            metas=self._wide_metas(sw, capped), height_min=self.height_min, wide=True,
        )
        payloads = [o.cpu().numpy() for o in outs]
        if span >= 0:
            RECORDER.close(span)
        return payloads

    def _row_consts_for(self, sw: int, gi: int, ci: int) -> tuple:
        """Single-row (corr, verify) consts for clip ``ci`` of group ``gi``,
        built once with the class-shared overlap-save geometry, so the row
        is correlated by the same FFT decomposition as the class step."""
        key = (sw, gi, ci)
        if key not in self._row_consts:
            cls = self.classes[sw]
            g = cls["groups"][gi]
            corr_row = build_correlation_bank(
                g.clips_np[ci : ci + 1], g.self_max_np[ci : ci + 1], cls["section_len"],
                self.device, self._shared_geoms[sw], overlap_save=g.corr.num_segments > 1,
            )
            verify_row: "NormalVerifyConsts | MarkerVerifyConsts"
            if g.kind == "marker":
                verify_row = build_marker_verify_consts(
                    g.clip_len, self.sample_rate, np.array([g.tone_freqs[ci]], dtype=np.float64),
                    [g.verification_params[ci]], self.device,
                )
            else:
                verify_row = build_normal_verify_consts(
                    g.corr_clips_np[ci : ci + 1], g.clip_len, self.sample_rate, self.device
                )
            self._row_consts[key] = (corr_row, verify_row)
        return self._row_consts[key]

    def _row_rerun_step(self, sw: int, gi: int, ci: int, kd: int) -> "CapturedStep | EagerStep":
        """The wide tier of clip ``ci`` of group ``gi`` over one section at
        ``kd`` lanes, as an object to ``load(section, n_valid)`` and
        ``run()``: with ``capture`` on, the captured step of its key (B = 1,
        the one-row constants, the lanes), so that a rerun on a round's
        critical path is one graph launch and not the eager step's 160-odd
        launches, one by one; else the eager step. Its graph is made at the
        clip's first flagged row at that width."""
        cls = self.classes[sw]
        g = cls["groups"][gi]
        row = self._row_consts_for(sw, gi, ci)
        fn = functools.partial(
            class_step, loud=cls["loud"], group_consts=(row,),
            metas=((g.kind, g.clip_len, kd, g.k_verify),), height_min=self.height_min, wide=True,
        )
        if not self.capture:
            return EagerStep(fn, self.device)
        key = StepKey(
            device=self.device, sw=sw, rows=1, dtype=torch.float32, fused=False, scan=candidate_scan,
            general=False, kernel_tier=self.kernel_tier,
            marker_gemm=_marker_gemm_enabled() and self.device.type != "cuda",
            consts=(id(cls["loud"]), *(id(c) for c in row)), wide_lanes=(kd,),
        )
        return self.rerun_graphs.get(key, fn, (cls["loud"], (row,)), cls["section_len"])

    def _full_tier_row(
        self, sw: int, gi: int, ci: int, raw_section: NDArray[np.float32], capped: bool = True
    ) -> NDArray[np.float32]:
        """Re-derive one clip row through the wide tier: its packed payload
        (2 k_verify + 2,). A marker hit floods exactly that clip's row, and
        the whole class would cost G times the correlation work. The step is
        :meth:`_row_rerun_step`'s, captured where the bank captures."""
        cls = self.classes[sw]
        g = cls["groups"][gi]
        kd = min(g.k_detect, self._WIDE_RERUN_CAP) if capped else g.k_detect
        self.row_reruns += 1
        span = -1
        if RECORDER.on:
            span = RECORDER.open("collect.flagged", a=_route("row" if capped else "escalated"), b=sw)
            RECORDER.count("flagged_rows", 1)
        step = self._row_rerun_step(sw, gi, ci, kd)
        step.load(self._rerun_section(sw, raw_section), len(raw_section))
        payload = step.run()[0][0].cpu().numpy()
        if span >= 0:
            RECORDER.close(span)
        return payload

    def resolve_flagged_rows(
        self,
        sw: int,
        flagged: "list[tuple[int, int, bool]]",
        raw_section: NDArray[np.float32],
    ) -> dict[tuple[int, int], list[int]]:
        """Resolve the flagged (group, clip) rows of one f32 section exactly.

        ``flagged`` holds (gi, ci, is_host_flag) triples. Host-flagged rows
        take the host path. Device-flagged rows rerun through the wide
        tier at the capped lane width, per row when few and per class when
        many; rows that rerun host-flags escalate to the full k_detect
        width where the group has more lanes than the cap, else go to the
        host path, as do rows the escalated rerun host-flags. Returns
        {(gi, ci): accepted positions}. While recording, each rerun and
        each host-path row is a span ``collect.flagged`` whose first
        attribute is its route's index in :data:`FLAGGED_ROUTES`."""
        groups = self.classes[sw]["groups"]
        out: dict[tuple[int, int], list[int]] = {}
        device_rows = [(gi, ci) for gi, ci, host in flagged if not host]
        host_rows = [(gi, ci) for gi, ci, host in flagged if host]

        def rerun_rows(rows: "list[tuple[int, int]]", capped: bool, on_flag) -> None:
            class_rerun = None
            if len(rows) > self._ROW_RERUN_MAX:
                class_rerun = self._full_tier_packed(sw, raw_section, capped=capped)
            for gi, ci in rows:
                k_verify = groups[gi].k_verify
                if class_rerun is not None:
                    rpos, rsel, rhost, _ = unpack_group(class_rerun[gi][ci], k_verify)
                else:
                    rpos, rsel, rhost, _ = unpack_group(
                        self._full_tier_row(sw, gi, ci, raw_section, capped=capped), k_verify
                    )
                if rhost:
                    on_flag(gi, ci)
                else:
                    out[(gi, ci)] = [int(p) for p in rpos[rsel]]

        escalate: list[tuple[int, int]] = []

        def route_capped_flag(gi: int, ci: int) -> None:
            if groups[gi].k_detect > self._WIDE_RERUN_CAP:
                escalate.append((gi, ci))
            else:
                host_rows.append((gi, ci))

        rerun_rows(device_rows, capped=True, on_flag=route_capped_flag)
        if escalate:
            self.escalated_reruns += len(escalate)
            if RECORDER.on:
                RECORDER.count("flagged_rows", len(escalate))
            rerun_rows(escalate, capped=False, on_flag=lambda gi, ci: host_rows.append((gi, ci)))
        for gi, ci in host_rows:
            out[(gi, ci)] = self._host_fallback(groups[gi], ci, raw_section)
        return out

    def _host_fallback(
        self, g: ClipGroup, ci: int, raw_section: NDArray[np.float32]
    ) -> list[int]:
        """Exact host path for a flagged row."""
        self.host_path_rows += 1
        span = -1
        if RECORDER.on:
            span = RECORDER.open("collect.flagged", a=_route("host"))
            RECORDER.count("flagged_rows", 1)
        hits = hostpath.process_section_host(
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
        if span >= 0:
            RECORDER.close(span)
        return hits


def _split_fused(
    flat: NDArray[np.float32],
    groups: list[ClipGroup],
    rows: "tuple[int, ...] | None" = None,
) -> list[NDArray[np.float32]]:
    """Split a fused payload (..., total) into per-group (..., G, 2K+2)
    views. ``rows`` gives each group's row count in the payload where it
    differs from its clip count (the bank-sharded path pads groups to a
    size its shards divide; padded rows duplicate clip 0 and are sliced
    off here)."""
    out = []
    off = 0
    for gi, g in enumerate(groups):
        gn = len(g.names)
        gr = rows[gi] if rows is not None else gn
        w = 2 * g.k_verify + 2
        blk = flat[..., off : off + gr * w].reshape(*flat.shape[:-1], gr, w)
        out.append(blk[..., :gn, :])
        off += gr * w
    return out


def unpack_group(
    packed: NDArray[np.float32], k_verify: int
) -> tuple[NDArray[np.int32], NDArray[np.bool_], NDArray[np.bool_], NDArray[np.bool_]]:
    """(pos, selected, host_fallback, needs_full_tier) of a packed group
    payload (..., 2K+2); leading batch axes pass through."""
    host_fallback, needs_full = group_flags(packed, k_verify)
    pos = packed[..., :k_verify].astype(np.int32)
    return pos, packed[..., k_verify : 2 * k_verify] != 0, host_fallback, needs_full


def group_flags(
    packed: NDArray[np.float32], k_verify: int
) -> tuple[NDArray[np.bool_], NDArray[np.bool_]]:
    """(host_fallback, needs_full_tier) of a packed group payload
    (..., 2K+2), as :func:`unpack_group` reads them."""
    flag = packed[..., 2 * k_verify]
    return (flag == 1.0) | (packed[..., 2 * k_verify + 1] != 0), flag == 2.0


# ── The class step ──


# Every group tier takes one section's rows or a round's: ``norm`` (S,)
# with ``corr`` (G, L) and an int ``valid_len``, or ``norm`` (B, S) with
# ``corr`` (B * G, L) round-major, a (B * G,) int32 ``valid_len`` and
# ``self_corr_max`` tiled to (B * G,). Row r then reads section r // G and
# the verify constants of clip r % G.


def lean_group_packed(
    norm: torch.Tensor,  # (S,) or (B, S) normalised section
    corr: torch.Tensor,  # (R, L) |correlation|, unnormalised
    valid_len: ValidLen,
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts: "NormalVerifyConsts | MarkerVerifyConsts",
    self_corr_max: torch.Tensor,  # (R,) f32
    scan=candidate_scan,
    branch: "Branch | None" = None,
    loop: "Loop | None" = None,
) -> torch.Tensor:
    """Lean tier of one group: candidate scan, in-program greedy, verify.

    Port of ``_lean_group_packed_pallas``. The scan's block maxima of raw
    |corr| seed the exact greedy; each greedy round re-derives the
    candidate mask on a +-2-halo window in normalised (quotient) space,
    the space every tier compares in, so unflagged rows are bitwise the
    full tier's. The scan's near-collapse flag routes the rows where f32
    division could make the two spaces disagree. ``branch`` as in
    :func:`_lean_tail`; the normal verifier normalises only the windows it
    reads (``verify_normal``'s ``normalise``). The greedy is
    ``ops/lean_greedy.py::lean_greedy``: on a card one kernel launch for
    the group, its rounds inside it; on the CPU the plain version, whose
    rounds ``loop`` runs as a while loop (without it they are unrolled).
    """
    hm = f32(height_min)  # compares as JAX's f32 threshold
    bmax, _count, plateau_min, omax, near = scan(corr, hm * self_corr_max, valid_len)
    denom = torch.maximum(self_corr_max, omax).clamp_min(1e-38)
    k_lanes = min(_SMALL_TIER, k_detect)
    pos, height, overflow = lean_greedy(corr, valid_len, bmax, denom, hm, m, k_lanes, loop)
    needs_full = ~plateau_min & (overflow | near)
    flag = torch.where(plateau_min, 1.0, torch.where(needs_full, 2.0, 0.0))

    return _lean_tail(
        norm, corr, valid_len, kind, m, k_verify, verify_consts, pos, height, flag, k_lanes,
        denom=denom, branch=branch,
    )


def mask_group_packed(
    norm: torch.Tensor,  # (S,) or (B, S) normalised section
    corr: torch.Tensor,  # (R, L) normalised correlation (bank_correlate)
    valid_len: ValidLen,
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts: "NormalVerifyConsts | MarkerVerifyConsts",
    branch: "Branch | None" = None,
    loop: "Loop | None" = None,
) -> torch.Tensor:
    """Mask lean tier of one group (``APD_PALLAS=0``), the lean branch of
    the JAX ``_lean_group_packed``: the short-run candidate mask over the
    normalised correlation, the exact block-wise greedy seeded from it,
    verify. No kernel runs. Flags: 1 = an equal run of 4 or more at the threshold
    (host path), 2 = more than 16 greedy survivors (wide rerun); this tier
    has no near-collapse flag, since it compares in one space only.
    ``branch`` as in :func:`_lean_tail`, ``loop`` as in
    :func:`lean_group_packed`."""
    hm = f32(height_min)
    x = torch.where(
        torch.arange(corr.shape[1], device=corr.device)[None, :] < row_limit(valid_len),
        corr, -math.inf,
    )
    plateau = long_plateau_present(x, hm)
    k_lanes = min(_SMALL_TIER, k_detect)
    scored = torch.where(short_run_local_maxima_mask(x) & (x >= hm), x, -math.inf)
    pos, height, overflow = greedy_survivors_blockwise(scored, m, k_lanes, loop=loop)
    flag = torch.where(plateau, 1.0, torch.where(overflow, 2.0, 0.0))
    return _lean_tail(
        norm, corr, valid_len, kind, m, k_verify, verify_consts, pos, height, flag, k_lanes,
        branch=branch,
    )


def _normalised(corr: torch.Tensor, valid_len: ValidLen, denom: torch.Tensor) -> torch.Tensor:
    """Raw |corr| as ``bank_correlate`` returns it: exact zeros past
    ``valid_len``, divided by ``denom`` = max(self_corr_max, observed max)."""
    in_range = torch.arange(corr.shape[1], device=corr.device)[None, :] < row_limit(valid_len)
    return torch.where(in_range, corr, 0.0) / denom[:, None]


def wide_group_packed(
    norm: torch.Tensor,  # (S,) or (B, S) normalised section
    corr: torch.Tensor,  # (R, L) normalised correlation (bank_correlate)
    valid_len: ValidLen,
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts: "NormalVerifyConsts | MarkerVerifyConsts",
) -> torch.Tensor:
    """Wide tier of one group, the rerun of flag-2 rows: top-k capture at
    the full ``k_detect`` width, the lane greedy, a two-tier verify.

    Port of ``_lean_group_packed(wide=True)``. It compares the same f32
    quotients as the lean tier (``bank_correlate`` divides by the same
    max(self_corr_max, observed max)), so an unflagged row's payload is
    bitwise the lean tier's. A row with more raw candidates than lanes, or
    an equal run of length >= 4 at the threshold, is flagged for the host
    path (flag 1); the wide tier never sets flag 2."""
    hm = f32(height_min)
    idx = torch.arange(corr.shape[1], device=corr.device)[None, :]
    x = torch.where(idx < row_limit(valid_len), corr, -math.inf)
    mask = short_run_local_maxima_mask(x) & (x >= hm)
    host_fallback = (mask.sum(dim=1) > k_detect) | long_plateau_present(x, hm)
    height, pos = topk_sparse(torch.where(mask, x, -math.inf), k_detect)
    return _lean_tail(
        norm, corr, valid_len, kind, m, k_verify, verify_consts, pos, height,
        host_fallback.to(torch.float32), k_detect, wide=True,
    )


def rich_group_packed(
    norm: torch.Tensor,
    corr: torch.Tensor,  # (R, L) |correlation|, unnormalised
    valid_len: ValidLen,
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts: "NormalVerifyConsts | MarkerVerifyConsts",
    self_corr_max: torch.Tensor,
    scan=candidate_scan,
    loop: "Loop | None" = None,
    cond: "Cond | None" = None,
) -> torch.Tensor:
    """General-plateau tier of one group, for ``height_min <= 0``: the
    packed payload of ``_class_step``'s rich branch.

    The short-run mask needs sub-threshold zero runs, so this tier takes
    the general plateau mask, captures ``k_detect`` candidates and runs
    the lane greedy. The candidate scan supplies the observed max that
    normalises the row (bitwise ``bank_correlate``'s normaliser). Raw
    count past ``k_detect`` flags the row for the host path.

    The observed max does not depend on the scan's threshold, and the
    threshold's outputs go unread here, so the scan gets +inf: no finite
    sample reaches it, and the kernel runs none of its per-sample threshold
    tests (``height_min * self_corr_max <= 0`` would send every sample to
    them). ``loop`` and ``cond`` as in :func:`general_group_packed`."""
    no_threshold = torch.full_like(self_corr_max, float("inf"))
    _bmax, _count, _plateau, omax, _near = scan(corr, no_threshold, valid_len)
    corr_n = _normalised(corr, valid_len, torch.maximum(self_corr_max, omax).clamp_min(1e-38))
    return general_group_packed(
        norm, corr_n, valid_len, kind, m, k_detect, k_verify, height_min, verify_consts,
        loop=loop, cond=cond,
    )


def general_group_packed(
    norm: torch.Tensor,
    corr_n: torch.Tensor,  # (R, L) normalised correlation
    valid_len: ValidLen,
    kind: str,
    m: int,
    k_detect: int,
    k_verify: int,
    height_min: float,
    verify_consts: "NormalVerifyConsts | MarkerVerifyConsts",
    loop: "Loop | None" = None,
    cond: "Cond | None" = None,
) -> torch.Tensor:
    """The general-plateau tier on a normalised correlation: the rest of
    :func:`rich_group_packed`, and the whole tier under ``APD_PALLAS=0``,
    where ``bank_correlate`` normalises.

    The lane greedy (:func:`greedy_distance_filter`) is one kernel launch a
    group on a card; on the CPU ``loop`` runs its plain version's while
    loop. On a card each verifier is one launch over every lane; the plain
    versions verify two-tier, ``cond`` picking the tier (a stand-in
    backend's pair of if-nodes, ``models/captured.py``; without it the host
    reads the predicate)."""
    cand, plateau_flag = find_peaks_device_fast(corr_n, valid_len, height_min, m, k_detect, loop)
    half = (2 * m - 1) // 2
    keep = cand.alive & ~(cand.pos + half > row_limit(valid_len) + 5) & ~(cand.pos - half < -5)
    sv = torch.topk(torch.where(keep, -cand.pos, -_BIG), k_verify, dim=1).values
    vpos, valive = -sv, sv > -_BIG
    accept = _verify_accept(kind, norm, corr_n, verify_consts, vpos, valive, two_tier=True,
                            cond=cond)
    return _pack(vpos, valive & accept, cand.overflow | plateau_flag, keep.sum(dim=1) > k_verify)


def _two_tier_accept(verify_accept, vpos: torch.Tensor, valive: torch.Tensor,
                     cond: "Cond | None" = None) -> torch.Tensor:
    """The plain versions' two-tier verify: only the first _SMALL_TIER
    lanes when every row's live lanes fit there (compaction puts them
    first), else every lane, _SMALL_TIER lanes at a time; bitwise the same
    accept bits either way, since each lane's verdict reads only its own
    window. ``cond`` (by default :func:`host_cond`, one host sync) picks the
    branch; each branch writes the whole of ``accept``, allocated before
    it. The plain versions make every lane's windows, so a branch's working
    set is one block's: the full-width verify of a 16-row flagship round
    would hold gigabytes of them."""
    kv = vpos.shape[1]
    small_fits = valive.sum(dim=1).amax() <= _SMALL_TIER
    accept = torch.empty_like(valive)

    def block(lo: int, n: int) -> None:
        lanes = slice(lo, lo + n)
        accept[:, lanes] = verify_accept(vpos[:, lanes], valive[:, lanes])

    def small_tier() -> None:
        block(0, _SMALL_TIER)
        accept[:, _SMALL_TIER:] = False

    def every_lane() -> None:
        for lo in range(0, kv, _SMALL_TIER):
            block(lo, _SMALL_TIER)

    (cond or host_cond)(small_fits, small_tier, every_lane)
    return accept


def _verify_accept(kind, norm, corr, verify_consts, vpos, valive, two_tier: bool,
                   cond: "Cond | None" = None, normalise=None) -> torch.Tensor:
    """Accept bits of the group's lanes: the marker verifier reads the
    section, the normal one the correlation (raw, with ``normalise``, as
    :func:`verify_normal` takes it)."""
    def verify_accept(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        if kind == "marker":
            return verify_marker(norm, p, a, verify_consts)
        return verify_normal(corr, p, a, verify_consts, normalise)[0]

    # On a card each verifier's kernel computes only live lanes and makes
    # no array of their windows: every lane in one launch, with no cond.
    if two_tier and vpos.shape[1] > _SMALL_TIER and not vpos.is_cuda:
        return _two_tier_accept(verify_accept, vpos, valive, cond)
    return verify_accept(vpos, valive)


def _pack(vpos, selected, flag, verify_overflow) -> torch.Tensor:
    """(G, 2K+2) f32 payload: positions, selected, flag, verify overflow."""
    return torch.cat(
        [
            vpos.to(torch.float32),
            selected.to(torch.float32),
            flag[:, None].to(torch.float32),
            verify_overflow[:, None].to(torch.float32),
        ],
        dim=1,
    )


def _lean_tail(
    norm, corr, valid_len, kind, m, k_verify, verify_consts, pos, height, flag, k_lanes,
    wide=False, denom=None, branch=None,
) -> torch.Tensor:
    """[Lane greedy ->] bounds -> compact ascending -> verify -> packed
    (G, 2K+2) payload. ``corr`` is the normalised correlation, or raw
    |corr| with its normaliser ``denom``. In the lean tier the lanes
    already are the greedy survivors; ``wide`` lanes are raw top-k
    candidates, filtered here, verified two-tier.

    ``branch(pred, body)`` (a captured lean step; ``models/captured.py``)
    runs the verify only where the 0-d device tensor ``pred``, "some lane
    of the group is live", holds at run time, into ``accept`` zeroed
    before it: the JAX ``lax.cond``. Without a live lane ``sel = valive &
    accept`` is zero whatever the verify returns, and nothing else reads
    it, so the payload is the same either way. Without ``branch`` the
    verify always runs."""
    keep = torch.isfinite(height)
    if wide:
        keep = greedy_distance_filter(PeakCandidates(pos, height, keep, flag != 0), m)
    # Candidate bound checks (reference: audio_pattern_detector.py:531-546).
    half = (2 * m - 1) // 2
    keep = keep & ~(pos + half > row_limit(valid_len) + 5) & ~(pos - half < -5)
    kv = min(k_verify, k_lanes)
    sv = torch.topk(torch.where(keep, -pos, -_BIG), kv, dim=1).values  # live values distinct
    vpos = -sv
    valive = sv > -_BIG

    def verify() -> torch.Tensor:
        return _verify_accept(kind, norm, corr, verify_consts, vpos, valive, two_tier=wide,
                              normalise=None if denom is None else (valid_len, denom))

    if branch is None:
        accept = verify()
    else:
        accept = torch.zeros_like(valive)
        branch(valive.any(), lambda: accept.copy_(verify()))
    if kv < k_verify:
        pad = k_verify - kv
        vpos = F.pad(vpos, (0, pad), value=_BIG)
        valive = F.pad(valive, (0, pad))
        accept = F.pad(accept, (0, pad))
    return _pack(vpos, valive & accept, flag, keep.sum(dim=1) > kv)


def class_step(
    section: torch.Tensor,  # (S,) f32, or (B, S) for a round of B rows
    n_valid: "int | torch.Tensor",  # int, or (B,) int32 on section's device
    loud: LoudnessConsts,
    group_consts: tuple,
    *,
    metas: tuple,
    height_min: float,
    scan=candidate_scan,
    wide: bool = False,
    kernel_tier: bool = True,
    branch: "Branch | None" = None,
    loop: "Loop | None" = None,
    cond: "Cond | None" = None,
) -> list[torch.Tensor]:
    """One sliding-window class over one section, or over the B sections
    of a round in one set of launches: packed payload per group, (G, 2K+2)
    or round-major (B * G, 2K+2).

    The tier follows ``_class_step``: ``wide`` runs the rerun tier
    (:func:`wide_group_packed`); otherwise ``height_min > 0`` runs the lean
    tier and ``height_min <= 0`` the general-plateau tier. ``scan`` is the
    candidate scan (the kernel wrapper by default; the plain version to
    compare against it on the same device). A batch folds into the clip
    axis after the correlation, so each group's scan is one launch over
    B * G rows with per-row lengths.

    ``kernel_tier=False`` (the bank's ``APD_PALLAS=0``) runs the mask tiers
    (:func:`mask_group_packed`, :func:`general_group_packed`), which read the
    normalised correlation and launch no candidate scan (the general tier's
    lane greedy stays a kernel, as the JAX lane greedy is XLA in both).

    ``branch`` reaches the lean tiers' verify tail (:func:`_lean_tail`); the
    wide and general-plateau tiers verify unconditionally, as in JAX.
    ``loop`` reaches the lean tiers' block-wise greedy (a while loop over
    its rounds; without it they are unrolled) and the general-plateau
    tier's lane greedy (without it, host loops) where they run their plain
    versions: the mask tier, and the CPU (the kernels need neither);
    ``cond`` reaches that tier's two-tier verify
    (:func:`general_group_packed`). The wide tier takes neither."""
    batched = section.dim() == 2
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

    # The kernel tier reads raw |corr| (the scan derives the observed max);
    # the mask tiers and the wide rerun read it normalised.
    correlate = bank_correlate_abs if kernel_tier and not wide else bank_correlate
    outs = []
    for (kind, m, k_detect, k_verify), (corr_consts, verify_consts) in zip(metas, group_consts):
        corr, valid_len = correlate(norm, n_valid, corr_consts, shared_spec)
        self_corr_max = corr_consts.self_corr_max
        if batched:
            b, g, l = corr.shape
            corr = corr.reshape(b * g, l)
            # Round-major, one length per row: a copy, so that one section's
            # lengths (B = 1) are not a stride-0 view the kernel refuses.
            valid_len = valid_len.to(torch.int32)[:, None].expand(b, g).reshape(b * g)
            valid_len = valid_len.contiguous()
            self_corr_max = self_corr_max.repeat(b)
        args = (norm, corr, valid_len, kind, m, k_detect, k_verify, height_min, verify_consts)
        if wide:
            outs.append(wide_group_packed(*args))
        elif not kernel_tier:
            outs.append(
                mask_group_packed(*args, branch=branch, loop=loop) if height_min > 0
                else general_group_packed(*args, loop=loop, cond=cond)
            )
        elif height_min > 0:
            outs.append(lean_group_packed(*args, self_corr_max, scan, branch=branch, loop=loop))
        else:
            outs.append(rich_group_packed(*args, self_corr_max, scan, loop=loop, cond=cond))
    return outs


def class_step_fused(section, n_valid, loud, group_consts, *, metas, height_min, scan=candidate_scan,
                     kernel_tier=True, branch=None, loop=None, cond=None):
    """:func:`class_step` with every group's payload flattened into one
    vector per section: (total,), or (B, total) for a batch."""
    outs = class_step(
        section, n_valid, loud, group_consts, metas=metas, height_min=height_min, scan=scan,
        kernel_tier=kernel_tier, branch=branch, loop=loop, cond=cond,
    )
    return torch.cat([o.reshape(*section.shape[:-1], -1) for o in outs], dim=-1)
