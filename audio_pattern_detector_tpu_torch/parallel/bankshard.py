"""Bank sharding: the clip bank distributed across devices (TP analogue).

Port of audio_pattern_detector_tpu/parallel/bankshard.py. The clip bank is
the framework's "model": precomputed conjugate spectra (G, N//2+1),
self-correlation maxima and verification constants. When it outgrows one
device, or to cut per-chunk latency, the bank's leading (G) axis splits
across a mesh axis.

Correlation against a *replicated* section is embarrassingly parallel in
G: every device correlates the shared section against its clip shard and
verifies its own candidates, with no cross-device traffic until the
(kilobyte-sized) payloads are stitched on the host. Here that is explicit:
each shard's constants are slices of the G-leading tensors placed on the
shard's device, the controller uploads the section to every device and
enqueues each shard's class step under that device's guard, and the
candidate-scan kernel stays on (each shard launches it on its own rows).

The JAX module's ``group_spec_tree`` builds ``shard_map`` partition specs;
it is plumbing of that API and has no counterpart here.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import numpy as np
import torch
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.models.bank import (
    PatternBank,
    PayloadHandle,
    StitchedPayload,
)
from audio_pattern_detector_tpu_torch.ops.consts import consts_to_device
from audio_pattern_detector_tpu_torch.ops.correlate import CorrelationBankConsts
from audio_pattern_detector_tpu_torch.ops.devices import canonical_device, device_guard
from audio_pattern_detector_tpu_torch.ops.packing import as_f32, upload_rows
from audio_pattern_detector_tpu_torch.ops.verify import MarkerVerifyConsts, NormalVerifyConsts
from audio_pattern_detector_tpu_torch.parallel.mesh import Mesh

# The tensors whose leading axis is the clip axis G; everything else of a
# group's constants is shared structure.
_CORR_G_FIELDS = ("bank_rfft_conj", "self_corr_max")
_NORMAL_G_FIELDS = ("corr_clip_partitions", "ds_clip")
_MARKER_G_FIELDS = ("band_whole", "dom_freq", "lock_hz", "band_frame", "thresholds")


def _g_fields(verify: "NormalVerifyConsts | MarkerVerifyConsts") -> tuple[str, ...]:
    return _NORMAL_G_FIELDS if isinstance(verify, NormalVerifyConsts) else _MARKER_G_FIELDS


def _map_g(corr: CorrelationBankConsts, verify: Any, fn) -> tuple[CorrelationBankConsts, Any]:
    """(corr, verify) with ``fn`` applied to every G-leading tensor."""
    return (
        replace(corr, **{f: fn(getattr(corr, f)) for f in _CORR_G_FIELDS}),
        replace(verify, **{f: fn(getattr(verify, f)) for f in _g_fields(verify)}),
    )


def pad_group_consts(
    corr: CorrelationBankConsts,
    verify: "NormalVerifyConsts | MarkerVerifyConsts",
    g_pad: int,
) -> tuple[CorrelationBankConsts, Any]:
    """Pad one group's constants to ``g_pad`` clip rows by repeating row 0.

    Duplicated rows compute exactly what clip 0 computes (same spectra,
    same verifier constants); callers slice results back to the real clip
    count, so padding only makes non-divisible groups shardable: it never
    changes results. Done once at init.
    """
    g = corr.self_corr_max.shape[0]
    if g_pad == g:
        return corr, verify
    if g_pad < g:
        raise ValueError(f"cannot pad group of {g} down to {g_pad}")
    return _map_g(
        corr, verify, lambda a: torch.cat([a, a[:1].expand(g_pad - g, *a.shape[1:])])
    )


def slice_group_consts(
    corr: CorrelationBankConsts,
    verify: "NormalVerifyConsts | MarkerVerifyConsts",
    shard: int,
    n_shards: int,
) -> tuple[CorrelationBankConsts, Any]:
    """Shard ``shard`` of ``n_shards`` of one group's constants: a
    contiguous slice of the G-leading tensors (G must divide), the shared
    structure as it is."""
    g = corr.self_corr_max.shape[0]
    if g % n_shards:
        raise ValueError(f"group of {g} clips does not divide over {n_shards} shards")
    per = g // n_shards
    return _map_g(corr, verify, lambda a: a[shard * per : (shard + 1) * per])


def shard_group_consts(
    mesh: Mesh,
    axis: str,
    corr: CorrelationBankConsts,
    verify: "NormalVerifyConsts | MarkerVerifyConsts",
) -> list[tuple[CorrelationBankConsts, Any]]:
    """One group's constants split over ``axis``: shard k holds slice k of
    the G-leading tensors and a replica of the shared structure, on the
    device at coordinate k of the axis."""
    n = mesh.shape[axis]
    out = []
    for k in range(n):
        dev = canonical_device(mesh.device_at(**{axis: k}))
        c, v = slice_group_consts(corr, verify, k, n)
        out.append((consts_to_device(c, dev), consts_to_device(v, dev)))
    return out


def stitch_bank_shards(
    parts: list[NDArray[np.float32]], local_widths: "tuple[int, ...]"
) -> NDArray[np.float32]:
    """The fused payload (..., total) of a class from its bank shards'
    fused payloads: each shard holds, group after group, its own rows of
    that group (``local_widths[g]`` floats); the whole holds every group's
    rows in clip order."""
    out = []
    off = 0
    for lw in local_widths:
        out += [p[..., off : off + lw] for p in parts]
        off += lw
    return np.concatenate(out, axis=-1)


class BankShardedBank:
    """A PatternBank whose group constants live sharded across a mesh axis.

    Drop-in for PatternBank's dispatch/collect/process_chunk surface: same
    inputs, same results; each shard's class step runs on its own device.
    Groups whose size does not divide the shard count are padded
    automatically with duplicate rows (results sliced back, see
    :func:`pad_group_consts`).
    """

    def __init__(self, bank: PatternBank, mesh: Mesh, axis: str = "bank") -> None:
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        self._bank = bank
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.shape[axis]
        self._devices = [canonical_device(mesh.device_at(**{axis: k})) for k in range(n_shards)]
        # Per class: for each shard, the tuple of its groups' (corr, verify).
        self._sharded: dict[int, list[tuple]] = {}
        self._padded_rows: dict[int, tuple[int, ...]] = {}
        self._local_widths: dict[int, tuple[int, ...]] = {}
        for sw, cls in bank.classes.items():
            per_group = []
            pad_rows = []
            for g in cls["groups"]:
                g_pad = -(-len(g.names) // n_shards) * n_shards
                corr_c, verify_c = pad_group_consts(g.corr, g.verify, g_pad)
                per_group.append(shard_group_consts(mesh, axis, corr_c, verify_c))
                pad_rows.append(g_pad)
            self._sharded[sw] = [
                tuple(shards[k] for shards in per_group) for k in range(n_shards)
            ]
            self._padded_rows[sw] = tuple(pad_rows)
            self._local_widths[sw] = tuple(
                gp // n_shards * (2 * g.k_verify + 2) for gp, g in zip(pad_rows, cls["groups"])
            )

    # ── Per-chunk execution (same dispatch/collect pairing as
    # PatternBank: dispatch enqueues asynchronously, collect blocks) ──

    def dispatch_chunk(self, chunk, previous_chunk):
        """Enqueue one chunk over the sharded bank (async); returns the
        same per-class records PatternBank.dispatch_chunk does.

        Rides the serial path's helpers (section assembly into a pooled
        staging buffer, int16 upload, fused payload, copy back enqueued at
        dispatch) with each shard's slice of the constants substituted;
        every shard of every class is enqueued before anything is awaited.
        The staging buffer goes back to the bank's pool at collect, once
        every shard's payload is on the host."""
        bank = self._bank
        dispatched = []
        for sw, cls in bank.classes.items():
            staged, (raw,) = bank._staged_sections(
                cls["section_len"], [bank._section_parts(sw, chunk, previous_chunk)])
            uploaded: dict[torch.device, torch.Tensor] = {}
            handles = []
            for dev, group_consts in zip(self._devices, self._sharded[sw]):
                if dev not in uploaded:
                    uploaded[dev] = as_f32(upload_rows(staged, dev)[0])
                with device_guard(dev):
                    flat = bank.step(
                        sw, uploaded[dev], len(raw), (bank.replica_loud(sw, dev), group_consts)
                    )
                    handles.append(PayloadHandle(flat))
            widths = self._local_widths[sw]
            dispatched.append(
                (sw, StitchedPayload(handles, lambda parts, w=widths: stitch_bank_shards(parts, w)),
                 raw, staged)
            )
        return dispatched

    def collect_chunk(self, dispatched):
        """Block on a dispatched chunk; accepted peak positions per clip.

        Identical record shape to the serial path, so collection
        (including row-granular flag resolution: wide device rerun for
        flag 2, exact host path for flag 1) delegates to
        PatternBank.collect_chunk; the padded-row map slices duplicate
        rows back off the fused payload."""
        return self._bank.collect_chunk(dispatched, padded_rows=self._padded_rows)

    def process_chunk(self, chunk, previous_chunk):
        """Synchronous dispatch + collect of one chunk."""
        return self.collect_chunk(self.dispatch_chunk(chunk, previous_chunk))
