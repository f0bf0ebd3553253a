"""Captured class steps: the port's counterpart of the JAX bank's jitted
class-step programs (``_class_step_jit``, ``_class_step_fused_jit``,
``_class_step_batch_jit``, ``_class_step_scan_jit`` and their packed
twins, JAX ``models/bank.py:1716-1884``).

The JAX bank never runs a class step op by op: each is one compiled
program, cached by its shapes and static arguments. Here the class step
(:func:`models.bank.class_step_fused`, or :func:`class_step` for per-group
payloads) is captured once per key into a CUDA graph and replayed:

* **The batched form, B = 1 included.** A graph runs the step on a
  ``(B, S)`` section in the upload dtype (int16 rows decode inside it)
  with a ``(B,)`` int32 length tensor, the form that makes no host sync.
  One section is B = 1, so one graph serves every length of a shape, as
  the JAX program does by tracing its length.
* **Key** (:class:`StepKey`): device, sliding-window class, B, upload
  dtype, fused or per-group payloads, the candidate scan, the tier (lean,
  or general-plateau for ``height_min <= 0``) and its form (kernel or
  ``APD_PALLAS=0`` mask), ``APD_MARKER_GEMM`` as it reads at the call
  where it acts (off a card: a card's marker verifier is its fused kernel
  either way), and the identity of the constants the step reads:
  a replica on another device or a bank shard's slice is another key, and
  its graph holds those constants for as long as it lives. A flagged
  row's wide rerun (``models/bank.py::PatternBank._full_tier_row``) is a
  key of its own too: one clip's constants, B = 1, and its lanes.
  The JAX bank's ``APD_PACKED_UPLOAD``, ``APD_NO_OVERLAP_SAVE``,
  ``APD_SKIP_EMPTY_VERIFY`` and ``APD_GREEDY_UNROLL`` are no part of it:
  they pick other forms of the same step, which the port does not read
  (``models/bank.py``).
* **First use** copies the call's rows and lengths into the static inputs,
  runs the step eagerly on the device's capture stream (which builds the
  cuFFT plans, the kernels' per-device attributes and the marker kernel's
  FFT plans), then captures it into the device's graph memory pool. The eager run's payload
  is the call's result, so a key's first call costs one step on the card,
  as every later call does.
* **Replay**: copy the rows and lengths into the static inputs, replay on
  the current stream, copy the payload out of the static output (one small
  device copy), so that no later replay overwrites a payload a caller
  holds. A call of fewer rows than B leaves the rest idle: zero samples,
  zero length.
* **Rounds wider than a graph** (:class:`SplitRound`): a graph keeps its
  pools for its bank's life, so the bank caps a key's B
  (``models/bank.py::GRAPH_ROWS``) and a round of more rows runs as
  ceil(B / W) replays of the W-row key, each writing its rows of the
  round's payload; the last replay's spare rows are idle and dropped. Idle
  rows (rather than a second key of B mod W rows) keep one graph and one
  set of static inputs per width. The eager step runs a wide round in the
  same W-row steps, idle rows included, so the two agree bit for bit.
* **Candidate-free groups skip the verify tail** (JAX
  ``models/bank.py:1306-1330``): the capture hands the step the backend's
  ``conditional(pred, body)``, and the lean tail captures
  each group's verify as the body of a CUDA conditional (if) node whose
  predicate, "some lane of the group's rows is live", a kernel sets on the
  device at replay (``csrc/graph_conditional.cu``: torch 2.11 has no
  conditional-node capture of its own). The body is captured on a side
  stream into the if-node's body graph, and what it allocates comes from a
  second memory pool of the device kept for bodies, as the graph's pool
  takes only the capture stream's allocations. A round's graph (B > 1)
  tests all its rows at once: it skips a group only where no row of the
  round has a live lane. The eager first run verifies every group, so the
  plans and tables the body replays (the marker kernel's FFT plans) exist
  before the capture.
* **The two greedy filters are kernels** (``ops/lean_greedy.py``,
  ``ops/lane_greedy.py``): the lean kernel tier's block-wise greedy and the
  general-plateau tier's lane greedy are one launch a group in the graph,
  each row's loop inside the launch, where the JAX bank's
  ``lax.while_loop`` forms run in its program. So on a card a kernel-tier key
  holds no while node.
* **The mask tier's lean greedy is a while node** (``APD_PALLAS=0``, JAX
  ``ops/peaks.py:542-565``): the capture hands the step the backend's
  ``while_loop(pred, body)``, the body one round of
  ``ops/peaks.py::greedy_survivors_from_blocks``, so a group whose rows
  have no candidate runs no round. The eager first run runs the ``r_max``
  rounds unrolled, so every gather buffer exists before the capture.
* **The general-plateau tier's two-tier verify** (JAX
  ``models/bank.py:111-133``, a ``lax.cond``): on a card each verifier's
  kernel takes every lane in one launch and computes only live ones, so a
  card's key holds no cond. With the plain verifiers (a stand-in backend)
  the capture hands the step the backend's ``cond(pred, then_, else_)``:
  two if-nodes, on ``pred`` and on ``~pred``. A while node (``while_loop(pred, body)``, the mask tier's greedy above)
  re-runs its body graph while a device bool the body rewrites holds; loop
  state lives in tensors allocated before the node and updated in place.
  The eager first run takes both branches of each cond (the untaken one
  first, :func:`both_branches`), so either body's cuFFT plans exist before
  the capture.
* **Launch accounting**: a replay makes no Python call of the kernel
  wrappers, so each graph records how many launches of each kernel
  (:data:`KERNELS`), and how many calls of the correlation's cuFFT route,
  its capture enqueued (:data:`COUNTED`; the capture itself executes none
  and adds none to a wrapper's ``launches``), and each replay adds those
  numbers. The lean tail's verifiers run inside its if-node bodies, which
  a replay runs or skips on the device: a replay adds only the launches outside bodies,
  and ``body_launches`` lists each body's, for a caller that counts the
  bodies that ran from the payload (a lean group's body ran where the
  group has a position below the sentinel).
* **Memory**: one graph memory pool per device, shared by the bank's
  graphs on it (the widths of a tile ladder, both upload dtypes, both
  schedules), on one capture stream per device, and one pool
  and side stream per device for the conditional bodies (nodes do not
  nest: a body holds no node of its own). Graphs sharing a pool must
  not run at once: a bank's replays on a device are issued in order on the
  current stream, each payload copied out before the next replay.

A bank is driven from one thread at a time. Nothing here falls back to the
eager step: a capture or replay that fails raises.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from audio_pattern_detector_tpu_torch.ops.candidate_scan import candidate_scan
from audio_pattern_detector_tpu_torch.ops.correlate import cufft_correlation
from audio_pattern_detector_tpu_torch.ops.correlate_os import correlate_os
from audio_pattern_detector_tpu_torch.ops.devices import device_guard
from audio_pattern_detector_tpu_torch.ops.lane_greedy import lane_greedy
from audio_pattern_detector_tpu_torch.ops.lean_greedy import lean_greedy
from audio_pattern_detector_tpu_torch.ops.loudness import loudness_gate
from audio_pattern_detector_tpu_torch.ops.packing import as_f32
from audio_pattern_detector_tpu_torch.ops.verify_marker import verify_marker
from audio_pattern_detector_tpu_torch.ops.verify_normal import verify_normal
from audio_pattern_detector_tpu_torch.utils.profiling import RECORDER

# The kernel wrappers whose ``launches`` a replay adds to; and the
# correlation's cuFFT route, whose ``launches`` counts calls, not kernels.
KERNELS = (candidate_scan, lane_greedy, lean_greedy, verify_normal, verify_marker, loudness_gate,
           correlate_os)
COUNTED = KERNELS + (cufft_correlation,)


class StepKey(NamedTuple):
    """What a captured class step is compiled for (the JAX compile key:
    shapes plus static arguments)."""

    device: torch.device
    sw: int  # sliding-window class
    rows: int  # B
    dtype: torch.dtype  # upload dtype of the section
    fused: bool  # one flat payload per row, or each group's
    scan: Callable  # the candidate scan the lean tier calls
    general: bool  # the general-plateau tier (height_min <= 0), else the lean one
    kernel_tier: bool  # False: the APD_PALLAS=0 mask tier
    marker_gemm: bool  # APD_MARKER_GEMM=1 at the call, off a card (a card runs the fused kernel)
    consts: tuple[int, ...]  # ids of the loudness and group constants
    wide_lanes: tuple[int, ...] = ()  # a row rerun's wide tier: its k_detect lanes; () for the class step


def _tensors(out: Any) -> list[torch.Tensor]:
    return [out] if isinstance(out, torch.Tensor) else list(out)


def _copy_out(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.clone()
    return [t.clone() for t in out]


class EagerStep:
    """The class step run op by op (``capture=False`` and the CPU). A
    single section with an int length runs the single-section form; a
    length tensor is copied into a buffer of the step's own, as the
    captured step copies it into its static input. A batch of fewer than
    ``rows`` rows (a :class:`SplitRound`'s last step) runs with the rest
    idle, as the captured step of ``rows`` rows runs it."""

    def __init__(self, fn: Callable, device: torch.device, rows: int = 1) -> None:
        self._fn = fn
        self.device = device
        self.rows = rows

    def load(self, section: torch.Tensor, n_valid: "int | torch.Tensor") -> None:
        self._section = section.to(self.device)
        if isinstance(n_valid, torch.Tensor):
            with device_guard(self.device):
                self._n_valid: "int | torch.Tensor" = torch.empty(
                    n_valid.shape, dtype=torch.int32, device=self.device)
            self._n_valid.copy_(n_valid, non_blocking=True)
            idle = self.rows - n_valid.shape[0]
            if idle > 0:
                self._section = F.pad(self._section, (0, 0, 0, idle))
                self._n_valid = F.pad(self._n_valid, (0, idle))
        else:
            self._n_valid = int(n_valid)

    def run(self) -> Any:
        return self._fn(as_f32(self._section), self._n_valid)


class CudaGraphBackend:
    """``torch.cuda.CUDAGraph`` with one memory pool and one capture stream
    per device, shared by every graph the backend makes on that device,
    and a pool and side stream per device for conditional bodies."""

    def __init__(self) -> None:
        self._devices: dict[torch.device, tuple[Any, torch.cuda.Stream]] = {}
        self._bodies: dict[torch.device, tuple[Any, torch.cuda.Stream]] = {}

    @staticmethod
    def check(device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(
                f"capture=True needs a CUDA device, got {device}: on the CPU the class "
                "step runs eagerly (capture=False)"
            )

    def _pool_and_stream(self, device: torch.device) -> tuple[Any, torch.cuda.Stream]:
        if device not in self._devices:
            self._devices[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        return self._devices[device]

    def warm_up(self, device: torch.device, fn: Callable[[], Any]) -> Any:
        """``fn()`` run eagerly on the device's capture stream, ordered after
        the current stream's work and before its later work."""
        _, stream = self._pool_and_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        for t in _tensors(out):
            t.record_stream(current)
        return out

    def capture(self, device: torch.device, fn: Callable[[], Any]) -> tuple[Callable[[], None], Any]:
        """(replay, static output) of ``fn`` captured into the device's pool."""
        pool, stream = self._pool_and_stream(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn()
        return graph.replay, out

    # How conditional(), cond() and while_loop() build their nodes: the
    # port's own C entry points around the capture (torch 2.11 has no
    # conditional-node capture).
    conditional_route = "csrc/graph_conditional.cu"

    def conditional(self, pred: torch.Tensor, body: Callable[[], Any]) -> None:
        """Inside a capture on the current stream: ``body``'s work becomes
        the body graph of a CUDA if-node, run at replay only where the 0-d
        bool ``pred`` on the device holds (a kernel captured before the
        node sets the node's handle from it). The body runs on the device's
        side stream, allocating from the bodies' pool. Raises outside a
        capture, and where the driver cannot make the node."""
        self._node("if", pred, body)

    def cond(self, pred: torch.Tensor, then_: Callable[[], Any],
             else_: Callable[[], Any]) -> None:
        """The two-way ``lax.cond``: ``then_`` as the body of an if-node on
        ``pred``, ``else_`` as the body of a second if-node on ``~pred``
        (computed before the first node, so ``then_`` cannot change it). Each
        branch writes its results into tensors allocated before the call."""
        not_pred = ~pred
        self._node("if", pred, then_)
        self._node("if", not_pred, else_)

    def while_loop(self, pred: torch.Tensor, body: Callable[[], Any]) -> None:
        """The ``lax.while_loop``: ``body``'s work becomes the body graph of
        a CUDA while node, run at replay while the 0-d bool ``pred`` holds.
        The node's handle is set from ``pred`` before the node (so a false
        ``pred`` runs no body) and after each pass of the body, which must
        rewrite ``pred`` in place. Loop state lives in tensors allocated
        before the call and updated in place, since a graph's addresses are
        fixed."""
        self._node("while", pred, body)

    def _node(self, kind: str, pred: torch.Tensor, body: Callable[[], Any]) -> None:
        from audio_pattern_detector_tpu_torch.kernels._build import load_kernels

        if pred.dim() != 0 or pred.dtype != torch.bool or pred.device.type != "cuda":
            raise ValueError(f"{kind} node: pred must be a 0-d bool tensor on a CUDA device")
        lib = load_kernels().lib
        begin, end = ((lib.apd_graph_if_begin, lib.apd_graph_if_end) if kind == "if"
                      else (lib.apd_graph_while_begin, lib.apd_graph_while_end))
        device = pred.device
        held = self._bodies.get(device)
        pool, side = held or (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        err = begin(torch.cuda.current_stream(device).cuda_stream, pred.data_ptr(),
                    side.cuda_stream)
        if err:
            raise RuntimeError(f"{kind} node: capture of the node failed: CUDA error {err}")
        # The graph's pool takes only the capture stream's allocations, and
        # a pool records one capture at a time: the body's go to its own.
        # Each recording takes a reference to the pool; the backend keeps
        # the first until it is collected (after every graph it made).
        torch._C._cuda_beginAllocateToPool(device.index, pool)
        if held is None:
            self._bodies[device] = (pool, side)
        try:
            with torch.cuda.stream(side):
                body()
        finally:
            torch._C._cuda_endAllocateToPool(device.index, pool)
            if held is not None:
                torch._C._cuda_releasePool(device.index, pool)
            end_err = end(side.cuda_stream)
        if end_err:
            raise RuntimeError(f"{kind} node: capture of the body failed: CUDA error {end_err}")

    def __del__(self) -> None:
        # Every graph of this backend holds it, so none is left to replay:
        # the bodies' pools may go back to the allocator.
        for device, (pool, _) in getattr(self, "_bodies", {}).items():
            try:
                torch._C._cuda_releasePool(device.index, pool)
            except (AttributeError, TypeError):  # torch torn down at interpreter exit
                pass


def both_branches(pred: torch.Tensor, then_: Callable[[], Any],
                  else_: Callable[[], Any]) -> None:
    """The two-way cond of a captured step's eager first run: the branch
    ``pred`` does not take, then the one it takes. Each branch writes all
    of its results, so the taken one's stand; and both have run once, so
    the plans and tables either body replays exist before the capture.
    Reads ``pred`` on the host: an eager run."""
    taken, other = (then_, else_) if bool(pred) else (else_, then_)
    other()
    taken()


class CapturedStep:
    """One captured class step: static inputs, its graph and static output."""

    def __init__(self, key: StepKey, fn: Callable, consts: tuple, backend: Any,
                 section_len: int) -> None:
        self.key = key
        self.device = key.device
        self.consts = consts  # the graph reads these tensors: held while it lives
        self._fn = fn
        self._backend = backend
        with device_guard(self.device):
            self.section = torch.zeros((key.rows, section_len), dtype=key.dtype,
                                       device=self.device)
            self.n_valid = torch.zeros((key.rows,), dtype=torch.int32, device=self.device)
        self._replay: "Callable[[], None] | None" = None
        self._out: Any = None
        # Each wrapper's launches a replay outside conditional bodies, and
        # each body's launches, in the order the capture met the bodies.
        self.kernel_launches = dict.fromkeys(COUNTED, 0)
        self.body_launches: list[dict] = []
        self.replays = 0
        self.capture_seconds: "float | None" = None  # first use: eager run and capture

    @property
    def launches(self) -> int:
        """Kernel launches one replay makes outside conditional bodies,
        every kernel counted."""
        return sum(self.kernel_launches[w] for w in KERNELS)

    def _recorded(self, body: Callable[[], Any]) -> Callable[[], None]:
        """``body`` adding the launches it makes when captured to a new
        entry of ``body_launches``."""
        if self._replay is not None:  # a stand-in backend's replay runs the step again
            return body
        launched: dict = {}
        self.body_launches.append(launched)

        def run() -> None:
            before = {w: w.launches for w in COUNTED}
            body()
            launched.update({w: w.launches - n for w, n in before.items() if w.launches != n})

        return run

    def load(self, section: torch.Tensor, n_valid: "int | torch.Tensor") -> None:
        """Copy one call's rows ((n, S) with n <= B, or one (S,) row) and
        lengths into the static inputs, in stream order: lengths from
        pinned host memory (the dispatch path's) do not make the host wait
        for the stream. Rows past the call's are idle: zero samples, zero
        length."""
        span = RECORDER.open("step.load", a=self.key.rows, b=self.key.sw) if RECORDER.on else -1
        rows = section.reshape(-1, self.section.shape[1])
        n = rows.shape[0]
        self.section[:n].copy_(rows)
        if isinstance(n_valid, torch.Tensor):
            self.n_valid[:n].copy_(n_valid.reshape(n), non_blocking=True)
        else:
            self.n_valid[:n].fill_(n_valid)
        if n < self.key.rows:
            self.section[n:].zero_()
            self.n_valid[n:].zero_()
        if span >= 0:
            RECORDER.close(span)

    def _step(self, branch: "Callable | None" = None, loop: "Callable | None" = None,
              cond: "Callable | None" = None) -> Any:
        return self._fn(as_f32(self.section), self.n_valid, branch=branch, loop=loop, cond=cond)

    def run(self) -> Any:
        """The payload of the loaded inputs, owned by the caller. A replay
        adds its graph's launches to each wrapper's count; while recording
        it is the span ``step.replay`` (attributes: rows, window), a first
        use ``step.capture``."""
        with device_guard(self.device):
            if self._replay is None:
                return self._first_run()
            span = RECORDER.open("step.replay", a=self.key.rows, b=self.key.sw) if RECORDER.on else -1
            self._replay()
            for wrapper, n in self.kernel_launches.items():
                wrapper.launches += n
            self.replays += 1
            out = _copy_out(self._out)
            if span >= 0:
                RECORDER.close(span)
            return out

    def _first_run(self) -> Any:
        span = RECORDER.open("step.capture", a=self.key.rows, b=self.key.sw) if RECORDER.on else -1
        t0 = time.perf_counter()
        self._backend.check(self.device)
        general = self.key.general
        out = self._backend.warm_up(
            self.device, lambda: self._step(cond=both_branches if general else None))
        counted = {wrapper: wrapper.launches for wrapper in COUNTED}
        backend = self._backend

        def branch(pred, body) -> None:
            backend.conditional(pred, self._recorded(body))

        def two_way(pred, then_, else_) -> None:
            backend.cond(pred, self._recorded(then_), self._recorded(else_))

        # A plain greedy's loop (the mask tier's lean greedy, and on a
        # stand-in backend the plain greedies of every tier) is a while
        # node; the plain verifiers' two-tier verify in the general tier a
        # cond. The kernels take neither.
        try:
            self._replay, self._out = backend.capture(self.device, lambda: self._step(
                branch, backend.while_loop, two_way if general else None))
            in_bodies = {w: sum(b.get(w, 0) for b in self.body_launches) for w in COUNTED}
            self.kernel_launches = {w: w.launches - n - in_bodies[w] for w, n in counted.items()}
        finally:
            for wrapper, n in counted.items():
                wrapper.launches = n  # a capture executes nothing
        self.capture_seconds = time.perf_counter() - t0
        if span >= 0:
            RECORDER.close(span)
        return out


class SplitRound:
    """A round of more rows than the widest graph: its W-row step
    (:class:`CapturedStep` or :class:`EagerStep`) run once per W rows, the
    steps' rows of the (B, total) payload (or of each group's round-major
    (B * G, 2K+2) payload) joined in row order; the last step's spare rows
    run idle and are dropped."""

    def __init__(self, step: "CapturedStep | EagerStep", rows: int, width: int,
                 fused: bool) -> None:
        self.step = step
        self.rows = rows
        self.width = width
        self.fused = fused
        self.device = step.device

    def load(self, section: torch.Tensor, n_valid: torch.Tensor) -> None:
        self._section, self._n_valid = section, n_valid

    def run(self) -> Any:
        """The round's payload, owned by the caller."""
        parts = []
        for lo in range(0, self.rows, self.width):
            hi = min(lo + self.width, self.rows)
            self.step.load(self._section[lo:hi], self._n_valid[lo:hi])
            out = self.step.run()
            parts.append([t[: t.shape[0] // self.width * (hi - lo)] for t in _tensors(out)])
        joined = [torch.cat(group) for group in zip(*parts)]
        return joined[0] if self.fused else joined


class StepGraphs:
    """A bank's captured class steps, by :class:`StepKey`."""

    backend: type = CudaGraphBackend  # the graph maker; tests substitute a stand-in

    def __init__(self) -> None:
        self._backend = type(self).backend()
        self._steps: dict[StepKey, CapturedStep] = {}

    def check(self, device: torch.device) -> None:
        self._backend.check(device)

    def get(self, key: StepKey, fn: Callable, consts: tuple, section_len: int) -> CapturedStep:
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = CapturedStep(key, fn, consts, self._backend, section_len)
        return step

    def steps(self) -> list[CapturedStep]:
        return list(self._steps.values())
