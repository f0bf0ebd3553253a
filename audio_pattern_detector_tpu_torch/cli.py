"""CLI of the torch port: ``python -m audio_pattern_detector_tpu_torch match | serve | show-config``.

``match`` takes the JAX CLI's flags with the same defaults, guards, error
messages and exit codes, and writes the same JSONL events: one audio
file, several files (one start/end block each, the bank shared),
``--stdin``, ``--multiplexed-stdin``, ``--offline-batch``,
``--checkpoint-file``, ``--debug``, ``--trace-dir`` (a torch.profiler
Chrome trace) and ``--height-min`` at any value. It is built on the
port's ``match`` module, whose ``TorchEngineOptions`` pick the port's
detector and its device. ``serve`` takes
the JAX ``serve`` flags with the same defaults and answers TCP clients
with the JSONL events ``match --stdin`` prints (``serve.py``).
``--device`` (default ``cuda``) picks the torch device; without CUDA,
``cuda`` raises instead of running elsewhere.

``--mesh-time`` / ``--mesh-bank`` shard one stream's scan over a device
mesh, ``--mesh-stream`` scans several files (or serves streams) data
parallel over one; the mesh holds every visible device of ``--device``'s
kind, times ``APD_TORCH_LOGICAL_DEVICES`` (logical shards on one device,
``parallel/mesh.py``). Stdout is the serial run's, byte for byte.
"""

from __future__ import annotations

import argparse
import sys
from collections.abc import Sequence

from audio_pattern_detector_tpu_torch.match import (
    TorchEngineOptions,
    _collect_pattern_files,
    _emit_jsonl,
    _emit_jsonl_end,
    _int_or,
    _make_jsonl_callback,
    _match_pattern_multiplexed_stdin,
    _parse_chunk_seconds,
    cmd_show_config,
    match_pattern,
    match_pattern_many,
    match_pattern_many_parallel,
)
from audio_pattern_detector_tpu_torch.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu_torch.utils.timefmt import seconds_to_time

__all__ = ["TorchEngineOptions", "build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="audio-pattern-detector-tpu-torch",
        description="Audio pattern detection on a torch device (CUDA)",
    )
    sub = parser.add_subparsers(dest="command", help="Available commands")

    m = sub.add_parser("match", help="Find pattern matches in audio files")
    m.add_argument("--pattern-file", metavar="pattern file", action="append",
                   help="pattern file (can be specified multiple times)")
    m.add_argument("--pattern-folder", metavar="pattern folder", action="append",
                   help="folder of *.wav / *.apd.toml pattern clips (repeatable)")
    m.add_argument("audio_file", nargs="*", default=None,
                   help=("audio file(s) to find patterns in (omit with --stdin or "
                         "--multiplexed-stdin); several files scan one after another "
                         "against one bank, one start/end JSONL block each"))
    m.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without CUDA) or 'cpu'")
    m.add_argument("--stdin", action="store_true", help="read audio from stdin in WAV format")
    m.add_argument("--multiplexed-stdin", action="store_true",
                   help=("read patterns and audio from stdin: [uint32 num_patterns], per "
                         "pattern [uint32 name_len][name][uint32 data_len][wav_data], then "
                         "the audio stream (WAV)"))
    m.add_argument("--target-sample-rate", metavar="rate", type=int,
                   help="target sample rate in Hz (default: 8000)")
    m.add_argument("--timestamp-format", choices=["ms", "formatted", "both"], default="both",
                   help="timestamp format in JSONL output (default: both)")
    m.add_argument("--chunk-seconds", metavar="seconds", type=str, default=None,
                   help=("seconds per chunk. Default: 60 s chunks, up to 8 per device "
                         "launch for whole files; an explicit value disables the "
                         "batching, 'auto' picks the minimum the patterns allow"))
    m.add_argument("--debug", action=argparse.BooleanOptionalAction, default=False,
                   help=("debug mode (one audio file): the exact host path with its "
                         "artifacts; device positions that differ go to stderr"))
    m.add_argument("--debug-dir", metavar="dir", default="./tmp",
                   help="base directory for debug output (default: ./tmp)")
    m.add_argument("--height-min", metavar="height", type=float, default=None,
                   help="minimum correlation peak height (default: 0.25)")
    m.add_argument("--pipeline-depth", metavar="chunks", type=int, default=None,
                   help="maximum launches kept in flight on the device (default: 3)")
    m.add_argument("--offline-batch", metavar="chunks", type=int, default=None,
                   help=("file mode only: scan the whole file through the batched path, "
                         "N chunks per launch (events emitted after the scan)"))
    m.add_argument("--stream-batch", metavar="chunks", type=int, default=1,
                   help="consecutive chunks per device launch (default: auto for files)")
    m.add_argument("--stream-batch-mode", choices=("scan", "vmap"), default="scan",
                   help=("batched program for --stream-batch: 'scan' (chunks one after "
                         "another, one-chunk memory; default) or 'vmap' (chunks in "
                         "parallel, one set of launches, higher memory). Identical results"))
    m.add_argument("--offline-batch-mode", choices=("vmap", "scan"), default="scan",
                   help=("how --offline-batch packs chunks into a launch: 'scan' (default) "
                         "runs them one after another (one-chunk memory), 'vmap' computes "
                         "them in parallel (higher memory). Identical results"))
    m.add_argument("--mesh-time", metavar="devices", type=int, default=None,
                   help=("shard the scan along time across this many devices (each takes "
                         "one chunk of a slab, its lookback copied from its left "
                         "neighbour). Identical detections; events emitted per slab"))
    m.add_argument("--mesh-bank", metavar="devices", type=int, default=1,
                   help=("with --mesh-time: also shard the pattern bank across this many "
                         "devices (mesh = bank x time)"))
    m.add_argument("--mesh-stream", metavar="devices", type=int, default=1,
                   help=("several audio files: scan them concurrently, one chunk of each "
                         "per round, rows partitioned across this many devices. Stdout "
                         "identical to the sequential multi-file run"))
    m.add_argument("--checkpoint-file", metavar="path", default=None,
                   help=("persist resume state to this file after every chunk and resume "
                         "from it when it exists (single audio file or stdin; removed at "
                         "a clean end of stream)"))
    m.add_argument("--profile", action="store_true", default=False,
                   help="print per-stage wall-clock stats (JSON) to stderr after the run")
    m.add_argument("--trace-dir", metavar="dir", default=None,
                   help="write a torch.profiler Chrome trace of the run to this directory")

    s = sub.add_parser("serve", help=("serve the pattern bank to concurrent TCP audio streams "
                                      "(one device, N live streams batched per round)"))
    s.add_argument("--pattern-file", metavar="pattern file", action="append",
                   help="pattern file (can be specified multiple times)")
    s.add_argument("--pattern-folder", metavar="pattern folder", action="append",
                   help="folder of *.wav / *.apd.toml pattern clips (repeatable)")
    s.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without CUDA) or 'cpu'")
    s.add_argument("--host", metavar="host", default="127.0.0.1",
                   help="bind address (default: 127.0.0.1)")
    s.add_argument("--port", metavar="port", type=int, default=7342,
                   help="TCP port to listen on (default: 7342; 0 picks a free port)")
    s.add_argument("--max-streams", metavar="n", type=int, default=8,
                   help=("concurrent client streams batched into each round (default: 8); "
                         "extra connections get a JSONL error event"))
    s.add_argument("--tile", metavar="n", type=int, default=None,
                   help=("max rows per dispatch: a round's active rows compact into the tile "
                         "and the powers of two below it (default: min(16, max-streams))"))
    s.add_argument("--target-sample-rate", metavar="rate", type=int,
                   help="target sample rate in Hz (default: 8000)")
    s.add_argument("--timestamp-format", choices=["ms", "formatted", "both"], default="both",
                   help="timestamp format in JSONL events (same as match)")
    s.add_argument("--chunk-seconds", metavar="seconds", type=int, default=None,
                   help="seconds per chunk per stream (default: 60)")
    s.add_argument("--height-min", metavar="height", type=float, default=None,
                   help="minimum correlation peak height (default: 0.25)")
    s.add_argument("--pipeline-depth", metavar="rounds", type=int, default=2,
                   help="device rounds kept in flight while sockets ingest (default: 2)")
    s.add_argument("--dispatch-defer-ms", metavar="ms", type=float, default=50.0,
                   help=("hold a round back up to this long while other live streams are "
                         "mid-chunk; 0 disables (default: 50)"))
    s.add_argument("--idle-timeout", metavar="seconds", type=float, default=0,
                   help="drop a connection that sends no data for this long; 0 disables (default)")
    s.add_argument("--stats-interval", metavar="seconds", type=float, default=0,
                   help="print one JSON ops line to stderr every N seconds; 0 disables (default)")
    s.add_argument("--mesh-stream", metavar="N", type=int, default=None,
                   help=("partition each round's rows across a stream mesh of N devices "
                         "(--max-streams must be divisible by N)"))

    c = sub.add_parser("show-config", help="Show computed configuration for a pattern file")
    c.add_argument("pattern_file", metavar="pattern file", help="pattern file")
    c.add_argument("--target-sample-rate", metavar="rate", type=int,
                   help="target sample rate in Hz (default: 8000)")
    return parser


def _fail(message: str) -> None:
    print(f"Error: {message}", file=sys.stderr)
    sys.exit(1)


def _engine_options(args: argparse.Namespace) -> TorchEngineOptions:
    seconds_per_chunk, chunk_auto_perf = _parse_chunk_seconds(args)
    return TorchEngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_auto_perf,
        target_sample_rate=args.target_sample_rate or DEFAULT_TARGET_SAMPLE_RATE,
        debug_mode=args.debug,
        debug_dir=args.debug_dir,
        height_min=args.height_min,
        pipeline_depth=args.pipeline_depth,
        stream_batch=_int_or(args.stream_batch, 1),
        stream_batch_mode=args.stream_batch_mode,
        mesh_time=args.mesh_time,
        mesh_bank=_int_or(args.mesh_bank, 1),
        mesh_stream=_int_or(args.mesh_stream, 1),
        checkpoint_file=args.checkpoint_file,
        device=args.device,
    )


def _run_match_with_output(
    args: argparse.Namespace,
    pattern_files: list[str],
    audio_source: str | None,
    opts: TorchEngineOptions,
    from_stdin: bool = False,
) -> None:
    """One stream, one start/end block (the JAX CLI's runner of that name)."""
    callback = _make_jsonl_callback(args.timestamp_format)
    _emit_jsonl("start", source="stdin" if from_stdin else (audio_source or "unknown"))
    _, total_time = match_pattern(
        audio_source,
        pattern_files,
        debug_mode=opts.debug_mode,
        on_pattern_detected=callback,
        accumulate_results=False,
        seconds_per_chunk=opts.seconds_per_chunk,
        chunk_seconds_auto_perf=opts.chunk_auto_perf,
        from_stdin=from_stdin,
        target_sample_rate=args.target_sample_rate,
        debug_dir=opts.debug_dir,
        height_min=opts.height_min,
        profile=opts.profile,
        trace_dir=args.trace_dir,
        offline_batch=opts.offline_batch,
        offline_batch_mode=opts.offline_batch_mode,
        pipeline_depth=opts.pipeline_depth,
        stream_batch=opts.stream_batch,
        stream_batch_mode=opts.stream_batch_mode,
        mesh_time=opts.mesh_time,
        mesh_bank=opts.mesh_bank,
        checkpoint_file=opts.checkpoint_file,
        device=opts.device,
    )
    print(f"Total time processed: {seconds_to_time(seconds=total_time)}", file=sys.stderr)
    _emit_jsonl_end(total_time, args.timestamp_format)


def _run_match_many(
    args: argparse.Namespace,
    pattern_files: list[str],
    audio_sources: list[str],
    opts: TorchEngineOptions,
) -> None:
    """Several files, one after another: one start/end block per file in
    argument order, the bank shared, the equal-ms dedup reset per file."""
    if opts.debug_mode:
        _fail("--debug supports a single audio file")
    fmt = args.timestamp_format
    current_callback = [_make_jsonl_callback(fmt)]

    def on_file_start(source: str) -> None:
        current_callback[0] = _make_jsonl_callback(fmt)
        _emit_jsonl("start", source=source)

    def on_file_end(source: str, total_time: float) -> None:
        print(f"Total time processed: {seconds_to_time(seconds=total_time)}", file=sys.stderr)
        _emit_jsonl_end(total_time, fmt)

    match_pattern_many(
        audio_sources,
        pattern_files,
        on_pattern_detected=lambda name, t: current_callback[0](name, t),
        on_file_start=on_file_start,
        on_file_end=on_file_end,
        accumulate_results=False,
        seconds_per_chunk=opts.seconds_per_chunk,
        chunk_seconds_auto_perf=opts.chunk_auto_perf,
        target_sample_rate=args.target_sample_rate,
        height_min=opts.height_min,
        profile=opts.profile,
        trace_dir=args.trace_dir,
        offline_batch=opts.offline_batch,
        offline_batch_mode=opts.offline_batch_mode,
        pipeline_depth=opts.pipeline_depth,
        stream_batch=opts.stream_batch,
        stream_batch_mode=opts.stream_batch_mode,
        mesh_time=opts.mesh_time,
        mesh_bank=opts.mesh_bank,
        device=opts.device,
    )


def _run_match_many_parallel(
    args: argparse.Namespace,
    pattern_files: list[str],
    audio_sources: list[str],
    opts: TorchEngineOptions,
) -> None:
    """CLI runner for ``match a.wav b.wav … --mesh-stream N``.

    Output is BYTE-IDENTICAL to the sequential multi-file runner
    (_run_match_many): one start/end JSONL block per file, in argument
    order, per-file equal-ms dedup. Files scan concurrently underneath
    (match_pattern_many_parallel); events for files behind the emission
    cursor stream live, later files' events buffer until their block's
    turn. Only the stderr diagnostics interleave in completion order.
    """
    fmt = args.timestamp_format
    n = len(audio_sources)
    cursor = 0
    state = ["pending"] * n  # pending | started | ended
    buffers: list[list[tuple[str, float]]] = [[] for _ in range(n)]
    callbacks: list = [None] * n
    totals = [0.0] * n

    def emit_start(i: int) -> None:
        callbacks[i] = _make_jsonl_callback(fmt)
        _emit_jsonl("start", source=audio_sources[i])

    def advance() -> None:
        nonlocal cursor
        while cursor < n and state[cursor] != "pending":
            i = cursor
            if callbacks[i] is None:
                emit_start(i)
            cb = callbacks[i]
            for clip_name, t in buffers[i]:
                cb(clip_name, t)
            buffers[i].clear()
            if state[i] != "ended":
                return  # head file now live; its events emit directly
            print(
                f"Total time processed: {seconds_to_time(seconds=totals[i])}",
                file=sys.stderr,
            )
            _emit_jsonl_end(totals[i], fmt)
            cursor += 1

    def on_start(i: int, src: str) -> None:
        state[i] = "started"
        if i == cursor:
            advance()

    def on_detect(i: int, src: str, clip_name: str, t: float) -> None:
        cb = callbacks[i]
        if i == cursor and cb is not None:
            cb(clip_name, t)
        else:
            buffers[i].append((clip_name, t))

    def on_end(i: int, src: str, total: float) -> None:
        state[i] = "ended"
        totals[i] = total
        advance()

    match_pattern_many_parallel(
        audio_sources,
        pattern_files,
        mesh_stream=opts.mesh_stream,
        on_file_start=on_start,
        on_file_detect=on_detect,
        on_file_end=on_end,
        accumulate_results=False,
        seconds_per_chunk=opts.seconds_per_chunk,
        chunk_seconds_auto_perf=opts.chunk_auto_perf,
        target_sample_rate=args.target_sample_rate,
        height_min=opts.height_min,
        pipeline_depth=opts.pipeline_depth,
        device=opts.device,
    )
    if cursor != n:
        raise RuntimeError("parallel scan ended with unemitted file blocks")


def cmd_match(args: argparse.Namespace) -> None:
    """The JAX CLI's ``cmd_match`` on the port: same guards, messages,
    exit codes and event order."""
    from audio_pattern_detector_tpu_torch.ops.devices import resolve_device

    resolve_device(args.device)  # fail before any event is emitted
    opts = _engine_options(args)
    from_stdin = args.stdin or args.multiplexed_stdin
    audio_files = args.audio_file or []
    if audio_files and from_stdin:
        _fail(
            "audio files and --stdin/--multiplexed-stdin are mutually exclusive "
            "(the stdin stream would be scanned and the files silently ignored)"
        )
    if args.offline_batch and from_stdin:
        _fail(
            "--offline-batch requires file mode (whole-file scans; incompatible with "
            "--stdin/--multiplexed-stdin — use --stream-batch for live streams)"
        )
    if opts.mesh_stream != 1 and from_stdin:
        _fail(
            "--mesh-stream requires file mode (data parallelism over multiple audio "
            "FILES; incompatible with --stdin/--multiplexed-stdin — use serve "
            "--mesh-stream for live streams)"
        )

    if args.multiplexed_stdin:
        # Like the JAX CLI, the multiplexed mode ignores --profile and
        # --trace-dir.
        callback = _make_jsonl_callback(args.timestamp_format)
        _emit_jsonl("start", source="multiplexed-stdin")
        _, total_time = _match_pattern_multiplexed_stdin(opts, callback, accumulate_results=False)
        print(f"Total time processed: {seconds_to_time(seconds=total_time)}", file=sys.stderr)
        _emit_jsonl_end(total_time, args.timestamp_format)
        return

    opts.profile = args.profile
    opts.trace_dir = args.trace_dir
    pattern_files = _collect_pattern_files(args)
    if not pattern_files:
        print(
            "Please provide either --pattern-file, --pattern-folder, or --multiplexed-stdin",
            file=sys.stderr,
        )
        sys.exit(1)

    if args.stdin:
        _run_match_with_output(args, pattern_files, None, opts, from_stdin=True)
    elif audio_files:
        opts.offline_batch = args.offline_batch
        opts.offline_batch_mode = args.offline_batch_mode
        if opts.mesh_stream != 1 and len(audio_files) == 1:
            _fail(
                "--mesh-stream parallelises across MULTIPLE audio files (data "
                "parallelism over files); pass 2+ files, or use --mesh-time to shard "
                "a single file's scan"
            )
        if len(audio_files) == 1:
            _run_match_with_output(args, pattern_files, audio_files[0], opts)
        elif opts.checkpoint_file:
            # One checkpoint file cannot say which of the files it belongs to.
            _fail("--checkpoint-file supports a single audio file or stdin")
        elif opts.mesh_stream != 1:
            try:
                opts.validate(from_stdin=False)
            except ValueError as e:
                _fail(str(e))
            _run_match_many_parallel(args, pattern_files, audio_files, opts)
        else:
            _run_match_many(args, pattern_files, audio_files, opts)
    else:
        print("Please provide an audio file or --stdin or --multiplexed-stdin", file=sys.stderr)
        sys.exit(1)


def main(argv: "Sequence[str] | None" = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "match":
        cmd_match(args)
    elif args.command == "serve":
        from audio_pattern_detector_tpu_torch.serve import cmd_serve

        cmd_serve(args)
    elif args.command == "show-config":
        cmd_show_config(args)
    else:
        parser.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
