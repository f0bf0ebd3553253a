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

Not ported, and refused with an error naming the flag: ``--mesh-time``,
``--mesh-bank`` and ``--mesh-stream`` (other than 1).
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
                   help="not supported by the torch port yet")
    m.add_argument("--mesh-bank", metavar="devices", type=int, default=1,
                   help="not supported by the torch port yet")
    m.add_argument("--mesh-stream", metavar="devices", type=int, default=1,
                   help="not supported by the torch port yet")
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
                   help="not supported by the torch port yet (N other than 1 is refused)")

    c = sub.add_parser("show-config", help="Show computed configuration for a pattern file")
    c.add_argument("pattern_file", metavar="pattern file", help="pattern file")
    c.add_argument("--target-sample-rate", metavar="rate", type=int,
                   help="target sample rate in Hz (default: 8000)")
    return parser


def _not_ported(args: argparse.Namespace) -> "str | None":
    if args.mesh_time is not None:
        return "--mesh-time"
    if args.mesh_bank != 1:
        return "--mesh-bank"
    if args.mesh_stream != 1:
        return "--mesh-stream"
    return None


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
        device=opts.device,
    )


def cmd_match(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    """The JAX CLI's ``cmd_match`` on the port: same guards, messages,
    exit codes and event order."""
    flag = _not_ported(args)
    if flag is not None:
        parser.error(f"{flag} is not supported by the torch port yet")
    from audio_pattern_detector_tpu_torch.models.detector import resolve_device

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
        if len(audio_files) == 1:
            _run_match_with_output(args, pattern_files, audio_files[0], opts)
        elif opts.checkpoint_file:
            # One checkpoint file cannot say which of the files it belongs to.
            _fail("--checkpoint-file supports a single audio file or stdin")
        else:
            _run_match_many(args, pattern_files, audio_files, opts)
    else:
        print("Please provide an audio file or --stdin or --multiplexed-stdin", file=sys.stderr)
        sys.exit(1)


def main(argv: "Sequence[str] | None" = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "match":
        cmd_match(args, parser)
    elif args.command == "serve":
        if args.mesh_stream not in (None, 1):
            parser.error("--mesh-stream is not supported by the torch port yet")
        from audio_pattern_detector_tpu_torch.serve import cmd_serve

        cmd_serve(args)
    elif args.command == "show-config":
        cmd_show_config(args)
    else:
        parser.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
