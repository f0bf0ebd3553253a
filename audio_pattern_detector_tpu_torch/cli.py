"""CLI of the torch port: ``python -m audio_pattern_detector_tpu_torch match | show-config``.

``match`` takes the JAX CLI's flags with the same flag-free defaults and
writes the same JSONL events. File mode is built from the reused host
pieces of ``audio_pattern_detector_tpu.match`` (pattern loading, the
file-mode launch plan of ``_match_pattern_file``, the JSONL emitters);
only the detector differs, chosen through ``TorchEngineOptions``.
``--device`` (default ``cuda``) picks the torch device; without CUDA,
``cuda`` raises instead of running elsewhere.

Surfaces not ported yet fail with an error naming the flag: ``--stdin``,
``--multiplexed-stdin``, ``--offline-batch``, ``--mesh-*``,
``--checkpoint-file``, ``--debug``, ``--trace-dir``,
``--stream-batch-mode vmap``, more than one audio file, and ``serve``.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections.abc import Sequence
from dataclasses import dataclass

from audio_pattern_detector_tpu.match import (
    EngineOptions,
    _collect_pattern_files,
    _emit_jsonl,
    _emit_jsonl_end,
    _int_or,
    _load_pattern_clips,
    _make_jsonl_callback,
    _match_pattern_file,
    _parse_chunk_seconds,
    cmd_show_config,
)
from audio_pattern_detector_tpu.utils.audio_io import DEFAULT_TARGET_SAMPLE_RATE
from audio_pattern_detector_tpu.utils.clip import AudioClip
from audio_pattern_detector_tpu.utils.timefmt import seconds_to_time


@dataclass
class TorchEngineOptions(EngineOptions):
    """EngineOptions whose detector runs on a torch device."""

    device: str = "cuda"

    def build_detector(self, clips: list[AudioClip]):
        from audio_pattern_detector_tpu_torch.models.detector import (
            TorchAudioPatternDetector,
        )

        return TorchAudioPatternDetector(
            audio_clips=clips,
            device=self.device,
            seconds_per_chunk=self.seconds_per_chunk,
            target_sample_rate=self.target_sample_rate,
            height_min=self.height_min,
        )


# (argparse dest, flag) of match options this port does not run yet.
_NOT_PORTED = (
    ("stdin", "--stdin"),
    ("multiplexed_stdin", "--multiplexed-stdin"),
    ("offline_batch", "--offline-batch"),
    ("mesh_time", "--mesh-time"),
    ("checkpoint_file", "--checkpoint-file"),
    ("debug", "--debug"),
    ("trace_dir", "--trace-dir"),
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="audio-pattern-detector-tpu-torch",
        description="Audio pattern detection on a torch device (CUDA)",
    )
    sub = parser.add_subparsers(dest="command", help="Available commands")

    m = sub.add_parser("match", help="Find pattern matches in an audio file")
    m.add_argument("--pattern-file", metavar="pattern file", action="append",
                   help="pattern file (can be specified multiple times)")
    m.add_argument("--pattern-folder", metavar="pattern folder", action="append",
                   help="folder of *.wav / *.apd.toml pattern clips (repeatable)")
    m.add_argument("audio_file", nargs="*", default=None,
                   help="the audio file to find patterns in")
    m.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without CUDA) or 'cpu'")
    m.add_argument("--stdin", action="store_true", help="not supported by the torch port yet")
    m.add_argument("--multiplexed-stdin", action="store_true",
                   help="not supported by the torch port yet")
    m.add_argument("--target-sample-rate", metavar="rate", type=int,
                   help="target sample rate in Hz (default: 8000)")
    m.add_argument("--timestamp-format", choices=["ms", "formatted", "both"], default="both",
                   help="timestamp format in JSONL output (default: both)")
    m.add_argument("--chunk-seconds", metavar="seconds", type=str, default=None,
                   help=("seconds per chunk. Default: 60 s chunks, up to 8 per device "
                         "launch for whole files; an explicit value disables the "
                         "batching, 'auto' picks the minimum the patterns allow"))
    m.add_argument("--debug", action=argparse.BooleanOptionalAction, default=False,
                   help="not supported by the torch port yet")
    m.add_argument("--debug-dir", metavar="dir", default="./tmp", help=argparse.SUPPRESS)
    m.add_argument("--height-min", metavar="height", type=float, default=None,
                   help="minimum correlation peak height (default: 0.25)")
    m.add_argument("--pipeline-depth", metavar="chunks", type=int, default=None,
                   help="maximum launches kept in flight on the device (default: 3)")
    m.add_argument("--offline-batch", metavar="chunks", type=int, default=None,
                   help="not supported by the torch port yet")
    m.add_argument("--stream-batch", metavar="chunks", type=int, default=1,
                   help="consecutive chunks per device launch (default: auto for files)")
    m.add_argument("--stream-batch-mode", choices=("scan", "vmap"), default="scan",
                   help="'scan' (default); 'vmap' is not supported by the torch port yet")
    m.add_argument("--offline-batch-mode", choices=("vmap", "scan"), default="scan",
                   help=argparse.SUPPRESS)
    m.add_argument("--mesh-time", metavar="devices", type=int, default=None,
                   help="not supported by the torch port yet")
    m.add_argument("--mesh-bank", metavar="devices", type=int, default=1,
                   help="not supported by the torch port yet")
    m.add_argument("--mesh-stream", metavar="devices", type=int, default=1,
                   help="not supported by the torch port yet")
    m.add_argument("--checkpoint-file", metavar="path", default=None,
                   help="not supported by the torch port yet")
    m.add_argument("--profile", action="store_true", default=False,
                   help="print per-stage wall-clock stats (JSON) to stderr after the run")
    m.add_argument("--trace-dir", metavar="dir", default=None,
                   help="not supported by the torch port yet")

    sub.add_parser("serve", help="not supported by the torch port yet")

    c = sub.add_parser("show-config", help="Show computed configuration for a pattern file")
    c.add_argument("pattern_file", metavar="pattern file", help="pattern file")
    c.add_argument("--target-sample-rate", metavar="rate", type=int,
                   help="target sample rate in Hz (default: 8000)")
    return parser


def _not_ported(args: argparse.Namespace) -> "str | None":
    for dest, flag in _NOT_PORTED:
        if getattr(args, dest):
            return flag
    if args.mesh_bank != 1:
        return "--mesh-bank"
    if args.mesh_stream != 1:
        return "--mesh-stream"
    if args.stream_batch_mode != "scan":
        return "--stream-batch-mode vmap"
    return None


def cmd_match(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    flag = _not_ported(args)
    if flag is not None:
        parser.error(f"{flag} is not supported by the torch port yet")
    audio_files = args.audio_file or []
    if len(audio_files) != 1:
        parser.error(
            "the torch port scans exactly one audio file "
            f"(got {len(audio_files)}; multi-file mode is not ported yet)"
        )
    pattern_files = _collect_pattern_files(args)
    if not pattern_files:
        parser.error("please provide --pattern-file or --pattern-folder")

    from audio_pattern_detector_tpu_torch.models.detector import resolve_device

    resolve_device(args.device)  # fail before any event is emitted
    seconds_per_chunk, chunk_auto_perf = _parse_chunk_seconds(args)
    sr = args.target_sample_rate or DEFAULT_TARGET_SAMPLE_RATE
    opts = TorchEngineOptions(
        seconds_per_chunk=seconds_per_chunk,
        chunk_auto_perf=chunk_auto_perf,
        target_sample_rate=sr,
        height_min=args.height_min,
        profile=args.profile,
        pipeline_depth=args.pipeline_depth,
        stream_batch=_int_or(args.stream_batch, 1),
        stream_batch_mode=args.stream_batch_mode,
        device=args.device,
    )
    opts.validate(from_stdin=False)

    # Event order of the JAX CLI's _run_match_with_output.
    audio_source = audio_files[0]
    callback = _make_jsonl_callback(args.timestamp_format)
    _emit_jsonl("start", source=audio_source)
    if not os.path.exists(audio_source):
        raise ValueError(f"Audio {audio_source} does not exist")
    clips = _load_pattern_clips(pattern_files, sr)
    _, total_time = _match_pattern_file(
        audio_source, clips, opts, callback, accumulate_results=False
    )
    print(f"Total time processed: {seconds_to_time(seconds=total_time)}", file=sys.stderr)
    _emit_jsonl_end(total_time, args.timestamp_format)


def main(argv: "Sequence[str] | None" = None) -> None:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if args.command == "serve":
        parser.error("serve is not supported by the torch port yet")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.command == "match":
        cmd_match(args, parser)
    elif args.command == "show-config":
        cmd_show_config(args)
    else:
        parser.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
