"""What the drivers share of the port: the bank's patterns as the program
takes them, the options a cell passes to it, and the counters and shapes
the metrics read. Only the port (``audio_pattern_detector_tpu_torch``) is
imported, and only inside these functions."""

from __future__ import annotations

from harness.bounds import correlate_bound_s, scan_bound_s
from harness.cell import Cell, pattern_paths

MAX_CORRELATE_KERNEL_LEN = 262_144  # the correlation kernel takes powers of two up to this
RERUN_COUNTERS = ("row_reruns", "class_reruns", "escalated_reruns", "host_path_rows")


def engine_options(cell: Cell) -> dict:
    """The port's options a cell sets beyond its defaults: the
    configuration's ``engine`` object, then the traffic file's over it."""
    return {**cell.config.get("engine", {}), **cell.traffic.get("engine", {})}


def program_clips(cell: Cell, ref_clips: list) -> list:
    """The same patterns as the program takes them: through the CLI's own
    loader for pattern files, as ``AudioClip``s for a seeded bank."""
    from audio_pattern_detector_tpu_torch import match as apd_match
    from audio_pattern_detector_tpu_torch.utils.clip import AudioClip

    sr = int(cell.config["sample_rate"])
    paths = pattern_paths(cell.config)
    if paths:
        return apd_match._load_pattern_clips(paths, sr)
    return [AudioClip(name=c.name, audio=c.audio, sample_rate=sr, strategy=c.strategy,
                      strategy_params={"dominant_frequency_hz": c.tone_hz} if c.tone_hz else {})
            for c in ref_clips]


def pack_seconds() -> float:
    """Host seconds so far in the bank's staging copy ("pack")."""
    from audio_pattern_detector_tpu_torch.models import bank as apd_bank

    return apd_bank.dispatch_phase_seconds["pack"]


def reruns(bank) -> dict[str, int]:
    """The bank's counts of flagged rows by the route that resolved them."""
    return {k: int(getattr(bank, k, 0)) for k in RERUN_COUNTERS}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def launch_bounds(bank, rows: int = 1) -> dict[str, list[tuple[float, str]]]:
    """The bounds of the correlation and scan launches one class step of
    ``rows`` rows makes, from the geometry the bank built (a full chunk
    with its lookback in every row)."""
    out: dict[str, list[tuple[float, str]]] = {"correlate": [], "scan": []}
    for sw in sorted(bank.classes):
        for group in bank.classes[sw]["groups"]:
            c = group.corr
            g = int(c.bank_rfft_conj.shape[0])
            n = int(c.fft_len)
            if c.num_segments > 1 and n <= MAX_CORRELATE_KERNEL_LEN and n & (n - 1) == 0:
                out["correlate"].append(correlate_bound_s(rows, g, int(c.num_segments), n, int(c.full_len)))
            out["scan"].append(scan_bound_s(rows * g, int(c.full_len), int(c.section_len + c.clip_len - 1)))
    return out
