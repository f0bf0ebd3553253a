"""Timestamp formatting.

Standalone replacement for the ``andrew_utils.seconds_to_time`` helper the
reference depends on (used at reference match.py:17,536,596 and
audio_pattern_detector.py:15,496). Format: ``HH:MM:SS.mmm`` (or ``HH:MM:SS``
when ``include_decimals=False``); hours grow beyond two digits for long
streams.
"""

from __future__ import annotations


def seconds_to_time(seconds: float, include_decimals: bool = True) -> str:
    """Format a non-negative number of seconds as ``HH:MM:SS[.mmm]``."""
    if seconds < 0:
        raise ValueError(f"seconds must be non-negative, got {seconds}")
    total_ms = round(seconds * 1000)
    if not include_decimals:
        total_ms = int(seconds) * 1000
    ms = total_ms % 1000
    total_s = total_ms // 1000
    s = total_s % 60
    m = (total_s // 60) % 60
    h = total_s // 3600
    base = f"{h:02d}:{m:02d}:{s:02d}"
    if include_decimals:
        return f"{base}.{ms:03d}"
    return base
