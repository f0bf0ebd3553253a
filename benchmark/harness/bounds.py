"""The least time a kernel's work can take on one H100, frozen here so that
a change to the program cannot move it.

Copied from the port's ``scripts/kernel_bounds.py`` (the candidate scan)
and ``scripts/profile_stages_torch.py`` (the correlation) as they stood
when this benchmark was written: the bytes the function needs, each input
read once and each output written once, over the card's memory rate, or
its operations over the f32 rate outside the tensor cores, whichever is
larger. Published peaks of the H100 SXM at 700 W.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12
SCAN_BLOCK = 512  # samples a block maximum of the candidate scan covers


def correlate_bound_s(b: int, g: int, ns: int, n: int, l: int) -> tuple[float, str]:
    """One overlap-save correlation launch: ``b`` rows, ``g`` clips of a
    group, ``ns`` segments of ``n`` points, ``l`` output samples a row and
    clip. Reads the segment spectra and the clips' spectra, writes the
    magnitudes; 2.5 n log2 n operations a transform."""
    half = n // 2 + 1
    nbytes = b * ns * half * 8 + g * half * 8 + b * g * l * 4
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = b * g * ns * 2.5 * n * math.log2(n) / PEAK_F32_OPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def scan_bound_s(g: int, l: int, valid: int) -> tuple[float, str]:
    """One candidate scan over ``g`` rows of ``l`` samples, ``valid`` of them
    valid a row: the valid samples and thresholds read once, the block
    maxima and four stats a row written once."""
    read = g * min(valid, l) * 4 + g * 4
    written = g * -(-l // SCAN_BLOCK) * 4 + 4 * g * 4
    return (read + written) / HBM_BYTES_PER_S, "bytes"


def roofline_pct(ctx, kernel: str, family: str) -> float | None:
    """The traced launches of ``kernel`` against their bounds, in percent:
    the bound of the launches a step makes (``ctx.launch_bounds[family]``,
    from the shapes the program runs), times the traced launches over the
    launches a step makes, over their traced time. None where the trace
    holds no such launch."""
    trace = ctx.trace
    per_step = ctx.launch_bounds.get(family) or []
    if trace is None or not per_step:
        return None
    count, seconds = trace.kernel_time(kernel)
    if count == 0 or seconds <= 0:
        return None
    bound = count * sum(s for s, _ in per_step) / len(per_step)
    return 100.0 * bound / seconds
