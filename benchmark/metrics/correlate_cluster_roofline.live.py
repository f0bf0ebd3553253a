"""The correlation kernel's (``csrc/correlate_os.cu``) cluster instance,
``correlate_os_kernel<true>`` (a transform over a cluster of CTAs, past
32,768 points), and its share of its roofline: the bounds of the groups
that launch it (the family ``correlate_cluster`` of the driver's launch
bounds, ``harness/bounds.py``) over its traced launches' time. None where
the trace holds no such launch or the driver names no such group."""

from harness.bounds import roofline_pct

KERNEL = "correlate_os_kernel<true>"


def read(ctx):
    return roofline_pct(ctx, KERNEL, "correlate_cluster")
