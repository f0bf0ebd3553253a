"""The correlation kernel's (``csrc/correlate_os.cu``) share of its roofline:
its launches' bounds (bytes or operations, ``harness/bounds.py``) over their
traced time."""

from harness.bounds import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "correlate_os_kernel", "correlate")
