"""The candidate scan kernel's (``csrc/candidate_scan.cu``) share of its
roofline: its launches' byte bounds (``harness/bounds.py``) over their
traced time."""

from harness.bounds import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "candidate_scan_kernel", "scan")
