"""The ``live`` driver (``drivers/live.py``: stations served as ``serve``
builds its session, one ``dispatch`` and its ``collect`` a round), whose
launch bounds also name, as the family ``correlate_cluster``, the
correlation launches that run as a cluster of CTAs: a group whose
``fft_len`` is past what one CTA of ``csrc/correlate_os.cu`` transforms.
A traffic file names it where a cell reads that family
(``metrics/correlate_cluster_roofline.live.py``). Its warm-up also runs
each clip's row rerun once (the wide tier a flagged row takes at collect
time), so that what a program builds for a rerun at first use (one clip's
constants, a captured step) is set-up and not a round of the window;
everything else is the ``live`` driver's own.
"""

from __future__ import annotations

import numpy as np

from harness import port
from harness.bounds import correlate_bound_s
from harness.cell import load_driver

_live = load_driver("live")
served_whole = _live.served_whole
population = _live.population
inputs = _live.inputs

# The largest fft_len one CTA of the correlation kernel transforms (N / 2
# complex values in its 128 KB of shared memory); past it a transform takes
# a cluster of CTAs. Frozen here as ``harness/port.py`` freezes the kernel's
# largest length, so that a change to the program cannot move it.
MAX_ONE_CTA_CORRELATE_LEN = 32_768


def cluster_bounds(bank, rows: int = 1) -> list[tuple[float, str]]:
    """The bounds of the correlation launches one class step of ``rows``
    rows makes in a cluster of CTAs, from the geometry the bank built (a
    full chunk with its lookback in every row), as ``port.launch_bounds``
    computes the family ``correlate``."""
    out = []
    for sw in sorted(bank.classes):
        for group in bank.classes[sw]["groups"]:
            c = group.corr
            n = int(c.fft_len)
            if (c.num_segments > 1 and MAX_ONE_CTA_CORRELATE_LEN < n <= port.MAX_CORRELATE_KERNEL_LEN
                    and n & (n - 1) == 0):
                out.append(correlate_bound_s(rows, int(c.bank_rfft_conj.shape[0]), int(c.num_segments), n,
                                             int(c.full_len)))
    return out


class Driver(_live.Driver):
    """``live``'s driver, with the family ``correlate_cluster`` beside
    ``correlate`` and ``scan`` in its launch bounds, and the row reruns in
    its warm-up."""

    def warm(self) -> None:
        """``live``'s warm-up, then every clip's row rerun at the capped
        width on a silent section of its class, as a flagged row of the
        window would take it (a silent section flags nothing further)."""
        super().warm()
        bank = self.session._bank
        for sw, cls in bank.classes.items():
            silent = np.zeros(cls["section_len"], dtype=np.float32)
            for gi, group in enumerate(cls["groups"]):
                for ci in range(len(group.names)):
                    bank.resolve_flagged_rows(sw, [(gi, ci, False)], silent)

    def launch_bounds(self) -> dict:
        out = super().launch_bounds()
        out["correlate_cluster"] = cluster_bounds(self.session._bank, rows=1)
        return out
