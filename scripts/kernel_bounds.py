"""The least time of a kernel's work on an H100, shared by ``chip_smoke.py``
and ``scripts/profile_stages_torch.py``: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, as the kernels line's ``bound_ms`` counts them."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
WINDOW_BYTES = 516 * 4  # one lean greedy window of 516 f32 samples


def scan_bound_ms(g: int, l: int, valid_len) -> float:
    """The least time of one scan on the card: the bytes the function needs
    (each row's valid samples and the thresholds read once, and the lengths
    where they are per row; the block maxima and four (G,) stats written
    once) over the memory rate. Its operations (a few compares a sample)
    bound it far lower. ``valid_len`` is an int or a (G,) tensor."""
    if isinstance(valid_len, int):
        n_read = g * min(valid_len, l) * 4 + g * 4
    else:
        n_read = int(valid_len.clamp(0, l).sum()) * 4 + 2 * g * 4
    n_written = g * -(-l // 512) * 4 + 4 * g * 4
    return (n_read + n_written) / HBM_BYTES_PER_S * 1e3


def lean_greedy_bound(args, out) -> tuple[float, str, int]:
    """(bound ms, what bounds it, windows read) of one lean greedy call: the
    bytes this input needs (the block maxima, the normalisers and per-row
    lengths read once; the windows of 516 samples its rounds read, three a
    kept survivor and one a refused round; the outputs written once) over
    the memory rate. Its operations (a few compares a window sample) are
    below that."""
    import torch

    corr, valid_len, bmax, denom, _hm, _m, r_max = args
    _pos, height, overflow = out
    g = corr.shape[0]
    kept = torch.isfinite(height).sum(dim=1)
    refused = overflow & (kept < r_max)
    windows = int(3 * kept.sum() + refused.sum())
    nbytes = (bmax.numel() * 4 + g * 4 + (g * 4 if isinstance(valid_len, torch.Tensor) else 0)
              + windows * WINDOW_BYTES + g * r_max * 12 + g)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", windows
