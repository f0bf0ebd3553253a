"""The ``loop(pred, body)`` hook of the plain greedy filters.

A JAX ``lax.while_loop`` becomes one body over state in tensors updated in
place, run by a :data:`Loop`: on the host :func:`host_loop`, in a captured
class step the backend's CUDA while node
(``models/captured.py::CudaGraphBackend.while_loop``).
"""

from __future__ import annotations

from collections.abc import Callable

import torch

# ``loop(pred, body)``: run ``body()`` while the 0-d device bool ``pred``
# holds, ``body`` rewriting ``pred`` in place.
Loop = Callable[[torch.Tensor, Callable[[], None]], None]


def host_loop(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """The host's :data:`Loop`: one sync a pass, to read ``pred``."""
    while bool(pred):
        body()
