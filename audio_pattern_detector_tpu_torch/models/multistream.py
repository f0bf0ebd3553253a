"""Multi-stream serving on one torch device: N live streams, one dispatch per round.

Port of audio_pattern_detector_tpu/models/multistream.py. Each round
batches one chunk from every active stream through the port bank's
independent-lookback batch dispatch
(``PatternBank.dispatch_chunks_batch(prev_tails=...)``): per-stream
lookback, timestamp algebra and flagged-row resolution are the serial
engine's, so each stream's detections equal its serial run's.

The JAX session's round logic is host code and is reused by subclass:
``feed``, ``dispatch``/``collect`` with any number of rounds in flight,
``round_ready``, the compacted tile-width ladder, int16 chunks riding
through raw, zero-length chunks as idle rounds, ``total_time`` and
``reset``. The port overrides what would reach jax: the constructor
refuses ``mesh`` (stream sharding is not ported) and the ``vmap`` batch
mode, and ``checkpoint`` decodes an int16 tail with ``native``.
"""

from __future__ import annotations

from typing import Any

from audio_pattern_detector_tpu.models.detector import StreamCheckpoint
from audio_pattern_detector_tpu.models.multistream import (
    MultiStreamSession as _JaxMultiStreamSession,
)
from audio_pattern_detector_tpu_torch.models.detector import (
    TorchAudioPatternDetector,
    _f32_copy,
)


class MultiStreamSession(_JaxMultiStreamSession):
    """Batch one chunk from each of N independent streams per dispatch.

    ``feed`` takes one chunk (or ``None``) per stream and returns each
    stream's ``{clip_name: [timestamps]}``; ``dispatch``/``collect`` keep
    several rounds in flight. With ``tile`` set, a round's active rows
    dispatch as a greedy decomposition over the tile and every power of
    two below it, and ``collect`` scatters the rows back to their slots.
    """

    def __init__(
        self,
        detector: TorchAudioPatternDetector,
        n_streams: int,
        mesh: Any = None,
        batch_mode: str | None = None,
        tile: int | None = None,
    ) -> None:
        if mesh is not None:
            raise ValueError("mesh is not supported by the torch port yet")
        if batch_mode == "vmap":
            raise ValueError("batch_mode='vmap' is not supported by the torch port yet")
        if not isinstance(detector, TorchAudioPatternDetector):
            raise TypeError(
                f"the torch port's session needs a TorchAudioPatternDetector, "
                f"got {type(detector).__name__}"
            )
        super().__init__(detector, n_streams, batch_mode=batch_mode, tile=tile)

    def checkpoint(self, stream: int) -> StreamCheckpoint:
        """O(1) resume state for one stream. An int16 tail (the raw
        serving path) decodes to the f32 samples ``StreamCheckpoint``
        holds, bitwise as the device decodes it."""
        tail = self._tails[stream]
        return StreamCheckpoint(
            self._indices[stream],
            None if tail is None else _f32_copy(tail),
            self._times[stream],
        )
