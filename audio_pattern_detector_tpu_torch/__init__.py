"""PyTorch/CUDA port of audio_pattern_detector_tpu.

The JAX package stays the reference. This package needs only ``torch``,
``numpy`` and its own sources: it keeps its own copies of the host modules
(clip loading, stream wrappers, the streaming loop, the exact host path,
the native host library's C++ source) and reimplements what runs on the
device in torch, with the lean tier's candidate scan as a hand-written
CUDA kernel (``csrc/``). It never imports jax or the JAX package. The
CUDA kernels and the native host library build at first use; importing
the package builds and loads nothing and does not touch CUDA.

The library surface is the JAX package's, under the same names
(``AudioPatternDetector`` is the port's detector, also importable as
``TorchAudioPatternDetector``; it takes a torch ``device``, ``cuda`` by
default). Command line: ``python -m audio_pattern_detector_tpu_torch match
| serve | show-config``.
"""

from audio_pattern_detector_tpu_torch.models.detector import (
    DEFAULT_SECONDS_PER_CHUNK,
    MARKER_TONE_STRATEGY,
    SHORT_CLIP_DURATION_THRESHOLD,
    PatternDetectedCallback,
    StreamCheckpoint,
    TorchAudioPatternDetector,
)
from audio_pattern_detector_tpu_torch.models.multistream import MultiStreamSession
from audio_pattern_detector_tpu_torch.utils.clip import AudioClip, AudioStream

AudioPatternDetector = TorchAudioPatternDetector

__version__ = "0.1.0"


def __getattr__(name: str):
    # Lazy: the serving layer pulls in the whole orchestration module
    # (match.py); library users who never serve shouldn't pay for it.
    if name == "PatternServer":
        from audio_pattern_detector_tpu_torch.serve import PatternServer

        return PatternServer
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


__all__ = [
    "AudioClip",
    "AudioStream",
    "AudioPatternDetector",
    "TorchAudioPatternDetector",
    "MultiStreamSession",
    "PatternServer",
    "PatternDetectedCallback",
    "StreamCheckpoint",
    "DEFAULT_SECONDS_PER_CHUNK",
    "SHORT_CLIP_DURATION_THRESHOLD",
    "MARKER_TONE_STRATEGY",
    "__version__",
]
