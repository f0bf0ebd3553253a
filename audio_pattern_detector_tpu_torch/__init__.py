"""PyTorch/CUDA port of audio_pattern_detector_tpu.

The JAX package stays the reference. This package needs only ``torch``,
``numpy`` and its own sources: it keeps its own copies of the host modules
(clip loading, stream wrappers, the streaming loop, the exact host path,
the native host library's C++ source) and reimplements what runs on the
device in torch, with the lean tier's candidate scan as a hand-written
CUDA kernel (``csrc/``). It never imports jax or the JAX package. The
CUDA kernels and the native host library build at first use.

Entry points: ``python -m audio_pattern_detector_tpu_torch match ...`` and
``models.detector.TorchAudioPatternDetector``.
"""
