"""PyTorch/CUDA port of audio_pattern_detector_tpu.

The JAX package stays the reference; this package reuses its jax-free host
modules (clip loading, stream wrappers, the streaming loop, the exact host
path) and reimplements what runs on the device in torch, with the lean
tier's candidate scan as a hand-written CUDA kernel (``csrc/``). It never
imports jax.

Entry points: ``python -m audio_pattern_detector_tpu_torch match ...`` and
``models.detector.TorchAudioPatternDetector``.
"""
