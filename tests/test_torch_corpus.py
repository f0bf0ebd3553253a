"""Level (b) on the rest of ``sample_audios/``: the port's ``match_pattern``
on the CPU against the JAX package's, exactly.

The JAX package's own tests read these inputs with a tolerance (±0.02 s in
tests/test_real_data_regressions.py); here every timestamp and the total
must be equal, since both packages turn the same integer positions into
times with the same host algebra:

* the 17 ``CASES`` of tests/test_real_data_regressions.py (real broadcast
  captures, false-positive files among them), imported, not copied;
* ``am1430_section_with_rainbow_intro.wav`` against its intro clip;
* both ``test_16khz/`` sections (the resample path) against
  ``rthk_beep.apd.toml``, ``cbs_news_16k.wav`` and ``cbs_news_dada_16k.wav``;
* ``test_generated/interleaved_patterns.wav`` with both of its clips in one
  bank.

And the CLI: a regression directory in multi-file mode and a 16 kHz input
print byte-identical stdout through both CLIs.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_corpus.py -q``.
"""

import contextlib
import glob
import io
import os
import sys

import pytest
import torch

from audio_pattern_detector_tpu import cli as jcli
from audio_pattern_detector_tpu.match import match_pattern as jax_match_pattern
from audio_pattern_detector_tpu_torch import cli
from audio_pattern_detector_tpu_torch.match import match_pattern
from tests.conftest import SAMPLE_AUDIOS
from tests.test_real_data_regressions import CASES, RTHK, STRAY_V2

torch.set_num_threads(1)

CLIPS = os.path.join(SAMPLE_AUDIOS, "clips")
K16 = os.path.join(SAMPLE_AUDIOS, "test_16khz")
GENERATED = os.path.join(SAMPLE_AUDIOS, "test_generated")

OTHER_CASES = [
    ([os.path.join(CLIPS, "天空下的彩虹intro.wav")],
     os.path.join(SAMPLE_AUDIOS, "am1430_section_with_rainbow_intro.wav")),
    *[([pattern], os.path.join(K16, section))
      for section in ("rthk_section_with_beep_16k.wav", "cbs_news_audio_section_16k.wav")
      for pattern in (RTHK, os.path.join(K16, "clips", "cbs_news_16k.wav"),
                      os.path.join(K16, "clips", "cbs_news_dada_16k.wav"))],
    (sorted(glob.glob(os.path.join(GENERATED, "clips", "*.wav"))),
     os.path.join(GENERATED, "interleaved_patterns.wav")),
]


def _name(path):
    return os.path.relpath(path, SAMPLE_AUDIOS)


def _both(patterns, audio):
    """(port, JAX) results of ``match_pattern``: detections by clip and the
    total seconds."""
    return (match_pattern(audio, patterns, device="cpu"), jax_match_pattern(audio, patterns))


@pytest.mark.parametrize(
    "pattern,audio,expected", CASES,
    ids=[f"{os.path.basename(a)}/{os.path.basename(p)}" for p, a, _ in CASES],
)
def test_regression_case_exactly_as_jax(pattern, audio, expected):
    (peaks, total), (jpeaks, jtotal) = _both([pattern], audio)
    assert peaks == jpeaks and total == jtotal
    assert len([t for ts in peaks.values() for t in ts]) == len(expected)


@pytest.mark.parametrize(
    "patterns,audio", OTHER_CASES,
    ids=[f"{_name(a)}/{'+'.join(os.path.basename(p) for p in ps)}" for ps, a in OTHER_CASES],
)
def test_other_inputs_exactly_as_jax(patterns, audio):
    (peaks, total), (jpeaks, jtotal) = _both(patterns, audio)
    assert peaks == jpeaks and total == jtotal
    assert set(peaks) == {os.path.basename(p).split(".")[0] for p in patterns}


def _port_stdout(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["match", "--device", "cpu", *argv])
    return out.getvalue()


def _jax_stdout(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["audio-pattern-detector-tpu", "match", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.suppress(SystemExit):
        jcli.main()
    return out.getvalue()


@pytest.mark.parametrize("patterns,audios", [
    ([RTHK], sorted(glob.glob(os.path.join(STRAY_V2, "*.wav")))),
    ([RTHK, os.path.join(K16, "clips", "cbs_news_16k.wav")],
     [os.path.join(K16, "rthk_section_with_beep_16k.wav")]),
], ids=["regression_dir_multi_file", "16khz_input"])
def test_cli_stdout_byte_identical_to_jax(patterns, audios, monkeypatch):
    argv = [arg for p in patterns for arg in ("--pattern-file", p)] + audios
    port = _port_stdout(argv)
    assert port == _jax_stdout(argv, monkeypatch)
    assert port.count('"type": "start"') == len(audios) and '"pattern_detected"' in port
