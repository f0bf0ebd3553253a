"""Audio I/O and host DSP utilities.

Functional parity with the reference's audio utility layer
(reference: audio_pattern_detector/audio_utils.py), re-homed for the TPU
framework: all decode paths produce float32 mono PCM in [-1, 1] and the
FFT resampler delegates to the hostref exact implementation.
"""

from __future__ import annotations

import math
import subprocess
import sys
from collections.abc import Generator
from contextlib import contextmanager
from typing import IO, Any, TypeVar

import numpy as np
from numpy.typing import NDArray

from audio_pattern_detector_tpu_torch.ops import hostref

# All clips and streams must share one rate for matching to work
# (reference: audio_utils.py:13).
DEFAULT_TARGET_SAMPLE_RATE = 8000

_ffmpeg_available: bool | None = None


def is_ffmpeg_available() -> bool:
    """True when an ffmpeg binary is runnable (cached)."""
    global _ffmpeg_available
    if _ffmpeg_available is not None:
        return _ffmpeg_available
    try:
        subprocess.run(["ffmpeg", "-version"], capture_output=True, check=True)
        _ffmpeg_available = True
    except (subprocess.CalledProcessError, FileNotFoundError):
        _ffmpeg_available = False
    return _ffmpeg_available


def _decode_wav(wav_file: "str | IO[bytes]", source_name: str) -> tuple[NDArray[Any], int]:
    """Read a WAV via the stdlib wave module into a raw numpy array."""
    import wave

    try:
        with wave.open(wav_file, "rb") as wf:
            sample_rate = wf.getframerate()
            n_channels = wf.getnchannels()
            sampwidth = wf.getsampwidth()
            raw = wf.readframes(wf.getnframes())
    except Exception as e:  # noqa: BLE001 — uniform error contract
        raise ValueError(f"Failed to read WAV data from {source_name}: {e}") from e

    if sampwidth == 1:
        data: NDArray[Any] = np.frombuffer(raw, dtype=np.uint8)
    elif sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16)
    elif sampwidth == 3:
        # 24-bit: assemble little-endian triplets into sign-extended int32,
        # left-shifted so the usual /2^31 normalisation applies.
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32[b[:, 2] >= 0x80] -= 1 << 24
        data = i32 << 8
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype=np.int32)
    else:
        raise ValueError(f"Unsupported sample width {sampwidth} in {source_name}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data, sample_rate


def _to_float32_mono(data: NDArray[Any], source_name: str) -> NDArray[np.float32]:
    """Normalise raw WAV samples to float32 [-1, 1], mean-mixing to mono."""
    if data.dtype == np.int16:
        out = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        out = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.float32:
        out = data.view(np.float32)
    elif data.dtype == np.float64:
        out = data.astype(np.float32)
    elif data.dtype == np.uint8:
        out = (data.astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV dtype in {source_name}: {data.dtype}")
    if out.ndim > 1:
        out = out.mean(axis=1).astype(np.float32)
    return out


def load_wav_file(file_path: str) -> tuple[NDArray[np.float32], int]:
    """Load a WAV file as (float32 mono in [-1, 1], sample_rate)."""
    data, sample_rate = _decode_wav(file_path, f"file {file_path}")
    return _to_float32_mono(data, f"file {file_path}"), sample_rate


def load_wav_from_bytes(wav_bytes: bytes, name: str = "bytes") -> tuple[NDArray[np.float32], int]:
    """Load WAV content from bytes as (float32 mono, sample_rate)."""
    import io

    data, sample_rate = _decode_wav(io.BytesIO(wav_bytes), name)
    return _to_float32_mono(data, name), sample_rate


def resample_audio(
    audio: NDArray[np.float32], orig_sr: int, target_sr: int
) -> NDArray[np.float32]:
    """FFT-resample audio between rates (no-op when rates match)."""
    if orig_sr == target_sr:
        return audio
    num_samples = int(len(audio) * target_sr / orig_sr)
    return hostref.resample(audio, num_samples)


_FloatT = TypeVar("_FloatT", bound=np.floating[Any])


def slicing_with_zero_padding(
    array: NDArray[_FloatT], width: int, middle_index: int
) -> NDArray[_FloatT]:
    """Center slice of ``width`` around ``middle_index`` with zero padding.

    Asymmetric floor/ceil split so odd widths keep the middle sample centred
    (reference: audio_utils.py:177-191).
    """
    beg = int(middle_index - math.floor(width / 2))
    end = int(middle_index + math.ceil(width / 2))
    out = np.zeros(end - beg, dtype=array.dtype)
    lo, hi = max(beg, 0), min(end, len(array))
    if hi > lo:
        out[lo - beg : hi - beg] = array[lo:hi]
    return out


def load_wave_file(file_path: str, expected_sample_rate: int) -> NDArray[np.float32]:
    """Load any audio file to float32 at ``expected_sample_rate``.

    WAVs decode natively (with FFT resample if needed); other formats
    require ffmpeg.
    """
    if file_path.lower().endswith(".wav"):
        data, sample_rate = load_wav_file(file_path)
        if sample_rate != expected_sample_rate:
            data = resample_audio(data, sample_rate, expected_sample_rate)
        return data
    if not is_ffmpeg_available():
        raise ValueError(
            f"ffmpeg not available and file {file_path} is not a WAV file. "
            "Install ffmpeg or use WAV files for patterns."
        )
    with ffmpeg_get_float32_pcm(file_path, target_sample_rate=expected_sample_rate, ac=1) as stdout:
        raw = stdout.read()
    return np.frombuffer(raw, dtype=np.float32)


def resample_preserve_maxima(
    curve: NDArray[np.floating[Any]], num_samples: int
) -> NDArray[np.float32]:
    """Window-max resample of a curve to ``num_samples`` points."""
    curve_f32 = np.ascontiguousarray(curve, dtype=np.float32)
    return hostref.resample_preserve_maxima(curve_f32, num_samples)


def _ffmpeg_decode_cmd(
    source: str,
    target_sample_rate: int | None,
    ac: int | None,
    from_stdin: bool,
    input_format: str | None,
) -> list[str]:
    """ffmpeg argv decoding ``source`` to f32le PCM on stdout."""
    inp = (
        (["-f", input_format] if input_format else []) + ["-i", "pipe:0"]
        if from_stdin
        else ["-i", source]
    )
    opts = ["-f", "f32le", "-acodec", "pcm_f32le"]
    if ac is not None:
        opts += ["-ac", str(ac)]
    if target_sample_rate is not None:
        opts += ["-ar", str(target_sample_rate)]
    return ["ffmpeg", *inp, *opts, "-loglevel", "error", "pipe:"]


@contextmanager
def ffmpeg_get_float32_pcm(
    full_audio_path: str,
    target_sample_rate: int | None = None,
    ac: int | None = None,
    from_stdin: bool = False,
    input_format: str | None = None,
) -> Generator[IO[bytes], None, None]:
    """Stream float32 little-endian PCM from an ffmpeg child process."""
    process = None
    finished = False
    try:
        process = subprocess.Popen(
            _ffmpeg_decode_cmd(
                full_audio_path, target_sample_rate, ac, from_stdin, input_format
            ),
            stdin=sys.stdin.buffer if from_stdin else None,
            stdout=subprocess.PIPE,
        )
        assert process.stdout is not None
        yield process.stdout
        finished = True
        if process.wait() != 0:
            raise ValueError(f"ffmpeg command failed with return code {process.returncode}")
    finally:
        if process is not None and process.stdout is not None:
            process.stdout.close()
        if process is not None and not finished:
            # The with-body raised before the clean wait: without an
            # explicit terminate + wait the child runs until SIGPIPE and
            # lingers as a zombie — a long-lived serve/library process
            # would accumulate defunct children across failed decodes.
            try:
                process.terminate()
            except OSError:
                pass
            try:
                process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait()


def write_wav_file(
    filepath: str, audio_data: NDArray[np.float32], sample_rate: int
) -> None:
    """Write float32 mono audio in [-1, 1] to a 16-bit PCM WAV file.

    Pure-stdlib writer. The reference shells out to ffmpeg, whose WAV muxer
    defaults to pcm_s16le (reference: audio_utils.py:294-322); writing int16
    directly matches that output without a subprocess.
    """
    import wave

    scaled = np.clip(np.asarray(audio_data, dtype=np.float64) * 32768.0, -32768.0, 32767.0)
    pcm = np.round(scaled).astype(np.int16)
    with wave.open(filepath, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def get_audio_duration(audio_path: str) -> float | None:
    """Duration in seconds via ffprobe (None when indeterminate)."""
    result = subprocess.run(
        [
            "ffprobe", "-v", "error",
            "-show_entries", "format=duration",
            "-of", "default=noprint_wrappers=1:nokey=1",
            audio_path,
        ],
        capture_output=True,
        text=True,
    )
    if result.returncode != 0:
        raise ValueError(f"ffprobe failed: {result.stderr}")
    value = result.stdout.strip()
    if not value or value == "N/A":
        return None
    return float(value)
