"""WAV file I/O and resampling, dependency-free (numpy + stdlib).

The reference leans on librosa/soundfile (data.py:254-256, separate.py:57,
preprocess.py:20); neither ships in this environment, so the framework
carries its own RIFF/WAVE codec:

* read_wav: PCM 8/16/24/32-bit and IEEE float32/64, mono-ized by channel
  averaging and scaled to [-1, 1] float32 (librosa.load conventions), with
  optional polyphase resampling to a target rate.
* write_wav: PCM_16 output matching the reference's separate CLI
  (separate.py:57) plus float32 for lossless round-trips.
* resample: windowed-sinc polyphase (Kaiser beta 8.555, cutoff at the
  target Nyquist), the same design librosa's default resampler family uses.
"""

from __future__ import annotations

import math
import os
import struct
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(
    path: str,
    sample_rate: Optional[int] = None,
    mono: bool = True,
) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1], sample_rate).

    If sample_rate is given and differs from the file's rate, the audio is
    resampled. Multi-channel audio is averaged to mono when mono=True
    (librosa.load behavior), otherwise returned as [T, ch].
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits != 32 else 3

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            as32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as32 = (as32 << 8) >> 8  # sign-extend
            x = as32.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
        if mono:
            x = x.mean(axis=1)
    if sample_rate is not None and sample_rate != rate:
        x = resample(x, rate, sample_rate)
        rate = sample_rate
    return np.ascontiguousarray(x, dtype=np.float32), rate


def write_wav(path: str, x: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    """Write mono/[T, ch] float audio. subtype: PCM_16 (clipped, like the
    reference separate.py:57) or FLOAT."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n_ch = x.shape[1]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if subtype == "PCM_16":
        pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(n_ch)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
    elif subtype == "FLOAT":
        body = x.astype("<f4").tobytes()
        hdr = struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + len(body), b"WAVE", b"fmt ", 16,
            3, n_ch, sample_rate, sample_rate * 4 * n_ch, 4 * n_ch, 32,
            b"data", len(body),
        )
        with open(path, "wb") as f:
            f.write(hdr + body)
    else:
        raise ValueError(f"unsupported subtype {subtype}")


def resample(x: np.ndarray, orig_sr: int, target_sr: int, zeros: int = 24,
             beta: float = 8.555) -> np.ndarray:
    """Polyphase windowed-sinc resampling along axis 0 (librosa
    res_type='polyphase' design: Kaiser-windowed sinc, cutoff at the lower
    Nyquist), executed by scipy's polyphase engine."""
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    cutoff = 0.5 / max(up, down)
    half = zeros * max(up, down)
    n = np.arange(-half, half + 1)
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.kaiser(2 * half + 1, beta)
    y = resample_poly(x.astype(np.float64), up, down, axis=0, window=h)
    return y.astype(np.float32)
