"""ctypes binding of the native C++ batch WAV decoder (native/wavloader.cpp).

The port's copy of convtasnet_tpu/data/native_loader.py, over the port's
own build (data/_native.py: built with g++ on first use into
convtasnet_torch/_native_build/; WAVLOADER_SO may point at a prebuilt
library). It exposes

    decode_batch(paths, max_samples, n_threads) -> (buf [n, max], lengths, rates)

AudioDataset uses it when it is available; a file at another rate, or a
machine without a toolchain, goes through the pure-Python codec (wavio.py),
which resamples.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ._native import NativeLib


def _configure(lib: ctypes.CDLL) -> None:
    lib.wav_decode_batch.restype = ctypes.c_int
    lib.wav_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]


_NATIVE = NativeLib("wavloader.cpp", "libwavloader.so", "WAVLOADER_SO", _configure,
                    extra_flags=("-pthread",))


def get_lib():
    """Load (building if needed) the native library, or None."""
    return _NATIVE.get()


def available() -> bool:
    return get_lib() is not None


def decode_batch(paths: List[str], max_samples: int, n_threads: int = 4
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of wav files to mono float32 on C++ threads.

    Returns (buf [n, max_samples], lengths [n], rates [n]). Raises
    RuntimeError if any file fails to decode."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native wavloader unavailable")
    n = len(paths)
    buf = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros(n, np.int64)
    rates = np.zeros(n, np.uint32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.wav_decode_batch(
        arr, n, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(max_samples),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_threads)
    if rc != 0:
        bad = [paths[i] for i in range(n) if lengths[i] < 0]
        raise RuntimeError(f"native wav decode failed for: {bad[:3]}")
    return buf, lengths, rates
