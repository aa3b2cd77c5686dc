"""NIST SPHERE audio reading + corpus conversion (the sph2pipe analogue).

The reference's recipe stage 0 shells out to the third-party sph2pipe C tool
(reference tools/Makefile:9-11, egs/wsj0/local/data_prepare.sh:16-33) to turn
LDC SPHERE files (.wv1/.wv2/.sph) into wav. Here that capability is part of
the framework: a native C++ decoder (native/sphio.cpp — header parsing, pcm /
mu-law / a-law, and embedded-shorten-v2 decompression) bound via ctypes, with
a pure-Python fallback for the uncompressed codings when no toolchain exists.
The port's copy of convtasnet_tpu/data/sphio.py, over the port's own build
of native/sphio.cpp (data/_native.py; SPHIO_SO may point at a prebuilt
library).

    read_sphere(path)            -> (float32 [T] or [T, ch] in [-1, 1], sr)
    convert_sphere_dir(src, dst) -> parallel .wv1/.sph -> .wav tree conversion
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ._native import NativeLib

_ERRORS = {
    -1: "I/O error",
    -2: "not a NIST SPHERE file / malformed header",
    -3: "unsupported sample_coding",
    -4: "corrupt shorten bitstream",
    -5: "output capacity exceeded",
}

SPHERE_EXTENSIONS = (".wv1", ".wv2", ".sph")


def _configure(lib: ctypes.CDLL) -> None:
    lib.sph_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sph_info.restype = ctypes.c_int
    lib.sph_decode.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    lib.sph_decode.restype = ctypes.c_int64


_NATIVE = NativeLib("sphio.cpp", "libsphio.so", "SPHIO_SO", _configure)


def _get_lib():
    return _NATIVE.get()


def native_available() -> bool:
    return _get_lib() is not None


def sphere_info(path: str) -> Tuple[int, int, int]:
    """(channels, sample_rate, sample_count) from the SPHERE header."""
    lib = _get_lib()
    if lib is not None:
        ch = ctypes.c_int32()
        sr = ctypes.c_int32()
        ns = ctypes.c_int64()
        rc = lib.sph_info(path.encode(), ctypes.byref(ch), ctypes.byref(sr),
                          ctypes.byref(ns))
        if rc != 0:
            raise ValueError(f"{path}: {_ERRORS.get(rc, rc)}")
        return ch.value, sr.value, ns.value
    hdr = _parse_header_py(path)
    return hdr["channel_count"], hdr["sample_rate"], hdr["sample_count"]


def read_sphere_int16(path: str) -> Tuple[np.ndarray, int]:
    """Decodes a SPHERE file to exact int16 PCM; [T] mono or [T, ch]."""
    channels, rate, sample_count = sphere_info(path)
    lib = _get_lib()
    if lib is not None:
        if sample_count <= 0:
            # Header lacks sample_count: for non-compressed codings the
            # native decoder derives the length from the payload size, so
            # size the capacity the same way instead of failing with
            # SPH_ERR_CAPACITY (shorten payloads have no usable bound —
            # let the decoder report the bitstream error itself).
            hdr = _parse_header_py(path)
            if "shorten" not in hdr["sample_coding"]:
                payload = os.path.getsize(path) - hdr["header_bytes"]
                sample_count = max(payload // max(hdr["sample_n_bytes"], 1)
                                   // channels, 0)
        cap = max(sample_count, 1) * channels
        out = np.empty(cap, dtype=np.int16)
        frames = lib.sph_decode(path.encode(), out, cap)
        if frames < 0:
            raise ValueError(f"{path}: {_ERRORS.get(int(frames), frames)}")
        pcm = out[: frames * channels]
    else:
        pcm = _decode_py(path)
        frames = pcm.size // channels
        pcm = pcm[: frames * channels]  # drop a truncated trailing frame
    if channels > 1:
        pcm = pcm.reshape(frames, channels)
    return pcm, rate


def read_sphere(path: str) -> Tuple[np.ndarray, int]:
    """Decodes a SPHERE file to float32 in [-1, 1]; mono files return [T]."""
    pcm, rate = read_sphere_int16(path)
    return pcm.astype(np.float32) / 32768.0, rate


# ---------------------------------------------------------------------------
# Pure-Python fallback (pcm / ulaw / alaw only; shorten requires the native
# decoder — a Python bit-reader would be orders of magnitude too slow for
# corpus conversion anyway).
# ---------------------------------------------------------------------------

def _parse_header_py(path: str) -> dict:
    with open(path, "rb") as f:
        head = f.read(16)
        if not head.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        hsize = int(head[8:16].split(b"\n")[0].strip())
        f.seek(0)
        text = f.read(hsize).decode("ascii", errors="replace")
    out = {
        "header_bytes": hsize, "channel_count": 1, "sample_rate": 0,
        "sample_count": 0, "sample_n_bytes": 2, "sample_byte_format": "10",
        "sample_coding": "pcm",
    }
    for line in text.splitlines()[2:]:
        if line.startswith("end_head"):
            break
        parts = line.split(" ", 2)
        if len(parts) != 3:
            continue
        name, typ, value = parts
        if name in ("channel_count", "sample_rate", "sample_count",
                    "sample_n_bytes"):
            out[name] = int(value)
        elif name in ("sample_byte_format", "sample_coding"):
            out[name] = value
    return out


_ULAW_TABLE: Optional[np.ndarray] = None
_ALAW_TABLE: Optional[np.ndarray] = None


def _ulaw_table() -> np.ndarray:
    global _ULAW_TABLE
    if _ULAW_TABLE is None:
        t = np.zeros(256, dtype=np.int16)
        for i in range(256):
            u = ~i & 0xFF
            mag = (((u & 0x0F) << 3) + 0x84) << ((u >> 4) & 0x07)
            t[i] = (0x84 - mag) if (u & 0x80) else (mag - 0x84)
        _ULAW_TABLE = t
    return _ULAW_TABLE


def _alaw_table() -> np.ndarray:
    global _ALAW_TABLE
    if _ALAW_TABLE is None:
        t = np.zeros(256, dtype=np.int16)
        for i in range(256):
            a = i ^ 0x55
            mag = (a & 0x0F) << 4
            seg = (a & 0x70) >> 4
            if seg == 0:
                mag += 8
            elif seg == 1:
                mag += 0x108
            else:
                mag = (mag + 0x108) << (seg - 1)
            t[i] = mag if (a & 0x80) else -mag
        _ALAW_TABLE = t
    return _ALAW_TABLE


def _decode_py(path: str) -> np.ndarray:
    h = _parse_header_py(path)
    coding = h["sample_coding"]
    if "embedded-shorten" in coding:
        raise ValueError(
            f"{path}: shorten-compressed SPHERE needs the native decoder "
            "(native/sphio.cpp) — no C++ toolchain found")
    with open(path, "rb") as f:
        f.seek(h["header_bytes"])
        raw = f.read()
    declared = h["sample_count"] * h["channel_count"] or None
    if h["sample_n_bytes"] == 2:
        dt = "<i2" if h["sample_byte_format"] == "01" else ">i2"
        pcm = np.frombuffer(raw[: len(raw) // 2 * 2], dtype=dt).astype(np.int16)
        return pcm[:declared]
    b = np.frombuffer(raw, dtype=np.uint8)[:declared]
    if coding.startswith(("ulaw", "mu-law")):
        return _ulaw_table()[b]
    if coding.startswith("alaw"):
        return _alaw_table()[b]
    return (b.view(np.int8).astype(np.int16)) << 8


# ---------------------------------------------------------------------------
# Corpus conversion (the data_prepare.sh analogue)
# ---------------------------------------------------------------------------

def convert_sphere_file(src: str, dst: str) -> int:
    """SPHERE -> 16-bit wav, sample-exact (sph2pipe writes PCM through
    unchanged; so do we). Returns samples per channel written."""
    import wave

    pcm, sr = read_sphere_int16(src)
    frames = pcm.shape[0]
    n_ch = 1 if pcm.ndim == 1 else pcm.shape[1]
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with wave.open(dst, "wb") as w:
        w.setnchannels(n_ch)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(pcm, dtype="<i2").tobytes())
    return frames


def convert_sphere_dir(src_root: str, dst_root: str,
                       extensions: Tuple[str, ...] = SPHERE_EXTENSIONS,
                       n_threads: int = 8) -> List[str]:
    """Converts every SPHERE file under src_root, mirroring the tree.

    Reference analogue: the find/sph2pipe loop in
    egs/wsj0/local/data_prepare.sh:16-33. Returns the written wav paths.
    """
    jobs = []
    for dirpath, _, files in os.walk(src_root):
        for name in sorted(files):
            if not name.lower().endswith(extensions):
                continue
            src = os.path.join(dirpath, name)
            rel = os.path.relpath(src, src_root)
            dst = os.path.join(dst_root, os.path.splitext(rel)[0] + ".wav")
            jobs.append((src, dst))
    # ctypes releases the GIL during the native call, so threads scale.
    with ThreadPoolExecutor(max_workers=max(1, n_threads)) as ex:
        list(ex.map(lambda j: convert_sphere_file(*j), jobs))
    return [dst for _, dst in jobs]
