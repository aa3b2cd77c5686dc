"""JSON manifest generation (the reference's preprocess stage).

Scans wav directories and records (absolute_path, n_samples) per file into
<split>/<speaker>.json, exactly the manifest format the reference datasets
consume (preprocess.py:12-34, data.py:43-51). Sample counts are computed
from WAV headers — no full decode, unlike the reference which
librosa-loads every file just to count samples (preprocess.py:20)."""

from __future__ import annotations

import json
import os
import struct
import wave
from typing import List, Optional, Tuple


def wav_num_samples(path: str, sample_rate: Optional[int] = None) -> int:
    """Sample count (per channel) from the WAV header — PCM and IEEE-float
    formats (stdlib wave rejects float). If sample_rate is given and differs
    from the file rate, returns the post-resample count (ceil(T * target /
    orig), matching polyphase output length)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate = n_ch = bits = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                body = f.read(size + (size & 1))
                _, n_ch, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                data_size = size
                f.seek(size + (size & 1), 1)
            else:
                f.seek(size + (size & 1), 1)
    if rate is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    n = data_size // (n_ch * (bits // 8))
    if sample_rate is not None and rate != sample_rate:
        n = -(-n * sample_rate // rate)
    return n


def preprocess_one_dir(in_dir: str, out_dir: str, out_filename: str,
                       sample_rate: int = 8000) -> str:
    """Write <out_dir>/<out_filename>.json of (path, n_samples) entries
    (preprocess.py:12-25). Returns the json path."""
    in_dir = os.path.abspath(in_dir)
    infos: List[Tuple[str, int]] = []
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(".wav"):
            continue
        path = os.path.join(in_dir, name)
        infos.append((path, wav_num_samples(path, sample_rate)))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, out_filename + ".json")
    with open(out_path, "w") as f:
        json.dump(infos, f, indent=4)
    return out_path


def preprocess(in_dir: str, out_dir: str, sample_rate: int = 8000,
               splits=("tr", "cv", "tt"), speakers=("mix", "s1", "s2")) -> None:
    """Full dataset prep: {tr,cv,tt} x {mix,s1,s2} (preprocess.py:28-34)."""
    for split in splits:
        for spk in speakers:
            preprocess_one_dir(
                os.path.join(in_dir, split, spk),
                os.path.join(out_dir, split),
                spk,
                sample_rate=sample_rate,
            )


def load_manifest(json_path: str) -> List[Tuple[str, int]]:
    with open(json_path) as f:
        return [(p, int(n)) for p, n in json.load(f)]
