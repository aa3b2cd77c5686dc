"""Synthetic multi-speaker mixtures for tests, benchmarks, and smoke e2e.

Each "speaker" is a harmonic tone stack with a random fundamental, AM
envelope, and onset pattern — spectrally disjoint enough that a small model
separates them quickly, which makes loss-goes-down e2e tests meaningful.
Can also materialize a full wav dataset tree (tr/cv/tt x mix/s1..sC) plus
JSON manifests in the reference's format, to exercise the real data
pipeline and CLIs end-to-end.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .manifest import preprocess
from .wavio import write_wav


def synthetic_sources(
    rng: np.random.Generator, C: int, T: int, sample_rate: int = 8000
) -> np.ndarray:
    """Generate [C, T] float32 sources with disjoint fundamentals."""
    t = np.arange(T) / sample_rate
    out = np.zeros((C, T), np.float32)
    for c in range(C):
        f0 = rng.uniform(80, 220) * (1.6**c)
        sig = np.zeros(T)
        for h in range(1, 4):
            sig += rng.uniform(0.2, 1.0) / h * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)
            )
        env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(0.7, 2.5) * t
                                   + rng.uniform(0, 2 * np.pi))
        out[c] = (sig * env * 0.25).astype(np.float32)
    return out


def synthetic_batch(
    rng: np.random.Generator, batch: int, C: int, T: int, sample_rate: int = 8000
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mixture [B, T], lengths [B], sources [B, C, T]) numpy batch."""
    src = np.stack([synthetic_sources(rng, C, T, sample_rate) for _ in range(batch)])
    mix = src.sum(axis=1)
    lengths = np.full(batch, T, np.int32)
    return mix.astype(np.float32), lengths, src.astype(np.float32)


def make_wav_dataset(
    out_dir: str,
    n_utts: int = 8,
    C: int = 2,
    sample_rate: int = 8000,
    min_sec: float = 2.0,
    max_sec: float = 5.0,
    seed: int = 0,
    splits=("tr", "cv", "tt"),
) -> str:
    """Write a tiny on-disk dataset in the reference layout and manifest it.

    Returns the manifest root (out_dir/json)."""
    rng = np.random.default_rng(seed)
    wav_root = os.path.join(out_dir, "wav")
    for split in splits:
        for d in ["mix"] + [f"s{i+1}" for i in range(C)]:
            os.makedirs(os.path.join(wav_root, split, d), exist_ok=True)
        for u in range(n_utts):
            T = int(rng.uniform(min_sec, max_sec) * sample_rate)
            src = synthetic_sources(rng, C, T, sample_rate)
            mix = src.sum(axis=0)
            name = f"utt{u:03d}.wav"
            write_wav(os.path.join(wav_root, split, "mix", name), mix, sample_rate, "FLOAT")
            for c in range(C):
                write_wav(
                    os.path.join(wav_root, split, f"s{c+1}", name), src[c], sample_rate, "FLOAT"
                )
    json_root = os.path.join(out_dir, "json")
    preprocess(wav_root, json_root, sample_rate, splits=splits,
               speakers=["mix"] + [f"s{i+1}" for i in range(C)])
    return json_root
