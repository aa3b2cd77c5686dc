"""Multi-speaker mixture creation (the MERL create-speaker-mixtures port).

The reference ships MATLAB scripts (tools/create-speaker-mixtures.zip,
tools/Makefile:16-17) that build wsj0-{2,3}mix: pairs of utterances mixed
at a random target SNR in [0, 5] dB after speech-active-level
normalization, in 'min' (truncate to shorter) and 'max' (pad to longer)
modes. This module provides the same capability in Python:

* ITU-T P.56 method-B active speech level (the MERL scripts normalize by
  voicebox `activlev`, which implements exactly this): cascaded
  exponential envelope, thresholds with 0.2 s hangover, and the 15.9 dB
  margin crossing found by bisection — see active_speech_level_p56. The
  earlier frame-energy stand-in is kept as active_speech_level_frame;
  the measured deviation between the two is documented in docs/parity.md
* pairing list either provided explicitly (path_a, path_b, snr_db) — the
  MERL recipe distributes such .txt lists — or generated from directories
  with a seeded RNG
* writes mix/s1/../sC trees compatible with preprocess/AudioDataset and
  returns the per-mixture metadata.

The port's copy of convtasnet_tpu/data/mixtures.py (numpy and scipy, over
the port's wavio).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .wavio import read_wav, write_wav


def active_speech_level_frame(x: np.ndarray, frame: int = 200,
                              threshold_db: float = -50.0) -> float:
    """RMS over frames whose energy is within threshold_db of the peak
    frame — the rounds-1-4 stand-in, kept for the parity measurement
    against the P.56 implementation below (docs/parity.md)."""
    n = (len(x) // frame) * frame
    if n == 0:
        return float(np.sqrt(np.mean(x**2)) + 1e-12)
    frames = x[:n].reshape(-1, frame)
    energy = np.mean(frames**2, axis=1)
    peak = energy.max()
    active = energy >= peak * (10 ** (threshold_db / 10))
    lvl = np.sqrt(energy[active].mean()) if active.any() else np.sqrt(energy.mean())
    return float(lvl + 1e-12)


def _p56_activity(q: np.ndarray, c: float, hang: int) -> int:
    """Sample count where envelope q >= c, each active run extended by a
    `hang`-sample hangover (P.56 §B.2.3: short pauses stay 'active')."""
    act = q >= c
    if not act.any():
        return 0
    n = len(q)
    last = np.where(act, np.arange(n), -n - hang)
    last = np.maximum.accumulate(last)
    return int(np.count_nonzero(np.arange(n) - last <= hang))


def active_speech_level_p56(
    x: np.ndarray,
    sample_rate: int = 8000,
    margin_db: float = 15.9,
    hangover_sec: float = 0.2,
    smooth_sec: float = 0.03,
) -> Tuple[float, float]:
    """ITU-T P.56 method-B active speech level.

    The published algorithm (also voicebox `activlev` / ITU STL `sv56`,
    which the MERL mixture scripts call; the reference's
    tools/Makefile:16-17): the speech envelope q is the |x| passed through two
    cascaded exponential smoothers with time constant 0.03 s; for a
    threshold c, the activity a(c) counts samples with q >= c, runs
    extended by a 0.2 s hangover; the active level A(c) = 10log10(E/a(c))
    (E = total energy) is compared against 20log10(c), and the reported
    level is where the margin A(c) - 20log10(c) crosses 15.9 dB —
    located here by bisection in log-threshold (the STL uses the same
    crossing on a fixed binary threshold ladder plus interpolation).

    Returns (active_rms, activity_factor) — linear RMS over the active
    samples and the active fraction of the signal. Degenerate inputs
    (all-zero / too short for the envelope) fall back to plain RMS with
    activity 1.
    """
    x = np.asarray(x, np.float64)
    n = x.size
    if n == 0:
        return 1e-12, 0.0
    energy = float(np.sum(x * x))
    if energy <= 0.0:
        return 1e-12, 0.0
    g = float(np.exp(-1.0 / (sample_rate * smooth_sec)))
    from scipy.signal import lfilter

    p = lfilter([1.0 - g], [1.0, -g], np.abs(x))
    q = lfilter([1.0 - g], [1.0, -g], p)
    hang = int(round(hangover_sec * sample_rate))

    def margin(c: float) -> float:
        a = _p56_activity(q, c, hang)
        if a == 0:
            return -np.inf  # threshold above the whole envelope
        return 10.0 * np.log10(energy / a) - 20.0 * np.log10(c)

    # Bracket the 15.9 dB crossing on the binary ladder c_j = qmax * 2^-j
    # (margin is monotone non-decreasing as c falls), then bisect.
    c_hi = float(q.max())
    if c_hi <= 0.0 or margin(c_hi) >= margin_db:
        # Envelope never exceeds the margin even at its peak (constant
        # or noise-like signal): everything is active.
        return float(np.sqrt(energy / n)), 1.0
    c_lo = c_hi
    for _ in range(60):
        c_lo *= 0.5
        if margin(c_lo) >= margin_db:
            break
    else:  # signal with no level structure at all: treat as fully active
        return float(np.sqrt(energy / n)), 1.0
    for _ in range(40):  # bisection in log-threshold
        c_mid = np.sqrt(c_lo * c_hi)
        if margin(c_mid) >= margin_db:
            c_lo = c_mid
        else:
            c_hi = c_mid
    a = _p56_activity(q, np.sqrt(c_lo * c_hi), hang)
    a = max(a, 1)
    return float(np.sqrt(energy / a)), float(a / n)


def active_speech_level(x: np.ndarray, sample_rate: int = 8000) -> float:
    """Speech level used for mixture SNR scaling: P.56 active RMS."""
    lvl, _ = active_speech_level_p56(x, sample_rate)
    return float(max(lvl, 1e-12))


def mix_pair(
    sources: Sequence[np.ndarray],
    snrs_db: Sequence[float],
    mode: str = "min",
    sample_rate: int = 8000,
) -> Tuple[np.ndarray, List[np.ndarray], float]:
    """Scale each source to its target SNR (relative to source 0) by P.56
    active speech level, then sum. mode: 'min' truncates to the shortest,
    'max' zero-pads to the longest. Returns (mixture, scaled_sources,
    gain) where gain is the common factor applied to keep |mix| <= 0.9."""
    assert len(sources) == len(snrs_db)
    scaled = []
    base_lvl = active_speech_level(sources[0], sample_rate)
    for x, snr in zip(sources, snrs_db):
        lvl = active_speech_level(x, sample_rate)
        target = base_lvl * (10 ** (-snr / 20.0))
        scaled.append(x * (target / lvl))
    if mode == "min":
        T = min(len(x) for x in scaled)
        scaled = [x[:T] for x in scaled]
    elif mode == "max":
        T = max(len(x) for x in scaled)
        scaled = [np.pad(x, (0, T - len(x))) for x in scaled]
    else:
        raise ValueError(f"mode must be min|max, got {mode}")
    mix = np.sum(scaled, axis=0)
    peak = np.abs(mix).max()
    gain = 0.9 / peak if peak > 0.9 else 1.0
    return mix * gain, [x * gain for x in scaled], gain


def create_mixtures(
    pair_list: Sequence[Tuple[Sequence[str], Sequence[float]]],
    out_dir: str,
    sample_rate: int = 8000,
    mode: str = "min",
    subtype: str = "PCM_16",
) -> List[dict]:
    """Materialize a mixture dataset.

    pair_list: sequence of (paths [C], snrs_db [C]); snr of source 0 is
    conventionally 0. Output tree: out_dir/{mix,s1..sC}/<name>.wav with
    name = '_'.join of source basenames + snrs (MERL naming convention).
    """
    meta = []
    for paths, snrs in pair_list:
        C = len(paths)
        srcs = [read_wav(p, sample_rate=sample_rate)[0] for p in paths]
        mix, scaled, gain = mix_pair(srcs, snrs, mode, sample_rate)
        stem = "_".join(
            f"{os.path.splitext(os.path.basename(p))[0]}_{snr:.4g}"
            for p, snr in zip(paths, snrs)
        )
        write_wav(os.path.join(out_dir, "mix", stem + ".wav"), mix,
                  sample_rate, subtype)
        for c in range(C):
            write_wav(os.path.join(out_dir, f"s{c+1}", stem + ".wav"),
                      scaled[c], sample_rate, subtype)
        meta.append({"name": stem, "paths": list(paths),
                     "snrs_db": list(snrs), "gain": gain,
                     "n_samples": int(len(mix))})
    return meta


def random_pair_list_from_files(
    files: Sequence[str],
    n_mixtures: int,
    C: int = 2,
    snr_range: Tuple[float, float] = (0.0, 5.0),
    seed: int = 0,
    speaker_of=None,
) -> List[Tuple[List[str], List[float]]]:
    """Seeded random C-way pairing over a flat utterance list.

    Like the MERL mixture lists, the C sources of a mixture always come
    from C *different* speakers (speaker_of: path -> id, default the
    parent directory name; falls back to distinct files when fewer than C
    speakers exist). First source gets SNR 0 dB, the rest a uniform draw
    in snr_range (the wsj0-mix convention).
    """
    if speaker_of is None:
        speaker_of = lambda p: os.path.basename(os.path.dirname(p))
    rng = np.random.default_rng(seed)
    files = sorted(files)
    by_spk: dict = {}
    for f in files:
        by_spk.setdefault(speaker_of(f), []).append(f)
    speakers = sorted(by_spk)
    distinct_spk = len(speakers) >= C
    if not distinct_spk and len(files) < C:
        raise ValueError(f"need at least {C} utterances to build mixtures")
    out = []
    for _ in range(n_mixtures):
        if distinct_spk:
            chosen = rng.choice(len(speakers), size=C, replace=False)
            paths = [str(rng.choice(by_spk[speakers[i]])) for i in chosen]
        else:
            chosen = rng.choice(len(files), size=C, replace=False)
            paths = [files[i] for i in chosen]
        snrs = [0.0] + [float(rng.uniform(*snr_range)) for _ in range(C - 1)]
        out.append((paths, snrs))
    return out


def random_pair_list(
    wav_dirs: Sequence[str],
    n_mixtures: int,
    C: int = 2,
    snr_range: Tuple[float, float] = (0.0, 5.0),
    seed: int = 0,
) -> List[Tuple[List[str], List[float]]]:
    """random_pair_list_from_files over the wavs found under wav_dirs
    (recursive). Speaker id is the wav's parent directory."""
    files = [
        os.path.join(r, f)
        for d in wav_dirs
        for r, _, fs in os.walk(d)
        for f in fs if f.endswith(".wav")
    ]
    return random_pair_list_from_files(files, n_mixtures, C=C,
                                       snr_range=snr_range, seed=seed)
