"""Separation quality metrics: SI-SNR(i) and BSS-Eval SDR(i)/SIR/SAR.

The port's copy of convtasnet_tpu/ops/metrics.py (same code, same bits).
Host-side numpy implementations matching the reference eval harness
(evaluate.py:90-144). The reference outsources SDR to
mir_eval.bss_eval_sources; that package isn't available here, so the
framework carries its own BSS Eval v3 implementation built from the metric
definitions (Vincent et al., "Performance measurement in blind audio
source separation", IEEE TASLP 2006): 512-tap least-squares projections of
the estimate onto the subspace of delayed references, assembled with FFT
cross-correlations and a block-Gram solve, with the SIR-maximizing
permutation search mir_eval applies by default.
"""

from __future__ import annotations

from itertools import permutations
from typing import Tuple

import numpy as np

EPS = 1e-8


# --------------------------------------------------------------------------
# SI-SNR (evaluate.py:128-144 semantics)
# --------------------------------------------------------------------------

def si_snr(ref: np.ndarray, est: np.ndarray, eps: float = EPS) -> float:
    """Scale-invariant SNR between two 1-D signals."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    assert ref.shape == est.shape
    ref = ref - ref.mean()
    est = est - est.mean()
    ref_energy = np.sum(ref**2) + eps
    proj = np.sum(ref * est) * ref / ref_energy
    noise = est - proj
    ratio = np.sum(proj**2) / (np.sum(noise**2) + eps)
    return float(10 * np.log10(ratio + eps))


def si_snr_improvement(src_ref: np.ndarray, src_est: np.ndarray, mix: np.ndarray) -> float:
    """Average SI-SNRi over channels, mixture as the do-nothing baseline
    (evaluate.py:108-125). src_ref/src_est: [C, T], mix: [T]."""
    C = src_ref.shape[0]
    vals = []
    for c in range(C):
        snr = si_snr(src_ref[c], src_est[c])
        base = si_snr(src_ref[c], mix)
        vals.append(snr - base)
    return float(np.mean(vals))


# --------------------------------------------------------------------------
# BSS Eval v3 (SDR / SIR / SAR)
# --------------------------------------------------------------------------

def _factor(G: np.ndarray):
    """Factor a (symmetric PSD) Gram matrix once; return a solve closure.

    Cholesky when positive definite, exact solve / lstsq fallback
    otherwise — same answers as solving from scratch, amortized across
    every estimate and permutation that reuses the factorization."""
    try:
        from scipy.linalg import cho_factor, cho_solve

        c = cho_factor(G)
        return lambda D: cho_solve(c, D)
    except Exception:
        def solve(D):
            try:
                return np.linalg.solve(G, D)
            except np.linalg.LinAlgError:
                return np.linalg.lstsq(G, D, rcond=None)[0]

        return solve


class _Projector:
    """Least-squares projection machinery for ONE reference set.

    Everything that depends only on the references — their FFTs, the
    [C*flen, C*flen] delayed-source Gram matrix and its factorization, and
    the per-source diagonal-block factorizations — is computed once here
    and reused for every estimate and every (i, j) pair. bss_eval_sources
    previously rebuilt and re-solved these C*Cr times per utterance; this
    is the host-side hot spot of cal_sdr=1 evaluation.
    """

    def __init__(self, sources: np.ndarray, flen: int):
        C, T = sources.shape
        self.sources, self.flen, self.C, self.T = sources, flen, C, T
        n_fft = 1
        while n_fft < T + flen:
            n_fft *= 2
        self.n_fft = n_fft
        self.sf = np.fft.rfft(sources, n=n_fft, axis=1)

        from scipy.linalg import toeplitz

        G = np.empty((C * flen, C * flen))
        for j in range(C):
            for k in range(j, C):
                # cross-correlation cc[d] = sum_t s_j[t] s_k[t+d]; the
                # (j, k) block is Toeplitz: block[a, b] =
                # <s_j delayed a, s_k delayed b> = cc[(a - b) mod n_fft].
                cc = np.fft.irfft(np.conj(self.sf[j]) * self.sf[k], n=n_fft)
                block = toeplitz(cc[:flen], cc[(-np.arange(flen)) % n_fft])
                G[j * flen:(j + 1) * flen, k * flen:(k + 1) * flen] = block
                if k != j:
                    G[k * flen:(k + 1) * flen,
                      j * flen:(j + 1) * flen] = block.T
        self.solve_all = _factor(G)
        self.solve_one = [
            _factor(G[j * flen:(j + 1) * flen, j * flen:(j + 1) * flen])
            for j in range(C)
        ]

    def cross_corr(self, est: np.ndarray) -> np.ndarray:
        """D[j*flen+a] = sum_t s_j[t-a] est[t] for one estimate."""
        ef = np.fft.rfft(est, n=self.n_fft)
        D = np.empty(self.C * self.flen)
        for j in range(self.C):
            cd = np.fft.irfft(np.conj(self.sf[j]) * ef, n=self.n_fft)
            D[j * self.flen:(j + 1) * self.flen] = cd[:self.flen]
        return D

    def _filter_sum(self, h: np.ndarray, idx) -> np.ndarray:
        """proj[t] = sum_j sum_a h[j, a] s_j[t-a], via the cached FFTs."""
        hf = np.fft.rfft(h.reshape(len(idx), self.flen), n=self.n_fft,
                         axis=1)
        pf = np.sum(hf * self.sf[idx], axis=0)
        return np.fft.irfft(pf, n=self.n_fft)[: self.T + self.flen - 1]

    def project_all(self, D: np.ndarray) -> np.ndarray:
        """Projection of the estimate behind D onto ALL delayed sources."""
        return self._filter_sum(self.solve_all(D), np.arange(self.C))

    def project_one(self, D: np.ndarray, j: int) -> np.ndarray:
        """Projection onto delays of source j alone (reuses D's block)."""
        h = self.solve_one[j](D[j * self.flen:(j + 1) * self.flen])
        return self._filter_sum(h, np.array([j]))


def _project(sources: np.ndarray, est: np.ndarray, flen: int) -> np.ndarray:
    """Least-squares projection of est onto delays 0..flen-1 of sources."""
    p = _Projector(np.asarray(sources, np.float64), flen)
    return p.project_all(p.cross_corr(np.asarray(est, np.float64)))


def _ratios(s_target, e_interf, e_artif, eps: float = np.finfo(np.float64).eps):
    sdr = 10 * np.log10(np.sum(s_target**2) / (np.sum((e_interf + e_artif) ** 2) + eps) + eps)
    sir = 10 * np.log10(np.sum(s_target**2) / (np.sum(e_interf**2) + eps) + eps)
    sar = 10 * np.log10(
        np.sum((s_target + e_interf) ** 2) / (np.sum(e_artif**2) + eps) + eps
    )
    return sdr, sir, sar


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    compute_permutation: bool = True,
    filt_len: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """BSS Eval SDR/SIR/SAR with SIR-maximizing permutation search.

    Args: [C, T] references and estimates (same shapes).
    Returns (sdr, sir, sar, perm) each [C], with estimate i scored against
    reference perm[i] — the mir_eval-compatible contract the reference eval
    relies on (evaluate.py:101-103).
    """
    ref = np.asarray(reference_sources, np.float64)
    est = np.asarray(estimated_sources, np.float64)
    if ref.ndim == 1:
        ref = ref[None]
    if est.ndim == 1:
        est = est[None]
    C = est.shape[0]
    Cr = ref.shape[0]

    # Pairwise metrics: estimate i vs reference j. The reference-only
    # work (FFTs, Gram build + factorizations) happens once in _Projector;
    # each estimate adds one cross-correlation + one full solve, and each
    # (i, j) pair only a per-source block solve.
    proj = _Projector(ref, filt_len)
    sdr_m = np.empty((C, Cr))
    sir_m = np.empty((C, Cr))
    sar_m = np.empty((C, Cr))
    for i in range(C):
        D = proj.cross_corr(est[i])
        p_all = proj.project_all(D)
        e_artif = np.concatenate([est[i], np.zeros(filt_len - 1)]) - p_all
        for j in range(Cr):
            s_target = proj.project_one(D, j)
            e_interf = p_all - s_target
            sdr_m[i, j], sir_m[i, j], sar_m[i, j] = _ratios(
                s_target, e_interf, e_artif)

    if not compute_permutation or C == 1:
        idx = np.arange(C)
        return sdr_m[idx, idx], sir_m[idx, idx], sar_m[idx, idx], idx

    best, best_perm = -np.inf, None
    for p in permutations(range(Cr), C):
        mean_sir = np.mean([sir_m[i, p[i]] for i in range(C)])
        if mean_sir > best:
            best, best_perm = mean_sir, p
    perm = np.array(best_perm)
    rows = np.arange(C)
    return sdr_m[rows, perm], sir_m[rows, perm], sar_m[rows, perm], perm


def sdr_improvement(src_ref: np.ndarray, src_est: np.ndarray, mix: np.ndarray,
                    filt_len: int = 512) -> float:
    """Average SDRi with the mixture duplicated as the do-nothing anchor
    (evaluate.py:90-105). src_ref/src_est: [C, T], mix: [T]."""
    C = src_ref.shape[0]
    anchor = np.stack([mix] * C, axis=0)
    sdr, *_ = bss_eval_sources(src_ref, src_est, filt_len=filt_len)
    sdr0, *_ = bss_eval_sources(src_ref, anchor, filt_len=filt_len)
    return float(np.mean(sdr - sdr0))
