"""BSS-Eval v3 and SI-SNRi, batched, in PyTorch on the card.

The port of convtasnet_tpu/ops/metrics_device.py. BSS-Eval scores an
estimate by its 512-tap least-squares projections onto the subspace of
delayed references (Vincent et al., "Performance measurement in blind
audio source separation", IEEE TASLP 2006). Per utterance that is FFT
cross-correlations, a block-Toeplitz Gram, one Cholesky factor of it and
triangular solves: batched tensor work, so evaluate runs it on the card in
the same enqueue as the forward instead of on the host (ops/metrics.py,
the f64 numpy oracle).

Pipeline (the JAX module's, step for step):
- estimates, references and mixture are masked to each row's length;
- cross-correlations by torch.fft at n_fft = next_pow2(T + flen), exact
  for linear lags under zero padding, so a padded batch gives the values
  of the trimmed utterances;
- the [C*flen, C*flen] Gram gathered from the references'
  cross-correlations, and its C diagonal [flen, flen] blocks;
- a robust Cholesky: a ridge of _JITTER[dtype] times a Gershgorin bound on
  lambda_max, and for each matrix whose factor broke down
  (torch.linalg.cholesky_ex's info, read on the device: no host sync) a
  second factor with the big ridge _JITTER_BIG;
- each solve refined 4 times against the raw Gram (iterated Tikhonov: it
  converges to the unregularised solution in well-conditioned directions
  and stays regularised in the near-null space of tonal references);
- the C estimates and the mixture anchor are the right-hand columns of
  one solve per factor, so the anchor is projected once;
- the SIR-maximising permutation over itertools.permutations, the first
  maximum winning (the host's strict '>').

`dtype` defaults to float64: the card has f64 linear algebra, so the
port does not need the JAX module's f32 workarounds (ops/linalg_hp.py, for
XLA:TPU's bf16-rounded dots). float32 stays available; its refinement
residual b - G h is the cancellation the JAX module pins to
Precision.HIGHEST, so in f32 every matmul here runs with TF32 off, whatever
the process has set. There is no host fallback: a factor that breaks down
under both ridges yields NaN.
"""

from __future__ import annotations

import contextlib
import functools
from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F

# Ridge as a fraction of the lambda_max bound, by type: f32 keeps the JAX
# module's 3e-8 (about eps / 4); f64 takes 1e-10, about 500 times its
# Cholesky roundoff floor (n * eps * lambda_max at n = 1024): in f64 the f32
# ridge biases the SDRi of tonal references against the host's
# unregularised solve past the evaluate tests' 1e-3 dB gate.
_JITTER = {torch.float32: 3e-8, torch.float64: 1e-10}
_JITTER_BIG = 1e-4    # ridge for the matrices whose first factor broke down
_REFINE_STEPS = 4
_SI_SNR_EPS = 1e-8    # the host metric's EPS (ops/metrics.py)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@contextlib.contextmanager
def _full_precision(dtype: torch.dtype):
    """f32 matmuls without TF32 inside the block (restored after)."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=None)
def _permutations(C: int, device: torch.device) -> torch.Tensor:
    """All permutations of range(C) as a [C!, C] tensor on `device`, made
    once (its copy to the device would synchronise every call)."""
    return torch.tensor(list(permutations(range(C))), device=device)


def _as_tensor(x, device=None) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def _ratios(s_target, e_interf, e_artif, eps: float):
    """SDR / SIR / SAR from the three projection components (last axis =
    time)."""
    et = (s_target * s_target).sum(-1)
    ei = (e_interf * e_interf).sum(-1)
    eia = ((e_interf + e_artif) ** 2).sum(-1)
    ea = (e_artif * e_artif).sum(-1)
    eti = ((s_target + e_interf) ** 2).sum(-1)
    sdr = 10.0 * torch.log10(et / (eia + eps) + eps)
    sir = 10.0 * torch.log10(et / (ei + eps) + eps)
    sar = 10.0 * torch.log10(eti / (ea + eps) + eps)
    return sdr, sir, sar


def _robust_cholesky(G: torch.Tensor, eps: float) -> torch.Tensor:
    """Lower factor of G + ridge, per matrix of the batch: the small ridge,
    or the big one where the small one's factorisation broke down; NaN where
    both did."""
    lam = G.abs().sum(-1).amax(-1)                       # Gershgorin bound
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    fac1, info1 = torch.linalg.cholesky_ex(
        G + (_JITTER[G.dtype] * lam + eps)[..., None, None] * eye)
    fac2, info2 = torch.linalg.cholesky_ex(
        G + (_JITTER_BIG * lam + eps)[..., None, None] * eye)
    fac = torch.where((info1 != 0)[..., None, None], fac2, fac1)
    broken = ((info1 != 0) & (info2 != 0))[..., None, None]
    return torch.where(broken, torch.full_like(fac, float("nan")), fac)


def _refined_solve(fac: torch.Tensor, G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve G h ~= b ([..., n, k] right-hand columns) through the ridged
    factor plus refinement against the raw Gram."""
    h = torch.cholesky_solve(b, fac)
    for _ in range(_REFINE_STEPS):
        h = h + torch.cholesky_solve(b - G @ h, fac)
    return h


def _bss_eval_impl(refs, ests, mix, lengths, filt_len: int, dtype: torch.dtype):
    """refs / ests [B, C, T], mix [B, T], lengths [B] ->
    (sdr [B, C], sir [B, C], perm [B, C], sdr0 [B, C], sdri [B]).

    sdr / sir are taken at the SIR-maximising permutation; sdr0 is the
    mixture anchor's row (the same for every estimate); sdri is the mean
    over channels of sdr - sdr0, as ops.metrics.sdr_improvement."""
    B, C, T = refs.shape
    flen = filt_len
    n_fft = _next_pow2(T + flen)
    Tp = T + flen - 1
    dev = refs.device
    eps = torch.finfo(dtype).eps

    tmask = (torch.arange(T, device=dev)[None, :] < lengths.to(dev)[:, None]).to(dtype)
    refs = refs.to(dtype) * tmask[:, None, :]
    # The C estimates and the anchor: E = C + 1 right-hand sides.
    X = torch.cat([ests.to(dtype), mix.to(dtype)[:, None, :]], 1) * tmask[:, None, :]

    sf = torch.fft.rfft(refs, n=n_fft, dim=-1)                          # [B, C, F]
    # Gram blocks: cc_jk[d] = sum_t s_j[t] s_k[t + d] (circular, exact for
    # the linear lags used); block[a, b] = cc[(a - b) mod n_fft].
    cc = torch.fft.irfft(sf.conj()[:, :, None] * sf[:, None, :], n=n_fft, dim=-1)
    a = torch.arange(flen, device=dev)
    blocks = cc[..., (a[:, None] - a[None, :]) % n_fft]                 # [B, C, C, f, f]
    del cc
    G = blocks.permute(0, 1, 3, 2, 4).reshape(B, C * flen, C * flen)
    diag = torch.arange(C, device=dev)
    Gd = blocks[:, diag, diag]                                          # [B, C, f, f]

    with _full_precision(dtype):
        L = _robust_cholesky(G, eps)
        Ld = _robust_cholesky(Gd, eps)

        xf = torch.fft.rfft(X, n=n_fft, dim=-1)                         # [B, E, F]
        D = torch.fft.irfft(sf.conj()[:, None] * xf[:, :, None], n=n_fft,
                            dim=-1)[..., :flen]                          # [B, E, C, f]
        E = D.shape[1]
        # Projection onto every delayed reference.
        h = _refined_solve(L, G, D.reshape(B, E, C * flen).transpose(1, 2))
        hf = torch.fft.rfft(h.transpose(1, 2).reshape(B, E, C, flen), n=n_fft, dim=-1)
        p_all = torch.fft.irfft((hf * sf[:, None]).sum(2), n=n_fft, dim=-1)[..., :Tp]
        e_artif = F.pad(X, (0, flen - 1)) - p_all                        # [B, E, Tp]
        # Projection onto each reference's own delays.
        hj = _refined_solve(Ld, Gd, D.permute(0, 2, 3, 1))               # [B, C, f, E]
        hjf = torch.fft.rfft(hj.permute(0, 3, 1, 2), n=n_fft, dim=-1)    # [B, E, C, F]
        s_target = torch.fft.irfft(hjf * sf[:, None], n=n_fft, dim=-1)[..., :Tp]
        e_interf = p_all[:, :, None] - s_target                          # [B, E, C, Tp]
        sdr_m, sir_m, _ = _ratios(s_target, e_interf, e_artif[:, :, None], eps)

    sdr0 = sdr_m[:, C]                                                   # [B, Cref]
    sdr_m, sir_m = sdr_m[:, :C], sir_m[:, :C]                            # [B, Cest, Cref]
    perms = _permutations(C, dev)                                       # [P, C]
    rows = torch.arange(C, device=dev)
    mean_sir = torch.stack([sir_m[:, rows, p].mean(-1) for p in perms], 1)  # [B, P]
    perm = perms[torch.argmax(mean_sir, dim=1)]                          # first max wins
    sdr = sdr_m.gather(2, perm[:, :, None])[..., 0]
    sir = sir_m.gather(2, perm[:, :, None])[..., 0]
    return sdr, sir, perm, sdr0, (sdr - sdr0).mean(-1)


def _lengths(lengths, B: int, T: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), T, dtype=torch.int64, device=device)
    return _as_tensor(lengths, device).to(device=device, dtype=torch.int64)


def sdr_improvement_batch(src_ref, src_est, mix, lengths=None, filt_len: int = 512,
                          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Batched SDRi: [B, C, T] references and estimates, [B, T] mixture ->
    [B] (the mixture-anchor SDRi of ops.metrics.sdr_improvement). Runs
    where the tensors are (numpy inputs on the CPU); `lengths` defaults to
    the full T, and rows are masked past their length."""
    src_ref = _as_tensor(src_ref)
    B, C, T = src_ref.shape
    dev = src_ref.device
    *_, sdri = _bss_eval_impl(src_ref, _as_tensor(src_est, dev), _as_tensor(mix, dev),
                              _lengths(lengths, B, T, dev), filt_len, dtype)
    return sdri


def bss_eval_sources_device(reference_sources, estimated_sources, filt_len: int = 512,
                            dtype: torch.dtype = torch.float64):
    """One utterance, the host contract: [C, T] references and estimates ->
    numpy (sdr [C], sir [C], perm [C]) at the SIR-maximising permutation."""
    ref = _as_tensor(reference_sources)[None]
    est = _as_tensor(estimated_sources, ref.device)[None]
    sdr, sir, perm, _, _ = _bss_eval_impl(ref, est, ref.sum(1), _lengths(None, 1, ref.shape[-1],
                                                                          ref.device),
                                          filt_len, dtype)
    return sdr[0].cpu().numpy(), sir[0].cpu().numpy(), perm[0].cpu().numpy()


def si_snr_improvement_batch(src_ref, src_est, mix, lengths=None,
                             dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Batched SI-SNRi: [B, C, T] references and estimates, [B, T] mixture
    -> [B]: the host ops.metrics.si_snr_improvement (per-channel SI-SNR of
    the estimate minus that of the mixture, averaged over C) as masked
    tensor math; zero-mean divides by each row's true length."""
    src_ref = _as_tensor(src_ref)
    B, C, T = src_ref.shape
    dev = src_ref.device
    lens = _lengths(lengths, B, T, dev)
    mask = (torch.arange(T, device=dev)[None, None, :] < lens[:, None, None]).to(dtype)
    n = lens.clamp_min(1).to(dtype)[:, None, None]

    def zero_mean(x):
        x = x.to(dtype) * mask
        return (x - x.sum(2, keepdim=True) / n) * mask

    ref = zero_mean(src_ref)
    eps = _SI_SNR_EPS

    def si_snr(est):  # zero-meaned [B, C, T] -> [B, C] dB
        proj = ((ref * est).sum(2) / ((ref * ref).sum(2) + eps))[..., None] * ref
        noise = est - proj
        return 10.0 * torch.log10((proj * proj).sum(2) / ((noise * noise).sum(2) + eps) + eps)

    mix = _as_tensor(mix, dev)
    base = si_snr(zero_mean(mix[:, None, :].expand(B, C, T)))
    return (si_snr(zero_mean(_as_tensor(src_est, dev))) - base).mean(1)
