"""The port's metrics against the JAX package's (CPU).

Host metrics (convtasnet_torch/ops/metrics.py) are a copy and must give the
same bits. The device metrics (convtasnet_torch/ops/metrics_device.py, run
here on CPU tensors) are held against the host f64 oracle and, in f32,
against convtasnet_tpu.ops.metrics_device. Tolerances, in dB: f64 against
the host 1e-3 on broadband signals (what the JAX package's own device gate
asks, tests/test_metrics.py), 1e-2 on pure tones (its degenerate-Gram
gate); f32 against the JAX f32 function 2e-2 (two f32 pipelines with other
Cholesky and FFT roundings); SI-SNRi against the host 1e-3."""

import numpy as np
import pytest
import torch

from convtasnet_torch.ops import metrics as t_host
from convtasnet_torch.ops import metrics_device as t_dev
from convtasnet_torch.utils.tensor import remove_pad
from convtasnet_tpu.ops import metrics as j_host
from convtasnet_tpu.utils.tensor import remove_pad as j_remove_pad

torch.set_num_threads(1)
TOL_F64_DB = 1e-3
TOL_TONE_DB = 1e-2
TOL_F32_VS_JAX_DB = 2e-2
TOL_SISNR_DB = 1e-3


def _separation(seed, T=3000, C=2, permute=False):
    """Seeded broadband sources and an imperfect separation of them:
    filtered target, crosstalk and noise."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((C, T))
    est = np.stack([np.convolve(s[c], rng.standard_normal(5))[:T]
                    + 0.2 * s[(c + 1) % C] + 0.05 * rng.standard_normal(T)
                    for c in range(C)])
    if permute:
        est = est[::-1].copy()
    return s, est, s.sum(0)


def _tones(T=4000):
    t = np.arange(T) / 8000
    s = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)])
    e = s + 0.05 * np.random.default_rng(2).standard_normal((2, T))
    return s, e, s.sum(0)


def _padded_batch(seed, lens=(6000, 5000, 4096), C=2):
    """Broadband batch zero-padded to the longest row, with garbage in the
    estimates past each row's length (the device path must mask it)."""
    rng = np.random.default_rng(seed)
    T = max(lens)
    src = rng.standard_normal((len(lens), C, T))
    est = src + 0.3 * rng.standard_normal(src.shape)
    mix = src.sum(1)
    for b, n in enumerate(lens):
        src[b, :, n:] = 0
        mix[b, n:] = 0
        est[b, :, n:] = rng.standard_normal((C, T - n))
    return src, est, mix, np.array(lens)


@pytest.mark.parametrize("case", ["broadband", "permuted", "tones", "three"])
def test_host_metrics_equal_jax_bits(case):
    s, e, mix = {"broadband": lambda: _separation(0),
                 "permuted": lambda: _separation(1, permute=True),
                 "tones": _tones,
                 "three": lambda: _separation(3, T=1500, C=3)}[case]()
    for a, b in zip(t_host.bss_eval_sources(s, e, filt_len=256),
                    j_host.bss_eval_sources(s, e, filt_len=256)):
        np.testing.assert_array_equal(a, b)
    assert t_host.sdr_improvement(s, e, mix, filt_len=256) == j_host.sdr_improvement(
        s, e, mix, filt_len=256)
    assert t_host.si_snr_improvement(s, e, mix) == j_host.si_snr_improvement(s, e, mix)
    assert t_host.si_snr(s[0], e[0]) == j_host.si_snr(s[0], e[0])


def test_remove_pad_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 50)).astype(np.float32)
    lens = np.array([50, 31, 7])
    want = j_remove_pad(x, lens)
    for got in (remove_pad(x, lens), remove_pad(torch.from_numpy(x), torch.from_numpy(lens))):
        assert len(got) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_device_f64_sdri_matches_host_on_padded_batch():
    """Padded broadband batch with garbage past each length, f64 device
    against the JAX host f64 on the trimmed utterances."""
    src, est, mix, lens = _padded_batch(0)
    host = [j_host.sdr_improvement(src[b, :, :n], est[b, :, :n], mix[b, :n])
            for b, n in enumerate(lens)]
    dev = t_dev.sdr_improvement_batch(torch.from_numpy(src), torch.from_numpy(est),
                                      torch.from_numpy(mix), torch.from_numpy(lens))
    assert dev.dtype == torch.float64 and dev.shape == (3,)
    np.testing.assert_allclose(dev.numpy(), host, atol=TOL_F64_DB, rtol=0)


@pytest.mark.parametrize("seed,permute", [(0, False), (1, True), (2, False)])
def test_device_bss_eval_sources_matches_host(seed, permute):
    s, e, _ = _separation(seed, permute=permute)
    sdr_h, sir_h, _, perm_h = j_host.bss_eval_sources(s, e)
    sdr_d, sir_d, perm_d = t_dev.bss_eval_sources_device(s, e)
    np.testing.assert_array_equal(perm_d, perm_h)
    np.testing.assert_allclose(sdr_d, sdr_h, atol=TOL_F64_DB, rtol=0)
    np.testing.assert_allclose(sir_d, sir_h, atol=TOL_F64_DB, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_bss_eval_pure_tones(dtype):
    """Pure sinusoids make each source's delayed Gram near rank 2: the
    ridge and its refinement must keep the device within the tone gate of
    the host, with no NaN."""
    s, e, mix = _tones()
    sdr_h, _, _, perm_h = j_host.bss_eval_sources(s, e)
    sdr_d, _, perm_d = t_dev.bss_eval_sources_device(
        torch.from_numpy(s).to(dtype), torch.from_numpy(e).to(dtype), dtype=dtype)
    assert np.all(np.isfinite(sdr_d))
    np.testing.assert_array_equal(perm_d, perm_h)
    np.testing.assert_allclose(sdr_d, sdr_h, atol=TOL_TONE_DB, rtol=0)
    sdri = t_dev.sdr_improvement_batch(s[None], e[None], mix[None], dtype=dtype)
    np.testing.assert_allclose(float(sdri[0]), j_host.sdr_improvement(s, e, mix),
                               atol=TOL_TONE_DB, rtol=0)


def test_device_f32_matches_jax_device_function():
    from convtasnet_tpu.ops.metrics_device import sdr_improvement_batch as j_batch

    src, est, mix, lens = _padded_batch(3, lens=(2000, 1500))
    src, est, mix = (a.astype(np.float32) for a in (src, est, mix))
    want = np.asarray(j_batch(src, est, mix, lens, filt_len=128))
    got = t_dev.sdr_improvement_batch(torch.from_numpy(src), torch.from_numpy(est),
                                      torch.from_numpy(mix), torch.from_numpy(lens),
                                      filt_len=128, dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32_VS_JAX_DB, rtol=0)


def test_padded_batch_equals_trimmed_utterances():
    """Zero padding is exact for the linear correlations, and the masks
    drop the garbage: each row of a padded batch scores as its trimmed
    utterance alone (f64, to 1e-9 dB)."""
    src, est, mix, lens = _padded_batch(4)
    batch = t_dev.sdr_improvement_batch(src, est, mix, lens).numpy()
    alone = [float(t_dev.sdr_improvement_batch(src[b:b + 1, :, :n], est[b:b + 1, :, :n],
                                               mix[b:b + 1, :n])[0])
             for b, n in enumerate(lens)]
    np.testing.assert_allclose(batch, alone, atol=1e-9, rtol=0)


def test_device_finds_permutation():
    rng = np.random.default_rng(5)
    s = rng.standard_normal((2, 2000))
    est = s[::-1] + 0.01 * rng.standard_normal((2, 2000))
    sdr, _, perm = t_dev.bss_eval_sources_device(s, est, filt_len=64)
    np.testing.assert_array_equal(perm, [1, 0])
    assert np.all(sdr > 20)


def test_device_si_snri_matches_host_and_jax():
    from convtasnet_tpu.ops.metrics_device import si_snr_improvement_batch as j_batch

    src, est, mix, lens = _padded_batch(6)
    host = [j_host.si_snr_improvement(src[b, :, :n], est[b, :, :n], mix[b, :n])
            for b, n in enumerate(lens)]
    got = t_dev.si_snr_improvement_batch(src, est, mix, lens)
    np.testing.assert_allclose(got.numpy(), host, atol=TOL_SISNR_DB, rtol=0)
    got32 = t_dev.si_snr_improvement_batch(src, est, mix, lens, dtype=torch.float32)
    want32 = np.asarray(j_batch(*(a.astype(np.float32) for a in (src, est, mix)), lens))
    np.testing.assert_allclose(got32.numpy(), want32, atol=TOL_SISNR_DB, rtol=0)
