"""The port's stream CLI (CPU) against its offline separation and against
the JAX package's stream CLI on a checkpoint that JAX wrote.

Wavs are PCM16, so outputs are compared at atol 5e-4, as
tests/test_e2e_cli.py does."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.cli.separate import main as separate_main
from convtasnet_torch.cli.stream import chunk_samples
from convtasnet_torch.cli.stream import main as stream_main
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.data.wavio import read_wav, write_wav
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.training.checkpoint import save_checkpoint
from convtasnet_tpu.cli.stream import main as jax_stream_main
from convtasnet_tpu.training import checkpoint as j_ckpt

torch.set_num_threads(1)
PCM16_ATOL = 5e-4  # two PCM16 roundings plus the f32 paths' difference
SMALL = dict(N=16, L=8, B=12, H=24, P=3, X=2, R=2, C=2, compute_dtype="float32")
CAUSAL = dict(SMALL, norm_type="cLN", causal=True)


def _port_ckpt(tmp_path, seed=1, **kw):
    cfg = ConvTasNetConfig(**{**CAUSAL, **kw})
    params, state = tm.init_params(torch.Generator().manual_seed(seed), cfg)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, cfg, params, state)
    return cfg, params, state, path


def _wavs(tmp_path, lengths, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, T in enumerate(lengths):
        p = str(tmp_path / f"utt{i}.wav")
        write_wav(p, (0.05 * rng.standard_normal(T)).astype(np.float32), 8000)
        paths.append(p)
    return paths


def _argv(ckpt, out_dir, wavs, *extra):
    argv = ["--model_path", ckpt, "--out_dir", out_dir, "--device", "cpu", *extra]
    for w in wavs:
        argv += ["--wav", w]
    return argv


def test_batch_serving_matches_offline(tmp_path):
    """--batch 3 over files of unequal length, with a part-filled last
    group: each file's output is the offline forward of its mixture padded
    to its group's streamed length."""
    cfg, params, state, ckpt = _port_ckpt(tmp_path)
    lengths = [4320, 3200, 2720, 1990]
    wavs = _wavs(tmp_path, lengths, 9)
    out_dir = str(tmp_path / "stream_out")
    assert stream_main(_argv(ckpt, out_dir, wavs, "--chunk_ms", "20", "--batch", "3")) == 4
    group_len = [4320, 4320, 4320, 2080]  # ceil(max T / 160) * 160 per group
    for i, w in enumerate(wavs):
        mix_q, _ = read_wav(w)
        mix_pad = np.pad(mix_q, (0, group_len[i] - len(mix_q)))
        with torch.no_grad():
            est, _ = tm.forward(params, state, cfg, torch.from_numpy(mix_pad[None]))
        ref = est[0].numpy()
        for c in range(cfg.C):
            got, sr = read_wav(os.path.join(out_dir, f"utt{i}_s{c + 1}.wav"))
            assert sr == 8000 and got.shape[0] == lengths[i]
            np.testing.assert_allclose(got, ref[c, :lengths[i]], atol=PCM16_ATOL)


def test_jax_checkpoint_streams_alike_in_both_clis(tmp_path, monkeypatch):
    monkeypatch.setenv("CONVTASNET_COMPILE_CACHE", "0")
    jcfg = convtasnet_tpu.ConvTasNetConfig(use_pallas=False, **CAUSAL)
    params, state = convtasnet_tpu.init_params(jax.random.key(1), jcfg)
    ckpt = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(ckpt, jcfg, params, state)
    wavs = _wavs(tmp_path, [4320], 7)  # 27 exact 20 ms chunks
    jax_dir, port_dir = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    assert jax_stream_main(["--model_path", ckpt, "--wav", wavs[0], "--out_dir", jax_dir,
                            "--chunk_ms", "20"]) == 1
    assert stream_main(_argv(ckpt, port_dir, wavs, "--chunk_ms", "20")) == 1
    mix_q, _ = read_wav(wavs[0])
    ref, _ = convtasnet_tpu.forward(params, state, jcfg, jnp.asarray(mix_q[None]))
    assert np.max(np.abs(np.asarray(ref))) < 0.99  # PCM16 clipping not in play
    for c in range(jcfg.C):
        got, _ = read_wav(os.path.join(port_dir, f"utt0_s{c + 1}.wav"))
        want, _ = read_wav(os.path.join(jax_dir, f"utt0_s{c + 1}.wav"))
        assert got.shape == want.shape == (4320,)
        np.testing.assert_allclose(got, want, atol=PCM16_ATOL)
        np.testing.assert_allclose(got, np.asarray(ref)[0, c], atol=PCM16_ATOL)


def test_stream_cli_matches_separate_cli(tmp_path):
    """The stream CLI against the offline separate CLI padded to the same
    chunk multiple (160 samples at 20 ms), lengths on and off it."""
    cfg, _, _, ckpt = _port_ckpt(tmp_path, seed=2)
    mix_dir = tmp_path / "mix"
    mix_dir.mkdir()
    lengths = [3200, 2901]
    _wavs(mix_dir, lengths, 5)
    s_dir, o_dir = str(tmp_path / "stream"), str(tmp_path / "sep")
    assert stream_main(["--model_path", ckpt, "--mix_dir", str(mix_dir), "--out_dir", s_dir,
                        "--device", "cpu"]) == 2
    assert separate_main(["--model_path", ckpt, "--mix_dir", str(mix_dir), "--out_dir", o_dir,
                          "--device", "cpu", "--pad_to_multiple", "160"]) == 2
    for i, T in enumerate(lengths):
        for c in range(cfg.C):
            got, _ = read_wav(os.path.join(s_dir, f"utt{i}_s{c + 1}.wav"))
            want, _ = read_wav(os.path.join(o_dir, f"utt{i}_s{c + 1}.wav"))
            assert got.shape == want.shape == (T,)
            np.testing.assert_allclose(got, want, atol=PCM16_ATOL)


@pytest.mark.parametrize("chunk_ms,L,S,want", [
    (20, 8, 4, 160),    # 160 samples, already a stride multiple
    (20, 20, 10, 160),
    (12.6, 16, 8, 104),  # 100.8 -> 101 -> up to a multiple of 8
    (0.5, 20, 10, 20),  # 4 samples -> floor of one frame (L)
    (1, 8, 4, 8),
])
def test_chunk_length_rounding(chunk_ms, L, S, want):
    assert chunk_samples(chunk_ms, 8000, L, S) == want


def test_chunk_length_rounding_in_cli(tmp_path, capsys):
    _, _, _, ckpt = _port_ckpt(tmp_path)
    wavs = _wavs(tmp_path, [800], 3)
    stream_main(_argv(ckpt, str(tmp_path / "o"), wavs, "--chunk_ms", "2.6"))
    # 20.8 samples -> 21 -> 24 (stride 4) = 3.0 ms
    assert "| chunk 3.0 ms |" in capsys.readouterr().out


def test_rejects_noncausal_checkpoint(tmp_path):
    _, _, _, ckpt = _port_ckpt(tmp_path, norm_type="gLN", causal=False)
    wavs = _wavs(tmp_path, [1600], 0)
    with pytest.raises(SystemExit, match="causal"):
        stream_main(_argv(ckpt, str(tmp_path / "o"), wavs))


def test_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    _, _, _, ckpt = _port_ckpt(tmp_path)
    wavs = _wavs(tmp_path, [1600], 0)
    out_dir = tmp_path / "o"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_main(["--model_path", ckpt, "--wav", wavs[0], "--out_dir", str(out_dir)])
    assert not out_dir.exists()
