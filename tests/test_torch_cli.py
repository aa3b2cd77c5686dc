"""Checkpoints and the separate CLI across the two packages (CPU), plus the
port's isolation from JAX and its CUDA-by-default entry points."""

import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.data.wavio import read_wav, write_wav
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.training import checkpoint as t_ckpt
from convtasnet_tpu.training import checkpoint as j_ckpt

torch.set_num_threads(1)
SMALL = dict(N=32, L=16, B=16, H=32, P=3, X=3, R=2, compute_dtype="float32")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_model(seed=0, **kw):
    cfg = convtasnet_tpu.ConvTasNetConfig(**SMALL, **kw)
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), cfg)
    return cfg, params, state


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
    return out


@pytest.mark.parametrize("norm_type", ["gLN", "BN"])
def test_jax_checkpoint_loads_in_port(tmp_path, norm_type):
    jcfg, params, state = _jax_model(1, norm_type=norm_type, causal=True)
    path = str(tmp_path / "j.ckpt")
    j_ckpt.save_checkpoint(path, jcfg, params, state, epoch=3)
    assert "use_pallas" in t_ckpt.load_header(path)["model_config"]
    cfg, tp, ts = t_ckpt.load_model(path, "cpu")
    assert (cfg.norm_type, cfg.causal, cfg.H, cfg.compute_dtype) == (norm_type, True, 32, "float32")
    want, got = _flat(jax.tree_util.tree_map(np.asarray, params)), _flat(tp)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _flat(ts).keys() == _flat(jax.tree_util.tree_map(np.asarray, state)).keys()


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = ConvTasNetConfig(norm_type="cLN", **SMALL)
    tp, ts = tm.init_params(torch.Generator().manual_seed(2), cfg)
    path = str(tmp_path / "t.ckpt")
    t_ckpt.save_checkpoint(path, cfg, tp, ts, epoch=1, tr_loss=[1.5])
    jcfg, jp, js = j_ckpt.load_model(path)
    assert jcfg.norm_type == "cLN" and jcfg.H == 32 and not jcfg.use_pallas
    want, got = _flat(tp), _flat(jax.tree_util.tree_map(np.asarray, jp))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert j_ckpt.load_header(path)["tr_loss"] == [1.5]


def test_load_rejects_wrong_shapes(tmp_path):
    cfg = ConvTasNetConfig(**SMALL)
    tp, ts = tm.init_params(torch.Generator().manual_seed(0), cfg)
    tp["separator"]["blocks"]["in_w"] = tp["separator"]["blocks"]["in_w"][:, :, :8]
    path = str(tmp_path / "bad.ckpt")
    t_ckpt.save_checkpoint(path, cfg, tp, ts)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.load_model(path, "cpu")


@pytest.fixture(scope="module")
def separated(tmp_path_factory):
    """One checkpoint and three mixtures (two lengths share a batch),
    separated by the JAX CLI with --use_pallas 0."""
    root = tmp_path_factory.mktemp("sep")
    jcfg, params, state = _jax_model(4)
    ckpt = str(root / "m.ckpt")
    j_ckpt.save_checkpoint(ckpt, jcfg, params, state)
    mix_dir = root / "mix"
    rng = np.random.default_rng(4)
    for i, n in enumerate((1200, 1000, 777)):
        write_wav(str(mix_dir / f"utt{i}.wav"), 0.3 * rng.normal(size=n), 8000)
    from convtasnet_tpu.cli.separate import main as jax_main

    out = str(root / "jax")
    assert jax_main(["--model_path", ckpt, "--mix_dir", str(mix_dir),
                     "--out_dir", out, "--batch_size", "2", "--use_pallas", "0"]) == 3
    return ckpt, str(mix_dir), out


@pytest.mark.parametrize("use_kernels", ["0", "auto", "block"])
def test_separate_cli_matches_jax(separated, tmp_path, use_kernels):
    from convtasnet_torch.cli.separate import main

    ckpt, mix_dir, jax_out = separated
    out = str(tmp_path / "torch")
    assert main(["--model_path", ckpt, "--mix_dir", mix_dir, "--out_dir", out,
                 "--batch_size", "2", "--device", "cpu",
                 "--use_kernels", use_kernels]) == 3
    want = sorted(glob.glob(os.path.join(jax_out, "*.wav")))
    got = sorted(glob.glob(os.path.join(out, "*.wav")))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 9  # 3 mixtures + 2 speakers each
    for g, w in zip(got, want):
        a, _ = read_wav(g)
        b, _ = read_wav(w)
        assert a.shape == b.shape
        # within one LSB of int16
        assert np.max(np.abs(a - b)) * 32768 <= 1.0 + 1e-6, g


def test_separate_cli_without_cuda_raises(separated, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from convtasnet_torch.cli.separate import main

    ckpt, mix_dir, _ = separated
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model_path", ckpt, "--mix_dir", mix_dir,
              "--out_dir", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_port_never_imports_jax():
    code = ("import sys, convtasnet_torch, convtasnet_torch.cli.separate, "
            "convtasnet_torch.cli.evaluate, convtasnet_torch.models.graphed, "
            "convtasnet_torch.models.conv_tasnet, convtasnet_torch.training.checkpoint\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('jaxlib') or m.startswith('convtasnet_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
