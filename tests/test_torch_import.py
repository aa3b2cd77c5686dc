"""The port's reference-checkpoint import against the JAX package's (CPU).

Reference packages (the reference's ConvTasNet.serialize layout:
hyperparameters, state_dict, epoch, loss history) are built from seeded
JAX parameters with convtasnet_tpu's state_dict_from_params and
torch.save, for gLN / cLN / BN, causal or not (the causal dsconv slots
shift by Chomp1d's). Both import CLIs convert them. Checks: imported
parameters and BN statistics equal bit for bit; the port's forward on the
imported checkpoint against the JAX forward on the JAX import at rtol 5e-4 /
atol 5e-5 (tests/test_torch_model.py); the port's state_dict_from_params
gives the package's state_dict back bit for bit."""

import jax
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.cli import import_torch as t_cli
from convtasnet_torch.compat import torch_convert as t_conv
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.training import checkpoint as t_ckpt
from convtasnet_tpu.cli import import_torch as j_cli
from convtasnet_tpu.compat import torch_convert as j_conv
from convtasnet_tpu.training import checkpoint as j_ckpt

torch.set_num_threads(1)
TOL = dict(rtol=5e-4, atol=5e-5)
SMALL = dict(N=32, L=16, B=16, H=32, P=3, X=2, R=2)
CASES = [(n, c) for n in ("gLN", "cLN", "BN") for c in (False, True)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
    return out


def _package(tmp_path, norm_type, causal, seed=0):
    """A reference package from seeded JAX weights (BN statistics and
    affines randomised, so every slot carries distinct values)."""
    cfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm_type, causal=causal, **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)
    blocks = params["separator"]["blocks"]
    for k in ("in_gamma", "in_beta", "dw_gamma", "dw_beta", "in_prelu", "dw_prelu"):
        blocks[k] = rng.uniform(0.5, 1.5, blocks[k].shape).astype(np.float32)
    if norm_type == "BN":
        state["blocks"] = {k: rng.uniform(0.1, 2.0, v.shape).astype(np.float32)
                           for k, v in state["blocks"].items()}
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in j_conv.state_dict_from_params(params, state, cfg).items()}
    package = {k: getattr(cfg, k) for k in j_conv.HPARAM_KEYS}
    package["causal"] = int(causal)
    package.update(state_dict=sd, optim_dict={}, epoch=3,
                   tr_loss=torch.arange(10.0), cv_loss=torch.arange(10.0) / 2)
    path = str(tmp_path / f"{norm_type}_{int(causal)}.pth.tar")
    torch.save(package, path)
    return path, sd, params, state


@pytest.mark.parametrize("norm_type,causal", CASES)
def test_import_matches_jax(tmp_path, norm_type, causal):
    pth, sd, params, state = _package(tmp_path, norm_type, causal)
    out_t, out_j = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    t_cli.import_torch(t_cli.build_parser().parse_args(
        ["--torch_path", pth, "--out", out_t, "--compute_dtype", "float32"]), log=lambda s: None)
    j_cli.import_torch(j_cli.build_parser().parse_args(
        ["--torch_path", pth, "--out", out_j, "--compute_dtype", "float32"]), log=lambda s: None)

    header = t_ckpt.load_header(out_t)
    assert header["epoch"] == 3 and header["tr_loss"] == [0.0, 1.0, 2.0]
    assert header["cv_loss"] == [0.0, 0.5, 1.0]
    assert header["extra"]["imported_from"] == pth
    cfg, tp, ts = t_ckpt.load_model(out_t, "cpu")
    assert (cfg.norm_type, cfg.causal, cfg.H, cfg.compute_dtype) == (
        norm_type, causal, 32, "float32")
    _, jp, js = t_ckpt.load_model(out_j, "cpu")
    for want_tree, got_tree in ((params, tp), (_flat(jp), _flat(tp)), (state, ts),
                                (_flat(js), _flat(ts))):
        want, got = _flat(want_tree), _flat(got_tree)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # Forward of each import: the port's on its checkpoint, JAX's on its own.
    jcfg, jparams, jstate = j_ckpt.load_model(out_j)
    mix = np.random.default_rng(1).normal(size=(2, 400)).astype(np.float32)
    want, _ = convtasnet_tpu.forward(jparams, jstate, jcfg, jax.numpy.asarray(mix))
    for form in ("0", "auto"):
        c = ConvTasNetConfig.from_header(header["model_config"])
        c = ConvTasNetConfig(**{**c.header_dict(), "use_kernels": form})
        got, _ = tm.forward(tp, ts, c, torch.from_numpy(mix))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # The inverse mapping gives the package back, bit for bit.
    back = t_conv.state_dict_from_params(tp, ts, cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == sd[k].dtype, k
        assert torch.equal(back[k], sd[k]), k


def test_load_torch_package_numpy_state_dict(tmp_path):
    pth, sd, _, _ = _package(tmp_path, "gLN", False, seed=2)
    pkg = t_conv.load_torch_package(pth)
    assert pkg["epoch"] == 3 and set(pkg["state_dict"]) == set(sd)
    for k, v in pkg["state_dict"].items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, sd[k].numpy())
    cfg, params, state = t_conv.import_package(pkg, compute_dtype="float32")
    assert isinstance(cfg, ConvTasNetConfig) and state == {}
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in _leaves(params))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])
