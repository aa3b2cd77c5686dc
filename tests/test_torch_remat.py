"""--remat and --scan_unroll in the port (f32, CPU) against the JAX package
in the same mode: forward, gradients and one train step per mode, BN's
state after a remat step, the kernel forms (their plain versions here)
unchanged by remat, the activation bytes each mode keeps for backward,
and the header round trip through both packages' checkpoints.

Tolerances: rtol 5e-4 / atol 5e-5 on forwards, losses, new parameters and
state; rtol 2e-3 / atol 5e-4 on gradients."""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig, remat_mode
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.ops.loss import cal_loss
from convtasnet_torch.training import checkpoint as t_ckpt
from convtasnet_torch.training import optim as to
from convtasnet_torch.training.solver import make_train_step
from convtasnet_tpu.training import checkpoint as j_ckpt
from convtasnet_tpu.training import optim as jo
from convtasnet_tpu.training.solver import make_train_step as j_make_train_step

torch.set_num_threads(1)
FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)
SMALL = dict(N=16, L=4, B=32, H=48, P=3, X=2, R=2, C=2, compute_dtype="float32")
# The port's remat values and the JAX package's for the same mode.
MODES = {"none": False, "repeat": True, "block": "block", "dots": "dots"}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)


def _setup(seed, mode, norm_type="gLN", M=2, T=402):
    jcfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm_type, remat=MODES[mode],
                                           scan_unroll=2, **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(M, 2, T)) * 0.3).astype(np.float32)
    lens = np.array([T, T - 61], np.int32)
    tp, ts = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state), "cpu")
    cfg = ConvTasNetConfig(norm_type=norm_type, use_kernels="0", remat=MODES[mode],
                           scan_unroll=2, **SMALL)
    return jcfg, params, state, cfg, tp, ts, (src.sum(1), src, lens)


def _torch_grads(cfg, tp, ts, mix, src, lens):
    leaves_tree = to.tree_map(lambda p: p.clone().requires_grad_(True), tp)
    est, new_state = tm.forward(leaves_tree, ts, cfg, torch.from_numpy(mix), train=True)
    loss = cal_loss(torch.from_numpy(src), est, torch.from_numpy(lens))[0]
    return est.detach(), loss.detach(), torch.autograd.grad(loss, to.tree_leaves(leaves_tree)), \
        new_state


@pytest.mark.parametrize("mode,norm_type", [("none", "gLN"), ("repeat", "gLN"),
                                            ("block", "gLN"), ("dots", "gLN"),
                                            ("dots", "cLN"), ("block", "BN")])
def test_remat_forward_and_grads_match_jax(mode, norm_type):
    """The training forward, the loss and every gradient leaf of the port
    in each remat mode against the JAX package in the same mode."""
    jcfg, params, state, cfg, tp, ts, (mix, src, lens) = _setup(3, mode, norm_type)

    def jloss(p):
        est, _ = convtasnet_tpu.forward(p, state, jcfg, jnp.asarray(mix), train=True)
        return convtasnet_tpu.cal_loss(jnp.asarray(src), est, jnp.asarray(lens))[0], est

    (jl, jest), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    est, loss, grads, _ = _torch_grads(cfg, tp, ts, mix, src, lens)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), **FWD)
    np.testing.assert_allclose(float(loss), float(jl), **FWD)
    for (k, want), got in zip(_leaves(jgrads), grads):
        np.testing.assert_allclose(got.numpy(), want, **GRAD, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_train_step_matches_jax(mode):
    """One SGD-with-momentum step (clip, update, BN state) per mode, each
    package in the same mode."""
    jcfg, params, state, cfg, tp, ts, (mix, src, lens) = _setup(5, mode, "BN")
    jopt = jo.Optimizer("sgd", lr=0.1, momentum=0.9)
    jstep = j_make_train_step(convtasnet_tpu.ConvTasNet(jcfg), jopt, max_norm=5.0)
    jp, _, jstate, jl, jgn = jstep(params, jopt.init(params), state, jnp.asarray(mix),
                                   jnp.asarray(src), jnp.asarray(lens))
    topt = to.Optimizer("sgd", lr=0.1, momentum=0.9)
    step = make_train_step(cfg, topt, max_norm=5.0)
    new_p, _, new_s, tl, tgn = step(tp, topt.init(tp), ts, torch.from_numpy(mix),
                                    torch.from_numpy(src), torch.from_numpy(lens))
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    np.testing.assert_allclose(float(tgn), float(jgn), **GRAD)
    for (k, want), (_, got) in zip(_leaves(jp), _leaves(new_p)):
        np.testing.assert_allclose(got, want, **FWD, err_msg=k)
    for (k, want), (_, got) in zip(_leaves(jstate), _leaves(new_s)):
        np.testing.assert_allclose(got, want, **FWD, err_msg=k)


@pytest.mark.parametrize("mode", ["repeat", "block", "dots"])
def test_bn_state_after_remat_step_equals_no_remat(mode):
    """The recompute's BN statistics are dropped: the running statistics
    advance once, to the no-remat step's values, and so do the gradients
    and the loss (bit for bit on the CPU)."""
    _, _, _, cfg, tp, ts, batch = _setup(7, mode, "BN")
    _, l0, g0, s0 = _torch_grads(dataclasses.replace(cfg, remat=False), tp, ts, *batch)
    _, l1, g1, s1 = _torch_grads(cfg, tp, ts, *batch)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert s1["blocks"].keys() == ts["blocks"].keys()
    for k, v in s0["blocks"].items():
        assert torch.equal(s1["blocks"][k], v), k
        assert not torch.equal(v, ts["blocks"][k]), k  # the step did advance them


@pytest.mark.parametrize("use_kernels,train", [("hybrid", True), ("whole", True),
                                               ("auto", False), ("block", False)])
def test_kernel_forms_ignore_remat(use_kernels, train):
    """The kernel forms (their plain versions on the CPU) run as without
    remat, as the JAX Pallas tiers run before it: the same bits."""
    _, _, _, cfg, tp, ts, (mix, src, lens) = _setup(9, "none")
    outs = []
    for mode in MODES.values():
        c = dataclasses.replace(cfg, use_kernels=use_kernels, remat=mode)
        assert c.kernel_form(train, "cpu") != "eager"
        if train:
            est, loss, grads, _ = _torch_grads(c, tp, ts, mix, src, lens)
            outs.append((est, loss, *grads))
        else:
            with torch.inference_mode():
                outs.append((tm.forward(tp, ts, c, torch.from_numpy(mix))[0],))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


class _LiveStorages(TorchDispatchMode):
    """Records every storage an op creates; `alive()` sums the bytes of
    those still referenced (deduplicated by storage)."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs.setdefault(st._cdata, (StorageWeakRef(st), st.nbytes()))
        return out

    def alive(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def _kept_for_backward(cfg, tp, ts, mix, src, lens):
    """(bytes the forward leaves alive for backward, bytes packed by
    saved_tensors_hooks): storages created by the forward and still held
    once only the loss is kept, and those autograd saved outside any
    checkpoint (a checkpoint saves through hooks of its own)."""
    leaves_tree = to.tree_map(lambda p: p.clone().requires_grad_(True), tp)
    hooked = {}

    def pack(t):
        st = t.untyped_storage()
        hooked[st._cdata] = st.nbytes()
        return t

    live = _LiveStorages()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), live:
        est, _ = tm.forward(leaves_tree, ts, cfg, torch.from_numpy(mix), train=True)
        loss = cal_loss(torch.from_numpy(src), est, torch.from_numpy(lens))[0]
    del est
    kept = live.alive()
    torch.autograd.grad(loss, to.tree_leaves(leaves_tree))
    return kept, sum(hooked.values())


def test_bytes_kept_for_backward_order():
    """Activation bytes alive at the end of the forward (bf16, the paper
    config's dtypes at a small width): none > dots > block > repeat.
    dots keeps per block its input and the two matmul outputs; block its
    input only; repeat one input per repeat. Without remat every saved
    tensor goes through saved_tensors_hooks, and those bytes are all alive."""
    cfg = ConvTasNetConfig(N=32, L=16, B=64, H=128, P=3, X=4, R=2, C=2,
                           compute_dtype="bfloat16", use_kernels="0")
    tp, ts = tm.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    src = (rng.normal(size=(2, 2, 4000)) * 0.3).astype(np.float32)
    batch = (src.sum(1), src, np.array([4000, 3500], np.int32))
    kept, hooked = {}, {}
    for mode in MODES:
        kept[mode], hooked[mode] = _kept_for_backward(
            dataclasses.replace(cfg, remat=mode), tp, ts, *batch)
    assert kept["none"] > kept["dots"] > kept["block"] > kept["repeat"] > 0, kept
    assert 0 < hooked["none"] <= kept["none"]
    # dots keeps the two f32 matmul outputs [M, K, H] and [M, K, B] of
    # every block beyond block's inputs.
    K = cfg.num_frames(4000)
    mm_bytes = cfg.R * cfg.X * 2 * K * (cfg.H + cfg.B) * 4
    assert kept["dots"] - kept["block"] >= mm_bytes


def test_remat_and_scan_unroll_values():
    """The JAX values of remat map to the port's modes; scan_unroll takes
    any int as max(1, v) (no scan here)."""
    assert [remat_mode(v) for v in (False, None, "none", True, "repeat", "block", "dots")] == [
        "none", "none", "none", "repeat", "repeat", "block", "dots"]
    with pytest.raises(ValueError, match="remat"):
        ConvTasNetConfig(remat="everything")
    assert [ConvTasNetConfig(scan_unroll=v).scan_unroll for v in (-3, 0, 1, 6)] == [1, 1, 1, 6]


@pytest.mark.parametrize("remat,unroll", [("dots", 2), ("block", 1), (True, 4), (False, 1)])
def test_remat_header_round_trip_both_packages(tmp_path, remat, unroll):
    """remat and scan_unroll go through each package's checkpoint into the
    other's config and back."""
    jcfg = convtasnet_tpu.ConvTasNetConfig(remat=remat, scan_unroll=unroll, **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(0), jcfg)
    j_path = str(tmp_path / "j.ckpt")
    j_ckpt.save_checkpoint(j_path, jcfg, params, state)
    cfg = t_ckpt.load_checkpoint(j_path)["config"]
    assert (cfg.remat, cfg.scan_unroll) == (remat, unroll)
    tp, ts = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state))
    t_path = str(tmp_path / "t.ckpt")
    t_ckpt.save_checkpoint(t_path, cfg, tp, ts)
    assert t_ckpt.load_header(t_path)["model_config"]["remat"] == remat
    back = j_ckpt.load_checkpoint(t_path)["config"]
    assert (back.remat, back.scan_unroll) == (remat, unroll)
    assert back == jcfg
