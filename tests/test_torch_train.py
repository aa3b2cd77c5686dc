"""One training step of the port against the JAX package (f32, CPU), the
repairs of the model's kernel dispatch, and checkpoints with optimizer
state in both directions.

Parameters come from convtasnet_tpu.init_params (params_from_jax),
batches from numpy. Tolerances: rtol 5e-4 / atol 5e-5 on losses, new
parameters and state; rtol 2e-3 / atol 5e-4 on gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
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
SMALL = dict(N=16, L=4, B=128, H=128, P=3, X=2, R=1, C=2, compute_dtype="float32")
JAX_FORM = {"0": False, "hybrid": "hybrid", "whole": "whole"}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)


def _setup(seed, norm_type="gLN", use_kernels="0", M=2, T=402):
    jcfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm_type,
                                           use_pallas=JAX_FORM[use_kernels], **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(M, 2, T)) * 0.3).astype(np.float32)
    mix = src.sum(1)
    lens = np.array([T, T - 61], np.int32)
    tp, ts = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state), "cpu")
    cfg = ConvTasNetConfig(norm_type=norm_type, use_kernels=use_kernels, **SMALL)
    return jcfg, params, state, cfg, tp, ts, (mix, src, lens)


@pytest.mark.parametrize("norm_type,use_kernels", [("gLN", "0"), ("gLN", "hybrid"),
                                                   ("cLN", "whole"), ("BN", "0")])
def test_train_step_matches_jax(norm_type, use_kernels):
    """Loss, gradients, the clipped update and (BN) the running state of
    one step, each package in the same kernel form. SGD with momentum:
    Adam's first step divides each gradient by its own magnitude, which
    makes near-zero gradient elements ill-conditioned (Adam is held to
    JAX in test_torch_loss_optim.py)."""
    jcfg, params, state, cfg, tp, ts, (mix, src, lens) = _setup(5, norm_type, use_kernels)
    jmodel = convtasnet_tpu.ConvTasNet(jcfg)

    def jloss(p):
        est, new_state = jmodel.apply(p, state, jnp.asarray(mix), train=True)
        return convtasnet_tpu.cal_loss(jnp.asarray(src), est, jnp.asarray(lens))[0], new_state

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    jopt = jo.Optimizer("sgd", lr=0.1, momentum=0.9)
    jstep = j_make_train_step(jmodel, jopt, max_norm=5.0)
    jp, _, jstate, jl2, jgn = jstep(params, jopt.init(params), state, jnp.asarray(mix),
                                    jnp.asarray(src), jnp.asarray(lens))

    leaves_tree = to.tree_map(lambda p: p.clone().requires_grad_(True), tp)
    est, _ = tm.forward(leaves_tree, ts, cfg, torch.from_numpy(mix), train=True)
    loss = cal_loss(torch.from_numpy(src), est, torch.from_numpy(lens))[0]
    tgrads = torch.autograd.grad(loss, to.tree_leaves(leaves_tree))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **FWD)
    for (k, want), got in zip(_leaves(jgrads), tgrads):
        np.testing.assert_allclose(got.numpy(), want, **GRAD, err_msg=k)

    topt = to.Optimizer("sgd", lr=0.1, momentum=0.9)
    step = make_train_step(cfg, topt, max_norm=5.0)
    new_p, opt_state, new_s, tl2, tgn = step(tp, topt.init(tp), ts, torch.from_numpy(mix),
                                             torch.from_numpy(src), torch.from_numpy(lens))
    np.testing.assert_allclose(float(tl2), float(jl2), **FWD)
    np.testing.assert_allclose(float(tgn), float(jgn), **GRAD)
    assert int(opt_state.step) == 1
    for (k, want), (_, got) in zip(_leaves(jp), _leaves(new_p)):
        np.testing.assert_allclose(got, want, **FWD, err_msg=k)
    for (k, want), (_, got) in zip(_leaves(jstate), _leaves(new_s)):
        np.testing.assert_allclose(got, want, **FWD, err_msg=k)
    if norm_type == "BN":
        assert not np.allclose(_leaves(new_s).__next__()[1], _leaves(ts).__next__()[1])


@pytest.mark.parametrize("use_kernels", ["auto", "block"])
def test_train_forward_with_inference_kernel_flags_matches_eager(use_kernels):
    """Repair: a training forward with use_kernels auto / block runs the
    eager chain (as the JAX package keeps training on XLA for
    use_pallas=True), so backward works and equals use_kernels=0; it used
    to reach the inference kernels and their in-place residual update."""
    _, _, _, cfg0, tp, ts, (mix, src, lens) = _setup(9)
    cfg = dataclasses.replace(cfg0, use_kernels=use_kernels)
    assert cfg.kernel_form(train=True) == "eager"
    grads = []
    for c in (cfg0, cfg):
        leaves_tree = to.tree_map(lambda p: p.clone().requires_grad_(True), tp)
        est, _ = tm.forward(leaves_tree, ts, c, torch.from_numpy(mix), train=True)
        loss = cal_loss(torch.from_numpy(src), est, torch.from_numpy(lens))[0]
        grads.append(torch.autograd.grad(loss, to.tree_leaves(leaves_tree)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_kernel_form_rules():
    """The dispatch table of config.kernel_form (convtasnet_tpu
    conv_tasnet.py:182-233)."""
    want = {("auto", False): "whole_tcn", ("block", False): "whole_block",
            ("hybrid", False): "whole_tcn", ("whole", False): "whole_tcn",
            ("0", False): "eager", ("auto", True): "eager", ("block", True): "eager",
            ("hybrid", True): "whole_tcn_train", ("whole", True): "whole_block_train",
            ("0", True): "eager"}
    for (flag, train), form in want.items():
        cfg = ConvTasNetConfig(use_kernels=flag)
        assert cfg.kernel_form(train) == form, (flag, train)
        bn = ConvTasNetConfig(use_kernels=flag, norm_type="BN")
        assert bn.kernel_form(train) == "eager"


def test_kernel_width_gate_takes_eager_before_any_launch():
    """Repair: B or H not a multiple of 128 takes the eager chain on a
    device with kernels, decided from the config (the JAX package takes
    XLA there); the forward used to reach the kernel wrappers and raise.
    A forward on the meta device follows the CUDA dispatch without a card."""
    cfg = ConvTasNetConfig(N=16, L=4, B=96, H=128, X=2, R=1, use_kernels="auto")
    assert cfg.kernel_form(device="cuda") == "eager"
    assert cfg.kernel_form(train=True, device="cuda") == "eager"
    assert cfg.kernel_form(device="cpu") == "whole_tcn"  # plain versions: any width
    assert ConvTasNetConfig().kernel_form() == "whole_tcn"  # paper widths: kernels
    params, state = tm.init_params(torch.Generator(), cfg, device="meta")
    est, _ = tm.forward(params, state, cfg, torch.empty((2, 400), device="meta"))
    assert est.shape == (2, 2, 400)


def test_module_parameters_are_trainable():
    """Repair: the module's parameters require grad (BN running statistics
    stay buffers), so a module forward in train mode backpropagates."""
    cfg = ConvTasNetConfig(N=16, L=4, B=16, H=32, X=2, R=1, norm_type="BN",
                           compute_dtype="float32", use_kernels="0")
    model = tm.ConvTasNet(cfg, device="cpu").train()
    assert all(p.requires_grad for p in model.parameters())
    assert {k for k, _ in model.named_buffers()} == {"bn_in_mean", "bn_in_var", "bn_dw_mean",
                                                     "bn_dw_var"}
    before = model.bn_in_mean.clone()
    model(torch.randn(2, 200)).square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    assert not torch.equal(model.bn_in_mean, before) and not model.bn_in_mean.requires_grad


def test_hybrid_memory_gate_falls_back_to_the_whole_chain(monkeypatch):
    """Repair: use_kernels=hybrid takes the `whole` chain (whole_chain_train,
    which saves the block inputs alone) when the whole-TCN op's residuals
    exceed the budget; both give the eager gradients. The fallback's bytes
    are the block inputs', a third of the whole-TCN op's at B = H / 2."""
    _, _, _, cfg0, tp, ts, (mix, src, lens) = _setup(4)
    cfg = dataclasses.replace(cfg0, use_kernels="hybrid")
    K_pad = 256
    assert tm.residual_bytes(cfg, 2, K_pad) == 2 * 2 * K_pad * 256 * 4
    assert tm.fallback_bytes(cfg, 2, K_pad) == 2 * 2 * K_pad * cfg.B * 4
    assert 3 * tm.fallback_bytes(dataclasses.replace(cfg, B=256, H=512), 2, K_pad) == \
        tm.residual_bytes(dataclasses.replace(cfg, B=256, H=512), 2, K_pad)
    calls = []
    for name in ("whole_tcn_train", "whole_chain_train"):
        fn = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                        _fn(*a, **k))[1])
    grads = {}
    for tag, budget in (("eager", None), ("hybrid", 1 << 30), ("fallback", 1024)):
        monkeypatch.setattr(tm, "residual_budget", lambda device, b=budget: b)
        if budget is not None:
            assert tm.chain_form(cfg, True, 2, 200, "cpu") == (
                "whole_tcn_train" if tag == "hybrid" else "whole_block_train")
        leaves_tree = to.tree_map(lambda p: p.clone().requires_grad_(True), tp)
        est, _ = tm.forward(leaves_tree, ts, cfg0 if tag == "eager" else cfg,
                            torch.from_numpy(mix), train=True)
        loss = cal_loss(torch.from_numpy(src), est, torch.from_numpy(lens))[0]
        grads[tag] = torch.autograd.grad(loss, to.tree_leaves(leaves_tree))
    assert calls == ["whole_tcn_train", "whole_chain_train"]
    for tag in ("hybrid", "fallback"):
        for a, b in zip(grads[tag], grads["eager"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def _opt_trees(kind):
    jcfg = convtasnet_tpu.ConvTasNetConfig(**SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(1), jcfg)
    jopt = jo.Optimizer(kind, lr=1e-3, momentum=0.0)
    g = jax.tree_util.tree_map(lambda p: 0.01 * jnp.ones_like(p), params)
    jp, js = jopt.update(g, jopt.init(params), params)
    return jcfg, jp, state, js


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_jax_checkpoint_with_optimizer_loads_in_port(tmp_path, kind):
    jcfg, jp, state, js = _opt_trees(kind)
    path = str(tmp_path / "j.ckpt")
    j_ckpt.save_checkpoint(path, jcfg, jp, state, opt_state=js, epoch=2, extra={"a": 1})
    cfg = ConvTasNetConfig(**SMALL)
    tp, ts = tm.init_params(torch.Generator(), cfg)
    template = to.Optimizer(kind).init(tp)
    ck = t_ckpt.load_checkpoint(path, "cpu", params_template=tp, state_template=ts,
                                opt_template=template)
    opt = ck["opt_state"]
    assert int(opt.step) == 1 and opt.step.dtype == torch.int32
    np.testing.assert_allclose(float(opt.lr), 1e-3, rtol=1e-7)
    for part in ("mu", "nu"):
        got = dict(_leaves(getattr(opt, part)))
        want = dict(_leaves(jax.tree_util.tree_map(np.asarray, getattr(js, part))))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert ck["header"]["extra"] == {"a": 1} and ck["header"]["epoch"] == 2


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_port_checkpoint_with_optimizer_loads_in_jax(tmp_path, kind):
    cfg = ConvTasNetConfig(**SMALL)
    tp, ts = tm.init_params(torch.Generator().manual_seed(0), cfg)
    topt = to.Optimizer(kind, lr=1e-3)
    grads = to.tree_map(lambda p: 0.01 * torch.ones_like(p), tp)
    tp, tstate = topt.update(grads, topt.init(tp), tp)
    path = str(tmp_path / "t.ckpt")
    t_ckpt.save_checkpoint(path, cfg, tp, ts, opt_state=tstate, epoch=3,
                           extra={"step_in_epoch": 2})
    jcfg, jp, jstate, js = _opt_trees(kind)
    ck = j_ckpt.load_checkpoint(path, params_template=jp, state_template=jstate,
                                opt_template=js)
    assert int(ck["opt_state"].step) == 1 and ck["header"]["epoch"] == 3
    for part in ("mu", "nu"):
        got = dict(_leaves(jax.tree_util.tree_map(np.asarray, getattr(ck["opt_state"], part))))
        want = dict(_leaves(getattr(tstate, part)))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for (k, a), (_, b) in zip(_leaves(ck["params"]), _leaves(tp)):
        np.testing.assert_array_equal(a, b, err_msg=k)
