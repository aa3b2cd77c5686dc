"""The port's mesh, sharding rules, batch sharders and CP padding in one
process (no spawn): shapes and errors, the TP cut and its inverse, zero-row
padding, cp_padded_frames against the JAX package's, the kernel gate
under TP / CP, and the flags that once waited for a later slice (--remat,
--scan_unroll, --visualize), now parsed as the JAX train CLI parses them."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import convtasnet_tpu
from convtasnet_torch.cli import evaluate as t_eval
from convtasnet_torch.cli import separate as t_sep
from convtasnet_torch.cli import train as t_train
from convtasnet_torch.cli.common import resolve_mesh_kernels
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models.conv_tasnet import init_params
from convtasnet_torch.parallel import distributed
from convtasnet_torch.parallel.context import cp_padded_frames
from convtasnet_torch.parallel.mesh import (make_mesh, mesh_shape, shard_batch_fn,
                                            tp_place, tp_rule, tp_slice)
from convtasnet_torch.training.optim import Optimizer, tree_paths
from convtasnet_torch.training.solver import make_train_step
from convtasnet_tpu.cli import train as j_train
from convtasnet_tpu.parallel.context import cp_padded_frames as j_cp_padded_frames

torch.set_num_threads(1)
TINY = dict(N=16, L=8, B=16, H=32, P=3, X=2, R=2, compute_dtype="float32")


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group on the CPU for the test's duration."""
    distributed.initialize(f"file://{tmp_path}/store", 1, 0, device_type="cpu")
    yield
    distributed.shutdown()


@pytest.mark.parametrize("dp,tp,cp,world,want", [
    (0, 1, 1, 8, (8, 1, 1)), (0, 2, 1, 8, (4, 2, 1)), (4, 2, 1, 8, (4, 2, 1)),
    (0, 2, 2, 8, (2, 2, 2)), (0, 1, 4, 4, (1, 1, 4)), (1, 1, 1, 1, (1, 1, 1)),
])
def test_mesh_shape(dp, tp, cp, world, want):
    assert mesh_shape(dp, tp, cp, world) == want


@pytest.mark.parametrize("dp,tp,cp,world", [(8, 2, 1, 8), (2, 1, 1, 1), (0, 3, 1, 8),
                                            (1, 1, 2, 4)])
def test_mesh_shape_mismatch_names_torchrun(dp, tp, cp, world):
    with pytest.raises(ValueError, match="torchrun|not divisible"):
        mesh_shape(dp, tp, cp, world)


def test_make_mesh_world1(world1):
    m = make_mesh()
    assert (m.dp, m.tp, m.cp, m.world) == (1, 1, 1, 1)
    assert (m.data_rank, m.model_rank, m.context_rank) == (0, 0, 0)
    assert m.device_mesh.mesh_dim_names == ("data", "model")
    assert m.replica is m.data and m.context is None
    assert m.par.model is None and m.par.context is None and m.par.data is None
    assert m.device == torch.device("cpu")  # the device initialize() was given
    m3 = make_mesh(1, 1, 1)
    assert m3.device_mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(dp=2)


def test_make_mesh_without_a_device_does_not_pick_the_cpu(tmp_path, monkeypatch):
    """A group joined without initialize(): the rows go to the card, and
    with no card make_mesh raises rather than put them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        assert make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_rank_device_is_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert distributed.device() == torch.device("cuda", 3)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh()


def _tree(C, norm_type):
    cfg = ConvTasNetConfig(C=C, norm_type=norm_type, **TINY)
    params, state = init_params(torch.Generator().manual_seed(C), cfg)
    opt = Optimizer("adam").init(params)
    return cfg, {"params": params, "state": state, "mu": opt.mu, "nu": opt.nu}


@pytest.mark.parametrize("C,norm_type", [(2, "gLN"), (3, "gLN"), (2, "BN"), (3, "BN")])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_cut_and_place_are_inverse(C, norm_type, tp):
    """Every rank's pieces, placed and summed over the ranks, give back
    every leaf exactly; the pieces partition it (no element twice)."""
    cfg, tree = _tree(C, norm_type)
    cut = 0
    for path, t in tree_paths(tree):
        rule = tp_rule(path)
        pieces = [tp_slice(t, rule, tp, m, cfg.C) for m in range(tp)]
        if rule is None:
            assert all(p is t for p in pieces), path
            continue
        cut += 1
        assert sum(p.numel() for p in pieces) == t.numel(), path
        whole = sum(tp_place(p, rule, tp, m, cfg.C) for m, p in enumerate(pieces))
        assert torch.equal(whole, t), path
        ones = sum(tp_place(torch.ones_like(p), rule, tp, m, cfg.C)
                   for m, p in enumerate(pieces))
        assert torch.equal(ones, torch.ones_like(t)), path
    # 10 cut leaves in the parameters and in each moment, BN's 4 statistics
    assert cut == 30 + (4 if norm_type == "BN" else 0)


def test_mask_cut_keeps_each_speaker_on_every_rank():
    """mask/w [B, C*N]: rank m holds columns c*N + n for n in its N chunk."""
    C, B, N, tp = 3, 2, 8, 2
    w = torch.arange(B * C * N, dtype=torch.float32).reshape(B, C * N)
    piece = tp_slice(w, tp_rule("separator/mask/w"), tp, 1, C)
    cols = [c * N + n for c in range(C) for n in range(N // tp, N)]
    assert torch.equal(piece, w[:, cols])


@pytest.mark.parametrize("dp,b", [(2, 3), (2, 5), (3, 5), (4, 4)])
def test_shard_batch_pads_zero_rows(world1, dp, b):
    """The data ranks' rows, in order, are the batch padded with zero rows
    of length 0 to the next multiple of dp, whatever tp is: at dp 2, tp 2
    five rows make six."""
    mix = np.arange(b * 4, dtype=np.float32).reshape(b, 4) + 1
    lens = np.full(b, 4, np.int32)
    src = np.stack([mix, -mix], 1)
    b_pad = -(-b // dp) * dp
    got = [shard_batch_fn(dataclasses.replace(make_mesh(), dp=dp, tp=2, data_rank=d))(
        mix, lens, src) for d in range(dp)]
    assert all(m.shape == (b_pad // dp, 4) for m, _, _ in got)
    np.testing.assert_array_equal(torch.cat([m for m, _, _ in got]).numpy(),
                                  np.pad(mix, [(0, b_pad - b), (0, 0)]))
    np.testing.assert_array_equal(torch.cat([s for _, _, s in got]).numpy(),
                                  np.pad(src, [(0, b_pad - b), (0, 0), (0, 0)]))
    np.testing.assert_array_equal(torch.cat([ln for _, ln, _ in got]).numpy(),
                                  [4] * b + [0] * (b_pad - b))
    assert shard_batch_fn(make_mesh())(mix, lens, None)[2] is None


def test_mesh_step_losses_outlive_the_next_step(world1):
    """The mesh step's loss is its own tensor, not a view of the reused
    gradient bucket: losses kept over steps equal the plain step's."""
    cfg = ConvTasNetConfig(**TINY, use_kernels="0")
    params, state = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = Optimizer("sgd", lr=0.1)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.normal(size=(2, 2, 160)).astype(np.float32))
               for _ in range(3)]
    lens = torch.tensor([160, 120], dtype=torch.int32)
    kept = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh())):
        step = make_train_step(cfg, opt, 5.0, mesh)
        p, o, losses = params, opt.init(params), []
        for src in batches:
            p, o, _, loss, _ = step(p, o, state, src.sum(1), src, lens)
            losses.append(loss)
        kept[name] = torch.stack(losses)
    assert len(set(kept["plain"].tolist())) == 3
    torch.testing.assert_close(kept["mesh"], kept["plain"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("X", [1, 3, 5, 8])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_cp_padded_frames_matches_jax(X, n):
    t = ConvTasNetConfig(X=X, L=20)
    j = convtasnet_tpu.ConvTasNetConfig(X=X, L=20)
    for T in (1, 19, 20, 21, 399, 4000, 32000, 64003):
        assert cp_padded_frames(t, T, n) == j_cp_padded_frames(j, T, n)


def test_cp_padded_frames_holds_the_halo():
    cfg = ConvTasNetConfig()  # the paper config: (P-1)*2**(X-1) = 256
    for n in (1, 2, 4):
        K = cp_padded_frames(cfg, 32000, n)
        assert K % n == 0 and K // n >= 256 and K >= cfg.num_frames(32000)


@pytest.mark.parametrize("tp,cp,want", [(1, 1, "hybrid"), (2, 1, "0"), (1, 2, "0"),
                                        (2, 2, "0")])
def test_resolve_mesh_kernels(tp, cp, want):
    cfg = ConvTasNetConfig(use_kernels="hybrid")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = resolve_mesh_kernels(cfg, tp, cp)
    assert got.use_kernels == want
    assert bool(caught) == (want == "0")
    assert resolve_mesh_kernels(dataclasses.replace(cfg, use_kernels="0"), 2, 1).use_kernels == "0"


def test_later_flags_are_remat_scan_unroll_visualize():
    """The three flags parse on the train CLI only, with the JAX train
    CLI's types, defaults and choices, and nothing waits any more."""
    def actions(build):
        return {a.dest: a for a in build()._actions}

    ours, jax_ = actions(t_train.build_parser), actions(j_train.build_parser)
    for flag in ("remat", "scan_unroll", "visualize"):
        assert (ours[flag].type, ours[flag].default, ours[flag].choices) == (
            jax_[flag].type, jax_[flag].default, jax_[flag].choices), flag
    args = t_train.build_parser().parse_args(
        ["--train_dir", "a", "--valid_dir", "b", "--remat", "dots", "--scan_unroll", "3",
         "--visualize", "1"])
    assert (args.remat, args.scan_unroll, args.visualize) == ("dots", 3, 1)
    for mod in (t_eval, t_sep):
        assert not {"remat", "scan_unroll", "visualize"} & actions(mod.build_parser).keys()
    for mod in (t_train, t_eval, t_sep):
        assert not hasattr(mod, "LATER_FLAGS")
    for build in (t_train.build_parser, t_eval.build_parser, t_sep.build_parser):
        flags = {a.dest for a in build()._actions}
        assert {"dp", "tp", "cp", "multihost", "coordinator_address", "num_processes",
                "process_id"} <= flags


def test_jax_names_of_the_mesh_flags_default_as_in_jax():
    """--dp defaults: train 0 (all ranks), evaluate and separate 1."""
    args = t_train.build_parser().parse_args(["--train_dir", "a", "--valid_dir", "b"])
    assert (args.dp, args.tp, args.cp, args.multihost) == (0, 1, 1, 0)
    args = t_eval.build_parser().parse_args(["--model_path", "m", "--data_dir", "d"])
    assert (args.dp, args.tp, args.cp) == (1, 1, 1)
