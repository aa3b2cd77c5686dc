"""The paper's final Conv-TasNet (a skip path: Sc skip channels, the mask
from PReLU of the skip sum; a linear encoder, a gLN input norm, a sigmoid
mask) in convtasnet_torch against the plain reference
benchmark/reference/convtasnet_skip.py (f32, CPU), and the rules that
route such a config.

Tolerances: forward rtol 5e-4 / atol 5e-5, those of tests/test_pallas_tcn.py:
the two differ only in the order of f32 sums (the reference convolves
channels first with F.conv1d, the port multiplies channels last, the
kernels' plain versions sum the norm statistics from partials). Loss and
gradients rtol 2e-3 / atol 5e-4, those of the port's gradient tests
(tests/test_torch_train_ops.py): the same reordering carried through the
uPIT loss's division by each estimate's energy, and through 12 blocks of
backward. A planted fault (one block's skip add left out) shows that these
tolerances see the skip path."""

import dataclasses
from unittest import mock

import pytest
import torch

from benchmark.reference import convtasnet_skip as ref
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.models import streaming
from convtasnet_torch.ops.kernels import tcn_block, tcn_block_bwd, whole_tcn
from convtasnet_torch.ops.loss import cal_loss
from convtasnet_torch.parallel.comm import ParallelContext
from convtasnet_torch.training.checkpoint import load_header, load_model, save_checkpoint

torch.set_num_threads(1)
FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)
SMALL = dict(N=32, L=16, B=16, H=32, P=3, X=3, R=2, C=2, Sc=16, compute_dtype="float32")
# (mask_nonlinear, encoder_relu, input_norm, norm_type, causal): the taslp
# config's own design first, then each final-version key on its own.
VARIANTS = [("sigmoid", False, "gLN", "gLN", False), ("relu", True, "cLN", "gLN", False),
            ("softmax", False, "cLN", "cLN", True), ("sigmoid", True, "gLN", "cLN", False)]
IDS = ["taslp", "relu-encoder_relu", "softmax-cLN-causal", "sigmoid-input_gLN"]


def _cfg(variant, use_kernels="0", **kw):
    mask, relu, inorm, norm, causal = variant
    return ConvTasNetConfig(**{**SMALL, **kw}, mask_nonlinear=mask, encoder_relu=relu,
                            input_norm=inorm, norm_type=norm, causal=causal,
                            use_kernels=use_kernels)


def _model(cfg):
    return ref.Model(**dataclasses.asdict(cfg))


def _params(cfg, seed=3):
    params, _ = tm.init_params(torch.Generator().manual_seed(seed), cfg)
    return params


def _data(seed=5, M=2, T=800, C=2):
    g = torch.Generator().manual_seed(seed)
    src = torch.randn((M, C, T), generator=g)
    return src.sum(1), src, torch.full((M,), T, dtype=torch.int32)


def _leaves(tree, prefix=""):
    return ref.leaves(tree, prefix)


@pytest.mark.parametrize("form", ["0", "auto", "block"])
@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_forward_matches_the_reference(variant, form):
    """Inference: the eager chain, the whole-TCN form (the fold over [out_w
    | skip_w]) and the whole-block form (K3 unfold with the skip add), by
    their plain versions."""
    cfg = _cfg(variant, form)
    assert cfg.kernel_form(False, "cpu") == {"0": "eager", "auto": "whole_tcn",
                                             "block": "whole_block"}[form]
    params = _params(cfg)
    mix, _, _ = _data()
    with torch.no_grad():
        got, _ = tm.forward(params, {}, cfg, mix)
    want = ref.forward(params, _model(cfg), mix, ref.rounding(None))
    torch.testing.assert_close(got, want, **FWD)


def _loss_and_grads(fn, params, batch):
    names = [n for n, _ in _leaves(params)]
    flat = [t.clone().requires_grad_(True) for _, t in _leaves(params)]
    tree = ref._tree(list(zip(names, flat)))
    loss = fn(tree, batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, flat)))


@pytest.mark.parametrize("form", ["0", "hybrid"])
@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_loss_and_every_gradient_match_the_reference(variant, form):
    """Training: the eager chain under autograd and the whole-TCN training
    op (plain stages: the skip sum through every block forward, its one
    cotangent to every block's KB1 and KW z backward, KF over [out_w |
    skip_w]); every leaf, skip_w and mask/prelu among them."""
    cfg = _cfg(variant, form)
    assert cfg.kernel_form(True, "cpu") == {"0": "eager", "hybrid": "whole_tcn_train"}[form]
    params = _params(cfg)
    batch = _data()

    def port(tree, b):
        est, _ = tm.forward(tree, {}, cfg, b[0], train=True)
        return cal_loss(b[1], est, b[2])[0]

    def plain(tree, b):
        return ref.pit_loss(b[1], ref.forward(tree, _model(cfg), b[0], ref.rounding(None)), b[2])

    loss, grads = _loss_and_grads(port, params, batch)
    r_loss, r_grads = _loss_and_grads(plain, params, batch)
    assert {"separator/blocks/skip_w", "separator/mask/prelu"} <= set(grads)
    torch.testing.assert_close(loss, r_loss, **GRAD)
    for name, g in r_grads.items():
        torch.testing.assert_close(grads[name], g, **GRAD, msg=lambda m: f"{name}: {m}")


def _drop_one_skip_add(block=1):
    """The eager block `block` adds nothing into the skip sum."""
    calls = []
    real = tm._temporal_block

    def faulty(x, s, *a, **k):
        out = real(x, s, *a, **k)
        calls.append(1)
        return (out[0], s, out[2]) if len(calls) == block + 1 else out
    return mock.patch.object(tm, "_temporal_block", faulty)


def _drop_one_skip_add_kernel(block=1):
    """The plain K3 of block `block` adds nothing into the skip sum."""
    calls = []
    in_gemm, dwconv, out_gemm = whole_tcn.PLAIN_STAGES

    def faulty(e, stats2, res, wmat, vec_a, vec_b, norm_type, valid_k, fold, out=None,
               skip=None):
        calls.append(1)
        keep = None if skip is None else skip.clone()
        got = out_gemm(e, stats2, res, wmat, vec_a, vec_b, norm_type, valid_k, fold, out, skip)
        if keep is not None and len(calls) == block + 1:
            skip.copy_(keep)
        return got
    return mock.patch.object(whole_tcn, "PLAIN_STAGES", (in_gemm, dwconv, faulty))


@pytest.mark.parametrize("form,plant", [("0", _drop_one_skip_add),
                                        ("auto", _drop_one_skip_add_kernel)],
                         ids=["eager", "whole_tcn"])
def test_a_skip_add_left_out_fails_the_comparison(form, plant):
    cfg = _cfg(VARIANTS[0], form)
    params = _params(cfg)
    mix, _, _ = _data()
    want = ref.forward(params, _model(cfg), mix, ref.rounding(None))
    with torch.no_grad(), plant():
        got, _ = tm.forward(params, {}, cfg, mix)
    assert not torch.allclose(got, want, **FWD)
    err = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    assert err > 100 * FWD["rtol"], err


def test_bf16_rounding_points_follow_the_port():
    """In bf16 the reference (rounding where the port stores an activation,
    the skip sum and the mask head's PReLU among them) sits at the port's
    rounding noise, far closer than one precision below (fp8)."""
    cfg = _cfg(VARIANTS[0], "auto", compute_dtype="bfloat16")
    params = _params(cfg)
    mix, _, _ = _data(T=4000)
    with torch.no_grad():
        got, _ = tm.forward(params, {}, cfg, mix)
    bf = ref.forward(params, _model(cfg), mix, ref.rounding(torch.bfloat16))
    fp8 = ref.forward(params, _model(cfg), mix, ref.rounding(ref.FP8))
    assert ref.wave_error(got, bf) < 0.05
    assert ref.wave_error(fp8, bf) > 3 * ref.wave_error(got, bf)


def test_parameters_of_the_published_config():
    """N=512 L=16 B=128 Sc=128 H=512 P=3 X=8 R=3: 5,018,673 parameters
    without biases; the skip path's leaves and the head's shapes."""
    cfg = ConvTasNetConfig(N=512, L=16, B=128, Sc=128, H=512, P=3, X=8, R=3, C=2,
                           mask_nonlinear="sigmoid", encoder_relu=False, input_norm="gLN")
    params, _ = tm.init_params(torch.Generator(), cfg, device="meta")
    shapes = dict((n, tuple(t.shape)) for n, t in _leaves(params))
    assert sum(t.numel() for _, t in _leaves(params)) == 5_018_673
    assert shapes["separator/blocks/skip_w"] == (3, 8, 512, 128)
    assert shapes["separator/mask/w"] == (128, 1024) and shapes["separator/mask/prelu"] == ()
    first = ConvTasNetConfig()
    p1, _ = tm.init_params(torch.Generator(), first, device="meta")
    assert "skip_w" not in p1["separator"]["blocks"] and "prelu" not in p1["separator"]["mask"]


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_checkpoint_header_round_trip(tmp_path, variant):
    cfg = _cfg(variant, "auto")
    params = _params(cfg)
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, cfg, params, {})
    header = load_header(path)["model_config"]
    assert {k: header[k] for k in ("Sc", "mask_nonlinear")} == {
        "Sc": 16, "mask_nonlinear": variant[0]}
    got_cfg, got, _ = load_model(path)
    assert got_cfg == dataclasses.replace(cfg, use_kernels="auto")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(got), _leaves(params)))


def test_first_version_header_holds_no_new_key(tmp_path):
    """A first-version config writes the header the JAX package reads, and
    a header without the new keys loads as the first version."""
    cfg = ConvTasNetConfig(**{k: v for k, v in SMALL.items() if k != "Sc"})
    header = cfg.header_dict()
    assert not {"Sc", "encoder_relu", "input_norm"} & set(header)
    back = ConvTasNetConfig.from_header(header)
    assert (back.Sc, back.encoder_relu, back.input_norm) == (0, True, "cLN")
    assert back.first_version and not _cfg(VARIANTS[1]).first_version


@pytest.mark.parametrize("kw,train,flag,form", [
    ({}, True, "whole", "eager"),           # the recompute chain has no skip path
    ({}, True, "hybrid", "whole_tcn_train"),
    ({}, False, "auto", "whole_tcn"),
    ({}, False, "block", "whole_block"),
    ({"compute_dtype": "float32"}, False, "auto", "eager"),  # skip modes: bf16 only
    ({"Sc": 64}, True, "hybrid", "eager"),  # Sc not a multiple of 128
    ({"Sc": 0}, True, "whole", "whole_block_train"),
])
def test_kernel_form_of_a_skip_config_on_a_card(kw, train, flag, form):
    cfg = ConvTasNetConfig(**{**dict(N=512, L=16, B=128, Sc=128, H=512, X=8, R=3),
                              "use_kernels": flag, **kw})
    assert cfg.kernel_form(train, "cuda") == form


def test_memory_gate_sends_a_skip_config_to_the_eager_chain(monkeypatch):
    cfg = ConvTasNetConfig(**{**SMALL, "use_kernels": "hybrid"})
    assert tm.chain_form(cfg, True, 2, 49, "cpu") == "whole_tcn_train"
    monkeypatch.setattr(tm, "CPU_RESIDUAL_BUDGET", 1)
    assert tm.chain_form(cfg, True, 2, 49, "cpu") == "eager"
    first = ConvTasNetConfig(**{**SMALL, "Sc": 0, "use_kernels": "hybrid"})
    assert tm.chain_form(first, True, 2, 49, "cpu") == "whole_block_train"
    # the skip sum is one buffer, counted once
    assert tm.residual_bytes(cfg, 2, 128) - tm.residual_bytes(first, 2, 128) == 2 * 128 * 16 * 4


@pytest.mark.parametrize("variant", VARIANTS[:2], ids=IDS[:2])
def test_tp_cp_and_streaming_refuse_the_final_design(variant):
    cfg = _cfg(variant)
    params = _params(cfg)
    w = torch.zeros((1, 10, cfg.N))
    with pytest.raises(ValueError, match="first version"):
        tm.separate(params, {}, cfg, w, par=ParallelContext(model=object()))
    with pytest.raises(ValueError, match="first version"):
        tm.separate(params, {}, cfg, w, par=ParallelContext(context=object()))
    causal = dataclasses.replace(cfg, causal=True, norm_type="cLN")
    with pytest.raises(ValueError, match="first version"):
        streaming.init_stream_state(causal, 1, "cpu")


@pytest.mark.parametrize("B,Sc,bn", [(128, 128, 128), (256, 256, 256), (256, 128, 128),
                                     (128, 256, 128)])
def test_skip_tiles_never_straddle_the_seam(B, Sc, bn):
    """K3 skip and KW z skip take column tiles that start at B, the seam
    between x's (g's) columns and s's (g_s's)."""
    _, got = tcn_block.gemm_plan(8 * 4096, B + Sc, 512, 132, seam=B)
    assert got <= bn and B % got == 0
    plan = tcn_block_bwd.wgrad_plan(8 * 4096, 4096, 512, B + Sc, 132, seam=B)
    assert plan.bn == bn and B % plan.bn == 0
    assert tcn_block_bwd.wgrad_plan(8 * 4096, 4096, 512, 2 * B, 132).bn == 256


@pytest.mark.parametrize("Sc", [0, 16])
def test_counters_of_a_plain_run_do_not_move(Sc):
    """On the CPU the plain versions count no launches: the skip modes'
    counters are listed beside the first version's, at zero."""
    tcn_block.reset_counts()
    tcn_block_bwd.reset_counts()
    cfg = ConvTasNetConfig(**{**SMALL, "Sc": Sc, "use_kernels": "hybrid"})
    names, flat = zip(*[(n, t.requires_grad_(True)) for n, t in _leaves(_params(cfg))])
    mix, src, lens = _data()
    est, _ = tm.forward(ref._tree(list(zip(names, flat))), {}, cfg, mix, train=True)
    cal_loss(src, est, lens)[0].backward()
    assert all(t.grad is not None for t in flat)
    counts = {**tcn_block.counts(), **tcn_block_bwd.counts()}
    assert {"tcn_out_gemm_unfold_skip", "tcn_out_gemm_fold_skip", "tcn_fold_weights_skip",
            "tcn_bwd_dz_skip", "tcn_wgrad_out_skip", "tcn_bwd_finish_skip"} <= set(counts)
    assert not any(counts.values())


def test_the_final_design_on_the_normal_path(tmp_path):
    """The train CLI takes the final version's flags and trains it through
    the Solver (hybrid: the whole-TCN training op's plain stages here); the
    checkpoint's header carries them; evaluate reads it back, and the
    separate CLI's estimates are the reference's forward of the trained
    parameters (PCM_16 wavs in and out)."""
    from convtasnet_torch.cli import evaluate, separate, train
    from convtasnet_torch.data.synthetic import make_wav_dataset
    from convtasnet_torch.data.wavio import read_wav

    root = make_wav_dataset(str(tmp_path / "data"), n_utts=3, min_sec=0.6, max_sec=0.8, seed=4)
    exp = str(tmp_path / "exp")
    train.main(["--train_dir", f"{root}/tr", "--valid_dir", f"{root}/cv", "--device", "cpu",
                "--N", "32", "--L", "16", "--B", "16", "--H", "32", "--X", "3", "--R", "2",
                "--Sc", "16", "--mask_nonlinear", "sigmoid", "--encoder_relu", "0",
                "--input_norm", "gLN", "--segment", "0.5", "--batch_size", "2",
                "--compute_dtype", "float32", "--epochs", "1", "--use_kernels", "hybrid",
                "--save_folder", exp, "--num_workers", "0"])
    ckpt = f"{exp}/final.ckpt"
    cfg, params, _ = load_model(ckpt)
    assert (cfg.Sc, cfg.encoder_relu, cfg.input_norm, cfg.mask_nonlinear) == (
        16, False, "gLN", "sigmoid")
    assert evaluate.main(["--model_path", ckpt, "--data_dir", f"{root}/tt", "--device",
                          "cpu"]) is not None
    separate.main(["--model_path", ckpt, "--mix_dir", str(tmp_path / "data/wav/tt/mix"),
                   "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    name = sorted(p.stem for p in (tmp_path / "data/wav/tt/mix").glob("*.wav"))[0]
    mix = torch.from_numpy(read_wav(str(tmp_path / f"data/wav/tt/mix/{name}.wav"))[0])[None]
    got = torch.stack([torch.from_numpy(read_wav(str(tmp_path / f"out/{name}_s{c}.wav"))[0])
                       for c in (1, 2)])
    want = ref.forward(params, _model(cfg), mix, ref.rounding(None))[0]
    assert ref.wave_error(got, want) < 1e-3  # PCM_16 quantisation of both wavs


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group on the CPU for the test's duration."""
    from convtasnet_torch.parallel import distributed

    distributed.initialize(f"file://{tmp_path}/store", 1, 0, device_type="cpu")
    yield
    distributed.shutdown()


@pytest.mark.parametrize("use_kernels", ["0", "hybrid"])
def test_dp_takes_the_skip_leaves_unchanged(world1, use_kernels):
    """A DP mesh step (its one flat gradient bucket, all-reduced) over the
    skip path's leaves, the head's 0-d PReLU slope among them, equals the
    plain step."""
    from convtasnet_torch.parallel.mesh import make_mesh
    from convtasnet_torch.training.optim import Optimizer
    from convtasnet_torch.training.solver import make_train_step

    cfg = _cfg(VARIANTS[0], use_kernels)
    params = _params(cfg)
    opt = Optimizer("adam", lr=1e-3)
    mix, src, lens = _data()
    out = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh())):
        step = make_train_step(cfg, opt, 5.0, mesh)
        p, o = params, opt.init(params)
        for _ in range(2):
            p, o, _, loss, _ = step(p, o, {}, mix, src, lens)
        out[name] = (loss, p)
    torch.testing.assert_close(out["mesh"][0], out["plain"][0], rtol=1e-6, atol=0)
    for (n, a), (_, b) in zip(_leaves(out["mesh"][1]), _leaves(out["plain"][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=n)
