"""convtasnet_torch.cli.train and the Solver on the CPU: checkpoints,
mid-epoch resume, and the LR-halving / early-stop sequence against the
JAX Solver on the same scripted CV losses."""

import os

import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.cli.train import main as train_main
from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
from convtasnet_torch.data.dataset import AudioDataset, DataLoader
from convtasnet_torch.data.synthetic import make_wav_dataset
from convtasnet_torch.models.conv_tasnet import ConvTasNet
from convtasnet_torch.training.checkpoint import load_checkpoint
from convtasnet_torch.training.solver import Solver
from convtasnet_tpu.data.dataset import AudioDataset as JAudioDataset
from convtasnet_tpu.training.solver import Solver as JSolver

torch.set_num_threads(1)
NET = ["--N", "16", "--L", "8", "--B", "128", "--H", "128", "--X", "2", "--R", "1",
       "--compute_dtype", "float32", "--device", "cpu", "--num_workers", "1",
       "--print_freq", "1", "--segment", "0.5", "--batch_size", "2"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav")
    return make_wav_dataset(str(root), n_utts=4, min_sec=0.6, max_sec=1.0, seed=3,
                            splits=("tr", "cv"))


def _args(data, folder, *extra):
    return ["--train_dir", os.path.join(data, "tr"), "--valid_dir", os.path.join(data, "cv"),
            "--save_folder", str(folder), *NET, *extra]


def _params(path):
    return {k: v for k, v in load_checkpoint(path)["arrays"].items()
            if k.startswith("params/")}


def test_dataset_plan_matches_jax(data):
    """The segment plan and the CV plan (cv_maxlen skip) equal the JAX
    package's, and the batches decode to the same arrays."""
    for kw in (dict(batch_size=2, segment=0.5), dict(batch_size=1, segment=-1, cv_maxlen=0.8)):
        split = "tr" if kw["segment"] > 0 else "cv"
        t = AudioDataset(os.path.join(data, split), **kw)
        j = JAudioDataset(os.path.join(data, split), **kw)
        j.disable_native = True
        assert t.batches == [b["idxs"] for b in j.batches]
        for i in range(len(t)):
            tb, jb = t.load_batch(i), j.load_batch(i)
            np.testing.assert_array_equal(tb.mixture, jb.mixture)
            np.testing.assert_array_equal(tb.source, jb.source)
            np.testing.assert_array_equal(tb.lengths, jb.lengths)


@pytest.mark.parametrize("use_kernels", ["0", "hybrid", "whole"])
def test_train_cli_writes_checkpoints(data, tmp_path, use_kernels):
    """Two epochs with --checkpoint 1 --save_every_steps 1: per-epoch,
    best and latest checkpoints, finite losses, and the same losses for
    every kernel form (the CPU runs their plain versions)."""
    out = train_main(_args(data, tmp_path, "--epochs", "2", "--checkpoint", "1",
                           "--save_every_steps", "1", "--use_kernels", use_kernels))
    assert {"epoch1.ckpt", "epoch2.ckpt", "final.ckpt", "latest.ckpt"} <= set(os.listdir(tmp_path))
    assert out["steps"] == 8 and np.all(np.isfinite(out["tr_loss"] + out["cv_loss"]))
    ck = load_checkpoint(str(tmp_path / "epoch2.ckpt"))
    assert ck["header"]["has_opt"] and int(ck["opt_state"].step) == 8
    assert ck["header"]["tr_loss"] == out["tr_loss"]
    ref = train_main(_args(data, tmp_path / "ref", "--epochs", "1", "--use_kernels", "0"))
    np.testing.assert_allclose(out["tr_loss"][0], ref["tr_loss"][0], rtol=1e-5)


def test_mid_epoch_resume_equals_uninterrupted_run(data, tmp_path):
    """Resuming from a mid-epoch latest.ckpt (step 3 of 4) ends with the
    parameters and loss history of the run that was never cut."""
    full = train_main(_args(data, tmp_path / "full", "--epochs", "2", "--checkpoint", "1"))
    train_main(_args(data, tmp_path / "cut", "--epochs", "1", "--save_every_steps", "3"))
    latest = str(tmp_path / "cut" / "latest.ckpt")
    assert load_checkpoint(latest)["header"]["extra"]["step_in_epoch"] == 3
    resumed = train_main(_args(data, tmp_path / "resumed", "--epochs", "2", "--checkpoint", "1",
                               "--continue_from", latest))
    assert resumed["steps"] == 5
    np.testing.assert_allclose(resumed["tr_loss"], full["tr_loss"], rtol=1e-6)
    want = _params(str(tmp_path / "full" / "epoch2.ckpt"))
    got = _params(str(tmp_path / "resumed" / "epoch2.ckpt"))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_later_slice_flags_raise(data, tmp_path):
    """--remat block and --visualize 1 (which waited for a later slice)
    train now: the remat run's losses equal the plain run's, and the
    visualize run writes loss.png or logs why not. --dp 2 still raises."""
    ref = train_main(_args(data, tmp_path / "ref", "--epochs", "1"))
    out = train_main(_args(data, tmp_path / "remat", "--epochs", "1", "--remat", "block",
                           "--scan_unroll", "2"))
    np.testing.assert_allclose(out["tr_loss"], ref["tr_loss"], rtol=1e-6)
    assert load_checkpoint(str(tmp_path / "remat" / "final.ckpt"))["config"].remat == "block"
    out = train_main(_args(data, tmp_path / "viz", "--epochs", "1", "--visualize", "1"))
    log = open(tmp_path / "viz" / "train.log").read()
    assert (tmp_path / "viz" / "loss.png").exists() or "visualize failed" in log
    assert np.isfinite(out["tr_loss"][0]) and TrainConfig(visualize=True).visualize
    # --dp 2 needs two processes (one per card): in one it names torchrun.
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train_main(_args(data, tmp_path, "--dp", "2"))


CV_SCRIPT = [5.0, 4.0, 4.5, 4.6, 4.7, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5, 3.6, 3.7, 3.8, 3.9, 4.0,
             4.1, 4.2]


def test_lr_halving_and_early_stop_match_jax_solver(tmp_path):
    """The same scripted CV losses drive both Solvers: the learning rates
    after each epoch and the epoch at which early stop ends the run."""
    kw = dict(epochs=len(CV_SCRIPT), half_lr=True, early_stop=True, lr=1e-3)

    def script(solver):
        solver._run_one_epoch = lambda epoch, cross_valid: (
            (CV_SCRIPT[epoch], 0.0) if cross_valid else (1.0, 0.0))
        return solver.train()["history"]

    small = dict(N=8, L=4, B=16, H=16, X=1, R=1, compute_dtype="float32")
    jcfg = convtasnet_tpu.TrainConfig(save_folder=str(tmp_path / "j"), **kw)
    jhist = script(JSolver(convtasnet_tpu.ConvTasNet(convtasnet_tpu.ConvTasNetConfig(**small)),
                           jcfg, [], [], log=lambda s: None))
    tcfg = TrainConfig(save_folder=str(tmp_path / "t"), **kw)
    model = ConvTasNet(ConvTasNetConfig(use_kernels="0", **small), device="cpu")
    thist = script(Solver(model, tcfg, DataLoader([]), DataLoader([]), log=lambda s: None))
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist]
    assert len(thist) < len(CV_SCRIPT)  # early stop fired
    np.testing.assert_allclose([h["lr"] for h in thist], [h["lr"] for h in jhist], rtol=1e-6)
    assert min(h["lr"] for h in thist) < 1e-3  # halving fired
