"""The train, evaluate and separate CLIs of the port in 2 gloo processes
on the CPU against the same CLIs in one process, and the mapping of the
JAX package's rendezvous names onto init_process_group.

Each rank is a spawned process running the CLI's main with the JAX-style
flags (--coordinator_address file://..., --num_processes, --process_id).
Tolerances: losses rtol 1e-4; parameters after SGD training rtol 2e-3 /
atol 1e-5 (the DP gradient is the sum of two partial sums); SI-SNRi and
SDRi 1e-3 dB; separated wavs 1e-4 (PCM16 steps are 3e-5). CP pads the
frame axis to a multiple of the ranks (gLN statistics include the pad, as
in the JAX package's cp_forward). The training segments are 4004 samples,
1000 frames, which need no pad, so CP training is held to the DP bounds;
full utterances do get a pad, so CP's CV loss is held to rtol 2e-3 and
its evaluate metrics and wavs to 0.05 dB and 1e-2 (wavs up to the start
of the single-card forward's last frame, which the padded frame overlaps).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from convtasnet_torch.cli.evaluate import main as evaluate_main
from convtasnet_torch.cli.separate import main as separate_main
from convtasnet_torch.cli.train import main as train_main
from convtasnet_torch.data.synthetic import make_wav_dataset
from convtasnet_torch.data.wavio import read_wav
from convtasnet_torch.models.conv_tasnet import forward
from convtasnet_torch.parallel import distributed
from convtasnet_torch.training.checkpoint import load_checkpoint, load_model

import torch_parallel_worker as worker

torch.set_num_threads(1)
NET = ["--N", "16", "--L", "8", "--B", "16", "--H", "32", "--X", "2", "--R", "1",
       "--compute_dtype", "float32", "--device", "cpu", "--num_workers", "1",
       "--print_freq", "1", "--segment", "0.50051", "--batch_size", "3", "--cv_batch_size", "2",
       "--optimizer", "sgd", "--lr", "0.05", "--epochs", "1", "--use_kernels", "hybrid"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav")
    return make_wav_dataset(str(root), n_utts=4, min_sec=0.6, max_sec=1.0, seed=3,
                            splits=("tr", "cv", "tt"))


def _spawn(out_dir, cli, argv, world=2):
    codes = worker.run_ranks(world, worker.cli_main, (str(out_dir), cli, argv))
    errors = [open(f).read() for f in sorted(glob.glob(os.path.join(out_dir, "error_*")))]
    assert codes == [0] * world, errors
    return [json.load(open(os.path.join(out_dir, f"{cli}_r{r}.json"))) for r in range(world)]


def _params(path):
    return {k: v for k, v in load_checkpoint(path)["arrays"].items() if k.startswith("params/")}


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """The train CLI in one process, at DP 2 and at TP 2 (world 2)."""
    d = tmp_path_factory.mktemp("train")
    base = ["--train_dir", os.path.join(data, "tr"), "--valid_dir", os.path.join(data, "cv"),
            *NET]
    one = train_main(base + ["--save_folder", str(d / "one")])
    dp = _spawn(d, "train", base + ["--save_folder", str(d / "dp"), "--dp", "2"])
    runs = {"dp": dp}
    for mode, flags in (("tp", ["--tp", "2", "--dp", "1"]), ("cp", ["--cp", "2", "--dp", "1"])):
        (d / mode).mkdir()
        runs[mode] = _spawn(d / mode, "train", base + ["--save_folder", str(d / mode), *flags])
    return d, one, runs


@pytest.mark.parametrize("mode,cv_tol", [("dp", 1e-4), ("tp", 1e-4), ("cp", 2e-3)])
def test_train_cli_world2_matches_one_process(trained, mode, cv_tol):
    d, one, runs = trained
    for r in runs[mode]:
        assert r["steps"] == one["steps"]
        np.testing.assert_allclose(r["tr_loss"], one["tr_loss"], rtol=1e-4)
        np.testing.assert_allclose(r["cv_loss"], one["cv_loss"], rtol=cv_tol)
    want = _params(str(d / "one" / "final.ckpt"))
    got = _params(str(d / mode / "final.ckpt"))  # whole, from the coordinator
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-5, err_msg=k)


def test_tp_checkpoint_loads_at_tp1(trained, data):
    """The TP run's checkpoint is the whole tree: it loads in one process
    and separates like the one-process run's checkpoint."""
    d = trained[0]
    mix = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 4000)).astype(np.float32))
    outs = []
    for run in ("one", "tp"):
        cfg, params, state = load_model(str(d / run / "final.ckpt"), "cpu")
        outs.append(forward(params, state, cfg, mix)[0])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=2e-3, atol=1e-4)


def test_train_cli_dp2_in_one_process_raises(data, tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train_main(["--train_dir", os.path.join(data, "tr"), "--valid_dir",
                    os.path.join(data, "cv"), "--save_folder", str(tmp_path), *NET,
                    "--dp", "2"])


@pytest.mark.parametrize("extra,tol", [([], 1e-3), (["--multihost", "1"], 1e-3),
                                       (["--multihost", "1", "--sdr_backend", "host"], 1e-3),
                                       (["--tp", "2", "--dp", "1"], 1e-3),
                                       (["--cp", "2", "--dp", "1"], 0.05)],
                         ids=["dp", "multihost", "multihost-host-sdr", "tp", "cp"])
def test_evaluate_cli_world2_matches_one_process(trained, data, tmp_path, extra, tol):
    ckpt = str(trained[0] / "one" / "final.ckpt")
    base = ["--model_path", ckpt, "--data_dir", os.path.join(data, "tt"), "--batch_size", "3",
            "--cal_sdr", "1", "--device", "cpu", "--sdr_backend", "device"]
    one = evaluate_main(base)
    for r in _spawn(tmp_path, "evaluate", base + extra):
        assert r["count"] == one["count"] == 4
        assert abs(r["si_snri"] - one["si_snri"]) <= tol
        assert abs(r["sdri"] - one["sdri"]) <= tol


@pytest.mark.parametrize("extra,tol", [([], 1e-4), (["--cp", "2", "--dp", "1"], 1e-2)],
                         ids=["dp", "cp"])
def test_separate_cli_world2_matches_one_process(trained, data, tmp_path, extra, tol):
    ckpt = str(trained[0] / "one" / "final.ckpt")
    mix_json = os.path.join(data, "tt", "mix.json")
    base = ["--model_path", ckpt, "--mix_json", mix_json, "--batch_size", "1",
            "--device", "cpu"]
    one = separate_main(base + ["--out_dir", str(tmp_path / "one")])
    written = _spawn(tmp_path, "separate", base + ["--out_dir", str(tmp_path / "two")] + extra)
    assert sum(written) == one == 4
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "two")) == names and len(names) == 12
    L, S = 8, 4
    for n in names:
        a, _ = read_wav(str(tmp_path / "two" / n))
        b, _ = read_wav(str(tmp_path / "one" / n))
        assert a.shape == b.shape
        # CP's padded frame overlaps the single-card forward's last frame
        # and fills the samples past it (as in JAX's cp_forward): compare
        # up to the last frame's start.
        last = (a.shape[0] - L) // S * S
        np.testing.assert_allclose(a[:last], b[:last], atol=tol)


@pytest.mark.parametrize("env,flags,want", [
    ({"MASTER_ADDR": "h0", "MASTER_PORT": "29500", "WORLD_SIZE": "4", "RANK": "3",
      "LOCAL_RANK": "1"}, {}, ("env://", 4, 3)),
    ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "8", "PROCESS_ID": "5"}, {},
     ("tcp://h0:1234", 8, 5)),
    ({}, {"coordinator_address": "h1:99", "num_processes": 2, "process_id": 1},
     ("tcp://h1:99", 2, 1)),
    ({}, {"coordinator_address": "file:///tmp/s", "num_processes": 2, "process_id": 0},
     ("file:///tmp/s", 2, 0)),
], ids=["torchrun", "jax-env", "jax-flags", "file-store"])
def test_initialize_maps_rendezvous_names(monkeypatch, env, flags, want):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    dev = distributed.initialize(device_type="cpu", **flags)
    assert dev == torch.device("cpu") and seen["backend"] == "gloo"
    assert (seen["init_method"], seen["world_size"], seen["rank"]) == want


def test_initialize_without_rendezvous_raises(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize(device_type="cpu")
