"""The port's evaluate CLI against the JAX package's (CPU).

One JAX save_checkpoint of a seeded tiny f32 model (two blocks, narrow
widths) is scored by both CLIs on a make_wav_dataset set. The port runs
--device cpu with --use_kernels auto (the kernels' plain versions) and 0.
Tolerances: the two forwards agree at rtol 5e-4 / atol 5e-5
(tests/test_torch_model.py), which moves SI-SNRi and SDRi by far less than
TOL_DB; the port's device SDRi (f64) against its host SDRi on the same
estimates, TOL_DEVICE_DB (the f64 broadband gate of
tests/test_torch_metrics.py; these synthetic sources are harmonic, which
the f64 ridge keeps to ~1e-9 dB)."""

import os

import jax
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.cli import evaluate as t_eval
from convtasnet_torch.data.synthetic import make_wav_dataset
from convtasnet_tpu.cli import evaluate as j_eval
from convtasnet_tpu.training import checkpoint as j_ckpt

torch.set_num_threads(1)
TINY = dict(N=32, L=16, B=16, H=32, P=3, X=2, R=1, compute_dtype="float32")
TOL_DB = 5e-3
TOL_DEVICE_DB = 1e-3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    json_root = make_wav_dataset(str(d), n_utts=3, min_sec=0.5, max_sec=1.0, seed=3,
                                 splits=("tt",))
    cfg = convtasnet_tpu.ConvTasNetConfig(**TINY)
    params, state = convtasnet_tpu.init_params(jax.random.key(5), cfg)
    ckpt = str(d / "tiny.ckpt")
    j_ckpt.save_checkpoint(ckpt, cfg, params, state)
    args = ["--model_path", ckpt, "--data_dir", os.path.join(json_root, "tt"),
            "--batch_size", "2", "--cal_sdr", "1"]
    want = j_eval.evaluate(j_eval.build_parser().parse_args(
        args + ["--sdr_backend", "host", "--use_pallas", "0"]), log=lambda s: None)
    return args, want


def _port(args, *extra, utterances=None):
    ns = t_eval.build_parser().parse_args(args + list(extra))
    return t_eval.evaluate(ns, log=lambda s: None, utterances=utterances)


@pytest.mark.parametrize("form", ["auto", "0"])
def test_evaluate_matches_jax(setup, form):
    args, want = setup
    host = _port(args, "--device", "cpu", "--use_kernels", form, "--sdr_backend", "host")
    utts = []
    dev = _port(args, "--device", "cpu", "--use_kernels", form, "--sdr_backend", "device",
                utterances=utts)
    assert want["count"] == host["count"] == dev["count"] == len(utts) == 3
    for got in (host, dev):
        assert abs(got["si_snri"] - want["si_snri"]) <= TOL_DB
        assert abs(got["sdri"] - want["sdri"]) <= TOL_DB
    assert abs(dev["sdri"] - host["sdri"]) <= TOL_DEVICE_DB
    for u in utts:
        assert u["estimate"].shape == u["source"].shape
        assert u["mixture"].shape == u["source"].shape[1:]
        assert np.isfinite(u["sdri"]) and np.isfinite(u["si_snri"])


def test_sdr_backend_auto_is_host_on_cpu(setup):
    args, _ = setup
    assert _port(args, "--device", "cpu") == _port(args, "--device", "cpu",
                                                   "--sdr_backend", "host")


def test_evaluate_later_flags_and_device(setup):
    args, _ = setup
    # Parallel flags need one process per card: in one process they raise.
    for flag in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            _port(args, "--device", "cpu", *flag)
    with pytest.raises(RuntimeError, match="no process group to join"):
        _port(args, "--device", "cpu", "--multihost", "1")
    assert t_eval.build_parser().parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _port(args)
