"""The port's WSJ0 recipe (convtasnet_torch/recipes/wsj0/run.py), stages 0-4
on the CPU: a tiny LDC-shaped tree of shorten-compressed SPHERE files goes
through sphere->wav, seeded mixtures, manifests, training, evaluation and
separation, as tests/test_recipe_e2e.py drives the JAX recipe."""

import glob
import json
import os
import sys

import numpy as np
import torch

from convtasnet_torch.data.sphio import read_sphere_int16
from convtasnet_torch.data.wavio import read_wav
from convtasnet_torch.recipes.wsj0 import run

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from shorten_encoder import write_sphere_shorten  # noqa: E402

torch.set_num_threads(1)


def _make_wsj0_tree(root: str, sr: int = 8000) -> None:
    """<root>/<split>/<speaker>/<utt>.wv1: 3 speakers x 2 utterances per
    split, so that distinct-speaker pairs exist."""
    rng = np.random.default_rng(11)
    for split in ("si_tr_s", "si_dt_05", "si_et_05"):
        for spk in ("011", "012", "013"):
            for u in range(2):
                t = np.arange(int(1.4 * sr))
                f = float(rng.uniform(80, 900))
                x = (4000 * np.sin(2 * np.pi * f * t / sr)
                     + 600 * rng.standard_normal(t.size)).astype(np.int16)
                path = os.path.join(root, split, spk, f"{spk}o030{u}.wv1")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_sphere_shorten(path, x, sr)


def test_wsj0_recipe_stage0_to_4(tmp_path, monkeypatch):
    sphere_root = str(tmp_path / "wsj0_sphere")
    _make_wsj0_tree(sphere_root)
    monkeypatch.chdir(tmp_path)  # the recipe's data/ and exp/ paths are relative
    cfg = {
        "sphere_root": sphere_root, "n_mix_tr": 8, "n_mix_cv": 4, "n_mix_tt": 4,
        "N": 16, "L": 8, "B": 12, "H": 24, "X": 2, "R": 2,
        "epochs": 2, "batch_size": 4, "segment": 1.0, "cv_maxlen": 4.0,
        "num_workers": 2, "compute_dtype": "float32", "remat": "dots",
        "use_kernels": "0", "visualize": 0, "cal_sdr": 1, "print_freq": 50,
        "save_every_steps": 0, "device": "cpu",
    }
    with open(tmp_path / "drill.json", "w") as f:
        json.dump(cfg, f)

    run.main(["--stage", "0", "--stop_stage", "4", "--config", str(tmp_path / "drill.json")])

    wavs = glob.glob("data/wsj0_wav/tr/**/*.wav", recursive=True)
    assert len(wavs) == 6
    for split, n in (("tr", 8), ("cv", 4), ("tt", 4)):
        for sub in ("mix", "s1", "s2"):
            got = glob.glob(f"data/wsj0-mix/2speakers/wav8k/min/{split}/{sub}/*.wav")
            assert len(got) == n, (split, sub)
    assert os.path.exists("data/json/tr/mix.json")
    ckpts = glob.glob("exp/train_*/final.ckpt")
    assert len(ckpts) == 1
    # The experiment dir encodes the hyperparameters as the JAX recipe's does.
    assert os.path.basename(os.path.dirname(ckpts[0])).startswith(
        "train_r8000_N16_L8_B12_H24_P3_X2_R2_C2_gLN_causal0_relu_epoch2_adam")
    with open(os.path.join(os.path.dirname(ckpts[0]), "history.jsonl")) as f:
        assert len([json.loads(line) for line in f if line.strip()]) == 2
    sep = glob.glob("exp/train_*/separate/*_s1.wav")
    assert len(sep) == 4
    y, sr = read_wav(sep[0])
    assert sr == 8000 and y.size > sr and np.isfinite(y).all()
    # The ingestion leg is exact: a stage-0 wav is the PCM the encoder wrote.
    src = sorted(glob.glob(os.path.join(sphere_root, "si_tr_s", "**", "*.wv1"),
                           recursive=True))[0]
    pcm, _ = read_sphere_int16(src)
    got, _ = read_wav(sorted(wavs)[0])
    np.testing.assert_array_equal(np.round(got * 32768.0).astype(np.int16), pcm)


def test_config_overrides_and_exp_dir(tmp_path):
    """--config merges a JSON dict of flags; the exp dir names them."""
    with open(tmp_path / "c.json", "w") as f:
        json.dump({"H": 24, "device": "cpu", "use_kernels": "hybrid", "remat": "block"}, f)
    parser = run.build_parser()
    args = parser.parse_args(["--config", str(tmp_path / "c.json"), "--X", "3"])
    assert args.config
    parser.set_defaults(**json.load(open(tmp_path / "c.json")))
    args = parser.parse_args(["--X", "3"])
    assert (args.H, args.X, args.device, args.use_kernels, args.remat) == (
        24, 3, "cpu", "hybrid", "block")
    assert "_H24_P3_X3_" in run.exp_dir(args)
    assert run.detect_sphere_root("") == "" and run.detect_sphere_root("/x") == "/x"
