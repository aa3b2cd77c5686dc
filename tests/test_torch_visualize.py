"""The port's utils/visualize.py and the Solver's --visualize hooks: the
eight cases of tests/test_visualize.py on the port, plus the same PNG
bytes as the JAX package's renderer for the same history."""

import json
import os

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")

import convtasnet_torch.utils.visualize as viz  # noqa: E402
from convtasnet_torch.config import ConvTasNetConfig, TrainConfig  # noqa: E402
from convtasnet_torch.data.dataset import Batch, DataLoader  # noqa: E402
from convtasnet_torch.data.synthetic import synthetic_batch  # noqa: E402
from convtasnet_torch.models.conv_tasnet import ConvTasNet  # noqa: E402
from convtasnet_torch.training.checkpoint import save_checkpoint  # noqa: E402
from convtasnet_torch.training.solver import Solver  # noqa: E402
from convtasnet_torch.utils.visualize import (main as viz_main, plot_from_checkpoint,  # noqa: E402
                                              plot_history, plot_history_jsonl,
                                              plot_loss_curves)
from convtasnet_tpu.utils import visualize as j_viz  # noqa: E402

torch.set_num_threads(1)


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


class _Batches:
    """A fixed list of batches behind the port's DataLoader."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def load_batch(self, i):
        return self.batches[i]


def _solver(tmp_path, **kw):
    cfg = ConvTasNetConfig(N=8, L=8, B=8, H=16, P=3, X=1, R=1, C=2,
                           compute_dtype="float32", use_kernels="0")
    tcfg = TrainConfig(epochs=2, batch_size=2, save_folder=str(tmp_path),
                       checkpoint=False, visualize=True, print_freq=100, **kw)
    rng = np.random.default_rng(0)
    tr = [Batch(*synthetic_batch(rng, 2, 2, 2000)) for _ in range(2)]
    cv = [Batch(*synthetic_batch(rng, 2, 2, 2000))]
    model = ConvTasNet(cfg, device="cpu")
    return Solver(model, tcfg, DataLoader(_Batches(tr), num_workers=1),
                  DataLoader(_Batches(cv), num_workers=1), log=lambda s: None)


def test_plot_loss_curves(tmp_path):
    out = str(tmp_path / "loss.png")
    got = plot_loss_curves([5.0, 2.0, 1.0, 0.5], [6.0, 3.0, 2.5, 2.6], out,
                           lr=[1e-3, 1e-3, 5e-4, 5e-4])
    assert got == out and _is_png(out)


def test_plot_history_and_jsonl_cli(tmp_path):
    hist = [{"epoch": i + 1, "tr_loss": 10.0 / (i + 1), "cv_loss": 12.0 / (i + 1),
             "lr": 1e-3, "audio_sps": 100.0} for i in range(5)]
    out = str(tmp_path / "h.png")
    assert plot_history(hist, out) == out and _is_png(out)
    jsonl = tmp_path / "history.jsonl"
    with open(jsonl, "w") as f:
        for h in hist:
            f.write(json.dumps(h) + "\n")
        f.write("not json\n")  # log noise is skipped
    out2 = str(tmp_path / "j.png")
    assert plot_history_jsonl(str(jsonl), out2) == out2 and _is_png(out2)
    assert viz_main([str(tmp_path)]) == 0  # an experiment dir -> <dir>/loss.png
    assert _is_png(tmp_path / "loss.png")


def test_empty_history_is_noop(tmp_path):
    assert plot_history([], str(tmp_path / "x.png")) is None
    assert not os.path.exists(tmp_path / "x.png")


def test_solver_renders_loss_png(tmp_path):
    """The Solver with visualize writes loss.png per epoch and
    loss_iter.png with every train iteration (2 batches x 2 epochs)."""
    solver = _solver(tmp_path)
    solver.train()
    assert _is_png(tmp_path / "loss.png")
    assert _is_png(tmp_path / "loss_iter.png")
    assert [p["iter"] for p in solver.iter_history] == [1, 2, 3, 4]
    assert [p["epoch"] for p in solver.iter_history] == [0, 0, 1, 1]
    assert all(np.isfinite(p["loss"]) for p in solver.iter_history)


def test_plot_iter_curve(tmp_path):
    pts = [{"iter": i + 1, "epoch": i // 5, "loss": 10.0 - 0.1 * i} for i in range(15)]
    out = str(tmp_path / "it.png")
    assert viz.plot_iter_curve(pts, out) == out and _is_png(out)
    assert viz.plot_iter_curve([], str(tmp_path / "no.png")) is None


def test_partial_cv_history(tmp_path):
    """Rows without cv_loss or lr keep CV aligned to the epoch axis."""
    hist = [{"epoch": 1, "tr_loss": 5.0, "cv_loss": 6.0, "lr": 1e-3},
            {"epoch": 2, "tr_loss": 4.0, "lr": 1e-3},
            {"epoch": 3, "tr_loss": 3.0, "cv_loss": 3.5}]
    out = str(tmp_path / "p.png")
    assert plot_history(hist, out) == out and _is_png(out)


def test_cli_missing_history(tmp_path):
    assert viz_main([str(tmp_path)]) == 1


def test_iter_plot_wall_clock_throttle(tmp_path, monkeypatch):
    """Every iteration's loss is kept (a device scalar drained at the
    read-back points), but loss_iter.png is redrawn at most every
    iter_plot_interval seconds, plus once unthrottled at the end."""
    solver = _solver(tmp_path)
    solver.iter_plot_interval = 1e9  # only the first render may fire
    renders = []
    monkeypatch.setattr(viz, "plot_iter_curve", lambda pts, path: renders.append(len(pts)))
    solver.train()
    assert [p["iter"] for p in solver.iter_history] == [1, 2, 3, 4]
    assert not solver._pending_iter
    assert renders == [1, 4]


def test_plot_failure_is_logged_and_training_goes_on(tmp_path, monkeypatch):
    """A renderer that raises is logged as "visualize failed" and the run
    ends with its epochs and checkpoint."""
    logs = []
    solver = _solver(tmp_path)
    solver.log = logs.append

    def boom(*a, **k):
        raise RuntimeError("no display")

    monkeypatch.setattr(viz, "plot_history", boom)
    monkeypatch.setattr(viz, "plot_iter_curve", boom)
    out = solver.train()
    assert len(out["tr_loss"]) == 2 and os.path.exists(tmp_path / "final.ckpt")
    assert sum("visualize failed: no display" in m for m in logs) >= 3


def test_missing_matplotlib_is_logged(tmp_path, monkeypatch):
    """Without matplotlib the renderers return None: the Solver logs that
    no plot was written and trains on."""
    logs = []
    solver = _solver(tmp_path)
    solver.log = logs.append
    monkeypatch.setattr(viz, "_mpl", lambda: None)
    out = solver.train()
    assert len(out["tr_loss"]) == 2 and not os.path.exists(tmp_path / "loss.png")
    assert any("visualize failed: loss.png not written" in m for m in logs)
    assert any("visualize failed: loss_iter.png not written" in m for m in logs)


def test_plot_from_checkpoint_and_same_png_as_jax(tmp_path):
    """A port checkpoint's loss lists plot, and the port's renderer writes
    the same bytes as the JAX package's for the same history."""
    cfg = ConvTasNetConfig(N=8, L=8, B=8, H=16, X=1, R=1, compute_dtype="float32")
    model = ConvTasNet(cfg, device="cpu")
    ck = str(tmp_path / "m.ckpt")
    save_checkpoint(ck, cfg, model.params(), model.state(), epoch=3,
                    tr_loss=[3.0, 2.0, 1.5], cv_loss=[3.5, 2.5, 2.4])
    assert plot_from_checkpoint(ck, str(tmp_path / "ck.png")) == str(tmp_path / "ck.png")
    assert _is_png(tmp_path / "ck.png")
    hist = [{"epoch": i + 1, "tr_loss": 5.0 - i, "cv_loss": 5.5 - i, "lr": 1e-3}
            for i in range(3)]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    plot_history(hist, a)
    j_viz.plot_history(hist, b)
    assert open(a, "rb").read() == open(b, "rb").read()
