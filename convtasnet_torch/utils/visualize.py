"""Training-curve visualization (the reference's visdom analogue); a copy
of convtasnet_tpu/utils/visualize.py for the PyTorch port.

The reference offers optional live visdom loss curves (solver.py:39-46,
:139-156, :197-208, README.md:51-57) and ships a rendered loss.png in its
recipe dir (egs/wsj0/loss.png). Here the solver re-renders
<save_folder>/loss.png after every epoch when TrainConfig.visualize is on
— a live-updating file instead of a server — and this module doubles as a
CLI for plotting any experiment dir, history.jsonl, or checkpoint:

    python -m convtasnet_torch.utils.visualize <exp_dir|history.jsonl|ckpt> \
        [-o out.png]

Loss is the uPIT objective (−SI-SNR, dB): lower is better.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

# Validated light-mode palette (2 series + chrome); identity also carried by
# direct labels + linestyle so the chart never relies on hue alone.
_BLUE = "#2a78d6"     # train
_ORANGE = "#eb6834"   # cross-validation
_INK = "#0b0b0b"
_MUTED = "#898781"
_GRID = "#e1e0d9"
_BASELINE = "#c3c2b7"
_SURFACE = "#fcfcfb"


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:  # matplotlib genuinely optional
        return None


def _style_axis(ax):
    ax.set_facecolor(_SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_BASELINE)
    ax.tick_params(colors=_MUTED, labelsize=9)
    ax.grid(True, axis="y", color=_GRID, linewidth=0.8)
    ax.set_axisbelow(True)


def plot_loss_curves(
    tr_loss: Sequence[float],
    cv_loss: Sequence[float],
    out_path: str,
    lr: Optional[Sequence[float]] = None,
    title: str = "Conv-TasNet training",
) -> Optional[str]:
    """Renders per-epoch train/CV loss (and optionally the LR schedule as
    its own small chart below — never a second y-axis). Returns out_path,
    or None when matplotlib is unavailable."""
    plt = _mpl()
    if plt is None or not len(tr_loss):
        return None
    import numpy as _np

    epochs = list(range(1, len(tr_loss) + 1))
    # Align CV to the epoch axis; missing entries (CV run every k epochs,
    # partial histories) become NaN, which matplotlib renders as gaps.
    cv = list(cv_loss[: len(tr_loss)])
    cv += [float("nan")] * (len(tr_loss) - len(cv))
    has_cv = any(_np.isfinite(v) for v in cv)

    n_rows = 2 if lr is not None and len(lr) else 1
    fig, axes = plt.subplots(
        n_rows, 1, figsize=(7.2, 4.4 if n_rows == 1 else 5.6),
        sharex=True, height_ratios=None if n_rows == 1 else [3, 1],
    )
    fig.patch.set_facecolor(_SURFACE)
    ax = axes if n_rows == 1 else axes[0]

    _style_axis(ax)
    ax.plot(epochs, tr_loss, color=_BLUE, linewidth=2, label="train")
    if has_cv:
        ax.plot(epochs, cv, color=_ORANGE, linewidth=2, linestyle=(0, (5, 2)),
                label="cross-validation")
    # Selective direct labels: name each series at its last finite point.
    ax.annotate(f" train {tr_loss[-1]:.2f}", (epochs[-1], tr_loss[-1]),
                color=_INK, fontsize=9, va="center")
    if has_cv:
        finite = [i for i, v in enumerate(cv) if _np.isfinite(v)]
        last, best = finite[-1], min(finite, key=lambda i: cv[i])
        ax.annotate(f" cv {cv[last]:.2f}", (last + 1, cv[last]),
                    color=_INK, fontsize=9, va="center")
        ax.scatter([best + 1], [cv[best]], s=36, color=_ORANGE, zorder=3,
                   edgecolor=_SURFACE, linewidth=2)
    ax.set_ylabel("loss = −SI-SNR (dB)", color=_INK, fontsize=10)
    ax.set_title(title, color=_INK, fontsize=11, loc="left")
    ax.legend(loc="upper right", frameon=False, fontsize=9,
              labelcolor=_INK)
    ax.margins(x=0.10)

    if n_rows == 2:
        ax2 = axes[1]
        _style_axis(ax2)
        ax2.plot(epochs[: len(lr)], list(lr)[: len(epochs)], color=_BLUE,
                 linewidth=2, drawstyle="steps-post")
        ax2.set_ylabel("lr", color=_INK, fontsize=10)
        ax2.set_yscale("log")
        ax2.set_xlabel("epoch", color=_INK, fontsize=10)
    else:
        ax.set_xlabel("epoch", color=_INK, fontsize=10)

    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, facecolor=_SURFACE)
    plt.close(fig)
    return out_path


def plot_iter_curve(points: List[Dict[str, Any]], out_path: str,
                    title: str = "training loss (per iteration)"
                    ) -> Optional[str]:
    """Per-iteration live loss window — the analogue of the reference's
    every-iteration visdom plot (solver.py:197-208). `points` rows are
    {iter, loss[, epoch]}; the solver appends at print_freq sync points (a
    per-step device sync would serialize the async dispatch pipeline)."""
    plt = _mpl()
    if plt is None or not points:
        return None
    xs = [int(p["iter"]) for p in points]
    ys = [float(p["loss"]) for p in points]
    fig, ax = plt.subplots(figsize=(7.2, 3.6))
    fig.patch.set_facecolor(_SURFACE)
    _style_axis(ax)
    ax.plot(xs, ys, color=_BLUE, linewidth=1.6)
    # Epoch boundaries as faint verticals, if recorded.
    seen = set()
    for p in points:
        e = p.get("epoch")
        if e is not None and e not in seen and len(seen) < 40:
            seen.add(e)
            if e > 0:
                ax.axvline(int(p["iter"]), color=_GRID, linewidth=0.8)
    ax.annotate(f" {ys[-1]:.2f}", (xs[-1], ys[-1]), color=_INK,
                fontsize=9, va="center")
    ax.set_xlabel("iteration", color=_INK, fontsize=10)
    ax.set_ylabel("loss = −SI-SNR (dB)", color=_INK, fontsize=10)
    ax.set_title(title, color=_INK, fontsize=11, loc="left")
    ax.margins(x=0.06)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, facecolor=_SURFACE)
    plt.close(fig)
    return out_path


def plot_history(history: List[Dict[str, Any]], out_path: str,
                 title: str = "Conv-TasNet training") -> Optional[str]:
    """Plots Solver.history entries ({epoch, tr_loss, cv_loss, lr, ...})."""
    rows = [h for h in history if "tr_loss" in h]
    if not rows:
        return None
    tr = [float(h["tr_loss"]) for h in rows]
    # Keep per-epoch alignment: rows without cv_loss/lr contribute NaN.
    cv = [float(h["cv_loss"]) if "cv_loss" in h else float("nan")
          for h in rows]
    lr = [float(h["lr"]) if "lr" in h else float("nan") for h in rows]
    import math
    if all(math.isnan(v) for v in lr):
        lr = None
    return plot_loss_curves(tr, cv, out_path, lr=lr, title=title)


def plot_history_jsonl(jsonl_path: str, out_path: str) -> Optional[str]:
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return plot_history(rows, out_path,
                        title=os.path.basename(os.path.dirname(
                            os.path.abspath(jsonl_path))) or "training")


def plot_from_checkpoint(ckpt_path: str, out_path: str) -> Optional[str]:
    """Plots the loss history a checkpoint carries (tr_loss/cv_loss lists,
    mirroring the reference package, conv_tasnet.py:86-91)."""
    from ..training.checkpoint import load_header

    h = load_header(ckpt_path)
    return plot_loss_curves(
        [float(x) for x in h.get("tr_loss", [])],
        [float(x) for x in h.get("cv_loss", [])],
        out_path,
        title=os.path.basename(ckpt_path),
    )


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        "plot training curves (loss.png) from an experiment")
    p.add_argument("source", help="exp dir, history.jsonl, or .ckpt file")
    p.add_argument("-o", "--out", default=None, help="output PNG path")
    args = p.parse_args(argv)

    src = args.source
    if os.path.isdir(src):
        jsonl = os.path.join(src, "history.jsonl")
        out = args.out or os.path.join(src, "loss.png")
        if not os.path.exists(jsonl):
            print(f"nothing plotted ({jsonl} does not exist yet)")
            return 1
        got = plot_history_jsonl(jsonl, out)
    elif src.endswith(".jsonl"):
        out = args.out or os.path.join(os.path.dirname(src) or ".", "loss.png")
        got = plot_history_jsonl(src, out)
    else:
        out = args.out or (os.path.splitext(src)[0] + ".png")
        got = plot_from_checkpoint(src, out)
    if got is None:
        print("nothing plotted (no epochs yet, or matplotlib missing)")
        return 1
    print(f"wrote {got}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
