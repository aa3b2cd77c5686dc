"""The final Conv-TasNet in plain float32 PyTorch: the yardstick of the
`taslp` configuration's cells.

Luo & Mesgarani, "Conv-TasNet: Surpassing Ideal Time-Frequency Magnitude
Masking for Speech Separation", IEEE/ACM TASLP 27(8), 2019
(arXiv:1809.07454v3), with the layer equations of the authors' code
(github.com/naplab/Conv-TasNet, utility/models.py: TasNet, TCN,
DepthConv1d with skip=True), channels first ([M, channels, frames]) with
F.conv1d:

    w   = encoder(mixture)                 linear, or ReLU'd (encoder_relu)
    x   = input_norm(w) @ bottleneck       gLN or cLN (input_norm)
    s   = 0
    per block: e = norm2(PReLU2(dwconv(norm1(PReLU1(x @ in_w)))))
               x = x + e @ out_w           the residual path
               s = s + e @ skip_w          the skip path
    mask = mask_nonlinear(PReLU(s) @ mask_w)

Where it departs from the authors' code, as the configuration file's
`assumed` says:
  * no convolution biases: the bias-free convention of the first version's
    recipe, whose family this repo ports (the port's parameter layout has
    no bias leaves);
  * framing without `pad_signal`'s padding: frames of L samples every L/2
    from the first sample, the decoder's overlap-add zero-padded back to T
    samples, as the first version's recipe frames.

Like benchmark/reference/convtasnet.py, whose helpers it takes, it imports
nothing of convtasnet_torch or of JAX and takes only the weights and inputs
the benchmark made, in the port's parameter layout. `q` rounds activations
at the points where such a model stores one (convtasnet.py's points, and
here also the skip sum after each add and the mask head's PReLU output).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.convtasnet import (FP8, Model as _Model, _conv1x1, _norm, _prelu,
                                            _tree, clip, leaves, norm_gaps, pit_loss, rounding,
                                            row_shares, wave_error, worst)

__all__ = ("FP8", "Model", "forward", "row_grads", "train", "clip", "leaves", "norm_gaps",
           "pit_loss", "rounding", "row_shares", "wave_error", "worst")


class Model(_Model):
    """The hyperparameters, with the final version's: Sc skip channels,
    encoder_relu, input_norm."""

    def __init__(self, Sc, encoder_relu, input_norm, **kw):
        super().__init__(**kw)
        self.Sc, self.encoder_relu, self.input_norm = Sc, encoder_relu, input_norm


def _mask(score: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "softmax":
        return torch.softmax(score, dim=1)
    if kind == "sigmoid":
        return torch.sigmoid(score)
    return F.relu(score)


def forward(p: Dict, m: Model, mixture: torch.Tensor, q) -> torch.Tensor:
    """Separated sources [M, C, T] of mixtures [M, T]."""
    M, T = mixture.shape
    sp = p["separator"]
    w = F.conv1d(q(mixture)[:, None, :], q(p["encoder"]["U"]).t()[:, None, :], stride=m.S)
    w = q(F.relu(w) if m.encoder_relu else w)                 # [M, N, K]
    x = q(_norm(w, sp["ln"]["gamma"], sp["ln"]["beta"], m.input_norm))
    x = q(_conv1x1(x, q(sp["bottleneck"]["w"])))              # [M, B, K]
    K = x.shape[2]
    s = torch.zeros((M, m.Sc, K), dtype=x.dtype, device=x.device)
    bl = sp["blocks"]
    for r in range(m.R):
        for i in range(m.X):
            d = 2 ** i
            y = q(_conv1x1(x, q(bl["in_w"][r, i])))
            y = q(_prelu(y, q(bl["in_prelu"][r, i])))
            y = q(_norm(y, bl["in_gamma"][r, i], bl["in_beta"][r, i], m.norm_type))
            span = (m.P - 1) * d
            left = span if m.causal else span // 2
            y = F.pad(y, (left, span - left))
            y = q(F.conv1d(y, q(bl["dw_w"][r, i]).t()[:, None, :], dilation=d, groups=m.H))
            y = q(_prelu(y, q(bl["dw_prelu"][r, i])))
            y = q(_norm(y, bl["dw_gamma"][r, i], bl["dw_beta"][r, i], m.norm_type))
            x = q(x + q(_conv1x1(y, q(bl["out_w"][r, i]))))
            s = q(s + q(_conv1x1(y, q(bl["skip_w"][r, i]))))
    head = q(_prelu(s, q(sp["mask"]["prelu"])))
    score = _conv1x1(head, q(sp["mask"]["w"])).reshape(M, m.C, m.N, K)
    mask = q(_mask(score, m.mask_nonlinear))
    src_w = q(w[:, None] * mask)                              # [M, C, N, K]
    frames = torch.einsum("mcnk,nl->mclk", src_w, q(p["decoder"]["V"]))
    T_out = (K - 1) * m.S + m.L
    out = F.fold(frames.reshape(M * m.C, m.L, K), output_size=(1, T_out),
                 kernel_size=(1, m.L), stride=(1, m.S))
    return F.pad(out.reshape(M, m.C, T_out), (0, T - T_out))


def row_grads(params: Dict, m: Model, batch, q, keep_rows: bool = True):
    """The recipe's loss and gradient on one (mixture, source, lengths)
    batch at `params` {path: tensor}, each row's taken on its own (the
    batch's are their mean), as convtasnet.row_grads: (each row's loss, the
    batch gradient as a list in path order, with keep_rows the rows'
    gradients [M, P])."""
    names = [n for n, _ in leaves(_tree(list(params.items())))]
    cur = [params[n].detach().float().requires_grad_(True) for n in names]
    tree = _tree(list(zip(names, cur)))
    mix, src, lens = batch
    M = mix.shape[0]
    grads = [torch.zeros_like(x) for x in cur]
    losses, per_row = [], []
    for r in range(M):
        loss = pit_loss(src[r:r + 1], forward(tree, m, mix[r:r + 1], q), lens[r:r + 1])
        g = torch.autograd.grad(loss, cur)
        losses.append(float(loss.detach()))
        grads = [a + b / M for a, b in zip(grads, g)]
        if keep_rows:
            per_row.append(torch.cat([x.flatten() for x in g]))
    return losses, grads, (torch.stack(per_row) if keep_rows else None)


def train(params: Dict, m: Model, batches, q, steps: int, lr: float, max_norm: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """`steps` steps of the recipe, as convtasnet.train: uPIT loss, clipping
    of the global norm, Adam with bias correction. Returns (losses, each
    step's clipped gradients {path: tensor}, the parameters after each
    step {path: tensor})."""
    names = [n for n, _ in leaves(params)]
    p = [t.detach().clone().float() for _, t in leaves(params)]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    losses, clipped, after = [], [], []
    for t, batch in enumerate(batches[:steps], start=1):
        row_loss, grads, _ = row_grads(dict(zip(names, p)), m, batch, q, keep_rows=False)
        losses.append(sum(row_loss) / len(row_loss))
        grads = clip(grads, max_norm)
        clipped.append({n: g.detach() for n, g in zip(names, grads)})
        with torch.no_grad():
            mu = [b1 * a + (1 - b1) * g for a, g in zip(mu, grads)]
            nu = [b2 * v + (1 - b2) * g * g for v, g in zip(nu, grads)]
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            p = [x - lr * (a / c1) / (torch.sqrt(v / c2) + eps) for x, a, v in zip(p, mu, nu)]
        after.append(dict(zip(names, p)))
    return losses, clipped, after
