"""Conv-TasNet in plain float32 PyTorch: the yardstick that decides `correct`.

Written from the paper (Luo & Mesgarani, arXiv:1809.07454) and the recipe it
was trained with, channels first ([M, channels, frames]) with F.conv1d, and
independent of the port: it imports nothing of convtasnet_torch and takes
only the weights and inputs the benchmark made. The weights arrive in the
port's parameter layout (a nested dict of float32 tensors; block weights
stacked [R, X, ...], pointwise weights as [in, out] matrices), which is a
layout of numbers, not of code.

`q` is where activations are rounded: the configuration states bf16
activations with f32 parameters, so the reference rounds, in the forward
only (the gradient passes straight through), at the points where such a
model stores an activation: the mixture and each weight as an operand, the
encoder output, each norm output, each pointwise output, each block output,
the mask and the masked basis. Everything else runs in float32 with TF32
off. `rounding(torch.bfloat16)` is the reference; `rounding(FP8)` is the
control one precision below it.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-8
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0  # largest finite float8_e4m3fn; the cast saturates there


def rounding(dtype: Optional[torch.dtype], backward: bool = False
             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> x rounded to `dtype` and back to float32 in the forward, the
    identity in the backward, or with `backward` the gradient rounded there
    too (None: no rounding)."""
    if dtype is None:
        return lambda x: x

    class _Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            if dtype == FP8:
                x = x.clamp(-FP8_MAX, FP8_MAX)
            return x.to(dtype).to(torch.float32)

        @staticmethod
        def backward(ctx, g):
            return g.to(dtype).to(torch.float32) if backward else g

    return _Round.apply


class Model:
    """The hyperparameters the reference needs (conv_tasnet.py naming)."""

    def __init__(self, N, L, B, H, P, X, R, C, norm_type, causal, mask_nonlinear, **_):
        self.N, self.L, self.B, self.H, self.P, self.X, self.R, self.C = N, L, B, H, P, X, R, C
        self.norm_type, self.causal, self.mask_nonlinear = norm_type, causal, mask_nonlinear
        self.S = L // 2


def _norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, kind: str) -> torch.Tensor:
    """gLN (over channels and frames) or cLN (over channels, per frame) of
    x [M, ch, K]: gamma * (x - mean) / sqrt(var + EPS) + beta."""
    dims = (1, 2) if kind == "gLN" else (1,)
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return gamma[None, :, None] * (x - mean) / torch.sqrt(var + EPS) + beta[None, :, None]


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def _conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, cin, K], w [cin, cout] -> [M, cout, K]."""
    return F.conv1d(x, w.t()[:, :, None])


def forward(p: Dict, m: Model, mixture: torch.Tensor, q) -> torch.Tensor:
    """Separated sources [M, C, T] of mixtures [M, T]."""
    M, T = mixture.shape
    sp = p["separator"]
    # encoder: N filters of length L, stride L/2, ReLU
    w = F.relu(F.conv1d(q(mixture)[:, None, :], q(p["encoder"]["U"]).t()[:, None, :],
                        stride=m.S))
    w = q(w)                                                  # [M, N, K]
    x = q(_norm(w, sp["ln"]["gamma"], sp["ln"]["beta"], "cLN"))
    x = q(_conv1x1(x, q(sp["bottleneck"]["w"])))              # [M, B, K]
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
    K = x.shape[2]
    score = _conv1x1(x, q(sp["mask"]["w"])).reshape(M, m.C, m.N, K)
    mask = q(torch.softmax(score, dim=1) if m.mask_nonlinear == "softmax" else F.relu(score))
    src_w = q(w[:, None] * mask)                              # [M, C, N, K]
    frames = torch.einsum("mcnk,nl->mclk", src_w, q(p["decoder"]["V"]))
    T_out = (K - 1) * m.S + m.L
    out = F.fold(frames.reshape(M * m.C, m.L, K), output_size=(1, T_out),
                 kernel_size=(1, m.L), stride=(1, m.S))
    return F.pad(out.reshape(M, m.C, T_out), (0, T - T_out))


def _si_snr(est: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """SI-SNR in dB of zero-mean est against zero-mean src, [M, T] -> [M]."""
    dot = (est * src).sum(-1, keepdim=True)
    proj = dot * src / ((src ** 2).sum(-1, keepdim=True) + EPS)
    noise = est - proj
    return 10 * torch.log10((proj ** 2).sum(-1) / ((noise ** 2).sum(-1) + EPS) + EPS)


def pit_loss(source: torch.Tensor, estimate: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uPIT SI-SNR loss (pit_criterion.py): minus the mean over utterances of
    the best permutation's mean SI-SNR, each signal zero-meaned over its
    true length."""
    M, C, T = source.shape
    mask = (torch.arange(T, device=source.device)[None, :] < lengths[:, None]).float()[:, None]
    n = lengths.clamp(min=1).float()[:, None, None]
    src, est = source * mask, estimate * mask
    src = (src - src.sum(-1, keepdim=True) / n) * mask
    est = (est - est.sum(-1, keepdim=True) / n) * mask
    best = None
    for perm in itertools.permutations(range(C)):
        snr = sum(_si_snr(est[:, i], src[:, perm[i]]) for i in range(C)) / C
        best = snr if best is None else torch.maximum(best, snr)
    return -best.mean()


def leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a nested dict, paths joined by '/', sorted."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out.extend(leaves(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def _tree(pairs: List[Tuple[str, torch.Tensor]]) -> Dict:
    root: Dict = {}
    for path, t in pairs:
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return root


def row_grads(params: Dict, m: Model, batch, q, keep_rows: bool = True):
    """The recipe's loss and gradient on one (mixture, source, lengths)
    batch at `params` {path: tensor}, each row's taken on its own (no layer
    mixes rows; the batch's are their mean). Returns (each row's loss, the
    batch gradient as a list in path order, and with keep_rows the rows'
    gradients as one [M, P] tensor, leaves flattened in path order)."""
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


def clip(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """Clipping of the global norm to max_norm: scale max_norm / (norm +
    1e-6) when above."""
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def train(params: Dict, m: Model, batches, q, steps: int, lr: float, max_norm: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """`steps` steps of the recipe on (mixture, source, lengths) batches:
    uPIT loss, gradients (row_grads), clipping of the global norm, Adam
    with bias correction, eps outside the root. Returns (losses, each
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


def row_shares(grad: Dict[str, torch.Tensor], rows: torch.Tensor,
               chunk: int = 1 << 20) -> torch.Tensor:
    """How much of each row a batch gradient holds: the least-squares
    weights of `grad` {path: tensor} (flattened as `train` flattens the
    rows) over the rows' own gradients rows [M, P], scaled so that an even mean of all rows
    reads 1 for each (clipping's scale drops out). A row left out reads
    about 0."""
    g = torch.cat([t.flatten() for _, t in leaves(_tree(list(grad.items())))]).to(rows.device)
    M = rows.shape[0]
    G = torch.zeros((M, M), dtype=torch.float64, device=rows.device)
    b = torch.zeros(M, dtype=torch.float64, device=rows.device)
    for s in range(0, rows.shape[1], chunk):
        R = rows[:, s:s + chunk].double()
        G += R @ R.T
        b += R @ g[s:s + chunk].double()
    w = torch.linalg.lstsq(G, b[:, None]).solution[:, 0]
    return (w * M / w.sum()).cpu()


def norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              skip=()) -> Dict[str, float]:
    """Per leaf, the gap between the program's and the reference's L2 norms,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    norms = {n: float(t.double().norm()) for n, t in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n: abs(float(prog[n].double().norm()) - r) / max(r, med)
            for n, r in norms.items() if n not in skip}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """(the largest gap, its leaf); inf where one is not finite."""
    leaf = max(gaps, key=lambda n: gaps[n] if math.isfinite(gaps[n]) else math.inf)
    return (gaps[leaf] if math.isfinite(gaps[leaf]) else math.inf), leaf


def median(gaps: Dict[str, float]) -> float:
    v = sorted(g if math.isfinite(g) else math.inf for g in gaps.values())
    return v[len(v) // 2]


def wave_error(prog, ref) -> float:
    """Worst relative L2 error over the sources of [..., T] waveforms
    (tensors or arrays)."""
    p = torch.as_tensor(prog).double().reshape(-1, prog.shape[-1])
    r = torch.as_tensor(ref).double().reshape(-1, ref.shape[-1])
    e = float(((p - r).norm(dim=-1) / r.norm(dim=-1).clamp(min=1e-12)).max())
    return e if math.isfinite(e) else math.inf
