"""Reference PyTorch state_dict <-> the port's parameter / state trees.

The port's copy of convtasnet_tpu/compat/torch_convert.py. The reference
serializes models as a single pickle "package" of hyperparameters +
nn.Module state_dict (+ optimizer state, epoch, loss history; the
reference's conv_tasnet.py:78-94). This module maps that flat tensor dict
into the port's parameter / state trees (nested dicts of f32 tensors with
the JAX package's leaf names and shapes) and back, so reference-trained
checkpoints can be served by the port.

Layout differences handled (all pure reshapes/transposes, so the SAME
mapping is valid for parameter *gradients*):

  torch module (key)                         torch shape    ours        shape
  encoder.conv1d_U.weight                    [N, 1, L]      encoder.U   [L, N]
  decoder.basis_signals.weight (nn.Linear)   [L, N]         decoder.V   [N, L]
  separator.network.0.{gamma,beta}  (cLN)    [1, N, 1]      ln.*        [N]
  separator.network.1.weight (bottleneck)    [B, N, 1]      bottleneck.w[N, B]
  separator.network.3.weight (mask conv)     [C*N, B, 1]    mask.w      [B, C*N]
  separator.network.2.{r}.{x}.net.0.weight   [H, B, 1]      blocks.in_w [R,X,B,H]
  separator.network.2.{r}.{x}.net.1.weight   [1] (PReLU)    in_prelu    [R,X]
  separator.network.2.{r}.{x}.net.2.*        [1, H, 1]|[H]  in_gamma/.. [R,X,H]
  ...net.3.net.0.weight (depthwise)          [H, 1, P]      dw_w        [R,X,P,H]
  ...net.3.net.{1|2}.weight (PReLU)          [1]            dw_prelu    [R,X]
  ...net.3.net.{2|3}.* (norm)                [1, H, 1]|[H]  dw_gamma/.. [R,X,H]
  ...net.3.net.{3|4}.weight (pointwise)      [B, H, 1]      out_w       [R,X,H,B]

The dsconv sub-indices shift by one when causal=True because Chomp1d (no
params) occupies slot 1 (conv_tasnet.py:258-263). BN norms contribute
weight/bias as gamma/beta plus running_mean/running_var into the BN state
tree; num_batches_tracked is not used (the port's BN uses the reference's
constant momentum 0.1, matching BatchNorm1d defaults).

The state_dict may hold tensors or numpy arrays; the mapping itself is
numpy (exact transposes and reshapes of f32), and the trees come back as
CPU tensors. load_torch_package() reads a .pth.tar.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import params_from_jax

HPARAM_KEYS = ("N", "L", "B", "H", "P", "X", "R", "C",
               "norm_type", "causal", "mask_nonlinear")


def config_from_package(package: Dict[str, Any], **overrides) -> ConvTasNetConfig:
    """Rebuild a ConvTasNetConfig from a reference package's hyperparameters
    (conv_tasnet.py:70-75). The port's own knobs come from `overrides`."""
    kw = {k: package[k] for k in HPARAM_KEYS}
    kw["causal"] = bool(kw["causal"])
    kw.update(overrides)
    return ConvTasNetConfig(**kw)


def _dsconv_slots(causal: bool) -> Tuple[int, int, int]:
    """(prelu, norm, pointwise) indices inside DepthwiseSeparableConv.net —
    Chomp1d at slot 1 shifts everything when causal (conv_tasnet.py:258-263)."""
    return (2, 3, 4) if causal else (1, 2, 3)


def _norm_entries(sd: Dict[str, np.ndarray], prefix: str, norm_type: str,
                  ch: int) -> Dict[str, np.ndarray]:
    """Extract gamma/beta (+BN running stats) for one norm module."""
    if norm_type == "BN":
        out = {
            "gamma": np.asarray(sd[prefix + "weight"], np.float32).reshape(ch),
            "beta": np.asarray(sd[prefix + "bias"], np.float32).reshape(ch),
            "mean": np.asarray(sd[prefix + "running_mean"], np.float32).reshape(ch),
            "var": np.asarray(sd[prefix + "running_var"], np.float32).reshape(ch),
        }
    else:  # gLN / cLN store [1, ch, 1] gamma/beta (conv_tasnet.py:311-317)
        out = {
            "gamma": np.asarray(sd[prefix + "gamma"], np.float32).reshape(ch),
            "beta": np.asarray(sd[prefix + "beta"], np.float32).reshape(ch),
        }
    return out


def params_from_state_dict(
    sd: Dict[str, np.ndarray], cfg: ConvTasNetConfig
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference state_dict into the port's (params, state) trees
    of f32 CPU tensors. sd values may be tensors (on any device) or numpy
    arrays."""
    sd = {k: _np(v) for k, v in sd.items()}
    N, L, B, H, P, X, R, C = (cfg.N, cfg.L, cfg.B, cfg.H, cfg.P, cfg.X,
                              cfg.R, cfg.C)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731

    enc = sd["encoder.conv1d_U.weight"]  # [N, 1, L]
    assert enc.shape == (N, 1, L), f"encoder weight shape {enc.shape}"
    dec = sd["decoder.basis_signals.weight"]  # nn.Linear(N, L): [L, N]
    assert dec.shape == (L, N), f"decoder weight shape {dec.shape}"

    net = "separator.network."
    ln = _norm_entries(sd, net + "0.", "cLN", N)  # input norm is always cLN
    bott = sd[net + "1.weight"]  # [B, N, 1]
    mask = sd[net + "3.weight"]  # [C*N, B, 1]
    assert bott.shape == (B, N, 1) and mask.shape == (C * N, B, 1)

    pi, ni, wi = _dsconv_slots(cfg.causal)
    in_w = np.empty((R, X, B, H), np.float32)
    dw_w = np.empty((R, X, P, H), np.float32)
    out_w = np.empty((R, X, H, B), np.float32)
    in_prelu = np.empty((R, X), np.float32)
    dw_prelu = np.empty((R, X), np.float32)
    norms = {f"{site}_{p}": np.empty((R, X, H), np.float32)
             for site in ("in", "dw") for p in ("gamma", "beta")}
    bn_state = ({f"{site}_{p}": np.empty((R, X, H), np.float32)
                 for site in ("in", "dw") for p in ("mean", "var")}
                if cfg.norm_type == "BN" else None)

    for r in range(R):
        for x in range(X):
            blk = f"{net}2.{r}.{x}.net."
            in_w[r, x] = f32(sd[blk + "0.weight"][:, :, 0].T)    # [H,B,1]->[B,H]
            in_prelu[r, x] = float(np.asarray(sd[blk + "1.weight"]).reshape(()))
            nin = _norm_entries(sd, blk + "2.", cfg.norm_type, H)
            norms["in_gamma"][r, x] = nin["gamma"]
            norms["in_beta"][r, x] = nin["beta"]
            ds = blk + "3.net."
            dw_w[r, x] = f32(sd[ds + "0.weight"][:, 0, :].T)     # [H,1,P]->[P,H]
            dw_prelu[r, x] = float(np.asarray(sd[ds + f"{pi}.weight"]).reshape(()))
            ndw = _norm_entries(sd, ds + f"{ni}.", cfg.norm_type, H)
            norms["dw_gamma"][r, x] = ndw["gamma"]
            norms["dw_beta"][r, x] = ndw["beta"]
            out_w[r, x] = f32(sd[ds + f"{wi}.weight"][:, :, 0].T)  # [B,H,1]->[H,B]
            if bn_state is not None:
                bn_state["in_mean"][r, x] = nin["mean"]
                bn_state["in_var"][r, x] = nin["var"]
                bn_state["dw_mean"][r, x] = ndw["mean"]
                bn_state["dw_var"][r, x] = ndw["var"]

    params = {
        "encoder": {"U": f32(enc[:, 0, :].T)},          # [L, N]
        "separator": {
            "ln": {"gamma": ln["gamma"], "beta": ln["beta"]},
            "bottleneck": {"w": f32(bott[:, :, 0].T)},  # [N, B]
            "blocks": {
                "in_w": in_w, "in_prelu": in_prelu,
                "dw_w": dw_w, "dw_prelu": dw_prelu,
                "out_w": out_w, **norms,
            },
            "mask": {"w": f32(mask[:, :, 0].T)},        # [B, C*N]
        },
        "decoder": {"V": f32(dec.T)},                   # [N, L]
    }
    state: Dict[str, Any] = {"blocks": bn_state} if bn_state is not None else {}
    return params_from_jax(params, state)


def state_dict_from_params(
    params: Dict[str, Any], state: Dict[str, Any], cfg: ConvTasNetConfig
) -> Dict[str, np.ndarray]:
    """Inverse mapping: the port's trees as a reference-layout state_dict
    of CPU tensors (ready for load_state_dict or torch.save)."""
    p = {k: _np(v).astype(np.float32) for k, v in _flatten2(params).items()}
    N, L, B, H, P, X, R, C = (cfg.N, cfg.L, cfg.B, cfg.H, cfg.P, cfg.X,
                              cfg.R, cfg.C)
    sd: Dict[str, np.ndarray] = {
        "encoder.conv1d_U.weight": p["encoder/U"].T[:, None, :],   # [N,1,L]
        "decoder.basis_signals.weight": p["decoder/V"].T,           # [L,N]
        "separator.network.0.gamma": p["separator/ln/gamma"].reshape(1, N, 1),
        "separator.network.0.beta": p["separator/ln/beta"].reshape(1, N, 1),
        "separator.network.1.weight": p["separator/bottleneck/w"].T[:, :, None],
        "separator.network.3.weight": p["separator/mask/w"].T[:, :, None],
    }
    pi, ni, wi = _dsconv_slots(cfg.causal)
    blocks = {k.split("/")[-1]: _np(v).astype(np.float32)
              for k, v in _flatten2(params["separator"]["blocks"]).items()}
    bn = state.get("blocks") if cfg.norm_type == "BN" else None
    for r in range(R):
        for x in range(X):
            blk = f"separator.network.2.{r}.{x}.net."
            ds = blk + "3.net."
            sd[blk + "0.weight"] = blocks["in_w"][r, x].T[:, :, None]
            sd[blk + "1.weight"] = blocks["in_prelu"][r, x].reshape(1)
            sd[ds + "0.weight"] = blocks["dw_w"][r, x].T[:, None, :]
            sd[ds + f"{pi}.weight"] = blocks["dw_prelu"][r, x].reshape(1)
            sd[ds + f"{wi}.weight"] = blocks["out_w"][r, x].T[:, :, None]
            for site, idx in (("in", blk + "2."), ("dw", ds + f"{ni}.")):
                g = blocks[f"{site}_gamma"][r, x]
                b = blocks[f"{site}_beta"][r, x]
                if cfg.norm_type == "BN":
                    sd[idx + "weight"] = g
                    sd[idx + "bias"] = b
                    sd[idx + "running_mean"] = _np(bn[f"{site}_mean"][r, x]).astype(
                        np.float32)
                    sd[idx + "running_var"] = _np(bn[f"{site}_var"][r, x]).astype(np.float32)
                    sd[idx + "num_batches_tracked"] = np.zeros((), np.int64)
                else:
                    sd[idx + "gamma"] = g.reshape(1, H, 1)
                    sd[idx + "beta"] = b.reshape(1, H, 1)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten2(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten2(v, key))
        else:
            out[key] = v
    return out


def load_torch_package(path: str) -> Dict[str, Any]:
    """Unpickle a reference .pth.tar package with CPU mapping, returning
    state_dict values as numpy arrays. The package is a pickle: load only
    files from a trusted source."""
    package = torch.load(path, map_location="cpu", weights_only=False)
    sd = package.get("state_dict", package)
    package = dict(package) if isinstance(package, dict) else {"state_dict": sd}
    package["state_dict"] = {
        k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        for k, v in sd.items()
    }
    return package


def import_package(package: Dict[str, Any], **cfg_overrides):
    """Reference package dict -> (the port's cfg, params, state)."""
    cfg = config_from_package(package, **cfg_overrides)
    params, state = params_from_state_dict(package["state_dict"], cfg)
    return cfg, params, state
