"""Self-describing checkpoints in the JAX package's format.

One .npz of flattened parameter / state leaves plus a JSON header, written
atomically (tmp + rename). Keys are the JAX pytree paths joined by "/"
(`params/separator/blocks/in_w`, `state/blocks/in_mean`), so a checkpoint
written by either package loads in the other. The model config is rebuilt
from the header, remat and scan_unroll included; the JAX-only key it may
carry (use_pallas) is dropped. The optimizer state is stored under the JAX
`opt/` keys (`opt/step` int32, `opt/lr`, `opt/mu/...`, `opt/nu/...`,
convtasnet_tpu/training/checkpoint.py:78-86, :130-131), so either package
resumes from the other's checkpoint with its optimizer state.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ConvTasNetConfig
from .optim import OptState

_SEP = "/"
FORMAT = "convtasnet_tpu.ckpt.v1"


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """Leaves of nested dicts in sorted-key order (jax.tree_util's order)."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        else:
            t = node.detach().cpu() if isinstance(node, torch.Tensor) else node
            out[prefix + _SEP.join(path)] = np.asarray(t)

    walk(tree, [])
    return out


def _unflatten(arrays: Dict[str, np.ndarray], prefix: str, device) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split(_SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr)).to(device)
    return tree


def _check_against(template: Any, tree: Any, path: str) -> None:
    """Every template leaf must be present with the same shape."""
    if isinstance(template, dict):
        for k, v in template.items():
            if not isinstance(tree, dict) or k not in tree:
                raise KeyError(f"checkpoint missing array: {path}{k}")
            _check_against(v, tree[k], f"{path}{k}{_SEP}")
    elif tuple(template.shape) != tuple(tree.shape):
        raise ValueError(f"shape mismatch for {path.rstrip(_SEP)}: ckpt "
                         f"{tuple(tree.shape)} vs model {tuple(template.shape)}")


def save_checkpoint(path: str, cfg: ConvTasNetConfig, params: Any, state: Any,
                    opt_state: Optional[OptState] = None, epoch: int = 0,
                    tr_loss: Optional[list] = None, cv_loss: Optional[list] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write a self-describing checkpoint."""
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(_flatten(params, "params/"))
    arrays.update(_flatten(state, "state/"))
    if opt_state is not None:
        arrays.update(_flatten(opt_state._asdict(), "opt/"))
    header = {
        "format": FORMAT,
        "model_config": cfg.header_dict(),
        "epoch": int(epoch),
        "tr_loss": list(map(float, tr_loss or [])),
        "cv_loss": list(map(float, cv_loss or [])),
        "has_opt": opt_state is not None,
        "extra": extra or {},
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __header__=np.frombuffer(json.dumps(header).encode(),
                                                 dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_header(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return json.loads(bytes(z["__header__"]).decode())


def load_checkpoint(path: str, device=None, params_template: Any = None,
                    state_template: Any = None, opt_template: Any = None
                    ) -> Dict[str, Any]:
    """Load a checkpoint: the header, the raw flat arrays, the config, the
    parameter / state trees as tensors on `device` (CPU by default) and,
    when the header has one, "opt_state" (an OptState). With templates,
    every template leaf must be present with its shape."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    out: Dict[str, Any] = {
        "header": header, "arrays": arrays,
        "config": ConvTasNetConfig.from_header(header["model_config"]),
        "params": _unflatten(arrays, "params/", dev),
        "state": _unflatten(arrays, "state/", dev),
    }
    if header.get("has_opt"):
        opt = _unflatten(arrays, "opt/", dev)
        out["opt_state"] = OptState(step=opt["step"], lr=opt["lr"],
                                    mu=opt.get("mu", {}), nu=opt.get("nu", {}))
        if opt_template is not None:
            _check_against(opt_template._asdict(), out["opt_state"]._asdict(), "opt/")
    if params_template is not None:
        _check_against(params_template, out["params"], "params/")
    if state_template is not None:
        _check_against(state_template, out["state"], "state/")
    return out


def load_model(path: str, device=None):
    """Rebuild (cfg, params, state) from the checkpoint alone, checked
    against the structure init_params gives for its config."""
    from ..models.conv_tasnet import init_params

    cfg = ConvTasNetConfig.from_header(load_header(path)["model_config"])
    tp, ts = init_params(torch.Generator(), cfg, device="meta")  # shapes only
    out = load_checkpoint(path, device, params_template=tp, state_template=ts)
    return cfg, out["params"], out["state"]
