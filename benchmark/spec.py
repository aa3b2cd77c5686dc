"""BENCHMARK.json and the files it names, each found by its name."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Model keys of a configuration file that the port's ConvTasNetConfig takes.
MODEL_KEYS = ("N", "L", "B", "H", "P", "X", "R", "C", "norm_type", "causal",
              "mask_nonlinear", "compute_dtype")


class Cell(NamedTuple):
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # {check name: limit}
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int
    root: str


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str = ROOT) -> str:
    return os.path.join(root, "benchmark")


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files loaded."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    d = bench_dir(root)
    traffic = load_json(os.path.join(d, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(d, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, config, traffic, limits, e2e, per_layer, int(w["chips"]), root)


def model_kwargs(config: dict) -> Dict[str, object]:
    """The ConvTasNetConfig keywords of a configuration file."""
    return {k: config[k] for k in MODEL_KEYS}


def load_module(kind: str, name: str, root: str = ROOT):
    """benchmark/<kind>/<name>.py as a module, or None where there is no such
    file. A metric falls back to the file of its name's first part
    (`kernel_roofline.train` -> `kernel_roofline.py`)."""
    d = os.path.join(bench_dir(root), kind)
    for stem in (name, name.split(".")[0]):
        path = os.path.join(d, stem + ".py")
        if os.path.exists(path):
            mod_name = f"benchmark_{kind}_{stem}".replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
        if kind != "metrics":
            break
    return None


def peaks(kind: str, root: str = ROOT):
    """The peaks.json row of a device whose name contains its key, or None."""
    table = load_json(os.path.join(bench_dir(root), "peaks.json"))
    for key, row in table.items():
        if key in kind:
            return row
    return None
