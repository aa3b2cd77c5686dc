"""BENCHMARK.json against the contract's rules, and every cell resolving to
its files."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness, spec
from benchmark.tests import tiny

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("N", "B", "H", "P", "L", "C")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_all_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[group]
    assert set(entry) <= allowed
    for key in ("why", "layer", "source"):
        if key in entry and group in ("configs", "workloads"):
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0 < entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(entry["layer"]) <= 200
    if group == "workloads":
        assert entry["chips"] == 1 and NAME.match(entry["traffic"]) and NAME.match(entry["config"])
    if group == "configs":
        assert all(NAME.match(k) for k in entry["reduced"])
        assert not set(entry["reduced"]) & set(WIDTHS)


def test_names_are_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert spec.load_module("drivers", cell.traffic["driver"]) is not None
    for m in cell.per_layer:
        assert spec.load_module("metrics", m["name"]) is not None, m["name"]
        assert m["moves"] in e2e
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    model = spec.model_kwargs(cell.config)
    assert model["compute_dtype"] == "bfloat16"
    for c in BENCH["configs"]:
        if c["name"] == cell.config["name"]:
            assert c["file"].startswith("benchmark/")


def test_every_config_is_used_and_full_size():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        f = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert (f["N"], f["L"], f["B"], f["H"], f["P"], f["X"], f["R"], f["C"]) == \
            (256, 20, 256, 512, 3, 8, 4, 2)
        assert f["reduced"] == c["reduced"] == []


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a kernel's work
    file added as new files, in a copy, with BENCHMARK.json's lists only
    growing: the new cell runs and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.bench_dir(), root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    d = root / "benchmark"
    cfg = spec.load_json(os.path.join(spec.ROOT, "benchmark/configs/causal.json"))
    (d / "configs" / "causal3.json").write_text(json.dumps({**cfg, "name": "causal3", "C": 3}))
    t = spec.load_json(os.path.join(spec.bench_dir(), "traffic", "stream.b1x20ms.json"))
    (d / "traffic" / "stream.b1x40ms.json").write_text(json.dumps({**t, "chunk": 320}))
    (d / "limits" / "causal3.stream.b1x40ms.json").write_text(json.dumps({"wave_err": 0.5}))
    (d / "metrics" / "chunk_records.py").write_text(
        "def read(name, trace, ctx):\n    return float(trace.n_records)\n")
    (d / "kernels" / "tcn_new_kernel.py").write_text(
        "def work(s, n):\n    return n * 1.0, n * 2.0, 'float32'\n")
    bench["configs"].append({"name": "causal3", "source": "https://arxiv.org/abs/1809.07454",
                             "file": "benchmark/configs/causal3.json", "reduced": [],
                             "why": "three speakers"})
    bench["workloads"].append({"name": "causal3.stream.b1x40ms", "config": "causal3",
                               "traffic": "stream.b1x40ms", "chips": 1, "why": "40 ms chunks"})
    bench["end_to_end"][-2]["workloads"] = bench["end_to_end"][-2]["workloads"] + [
        "causal3.stream.b1x40ms"]
    bench["per_layer"].append({"name": "chunk_records", "unit": "launches", "better": "lower",
                               "source": "device_trace", "layer": "streaming",
                               "moves": "stream_chunk_p95_ms",
                               "workloads": ["causal3.stream.b1x40ms"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("causal3.stream.b1x40ms", str(root))
    assert cell.config["C"] == 3 and cell.traffic["chunk"] == 320
    assert spec.load_module("kernels", "tcn_new_kernel", str(root)).work({}, 2) == (2.0, 4.0,
                                                                                   "float32")
    over = {"model": {**tiny.MODEL, "C": 3}, "traffic": {**tiny.TRAFFIC["causal.stream.b1x20ms"],
                                                         "min_samples": 1920,
                                                         "max_samples": 3840,
                                                         "grid_step": 960}}
    res = harness.run(cell.name, tiny.SEED, 0.3, True, "cpu", root=str(root), overrides=over)
    assert res["metrics"]["chunk_records"]["value"] > 0
    assert res["correct"]
