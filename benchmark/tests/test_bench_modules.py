"""A run never holds JAX or the JAX package, and refuses to run without a
card or outside a full checkout."""

import os
import shutil
import subprocess
import sys

from benchmark import harness, spec
from benchmark.tests import tiny

ROOT = spec.ROOT


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jaxlike", "convtasnet_torch", "convtasnet_tpu_x", "flaxen.a"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in harness.forbidden_modules()
                if m in ("jaxlike", "convtasnet_torch", "convtasnet_tpu_x", "flaxen.a")]
    monkeypatch.setitem(sys.modules, "convtasnet_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"convtasnet_tpu.models", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_run_loads_no_jax():
    code = ("import sys; from benchmark import harness; from benchmark.tests import tiny; "
            "[harness.run(c, tiny.SEED, 0.2, t, 'cpu', overrides=tiny.overrides(c)) "
            "for c in tiny.CELLS for t in (False, True)]; "
            "print('FORBIDDEN', harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def _bench(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "paper.train.b8x4s", "--seed", str(tiny.SEED), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _bench(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(spec.bench_dir(), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _bench(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
