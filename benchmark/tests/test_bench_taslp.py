"""The taslp configuration's cell (the paper's final version: a skip path)
on the CPU at a tiny size, in tiny.py's pattern: drivers/train_skip.py builds, steps
and passes its own check against benchmark/reference/convtasnet_skip.py,
a planted fault fails it, and the final version's keys reach the port."""

import pytest

from benchmark import faults, harness, spec
from benchmark.drivers import train_skip
from benchmark.tests import tiny

CELL = "taslp.train.b8x4s"
# tiny.MODEL's widths with a skip path narrower than B (so mask/w is drawn
# [Sc, C*N] by drivers/train_skip.py) and the final version's other keys as the
# configuration file states them.
MODEL = {**tiny.MODEL, "Sc": 16}
OVERRIDES = {"model": MODEL, "traffic": tiny.TRAFFIC["paper.train.b8x4s"],
             "limits": tiny.LIMITS["paper.train.b8x4s"]}


def _run(trace=False, seed=tiny.SEED):
    return harness.run(CELL, seed, 0.3, trace, "cpu", overrides=OVERRIDES)


def test_config_file_holds_the_final_versions_keys():
    cfg = spec.cell(CELL).config
    assert {k: cfg[k] for k in train_skip.FINAL_KEYS} == {
        "Sc": 128, "encoder_relu": False, "input_norm": "gLN"}
    assert cfg["mask_nonlinear"] == "sigmoid" and cfg["reduced"] == []


def test_weights_hold_the_skip_leaves():
    m = {**spec.model_kwargs(spec.cell(CELL).config), **MODEL, "encoder_relu": False,
         "input_norm": "gLN"}
    tree = train_skip.make_weights(m, tiny.SEED, "cpu")
    assert tuple(tree["separator"]["blocks"]["skip_w"].shape) == (2, 3, 64, 16)
    assert tuple(tree["separator"]["mask"]["w"].shape) == (16, 2 * 16)
    assert float(tree["separator"]["mask"]["prelu"]) == 0.25
    again = train_skip.make_weights(m, tiny.SEED, "cpu")
    assert all((a == b).all() for (_, a), (_, b) in zip(
        train_skip.ref.leaves(tree), train_skip.ref.leaves(again)))


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    if not trace:
        assert "train_audio_s_per_s" in res["metrics"] and "setup_s" in res["metrics"]
    else:
        assert {"glue_ms.taslp", "idle_share.taslp"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["stale", "half_batch"])
def test_fault_is_not_correct(fault):
    with faults.plant(fault):
        res = _run()
    assert not res["correct"], res["checks"]
