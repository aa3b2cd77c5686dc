"""The port's measuring tools (convtasnet_torch/tools/bench_*.py) at a tiny
size on the CPU: their JSON rows, their keys and their devices. The
times are the CPU's; the card's come from chip_smoke.py."""

import json

import numpy as np
import pytest
import torch

from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.tools import (bench_infer_paths, bench_scaled_config, bench_scaling,
                                    bench_sdr, bench_train_paths, profile_forward)
from convtasnet_torch.tools._bench import forward_matmul_flops
from convtasnet_tpu.config import ConvTasNetConfig as JConfig

torch.set_num_threads(1)


def _printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_bench_scaled_config_train_tiers(capsys):
    rows = bench_scaled_config.main(["train", "--tiny", "--device", "cpu", "--seg_sec", "0.25",
                                     "--steps", "1"])
    assert _printed(capsys) == rows
    assert [r["tier"] for r in rows] == list(bench_scaled_config.TIERS)
    assert [r["form"] for r in rows] == ["eager", "eager", "whole_block_train",
                                         "whole_tcn_train"]
    assert [r["remat"] for r in rows] == [False, "dots", False, False]
    for r in rows:
        assert r["ok"] and not r["oom"] and r["steps_run"] == 3
        assert r["device"] == "cpu" and r["peak_gb"] is None and r["held_gb"] is None
        assert r["step_ms"] > 0
        assert r["metric"] == "scaled_config_train" and r["sr"] == 16000
    # The same seed, batch and f32 math: every tier starts from one loss.
    np.testing.assert_allclose([r["loss"] for r in rows], rows[0]["loss"], rtol=1e-3)


def test_bench_scaled_config_oom_row(monkeypatch):
    """An out-of-memory error is a row (ok false, oom true), not a crash."""
    def oom(*a):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 64.00 GiB")

    monkeypatch.setattr(bench_scaled_config, "_train_steps", oom)
    row = bench_scaled_config.bench_train("eager_noremat", 2, 0.25, 1, torch.device("cpu"),
                                          tiny=True)
    assert (row["ok"], row["oom"], row["steps_run"]) == (False, True, None)
    assert "out of memory" in row["error"]


def test_bench_scaled_config_infer_and_config(capsys):
    rows = bench_scaled_config.main(["infer", "--tiny", "--device", "cpu", "--seg_sec", "0.25",
                                     "--batch", "2"])
    assert _printed(capsys) == rows
    row = rows[0]
    assert row["kernel_tier"] == "whole_tcn" and row["latency_ms"] > 0
    assert row["matmul_floor_frac"] is None and row["device"] == "cpu"
    assert "989" in row["floor_peak"]
    # The published scaled config: BASELINE.json configs[4], on the launch limits.
    cfg = bench_scaled_config.scaled_cfg()
    assert (cfg.N, cfg.L, cfg.B, cfg.H, cfg.P, cfg.X, cfg.R) == (256, 32, 256, 1024, 3, 10, 6)
    for tier, form in (("hybrid", "whole_tcn_train"), ("whole", "whole_block_train")):
        assert bench_scaled_config.scaled_cfg(**bench_scaled_config.TIERS[tier]).kernel_form(
            True, "cuda") == form
    assert cfg.kernel_form(False, "cuda") == "whole_tcn"
    assert cfg.num_frames(int(8.0 * bench_scaled_config.SR)) == 7999


def test_forward_matmul_flops_matches_bench():
    """The analytic forward work is bench.py's formula."""
    import bench

    for kw in ({}, dict(N=256, L=32, B=256, H=1024, P=3, X=10, R=6)):
        want = bench._matmul_flops_forward(JConfig(**kw), 2, 32000)
        assert forward_matmul_flops(ConvTasNetConfig(**kw), 2, 32000) == want


@pytest.mark.parametrize("paths", [["0", "0+dots", "0+block", "0+repeat"],
                                   ["hybrid", "whole", "hybrid+dots"]])
def test_bench_train_paths(capsys, paths):
    rows = bench_train_paths.main([*paths, "--tiny", "--device", "cpu", "--batch", "2",
                                   "--steps", "1"])
    assert _printed(capsys) == rows and [r["path"] for r in rows] == paths
    for r in rows:
        assert r["step_ms"] > 0 and r["fwd_ms"] > 0 and r["device"] == "cpu"
        assert r["form"] == {"0": "eager", "hybrid": "whole_tcn_train",
                             "whole": "whole_block_train"}[r["use_kernels"]]
    assert bench_train_paths.parse_path("0+dots") == {"use_kernels": "0", "remat": "dots"}


def test_bench_infer_paths(capsys):
    rows = bench_infer_paths.main(["--tiny", "--device", "cpu", "--batch", "2", "--steps", "1"])
    assert _printed(capsys) == rows
    assert [(r["path"], r["form"]) for r in rows] == [
        ("auto", "whole_tcn"), ("block", "whole_block"), ("0", "eager")]
    assert all(r["fwd_ms"] > 0 and r["device"] == "cpu" for r in rows)


@pytest.mark.parametrize("graph", ["0", "1"])
def test_bench_infer_paths_graph_flag(capsys, graph):
    """--graph 1 times the forward through GraphedForward and the train step
    through GraphedStep (eager on the CPU: graphs are a CUDA mechanism),
    --graph 0 the bare forward and step; the scaled config's modes and
    profile_forward's train step take the same flag."""
    rows = bench_infer_paths.main(["auto", "--tiny", "--device", "cpu", "--batch", "1",
                                   "--steps", "1", "--graph", graph])
    rows += bench_scaled_config.main(["infer", "--tiny", "--device", "cpu", "--batch", "1",
                                      "--seg_sec", "0.25", "--graph", graph])
    rows += bench_train_paths.main(["hybrid", "--tiny", "--device", "cpu", "--batch", "1",
                                    "--steps", "1", "--graph", graph])
    rows += bench_scaled_config.main(["train", "--tiers", "hybrid", "--tiny", "--device", "cpu",
                                      "--batch", "1", "--seg_sec", "0.25", "--steps", "1",
                                      "--graph", graph])
    assert _printed(capsys) == rows and len(rows) == 4
    for r in rows:
        assert r["graphed"] is False and r["capture_ms"] is None and r["pool_bytes"] is None
    # The graphed train step is profiled too: only the card is missing here.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_forward.profile(5, "hybrid", train=True, graph=bool(int(graph)))


def test_bench_sdr(capsys):
    row = bench_sdr.main(["--device", "cpu", "--utts", "3", "--batch", "2", "--sec", "0.5",
                          "--host_utts", "2"])
    assert _printed(capsys) == [row]
    assert row["device"] == "cpu" and row["host_s_per_utt"] > 0
    assert row["device_s_per_utt"] > 0 and row["device_s_per_utt_batch1"] > 0
    assert row["max_abs_sdri_diff_db"] < 1e-6  # f64 on both paths


def test_bench_scaling_spawned_gloo_ranks(capsys):
    """World sizes 1 and 2 as spawned gloo ranks on the CPU (the JAX tool's
    virtual mesh): weak scaling rows and the summary."""
    rows = bench_scaling.main(["--sizes", "1", "2", "--tiny", "--device", "cpu",
                               "--per_device_batch", "1", "--steps", "1", "--seconds", "0.5"])
    printed = _printed(capsys)
    assert printed[:2] == rows and printed[2]["metric"] == "dp_weak_scaling"
    assert printed[2]["shared_device"] is True and printed[2]["backend"] == ["gloo", "gloo"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["global_batch"] for r in rows] == [1, 2]
    assert rows[0]["audio_sps"] > 0 and "efficiency_vs_1" in rows[1]


@pytest.mark.parametrize("tool,argv", [(bench_scaled_config, ["train", "--tiny"]),
                                       (bench_train_paths, ["--tiny"]),
                                       (bench_infer_paths, ["--tiny"]),
                                       (bench_sdr, []),
                                       (bench_scaling, ["--tiny"])])
def test_tools_default_to_cuda(tool, argv):
    """Without --device cpu every tool runs on CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
