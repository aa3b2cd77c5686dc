"""The port's observability and debugging helpers and its streaming tools
(CPU)."""

import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.data.wavio import write_wav
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.tools import bench_streaming, check_streaming_ckpt
from convtasnet_torch.training.checkpoint import save_checkpoint
from convtasnet_torch.utils import debugging
from convtasnet_torch.utils.observability import StepTimer, profile_trace
from convtasnet_tpu.utils.observability import StepTimer as JaxStepTimer

torch.set_num_threads(1)
# Largest |streamed - offline| / max |offline| in f32 on the CPU: the two
# paths differ only by the matmuls' summation order (~1e-7 measured).
STREAM_REL_TOL = 1e-5


@pytest.mark.parametrize("skip_first,n_ticks", [(2, 7), (2, 2), (0, 4), (5, 3)])
def test_step_timer_matches_jax(monkeypatch, skip_first, n_ticks):
    clock = [0.0, 0.5, 0.75, 1.0, 1.125, 1.625, 2.0, 2.25]
    ticks = iter(clock[:n_ticks] * 2)  # the same script for each timer
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timers = [StepTimer(skip_first), JaxStepTimer(skip_first)]
    for t in timers:
        for _ in range(n_ticks):
            t.tick()
    assert timers[0].times == timers[1].times
    assert timers[0].mean_ms == pytest.approx(timers[1].mean_ms, rel=1e-12)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(tmp_path / "t" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(ValueError):
        with profile_trace(str(tmp_path / "err")):
            raise ValueError("inside the block")
    assert os.path.exists(tmp_path / "err" / "trace.json")
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


@pytest.fixture
def fake_sync_debug(monkeypatch):
    """torch.cuda's sync debug mode, kept in a dict (this torch has no CUDA)."""
    mode = {"value": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["value"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(value={"default": 0, "warn": 1, "error": 2}.get(m, m)))
    return mode


@pytest.mark.parametrize("raise_inside", [False, True])
@pytest.mark.parametrize("prev_anomaly", [False, True])
def test_strict_mode_restores_settings(fake_sync_debug, raise_inside, prev_anomaly):
    fake_sync_debug["value"] = 1
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(prev_anomaly, check_nan=False)
    try:
        with pytest.raises(RuntimeError) if raise_inside else contextlib.nullcontext():
            with debugging.strict_mode():
                assert fake_sync_debug["value"] == 2
                assert torch.is_anomaly_enabled()
                if raise_inside:
                    raise RuntimeError("inside the block")
        assert fake_sync_debug["value"] == 1
        assert torch.is_anomaly_enabled() == prev_anomaly
        assert not torch.is_anomaly_check_nan_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before[0], check_nan=before[1])


def test_strict_mode_without_nan_checks_leaves_anomaly_off(fake_sync_debug):
    assert not torch.is_anomaly_enabled()
    with debugging.strict_mode(nan_checks=False, sync_debug="warn"):
        assert fake_sync_debug["value"] == 1
        assert not torch.is_anomaly_enabled()
    assert fake_sync_debug["value"] == 0


def test_check_streaming_ckpt_prints_its_keys(tmp_path, capsys):
    cfg = ConvTasNetConfig(N=16, L=8, B=12, H=24, P=3, X=2, R=2, C=2, norm_type="cLN",
                           causal=True, compute_dtype="float32")
    params, state = tm.init_params(torch.Generator().manual_seed(0), cfg)
    ckpt = str(tmp_path / "c.ckpt")
    save_checkpoint(ckpt, cfg, params, state)
    rng = np.random.default_rng(0)
    entries = []
    for i, T in enumerate((1600, 1234)):
        p = str(tmp_path / f"m{i}.wav")
        write_wav(p, 0.05 * rng.standard_normal(T), 8000)
        entries.append([p, T])
    with open(tmp_path / "mix.json", "w") as f:
        json.dump(entries, f)
    check_streaming_ckpt.main(["--model_path", ckpt, "--mix_json", str(tmp_path / "mix.json"),
                               "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "max_abs_err", "chunk_ms", "sample_rate", "n",
            "compute_dtype", "device"} <= row.keys()
    assert row["n"] == 2 and row["device"] == "cpu"
    assert row["value"] < STREAM_REL_TOL


def test_bench_streaming_tiny_on_cpu(capsys):
    rows = bench_streaming.main(["--tiny", "--chunks_ms", "20", "10", "--batch", "1", "2",
                                 "--steps", "4", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == rows and len(rows) == 4
    for row in rows:
        assert {"chunk_ms", "batch", "latency_ms", "rtf", "streams_per_card_rt", "graph",
                "setup_ms", "device_busy_ms", "ops_per_chunk", "device"} <= row.keys()
        assert row["device"] == "cpu" and row["graph"] is False
        assert row["device_busy_ms"] is None and row["latency_ms"] > 0
    assert [(r["chunk_ms"], r["batch"]) for r in rows] == [(20, 1), (20, 2), (10, 1), (10, 2)]
