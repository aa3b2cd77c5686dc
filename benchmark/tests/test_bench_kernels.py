"""The work files, the readers and the trace arithmetic, on numbers made
here."""

import types

import pytest
import torch

from benchmark import flops, spec, tracing
from benchmark.tests import tiny

PAPER = spec.model_kwargs(spec.cell("paper.train.b8x4s").config)
HBM = 3.35e12

# PERF.md's kernel table: each kernel's bound in ms per launch at K = 3199,
# separation kernels at M = 8, training kernels at M = 5, to 4 decimals.
# That table counted K_pad = 3200 rows and the statistics' tile partials;
# the work files count the K frames the inputs hold and one set of
# statistics, so they agree within 1 %. KB1's bound there also counted the
# tile partials of its column sums, and KF's every partial its producers
# leave: neither is work these inputs need, so those two read lower.
BOUNDS = [("tcn_in_gemm", 8, 0.0118), ("tcn_dwconv", 8, 0.0157),
          ("tcn_out_gemm_fold", 8, 0.0157), ("tcn_out_gemm_unfold", 8, 0.0157),
          ("tcn_fold_weights", 8, 0.0076), ("tcn_dwconv_save", 5, 0.0147),
          ("tcn_bwd_dz", 5, 0.0125), ("tcn_wgrad_out", 5, 0.0075),
          ("tcn_bwd_dwconv", 5, 0.0196), ("tcn_bwd_dx", 5, 0.0196),
          ("tcn_wgrad_in", 5, 0.0075), ("tcn_bwd_finish", 5, 0.0974)]
BELOW = {"tcn_bwd_dz": 0.02, "tcn_bwd_finish": 0.9}  # how far below, at most


def _bound_ms(name, M):
    s = flops.shape(PAPER, {"M": M, "T": 32000})
    b, f, dt = spec.load_module("kernels", name).work(s, 1)
    peak = spec.peaks("NVIDIA H100 80GB HBM3")
    assert b / HBM >= f / peak["flops_per_s"][dt]  # every kernel is bound by bytes
    return 1e3 * b / peak["hbm_bytes_per_s"]


@pytest.mark.parametrize("name,M,table", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_work_files_give_the_bound_column(name, M, table):
    got = _bound_ms(name, M)
    if name in BELOW:
        assert table * (1 - BELOW[name]) <= got <= table
    else:
        assert got == pytest.approx(table, rel=0.01)


def test_forward_flops_of_a_batch():
    # 443 GFLOP per batch-8 x 4 s forward at the paper config (PERF.md)
    assert flops.forward_flops(PAPER, 8, 32000) == pytest.approx(443e9, rel=0.01)
    assert flops.num_frames(PAPER, 32000) == 3199


def _trace(units, records, intervals, window=(0, 10_000_000), untraced_s=0.02):
    return tracing.Trace(units, records, intervals, window, [(0, 4_000_000, "bench:step")],
                         (untraced_s, units))


def _ctx(cell):
    c = spec.cell(cell)
    return types.SimpleNamespace(cell=c, model=spec.model_kwargs(c.config),
                                 device=torch.device("cuda"))


def test_roofline_and_mfu_readers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    ctx = _ctx("paper.separate.b8x4s")
    unit = {"M": 8, "T": 32000, "passes": 1, "launches": {"tcn_in_gemm": 2}}
    bound = 2 * _bound_ms("tcn_in_gemm", 8) * 1e-3
    tr = _trace([unit], {"void tcn::hop::hgemm_kernel<3, 256, 2>": (2, 4 * bound),
                         "elementwise": (3, 0.001)}, [(0, 5_000_000)])
    roof = spec.load_module("metrics", "kernel_roofline.separate")
    assert roof.read("kernel_roofline.separate", tr, ctx) == pytest.approx(25.0)
    mfu = spec.load_module("metrics", "mfu.separate")
    want = 100 * flops.forward_flops(PAPER, 8, 32000) / 0.02 / 989e12  # the untraced time
    assert mfu.read("mfu.separate", tr, ctx) == pytest.approx(want)
    unit["launches"]["tcn_nameless"] = 1  # a counter with no work file: left out
    assert roof.read("kernel_roofline.separate", tr, ctx) is None


def test_idle_glue_and_launch_readers():
    ctx = _ctx("paper.train.b8x4s")
    units = [{"M": 8, "T": 32000, "passes": 3, "launches": {}}] * 2
    tr = _trace(units, {"tcn::a": (4, 0.002), "copy": (6, 0.003)},
                [(0, 2_000_000), (1_000_000, 3_000_000), (6_000_000, 7_000_000)],
                untraced_s=0.005)
    assert tr.busy_s == pytest.approx(0.004) and tr.window_s == pytest.approx(0.01)
    idle = spec.load_module("metrics", "idle_share.train").read("idle_share.train", tr, ctx)
    assert idle == pytest.approx(60.0)
    for cell in ("stream", "latency"):  # busy 4 ms over the untraced 5 ms
        name = f"idle_share.{cell}"
        assert spec.load_module("metrics", name).read(name, tr, ctx) == pytest.approx(20.0)
    glue = spec.load_module("metrics", "glue_ms.train").read("glue_ms.train", tr, ctx)
    assert glue == pytest.approx(1.5)
    lpc = spec.load_module("metrics", "launches_per_chunk.stream")
    assert lpc.read("launches_per_chunk.stream", tr, ctx) == 5.0
    b = tr.breakdown()
    assert b["device_ops"][0] == ["copy", 0.003]
    assert b["idle_gaps"][0][0] in ("bench:step", "host outside the harness's spans")
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(0.006)


def test_verdict_counts_records():
    units = [{"launches": {"tcn_in_gemm": 1}}, {"launches": {"tcn_in_gemm": 1}}]
    one = {"tcn::k": (1, 1.0), "copy": (2, 1.0)}
    assert tracing.verdict(units, {"tcn::k": (2, 1.0), "copy": (4, 1.0)}, one, 2) == ""
    assert "port" in tracing.verdict(units, {"tcn::k": (1, 1.0), "copy": (4, 1.0)}, one, 2)
    assert "one-unit" in tracing.verdict(units, {"tcn::k": (2, 1.0), "copy": (3, 1.0)}, one, 2)
    assert "no device record" in tracing.verdict([], {}, None, 2)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traced_run_reports_its_metrics_on_the_cpu(cell):
    from benchmark import harness

    res = harness.run(cell, tiny.SEED, 0.3, True, "cpu", overrides=tiny.overrides(cell))
    names = {m["name"] for m in spec.cell(cell).per_layer}
    assert set(res["metrics"]) <= names and any(k.startswith("idle_share") for k in res["metrics"])
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["device_ops"]) <= 10
