"""The readers of the port's own spans and counters (host_us.*,
program_idle_us.*, graph_setup_s) on numbers made here, and in the tiny
cells on the CPU."""

import types

import pytest
import torch

from benchmark import harness, spec, tracing
from benchmark.tests import tiny
from convtasnet_torch.models import graphed
from convtasnet_torch.utils import observability
from convtasnet_torch.utils.observability import Span

NEW = ("host_us.latency", "host_us.stream", "program_idle_us.latency",
       "program_idle_us.stream", "graph_setup_s")


def _ctx(cell):
    c = spec.cell(cell)
    return types.SimpleNamespace(cell=c, model=spec.model_kwargs(c.config),
                                 device=torch.device("cuda"))


def _read(name, trace=None, cell="paper.separate.b1x6s"):
    return spec.load_module("metrics", name).read(name, trace, _ctx(cell))


@pytest.fixture
def counters(monkeypatch):
    c = dict.fromkeys(graphed._COUNTS, 0)
    monkeypatch.setattr(graphed, "_COUNTS", c)
    return c


def test_the_new_metrics_are_declared_for_their_cells():
    for name in NEW:
        entry = [m for m in spec.benchmark()["per_layer"] if m["name"] == name][0]
        for cell in entry["workloads"]:
            assert name in {m["name"] for m in spec.cell(cell).per_layer}
        assert spec.load_module("metrics", name) is not None


@pytest.mark.parametrize("name", ["host_us.latency", "host_us.stream"])
def test_host_us_is_replay_ns_over_replays(counters, monkeypatch, name):
    monkeypatch.setattr(observability, "spans", lambda: [])
    assert _read(name) is None  # nothing replayed
    counters.update(replays=4, replay_ns=4 * 37_500, eager_calls=1, eager_ns=10 ** 9)
    assert _read(name) == pytest.approx(37.5)


def test_host_us_leaves_out_the_profiled_calls(counters, monkeypatch):
    """Two of six replays ran under the profiler (1,000 us each, one of them
    the capturing call with 600 us of warm-up and capture): the other four
    read 40 us each."""
    ring = [_span("graphed.copy_in", 1, 2, 2, 1, 1), _span("graphed.replay", 2, 3, 3, 1, 1),
            _span("graphed.call", 0, 1_000_000, 1, None, 1),
            _span("graphed.warm_up", 10, 300_010, 5, 4, 4),
            _span("graphed.capture", 300_010, 600_010, 6, 4, 4),
            _span("graphed.replay", 700_000, 700_001, 7, 4, 4),
            _span("graphed.call", 0, 1_000_000, 4, None, 4),
            _span("graphed.call", 0, 9_000_000, 8, None, 8)]  # an eager call
    monkeypatch.setattr(observability, "spans", lambda: ring)
    counters.update(replays=6, replay_ns=4 * 40_000 + 1_000_000 + 400_000)
    assert _read("host_us.latency") == pytest.approx(40.0)
    counters.update(replays=2)  # every replay profiled
    assert _read("host_us.latency") is None


def test_graph_setup_s_is_eager_and_capture_ns(counters):
    counters.update(eager_calls=3, eager_ns=2_000_000_000, replays=9, replay_ns=10 ** 9)
    assert _read("graph_setup_s") is None  # nothing captured
    counters.update(captures=2, capture_ns=500_000_000)
    assert _read("graph_setup_s") == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["host_us.latency", "graph_setup_s"])
def test_a_port_without_the_timed_counters_reads_nothing(monkeypatch, name):
    """The parent commit's counters: counts without their nanoseconds."""
    monkeypatch.setattr(graphed, "counts", lambda: {"captures": 2, "replays": 9,
                                                    "eager_calls": 1, "graphs": 2,
                                                    "pool_bytes": 0})
    assert _read(name) is None


def _span(name, s, e, sid, parent, unit):
    return Span(name, s, e, sid, parent, unit, {})


# Two traced units (bench ranges 0-100 and 200-300 ns) and a unit of
# another session (1000-1100). In unit 1: call 10-90 over copy_in 20-30,
# replay 30-60, clone 70-80.
RING = [_span("graphed.copy_in", 20, 30, 2, 1, 1), _span("graphed.replay", 30, 60, 3, 1, 1),
        _span("graphed.clone", 70, 80, 4, 1, 1), _span("graphed.call", 10, 90, 1, None, 1),
        _span("graphed.call", 210, 290, 5, None, 5),
        _span("graphed.call", 1010, 1090, 6, None, 6)]
GAPS = [(0, 25), (55, 75), (95, 210), (280, 1200)]


def _idle_trace(units=2):
    tr = tracing.Trace([{"M": 1, "T": 1, "passes": 1}] * units, {"k": (1, 1e-9)}, [],
                       (0, 1200), [(0, 100, "bench:request"), (200, 300, "bench:request")],
                       (0.0, []))
    tr._gaps = GAPS
    return tr


def test_program_idle_goes_to_the_innermost_span(monkeypatch, capsys):
    monkeypatch.setattr(observability, "spans", lambda: list(RING))
    # gap 0-25: caller 0-10, call 10-20, copy_in 20-25; gap 55-75: replay
    # 55-60, call 60-70, clone 70-75; gap 95-210: caller 95-100 and 200-210
    # (outside the ranges 100-200 is nobody's); gap 280-1200: call 280-290,
    # caller 290-300, the other session's unit left out. The replay's 5 ns
    # (the graph's launch) are left out of the value and logged.
    port = 10 + 5 + 10 + 5 + 10
    for name in ("program_idle_us.latency", "program_idle_us.stream"):
        assert _read(name, _idle_trace()) == pytest.approx(port / 2 * 1e-3)
    err = capsys.readouterr().err
    assert "graph launches (*.replay, left out) 0.0025 us a unit" in err
    # idle in the ranges 25 + 20 + 15 + 20 ns, 35 of them outside the spans
    assert "left to the caller 0.0175 us a unit" in err
    mod = spec.load_module("metrics", "program_idle_us.latency")
    spans = mod._units_in(RING, [(0, 100), (200, 300)])
    assert {s.span_id for s in spans} == {1, 2, 3, 4, 5}
    got = mod._overlap(GAPS, mod._innermost(spans))
    assert dict(got) == {"graphed.call": 30, "graphed.copy_in": 5, "graphed.replay": 5,
                         "graphed.clone": 5}
    assert dict(mod._self_times(spans)) == {"graphed.call": 30 + 80, "graphed.copy_in": 10,
                                            "graphed.replay": 30, "graphed.clone": 10}


def test_program_idle_leaves_out_the_stream_launch_too(monkeypatch):
    """The stream's spans: `stream.replay` is a graph's launch as well."""
    ring = [s._replace(name=s.name.replace("graphed.call", "stream.push")
                       .replace("graphed.", "stream.")) for s in RING]
    monkeypatch.setattr(observability, "spans", lambda: ring)
    assert _read("program_idle_us.stream", _idle_trace(),
                 "causal.stream.b1x20ms") == pytest.approx(40 / 2 * 1e-3)


def test_program_idle_reads_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(observability, "spans", lambda: [])
    assert _read("program_idle_us.latency", _idle_trace()) is None
    monkeypatch.delattr(observability, "spans")  # a port without the ring
    assert _read("program_idle_us.latency", _idle_trace()) is None


class StandIn:
    """A capture backend on the CPU: the capture keeps the function, a
    replay runs it into the captured outputs."""

    @staticmethod
    def warm_up(fn, inputs):
        return fn(*inputs)

    @staticmethod
    def capture(fn, inputs, pool=None):
        out = fn(*inputs)
        single = isinstance(out, torch.Tensor)

        def replay():
            new = fn(*inputs)
            for o, n in zip((out,) if single else out, (new,) if single else new):
                o.copy_(n)

        return graphed.Program(replay, out, "pool", 0)


@pytest.mark.parametrize("cell,idle", [("paper.separate.b1x6s", "program_idle_us.latency"),
                                       ("causal.stream.b1x20ms", "program_idle_us.stream")])
def test_tiny_cells_report_the_new_metrics_on_the_cpu(cell, idle):
    """On the CPU the port replays nothing (no host_us, no graph_setup_s)
    but records its spans under the profiler."""
    graphed.reset_counts()
    res = harness.run(cell, tiny.SEED, 0.3, True, "cpu", overrides=tiny.overrides(cell))
    assert set(res["metrics"]) & set(NEW) == {idle}
    assert res["metrics"][idle]["value"] >= 0 and res["correct"]


def test_tiny_request_cell_with_replays_reads_every_metric(monkeypatch):
    """With a stand-in capture backend the request cell replays on the CPU:
    host_us.latency and graph_setup_s read the counters, and the spans
    split the traced requests' idle."""
    monkeypatch.setattr(graphed, "backend_for", lambda device: StandIn())
    graphed.reset_counts()
    cell = "paper.separate.b1x6s"
    res = harness.run(cell, tiny.SEED, 0.3, True, "cpu", overrides=tiny.overrides(cell))
    m = res["metrics"]
    assert {"host_us.latency", "graph_setup_s", "program_idle_us.latency"} <= set(m)
    assert m["host_us.latency"]["value"] > 0 and m["graph_setup_s"]["value"] > 0
    assert res["correct"] and graphed.counts()["replays"] > 0
    graphed.reset_counts()
