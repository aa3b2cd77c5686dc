"""The port's spans and the graph layer's timed counters (CPU), and on the
card the spans' clock against the profiler's device records.

The file imports only torch and the port, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

import collections
import gc
import json
import time

import numpy as np
import pytest
import torch

from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
from convtasnet_torch.data.dataset import Batch
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.models import graphed
from convtasnet_torch.models import streaming as ts
from convtasnet_torch.training import optim as to
from convtasnet_torch.training.solver import GraphedStep, Solver, make_train_step
from convtasnet_torch.utils import observability as ob
from convtasnet_torch.utils.observability import MetricLogger, profile_trace, span
from torch_parallel_worker import RecordOnly

torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]
SMALL = dict(N=8, L=4, B=16, H=16, P=3, X=1, R=1, C=2, compute_dtype="float32")
CAUSAL = dict(SMALL, X=3, R=2, norm_type="cLN", causal=True)
COUNTERS = ("captures", "replays", "eager_calls", "over_cap", "capture_ns", "replay_ns",
            "eager_ns")


@pytest.fixture(autouse=True)
def fresh():
    ob.clear()
    graphed.reset_counts()
    yield
    ob.clear()
    graphed.reset_counts()


@pytest.fixture
def record_only(monkeypatch):
    backend = RecordOnly()
    monkeypatch.setattr(graphed, "backend_for", lambda device: backend)
    return backend


def _by_name(spans):
    return {s.name: s for s in spans}


def _annotations(prof):
    """{name: (start_ns, end_ns)} of the session's user annotations."""
    return {e.name(): (e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}


def test_no_session_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with no profiler session")

    monkeypatch.setattr(ob.time, "time_ns", no_clock)
    with span("a", k=1) as a:
        a.set("path", "replay")
        with span("b") as b:
            pass
    assert a is b  # the one shared no-op
    assert ob.spans() == []


def test_nested_spans_carry_parent_and_unit_ids():
    with torch.profiler.profile(activities=CPU):
        with span("unit", k=1) as u:
            with span("child") as c:
                c.set("path", "replay")
                with span("grandchild"):
                    pass
            with span("sibling"):
                pass
        with span("next"):
            pass
    got = ob.spans()
    assert [s.name for s in got] == ["grandchild", "child", "sibling", "unit", "next"]
    s = _by_name(got)
    assert s["unit"].parent_id is None and s["unit"].unit_id == s["unit"].span_id
    assert s["unit"].attrs == {"k": 1} and s["child"].attrs == {"path": "replay"}
    assert s["child"].parent_id == s["sibling"].parent_id == s["unit"].span_id
    assert s["grandchild"].parent_id == s["child"].span_id
    assert {s[n].unit_id for n in ("unit", "child", "grandchild", "sibling")} == {u.id}
    assert s["next"].parent_id is None and s["next"].unit_id == s["next"].span_id != u.id
    for n in ("child", "grandchild", "sibling"):
        p = [x for x in got if x.span_id == s[n].parent_id][0]
        assert p.start_ns <= s[n].start_ns <= s[n].end_ns <= p.end_ns
    with span("after"):
        pass
    assert len(ob.spans()) == 5  # the session has ended


def test_the_ring_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(ob, "_RING", collections.deque(maxlen=4))
    with torch.profiler.profile(activities=CPU):
        for i in range(10):
            with span(f"s{i}"):
                pass
    assert [s.name for s in ob.spans()] == ["s6", "s7", "s8", "s9"]
    ob.clear()
    assert ob.spans() == []
    assert ob.RING == 65536 and isinstance(ob._RING, collections.deque)


def test_a_span_falls_between_the_annotations_around_it():
    """time.time_ns() is the clock of the profiler's records: each span
    starts after the annotation opened just outside it and before the one
    opened just inside it, and ends in the same order."""
    n = 20
    with torch.profiler.profile(activities=CPU) as prof:
        for i in range(n):
            with torch.profiler.record_function(f"outer{i}"):
                with span("port", i=i):
                    with torch.profiler.record_function(f"inner{i}"):
                        torch.ones(8) + 1
    ann = _annotations(prof)
    got = ob.spans()
    assert len(got) == n
    for s in got:
        i = s.attrs["i"]
        (o0, o1), (i0, i1) = ann[f"outer{i}"], ann[f"inner{i}"]
        assert o0 <= s.start_ns <= i0 and i1 <= s.end_ns <= o1, (i, o0, s, i0, i1, o1)


def _double(x):
    return x * 2


PATHS = {"eager": 1, "capture": 2, "replay": 3}  # the call that takes each path


@pytest.mark.parametrize("path", list(PATHS))
def test_graphed_forward_paths_give_spans_and_counters(record_only, path):
    g = graphed.GraphedForward(_double)
    x = torch.arange(4.0)
    for _ in range(PATHS[path] - 1):
        g(x)
    before = graphed.counts()
    ob.clear()
    with torch.profiler.profile(activities=CPU):
        torch.testing.assert_close(g(x), 2 * x, rtol=0, atol=0)
    c = graphed.counts()
    got = ob.spans()
    root = _by_name(got)["graphed.call"]
    assert root.parent_id is None and root.attrs == {"path": path}
    assert all(s.unit_id == root.span_id for s in got)
    children = {s.name for s in got if s.parent_id == root.span_id}
    moved = {k for k in COUNTERS if c[k] != before[k]}
    if path == "eager":
        assert children == {"graphed.eager"}
        assert moved == {"eager_calls", "eager_ns"}
    elif path == "capture":
        assert children == {"graphed.warm_up", "graphed.capture", "graphed.copy_in",
                            "graphed.replay", "graphed.clone"}
        assert moved == {"captures", "capture_ns", "replays", "replay_ns"}
    else:
        assert children == {"graphed.copy_in", "graphed.replay", "graphed.clone"}
        assert moved == {"replays", "replay_ns"}
    for k in ("captures", "replays", "eager_calls"):
        assert c[k] - before[k] == int(k in moved)
    assert c["over_cap"] == 0
    assert all(c[k] > before[k] for k in moved if k.endswith("_ns"))
    assert g.calls == {"eager": dict(captures=0, replays=0, eager_calls=1, over_cap=0),
                       "capture": dict(captures=1, replays=1, eager_calls=1, over_cap=0),
                       "replay": dict(captures=1, replays=2, eager_calls=1, over_cap=0)}[path]


def test_keys_past_the_cap_count_over_cap(record_only, monkeypatch):
    monkeypatch.setattr(graphed, "MAX_GRAPHS", 1)
    g = graphed.GraphedForward(_double)
    for n in (2, 2, 3, 3, 3, 4, 4):
        g(torch.ones(n))
    c = graphed.counts()
    assert (c["captures"], c["over_cap"], c["eager_calls"], c["replays"]) == (1, 2, 6, 1)
    assert g.stats()["over_cap"] == 2  # the Solver's Graphs line prints stats()
    assert c["eager_ns"] > 0 and c["capture_ns"] > 0 and c["replay_ns"] > 0
    graphed.reset_counts()
    assert graphed.counts()["over_cap"] == graphed.counts()["eager_ns"] == 0


def test_graphed_step_spans_nest_the_graphed_spans(record_only):
    cfg = ConvTasNetConfig(**SMALL)
    params, state = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = to.Optimizer("adam", lr=1e-3)
    o = opt.init(params)
    step = GraphedStep(make_train_step(cfg, opt, 5.0), params, o, state)
    rng = np.random.default_rng(0)
    src = torch.from_numpy((rng.normal(size=(2, 2, 320)) * 0.3).astype(np.float32))
    mix, lens = src.sum(1), torch.tensor([320, 300], dtype=torch.int32)
    p, o, s = params, o, state
    for _ in range(2):
        p, o, s, _, _ = step(p, o, s, mix, src, lens)
    fresh = to.tree_map(lambda t: t.clone(), p)  # not the static trees: copied in
    ob.clear()
    with torch.profiler.profile(activities=CPU):
        step(fresh, o, s, mix, src, lens)
    got = ob.spans()
    root = _by_name(got)["step.call"]
    assert root.parent_id is None and all(x.unit_id == root.span_id for x in got)
    kids = {x.name: x for x in got if x.parent_id == root.span_id}
    assert set(kids) == {"step.adopt", "graphed.call"}
    assert kids["graphed.call"].attrs == {"path": "replay"}
    assert kids["step.adopt"].end_ns <= kids["graphed.call"].start_ns
    assert graphed.counts()["replays"] == 1 and graphed.counts()["replay_ns"] > 0


def _separator(**kw):
    cfg = ConvTasNetConfig(**CAUSAL)
    params, _ = tm.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    return ts.StreamingSeparator(cfg, params, batch=1, device="cpu", **kw)


def test_eager_stream_push_gives_its_spans():
    sep = _separator(graph=False)
    x = torch.randn(1, 32, generator=torch.Generator().manual_seed(2))
    with torch.profiler.profile(activities=CPU):
        sep.push(x)
    got = ob.spans()
    root = _by_name(got)["stream.push"]
    assert root.parent_id is None
    assert [s.name for s in got if s.parent_id == root.span_id] == ["stream.copy_in",
                                                                    "stream.eager"]
    assert graphed.counts()["replays"] == graphed.counts()["captures"] == 0


def test_stream_replays_count_one_per_push(record_only):
    """With the capture stood in on the CPU, a graphed separator runs each
    push as one call of the graph layer: a key's first push eager, its
    second captured, later ones replayed; every push records its
    `graphed.*` spans under `stream.push`, and the streams are bit for bit
    what the eager separator streams."""
    sep, eager = _separator(), _separator(graph=False)
    assert sep.graphed and not eager.graphed
    x = torch.randn(1, 32 * 4, generator=torch.Generator().manual_seed(3))
    want, got, paths = [], [], []
    with torch.profiler.profile(activities=CPU):
        for _ in range(3):  # three utterances of four chunks
            for k in range(4):
                chunk = x[:, 32 * k:32 * (k + 1)]
                want.append(eager.push(chunk))
                before = graphed.counts()
                got.append(sep.push(chunk))
                after = graphed.counts()
                assert sum(after[c] - before[c] for c in COUNTERS[:3]) == 1
                paths.append(next(c for c in COUNTERS[:3] if after[c] != before[c]))
            want.append(eager.flush())
            got.append(sep.flush())
            eager.reset()
            sep.reset()
    # first chunk (one key) and steady chunks (another): eager, capture, replays
    assert paths == (["eager_calls", "eager_calls", "captures", "replays"]
                     + ["captures"] + ["replays"] * 3 + ["replays"] * 4)
    assert record_only.captures == 2
    torch.testing.assert_close(torch.cat(got, -1), torch.cat(want, -1), rtol=0, atol=0)
    roots = [s for s in ob.spans() if s.name == "stream.push" and s.unit_id == s.span_id]
    assert len(roots) == 24  # the eager separator's twelve and the graphed one's
    calls = [s for s in ob.spans() if s.name == "graphed.call"]
    assert len(calls) == 12 and {c.parent_id for c in calls} <= {r.span_id for r in roots}
    assert [c.attrs["path"] for c in calls] == ["eager", "eager", "capture", "replay",
                                                "capture"] + ["replay"] * 7
    kids = collections.Counter(s.name for s in ob.spans()
                               if s.parent_id in {c.span_id for c in calls})
    assert kids == {"graphed.eager": 2, "graphed.warm_up": 2, "graphed.capture": 2,
                    "graphed.copy_in": 8, "graphed.replay": 8, "graphed.clone": 8}


def test_profile_trace_writes_the_port_spans(tmp_path):
    with profile_trace(str(tmp_path)):
        for i in range(3):
            with span("port.outer", i=i):
                with span("port.inner"):
                    with torch.profiler.record_function(f"inside{i}"):
                        torch.ones(8) + 1
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("pid") == ob.TRACK]
    names = [e["args"]["name"] for e in mine if e["ph"] == "M"]
    assert names == [ob.TRACK]
    outer = sorted((e for e in mine if e["name"] == "port.outer"), key=lambda e: e["ts"])
    inner = sorted((e for e in mine if e["name"] == "port.inner"), key=lambda e: e["ts"])
    assert [e["args"]["i"] for e in outer] == ["0", "1", "2"] and len(inner) == 3
    for i, (o, n) in enumerate(zip(outer, inner)):
        assert n["args"]["parent_id"] == o["args"]["span_id"] == n["args"]["unit_id"]
        ann = [e for e in events if e.get("name") == f"inside{i}" and e.get("ph") == "X"][0]
        # on the trace's own timebase: the span encloses the annotation it opened
        assert o["ts"] <= n["ts"] <= ann["ts"]
        assert ann["ts"] + ann["dur"] <= n["ts"] + n["dur"] <= o["ts"] + o["dur"]


class _SlowData:
    """Three batches, each taking `delay` seconds to load."""

    def __init__(self, delay):
        self.delay = delay
        rng = np.random.default_rng(4)
        src = (rng.normal(size=(2, 2, 320)) * 0.3).astype(np.float32)
        self.batch = (src.sum(1), np.array([320, 320], np.int32), src)

    def __len__(self):
        return 3

    def load_batch(self, i):
        time.sleep(self.delay)
        return Batch(*self.batch)


def test_solver_writes_its_data_wait(tmp_path):
    from convtasnet_torch.data.dataset import DataLoader

    delay = 0.05
    model = tm.ConvTasNet(ConvTasNetConfig(use_kernels="0", **SMALL), device="cpu")
    lines = []
    logger = MetricLogger(str(tmp_path))
    solver = Solver(model, TrainConfig(save_folder=str(tmp_path), epochs=1, print_freq=100),
                    DataLoader(_SlowData(delay), num_workers=1, prefetch=1),
                    DataLoader(_SlowData(0.0), num_workers=1),
                    log=lines.append, metric_logger=logger)
    solver.train()
    logger.close()
    with open(tmp_path / "history.jsonl") as f:
        row = json.loads(f.readline())
    # the first batch alone keeps the loop waiting `delay`
    assert delay <= row["data_wait_s"] and 0 < row["data_wait_share"] <= 1
    summary = [x for x in lines if x.startswith("Train Summary")][0]
    assert f"data wait {row['data_wait_s']:.3f}s" in summary


def _sleep_spans(warm, n):
    """warm + n spans, each around a torch.cuda._sleep launch and its
    stream's synchronise, under a profiler of host and card activity;
    returns the session's kineto events and the spans, in order. The
    collector stays off while the spans run: its pauses are the
    interpreter's, not the clock's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device records come from the card")
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(1000)
    stream.synchronize()
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    ob.clear()
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(warm + n):
                with span("clock.sleep", i=i):
                    torch.cuda._sleep(200_000)
                    stream.synchronize()
    finally:
        gc.enable()
    got = sorted((s.start_ns, s.end_ns) for s in ob.spans() if s.name == "clock.sleep")
    assert len(got) == warm + n
    return list(prof.profiler.kineto_results.events()), got


def _edges_ok(edges):
    """Every edge at least 0; every edge within 10 us but for at most one,
    which lies within 100 us (a shared host's scheduling can delay one)."""
    print("span edges, us (start, end):", [(b / 1e3, a / 1e3) for b, a in edges])
    flat = [e for pair in edges for e in pair]
    assert min(flat) >= 0, edges
    assert len([e for e in flat if e > 10_000]) <= 1 and max(flat) < 100_000, edges


def test_span_encloses_the_kernel_it_launches_on_the_card():
    """A span around a torch.cuda._sleep launch and its synchronise holds
    that kernel's device record every time, and after 10 warm-ups each of
    its 40 edges (20 spans) lies within 10 us of the record's, but for at
    most one, which lies within 100 us."""
    warm, n = 10, 20
    events, got = _sleep_spans(warm, n)
    kernels = sorted((e.start_ns(), e.end_ns()) for e in events
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and "spin_kernel" in e.name())
    assert len(kernels) == warm + n
    _edges_ok([(k0 - s0, s1 - k1) for (s0, s1), (k0, k1) in zip(got, kernels)][warm:])


def test_span_encloses_its_launch_and_wait_records_on_the_card():
    """The same spans against the profiler's host records of the CUDA
    runtime calls they make: each span begins before its cudaLaunchKernel
    record and ends after its cudaStreamSynchronize record, each edge
    within 10 us but for at most one (within 100 us). The spans share the
    clock of the profiler's host records."""
    warm, n = 10, 20
    events, got = _sleep_spans(warm, n)

    def host(name):
        return sorted((e.start_ns(), e.end_ns()) for e in events
                      if e.device_type() != torch.autograd.DeviceType.CUDA and e.name() == name)

    launches, waits = host("cudaLaunchKernel"), host("cudaStreamSynchronize")
    edges = []
    for s0, s1 in got[warm:]:
        (l0, _), = [r for r in launches if s0 <= r[0] <= s1] or [(s0 - 1, 0)]
        (_, w1), = [r for r in waits if s0 <= r[0] <= s1] or [(0, s1 + 1)]
        edges.append((l0 - s0, s1 - w1))
    _edges_ok(edges)
