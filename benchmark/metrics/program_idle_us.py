"""program_idle_us.*: microseconds per traced unit during which the device
sat idle while the host was inside one of the port's own spans
(convtasnet_torch/utils/observability.span, recorded while the profiler
runs, on the clock of its records), other than a graph's launch.

Each idle gap of the accepted profiler session (the trace's gaps between
the union of its device records, in the profiler's ns) goes, instant by
instant, to the innermost port span open then. The spans are those of
the port's ring whose unit (its outermost span) began inside one of that
session's bench:* ranges, so the other sessions' spans are left out.

The idle inside `*.replay` spans (`graphed.replay`, `stream.replay`) is
left out of the value: under the profiler a graph's launch holds the host
some microseconds per node (CUPTI's work), so that idle is the profiler's
and not the untraced path's. The value is the idle inside the copies in,
the clones and the calls' own code, which the untraced path shares. The
reader logs per span name its self time and its idle per unit, the idle
it left out, and the idle left to the caller: inside the bench:* ranges,
outside every port span. Nothing to read where the port records no spans.
"""

import bisect
import collections

from benchmark import harness

LAUNCH = ".replay"  # a graph's launch: the profiler's cost (module docstring)


def read(name, trace, ctx):
    from convtasnet_torch.utils import observability

    ring = getattr(observability, "spans", None)
    if ring is None or not trace.units:
        return None
    bench = sorted((s, e) for s, e, _ in trace._spans)
    spans = _units_in(ring(), bench)
    if not spans:
        return None
    idle = _overlap(trace._gaps, _innermost(spans))
    n = len(trace.units)
    port = sum(v for k, v in idle.items() if k is not None)
    launch = sum(v for k, v in idle.items() if k is not None and k.endswith(LAUNCH))
    caller = sum(_overlap(trace._gaps, [(s, e, None) for s, e in bench]).values()) - port
    self_ns = _self_times(spans)
    for key in sorted(self_ns, key=lambda k: -self_ns[k]):
        harness.log(f"{name}: {key} self {self_ns[key] / n * 1e-3:.4g} us, "
                    f"device idle {idle.get(key, 0) / n * 1e-3:.4g} us a unit")
    harness.log(f"{name}: device idle inside the graph launches (*{LAUNCH}, left out) "
                f"{launch / n * 1e-3:.4g} us a unit")
    harness.log(f"{name}: device idle left to the caller {caller / n * 1e-3:.4g} us a unit")
    return (port - launch) / n * 1e-3


def _units_in(spans, bench):
    """The spans whose unit's outermost span began inside a bench range."""
    starts = [s for s, _ in bench]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= bench[i][1]

    units = {s.unit_id for s in spans if s.parent_id is None and inside(s.start_ns)}
    return [s for s in spans if s.unit_id in units]


def _innermost(spans):
    """[(start, end, name)]: the innermost open span over each stretch of
    the spans' time, in order (spans on one thread nest, so the innermost
    open span is the one that opened last)."""
    events = sorted([(s.start_ns, 1, k) for k, s in enumerate(spans)]
                    + [(s.end_ns, 0, k) for k, s in enumerate(spans)])
    open_, out, at = set(), [], None
    for t, starts, k in events:
        if open_ and t > at:
            top = max(open_, key=lambda j: (spans[j].start_ns, j))
            out.append((at, t, spans[top].name))
        (open_.add if starts else open_.discard)(k)
        at = t
    return out


def _overlap(gaps, stretches):
    """{name: ns} of the gaps' time inside each named stretch; both lists
    sorted and each free of overlaps."""
    got = collections.defaultdict(int)
    j = 0
    for g0, g1 in gaps:
        while j < len(stretches) and stretches[j][1] <= g0:
            j += 1
        k = j
        while k < len(stretches) and stretches[k][0] < g1:
            s0, s1, name = stretches[k]
            got[name] += max(0, min(g1, s1) - max(g0, s0))
            k += 1
    return got


def _self_times(spans):
    """{name: ns} of each span's time outside its children."""
    child = collections.defaultdict(int)
    for s in spans:
        if s.parent_id is not None:
            child[s.parent_id] += s.end_ns - s.start_ns
    out = collections.defaultdict(int)
    for s in spans:
        out[s.name] += s.end_ns - s.start_ns - child[s.span_id]
    return out
