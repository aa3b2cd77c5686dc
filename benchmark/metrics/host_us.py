"""host_us.*: host microseconds per replay in the port's graph layer, from
entry to return of the call that replayed (models/graphed.GraphedForward
in the request cell, models/streaming.StreamingSeparator.push in the
stream cell), over the run's calls that no profiler watched: the layer's
always-on counters, replay_ns / replays, less the calls the port recorded
as spans. A span is recorded exactly while a profiler session runs, and
a profiled call costs the host many times an untraced one (CUPTI's work
at each graph launch): one `graphed.replay` or `stream.replay` span per
profiled replay, its parent the whole call, of which a capture's own
spans were counted apart. Nothing to read where the port keeps no such
counter or replayed nothing (the CPU)."""

REPLAY = ("graphed.replay", "stream.replay")
CAPTURE = ("graphed.warm_up", "graphed.capture", "stream.capture")


def read(name, trace, ctx):
    from convtasnet_torch.models import graphed
    from convtasnet_torch.utils import observability

    c = graphed.counts()
    if "replay_ns" not in c:
        return None
    spans = observability.spans()
    by_id = {s.span_id: s for s in spans}
    calls = [by_id[s.parent_id] for s in spans if s.name in REPLAY and s.parent_id in by_id]
    ids = {s.span_id for s in calls}
    ns = sum(s.end_ns - s.start_ns for s in calls)
    ns -= sum(s.end_ns - s.start_ns for s in spans if s.name in CAPTURE and s.parent_id in ids)
    n = c["replays"] - len(calls)
    if n <= 0:
        return None
    return (c["replay_ns"] - ns) / n * 1e-3
