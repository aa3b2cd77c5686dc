"""Programs captured once per input shape as CUDA graphs.

Counterpart of `jax.jit` on the JAX package's inference functions
(convtasnet_tpu/cli/separate.py `infer`, cli/evaluate.py `infer`) and of
its buffer-donating train step (convtasnet_tpu/training/solver.py
`make_train_step`): XLA compiles each once per input shape and then
launches the program whole. `GraphedForward` wraps a function of device
tensors the same way:

* key: the inputs' shapes, dtypes and devices, plus the caller's `tag` of
  the run-time choices that change the program (the kernel form, cal_sdr);
* 1st call of a key: eager. It is also the warm-up a capture needs: the
  kernels' build at first use, their occupancy caches and function
  attributes, cuBLAS and cuFFT handles and plans;
* 2nd call: the inputs are copied into static buffers (allocated outside
  any capture), the function runs once on a side stream, is captured
  under torch.cuda.graph into the memory pool that all of the wrapper's
  graphs share, and the graph is replayed;
* later calls: the inputs are copied into the static buffers, the graph is
  replayed.

A `stateful` function (the train step, training/solver.GraphedStep)
updates tensors it closes over in place, so it must run exactly once per
call: on its capturing call the side-stream warm-up is that call's run,
the capture only records, and the call returns the warm-up's outputs
without a replay. A function whose warm-up ran a collective (a mesh's CV
step: parallel/comm.py counts them) is treated the same way: each call
runs each collective once on every rank, so a rank that captures and a
rank that replays in the same call stay in step.

A replay returns clones of the static outputs, so the next replay never
overwrites what a caller still holds (both CLIs keep one batch in flight).
That also makes the shared pool safe: replays run one at a time on one
stream, and a graph's memory is read only by its own replay and the
clones right after it, so the pool holds the largest key's activations,
not the sum over keys.
At most MAX_GRAPHS keys are captured per wrapper; a key seen a
second time beyond that runs eagerly for good and nothing is evicted, so a
cycle of more shapes than the cap costs what eager costs. A capture or
replay that fails raises GraphError naming the key, and the key is never
captured again; nothing retries eagerly. On the CPU every call runs
eagerly: graphs are a CUDA mechanism.

The layer counts its work on the host, always: `counts()` gives the
captures, replays and eager calls, each with the host nanoseconds of its
calls (`capture_ns`: the warm-up and the capture; `replay_ns` and
`eager_ns`: entry to return of the call), and `over_cap`, the keys sent
eager for good past MAX_GRAPHS. models/streaming.StreamingSeparator
counts its captures and replays here too (`count`). While a
torch.profiler session is active each call also records its spans
(utils/observability.span): `graphed.call` (attribute `path`: replay,
capture or eager) over `graphed.copy_in`, `graphed.replay` (the launch
and the launch counters' bookkeeping) and `graphed.clone`, or
`graphed.warm_up` and `graphed.capture`, or `graphed.eager`.

The kernel wrappers count their launches, and parallel/comm.py its
collectives, on the host, which a replay never reaches. What is counted
while a key is captured (recorded, not executed) is taken off the
counters again and added back on every replay, so `tcn_block.counts()`
and `comm.counts()` keep counting executions: the side-stream warm-up's,
the eager calls' and each replay's.

A process that holds CUDA graphs keeps CUPTI attached between
torch.profiler sessions (`keep_cupti`), PyTorch's own remedy for graphs
under the profiler: tearing CUPTI down after each session and starting it
again can leave every later session of the process without device time.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.kernels import tcn_block, tcn_block_bwd
from ..parallel import comm
from ..utils.observability import span

# Graphs kept per wrapper, read at each new key. Its graphs share one pool,
# which grows to the largest key's activations plus every key's static
# outputs; each key also keeps static copies of its inputs. chip_smoke.py's
# graph phase measured (H100 80GB HBM3, 700 W) 0.04-0.30 GB of pool for a
# paper-config key alone (batch 1 and 8 x 4 s) and 0.25-0.33 GB for a
# scaled-config key (batch 1 and 2 x 8 s at 16 kHz). What the cap bounds is
# the static tensors: at batch 8 x 30 s of 8 kHz, 23 MB of mixture and
# estimates per separate key (46 MB with evaluate's sources and reordered
# estimates), so 16 keys hold under 0.8 GB beside the one pool.
MAX_GRAPHS = 16

# Runs on a side stream before a capture (torch.cuda.graph's warm-up rule;
# the key's eager first call has already done the one-time set-up). A
# stateful function's warm-up is its capturing call's one run.
CAPTURE_WARMUP = 1

_COUNTS = {"captures": 0, "replays": 0, "eager_calls": 0, "over_cap": 0,
           "capture_ns": 0, "replay_ns": 0, "eager_ns": 0}
_NS = {"captures": "capture_ns", "replays": "replay_ns", "eager_calls": "eager_ns"}
_LIVE: "weakref.WeakSet[GraphedForward]" = weakref.WeakSet()


class GraphError(RuntimeError):
    """A capture or replay failed; the message names the key."""


class Program(NamedTuple):
    """A captured function: replay() reruns it on the current stream,
    writing `outputs` (tensors) in place. `pool` is the memory pool it was
    captured into, passed to the wrapper's next capture; `pool_bytes` what
    this capture added to it."""

    replay: Callable[[], None]
    outputs: object
    pool: object
    pool_bytes: int


def count(what: str, since: int) -> int:
    """One more of `what` (captures, replays, eager_calls) in the layer's
    counters, with the host nanoseconds since `since` (a
    time.perf_counter_ns() reading); returns those nanoseconds."""
    ns = time.perf_counter_ns() - since
    _COUNTS[what] += 1
    _COUNTS[_NS[what]] += ns
    return ns


def keep_cupti() -> None:
    """Keep CUPTI attached from one torch.profiler session to the next.
    torch.profiler sets the same two variables itself when torch.compile
    captures graphs, with the comment that CUPTI's teardown and re-init
    break under CUDA graphs; it does not know of graphs captured by hand.
    A value the caller set stays."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")


class CudaGraphs:
    """The capture backend of a CUDA device."""

    @staticmethod
    def warm_up(fn: Callable, inputs: Sequence[torch.Tensor]):
        """fn's outputs (of its last warm-up run)."""
        dev = inputs[0].device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                out = fn(*inputs)
        current.wait_stream(side)
        return out

    @staticmethod
    def capture(fn: Callable, inputs: Sequence[torch.Tensor], pool=None) -> Program:
        """Capture into `pool` (None: a new one)."""
        keep_cupti()
        dev = inputs[0].device
        graph = torch.cuda.CUDAGraph()
        # An NCCL group's watchdog thread queries its collectives' events
        # while this thread captures; under the default "global" mode such
        # a call from any thread breaks the capture ("operation not
        # permitted when stream is capturing"). "thread_local" holds only
        # this thread to the capture rules.
        nccl = dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl"
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local" if nccl else "global"):
            # After the context's empty_cache: what is reserved from here on
            # is added to the pool.
            before = torch.cuda.memory_reserved(dev)
            out = fn(*inputs)
        return Program(graph.replay, out, graph.pool(),
                       torch.cuda.memory_reserved(dev) - before)


def backend_for(device: torch.device):
    """The capture backend of `device`: CUDA graphs on a card, None (every
    call eager) on the CPU."""
    return CudaGraphs() if device.type == "cuda" else None


def _launches() -> Dict[str, int]:
    """The kernel launch counters and the collective counter."""
    return {**tcn_block.counts(), **tcn_block_bwd.counts(), **comm.counts()}


def _add_launches(delta: Dict[str, int]) -> None:
    tcn_block.add_counts(delta)
    tcn_block_bwd.add_counts(delta)
    comm.add_counts(delta)


class _Graph(NamedTuple):
    program: Program
    inputs: Tuple[torch.Tensor, ...]
    single: bool                   # the function returned one tensor
    launches: Dict[str, int]       # kernel launches and collectives per replay
    capture_ms: float


_SEEN = object()     # one eager call so far
_EAGER = object()    # beyond the cap: eager for good


def _clones(outs: Sequence[torch.Tensor], single: bool):
    """Clones of a function's outputs, as it returned them (`single`: one
    tensor)."""
    copies = tuple(o.clone() for o in outs)
    return copies[0] if single else copies


class GraphedForward:
    """fn(*tensors) -> tensor or tuple of tensors, captured per key as
    described in the module docstring. `tag` joins every key; `stateful`
    says that fn updates state in place and must run once per call."""

    def __init__(self, fn: Callable, tag: Tuple = (), stateful: bool = False):
        self.fn = fn
        self.tag = tuple(tag)
        self.stateful = stateful
        # this wrapper's share of _COUNTS' counts (not of their ns)
        self.calls = dict.fromkeys((*_NS, "over_cap"), 0)
        self._state: Dict[tuple, object] = {}
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None  # the pool of the first capture, shared by the rest
        _LIVE.add(self)

    def _count(self, what: str, since: int) -> int:
        self.calls[what] += 1
        return count(what, since)

    def key(self, inputs: Sequence[torch.Tensor]) -> tuple:
        return tuple((tuple(t.shape), t.dtype, t.device) for t in inputs) + self.tag

    def __call__(self, *inputs: torch.Tensor):
        t0 = time.perf_counter_ns()
        with span("graphed.call") as sp:
            if not inputs or not all(isinstance(t, torch.Tensor) for t in inputs):
                raise TypeError("GraphedForward takes tensors only")
            backend = backend_for(inputs[0].device)
            key = self.key(inputs)
            state = self._state.get(key)
            if isinstance(state, _Graph):
                sp.set("path", "replay")
                return self._replay(key, state, inputs, t0)
            if isinstance(state, GraphError):
                raise GraphError(f"key {key} failed before: {state}")
            if backend is not None and state is _SEEN:
                if len(self._graphs) < MAX_GRAPHS:
                    sp.set("path", "capture")
                    return self._capture(key, backend, inputs)
                self._state[key] = _EAGER
                _COUNTS["over_cap"] += 1
                self.calls["over_cap"] += 1
            elif backend is not None and state is None:
                self._state[key] = _SEEN
            sp.set("path", "eager")
            with span("graphed.eager"):
                out = self.fn(*inputs)
            self._count("eager_calls", t0)
            return out

    def _capture(self, key, backend, inputs):
        static = tuple(t.clone() for t in inputs)
        t0 = time.perf_counter_ns()
        try:
            ran = comm.counts()["collectives"]
            with span("graphed.warm_up"):
                warm = backend.warm_up(self.fn, static)
            once = self.stateful or comm.counts()["collectives"] != ran
            before = _launches()
            with span("graphed.capture"):
                program = backend.capture(self.fn, static, self._pool)
        except Exception as e:
            err = GraphError(f"capture of key {key} failed: {type(e).__name__}: {e}")
            self._state[key] = err
            raise err from e
        capture_ms = self._count("captures", t0) * 1e-6
        launches = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        _add_launches({k: -v for k, v in launches.items()})  # recorded, not run
        single = isinstance(program.outputs, torch.Tensor)
        outs = (program.outputs,) if single else tuple(program.outputs)
        graph = _Graph(program._replace(outputs=outs), static, single, launches, capture_ms)
        self._state[key] = self._graphs[key] = graph
        self._pool = program.pool
        if once:  # the warm-up was this call's run; the capture only recorded
            return _clones((warm,) if single else warm, single)
        return self._replay(key, graph, inputs, time.perf_counter_ns())

    def _replay(self, key, graph: _Graph, inputs, since: int):
        try:
            with span("graphed.copy_in"):
                for dst, src in zip(graph.inputs, inputs):
                    dst.copy_(src)
            with span("graphed.replay"):
                graph.program.replay()
                _add_launches(graph.launches)
        except Exception as e:
            raise GraphError(f"replay of key {key} failed: {type(e).__name__}: {e}") from e
        with span("graphed.clone"):
            out = _clones(graph.program.outputs, graph.single)
        self._count("replays", since)
        return out

    def graphs(self) -> Dict[tuple, dict]:
        """Per captured key: capture_ms (host time of the warm-up and the
        capture), pool_bytes (what its capture added to the shared pool)
        and the kernel launches and collectives per replay."""
        return {k: {"capture_ms": g.capture_ms, "pool_bytes": g.program.pool_bytes,
                    "launches": dict(g.launches)} for k, g in self._graphs.items()}

    def stats(self) -> dict:
        """This wrapper's captures, replays, eager_calls and over_cap, the
        keys it has seen, its graphs and the bytes of its pool."""
        return {**self.calls, "keys": len(self._state), "graphs": len(self._graphs),
                "pool_bytes": sum(g.program.pool_bytes for g in self._graphs.values())}


def graph_row(fn: Optional[GraphedForward]) -> dict:
    """The keys a measuring tool's row carries for `fn` (None: no wrapper):
    whether a graph was captured, and the capture ms and pool bytes of its
    graphs (the tools time one key)."""
    graphs = list(fn.graphs().values()) if fn is not None else []
    return {"graphed": bool(graphs),
            "capture_ms": sum(g["capture_ms"] for g in graphs) if graphs else None,
            "pool_bytes": sum(g["pool_bytes"] for g in graphs) if graphs else None}


def counts() -> dict:
    """captures, replays, eager_calls, over_cap and the host ns of the
    first three (module docstring) since reset_counts(), the streaming
    separator's included; graphs and pool_bytes held now by the live
    GraphedForward wrappers only (a StreamingSeparator's two graphs and
    their pool are not among them)."""
    live = [g for f in list(_LIVE) for g in f._graphs.values()]
    return {**_COUNTS, "graphs": len(live),
            "pool_bytes": sum(g.program.pool_bytes for g in live)}


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0
