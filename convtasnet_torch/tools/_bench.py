"""Shared pieces of the port's measuring tools (bench_*.py, time_*.py,
profile_forward.py, chip_smoke.py): timing on the tool's device; the one
kernel timer, device time from torch.profiler whose records are counted
before they are summed, warm or with cold L2; the device's name, the
H100's matmul peak and the analytic matmul work of a forward."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ConvTasNetConfig
from ..data.synthetic import synthetic_batch

# The small f32 config of the tools' --tiny runs (CPU tests).
TINY = dict(N=16, L=8, B=32, H=64, P=3, X=3, R=2, C=2, compute_dtype="float32")

# NVIDIA H100 SXM data sheet, dense bf16 tensor-core peak at 700 W: the
# floor of a bf16 matmul's time on the card. A card set below 700 W
# (nvidia-smi power.limit) runs below it.
H100_BF16_FLOPS = 989e12
H100_PEAK_NAME = "H100 SXM dense bf16, 989 TFLOP/s at 700 W"


def device_name(dev: torch.device) -> str:
    """The name a result row carries: the card's, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def timed_ms(fn: Callable[[], object], iters: int, warm: int, dev: torch.device) -> float:
    """Mean ms per call of `iters` back-to-back calls after `warm`: CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# The kernel timer
# ---------------------------------------------------------------------------

# {kernel name: (records, device us)}: what one profile holds per name.
Records = Dict[str, Tuple[int, float]]

# The port's kernels all live in this C++ namespace (csrc/), so their
# records carry it; no library kernel does.
PORT_KERNEL = "tcn::"
# torch.cuda._sleep's kernel. Launched before and after the calls of a
# profile, so that the records a session loses at its start fall on them:
# on the H100 a process that has run for a while loses the first few
# records of each torch.profiler session, more the longer it has run.
# Its records are left out.
FILLER = "spin_kernel"
# Filler launches on each side of the calls, by try.
FILLS = (64, 512, 4096)

# Calls timed with CUDA events because no profile's records were complete
# (the summary line's "profiler_blind").
PROFILER_BLIND: List[str] = []

# The H100 SXM's L2 (data sheet). A cold launch reads inputs that are not
# in it: COLD_FACTOR times its bytes of copies are cycled between launches.
H100_L2_BYTES = 50 * 2 ** 20
COLD_FACTOR = 2


def kernel_records(events) -> Records:
    """The device records of torch.profiler's key_averages() `events` by
    name: kernels, copies and sets, the fillers and user annotations (an
    operator's range projected onto the device) left out."""
    import torch.autograd

    out: Records = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation
                or FILLER in e.key):
            continue
        n, us = out.get(e.key, (0, 0.0))
        out[e.key] = (n + e.count, us + e.self_device_time_total)
    return out


def _fill(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def profile_records(fn: Callable[[], object], calls: int, fill: int = 0,
                    cpu: bool = False) -> Records:
    """The device records of `calls` calls of fn under torch.profiler, with
    `fill` filler launches on each side (`cpu`: the CPU activity too)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        _fill(fill)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        _fill(fill)
    return kernel_records(prof.key_averages())


def records_verdict(one: Records, many: Records, iters: int,
                    launched: Optional[int] = None) -> str:
    """Why a profile of `iters` calls (`many`) is not complete, or "" if it
    is. `one` is a profile of one call: it must hold a record, and, where
    the port's counters saw `launched` launches in that call, as many
    records of the port's kernels; `many` must hold, for every name, exactly
    `iters` times the records of `one`, and no other name. A profile that
    recorded nothing is one case of a missing record."""
    got = sum(n for n, _ in one.values())
    if got == 0:
        return "the one-call profile holds no record"
    if launched:
        port = sum(n for k, (n, _) in one.items() if PORT_KERNEL in k)
        if port != launched:
            return f"{port} records of the port's kernels in one call, {launched} launches counted"
    off = sorted(((many.get(k, (0, 0.0))[0] - iters * one.get(k, (0, 0.0))[0], k)
                  for k in set(one) | set(many)), key=lambda d: -abs(d[0]))
    off = [d for d in off if d[0]]
    if off:
        return (f"{sum(n for n, _ in many.values())} records in {iters} calls, "
                f"{iters * got} expected ({got} a call); off by name: "
                + ", ".join(f"{d:+d} {k[:48]}" for d, k in off[:3]))
    return ""


@dataclasses.dataclass
class Timing:
    """Device ms per call; the complete profile's records (None when every
    try fell short and `ms` is CUDA event time); each try's reason."""
    ms: float
    records: Optional[Records]
    why: List[str]

    @property
    def blind(self) -> bool:
        return self.records is None


def port_launches() -> int:
    """Launches of the port's kernels counted so far (the wrappers' and
    the replayed graphs' counters)."""
    from ..ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    return sum(tb.counts().values()) + sum(tbb.counts().values())


def timed(fn: Callable[[], object], iters: int = 20, warm: int = 3, tries: int = 3,
          cpu: bool = False, label: str = "", profile=profile_records,
          counted=port_launches, event_ms=None) -> Timing:
    """Device time per call of fn: a profile of one call gives the records
    per name one call makes (checked against the port's counters), then a
    profile of `iters` calls is taken only if it holds exactly `iters`
    times those records (records_verdict); else both are taken again, up to
    `tries` times, with more filler launches (FILLS). If no try qualifies,
    the time is CUDA event time of `iters` calls, and the call is listed in
    PROFILER_BLIND under `label`. `profile`, `counted` and `event_ms` are
    the profiler, the counters and the event timer (tests pass stand-ins)."""
    for _ in range(warm):
        fn()
    if warm:
        torch.cuda.synchronize()
    why = []
    for t in range(tries):
        fill = FILLS[min(t, len(FILLS) - 1)]
        before = counted()
        one = profile(fn, 1, fill, cpu)
        launched = counted() - before
        many = profile(fn, iters, fill, cpu)
        short = records_verdict(one, many, iters, launched)
        if not short:
            return Timing(sum(us for _, us in many.values()) / 1e3 / iters, many, why)
        why.append(f"{short} ({fill} fillers)")
    PROFILER_BLIND.append(label or getattr(fn, "__qualname__", str(fn)))
    print(f"  torch.profiler fell short for {PROFILER_BLIND[-1]}: " + "; ".join(why)
          + f" (#{len(PROFILER_BLIND)}): CUDA event time instead", flush=True)
    ms = (event_ms or cuda_event_ms)(fn, iters)
    return Timing(ms, None, why)


def device_ms(fn: Callable[[], object], iters: int = 20, warm: int = 3, tries: int = 3,
              label: str = "") -> float:
    """timed(...).ms: device ms per call of fn."""
    return timed(fn, iters, warm, tries, label=label).ms


def cuda_event_ms(fn: Callable[[], object], iters: int) -> float:
    """CUDA-event ms per call of `iters` back-to-back calls (launch gaps
    included)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tree_tensors(obj) -> list:
    """The tensors of a tree of tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tree_tensors(o)]
    return []


def clone_tree(obj):
    """A copy of a tree of tuples (named ones too) and lists whose tensors
    are cloned; other leaves are shared."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[clone_tree(o) for o in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(clone_tree(o) for o in obj)
    return obj


def cold_copies(nbytes: int, l2_bytes: int = H100_L2_BYTES, factor: int = COLD_FACTOR) -> int:
    """How many copies of inputs of `nbytes`, read in turn launch after
    launch, leave no launch an input still in an L2 of `l2_bytes`: n with
    n * nbytes >= factor * l2_bytes."""
    return max(1, -(-factor * l2_bytes // max(1, nbytes)))


def cold_timed(call: Callable, args: tuple, iters: int = 20, warm: int = 3, tries: int = 3,
               label: str = "", copies: Optional[int] = None) -> Timing:
    """Device time per launch of call(*args) with cold L2: launch i reads
    copy i % n of every tensor in `args` (n = cold_copies of their bytes),
    and holds its outputs until launch i + n, so that the allocator cycles
    the write targets over n + 1 sets too. Timed by `timed`, with its
    checks; `iters` is rounded up to a multiple of n."""
    n = copies or cold_copies(sum(t.numel() * t.element_size() for t in tree_tensors(args)))
    sets = [args] + [clone_tree(args) for _ in range(n - 1)]
    ring = [None] * n
    at = [0]

    def step():
        i = at[0] % n
        at[0] += 1
        ring[i] = call(*sets[i])

    return timed(step, -(-iters // n) * n, max(warm, n), tries, label=label)


def device_batch(seed: int, batch: int, C: int, T: int, sample_rate: int, dev):
    """(mixture, lengths, sources) of data/synthetic on `dev`."""
    mix, lens, src = synthetic_batch(np.random.default_rng(seed), batch, C, T, sample_rate)
    return tuple(torch.from_numpy(a).to(dev) for a in (mix, lens, src))


def forward_matmul_flops(cfg: ConvTasNetConfig, M: int, T: int) -> float:
    """Every contraction of the inference forward at 2 * MACs (encoder,
    bottleneck, per block in_w / depthwise taps / out_w, mask, decoder);
    the formula of bench.py's _matmul_flops_forward."""
    K = cfg.num_frames(T)
    NB = cfg.R * cfg.X
    per_frame = (2 * cfg.L * cfg.N + 2 * cfg.N * cfg.B
                 + NB * (4 * cfg.B * cfg.H + 2 * cfg.P * cfg.H)
                 + 2 * cfg.B * cfg.C * cfg.N + 2 * cfg.C * cfg.N * cfg.L)
    return float(M) * K * per_frame
