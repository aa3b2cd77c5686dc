"""Streaming (chunked, stateful) inference for causal Conv-TasNet.

Counterpart of convtasnet_tpu/models/streaming.py. Causality makes true
streaming possible: across fixed-size chunks this module carries

  * the last L - S input samples (frame overlap at the chunk boundary),
  * per temporal block, a ring of the last (P-1)*dilation depthwise input
    frames (the causal conv's receptive tail),
  * the decoder's overlap-add tail (L - S samples),

so feeding a waveform chunk by chunk reproduces the offline forward (up to
float associativity) with per-chunk latency. Requires causal=True and cLN:
gLN normalises over all time and BN over the batch.

`stream_step` runs op by op in the JAX step's rounding points (encode,
decode, pointwise, prelu and cLN are the offline model's). Each TCN block
takes one of two forms (`block_form`, decided from the config before any
launch): "kernel", ops/kernels/stream_block.stream_block, one launch of
the hand-written block kernel (csrc/tcn_stream_block.cu) on a card, which
writes the block's new history into its ring in place, and its plain
version on the CPU; or "library", the same ops one by one
(stream_block_plain) wherever the config takes no kernels or the kernel
does not admit its widths or dtype. On a CUDA device `StreamingSeparator`
runs the step as CUDA graphs, one per (first chunk or not, chunk length)
at its batch: the counterpart of the JAX package's two jitted steps. The
state then lives in static device buffers that the graph updates in place,
and each chunk is copied into a static input buffer before the replay. On
the CPU (or with graph=False) the same step runs eagerly.

The separator's captures and replays count in models/graphed's counters
(`graphed.counts()`: one replay per graphed push, with its host ns from
entry to return of push; a capture's warm-ups and capture under
`capture_ns`). While a torch.profiler session is active a push records
its spans (utils/observability.span): `stream.push` over
`stream.copy_in` (the chunk into the static input, or onto the device
when eager), `stream.replay` and `stream.clone`, or `stream.eager`, and
`stream.capture` at a key's first push. The block kernel's launches count
in `stream_block.launches` (tcn_block.counts()["tcn_stream_block"]), a
graph's added back on each replay: R * X a push.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import torch

from ..config import ConvTasNetConfig
from ..ops.conv import pointwise
from ..ops.kernels.limits import stream_limit
from ..ops.kernels.stream_block import stream_block, stream_block_plain
from ..ops.norms import channelwise_layer_norm
from ..utils.observability import span
from . import graphed
from .conv_tasnet import decode, encode, mask_of, resolve_device

StreamState = Dict[str, Any]

# Runs of the step on a side stream before a capture (cuBLAS handles and
# workspaces, the allocator's blocks), as torch.cuda.graphs asks.
CAPTURE_WARMUP = 2

# Parameter leaves every use of which casts them to the compute dtype; the
# separator casts them once, ahead of any capture (a repeated cast is exact).
_COMPUTE_DTYPE_LEAVES = frozenset({"U", "V", "w", "in_w", "in_prelu", "dw_w", "dw_prelu",
                                   "out_w"})


def _check(cfg: ConvTasNetConfig) -> None:
    if not cfg.causal:
        raise ValueError("streaming requires causal=True")
    if cfg.norm_type != "cLN":
        raise ValueError("streaming requires norm_type='cLN' (gLN needs "
                         "global time statistics; BN uses batch statistics)")
    if not cfg.first_version:
        raise ValueError("streaming runs the first version's design only (Sc=0, a ReLU "
                         "encoder, the cLN input norm): the skip path is not ported there")


def init_stream_state(cfg: ConvTasNetConfig, batch: int = 1, device=None) -> StreamState:
    """Zero history: equivalent to the offline model's implicit zero padding."""
    _check(cfg)
    dev = resolve_device(device)
    tail = cfg.L - cfg.stride
    spans = [(cfg.P - 1) * 2 ** x for x in range(cfg.X)]
    return {
        # Unconsumed input samples (not yet coverable by a full frame).
        "sample_tail": torch.zeros((batch, tail), device=dev),
        # Per (r, x) block: last span frames of the dwconv input, [R] list
        # of [X] lists of [M, span, H].
        "conv_hist": [[torch.zeros((batch, s, cfg.H), dtype=cfg.dtype, device=dev)
                       for s in spans] for _ in range(cfg.R)],
        "ola_tail": torch.zeros((batch, cfg.C, tail), device=dev),
    }


def state_leaves(state: StreamState) -> List[torch.Tensor]:
    """The state's tensors in a fixed order (sample_tail, conv_hist by r
    then x, ola_tail)."""
    return ([state["sample_tail"]] + [h for row in state["conv_hist"] for h in row]
            + [state["ola_tail"]])


def block_form(cfg: ConvTasNetConfig, device) -> str:
    """How stream_step runs each TCN block on `device`: "kernel"
    (stream_block: the hand-written kernel on a card, its plain version on
    the CPU) where the config takes kernels (kernel_form is not "eager")
    and the stream kernel admits its widths and dtype at every dilation,
    else "library" (stream_block_plain). Decided from the config alone, as
    kernel_form is, so it needs no card."""
    if cfg.kernel_form(False, device) == "eager" or stream_limit(
            cfg.B, cfg.H, cfg.P, cfg.X, cfg.compute_dtype == "bfloat16"):
        return "library"
    return "kernel"


def stream_step(params, state: StreamState, cfg: ConvTasNetConfig, chunk: torch.Tensor,
                first: bool = False) -> Tuple[torch.Tensor, StreamState]:
    """Process one chunk: [M, T_chunk] -> ([M, C, K_c*S] samples, new_state).

    T_chunk must be a multiple of the encoder stride S = L//2. `first`
    marks the stream's first chunk, which frames the raw chunk with no
    carried samples (a zero-filled tail would fabricate a leading frame
    the offline forward does not have). The concatenated outputs of all
    chunks plus the final ola_tail match the offline forward sample for
    sample. `state` is read, never written, but by the block kernel on a
    card, which writes each block's new history into its ring in place: the
    new state then holds the same ring tensors."""
    _check(cfg)
    dt, S = cfg.dtype, cfg.stride
    M, Tc = chunk.shape
    if Tc % S != 0:
        raise ValueError(f"chunk length {Tc} must be a multiple of stride {S}")
    buf = chunk if first else torch.cat([state["sample_tail"], chunk], dim=1)
    new_sample_tail = buf[:, buf.shape[1] - (cfg.L - S):].clone()
    w_mix = encode(params, cfg, buf)  # [M, Kc, N], compute dtype

    sp = params["separator"]
    x = channelwise_layer_norm(w_mix, sp["ln"]["gamma"], sp["ln"]["beta"])
    x = pointwise(x, sp["bottleneck"]["w"], dt).to(dt)
    block = stream_block if block_form(cfg, chunk.device) == "kernel" else stream_block_plain
    new_hist = []
    for r in range(cfg.R):
        row = []
        for xi in range(cfg.X):
            bp = {k: v[r, xi] for k, v in sp["blocks"].items()}
            x, h = block(x, state["conv_hist"][r][xi], bp, 2 ** xi, dt)
            row.append(h)
        new_hist.append(row)

    Kc = x.shape[1]
    score = pointwise(x, sp["mask"]["w"], dt).reshape(M, Kc, cfg.C, cfg.N)
    mask = mask_of(score, cfg)
    local = decode(params, cfg, w_mix, mask.to(dt))  # [M, C, Kc*S + (L-S)]
    body = local[..., : Kc * S].clone()
    body[..., : cfg.L - S] += state["ola_tail"]
    new_state = {"sample_tail": new_sample_tail, "conv_hist": new_hist,
                 "ola_tail": local[..., Kc * S:]}
    return body, new_state


def _step_params(params, cfg: ConvTasNetConfig, device: torch.device):
    """The parameters on `device`: the leaves each use casts to the compute
    dtype in it, the norms' affines in f32. A captured graph reads them at
    these fixed addresses."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.to(device, cfg.dtype if k in _COMPUTE_DTYPE_LEAVES else torch.float32)
                for k, v in tree.items()}
    return walk(params)


class StreamingSeparator:
    """Stateful wrapper over stream_step for `batch` concurrent streams.

    push() per chunk, then flush() for the final L-S overlap-add samples;
    the concatenation equals the offline forward on the whole waveform.
    On a CUDA device with graph=True (the default) each chunk step is one
    replay of a CUDA graph, captured at the first push of each (first
    chunk or not, chunk length); a failed capture raises. graph=False, or
    a CPU device, runs the step eagerly."""

    def __init__(self, cfg: ConvTasNetConfig, params, batch: int = 1, device=None,
                 graph: bool = True):
        _check(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _step_params(params, cfg, self.device)
        self._batch = batch
        self.graphed = graph and self.device.type == "cuda"
        self.state = init_stream_state(cfg, batch, self.device)
        # (first, chunk length) -> (graph, static input, static output)
        self._graphs: Dict[Tuple[bool, int], tuple] = {}
        # (first, chunk length) -> the block kernel's launches a replay
        self._launches: Dict[Tuple[bool, int], int] = {}
        self._warm = 0

    def reset(self) -> None:
        """Reinitialise ALL mutable stream state for a fresh utterance (the
        captured graphs are kept: their static state is zeroed in place,
        since a graph reads the buffers it was captured with). Callers use
        this rather than poking .state so that no state is carried across
        utterances."""
        if self.graphed:
            for t in state_leaves(self.state):
                t.zero_()
        else:
            self.state = init_stream_state(self.cfg, self._batch, self.device)
        self._warm = 0

    @torch.no_grad()
    def push(self, chunk: torch.Tensor) -> torch.Tensor:
        """Feed [M, T_chunk] samples (host or device); returns a new tensor
        on the device with the separated samples that became final
        ([M, C, T_chunk - S] for the first chunk, then [M, C, T_chunk])."""
        t0 = time.perf_counter_ns()
        with span("stream.push"):
            if chunk.dim() != 2 or chunk.shape[0] != self._batch:
                raise ValueError(f"chunk of shape {tuple(chunk.shape)}: expected "
                                 f"[{self._batch}, T_chunk]")
            first = self._warm == 0
            if self.graphed:
                key = (first, int(chunk.shape[1]))
                if key not in self._graphs:
                    self._graphs[key] = self._capture(first, tuple(chunk.shape))
                    t0 = time.perf_counter_ns()  # the capture is counted apart
                out = self._replay(self._graphs[key], chunk)
                stream_block.launches += self._launches.get(key, 0)
            else:
                with span("stream.copy_in"):
                    x = chunk.to(self.device, torch.float32, non_blocking=True)
                with span("stream.eager"):
                    out, self.state = stream_step(self.params, self.state, self.cfg, x, first)
            self._warm += 1
        if self.graphed:
            graphed.count("replays", t0)
        return out

    def flush(self) -> torch.Tensor:
        """Emit the final overlap-add tail ([M, C, L - S]) as a new tensor."""
        return self.state["ola_tail"].clone()

    @staticmethod
    def _replay(entry: tuple, chunk: torch.Tensor) -> torch.Tensor:
        graph, static_in, static_out = entry
        with span("stream.copy_in"):
            static_in.copy_(chunk, non_blocking=True)
        with span("stream.replay"):
            graph.replay()
        with span("stream.clone"):
            # The next replay overwrites static_out.
            return static_out.clone()

    def _capture(self, first: bool, shape) -> tuple:
        t0 = time.perf_counter_ns()
        with span("stream.capture"):
            entry = self._record(first, shape)
        graphed.count("captures", t0)
        return entry

    def _record(self, first: bool, shape) -> tuple:
        static_in = torch.zeros(shape, dtype=torch.float32, device=self.device)
        # The warm-ups run on copies of the rings: the block kernel writes
        # its history in place, and the stream's own must not move.
        warm = {**self.state, "conv_hist": [[h.clone() for h in row]
                                            for row in self.state["conv_hist"]]}

        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                stream_step(self.params, warm, self.cfg, static_in, first)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = stream_block.launches
        with torch.cuda.graph(graph):
            out, new_state = stream_step(self.params, self.state, self.cfg, static_in, first)
            for dst, src in zip(state_leaves(self.state), state_leaves(new_state)):
                if src is not dst:  # a ring the kernel updated in place needs no copy
                    dst.copy_(src)
        self._launches[(first, shape[1])] = stream_block.launches - before
        stream_block.launches = before  # recorded, not run
        return graph, static_in, out
