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
runs the step through models/graphed.GraphedForward (stateful), one
wrapper per value of `first` and one CUDA graph per chunk shape at its
batch: the counterpart of the JAX package's two jitted steps. The state
then lives in static device buffers that every call updates in place, and
each chunk is copied into the wrapper's static input before a replay. On
the CPU (or with graph=False) the same step runs eagerly.

The graph layer counts the graphed pushes (`graphed.counts()`: eager
calls, captures and replays, one a push) and records their spans: while a
torch.profiler session is active a push records `stream.push` over the
layer's `graphed.call` (utils/observability.span), or, eager, over
`stream.copy_in` (the chunk onto the device) and `stream.eager`. The block
kernel counts its launches in the launch ledger
(tcn_block.counts()["tcn_stream_block"]): R * X a push, replayed or not.
"""

from __future__ import annotations

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


def _step_in_place(params, state: StreamState, cfg: ConvTasNetConfig, device: torch.device,
                   first: bool):
    """stream_step on `state` as a function of the chunk alone, writing the
    new state into `state` in place: a captured graph reads and writes the
    same buffers on every replay. A host chunk is taken to `device` first
    (a no-op on the graph layer's static input)."""
    def step(chunk: torch.Tensor) -> torch.Tensor:
        x = chunk.to(device, torch.float32, non_blocking=True)
        out, new = stream_step(params, state, cfg, x, first)
        for dst, src in zip(state_leaves(state), state_leaves(new)):
            if src is not dst:  # a ring the kernel updated in place needs no copy
                dst.copy_(src)
        return out
    return step


class StreamingSeparator:
    """Stateful wrapper over stream_step for `batch` concurrent streams.

    push() per chunk, then flush() for the final L-S overlap-add samples;
    the concatenation equals the offline forward on the whole waveform.
    Where models/graphed has a capture backend for the device (a card) and
    graph=True (the default), the chunk step runs through one stateful
    GraphedForward per value of `first`, keyed by the chunk's shape: a
    key's first push eager, its second captured, later ones replayed, the
    state held in place throughout; a failed capture raises. graph=False,
    or a CPU device, runs the step eagerly."""

    def __init__(self, cfg: ConvTasNetConfig, params, batch: int = 1, device=None,
                 graph: bool = True):
        _check(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _step_params(params, cfg, self.device)
        self._batch = batch
        self.graphed = graph and graphed.backend_for(self.device) is not None
        self.state = init_stream_state(cfg, batch, self.device)
        if self.graphed:
            self._steps = {first: graphed.GraphedForward(
                _step_in_place(self.params, self.state, cfg, self.device, first),
                stateful=True, device=self.device) for first in (True, False)}
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
        with span("stream.push"):
            if chunk.dim() != 2 or chunk.shape[0] != self._batch:
                raise ValueError(f"chunk of shape {tuple(chunk.shape)}: expected "
                                 f"[{self._batch}, T_chunk]")
            first = self._warm == 0
            if self.graphed:
                out = self._steps[first](chunk)
            else:
                with span("stream.copy_in"):
                    x = chunk.to(self.device, torch.float32, non_blocking=True)
                with span("stream.eager"):
                    out, self.state = stream_step(self.params, self.state, self.cfg, x, first)
            self._warm += 1
        return out

    def flush(self) -> torch.Tensor:
        """Emit the final overlap-add tail ([M, C, L - S]) as a new tensor."""
        return self.state["ola_tail"].clone()
