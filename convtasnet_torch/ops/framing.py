"""Signal framing and overlap-add.

`frame_signal` turns [..., T] into [..., K, L] windows with hop S (reshape
and concatenation when L % S == 0, a gather otherwise); the encoder is then
one [M*K, L] @ [L, N] product. `overlap_and_add` inverts it as a sum of
L//S shifted sub-signals, with a GCD-subframe scatter-add for irregular
(L, S) (the reference's utils.py:9-46).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def num_frames(T: int, frame_len: int, hop: int) -> int:
    return (T - frame_len) // hop + 1


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., K, frame_len], K = (T - frame_len) // hop + 1; a
    trailing partial frame is dropped (VALID strided conv semantics)."""
    T = x.shape[-1]
    K = num_frames(T, frame_len, hop)
    if K <= 0:
        raise ValueError(f"signal too short to frame: T={T} L={frame_len}")
    if frame_len % hop == 0:
        r = frame_len // hop
        n_sub = T // hop
        sub = x[..., : n_sub * hop].reshape(*x.shape[:-1], n_sub, hop)
        return torch.cat([sub[..., i: i + K, :] for i in range(r)], dim=-1)
    starts = torch.arange(K, device=x.device) * hop
    idx = starts[:, None] + torch.arange(frame_len, device=x.device)[None, :]
    return x[..., idx]


def overlap_and_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., K, L] -> [..., (K - 1) * hop + L] (reference utils.py:28-46)."""
    *lead, K, L = frames.shape
    T_out = (K - 1) * hop + L
    if L % hop == 0:
        r = L // hop
        chunks = frames.reshape(*lead, K, r, hop)
        n_sub = K + r - 1
        out = torch.zeros((*lead, n_sub, hop), dtype=frames.dtype,
                          device=frames.device)
        for c in range(r):
            out = out + F.pad(chunks[..., :, c, :], (0, 0, c, n_sub - K - c))
        return out.reshape(*lead, n_sub * hop)[..., :T_out]
    g = math.gcd(L, hop)
    sub_per_frame = L // g
    sub_step = hop // g
    n_out_sub = T_out // g
    sub = frames.reshape(*lead, K * sub_per_frame, g)
    frame_idx = (torch.arange(K, device=frames.device)[:, None] * sub_step
                 + torch.arange(sub_per_frame, device=frames.device)[None, :]
                 ).reshape(-1)
    out = torch.zeros((*lead, n_out_sub, g), dtype=frames.dtype,
                      device=frames.device)
    out.index_add_(out.dim() - 2, frame_idx, sub)
    return out.reshape(*lead, n_out_sub * g)
