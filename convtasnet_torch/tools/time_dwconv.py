"""Per-dilation check and device time of the depthwise kernels K2
(tcn_dwconv, inference and save modes) and KB2 (tcn_bwd_dwconv) at the
paper widths (H=512, P=3, gLN, bf16), on one CUDA device.

    python -m convtasnet_torch.tools.time_dwconv
    python -m convtasnet_torch.tools.time_dwconv --dilations 1 64 128 --tiles 128x32 64x16

For each kernel (K2 at batch 8, K2 save and KB2 at batch 5; 4 s at 8 kHz:
K = 3199 frames, padded to 3200) and dilation, prints one JSON line: the
tile plan (`auto`: dw_plan; `BRxLANES`: that tile forced through dw_tile),
the largest |kernel - plain| / max |plain| of every output, whether two
launches gave equal bytes, the kernel's device time per launch
(torch.profiler), its host time per wrapper call, the bound (the bytes the
function must move at 3.35 TB/s), the f32 channel-partial bytes the tile
writes (KB2), and one cuDNN depthwise call of the same conv (F.conv1d /
F.conv_transpose1d with groups=H on a [M, H, K_pad] copy, TF32 off).
Inputs are random from a seed; the time does not depend on their values.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from ..ops.kernels import tcn_block as tb
from ..ops.kernels import tcn_block_bwd as tbb
from ._bench import device_ms

H, P, K, KP = 512, 3, 3199, 3200
PEAK_BYTES_PER_S = 3.35e12


def host_us(fn, iters: int = 50) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def rel_max(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def inputs(batch: int, seed: int, dt=torch.bfloat16, norm="gLN"):
    """Block inputs at the paper widths and their forward residuals (plain
    K1 and K2 save, KB1's dz and partials)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    x = rnd(batch, KP, 256)
    x[:, K:] = 0
    x = x.to(dt)
    in_w, out_w = rnd(256, H, scale=0.05).to(dt), rnd(H, 256, scale=0.05).to(dt)
    a1, a2 = torch.full((1,), 0.25, device=dev), torch.full((1,), 0.25, device=dev)
    g1, b1, g2 = rnd(H, scale=0.1, shift=1.0), rnd(H, scale=0.1), rnd(H, scale=0.1, shift=1.0)
    w = rnd(P, H, scale=0.3)
    y1, s1 = tb.in_gemm_plain(x, in_w, a1, norm)
    _, s2, c = tb.dwconv_plain(y1, s1, a1, g1, b1, w, a2, norm, 1, False, K, save=True)
    g = rnd(batch, KP, 256).to(dt)
    dz, _, gs2 = tbb.bwd_dz_plain(g, out_w.t().contiguous(), c, s2, a2, g2, norm, K)
    return dict(y1=y1, s1=s1, c=c, s2=s2, dz=dz, gs2=gs2, a1=a1, g1=g1, b1=b1, w=w, a2=a2,
                g2=g2, norm=norm)


def forced_plan(tile: str, d: int, itemsize: int, backward: bool):
    if tile == "auto":
        return None
    return tb.dw_tile(P, d, H, itemsize, backward, *(int(v) for v in tile.split("x")))[1]


def run(kernel: str, batch: int, d: int, tile: str, t: dict) -> dict:
    it = t["y1"].element_size()
    rows = batch * KP
    backward = kernel == "tcn_bwd_dwconv"
    plan = forced_plan(tile, d, it, backward)
    shown = plan or tb.dw_plan(P, d, H, it, backward)
    fargs = (t["y1"], t["s1"], t["a1"], t["g1"], t["b1"], t["w"], t["a2"], t["norm"], d, False, K)
    bargs = (t["y1"], t["c"], t["dz"], t["s1"], t["s2"], t["gs2"], t["a1"], t["g1"], t["b1"],
             t["w"], t["a2"], t["g2"], t["norm"], d, False, K)
    pad = (P - 1) * d // 2
    w_t = t["w"].t().contiguous().unsqueeze(1).to(t["y1"].dtype)
    if kernel == "tcn_bwd_dwconv":
        kern = lambda: tbb.tcn_bwd_dwconv(*bargs, plan=plan)  # noqa: E731
        want = tbb.bwd_dwconv_plain(*bargs)
        src = t["dz"].transpose(1, 2).contiguous()
        lib = lambda: F.conv_transpose1d(src, w_t, groups=H, dilation=d, padding=pad)  # noqa: E731
        streams = 4
    else:
        save = kernel == "tcn_dwconv_save"
        kern = lambda: tb.tcn_dwconv(*fargs, save=save, plan=plan)  # noqa: E731
        want = tb.dwconv_plain(*fargs, save=save)
        src = t["y1"].transpose(1, 2).contiguous()
        lib = lambda: F.conv1d(src, w_t, groups=H, dilation=d, padding=pad)  # noqa: E731
        streams = 3 if save else 2
    got = kern()
    red = {0: None, 1: (1,) if t["norm"] == "gLN" else (2,)}
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dim() == 1 or (backward and i == 1):   # d_alpha2 / channel partials: summed
            a, b = a.sum(0), b.sum(0)
        elif a.dtype == torch.float32:              # norm partials: summed over n
            a, b = a.sum(red[1]), b.sum(red[1])
        errs.append(rel_max(a, b))
    again = kern()
    res = {"device": torch.cuda.get_device_name(0), "kernel": kernel, "batch": batch,
           "dilation": d, "tile": tile, "plan": list(shown), "max_rel_err": errs,
           "repeat_equal": all(torch.equal(u, v) for u, v in zip(got, again)),
           "ms": device_ms(kern), "host_us": host_us(kern),
           "bound_ms": streams * rows * H * it / PEAK_BYTES_PER_S * 1e3,
           "library_ms": device_ms(lib)}
    if backward:
        res["chpart_bytes"] = rows // shown.rows * (P + 2) * H * 4
    return res


def main(argv=None):
    p = argparse.ArgumentParser("Check and time K2 / K2 save / KB2 per dilation on the GPU")
    p.add_argument("--dilations", type=int, nargs="+", default=[2 ** i for i in range(8)])
    p.add_argument("--kernels", nargs="+",
                   default=["tcn_dwconv", "tcn_dwconv_save", "tcn_bwd_dwconv"])
    p.add_argument("--tiles", nargs="+", default=["auto"],
                   help="auto, or BRxLANES (dw_tile)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_dwconv: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    data = {8: inputs(8, 8), 5: inputs(5, 5)}
    out = []
    for kernel in args.kernels:
        batch = 8 if kernel == "tcn_dwconv" else 5
        for tile in args.tiles:
            for d in args.dilations:
                try:
                    out.append(run(kernel, batch, d, tile, data[batch]))
                except ValueError as err:  # a forced tile that does not fit
                    out.append({"kernel": kernel, "dilation": d, "tile": tile, "error": str(err)})
                print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
