"""Per-dilation check and device time of the depthwise kernels K2
(tcn_dwconv, inference and save modes) and KB2 (tcn_bwd_dwconv) at the
paper widths (H=512, P=3, gLN, bf16), on one CUDA device.

    python -m convtasnet_torch.tools.time_dwconv
    python -m convtasnet_torch.tools.time_dwconv --dilations 1 64 128 --tiles 128x32 64x16
    python -m convtasnet_torch.tools.time_dwconv --kernels tcn_bwd_dwconv --strips 6

K2 runs at batch 8 and K2 save at batch 5 of 4 s at 8 kHz (K = 3199
frames, padded to 3200); KB2 at the train cells' shapes (`--shapes`):
`paper` (batch 8, K = 3199, K_pad = 3200) and `taslp` (batch 8, K = 3999,
K_pad = 4096). For each kernel, shape and dilation, prints one JSON line:
the plan (K2 `--tiles`: `auto` is dw_plan, `BRxLANES` that tile forced
through dw_tile; KB2 `--strips`: `auto` is kb2_plan, `BANDS` that many
strips an item forced through kb2_strip; KB2's line names its strip rows,
channels, ring rows, stages and CTAs, and `loaded_per_row`, the rows of c
and dz it loads per row of db it writes, by kb2_load_rows: 1 plus the
halo chunks that two strips load),
the largest |kernel - plain| / max |plain| of every output, whether two
launches gave equal bytes, the kernel's device time per launch warm and
with a cold L2 (torch.profiler), its host time per wrapper call, the
bound (the bytes the function must move at 3.35 TB/s) and its share of
the warm time, the f32 channel-partial bytes the plan writes (KB2), and
(unless `--compare 0`) the plain version's time and one cuDNN depthwise
call of the same conv (F.conv1d / F.conv_transpose1d with groups=H on a
[M, H, K_pad] copy, TF32 off). Inputs are random from
a seed; the time does not depend on their values.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from ..ops.kernels import tcn_block as tb
from ..ops.kernels import tcn_block_bwd as tbb
from ._bench import cold_timed, device_ms

H, P, K, KP = 512, 3, 3199, 3200
SHAPES = {"paper": (8, 3199, 3200), "taslp": (8, 3999, 4096)}  # KB2: (batch, K, K_pad)
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


def inputs(batch: int, seed: int, dt=torch.bfloat16, norm="gLN", K: int = K, KP: int = KP):
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


def forced_plan(tile: str, d: int, itemsize: int, backward: bool, batch: int, kp: int):
    if tile == "auto":
        return None
    if backward:
        return tb.kb2_strip(P, d, H, itemsize, batch, kp, int(tile))[1]
    return tb.dw_tile(P, d, H, itemsize, *(int(x) for x in tile.split("x")))[1]


def run(kernel: str, batch: int, d: int, tile: str, t: dict, compare: bool = True) -> dict:
    it = t["y1"].element_size()
    kp, k = t["y1"].shape[1], t["K"]
    rows = batch * kp
    backward = kernel == "tcn_bwd_dwconv"
    plan = forced_plan(tile, d, it, backward, batch, kp)
    fargs = (t["y1"], t["s1"], t["a1"], t["g1"], t["b1"], t["w"], t["a2"], t["norm"], d, False, k)
    bargs = (t["y1"], t["c"], t["dz"], t["s1"], t["s2"], t["gs2"], t["a1"], t["g1"], t["b1"],
             t["w"], t["a2"], t["g2"], t["norm"], d, False, k)
    pad = (P - 1) * d // 2
    w_t = t["w"].t().contiguous().unsqueeze(1).to(t["y1"].dtype)
    if backward:
        shown = plan or tbb._kb2_plan(P, d, H, t["y1"].dtype, batch, kp, t["y1"].device.index)
        call = lambda *a: tbb.tcn_bwd_dwconv(*a, plan=plan)  # noqa: E731
        args = bargs
        plain = lambda: tbb.bwd_dwconv_plain(*bargs)  # noqa: E731
        src = t["dz"].transpose(1, 2).contiguous()
        lib = lambda: F.conv_transpose1d(src, w_t, groups=H, dilation=d, padding=pad)  # noqa: E731
        streams = 4
    else:
        shown = plan or tb.dw_plan(P, d, H, it)
        save = kernel == "tcn_dwconv_save"
        call = lambda *a: tb.tcn_dwconv(*a, save=save, plan=plan)  # noqa: E731
        args = fargs
        plain = lambda: tb.dwconv_plain(*fargs, save=save)  # noqa: E731
        src = t["y1"].transpose(1, 2).contiguous()
        lib = lambda: F.conv1d(src, w_t, groups=H, dilation=d, padding=pad)  # noqa: E731
        streams = 3 if save else 2
    kern = lambda: call(*args)  # noqa: E731
    got = kern()
    want = plain()
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
           "K": k, "K_pad": kp, "dilation": d, "tile": tile, "plan": shown._asdict(),
           "max_rel_err": errs,
           "repeat_equal": all(torch.equal(u, v) for u, v in zip(got, again)),
           "ms": device_ms(kern), "cold_ms": cold_timed(call, args).ms, "host_us": host_us(kern),
           "bound_ms": streams * rows * H * it / PEAK_BYTES_PER_S * 1e3}
    if compare:
        res.update(plain_ms=device_ms(plain), library_ms=device_ms(lib))
    if backward:
        span = (P - 1) * d
        loaded = sum(len(tb.kb2_load_rows(shown, kp, band, span // 2, span))
                     for band in range(shown.bands)) * shown.chunk
        res.update(strip_rows=shown.strip, channels=shown.cols, ring_rows=shown.ring * shown.chunk,
                   stages=shown.stages, ctas=shown.grid, loaded_per_row=loaded / kp,
                   halo_rows=span, chpart_bytes=batch * shown.bands * (P + 2) * H * 4)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    return res


def main(argv=None):
    p = argparse.ArgumentParser("Check and time K2 / K2 save / KB2 per dilation on the GPU")
    p.add_argument("--dilations", type=int, nargs="+", default=[2 ** i for i in range(8)])
    p.add_argument("--kernels", nargs="+",
                   default=["tcn_dwconv", "tcn_dwconv_save", "tcn_bwd_dwconv"])
    p.add_argument("--tiles", nargs="+", default=["auto"],
                   help="K2: auto, or BRxLANES (dw_tile)")
    p.add_argument("--strips", nargs="+", default=["auto"],
                   help="KB2: auto, or BANDS, strips an item (kb2_strip)")
    p.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES),
                   help="KB2's shapes: the train cells'")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--compare", type=int, default=1,
                   help="0: leave out the plain version's and the library's times")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_dwconv: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, args.dtype)
    out = []
    for kernel in args.kernels:
        if kernel == "tcn_bwd_dwconv":
            cases = [(SHAPES[s], args.strips) for s in args.shapes]
        else:
            cases = [((8 if kernel == "tcn_dwconv" else 5, K, KP), args.tiles)]
        for (batch, k, kp), plans in cases:
            t = dict(inputs(batch, batch + k, dt, K=k, KP=kp), K=k)
            for tile in plans:
                for d in args.dilations:
                    try:
                        out.append(run(kernel, batch, d, tile, t, bool(args.compare)))
                    except ValueError as err:  # a forced plan that does not fit
                        out.append({"kernel": kernel, "dilation": d, "tile": tile,
                                    "error": str(err)})
                    print(json.dumps(out[-1]), flush=True)
            del t
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
