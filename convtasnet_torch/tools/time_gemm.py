"""Device time of the bf16 wgmma kernels K1 (tcn_in_gemm), K3 (tcn_out_gemm,
fold and unfold), KB1 (tcn_bwd_dz), KB3 (tcn_bwd_dx) and KW (tcn_wgrad,
both forms) at the paper widths, for each launch plan, on one CUDA device.

    python -m convtasnet_torch.tools.time_gemm --batch 8 5 1
    python -m convtasnet_torch.tools.time_gemm --batch 5 --plans --kw_plans auto 32x8 32x4 33x1

For each batch (4 s at 8 kHz: K = 3199 frames, padded to 3200) and each
plan (`auto`: gemm_plan for the card's SM count and occupancy; the
others count one CTA per SM: `128`: 128-row tiles, what gemm_plan picks
for a card of one SM; `64`: the smallest tiles, what it picks when every
tile fits one wave; `wave64`: an SM count at which K1 and KB1 take
64 x 256, their 64-row tiles all in one wave) prints one
JSON line: the tiles, each kernel's device time per launch from
torch.profiler, the host time per wrapper call, and torch.matmul of the
same products (device time). Inputs are random from a seed: the time does
not depend on their values.

For KW each plan (`auto`: wgrad_plan for the card; `SxC`: S row splits in
clusters of C CTAs) gives one JSON line: each form's device time per
`tcn_wgrad(...).sum(0)` call (the measure of chip_smoke.py), of the kernel
alone, the host time per wrapper call, and torch.matmul of the product.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops.kernels import tcn_block as tb
from ..ops.kernels import tcn_block_bwd as tbb
from ._bench import device_ms

B, H, K, KP = 256, 512, 3199, 3200
PLAN_SMS = {"128": lambda rows: 1, "64": lambda rows: 10 ** 6,
            "wave64": lambda rows: rows // 64 * (H // 256)}


def host_us(fn, iters: int = 100) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def run(batch: int, plan: str) -> dict:
    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(batch)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    e, db, y1, c = (rnd(batch, KP, H).to(dt) for _ in range(4))
    x, g = rnd(batch, KP, B), rnd(batch, KP, B).to(dt)
    x[:, K:] = 0
    x = x.to(dt)
    in_w = rnd(B, H, scale=0.05).to(dt)
    out_w, g2, b2 = rnd(H, B, scale=0.05), rnd(H, scale=0.1) + 1, rnd(H, scale=0.1)
    wp, ga, gb = tb.fold_weights(out_w, g2, b2, dt)
    ow = out_w.to(dt)
    in_wt = rnd(H, B, scale=0.05).to(dt)
    a1, g1 = torch.full((1,), 0.25, device=dev), rnd(H, scale=0.1) + 1
    # gLN partials of a plausible scale: one (sum, sum of squares) pair per item
    n = float(K * H)
    stats = torch.stack([rnd(batch, 1, scale=0.01 * n), (1 + rnd(batch, 1).abs()) * n], -1)
    gs1 = rnd(batch, 1, 2, scale=10.0)
    out, y1_out = torch.empty_like(x), torch.empty_like(y1)
    out_wt = ow.t().contiguous()
    rows = batch * KP
    real = (tb._sm_count, tb._resident, tbb._resident)
    if plan in PLAN_SMS:  # forced: this SM count, one CTA counted per SM
        sms = PLAN_SMS[plan](rows)
        tb._sm_count = tbb._sm_count = lambda index: sms
        tb._resident = tbb._resident = lambda index, mode: ()
    try:
        runs = {
            "tcn_in_gemm": lambda: tb.tcn_in_gemm(x, in_w, a1, "gLN", y1_out),
            "tcn_bwd_dz": lambda: tbb.tcn_bwd_dz(g, out_wt, c, stats, a1, g2, "gLN", K),
            "tcn_out_gemm_fold": lambda: tb.tcn_out_gemm(e, stats, x, wp, ga, gb, "gLN", K, True, out),
            "tcn_out_gemm_unfold": lambda: tb.tcn_out_gemm(e, stats, x, ow, g2, b2, "gLN", K, False,
                                                           out),
            "tcn_bwd_dx": lambda: tbb.tcn_bwd_dx(db, y1, in_wt, g, stats, gs1, a1, g1, "gLN", K),
        }
        idx = torch.cuda.current_device()
        sms_now = tb._sm_count(idx)
        res = {"device": torch.cuda.get_device_name(dev), "batch": batch, "plan": plan,
               "k1_tile": tb.gemm_plan(rows, H, B, sms_now, io_tiles=1,
                                       resident=tb._resident(idx, tb.H_IN)),
               "k3_tile": tb.gemm_plan(rows, B, H, sms_now, resident=tb._resident(idx, tb.H_FOLD)),
               "kb1_tile": tb.gemm_plan(rows, H, B, sms_now, resident=tbb._resident(idx, tb.H_DZ)),
               "kb3_tile": tb.gemm_plan(rows, B, H, sms_now, split=False,
                                        resident=tbb._resident(idx, tb.H_DX))}
        for name, fn in runs.items():
            res[f"{name}_ms"] = device_ms(fn)
            res[f"{name}_host_us"] = host_us(fn)
        res["matmul_ms"] = device_ms(lambda: torch.matmul(e.view(rows, H), ow))
        res["matmul_in_ms"] = device_ms(lambda: torch.matmul(x.view(rows, B), in_w))
    finally:
        tb._sm_count = tbb._sm_count = real[0]
        tb._resident, tbb._resident = real[1:]
    return res


def run_kw(batch: int, plan: str) -> dict:
    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(batch)
    rows = batch * KP
    c, dy1 = (torch.randn((batch, KP, H), generator=gen, device=dev).to(dt) for _ in range(2))
    x, g = (torch.randn((batch, KP, B), generator=gen, device=dev).to(dt) for _ in range(2))
    a2 = torch.full((1,), 0.25, device=dev)
    g2 = torch.randn((H,), generator=gen, device=dev) * 0.1 + 1
    b2 = torch.randn((H,), generator=gen, device=dev) * 0.1
    n = float(K * H)
    s2 = torch.stack([torch.randn((batch, 1), generator=gen, device=dev) * 0.01 * n,
                      (1 + torch.randn((batch, 1), generator=gen, device=dev).abs()) * n], -1)
    z = (s2, a2, g2, b2, "gLN")
    forced = None if plan == "auto" else tuple(int(v) for v in plan.split("x"))
    res = {"device": torch.cuda.get_device_name(dev), "batch": batch, "kw_plan": plan,
           "plan_z": list(forced or tbb.wgrad_launch_plan(c, g, z)),
           "plan_din": list(forced or tbb.wgrad_launch_plan(x, dy1)),
           "max_clusters": tbb._max_clusters(torch.cuda.current_device(), B)}
    for name, A, Bm, zz in (("z", c, g, z), ("din", x, dy1, None)):
        res[f"kw_{name}_ms"] = device_ms(lambda: tbb.tcn_wgrad(A, Bm, K, zz, plan=forced).sum(0))
        res[f"kw_{name}_kernel_ms"] = device_ms(lambda: tbb.tcn_wgrad(A, Bm, K, zz, plan=forced))
        res[f"kw_{name}_host_us"] = host_us(lambda: tbb.tcn_wgrad(A, Bm, K, zz, plan=forced))
    res["matmul_ms"] = device_ms(lambda: torch.matmul(c.view(rows, H).t(), g.view(rows, B)))
    return res


def main(argv=None):
    p = argparse.ArgumentParser("Time the bf16 wgmma kernels K1, K3, KB1, KB3 and KW on the GPU")
    p.add_argument("--batch", type=int, nargs="+", default=[8, 5, 1])
    p.add_argument("--plans", nargs="*", default=["auto", "128", "64"],
                   choices=["auto", *PLAN_SMS])
    p.add_argument("--kw_plans", nargs="*", default=["auto"],
                   help="KW plans: auto, or SxC (S splits in clusters of C)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_gemm: no CUDA device")
    out = []
    for batch in args.batch:
        for plan in args.plans:
            out.append(run(batch, plan))
            print(json.dumps(out[-1]), flush=True)
        for plan in args.kw_plans:
            out.append(run_kw(batch, plan))
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
