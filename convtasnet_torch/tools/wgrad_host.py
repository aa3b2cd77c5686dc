"""Host time per KW `tcn_wgrad` wrapper call, both forms, bf16, batch 5 x
4 s at the paper widths, beside one `torch.add` of the same size; one JSON
line. It imports the `convtasnet_torch` of the working directory, so two
trees compare in one call by running it from each one's root:

    python /path/to/convtasnet_torch/tools/wgrad_host.py <label>

Each value is the mean over 200 back-to-back calls (no synchronisation
inside), three times. Inputs are random from a seed.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb  # noqa: E402

M, KP, K, B, H = 5, 3200, 3199, 256, 512


def host_us(fn, iters: int = 200) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def main(label: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_host: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    c, dy1 = (torch.randn((M, KP, H), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    x, g = (torch.randn((M, KP, B), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    s2 = torch.stack([torch.zeros((M, 1), device=dev), torch.full((M, 1), 1e6, device=dev)], -1)
    z = (s2, torch.full((1,), 0.25, device=dev), torch.ones(H, device=dev),
         torch.zeros(H, device=dev), "gLN")
    out = {"tree": label, "device": torch.cuda.get_device_name(dev),
           "z_us": [], "din_us": [], "add_us": []}
    for _ in range(3):
        out["z_us"].append(host_us(lambda: tbb.tcn_wgrad(c, g, K, z)))
        out["din_us"].append(host_us(lambda: tbb.tcn_wgrad(x, dy1, K)))
        out["add_us"].append(host_us(lambda: torch.add(c, c)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
