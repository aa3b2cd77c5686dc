"""The benchmark of convtasnet_torch, the PyTorch and CUDA port, on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root:
`configs/<config>.json` (model widths), `traffic/<traffic>.json` (the mix
and the driver that plays it), `drivers/<driver>.py`, `limits/<cell>.json`
(the limits of the correctness check), `metrics/<metric>.py` (readers of
the traced run) and `kernels/<counter>.py` (the work of one hand-written
kernel). `reference/` is the plain float32 model that decides `correct`.
Nothing here imports JAX or the JAX package.
"""
