"""Debugging hooks (counterpart of convtasnet_tpu/utils/debugging.py).

* CUDA's sync debug mode turns a silent host <-> device synchronisation
  (.item(), a blocking copy, a host read of a device tensor) into an error:
  the counterpart of JAX's transfer guard, the classic throughput bug class
  of a step or chunk loop.
* autograd's anomaly mode reports the op that produced a NaN in a backward
  (the counterpart of jax_debug_nans).
* The kernels' plain PyTorch versions run on the CPU in the test suite and
  are held against the CUDA kernels by chip_smoke.py and tests/test_torch_cuda.py.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_mode(nan_checks: bool = True, sync_debug: str = "error"):
    """Run a block with host synchronisations as errors (where CUDA is
    present) and, with nan_checks, autograd's anomaly detection; both
    settings are restored on exit, also on an error.

    Example:
        with strict_mode():
            out = separator.push(chunk)
    """
    has_cuda = torch.cuda.is_available()
    prev_sync = torch.cuda.get_sync_debug_mode() if has_cuda else None
    prev_anomaly = torch.is_anomaly_enabled()
    prev_check_nan = torch.is_anomaly_check_nan_enabled()
    try:
        if has_cuda:
            torch.cuda.set_sync_debug_mode(sync_debug)
        if nan_checks:
            torch.autograd.set_detect_anomaly(True)
        yield
    finally:
        if has_cuda:
            torch.cuda.set_sync_debug_mode(prev_sync)
        torch.autograd.set_detect_anomaly(prev_anomaly, check_nan=prev_check_nan)
