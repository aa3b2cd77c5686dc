"""Process-group start-up.

Counterpart of convtasnet_tpu/parallel/distributed.py. The port runs one
process per card: `initialize` joins the torch.distributed process group
from the JAX package's names (flags, or COORDINATOR_ADDRESS /
NUM_PROCESSES / PROCESS_ID) and else from torchrun's (MASTER_ADDR /
MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK), and puts this process on
cuda:LOCAL_RANK. The backend is nccl on CUDA and gloo on the CPU; a caller
may name another (two ranks sharing one card need gloo, since nccl refuses
two ranks on one GPU).

    torchrun --nproc_per_node 4 -m convtasnet_torch.cli.train --dp 4 ...
    python -m convtasnet_torch.cli.train --multihost 1 \\
        --coordinator_address host0:1234 --num_processes 8 --process_id 3 ...

A coordinator address with a scheme (`file:///path/store`, `tcp://h:p`)
is passed to init_process_group as its init_method unchanged.

Under DP on NCCL the Solver captures the train and CV steps as CUDA
graphs with their all-reduces inside (training/solver.py). What that
needs of the group:
* its communicator exists before any capture: NCCL makes it at the
  group's first collective, which is the first, eager call of a step's
  key (models/graphed.GraphedForward), never inside a capture;
* no recordStream on a tensor of a graph's private pool, which the
  caching allocator cannot honour: ProcessGroupNCCL keeps a collective's
  tensors alive until its work is done instead. That is its default in
  the torch the port runs on the card (2.11), which warns that
  TORCH_NCCL_AVOID_RECORD_STREAMS, the variable that once chose it, is
  deprecated; so nothing is set here;
* the capture's error mode (models/graphed.CudaGraphs.capture).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


_device: Optional[torch.device] = None  # the device initialize() put this rank on


def launched() -> bool:
    """Whether the environment names a process group (torchrun or the JAX
    package's variables)."""
    return "WORLD_SIZE" in os.environ or "COORDINATOR_ADDRESS" in os.environ


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: str = "cuda") -> torch.device:
    """init_process_group from flags or the environment; returns this
    rank's device (cuda:LOCAL_RANK, or the CPU for device_type "cpu")."""
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(env.get("NUM_PROCESSES", env.get("WORLD_SIZE", 0))) or None
    if process_id is None:
        process_id = int(env.get("PROCESS_ID", env.get("RANK", -1)))
        process_id = None if process_id < 0 else process_id
    if address:
        init_method = address if "://" in address else f"tcp://{address}"
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    else:
        raise RuntimeError(
            "no process group to join: launch with torchrun (torchrun "
            "--nproc_per_node N -m convtasnet_torch.cli.<cli> ...) or pass "
            "--coordinator_address / --num_processes / --process_id")
    if num_processes is None or process_id is None:
        raise RuntimeError("the process group needs its world size and this process's rank "
                           "(--num_processes / --process_id, or WORLD_SIZE / RANK)")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device(device_type)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    global _device
    _device = device
    return device


def shutdown() -> None:
    global _device
    _device = None
    if dist.is_initialized():
        dist.destroy_process_group()


def device() -> torch.device:
    """This rank's device: the one initialize() chose, else the current
    card. Like every entry point it is CUDA unless the caller named the
    CPU, and raises rather than fall back when no card is present."""
    if _device is not None:
        return _device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank; pass device='cpu' "
                           "(or initialize(device_type='cpu')) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return rank() == 0


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero rows appended up to `rows` (length-0 rows: zero loss weight)."""
    a = np.asarray(a)
    if a.shape[0] == rows:
        return a
    return np.pad(a, [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
