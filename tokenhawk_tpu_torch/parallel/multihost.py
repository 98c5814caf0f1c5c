"""Multi-process start-up (counterpart of tokenhawk_tpu/parallel/multihost.py).

The reference brings up JAX's multi-controller runtime and builds one
global (data, model) mesh over every host's devices.  The port runs one
process per rank, under torchrun (or any launcher that sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    torchrun --nproc-per-node N -m tokenhawk_tpu_torch.cli --tp N ...

`initialize_distributed` joins the process group from that environment:
"nccl" with rank r on cuda:LOCAL_RANK, or "gloo" on the CPU.  There is no
fallback: a CUDA rank without its device, or without NCCL, raises.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from tokenhawk_tpu_torch.parallel.mesh import TpMesh, make_mesh

# The group's collective timeout.  A follower of the lockstep server
# waits in a broadcast while the coordinator is idle, and the idle
# coordinator sends an empty round every KEEPALIVE_S (60 s) so that no
# wait comes near it (parallel/multihost_serving.py); it also bounds how
# far apart the ranks may finish loading their shards.
GROUP_TIMEOUT = timedelta(minutes=30)


def launched_world_size() -> int:
    """WORLD_SIZE as a launcher set it, 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_distributed(device: str = "cuda", timeout: timedelta = GROUP_TIMEOUT
                           ) -> torch.device:
    """Join the process group from the launcher's environment (idempotent)
    and return this rank's device: cuda:LOCAL_RANK over "nccl" for a CUDA
    device, the CPU over "gloo" for "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank with LOCAL_RANK={local} has no CUDA device "
                               f"({torch.cuda.device_count()} visible)")
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend on this machine")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, timeout=timeout)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
    return dev


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None) -> TpMesh:
    """The model axis over every rank (dp 1: data parallelism is not
    ported, parallel/mesh.py)."""
    n = dist.get_world_size()
    if tp is None:
        tp = n
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return make_mesh(dp=dp, tp=tp)


def host_local_slice(total: int, axis_shards: int) -> Sequence[slice]:
    """Row ranges each shard owns when splitting `total` into axis_shards."""
    per = total // axis_shards
    return [slice(i * per, (i + 1) * per) for i in range(axis_shards)]
