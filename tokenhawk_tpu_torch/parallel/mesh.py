"""The context-parallel process group (the CTX part of tokenhawk_tpu/parallel/mesh.py).

The reference builds a (data, ctx) `jax.sharding.Mesh` over its devices
and its CP code runs inside `shard_map`, naming the ctx axis.  Here each
rank is one process with one device, the ctx axis is a torch.distributed
process group, and the code the reference maps over the mesh runs in
every rank of the group with its own slice of the cache.  The caller
initialises the group (`torch.distributed.init_process_group`): "nccl"
on GPUs, "gloo" on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

# The reference's axis names: one rank a ctx position, no data axis yet.
DATA_AXIS = "data"
CTX_AXIS = "ctx"


@dataclasses.dataclass(frozen=True)
class CtxMesh:
    """This rank's place on the ctx axis: the group, its index, ncp."""

    group: dist.ProcessGroup
    index: int
    ncp: int

    def peer(self, index: int) -> int:
        """The global rank of the group's member `index` (ring neighbours)."""
        return dist.get_global_rank(self.group, index)


def make_cp_mesh(dp: int = 1, cp: Optional[int] = None,
                 group: Optional[dist.ProcessGroup] = None) -> CtxMesh:
    """The ctx axis over `group` (default: the whole world), which must
    already be initialised; `cp`, when given, must be its size."""
    if dp != 1:
        raise NotImplementedError(
            f"dp={dp}: data parallelism composed with CP waits for the TP/DP port "
            "(ROADMAP.md Queue 1 item 5)")
    if not dist.is_initialized():
        raise RuntimeError("make_cp_mesh needs torch.distributed.init_process_group first")
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    if cp is not None and cp != n:
        raise ValueError(f"cp={cp} but the ctx group has {n} ranks")
    return CtxMesh(group, dist.get_rank(group), n)
