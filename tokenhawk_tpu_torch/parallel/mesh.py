"""Process groups of the parallel paths (counterpart of tokenhawk_tpu/parallel/mesh.py).

The reference builds a (data, model) or (data, ctx) `jax.sharding.Mesh`
over its devices, and its TP and CP code runs inside `shard_map`, naming
the axis.  Here each rank is one process with one device, an axis is a
torch.distributed process group, and the code the reference maps over the
mesh runs in every rank of the group with its own shard:

  - `TpMesh` (make_mesh): the model axis, tensor parallelism
    (parallel/tp.py, parallel/tp_paged.py): weights and KV heads sharded,
    the row-parallel partials summed with all_reduce;
  - `CtxMesh` (make_cp_mesh): the ctx axis, context parallelism
    (parallel/cp.py): the KV cache sharded along the sequence.

The caller initialises the group (`torch.distributed.init_process_group`,
or parallel/multihost.py initialize_distributed under torchrun): "nccl"
on GPUs, "gloo" on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

# The reference's axis names: one rank a model or ctx position, no data axis yet.
DATA_AXIS = "data"
MODEL_AXIS = "model"
CTX_AXIS = "ctx"

DP_TODO = ("data parallelism composed with TP or CP is not ported yet "
           "(ROADMAP.md Queue 1 item 4)")


@dataclasses.dataclass(frozen=True)
class CtxMesh:
    """This rank's place on the ctx axis: the group, its index, ncp."""

    group: dist.ProcessGroup
    index: int
    ncp: int

    def peer(self, index: int) -> int:
        """The global rank of the group's member `index` (ring neighbours)."""
        return dist.get_global_rank(self.group, index)


@dataclasses.dataclass(frozen=True)
class TpMesh:
    """This rank's place on the model axis: the group, its index, tp.
    The collectives are the reference's psum and tiled all_gather over
    the axis."""

    group: dist.ProcessGroup
    index: int
    tp: int

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """psum: x summed over the group, in place; returns x."""
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all_gather along the last axis: every rank's x, rank
        order, concatenated."""
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)


def _group(group: Optional[dist.ProcessGroup], fn: str) -> dist.ProcessGroup:
    if not dist.is_initialized():
        raise RuntimeError(f"{fn} needs torch.distributed.init_process_group first")
    return group or dist.group.WORLD


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              group: Optional[dist.ProcessGroup] = None) -> TpMesh:
    """The model axis over `group` (default: the whole world), which must
    already be initialised; `tp`, when given, must be its size."""
    if dp != 1:
        raise NotImplementedError(f"dp={dp}: {DP_TODO}")
    group = _group(group, "make_mesh")
    n = dist.get_world_size(group)
    if tp is not None and tp != n:
        raise ValueError(f"tp={tp} but the model group has {n} ranks")
    return TpMesh(group, dist.get_rank(group), n)


def make_cp_mesh(dp: int = 1, cp: Optional[int] = None,
                 group: Optional[dist.ProcessGroup] = None) -> CtxMesh:
    """The ctx axis over `group` (default: the whole world), which must
    already be initialised; `cp`, when given, must be its size."""
    if dp != 1:
        raise NotImplementedError(f"dp={dp}: {DP_TODO}")
    group = _group(group, "make_cp_mesh")
    n = dist.get_world_size(group)
    if cp is not None and cp != n:
        raise ValueError(f"cp={cp} but the ctx group has {n} ranks")
    return CtxMesh(group, dist.get_rank(group), n)
