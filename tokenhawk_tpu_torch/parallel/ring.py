"""Context parallelism: KV sharded along the sequence dimension.

Counterpart of tokenhawk_tpu/parallel/ring.py.  The reference runs these
inside `shard_map` over the ctx axis; here every rank of the ctx group
(parallel/mesh.py) calls them with its own shard, and the collectives
are torch.distributed's:

  - `ring_attention`: prefill.  Each rank owns a query block and a KV
    block; KV blocks rotate one hop a step (`batch_isend_irecv` to the
    next rank, from the previous: the reference's `ppermute`) while each
    rank folds the visiting block into its online-softmax state.  The
    step's partials are kernel 19 (ops/cuda/flash_attention.py
    `flash_attention_stats`); the next block's transfer is in flight
    while it runs.
  - `decode_attend_cp`: decode.  Each rank computes the softmax partials
    of the query over its shard (kernel 18, ops/cuda/flash_decode.py
    `flash_decode_stats`), then the partials merge across ranks with
    all_reduce MAX and SUM (the reference's pmax and psum): O(Dh) per
    head on the wire, never the cache.

On CPU tensors the kernels' plain versions run.  The reference's masked
jnp fallback, `_block_attend_stats`, is `ops/attention.py`
`attend_stats`, which those plain versions compute.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from tokenhawk_tpu_torch.ops.cuda.flash_attention import flash_attention_stats
from tokenhawk_tpu_torch.ops.cuda.flash_decode import flash_decode_stats
from tokenhawk_tpu_torch.parallel.mesh import CtxMesh

_MASK = -0.7 * float(torch.finfo(torch.float32).max)


def _merge_stats(o1, m1, l1, o2, m2, l2):
    """Combine two unnormalised softmax partials (online-softmax merge);
    o [..., Dh] with m, l [...]."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def _rotate(mesh: CtxMesh, tensors):
    """Start sending `tensors` to the next rank of the ring and receiving the
    previous rank's into new buffers: (requests, buffers)."""
    nxt = mesh.peer((mesh.index + 1) % mesh.ncp)
    prv = mesh.peer((mesh.index - 1) % mesh.ncp)
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, mesh.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, prv, mesh.group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def ring_attention(q_local: torch.Tensor, k_local: torch.Tensor, v_local: torch.Tensor,
                   mesh: CtxMesh, scale: Optional[float] = None,
                   layout: str = "block") -> torch.Tensor:
    """Causal ring attention over the ctx group.

    q_local [B, H, T, Dh] are this rank's queries, k_local / v_local
    [B, Hkv, T, Dh] its KV block (contiguous) -> [B, H, T, Dh] in q's dtype.
    layout "block":  rank i's rows sit at positions [i*T, (i+1)*T);
    layout "cyclic": rank i owns positions {i, i+n, i+2n, ...} (the
                     interleave parallel/cp.py keeps its cache in).
    q is scaled in f32 and stays f32 into kernel 19, as in the reference."""
    B, H, T, Dh = q_local.shape
    Hkv = k_local.shape[1]
    n, idx = mesh.ncp, mesh.index
    if scale is None:
        scale = 1.0 / Dh**0.5
    q = (q_local.float() * scale).reshape(B, Hkv, H // Hkv, T, Dh)
    cyclic = layout == "cyclic"
    stride = n if cyclic else 1
    dev = q.device

    def start(shard):
        return torch.full((B,), shard if cyclic else shard * T, dtype=torch.int32, device=dev)

    q_start = start(idx)
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:-1], -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    kv = [k_local, v_local]
    for step in range(n):
        src = (idx - step) % n  # owner of the visiting KV block
        pending = _rotate(mesh, kv) if step < n - 1 else None
        o, m, l = _merge_stats(o, m, l, *flash_attention_stats(q, *kv, q_start, start(src),
                                                               stride))
        if pending is not None:
            reqs, kv = pending
            for r in reqs:
                r.wait()
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (o / l_safe[..., None]).reshape(B, H, T, Dh).to(q_local.dtype)


def decode_attend_cp(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                     shard_lengths: torch.Tensor, mesh: CtxMesh,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over sequence-sharded KV.

    q [B, H, Dh] (the same on every rank), k_shard / v_shard [B, Hkv, S_local,
    Dh] this rank's slots, shard_lengths [B] int32 valid slots in this
    shard -> [B, H, Dh] in q's dtype.  q is scaled in f32 and rounded to the
    cache dtype, as the reference hands it to its kernel.  A shard with no
    valid slot gives the merge identity and weighs 0."""
    B, H, Dh = q.shape
    Hkv = k_shard.shape[1]
    if scale is None:
        scale = 1.0 / Dh**0.5
    qg = (q.float() * scale).reshape(B, Hkv, H // Hkv, Dh).to(k_shard.dtype)
    o, m, l = (x[0] for x in flash_decode_stats(qg, k_shard, v_shard, shard_lengths))
    o = o.reshape(B, H, Dh)
    m_g = m.clone()
    dist.all_reduce(m_g, dist.ReduceOp.MAX, group=mesh.group)
    alpha = torch.where(torch.isinf(m) & (m < 0), 0.0, torch.exp(m - m_g))  # [B, H]
    # psum of o * alpha and of l * alpha in one collective.
    ol = torch.cat([o * alpha[..., None], (l * alpha)[..., None]], dim=-1)
    dist.all_reduce(ol, group=mesh.group)
    l_g = ol[..., Dh]
    l_safe = torch.where(l_g == 0.0, 1.0, l_g)
    return (ol[..., :Dh] / l_safe[..., None]).to(q.dtype)
