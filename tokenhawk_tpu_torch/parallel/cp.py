"""Context parallelism end to end: the Engine's prefill and decode over a
sequence-sharded KV cache.

Counterpart of tokenhawk_tpu/parallel/cp.py.  Every rank of the ctx group
(parallel/mesh.py) runs these functions with the whole (replicated)
parameters and its own slice of the cache; the reference runs the same
bodies inside `shard_map`.

Layout, CYCLIC interleave: global position p lives on rank p % ncp at
local slot p // ncp.

  * prefill: rank i takes query tokens {i, i+ncp, ...} of the block,
    writes their K / V into its own cache slots 0 .. T/ncp (a local
    write), and attends through cyclic ring attention (parallel/ring.py,
    kernel 19 a step);
  * decode: the new token's projections are computed on every rank (one
    row); only the owner rank (p % ncp) writes its KV slot, with an index
    copy; the query attends every rank's slots through kernel 18's
    partials, merged across the group by all_reduce.

Each layer is the reference's: one `matmul` per projection (kernel 1, 13
or 17 by the weight's kind, the RMSNorm fused), then Wo and the SwiGLU
FFN as two matmuls and a SiLU (never kernel 2).  Sampling runs on every
rank over the same logits from generators seeded alike, so every rank
draws the same token and nothing is broadcast.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import (
    KVCache,
    LayerParams,
    LlamaParams,
    _qkv,
    logits_from_hidden,
)
from tokenhawk_tpu_torch.ops.linear import matmul
from tokenhawk_tpu_torch.ops.rope import rope_cos_sin
from tokenhawk_tpu_torch.parallel.mesh import CtxMesh
from tokenhawk_tpu_torch.parallel.ring import decode_attend_cp, ring_attention
from tokenhawk_tpu_torch.runtime.engine import make_decode_fn


def validate_cp(cfg: LlamaConfig, ncp: int, max_seq: int):
    if max_seq % ncp:
        raise ValueError(f"cp={ncp} must divide max_seq={max_seq}")


def shard_cache_cp(cache: KVCache, mesh: CtxMesh) -> KVCache:
    """This rank's slice of a whole-sequence cache: its positions
    {index, index + ncp, ...} as local slots 0, 1, ... (copies)."""
    i, n = mesh.index, mesh.ncp
    return KVCache([k[:, :, i::n].contiguous() for k in cache.k],
                   [v[:, :, i::n].contiguous() for v in cache.v])


def _shard_count(length: torch.Tensor, idx: int, ncp: int) -> torch.Tensor:
    """Positions p < length with p % ncp == idx (valid slots of a shard)."""
    return torch.clamp((length - idx + ncp - 1) // ncp, min=0)


# ---------------------------------------------------------------------------
# Layer bodies (every rank of the ctx group)
# ---------------------------------------------------------------------------


def _ffn(cfg: LlamaConfig, lp: LayerParams, x: torch.Tensor) -> torch.Tensor:
    eps = cfg.rms_norm_eps
    if lp.w13 is not None:
        gu = matmul(x, lp.w13, lp.ffn_norm, eps=eps)
        F = gu.shape[-1] // 2
        g, u = gu[..., :F], gu[..., F:]
    else:
        g = matmul(x, lp.w1, lp.ffn_norm, eps=eps)
        u = matmul(x, lp.w3, lp.ffn_norm, eps=eps)
    gate = torch.nn.functional.silu(g.float()).to(x.dtype)
    return x + matmul(gate * u, lp.w2)


def _prefill_layer_cp(cfg, mesh, x, lp, kc, vc, cos, sin):
    """One layer over this rank's cyclic query slice; its K / V go to local
    slots [0, T_loc)."""
    B, T_loc, D = x.shape
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    k_blk = k.transpose(1, 2).to(kc.dtype).contiguous()  # [B, Hkv, T_loc, Dh]
    v_blk = v.transpose(1, 2).to(vc.dtype).contiguous()
    kc[:, :, :T_loc] = k_blk
    vc[:, :, :T_loc] = v_blk
    ctx = ring_attention(q.transpose(1, 2), k_blk, v_blk, mesh, layout="cyclic")
    x = x + matmul(ctx.transpose(1, 2).reshape(B, T_loc, D), lp.wo)
    return _ffn(cfg, lp, x)


def _decode_layer_cp(cfg, mesh, x, lp, kc, vc, cos, sin, offsets):
    """One decode layer: the projections on every rank, the new row written
    by its owner rank, attention over every rank's slots."""
    B, _, D = x.shape
    ncp = mesh.ncp
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    # Owner-predicated write: every rank rewrites slot p // ncp, the owner
    # with the new row, the others with what the slot held.
    b = torch.arange(B, device=x.device)
    slot = (offsets // ncp).long()
    owner = ((offsets % ncp) == mesh.index)[:, None, None]
    kc[b, :, slot] = torch.where(owner, k[:, 0].to(kc.dtype), kc[b, :, slot])
    vc[b, :, slot] = torch.where(owner, v[:, 0].to(vc.dtype), vc[b, :, slot])
    shard_lengths = _shard_count(offsets + 1, mesh.index, ncp).to(torch.int32)
    ctx = decode_attend_cp(q[:, 0], kc, vc, shard_lengths, mesh)
    x = x + matmul(ctx.reshape(B, 1, D), lp.wo)
    return _ffn(cfg, lp, x)


def forward_cp_decode(cfg: LlamaConfig, mesh: CtxMesh, params: LlamaParams,
                      tokens: torch.Tensor, cache: KVCache, offsets: torch.Tensor):
    """One decode token [B, 1] at positions `offsets` through every layer:
    (hidden [B, 1, D], cache updated in place), as models/llama.py
    `forward` for the dense cache."""
    x = params.tok_embd[tokens]
    cos, sin = rope_cos_sin(offsets.long()[:, None], cfg.head_dim, cfg.rope_theta)
    for lp, kc, vc in zip(params.layers, cache.k, cache.v):
        x = _decode_layer_cp(cfg, mesh, x, lp, kc, vc, cos, sin, offsets)
    return x, cache


# ---------------------------------------------------------------------------
# Step functions (runtime/engine.py signatures)
# ---------------------------------------------------------------------------


def make_cp_prefill_fn(cfg: LlamaConfig, mesh: CtxMesh):
    """fn: (params, cache, tokens [B, T], lengths [B], offsets [B]) ->
    (cache, last_logits [B, V] f32).  Every rank gets the whole block and
    takes its cyclic slice; T must be a multiple of ncp.  Offsets must be
    zero (CP prefills from the start; a continuation goes through decode),
    as in the reference."""
    ncp, idx = mesh.ncp, mesh.index

    @torch.inference_mode()
    def prefill(params, cache, tokens, lengths, offsets):
        B, T = tokens.shape
        T_loc = T // ncp
        cols = idx + torch.arange(T_loc, device=tokens.device) * ncp  # this rank's positions
        x = params.tok_embd[tokens[:, cols]]
        cos, sin = rope_cos_sin(cols.expand(B, T_loc), cfg.head_dim, cfg.rope_theta)
        for lp, kc, vc in zip(params.layers, cache.k, cache.v):
            x = _prefill_layer_cp(cfg, mesh, x, lp, kc, vc, cos, sin)
        # The last valid token's hidden state lives on rank (lengths-1) % ncp.
        last = lengths.long() - 1
        slot = torch.clamp(last // ncp, 0, T_loc - 1)
        h = x[torch.arange(B, device=x.device), slot]
        h = torch.where(((last % ncp) == idx)[:, None], h, 0.0)
        dist.all_reduce(h, group=mesh.group)
        return cache, logits_from_hidden(cfg, params, h)

    return prefill


def make_cp_decode_fn(cfg: LlamaConfig, mesh: CtxMesh, sampling: SamplingConfig,
                      chunk: int, eos_id=2):
    """runtime/engine.py make_decode_fn over forward_cp_decode."""

    def forward(cfg, params, tokens, cache, offsets):
        return forward_cp_decode(cfg, mesh, params, tokens, cache, offsets)

    return make_decode_fn(cfg, sampling, chunk, eos_id, forward=forward)
