"""Kernels 4 and 19: causal flash attention (csrc/flash_attention.cu).

Replaces tokenhawk_tpu/ops/pallas/flash_attention.py `flash_attention`
(_kernel), reached through `attend_prefill`.  The query at absolute
position offsets[b] + t attends to cache slots at or before it, online
softmax in f32, tiles past the block's diagonal skipped; head dim 64 or
128.  On the H100 a
prefill's attention is a small share of its FLOPs next to the
projections; this first kernel runs on the CUDA cores with K/V tiles
staged in shared memory, and tensor-core tiles come later.

Kernel 19, `flash_attention_stats`, replaces flash_attention.py
`flash_attention_stats` (_kernel_stats), the ring-attention step of
context parallelism (parallel/ring.py): kernel 4's walk over a visiting
KV block at affine positions (query t at q_start + stride*t, key j at
k_start + stride*j), returning the unnormalised o, m and l in f32 for the
cross-shard merge.  A row that sees no key of the block gets
(0, _MASK, 0); the Pallas kernel's such rows inside a partly visible tile
carry exp(0) = 1 per slot instead (tile-dependent), and both merge to the
same result.  The TPU kernel's 128-lane copies of m and l are dropped.

Tolerance against the plain versions: f32 in both, another summation
order (kernel 4: one rounding to q.dtype).
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.attention import attend_cache, attend_stats
from tokenhawk_tpu_torch.ops.cuda import build

launches = {"flash_attention": 0, "flash_attention_stats": 0}
HEAD_DIMS = (64, 128)

_ARGS = [build.P] * 5 + [build.I] * 8 + [build.P]
# q, k, v, q_start, k_start; stride; o, m, l; B, Hkv, rep, Dh, T, S, cache dtype; stream.
_STATS_ARGS = [build.P] * 5 + [build.I] + [build.P] * 3 + [build.I] * 7 + [build.P]


def flash_attention_plain(q, k_cache, v_cache, offsets):
    """The same function in plain PyTorch."""
    B, Hkv, rep, T, Dh = q.shape
    qt = q.permute(0, 3, 1, 2, 4).reshape(B, T, Hkv * rep, Dh)
    pos = offsets.to(q.device).long()[:, None] + torch.arange(T, device=q.device)
    out = attend_cache(qt, k_cache, v_cache, pos, scale=1.0)
    return out.reshape(B, T, Hkv, rep, Dh).permute(0, 2, 3, 1, 4).contiguous()


def flash_attention(q, k_cache, v_cache, offsets):
    """q [B, Hkv, rep, T, Dh] (pre-scaled), caches [B, Hkv, S, Dh],
    offsets [B] int32 -> out [B, Hkv, rep, T, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_attention_plain(q, k_cache, v_cache, offsets)
    B, Hkv, rep, T, Dh = q.shape
    S = k_cache.shape[2]
    build.require(Dh in HEAD_DIMS, f"head dim {Dh} not in {HEAD_DIMS}")
    build.require(k_cache.shape == (B, Hkv, S, Dh) and v_cache.shape == k_cache.shape,
                  f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    build.require(offsets.dtype == torch.int32 and offsets.shape == (B,),
                  "offsets must be int32 [B]")
    build.require(k_cache.dtype == v_cache.dtype, "k and v caches differ in dtype")
    q = q.contiguous()
    build.require_cuda(q, k_cache, v_cache, offsets)
    out = torch.empty_like(q)
    fn = build.function("th_flash_prefill", _ARGS)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), B, Hkv, rep, Dh, T, S, build.dtype_code(q.dtype),
            build.dtype_code(k_cache.dtype), build.stream_of(q))
    build.check(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out


def flash_attention_stats_plain(q, k_block, v_block, q_start, k_start, stride: int = 1):
    """Kernel 19's function in plain PyTorch."""
    T, S = q.shape[3], k_block.shape[2]
    dev = q.device
    qpos = q_start.to(dev).long()[:, None] + stride * torch.arange(T, device=dev)
    kpos = k_start.to(dev).long()[:, None] + stride * torch.arange(S, device=dev)
    return attend_stats(q, k_block, v_block, kpos[:, None, :] <= qpos[:, :, None])


def flash_attention_stats(q, k_block, v_block, q_start, k_start, stride: int = 1):
    """Kernel 19.  q [B, Hkv, rep, T, Dh] f32 (pre-scaled), K / V blocks
    [B, Hkv, S, Dh], q_start / k_start [B] int32 positions of q[..., 0, :]
    and of row 0 of the blocks, rows `stride` positions apart -> (o
    [B, Hkv, rep, T, Dh], m [B, Hkv, rep, T], l [B, Hkv, rep, T]) f32."""
    if not q.is_cuda:
        return flash_attention_stats_plain(q, k_block, v_block, q_start, k_start, stride)
    B, Hkv, rep, T, Dh = q.shape
    S = k_block.shape[2]
    build.require(Dh in HEAD_DIMS, f"head dim {Dh} not in {HEAD_DIMS}")
    build.require(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    build.require(k_block.shape == (B, Hkv, S, Dh) and v_block.shape == k_block.shape,
                  f"KV block {tuple(k_block.shape)} does not match q {tuple(q.shape)}")
    build.require(k_block.dtype == v_block.dtype, "k and v blocks differ in dtype")
    for name, st in (("q_start", q_start), ("k_start", k_start)):
        build.require(st.dtype == torch.int32 and st.shape == (B,), f"{name} must be int32 [B]")
    build.require(stride >= 1, f"stride must be positive, got {stride}")
    q = q.contiguous()
    build.require_cuda(q, k_block, v_block, q_start, k_start)
    o = torch.empty_like(q)
    m = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = build.function("th_flash_attention_stats", _STATS_ARGS)
    rc = fn(q.data_ptr(), k_block.data_ptr(), v_block.data_ptr(), q_start.data_ptr(),
            k_start.data_ptr(), stride, o.data_ptr(), m.data_ptr(), l.data_ptr(), B, Hkv, rep,
            Dh, T, S, build.dtype_code(k_block.dtype), build.stream_of(q))
    build.check(rc, "flash_attention_stats")
    launches["flash_attention_stats"] += 1
    return o, m, l
