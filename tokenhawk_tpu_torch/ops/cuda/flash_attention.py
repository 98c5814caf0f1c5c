"""Kernel 4: causal prefill flash attention (csrc/flash_attention.cu).

Replaces tokenhawk_tpu/ops/pallas/flash_attention.py `flash_attention`
(_kernel), reached through `attend_prefill`.  The query at absolute
position offsets[b] + t attends to cache slots at or before it, online
softmax in f32, tiles past the block's diagonal skipped; head dim 64 or
128.  On the H100 a
prefill's attention is a small share of its FLOPs next to the
projections; this first kernel runs on the CUDA cores with K/V tiles
staged in shared memory, and tensor-core tiles come later.

Tolerance against the plain version: f32 in both, another summation
order, one rounding to q.dtype.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.attention import attend_cache
from tokenhawk_tpu_torch.ops.cuda import build

launches = {"flash_attention": 0}
HEAD_DIMS = (64, 128)

_ARGS = [build.P] * 5 + [build.I] * 8 + [build.P]


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
