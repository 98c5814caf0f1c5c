"""Kernel 3: decode append + attend (csrc/flash_decode.cu).

Replaces tokenhawk_tpu/ops/pallas/flash_decode_dma.py
`flash_decode_append_walk` (_kernel_walk_append) and its grid form
`flash_decode_append` (_kernel_vec_append).  Writes k_new / v_new at slot
lengths-1 of each sequence's cache in place, then attends over lengths
tokens.  On the H100 it is bound by the bytes of the live cache rows: one
block per (sequence, kv head) reads only the live 32-token tiles, and
because the block that writes a head's row is the block that reads it,
a barrier orders the write before the reads.

Tolerance against the plain version: f32 scores and softmax in both; the
kernel's online softmax sums in another order (~1e-6 relative) and both
round once to q.dtype.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.attention import attend_cache
from tokenhawk_tpu_torch.ops.cuda import build

launches = {"flash_decode": 0}
HEAD_DIM = 128
REPS = (1, 2, 4, 8)

_ARGS = [build.P] * 7 + [build.I] * 6 + [build.P]


def flash_decode_append_plain(q, k_new, v_new, k_cache, v_cache, lengths):
    """The same function in plain PyTorch (cache updated in place)."""
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    L = lengths.to(k_cache.device).long().clamp(1, S)
    bi = torch.arange(B, device=k_cache.device)
    k_cache[bi, :, L - 1] = k_new.to(k_cache.dtype)
    v_cache[bi, :, L - 1] = v_new.to(v_cache.dtype)
    out = attend_cache(q.reshape(B, 1, Hkv * rep, Dh), k_cache, v_cache, (L - 1)[:, None],
                       scale=1.0)
    return out.reshape(B, Hkv, rep, Dh)


def flash_decode_append(q, k_new, v_new, k_cache, v_cache, lengths):
    """q [B, Hkv, rep, Dh] (pre-scaled), k_new/v_new [B, Hkv, Dh],
    caches [B, Hkv, S, Dh] (written in place), lengths [B] int32 valid
    tokens including the new one -> out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_append_plain(q, k_new, v_new, k_cache, v_cache, lengths)
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    build.require(Dh == HEAD_DIM, f"head dim {Dh} != {HEAD_DIM}")
    build.require(rep in REPS, f"query heads per kv head {rep} not in {REPS}")
    build.require(k_cache.shape == (B, Hkv, S, Dh) and v_cache.shape == k_cache.shape,
                  f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == (B, Hkv, Dh),
                  f"new rows {tuple(k_new.shape)} do not match q {tuple(q.shape)}")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                  "lengths must be int32 [B]")
    build.require(k_cache.dtype == v_cache.dtype, "k and v caches differ in dtype")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    build.require_cuda(q, k_new, v_new, k_cache, v_cache, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_decode_append", _ARGS)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, Hkv, rep, S,
            build.dtype_code(q.dtype), build.dtype_code(k_cache.dtype), build.stream_of(q))
    build.check(rc, "flash_decode_append")
    launches["flash_decode"] += 1
    return out
