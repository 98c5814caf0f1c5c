"""Kernels 3 and 14: decode attention over the dense KV cache (csrc/flash_decode.cu).

  flash_decode_append  kernel 3, replaces tokenhawk_tpu/ops/pallas/
                       flash_decode_dma.py `flash_decode_append_walk`
                       (_kernel_walk_append) and its grid form
                       `flash_decode_append` (_kernel_vec_append): writes
                       k_new / v_new at slot lengths-1 of each sequence's
                       cache in place, then attends over lengths tokens;
  flash_decode         kernel 14, replaces `flash_decode_dma` (_kernel,
                       _kernel_vec), `flash_decode_loop` (_kernel_loop) and
                       ops/pallas/flash_decode.py `flash_decode` (_kernel,
                       via attend_decode): the same attention, no write.
                       Dense-weight models decode through it, after an
                       index copy of the new row (models/llama.py
                       _attend_and_update).

Both run one kernel body: one block per (sequence, kv head) reads only
the live 32-token tiles, so on the H100 they are bound by the bytes of
the live cache rows.  Kernel 3's block writes the row it then reads, and
a barrier orders the two.  Head dim 64 or 128; 1, 2, 4 or 8 query heads
per kv head.  Launches are counted per kernel: `launches["flash_decode"]`
(kernel 3) and `launches["flash_decode_attend"]` (kernel 14).

Tolerance against the plain versions: f32 scores and softmax in both;
the kernel's online softmax sums in another order (~1e-6 relative) and
both round once to q.dtype.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.attention import attend_cache
from tokenhawk_tpu_torch.ops.cuda import build

launches = {"flash_decode": 0, "flash_decode_attend": 0}
HEAD_DIMS = (64, 128)
REPS = (1, 2, 4, 8)

_APPEND_ARGS = [build.P] * 7 + [build.I] * 7 + [build.P]
_ATTEND_ARGS = [build.P] * 5 + [build.I] * 7 + [build.P]


def _attend(q, k_cache, v_cache, L):
    """q [B, Hkv, rep, Dh] over the first L[b] rows of each cache, f32."""
    B, Hkv, rep, Dh = q.shape
    out = attend_cache(q.reshape(B, 1, Hkv * rep, Dh), k_cache, v_cache, (L - 1)[:, None],
                       scale=1.0)
    return out.reshape(B, Hkv, rep, Dh)


def flash_decode_plain(q, k_cache, v_cache, lengths):
    """Kernel 14's function in plain PyTorch: q [B, Hkv, rep, Dh] over the
    first clamp(lengths, 1, S) rows of each sequence's cache."""
    S = k_cache.shape[2]
    return _attend(q, k_cache, v_cache, lengths.to(k_cache.device).long().clamp(1, S))


def flash_decode_append_plain(q, k_new, v_new, k_cache, v_cache, lengths):
    """Kernel 3's function in plain PyTorch (cache updated in place)."""
    B = q.shape[0]
    S = k_cache.shape[2]
    L = lengths.to(k_cache.device).long().clamp(1, S)
    bi = torch.arange(B, device=k_cache.device)
    k_cache[bi, :, L - 1] = k_new.to(k_cache.dtype)
    v_cache[bi, :, L - 1] = v_new.to(v_cache.dtype)
    return _attend(q, k_cache, v_cache, L)


def _check(q, k_cache, v_cache, lengths):
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    build.require(Dh in HEAD_DIMS, f"head dim {Dh} not in {HEAD_DIMS}")
    build.require(rep in REPS, f"query heads per kv head {rep} not in {REPS}")
    build.require(k_cache.shape == (B, Hkv, S, Dh) and v_cache.shape == k_cache.shape,
                  f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                  "lengths must be int32 [B]")
    build.require(k_cache.dtype == v_cache.dtype, "k and v caches differ in dtype")
    return B, Hkv, rep, Dh, S


def flash_decode(q, k_cache, v_cache, lengths):
    """Kernel 14.  q [B, Hkv, rep, Dh] (pre-scaled), caches [B, Hkv, S, Dh]
    (read only), lengths [B] int32 live tokens (clamped to [1, S]) ->
    out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, lengths)
    B, Hkv, rep, Dh, S = _check(q, k_cache, v_cache, lengths)
    q = q.contiguous()
    build.require_cuda(q, k_cache, v_cache, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_decode_attend", _ATTEND_ARGS)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Hkv, rep, Dh, S, build.dtype_code(q.dtype),
            build.dtype_code(k_cache.dtype), build.stream_of(q))
    build.check(rc, "flash_decode")
    launches["flash_decode_attend"] += 1
    return out


def flash_decode_append(q, k_new, v_new, k_cache, v_cache, lengths):
    """Kernel 3.  q [B, Hkv, rep, Dh] (pre-scaled), k_new/v_new [B, Hkv, Dh],
    caches [B, Hkv, S, Dh] (written in place), lengths [B] int32 valid
    tokens including the new one -> out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_append_plain(q, k_new, v_new, k_cache, v_cache, lengths)
    B, Hkv, rep, Dh, S = _check(q, k_cache, v_cache, lengths)
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == (B, Hkv, Dh),
                  f"new rows {tuple(k_new.shape)} do not match q {tuple(q.shape)}")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    build.require_cuda(q, k_new, v_new, k_cache, v_cache, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_decode_append", _APPEND_ARGS)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, Hkv, rep, Dh, S,
            build.dtype_code(q.dtype), build.dtype_code(k_cache.dtype), build.stream_of(q))
    build.check(rc, "flash_decode_append")
    launches["flash_decode"] += 1
    return out
