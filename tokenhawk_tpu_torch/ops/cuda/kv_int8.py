"""Kernels 8 and 9: attention over the dense int8 KV cache (csrc/kv_int8.cu).

  flash_decode_int8     replaces tokenhawk_tpu/ops/pallas/flash_decode_int8.py
                        `flash_decode_int8` (_kernel) and the
                        `update_kv_cache_int8` its caller runs first: the new
                        K / V rows are quantized and written at slot
                        lengths-1, then the query attends over lengths tokens;
  flash_attention_int8  replaces tokenhawk_tpu/ops/pallas/flash_attention_int8.py
                        `flash_attention_int8` (_kernel), reached through
                        `attend_prefill_int8`: causal prefill over the cache.

The cache is int8 codes [B, Hkv, S, Dh] with bfloat16 scales [B, Hkv, S]
(ops/kvquant.py), Dh 64 or 128.  Both kernels compute exact attention over the
dequantized cache; the TPU decode kernel also quantizes the query and the
probabilities to int8 for its matrix unit, which adds about 0.4% relative
error (ROADMAP Queue 3).  Their plain version is `attend_cache_int8`.  On
the H100 decode is bound by the bytes of the live codes and scales (about
half of kernel 3's): it runs kernel 3's shared-memory tile walk
(csrc/decode_tiles.cuh) over int8 rows, codes and scales copied together
into shared memory, each code widened to f32 times its row's scale where
it is used, in clusters of `decode_int8_splits` blocks where the
(sequence, KV head) pairs leave SMs idle (kernel 3's rule from shapes
only, at most one block an SM), the ranges cut on the card and merged on
chip; counted in `launches["flash_decode_int8"]`, the split form also in
`["flash_decode_int8_split"]`.  Prefill is bound by its FLOPs: with bf16
q it runs kernel 4's tensor-core walk (csrc/prefill_tc.cuh) over int8
tiles, the codes copied at one byte each and widened to bf16 in shared
memory, counted in `launches["flash_attention_int8_tc"]`; with f32 q the
CUDA-core walk, counted in `launches["flash_attention_int8"]`.

Tolerance against the plain versions: f32 scores and softmax in both over
the same dequantized values (a code times a bfloat16 scale is exact in
f32), another summation order (the split form also merges its ranges in
split order), one rounding to q.dtype; the tensor-core prefill also rounds
P (after the V-scale fold) to bf16 before P·V.  The rows the decode kernel
appends match `quantize_kv_block` bit for bit.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.flash_decode import APPEND_MIN_TILES, MAX_SPLITS, decode_splits
from tokenhawk_tpu_torch.ops.kvquant import attend_cache_int8, quantize_kv_block

launches = {"flash_decode_int8": 0, "flash_decode_int8_split": 0, "flash_attention_int8": 0,
            "flash_attention_int8_tc": 0}
HEAD_DIMS = (64, 128)
REPS = (1, 2, 4, 8)
# Kernel 8's split count caps its blocks at one an SM, kernel 3's at two
# (BLOCKS_PER_SM): a cluster of 8 cost it 10-44% against a cluster of 4 at
# LLaMA-7B's heads at B=1 on an H100 at 700 W (experiments/decode_rows.py
# --sweep, ms at 4 and 8 splits: 2048 live rows 0.0176 / 0.0194, 512
# 0.0081 / 0.0114, 300 0.0072 / 0.0104); at TinyLlama's 4 KV heads both
# give 16.
INT8_BLOCKS_PER_SM = 1

# q, k_new, v_new, the cache (4), lengths, out; B, Hkv, rep, Dh, S, splits,
# min_tiles, q dtype; stream.
_DECODE_ARGS = [build.P] * 9 + [build.I] * 8 + [build.P]
_PREFILL_ARGS = [build.P] * 7 + [build.I] * 6 + [build.P]
_PREFILL_TC_ARGS = [build.P] * 7 + [build.I] * 5 + [build.P]


def _check_cache(k_cache, ks_cache, v_cache, vs_cache, B, Hkv, Dh):
    S = k_cache.shape[2]
    build.require(Dh in HEAD_DIMS, f"head dim {Dh} not in {HEAD_DIMS}")
    build.require(k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8,
                  "the cache codes must be int8")
    build.require(ks_cache.dtype == torch.bfloat16 and vs_cache.dtype == torch.bfloat16,
                  "the cache scales must be bfloat16")
    build.require(k_cache.shape == (B, Hkv, S, Dh) and v_cache.shape == k_cache.shape
                  and ks_cache.shape == (B, Hkv, S) and vs_cache.shape == ks_cache.shape,
                  f"cache {tuple(k_cache.shape)} / {tuple(ks_cache.shape)} does not match "
                  f"B={B} Hkv={Hkv} Dh={Dh}")
    return S


# -- kernel 8: decode append + attend ----------------------------------------


def flash_decode_int8_plain(q, k_new, v_new, k_cache, ks_cache, v_cache, vs_cache, lengths):
    """The same function in plain PyTorch (cache updated in place)."""
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    L = lengths.to(k_cache.device).long().clamp(max=S)
    live = L > 0
    bi = torch.arange(B, device=k_cache.device)[live]
    at = L[live] - 1
    for cache, scales, new in ((k_cache, ks_cache, k_new), (v_cache, vs_cache, v_new)):
        codes, s = quantize_kv_block(new[live])
        cache[bi, :, at] = codes
        scales[bi, :, at] = s
    out = attend_cache_int8(q.reshape(B, 1, Hkv * rep, Dh), k_cache, ks_cache, v_cache,
                            vs_cache, (L - 1)[:, None], scale=1.0)
    out = torch.where(live[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(B, Hkv, rep, Dh)


def flash_decode_int8(q, k_new, v_new, k_cache, ks_cache, v_cache, vs_cache, lengths):
    """q [B, Hkv, rep, Dh] (pre-scaled), k_new / v_new [B, Hkv, Dh], the
    int8 cache (written in place), lengths [B] int32 valid tokens including
    the new one -> out [B, Hkv, rep, Dh] in q.dtype.  A row of length 0
    appends nothing and gives zeros."""
    if not q.is_cuda:
        return flash_decode_int8_plain(q, k_new, v_new, k_cache, ks_cache, v_cache, vs_cache,
                                       lengths)
    B, Hkv = q.shape[:2]
    return flash_decode_int8_at(
        q, k_new, v_new, k_cache, ks_cache, v_cache, vs_cache, lengths,
        decode_int8_splits(B, Hkv, k_cache.shape[2], build.sm_count(q.device)))


def decode_int8_splits(B: int, Hkv: int, S: int, sm_count: int) -> int:
    """Kernel 8's split count: kernel 3's rule (decode_splits, from the
    host's shapes alone, ranges of at least APPEND_MIN_TILES tiles) at
    INT8_BLOCKS_PER_SM blocks an SM."""
    return decode_splits(B, Hkv, S, sm_count, APPEND_MIN_TILES, INT8_BLOCKS_PER_SM)


def flash_decode_int8_at(q, k_new, v_new, k_cache, ks_cache, v_cache, vs_cache, lengths,
                         splits: int, min_tiles: int = APPEND_MIN_TILES):
    """Kernel 8 at a given split count (1 to MAX_SPLITS), its ranges at
    least min_tiles tiles: what flash_decode_int8 launches with
    decode_int8_splits' count; chip_smoke.py times splits = 1 beside it.
    CUDA tensors only."""
    B, Hkv, rep, Dh = q.shape
    build.require(rep in REPS, f"query heads per kv head {rep} not in {REPS}")
    S = _check_cache(k_cache, ks_cache, v_cache, vs_cache, B, Hkv, Dh)
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == (B, Hkv, Dh),
                  f"new rows {tuple(k_new.shape)} do not match q {tuple(q.shape)}")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                  "lengths must be int32 [B]")
    build.require(1 <= splits <= MAX_SPLITS, f"splits {splits} not in 1..{MAX_SPLITS}")
    build.require(min_tiles >= 1, f"min_tiles must be positive, got {min_tiles}")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    build.require_cuda(q, k_new, v_new, k_cache, ks_cache, v_cache, vs_cache, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_flash_decode_int8", _DECODE_ARGS)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            ks_cache.data_ptr(), v_cache.data_ptr(), vs_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Hkv, rep, Dh, S, splits, min_tiles, build.dtype_code(q.dtype),
            build.stream_of(q))
    build.check(rc, "flash_decode_int8")
    launches["flash_decode_int8"] += 1
    if splits > 1:
        launches["flash_decode_int8_split"] += 1
    return out


# -- kernel 9: causal prefill --------------------------------------------------


def flash_attention_int8_plain(q, k_cache, ks_cache, v_cache, vs_cache, offsets):
    """The same function in plain PyTorch."""
    B, Hkv, rep, T, Dh = q.shape
    qt = q.permute(0, 3, 1, 2, 4).reshape(B, T, Hkv * rep, Dh)
    pos = offsets.to(q.device).long()[:, None] + torch.arange(T, device=q.device)
    out = attend_cache_int8(qt, k_cache, ks_cache, v_cache, vs_cache, pos, scale=1.0)
    return out.reshape(B, T, Hkv, rep, Dh).permute(0, 2, 3, 1, 4).contiguous()


def flash_attention_int8(q, k_cache, ks_cache, v_cache, vs_cache, offsets):
    """q [B, Hkv, rep, T, Dh] (pre-scaled), the int8 cache, offsets [B]
    int32: the query at offsets[b] + t attends to slots at or before it ->
    out [B, Hkv, rep, T, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_attention_int8_plain(q, k_cache, ks_cache, v_cache, vs_cache, offsets)
    B, Hkv, rep, T, Dh = q.shape
    S = _check_cache(k_cache, ks_cache, v_cache, vs_cache, B, Hkv, Dh)
    build.require(offsets.dtype == torch.int32 and offsets.shape == (B,),
                  "offsets must be int32 [B]")
    q = q.contiguous()
    build.require_cuda(q, k_cache, ks_cache, v_cache, vs_cache, offsets)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), ks_cache.data_ptr(), v_cache.data_ptr(),
            vs_cache.data_ptr(), offsets.data_ptr(), out.data_ptr(), B, Hkv, rep, Dh, T, S)
    if q.dtype == torch.bfloat16:
        walk = "flash_attention_int8_tc"
        rc = build.function("th_flash_attention_int8_tc", _PREFILL_TC_ARGS)(
            *ptrs, build.stream_of(q))
    else:
        walk = "flash_attention_int8"
        rc = build.function("th_flash_attention_int8", _PREFILL_ARGS)(
            *ptrs, build.dtype_code(q.dtype), build.stream_of(q))
    build.check(rc, walk)
    launches[walk] += 1
    return out
