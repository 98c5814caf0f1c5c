"""Kernels 3, 14, 16 and 18: decode attention over the dense KV cache
(csrc/decode_append.cu, csrc/flash_decode.cu, csrc/attn_wo.cu, csrc/decode_stats.cu).

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

Both read only the live 32-token tiles, so on the H100 they are bound by
the bytes of the live cache rows.  Kernel 14's block walks its tiles one
V row a step from device memory; kernel 3's walk (csrc/decode_tiles.cuh,
shared with kernels 18 and 5) brings its block's whole range of K/V rows
into shared memory by asynchronous copies before any arithmetic, then
computes from there with all 8 warps; the block whose range holds the
new row writes it to the cache and takes it into its tile from k_new /
v_new.  Head dim 64 or 128; 1, 2, 4 or 8 query heads per kv head.
Launches are counted per kernel: `launches["flash_decode"]` (kernel 3)
and `launches["flash_decode_attend"]` (kernel 14).

Kernels 3 and 14 where the (sequence, kv head) pairs leave most SMs idle
(a TinyLlama-width draft's 4 KV heads at B=1 run 4 blocks on 132 SMs, the
7B's 32 at B=1 32 blocks) cut
each pair's live rows into `decode_splits` tile-aligned ranges, one block
each in a thread-block cluster of the pair's blocks: kernel 14's body over
each range (kernel 3: its tile walk), then the cluster merges the
partials over distributed shared memory and rounds once
(csrc/flash_decode.cu decode_split_kernel; kernel 3 pushes each block's
partials into block 0 of the cluster, csrc/decode_tiles.cuh).  The
split count comes from the shapes the host knows (B, Hkv, S and the SM
count), never from `lengths`, so the decode path stays free of host
syncs; the ranges are computed on the device from `lengths`, none
shorter than MIN_SPLIT_TILES tiles (kernel 3: APPEND_MIN_TILES) (a short
live length fills the first ranges and leaves the rest empty).  Those launches also count in
`launches["flash_decode_split"]` (kernel 14) and
`launches["flash_decode_append_split"]` (kernel 3).

Kernel 18, `flash_decode_stats`, replaces flash_decode_dma.py
`flash_decode_stats` (_kernel_vec_stats), one shard's half of
context-parallel decode (parallel/ring.py decode_attend_cp): the same
attention without the final normalisation, returning the unnormalised o,
m and l in f32; a sequence of length 0 gives the merge identity
(0, -inf, 0) exactly.  The cache may be a strided view (one cyclic shard of
a larger cache).  It runs kernel 3's tile walk (csrc/decode_stats.cu over
csrc/decode_tiles.cuh).  `splits` > 1 cuts each sequence's live rows into
that many tile-aligned ranges, one block each, for the caller to merge;
with `splits` 1 where the (sequence, kv head) pairs leave SMs idle (CP
decode at B=1) the one range is cut over a thread-block cluster of
`decode_splits(..., APPEND_MIN_TILES)` blocks, ranges cut on the card as
kernel 3's, and merged on chip into one unnormalised partial.  Counted as
`launches["flash_decode_stats"]`, the cluster form also in
`["flash_decode_stats_split"]`.

Kernel 16, `fused_attn_out`, replaces tokenhawk_tpu/ops/pallas/
attn_block.py `fused_attn_out` (_attn_wo): the attention block of one
decode token of one sequence with one query per kv head, x + attend(q,
cache + new row) @ Wo, the new K / V rows written in place.  Two launches
on one stream (csrc/attn_wo.cu th_attn_wo): kernel 3's tile walk (q scaled
in the block by 1/sqrt(Dh) in q's type, an f32 context; split by
`decode_splits` as kernel 3 is), then Wo on the decode-row walk at one row
over that context with x in its epilogue (`qmatmul.stream_plan`'s plan), a
programmatic dependent of the attention launch.  Off by default, as in the
reference: the model takes it where `can_fuse_attn_out` passes and its
Fusions ask for it (THAWK_FUSED_ATTN=1).  Counted as `launches["attn_wo"]`,
the cluster form also in `["attn_wo_split"]`, the Wo walk's launch in
`["attn_wo_stream"]`; `fused_attn_out_at` forces the split count and Wo's
plan.

Tolerance against the plain versions: f32 scores and softmax in both;
the kernel's online softmax sums in another order (~1e-6 relative; the
split forms also merge their ranges' partials in split order) and both
round once to q.dtype (kernel 16: once to x.dtype, after the Wo
product).
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.attention import attend_cache, attend_stats
from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.qmatmul import forced_plan, form_code, stream_plan, weight_args
from tokenhawk_tpu_torch.ops.qweight import QWeight

launches = {"flash_decode": 0, "flash_decode_append_split": 0, "flash_decode_attend": 0,
            "flash_decode_split": 0, "flash_decode_stats": 0, "flash_decode_stats_split": 0,
            "attn_wo": 0, "attn_wo_split": 0, "attn_wo_stream": 0}
HEAD_DIMS = (64, 128)
REPS = (1, 2, 4, 8)
# Kernel 14's split form: at most 16 blocks a cluster (above 8 the
# cluster is not portable; the launch allows it), each range at least
# MIN_SPLIT_TILES tiles of 32 rows (of S on the host, of the live rows on
# the card), and at most BLOCKS_PER_SM blocks
# an SM in all (two of its 256-thread blocks, at most 128 registers a
# thread, fit an SM at once).  From a sweep on an H100 (chip_smoke.py phase 2):
# ranges of 4 tiles run as fast as ranges of 8 (2 and 1 tiles slower), and
# the draft's 8 slots ran 22% faster in 8 splits (256 blocks) than in 4.
MAX_SPLITS = 16
MIN_SPLIT_TILES = 4
BLOCKS_PER_SM = 2
# The tile walk's ranges (kernels 3, 18 and 5): at least 2 tiles (one
# 64-row chunk of the walk).  Kernel 3's sweep on an H100 (chip_smoke.py
# phase 2, the 7B's heads at B=1): ranges of 2 tiles ran 5-6% faster than
# 4 at 300 and 512 live rows, 1 tile slower.
APPEND_MIN_TILES = 2

_APPEND_ARGS = [build.P] * 7 + [build.I] * 9 + [build.P]
_ATTEND_ARGS = [build.P] * 5 + [build.I] * 9 + [build.P]
# q, k, v, lengths, o, m, l; B, Hkv, rep, Dh, S, splits; strides; cluster,
# min_tiles, dtype; stream.
_STATS_ARGS = [build.P] * 7 + [build.I] * 6 + [build.LL] * 3 + [build.I] * 3 + [build.P]
# q, k_new, v_new, kc, vc, lengths, x; wo (qs, scales, mins, hi, form); ctx,
# y; H, Dh, S, D; q_scale; splits, min_tiles; Wo's plan; q and cache dtypes;
# stream.
_ATTN_WO_ARGS = [build.P] * 11 + [build.I] + [build.P] * 2 + [build.I] * 4 + [
    build.F] + [build.I] * 8 + [build.P]


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


def decode_splits(B: int, Hkv: int, S: int, sm_count: int, min_tiles: int = MIN_SPLIT_TILES,
                  blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Kernels 3's and 14's split count from the host's shapes alone (never
    from lengths, which live on the card): 1 where the B*Hkv pairs already
    fill the SMs (one block a pair); else as many as the card holds at once
    (blocks_per_sm an SM), at most MAX_SPLITS, and no range shorter than
    min_tiles tiles of S."""
    if not all(type(v) is int for v in (B, Hkv, S, sm_count, min_tiles, blocks_per_sm)):
        raise TypeError("decode_splits takes the host's shape integers, not tensors")
    pairs = B * Hkv
    if pairs >= sm_count:
        return 1
    return max(1, min(blocks_per_sm * sm_count // pairs, (S + 31) // 32 // min_tiles,
                      MAX_SPLITS))


def flash_decode(q, k_cache, v_cache, lengths):
    """Kernel 14.  q [B, Hkv, rep, Dh] (pre-scaled), caches [B, Hkv, S, Dh]
    (read only), lengths [B] int32 live tokens (clamped to [1, S]) ->
    out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, lengths)
    B, Hkv, _, _, S = _check(q, k_cache, v_cache, lengths)
    return flash_decode_at(q, k_cache, v_cache, lengths,
                           decode_splits(B, Hkv, S, build.sm_count(q.device)))


def flash_decode_at(q, k_cache, v_cache, lengths, splits: int,
                    min_tiles: int = MIN_SPLIT_TILES):
    """Kernel 14 at a given split count (1 to MAX_SPLITS), its ranges at
    least min_tiles tiles: what flash_decode launches with decode_splits'
    count; chip_smoke.py sweeps the count with it at min_tiles 1.  CUDA
    tensors only."""
    B, Hkv, rep, Dh, S = _check(q, k_cache, v_cache, lengths)
    build.require(1 <= splits <= MAX_SPLITS, f"splits {splits} not in 1..{MAX_SPLITS}")
    build.require(min_tiles >= 1, f"min_tiles must be positive, got {min_tiles}")
    q = q.contiguous()
    build.require_cuda(q, k_cache, v_cache, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_decode_attend", _ATTEND_ARGS)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Hkv, rep, Dh, S, splits, min_tiles, build.dtype_code(q.dtype),
            build.dtype_code(k_cache.dtype), build.stream_of(q))
    build.check(rc, "flash_decode")
    launches["flash_decode_attend"] += 1
    if splits > 1:
        launches["flash_decode_split"] += 1
    return out


def flash_decode_append(q, k_new, v_new, k_cache, v_cache, lengths):
    """Kernel 3.  q [B, Hkv, rep, Dh] (pre-scaled), k_new/v_new [B, Hkv, Dh],
    caches [B, Hkv, S, Dh] (written in place), lengths [B] int32 valid
    tokens including the new one -> out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_append_plain(q, k_new, v_new, k_cache, v_cache, lengths)
    B, Hkv, _, _, S = _check(q, k_cache, v_cache, lengths)
    return flash_decode_append_at(
        q, k_new, v_new, k_cache, v_cache, lengths,
        decode_splits(B, Hkv, S, build.sm_count(q.device), APPEND_MIN_TILES))


def flash_decode_append_at(q, k_new, v_new, k_cache, v_cache, lengths, splits: int,
                           min_tiles: int = APPEND_MIN_TILES):
    """Kernel 3 at a given split count (1 to MAX_SPLITS), its ranges at
    least min_tiles tiles: what flash_decode_append launches with
    decode_splits' count; chip_smoke.py times splits = 1 beside it.  CUDA
    tensors only."""
    B, Hkv, rep, Dh, S = _check(q, k_cache, v_cache, lengths)
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == (B, Hkv, Dh),
                  f"new rows {tuple(k_new.shape)} do not match q {tuple(q.shape)}")
    build.require(1 <= splits <= MAX_SPLITS, f"splits {splits} not in 1..{MAX_SPLITS}")
    build.require(min_tiles >= 1, f"min_tiles must be positive, got {min_tiles}")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    build.require_cuda(q, k_new, v_new, k_cache, v_cache, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_decode_append", _APPEND_ARGS)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, Hkv, rep, Dh, S, splits,
            min_tiles, build.dtype_code(q.dtype), build.dtype_code(k_cache.dtype),
            build.stream_of(q))
    build.check(rc, "flash_decode_append")
    launches["flash_decode"] += 1
    if splits > 1:
        launches["flash_decode_append_split"] += 1
    return out


# -- kernel 18: one shard's softmax partials ------------------------------------


def _split_ranges(lengths, S: int, splits: int, min_tiles: int = 1):
    """[splits, B] row ranges [begin, end) of each sequence's live rows,
    cut at whole 32-row tiles, as kernel 18's blocks take them (and the
    split forms, whose ranges are at least min_tiles tiles)."""
    L = lengths.long().clamp(0, S)
    per = (((L + 31) // 32 + splits - 1) // splits).clamp(min=min_tiles) * 32
    begin = torch.minimum(torch.arange(splits, device=L.device)[:, None] * per, L)
    return begin, torch.minimum(begin + per, L)


def flash_decode_stats_plain(q, k_cache, v_cache, lengths, splits: int = 1):
    """Kernel 18's function in plain PyTorch."""
    S = k_cache.shape[2]
    return range_stats(q, k_cache, v_cache, *_split_ranges(lengths.to(q.device), S, splits))


def range_stats(q, k_cache, v_cache, begin, end):
    """Softmax partials (o, m, l) of q over each [begin, end) row range
    ([splits, B]) of each sequence's cache, as flash_decode_stats returns
    them; an empty range gives (0, -inf, 0)."""
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    splits = begin.shape[0]
    slot = torch.arange(S, device=q.device)
    mask = (slot >= begin[..., None]) & (slot < end[..., None])  # [splits, B, S]
    qs = q[:, :, :, None].expand(B, Hkv, rep, splits, Dh)  # one query row per split
    o, m, l = attend_stats(qs, k_cache, v_cache, mask.transpose(0, 1))
    m = torch.where((begin == end).T[:, None, None], -torch.inf, m)
    return (o.permute(3, 0, 1, 2, 4), m.permute(3, 0, 1, 2).reshape(splits, B, Hkv * rep),
            l.permute(3, 0, 1, 2).reshape(splits, B, Hkv * rep))


def flash_decode_stats(q, k_cache, v_cache, lengths, splits: int = 1):
    """Kernel 18.  q [B, Hkv, rep, Dh] (pre-scaled) in the caches' dtype;
    caches [B, Hkv, S, Dh], any strides with the last dim contiguous (k and
    v alike); lengths [B] int32 live rows (clamped to [0, S]) -> partials
    of `splits` ranges of them: (o [splits, B, Hkv, rep, Dh], m [splits, B,
    Hkv*rep], l [splits, B, Hkv*rep]) f32; an empty range gives
    (0, -inf, 0).  With splits 1 the launch takes a cluster where the
    pairs leave SMs idle (decode_splits, from shapes only)."""
    if not q.is_cuda:
        return flash_decode_stats_plain(q, k_cache, v_cache, lengths, splits)
    B, Hkv, _, _, S = _check(q, k_cache, v_cache, lengths)
    cluster = (decode_splits(B, Hkv, S, build.sm_count(q.device), APPEND_MIN_TILES)
               if splits == 1 else 1)
    return flash_decode_stats_at(q, k_cache, v_cache, lengths, splits, cluster)


def flash_decode_stats_at(q, k_cache, v_cache, lengths, splits: int = 1, cluster: int = 1,
                          min_tiles: int = APPEND_MIN_TILES):
    """Kernel 18 at a given launch: `splits` ranges one block each (as
    _split_ranges cuts them, no floor), or with splits 1 the one range over
    a cluster of `cluster` blocks (1 to MAX_SPLITS; ranges of at least
    min_tiles tiles) merged on chip into one partial; what
    flash_decode_stats launches, and chip_smoke.py times cluster 1 beside
    it.  CUDA tensors only."""
    B, Hkv, rep, Dh, S = _check(q, k_cache, v_cache, lengths)
    build.require(q.dtype == k_cache.dtype, f"q {q.dtype} and caches {k_cache.dtype} differ")
    build.require(splits >= 1, f"splits must be positive, got {splits}")
    build.require(1 <= cluster <= MAX_SPLITS and (cluster == 1 or splits == 1),
                  f"cluster {cluster} not in 1..{MAX_SPLITS}, or beside splits {splits}")
    build.require(min_tiles >= 1, f"min_tiles must be positive, got {min_tiles}")
    build.require(k_cache.stride() == v_cache.stride() and k_cache.stride(-1) == 1,
                  f"caches need one set of strides with contiguous rows, got "
                  f"{k_cache.stride()} and {v_cache.stride()}")
    item = k_cache.element_size()
    build.require(all(st * item % 16 == 0 for st in k_cache.stride()[:3])
                  and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
                  "cache rows must be 16-byte aligned")
    build.require(k_cache.device == q.device == v_cache.device,
                  "q and the caches must share a device")
    q = q.contiguous()
    build.require_cuda(q, lengths)
    o = torch.empty((splits, B, Hkv, rep, Dh), dtype=torch.float32, device=q.device)
    m = torch.empty((splits, B, Hkv * rep), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = build.function("th_flash_decode_stats", _STATS_ARGS)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), B, Hkv, rep, Dh, S, splits,
            *k_cache.stride()[:3], cluster, min_tiles, build.dtype_code(q.dtype),
            build.stream_of(q))
    build.check(rc, "flash_decode_stats")
    launches["flash_decode_stats"] += 1
    if cluster > 1:
        launches["flash_decode_stats_split"] += 1
    return o, m, l


# -- kernel 16: append + attend + Wo + residual --------------------------------


def can_fuse_attn_out(wo, B: int, T: int, rep: int, Dh: int, S: int) -> bool:
    """The reference's gate for kernel 16 (attn_block.py can_fuse_attn_out):
    Wo in Q4_0 or the symmetric G 32 form (the reference's q4_0_i4 and q8_0
    kinds) without mins; one token of one sequence, one query per kv head;
    Dh % 128, S % 128, Dq % 256 and D % 128 all 0."""
    if not (isinstance(wo, QWeight) and wo.group == 32 and wo.mins is None):
        return False
    if B != 1 or T != 1 or rep != 1:
        return False
    Dq, D = wo.shape
    return Dh % 128 == 0 and S % 128 == 0 and Dq % 256 == 0 and D % 128 == 0


def _q_scale(q: torch.Tensor) -> float:
    """1/sqrt(Dh) rounded to q's type: the reference's wrapper multiplies q
    by a weakly typed Python float, which takes q's type first."""
    return float(torch.tensor(1.0 / q.shape[-1]**0.5, dtype=q.dtype))


def fused_attn_out_plain(x, q, k_new, v_new, k_cache, v_cache, lengths, wo: QWeight):
    """Kernel 16's function in plain PyTorch: q scaled in its own type (as
    the reference's wrapper does), then f32 to one rounding of y."""
    B, T, H, Dh = q.shape
    Hkv = k_cache.shape[1]
    qg = (q[:, 0] * _q_scale(q)).float().reshape(B, Hkv, H // Hkv, Dh)
    ctx = flash_decode_append_plain(qg, k_new[:, 0], v_new[:, 0], k_cache, v_cache, lengths)
    y = x.float() + ctx.reshape(B, 1, H * Dh) @ wo.dequantize(torch.float32)
    return y.to(x.dtype)


def fused_attn_out(x, q, k_new, v_new, k_cache, v_cache, lengths, wo: QWeight):
    """Kernel 16.  x [1, 1, D] residual, q [1, 1, H, Dh] (RoPE applied,
    unscaled), k_new / v_new [1, 1, H, Dh], caches [1, H, S, Dh] (written in
    place at min(lengths, S) - 1), lengths [1] int32 tokens including the
    new one, Wo [H*Dh, D] -> x + attend @ Wo, [1, 1, D] in x.dtype."""
    if not q.is_cuda:
        return fused_attn_out_plain(x, q, k_new, v_new, k_cache, v_cache, lengths, wo)
    H, S = q.shape[2], k_cache.shape[2]
    return fused_attn_out_at(x, q, k_new, v_new, k_cache, v_cache, lengths, wo,
                             decode_splits(1, H, S, build.sm_count(q.device), APPEND_MIN_TILES))


def fused_attn_out_at(x, q, k_new, v_new, k_cache, v_cache, lengths, wo: QWeight, splits: int,
                      min_tiles: int = APPEND_MIN_TILES, plan=None):
    """Kernel 16 with the attention in `splits` blocks a head (1 to
    MAX_SPLITS), its ranges at least min_tiles tiles, and Wo's plan forced
    by `plan` ((splits, stages) or (splits, stages, parts); None: the
    rule's): what fused_attn_out launches with decode_splits' count.  CUDA
    tensors only."""
    B, T, H, Dh = q.shape
    S = k_cache.shape[2]
    Dq, D = wo.shape
    build.require(B == 1 and T == 1, f"fused_attn_out takes one token of one sequence, got "
                                     f"{tuple(q.shape)}")
    build.require(Dh in HEAD_DIMS, f"head dim {Dh} not in {HEAD_DIMS}")
    build.require(k_cache.shape == (1, H, S, Dh) and v_cache.shape == k_cache.shape,
                  f"cache {tuple(k_cache.shape)} is not one kv head per query of q "
                  f"{tuple(q.shape)}")
    build.require(k_cache.dtype == v_cache.dtype, "k and v caches differ in dtype")
    build.require(k_new.shape == q.shape and v_new.shape == q.shape,
                  f"new rows {tuple(k_new.shape)} do not match q {tuple(q.shape)}")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (1,),
                  "lengths must be int32 [1]")
    build.require(Dq == H * Dh and x.shape == (1, 1, D) and x.dtype == q.dtype,
                  f"x {tuple(x.shape)} {x.dtype}, Wo {wo.shape} do not match q {tuple(q.shape)} "
                  f"{q.dtype}")
    build.require(1 <= splits <= MAX_SPLITS, f"splits {splits} not in 1..{MAX_SPLITS}")
    build.require(min_tiles >= 1, f"min_tiles must be positive, got {min_tiles}")
    form = form_code(wo, sb=False)
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    x = x.contiguous()
    build.require_cuda(q, k_new, v_new, k_cache, v_cache, lengths, x)
    wo_plan = stream_plan(1, Dq, D, form, build.sm_count(q.device), **forced_plan(plan))
    ctx = torch.empty((H * Dh,), dtype=torch.float32, device=q.device)
    y = torch.empty_like(x)
    fn = build.function("th_attn_wo", _ATTN_WO_ARGS)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), x.data_ptr(), *weight_args(wo, q), form,
            ctx.data_ptr(), y.data_ptr(), H, Dh, S, D, _q_scale(q), splits, min_tiles, *wo_plan,
            build.dtype_code(q.dtype), build.dtype_code(k_cache.dtype), build.stream_of(q))
    build.check(rc, "fused_attn_out")
    launches["attn_wo"] += 1
    if splits > 1:
        launches["attn_wo_split"] += 1
    launches["attn_wo_stream"] += 1
    return y
