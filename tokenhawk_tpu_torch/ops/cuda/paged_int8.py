"""Kernels 10-12: the int8 paged KV pool (csrc/paged_int8.cu).

  paged_decode_int8  replaces tokenhawk_tpu/ops/pallas/paged_decode_int8.py
                     `paged_flash_decode_int8_walk` (_kernel_walk) and its
                     grid form `paged_flash_decode_int8` (_kernel_vec):
                     decode attention through page tables over int8 pages,
                     on kernel 3's shared-memory tile walk
                     (csrc/decode_tiles.cuh) as kernel 5 runs it, each
                     row's codes and scale read through the table;
  paged_decode_int8_append
                     kernel 10 with kernel 11 folded in, the int8 decode
                     layer's one launch: each sequence's new K / V row
                     quantized and appended at row lengths[b] (the tokens
                     already stored) through the table, then attention
                     over lengths[b] + 1 rows;
  paged_append_int8  replaces `paged_append_rows` on int8 payloads and
                     `paged_append_scales` (ops/pallas/paged_decode.py):
                     quantizes one K and one V row per sequence and writes
                     codes and scale at (page, slot), in place;
  gather_pages_int8  replaces `gather_pages_dense_int8` and the multiply by
                     the scales after it: each sequence's pages -> dense
                     dequantized [B, Hkv, mp*ps, Dh] K and V.

An int8 pool is one layer's codes in a layout of paged_decode.LAYOUTS,
[n_pages, Hkv, ps, Dh] ("contig") or [Hkv, n_pages, ps, Dh] ("head"), Dh 64
or 128, and
its f32 scale pages, the same without Dh.  A stored scale is the codec's
bfloat16-rounded scale (ops/kvquant.py) held as f32, as the reference
stores it.  The kernels trust the page ids; the plain versions raise on
one out of range.  A wrapper runs its plain version only for CPU tensors.

paged_decode_int8 copies each chunk's codes and scales into shared memory
together and widens each code to f32 times its row's scale where it is
used.  It takes kernel 5's split rule (`paged_splits`, from the host's
shapes only), with 2 splits where kernel 5 takes FULL_SPLITS
(`paged_int8_splits`): one block a (sequence, kv head), or each pair's
live rows cut on the card into tile-aligned ranges over a thread-block
cluster, merged on chip.  Counted as `launches["paged_decode_int8"]`, the
split form also in `["paged_decode_int8_split"]`.

paged_decode_int8_append launches the same kernel with the new rows: the
block whose range holds row lengths[b] quantizes them (a warp each for K
and V, kernel 11's codec) and writes codes and scale there and into its
tile; nothing where the table has no row lengths[b].  Same split rule;
counted as `launches["paged_decode_int8_append"]`, the split form also in
`["paged_decode_int8_append_split"]`.  Its output and pools are bit for
bit those of kernel 11 then kernel 10; sequences parked on the trash page
read rows another may be writing in the same launch, so their discarded
outputs are unspecified.

Tolerance of paged_decode_int8 against its plain version: exact attention
over the dequantized pages in f32 in both (a code times a bfloat16 scale
is exact in f32), another summation order (the split form also merges its
ranges in split order), one rounding to q.dtype.  paged_append_int8
matches bit for bit (outside the trash page), and so does
gather_pages_int8: a code times a bfloat16 scale is exact in f32 and
rounds once to the output type on both sides.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.flash_decode import APPEND_MIN_TILES, MAX_SPLITS
from tokenhawk_tpu_torch.ops.cuda.paged_decode import (
    HEAD_DIMS,
    REPS,
    _check_ids,
    _strides,
    append_rows,
    attend_gathered,
    gather_pool_payload,
    paged_splits,
    pool_dims,
)
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

launches = {"paged_decode_int8": 0, "paged_decode_int8_split": 0,
            "paged_decode_int8_append": 0, "paged_decode_int8_append_split": 0,
            "paged_append_int8": 0, "gather_pages_int8": 0}
# Kernel 10's splits where one block a pair would fill the SMs at most two
# deep (kernel 5's FULL_SPLITS): at LLaMA-7B's heads over 8 slots on an
# H100 at 700 W (experiments/decode_rows.py --sweep, ms at 1, 2, 4 splits),
# lengths 1-2048 0.0437, 0.0360, 0.0394 and all at 2048 0.0617, 0.0672,
# 0.0794: 2 keeps the ragged gain and loses 9% where every slot is full.
INT8_FULL_SPLITS = 2

_LL = build.LL
# q, the pools (4), table, lengths, out; B, Hkv, rep, Dh, ps, max_pages;
# strides; splits, min_tiles, q dtype; stream.
_DECODE_ARGS = [build.P] * 8 + [build.I] * 6 + [_LL] * 4 + [build.I] * 3 + [build.P]
# The same with k_new and v_new after the pools.
_DECODE_APPEND_ARGS = [build.P] * 10 + [build.I] * 6 + [_LL] * 4 + [build.I] * 3 + [build.P]
_APPEND_ARGS = [build.P] * 8 + [build.I] * 3 + [_LL] * 4 + [build.I, build.P]
_GATHER_ARGS = [build.P] * 7 + [build.I] * 5 + [_LL] * 4 + [build.I, build.P]


def gather_pool_scales(spages: torch.Tensor, page_table: torch.Tensor, layout: str):
    """Scale pages by table -> [B, Hkv, mp, ps] whatever the layout."""
    n_pages = spages.shape[0 if layout == "contig" else 1]
    _check_ids(page_table, n_pages)
    idx = page_table.to(spages.device).long()
    if layout == "contig":
        return spages[idx].transpose(1, 2)
    return spages[:, idx].transpose(0, 1)


def _all_strides(k_pages, layout):
    """(code page, code head, scale page, scale head) strides in elements."""
    page, head = _strides(k_pages, layout)
    Dh = pool_dims(k_pages, layout)[3]
    return page, head, page // Dh, head // Dh


def _check_pool(k_pages, ks_pages, v_pages, vs_pages, layout):
    n_pages, Hkv, ps, Dh = pool_dims(k_pages, layout)
    build.require(Dh in HEAD_DIMS, f"head dim {Dh} not in {HEAD_DIMS}")
    build.require(k_pages.dtype == torch.int8 and v_pages.shape == k_pages.shape
                  and v_pages.dtype == torch.int8, "the pools' codes must be int8, K as V")
    build.require(ks_pages.dtype == torch.float32 and ks_pages.shape == k_pages.shape[:3]
                  and vs_pages.shape == ks_pages.shape and vs_pages.dtype == torch.float32,
                  f"scale pages {tuple(ks_pages.shape)} must be f32 {tuple(k_pages.shape[:3])}")
    return n_pages, Hkv, ps, Dh


# -- kernel 10: paged decode ----------------------------------------------------


def paged_decode_int8_plain(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths,
                            layout):
    """The same function in plain PyTorch: gather, dequantize in f32, attend."""

    def deq(pages, spages):
        return (gather_pool_payload(pages, page_table, layout).float()
                * gather_pool_scales(spages, page_table, layout)[..., None])

    return attend_gathered(q, deq(k_pages, ks_pages), deq(v_pages, vs_pages), lengths)


def paged_decode_int8(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths, layout):
    """q [B, Hkv, rep, Dh] (pre-scaled), one layer's int8 pools in `layout`,
    page_table [B, max_pages] int32, lengths [B] int32 live tokens ->
    out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return paged_decode_int8_plain(q, k_pages, ks_pages, v_pages, vs_pages, page_table,
                                       lengths, layout)
    B, Hkv = q.shape[:2]
    ps = pool_dims(k_pages, layout)[2]
    return paged_decode_int8_at(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths,
                                layout, paged_int8_splits(B, Hkv, page_table.shape[1] * ps,
                                                          build.sm_count(q.device)))


def paged_int8_splits(B: int, Hkv: int, max_rows: int, sm_count: int) -> int:
    """Kernel 10's split count: kernel 5's rule (paged_splits, from the
    host's shapes alone) with INT8_FULL_SPLITS where the pairs fill the
    SMs at most two deep."""
    return paged_splits(B, Hkv, max_rows, sm_count, INT8_FULL_SPLITS)


def paged_decode_int8_at(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths, layout,
                         splits: int, min_tiles: int = APPEND_MIN_TILES):
    """Kernel 10 at a given split count (1 to MAX_SPLITS), its ranges at
    least min_tiles tiles: what paged_decode_int8 launches with
    paged_int8_splits' count; chip_smoke.py times splits = 1 beside it.
    CUDA tensors only."""
    B, Hkv, rep, Dh, ps = _check_decode(q, k_pages, ks_pages, v_pages, vs_pages, page_table,
                                        lengths, layout, splits, min_tiles)
    q = q.contiguous()
    page_table = page_table.contiguous()
    build.require_cuda(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_paged_decode_int8", _DECODE_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), ks_pages.data_ptr(), v_pages.data_ptr(),
            vs_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Hkv, rep, Dh, ps, page_table.shape[1], *_all_strides(k_pages, layout), splits,
            min_tiles, build.dtype_code(q.dtype), build.stream_of(q))
    build.check(rc, "paged_decode_int8")
    launches["paged_decode_int8"] += 1
    if splits > 1:
        launches["paged_decode_int8_split"] += 1
    return out


def _check_decode(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths, layout, splits,
                  min_tiles):
    """Kernel 10's argument checks (both entries): (B, Hkv, rep, Dh, ps)."""
    B, Hkv, rep, Dh = q.shape
    n_pages, pHkv, ps, pDh = _check_pool(k_pages, ks_pages, v_pages, vs_pages, layout)
    build.require(Dh == pDh and pHkv == Hkv,
                  f"pools {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    build.require(rep in REPS, f"query heads per kv head {rep} not in {REPS}")
    build.require(page_table.dtype == torch.int32 and page_table.dim() == 2
                  and page_table.shape[0] == B, "page_table must be int32 [B, max_pages]")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                  "lengths must be int32 [B]")
    build.require(1 <= splits <= MAX_SPLITS, f"splits {splits} not in 1..{MAX_SPLITS}")
    build.require(min_tiles >= 1, f"min_tiles must be positive, got {min_tiles}")
    return B, Hkv, rep, Dh, ps


# -- kernel 10 with kernel 11 folded in: quantizing append + attend --------------


def paged_decode_int8_append_plain(q, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new,
                                   page_table, lengths, layout):
    """The same function in plain PyTorch, the reference's order: kernel
    11's plain version at row lengths[b] of each sequence whose table has
    it, in order, then kernel 10's over lengths + 1 rows."""
    page, slot, fits = append_rows(page_table, lengths, pool_dims(k_pages, layout)[2])
    paged_append_int8_plain(k_pages, ks_pages, v_pages, vs_pages, k_new[fits], v_new[fits],
                            page[fits], slot[fits], layout)
    return paged_decode_int8_plain(q, k_pages, ks_pages, v_pages, vs_pages, page_table,
                                   lengths + 1, layout)


def paged_decode_int8_append(q, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page_table,
                             lengths, layout):
    """q [B, Hkv, rep, Dh] (pre-scaled), one layer's int8 pools in
    `layout`, k_new / v_new [B, Hkv, Dh] in q.dtype, page_table
    [B, max_pages] int32, lengths [B] int32 tokens already stored ->
    out [B, Hkv, rep, Dh] in q.dtype: the new rows quantized and written at
    row lengths[b] of the pools, in place, and attention over lengths[b] + 1
    rows, in one launch."""
    if not q.is_cuda:
        return paged_decode_int8_append_plain(q, k_pages, ks_pages, v_pages, vs_pages, k_new,
                                              v_new, page_table, lengths, layout)
    B, Hkv = q.shape[:2]
    ps = pool_dims(k_pages, layout)[2]
    return paged_decode_int8_append_at(
        q, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page_table, lengths, layout,
        paged_int8_splits(B, Hkv, page_table.shape[1] * ps, build.sm_count(q.device)))


def paged_decode_int8_append_at(q, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new,
                                page_table, lengths, layout, splits: int,
                                min_tiles: int = APPEND_MIN_TILES):
    """paged_decode_int8_append at a given split count (1 to MAX_SPLITS),
    its ranges at least min_tiles tiles.  CUDA tensors only."""
    B, Hkv, rep, Dh, ps = _check_decode(q, k_pages, ks_pages, v_pages, vs_pages, page_table,
                                        lengths, layout, splits, min_tiles)
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == k_new.shape,
                  f"new rows {tuple(k_new.shape)} do not match q {tuple(q.shape)}")
    build.require(k_new.dtype == q.dtype and v_new.dtype == q.dtype,
                  f"new rows in {k_new.dtype} / {v_new.dtype}, q in {q.dtype}")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    page_table = page_table.contiguous()
    build.require_cuda(q, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page_table,
                       lengths)
    out = torch.empty_like(q)
    fn = build.function("th_paged_decode_int8_append", _DECODE_APPEND_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), ks_pages.data_ptr(), v_pages.data_ptr(),
            vs_pages.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hkv, rep, Dh, ps, page_table.shape[1],
            *_all_strides(k_pages, layout), splits, min_tiles, build.dtype_code(q.dtype),
            build.stream_of(q))
    build.check(rc, "paged_decode_int8_append")
    launches["paged_decode_int8_append"] += 1
    if splits > 1:
        launches["paged_decode_int8_append_split"] += 1
    return out


# -- kernel 11: quantizing paged append -----------------------------------------


def paged_append_int8_plain(k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page, slot,
                            layout):
    """The same function in plain PyTorch: quantize_kv_block, then one row
    copy per sequence, in order (a later sequence on the same (page, slot)
    wins)."""
    n_pages = pool_dims(k_pages, layout)[0]
    _check_ids(page, n_pages)
    for pages, spages, new in ((k_pages, ks_pages, k_new), (v_pages, vs_pages, v_new)):
        codes, scales = quantize_kv_block(new)  # [B, Hkv, Dh], bf16 [B, Hkv]
        for b, (p, s) in enumerate(zip(page.tolist(), slot.tolist())):
            if layout == "contig":
                pages[p, :, s] = codes[b]
                spages[p, :, s] = scales[b].float()
            else:
                pages[:, p, s] = codes[b]
                spages[:, p, s] = scales[b].float()


def paged_append_int8(k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page, slot, layout):
    """Quantize k_new / v_new [B, Hkv, Dh] and write codes and scales at row
    slot[b] of page page[b] of one layer's int8 pools, in place (one launch
    for K and V)."""
    if not k_pages.is_cuda:
        return paged_append_int8_plain(k_pages, ks_pages, v_pages, vs_pages, k_new, v_new,
                                       page, slot, layout)
    n_pages, Hkv, ps, Dh = _check_pool(k_pages, ks_pages, v_pages, vs_pages, layout)
    B = k_new.shape[0]
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == k_new.shape,
                  f"new rows {tuple(k_new.shape)} do not match the pool {tuple(k_pages.shape)}")
    build.require(page.dtype == torch.int32 and slot.dtype == torch.int32
                  and page.shape == (B,) and slot.shape == (B,), "page and slot must be int32 [B]")
    k_new = k_new.contiguous()
    v_new = v_new.to(k_new.dtype).contiguous()
    build.require_cuda(k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page, slot)
    fn = build.function("th_paged_append_int8", _APPEND_ARGS)
    rc = fn(k_pages.data_ptr(), ks_pages.data_ptr(), v_pages.data_ptr(), vs_pages.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), page.data_ptr(), slot.data_ptr(), B, Hkv, Dh,
            *_all_strides(k_pages, layout), build.dtype_code(k_new.dtype),
            build.stream_of(k_pages))
    build.check(rc, "paged_append_int8")
    launches["paged_append_int8"] += 1


# -- kernel 12: dequantizing page gather ----------------------------------------


def gather_pages_int8_plain(k_pages, ks_pages, v_pages, vs_pages, page_table, layout, dtype):
    """The same function in plain PyTorch: gather codes and scales, then the
    reference's multiply in `dtype` (codes.to(dtype) * scales.to(dtype))."""
    B, mp = page_table.shape
    n_pages, Hkv, ps, Dh = pool_dims(k_pages, layout)
    outs = []
    for pages, spages in ((k_pages, ks_pages), (v_pages, vs_pages)):
        codes = gather_pool_payload(pages, page_table, layout).to(dtype)
        scales = gather_pool_scales(spages, page_table, layout).to(dtype)
        outs.append((codes * scales[..., None]).reshape(B, Hkv, mp * ps, Dh))
    return tuple(outs)


def gather_pages_int8(k_pages, ks_pages, v_pages, vs_pages, page_table, layout, dtype):
    """One layer's int8 pools, page_table [B, mp] int32 -> dense dequantized
    (k, v) [B, Hkv, mp*ps, Dh] in `dtype`, row p*ps + i holding slot i of
    page p."""
    if not k_pages.is_cuda:
        return gather_pages_int8_plain(k_pages, ks_pages, v_pages, vs_pages, page_table,
                                       layout, dtype)
    n_pages, Hkv, ps, Dh = _check_pool(k_pages, ks_pages, v_pages, vs_pages, layout)
    B, mp = page_table.shape
    build.require(page_table.dtype == torch.int32, "page_table must be int32")
    page_table = page_table.contiguous()
    build.require_cuda(k_pages, ks_pages, v_pages, vs_pages, page_table)
    k_out = torch.empty((B, Hkv, mp * ps, Dh), dtype=dtype, device=k_pages.device)
    v_out = torch.empty_like(k_out)
    fn = build.function("th_gather_pages_int8", _GATHER_ARGS)
    rc = fn(k_pages.data_ptr(), ks_pages.data_ptr(), v_pages.data_ptr(), vs_pages.data_ptr(),
            page_table.data_ptr(), k_out.data_ptr(), v_out.data_ptr(), B, Hkv, Dh, mp, ps,
            *_all_strides(k_pages, layout), build.dtype_code(dtype), build.stream_of(k_pages))
    build.check(rc, "gather_pages_int8")
    launches["gather_pages_int8"] += 1
    return k_out, v_out
