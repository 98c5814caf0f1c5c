"""Kernels 10-12: the int8 paged KV pool (csrc/paged_int8.cu).

  paged_decode_int8  replaces tokenhawk_tpu/ops/pallas/paged_decode_int8.py
                     `paged_flash_decode_int8_walk` (_kernel_walk) and its
                     grid form `paged_flash_decode_int8` (_kernel_vec):
                     decode attention through page tables over int8 pages;
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

Tolerance of paged_decode_int8 against its plain version: exact attention
over the dequantized pages in f32 in both, another summation order, one
rounding to q.dtype.  paged_append_int8 matches bit for bit (outside the
trash page), and so does gather_pages_int8: a code times a bfloat16 scale
is exact in f32 and rounds once to the output type on both sides.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.paged_decode import (
    HEAD_DIMS,
    REPS,
    _check_ids,
    _strides,
    attend_gathered,
    gather_pool_payload,
    pool_dims,
)
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

launches = {"paged_decode_int8": 0, "paged_append_int8": 0, "gather_pages_int8": 0}

_LL = build.LL
_DECODE_ARGS = [build.P] * 8 + [build.I] * 6 + [_LL] * 4 + [build.I, build.P]
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
    B, Hkv, rep, Dh = q.shape
    n_pages, pHkv, ps, pDh = _check_pool(k_pages, ks_pages, v_pages, vs_pages, layout)
    build.require(Dh == pDh and pHkv == Hkv,
                  f"pools {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    build.require(rep in REPS, f"query heads per kv head {rep} not in {REPS}")
    build.require(page_table.dtype == torch.int32 and page_table.dim() == 2
                  and page_table.shape[0] == B, "page_table must be int32 [B, max_pages]")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                  "lengths must be int32 [B]")
    q = q.contiguous()
    page_table = page_table.contiguous()
    build.require_cuda(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths)
    out = torch.empty_like(q)
    fn = build.function("th_paged_decode_int8", _DECODE_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), ks_pages.data_ptr(), v_pages.data_ptr(),
            vs_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Hkv, rep, Dh, ps, page_table.shape[1], *_all_strides(k_pages, layout),
            build.dtype_code(q.dtype), build.stream_of(q))
    build.check(rc, "paged_decode_int8")
    launches["paged_decode_int8"] += 1
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
