"""Kernels 5-7: the paged KV pool (csrc/paged_decode.cu).

  paged_decode   replaces tokenhawk_tpu/ops/pallas/paged_decode.py
                 `paged_flash_decode_walk` (_kernel_walk) and its grid form
                 `paged_flash_decode` (_kernel_vec): decode attention
                 through per-sequence page tables;
  paged_append   replaces `paged_append_rows` (_append_kernel): one K and
                 one V row per sequence into (page, slot), in place;
  gather_pages   replaces `gather_pages_dense` (_gather_kernel): each
                 sequence's pages -> dense [B, Hkv, mp*ps, Dh] K and V.

A pool is one layer's pages in one of two layouts, fixed when the pool is
made (runtime/paged.py) and passed here by name: "contig" (page-major)
[n_pages, Hkv, ps, Dh] or "head" (head-major) [Hkv, n_pages, ps, Dh].
Head dim 64 or 128.  All three are bound by bytes on the H100.  The kernels trust the page
ids; the plain versions raise on one out of range.  A wrapper runs its
plain version only for CPU tensors.

Tolerance of paged_decode against its plain version: f32 scores and
softmax in both, another summation order, one rounding to q.dtype.
paged_append and gather_pages copy bytes: they match exactly.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.flash_decode import HEAD_DIMS, REPS

LAYOUTS = ("contig", "head")
launches = {"paged_decode": 0, "paged_append": 0, "gather_pages": 0}

_LL = build.LL
_DECODE_ARGS = [build.P] * 6 + [build.I] * 6 + [_LL, _LL] + [build.I] * 2 + [build.P]
_APPEND_ARGS = [build.P] * 6 + [build.I] * 3 + [_LL, _LL, build.P]
_GATHER_ARGS = [build.P] * 5 + [build.I] * 4 + [_LL, _LL, build.P]


def pool_dims(pages: torch.Tensor, layout: str):
    """(n_pages, Hkv, ps, Dh) of one layer's pool in `layout`."""
    if layout == "contig":
        n_pages, Hkv, ps, Dh = pages.shape
    elif layout == "head":
        Hkv, n_pages, ps, Dh = pages.shape
    else:
        raise ValueError(f"pool layout must be one of {LAYOUTS}, got {layout!r}")
    return n_pages, Hkv, ps, Dh


def _strides(pages: torch.Tensor, layout: str):
    """(page stride, head stride) in elements of a contiguous pool."""
    n_pages, Hkv, ps, Dh = pool_dims(pages, layout)
    if layout == "contig":
        return Hkv * ps * Dh, ps * Dh
    return ps * Dh, n_pages * ps * Dh


def _check_ids(ids: torch.Tensor, n_pages: int) -> None:
    if ids.numel() and not bool(((ids >= 0) & (ids < n_pages)).all()):
        raise IndexError(f"page id out of range [0, {n_pages}): {ids.tolist()}")


def gather_pool_payload(pages: torch.Tensor, page_table: torch.Tensor, layout: str):
    """Pages by table -> [B, Hkv, mp, ps, Dh] whatever the layout (fancy
    indexing: the form the plain versions and the library timing use)."""
    n_pages = pool_dims(pages, layout)[0]
    _check_ids(page_table, n_pages)
    idx = page_table.to(pages.device).long()
    if layout == "contig":
        return pages[idx].transpose(1, 2)  # [B, mp, Hkv, ps, Dh] -> [B, Hkv, mp, ps, Dh]
    return pages[:, idx].transpose(0, 1)  # [Hkv, B, mp, ps, Dh] -> [B, Hkv, mp, ps, Dh]


# -- kernel 5: paged decode ---------------------------------------------------


def attend_gathered(q, kg, vg, lengths):
    """q [B, Hkv, rep, Dh] (pre-scaled) over the first lengths[b] rows of
    gathered kg / vg [B, Hkv, mp, ps, Dh], in f32 -> [B, Hkv, rep, Dh] in
    q.dtype (the plain versions' attention, bf16 and int8 pools alike)."""
    B, Hkv, mp, ps, Dh = kg.shape
    kg = kg.reshape(B, Hkv, mp * ps, Dh).float()
    vg = vg.reshape(B, Hkv, mp * ps, Dh).float()
    L = lengths.to(q.device).long()
    scores = torch.einsum("bhrd,bhsd->bhrs", q.float(), kg)
    live = torch.arange(mp * ps, device=q.device)[None, :] < L[:, None]  # [B, S]
    scores = scores.masked_fill(~live[:, None, None], -torch.inf)
    # A row of length 0 has no live key: its output is zeros (not NaN).
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhrs,bhsd->bhrd", probs, vg).to(q.dtype)


def paged_decode_plain(q, k_pages, v_pages, page_table, lengths, layout):
    """The same function in plain PyTorch: gather, mask, softmax in f32."""
    return attend_gathered(q, gather_pool_payload(k_pages, page_table, layout),
                           gather_pool_payload(v_pages, page_table, layout), lengths)


def paged_decode(q, k_pages, v_pages, page_table, lengths, layout):
    """q [B, Hkv, rep, Dh] (pre-scaled), one layer's k/v pools in `layout`,
    page_table [B, max_pages] int32, lengths [B] int32 live tokens ->
    out [B, Hkv, rep, Dh] in q.dtype."""
    if not q.is_cuda:
        return paged_decode_plain(q, k_pages, v_pages, page_table, lengths, layout)
    B, Hkv, rep, Dh = q.shape
    n_pages, pHkv, ps, pDh = pool_dims(k_pages, layout)
    build.require(Dh in HEAD_DIMS and pDh == Dh,
                  f"head dim {Dh} (pool {pDh}) not in {HEAD_DIMS}")
    build.require(rep in REPS, f"query heads per kv head {rep} not in {REPS}")
    build.require(pHkv == Hkv and v_pages.shape == k_pages.shape,
                  f"pools {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    build.require(k_pages.dtype == v_pages.dtype, "k and v pools differ in dtype")
    build.require(page_table.dtype == torch.int32 and page_table.dim() == 2
                  and page_table.shape[0] == B, "page_table must be int32 [B, max_pages]")
    build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                  "lengths must be int32 [B]")
    q = q.contiguous()
    page_table = page_table.contiguous()
    build.require_cuda(q, k_pages, v_pages, page_table, lengths)
    out = torch.empty_like(q)
    page_stride, head_stride = _strides(k_pages, layout)
    fn = build.function("th_paged_decode", _DECODE_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hkv, rep, Dh, ps, page_table.shape[1],
            page_stride, head_stride, build.dtype_code(q.dtype),
            build.dtype_code(k_pages.dtype), build.stream_of(q))
    build.check(rc, "paged_decode")
    launches["paged_decode"] += 1
    return out


# -- kernel 6: paged append ---------------------------------------------------


def paged_append_plain(k_pages, v_pages, k_new, v_new, page, slot, layout):
    """The same function in plain PyTorch: one row copy per sequence, in
    order (a later sequence on the same (page, slot) wins)."""
    n_pages = pool_dims(k_pages, layout)[0]
    _check_ids(page, n_pages)
    for b, (p, s) in enumerate(zip(page.tolist(), slot.tolist())):
        for pages, new in ((k_pages, k_new), (v_pages, v_new)):
            if layout == "contig":
                pages[p, :, s] = new[b].to(pages.dtype)
            else:
                pages[:, p, s] = new[b].to(pages.dtype)


def paged_append(k_pages, v_pages, k_new, v_new, page, slot, layout):
    """Write k_new / v_new [B, Hkv, Dh] at row slot[b] of page page[b] of
    one layer's k / v pools, in place (one launch for both)."""
    if not k_pages.is_cuda:
        return paged_append_plain(k_pages, v_pages, k_new, v_new, page, slot, layout)
    n_pages, Hkv, ps, Dh = pool_dims(k_pages, layout)
    B = k_new.shape[0]
    build.require(v_pages.shape == k_pages.shape and v_pages.dtype == k_pages.dtype,
                  "k and v pools differ")
    build.require(k_new.shape == (B, Hkv, Dh) and v_new.shape == k_new.shape,
                  f"new rows {tuple(k_new.shape)} do not match the pool {tuple(k_pages.shape)}")
    build.require(page.dtype == torch.int32 and slot.dtype == torch.int32
                  and page.shape == (B,) and slot.shape == (B,), "page and slot must be int32 [B]")
    row_bytes = Dh * k_pages.element_size()
    build.require(row_bytes % 16 == 0, f"a row of {row_bytes} bytes is not a multiple of 16")
    k_new = k_new.to(k_pages.dtype).contiguous()
    v_new = v_new.to(k_pages.dtype).contiguous()
    build.require_cuda(k_pages, v_pages, k_new, v_new, page, slot)
    es = k_pages.element_size()
    page_stride, head_stride = _strides(k_pages, layout)
    fn = build.function("th_paged_append", _APPEND_ARGS)
    rc = fn(k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            page.data_ptr(), slot.data_ptr(), B, Hkv, row_bytes, page_stride * es,
            head_stride * es, build.stream_of(k_pages))
    build.check(rc, "paged_append")
    launches["paged_append"] += 1


# -- kernel 7: page gather ----------------------------------------------------


def gather_pages_plain(k_pages, v_pages, page_table, layout):
    """The same function in plain PyTorch: one page copy per (sequence,
    table entry), as the TPU kernel's page DMAs."""
    n_pages, Hkv, ps, Dh = pool_dims(k_pages, layout)
    _check_ids(page_table, n_pages)
    B, mp = page_table.shape
    outs = []
    for pages in (k_pages, v_pages):
        out = torch.empty((B, Hkv, mp * ps, Dh), dtype=pages.dtype, device=pages.device)
        for b, row in enumerate(page_table.tolist()):
            for i, p in enumerate(row):
                out[b, :, i * ps:(i + 1) * ps] = pages[p] if layout == "contig" else pages[:, p]
        outs.append(out)
    return tuple(outs)


def gather_pages(k_pages, v_pages, page_table, layout):
    """One layer's k/v pools, page_table [B, mp] int32 -> dense
    (k, v) [B, Hkv, mp*ps, Dh], row p*ps + i holding slot i of page p."""
    if not k_pages.is_cuda:
        return gather_pages_plain(k_pages, v_pages, page_table, layout)
    n_pages, Hkv, ps, Dh = pool_dims(k_pages, layout)
    B, mp = page_table.shape
    build.require(v_pages.shape == k_pages.shape and v_pages.dtype == k_pages.dtype,
                  "k and v pools differ")
    build.require(page_table.dtype == torch.int32, "page_table must be int32")
    es = k_pages.element_size()
    page_bytes = ps * Dh * es
    build.require(page_bytes % 16 == 0, f"a page of {page_bytes} bytes is not a multiple of 16")
    page_table = page_table.contiguous()
    build.require_cuda(k_pages, v_pages, page_table)
    k_out = torch.empty((B, Hkv, mp * ps, Dh), dtype=k_pages.dtype, device=k_pages.device)
    v_out = torch.empty_like(k_out)
    page_stride, head_stride = _strides(k_pages, layout)
    fn = build.function("th_gather_pages", _GATHER_ARGS)
    rc = fn(k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(), k_out.data_ptr(),
            v_out.data_ptr(), B, Hkv, mp, page_bytes, page_stride * es, head_stride * es,
            build.stream_of(k_pages))
    build.check(rc, "gather_pages")
    launches["gather_pages"] += 1
    return k_out, v_out
