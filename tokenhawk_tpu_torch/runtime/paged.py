"""Paged KV cache: fixed-size pages allocated on demand, mapped through a
per-sequence page table (counterpart of tokenhawk_tpu/runtime/paged.py).

  pool.k[l], pool.v[l]   : one layer's pages, [n_pages, Hkv, ps, Dh] in the
                           "contig" (page-major) layout, the default, or
                           [Hkv, n_pages, ps, Dh] in the "head" layout;
                           bf16/f32 values, or int8 codes
  pool.ks[l], pool.vs[l] : an int8 pool's f32 scale pages, the same
                           layout without Dh (None for a bf16/f32 pool)
  page_table             : [B, max_pages] int32 physical page ids
  lengths                : [B] tokens currently stored

The pool keeps per-layer lists (as the port keeps per-layer weights), so
the reference's stacked `PagedKVCache` / `PagedQuantKVCache` and their
unrolled per-layer tuple pools are one class here.  The layout is an
argument of the pool, stored on it when it is made and passed down to
every op and kernel; nothing reads it from the environment (the reference
reads THAWK_POOL_LAYOUT at trace time, and infers the head axis from the
number of dimensions).

Decode appends and attention run kernels 6 and 5, the chunked-prefill
gather kernel 7 (ops/cuda/paged_decode.py); on an int8 pool kernels 11,
10 and 12 (ops/cuda/paged_int8.py).  Whole-page fragment writes are plain
index copies (quantized first on an int8 pool), as in the reference.  An
int8 scale is the codec's bfloat16-rounded scale held as f32
(ops/kvquant.py).  Pages are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ops.cuda.paged_decode import (
    LAYOUTS,
    gather_pages,
    gather_pool_payload,
    paged_append,
    paged_decode,
    pool_dims,
)
from tokenhawk_tpu_torch.ops.cuda.paged_int8 import (
    gather_pages_int8,
    gather_pool_scales,
    paged_append_int8,
    paged_decode_int8,
)
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

__all__ = ["LAYOUTS", "PagedKVCache", "PageAllocator", "append_token_layer",
           "paginate_fragment_layer", "paginate_fragment_layer_at", "attend_paged_layer",
           "gather_pool_payload", "gather_pages", "append_token_layer_int8",
           "paginate_fragment_layer_int8", "paginate_fragment_layer_int8_at",
           "attend_paged_layer_int8", "gather_pool_scales", "gather_pages_int8",
           "pool_from_jax"]


@dataclasses.dataclass
class PagedKVCache:
    """One K and one V page array per layer, all in `layout`; an int8
    pool also holds one K and one V scale-page array per layer."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    layout: str = "contig"
    ks: Optional[List[torch.Tensor]] = None
    vs: Optional[List[torch.Tensor]] = None

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"pool layout must be one of {LAYOUTS}, got {self.layout!r}")
        if (self.ks is None) != (self.vs is None):
            raise ValueError("an int8 pool needs both K and V scale pages")

    @staticmethod
    def create(cfg: LlamaConfig, n_pages: int, page_size: int = 128, dtype=torch.bfloat16,
               device=None, layout: str = "contig") -> "PagedKVCache":
        """dtype "int8" makes int8 code pages with f32 scale pages."""
        if layout == "contig":
            shape = (n_pages, cfg.n_kv_head, page_size, cfg.head_dim)
        else:
            shape = (cfg.n_kv_head, n_pages, page_size, cfg.head_dim)
        quant = dtype == "int8"

        def z(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layer)]

        if not quant:
            return PagedKVCache(z(shape, dtype), z(shape, dtype), layout)
        return PagedKVCache(z(shape, torch.int8), z(shape, torch.int8), layout,
                            z(shape[:3], torch.float32), z(shape[:3], torch.float32))

    @property
    def quant(self) -> bool:
        return self.ks is not None

    def layers(self):
        """Per layer: (k, v), or (k, ks, v, vs) for an int8 pool."""
        if self.quant:
            return list(zip(self.k, self.ks, self.v, self.vs))
        return list(zip(self.k, self.v))

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for lc in self.layers() for t in lc)

    @property
    def n_pages(self) -> int:
        return pool_dims(self.k[0], self.layout)[0]

    @property
    def page_size(self) -> int:
        return self.k[0].shape[2]


class PageAllocator:
    """Host-side free-list allocator over physical pages."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV: need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p < 0 or p >= self.n_pages:
                raise ValueError(f"bad page id {p}")
            self._free.append(p)


# ---------------------------------------------------------------------------
# Layer ops: one layer's k / v pages, updated in place
# ---------------------------------------------------------------------------


def _table_at(page_table: torch.Tensor, logical_page: torch.Tensor) -> torch.Tensor:
    """page_table[b, logical_page[b]] -> [B] int32."""
    return page_table.gather(1, logical_page.long()[:, None])[:, 0].to(torch.int32)


def append_token_layer(k_pages, v_pages, k_new, v_new, page_table, positions, layout):
    """Write one token's k_new / v_new [B, Hkv, Dh] per sequence at
    `positions` [B] (kernel 6; the reference appends k and v in two calls)."""
    ps = k_pages.shape[2]
    page = _table_at(page_table, positions // ps)
    slot = (positions % ps).to(torch.int32)
    paged_append(k_pages, v_pages, k_new, v_new, page, slot, layout)


def paginate_fragment_layer_at(pages, frag, page_table, start_page, layout):
    """Copy a dense fragment frag [B, Hkv, C, Dh] into whole pages, its
    first row at logical page start_page[b] (the chunked prefill writes
    chunk c of a prompt at pages [c*C/ps, ...)).  A short tail page is
    padded with zeros; the rows past the data are dead until overwritten."""
    B, Hkv, C, Dh = frag.shape
    ps = pages.shape[2]
    n = -(-C // ps)
    if n * ps != C:
        frag = torch.nn.functional.pad(frag, (0, 0, 0, n * ps - C))
    blocks = frag.reshape(B, Hkv, n, ps, Dh).to(pages.dtype)
    logical = start_page.long()[:, None] + torch.arange(n, device=start_page.device)
    ids = page_table.gather(1, logical).long()  # [B, n]
    # Sequences write in order, as the reference's per-row loop does: rows
    # that share a page (padding rows on the trash page) leave the last one.
    for b in range(B):
        if layout == "contig":
            pages[ids[b]] = blocks[b].transpose(0, 1)  # [n, Hkv, ps, Dh]
        else:
            pages[:, ids[b]] = blocks[b]  # [Hkv, n, ps, Dh]


def paginate_fragment_layer(pages, frag, page_table, layout):
    """paginate_fragment_layer_at from position 0 (a fresh prefill)."""
    start = torch.zeros((frag.shape[0],), dtype=torch.int32, device=frag.device)
    paginate_fragment_layer_at(pages, frag, page_table, start, layout)


def attend_paged_layer(q, k_pages, v_pages, page_table, lengths, layout,
                       scale: Optional[float] = None):
    """Decode attention, q [B, 1, H, Dh] over `lengths` [B] live tokens
    (the current one included) -> [B, 1, H, Dh] (kernel 5)."""
    B, T, H, Dh = q.shape
    Hkv = pool_dims(k_pages, layout)[1]
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / Dh**0.5
    qg = (q[:, 0] * scale).reshape(B, Hkv, rep, Dh)
    out = paged_decode(qg, k_pages, v_pages, page_table, lengths.to(torch.int32), layout)
    return out.reshape(B, 1, H, Dh)


# ---------------------------------------------------------------------------
# Layer ops on an int8 pool: codes and scale pages, updated in place
# ---------------------------------------------------------------------------


def append_token_layer_int8(k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page_table,
                            positions, layout):
    """Quantize one token's k_new / v_new [B, Hkv, Dh] per sequence and
    write codes and scales at `positions` [B] (kernel 11; the reference
    appends payloads and scales of K and of V in four calls)."""
    ps = k_pages.shape[2]
    page = _table_at(page_table, positions // ps)
    slot = (positions % ps).to(torch.int32)
    paged_append_int8(k_pages, ks_pages, v_pages, vs_pages, k_new, v_new, page, slot, layout)


def paginate_fragment_layer_int8_at(pages, spages, frag, page_table, start_page, layout):
    """Quantize a dense fragment frag [B, Hkv, C, Dh] and copy codes and
    scales into whole pages from logical page start_page[b] (see
    paginate_fragment_layer_at; a short tail pads with zero codes and
    scales)."""
    codes, scales = quantize_kv_block(frag)  # [B, Hkv, C, Dh], bf16 [B, Hkv, C]
    paginate_fragment_layer_at(pages, codes, page_table, start_page, layout)
    # Scale pages as pages of 1-value rows: a view, so the writes land.
    paginate_fragment_layer_at(spages.unsqueeze(-1), scales.float()[..., None], page_table,
                               start_page, layout)


def paginate_fragment_layer_int8(pages, spages, frag, page_table, layout):
    """paginate_fragment_layer_int8_at from position 0 (a fresh prefill)."""
    start = torch.zeros((frag.shape[0],), dtype=torch.int32, device=frag.device)
    paginate_fragment_layer_int8_at(pages, spages, frag, page_table, start, layout)


def attend_paged_layer_int8(q, k_pages, ks_pages, v_pages, vs_pages, page_table, lengths,
                            layout, scale: Optional[float] = None):
    """Decode attention, q [B, 1, H, Dh] over `lengths` [B] live tokens of
    one layer's int8 pools -> [B, 1, H, Dh] (kernel 10)."""
    B, T, H, Dh = q.shape
    Hkv = pool_dims(k_pages, layout)[1]
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / Dh**0.5
    qg = (q[:, 0] * scale).reshape(B, Hkv, rep, Dh)
    out = paged_decode_int8(qg, k_pages, ks_pages, v_pages, vs_pages, page_table,
                            lengths.to(torch.int32), layout)
    return out.reshape(B, 1, H, Dh)


# ---------------------------------------------------------------------------
# From the JAX package
# ---------------------------------------------------------------------------


def pool_from_jax(np_pool, layout: str, device=None) -> PagedKVCache:
    """The JAX package's pool, as numpy, -> the port's.

    np_pool is the reference's per-layer tuple pool ((k_l, v_l), ...), or
    ((k_l, ks_l, v_l, vs_l), ...) for int8 pages, or a stacked
    PagedKVCache / PagedQuantKVCache-like mapping or tuple of [L, ...]
    arrays; `layout` names the layout it was made in (the reference's
    THAWK_POOL_LAYOUT)."""

    def conv(arrays):
        return [torch.from_numpy(np.array(a, order="C")).to(device) for a in arrays]

    if isinstance(np_pool, Mapping):
        names = ["k_pages", "v_pages"] + (["ks_pages", "vs_pages"]
                                          if "ks_pages" in np_pool else [])
        parts = [np_pool[n] for n in names]
    elif len(np_pool) in (2, 4) and not isinstance(np_pool[0], (tuple, list)):
        parts = list(np_pool)  # stacked (k, v) or (k, ks, v, vs)
        parts = parts if len(parts) == 2 else [parts[0], parts[2], parts[1], parts[3]]
    else:
        per_layer = list(zip(*np_pool))
        parts = (per_layer if len(per_layer) == 2
                 else [per_layer[0], per_layer[2], per_layer[1], per_layer[3]])
    return PagedKVCache(*[conv(p) for p in parts[:2]], layout, *[conv(p) for p in parts[2:]])
