"""Paged KV cache: fixed-size pages allocated on demand, mapped through a
per-sequence page table (counterpart of tokenhawk_tpu/runtime/paged.py,
bf16/f32 pages).

  pool.k[l], pool.v[l] : one layer's pages, [n_pages, Hkv, ps, Dh] in the
                         "contig" (page-major) layout, the default, or
                         [Hkv, n_pages, ps, Dh] in the "head" layout
  page_table           : [B, max_pages] int32 physical page ids
  lengths              : [B] tokens currently stored

The pool keeps per-layer lists (as the port keeps per-layer weights), so
the reference's stacked `PagedKVCache` and its unrolled per-layer tuple
pool are one class here.  The layout is an argument of the pool, stored
on it when it is made and passed down to every op and kernel; nothing
reads it from the environment (the reference reads THAWK_POOL_LAYOUT at
trace time, and infers the head axis from the number of dimensions).

Decode appends and attention run kernels 6 and 5, the chunked-prefill
gather kernel 7 (ops/cuda/paged_decode.py); whole-page fragment writes
are plain index copies, as in the reference.  Pages are updated in place.
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

__all__ = ["LAYOUTS", "PagedKVCache", "PageAllocator", "append_token_layer",
           "paginate_fragment_layer", "paginate_fragment_layer_at", "attend_paged_layer",
           "gather_pool_payload", "gather_pages", "pool_from_jax"]


@dataclasses.dataclass
class PagedKVCache:
    """One K and one V page array per layer, all in `layout`."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    layout: str = "contig"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"pool layout must be one of {LAYOUTS}, got {self.layout!r}")

    @staticmethod
    def create(cfg: LlamaConfig, n_pages: int, page_size: int = 128, dtype=torch.bfloat16,
               device=None, layout: str = "contig") -> "PagedKVCache":
        if layout == "contig":
            shape = (n_pages, cfg.n_kv_head, page_size, cfg.head_dim)
        else:
            shape = (cfg.n_kv_head, n_pages, page_size, cfg.head_dim)

        def z():
            return torch.zeros(shape, dtype=dtype, device=device)

        return PagedKVCache([z() for _ in range(cfg.n_layer)],
                            [z() for _ in range(cfg.n_layer)], layout)

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
# From the JAX package
# ---------------------------------------------------------------------------


def pool_from_jax(np_pool, layout: str, device=None) -> PagedKVCache:
    """The JAX package's bf16/f32 pool, as numpy, -> the port's.

    np_pool is the reference's per-layer tuple pool ((k_l, v_l), ...) or
    a stacked PagedKVCache-like mapping/pair of [L, ...] arrays; `layout`
    names the layout it was made in (the reference's THAWK_POOL_LAYOUT)."""

    def conv(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    if isinstance(np_pool, Mapping):
        ks, vs = np_pool["k_pages"], np_pool["v_pages"]
    elif len(np_pool) == 2 and not isinstance(np_pool[0], (tuple, list)):
        ks, vs = np_pool
    else:
        ks, vs = zip(*np_pool)
    return PagedKVCache([conv(k) for k in ks], [conv(v) for v in vs], layout)
