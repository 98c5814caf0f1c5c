"""Attention over a dense KV cache in plain PyTorch.

Counterpart of tokenhawk_tpu/ops/attention.py: the reference functions
the attention kernels (ops/cuda/flash_decode.py, flash_attention.py) are
checked against.  GQA: queries have H heads, the cache Hkv, H % Hkv == 0.
A query at absolute position p attends to cache slots <= p.

`attend_stats` is the softmax-partials form (tokenhawk_tpu/parallel/
ring.py _block_attend_stats) the plain versions of kernels 18 and 19
compute.
"""

from __future__ import annotations

import torch

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def attend_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 q_positions: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """q [B, T, H, Dh]; caches [B, Hkv, S, Dh]; q_positions [B, T] ->
    [B, T, H, Dh] in q.dtype (f32 math)."""
    B, T, H, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / Dh**0.5
    qg = q.reshape(B, T, Hkv, rep, Dh).float()
    scores = torch.einsum("bthrd,bhsd->bhrts", qg, k_cache.float()) * scale
    key_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = key_pos <= q_positions[:, :, None]  # [B, T, S]
    scores = torch.where(mask[:, None, None], scores, _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhrts,bhsd->bthrd", probs, v_cache.float())
    return ctx.reshape(B, T, H, Dh).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write k_new/v_new [B, T, Hkv, Dh] at each sequence's offset, in
    place (the reference returns new arrays; the port updates the cache
    it is given).  A block that would run past the cache end starts at
    S - T instead, as the reference's dynamic_update_slice clamps its
    start.  offsets stays on the device: no host sync."""
    B, T = k_new.shape[:2]
    S = k_cache.shape[2]
    bi = torch.arange(B, device=k_cache.device)[:, None]
    start = offsets.to(k_cache.device).long().clamp(0, S - T)
    si = start[:, None] + torch.arange(T, device=k_cache.device)
    k_cache[bi, :, si] = k_new.to(k_cache.dtype)
    v_cache[bi, :, si] = v_new.to(v_cache.dtype)


def attend_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor):
    """Softmax partials of grouped queries q [B, Hkv, rep, T, Dh] (scaled)
    over k / v [B, Hkv, S, Dh] under mask [B, T, S] (True: visible), f32:
    (o [B, Hkv, rep, T, Dh], m [B, Hkv, rep, T], l [B, Hkv, rep, T]) with m
    the largest visible score and o, l the sums of exp(s - m) * v and of
    exp(s - m) over the visible keys.  A row that sees no key gets
    (0, _MASK_VALUE, 0)."""
    vis = mask[:, None, None]
    s = torch.einsum("bhrtd,bhsd->bhrts", q.float(), k.float())
    s = torch.where(vis, s, _MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("bhrts,bhsd->bhrtd", p, v.float()), m, p.sum(dim=-1)
