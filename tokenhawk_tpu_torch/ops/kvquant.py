"""Int8 KV-cache codec, cache updates and reference attention.

Counterpart of tokenhawk_tpu/ops/kvquant.py.  Each cached K/V row
quantizes per (sequence, head, token) over the head dimension: an int8
payload and one scale, stored bf16 in the dense cache and f32 in the
paged pool (runtime/paged.py).  Scales keep the token axis innermost:
[B, Hkv, S] beside the [B, Hkv, S, Dh] payload.

The codec matches the reference bit for bit, and so do the kernels that
quantize (csrc/kv_int8.cuh):
  scale = amax / 127 in f32 (a division);
  inv   = 1 / scale, 0 where the scale is 0, then x * inv (a multiply);
  q     = round half to even, clipped to +-127;
  the stored scale is rounded to bf16, while the payload was quantized
  with the unrounded f32 scale.

The attention kernels over the int8 cache (ops/cuda/kv_int8.py,
ops/cuda/paged_int8.py) compute exact attention over the dequantized
cache; `attend_cache_int8` is their plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tokenhawk_tpu_torch.ops.attention import attend_cache


def quantize_kv_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Dh] f32/bf16 -> (int8 [..., Dh], scales bf16 [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not always the rounded quotient.
    scale = amax / torch.full_like(amax, 127.0)
    live = scale > 0
    inv = torch.where(live, 1.0 / torch.where(live, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(int8 [..., Dh], scales [...]) -> f32 [..., Dh]."""
    return q.float() * scales[..., None].float()


def update_kv_cache_int8(k_cache, ks_cache, v_cache, vs_cache, k_new, v_new, offsets) -> None:
    """Quantize k_new / v_new [B, T, Hkv, Dh] and write payloads and scales
    at each sequence's offset, in place (the reference returns new
    arrays).  offsets stays on the device: no host sync."""
    B, T = k_new.shape[:2]
    dev = k_cache.device
    bi = torch.arange(B, device=dev)[:, None]
    si = offsets.to(dev).long()[:, None] + torch.arange(T, device=dev)
    for cache, scales, new in ((k_cache, ks_cache, k_new), (v_cache, vs_cache, v_new)):
        q, s = quantize_kv_block(new)  # [B, T, Hkv, Dh], [B, T, Hkv]
        cache[bi, :, si] = q
        scales[bi, :, si] = s.to(scales.dtype)


def attend_cache_int8(q, k_cache, ks_cache, v_cache, vs_cache, q_positions,
                      scale: float | None = None) -> torch.Tensor:
    """q [B, T, H, Dh] over the int8 cache (payloads [B, Hkv, S, Dh],
    scales [B, Hkv, S]), q_positions [B, T] -> [B, T, H, Dh] in q.dtype:
    the dequantized cache through `attend_cache` (f32 math)."""
    return attend_cache(q, dequantize_kv(k_cache, ks_cache), dequantize_kv(v_cache, vs_cache),
                        q_positions, scale=scale)
