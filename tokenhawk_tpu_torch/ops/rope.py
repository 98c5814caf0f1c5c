"""Rotary position embeddings (counterpart of tokenhawk_tpu/ops/rope.py).

Two conventions:
  - "interleaved": rotate adjacent (x[2i], x[2i+1]) pairs (GGML);
  - "half": rotate (x[i], x[i+d/2]) pairs — what the loader switches to
    after permuting the wq/wk columns (models.llama.rope_half_params).
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, base: float = 10000.0):
    """positions [..., T] int -> cos/sin [..., T, head_dim//2] f32."""
    half = head_dim // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = base ** (-2.0 * i / head_dim)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "interleaved") -> torch.Tensor:
    """x [B, T, H, Dh]; cos/sin [B, T, Dh//2] -> same shape/dtype as x."""
    dtype = x.dtype
    x = x.float()
    c = cos[:, :, None, :]  # broadcast over heads
    s = sin[:, :, None, :]
    if style == "interleaved":
        x0 = x[..., 0::2]
        x1 = x[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape)
    elif style == "half":
        half = x.shape[-1] // 2
        x0 = x[..., :half]
        x1 = x[..., half:]
        out = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    return out.to(dtype)
