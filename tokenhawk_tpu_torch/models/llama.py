"""LLaMA-family model as plain functions over per-layer parameters.

Counterpart of tokenhawk_tpu/models/llama.py, dense single-device path.
The reference traces one XLA program (lax.scan over stacked layers,
donated caches); here parameters are a per-layer list, the cache a
per-layer list of [B, Hkv, S, Dh] tensors updated in place, and the
forward is an eager Python loop whose hot operations are the port's
CUDA kernels:

  wqkv / wo / w13 / w2 / output   kernel 1 (Q4_0), kernel 13 (group
                                  codes: Q8_0, Q4_1, Q5_x, k-quants) or
                                  kernel 17 (Q4_K super-blocks, under
                                  THAWK_Q4K_SB=1), matmul + fused RMSNorm
  decode FFN (<= 8 rows)          kernel 2, fused SwiGLU + residual, any
                                  pairing of those weight forms (a
                                  super-block w13, never w2: can_fuse_ffn)
  decode attention                quantized weights: kernel 3, append +
                                  attend in place; dense weights: an
                                  index copy, then kernel 14 (attend only)
  prefill attention               kernel 4, causal flash attention
  int8 cache (QuantKVCache)       kernel 8, quantize + append + attend;
                                  kernel 9, prefill over the int8 cache
  paged decode (forward_paged_*)  kernels 6 + 5, paged append + attend;
                                  chunked prefill gathers pages (kernel 7);
                                  on int8 pages kernels 11, 10 and 12
  speculative verify (paged)      kernel 6 for every row of the block,
                                  kernel 7, then kernel 4
  Fusions.owo (THAWK_FUSED_OWO=1) kernel 15: Wo + residual + norm + FFN +
                                  residual in one entry point, at decode
                                  rows (every forward)
  Fusions.attn (THAWK_FUSED_ATTN=1)  kernel 16: append + attend + Wo +
                                  residual, one token of one sequence
                                  over the dense bf16/f32 cache, H == Hkv

Both fusions are off by default, as in the reference; each model reads
the two variables once, when its LlamaParams are built, and a caller may
set `params.fusions` on a built model.

Weight orientation is [in, out] (y = x @ W) at every public function,
as in the reference, whatever the quantized storage layout.

A GGUF file of llama.cpp's *_M recipes mixes kinds within one family
across layers (Q6_K attn_v / ffn_down on some layers of Q4_K_M).  The
reference stacks its layers, so it re-encodes such a family exactly to a
common group-16 form (to_qk16, which also expands a Q4_K super-block
weight); the port keeps a list of layers, so each layer keeps its own
kind, a super-block one included, and since to_qk16 is exact the
function is the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor, dequantize
from tokenhawk_tpu_torch.ops.attention import update_kv_cache
from tokenhawk_tpu_torch.ops.cuda.ffn import (
    can_fuse_ffn,
    can_fuse_owo_ffn,
    fused_ffn,
    fused_owo_ffn,
)
from tokenhawk_tpu_torch.ops.cuda.flash_attention import flash_attention
from tokenhawk_tpu_torch.ops.cuda.flash_decode import (
    can_fuse_attn_out,
    flash_decode,
    flash_decode_append,
    fused_attn_out,
)
from tokenhawk_tpu_torch.ops.cuda.kv_int8 import flash_attention_int8, flash_decode_int8
from tokenhawk_tpu_torch.ops.kvquant import update_kv_cache_int8
from tokenhawk_tpu_torch.ops.linear import matmul
from tokenhawk_tpu_torch.ops.qweight import (
    ArrayOrQ,
    QWeight,
    concat_qweights,
    q4k_sb_fits,
    take_columns,
)
from tokenhawk_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from tokenhawk_tpu_torch.runtime.paged import (
    PagedKVCache,
    append_attend_paged_layer,
    append_attend_paged_layer_int8,
    append_token_layer,
    gather_pages,
    gather_pages_int8,
    paginate_fragment_layer,
    paginate_fragment_layer_at,
    paginate_fragment_layer_int8,
    paginate_fragment_layer_int8_at,
)


@dataclasses.dataclass
class LayerParams:
    wq: Optional[ArrayOrQ]
    wk: Optional[ArrayOrQ]
    wv: Optional[ArrayOrQ]
    wo: ArrayOrQ
    w1: Optional[ArrayOrQ]
    w2: ArrayOrQ
    w3: Optional[ArrayOrQ]
    attn_norm: torch.Tensor
    ffn_norm: torch.Tensor
    # Fused variants (fuse_params): wqkv = [wq|wk|wv], w13 = [w1|w3].
    wqkv: Optional[ArrayOrQ] = None
    w13: Optional[ArrayOrQ] = None


@dataclasses.dataclass(frozen=True)
class Fusions:
    """The reference's fused decode-layer kernels, off by default as there
    (negative results on its TPU): owo, kernel 15, under THAWK_FUSED_OWO=1;
    attn, kernel 16, under THAWK_FUSED_ATTN=1.  The model takes each where
    its gate passes, as the reference does."""

    owo: bool = False
    attn: bool = False

    @staticmethod
    def from_env() -> "Fusions":
        return Fusions(owo=os.environ.get("THAWK_FUSED_OWO", "0") == "1",
                       attn=os.environ.get("THAWK_FUSED_ATTN", "0") == "1")


@dataclasses.dataclass
class LlamaParams:
    tok_embd: torch.Tensor  # [V, D]
    layers: List[LayerParams]
    norm: torch.Tensor  # [D]
    output: ArrayOrQ  # [D, V]
    # Read from the environment when the model is built.
    fusions: Fusions = dataclasses.field(default_factory=Fusions.from_env)

    @property
    def device(self) -> torch.device:
        return self.tok_embd.device

    def to(self, device) -> "LlamaParams":
        """A copy of every tensor on `device`."""

        def mv(w):
            return None if w is None else w.to(device)

        layers = [LayerParams(**{f.name: mv(getattr(lp, f.name))
                                 for f in dataclasses.fields(LayerParams)})
                  for lp in self.layers]
        return LlamaParams(mv(self.tok_embd), layers, mv(self.norm), mv(self.output),
                           self.fusions)


@dataclasses.dataclass
class KVCache:
    """Dense KV cache, one [B, Hkv, S, Dh] tensor per layer for k and v."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, cfg.n_kv_head, max_seq or cfg.n_ctx, cfg.head_dim)

        def z():
            return torch.zeros(shape, dtype=dtype, device=device)

        return KVCache([z() for _ in range(cfg.n_layer)], [z() for _ in range(cfg.n_layer)])

    def layers(self):
        return list(zip(self.k, self.v))


@dataclasses.dataclass
class QuantKVCache:
    """Dense int8 KV cache (ops/kvquant.py): per layer, int8 codes
    [B, Hkv, S, Dh] and bfloat16 scales [B, Hkv, S] for k and v."""

    k: List[torch.Tensor]
    ks: List[torch.Tensor]
    v: List[torch.Tensor]
    vs: List[torch.Tensor]

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               device=None) -> "QuantKVCache":
        shape = (batch, cfg.n_kv_head, max_seq or cfg.n_ctx, cfg.head_dim)

        def z(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layer)]

        return QuantKVCache(z(shape, torch.int8), z(shape[:3], torch.bfloat16),
                            z(shape, torch.int8), z(shape[:3], torch.bfloat16))

    def layers(self):
        return list(zip(self.k, self.ks, self.v, self.vs))


def cache_from_jax(np_cache, device=None) -> Union[KVCache, QuantKVCache]:
    """The JAX package's dense cache, as numpy, -> the port's: a stacked
    KVCache / QuantKVCache-like tuple of [L, ...] arrays ((k, v) or
    (k, ks, v, vs)), or the unrolled per-layer tuple of such tuples."""

    def conv(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    if isinstance(np_cache[0], (tuple, list)):  # unrolled: one tuple per layer
        parts = [[conv(a) for a in part] for part in zip(*np_cache)]
    else:
        parts = [[conv(a) for a in stacked] for stacked in np_cache]
    return KVCache(*parts) if len(parts) == 2 else QuantKVCache(*parts)


def _attend_and_update(cfg: LlamaConfig, q, k, v, lcache, offsets, positions,
                       prefer_append: bool = True):
    """Write (k, v) into this layer's cache and attend; q [B, T, H, Dh].
    lcache is (k, v) of a bf16/f32 cache or (k, ks, v, vs) of an int8 one.

    Decode (T == 1) on an int8 cache runs kernel 8, which quantizes and
    appends the row at slot lengths-1 = min(position, S-1) and attends
    over lengths tokens.  On a bf16/f32 cache it follows the reference's
    route: with prefer_append (quantized weights) kernel 3, the append
    and the attention in one launch; without it (dense weights) an index
    copy writes the row and kernel 14 attends, as the reference's
    update_kv_cache and flash_decode_dma do.  Prefill writes its block
    with an index copy (quantized first on int8) and runs kernel 4
    (kernel 9): the prompt attends to its own stored, so on int8
    quantized, K / V, as in the reference."""
    B, T, H, Dh = q.shape
    Hkv, S = lcache[0].shape[1], lcache[0].shape[2]
    rep = H // Hkv
    scale = 1.0 / Dh**0.5
    int8 = len(lcache) == 4
    if T == 1:
        qg = (q[:, 0] * scale).reshape(B, Hkv, rep, Dh)
        lengths = torch.clamp(positions[:, 0] + 1, max=S).to(torch.int32)
        if int8:
            out = flash_decode_int8(qg, k[:, 0], v[:, 0], *lcache, lengths)
        elif prefer_append:
            out = flash_decode_append(qg, k[:, 0], v[:, 0], *lcache, lengths)
        else:
            update_kv_cache(*lcache, k, v, offsets)
            out = flash_decode(qg, *lcache, lengths)
        return out.reshape(B, 1, H, Dh)
    qg = (q * scale).reshape(B, T, Hkv, rep, Dh).permute(0, 2, 3, 1, 4)
    if int8:
        update_kv_cache_int8(*lcache, k, v, offsets)
        out = flash_attention_int8(qg, *lcache, positions[:, 0].to(torch.int32))
    else:
        update_kv_cache(*lcache, k, v, offsets)
        out = flash_attention(qg, *lcache, positions[:, 0].to(torch.int32))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)


def _ffn_block(cfg: LlamaConfig, x, lp: LayerParams):
    """SwiGLU MLP with residual: x + silu(norm(x)@w1)*(norm(x)@w3) @ w2.

    At most 8 rows over quantized w13/w2 (any pairing of Q4_0 and
    group-code forms; a super-block w13 too): kernel 2 in one call.
    Otherwise (prefill, dense weights): two matmuls and a SiLU, as the
    reference's unfused form."""
    rows = x.numel() // x.shape[-1]
    if can_fuse_ffn(lp.w13, lp.w2, rows):
        return fused_ffn(x, lp.w13, lp.w2, lp.ffn_norm, eps=cfg.rms_norm_eps)
    if lp.w13 is not None:
        gate_up = matmul(x, lp.w13, lp.ffn_norm, eps=cfg.rms_norm_eps)
        F = gate_up.shape[-1] // 2
        g, u = gate_up[..., :F], gate_up[..., F:]
    else:
        g = matmul(x, lp.w1, lp.ffn_norm, eps=cfg.rms_norm_eps)
        u = matmul(x, lp.w3, lp.ffn_norm, eps=cfg.rms_norm_eps)
    gate = torch.nn.functional.silu(g.float()).to(x.dtype)
    return x + matmul(gate * u, lp.w2)


def _qkv(cfg: LlamaConfig, x, lp: LayerParams, cos, sin):
    """Normed q / k / v projections with RoPE: [B, T, H|Hkv, Dh] each."""
    B, T, D = x.shape
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    Dq, Dkv = H * Dh, Hkv * Dh
    eps = cfg.rms_norm_eps
    if lp.wqkv is not None:
        qkv = matmul(x, lp.wqkv, lp.attn_norm, eps=eps)  # [B, T, Dq + 2*Dkv]
        q = qkv[..., :Dq].reshape(B, T, H, Dh)
        k = qkv[..., Dq:Dq + Dkv].reshape(B, T, Hkv, Dh)
        v = qkv[..., Dq + Dkv:].reshape(B, T, Hkv, Dh)
    else:
        q = matmul(x, lp.wq, lp.attn_norm, eps=eps).reshape(B, T, H, Dh)
        k = matmul(x, lp.wk, lp.attn_norm, eps=eps).reshape(B, T, Hkv, Dh)
        v = matmul(x, lp.wv, lp.attn_norm, eps=eps).reshape(B, T, Hkv, Dh)
    return apply_rope(q, cos, sin, cfg.rope_style), apply_rope(k, cos, sin, cfg.rope_style), v


def _wo_ffn_block(cfg: LlamaConfig, x, ctx, lp: LayerParams, fusions: Fusions):
    """x + ctx @ Wo, then the SwiGLU MLP block with its residual; kernel 15
    in one call where fusions.owo asks for it and its gate passes."""
    B, T = ctx.shape[:2]
    ctx = ctx.reshape(B, T, -1)
    if fusions.owo and can_fuse_owo_ffn(lp.wo, lp.w13, lp.w2, B * T):
        return fused_owo_ffn(ctx, x, lp.wo, lp.w13, lp.w2, lp.ffn_norm, eps=cfg.rms_norm_eps)
    x = x + matmul(ctx, lp.wo)
    return _ffn_block(cfg, x, lp)


def _layer_forward(cfg: LlamaConfig, x, lp: LayerParams, lcache, cos, sin, offsets,
                   positions, fusions: Fusions):
    """One layer of the dense-cache forward.  Where fusions.attn asks for it
    (one token of one sequence over a bf16/f32 cache with quantized weights
    and H == Hkv) and its gate passes, kernel 16 runs the attention block
    and the layer goes on with the FFN block, as the reference does."""
    B, T = x.shape[:2]
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    quantized = isinstance(lp.wqkv if lp.wqkv is not None else lp.wq, QWeight)
    if (fusions.attn and quantized and B == 1 and T == 1 and cfg.n_head == cfg.n_kv_head
            and len(lcache) == 2):
        S = lcache[0].shape[2]
        if can_fuse_attn_out(lp.wo, B, T, 1, cfg.head_dim, S):
            lengths = torch.clamp(positions[:, 0] + 1, max=S).to(torch.int32)
            x = fused_attn_out(x, q, k, v, *lcache, lengths, lp.wo)
            return _ffn_block(cfg, x, lp)
    ctx = _attend_and_update(cfg, q, k, v, lcache, offsets, positions,
                             prefer_append=quantized)
    return _wo_ffn_block(cfg, x, ctx, lp, fusions)


def forward(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
            cache: Union[KVCache, QuantKVCache], offsets: torch.Tensor):
    """Run a token block [B, T] through all layers; `offsets` [B] int32
    is each sequence's cache write offset.  Returns the hidden states
    [B, T, D] (before the final norm) and the cache, updated in place."""
    B, T = tokens.shape
    x = params.tok_embd[tokens]
    positions = offsets.long()[:, None] + torch.arange(T, device=tokens.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for lp, lcache in zip(params.layers, cache.layers()):
        x = _layer_forward(cfg, x, lp, lcache, cos, sin, offsets, positions, params.fusions)
    return x, cache


# ---------------------------------------------------------------------------
# Paged KV forwards (runtime/paged.py pools)
# ---------------------------------------------------------------------------


def _prefill_attention(q, k, v, offsets):
    """Causal attention of q [B, T, H, Dh] (RoPE applied) over dense
    k / v [B, Hkv, S, Dh] at query positions offsets[b] + t (kernel 4)."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[1]
    qg = (q * (1.0 / Dh**0.5)).reshape(B, T, Hkv, H // Hkv, Dh).permute(0, 2, 3, 1, 4)
    out = flash_attention(qg, k, v, offsets.to(torch.int32))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)


def forward_paged_decode(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
                         cache: PagedKVCache, page_table: torch.Tensor,
                         lengths: torch.Tensor):
    """One decode step over the paged pool: tokens [B, 1] land at position
    lengths[b] (tokens already stored), through page_table [B, max_pages]
    int32.  Each layer appends its K / V row and attends over lengths + 1
    tokens in one launch.  Returns (hidden [B, 1, D], the pool, updated in
    place)."""
    x = params.tok_embd[tokens]
    positions = lengths.long()[:, None]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    stored = lengths.to(torch.int32)
    for lp, lc in zip(params.layers, cache.layers()):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        if cache.quant:  # kernel 10 with kernel 11 folded in
            ctx = append_attend_paged_layer_int8(q, *lc, k[:, 0], v[:, 0], page_table, stored,
                                                 cache.layout)
        else:  # kernel 5 with kernel 6 folded in
            ctx = append_attend_paged_layer(q, *lc, k[:, 0], v[:, 0], page_table, stored,
                                            cache.layout)
        x = _wo_ffn_block(cfg, x, ctx, lp, params.fusions)
    return x, cache


def forward_paged_prefill(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
                          cache: PagedKVCache, page_table: torch.Tensor):
    """Prefill fresh prompts tokens [B, Tb] (positions 0..Tb-1) straight
    into their pages: the block attends only to itself (kernel 4, over
    its unquantized K / V even on an int8 pool, as the reference does) and
    each layer's K / V page out in place.  Padding rows past a prompt are
    causally masked from its real rows.  Returns (hidden [B, Tb, D], the
    pool)."""
    B, T = tokens.shape
    x = params.tok_embd[tokens]
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    for lp, lc in zip(params.layers, cache.layers()):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        k_b = k.transpose(1, 2).contiguous()  # [B, Hkv, T, Dh]
        v_b = v.transpose(1, 2).contiguous()
        ctx = _prefill_attention(q, k_b, v_b, zeros)
        if cache.quant:
            k_l, ks_l, v_l, vs_l = lc
            paginate_fragment_layer_int8(k_l, ks_l, k_b, page_table, cache.layout)
            paginate_fragment_layer_int8(v_l, vs_l, v_b, page_table, cache.layout)
        else:
            k_l, v_l = lc
            paginate_fragment_layer(k_l, k_b, page_table, cache.layout)
            paginate_fragment_layer(v_l, v_b, page_table, cache.layout)
        x = _wo_ffn_block(cfg, x, ctx, lp, params.fusions)
    return x, cache


def forward_paged_prefill_cont(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
                               cache: PagedKVCache, page_table: torch.Tensor,
                               start: torch.Tensor, n_new: torch.Tensor):
    """One chunk tokens [B, C] of longer prompts, its first row at the
    page-aligned position start[b], n_new[b] of its rows real: the chunk's
    K / V page out in place, then every row attends to the slot's pages
    gathered dense (kernel 7; on an int8 pool kernel 12, dequantized to
    the activation dtype) up to its own position (kernel 4).

    RoPE positions are the reference's: start + t for real rows, 0 for
    padding rows.  The attention kernel places query t at start + t for
    every row, which gives each real row exactly the reference's mask;
    padding rows' outputs are discarded on both sides.  Returns
    (hidden [B, C, D], the pool)."""
    B, C = tokens.shape
    x = params.tok_embd[tokens]
    t = torch.arange(C, device=tokens.device)[None, :]
    start = start.to(tokens.device)
    positions = torch.where(t < n_new.to(tokens.device).long()[:, None],
                            start.long()[:, None] + t, 0)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    start_page = start // cache.page_size
    for lp, lc in zip(params.layers, cache.layers()):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        if cache.quant:
            k_l, ks_l, v_l, vs_l = lc
            paginate_fragment_layer_int8_at(k_l, ks_l, k.transpose(1, 2), page_table,
                                            start_page, cache.layout)
            paginate_fragment_layer_int8_at(v_l, vs_l, v.transpose(1, 2), page_table,
                                            start_page, cache.layout)
            kg, vg = gather_pages_int8(*lc, page_table, cache.layout, x.dtype)
        else:
            k_l, v_l = lc
            paginate_fragment_layer_at(k_l, k.transpose(1, 2), page_table, start_page,
                                       cache.layout)
            paginate_fragment_layer_at(v_l, v.transpose(1, 2), page_table, start_page,
                                       cache.layout)
            kg, vg = gather_pages(k_l, v_l, page_table, cache.layout)
        ctx = _prefill_attention(q, kg, vg, start)
        x = _wo_ffn_block(cfg, x, ctx, lp, params.fusions)
    return x, cache


def forward_paged_verify(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
                         cache: PagedKVCache, page_table: torch.Tensor, start: torch.Tensor,
                         adv: torch.Tensor):
    """The target's verify block of speculative decoding over bf16/f32
    pages: tokens [B, T] (T = gamma+1) at positions start[b] + adv[b]*t,
    any alignment (adv 1 for a live slot, 0 for a frozen one).  Each
    layer writes all B*T K / V rows into their pages in one kernel-6
    launch, gathers the slot's pages dense (kernel 7) and attends with
    kernel 4 from offset start.  Rejected drafts' rows stay past the
    committed frontier, masked by length, and the next round overwrites
    them (no rollback, as in the reference).

    A frozen slot's rows all sit at `start`: they write one (page, slot)
    in the same launch, and which row lands is unordered, which is
    harmless since the row is past the slot's committed tokens (like the
    shared trash page).  Kernel 4 places such a slot's query t at
    start + t where the reference keeps every query at start; the rows
    are discarded on both sides.  Returns (hidden [B, T, D], the pool)."""
    if cache.quant:
        raise ValueError("the speculative verify runs over bf16/f32 pages")
    B, T = tokens.shape
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dev = tokens.device
    x = params.tok_embd[tokens]
    start = start.to(dev)
    positions = start.long()[:, None] + adv.to(dev).long()[:, None] * torch.arange(T, device=dev)
    cos, sin = rope_cos_sin(positions, Dh, cfg.rope_theta)
    rows_table = page_table.repeat_interleave(T, dim=0)  # one table row per block row
    flat = positions.reshape(-1)
    for lp, (k_l, v_l) in zip(params.layers, cache.layers()):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        append_token_layer(k_l, v_l, k.reshape(B * T, Hkv, Dh), v.reshape(B * T, Hkv, Dh),
                           rows_table, flat, cache.layout)
        kg, vg = gather_pages(k_l, v_l, page_table, cache.layout)
        ctx = _prefill_attention(q, kg, vg, start)
        x = _wo_ffn_block(cfg, x, ctx, lp, params.fusions)
    return x, cache


def logits_from_hidden(cfg: LlamaConfig, params: LlamaParams, hidden: torch.Tensor):
    """Final RMSNorm + output projection -> f32 logits [..., V] (rounded
    through the activation dtype first, as the reference does)."""
    return matmul(hidden, params.output, params.norm, eps=cfg.rms_norm_eps).float()


# ---------------------------------------------------------------------------
# Load-time transforms
# ---------------------------------------------------------------------------


def rope_half_params(cfg: LlamaConfig, params: LlamaParams):
    """Interleaved RoPE -> "half" RoPE by permuting each head's wq/wk output
    columns (new j = old 2j for j < Dh/2, new Dh/2+j = old 2j+1).  The
    cache then stores permuted keys; attention is unchanged.  Run before
    fuse_params.  Returns (cfg', params')."""
    if cfg.rope_style != "interleaved":
        return cfg, params
    Dh = cfg.head_dim
    half = Dh // 2
    within = np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])

    def perm(n_heads):
        p = (np.arange(n_heads)[:, None] * Dh + within[None, :]).reshape(-1)
        return torch.from_numpy(p).to(params.device)

    pq, pk = perm(cfg.n_head), perm(cfg.n_kv_head)
    layers = []
    for lp in params.layers:
        if lp.wqkv is not None:
            raise ValueError("rope_half_params must run before fuse_params")
        layers.append(dataclasses.replace(lp, wq=take_columns(lp.wq, pq),
                                          wk=take_columns(lp.wk, pk)))
    return (dataclasses.replace(cfg, rope_style="half"),
            dataclasses.replace(params, layers=layers))


def fuse_params(params: LlamaParams) -> LlamaParams:
    """wq|wk|wv -> wqkv and w1|w3 -> w13 in every layer (one matmul
    instead of three, and w13 is what kernel 2 reads).  Weights of mixed
    forms (a Q6_K wv beside Q4_K wq / wk: other group and no mins) stay
    separate, as in the reference."""

    def fusable(ws):
        qws = [w for w in ws if isinstance(w, QWeight)]
        if not qws:
            return True
        return len(qws) == len(ws) and len(
            {(w.kind, w.group, w.mins is None) for w in qws}) == 1

    def cat(ws):
        if isinstance(ws[0], QWeight):
            return concat_qweights(ws)
        return torch.cat(ws, dim=-1)

    layers = []
    for lp in params.layers:
        upd = {}
        if lp.wq is not None and fusable([lp.wq, lp.wk, lp.wv]):
            upd.update(wqkv=cat([lp.wq, lp.wk, lp.wv]), wq=None, wk=None, wv=None)
        if lp.w1 is not None and fusable([lp.w1, lp.w3]):
            upd.update(w13=cat([lp.w1, lp.w3]), w1=None, w3=None)
        layers.append(dataclasses.replace(lp, **upd))
    return dataclasses.replace(params, layers=layers)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device=None, scale: float = 0.02, quant: Optional[str] = None,
                sb: bool = False) -> LlamaParams:
    """Random parameters drawn from `generator` (which lives on `device`).

    quant="q4_0" quantizes every projection (wq..w3, output) on the
    device as it is drawn; "q8_0" and "q4_k_m" draw codes and scales
    directly (QWeight.random), Q8_0 everywhere or llama.cpp's Q4_K_M mix:
    Q4_K, with Q6_K for the output and for wv and w2 on the layers that
    recipe gives more bits.  With sb (q4_k_m only) the Q4_K weights take
    the super-block form where the loader's THAWK_Q4K_SB=1 would put them:
    every one but w2, at widths q4k_sb_fits.  A full-width model never
    exists densely."""
    if quant not in (None, "q4_0", "q8_0", "q4_k_m") or (sb and quant != "q4_k_m"):
        raise ValueError(f"unsupported quant {quant!r}{' with sb' if sb else ''}")
    D, F, V = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    Dkv = cfg.n_embd_kv

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device) * scale

    def w(k, n, form="q4_k", sb_ok=True):
        if quant == "q4_0":
            return QWeight.quantize(randn(k, n))
        if quant is not None:
            form = "q8_0" if quant == "q8_0" else form
            if form == "q4_k" and sb and sb_ok and q4k_sb_fits(k):
                form = "q4k_sb"
            return QWeight.random(k, n, form, generator, device, std=scale)
        return randn(k, n).to(dtype)

    def ones():
        return torch.ones(D, dtype=dtype, device=device)

    def layer(i):
        more = "q6_k" if q4_k_m_more_bits(i, cfg.n_layer) else "q4_k"
        return LayerParams(wq=w(D, D), wk=w(D, Dkv), wv=w(D, Dkv, more), wo=w(D, D),
                           w1=w(D, F), w2=w(F, D, more, sb_ok=False), w3=w(D, F),
                           attn_norm=ones(), ffn_norm=ones())

    layers = [layer(i) for i in range(cfg.n_layer)]
    return LlamaParams(tok_embd=randn(V, D).to(dtype), layers=layers, norm=ones(),
                       output=w(D, V, "q6_k"))


def q4_k_m_more_bits(layer: int, n_layer: int) -> bool:
    """The layers whose attn_v and ffn_down llama.cpp's Q4_K_M recipe
    stores in Q6_K (its use_more_bits): the first and last eighth, and
    every third layer between."""
    return (layer < n_layer // 8 or layer >= 7 * n_layer // 8
            or (layer - n_layer // 8) % 3 == 2)


HostTensor = Union[np.ndarray, QuantizedTensor]


def _device_weight(t: HostTensor, dtype, device, transpose: bool,
                   scale_dtype=torch.float32) -> ArrayOrQ:
    if isinstance(t, QWeight):
        return t.to(device)  # built by the loader (k-quants)
    if isinstance(t, QuantizedTensor):
        if transpose:
            return QWeight.from_quantized_tensor(t, device, scale_dtype)
        t = dequantize(t)
    arr = np.asarray(t, np.float32)
    if transpose:
        arr = arr.T
    # np.array copies: the reader's f32 tensors are read-only views of the mmap.
    return torch.from_numpy(np.array(arr, order="C")).to(device=device, dtype=dtype)


def params_from_ggml(cfg: LlamaConfig, tensors: Dict[str, HostTensor], dtype=torch.bfloat16,
                     device=None, scale_dtype=torch.float32) -> LlamaParams:
    """Device parameters from loaded GGML tensors: 2-D projections go from
    GGML's [out, in] to [in, out] (quantized kinds stay quantized, their
    sides rounded to scale_dtype; a QWeight the loader built passes
    through); the embedding table and the norm gains are dense."""

    def get(name, transpose=True):
        return _device_weight(tensors[name], dtype, device, transpose, scale_dtype)

    layers = []
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        layers.append(LayerParams(
            wq=get(p + "attention.wq.weight"), wk=get(p + "attention.wk.weight"),
            wv=get(p + "attention.wv.weight"), wo=get(p + "attention.wo.weight"),
            w1=get(p + "feed_forward.w1.weight"), w2=get(p + "feed_forward.w2.weight"),
            w3=get(p + "feed_forward.w3.weight"),
            attn_norm=get(p + "attention_norm.weight", False),
            ffn_norm=get(p + "ffn_norm.weight", False)))
    return LlamaParams(tok_embd=get("tok_embeddings.weight", False), layers=layers,
                       norm=get("norm.weight", False), output=get("output.weight"))


def params_from_jax(np_params: Mapping, dtype=torch.float32, device=None) -> LlamaParams:
    """The JAX package's parameters, as numpy, -> the port's.

    np_params maps LlamaParams field names (tok_embd, layers, norm,
    output) to arrays; `layers` is a sequence of mappings with LayerParams
    field names (unrolled) or one mapping of [L, ...] stacked leaves.  A
    weight is an ndarray [K, N] (dense) or a mapping of the reference's
    QWeight fields (qs, scales, mins, scales_hi, kind, group; a q4_0
    mapping may hold only the first three)."""

    def conv(w, layer=None):
        if w is None:
            return None
        if isinstance(w, Mapping):
            arrays = {k: (v if layer is None or v is None else v[layer])
                      for k, v in w.items() if k in ("qs", "scales", "mins", "scales_hi")}
            return QWeight.from_jax(w.get("kind", "q4_0"), group=w.get("group", 32),
                                    device=device, **arrays)
        a = np.asarray(w if layer is None else w[layer], np.float32)
        return torch.from_numpy(np.array(a, order="C")).to(device=device, dtype=dtype)

    def gain(g, layer=None):  # the reference keeps gains [1, D] on a TPU
        return conv(g, layer).reshape(-1)

    def layer_params(get, layer=None):
        kw = {f.name: conv(get(f.name), layer) for f in dataclasses.fields(LayerParams)
              if not f.name.endswith("norm")}
        return LayerParams(attn_norm=gain(get("attn_norm"), layer),
                           ffn_norm=gain(get("ffn_norm"), layer), **kw)

    lay = np_params["layers"]
    if isinstance(lay, Mapping):  # stacked [L, ...] leaves
        layers = [layer_params(lay.get, i) for i in range(len(lay["attn_norm"]))]
    else:
        layers = [layer_params(lp.get) for lp in lay]
    return LlamaParams(tok_embd=conv(np_params["tok_embd"]), layers=layers,
                       norm=gain(np_params["norm"]), output=conv(np_params["output"]))
