"""Tensor parallelism over torch.distributed (counterpart of tokenhawk_tpu/parallel/tp.py).

Megatron-style TP over the model axis (parallel/mesh.py TpMesh): every
rank of the group is one process with one device and holds its shard of
the weights and of the KV heads; the reference runs the same bodies under
shard_map.

  per layer:   wq/wk/wv column-parallel (fused per shard as
               [wq_s|wk_s|wv_s]) -> local heads -> local attention ->
               wo row-parallel -> all_reduce          (1 all-reduce)
               w1/w3 column-parallel -> SiLU -> w2 row-parallel ->
               all_reduce                              (1 all-reduce)
  embedding:   vocab-parallel gather + all_reduce
  logits:      vocab-column matmul (kernel 1, 13 or 17 at V/tp columns,
               the final norm fused) + all_gather
  sampling:    replicated: every rank samples the same gathered logits
               from the same (seed, counter) streams, so every rank draws
               the same token and nothing is broadcast.

The layer bodies are models/llama.py's forwards with their `tp` argument
(the reference's psum hooks): its `_embed_vocab_parallel`,
`_layer_forward_tp`, `_forward_tp` and `_logits_tp` are `embed`,
`_layer_forward`, `forward` and `logits_from_hidden` given a TpMesh.  The
step functions are runtime/engine.py's and runtime/speculative.py's.  The
kernels run at the rank-local widths.

Weight layout: the port's weights are output-major (ops/qweight.py), so a
column-parallel shard is a run of contiguous rows of every tensor of the
weight, and a row-parallel shard a run of whole 32-weight blocks in each
row (whole super-blocks for the q4k_sb kind).  Nothing is packed per
shard: the reference's q4_0 per-K-shard packing (pack_q4_rows) has no
counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import KVCache, LayerParams, LlamaParams
from tokenhawk_tpu_torch.ops.qweight import ArrayOrQ, QWeight, concat_qweights
from tokenhawk_tpu_torch.parallel.mesh import TpMesh
from tokenhawk_tpu_torch.runtime import speculative
from tokenhawk_tpu_torch.runtime.engine import (
    make_decode_fn,
    make_decode_fn_dynamic,
    make_prefill_fn,
)
from tokenhawk_tpu_torch.tokenizer import EOS_ID

# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

COL_PARALLEL = ("wq", "wk", "wv", "w1", "w3", "wqkv", "w13")
ROW_PARALLEL = ("wo", "w2")


def validate_tp(cfg: LlamaConfig, tp: int):
    for name, v in (("n_kv_head", cfg.n_kv_head), ("n_vocab", cfg.n_vocab),
                    ("n_ff", cfg.n_ff)):
        if v % tp:
            raise ValueError(f"tp={tp} must divide {name}={v}")


def local_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """A config of one rank's widths (heads, n_embd, n_ff and n_vocab over
    tp; head_dim kept): the shapes of its cache and page pool."""
    validate_tp(cfg, tp)
    return dataclasses.replace(cfg, n_embd=cfg.n_embd // tp, n_head=cfg.n_head // tp,
                               n_kv_head=cfg.n_kv_head // tp, n_ff=cfg.n_ff // tp,
                               n_vocab=cfg.n_vocab // tp)


def slice_cols(w: ArrayOrQ, lo: int, hi: int) -> ArrayOrQ:
    """Output columns [lo, hi) of a [K, N] weight (copies)."""
    if isinstance(w, QWeight):
        return w._replace(lambda t: t[lo:hi].contiguous())
    return w[:, lo:hi].contiguous()


def slice_rows(w: ArrayOrQ, lo: int, hi: int) -> ArrayOrQ:
    """Input rows [lo, hi) of a [K, N] weight (copies): whole blocks of
    each output row's codes and sides."""
    if not isinstance(w, QWeight):
        return w[lo:hi].contiguous()
    unit = 256 if w.kind == "q4k_sb" else 32
    if lo % unit or hi % unit:
        raise ValueError(f"a {w.kind} weight splits along K at multiples of {unit}, "
                         f"not [{lo}, {hi})")

    def cut(t, per):  # columns of t at `per` inputs a column
        return t[:, lo // per:hi // per].contiguous()

    if w.kind == "q4_0":
        return dataclasses.replace(w, qs=cut(w.qs, 2), scales=cut(w.scales, 32))
    if w.kind == "qk":
        return dataclasses.replace(w, qs=cut(w.qs, 1), scales=cut(w.scales, w.group),
                                   mins=None if w.mins is None else cut(w.mins, w.group))
    g = w.scmn.shape[1] // 2  # q4k_sb: [sc | mn], one byte each a group of 32
    scmn = torch.cat([w.scmn[:, lo // 32:hi // 32], w.scmn[:, g + lo // 32:g + hi // 32]], 1)
    return dataclasses.replace(w, qs=cut(w.qs, 2), scales=cut(w.scales, 256),
                               mins=cut(w.mins, 256), scmn=scmn.contiguous())


def _shard(w: Optional[ArrayOrQ], dim: int, index: int, tp: int, rows: bool):
    if w is None:
        return None
    per = dim // tp
    return (slice_rows if rows else slice_cols)(w, index * per, (index + 1) * per)


def _concat_cols(ws):
    if isinstance(ws[0], QWeight):
        return concat_qweights(ws)
    return torch.cat(ws, dim=-1)


def fuse_params_tp(cfg: LlamaConfig, params: LlamaParams, tp: int) -> LlamaParams:
    """Fuse wq|wk|wv -> wqkv and w1|w3 -> w13 with per-shard interleaving:
    shard s of the fused matrix is [wq_s|wk_s|wv_s], so each rank slices
    its local q / k / v at the local widths.  Column slicing never cuts a
    quantization group (groups run down K)."""
    validate_tp(cfg, tp)

    def interleave(ws):
        widths = [w.shape[-1] for w in ws]
        return _concat_cols([slice_cols(w, s * n // tp, (s + 1) * n // tp)
                             for s in range(tp) for w, n in zip(ws, widths)])

    layers = [dataclasses.replace(lp, wqkv=interleave([lp.wq, lp.wk, lp.wv]),
                                  w13=interleave([lp.w1, lp.w3]),
                                  wq=None, wk=None, wv=None, w1=None, w3=None)
              if lp.wq is not None else lp for lp in params.layers]
    return dataclasses.replace(params, layers=layers)


def shard_layer_tp(lp: LayerParams, index: int, tp: int) -> LayerParams:
    """Rank `index`'s shard of one layer: column-parallel weights (a fused
    one taken as fuse_params_tp's interleave) and row-parallel wo / w2;
    the norm gains whole."""
    upd = {}
    for name in COL_PARALLEL:
        w = getattr(lp, name)
        upd[name] = _shard(w, 0 if w is None else w.shape[1], index, tp, rows=False)
    for name in ROW_PARALLEL:
        w = getattr(lp, name)
        upd[name] = _shard(w, w.shape[0], index, tp, rows=True)
    return dataclasses.replace(lp, **upd)


def shard_params_tp(cfg: LlamaConfig, params: LlamaParams, mesh: TpMesh) -> LlamaParams:
    """This rank's shard of whole parameters (copies; the whole ones can
    be dropped): vocab rows of the embedding table, vocab columns of the
    output, each layer's shard (shard_layer_tp).  Fuse afterwards with
    models/llama.py fuse_params, which makes the interleaved shard."""
    validate_tp(cfg, mesh.tp)
    i, n = mesh.index, mesh.tp
    V = params.tok_embd.shape[0]
    return LlamaParams(tok_embd=params.tok_embd[i * V // n:(i + 1) * V // n].contiguous(),
                       layers=[shard_layer_tp(lp, i, n) for lp in params.layers],
                       norm=params.norm, output=_shard(params.output, V, i, n, rows=False),
                       fusions=params.fusions)


def shard_cache_tp(cache: KVCache, mesh: TpMesh) -> KVCache:
    """This rank's KV heads of a whole cache (copies)."""
    i, n = mesh.index, mesh.tp

    def heads(t):
        h = t.shape[1] // n
        return t[:, i * h:(i + 1) * h].contiguous()

    return KVCache([heads(k) for k in cache.k], [heads(v) for v in cache.v])


# ---------------------------------------------------------------------------
# Step functions (runtime/engine.py and runtime/speculative.py signatures)
# ---------------------------------------------------------------------------


def make_tp_prefill_fn(cfg: LlamaConfig, mesh: TpMesh):
    validate_tp(cfg, mesh.tp)
    return make_prefill_fn(cfg, tp=mesh)


def make_tp_decode_fn(cfg: LlamaConfig, mesh: TpMesh, sampling: SamplingConfig, chunk: int,
                      eos_id=EOS_ID):
    validate_tp(cfg, mesh.tp)
    return make_decode_fn(cfg, sampling, chunk, eos_id, tp=mesh)


def make_tp_decode_fn_dynamic(cfg: LlamaConfig, mesh: TpMesh, chunk: int, eos_id=EOS_ID):
    """Per-slot sampling (the dense Scheduler's step): every rank samples
    the gathered logits from each slot's (seed, counter) stream."""
    validate_tp(cfg, mesh.tp)
    return make_decode_fn_dynamic(cfg, chunk, eos_id, tp=mesh)


def make_tp_spec_serving_fn(cfg_draft: LlamaConfig, cfg_target: LlamaConfig, mesh: TpMesh,
                            gamma: int, eos_id=EOS_ID):
    """Greedy speculative round over the dense target cache: the draft
    whole on every rank, the target's verify head-sharded."""
    validate_tp(cfg_target, mesh.tp)
    return speculative.make_spec_serving_fn(cfg_draft, cfg_target, gamma, eos_id, tp=mesh)


def make_tp_spec_serving_fn_sampled(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                                    mesh: TpMesh, gamma: int, eos_id=EOS_ID):
    """Sampled round: every draw keys on per-slot (seed, counter) streams
    over values equal on every rank, so every rank draws the same."""
    validate_tp(cfg_target, mesh.tp)
    return speculative.make_spec_serving_fn_sampled(cfg_draft, cfg_target, gamma, eos_id,
                                                    tp=mesh)
