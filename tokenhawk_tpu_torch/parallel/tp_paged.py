"""Tensor-parallel paged serving (counterpart of tokenhawk_tpu/parallel/tp_paged.py).

The page pool (runtime/paged.py) shards along the KV-head axis, the same
Megatron head split as the dense TP path (parallel/tp.py): the
column-parallel wqkv shard of a rank makes exactly the local heads whose
pages it holds, attention is local (kernel 5 with the append folded in,
kernels 7 and 4; kernels 10-12 on int8 pages, whose scale pages shard with
their payloads), and the row-parallel Wo / w2 partials are all_reduced.
Page tables, lengths and token ids are the same on every rank (host-driven
control state); the paged forwards run with their `tp` hooks
(models/llama.py forward_paged_*).

The whole serving stack runs this way: continuous batching, chunked
prefill, the prefix cache (page reuse is index-level, so layout-agnostic),
per-request sampling (every rank samples the gathered logits from the same
per-slot streams), int8 pages and speculative decoding (the draft whole on
every rank, the target's verify under the hooks).
"""

from __future__ import annotations

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.parallel.mesh import TpMesh
from tokenhawk_tpu_torch.parallel.tp import validate_tp
from tokenhawk_tpu_torch.runtime import speculative
from tokenhawk_tpu_torch.runtime.paged import PagedKVCache
from tokenhawk_tpu_torch.runtime.paged_scheduler import (
    make_paged_decode_fn_dynamic,
    make_paged_prefill_cont_fn,
    make_paged_prefill_fn,
)
from tokenhawk_tpu_torch.tokenizer import EOS_ID


def shard_paged_cache_tp(cache: PagedKVCache, mesh: TpMesh) -> PagedKVCache:
    """This rank's KV heads of a whole pool (copies): the head axis of the
    payload pages and, on int8 pages, of their scale pages."""
    i, n = mesh.index, mesh.tp
    axis = 1 if cache.layout == "contig" else 0

    def heads(ts):
        if ts is None:
            return None
        h = ts[0].shape[axis] // n
        return [t.narrow(axis, i * h, h).contiguous() for t in ts]

    return PagedKVCache(heads(cache.k), heads(cache.v), cache.layout, heads(cache.ks),
                        heads(cache.vs))


def make_tp_paged_prefill_fn(cfg: LlamaConfig, mesh: TpMesh):
    validate_tp(cfg, mesh.tp)
    return make_paged_prefill_fn(cfg, tp=mesh)


def make_tp_paged_prefill_cont_fn(cfg: LlamaConfig, mesh: TpMesh):
    validate_tp(cfg, mesh.tp)
    return make_paged_prefill_cont_fn(cfg, tp=mesh)


def make_tp_paged_decode_fn_dynamic(cfg: LlamaConfig, mesh: TpMesh, chunk: int,
                                    eos_id=EOS_ID):
    """Chunked paged decode with per-slot sampling: every rank samples the
    gathered logits, so token feedback never leaves the rank mid-chunk."""
    validate_tp(cfg, mesh.tp)
    return make_paged_decode_fn_dynamic(cfg, chunk, eos_id, tp=mesh)


def make_tp_spec_serving_fn_paged(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                                  mesh: TpMesh, gamma: int, eos_id=EOS_ID):
    """Greedy speculative round: the draft whole on every rank, the
    target's verify head-sharded through forward_paged_verify's hooks."""
    validate_tp(cfg_target, mesh.tp)
    return speculative.make_spec_serving_fn_paged(cfg_draft, cfg_target, gamma, eos_id,
                                                  tp=mesh)


def make_tp_spec_serving_fn_paged_sampled(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                                          mesh: TpMesh, gamma: int, eos_id=EOS_ID):
    """Sampled round: draft proposals, accept tests and residual draws key
    on per-slot (seed, counter) streams over values equal on every rank."""
    validate_tp(cfg_target, mesh.tp)
    return speculative.make_spec_serving_fn_paged_sampled(cfg_draft, cfg_target, gamma,
                                                          eos_id, tp=mesh)

