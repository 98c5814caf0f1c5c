"""Tensor-parallel paged serving of the port (parallel/tp_paged.py,
PagedScheduler(mesh=...)) against the JAX package's.

The twins of tests/test_tp_paged.py's cases, the port in 2 and 4 spawned
ranks of a gloo group (tests/torch_dist.py, tests/torch_tp_workers.py):
continuous batching over a pool sharded along KV heads, chunked prefill
with the prefix cache, per-request sampling, int8 pages (scale pages
sharded with their payloads; the head-major pool layout on one of them)
and speculative serving (the draft whole on every rank).  Every rank's
outputs agree; greedy outputs equal the JAX package's TP PagedScheduler's
(at one mesh size a case: its compiles are slow) and the port's
one-process PagedScheduler's; sampled ones equal the port's one-process
scheduler's (the two packages draw from different generators).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import init_params as j_init_params
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.parallel import make_mesh as j_make_mesh
from tokenhawk_tpu.parallel.tp import shard_params_tp as j_shard_params_tp
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler as JPagedScheduler
from tokenhawk_tpu_torch.parallel.mesh import TpMesh
from tokenhawk_tpu_torch.parallel.tp_paged import shard_paged_cache_tp
from tokenhawk_tpu_torch.runtime.paged import PagedKVCache

from helpers import make_ggml_weights
from torch_dist import run_ranks
from torch_helpers import numpy_params
from torch_tp_workers import build_model, run_job, tp_worker

CFG = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=4, n_ctx=96, n_ff=512)
DRAFT = LlamaConfig.tiny(n_vocab=512, n_embd=128, n_head=2, n_ctx=96, n_ff=128)
BASE = dict(max_seq=96, page_size=16, n_pages=24)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG.n_vocab, n).tolist() for n in lengths]


# key -> (prompts, max_new_tokens, [sampling a prompt] | None, scheduler kwargs, draft,
#         rounds, the JAX TP scheduler's mesh size or None)
CASES = {
    "greedy": (_prompts(0, (5, 11)), 7, None, {}, None, 1, 2),
    "chunked_prefix": ([list(range(3, 44))], 6, None,
                       dict(prefill_chunk=16, prefix_cache=True, n_pages=32), None, 2, 4),
    "sampled": (_prompts(2, (6, 6)), 6, [dict(temperature=0.8, top_k=20, seed=7)] * 2, {},
                None, 1, None),
    "int8": (_prompts(3, (5, 9)), 6, None, dict(cache_dtype="int8", layout="head"), None, 1, 4),
    "int8_chunked": ([list(range(3, 40))], 5, None,
                     dict(cache_dtype="int8", prefill_chunk=16, n_pages=32), None, 1, 2),
    "spec": (_prompts(4, (5, 8)), 7, None, dict(gamma=3), "draft0", 1, 4),
    "spec_sampled": (_prompts(5, (6, 6)), 6, [dict(temperature=0.8, top_k=20, seed=11)] * 2,
                     dict(gamma=3), "draft1", 1, None),
}


def _jobs():
    return {k: ("sched", "target", "paged", p, n, s, {**BASE, **kw}, d, rounds)
            for k, (p, n, s, kw, d, rounds, _) in CASES.items()}


@pytest.fixture(scope="module")
def host():
    tensors = make_ggml_weights(CFG, np.random.default_rng(41))
    drafts = {f"draft{s}": j_init_params(DRAFT, jax.random.PRNGKey(s), jnp.float32)
              for s in (0, 1)}
    return tensors, drafts


@pytest.fixture(scope="module")
def np_models(host):
    tensors, drafts = host
    out = {"target": (dataclasses.asdict(CFG),
                      numpy_params(params_from_ggml(CFG, tensors, dtype=jnp.float32)))}
    out.update({k: (dataclasses.asdict(DRAFT), numpy_params(p)) for k, p in drafts.items()})
    return out


@pytest.fixture(scope="module")
def runs(np_models, tmp_path_factory):
    """tp -> {case: (outputs of each round, prefix hits), the same on every rank}."""
    out = {}

    def get(tp):
        if tp not in out:
            jobs = _jobs()
            ranks = run_ranks(tp_worker, tp, tmp_path_factory.mktemp("tp_paged"), np_models,
                              list(jobs.values()), ("draft0", "draft1"))
            for r in ranks[1:]:
                assert r == ranks[0]
            out[tp] = dict(zip(jobs, ranks[0]))
        return out[tp]

    return get


@pytest.fixture(scope="module")
def one_process(np_models):
    built = {k: build_model(*v) for k, v in np_models.items()}
    return {k: run_job(job, built, None) for k, job in _jobs().items()}


@pytest.fixture(scope="module")
def jax_tp(host):
    """case -> the JAX package's TP PagedScheduler's outputs of each round."""
    tensors, drafts = host
    out = {}
    for key, (prompts, n_new, _, kw, draft, rounds, tp) in CASES.items():
        if tp is None:
            continue
        mesh = j_make_mesh(dp=1, tp=tp)
        params = j_shard_params_tp(CFG, params_from_ggml(CFG, tensors, dtype=jnp.float32,
                                                         row_parallel_shards=tp), mesh)
        kw = {k: v for k, v in {**BASE, **kw}.items() if k != "layout"}
        kw.setdefault("cache_dtype", jnp.float32)
        if draft is not None:
            kw.update(draft_cfg=DRAFT, draft_params=drafts[draft])
        s = JPagedScheduler(CFG, params, sampling=SamplingConfig(temperature=0.0), max_batch=2,
                            decode_chunk=4, mesh=mesh, **kw)
        out[key] = [[r.output for r in s.generate_many(prompts, max_new_tokens=n_new)]
                    for _ in range(rounds)]
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_tp_paged_matches_jax_tp_and_one_process(runs, one_process, jax_tp, tp, case):
    outs, hits = runs(tp)[case]
    prompts, n_new = CASES[case][:2]
    assert all(len(o) == n_new for rnd in outs for o in rnd)
    assert outs == one_process[case][0]
    if case in jax_tp:
        assert outs == jax_tp[case]
    if case == "chunked_prefix":
        assert outs[0] == outs[1] and hits >= 1  # the second prompt reused pages


@pytest.mark.parametrize("layout", ["contig", "head"])
@pytest.mark.parametrize("quant", [False, True])
def test_shard_paged_cache_keeps_each_ranks_heads(layout, quant):
    cfg = dataclasses.replace(CFG, n_layer=1)
    from tokenhawk_tpu_torch.config import LlamaConfig as TConfig

    pool = PagedKVCache.create(TConfig(**dataclasses.asdict(cfg)), 3, 4,
                               "int8" if quant else torch.float32, layout=layout)
    for t in pool.k + pool.v + (pool.ks + pool.vs if quant else []):
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    axis = 1 if layout == "contig" else 0
    for i in range(2):
        part = shard_paged_cache_tp(pool, TpMesh(None, i, 2))
        assert part.layout == layout and part.quant == quant
        for whole, mine in zip(pool.k + pool.v + (pool.ks + pool.vs if quant else []),
                               part.k + part.v + (part.ks + part.vs if quant else [])):
            assert torch.equal(mine, whole.narrow(axis, 2 * i, 2))
