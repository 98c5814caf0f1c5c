"""Tensor parallelism of the port (parallel/tp.py, Engine(parallel="tp"), the
dense Scheduler with a mesh) against the JAX package's shard_map TP.

On tests/test_tp_shardmap.py's tiny models, the port runs in 1, 2 and 4
spawned ranks of a gloo group (tests/torch_dist.py, tests/torch_tp_workers.py),
the JAX package on a model mesh of as many of tests/conftest.py's CPU
devices:
  - each rank's parameters (shard_params_tp, then the per-shard fusion)
    dequantize bit for bit to the shard of the JAX package's
    shard_params_tp (and fuse_params_tp) on its device, at f32, Q8_0 and
    Q4_0 (whose row-parallel shards the reference packs per K-shard);
  - prefill logits within atol / rtol 1e-4 of JAX's make_tp_prefill_fn;
  - greedy Engine tokens identical to JAX's TP Engine and to the port's
    dense Engine (f32, Q8_0, Q4_0 and a GQA model), on every rank;
  - sampled: every rank draws the same tokens, with nothing broadcast;
  - the TP Scheduler (greedy against JAX's TP Scheduler; a sampled
    neighbour against the port's dense Scheduler) and speculative
    serving over the dense cache, greedy against JAX's TP speculative
    Scheduler and sampled against the port's dense one;
  - validate_tp rejects the widths the reference rejects, with its
    message; the port's refusals (int8 dense cache, a CtxMesh).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.ggml.format import GGMLType
from tokenhawk_tpu.ggml.quants import quantize
from tokenhawk_tpu.models.llama import init_params as j_init_params
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.parallel import make_mesh as j_make_mesh
from tokenhawk_tpu.parallel.tp import fuse_params_tp as j_fuse_params_tp
from tokenhawk_tpu.parallel.tp import make_tp_prefill_fn as j_make_tp_prefill_fn
from tokenhawk_tpu.parallel.tp import shard_params_tp as j_shard_params_tp
from tokenhawk_tpu.parallel.tp import validate_tp as j_validate_tp
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu.runtime.scheduler import Scheduler as JScheduler
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.parallel.mesh import TpMesh, make_cp_mesh, make_mesh
from tokenhawk_tpu_torch.parallel.tp import (
    fuse_params_tp,
    shard_cache_tp,
    shard_params_tp,
    validate_tp,
)
from tokenhawk_tpu_torch.runtime.engine import Engine as TEngine

from helpers import make_ggml_weights
from torch_dist import run_ranks
from torch_helpers import numpy_params, numpy_shard_params, port_config
from torch_tp_workers import build_model, run_job, tp_worker

CFG = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=4, n_ctx=64, n_ff=512)
GQA = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=8, n_kv_head=2, n_ctx=64, n_ff=512)
DRAFT = LlamaConfig.tiny(n_vocab=512, n_embd=128, n_head=2, n_ctx=64, n_ff=128)
KINDS = {"f32": None, "q8_0": GGMLType.Q8_0, "q4_0": GGMLType.Q4_0}
GREEDY = dict(temperature=0.0)
PROMPT = {"f32": [1, 9, 17, 33], "q8_0": [1, 5, 25], "q4_0": [1, 5, 25], "gqa": [1, 11, 22, 33]}
N_NEW = {"f32": 8, "q8_0": 6, "q4_0": 6, "gqa": 6}
JAX_TP = {"f32": 4, "q8_0": 2, "q4_0": 4, "gqa": 2}  # the JAX TP Engine's mesh size
SAMPLED = dict(temperature=0.8, seed=5)
SCHED_PROMPTS = [[1, 8, 16], [1, 64, 128, 192]]
PAIR = ([[1, 5, 9], [1, 7, 2, 9]],
        [GREEDY, dict(temperature=1.0, top_k=0, top_p=1.0, repeat_penalty=1.0, seed=1234)])
SPEC_GREEDY = [np.random.default_rng(6).integers(3, 512, n).tolist() for n in (5, 8)]
SPEC_SAMPLED = ([np.random.default_rng(7).integers(3, 512, 6).tolist() for _ in range(2)],
                dict(temperature=0.8, top_k=20, seed=13))
TOKENS = np.random.default_rng(0).integers(1, 512, (2, 16)).astype(np.int64)


def _quant(tensors, kind):
    if kind is None:
        return tensors
    return {k: (quantize(v, kind) if v.ndim == 2 and "norm" not in k
                and k != "tok_embeddings.weight" else v) for k, v in tensors.items()}


@pytest.fixture(scope="module")
def host():
    """name -> (JAX config, ggml tensors); the drafts' JAX params."""
    tensors = make_ggml_weights(CFG, np.random.default_rng(31))
    out = {k: (CFG, _quant(tensors, kind)) for k, kind in KINDS.items()}
    out["gqa"] = (GQA, make_ggml_weights(GQA, np.random.default_rng(53)))
    drafts = {f"draft{s}": j_init_params(DRAFT, jax.random.PRNGKey(s), jnp.float32)
              for s in (0, 1)}
    return out, drafts


@pytest.fixture(scope="module")
def np_models(host):
    """name -> (config fields, numpy params) of the whole models."""
    models, drafts = host
    out = {k: (dataclasses.asdict(c), numpy_params(params_from_ggml(c, t, dtype=jnp.float32)))
           for k, (c, t) in models.items()}
    out.update({k: (dataclasses.asdict(DRAFT), numpy_params(p)) for k, p in drafts.items()})
    return out


def _jobs(tp):
    """key -> job (tests/torch_tp_workers.py run_job) at tp ranks."""
    jobs = {"prefill": ("prefill", "f32", TOKENS, np.full((2,), 16, np.int64))}
    jobs.update({k: ("engine", k, PROMPT[k], N_NEW[k], GREEDY) for k in PROMPT
                 if k != "gqa" or GQA.n_kv_head % tp == 0})
    jobs["sampled"] = ("engine", "f32", PROMPT["f32"], 12, SAMPLED)
    jobs["sched"] = ("sched", "f32", "dense", SCHED_PROMPTS, 6, None, {}, None, 1)
    jobs["pair"] = ("sched", "f32", "dense", PAIR[0], 6, PAIR[1], {}, None, 1)
    jobs["spec"] = ("sched", "f32", "dense", SPEC_GREEDY, 7, None, {"gamma": 3}, "draft0", 1)
    jobs["spec_sampled"] = ("sched", "f32", "dense", SPEC_SAMPLED[0], 6,
                            [SPEC_SAMPLED[1]] * 2, {"gamma": 3}, "draft1", 1)
    return jobs


@pytest.fixture(scope="module")
def runs(np_models, tmp_path_factory):
    """tp -> {job key: its result, the same on every rank}."""
    out = {}

    def get(tp):
        if tp not in out:
            jobs = _jobs(tp)
            models = {k: v for k, v in np_models.items() if k != "gqa" or GQA.n_kv_head % tp == 0}
            ranks = run_ranks(tp_worker, tp, tmp_path_factory.mktemp("tp"), models,
                              list(jobs.values()), ("draft0", "draft1"))
            out[tp] = {k: _agreed(ranks, i) for i, k in enumerate(jobs)}
        return out[tp]

    return get


@pytest.fixture(scope="module")
def dense(np_models):
    """The port's dense (one-process) results of the same jobs."""
    built = {k: build_model(*v) for k, v in np_models.items()}
    return {k: run_job(job, built, None) for k, job in _jobs(2).items()}


def _agreed(ranks, i):
    """Job i's result, the same on every rank."""
    first = ranks[0][i]
    for r in ranks[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(r[i], first)
        else:
            assert r[i] == first
    return first


def _dequantized(w):
    return None if w is None else (w.dequantize() if hasattr(w, "dequantize") else w)


def _assert_params_equal(a, b):
    for name in ("tok_embd", "norm", "output"):
        assert torch.equal(_dequantized(getattr(a, name)), _dequantized(getattr(b, name))), name
    for la, lb in zip(a.layers, b.layers, strict=True):
        for f in dataclasses.fields(tl.LayerParams):
            wa, wb = _dequantized(getattr(la, f.name)), _dequantized(getattr(lb, f.name))
            assert (wa is None) == (wb is None), f.name
            assert wa is None or torch.equal(wa, wb), f.name


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_rank_params_dequantize_to_the_jax_shards(host, tp, kind):
    cfg, tensors = host[0][kind]
    mesh = j_make_mesh(dp=1, tp=tp)
    packed = params_from_ggml(cfg, tensors, dtype=jnp.float32, row_parallel_shards=tp)
    j_unfused = j_shard_params_tp(cfg, packed, mesh)
    j_fused = j_shard_params_tp(cfg, j_fuse_params_tp(cfg, packed, tp), mesh)
    whole = tl.params_from_jax(numpy_params(params_from_ggml(cfg, tensors, dtype=jnp.float32)))
    pcfg = port_config(cfg)
    interleaved = fuse_params_tp(pcfg, whole, tp)
    for i in range(tp):
        mine = shard_params_tp(pcfg, whole, TpMesh(None, i, tp))
        _assert_params_equal(mine, tl.params_from_jax(numpy_shard_params(j_unfused, mesh, i)))
        fused = tl.params_from_jax(numpy_shard_params(j_fused, mesh, i))
        _assert_params_equal(tl.fuse_params(mine), fused)
        _assert_params_equal(shard_params_tp(pcfg, interleaved, TpMesh(None, i, tp)), fused)


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_cache_is_the_jax_shard(tp):
    from tokenhawk_tpu.parallel.tp import shard_cache_tp as j_shard_cache_tp

    rng = np.random.default_rng(tp)
    layers = [tuple(rng.standard_normal((2, CFG.n_kv_head, 16, CFG.head_dim)).astype(np.float32)
                    for _ in "kv") for _ in range(CFG.n_layer)]
    mesh = j_make_mesh(dp=1, tp=tp)
    placed = j_shard_cache_tp(tuple(tuple(map(jnp.asarray, kv)) for kv in layers), mesh)
    whole = tl.KVCache([torch.from_numpy(k) for k, _ in layers],
                       [torch.from_numpy(v) for _, v in layers])
    for i in range(tp):
        mine = shard_cache_tp(whole, TpMesh(None, i, tp))
        for (k, v), jk, jv in zip(placed, mine.k, mine.v):
            for a, b in ((k, jk), (v, jv)):
                shard, = [s for s in a.addressable_shards if s.device == mesh.devices[0, i]]
                np.testing.assert_array_equal(b.numpy(), np.asarray(shard.data))


def _jax_tp_params(cfg, tensors, tp):
    mesh = j_make_mesh(dp=1, tp=tp)
    return mesh, j_shard_params_tp(cfg, params_from_ggml(cfg, tensors, dtype=jnp.float32,
                                                         row_parallel_shards=tp), mesh)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_prefill_logits_match_jax(host, runs, tp):
    from tokenhawk_tpu.models.llama import KVCache as JKVCache

    cfg, tensors = host[0]["f32"]
    mesh, params = _jax_tp_params(cfg, tensors, tp)
    _, want = j_make_tp_prefill_fn(cfg, mesh)(
        params, JKVCache.create(cfg, 2, 64, jnp.float32), jnp.asarray(TOKENS, jnp.int32),
        jnp.full((2,), 16, jnp.int32), jnp.zeros((2,), jnp.int32))
    np.testing.assert_allclose(runs(tp)["prefill"], np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_tp_tokens(host):
    """name -> the JAX package's TP Engine's greedy tokens (mesh JAX_TP[name])."""
    out = {}
    for name, tp in JAX_TP.items():
        cfg, tensors = host[0][name]
        mesh, params = _jax_tp_params(cfg, tensors, tp)
        eng = JEngine(cfg, params, sampling=SamplingConfig(temperature=0.0),
                      cache_dtype=jnp.float32, decode_chunk=4, mesh=mesh, parallel="tp")
        out[name] = eng.generate(PROMPT[name], max_new_tokens=N_NEW[name]).tokens
    return out


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_engine_greedy_matches_jax_tp_and_dense(runs, dense, jax_tp_tokens, tp):
    for name in PROMPT:
        if name == "gqa" and GQA.n_kv_head % tp:
            continue
        got = runs(tp)[name]
        assert len(got) == N_NEW[name]
        assert got == jax_tp_tokens[name], name
        assert got == dense[name], name


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_sampled_tokens_agree_on_every_rank(runs, tp):
    sampled = runs(tp)["sampled"]  # _agreed: the same on every rank
    assert len(sampled) == 12 and sampled[:8] != runs(tp)["f32"]  # not the greedy stream


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_scheduler_matches_jax_tp_and_per_request_sampling(host, runs, dense, tp):
    cfg, tensors = host[0]["f32"]
    mesh, params = _jax_tp_params(cfg, tensors, tp)
    s = JScheduler(cfg, params, sampling=SamplingConfig(temperature=0.0), max_batch=2,
                   cache_dtype=jnp.float32, decode_chunk=4, mesh=mesh, parallel="tp")
    (got,), _ = runs(tp)["sched"]
    assert got == [r.output for r in s.generate_many(SCHED_PROMPTS, max_new_tokens=6)]
    # A greedy request beside a sampled one, each from its own stream.
    (pair,), _ = runs(tp)["pair"]
    assert pair == dense["pair"][0][0] and len(pair[1]) == 6


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_dense_speculative_greedy_matches_jax_and_sampled_matches_dense(host, runs, dense,
                                                                           tp):
    (sampled,), _ = runs(tp)["spec_sampled"]
    assert sampled == dense["spec_sampled"][0][0]
    (greedy,), _ = runs(tp)["spec"]
    assert greedy == dense["spec"][0][0]
    if tp == 2:  # JAX's TP speculative Scheduler at one mesh size (its compile is slow)
        cfg, tensors = host[0]["f32"]
        mesh, params = _jax_tp_params(cfg, tensors, tp)
        s = JScheduler(cfg, params, sampling=SamplingConfig(temperature=0.0), max_batch=2,
                       cache_dtype=jnp.float32, decode_chunk=4, mesh=mesh, parallel="tp",
                       draft_cfg=DRAFT, draft_params=host[1]["draft0"], gamma=3)
        assert greedy == [r.output for r in s.generate_many(SPEC_GREEDY, max_new_tokens=7)]


@pytest.mark.parametrize("tp", [3, 8])
def test_validate_tp_rejects_the_same_widths(tp):
    with pytest.raises(ValueError) as want:
        j_validate_tp(CFG, tp)
    with pytest.raises(ValueError) as got:
        validate_tp(port_config(CFG), tp)
    assert str(got.value) == str(want.value)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    yield make_mesh()
    dist.destroy_process_group()


def test_what_tp_does_not_run_raises(np_models, world_of_one):
    cfg, params = build_model(*np_models["f32"])
    with pytest.raises(ValueError, match="int8"):
        TEngine(cfg, params, cache_dtype="int8", mesh=world_of_one, parallel="tp")
    with pytest.raises(ValueError, match="parallel='tp'"):
        TEngine(cfg, params, mesh=make_cp_mesh(), parallel="tp")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        make_mesh(dp=2, tp=1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        TEngine(cfg, params, mesh=world_of_one, parallel="pp")
    auto = TEngine(cfg, params, cache_dtype="auto", max_seq=64, mesh=world_of_one)
    assert auto.parallel == "tp" and auto.cache_dtype == torch.bfloat16
    from tokenhawk_tpu.parallel.multihost import host_local_slice as j_host_local_slice
    from tokenhawk_tpu_torch.parallel.multihost import global_mesh, host_local_slice

    assert global_mesh() == world_of_one
    with pytest.raises(ValueError, match="dp\\*tp"):
        global_mesh(dp=1, tp=2)
    assert host_local_slice(12, 4) == j_host_local_slice(12, 4)


def test_tp_decode_trace_runs_on_the_cpu():
    """experiments/tp_decode_trace.py's forms on a small model over gloo:
    the identity collectives of its one-rank mesh are exact, so its
    tp_local and tp streams are equal, and every form's numbers are there."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from torch_helpers import subprocess_env

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "tokenhawk_tpu_torch.experiments.tp_decode_trace",
                           "--device", "cpu", "--tokens", "3", "--repeats", "1"], cwd=root,
                          env=subprocess_env(PYTHONPATH=str(root)), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    forms = ("dense", "dense_unfused", "tp_local", "tp")
    assert out["streams_equal"]["tp_local"] == out["streams_equal"]["tp"]
    for name in forms:
        assert len(out["decode_tok_s"][name]) == 1 and out["decode_ms_a_token"][name] > 0
        assert out["traces"][name]["host_ops"]
