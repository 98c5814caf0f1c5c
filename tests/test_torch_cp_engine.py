"""Context-parallel generation of the port (Engine(parallel="cp"),
parallel/cp.py) against the JAX package's CP Engine and the port's dense
Engine.

On tests/test_cp_engine.py's tiny f32 model, the port's CP Engine runs in
1, 2 and 4 spawned ranks of a gloo group (tests/torch_dist.py), the JAX
package's on a ctx mesh of as many CPU devices:
  - greedy, 8 new tokens on a prompt longer than one shard's slots
    (S/ncp), and 40 on a short prompt, decoding past one shard's
    capacity: every rank's tokens identical to JAX's CP Engine on the same
    mesh size and to the port's dense Engine;
  - sampled: every rank draws the same tokens, with nothing broadcast;
  - each rank's cache after the prefill: its cyclic slice of the dense
    Engine's cache (shard_cache_cp), within 1e-4;
  - what the port does not run raises: dp > 1, an int8 cache with CP,
    parallel="tp", and a mesh without a process group.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import fuse_params as j_fuse_params
from tokenhawk_tpu.models.llama import params_from_ggml, unstack_params
from tokenhawk_tpu.parallel.mesh import make_cp_mesh as j_make_cp_mesh
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.parallel.cp import shard_cache_cp
from tokenhawk_tpu_torch.parallel.mesh import CtxMesh, make_cp_mesh
from tokenhawk_tpu_torch.runtime.engine import Engine as TEngine

from helpers import make_ggml_weights
from torch_dist import engine_worker, run_ranks
from torch_helpers import numpy_params, port_config

CFG = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=4, n_ctx=64, n_ff=512)
LONG = [1] + [(7 * i) % 500 + 3 for i in range(52)]  # 53 tokens: > S/ncp for ncp >= 2
SHORT = [1, 9, 17, 33, 2, 4]
GREEDY_RUNS = [(LONG, 8), (SHORT, 40)]
SAMPLED = (SHORT, 12, 0.8, 5)


@pytest.fixture(scope="module")
def model():
    tensors = make_ggml_weights(CFG, np.random.default_rng(77))
    ref = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    return ref, numpy_params(ref)


@pytest.fixture(scope="module")
def dense_port(model):
    cfg = port_config(CFG)
    params = tl.fuse_params(tl.params_from_jax(model[1]))
    eng = TEngine(cfg, params, sampling=TSamplingConfig(temperature=0.0),
                  cache_dtype=torch.float32, decode_chunk=4)
    return cfg, params, eng


@pytest.fixture(scope="module")
def runs(model, tmp_path_factory):
    """ncp -> every rank's (greedy tokens of GREEDY_RUNS + the SAMPLED
    run, layer caches after LONG's prefill)."""
    out = {}

    def get(ncp):
        if ncp not in out:
            work = [(p, n, 0.0, 0) for p, n in GREEDY_RUNS] + [SAMPLED]
            out[ncp] = run_ranks(engine_worker, ncp, tmp_path_factory.mktemp("ranks"),
                                 model[1], dataclasses.asdict(CFG), work, LONG)
        return out[ncp]

    return get


@pytest.mark.parametrize("ncp", [1, 2, 4])
def test_cp_greedy_matches_jax_cp_and_dense(model, dense_port, runs, ncp):
    ranks = runs(ncp)
    got = [tokens[:len(GREEDY_RUNS)] for tokens, _ in ranks]
    assert all(g == got[0] for g in got)
    jparams = unstack_params(j_fuse_params(model[0]))
    j_cp = JEngine(CFG, jparams, sampling=SamplingConfig(temperature=0.0),
                   cache_dtype=jnp.float32, decode_chunk=4, mesh=j_make_cp_mesh(dp=1, cp=ncp),
                   parallel="cp")
    for (prompt, n), tokens in zip(GREEDY_RUNS, got[0]):
        assert len(prompt) + n > j_cp.max_seq // ncp or ncp == 1  # crosses a shard's slots
        assert tokens == j_cp.generate(prompt, max_new_tokens=n).tokens
        assert tokens == dense_port[2].generate(prompt, max_new_tokens=n).tokens


@pytest.mark.parametrize("ncp", [2, 4])
def test_cp_sampled_tokens_agree_on_every_rank(runs, ncp):
    sampled = [tokens[-1] for tokens, _ in runs(ncp)]
    assert len(sampled[0]) == SAMPLED[1]
    assert all(s == sampled[0] for s in sampled)
    assert sampled[0] != runs(ncp)[0][0][1][:SAMPLED[1]]  # not the greedy stream


@pytest.mark.parametrize("ncp", [1, 2, 4])
def test_cp_prefill_cache_is_the_cyclic_slice_of_the_dense_one(dense_port, runs, ncp):
    cfg, params, eng = dense_port
    cache, _, _ = eng.prefill(eng.new_cache(1), [LONG])
    for r, (_, layers) in enumerate(runs(ncp)):
        want = shard_cache_cp(cache, CtxMesh(None, r, ncp))
        n = len(range(r, len(LONG), ncp))  # this rank's prompt slots
        for i, (k, v) in enumerate(layers):
            assert k.shape == (1, cfg.n_kv_head, cfg.n_ctx // ncp, cfg.head_dim)
            torch.testing.assert_close(k[:, :, :n], want.k[i][:, :, :n], atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(v[:, :, :n], want.v[i][:, :, :n], atol=1e-4, rtol=1e-4)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    yield make_cp_mesh()
    dist.destroy_process_group()


def test_what_the_port_does_not_run_raises(dense_port, world_of_one):
    cfg, params, _ = dense_port
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        make_cp_mesh(dp=2, cp=2)
    with pytest.raises(ValueError, match="int8"):
        TEngine(cfg, params, cache_dtype="int8", mesh=world_of_one, parallel="cp")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        TEngine(cfg, params, parallel="tp")
    with pytest.raises(ValueError, match="cp=2"):
        make_cp_mesh(cp=2)
    auto = TEngine(cfg, params, cache_dtype="auto", max_seq=1024, mesh=world_of_one,
                   parallel="cp")
    assert auto.cache_dtype == torch.bfloat16  # "auto" under a mesh, as the reference


def test_cp_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_cp_mesh()
