"""Kernel 14 of the port (decode attention, no append) and the dense-weight
decode route, against the JAX package.

  - flash_decode_plain, kernel 14's plain version, against the three
    Pallas functions it replaces in interpret mode, called directly:
    flash_decode_dma, flash_decode_loop and ops/pallas/flash_decode.py's
    flash_decode, at the reference's own tolerance (atol 3e-5, rtol 1e-4,
    tests/test_flash_decode_dma.py), head dims 64 and 128, 1, 2 and 8
    query heads per KV head, random lengths;
  - the dense decode step (an index copy, then kernel 14) against the
    reference's update_kv_cache and attend_cache;
  - a tiny f32 model with dense weights: the port's forward against the
    JAX forward (logits of a prefill and 6 decode steps, rtol 1e-4), and
    16 greedy tokens of Engine.generate against the JAX Engine's, with the
    decode going through kernel 14's function (an index copy first) and
    never through kernel 3's.
The JAX side runs XLA on the CPU, as its own tests do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models import llama as jl
from tokenhawk_tpu.ops.attention import attend_cache as j_attend_cache
from tokenhawk_tpu.ops.attention import update_kv_cache as j_update_kv_cache
from tokenhawk_tpu.ops.pallas.flash_decode import flash_decode as j_flash_decode_grid
from tokenhawk_tpu.ops.pallas.flash_decode_dma import flash_decode_dma, flash_decode_loop
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops.cuda import flash_decode
from tokenhawk_tpu_torch.runtime.engine import Engine as TEngine

from helpers import make_ggml_weights
from torch_helpers import numpy_params, port_config, t

SHAPES = [(2, 256, 2, 2, 64), (1, 128, 4, 1, 64), (2, 256, 1, 8, 128)]  # B, S, Hkv, rep, Dh
PALLAS = {
    "dma": lambda q, k, v, n: flash_decode_dma(q, k, v, n, interpret=True),
    "loop": lambda q, k, v, n: flash_decode_loop(q, k, v, n, interpret=True),
    "grid": lambda q, k, v, n: j_flash_decode_grid(q, k, v, n, interpret=True),
}


def _inputs(B, S, Hkv, rep, Dh, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(f)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(f)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(f)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-S{}-Hkv{}-rep{}-Dh{}".format(*s))
@pytest.mark.parametrize("variant", sorted(PALLAS))
def test_plain_matches_pallas(variant, shape):
    q, k, v, lengths = _inputs(*shape, seed=sum(shape))
    want = np.asarray(PALLAS[variant](*(jnp.asarray(a) for a in (q, k, v, lengths))))
    kc, vc = t(k), t(v)
    got = flash_decode.flash_decode(t(q), kc, vc, t(lengths))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
    np.testing.assert_array_equal(kc.numpy(), k)  # no write
    np.testing.assert_array_equal(vc.numpy(), v)


def test_lengths_clamp_to_the_cache():
    """A length past S attends the whole cache, as the reference's
    attend_cache clamps q_position + 1 to S."""
    q, k, v, _ = _inputs(2, 128, 2, 2, 64, seed=5)
    full = flash_decode.flash_decode(t(q), t(k), t(v), torch.tensor([128, 128], dtype=torch.int32))
    over = flash_decode.flash_decode(t(q), t(k), t(v), torch.tensor([128, 140], dtype=torch.int32))
    assert torch.equal(full, over)


def test_attend_cache_decode_branch_matches_reference(monkeypatch):
    """The dense-weight decode step (_attend_and_update without
    prefer_append: an index copy, then kernel 14's function, once) equals
    the reference's update_kv_cache + attend_cache at T == 1, cache and
    output, positions past S included."""
    B, S, Hkv, rep, Dh = 3, 128, 2, 4, 64
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, 1, Hkv * rep, Dh)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((B, 1, Hkv, Dh)).astype(np.float32) for _ in range(2))
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    pos = np.array([[0], [77], [S + 3]], np.int32)
    calls = []
    plain = flash_decode.flash_decode_plain
    monkeypatch.setattr(flash_decode, "flash_decode_plain",
                        lambda *a: calls.append(1) or plain(*a))
    kc, vc = t(k), t(v)
    got = tl._attend_and_update(port_config(CFG), t(q), t(k_new), t(v_new), (kc, vc),
                                t(pos[:, 0]), t(pos).long(), prefer_append=False)
    jk, jv = j_update_kv_cache(*(jnp.asarray(a) for a in (k, v, k_new, v_new, pos[:, 0])))
    want = np.asarray(j_attend_cache(jnp.asarray(q), jk, jv, jnp.asarray(pos)))
    assert len(calls) == 1
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jv))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


# -- the dense-weight decode route -------------------------------------------

CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=4, n_kv_head=2, n_layer=2, n_ff=512,
                       n_ctx=128)  # head dim 64, 2 query heads per KV head
PROMPT = [1, 17, 230, 45, 9, 101, 7, 66]


@pytest.fixture(scope="module")
def dense():
    jparams = jl.params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(21)),
                                  dtype=jnp.float32)
    return jparams, tl.params_from_jax(numpy_params(jparams)), port_config(CFG)


@pytest.fixture
def decode_routes(monkeypatch):
    """Calls of kernel 14's and kernel 3's functions (their plain
    versions, which the wrappers run for CPU tensors)."""
    calls = {"attend": 0, "append": 0}
    attend, append = flash_decode.flash_decode_plain, flash_decode.flash_decode_append_plain

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(flash_decode, "flash_decode_plain", count("attend", attend))
    monkeypatch.setattr(flash_decode, "flash_decode_append_plain", count("append", append))
    return calls


def test_dense_forward_matches_jax(dense, decode_routes):
    jparams, tparams, tcfg = dense
    jcache = jl.KVCache.create(CFG, 1, 64, jnp.float32)
    tcache = tl.KVCache.create(tcfg, 1, 64, torch.float32, "cpu")
    toks = np.array([PROMPT], np.int32)
    jh, jcache = jl.forward(CFG, jparams, jnp.asarray(toks), jcache, jnp.zeros(1, jnp.int32))
    th, _ = tl.forward(tcfg, tparams, t(toks).long(), tcache, torch.zeros(1, dtype=torch.int32))
    pairs = [(jl.logits_from_hidden(CFG, jparams, jh[:, -1]),
              tl.logits_from_hidden(tcfg, tparams, th[:, -1]))]
    for i, tok in enumerate([5, 250, 3, 77, 12, 200]):
        off = len(PROMPT) + i
        jh, jcache = jl.forward(CFG, jparams, jnp.asarray([[tok]], jnp.int32), jcache,
                                jnp.asarray([off], jnp.int32))
        th, _ = tl.forward(tcfg, tparams, torch.tensor([[tok]]), tcache,
                           torch.tensor([off], dtype=torch.int32))
        pairs.append((jl.logits_from_hidden(CFG, jparams, jh[:, 0]),
                      tl.logits_from_hidden(tcfg, tparams, th[:, 0])))
    for want, got in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # Every decode step of every layer: index copy + kernel 14, never kernel 3.
    assert decode_routes == {"attend": 6 * CFG.n_layer, "append": 0}
    np.testing.assert_allclose(tcache.k[1].numpy(), np.asarray(jcache.k[1]), rtol=1e-4,
                               atol=1e-5)


def test_dense_greedy_generate_matches_jax(dense, decode_routes):
    jparams, tparams, tcfg = dense
    jeng = JEngine(CFG, jparams, sampling=SamplingConfig(temperature=0.0),
                   cache_dtype=jnp.float32, decode_chunk=4, eos_id=-1)
    teng = TEngine(tcfg, tparams, sampling=TSamplingConfig(temperature=0.0),
                   cache_dtype=torch.float32, decode_chunk=4, eos_id=-1)
    want = jeng.generate(PROMPT, max_new_tokens=16).tokens
    got = teng.generate(PROMPT, max_new_tokens=16).tokens
    assert len(want) == 16 and got == want
    assert decode_routes["attend"] > 0 and decode_routes["append"] == 0


def test_quantized_decode_keeps_the_append_kernel(decode_routes):
    """Q4_0 projections keep kernel 3 (append + attend in one launch)."""
    tcfg = port_config(CFG)
    params = tl.fuse_params(tl.init_params(tcfg, torch.Generator().manual_seed(2),
                                           dtype=torch.float32, device="cpu", quant="q4_0"))
    eng = TEngine(tcfg, params, sampling=TSamplingConfig(temperature=0.0),
                  cache_dtype=torch.float32, decode_chunk=4, eos_id=-1)
    assert len(eng.generate(PROMPT, max_new_tokens=6).tokens) == 6
    assert decode_routes["append"] > 0 and decode_routes["attend"] == 0
