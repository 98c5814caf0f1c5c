"""The port's dense int8 KV cache against the JAX package.

  - the codec (ops/kvquant.py quantize_kv_block) bit for bit: random rows,
    all-zero rows, values at .5 rounding ties, bfloat16 inputs;
  - update_kv_cache_int8 exactly, at decode and at prefill;
  - kernel 8's and kernel 9's plain versions (ops/cuda/kv_int8.py) against
    JAX's attend_cache_int8 at atol 3e-5, rtol 1e-4 (f32 attention over the
    same dequantized cache, another summation order), and against the
    Pallas kernels `flash_decode_int8` / `attend_prefill_int8` in interpret
    mode within those tests' own 3e-2 / 2e-2 (the TPU kernels also quantize
    the query and the probabilities);
  - Engine with cache_dtype "int8" and "auto" on a tiny f32 model: greedy
    tokens identical to JAX's for 16 steps (JAX on the CPU takes
    attend_cache_int8), and the "auto" rule;
  - the CLI's --kv int8 / auto on --device cpu.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models import llama as jl
from tokenhawk_tpu.ops import kvquant as jk
from tokenhawk_tpu.ops.pallas.flash_attention_int8 import attend_prefill_int8
from tokenhawk_tpu.ops.pallas.flash_decode_int8 import flash_decode_int8 as j_flash_decode_int8
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops import kvquant as tk
from tokenhawk_tpu_torch.ops.cuda import kv_int8
from tokenhawk_tpu_torch.runtime.engine import Engine as TEngine
from tokenhawk_tpu_torch.runtime.engine import resolve_cache_dtype

from helpers import make_ggml_weights
from torch_helpers import numpy_params, padded_vocab, port_config, t

DH = 128


def _jq(x, dtype=jnp.float32):
    q, s = jk.quantize_kv_block(jnp.asarray(x, dtype))
    return np.asarray(q), np.asarray(s.astype(jnp.float32))


def _tq(x, dtype=torch.float32):
    q, s = tk.quantize_kv_block(t(x, dtype))
    return q.numpy(), s.float().numpy()


def _codec_inputs():
    rng = np.random.default_rng(0)
    rand = (rng.standard_normal((3, 4, 5, DH)) * rng.uniform(0.01, 30, (3, 4, 5, 1)))
    zero = np.zeros((2, DH))
    zero[1, 7] = 1e-30  # a scale far below bf16's normal range
    ties = np.zeros((4, DH))  # amax 127 -> scale 1: x * inv is exactly x
    ties[:, 0] = 127.0
    ties[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    ties[1] *= 2.0 / 127  # scale 2/127: the same ties through a rounded inverse
    ties[2, 9:] = rng.integers(-254, 255, DH - 9) / 2  # every half-integer code
    return {"random": rand.astype(np.float32), "zero": zero.astype(np.float32),
            "ties": ties.astype(np.float32)}


@pytest.mark.parametrize("kind", ["random", "zero", "ties"])
@pytest.mark.parametrize("bf16", [False, True])
def test_codec_matches_jax_bit_for_bit(kind, bf16):
    x = _codec_inputs()[kind]
    if bf16:  # the same bfloat16 values on both sides
        x = torch.from_numpy(x).bfloat16().float().numpy()
        got, want = _tq(x, torch.bfloat16), _jq(x, jnp.bfloat16)
    else:
        got, want = _tq(x), _jq(x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int8 and np.abs(got[0]).max() <= 127
    if kind == "ties":  # round half to even, not away from zero
        np.testing.assert_array_equal(got[0][0, 1:9], [0, 2, 2, 0, -2, -2, 126, -126])


def _int8_cache(rng, B, Hkv, S):
    kq, ks = jk.quantize_kv_block(jnp.asarray(rng.standard_normal((B, Hkv, S, DH)), jnp.float32))
    vq, vs = jk.quantize_kv_block(jnp.asarray(rng.standard_normal((B, Hkv, S, DH)), jnp.float32))
    jcache = (kq, ks, vq, vs)
    return jcache, [t(np.asarray(a)) if a.dtype != jnp.bfloat16
                    else t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in jcache]


@pytest.mark.parametrize("T,offsets", [(1, [3, 60]), (5, [0, 20])])
def test_update_kv_cache_int8_matches_jax(T, offsets):
    rng = np.random.default_rng(T)
    B, Hkv, S = 2, 2, 64
    jcache, tcache = _int8_cache(rng, B, Hkv, S)
    k_new, v_new = (rng.standard_normal((B, T, Hkv, DH)).astype(np.float32) for _ in range(2))
    want = jk.update_kv_cache_int8(*jcache, jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(offsets, jnp.int32))
    tk.update_kv_cache_int8(*tcache, t(k_new), t(v_new), t(offsets, torch.int32))
    for got, w in zip(tcache, want):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("Hkv,rep", [(2, 2), (1, 4)])
def test_decode_plain_matches_jax(Hkv, rep):
    """Kernel 8's plain version appends the quantized row at lengths-1 and
    attends; JAX updates the cache the same way, then attends."""
    rng = np.random.default_rng(10 + rep)
    B, S = 3, 256
    jcache, tcache = _int8_cache(rng, B, Hkv, S)
    lengths = np.array([100, 1, 256], np.int32)
    k_new, v_new = (rng.standard_normal((B, Hkv, DH)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, 1, Hkv * rep, DH)).astype(np.float32)
    jcache = jk.update_kv_cache_int8(*jcache, jnp.asarray(k_new[:, None]),
                                     jnp.asarray(v_new[:, None]), jnp.asarray(lengths - 1))
    pos = jnp.asarray(lengths - 1)[:, None]
    want = np.asarray(jk.attend_cache_int8(jnp.asarray(q), *jcache, pos))
    qg = (q[:, 0] / DH**0.5).reshape(B, Hkv, rep, DH)
    got = kv_int8.flash_decode_int8(t(qg), t(k_new), t(v_new), *tcache, t(lengths)).numpy()
    np.testing.assert_allclose(got.reshape(B, 1, Hkv * rep, DH), want, atol=3e-5, rtol=1e-4)
    for a, w in zip(tcache, jcache):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(w.astype(jnp.float32)))
    pallas = np.asarray(j_flash_decode_int8(jnp.asarray(qg), *jcache, jnp.asarray(lengths),
                                            interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3e-2, rtol=3e-2)


def test_decode_plain_length_zero_is_zeros_and_appends_nothing():
    rng = np.random.default_rng(4)
    _, tcache = _int8_cache(rng, 2, 2, 64)
    before = [c.clone() for c in tcache]
    q = t(rng.standard_normal((2, 2, 1, DH)).astype(np.float32))
    new = t(rng.standard_normal((2, 2, DH)).astype(np.float32))
    out = kv_int8.flash_decode_int8(q, new, new, *tcache, t([0, 9], torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0])) and bool((out[1] != 0).any())
    for a, b in zip(tcache, before):
        assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])


@pytest.mark.parametrize("T,offset", [(16, 16), (13, 0)])
def test_prefill_plain_matches_jax(T, offset):
    rng = np.random.default_rng(T)
    B, Hkv, rep, S = 2, 2, 2, 128
    jcache, tcache = _int8_cache(rng, B, Hkv, S)
    q = rng.standard_normal((B, T, Hkv * rep, DH)).astype(np.float32)
    positions = jnp.broadcast_to(jnp.arange(offset, offset + T)[None], (B, T))
    want = np.asarray(jk.attend_cache_int8(jnp.asarray(q), *jcache, positions))
    qg = t(q / DH**0.5).reshape(B, T, Hkv, rep, DH).permute(0, 2, 3, 1, 4)
    got = kv_int8.flash_attention_int8(qg, *tcache, t([offset] * B, torch.int32))
    got = got.permute(0, 3, 1, 2, 4).reshape(B, T, Hkv * rep, DH).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    if T % 8 == 0:  # the TPU kernel's tiling
        pallas = np.asarray(attend_prefill_int8(jnp.asarray(q), *jcache, positions,
                                                1.0 / DH**0.5, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(kv_int8.launches)
    test_decode_plain_length_zero_is_zeros_and_appends_nothing()
    test_prefill_plain_matches_jax(13, 0)
    assert kv_int8.launches == before


# ---------------------------------------------------------------------------
# Engine on the int8 cache
# ---------------------------------------------------------------------------

CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=256)
PROMPT = [1, 72, 101, 108, 108, 111, 44, 32, 119, 111]


@pytest.fixture(scope="module")
def params():
    jparams = jl.params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(5)),
                                  dtype=jnp.float32)
    return jparams, tl.params_from_jax(numpy_params(jparams))


@pytest.mark.parametrize("kv,max_seq", [("int8", 256), ("auto", 1024)])
def test_engine_int8_greedy_matches_jax(params, kv, max_seq):
    """16 greedy steps, token for token (EOS off; decode chunk 4)."""
    jparams, tparams = params
    jeng = JEngine(CFG, jparams, sampling=SamplingConfig(temperature=0.0), max_seq=max_seq,
                   cache_dtype=kv, decode_chunk=4, eos_id=-1)
    teng = TEngine(port_config(CFG), tparams, sampling=TSamplingConfig(temperature=0.0),
                   max_seq=max_seq, cache_dtype=kv, decode_chunk=4, eos_id=-1)
    assert jeng.cache_dtype == teng.cache_dtype == "int8"
    assert isinstance(teng.new_cache(1), tl.QuantKVCache)
    want = jeng.generate(PROMPT, max_new_tokens=16).tokens
    got = teng.generate(PROMPT, max_new_tokens=16).tokens
    assert len(want) == 16 and got == want


def test_auto_rule_matches_jax(params):
    jparams, tparams = params
    for max_seq, want in ((1024, "int8"), (4096, "int8"), (512, torch.bfloat16),
                          (1023, torch.bfloat16)):
        assert resolve_cache_dtype("auto", max_seq) == want
        j = JEngine(CFG, jparams, max_seq=max_seq, cache_dtype="auto").cache_dtype
        assert (j == "int8") == (want == "int8")
    assert resolve_cache_dtype(torch.float32, 4096) == torch.float32
    eng = TEngine(port_config(CFG), tparams, max_seq=512, cache_dtype="auto")
    assert isinstance(eng.new_cache(1), tl.KVCache)


def test_cache_from_jax_carries_int8_and_bf16_caches():
    stacked = jl.QuantKVCache.create(CFG, 2, 32)
    unrolled = jl.make_unrolled_quant_cache(CFG, 2, 32)
    for src in (tuple(np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
                      else np.asarray(a) for a in stacked),
                [tuple(np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
                       else np.asarray(a) for a in lc) for lc in unrolled]):
        c = tl.cache_from_jax(src)
        assert isinstance(c, tl.QuantKVCache) and len(c.layers()) == CFG.n_layer
        assert tuple(c.k[0].shape) == (2, CFG.n_kv_head, 32, CFG.head_dim)
        assert tuple(c.vs[1].shape) == (2, CFG.n_kv_head, 32)
    bf = jl.KVCache.create(CFG, 1, 16, jnp.float32)
    c = tl.cache_from_jax((np.asarray(bf.k), np.asarray(bf.v)))
    assert isinstance(c, tl.KVCache) and len(c.layers()) == CFG.n_layer


@pytest.mark.parametrize("kv,n_ctx", [("int8", 64), ("auto", 1024)])
def test_cli_kv_int8_and_auto_on_the_cpu(tmp_path, capsys, kv, n_ctx):
    from tokenhawk_tpu_torch import cli
    from tokenhawk_tpu_torch.ggml.writer import write_ggml

    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=128, n_head=2, n_layer=1, n_ff=256)
    tokens, scores = padded_vocab(cfg.n_vocab)
    hp = dict(n_vocab=cfg.n_vocab, n_embd=cfg.n_embd, n_mult=cfg.n_mult, n_head=cfg.n_head,
              n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=0)
    path = tmp_path / "tiny.bin"
    write_ggml(path, hp, tokens, scores, make_ggml_weights(cfg, np.random.default_rng(3)))
    rc = cli.main(["-m", str(path), "Hello", "--device", "cpu", "--dtype", "f32", "--kv", kv,
                   "--n-ctx", str(n_ctx), "--max-tokens", "6", "--greedy"])
    assert rc == 0
    assert "generated; prefill" in capsys.readouterr().err
