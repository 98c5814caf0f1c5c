"""The port's Q4_K super-block form (q4k_sb, kernel 17) against the JAX package.

Random Q4_K block streams (ggml/synth.py) go through both packages'
from_kquant_raw: the reference's with use_i4=True (its TPU default, which
the sb form needs) and THAWK_Q4K_SB=1, the port's with sb=True.
  - `dequantize()` equals the reference's bit for bit at float32 and at
    bfloat16 sides (both round d / dmin, not s and the bias), and so does
    a weight rebuilt from the reference's fields (from_jax);
  - the width gate and sb_ok give the reference's kinds;
  - kernel 17's plain version (what a CPU tensor runs) agrees with the
    reference's quant_matmul in interpret mode (its Pallas qk_sb_matmul;
    the reference's XLA path cannot run the sb kind), with and without the
    norm; kernel 2's plain version with an sb w13 and a flat w2 with the
    reference's fused_ffn in interpret mode: f32 on both sides, so
    summation order only, within 1e-4 of the largest output;
  - a 2-layer Q4_K_M GGUF at D 1024 loaded by the port with
    THAWK_Q4K_SB=1 at float32 sides (sb kinds wherever the reference's
    gate puts them) against the reference's load_model of the same file
    on its CPU path (flat forms, which at float32 sides are the same
    weights): prefill logits within 1e-4 of the largest |logit|, and the
    Engines' 16 greedy tokens identical.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import SamplingConfig as JSamplingConfig
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.models.llama import make_unrolled_cache
from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.norms import rms_norm as j_rms_norm
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu.runtime.engine import make_prefill_fn as j_make_prefill_fn
from tokenhawk_tpu.runtime.loader import load_model as j_load_model
from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.ggml import synth
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.runtime.engine import Engine, make_prefill_fn
from tokenhawk_tpu_torch.runtime.loader import load_model

from torch_helpers import t

SIDES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _raw(out_dim, in_dim, seed=0):
    rng = np.random.default_rng(seed)
    return synth.random_kquant(TType.Q4_K, (out_dim, in_dim), rng, std=0.05).raw


def _reference(monkeypatch, raw, shape, sides="f32", sb_ok=True):
    monkeypatch.setenv("THAWK_Q4K_SB", "1")
    return j_qw.from_kquant_raw(JType.Q4_K, raw, shape, scale_dtype=SIDES[sides][0],
                                use_i4=True, sb_ok=sb_ok)


def _port(raw, shape, sides="f32", sb_ok=True):
    return QWeight.from_kquant_raw(TType.Q4_K, raw, shape, scale_dtype=SIDES[sides][1],
                                   sb=True, sb_ok=sb_ok)


@pytest.mark.parametrize("sides", ["f32", "bf16"])
def test_dequantize_is_the_references_bit_for_bit(sides, monkeypatch):
    N, K = 96, 1024
    raw = _raw(N, K)
    jw, pw = _reference(monkeypatch, raw, (N, K), sides), _port(raw, (N, K), sides)
    assert jw.kind == "q4k_sb" and pw.kind == "q4k_sb" and pw.shape == (K, N)
    assert (pw.qs.dtype, pw.qs.shape) == (torch.uint8, (N, K // 2))
    assert (pw.scmn.dtype, pw.scmn.shape) == (torch.uint8, (N, 2 * K // 32))
    assert pw.scales.shape == pw.mins.shape == (N, K // 256)
    assert pw.nbytes == N * K // 2 + N * K // 16 + 2 * 4 * N * K // 256
    want = np.asarray(jw.dequantize(jnp.float32))
    np.testing.assert_array_equal(pw.dequantize().numpy(), want)
    again = QWeight.from_jax(jw.kind, np.asarray(jw.qs).astype(np.int8),
                             np.asarray(jw.scales, np.float32), np.asarray(jw.mins, np.float32),
                             np.asarray(jw.scales_hi))
    np.testing.assert_array_equal(again.dequantize().numpy(), want)
    # The flat form of the same blocks rounds s and the bias instead: the
    # same weights at float32 sides, others at bfloat16 sides.
    flat = QWeight.from_kquant_raw(TType.Q4_K, raw, (N, K), scale_dtype=SIDES[sides][1])
    assert np.array_equal(flat.dequantize().numpy(), want) == (sides == "f32")


@pytest.mark.parametrize("in_dim, sb_ok", [(1024, True), (512, True), (1024, False),
                                           (5120, True), (17408, True)])
def test_the_gate_gives_the_references_kinds(in_dim, sb_ok, monkeypatch):
    raw = _raw(8, in_dim)
    jw = _reference(monkeypatch, raw, (8, in_dim), sb_ok=sb_ok)
    pw = _port(raw, (8, in_dim), sb_ok=sb_ok)
    assert (pw.kind == "q4k_sb") == (jw.kind == "q4k_sb")
    assert pw.kind == ("q4k_sb" if in_dim in (1024, 5120) and sb_ok else "qk")
    assert QWeight.from_kquant_raw(TType.Q4_K, raw, (8, in_dim)).kind == "qk"  # flag off


def test_random_flat_and_fused_forms_carry_the_sides():
    """QWeight.random's super-block weights (what chip_smoke.py draws on the
    card), their flat form (kernel 13's comparison there), and the load-time
    transforms: concat_qweights and take_columns carry scmn with the codes."""
    from tokenhawk_tpu_torch.ops.qweight import concat_qweights, take_columns

    g = torch.Generator().manual_seed(0)
    a, b = (QWeight.random(1024, n, "q4k_sb", g, std=0.02) for n in (64, 32))
    wa = a.dequantize()
    assert a.kind == "q4k_sb" and abs(wa.std().item() - 0.02) < 0.005
    assert abs(wa.mean().item()) < 0.002
    flat = a.flat()
    assert (flat.kind, flat.group, flat.qs.dtype) == ("qk", 32, torch.int8)
    np.testing.assert_array_equal(flat.dequantize().numpy(), wa.numpy())
    cat = concat_qweights([a, b])
    assert cat.kind == "q4k_sb" and cat.scmn.shape == (96, 64)
    np.testing.assert_array_equal(cat.dequantize().numpy(),
                                  torch.cat([wa, b.dequantize()], 1).numpy())
    idx = torch.randperm(96, generator=g)
    np.testing.assert_array_equal(take_columns(cat, idx).dequantize().numpy(),
                                  cat.dequantize()[:, idx].numpy())


@pytest.mark.parametrize("norm", [False, True])
def test_kernel_17_plain_matches_the_references_pallas_kernel(norm, monkeypatch):
    from tokenhawk_tpu.ops.pallas.qmatmul import quant_matmul as j_quant_matmul

    N, K = 256, 1024
    raw = _raw(N, K, seed=1)
    jw, pw = _reference(monkeypatch, raw, (N, K)), _port(raw, (N, K))
    rng = np.random.default_rng(2 + norm)
    x = rng.standard_normal((3, K)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32) if norm else None
    want = np.asarray(j_quant_matmul(jnp.asarray(x), jw, None if g is None else jnp.asarray(g),
                                     interpret=True))
    before = dict(qmatmul.launches)
    got = qmatmul.quant_matmul(t(x), pw, None if g is None else t(g)).numpy()
    assert qmatmul.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_kernel_2_plain_with_an_sb_w13_matches_the_references_pallas_kernel(monkeypatch):
    import tokenhawk_tpu.ops.pallas.ffn as j_ffn

    monkeypatch.setattr(j_ffn, "_FFN_ENABLED", True)
    monkeypatch.setattr(j_ffn, "BLOCK_F", 256)
    D, F = 1024, 512
    raw13, raw2 = _raw(2 * F, D, seed=3), _raw(D, F, seed=4)
    jw13 = _reference(monkeypatch, raw13, (2 * F, D))
    jw2 = _reference(monkeypatch, raw2, (D, F), sb_ok=False)
    assert (jw13.kind, jw2.kind) == ("q4k_sb", "qk_i4") and j_ffn.can_fuse_ffn(jw13, jw2, 1)
    w13, w2 = _port(raw13, (2 * F, D)), _port(raw2, (D, F), sb_ok=False)
    assert (w13.kind, w2.kind) == ("q4k_sb", "qk") and ffn.can_fuse_ffn(w13, w2, 1)
    assert not ffn.can_fuse_ffn(w13, _port(_raw(D, 2 * F, seed=5), (D, 2 * F)), 1)
    assert not ffn.can_fuse_owo_ffn(_port(_raw(D, D, seed=6), (D, D)), w13, w2, 1)
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((1, D))).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    want = np.asarray(j_ffn.fused_ffn(jnp.asarray(x), jw13, jw2, jnp.asarray(g),
                                      interpret=True))
    got = ffn.fused_ffn(t(x), w13, w2, t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # The numpy oracle of the same function, as tests/test_q4k_sb.py builds it.
    xn = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(g)), np.float32)
    wd13, wd2 = w13.dequantize().numpy(), w2.dequantize().numpy()
    gu = xn @ wd13
    h = gu[:, :F] / (1.0 + np.exp(-gu[:, :F])) * gu[:, F:]
    np.testing.assert_allclose(got, x + h @ wd2, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# A 2-layer Llama-3-shaped Q4_K_M model at the narrowest width the sb gate
# takes (D 1024): layer 0 all Q4_K, layer 1 with a Q6_K wv and w2.
CFG = LlamaConfig.tiny(n_vocab=512, n_embd=1024, n_head=8, n_kv_head=2, n_layer=2, n_ff=1024,
                       n_ctx=64, rope_theta=500000.0, rms_norm_eps=1e-5)
PROMPT = "Tell me 3 stories about 42 cats"
N_NEW = 16


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q4k_sb") / "q4_k_m.gguf")
    md = synth.bpe_vocab_metadata(CFG.n_vocab, np.random.default_rng(1), n_special=16)
    synth.write_random_llama(path, CFG, "q4_k_m", md, seed=21, std=0.05)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("THAWK_Q4K_SB", "1")
        port = load_model(path, n_ctx=CFG.n_ctx, dtype=torch.float32, device="cpu",
                          scale_dtype=torch.float32)
        ref = j_load_model(path, n_ctx=CFG.n_ctx, dtype=jnp.float32, scale_dtype=jnp.float32)
    return ref, port


def test_sb_model_matches_the_reference(loaded):
    (jcfg, jparams, jtok), (tcfg, tparams, ttok) = loaded
    l0, l1 = tparams.layers
    assert [w.kind for w in (l0.wqkv, l0.wo, l0.w13, l1.wq, l1.wk, l1.wo, l1.w13)] == \
        ["q4k_sb"] * 7
    assert (l0.w2.kind, l0.w2.group, l0.w2.mins is not None) == ("qk", 32, True)  # flat Q4_K
    assert (l1.wv.kind, l1.wv.group, l1.w2.group) == ("qk", 16, 16)  # Q6_K
    assert l1.wqkv is None and tparams.output.kind == "qk"
    assert ffn.can_fuse_ffn(l0.w13, l0.w2, 1) and ffn.can_fuse_ffn(l1.w13, l1.w2, 1)

    ids = jtok.encode_prompt(PROMPT)
    assert ttok.encode_prompt(PROMPT) == ids
    T = 48
    toks = np.zeros((1, T), np.int32)
    toks[0, :len(ids)] = ids
    lens, offs = np.array([len(ids)], np.int32), np.zeros(1, np.int32)
    _, want = j_make_prefill_fn(jcfg)(jparams, make_unrolled_cache(jcfg, 1, 64, jnp.float32),
                                      jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(offs))
    from tokenhawk_tpu_torch.models.llama import KVCache

    _, got = make_prefill_fn(tcfg)(tparams, KVCache.create(tcfg, 1, 64, torch.float32, "cpu"),
                                   t(toks, torch.long), t(lens), t(offs))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    jeng = JEngine(jcfg, jparams, tokenizer=jtok, sampling=JSamplingConfig(temperature=0.0),
                   cache_dtype=jnp.float32, decode_chunk=4, eos_id=-1)
    teng = Engine(tcfg, tparams, ttok, SamplingConfig(temperature=0.0),
                  cache_dtype=torch.float32, decode_chunk=4, eos_id=-1)
    before = dict(qmatmul.launches)
    assert teng.generate(PROMPT, max_new_tokens=N_NEW).tokens == \
        jeng.generate(PROMPT, max_new_tokens=N_NEW).tokens
    assert qmatmul.launches == before
