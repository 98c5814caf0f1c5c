"""The port's whole slice against the JAX package on a tiny f32 Q4_0 model.

One ggjt file (LlamaConfig.tiny at n_vocab 300, n_embd 256, 2 heads of
128, 2 layers, n_ff 512, n_ctx 256; projections Q4_0 from
make_ggml_weights) is loaded by both packages:
  - the JAX load_model and the port's load_model give the same
    parameters (codes and scales exactly, through params_from_jax), with
    f32 scales and at both loaders' default, bfloat16-rounded scales;
  - their prefill logits agree (f32 on both sides: rtol 1e-4 and an atol
    of 1e-4 of the largest |logit|, summation order only);
  - Engine.generate, greedy, gives identical tokens for 16 steps.
The JAX side runs its default CPU path (XLA), as its own e2e tests do.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.ggml.format import GGMLType
from tokenhawk_tpu.ggml.quants import quantize
from tokenhawk_tpu.ggml.writer import write_ggml
from tokenhawk_tpu.models.llama import params_from_ggml as j_params_from_ggml
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu.runtime.engine import make_prefill_fn as j_make_prefill_fn
from tokenhawk_tpu.runtime.loader import load_model as j_load_model
from tokenhawk_tpu_torch.config import LlamaConfig as TLlamaConfig
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor as TQuantizedTensor
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.runtime.engine import Engine as TEngine
from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn as t_make_prefill_fn
from tokenhawk_tpu_torch.runtime.loader import load_model as t_load_model

from helpers import make_ggml_weights
from torch_helpers import numpy_params, padded_vocab

CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=256)
PROMPT = "hello world, once more"


def _q4_tensors():
    tensors = make_ggml_weights(CFG, np.random.default_rng(5))
    return {k: (quantize(v, GGMLType.Q4_0)
                if v.ndim == 2 and "norm" not in k and k != "tok_embeddings.weight" else v)
            for k, v in tensors.items()}


def _write(path, tensors):
    tokens, scores = padded_vocab(CFG.n_vocab)
    hp = dict(n_vocab=CFG.n_vocab, n_embd=CFG.n_embd, n_mult=CFG.n_mult, n_head=CFG.n_head,
              n_layer=CFG.n_layer, n_rot=CFG.head_dim, ftype=2)
    write_ggml(path, hp, tokens, scores, tensors)
    return str(path)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("model") / "tiny-q4_0.bin", _q4_tensors())


@pytest.fixture(scope="module")
def loaded(model_path):
    j = j_load_model(model_path, n_ctx=CFG.n_ctx, dtype=jnp.float32, scale_dtype=jnp.float32)
    t = t_load_model(model_path, n_ctx=CFG.n_ctx, dtype=torch.float32, device="cpu",
                     scale_dtype=torch.float32)
    return j, t


def _assert_params_equal(a: tl.LlamaParams, b: tl.LlamaParams):
    def eq(x, y):
        assert type(x) is type(y)
        if isinstance(x, QWeight):
            assert torch.equal(x.qs, y.qs) and torch.equal(x.scales, y.scales)
        elif x is not None:
            assert torch.equal(x, y)

    eq(a.tok_embd, b.tok_embd)
    eq(a.norm, b.norm)
    eq(a.output, b.output)
    assert len(a.layers) == len(b.layers)
    for la, lb in zip(a.layers, b.layers):
        for f in dataclasses.fields(tl.LayerParams):
            eq(getattr(la, f.name), getattr(lb, f.name))


def test_load_model_matches_jax(loaded):
    (jcfg, jparams, jtok), (tcfg, tparams, ttok) = loaded
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.rope_style == "half"
    assert jtok.id_to_token == ttok.id_to_token
    _assert_params_equal(tl.params_from_jax(numpy_params(jparams)), tparams)


@pytest.mark.parametrize("scale_dtype", ["default", "float32"])
def test_load_model_scales_match_jax(model_path, scale_dtype):
    """At both loaders' default (Q4_0 scales rounded to bfloat16) and at
    float32, the two packages hold the same codes and scales."""
    kw = {} if scale_dtype == "default" else {"scale_dtype": jnp.float32}
    _, jparams, _ = j_load_model(model_path, n_ctx=CFG.n_ctx, dtype=jnp.float32, **kw)
    kw = {} if scale_dtype == "default" else {"scale_dtype": torch.float32}
    _, tparams, _ = t_load_model(model_path, n_ctx=CFG.n_ctx, dtype=torch.float32, device="cpu",
                                 **kw)
    _assert_params_equal(tl.params_from_jax(numpy_params(jparams)), tparams)
    rounded = tparams.output.scales.to(torch.bfloat16).float()
    assert torch.equal(rounded, tparams.output.scales) == (scale_dtype == "default")


def test_params_from_jax_stacked_matches_params_from_ggml():
    """The stacked (scan) layout converts too, and params_from_ggml agrees
    with the reference before any load-time transform."""
    tensors = _q4_tensors()
    jp = j_params_from_ggml(CFG, tensors, dtype=jnp.float32)
    tcfg = TLlamaConfig(**dataclasses.asdict(CFG))
    tp = tl.params_from_ggml(tcfg, {k: v if isinstance(v, np.ndarray) else TQuantizedTensor(
        v.kind, v.shape, v.qs, v.scales, v.mins) for k, v in tensors.items()},
        dtype=torch.float32, device="cpu")
    _assert_params_equal(tl.params_from_jax(numpy_params(jp)), tp)


def _prefill_logits_match(loaded):
    (jcfg, jparams, jtok), (tcfg, tparams, _) = loaded
    ids = jtok.encode_prompt(PROMPT)
    T = 32
    toks = np.zeros((1, T), np.int32)
    toks[0, :len(ids)] = ids
    lens, offs = np.array([len(ids)], np.int32), np.zeros(1, np.int32)
    from tokenhawk_tpu.models.llama import make_unrolled_cache

    jcache = make_unrolled_cache(jcfg, 1, 64, jnp.float32)
    _, want = j_make_prefill_fn(jcfg)(jparams, jcache, jnp.asarray(toks), jnp.asarray(lens),
                                      jnp.asarray(offs))
    tcache = tl.KVCache.create(tcfg, 1, 64, torch.float32, "cpu")
    _, got = t_make_prefill_fn(tcfg)(tparams, tcache, torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), torch.from_numpy(offs))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_prefill_logits_match_jax(loaded):
    _prefill_logits_match(loaded)


def test_dense_file_logits_match_jax(tmp_path):
    """An f32 file: dense projections through torch.matmul on the port's
    side, XLA dots on the reference's."""
    path = _write(tmp_path / "tiny-f32.bin", make_ggml_weights(CFG, np.random.default_rng(5)))
    j = j_load_model(path, n_ctx=CFG.n_ctx, dtype=jnp.float32)
    t = t_load_model(path, n_ctx=CFG.n_ctx, dtype=torch.float32, device="cpu")
    assert not isinstance(t[1].layers[0].wqkv, QWeight)
    _prefill_logits_match((j, t))


def test_greedy_generate_matches_jax(loaded):
    """16 greedy steps, token for token (EOS off so both run the full
    budget; decode chunk 4 so the chunk loop turns over several times)."""
    (jcfg, jparams, jtok), (tcfg, tparams, ttok) = loaded
    jeng = JEngine(jcfg, jparams, tokenizer=jtok, sampling=SamplingConfig(temperature=0.0),
                   cache_dtype=jnp.float32, decode_chunk=4, eos_id=-1)
    teng = TEngine(tcfg, tparams, tokenizer=ttok, sampling=TSamplingConfig(temperature=0.0),
                   cache_dtype=torch.float32, decode_chunk=4, eos_id=-1)
    want = jeng.generate(PROMPT, max_new_tokens=16)
    got = teng.generate(PROMPT, max_new_tokens=16)
    assert len(want.tokens) == 16
    assert got.tokens == want.tokens
    assert got.text == want.text and got.prompt_tokens == want.prompt_tokens


def test_generate_stops_at_eos_and_done_slots_hold(loaded):
    """A slot that emits EOS stops streaming, and inside a chunk it keeps
    emitting the EOS sentinel without advancing its offset."""
    _, (tcfg, tparams, ttok) = loaded
    eng = TEngine(tcfg, tparams, tokenizer=ttok, sampling=TSamplingConfig(temperature=0.0),
                  cache_dtype=torch.float32, decode_chunk=4, eos_id=-1)
    first = eng.generate(PROMPT, max_new_tokens=8).tokens
    stop = first[3]
    eng = TEngine(tcfg, tparams, tokenizer=ttok, sampling=TSamplingConfig(temperature=0.0),
                  cache_dtype=torch.float32, decode_chunk=4, eos_id=stop)
    assert eng.generate(PROMPT, max_new_tokens=8).tokens == first[:first.index(stop)]
    dec = eng._decode
    cache = eng.new_cache(1)
    out = dec(tparams, cache, torch.tensor([stop]), torch.tensor([5], dtype=torch.int32),
              torch.full((1, 64), -1), torch.tensor([True]), eng.generator)
    _, toks, offsets, _, done = out
    assert toks.tolist() == [[stop] * 4] and offsets.tolist() == [5] and done.tolist() == [True]
