"""The port's runtime/eval.py against tests/test_eval.py's cases.

The same tiny model (make_ggml_weights at the reference's CFG, float32
activations; the score fn's cache is bfloat16, as the reference's):
  - the score fn's logprobs against the float64 numpy oracle forward_np
    (atol 5e-2, rtol 1e-2: the reference's tolerance, for the bfloat16
    cache);
  - the perplexity is finite and above 1;
  - Q8_0 weights move the perplexity by less than 0.05 in log;
and one of the port's own: a Q4_K_M GGUF at D 1024 loaded at float32
sides with THAWK_Q4K_SB=1 and without scores the same stream within 1e-4
in log (at float32 sides the two forms hold the same weights).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig as JLlamaConfig
from tokenhawk_tpu.models.reference_numpy import forward_np
from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml import synth
from tokenhawk_tpu_torch.ggml.format import GGMLType
from tokenhawk_tpu_torch.ggml.quants import quantize
from tokenhawk_tpu_torch.models.llama import params_from_ggml
from tokenhawk_tpu_torch.runtime.eval import make_score_fn, mean_nll, perplexity
from tokenhawk_tpu_torch.runtime.loader import load_model

from helpers import make_ggml_weights

JCFG = JLlamaConfig.tiny(n_vocab=256, n_ctx=64)
CFG = LlamaConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    tensors = make_ggml_weights(JCFG, rng)
    params = params_from_ggml(CFG, tensors, dtype=torch.float32, device="cpu")
    return rng, tensors, params


def test_score_matches_oracle(setup):
    rng, tensors, params = setup
    toks = rng.integers(0, CFG.n_vocab, size=16)
    lp = make_score_fn(CFG, 16)(params, torch.from_numpy(toks[None, :]))[0].numpy()
    logits = forward_np(JCFG, tensors, toks)
    m = logits.max(-1, keepdims=True)
    ref_lp = logits - np.log(np.exp(logits - m).sum(-1, keepdims=True)) - m
    np.testing.assert_allclose(lp, ref_lp[np.arange(15), toks[1:]], atol=5e-2, rtol=1e-2)


def test_perplexity_positive_and_finite(setup):
    rng, _, params = setup
    ppl = perplexity(CFG, params, rng.integers(0, CFG.n_vocab, size=64), window=32)
    assert np.isfinite(ppl) and ppl > 1.0


def test_quantized_ppl_close_to_dense(setup):
    """Q8_0 weight-only quantization perturbs ppl only slightly."""
    rng, tensors, params = setup
    toks = rng.integers(0, CFG.n_vocab, size=64)
    ppl_f32 = perplexity(CFG, params, toks, window=32)
    qt = {k: (quantize(v, GGMLType.Q8_0)
              if v.ndim == 2 and "norm" not in k and k != "tok_embeddings.weight" else v)
          for k, v in tensors.items()}
    params_q8 = params_from_ggml(CFG, qt, dtype=torch.float32, device="cpu")
    ppl_q8 = perplexity(CFG, params_q8, toks, window=32)
    # random tiny model ppl ~ n_vocab; q8 should stay within a few percent.
    assert abs(math.log(ppl_q8) - math.log(ppl_f32)) < 0.05


def test_sb_and_flat_forms_score_alike(tmp_path, monkeypatch):
    cfg = LlamaConfig.tiny(n_vocab=512, n_embd=1024, n_head=8, n_kv_head=2, n_layer=2,
                           n_ff=1024, n_ctx=64)
    path = str(tmp_path / "q4_k_m.gguf")
    synth.write_random_llama(path, cfg, "q4_k_m", synth.bpe_vocab_metadata(
        cfg.n_vocab, np.random.default_rng(3), n_special=16), seed=31, std=0.05)
    toks = np.random.default_rng(4).integers(0, cfg.n_vocab, size=64)
    nll = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("THAWK_Q4K_SB", flag)
        lcfg, params, _ = load_model(path, n_ctx=64, dtype=torch.float32, device="cpu",
                                     scale_dtype=torch.float32)
        assert (params.layers[0].wqkv.kind == "q4k_sb") == (flag == "1")
        nll[flag] = mean_nll(lcfg, params, toks, window=32)
    assert np.isfinite(nll["0"]) and abs(nll["1"] - nll["0"]) < 1e-4
