"""The port's SpeculativeEngine and CLI speculation against the JAX package.

On the fixtures of tests/test_speculative.py (a 4-layer f32 target and
an unrelated 2-layer draft, head dim 32, dense weights through
params_from_jax): the greedy speculative stream equals the JAX
SpeculativeEngine's and the port's own target-only Engine's, at gamma 1,
3 and 4, whatever the draft; a draft that is the target accepts the
same drafts as the reference's, round for round; a vocab mismatch
raises.  Then the CLI with --draft-model on tiny ggjt files with --device
cpu, in a subprocess: the bytes of the target's greedy tokens, and the
acceptance line.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.runtime.speculative import SpeculativeEngine as JSpeculativeEngine
from tokenhawk_tpu_torch.config import SamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.runtime.engine import Engine
from tokenhawk_tpu_torch.runtime.speculative import SpeculativeEngine

from helpers import make_ggml_weights
from torch_helpers import numpy_params, padded_vocab, port_config, subprocess_env

CFG_T = LlamaConfig.tiny(n_vocab=512, n_embd=128, n_head=4, n_layer=4, n_ctx=64, n_ff=256)
CFG_D = LlamaConfig.tiny(n_vocab=512, n_embd=64, n_head=2, n_layer=2, n_ctx=64, n_ff=128)
PROMPT = [1, 7, 42, 9]


def _params(cfg, seed):
    """(JAX params, the port's params) of make_ggml_weights(seed), f32."""
    jp = params_from_ggml(cfg, make_ggml_weights(cfg, np.random.default_rng(seed)),
                          dtype=jnp.float32)
    return jp, tl.params_from_jax(numpy_params(jp))


@pytest.fixture(scope="module")
def target():
    return _params(CFG_T, 11)


@pytest.fixture(scope="module")
def draft():
    return _params(CFG_D, 99)


@pytest.fixture(scope="module")
def greedy_stream(target):
    eng = Engine(port_config(CFG_T), target[1], sampling=SamplingConfig(temperature=0.0),
                 cache_dtype=torch.float32, decode_chunk=4)
    return eng.generate(PROMPT, max_new_tokens=12).tokens


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_spec_matches_jax_and_target_greedy(target, draft, greedy_stream, gamma):
    jspec = JSpeculativeEngine(CFG_T, target[0], CFG_D, draft[0], gamma=gamma,
                               cache_dtype=jnp.float32)
    want, jstats = jspec.generate(PROMPT, max_new_tokens=12)
    spec = SpeculativeEngine(port_config(CFG_T), target[1], port_config(CFG_D), draft[1],
                             gamma=gamma, cache_dtype=torch.float32)
    got, stats = spec.generate(PROMPT, max_new_tokens=12)
    assert got == want
    assert got[:len(greedy_stream)] == greedy_stream
    assert stats["rounds"] > 0 and stats["drafted"] == stats["rounds"] * gamma
    assert 0.0 <= stats["acceptance_rate"] <= 1.0
    assert set(stats) == set(jstats)


def test_self_draft_acceptance_equals_the_reference(target, greedy_stream):
    """Draft == target in f32: the port's rounds are the reference's, so
    the same drafts are accepted round for round.  Neither reaches 100%:
    after a round that accepts every draft, the draft's cache has no row
    for the last one (as in the reference), and the next round's drafts
    attend without it."""
    cfg = port_config(CFG_T)
    spec = SpeculativeEngine(cfg, target[1], cfg, target[1], gamma=3, cache_dtype=torch.float32)
    got, stats = spec.generate(PROMPT, max_new_tokens=12)
    want, jstats = JSpeculativeEngine(CFG_T, target[0], CFG_T, target[0], gamma=3,
                                      cache_dtype=jnp.float32).generate(PROMPT, max_new_tokens=12)
    assert got == want and got[:len(greedy_stream)] == greedy_stream
    for key in ("rounds", "drafted", "accepted_drafts"):
        assert stats[key] == jstats[key], key
    assert stats["acceptance_rate"] > 0.5 and stats["tokens_per_round"] > 2.0


def test_streams_tokens_and_stops_at_eos(target, draft, greedy_stream):
    seen = []
    spec = SpeculativeEngine(port_config(CFG_T), target[1], port_config(CFG_D), draft[1],
                             gamma=2, cache_dtype=torch.float32, eos_id=greedy_stream[5])
    got, _ = spec.generate(PROMPT, max_new_tokens=12, on_token=seen.append)
    assert seen == got == greedy_stream[:6]


def test_vocab_mismatch_raises(target):
    other = port_config(LlamaConfig.tiny(n_vocab=500, n_embd=64, n_head=2, n_layer=1, n_ff=128))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(port_config(CFG_T), target[1], other, target[1])


def test_cli_with_draft_model_prints_the_target_stream(tmp_path):
    """`python -m tokenhawk_tpu_torch.cli --draft-model` on the CPU prints
    the bytes of the target's greedy tokens (the port's Engine on the same
    file) and the acceptance in its stats line."""
    import subprocess
    from pathlib import Path

    from tokenhawk_tpu_torch.ggml.writer import write_ggml
    from tokenhawk_tpu_torch.runtime.loader import load_model

    paths = []
    for cfg, seed in ((CFG_T, 11), (CFG_D, 99)):
        tokens, scores = padded_vocab(cfg.n_vocab)
        hp = dict(n_vocab=cfg.n_vocab, n_embd=cfg.n_embd, n_mult=cfg.n_mult, n_head=cfg.n_head,
                  n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=0)
        paths.append(str(tmp_path / f"m{seed}.bin"))
        write_ggml(paths[-1], hp, tokens, scores,
                   make_ggml_weights(cfg, np.random.default_rng(seed)))
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "tokenhawk_tpu_torch.cli", "-m", paths[0], "Hello there",
         "--draft-model", paths[1], "--gamma", "3", "--device", "cpu", "--dtype", "f32",
         "--n-ctx", "64", "--max-tokens", "10", "--greedy"],
        cwd=root, env=subprocess_env(), capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    cfg, params, tok = load_model(paths[0], n_ctx=64, dtype=torch.float32, device="cpu")
    eng = Engine(cfg, params, tok, SamplingConfig(temperature=0.0), cache_dtype=torch.float32)
    want = b"".join(tok.decode_token_bytes(t) for t in eng.generate("Hello there", 10).tokens)
    assert want and out.stdout == want + b"\n"
    assert b"accept" in out.stderr and b"tok/round" in out.stderr
