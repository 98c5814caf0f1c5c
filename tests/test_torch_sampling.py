"""The port's sampling against the JAX package's.

Masks and greedy picks must be identical (same f32 arithmetic); draws
come from different generators, so the sampled frequencies are held to
the probabilities the JAX pipeline computes, by a chi-square test at
p > 1e-4 on 40000 draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from tokenhawk_tpu import sampling as js
from tokenhawk_tpu.config import SamplingConfig
from tokenhawk_tpu_torch import sampling as ts
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig


def _logits(seed, B=4, V=64):
    return (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5, 40, 64])
def test_top_k_mask_matches(k):
    x = _logits(k)
    np.testing.assert_array_equal(ts.top_k_mask(torch.from_numpy(x), k).numpy(),
                                  np.asarray(js.top_k_mask(jnp.asarray(x), k)))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.95, 1.0])
def test_top_p_mask_matches(p):
    x = _logits(int(p * 100))
    np.testing.assert_array_equal(ts.top_p_mask(torch.from_numpy(x), p).numpy(),
                                  np.asarray(js.top_p_mask(jnp.asarray(x), p)))


def test_repeat_penalty_and_greedy_match():
    x = _logits(3)
    last = np.array([[-1, 5, 7, 5], [0, -1, -1, -1], [63, 1, 2, 3], [-1, -1, -1, -1]])
    np.testing.assert_array_equal(
        ts.apply_repeat_penalty(torch.from_numpy(x), torch.from_numpy(last), 1.3).numpy(),
        np.asarray(js.apply_repeat_penalty(jnp.asarray(x), jnp.asarray(last), 1.3)))
    greedy = SamplingConfig(temperature=0.0)
    want = np.asarray(js.sample(jnp.asarray(x), jax.random.PRNGKey(0), greedy))
    got = ts.sample(torch.from_numpy(x), None, TSamplingConfig(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_frequencies_fit_probabilities():
    V, n = 12, 40000
    x = _logits(11, B=1, V=V)
    last = np.array([[2, 3, -1]])
    cfg = SamplingConfig(temperature=0.8, top_k=8, top_p=0.9, repeat_penalty=1.2)
    z = js.apply_repeat_penalty(jnp.asarray(x), jnp.asarray(last), cfg.repeat_penalty)
    z = js.top_p_mask(js.top_k_mask(z / cfg.temperature, cfg.top_k), cfg.top_p)
    probs = np.asarray(jax.nn.softmax(z, axis=-1))[0].astype(np.float64)
    g = torch.Generator().manual_seed(0)
    tcfg = TSamplingConfig(temperature=0.8, top_k=8, top_p=0.9, repeat_penalty=1.2)
    draws = ts.sample(torch.from_numpy(np.repeat(x, n, 0)), g, tcfg,
                      torch.from_numpy(np.repeat(last, n, 0))).numpy()
    counts = np.bincount(draws, minlength=V)
    assert counts[probs == 0].sum() == 0  # masked tokens are unreachable
    live = probs > 0
    assert chisquare(counts[live], probs[live] / probs[live].sum() * n).pvalue > 1e-4


def test_eos_helpers_match():
    assert ts.normalize_eos(2) == js.normalize_eos(2)
    assert ts.normalize_eos([128009, 128001]) == js.normalize_eos([128009, 128001])
    tok = np.array([1, 2, 5, 7])
    np.testing.assert_array_equal(ts.is_eos(torch.from_numpy(tok), (2, 7)).numpy(),
                                  np.asarray(js.is_eos(jnp.asarray(tok), (2, 7))))
