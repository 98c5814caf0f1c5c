"""The port's sampling against the JAX package's.

Masks and greedy picks must be identical (same f32 arithmetic), and the
per-slot processed distributions within 1e-6 (a sort, softmax and
cumulative sum in another order); draws come from different generators,
so the sampled frequencies are held to the processed probabilities by a
chi-square test at p > 1e-4 on 40000 draws.
"""

import dataclasses

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


# -- per-slot sampling (continuous batching) ---------------------------------

CFGS = [SamplingConfig(temperature=0.0),
        SamplingConfig(temperature=0.8, top_k=8, top_p=0.9, repeat_penalty=1.2),
        SamplingConfig(temperature=1.3, top_k=0, top_p=1.0, repeat_penalty=1.0),
        SamplingConfig(temperature=0.5, top_k=40, top_p=0.5, repeat_penalty=1.1, seed=7)]


def _sp_pair(cfgs):
    tcfgs = [TSamplingConfig(**dataclasses.asdict(c)) for c in cfgs]
    return (js.SamplingParams.from_configs(cfgs, len(cfgs)),
            ts.SamplingParams.from_configs(tcfgs, len(tcfgs)))


def test_sampling_params_slot_updates_match_jax():
    """broadcast, then set_slot (one slot) and set_rows (a scattered
    group) leave the same per-slot values as the reference's set_slot."""
    tcfgs = [TSamplingConfig(**dataclasses.asdict(c)) for c in CFGS]
    jsp = js.SamplingParams.broadcast(CFGS[0], 4)
    tsp = ts.SamplingParams.broadcast(tcfgs[0], 4)
    jsp = jsp.set_slot(2, js.SamplingParams.slot_values(CFGS[1]))
    tsp.set_slot(2, ts.SamplingParams.slot_values(tcfgs[1]))
    for slot, i in ((3, 2), (0, 3)):
        jsp = jsp.set_slot(slot, js.SamplingParams.slot_values(CFGS[i]))
    tsp.set_rows(torch.tensor([3, 0]), ts.SamplingParams.from_configs(tcfgs[2:], 2))
    want = [jsp.temperature, jsp.top_k, jsp.top_p, jsp.repeat_penalty, jsp.seed]
    for got, w in zip(tsp.fields(), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w).astype(got.numpy().dtype))


def test_processed_probs_dynamic_matches_jax():
    x = _logits(21, B=4, V=64)
    last = np.array([[-1, 5, 7, 5], [0, -1, -1, -1], [63, 1, 2, 3], [9, 9, 10, 11]])
    jsp, tsp = _sp_pair(CFGS)
    want = np.asarray(js.processed_probs_dynamic(jnp.asarray(x), jsp, jnp.asarray(last)))
    got = ts.processed_probs_dynamic(torch.from_numpy(x), tsp, torch.from_numpy(last))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # Greedy rows: the raw argmax, taken before the penalty.
    got_ids = ts.sample_dynamic(torch.from_numpy(x), tsp, torch.zeros(4, dtype=torch.int64),
                                torch.from_numpy(last))
    want_ids = np.asarray(js.sample_dynamic(jnp.asarray(x), jsp, jnp.zeros(4, jnp.int32),
                                            jnp.asarray(last)))
    assert got_ids[0] == want_ids[0] == x[0].argmax()


def test_sample_dynamic_slot_independent_of_its_batch():
    """Row b's draw depends only on (logits[b], its params, seed, counter)."""
    x = _logits(22, B=4, V=64)
    _, tsp = _sp_pair(CFGS)
    counters = torch.tensor([3, 17, 5, 0])
    full = ts.sample_dynamic(torch.from_numpy(x), tsp, counters)
    for b in range(4):
        one = ts.SamplingParams(*[a[b:b + 1] for a in tsp.fields()])
        alone = ts.sample_dynamic(torch.from_numpy(x[b:b + 1]), one, counters[b:b + 1])
        assert alone.item() == full[b].item()
    again = ts.sample_dynamic(torch.from_numpy(x), tsp, counters)
    assert torch.equal(full, again)


def test_sample_dynamic_draws_fit_processed_distribution():
    """40000 draws of one slot over consecutive counters (its real stream)
    against the processed probabilities: chi-square p > 1e-4; masked
    tokens never drawn."""
    V, n = 24, 40000
    x = _logits(23, B=1, V=V)
    last = np.array([[2, 3, -1]])
    cfg = TSamplingConfig(temperature=0.8, top_k=12, top_p=0.9, repeat_penalty=1.2, seed=99)
    sp = ts.SamplingParams.broadcast(cfg, n)
    logits = torch.from_numpy(np.repeat(x, n, 0))
    rings = torch.from_numpy(np.repeat(last, n, 0))
    draws = ts.sample_dynamic(logits, sp, torch.arange(n), rings).numpy()
    probs = ts.processed_probs_dynamic(logits[:1], ts.SamplingParams.broadcast(cfg, 1),
                                       rings[:1])[0].double().numpy()
    counts = np.bincount(draws, minlength=V)
    assert counts[probs == 0].sum() == 0
    live = probs > 0
    assert chisquare(counts[live], probs[live] / probs[live].sum() * n).pvalue > 1e-4
    # Another seed gives another stream of the same distribution.
    other = ts.sample_dynamic(logits, ts.SamplingParams.broadcast(
        dataclasses.replace(cfg, seed=100), n), torch.arange(n), rings).numpy()
    assert (other != draws).mean() > 0.3


def test_uniform_rows_are_uniform_and_open():
    u = ts.uniform_rows(torch.tensor([1, 2**31 - 1]), torch.tensor([0, 12345]), 50000)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    for row in u.numpy():
        hist = np.histogram(row, bins=20, range=(0, 1))[0]
        assert chisquare(hist).pvalue > 1e-4
