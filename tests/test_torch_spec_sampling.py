"""Sampled speculation, the paged verify forward and the speculative
server entry point of the port, against the JAX package.

On the fixtures of tests/test_spec_sampled.py (a 2-layer f32 target of
head dim 32 and a 1-layer draft of head dim 16):
  - the first committed token over 2000 seeds passes a chi-square test
    against the JAX target's processed distribution (the port's draws
    come from its own counter hash, so it is held in distribution, not
    token for token); the sampled round with temperature 0 is the greedy
    round token for token; a greedy slot beside a sampled one in either
    scheduler is exact;
  - forward_paged_verify against the JAX one on the live rows (rtol 1e-4);
  - `python -m tokenhawk_tpu_torch.serving --draft-model --paged` on the CPU.
"""

import json
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.config import SamplingConfig as JSamplingConfig
from tokenhawk_tpu.models import llama as jl
from tokenhawk_tpu.runtime import paged as jp
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler as JPaged
from tokenhawk_tpu.runtime.scheduler import Request as JRequest
from tokenhawk_tpu.runtime.scheduler import Scheduler as JScheduler
from tokenhawk_tpu.sampling import SamplingParams as JSamplingParams
from tokenhawk_tpu.sampling import processed_probs_dynamic as j_processed
from tokenhawk_tpu_torch.config import SamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.runtime import paged as tp
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Request, Scheduler
from tokenhawk_tpu_torch.runtime.speculative import (
    make_spec_serving_fn,
    make_spec_serving_fn_sampled,
)
from tokenhawk_tpu_torch.sampling import SamplingParams

from helpers import make_ggml_weights
from torch_helpers import numpy_params, padded_vocab, port_config, subprocess_env, t

CFG = LlamaConfig(n_vocab=97, n_embd=64, n_head=2, n_layer=2, n_ctx=96, n_ff=96)
DRAFT_CFG = LlamaConfig(n_vocab=97, n_embd=32, n_head=2, n_layer=1, n_ctx=96, n_ff=48)
TCFG, TDRAFT = port_config(CFG), port_config(DRAFT_CFG)
GREEDY = SamplingConfig(temperature=0.0)
JGREEDY = JSamplingConfig(temperature=0.0)
N_RING = 16
GAMMA = 3


def _params(cfg, seed):
    jparams = jl.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return jparams, tl.params_from_jax(numpy_params(jparams))


@pytest.fixture(scope="module")
def target():
    return _params(CFG, 0)


@pytest.fixture(scope="module")
def draft():
    return _params(DRAFT_CFG, 7)


def _run(sched, req_cls, prompts, max_new):
    reqs = [req_cls(prompt=list(p), max_new_tokens=m) for p, m in zip(prompts, max_new)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [r.output for r in reqs]


def _prefilled(target, draft, prompt, batch):
    """Both caches after the prompt's prefill, copied to `batch` rows, and
    the target's greedy first token, the offsets and the last-N ring."""
    tc = tl.KVCache.create(TCFG, batch, 32, torch.float32, "cpu")
    dc = tl.KVCache.create(TDRAFT, batch, 32, torch.float32, "cpu")
    toks = torch.tensor([prompt] * batch)
    zero = torch.zeros(batch, dtype=torch.int32)
    with torch.no_grad():
        h, _ = tl.forward(TCFG, target[1], toks, tc, zero)
        tl.forward(TDRAFT, draft[1], toks, dc, zero)
        first = tl.logits_from_hidden(TCFG, target[1], h[:, -1]).argmax(-1)
    ring = np.full((batch, N_RING), -1, np.int64)
    hist = (prompt + [int(first[0])])[-N_RING:]
    ring[:, N_RING - len(hist):] = hist
    return tc, dc, first, zero + len(prompt), torch.from_numpy(ring)


def _sp(batch, temp, seeds, top_k=0, top_p=1.0, penalty=1.0):
    return SamplingParams(temperature=torch.full((batch,), temp), top_k=torch.full((batch,), top_k),
                          top_p=torch.full((batch,), top_p),
                          repeat_penalty=torch.full((batch,), penalty),
                          seed=torch.as_tensor(seeds, dtype=torch.int64))


@pytest.mark.parametrize("spkw", [dict(temp=1.0), dict(temp=0.8, top_k=12, top_p=0.9,
                                                       penalty=1.1)])
def test_first_committed_token_passes_chi_square(target, draft, spkw):
    """2000 slots with seeds 1000.. run one sampled round from the same
    prefilled state (an unrelated draft): the first committed token's
    counts against the JAX target's processed distribution at that
    position (chi-square over bins expecting >= 5, p > 1e-3), all inside
    its support."""
    N = 2000
    prompt = [12, 40, 7, 88, 3, 61]
    tc, dc, first, offsets, ring = _prefilled(target, draft, prompt, N)
    kw = dict(spkw)
    temp = kw.pop("temp")
    # The JAX target's distribution after the committed first token.
    jtc = jl.KVCache.create(CFG, 1, 32, jnp.float32)
    _, jtc = jl.forward(CFG, target[0], jnp.asarray([prompt], jnp.int32), jtc,
                        jnp.zeros(1, jnp.int32))
    h, _ = jl.forward(CFG, target[0], jnp.asarray([[int(first[0])]], jnp.int32), jtc,
                      jnp.asarray([len(prompt)], jnp.int32))
    jsp = JSamplingParams(temperature=jnp.asarray([temp], jnp.float32),
                          top_k=jnp.asarray([kw.get("top_k", 0)], jnp.int32),
                          top_p=jnp.asarray([kw.get("top_p", 1.0)], jnp.float32),
                          repeat_penalty=jnp.asarray([kw.get("penalty", 1.0)], jnp.float32),
                          seed=jnp.asarray([0], jnp.int32))
    p_t = np.asarray(j_processed(jl.logits_from_hidden(CFG, target[0], h[:, 0]), jsp,
                                 jnp.asarray(ring[:1].numpy(), jnp.int32)), np.float64)[0]
    step = make_spec_serving_fn_sampled(TDRAFT, TCFG, GAMMA, eos_id=-1)
    out = step(draft[1], target[1], dc, tc, first, offsets, torch.zeros(N, dtype=torch.bool),
               ring, _sp(N, temp, np.arange(1000, 1000 + N), **kw),
               torch.ones(N, dtype=torch.int64))
    counts = np.bincount(out[2][:, 0].numpy(), minlength=CFG.n_vocab)
    assert np.all(p_t[counts > 0] > 0)
    expected = N * p_t
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    keep = exp > 0
    p = stats.chisquare(obs[keep], exp[keep] * obs[keep].sum() / exp[keep].sum()).pvalue
    assert p > 1e-3, (p, obs, exp)


def test_sampled_round_at_temperature_0_is_the_greedy_round(target, draft):
    tc, dc, first, offsets, ring = _prefilled(target, draft, [5, 9, 31, 2, 77], 1)
    tc2, dc2 = (tl.KVCache([x.clone() for x in c.k], [x.clone() for x in c.v]) for c in (tc, dc))
    g_step = make_spec_serving_fn(TDRAFT, TCFG, GAMMA, eos_id=-1)
    s_step = make_spec_serving_fn_sampled(TDRAFT, TCFG, GAMMA, eos_id=-1)
    sp, counters = _sp(1, 0.0, [3], penalty=1.1), torch.ones(1, dtype=torch.int64)
    done = torch.zeros(1, dtype=torch.bool)
    g_state = (first, offsets, done)
    s_state = (first, offsets, done, ring)
    for _ in range(4):
        _, _, out_g, n_g, off_g, done_g, last_g = g_step(draft[1], target[1], dc, tc, *g_state)
        (_, _, out_s, n_s, off_s, done_s, last_s, ring_s, counters) = s_step(
            draft[1], target[1], dc2, tc2, *s_state, sp, counters)
        assert torch.equal(out_g, out_s) and torch.equal(n_g, n_s)
        g_state, s_state = (last_g, off_g, done_g), (last_s, off_s, done_s, ring_s)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_greedy_slot_beside_a_sampled_one_is_exact(target, draft, kind):
    p1, p2 = [3, 50, 12, 9, 60], [7, 7, 21, 80, 33, 2, 14]
    if kind == "dense":
        jbase = JScheduler(CFG, target[0], sampling=JGREEDY, max_batch=2, max_seq=96)
        spec = Scheduler(TCFG, target[1], sampling=GREEDY, max_batch=2, max_seq=96,
                         cache_dtype=torch.float32, draft_cfg=TDRAFT, draft_params=draft[1],
                         gamma=GAMMA)
    else:
        jbase = JPaged(CFG, target[0], sampling=JGREEDY, max_batch=2, max_seq=96, page_size=16,
                       n_pages=16, cache_dtype=jnp.float32)
        spec = PagedScheduler(TCFG, target[1], sampling=GREEDY, max_batch=2, max_seq=96,
                              page_size=16, n_pages=16, cache_dtype=torch.float32,
                              draft_cfg=TDRAFT, draft_params=draft[1], gamma=GAMMA)
    want = _run(jbase, JRequest, [p1], [10])[0]
    r_g = Request(prompt=p1, max_new_tokens=10, sampling=GREEDY)
    r_s = Request(prompt=p2, max_new_tokens=10, sampling=SamplingConfig(temperature=0.9, seed=5))
    for r in (r_g, r_s):
        spec.submit(r)
    spec.run()
    assert r_g.output == want
    assert r_s.finish_reason in ("eos", "length", "stop") and len(r_s.output) > 0
    assert all(0 <= tok < CFG.n_vocab for tok in r_s.output)


# -- the paged verify forward -------------------------------------------------

VCFG = LlamaConfig.tiny(n_vocab=512, n_ctx=64, n_kv_head=2)  # 4 heads of 64, GQA 2
PS, N_PAGES = 16, 10


def test_forward_paged_verify_matches_jax_on_live_rows():
    """Two live slots at unaligned starts (one block crossing a page
    boundary) and one frozen slot: the live slots' hidden rows and every
    K / V row they wrote agree with the JAX forward_paged_verify."""
    jparams = jl.params_from_ggml(VCFG, make_ggml_weights(VCFG, np.random.default_rng(7)),
                                  dtype=jnp.float32)
    jparams_u, tparams = jl.unstack_params(jparams), tl.params_from_jax(numpy_params(jparams))
    rng = np.random.default_rng(4)
    shape = jp.make_unrolled_pool(VCFG, N_PAGES, PS, jnp.float32)[0][0].shape
    jpool = tuple((jnp.asarray(rng.standard_normal(shape), jnp.float32),
                   jnp.asarray(rng.standard_normal(shape), jnp.float32))
                  for _ in range(VCFG.n_layer))
    tpool = tp.pool_from_jax([(np.asarray(k), np.asarray(v)) for k, v in jpool], "contig")
    table = np.array([[3, 7, 1], [5, 2, 8], [0, 0, 0]], np.int32)
    start = np.array([13, 21, 4], np.int32)
    adv = np.array([1, 1, 0], np.int32)
    toks = rng.integers(3, VCFG.n_vocab, size=(3, 5)).astype(np.int32)
    jh, jpool = jl.forward_paged_verify(VCFG, jparams_u, jnp.asarray(toks), jpool,
                                        jnp.asarray(table), jnp.asarray(start), jnp.asarray(adv))
    th, _ = tl.forward_paged_verify(port_config(VCFG), tparams, t(toks).long(), tpool, t(table),
                                    t(start), t(adv))
    want = np.asarray(jh)[:2]
    np.testing.assert_allclose(th.numpy()[:2], want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    for (k_t, v_t), (k_j, v_j) in zip(zip(tpool.k, tpool.v), jpool):
        for got, ref in ((k_t, k_j), (v_t, v_j)):
            g = tp.gather_pool_payload(got, t(table[:2]), "contig").numpy()
            w = np.asarray(jp.gather_pool_payload(ref, jnp.asarray(table[:2])))
            for b in range(2):
                rows = slice(start[b], start[b] + 5)
                a = g[b].transpose(1, 2, 0, 3).reshape(-1, VCFG.n_kv_head, VCFG.head_dim)[rows]
                e = w[b].transpose(1, 2, 0, 3).reshape(-1, VCFG.n_kv_head, VCFG.head_dim)[rows]
                np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4 * np.abs(e).max())


# -- the entry point ------------------------------------------------------------


def test_entry_point_serves_with_a_draft_model_on_the_cpu(tmp_path):
    """`python -m tokenhawk_tpu_torch.serving --draft-model --paged` on tiny
    ggjt files: /health says speculative, one request streams to its end
    with no step errors."""
    from tokenhawk_tpu_torch.ggml.writer import write_ggml

    root = Path(__file__).resolve().parents[1]
    paths = []
    for cfg, seed in ((LlamaConfig.tiny(n_vocab=300, n_embd=128, n_head=2, n_layer=1, n_ff=256),
                       3),
                      (LlamaConfig.tiny(n_vocab=300, n_embd=64, n_head=2, n_layer=1, n_ff=128),
                       4)):
        tokens, scores = padded_vocab(cfg.n_vocab)
        hp = dict(n_vocab=cfg.n_vocab, n_embd=cfg.n_embd, n_mult=cfg.n_mult, n_head=cfg.n_head,
                  n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=0)
        paths.append(tmp_path / f"m{seed}.bin")
        write_ggml(paths[-1], hp, tokens, scores,
                   make_ggml_weights(cfg, np.random.default_rng(seed)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tokenhawk_tpu_torch.serving", "-m", str(paths[0]),
         "--draft-model", str(paths[1]), "--gamma", "3", "--paged", "--device", "cpu",
         "--dtype", "f32", "--n-ctx", "64", "--page-size", "16", "--port", str(port)],
        cwd=root, env=subprocess_env(PYTHONPATH=str(root)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
                time.sleep(0.5)
        assert health["speculative"] is True and health["paged"] is True
        req = urllib.request.Request(base + "/generate",
                                     data=json.dumps({"prompt": "hi", "max_tokens": 6}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read().decode()
        assert "event: done" in body
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            assert json.loads(r.read())["step_errors"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
