"""Greedy speculative serving in the port's schedulers, against the JAX package.

On the fixtures of tests/test_spec_scheduler.py and test_spec_paged.py (a
2-layer f32 target of head dim 32 and a 1-layer draft of head dim 16, JAX
init_params converted with params_from_jax): greedy streams of the dense
Scheduler and the PagedScheduler with a draft (seeds 0 and 7, and the
target as its own draft) equal the JAX speculative schedulers' streams,
which equal plain greedy decoding; the paged one also with the prefix
cache and chunked prefill, the dense one across a two-turn session.
Sampled speculation, the paged verify forward and the entry point are in
tests/test_torch_spec_sampling.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.config import SamplingConfig as JSamplingConfig
from tokenhawk_tpu.models import llama as jl
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler as JPaged
from tokenhawk_tpu.runtime.scheduler import Request as JRequest
from tokenhawk_tpu.runtime.scheduler import Scheduler as JScheduler
from tokenhawk_tpu_torch.config import SamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Request, Scheduler

from torch_helpers import numpy_params, port_config

CFG = LlamaConfig(n_vocab=97, n_embd=64, n_head=2, n_layer=2, n_ctx=96, n_ff=96)
DRAFT_CFG = LlamaConfig(n_vocab=97, n_embd=32, n_head=2, n_layer=1, n_ctx=96, n_ff=48)
TCFG, TDRAFT = port_config(CFG), port_config(DRAFT_CFG)
GREEDY = SamplingConfig(temperature=0.0)
JGREEDY = JSamplingConfig(temperature=0.0)
PROMPTS = [[1, 5, 9, 13, 17], [1, 30, 60], [4, 8, 15, 16, 23, 42, 7]]
MAX_NEW = (12, 7, 15)


def _params(cfg, seed):
    jparams = jl.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return jparams, tl.params_from_jax(numpy_params(jparams))


@pytest.fixture(scope="module")
def target():
    return _params(CFG, 0)


@pytest.fixture(scope="module")
def drafts():
    return {seed: _params(DRAFT_CFG, seed) for seed in (0, 7)}


def _run(sched, req_cls, prompts=PROMPTS, max_new=MAX_NEW):
    reqs = [req_cls(prompt=list(p), max_new_tokens=m) for p, m in zip(prompts, max_new)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [r.output for r in reqs]


def _dense_pair(target, draft, draft_cfg, gamma):
    kw = dict(max_batch=2, max_seq=96)
    return (JScheduler(CFG, target[0], sampling=JGREEDY, draft_cfg=draft_cfg,
                       draft_params=draft[0], gamma=gamma, **kw),
            Scheduler(TCFG, target[1], sampling=GREEDY, cache_dtype=torch.float32,
                      draft_cfg=port_config(draft_cfg), draft_params=draft[1], gamma=gamma,
                      **kw))


@pytest.mark.parametrize("draft_seed", [0, 7, "target"])
def test_dense_scheduler_streams_match_jax(target, drafts, draft_seed):
    if draft_seed == "target":
        draft, draft_cfg, gamma = target, CFG, 4
    else:
        draft, draft_cfg, gamma = drafts[draft_seed], DRAFT_CFG, 3
    jsched, sched = _dense_pair(target, draft, draft_cfg, gamma)
    want = _run(jsched, JRequest)
    assert _run(sched, Request) == want
    plain = Scheduler(TCFG, target[1], sampling=GREEDY, max_batch=2, max_seq=96,
                      cache_dtype=torch.float32)
    assert _run(plain, Request) == want


def test_dense_scheduler_session_turns_match_jax(target, drafts):
    """A two-turn session continues both caches (target and draft stripes)."""
    rng = np.random.default_rng(0)
    turns = [rng.integers(3, CFG.n_vocab, 5).tolist(), rng.integers(3, CFG.n_vocab, 4).tolist()]
    outs = []
    for sched, req_cls in zip(_dense_pair(target, _params(DRAFT_CFG, 3), DRAFT_CFG, 3),
                              (JRequest, Request)):
        got = []
        for prompt in turns:
            r = req_cls(prompt=prompt, max_new_tokens=6, session="s1")
            sched.submit(r)
            sched.run()
            got.append(r.output)
        outs.append(got)
    assert outs[1] == outs[0] and all(len(o) == 6 for o in outs[0])


def _paged_pair(target, draft, gamma, **extra):
    kw = dict(max_batch=2, max_seq=96, page_size=16, n_pages=24, decode_chunk=4, **extra)
    return (JPaged(CFG, target[0], sampling=JGREEDY, cache_dtype=jnp.float32,
                   draft_cfg=DRAFT_CFG, draft_params=draft[0], gamma=gamma, **kw),
            PagedScheduler(TCFG, target[1], sampling=GREEDY, cache_dtype=torch.float32,
                           draft_cfg=TDRAFT, draft_params=draft[1], gamma=gamma, **kw))


@pytest.mark.parametrize("draft_seed", [0, 7])
def test_paged_scheduler_streams_match_jax(target, drafts, draft_seed):
    jsched, sched = _paged_pair(target, drafts[draft_seed], 3)
    want = _run(jsched, JRequest)
    assert _run(sched, Request) == want
    assert sched.alloc.n_free == sched.n_pages - 1  # every page back but the trash page


def test_paged_spec_with_prefix_cache_and_chunked_prefill(target, drafts):
    long_prompt = list(range(3, 44))  # 41 tokens: chunks of 16, 2 cacheable pages
    prompts, max_new = [long_prompt, [1, 5, 9]], (12, 7)
    jsched, sched = _paged_pair(target, drafts[0], 3, prefix_cache=True, prefill_chunk=16)
    want = _run(jsched, JRequest, prompts, max_new)
    assert _run(sched, Request, prompts, max_new) == want
    assert _run(sched, Request, prompts, max_new) == want
    assert sched.prefix_hits >= 2


def test_paged_spec_refuses_int8_pages_and_vocab_mismatch(target, drafts):
    with pytest.raises(ValueError, match="bf16 pages"):
        PagedScheduler(TCFG, target[1], cache_dtype="int8", draft_cfg=TDRAFT,
                       draft_params=drafts[0][1])
    other = port_config(LlamaConfig(n_vocab=90, n_embd=32, n_head=2, n_layer=1, n_ff=48))
    for cls in (Scheduler, PagedScheduler):
        with pytest.raises(ValueError, match="vocab"):
            cls(TCFG, target[1], cache_dtype=torch.float32, draft_cfg=other,
                draft_params=drafts[0][1])
