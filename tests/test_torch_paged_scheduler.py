"""The port's continuous-batching schedulers against the JAX package's.

Both packages get the same f32 weights (the JAX params_from_ggml of
make_ggml_weights, carried over with params_from_jax) and the same
requests; greedy outputs must be identical token for token:
  - the port's PagedScheduler, in both pool layouts, against the JAX
    PagedScheduler: more requests than slots, pool pressure, chunked
    prefill, the prefix cache (with chunked prefill, and the same-step
    cold-prefix leader), batched admissions, and a randomized workload
    with a cancel;
  - the port's dense Scheduler against the JAX Scheduler, sessions too.
The JAX side runs its CPU path (XLA).  Sampled requests cannot match the
reference's jax.random draws; they are held to their own reproducibility:
the same tokens alone and inside a mixed batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler as JPaged
from tokenhawk_tpu.runtime.scheduler import Request as JRequest
from tokenhawk_tpu.runtime.scheduler import Scheduler as JDense
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.models.llama import params_from_jax
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Request, Scheduler

from helpers import make_ggml_weights
from torch_helpers import numpy_params, port_config

CFG = LlamaConfig.tiny(n_vocab=512, n_ctx=64)
TCFG = port_config(CFG)
LAYOUTS = ["contig", "head"]
KW = dict(decode_chunk=4, page_size=16)


@pytest.fixture(scope="module")
def params():
    jparams = params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(77)),
                               dtype=jnp.float32)
    return jparams, params_from_jax(numpy_params(jparams))


def _jax_paged(jparams, prompts, n, **kw):
    s = JPaged(CFG, jparams, sampling=SamplingConfig(temperature=0.0),
               cache_dtype=jnp.float32, **KW, **kw)
    return [r.output for r in s.generate_many(prompts, max_new_tokens=n)]


def _paged(tparams, layout, **kw):
    return PagedScheduler(TCFG, tparams, sampling=TSamplingConfig(temperature=0.0),
                          cache_dtype=torch.float32, layout=layout, **KW, **kw)


def _rand_prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[1] + rng.integers(3, 500, n - 1).tolist() for n in lens]


# Scenarios: (prompts, new tokens, scheduler options).  Every one runs
# once on the JAX PagedScheduler and in both layouts on the port's.
SCENARIOS = {
    "two_prompts": ([[1, 5, 9, 13], [1, 30, 60, 90, 120, 150]], 8, dict(max_batch=2)),
    "more_requests_than_slots": ([[1, i + 3, i + 9] for i in range(6)], 5,
                                 dict(max_batch=2, n_pages=12)),
    "pool_pressure": ([[1, 7, 21], [1, 2, 3]], 4, dict(max_batch=2, n_pages=4)),
    "chunked_prefill": (_rand_prompts(21, [41]) + [[1, 5, 9]], 6,
                        dict(max_batch=2, prefill_chunk=16)),
    "batched_admission": ([[1, 5, 9, 13], [1, 30, 60, 90, 120], [1, 4, 4, 8],
                           [1, 2, 3, 4, 5, 6, 7]], 6, dict(max_batch=4, n_pages=24)),
    "shared_cold_prefix": ([[1] + list(range(3, 34)) + [200 + i, 99] for i in range(4)], 5,
                           dict(max_batch=4, n_pages=40, prefix_cache=True)),
    "prefix_cache_chunked": (_rand_prompts(34, [61]) * 2, 6,
                             dict(max_batch=1, n_pages=16, prefix_cache=True,
                                  prefill_chunk=32)),
}


@pytest.fixture(scope="module")
def jax_outputs(params):
    jparams, _ = params
    return {name: _jax_paged(jparams, prompts, n, **kw)
            for name, (prompts, n, kw) in SCENARIOS.items()}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_scheduler_matches_jax(params, jax_outputs, name, layout):
    prompts, n, kw = SCENARIOS[name]
    s = _paged(params[1], layout, **kw)
    got = [r.output for r in s.generate_many(prompts, max_new_tokens=n)]
    assert got == jax_outputs[name]
    # No page leaks: every page is back in the pool or parked in the
    # prefix cache at refcount 0; only the trash page stays out.
    assert s.alloc.n_free + len(set(s._pc.values())) == s.n_pages - 1
    assert all(s.page_refs.get(p, 0) == 0 for p in s._pc.values())
    if name == "shared_cold_prefix":
        assert s.prefix_hits == 6  # 3 followers x the leader's 2 pages
    if name == "prefix_cache_chunked":
        assert s.prefix_hits == 3  # the second prompt reuses floor(60/16) pages


def test_randomized_workload_with_cancel_matches_jax(params):
    """Random prompt lengths (some chunk-prefilled, some sharing a prefix),
    staggered arrivals and a mid-flight cancel, on both sides; completed
    requests identical, the cancelled one a clean prefix."""
    jparams, tparams = params
    rng = np.random.default_rng(100)
    shared = [1] + rng.integers(3, 500, 31).tolist()
    prompts = []
    for _ in range(8):
        kind = rng.integers(0, 3)
        if kind == 0:
            prompts.append([1] + rng.integers(3, 500, int(rng.integers(2, 12))).tolist())
        elif kind == 1:
            prompts.append([1] + rng.integers(3, 500, int(rng.integers(20, 44))).tolist())
        else:
            prompts.append(shared + rng.integers(3, 500, int(rng.integers(2, 10))).tolist())
    arrivals = rng.integers(0, 3, 64).tolist()
    kw = dict(max_batch=3, n_pages=40, prefill_chunk=16, prefix_cache=True)

    def drive(s, make_request):
        reqs = [make_request(p) for p in prompts]
        pending, steps = list(reqs), 0
        while s.has_work or pending:
            for _ in range(arrivals[steps % len(arrivals)]):
                if pending:
                    s.submit(pending.pop(0))
            steps += 1
            if steps == 3:
                victim = next((r for r in reqs if r.finish_reason == ""), None)
                if victim is not None:
                    s.cancel(victim)
            s.step()
        return [(r.output, r.finish_reason) for r in reqs]

    want = drive(JPaged(CFG, jparams, sampling=SamplingConfig(temperature=0.0),
                        cache_dtype=jnp.float32, **KW, **kw),
                 lambda p: JRequest(prompt=p, max_new_tokens=6))
    s = _paged(tparams, "contig", **kw)
    got = drive(s, lambda p: Request(prompt=p, max_new_tokens=6))
    assert got == want
    assert s.alloc.n_free + len(set(s._pc.values())) == 40 - 1


def test_infeasible_request_and_starved_chunking_fail_with_oom(params):
    tparams = params[1]
    s = _paged(tparams, "contig", max_batch=1, n_pages=3)  # 1 trash + 2 free
    r = Request(prompt=list(range(3, 43)), max_new_tokens=4)  # needs 4 pages
    s.submit(r)
    for _ in range(5):
        if s.has_work:
            s.step()
    assert not s.has_work and r.finish_reason == "oom_pages"

    # Two chunking slots that can never both fit: the larger gives up.
    rng = np.random.default_rng(42)
    feasible = [1] + rng.integers(3, 500, 44).tolist()  # 3 pages
    infeasible = [1] + rng.integers(3, 500, 120).tolist()  # 8 pages > pool
    s = _paged(tparams, "head", max_batch=2, n_pages=5, prefill_chunk=16, max_seq=256)
    rf, ri = Request(prompt=feasible, max_new_tokens=4), Request(prompt=infeasible,
                                                                 max_new_tokens=4)
    s.submit(rf)
    s.submit(ri)
    for _ in range(300):
        if not s.has_work:
            break
        s.step()
    assert not s.has_work
    assert ri.finish_reason == "oom_pages" and rf.finish_reason in ("eos", "length")


def test_cancel_mid_chunking_and_reset_device_state(params):
    tparams = params[1]
    s = _paged(tparams, "contig", max_batch=2, prefill_chunk=16)
    short = Request(prompt=[1, 5, 9], max_new_tokens=32)
    s.submit(short)
    s.step()
    long = Request(prompt=_rand_prompts(3, [45])[0], max_new_tokens=4)
    s.submit(long)
    s.step()  # long claims a slot and prefills its first chunk; short decodes on
    assert s.n_chunking == 1 and len(short.output) > 1
    assert s.cancel(long) and long.finish_reason == "cancelled"
    assert s.n_chunking == 0
    s.cancel(short)
    assert s.alloc.n_free == s.n_pages - 1
    s.reset_device_state()
    assert not s.has_work and s.alloc.n_free == s.n_pages - 1
    assert bool(s.done.all()) and s.cache.layout == "contig"
    [r] = s.generate_many([[1, 5, 9]], max_new_tokens=3)
    assert r.finish_reason == "length" and len(r.output) == 3


def test_unported_options_raise(params):
    """Tensor-parallel serving is refused with its ROADMAP item, with or
    without a draft; speculation refuses int8 pages (as the reference's)
    and a draft without its config; int8 pages are served
    (tests/test_torch_paged_int8.py), while the dense Scheduler refuses an
    int8 cache (the reference's would truncate bf16 K/V into int8, ROADMAP
    Queue 3)."""
    tparams = params[1]
    for kw in (dict(cache_dtype="int8", mesh=object()), dict(mesh=object()),
               dict(mesh=object(), draft_cfg=TCFG, draft_params=tparams)):
        with pytest.raises(NotImplementedError, match="item 8"):
            PagedScheduler(TCFG, tparams, **kw)
    with pytest.raises(ValueError, match="bf16 pages"):
        PagedScheduler(TCFG, tparams, cache_dtype="int8", draft_cfg=TCFG, draft_params=tparams)
    with pytest.raises(ValueError):
        PagedScheduler(TCFG, tparams, page_size=16, prefill_chunk=20)
    for cls in (PagedScheduler, Scheduler):
        with pytest.raises(ValueError, match="draft_cfg"):
            cls(TCFG, tparams, draft_params=tparams)
    assert PagedScheduler(TCFG, tparams, cache_dtype="int8", **KW).cache.quant
    for kv in ("int8", "auto"):
        with pytest.raises(ValueError, match="PagedScheduler"):
            Scheduler(TCFG, tparams, cache_dtype=kv)


def _mixed_requests():
    return [Request(prompt=[1, 9, 17], max_new_tokens=6),  # the scheduler's greedy default
            Request(prompt=[1, 33, 65], max_new_tokens=6,
                    sampling=TSamplingConfig(temperature=0.9, top_k=13, seed=5)),
            Request(prompt=[1, 8, 21], max_new_tokens=6,
                    sampling=TSamplingConfig(temperature=0.7, top_p=0.8, seed=11))]


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_sampled_request_is_the_same_alone_and_in_a_batch(params, kind):
    """A seeded sampled request draws from its own (seed, counter) stream:
    the same tokens admitted in one batch with others, or alone."""
    tparams = params[1]

    def make():
        if kind == "paged":
            return _paged(tparams, "contig", max_batch=4, n_pages=24)
        return Scheduler(TCFG, tparams, sampling=TSamplingConfig(temperature=0.0),
                         max_batch=4, cache_dtype=torch.float32, decode_chunk=4)

    s = make()
    batched = _mixed_requests()
    for r in batched:
        s.submit(r)
    s.run()
    alone = []
    for r in _mixed_requests():
        s = make()
        s.submit(r)
        s.run()
        alone.append(r.output)
    assert [r.output for r in batched] == alone
    assert batched[1].output != batched[2].output


# ---------------------------------------------------------------------------
# The dense Scheduler
# ---------------------------------------------------------------------------


def _jax_dense(jparams, **kw):
    return JDense(CFG, jparams, sampling=SamplingConfig(temperature=0.0),
                  cache_dtype=jnp.float32, decode_chunk=4, **kw)


def _dense(tparams, **kw):
    return Scheduler(TCFG, tparams, sampling=TSamplingConfig(temperature=0.0),
                     cache_dtype=torch.float32, decode_chunk=4, **kw)


def test_dense_scheduler_matches_jax(params):
    jparams, tparams = params
    prompts = [[1, 5, 9, 13], [1, 30, 60, 90, 120, 150]] + [[1, i + 3, i + 9] for i in range(4)]
    want = [r.output for r in _jax_dense(jparams, max_batch=2).generate_many(prompts, 7)]
    got = [r.output for r in _dense(tparams, max_batch=2).generate_many(prompts, 7)]
    assert got == want
    got = [r.output for r in _dense(tparams, max_batch=4).generate_many(prompts, 7)]
    assert got == want  # batched admissions, padded to a power of two


def test_dense_sessions_match_jax(params):
    """Two turns of one session (the second prefills only its new tokens
    into the pinned stripe) and a reset, on both sides."""
    jparams, tparams = params

    def run(s, make_request):
        outs = []
        for prompt in ([1, 5, 9, 13], [40, 41, 42]):
            r = make_request(prompt)
            s.submit(r)
            s.run()
            outs.append((r.output, r.n_past0, r.finish_reason))
        s.reset_session("chat")
        r = make_request([1, 5, 9, 13])
        s.submit(r)
        s.run()
        return outs + [(r.output, r.n_past0, r.finish_reason)]

    want = run(_jax_dense(jparams, max_batch=2),
               lambda p: JRequest(prompt=p, max_new_tokens=6, session="chat"))
    got = run(_dense(tparams, max_batch=2),
              lambda p: Request(prompt=p, max_new_tokens=6, session="chat"))
    assert got == want
    assert got[1][1] > 0 and got[2][1] == 0
