"""The rank body of the port's tensor-parallel tests (tests/test_torch_tp.py,
test_torch_tp_paged.py, test_torch_sharded_loader.py).

`tp_worker` runs in every rank of a gloo group that tests/torch_dist.py
`run_ranks` spawns: it builds the port's whole models from numpy (the
JAX package's parameters through params_from_jax), keeps its shard
(parallel/tp.py shard_params_tp, then the per-shard fusion) and runs a
list of jobs over the model axis, returning what each produced.  This
module imports no jax: a spawned child imports it to find its worker.
"""

from __future__ import annotations

import numpy as np
import torch


def _sampling(fields):
    from tokenhawk_tpu_torch.config import SamplingConfig

    return None if fields is None else SamplingConfig(**fields)


def run_requests(sched, prompts, n_new, samplings=None):
    """Submit one request a prompt (with its SamplingConfig, or the
    scheduler's), run to the end -> each request's output."""
    from tokenhawk_tpu_torch.runtime.scheduler import Request

    samplings = samplings or [None] * len(prompts)
    reqs = [Request(prompt=list(p), max_new_tokens=n_new, sampling=sc)
            for p, sc in zip(prompts, samplings)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [r.output for r in reqs]


def build_model(cfg_fields, np_params, mesh=None):
    """(config, params) of the port from numpy; this rank's fused shard
    under `mesh`, the whole fused model without."""
    from tokenhawk_tpu_torch.config import LlamaConfig
    from tokenhawk_tpu_torch.models.llama import fuse_params, params_from_jax
    from tokenhawk_tpu_torch.parallel.tp import shard_params_tp

    cfg = LlamaConfig(**cfg_fields)
    params = params_from_jax(np_params)
    if mesh is not None:
        params = shard_params_tp(cfg, params, mesh)
    return cfg, fuse_params(params)


def run_job(job, models, mesh):
    """One job over `models` {name: (cfg, params)} (shards under `mesh`):
      ("prefill", model, tokens [B, T], lengths [B]) -> logits [B, V];
      ("engine", model, prompt, n_new, sampling fields) -> tokens;
      ("sched", model, kind "dense" | "paged", prompts, n_new,
       [sampling fields a prompt] | None, scheduler kwargs, draft model |
       None, rounds) -> [outputs of each round], prefix hits."""
    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.models.llama import KVCache
    from tokenhawk_tpu_torch.runtime.engine import Engine, make_prefill_fn
    from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu_torch.runtime.scheduler import Scheduler

    what, name = job[0], job[1]
    cfg, params = models[name]
    tp_kw = dict(mesh=mesh) if mesh is not None else {}
    if what == "prefill":
        tokens, lengths = (torch.from_numpy(np.asarray(a)) for a in job[2:4])
        if mesh is not None:
            from tokenhawk_tpu_torch.parallel.tp import local_config, make_tp_prefill_fn

            fn, ccfg = make_tp_prefill_fn(cfg, mesh), local_config(cfg, mesh.tp)
        else:
            fn, ccfg = make_prefill_fn(cfg), cfg
        cache = KVCache.create(ccfg, tokens.shape[0], cfg.n_ctx, torch.float32)
        _, logits = fn(params, cache, tokens, lengths.to(torch.int32),
                       torch.zeros_like(lengths, dtype=torch.int32))
        return logits.numpy()
    if what == "engine":
        prompt, n_new, sampling = job[2:]
        eng = Engine(cfg, params, sampling=SamplingConfig(**sampling),
                     cache_dtype=torch.float32, decode_chunk=4,
                     parallel="tp" if mesh is not None else None, **tp_kw)
        return eng.generate(prompt, max_new_tokens=n_new).tokens
    kind, prompts, n_new, samplings, kw, draft, rounds = job[2:]
    kw = dict(kw)
    kw.setdefault("cache_dtype", torch.float32)
    if draft is not None:
        kw.update(draft_cfg=models[draft][0], draft_params=models[draft][1])
    cls = PagedScheduler if kind == "paged" else Scheduler
    sched = cls(cfg, params, sampling=SamplingConfig(temperature=0.0), max_batch=2,
                decode_chunk=4, **tp_kw, **kw)
    samplings = None if samplings is None else [_sampling(f) for f in samplings]
    outs = [run_requests(sched, prompts, n_new, samplings) for _ in range(rounds)]
    return outs, getattr(sched, "prefix_hits", 0)


def tp_worker(rank, n, models, jobs, draft_names=()):
    """Every job of `jobs` on this rank's shards of `models` {name:
    (config fields, numpy params)}; models named in draft_names stay
    whole on every rank (a speculative draft)."""
    from tokenhawk_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tp=n)
    built = {name: build_model(f, p, None if name in draft_names else mesh)
             for name, (f, p) in models.items()}
    return [run_job(job, built, mesh) for job in jobs]


def sharded_engine_worker(rank, n, path, prompt, n_new):
    """runtime/sharded_loader.py load_model_sharded of this rank's shard
    (float32) and Engine(parallel="tp") greedy over it -> its tokens."""
    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.parallel.mesh import make_mesh
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.runtime.sharded_loader import load_model_sharded

    mesh = make_mesh(tp=n)
    cfg, params, tok, _ = load_model_sharded(path, mesh, n_ctx=64, dtype=torch.float32,
                                             device="cpu", scale_dtype=torch.float32)
    eng = Engine(cfg, params, tok, sampling=SamplingConfig(temperature=0.0),
                 cache_dtype=torch.float32, decode_chunk=4, mesh=mesh, parallel="tp")
    return eng.generate(prompt, max_new_tokens=n_new).tokens


def lockstep_worker(rank, n, cfg_fields, np_params, first, late, n_new):
    """parallel/multihost_serving.py over the group: every rank a TP
    PagedScheduler and a driver whose packets go over gloo (group_broadcast);
    rank 0 submits `first`, then `late` after two rounds, runs to idle and
    sends the stop round; the others follow.  -> every finished request's
    (prompt, output), in finishing order."""
    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.parallel.mesh import make_mesh
    from tokenhawk_tpu_torch.parallel.multihost_serving import MultihostServingDriver
    from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu_torch.runtime.scheduler import Request

    mesh = make_mesh(tp=n)
    cfg, params = build_model(cfg_fields, np_params, mesh)
    sched = PagedScheduler(cfg, params, sampling=SamplingConfig(temperature=0.0), max_batch=2,
                           page_size=16, n_pages=24, decode_chunk=4, cache_dtype=torch.float32,
                           mesh=mesh)
    drv = MultihostServingDriver(sched)
    assert drv.is_coordinator == (rank == 0)
    if drv.is_coordinator:
        drv.submit(Request(prompt=first, max_new_tokens=n_new))
        rounds = 0
        while drv.has_work:
            drv.step()
            rounds += 1
            if rounds == 2:
                drv.submit(Request(prompt=late, max_new_tokens=n_new))
        drv.step(stop=True)
    else:
        drv.run()
    return [(r.prompt, r.output) for r in sched.finished]


def failing_follower_worker(rank, n, cfg_fields, np_params):
    """A lockstep group whose follower fails: every rank a TP PagedScheduler
    and a driver over gloo; rank 0 steps one request through its
    LockstepScheduler, the others `follow`, and their scheduler raises in
    its second round.  -> rank 0: ("failed" | "finished", rounds stepped
    before); the others: follow()'s exit code."""
    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.parallel.mesh import make_mesh
    from tokenhawk_tpu_torch.parallel.multihost_serving import (
        LockstepScheduler,
        MultihostServingDriver,
        follow,
    )
    from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu_torch.runtime.scheduler import Request

    mesh = make_mesh(tp=n)
    cfg, params = build_model(cfg_fields, np_params, mesh)
    sched = PagedScheduler(cfg, params, sampling=SamplingConfig(temperature=0.0), max_batch=2,
                           page_size=16, n_pages=24, decode_chunk=4, cache_dtype=torch.float32,
                           mesh=mesh)
    drv = MultihostServingDriver(sched)
    if rank == 0:
        front = LockstepScheduler(drv)
        front.submit(Request(prompt=[5, 9, 13, 2, 7], max_new_tokens=40))
        rounds = 0
        try:
            while front.has_work:
                front.step()
                rounds += 1
        except Exception:
            return "failed", rounds
        return "finished", rounds
    calls = []
    real_step = sched.step

    def step():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected device fault")
        real_step()

    sched.step = step
    return follow(drv)
