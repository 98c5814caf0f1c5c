"""Ranks of a torch.distributed group on the CPU for the port's context-parallel
tests (tests/test_torch_ring.py, test_torch_cp_engine.py).

`run_ranks` spawns one process a rank, joins them into a gloo group
through a file store in the test's temporary directory (TCP ports would
collide between the suite's workers), runs a worker of this module in
each and returns what each returned.  A group that hangs is killed at
the deadline and fails the test.  This module imports no jax: a spawned
child imports it to find its worker, and sets torch to one thread.
"""

from __future__ import annotations

import pickle
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 90


def _child(fn, rank: int, n: int, store: str, out: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = fn(rank, n, *args)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, n: int, tmp_path, *args, timeout: float = 180.0) -> list:
    """fn(rank, n, *args) in each of n spawned ranks of one gloo group ->
    the list of their results (picklable), rank by rank."""
    ctx = mp.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pkl" for r in range(n)]
    procs = [ctx.Process(target=_child, args=(fn, r, n, str(tmp_path / "store"), str(outs[r]),
                                              args), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        pytest.fail(f"{len(hung)} of {n} ranks still running after {timeout} s: killed")
    codes = [p.exitcode for p in procs]
    if any(codes):
        pytest.fail(f"ranks exited with codes {codes}")
    results = []
    for o in outs:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results


# -- workers (module level, so that a spawned child can import them) ----------


def ring_worker(rank, n, ring, decode):
    """parallel/ring.py on this rank's shards: ring_attention over its rows of
    the whole ring = (q, k, v) [B, H|Hkv, T, Dh] in both layouts (a
    contiguous block, every n-th row), and decode_attend_cp over its block
    of the slots of decode = (q, k, v, lengths), each shard masked at its
    own valid length."""
    from tokenhawk_tpu_torch.parallel.mesh import make_cp_mesh
    from tokenhawk_tpu_torch.parallel.ring import decode_attend_cp, ring_attention

    mesh = make_cp_mesh(cp=n)

    def rows(a, sl):
        return torch.from_numpy(np.ascontiguousarray(a[:, :, sl]))

    T = ring[0].shape[2] // n
    out = {}
    for layout, sl in (("block", slice(rank * T, (rank + 1) * T)),
                       ("cyclic", slice(rank, None, n))):
        out[layout] = ring_attention(*(rows(a, sl) for a in ring), mesh, layout=layout).numpy()
    q, k, v, lengths = decode
    S = k.shape[2] // n
    lo = rank * S
    shard_lengths = torch.from_numpy(np.clip(lengths - lo, 0, S).astype(np.int32))
    out["decode"] = decode_attend_cp(torch.from_numpy(q), rows(k, slice(lo, lo + S)),
                                     rows(v, slice(lo, lo + S)), shard_lengths, mesh).numpy()
    return out


def engine_worker(rank, n, np_params, cfg_fields, runs, cache_prompt):
    """Engine(parallel="cp") over the port's copy of a JAX model (numpy
    params, f32 cache): the tokens it generates for each (prompt,
    max_new_tokens, temperature, seed) of `runs`, and this rank's layer
    caches [(k, v), ...] after the prefill of `cache_prompt`."""
    from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
    from tokenhawk_tpu_torch.models.llama import fuse_params, params_from_jax
    from tokenhawk_tpu_torch.parallel.mesh import make_cp_mesh
    from tokenhawk_tpu_torch.runtime.engine import Engine

    cfg = LlamaConfig(**cfg_fields)
    params = fuse_params(params_from_jax(np_params))
    mesh = make_cp_mesh(cp=n)

    def engine(temp=0.0, seed=0):
        return Engine(cfg, params, sampling=SamplingConfig(temperature=temp, seed=seed),
                      cache_dtype=torch.float32, decode_chunk=4, mesh=mesh, parallel="cp")

    tokens = [engine(temp, seed).generate(prompt, max_new_tokens=n_new).tokens
              for prompt, n_new, temp, seed in runs]
    eng = engine()
    cache, _, _ = eng.prefill(eng.new_cache(1), [cache_prompt])
    return tokens, cache.layers()
