"""The port's int8 paged KV pool against the JAX package.

Kernels 10-12 (ops/cuda/paged_int8.py) through their plain versions, and
the int8 layer ops of runtime/paged.py, on the same numpy inputs as the
JAX package, every case in both pool layouts (the JAX side's set through
THAWK_POOL_LAYOUT):
  - the int8 append (kernel 11), codes and scales, and the fragment
    paginations exactly against append_token_layer_int8 and
    paginate_fragment_layer_int8(_at);
  - the dequantizing gather (kernel 12) exactly against
    gather_pages_dense_int8 (interpret mode) followed by its caller's
    multiply;
  - paged decode (kernel 10) at atol 3e-5, rtol 1e-4 against JAX's XLA
    fallback (f32 attention over the same dequantized pages, another
    summation order), and within 3e-2 of the Pallas walk and grid kernels
    in interpret mode (they also quantize the query and the
    probabilities, as the JAX package's own test allows);
  - the three paged forwards on an int8 pool against JAX's: hidden states
    at rtol 1e-4 and an atol of 1e-4 of the largest value, live K / V rows
    dequantized within one code step (f32 projections summed in another
    order may move a value across a rounding boundary);
  - PagedScheduler(cache_dtype="int8"): greedy tokens identical to JAX's;
  - pool_from_jax for int8 pools;
  - `python -m tokenhawk_tpu_torch.serving --paged --kv int8 --device cpu`.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models import llama as jl
from tokenhawk_tpu.ops.kvquant import quantize_kv_block as j_quantize
from tokenhawk_tpu.ops.pallas.paged_decode import gather_pages_dense_int8
from tokenhawk_tpu.ops.pallas.paged_decode_int8 import (
    paged_flash_decode_int8,
    paged_flash_decode_int8_walk,
)
from tokenhawk_tpu.runtime import paged as jp
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler as JPaged
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pik
from tokenhawk_tpu_torch.runtime import paged as tp
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler

from helpers import make_ggml_weights
from torch_helpers import numpy_params, padded_vocab, port_config, t

LAYOUTS = ["contig", "head"]
DH = 128


def _pools(layout, monkeypatch, cfg, n_pages, ps, seed=4):
    """A JAX unrolled int8 pool made in `layout`, filled with quantized
    random rows, and the port's copy of it."""
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    rng = np.random.default_rng(seed)
    shape = jp.make_unrolled_quant_pool(cfg, n_pages, ps)[0][0].shape

    def filled():
        q, s = j_quantize(jnp.asarray(rng.standard_normal(shape), jnp.float32))
        return q, s.astype(jnp.float32)

    jpool = tuple(filled() + filled() for _ in range(cfg.n_layer))  # (k, ks, v, vs)
    return jpool, tp.pool_from_jax([tuple(map(np.asarray, lc)) for lc in jpool], layout)


def _page(a, layout, p):
    return a[p] if layout == "contig" else a[:, p]


def _assert_pages_equal(got, want, layout, n_pages, skip=()):
    got, want = got.numpy(), np.asarray(want)
    for p in range(n_pages):
        if p not in skip:
            np.testing.assert_array_equal(_page(got, layout, p), _page(want, layout, p))


KCFG = LlamaConfig.tiny(n_layer=1, n_embd=512, n_head=8, n_kv_head=4)  # head dim 64, GQA 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_append_and_paginate_match_jax_exactly(layout, monkeypatch):
    ps, n_pages = 16, 8
    jpool, tpool = _pools(layout, monkeypatch, KCFG, n_pages, ps)
    k_j, ks_j, v_j, vs_j = jpool[0]
    rng = np.random.default_rng(8)
    Hkv, Dh = KCFG.n_kv_head, KCFG.head_dim
    table = np.array([[3, 7, 1], [5, 2, 6]], np.int32)
    pos = np.array([ps + 4, 2], np.int32)
    kn, vn = (rng.standard_normal((2, Hkv, Dh)).astype(np.float32) for _ in range(2))
    k_j, ks_j = jp.append_token_layer_int8(k_j, ks_j, jnp.asarray(kn), jnp.asarray(table),
                                           jnp.asarray(pos))
    v_j, vs_j = jp.append_token_layer_int8(v_j, vs_j, jnp.asarray(vn), jnp.asarray(table),
                                           jnp.asarray(pos))
    tp.append_token_layer_int8(*tpool.layers()[0], t(kn), t(vn), t(table), t(pos), layout)
    frag = rng.standard_normal((2, Hkv, 20, Dh)).astype(np.float32)  # 2 pages, the last short
    start = np.array([0, 1], np.int32)
    k_j, ks_j = jp.paginate_fragment_layer_int8_at(k_j, ks_j, jnp.asarray(frag),
                                                   jnp.asarray(table), jnp.asarray(start))
    tp.paginate_fragment_layer_int8_at(tpool.k[0], tpool.ks[0], t(frag), t(table), t(start),
                                       layout)
    frag0 = rng.standard_normal((2, Hkv, ps + 3, Dh)).astype(np.float32)
    v_j, vs_j = jp.paginate_fragment_layer_int8(v_j, vs_j, jnp.asarray(frag0),
                                                jnp.asarray(table[:, 1:]))
    tp.paginate_fragment_layer_int8(tpool.v[0], tpool.vs[0], t(frag0), t(table[:, 1:]), layout)
    for got, want in zip(tpool.layers()[0], (k_j, ks_j, v_j, vs_j)):
        _assert_pages_equal(got, want, layout, n_pages)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gather_plain_matches_jax_kernel_and_its_dequant(layout, monkeypatch):
    ps, n_pages, B, mp = 16, 9, 3, 4
    jpool, tpool = _pools(layout, monkeypatch, KCFG, n_pages, ps)
    table = np.random.default_rng(5).integers(0, n_pages, (B, mp)).astype(np.int32)
    kq, ksq, vq, vsq = gather_pages_dense_int8(*jpool[0], jnp.asarray(table),
                                               contig=layout == "contig", interpret=True)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = pik.gather_pages_int8(*tpool.layers()[0], t(table), layout, dtype)
        for g, (c, s) in zip(got, ((kq, ksq), (vq, vsq))):
            want = c.astype(jdtype) * s[..., None].astype(jdtype)
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(want.astype(jnp.float32)))
    want = jp.gather_pool_scales(jpool[0][1], jnp.asarray(table))
    np.testing.assert_array_equal(pik.gather_pool_scales(tpool.ks[0], t(table), layout).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("Hkv,rep", [(4, 1), (2, 2)])
def test_paged_decode_plain_matches_jax(layout, Hkv, rep, monkeypatch):
    cfg = LlamaConfig.tiny(n_layer=1, n_embd=4 * DH, n_head=4, n_kv_head=Hkv)
    ps, n_pages, B = 128, 6, 3
    jpool, tpool = _pools(layout, monkeypatch, cfg, n_pages, ps, seed=Hkv)
    table = np.array([[5, 2], [1, 3], [4, 0]], np.int32)
    lengths = np.array([ps + 40, 70, 1], np.int32)  # across a boundary, length 1
    rng = np.random.default_rng(rep)
    q = rng.standard_normal((B, 1, 4, DH)).astype(np.float32)
    want = np.asarray(jp.attend_paged_layer_int8(jnp.asarray(q), *jpool[0], jnp.asarray(table),
                                                 jnp.asarray(lengths)))
    got = tp.attend_paged_layer_int8(t(q), *tpool.layers()[0], t(table), t(lengths),
                                     layout).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    qg = jnp.asarray((q[:, 0] / DH**0.5).reshape(B, Hkv, rep, DH))
    for fn in (paged_flash_decode_int8, paged_flash_decode_int8_walk):
        pallas = np.asarray(fn(qg, *jpool[0], jnp.asarray(table), jnp.asarray(lengths),
                               contig=layout == "contig", interpret=True))
        np.testing.assert_allclose(got, pallas.reshape(B, 1, 4, DH), atol=3e-2, rtol=3e-2)


def test_plain_versions_length_zero_bad_ids_and_no_launch_on_the_cpu(monkeypatch):
    _, tpool = _pools("head", monkeypatch, KCFG, 4, 16)
    lc = tpool.layers()[0]
    before = dict(pik.launches)
    q = torch.randn(2, KCFG.n_kv_head, 2, KCFG.head_dim)
    out = pik.paged_decode_int8(q, *lc, t([[1, 2], [3, 0]], torch.int32),
                                t([0, 5], torch.int32), "head")
    assert torch.equal(out[0], torch.zeros_like(out[0])) and bool(torch.isfinite(out).all())
    bad = t([[0, 4]], torch.int32)
    with pytest.raises(IndexError):
        pik.gather_pages_int8(*lc, bad, "head", torch.float32)
    with pytest.raises(IndexError):
        new = torch.zeros((1, KCFG.n_kv_head, KCFG.head_dim))
        pik.paged_append_int8(*lc, new, new, t([4], torch.int32), t([0], torch.int32), "head")
    assert pik.launches == before


# ---------------------------------------------------------------------------
# Model forwards and the scheduler against the JAX package's XLA path
# ---------------------------------------------------------------------------

CFG = LlamaConfig.tiny(n_vocab=512, n_ctx=64, n_kv_head=2)  # 4 heads of 64, GQA 2
N_PAGES, PS = 10, 16


@pytest.fixture(scope="module")
def params():
    jparams = jl.params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(77)),
                                  dtype=jnp.float32)
    return jl.unstack_params(jparams), tl.params_from_jax(numpy_params(jparams))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _assert_live_rows_close(tpool, jpool, layout, table, lengths):
    """Each sequence's first lengths[b] K / V rows, dequantized through its
    table, within one code step of the row (amax / 127)."""
    for (k_t, ks_t, v_t, vs_t), (k_j, ks_j, v_j, vs_j) in zip(tpool.layers(), jpool):
        for got, want in (((k_t, ks_t), (k_j, ks_j)), ((v_t, vs_t), (v_j, vs_j))):
            g = pik.gather_pages_int8(got[0], got[1], got[0], got[1], t(table), layout,
                                      torch.float32)[0].numpy()
            c = jp.gather_pool_payload(want[0], jnp.asarray(table))
            s = jp.gather_pool_scales(want[1], jnp.asarray(table))
            w = np.asarray(c.astype(jnp.float32) * s[..., None])
            B, Hkv, mp, ps, Dh = w.shape
            w = w.reshape(B, Hkv, mp * ps, Dh)
            step = np.asarray(s).reshape(B, Hkv, mp * ps, 1) * 1.01
            for b, n in enumerate(lengths):
                assert np.all(np.abs(g[b, :, :n] - w[b, :, :n]) <= step[b, :, :n])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_int8_forwards_match_jax(params, layout, monkeypatch):
    """Prefill two prompts into int8 pages, one chunked-prefill
    continuation over a cached prefix, then three decode steps (see
    tests/test_torch_paged.py for the bf16 twin)."""
    jparams, tparams = params
    cfg = port_config(CFG)
    jpool, tpool = _pools(layout, monkeypatch, CFG, N_PAGES, PS)
    rng = np.random.default_rng(12)
    table = np.array([[4, 2, 9, 0], [6, 1, 3, 0], [0, 0, 0, 0]], np.int32)

    toks = rng.integers(3, CFG.n_vocab, (3, 32)).astype(np.int32)
    lengths = np.array([32, 19, 0], np.int32)
    h_j, jpool = jl.forward_paged_prefill(CFG, jparams, jnp.asarray(toks), jpool,
                                          jnp.asarray(table), jnp.asarray(lengths))
    with torch.no_grad():
        h_t, _ = tl.forward_paged_prefill(cfg, tparams, t(toks).long(), tpool, t(table))
    _close(h_t[:2], np.asarray(h_j)[:2])
    _assert_live_rows_close(tpool, jpool, layout, table, [32, 32])

    chunk = np.zeros((3, PS), np.int32)
    chunk[0, :7] = rng.integers(3, CFG.n_vocab, 7)
    start, n_new = np.array([32, 0, 0], np.int32), np.array([7, 0, 0], np.int32)
    cont_table = np.where(np.arange(3)[:, None] == 0, table, 0).astype(np.int32)
    h_j, jpool = jl.forward_paged_prefill_cont(CFG, jparams, jnp.asarray(chunk), jpool,
                                               jnp.asarray(cont_table), jnp.asarray(start),
                                               jnp.asarray(n_new))
    with torch.no_grad():
        h_t, _ = tl.forward_paged_prefill_cont(cfg, tparams, t(chunk).long(), tpool,
                                               t(cont_table), t(start), t(n_new))
    _close(h_t[0, :7], np.asarray(h_j)[0, :7])
    _assert_live_rows_close(tpool, jpool, layout, table, [39, 19])

    lens = np.array([39, 19, 0], np.int32)
    for _ in range(3):
        tok = rng.integers(3, CFG.n_vocab, (3, 1)).astype(np.int32)
        h_j, jpool = jl.forward_paged_decode(CFG, jparams, jnp.asarray(tok), jpool,
                                             jnp.asarray(table), jnp.asarray(lens))
        with torch.no_grad():
            h_t, _ = tl.forward_paged_decode(cfg, tparams, t(tok).long(), tpool, t(table),
                                             t(lens))
        _close(h_t[:2], np.asarray(h_j)[:2])
        lens = lens + np.array([1, 1, 0], np.int32)
    _assert_live_rows_close(tpool, jpool, layout, table, lens[:2])


SCENARIOS = {
    "two_prompts": ([[1, 5, 9, 13], [1, 30, 60, 90, 120, 150]], 16, dict(max_batch=2)),
    "chunked_prefix_cache": ([[1] + list(range(3, 44)), [1] + list(range(3, 40)) + [7, 8]], 8,
                             dict(max_batch=2, n_pages=24, prefill_chunk=16,
                                  prefix_cache=True)),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_scheduler_int8_matches_jax(params, name, layout, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    prompts, n, kw = SCENARIOS[name]
    jparams = jl.params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(77)),
                                  dtype=jnp.float32)
    j = JPaged(CFG, jparams, sampling=SamplingConfig(temperature=0.0), cache_dtype="int8",
               decode_chunk=4, page_size=PS, **kw)
    want = [r.output for r in j.generate_many(prompts, max_new_tokens=n)]
    s = PagedScheduler(port_config(CFG), params[1], sampling=TSamplingConfig(temperature=0.0),
                       cache_dtype="int8", decode_chunk=4, page_size=PS, layout=layout, **kw)
    assert s.cache.quant and s.cache.k[0].dtype == torch.int8
    got = [r.output for r in s.generate_many(prompts, max_new_tokens=n)]
    assert got == want and all(len(o) == n for o in got)
    assert s.alloc.n_free + len(set(s._pc.values())) == s.n_pages - 1
    s.reset_device_state()
    assert s.cache.quant and s.cache.layout == layout


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pool_from_jax_takes_int8_pools(layout, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    stacked = jp.PagedQuantKVCache.create(CFG, 5, PS)
    unrolled = jp.make_unrolled_quant_pool(CFG, 5, PS)
    arrays = tuple(map(np.asarray, stacked))
    for src in (dict(zip(("k_pages", "ks_pages", "v_pages", "vs_pages"), arrays)), arrays,
                [tuple(map(np.asarray, lc)) for lc in unrolled]):
        pool = tp.pool_from_jax(src, layout)
        assert pool.quant and len(pool.layers()) == CFG.n_layer and pool.n_pages == 5
        assert tuple(pool.k[0].shape) == tuple(stacked.k_pages.shape[1:])
        assert tuple(pool.vs[0].shape) == tuple(stacked.vs_pages.shape[1:])
        assert pool.k[0].dtype == torch.int8 and pool.ks[0].dtype == torch.float32
    made = tp.PagedKVCache.create(port_config(CFG), 5, PS, "int8", layout=layout)
    assert [tuple(a.shape) for a in made.layers()[0]] == [
        tuple(a.shape[1:]) for a in (stacked.k_pages, stacked.ks_pages, stacked.v_pages,
                                     stacked.vs_pages)]
    with pytest.raises(ValueError):
        tp.PagedKVCache(made.k, made.v, layout, made.ks, None)


def test_entry_point_serves_int8_pages_on_the_cpu(tmp_path):
    """`python -m tokenhawk_tpu_torch.serving --paged --kv int8 --device cpu`
    on a tiny ggjt file: two requests stream to `event: done`, /health
    reports 0 step errors."""
    from tokenhawk_tpu_torch.ggml.writer import write_ggml

    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=128, n_head=2, n_layer=1, n_ff=256)
    tokens, scores = padded_vocab(cfg.n_vocab)
    hp = dict(n_vocab=cfg.n_vocab, n_embd=cfg.n_embd, n_mult=cfg.n_mult, n_head=cfg.n_head,
              n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=0)
    path = tmp_path / "tiny.bin"
    write_ggml(path, hp, tokens, scores, make_ggml_weights(cfg, np.random.default_rng(3)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tokenhawk_tpu_torch.serving", "-m", str(path), "--paged",
         "--kv", "int8", "--device", "cpu", "--dtype", "f32", "--n-ctx", "64",
         "--page-size", "16", "--port", str(port)], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
                time.sleep(0.5)
        for prompt in ("hi", "a longer prompt than the first"):
            req = urllib.request.Request(base + "/generate",
                                         data=json.dumps({"prompt": prompt,
                                                          "max_tokens": 5}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                frames = [f for f in r.read().decode().split("\n\n") if f.strip()]
            assert frames[-1].startswith("event: done")
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            health = json.loads(r.read())
        assert health["paged"] is True and health["step_errors"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
