"""The port's paged KV pool against the JAX package.

Kernels 5-7 (ops/cuda/paged_decode.py) are held, through their plain
versions, to the JAX Pallas kernels in interpret mode:
  - paged decode to `paged_flash_decode` (grid form) and
    `paged_flash_decode_walk` at atol 3e-5, rtol 1e-4 (f32 softmax in a
    different order), on ragged lengths across a page boundary and a
    length-1 slot;
  - paged append to `paged_append_rows` and page gather to
    `gather_pages_dense` bit for bit.
The layer ops and the three paged model forwards are held to the JAX
package's (its CPU path, XLA) on the same numpy inputs: the layer ops'
pool writes exactly; the forwards' written pages and hidden states at
rtol 1e-4 and an atol of 1e-4 of the largest value (f32 projections
summed in another order).  Every case runs in both pool layouts.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models import llama as jl
from tokenhawk_tpu.ops.pallas.paged_decode import (
    gather_pages_dense,
    paged_append_rows,
    paged_flash_decode,
    paged_flash_decode_walk,
)
from tokenhawk_tpu.runtime import paged as jp
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops.cuda import paged_decode as pdk
from tokenhawk_tpu_torch.runtime import paged as tp

from helpers import make_ggml_weights
from torch_helpers import numpy_params, port_config, t

LAYOUTS = ["contig", "head"]
PS, DH = 16, 128


def _pool(rng, layout, Hkv, n_pages, ps=PS, Dh=DH):
    shape = (n_pages, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pages, ps, Dh)
    return rng.standard_normal(shape).astype(np.float32)


def _page(pool, layout, p):
    return pool[p] if layout == "contig" else pool[:, p]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("Hkv,rep", [(2, 2), (4, 1)])
def test_paged_decode_plain_matches_jax_kernels(layout, Hkv, rep):
    rng = np.random.default_rng(Hkv * 10 + rep)
    B, n_pages, mp = 4, 12, 3
    kp, vp = _pool(rng, layout, Hkv, n_pages), _pool(rng, layout, Hkv, n_pages)
    table = rng.permutation(n_pages)[: B * mp].reshape(B, mp).astype(np.int32)
    lengths = np.array([PS + 9, 1, 2 * PS, 40], np.int32)  # across a boundary, length 1
    q = (rng.standard_normal((B, Hkv, rep, DH)) / DH**0.5).astype(np.float32)
    args = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    contig = layout == "contig"
    got = pdk.paged_decode(t(q), t(kp), t(vp), t(table), t(lengths), layout).numpy()
    for fn in (paged_flash_decode, paged_flash_decode_walk):
        want = np.asarray(fn(*args, contig=contig, interpret=True))
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_paged_decode_length_zero_is_zeros():
    rng = np.random.default_rng(3)
    kp, vp = _pool(rng, "contig", 2, 4), _pool(rng, "contig", 2, 4)
    q = rng.standard_normal((2, 2, 1, DH)).astype(np.float32)
    out = pdk.paged_decode(t(q), t(kp), t(vp), t([[1, 2], [3, 0]], torch.int32),
                           t([0, 5], torch.int32), "contig")
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool(torch.isfinite(out).all()) and bool((out[1] != 0).any())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_append_plain_matches_jax_kernel(layout):
    """Distinct slots of one page all land (bit for bit with the Pallas
    kernel); rows that share the trash (page, slot) leave it unspecified,
    so that page is left out of the second comparison."""
    rng = np.random.default_rng(6)
    Hkv, n_pages, B = 4, 6, 3
    for page, slot, trash in (([1, 4, 1], [3, 9, 5], None), ([2, 5, 2], [7, 0, 7], 2)):
        kp, vp = _pool(rng, layout, Hkv, n_pages), _pool(rng, layout, Hkv, n_pages)
        kn, vn = (rng.standard_normal((B, Hkv, DH)).astype(np.float32) for _ in range(2))
        page, slot = np.array(page, np.int32), np.array(slot, np.int32)
        k_t, v_t = t(kp), t(vp)
        pdk.paged_append(k_t, v_t, t(kn), t(vn), t(page), t(slot), layout)
        keep = [p for p in range(n_pages) if p != trash]
        for got, pool, new in ((k_t, kp, kn), (v_t, vp, vn)):
            want = np.asarray(paged_append_rows(jnp.asarray(pool), jnp.asarray(new),
                                                jnp.asarray(page), jnp.asarray(slot),
                                                contig=layout == "contig", interpret=True))
            for p in keep:
                np.testing.assert_array_equal(_page(got.numpy(), layout, p),
                                              _page(want, layout, p))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gather_pages_plain_matches_jax_kernel(layout):
    rng = np.random.default_rng(5)
    Hkv, n_pages, B, mp = 4, 9, 3, 4
    kp, vp = _pool(rng, layout, Hkv, n_pages), _pool(rng, layout, Hkv, n_pages)
    table = rng.integers(0, n_pages, (B, mp)).astype(np.int32)
    kg, vg = gather_pages_dense(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                                contig=layout == "contig", interpret=True)
    got_k, got_v = pdk.gather_pages(t(kp), t(vp), t(table), layout)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(kg))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(vg))
    fancy = pdk.gather_pool_payload(t(kp), t(table), layout).reshape(B, Hkv, mp * PS, DH)
    np.testing.assert_array_equal(fancy.numpy(), np.asarray(kg))


def test_plain_versions_raise_on_page_ids_out_of_range():
    rng = np.random.default_rng(9)
    kp, vp = t(_pool(rng, "head", 2, 4)), t(_pool(rng, "head", 2, 4))
    bad = t([[0, 4]], torch.int32)
    q = torch.zeros((1, 2, 1, DH))
    with pytest.raises(IndexError):
        pdk.paged_decode(q, kp, vp, bad, t([3], torch.int32), "head")
    with pytest.raises(IndexError):
        pdk.gather_pages(kp, vp, bad, "head")
    with pytest.raises(IndexError):
        new = torch.zeros((1, 2, DH))
        pdk.paged_append(kp, vp, new, new, t([-1], torch.int32), t([0], torch.int32), "head")
    with pytest.raises(ValueError):
        pdk.pool_dims(kp, "rows")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(pdk.launches)
    test_paged_decode_length_zero_is_zeros()
    test_gather_pages_plain_matches_jax_kernel("contig")
    assert pdk.launches == before


# ---------------------------------------------------------------------------
# Layer ops and model forwards against the JAX package's XLA path
# ---------------------------------------------------------------------------

CFG = LlamaConfig.tiny(n_vocab=512, n_ctx=64, n_kv_head=2)  # 4 heads of 64, GQA 2
N_PAGES = 10


@pytest.fixture(scope="module")
def params():
    jparams = jl.params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(77)),
                                  dtype=jnp.float32)
    return jl.unstack_params(jparams), tl.params_from_jax(numpy_params(jparams))


def _pools(layout, monkeypatch):
    """A JAX unrolled pool made in `layout` with random contents, and the
    port's copy of it."""
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    rng = np.random.default_rng(4)
    shape = jp.make_unrolled_pool(CFG, N_PAGES, PS, jnp.float32)[0][0].shape
    jpool = tuple((jnp.asarray(rng.standard_normal(shape), jnp.float32),
                   jnp.asarray(rng.standard_normal(shape), jnp.float32))
                  for _ in range(CFG.n_layer))
    return jpool, tp.pool_from_jax([(np.asarray(k), np.asarray(v)) for k, v in jpool], layout)


def _assert_pools_equal(tpool, jpool, layout, skip=()):
    for (k_t, v_t), (k_j, v_j) in zip(zip(tpool.k, tpool.v), jpool):
        for got, want in ((k_t, k_j), (v_t, v_j)):
            for p in range(N_PAGES):
                if p not in skip:
                    np.testing.assert_array_equal(_page(got.numpy(), layout, p),
                                                  _page(np.asarray(want), layout, p))


def _assert_live_rows_close(tpool, jpool, layout, table, lengths):
    """Each sequence's first lengths[b] K / V rows, through its table."""
    for (k_t, v_t), (k_j, v_j) in zip(zip(tpool.k, tpool.v), jpool):
        for got, want in ((k_t, k_j), (v_t, v_j)):
            g = tp.gather_pool_payload(got, t(table), layout).numpy()
            w = np.asarray(jp.gather_pool_payload(want, jnp.asarray(table)))
            B, Hkv, mp, ps, Dh = g.shape
            for b, n in enumerate(lengths):
                a = g[b].reshape(Hkv, mp * ps, Dh)[:, :n]
                e = w[b].reshape(Hkv, mp * ps, Dh)[:, :n]
                np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4 * np.abs(e).max())


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layer_ops_match_jax(layout, monkeypatch):
    jpool, tpool = _pools(layout, monkeypatch)
    assert tpool.layout == layout and tpool.n_pages == N_PAGES and tpool.page_size == PS
    assert pdk.pool_dims(tpool.k[0], layout)[1] == CFG.n_kv_head
    rng = np.random.default_rng(8)
    Hkv, Dh = CFG.n_kv_head, CFG.head_dim
    table = np.array([[3, 7, 1], [5, 2, 8]], np.int32)
    pos = np.array([PS + 4, 2], np.int32)
    kn, vn = (rng.standard_normal((2, Hkv, Dh)).astype(np.float32) for _ in range(2))
    k_j, v_j = jpool[0]
    k_j = jp.append_token_layer(k_j, jnp.asarray(kn), jnp.asarray(table), jnp.asarray(pos))
    v_j = jp.append_token_layer(v_j, jnp.asarray(vn), jnp.asarray(table), jnp.asarray(pos))
    tp.append_token_layer(tpool.k[0], tpool.v[0], t(kn), t(vn), t(table), t(pos), layout)
    frag = rng.standard_normal((2, Hkv, 20, Dh)).astype(np.float32)  # 2 pages, the last short
    start = np.array([0, 1], np.int32)
    k_j = jp.paginate_fragment_layer_at(k_j, jnp.asarray(frag), jnp.asarray(table),
                                        jnp.asarray(start))
    tp.paginate_fragment_layer_at(tpool.k[0], t(frag), t(table), t(start), layout)
    _assert_pools_equal(tpool, ((k_j, v_j),) + jpool[1:], layout)

    q = rng.standard_normal((2, 1, CFG.n_head, Dh)).astype(np.float32)
    lengths = np.array([PS + 5, 40], np.int32)
    want = jp.attend_paged_layer(jnp.asarray(q), k_j, v_j, jnp.asarray(table),
                                 jnp.asarray(lengths))
    _close(tp.attend_paged_layer(t(q), tpool.k[0], tpool.v[0], t(table), t(lengths), layout),
           want)
    _close(tp.gather_pool_payload(tpool.v[0], t(table), layout),
           jp.gather_pool_payload(v_j, jnp.asarray(table)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_forwards_match_jax(params, layout, monkeypatch):
    """Prefill two prompts into pages, one chunked-prefill continuation
    over a cached prefix, then three decode steps: hidden states and every
    sequence's live K / V rows agree with the JAX forwards (rows past a
    sequence's length, and page 0, the padding rows' trash page, hold
    values neither side reads)."""
    jparams, tparams = params
    cfg = port_config(CFG)
    jpool, tpool = _pools(layout, monkeypatch)
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

    # Row 0 continues at position 32 (page 2 of its table) with 7 new
    # tokens; the other rows are padding (trash tables), as the scheduler
    # pads a continuation group.
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


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pool_from_jax_takes_unrolled_and_stacked_pools(layout, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    stacked = jp.PagedKVCache.create(CFG, 5, PS, jnp.float32)
    for src in ({"k_pages": np.asarray(stacked.k_pages), "v_pages": np.asarray(stacked.v_pages)},
                (np.asarray(stacked.k_pages), np.asarray(stacked.v_pages)),
                [tuple(map(np.asarray, kv)) for kv in jp.make_unrolled_pool(CFG, 5, PS,
                                                                            jnp.float32)]):
        pool = tp.pool_from_jax(src, layout)
        assert len(pool.k) == CFG.n_layer and pool.n_pages == 5
        assert tuple(pool.k[0].shape) == tuple(stacked.k_pages.shape[1:])


def test_pool_layout_is_stored_not_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "head")
    pool = tp.PagedKVCache.create(port_config(CFG), 5, PS, torch.float32)
    assert pool.layout == "contig" and pool.k[0].shape[0] == 5
    with pytest.raises(ValueError):
        tp.PagedKVCache(pool.k, pool.v, "rows")
    root = Path(__file__).resolve().parents[1] / "tokenhawk_tpu_torch"
    readers = sorted(p.name for p in root.rglob("*.py")
                     if re.search(r"os\.environ|getenv", p.read_text()))
    # build.py: where nvcc lives, read once at build time; llama.py: the
    # reference's THAWK_FUSED_OWO / THAWK_FUSED_ATTN, read once per built model;
    # loader.py: the reference's THAWK_Q4K_SB, read once per load.
    assert readers == ["build.py", "llama.py", "loader.py"]
