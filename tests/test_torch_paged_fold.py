"""Kernels 5 and 10 with their appends (kernels 6 and 11) folded in, on the CPU.

A paged decode layer appends its K / V row and attends in one launch
(ops/cuda/paged_decode.py `paged_decode_append`, ops/cuda/paged_int8.py
`paged_decode_int8_append`).  The kernels cannot run here, so their order
is repeated in torch and held to the JAX package:

  - `folded_split` / `folded_int8_split`: the block whose range holds row
    lengths[b] writes the new row there through the table (the int8 form
    quantizes it first, with the codec's bfloat16-rounded scale) and takes
    the same values into its tile, nothing where the table has no such row
    (the capacity edge); then kernel 5's (or 10's) split form over
    lengths + 1 rows (tests/test_torch_decode_tiles.py `paged_split`, its
    ranges and merge), at 1 to 8 splits and floors of 1, 2 and 4 tiles.
    Held against the JAX package's `append_token_layer` then
    `attend_paged_layer` over lengths + 1 (and their int8 twins), and the
    written pools against the Pallas `paged_append_rows` /
    `paged_append_scales` in interpret mode, in both pool layouts, pages of
    16 and 64 rows, head dims 64 and 128, with two sequences parked on the
    trash page (their table rows all the trash page, both appending at its
    slot 5) and one at the capacity edge;
  - `forward_paged_decode` on CPU tensors against the layer loop it
    replaces (kernel 6 then kernel 5 over lengths + 1; kernels 11 then 10
    on int8 pages), bit for bit, a slot parked on the trash page among the
    sequences.

Tolerance: outputs within atol 3e-5, rtol 1e-4 of JAX (the reference's
decode tolerance: f32 softmax in another order); pools bit for bit (int8
codes and scales too) outside the trash page, whose shared slot is
written by two sequences in no set order.  The parked sequences' outputs
are discarded by the scheduler and left out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops import kvquant as jk
from tokenhawk_tpu.ops.pallas.paged_decode import paged_append_rows, paged_append_scales
from tokenhawk_tpu.runtime import paged as jp
from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops import kvquant as tk
from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
from tokenhawk_tpu_torch.runtime import paged as tp

from test_torch_decode_tiles import paged_split
from test_torch_decode_tiles_int8 import paged_int8_split
from torch_helpers import t

TOL = dict(atol=3e-5, rtol=1e-4)
# (Hkv, rep, Dh): a TinyLlama-width model's heads, then few wide ones.
HEADS = [(4, 8, 64), (2, 1, 128)]
FLOORS = (1, fd.APPEND_MIN_TILES, fd.MIN_SPLIT_TILES)
N_PARKED = 2


def _write_rows(pages, rows, page, slot, fits, layout):
    """rows [B, Hkv, ...] at (page[b], slot[b]) of `pages` where fits[b],
    in order."""
    for b in torch.nonzero(fits)[:, 0].tolist():
        if layout == "contig":
            pages[page[b], :, slot[b]] = rows[b].to(pages.dtype)
        else:
            pages[:, page[b], slot[b]] = rows[b].to(pages.dtype)


def folded_split(q, k_pages, v_pages, k_new, v_new, table, lengths, layout, splits: int,
                 min_tiles: int):
    """Kernel 5 with kernel 6 folded in, in torch (the pools updated in
    place): the appending blocks' writes, then the walk over lengths + 1."""
    page, slot, fits = pd.append_rows(table, lengths, pd.pool_dims(k_pages, layout)[2])
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        _write_rows(pages, new, page, slot, fits, layout)
    return paged_split(q, k_pages, v_pages, table, lengths + 1, layout, splits, min_tiles)


def folded_int8_split(q, pool, k_new, v_new, table, lengths, layout, splits: int,
                      min_tiles: int):
    """Kernel 10 with kernel 11 folded in, in torch: each appended row
    quantized (codes and the bfloat16-rounded scale, held as f32), then the
    walk over lengths + 1."""
    k, ks, v, vs = pool
    page, slot, fits = pd.append_rows(table, lengths, pd.pool_dims(k, layout)[2])
    for codes, scales, new in ((k, ks, k_new), (v, vs, v_new)):
        c, s = tk.quantize_kv_block(new)
        _write_rows(codes, c, page, slot, fits, layout)
        _write_rows(scales, s.float(), page, slot, fits, layout)
    return paged_int8_split(q, pool, table, lengths + 1, layout, splits, min_tiles)


def _case(layout, ps, Hkv, rep, Dh, seed, int8: bool):
    """Stored lengths 0, 1, ps - 1, ps, ps + 1 and the table's rows but one
    (each appends at that row), the table's full rows (the capacity edge),
    then N_PARKED sequences parked on the trash page (the last page) at
    stored length 5.  Returns numpy (q, k_new, v_new, pools, table, lengths)."""
    rng = np.random.default_rng(seed)
    mp = 128 // ps + 1
    cap = mp * ps
    lens = np.array([0, 1, ps - 1, ps, ps + 1, cap - 1, cap] + [5] * N_PARKED, np.int32)
    B, n_pages = len(lens), len(lens) * mp + 1
    shape = (n_pages, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pages, ps, Dh)
    if int8:
        pools = []
        for _ in range(2):
            codes, scales = jk.quantize_kv_block(jnp.asarray(rng.standard_normal(shape),
                                                             jnp.float32))
            pools += [np.asarray(codes), np.asarray(scales.astype(jnp.float32))]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    table = rng.permutation(n_pages - 1)[:B * mp].reshape(B, mp).astype(np.int32)
    table[-N_PARKED:] = n_pages - 1
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    kn, vn = (rng.standard_normal((B, Hkv, Dh)).astype(np.float32) for _ in range(2))
    return q, kn, vn, pools, table, lens


def _kept(x, layout):
    """A pool without its last page (the trash page)."""
    x = np.asarray(x)
    return x[:-1] if layout == "contig" else x[:, :-1]


def _jax_reference(q, kn, vn, pools, table, lens, layout, int8: bool):
    """The JAX package's layer ops: the appends of the sequences whose
    table has row lengths[b], then the attention over lengths + 1 (the
    rows the table has).  Returns (out [B, Hkv, rep, Dh], pools as f32)."""
    B, Hkv, rep, Dh = q.shape
    fits = lens < table.shape[1] * (pools[0].shape[2])
    rows = [jnp.asarray(a[fits]) for a in (kn, vn, table, lens)]
    qj = jnp.asarray(q.reshape(B, 1, Hkv * rep, Dh))
    if int8:
        k, ks, v, vs = (jnp.asarray(a) if a.dtype == np.int8 else jnp.asarray(a, jnp.bfloat16)
                        for a in pools)
        k, ks = jp.append_token_layer_int8(k, ks, rows[0], rows[2], rows[3])
        v, vs = jp.append_token_layer_int8(v, vs, rows[1], rows[2], rows[3])
        out = jp.attend_paged_layer_int8(qj, k, ks, v, vs, jnp.asarray(table),
                                         jnp.asarray(lens + 1), scale=1.0)
        written = (k, ks, v, vs)
    else:
        k = jp.append_token_layer(jnp.asarray(pools[0]), rows[0], rows[2], rows[3])
        v = jp.append_token_layer(jnp.asarray(pools[1]), rows[1], rows[2], rows[3])
        out = jp.attend_paged_layer(qj, k, v, jnp.asarray(table), jnp.asarray(lens + 1),
                                    scale=1.0)
        written = (k, v)
    return (np.asarray(out).reshape(B, Hkv, rep, Dh),
            [np.asarray(a.astype(jnp.float32)) for a in written])


def _pallas_pools(kn, vn, pools, table, lens, layout, int8: bool):
    """The rows written by the Pallas appends in interpret mode (payload,
    and scales on int8 pages) at the rows the table has."""
    ps = pools[0].shape[2]
    fits = lens < table.shape[1] * ps
    page = jnp.asarray(table[fits][np.arange(fits.sum()), lens[fits] // ps])
    slot = jnp.asarray(lens[fits] % ps)
    contig = layout == "contig"
    if not int8:
        return [np.asarray(paged_append_rows(jnp.asarray(pool), jnp.asarray(new[fits]), page,
                                             slot, contig=contig, interpret=True))
                for pool, new in zip(pools, (kn, vn))]
    out = []
    for (codes, scales), new in zip((pools[:2], pools[2:]), (kn, vn)):
        q8, sc = jk.quantize_kv_block(jnp.asarray(new[fits]))
        out.append(np.asarray(paged_append_rows(jnp.asarray(codes), q8, page, slot,
                                                contig=contig, interpret=True)))
        out.append(np.asarray(paged_append_scales(jnp.asarray(scales, jnp.bfloat16), sc, page,
                                                  slot, contig=contig, interpret=True)
                              .astype(jnp.float32)))
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["f32-pages", "int8-pages"])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("layout", ["contig", "head"])
def test_folded_walk_matches_the_reference(layout, ps, heads, int8, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    Hkv, rep, Dh = heads
    q, kn, vn, pools, table, lens = _case(layout, ps, Hkv, rep, Dh, ps + Hkv + rep + int8,
                                          int8)
    want, want_pools = _jax_reference(q, kn, vn, pools, table, lens, layout, int8)
    pallas_pools = _pallas_pools(kn, vn, pools, table, lens, layout, int8)
    live = np.arange(len(lens)) < len(lens) - N_PARKED
    cap = table.shape[1] * ps
    assert lens[live].max() == cap  # the capacity edge is among them

    def check(got, got_pools, msg):
        np.testing.assert_allclose(got[live], want[live], **TOL, err_msg=msg)
        for g, w, p in zip(got_pools, want_pools, pallas_pools):
            np.testing.assert_array_equal(_kept(g.float().numpy(), layout), _kept(w, layout),
                                          err_msg=msg)
            np.testing.assert_array_equal(_kept(g.float().numpy(), layout), _kept(p, layout),
                                          err_msg=msg)

    plain_pools = [t(a) for a in pools]
    fold = pi.paged_decode_int8_append_plain if int8 else pd.paged_decode_append_plain
    plain = fold(t(q), *plain_pools, t(kn), t(vn), t(table), t(lens), layout).numpy()
    check(plain, plain_pools, "plain")
    for min_tiles in FLOORS:
        for splits in range(1, 9):
            msg = f"splits={splits} min_tiles={min_tiles}"
            got_pools = [t(a) for a in pools]
            if int8:
                got = folded_int8_split(t(q), got_pools, t(kn), t(vn), t(table), t(lens),
                                        layout, splits, min_tiles).numpy()
            else:
                got = folded_split(t(q), *got_pools, t(kn), t(vn), t(table), t(lens), layout,
                                   splits, min_tiles).numpy()
            check(got, got_pools, msg)
            np.testing.assert_allclose(got[live], plain[live], **TOL, err_msg=msg)
            for g, p in zip(got_pools, plain_pools):
                assert torch.equal(g, p), msg


@pytest.mark.parametrize("int8", [False, True], ids=["f32-pages", "int8-pages"])
def test_the_capacity_edge_appends_nothing(int8):
    """A sequence whose table is full attends over its rows and writes no
    row anywhere: the pools are unchanged, the output is the attention
    alone over the table's rows."""
    q, kn, vn, pools, table, lens = _case("contig", 16, 2, 4, 64, 3, int8)
    full = slice(6, 7)  # the sequence at the capacity edge
    args = [t(a[full]) for a in (q, kn, vn)]
    tab, stored = t(table[full]), t(lens[full])
    before = [t(a) for a in pools]
    after = [x.clone() for x in before]
    if int8:
        got = pi.paged_decode_int8_append(args[0], *after, *args[1:], tab, stored, "contig")
        want = pi.paged_decode_int8_plain(args[0], *before, tab, stored, "contig")
    else:
        got = pd.paged_decode_append(args[0], *after, *args[1:], tab, stored, "contig")
        want = pd.paged_decode_plain(args[0], *before, tab, stored, "contig")
    assert int(stored[0]) == table.shape[1] * 16
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    q, kn, vn, pools, table, lens = _case("head", 16, 2, 4, 64, 5, False)
    before = (dict(pd.launches), dict(pi.launches))
    a, b = [t(x) for x in pools], [t(x) for x in pools]
    args = (t(kn), t(vn), t(table), t(lens), "head")
    assert torch.equal(pd.paged_decode_append(t(q), *a, *args),
                       pd.paged_decode_append_plain(t(q), *b, *args))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    q, kn, vn, pools, table, lens = _case("head", 16, 2, 4, 64, 5, True)
    a, b = [t(x) for x in pools], [t(x) for x in pools]
    args = (t(kn), t(vn), t(table), t(lens), "head")
    assert torch.equal(pi.paged_decode_int8_append(t(q), *a, *args),
                       pi.paged_decode_int8_append_plain(t(q), *b, *args))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (pd.launches, pi.launches) == before


def _parent_forward_paged_decode(cfg, params, tokens, cache, table, lengths):
    """forward_paged_decode's layer loop before the fold: kernel 6 (11)
    at lengths, then kernel 5 (10) over lengths + 1."""
    x = params.tok_embd[tokens]
    cos, sin = tl.rope_cos_sin(lengths.long()[:, None], cfg.head_dim, cfg.rope_theta)
    for lp, lc in zip(params.layers, cache.layers()):
        q, k, v = tl._qkv(cfg, x, lp, cos, sin)
        if cache.quant:
            tp.append_token_layer_int8(*lc, k[:, 0], v[:, 0], table, lengths, cache.layout)
            ctx = tp.attend_paged_layer_int8(q, *lc, table, lengths + 1, cache.layout)
        else:
            tp.append_token_layer(*lc, k[:, 0], v[:, 0], table, lengths, cache.layout)
            ctx = tp.attend_paged_layer(q, *lc, table, lengths + 1, cache.layout)
        x = tl._wo_ffn_block(cfg, x, ctx, lp, params.fusions)
    return x


@pytest.mark.parametrize("layout", ["contig", "head"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_forward_paged_decode_is_the_parents(kv, layout):
    """Four decode steps of three sequences (one parked on the trash page,
    page 0, at length 0) through a two-layer Q4_0 model: hidden states and
    every page bit for bit those of the layer loop before the fold."""
    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=4, n_kv_head=2, n_layer=2,
                           n_ff=512, n_ctx=64)
    g = torch.Generator().manual_seed(7)
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    params = tl.fuse_params(tl.init_params(cfg, g, dtype=dtype, scale=0.05, quant="q4_0"))
    pool_dtype = "int8" if kv == "int8" else dtype
    pools = [tp.PagedKVCache.create(cfg, 8, 16, pool_dtype, layout=layout) for _ in range(2)]
    for a, b in zip(*(p.layers() for p in pools)):
        for x, y in zip(a, b):
            x.copy_(torch.randn(x.shape, generator=g).to(x.dtype) if x.dtype != torch.int8
                    else torch.randint(-127, 128, x.shape, generator=g, dtype=torch.int8))
            y.copy_(x)
    table = torch.tensor([[3, 5, 1, 7], [2, 6, 4, 0], [0, 0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([15, 30, 0], dtype=torch.int32)
    with torch.no_grad():
        for step in range(4):
            tok = torch.randint(3, cfg.n_vocab, (3, 1), generator=g)
            h, _ = tl.forward_paged_decode(cfg, params, tok, pools[0], table, lengths)
            want = _parent_forward_paged_decode(cfg, params, tok, pools[1], table, lengths)
            assert torch.equal(h, want), step
            for a, b in zip(*(p.layers() for p in pools)):
                assert all(torch.equal(x, y) for x, y in zip(a, b)), step
            lengths = lengths + torch.tensor([1, 1, 0], dtype=torch.int32)
