"""The split forms of kernels 18 and 5 and kernel 16 on kernel 3's tile walk, on the CPU.

The kernels (csrc/decode_tiles.cuh, instanced by csrc/decode_stats.cu,
csrc/paged_decode.cu and csrc/attn_wo.cu) cannot run here, so their functions are repeated in
torch and held to the reference's Pallas kernels in interpret mode:

  - kernel 18's cluster form (`cluster_partials`): the one range of a
    sequence's live rows (lengths clamped to [0, S], not to 1) cut into the
    tile-aligned ranges `_split_ranges` gives for the cluster's size and
    floor, each range's partials (`range_stats`), then block 0's merge over
    the ranges that hold rows, in split order, into one unnormalised
    partial: m the max of the ranges' m, o and l their sums weighted by
    exp(m_s - m), no division; no range holding a row gives the merge
    identity (0, -inf, 0).  Held against `flash_decode_stats` at 1 to 16
    blocks (floors of 1, 2 and 4 tiles), lengths 0, 1, 31, 32, 33 and S, on
    a contiguous cache and on a cyclic shard (every fourth row of a larger
    cache, as CP decode hands it over), and against
    `flash_decode_stats_plain` on the one range;
  - kernel 5's split form (`paged_split`): the pages gathered by the table,
    the same ranges and merge, one division, zeros for a length of 0 (the
    port's recorded difference: the plain version's too).  Held against
    `paged_flash_decode_walk` in both pool layouts, pages of 16 and 64
    rows, lengths 0 (against zeros), 1, ps - 1, ps, ps + 1 and the table's
    full rows, at 1 to 8 splits and floors of 1 and 2 tiles.

  - kernel 16's two launches (`kernel16`): the tile walk as kernel 3 runs it
    (the new row appended at clamp(lengths, 1, S) - 1, kernel 3's ranges of
    the live rows and block 0's merge) with q scaled by 1/sqrt(Dh) in q's
    type and the context divided once into f32, never rounded; then Wo's
    decode-row walk at one row over that context (each group's dot of the
    codes scaled once, the groups summed), x added, y rounded once.  Held
    against the reference's `fused_attn_out` in interpret mode over Q4_0
    and Q8_0 Wo at len_old 0, 37, 255 and 511, at 1 to 8 splits: the
    caches bit for bit, y within atol 1e-5 and rtol 1e-4.

Tolerance: atol 3e-5, rtol 1e-4 in f32 (the reference's decode tolerance;
kernel 16's 1e-5 and 1e-4); the merge identity and the zeros exactly.  `paged_splits`, kernel 5's
split count, is held to its rules: host integers only; kernel 3's count
where the (sequence, kv head) pairs leave SMs idle, FULL_SPLITS where one
block a pair would fill the SMs at most BLOCKS_PER_SM deep, 1 above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.pallas.attn_block import fused_attn_out as j_fused_attn_out
from tokenhawk_tpu.ops.pallas.flash_decode_dma import flash_decode_stats as j_fd_stats
from tokenhawk_tpu.ops.pallas.paged_decode import paged_flash_decode_walk
from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.parallel.cp import _shard_count

from torch_helpers import jax_q4, t

TOL = dict(atol=3e-5, rtol=1e-4)
# (Hkv, rep, Dh): the draft's heads, then few wide ones.
HEADS = [(4, 8, 64), (2, 1, 128)]
H100_SMS = 132


def _merge_live(o, m, l, live):
    """Block 0's merge of the ranges that hold rows ([n, ...] partials, live
    [n, B]) in split order: (o, m, l) unnormalised, the identity where no
    range holds a row."""
    n, B, Hkv, rep, Dh = o.shape
    m = m.reshape(n, B, Hkv, rep)
    l = l.reshape(n, B, Hkv, rep)
    keep = live[:, :, None, None]
    mx = torch.full_like(m[0], -torch.inf)
    for s in range(n):
        mx = torch.where(keep[s], torch.maximum(mx, m[s]), mx)
    num, den = torch.zeros_like(o[0]), torch.zeros_like(l[0])
    for s in range(n):
        f = torch.where(keep[s], torch.exp(m[s] - torch.where(keep[s], mx, 0.0)), 0.0)
        num = num + o[s] * f[..., None]
        den = den + l[s] * f
    return num, mx, den


def cluster_partials(q, k_cache, v_cache, lengths, cluster: int, min_tiles: int):
    """Kernel 18's cluster form in torch: one partial ([1, ...] as the
    kernel writes it with splits 1)."""
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    begin, end = fd._split_ranges(lengths.long().clamp(0, S), S, cluster, min_tiles)
    o, m, l = fd.range_stats(q, k_cache, v_cache, begin, end)
    num, mx, den = _merge_live(o, m, l, begin < end)
    return num[None], mx.reshape(1, B, Hkv * rep), den.reshape(1, B, Hkv * rep)


def paged_split(q, k_pages, v_pages, table, lengths, layout, splits: int, min_tiles: int):
    """Kernel 5's split form in torch: the table's pages, the ranges of
    each sequence's live rows (clamped to [0, max_pages * ps]), the merge,
    one division; zeros for a length of 0."""
    kg = pd.gather_pool_payload(k_pages, table, layout)
    vg = pd.gather_pool_payload(v_pages, table, layout)
    B, Hkv, mp, ps, Dh = kg.shape
    S = mp * ps
    kg, vg = kg.reshape(B, Hkv, S, Dh), vg.reshape(B, Hkv, S, Dh)
    begin, end = fd._split_ranges(lengths.long().clamp(0, S), S, splits, min_tiles)
    num, _, den = _merge_live(*fd.range_stats(q, kg, vg, begin, end), begin < end)
    out = num / torch.where(den == 0, 1.0, den)[..., None]  # den 0: num 0, the zeros
    return out.to(q.dtype)


def _stats_case(Hkv, rep, Dh, strided, seed):
    """q (numpy), the port's caches (contiguous, or a strided view of a
    larger cache) and lengths 0, 1, 31, 32, 33, S (numpy)."""
    rng = np.random.default_rng(seed)
    S = 128
    L = np.array([0, 1, 31, 32, 33, S], np.int32)
    B = len(L)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    if strided:  # shard 1 of 4 of a 4S-row cache, lengths its share of 4L
        big = [rng.standard_normal((B, Hkv, 4 * S, Dh)).astype(np.float32) for _ in range(2)]
        k_t, v_t = (t(c)[:, :, 1::4] for c in big)
        L = _shard_count(t(4 * L), 1, 4).numpy().astype(np.int32)  # 0, 1, 31, 32, 33, S
    else:
        k_t, v_t = (t(rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)) for _ in range(2))
    return q, k_t, v_t, L


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "cyclic-shard"])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
def test_stats_cluster_matches_the_reference(heads, strided):
    Hkv, rep, Dh = heads
    q, k_t, v_t, L = _stats_case(Hkv, rep, Dh, strided, Hkv * 10 + rep + strided)
    kc, vc = (np.ascontiguousarray(c.numpy()) for c in (k_t, v_t))
    jo, jm, jl = (np.asarray(a) for a in j_fd_stats(
        *(jnp.asarray(a) for a in (q, kc, vc, L)), interpret=True))
    want = (jo, jm[..., 0], jl[..., 0])
    plain = [a[0].numpy() for a in fd.flash_decode_stats_plain(t(q), k_t, v_t, t(L))]
    for p, w in zip(plain, want):
        np.testing.assert_allclose(p, w, **TOL)
    live = L > 0
    for min_tiles in (1, fd.APPEND_MIN_TILES, fd.MIN_SPLIT_TILES):
        for cluster in range(1, fd.MAX_SPLITS + 1):
            got = [a[0].numpy() for a in cluster_partials(t(q), k_t, v_t, t(L), cluster,
                                                           min_tiles)]
            msg = f"cluster={cluster} min_tiles={min_tiles}"
            for g, w, p in zip(got, want, plain):
                np.testing.assert_allclose(g[live], w[live], **TOL, err_msg=msg)
                np.testing.assert_allclose(g[live], p[live], **TOL, err_msg=msg)
            o, m, l = got
            assert np.all(o[~live] == 0) and np.all(m[~live] == -np.inf), msg
            assert np.all(l[~live] == 0), msg
            for g, w in zip(got, want):  # the reference's identity too
                assert np.array_equal(g[~live], w[~live]), msg


@pytest.mark.parametrize("cluster", [1, 2, 16])
def test_stats_cluster_of_an_empty_shard_is_the_identity(cluster):
    """Every length 0 (a shard before its first row): no range holds a row,
    so nothing merges and the partial is (0, -inf, 0) exactly."""
    rng = np.random.default_rng(cluster)
    q = t((rng.standard_normal((2, 4, 8, 64)) / 8).astype(np.float32))
    kc, vc = (t(rng.standard_normal((2, 4, 64, 64)).astype(np.float32)) for _ in range(2))
    o, m, l = cluster_partials(q, kc, vc, torch.zeros(2, dtype=torch.int32), cluster,
                               fd.APPEND_MIN_TILES)
    assert torch.all(o == 0) and torch.all(m == -torch.inf) and torch.all(l == 0)
    assert not torch.isnan(o).any()


def _paged_case(layout, ps, Hkv, rep, Dh, seed):
    rng = np.random.default_rng(seed)
    mp = 128 // ps + 1
    lens = np.array([0, 1, ps - 1, ps, ps + 1, mp * ps], np.int32)
    B, n_pages = len(lens), len(lens) * mp + 2
    shape = (n_pages, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pages, ps, Dh)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = rng.permutation(n_pages)[:B * mp].reshape(B, mp).astype(np.int32)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("layout", ["contig", "head"])
def test_paged_split_matches_the_reference(layout, ps, heads):
    Hkv, rep, Dh = heads
    q, kp, vp, table, lens = _paged_case(layout, ps, Hkv, rep, Dh, ps + Hkv + rep)
    want = np.asarray(paged_flash_decode_walk(*(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
                                              contig=layout == "contig", interpret=True))
    args = (t(q), t(kp), t(vp), t(table), t(lens), layout)
    plain = pd.paged_decode_plain(*args).numpy()
    live = lens > 0
    np.testing.assert_allclose(plain[live], want[live], **TOL)
    for min_tiles in (1, fd.APPEND_MIN_TILES):
        for splits in range(1, 9):
            got = paged_split(*args, splits, min_tiles).numpy()
            msg = f"splits={splits} min_tiles={min_tiles}"
            np.testing.assert_allclose(got[live], want[live], **TOL, err_msg=msg)
            np.testing.assert_allclose(got, plain, **TOL, err_msg=msg)
            assert np.all(got[~live] == 0), msg


def wo_walk(ctx, wo: QWeight, x):
    """Kernel 16's Wo launch in torch: the decode-row walk at one row over
    the f32 context [1, K], each G 32 group's dot of the codes scaled once
    and the groups summed (the gate's forms: Q4_0, Q8_0), x added, y
    rounded once to x's type."""
    codes = wo.codes().float() - (8.0 if wo.kind == "q4_0" else 0.0)  # [N, K]
    N, K = codes.shape
    dots = torch.einsum("gk,ngk->ng", ctx.reshape(K // 32, 32), codes.reshape(N, K // 32, 32))
    return (x.float() + (dots * wo.scales).sum(-1)).to(x.dtype)


def kernel16(x, q, k_new, v_new, k_cache, v_cache, lengths, wo: QWeight, splits: int,
             min_tiles: int = fd.APPEND_MIN_TILES):
    """Kernel 16's two launches in torch (caches updated in place): the tile
    walk with q scaled in q's type into an f32 context, then Wo's walk."""
    H, Dh = q.shape[2:]
    S = k_cache.shape[2]
    L = lengths.long().clamp(1, S)
    k_cache[0, :, L[0] - 1] = k_new[0, 0].to(k_cache.dtype)
    v_cache[0, :, L[0] - 1] = v_new[0, 0].to(v_cache.dtype)
    qs = (q[0, 0] * fd._q_scale(q)).float().reshape(1, H, 1, Dh)
    begin, end = fd._split_ranges(L, S, splits, min_tiles)
    o, m, l = fd.range_stats(qs, k_cache.float(), v_cache.float(), begin, end)
    num, _, den = _merge_live(o, m, l, begin < end)
    ctx = num / den[..., None]
    return wo_walk(ctx.reshape(1, H * Dh), wo, x.reshape(1, -1)).reshape(x.shape)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("len_old", [0, 37, 255, 511])
def test_kernel16_walks_match_the_pallas_attn_out(len_old, kind):
    rng = np.random.default_rng(len_old + 50)
    H, Dh, S, D = 2, 128, 512, 256
    w = (rng.standard_normal((H * Dh, D)) * 0.05).astype(np.float32)
    if kind == "q4_0":
        jwo, pwo = jax_q4(w)
        jwo = j_qw.q4_packed_to_i4(jwo)
    else:
        jwo = j_qw.quantize_array(w, "q8_0")
        pwo = QWeight.from_jax("q8_0", np.asarray(jwo.qs), np.asarray(jwo.scales), None)
    x, q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                    for s in ((1, 1, D), (1, 1, H, Dh), (1, 1, H, Dh), (1, 1, H, Dh)))
    kc, vc = (rng.standard_normal((1, H, S, Dh)).astype(np.float32) for _ in range(2))
    lengths = np.array([len_old + 1], np.int32)
    want, jk, jv = (np.asarray(a) for a in j_fused_attn_out(
        *(jnp.asarray(a) for a in (x, q, kn, vn, kc, vc, lengths)), jwo, interpret=True))
    assert fd.decode_splits(1, H, S, H100_SMS, fd.APPEND_MIN_TILES) == 8
    for splits in range(1, 9):
        tk, tv = t(kc), t(vc)
        got = kernel16(t(x), t(q), t(kn), t(vn), tk, tv, t(lengths), pwo, splits).numpy()
        np.testing.assert_array_equal(tk.numpy(), jk)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"splits={splits}")


@pytest.mark.parametrize("B, Hkv, rows, want", [
    (1, 32, 2048, 8),   # a paged server with one live 7B request: ranges of 2 tiles
    (1, 4, 2048, 16),   # a TinyLlama-width model's 4 KV heads
    (2, 32, 512, 4),
    (8, 32, 2048, 4),   # 8 slots of the 7B: 256 pairs fill the SMs, ragged lengths
    (5, 32, 2048, 4),   # 160 pairs
    (8, 32, 128, 2),    # 4 tiles: two ranges of the floor
    (9, 32, 2048, 1),   # 288 pairs: deeper than BLOCKS_PER_SM an SM
    (1, 32, 64, 1),     # one chunk of rows: no room for a second range
    (8, 32, 64, 1),
])
def test_paged_splits(B, Hkv, rows, want):
    assert pd.paged_splits(B, Hkv, rows, H100_SMS) == want


def test_paged_splits_rules():
    """Kernel 3's count where the pairs leave SMs idle; FULL_SPLITS where
    one block a pair fills the SMs at most BLOCKS_PER_SM deep; 1 above;
    never a range of the table's rows under the floor; no tensor
    argument."""
    for B in (1, 2, 3, 8, 9, 33):
        for Hkv in (1, 2, 4, 8, 32):
            for rows in (16, 128, 512, 2048, 4096):
                splits = pd.paged_splits(B, Hkv, rows, H100_SMS)
                pairs = B * Hkv
                assert 1 <= splits <= fd.MAX_SPLITS
                if pairs < H100_SMS:
                    assert splits == fd.decode_splits(B, Hkv, rows, H100_SMS,
                                                      fd.APPEND_MIN_TILES)
                else:
                    assert splits <= pd.FULL_SPLITS
                if pairs > fd.BLOCKS_PER_SM * H100_SMS:
                    assert splits == 1
                if splits > 1:  # each range of the table's rows at least the floor
                    assert -(-(-(-rows // 32)) // splits) >= fd.APPEND_MIN_TILES
    with pytest.raises(TypeError):  # lengths live on the card: never read on the host
        pd.paged_splits(torch.tensor(1), 32, 2048, H100_SMS)


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    q, kp, vp, table, lens = _paged_case("contig", 16, 2, 4, 64, 3)
    args = (t(q), t(kp), t(vp), t(table), t(lens), "contig")
    before = (dict(pd.launches), dict(fd.launches))
    out = pd.paged_decode(*args)
    qs, k_t, v_t, L = _stats_case(2, 4, 64, True, 5)
    stats = fd.flash_decode_stats(t(qs), k_t, v_t, t(L))
    assert (pd.launches, fd.launches) == before
    assert torch.equal(out, pd.paged_decode_plain(*args))
    for a, b in zip(stats, fd.flash_decode_stats_plain(t(qs), k_t, v_t, t(L))):
        assert torch.equal(a, b)
