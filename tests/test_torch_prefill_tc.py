"""A CPU rehearsal of the tensor-core walk of kernels 4, 9 and 19 (csrc/prefill_tc.cuh).

`walk` below repeats the walk's arithmetic tile by tile in torch: the
query rows of one (b, kv head) are its flattened (t, r) pairs, t major,
in blocks of 64 rows and warps of 16, or, when the head has at most 16
rows, one block of 16 rows whose 4 warps each take 16 keys of every tile
and merge their partials at the end; keys come in tiles of 64; a block
never visits the tiles past its last query position (nor loads the keys
of its last tile past it: they are zeros), and a warp skips the tiles
past its own last row.  Scores are f32 sums of bf16 products (int8 codes
are exact in bf16), times the K scale after the product for an int8
cache; keys past a row's position or past the cache's end are masked;
the softmax runs online in f32 (a row that has seen no key keeps p = 0);
P is rounded to bf16 (after the V-scale fold for an int8 cache) before
P.V, while l sums the unrounded p; out = O / l (l == 0 -> 1), rounded
once to bf16. The emulation lives here, not in the package: the kernel
cannot run on the CPU, and its plain version computes the function
without the walk's tiles and roundings.

It is held against the reference's Pallas kernels in interpret mode
(`attend_prefill`, `attend_prefill_int8`, as tests/test_torch_flash_attention.py
and tests/test_torch_kvquant.py run them) on bf16 inputs, within
KERNEL_TOL: 2^-7 of the largest |reference|, the tolerance chip_smoke.py
holds the kernels to against their plain versions.

Kernel 19 (`stats=True`) runs the same walk on f32 q over bf16 K/V
blocks: the mask is kernel 4's with off = floor((q_start - k_start) /
stride) per sequence (negative when the query shard precedes the block:
a block whose last row sees no key loads nothing and writes the
identity); q and P are each split into three bf16 parts, hi = bf16(x),
mid = bf16(x - hi), lo = bf16(x - hi - mid), S = q_hi.K^T + (q_mid.K^T +
q_lo.K^T) and O += P_hi.V + P_mid.V + P_lo.V, l summing the unsplit p;
the partials (o, m, l) are written as they stand, a row that saw no key
as (0, _MASK, 0).  It is held against the Pallas `flash_attention_stats`
in interpret mode (as tests/test_torch_ring.py runs it) on the rows that
see a key, within PARTIALS_TOL (atol / rtol 1e-5, that file's), and its
rows with no visible key must be exactly (0, _MASK, 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops.pallas.flash_attention import attend_prefill
from tokenhawk_tpu.ops.pallas.flash_attention import flash_attention_stats as j_fa_stats
from tokenhawk_tpu.ops.pallas.flash_attention_int8 import attend_prefill_int8
from tokenhawk_tpu_torch.ops.cuda import flash_attention
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block
from tokenhawk_tpu_torch.parallel.ring import _MASK

from torch_helpers import t

KERNEL_TOL = 2.0**-7
PARTIALS_TOL = dict(atol=1e-5, rtol=1e-5)
KEYS, WARP_ROWS = 64, 16  # a K/V tile; the rows of one mma (one warp)
B, HKV, S = 2, 2, 256


def _split(x):
    """x as the sum of three bf16 values (hi, mid, lo), each in f32."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _warp(qw, pos, w_first, w_last, wkey, nk, n_tiles, block_last, kh, vh, ksh, vsh,
          stats=False):
    """One warp's online softmax over keys [wkey, wkey + nk) of each tile:
    its (m, l, o) for its 16 rows (stats: q and P split in three parts)."""
    S, Dh = kh.shape
    m = torch.full((WARP_ROWS,), -torch.inf)
    l = torch.zeros(WARP_ROWS)
    o = torch.zeros(WARP_ROWS, Dh)
    for tile in range(n_tiles):
        key0 = tile * KEYS + wkey
        if key0 > w_last:
            continue  # past every row of this warp
        keys = torch.arange(key0, key0 + nk)
        live = keys <= block_last  # the rest is zero-filled
        kt = torch.zeros(nk, Dh)
        vt = torch.zeros(nk, Dh)
        kt[live], vt[live] = kh[keys[live]], vh[keys[live]]
        if stats:
            q_hi, q_mid, q_lo = _split(qw)
            s = q_hi @ kt.T + (q_mid @ kt.T + q_lo @ kt.T)
        else:
            s = qw @ kt.T
        if ksh is not None:
            s = s * torch.where(live, ksh[keys.clamp(max=S - 1)], 0.0)
        if key0 + nk - 1 > w_first:  # crosses a row (the block's last tile too)
            s = s.masked_fill((keys[None] > pos[:, None]) | (keys[None] >= S), -torch.inf)
        m_new = torch.maximum(m, s.amax(1))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)  # a row that saw no key yet
        alpha = torch.exp(m - base)
        p = torch.exp(s - base[:, None])
        l = l * alpha + p.sum(1)
        m = m_new
        if vsh is not None:
            p = p * torch.where(live, vsh[keys.clamp(max=S - 1)], 0.0)
        if stats:
            p_hi, p_mid, p_lo = _split(p)
            o = o * alpha[:, None] + p_hi @ vt + p_mid @ vt + p_lo @ vt
        else:
            o = o * alpha[:, None] + p.bfloat16().float() @ vt
    return m, l, o


def stats_offsets(q_start, k_start, stride: int):
    """Kernel 19's per-sequence offset: key j is visible to query t iff
    k_start + stride*j <= q_start + stride*t, i.e. j <= t + off."""
    return [(int(a) - int(b)) // stride for a, b in zip(q_start, k_start)]


def walk(q, k, v, offsets, ks=None, vs=None, stats=False):
    """The walk's function: q [B, Hkv, rep, T, Dh] bf16 (pre-scaled), k / v
    [B, Hkv, S, Dh] bf16 or int8 codes with ks / vs [B, Hkv, S] bf16 scales,
    offsets [B] -> out [B, Hkv, rep, T, Dh] bf16.  stats (kernel 19): q f32,
    bf16 k / v, offsets from stats_offsets -> the partials (o [B, Hkv, rep,
    T, Dh], m, l [B, Hkv, rep, T]) in f32."""
    Bq, Hkv, rep, T, Dh = q.shape
    S = k.shape[2]
    N = T * rep
    split = N <= WARP_ROWS
    block = WARP_ROWS if split else 4 * WARP_ROWS
    out = torch.zeros_like(q)
    m_out = torch.zeros(Bq, Hkv, rep, T)
    l_out = torch.zeros(Bq, Hkv, rep, T)
    for b in range(Bq):
        off = int(offsets[b])
        for h in range(Hkv):
            rows = q[b, h].transpose(0, 1).reshape(N, Dh).float()  # row i = (i // rep, i % rep)
            kv = (k[b, h].float(), v[b, h].float(),
                  ks[b, h].float() if ks is not None else None,
                  vs[b, h].float() if vs is not None else None)
            res = torch.zeros(N, Dh)
            res_m = torch.full((N,), _MASK)
            res_l = torch.zeros(N)
            for i0 in range(0, N, block):
                last_row = min(i0 + block, N) - 1
                block_last = min(off + last_row // rep, S - 1)  # the block's last key
                if block_last < 0:  # (stats) no row sees a key: the identity, nothing loaded
                    continue
                n_tiles = block_last // KEYS + 1
                for w0 in range(i0, last_row + 1, WARP_ROWS):
                    n = min(WARP_ROWS, N - w0)
                    pos = off + torch.arange(w0, w0 + WARP_ROWS) // rep
                    w_first, w_last = off + w0 // rep, off + (w0 + n - 1) // rep
                    qw = torch.zeros(WARP_ROWS, Dh)
                    qw[:n] = rows[w0:w0 + n]
                    # One warp over the whole tile, or (split) 4 over a quarter each.
                    subs = [(16 * w, 16) for w in range(4)] if split else [(0, KEYS)]
                    parts = [_warp(qw, pos, w_first, w_last, wk, nk, n_tiles, block_last, *kv,
                                   stats=stats) for wk, nk in subs]
                    m = torch.stack([x[0] for x in parts])
                    mx = m.amax(0)
                    # 0 for a warp that saw no key of the row (and, stats, for every
                    # warp of a row none saw)
                    f = torch.where(torch.isinf(m), 0.0, torch.exp(m - mx))
                    den = (torch.stack([x[1] for x in parts]) * f).sum(0)
                    num = (torch.stack([x[2] for x in parts]) * f[..., None]).sum(0)
                    if stats:
                        res[w0:w0 + n] = num[:n]
                        res_m[w0:w0 + n] = torch.where(torch.isinf(mx), _MASK, mx)[:n]
                        res_l[w0:w0 + n] = den[:n]
                    else:
                        res[w0:w0 + n] = (num / torch.where(den > 0, den, 1.0)[:, None])[:n]
            if stats:
                out[b, h] = res.reshape(T, rep, Dh).transpose(0, 1)
                m_out[b, h] = res_m.reshape(T, rep).T
                l_out[b, h] = res_l.reshape(T, rep).T
            else:
                out[b, h] = res.reshape(T, rep, Dh).transpose(0, 1).bfloat16()
    return (out, m_out, l_out) if stats else out


def _bf16(a):
    return t(a).bfloat16()


def _jax_bf16(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _to_bthd(x):
    """[B, Hkv, rep, T, Dh] -> [B, T, Hkv * rep, Dh], the wrappers' layout."""
    Bq, Hkv, rep, T, Dh = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(Bq, T, Hkv * rep, Dh)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("offset", [0, 100])
@pytest.mark.parametrize("T", [5, 13, 64])
def test_walk_matches_pallas(T, offset, rep, Dh, cache):
    rng = np.random.default_rng(T * 1000 + offset * 10 + rep + Dh)
    q = _bf16(rng.standard_normal((B, HKV, rep, T, Dh)) / Dh**0.5)  # pre-scaled
    offsets = np.array([offset, offset // 3], np.int32)
    positions = jnp.asarray(offsets[:, None] + np.arange(T, dtype=np.int32)[None])
    kx = rng.standard_normal((B, HKV, S, Dh)).astype(np.float32)
    vx = rng.standard_normal((B, HKV, S, Dh)).astype(np.float32)
    qj = _jax_bf16(_to_bthd(q))
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv_block(t(kx)), quantize_kv_block(t(vx))
        got = walk(q, k, v, offsets, ks, vs)
        want = attend_prefill_int8(qj, jnp.asarray(k.numpy()), _jax_bf16(ks),
                                   jnp.asarray(v.numpy()), _jax_bf16(vs), positions, 1.0,
                                   interpret=True)
    else:
        k, v = _bf16(kx), _bf16(vx)
        got = walk(q, k, v, offsets)
        want = attend_prefill(qj, _jax_bf16(k), _jax_bf16(v), positions, 1.0, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = _to_bthd(got).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want).max(), KERNEL_TOL * np.abs(want).max())


# Kernel 19's walk: (stride, Dh, rep, T, q_start [B], k_start [B], S).  Each
# pair of sequences mixes the offset's signs: 0 and -35 with T*rep <= 16
# (the SPLIT form); 1 and -5 over 132 rows (three 64-row blocks, the last
# ragged); 1 and -33 with 16 rows, the second sequence seeing no key at all
# (its block loads nothing); -1 (row 0 sees nothing) and 75 (every key);
# 0 and -90 (both blocks of the second sequence empty); 50 and -1 at rep 8.
STATS_CASES = [
    (1, 64, 1, 13, [0, 5], [0, 40], 128),
    (2, 128, 4, 33, [3, 0], [0, 9], 128),
    (4, 64, 2, 8, [7, 1], [2, 130], 128),
    (4, 128, 1, 70, [1, 300], [2, 0], 128),
    (1, 128, 2, 40, [0, 10], [0, 100], 64),
    (2, 64, 8, 2, [100, 0], [0, 1], 64),
]


@pytest.mark.parametrize("stride,Dh,rep,T,q_start,k_start,S_", STATS_CASES,
                         ids=[f"stride{c[0]}-dh{c[1]}-rep{c[2]}-T{c[3]}" for c in STATS_CASES])
def test_stats_walk_matches_pallas(stride, Dh, rep, T, q_start, k_start, S_):
    rng = np.random.default_rng(stride * 100 + T + rep)
    q = (rng.standard_normal((B, HKV, rep, T, Dh)) / Dh**0.5).astype(np.float32)
    k = _bf16(rng.standard_normal((B, HKV, S_, Dh)))  # K/V blocks in the cache's type
    v = _bf16(rng.standard_normal((B, HKV, S_, Dh)))
    qs, ks = np.array(q_start, np.int32), np.array(k_start, np.int32)
    offs = stats_offsets(qs, ks, stride)
    assert min(offs) < 0 and max(offs) >= 0
    o, m, l = walk(t(q), k, v, offs, stats=True)
    jo, jm, jl = (np.asarray(a) for a in j_fa_stats(
        jnp.asarray(q), jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy()),
        jnp.asarray(qs), jnp.asarray(ks), stride=stride, interpret=True))
    jm, jl = jm[..., 0], jl[..., 0]
    # A row sees a key iff key 0 is visible to it: k_start <= q_start + stride*t.
    qpos = qs[:, None] + stride * np.arange(T)
    seen = np.broadcast_to((ks[:, None] <= qpos)[:, None, None], m.shape)
    assert seen.any() and not seen.all()
    o, m, l = o.numpy(), m.numpy(), l.numpy()
    np.testing.assert_allclose(o[seen], jo[seen], **PARTIALS_TOL)
    np.testing.assert_allclose(m[seen], jm[seen], **PARTIALS_TOL)
    np.testing.assert_allclose(l[seen], jl[seen], **PARTIALS_TOL)
    mask = np.float32(_MASK)
    assert np.all(o[~seen] == 0.0) and np.all(m[~seen] == mask) and np.all(l[~seen] == 0.0)
    assert np.all(jm[~seen] == mask)
    # The plain version (kernel 19's on the CPU) gives the same partials.
    po, pm, pl = (a.numpy() for a in flash_attention.flash_attention_stats_plain(
        t(q), k.float(), v.float(), t(qs), t(ks), stride))
    for got, want in ((o, po), (m, pm), (l, pl)):
        np.testing.assert_allclose(got, want, **PARTIALS_TOL)
