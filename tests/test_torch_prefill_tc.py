"""A CPU rehearsal of the tensor-core walk of kernels 4 and 9 (csrc/prefill_tc.cuh).

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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops.pallas.flash_attention import attend_prefill
from tokenhawk_tpu.ops.pallas.flash_attention_int8 import attend_prefill_int8
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

from torch_helpers import t

KERNEL_TOL = 2.0**-7
KEYS, WARP_ROWS = 64, 16  # a K/V tile; the rows of one mma (one warp)
B, HKV, S = 2, 2, 256


def _warp(qw, pos, w_first, w_last, wkey, nk, n_tiles, block_last, kh, vh, ksh, vsh):
    """One warp's online softmax over keys [wkey, wkey + nk) of each tile:
    its (m, l, o) for its 16 rows."""
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
        o = o * alpha[:, None] + p.bfloat16().float() @ vt
    return m, l, o


def walk(q, k, v, offsets, ks=None, vs=None):
    """The walk's function: q [B, Hkv, rep, T, Dh] bf16 (pre-scaled), k / v
    [B, Hkv, S, Dh] bf16 or int8 codes with ks / vs [B, Hkv, S] bf16 scales,
    offsets [B] -> out [B, Hkv, rep, T, Dh] bf16."""
    Bq, Hkv, rep, T, Dh = q.shape
    S = k.shape[2]
    N = T * rep
    split = N <= WARP_ROWS
    block = WARP_ROWS if split else 4 * WARP_ROWS
    out = torch.zeros_like(q)
    for b in range(Bq):
        off = int(offsets[b])
        for h in range(Hkv):
            rows = q[b, h].transpose(0, 1).reshape(N, Dh).float()  # row i = (i // rep, i % rep)
            kv = (k[b, h].float(), v[b, h].float(),
                  ks[b, h].float() if ks is not None else None,
                  vs[b, h].float() if vs is not None else None)
            res = torch.zeros(N, Dh)
            for i0 in range(0, N, block):
                last_row = min(i0 + block, N) - 1
                block_last = min(off + last_row // rep, S - 1)  # the block's last key
                n_tiles = block_last // KEYS + 1
                for w0 in range(i0, last_row + 1, WARP_ROWS):
                    n = min(WARP_ROWS, N - w0)
                    pos = off + torch.arange(w0, w0 + WARP_ROWS) // rep
                    w_first, w_last = off + w0 // rep, off + (w0 + n - 1) // rep
                    qw = torch.zeros(WARP_ROWS, Dh)
                    qw[:n] = rows[w0:w0 + n]
                    # One warp over the whole tile, or (split) 4 over a quarter each.
                    subs = [(16 * w, 16) for w in range(4)] if split else [(0, KEYS)]
                    parts = [_warp(qw, pos, w_first, w_last, wk, nk, n_tiles, block_last, *kv)
                             for wk, nk in subs]
                    m = torch.stack([x[0] for x in parts])
                    mx = m.amax(0)
                    f = torch.exp(m - mx)  # 0 for a warp that saw no key of the row
                    den = (torch.stack([x[1] for x in parts]) * f).sum(0)
                    num = (torch.stack([x[2] for x in parts]) * f[..., None]).sum(0)
                    res[w0:w0 + n] = (num / torch.where(den > 0, den, 1.0)[:, None])[:n]
            out[b, h] = res.reshape(T, rep, Dh).transpose(0, 1).bfloat16()
    return out


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
