"""Kernels 8 and 10 on kernel 3's tile walk over int8 rows, on the CPU.

The kernels (csrc/decode_tiles.cuh with DenseRows8 / PagedRows8,
instanced by csrc/kv_int8.cu and csrc/paged_int8.cu) cannot run here, so
their functions are repeated in torch:

  - kernel 8 (`int8_split`): each live sequence's new K and V rows
    quantized (the codec, bit for bit `update_kv_cache_int8`'s) and
    written at row min(L, S) - 1 of the cache, the same codes and rounded
    scale put into the tile in place of that row, every other row of the
    tile the cache's codes times their scales (exact in f32); then the
    split ranges and block 0's merge in split order (`split_merge` of
    tests/test_torch_decode_split.py); a length of 0 writes nothing and
    gives zeros (no clamp to one row, unlike kernel 3);
  - kernel 10 (`paged_int8_split`): the table's pages dequantized the same
    way, then kernel 5's ranges and merge (`paged_split` of
    tests/test_torch_decode_tiles.py), zeros for a length of 0.

Each is held, at every split count from 1 to 16 and floors of 1, 2 and 4
tiles, to the JAX package's XLA path (`attend_cache_int8` after
`update_kv_cache_int8`; `attend_paged_layer_int8`) within atol 3e-5 and
rtol 1e-4 (f32 attention over the same dequantized values, summed in
another order), and once to the Pallas kernels in interpret mode
(`flash_decode_int8`; `paged_flash_decode_int8_walk` and
`paged_flash_decode_int8`) within 3e-2: they also quantize the query and
the probabilities to int8 (ROADMAP Queue 3).  Lengths 0, 1, 31, 32, 33
and the cache's rows; pages of 16 and 64 rows in both pool layouts; head
dims 64 (a TinyLlama-width model's 4 KV heads x 8 queries) and 128.

Beside them: code x scale is exact in f32 for every code and every scale
the codec can store, and the kernels' widening (a byte permute into
2^23's mantissa, then 2^23 + 128 taken off) gives every code back; the
split counts, kernel 3's rule at one block an SM for kernel 8 and kernel
5's with 2 splits where the pairs fill the SMs for kernel 10, come from
the host's integers; CPU tensors run the plain versions and count no
launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops import kvquant as jk
from tokenhawk_tpu.ops.pallas.flash_decode_int8 import flash_decode_int8 as j_flash_decode_int8
from tokenhawk_tpu.ops.pallas.paged_decode_int8 import (
    paged_flash_decode_int8,
    paged_flash_decode_int8_walk,
)
from tokenhawk_tpu.runtime import paged as jp
from tokenhawk_tpu_torch.ops import kvquant as tk
from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi

from test_torch_decode_split import split_merge
from test_torch_decode_tiles import paged_split
from torch_helpers import t

TOL = dict(atol=3e-5, rtol=1e-4)
PALLAS_TOL = dict(atol=3e-2, rtol=3e-2)
# (Hkv, rep, Dh): a TinyLlama-width model's heads, then few wide ones.
HEADS = [(4, 8, 64), (2, 1, 128)]
FLOORS = (1, fd.APPEND_MIN_TILES, fd.MIN_SPLIT_TILES)
H100_SMS = 132
S = 128
LENGTHS = [0, 1, 31, 32, 33, S]


def int8_split(q, k_new, v_new, cache, lengths, splits: int, min_tiles: int):
    """Kernel 8's walk in torch (the int8 cache [codes, scales] x (K, V)
    updated in place; see the module docstring)."""
    k, ks, v, vs = cache
    S_ = k.shape[2]
    L = lengths.long().clamp(0, S_)
    live = L > 0
    bi, at = torch.arange(q.shape[0])[live], L[live] - 1
    tiles = []
    for codes, scales, new in ((k, ks, k_new), (v, vs, v_new)):
        tile = tk.dequantize_kv(codes, scales)  # the rows the copies bring in
        c, s = tk.quantize_kv_block(new[live])
        codes[bi, :, at] = c  # the cache write
        scales[bi, :, at] = s
        tile[bi, :, at] = tk.dequantize_kv(c, s)  # the same codes and rounded scale
        tiles.append(tile)
    out = split_merge(q, *tiles, lengths, splits, min_tiles)
    return torch.where(live[:, None, None, None], out, torch.zeros_like(out))


def paged_int8_split(q, pool, table, lengths, layout, splits: int, min_tiles: int):
    """Kernel 10's walk in torch: the pools' codes times their scales, then
    kernel 5's split form."""
    k, ks, v, vs = pool
    return paged_split(q, tk.dequantize_kv(k, ks), tk.dequantize_kv(v, vs), table, lengths,
                       layout, splits, min_tiles)


def _quantized(rng, shape):
    """Random rows through the JAX codec: (int8 codes, f32 scales) in numpy."""
    codes, scales = jk.quantize_kv_block(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    return np.asarray(codes), np.asarray(scales.astype(jnp.float32))


def _dense_case(Hkv, rep, Dh, seed):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    kn, vn = (rng.standard_normal((B, Hkv, Dh)).astype(np.float32) for _ in range(2))
    cache = [*_quantized(rng, (B, Hkv, S, Dh)), *_quantized(rng, (B, Hkv, S, Dh))]
    return q, kn, vn, cache, np.asarray(LENGTHS, np.int32)


def _torch_cache(cache):
    k, ks, v, vs = cache
    return [t(k), t(ks).bfloat16(), t(v), t(vs).bfloat16()]


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
def test_int8_walk_matches_the_reference(heads):
    Hkv, rep, Dh = heads
    q, kn, vn, cache, L = _dense_case(Hkv, rep, Dh, Hkv * 10 + rep)
    live = L > 0
    # The JAX package: the append of the live sequences, then the XLA path.
    jcache = jk.update_kv_cache_int8(
        *(jnp.asarray(c[live]) if c.dtype == np.int8 else jnp.asarray(c[live], jnp.bfloat16)
          for c in cache),
        jnp.asarray(kn[live][:, None]), jnp.asarray(vn[live][:, None]), jnp.asarray(L[live] - 1))
    B_live, H = int(live.sum()), Hkv * rep
    want = np.asarray(jk.attend_cache_int8(jnp.asarray(q[live].reshape(B_live, 1, H, Dh)),
                                           *jcache, jnp.asarray(L[live] - 1)[:, None],
                                           scale=1.0)).reshape(B_live, Hkv, rep, Dh)
    want_cache = [np.asarray(c.astype(jnp.float32)) for c in jcache]
    pallas = np.asarray(j_flash_decode_int8(jnp.asarray(q[live]), *jcache,
                                            jnp.asarray(L[live]), interpret=True))
    plain_cache = _torch_cache(cache)
    plain = ki.flash_decode_int8_plain(t(q), t(kn), t(vn), *plain_cache, t(L)).numpy()
    np.testing.assert_allclose(plain[live], want, **TOL)
    for min_tiles in FLOORS:
        for splits in range(1, fd.MAX_SPLITS + 1):
            msg = f"splits={splits} min_tiles={min_tiles}"
            tc = _torch_cache(cache)
            got = int8_split(t(q), t(kn), t(vn), tc, t(L), splits, min_tiles).numpy()
            np.testing.assert_allclose(got[live], want, **TOL, err_msg=msg)
            np.testing.assert_allclose(got[live], plain[live], **TOL, err_msg=msg)
            assert np.all(got[~live] == 0), msg
            for a, w, p, c in zip(tc, want_cache, plain_cache, cache):
                # The append bit for bit: update_kv_cache_int8's on the live
                # sequences, nothing on a length of 0; the plain version's.
                np.testing.assert_array_equal(a[live].float().numpy(), w, err_msg=msg)
                np.testing.assert_array_equal(a[~live].float().numpy(),
                                              c[~live].astype(np.float32), err_msg=msg)
                assert torch.equal(a, p), msg
            np.testing.assert_allclose(got[live], pallas, **PALLAS_TOL, err_msg=msg)


def _paged_case(layout, ps, Hkv, rep, Dh, seed):
    rng = np.random.default_rng(seed)
    mp = 128 // ps + 1
    lens = np.array(sorted({0, 1, 31, 32, 33, ps - 1, ps + 1, mp * ps}), np.int32)
    B, n_pages = len(lens), len(lens) * mp + 2
    shape = (n_pages, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pages, ps, Dh)
    pool = [*_quantized(rng, shape), *_quantized(rng, shape)]
    table = rng.permutation(n_pages)[:B * mp].reshape(B, mp).astype(np.int32)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    return q, pool, table, lens


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("layout", ["contig", "head"])
def test_paged_int8_walk_matches_the_reference(layout, ps, heads, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    Hkv, rep, Dh = heads
    q, pool, table, lens = _paged_case(layout, ps, Hkv, rep, Dh, ps + Hkv + rep)
    B, H = len(lens), Hkv * rep
    live = lens > 0
    jpool = [jnp.asarray(a) for a in pool]
    want = np.asarray(jp.attend_paged_layer_int8(
        jnp.asarray(q.reshape(B, 1, H, Dh)), *jpool, jnp.asarray(table), jnp.asarray(lens),
        scale=1.0)).reshape(B, Hkv, rep, Dh)
    tpool = [t(a) for a in pool]
    args = (t(q), *tpool, t(table), t(lens), layout)
    plain = pi.paged_decode_int8_plain(*args).numpy()
    np.testing.assert_allclose(plain[live], want[live], **TOL)
    for min_tiles in FLOORS:
        for splits in range(1, fd.MAX_SPLITS + 1):
            msg = f"splits={splits} min_tiles={min_tiles}"
            got = paged_int8_split(t(q), tpool, t(table), t(lens), layout, splits,
                                   min_tiles).numpy()
            np.testing.assert_allclose(got[live], want[live], **TOL, err_msg=msg)
            np.testing.assert_allclose(got, plain, **TOL, err_msg=msg)
            assert np.all(got[~live] == 0), msg
    for fn in (paged_flash_decode_int8_walk, paged_flash_decode_int8):
        pallas = np.asarray(fn(jnp.asarray(q), *jpool, jnp.asarray(table), jnp.asarray(lens),
                               contig=layout == "contig", interpret=True))
        np.testing.assert_allclose(got[live], pallas[live], **PALLAS_TOL, err_msg=fn.__name__)


def _codec_scales():
    """Every scale the codec can store, as f32: the non-negative bfloat16
    values up to its scale of a row whose largest |value| is f32's largest
    (amax / 127 rounded to bfloat16), dense (bf16) or paged (f32)."""
    top = tk.quantize_kv_block(torch.full((1, 128), float(np.finfo(np.float32).max)))[1]
    bits = np.arange(0x7F80, dtype=np.uint32)  # every finite non-negative bfloat16
    scales = (bits << 16).view(np.float32)
    return scales[scales <= top.float().item()]


def test_code_times_scale_is_exact_in_f32():
    scales = _codec_scales()
    assert scales[1] > 0 and scales.max() > 2e36 and len(scales) > 31000
    for code in range(-127, 128):
        got = np.float32(code) * scales  # f32 products, as the walk forms them
        exact = np.float64(code) * scales.astype(np.float64)
        assert np.array_equal(got.astype(np.float64), exact), code


def test_the_widening_gives_every_code_back():
    """kv_int8.cuh widen1: the stored byte b with its sign bit flipped,
    under 0x4B00_0000 (2^23's exponent), read as f32, less 2^23 + 128."""
    b = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | (b ^ np.uint32(0x80))).view(np.float32)
    widened = f - np.float32(8388736.0)
    assert widened.dtype == np.float32
    assert np.array_equal(widened, b.astype(np.uint8).view(np.int8).astype(np.float32))


@pytest.mark.parametrize("B, Hkv, S_, want", [
    (1, 32, 2048, 4),   # LLaMA-7B's heads at B=1: one block an SM, clusters of 4
    (1, 32, 512, 4),
    (1, 4, 2048, 16),   # TinyLlama's 4 KV heads: as kernel 3
    (4, 32, 512, 1),    # 128 pairs: one block an SM already
    (8, 32, 2048, 1),   # the pairs fill the SMs
    (1, 32, 32, 1),     # one tile
])
def test_kernel_8_split_count(B, Hkv, S_, want):
    """Kernel 3's rule at one block an SM, from the host's shapes alone."""
    assert ki.decode_int8_splits(B, Hkv, S_, H100_SMS) == want
    assert want == fd.decode_splits(B, Hkv, S_, H100_SMS, fd.APPEND_MIN_TILES,
                                    ki.INT8_BLOCKS_PER_SM)


@pytest.mark.parametrize("B, Hkv, rows, want", [
    (8, 32, 2048, 2),   # the paged server's 8 slots: 256 pairs, INT8_FULL_SPLITS
    (5, 32, 2048, 2),   # 160 pairs
    (9, 32, 2048, 1),   # 288 pairs: deeper than two an SM
    (1, 32, 2048, 8),   # one live request: kernel 5's (kernel 3's) rule
    (8, 4, 2048, 8),    # TinyLlama's heads over 8 slots
])
def test_kernel_10_split_count(B, Hkv, rows, want):
    """Kernel 5's rule with INT8_FULL_SPLITS where the pairs fill the SMs
    at most two deep."""
    assert pi.paged_int8_splits(B, Hkv, rows, H100_SMS) == want
    assert want == pd.paged_splits(B, Hkv, rows, H100_SMS, pi.INT8_FULL_SPLITS)


def test_split_counts_are_the_hosts_integers():
    """Lengths live on the card: neither rule reads a tensor."""
    for bad in ((torch.tensor(1), 32, 2048, H100_SMS), (1, 32, torch.tensor(2048), H100_SMS)):
        with pytest.raises(TypeError):
            ki.decode_int8_splits(*bad)
        with pytest.raises(TypeError):
            pi.paged_int8_splits(*bad)


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    q, kn, vn, cache, L = _dense_case(2, 4, 64, 3)
    before = (dict(ki.launches), dict(pi.launches))
    a, b = _torch_cache(cache), _torch_cache(cache)
    got = ki.flash_decode_int8(t(q), t(kn), t(vn), *a, t(L))
    want = ki.flash_decode_int8_plain(t(q), t(kn), t(vn), *b, t(L))
    assert torch.equal(got, want) and all(torch.equal(x, y) for x, y in zip(a, b))
    qp, pool, table, lens = _paged_case("head", 16, 2, 4, 64, 5)
    args = (t(qp), *(t(x) for x in pool), t(table), t(lens), "head")
    assert torch.equal(pi.paged_decode_int8(*args), pi.paged_decode_int8_plain(*args))
    assert (ki.launches, pi.launches) == before
