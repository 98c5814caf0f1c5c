"""Kernel 14's split form (csrc/flash_decode.cu decode_split_kernel) on the CPU.

The kernel cannot run here, so `split_merge` repeats its function in
torch: kernel 18's partials over the tile-aligned ranges `_split_ranges`
cuts from the live lengths (clamped to [1, S], as kernel 14 clamps them;
each range at least min_tiles tiles), an empty range giving the merge
identity (0, -inf, 0), then the merge in
the kernel's order: the max of m over the splits, each split's o and l
weighted by exp(m - max) and summed in split order, one division.  It is
held against the reference's `flash_decode_dma` in Pallas interpret mode
and against `flash_decode_plain` at every split count from 1 to 16 (with
ranges of at least 1, 2 and MIN_SPLIT_TILES tiles), over
lengths 1, 31, 32, 33 and S (ranges that are empty, one row, one tile,
one row past a tile, whole), at a TinyLlama-width draft's heads (4 KV
heads of 64, 8 queries each) and at 2 KV heads of 128, one query each:
f32, one function summed in other orders, within atol 3e-5 and rtol 1e-4
(the reference's own decode tolerance).

Kernel 3's split form (csrc/decode_append.cu decode_append_tiles_kernel
with SPLIT) appends the new row, then takes the same ranges and merge:
`append_split_merge` writes k_new / v_new at row clamp(lengths, 1, S) - 1
as the block whose range holds that row does, then runs `split_merge`.
It is held against the reference's `flash_decode_append_walk` in Pallas
interpret mode at 1 to 8 splits, lengths 1, 37, 300 and S, at the 7B's
heads (one query a KV head, head dim 128) and the draft's: the caches
bit for bit, the output within the same tolerance.

`decode_splits`, which picks the split count on the host, is held to its
rules: 1 where B*Hkv fills the SMs, more at the draft's B=1 shape, no
range of S under MIN_SPLIT_TILES tiles, no more blocks than the card
holds at once, and no tensor argument.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops.pallas.flash_decode_dma import flash_decode_append_walk, flash_decode_dma
from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

from torch_helpers import t

S = 128
LENGTHS = [1, 31, 32, 33, S]
# (Hkv, rep, Dh): the draft's heads, then few wide ones.
HEADS = [(4, 8, 64), (2, 1, 128)]
H100_SMS = 132


def split_merge(q, k_cache, v_cache, lengths, splits: int, min_tiles: int):
    """Kernel 14's split form in torch (see the module docstring)."""
    B, Hkv, rep, Dh = q.shape
    S = k_cache.shape[2]
    live = lengths.long().clamp(1, S)
    o, m, l = fd.range_stats(q, k_cache, v_cache, *fd._split_ranges(live, S, splits, min_tiles))
    m = m.reshape(splits, B, Hkv, rep)
    l = l.reshape(splits, B, Hkv, rep)
    mx = m[0]
    for s in range(1, splits):
        mx = torch.maximum(mx, m[s])
    num, den = torch.zeros_like(o[0]), torch.zeros_like(l[0])
    for s in range(splits):
        f = torch.exp(m[s] - mx)  # 0 for an empty range
        num = num + o[s] * f[..., None]
        den = den + l[s] * f
    return (num / den[..., None]).to(q.dtype)


def append_split_merge(q, k_new, v_new, k_cache, v_cache, lengths, splits: int,
                       min_tiles: int):
    """Kernel 3's split form in torch: the append (caches updated in
    place), then split_merge over the live rows."""
    S = k_cache.shape[2]
    L = lengths.long().clamp(1, S)
    bi = torch.arange(q.shape[0])
    k_cache[bi, :, L - 1] = k_new.to(k_cache.dtype)
    v_cache[bi, :, L - 1] = v_new.to(v_cache.dtype)
    return split_merge(q, k_cache, v_cache, lengths, splits, min_tiles)


APPEND_S = 512
APPEND_LENGTHS = [1, 37, 300, APPEND_S]


@pytest.mark.parametrize("heads", [(2, 1, 128), (4, 8, 64)],
                         ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
def test_append_split_merge_matches_the_reference(heads):
    Hkv, rep, Dh = heads
    rng = np.random.default_rng(Hkv * 100 + rep)
    B = len(APPEND_LENGTHS)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    kn, vn = (rng.standard_normal((B, Hkv, Dh)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((B, Hkv, APPEND_S, Dh)).astype(np.float32) for _ in range(2))
    lengths = np.asarray(APPEND_LENGTHS, np.int32)
    want, jk, jv = (np.asarray(a) for a in flash_decode_append_walk(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc, lengths)), interpret=True))
    for splits in range(1, 9):
        for min_tiles in (1, fd.APPEND_MIN_TILES, fd.MIN_SPLIT_TILES):
            k_t, v_t = t(kc), t(vc)
            got = append_split_merge(t(q), t(kn), t(vn), k_t, v_t, t(lengths), splits, min_tiles)
            msg = f"splits={splits} min_tiles={min_tiles}"
            assert np.array_equal(k_t.numpy(), jk) and np.array_equal(v_t.numpy(), jv), msg
            np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4, err_msg=msg)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hkv{h[0]}-rep{h[1]}-dh{h[2]}")
def test_split_merge_matches_the_reference_at_every_split_count(heads):
    Hkv, rep, Dh = heads
    rng = np.random.default_rng(Hkv * 10 + rep)
    B = len(LENGTHS)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    want = np.asarray(flash_decode_dma(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(lengths), interpret=True))
    plain = fd.flash_decode_plain(t(q), t(kc), t(vc), t(lengths)).numpy()
    np.testing.assert_allclose(plain, want, atol=3e-5, rtol=1e-4)
    for min_tiles in (1, 2, fd.MIN_SPLIT_TILES):
        for splits in range(1, fd.MAX_SPLITS + 1):
            got = split_merge(t(q), t(kc), t(vc), t(lengths), splits, min_tiles).numpy()
            msg = f"splits={splits} min_tiles={min_tiles}"
            np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4, err_msg=msg)
            np.testing.assert_allclose(got, plain, atol=3e-5, rtol=1e-4, err_msg=msg)


@pytest.mark.parametrize("min_tiles", [1, fd.MIN_SPLIT_TILES])
def test_the_ranges_cover_the_live_rows_in_whole_tiles(min_tiles):
    """Every split count cuts each length into ranges that tile [0, L)
    in order, each non-empty one starting on a 32-row tile and, but for
    the one that ends at L, at least min_tiles tiles long; the empty ones
    at the end."""
    L = torch.tensor(LENGTHS + [300, 2048], dtype=torch.int32)
    for splits in range(1, fd.MAX_SPLITS + 1):
        begin, end = fd._split_ranges(L, 2048, splits, min_tiles)
        assert torch.equal(begin[0], torch.zeros_like(L).long()) and torch.equal(end[-1], L.long())
        assert torch.equal(begin[1:], end[:-1]) and bool((end >= begin).all())
        assert bool(((begin % 32 == 0) | (begin == end)).all())
        assert bool(((end - begin >= 32 * min_tiles) | (end == L.long())).all())
        empty = begin == end
        assert bool((empty[:-1] <= empty[1:]).all())


@pytest.mark.parametrize("B, Hkv, S_, want", [
    (1, 4, 2048, 16),   # the draft at B=1: 4 blocks would idle 128 SMs
    (8, 4, 2048, 8),    # the draft over 8 slots: 32 pairs, 8 splits fill the card
    (1, 32, 512, 4),    # LLaMA-7B's heads at B=1 over 512
    (8, 32, 512, 1),    # 256 pairs already fill the card: today's launch
    (5, 32, 2048, 1),
    (1, 4, 64, 1),      # 2 tiles: no room for a range of the minimum
])
def test_decode_splits(B, Hkv, S_, want):
    assert fd.decode_splits(B, Hkv, S_, H100_SMS) == want


@pytest.mark.parametrize("B, Hkv, S_, want", [
    (1, 32, 512, 8),    # kernel 3 at the 7B's heads, B=1: ranges of 2 tiles
    (1, 32, 2048, 8),   # as many as the card holds (2 blocks an SM)
    (4, 32, 512, 2),
    (8, 32, 2048, 1),   # 256 pairs: one block a pair
    (1, 32, 32, 1),     # one tile
])
def test_decode_splits_with_kernel_3s_floor(B, Hkv, S_, want):
    assert fd.decode_splits(B, Hkv, S_, H100_SMS, fd.APPEND_MIN_TILES) == want


def test_decode_splits_rules():
    for B in (1, 2, 3, 8, 33):
        for Hkv in (1, 2, 4, 8, 32):
            for S_ in (32, 100, 512, 2048, 4096):
                splits = fd.decode_splits(B, Hkv, S_, H100_SMS)
                assert 1 <= splits <= fd.MAX_SPLITS
                if B * Hkv >= H100_SMS:
                    assert splits == 1
                if splits > 1:  # each range of S at least the minimum
                    tiles = -(-S_ // 32)
                    assert -(-tiles // splits) >= fd.MIN_SPLIT_TILES
                    assert B * Hkv * splits <= fd.BLOCKS_PER_SM * H100_SMS
    assert fd.decode_splits(1, 4, 2048, H100_SMS) > 1
    with pytest.raises(TypeError):  # lengths live on the card: never read on the host
        fd.decode_splits(torch.tensor(1), 4, 2048, H100_SMS)
    with pytest.raises(TypeError):
        fd.decode_splits(1, 4, torch.tensor([2048], dtype=torch.int32), H100_SMS)


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(3)
    q = t((rng.standard_normal((1, 4, 8, 64)) / 8).astype(np.float32))
    kc, vc = (t(rng.standard_normal((1, 4, S, 64)).astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([77], dtype=torch.int32)
    before = dict(fd.launches)
    got = fd.flash_decode(q, kc, vc, lengths)
    assert fd.launches == before
    assert torch.equal(got, fd.flash_decode_plain(q, kc, vc, lengths))
