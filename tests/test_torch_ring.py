"""Kernels 18 and 19 of the port (softmax partials) and parallel/ring.py,
against the JAX package.

  - flash_decode_stats_plain, kernel 18's plain version, against the Pallas
    flash_decode_stats in interpret mode (as tests/test_flash_decode_dma.py
    runs it: Dh 128, S 256, lengths [100, 0]): partials within atol / rtol
    1e-5, and the empty sequence's merge identity (0, -inf, 0) exactly;
    its split form, merged, against the unsplit one;
  - flash_attention_stats_plain, kernel 19's plain version, against the
    Pallas flash_attention_stats(interpret=True) at strides 1 and 4 from
    nonzero q_start / k_start: rows that see a key within 1e-5; rows that
    see none carry m == _MASK on both sides (the Pallas kernel's o and l
    there depend on its tiles) and merge into a real partial without
    changing it;
  - ring_attention (block and cyclic layouts) and decode_attend_cp at 2
    and 4 ranks of a gloo group (tests/torch_dist.py), against the JAX
    package's under shard_map on as many CPU devices, built as
    tests/test_ring_attention.py builds them: atol 3e-5, rtol 1e-4 (the
    reference's own tolerance there), every rank's decode output equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tokenhawk_tpu.ops.pallas.flash_attention import flash_attention_stats as j_fa_stats
from tokenhawk_tpu.ops.pallas.flash_decode_dma import flash_decode_stats as j_fd_stats
from tokenhawk_tpu.parallel.ring import decode_attend_cp as j_decode_attend_cp
from tokenhawk_tpu.parallel.ring import ring_attention as j_ring_attention
from tokenhawk_tpu.parallel.tp import shard_map
from tokenhawk_tpu_torch.ops.cuda import flash_attention, flash_decode
from tokenhawk_tpu_torch.parallel.ring import _MASK, _merge_stats

from torch_dist import ring_worker, run_ranks
from torch_helpers import t

PARTIALS_TOL = dict(atol=1e-5, rtol=1e-5)
RING_TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_decode_stats_plain_matches_pallas(rng, dtype):
    B, Hkv, rep, S, Dh = 2, 2, 2, 256, 128
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32)
    if dtype == "bfloat16":  # the cache's type, as decode_attend_cp hands q over
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    lengths = np.array([100, 0], np.int32)
    jo, jm, jl = (np.asarray(a) for a in j_fd_stats(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(lengths),
        interpret=True))
    o, m, l = (a[0].numpy() for a in flash_decode.flash_decode_stats_plain(
        t(q, tdt), t(k, tdt), t(v, tdt), t(lengths)))
    assert o.shape == (B, Hkv, rep, Dh) and m.shape == l.shape == (B, Hkv * rep)
    np.testing.assert_allclose(o[0], jo[0], **PARTIALS_TOL)
    np.testing.assert_allclose(m[0], jm[0, :, 0], **PARTIALS_TOL)
    np.testing.assert_allclose(l[0], jl[0, :, 0], **PARTIALS_TOL)
    assert np.all(o[1] == 0.0) and np.all(m[1] == -np.inf) and np.all(l[1] == 0.0)


@pytest.mark.parametrize("splits", [2, 3, 16])
def test_decode_stats_splits_merge_to_the_unsplit_partials(rng, splits):
    """Kernel 18's split form: ranges cut at 32-row tiles, empty ranges the
    identity, merged (split 0 first, never empty for a live sequence) back
    to the one-range partials."""
    B, Hkv, rep, S, Dh = 4, 2, 4, 384, 64
    q = t((rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(np.float32))
    k, v = (t(rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)) for _ in range(2))
    lengths = t(np.array([1, 33, 300, 384], np.int32))
    whole = [a[0] for a in flash_decode.flash_decode_stats_plain(q, k, v, lengths)]
    o, m, l = flash_decode.flash_decode_stats_plain(q, k, v, lengths, splits)
    assert o.shape == (splits, B, Hkv, rep, Dh) and m.shape == (splits, B, Hkv * rep)
    assert torch.all(m[-1, 0] == -torch.inf) and torch.all(l[-1, 0] == 0)  # 1 row: 1 range
    o = o.reshape(splits, B, Hkv * rep, Dh)
    acc = (o[0], m[0], l[0])
    for i in range(1, splits):
        acc = _merge_stats(*acc, o[i], m[i], l[i])
    got = acc[0] / acc[2][..., None]
    want = whole[0].reshape(B, Hkv * rep, Dh) / whole[2][..., None]
    torch.testing.assert_close(got, want, **PARTIALS_TOL)


@pytest.mark.parametrize("stride,q_start,k_start", [(1, [64, 0], [0, 16]), (4, [3, 1], [2, 9])])
def test_attention_stats_plain_matches_pallas(rng, stride, q_start, k_start):
    B, Hkv, rep, T, S, Dh = 2, 2, 2, 32, 64, 128
    q = (rng.standard_normal((B, Hkv, rep, T, Dh)) / Dh**0.5).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    qs, ks = np.array(q_start, np.int32), np.array(k_start, np.int32)
    jo, jm, jl = (np.asarray(a) for a in j_fa_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs), jnp.asarray(ks),
        stride=stride, block_t=16, block_s=16, interpret=True))
    jm, jl = jm[..., 0], jl[..., 0]
    o, m, l = (a.numpy() for a in flash_attention.flash_attention_stats_plain(
        t(q), t(k), t(v), t(qs), t(ks), stride))
    qpos = qs[:, None] + stride * np.arange(T)
    seen = (ks[:, None] <= qpos)[:, None, None]  # [B, 1, 1, T]: row 0 of the block visible
    assert seen.any() and not seen.all()
    vis = np.broadcast_to(seen, m.shape)
    np.testing.assert_allclose(o[vis], jo[vis], **PARTIALS_TOL)
    np.testing.assert_allclose(m[vis], jm[vis], **PARTIALS_TOL)
    np.testing.assert_allclose(l[vis], jl[vis], **PARTIALS_TOL)
    mask = np.float32(_MASK)
    assert np.all(m[~vis] == mask) and np.all(jm[~vis] == mask)
    # Merged into a real partial, a row that saw nothing changes nothing.
    real = (t(rng.standard_normal(o.shape).astype(np.float32)),
            t(rng.standard_normal(m.shape).astype(np.float32)),
            t(rng.random(l.shape).astype(np.float32) + 0.5))
    unseen = torch.from_numpy(np.ascontiguousarray(~vis))
    for parts in ((o, m, l), (jo, jm, jl)):
        merged = _merge_stats(*real, *(t(a) for a in parts))
        for got, want in zip(merged, real):
            assert torch.equal(got[unseen], want[unseen])


def _ctx_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("ctx",))


RING_SHAPES = {2: (1, 4), 4: (2, 2)}  # ncp -> (Hkv, rep) of the ring inputs
B, T_LOCAL, S_LOCAL, DH = 2, 8, 16, 64


def _inputs(ncp):
    """(ring q, k, v), (decode q, k, v, lengths) for ncp ranks, from a seed."""
    rng = np.random.default_rng(ncp)
    Hkv, rep = RING_SHAPES[ncp]
    T, S = ncp * T_LOCAL, ncp * S_LOCAL

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ring = (randn(B, Hkv * rep, T, DH), randn(B, Hkv, T, DH), randn(B, Hkv, T, DH))
    lengths = np.array([S - 5, 20], np.int32)  # ragged; the second leaves shards empty
    return ring, (randn(B, 4, DH), randn(B, 2, S, DH), randn(B, 2, S, DH), lengths)


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    """ncp -> (inputs, each rank's ring_worker outputs): one group a size."""
    runs = {}

    def get(ncp):
        if ncp not in runs:
            inputs = _inputs(ncp)
            runs[ncp] = inputs, run_ranks(ring_worker, ncp, tmp_path_factory.mktemp("ranks"),
                                          *inputs)
        return runs[ncp]

    return get


@pytest.mark.parametrize("layout", ["block", "cyclic"])
@pytest.mark.parametrize("ncp", [2, 4])
def test_ring_attention_matches_jax(rank_outputs, ncp, layout):
    ((q, k, v), _), outs = rank_outputs(ncp)
    T = q.shape[2]
    # Shard i's rows: a contiguous block, or positions i, i+n, ... gathered
    # as shard_map's contiguous split sees them.
    order = (np.arange(T) if layout == "block"
             else np.arange(T).reshape(T_LOCAL, ncp).T.reshape(-1))
    fn = shard_map(lambda ql, kl, vl: j_ring_attention(ql, kl, vl, "ctx", ncp, layout=layout),
                   _ctx_mesh(ncp), in_specs=(P(None, None, "ctx", None),) * 3,
                   out_specs=P(None, None, "ctx", None))
    want = np.asarray(jax.jit(fn)(*(jnp.asarray(a[:, :, order]) for a in (q, k, v))))
    got = np.concatenate([o[layout] for o in outs], axis=2)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, **RING_TOL)


@pytest.mark.parametrize("ncp", [2, 4])
def test_decode_attend_cp_matches_jax(rank_outputs, ncp):
    (_, (q, k, v, lengths)), outs = rank_outputs(ncp)

    def local(q, kl, vl, lens_all):
        lo = jax.lax.axis_index("ctx") * S_LOCAL
        return j_decode_attend_cp(q, kl, vl, jnp.clip(lens_all - lo, 0, S_LOCAL), "ctx")

    fn = shard_map(local, _ctx_mesh(ncp),
                   in_specs=(P(), P(None, None, "ctx", None), P(None, None, "ctx", None), P()),
                   out_specs=P())
    want = np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in (q, k, v, lengths))))
    for o in outs:
        np.testing.assert_array_equal(o["decode"], outs[0]["decode"])
    np.testing.assert_allclose(outs[0]["decode"], want, **RING_TOL)
