"""Kernel 3 of the port (decode append + attend) against the JAX package.

The JAX side is `flash_decode_append` in interpret mode; the port's side
its plain version.  Both the output and the cache after the write are
compared: the written rows exactly, the output at f32 softmax precision
(atol 2e-5, rtol 1e-4, as the reference's own append test).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.ops.pallas.flash_decode_dma import flash_decode_append as jax_append
from tokenhawk_tpu_torch.ops.cuda import flash_decode

from torch_helpers import t

S, Dh, Hkv = 256, 128, 2


def _inputs(B, rep, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = (rng.standard_normal((B, Hkv, rep, Dh)) / Dh**0.5).astype(f)
    kn = rng.standard_normal((B, Hkv, Dh)).astype(f)
    vn = rng.standard_normal((B, Hkv, Dh)).astype(f)
    kc = rng.standard_normal((B, Hkv, S, Dh)).astype(f)
    vc = rng.standard_normal((B, Hkv, S, Dh)).astype(f)
    return q, kn, vn, kc, vc


def _check(B, rep, lengths, seed):
    q, kn, vn, kc, vc = _inputs(B, rep, seed)
    lengths = np.asarray(lengths, np.int32)
    out, kc_j, vc_j = jax_append(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths),
                                 interpret=True)
    kc_t, vc_t = t(kc), t(vc)
    got = flash_decode.flash_decode_append(t(q), t(kn), t(vn), kc_t, vc_t, t(lengths))
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("B", [1, 2])
def test_append_attend_matches_jax(B, rep):
    lengths = [1, 140][:B] if B == 2 else [77]
    _check(B, rep, lengths, seed=B * 10 + rep)


def test_append_attend_clamps_at_capacity():
    """An over-long slot writes the last cache row and attends the whole
    cache (the engine's length clamp), as the reference kernel does."""
    _check(2, 2, [S, S + 7], seed=99)
