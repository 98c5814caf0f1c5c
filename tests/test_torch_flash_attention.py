"""Kernel 4 of the port (causal prefill flash attention) against the JAX package.

The JAX side is `attend_prefill` (Pallas flash_attention) in interpret
mode, the port's side its plain version, at offsets 0 and > 0, MHA and
GQA.  f32 softmax in both: atol 2e-5, rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.ops.pallas.flash_attention import attend_prefill
from tokenhawk_tpu_torch.ops.cuda import flash_attention

from torch_helpers import t

S, Dh = 256, 128


@pytest.mark.parametrize("offset", [0, 100])
@pytest.mark.parametrize("Hkv,rep", [(2, 1), (1, 2)])
def test_prefill_attention_matches_jax(offset, Hkv, rep):
    B, T = 2, 16
    H = Hkv * rep
    rng = np.random.default_rng(offset + rep)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    offsets = np.array([offset, offset // 2], np.int32)
    pos = offsets[:, None] + np.arange(T, dtype=np.int32)[None]
    scale = 1.0 / Dh**0.5
    want = np.asarray(attend_prefill(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(pos), scale, interpret=True))
    qg = (t(q) * scale).reshape(B, T, Hkv, rep, Dh).permute(0, 2, 3, 1, 4)
    got = flash_attention.flash_attention(qg, t(kc), t(vc), t(offsets))
    got = got.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
