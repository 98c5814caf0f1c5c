"""Kernel 2 of the port (fused SwiGLU FFN + residual) against the JAX package.

The JAX side is `_ffn_block` over packed q4_0 weights under the
pallas_interpret backend: packed q4_0 is not a fused-FFN kind there, so
it runs two Pallas q4 matmuls and a SiLU, which is the function the
TPU's fused kernel computes.  f32 throughout: rtol 1e-4, atol 1e-4 of
the largest |output|.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import LayerParams, _ffn_block
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu_torch.ops.cuda import ffn

from torch_helpers import jax_q4, t

D, F = 256, 512
CFG = LlamaConfig.tiny(n_embd=D, n_ff=F)


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_fused_ffn_matches_jax_ffn_block(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    w13 = (rng.standard_normal((D, 2 * F)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((F, D)) * 0.05).astype(np.float32)
    gain = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    q13, p13 = jax_q4(w13)
    q2, p2 = jax_q4(w2)
    lp = LayerParams(wq=None, wk=None, wv=None, wo=None, w1=None, w2=q2, w3=None,
                     attn_norm=None, ffn_norm=jnp.asarray(gain), w13=q13)
    old = dispatch.get_backend()
    dispatch.set_backend("pallas_interpret")
    try:
        want = np.asarray(_ffn_block(CFG, jnp.asarray(x), lp))
    finally:
        dispatch.set_backend(old)
    got = ffn.fused_ffn(t(x), p13, p2, t(gain), eps=CFG.rms_norm_eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
