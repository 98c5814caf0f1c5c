"""Kernel 2 of the port (fused SwiGLU FFN + residual) against the JAX package.

Over packed q4_0 weights the JAX side is `_ffn_block` under the
pallas_interpret backend: packed q4_0 is not a fused-FFN kind there, so
it runs two Pallas q4 matmuls and a SiLU, which is the function the
TPU's fused kernel computes.  Over the group-code kinds (Q8_0 / Q8_0 and
Q4_K_M's Q4_K / Q6_K pairing, built by both packages from the same GGML
bytes) it is the TPU's fused kernel itself, `fused_ffn`, in interpret
mode.  f32 throughout: rtol 1e-4, atol 1e-4 of the largest |output|.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.ggml.quants import quantize as j_quantize
from tokenhawk_tpu.models.llama import LayerParams, _ffn_block
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.pallas.ffn import can_fuse_ffn
from tokenhawk_tpu.ops.pallas.ffn import fused_ffn as j_fused_ffn
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor as TQuantizedTensor
from tokenhawk_tpu_torch.ggml.synth import random_kquant
from tokenhawk_tpu_torch.ops.cuda import ffn
from tokenhawk_tpu_torch.ops.qweight import QWeight

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


def _group_code(kind, out_dim, in_dim, rng):
    """The reference's QWeight and the port's of one GGML [out, in] tensor
    (float32 sides, use_i4=False: the forms the port keeps)."""
    if kind == "Q8_0":
        qt = j_quantize((rng.standard_normal((out_dim, in_dim)) * 0.05).astype(np.float32),
                        JType.Q8_0)
        return (j_qw.from_quantized_tensor(qt, scale_dtype=jnp.float32),
                QWeight.from_quantized_tensor(TQuantizedTensor(TType.Q8_0, qt.shape, qt.qs,
                                                               qt.scales, qt.mins)))
    raw = random_kquant(TType[kind], (out_dim, in_dim), rng, std=0.05).raw
    return (j_qw.from_kquant_raw(JType[kind], raw, (out_dim, in_dim), scale_dtype=jnp.float32,
                                 use_i4=False),
            QWeight.from_kquant_raw(TType[kind], raw, (out_dim, in_dim)))


@pytest.mark.parametrize("kinds", [("Q8_0", "Q8_0"), ("Q4_K", "Q6_K")])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_fused_ffn_matches_jax_fused_kernel_over_group_codes(kinds, rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    gain = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    j13, p13 = _group_code(kinds[0], 2 * F, D, rng)
    j2, p2 = _group_code(kinds[1], D, F, rng)
    assert can_fuse_ffn(j13, j2, rows)
    want = np.asarray(j_fused_ffn(jnp.asarray(x), j13, j2, jnp.asarray(gain),
                                  eps=CFG.rms_norm_eps, interpret=True))
    got = ffn.fused_ffn(t(x), p13, p2, t(gain), eps=CFG.rms_norm_eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
