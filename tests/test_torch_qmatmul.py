"""Kernel 1 of the port (Q4_0 matmul + fused RMSNorm) against the JAX package.

The JAX side runs its Pallas q4 kernel in interpret mode on the CPU
(quant_matmul -> q4_matmul), the port its plain version; both compute in
f32 here, so they agree to f32 summation-order error: rtol 1e-4 and an
atol of 1e-4 of the largest |output|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ops.pallas.qmatmul import quant_matmul
from tokenhawk_tpu_torch.ggml.quants import quantize_q4_0
from tokenhawk_tpu_torch.ops.linear import matmul
from tokenhawk_tpu_torch.ops.qweight import QWeight

from torch_helpers import jax_q4, t

N = 256


@pytest.mark.parametrize("K", [256, 704])  # 704 = 64*11, not a power of two like 11008
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8, 64])
def test_q4_matmul_matches_jax(rows, norm, K):
    rng = np.random.default_rng(rows * 1000 + K + norm)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32) if norm else None
    qw, pw = jax_q4(w)
    want = np.asarray(quant_matmul(jnp.asarray(x), qw, None if g is None else jnp.asarray(g),
                                   interpret=True))
    got = matmul(t(x), pw, None if g is None else t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("K", [256, 704])
def test_layout_dequantizes_like_jax(K):
    """from_jax_packed keeps every weight: the port's oracle equals the
    reference's QWeight.dequantize exactly."""
    w = np.random.default_rng(K).standard_normal((K, 96)).astype(np.float32)
    qw, pw = jax_q4(w)
    np.testing.assert_array_equal(pw.dequantize().numpy(), np.asarray(qw.dequantize()))
    assert pw.shape == (K, 96) and pw.qs.shape == (96, K // 2)


def test_quantize_matches_host_quantizer():
    """QWeight.quantize (torch, any device) == the GGML host quantizer."""
    w = np.random.default_rng(3).standard_normal((128, 64)).astype(np.float32)
    host = QWeight.from_quantized_tensor(quantize_q4_0(w.T))
    dev = QWeight.quantize(t(w))
    assert torch.equal(host.qs, dev.qs)
    assert torch.equal(host.scales, dev.scales)
