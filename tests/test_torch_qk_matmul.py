"""Kernel 13 of the port (group-code matmul + fused RMSNorm) against the JAX package.

Weights of every group-code kind, built by both packages from the same
bytes: Q8_0 and Q4_1 from the host quantizer, Q5_0 and Q5_1 from GGUF
blocks, Q2_K..Q6_K from random GGUF blocks (ggml/synth.py), through the
reference's from_quantized_tensor / from_kquant_raw with float32 sides
and use_i4=False (the forms the port keeps).
  - `dequantize()` equals the reference's QWeight.dequantize bit for bit,
    and so does a weight rebuilt from the reference's fields (from_jax);
  - the plain version of kernel 13 (what a CPU tensor runs) agrees with
    the reference's `matmul` under the pallas_interpret backend (its
    Pallas q8_matmul / qk_matmul in interpret mode; Q4_1 is no Pallas
    kind there and takes XLA) at rows 1, 3, 8 and 17, and under XLA
    (_matmul_quant; run once on the 17 rows, whose leading rows each
    row count takes), with and without the norm: f32 on both sides, so
    summation order only, atol 1e-5 and rtol 1e-4.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ggml import gguf as j_gguf
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.ggml.quants import quantize as j_quantize
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.linear import matmul as j_matmul
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor as TQuantizedTensor
from tokenhawk_tpu_torch.ggml.synth import random_kquant
from tokenhawk_tpu_torch.ops.cuda import qmatmul
from tokenhawk_tpu_torch.ops.linear import matmul
from tokenhawk_tpu_torch.ops.qweight import QWeight

from torch_helpers import t

K, N = 512, 256
KINDS = ["Q8_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
# (group, with mins) of each kind's form in the port
FORMS = {"Q8_0": (32, False), "Q4_1": (32, True), "Q5_0": (32, False), "Q5_1": (32, True),
         "Q2_K": (16, True), "Q3_K": (16, False), "Q4_K": (32, True), "Q5_K": (32, True),
         "Q6_K": (16, False)}


@functools.lru_cache(maxsize=None)
def weights(kind):
    """The reference's QWeight and the port's, of logical shape [K, N],
    from one GGML tensor [N, K]."""
    rng = np.random.default_rng(KINDS.index(kind))
    x = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    if kind.endswith("_K"):
        raw = random_kquant(TType[kind], (N, K), rng).raw
        jw = j_qw.from_kquant_raw(JType[kind], raw, (N, K), scale_dtype=jnp.float32, use_i4=False)
        return jw, QWeight.from_kquant_raw(TType[kind], raw, (N, K))
    if kind in ("Q8_0", "Q4_1"):
        qt = j_quantize(x, JType[kind])
    else:
        pack = j_gguf.pack_q5_0_blocks if kind == "Q5_0" else j_gguf.pack_q5_1_blocks
        qt = j_gguf.from_blocks_gguf(JType[kind], pack(x.reshape(-1)), (N, K))
    port_qt = TQuantizedTensor(TType[kind], qt.shape, qt.qs, qt.scales, qt.mins)
    return (j_qw.from_quantized_tensor(qt, scale_dtype=jnp.float32),
            QWeight.from_quantized_tensor(port_qt))


@pytest.mark.parametrize("kind", KINDS)
def test_dequantize_is_the_references_bit_for_bit(kind):
    jw, pw = weights(kind)
    assert pw.kind == "qk" and (pw.group, pw.mins is not None) == FORMS[kind]
    assert pw.qs.dtype == torch.int8 and pw.qs.shape == (N, K) and pw.shape == (K, N)
    want = np.asarray(jw.dequantize(jnp.float32))
    np.testing.assert_array_equal(pw.dequantize().numpy(), want)
    again = QWeight.from_jax(jw.kind, np.asarray(jw.qs), np.asarray(jw.scales),
                             None if jw.mins is None else np.asarray(jw.mins), group=jw.group)
    np.testing.assert_array_equal(again.dequantize().numpy(), want)


def _inputs(kind, norm):
    rng = np.random.default_rng(KINDS.index(kind) * 10 + norm)
    x = rng.standard_normal((17, K)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32) if norm else None
    return x, g


def _reference(kind, x, g, backend):
    old = dispatch.get_backend()
    dispatch.set_backend(backend)
    try:
        return np.asarray(j_matmul(jnp.asarray(x), weights(kind)[0],
                                   None if g is None else jnp.asarray(g)))
    finally:
        dispatch.set_backend(old)


@functools.lru_cache(maxsize=None)
def _xla_reference(kind, norm):
    return _reference(kind, *_inputs(kind, norm), "xla")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows", [1, 3, 8, 17])
@pytest.mark.parametrize("norm", [False, True])
def test_qk_matmul_plain_matches_jax(kind, rows, norm):
    x, g = _inputs(kind, norm)
    x = x[:rows]
    before = dict(qmatmul.launches)
    got = matmul(t(x), weights(kind)[1], None if g is None else t(g)).numpy()
    assert qmatmul.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got, _reference(kind, x, g, "pallas_interpret"),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _xla_reference(kind, norm)[:rows], rtol=1e-4, atol=1e-5)
