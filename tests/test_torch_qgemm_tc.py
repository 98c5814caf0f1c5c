"""A CPU rehearsal of the tensor-core path of kernels 1, 13 and 17 (csrc/qgemm_tc.cuh).

`tile_walk` below repeats the walk's roundings in torch: xn is rounded
to bf16 once (after the norm, (x * inv_rms) * gain, when there is one);
each weight code * s is formed in f32 and rounded to bf16; the bf16
products (exact in f32) are summed in f32 one K step of 64 inputs at a
time (a ragged last step of 32; where the kernel splits K across blocks
it adds the splits' sums in order, another order of the same sums); a
mins form adds the f32 dot of xn's group sums with m after each step's
products; the output is rounded once to bf16.  The Q4_K super-block form
(kernel 17) first expands each group's s = d*sc and m = 8s - dmin*mn in
f32, each product and the difference rounded, and then walks as a mins
form over its codes less 8.  The emulation lives here,
not in the package: the kernel cannot run on the CPU, and its plain
version keeps f32 throughout.

It is held against the reference's Pallas kernels in interpret mode
(q4_matmul, q8_matmul, qk_matmul and qk_sb_matmul, reached as the model
reaches them) on bf16 x at 9 to 256 rows, where `_qdot` takes its bf16
dot (the reference pads the rows to a multiple of 8 and tiles them in
blocks of more than 8 at these counts), with and without the fused norm,
over Q4_0, Q8_0 (G 32), Q4_K (G 32, mins), Q6_K (G 16), Q2_K (G 16,
mins) and Q4_K in super-blocks (THAWK_Q4K_SB=1's form; the reference's
kernel needs K % 1024 == 0) at ragged widths.  Both sides sum the same bf16 products in f32 and
differ by order and by the norm's row statistics: the mean of squares,
summed in another order, can move inv_rms by an f32 ulp and with it an xn
across a bf16 rounding boundary.  So each output is held within one bf16
step of the reference's (its own rounding), plus 2^-7 of its largest
|xn_k| * |w_nk| bound (two xn a bf16 step apart), plus 2^-16 of the sum of
its terms' magnitudes (f32 order); and at most 1% of the outputs may
differ at all, where a walk with other roundings moves most of them.
Against the plain version (f32 throughout) the walk stays within
KERNEL_TOL, 2^-7 of the largest |output|, the tolerance chip_smoke.py
holds the kernels to.
"""

import functools
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.ggml.quants import quantize as j_quantize
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.linear import matmul as j_matmul
from tokenhawk_tpu.ops.pallas.qmatmul import _pick_block
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor as TQuantizedTensor
from tokenhawk_tpu_torch.ggml.synth import random_kquant
from tokenhawk_tpu_torch.ops.cuda import qmatmul
from tokenhawk_tpu_torch.ops.qweight import QWeight

from torch_helpers import jax_q4, t

KERNEL_TOL = 2.0**-7
STEP = 64  # inputs a K step of the walk
# Each kind at ragged widths (N not a multiple of the walk's 128 columns;
# Q8_0's K = 800 ends in a half step; Q4_0's K a multiple of 64, as the
# reference's packed halves need).
KINDS = {"Q4_0": (704, 200), "Q8_0": (800, 100), "Q4_K": (512, 136), "Q6_K": (768, 100),
         "Q2_K": (512, 72), "Q4_K_SB": (1024, 136)}
ROWS = [9, 40, 256]


@functools.lru_cache(maxsize=None)
def weights(kind):
    """The reference's QWeight and the port's over the same codes, of
    logical shape [K, N]."""
    K, N = KINDS[kind]
    rng = np.random.default_rng(list(KINDS).index(kind))
    if kind == "Q4_0":
        return jax_q4((rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    if kind == "Q8_0":
        qt = j_quantize((rng.standard_normal((N, K)) * 0.05).astype(np.float32), JType.Q8_0)
        port_qt = TQuantizedTensor(TType.Q8_0, qt.shape, qt.qs, qt.scales, qt.mins)
        return (j_qw.from_quantized_tensor(qt, scale_dtype=jnp.float32),
                QWeight.from_quantized_tensor(port_qt))
    if kind == "Q4_K_SB":
        raw = random_kquant(TType.Q4_K, (N, K), rng).raw
        with mock.patch.dict(os.environ, {"THAWK_Q4K_SB": "1"}):
            jw = j_qw.from_kquant_raw(JType.Q4_K, raw, (N, K), scale_dtype=jnp.float32,
                                      use_i4=True)
        pw = QWeight.from_kquant_raw(TType.Q4_K, raw, (N, K), sb=True)
        assert jw.kind == pw.kind == "q4k_sb"
        return jw, pw
    raw = random_kquant(TType[kind], (N, K), rng).raw
    return (j_qw.from_kquant_raw(JType[kind], raw, (N, K), scale_dtype=jnp.float32, use_i4=False),
            QWeight.from_kquant_raw(TType[kind], raw, (N, K)))


def _sides(w: QWeight):
    """codes [N, K] as the kernel reads them (Q4_0's and the super-blocks'
    less 8), s and m [N, K/G]; a super-block weight's expanded per group
    with the walk's f32 roundings."""
    if w.kind == "q4k_sb":
        g = w.scmn.shape[1] // 2
        s = w.scales.repeat_interleave(8, dim=1) * w.scmn[:, :g].float()
        m = 8.0 * s - w.mins.repeat_interleave(8, dim=1) * w.scmn[:, g:].float()
        return w.codes().float() - 8.0, s, m
    codes = w.codes().float() - (8.0 if w.kind == "q4_0" else 0.0)
    return codes, w.scales, w.mins


def tile_walk(x: torch.Tensor, w: QWeight, gain=None, eps: float = 1e-6) -> torch.Tensor:
    """The tensor-core walk's function: x [B, K] bf16 -> [B, N] bf16."""
    codes, s, m = _sides(w)
    G = w.group
    xf = x.float()
    if gain is not None:
        inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xf = (xf * inv * gain.float()).bfloat16().float()
    wb = (codes * s.repeat_interleave(G, dim=1)).bfloat16().float()  # [N, K]
    B, K = xf.shape
    xsum = xf.reshape(B, K // G, G).sum(-1)
    acc = torch.zeros(B, wb.shape[0])
    for k0 in range(0, K, STEP):
        acc += xf[:, k0:k0 + STEP] @ wb[:, k0:k0 + STEP].T
        if m is not None:
            g0, g1 = k0 // G, min(k0 + STEP, K) // G
            acc += xsum[:, g0:g1] @ m[:, g0:g1].T
    return acc.bfloat16()


def _bounds(x: torch.Tensor, w: QWeight, gain=None) -> tuple:
    """Per output: the sum of |terms| (f32 products of the walk's operands,
    mins terms included), the scale of its f32 order errors; and the
    largest |xn_k| times the largest |w_nk|, a bound on any one term."""
    codes, s, m = _sides(w)
    G = w.group
    xf = x.float()
    if gain is not None:
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) * gain.float()
    wa = (codes * s.repeat_interleave(G, dim=1)).abs()
    total = xf.abs() @ wa.T
    if m is not None:
        total += xf.reshape(xf.shape[0], -1, G).sum(-1).abs() @ m.abs().T
    return total, xf.abs().amax(1, keepdim=True) * wa.amax(1)[None]


def _inputs(kind, rows, norm):
    K, _ = KINDS[kind]
    rng = np.random.default_rng(rows * 100 + list(KINDS).index(kind) * 10 + norm)
    x = t(rng.standard_normal((rows, K)).astype(np.float32)).bfloat16()
    gain = t((1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)).bfloat16() if norm else None
    return x, gain


def _jax(a: torch.Tensor):
    return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)


def _reference(kind, x, gain):
    """The reference's quantized matmul in Pallas interpret mode, bf16 x."""
    old = dispatch.get_backend()
    dispatch.set_backend("pallas_interpret")
    try:
        y = j_matmul(_jax(x), weights(kind)[0], None if gain is None else _jax(gain))
    finally:
        dispatch.set_backend(old)
    return torch.from_numpy(np.array(y.astype(jnp.float32)))


def _bf16_step(a: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step (ulp) at each |a|."""
    e = torch.floor(torch.log2(a.abs().clamp(min=2.0**-126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("norm", [False, True])
def test_walk_matches_pallas(kind, rows, norm):
    bp = -(-rows // 8) * 8
    assert _pick_block(bp, 128, 8) > 8  # the reference's row tile takes the bf16 dot
    x, gain = _inputs(kind, rows, norm)
    w = weights(kind)[1]
    got = tile_walk(x, w, gain).float()
    want = _reference(kind, x, gain)
    assert got.shape == want.shape == (rows, KINDS[kind][1])
    total, largest = _bounds(x, w, gain)
    diff = (got - want).abs()
    assert float((diff / (_bf16_step(want) + 2.0**-7 * largest + 2.0**-16 * total)).max()) <= 1
    assert int((diff > 0).sum()) <= 0.01 * diff.numel()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("norm", [False, True])
def test_walk_matches_plain(kind, rows, norm):
    x, gain = _inputs(kind, rows, norm)
    w = weights(kind)[1]
    got = tile_walk(x, w, gain).float()
    want = qmatmul.quant_matmul_plain(x, w, gain).float()
    assert float((got - want).abs().max()) <= KERNEL_TOL * float(want.abs().max())


def test_the_path_is_chosen_by_dtype_rows_and_form():
    """bf16 x above 8 rows over every form, the super-block form (kernel
    17) too; every other call (decode rows, f32 x) keeps the GEMV."""
    for rows in (1, 8, 9, 40, 512):
        for dtype in (torch.bfloat16, torch.float32):
            want = dtype == torch.bfloat16 and rows > 8
            assert qmatmul.tensor_core_path(dtype, rows) == want
    for kind in KINDS:  # a CPU tensor runs the plain version and counts nothing
        x, gain = _inputs(kind, 40, True)
        before = dict(qmatmul.launches)
        qmatmul.quant_matmul(x, weights(kind)[1], gain)
        assert qmatmul.launches == before
