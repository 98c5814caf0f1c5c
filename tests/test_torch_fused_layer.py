"""Kernels 15 and 16 of the port (the fused decode-layer kernels) against the JAX package.

Kernel 15 (ops/cuda/ffn.py fused_owo_ffn: Wo + residual + RMSNorm + SwiGLU
FFN + residual) and kernel 16 (ops/cuda/flash_decode.py fused_attn_out:
append + attend + Wo + residual) run their plain versions here, held to
the reference's Pallas kernels (ffn.py fused_owo_ffn, attn_block.py
fused_attn_out) in interpret mode on the same numpy inputs.  Then the
port's gates against the reference's on the reference's own gate cases, a
two-layer Q8_0 model with the fusions on against the reference's forward
with its fusions on, and the weight forms where the reference's kernel 15
misreads its weights.

Tolerances: in f32, rtol 1e-4 and atol 1e-4 of the largest |output| (one
function summed in other orders, ~1e-6 relative); in bfloat16 rtol 2^-7
(both round one f32 value once: at most one bfloat16 step apart).  The K / V
rows kernel 16 appends match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig as JLlamaConfig
from tokenhawk_tpu.ggml import quants as hq
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.models import llama as JM
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.pallas import attn_block as jattn
from tokenhawk_tpu.ops.pallas import ffn as jffn
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ggml.synth import random_kquant
from tokenhawk_tpu_torch.models import llama as TM
from tokenhawk_tpu_torch.ops.cuda import ffn, flash_decode
from tokenhawk_tpu_torch.ops.qweight import QWeight

from helpers import make_ggml_weights
from torch_helpers import numpy_params, port_config, t

F32_RTOL = 1e-4
BF16_RTOL = 2.0**-7
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype: str):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)


def _weight(kind: str, k: int, n: int, rng):
    """(the reference's QWeight, the port's) of one random [k, n] weight:
    "q8_0", "q4_0" (packed), "q4_0_i4" (the reference's TPU form of Q4_0,
    which the port's q4_0 kind stands for), "q4_1", or a k-quant ("Q6_K",
    "Q4_K") from the same GGML bytes, as the reference keeps it off the TPU."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    if kind in ("q8_0", "q4_1"):
        jw = j_qw.quantize_array(w, kind)
        return jw, QWeight.from_jax(kind, np.asarray(jw.qs), np.asarray(jw.scales),
                                    None if jw.mins is None else np.asarray(jw.mins))
    if kind in ("q4_0", "q4_0_i4"):
        jw = j_qw.quantize_array(w, "q4_0")
        pw = QWeight.from_jax_packed(np.asarray(jw.qs), np.asarray(jw.scales),
                                     np.asarray(jw.scales_hi))
        return (j_qw.q4_packed_to_i4(jw) if kind == "q4_0_i4" else jw), pw
    raw = random_kquant(TType[kind], (n, k), rng, std=0.05).raw
    return (j_qw.from_kquant_raw(JType[kind], raw, (n, k), scale_dtype=jnp.float32,
                                 use_i4=False),
            QWeight.from_kquant_raw(TType[kind], raw, (n, k)))


def _dense(jw) -> np.ndarray:
    return np.asarray(jw.dequantize(), np.float32)


def _owo_oracle(ctx, x, wo, w13, w2, gain, eps=1e-6):
    """Kernel 15's function in numpy over the reference's dequantized weights."""
    xp = x.astype(np.float32) + ctx.astype(np.float32) @ _dense(wo)
    xn = xp / np.sqrt((xp * xp).mean(-1, keepdims=True) + eps) * gain
    gu = xn @ _dense(w13)
    F = gu.shape[-1] // 2
    g, u = gu[:, :F], gu[:, F:]
    return xp + (g / (1 + np.exp(-g)) * u) @ _dense(w2)


# -- kernel 15 ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 2, 8])
def test_owo_ffn_plain_matches_reference_kernel(rows, dtype):
    rng = np.random.default_rng(rows)
    D = Dq = F = 512
    (jwo, pwo), (j13, p13), (j2, p2) = (_weight("q8_0", *s, rng)
                                        for s in ((Dq, D), (D, 2 * F), (F, D)))
    gain = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    jd, td = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((rows, D)), jd)
    ctx = jnp.asarray(rng.standard_normal((rows, Dq)), jd)
    want = jffn.fused_owo_ffn(ctx, x, jwo, j13, j2, jnp.asarray(gain), interpret=True)
    xt, ct = t(np.asarray(x, np.float32), td), t(np.asarray(ctx, np.float32), td)
    got = ffn.fused_owo_ffn(ct, xt, pwo, p13, p2, t(gain))
    assert got.dtype == td and got.shape == (rows, D)
    _close(got.float(), want, dtype)
    _close(ffn.fused_owo_ffn_plain(ct, xt, pwo, p13, p2, t(gain)).float(), want, dtype)


@pytest.mark.parametrize("forms", [("Q6_K", "Q6_K", "Q6_K"), ("q8_0", "q8_0", "Q4_K")],
                         ids=["g16-wo-w13", "w2-with-mins"])
def test_owo_ffn_plain_is_exact_where_the_reference_misreads(forms):
    """Forms the reference's gate admits for its kernel 15 and the kernel
    misreads: it reads every scale as one of a 32-row block (Wo / w13 of G
    16, llama.cpp's Q6_K) and drops w2's mins (Q4_K).  The port computes
    them as the numpy oracle does; the reference is far from it."""
    rng = np.random.default_rng(3)
    D = Dq = F = 512
    rows = 2
    (jwo, pwo), (j13, p13), (j2, p2) = (_weight(k, *s, rng) for k, s in
                                        zip(forms, ((Dq, D), (D, 2 * F), (F, D))))
    gain = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    ctx = rng.standard_normal((rows, Dq)).astype(np.float32)
    jffn_gate = jffn._OWO_ENABLED
    try:
        jffn._OWO_ENABLED = True
        assert jffn.can_fuse_owo_ffn(jwo, j13, j2, rows)
    finally:
        jffn._OWO_ENABLED = jffn_gate
    assert ffn.can_fuse_owo_ffn(pwo, p13, p2, rows)
    want = _owo_oracle(ctx, x, jwo, j13, j2, gain)
    _close(ffn.fused_owo_ffn_plain(t(ctx), t(x), pwo, p13, p2, t(gain)), want, "f32")
    ref = np.asarray(jffn.fused_owo_ffn(jnp.asarray(ctx), jnp.asarray(x), jwo, j13, j2,
                                        jnp.asarray(gain), interpret=True))
    assert np.abs(ref - want).max() > 0.05 * np.abs(want).max()


# -- kernel 16 ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("len_old", [0, 37, 255, 511])
def test_attn_out_plain_matches_reference_kernel(len_old, dtype):
    rng = np.random.default_rng(len_old)
    H, Dh, S, D = 2, 128, 512, 256
    jwo, pwo = _weight("q8_0", H * Dh, D, rng)
    jd, td = DTYPES[dtype]

    def arr(*shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape), jd), np.float32)

    x, q = arr(1, 1, D), arr(1, 1, H, Dh)
    kn, vn = arr(1, 1, H, Dh), arr(1, 1, H, Dh)
    kc, vc = arr(1, H, S, Dh), arr(1, H, S, Dh)
    lengths = np.array([len_old + 1], np.int32)
    want, jk, jv = jattn.fused_attn_out(
        *(jnp.asarray(a, jd) for a in (x, q, kn, vn, kc, vc)), jnp.asarray(lengths), jwo,
        interpret=True)
    tk, tv = t(kc, td), t(vc, td)
    got = flash_decode.fused_attn_out(t(x, td), t(q, td), t(kn, td), t(vn, td), tk, tv,
                                      t(lengths), pwo)
    assert got.dtype == td and got.shape == (1, 1, D)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    _close(got.float(), want, dtype)


# -- the gates --------------------------------------------------------------------


# (wo, w13, w2) kinds and shapes (Dq, D, F), rows: the reference's cases
# (tests/test_ffn_fused.py test_gate_conditions: prefill rows, a dense
# weight, mixed kinds, F not a multiple of its tile) carried over to the Wo
# gate, with the cases that pass and the Wo conditions beside them.  The
# port's q4_0 kind is the reference's q4_0_i4 (its TPU form of Q4_0).
OWO_CASES = {
    "q8_0": (("q8_0",) * 3, (512, 512, 512), 1),
    "q8_0-8-rows": (("q8_0",) * 3, (512, 512, 512), 8),
    "prefill-rows": (("q8_0",) * 3, (512, 512, 512), 9),
    "dense-w13": (("q8_0", "dense", "q8_0"), (512, 512, 512), 1),
    "mixed-kinds": (("q8_0", "q4_0", "q8_0"), (512, 512, 512), 1),
    "q4_0": (("q4_0_i4",) * 3, (512, 512, 512), 1),
    "wo-kind-differs": (("q4_0_i4", "q8_0", "q8_0"), (512, 512, 512), 1),
    "F-not-a-tile": (("q8_0",) * 3, (512, 512, 128), 1),
    "g16": (("Q6_K",) * 3, (512, 512, 512), 4),
    "wo-with-mins": (("Q4_K", "Q4_K", "q8_0"), (512, 512, 512), 1),
    "w2-with-mins": (("q8_0", "q8_0", "Q4_K"), (512, 512, 512), 1),
    "Dq-384": (("q8_0",) * 3, (384, 512, 512), 1),
    "D-768": (("q8_0",) * 3, (512, 768, 512), 1),
}


@pytest.mark.parametrize("case", list(OWO_CASES))
def test_owo_gate_matches_reference(case, monkeypatch):
    (k_o, k_13, k_2), (Dq, D, F), rows = OWO_CASES[case]
    rng = np.random.default_rng(0)
    (jwo, pwo), (j2, p2) = _weight(k_o, Dq, D, rng), _weight(k_2, F, D, rng)
    if k_13 == "dense":
        j13 = jnp.zeros((D, 2 * F), jnp.float32)
        p13 = torch.zeros(D, 2 * F)
    else:
        j13, p13 = _weight(k_13, D, 2 * F, rng)
    monkeypatch.setattr(jffn, "_OWO_ENABLED", True)
    want = jffn.can_fuse_owo_ffn(jwo, j13, j2, rows)
    assert ffn.can_fuse_owo_ffn(pwo, p13, p2, rows) == want
    assert want == (case in ("q8_0", "q8_0-8-rows", "q4_0", "g16", "w2-with-mins"))


# Wo kind and [Dq, D]; (B, T, rep, Dh, S): tests/test_attn_block.py
# test_gate's cases (batch > 1, prefill, GQA, dense) and the conditions
# beside them.
ATTN_CASES = {
    "q8_0": ("q8_0", (256, 256), (1, 1, 1, 128, 512)),
    "q4_0": ("q4_0_i4", (256, 256), (1, 1, 1, 128, 512)),
    "batch": ("q8_0", (256, 256), (2, 1, 1, 128, 512)),
    "prefill": ("q8_0", (256, 256), (1, 2, 1, 128, 512)),
    "gqa": ("q8_0", (256, 256), (1, 1, 2, 128, 512)),
    "dense": ("dense", (256, 256), (1, 1, 1, 128, 512)),
    "g16": ("Q6_K", (256, 256), (1, 1, 1, 128, 512)),
    "mins": ("q4_1", (256, 256), (1, 1, 1, 128, 512)),
    "Dh-64": ("q8_0", (256, 256), (1, 1, 1, 64, 512)),
    "S-96": ("q8_0", (256, 256), (1, 1, 1, 128, 96)),
    "Dq-384": ("q8_0", (384, 256), (1, 1, 1, 128, 512)),
    "D-320": ("q8_0", (256, 320), (1, 1, 1, 128, 512)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_gate_matches_reference(case):
    kind, (Dq, D), args = ATTN_CASES[case]
    if kind == "dense":
        jwo, pwo = jnp.zeros((Dq, D), jnp.float32), torch.zeros(Dq, D)
    else:
        jwo, pwo = _weight(kind, Dq, D, np.random.default_rng(0))
    want = jattn.can_fuse_attn_out(jwo, *args)
    assert flash_decode.can_fuse_attn_out(pwo, *args) == want
    assert want == (case in ("q8_0", "q4_0"))


# -- a two-layer model ------------------------------------------------------------


def _counting(monkeypatch, module, name: str) -> dict:
    calls = {"n": 0}
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls["n"] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_tiny_model_with_fusions_matches_reference(monkeypatch):
    """A two-layer Q8_0 model (4 heads of 128, n_ff 512, f32) with both
    fusions on: a 5-token prefill (kernel 15 at 5 rows) and 8 greedy decode
    steps (kernel 16, then kernel 2) through the port's forward and through
    the reference's under the pallas_interpret backend with its fusions on.
    Greedy tokens are identical; hidden states agree to the f32 tolerance."""
    jcfg = JLlamaConfig(n_vocab=256, n_embd=512, n_head=4, n_kv_head=4, n_layer=2, n_ff=512,
                        n_ctx=128)
    tensors = make_ggml_weights(jcfg, np.random.default_rng(5))
    qtensors = {k: (hq.quantize(v, JType.Q8_0)
                    if v.ndim == 2 and "norm" not in k and "tok_embeddings" not in k else v)
                for k, v in tensors.items()}
    jparams = JM.fuse_params(JM.params_from_ggml(jcfg, qtensors, dtype=jnp.float32))
    cfg = port_config(jcfg)
    tparams = TM.params_from_jax(numpy_params(jparams))
    assert tparams.fusions == TM.Fusions()  # off unless asked for
    tparams.fusions = TM.Fusions(owo=True, attn=True)
    monkeypatch.setattr(jffn, "_OWO_ENABLED", True)
    monkeypatch.setenv("THAWK_FUSED_ATTN", "1")
    counts = {(side, name): _counting(monkeypatch, mod, name) for side, mod, name in (
        ("port", TM, "fused_owo_ffn"), ("port", TM, "fused_attn_out"),
        ("ref", jffn, "fused_owo_ffn"), ("ref", jattn, "fused_attn_out"))}
    prompt = [1, 17, 42, 99, 7]
    steps = 8

    def run_port():
        cache = TM.KVCache.create(cfg, 1, dtype=torch.float32)
        toks, hs = torch.tensor([prompt]), []
        off = 0
        for _ in range(steps + 1):
            h, cache = TM.forward(cfg, tparams, toks, cache, torch.tensor([off], dtype=torch.int32))
            hs.append(h[:, -1].numpy())
            off += toks.shape[1]
            toks = TM.logits_from_hidden(cfg, tparams, h[:, -1]).argmax(-1)[:, None]
            hs.append(int(toks[0, 0]))
        return hs

    def run_reference():
        cache = JM.KVCache.create(jcfg, 1, dtype=jnp.float32)
        toks, hs = jnp.asarray([prompt], jnp.int32), []
        off = 0
        for _ in range(steps + 1):
            h, cache = JM.forward(jcfg, jparams, toks, cache, jnp.asarray([off], jnp.int32))
            hs.append(np.asarray(h[:, -1]))
            off += toks.shape[1]
            toks = JM.logits_from_hidden(jcfg, jparams, h[:, -1]).argmax(-1)[:, None]
            hs.append(int(toks[0, 0]))
        return hs

    got = run_port()
    old = dispatch.get_backend()
    dispatch.set_backend("pallas_interpret")
    try:
        want = run_reference()
    finally:
        dispatch.set_backend(old)
    assert got[1::2] == want[1::2]
    for g, w in zip(got[0::2], want[0::2]):
        _close(g, w, "f32")
    layers = jcfg.n_layer
    assert counts["port", "fused_owo_ffn"]["n"] == layers  # the prefill's 5 rows
    assert counts["port", "fused_attn_out"]["n"] == steps * layers
    # The reference traces its scanned layer once per forward.
    assert counts["ref", "fused_owo_ffn"]["n"] > 0 and counts["ref", "fused_attn_out"]["n"] > 0
