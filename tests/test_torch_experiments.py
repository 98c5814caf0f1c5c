"""The port's experiment kernels (21: experiments/dequant_exp.py, 22:
experiments/sm90_probe.py) against the reference's experiment scripts, on
the CPU.

  - kernel 21's plain version, for each variant, against the reference's
    make_kernel / build (experiments/dequant_exp.py) in Pallas interpret
    mode at K 1024, N 512, B 8: only the script's imports and function
    definitions are loaded (with ast), K, N, B and x set as its globals,
    pallas_call given interpret=True.  Tolerance: one bfloat16 step of the
    largest |output| (f32 sums in another order, one rounding);
  - kernel 22's plain probes against the full output arrays of the
    reference's seven probes, exactly: experiments/mosaic_probe.py run with
    runpy while pallas.pallas_call is patched to interpret=True and
    jax.block_until_ready records each probe's output;
  - the host side of kernel 22's int4 probe (two codes a byte), and both
    scripts' refusal where there is no card.
"""

import ast
import functools
import runpy
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from tokenhawk_tpu_torch.experiments import dequant_exp, sm90_probe

from torch_helpers import t

ROOT = Path(__file__).resolve().parents[1]
K, N, B = 1024, 512, 8


def _reference_dequant(x):
    """experiments/dequant_exp.py's imports and function definitions, with
    the module globals K, N, B and x set small and pallas_call in
    interpret mode; the script's timing loop is not run."""
    tree = ast.parse((ROOT / "experiments" / "dequant_exp.py").read_text())
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = {"__name__": "dequant_exp_defs"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "dequant_exp.py", "exec"), ns)
    pl = ns["pl"]
    ns["pl"] = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    ns["pl"].pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns.update(K=K, N=N, B=B, x=x)
    return ns


@pytest.fixture(scope="module")
def dequant_inputs():
    rng = np.random.default_rng(21)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, K)), jnp.bfloat16).astype(jnp.float32))
    qs = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    s = np.asarray(jnp.asarray(0.01 * (0.5 + rng.random((K // 64, N))), jnp.bfloat16)
                   .astype(jnp.float32))
    return x, qs, s


@pytest.mark.parametrize("variant", dequant_exp.VARIANTS)
def test_dequant_plain_matches_the_pallas_kernel(dequant_inputs, variant):
    x, qs, s = dequant_inputs
    xj, sj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16)
    ns = _reference_dequant(xj)
    want = np.asarray(ns["build"](variant)(xj, jnp.asarray(qs), sj).astype(jnp.float32))
    for fn in (dequant_exp.dequant_matmul_plain, dequant_exp.dequant_matmul):  # CPU: plain
        got = fn(t(x, torch.bfloat16), t(qs), t(s, torch.bfloat16), variant)
        assert got.shape == (B, N) and got.dtype == torch.bfloat16
        top = np.abs(want).max()
        step = 2.0 ** (np.floor(np.log2(top)) - 7)  # one bfloat16 step at the top
        assert np.abs(got.float().numpy() - want).max() <= step


def test_dequant_variants_differ_only_where_they_should(dequant_inputs):
    x, qs, s = (t(a) for a in dequant_inputs)
    x = x.to(torch.bfloat16)
    s = s.to(torch.bfloat16)
    outs = {v: dequant_exp.dequant_matmul_plain(x, qs, s, v) for v in dequant_exp.VARIANTS}
    assert torch.equal(outs["int32"], outs["u8int8"])
    assert not torch.equal(outs["int32"], outs["biasdot"])  # no -8: wrong by design
    assert dequant_exp.bytes_per_matmul(4096, 11008) == 2048 * 11008 + 128 * 11008 * 2


@pytest.fixture(scope="module")
def reference_probes():
    """Each mosaic_probe.py probe's printed line and full output array."""
    outs, lines = [], []
    real_call, real_block = pallas.pallas_call, jax.block_until_ready

    def record(x):
        x = real_block(x)
        outs.append(np.asarray(x))
        return x

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pallas, "pallas_call", functools.partial(real_call, interpret=True))
        mp.setattr(jax, "block_until_ready", record)
        mp.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
        runpy.run_path(str(ROOT / "experiments" / "mosaic_probe.py"), run_name="__main__")
    finally:
        mp.undo()
    return lines, outs


def test_reference_probes_all_pass_in_interpret_mode(reference_probes):
    lines, outs = reference_probes
    assert len(lines) == len(outs) == len(sm90_probe.PROBES) == 7
    for line, name in zip(lines, sm90_probe.PROBES):
        assert line.startswith(f"ok   {name}:"), line


@pytest.mark.parametrize("i", range(7), ids=sm90_probe.PROBES)
def test_plain_probes_equal_the_references(reference_probes, i):
    want = reference_probes[1][i]
    ins = sm90_probe.inputs()
    for fn in (sm90_probe.probe_plain, sm90_probe.probe):  # the CPU wrapper: plain
        got = fn(i, ins).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_int4_packing_holds_two_codes_a_byte():
    codes = sm90_probe.inputs()["i4"]
    packed = sm90_probe.pack_int4(codes)
    assert packed.shape == (8, 64) and packed.dtype == torch.uint8
    lo, hi = sm90_probe._nibble_i4(packed & 0xF), sm90_probe._nibble_i4(packed >> 4)
    assert torch.equal(torch.stack([lo, hi], -1).reshape(8, 128), codes.float())


def test_experiment_scripts_refuse_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no GPU")
    assert dequant_exp.main() == 1 and sm90_probe.main() == 1
    assert capsys.readouterr().err.count("no CUDA device; nothing run") == 2
