"""The port's bench path (bench.py, utils/benchlib.py, utils/profiling.py,
experiments/trace_summarize.py) against the JAX package's, on the CPU.

  - kernel 20's plain version (benchlib.stream_sum_plain) against the
    reference's Pallas `_stream_sum_kernel` in interpret mode: 64 x 1024
    bfloat16, blocks of 16 rows, a nonzero seed, within 1e-6 of sum(|x|)
    (f32 sums in another order);
  - measure_iter_seconds' differencing on a scripted clock, exactly;
  - profiling: prefill_flops and kv_stream_bytes equal the reference's;
    weight_stream_bytes equals it for dense f32 and Q4_0 parameters carried
    across with params_from_jax; decode_speed_of_light at B = 1 is the
    reference's scaled by 3350/819 (H100 HBM over v5e HBM), and at B = 8
    the aggregate B * BW / (weights + KV of every row);
  - synth_params at a tiny config: every weight dequantizes bit for bit to
    root bench.synth_params's, for each --quant (q4_k with and without
    THAWK_Q4K_SB=1);
  - bench.run in decode, ttft and serve modes on the CPU at a tiny width:
    one JSON line whose metric is the reference's name for the arguments
    (BENCH_MATRIX.jsonl holds the reference's lines) and whose fields are
    the reference's, plus `device`;
  - trace_summarize's families and busy time on a scripted trace, and on a
    real CPU trace written by `--trace`.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench as jbench
from tokenhawk_tpu.config import LlamaConfig as JConfig
from tokenhawk_tpu.models.llama import init_params as j_init_params
from tokenhawk_tpu.utils import benchlib as jbenchlib
from tokenhawk_tpu.utils import profiling as jprof
from tokenhawk_tpu_torch import bench
from tokenhawk_tpu_torch.experiments import trace_summarize
from tokenhawk_tpu_torch.models.llama import params_from_jax
from tokenhawk_tpu_torch.ops.cuda import stream
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.utils import benchlib, profiling

from torch_helpers import numpy_params, port_config, t

ROOT = Path(__file__).resolve().parents[1]
H100 = profiling.H100_SXM


def _pallas_stream_sum(x, seed, block_rows):
    """The reference's probe kernel as hbm_stream_gbps builds it, in
    interpret mode."""
    rows, cols = x.shape
    return pl.pallas_call(
        jbenchlib._stream_sum_kernel,
        grid=(rows // block_rows,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM, block_shape=(1, 1),
                               index_map=lambda i: (0, 0)),
                  pl.BlockSpec((block_rows, cols), lambda i: (i, 0))],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM, block_shape=(1, 1),
                               index_map=lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        interpret=True,
    )(seed, x)


def test_stream_sum_plain_matches_pallas(rng):
    x = rng.standard_normal((64, 1024)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    seed = np.array([[3.25]], np.float32)
    want = float(np.asarray(_pallas_stream_sum(xb, jnp.asarray(seed), 16))[0, 0])
    xt = t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16)
    before = stream.launches["stream_sum"]
    for fn in (benchlib.stream_sum_plain, stream.stream_sum):  # the CPU wrapper: plain
        got = fn(xt, t(seed))
        assert got.shape == (1, 1) and got.dtype == torch.float32
        assert abs(got.item() - want) <= 1e-6 * np.abs(np.asarray(xb, np.float32)).sum()
    assert stream.launches["stream_sum"] == before  # CPU tensors launch nothing


def test_stream_sum_chains_its_seed():
    x = torch.ones((16, 1024), dtype=torch.bfloat16)
    acc = torch.zeros((1, 1))
    for _ in range(3):
        acc = stream.stream_sum(x, acc)
    assert acc.item() == 3 * 16 * 1024


@pytest.mark.parametrize("reduce", ["min", "median"])
def test_measure_iter_seconds_differences_two_counts(monkeypatch, reduce):
    clock = [0.0]
    monkeypatch.setattr(benchlib.time, "perf_counter", lambda: clock[0])
    jitter = iter([0.0, 0.0, 0.003, 0.0, -0.002, 0.0, 0.001, 0.0] * 4)

    def make_fn(n):
        def f(x):
            clock[0] += 0.5 + n * 0.01 + next(jitter)  # fixed overhead + n iterations
            return x

        return f

    est = benchlib.measure_iter_seconds(make_fn, (torch.ones(2),), 4, 24, trials=3, reduce=reduce)
    per = sorted([0.01 - 0.003 / 20, 0.01 + 0.002 / 20, 0.01 - 0.001 / 20])
    assert est == pytest.approx(per[0] if reduce == "min" else per[1], rel=1e-9)


def test_hbm_stream_gbps_runs_the_probe_loop_on_the_cpu():
    before = stream.launches["stream_sum"]
    gbps = benchlib.hbm_stream_gbps(nbytes=1 << 17, block_rows=16, trials=1, device="cpu")
    assert np.isfinite(gbps) and gbps > 0
    assert stream.launches["stream_sum"] == before


JCFGS = [JConfig.tiny(), JConfig.tiny(n_kv_head=2, n_embd=256, n_head=8),
         JConfig.llama_7b(n_ctx=512)]


@pytest.mark.parametrize("jcfg", JCFGS, ids=["tiny", "gqa", "7b"])
def test_prefill_flops_and_kv_bytes_equal_the_references(jcfg):
    cfg = port_config(jcfg)
    for n, b in ((1, 1), (64, 1), (512, 8)):
        assert profiling.prefill_flops(cfg, n, b) == jprof.prefill_flops(jcfg, n, b)
        for dtype_bytes in (1, 2):
            assert (profiling.kv_stream_bytes(cfg, n, b, dtype_bytes)
                    == jprof.kv_stream_bytes(jcfg, n, b, dtype_bytes))
    want = jprof.prefill_speed_of_light(jcfg, 512, 2) * 197.0 / 989.0
    assert profiling.prefill_speed_of_light(cfg, 512, 2, card=H100) == pytest.approx(want, 1e-12)


def _jax_params(kind):
    jcfg = JConfig.tiny(n_vocab=300)
    if kind == "f32":
        jp = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        return jcfg, jp, params_from_jax(numpy_params(jp))
    jp = jbench.synth_params(jcfg, "q4_0", jnp.bfloat16, jnp.float32)
    return jcfg, jp, params_from_jax(numpy_params(jp), dtype=torch.bfloat16)


@pytest.mark.parametrize("kind", ["f32", "q4_0"])
def test_weight_stream_bytes_equals_the_references(kind):
    jcfg, jp, tp = _jax_params(kind)
    assert profiling.weight_stream_bytes(tp) == jprof.weight_stream_bytes(jp)
    if kind == "q4_0":  # shared layer buffers still count once per layer
        shared = dataclasses.replace(tp, layers=[tp.layers[0]] * len(tp.layers))
        assert profiling.weight_stream_bytes(shared) == profiling.weight_stream_bytes(tp)


@pytest.mark.parametrize("kind", ["f32", "q4_0"])
def test_decode_roofline_is_the_references_at_one_row(kind):
    jcfg, jp, tp = _jax_params(kind)
    cfg = port_config(jcfg)
    for n_past, kvb in ((0, 2), (100, 2), (100, 1)):
        ref = jprof.decode_speed_of_light(jp, cfg=jcfg, n_past=n_past, batch=1, chip="v5e",
                                          kv_dtype_bytes=kvb)
        got = profiling.decode_speed_of_light(tp, cfg=cfg, n_past=n_past, batch=1, card=H100,
                                              kv_dtype_bytes=kvb)
        assert got == pytest.approx(ref * 3350.0 / 819.0, rel=1e-12)
    assert profiling.roofline_fraction(got / 2, tp, cfg=cfg, n_past=100, card=H100,
                                       kv_dtype_bytes=1) == pytest.approx(0.5)


def test_decode_roofline_charges_every_rows_kv_at_batch_8():
    jcfg, jp, tp = _jax_params("q4_0")
    cfg = port_config(jcfg)
    w = profiling.weight_stream_bytes(tp)
    kv8 = profiling.kv_stream_bytes(cfg, 100, 8)
    got = profiling.decode_speed_of_light(tp, cfg=cfg, n_past=100, batch=8, card=H100)
    assert got == pytest.approx(8 * 3350e9 / (w + kv8), rel=1e-12)
    # The reference's value (profiling.py:82-85: the weights plus an eighth
    # of the KV, compared with tok/s / B) is the per-row rate of a step
    # that read only one row's KV.
    ref = jprof.decode_speed_of_light(jp, cfg=jcfg, n_past=100, batch=8, chip="v5e")
    assert ref * 3350.0 / 819.0 == pytest.approx(3350e9 / (w + kv8 // 8), rel=1e-12)
    assert got < 8 * ref * 3350.0 / 819.0


def test_unknown_card_raises_unless_given_the_figures():
    _, _, tp = _jax_params("f32")
    with pytest.raises(KeyError):
        profiling.decode_speed_of_light(tp, card="Some Other GPU")
    with pytest.raises(KeyError):
        profiling.prefill_speed_of_light(port_config(JConfig.tiny()), 16, card="Some Other GPU")
    assert profiling.decode_speed_of_light(tp, card="Some Other GPU", hbm=1000.0) == \
        pytest.approx(1e12 / profiling.weight_stream_bytes(tp))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            profiling.hbm_gbps()


SYNTH_CFG = JConfig.tiny(n_vocab=256, n_embd=1024, n_head=8, n_layer=2, n_ff=1024)


def _dense(w):
    if isinstance(w, QWeight):
        return w.dequantize().numpy()
    return w.float().numpy()


def _jdense(w):
    if hasattr(w, "dequantize"):
        return np.asarray(w.dequantize(jnp.float32))
    return np.asarray(w, np.float32)


@pytest.mark.parametrize("quant,sb", [("f16", False), ("q8_0", False), ("q4_0", False),
                                      ("q4_k", False), ("q4_k", True)])
@pytest.mark.parametrize("fuse", [True, False])
def test_synth_params_dequantize_to_the_references(monkeypatch, quant, sb, fuse):
    monkeypatch.setenv("THAWK_Q4K_SB", "1" if sb else "0")  # another file may have set it
    jp = jbench.synth_params(SYNTH_CFG, quant, jnp.bfloat16, jnp.bfloat16, fuse=fuse)
    tp = bench.synth_params(port_config(SYNTH_CFG), quant, torch.bfloat16, torch.bfloat16,
                            "cpu", fuse=fuse)
    names = (["wqkv", "w13"] if fuse else ["wq", "wk", "wv", "w1", "w3"]) + ["wo", "w2"]
    pairs = [(jp.tok_embd, tp.tok_embd), (jp.norm, tp.norm), (jp.output, tp.output)]
    assert len(jp.layers) == len(tp.layers) == SYNTH_CFG.n_layer
    for jl, tl in zip(jp.layers, tp.layers):
        pairs += [(getattr(jl, n), getattr(tl, n)) for n in names + ["attn_norm", "ffn_norm"]]
    for jw, tw in pairs:
        np.testing.assert_array_equal(_dense(tw), _jdense(jw).reshape(_dense(tw).shape))
    wo, w2 = tp.layers[0].wo, tp.layers[0].w2
    if quant == "f16":
        assert isinstance(wo, torch.Tensor) and wo.dtype == torch.bfloat16
    else:
        want = "q4k_sb" if sb else "q4_0" if quant == "q4_0" else "qk"
        assert wo.kind == want and w2.kind == ("qk" if sb else want)  # sb: w2 stays flat
    # Every layer owns its buffers (the reference shares one layer's).
    ptr = [(lp.wo if quant == "f16" else lp.wo.qs).data_ptr() for lp in tp.layers]
    assert len(set(ptr)) == len(ptr)


def _matrix_lines():
    return [json.loads(ln) for ln in (ROOT / "BENCH_MATRIX.jsonl").read_text().splitlines()
            if ln.strip()]


def _args_of(line, **over):
    argv = ["--quant", line["quant"], "--model", line["model"], "--mode", line["mode"],
            "--batch", str(line["batch"]), "--ctx", str(line["ctx"]),
            "--prompt-tokens", str(line["prompt_tokens"]), "--kv", line["kv"],
            "--chunk", str(line["chunk"])]
    if line.get("prefix_cache"):
        argv.append("--prefix-cache")
    for k, v in over.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return bench.parse_args(argv)


def test_metric_names_are_the_references():
    lines = _matrix_lines()
    assert len(lines) >= 10
    for line in lines:
        assert bench.metric_name(_args_of(line)) == line["metric"]


TINY = port_config(JConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512,
                                n_ctx=512, rope_style="half"))


@pytest.mark.parametrize("mode,extra", [
    ("decode", []), ("decode", ["--batch", "2", "--kv", "int8"]), ("ttft", []),
    ("serve", ["--batch", "2", "--requests", "3"]),
    ("serve", ["--batch", "2", "--requests", "3", "--prefix-cache", "--kv", "int8"]),
])
def test_bench_runs_each_mode_on_the_cpu(capsys, mode, extra):
    args = bench.parse_args(["--device", "cpu", "--mode", mode, "--ctx", "512",
                             "--prompt-tokens", "16", "--tokens", "16", "--chunk", "8", *extra])
    rec = bench.run(TINY, args)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == rec
    assert rec["metric"] == bench.metric_name(args) and rec["device"] == "cpu"
    assert rec["value"] > 0 and np.isfinite(rec["value"])
    ref_keys = set().union(*(line.keys() for line in _matrix_lines() if line["mode"] == mode))
    assert set(rec) - ref_keys == {"device"}, set(rec) - ref_keys
    assert "measured_hbm_gbps" not in rec  # the probe runs on the card only
    if mode == "decode":  # no device roofline from a CPU run
        assert rec["pct_of_spec_sol"] is None and rec["achieved_gbps"] is None
    if mode == "serve":
        assert rec["gen_tokens"] == 16 and rec["decode_calls"] > 0


def test_bench_refuses_without_a_card_and_without_unroll(capsys):
    with pytest.raises(SystemExit) as e:
        bench.parse_args(["--no-unroll"])
    assert e.value.code == 2 and "lax.scan" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--mode", "ttft"])


def test_trace_summarize_families_and_busy_time():
    ours = trace_summarize.port_kernels()
    assert {"gemv_kernel", "stream_partials", "dequant_partials", "probe_mma_s8"} <= ours
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "ts": 10.0, "dur": 20.0,
         "name": "void (anonymous namespace)::gemv_kernel<0, __nv_bfloat16, 8>(float const*)"},
        {"ph": "X", "cat": "kernel", "ts": 25.0, "dur": 10.0,
         "name": "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"},
        {"ph": "X", "cat": "kernel", "ts": 50.0, "dur": 5.0,
         "name": "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60.0, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "ts": 70.0, "dur": 6.0, "name": "ncclDevKernel_AllReduce_Sum"},
    ]
    s = trace_summarize.summarize(ev, tokens=2, ours=ours)
    assert s["ms_per_tok"] == pytest.approx({"gemv_kernel": 0.01, "cublas": 0.005,
                                             "elementwise": 0.0025, "memcpy/memset": 0.002,
                                             "nccl": 0.003})
    assert s["busy_ms"] == pytest.approx(0.040) and s["window_ms"] == pytest.approx(0.1)


def test_bench_trace_writes_a_summarizable_trace(tmp_path, capsys):
    args = bench.parse_args(["--device", "cpu", "--mode", "decode", "--ctx", "256",
                             "--prompt-tokens", "16", "--tokens", "16", "--chunk", "8",
                             "--trace", str(tmp_path)])
    bench.run(TINY, args)
    assert (tmp_path / "trace.json").exists()
    capsys.readouterr()
    assert trace_summarize.main([str(tmp_path), "16"]) == 0
    out = capsys.readouterr().out
    assert "ms/tok" in out and "busy" in out
