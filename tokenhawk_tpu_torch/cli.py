"""Command-line frontend (counterpart of tokenhawk_tpu/cli.py).

    python -m tokenhawk_tpu_torch.cli -m models/7B/ggml-model-q4_0.bin "<prompt>"

Same flags and output lines as the reference CLI, on one CUDA device,
except --tp (tensor parallelism), still to port.  --kv int8 keeps K/V as
int8 codes with per-token scales; --kv auto picks int8 at --n-ctx >=
1024.  --draft-model FILE with --gamma N decodes speculatively: the draft
proposes N tokens a round and the target verifies them in one pass
(greedy only; the output is the target's greedy stream).  --device names
the device (a machine without CUDA fails instead of running on the CPU
unless --device cpu is given).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tokenhawk-torch",
                                description="LLaMA inference on one CUDA GPU")
    p.add_argument("-m", "--model", help="GGML or GGUF model file")
    p.add_argument("-d", "--dir", help="TH chunk directory (split model)")
    p.add_argument("prompt", nargs="?", default="", help="prompt text")
    p.add_argument("--n-ctx", type=int, default=2048)
    p.add_argument("--max-tokens", type=int, default=500)
    p.add_argument("--temp", type=float, default=0.80)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--repeat-penalty", type=float, default=1.10)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--seed", type=int, default=780658349)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--kv", choices=["bf16", "int8", "auto"], default="bf16",
                   help="KV cache dtype; auto picks int8 at n-ctx >= 1024")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--timing", action="store_true", help="per-token latency stats")
    p.add_argument("--draft-model", help="GGML or GGUF draft model for speculative decoding "
                   "(greedy only; output identical to the target's)")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    model_path = args.model or args.dir
    if not model_path:
        parser.error("one of -m/--model or -d/--dir is required")

    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.runtime.loader import load_model
    from tokenhawk_tpu_torch.utils.timing import TokenTimer

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    print(f"Loading {model_path} ...", file=sys.stderr)
    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(model_path, n_ctx=args.n_ctx, dtype=dtype,
                                        device=args.device)
    print(f"Loaded in {time.perf_counter() - t0:.1f}s "
          f"({cfg.n_layer} layers, n_embd {cfg.n_embd})", file=sys.stderr)

    sampling = SamplingConfig(
        temperature=0.0 if args.greedy else args.temp,
        top_k=args.top_k,
        top_p=args.top_p,
        repeat_penalty=args.repeat_penalty,
        seed=args.seed,
    )
    kv = {"bf16": torch.bfloat16, "int8": "int8", "auto": "auto"}[args.kv]
    if args.draft_model:
        return _speculate(args, cfg, params, tokenizer, dtype,
                          kv if kv != "auto" else torch.bfloat16)
    engine = Engine(cfg, params, tokenizer=tokenizer, sampling=sampling, cache_dtype=kv)
    timer = TokenTimer() if args.timing else None

    def on_text(s: str):
        if timer:
            timer.tick()
        sys.stdout.write(s)
        sys.stdout.flush()

    result = engine.generate(args.prompt, max_new_tokens=args.max_tokens, on_text=on_text)
    sys.stdout.write("\n")
    print(
        f"[{result.prompt_tokens} prompt tok, {len(result.tokens)} generated; "
        f"prefill {result.prefill_seconds:.2f}s, "
        f"decode {result.decode_tokens_per_second:.1f} tok/s]",
        file=sys.stderr,
    )
    if timer:
        timer.print_stats(file=sys.stderr)
    return 0


def _speculate(args, cfg, params, tokenizer, dtype, kv) -> int:
    """Greedy speculative generation (the acceptance rule verifies the
    target's argmax, so --temp is ignored with a note)."""
    from tokenhawk_tpu_torch.runtime.loader import load_model
    from tokenhawk_tpu_torch.runtime.speculative import SpeculativeEngine

    if not args.greedy and args.temp > 0:
        print("note: --draft-model implies greedy decoding", file=sys.stderr)
    cfg_d, params_d, _ = load_model(args.draft_model, n_ctx=args.n_ctx, dtype=dtype,
                                    device=args.device)
    spec = SpeculativeEngine(cfg, params, cfg_d, params_d, tokenizer=tokenizer,
                             gamma=args.gamma, cache_dtype=kv)

    def on_token(t: int):
        sys.stdout.buffer.write(tokenizer.decode_token_bytes(t))
        sys.stdout.flush()

    toks, stats = spec.generate(args.prompt, max_new_tokens=args.max_tokens, on_token=on_token)
    sys.stdout.write("\n")
    dps = (len(toks) - 1) / stats["decode_seconds"] if stats["decode_seconds"] > 0 else 0.0
    print(f"[{len(toks)} generated; prefill {stats['prefill_seconds']:.2f}s, decode "
          f"{dps:.1f} tok/s; accept {stats['acceptance_rate']:.0%}, "
          f"{stats['tokens_per_round']:.2f} tok/round]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
