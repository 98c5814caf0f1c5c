"""HTTP chat server entry point (counterpart of tokenhawk_tpu/serving/__main__.py).

    python -m tokenhawk_tpu_torch.serving -m model.gguf --port 22345 [--paged]

Continuous batching on one CUDA device behind an SSE streaming API:
the dense per-slot Scheduler, or with --paged the PagedScheduler (page
pool, prefix cache, chunked prefill).  --device names the torch device
(cuda by default; a machine without CUDA fails unless --device cpu is
given).  A ggjt or GGUF file (sniffed by its magic); requests stop on
any of the tokenizer's end-of-generation ids (a Llama-3 BPE vocab's
<|eot_id|> as well as its EOS), and /v1/chat/completions renders a GGUF
file's own tokenizer.chat_template.  --paged --kv int8 serves from int8 pages with per-token scales;
the dense Scheduler keeps bf16 KV whatever --kv says, as the reference's
does (a note on stderr).  --draft-model FILE (with --gamma N) serves
speculatively through either scheduler: greedy requests get the target's
greedy stream, sampled ones rejection sampling (bf16 pages only with
--paged).  Not ported yet, and refused with an error: --tp (ROADMAP
Queue 1 item 8).
"""

from __future__ import annotations

import argparse
import sys
import time

NOT_PORTED = {"tp": "--tp (tensor parallelism) is not ported yet (ROADMAP Queue 1 item 8)"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tokenhawk-torch-serve",
                                description="LLaMA chat server on one CUDA GPU")
    p.add_argument("-m", "--model", help="GGML or GGUF model file")
    p.add_argument("-d", "--dir", help="TH chunk directory (split model)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=22345)
    p.add_argument("--n-ctx", type=int, default=2048)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--decode-chunk", type=int, default=8)
    p.add_argument("--temp", type=float, default=0.80)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--repeat-penalty", type=float, default=1.10)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--seed", type=int, default=780658349)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--paged", action="store_true",
                   help="paged-KV continuous batching (page pool instead of per-slot "
                        "dense caches; enables --prefill-chunk)")
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--prefix-cache", default=True, action=argparse.BooleanOptionalAction,
                   help="cross-request prefix caching over the page pool (paged only; "
                        "on by default: paged sessions replay conversation text)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="admit long prompts in chunks of this many tokens interleaved "
                        "with decode (paged only)")
    p.add_argument("--kv", choices=["bf16", "int8"], default="bf16",
                   help="paged KV dtype (int8 halves page traffic)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--draft-model",
                   help="GGML or GGUF draft model: speculative continuous batching")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    model_path = args.model or args.dir
    if not model_path:
        parser.error("one of -m/--model or -d/--dir is required")
    if args.tp != 1:
        parser.error(NOT_PORTED["tp"])

    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.loader import load_model
    from tokenhawk_tpu_torch.sampling import tokenizer_eos
    from tokenhawk_tpu_torch.serving.server import serve

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    print(f"Loading {model_path} ...", file=sys.stderr)
    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(model_path, n_ctx=args.n_ctx, dtype=dtype,
                                        device=args.device)
    print(f"Loaded in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    draft_cfg = draft_params = None
    if args.draft_model:
        draft_cfg, draft_params, _ = load_model(args.draft_model, n_ctx=args.n_ctx, dtype=dtype,
                                                device=args.device)
    spec = dict(draft_cfg=draft_cfg, draft_params=draft_params, gamma=args.gamma)
    sampling = SamplingConfig(
        temperature=0.0 if args.greedy else args.temp,
        top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty, seed=args.seed,
    )
    eos_id = tokenizer_eos(tokenizer)
    if args.paged:
        from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler

        sched = PagedScheduler(
            cfg, params, sampling=sampling, max_batch=args.max_batch, max_seq=args.n_ctx,
            decode_chunk=args.decode_chunk, page_size=args.page_size,
            cache_dtype="int8" if args.kv == "int8" else dtype,
            prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache, eos_id=eos_id,
            **spec)
    else:
        from tokenhawk_tpu_torch.runtime.scheduler import Scheduler

        if args.kv == "int8":
            print("note: --kv int8 applies to --paged; the dense server keeps bf16 KV",
                  file=sys.stderr)
        sched = Scheduler(cfg, params, sampling=sampling, max_batch=args.max_batch,
                          max_seq=args.n_ctx, decode_chunk=args.decode_chunk, eos_id=eos_id,
                          **spec)
    httpd = serve(sched, tokenizer, host=args.host, port=args.port,
                  model_info={"model": model_path, "n_ctx": args.n_ctx, "paged": args.paged,
                              "chat_template": tokenizer.chat_template, "speculative": bool(args.draft_model),
                              "device": str(params.device)})
    print(f"Serving on http://{args.host}:{args.port}", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.serving_loop.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
