"""Command-line entry point (counterpart of ``llms_on_kubernetes_tpu/cli.py``).

    python -m llms_on_kubernetes_tpu_torch serve --model MODEL [--random-weights] \\
        [--device cuda|cpu] [--port 8080] [--kv-cache-dtype int8] [--kv-write dus|fused] \\
        [--no-prefix-caching]

``MODEL`` is a registry name (``configs.py``), a local checkpoint directory
(``config.json`` and ``*.safetensors``: the model config comes from the
registry for a registry name, else from that ``config.json``), or a
HuggingFace repo id or registry name whose snapshot is in the local HF
cache. Nothing is downloaded. Missing weights are a startup failure: the
process exits 1 and names ``--random-weights``, which serves seeded random
weights at the model's full width instead. The engine defaults are
``EngineConfig``'s.
"""

from __future__ import annotations

import argparse
import sys


def _buckets(v: str) -> tuple[int, ...]:
    return tuple(int(b) for b in v.split(",") if b.strip())


def build_parser() -> argparse.ArgumentParser:
    from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig

    d = EngineConfig()
    ap = argparse.ArgumentParser(prog="python -m llms_on_kubernetes_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve", help="run the OpenAI-compatible engine server")
    p.add_argument("--model", required=True,
                   help="registry name, checkpoint directory, or HF id in the local cache")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", default=d.dtype)
    p.add_argument("--random-weights", action="store_true",
                   help="serve seeded random weights instead of a checkpoint")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--max-decode-slots", type=int, default=d.max_decode_slots)
    p.add_argument("--num-pages", type=int, default=d.num_pages)
    p.add_argument("--page-size", type=int, default=d.page_size)
    p.add_argument("--pages-per-slot", type=int, default=d.pages_per_slot)
    p.add_argument("--prefill-buckets", type=_buckets,
                   default=",".join(str(b) for b in d.prefill_buckets))
    p.add_argument("--decode-steps", type=int, default=d.decode_steps)
    p.add_argument("--kv-write", choices=["dus", "fused"], default=d.kv_write)
    p.add_argument("--kv-cache-dtype", choices=["int8"], default=None,
                   help="KV cache storage dtype (default: the model dtype, or env "
                        "LLMK_KV_DTYPE)")
    p.add_argument("--no-prefix-caching", dest="prefix_caching", action="store_false",
                   help="disable hash-chained prefix reuse (cached prompt pages)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig
        from llms_on_kubernetes_tpu_torch.engine.weights import resolve_model_dir
        from llms_on_kubernetes_tpu_torch.server.openai_api import serve

        model_dir = None
        if not args.random_weights:
            try:
                model_dir = resolve_model_dir(args.model)
            except FileNotFoundError as e:
                print(f"error: cannot obtain weights for {args.model!r}: {e}\n"
                      f"(pass --random-weights to serve seeded random weights)",
                      file=sys.stderr)
                return 1
        cfg = EngineConfig(
            model=args.model, dtype=args.dtype, max_decode_slots=args.max_decode_slots,
            page_size=args.page_size, num_pages=args.num_pages,
            pages_per_slot=args.pages_per_slot, prefill_buckets=args.prefill_buckets,
            decode_steps=args.decode_steps, kv_write=args.kv_write,
            kv_cache_dtype=args.kv_cache_dtype, prefix_caching=args.prefix_caching,
            seed=args.seed, device=args.device)
        serve(args.model, host=args.host, port=args.port, device=args.device,
              random_weights=args.random_weights, served_model_name=args.served_model_name,
              engine_config=cfg, model_dir=model_dir)
    return 0
