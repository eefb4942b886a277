"""Command-line entry point (counterpart of ``llms_on_kubernetes_tpu/cli.py``).

    python -m llms_on_kubernetes_tpu_torch serve --model llama-3-8b --random-weights \\
        [--device cuda|cpu] [--port 8080]

The engine defaults are ``EngineConfig``'s. Checkpoint loading is not
ported yet, so ``--random-weights`` is required: the model serves seeded
random weights at its full width.
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
    p.add_argument("--model", required=True, help="registry name (configs.py)")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", default=d.dtype)
    p.add_argument("--random-weights", action="store_true",
                   help="serve seeded random weights (required until the "
                        "checkpoint loader is ported)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--max-decode-slots", type=int, default=d.max_decode_slots)
    p.add_argument("--num-pages", type=int, default=d.num_pages)
    p.add_argument("--page-size", type=int, default=d.page_size)
    p.add_argument("--pages-per-slot", type=int, default=d.pages_per_slot)
    p.add_argument("--prefill-buckets", type=_buckets,
                   default=",".join(str(b) for b in d.prefill_buckets))
    p.add_argument("--decode-steps", type=int, default=d.decode_steps)
    p.add_argument("--kv-write", choices=["dus", "fused"], default=d.kv_write)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig
        from llms_on_kubernetes_tpu_torch.server.openai_api import serve

        if not args.random_weights:
            print("error: checkpoint loading is not ported yet; pass --random-weights",
                  file=sys.stderr)
            return 1
        cfg = EngineConfig(
            model=args.model, dtype=args.dtype, max_decode_slots=args.max_decode_slots,
            page_size=args.page_size, num_pages=args.num_pages,
            pages_per_slot=args.pages_per_slot, prefill_buckets=args.prefill_buckets,
            decode_steps=args.decode_steps, kv_write=args.kv_write, seed=args.seed,
            device=args.device)
        serve(args.model, host=args.host, port=args.port, device=args.device,
              random_weights=True, served_model_name=args.served_model_name,
              engine_config=cfg)
    return 0
