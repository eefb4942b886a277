"""Command-line entry point (counterpart of ``llms_on_kubernetes_tpu/cli.py``).

    python -m llms_on_kubernetes_tpu_torch serve --model MODEL [--random-weights] \\
        [--device cuda|cpu] [--port 8080] [--kv-cache-dtype int8] [--kv-write dus|fused] \\
        [--quantization int8|fp8|awq] [--no-prefix-caching] [--watchdog-stall-s S] \\
        [--decode-steps K] [--kv-host-cache-gb GB] [--speculation ngram|draft] \\
        [--draft-model NAME_OR_GGUF] [--no-warmup] [--no-ledger] [--no-anomaly-profile] \\
        [--anomaly-z Z] [--anomaly-cooldown-s S] [--max-images-per-request N]

``serve``'s defaults are the JAX ``serve``'s (``cli._add_serve``): 8
slots, 2,048 pages of 64 tokens, 64 pages a slot (a 4,096-token context)
and prefill buckets 256, 1,024 and 4,096; ``EngineConfig``'s own defaults
are smaller and are what code that builds an engine directly gets.
``--decode-steps``, ``--kv-write``, ``--kv-host-cache-gb``,
``--speculation``, ``--draft-model``, ``--no-ledger``,
``--no-anomaly-profile``, ``--anomaly-z`` and ``--anomaly-cooldown-s``
default to the environment (``LLMK_DECODE_STEPS``, ``LLMK_KV_WRITE``,
``LLMK_KV_HOST_CACHE_GB``, ``LLMK_SPECULATION``, ``LLMK_DRAFT_MODEL``,
``LLMK_LEDGER``, ``LLMK_ANOMALY_PROFILE``, ``LLMK_ANOMALY_Z``,
``LLMK_ANOMALY_COOLDOWN_S``), as the JAX engine's config does; a flag wins
over the environment. Before ``/health`` answers, the server warms up as
the JAX one does: a 4-token prompt generates 2 greedy tokens (the
"compile" phase of ``llm_cold_start_seconds``); ``--no-warmup`` skips it. The serving role (prefill, decode or both) comes
from ``LLMK_ROLE`` alone, and the engine's fair-queue config from
``LLMK_QOS``, JSON as the JAX CLI reads it: ``{"weights": {"alice": 4},
"priorities": {"bulk": "batch"}, "default_priority": "normal",
"default_weight": 1, "starvation_s": 5}``. ``LLMK_FAULT`` arms the fault
hooks of ``faults.py``.

``MODEL`` is a registry name (``configs.py``), a local checkpoint directory
(``config.json`` and ``*.safetensors``: the model config comes from the
registry for a registry name, else from that ``config.json``), a llama.cpp
``.gguf`` file (the model config from its metadata; tokenizer files beside
it win, else the vocabulary and chat template it embeds), or a
HuggingFace repo id or registry name whose snapshot is in the local HF
cache. Nothing is downloaded. Missing weights are a startup failure: the
process exits 1 and names ``--random-weights``, which serves seeded random
weights at the model's full width instead.

SIGTERM drains the server: ``/ready`` answers 503 (routers eject the
replica), new requests get 503, and the process exits 0 once the requests
in flight are done, at most 55 s later (``EngineLoop.drain_timeout_s``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _buckets(v: str) -> tuple[int, ...]:
    return tuple(int(b) for b in v.split(",") if b.strip())


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig

    # the fields' own defaults: EngineConfig() would validate the
    # environment (LLMK_ROLE=prefill needs the tier a flag may give)
    d = argparse.Namespace(**{f.name: f.default for f in dataclasses.fields(EngineConfig)})
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
    # the JAX serve's pool and buckets (cli._add_serve), not EngineConfig's
    p.add_argument("--max-decode-slots", type=int, default=8)
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--pages-per-slot", type=int, default=64)
    p.add_argument("--prefill-buckets", type=_buckets, default="256,1024,4096")
    p.add_argument("--decode-steps", type=int, default=None,
                   help="tokens a decode window runs (default: env LLMK_DECODE_STEPS, "
                        "else 4)")
    p.add_argument("--kv-write", choices=["dus", "fused"], default=None,
                   help="KV append strategy (default: env LLMK_KV_WRITE, else dus)")
    p.add_argument("--kv-cache-dtype", choices=["int8"], default=None,
                   help="KV cache storage dtype (default: the model dtype, or env "
                        "LLMK_KV_DTYPE)")
    p.add_argument("--quantization", choices=["int8", "fp8", "awq"], default=None,
                   help="int8: weight-only quantize the checkpoint (or the random "
                        "weights); fp8/awq: assert the checkpoint is that pre-quantized "
                        "format (auto-detected otherwise)")
    p.add_argument("--no-prefix-caching", dest="prefix_caching", action="store_false",
                   help="disable hash-chained prefix reuse (cached prompt pages)")
    p.add_argument("--kv-host-cache-gb", type=float, default=None,
                   help="host-RAM KV tier in GiB: finished and preempted sessions park "
                        "their pages in host memory and a returning one uploads them "
                        "instead of prefilling (default: env LLMK_KV_HOST_CACHE_GB, else "
                        "off; needs prefix caching)")
    p.add_argument("--speculation", choices=["ngram", "draft"], default=None,
                   help="speculative decoding riding the decode window: ngram = "
                        "model-free prompt lookup, draft = a small draft model via "
                        "--draft-model (default: env LLMK_SPECULATION, else off; "
                        "greedy outputs match speculation off up to the verify's "
                        "rounding)")
    p.add_argument("--draft-model", default=None,
                   help="draft model for --speculation draft (registry name, random "
                        "weights from --seed, or a .gguf path; default: env "
                        "LLMK_DRAFT_MODEL; implies --speculation draft)")
    p.add_argument("--watchdog-stall-s", type=float, default=d.watchdog_stall_s,
                   help="seconds a device step may go without completing before the "
                        "engine sheds all work as 'stalled' and /health turns 503 "
                        "(the budget is max(this, 50 x the step estimate); <= 0 "
                        "disables; default: env LLMK_WATCHDOG_S, else 120)")
    p.add_argument("--max-images-per-request", type=_positive_int,
                   default=d.max_images_per_request,
                   help="images a request may carry (a vision model); requests beyond it "
                        "get a 400")
    p.add_argument("--adapter", action="append", default=None, metavar="NAME=DIR",
                   help="repeatable: serve the LoRA adapter NAME from the local PEFT "
                        "directory DIR; requests address it as model=<served-name>:NAME")
    p.add_argument("--adapter-slots", type=_positive_int, default=d.adapter_slots,
                   help="on-device adapter slots (LRU-recycled)")
    p.add_argument("--adapter-rank", type=_positive_int, default=d.adapter_rank,
                   help="max LoRA rank the device stacks are sized for")
    p.add_argument("--no-ledger", dest="ledger", action="store_false", default=None,
                   help="disable the goodput ledger (per-request chip-time attribution, "
                        "MFU/MBU gauges, per-tenant chip-seconds; default: env "
                        "LLMK_LEDGER, else on)")
    p.add_argument("--no-anomaly-profile", dest="anomaly_profile", action="store_false",
                   default=None,
                   help="disable the step-time anomaly watchdog's automatic profiler "
                        "captures (default: env LLMK_ANOMALY_PROFILE, else on)")
    p.add_argument("--anomaly-z", type=float, default=None,
                   help="z-score a dispatch's device time must exceed to count as "
                        "anomalous (default: env LLMK_ANOMALY_Z, else 4.0)")
    p.add_argument("--anomaly-cooldown-s", type=float, default=None,
                   help="minimum seconds between automatic profiler captures (default: "
                        "env LLMK_ANOMALY_COOLDOWN_S, else 600)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false", default=True,
                   help="skip the warm-up generation before /health answers (the first "
                        "request then pays the first prefill and window)")
    return ap


def adapters_from_args(args) -> dict:
    """``--adapter NAME=DIR`` flags as {name: dir}; a malformed one exits."""
    adapters = {}
    for spec in args.adapter or ():
        name, _, ref = spec.partition("=")
        if not name or not ref:
            raise SystemExit(f"[serve] --adapter must be NAME=DIR, got {spec!r}")
        adapters[name] = ref
    return adapters


def qos_from_env() -> dict:
    """``LLMK_QOS`` (the engine's fair-queue config, JSON) as EngineConfig
    keywords, as the JAX CLI reads it; unset or empty: none."""
    raw = os.environ.get("LLMK_QOS", "").strip()
    if not raw:
        return {}
    try:
        q = json.loads(raw)
    except ValueError as e:
        raise SystemExit(f"[serve] LLMK_QOS is not valid JSON: {e}")
    return dict(qos_weights=q.get("weights", ()), qos_priorities=q.get("priorities", ()),
                qos_default_weight=float(q.get("default_weight", 1.0)),
                qos_default_priority=str(q.get("default_priority", "normal")),
                qos_starvation_s=float(q.get("starvation_s", 5.0)))


def engine_config_from_args(args):
    """The ``serve`` flags as an ``EngineConfig``; a flag left unset (None)
    falls through to the config's own default, the environment's where
    the config reads one. ``LLMK_QOS`` adds the fair-queue fields."""
    from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig

    return EngineConfig(
        model=args.model, dtype=args.dtype, max_decode_slots=args.max_decode_slots,
        page_size=args.page_size, num_pages=args.num_pages,
        pages_per_slot=args.pages_per_slot, prefill_buckets=args.prefill_buckets,
        decode_steps=args.decode_steps, kv_write=args.kv_write,
        kv_cache_dtype=args.kv_cache_dtype, quantization=args.quantization,
        prefix_caching=args.prefix_caching, watchdog_stall_s=args.watchdog_stall_s,
        kv_host_cache_gb=args.kv_host_cache_gb, speculation=args.speculation,
        draft_model=args.draft_model, seed=args.seed, device=args.device,
        adapters=adapters_from_args(args), adapter_slots=args.adapter_slots,
        adapter_rank=args.adapter_rank, ledger=args.ledger,
        anomaly_profile=args.anomaly_profile, anomaly_z=args.anomaly_z,
        anomaly_cooldown_s=args.anomaly_cooldown_s,
        max_images_per_request=args.max_images_per_request, **qos_from_env())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        from llms_on_kubernetes_tpu_torch.engine.weights import resolve_model_dir
        from llms_on_kubernetes_tpu_torch.server.openai_api import serve

        model_dir = None
        if args.model.endswith(".gguf"):
            if not os.path.isfile(args.model):
                print(f"error: GGUF file not found: {args.model}", file=sys.stderr)
                return 1
        elif not args.random_weights:
            try:
                model_dir = resolve_model_dir(args.model)
            except FileNotFoundError as e:
                print(f"error: cannot obtain weights for {args.model!r}: {e}\n"
                      f"(pass --random-weights to serve seeded random weights)",
                      file=sys.stderr)
                return 1
        cfg = engine_config_from_args(args)
        serve(args.model, host=args.host, port=args.port, device=args.device,
              random_weights=args.random_weights, served_model_name=args.served_model_name,
              engine_config=cfg, model_dir=model_dir, warmup=args.warmup)
    return 0
