"""Write a PEFT LoRA adapter (``adapter_config.json`` and
``adapter_model.safetensors``) for a registry model, at its full width,
with seeded random factors.

    python -m llms_on_kubernetes_tpu_torch.testing.synth_adapter qwen3-8b OUT_DIR \
        [--rank 16] [--alpha 32] [--modules q,k,v,o] [--seed 0]

Neither machine this repository runs on can download published adapters,
so the card's run serves adapters this module writes: PEFT's tensor names
(``base_model.model.model.layers.{i}.{self_attn|mlp}.{m}_proj.lora_{A|B}
.weight``) and layouts (``lora_A [r, in]``, ``lora_B [out, r]``), float32,
``scale`` times standard normal draws from ``seed``. The file goes
through ``synth_checkpoint``'s own header writer, not the ``safetensors``
package. Every knob a loader test corrupts (``config``, ``shapes``,
``layers``, ``modules``) can be overridden.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from llms_on_kubernetes_tpu_torch.configs import ModelConfig, get_config
from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import _header

MLP_MODULES = ("gate", "up", "down")


def peft_shapes(cfg: ModelConfig) -> dict:
    """PEFT module -> (in_features, out_features) of ``cfg``'s linears."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"q": (D, H * hd), "k": (D, KV * hd), "v": (D, KV * hd), "o": (H * hd, D),
            "gate": (D, F), "up": (D, F), "down": (F, D)}


def write_safetensors(path: str, tensors: dict) -> None:
    """float32 ``tensors`` (name -> array) as one safetensors file."""
    entries = [(name, tuple(a.shape), "F32", 4) for name, a in tensors.items()]
    with open(path, "wb") as f:
        f.write(_header(entries))
        for a in tensors.values():
            f.write(memoryview(np.ascontiguousarray(a, np.float32)).cast("B"))


def write_peft(dirpath, cfg: ModelConfig, rank: int = 4, alpha: float = 8,
               modules=("q", "k", "v", "o"), layers=None, shapes=None, config=None,
               seed: int = 0, scale: float = 0.1) -> str:
    """A PEFT LoRA checkpoint for ``cfg`` under ``dirpath`` (made if
    missing); returns the directory."""
    dirpath = str(dirpath)
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "adapter_config.json"), "w") as f:
        json.dump(config if config is not None else {"r": rank, "lora_alpha": alpha}, f)
    shapes = shapes or peft_shapes(cfg)
    rng = np.random.default_rng(seed)
    tensors = {}
    for layer in range(cfg.num_layers if layers is None else layers):
        for mod in modules:
            fin, fout = shapes[mod]
            part = "mlp" if mod in MLP_MODULES else "self_attn"
            pre = f"base_model.model.model.layers.{layer}.{part}.{mod}_proj"
            tensors[pre + ".lora_A.weight"] = (
                scale * rng.standard_normal((rank, fin))).astype(np.float32)
            tensors[pre + ".lora_B.weight"] = (
                scale * rng.standard_normal((fout, rank))).astype(np.float32)
    write_safetensors(os.path.join(dirpath, "adapter_model.safetensors"), tensors)
    return dirpath


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m llms_on_kubernetes_tpu_torch.testing."
                                      "synth_adapter")
    ap.add_argument("model", help="a registry model")
    ap.add_argument("out_dir")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=32.0)
    ap.add_argument("--modules", default="q,k,v,o")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.02)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    write_peft(args.out_dir, get_config(args.model), rank=args.rank, alpha=args.alpha,
               modules=tuple(m for m in args.modules.split(",") if m), seed=args.seed,
               scale=args.scale)
    print(args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
