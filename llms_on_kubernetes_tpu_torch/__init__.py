"""PyTorch/CUDA port of ``llms_on_kubernetes_tpu`` for one NVIDIA H100.

The JAX package stays the reference; every module here names its JAX
counterpart. The port imports ``torch`` and numpy, never ``jax`` and never
the JAX package. Its entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where each kernel wrapper takes its
plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no GPU is present: the port never carries on
    silently on the CPU — pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
