"""Normalization ops (counterpart of ``llms_on_kubernetes_tpu/ops/norms.py``).

The variance is accumulated in float32 whatever the activation dtype, the
same numerics HF/vLLM and the JAX package use.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
             style: str = "llama") -> torch.Tensor:
    """RMSNorm over the last axis.

    style="llama": ``normalize(x) * w``  (Llama/Mistral/Qwen/Phi)
    style="gemma": ``normalize(x) * (1 + w)``  (Gemma stores weight-1)
    """
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if style == "gemma":
        w = 1.0 + w
    return (normed * w).to(dtype)
