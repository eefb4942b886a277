"""Flash prefill attention: the CUDA kernel's wrapper and its plain version
(counterpart of ``llms_on_kubernetes_tpu/ops/pallas_flash.py``).

``flash_prefill_attention`` launches ``csrc/flash_prefill.cu`` for CUDA
tensors and runs ``prefill_attention_plain`` (the gather-and-einsum of
``ops/attention.prefill_attention``) for CPU tensors. A CUDA tensor never
takes the plain version: a shape or dtype the kernel does not take raises.

Rows ``t >= lengths[b]`` of the output are padding. The kernel keeps them
finite (a query tile whose rows all lie there is zeros), but their values
are don't-care and differ from the plain version's.

The kernel has two bodies: bfloat16 with head_dim >= 16 runs on the tensor
cores (mma.sync, P rounded to bf16 for the P.V product); float32, and
bfloat16 with head_dim 8, run the f32 CUDA-core body. It is built for the
head dims of ``kernels.HEAD_DIMS`` (8 to 256, 96 among them); a CUDA
tensor of another head_dim raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.ops.attention import prefill_attention

KERNEL = "flash_prefill"


def prefill_attention_plain(q, k, v, lengths, *, scale: float,
                            sliding_window: Optional[int] = None,
                            attn_softcap: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version the kernel is held against."""
    return prefill_attention(q, k, v, lengths, scale=scale,
                             sliding_window=sliding_window,
                             attn_softcap=attn_softcap)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            lengths: torch.Tensor, *, scale: float,
                            sliding_window: Optional[int] = None,
                            attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Causal GQA self-attention over a padded prompt bucket.

    q [B, T, n_q, d]; k, v [B, T, n_kv, d]; lengths [B] int32 (keys at or
    beyond a row's length are masked). Returns [B, T, n_q, d] in q's dtype.
    """
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, lengths, scale=scale,
                                       sliding_window=sliding_window,
                                       attn_softcap=attn_softcap)
    B, T, n_q, d = q.shape
    n_kv = k.shape[2]
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"flash prefill kernel takes float32/bfloat16, got {q.dtype}")
    if d not in kernels.HEAD_DIMS:
        raise ValueError(f"flash prefill kernel takes head_dim in {kernels.HEAD_DIMS}, got {d}")
    if n_kv == 0 or n_q % n_kv:
        raise ValueError(f"n_q={n_q} is not a multiple of n_kv={n_kv}")
    # 16-byte aligned: the kernel copies rows in 16-byte vectors
    kernels.check_tensor("q", q, ndim=4, align=16)
    for name, t in (("k", k), ("v", v)):
        kernels.check_tensor(name, t, dtype=q.dtype, ndim=4, device=q.device, align=16)
        if tuple(t.shape) != (B, T, n_kv, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, T, n_kv, d)}")
    kernels.check_tensor("lengths", lengths, dtype=torch.int32, ndim=1, device=q.device)
    if lengths.shape[0] != B:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, expected {B}")
    out = torch.empty_like(q)
    fn = kernels.function(KERNEL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), B, T, n_q, n_kv, d, float(scale),
             int(sliding_window or 0), float(attn_softcap or 0.0),
             kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q))
    kernels.check(KERNEL, err)
    kernels.LAUNCHES[KERNEL] += 1
    return out
