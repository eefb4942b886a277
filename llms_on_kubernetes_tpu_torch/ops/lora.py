"""Batched multi-adapter LoRA: per-row adapter deltas beside the base
projection (counterpart of ``llms_on_kubernetes_tpu/ops/lora.py``).

- ``LoRAStack`` holds every resident adapter's factors for one target
  weight, slot-major, with the layer stack leading: ``a`` float32 ``[L,
  S, *in, r]`` and ``b`` float32 ``[L, S, r, *out]`` (alpha/r folded into
  ``b`` at load). The engine allocates it once and only ever copies into
  a slot: a captured CUDA graph reads its addresses on every replay.
  Indexing by layer gives views. An empty slot is zeros: its delta
  vanishes.
- ``lora_delta`` is the JAX masked sum over slots in one pass: ``x @ a``
  for every slot at once (one batched product over slots and chunks of
  the contraction, then a sum over the chunks), each row's rank vector
  kept for its own slot only (idx < 0, the base model, keeps none), then
  one product with ``b`` flattened over (slot, rank). Only one slot is
  non-zero a row, so it is the JAX function: each row's own slot's delta,
  exactly zero for a base row. The delta is float32; ``decoder._proj``
  adds it to the base product (``torch.matmul``, W8A16 or W4A16, whichever
  the weight takes) in float32 and casts to the base's dtype, as
  ``lora_qeinsum`` does.

The delta runs in PyTorch ops (the JAX package leaves it to XLA as well):
no Pallas kernel computes it there.
"""

from __future__ import annotations

import math

import torch


class LoRAStack:
    """All resident adapters' factors for ONE target weight."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        self.a = a
        self.b = b

    @property
    def rank(self) -> int:
        return self.a.shape[-1]

    def __getitem__(self, idx) -> "LoRAStack":
        """Views of both factors (the layer loop takes ``stack[layer]``)."""
        return LoRAStack(self.a[idx], self.b[idx])

    def __repr__(self):
        return f"LoRAStack(a={tuple(self.a.shape)}, b={tuple(self.b.shape)})"


def lora_zeros(num_layers: int, num_slots: int, in_shape: tuple, out_shape: tuple, rank: int,
               device="cpu") -> LoRAStack:
    """An empty (all slots vacant) stack for one layer-stacked target."""
    a = torch.zeros((num_layers, num_slots, *in_shape, rank), dtype=torch.float32,
                    device=device)
    b = torch.zeros((num_layers, num_slots, rank, *out_shape), dtype=torch.float32,
                    device=device)
    return LoRAStack(a, b)


def _delta_eqs(eq: str) -> tuple[str, str]:
    """The two rank-space einsums of a base equation, as the JAX
    ``_delta_eqs`` derives them: "btd,dhk->bthk" -> ("btd,dr->btr",
    "btr,rhk->bthk")."""
    lhs, out = eq.split("->")
    x_sub, w_sub = lhs.split(",")
    batch = "".join(c for c in x_sub if c not in w_sub)
    contract = "".join(c for c in x_sub if c in w_sub)
    out_dims = "".join(c for c in out if c not in x_sub)
    assert "r" not in eq, f"rank label collides in {eq!r}"
    return f"{x_sub},{contract}r->{batch}r", f"{batch}r,r{out_dims}->{out}"


# K rows a chunk of the rank-space contraction: x @ a has a tiny output
# (rows x rank) and a long K, which one GEMM runs on a few thread blocks
# (0.70 ms for one layer's four deltas at 8 rows on the H100, PERF.md);
# cut into chunks it is one batched GEMM over (slot, chunk) and a sum
LORA_K_CHUNK = 128


def lora_delta_rows(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """The float32 delta of rows ``x [R, K]`` whose slots are ``idx [R]``
    (< 0: none), for one layer's factors ``a [S, K, r]`` and ``b [S, r,
    N]``: ``[R, N]``."""
    S, K, r = a.shape
    R = x.shape[0]
    kc = LORA_K_CHUNK if K % LORA_K_CHUNK == 0 else K
    xs = x.float().reshape(R, K // kc, kc).transpose(0, 1)               # [c, R, kc]
    t = torch.matmul(xs[None], a.reshape(S, K // kc, kc, r)).sum(dim=1)  # [S, R, r]
    keep = idx.to(torch.int64)[None, :] == torch.arange(S, device=idx.device)[:, None]
    t = torch.where(keep[:, :, None], t, 0.0)
    return torch.matmul(t.transpose(0, 1).reshape(R, S * r), b.reshape(S * r, -1))


def lora_delta_flat(x: torch.Tensor, lora: LoRAStack, idx: torch.Tensor,
                    n_in: int) -> torch.Tensor:
    """The float32 delta of ``x [B, ..., *in]`` (its last ``n_in`` axes
    contracted; row b's slot ``idx[b]``) for one layer's stack: ``[B, ...,
    N]``, the output axes flattened."""
    lead = x.shape[:x.dim() - n_in]
    K = math.prod(x.shape[x.dim() - n_in:])
    S, r = lora.a.shape[0], lora.rank
    rows = idx.reshape(-1, *([1] * (len(lead) - 1))).expand(lead).reshape(-1)
    d = lora_delta_rows(x.reshape(-1, K), lora.a.reshape(S, K, r), lora.b.reshape(S, r, -1),
                        rows)
    return d.reshape(*lead, -1)


def lora_delta(eq: str, x: torch.Tensor, lora: LoRAStack, idx: torch.Tensor) -> torch.Tensor:
    """The sum of per-slot adapter deltas, each kept to its rows (the JAX
    ``lora_delta``): ``eq`` the base equation (x's leading axis the batch
    row whose slot ``idx [B]`` gives, its contracted axes last), ``lora``
    one layer's stack. Returns the float32 delta in the base output's
    shape."""
    _delta_eqs(eq)       # asserts the equation holds no rank label
    x_sub, w_sub = eq.split("->")[0].split(",")
    n_in = sum(c in w_sub for c in x_sub)
    d = lora_delta_flat(x, lora, idx, n_in)
    return d.reshape(*d.shape[:-1], *lora.b.shape[2:])


def merge_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dense ``[in.., out..]`` weight delta of ONE adapter's factors
    (``[in.., r]``, ``[r, out..]``): the merged-weights reference."""
    return torch.tensordot(a.float(), b.float(), dims=([-1], [0]))
