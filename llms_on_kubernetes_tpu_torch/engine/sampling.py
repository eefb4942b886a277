"""Batched token sampling on the device (counterpart of
``llms_on_kubernetes_tpu/engine/sampling.py``).

One function handles the whole batch with per-row parameters: temperature
(0 => greedy), top-k and top-p over a fixed candidate set of the
``MAX_CANDIDATES`` highest logits (exact ``torch.topk``; the TPU path's
``approx_max_k`` has no counterpart here), OpenAI presence/frequency
penalties, the OpenAI ``logit_bias`` map, and the Gumbel-max draw. It
also returns the chosen token's logprob and the ``LOGPROB_TOPK`` best
alternatives.

Random numbers: each row's Gumbel noise comes from a counter-based
generator keyed only by (engine seed, request seed, sequence position), so
a request's sampled stream never depends on which other requests share its
batch (the contract of the JAX ``sample``). The port cannot reproduce the
bits of JAX's threefry stream and does not try to.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -2.0e38
MAX_CANDIDATES = 64
LOGPROB_TOPK = 8

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply), on int64 tensors holding
    values in [0, 2**32). Products wrap mod 2**64; the low 32 bits are
    exact."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def gumbel_noise(base_seed: int, seeds: torch.Tensor, positions: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, n] float32: row b is a pure function of
    (base_seed, seeds[b], positions[b]), computed on the tensors' device."""
    dev = seeds.device
    key = _mix32(torch.full_like(seeds, base_seed & _M32, dtype=torch.int64) ^ 0x9E3779B9)
    key = _mix32(key ^ (seeds.long() & _M32))
    key = _mix32(key ^ (positions.long() & _M32))
    col = (torch.arange(n, device=dev, dtype=torch.int64) * 0x9E3779B9) & _M32
    bits = _mix32(key[:, None] ^ col[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))     # in (0, 1)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class SampleResult:
    """tokens [B] int32; logprobs [B] float32 (of the chosen token);
    top_ids / top_logprobs [B, LOGPROB_TOPK], sorted descending."""
    tokens: torch.Tensor
    logprobs: torch.Tensor
    top_ids: torch.Tensor
    top_logprobs: torch.Tensor


def sample(logits: torch.Tensor, noise: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           penalties: "tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None" = None,
           bias: "tuple[torch.Tensor, torch.Tensor] | None" = None,
           allowed: "torch.Tensor | None" = None) -> SampleResult:
    """logits [B, V]; noise [B, min(MAX_CANDIDATES, V)] Gumbel noise
    (``gumbel_noise``); temperature [B] (0 => greedy); top_k [B] (0 =>
    off); top_p [B] (1.0 => off); penalties = (presence [B], frequency [B],
    counts [B, V]) over the OUTPUT tokens so far, applied to the raw logits
    before candidate extraction; bias = (ids [B, N] int32, values [B, N]
    float32), the OpenAI ``logit_bias`` map, added after the penalties (so
    +100 forces a token and -100 bans it; the logprobs are the biased
    ones). A bias entry whose id is negative (padding, -1) or >= V is
    dropped, as the JAX scatter's ``mode="drop"`` drops it: its value is
    zeroed and its id clamped into the row, because a negative index would
    wrap and an out-of-range one is a device-side assert on a card.
    ``allowed`` [B, V] bool: grammar-constrained decoding's per-step token
    mask (``engine/grammar.py``), applied AFTER the bias (a +100 bias must
    not defeat a grammar) and before candidate extraction, so the logprobs
    renormalize over the allowed set, as the JAX ``sample`` applies it."""
    B, V = logits.shape
    logits = logits.float()
    if penalties is not None:
        presence, frequency, counts = penalties
        c = counts.float()
        logits = logits - presence[:, None] * (c > 0) - frequency[:, None] * c
    if bias is not None:
        b_ids, b_vals = bias
        keep = (b_ids >= 0) & (b_ids < V)
        logits = logits.scatter_add(1, b_ids.long().clamp(0, V - 1),
                                    torch.where(keep, b_vals.float(), 0.0))
    if allowed is not None:
        logits = torch.where(allowed, logits, NEG_INF)
    C = min(MAX_CANDIDATES, V)
    cand_logits, cand_idx = torch.topk(logits, C, dim=-1)         # sorted desc

    rank = torch.arange(C, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, C, torch.clamp(top_k, max=C))[:, None]
    keep_k = rank < k
    # probabilities against the FULL vocab, so the top-p cut is made on the
    # true distribution; the argmax token is always kept
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    cand_probs = torch.exp(cand_logits - lse)
    cumprob = torch.cumsum(cand_probs, dim=-1)
    keep_p = (cumprob - cand_probs) < top_p[:, None]
    masked = torch.where(keep_k & keep_p, cand_logits, NEG_INF)

    safe_temp = torch.clamp(temperature, min=1e-6)[:, None]
    sampled_rank = torch.argmax(masked / safe_temp + noise, dim=-1)
    chosen = torch.where(temperature <= 0.0, 0, sampled_rank)[:, None]
    K = min(LOGPROB_TOPK, C)
    return SampleResult(
        tokens=torch.gather(cand_idx, 1, chosen)[:, 0].to(torch.int32),
        logprobs=(torch.gather(cand_logits, 1, chosen) - lse)[:, 0],
        top_ids=cand_idx[:, :K].to(torch.int32),
        top_logprobs=cand_logits[:, :K] - lse,
    )
