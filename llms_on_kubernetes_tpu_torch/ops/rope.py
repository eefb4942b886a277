"""Rotary position embeddings, HF "rotate_half" convention (counterpart of
``llms_on_kubernetes_tpu/ops/rope.py``: ``rope_frequencies``,
``apply_rope`` and Qwen3-VL's interleaved ``apply_mrope``)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def rope_frequencies(head_dim: int, theta: float,
                     rope_scaling: Optional[dict] = None) -> np.ndarray:
    """Inverse frequencies [head_dim // 2], float32 (llama3 and linear
    scaling; anything else raises rather than serve wrong positions)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if rope_scaling:
        kind = rope_scaling.get("rope_type", rope_scaling.get("type", "llama3"))
        if kind == "linear":
            return (inv_freq / float(rope_scaling.get("factor", 1.0))).astype(np.float32)
        if kind != "llama3":
            raise NotImplementedError(f"unsupported rope_scaling type {kind!r}")
        factor = float(rope_scaling.get("factor", 8.0))
        low = float(rope_scaling.get("low_freq_factor", 1.0))
        high = float(rope_scaling.get("high_freq_factor", 4.0))
        orig = float(rope_scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        smooth = np.clip((orig / wavelen - low) / (high - low), 0.0, 1.0)
        scaled = inv_freq / factor
        inv_freq = np.where(
            wavelen > orig / low, scaled,
            np.where(wavelen < orig / high, inv_freq,
                     (1.0 - smooth) * scaled + smooth * inv_freq))
    return inv_freq.astype(np.float32)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [..., T, n_q, d] and k [..., T, n_kv, d] at integer
    ``positions`` [..., T] with ``inv_freq`` [d // 2] float32."""
    angles = positions[..., None].float() * inv_freq      # [..., T, d/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., T, 1, d/2]
    sin = torch.sin(angles)[..., None, :]

    def rot(x: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        x1 = x[..., :half].float()
        x2 = x[..., half:].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, pos3: torch.Tensor, inv_freq: torch.Tensor,
                mrope_section: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved multimodal rope (Qwen3-VL's text decoder): ``pos3``
    [..., 3, T] the (temporal, height, width) position of each token, all
    three equal for text, where this is exactly ``apply_rope``. The
    frequency channels take the axes interleaved T, H, W, T, H, W, ... up to
    3 * section[axis], then the temporal axis."""
    angles3 = pos3[..., :, :, None].float() * inv_freq                # [..., 3, T, d/2]
    half = inv_freq.shape[-1]
    axis_sel = np.zeros((half,), np.int64)
    for dim, offset in ((1, 1), (2, 2)):
        idx = np.arange(offset, 3 * mrope_section[dim], 3)
        axis_sel[idx[idx < half]] = dim
    sel = torch.from_numpy(axis_sel).to(pos3.device)
    angles = angles3[..., 0, :, :]
    for dim in (1, 2):
        angles = torch.where(sel == dim, angles3[..., dim, :, :], angles)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]

    def rot(x: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        x1 = x[..., :half].float()
        x2 = x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)
