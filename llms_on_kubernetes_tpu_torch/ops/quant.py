"""Weight-only int8 quantization for serving (counterpart of
``llms_on_kubernetes_tpu/ops/quant.py``: ``QTensor``, ``quantize``,
``quantize_params``, ``fp8_dequantize`` and ``qeinsum``'s int8 path).

A ``QTensor`` holds int8 ``data`` in the JAX layout (layer-stacked, head
axes explicit: ``wq [L, D, H, hd]``, ``wo [L, H, hd, D]``) and a float32
``scale`` with keepdims over the contraction axes (``wq``'s scale is
``[L, 1, H, hd]``): one symmetric scale per output channel and layer.
Indexing it (``w[layer]``) gives a QTensor of views, so the decoder's
layer loop and a captured CUDA graph read the same addresses every time.

``w8_matmul`` is the projection: on a CUDA tensor it launches the
hand-written W8A16 kernel (``csrc/w8_matmul.cu``), which converts the
int8 weight tile on its way to the tensor cores, so no bf16 copy of the
weight is ever written; on a CPU tensor it runs ``w8_matmul_plain``, the
JAX ``qeinsum`` formula. A CUDA tensor never takes the plain version: a
shape, dtype or layout the kernel does not take raises. ``w8_splits``
gives the kernel's K slices (its bf16 bodies sum each slice's chain, then
the slices in order), so the split can be known and tested without a card.

Pre-quantized checkpoints declare their format in ``config.json``
(``checkpoint_quantization``): compressed-tensors fp8 is dequantized with
``fp8_dequantize`` and requantized to the same int8 QTensors, as the JAX
loader does (``engine/weights.load_hf_params``). AWQ needs a grouped
int4 kernel of its own and is refused there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels

Params = dict[str, Any]
KERNEL = "w8_matmul"

# "fp8" / "awq" declare the CHECKPOINT's format (checked against its
# quantization_config at load); serving streams weight-only int8 either way
SUPPORTED_QUANTIZATIONS = (None, "int8", "fp8", "awq")

# weight name -> contraction (input) axes of the stacked weight: wq
# [L, D, H, hd] contracts over D; None: the MLP weights, by rank (MoE)
_LAYER_REDUCE_AXES = {
    "wq": (1,), "wk": (1,), "wv": (1,),
    "wo": (1, 2),                 # [L, H, hd, D] contracts over (H, hd)
    "w_gate": None, "w_up": None, "w_down": None,
}


def reduce_axes_for(name: str, ndim: int) -> tuple[int, ...]:
    """Contraction axes of stacked weight ``name`` of rank ``ndim``."""
    axes = _LAYER_REDUCE_AXES[name]
    if axes is not None:
        return axes
    return (2,) if ndim == 4 else (1,)


class QTensor:
    """int8 weight and its float32 per-channel scale (keepdims over the
    contraction axes, so it broadcasts against ``data``)."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.data.float() * self.scale).to(dtype)

    def __getitem__(self, idx) -> "QTensor":
        """Views of both parts (the layer loop takes ``w[layer]``)."""
        return QTensor(self.data[idx], self.scale[idx])

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scale.to(device))

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __repr__(self):
        return f"QTensor(shape={tuple(self.data.shape)}, scale={tuple(self.scale.shape)})"


def quantize(w: torch.Tensor, reduce_axes: tuple[int, ...]) -> QTensor:
    """Symmetric int8 over ``reduce_axes`` (the contraction axes), as the
    JAX ``quantize``: scale = amax / 127 (1 where amax is 0), data =
    clip(round(w / scale), -127, 127), rounding half to even, in float32
    from ``w``'s value. Both divisions divide by a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal (one ulp off),
    so the card gives numpy's bytes."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    data = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return QTensor(data, scale)


def quantize_stack(w: torch.Tensor, reduce_axes: tuple[int, ...]) -> QTensor:
    """``quantize`` of a layer-stacked weight one layer at a time (the
    axes exclude the layer axis 0, so the bytes are the same), so the
    float32 temporaries never hold more than one layer."""
    axes = tuple(a - 1 for a in reduce_axes)
    out: Optional[QTensor] = None
    for i in range(w.shape[0]):
        q = quantize(w[i], axes)
        if out is None:
            out = QTensor(torch.empty(w.shape, dtype=torch.int8, device=w.device),
                          torch.empty((w.shape[0], *q.scale.shape), dtype=torch.float32,
                                      device=w.device))
        out.data[i].copy_(q.data)
        out.scale[i].copy_(q.scale)
    return out


def quantize_params(params: Params) -> Params:
    """The decoder's matmul weights quantized to int8 QTensors; the
    embedding, the LM head and the norms stay in their dtype (the JAX
    policy: the embedding is a gather and the logits matmul is the most
    sensitive to rounding)."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_REDUCE_AXES:
        w = layers.get(name)
        if w is None or isinstance(w, QTensor):
            continue
        layers[name] = quantize_stack(w, reduce_axes_for(name, w.dim()))
    out["layers"] = layers
    return out


def fp8_dequantize(weight: torch.Tensor, weight_scale: torch.Tensor) -> torch.Tensor:
    """compressed-tensors fp8 -> float32 ``[out, in]``: ``weight``
    float8_e4m3fn ``[out, in]``, ``weight_scale`` a scalar (per tensor),
    ``[out]`` or ``[out, 1]`` (per channel)."""
    w = weight.float()
    s = weight_scale.float()
    if s.dim() == 1:        # [out] -> a per-channel column
        s = s[:, None]
    return w * s


# ---------------------------------------------------------------------------
# The projection: the W8A16 kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

# the K split of the kernel's bf16 bodies (csrc/w8_matmul.cu w8_split)
W8_SLAB = 128          # columns a decode block (kSlab)
W8_MIN_BLOCKS = 128    # decode blocks to aim for (kMinBlocks)
W8_MAX_CLUSTER = 8     # blocks a cluster at most (kMaxCluster)
W8_SLICE_GROUPS = 2    # slices a decode block (kSliceGroups)
W8_MAX_SLICE = 1024    # K rows a slice stays within where S allows (kMaxSlice)


def w8_splits(K: int, N: int) -> list[tuple[int, int]]:
    """The K slices ``[(k0, k1), ...]`` of the kernel's bf16 bodies for a
    K x N weight: contiguous, in order, covering ``[0, K)``, each a whole
    number of units (64 rows when 64 divides K, else 16). Their number S is
    a power of two chosen from K and N alone (enough decode blocks for the
    card, slices of at most ``W8_MAX_SLICE`` rows where S allows), so a
    row's result never depends on M: each output is each slice's f32
    chain, the chains summed in slice order, then ``qeinsum``'s two
    roundings."""
    unit = 64 if K % 64 == 0 else 16
    units = K // unit
    slabs = -(-N // W8_SLAB)
    kb = 1
    while slabs * kb < W8_MIN_BLOCKS and kb < W8_MAX_CLUSTER:
        kb *= 2
    s = W8_SLICE_GROUPS * kb
    while s < W8_SLICE_GROUPS * W8_MAX_CLUSTER and s * W8_MAX_SLICE < K:
        s *= 2
    while s > units:
        s //= 2
    return [(unit * (i * units // s), unit * ((i + 1) * units // s)) for i in range(s)]


def w8_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX ``qeinsum`` formula: the product with the int8 weight
    converted to x's dtype, rounded to x's dtype, then times the scale in
    x's dtype, rounded again. x ``[..., K]``, w int8 ``[K, N]``, scale
    ``[N]``; returns ``[..., N]`` in x's dtype."""
    y = torch.matmul(x, w.to(x.dtype))
    return y * scale.to(x.dtype)


def w8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x ``[M, K]`` (float32 or bfloat16) times int8 w ``[K, N]``, each
    output column times ``scale[N]`` (float32): ``w8_matmul_plain``'s
    function. A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/w8_matmul.cu`` (M >= 1, K and N multiples of 16, all contiguous
    and 16-byte aligned) or raises. bfloat16 rows come out bit for bit the
    same at any M (the split of ``w8_splits``); float32 runs one chain over
    K on the CUDA cores."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w, scale)
    if x.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"w8_matmul kernel takes float32/bfloat16 x, got {x.dtype}")
    kernels.check_tensor("x", x, ndim=2, align=16)
    kernels.check_tensor("w", w, dtype=torch.int8, ndim=2, device=x.device, align=16)
    kernels.check_tensor("scale", scale, dtype=torch.float32, ndim=1, device=x.device,
                         align=16)
    M, K = x.shape
    N = w.shape[1]
    if M < 1:
        raise ValueError("w8_matmul kernel takes M >= 1 rows")
    if w.shape[0] != K or scale.shape[0] != N:
        raise ValueError(f"w8_matmul: x {tuple(x.shape)}, w {tuple(w.shape)} and scale "
                         f"{tuple(scale.shape)} do not chain")
    if K % 16 or N % 16:
        raise ValueError(f"w8_matmul kernel takes K and N multiples of 16, got K={K} N={N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = kernels.function(KERNEL)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N,
             kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x))
    kernels.check(KERNEL, err)
    kernels.count(KERNEL)
    return out
