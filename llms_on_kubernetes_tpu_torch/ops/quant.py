"""Weight-only int8 quantization for serving (counterpart of
``llms_on_kubernetes_tpu/ops/quant.py``: ``QTensor``, ``quantize``,
``quantize_params``, ``fp8_dequantize`` and ``qeinsum``'s int8 path).

A ``QTensor`` holds int8 ``data`` in the JAX layout (layer-stacked, head
axes explicit: ``wq [L, D, H, hd]``, ``wo [L, H, hd, D]``; an MoE model's
expert stacks ``[L, E, D, F]`` / ``[L, E, F, D]``) and a float32 ``scale``
with keepdims over the contraction axes (``wq``'s scale is ``[L, 1, H,
hd]``, ``w_gate``'s ``[L, E, 1, F]``): one symmetric scale per output
channel, layer and expert.
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
loader does (``engine/weights.load_hf_params``).

AWQ checkpoints are served natively, as the JAX package serves them: a
``GroupQTensor`` holds the centered int4 values of G groups of ``gs``
input rows (``data`` int8 ``[..., G, gs/2, O]`` with two nibbles a byte,
or ``[..., G, gs, O]`` widened), with per-group ``scale`` and
``zero_scaled`` float32 ``[..., G, O]``; ``awq_group_tensors`` makes one
from AWQ's packed int32 tensors, on whatever device they are (the loader
unpacks on the card). ``w4_matmul`` is its projection: the hand-written
W4A16 kernel (``csrc/w4_matmul.cu``) on a CUDA tensor, which unpacks each
nibble in registers on its way to the tensor cores, or
``group_qeinsum_plain`` (the JAX ``group_qeinsum`` scan, group after
group) on a CPU tensor. ``w4_splits`` gives the kernel's K slices (whole
groups, from K, N and the group size alone).
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels

Params = dict[str, Any]
KERNEL = "w8_matmul"
W4_KERNEL = "w4_matmul"

# "fp8" / "awq" declare the CHECKPOINT's format (checked against its
# quantization_config at load): an fp8 checkpoint serves weight-only int8,
# an AWQ one grouped int4 (GroupQTensor)
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
    """``quantize`` of a layer-stacked weight a slice at a time
    (``quantize_drawn``; the axes exclude the layer axis 0, so the bytes
    are the same), so the float32 temporaries never hold more than one
    layer."""
    slices = iter(w.reshape(-1, *w.shape[min(reduce_axes):]))
    return quantize_drawn(tuple(w.shape), reduce_axes, lambda _shape: next(slices))


def quantizes(name: str) -> bool:
    """Whether int8 weights quantize stacked weight ``name``: the matmul
    weights do; the embedding, the LM head, the norms and the router stay
    in their dtype."""
    return name in _LAYER_REDUCE_AXES


def quantize_drawn(shape: tuple[int, ...], reduce_axes: tuple[int, ...], draw) -> QTensor:
    """``quantize`` over ``reduce_axes`` of a stacked weight of ``shape``,
    built from ``draw(slice_shape)``: called in order once for each slice
    over the axes before the contraction axes (a layer; an expert stack's
    (layer, expert)), each slice quantized as it comes, so the unquantized
    stack never exists whole."""
    axes = tuple(reduce_axes)
    lead = min(axes)
    scale_shape = tuple(1 if i in axes else n for i, n in enumerate(shape))
    out: Optional[QTensor] = None
    for i in range(math.prod(shape[:lead])):
        q = quantize(draw(shape[lead:]), tuple(a - lead for a in axes))
        if out is None:
            out = QTensor(torch.empty(shape, dtype=torch.int8, device=q.data.device),
                          torch.empty(scale_shape, dtype=torch.float32, device=q.data.device))
        out.data.view(-1, *shape[lead:])[i].copy_(q.data)
        out.scale.view(-1, *scale_shape[lead:])[i].copy_(q.scale)
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

# the K split of the weight-only kernels' bf16 bodies (csrc/hopper.cuh make_split)
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
    return _cluster_splits(K, N, 64 if K % 64 == 0 else 16)


def _cluster_splits(K: int, N: int, unit: int) -> list[tuple[int, int]]:
    """The split both weight-only kernels' bf16 bodies share
    (``csrc/hopper.cuh`` ``make_split``): S slices of whole ``unit``-row
    units, S a power of two from K, N and the unit alone."""
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


# ---------------------------------------------------------------------------
# AWQ: grouped int4 weights, served natively (the JAX GroupQTensor)
# ---------------------------------------------------------------------------

# AutoAWQ's nibble interleave: bits [4k, 4k+4) of a packed int32 hold the
# quantized value for output channel 8*j + _AWQ_ORDER[k]
_AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
AWQ_STORAGES = ("int8", "int4", "packed4")


class GroupQTensor:
    """A group-quantized weight in the JAX layout: ``data`` int8 centered
    values (q - 2^(bits-1)), ``[..., G, gs, O]``, or with ``packed``
    ``[..., G, gs/2, O]`` (element 2i in the low nibble of byte i, 2i + 1
    in the high one); ``scale`` and ``zero_scaled`` (scale x (zero -
    2^(bits-1))) float32 ``[..., G, O]``; ``out_shape`` the logical output
    axes (their product is O). The logical weight is
    ``w[i, o] = data[g, i % gs, o] * scale[g, o] - zero_scaled[g, o]``,
    ``g = i // gs``. Leading axes (the layer stack) ride along; indexing
    gives views of all three parts."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor, zero_scaled: torch.Tensor,
                 out_shape: tuple, packed: bool = False):
        self.data = data
        self.scale = scale
        self.zero_scaled = zero_scaled
        self.out_shape = tuple(int(d) for d in out_shape)
        self.packed = bool(packed)

    @property
    def group_size(self) -> int:   # the logical gs (the stored axis is gs/2 when packed)
        return self.data.shape[-2] * (2 if self.packed else 1)

    @property
    def shape(self) -> tuple:      # logical [..., in, *out_shape]
        return (tuple(self.data.shape[:-3]) + (self.data.shape[-3] * self.group_size,)
                + self.out_shape)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        data = unpack_int4_lanes(self.data) if self.packed else self.data
        w = data.float() * self.scale[..., None, :] - self.zero_scaled[..., None, :]
        lead = tuple(self.data.shape[:-3])
        return w.reshape(lead + (self.data.shape[-3] * self.group_size,)
                         + self.out_shape).to(dtype)

    def __getitem__(self, idx) -> "GroupQTensor":
        return GroupQTensor(self.data[idx], self.scale[idx], self.zero_scaled[idx],
                            self.out_shape, self.packed)

    def to(self, device) -> "GroupQTensor":
        return GroupQTensor(self.data.to(device), self.scale.to(device),
                            self.zero_scaled.to(device), self.out_shape, self.packed)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.scale, self.zero_scaled))

    def __repr__(self):
        return (f"GroupQTensor(data={tuple(self.data.shape)} {self.data.dtype}, "
                f"out={self.out_shape}, packed={self.packed})")


def pack_int4_lanes(q: torch.Tensor) -> torch.Tensor:
    """Centered int4-range values ``[..., gs, O]`` int8 -> ``[..., gs/2, O]``
    int8 with two's-complement nibbles lane-packed: element 2i in the low
    nibble, 2i + 1 in the high one (the JAX ``pack_int4_lanes``)."""
    gs = q.shape[-2]
    if gs % 2:
        raise ValueError(f"group_size {gs} must be even to nibble-pack")
    u = q.to(torch.int8).view(torch.uint8)
    lo = u[..., 0::2, :] & 0xF
    hi = (u[..., 1::2, :] & 0xF) << 4
    return (lo | hi).view(torch.int8)


def unpack_int4_lanes(p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_int4_lanes``: ``[..., gsp, O]`` int8 ->
    ``[..., 2 gsp, O]`` int8, each nibble sign-extended by shifts."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    return torch.stack((lo, hi), dim=-2).reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1])


def _awq_unpack(arr: torch.Tensor, bits: int) -> torch.Tensor:
    """``[r, c]`` int32 -> ``[r, c * 32 / bits]`` int32 unpacked values with
    AWQ's interleave, on ``arr``'s device."""
    if bits not in (4, 8):
        raise ValueError(f"unsupported AWQ bits={bits}")
    pack = 32 // bits
    mask = (1 << bits) - 1
    arr = arr.to(torch.int32)
    r, c = arr.shape
    out = torch.empty((r, c, pack), dtype=torch.int32, device=arr.device)
    order = _AWQ_ORDER if bits == 4 else range(pack)
    for k, o in enumerate(order):
        out[:, :, o] = torch.bitwise_right_shift(arr, bits * k) & mask
    return out.reshape(r, c * pack)


def awq_dequantize(qweight: torch.Tensor, qzeros: torch.Tensor, scales: torch.Tensor,
                   bits: int = 4) -> torch.Tensor:
    """AWQ "gemm" tensors -> float32 ``[in, out]``: ``w[i, o] = (q[i, o] -
    z[g(i), o]) * s[g(i), o]`` with ``g(i) = i // (in / G)``, as the JAX
    ``awq_dequantize`` computes it (qweight int32 ``[in, out*bits/32]``,
    qzeros int32 ``[G, out*bits/32]``, scales f16/f32 ``[G, out]``)."""
    q = _awq_unpack(qweight, bits)
    z = _awq_unpack(qzeros, bits)
    group = q.shape[0] // z.shape[0]
    zf = z.repeat_interleave(group, dim=0).float()
    sf = scales.float().repeat_interleave(group, dim=0)
    return (q.float() - zf) * sf


def awq_group_tensors(qweight: torch.Tensor, qzeros: torch.Tensor, scales: torch.Tensor,
                      bits: int = 4, storage: Optional[str] = None,
                      out_shape: Optional[tuple] = None) -> GroupQTensor:
    """AWQ "gemm" tensors -> a ``GroupQTensor`` on their device (exact), as
    the JAX ``awq_group_tensors`` makes it. ``storage`` (else env
    ``LLMK_AWQ_STORAGE``, else "packed4" for 4 bits and "int8" for 8):
    "packed4" lane-packs two nibbles a byte; "int8" widens; "int4" (an
    ml_dtypes element type in JAX, which torch lacks) is stored as
    "packed4", the same function at the same 0.5 byte a weight."""
    q = _awq_unpack(qweight, bits)          # [in, out]
    z = _awq_unpack(qzeros, bits)           # [G, out]
    G, O = z.shape
    gs = q.shape[0] // G
    center = 1 << (bits - 1)
    if storage is None:
        storage = os.environ.get("LLMK_AWQ_STORAGE")
    if storage is None:
        storage = "int8" if bits == 8 else "packed4"
    if storage not in AWQ_STORAGES:
        raise ValueError(f"unsupported AWQ storage {storage!r}")
    if storage == "int4":
        storage = "packed4"
    if storage == "packed4" and (bits != 4 or gs % 2):
        storage = "int8"   # nibble-packing needs 4-bit values and an even gs
    centered = (q - center).to(torch.int8).reshape(G, gs, O)
    data = pack_int4_lanes(centered) if storage == "packed4" else centered
    s = scales.float()
    return GroupQTensor(data, s, (z.float() - center) * s,
                        out_shape=tuple(out_shape) if out_shape is not None else (O,),
                        packed=storage == "packed4")


def w4_splits(K: int, N: int, gs: int) -> list[tuple[int, int]]:
    """The K slices ``[(k0, k1), ...]`` of the W4A16 kernel's bf16 bodies
    for a K x N weight in groups of ``gs`` rows (``csrc/w4_matmul.cu``
    ``w4_split``): W8A16's split with whole groups as the unit, so the
    slices are contiguous, in order, each a whole number of groups, and
    their number S is a power of two chosen from K, N and gs alone (at most
    one group a slice), never from M. Each slice's groups run in order, the
    slice results are summed in order and rounded once."""
    return _cluster_splits(K, N, gs)


def group_qeinsum_plain(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                        zero_scaled: torch.Tensor, packed: bool) -> torch.Tensor:
    """The JAX ``group_qeinsum`` scan written out, group after group: x
    ``[M, K]``, data ``[G, gs or gs/2, N]``, scale and zero_scaled ``[G,
    N]``. Per group, ``part = x_g @ q_g`` with q in x's dtype and float32
    sums (exact widening products), ``xsum`` = x_g's sum rounded to x's
    dtype, then float32, and ``acc += part * s - xsum * zs``; the result
    is cast to x's dtype at the end."""
    q = unpack_int4_lanes(data) if packed else data
    G, gs, N = q.shape
    M = x.shape[0]
    xg = x.reshape(M, G, gs)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        x_g = xg[:, g]
        part = torch.matmul(x_g.float(), q[g].to(x.dtype).float())
        xsum = x_g.sum(dim=-1).float()[:, None]
        acc = acc + part * scale[g] - xsum * zero_scaled[g]
    return acc.to(x.dtype)


def w4_matmul(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
              zero_scaled: torch.Tensor, packed: bool) -> torch.Tensor:
    """x ``[M, K]`` (float32 or bfloat16) times a grouped int4 weight
    (``GroupQTensor``'s parts of one layer: data ``[G, gs/2, N]`` packed or
    ``[G, gs, N]`` int8, scale and zero_scaled float32 ``[G, N]``):
    ``group_qeinsum_plain``'s function, ``[M, N]`` in x's dtype. A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``csrc/w4_matmul.cu`` (M >= 1, gs a multiple of 16, N a multiple of
    16, all contiguous and 16-byte aligned) or raises: one launch, and
    nothing allocated but the output. Rows come out bit for bit the same at
    any M (the split of ``w4_splits``)."""
    if x.device.type == "cpu":
        return group_qeinsum_plain(x, data, scale, zero_scaled, packed)
    if x.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"w4_matmul kernel takes float32/bfloat16 x, got {x.dtype}")
    kernels.check_tensor("x", x, ndim=2, align=16)
    kernels.check_tensor("data", data, dtype=torch.int8, ndim=3, device=x.device, align=16)
    for name, t in (("scale", scale), ("zero_scaled", zero_scaled)):
        kernels.check_tensor(name, t, dtype=torch.float32, ndim=2, device=x.device, align=16)
    M, K = x.shape
    G, gsp, N = data.shape
    gs = 2 * gsp if packed else gsp
    if M < 1:
        raise ValueError("w4_matmul kernel takes M >= 1 rows")
    if G * gs != K or tuple(scale.shape) != (G, N) or tuple(zero_scaled.shape) != (G, N):
        raise ValueError(f"w4_matmul: x {tuple(x.shape)}, data {tuple(data.shape)} "
                         f"(packed={packed}), scale {tuple(scale.shape)} and zero_scaled "
                         f"{tuple(zero_scaled.shape)} do not chain")
    if gs % 16 or N % 16:
        raise ValueError(f"w4_matmul kernel takes a group size and N that are multiples of "
                         f"16, got gs={gs} N={N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = kernels.function(W4_KERNEL)
    err = fn(x.data_ptr(), data.data_ptr(), scale.data_ptr(), zero_scaled.data_ptr(),
             out.data_ptr(), M, K, N, gs, int(packed), kernels.DTYPE_CODES[x.dtype],
             kernels.stream_ptr(x))
    kernels.check(W4_KERNEL, err)
    kernels.count(W4_KERNEL)
    return out
