"""Mixture-of-Experts block: top-k routing and the routed expert FFN
(counterpart of ``llms_on_kubernetes_tpu/ops/moe.py``).

The JAX block writes dispatch and combine as one-hot einsums around a
batched expert matmul over an [E, C, D] buffer. That form does E / k times
the expert FLOPs routing needs and holds a [N, k, E, C] one-hot that grows
with N^2 (34.4 GB in bf16 at Qwen3-30B-A3B's widths and a 4,096-token
bucket), so the port computes the same function with routed products:

- ``moe_route``: the router's top-k, each claim's position within its
  expert (the JAX cumulative sum over the flattened [N k, E] one-hot, the
  ``valid`` mask applied first), the capacity drops (a claim at position C
  or more), the per-expert counts and offsets, and each kept claim's row in
  an expert-major buffer (offset + position). Plain torch ops with no host
  read, so a CUDA graph captures them.
- ``moe_experts``: y[r] = (SiLU(x[src[r]] W_gate[e]) * (x[src[r]] W_up[e]))
  W_down[e] for every expert-major row r of expert e. A CUDA tensor
  launches ``csrc/moe_experts.cu`` (two launches of persistent blocks:
  gate/up with the SiLU product, then down), or with int8 ``QTensor``
  stacks (the JAX ``quantize_params`` layout: data ``[E, D, F]`` /
  ``[E, F, D]``, scales ``[E, 1, F]`` / ``[E, 1, D]``) ``csrc/
  moe_experts_w8.cu``, the same body on int8 weight tiles converted in
  registers, each product with ``qeinsum``'s two roundings; a CPU tensor
  runs ``moe_experts_plain``, a loop over the experts in torch that is
  both kernels' reference. ``moe_splits``, ``moe_rows``, ``moe_tiles``
  and ``moe_walk`` mirror the kernels' K split, tile size and walk over
  the tiles.
- ``moe_combine``: out[n] = sum_j w[n, j] y[row(n, j)], in choice order;
  a dropped or invalid claim adds 0, so padding rows come out 0.

Rounding follows the JAX block at x's dtype: the gate and up products are
rounded, SiLU(gate) is rounded, their product h is rounded, y is rounded;
the router runs in float32 and its renormalized weights are rounded to x's
dtype before the combine, which sums in float32 and rounds once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.ops.quant import QTensor, _cluster_splits, w8_matmul_plain

MOE_KERNEL = "moe_experts"
MOE_W8_KERNEL = "moe_experts_w8"     # int8 expert stacks (csrc/moe_experts_w8.cu)
# the expert kernel's tiles (csrc/moe_experts.cu)
MOE_POW2_ROWS = 64        # rows a tile for up to 64 rows an expert (kMaxPow2Rows)
MOE_PREFILL_ROWS = 128    # rows a tile above (kPreRows)
MOE_COLS = 64             # weight columns a wgmma tile (kCols)
MOE_MAX_EXPERTS = 512     # experts the kernel's tile tables hold (kMaxExperts)


@dataclasses.dataclass
class MoERoute:
    """One routing of N tokens over E experts, top k.

    ``weights`` [N, k] x's dtype (renormalized top-k probabilities);
    ``experts`` [N, k] int64 (the chosen experts, descending probability,
    ties to the lower index); ``pos`` [N, k] int32 (the claim's position
    within its expert); ``kept`` [N, k] bool (valid and pos < C);
    ``rows`` [N, k] int32 (offset + pos where kept, else 0); ``counts``
    [E] int32 (kept claims an expert); ``offsets`` [E] int32 (exclusive
    sum of counts); ``src`` [N k] int32 (the token of each expert-major
    row; rows past the kept claims are 0)."""
    weights: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    rows: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    src: torch.Tensor


def capacity(N: int, E: int, top_k: int, capacity_factor: Optional[float]) -> int:
    """Claims an expert keeps: N when dropless (``capacity_factor`` None),
    else ceil(N k cf / E) within [1, N], as the JAX block computes C."""
    if capacity_factor is None:
        return N
    return min(N, max(1, int(-(-N * top_k * capacity_factor // E))))


def moe_route(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
              capacity_factor: Optional[float] = None,
              valid: Optional[torch.Tensor] = None,
              src_out: Optional[torch.Tensor] = None) -> MoERoute:
    """Route x [N, D] through router_w [D, E]. ``valid`` [N] bool: an
    invalid token claims nothing (its weights still come back, its
    ``kept`` is False). ``src_out``: an int32 buffer of at least N k + 1
    elements for ``src`` (a workspace's), else one is allocated."""
    N = x.shape[0]
    E = router_w.shape[1]
    dev = x.device
    C = capacity(N, E, top_k, capacity_factor)
    logits = x.float() @ router_w.float()                                  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first among equal values: rank by
    # (probability bits, E - 1 - index), which no two experts share. A
    # non-negative float's bits order as the float does
    key = probs.view(torch.int32).long() * E + (E - 1 - torch.arange(E, device=dev))
    top = torch.topk(key, top_k, dim=-1).values
    experts = (E - 1) - top.remainder(E)                                   # [N, k]
    top_p = probs.gather(1, experts)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    weights = top_p.to(x.dtype)
    onehot = (experts[:, :, None] == torch.arange(E, device=dev)).to(torch.int32)
    claimed = (torch.ones((N,), dtype=torch.bool, device=dev) if valid is None
               else valid.to(torch.bool))
    onehot = onehot * claimed.to(torch.int32)[:, None, None]
    # claims on each expert up to and including this one, in (token,
    # choice) order
    upto = torch.cumsum(onehot.view(N * top_k, E), dim=0, dtype=torch.int32)
    pos = upto.view(N, top_k, E).gather(2, experts[:, :, None])[:, :, 0] \
        - claimed.to(torch.int32)[:, None]
    kept = claimed[:, None] & (pos < C)
    counts = upto[-1].clamp(max=C)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    rows = torch.where(kept, offsets[experts] + pos, 0).to(torch.int32)
    R = N * top_k
    src = (torch.empty((R + 1,), dtype=torch.int32, device=dev) if src_out is None
           else src_out[:R + 1])
    src.zero_()
    token = torch.arange(N, dtype=torch.int32, device=dev)[:, None].expand(N, top_k)
    # dropped claims land in the spare last element
    src.scatter_(0, torch.where(kept, rows, R).reshape(-1).long(), token.reshape(-1))
    return MoERoute(weights, experts, pos.to(torch.int32), kept, rows, counts.to(torch.int32),
                    offsets, src[:R])


def _expert_product(x: torch.Tensor, w, e: int) -> torch.Tensor:
    """x times expert e's weight: a plain matmul, or for a ``QTensor``
    stack ``w8_matmul_plain`` (the JAX ``qeinsum`` roundings) with the
    expert's column scales."""
    if isinstance(w, QTensor):
        return w8_matmul_plain(x, w.data[e], w.scale[e].reshape(-1))
    return x @ w[e]


def moe_experts_plain(x: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
                      w_gate, w_up, w_down, act=F.silu) -> torch.Tensor:
    """The routed expert FFN, expert by expert: y [N k, D] in x's dtype,
    rows [offset_e, offset_e + count_e) for expert e, in torch matmuls (an
    int8 ``QTensor`` stack: each product rounded, times its rounded scale,
    rounded again, as ``qeinsum``); rows past the kept claims are 0. Reads
    ``counts`` on the host."""
    R = src.shape[0]
    y = torch.zeros((R, w_down.shape[2]), dtype=x.dtype, device=x.device)
    start = 0
    for e, c in enumerate(counts.tolist()):
        if c:
            xs = x[src[start:start + c].long()]
            h = act(_expert_product(xs, w_gate, e)) * _expert_product(xs, w_up, e)
            y[start:start + c] = _expert_product(h, w_down, e)
        start += c
    return y


def moe_splits(K: int, Nw: int) -> list[tuple[int, int]]:
    """The K slices ``[(k0, k1), ...]`` of the expert kernel's launch over
    K rows that streams ``Nw`` weight columns an expert (2F for gate/up, D
    for down; ``csrc/moe_experts.cu`` ``moe_split``): the weight-only
    kernels' split (``ops/quant._cluster_splits``) in units of 64 rows, or
    32 where 64 does not divide K. So S and the edges follow from D and F
    alone, never from R. Each output is each slice's f32 chain of 16-deep
    steps in increasing k, the chains summed in slice order, then the
    epilogue's roundings."""
    return _cluster_splits(K, Nw, 64 if K % 64 == 0 else 32)


def moe_rows(R: int, N: int, E: int) -> int:
    """Rows a tile of the expert kernel for R expert-major rows over N
    tokens and E experts (``llmk_moe_rows``): an expert holds at most one
    row a token, so at most min(R, N) rows, and a tile is sized for that
    or, where fewer, for four times an expert's even share (4 R / E, at
    least 8; an expert with more rows gets more tiles): the least of 8, 16,
    32 and 64 that holds it, else ``MOE_PREFILL_ROWS``. Every tile size
    gives the same bits."""
    most = min(R, N)
    share = 4 * R // E
    if share < most:
        most = max(share, 8)
    if most > MOE_POW2_ROWS:
        return MOE_PREFILL_ROWS
    return 8 if most <= 8 else 1 << (most - 1).bit_length()


def moe_col_tiles(N: int, gated: bool) -> int:
    """Column tiles of a launch with N outputs: 64 outputs (the gate and up
    columns, 128 weight columns) for gate/up, 128 for down."""
    width = MOE_COLS if gated else 2 * MOE_COLS
    return -(-N // width)


def moe_tiles(counts, rows: int) -> list[tuple[int, int, int]]:
    """The kernel's row tiles, in order: tiles of ``rows`` rows within each
    expert, experts in order, as ``(expert, first row, rows)`` (the tables
    ``tile_tables`` builds from the counts, read by ``lookup_tile``)."""
    out, row = [], 0
    for e, c in enumerate(int(c) for c in counts):
        for r in range(0, c, rows):
            out.append((e, row + r, min(rows, c - r)))
        row += c
    return out


def moe_walk(counts, N: int, gated: bool, blocks: int,
             rows: int = MOE_PREFILL_ROWS) -> list[list[tuple[int, int, int, int]]]:
    """The kernel's persistent walk over tiles of ``rows`` rows: block
    b takes work items b, b + blocks, ...; item w is row tile w // C and
    column tile w % C (C column tiles), so the blocks running side by side
    share a row tile. Returns each block's items as ``(expert, first row,
    rows, column tile)``."""
    tiles = moe_tiles(counts, rows)
    C = moe_col_tiles(N, gated)
    return [[(*tiles[w // C], w % C) for w in range(b, len(tiles) * C, blocks)]
            for b in range(blocks)]


class MoEWorkspace:
    """The expert kernel's scratch for one engine: ``src`` [rows + 1]
    int32, ``h`` [rows, F] and ``y`` [rows, D], made once (``rows`` = the
    largest forward's tokens times k). A captured graph holds their
    addresses, so they are never replaced: a call with more rows than
    ``rows`` gets buffers of its own for that call."""

    def __init__(self, rows: int, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        self.rows = rows
        self.src = torch.zeros((rows + 1,), dtype=torch.int32, device=device)
        self.h = torch.empty((rows, d_ff), dtype=dtype, device=device)
        self.y = torch.empty((rows, d_model), dtype=dtype, device=device)

    def fits(self, R: int, D: int, Fd: int, dtype: torch.dtype, device) -> bool:
        return (R <= self.rows and self.h.shape[1] == Fd and self.y.shape[1] == D
                and self.y.dtype == dtype and self.y.device == device)


def moe_experts(x: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
                w_gate, w_up, w_down, act=F.silu,
                workspace: Optional[MoEWorkspace] = None) -> torch.Tensor:
    """``moe_experts_plain``'s function, y [R, D] with R = len(src): a CPU
    tensor runs the plain version; a CUDA tensor launches
    ``csrc/moe_experts.cu`` (bfloat16 weights) or, when all three stacks
    are int8 ``QTensor``s, ``csrc/moe_experts_w8.cu`` (bfloat16 x, SiLU, D
    and F multiples of 32, all contiguous), or raises. Rows past the kept
    claims are left unwritten. A row's result is bit for bit the same
    whatever the other rows are and whatever the tile size (``moe_rows``):
    the K split and the order of sums depend on D and F
    only (``moe_splits``)."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, src, counts, w_gate, w_up, w_down, act)
    quant = [isinstance(w, QTensor) for w in (w_gate, w_up, w_down)]
    if any(quant) and not all(quant):
        raise ValueError("moe_experts takes three bf16 stacks or three int8 QTensor stacks")
    int8 = all(quant)
    name = MOE_W8_KERNEL if int8 else MOE_KERNEL
    if act is not F.silu:
        raise ValueError(f"the {name} kernel computes SiLU(gate) * up only")
    bf = torch.bfloat16
    kernels.check_tensor("x", x, dtype=bf, ndim=2, align=16)
    kernels.check_tensor("src", src, dtype=torch.int32, ndim=1, device=x.device)
    kernels.check_tensor("counts", counts, dtype=torch.int32, ndim=1, device=x.device)
    weights, scales = [], []
    for wname, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        data = w.data if int8 else w
        kernels.check_tensor(wname, data, dtype=torch.int8 if int8 else bf, ndim=3,
                             device=x.device, align=16)
        weights.append(data.data_ptr())
        if int8:
            # [E, 1, N] keepdims: the kernel reads it as [E, N], no copy
            kernels.check_tensor(wname + ".scale", w.scale, dtype=torch.float32, ndim=3,
                                 device=x.device, align=16)
            if tuple(w.scale.shape) != (data.shape[0], 1, data.shape[2]):
                raise ValueError(f"{wname}.scale {tuple(w.scale.shape)} is not the "
                                 f"[E, 1, N] scale of {tuple(data.shape)}")
            scales.append(w.scale.data_ptr())
    D = x.shape[1]
    E, _, Fd = w_gate.shape
    R = src.shape[0]
    if (tuple(w_gate.shape) != (E, D, Fd) or tuple(w_up.shape) != (E, D, Fd)
            or tuple(w_down.shape) != (E, Fd, D) or counts.shape[0] != E):
        raise ValueError(f"moe_experts: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)} and counts "
                         f"{tuple(counts.shape)} do not chain")
    if D % 32 or Fd % 32 or R < 1 or E > MOE_MAX_EXPERTS:
        raise ValueError(f"moe_experts kernel takes D and F that are multiples of 32, R >= 1 "
                         f"and at most {MOE_MAX_EXPERTS} experts, got D={D} F={Fd} R={R} E={E}")
    if workspace is not None and workspace.fits(R, D, Fd, bf, x.device):
        h, y = workspace.h[:R], workspace.y[:R]
    else:
        h = torch.empty((R, Fd), dtype=bf, device=x.device)
        y = torch.empty((R, D), dtype=bf, device=x.device)
    fn = kernels.function(name)
    err = fn(x.data_ptr(), src.data_ptr(), counts.data_ptr(), *weights, *scales,
             h.data_ptr(), y.data_ptr(), R, x.shape[0], E, D, Fd, kernels.stream_ptr(x))
    kernels.check(name, err)
    kernels.count(name)      # gate/up
    kernels.count(name)      # down
    return y


def moe_combine(y: torch.Tensor, route: MoERoute) -> torch.Tensor:
    """out [N, D] in y's dtype: sum over the choices j, in order, of
    weights[n, j] * y[rows[n, j]] in float32, a claim not kept adding 0."""
    N, k = route.rows.shape
    picked = y.index_select(0, route.rows.reshape(-1).long()).view(N, k, -1).float()
    w = route.weights.float()[:, :, None]
    terms = torch.where(route.kept[:, :, None], w * picked, 0.0)
    acc = terms[:, 0]
    for j in range(1, k):
        acc = acc + terms[:, j]
    return acc.to(y.dtype)


def moe_block(x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up, w_down, *, top_k: int,
              capacity_factor: Optional[float] = None, act=F.silu,
              valid: Optional[torch.Tensor] = None,
              workspace: Optional[MoEWorkspace] = None) -> torch.Tensor:
    """x [N, D]; router_w [D, E]; w_gate / w_up [E, D, F]; w_down [E, F, D]
    (the JAX ``moe_block``'s signature and layouts), bf16 tensors or int8
    ``QTensor`` stacks with their ``[E, 1, F]`` / ``[E, 1, D]`` scales (the
    router stays in its dtype, as in JAX). ``valid`` [N] bool
    excludes padding and idle tokens from routing: they claim no expert
    capacity and their output rows are 0. ``workspace``: an engine's
    ``MoEWorkspace`` (a card's scratch), else allocated per call."""
    fits = workspace is not None and x.shape[0] * top_k <= workspace.rows
    route = moe_route(x, router_w, top_k=top_k, capacity_factor=capacity_factor,
                      valid=valid, src_out=workspace.src if fits else None)
    y = moe_experts(x, route.src, route.counts, w_gate, w_up, w_down, act, workspace)
    return moe_combine(y, route)
