"""The W4A16 kernel's K split (``ops/quant.w4_splits``, the Python mirror of
``csrc/w4_matmul.cu``'s ``w4_split``) and the order of sums it fixes, on
the CPU.

The kernel's bf16 bodies cut K into slices of whole groups chosen from K,
N and the group size alone, run each slice's groups in order (a fresh f32
chain a group, then the group step with the group's xsum rounded to x's
dtype), sum the slice results in slice order and round once. These tests
hold the split's contract at every projection of the served models and at
random shapes, and an emulation of that order against
``group_qeinsum_plain`` and JAX ``group_qeinsum``. On the card the
kernel's split is held to this mirror and its rows bit for bit across M
and both bodies (tests/test_torch_cuda.py, chip_smoke.py phase 2).

Tolerances: the emulation against the plain version and JAX, bfloat16 x,
each row's max |err| <= 2e-2 x the row's own max |reference| (the bf16
row tolerance of the port's kernel checks: the rounding points are the
same, the order of the f32 sums is not); float32 x, each row's max |err|
<= 1e-5 x the row's own max |reference| (the order of the f32 sums only).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu.ops import quant as jquant
from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.ops import quant as tquant

GROUPS = (32, 64, 128)
MODELS = ("qwen3-8b", "llama-3-8b", "phi-3-mini", "debug-tiny")
# the kernel stages the scale rows of at most this many groups a 64-row tile
MAX_GROUP_ROWS = 4


def _projections(model: str) -> dict:
    """name -> (K, N) of a model's seven projections, as the decoder
    flattens them for ``w4_matmul``."""
    c = get_config(model)
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    D, F = c.hidden_size, c.intermediate_size
    return {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
            "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}


SHAPES = [(m, name, K, N, gs) for m in MODELS for name, (K, N) in _projections(m).items()
          for gs in GROUPS if K % gs == 0]


def _check_split(K: int, N: int, gs: int) -> list:
    sp = tquant.w4_splits(K, N, gs)
    S = len(sp)
    assert S >= 1 and S & (S - 1) == 0, sp                   # a power of two
    assert S <= tquant.W8_SLICE_GROUPS * tquant.W8_MAX_CLUSTER
    assert sp[0][0] == 0 and sp[-1][1] == K
    for (_, b), (c, _) in zip(sp, sp[1:]):
        assert b == c                                          # contiguous, in order
    for a, b in sp:
        assert a % gs == 0 and b > a and (b - a) % gs == 0     # whole groups
    groups = [(b - a) // gs for a, b in sp]
    assert max(groups) - min(groups) <= 1                      # balanced
    # every 64-row tile from a slice's start touches at most MAX_GROUP_ROWS
    # groups (the rows of scales the kernel stages a tile)
    for a, b in sp:
        for k0 in range(a, b, 64):
            k1 = min(k0 + 64, b)
            assert (k1 - 1) // gs - k0 // gs + 1 <= MAX_GROUP_ROWS
    return sp


@pytest.mark.parametrize("model,name,K,N,gs", SHAPES,
                         ids=[f"{m}-{n}-gs{gs}" for m, n, _, _, gs in SHAPES])
def test_splits_cut_whole_groups_at_the_served_widths(model, name, K, N, gs):
    _check_split(K, N, gs)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 256), st.integers(1, 2048), st.sampled_from([16, 32, 48, 64, 128, 256]))
def test_splits_of_any_shape(groups, n16, gs):
    """Any K of whole groups, any N a multiple of 16, any gs the kernel
    takes: the same contract, and the same answer asked twice (nothing but
    K, N and gs goes in)."""
    K, N = groups * gs, 16 * n16
    assert _check_split(K, N, gs) == tquant.w4_splits(K, N, gs)


def test_split_is_w8a16s_with_groups_as_the_unit():
    """Where the group is W8A16's unit the two kernels cut K alike."""
    for K, N in [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096), (3072, 8192)]:
        assert tquant.w4_splits(K, N, 64) == tquant.w8_splits(K, N)


def test_split_counts_at_the_served_widths():
    """The slice counts the kernel uses at Qwen3-8B's projections and a few
    others (a change here changes every bf16 W4A16 result: held against the
    kernel itself on the card)."""
    got = {kn: len(tquant.w4_splits(*kn)) for kn in
           [(4096, 4096, 128), (4096, 1024, 128), (4096, 12288, 128), (12288, 4096, 128),
            (4096, 14336, 128), (14336, 4096, 128), (3072, 3072, 64), (64, 32, 32),
            (64, 16, 64), (128, 1040, 128), (512, 1040, 16), (4096, 4096, 32)]}
    assert got == {(4096, 4096, 128): 8, (4096, 1024, 128): 16, (4096, 12288, 128): 4,
                   (12288, 4096, 128): 16, (4096, 14336, 128): 4, (14336, 4096, 128): 16,
                   (3072, 3072, 64): 16, (64, 32, 32): 2, (64, 16, 64): 1,
                   (128, 1040, 128): 1, (512, 1040, 16): 16, (4096, 4096, 32): 8}


def emulate(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
            zero_scaled: torch.Tensor, packed: bool) -> torch.Tensor:
    """The kernel's order on the CPU: per slice, the groups in order, each
    a fresh f32 chain of 16-deep steps in increasing k and an xsum chained
    over the same steps, rounded to x's dtype; the group step ``(acc + part
    * s) - xsum * zs``, each operation rounded; the slice results summed in
    slice order; one rounding to x's dtype."""
    q = tquant.unpack_int4_lanes(data) if packed else data
    G, gs, N = q.shape
    K = G * gs
    xf, qf = x.float(), q.reshape(K, N).float()
    total = None
    for a, b in tquant.w4_splits(K, N, gs):
        acc = torch.zeros(x.shape[0], N)
        for g0 in range(a, b, gs):
            part, xs = torch.zeros(x.shape[0], N), torch.zeros(x.shape[0])
            for k in range(g0, g0 + gs, 16):
                part = part + xf[:, k:k + 16] @ qf[k:k + 16]
                xs = xs + xf[:, k:k + 16].sum(dim=-1)
            xs = xs.to(x.dtype).float()[:, None]
            g = g0 // gs
            acc = (acc + part * scale[g]) - xs * zero_scaled[g]
        total = acc if total is None else total + acc
    return total.to(x.dtype)


def _inputs(rng, M, K, N, gs, dtype, packed):
    x = rng.normal(size=(M, K)).astype(np.float32)
    G = K // gs
    vals = rng.integers(-8, 8, size=(G, gs, N)).astype(np.int8)
    s = (rng.uniform(0.8, 1.2, size=(G, N)) / (4.6 * np.sqrt(K))).astype(np.float32)
    zs = s * (rng.integers(6, 10, size=(G, N)).astype(np.float32) - 8)
    data = jquant.pack_int4_lanes(vals) if packed else vals
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        tx = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    return (x, np.asarray(data), s, zs, tx, torch.from_numpy(np.asarray(data)),
            torch.from_numpy(s), torch.from_numpy(zs))


def _rows_close(got: np.ndarray, want: np.ndarray, dtype: str):
    n = want.shape[-1]
    row_err = np.abs(got - want).reshape(-1, n).max(axis=1)
    row_max = np.abs(want).reshape(-1, n).max(axis=1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert (row_err <= tol * row_max).all(), float((row_err / row_max).max())


# (M, K, N, gs): one group, groups of 16 to 128, N off the 128-column slab,
# several slices, a K that needs 16 of them
EMU = [(1, 64, 32, 64), (5, 256, 48, 32), (8, 512, 1040, 16), (64, 1024, 144, 128),
       (65, 384, 96, 64), (3, 4096, 64, 128), (17, 16, 16, 16)]


@pytest.mark.parametrize("packed", [True, False], ids=["packed4", "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N,gs", EMU)
def test_split_order_equals_plain_and_group_qeinsum(M, K, N, gs, dtype, packed):
    """The emulated order against ``group_qeinsum_plain`` and JAX
    ``group_qeinsum`` on the same numpy inputs."""
    x, data, s, zs, tx, tdata, ts, tzs = _inputs(np.random.default_rng(K + N + M + gs), M, K,
                                                 N, gs, dtype, packed)
    got = emulate(tx, tdata, ts, tzs, packed)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    plain = tquant.group_qeinsum_plain(tx, tdata, ts, tzs, packed)
    jw = jquant.GroupQTensor(jnp.asarray(data), jnp.asarray(s), jnp.asarray(zs), (N,),
                             packed=packed)
    want = np.asarray(jquant.group_qeinsum("mk,kn->mn", jnp.asarray(x), jw)).astype(np.float32)
    _rows_close(got.float().numpy(), plain.float().numpy(), dtype)
    _rows_close(got.float().numpy(), want, dtype)


def test_split_order_does_not_depend_on_m():
    """A row of the emulation alone equals that row of a call of many rows:
    the split and the order come from K, N and gs only."""
    _, _, _, _, tx, tdata, ts, tzs = _inputs(np.random.default_rng(7), 65, 1024, 64, 64,
                                             "bfloat16", True)
    full = emulate(tx, tdata, ts, tzs, True)
    for r in (0, 37, 64):
        assert torch.equal(emulate(tx[r:r + 1], tdata, ts, tzs, True)[0], full[r])


def test_nibble_to_bf16_without_i2f_is_exact():
    """The kernel's conversion (``nibble_pair``): for every byte, the bf16
    bit patterns 0x4300 | (u ^ 8) of its two nibbles u, minus 136 in bf16,
    are the two's-complement nibbles' values, the low nibble first."""
    b = np.arange(256, dtype=np.uint16)
    want = tquant.unpack_int4_lanes(torch.from_numpy(b.astype(np.uint8).view(np.int8))
                                    .reshape(1, 256))
    for half, u in ((0, b & 0xF), (1, b >> 4)):
        v = torch.from_numpy(((u ^ 8) | 0x4300).view(np.int16)).view(torch.bfloat16)
        got = v - torch.tensor(136.0, dtype=torch.bfloat16)
        assert torch.equal(got.float(), (v.float() - 136.0))   # exact in bf16
        assert torch.equal(got.float(), want[half].float())


def test_c_entry_matches_its_binding():
    """``llmk_w4_matmul``'s parameter list in the source is the one
    ``kernels`` binds: no workspace pointer."""
    text = (Path(kernels.CSRC) / "w4_matmul.cu").read_text()
    m = re.search(r'extern "C" int llmk_w4_matmul\(([^)]*)\)', text)
    assert m
    params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(1).split(",")]
    c_types = {"int": "c_int", "const void*": "c_void_p", "void*": "c_void_p"}
    symbol, argtypes = kernels._SIGNATURES["w4_matmul"]
    assert symbol == "llmk_w4_matmul"
    assert [c_types[p] for p in params] == [a.__name__ for a in argtypes]
    assert len(params) == 12 and "part" not in m.group(1)
