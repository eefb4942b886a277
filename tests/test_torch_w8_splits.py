"""The W8A16 kernel's K split (``ops/quant.w8_splits``, the Python mirror of
``csrc/w8_matmul.cu``'s ``w8_split``) and the order of sums it fixes, on
the CPU.

The kernel's bf16 bodies cut K into slices chosen from K and N alone,
take each slice's f32 chain, sum the chains in slice order, then round as
JAX ``qeinsum`` does. These tests hold the split's contract at every
projection the port serves and at random K and N, and an emulation of that
order against ``w8_matmul_plain`` and JAX ``qeinsum``. On the card the
kernel's split is held to this mirror and its rows bit for bit across M
(tests/test_torch_cuda.py, chip_smoke.py phase 2).

Tolerances: the emulation against the plain version and JAX, bfloat16 x,
each row's max |err| <= 2e-2 x the row's own max |reference| (the bf16
row tolerance of the port's kernel checks: the rounding points are the
same, the order of the f32 sums is not); float32 x, each row's max |err|
<= 1e-5 x the row's own max |reference| (the order of the f32 sums only,
whose error follows the row's scale, not each element's).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu.ops import quant as jquant
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.ops import quant as tquant


def _projections(model: str) -> dict:
    """name -> (K, N) of a model's seven projections, as the decoder
    flattens them for ``w8_matmul``."""
    c = get_config(model)
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    D, F = c.hidden_size, c.intermediate_size
    return {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
            "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}


SHAPES = [(m, name, *kn) for m in ("llama-3-8b", "phi-3-mini", "debug-tiny")
          for name, kn in _projections(m).items()]


def _check_split(K: int, N: int) -> list:
    sp = tquant.w8_splits(K, N)
    S = len(sp)
    assert S >= 1 and S & (S - 1) == 0, sp          # a power of two
    assert S <= tquant.W8_SLICE_GROUPS * tquant.W8_MAX_CLUSTER
    unit = 64 if K % 64 == 0 else 16
    assert sp[0][0] == 0 and sp[-1][1] == K
    for (a, b), (c, _) in zip(sp, sp[1:]):
        assert b == c                                 # contiguous, in order
    for a, b in sp:
        assert a % 16 == 0 and a % unit == 0 and b > a and (b - a) % unit == 0
    # balanced: slice lengths differ by at most one unit
    lengths = [b - a for a, b in sp]
    assert max(lengths) - min(lengths) <= unit
    return sp


@pytest.mark.parametrize("model,name,K,N", SHAPES, ids=[f"{m}-{n}" for m, n, _, _ in SHAPES])
def test_splits_cover_k_in_order(model, name, K, N):
    _check_split(K, N)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 1024), st.integers(1, 2048))
def test_splits_of_any_multiple_of_16(k16, n16):
    _check_split(16 * k16, 16 * n16)


def test_split_counts_at_the_served_widths():
    """The slice counts the kernel uses (a change here changes every bf16
    W8A16 result: held against the kernel itself on the card)."""
    got = {kn: len(tquant.w8_splits(*kn)) for kn in
           [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (3072, 3072),
            (3072, 8192), (8192, 3072), (64, 64), (64, 32), (64, 128), (128, 64),
            (4112, 4096), (80, 48)]}
    assert got == {(4096, 4096): 8, (4096, 1024): 16, (4096, 14336): 4, (14336, 4096): 16,
                   (3072, 3072): 16, (3072, 8192): 4, (8192, 3072): 16, (64, 64): 1,
                   (64, 32): 1, (64, 128): 1, (128, 64): 2, (4112, 4096): 8, (80, 48): 4}


def emulate(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's order on the CPU: per slice, an f32 chain of 16-deep
    steps in increasing k; the chains summed in slice order; then
    ``qeinsum``'s two roundings to x's dtype."""
    K, N = w.shape
    xf, wf = x.float(), w.float()
    total = None
    for a, b in tquant.w8_splits(K, N):
        chain = torch.zeros(x.shape[0], N)
        for k in range(a, b, 16):
            chain = chain + xf[:, k:k + 16] @ wf[k:k + 16]
        total = chain if total is None else total + chain
    y = total.to(x.dtype)
    return y * scale.to(x.dtype)


EMU = [(1, 64, 32), (5, 320, 96), (8, 4112, 64), (64, 1024, 256), (70, 3072, 128),
       (3, 80, 48)]


def _inputs(rng, M, K, N, dtype):
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = rng.uniform(1e-3, 2e-2, size=N).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        tx = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    return x, w, s, tx, torch.from_numpy(w), torch.from_numpy(s)


def _rows_close(got: np.ndarray, want: np.ndarray, dtype: str):
    n = want.shape[-1]
    row_err = np.abs(got - want).reshape(-1, n).max(axis=1)
    row_max = np.abs(want).reshape(-1, n).max(axis=1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert (row_err <= tol * row_max).all(), float((row_err / row_max).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N", EMU)
def test_split_order_equals_plain_and_qeinsum(M, K, N, dtype):
    """The emulated order against ``w8_matmul_plain`` and JAX ``qeinsum``
    on the same numpy inputs."""
    x, w, s, tx, tw, ts = _inputs(np.random.default_rng(K + N + M), M, K, N, dtype)
    got = emulate(tx, tw, ts)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    plain = tquant.w8_matmul_plain(tx, tw, ts)
    want = np.asarray(jquant.qeinsum("mk,kn->mn", jnp.asarray(x),
                                     jquant.QTensor(jnp.asarray(w),
                                                    jnp.asarray(s[None, :])))).astype(np.float32)
    _rows_close(got.float().numpy(), plain.float().numpy(), dtype)
    _rows_close(got.float().numpy(), want, dtype)


def test_split_order_does_not_depend_on_m():
    """A row of the emulation alone equals that row of a call of many rows:
    the split and the order come from K and N only."""
    x, w, s, tx, tw, ts = _inputs(np.random.default_rng(7), 65, 1024, 64, "bfloat16")
    full = emulate(tx, tw, ts)
    for r in (0, 37, 64):
        assert torch.equal(emulate(tx[r:r + 1], tw, ts)[0], full[r])


def test_int8_to_bf16_without_i2f_is_exact():
    """The kernel's conversion (``s8_pair``): bf16 bits 0x4300 | (b & 0x7f)
    minus bf16 bits 0x4300 | (b & 0x80) is the signed byte's value, for
    every byte."""
    b = np.arange(256, dtype=np.uint16)
    v = torch.from_numpy(((b & 0x7F) | 0x4300).view(np.int16)).view(torch.bfloat16)
    s = torch.from_numpy(((b & 0x80) | 0x4300).view(np.int16)).view(torch.bfloat16)
    want = torch.from_numpy(b.astype(np.uint8).view(np.int8).astype(np.float32))
    assert torch.equal((v.float() - s.float()), want)
    # the subtraction is exact in bf16 itself (the kernel's fma.bf16x2)
    assert torch.equal((v - s).float(), want)


def test_extra_c_entries_match_their_signatures():
    """``kernels._EXTRA_ENTRIES`` (the split's slice count, read by the card
    tests and chip_smoke.py) bind the parameter lists their sources
    declare."""
    import re
    from pathlib import Path

    from llms_on_kubernetes_tpu_torch import kernels

    c_types = {"int": "c_int", "const void*": "c_void_p", "void*": "c_void_p"}
    assert "w8_splits" in kernels._EXTRA_ENTRIES
    for lib, symbol, argtypes in kernels._EXTRA_ENTRIES.values():
        text = (Path(kernels.CSRC) / f"{lib}.cu").read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
        assert m, symbol
        params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(1).split(",")]
        assert [c_types[p] for p in params] == [a.__name__ for a in argtypes], symbol
