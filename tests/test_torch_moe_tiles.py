"""The MoE expert kernel's K split, tile size and walk over the tiles
(``ops/moe.moe_splits``, ``moe_rows``, ``moe_tiles``, ``moe_walk``: the
Python mirrors of ``csrc/moe_experts.cu``) and the order of sums they fix,
on the CPU.

The kernel cuts each launch's K into slices chosen from K and the weight
columns it streams (2F for gate/up, D for down) alone, runs each slice as
one f32 chain of 16-deep steps in increasing k, sums the slice results in
slice order and then rounds (down) or takes the SiLU product with the
plain version's roundings (gate/up). Its rows come in tiles of 8 to 128
rows within an expert, and its persistent blocks walk (row tile, column
tile) items row tile by row tile. These
tests hold the split's contract at every registry MoE width, the tiles'
cover of the rows, and an emulation of that order against
``moe_experts_plain`` and, through the port's routing and combine, JAX
``moe_block``. On the card the kernel's split and tile size are held to
these mirrors and its rows bit for bit across R and tile sizes
(tests/test_torch_cuda.py, chip_smoke.py phase 9 A).

Tolerances: the emulation against the plain version, bfloat16, each row's
max |err| <= 2e-2 x the row's own max |reference| (the bf16 row tolerance
of the port's kernel checks: the rounding points are the same, the order
of the f32 sums is not); float32, each row's max |err| <= 1e-5 x the row's
own max |reference| (the order of the f32 sums only). Against JAX
``moe_block`` in float32 after the combine, atol = rtol = 1e-5, as
tests/test_torch_moe.py holds the port's block.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu.ops.moe import moe_block as j_moe_block
from llms_on_kubernetes_tpu_torch import configs as tconfigs
from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.ops import moe

SOURCE = Path(kernels.CSRC) / "moe_experts.cu"
BODY = Path(kernels.CSRC) / "moe_stream.cuh"      # the body both expert kernels share
W8_SOURCE = Path(kernels.CSRC) / "moe_experts_w8.cu"
MOE_MODELS = sorted(n for n, c in tconfigs.REGISTRY.items() if c.num_experts)


def _check_split(K: int, Nw: int) -> list:
    sp = moe.moe_splits(K, Nw)
    S = len(sp)
    unit = 64 if K % 64 == 0 else 32
    assert S >= 1 and S & (S - 1) == 0, sp                    # a power of two
    assert S <= 16                                             # make_split's most
    assert sp[0][0] == 0 and sp[-1][1] == K
    for (_, b), (c, _) in zip(sp, sp[1:]):
        assert b == c                                          # contiguous, in order
    for a, b in sp:
        assert a % unit == 0 and b > a and (b - a) % unit == 0  # whole units
    units = [(b - a) // unit for a, b in sp]
    assert max(units) - min(units) <= 1                        # balanced
    return sp


@pytest.mark.parametrize("model", MOE_MODELS)
def test_splits_at_every_registry_moe_width(model):
    """Gate/up (K = D over 2F weight columns) and down (K = F over D) at
    each MoE model's widths: the contract, and nothing but D and F goes in."""
    c = tconfigs.get_config(model)
    D, Fd = c.hidden_size, c.intermediate_size
    for K, Nw in ((D, 2 * Fd), (Fd, D)):
        assert _check_split(K, Nw) == moe.moe_splits(K, Nw)


def test_split_counts_at_the_served_widths():
    """The slice counts the kernel uses at the served MoE widths (a change
    here changes every bf16 expert result: held against the kernel itself
    on the card)."""
    got = {m: (len(moe.moe_splits(c.hidden_size, 2 * c.intermediate_size)),
               len(moe.moe_splits(c.intermediate_size, c.hidden_size)))
           for m, c in ((m, tconfigs.get_config(m)) for m in MOE_MODELS)}
    assert got["qwen3-30b-a3b"] == (16, 8)
    assert got["mixtral-8x7b"] == (4, 16)
    assert got["debug-moe"] == (1, 2)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 512), st.integers(1, 512))
def test_splits_of_any_width(k32, n32):
    """Any K and any weight columns the kernel takes (multiples of 32): the
    same contract, and the same answer asked twice."""
    K, Nw = 32 * k32, 32 * n32
    assert _check_split(K, Nw) == moe.moe_splits(K, Nw)


def _counts_cases():
    rng = np.random.default_rng(0)
    return {
        "zeros between": [0, 3, 0, 0, 130, 1, 0, 64],
        "one expert": [0, 0, 300, 0],
        "uniform 128": list(rng.multinomial(32768, [1 / 128] * 128)),
        "not a tile multiple": [129, 255, 1, 63, 65, 0, 7],
        "all zero": [0] * 8,
    }


@pytest.mark.parametrize("rows", [8, 16, 32, 64, moe.MOE_PREFILL_ROWS])
@pytest.mark.parametrize("case", list(_counts_cases()))
def test_every_kept_row_lands_in_exactly_one_tile(case, rows):
    counts = _counts_cases()[case]
    tiles = moe.moe_tiles(counts, rows)
    seen = np.zeros(sum(counts), dtype=np.int64)
    starts = np.cumsum([0] + list(counts))
    for e, r0, n in tiles:
        assert 1 <= n <= rows
        assert starts[e] <= r0 and r0 + n <= starts[e + 1]     # within its expert
        seen[r0:r0 + n] += 1
    assert (seen == 1).all()
    assert [t[1] for t in tiles] == sorted(t[1] for t in tiles)  # in row order
    # at most ceil(R / rows) + min(E, R) tiles: one partial tile an expert
    R = max(1, sum(counts))
    assert len(tiles) <= -(-R // rows) + min(len(counts), R)


@pytest.mark.parametrize("gated,N", [(True, 768), (False, 2048), (True, 96), (False, 64)])
@pytest.mark.parametrize("case", ["zeros between", "uniform 128", "not a tile multiple"])
def test_the_persistent_walk_covers_every_item_once(case, gated, N):
    """Each (row tile, column tile) is one block's, blocks take items b, b +
    blocks, ..., and the blocks running side by side share a row tile."""
    counts = _counts_cases()[case]
    blocks = 132
    walk = moe.moe_walk(counts, N, gated, blocks)
    C = moe.moe_col_tiles(N, gated)
    items = [it for b in walk for it in b]
    tiles = moe.moe_tiles(counts, moe.MOE_PREFILL_ROWS)
    assert all(len(b) in (len(walk[0]), len(walk[0]) - 1) for b in walk)  # balanced
    assert sorted(items) == sorted((*t, c) for t in tiles for c in range(C))
    assert len(set(items)) == len(items)
    # in walk order (item w is block w % blocks's (w // blocks)-th), each
    # row tile's C column tiles follow one another, row tiles in order
    order = [walk[w % blocks][w // blocks] for w in range(len(items))]
    assert [it[:3] for it in order] == [t for t in tiles for _ in range(C)]
    assert [it[3] for it in order] == list(range(C)) * len(tiles)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 70000), st.integers(1, 5000), st.sampled_from([4, 8, 16, 128, 512]))
def test_the_tile_follows_rows_an_expert_can_hold(R, N, E):
    """Tiles of 8 to 64 rows (a power of two that holds min(R, N), the most
    rows an expert takes when a token claims an expert once, or four times
    an expert's even share where that is fewer), else 128."""
    nx, most = moe.moe_rows(R, N, E), min(R, N)
    if 4 * R // E < most:
        most = max(4 * R // E, 8)
    if most > moe.MOE_POW2_ROWS:
        assert nx == moe.MOE_PREFILL_ROWS
    else:
        assert nx in (8, 16, 32, 64) and nx >= most and (nx == 8 or nx < 2 * most)


def test_the_mirrors_name_the_kernels_constants():
    """The tile sizes the mirrors assume are the ones the body sets."""
    text = BODY.read_text()
    for name, want in (("kCols", moe.MOE_COLS), ("kMaxPow2Rows", moe.MOE_POW2_ROWS),
                       ("kPreRows", moe.MOE_PREFILL_ROWS), ("kMaxExperts", moe.MOE_MAX_EXPERTS),
                       ("kChains", moe.MOE_CHAINS), ("kSpreadItems", moe.MOE_SPREAD_ITEMS)):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m and int(m.group(1)) == want, name
    assert "make_split(K, Nw, K % kBK == 0 ? kBK : 32)" in text
    # the decode body takes whole-tile splits of at least kChains slices
    assert "return K % kBK == 0 && sp.S >= kChains && (K / kBK) % sp.S == 0;" in text
    assert "if (S <= kChains || col_tiles(N, gated) * E >= kSpreadItems * sms) return 1;" in text


# ---------------------------------------------------------------------------
# the int8 kernel's decode body: slices side by side, spread over a cluster
# ---------------------------------------------------------------------------

def _launches():
    """(model, K, N, gated) of every registry MoE model's two launches."""
    for m in MOE_MODELS:
        c = tconfigs.get_config(m)
        D, Fd = c.hidden_size, c.intermediate_size
        yield m, c.num_experts, D, Fd, True
        yield m, c.num_experts, Fd, D, False


def test_the_decode_body_takes_the_served_widths_it_should():
    """Which launches the decode body takes (whole-tile slices, at least two)
    and over how many blocks an item spreads, on 132 SMs: Mixtral's down
    launch (32 column tiles x 8 experts) spreads its 16 slices over 8
    blocks; qwen3's 64/128-row down slices and debug-moe's 32-row units
    stay on the shared body."""
    got = {(m, gated): moe.moe_spread_blocks(K, N, gated, E, 132)
           for m, E, K, N, gated in _launches()}
    assert got[("mixtral-8x7b", True)] == 1 and got[("mixtral-8x7b", False)] == 8
    assert got[("qwen3-30b-a3b", True)] == 1 and got[("qwen3-30b-a3b", False)] == 0
    assert got[("debug-moe", True)] == 0 and got[("debug-moe", False)] == 0


@pytest.mark.parametrize("kc,S", [(1, 2), (1, 4), (1, 16), (2, 4), (4, 8), (8, 16)])
@pytest.mark.parametrize("items", [1, 7, 192, 1568])
def test_every_item_slice_is_computed_once(kc, S, items):
    """Every (item, slice) is one block's, every item's fold names each
    slice once, and the blocks of a cluster walk the same items."""
    clusters = max(1, 132 // kc)
    blocks, folds = moe.moe_spread_schedule(S, items, kc, clusters)
    assert len(blocks) == clusters * kc
    seen = {}
    for (c, r), work in blocks.items():
        assert [w for w, _ in work] == list(range(c, items, clusters))
        for w, slices in work:
            for s in slices:
                seen[(w, s)] = seen.get((w, s), 0) + 1
    assert seen == {(w, s): 1 for w in range(items) for s in range(S)}
    assert sorted(folds) == list(range(items))
    for w, parts in folds.items():
        assert all(b[0] == w % clusters for b, _ in parts)     # the item's own cluster


def _simulate_fold(chains: np.ndarray, kc: int) -> np.ndarray:
    """The kernel's sums of one item, literally, in float32: each block's
    chains (kc > 1) or in-order sum (kc = 1) as partial entries, then the
    fold over ``moe_spread_schedule``'s entries in its order."""
    S = chains.shape[0]
    blocks, folds = moe.moe_spread_schedule(S, 1, kc, 1)
    entries = {}
    for (c, r), work in blocks.items():
        for _w, slices in work:
            if kc > 1:
                for i, s in enumerate(slices):
                    entries[((c, r), i)] = chains[s]
            else:
                tot = None
                for s in slices:                      # groups of MOE_CHAINS, in order
                    tot = chains[s] if tot is None else (tot + chains[s]).astype(np.float32)
                entries[((c, r), 0)] = tot
    out = None
    for key in folds[0]:
        v = entries[key]
        out = v if out is None else (out + v).astype(np.float32)
    return out


def _fold_cases():
    for m, E, K, N, gated in _launches():
        Nw = 2 * N if gated else N
        kc = moe.moe_spread_blocks(K, N, gated, E, 132)
        yield m, K, Nw, kc
    # debug-moe's down launch (K 96: 32-row units) on the shared body, and
    # its decode-body forms at any cluster size the split allows
    yield "debug-moe unit 32", 96, 64, 0


@pytest.mark.parametrize("m,K,Nw,kc", list(_fold_cases()))
def test_the_fold_sums_slices_in_slice_order(m, K, Nw, kc):
    """A numpy float32 simulation of the fold equals the sequential slice
    sum ((c0 + c1) + c2) + ... bit for bit, in both of the decode body's
    forms (local: kc 1; spread: S / 2 blocks) and the shared body's (kc 0:
    one block, every slice in order), at every registry MoE width and at
    debug-moe's 32-row unit split."""
    S = len(moe.moe_splits(K, Nw))
    rng = np.random.default_rng(K * 7 + Nw)
    # chains of very different sizes, so that a change of order shows
    chains = (rng.standard_normal((S, 8, 64)) * 10.0 ** rng.integers(-3, 4, (S, 1, 1))
              ).astype(np.float32)
    want = chains[0]
    for s in range(1, S):
        want = (want + chains[s]).astype(np.float32)
    forms = {max(kc, 1)} | ({1, S // moe.MOE_CHAINS} if S >= moe.MOE_CHAINS else {1})
    for form in sorted(forms):
        got = _simulate_fold(chains, form)
        assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                          want.view(np.uint32)), form
    # another order (pairs first) is not the kernel's: the chains' sizes show it
    if S >= 4:
        pairs = [(chains[2 * i] + chains[2 * i + 1]).astype(np.float32) for i in range(S // 2)]
        other = pairs[0]
        for v in pairs[1:]:
            other = (other + v).astype(np.float32)
        assert not np.array_equal(other, want)


@pytest.mark.parametrize("launch", list(_launches()), ids=lambda v: str(v))
def test_the_spread_grid_does_not_depend_on_r(launch):
    """The decode body's grid (its cluster size and the blocks of the
    clusters that fit 132 SMs) is the same at every R: R changes only the
    items the tile tables make, which the same blocks walk."""
    _m, E, K, N, gated = launch
    assert "R" not in inspect.signature(moe.moe_spread_blocks).parameters
    kc = max(1, moe.moe_spread_blocks(K, N, gated, E, 132))
    S = len(moe.moe_splits(K, 2 * N if gated else N))
    assert kc == 1 or kc * moe.MOE_CHAINS == S
    grids = set()
    for R in (1, 16, 64, 512, 8192, 70000):
        counts = [R // E + (e < R % E) for e in range(E)]
        rows = moe.moe_rows(R, max(1, R // 2), E)
        items = len(moe.moe_tiles(counts, rows)) * moe.moe_col_tiles(N, gated)
        blocks, folds = moe.moe_spread_schedule(S, items, kc, 132 // kc)
        assert len(folds) == items
        grids.add(tuple(sorted(blocks)))
    assert len(grids) == 1


def _params(text: str, symbol: str) -> list:
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert m, symbol
    c_types = {"int": "c_int", "const void*": "c_void_p", "void*": "c_void_p"}
    return [c_types[re.sub(r"\s+\w+$", "", p.strip())] for p in m.group(1).split(",")]


def test_c_entries_match_their_bindings():
    """``llmk_moe_experts`` (x rows now among its ints, for the tile size) and the
    two mirror entries take what ``kernels`` binds."""
    text = SOURCE.read_text()
    symbol, argtypes = kernels._SIGNATURES["moe_experts"]
    assert symbol == "llmk_moe_experts"
    assert _params(text, symbol) == [a.__name__ for a in argtypes]
    assert len(argtypes) == 14
    for name in ("moe_splits", "moe_rows"):
        lib, symbol, argtypes = kernels._EXTRA_ENTRIES[name]
        assert lib == "moe_experts"
        assert _params(text, symbol) == [a.__name__ for a in argtypes]
    # the int8 kernel's entry: the three scale pointers after the weights
    symbol, argtypes = kernels._SIGNATURES["moe_experts_w8"]
    assert symbol == "llmk_moe_experts_w8"
    assert _params(W8_SOURCE.read_text(), symbol) == [a.__name__ for a in argtypes]
    assert len(argtypes) == 17


# ---------------------------------------------------------------------------
# the order of sums
# ---------------------------------------------------------------------------

def _chain_sum(a: torch.Tensor, w: torch.Tensor, Nw: int) -> torch.Tensor:
    """a [n, K] @ w [K, N] in the kernel's order: per slice of
    ``moe_splits(K, Nw)`` a chain of 16-deep steps in increasing k, the
    slices summed in order, all in float32."""
    tot = None
    for k0, k1 in moe.moe_splits(a.shape[1], Nw):
        chain = a[:, k0:k0 + 16] @ w[k0:k0 + 16]
        for k in range(k0 + 16, k1, 16):
            chain = chain + a[:, k:k + 16] @ w[k:k + 16]
        tot = chain if tot is None else tot + chain
    return tot


def emulate(x, src, counts, wg, wu, wd) -> torch.Tensor:
    """The kernel's order on the CPU: y [R, D] in x's dtype, rows past the
    kept ones 0; gate and up summed in the order above, rounded to x's
    dtype, SiLU rounded, the product rounded; down summed likewise and
    rounded."""
    R, D = src.shape[0], x.shape[1]
    Fd = wg.shape[2]
    y = torch.zeros((R, D), dtype=x.dtype)
    start = 0
    for e, c in enumerate(counts.tolist()):
        if c:
            xs = x[src[start:start + c].long()].float()
            g = _chain_sum(xs, wg[e].float(), 2 * Fd).to(x.dtype)
            u = _chain_sum(xs, wu[e].float(), 2 * Fd).to(x.dtype)
            h = (F.silu(g.float()).to(x.dtype).float() * u.float()).to(x.dtype)
            y[start:start + c] = _chain_sum(h.float(), wd[e].float(), D).to(x.dtype)
        start += c
    return y


def _rows_close(got: np.ndarray, want: np.ndarray, dtype):
    n = want.shape[-1]
    row_err = np.abs(got - want).reshape(-1, n).max(axis=1)
    row_max = np.abs(want).reshape(-1, n).max(axis=1)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    keep = row_max > 0
    worst = float((row_err[keep] / row_max[keep]).max(initial=0.0))
    assert (row_err[keep] <= tol * row_max[keep]).all(), worst
    assert (row_err[~keep] == 0).all()


def _inputs(seed, N, D, Fd, E, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) * D ** -0.5).astype(np.float32)
    wg, wu = ((rng.normal(size=(E, D, Fd)) * D ** -0.5).astype(np.float32) for _ in range(2))
    wd = (rng.normal(size=(E, Fd, D)) * Fd ** -0.5).astype(np.float32)
    arrays = (x, router, wg, wu, wd)
    if dtype == torch.bfloat16:
        arrays = tuple(a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in arrays)
    return arrays, tuple(torch.from_numpy(a).to(dtype) for a in arrays)


# (N, D, F, E, k): debug-moe's widths (K of 64 and 96: one slice, then
# slices of 32 rows), a 16-expert top-8 case, widths whose split has 4-16
# slices
EMU = [(8, 64, 96, 4, 2), (16, 128, 64, 16, 8), (5, 96, 160, 8, 2), (12, 2048, 64, 4, 2),
       (6, 256, 1024, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("N,D,Fd,E,k", EMU)
def test_the_order_of_sums_equals_plain_and_jax_moe_block(N, D, Fd, E, k, dtype):
    """The emulated order against ``moe_experts_plain`` on the same routed
    rows, and (float32) through the port's combine against JAX
    ``moe_block`` on the same numpy inputs."""
    arrays, (x, router, wg, wu, wd) = _inputs(N + D + Fd + E, N, D, Fd, E, dtype)
    route = moe.moe_route(x, router, top_k=k)
    got = emulate(x, route.src, route.counts, wg, wu, wd)
    assert got.dtype == dtype and tuple(got.shape) == (N * k, D)
    plain = moe.moe_experts_plain(x, route.src, route.counts, wg, wu, wd)
    _rows_close(got.float().numpy(), plain.float().numpy(), dtype)
    if dtype == torch.float32:
        want = np.asarray(j_moe_block(*(jnp.asarray(a) for a in arrays), top_k=k))
        out = moe.moe_combine(got, route).numpy()
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_the_order_does_not_depend_on_r():
    """A row of the emulation alone equals that row among many: the split
    and the order come from D and F only."""
    _, (x, router, wg, wu, wd) = _inputs(7, 40, 256, 1024, 8, torch.bfloat16)
    route = moe.moe_route(x, router, top_k=2)
    full = emulate(x, route.src, route.counts, wg, wu, wd)
    expert_of = torch.repeat_interleave(torch.arange(8), route.counts.long())
    for r in (0, 37, 79):
        one = torch.zeros(8, dtype=torch.int32)
        one[expert_of[r]] = 1
        assert torch.equal(emulate(x, route.src[r:r + 1], one, wg, wu, wd)[0], full[r])
