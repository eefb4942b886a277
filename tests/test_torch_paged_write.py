"""The window kernels' span decomposition (``ops/paged_write._window_spans``,
the formulas of ``csrc/paged_write_window.cu``'s grid) on the CPU.

Each block of the kernels writes one span: a run of window rows that lands
on one pool page, at most ``SPAN_ROWS`` rows, the runs cut by in-page
offset. The decomposition must cover every row the plain version writes
exactly once and no other row, at any base, width, window, page (1 to 130
rows, 24 and 100 among them) and table size, in no more spans than the
grid's ``window_span_count(W, page)``, a bound some base reaches. A writer
that copies each span as one run (what a block does) must then leave the
JAX Pallas kernel's pool bytes (interpret mode; its 8-row blocks need a
page that is a multiple of 8, the JAX dispatcher's own gate,
``ops/attention.py:333``, so page 24 and not 100) and the plain versions'
outside page 0 (pages 24 and 100 among them), and page 0 as it was.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu.ops.pallas_paged import pallas_paged_write_window
from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

R = pw.SPAN_ROWS

# (base per slot, width per slot, W, page, pps)
SPAN_CASES = {
    "mid_page_and_boundary": ([7, 8, 0, 15], [4, 3, 4, 2], 4, 8, 4),
    "width_0": ([0, 64, 5], [0, 0, 0], 64, 64, 4),
    "width_eq_page": ([0, 64, 10], [64, 64, 64], 64, 64, 4),
    "W_below_page": ([3, 60, 128], [50, 50, 17], 50, 64, 4),
    "W_not_a_page_multiple": ([0, 16, 5, 40], [20, 16, 1, 0], 20, 16, 4),
    "rows_past_the_table": ([100, 120, 127], [40, 8, 40], 40, 32, 4),
    "page_128_several_spans_a_page": ([0, 65, 127, 200], [200, 200, 1, 100], 200, 128, 3),
    "page_256": ([0, 300, 500], [512, 211, 20], 512, 256, 3),
    "page_4": ([0, 3, 9], [32, 30, 7], 32, 4, 12),
    "chunk_path_second_chunk": ([1024], [476], 1024, 64, 32),
    "chunk_path_four_slots": ([0, 896, 900, 0], [1024, 1024, 1000, 0], 1024, 64, 32),
    "cache_hit_tail": ([896], [104], 256, 64, 32),
    "negative_base": ([-5, -70], [10, 100], 100, 16, 8),
    # pages neither at most R rows nor a multiple of R: pieces of 16 and 8
    # rows (page 24), of 16 and 4 (page 100), of 16 and 2 (page 130)
    "page_24": ([5, 24, 17, 0], [32, 20, 31, 0], 32, 24, 3),
    "page_100": ([95, 0, 190, 40], [150, 100, 10, 0], 150, 100, 3),
    "page_130": ([125, 0, 260], [200, 130, 70], 200, 130, 3),
}


def _check_spans(base, widths, W, page, pps):
    spans = pw._window_spans(base, widths, W, page, pps)
    n_spans = pw.window_span_count(W, page)
    assert len(spans) == len(base) * n_spans                    # the grid, fixed by W and page
    want = {(b, t) for b, (b0, w) in enumerate(zip(base, widths))
            for t in range(min(w, W)) if 0 <= b0 + t < pps * page}
    seen = []
    for b, s, t0, r, slot in spans:
        if r <= 0:
            continue
        assert r <= R
        pos0 = base[b] + t0
        # one contiguous run of rows on one page of the table
        assert (pos0 + r - 1) // page == pos0 // page == slot < pps
        seen += [(b, t) for t in range(t0, t0 + r)]
    assert len(seen) == len(set(seen)), "a row lies in two spans"
    assert set(seen) == want


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_spans_cover_each_written_row_once(case):
    _check_spans(*SPAN_CASES[case])


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_spans_cover_each_written_row_once_drawn(data):
    # any page up to 130 rows, and the aligned pages up to 256
    page = data.draw(st.one_of(st.integers(1, 130),
                               st.sampled_from([1, 3, 4, 8, 12, R, 2 * R, 3 * R, 64, 128, 256,
                                                24, 100])))
    pps = data.draw(st.integers(1, 6))
    W = data.draw(st.integers(1, 3 * max(page, R)))
    B = data.draw(st.integers(1, 4))
    base = data.draw(st.lists(st.integers(-page, pps * page + 2), min_size=B, max_size=B))
    widths = data.draw(st.lists(st.integers(0, W + 2), min_size=B, max_size=B))
    _check_spans(base, widths, W, page, pps)


@settings(max_examples=150, deadline=None)
@given(page=st.one_of(st.integers(1, 130), st.sampled_from([24, 100])),
       W=st.integers(1, 300))
def test_span_count_is_tight(page, W):
    """Some base needs every span of the grid: the bound wastes no block."""
    pps = (W + 2 * page) // page + 2
    used = max(sum(r > 0 for *_, r, _ in pw._window_spans([b], [W], W, page, pps))
               for b in range(page))
    assert used == pw.window_span_count(W, page)


@pytest.mark.parametrize("page", list(range(1, 17)) + [32, 48, 64, 128, 256])
def test_span_count_keeps_the_aligned_grid(page):
    """At a page of at most R rows or a multiple of R the grid is the one
    the kernels had before they took any page: ceil((W - 1) / rp) + 1."""
    rp = min(page, R)
    for W in (1, 2, 15, 16, 17, 64, 476, 1024):
        assert pw.window_span_count(W, page) == -(-(W - 1) // rp) + 1


def _span_write(pools, table, base, widths, k_new, v_new, int8: bool):
    """What the blocks do: each span's rows copied as one run into its
    page (quantized row by row for an int8 pool); nothing else written."""
    page, pps = pools[0].shape[2], table.shape[1]
    W = k_new.shape[1]
    sides = ((pools[0], pools[1], k_new), (pools[2], pools[3], v_new)) if int8 else \
        ((pools[0], None, k_new), (pools[1], None, v_new))
    for b, _, t0, r, slot in pw._window_spans(base, widths, W, page, pps):
        if r <= 0:
            continue
        off = (int(base[b]) + t0) % page
        for data, scale, x in sides:
            rows = x[b, t0:t0 + r].transpose(0, 1)               # [n_kv, r, d]
            if int8:
                q, s = quantize_kv(rows)
                data[:, table[b, slot], off:off + r] = q
                scale[:, table[b, slot], off:off + r] = s
            else:
                data[:, table[b, slot], off:off + r] = rows.to(data.dtype)


def _setup(rng, base, widths, W, page, pps, n_kv=2, d=8):
    B = len(base)
    P = B * pps + 1
    table = (rng.permutation(P - 1)[:B * pps] + 1).reshape(B, pps).astype(np.int32)
    k_new = rng.normal(size=(B, W, n_kv, d)).astype(np.float32)
    v_new = rng.normal(size=(B, W, n_kv, d)).astype(np.float32)
    return P, table, np.asarray(base, np.int32), np.asarray(widths, np.int32), k_new, v_new


# the cases inside the Pallas kernel's domain: positions inside the page
# table (it does not drop the rows past it, the port's writers do) and the
# small pages and windows its interpret mode runs quickly
PALLAS_CASES = ["mid_page_and_boundary", "width_0", "width_eq_page", "W_below_page",
                "W_not_a_page_multiple", "page_128_several_spans_a_page", "page_24"]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_span_writer_matches_the_pallas_kernel(rng, case):
    base, widths, W, page, pps = SPAN_CASES[case]
    P, table, base, widths, k_new, v_new = _setup(rng, base, widths, W, page, pps)
    kp = rng.normal(size=(2, P, page, 8)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    jk, jv = pallas_paged_write_window(
        *(jnp.asarray(a) for a in (kp, vp, table, base, widths, k_new, v_new)), interpret=True)
    got = [torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())]
    _span_write(got, table, base, widths, torch.from_numpy(k_new), torch.from_numpy(v_new),
                int8=False)
    for g, j, before in zip(got, (jk, jv), (kp, vp)):
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(j)[:, 1:])
        np.testing.assert_array_equal(g.numpy()[:, 0], before[:, 0])    # page 0 untouched


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pool", "int8_pool"])
@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_span_writer_equals_the_plain_version(rng, case, int8):
    base, widths, W, page, pps = SPAN_CASES[case]
    P, table, base, widths, k_new, v_new = _setup(rng, base, widths, W, page, pps)
    if int8:
        pools = [torch.from_numpy(a) for a in (
            rng.integers(-127, 128, size=(2, P, page, 8)).astype(np.int8),
            (rng.random(size=(2, P, page)) + 0.1).astype(np.float32),
            rng.integers(-127, 128, size=(2, P, page, 8)).astype(np.int8),
            (rng.random(size=(2, P, page)) + 0.1).astype(np.float32))]
        plain = pw.paged_write_window_int8_plain
    else:
        pools = [torch.from_numpy(rng.normal(size=(2, P, page, 8)).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(2)]
        plain = pw.paged_write_window_plain
    before = [p.clone() for p in pools]
    ref = [p.clone() for p in pools]
    args = [torch.from_numpy(a) for a in (table, base, widths, k_new, v_new)]
    plain(*ref, *args)
    _span_write(pools, table, base, widths, *args[3:], int8=int8)
    for g, want, old in zip(pools, ref, before):
        assert torch.equal(g[:, 1:], want[:, 1:])
        assert torch.equal(g[:, 0], old[:, 0])
