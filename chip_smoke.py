#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llms_on_kubernetes_tpu_torch``) on one
NVIDIA GPU and check it end to end. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``csrc/`` (one nvcc per source,
   in parallel) and print the build seconds and the card's name and power
   limit;
2. kernels: hold each kernel against its plain PyTorch version on the card
   -- the small shapes of tests/test_pallas.py and tests/test_kv_int8.py in
   float32 and full-width llama-3-8b shapes in bfloat16 (int8 pools for
   the int8 kernels) -- and time kernel, plain version, and (for prefill)
   the ``scaled_dot_product_attention`` yardstick;
3. serve: start ``python -m llms_on_kubernetes_tpu_torch serve --model
   llama-3-8b --random-weights --device cuda`` (the default EngineConfig:
   8 slots, decode_steps 4, kv_write "dus", bf16) and send concurrent
   completions and a streamed chat with prompts in each prefill bucket;
   the kernel launch counters are zeroed just before and read just after;
   then the same again with ``--kv-cache-dtype int8`` (the int8 decode
   kernel, and never the float one, on every layer of every decode step).
   Before it, a reference check on a small input: debug-tiny in float32
   on the card against the same weights on the CPU (prefill logits within
   1e-4, greedy streams identical, float and int8 KV);
4. fused: in this process, the same random weights behind an Engine with
   kv_write "fused", first with bf16 KV, then with int8 KV: requests
   through it (counters zeroed before, read after), the same greedy
   streams as kv_write "dus", and one decode step both ways from copies of
   one pool (bf16 logits within the bf16 tolerance, int8 logits identical;
   pools byte-equal outside the trash pages, int8 scales included).

The line before the last is the card's name and power limit as nvidia-smi
gives them; before it, one ``{"kernels": [...]}`` JSON line. The last line
is ``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device, or outside a checkout, it exits non-zero first.

Tolerances (kernel against plain version on the same inputs), held row by
row (one query head's d values): float32, |err| <= 1e-4 (only the
summation order differs); bfloat16, |err| <= 2e-2 * the row's own max
|plain| (the rounding points differ). The float32 cases include lengths
past one 256-key split, so the decode kernel's split merge is held at
1e-4. Pool bytes after the fused kernels must equal those after
write_tokens exactly (for int8, data and scales: the kernel quantizes as
engine/cache.quantize_kv does).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

MODEL = "llama-3-8b"
F32_TOL = 1e-4
BF16_REL_TOL = 2e-2
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
REPS = 20
OUT_DIR = "smoke_out"      # logs: nvcc build report, the server's output


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Mean device milliseconds of ``fn`` over REPS launches, each timed by
    its own CUDA events after a write of 128 MB that evicts the 50 MB L2
    cache (the main path finds each layer's KV cold). A ~0.5 ms spin kernel
    ahead of the start event keeps the card busy while the host issues
    ``fn``'s launches, so the events time the device work and not the
    Python wrapper's launch latency."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / reps


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prefill_work(lengths, n_q: int, n_kv: int, d: int, elt: int, window=None):
    """FLOPs and bytes flash prefill needs for these lengths: valid query
    rows attend keys <= t (and inside the window); q, k, v of valid tokens
    read once and the output of valid rows written once."""
    pairs = 0
    for n in lengths:
        t = np.arange(n)
        keys = t + 1 if window is None else np.minimum(t + 1, window)
        pairs += int(keys.sum())
    flops = 4.0 * d * n_q * pairs
    tokens = int(sum(lengths))
    nbytes = tokens * d * elt * (2 * n_q + 2 * n_kv) + 4 * len(lengths)
    return flops, nbytes


def decode_work(lengths, n_q: int, n_kv: int, d: int, elt: int, pps: int, write: bool,
                int8: bool = False):
    """FLOPs and bytes one decode attention call needs: each active query
    row attends its slot's keys; q read, out written, each cached K/V row
    read once (d * elt bytes a row and side, or d + 4 for an int8 row and
    its scale); the fused kernel also reads k_new/v_new (q's dtype) and
    writes one row per side per active slot."""
    B = len(lengths)
    keys = int(sum(lengths))
    active = sum(1 for n in lengths if n > 0)
    row = d + 4 if int8 else d * elt
    flops = 4.0 * d * n_q * keys
    cached = keys - (active if write else 0)
    nbytes = 2 * B * n_q * d * elt + 2 * cached * n_kv * row + 4 * B * (pps + 1)
    if write:
        nbytes += 2 * B * n_kv * d * elt + 2 * active * n_kv * row
    return flops, nbytes


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_close(name: str, out, ref, dtype: str, rows=None) -> float:
    """Hold ``out`` to ``ref`` row by row (a row is the last axis: one
    query head's d values, or one slot's logits). float32: |err| <= F32_TOL.
    bfloat16: each row's |err| <= BF16_REL_TOL * that row's max |ref|, so a
    long-context row, whose values are small, is held to its own scale.
    Returns the max abs error."""
    torch = sys.modules["torch"]
    o, r = out.float(), ref.float()
    if rows is not None:
        o, r = o[rows], r[rows]
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite kernel output")
    if not o.numel():
        say(f"  {name}: no rows to compare")
        return 0.0
    n = o.shape[-1]
    row_err = (o - r).abs().reshape(-1, n).amax(dim=1)
    if dtype == "float32":
        row_tol = torch.full_like(row_err, F32_TOL)
    else:
        row_tol = BF16_REL_TOL * r.abs().reshape(-1, n).amax(dim=1).clamp_min(1e-6)
    err, worst = float(row_err.max()), float((row_err / row_tol).max())
    say(f"  {name}: max_abs_err={err:.3e} worst row err/tol={worst:.3f} "
        f"(tightest row tol {float(row_tol.min()):.3e})")
    if not worst <= 1.0:
        fail(f"{name}: a row's error exceeds its tolerance (worst err/tol {worst:.3f})")
    return err


def paged_setup(torch, rng, B, n_kv, d, page, pps, lengths, dtype, pool_pages=None):
    """The tests' _paged_setup: random pools and per-slot page tables over
    distinct random pages (page 0 stays the trash page)."""
    P = pool_pages or B * pps + 1
    k = torch.from_numpy(rng.normal(size=(n_kv, P, page, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_kv, P, page, d)).astype(np.float32))
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = -(-int(lengths[b]) // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    return (k.to("cuda", dtype), v.to("cuda", dtype),
            torch.from_numpy(table).cuda())


def phase_kernels(torch) -> dict:
    from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    timer = Timer(torch)
    f32, bf16 = torch.float32, torch.bfloat16
    entries = {}

    def qkv(B, T, n_q, n_kv, d, dtype):
        mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
        return mk(B, T, n_q, d), mk(B, T, n_kv, d), mk(B, T, n_kv, d)

    # -- flash prefill ------------------------------------------------------
    say("kernel flash_prefill (replaces ops/pallas_flash.py::flash_prefill_attention)")
    for window, cap in [(None, None), (5, None), (None, 30.0)]:
        q, k, v = qkv(2, 16, 4, 2, 8, f32)
        lengths = torch.tensor([16, 9], dtype=torch.int32, device="cuda")
        kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        check_close(f"f32 B2 T16 window={window} softcap={cap}", out[0], ref[0], "float32")
        check_close(f"f32 B2 T16 window={window} softcap={cap} row1", out[1, :9], ref[1, :9],
                    "float32")
    q, k, v = qkv(2, 256, 2, 1, 16, f32)
    lengths = torch.tensor([256, 130], dtype=torch.int32, device="cuda")
    ref = fa.prefill_attention_plain(q, k, v, lengths, scale=16 ** -0.5)
    out = fa.flash_prefill_attention(q, k, v, lengths, scale=16 ** -0.5)
    check_close("f32 multiblock T256 row0", out[0], ref[0], "float32")
    check_close("f32 multiblock T256 row1", out[1, :130], ref[1, :130], "float32")
    # llama-3-8b widths in float32: up to 900 keys a row, 29 K/V tiles
    q, k, v = qkv(1, 1024, 32, 8, 128, f32)
    lengths = torch.tensor([900], dtype=torch.int32, device="cuda")
    ref = fa.prefill_attention_plain(q, k, v, lengths, scale=128 ** -0.5)
    out = fa.flash_prefill_attention(q, k, v, lengths, scale=128 ** -0.5)
    check_close("f32 llama-3-8b widths B1 T1024 length 900", out[0, :900], ref[0, :900],
                "float32")
    main = None
    for T, n in [(64, 40), (1024, 1024), (1024, 900)]:
        q, k, v = qkv(1, T, 32, 8, 128, bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=128 ** -0.5)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        err = check_close(f"bf16 llama-3-8b B1 T{T} length {n}", out[0, :n], ref[0, :n],
                          "bfloat16")
        if (T, n) == (1024, 900):
            main = (q, k, v, lengths, err)
    q, k, v, lengths, err = main
    kw = dict(scale=128 ** -0.5)
    ms = timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw))
    plain = timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, **kw))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t[:, :900].transpose(1, 2) for t in (q, k, v))
    try:
        sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
        lib = timer(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
    except TypeError:   # a torch without enable_gqa: expand the KV heads first
        kx, vx = kh.repeat_interleave(4, dim=1), vh.repeat_interleave(4, dim=1)
        lib = timer(lambda: sdpa(qh, kx, vx, is_causal=True))
    flops, nbytes = prefill_work([900], 32, 8, 128, 2)
    b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
    entries["flash_prefill"] = dict(
        name="flash_prefill", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/flash_prefill.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_flash.py:89",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, shape="B1 T1024 length 900 n_q32 n_kv8 d128 bf16")

    # -- paged decode, plain and fused ----------------------------------------
    say("kernel paged_decode (replaces ops/pallas_paged.py::pallas_paged_attention)")
    for window, cap in [(None, None), (7, None), (None, 50.0)]:
        lens = np.array([13, 16, 5])
        kp, vp, table = paged_setup(torch, rng, 3, 2, 8, 4, 4, lens, f32)
        q = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32)).cuda()
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw)
        out = pa.paged_decode_attention(q, kp, vp, table, lengths, **kw)
        check_close(f"f32 B3 page4 window={window} softcap={cap}", out, ref, "float32")
    lens = np.array([6, 0])
    kp, vp, table = paged_setup(torch, rng, 2, 1, 8, 4, 2, lens, f32)
    q = torch.from_numpy(rng.normal(size=(2, 2, 8)).astype(np.float32)).cuda()
    out = pa.paged_decode_attention(q, kp, vp, table,
                                    torch.tensor([6, 0], dtype=torch.int32, device="cuda"),
                                    scale=8 ** -0.5)
    if not torch.isfinite(out).all() or out[1].abs().max() != 0:
        fail("paged decode: an idle slot must give finite zeros")
    say("  f32 idle slot: zeros")
    # float32 past one 256-key split (page 64, 32 pages a slot: 8 splits), so
    # the merge of real partials is held at 1e-4
    long_lens = np.array([300, 700, 2048, 0])
    for window, cap in [(None, None), (500, None), (None, 30.0)]:
        kp, vp, table = paged_setup(torch, rng, 4, 8, 128, 64, 32, long_lens, f32)
        q = torch.from_numpy(rng.normal(size=(4, 32, 128)).astype(np.float32)).cuda()
        lengths = torch.from_numpy(long_lens.astype(np.int32)).cuda()
        kw = dict(scale=128 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw)
        out = pa.paged_decode_attention(q, kp, vp, table, lengths, **kw)
        check_close(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window} "
                    f"softcap={cap}", out, ref, "float32",
                    rows=torch.from_numpy(long_lens > 0).cuda())

    def fused_case(label, lens, n_kv, group, d, page, pps, dtype, pool_pages=None,
                   window=None, cap=None):
        lens = np.asarray(lens)
        B = len(lens)
        kp, vp, table = paged_setup(torch, rng, B, n_kv, d, page, pps, lens, dtype,
                                    pool_pages)
        mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
        q, kn, vn = mk(B, n_kv * group, d), mk(B, n_kv, d), mk(B, n_kv, d)
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=cap)
        kr, vr = kp.clone(), vp.clone()
        ref = pa.paged_decode_attention_write_plain(q, kr, vr, table, lengths, kn, vn, **kw)
        out = pa.paged_decode_attention_write(q, kp, vp, table, lengths, kn, vn, **kw)
        act = torch.from_numpy(lens > 0).cuda()
        err = check_close(label, out, ref, "float32" if dtype == f32 else "bfloat16",
                          rows=act)
        # the plain path writes idle rows to the trash page 0; the kernel skips them
        if not (torch.equal(kp[:, 1:], kr[:, 1:]) and torch.equal(vp[:, 1:], vr[:, 1:])):
            fail(f"{label}: pool bytes differ from write_tokens'")
        say(f"  {label}: pool bytes equal")
        # the fused kernel attends exactly like the unfused one after the write
        ref2 = pa.paged_decode_attention(q, kr, vr, table, lengths, **kw)
        if not torch.equal(out[act], ref2[act]):
            fail(f"{label}: fused output differs from write_tokens + paged_decode")
        return kp, vp, table, q, kn, vn, lengths, err

    say("kernel paged_decode_write (replaces ops/pallas_paged.py::pallas_paged_attention_write)")
    fused_case("f32 page boundary", [8, 9, 24, 25], 2, 2, 8, 8, 4, f32)
    fused_case("f32 idle rows", [0, 0, 0], 1, 2, 8, 8, 2, f32)
    fused_case("f32 idle interleaved", [0, 5, 0, 8, 1], 2, 2, 8, 8, 2, f32)
    for window, cap in [(None, None), (9, None), (None, 40.0)]:
        fused_case(f"f32 B5 window={window} softcap={cap}", [13, 16, 1, 0, 32], 2, 2, 8, 8,
                   4, f32, window=window, cap=cap)
    for window in (None, 500):
        fused_case(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window}",
                   [300, 700, 2048, 0], 8, 4, 128, 64, 32, f32, window=window)

    # full-width llama-3-8b decode: 8 slots, page 64, lengths over 1..2048
    dec_lens = np.array([1, 63, 64, 65, 700, 1500, 2048, 0])
    kp, vp, table = paged_setup(torch, rng, 8, 8, 128, 64, 32, dec_lens, bf16, pool_pages=512)
    q = torch.from_numpy(rng.normal(size=(8, 32, 128)).astype(np.float32)).to("cuda", bf16)
    lengths = torch.from_numpy(dec_lens.astype(np.int32)).cuda()
    kw = dict(scale=128 ** -0.5)
    act = torch.from_numpy(dec_lens > 0).cuda()
    ref = pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw)
    out = pa.paged_decode_attention(q, kp, vp, table, lengths, **kw)
    err_dec = check_close("bf16 llama-3-8b B8 page64 lengths 1..2048", out, ref, "bfloat16",
                          rows=act)
    ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, table, lengths, **kw))
    plain = timer(lambda: pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw))
    flops, nbytes = decode_work(dec_lens, 32, 8, 128, 2, 32, write=False)
    b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
    entries["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:1118",
        max_abs_err=err_dec, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        shape="B8 n_q32 n_kv8 d128 page64 lengths 1,63,64,65,700,1500,2048,0 bf16",
        library_note="no single PyTorch call computes attention through a page table")

    kp, vp, table, q, kn, vn, lengths, err_w = fused_case(
        "bf16 llama-3-8b B8 page64 lengths 1..2048", dec_lens, 8, 4, 128, 64, 32, bf16,
        pool_pages=512)
    ms = timer(lambda: pa.paged_decode_attention_write(q, kp, vp, table, lengths, kn, vn,
                                                       **kw))
    plain = timer(lambda: pa.paged_decode_attention_write_plain(q, kp, vp, table, lengths,
                                                                kn, vn, **kw))
    flops, nbytes = decode_work(dec_lens, 32, 8, 128, 2, 32, write=True)
    b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
    entries["paged_decode_write"] = dict(
        name="paged_decode_write", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:476",
        max_abs_err=err_w, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        shape="B8 n_q32 n_kv8 d128 page64 lengths 1,63,64,65,700,1500,2048,0 bf16",
        library_note="no single PyTorch call computes attention through a page table")
    entries.update(int8_kernels(torch, rng, timer, dec_lens))
    for e in entries.values():
        say(f"  timing {e['name']}: ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} "
            f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']}) library_ms={e['library_ms']}")
    return entries


def int8_kernels(torch, rng, timer, dec_lens) -> dict:
    """Phase 2 for the int8 pool's kernels: paged_decode_int8 and
    paged_decode_write_int8 against their plain versions, then timed at
    the full-width shape of the float kernels (bf16 q, int8 pool)."""
    from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    f32, bf16 = torch.float32, torch.bfloat16
    entries = {}

    def setup(B, n_kv, d, page, pps, lens, pool_pages=None):
        """int8 pools holding quantize_kv's bytes of random K/V, quantized
        on the card, and the tests' page tables."""
        kp, vp, table = paged_setup(torch, rng, B, n_kv, d, page, pps, lens, f32, pool_pages)
        return [*quantize_kv(kp), *quantize_kv(vp)], table

    def mk(*shape, dtype=f32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)

    say("kernel paged_decode_int8 (replaces ops/pallas_paged.py::pallas_paged_attention_int8)")
    # tests/test_kv_int8.py:77: 2 KV heads, page 4, d 128, lengths 12 and 7
    lens = np.array([12, 7])
    pools, table = setup(2, 2, 128, 4, 8, lens)
    q = mk(2, 4, 128)
    lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
    for window in (None, 6):
        kw = dict(scale=0.3, sliding_window=window)
        ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw)
        out = pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw)
        check_close(f"f32 B2 page4 d128 window={window}", out, ref, "float32")
    long_lens = np.array([300, 700, 2048, 0])
    act = torch.from_numpy(long_lens > 0).cuda()
    for window, cap in [(None, None), (500, None), (None, 30.0)]:
        pools, table = setup(4, 8, 128, 64, 32, long_lens)
        q = mk(4, 32, 128)
        lengths = torch.from_numpy(long_lens.astype(np.int32)).cuda()
        kw = dict(scale=128 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw)
        out = pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw)
        check_close(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window} "
                    f"softcap={cap}", out, ref, "float32", rows=act)
        if out[3].abs().max() != 0:
            fail("paged_decode_int8: an idle slot must give zeros")

    def fused_case(label, lens, n_kv, group, d, page, pps, dtype, pool_pages=None,
                   window=None, cap=None):
        lens = np.asarray(lens)
        B = len(lens)
        pools, table = setup(B, n_kv, d, page, pps, lens, pool_pages)
        q, kn, vn = mk(B, n_kv * group, d, dtype=dtype), mk(B, n_kv, d, dtype=dtype), \
            mk(B, n_kv, d, dtype=dtype)
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=cap)
        ref_pools = [t.clone() for t in pools]
        ref = pa.paged_decode_attention_write_int8_plain(q, *ref_pools, table, lengths, kn, vn,
                                                         **kw)
        out = pa.paged_decode_attention_write_int8(q, *pools, table, lengths, kn, vn, **kw)
        act = torch.from_numpy(lens > 0).cuda()
        err = check_close(label, out, ref, "float32" if dtype == f32 else "bfloat16", rows=act)
        # the plain path writes idle rows to the trash page 0; the kernel skips them
        if not all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pools, ref_pools)):
            fail(f"{label}: int8 data or scale bytes differ from write_tokens'")
        say(f"  {label}: pool data and scale bytes equal")
        ref2 = pa.paged_decode_attention_int8(q, *ref_pools, table, lengths, **kw)
        if not torch.equal(out[act], ref2[act]):
            fail(f"{label}: fused output differs from write_tokens + paged_decode_int8")
        return pools, table, q, kn, vn, lengths, err

    say("kernel paged_decode_write_int8 (replaces "
        "ops/pallas_paged.py::pallas_paged_attention_write_int8)")
    # tests/test_kv_int8.py:104-165: history 13, 16, 1, 0, 31 at page 8
    for window, cap in [(None, None), (9, None), (None, 40.0)]:
        fused_case(f"f32 B5 d8 page8 window={window} softcap={cap}", [14, 17, 2, 0, 32], 2, 2,
                   8, 8, 4, f32, window=window, cap=cap)
    fused_case("f32 page boundary", [8, 9, 24, 25], 2, 2, 16, 8, 4, f32)
    fused_case("f32 idle rows", [0, 0, 0], 1, 2, 8, 8, 2, f32)
    for window in (None, 500):
        fused_case(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window}",
                   [300, 700, 2048, 0], 8, 4, 128, 64, 32, f32, window=window)

    # full-width llama-3-8b decode over an int8 pool: the float kernels' shape
    pools, table = setup(8, 8, 128, 64, 32, dec_lens, pool_pages=512)
    q = mk(8, 32, 128, dtype=bf16)
    lengths = torch.from_numpy(dec_lens.astype(np.int32)).cuda()
    kw = dict(scale=128 ** -0.5)
    act = torch.from_numpy(dec_lens > 0).cuda()
    ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw)
    out = pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw)
    err = check_close("bf16 q, int8 pool, llama-3-8b B8 page64 lengths 1..2048", out, ref,
                      "bfloat16", rows=act)
    ms = timer(lambda: pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw))
    plain = timer(lambda: pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw))
    flops, nbytes = decode_work(dec_lens, 32, 8, 128, 2, 32, write=False, int8=True)
    b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
    shape = "B8 n_q32 n_kv8 d128 page64 lengths 1,63,64,65,700,1500,2048,0 bf16 q, int8 pool"
    entries["paged_decode_int8"] = dict(
        name="paged_decode_int8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:264",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=shape,
        library_note="no single PyTorch call computes attention through a page table")

    pools, table, q, kn, vn, lengths, err = fused_case(
        "bf16 q, int8 pool, llama-3-8b B8 page64 lengths 1..2048", dec_lens, 8, 4, 128, 64,
        32, bf16, pool_pages=512)
    ms = timer(lambda: pa.paged_decode_attention_write_int8(q, *pools, table, lengths, kn, vn,
                                                            **kw))
    plain = timer(lambda: pa.paged_decode_attention_write_int8_plain(q, *pools, table, lengths,
                                                                     kn, vn, **kw))
    flops, nbytes = decode_work(dec_lens, 32, 8, 128, 2, 32, write=True, int8=True)
    b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
    entries["paged_decode_write_int8"] = dict(
        name="paged_decode_write_int8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:874",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=shape,
        library_note="no single PyTorch call computes attention through a page table")
    return entries


# ---------------------------------------------------------------------------
# phase 3: the server, through its normal entry point
# ---------------------------------------------------------------------------

def http(method: str, url: str, body=None, timeout: float = 600.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def stream(url: str, body: dict, timeout: float = 600.0):
    """POST a streaming request; return (status, [(t, data line)], t0)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append((time.perf_counter(), line[6:]))
        return r.status, events, t0


def check_stream(name: str, status: int, events, max_tokens: int) -> list[dict]:
    if status != 200:
        fail(f"{name}: HTTP {status}")
    if not events or events[-1][1] != "[DONE]":
        fail(f"{name}: the stream does not end in [DONE]")
    chunks = [json.loads(d) for _, d in events[:-1]]
    finals = [c for c in chunks if c["choices"] and c["choices"][0]["finish_reason"]]
    if len(finals) != 1 or finals[0]["choices"][0]["finish_reason"] not in ("length", "stop"):
        fail(f"{name}: expected one final chunk with finish_reason length/stop")
    return chunks


def phase_serve(model: str, num_layers: int, kv_cache_dtype=None) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = f"_{kv_cache_dtype}" if kv_cache_dtype else ""
    log_path = os.path.join(OUT_DIR, f"chip_smoke_server{suffix}.log")
    cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", "--model", model,
           "--random-weights", "--device", "cuda", "--host", "127.0.0.1",
           "--port", str(port)]
    if kv_cache_dtype:
        cmd += ["--kv-cache-dtype", kv_cache_dtype]
    say(f"serve: {' '.join(cmd[1:])}")
    t_start = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            return _drive_server(proc, base, model, num_layers, t_start, kv_cache_dtype)
        except SystemExit:
            logf.flush()
            with open(log_path) as f:
                say("server log (tail):\n" + "".join(f.readlines()[-40:]))
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def _drive_server(proc, base: str, model: str, num_layers: int, t_start: float,
                  kv_cache_dtype=None) -> dict:
    deadline = time.perf_counter() + 420
    while True:
        if proc.poll() is not None:
            fail(f"server exited with {proc.returncode} before /health answered")
        try:
            status, body = http("GET", base + "/health", timeout=5)
            if status == 200 and body == b"OK":
                break
        except OSError:
            pass
        if time.perf_counter() > deadline:
            fail("server did not answer /health within 420 s")
        time.sleep(1.0)
    say(f"  /health OK after {time.perf_counter() - t_start:.1f} s")
    status, body = http("GET", base + "/v1/models")
    if status != 200 or json.loads(body)["data"][0]["id"] != model:
        fail(f"/v1/models: {status} {body[:200]!r}")

    max_tokens = 32
    text = ("The quick brown fox jumps over the lazy dog while the engine serves "
            "requests on the card. ") * 12
    jobs = {
        "completion greedy 40-token prompt": ("/v1/completions", {
            "model": model, "prompt": text[:40], "max_tokens": max_tokens, "temperature": 0}),
        "completion seeded t=0.8 200-token prompt": ("/v1/completions", {
            "model": model, "prompt": text[:200], "max_tokens": max_tokens,
            "temperature": 0.8, "seed": 1234}),
        "completion greedy 900-token prompt": ("/v1/completions", {
            "model": model, "prompt": (text * 2)[:900], "max_tokens": max_tokens,
            "temperature": 0}),
        "chat streamed": ("/v1/chat/completions", {
            "model": model, "messages": [{"role": "user", "content": text[:150]}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}}),
    }
    status, _ = http("POST", base + "/debug/kernels/reset", {})
    if status != 200:
        fail("/debug/kernels/reset failed")
    results: dict = {}

    def run(name, path, body):
        try:
            if body.get("stream"):
                results[name] = ("stream",) + stream(base + path, body)
            else:
                results[name] = ("full",) + http("POST", base + path, body)
        except Exception as e:  # reported below as this request's failure
            results[name] = ("error", repr(e))

    threads = [threading.Thread(target=run, args=(n, p, b)) for n, (p, b) in jobs.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t0
    status, body = http("GET", base + "/debug/kernels")
    counts = json.loads(body)
    for name in jobs:
        res = results.get(name)
        if res is None or res[0] == "error":
            fail(f"{name}: {res}")
        if res[0] == "full":
            _, status, raw = res
            if status != 200:
                fail(f"{name}: HTTP {status} {raw[:300]!r}")
            data = json.loads(raw)
            ch = data["choices"][0]
            if ch["finish_reason"] not in ("length", "stop") or not isinstance(ch["text"], str):
                fail(f"{name}: bad choice {ch}")
            n = data["usage"]["completion_tokens"]
            if not (n == max_tokens or (ch["finish_reason"] == "stop" and 0 < n <= max_tokens)):
                fail(f"{name}: completion_tokens={n}, finish_reason={ch['finish_reason']}")
            say(f"  {name}: 200, {n} tokens, finish_reason={ch['finish_reason']}")
        else:
            _, status, events, _t0 = res
            chunks = check_stream(name, status, events, max_tokens)
            if chunks[0]["choices"][0]["delta"].get("role") != "assistant":
                fail(f"{name}: first chunk carries no assistant role")
            usage = chunks[-1].get("usage") or {}
            n = usage.get("completion_tokens")
            reason = [c for c in chunks if c["choices"] and
                      c["choices"][0]["finish_reason"]][0]["choices"][0]["finish_reason"]
            if not (n == max_tokens or (reason == "stop" and n and n <= max_tokens)):
                fail(f"{name}: completion_tokens={n}, finish_reason={reason}")
            say(f"  {name}: 200, {len(chunks)} chunks ending in [DONE], {n} tokens, "
                f"finish_reason={reason}")
    launches = counts["launches"]
    say(f"  kernel launches over the burst: {launches}; prefill calls "
        f"{counts['prefill_calls']}, decode forwards {counts['decode_forwards']}, "
        f"layers {num_layers}; burst wall {burst_s:.2f} s")
    if counts["prefill_calls"] < 1 or counts["decode_forwards"] < 1:
        fail("the burst ran no prefill or no decode")
    if launches.get("flash_prefill", 0) < num_layers * counts["prefill_calls"]:
        fail("flash_prefill launched fewer than num_layers times per prefill call")
    decode_kernel = "paged_decode_int8" if kv_cache_dtype else "paged_decode"
    if launches.get(decode_kernel, 0) < num_layers * counts["decode_forwards"]:
        fail(f"{decode_kernel} launched fewer than num_layers times per decode step")
    if kv_cache_dtype and launches.get("paged_decode", 0):
        fail("the int8 KV server launched the float decode kernel")

    # TTFT and decode rate: 8 concurrent greedy streams (one per slot); TTFT
    # is the first token's chunk (the server sends one per first token even
    # when its text is empty), decode rate the tokens after it over the span
    # from the first of those chunks to the last
    n_dec = 64
    per: list = []

    def one(i):
        body = {"model": model, "prompt": text[i:i + 40], "max_tokens": n_dec,
                "temperature": 0, "stream": True, "stream_options": {"include_usage": True}}
        per.append(stream(base + "/v1/completions", body))

    ths = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=600)
    if len(per) != 8:
        fail("decode-rate streams did not all finish")
    ttft, firsts, lasts, toks = [], [], [], 0
    for status, events, t0 in per:
        chunks = check_stream("decode-rate stream", status, events, n_dec)
        ttft.append(events[0][0] - t0)
        firsts.append(events[0][0])
        # the chunk that carries the finish reason follows the last token
        lasts.append(next(t for (t, _), c in zip(events, chunks)
                          if c["choices"] and c["choices"][0]["finish_reason"]))
        toks += chunks[-1]["usage"]["completion_tokens"] - 1
    decode_tps = toks / (max(lasts) - min(firsts))
    card = card_line()
    kv = f", {kv_cache_dtype} KV" if kv_cache_dtype else ""
    say(f"TTFT (8 concurrent 40-token prompts, median{kv}) ms: "
        f"{1e3 * float(np.median(ttft)):.1f} [{card}]")
    say(f"decode tokens/s (8 concurrent streams of {n_dec} tokens, {model} bf16{kv}): "
        f"{decode_tps:.1f} [{card}]")
    return {"launches": launches, "ttft_ms": 1e3 * float(np.median(ttft)),
            "decode_tps": decode_tps}


# ---------------------------------------------------------------------------
# phase 4: kv_write="fused" in process
# ---------------------------------------------------------------------------

def phase_fused(torch, model: str, params, kv_cache_dtype=None) -> dict:
    """kv_write "fused" against "dus" on ``params``, with the KV pool in
    bf16 (kv_cache_dtype None) or int8. Each engine is freed before the
    next one starts."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_decode

    cfg = get_config(model)
    int8 = kv_cache_dtype == "int8"
    write_kernel = "paged_decode_write_int8" if int8 else "paged_decode_write"
    unfused = "paged_decode_int8" if int8 else "paged_decode"
    tag = f"fused ({kv_cache_dtype or 'bf16'} KV)"
    kw = dict(model=model, kv_cache_dtype=kv_cache_dtype, device="cuda")
    fused = Engine(EngineConfig(kv_write="fused", **kw), params=params)
    prompts = [[1 + i % 200 for i in range(40)], [7 + i % 200 for i in range(200)], [5] * 900]
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    kernels.reset_launches()
    reqs = [fused.submit(p, sp) for p in prompts]
    while fused.has_work():
        fused.step()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say(f"{tag}: engine launches: {launches}; decode forwards {fused.decode_forwards}")
    if launches.get(write_kernel, 0) < cfg.num_layers * fused.decode_forwards:
        fail(f"{write_kernel} launched fewer than num_layers times per decode step")
    for other in ("paged_decode", "paged_decode_write", "paged_decode_int8",
                  "paged_decode_write_int8"):
        if other != write_kernel and launches.get(other, 0):
            fail(f"the {tag} engine launched {other}")
    if any(r.finish_reason not in ("length", "stop") for r in reqs):
        fail(f"{tag} engine finish reasons {[r.finish_reason for r in reqs]}")
    streams = [r.output for r in reqs]
    del fused, reqs
    torch.cuda.empty_cache()

    dus = Engine(EngineConfig(kv_write="dus", **kw), params=params)
    ref = [dus.generate(p, sp) for p in prompts]
    if streams != ref:
        fail(f"{tag}: greedy streams differ between kv_write fused and dus: {streams} vs {ref}")
    say(f"  {tag}: greedy streams equal under kv_write fused and dus")

    # one decode step both ways from copies of one pool: prefill three
    # prompts, then decode their first tokens
    B = dus.config.max_decode_slots
    rows = [dus.submit(p, SamplingParams(max_tokens=2, temperature=0.0)) for p in prompts]
    dus._admit()
    tokens = torch.zeros(B, dtype=torch.int32, device="cuda")
    lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
    for r in rows:
        tokens[r.slot] = r.pending_token
        lengths[r.slot] = len(r.prompt) + 1
    table = torch.from_numpy(dus.allocator.page_tables).cuda()
    pools, logits = {}, {}
    for mode in ("dus", "fused"):
        kp, vp = (KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
                  for p in (dus.k_pages, dus.v_pages))
        logits[mode], _, _ = forward_decode(params, cfg, tokens, lengths, kp, vp, table,
                                            kv_write=mode)
        pools[mode] = [t for p in (kp, vp) for t in (p.data, p.scale) if t is not None]
    check_close(f"{tag}: one decode step, logits fused vs dus", logits["fused"],
                logits["dus"], "bfloat16", rows=lengths > 0)
    if int8 and not torch.equal(logits["fused"], logits["dus"]):
        fail(f"{tag}: logits of one decode step differ between fused and dus")
    P = dus.config.num_pages
    keep = torch.ones(cfg.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False          # each layer's trash page; dus writes idle rows there
    for a, b in zip(pools["dus"], pools["fused"]):
        if not torch.equal(a[:, keep], b[:, keep]):
            fail(f"{tag}: pools differ between kv_write dus and fused after one decode step")
    say(f"  {tag}: pools byte-equal outside the trash pages"
        + (" (int8 data and scales); logits identical" if int8 else ""))
    for r in rows:
        dus.abort(r)
    dus.step()
    del dus, pools
    torch.cuda.empty_cache()
    return {"launches": launches}


def phase_in_process(torch, model: str) -> dict:
    """Phase 4 with bf16 and with int8 KV, on one set of random weights."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    t0 = time.perf_counter()
    params = init_params(get_config(model), seed=0, dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    say(f"fused: {model} random weights (seed 0) in {time.perf_counter() - t0:.1f} s")
    out = {kv: phase_fused(torch, model, params, kv) for kv in (None, "int8")}
    del params
    torch.cuda.empty_cache()
    return out


def phase_reference(torch) -> None:
    """The model on a small input against a reference: debug-tiny in
    float32, the same weights on the card (kernels) and on the CPU (plain
    versions). Prefill logits within 1e-4 (summation order only), and the
    engines' greedy streams identical, kv_write dus and fused."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_prefill, init_params

    cfg = get_config("debug-tiny")
    cpu_params = init_params(cfg, seed=0, dtype="float32", device="cpu")

    def on(dev):
        return {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                    else v.to(dev)) for k, v in cpu_params.items()}

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 32)).astype(np.int32))
    lengths = torch.tensor([32, 17, 5], dtype=torch.int32)
    table = torch.arange(1, 3 * 8 + 1, dtype=torch.int32).reshape(3, 8)
    logits = {}
    for dev in ("cpu", "cuda"):
        cc = CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_pages=32,
                         page_size=4, pages_per_slot=8, dtype="float32")
        k, v = init_pages(cc, device=dev)
        logits[dev] = forward_prefill(on(dev), cfg, tokens.to(dev), lengths.to(dev), k, v,
                                      table.to(dev))[0].cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    say(f"reference: debug-tiny f32 prefill logits, card vs CPU: max_abs_err={err:.3e} "
        f"tol={F32_TOL:.0e}")
    if not err <= F32_TOL:
        fail("debug-tiny prefill logits on the card differ from the CPU reference")
    kw = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
              num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
    prompts = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [11] * 30, [100, 42, 5, 1, 9]]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    for kv_dtype in (None, "int8"):
        streams = {}
        for dev, kv_write in (("cpu", "dus"), ("cuda", "dus"), ("cuda", "fused")):
            eng = Engine(EngineConfig(**kw, device=dev, kv_write=kv_write,
                                      kv_cache_dtype=kv_dtype), params=on(dev))
            reqs = [eng.submit(p, sp) for p in prompts]
            while eng.has_work():
                eng.step()
            streams[(dev, kv_write)] = [r.output for r in reqs]
        kv = f"{kv_dtype or 'f32'} KV"
        if not streams[("cuda", "dus")] == streams[("cuda", "fused")] == streams[("cpu", "dus")]:
            fail(f"debug-tiny {kv}: greedy streams differ between the card and the CPU: "
                 f"{streams}")
        say(f"reference: debug-tiny {kv} greedy streams equal on the card (dus, fused) and "
            f"the CPU")


def phase_profile(torch, model: str = MODEL) -> None:
    """Where a decode window's time goes: eight greedy requests in decode,
    one window timed on the host clock, then one under torch.profiler;
    prints the top operators by device time and by host time."""
    from torch.profiler import ProfilerActivity, profile

    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams

    eng = Engine(EngineConfig(model=model, device="cuda"))
    for i in range(eng.config.max_decode_slots):
        eng.submit([1 + (i * 7 + j) % 200 for j in range(40)],
                   SamplingParams(max_tokens=64, temperature=0.0))
    eng.step()                                   # prefill + first window
    torch.cuda.synchronize()
    for _ in range(2):
        t0 = time.perf_counter()
        eng._decode()
        torch.cuda.synchronize()
        say(f"profile: decode window ({eng.config.decode_steps} steps, "
            f"{eng.config.max_decode_slots} slots) wall {1e3 * (time.perf_counter() - t0):.1f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng._decode()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # the device's own events only, as the table's "Self CUDA time total"
    # sums them: a CPU operator's entry repeats its kernels' time
    dev_total = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    say(f"profile: device time in the window {dev_total / 1e3:.2f} ms")
    say(ka.table(sort_by="self_cuda_time_total", row_limit=18))
    say(ka.table(sort_by="self_cpu_time_total", row_limit=12))


# ---------------------------------------------------------------------------

def main(argv) -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    try:
        from llms_on_kubernetes_tpu_torch import kernels
        from llms_on_kubernetes_tpu_torch.configs import get_config
    except ImportError as e:
        fail(f"run from the root of a checkout: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    if "jax" in sys.modules:
        fail("the port imported jax")
    t_all = time.perf_counter()
    card = card_line()
    say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.build()
    say(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(kernels.SOURCES)}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for name, out in kernels.build_log.items():
            f.write(f"== {name}\n{out}\n")
    for name, out in kernels.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    entries = phase_kernels(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if "--profile" in argv:
        phase_profile(torch)
        fail("--profile: profile only, no result")
    if "--kernels-only" in argv:
        say(json.dumps({"kernels": list(entries.values())}))
        fail("--kernels-only: phases 3 and 4 skipped, no result")
    phase_reference(torch)
    num_layers = get_config(MODEL).num_layers
    served = phase_serve(MODEL, num_layers)
    served_int8 = phase_serve(MODEL, num_layers, kv_cache_dtype="int8")
    fused = phase_in_process(torch, MODEL)
    entries["flash_prefill"]["launches"] = served["launches"].get("flash_prefill", 0)
    entries["paged_decode"]["launches"] = served["launches"].get("paged_decode", 0)
    entries["paged_decode_int8"]["launches"] = served_int8["launches"].get(
        "paged_decode_int8", 0)
    for kv, name in ((None, "paged_decode_write"), ("int8", "paged_decode_write_int8")):
        entries[name]["launches"] = fused[kv]["launches"].get(name, 0)
    for e in entries.values():
        if not e["launches"]:
            fail(f"{e['name']} was never launched on its path")
    say(f"total: {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": list(entries.values())}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
