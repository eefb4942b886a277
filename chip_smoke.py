#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llms_on_kubernetes_tpu_torch``) on one
NVIDIA GPU and check it end to end. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``csrc/`` (one nvcc per source,
   in parallel) and print the build seconds and the card's name and power
   limit; count the HMMA (tensor-core) instructions in the SASS of the
   bf16 flash prefill body (``cuobjdump -sass``) and fail if it has none;
2. kernels: hold each kernel against its plain PyTorch version on the card
   -- the small shapes of tests/test_pallas.py and tests/test_kv_int8.py in
   float32 and full-width llama-3-8b shapes in bfloat16 (int8 pools for
   the int8 kernels) -- and time kernel, plain version, and the library
   yardstick where one PyTorch call computes the same function (flash
   prefill: ``scaled_dot_product_attention``; the float window append: two
   ``index_put_`` stores), beside the timer's floor (a kernel that does
   nothing). Flash prefill is timed at buckets 1,024 (length 900), 2,048
   (length 1,500: phase 4's one-shot prompt) and 256 (length 200); the
   decode kernels at lengths 1..2,048 and at the serve shape (8 slots of
   40-47 keys); the window appends at the chunk path's shapes (the
   engine's own chunk calls for phase 3's prompts, and four slots). The
   window appends must leave the plain version's pool bytes outside the
   trash page 0 and every byte outside the written rows as it was, at the
   span edge cases too (bases mid-page and on a boundary, rows past the
   page table, pages of 16, 64 and 128). Then every kernel again at
   head_dim 96 and 256 (``wide_kernels``): float32 at small shapes (group 1
   and 2, a window, a softcap, pages 64 and 24) and bfloat16 at phi-3-mini's
   widths (32 query heads on 32 KV heads, d 96, window 2,047) and
   gemma-2-9b's (16 on 8, d 256, softcap 50), timed there beside the bound
   (decode at lengths 1..2,500, 48 pages a slot; flash at bucket 1,024,
   length 900, beside sdpa); the window appends also at pages 24 and 100,
   span edges and timed;
3. serve: start ``python -m llms_on_kubernetes_tpu_torch serve --model
   llama-3-8b --random-weights --device cuda`` (the default EngineConfig:
   8 slots, decode_steps 4, kv_write "dus", bf16, prefix caching on) and
   send concurrent completions and a streamed chat with prompts in each
   prefill bucket and one of 1,500 tokens (two chunks), then the 900-token
   prompt again with a tail (a prefix-cache hit of 896 tokens, prefilled
   through the chunk path); the kernel launch counters are zeroed just
   before and read just after. Held: every window-kernel launch count is
   num_layers x the chunk calls (and >= 96), the re-sent prompt adopts
   >= 896 tokens. Then the same again with ``--kv-cache-dtype int8`` (the
   int8 decode and window kernels, and never the float ones, on every
   layer). Before it, a reference check on a small input: debug-tiny in
   float32 on the card against the same weights on the CPU (prefill logits
   within 1e-4; greedy streams identical, float and int8 KV, with a
   chunked prompt and a second pass of cache hits), then the same at page
   24 for debug-tiny cut to head_dim 96 and debug-gemma cut to 256 (made
   here with dataclasses.replace, not registered);
4. fused: in this process, the same random weights behind an Engine with
   kv_write "fused", first with bf16 KV, then with int8 KV: requests
   through it (counters zeroed before, read after), the same greedy
   streams as kv_write "dus", and one decode step both ways from copies of
   one pool (bf16 logits within the bf16 tolerance, int8 logits identical;
   pools byte-equal outside the trash pages, int8 scales included). Last,
   printed and not held: a 1,500-token prompt's first-token logits chunked
   (bucket 1,024) against one-shot (bucket 2,048);
5. checkpoint: write full-width phi-3-mini (head_dim 96, 3.82 B
   parameters, 7.64 GB in bf16) as a HuggingFace safetensors checkpoint
   under ``smoke_out/`` with ``testing/synth_checkpoint.py`` (failing when
   the disk lacks the room), drop it from the page cache, load it in this
   process and hold layers 0 and 31 (the fused qkv_proj and gate_up_proj
   split), the embedding, the final norm and the head bit for bit to what
   was written; then serve it as a user would, ``python -m
   llms_on_kubernetes_tpu_torch serve --model <dir> --pages-per-slot 48``,
   with prompts in each bucket, a 1,500-token prompt (chunked) and its
   cache hit, a 2,500-token prompt past the 2,047-token sliding window and
   a chat, counters zeroed before and read after: flash prefill, the
   decode kernel and the window kernel each launch num_layers times their
   calls, and no other kernel runs; then the same with
   ``--kv-cache-dtype int8`` (kernels 1, 4 and 7). Prints the load
   seconds, cold (in process) and warm (in the server), the time to
   /health and the phase's seconds.

``--profile`` stops after phase 2 and traces, under torch.profiler, one
decode window of eight requests and one chunk call (the second chunk of a
1,500-token prompt, padded to its bucket and unpadded), with the pool of
``LLMK_KV_DTYPE`` (bf16 or int8); ``--kernels-only`` stops after phase 2.

The line before the last is the card's name and power limit as nvidia-smi
gives them; before it, one ``{"kernels": [...]}`` JSON line, whose
``launches`` come from phase 5's servers (kernels 1, 2, 4, 6, 7) and
phase 4's fused engines (3, 5), and ``launches_by_path`` from every path. The last line
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
import shutil
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
# phase 3's prompt texts (the byte tokenizer: one token a character)
SERVE_TEXT = ("The quick brown fox jumps over the lazy dog while the engine serves "
              "requests on the card. ") * 12
# a text that shares no page with the others: its 1,500 tokens take the
# chunk path in two chunks (largest bucket 1,024), never a cache hit
LONG_TEXT = ("Paged attention reads the cache through a table of pages, and "
             "chunked prefill fills it one bucket at a time. ") * 20
PROMPT_900 = (SERVE_TEXT * 2)[:900]
PROMPT_1500 = LONG_TEXT[:1500]
TAIL_100 = LONG_TEXT[:100]


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
                int8: bool = False, window=None):
    """FLOPs and bytes one decode attention call needs: each active query
    row attends its slot's keys (the last ``window`` of them under a
    sliding window); q read, out written, each attended K/V row read once
    (d * elt bytes a row and side, or d + 4 for an int8 row and its
    scale); the fused kernel also reads k_new/v_new (q's dtype) and writes
    one row per side per active slot."""
    B = len(lengths)
    keys = int(sum(min(int(n), window) if window else int(n) for n in lengths))
    active = sum(1 for n in lengths if n > 0)
    row = d + 4 if int8 else d * elt
    flops = 4.0 * d * n_q * keys
    cached = keys - (active if write else 0)
    nbytes = 2 * B * n_q * d * elt + 2 * cached * n_kv * row + 4 * B * (pps + 1)
    if write:
        nbytes += 2 * B * n_kv * d * elt + 2 * active * n_kv * row
    return flops, nbytes


# the decode kernels' two timed shapes: 8 slots of llama-3-8b (32 query / 8
# KV heads, d 128, page 64, 32 pages a slot) at lengths over 1..2,048, and
# the serve shape: 8 slots ~40 tokens in, the decode window that
# --profile traces
DEC_SHAPE = "B8 n_q32 n_kv8 d128 page64 lengths 1,63,64,65,700,1500,2048,0 bf16"
SERVE_SHAPE = "B8 n_q32 n_kv8 d128 page64 lengths 40..47 bf16"
SERVE_LENS = np.arange(40, 48)
INT8 = " q, int8 pool"


def decode_timing(timer, kernel, plain, lens, write: bool, int8: bool = False,
                  widths=(32, 8, 128, 32), window=None) -> dict:
    """Time a decode kernel (50 launches: ~0.01 ms each) and its plain
    version; bound_ms from these lengths at ``widths`` (n_q, n_kv, d,
    pages a slot; llama-3-8b's by default)."""
    ms = timer(kernel, reps=50)
    plain_ms = timer(plain)
    n_q, n_kv, d, pps = widths
    b_ms, b_by = bound_ms(*decode_work(lens, n_q, n_kv, d, 2, pps, write=write, int8=int8,
                                       window=window), "bfloat16")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def sass_mma_count(path) -> tuple[int, int]:
    """(mma instructions, functions) in the SASS of the tensor-core flash
    body (kernel names containing flash_prefill_tc) of a built library,
    read with cuobjdump from the CUDA toolkit or Triton's bundled copy."""
    import shutil
    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                                  "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and os.path.exists(t)), None)
    if tool is None:
        fail("cuobjdump not found: cannot check the flash prefill SASS for tensor-core ops")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=120).stdout
    count, funcs, inside = 0, 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "flash_prefill_tc" in line
            funcs += inside
        elif inside and ("HMMA" in line or "HGMMA" in line):
            count += 1
    return count, funcs


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
    # the timer's floor: launch and events around a kernel that does nothing
    tiny = torch.zeros(8, device="cuda")
    say(f"timer floor (one add_ on 8 floats): {timer(lambda: tiny.add_(1), reps=50):.4f} ms "
        f"[{card_line()}]")
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
    for T, n in [(64, 40), (1024, 1024), (77, 77)]:
        q, k, v = qkv(1, T, 32, 8, 128, bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=128 ** -0.5)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        check_close(f"bf16 llama-3-8b B1 T{T} length {n}", out[0, :n], ref[0, :n], "bfloat16")

    def flash_shape(T, n):
        """Check and time bf16 flash prefill at llama-3-8b widths, bucket T,
        one prompt of n tokens, beside its plain version and sdpa over the
        n valid tokens."""
        q, k, v = qkv(1, T, 32, 8, 128, bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=128 ** -0.5)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        err = check_close(f"bf16 llama-3-8b B1 T{T} length {n}", out[0, :n], ref[0, :n],
                          "bfloat16")
        ms = timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw))
        plain = timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, **kw))
        del ref, out
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, kh, vh = (t[:, :n].transpose(1, 2) for t in (q, k, v))
        try:
            sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
            lib = timer(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
        except TypeError:   # a torch without enable_gqa: expand the KV heads first
            kx, vx = kh.repeat_interleave(4, dim=1), vh.repeat_interleave(4, dim=1)
            lib = timer(lambda: sdpa(qh, kx, vx, is_causal=True))
        flops, nbytes = prefill_work([n], 32, 8, 128, 2)
        b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
        say(f"  timing flash_prefill T{T} length {n}: ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={b_ms:.4f} library_ms={lib:.4f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib)

    # the timed shape (a 900-token prompt in bucket 1,024), then phase 4's
    # one-shot 1,500-token prompt (bucket 2,048) and a 200-token prompt
    # (bucket 256)
    main = flash_shape(1024, 900)
    others = {f"B1 T{T} length {n}": flash_shape(T, n) for T, n in [(2048, 1500), (256, 200)]}
    entries["flash_prefill"] = dict(
        name="flash_prefill", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/flash_prefill.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_flash.py:89", **main,
        shape="B1 T1024 length 900 n_q32 n_kv8 d128 bf16",
        other_shapes={s: {k: v for k, v in e.items() if k != "max_abs_err"}
                      for s, e in others.items()})

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
    timed = decode_timing(timer, lambda: pa.paged_decode_attention(
        q, kp, vp, table, lengths, **kw), lambda: pa.paged_decode_attention_plain(
        q, kp, vp, table, lengths, **kw), dec_lens, write=False)
    # the serve shape: the decode window chip_smoke.py --profile traces
    kp, vp, table = paged_setup(torch, rng, 8, 8, 128, 64, 32, SERVE_LENS, bf16, pool_pages=512)
    q = torch.from_numpy(rng.normal(size=(8, 32, 128)).astype(np.float32)).to("cuda", bf16)
    lengths = torch.from_numpy(SERVE_LENS.astype(np.int32)).cuda()
    check_close("bf16 llama-3-8b B8 page64 lengths 40..47", pa.paged_decode_attention(
        q, kp, vp, table, lengths, **kw), pa.paged_decode_attention_plain(
        q, kp, vp, table, lengths, **kw), "bfloat16")
    serve = decode_timing(timer, lambda: pa.paged_decode_attention(
        q, kp, vp, table, lengths, **kw), lambda: pa.paged_decode_attention_plain(
        q, kp, vp, table, lengths, **kw), SERVE_LENS, write=False)
    entries["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:1118",
        max_abs_err=err_dec, **timed, library_ms=None, shape=DEC_SHAPE,
        other_shapes={SERVE_SHAPE: serve},
        library_note="no single PyTorch call computes attention through a page table")

    kp, vp, table, q, kn, vn, lengths, err_w = fused_case(
        "bf16 llama-3-8b B8 page64 lengths 1..2048", dec_lens, 8, 4, 128, 64, 32, bf16,
        pool_pages=512)
    timings = {}
    for shape, lens in ((DEC_SHAPE, dec_lens), (SERVE_SHAPE, SERVE_LENS)):
        if shape == SERVE_SHAPE:
            kp, vp, table, q, kn, vn, lengths, _ = fused_case(
                "bf16 llama-3-8b B8 page64 lengths 40..47", lens, 8, 4, 128, 64, 32, bf16,
                pool_pages=512)
        timings[shape] = decode_timing(timer, lambda: pa.paged_decode_attention_write(
            q, kp, vp, table, lengths, kn, vn, **kw), lambda: pa.paged_decode_attention_write_plain(
            q, kp, vp, table, lengths, kn, vn, **kw), lens, write=True)
    entries["paged_decode_write"] = dict(
        name="paged_decode_write", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:476",
        max_abs_err=err_w, **timings[DEC_SHAPE], library_ms=None, shape=DEC_SHAPE,
        other_shapes={SERVE_SHAPE: timings[SERVE_SHAPE]},
        library_note="no single PyTorch call computes attention through a page table")
    entries.update(int8_kernels(torch, rng, timer, dec_lens))
    entries.update(window_kernels(torch, rng, timer))
    for e in entries.values():
        say(f"  timing {e['name']}: ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} "
            f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']}) library_ms={e['library_ms']}")
        for shape, o in e.get("other_shapes", {}).items():
            say(f"    at {shape}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.4f} "
                f"bound_ms={o['bound_ms']:.4f} library_ms={o.get('library_ms')}")
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
    timings = {}
    for shape, lens in ((DEC_SHAPE, dec_lens), (SERVE_SHAPE, SERVE_LENS)):
        if shape == SERVE_SHAPE:
            pools, table = setup(8, 8, 128, 64, 32, lens, pool_pages=512)
            lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
            check_close("bf16 q, int8 pool, llama-3-8b B8 page64 lengths 40..47",
                        pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw),
                        pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw),
                        "bfloat16")
        timings[shape] = decode_timing(timer, lambda: pa.paged_decode_attention_int8(
            q, *pools, table, lengths, **kw), lambda: pa.paged_decode_attention_int8_plain(
            q, *pools, table, lengths, **kw), lens, write=False, int8=True)
    entries["paged_decode_int8"] = dict(
        name="paged_decode_int8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:264",
        max_abs_err=err, **timings[DEC_SHAPE], library_ms=None, shape=DEC_SHAPE + INT8,
        other_shapes={SERVE_SHAPE + INT8: timings[SERVE_SHAPE]},
        library_note="no single PyTorch call computes attention through a page table")

    timings = {}
    for shape, lens in ((DEC_SHAPE, dec_lens), (SERVE_SHAPE, SERVE_LENS)):
        pools, table, q, kn, vn, lengths, e = fused_case(
            f"bf16 q, int8 pool, llama-3-8b B8 page64 lengths {shape.split('lengths ')[1]}",
            lens, 8, 4, 128, 64, 32, bf16, pool_pages=512)
        err = e if shape == DEC_SHAPE else err
        timings[shape] = decode_timing(timer, lambda: pa.paged_decode_attention_write_int8(
            q, *pools, table, lengths, kn, vn, **kw),
            lambda: pa.paged_decode_attention_write_int8_plain(
                q, *pools, table, lengths, kn, vn, **kw), lens, write=True, int8=True)
    entries["paged_decode_write_int8"] = dict(
        name="paged_decode_write_int8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:874",
        max_abs_err=err, **timings[DEC_SHAPE], library_ms=None, shape=DEC_SHAPE + INT8,
        other_shapes={SERVE_SHAPE + INT8: timings[SERVE_SHAPE]},
        library_note="no single PyTorch call computes attention through a page table")
    return entries


def window_work(widths, n_kv: int, d: int, new_elt: int, int8: bool) -> float:
    """Bytes one windowed append needs: each written row of k_new/v_new
    read once (d * new_elt a KV head and side) and each pool row written
    once (d * new_elt for a float pool, d + 4 for an int8 row and its
    scale). Only rows t < widths[b] count: the rest are neither read nor
    written. No arithmetic to speak of: the bound is bytes."""
    rows = int(sum(widths)) * n_kv * 2
    return rows * (d * new_elt + (d + 4 if int8 else d * new_elt))


def window_case(torch, rng, label, base, widths, W, n_kv, d, page, pps, int8, pool_dtype,
                new_dtype, pool_pages=None):
    """Run the window kernel and its plain version on copies of one random
    pool; fail unless the pool bytes (data and scales) equal the plain
    version's outside the trash page 0 and every byte outside the written
    rows equals the pre-call copy. Returns the arguments for timing:
    (pool tensors, [page_table, base, widths], k_new, v_new)."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    base, widths = np.asarray(base), np.asarray(widths)
    B = len(base)
    P = pool_pages or B * pps + 1
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = min(pps, -(-int(base[b] + W) // page))
        table[b, :used] = perm[b * pps:b * pps + used]
    written = np.zeros((P, page), bool)
    for b in range(B):
        for t in range(int(widths[b])):
            pos = int(base[b]) + t
            if 0 <= pos < pps * page:
                written[table[b, pos // page], pos % page] = True
    if int8:
        mk_d = lambda: torch.from_numpy(
            rng.integers(-127, 128, size=(n_kv, P, page, d)).astype(np.int8)).cuda()
        mk_s = lambda: torch.from_numpy(
            (rng.random(size=(n_kv, P, page)) + 0.1).astype(np.float32)).cuda()
        pool = [mk_d(), mk_s(), mk_d(), mk_s()]
    else:
        mk_p = lambda: torch.from_numpy(
            rng.normal(size=(n_kv, P, page, d)).astype(np.float32)).to("cuda", pool_dtype)
        pool = [mk_p(), mk_p()]
    mk = lambda: torch.from_numpy(
        rng.normal(size=(B, W, n_kv, d)).astype(np.float32)).to("cuda", new_dtype)
    kn, vn = mk(), mk()
    args = [torch.from_numpy(a.astype(np.int32)).cuda() for a in (table, base, widths)]
    before = [t.clone() for t in pool]
    ref = [t.clone() for t in pool]
    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    plain(*ref, *args, kn, vn)
    kernel(*pool, *args, kn, vn)
    torch.cuda.synchronize()
    if not all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pool, ref)):
        fail(f"{label}: pool bytes differ from the plain version's outside page 0")
    keep = torch.from_numpy(~written).cuda()
    if not all(torch.equal(a[:, keep], b[:, keep]) for a, b in zip(pool, before)):
        fail(f"{label}: the kernel changed pool bytes outside the written rows")
    say(f"  {label}: pool bytes equal the plain version's outside page 0; "
        f"{int(written.sum())} rows a KV head written, every other byte untouched")
    return pool, args, kn, vn


def engine_chunk_shapes() -> list[tuple[int, int, int]]:
    """(base, width, bucket W) of every forward_chunk call the default
    EngineConfig (page 64, buckets 64/256/1,024, prefix caching on) makes
    for phase 3's chunked requests, in order: the 1,500-token prompt (two
    chunks), then the 900-token prompt and its re-send with the
    100-character tail (a cache hit; the tail is one chunk). Read from the
    engine itself -- its tokenizer, admission, prefix cache and bucket
    choice -- run on the CPU with debug-tiny weights: the scheduling
    depends on the config and the prompts, not on the model's widths."""
    from llms_on_kubernetes_tpu_torch.engine import engine as em
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import load_tokenizer

    calls = []
    real = em.forward_chunk

    def spy(params, cfg, tokens, history, lengths, *rest):
        calls.append((int(history[0]), int(lengths[0]), int(tokens.shape[1])))
        return real(params, cfg, tokens, history, lengths, *rest)

    tok = load_tokenizer(MODEL)
    eng = em.Engine(em.EngineConfig(model="debug-tiny", dtype="float32", device="cpu"))
    em.forward_chunk = spy
    try:
        for text in (PROMPT_1500, PROMPT_900, PROMPT_900 + TAIL_100):
            eng.generate(tok.encode(text), em.SamplingParams(max_tokens=1, temperature=0.0))
    finally:
        em.forward_chunk = real
    return calls


def window_shapes() -> dict:
    """The windowed append's timed shapes, llama-3-8b widths, the main one
    first: the second chunk of phase 3's 1,500-token prompt; four slots
    starting at 0, a page boundary (896), mid-page (900) and one idle; the
    first chunk of that prompt; the re-sent prompt's tail after its cache
    hit. The single-slot shapes are the engine's own chunk calls."""
    calls = engine_chunk_shapes()
    if len(calls) != 3:
        fail(f"expected the engine to make 3 chunk calls for phase 3's prompts, got {calls}")
    (b0, w0, W0), (b1, w1, W1), (b2, w2, W2) = calls
    one = lambda b, w, W: (f"B1 W{W} base {b} width {w}", dict(base=[b], widths=[w], W=W))
    return dict([one(b1, w1, W1),
                 ("B4 W1024 bases 0,896,900,0 widths 1024,1024,1000,0",
                  dict(base=[0, 896, 900, 0], widths=[1024, 1024, 1000, 0], W=1024)),
                 one(b0, w0, W0), one(b2, w2, W2)])


# the timed window shapes' fixed widths: llama-3-8b (8 KV heads, d 128),
# the default page and a 512-page pool, bf16 rows
WINDOW_FIXED = dict(n_kv=8, d=128, page=64, pps=32, pool_pages=512)


def window_timing(torch, timer, int8: bool, pool, args, kn, vn, W: int, widths,
                  n_kv: int = WINDOW_FIXED["n_kv"], d: int = WINDOW_FIXED["d"],
                  page: int = WINDOW_FIXED["page"]) -> dict:
    """Time the window kernel (100 launches: a few microseconds each), its
    plain version and (float pool) the library yardstick, two index_put_
    stores of the same rows; bound_ms from the written rows."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    ms = timer(lambda: kernel(*pool, *args, kn, vn), reps=100)
    plain_ms = timer(lambda: plain(*pool, *args, kn, vn), reps=100)
    lib = None
    if not int8:
        pid, off = pw._window_index(args[0], args[1], args[2], W, page)
        sel = (args[2].long()[:, None] > torch.arange(W, device="cuda")).reshape(-1)
        pid, off = pid[sel], off[sel]
        kr = kn.reshape(-1, n_kv, d)[sel].transpose(0, 1).contiguous()
        vr = vn.reshape(-1, n_kv, d)[sel].transpose(0, 1).contiguous()
        hix = torch.arange(n_kv, device="cuda")[:, None]
        lib = timer(lambda: (pool[0].index_put_((hix, pid, off), kr),
                             pool[1].index_put_((hix, pid, off), vr)), reps=100)
    b_ms, b_by = bound_ms(0.0, window_work(widths, n_kv, d, 2, int8), "bfloat16")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def window_kernels(torch, rng, timer) -> dict:
    """Phase 2 for the windowed KV append (the chunk path's write):
    paged_write_window (float pools) and paged_write_window_int8 against
    their plain versions (``window_case``) at the tests' small shapes, the
    span edge cases and the full-width shapes, then timed at the latter."""
    f32, bf16 = torch.float32, torch.bfloat16
    entries = {}
    case = lambda label, **kw: window_case(torch, rng, label, **kw)

    say("kernel paged_write_window (replaces ops/pallas_paged.py::pallas_paged_write_window)")
    say("kernel paged_write_window_int8 (replaces "
        "ops/pallas_paged.py::pallas_paged_write_window_int8)")
    # tests/test_pallas.py:261 and tests/test_kv_int8.py:168, float32 rows
    small = dict(base=[7, 8, 0, 15, 3], widths=[4, 3, 4, 2, 0], W=4, n_kv=2, d=8, page=8,
                 pps=4)
    case("f32 pool, test_pallas shape", int8=False, pool_dtype=f32, new_dtype=f32, **small)
    case("bf16 pool, test_pallas shape", int8=False, pool_dtype=bf16, new_dtype=bf16, **small)
    case("int8 pool, f32 rows, test_kv_int8 shape", int8=True, pool_dtype=None,
         new_dtype=f32, **small)
    case("int8 pool, bf16 rows, d 128 page 16", base=[0, 16, 5, 40], widths=[20, 16, 1, 0],
         W=20, n_kv=2, d=128, page=16, pps=4, int8=True, pool_dtype=None, new_dtype=bf16)
    # spans: a base mid-page and on a boundary, W below a page, rows past
    # the page table, and a page of 128 (two spans a page)
    for page, W in ((16, 40), (64, 50), (128, 200)):
        edge = dict(base=[page // 2 + 1, page, 0, 3 * page - 5], widths=[W, W - 1, 0, W],
                    W=W, n_kv=2, d=64, page=page, pps=3)
        for int8, pool_dtype, new_dtype in ((False, f32, f32), (False, bf16, bf16),
                                            (True, None, f32), (True, None, bf16)):
            case(f"{'int8' if int8 else pool_dtype} pool, {new_dtype} rows, span edges "
                 f"page {page} W {W}", int8=int8, pool_dtype=pool_dtype, new_dtype=new_dtype,
                 **edge)
    shapes = window_shapes()
    for int8, name in ((False, "paged_write_window"), (True, "paged_write_window_int8")):
        times = {}
        for shape, kw in shapes.items():
            pool, args, kn, vn = case(f"{'int8' if int8 else 'bf16'} pool, bf16 rows, {shape}",
                                      int8=int8, pool_dtype=bf16, new_dtype=bf16, **kw,
                                      **WINDOW_FIXED)
            t = window_timing(torch, timer, int8, pool, args, kn, vn, kw["W"], kw["widths"])
            times[shape] = t
            say(f"  timing {name} {shape}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.5f} library_ms={t['library_ms']}")
        main_shape = next(iter(shapes))
        entries[name] = dict(
            name=name, route="cuda",
            source="llms_on_kubernetes_tpu_torch/csrc/paged_write_window.cu",
            replaces=("llms_on_kubernetes_tpu/ops/pallas_paged.py:1045" if int8
                      else "llms_on_kubernetes_tpu/ops/pallas_paged.py:612"),
            max_abs_err=0.0, **times[main_shape],
            shape=f"{main_shape} n_kv8 d128 page64 bf16 rows, "
                  f"{'int8' if int8 else 'bf16'} pool",
            other_shapes={s: t for s, t in times.items() if s != main_shape})
        if int8:
            entries[name]["library_note"] = ("no single PyTorch call quantizes and stores: "
                                             "quantize_kv alone is several calls")
    return entries


# ---------------------------------------------------------------------------
# phase 2, head_dim 96 and 256: every kernel at phi-3-mini's and gemma-2-9b's
# widths
# ---------------------------------------------------------------------------

# phi-3-mini: 32 query heads on 32 KV heads (group 1), d 96, window 2047;
# gemma-2-9b: 16 on 8, d 256, attention softcap 50 (its window, 4096, lies
# past every length here). Pages a slot: 48 (3,072 tokens: phase 5's
# --pages-per-slot), lengths past phi-3's window.
WIDE = {96: dict(model="phi-3-mini", n_q=32, n_kv=32, window=2047, cap=None),
        256: dict(model="gemma-2-9b", n_q=16, n_kv=8, window=4096, cap=50.0)}
WIDE_LENS = np.array([1, 63, 64, 65, 700, 1500, 2500, 0])
WIDE_PPS = 48


def wide_kernels(torch, rng, timer) -> dict:
    """Phase 2 at head_dim 96 and 256: each of the seven kernels against
    its plain version, float32 at small shapes (1e-4, group 1 and 2, a
    window, a softcap) and bfloat16 at the two models' full widths (the row
    tolerance), then timed at the full widths beside its bound (and
    scaled_dot_product_attention for kernel 1); the window kernels also at
    pages 24 and 100, which their spans cut by in-page offset. Returns
    {kernel name: {shape: timing}} for the kernel table's other shapes."""
    from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
    from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    f32, bf16 = torch.float32, torch.bfloat16
    out: dict = {}

    def mk(*shape, dtype=f32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)

    for d, w in WIDE.items():
        n_q, n_kv, window, cap = w["n_q"], w["n_kv"], w["window"], w["cap"]
        group = n_q // n_kv
        tag = f"{w['model']} n_q{n_q} n_kv{n_kv} d{d}"
        say(f"head_dim {d} ({tag}): every kernel against its plain version")
        # -- kernel 1 ----------------------------------------------------------
        for win, c in [(None, None), (37, None), (None, cap or 30.0)]:
            q, k, v = mk(2, 200, 2 * group, d), mk(2, 200, 2, d), mk(2, 200, 2, d)
            lengths = torch.tensor([200, 77], dtype=torch.int32, device="cuda")
            kw = dict(scale=d ** -0.5, sliding_window=win, attn_softcap=c)
            ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
            got = fa.flash_prefill_attention(q, k, v, lengths, **kw)
            check_close(f"flash f32 d{d} group {group} T200 window={win} softcap={c}",
                        got[0], ref[0], "float32")
            check_close(f"flash f32 d{d} group {group} T200 row1", got[1, :77], ref[1, :77],
                        "float32")
        T, n = 1024, 900
        q, k, v = mk(1, T, n_q, d, dtype=bf16), mk(1, T, n_kv, d, dtype=bf16), \
            mk(1, T, n_kv, d, dtype=bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        err = check_close(f"flash bf16 {tag} B1 T{T} length {n}", fa.flash_prefill_attention(
            q, k, v, lengths, **kw)[0, :n], ref[0, :n], "bfloat16")
        del ref
        ms = timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw))
        plain = timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, **kw))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, kh, vh = (t[:, :n].transpose(1, 2) for t in (q, k, v))
        kx, vx = (kh, vh) if group == 1 else (kh.repeat_interleave(group, 1),
                                               vh.repeat_interleave(group, 1))
        lib = timer(lambda: sdpa(qh, kx, vx, is_causal=True, scale=d ** -0.5))
        b_ms, b_by = bound_ms(*prefill_work([n], n_q, n_kv, d, 2, window), "bfloat16")
        out.setdefault("flash_prefill", {})[f"{tag} B1 T{T} length {n} bf16"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib, library_note="sdpa causal over the valid tokens"
            + (" without the softcap (sdpa has none)" if cap else ""))
        # -- kernels 2-5 ---------------------------------------------------------
        for lens, nkv, page, pps, dtype, win, c, label in (
                ([300, 37, 0, 700], 2, 64, 12, f32, 300, None, "f32 window 300"),
                ([300, 37, 0, 700], 2, 24, 30, f32, None, cap or 30.0, "f32 page 24"),
                (WIDE_LENS, n_kv, 64, WIDE_PPS, bf16, window, cap, f"bf16 {tag} B8")):
            lens = np.asarray(lens)
            B = len(lens)
            kp, vp, table = paged_setup(torch, rng, B, nkv, d, page, pps, lens, f32,
                                        pool_pages=B * pps + 1)
            q = mk(B, nkv * group, d, dtype=dtype)
            kn, vn = mk(B, nkv, d, dtype=dtype), mk(B, nkv, d, dtype=dtype)
            lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
            kw = dict(scale=d ** -0.5, sliding_window=win, attn_softcap=c)
            act = torch.from_numpy(lens > 0).cuda()
            for int8 in (False, True):
                base_pools = [*quantize_kv(kp), *quantize_kv(vp)] if int8 else \
                    [kp.to(dtype), vp.to(dtype)]
                for fused in (False, True):
                    name = "paged_decode" + ("_write" if fused else "") + ("_int8" if int8 else "")
                    pools = [t.clone() for t in base_pools]
                    if fused:
                        kern = (pa.paged_decode_attention_write_int8 if int8
                                else pa.paged_decode_attention_write)
                        plain_fn = (pa.paged_decode_attention_write_int8_plain if int8
                                    else pa.paged_decode_attention_write_plain)
                        ref_pools = [t.clone() for t in pools]
                        ref = plain_fn(q, *ref_pools, table, lengths, kn, vn, **kw)
                        got = kern(q, *pools, table, lengths, kn, vn, **kw)
                        if not all(torch.equal(a[:, 1:], b[:, 1:])
                                   for a, b in zip(pools, ref_pools)):
                            fail(f"{name} {label}: pool bytes differ from write_tokens'")
                        del ref_pools
                        run = lambda: kern(q, *pools, table, lengths, kn, vn, **kw)
                        run_plain = lambda: plain_fn(q, *pools, table, lengths, kn, vn, **kw)
                    else:
                        kern = pa.paged_decode_attention_int8 if int8 else pa.paged_decode_attention
                        plain_fn = (pa.paged_decode_attention_int8_plain if int8
                                    else pa.paged_decode_attention_plain)
                        ref = plain_fn(q, *pools, table, lengths, **kw)
                        got = kern(q, *pools, table, lengths, **kw)
                        run = lambda: kern(q, *pools, table, lengths, **kw)
                        run_plain = lambda: plain_fn(q, *pools, table, lengths, **kw)
                    err = check_close(f"{name} {label}" + (" int8 pool" if int8 else ""),
                                      got, ref, "float32" if dtype == f32 else "bfloat16",
                                      rows=act)
                    if dtype == bf16:
                        t = decode_timing(timer, run, run_plain, lens, write=fused, int8=int8,
                                          widths=(n_q, n_kv, d, pps), window=win)
                        out.setdefault(name, {})[
                            f"{label} page64 lengths 1..2500" + (INT8 if int8 else "")] = dict(
                            max_abs_err=err, **t, library_ms=None)
                    del pools, ref, got
                del base_pools
            del kp, vp
        # -- kernels 6-7 -------------------------------------------------------
        for int8, name in ((False, "paged_write_window"), (True, "paged_write_window_int8")):
            for page in (24, 100):
                for W in (page - 3, 2 * page + 5):
                    edge = dict(base=[page // 2 + 1, page, 0, 3 * page - 5],
                                widths=[W, W - 1, 0, W], W=W, n_kv=2, d=d, page=page, pps=4)
                    for pool_dtype, new_dtype in ((None, f32), (None, bf16)) if int8 else \
                            ((f32, f32), (bf16, bf16)):
                        window_case(torch, rng, f"{name} d{d} page {page} W {W} "
                                    f"{new_dtype} rows", int8=int8, pool_dtype=pool_dtype,
                                    new_dtype=new_dtype, **edge)
            for page, pps in ((64, WIDE_PPS), (24, 128), (100, 31)):
                shape = dict(base=[1024], widths=[476], W=1024)
                pool, args, kn, vn = window_case(
                    torch, rng, f"{name} {tag} page {page} B1 W1024 base 1024 width 476",
                    int8=int8, pool_dtype=bf16, new_dtype=bf16, n_kv=n_kv, d=d, page=page,
                    pps=pps, pool_pages=pps + 1, **shape)
                t = window_timing(torch, timer, int8, pool, args, kn, vn, 1024, [476],
                                  n_kv=n_kv, d=d, page=page)
                out.setdefault(name, {})[
                    f"{tag} page {page} B1 W1024 base 1024 width 476 bf16 rows"] = dict(
                    max_abs_err=0.0, **t)
                del pool, args, kn, vn
        torch.cuda.empty_cache()
    for name, shapes in out.items():
        for shape, t in shapes.items():
            say(f"  timing {name} {shape}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) library_ms={t['library_ms']}")
    return out


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


def with_server(args: list, log_name: str, drive) -> dict:
    """Start ``python -m llms_on_kubernetes_tpu_torch serve ARGS`` on the
    card and a free port, its output in ``OUT_DIR/log_name``; wait for
    /health (at most 420 s), then return ``drive(base URL)`` with
    ``health_s``, the seconds to /health, added. The server is stopped
    however this ends; a failure prints the tail of its log."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, log_name)
    cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", *args,
           "--device", "cuda", "--host", "127.0.0.1", "--port", str(port)]
    say(f"serve: {' '.join(cmd[1:])}")
    t_start = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            deadline = t_start + 420
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
                time.sleep(0.5)
            health_s = time.perf_counter() - t_start
            say(f"  /health OK after {health_s:.1f} s")
            return {**drive(base), "health_s": health_s}
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


def phase_serve(model: str, num_layers: int, kv_cache_dtype=None) -> dict:
    kv = ["--kv-cache-dtype", kv_cache_dtype] if kv_cache_dtype else []
    return with_server(["--model", model, "--random-weights", *kv],
                       f"chip_smoke_server{'_' + kv_cache_dtype if kv_cache_dtype else ''}.log",
                       lambda base: _drive_server(base, model, num_layers, kv_cache_dtype))


def _drive_server(base: str, model: str, num_layers: int, kv_cache_dtype=None) -> dict:
    status, body = http("GET", base + "/v1/models")
    if status != 200 or json.loads(body)["data"][0]["id"] != model:
        fail(f"/v1/models: {status} {body[:200]!r}")

    max_tokens = 32
    text = SERVE_TEXT
    jobs = {
        "completion greedy 40-token prompt": ("/v1/completions", {
            "model": model, "prompt": text[:40], "max_tokens": max_tokens, "temperature": 0}),
        "completion seeded t=0.8 200-token prompt": ("/v1/completions", {
            "model": model, "prompt": text[:200], "max_tokens": max_tokens,
            "temperature": 0.8, "seed": 1234}),
        "completion greedy 900-token prompt": ("/v1/completions", {
            "model": model, "prompt": PROMPT_900, "max_tokens": max_tokens,
            "temperature": 0}),
        "completion greedy 1500-token prompt (2 chunks)": ("/v1/completions", {
            "model": model, "prompt": PROMPT_1500, "max_tokens": max_tokens,
            "temperature": 0}),
        "chat streamed": ("/v1/chat/completions", {
            "model": model, "messages": [{"role": "user", "content": text[:150]}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}}),
    }
    status, _ = http("POST", base + "/debug/kernels/reset", {})
    if status != 200:
        fail("/debug/kernels/reset failed")
    counts0 = json.loads(http("GET", base + "/debug/kernels")[1])
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
    # the 900-token prompt again with a 100-character tail: a cache hit of
    # its first 14 pages (896 tokens), the rest through the chunk path
    resend = "completion greedy 900-token prompt again + 100-character tail"
    counts_burst = json.loads(http("GET", base + "/debug/kernels")[1])
    results[resend] = ("full",) + http("POST", base + "/v1/completions", {
        "model": model, "prompt": PROMPT_900 + TAIL_100,
        "max_tokens": max_tokens, "temperature": 0})
    status, body = http("GET", base + "/debug/kernels")
    counts = json.loads(body)
    for name in [*jobs, resend]:
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
            say(f"  {name}: 200, {data['usage']['prompt_tokens']} prompt tokens, {n} "
                f"tokens, finish_reason={ch['finish_reason']}")
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
    # the chunk path: one window append a layer per chunk call, by pool kind
    chunk_calls = counts["chunk_calls"] - counts0["chunk_calls"]
    hits = counts["prefix_hit_tokens"] - counts0["prefix_hit_tokens"]
    resend_hit = counts["prefix_hit_tokens"] - counts_burst["prefix_hit_tokens"]
    window, other = (("paged_write_window_int8", "paged_write_window") if kv_cache_dtype
                     else ("paged_write_window", "paged_write_window_int8"))
    say(f"  chunk path: {chunk_calls} chunk calls, {launches.get(window, 0)} {window} "
        f"launches, {hits} prompt tokens from the prefix cache ({resend_hit} by the "
        f"re-sent prompt)")
    if launches.get(window, 0) != num_layers * chunk_calls or launches.get(window, 0) < 96:
        fail(f"{window} launched {launches.get(window, 0)} times for {chunk_calls} chunk "
             f"calls: expected num_layers per call, and at least 96")
    if launches.get(other, 0):
        fail(f"the {kv_cache_dtype or 'bf16'} KV server launched {other}")
    if resend_hit < 896:
        fail(f"the re-sent 900-token prompt adopted {resend_hit} < 896 cached tokens")

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


def phase_chunk_vs_one_shot(torch, model: str, params) -> None:
    """Printed, not held: a 1,500-token prompt's first-token logits through
    the chunk path (bucket 1,024: two forward_chunk calls, the window
    kernels and the plain chunk attention) against one-shot prefill (bucket
    2,048: flash prefill). The two round differently, so this reports how
    far apart they land and whether the top-1 token agrees."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_chunk, forward_prefill

    cfg = get_config(model)
    n = 1500
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=n).astype(np.int32)
    cc = CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_pages=33,
                     page_size=64, pages_per_slot=32, dtype="bfloat16")
    table = torch.arange(1, 33, dtype=torch.int32, device="cuda")[None]
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device="cuda")
    tokens = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
    tokens[0, :n] = torch.from_numpy(prompt)

    def one_shot():
        k, v = init_pages(cc, device="cuda")
        return forward_prefill(params, cfg, tokens, i32(n), k, v, table)[0]

    def chunked():
        k, v = init_pages(cc, device="cuda")
        for pos in range(0, n, 1024):
            m = min(1024, n - pos)
            chunk = torch.zeros((1, 1024), dtype=torch.int32, device="cuda")
            chunk[0, :m] = tokens[0, pos:pos + m]
            logits = forward_chunk(params, cfg, chunk, i32(pos), i32(m), k, v, table)[0]
        return logits

    wall = {}
    for name, fn in (("one-shot", one_shot), ("chunked", chunked)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = (1e3 * (time.perf_counter() - t0), out)     # the second run stays
    (ms1, ref), (ms2, got) = wall["one-shot"], wall["chunked"]
    err = float((got - ref).abs().max())
    top2 = ref[0].topk(2).values
    same = int(got.argmax()) == int(ref.argmax())
    say(f"chunk vs one-shot ({model} bf16, 1,500-token prompt, buckets 1,024 / 2,048): "
        f"first-token logits max |diff| {err:.4e} (logit scale {float(ref.abs().max()):.3f}), "
        f"top-1 {'equal' if same else 'different'} (one-shot top-1/top-2 gap "
        f"{float(top2[0] - top2[1]):.4e}); wall {ms1:.1f} ms one-shot, {ms2:.1f} ms in two "
        f"chunks [{card_line()}]")
    del wall, ref, got, out
    torch.cuda.empty_cache()


def phase_in_process(torch, model: str) -> dict:
    """Phase 4 with bf16 and with int8 KV, on one set of random weights."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    t0 = time.perf_counter()
    params = init_params(get_config(model), seed=0, dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    say(f"fused: {model} random weights (seed 0) in {time.perf_counter() - t0:.1f} s")
    out = {kv: phase_fused(torch, model, params, kv) for kv in (None, "int8")}
    phase_chunk_vs_one_shot(torch, model, params)
    del params
    torch.cuda.empty_cache()
    return out


def wide_debug_configs() -> list:
    """debug-tiny cut to head_dim 96 (phi-3 style: one query head a KV
    head, a sliding window) and debug-gemma to 256 (gemma-2 style:
    softcaps, alternating windows), made here and not registered."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import get_config

    return [dataclasses.replace(get_config("debug-tiny"), name="debug-d96", head_dim=96,
                                num_heads=2, num_kv_heads=2, sliding_window=30),
            dataclasses.replace(get_config("debug-gemma"), name="debug-d256", head_dim=256,
                                num_heads=2, num_kv_heads=1, logit_softcap=30.0,
                                attn_softcap=50.0, query_pre_attn_scalar=256.0)]


def phase_reference(torch, cfg=None, page: int = 4) -> None:
    """The model on a small input against a reference: ``cfg`` (debug-tiny
    by default) in float32, the same weights on the card (kernels) and on
    the CPU (plain versions), at a page of ``page`` rows. Prefill logits
    within 1e-4 (summation order only), and the engines' greedy streams
    identical, kv_write dus and fused, float and int8 KV, with a chunked
    prompt and a second pass of cache hits."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_prefill, init_params

    cfg = cfg or get_config("debug-tiny")
    cpu_params = init_params(cfg, seed=0, dtype="float32", device="cpu")

    def on(dev):
        return {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                    else v.to(dev)) for k, v in cpu_params.items()}

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 32)).astype(np.int32))
    lengths = torch.tensor([32, 17, 5], dtype=torch.int32)
    logits = {}
    pps = -(-32 // page)
    table = torch.arange(1, 3 * pps + 1, dtype=torch.int32).reshape(3, pps)
    for dev in ("cpu", "cuda"):
        cc = CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                         num_pages=3 * pps + 1, page_size=page, pages_per_slot=pps,
                         dtype="float32")
        k, v = init_pages(cc, device=dev)
        logits[dev] = forward_prefill(on(dev), cfg, tokens.to(dev), lengths.to(dev), k, v,
                                      table.to(dev))[0].cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    say(f"reference: {cfg.name} f32 prefill logits (page {page}), card vs CPU: "
        f"max_abs_err={err:.3e} tol={F32_TOL:.0e}")
    if not err <= F32_TOL:
        fail(f"{cfg.name} prefill logits on the card differ from the CPU reference")
    kw = dict(model=cfg.name, dtype="float32", max_decode_slots=4, page_size=page,
              num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
    # the last prompt passes the largest bucket (two chunks); the second
    # pass over the same engine adopts every prompt's cached full pages
    prompts = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [11] * 30, [100, 42, 5, 1, 9],
               [(7 * i) % 251 for i in range(45)]]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    for kv_dtype in (None, "int8"):
        streams = {}
        for dev, kv_write in (("cpu", "dus"), ("cuda", "dus"), ("cuda", "fused")):
            eng = Engine(EngineConfig(**kw, device=dev, kv_write=kv_write,
                                      kv_cache_dtype=kv_dtype), model_config=cfg,
                         params=on(dev))
            for rnd in ("cold", "hit"):
                reqs = [eng.submit(p, sp) for p in prompts]
                while eng.has_work():
                    eng.step()
                streams[(dev, kv_write, rnd)] = [r.output for r in reqs]
            # cold: the 45-token prompt in two chunks; then cache hits (page
            # 4: 80 tokens and 4 chunk calls; page 24: 48 tokens, the 30- and
            # 45-token prompts' first pages, and 2 chunk calls)
            min_chunks, min_hits = (2 + 4, 80) if page == 4 else (2 + 2, 48)
            if eng.chunk_calls < min_chunks or eng.allocator.hit_tokens_total < min_hits:
                fail(f"{cfg.name} {dev}: {eng.chunk_calls} chunk calls and "
                     f"{eng.allocator.hit_tokens_total} cached tokens: the chunk path or the "
                     f"prefix cache did not run")
        kv = f"{kv_dtype or 'f32'} KV"
        ref = streams[("cpu", "dus", "cold")]
        if any(out != ref for out in streams.values()):
            fail(f"{cfg.name} {kv}: greedy streams differ between the card and the CPU, or "
                 f"between cold and cache-hit runs: {streams}")
        say(f"reference: {cfg.name} {kv} greedy streams equal on the card (dus, fused) and "
            f"the CPU at page {page}, cold, chunked (45 tokens, bucket 32) and on cache hits")


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
    say(f"profile: device time in the window {device_ms(torch, prof):.2f} ms")
    say(ka.table(sort_by="self_cuda_time_total", row_limit=18))
    say(ka.table(sort_by="self_cpu_time_total", row_limit=12))
    profile_chunk(torch, eng)


def device_ms(torch, prof) -> float:
    """The device's own kernel time in a trace (what the table's "Self
    CUDA time total" sums: a CPU operator's entry repeats its kernels)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def profile_chunk(torch, eng) -> None:
    """One chunk call under torch.profiler: the second chunk of a
    1,500-token prompt (base 1,024, 476 tokens in bucket 1,024, as the
    engine runs it), over the engine's pool kind (bf16, or int8 under
    LLMK_KV_DTYPE=int8), in pool pages the decode requests do not use.
    Prints device time by op name, the window appends' kernel time and the
    plain chunk attention's (its calls run inside a record_function
    range), then the same chunk unpadded (W 476): the difference is what
    the padding costs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from llms_on_kubernetes_tpu_torch.models import decoder

    n, base, bucket = 1500, 1024, 1024
    cfg, dev = eng.model_config, "cuda"
    prompt = np.random.default_rng(1).integers(0, 256, size=n).astype(np.int32)
    free = eng.cache_config.num_pages - 33     # the top 32 pages of each layer's pool
    table = torch.arange(free, free + 32, dtype=torch.int32, device=dev)[None]
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    attention = decoder.dispatch_chunk_attention

    def ranged(*a, **k):
        with record_function("chunk_attention"):
            return attention(*a, **k)

    def chunk(pos, m, W):
        tokens = torch.zeros((1, W), dtype=torch.int32, device=dev)
        tokens[0, :m] = torch.from_numpy(prompt[pos:pos + m])
        return decoder.forward_chunk(eng.params, cfg, tokens, i32(pos), i32(m), eng.k_pages,
                                     eng.v_pages, table)[0]

    kv = "int8" if eng.cache_config.kv_dtype == "int8" else "bf16"
    chunk(0, base, bucket)                                  # the first chunk fills the pages
    for label, W in ((f"bucket {bucket}", bucket), ("unpadded W 476", n - base)):
        for _ in range(2):
            chunk(base, n - base, W)                        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(base, n - base, W)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        decoder.dispatch_chunk_attention = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                chunk(base, n - base, W)
                torch.cuda.synchronize()
        finally:
            decoder.dispatch_chunk_attention = attention
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        # the window kernels are launched through ctypes, outside any host
        # op: count them by kernel name; the attention by its host ranges
        appends = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == cuda and "write_window" in e.key) / 1e3
        attn = sum(e.device_time_total for e in prof.events()
                   if e.name == "chunk_attention" and e.device_type == cpu) / 1e3
        say(f"profile: chunk call ({cfg.name} {kv} KV, base {base}, {n - base} tokens, "
            f"{label}): wall {wall:.1f} ms, device {device_ms(torch, prof):.2f} ms, of which "
            f"window append kernels {appends:.3f} ms ({cfg.num_layers} calls) and chunk "
            f"attention {attn:.2f} ms [{card_line()}]")
        if label.startswith("bucket"):
            say(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18))


# ---------------------------------------------------------------------------
# phase 5: a safetensors checkpoint, written, loaded and served
# ---------------------------------------------------------------------------

CKPT_MODEL = "phi-3-mini"
CKPT_DIR = os.path.join(OUT_DIR, "phi-3-mini-synth")
CKPT_PPS = 48          # 3,072 tokens a slot: room for the 2,500-token prompt
# a 2,500-token text past phi-3's 2,047-token window, sharing no page with
# phase 3's prompts (the byte tokenizer: one token a character)
PROMPT_2500 = ("A sliding window keeps the last two thousand and forty seven keys in "
               "view, and the page table still holds every one of them. " * 25)[:2500]


def drop_page_cache(path: str) -> None:
    """Ask the kernel to drop a written file's cached pages (clean pages
    only, so after an fsync), so the next read comes from the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def expected_layer(cfg, i: int, spec: dict) -> dict:
    """Layer i of the decoder's parameters as the writer wrote its HF
    tensors (bfloat16 bits), moved to the decoder's layouts here with
    numpy, independently of the loader: phi-3's fused qkv_proj and
    gate_up_proj split, linears transposed, heads made explicit."""
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import tensor_value

    H, KV, hd, D, F = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size,
                       cfg.intermediate_size)
    p = f"model.layers.{i}."
    hf = lambda name: tensor_value(cfg, p + name, *spec[p + name])
    qkv = hf("self_attn.qkv_proj.weight")
    gate_up = hf("mlp.gate_up_proj.weight")
    return {
        "wq": qkv[:H * hd].T.reshape(D, H, hd),
        "wk": qkv[H * hd:(H + KV) * hd].T.reshape(D, KV, hd),
        "wv": qkv[(H + KV) * hd:].T.reshape(D, KV, hd),
        "wo": hf("self_attn.o_proj.weight").T.reshape(H, hd, D),
        "w_gate": gate_up[:F].T, "w_up": gate_up[F:].T,
        "w_down": hf("mlp.down_proj.weight").T,
        "attn_norm": hf("input_layernorm.weight"),
        "mlp_norm": hf("post_attention_layernorm.weight"),
    }


def bits(t) -> np.ndarray:
    """A bfloat16 tensor's bits as uint16, on the host."""
    import torch
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


def phase_checkpoint(torch) -> dict:
    """Write full-width phi-3-mini as a bf16 safetensors checkpoint
    (testing/synth_checkpoint.py: the family's names, shapes and layouts,
    pattern values), drop it from the page cache, load it in this process
    (cold) and hold layers 0 and 31 (the fused tensors split), the
    embedding, the final norm and the head bit for bit to what was
    written; then serve it through the CLI with bf16 and with int8 KV."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import (
        tensor_specs, tensor_value, write_checkpoint,
    )

    t_phase = time.perf_counter()
    cfg = get_config(CKPT_MODEL)
    specs = tensor_specs(cfg)
    need = sum(int(np.prod(shape)) * 2 for _, shape, _ in specs)
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free = shutil.disk_usage(OUT_DIR).free
    if free < need + (1 << 30):
        fail(f"{free} bytes free under {OUT_DIR}: the {CKPT_MODEL} checkpoint needs {need} "
             f"and 1 GiB of room")
    t0 = time.perf_counter()
    index = write_checkpoint(cfg, CKPT_DIR)
    shards = sorted(set(index["weight_map"].values()))
    for shard in shards:
        drop_page_cache(os.path.join(CKPT_DIR, shard))
    write_s = time.perf_counter() - t0
    say(f"checkpoint: {CKPT_MODEL} written, {index['metadata']['total_size']} bytes in "
        f"{len(shards)} shards, {len(index['weight_map'])} tensors, {write_s:.1f} s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_hf_params(cfg, CKPT_DIR, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    say(f"checkpoint: loaded in process from a dropped page cache in {load_s:.2f} s "
        f"({need / load_s / 1e9:.2f} GB/s) [{card_line()}]")
    spec = {name: (shape, kind) for name, shape, kind in specs}
    for i in (0, cfg.num_layers - 1):
        for name, want in expected_layer(cfg, i, spec).items():
            got = params["layers"][name][i]
            if got.dtype != torch.bfloat16 or not np.array_equal(bits(got), want):
                fail(f"checkpoint: layer {i} {name} differs from what was written")
    for name, hf_name in (("embed", "model.embed_tokens.weight"),
                          ("final_norm", "model.norm.weight"), ("lm_head", "lm_head.weight")):
        want = tensor_value(cfg, hf_name, *spec[hf_name])
        if not np.array_equal(bits(params[name]), want.T if name == "lm_head" else want):
            fail(f"checkpoint: {name} differs from what was written")
    say(f"checkpoint: layers 0 and {cfg.num_layers - 1} (qkv_proj and gate_up_proj split), "
        f"embed, final_norm and lm_head equal what was written, bit for bit")
    del params
    torch.cuda.empty_cache()
    served = {kv: serve_checkpoint(cfg, kv) for kv in (None, "int8")}
    say(f"checkpoint phase: {time.perf_counter() - t_phase:.1f} s (write {write_s:.1f}, "
        f"cold load {load_s:.2f}, to /health bf16 {served[None]['health_s']:.1f} / int8 "
        f"{served['int8']['health_s']:.1f}, warm load in the server bf16 "
        f"{served[None]['load_s']} / int8 {served['int8']['load_s']})")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return served


def serve_checkpoint(cfg, kv_cache_dtype=None) -> dict:
    """``serve --model <checkpoint dir>`` as a user runs it, and a request
    mix through HTTP: prompts in each bucket, a 1,500-token prompt (two
    chunks) and the same again with a tail (a cache hit), a 2,500-token
    prompt past the sliding window (three chunks). The launch counters are
    zeroed just before and read just after."""
    kv = ["--kv-cache-dtype", kv_cache_dtype] if kv_cache_dtype else []
    log_name = f"chip_smoke_checkpoint_server{'_' + kv_cache_dtype if kv_cache_dtype else ''}.log"
    res = with_server(["--model", CKPT_DIR, "--pages-per-slot", str(CKPT_PPS), *kv], log_name,
                      lambda base: _drive_checkpoint_server(base, cfg, kv_cache_dtype))
    with open(os.path.join(OUT_DIR, log_name)) as f:
        loaded = [line for line in f if "weights from" in line]
    res["load_s"] = loaded[-1].rsplit(" in ", 1)[-1].strip() if loaded else "not printed"
    return res


def _drive_checkpoint_server(base: str, cfg, kv_cache_dtype) -> dict:
    model = CKPT_DIR
    status, body = http("GET", base + "/v1/models")
    if status != 200 or json.loads(body)["data"][0]["id"] != model:
        fail(f"/v1/models: {status} {body[:200]!r}")
    status, _ = http("POST", base + "/debug/kernels/reset", {})
    if status != 200:
        fail("/debug/kernels/reset failed")
    counts0 = json.loads(http("GET", base + "/debug/kernels")[1])
    max_tokens = 16
    burst = {
        "40-token prompt (bucket 64)": SERVE_TEXT[:40],
        "200-token prompt (bucket 256)": SERVE_TEXT[:200],
        "900-token prompt (bucket 1,024)": PROMPT_900,
        "1,500-token prompt (two chunks)": PROMPT_1500,
        "2,500-token prompt past the 2,047-token window (three chunks)": PROMPT_2500,
    }
    results: dict = {}

    def run(name, prompt):
        try:
            results[name] = http("POST", base + "/v1/completions", {
                "model": model, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0})
        except Exception as e:  # reported below as this request's failure
            results[name] = ("error", repr(e))

    threads = [threading.Thread(target=run, args=item) for item in burst.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts_burst = json.loads(http("GET", base + "/debug/kernels")[1])
    hit = "1,500-token prompt again + 100-character tail (a cache hit)"
    run(hit, PROMPT_1500 + TAIL_100)
    status, chat = http("POST", base + "/v1/chat/completions", {
        "model": model, "messages": [{"role": "user", "content": SERVE_TEXT[:120]}],
        "max_tokens": max_tokens, "temperature": 0})
    results["chat"] = (status, chat)
    counts = json.loads(http("GET", base + "/debug/kernels")[1])
    for name, res in results.items():
        if res[0] == "error" or res[0] != 200:
            fail(f"checkpoint server, {name}: {res[0]} {res[1][:300]!r}")
        data = json.loads(res[1])
        ch = data["choices"][0]
        text = ch["message"]["content"] if name == "chat" else ch["text"]
        n = data["usage"]["completion_tokens"]
        if ch["finish_reason"] not in ("length", "stop") or not isinstance(text, str) or not (
                n == max_tokens or (ch["finish_reason"] == "stop" and 0 < n <= max_tokens)):
            fail(f"checkpoint server, {name}: {ch['finish_reason']}, {n} tokens")
        say(f"  {name}: 200, {data['usage']['prompt_tokens']} prompt tokens, {n} tokens, "
            f"finish_reason={ch['finish_reason']}")
    delta = {k: counts[k] - counts0[k] for k in ("prefill_calls", "chunk_calls",
                                                "decode_forwards", "prefix_hit_tokens")}
    hit_tokens = counts["prefix_hit_tokens"] - counts_burst["prefix_hit_tokens"]
    launches = counts["launches"]
    L = cfg.num_layers
    int8 = kv_cache_dtype == "int8"
    decode = "paged_decode_int8" if int8 else "paged_decode"
    window = "paged_write_window_int8" if int8 else "paged_write_window"
    say(f"  kernel launches: {launches}; calls {delta}; layers {L}; the re-sent prompt "
        f"adopted {hit_tokens} cached tokens")
    expect = {"flash_prefill": L * delta["prefill_calls"], decode: L * delta["decode_forwards"],
              window: L * delta["chunk_calls"]}
    for name, n in expect.items():
        if not n or launches.get(name, 0) != n:
            fail(f"{name} launched {launches.get(name, 0)} times, expected num_layers x its "
                 f"calls = {n}")
    others = set(launches) - set(expect)
    if any(launches[k] for k in others):
        fail(f"the {'int8' if int8 else 'bf16'} KV checkpoint server launched "
             f"{ {k: launches[k] for k in others} }")
    # 1,500 tokens: 2 chunks; the hit's rest: 1; 2,500 tokens: 3
    if delta["chunk_calls"] < 6 or hit_tokens < 1472:
        fail(f"{delta['chunk_calls']} chunk calls and a hit of {hit_tokens} tokens: the chunk "
             f"path or the prefix cache did not run")
    return {"launches": launches}


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
    hmma, funcs = sass_mma_count(kernels.library_path("flash_prefill"))
    say(f"sass flash_prefill: {hmma} HMMA instructions in {funcs} tensor-core "
        f"(bf16) functions")
    if not funcs or not hmma:
        fail("the bf16 flash prefill body has no tensor-core (HMMA) instruction")

    t0 = time.perf_counter()
    entries = phase_kernels(torch)
    for name, shapes in wide_kernels(torch, np.random.default_rng(1), Timer(torch)).items():
        entries[name]["other_shapes"].update(shapes)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"phase 2 (kernels): {time.perf_counter() - t0:.1f} s")
    if "--profile" in argv:
        phase_profile(torch)
        fail("--profile: profile only, no result")
    if "--kernels-only" in argv:
        say(json.dumps({"kernels": list(entries.values())}))
        fail("--kernels-only: phases 3 to 5 skipped, no result")
    t0 = time.perf_counter()
    phase_reference(torch)
    for cfg in wide_debug_configs():
        phase_reference(torch, cfg, page=24)
    num_layers = get_config(MODEL).num_layers
    served = phase_serve(MODEL, num_layers)
    served_int8 = phase_serve(MODEL, num_layers, kv_cache_dtype="int8")
    say(f"phase 3 (reference, serve): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fused = phase_in_process(torch, MODEL)
    say(f"phase 4 (fused): {time.perf_counter() - t0:.1f} s")
    ckpt = phase_checkpoint(torch)
    # launches on each path, counted from 0 just before it and read just
    # after; the line's "launches" is this slice's path (the checkpoint
    # server) where the kernel runs there, else phase 4's fused engines
    ckpt_bf16, ckpt_int8 = (f"{CKPT_MODEL} checkpoint serve {kv} KV" for kv in ("bf16", "int8"))
    fused_bf16, fused_int8 = (f"{MODEL} kv_write fused {kv} KV" for kv in ("bf16", "int8"))
    paths = {f"{MODEL} serve bf16 KV": served["launches"],
             f"{MODEL} serve int8 KV": served_int8["launches"],
             fused_bf16: fused[None]["launches"], fused_int8: fused["int8"]["launches"],
             ckpt_bf16: ckpt[None]["launches"], ckpt_int8: ckpt["int8"]["launches"]}
    main_path = {"flash_prefill": ckpt_bf16, "paged_decode": ckpt_bf16,
                 "paged_write_window": ckpt_bf16, "paged_decode_int8": ckpt_int8,
                 "paged_write_window_int8": ckpt_int8, "paged_decode_write": fused_bf16,
                 "paged_decode_write_int8": fused_int8}
    for name, e in entries.items():
        e["launches"] = paths[main_path[name]].get(name, 0)
        e["launches_path"] = main_path[name]
        e["launches_by_path"] = {p: c.get(name, 0) for p, c in paths.items() if c.get(name)}
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
