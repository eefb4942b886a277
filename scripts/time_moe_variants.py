#!/usr/bin/env python3
"""Take the MoE expert kernel apart on one GPU: where its time goes.

    python scripts/time_moe_variants.py            # check, then time every copy
    python scripts/time_moe_variants.py --check    # build and check the kernel only
    python scripts/time_moe_variants.py --w8       # the same copies of the int8 kernel
    python scripts/time_moe_variants.py --check --old DIR   # the kernel bit for bit
                                                            # DIR/moe_experts.cu's

Builds copies of ``llms_on_kubernetes_tpu_torch/csrc/moe_experts.cu`` (its
body ``moe_stream.cuh`` patched) side by side (into ``_variants/build_moe/``, git-ignored; each with
``-Xcompiler -fno-gnu-unique`` so that two builds of one template in one
process do not share its static locals), and the body before the Hopper
redesign (``scripts/moe_experts_simple.cu``):

- ``kernel``: the source as it is (held against the plain version, rows
  alone bit-equal to them among R rows, and its SASS read for ``HGMMA``);
- ``no-mma``: no wgmma is issued: the tiles still stream in through the
  same barriers, the gather, the slice sums and the epilogues run;
- ``no-gather``: the gate/up launch copies none of its rows (the copies
  are predicated off; every thread still arrives on the stage's barrier);
- ``no-slice-sum``: no slice is added into the sum (the wait at each
  slice's end stays);
- ``one-slice``: the K split is one slice at every width: no slice sum,
  no wait at a slice's end;
- ``no-wload``: no weight tile is loaded (the consumers read whatever the
  ring holds);
- ``no-xload``: no rows are loaded (no gather, no TMA of h);
- ``gateup-only``, ``down-only``: one of the two launches (the other
  skipped);
- ``stages-4``: the ring cut to 4 stages;
- ``no-epilogue``: no output row is stored;
- ``rows-by-tokens``: tiles sized for min(R, tokens) rows alone (every
  expert in one tile), not for four times an expert's even share;
- ``simple``: the earlier body (``mma.sync``, 64 x 64 tiles, cp.async).

With ``--w8`` every copy is built from ``moe_experts_w8.cu`` (the same
body on int8 weight tiles) and run on int8 QTensor stacks quantized from
the bf16 ones (no ``simple``; the bound counts the int8 bytes,
``chip_smoke.moe_w8_work``; ``_grouped_mm`` still runs on the bf16
stacks). With ``--old DIR`` (the ``csrc`` directory of an earlier tree,
e.g. unpacked from ``git archive``) DIR's ``moe_experts.cu`` is built too
and the bf16 kernel's output is held bit for bit to its output at every
shape checked. The copies other than ``kernel`` and ``simple`` compute nothing
useful and are timed only. Each is timed with ``chip_smoke.Timer`` (L2 flushed before
each launch) at Qwen3-30B-A3B's widths (D 2,048, F 768, 128 experts top-8)
at every R of ``chip_smoke.MOE_ROWS`` and at Mixtral-8x7B's (D 4,096, F
14,336, 8 experts top-2) at R 16 and 8,192, in turns A B C ... C B A within
one process, beside ``torch._grouped_mm`` (the gather, three grouped
products and the SiLU product) and the bound of the experts touched. Prints
every time; writes the numbers to ``chiprun_out/moe_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "llms_on_kubernetes_tpu_torch" / "csrc"
SOURCE = CSRC / "moe_stream.cuh"       # the body the copies patch
SIMPLE = ROOT / "scripts" / "moe_experts_simple.cu"
MMA = [("      wgmma_rs<NX>(chain, af[P][kk], desc_b(st + kk * 32), !(first && kk == 0));",
        "      (void)st, (void)first;")]
STREAM_EXPECT = "          mbar_expect(&full[s], 2 * C::kWT + (GATED ? 0 : C::kXTile));"
GATHER = [("    cp16_if(q < kChunks, dst + swz(r, 16 * c),",
           "    cp16_if(false, dst + swz(r, 16 * c),")]
SLICE_SUM = [("      for (int i = 0; i < NX / 2; ++i) tot[i] = s0 ? chain[i] : tot[i] + chain[i];",
              "      for (int i = 0; i < NX / 2; ++i) tot[i] = s0 ? chain[i] : tot[i];")]
WLOAD = [(STREAM_EXPECT, "          mbar_expect(&full[s], GATED ? 0 : C::kXTile);"),
         ("          tma_load(st + C::kXTile, &tw0, c0, wrow + ld.k0, &full[s]);\n"
          "          tma_load(st + C::kXTile + C::kWT, &tw1, GATED ? c0 : c0 + kCols, "
          "wrow + ld.k0,\n                   &full[s]);\n", "")]
XLOAD = [GATHER[0], (STREAM_EXPECT, "          mbar_expect(&full[s], 2 * C::kWT);"),
         ("          if (!GATED) tma_load(st, &ta, ld.k0, tl.y, &full[s]);\n", "")]
VARIANTS = {
    "kernel": [],
    "no-mma": MMA,
    "no-gather": GATHER,
    "no-slice-sum": SLICE_SUM,
    "one-slice": [("  return make_split(K, Nw, K % kBK == 0 ? kBK : 32);",
                   "  Split sp = make_split(K, Nw, K % kBK == 0 ? kBK : 32);\n"
                   "  sp.S = 1;\n  return sp;")],
    "no-wload": WLOAD,
    "no-xload": XLOAD,
    "gateup-only": [("  if (e) return e;\n  return launch<false, W8>(",
                     "  if (e || R > 0) return e;\n  return launch<false, W8>(")],
    "down-only": [("  const int e = launch<true, W8>(",
                   "  const int e = 0 * R;\n  if (0) launch<true, W8>(")],
    "stages-4": [("  static constexpr int kStages = kFit < 8 ? kFit : 8;",
                  "  static constexpr int kStages = kFit < 4 ? kFit : 4;")],
    "no-epilogue": [("        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + nc + 8 * ch)"
                     " =\n            *reinterpret_cast<const uint4*>(ostage + r * C::kOStride"
                     " + 8 * ch);", "        (void)row0;")],
    "rows-by-tokens": [("  if (share < most) most = share > 8 ? share : 8;", "")],
}
# (model, R) shapes timed
SHAPES = [("qwen3-30b-a3b", R) for R in cs.MOE_ROWS] + [("mixtral-8x7b", 16),
                                                       ("mixtral-8x7b", 8192)]


def build(check_only: bool, w8: bool = False, old=None) -> dict:
    """{label: ctypes entry}, every nvcc started together (``w8``: the
    int8 kernel's copies; ``old``: a csrc directory whose moe_experts.cu is
    built as ``old``)."""
    from llms_on_kubernetes_tpu_torch import kernels

    entry = "moe_experts_w8.cu" if w8 else "moe_experts.cu"
    out = ROOT / "_variants" / ("build_moe_w8" if w8 else "build_moe")
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for label, edits in VARIANTS.items():
        if check_only and label != "kernel":
            continue
        src = text
        for old, new in edits:
            if old not in src:
                cs.fail(f"{label}: {SOURCE.name} no longer has {old.strip()!r}")
            src = src.replace(old, new, 1)
        d = out / label
        d.mkdir(exist_ok=True)
        (d / SOURCE.name).write_text(src)
        for header in (entry, "common.cuh", "hopper.cuh"):
            (d / header).write_text((CSRC / header).read_text())
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
               str(d / "lib.so"), str(d / entry)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), d / "lib.so",
                        "llmk_moe_experts_w8" if w8 else "llmk_moe_experts")
    if not check_only and not w8:
        d = out / "simple"
        d.mkdir(exist_ok=True)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
               str(d / "lib.so"), str(SIMPLE)]
        procs["simple"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           d / "lib.so", "llmk_moe_experts_simple")
    if old is not None:
        d = out / "old"
        d.mkdir(exist_ok=True)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
               str(d / "lib.so"), str(Path(old) / "moe_experts.cu")]
        procs["old"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), d / "lib.so", "llmk_moe_experts")
    fns = {}
    for label, (proc, lib, symbol) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc {label} exited {proc.returncode}:\n{log}")
        if label == "kernel":
            for func, line in cs.ptxas_report(log):
                cs.say(f"  ptxas {func}: {line}")
            n, funcs = cs.sass_mma_count(lib, "moe_stream", "HGMMA")
            cs.say(f"  sass moe_stream: {n} HGMMA instructions in {funcs} functions")
            if not n or not funcs:
                cs.fail("moe_stream has no wgmma (HGMMA) instruction")
            faults = cs.ptxas_faults(log, "moe_stream")
            if faults:
                cs.fail("kernel: " + "; ".join(faults))
        serial = [line for line in log.splitlines() if "Performance Loss" in line]
        cs.say(f"  {label}: ptxas serializes the wgmma of {len(serial)} functions")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        if symbol == "llmk_moe_experts":
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        elif symbol == "llmk_moe_experts_w8":
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def call(torch, label: str, fn, x, src, counts, wg, wu, wd):
    from llms_on_kubernetes_tpu_torch import kernels

    R, E, D, Fd = src.shape[0], wg.shape[0], wg.shape[1], wg.shape[2]
    h = torch.empty((R, Fd), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((R, D), dtype=torch.bfloat16, device="cuda")
    w8 = hasattr(wg, "scale")           # int8 QTensor stacks: their data, then scales
    args = [x.data_ptr(), src.data_ptr(), counts.data_ptr()]
    args += [w.data.data_ptr() if w8 else w.data_ptr() for w in (wg, wu, wd)]
    args += [w.scale.data_ptr() for w in (wg, wu, wd)] if w8 else []
    args += [h.data_ptr(), y.data_ptr(), R]
    args += [E, D, Fd] if label == "simple" else [x.shape[0], E, D, Fd]
    kernels.check(f"moe_experts {label}", fn(*args, torch.cuda.current_stream().cuda_stream))
    return y


def check(torch, fn, cfg, x, src, counts, wg, wu, wd, tag: str, old=None) -> None:
    """The kernel against the plain version (the bf16 row tolerance), and
    rows alone (each an R-1 call, on 8-row tiles) bit-equal to them;
    ``old``: every row bit-equal to that build's too."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    E, rows = counts.shape[0], int(counts.sum())
    got = call(torch, "kernel", fn, x, src, counts, wg, wu, wd)
    want = moe.moe_experts_plain(x, src, counts, wg, wu, wd)
    cs.check_close(f"{tag} ({moe.moe_rows(src.shape[0], x.shape[0], E)}-row tiles)",
                   got[:rows], want[:rows], "bfloat16")
    if old is not None:
        prev = call(torch, "old", old, x, src, counts, wg, wu, wd)
        if not torch.equal(got[:rows], prev[:rows]):
            bad = int((got[:rows] != prev[:rows]).any(dim=1).sum())
            cs.fail(f"{tag}: {bad} of {rows} rows differ from the earlier source's")
        cs.say(f"  {tag}: every row bit for bit the earlier source's")
    expert_of = torch.repeat_interleave(torch.arange(E, device="cuda"), counts.long())
    for r in sorted({0, rows // 3, rows - 1}):
        one = torch.zeros((E,), dtype=torch.int32, device="cuda")
        one[expert_of[r]] = 1
        alone = call(torch, "kernel", fn, x, src[r:r + 1].contiguous(), one, wg, wu, wd)
        if not torch.equal(alone[0], got[r]):
            bad = int((alone[0] != got[r]).sum())
            cs.fail(f"{tag}: row {r} alone differs from row {r} among {src.shape[0]} rows in "
                    f"{bad} columns")
    cs.say(f"  {tag}: rows {sorted({0, rows // 3, rows - 1})} alone bit-equal")


def main(argv) -> int:
    import numpy as np
    import torch

    from llms_on_kubernetes_tpu_torch.configs import get_config

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    check_only, w8 = "--check" in argv, "--w8" in argv
    old_dir = argv[argv.index("--old") + 1] if "--old" in argv else None
    if old_dir is not None and w8:
        cs.fail("--old holds the bf16 kernel: not with --w8")
    card = cs.card_line()
    fns = build(check_only, w8, old_dir)
    old = fns.pop("old", None)
    timer = cs.Timer(torch)

    def kernel_stacks(wg, wu, wd):      # what the copies run on
        return cs.moe_w8_stacks(wg, wu, wd) if w8 else (wg, wu, wd)

    # debug-moe widths (D 64, F 96: a partial column tile and K slices of 32
    # rows) and a few R, checked only
    small = get_config("debug-moe")
    router, wg, wu, wd, gen = cs.moe_weights(torch, small)
    ks = kernel_stacks(wg, wu, wd)
    for R in (1, 8, 32, 40, 128, 300):
        x, src, counts = cs.moe_inputs(torch, small, router, gen, R)
        check(torch, fns["kernel"], small, x, src, counts, *ks, f"debug-moe R{R}", old)
    result = {}
    model = None
    for name, R in SHAPES:
        if name != model:
            model, cfg = name, get_config(name)
            wg = wu = wd = ks = None
            torch.cuda.empty_cache()
            router, wg, wu, wd, gen = cs.moe_weights(torch, cfg)
            ks = kernel_stacks(wg, wu, wd)
        x, src, counts = cs.moe_inputs(torch, cfg, router, gen, R)
        check(torch, fns["kernel"], cfg, x, src, counts, *ks, f"{name} R{R}", old)
        if check_only:
            continue
        flops, nbytes, touched = (cs.moe_w8_work if w8 else cs.moe_work)(cfg, x, counts, R)
        b_ms, b_by = cs.bound_ms(flops, nbytes, "bfloat16")
        lib_fn, why = cs.moe_library(torch, x, src, counts, wg, wu, wd)
        order = list(fns) + ["_grouped_mm"] + list(fns)[::-1]
        ms = {k: [] for k in list(fns) + ["_grouped_mm"]}
        reps = 30 if R <= 512 else 10
        for label in order:
            if label == "_grouped_mm":
                if lib_fn is not None:
                    ms[label].append(timer(lib_fn, reps=reps))
                continue
            fn = fns[label]
            ms[label].append(timer(lambda: call(torch, label, fn, x, src, counts, *ks),
                                   reps=reps))
        key = f"{name} R{R}"
        result[key] = {k: float(np.mean(v)) for k, v in ms.items() if v}
        result[key].update(bound_ms=b_ms, bound_by=b_by, experts_touched=touched)
        cs.say(f"{key} ({touched} experts touched; bound {b_ms:.4f} {b_by}): " + " ".join(
            f"{k}={np.mean(v):.4f}" for k, v in ms.items() if v)
            + ("" if lib_fn is not None else f" (_grouped_mm none: {why})"))
    if check_only:
        cs.say(f"check only: every shape held [{card}]")
        return 0
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "moe_variants.json").write_text(
        json.dumps({"card": card, "weights": "int8" if w8 else "bf16", "ms": result}, indent=1))
    cs.say(f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
