#!/usr/bin/env python3
"""Take the W8A16 kernel apart on one GPU: where its time goes.

    python scripts/time_w8_variants.py

Builds copies of ``llms_on_kubernetes_tpu_torch/csrc/w8_matmul.cu`` side by
side (into ``_variants/build/``, git-ignored; each with ``-Xcompiler
-fno-gnu-unique`` so that two builds of one template in one process do not
share its static locals):

- ``kernel``: the source as it is (held against the plain version);
- ``no-arith``: the decode body skips every 16-deep step and the prefill
  body skips its conversions and its wgmma steps, so the tiles still
  stream in by TMA through the same barriers and the folds still run, but
  nothing is converted or multiplied;
- ``no-tiles``: the decode body loads no tile at all: the launch, the
  cluster barriers and the fold of zero chains (prefill rows: the kernel);
- ``no-convert`` / ``no-mma``: the prefill body without its conversions /
  without its wgmma steps (decode rows: the kernel).

The copies other than ``kernel`` compute nothing useful and are timed
only. Each is timed with ``chip_smoke.Timer`` (50 launches, L2 flushed) at
llama-3-8b's and phi-3-mini's projections at M 8 and 64 (the decode body)
and 256 and 4,096 (the prefill body), in turns A B C ... C B A within one
process, beside a read-rate yardstick: ``torch.sum`` over the weight's
bytes viewed as float32 (one PyTorch call that streams the same bytes).
Prints every time and a forward's 224 projections for each copy; writes
the numbers to ``chiprun_out/w8_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "llms_on_kubernetes_tpu_torch" / "csrc" / "w8_matmul.cu"
STEPS = ("    const int steps = max(0, min(kBK, my_ke - (my_kb + t * kBK))) / 16;",
         "    const int steps = 0 * my_ke;")
TILES = ("    tiles = max(tiles, (ke[i] - kb[i] + kBK - 1) / kBK);\n  }",
         "    tiles = max(tiles, (ke[i] - kb[i] + kBK - 1) / kBK);\n  }\n  tiles = 0;")
MMA = [("    if (steps == kBK / 16) {  // no branch between a whole tile's steps",
        "    if (steps < 0) {"),
       ("        if (kk < steps) wgmma_rs<C::kRows>(",
        "        if (kk < steps && steps < 0) wgmma_rs<C::kRows>(")]
CONVERT = ("    if (T == 0)\n      pre_frags<0>(f, b, wn, g, tq);\n    else\n"
           "      pre_frags<1>(f, b, wn, g, tq);", "    (void)b;")
VARIANTS = {
    "kernel": [],
    "no-arith": [STEPS, *MMA, CONVERT],
    "no-tiles": [TILES],
    "no-convert": [CONVERT],
    "no-mma": MMA,
}
# label -> (K, N, projections of that shape a layer)
SHAPES = {"llama wq/wo": (4096, 4096, 2), "llama wk/wv": (4096, 1024, 2),
          "llama w_gate/w_up": (4096, 14336, 2), "llama w_down": (14336, 4096, 1),
          "phi3 wqkvo": (3072, 3072, 4), "phi3 w_gate/w_up": (3072, 8192, 2),
          "phi3 w_down": (8192, 3072, 1)}
ROWS = (8, 64, 256, 4096)


def build() -> dict:
    """{label: ctypes entry}, every nvcc started together."""
    from llms_on_kubernetes_tpu_torch import kernels

    out = ROOT / "_variants" / "build"
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for label, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                cs.fail(f"{label}: {SOURCE.name} no longer has {old.strip()!r}")
            src = src.replace(old, new, 1)
        d = out / label
        d.mkdir(exist_ok=True)
        (d / "w8_matmul.cu").write_text(src)
        (d / "common.cuh").write_text((SOURCE.parent / "common.cuh").read_text())
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
               str(d / "lib.so"), str(d / "w8_matmul.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), d / "lib.so")
    fns = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc {label} exited {proc.returncode}:\n{log}")
        fn = ctypes.CDLL(str(lib)).llmk_w8_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def main() -> int:
    import torch

    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.ops import quant as q

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card = cs.card_line()
    fns = build()
    timer = cs.Timer(torch)
    rng = np.random.default_rng(0)

    def call(fn, x, w, s):
        out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device="cuda")
        kernels.check("w8_matmul variant", fn(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            w.shape[1], kernels.DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream))
        return out

    order = list(fns) + list(fns)[::-1]
    result, forward = {}, {}
    for label, (K, N, per) in SHAPES.items():
        x0 = torch.from_numpy(rng.normal(size=(max(ROWS), K)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        w = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8)).cuda()
        s = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=N).astype(np.float32)).cuda()
        wf = w.view(torch.float32)
        read = timer(lambda: wf.sum(), reps=50)
        result[f"{label} torch.sum"] = read
        cs.say(f"{label} K{K} N{N}: torch.sum over the {K * N / 1e6:.1f} MB weight: "
               f"{read:.4f} ms")
        for M in ROWS:
            x = x0[:M]
            cs.check_close(f"kernel {label} M{M}", call(fns["kernel"], x, w, s),
                           q.w8_matmul_plain(x, w, s), "bfloat16")
            ms = {name: [] for name in fns}
            for name in order:
                fn = fns[name]
                ms[name].append(timer(lambda: call(fn, x, w, s), reps=50))
            for name, v in ms.items():
                result[f"{label} M{M} {name}"] = float(np.mean(v))
                key = (label.split()[0], M, name)
                forward[key] = forward.get(key, 0.0) + 32 * per * float(np.mean(v))
            cs.say(f"{label} K{K} N{N} M{M}: " + " ".join(
                f"{name}={np.mean(v):.4f}" for name, v in ms.items()))
    for (model, M, name), v in sorted(forward.items()):
        result[f"{model} forward M{M} {name}"] = v
        cs.say(f"{model} forward's 224 projections at M {M}, {name}: {v:.3f} ms [{card}]")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "w8_variants.json").write_text(
        json.dumps({"card": card, "ms": result}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
