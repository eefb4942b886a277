#!/usr/bin/env python3
"""Take the W4A16 kernel apart on one GPU: where its time goes.

    python scripts/time_w4_variants.py

Builds copies of ``llms_on_kubernetes_tpu_torch/csrc/w4_matmul.cu`` side by
side (into ``_variants/build4/``, git-ignored; each with ``-Xcompiler
-fno-gnu-unique`` so that two builds of one template in one process do not
share its static locals):

- ``kernel``: the source as it is (held against the plain version);
- ``no-arith``: the decode body converts, multiplies and group-steps
  nothing, so the tiles still stream in by TMA through the same barriers
  and the cluster fold still runs (prefill rows: the kernel);
- ``no-tiles``: the decode body loads no tile at all: the launch, the
  cluster barriers and the fold of zero results (prefill rows: the
  kernel);
- ``no-convert``: both bodies take the packed words as fragments, without
  the nibble conversion;
- ``no-mma``: both bodies issue no wgmma (the data path's and xsum's);
- ``no-group``: no group step's arithmetic (the xsums still pass through
  shared memory);
- ``no-xsum``: the decode body issues no xsum wgmma (the data path's
  two a step only);
- ``decode-rows``: every M on the decode body (64 rows a block, ceil(M /
  64) row blocks), none on the prefill body;
- ``no-pipe``: the decode body with one chain parity at every width (a
  group's step waits for its own chains, and the next group's steps wait
  for it).

The copies other than ``kernel`` compute nothing useful and are timed
only. Each is timed with ``chip_smoke.Timer`` (50 launches, L2 flushed) at
Qwen3-8B's four projection shapes (group 128, packed) at M 8 and 64 (the
decode body) and 256 and 4,096 (the prefill body), in turns A B C ... C B
A within one process, beside a read-rate yardstick: ``torch.sum`` over the
packed weight's bytes viewed as float32 (one PyTorch call that streams the
same bytes). Prints every time and a forward's 252 projections for each
copy; writes the numbers to ``chiprun_out/w4_variants.json``.
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

CSRC = ROOT / "llms_on_kubernetes_tpu_torch" / "csrc"
SOURCE = CSRC / "w4_matmul.cu"
FRAGS = [("      w4_frags<0, PACKED>(f[kk][0], b, kk, wn, g, tq);\n"
          "      w4_frags<1, PACKED>(f[kk][1], b, kk, wn, g, tq);", "      (void)b;")]
TILES = [("  const int tiles = (ke - kb + kBK - 1) / kBK;", "  const int tiles = 0 * ke;")]
CONVERT = [("    f[0] = nibble_pair<2 * T>(w0, h0), f[1] = nibble_pair<2 * T + 1>(w0, h0);\n"
            "    f[2] = nibble_pair<2 * T>(w1, h1), f[3] = nibble_pair<2 * T + 1>(w1, h1);",
            "    f[0] = w0, f[1] = h0, f[2] = w1, f[3] = h1;")]
XSUM = [("    wgmma_ss8(xd[Q], d, desc_b(ones), more);", "")]
MMA = [("    wgmma_rs<NX>(part[Q][0], af[P][kk][0], d, more);\n"
        "    wgmma_rs<NX>(part[Q][1], af[P][kk][1], d, more);", "    (void)d, (void)more;"),
       *XSUM,
       ("      wgmma_rs<C::kRows>(part, af[P][kk], d, more);\n"
        "      wgmma_ss8(xd[0], d, desc_b(ones), more);\n"
        "      wgmma_ss8(xd[1], desc_b(st + 64 * 128 + kk * 32), desc_b(ones), more);",
        "      (void)d, (void)more;")]
GROUP = [("          acc[T][4 * i + e] = group_step(acc[T][4 * i + e], part[Q][T][4 * i + e], sv[c],\n"
          "                                         e & 1 ? x2.y : x2.x, zv[c]);",
          "          (void)c;"),
         ("        acc[4 * i + e] = group_step(acc[4 * i + e], part[4 * i + e], e >> 1 ? s2.y : s2.x,\n"
          "                                    e & 1 ? x2.y : x2.x, e >> 1 ? z2.y : z2.x);", "        (void)x2;")]
VARIANTS = {
    "kernel": [],
    "no-arith": MMA[:2] + FRAGS + GROUP[:1],
    "no-tiles": TILES,
    "no-convert": CONVERT,
    "no-mma": MMA,
    "no-group": GROUP,
    "no-xsum": XSUM,
    "decode-rows": [("  if (M <= 64 || prefill_blocks < kMinPrefillBlocks)", "  if (M > 0)")],
    "no-pipe": [("  static constexpr bool kPipe = NX <= 32;", "  static constexpr bool kPipe = false;")],
}
# label -> (K, N, projections of that shape a layer)
SHAPES = {"wq/wo": (4096, 4096, 2), "wk/wv": (4096, 1024, 2), "w_gate/w_up": (4096, 12288, 2),
          "w_down": (12288, 4096, 1)}
ROWS = (8, 64, 256, 4096)
GROUP_SIZE = 128


def build() -> dict:
    """{label: ctypes entry}, every nvcc started together."""
    from llms_on_kubernetes_tpu_torch import kernels

    out = ROOT / "_variants" / "build4"
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
        (d / "w4_matmul.cu").write_text(src)
        for header in ("common.cuh", "hopper.cuh"):
            (d / header).write_text((CSRC / header).read_text())
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
               str(d / "lib.so"), str(d / "w4_matmul.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), d / "lib.so")
    fns = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc {label} exited {proc.returncode}:\n{log}")
        if label == "kernel":
            for func, line in cs.ptxas_report(log):
                cs.say(f"  ptxas {func}: {line}")
        serial = [line for line in log.splitlines() if "Performance Loss" in line]
        cs.say(f"  {label}: ptxas serializes the wgmma of {len(serial)} functions")
        fn = ctypes.CDLL(str(lib)).llmk_w4_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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

    def call(fn, x, data, s, zs):
        M, K = x.shape
        N = data.shape[2]
        out = torch.empty((M, N), dtype=x.dtype, device="cuda")
        kernels.check("w4_matmul variant", fn(
            x.data_ptr(), data.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(), M, K, N,
            GROUP_SIZE, 1, kernels.DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream))
        return out

    order = list(fns) + list(fns)[::-1]
    result, forward = {}, {}
    for label, (K, N, per) in SHAPES.items():
        x0 = torch.from_numpy(rng.normal(size=(max(ROWS), K)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        data, s, zs = cs.w4_inputs(torch, rng, K, N, GROUP_SIZE)
        wf = data.view(torch.float32)
        read = timer(lambda: wf.sum(), reps=50)
        result[f"{label} torch.sum"] = read
        cs.say(f"{label} K{K} N{N}: torch.sum over the {K * N / 2e6:.1f} MB packed weight: "
               f"{read:.4f} ms")
        for M in ROWS:
            x = x0[:M]
            cs.check_close(f"kernel {label} M{M}", call(fns["kernel"], x, data, s, zs),
                           q.group_qeinsum_plain(x, data, s, zs, True), "bfloat16")
            ms = {name: [] for name in fns}
            for name in order:
                fn = fns[name]
                ms[name].append(timer(lambda: call(fn, x, data, s, zs), reps=50))
            for name, v in ms.items():
                result[f"{label} M{M} {name}"] = float(np.mean(v))
                forward[(M, name)] = forward.get((M, name), 0.0) + 36 * per * float(np.mean(v))
            cs.say(f"{label} K{K} N{N} M{M}: " + " ".join(
                f"{name}={np.mean(v):.4f}" for name, v in ms.items()))
    for (M, name), v in sorted(forward.items()):
        result[f"forward M{M} {name}"] = v
        cs.say(f"a Qwen3-8B forward's 252 projections at M {M}, {name}: {v:.3f} ms [{card}]")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "w4_variants.json").write_text(
        json.dumps({"card": card, "ms": result}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
