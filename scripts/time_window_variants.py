#!/usr/bin/env python3
"""Time builds of the windowed KV append source side by side on one GPU.

    python scripts/time_window_variants.py LABEL=DIR[:FLAG,FLAG...] ...

Each variant is ``DIR/paged_write_window.cu`` (beside its headers) built
with the port's nvcc flags, ``-Xcompiler -fno-gnu-unique`` (two builds of
one template in one process must not share its static locals) and the
given flags (``-DNAME`` switches of a patched copy of the source, kept in
a git-ignored directory such as ``_variants/``). A variant whose flags
include ``-DVAR_ROWS`` and whose library exports ``int llmk_var_rows``
gets the shape's largest width there before each shape (a grid with no
threads for rows past the width).

Every variant is timed through the port's wrapper (its C entry swapped
into ``kernels._funcs``) with ``chip_smoke.Timer``, 100 launches, at
``chip_smoke.window_shapes()``, in turns A B ... B A within one process,
beside the timer's floor. Each variant is also held against the plain
version once and reported exact or not (a variant that drops the loads or
the stores is not, by design). Results go to stdout and, as JSON, to
``chiprun_out/window_variants.json``.
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


def build(variants: dict) -> dict:
    """{label: ctypes function}, all nvcc runs started together."""
    from llms_on_kubernetes_tpu_torch import kernels

    out_dir = ROOT / "_variants" / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, flags) in variants.items():
        lib = out_dir / f"{label}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", *flags,
               "-o", str(lib), str(Path(src) / "paged_write_window.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    fns = {}
    symbol, argtypes = kernels._SIGNATURES["paged_write_window"]
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc {label} exited {proc.returncode}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.say(f"  ptxas {label}: {line.strip()}")
        dll = ctypes.CDLL(str(lib))
        fn = getattr(dll, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        try:
            rows = ctypes.c_int.in_dll(dll, "llmk_var_rows")
        except ValueError:
            rows = None
        fns[label] = (fn, rows if "-DVAR_ROWS" in variants[label][1] else None)
    return fns


def main(argv) -> int:
    import torch

    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    variants = {}
    for spec in argv:
        label, _, rest = spec.partition("=")
        src, _, flags = rest.partition(":")
        variants[label] = (src, [f for f in flags.split(",") if f])
    if not variants:
        cs.fail("give at least one LABEL=DIR[:FLAGS] variant")
    card = cs.card_line()
    cs.say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    fns = build(variants)
    timer = cs.Timer(torch)
    tiny = torch.zeros(8, device="cuda")
    floor = [timer(lambda: tiny.add_(1), reps=50)]
    rng = np.random.default_rng(0)
    shapes = cs.window_shapes()
    order = list(fns) + list(fns)[::-1]
    results: dict = {}
    for int8, name in ((False, pw.KERNEL), (True, pw.KERNEL_INT8)):
        kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
        plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
        for shape, kw in shapes.items():
            kernels._funcs[pw.SOURCE] = fns[order[0]][0]     # the setup's check: variant A
            pool, args, kn, vn = cs.window_case(torch, rng, f"{name} {shape}", int8=int8,
                                                pool_dtype=torch.bfloat16,
                                                new_dtype=torch.bfloat16, **kw,
                                                **cs.WINDOW_FIXED)
            row = results.setdefault(f"{name} {shape}", {})
            for label in order:
                fn, rows = fns[label]
                kernels._funcs[pw.SOURCE] = fn
                if rows is not None:
                    rows.value = max(kw["widths"])
                if label not in row:
                    got = [t.clone() for t in pool]
                    ref = [t.clone() for t in pool]
                    kernel(*got, *args, kn, vn)
                    plain(*ref, *args, kn, vn)
                    torch.cuda.synchronize()
                    exact = all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(got, ref))
                    row[label] = {"exact": exact, "ms": []}
                    del got, ref
                row[label]["ms"].append(timer(lambda: kernel(*pool, *args, kn, vn), reps=100))
                if rows is not None:
                    rows.value = 0
            kernels._funcs.pop(pw.SOURCE, None)
            cs.say(f"{name} {shape}: " + "; ".join(
                f"{lb} {' / '.join(f'{t:.4f}' for t in r['ms'])}"
                f"{'' if r['exact'] else ' (not exact)'}" for lb, r in row.items()))
    floor.append(timer(lambda: tiny.add_(1), reps=50))
    cs.say(f"timer floor (one add_ on 8 floats), before / after: "
           f"{floor[0]:.4f} / {floor[1]:.4f} ms [{card}]")
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/window_variants.json", "w") as f:
        json.dump({"card": card, "floor_ms": floor, "variants": {k: [v[0], v[1]] for k, v in
                                                                 variants.items()},
                   "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
