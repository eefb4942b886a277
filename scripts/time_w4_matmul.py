"""Check and time the W4A16 kernel alone on one NVIDIA GPU: build
``csrc/w4_matmul.cu``, ``csrc/w8_matmul.cu`` and the kernel's earlier body kept as a
timing variant (``scripts/w4_matmul_simple.cu``) in parallel, print
ptxas's registers and spills of every W4A16 body and the HGMMA count of
the two bf16 bodies, then run ``chip_smoke.py``'s W4A16 phase (the split
against its Python mirror, the plain-version checks, batch invariance
across both bf16 bodies at Qwen3-8B's seven projections and at narrow
shapes, int8 storage, one kernel node a captured call, the refusals, and
the timings in turns beside that earlier body, the W8A16 kernel and bf16
``torch.matmul``). Exits 1 on any failure. Run from the root of a
checkout:

    python scripts/time_w4_matmul.py
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from llms_on_kubernetes_tpu_torch import kernels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    cs.say(f"card: {cs.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    variant = cs.start_variant_build(cs.W4_VARIANT)
    kernels.build(["w4_matmul", "w8_matmul"])
    simple = cs.finish_variant_build(variant)
    cs.say(f"build: {time.perf_counter() - t0:.1f} s")
    for func, line in cs.ptxas_report(kernels.build_log.get("w4_matmul", "")):
        cs.say(f"  ptxas w4_matmul {func}: {line}")
    for body in ("w4_matmul_decode", "w4_matmul_prefill"):
        hgmma, funcs = cs.sass_mma_count(kernels.library_path("w4_matmul"), body, "HGMMA")
        cs.say(f"sass {body}: {hgmma} HGMMA instructions in {funcs} functions")
        if not hgmma:
            cs.fail(f"{body} has no wgmma (HGMMA) instruction")
    entry = cs.w4_kernels(torch, np.random.default_rng(3), cs.Timer(torch), simple)
    cs.say(json.dumps(entry))
    cs.say(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
