"""Check and time the W4A16 kernel alone on one NVIDIA GPU: build
``csrc/w4_matmul.cu`` and ``csrc/w8_matmul.cu`` in parallel, print
ptxas's register and spill report and the HMMA count of the bf16 body,
then run ``chip_smoke.py``'s W4A16 phase (the split against its Python
mirror, the plain-version checks, batch invariance at Qwen3-8B's seven
projections, int8 storage, the refusals, and the timings in turns beside
the W8A16 kernel and bf16 ``torch.matmul``). Exits 1 on any failure. Run
from the root of a checkout:

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
    kernels.build(["w4_matmul", "w8_matmul"])
    cs.say(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.get("w4_matmul", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            cs.say(f"  ptxas w4_matmul: {line.strip()}")
    hmma, funcs = cs.sass_mma_count(kernels.library_path("w4_matmul"), "w4_matmul_tc")
    cs.say(f"sass w4_matmul_tc: {hmma} HMMA instructions in {funcs} functions")
    if not hmma:
        cs.fail("w4_matmul_tc has no tensor-core instruction")
    entry = cs.w4_kernels(torch, np.random.default_rng(3), cs.Timer(torch))
    cs.say(json.dumps(entry))
    cs.say(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
