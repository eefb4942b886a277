"""Check and time the W8A16 kernel alone on one NVIDIA GPU: build
``csrc/w8_matmul.cu`` and the unsplit timing variant
(``scripts/w8_matmul_unsplit.cu``) in parallel, print ptxas's register and
spill report and the HMMA count of each bf16 body, then run
``chip_smoke.py``'s W8A16 phase (the split against its Python mirror, the
plain-version checks, batch invariance at every llama-3-8b and
phi-3-mini projection, and the two kernels timed in turns). Exits 1 on any
failure. Run from the root of a checkout:

    python scripts/time_w8_matmul.py
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
    variant = cs.start_variant_build()
    kernels.build(["w8_matmul"])
    unsplit = cs.finish_variant_build(variant)["llmk_w8_matmul_unsplit"]
    cs.say(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.get("w8_matmul", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            cs.say(f"  ptxas w8_matmul: {line.strip()}")
    for body in ("w8_matmul_decode", "w8_matmul_prefill"):
        hmma, funcs = cs.sass_mma_count(kernels.library_path("w8_matmul"), body)
        cs.say(f"sass {body}: {hmma} HMMA instructions in {funcs} functions")
        if not hmma:
            cs.fail(f"{body} has no tensor-core instruction")
    entry = cs.w8_kernels(torch, np.random.default_rng(2), cs.Timer(torch), unsplit)
    cs.say(json.dumps(entry))
    cs.say(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
