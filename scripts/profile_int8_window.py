"""Profile the 8-slot llama-3-8b decode window with int8 weights, and
nothing else, in a fresh process on one NVIDIA GPU: the kernels are built,
then ``chip_smoke.phase_profile`` runs with ``quantization="int8"`` (the
window replayed as one CUDA graph and run eagerly, each timed on the host
clock and traced under torch.profiler). ``chip_smoke.py --profile`` runs the
same window after phase 2 and after the bf16-weight window, in one process;
this script shows the window without that history. Run from the root of a
checkout:

    python scripts/profile_int8_window.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from llms_on_kubernetes_tpu_torch import kernels  # noqa: E402

if __name__ == "__main__":
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    kernels.build()
    cs.phase_profile(torch, quantization="int8")
