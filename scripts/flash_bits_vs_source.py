"""Hold the flash prefill kernel without image groups to an earlier
``flash_prefill.cu``, bit for bit, on the card.

    python scripts/flash_bits_vs_source.py OLD_CSRC_DIR

``OLD_CSRC_DIR`` holds an earlier ``flash_prefill.cu`` and the headers it
includes (for example the ``llms_on_kubernetes_tpu_torch/csrc`` of an
unpacked earlier commit). The script builds it with the package's nvcc
flags, binds its C entry (the signature without image spans), and runs it
and the package's kernel (``mm_groups=None``) on the same inputs: float32
and bfloat16, every head dim the kernels are built for, global, windowed
and soft-capped, padded rows and a row of length 0. Every output must be
equal bit for bit. Exits 1 on a difference, 0 after printing the cases.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llms_on_kubernetes_tpu_torch import kernels  # noqa: E402
from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa  # noqa: E402

OLD_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def build_old(src_dir: str):
    out = kernels.BUILD_DIR / "flash_prefill_earlier.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
           str(out), os.path.join(src_dir, "flash_prefill.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc {src_dir}/flash_prefill.cu failed:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(out)).llmk_flash_prefill
    fn.argtypes, fn.restype = OLD_SIGNATURE, ctypes.c_int
    return fn


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        sys.exit("usage: python scripts/flash_bits_vs_source.py OLD_CSRC_DIR (needs a card)")
    old = build_old(argv[0])
    rng = np.random.default_rng(0)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in kernels.HEAD_DIMS:
            for window, cap in ((None, None), (40, None), (None, 30.0)):
                B, T, n_q, n_kv = 2, 200, 8, 2
                q, k, v = (torch.from_numpy(rng.normal(size=(B, T, h, d)).astype(np.float32))
                           .to("cuda", dtype) for h in (n_q, n_kv, n_kv))
                lengths = torch.tensor([200, 0] if d == 64 else [200, 131],
                                       dtype=torch.int32, device="cuda")
                scale = d ** -0.5
                new = fa.flash_prefill_attention(q, k, v, lengths, scale=scale,
                                                 sliding_window=window, attn_softcap=cap)
                ref = torch.empty_like(q)
                err = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                          ref.data_ptr(), B, T, n_q, n_kv, d, scale, int(window or 0),
                          float(cap or 0.0), kernels.DTYPE_CODES[dtype],
                          torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err:
                    sys.exit(f"the earlier kernel returned CUDA error {err}")
                rows = [(0, 200), (1, int(lengths[1]))]
                same = all(torch.equal(new[b, :n], ref[b, :n]) for b, n in rows)
                print(f"{str(dtype)[6:]} d {d} window {window} softcap {cap}: "
                      f"{'bit-equal' if same else 'DIFFERENT'}")
                if not same:
                    return 1
                cases += 1
    print(f"{cases} cases bit-equal to {argv[0]}/flash_prefill.cu "
          f"[{torch.cuda.get_device_name(0)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
