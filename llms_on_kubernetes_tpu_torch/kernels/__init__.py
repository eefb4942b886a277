"""Build, load and count the port's hand-written Hopper kernels.

The CUDA C++ sources live in ``llms_on_kubernetes_tpu_torch/csrc``. Each
``*.cu`` file is compiled on first use by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, in
``llms_on_kubernetes_tpu_torch/_build/`` (git-ignored), under a name keyed
by a hash of the sources and flags, and loaded with ``ctypes``. Every
source that is not built yet is compiled at once, one ``nvcc`` process
each, so a cold start costs the slowest file, not their sum.

Nothing here runs at import time: a machine without ``nvcc`` or a card
imports the package and runs the plain versions on CPU tensors.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_prefill", "paged_decode", "paged_decode_int8")
# no --use_fast_math: the int8 kernel's quantization needs IEEE division
# to store the bytes engine/cache.quantize_kv stores
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are instantiated for (LLMK_DISPATCH_D)
HEAD_DIMS = (8, 16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_prefill": ("llmk_flash_prefill",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _I, _P]),
    "paged_decode": ("llmk_paged_decode",
                     [_P] * 11 + [_I] * 8 + [_F, _I, _F, _I, _I, _P]),
    "paged_decode_int8": ("llmk_paged_decode_int8",
                          [_P] * 13 + [_I] * 8 + [_F, _I, _F, _I, _I, _P]),
}

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_funcs: dict = {}
build_log: dict = {}        # source name -> nvcc output (ptxas register report)


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built on first use on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in ``names`` whose library is missing, all in
    parallel; return {name: library path}. Raises with nvcc's output when
    a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu exited {proc.returncode}:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def function(name: str):
    """The C entry of kernel library ``name``, building it if needed."""
    with _lock:
        fn = _funcs.get(name)
        if fn is None:
            path = build([name])[name]
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _funcs[name] = fn
        return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, *, dtype=None, ndim=None,
                 device=None, align: int = 1) -> None:
    """Raise on anything a kernel does not take: a CPU tensor, another
    card, a dtype or rank it was not built for, a strided view, or a base
    address off the ``align``-byte boundary its vector loads need."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")
