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
(``count``) where it launches its kernel and nowhere else, so a run can
show that its main path went through the kernels. A CUDA graph replay runs
no Python, so whoever captures one counts the capture's launches apart
(``counting_apart``, in the capturing thread only) and adds them on every
replay (``add_launches``), in ``LAUNCHES`` and in ``REPLAYED``: a kernel's
launches less its replayed ones are the launches it made eagerly.

``COMPILES`` records the port's compile events, (kind, seconds): each
parallel ``nvcc`` build ("nvcc:<source>,...", its wall time) and each CUDA
graph capture
("graph:<name>", ``note_compile`` from ``engine/graphs.py``). The server's
runtime telemetry counts them under the JAX server's compile series.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_prefill", "paged_decode", "paged_decode_int8", "paged_write_window",
           "w8_matmul", "w4_matmul", "moe_experts", "moe_experts_w8")
# no --use_fast_math: the int8 kernels' quantization (csrc/quantize.cuh)
# needs IEEE division to store the bytes engine/cache.quantize_kv stores
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# pool storage codes: the float codes plus int8 (LLMK_I8)
POOL_CODES = {**DTYPE_CODES, torch.int8: 2}
# head dims the kernels are instantiated for (LLMK_DISPATCH_D): 96 is
# phi-3's, 256 gemma-2's
HEAD_DIMS = (8, 16, 32, 64, 96, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_prefill": ("llmk_flash_prefill",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _P, _P, _I, _P]),
    "paged_decode": ("llmk_paged_decode",
                     [_P] * 10 + [_I] * 8 + [_F, _I, _F, _I, _I, _P]),
    "paged_decode_int8": ("llmk_paged_decode_int8",
                          [_P] * 12 + [_I] * 8 + [_F, _I, _F, _I, _I, _P]),
    "paged_write_window": ("llmk_paged_write_window", [_P] * 9 + [_I] * 9 + [_P]),
    "w8_matmul": ("llmk_w8_matmul", [_P] * 4 + [_I] * 4 + [_P]),
    "w4_matmul": ("llmk_w4_matmul", [_P] * 5 + [_I] * 6 + [_P]),
    "moe_experts": ("llmk_moe_experts", [_P] * 8 + [_I] * 5 + [_P]),
    "moe_experts_w8": ("llmk_moe_experts_w8", [_P] * 11 + [_I] * 5 + [_P]),
}
# further C entries of a kernel library: name -> (library, symbol, argtypes)
_EXTRA_ENTRIES = {
    "w8_splits": ("w8_matmul", "llmk_w8_splits", [_I, _I]),   # the K split's slice count
    "w4_splits": ("w4_matmul", "llmk_w4_splits", [_I, _I, _I]),
    "moe_splits": ("moe_experts", "llmk_moe_splits", [_I, _I]),  # the K split's slice count
    "moe_rows": ("moe_experts", "llmk_moe_rows", [_I, _I, _I]),  # rows a tile
    # the int8 decode body's cluster size
    "moe_spread": ("moe_experts_w8", "llmk_moe_spread", [_I, _I, _I, _I, _I]),
}

LAUNCHES: "collections.Counter[str]" = collections.Counter()
# the part of LAUNCHES that graph replays added
REPLAYED: "collections.Counter[str]" = collections.Counter()
# the Counter of this thread's open counting_apart block, if any
_apart = threading.local()

_lock = threading.Lock()
_funcs: dict = {}
COMPILES: list = []         # (kind, seconds), in the order they happened
build_log: dict = {}        # source name -> nvcc output (ptxas register report)


def count(name: str) -> None:
    """Count one launch of kernel ``name``: in the calling thread's open
    ``counting_apart`` Counter, else in ``LAUNCHES``."""
    counter = getattr(_apart, "counter", None)
    (LAUNCHES if counter is None else counter)[name] += 1


def note_compile(kind: str, seconds: float) -> None:
    """Record one compile event (an nvcc build, a graph capture)."""
    COMPILES.append((kind, float(seconds)))


def reset_launches() -> None:
    LAUNCHES.clear()
    REPLAYED.clear()


def launch_counts() -> dict:
    return dict(LAUNCHES)


def replayed_counts() -> dict:
    return dict(REPLAYED)


@contextlib.contextmanager
def counting_apart():
    """Count the calling thread's launches in the block in the Counter it
    yields instead of in ``LAUNCHES`` (for a warm-up, whose launches count
    nowhere, and a graph capture, whose launches count once per replay).
    Other threads' launches go on counting in ``LAUNCHES``."""
    outer = getattr(_apart, "counter", None)
    counted: "collections.Counter[str]" = collections.Counter()
    _apart.counter = counted
    try:
        yield counted
    finally:
        _apart.counter = outer


def add_launches(counts) -> None:
    """Count ``counts`` (one replay of a captured graph's launches)."""
    LAUNCHES.update(counts)
    REPLAYED.update(counts)


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
    parallel; return {name: library path}. nvcc's output goes to
    ``build_log`` and beside the library (``.log``), from where a library
    already built fills ``build_log``. Raises with nvcc's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, path in paths.items():
        if path.exists():
            log = path.with_suffix(".log")
            if n not in build_log and log.exists():
                build_log[n] = log.read_text()
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
            paths[n].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[n])
    if procs:
        # one event for the parallel build: its wall time, not the sum of
        # the overlapping nvcc processes'
        note_compile("nvcc:" + ",".join(procs), time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def function(name: str):
    """The C entry ``name``: a kernel library's launch entry, or one of
    ``_EXTRA_ENTRIES``; builds its library if needed."""
    with _lock:
        fn = _funcs.get(name)
        if fn is None:
            if name in _SIGNATURES:
                lib, (symbol, argtypes) = name, _SIGNATURES[name]
            else:
                lib, symbol, argtypes = _EXTRA_ENTRIES[name]
            path = build([lib])[lib]
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
