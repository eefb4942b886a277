"""A safetensors reader on numpy alone (counterpart of the JAX package's
``engine/weights._open_safetensors`` and its native mmap bridge,
``engine/native_loader.py``).

The machine with the card has no ``safetensors`` package, so the port
reads the format itself: 8 bytes of little-endian header length, a JSON
header naming each tensor's dtype, shape and ``[begin, end)`` byte range
in the data that follows, then the raw bytes. Each file's data is mapped
once with ``numpy.memmap`` and a tensor is a view of its range: nothing is
read from disk until a tensor's bytes are used, and nothing is copied
before the caller copies (to the card, or to a transposed layout).

dtypes: F64, F32, F16, BF16, I64, I32, I16, I8, U8 and BOOL. A BF16
tensor is read as ``uint16`` and viewed as ``torch.bfloat16``: the card's
machine has no ``ml_dtypes`` either.

The header is checked before any tensor is handed out: ranges must tile
the data exactly (sorted by start, no overlap, no gap, ending where the
file ends) and each range must hold its shape's bytes.
"""

from __future__ import annotations

import json
import pathlib
import warnings
from typing import Callable

import numpy as np
import torch

# safetensors dtype -> (numpy storage dtype, torch dtype)
DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
# the safetensors format's own cap on the header
MAX_HEADER_BYTES = 100_000_000


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


class SafetensorsFile:
    """One ``*.safetensors`` file: its header, checked, and its data
    mapped read-only. ``tensor(name)`` is a zero-copy CPU tensor."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise SafetensorsError(f"{self.path}: shorter than the 8-byte header length")
            n = int.from_bytes(head, "little")
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise SafetensorsError(f"{self.path}: header length {n} runs past the file "
                                       f"({size} bytes)")
            try:
                header = json.loads(f.read(n))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise SafetensorsError(f"{self.path}: header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise SafetensorsError(f"{self.path}: header is not a JSON object")
        self.metadata = header.pop("__metadata__", None) or {}
        self.data_start = 8 + n
        self.entries = {name: self._entry(name, e) for name, e in header.items()}
        self._check_tiling(size - self.data_start)
        data_size = size - self.data_start
        self._data = (np.memmap(self.path, dtype=np.uint8, mode="r", offset=self.data_start,
                                shape=(data_size,)) if data_size else np.zeros(0, np.uint8))

    def _entry(self, name: str, e) -> tuple:
        if not isinstance(e, dict) or set(e) < {"dtype", "shape", "data_offsets"}:
            raise SafetensorsError(f"{self.path}: tensor {name!r} lacks dtype, shape or "
                                   f"data_offsets")
        if e["dtype"] not in DTYPES:
            raise SafetensorsError(f"{self.path}: tensor {name!r} has dtype {e['dtype']!r}; "
                                   f"the reader takes {sorted(DTYPES)}")
        shape, offsets = e["shape"], e["data_offsets"]
        if (not isinstance(shape, list) or not all(isinstance(x, int) and x >= 0 for x in shape)
                or not isinstance(offsets, list) or len(offsets) != 2
                or not all(isinstance(x, int) and x >= 0 for x in offsets)
                or offsets[0] > offsets[1]):
            raise SafetensorsError(f"{self.path}: tensor {name!r} has a bad shape {shape!r} "
                                   f"or data_offsets {offsets!r}")
        np_dtype = DTYPES[e["dtype"]][0]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(np_dtype).itemsize
        if offsets[1] - offsets[0] != nbytes:
            raise SafetensorsError(f"{self.path}: tensor {name!r} of shape {shape} and dtype "
                                   f"{e['dtype']} needs {nbytes} bytes, its range holds "
                                   f"{offsets[1] - offsets[0]}")
        return e["dtype"], tuple(shape), offsets[0], offsets[1]

    def _check_tiling(self, data_size: int) -> None:
        pos = 0
        for name, (_, _, b, e) in sorted(self.entries.items(), key=lambda kv: kv[1][2:]):
            if b < pos:
                raise SafetensorsError(f"{self.path}: tensor {name!r} at bytes [{b}, {e}) "
                                       f"overlaps the one before it (ends at {pos})")
            if b > pos:
                raise SafetensorsError(f"{self.path}: bytes [{pos}, {b}) before tensor "
                                       f"{name!r} belong to no tensor")
            pos = e
        if pos != data_size:
            raise SafetensorsError(f"{self.path}: the tensors end at byte {pos} of the data, "
                                   f"the file holds {data_size}")

    def keys(self) -> list[str]:
        return list(self.entries)

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU tensor over the mapped bytes: read-only, the
        caller must not write to it."""
        dtype, shape, b, e = self.entries[name]
        arr = self._data[b:e].view(DTYPES[dtype][0]).reshape(shape)
        with warnings.catch_warnings():
            # torch warns that the mapping is read-only; nothing writes to it
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if dtype == "BF16" else t


def open_dir(model_dir) -> dict[str, Callable[[], torch.Tensor]]:
    """Name -> loader over every ``*.safetensors`` file of a directory, as
    the JAX ``_open_safetensors`` globs them. A name in two files
    raises."""
    files = sorted(pathlib.Path(model_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {model_dir}")
    loaders: dict[str, Callable[[], torch.Tensor]] = {}
    for path in files:
        f = SafetensorsFile(path)
        for name in f.keys():
            if name in loaders:
                raise SafetensorsError(f"tensor {name!r} is in two files of {model_dir}")
            loaders[name] = (lambda f=f, n=name: f.tensor(n))
    return loaders
