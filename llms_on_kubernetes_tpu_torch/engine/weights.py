"""Parameter conversion (counterpart of ``llms_on_kubernetes_tpu/engine/weights.py``).

``params_from_numpy`` turns a parameter tree of numpy arrays, laid out as
the JAX ``init_params`` lays it out (nested dicts, layer-stacked, head
axes explicit), into the port's parameters with identical layouts. A
caller holding JAX arrays converts them to numpy first, so the port never
sees JAX. The safetensors checkpoint loader is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.engine.cache import torch_dtype


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)    # a writable copy: torch does not wrap read-only buffers
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, device="cuda", dtype: Optional[str] = None) -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device``, cast to ``dtype`` when given (else kept as they are)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = _tensor(tree)
    return t.to(device=dev, dtype=dt) if dt is not None else t.to(dev)
