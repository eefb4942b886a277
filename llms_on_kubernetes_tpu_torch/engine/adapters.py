"""Multi-tenant LoRA adapters: PEFT loading and the device-slot LRU
(counterpart of ``llms_on_kubernetes_tpu/engine/adapters.py``, a copy of
its pure-Python parts).

One engine serves many fine-tunes of its base model: each configured
adapter is a local PEFT directory (``adapter_config.json`` and
``adapter_model.safetensors``; the port downloads nothing), validated
against the base model's shapes and uploaded into one of a fixed number of
device slots of the per-target ``ops/lora.LoRAStack``s. Requests name an
adapter; admission pins its slot for the request's lifetime (refcounted),
and slots are recycled least recently used when a new adapter needs one.
A slot change is a copy into the stacks in place: the captured windows
never change.

The safetensors file is read with the port's own reader
(``engine/safetensors.py``); the machine with the card has no
``safetensors`` package. Stats (hits, misses, evictions, load seconds) are
host counters the server bridges into ``llm_adapter_cache_*``.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from llms_on_kubernetes_tpu_torch.engine.safetensors import SafetensorsFile

# targets the engine can attach stacks for: our weight name -> the PEFT
# module suffix that maps to it
PEFT_MODULES = {
    "wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj",
    "w_gate": "gate_proj", "w_up": "up_proj", "w_down": "down_proj",
}
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")

_TENSOR_RE = re.compile(
    r"layers\.(\d+)\.(?:self_attn|mlp)\.([a-z_]+)_proj\.lora_([AB])\.weight$")


class AdapterError(ValueError):
    """A configured adapter failed to load or validate (corrupt file,
    rank/shape mismatch, unsupported target)."""


@dataclass
class LoadedAdapter:
    """Host-cached, validated factors for one adapter, already in the
    engine's layouts and padded to the stack rank (alpha/r folded into b)."""

    name: str
    rank: int
    alpha: float
    # target -> (a [L, *in_dims, max_rank] f32, b [L, max_rank, *out_dims] f32)
    factors: dict = field(default_factory=dict)


def _expected_shapes(cfg) -> dict:
    """Per-target (A, B) tensor shapes of ONE layer in PEFT layout
    (lora_A [r, in_features], lora_B [out_features, r])."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
        "wo": (H * hd, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
    }


def _to_engine_layout(target: str, which: str, w: np.ndarray, cfg):
    """One PEFT tensor -> the engine's factor layout for ``target``.

    A [r, in] -> a [*in_dims, r];  B [out, r] -> b [r, *out_dims] — with
    in/out factored into the decoder's explicit head axes."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w = np.asarray(w, np.float32)
    if which == "A":
        a = w.T  # [in, r]
        if target == "wo":
            return a.reshape(H, hd, -1)
        return a
    b = w.T  # [r, out]
    if target in ("wq",):
        return b.reshape(b.shape[0], H, hd)
    if target in ("wk", "wv"):
        return b.reshape(b.shape[0], KV, hd)
    return b


def load_adapter(name: str, adapter_dir: str, cfg, max_rank: int,
                 targets: tuple = DEFAULT_TARGETS) -> LoadedAdapter:
    """Read + validate a PEFT LoRA checkpoint against the base model.

    Rejects (``AdapterError``): unreadable/corrupt safetensors, a config
    rank that disagrees with the tensors, rank > the engine's stack rank,
    tensors for targets the engine has no stack for, wrong shapes, and an
    A without its B (or vice versa). The result is zero-padded to
    ``max_rank`` and carries the alpha/r scale folded into ``b`` so upload
    is a plain buffer copy.
    """
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    try:
        with open(cfg_path) as f:
            acfg = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise AdapterError(f"adapter {name!r}: bad adapter_config.json: {e}")
    rank = int(acfg.get("r", 0))
    alpha = float(acfg.get("lora_alpha", rank))
    if rank <= 0:
        raise AdapterError(f"adapter {name!r}: invalid rank r={rank}")
    if rank > max_rank:
        raise AdapterError(
            f"adapter {name!r}: rank {rank} exceeds the engine's adapter "
            f"rank capacity {max_rank} (raise --adapter-rank)")

    module_to_target = {v: k for k, v in PEFT_MODULES.items()}
    st_path = os.path.join(adapter_dir, "adapter_model.safetensors")
    try:
        tensors: dict[tuple, np.ndarray] = {}
        st = SafetensorsFile(st_path)
        for key in st.keys():
            m = _TENSOR_RE.search(key)
            if m is None:
                raise AdapterError(
                    f"adapter {name!r}: unrecognized tensor {key!r}")
            layer, module, which = int(m.group(1)), m.group(2), m.group(3)
            target = module_to_target.get(module + "_proj")
            if target is None:
                raise AdapterError(
                    f"adapter {name!r}: unsupported module "
                    f"{module}_proj in {key!r}")
            if target not in targets:
                raise AdapterError(
                    f"adapter {name!r}: target {target} ({module}_proj) "
                    f"is not enabled on this engine "
                    f"(enabled: {','.join(targets)})")
            if layer >= cfg.num_layers:
                raise AdapterError(
                    f"adapter {name!r}: layer {layer} out of range for "
                    f"{cfg.num_layers}-layer base model")
            tensors[(target, layer, which)] = st.tensor(key).float().numpy()
    except AdapterError:
        raise
    except Exception as e:  # unreadable / truncated / not safetensors
        raise AdapterError(
            f"adapter {name!r}: cannot read {st_path}: {e}")
    if not tensors:
        raise AdapterError(f"adapter {name!r}: no LoRA tensors found")

    expect = _expected_shapes(cfg)
    L = cfg.num_layers
    factors: dict = {}
    seen_targets = sorted({t for t, _, _ in tensors})
    for target in seen_targets:
        in_f, out_f = expect[target]
        a_one = _to_engine_layout(target, "A",
                                  np.zeros((rank, in_f)), cfg)
        b_one = _to_engine_layout(target, "B",
                                  np.zeros((out_f, rank)), cfg)
        a = np.zeros((L,) + a_one.shape[:-1] + (max_rank,), np.float32)
        b = np.zeros((L, max_rank) + b_one.shape[1:], np.float32)
        for layer in range(L):
            wa = tensors.get((target, layer, "A"))
            wb = tensors.get((target, layer, "B"))
            if (wa is None) != (wb is None):
                raise AdapterError(
                    f"adapter {name!r}: layer {layer} {target} has lora_"
                    f"{'A' if wa is None else 'B'} missing")
            if wa is None:
                continue
            if tuple(wa.shape) != (rank, in_f):
                raise AdapterError(
                    f"adapter {name!r}: {target} layer {layer} lora_A shape "
                    f"{tuple(wa.shape)} != expected {(rank, in_f)} "
                    f"(rank/shape mismatch)")
            if tuple(wb.shape) != (out_f, rank):
                raise AdapterError(
                    f"adapter {name!r}: {target} layer {layer} lora_B shape "
                    f"{tuple(wb.shape)} != expected {(out_f, rank)} "
                    f"(rank/shape mismatch)")
            a[layer, ..., :rank] = _to_engine_layout(target, "A", wa, cfg)
            # alpha/r folds into b so the batched path needs no extra scale
            b[layer, :rank] = _to_engine_layout(
                target, "B", wb, cfg) * (alpha / rank)
        factors[target] = (a, b)
    return LoadedAdapter(name=name, rank=rank, alpha=alpha, factors=factors)


class AdapterManager:
    """Name -> device-slot residency with LRU recycling.

    ``acquire`` returns the adapter's slot, loading + uploading on a miss
    (evicting the least-recently-used UNPINNED slot if none is free), or
    None when every slot is pinned by running requests — the admission
    waits, exactly like grammar-table or page-pool pressure. ``release``
    drops a request's pin. Loaded factors are host-cached, so re-loading
    an evicted adapter is an upload, not a disk read.
    """

    def __init__(self, registry: dict, num_slots: int,
                 loader: Callable[[str, str], LoadedAdapter],
                 upload: Callable[[int, LoadedAdapter], None]):
        self.registry = dict(registry)
        self.num_slots = int(num_slots)
        self._loader = loader
        self._upload = upload
        self.slot_name: list[Optional[str]] = [None] * self.num_slots
        self.slot_refs = [0] * self.num_slots
        self._slot_touch = [0] * self.num_slots
        self._tick = 0
        self._host_cache: dict[str, LoadedAdapter] = {}
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}
        self.load_times: list[float] = []  # drained by the metrics bridge

    def known(self, name: str) -> bool:
        return name in self.registry

    def names(self) -> list[str]:
        return sorted(self.registry)

    def slot_of(self, name: str) -> Optional[int]:
        try:
            return self.slot_name.index(name)
        except ValueError:
            return None

    def acquire(self, name: str) -> Optional[int]:
        if name not in self.registry:
            raise KeyError(f"adapter {name!r} is not configured")
        slot = self.slot_of(name)
        if slot is not None:
            self.stats["hits"] += 1
            self._pin(slot)
            return slot
        # miss: free slot first, else LRU among unpinned residents
        victims = [s for s in range(self.num_slots)
                   if self.slot_name[s] is None]
        if not victims:
            victims = sorted(
                (s for s in range(self.num_slots) if self.slot_refs[s] == 0),
                key=lambda s: self._slot_touch[s])
        if not victims:
            return None  # every slot pinned by running requests; wait
        slot = victims[0]
        self.stats["misses"] += 1
        if self.slot_name[slot] is not None:
            self.stats["evictions"] += 1
        t0 = time.perf_counter()
        loaded = self._host_cache.get(name)
        if loaded is None:
            loaded = self._loader(name, self.registry[name])
            self._host_cache[name] = loaded
        self._upload(slot, loaded)
        self.load_times.append(time.perf_counter() - t0)
        self.slot_name[slot] = name
        self.slot_refs[slot] = 0
        self._pin(slot)
        return slot

    def release(self, slot: int) -> None:
        if 0 <= slot < self.num_slots and self.slot_refs[slot] > 0:
            self.slot_refs[slot] -= 1

    def _pin(self, slot: int) -> None:
        self.slot_refs[slot] += 1
        self._tick += 1
        self._slot_touch[slot] = self._tick
