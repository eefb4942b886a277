"""A replica's share of the QoS semantics (the port's copy of the parts of
``llms_on_kubernetes_tpu/server/qos.py`` a serving replica uses).

- **Tenant identity** (``tenant_of``): the request body's ``user`` field
  (a non-empty string), else the requested ``model`` string verbatim,
  else the served model's name.
- **Priority** (``resolve_priority``): a valid ``X-LLMK-Priority`` header
  (interactive / normal / batch, case-insensitive) wins; else the
  tenant's configured priority; else the configured default. The routers
  strip a client's header and forward the resolved value, so the
  engine's fair queue and the edge agree.
- **Retry-After** (``retry_after_s``): whole seconds in [1, 60], shared by
  the queue-full 429 (``code=overloaded``) and the routers' 429s.

The edge gate (token buckets, the brownout ladder) belongs to the routers:
``llkt-router`` carries it, so it is not here. tests/test_torch_qos.py
holds these functions to every replica-side check of
``tests/data/qos_vectors.json``.
"""

from __future__ import annotations

import math
from typing import Optional

from llms_on_kubernetes_tpu_torch.engine.qos import (  # re-exported: one spelling
    PRIORITIES, normalize_priority, priority_rank,
)

__all__ = [
    "PRIORITIES", "PRIORITY_HEADER", "DEFAULT_TOKEN_CHARGE", "default_token_charge",
    "normalize_priority", "priority_rank", "resolve_priority", "retry_after_s",
    "tenant_of",
]

PRIORITY_HEADER = "X-LLMK-Priority"

# tokens-per-minute charge for a request that names no max_tokens
DEFAULT_TOKEN_CHARGE = 16


def default_token_charge(doc: Optional[dict]) -> int:
    """The generated-tokens charge for one request: its ``max_tokens``
    when that is a positive number, else DEFAULT_TOKEN_CHARGE."""
    mt = (doc or {}).get("max_tokens")
    if isinstance(mt, (int, float)) and not isinstance(mt, bool) and mt > 0:
        return int(mt)
    return DEFAULT_TOKEN_CHARGE


def retry_after_s(seconds: float) -> int:
    """Retry-After in whole seconds, never below 1 (clients would
    hot-loop) nor above 60 (a parked client re-probes within the SLO
    window)."""
    return max(1, min(60, int(math.ceil(seconds))))


def tenant_of(doc: Optional[dict], resolved_model: str) -> str:
    """The fair-queue tenant: body ``user``, else the requested model
    string (so base:adapter tenants separate), else the served model."""
    if doc:
        user = doc.get("user")
        if isinstance(user, str) and user:
            return user
        model = doc.get("model")
        if isinstance(model, str) and model:
            return model
    return resolved_model


def resolve_priority(header_value: Optional[str], tenant_priority: Optional[str],
                     default_priority: str = "normal") -> str:
    """Header (when valid) > tenant config > default. An invalid header
    falls through to the config: a typo must not grant or deny priority."""
    if header_value is not None:
        p = header_value.strip().lower()
        if p in PRIORITIES:
            return p
    if tenant_priority is not None:
        p = str(tenant_priority).strip().lower()
        if p in PRIORITIES:
            return p
    return normalize_priority(default_priority)
