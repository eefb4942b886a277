"""Per-tenant deficit-weighted fair queuing for engine admission (the
port's copy of ``llms_on_kubernetes_tpu/engine/qos.py``, kept so the port
imports nothing of the JAX package; tests/test_torch_qos.py holds its pop
order to the JAX queue's).

The admission queue used to be a plain FIFO deque: one tenant submitting a
burst of requests parked every other tenant behind it until the burst
drained — the classic noisy-neighbor failure mode. ``TenantFairQueue``
replaces it with deficit round-robin (DRR) across tenants inside strict
priority classes:

- **Priority classes** (``interactive`` > ``normal`` > ``batch``): the head
  is always drawn from the most important non-empty class, EXCEPT that a
  lower class whose oldest request has waited longer than ``starvation_s``
  preempts the scan (anti-starvation aging — batch work always makes
  progress, just slowly).
- **DRR within a class**: each tenant accumulates ``weight`` deficit per
  round-robin turn and spends 1 per admitted request, so over a backlog
  tenants are served in proportion to their weights regardless of how
  deep any one tenant's queue is. A tenant's deficit resets when its queue
  empties — an idle tenant cannot bank credit.

The queue is API-compatible with the subset of ``collections.deque`` the
engine scheduler uses — ``[0]`` peek, ``popleft``, ``append``,
``appendleft``, ``remove``, ``clear``, iteration, ``len()`` — with one
deliberate strengthening: the ``[0]`` peek is **sticky**. Once a head is
chosen it stays the head until it is actually popped or removed
(``appendleft`` — the preemption requeue — takes the head over, matching
deque semantics). The scheduler peeks the head, tentatively pins resources
(grammar rows, adapter slots) against it, and may bail out without popping;
a head that silently changed between peeks would leak those pins against a
request that is no longer next, and in the worst case livelock admission
behind a tenant whose head can never acquire its pinned resource.

Thread-safety: like the deque it replaces, the queue relies on the
engine's external ``_lock`` for compound operations; individual methods
only touch plain Python structures.
"""

from __future__ import annotations

import collections
import time
from typing import Iterator, Optional

# Most- to least-important. Unknown strings normalize to "normal".
PRIORITIES = ("interactive", "normal", "batch")
_PRIORITY_RANK = {"interactive": 0, "normal": 1, "batch": 2}

# Floor for configured weights: a zero/negative weight would make DRR spin
# forever accumulating deficit for a tenant that never crosses 1.
MIN_WEIGHT = 0.01


def priority_rank(priority: Optional[str]) -> int:
    """0 = interactive, 1 = normal, 2 = batch; unknown/None -> normal."""
    return _PRIORITY_RANK.get(priority or "", 1)


def normalize_priority(priority: Optional[str],
                       default: str = "normal") -> str:
    """Clamp an arbitrary string to a known priority class."""
    p = (priority or "").strip().lower()
    return p if p in _PRIORITY_RANK else (
        default if default in _PRIORITY_RANK else "normal")


class TenantFairQueue:
    """Deque-compatible admission queue: priority classes + per-tenant DRR.

    ``weights`` maps tenant name -> relative weight (default
    ``default_weight`` for unlisted tenants). ``starvation_s`` is the
    anti-starvation aging threshold; <= 0 disables aging (strict priority).
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, weights: Optional[dict] = None,
                 default_weight: float = 1.0,
                 starvation_s: float = 5.0,
                 clock=time.monotonic):
        self._weights = {str(k): max(MIN_WEIGHT, float(v))
                         for k, v in (weights or {}).items()}
        self._default_weight = max(MIN_WEIGHT, float(default_weight))
        self.starvation_s = float(starvation_s)
        self._clock = clock
        # preemption requeues jump every class/tenant: absolute head
        self._front: collections.deque = collections.deque()
        # per-rank DRR state: rank -> tenant -> deque[Request]
        self._queues: list[dict[str, collections.deque]] = [{}, {}, {}]
        self._deficit: list[dict[str, float]] = [{}, {}, {}]
        self._order: list[list[str]] = [[], [], []]  # round-robin order
        self._idx: list[int] = [0, 0, 0]             # current RR position
        self._len = 0
        # sticky head: (request, plan) — plan replays the DRR bookkeeping
        # peek() computed, applied only when the head is actually popped
        self._pick = None
        self._pick_plan = None

    # -- deque-compatible surface --------------------------------------

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator:
        yield from self._front
        for rank in range(3):
            for tenant in self._order[rank]:
                yield from self._queues[rank].get(tenant, ())

    def __getitem__(self, i: int):
        if i != 0:
            raise IndexError(
                "TenantFairQueue supports only head ([0]) indexing")
        head = self.peek()
        if head is None:
            raise IndexError("peek from an empty queue")
        return head

    def append(self, req) -> None:
        tenant, rank = self._key(req)
        q = self._queues[rank].get(tenant)
        if q is None:
            q = self._queues[rank][tenant] = collections.deque()
            self._order[rank].append(tenant)
            self._deficit[rank].setdefault(tenant, 0.0)
        q.append(req)
        self._len += 1

    def appendleft(self, req) -> None:
        """Absolute-front insert (the preemption requeue): the victim must
        re-admit before anything else, whatever its tenant or class."""
        self._front.appendleft(req)
        self._len += 1
        self._pick, self._pick_plan = req, ("front", None, None)

    def popleft(self):
        head = self.peek()
        if head is None:
            raise IndexError("pop from an empty queue")
        kind, rank, tenant = self._pick_plan
        if kind == "front":
            self._front.popleft()
        else:
            q = self._queues[rank][tenant]
            q.popleft()
            if kind == "drr":
                # commit the refills peek() simulated, then spend 1
                self._apply_refills()
                self._deficit[rank][tenant] -= 1.0
            if not q:
                self._drop_tenant(rank, tenant)
            elif kind == "drr" and self._deficit[rank][tenant] < 1.0:
                # deficit exhausted: this tenant's turn is over — advance
                # the RR pointer or the next peek would refill it straight
                # away and it would monopolize the class
                self._idx[rank] = (self._idx[rank] + 1) % len(
                    self._order[rank])
        self._len -= 1
        self._pick = self._pick_plan = None
        return head

    def remove(self, req) -> None:
        if req is self._pick:
            self._pick = self._pick_plan = None
        try:
            self._front.remove(req)
            self._len -= 1
            return
        except ValueError:
            pass
        tenant, rank = self._key(req)
        q = self._queues[rank].get(tenant)
        if q is None:
            raise ValueError("request not in queue")
        q.remove(req)  # raises ValueError if absent
        self._len -= 1
        if not q:
            self._drop_tenant(rank, tenant)

    def clear(self) -> None:
        self._front.clear()
        self._queues = [{}, {}, {}]
        self._deficit = [{}, {}, {}]
        self._order = [[], [], []]
        self._idx = [0, 0, 0]
        self._len = 0
        self._pick = self._pick_plan = None

    # -- scheduling ----------------------------------------------------

    def peek(self):
        """The next request to admit. Sticky: repeated peeks return the
        same request until it is popped/removed (or an appendleft takes
        the head over)."""
        if self._pick is not None:
            return self._pick
        if self._front:
            self._pick, self._pick_plan = self._front[0], ("front", None, None)
            return self._pick
        if self._len == 0:
            return None
        base_rank = next(r for r in range(3) if self._queues[r])
        starved = self._starved_below(base_rank)
        if starved is not None:
            rank, tenant = starved
            self._pick = self._queues[rank][tenant][0]
            self._pick_plan = ("aged", rank, tenant)
            return self._pick
        tenant = self._drr_select(base_rank)
        self._pick = self._queues[base_rank][tenant][0]
        self._pick_plan = ("drr", base_rank, tenant)
        return self._pick

    def _starved_below(self, base_rank: int):
        """(rank, tenant) of the most-starved head in a class BELOW
        base_rank, or None. Starved = head wait > starvation_s."""
        if self.starvation_s <= 0:
            return None
        now = self._clock()
        worst, worst_wait = None, self.starvation_s
        for rank in range(base_rank + 1, 3):
            for tenant, q in self._queues[rank].items():
                wait = now - getattr(q[0], "submitted_at", now)
                if wait > worst_wait:
                    worst, worst_wait = (rank, tenant), wait
        return worst

    def _drr_select(self, rank: int) -> str:
        """Pick the tenant to serve within ``rank`` WITHOUT mutating the
        DRR state; the refills simulated here are stashed and committed by
        popleft() (peek must stay pure — the scheduler peeks repeatedly
        while deciding whether it can admit at all)."""
        order, idx = self._order[rank], self._idx[rank]
        deficit = self._deficit[rank]
        self._pending_refills: list[tuple[int, str, float]] = []
        n = len(order)
        sim = {}
        for _visit in range(n * 101):  # ceil(1/MIN_WEIGHT)+1 turns worst case
            tenant = order[idx % n]
            d = sim.get(tenant, deficit[tenant])
            if d >= 1.0:
                self._idx[rank] = idx % n
                return tenant
            # turn entry: refill by weight, then re-check
            w = self._weights.get(tenant, self._default_weight)
            sim[tenant] = d + w
            self._pending_refills.append((rank, tenant, w))
            if sim[tenant] >= 1.0:
                self._idx[rank] = idx % n
                return tenant
            idx += 1
        # unreachable with weights floored at MIN_WEIGHT; serve RR head
        self._idx[rank] = idx % n
        return order[idx % n]

    def _apply_refills(self) -> None:
        for rank, tenant, w in getattr(self, "_pending_refills", ()):
            if tenant in self._deficit[rank]:
                self._deficit[rank][tenant] += w
        self._pending_refills = []

    # -- internals -----------------------------------------------------

    def _key(self, req) -> tuple[str, int]:
        tenant = str(getattr(req, "tenant", "") or "")
        rank = priority_rank(getattr(req, "priority", None))
        return tenant, rank

    def _drop_tenant(self, rank: int, tenant: str) -> None:
        """A tenant's queue emptied: forget its DRR state (deficit resets
        — credit must not be bankable across idle periods) and its RR
        slot, keeping the RR index pointed at the next survivor."""
        del self._queues[rank][tenant]
        self._deficit[rank].pop(tenant, None)
        order = self._order[rank]
        pos = order.index(tenant)
        order.pop(pos)
        if pos < self._idx[rank]:
            self._idx[rank] -= 1
        if order:
            self._idx[rank] %= len(order)
        else:
            self._idx[rank] = 0
