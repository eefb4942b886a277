"""The serving engine: continuous batching over bucketed prefill and fused
multi-step decode (counterpart of ``llms_on_kubernetes_tpu/engine/engine.py``).

The public surface keeps the JAX engine's names: ``EngineConfig`` (same
field names and defaults for the fields it keeps, plus ``device``),
``SamplingParams``, ``Request``, ``StepEvent`` and
``Engine.submit/step/abort/has_work/generate``.

One scheduler iteration (``step``):

1. reap aborted requests;
2. admit waiting requests into free slots, reserving pages for
   ``prompt + max_tokens`` up front (so decode never runs out of pages and
   never preempts), and prefill them: one ``forward_prefill`` call per
   prefill bucket, the rows padded to the smallest bucket that fits, the
   first token sampled on the device;
3. run one decode window over every active slot: ``decode_steps`` chained
   ``forward_decode`` + ``sample`` iterations with no host sync between
   them. Per-row budgets and stop ids mask a row on the device the moment
   it finishes (its length drops to 0, so its KV write goes to the trash
   page and its counts stop), and one device-to-host copy at the end
   brings back the window's tokens. The host stays authoritative for
   finishes.

The scheduler is synchronous. The JAX engine's async harvester, pacing,
prefix cache, host KV tier, QoS, ledger, grammar, LoRA, speculation,
chunked prefill and preemption are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Any, Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import ModelConfig, get_config
from llms_on_kubernetes_tpu_torch.engine.cache import (
    CacheConfig, PageAllocator, init_pages,
)
from llms_on_kubernetes_tpu_torch.engine.sampling import (
    MAX_CANDIDATES, gumbel_noise, sample,
)
from llms_on_kubernetes_tpu_torch.models.decoder import (
    forward_decode, forward_prefill, init_params,
)

Params = dict[str, Any]

# stop ids a request may carry into the decode window's on-device mask
STOP_SLOTS = 8
KV_WRITE_STRATEGIES = ("dus", "fused")


class QueueFullError(RuntimeError):
    """Admission rejected: the waiting queue is at max_waiting capacity.
    The API layer maps this to HTTP 429."""


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 => off; > MAX_CANDIDATES is rejected at submit
    top_p: float = 1.0
    max_tokens: int = 128
    stop_token_ids: tuple[int, ...] = ()
    seed: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0


@dataclasses.dataclass
class EngineConfig:
    model: str = "debug-tiny"
    dtype: str = "bfloat16"
    max_decode_slots: int = 8
    page_size: int = 64
    num_pages: int = 512
    pages_per_slot: int = 32
    prefill_buckets: tuple[int, ...] = (64, 256, 1024)
    max_waiting: int = 256
    # "dus": write_tokens then the decode kernel; "fused": the decode
    # kernel that appends the current token as it attends
    kv_write: str = "dus"
    decode_steps: int = 4
    seed: int = 0
    # "cuda" (the default) raises without a GPU; pass "cpu" for the CPU
    device: str = "cuda"

    def __post_init__(self):
        if self.kv_write not in KV_WRITE_STRATEGIES:
            raise ValueError(f"kv_write must be one of {KV_WRITE_STRATEGIES}, "
                             f"got {self.kv_write!r}")
        if self.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {self.decode_steps}")
        self.prefill_buckets = tuple(sorted(int(b) for b in self.prefill_buckets))
        if not self.prefill_buckets or self.prefill_buckets[0] < 1:
            raise ValueError(f"bad prefill_buckets {self.prefill_buckets!r}")

    @property
    def max_model_len(self) -> int:
        return self.page_size * self.pages_per_slot


@dataclasses.dataclass
class Request:
    id: str
    prompt: list[int]
    params: SamplingParams
    # resolved sampling seed: the sampled stream is a function of
    # (engine seed, this seed, position) only
    seed: int = 0
    output: list[int] = dataclasses.field(default_factory=list)
    # per output token: (logprob, top_ids, top_logprobs)
    output_logprobs: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pending_token: int = -1        # sampled, KV not cached yet
    finished: bool = False
    finish_reason: Optional[str] = None
    abort_reason: Optional[str] = None  # set by any thread; reaped by step()
    events: "queue.SimpleQueue[tuple[list[int], bool, Optional[str]]]" = dataclasses.field(
        default_factory=queue.SimpleQueue)
    # optional push delivery, called on the engine thread with each payload
    on_event: Optional[Any] = None


@dataclasses.dataclass
class StepEvent:
    request: Request
    new_tokens: list[int]
    finished: bool
    finish_reason: Optional[str]


class Engine:
    """Multi-request continuous-batching engine for one model on one device."""

    def __init__(self, engine_config: EngineConfig,
                 model_config: Optional[ModelConfig] = None,
                 params: Optional[Params] = None):
        self.config = engine_config
        self.device = resolve_device(engine_config.device)
        self.model_config = model_config or get_config(engine_config.model)
        cfg = self.model_config
        self.params = params if params is not None else init_params(
            cfg, seed=engine_config.seed, dtype=engine_config.dtype, device=self.device)
        self.cache_config = CacheConfig(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, num_pages=engine_config.num_pages,
            page_size=engine_config.page_size,
            pages_per_slot=engine_config.pages_per_slot, dtype=engine_config.dtype)
        self.k_pages, self.v_pages = init_pages(self.cache_config, device=self.device)
        B = engine_config.max_decode_slots
        self.allocator = PageAllocator(engine_config.num_pages, engine_config.page_size,
                                       B, engine_config.pages_per_slot)
        self.slots: list[Optional[Request]] = [None] * B
        self.slot_len = np.zeros((B,), np.int64)   # tokens whose KV is cached
        self.waiting: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._id_counter = iter(range(2 ** 62))
        self._seed_rng = np.random.default_rng(engine_config.seed)
        # per-slot OUTPUT-token counts for presence/frequency penalties
        self.token_counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32,
                                        device=self.device)
        self.prefill_calls = 0
        self.decode_forwards = 0     # forward_decode calls (K per window)

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, prompt: list[int], params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None, on_event=None) -> Request:
        params = params or SamplingParams()
        max_len = self.config.max_model_len
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if params.top_k > MAX_CANDIDATES:
            raise ValueError(f"top_k={params.top_k} exceeds the sampling candidate pool "
                             f"({MAX_CANDIDATES}); values above it are not supported")
        for name in ("presence_penalty", "frequency_penalty"):
            val = getattr(params, name)
            if not -2.0 <= val <= 2.0:
                raise ValueError(f"{name} must be in [-2, 2], got {val}")
        if len(params.stop_token_ids) > STOP_SLOTS:
            raise ValueError(f"stop_token_ids supports at most {STOP_SLOTS} entries, "
                             f"got {len(params.stop_token_ids)}")
        if params.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {params.max_tokens}")
        if len(prompt) > max(self.config.prefill_buckets):
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds the largest prefill "
                             f"bucket ({max(self.config.prefill_buckets)}); chunked "
                             f"prefill is not ported yet")
        if len(prompt) + 1 > max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit max_model_len="
                             f"{max_len} (page_size*pages_per_slot) with room to generate")
        if len(prompt) + params.max_tokens > max_len:
            params = dataclasses.replace(params, max_tokens=max(1, max_len - len(prompt)))
        if (self.allocator.pages_needed(len(prompt) + params.max_tokens)
                > self.config.num_pages - 1):
            # admission reserves these pages; more than the pool holds would
            # block the queue forever
            raise ValueError(f"prompt + max_tokens ({len(prompt) + params.max_tokens} "
                             f"tokens) needs more pages than the pool holds "
                             f"({self.config.num_pages - 1})")
        with self._lock:
            seed = (params.seed if params.seed is not None
                    else int(self._seed_rng.integers(0, 2 ** 31 - 1))) & 0x7FFFFFFF
            req = Request(id=request_id or f"req-{next(self._id_counter)}",
                          prompt=[int(t) for t in prompt], params=params, seed=seed,
                          on_event=on_event)
            if len(self.waiting) >= self.config.max_waiting:
                raise QueueFullError(f"waiting queue is full ({self.config.max_waiting} "
                                     f"requests); retry later")
            self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def abort(self, req: Request, reason: str = "abort") -> None:
        """Cancel from any thread; the next step() releases the slot."""
        req.abort_reason = reason

    # ------------------------------------------------------------------
    # scheduler iteration
    # ------------------------------------------------------------------

    def step(self) -> list[StepEvent]:
        # first tokens go out before the decode window runs, so a new
        # request's time to first token does not include the window
        events = self._reap_aborted() + self._admit()
        self._deliver(events)
        window = self._decode()
        self._deliver(window)
        return events + window

    def shed(self, reason: str) -> list[StepEvent]:
        """Finish every waiting and running request with ``reason`` (the
        serving loop's answer to a failed step: clients get a terminal
        event instead of a hang)."""
        with self._lock:
            doomed = list(self.waiting)
            self.waiting.clear()
        doomed += [r for r in self.slots if r is not None]
        events = [self._finish(r, reason) for r in doomed if not r.finished]
        self._deliver(events)
        return events

    def generate(self, prompt: list[int],
                 params: Optional[SamplingParams] = None) -> list[int]:
        """Synchronous single-request generation (drives the scheduler)."""
        req = self.submit(prompt, params)
        while not req.finished:
            self.step()
        return req.output

    @staticmethod
    def _deliver(events: list[StepEvent]) -> None:
        for ev in events:
            payload = (ev.new_tokens, ev.finished, ev.finish_reason)
            ev.request.events.put(payload)
            if ev.request.on_event is not None:
                ev.request.on_event(payload)

    def _reap_aborted(self) -> list[StepEvent]:
        with self._lock:
            doomed = [r for r in self.waiting if r.abort_reason and not r.finished]
            for r in doomed:
                self.waiting.remove(r)
        doomed += [r for r in self.slots
                   if r is not None and r.abort_reason and not r.finished]
        return [self._finish(r, r.abort_reason) for r in doomed]

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"no prefill bucket fits {n} tokens")

    def _emit(self, req: Request, token: int, lp: Optional[tuple]) -> list[StepEvent]:
        """Record a sampled token and decide whether the request finishes."""
        req.output.append(token)
        req.output_logprobs.append(lp)
        reason = None
        if token in req.params.stop_token_ids:
            reason = "stop"
        elif len(req.output) >= req.params.max_tokens:
            reason = "length"
        elif self.slot_len[req.slot] + 1 >= self.config.max_model_len:
            reason = "length"
        if reason is not None:
            self._finish(req, reason)
        return [StepEvent(req, [token], req.finished, reason)]

    def _finish(self, req: Request, reason: str) -> StepEvent:
        req.finished = True
        req.finish_reason = reason
        if req.slot >= 0:
            self.allocator.free(req.slot)
            self.slot_len[req.slot] = 0
            self.slots[req.slot] = None
            req.slot = -1
        return StepEvent(req, [], True, reason)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _admit(self) -> list[StepEvent]:
        """Admit waiting requests in order while a slot and their pages are
        free, then prefill them, one call per bucket."""
        admitted: list[Request] = []
        with self._lock:
            while self.waiting:
                slot = next((i for i, r in enumerate(self.slots) if r is None), None)
                if slot is None:
                    break
                req = self.waiting[0]
                need = len(req.prompt) + req.params.max_tokens
                if not self.allocator.can_allocate(slot, need):
                    break   # wait for pages to free up (FIFO: no overtaking)
                self.waiting.popleft()
                self.allocator.allocate(slot, need)
                self.slots[slot] = req
                req.slot = slot
                admitted.append(req)
        by_bucket: dict[int, list[Request]] = {}
        for req in admitted:
            by_bucket.setdefault(self._bucket_for(len(req.prompt)), []).append(req)
        events: list[StepEvent] = []
        for bucket, reqs in sorted(by_bucket.items()):
            events += self._prefill(bucket, reqs)
        return events

    def _prefill(self, bucket: int, reqs: list[Request]) -> list[StepEvent]:
        R, dev = len(reqs), self.device
        tokens = np.zeros((R, bucket), np.int32)
        ints = np.zeros((R, 3), np.int32)               # lengths, top_k, seed
        floats = np.zeros((R, 4), np.float32)           # temp, top_p, presence, freq
        for r, req in enumerate(reqs):
            n = len(req.prompt)
            tokens[r, :n] = req.prompt
            p = req.params
            ints[r] = (n, p.top_k, req.seed)
            floats[r] = (p.temperature, p.top_p, p.presence_penalty, p.frequency_penalty)
        slots = [req.slot for req in reqs]
        table = self.allocator.page_tables[slots]
        host = np.concatenate([ints, floats.view(np.int32), table], axis=1)
        dev_host = torch.from_numpy(host).to(dev)
        dev_tokens = torch.from_numpy(tokens).to(dev)
        lengths, top_k, seeds = (dev_host[:, c].contiguous() for c in range(3))
        fl = dev_host[:, 3:7].view(torch.float32)
        page_table = dev_host[:, 7:]
        slot_idx = torch.as_tensor(slots, device=dev)

        logits, _, _ = forward_prefill(self.params, self.model_config, dev_tokens,
                                       lengths, self.k_pages, self.v_pages, page_table)
        # fresh requests: no output tokens yet, so the penalty counts reset
        self.token_counts[slot_idx] = 0
        noise = gumbel_noise(self.config.seed, seeds, lengths,
                             min(MAX_CANDIDATES, logits.shape[1]))
        res = sample(logits, noise, fl[:, 0], top_k, fl[:, 1],
                     penalties=(fl[:, 2], fl[:, 3], self.token_counts[slot_idx]))
        self.prefill_calls += 1
        out = _to_host(res)
        events: list[StepEvent] = []
        for r, req in enumerate(reqs):
            self.slot_len[req.slot] = len(req.prompt)
            tok = int(out[0][r])
            req.pending_token = tok
            events += self._emit(req, tok, _lp_entry(out, r))
        return events

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode(self) -> list[StepEvent]:
        """One fused window of up to ``decode_steps`` tokens per slot."""
        B, K, dev = self.config.max_decode_slots, self.config.decode_steps, self.device
        max_len = self.config.max_model_len
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        ints = np.zeros((B, 5 + STOP_SLOTS), np.int32)  # len0, budget, cur, top_k, seed, stops
        ints[:, 5:] = -1
        floats = np.zeros((B, 4), np.float32)
        floats[:, 1] = 1.0
        plan: dict[int, int] = {}
        for i, r in active:
            base0 = int(self.slot_len[i]) + 1
            p = max(0, min(K, r.params.max_tokens - len(r.output), max_len - base0 + 1))
            plan[i] = p
            if p == 0:
                continue
            prm = r.params
            ints[i, :4] = (base0, p, r.pending_token, prm.top_k)
            ints[i, 4] = r.seed
            ints[i, 5:5 + len(prm.stop_token_ids)] = prm.stop_token_ids
            floats[i] = (prm.temperature, prm.top_p, prm.presence_penalty,
                         prm.frequency_penalty)
        if not any(plan.values()):
            return []
        host = np.concatenate([ints, floats.view(np.int32), self.allocator.page_tables],
                              axis=1)
        d = torch.from_numpy(host).to(dev)
        lengths0, budget, cur, top_k, seeds = (d[:, c] for c in range(5))
        stop_ids = d[:, 5:5 + STOP_SLOTS]
        fl = d[:, 5 + STOP_SLOTS:9 + STOP_SLOTS].view(torch.float32)
        page_table = d[:, 9 + STOP_SLOTS:]
        rows = torch.arange(B, device=dev)
        alive = lengths0 > 0
        C = min(MAX_CANDIDATES, self.model_config.vocab_size)
        results = []
        for j in range(K):
            lengths = torch.where(alive, lengths0 + j, 0)
            # the input token is an OUTPUT token: count it before sampling
            self.token_counts.index_put_((rows, cur.long()), alive.to(torch.int32),
                                         accumulate=True)
            logits, _, _ = forward_decode(self.params, self.model_config, cur, lengths,
                                          self.k_pages, self.v_pages, page_table,
                                          kv_write=self.config.kv_write)
            noise = gumbel_noise(self.config.seed, seeds, lengths, C)
            res = sample(logits, noise, fl[:, 0], top_k, fl[:, 1],
                         penalties=(fl[:, 2], fl[:, 3], self.token_counts))
            results.append(res)
            stopped = ((stop_ids >= 0) & (stop_ids == res.tokens[:, None])).any(dim=1)
            cur = torch.where(alive, res.tokens, cur)
            alive = alive & ~stopped & (j + 1 < budget)
        self.decode_forwards += K
        out = _to_host(*results)

        events: list[StepEvent] = []
        for i, r in active:
            for j in range(plan[i]):
                self.slot_len[i] += 1          # the pending token's KV is cached
                tok = int(out[0][j * B + i])
                r.pending_token = tok
                events += self._emit(r, tok, _lp_entry(out, j * B + i))
                if r.finished:
                    break
        return events


def _to_host(*results) -> tuple:
    """One device-to-host copy for the sampled tokens, logprobs and top
    alternatives of one or more SampleResults (rows concatenated)."""
    toks = torch.cat([r.tokens for r in results])
    ids = torch.cat([r.top_ids for r in results])
    lps = torch.cat([r.logprobs[:, None] for r in results])
    tlps = torch.cat([r.top_logprobs for r in results])
    packed = torch.cat([toks[:, None], ids, lps.view(torch.int32),
                        tlps.view(torch.int32)], dim=1).cpu().numpy()
    K = ids.shape[1]
    return (packed[:, 0], packed[:, 1:1 + K],
            np.ascontiguousarray(packed[:, 1 + K]).view(np.float32),
            np.ascontiguousarray(packed[:, 2 + K:]).view(np.float32))


def _lp_entry(out: tuple, row: int) -> tuple:
    """(logprob, top_ids, top_logprobs) of one row of ``_to_host``."""
    return (float(out[2][row]), out[1][row].tolist(), out[3][row].tolist())
