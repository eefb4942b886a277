"""The serving engine: continuous batching over bucketed prefill and fused
multi-step decode (counterpart of ``llms_on_kubernetes_tpu/engine/engine.py``).

The public surface keeps the JAX engine's names: ``EngineConfig`` (same
field names and defaults for the fields it keeps, plus ``device``),
``SamplingParams``, ``Request``, ``StepEvent`` and
``Engine.submit/step/abort/has_work/generate``.

The weights come from ``params``, else from a checkpoint directory
(``model_dir``: ``engine/weights.load_hf_params``, the model config from
the registry or, for a name the registry lacks, from the directory's
``config.json``), else they are drawn at random from the engine seed.

One scheduler iteration (``step``):

1. reap aborted requests;
2. admit waiting requests into free slots: adopt the longest cached prefix
   of the prompt (prefix caching, on by default), then reserve pages for
   ``prompt + max_tokens`` up front, counting only the pages past the
   adopted ones (so decode never runs out of pages and never preempts); an
   admission whose pages do not fit yet rolls its adoption back and waits;
3. prefill them: one ``forward_prefill`` call per prefill bucket, the rows
   padded to the smallest bucket that fits; a prompt with a cache hit, or
   longer than the largest bucket, takes the chunk path instead
   (``_chunked_prefill``: ``forward_chunk`` over chunks of the largest
   bucket, from the end of the adopted prefix). The first token is sampled
   on the device from the last prefill's logits, keyed on (seed, prompt
   length), so a seeded stream is the same cold, on a hit and chunked. The
   prompt's full pages are then published to the prefix cache;
4. run one decode window over every active slot: ``decode_steps`` chained
   ``forward_decode`` + ``sample`` iterations with no host sync between
   them. Per-row budgets and stop ids mask a row on the device the moment
   it finishes (its length drops to 0, so its KV write goes to the trash
   page and its counts stop), and one device-to-host copy at the end
   brings back the window's tokens. The host stays authoritative for
   finishes.

``kv_cache_dtype="int8"`` (or env ``LLMK_KV_DTYPE=int8``) keeps the KV
pool in int8 with per-token scales, as the JAX engine does.

The scheduler is synchronous. The JAX engine's async harvester, pacing,
host KV tier and handoff, QoS, ledger, grammar, LoRA, multimodal salts,
speculation and preemption are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
from typing import Any, Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import (
    ALIASES, REGISTRY, ModelConfig, from_hf_config, get_config,
)
from llms_on_kubernetes_tpu_torch.engine.cache import (
    CacheConfig, PageAllocator, init_pages,
)
from llms_on_kubernetes_tpu_torch.engine.sampling import (
    MAX_CANDIDATES, gumbel_noise, sample,
)
from llms_on_kubernetes_tpu_torch.models.decoder import (
    forward_chunk, forward_decode, forward_prefill, init_params,
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
    # KV cache storage: None => the engine dtype; "int8" => per-token
    # quantized KV (data + f32 scale; about half the pool bytes and half the
    # bytes decode attention reads). None falls through to env
    # LLMK_KV_DTYPE ("", "none" and "off" mean off), as in the JAX engine
    kv_cache_dtype: Optional[str] = None
    # hash-chained reuse of cached prompt pages (engine/cache.PageAllocator);
    # a hit prefills only the remainder, through the chunk path
    prefix_caching: bool = True
    decode_steps: int = 4
    seed: int = 0
    # "cuda" (the default) raises without a GPU; pass "cpu" for the CPU
    device: str = "cuda"

    def __post_init__(self):
        if self.kv_write not in KV_WRITE_STRATEGIES:
            raise ValueError(f"kv_write must be one of {KV_WRITE_STRATEGIES}, "
                             f"got {self.kv_write!r}")
        if self.kv_cache_dtype is None:
            self.kv_cache_dtype = os.environ.get("LLMK_KV_DTYPE") or None
        if self.kv_cache_dtype in ("off", "none", ""):
            self.kv_cache_dtype = None
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None/'int8', got "
                             f"{self.kv_cache_dtype!r}")
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
    # prefix-cache digest salt: the empty salt for text (the JAX engine's),
    # so the page digests equal the JAX allocator's
    cache_salt: bytes = b""
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


def model_config_for(model: str, model_dir: Optional[str] = None) -> ModelConfig:
    """The model's config: the registry's entry for a registry name or HF
    alias, else (a checkpoint directory) ``from_hf_config`` of its
    config.json, named ``model``, as the JAX ``cli serve`` resolves it."""
    if model in REGISTRY or model.lower() in ALIASES or model_dir is None:
        return get_config(model)
    return from_hf_config(os.path.join(model_dir, "config.json"), name=model)


class Engine:
    """Multi-request continuous-batching engine for one model on one device."""

    def __init__(self, engine_config: EngineConfig,
                 model_config: Optional[ModelConfig] = None,
                 params: Optional[Params] = None,
                 model_dir: Optional[str] = None):
        self.config = engine_config
        self.device = resolve_device(engine_config.device)
        self.model_config = model_config or model_config_for(engine_config.model, model_dir)
        cfg = self.model_config
        if params is not None:
            self.params = params
        elif model_dir is not None:
            from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params

            self.params = load_hf_params(cfg, model_dir, device=self.device,
                                         dtype=engine_config.dtype)
        else:   # random weights (tests, smoke runs)
            self.params = init_params(cfg, seed=engine_config.seed,
                                      dtype=engine_config.dtype, device=self.device)
        self.cache_config = CacheConfig(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, num_pages=engine_config.num_pages,
            page_size=engine_config.page_size,
            pages_per_slot=engine_config.pages_per_slot, dtype=engine_config.dtype,
            kv_dtype=engine_config.kv_cache_dtype)
        self.k_pages, self.v_pages = init_pages(self.cache_config, device=self.device)
        B = engine_config.max_decode_slots
        self.allocator = PageAllocator(engine_config.num_pages, engine_config.page_size,
                                       B, engine_config.pages_per_slot,
                                       prefix_caching=engine_config.prefix_caching)
        self.slots: list[Optional[Request]] = [None] * B
        self.slot_len = np.zeros((B,), np.int64)   # tokens whose KV is cached
        self.waiting: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._id_counter = iter(range(2 ** 62))
        self._seed_rng = np.random.default_rng(engine_config.seed)
        # per-slot OUTPUT-token counts for presence/frequency penalties
        self.token_counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32,
                                        device=self.device)
        self.prefill_calls = 0       # forward_prefill calls (one per bucket batch)
        self.chunk_calls = 0         # forward_chunk calls (one per chunk)
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
        free, then prefill them: one call per bucket, and the chunk path
        for each request with a cache hit or a prompt past the largest
        bucket."""
        admitted: list[tuple[Request, int]] = []
        alloc = self.allocator
        with self._lock:
            while self.waiting:
                slot = next((i for i, r in enumerate(self.slots) if r is None), None)
                if slot is None:
                    break
                req = self.waiting[0]
                # adopt the cached prefix FIRST, so the page check counts
                # only the pages past it; roll back if they do not fit yet
                hit = alloc.adopt_prefix(slot, req.prompt, salt=req.cache_salt)
                need = len(req.prompt) + req.params.max_tokens
                if not alloc.can_allocate(slot, need):
                    if hit:
                        alloc.rollback_adopt(slot)
                    break   # wait for pages to free up (FIFO: no overtaking)
                self.waiting.popleft()
                alloc.allocate(slot, need)
                if hit:
                    alloc.commit_adopt(slot, hit)
                self.slots[slot] = req
                req.slot = slot
                admitted.append((req, hit))
        by_bucket: dict[int, list[Request]] = {}
        chunked: list[tuple[Request, int]] = []
        for req, hit in admitted:
            if hit > 0 or len(req.prompt) > max(self.config.prefill_buckets):
                chunked.append((req, hit))
            else:
                by_bucket.setdefault(self._bucket_for(len(req.prompt)), []).append(req)
        events: list[StepEvent] = []
        for bucket, reqs in sorted(by_bucket.items()):
            events += self._prefill(bucket, reqs)
        for req, hit in chunked:
            events += self._chunked_prefill(req, start=hit)
        return events

    def _rows(self, reqs: list[Request], lengths: list[int]):
        """One host-to-device copy of the rows' sampling parameters and page
        tables: (lengths, top_k, seeds, floats [R, 4] = temperature, top_p,
        presence, frequency; page_table [R, pages_per_slot])."""
        R = len(reqs)
        ints = np.zeros((R, 3), np.int32)               # lengths, top_k, seed
        floats = np.zeros((R, 4), np.float32)
        for r, req in enumerate(reqs):
            p = req.params
            ints[r] = (lengths[r], p.top_k, req.seed)
            floats[r] = (p.temperature, p.top_p, p.presence_penalty, p.frequency_penalty)
        table = self.allocator.page_tables[[req.slot for req in reqs]]
        host = np.concatenate([ints, floats.view(np.int32), table], axis=1)
        d = torch.from_numpy(host).to(self.device)
        return (*(d[:, c].contiguous() for c in range(3)), d[:, 3:7].view(torch.float32),
                d[:, 7:])

    def _first_tokens(self, reqs: list[Request], logits, lengths, top_k, seeds,
                      fl) -> list[StepEvent]:
        """Sample each row's first token from its prompt's last logits (the
        noise keyed on the prompt length), publish the prompt's full pages
        to the prefix cache, and emit the tokens."""
        slot_idx = torch.as_tensor([req.slot for req in reqs], device=self.device)
        # fresh requests: no output tokens yet, so the penalty counts reset
        self.token_counts[slot_idx] = 0
        noise = gumbel_noise(self.config.seed, seeds, lengths,
                             min(MAX_CANDIDATES, logits.shape[1]))
        res = sample(logits, noise, fl[:, 0], top_k, fl[:, 1],
                     penalties=(fl[:, 2], fl[:, 3], self.token_counts[slot_idx]))
        out = _to_host(res)
        events: list[StepEvent] = []
        for r, req in enumerate(reqs):
            self.slot_len[req.slot] = len(req.prompt)
            # before _emit, which frees the slot of a request that finishes
            self.allocator.register_prefix(req.slot, req.prompt, salt=req.cache_salt)
            tok = int(out[0][r])
            req.pending_token = tok
            events += self._emit(req, tok, _lp_entry(out, r))
        return events

    def _prefill(self, bucket: int, reqs: list[Request]) -> list[StepEvent]:
        tokens = np.zeros((len(reqs), bucket), np.int32)
        for r, req in enumerate(reqs):
            tokens[r, :len(req.prompt)] = req.prompt
        lengths, top_k, seeds, fl, page_table = self._rows(
            reqs, [len(req.prompt) for req in reqs])
        logits, _, _ = forward_prefill(self.params, self.model_config,
                                       torch.from_numpy(tokens).to(self.device), lengths,
                                       self.k_pages, self.v_pages, page_table)
        self.prefill_calls += 1
        return self._first_tokens(reqs, logits, lengths, top_k, seeds, fl)

    def _chunked_prefill(self, req: Request, start: int = 0) -> list[StepEvent]:
        """Prefill ``req``'s prompt from position ``start`` (> 0 when a
        cached prefix was adopted: those positions' KV is already in the
        slot's pages) in chunks of the largest bucket, each padded to the
        smallest bucket that fits, one ``forward_chunk`` call per chunk
        with history = the position it starts at. Only the final chunk's
        logits are sampled, exactly as a one-shot prefill of the prompt
        would sample them."""
        n = len(req.prompt)
        step = max(self.config.prefill_buckets)
        lengths, top_k, seeds, fl, page_table = self._rows([req], [n])
        pos, logits = start, None
        while pos < n:
            m = min(step, n - pos)
            host = np.zeros((1, 2 + self._bucket_for(m)), np.int32)   # m, pos, tokens
            host[0, :2] = (m, pos)
            host[0, 2:2 + m] = req.prompt[pos:pos + m]
            d = torch.from_numpy(host).to(self.device)
            logits, _, _ = forward_chunk(self.params, self.model_config, d[:, 2:], d[:, 1],
                                         d[:, 0], self.k_pages, self.v_pages, page_table)
            self.chunk_calls += 1
            pos += m
        return self._first_tokens([req], logits, lengths, top_k, seeds, fl)

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
