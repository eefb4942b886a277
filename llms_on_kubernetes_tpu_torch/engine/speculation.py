"""Speculative decoding: drafters and the accept-ratio policy (the port's
copy of ``llms_on_kubernetes_tpu/engine/speculation.py``).

Two draft tiers behind one interface (Leviathan et al. 2023; Saxena 2023,
*Prompt Lookup Decoding*):

- ``PromptLookupDrafter`` (model-free): matches the tail n-gram of each
  slot's committed context (prompt + output) against an earlier
  occurrence in the same context and proposes the tokens that followed it.
  Host numpy only, line for line the JAX drafter, so its drafts equal the
  JAX drafter's exactly.
- ``DraftModelDrafter``: a small draft model (a registry name with random
  weights, or a ``.gguf`` file through ``engine/gguf.py``) rolled out
  greedily over a bounded context window in a private paged pool. On a
  card the whole rollout (one prefill, ``max_draft - 1`` decode steps, the
  argmaxes) is one CUDA graph over static ``[batch, window]`` inputs, as
  the JAX drafter jits it.

The engine scores the committed token plus the drafts in ONE verify
dispatch (``engine/graphs.verify_window``) and accepts drafts by exact
match against its own samples, so a draft can change the dispatches a
stream takes, never a committed token. ``SpecPolicy`` (the JAX policy, copied)
tracks the accept ratio and demotes drafting on traffic that rejects it.

The draft pool's dtype is the draft parameters' (the JAX drafter's pool
is always float32): the decode kernel needs the pool's dtype to equal the
queries'. In float32 (the CPU tests) the drafts equal the JAX drafter's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "PromptLookupDrafter",
    "DraftModelDrafter",
    "SpecPolicy",
    "Speculator",
    "build_speculator",
]

_EMPTY = np.zeros((0,), np.int32)


class PromptLookupDrafter:
    """Model-free prompt-lookup drafter (Saxena 2023).

    ``propose`` scans the last ``window`` tokens of the context for the
    most recent earlier occurrence of the context's tail n-gram (longest
    n-gram first) and returns the continuation that followed it. Host-side
    numpy only: a vectorized sliding-window compare over at most
    ``window`` tokens per n-gram size.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 1024):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.window = window

    def propose(self, ctx: np.ndarray, max_draft: int) -> np.ndarray:
        n = int(ctx.shape[0])
        if max_draft <= 0 or n < self.min_ngram + 1:
            return _EMPTY
        hay = np.asarray(ctx[max(0, n - self.window):], np.int32)
        m = int(hay.shape[0])
        for g in range(min(self.max_ngram, m - 1), self.min_ngram - 1, -1):
            tail = hay[m - g:]
            sub = np.lib.stride_tricks.sliding_window_view(hay, g)
            match = np.all(sub == tail[None, :], axis=1)
            match[-1] = False  # the tail matching itself proposes nothing
            idxs = np.nonzero(match)[0]
            # the most recent occurrence wins, but only among occurrences
            # with a FULL continuation window: on a run of one repeated
            # token the latest match ends flush with the tail and would
            # propose one token where max_draft are there for the taking
            best = _EMPTY
            for i in idxs[::-1]:
                cont = hay[i + g:i + g + max_draft]
                if cont.size == max_draft:
                    return cont.astype(np.int32, copy=True)
                if cont.size > best.size:
                    best = cont
            if best.size:
                return best.astype(np.int32, copy=True)
        return _EMPTY

    def propose_batch(self, ctxs: Sequence[Optional[np.ndarray]],
                      max_draft: int) -> List[np.ndarray]:
        return [self.propose(c, max_draft) if c is not None and c.size
                else _EMPTY for c in ctxs]


class DraftModelDrafter:
    """Draft-model drafter: greedy rollout of a small model over a bounded
    context window.

    The drafter owns a small private paged pool (page 0 of each layer is
    the pool's trash page, so row pages start at 1) in the draft
    parameters' dtype: each ``propose_batch`` re-prefills the
    ``[batch, window]`` context tails and runs ``max_draft - 1``
    single-token decode steps. Stale cache rows from an earlier call are
    invisible: attention is bounded by the row's current length. On a card
    the rollout is captured once, at the first call, as one CUDA graph
    over static inputs and its own decode workspace, and every group of
    ``batch`` rows is one replay (``replays``; ``launches`` is one
    replay's kernel launches, added to the counters on every replay). On
    the CPU it runs eagerly."""

    def __init__(self, params, cfg, *, window: int = 64, max_draft: int = 7,
                 batch: int = 8, page_size: int = 16, device=None):
        from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
        from llms_on_kubernetes_tpu_torch.ops.paged_attention import DecodeWorkspace

        self.params = params
        self.cfg = cfg
        self.window = window
        self.max_draft = max(1, max_draft)
        self.batch = batch
        self.device = torch.device(device) if device is not None else params["embed"].device
        per_row = -(-(window + self.max_draft) // page_size)
        dtype = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[params["embed"].dtype]
        cc = CacheConfig(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, num_pages=1 + batch * per_row,
            page_size=page_size, pages_per_slot=per_row, dtype=dtype,
        )
        self._kp, self._vp = init_pages(cc, device=self.device)
        self._pt = torch.from_numpy(
            1 + np.arange(batch * per_row, dtype=np.int32).reshape(batch, per_row)
        ).to(self.device)
        self.workspace = DecodeWorkspace()
        self.replays = 0
        self.launches: dict = {}
        self.capture_s = 0.0
        self.graph = None
        self._tokens = self._lens = self._drafts = None

    def _rollout(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """One prefill, then ``max_draft - 1`` decode steps, each sampling
        greedily: drafts [batch, max_draft] int32."""
        from llms_on_kubernetes_tpu_torch.models.decoder import forward_decode, forward_prefill

        logits, _, _ = forward_prefill(self.params, self.cfg, tokens, lengths, self._kp,
                                       self._vp, self._pt)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        drafts = [nxt]
        for j in range(1, self.max_draft):
            logits, _, _ = forward_decode(self.params, self.cfg, nxt, lengths + j, self._kp,
                                          self._vp, self._pt, workspace=self.workspace)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(nxt)
        return torch.stack(drafts, dim=1)

    def _capture(self) -> None:
        """Warm up (every row empty, on a side stream; counted nowhere),
        then capture the rollout over static inputs."""
        from llms_on_kubernetes_tpu_torch import kernels

        t0 = time.perf_counter()
        dev = self.device
        self._tokens = torch.zeros((self.batch, self.window), dtype=torch.int32, device=dev)
        self._lens = torch.zeros((self.batch,), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with kernels.counting_apart(), torch.cuda.stream(side):
            self._rollout(self._tokens, self._lens)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with kernels.counting_apart() as counted, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._drafts = self._rollout(self._tokens, self._lens)
        self.workspace.frozen = True
        self.launches = dict(counted)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        kernels.note_compile("graph:draft_rollout", self.capture_s)

    def _run(self, toks: np.ndarray, lens: np.ndarray) -> np.ndarray:
        if self.device.type != "cuda":
            return self._rollout(torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
        from llms_on_kubernetes_tpu_torch import kernels

        if self.graph is None:
            self._capture()
        self._tokens.copy_(torch.from_numpy(toks).pin_memory(), non_blocking=True)
        self._lens.copy_(torch.from_numpy(lens).pin_memory(), non_blocking=True)
        self.graph.replay()
        kernels.add_launches(self.launches)
        self.replays += 1
        return self._drafts.cpu().numpy()

    def propose_batch(self, ctxs: Sequence[Optional[np.ndarray]],
                      max_draft: int) -> List[np.ndarray]:
        max_draft = min(max_draft, self.max_draft)
        out: List[np.ndarray] = [_EMPTY] * len(ctxs)
        if max_draft <= 0:
            return out
        rows = [i for i, c in enumerate(ctxs) if c is not None and c.size]
        for s in range(0, len(rows), self.batch):
            group = rows[s:s + self.batch]
            toks = np.zeros((self.batch, self.window), np.int32)
            lens = np.zeros((self.batch,), np.int32)
            for b, i in enumerate(group):
                tail = np.asarray(ctxs[i][-self.window:], np.int32)
                toks[b, :tail.shape[0]] = tail
                lens[b] = tail.shape[0]
            host = self._run(toks, lens)
            for b, i in enumerate(group):
                out[i] = host[b, :max_draft].astype(np.int32, copy=True)
        return out

    def propose(self, ctx: np.ndarray, max_draft: int) -> np.ndarray:
        return self.propose_batch([ctx], max_draft)[0]


@dataclass
class SpecPolicy:
    """Adaptive accept-ratio gate.

    Tracks an EMA of accepted-per-drafted across spec dispatches. When the
    ratio stays below ``min_accept`` after ``min_dispatches`` observations,
    speculation is demoted (wasted verify rows cost real FLOPs on
    adversarial traffic); every ``probe_interval`` decode dispatches while
    demoted, one probe dispatch re-measures so a traffic shift back to
    lookup-friendly content re-enables drafting.
    """

    min_accept: float = 0.3
    min_dispatches: int = 8
    probe_interval: int = 64
    decay: float = 0.9
    dispatches: int = 0
    drafted: int = 0
    accepted: int = 0
    _ema: float = field(default=1.0, repr=False)
    _demoted: bool = field(default=False, repr=False)
    _idle: int = field(default=0, repr=False)

    def note(self, drafted: int, accepted: int) -> None:
        """Record one spec dispatch's outcome (counts exclude the bonus
        token: the pure draft hit-rate)."""
        if drafted <= 0:
            return
        self._idle = 0  # a probe (or regular spec dispatch) just ran
        self.dispatches += 1
        self.drafted += drafted
        self.accepted += accepted
        self._ema = (self.decay * self._ema
                     + (1.0 - self.decay) * (accepted / drafted))
        if self.dispatches >= self.min_dispatches:
            self._demoted = self._ema < self.min_accept

    def note_empty(self) -> None:
        """Record a draft attempt that proposed nothing (an accept-ratio
        observation of 0 without inflating the drafted/accepted counters,
        which feed the accept-ratio metric)."""
        self._idle = 0
        self.dispatches += 1
        self._ema = self.decay * self._ema
        if self.dispatches >= self.min_dispatches:
            self._demoted = self._ema < self.min_accept

    def tick(self) -> None:
        """Count one non-spec decode dispatch (drives re-probing)."""
        if self._demoted:
            self._idle += 1

    def should_draft(self) -> bool:
        """Pure check (no side effects): draft unless demoted, probing
        once every probe_interval plain dispatches while demoted. The
        probe's note()/note_empty() resets the idle counter."""
        if not self._demoted:
            return True
        return self._idle >= self.probe_interval

    @property
    def accept_ratio(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


class Speculator:
    """One engine-facing handle: drafter + policy + window size."""

    def __init__(self, drafter, policy: SpecPolicy, max_draft: int):
        self.drafter = drafter
        self.policy = policy
        self.max_draft = max(1, max_draft)

    def propose_batch(self, ctxs: Sequence[Optional[np.ndarray]],
                      max_draft: Optional[int] = None) -> List[np.ndarray]:
        k = self.max_draft if max_draft is None else min(max_draft,
                                                         self.max_draft)
        return self.drafter.propose_batch(ctxs, k)


def _load_draft_model(ref: str, target_cfg, dtype: str, seed: int, device="cuda"):
    """Resolve a draft-model reference to (params, cfg) on ``device``.

    ``*.gguf`` paths (and any existing path) load through
    ``engine/gguf.py``; anything else is a registry name given random
    weights from ``seed`` (tests and smoke runs: the policy demotes a
    useless drafter, so a random draft model is safe, just pointless).
    The draft vocabulary must cover the target's: drafted ids go straight
    into the target's verify window."""
    if ref.endswith(".gguf") or os.path.exists(ref):
        from llms_on_kubernetes_tpu_torch.engine.gguf import load_gguf_params
        cfg, params = load_gguf_params(ref, dtype=dtype, device=device)
    else:
        from llms_on_kubernetes_tpu_torch.configs import get_config
        from llms_on_kubernetes_tpu_torch.models.decoder import init_params
        cfg = get_config(ref)
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
    if cfg.vocab_size < target_cfg.vocab_size:
        raise ValueError(
            f"draft model {ref!r} vocab_size={cfg.vocab_size} < target "
            f"vocab_size={target_cfg.vocab_size}: drafted token ids would "
            "be unverifiable")
    return params, cfg


def build_speculator(engine_config, target_cfg, device="cuda") -> Optional[Speculator]:
    """Build the engine's speculator from its config, or None when
    speculation is off or structurally unavailable (K = 1)."""
    mode = engine_config.speculation
    if mode is None or engine_config.decode_steps <= 1:
        return None
    max_draft = engine_config.decode_steps - 1
    policy = SpecPolicy()
    if mode == "ngram":
        drafter = PromptLookupDrafter()
    elif mode == "draft":
        params, cfg = _load_draft_model(
            engine_config.draft_model, target_cfg,
            engine_config.dtype, engine_config.seed, device)
        drafter = DraftModelDrafter(params, cfg, max_draft=max_draft, device=device)
    else:
        raise ValueError(f"unknown speculation mode {mode!r}")
    return Speculator(drafter, policy, max_draft)
