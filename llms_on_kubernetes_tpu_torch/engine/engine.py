"""The serving engine: continuous batching over bucketed prefill and fused
multi-step decode (counterpart of ``llms_on_kubernetes_tpu/engine/engine.py``).

The public surface keeps the JAX engine's names: ``EngineConfig`` (same
field names and defaults for the fields it keeps, plus ``device``),
``SamplingParams``, ``Request``, ``StepEvent`` and
``Engine.submit/step/abort/has_work/generate``, and ``preemptions``.

The weights come from ``params``, else from a checkpoint directory
(``model_dir``: ``engine/weights.load_hf_params``, the model config from
the registry or, for a name the registry lacks, from the directory's
``config.json``), else they are drawn at random from the engine seed.
``quantization`` (JAX's field): "int8" serves weight-only int8 QTensors
(``ops/quant.py``; each projection one W8A16 kernel launch on a card);
"fp8" / "awq" assert a checkpoint's format. Random weights are quantized
whatever the mode names, and an fp8 checkpoint always serves int8.

Memory: pages are allocated on demand. Admission allocates pages for the
prompt and one token (after adopting the longest cached prefix of the
prompt: prefix caching, on by default); each decode window grows each row
to the positions it plans. When the pool runs out, the youngest request
of the lowest priority class is preempted: its pages are freed (spilled to
the host tier first, when it is on) and it goes back to the front of the
queue, to re-prefill its prompt and every token it emitted but the last
(the prefill's sample is thrown away, the penalty counts are rebuilt
from the replayed tokens), so its stream is the one it would have been.

Prefill: one ``forward_prefill`` call per prefill bucket, the rows padded
to the smallest bucket that fits; a prompt with a cache hit, or longer
than the largest bucket, takes the chunk path (``forward_chunk`` over
chunks of the largest bucket, from the end of the adopted prefix). The
first token is sampled on the device from the last prefill's logits,
keyed on (seed, prompt length), so a seeded stream is the same cold, on a
hit and chunked.

Decode: windows of up to ``decode_steps`` tokens per slot
(``engine/graphs.decode_window``), each one CUDA graph replay on a card.
Per-row budgets and stop ids mask a row on the device the moment it
finishes; the host stays authoritative for finishes.

Scheduling (``async_scheduling``, on by default, as in the JAX engine):
up to ``async_depth`` windows are in flight, each fed on the device by
the newest in-flight window's tokens, a host value or this step's prefill
sample (the token merge). Each window's results, and each prefill's first
tokens, go to the host in one non-blocking copy followed by an event,
which a harvester thread waits on; the engine thread consumes them in
dispatch order and blocks only for backpressure (``async_depth`` windows
unread) or a drain, so a new submission is admitted and prefilled while
the device works. ``async_scheduling=False`` runs the synchronous loop:
admit and prefill, then one window, read at once.

Device-queue pacing (``pace_target_steps`` > 0, as in the JAX engine):
the engine keeps an estimate of when the work it dispatched will be done
(``_busy_until``: one step time per window, two per prefill call) and,
when nothing was admitted this step, defers a window while that is more
than ``pace_target_steps`` step times away, so a new request's prefill
queues behind fewer windows. The step time (``_est_step``) is calibrated
from the spacing of harvested windows: the least seen, drifting up 2%.
A "step" is one dispatch, a whole K-step window, as in JAX.

``kv_cache_dtype="int8"`` (or env ``LLMK_KV_DTYPE=int8``) keeps the KV
pool in int8 with per-token scales, as the JAX engine does.

``SamplingParams.logit_bias`` rides every prefill, chunk and decode row as
``LOGIT_BIAS_SLOTS`` id and value columns (``engine/graphs.py``), so the
captured window applies it on every replay, padding for rows without one.

The stall watchdog (``watchdog_stall_s``, as in the JAX engine): a
blocking harvest wait gives up after ``_stall_budget()`` seconds; the
engine then finishes every request with reason "stalled", marks itself
``wedged`` and refuses submissions. A step the card never completes cannot
be cancelled: the engine only stops waiting for it (a restart recovers).

``score_prompt`` scores a prompt cache-free (``forward_score``): the
``echo`` + ``logprobs`` surface. ``prefix_filter_digests`` lists the
prefix cache's page digests for the server's ``/ready`` advertisement.

Deadlines (``submit(deadline=)``, an absolute ``time.monotonic()``, as in
the JAX engine): the head of every step turns an expired request into an
abort with reason "timeout". A waiting one is shed without a prefill; a
seated one takes the path a client disconnect takes (its slot and pages
come back at once; a window in flight drops the row at harvest).

Resume (``SamplingParams.prefix_tokens``, the JAX field): the tokens a
stream already delivered become the request's output at submit, so
admission re-prefills prompt + prefix as a preempted request's, they count
toward ``max_tokens`` and the penalties, and the stream continues with the
token the uninterrupted one would have sampled next (the noise is keyed on
the position, and the prompt length stays the original prompt's).

Fault hooks (``faults.py``, ``LLMK_FAULT``): ``queue_stall`` holds
admission; ``engine_stall`` and ``slow_step`` act at the harvester's
completion. ``Request.trace`` (the server's per-request trace) gets the
"preempted" and "finish" events.

The goodput ledger (``engine/ledger.py``, ``EngineConfig.ledger``, env
``LLMK_LEDGER``, on by default, as in the JAX engine): every prefill call
and window is booked with its launch time and the time the harvester saw
its results land (on the engine thread, no device sync): decode rows by
the tokens consumed, planned-but-unconsumed tokens as ``early_exit``,
padded prefill rows as nothing; ``Request.chip_ms`` gets each request's
share. Its anomaly detector (``anomaly_profile`` / ``anomaly_z`` /
``anomaly_cooldown_s``) flags a sustained slowdown for the server's one
rate-limited profile.

Grammar-constrained decoding (``SamplingParams.grammar``, an
``engine/grammar.CompiledGrammar``, as in the JAX engine): up to
``max_grammars`` grammars are resident in device tables allocated once at
capacity (``class_of [max_grammars, V]``, ``trans [grammar_states,
grammar_classes]`` int16, the per-slot state [B] int32; uploads copy into
them). A request whose grammar finds no free row waits, as under page
pressure; an oversized grammar is refused at submit. The prefill masks and
scatters a fresh request's start state; a window with any constrained row
replays the FSM window graph (``engine/graphs.py``), a grammar-free window
the grammar-free graph. A preempted or resumed request replays its state
on the host over its output and its first window sets it (``fsm_set``).

Tenants and priority classes (``engine/qos.py``, as in the JAX engine):
``waiting`` is a ``TenantFairQueue``, deficit round robin across tenants
inside strict classes (interactive > normal > batch) with starvation
aging; a request's ``tenant`` and ``priority`` are fixed at submit (the
``qos_*`` fields map tenants to weights and classes). The preemption
victim is the lowest class's youngest request. ``tenant_admitted`` and
``tenant_wait_obs`` count first admissions for the server's series.

The host KV tier (``kv_host_cache_gb`` > 0, env ``LLMK_KV_HOST_CACHE_GB``,
with prefix caching; ``engine/cache.HostKVCache``): a finishing or
preempted request's full pages, whose KV is committed, spill to host RAM
keyed by (tenant, digest). The gather is enqueued on the compute stream
before ``allocator.free`` hands the pages on, and its device-to-host copy
lands in a reusable pinned ring, waited for later through the harvester's
condition with the watchdog budget (``_drain_spills``: at the next
admission probe, when the ring is full, or at once for a handoff). An
admission walks the same digest chain through the tier past the device
hit and uploads the matched pages into its fresh pages in place (the
window graphs hold the pools' addresses), on the stream before the chunk
prefill that reads them. The gather and the upload are ``index_select``
and ``index_copy_`` on the flat page axis (XLA ``take`` / ``.at[].set``
in JAX, not Pallas).

The disaggregated handoff (``role``, env ``LLMK_ROLE``: prefill, decode or
both; prefill needs the tier): ``submit(handoff=True)`` is a one-token
prefill whose spills land in the tier before its finish is delivered;
``handoff_digests``, ``host_kv_export`` and ``host_kv_ingest`` serve the
server's ticket, ``/internal/kv/fetch`` and pull, from server threads.

Speculative decoding (``speculation``: "ngram" or "draft" with
``draft_model``; env ``LLMK_SPECULATION`` / ``LLMK_DRAFT_MODEL``; as in the
JAX engine, only with async scheduling and ``decode_steps`` > 1;
``engine/speculation.py``): each decode launch first tries a verify
dispatch (``_launch_decode_spec``). Verifies serialize: one launches only
into an empty pipeline (no window in flight, no first token unread, no
admission this step), so every row's input token and committed context are
host-known, and while it is in flight admission waits. The drafter
proposes up to ``decode_steps - 1`` tokens a row, one verify
(``engine/graphs.verify_window``, a CUDA graph replay on a card) scores
them, and the harvest takes each row's ``accept`` prefix of its plan,
booking the rejected rest as ``spec_waste``. The ``SpecPolicy`` demotes
drafting on traffic that rejects it (the pipelined plain window comes
back) and probes again every 64 plain dispatches. Counters (JAX names):
``spec_dispatches``, ``spec_drafted_tokens``, ``spec_accepted_tokens``,
``decode_dispatches``, ``steps_obs``.

Multi-tenant LoRA (``adapters``: (name, local directory) pairs of PEFT
adapters; ``engine/adapters.py``, ``ops/lora.py``; as in the JAX engine):
one zeroed ``LoRAStack`` a target weight (``adapter_targets``) of
``adapter_slots`` slots at ``adapter_rank`` joins the layer params before
the windows are captured, and is only ever copied into. ``submit(adapter=)``
names one (``UnknownAdapterError`` otherwise); admission pins it into a
slot (loading and uploading it on a miss, recycling the least recently
used unpinned slot) or waits, as under page pressure, and the pin goes at
finish and at preemption. Each row's slot rides the packed prefill, chunk,
decode and verify rows (-1: the base model), so a captured window applies
any mix of adapters with no recapture. The upload copies from pinned
memory on the compute stream, so the windows already launched read the
slot's old factors. An adapter request's digest chain is salted with the
adapter's name and directory (the device prefix cache, the host tier and
the handoff digests): its K/V never meets the base model's. (The JAX
engine salts text requests with ``b""`` whatever adapter they name, so
there an adapter request adopts pages the base model wrote.)

Not ported yet: multimodal salts.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue
import sys
import threading
import time
import weakref
from typing import Any, Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import faults, resolve_device
from llms_on_kubernetes_tpu_torch.configs import (
    ALIASES, REGISTRY, ModelConfig, from_hf_config, get_config,
)
from llms_on_kubernetes_tpu_torch.engine.cache import (
    CacheConfig, HostKVCache, PageAllocator, as_pool_view, init_pages, payload_shape_ok,
    torch_dtype,
)
from llms_on_kubernetes_tpu_torch.engine.graphs import (
    ADP, BIAS, BUD, DEC_COLS, FLOATS, FSM, LEN, LOGIT_BIAS_SLOTS, PRE_ROW, SEED, SRC, SRC_HOST,
    SRC_INFLIGHT, SRC_PREFILL, STOP, STOP_SLOTS, TOP_K, VAL, DecodeWindow, fsm_apply,
    fsm_scatter, idle_rows, pack_bias, pack_results, unpack_accept, unpack_bias,
    unpack_results, upload, verify_rows,
)
from llms_on_kubernetes_tpu_torch.engine.ledger import GoodputLedger, StepAnomalyDetector
from llms_on_kubernetes_tpu_torch.engine.qos import (
    MIN_WEIGHT, PRIORITIES, TenantFairQueue, normalize_priority, priority_rank,
)
from llms_on_kubernetes_tpu_torch.engine.sampling import (
    LOGPROB_TOPK, MAX_CANDIDATES, gumbel_noise, sample,
)
from llms_on_kubernetes_tpu_torch.models.decoder import (
    forward_chunk, forward_prefill, forward_score, init_params,
)
from llms_on_kubernetes_tpu_torch.ops.lora import LoRAStack, lora_zeros
from llms_on_kubernetes_tpu_torch.ops.moe import MoEWorkspace
from llms_on_kubernetes_tpu_torch.ops.paged_attention import DecodeWorkspace
from llms_on_kubernetes_tpu_torch.ops.quant import SUPPORTED_QUANTIZATIONS, quantize_params

Params = dict[str, Any]

KV_WRITE_STRATEGIES = ("dus", "fused")


def default_kv_write_strategy() -> str:
    """The env default (``LLMK_KV_WRITE``, resolved at EngineConfig
    construction), as the JAX ``cache.default_kv_write_strategy`` resolves
    it: the legacy ``scatter`` + ``LLMK_SCATTER_VARIANT=linear`` spelling
    included, and anything this engine does not implement means "dus"."""
    s = os.environ.get("LLMK_KV_WRITE", "dus")
    if s == "scatter" and os.environ.get("LLMK_SCATTER_VARIANT") == "linear":
        s = "scatter-linear"
    return s if s in KV_WRITE_STRATEGIES else "dus"

log = logging.getLogger(__name__)

# packed prefill/chunk row columns: tokens in this call, history (tokens
# cached before it), top_k, seed, slot, prompt length (the output-token
# counting boundary), reset (the request's first call: its penalty counts
# restart), four float32 columns viewed as int32 (temperature, top_p,
# presence, frequency), the FSM columns (the row's grammar row, -1 =
# unconstrained, and the absolute start state to assume before sampling:
# set for a fresh constrained request, -1 for a resumed one, whose first
# window sets its replayed state), the logit_bias ids and values, the
# row's LoRA adapter slot (-1: the base model), then the page table and the
# tokens
_FSM_PRE = 11
_BIAS_PRE = 13
_ADP_PRE = _BIAS_PRE + 2 * LOGIT_BIAS_SLOTS
_PRE_COLS = _ADP_PRE + 1
_OFF = ("0", "false", "off", "no")
ROLES = ("prefill", "decode", "both")
# spills queued before a drain (the JAX engine's threshold), and the
# least pages the pinned spill ring holds
_SPILL_DRAIN_AT = 32
_SPILL_RING_MIN_PAGES = 32


class EngineStallError(RuntimeError):
    """The device completed no step within the watchdog budget. Raised on
    the engine thread; ``Engine.step`` turns it into a shed: every request
    finishes with reason "stalled", the engine is ``wedged`` and submit()
    refuses (HTTP 503 upstream)."""


class UnknownAdapterError(LookupError):
    """The request named a LoRA adapter this engine does not serve. The
    server answers a structured 404 (adapter_not_found)."""


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
    # top alternatives the client asked to see per token (response shaping
    # only: the engine always records LOGPROB_TOPK)
    logprobs: int = 0
    # OpenAI logit_bias: ((token id, bias), ...) added to the raw logits on
    # the device at every sample; at most LOGIT_BIAS_SLOTS entries
    logit_bias: tuple = ()
    # stream resume: tokens a previous replica already delivered; they are
    # prefilled after the prompt and count as output (max_tokens, penalties)
    prefix_tokens: tuple[int, ...] = ()
    # grammar-constrained decoding: an engine/grammar.CompiledGrammar (the
    # OpenAI response_format / forced tool_choice); every sampled token is
    # masked to the grammar's allowed set and the FSM advances on the device
    grammar: Optional[Any] = None


@dataclasses.dataclass
class EngineConfig:
    model: str = "debug-tiny"
    dtype: str = "bfloat16"
    max_decode_slots: int = 8
    page_size: int = 64
    num_pages: int = 512
    pages_per_slot: int = 32
    prefill_buckets: tuple[int, ...] = (64, 256, 1024)
    quantization: Optional[str] = None  # None | "int8" (weight-only) | "fp8" | "awq"
    # pipelined scheduling: keep up to async_depth decode windows in flight,
    # each window's input tokens merged on the device from the newest
    # in-flight window; a harvester thread reads the results, so the engine
    # thread waits on the device only for backpressure at full depth
    async_scheduling: bool = True
    async_depth: int = 2
    # device-queue pacing (<= 0: off): no window is dispatched while the
    # estimated undone device work exceeds this many step times, unless the
    # step admitted a request (the JAX engine's field and mechanics)
    pace_target_steps: float = 0.0
    # async admission: up to this many same-bucket waiting requests prefill
    # together in one call
    admit_batch: int = 4
    max_waiting: int = 256
    # "dus": write_tokens then the decode kernel; "fused": the decode
    # kernel that appends the current token as it attends. None => env
    # LLMK_KV_WRITE (default_kv_write_strategy), as in the JAX engine
    kv_write: Optional[str] = None
    # KV cache storage: None => the engine dtype; "int8" => per-token
    # quantized KV (data + f32 scale; about half the pool bytes and half the
    # bytes decode attention reads). None falls through to env
    # LLMK_KV_DTYPE ("", "none" and "off" mean off), as in the JAX engine
    kv_cache_dtype: Optional[str] = None
    # hash-chained reuse of cached prompt pages (engine/cache.PageAllocator);
    # a hit prefills only the remainder, through the chunk path
    prefix_caching: bool = True
    # tokens a decode window runs. None => env LLMK_DECODE_STEPS (default 4)
    decode_steps: Optional[int] = None
    # speculative decoding on the window (engine/speculation.py): "ngram"
    # drafts up to decode_steps - 1 tokens a row by prompt lookup over the
    # request's own context, "draft" rolls out a small draft model
    # (draft_model: a registry name or a .gguf path); one verify dispatch
    # scores them. None/"off" disables; a draft model alone implies
    # "draft". Env: LLMK_SPECULATION / LLMK_DRAFT_MODEL (the JAX fields)
    speculation: Optional[str] = None
    draft_model: Optional[str] = None
    seed: int = 0
    # "cuda" (the default) raises without a GPU; pass "cpu" for the CPU
    device: str = "cuda"
    # watchdog: a blocking harvest wait that sees no completion within
    # max(watchdog_stall_s, 50 x the step estimate) sheds all work as
    # "stalled" and wedges the engine. None => env LLMK_WATCHDOG_S (default
    # 120); <= 0 disables
    watchdog_stall_s: Optional[float] = None
    # goodput ledger (engine/ledger.py): per-request chip-time attribution
    # and MFU/MBU accounting. None => env LLMK_LEDGER (default on). Off:
    # no booking at all
    ledger: Optional[bool] = None
    # the ledger's step-time anomaly detector, which the server turns into
    # one bounded, rate-limited profile. None => env LLMK_ANOMALY_PROFILE
    # (default on) / LLMK_ANOMALY_Z (z-score threshold, 4.0) /
    # LLMK_ANOMALY_COOLDOWN_S (600)
    anomaly_profile: Optional[bool] = None
    anomaly_z: Optional[float] = None
    anomaly_cooldown_s: Optional[float] = None
    # grammar device-table capacities (the JAX engine's): a grammar whose
    # tables exceed states/classes is refused at submit; resident grammars
    # beyond max_grammars wait for a row, as under page pressure
    max_grammars: int = 4
    grammar_states: int = 4096
    grammar_classes: int = 512
    # the host-RAM KV tier (engine/cache.HostKVCache) in GiB: finished and
    # preempted slots spill their full pages there, a returning session
    # uploads them instead of prefilling them. Needs prefix_caching (the
    # digest chain addresses both tiers). None => env
    # LLMK_KV_HOST_CACHE_GB; <= 0: off
    kv_host_cache_gb: Optional[float] = None
    # disaggregated serving role: "both" serves prefill and decode;
    # "prefill" answers generation requests with a handoff ticket (its
    # pages spilled to the tier); "decode" adopts handed-off pages. The
    # engine stays fully capable under every role: the role shapes the
    # server. None => env LLMK_ROLE (default "both")
    role: Optional[str] = None
    # per-tenant QoS (engine/qos.py): deficit-weighted fair queuing across
    # tenants inside strict priority classes; (tenant, value) pairs (dicts
    # normalize); unlisted tenants get the defaults. Starvation aging: a
    # lower-class head waiting > qos_starvation_s goes first (<= 0: off)
    qos_weights: tuple = ()
    qos_priorities: tuple = ()
    qos_default_weight: float = 1.0
    qos_default_priority: str = "normal"
    qos_starvation_s: float = 5.0
    # multi-tenant LoRA (engine/adapters.py, ops/lora.py): (name, local
    # PEFT directory) pairs of servable adapters (a dict normalizes);
    # requests pick one by name (model="base:adapter" upstream).
    # adapter_slots bounds how many live on the device at once (LRU),
    # adapter_rank is the stack rank every adapter is padded to (a larger
    # rank is refused at load), adapter_targets the weights the stacks
    # attach to. No adapters: no stacks, and every window is the
    # adapter-free one
    adapters: tuple = ()
    adapter_slots: int = 4
    adapter_rank: int = 16
    adapter_targets: tuple = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if self.kv_write is None:
            self.kv_write = default_kv_write_strategy()
        if self.decode_steps is None:
            self.decode_steps = int(os.environ.get("LLMK_DECODE_STEPS", "4"))
        if self.kv_write not in KV_WRITE_STRATEGIES:
            raise ValueError(f"kv_write must be one of {KV_WRITE_STRATEGIES}, "
                             f"got {self.kv_write!r}")
        if self.speculation is None:
            self.speculation = os.environ.get("LLMK_SPECULATION") or None
        if self.draft_model is None:
            self.draft_model = os.environ.get("LLMK_DRAFT_MODEL") or None
        if self.speculation in ("off", "none", ""):
            self.speculation = None
        if self.speculation is None and self.draft_model is not None:
            self.speculation = "draft"  # a draft model implies the tier
        if self.speculation not in (None, "ngram", "draft"):
            raise ValueError(f"speculation must be one of None/'off'/'ngram'/'draft', "
                             f"got {self.speculation!r}")
        if self.speculation == "draft" and self.draft_model is None:
            raise ValueError("speculation='draft' requires draft_model (registry name "
                             "or .gguf path)")
        if self.watchdog_stall_s is None:
            self.watchdog_stall_s = float(os.environ.get("LLMK_WATCHDOG_S", "120"))
        if self.ledger is None:
            self.ledger = os.environ.get("LLMK_LEDGER", "1").strip().lower() not in _OFF
        if self.anomaly_profile is None:
            self.anomaly_profile = (os.environ.get("LLMK_ANOMALY_PROFILE", "1")
                                    .strip().lower() not in _OFF)
        if self.anomaly_z is None:
            self.anomaly_z = float(os.environ.get("LLMK_ANOMALY_Z", "4.0"))
        if self.anomaly_z <= 0:
            raise ValueError(f"anomaly_z must be > 0, got {self.anomaly_z}")
        if self.anomaly_cooldown_s is None:
            self.anomaly_cooldown_s = float(os.environ.get("LLMK_ANOMALY_COOLDOWN_S", "600"))
        if self.anomaly_cooldown_s < 0:
            self.anomaly_cooldown_s = 0.0
        # the tables are int16 on the device: absolute (rebased) state and
        # class ids must fit
        if not 0 < self.grammar_states <= 32767:
            raise ValueError(f"grammar_states must be in (0, 32767], got "
                             f"{self.grammar_states}")
        if not 0 < self.grammar_classes <= 32767:
            raise ValueError(f"grammar_classes must be in (0, 32767], got "
                             f"{self.grammar_classes}")
        if self.kv_cache_dtype is None:
            self.kv_cache_dtype = os.environ.get("LLMK_KV_DTYPE") or None
        if self.kv_cache_dtype in ("off", "none", ""):
            self.kv_cache_dtype = None
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None/'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {self.decode_steps}")
        for name in ("async_depth", "admit_batch"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        self.prefill_buckets = tuple(sorted(int(b) for b in self.prefill_buckets))
        if not self.prefill_buckets or self.prefill_buckets[0] < 1:
            raise ValueError(f"bad prefill_buckets {self.prefill_buckets!r}")
        if self.kv_host_cache_gb is None:
            self.kv_host_cache_gb = float(os.environ.get("LLMK_KV_HOST_CACHE_GB", "0"))
        if self.kv_host_cache_gb < 0:
            self.kv_host_cache_gb = 0.0
        if self.role is None:
            self.role = os.environ.get("LLMK_ROLE", "both").strip() or "both"
        if self.role not in ROLES:
            raise ValueError(f"role must be 'prefill', 'decode', or 'both', got {self.role!r}")
        if self.role == "prefill" and self.kv_host_cache_gb <= 0:
            raise ValueError("role='prefill' requires kv_host_cache_gb > 0: handoff tickets "
                             "point decode replicas at pages spilled into the host tier")
        if isinstance(self.qos_weights, dict):
            self.qos_weights = tuple(sorted(self.qos_weights.items()))
        self.qos_weights = tuple((str(t), float(w)) for t, w in self.qos_weights)
        for tenant, w in self.qos_weights:
            if w < MIN_WEIGHT:
                raise ValueError(f"qos weight for tenant {tenant!r} must be >= {MIN_WEIGHT}, "
                                 f"got {w}")
        if isinstance(self.qos_priorities, dict):
            self.qos_priorities = tuple(sorted(self.qos_priorities.items()))
        self.qos_priorities = tuple((str(t), str(p)) for t, p in self.qos_priorities)
        for tenant, p in self.qos_priorities:
            if p not in PRIORITIES:
                raise ValueError(f"qos priority for tenant {tenant!r} must be one of "
                                 f"{PRIORITIES}, got {p!r}")
        if self.qos_default_priority not in PRIORITIES:
            raise ValueError(f"qos_default_priority must be one of {PRIORITIES}, got "
                             f"{self.qos_default_priority!r}")
        if self.qos_default_weight < MIN_WEIGHT:
            raise ValueError(f"qos_default_weight must be >= {MIN_WEIGHT}, got "
                             f"{self.qos_default_weight}")
        # adapters: sorted (name, ref) pairs; a name must fit inside an
        # OpenAI model string ("base:adapter") and a metric label
        if isinstance(self.adapters, dict):
            self.adapters = tuple(sorted(self.adapters.items()))
        else:
            self.adapters = tuple((str(n), str(r)) for n, r in self.adapters)
        seen = set()
        for name, _ref in self.adapters:
            if not name or any(c in name for c in ":,=") or any(c.isspace() for c in name):
                raise ValueError(f"adapter name {name!r} is invalid (no ':', ',', '=', "
                                 f"whitespace, or empty)")
            if name in seen:
                raise ValueError(f"duplicate adapter name {name!r}")
            seen.add(name)
        if self.adapters:
            if self.adapter_slots < 1:
                raise ValueError(f"adapter_slots must be >= 1 when adapters are configured, "
                                 f"got {self.adapter_slots}")
            if self.adapter_rank < 1:
                raise ValueError(f"adapter_rank must be >= 1, got {self.adapter_rank}")
        self.adapter_targets = tuple(self.adapter_targets)

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
    # monotonic submission time: the youngest request is preempted first
    submitted_at: float = 0.0
    # absolute time.monotonic() deadline (None: no budget); past it a
    # waiting request is shed unadmitted and a seated one aborted, both
    # finishing "timeout"
    deadline: Optional[float] = None
    admitted_at: Optional[float] = None     # first seated (prefill dispatched)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None     # terminal event recorded (_finish)
    events: "queue.SimpleQueue[tuple[list[int], bool, Optional[str]]]" = dataclasses.field(
        default_factory=queue.SimpleQueue)
    # optional push delivery, called on the engine thread with each payload
    on_event: Optional[Any] = None
    # the server's trace of this request (anything with .event(name, **kv)):
    # preemption and the finish, with its reason, land on its timeline
    trace: Optional[Any] = None
    # goodput ledger: device milliseconds attributed to this request per
    # phase (prefill / decode / early_exit), written on the engine thread
    chip_ms: dict = dataclasses.field(default_factory=dict)
    # grammar-constrained decoding: the request's row in the device class
    # table and its absolute start state (-1: none resident);
    # pending_fsm_state carries a host-replayed state the next window sets
    fsm_row: int = -1
    fsm_start: int = -1
    pending_fsm_state: Optional[int] = None
    # per-tenant QoS: the fair-queue bucket ("" = the shared default) and
    # the resolved priority class, fixed at submit
    tenant: str = ""
    priority: str = "normal"
    # multi-tenant LoRA: the adapter this request decodes with (None: the
    # base model) and its pinned device slot (-1: none pinned)
    adapter: Optional[str] = None
    adapter_slot: int = -1
    # a prefill-only handoff request (the server answers with a ticket):
    # its spilled pages land in the host tier before its finish event
    handoff: bool = False


@dataclasses.dataclass
class StepEvent:
    request: Request
    new_tokens: list[int]
    finished: bool
    finish_reason: Optional[str]


class _HostCopy:
    """A device result on its way to the host. On a card: one non-blocking
    copy into pinned memory that this object owns, then an event recorded
    after it on the stream; ``read`` waits on the event (the wait releases
    the interpreter lock). On the CPU the tensor is already computed."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


@dataclasses.dataclass
class InflightStep:
    """A launched-but-unharvested decode window (async scheduling)."""
    pack: _HostCopy                        # the window's packed results
    toks: torch.Tensor                     # device [B] tokens after the window (merge)
    active: list[tuple[int, Request]]      # (slot, request) snapshot at launch
    seq: int = -1                          # harvester sequence number
    planned: dict = dataclasses.field(default_factory=dict)  # slot -> tokens planned
    launched_at: float = 0.0               # dispatch time (goodput ledger)
    spec: bool = False                     # a verify dispatch: accept rides the pack
    drafted: Optional[dict] = None         # slot -> tokens drafted this window


class _Harvester(threading.Thread):
    """Off-thread device-to-host reader for async scheduling.

    The engine thread pushes ``_HostCopy``s: decode windows under dense
    non-negative sequence numbers, in dispatch order, and prefills' first
    tokens under negative PRIORITY keys, which jump the queue (a new
    request's time to first token must not wait behind window reads it does
    not depend on). This thread waits on each copy's event and marks it
    done; done-ness of windows is a dense prefix (``is_done(s)`` implies
    every earlier window is done). The engine thread polls ``is_done`` /
    ``key_done`` / ``get`` and blocks only in ``wait_done`` / ``wait_key``.
    A failed read is kept and re-raised, the original exception, on every
    later query from the engine thread. All engine state stays on the
    engine thread; this thread touches only the copies and its dicts. It
    stamps each result with the monotonic time its read completed
    (``done_time``: the goodput ledger segments busy time on these) and
    sums the seconds it waited on the device (``device_time_s``)."""

    def __init__(self):
        super().__init__(daemon=True, name="engine-harvester")
        self._cv = threading.Condition()
        self._pending: "collections.deque[tuple[int, _HostCopy]]" = collections.deque()
        self._prio: "collections.deque[tuple[int, _HostCopy]]" = collections.deque()
        self._done: dict[int, np.ndarray] = {}
        self._done_t: dict[int, float] = {}
        self._done_upto = -1
        # only this thread writes it; readers tolerate a stale value
        self.device_time_s = 0.0
        self._stopping = False
        self._error: Optional[BaseException] = None

    def push(self, key: int, copy: _HostCopy, priority: bool = False) -> None:
        with self._cv:
            (self._prio if priority else self._pending).append((key, copy))
            self._cv.notify_all()

    def run(self) -> None:
        while True:
            with self._cv:
                while not (self._pending or self._prio) and not self._stopping:
                    self._cv.wait()
                if self._stopping and not (self._pending or self._prio):
                    return
                priority = bool(self._prio)
                key, copy = (self._prio if priority else self._pending).popleft()
            try:
                # fault hooks (LLMK_FAULT): a read that never completes
                # (engine_stall: the engine thread's watchdog wait must
                # fire) or a slow but live one (slow_step, per read)
                faults.inject_hang("engine_stall")
                faults.inject_delay("slow_step", 0.2)
                t0 = time.perf_counter()
                host = copy.read()
                self.device_time_s += time.perf_counter() - t0
                t_read = time.monotonic()
            except Exception as e:  # surfaces on the engine thread, never silently
                with self._cv:
                    if self._error is None:
                        self._error = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._done[key] = host
                self._done_t[key] = t_read
                if not priority:
                    self._done_upto = key
                self._cv.notify_all()

    def _check_error(self) -> None:
        if self._error is not None:
            raise self._error

    def is_done(self, seq: int) -> bool:
        self._check_error()
        return seq <= self._done_upto

    def key_done(self, key: int) -> bool:
        self._check_error()
        return key in self._done

    def get(self, key: int) -> np.ndarray:
        with self._cv:
            return self._done[key]

    def done_time(self, key: int) -> float:
        """Monotonic time ``key``'s read completed (ledger segmenting); now
        for a key whose stamp was already discarded."""
        with self._cv:
            return self._done_t.get(key, time.monotonic())

    def wait_done(self, seq: int, wake: Optional[threading.Event] = None,
                  timeout_s: Optional[float] = None) -> None:
        """Block until window ``seq`` is done, or ``wake`` is set (a new
        submission wants admission now: submit() sets it and pokes). With
        ``timeout_s`` (the watchdog budget) raise EngineStallError when the
        window is still not done at the deadline."""
        self._wait(lambda: self._done_upto >= seq, wake, timeout_s,
                   f"decode window {seq} produced no completion")

    def wait_key(self, key: int, timeout_s: Optional[float] = None) -> None:
        self._wait(lambda: key in self._done, None, timeout_s,
                   f"prefill result {-1 - key} did not arrive")

    def _wait(self, ready, wake, timeout_s, what: str) -> None:
        """Sleep on the condition (a device wait holds no core) until
        ``ready()``, ``wake`` is set or the deadline passes."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cv:
            while not ready():
                self._check_error()
                if wake is not None and wake.is_set():
                    return
                if deadline is None:
                    self._cv.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise EngineStallError(f"{what} within the {timeout_s:.1f} s "
                                           f"watchdog budget")
                self._cv.wait(timeout=min(remaining, 1.0))

    def poke(self) -> None:
        """Wake any wait_done(wake=...) waiter (called from submit())."""
        with self._cv:
            self._cv.notify_all()

    def discard_upto(self, seq: int) -> None:
        with self._cv:
            for s in [s for s in self._done if 0 <= s <= seq]:
                del self._done[s]
                self._done_t.pop(s, None)

    def discard_key(self, key: int) -> None:
        with self._cv:
            self._done.pop(key, None)
            self._done_t.pop(key, None)

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()

    def close(self) -> None:
        """Stop, and wait for the thread to finish what it holds: an
        engine's finalizer, run at interpreter exit too, where a harvester
        thread still running aborts the process on a card."""
        self.stop()
        if self.is_alive() and self is not threading.current_thread():
            self.join(timeout=30)


def _rebuild_count_rows(counts: torch.Tensor, tokens: torch.Tensor, slots: torch.Tensor,
                        history: torch.Tensor, prompt_len: torch.Tensor,
                        lengths: torch.Tensor, reset: torch.Tensor) -> None:
    """Rebuild per-slot output-token counts from a prefill/chunk batch, in
    place (the JAX ``_rebuild_count_rows``). A request's first call
    (``reset`` != 0; history may be > 0 after an adopted prefix) restarts
    its slot's counts, a later chunk adds to them. Only tokens at positions
    >= the prompt length count (penalties cover OUTPUT tokens): that is
    non-empty only for a resumed (preempted) request, whose prompt and
    output replay through this path. Rows with length 0 keep their slot's
    counts; the rows' slots are distinct."""
    T = tokens.shape[1]
    V = counts.shape[1]
    t = torch.arange(T, device=tokens.device)
    out = ((history[:, None] + t >= prompt_len[:, None]) & (t < lengths[:, None])
           & (tokens >= 0) & (tokens < V))
    rows = slots.long()
    existing = counts[rows]
    contrib = torch.zeros_like(existing).scatter_add_(
        1, torch.where(out, tokens, 0).long(), out.to(counts.dtype))
    row = torch.where((reset != 0)[:, None], 0, existing) + contrib
    counts[rows] = torch.where((lengths > 0)[:, None], row, existing)


def _wasted(led: list) -> int:
    """A window's planned row-steps that no token came out of: the ledger
    rows booked as anything but "decode" (early exit, speculative waste)."""
    return sum(n for _req, phase, n in led if phase != "decode")


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
        if engine_config.quantization not in SUPPORTED_QUANTIZATIONS:
            raise ValueError(f"unknown quantization {engine_config.quantization!r} "
                             f"(supported: {[q for q in SUPPORTED_QUANTIZATIONS if q]})")
        self.device = resolve_device(engine_config.device)
        self.model_config = model_config or model_config_for(engine_config.model, model_dir)
        cfg = self.model_config
        if params is not None:
            self.params = params
        elif model_dir is not None:
            from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params

            self.params = load_hf_params(cfg, model_dir, device=self.device,
                                         dtype=engine_config.dtype,
                                         quantization=engine_config.quantization)
        else:   # random weights (tests, smoke runs)
            if cfg.is_moe and engine_config.quantization is not None:
                from llms_on_kubernetes_tpu_torch.engine.weights import moe_quantization_refusal

                raise NotImplementedError(
                    moe_quantization_refusal(cfg, engine_config.quantization))
            self.params = init_params(cfg, seed=engine_config.seed,
                                      dtype=engine_config.dtype, device=self.device)
            if engine_config.quantization is not None:
                # random weights have no checkpoint format: every mode
                # serves weight-only int8, as in the JAX engine
                self.params = quantize_params(self.params)
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
        # per-tenant fair admission: priority classes and deficit round
        # robin keyed by Request.tenant; the deque surface the scheduler
        # uses ([0], popleft, appendleft, remove, clear, iteration)
        self.waiting: TenantFairQueue = TenantFairQueue(
            weights=dict(engine_config.qos_weights),
            default_weight=engine_config.qos_default_weight,
            starvation_s=engine_config.qos_starvation_s)
        # first admissions per (tenant, priority), and (tenant, queue-wait
        # seconds, priority) observations, drained by the server's loop
        self.tenant_admitted: "collections.Counter" = collections.Counter()
        self.tenant_wait_obs: "collections.deque" = collections.deque(maxlen=4096)
        # the host KV tier (None: off): spills queued (tenant, digests,
        # payload source) until _drain_spills lands them; per-slot staged
        # host adoptions (first device page, digests, payloads) between the
        # admission probe and its commit; seconds per upload batch; tokens
        # whose prefill an upload replaced
        self.host_kv: Optional[HostKVCache] = None
        if engine_config.kv_host_cache_gb > 0 and engine_config.prefix_caching:
            self.host_kv = HostKVCache(int(engine_config.kv_host_cache_gb * (1 << 30)),
                                       engine_config.page_size)
        self._pending_spills: list = []
        self._spill_ring: Optional[tuple] = None
        self._spill_ring_used = 0
        self._host_adopt: dict = {}
        self._upload_stage: Optional[tuple] = None
        self._upload_event = None
        self.kv_upload_obs: "collections.deque[float]" = collections.deque(maxlen=4096)
        self.kv_uploaded_tokens = 0
        self._lock = threading.Lock()
        self._id_counter = iter(range(2 ** 62))
        self._seed_rng = np.random.default_rng(engine_config.seed)
        # per-slot OUTPUT-token counts for presence/frequency penalties
        self.token_counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32,
                                        device=self.device)
        # the decode kernels' scratch, this engine's own: its captured
        # window holds the buffers' addresses
        self.workspace = DecodeWorkspace()
        # the expert kernel's scratch (MoE models on a card), sized once for
        # the largest forward: admit_batch rows of the largest bucket
        self.moe_workspace: Optional[MoEWorkspace] = None
        if cfg.is_moe and self.device.type == "cuda":
            rows = engine_config.admit_batch * max(engine_config.prefill_buckets)
            rows = max(rows, B * engine_config.decode_steps) * cfg.num_experts_per_tok
            self.moe_workspace = MoEWorkspace(rows, cfg.hidden_size, cfg.intermediate_size,
                                              torch_dtype(engine_config.dtype), self.device)
        self.prefill_calls = 0       # forward_prefill calls (one per bucket batch)
        self.chunk_calls = 0         # forward_chunk calls (one per chunk)
        self.decode_forwards = 0     # forward_decode calls (K per window)
        self.decode_dispatches = 0   # decode windows and verifies harvested
        # speculative decoding (the JAX counters): drafted / accepted count
        # DRAFT tokens only (the bonus token is ordinary decode output), so
        # accepted / drafted is the pure draft hit rate
        self.spec_dispatches = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        # per-dispatch consumed window depth (the most tokens a row took),
        # and planned row-steps a window wasted (a row that finished,
        # aborted or was rejected mid-window), as the JAX engine counts them
        self.steps_obs: "collections.deque[int]" = collections.deque(maxlen=4096)
        self.early_exit_steps = 0
        self.preemptions = 0         # KV-pressure preemptions
        # set by _shed_wedged() when a device step outlasted the watchdog
        # budget: submit() refuses from then on and the server turns /health
        # and /ready to 503; a process restart is the only recovery
        self.wedged = False
        # multi-tenant LoRA: zeroed stacks join the layer params BEFORE the
        # window is captured (the graph holds their addresses)
        self._adapters = None
        if engine_config.adapters:
            self._init_adapters()
        # the window, captured on a card before the harvester starts
        self._window = DecodeWindow(
            self.params, cfg, self.k_pages, self.v_pages, self.token_counts, self.workspace,
            moe_workspace=self.moe_workspace, decode_steps=engine_config.decode_steps, slots=B,
            pages_per_slot=engine_config.pages_per_slot,
            admit_rows=engine_config.admit_batch, seed=engine_config.seed,
            kv_write=engine_config.kv_write, device=self.device)
        # async scheduling state (EngineConfig.async_scheduling)
        self._async = bool(engine_config.async_scheduling)
        self._inflight: "collections.deque[InflightStep]" = collections.deque()
        # (request, priority key, row) awaiting a first-token read
        self._pending_first: list[tuple[Request, int, int]] = []
        self._seq_counter = iter(range(2 ** 62))     # decode windows (dense)
        self._first_counter = iter(range(2 ** 62))   # priority prefill reads
        # set by submit(): breaks the backpressure wait so admission (and
        # the new request's prefill) never waits out a read
        self._admit_wake = threading.Event()
        # pacing: the device step time (a window's), calibrated from the
        # spacing of harvested windows, and the estimated wall time when all
        # dispatched work completes (the JAX engine's _est_step, _busy_until)
        self._est_step = 0.02
        self._busy_until = 0.0
        self._last_harvest_t: Optional[float] = None
        # goodput ledger (None: accounting off): in-flight prefill calls
        # awaiting their priority read, key -> (launch time, [(request,
        # tokens)]); seconds the engine thread waited on device reads
        self.ledger: Optional[GoodputLedger] = None
        if engine_config.ledger:
            det = None
            if engine_config.anomaly_profile:
                det = StepAnomalyDetector(
                    threshold=engine_config.anomaly_z,
                    cooldown_s=engine_config.anomaly_cooldown_s,
                    sustain=int(os.environ.get("LLMK_ANOMALY_SUSTAIN", "3")),
                    warmup=int(os.environ.get("LLMK_ANOMALY_WARMUP", "12")))
            self.ledger = GoodputLedger(cfg, detector=det, device=self.device)
        self._ledger_prefills: dict[int, tuple[float, list]] = {}
        self._device_time_s = 0.0
        # grammar residency (_ensure_grammar): key -> [row, base, states,
        # refs, grammar]; host mirrors of the device tables; the device
        # (state, class_of, trans), all made at the first constrained
        # admission, at capacity
        self._g_resident: dict = {}
        self._g_class_h: Optional[np.ndarray] = None
        self._g_trans_h: Optional[np.ndarray] = None
        self._fsm_state: Optional[torch.Tensor] = None
        self._g_dev: Optional[tuple] = None
        self._harvester: Optional[_Harvester] = None
        if self._async:
            self._harvester = _Harvester()
            self._harvester.start()
            self._close = weakref.finalize(self, self._harvester.close)
        # speculative decoding (engine/speculation.py): only on the async
        # path with room to draft (decode_steps > 1), as in the JAX engine
        self._spec = None
        if (engine_config.speculation is not None and self._async
                and engine_config.decode_steps > 1):
            from llms_on_kubernetes_tpu_torch.engine.speculation import build_speculator

            self._spec = build_speculator(engine_config, cfg, self.device)

    # ------------------------------------------------------------------
    # multi-tenant LoRA (engine/adapters.py, ops/lora.py)
    # ------------------------------------------------------------------

    @property
    def adapters(self):
        """The AdapterManager, or None on an adapter-free engine."""
        return self._adapters

    def _init_adapters(self) -> None:
        """One zeroed ``LoRAStack`` a target in ``params["layers"]``
        (``lora_<target>``), made once, and the slot manager."""
        from llms_on_kubernetes_tpu_torch.engine.adapters import AdapterManager, load_adapter

        cfg, ec = self.model_config, self.config
        D, F = cfg.hidden_size, cfg.intermediate_size
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        # (in_shape, out_shape) in the decoder's layouts
        shapes = {"wq": ((D,), (H, hd)), "wk": ((D,), (KV, hd)), "wv": ((D,), (KV, hd)),
                  "wo": ((H, hd), (D,)), "w_gate": ((D,), (F,)), "w_up": ((D,), (F,)),
                  "w_down": ((F,), (D,))}
        if cfg.is_moe and any(t.startswith("w_") for t in ec.adapter_targets):
            raise ValueError(
                f"adapter_targets {ec.adapter_targets} include MLP projections, but "
                f"{cfg.name!r} is MoE (per-expert LoRA is not supported); use "
                f"attention-only targets")
        S, r = ec.adapter_slots, ec.adapter_rank
        layers = dict(self.params["layers"])
        for t in ec.adapter_targets:
            if t not in shapes:
                raise ValueError(f"unknown adapter target {t!r} (supported: {sorted(shapes)})")
            layers["lora_" + t] = lora_zeros(cfg.num_layers, S, *shapes[t], r,
                                             device=self.device)
        self.params = {**self.params, "layers": layers}

        def _load(name: str, ref: str):
            if not os.path.isdir(ref):
                from llms_on_kubernetes_tpu_torch.engine.adapters import AdapterError

                raise AdapterError(f"adapter {name!r}: {ref!r} is not a local directory "
                                   f"(the port loads adapters from disk only)")
            return load_adapter(name, ref, cfg, r, targets=ec.adapter_targets)

        self._adapters = AdapterManager(dict(ec.adapters), S, _load, self._upload_adapter)

    def _upload_adapter(self, slot: int, loaded) -> None:
        """Copy one adapter's factors into slot ``slot`` of every target
        stack, zeroing the targets it does not train. In place (the
        captured windows hold the stacks' addresses), from pinned memory on
        the compute stream: windows already launched read the old factors,
        later ones the new."""
        layers = self.params["layers"]
        for t in self.config.adapter_targets:
            stack: LoRAStack = layers["lora_" + t]
            fac = loaded.factors.get(t)
            for dst, src in ((stack.a, None if fac is None else fac[0]),
                             (stack.b, None if fac is None else fac[1])):
                if src is None:
                    dst[:, slot].zero_()
                elif self.device.type == "cpu":
                    dst[:, slot].copy_(torch.from_numpy(src))
                else:
                    dst[:, slot].copy_(torch.from_numpy(src).pin_memory(), non_blocking=True)

    def _ensure_adapter(self, req: "Request") -> bool:
        """Pin ``req``'s adapter into a device slot; False: every slot is
        pinned by running requests, and the caller waits, as under page
        pressure."""
        if req.adapter is None or req.adapter_slot >= 0:
            return True
        slot = self._adapters.acquire(req.adapter)
        if slot is None:
            return False
        req.adapter_slot = slot
        return True

    def _release_adapter(self, req: "Request") -> None:
        if req.adapter_slot >= 0 and self._adapters is not None:
            self._adapters.release(req.adapter_slot)
            req.adapter_slot = -1

    @property
    def graph_replays(self) -> int:
        """Decode windows run as one CUDA graph replay (0 on the CPU)."""
        return self._window.replays

    @property
    def fsm_graph_replays(self) -> int:
        """The part of ``graph_replays`` that replayed the FSM window."""
        return self._window.fsm_replays

    @property
    def verify_replays(self) -> int:
        """Verify dispatches run as one CUDA graph replay (0 on the CPU)."""
        return self._window.verify_replays

    def device_wait_s(self) -> float:
        """Cumulative seconds spent waiting on device reads: the
        harvester's and the engine thread's own (sync path), the runtime
        telemetry's device share of a step."""
        h = self._harvester.device_time_s if self._harvester is not None else 0.0
        return self._device_time_s + h

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, prompt: list[int], params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None, on_event=None,
               deadline: Optional[float] = None, tenant: Optional[str] = None,
               priority: Optional[str] = None, handoff: bool = False,
               adapter: Optional[str] = None) -> Request:
        if self.wedged:
            raise EngineStallError("engine wedged: a device step stalled past the watchdog "
                                   "budget; restart the server to recover")
        params = params or SamplingParams()
        max_len = self.config.max_model_len
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if adapter is not None and (self._adapters is None or not self._adapters.known(adapter)):
            raise UnknownAdapterError(
                f"adapter {adapter!r} is not served by this engine "
                f"(configured: {self._adapters.names() if self._adapters else []})")
        if params.top_k > MAX_CANDIDATES:
            raise ValueError(f"top_k={params.top_k} exceeds the sampling candidate pool "
                             f"({MAX_CANDIDATES}); values above it are not supported")
        if params.grammar is not None:
            g = params.grammar
            if (g.n_states > self.config.grammar_states
                    or g.n_classes > self.config.grammar_classes):
                raise ValueError(
                    f"grammar needs {g.n_states} states / {g.n_classes} "
                    f"token classes; this engine's device-table caps are "
                    f"{self.config.grammar_states} / "
                    f"{self.config.grammar_classes}")
            if len(g.class_of) > self.model_config.vocab_size:
                raise ValueError(
                    f"grammar was compiled for a {len(g.class_of)}-token "
                    f"vocabulary; the model's is "
                    f"{self.model_config.vocab_size}")
        for name in ("presence_penalty", "frequency_penalty"):
            val = getattr(params, name)
            if not -2.0 <= val <= 2.0:
                raise ValueError(f"{name} must be in [-2, 2], got {val}")
        if len(params.logit_bias) > LOGIT_BIAS_SLOTS:
            raise ValueError(f"logit_bias supports at most {LOGIT_BIAS_SLOTS} entries, "
                             f"got {len(params.logit_bias)}")
        if len(params.stop_token_ids) > STOP_SLOTS:
            raise ValueError(f"stop_token_ids supports at most {STOP_SLOTS} entries, "
                             f"got {len(params.stop_token_ids)}")
        seen_bias: set[int] = set()
        for tid, _value in params.logit_bias:
            if not 0 <= tid < self.model_config.vocab_size:
                raise ValueError(f"logit_bias token id {tid} outside the vocabulary "
                                 f"(size {self.model_config.vocab_size})")
            if tid in seen_bias:
                # the scatter adds duplicates up, unlike a map
                raise ValueError(f"logit_bias has duplicate token id {tid}")
            seen_bias.add(tid)
        if params.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {params.max_tokens}")
        if len(prompt) + 1 > max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit max_model_len="
                             f"{max_len} (page_size*pages_per_slot) with room to generate")
        if len(prompt) + params.max_tokens > max_len:
            params = dataclasses.replace(params, max_tokens=max(1, max_len - len(prompt)))
        prefix = list(params.prefix_tokens or ())
        if prefix:
            vocab = self.model_config.vocab_size
            for t in prefix:
                if not isinstance(t, int) or not 0 <= t < vocab:
                    raise ValueError(f"prefix_tokens contains id {t!r} outside the "
                                     f"vocabulary (size {vocab})")
            if len(prompt) + len(prefix) + 1 > max_len:
                raise ValueError(f"prompt ({len(prompt)}) + prefix_tokens ({len(prefix)}) "
                                 f"cannot fit max_model_len={max_len} with room to generate")
            if len(prefix) >= params.max_tokens:
                raise ValueError(f"prefix_tokens ({len(prefix)}) already meets max_tokens "
                                 f"({params.max_tokens}); nothing left to generate")
        if (self.allocator.pages_needed(len(prompt) + params.max_tokens)
                > self.config.num_pages - 1):
            # a request that cannot fit the pool alone would preempt itself
            # forever
            raise ValueError(f"prompt + max_tokens ({len(prompt) + params.max_tokens} "
                             f"tokens) needs more pages than the pool holds "
                             f"({self.config.num_pages - 1})")
        # QoS identity: the fair-queue bucket ("" = the shared default) and
        # the class, resolved submit argument > per-tenant config > default
        tenant = str(tenant) if tenant else ""
        if priority is None:
            priority = dict(self.config.qos_priorities).get(
                tenant, self.config.qos_default_priority)
        priority = normalize_priority(priority, self.config.qos_default_priority)
        with self._lock:
            seed = (params.seed if params.seed is not None
                    else int(self._seed_rng.integers(0, 2 ** 31 - 1))) & 0x7FFFFFFF
            # a prefix is output already delivered: admission takes the
            # resumed re-prefill path (prompt + output), as after a
            # preemption; its logprobs were computed elsewhere
            req = Request(id=request_id or f"req-{next(self._id_counter)}",
                          prompt=[int(t) for t in prompt], params=params, seed=seed,
                          submitted_at=time.monotonic(), deadline=deadline,
                          output=prefix, output_logprobs=[None] * len(prefix),
                          on_event=on_event, tenant=tenant, priority=priority,
                          handoff=handoff, adapter=adapter,
                          cache_salt=self._adapter_salt(adapter))
            if len(self.waiting) >= self.config.max_waiting:
                raise QueueFullError(f"waiting queue is full ({self.config.max_waiting} "
                                     f"requests); retry later")
            self.waiting.append(req)
        if self._harvester is not None:
            self._admit_wake.set()
            self._harvester.poke()      # break any backpressure wait: admit now
        return req

    def _adapter_salt(self, adapter: Optional[str]) -> bytes:
        """The digest-chain salt of a request: ``b""`` for the base model
        (the JAX engine's text salt), the adapter's name and directory for
        an adapter request, so its pages never serve another model's."""
        if adapter is None:
            return b""
        return b"lora\0" + adapter.encode() + b"\0" + self._adapters.registry[adapter].encode()

    def has_work(self) -> bool:
        return (bool(self.waiting) or any(r is not None for r in self.slots)
                or bool(self._inflight) or bool(self._pending_first))

    def abort(self, req: Request, reason: str = "abort") -> None:
        """Cancel from any thread; the next step() releases the slot."""
        req.abort_reason = reason

    # ------------------------------------------------------------------
    # scheduler iteration
    # ------------------------------------------------------------------

    def step(self) -> list[StepEvent]:
        events = self._reap_aborted()
        if self.wedged:
            # nothing left to drive; reap what slipped in before the wedge
            self._deliver(events)
            return events
        if self._async:
            try:
                admitted = self._admit_async(events)
                status = self._launch_decode(admitted, events)
                events += self._harvest(drain=status == "idle")
            except EngineStallError as e:
                events += self._shed_wedged(str(e))
                status = "idle"
            self._deliver(events)
            if status == "paced" and not events and not self.waiting:
                # paced, or every row's budget is in flight: nothing to do
                # until device work completes; a bounded nap keeps the loop
                # from burning the lock the harvester needs (an admission
                # arriving mid-nap waits at most 1 ms)
                time.sleep(0.001)
            return events
        # first tokens go out before the decode window runs, so a new
        # request's time to first token does not include the window
        events += self._admit()
        self._deliver(events)
        window = self._decode()
        self._deliver(window)
        return events + window

    def shed(self, reason: str) -> list[StepEvent]:
        """Finish every waiting, running and in-flight request with
        ``reason`` (the serving loop's answer to a failed step: clients get
        a terminal event instead of a hang). Windows still on the device
        complete and are discarded unread."""
        events = self._finish_all(reason)
        self._deliver(events)
        return events

    def _finish_all(self, reason: str) -> list[StepEvent]:
        with self._lock:
            doomed = list(self.waiting)
            self.waiting.clear()
        doomed += [r for r in self.slots if r is not None]
        doomed += [r for r, _key, _row in self._pending_first]
        events = [self._finish(r, reason) for r in doomed if not r.finished]
        self._inflight.clear()
        self._pending_first = []
        self._ledger_prefills.clear()
        self._host_adopt.clear()
        return events

    def _stall_budget(self) -> Optional[float]:
        """The longest a blocking harvest wait may go without a completion:
        max(watchdog_stall_s, 50 x the step estimate), so a slow but live
        card is not shed; None when the watchdog is off."""
        limit = self.config.watchdog_stall_s
        if not limit or limit <= 0:
            return None
        return max(float(limit), 50.0 * self._est_step)

    def _shed_wedged(self, why: str) -> list[StepEvent]:
        """A device step outlasted the watchdog budget: finish every
        waiting, slotted and pending-first request with "stalled" and mark
        the engine wedged. The windows still on the device are forgotten;
        the harvester may go on waiting for them."""
        print(f"[engine] wedged: {why}; waiting {len(self.waiting)}, active "
              f"{sum(r is not None for r in self.slots)}", file=sys.stderr, flush=True)
        self.wedged = True
        # spill copies queued behind the stalled work never land
        self._pending_spills.clear()
        self._spill_ring_used = 0
        return self._finish_all("stalled")

    def prefix_filter_digests(self) -> list[bytes]:
        """Every chained page digest this replica can serve as cache now,
        the device prefix cache's and the host tier's: what the server's
        /ready bloom filter advertises to the routers. A snapshot, safe
        from server threads."""
        out = self.allocator.prefix_digests()
        if self.host_kv is not None:
            seen = set(out)
            out.extend(d for d in self.host_kv.digests() if d not in seen)
        return out

    # ------------------------------------------------------------------
    # disaggregated prefill/decode handoff (the server drives these from
    # its threads; HostKVCache is locked for that)
    # ------------------------------------------------------------------

    def handoff_digests(self, tokens, salt: bytes = b"") -> list[bytes]:
        """Chained digests of the FULL pages of ``tokens``: the handoff
        ticket's address of what ``_finish`` spilled. Pure hashing, safe
        from any thread."""
        page = self.allocator.page_size
        if len(tokens) // page <= 0:
            return []
        return self.allocator._digests(tokens[:len(tokens) // page * page], salt=salt)

    def host_kv_export(self, tenant: str, digests: list[bytes]) -> list[Optional[dict]]:
        """Host-tier payloads for a pulling decode replica (None per missing
        page; all None when the tier is off)."""
        if self.host_kv is None:
            return [None] * len(digests)
        return self.host_kv.export(tenant, digests)

    def host_kv_ingest(self, tenant: str, digest: bytes, payload: dict) -> bool:
        """Land one pulled handoff page in this replica's host tier, so the
        next admission's chain walk finds it. A payload whose shapes or
        dtypes do not fit this engine's pools is refused (False): that
        page re-prefills, degraded, never wrong bytes."""
        if self.host_kv is None or not payload_shape_ok(payload, self.cache_config):
            return False
        self.host_kv.put(tenant, digest, as_pool_view(payload))
        return True

    def score_prompt(self, prompt: list[int]) -> tuple[list, list, list]:
        """Per-position prompt logprobs (the OpenAI ``echo`` + ``logprobs``
        surface), as the JAX ``score_prompt``: (token_logprobs [len - 1],
        entry i scoring prompt[i + 1]; top_ids [len, LOGPROB_TOPK];
        top_logprobs [len, LOGPROB_TOPK]). The prompt is padded to the
        smallest prefill bucket that fits, or past the largest to a multiple
        of it, and scored by ``forward_score``: cache-free, its KV writes go
        to a private one-page pool, never the serving pool. Call it between
        steps, on the thread that steps the engine (the server's loop does):
        it reads the result back, so it waits for the work queued before it."""
        n = len(prompt)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.config.max_model_len:
            raise ValueError(f"prompt of {n} tokens exceeds max_model_len="
                             f"{self.config.max_model_len}")
        bucket = next((b for b in self.config.prefill_buckets if n <= b), None)
        if bucket is None:
            big = max(self.config.prefill_buckets)
            bucket = -(-n // big) * big
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = prompt
        nxt_lp, top_ids, top_lp = forward_score(
            self.params, self.model_config, upload(tokens, self.device),
            upload(np.array([n], np.int32), self.device), top_k=LOGPROB_TOPK,
            moe_workspace=self.moe_workspace)
        return (nxt_lp[0, :n - 1].cpu().tolist(), top_ids[0, :n].cpu().tolist(),
                top_lp[0, :n].cpu().tolist())

    def generate(self, prompt: list[int], params: Optional[SamplingParams] = None,
                 adapter: Optional[str] = None) -> list[int]:
        """Synchronous single-request generation (drives the scheduler)."""
        req = self.submit(prompt, params, adapter=adapter)
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
        """Finish every aborted request. First the deadline sweep (the JAX
        engine's): an expired request becomes an abort with reason
        "timeout", so it rides the path a client disconnect takes; a
        waiting one is shed without a prefill."""
        now = time.monotonic()
        with self._lock:
            for r in self.waiting:
                if (r.deadline is not None and now >= r.deadline
                        and not r.abort_reason and not r.finished):
                    r.abort_reason = "timeout"
        for r in self.slots:
            if (r is not None and r.deadline is not None and now >= r.deadline
                    and not r.abort_reason and not r.finished):
                r.abort_reason = "timeout"
        with self._lock:
            doomed = [r for r in self.waiting if r.abort_reason and not r.finished]
            for r in doomed:
                self.waiting.remove(r)
        doomed += [r for r in self.slots
                   if r is not None and r.abort_reason and not r.finished]
        return [self._finish(r, r.abort_reason) for r in doomed]

    def _free_slot(self) -> Optional[int]:
        return next((i for i, r in enumerate(self.slots) if r is None), None)

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"no prefill bucket fits {n} tokens")

    def _emit(self, req: Request, token: int, lp: Optional[tuple]) -> list[StepEvent]:
        """Record a sampled token and decide whether the request finishes."""
        if not req.output:
            req.first_token_at = time.monotonic()
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
        req.finished_at = time.monotonic()
        if req.trace is not None:
            req.trace.event("finish", request=req.id, reason=reason, tokens=len(req.output))
        self._g_release(req)
        self._release_adapter(req)
        if req.slot >= 0:
            # spill the full pages to the host tier BEFORE the allocator can
            # hand them on (not on a wedged card: the gather would never run)
            if reason != "stalled" and not self.wedged:
                self._spill_slot(req)
                # a handoff's whole product is its spilled pages: they land
                # in the tier before the finish event reaches the server,
                # so the decode replica's pull never races the drain
                if (self.config.role == "prefill" or req.handoff) and self.host_kv is not None:
                    self._drain_spills()
            self.allocator.free(req.slot)
            self.slot_len[req.slot] = 0
            self.slots[req.slot] = None
            req.slot = -1
        return StepEvent(req, [], True, reason)

    def _note_admission(self, req: Request) -> None:
        """Per-tenant admission accounting at a request's FIRST seating (a
        preemption round trip is not new tenant throughput)."""
        if req.admitted_at is not None:
            return
        self.tenant_admitted[(req.tenant, req.priority)] += 1
        self.tenant_wait_obs.append((req.tenant, time.monotonic() - req.submitted_at,
                                     req.priority))

    def _preempt_youngest(self) -> None:
        """Free a victim's pages and requeue it at the front, to resume
        (prompt + output so far) when pages free up. The victim is the
        lowest class's youngest submission (batch before normal before
        interactive), so KV pressure lands on preemptible traffic first.
        With the host tier on, its full pages spill there first and its
        admission uploads them instead of prefilling them."""
        victims = [r for r in self.slots if r is not None]
        if not victims:
            raise MemoryError("KV pool exhausted with no preemptable request")
        victim = max(victims, key=lambda r: (priority_rank(r.priority), r.submitted_at))
        self.preemptions += 1
        if victim.trace is not None:
            victim.trace.event("preempted", request=victim.id, tokens=len(victim.output))
        slot = victim.slot
        self._spill_slot(victim)
        self.allocator.free(slot)
        self.slot_len[slot] = 0
        self.slots[slot] = None
        victim.slot = -1
        victim.pending_token = -1
        # a resumed admission re-ensures residency and replays its state,
        # and re-pins its adapter (a reload is a host-cached upload)
        self._g_release(victim)
        self._release_adapter(victim)
        with self._lock:
            self.waiting.appendleft(victim)

    # ------------------------------------------------------------------
    # admission and prefill
    # ------------------------------------------------------------------

    def _seat_next(self, events: list[StepEvent], accept=None) -> Optional[tuple]:
        """Seat the queue's head (the caller holds ``_lock``): a slot, the
        longest cached prefix of its prompt (device pages, then host-tier
        pages staged for ``_host_kv_commit``), and pages for its prefill
        tokens and one more. A fresh request prefills its prompt; a resumed
        (preempted: it has output) one its prompt and every output token
        but the pending last one, and finishes with "length" here when that
        no longer fits a slot. Returns (slot, request, prefill tokens,
        adopted prefix tokens, resumed), or None to stop admitting: no free
        slot, no pages yet (FIFO: no overtaking), or ``accept(tokens,
        hit)`` false (the caller's batch cannot take it now)."""
        alloc = self.allocator
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                return None
            req = self.waiting[0]
            if req.params.grammar is not None and not self._ensure_grammar(req):
                return None     # every grammar row pinned: wait, as for pages
            if req.adapter is not None and not self._ensure_adapter(req):
                return None     # every adapter slot pinned: wait, as for pages
            resumed = bool(req.output)
            ptoks = req.prompt + req.output[:-1] if resumed else req.prompt
            n = len(ptoks)
            if alloc.pages_needed(n + 1) > alloc.pages_per_slot:
                self.waiting.popleft()
                events.append(self._finish(req, "length"))
                continue
            # adopt the cached prefix FIRST, so the page check counts only
            # the pages past it; roll back if the request is not taken now
            hit = self._adopt_cached_prefix(slot, req, ptoks)
            if ((accept is not None and not accept(ptoks, hit))
                    or not alloc.can_allocate(slot, n + 1)):
                if hit:
                    alloc.rollback_adopt(slot)
                self._host_adopt.pop(slot, None)
                return None
            self.waiting.popleft()
            alloc.allocate(slot, n + 1)
            if hit:
                alloc.commit_adopt(slot, hit)
            self.slots[slot] = req
            req.slot = slot
            self._note_admission(req)
            if req.admitted_at is None:
                req.admitted_at = time.monotonic()
            if resumed and req.fsm_row >= 0:
                self._fsm_replay(req)      # stages fsm_set for the next window
            return slot, req, ptoks, hit, resumed
        return None

    def _runs_alone(self, ptoks: list[int], hit: int) -> bool:
        """A cache hit or a prompt past the largest bucket takes the chunk
        path, alone."""
        return hit > 0 or len(ptoks) > max(self.config.prefill_buckets)

    def _admit(self) -> list[StepEvent]:
        """Sync admission: seat waiting requests in order while a slot and
        their pages are free, then prefill them: one call per bucket, and
        the chunk path for each request with a cache hit or past the
        largest bucket."""
        events: list[StepEvent] = []
        if faults.is_active("queue_stall"):
            # LLMK_FAULT=queue_stall: admission refuses while the flag is
            # set; waiting requests age (deadline sheds, the 429's
            # Retry-After)
            return events
        seats = []
        with self._lock:
            while (seat := self._seat_next(events)) is not None:
                seats.append(seat)
        for seat in seats:
            # host-tier pages upload before any prefill below is dispatched
            self._host_kv_commit(seat[0], seat[1])
        by_bucket: dict[int, list[tuple]] = {}
        chunked = []
        for seat in seats:
            _slot, _req, ptoks, hit, _resumed = seat
            if self._runs_alone(ptoks, hit):
                chunked.append(seat)
            else:
                by_bucket.setdefault(self._bucket_for(len(ptoks)), []).append(seat)
        for bucket, rows in sorted(by_bucket.items()):
            t_launch = time.monotonic()
            pack, _ = self._prefill(bucket, [(req, ptoks) for _s, req, ptoks, _h, _r in rows])
            events += self._first_tokens(rows, pack)
            self._book(t_launch, time.monotonic(),
                       [(req, "prefill", max(1, len(ptoks))) for _s, req, ptoks, _h, _r in rows])
        for seat in chunked:
            t_launch = time.monotonic()
            pack, _ = self._chunked_prefill(seat[1], seat[2], start=seat[3])
            events += self._first_tokens([seat], pack)
            self._book(t_launch, time.monotonic(),
                       [(seat[1], "prefill", max(1, len(seat[2]) - seat[3]))])
        return events

    def _book(self, t_launch: float, t_done: float, rows: list, window: int = 1) -> None:
        """One dispatch into the goodput ledger, if it is on."""
        if self.ledger is not None:
            self.ledger.record(t_launch, t_done, rows, window=window)

    def _first_tokens(self, seats: list[tuple], pack: torch.Tensor) -> list[StepEvent]:
        """Sync: read a prefill's samples, publish each prompt's full pages
        to the prefix cache, and emit each fresh request's first token (a
        resumed request restores its pending token instead)."""
        t0 = time.perf_counter()
        out = unpack_results(pack.cpu().numpy())
        self._device_time_s += time.perf_counter() - t0
        events: list[StepEvent] = []
        for r, (slot, req, ptoks, _hit, resumed) in enumerate(seats):
            self.slot_len[slot] = len(ptoks)
            # before _emit, which frees the slot of a request that finishes
            self.allocator.register_prefix(slot, req.prompt, salt=req.cache_salt)
            if resumed:
                req.pending_token = req.output[-1]
                continue
            tok = int(out[0][r])
            req.pending_token = tok
            events += self._emit(req, tok, _lp_entry(out, r))
        return events

    def _pack_row(self, host: np.ndarray, r: int, req: Request, m: int, history: int,
                  reset: bool) -> None:
        p = req.params
        host[r, :7] = (m, history, p.top_k, req.seed, req.slot, len(req.prompt), int(reset))
        host[r, 7:11] = np.array([p.temperature, p.top_p, p.presence_penalty,
                                  p.frequency_penalty], np.float32).view(np.int32)
        # a fresh constrained request starts at its grammar's start state; a
        # resumed one samples a discarded token unconstrained
        if req.fsm_row >= 0 and not req.output:
            host[r, _FSM_PRE:_FSM_PRE + 2] = (req.fsm_row, req.fsm_start)
        else:
            host[r, _FSM_PRE:_FSM_PRE + 2] = -1
        pack_bias(host, r, _BIAS_PRE, p.logit_bias)
        host[r, _ADP_PRE] = req.adapter_slot
        host[r, _PRE_COLS:_PRE_COLS + self.config.pages_per_slot] = \
            self.allocator.page_tables[req.slot]

    def _device_rows(self, host: np.ndarray) -> tuple:
        """One host-to-device copy of packed prefill rows: (lengths, history,
        top_k, seeds, slots, prompt_len, reset, floats [R, 4], bias (ids,
        values), page_table, tokens, FSM (rows, start states) or None when
        no row is constrained, the rows' adapter slots or None on an
        adapter-free engine)."""
        d = upload(host, self.device)
        pt_end = _PRE_COLS + self.config.pages_per_slot
        fsm = None
        if (host[:, _FSM_PRE] >= 0).any():
            fsm = (d[:, _FSM_PRE].contiguous(), d[:, _FSM_PRE + 1].contiguous())
        adp = d[:, _ADP_PRE].contiguous() if self._adapters is not None else None
        return (*(d[:, c].contiguous() for c in range(7)), d[:, 7:11].view(torch.float32),
                unpack_bias(d, _BIAS_PRE), d[:, _PRE_COLS:pt_end].contiguous(),
                d[:, pt_end:].contiguous(), fsm, adp)

    def _sample_first(self, logits, positions, top_k, seeds, fl, bias, slots, fsm=None,
                      lengths=None):
        """Sample each row's first token from its prompt's last logits, the
        noise keyed on the prompt length. With ``fsm`` (the rows' grammar
        rows and start states) constrained rows sample from their start
        state's allowed tokens and a real fresh row writes its slot's next
        state (the JAX ``_fsm_scatter``). Returns (packed results, tokens),
        on the device."""
        noise = gumbel_noise(self.config.seed, seeds, positions,
                             min(MAX_CANDIDATES, logits.shape[1]))
        allowed = None
        if fsm is not None:
            allowed, nxt_all, _ = fsm_apply(*self._g_dev, fsm[0], fsm[1])
        res = sample(logits, noise, fl[:, 0], top_k, fl[:, 1],
                     penalties=(fl[:, 2], fl[:, 3], self.token_counts[slots.long()]),
                     bias=bias, allowed=allowed)
        if fsm is not None:
            fsm_scatter(self._fsm_state, fsm[0], fsm[1], nxt_all, res.tokens, lengths, slots)
        return pack_results([res]), res.tokens

    def _prefill(self, bucket: int, rows: list[tuple[Request, list[int]]]):
        """One ``forward_prefill`` call over ``rows`` (request, tokens to
        prefill), padded to ``bucket``; the rows' penalty counts are rebuilt
        first. Returns (packed samples, sampled tokens), on the device.

        Two or more rows are padded to ``admit_batch`` rows (at most one a
        slot), as the JAX engine pads them: the matmuls then see one row
        count a bucket besides 1, so a request's KV and first token do not
        depend on how many requests shared its prefill (a resumed request
        re-prefills in other company than its first prefill had). A padded
        row has length 0: it writes only the trash page, and its slot (one
        no real row uses) keeps its counts."""
        pps, B = self.config.pages_per_slot, self.config.max_decode_slots
        n = len(rows)
        R = n if n == 1 else max(n, min(self.config.admit_batch, B))
        host = np.zeros((R, _PRE_COLS + pps + bucket), np.int32)
        for r, (req, ptoks) in enumerate(rows):
            self._pack_row(host, r, req, len(ptoks), 0, True)
            host[r, _PRE_COLS + pps:_PRE_COLS + pps + len(ptoks)] = ptoks
        used = {req.slot for req, _ in rows}
        host[n:, 4] = [s for s in range(B) if s not in used][:R - n]
        host[n:, 8] = np.float32(1.0).view(np.int32)      # top_p off
        host[n:, _FSM_PRE:_FSM_PRE + 2] = -1               # padded rows: none
        host[n:, _ADP_PRE] = -1                            # padded rows: the base model
        (lengths, history, top_k, seeds, slots, prompt_len, reset, fl, bias, page_table,
         tokens, fsm, adp) = self._device_rows(host)
        _rebuild_count_rows(self.token_counts, tokens, slots, history, prompt_len, lengths,
                            reset)
        logits, _, _ = forward_prefill(self.params, self.model_config, tokens, lengths,
                                       self.k_pages, self.v_pages, page_table, adp,
                                       moe_workspace=self.moe_workspace)
        self.prefill_calls += 1
        return self._sample_first(logits, lengths, top_k, seeds, fl, bias, slots, fsm, lengths)

    def _chunked_prefill(self, req: Request, ptoks: list[int], start: int = 0):
        """Prefill ``ptoks`` from position ``start`` (> 0 when a cached
        prefix was adopted: those positions' KV is already in the slot's
        pages) in chunks of the largest bucket, each padded to the smallest
        bucket that fits, one ``forward_chunk`` call per chunk with history
        = the position it starts at. Only the final chunk's logits are
        sampled, exactly as a one-shot prefill would sample them. Returns
        (packed samples, sampled tokens), on the device."""
        n = len(ptoks)
        step = max(self.config.prefill_buckets)
        pps = self.config.pages_per_slot
        pos = start
        while pos < n:
            m = min(step, n - pos)
            host = np.zeros((1, _PRE_COLS + pps + self._bucket_for(m)), np.int32)
            self._pack_row(host, 0, req, m, pos, pos == start)
            host[0, _PRE_COLS + pps:_PRE_COLS + pps + m] = ptoks[pos:pos + m]
            (lengths, history, top_k, seeds, slots, prompt_len, reset, fl, bias,
             page_table, tokens, fsm, adp) = self._device_rows(host)
            _rebuild_count_rows(self.token_counts, tokens, slots, history, prompt_len,
                                lengths, reset)
            logits, _, _ = forward_chunk(self.params, self.model_config, tokens, history,
                                         lengths, self.k_pages, self.v_pages, page_table, adp,
                                         moe_workspace=self.moe_workspace)
            self.chunk_calls += 1
            pos += m
        return self._sample_first(logits, history + lengths, top_k, seeds, fl, bias, slots,
                                  fsm, lengths)

    # ------------------------------------------------------------------
    # decode windows
    # ------------------------------------------------------------------

    def _window_rows(self, active: list[tuple[int, Request]], plan: dict,
                     base: dict) -> np.ndarray:
        """The packed window rows: each active row's sampling parameters,
        stop ids, logit_bias, grammar row (and a replayed FSM state to set,
        consumed here), budget ``plan[i]`` and first length ``base[i]`` (0
        when it plans nothing: it rides along idle), every slot's page
        table. Token sources are the caller's (host values by default)."""
        packed = idle_rows(self.config.max_decode_slots, self.config.pages_per_slot)
        packed[:, DEC_COLS:] = self.allocator.page_tables
        for i, r in active:
            p = plan.get(i, 0)
            prm = r.params
            packed[i, LEN] = base[i] if p > 0 else 0
            packed[i, BUD] = p
            packed[i, VAL] = r.pending_token
            packed[i, TOP_K] = prm.top_k
            packed[i, SEED] = r.seed
            packed[i, STOP:STOP + len(prm.stop_token_ids)] = prm.stop_token_ids
            packed[i, FLOATS:FLOATS + 4] = np.array(
                [prm.temperature, prm.top_p, prm.presence_penalty, prm.frequency_penalty],
                np.float32).view(np.int32)
            pack_bias(packed, i, BIAS, prm.logit_bias)
            packed[i, ADP] = r.adapter_slot
            packed[i, FSM] = r.fsm_row
            if r.fsm_row >= 0 and r.pending_fsm_state is not None:
                packed[i, FSM + 1], packed[i, FSM + 2] = 1, r.pending_fsm_state
                r.pending_fsm_state = None
        return packed

    def _plan_window(self, events: list[StepEvent]) -> tuple[dict, dict]:
        """Plan the next window: per row p <= K tokens from slot_len plus
        the tokens in flight, clipped by the request's remaining budget
        (less a first token still being read) and max_model_len, and grow
        the row's pages to cover them. On exhaustion drain the pipeline
        (finishes may hide in unread windows), and only then preempt the
        youngest request. Returns (tokens in flight per slot, plan)."""
        B, K = self.config.max_decode_slots, self.config.decode_steps
        max_len = self.config.max_model_len
        # slot_len + in-flight tokens and the remaining budget are invariant
        # under a harvest (tokens move from in flight to slot_len one for
        # one), so a plan made before a drain stays right after it
        infl = self._inflight_tokens()
        first_pending = {id(r) for r, _k, _row in self._pending_first}
        plan: dict[int, int] = {}
        i = 0
        while i < B:
            r = self.slots[i]
            if r is None:
                i += 1
                continue
            prior = infl.get(i, 0)
            base0 = int(self.slot_len[i]) + prior + 1
            # a first token still being read is emitted before any of this
            # window's tokens: budget for it
            extra = 1 if id(r) in first_pending else 0
            budget = r.params.max_tokens - len(r.output) - prior - extra
            p = max(0, min(K, budget, max_len - base0 + 1))
            plan[i] = p
            if p == 0:
                i += 1
                continue
            try:
                self.allocator.allocate(i, base0 + p - 1)
                i += 1
            except MemoryError:
                if self._inflight or self._pending_first:
                    events += self._harvest(drain=True)
                    infl = self._inflight_tokens()
                    first_pending = {id(r) for r, _k, _row in self._pending_first}
                    continue
                self._preempt_youngest()
                infl = self._inflight_tokens()
        return infl, plan

    def _emit_window(self, active: list[tuple[int, Request]], planned: dict,
                     out: tuple, accept=None,
                     drafted: Optional[dict] = None) -> tuple[list[StepEvent], list, int, int]:
        """Emit a window's tokens (``unpack_results`` of it), up to each
        row's plan (a verify's rows: up to ``min(plan, accept)``, the
        device-checked prefix), in order, until the request finishes. A
        request that finished, was aborted or preempted after the launch
        is skipped: its row's tokens are wasted. Returns (events, the
        window's ledger rows: each row's consumed tokens as "decode", its
        planned-but-unconsumed ones as "early_exit", or as "spec_waste" for
        a row a verify drafted for; the most tokens a row took; the drafts
        accepted)."""
        B = self.config.max_decode_slots
        drafted = drafted or {}
        events: list[StepEvent] = []
        led: list = []
        most = accepted = 0
        for slot, req in active:
            p = planned.get(slot, 0)
            if p <= 0:
                continue
            waste = "spec_waste" if slot in drafted else "early_exit"
            if req.finished or req.slot != slot:
                led.append((req, waste, p))
                continue
            # a verify row's tokens after a rejected draft were sampled
            # from logits conditioned on that draft: discarded like an
            # early exit's
            cap = p if accept is None else min(p, int(accept[slot]))
            consumed = 0
            for j in range(cap):
                self.slot_len[slot] += 1        # the pending token's KV is cached
                tok = int(out[0][j * B + slot])
                req.pending_token = tok
                events += self._emit(req, tok, _lp_entry(out, j * B + slot))
                consumed += 1
                if req.finished:
                    break                       # the device masked the row here too
            led.append((req, "decode", consumed))
            if p > consumed:
                led.append((req, waste, p - consumed))
            most = max(most, consumed)
            if slot in drafted:
                # accepted drafts: the tokens taken less the one the plain
                # window would have given anyway
                accepted += max(0, consumed - 1)
        return events, led, most, accepted

    def _decode(self) -> list[StepEvent]:
        """Sync: one window of up to ``decode_steps`` tokens per slot, read
        at once."""
        events: list[StepEvent] = []
        _infl, plan = self._plan_window(events)
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not any(plan.get(i, 0) for i, _r in active):
            return events
        packed = self._window_rows(active, plan,
                                   {i: int(self.slot_len[i]) + 1 for i, _r in active})
        t_launch = time.monotonic()
        pack, _ = self._window.run(packed, None, None, use_fsm=self._fsm_any_active())
        self.decode_forwards += self.config.decode_steps
        t0 = time.perf_counter()
        out = unpack_results(pack.cpu().numpy())
        self._device_time_s += time.perf_counter() - t0
        emitted, led, most, _accepted = self._emit_window(active, plan, out)
        self._book(t_launch, time.monotonic(), led, window=self.config.decode_steps)
        self.decode_dispatches += 1
        self.steps_obs.append(most)
        self.early_exit_steps += _wasted(led)
        return events + emitted

    # ------------------------------------------------------------------
    # async (pipelined) scheduling
    # ------------------------------------------------------------------

    def _inflight_tokens(self) -> dict:
        """Per-slot tokens planned by in-flight windows for the slot's
        CURRENT request (a window's entry for a previous occupant does not
        count: the harvest skips it)."""
        counts: dict[int, int] = {}
        for s in self._inflight:
            for j, r in s.active:
                if self.slots[j] is r:
                    counts[j] = counts.get(j, 0) + s.planned.get(j, 0)
        return counts

    def _admit_async(self, events: list[StepEvent]):
        """Admission without a host sync: prefill up to ``admit_batch``
        waiting same-bucket requests in one call (a cache hit or a prompt
        past the largest bucket runs alone, through the chunk path); the
        first tokens are read by the harvester. Returns None or the
        admissions for the window's on-device token merge: {"toks": the
        prefill's sampled tokens, "slots": {slot: (resumed, host value,
        prefill row)}}."""
        # clear BEFORE scanning: a submit after this point sets it again
        self._admit_wake.clear()
        if faults.is_active("queue_stall"):
            return None         # LLMK_FAULT=queue_stall (see _admit)
        if any(s.spec for s in self._inflight):
            # a verify is in flight: its consumed-vs-planned tokens are
            # unknown until the harvest, and an admission's window must
            # launch in the same step, so admission waits one step (the
            # JAX rule; the harvest of the verify comes first)
            return None
        picked: list[tuple] = []

        def accept(ptoks: list[int], hit: int) -> bool:
            # the first pick sets the batch: one that runs alone, or the
            # bucket every later pick must share
            return not picked or (not self._runs_alone(ptoks, hit) and self._bucket_for(
                len(ptoks)) == self._bucket_for(len(picked[0][2])))

        long_pick = None
        with self._lock:
            while len(picked) < self.config.admit_batch:
                seat = self._seat_next(events, accept)
                if seat is None:
                    break
                if self._runs_alone(seat[2], seat[3]):
                    long_pick = seat
                    break
                picked.append(seat)
        for seat in picked + ([long_pick] if long_pick is not None else []):
            # host-tier pages upload before the prefill that reads them is
            # dispatched (outside the lock: the stacking must not block
            # submit())
            self._host_kv_commit(seat[0], seat[1])
        merge: dict = {"slots": {}}
        t_launch = time.monotonic()
        if long_pick is not None:
            _slot, req, ptoks, hit, _resumed = long_pick
            pack, merge["toks"] = self._chunked_prefill(req, ptoks, start=hit)
            n_chunks = -(-(len(ptoks) - hit) // max(self.config.prefill_buckets))
            self._busy_until = (max(time.monotonic(), self._busy_until)
                                + 2.0 * n_chunks * self._est_step)
            rows = [long_pick]
        elif picked:
            pack, merge["toks"] = self._prefill(self._bucket_for(len(picked[0][2])),
                                                [(req, ptoks) for _s, req, ptoks, _h, _r in picked])
            # a prefill call counts as two steps
            self._busy_until = (max(time.monotonic(), self._busy_until)
                                + 2.0 * self._est_step)
            rows = picked
        else:
            return None
        key = None
        for row, (slot, req, ptoks, _hit, resumed) in enumerate(rows):
            self.slot_len[slot] = len(ptoks)
            # the dispatched prefill writes these pages; device order makes
            # them valid for any later adopter
            self.allocator.register_prefix(slot, req.prompt, salt=req.cache_salt)
            if resumed:
                # the prefill's sample is discarded; the pending token is
                # host-known
                req.pending_token = req.output[-1]
                merge["slots"][slot] = (True, req.output[-1], row)
                continue
            if key is None:
                # priority read: first tokens jump the window-read queue
                key = -1 - next(self._first_counter)
                self._harvester.push(key, _HostCopy(pack), priority=True)
                if self.ledger is not None:
                    # booked when the read lands; a batch's resumed rows
                    # rode the call too, a resumed chunk-path request's
                    # re-prefill folds into the next window's segment
                    self._ledger_prefills[key] = (t_launch, [
                        (r, max(1, len(pt) - h)) for _s, r, pt, h, _res in rows])
            merge["slots"][slot] = (False, 0, row)
            self._pending_first.append((req, key, row))
        return merge

    def _launch_decode(self, admitted, events: list[StepEvent]) -> str:
        """The step's decode launch: a verify dispatch when speculation is
        on and it can go now (``_launch_decode_spec``), else the window."""
        if self._spec is not None:
            st = self._launch_decode_spec(admitted, events)
            if st is not None:
                return st
        return self._launch_decode_multi(admitted, events)

    def _launch_decode_spec(self, admitted, events: list[StepEvent]) -> Optional[str]:
        """Try to launch a speculative verify dispatch (the JAX
        ``_launch_decode_spec``); None falls through to the plain window.

        Verifies SERIALIZE: a window that consumes fewer tokens than it
        planned would break the slot_len + in-flight-tokens sum every
        pipelined launch's positions rest on, so a verify launches only
        into an empty pipeline (no window in flight, no first token unread,
        no admission this step): every row's last token is then host-known
        and ends the drafter's context. While it is in flight the engine
        reports "paced" and admission waits. The policy demotes drafting on
        traffic that rejects it, which restores the pipelined window."""
        if any(s.spec for s in self._inflight):
            return "paced"          # serialize: wait for the verify
        if admitted is not None:
            return None             # the admission's merge launches now
        if not self._spec.policy.should_draft():
            return None
        if self._inflight or self._pending_first:
            # drafting needs every row's committed tail on the host: pace
            # until the pipeline drains
            return "paced"
        K = self.config.decode_steps
        B = self.config.max_decode_slots
        # with an empty pipeline the window's plan is the JAX spec plan
        # (pages grown; exhaustion preempts the youngest of the lowest class)
        _infl, plan = self._plan_window(events)
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return None
        # draft only rows with window room (p >= 2) and a committed tail
        ctxs: list = [None] * B
        for i, r in active:
            if plan.get(i, 0) >= 2 and r.pending_token >= 0:
                ctxs[i] = np.asarray(r.prompt + r.output, np.int32)
        if not any(c is not None for c in ctxs):
            return None               # no row has draft room: plain window
        proposals = self._spec.propose_batch(ctxs)
        drafted: dict[int, int] = {}
        ext = np.full((B, K - 1), -1, np.int32)
        for i, _r in active:
            d = proposals[i][:max(0, plan.get(i, 0) - 1)]
            if d.size:
                ext[i, :d.size] = d
                drafted[i] = int(d.size)
        if not drafted:
            # an empty draft pass is evidence against this traffic: feed
            # the policy, so such streams demote to the pipelined window
            self._spec.policy.note_empty()
            return None
        packed = self._window_rows(active, plan,
                                   {i: int(self.slot_len[i]) + 1 for i, _r in active})
        t_launch = time.monotonic()
        pack, toks = self._window.run_verify(verify_rows(packed, ext),
                                             use_fsm=self._fsm_any_active())
        seq = next(self._seq_counter)
        step = InflightStep(_HostCopy(pack), toks, active, seq,
                            planned={i: plan.get(i, 0) for i, _r in active},
                            launched_at=t_launch, spec=True, drafted=drafted)
        self._inflight.append(step)
        self._harvester.push(seq, step.pack)
        now = time.monotonic()
        self._busy_until = max(now, self._busy_until) + self._est_step
        return "launched"

    def _launch_decode_multi(self, admitted, events: list[StepEvent]) -> str:
        """Launch one window whose input tokens are merged ON THE DEVICE
        from the newest in-flight window (continuing rows), host values
        (rows with nothing in flight, resumed rows) and this step's prefill
        (just-admitted rows); each row's plan (``_plan_window``) is its
        on-device budget. Returns "launched", "paced" (deferred: the device
        queue is deep enough, or every row's budget is in flight) or
        "idle"."""
        pace = self.config.pace_target_steps
        if pace > 0 and admitted is None and self._inflight:
            # dispatching now would only deepen the queue a new request's
            # prefill waits behind; a step that admitted always launches (its
            # window merges the prefill's tokens)
            if self._busy_until - time.monotonic() > pace * self._est_step:
                return "paced"
        infl, plan = self._plan_window(events)
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return "idle"
        if not any(plan.get(i, 0) for i, _r in active):
            # every row's budget is in flight; harvesting makes progress
            return "paced"
        packed = self._window_rows(
            active, plan, {i: int(self.slot_len[i]) + infl.get(i, 0) + 1 for i, _r in active})
        for i, r in active:
            if admitted is not None and i in admitted["slots"]:
                resumed, host_val, row = admitted["slots"][i]
                if resumed:
                    packed[i, SRC], packed[i, VAL] = SRC_HOST, host_val
                else:
                    packed[i, SRC], packed[i, PRE_ROW] = SRC_PREFILL, row
            elif infl.get(i, 0) > 0:
                packed[i, SRC] = SRC_INFLIGHT
        last = self._inflight[-1].toks if self._inflight else None
        t_launch = time.monotonic()
        pack, toks = self._window.run(packed, last,
                                      admitted["toks"] if admitted is not None else None,
                                      use_fsm=self._fsm_any_active())
        self.decode_forwards += self.config.decode_steps
        seq = next(self._seq_counter)
        step = InflightStep(_HostCopy(pack), toks, active, seq,
                            planned={i: plan.get(i, 0) for i, _r in active},
                            launched_at=t_launch)
        self._inflight.append(step)
        self._harvester.push(seq, step.pack)
        now = time.monotonic()
        self._busy_until = max(now, self._busy_until) + self._est_step
        return "launched"

    def _harvest(self, drain: bool) -> list[StepEvent]:
        """Consume completed results in dispatch order without blocking on
        the device, except to drain (``drain``: memory pressure, an idle
        launch) or for backpressure (``async_depth`` windows unread). A
        submission breaks the backpressure wait, so its admission never
        waits out a read."""
        events: list[StepEvent] = []
        if not self._inflight and not self._pending_first:
            return events
        depth = self.config.async_depth
        budget = self._stall_budget()
        n_windows = 0
        while True:
            n_windows += self._collect_ready(events)
            if drain:
                if not self._inflight and not self._pending_first:
                    break
            elif len(self._inflight) < depth:
                break
            # the oldest window's request may still await its FIRST token:
            # consuming the window first would let the late first token
            # rewind pending_token
            key = self._head_blocking_first()
            if key is not None:
                self._harvester.wait_key(key, timeout_s=budget)
                continue
            if self._inflight:
                k = len(self._inflight) if drain else len(self._inflight) - (depth - 1)
                self._harvester.wait_done(self._inflight[k - 1].seq,
                                          wake=None if drain else self._admit_wake,
                                          timeout_s=budget)
                if not drain and self._admit_wake.is_set():
                    # a submission wants admission now: take what is done
                    # and go back to the loop
                    n_windows += self._collect_ready(events)
                    break
                continue
            self._harvester.wait_key(self._pending_first[0][1], timeout_s=budget)
        # pacing calibration: the spacing of completions per window bounds
        # the device's window time from above (reads add latency, never
        # remove it), so keep the least seen with a slow upward drift (a
        # mean would follow a slow read path up and starve the pipeline)
        if n_windows > 0:
            now = time.monotonic()
            if self._last_harvest_t is not None:
                gap = (now - self._last_harvest_t) / n_windows
                if 0.0 < gap < 0.5:
                    if gap < self._est_step:
                        self._est_step = gap
                    else:
                        self._est_step = min(self._est_step * 1.02, gap)
            self._last_harvest_t = now
        elif not self._inflight:
            self._last_harvest_t = None     # idle: the next spacing is no sample
        return events

    def _head_blocking_first(self) -> Optional[int]:
        """The pending-first key gating the OLDEST in-flight window, or None."""
        if not self._inflight or not self._harvester.is_done(self._inflight[0].seq):
            return None
        waiting = {id(r): k for r, k, _row in self._pending_first}
        for slot, req in self._inflight[0].active:
            if not req.finished and req.slot == slot and id(req) in waiting:
                return waiting[id(req)]
        return None

    def _collect_ready(self, events: list[StepEvent]) -> int:
        """Non-blocking: consume every completed first token, then windows
        in dispatch order while no pending first gates them. Returns the
        windows consumed (pacing calibration)."""
        done_entries, still = [], []
        for entry in self._pending_first:
            (done_entries if self._harvester.key_done(entry[1]) else still).append(entry)
        for req, key, row in done_entries:
            if req.finished:
                continue
            out = unpack_results(self._harvester.get(key))
            tok = int(out[0][row])
            req.pending_token = tok
            events += self._emit(req, tok, _lp_entry(out, row))
        if done_entries:
            self._pending_first = still
            for k in {k for _r, k, _row in done_entries} - {k for _r, k, _row in still}:
                led = self._ledger_prefills.pop(k, None)
                if led is not None:
                    t_launch, rows = led
                    self._book(t_launch, self._harvester.done_time(k),
                               [(r, "prefill", n) for r, n in rows])
                self._harvester.discard_key(k)
        processed = -1
        n_windows = 0
        while self._inflight and self._harvester.is_done(self._inflight[0].seq):
            if self._head_blocking_first() is not None:
                break
            step = self._inflight.popleft()
            processed = step.seq
            n_windows += 1
            host, accept = self._harvester.get(step.seq), None
            if step.spec:
                host, accept = unpack_accept(host, self.config.max_decode_slots)
            emitted, led, most, accepted = self._emit_window(
                step.active, step.planned, unpack_results(host), accept, step.drafted)
            events += emitted
            self._book(step.launched_at, self._harvester.done_time(step.seq), led,
                       window=self.config.decode_steps)
            self.decode_dispatches += 1
            self.steps_obs.append(most)
            self.early_exit_steps += _wasted(led)
            if step.spec:
                drafted_n = sum(step.drafted.values())
                self.spec_dispatches += 1
                self.spec_drafted_tokens += drafted_n
                self.spec_accepted_tokens += accepted
                self._spec.policy.note(drafted_n, accepted)
            elif self._spec is not None:
                self._spec.policy.tick()
        if processed >= 0:
            self._harvester.discard_upto(processed)
        return n_windows

    def _drain_async(self) -> list[StepEvent]:
        """Synchronize: harvest everything in flight and deliver it."""
        events = self._harvest(drain=True)
        self._deliver(events)
        return events

    # ------------------------------------------------------------------
    # the host KV tier
    # ------------------------------------------------------------------

    def _adopt_cached_prefix(self, slot: int, req: Request, ptoks: list[int]) -> int:
        """Adopt the longest cached prefix for an admission attempt (the
        JAX ``_adopt_cached_prefix``): the device prefix cache's pages of
        the prompt, then, with the host tier on, the same digest chain
        walked through the tier from where the device stopped, over the
        whole prefill stream (a resume's replayed output too), leaving at
        least one token to prefill. Returns the tokens covered by both.
        The host part is a peek, staged in ``_host_adopt[slot]``; only
        ``_host_kv_commit`` uploads and counts."""
        hit = self.allocator.adopt_prefix(slot, req.prompt, salt=req.cache_salt)
        if self.host_kv is None:
            return hit
        self._drain_spills()
        page = self.allocator.page_size
        cap_pages = (len(ptoks) - 1) // page
        start = hit // page
        if cap_pages <= start:
            return hit
        digests = self.allocator._digests(ptoks[:cap_pages * page], salt=req.cache_salt)
        matched, payloads = self.host_kv.match_chain(req.tenant, digests, start)
        # pulled payloads crossed a network: a page that does not fit the
        # pools stops the chain (the rest prefills), never lands
        for i, pl in enumerate(payloads):
            if not payload_shape_ok(pl, self.cache_config):
                matched, payloads = matched[:i], payloads[:i]
                break
        self._host_adopt[slot] = (start, matched, payloads)
        return hit + len(matched) * page

    def _host_kv_commit(self, slot: int, req: Request) -> None:
        """An admission with a staged host-tier probe landed: count the hit
        or miss, refresh recency, and upload the matched pages into the
        slot's fresh pages, in place, on the stream before the prefill
        that reads them. No-op without a staged probe."""
        staged = self._host_adopt.pop(slot, None)
        if staged is None or self.host_kv is None:
            return
        first, matched, payloads = staged
        self.host_kv.commit(req.tenant, matched)
        if not payloads:
            return
        t0 = time.perf_counter()
        m = len(payloads)
        pages = self.allocator.slot_pages[slot][first:first + m]
        idx = upload(self._flat_pages(pages), self.device)
        for dst, stage, key in zip(self._pool_sides(), self._upload_staging(m),
                                   ("k", "v", "ks", "vs")):
            # one host copy a page into the staging [m, n_kv, L, ...], one
            # copy to the card, then [n_kv, m * L, ...] there: page-major,
            # layer-minor, as _flat_pages orders the pool indices
            for j, pl in enumerate(payloads):
                _as_int16(stage[j]).copy_(_as_int16(_torch_bytes(as_pool_view(pl)[key])))
            src = stage[:m].to(self.device, non_blocking=True)
            dst.index_copy_(1, idx, src.transpose(0, 1).reshape(dst.shape[0], -1,
                                                               *dst.shape[2:]))
        if self.device.type == "cuda":
            # the staging is written again only once these copies have run
            self._upload_event = torch.cuda.Event()
            self._upload_event.record()
        self.kv_upload_obs.append(time.perf_counter() - t0)
        self.kv_uploaded_tokens += m * self.allocator.page_size

    def _upload_staging(self, m: int) -> tuple:
        """The upload staging, one tensor per pool side, [R, n_kv, L, page,
        (d)]: on a card pinned, made once (R at least
        ``_SPILL_RING_MIN_PAGES`` and a slot's pages, grown only for a
        larger upload) and reused once the last upload's copies ran; on the
        CPU, fresh memory."""
        L = self.cache_config.num_layers
        shapes = [(m, t.shape[0], L, *t.shape[2:]) for t in self._pool_sides()]
        if self.device.type != "cuda":
            return tuple(torch.empty(sh, dtype=t.dtype)
                         for sh, t in zip(shapes, self._pool_sides()))
        if self._upload_event is not None:
            self._wait_event(self._upload_event, "a KV upload's host-to-device copy did not run")
            self._upload_event = None
        if self._upload_stage is None or self._upload_stage[0].shape[0] < m:
            rows = max(_SPILL_RING_MIN_PAGES, self.config.pages_per_slot, m)
            self._upload_stage = tuple(
                torch.empty((rows, *sh[1:]), dtype=t.dtype, pin_memory=True)
                for sh, t in zip(shapes, self._pool_sides()))
        return self._upload_stage

    def _flat_pages(self, pages: list[int]) -> np.ndarray:
        """The flat pool index (l * P + page) of each page's every layer,
        page-major: [m * L] int64."""
        L, P = self.cache_config.num_layers, self.cache_config.num_pages
        return (np.asarray(pages, np.int64)[:, None] + P * np.arange(L)[None, :]).reshape(-1)

    def _pool_sides(self) -> list:
        """The pool tensors a page spans: K and V data, and their scales for
        an int8 pool, in payload order (k, v, ks, vs)."""
        sides = [self.k_pages.data, self.v_pages.data]
        if self.k_pages.scale is not None:
            sides += [self.k_pages.scale, self.v_pages.scale]
        return sides

    def _spill_slot(self, req: Request) -> None:
        """Queue a finishing or preempted slot's full, committed pages for
        the host tier. Runs BEFORE ``allocator.free`` can hand the pages
        on: the gather is enqueued now (stream order: after every write of
        this request, before any of a successor), only the landing in the
        tier waits for ``_drain_spills``. A full page holds positions below
        ``slot_len`` only, so a window still in flight for this row (it
        writes at ``slot_len`` and past) never touches it. Page 0, the
        trash page, is never spilled."""
        if self.host_kv is None or req.slot < 0:
            return
        slot = req.slot
        page = self.allocator.page_size
        tokens = req.prompt + req.output
        n_full = min(len(tokens), int(self.slot_len[slot])) // page
        if n_full <= 0:
            return
        digests = self.allocator._digests(tokens[:n_full * page], salt=req.cache_salt)
        keep = [(d, p) for d, p in zip(digests, self.allocator.slot_pages[slot][:n_full])
                if p != 0]
        if not keep:
            return
        m, L = len(keep), self.cache_config.num_layers
        idx = upload(self._flat_pages([p for _d, p in keep]), self.device)
        # [n_kv, m * L, ...] -> [m, n_kv, L, ...]: each page's payload one
        # contiguous block, so landing it in the tier is one plain copy
        gathered = [t.index_select(1, idx).unflatten(1, (m, L)).transpose(0, 1).contiguous()
                    for t in self._pool_sides()]
        digests = [d for d, _p in keep]
        if self.device.type != "cuda":
            self._pending_spills.append((req.tenant, digests, gathered, None))
        else:
            if self._spill_ring is None or \
                    self._spill_ring_used + m > self._spill_ring[0].shape[0]:
                self._drain_spills()        # the ring's copies landed: reuse it
            ring = self._spill_ring_for(m)
            lo, hi = self._spill_ring_used, self._spill_ring_used + m
            for dst, g in zip(ring, gathered):
                dst[lo:hi].copy_(g, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._spill_ring_used = hi
            self._pending_spills.append((req.tenant, digests, [dst[lo:hi] for dst in ring],
                                         ev))
        if len(self._pending_spills) > _SPILL_DRAIN_AT:
            self._drain_spills()

    def _spill_ring_for(self, m: int) -> tuple:
        """The pinned spill ring, one tensor per pool side (K, V, and the
        scales of an int8 pool), [R, n_kv, L, page, (d)] with R at least
        ``_SPILL_RING_MIN_PAGES`` and a slot's pages; made once, grown only
        for a spill larger than it."""
        if self._spill_ring is not None and self._spill_ring[0].shape[0] >= m:
            return self._spill_ring
        rows = max(_SPILL_RING_MIN_PAGES, self.config.pages_per_slot, m)
        L = self.cache_config.num_layers
        self._spill_ring = tuple(
            torch.empty((rows, t.shape[0], L, *t.shape[2:]), dtype=t.dtype, pin_memory=True)
            for t in self._pool_sides())
        self._spill_ring_used = 0
        return self._spill_ring

    def _drain_spills(self) -> None:
        """Land the queued spills in the host tier (the JAX
        ``_drain_spills``). On a card the engine thread waits for the last
        spill's copy through the harvester's condition with the watchdog
        budget (EngineStallError past it), never in an unbounded wait;
        then each page is copied out of the pinned ring into memory of its
        own (a torch copy: it releases the interpreter lock)."""
        if not self._pending_spills:
            return
        last = self._pending_spills[-1][3]
        if last is not None:
            self._wait_event(last, "a KV spill's device-to-host copy did not land")
        for tenant, digests, sides, _ev in self._pending_spills:
            for j, d in enumerate(digests):
                one = [_host_bytes(_host_copy(t[j])) for t in sides]
                self.host_kv.put(tenant, d, {"k": one[0], "v": one[1],
                                             "ks": one[2] if len(one) == 4 else None,
                                             "vs": one[3] if len(one) == 4 else None})
        self._pending_spills.clear()
        self._spill_ring_used = 0

    def _wait_event(self, ev, what: str) -> None:
        """Wait for a CUDA event with the watchdog budget: through the
        harvester's condition (async scheduling), else by polling."""
        budget = self._stall_budget()
        if self._harvester is not None:
            key = -1 - next(self._first_counter)
            self._harvester.push(key, _EventWait(ev), priority=True)
            self._harvester.wait_key(key, timeout_s=budget)
            self._harvester.discard_key(key)
            return
        deadline = None if budget is None else time.monotonic() + budget
        while not ev.query():
            if deadline is not None and time.monotonic() > deadline:
                raise EngineStallError(f"{what} within the {budget:.1f} s watchdog budget")
            time.sleep(0.0002)

    # ------------------------------------------------------------------
    # grammar-constrained decoding: device-table residency
    # ------------------------------------------------------------------

    def _fsm_any_active(self) -> bool:
        return any(r is not None and r.fsm_row >= 0 for r in self.slots)

    def _g_first_fit(self, size: int) -> Optional[int]:
        occ = sorted((e[1], e[1] + e[2]) for e in self._g_resident.values())
        base = 0
        for lo, hi in occ:
            if lo - base >= size:
                return base
            base = max(base, hi)
        return base if self.config.grammar_states - base >= size else None

    def _ensure_grammar(self, req: Request) -> bool:
        """Make the request's grammar resident in the device tables and
        point req.fsm_row / fsm_start at it (refcounted; the JAX
        ``_ensure_grammar``). False when every table row or state range is
        pinned by running requests: the admission waits, as under page
        pressure. Idempotent per request. The first call allocates the
        tables at capacity and hands them to the window, which captures its
        FSM graph over them on a card."""
        if req.fsm_row >= 0:
            return True
        g = req.params.grammar
        ent = self._g_resident.get(g.key)
        if ent is None:
            cfg = self.config
            V = self.model_config.vocab_size
            if self._g_class_h is None:
                self._g_class_h = np.zeros((cfg.max_grammars, V), np.int16)
                self._g_trans_h = np.full((cfg.grammar_states, cfg.grammar_classes), -1,
                                          np.int16)
                dev = self.device
                self._fsm_state = torch.full((cfg.max_decode_slots,), -1, dtype=torch.int32,
                                             device=dev)
                self._g_dev = (torch.zeros((cfg.max_grammars, V), dtype=torch.int16,
                                           device=dev),
                               torch.full((cfg.grammar_states, cfg.grammar_classes), -1,
                                          dtype=torch.int16, device=dev))
                self._window.enable_fsm((self._fsm_state, *self._g_dev))
            while True:
                used = {e[0] for e in self._g_resident.values()}
                row = next((r for r in range(cfg.max_grammars) if r not in used), None)
                base = self._g_first_fit(g.n_states)
                if row is not None and base is not None:
                    break
                victim = next((k for k, e in self._g_resident.items() if e[3] == 0), None)
                if victim is None:
                    return False      # all pinned by running requests; wait
                del self._g_resident[victim]
            co = np.full((V,), g.n_classes - 2, np.int16)    # pad: the reject class
            co[:len(g.class_of)] = g.class_of
            self._g_class_h[row] = co
            tr = g.trans.astype(np.int32)
            self._g_trans_h[base:base + g.n_states, :] = -1
            self._g_trans_h[base:base + g.n_states, :g.n_classes] = np.where(
                tr >= 0, tr + base, -1).astype(np.int16)
            ent = [row, base, g.n_states, 0, g]
            self._g_resident[g.key] = ent
            self._upload_grammars()
        ent[3] += 1
        req.fsm_row = ent[0]
        req.fsm_start = ent[1] + g.start
        return True

    def _upload_grammars(self) -> None:
        """Copy the host tables into the device ones (never reassigned: the
        FSM graph holds their addresses); stream-ordered after every window
        already launched."""
        for dev, host in zip(self._g_dev, (self._g_class_h, self._g_trans_h)):
            src = torch.from_numpy(host)
            if dev.device.type == "cuda":
                dev.copy_(src.pin_memory(), non_blocking=True)
            else:
                dev.copy_(src)

    def _g_release(self, req: Request) -> None:
        """Drop the request's hold on its resident grammar (finish, abort,
        preemption: a resumed admission re-ensures residency)."""
        if req.fsm_row < 0 or req.params.grammar is None:
            return
        ent = self._g_resident.get(req.params.grammar.key)
        if ent is not None and ent[3] > 0:
            ent[3] -= 1
        req.fsm_row = -1
        req.fsm_start = -1
        req.pending_fsm_state = None

    def _fsm_replay(self, req: Request) -> None:
        """Resume after a preemption or a journal resume: recompute the FSM
        state after every token of the output on the host (the device state
        went with the slot) and stage it for the next window's fsm_set."""
        g = req.params.grammar
        st = g.start
        for t in req.output:
            st = g.next_state(st, t)
            if st < 0:
                log.warning("request %s: emitted token %d not reachable in its own "
                            "grammar; continuing unconstrained", req.id, t)
                self._g_release(req)
                return
        req.pending_fsm_state = (req.fsm_start - g.start) + st   # base + replayed


class _EventWait:
    """A harvester item that only waits for a CUDA event (a spill's copy):
    the harvester thread blocks on it, the engine thread on the harvester's
    condition, with a deadline."""

    def __init__(self, ev):
        self.event = ev

    def read(self) -> np.ndarray:
        self.event.synchronize()
        return np.zeros(0, np.int32)


def _as_int16(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 host tensor viewed as int16 (a host copy of it is then a
    plain memory copy: a bfloat16 one measured ~7x slower a byte on the
    card's host); others unchanged."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of a host tensor (a ring slot) in fresh pageable memory of
    its own, which the tier keeps (the ring is reused)."""
    src = _as_int16(t)
    return torch.empty(src.shape, dtype=src.dtype).copy_(src)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as numpy, sharing its memory (bfloat16, or
    its int16 view, as ``BF16_VIEW``)."""
    t = _as_int16(t)
    if t.dtype == torch.int16:
        return t.numpy().view(np.uint16)
    return t.numpy()


def _torch_bytes(a: np.ndarray) -> torch.Tensor:
    """A payload array as a host tensor of the pool's dtype, sharing its
    memory (``BF16_VIEW`` as bfloat16)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _lp_entry(out: tuple, row: int) -> tuple:
    """(logprob, top_ids, top_logprobs) of one row of ``unpack_results``."""
    return (float(out[2][row]), out[1][row].tolist(), out[3][row].tolist())
