"""The K-step decode window as one function over static tensors, and its
capture as one CUDA graph (counterpart of the JAX engine's jitted
``_decode_multi_packed_step``, ``llms_on_kubernetes_tpu/engine/engine.py``).

``decode_window`` is the window: the on-device token merge, then K x
(count the input token -> ``forward_decode`` -> ``gumbel_noise`` ->
``sample`` with the rows' penalties and logit_bias -> stop and budget
mask), and the packed results of all K steps. Every row's inputs come in
one packed int32 array (``DEC_COLS`` below plus the page table), so a
window is one host-to-device copy.

Grammar-constrained rows (``engine/grammar.py``): with ``fsm`` (the
per-slot state [B] int32 and the resident tables ``class_of [G, V]`` and
``trans [S, C]`` int16) each step masks a constrained row's logits to the
tokens its FSM state allows and advances the state by the sampled token
(``fsm_apply`` / ``fsm_next``, the JAX ``_fsm_apply`` / ``_fsm_next``);
the state is written back in place at the end of the window. Without it
the window is exactly the grammar-free one (the JAX engine's ``fsm=None``
executables).

``DecodeWindow`` runs the windows of one engine. On a card it captures
``decode_window`` once, at construction, as a CUDA graph over static
buffers (the packed inputs, the prefill tokens, the output tokens and
packed results) and the engine's pools, penalty counts, weights and
decode workspace, and each window is one replay: the counterpart of XLA
dispatching the compiled window once. A second graph, the window with the
FSM, is captured at the engine's first grammar admission
(``enable_fsm``), in the first graph's memory pool, over the same static
buffers and the engine's FSM tables; it copies its results into the first
graph's outputs, so a window of either kind reads the newest in-flight
tokens wherever they came from. The engine picks the FSM graph for a
window in which any row is constrained. With int8 weights the graph holds
each layer's QTensor views (data and scale) and their W8A16 launches. On
the CPU the same function runs eagerly; it is the plain version the tests
hold the JAX engine against.
There is no switch between the two: a CUDA engine always replays, and a
capture or replay error raises.

Speculative decoding: ``verify_window`` is the verify dispatch (the JAX
``_decode_spec_packed_step``): one ``forward_verify`` over each row's
committed token and up to K - 1 drafts (K - 1 columns after the page
table, -1 = none), then K sampling iterations over those logits, each
counting its input token before it samples; a row stays alive only while
its sampled token equals the next draft. Its packed results carry each
row's ``accept`` count (the tokens the harvest may consume) in extra rows
(``pack_accept``), so a verify is still one device-to-host copy.
``DecodeWindow`` captures it as a third graph (and with the FSM as a
fourth), lazily at the first speculative dispatch (``run_verify``), in the
first graph's pool over its own static buffers; the two window graphs
are unchanged.

Launch counts: a replay runs no Python, so the kernel wrappers' counts
made while capturing are recorded apart (``kernels.counting_apart``) and
added on every replay; the eager warm-up before the capture counts
nowhere.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.sampling import (
    MAX_CANDIDATES, gumbel_noise, sample,
)
from llms_on_kubernetes_tpu_torch.models.decoder import forward_decode, forward_verify

# stop ids a request may carry into the window's on-device mask
STOP_SLOTS = 8
# OpenAI logit_bias entries a request may carry (the JAX engine's
# LOGIT_BIAS_SLOTS): id columns, then the values' float32 bits; id -1 pads
LOGIT_BIAS_SLOTS = 32

# packed decode columns: lengths0 (the first step's length including its
# input token; 0 => the row rides along idle), the row's budget (tokens
# planned this window), the input token's source (0: the newest in-flight
# window's output, 1: the host value, 2: this step's prefill sample at
# the prefill row), the host value, the prefill row, top_k, seed, the
# stop ids (-1 pads), four float32 columns viewed as int32 (temperature,
# top_p, presence, frequency), the logit_bias ids and values, the FSM
# columns (the row's grammar row in class_of, -1: unconstrained; fsm_set
# 1: start from fsm_val instead of the slot's device state, a resumed
# request's host-replayed state), the row's LoRA adapter slot (-1: the
# base model), the row's mrope delta (Qwen3-VL: its rotary position is
# the token index plus it; 0 otherwise), then the page table
LEN, BUD, SRC, VAL, PRE_ROW, TOP_K, SEED = range(7)
STOP = 7
FLOATS = STOP + STOP_SLOTS
BIAS = FLOATS + 4
FSM = BIAS + 2 * LOGIT_BIAS_SLOTS
ADP = FSM + 3
DELTA = ADP + 1
DEC_COLS = DELTA + 1
SRC_INFLIGHT, SRC_HOST, SRC_PREFILL = 0, 1, 2


def pack_bias(packed: np.ndarray, row: int, base: int, logit_bias) -> None:
    """Row ``row``'s logit_bias pairs into the columns from ``base`` (the
    JAX ``_pack_bias``): ids padded with -1, values as float32 bits."""
    packed[row, base:base + LOGIT_BIAS_SLOTS] = -1
    for j, (tid, value) in enumerate(logit_bias):
        packed[row, base + j] = tid
        packed[row, base + LOGIT_BIAS_SLOTS + j] = np.float32(value).view(np.int32)


def unpack_bias(packed: torch.Tensor, base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids [R, LOGIT_BIAS_SLOTS] int32, values float32) of packed rows."""
    return (packed[:, base:base + LOGIT_BIAS_SLOTS],
            packed[:, base + LOGIT_BIAS_SLOTS:base + 2 * LOGIT_BIAS_SLOTS].view(torch.float32))


def idle_rows(B: int, pages_per_slot: int) -> np.ndarray:
    """A packed window whose rows are all idle (top_p off, no stops, no
    bias)."""
    packed = np.zeros((B, DEC_COLS + pages_per_slot), np.int32)
    packed[:, SRC] = SRC_HOST
    packed[:, STOP:STOP + STOP_SLOTS] = -1
    packed[:, FLOATS + 1] = np.float32(1.0).view(np.int32)
    packed[:, BIAS:BIAS + LOGIT_BIAS_SLOTS] = -1
    packed[:, FSM] = -1
    packed[:, ADP] = -1
    return packed


def fsm_apply(class_of: torch.Tensor, trans: torch.Tensor, g_rows: torch.Tensor,
              states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row mask and transition lookup, one [R, V] lookup for both (the
    JAX ``_fsm_apply``): (allowed [R, V] bool, nxt_all [R, V] int16, the
    state each token leads to, -1 = not allowed; constrained [R] bool).
    Rows with ``g_rows`` < 0 or a state < 0 are unconstrained (all True).
    The lookup indexes ``trans`` flat with an int32 index (state * C +
    class; ``index_select`` takes int32): ``torch.gather`` would need an
    int64 [R, V] index, 8 bytes a row and token (8.2 MB at 8 rows and V
    128,256, 65.7 MB at 64); this one is 4 (4.1 / 32.8 MB), beside the
    int16 classes and result and the bool mask."""
    classes = class_of[g_rows.clamp(min=0).long()]                  # [R, V] int16
    idx = states.clamp(min=0)[:, None] * trans.shape[1] + classes   # int32
    nxt_all = trans.view(-1).index_select(0, idx.view(-1)).view(idx.shape)
    constrained = (g_rows >= 0) & (states >= 0)
    allowed = torch.where(constrained[:, None], nxt_all >= 0, True)
    return allowed, nxt_all, constrained


def fsm_next(nxt_all: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The state after emitting each row's sampled token ([R] int32; the
    JAX ``_fsm_next``)."""
    return nxt_all.gather(1, tokens.long()[:, None])[:, 0].to(torch.int32)


def fsm_scatter(state: torch.Tensor, g_rows: torch.Tensor, init: torch.Tensor,
                nxt_all: torch.Tensor, tokens: torch.Tensor, lengths: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """A prefill's per-slot state write, in place (the JAX
    ``_fsm_scatter``): a row writes its slot's state only when it is a
    constrained fresh start (fsm_row >= 0 and fsm_init >= 0) and real
    (length > 0); every other slot keeps its state. No data-dependent
    shape, so no host sync: a [R, B] match of writing rows to slots."""
    nxt = fsm_next(nxt_all, tokens)
    write = (g_rows >= 0) & (init >= 0) & (lengths > 0)
    hit = write[:, None] & (slots[:, None].long()
                            == torch.arange(state.shape[0], device=state.device)[None, :])
    val = (hit.to(torch.int32) * nxt[:, None]).sum(dim=0).to(state.dtype)
    state.copy_(torch.where(hit.any(dim=0), val, state))
    return state


def pack_results(results: list) -> torch.Tensor:
    """The sampled tokens, top ids, logprobs and top logprobs of one or
    more SampleResults as one int32 array [rows, 2 + 2 * topk] (floats
    viewed as int32; rows concatenated): one device-to-host copy."""
    toks = torch.cat([r.tokens[:, None] for r in results])
    ids = torch.cat([r.top_ids for r in results])
    lps = torch.cat([r.logprobs[:, None] for r in results])
    tlps = torch.cat([r.top_logprobs for r in results])
    return torch.cat([toks, ids, lps.view(torch.int32), tlps.view(torch.int32)], dim=1)


def unpack_results(packed: np.ndarray) -> tuple:
    """(tokens, top_ids, logprobs, top_logprobs) of a ``pack_results``
    array copied to the host."""
    k = (packed.shape[1] - 2) // 2
    return (packed[:, 0], packed[:, 1:1 + k],
            np.ascontiguousarray(packed[:, 1 + k]).view(np.float32),
            np.ascontiguousarray(packed[:, 2 + k:]).view(np.float32))


def _pos_delta(cfg, packed: torch.Tensor) -> Optional[torch.Tensor]:
    """The rows' mrope deltas, read from the packed rows (the captured
    graphs' static input) on an mrope model, else None: a model without
    mrope captures the windows it captured before the column existed."""
    return packed[:, DELTA] if cfg.mrope_section is not None else None


def decode_window(params: dict, cfg, K: int, packed: torch.Tensor,
                  last_toks: torch.Tensor, prefill_toks: torch.Tensor, k_pages, v_pages,
                  counts: torch.Tensor, *, seed: int, kv_write: str = "dus",
                  workspace=None, fsm=None, moe_workspace=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused window of up to K tokens per row.

    ``packed`` [B, DEC_COLS + pages_per_slot] int32 (see the columns
    above); ``last_toks`` [B] the newest in-flight window's output tokens;
    ``prefill_toks`` [R] this step's prefill samples; the pools and
    ``counts`` [B, V] (per-row output-token counts for the penalties) are
    updated in place. Iteration j samples at sequence position lengths0 +
    j, counting its input token before it samples. A row whose sampled
    token is one of its stop ids, or whose budget runs out, is masked
    (length 0) for the rest of the window: its KV write goes to the trash
    page, its counts stop and its input token freezes. Returns (the K
    steps' packed results [K * B, 2 + 2 * topk] int32, row j * B + b for
    step j of row b; the tokens after the window [B] int32)."""
    B = packed.shape[0]
    V = counts.shape[1]
    lengths0, budget = packed[:, LEN], packed[:, BUD]
    src, top_k, seeds = packed[:, SRC], packed[:, TOP_K], packed[:, SEED]
    stop_ids = packed[:, STOP:STOP + STOP_SLOTS]
    fl = packed[:, FLOATS:FLOATS + 4].view(torch.float32)
    # every window applies the bias columns, all padding (-1) for a row
    # without a bias: a captured window must not depend on whether any
    # request had one when it was captured
    bias = unpack_bias(packed, BIAS)
    page_table = packed[:, DEC_COLS:]
    cur = torch.where(src == SRC_INFLIGHT, last_toks,
                      torch.where(src == SRC_HOST, packed[:, VAL],
                                  prefill_toks[packed[:, PRE_ROW].long()]))
    alive = (lengths0 > 0) & (budget > 0)
    if fsm is not None:
        fsm_state, class_of, trans = fsm
        g_rows = packed[:, FSM]
        state = torch.where(packed[:, FSM + 1] == 1, packed[:, FSM + 2], fsm_state)
    row_base = torch.arange(B, device=packed.device) * V
    flat_counts = counts.view(-1)
    C = min(MAX_CANDIDATES, cfg.vocab_size)
    results = []
    for j in range(K):
        lengths = torch.where(alive, lengths0 + j, 0)
        # the input token is an OUTPUT token: count it before sampling (an
        # idle row adds 0; its token may be a placeholder)
        flat_counts.scatter_add_(0, row_base + cur.long().clamp(0, V - 1),
                                 alive.to(counts.dtype))
        logits, _, _ = forward_decode(params, cfg, cur, lengths, k_pages, v_pages, page_table,
                                      kv_write=kv_write, workspace=workspace,
                                      adapter_idx=packed[:, ADP], moe_workspace=moe_workspace,
                                      pos_delta=_pos_delta(cfg, packed))
        noise = gumbel_noise(seed, seeds, lengths, C)
        allowed = None
        if fsm is not None:
            allowed, nxt_all, constrained = fsm_apply(class_of, trans, g_rows, state)
        res = sample(logits, noise, fl[:, 0], top_k, fl[:, 1],
                     penalties=(fl[:, 2], fl[:, 3], counts), bias=bias, allowed=allowed)
        results.append(res)
        if fsm is not None:
            state = torch.where(constrained & alive, fsm_next(nxt_all, res.tokens), state)
        stopped = ((stop_ids >= 0) & (stop_ids == res.tokens[:, None])).any(dim=1)
        cur = torch.where(alive, res.tokens, cur)
        alive = alive & ~stopped & (j + 1 < budget)
    if fsm is not None:
        fsm_state.copy_(state)
    return pack_results(results), cur


def pack_accept(pack: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """A verify's packed results [K * B, W] with each row's accept count
    [B] appended as ceil(B / W) more rows (zero padded): still one
    device-to-host copy."""
    B, W = accept.shape[0], pack.shape[1]
    R = -(-B // W)
    pad = torch.zeros((R * W - B,), dtype=torch.int32, device=accept.device)
    return torch.cat([pack, torch.cat([accept.to(torch.int32), pad]).view(R, W)])


def unpack_accept(packed: np.ndarray, B: int) -> tuple[np.ndarray, np.ndarray]:
    """(the K steps' packed results, accept [B]) of a ``pack_accept``
    array copied to the host."""
    R = -(-B // packed.shape[1])
    return packed[:-R], packed[-R:].reshape(-1)[:B]


def verify_rows(packed: np.ndarray, drafts: np.ndarray) -> np.ndarray:
    """A verify's host rows: the window columns (``DEC_COLS`` and the page
    table) and the K - 1 draft columns after them (-1 = none)."""
    return np.concatenate([packed, drafts.astype(np.int32)], axis=1)


def verify_window(params: dict, cfg, K: int, packed: torch.Tensor, k_pages, v_pages,
                  counts: torch.Tensor, *, seed: int,
                  fsm=None, moe_workspace=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One speculative verify dispatch (the JAX ``_decode_spec_packed_step``).

    ``packed`` [B, DEC_COLS + pages_per_slot + K - 1]: a window's columns
    with every input token a host value (``VAL``; a verify launches only
    into an empty pipeline), then K - 1 draft columns, prefix-contiguous
    (-1 = none). One ``forward_verify`` writes the committed token and the
    row's drafts, ``w = min(budget, 1 + drafts)`` rows (0 for an idle
    row), from position ``lengths0 - 1``, and returns the logits at every
    window position; then K iterations sample from them as the window does
    (the input token counted first, the noise keyed on the position, the
    penalties, bias, FSM mask and stop ids), and a row stays alive after
    iteration j < K - 1 only if its sample equals draft j: iteration j +
    1's logits were conditioned on that draft. ``accept`` counts each
    row's alive iterations. Rows written past the accepted length are
    overwritten by the next dispatch. Returns (the K steps' packed results
    with ``accept`` appended, ``pack_accept``; the tokens after the
    window [B])."""
    D = K - 1
    B = packed.shape[0]
    V = counts.shape[1]
    lengths0, budget = packed[:, LEN], packed[:, BUD]
    top_k, seeds = packed[:, TOP_K], packed[:, SEED]
    stop_ids = packed[:, STOP:STOP + STOP_SLOTS]
    fl = packed[:, FLOATS:FLOATS + 4].view(torch.float32)
    bias = unpack_bias(packed, BIAS)
    W = packed.shape[1]
    page_table = packed[:, DEC_COLS:W - D]
    drafts = packed[:, W - D:]
    toks0 = packed[:, VAL]
    alive0 = (lengths0 > 0) & (budget > 0)
    if fsm is not None:
        fsm_state, class_of, trans = fsm
        g_rows = packed[:, FSM]
        state = torch.where(packed[:, FSM + 1] == 1, packed[:, FSM + 2], fsm_state)
    # the write covers the prefix-contiguous drafts, within the budget
    has = torch.cumprod((drafts >= 0).to(torch.int32), dim=1)
    n_drafts = has.sum(dim=1)
    w = torch.where(alive0, torch.minimum(budget, 1 + n_drafts), 0).to(torch.int32)
    window = torch.cat([toks0[:, None], drafts.clamp(min=0)], dim=1)
    history = (lengths0 - 1).clamp(min=0)
    logits_all, _, _ = forward_verify(params, cfg, window, history, w, k_pages, v_pages,
                                      page_table, adapter_idx=packed[:, ADP],
                                      moe_workspace=moe_workspace,
                                      pos_delta=_pos_delta(cfg, packed))
    row_base = torch.arange(B, device=packed.device) * V
    flat_counts = counts.view(-1)
    C = min(MAX_CANDIDATES, cfg.vocab_size)
    cur, alive = toks0, alive0
    accept = torch.zeros_like(lengths0)
    results = []
    for j in range(K):
        lengths = torch.where(alive, lengths0 + j, 0)
        # the input token is a committed OUTPUT token: count it first
        flat_counts.scatter_add_(0, row_base + cur.long().clamp(0, V - 1),
                                 alive.to(counts.dtype))
        noise = gumbel_noise(seed, seeds, lengths, C)
        allowed = None
        if fsm is not None:
            allowed, nxt_all, constrained = fsm_apply(class_of, trans, g_rows, state)
        res = sample(logits_all[:, j], noise, fl[:, 0], top_k, fl[:, 1],
                     penalties=(fl[:, 2], fl[:, 3], counts), bias=bias, allowed=allowed)
        results.append(res)
        if fsm is not None:
            state = torch.where(constrained & alive, fsm_next(nxt_all, res.tokens), state)
        accept = accept + alive.to(accept.dtype)
        stopped = ((stop_ids >= 0) & (stop_ids == res.tokens[:, None])).any(dim=1)
        nxt = torch.where(alive, res.tokens, cur)
        alive = alive & ~stopped & (j + 1 < budget)
        if j < D:
            alive = alive & (res.tokens == drafts[:, j]) & (has[:, j] > 0)
        cur = nxt
    if fsm is not None:
        fsm_state.copy_(state)
    return pack_accept(pack_results(results), accept), cur


def idle_verify_rows(B: int, pages_per_slot: int, K: int) -> np.ndarray:
    """A packed verify whose rows are all idle (no drafts)."""
    return verify_rows(idle_rows(B, pages_per_slot), np.full((B, K - 1), -1, np.int32))


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``. On a card: a non-blocking copy from pinned
    memory, so the host never waits for the work queued before it (a copy
    from pageable memory synchronizes the stream); the pinned block is not
    reused before the copy has run (PyTorch's caching host allocator
    records the copy)."""
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class DecodeWindow:
    """The decode windows of one engine: captured once as a CUDA graph and
    replayed on a card, run eagerly on the CPU.

    It holds the engine's weights, pools (``k_pages``, ``v_pages``),
    penalty ``counts`` and decode ``workspace``, and after ``enable_fsm``
    its FSM state and tables; none of these may be reassigned after the
    capture, only updated in place. ``replays`` counts the graph replays
    of either kind (0 on the CPU) and ``fsm_replays`` the FSM graph's;
    ``launches`` / ``fsm_launches`` are one replay's kernel launches. The
    verify graphs (``run_verify``) count apart: ``verify_replays`` (of
    either kind), ``fsm_verify_replays``, ``verify_launches`` and
    ``fsm_verify_launches``."""

    def __init__(self, params: dict, model_config, k_pages, v_pages, counts: torch.Tensor,
                 workspace, *, decode_steps: int, slots: int, pages_per_slot: int,
                 admit_rows: int, seed: int, kv_write: str, device: torch.device,
                 moe_workspace=None):
        self.params, self.model_config = params, model_config
        self.k_pages, self.v_pages, self.counts = k_pages, v_pages, counts
        self.workspace = workspace
        self.moe_workspace = moe_workspace
        self.K, self.B, self.pages_per_slot = decode_steps, slots, pages_per_slot
        self.seed, self.kv_write, self.device = seed, kv_write, device
        self.admit_rows = admit_rows
        self.replays = 0
        self.fsm_replays = 0
        self.launches: dict = {}
        self.fsm_launches: dict = {}
        self.fsm = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.fsm_graph: Optional[torch.cuda.CUDAGraph] = None
        self.verify_replays = 0
        self.fsm_verify_replays = 0
        self.verify_launches: dict = {}
        self.fsm_verify_launches: dict = {}
        self.verify_graph: Optional[torch.cuda.CUDAGraph] = None
        self.fsm_verify_graph: Optional[torch.cuda.CUDAGraph] = None
        if device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._capture(admit_rows)

    def _call(self, packed, last_toks, prefill_toks, k_pages=None, v_pages=None,
              counts=None, workspace=None, fsm=None):
        return decode_window(
            self.params, self.model_config, self.K, packed, last_toks, prefill_toks,
            self.k_pages if k_pages is None else k_pages,
            self.v_pages if v_pages is None else v_pages,
            self.counts if counts is None else counts,
            seed=self.seed, kv_write=self.kv_write,
            workspace=self.workspace if workspace is None else workspace, fsm=fsm,
            moe_workspace=self.moe_workspace)

    def _vcall(self, packed, k_pages=None, v_pages=None, counts=None, fsm=None):
        return verify_window(
            self.params, self.model_config, self.K, packed,
            self.k_pages if k_pages is None else k_pages,
            self.v_pages if v_pages is None else v_pages,
            self.counts if counts is None else counts, seed=self.seed, fsm=fsm,
            moe_workspace=self.moe_workspace)

    def _warm_up(self, fsm=None) -> None:
        """K eager steps with every row idle on a side stream (the
        kernels' lazy builds and first-launch attributes, cuBLAS's handles,
        the decode workspace and the rope tables are made there; idle rows
        write only the trash page, add no counts and leave every FSM state
        as it was). Its launches count nowhere."""
        dev = self.device
        idle = upload(idle_rows(self.B, self.pages_per_slot), dev)
        toks = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        pre = torch.zeros((self.admit_rows,), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with kernels.counting_apart(), torch.cuda.stream(side):
            self._call(idle, toks, pre, fsm=fsm)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)

    def _capture(self, admit_rows: int) -> None:
        """Warm up, then capture one window over static buffers. The
        capture's launches are kept to add on every replay."""
        t0 = time.perf_counter()
        dev = self.device
        self.packed = upload(idle_rows(self.B, self.pages_per_slot), dev)
        self.prefill_toks = torch.zeros((admit_rows,), dtype=torch.int32, device=dev)
        self.toks = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        self._warm_up()
        # keep_graph: the captured cudaGraph_t stays readable after the
        # instantiation (``raw_cuda_graph``), so its nodes can be counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # "thread_local": another engine's harvester may be waiting on an
        # event of its own while this thread captures
        with kernels.counting_apart() as counted, \
                torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            self.pack, toks = self._call(self.packed, self.toks, self.prefill_toks)
            self.toks.copy_(toks)
        graph.instantiate()
        self.workspace.frozen = True
        self.launches = dict(counted)
        self.graph = graph
        kernels.note_compile("graph:window", time.perf_counter() - t0)

    def enable_fsm(self, fsm: tuple) -> None:
        """Take the engine's FSM state and tables (allocated once, at
        capacity: only ever written in place) and, on a card, capture the
        FSM window in the first graph's pool. It reads the same static
        inputs and writes the first graph's ``pack`` and ``toks``. The
        capture synchronizes the device once (``torch.cuda.graph`` does)."""
        if self.fsm is not None:
            return
        self.fsm = fsm
        if self.graph is None:
            return
        t0 = time.perf_counter()
        self._warm_up(fsm)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.counting_apart() as counted, \
                torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            pack, toks = self._call(self.packed, self.toks, self.prefill_toks, fsm=fsm)
            self.pack.copy_(pack)
            self.toks.copy_(toks)
        graph.instantiate()
        self.fsm_launches = dict(counted)
        self.fsm_graph = graph
        kernels.note_compile("graph:window_fsm", time.perf_counter() - t0)

    def _capture_verify(self, fsm=None) -> None:
        """Warm the verify up (every row idle, on a side stream, counted
        nowhere: idle rows write nothing, count nothing and keep every FSM
        state), then capture it in the first graph's pool over its own
        static rows; the FSM verify (``fsm`` given) writes the first verify
        graph's outputs, so it is captured second."""
        t0 = time.perf_counter()
        dev = self.device
        if self.verify_graph is None:
            self.vpacked = upload(idle_verify_rows(self.B, self.pages_per_slot, self.K), dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with kernels.counting_apart(), torch.cuda.stream(side):
            self._vcall(upload(idle_verify_rows(self.B, self.pages_per_slot, self.K), dev),
                        fsm=fsm)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.counting_apart() as counted, \
                torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            pack, toks = self._vcall(self.vpacked, fsm=fsm)
            if fsm is None:
                self.vpack, self.vtoks = pack, toks
            else:
                self.vpack.copy_(pack)
                self.vtoks.copy_(toks)
        graph.instantiate()
        if fsm is None:
            self.verify_launches, self.verify_graph = dict(counted), graph
        else:
            self.fsm_verify_launches, self.fsm_verify_graph = dict(counted), graph
        kernels.note_compile("graph:verify" + ("_fsm" if fsm is not None else ""),
                             time.perf_counter() - t0)

    def run_verify(self, packed: np.ndarray,
                   use_fsm: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """One verify dispatch over the host rows ``packed`` (``verify_rows``),
        with the FSM when ``use_fsm``. On a card the verify graph is
        captured at the first call (the FSM one at the first call with
        ``use_fsm``) and each call is one replay; its static outputs are
        overwritten by the next verify, so the caller copies them out
        first. Returns (``pack_accept`` results, tokens after the window),
        on the device."""
        if use_fsm and self.fsm is None:
            raise RuntimeError("a verify with constrained rows needs enable_fsm() first")
        fsm = self.fsm if use_fsm else None
        if self.graph is None:
            return self._vcall(torch.from_numpy(packed), fsm=fsm)
        if self.verify_graph is None:
            self._capture_verify()
        if use_fsm and self.fsm_verify_graph is None:
            self._capture_verify(fsm)
        self.vpacked.copy_(torch.from_numpy(packed).pin_memory(), non_blocking=True)
        if use_fsm:
            self.fsm_verify_graph.replay()
            kernels.add_launches(self.fsm_verify_launches)
            self.fsm_verify_replays += 1
        else:
            self.verify_graph.replay()
            kernels.add_launches(self.verify_launches)
        self.verify_replays += 1
        return self.vpack, self.vtoks

    def _eager_verify(self, packed: torch.Tensor, k_pages, v_pages, counts,
                      fsm=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The verify eagerly, on the given pools and counts (and FSM state
        and tables): what ``chip_smoke.py`` and the card tests hold a
        verify replay against. The engine never calls it."""
        return self._vcall(packed, k_pages, v_pages, counts, fsm)

    def run(self, packed: np.ndarray, last_toks: Optional[torch.Tensor],
            prefill_toks: Optional[torch.Tensor],
            use_fsm: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """One window over the host rows ``packed``, with the FSM when
        ``use_fsm`` (a row is constrained; ``enable_fsm`` first).
        ``last_toks``: the newest in-flight window's tokens (what this
        method returned for it), or None; ``prefill_toks``: this step's
        prefill samples, or None. Returns (packed results, tokens after the
        window), both on the device. On a card they are the graphs' shared
        static outputs, which the next replay of either graph overwrites:
        the caller copies them out (stream-ordered) before it runs the
        next window."""
        if use_fsm and self.fsm is None:
            raise RuntimeError("a window with constrained rows needs enable_fsm() first")
        fsm = self.fsm if use_fsm else None
        if self.graph is None:
            zeros = torch.zeros((self.B,), dtype=torch.int32)
            return self._call(torch.from_numpy(packed),
                              zeros if last_toks is None else last_toks,
                              zeros[:1] if prefill_toks is None else prefill_toks, fsm=fsm)
        if last_toks is not None and last_toks is not self.toks:
            raise ValueError("a replayed window reads the previous window's tokens "
                             "from the graphs' shared static output")
        self.packed.copy_(torch.from_numpy(packed).pin_memory(), non_blocking=True)
        if prefill_toks is not None:
            self.prefill_toks[:prefill_toks.shape[0]].copy_(prefill_toks)
        if use_fsm:
            self.fsm_graph.replay()
            kernels.add_launches(self.fsm_launches)
            self.fsm_replays += 1
        else:
            self.graph.replay()
            kernels.add_launches(self.launches)
        self.replays += 1
        return self.pack, self.toks

    def _eager(self, packed: torch.Tensor, last_toks: torch.Tensor,
               prefill_toks: torch.Tensor, k_pages, v_pages, counts,
               workspace=None, fsm=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The same window eagerly, on the given pools and counts (and FSM
        state and tables): what ``chip_smoke.py`` and the card tests hold a
        replay against (and profile beside it). The engine never calls it."""
        return self._call(packed, last_toks, prefill_toks, k_pages, v_pages, counts,
                          workspace, fsm)
