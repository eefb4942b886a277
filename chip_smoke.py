#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llms_on_kubernetes_tpu_torch``) on one
NVIDIA GPU and check it end to end. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``csrc/`` (one nvcc per source,
   in parallel, beside g++ of ``native/router/router.cpp`` into
   ``llms_on_kubernetes_tpu_torch/_build/llkt-router``) and print the
   build seconds, ptxas's register report and the card's name and power
   limit (per kernel, demangled: registers and spills); count the
   HMMA/HGMMA (tensor-core) instructions in the SASS of the bf16 flash
   prefill body, of the two bf16 W8A16 bodies, w8_matmul_decode and
   w8_matmul_prefill, and the HGMMA of the two bf16 W4A16 bodies,
   w4_matmul_decode and w4_matmul_prefill, and of the MoE expert kernels'
   moe_stream (bf16 and int8 weights) and the int8 decode body moe_spread
   (``cuobjdump -sass``), and fail if
   any has none, or if either expert kernel's ptxas report (read back from
   beside its library where it was built before) is missing, serializes
   its wgmma (C7520) or shows a spill store or load. Three timing variants
   nothing else calls are built after them, while phases 1 and 2 run, and
   loaded where they are first timed: the W8A16 kernel before its K split
   (``scripts/w8_matmul_unsplit.cu``), the W4A16 kernel and the MoE expert
   kernel before their Hopper redesigns (``scripts/w4_matmul_simple.cu``,
   ``scripts/moe_experts_simple.cu``);
2. kernels: hold each kernel against its plain PyTorch version on the card
   -- the small shapes of tests/test_pallas.py and tests/test_kv_int8.py in
   float32 and full-width llama-3-8b shapes in bfloat16 (int8 pools for
   the int8 kernels) -- and time kernel, plain version, and the library
   yardstick where one PyTorch call computes the same function (flash
   prefill: ``scaled_dot_product_attention``; the float window append: two
   ``index_put_`` stores), beside the timer's floor (a kernel that does
   nothing). Flash prefill is timed at buckets 1,024 (length 900), 2,048
   (length 1,500: phase 4's one-shot prompt) and 256 (length 200); the
   decode kernels at lengths 1..2,048 and at the serve shape (8 slots of
   40-47 keys); the window appends at the chunk path's shapes (the
   engine's own chunk calls for phase 3's prompts, and four slots). The
   window appends must leave the plain version's pool bytes outside the
   trash page 0 and every byte outside the written rows as it was, at the
   span edge cases too (bases mid-page and on a boundary, rows past the
   page table, pages of 16, 64 and 128). Then every kernel again at
   head_dim 96 and 256 (``wide_kernels``): float32 at small shapes (group 1
   and 2, a window, a softcap, pages 64 and 24) and bfloat16 at phi-3-mini's
   widths (32 query heads on 32 KV heads, d 96, window 2,047) and
   gemma-2-9b's (16 on 8, d 256, softcap 50), timed there beside the bound
   (decode at lengths 1..2,500, 48 pages a slot; flash at bucket 1,024,
   length 900, beside sdpa); the window appends also at pages 24 and 100,
   span edges and timed. Then the W8A16 kernel (``w8_kernels``): its K
   split against ``ops/quant.w8_splits``; float32 at small shapes (1e-4),
   bfloat16 at llama-3-8b's seven projections, phi-3-mini's and a K of
   16-row units (4,112 x 4,096) at M 1, 8, 64, 256 and 4,096 (the row
   tolerance), rows 0, 5, 37 and 63 alone bit for bit equal to them in
   calls of 8, 64, 65, 256 and 4,096 rows (batch invariance across both
   bodies), refusals of a CPU weight, a strided view and K % 16 != 0;
   timed at every distinct shape and M, in turns with the unsplit kernel
   (new, unsplit, unsplit, new), beside the bound and bf16
   ``torch.matmul`` with a bf16 copy of the weight made outside the timed
   region (the yardstick: what bf16 serving pays), and a forward's 224
   projections of each model at M 8 and 64. Then the W4A16 kernel
   (``w4_kernels``): its K split against ``ops/quant.w4_splits``; float32
   at small shapes (1e-4), packed and int8 storage; bfloat16 at Qwen3-8B's
   seven projections (group 128) at M 1, 8, 64, 65, 256 and 4,096 and at
   narrow shapes (N 16, 48, 144, 1,040; groups of 16 to 128; K of one
   group), rows bit-equal across calls of 1 to 4,096 rows over both bf16
   bodies, int8 storage bit-equal to packed, one kernel node in a captured
   call and no allocation but the output, the refusals; timed at M 1, 8,
   64, 256 and 4,096 in turns (kernel, the earlier simple body, W8A16, bf16
   ``torch.matmul``, kernel) beside the bound and the plain version, and a
   Qwen3-8B forward's 252 projections at M 8 and 64;
3. serve: start ``python -m llms_on_kubernetes_tpu_torch serve --model
   llama-3-8b --random-weights --device cuda`` (the default EngineConfig:
   8 slots, decode_steps 4, kv_write "dus", bf16, prefix caching on, async
   scheduling at depth 2, each decode window one CUDA graph replay) and
   send concurrent completions and a streamed chat with prompts in each
   prefill bucket and one of 1,500 tokens (two chunks), then the 900-token
   prompt again with a tail (a prefix-cache hit of 896 tokens, prefilled
   through the chunk path); the kernel launch counters are zeroed just
   before and read just after; the bf16-KV server runs behind
   ``llkt-router`` (``--probe-interval 0.5``) and every completion goes
   through the router. Held: every window-kernel launch count is
   num_layers x the chunk calls (and >= 96), the re-sent prompt adopts
   >= 896 tokens; over the burst and over the decode-rate streams every
   window ran as a graph replay (``/debug/kernels``: graph_replays >= 1,
   graph_replays x decode_steps == decode_forwards, and every decode-kernel
   launch was one a replay added, none eager). Then, still through the
   router, the request surface (counters zeroed before, read after): stop
   strings, streamed and not (the text ends before the stop, finish_reason
   "stop"); logprobs on chat (top 5) and completions (top 3): shapes,
   chosen logprob <= 0, top lists sorted; logit_bias (+100 on 'Q' gives
   only 'Q'; -100 bans the reference's most common letter); n 4 with a
   seed, the same on a repeat; echo + logprobs on the 900-token prompt
   (wall ms printed; its logprobs held in phase 4 to a plain
   ``forward_score`` on the same weights, within BF16_REL_TOL x the
   largest |logprob|); flash prefill launched num_layers times per
   prefill call plus once a layer for the scoring, every decode window a
   graph replay; ``/metrics`` linted by ``scripts/metrics_lint.py``,
   ``/ready`` with its prefix filter. Then the rest of the replica contract
   (``_drive_contract``, counters zeroed before, read after): a stream with
   ``X-LLMK-Deadline-Ms: 400`` and max_tokens 4,096 through the router ends
   with finish_reason "timeout" (the ms from the deadline to its final
   chunk printed), the pool's free plus evictable pages return to idle,
   every window of it was a graph replay,
   ``llm_deadline_exceeded_total{phase="decode"}`` reads one more, the
   ``X-LLMK-Request-Id`` comes back through the router and
   ``/debug/traces`` holds the request with its queue, prefill and decode
   spans; ``/v1/embeddings`` answers 501 and a body declared at 64 MiB 413.
   Last, the drain: SIGTERM while a
   256-token stream runs through the router: /ready 503 and new requests
   503 at once, the router's ``llm_replica_healthy`` 0 within two probe
   periods, the stream ends whole, the server exits 0. Then the same again
   (directly, no router) with ``--kv-cache-dtype int8`` (the
   int8 decode and window kernels, and never the float ones, on every
   layer). Before it, a reference check on a small input: debug-tiny in
   float32 on the card against the same weights on the CPU (prefill logits
   within 1e-4; greedy streams identical, float and int8 KV, with a
   chunked prompt and a second pass of cache hits), then the same at page
   24 for debug-tiny cut to head_dim 96 and debug-gemma cut to 256 (made
   here with dataclasses.replace, not registered); debug-tiny again with
   int8 weights (the W8A16 kernel's f32 body against the plain version),
   and a debug-tiny fp8 checkpoint from synth_checkpoint served on the card
   and the CPU with the same streams;
   Then three short-lived debug-tiny servers (``phase_contract_servers``):
   one in this process with ``LLMK_FAULT=queue_stall``,
   max_waiting 1 and ``LLMK_SSE_KEEPALIVE_S=0.2`` (a held stream gets
   ``: ping`` before any data and is shed "timeout" at its deadline, a
   request past max_waiting 429 with Retry-After in [1, 60], a held
   completion 504, the queue-phase counter +2), and two behind
   ``llkt-router``, one with ``LLMK_FAULT=kill_mid_stream:8``: streams go
   through the router until the victim resets one, each equal to the
   uninterrupted stream with no error event, the router's resume count 1.
   Then the watchdog: a debug-tiny engine on the card with a 0.5 s
   ``watchdog_stall_s`` behind a ~3 s ``torch.cuda._sleep`` spin on its
   stream: every request finishes "stalled" before the spin ends, the
   engine is wedged and refuses submissions, and the run goes on; then the
   same under ``LLMK_FAULT=engine_stall`` (a harvester read that never
   completes), both shed seconds printed;
4. in process: the same random weights behind the default Engine (async,
   graphed windows). First stream resume (``phase_resume``): greedy and
   seeded streams cut after 1, 5 and 11 tokens and resumed with that prefix
   equal the uninterrupted ones, in float32 (held) and bfloat16 (greedy
   held, seeded counted). Then with bf16 KV, then with int8 KV. kv_write
   "fused": requests through it (counters zeroed before, read after: the
   fused kernel exactly num_layers times a decode step, every launch of
   it by a graph replay, no other decode kernel, graph_replays x
   decode_steps == decode_forwards), the same
   greedy streams as kv_write "dus". Graph against eager, "fused" and
   "dus": one window replayed and one run eagerly from copies of one pool
   and one penalty-count table, on seeded rows with penalties: sampled
   tokens, logprobs and top alternatives identical, pools (outside each
   layer's trash page) and counts byte-equal. Async against sync: the
   same greedy streams from an engine with async_scheduling off. One
   decode step both ways from copies of one pool (bf16 logits within the
   bf16 tolerance, int8 logits identical; pools byte-equal outside the
   trash pages, int8 scales included). Preemption: eight distinct
   900-token prompts of 64 tokens each in 122 pages (admission takes 120,
   growth needs 128): at least one preemption, and every stream equals
   the one a pool with room gives; then four 63-token prompts in 4 pages,
   so that requests are preempted holding only their first token (they
   resume re-prefilling their prompt alone): streams equal again. Last, printed and not held: a
   1,500-token prompt's first-token logits chunked (bucket 1,024) against
   one-shot (bucket 2,048). Then the goodput ledger and guided decoding
   (``phase_ledger_guided``): the same model with the llama3 tokenizer
   files (128,256 ids). First in process, on the fresh engine: the
   grammar-free window graph launches the port's kernels as the parent's
   did (``paged_decode`` K x L), holds the parent's nodes
   (``FREE_WINDOW_NODES``, read with ``cuGraphGetNodes``) and, at most,
   shows the parent's ``FREE_WINDOW_KERNELS`` device events over six idle
   replays under torch.profiler. The token byte map and three grammars
   (json_object, a bounded schema with an enum, an integer and maxLength
   strings, a forced tool call) compiled cold and from the cache, timed.
   The FSM graph (captured at the first constrained admission) held
   against the eager window on copies of one pool, count table and FSM
   state (8 sampled rows with penalties, 4 constrained): tokens, logprobs,
   pools, counts and states byte-equal. Then against the grammar-free
   graph, greedy: a batch of 8 with every other row constrained gives its
   free rows the streams of 8 free rows; 4 free rows joined mid-stream by
   4 constrained ones give the streams of the 4 alone, over windows that
   go grammar-free, FSM, grammar-free, each reading the other graph's
   in-flight tokens; every constrained output walks its grammar on the
   host. Both graphs' nodes and device events printed. Then behind the
   port's server in this process, counters zeroed before and read after:
   8 greedy journaled streams (admission held until all 8 wait, so they
   prefill in the same batches each time) with the ledger on and off in
   turns (on, off, off, on; the ledger is read per step; the profiler is
   held, so an anomaly capture answers busy): the streams' ids equal,
   decode tokens/s printed, and for the "on" turns the ledger's
   conservation error (held under 1% of its window), device-idle share,
   MFU and MBU. One ``/debug/profile`` capture (300 ms) while 8 streams
   decode: its archive's trace holds CUDA kernel events and the streams
   end whole; a second capture after it. Guided traffic: 8 free streams,
   then 8 mixed (two of each kind, two free; the constrained ones greedy,
   steered to finish by logit_bias on the end of turn and the closing
   characters: the bias ranks only what the grammar allows): every
   constrained answer parses and validates; the device time of each
   window by graph (CUDA events around the replay), the FSM graph's
   capture seconds; every window a graph replay, at least one of the FSM
   graph. Last, the graphs' device events again, their nodes unchanged.
   Then the host KV tier, the disaggregated handoff and QoS
   (``phase_tier_handoff_qos``, "4b"). A: the same random weights in
   process, the JAX session_bench shape at full width (12 sessions x 3
   turns, round-robin, ~500-token first turns, 32 greedy tokens a turn,
   each round submitted at once) in 96 usable pages, with the tier on (4
   GiB) and off, bf16 KV then int8 KV: host hits and uploaded tokens > 0,
   every decode window a graph replay, and every stream equal to the
   tier-off engine's or, where the tier-off engine prefilled the history
   another way (one shot, or from its device hit), differing first at a
   near-tie (within 2 x BF16_REL_TOL x |logprob| by the tier-off run's
   own logprobs, ``flip_margin``); printed,
   the returning turns' TTFT p50 on and off and the spill and upload ms a
   page. Phase 4's roomy traffic with the requests alternately batch and
   interactive: admitted interactive first, every greedy stream equal to
   phase 4's without classes. Then its preemption case with the tier on and the requests
   alternately batch and interactive: every victim of the lowest class
   seated, resumes adopting host pages and prefilling fewer tokens than a
   re-prefill, every stream equal to phase 4's roomy pool's or differing
   first at a near-tie (the same rule). B: a
   colocated replica (an in-process server on the same weights) streams
   each of four prompts of 200-900 tokens cold and warm (a prefix hit:
   the remainder through the chunk path); the weights are freed; then an
   ``LLMK_ROLE=prefill`` and an ``LLMK_ROLE=decode`` llama-3-8b server
   (``--kv-host-cache-gb 4``) behind ``llkt-router`` with a roles config
   stream them one at a time: each equal to the warm colocated stream
   (printed: how many equal the cold one), outcome "ok" each, the decode
   replica's flash prefill never launched and its window kernel num_layers
   x one remainder chunk a request, its host hits every offered page,
   every window a graph replay; printed llm_handoff_seconds and each
   pull's wire bytes and ms. C: llama-3-8b cut to 2 layers, in-process
   prefill, decode and "both" servers behind ``llkt-router``:
   ``drop_handoff:2`` gives "reprefill" twice then "ok", a fresh prefill
   replica under ``kill_prefill_replica`` gives "fallback_colocated"
   twice, every stream whole and equal to the "both" replica's cold or
   warm one. D: the "both" server, built through ``serve``'s parser
   under ``LLMK_QOS``: 20 batch streams fill the slots and the queue, 4
   interactive ones sent after are seated before every batch request
   still waiting, and get their first tokens (the engine's stamps) no
   later than those;
   ``llm_tenant_admitted_total`` counts 20 batch and 4 interactive, every
   window a graph replay, /metrics lints;
5. checkpoint: write full-width phi-3-mini (head_dim 96, 3.82 B
   parameters, 7.64 GB in bf16) as a HuggingFace safetensors checkpoint
   under ``smoke_out/`` with ``testing/synth_checkpoint.py`` (failing when
   the disk lacks the room), drop it from the page cache, load it in this
   process and hold layers 0 and 31 (the fused qkv_proj and gate_up_proj
   split), the embedding, the final norm and the head bit for bit to what
   was written; then serve it as a user would, ``python -m
   llms_on_kubernetes_tpu_torch serve --model <dir> --pages-per-slot 48``,
   with prompts in each bucket, a 1,500-token prompt (chunked) and its
   cache hit, a 2,500-token prompt past the 2,047-token sliding window and
   a chat, counters zeroed before and read after: flash prefill, the
   decode kernel and the window kernel each launch num_layers times their
   calls, no other kernel runs, and every decode window was a graph
   replay; then the same with
   ``--kv-cache-dtype int8`` (kernels 1, 4 and 7), the int8-KV server first
   from the weights-only directory and the bf16-KV one after
   ``write_tokenizer`` put the phi3 ``tokenizer.json`` and
   ``tokenizer_config.json`` beside the weights (the request mix is sent
   as token ids, the byte tokenizer's, so the chunk and window checks see
   the same lengths); with the tokenizer, ``/tokenize`` of the probe
   strings and chat equals ``TOKENIZER_PROBES``, a chat's prompt_tokens
   the templated count, and +100 on ``<|end|>`` (32007) stops a chat at
   once with no text; then loaded in process
   with ``quantization="int8"`` (load seconds, weight bytes on the card, a
   16-token greedy stream). Prints the load seconds, cold (in process) and
   warm (in the server), the time to /health with the tokenizer beside the
   weights-only run's, and the phase's seconds. Then llama-3-8b cut to 2
   layers, written with the llama3 tokenizer files and served: the same
   tokenizer checks (+100 on ``<|eot_id|>``, 128009), then one json_object
   chat and one streamed forced tool call through it, parsed and
   validated;
6. headline: the JAX bench's headline configuration (bench.py:2998-3037)
   in process, ``Engine(EngineConfig(model="llama-3-8b",
   quantization="int8", max_decode_slots=64, page_size=32,
   pages_per_slot=16, num_pages=1025, prefill_buckets=(64,),
   async_depth=8, pace_target_steps=3.0))`` with random weights: 56
   concurrent 32-token prompts of 128 greedy tokens and, once they decode,
   8 more arriving 100 ms apart, an engine thread stepping as the server's
   does; counters zeroed before each run and read after. Held: every
   request ends with its 128 tokens, every decode window is one graph
   replay and every decode-kernel launch a replay's, and every quantized
   projection one W8A16 launch (7 x num_layers a forward). Printed: decode
   tokens/s, the late arrivals' TTFT p50 and max, the pacing deferrals. In
   turns on one engine at pace 3, 0, 0, 3, then bf16 weights at pace 3;
   the streams equal between pace 0 and 3 are counted, not held; each run's
   goodput ledger (reset before it): device-idle share, MFU and MBU. One
   int8-weight window replayed and one run eagerly from copies of one pool
   and one count table: tokens, logprobs, pools and counts byte-equal;
7. speculation and GGUF (``phase_spec_gguf``). A: llama-3-8b bf16 random
   weights, the default EngineConfig, in process, an engine without and
   one with ``speculation="ngram"`` on the same weights, each case in
   turns (off, on, on, off; each on run held against the off run of its
   temperature, cold against cold, warm against warm), the launch
   counters zeroed before each run and read after. First one verify
   replayed (the verify graph, captured there) against its eager run from
   copies of one pool and one count table (8 seeded rows with penalties,
   the even ones pinned +90 on their drafts, the odd ones drafted random
   tokens): tokens, accept counts, logprobs, pools and counts byte-equal.
   A1 full accept: 8 prompts of 32 tokens ending in their pin, +90 on it,
   128 tokens: streams equal, accept ratio 1.0, at most 0.286 dispatches
   a committed token, every verify a graph replay. A2: 8 prompts of one
   40-token span repeated to 600 tokens, greedy; A3: 8 random 128-token
   prompts; A4: A2's prompts sampled (temperature 0.9, top_k 8, seeds,
   penalties): streams equal or first apart at a near-tie (``flip_margin``;
   for sampled rows ``sampled_flip``, the Gumbel noise recomputed). A
   guided batch: 4 pinned rows beside 4 under a JSON schema (byte grammar,
   steered by logit_bias): every constrained answer walks its grammar,
   parses and validates, the FSM verify graph replayed, and first held
   against its eager run as above. Each window kernel launch of a verify
   is a replay's, num_layers a verify. A5: A1 with int8 weights, int8 KV
   and kv_write "fused" (kernels 5, 7 and 8 on the path), its verify held
   against eager too. Printed per case: decode tok/s of each run, verify
   dispatches, drafted and accepted tokens, the policy's attempts and the
   attempt it demoted at, device ms a verify and a window (CUDA events).
   B: the draft tier, 8 prompts of 16 tokens and 48 greedy tokens (inside
   the draft's 64-token window): llama-3-8b drafting for itself (registry
   name, the target's seed), then a Llama-3.2-1B-width Q8_0 GGUF draft
   written by ``testing/synth_gguf.py``: streams equal the off run's or
   first apart at a near-tie, every rollout one graph replay (device ms
   printed), the self-draft's accept ratio at least 0.5 (printed: bf16
   prefill and verify round differently, so near-ties can reject). C:
   TinyLlama-1.1B Q8_0 and Phi-3-mini q4 (Q4_K, Q6_K output, phi3's fused
   tensors) at their published widths, cut to ``GGUF_SERVED_LAYERS`` layers
   for the run's time, written by ``testing/synth_gguf.py``
   (three writer processes started with phase 7, overlapping A), each
   served behind nothing: in bf16 in this process by ``serve``'s own GGUF
   branch (``_gguf_engine``: config, weights and embedded tokenizer from
   the file; load and ready seconds and the host's resident-set peak
   printed), its params' layers 0 and L - 1, embedding, norm and head
   held bit for bit to the file's values cast to bf16; then TinyLlama as a
   user runs it, ``serve --model <file>.gguf --quantization int8`` (/health
   seconds printed; Phi-3-mini's int8 serve is cut for the run's time,
   its GGUF tensors are held in process). Each: a chat completion
   through the embedded
   tokenizer and template (prompt_tokens the template's count), every
   window a graph replay, W8A16 7 x num_layers a forward (int8) or never
   (bf16).
9. MoE (``phase_moe``): A, the expert kernel (``csrc/moe_experts.cu``)
   against ``ops/moe.moe_experts_plain`` at qwen3-30b-a3b's widths (128
   experts, D 2,048, F 768, bf16) at 1, 8, 64, 512 and 32,768 expert-major
   rows and at mixtral-8x7b's (8 experts, D 4,096, F 14,336) at 16 and
   8,192, routed by a random router (the bf16 row tolerance), with the
   tile size each R runs on and the K split held to their Python mirrors,
   three rows of each alone equal to them bit for bit (a row alone runs on
   8-row tiles, so at larger R the tile sizes are held to each other);
   timed in turns (kernel, the earlier mma.sync body from
   ``scripts/moe_experts_simple.cu``, the same function through
   ``torch._grouped_mm``, kernel) beside the plain version and the bound
   of the experts touched; the int8 expert kernel
   (``csrc/moe_experts_w8.cu``) against ``moe_experts_plain`` on the same
   QTensor stacks at the same shapes and at Mixtral's R 16 over 6 experts
   (the down launch's imbalance case, spread over clusters of 8 blocks),
   its decode body's cluster size held to ``ops/moe.moe_spread_blocks``,
   rows alone bit-equal to them, timed
   in turns with the bf16 kernel and ``torch._grouped_mm`` on bf16 stacks
   of the shape beside the bound of the int8 bytes touched, and its
   refusals; kernels 1 and 2 at the
   model's group of 8 (32 query on 4 KV heads) against their plain
   versions, timed. B: Qwen3-VL-30B-A3B (its published config.json: the
   qwen3-30b-a3b backbone's widths, rope theta 5e6, interleaved mrope, the
   27-layer tower) at full width, cut to 24 of its 48 layers for the
   run's time, from
   ``init_params`` on the card behind the default Engine (the card's free
   memory before and what the process holds after the load): 8 greedy
   streams of 64, every window a graph replay, the expert kernel 2 x 24
   times a forward (decode launches all by replays), decode tok/s and
   window device ms, then steady windows' device time split between the
   experts, attention and the rest under torch.profiler, the rest by kind
   of kernel and its top kernels. C: ``serve
   --model qwen3-30b-a3b --random-weights`` with ``serve``'s own defaults
   behind ``llkt-router``: a streamed chat through the router, 8 greedy
   streams, the same launch checks, the two decode-window series of
   ``/metrics``, then a 4,000-token prompt's TTFT (bucket 4,096), twice;
   ``/health`` seconds with the warm-up, then with ``--no-warmup``. D:
   qwen3-30b-a3b cut to 2 layers at full width, written as a bf16, an fp8
   and an AWQ Qwen3-MoE checkpoint (3.74, 2.50 and 1.89 GB, routers in
   bf16; the bf16 one with Qwen3's tokenizer files, the ``"qwen3"``
   layout) by ``synth_checkpoint`` while phase 8 and A to C run, each loaded
   in process (layer 0's router held to the file; expert 5 to the file,
   bit for bit in bf16, and for fp8 and AWQ its int8 bytes and scales to
   the file's tensors dequantized and quantized as the JAX loader does)
   and served from its directory: the server's 16 greedy ids equal the
   in-process engine's, its logprobs within the bf16 tolerance, and the
   bf16 one's ``/tokenize`` of the probes equal to ``TOKENIZER_PROBES["qwen3"]``
   (its eos stop too); the bf16
   checkpoint through the bf16 expert kernel, the fp8 and AWQ ones through
   the int8 expert and W8A16 kernels, never the other expert kernel. E: Mixtral-8x7B
   (46.70 B parameters) with int8 weights drawn by ``init_params(quantize=
   True)`` at full width and depth behind the Engine with serve's pool and
   buckets: the card's free memory and what the model and the engine hold,
   8 greedy streams of 64, every window a graph replay, the int8 expert
   kernel 2 x 32 and W8A16 4 x 32 times a forward (decode launches all by
   replays), decode tok/s and window device ms, the steady windows' split
   (experts beside their byte floor, attention, the rest), a 4,000-token
   prompt's TTFT, twice. F: ``serve --model mixtral-8x7b --random-weights
   --quantization int8`` behind ``llkt-router``: C's drive (a chat through
   the router, 8 streams, the launch checks, /metrics, the long prompt's
   TTFT).
10. vision (``phase_vision``): A, kernel 1 with ``mm_groups`` (gemma-3's
   image blocks) at gemma-3-27b's attention (32 query on 16 KV heads, d
   128, bf16): bucket 1,024 with one image of 256 soft tokens and 4,096
   with four, window 1,024 and global, against its plain version (the bf16
   row tolerance), all-text groups bit-equal to none; timed in turns with
   the kernel without groups, the plain version and sdpa with the same
   boolean mask, beside the bound of the (query, key) pairs the mask
   keeps. B:
   gemma-3-27b-it from its published config.json at full width (62
   layers, SigLIP 27 x 1,152 at 896 px) behind an Engine sized for it
   (288 pages of 64, buckets 64/512/1,024): the bytes on the card, the
   host's PNG decode and resize for an 896 px and a 1,600 x 1,200 image
   (every row Paeth, the decoder's slowest path), the tower's device ms an
   image, an image request's TTFT split into host decode, tower and
   prefill (twice, cold, beside a text request of its length), 8 greedy
   streams with 4 images (decode tok/s over the span and once all 8
   decode; every image prefill 62 flash launches), one image request's
   stream equal on a cold resubmission and, within ``flip_margin``,
   through a prefix hit covering the image; then the engine behind the
   port's HTTP server with a gemma-3 tokenizer: a streamed PNG
   ``image_url`` chat whose ``usage`` counts the 256 soft tokens, 400 for
   a JPEG, a ``video_url`` and a remote URL, and 4 text streams' gaps
   between tokens alone and while the 1,600 x 1,200 PNG of an image chat
   is decoded on its request thread. C (run inside phase 9 B, on
   its engine): Qwen3-VL with images of two aspect ratios (two grids):
   the tower ms, the TTFT split, 8 streams with 4 images. D: both models
   cut to 2 layers at full width, written with their tokenizers by
   ``synth_checkpoint`` while phase 9 and A and B run, pre-quantized as the
   reference deploys them (gemma-3 fp8, Qwen3-VL AWQ; towers and routers in
   bf16) and Qwen3-VL in bf16 too, each served by ``serve
   --max-images-per-request 1`` behind ``llkt-router``: the streamed image
   chat and its usage, the three 400s and a fourth for two images; W8A16
   launched for the pre-quantized ones; Qwen3-VL's experts through the
   int8 expert kernel (AWQ) or the bf16 one (bf16), never the other.

``--profile`` stops after phase 2 and traces, under torch.profiler, one
decode window of eight requests as the engine runs it (one CUDA graph
replay) and the same window run eagerly (op by op), each with its wall
time, host enqueue time, device busy time, kernel count and the W8A16
kernel's share of the device time, and one chunk call (the second chunk
of a 1,500-token prompt, padded to its bucket and unpadded), with the pool
of ``LLMK_KV_DTYPE`` (bf16 or int8); then the two windows again with int8
weights;
``--kernels-only`` stops after phase 2; ``--spec-only`` runs phase 1 and
phase 7 and stops, ``--awq-only`` phase 1 and phase 8, ``--moe-only`` phase 1
and phase 9, ``--vision-only`` phase 1, phase 9 B and phase 10 (no result).

The line before the last is the card's name and power limit as nvidia-smi
gives them; before it, one ``{"kernels": [...]}`` JSON line, whose
``launches`` come from phase 5's servers (kernels 1, 2, 4, 6, 7), phase
4's fused engines (3, 5) and phase 6's first int8 run at pace 3 (the
W8A16 kernel), and ``launches_by_path`` from every path (phase 3's request
surface and phase 4b's tier sessions, prefill and decode replicas and
drills among them, phase 7's verify and draft paths and GGUF servers); the
expert kernel's ``launches`` come from phase 9 C's server, the int8
expert kernel's from phase 9 F's; flash
prefill's ``launches_by_path`` hold the multimodal paths of phase 10.
The last line is ``{"ok": true, "device": {...}}``, printed only when
every phase passed.
Without a CUDA device, or outside a checkout, it exits non-zero first.

Tolerances (kernel against plain version on the same inputs), held row by
row (one query head's d values): float32, |err| <= 1e-4 (only the
summation order differs); bfloat16, |err| <= 2e-2 * the row's own max
|plain| (the rounding points differ). The float32 cases include lengths
past one 256-key split, so the decode kernel's split merge is held at
1e-4. Pool bytes after the fused kernels must equal those after
write_tokens exactly (for int8, data and scales: the kernel quantizes as
engine/cache.quantize_kv does).
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

MODEL = "llama-3-8b"
F32_TOL = 1e-4
BF16_REL_TOL = 2e-2
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
REPS = 20
OUT_DIR = "smoke_out"      # logs: nvcc build report, the server's output
# the pool and buckets every phase but 9 was written for (EngineConfig's
# defaults); serve's own defaults are the JAX serve's (2,048 pages, 64 a
# slot, buckets 256/1024/4096), which phase 9 runs
POOL_ARGS = ("--num-pages", "512", "--pages-per-slot", "32", "--prefill-buckets", "64,256,1024")
# phase 3's prompt texts (the byte tokenizer: one token a character)
SERVE_TEXT = ("The quick brown fox jumps over the lazy dog while the engine serves "
              "requests on the card. ") * 12
# a text that shares no page with the others: its 1,500 tokens take the
# chunk path in two chunks (largest bucket 1,024), never a cache hit
LONG_TEXT = ("Paged attention reads the cache through a table of pages, and "
             "chunked prefill fills it one bucket at a time. ") * 20
PROMPT_900 = (SERVE_TEXT * 2)[:900]
PROMPT_1500 = LONG_TEXT[:1500]
TAIL_100 = LONG_TEXT[:100]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Mean device milliseconds of ``fn`` over REPS launches, each timed by
    its own CUDA events after a write of 128 MB that evicts the 50 MB L2
    cache (the main path finds each layer's KV cold). A ~0.5 ms spin kernel
    ahead of the start event keeps the card busy while the host issues
    ``fn``'s launches, so the events time the device work and not the
    Python wrapper's launch latency."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / reps


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prefill_work(lengths, n_q: int, n_kv: int, d: int, elt: int, window=None):
    """FLOPs and bytes flash prefill needs for these lengths: valid query
    rows attend keys <= t (and inside the window); q, k, v of valid tokens
    read once and the output of valid rows written once."""
    pairs = 0
    for n in lengths:
        t = np.arange(n)
        keys = t + 1 if window is None else np.minimum(t + 1, window)
        pairs += int(keys.sum())
    flops = 4.0 * d * n_q * pairs
    tokens = int(sum(lengths))
    nbytes = tokens * d * elt * (2 * n_q + 2 * n_kv) + 4 * len(lengths)
    return flops, nbytes


def decode_work(lengths, n_q: int, n_kv: int, d: int, elt: int, pps: int, write: bool,
                int8: bool = False, window=None):
    """FLOPs and bytes one decode attention call needs: each active query
    row attends its slot's keys (the last ``window`` of them under a
    sliding window); q read, out written, each attended K/V row read once
    (d * elt bytes a row and side, or d + 4 for an int8 row and its
    scale); the fused kernel also reads k_new/v_new (q's dtype) and writes
    one row per side per active slot."""
    B = len(lengths)
    keys = int(sum(min(int(n), window) if window else int(n) for n in lengths))
    active = sum(1 for n in lengths if n > 0)
    row = d + 4 if int8 else d * elt
    flops = 4.0 * d * n_q * keys
    cached = keys - (active if write else 0)
    nbytes = 2 * B * n_q * d * elt + 2 * cached * n_kv * row + 4 * B * (pps + 1)
    if write:
        nbytes += 2 * B * n_kv * d * elt + 2 * active * n_kv * row
    return flops, nbytes


# the decode kernels' two timed shapes: 8 slots of llama-3-8b (32 query / 8
# KV heads, d 128, page 64, 32 pages a slot) at lengths over 1..2,048, and
# the serve shape: 8 slots ~40 tokens in, the decode window that
# --profile traces
DEC_SHAPE = "B8 n_q32 n_kv8 d128 page64 lengths 1,63,64,65,700,1500,2048,0 bf16"
SERVE_SHAPE = "B8 n_q32 n_kv8 d128 page64 lengths 40..47 bf16"
SERVE_LENS = np.arange(40, 48)
INT8 = " q, int8 pool"


def decode_timing(timer, kernel, plain, lens, write: bool, int8: bool = False,
                  widths=(32, 8, 128, 32), window=None) -> dict:
    """Time a decode kernel (50 launches: ~0.01 ms each) and its plain
    version; bound_ms from these lengths at ``widths`` (n_q, n_kv, d,
    pages a slot; llama-3-8b's by default)."""
    ms = timer(kernel, reps=50)
    plain_ms = timer(plain)
    n_q, n_kv, d, pps = widths
    b_ms, b_by = bound_ms(*decode_work(lens, n_q, n_kv, d, 2, pps, write=write, int8=int8,
                                       window=window), "bfloat16")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def sass_mma_count(path, func: str = "flash_prefill_tc",
                   ops: tuple = ("HMMA", "HGMMA")) -> tuple[int, int]:
    """(mma instructions, functions) in the SASS of a built library's
    tensor-core body (kernel names containing ``func``), read with
    cuobjdump from the CUDA toolkit or Triton's bundled copy; ``ops`` the
    instructions counted (a string: that one alone)."""
    if isinstance(ops, str):
        ops = (ops,)
    import shutil
    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                                  "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and os.path.exists(t)), None)
    if tool is None:
        fail("cuobjdump not found: cannot check the flash prefill SASS for tensor-core ops")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=120).stdout
    count, funcs, inside = 0, 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = func in line
            funcs += inside
        elif inside and any(op in line for op in ops):
            count += 1
    return count, funcs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_close(name: str, out, ref, dtype: str, rows=None) -> float:
    """Hold ``out`` to ``ref`` row by row (a row is the last axis: one
    query head's d values, or one slot's logits). float32: |err| <= F32_TOL.
    bfloat16: each row's |err| <= BF16_REL_TOL * that row's max |ref|, so a
    long-context row, whose values are small, is held to its own scale.
    Returns the max abs error."""
    torch = sys.modules["torch"]
    o, r = out.float(), ref.float()
    if rows is not None:
        o, r = o[rows], r[rows]
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite kernel output")
    if not o.numel():
        say(f"  {name}: no rows to compare")
        return 0.0
    n = o.shape[-1]
    row_err = (o - r).abs().reshape(-1, n).amax(dim=1)
    if dtype == "float32":
        row_tol = torch.full_like(row_err, F32_TOL)
    else:
        row_tol = BF16_REL_TOL * r.abs().reshape(-1, n).amax(dim=1).clamp_min(1e-6)
    err, worst = float(row_err.max()), float((row_err / row_tol).max())
    say(f"  {name}: max_abs_err={err:.3e} worst row err/tol={worst:.3f} "
        f"(tightest row tol {float(row_tol.min()):.3e})")
    if not worst <= 1.0:
        fail(f"{name}: a row's error exceeds its tolerance (worst err/tol {worst:.3f})")
    return err


def paged_setup(torch, rng, B, n_kv, d, page, pps, lengths, dtype, pool_pages=None):
    """The tests' _paged_setup: random pools and per-slot page tables over
    distinct random pages (page 0 stays the trash page)."""
    P = pool_pages or B * pps + 1
    k = torch.from_numpy(rng.normal(size=(n_kv, P, page, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_kv, P, page, d)).astype(np.float32))
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = -(-int(lengths[b]) // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    return (k.to("cuda", dtype), v.to("cuda", dtype),
            torch.from_numpy(table).cuda())


def phase_kernels(torch) -> dict:
    from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    timer = Timer(torch)
    # the timer's floor: launch and events around a kernel that does nothing
    tiny = torch.zeros(8, device="cuda")
    say(f"timer floor (one add_ on 8 floats): {timer(lambda: tiny.add_(1), reps=50):.4f} ms "
        f"[{card_line()}]")
    f32, bf16 = torch.float32, torch.bfloat16
    entries = {}

    def qkv(B, T, n_q, n_kv, d, dtype):
        mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
        return mk(B, T, n_q, d), mk(B, T, n_kv, d), mk(B, T, n_kv, d)

    # -- flash prefill ------------------------------------------------------
    say("kernel flash_prefill (replaces ops/pallas_flash.py::flash_prefill_attention)")
    for window, cap in [(None, None), (5, None), (None, 30.0)]:
        q, k, v = qkv(2, 16, 4, 2, 8, f32)
        lengths = torch.tensor([16, 9], dtype=torch.int32, device="cuda")
        kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        check_close(f"f32 B2 T16 window={window} softcap={cap}", out[0], ref[0], "float32")
        check_close(f"f32 B2 T16 window={window} softcap={cap} row1", out[1, :9], ref[1, :9],
                    "float32")
    q, k, v = qkv(2, 256, 2, 1, 16, f32)
    lengths = torch.tensor([256, 130], dtype=torch.int32, device="cuda")
    ref = fa.prefill_attention_plain(q, k, v, lengths, scale=16 ** -0.5)
    out = fa.flash_prefill_attention(q, k, v, lengths, scale=16 ** -0.5)
    check_close("f32 multiblock T256 row0", out[0], ref[0], "float32")
    check_close("f32 multiblock T256 row1", out[1, :130], ref[1, :130], "float32")
    # llama-3-8b widths in float32: up to 900 keys a row, 29 K/V tiles
    q, k, v = qkv(1, 1024, 32, 8, 128, f32)
    lengths = torch.tensor([900], dtype=torch.int32, device="cuda")
    ref = fa.prefill_attention_plain(q, k, v, lengths, scale=128 ** -0.5)
    out = fa.flash_prefill_attention(q, k, v, lengths, scale=128 ** -0.5)
    check_close("f32 llama-3-8b widths B1 T1024 length 900", out[0, :900], ref[0, :900],
                "float32")
    for T, n in [(64, 40), (1024, 1024), (77, 77)]:
        q, k, v = qkv(1, T, 32, 8, 128, bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=128 ** -0.5)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        check_close(f"bf16 llama-3-8b B1 T{T} length {n}", out[0, :n], ref[0, :n], "bfloat16")

    def flash_shape(T, n):
        """Check and time bf16 flash prefill at llama-3-8b widths, bucket T,
        one prompt of n tokens, beside its plain version and sdpa over the
        n valid tokens."""
        q, k, v = qkv(1, T, 32, 8, 128, bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=128 ** -0.5)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
        err = check_close(f"bf16 llama-3-8b B1 T{T} length {n}", out[0, :n], ref[0, :n],
                          "bfloat16")
        ms = timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw))
        plain = timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, **kw))
        del ref, out
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, kh, vh = (t[:, :n].transpose(1, 2) for t in (q, k, v))
        try:
            sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
            lib = timer(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
        except TypeError:   # a torch without enable_gqa: expand the KV heads first
            kx, vx = kh.repeat_interleave(4, dim=1), vh.repeat_interleave(4, dim=1)
            lib = timer(lambda: sdpa(qh, kx, vx, is_causal=True))
        flops, nbytes = prefill_work([n], 32, 8, 128, 2)
        b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
        say(f"  timing flash_prefill T{T} length {n}: ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={b_ms:.4f} library_ms={lib:.4f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib)

    # the timed shape (a 900-token prompt in bucket 1,024), then phase 4's
    # one-shot 1,500-token prompt (bucket 2,048) and a 200-token prompt
    # (bucket 256)
    main = flash_shape(1024, 900)
    others = {f"B1 T{T} length {n}": flash_shape(T, n) for T, n in [(2048, 1500), (256, 200)]}
    entries["flash_prefill"] = dict(
        name="flash_prefill", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/flash_prefill.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_flash.py:89", **main,
        shape="B1 T1024 length 900 n_q32 n_kv8 d128 bf16",
        other_shapes={s: {k: v for k, v in e.items() if k != "max_abs_err"}
                      for s, e in others.items()})

    # -- paged decode, plain and fused ----------------------------------------
    say("kernel paged_decode (replaces ops/pallas_paged.py::pallas_paged_attention)")
    for window, cap in [(None, None), (7, None), (None, 50.0)]:
        lens = np.array([13, 16, 5])
        kp, vp, table = paged_setup(torch, rng, 3, 2, 8, 4, 4, lens, f32)
        q = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32)).cuda()
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw)
        out = pa.paged_decode_attention(q, kp, vp, table, lengths, **kw)
        check_close(f"f32 B3 page4 window={window} softcap={cap}", out, ref, "float32")
    lens = np.array([6, 0])
    kp, vp, table = paged_setup(torch, rng, 2, 1, 8, 4, 2, lens, f32)
    q = torch.from_numpy(rng.normal(size=(2, 2, 8)).astype(np.float32)).cuda()
    out = pa.paged_decode_attention(q, kp, vp, table,
                                    torch.tensor([6, 0], dtype=torch.int32, device="cuda"),
                                    scale=8 ** -0.5)
    if not torch.isfinite(out).all() or out[1].abs().max() != 0:
        fail("paged decode: an idle slot must give finite zeros")
    say("  f32 idle slot: zeros")
    # float32 past one 256-key split (page 64, 32 pages a slot: 8 splits), so
    # the merge of real partials is held at 1e-4
    long_lens = np.array([300, 700, 2048, 0])
    for window, cap in [(None, None), (500, None), (None, 30.0)]:
        kp, vp, table = paged_setup(torch, rng, 4, 8, 128, 64, 32, long_lens, f32)
        q = torch.from_numpy(rng.normal(size=(4, 32, 128)).astype(np.float32)).cuda()
        lengths = torch.from_numpy(long_lens.astype(np.int32)).cuda()
        kw = dict(scale=128 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw)
        out = pa.paged_decode_attention(q, kp, vp, table, lengths, **kw)
        check_close(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window} "
                    f"softcap={cap}", out, ref, "float32",
                    rows=torch.from_numpy(long_lens > 0).cuda())

    def fused_case(label, lens, n_kv, group, d, page, pps, dtype, pool_pages=None,
                   window=None, cap=None):
        lens = np.asarray(lens)
        B = len(lens)
        kp, vp, table = paged_setup(torch, rng, B, n_kv, d, page, pps, lens, dtype,
                                    pool_pages)
        mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
        q, kn, vn = mk(B, n_kv * group, d), mk(B, n_kv, d), mk(B, n_kv, d)
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=cap)
        kr, vr = kp.clone(), vp.clone()
        ref = pa.paged_decode_attention_write_plain(q, kr, vr, table, lengths, kn, vn, **kw)
        out = pa.paged_decode_attention_write(q, kp, vp, table, lengths, kn, vn, **kw)
        act = torch.from_numpy(lens > 0).cuda()
        err = check_close(label, out, ref, "float32" if dtype == f32 else "bfloat16",
                          rows=act)
        # the plain path writes idle rows to the trash page 0; the kernel skips them
        if not (torch.equal(kp[:, 1:], kr[:, 1:]) and torch.equal(vp[:, 1:], vr[:, 1:])):
            fail(f"{label}: pool bytes differ from write_tokens'")
        say(f"  {label}: pool bytes equal")
        # the fused kernel attends exactly like the unfused one after the write
        ref2 = pa.paged_decode_attention(q, kr, vr, table, lengths, **kw)
        if not torch.equal(out[act], ref2[act]):
            fail(f"{label}: fused output differs from write_tokens + paged_decode")
        return kp, vp, table, q, kn, vn, lengths, err

    say("kernel paged_decode_write (replaces ops/pallas_paged.py::pallas_paged_attention_write)")
    fused_case("f32 page boundary", [8, 9, 24, 25], 2, 2, 8, 8, 4, f32)
    fused_case("f32 idle rows", [0, 0, 0], 1, 2, 8, 8, 2, f32)
    fused_case("f32 idle interleaved", [0, 5, 0, 8, 1], 2, 2, 8, 8, 2, f32)
    for window, cap in [(None, None), (9, None), (None, 40.0)]:
        fused_case(f"f32 B5 window={window} softcap={cap}", [13, 16, 1, 0, 32], 2, 2, 8, 8,
                   4, f32, window=window, cap=cap)
    for window in (None, 500):
        fused_case(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window}",
                   [300, 700, 2048, 0], 8, 4, 128, 64, 32, f32, window=window)

    # full-width llama-3-8b decode: 8 slots, page 64, lengths over 1..2048
    dec_lens = np.array([1, 63, 64, 65, 700, 1500, 2048, 0])
    kp, vp, table = paged_setup(torch, rng, 8, 8, 128, 64, 32, dec_lens, bf16, pool_pages=512)
    q = torch.from_numpy(rng.normal(size=(8, 32, 128)).astype(np.float32)).to("cuda", bf16)
    lengths = torch.from_numpy(dec_lens.astype(np.int32)).cuda()
    kw = dict(scale=128 ** -0.5)
    act = torch.from_numpy(dec_lens > 0).cuda()
    ref = pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw)
    out = pa.paged_decode_attention(q, kp, vp, table, lengths, **kw)
    err_dec = check_close("bf16 llama-3-8b B8 page64 lengths 1..2048", out, ref, "bfloat16",
                          rows=act)
    timed = decode_timing(timer, lambda: pa.paged_decode_attention(
        q, kp, vp, table, lengths, **kw), lambda: pa.paged_decode_attention_plain(
        q, kp, vp, table, lengths, **kw), dec_lens, write=False)
    # the serve shape: the decode window chip_smoke.py --profile traces
    kp, vp, table = paged_setup(torch, rng, 8, 8, 128, 64, 32, SERVE_LENS, bf16, pool_pages=512)
    q = torch.from_numpy(rng.normal(size=(8, 32, 128)).astype(np.float32)).to("cuda", bf16)
    lengths = torch.from_numpy(SERVE_LENS.astype(np.int32)).cuda()
    check_close("bf16 llama-3-8b B8 page64 lengths 40..47", pa.paged_decode_attention(
        q, kp, vp, table, lengths, **kw), pa.paged_decode_attention_plain(
        q, kp, vp, table, lengths, **kw), "bfloat16")
    serve = decode_timing(timer, lambda: pa.paged_decode_attention(
        q, kp, vp, table, lengths, **kw), lambda: pa.paged_decode_attention_plain(
        q, kp, vp, table, lengths, **kw), SERVE_LENS, write=False)
    entries["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:1118",
        max_abs_err=err_dec, **timed, library_ms=None, shape=DEC_SHAPE,
        other_shapes={SERVE_SHAPE: serve},
        library_note="no single PyTorch call computes attention through a page table")

    kp, vp, table, q, kn, vn, lengths, err_w = fused_case(
        "bf16 llama-3-8b B8 page64 lengths 1..2048", dec_lens, 8, 4, 128, 64, 32, bf16,
        pool_pages=512)
    timings = {}
    for shape, lens in ((DEC_SHAPE, dec_lens), (SERVE_SHAPE, SERVE_LENS)):
        if shape == SERVE_SHAPE:
            kp, vp, table, q, kn, vn, lengths, _ = fused_case(
                "bf16 llama-3-8b B8 page64 lengths 40..47", lens, 8, 4, 128, 64, 32, bf16,
                pool_pages=512)
        timings[shape] = decode_timing(timer, lambda: pa.paged_decode_attention_write(
            q, kp, vp, table, lengths, kn, vn, **kw), lambda: pa.paged_decode_attention_write_plain(
            q, kp, vp, table, lengths, kn, vn, **kw), lens, write=True)
    entries["paged_decode_write"] = dict(
        name="paged_decode_write", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:476",
        max_abs_err=err_w, **timings[DEC_SHAPE], library_ms=None, shape=DEC_SHAPE,
        other_shapes={SERVE_SHAPE: timings[SERVE_SHAPE]},
        library_note="no single PyTorch call computes attention through a page table")
    entries.update(int8_kernels(torch, rng, timer, dec_lens))
    entries.update(window_kernels(torch, rng, timer))
    for e in entries.values():
        say(f"  timing {e['name']}: ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} "
            f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']}) library_ms={e['library_ms']}")
        for shape, o in e.get("other_shapes", {}).items():
            say(f"    at {shape}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.4f} "
                f"bound_ms={o['bound_ms']:.4f} library_ms={o.get('library_ms')}")
    return entries


def int8_kernels(torch, rng, timer, dec_lens) -> dict:
    """Phase 2 for the int8 pool's kernels: paged_decode_int8 and
    paged_decode_write_int8 against their plain versions, then timed at
    the full-width shape of the float kernels (bf16 q, int8 pool)."""
    from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    f32, bf16 = torch.float32, torch.bfloat16
    entries = {}

    def setup(B, n_kv, d, page, pps, lens, pool_pages=None):
        """int8 pools holding quantize_kv's bytes of random K/V, quantized
        on the card, and the tests' page tables."""
        kp, vp, table = paged_setup(torch, rng, B, n_kv, d, page, pps, lens, f32, pool_pages)
        return [*quantize_kv(kp), *quantize_kv(vp)], table

    def mk(*shape, dtype=f32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)

    say("kernel paged_decode_int8 (replaces ops/pallas_paged.py::pallas_paged_attention_int8)")
    # tests/test_kv_int8.py:77: 2 KV heads, page 4, d 128, lengths 12 and 7
    lens = np.array([12, 7])
    pools, table = setup(2, 2, 128, 4, 8, lens)
    q = mk(2, 4, 128)
    lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
    for window in (None, 6):
        kw = dict(scale=0.3, sliding_window=window)
        ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw)
        out = pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw)
        check_close(f"f32 B2 page4 d128 window={window}", out, ref, "float32")
    long_lens = np.array([300, 700, 2048, 0])
    act = torch.from_numpy(long_lens > 0).cuda()
    for window, cap in [(None, None), (500, None), (None, 30.0)]:
        pools, table = setup(4, 8, 128, 64, 32, long_lens)
        q = mk(4, 32, 128)
        lengths = torch.from_numpy(long_lens.astype(np.int32)).cuda()
        kw = dict(scale=128 ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw)
        out = pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw)
        check_close(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window} "
                    f"softcap={cap}", out, ref, "float32", rows=act)
        if out[3].abs().max() != 0:
            fail("paged_decode_int8: an idle slot must give zeros")

    def fused_case(label, lens, n_kv, group, d, page, pps, dtype, pool_pages=None,
                   window=None, cap=None):
        lens = np.asarray(lens)
        B = len(lens)
        pools, table = setup(B, n_kv, d, page, pps, lens, pool_pages)
        q, kn, vn = mk(B, n_kv * group, d, dtype=dtype), mk(B, n_kv, d, dtype=dtype), \
            mk(B, n_kv, d, dtype=dtype)
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=cap)
        ref_pools = [t.clone() for t in pools]
        ref = pa.paged_decode_attention_write_int8_plain(q, *ref_pools, table, lengths, kn, vn,
                                                         **kw)
        out = pa.paged_decode_attention_write_int8(q, *pools, table, lengths, kn, vn, **kw)
        act = torch.from_numpy(lens > 0).cuda()
        err = check_close(label, out, ref, "float32" if dtype == f32 else "bfloat16", rows=act)
        # the plain path writes idle rows to the trash page 0; the kernel skips them
        if not all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pools, ref_pools)):
            fail(f"{label}: int8 data or scale bytes differ from write_tokens'")
        say(f"  {label}: pool data and scale bytes equal")
        ref2 = pa.paged_decode_attention_int8(q, *ref_pools, table, lengths, **kw)
        if not torch.equal(out[act], ref2[act]):
            fail(f"{label}: fused output differs from write_tokens + paged_decode_int8")
        return pools, table, q, kn, vn, lengths, err

    say("kernel paged_decode_write_int8 (replaces "
        "ops/pallas_paged.py::pallas_paged_attention_write_int8)")
    # tests/test_kv_int8.py:104-165: history 13, 16, 1, 0, 31 at page 8
    for window, cap in [(None, None), (9, None), (None, 40.0)]:
        fused_case(f"f32 B5 d8 page8 window={window} softcap={cap}", [14, 17, 2, 0, 32], 2, 2,
                   8, 8, 4, f32, window=window, cap=cap)
    fused_case("f32 page boundary", [8, 9, 24, 25], 2, 2, 16, 8, 4, f32)
    fused_case("f32 idle rows", [0, 0, 0], 1, 2, 8, 8, 2, f32)
    for window in (None, 500):
        fused_case(f"f32 llama-3-8b widths page64 lengths 300,700,2048,0 window={window}",
                   [300, 700, 2048, 0], 8, 4, 128, 64, 32, f32, window=window)

    # full-width llama-3-8b decode over an int8 pool: the float kernels' shape
    pools, table = setup(8, 8, 128, 64, 32, dec_lens, pool_pages=512)
    q = mk(8, 32, 128, dtype=bf16)
    lengths = torch.from_numpy(dec_lens.astype(np.int32)).cuda()
    kw = dict(scale=128 ** -0.5)
    act = torch.from_numpy(dec_lens > 0).cuda()
    ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw)
    out = pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw)
    err = check_close("bf16 q, int8 pool, llama-3-8b B8 page64 lengths 1..2048", out, ref,
                      "bfloat16", rows=act)
    timings = {}
    for shape, lens in ((DEC_SHAPE, dec_lens), (SERVE_SHAPE, SERVE_LENS)):
        if shape == SERVE_SHAPE:
            pools, table = setup(8, 8, 128, 64, 32, lens, pool_pages=512)
            lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
            check_close("bf16 q, int8 pool, llama-3-8b B8 page64 lengths 40..47",
                        pa.paged_decode_attention_int8(q, *pools, table, lengths, **kw),
                        pa.paged_decode_attention_int8_plain(q, *pools, table, lengths, **kw),
                        "bfloat16")
        timings[shape] = decode_timing(timer, lambda: pa.paged_decode_attention_int8(
            q, *pools, table, lengths, **kw), lambda: pa.paged_decode_attention_int8_plain(
            q, *pools, table, lengths, **kw), lens, write=False, int8=True)
    entries["paged_decode_int8"] = dict(
        name="paged_decode_int8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:264",
        max_abs_err=err, **timings[DEC_SHAPE], library_ms=None, shape=DEC_SHAPE + INT8,
        other_shapes={SERVE_SHAPE + INT8: timings[SERVE_SHAPE]},
        library_note="no single PyTorch call computes attention through a page table")

    timings = {}
    for shape, lens in ((DEC_SHAPE, dec_lens), (SERVE_SHAPE, SERVE_LENS)):
        pools, table, q, kn, vn, lengths, e = fused_case(
            f"bf16 q, int8 pool, llama-3-8b B8 page64 lengths {shape.split('lengths ')[1]}",
            lens, 8, 4, 128, 64, 32, bf16, pool_pages=512)
        err = e if shape == DEC_SHAPE else err
        timings[shape] = decode_timing(timer, lambda: pa.paged_decode_attention_write_int8(
            q, *pools, table, lengths, kn, vn, **kw),
            lambda: pa.paged_decode_attention_write_int8_plain(
                q, *pools, table, lengths, kn, vn, **kw), lens, write=True, int8=True)
    entries["paged_decode_write_int8"] = dict(
        name="paged_decode_write_int8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/paged_decode_int8.cu",
        replaces="llms_on_kubernetes_tpu/ops/pallas_paged.py:874",
        max_abs_err=err, **timings[DEC_SHAPE], library_ms=None, shape=DEC_SHAPE + INT8,
        other_shapes={SERVE_SHAPE + INT8: timings[SERVE_SHAPE]},
        library_note="no single PyTorch call computes attention through a page table")
    return entries


def window_work(widths, n_kv: int, d: int, new_elt: int, int8: bool) -> float:
    """Bytes one windowed append needs: each written row of k_new/v_new
    read once (d * new_elt a KV head and side) and each pool row written
    once (d * new_elt for a float pool, d + 4 for an int8 row and its
    scale). Only rows t < widths[b] count: the rest are neither read nor
    written. No arithmetic to speak of: the bound is bytes."""
    rows = int(sum(widths)) * n_kv * 2
    return rows * (d * new_elt + (d + 4 if int8 else d * new_elt))


def window_case(torch, rng, label, base, widths, W, n_kv, d, page, pps, int8, pool_dtype,
                new_dtype, pool_pages=None):
    """Run the window kernel and its plain version on copies of one random
    pool; fail unless the pool bytes (data and scales) equal the plain
    version's outside the trash page 0 and every byte outside the written
    rows equals the pre-call copy. Returns the arguments for timing:
    (pool tensors, [page_table, base, widths], k_new, v_new)."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    base, widths = np.asarray(base), np.asarray(widths)
    B = len(base)
    P = pool_pages or B * pps + 1
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = min(pps, -(-int(base[b] + W) // page))
        table[b, :used] = perm[b * pps:b * pps + used]
    written = np.zeros((P, page), bool)
    for b in range(B):
        for t in range(int(widths[b])):
            pos = int(base[b]) + t
            if 0 <= pos < pps * page:
                written[table[b, pos // page], pos % page] = True
    if int8:
        mk_d = lambda: torch.from_numpy(
            rng.integers(-127, 128, size=(n_kv, P, page, d)).astype(np.int8)).cuda()
        mk_s = lambda: torch.from_numpy(
            (rng.random(size=(n_kv, P, page)) + 0.1).astype(np.float32)).cuda()
        pool = [mk_d(), mk_s(), mk_d(), mk_s()]
    else:
        mk_p = lambda: torch.from_numpy(
            rng.normal(size=(n_kv, P, page, d)).astype(np.float32)).to("cuda", pool_dtype)
        pool = [mk_p(), mk_p()]
    mk = lambda: torch.from_numpy(
        rng.normal(size=(B, W, n_kv, d)).astype(np.float32)).to("cuda", new_dtype)
    kn, vn = mk(), mk()
    args = [torch.from_numpy(a.astype(np.int32)).cuda() for a in (table, base, widths)]
    before = [t.clone() for t in pool]
    ref = [t.clone() for t in pool]
    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    plain(*ref, *args, kn, vn)
    kernel(*pool, *args, kn, vn)
    torch.cuda.synchronize()
    if not all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pool, ref)):
        fail(f"{label}: pool bytes differ from the plain version's outside page 0")
    keep = torch.from_numpy(~written).cuda()
    if not all(torch.equal(a[:, keep], b[:, keep]) for a, b in zip(pool, before)):
        fail(f"{label}: the kernel changed pool bytes outside the written rows")
    say(f"  {label}: pool bytes equal the plain version's outside page 0; "
        f"{int(written.sum())} rows a KV head written, every other byte untouched")
    return pool, args, kn, vn


def engine_chunk_shapes() -> list[tuple[int, int, int]]:
    """(base, width, bucket W) of every forward_chunk call the default
    EngineConfig (page 64, buckets 64/256/1,024, prefix caching on) makes
    for phase 3's chunked requests, in order: the 1,500-token prompt (two
    chunks), then the 900-token prompt and its re-send with the
    100-character tail (a cache hit; the tail is one chunk). Read from the
    engine itself -- its tokenizer, admission, prefix cache and bucket
    choice -- run on the CPU with debug-tiny weights: the scheduling
    depends on the config and the prompts, not on the model's widths."""
    from llms_on_kubernetes_tpu_torch.engine import engine as em
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import load_tokenizer

    calls = []
    real = em.forward_chunk

    def spy(params, cfg, tokens, history, lengths, *rest, **kw):
        calls.append((int(history[0]), int(lengths[0]), int(tokens.shape[1])))
        return real(params, cfg, tokens, history, lengths, *rest, **kw)

    tok = load_tokenizer(MODEL)
    eng = em.Engine(em.EngineConfig(model="debug-tiny", dtype="float32", device="cpu"))
    em.forward_chunk = spy
    try:
        for text in (PROMPT_1500, PROMPT_900, PROMPT_900 + TAIL_100):
            eng.generate(tok.encode(text), em.SamplingParams(max_tokens=1, temperature=0.0))
    finally:
        em.forward_chunk = real
    return calls


def window_shapes() -> dict:
    """The windowed append's timed shapes, llama-3-8b widths, the main one
    first: the second chunk of phase 3's 1,500-token prompt; four slots
    starting at 0, a page boundary (896), mid-page (900) and one idle; the
    first chunk of that prompt; the re-sent prompt's tail after its cache
    hit. The single-slot shapes are the engine's own chunk calls."""
    calls = engine_chunk_shapes()
    if len(calls) != 3:
        fail(f"expected the engine to make 3 chunk calls for phase 3's prompts, got {calls}")
    (b0, w0, W0), (b1, w1, W1), (b2, w2, W2) = calls
    one = lambda b, w, W: (f"B1 W{W} base {b} width {w}", dict(base=[b], widths=[w], W=W))
    return dict([one(b1, w1, W1),
                 ("B4 W1024 bases 0,896,900,0 widths 1024,1024,1000,0",
                  dict(base=[0, 896, 900, 0], widths=[1024, 1024, 1000, 0], W=1024)),
                 one(b0, w0, W0), one(b2, w2, W2)])


# the timed window shapes' fixed widths: llama-3-8b (8 KV heads, d 128),
# the default page and a 512-page pool, bf16 rows
WINDOW_FIXED = dict(n_kv=8, d=128, page=64, pps=32, pool_pages=512)


def window_timing(torch, timer, int8: bool, pool, args, kn, vn, W: int, widths,
                  n_kv: int = WINDOW_FIXED["n_kv"], d: int = WINDOW_FIXED["d"],
                  page: int = WINDOW_FIXED["page"]) -> dict:
    """Time the window kernel (100 launches: a few microseconds each), its
    plain version and (float pool) the library yardstick, two index_put_
    stores of the same rows; bound_ms from the written rows."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    ms = timer(lambda: kernel(*pool, *args, kn, vn), reps=100)
    plain_ms = timer(lambda: plain(*pool, *args, kn, vn), reps=100)
    lib = None
    if not int8:
        pid, off = pw._window_index(args[0], args[1], args[2], W, page)
        sel = (args[2].long()[:, None] > torch.arange(W, device="cuda")).reshape(-1)
        pid, off = pid[sel], off[sel]
        kr = kn.reshape(-1, n_kv, d)[sel].transpose(0, 1).contiguous()
        vr = vn.reshape(-1, n_kv, d)[sel].transpose(0, 1).contiguous()
        hix = torch.arange(n_kv, device="cuda")[:, None]
        lib = timer(lambda: (pool[0].index_put_((hix, pid, off), kr),
                             pool[1].index_put_((hix, pid, off), vr)), reps=100)
    b_ms, b_by = bound_ms(0.0, window_work(widths, n_kv, d, 2, int8), "bfloat16")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def window_kernels(torch, rng, timer) -> dict:
    """Phase 2 for the windowed KV append (the chunk path's write):
    paged_write_window (float pools) and paged_write_window_int8 against
    their plain versions (``window_case``) at the tests' small shapes, the
    span edge cases and the full-width shapes, then timed at the latter."""
    f32, bf16 = torch.float32, torch.bfloat16
    entries = {}
    case = lambda label, **kw: window_case(torch, rng, label, **kw)

    say("kernel paged_write_window (replaces ops/pallas_paged.py::pallas_paged_write_window)")
    say("kernel paged_write_window_int8 (replaces "
        "ops/pallas_paged.py::pallas_paged_write_window_int8)")
    # tests/test_pallas.py:261 and tests/test_kv_int8.py:168, float32 rows
    small = dict(base=[7, 8, 0, 15, 3], widths=[4, 3, 4, 2, 0], W=4, n_kv=2, d=8, page=8,
                 pps=4)
    case("f32 pool, test_pallas shape", int8=False, pool_dtype=f32, new_dtype=f32, **small)
    case("bf16 pool, test_pallas shape", int8=False, pool_dtype=bf16, new_dtype=bf16, **small)
    case("int8 pool, f32 rows, test_kv_int8 shape", int8=True, pool_dtype=None,
         new_dtype=f32, **small)
    case("int8 pool, bf16 rows, d 128 page 16", base=[0, 16, 5, 40], widths=[20, 16, 1, 0],
         W=20, n_kv=2, d=128, page=16, pps=4, int8=True, pool_dtype=None, new_dtype=bf16)
    # spans: a base mid-page and on a boundary, W below a page, rows past
    # the page table, and a page of 128 (two spans a page)
    for page, W in ((16, 40), (64, 50), (128, 200)):
        edge = dict(base=[page // 2 + 1, page, 0, 3 * page - 5], widths=[W, W - 1, 0, W],
                    W=W, n_kv=2, d=64, page=page, pps=3)
        for int8, pool_dtype, new_dtype in ((False, f32, f32), (False, bf16, bf16),
                                            (True, None, f32), (True, None, bf16)):
            case(f"{'int8' if int8 else pool_dtype} pool, {new_dtype} rows, span edges "
                 f"page {page} W {W}", int8=int8, pool_dtype=pool_dtype, new_dtype=new_dtype,
                 **edge)
    shapes = window_shapes()
    for int8, name in ((False, "paged_write_window"), (True, "paged_write_window_int8")):
        times = {}
        for shape, kw in shapes.items():
            pool, args, kn, vn = case(f"{'int8' if int8 else 'bf16'} pool, bf16 rows, {shape}",
                                      int8=int8, pool_dtype=bf16, new_dtype=bf16, **kw,
                                      **WINDOW_FIXED)
            t = window_timing(torch, timer, int8, pool, args, kn, vn, kw["W"], kw["widths"])
            times[shape] = t
            say(f"  timing {name} {shape}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.5f} library_ms={t['library_ms']}")
        main_shape = next(iter(shapes))
        entries[name] = dict(
            name=name, route="cuda",
            source="llms_on_kubernetes_tpu_torch/csrc/paged_write_window.cu",
            replaces=("llms_on_kubernetes_tpu/ops/pallas_paged.py:1045" if int8
                      else "llms_on_kubernetes_tpu/ops/pallas_paged.py:612"),
            max_abs_err=0.0, **times[main_shape],
            shape=f"{main_shape} n_kv8 d128 page64 bf16 rows, "
                  f"{'int8' if int8 else 'bf16'} pool",
            other_shapes={s: t for s, t in times.items() if s != main_shape})
        if int8:
            entries[name]["library_note"] = ("no single PyTorch call quantizes and stores: "
                                             "quantize_kv alone is several calls")
    return entries


# ---------------------------------------------------------------------------
# phase 2, head_dim 96 and 256: every kernel at phi-3-mini's and gemma-2-9b's
# widths
# ---------------------------------------------------------------------------

# phi-3-mini: 32 query heads on 32 KV heads (group 1), d 96, window 2047;
# gemma-2-9b: 16 on 8, d 256, attention softcap 50 (its window, 4096, lies
# past every length here). Pages a slot: 48 (3,072 tokens: phase 5's
# --pages-per-slot), lengths past phi-3's window.
WIDE = {96: dict(model="phi-3-mini", n_q=32, n_kv=32, window=2047, cap=None),
        256: dict(model="gemma-2-9b", n_q=16, n_kv=8, window=4096, cap=50.0)}
WIDE_LENS = np.array([1, 63, 64, 65, 700, 1500, 2500, 0])
WIDE_PPS = 48


def wide_kernels(torch, rng, timer) -> dict:
    """Phase 2 at head_dim 96 and 256: each of the seven kernels against
    its plain version, float32 at small shapes (1e-4, group 1 and 2, a
    window, a softcap) and bfloat16 at the two models' full widths (the row
    tolerance), then timed at the full widths beside its bound (and
    scaled_dot_product_attention for kernel 1); the window kernels also at
    pages 24 and 100, which their spans cut by in-page offset. Returns
    {kernel name: {shape: timing}} for the kernel table's other shapes."""
    from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
    from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    f32, bf16 = torch.float32, torch.bfloat16
    out: dict = {}

    def mk(*shape, dtype=f32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)

    for d, w in WIDE.items():
        n_q, n_kv, window, cap = w["n_q"], w["n_kv"], w["window"], w["cap"]
        group = n_q // n_kv
        tag = f"{w['model']} n_q{n_q} n_kv{n_kv} d{d}"
        say(f"head_dim {d} ({tag}): every kernel against its plain version")
        # -- kernel 1 ----------------------------------------------------------
        for win, c in [(None, None), (37, None), (None, cap or 30.0)]:
            q, k, v = mk(2, 200, 2 * group, d), mk(2, 200, 2, d), mk(2, 200, 2, d)
            lengths = torch.tensor([200, 77], dtype=torch.int32, device="cuda")
            kw = dict(scale=d ** -0.5, sliding_window=win, attn_softcap=c)
            ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
            got = fa.flash_prefill_attention(q, k, v, lengths, **kw)
            check_close(f"flash f32 d{d} group {group} T200 window={win} softcap={c}",
                        got[0], ref[0], "float32")
            check_close(f"flash f32 d{d} group {group} T200 row1", got[1, :77], ref[1, :77],
                        "float32")
        T, n = 1024, 900
        q, k, v = mk(1, T, n_q, d, dtype=bf16), mk(1, T, n_kv, d, dtype=bf16), \
            mk(1, T, n_kv, d, dtype=bf16)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=cap)
        ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
        err = check_close(f"flash bf16 {tag} B1 T{T} length {n}", fa.flash_prefill_attention(
            q, k, v, lengths, **kw)[0, :n], ref[0, :n], "bfloat16")
        del ref
        ms = timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw))
        plain = timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, **kw))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, kh, vh = (t[:, :n].transpose(1, 2) for t in (q, k, v))
        kx, vx = (kh, vh) if group == 1 else (kh.repeat_interleave(group, 1),
                                               vh.repeat_interleave(group, 1))
        lib = timer(lambda: sdpa(qh, kx, vx, is_causal=True, scale=d ** -0.5))
        b_ms, b_by = bound_ms(*prefill_work([n], n_q, n_kv, d, 2, window), "bfloat16")
        out.setdefault("flash_prefill", {})[f"{tag} B1 T{T} length {n} bf16"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib, library_note="sdpa causal over the valid tokens"
            + (" without the softcap (sdpa has none)" if cap else ""))
        # -- kernels 2-5 ---------------------------------------------------------
        for lens, nkv, page, pps, dtype, win, c, label in (
                ([300, 37, 0, 700], 2, 64, 12, f32, 300, None, "f32 window 300"),
                ([300, 37, 0, 700], 2, 24, 30, f32, None, cap or 30.0, "f32 page 24"),
                (WIDE_LENS, n_kv, 64, WIDE_PPS, bf16, window, cap, f"bf16 {tag} B8")):
            lens = np.asarray(lens)
            B = len(lens)
            kp, vp, table = paged_setup(torch, rng, B, nkv, d, page, pps, lens, f32,
                                        pool_pages=B * pps + 1)
            q = mk(B, nkv * group, d, dtype=dtype)
            kn, vn = mk(B, nkv, d, dtype=dtype), mk(B, nkv, d, dtype=dtype)
            lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
            kw = dict(scale=d ** -0.5, sliding_window=win, attn_softcap=c)
            act = torch.from_numpy(lens > 0).cuda()
            for int8 in (False, True):
                base_pools = [*quantize_kv(kp), *quantize_kv(vp)] if int8 else \
                    [kp.to(dtype), vp.to(dtype)]
                for fused in (False, True):
                    name = "paged_decode" + ("_write" if fused else "") + ("_int8" if int8 else "")
                    pools = [t.clone() for t in base_pools]
                    if fused:
                        kern = (pa.paged_decode_attention_write_int8 if int8
                                else pa.paged_decode_attention_write)
                        plain_fn = (pa.paged_decode_attention_write_int8_plain if int8
                                    else pa.paged_decode_attention_write_plain)
                        ref_pools = [t.clone() for t in pools]
                        ref = plain_fn(q, *ref_pools, table, lengths, kn, vn, **kw)
                        got = kern(q, *pools, table, lengths, kn, vn, **kw)
                        if not all(torch.equal(a[:, 1:], b[:, 1:])
                                   for a, b in zip(pools, ref_pools)):
                            fail(f"{name} {label}: pool bytes differ from write_tokens'")
                        del ref_pools
                        run = lambda: kern(q, *pools, table, lengths, kn, vn, **kw)
                        run_plain = lambda: plain_fn(q, *pools, table, lengths, kn, vn, **kw)
                    else:
                        kern = pa.paged_decode_attention_int8 if int8 else pa.paged_decode_attention
                        plain_fn = (pa.paged_decode_attention_int8_plain if int8
                                    else pa.paged_decode_attention_plain)
                        ref = plain_fn(q, *pools, table, lengths, **kw)
                        got = kern(q, *pools, table, lengths, **kw)
                        run = lambda: kern(q, *pools, table, lengths, **kw)
                        run_plain = lambda: plain_fn(q, *pools, table, lengths, **kw)
                    err = check_close(f"{name} {label}" + (" int8 pool" if int8 else ""),
                                      got, ref, "float32" if dtype == f32 else "bfloat16",
                                      rows=act)
                    if dtype == bf16:
                        t = decode_timing(timer, run, run_plain, lens, write=fused, int8=int8,
                                          widths=(n_q, n_kv, d, pps), window=win)
                        out.setdefault(name, {})[
                            f"{label} page64 lengths 1..2500" + (INT8 if int8 else "")] = dict(
                            max_abs_err=err, **t, library_ms=None)
                    del pools, ref, got
                del base_pools
            del kp, vp
        # -- kernels 6-7 -------------------------------------------------------
        for int8, name in ((False, "paged_write_window"), (True, "paged_write_window_int8")):
            for page in (24, 100):
                for W in (page - 3, 2 * page + 5):
                    edge = dict(base=[page // 2 + 1, page, 0, 3 * page - 5],
                                widths=[W, W - 1, 0, W], W=W, n_kv=2, d=d, page=page, pps=4)
                    for pool_dtype, new_dtype in ((None, f32), (None, bf16)) if int8 else \
                            ((f32, f32), (bf16, bf16)):
                        window_case(torch, rng, f"{name} d{d} page {page} W {W} "
                                    f"{new_dtype} rows", int8=int8, pool_dtype=pool_dtype,
                                    new_dtype=new_dtype, **edge)
            for page, pps in ((64, WIDE_PPS), (24, 128), (100, 31)):
                shape = dict(base=[1024], widths=[476], W=1024)
                pool, args, kn, vn = window_case(
                    torch, rng, f"{name} {tag} page {page} B1 W1024 base 1024 width 476",
                    int8=int8, pool_dtype=bf16, new_dtype=bf16, n_kv=n_kv, d=d, page=page,
                    pps=pps, pool_pages=pps + 1, **shape)
                t = window_timing(torch, timer, int8, pool, args, kn, vn, 1024, [476],
                                  n_kv=n_kv, d=d, page=page)
                out.setdefault(name, {})[
                    f"{tag} page {page} B1 W1024 base 1024 width 476 bf16 rows"] = dict(
                    max_abs_err=0.0, **t)
                del pool, args, kn, vn
        torch.cuda.empty_cache()
    for name, shapes in out.items():
        for shape, t in shapes.items():
            say(f"  timing {name} {shape}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) library_ms={t['library_ms']}")
    return out


# ---------------------------------------------------------------------------
# phase 2, the W8A16 kernel: int8 weights at llama-3-8b's and phi-3-mini's
# projections
# ---------------------------------------------------------------------------

# the projections, name -> (K, N): llama-3-8b's seven, phi-3-mini's (its
# fused qkv and gate_up split as the port holds them)
W8_PROJ = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
           "w_gate": (4096, 14336), "w_up": (4096, 14336), "w_down": (14336, 4096)}
W8_PHI3 = {"phi3 wq": (3072, 3072), "phi3 wk": (3072, 3072), "phi3 wv": (3072, 3072),
           "phi3 wo": (3072, 3072), "phi3 w_gate": (3072, 8192), "phi3 w_up": (3072, 8192),
           "phi3 w_down": (8192, 3072)}
# a K that no 64-row unit divides (16-row units, slices of unequal length)
W8_ODD = {"odd K": (4112, 4096)}
# the timed shapes: label -> one projection of that shape, and how many a
# layer has
W8_TIMED = {"wq/wo": ("wq", 2), "wk/wv": ("wk", 2), "w_gate/w_up": ("w_gate", 2),
            "w_down": ("w_down", 1), "phi3 wqkvo": ("phi3 wq", 4),
            "phi3 w_gate/w_up": ("phi3 w_gate", 2), "phi3 w_down": ("phi3 w_down", 1)}
# rows: one decode row, decode at 8 and 64 slots, the headline prefill
# (4 x 64) and the default one (4 x 1,024)
W8_ROWS = (1, 8, 64, 256, 4096)
# rows held alone against calls of more rows (batch invariance)
W8_SAME_ROWS = (0, 5, 37, 63)
W8_SAME_CALLS = (8, 64, 65, 256, 4096)
W8_MAIN = "w_gate/w_up 4096x14336 M64"
W8_VARIANT = os.path.join("scripts", "w8_matmul_unsplit.cu")
W4_VARIANT = os.path.join("scripts", "w4_matmul_simple.cu")
MOE_VARIANT = os.path.join("scripts", "moe_experts_simple.cu")


def w8_work(M: int, K: int, N: int) -> tuple[float, float]:
    """FLOPs and bytes of one W8A16 call: the int8 weight and the f32
    scale read once, bf16 x read once and bf16 out written once."""
    return 2.0 * M * K * N, K * N + 4 * N + 2 * M * K + 2 * M * N


# the timing variants (scripts/): source -> {C entry: argtypes}, bound with
# ctypes ("p" a pointer, "i" an int)
VARIANT_ENTRIES = {W8_VARIANT: {"llmk_w8_matmul_unsplit": "ppppiiip"},
                   W4_VARIANT: {"llmk_w4_matmul_simple": "ppppppiiiiiip",
                                "llmk_w4_simple_splits": "iii"},
                   MOE_VARIANT: {"llmk_moe_experts_simple": "ppppppppiiiip"}}


def start_variant_build(source: str = W8_VARIANT):
    """Start nvcc on a timing variant (scripts/), beside the package's own
    builds; ``finish_variant_build`` loads it."""
    from llms_on_kubernetes_tpu_torch import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = kernels.BUILD_DIR / (os.path.splitext(os.path.basename(source))[0] + ".so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(path), source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), path, source


def stop_variant_builds(builds: dict) -> None:
    """Stop every variant build still running (a run that ended early)."""
    for proc, _path, _source in builds.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_variant_build(proc_path) -> dict:
    """The variant's C entries by name, once its nvcc has finished."""
    import ctypes

    proc, path, source = proc_path
    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc {source} exited {proc.returncode}:\n{out}")
    for name, line in ptxas_report(out):
        say(f"  ptxas {name} (timing variant): {line}")
    lib = ctypes.CDLL(str(path))
    fns = {}
    for symbol, sig in VARIANT_ENTRIES[source].items():
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int for c in sig]
        fn.restype = ctypes.c_int
        fns[symbol] = fn
    return fns


def ptxas_report(log: str) -> list:
    """(kernel, "R registers, S bytes spill stores, L bytes spill loads")
    for each kernel in an nvcc -Xptxas -v log, its name demangled by the
    toolkit's cu++filt (or c++filt) where one is found, without the
    anonymous namespace and the parameter list."""
    import re
    import shutil

    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Performance Loss" in line or "warning" in line:
            rows.append(["ptxas says", line.strip()[:400]])
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif name and re.search(r"Used \d+ registers", line):
            rows.append([name, re.search(r"Used (\d+) registers", line).group(1)
                         + f" registers, {spill}"])
            name, spill = None, ""
    tool = next((t for t in (shutil.which("cu++filt"), "/usr/local/cuda/bin/cu++filt",
                             shutil.which("c++filt")) if t and os.path.exists(t)), None)
    if tool and rows:
        out = subprocess.run([tool], input="\n".join(r[0] for r in rows), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, d in zip(rows, out):
                if r[0] == "ptxas says":
                    continue
                d = re.sub(r"\((int|bool|unsigned int)\)|^void |<unnamed>::|"
                           r"\(anonymous namespace\)::", "", d.strip())
                r[0] = re.sub(r"\(.*\)$", "", d)
    return [tuple(r) for r in rows]


def ptxas_faults(log, body: str) -> list:
    """What a kernel's ptxas report says against it: no report at all, no
    function named ``body``, ptxas's C7520 (wgmma serialized: a
    "Performance Loss" warning), or a function with spill stores or spill
    loads."""
    import re

    if not log:
        return ["no ptxas report (nvcc's output is neither in this run nor beside the library)"]
    rows = ptxas_report(log)
    bad = [f"{f}: {line}" for f, line in rows if "Performance Loss" in line]
    for f, line in rows:
        if f == "ptxas says":
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if not m or int(m.group(1)) or int(m.group(2)):
            bad.append(f"{f}: {line} (spills)")
    if not any(body in f for f, _ in rows):
        bad.append(f"no function {body} in the ptxas report")
    return bad


def w8_kernels(torch, rng, timer, unsplit) -> dict:
    """Phase 2 for the W8A16 kernel: the K split against its Python mirror;
    float32 at small shapes (1e-4); bfloat16 at llama-3-8b's and
    phi-3-mini's projections and at a K of 16-row units, at M 1, 8, 64,
    256 and 4,096 (the row tolerance); rows alone bit-equal to them in
    calls of 8, 64, 65, 256 and 4,096 rows (batch invariance, across both
    bodies); the refusals; then the kernel, the unsplit timing variant
    (``unsplit``, in turns: kernel, variant, variant, kernel), the plain
    version and bf16 ``torch.matmul`` with a bf16 copy of the weight made
    outside the timed region (what bf16 serving pays for the same product)
    timed at every distinct shape and M, beside the bound."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.ops import quant as q

    f32, bf16 = torch.float32, torch.bfloat16

    def inputs(M, K, N, dtype):
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to("cuda", dtype)
        w = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8)).cuda()
        s = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=N).astype(np.float32)).cuda()
        return x, w, s

    def old(x, w, s):
        out = torch.empty((x.shape[0], w.shape[1]), dtype=bf16, device="cuda")
        kernels.check("w8_matmul_unsplit", unsplit(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            w.shape[1], torch.cuda.current_stream().cuda_stream))
        return out

    say("kernel w8_matmul (the port's own: the product JAX ops/quant.py::qeinsum leaves to XLA)")
    shapes = {**W8_PROJ, **W8_PHI3, **W8_ODD}
    splits = kernels.function("w8_splits")
    for K, N in sorted({*shapes.values(), (64, 32), (64, 64), (128, 64), (64, 128), (80, 48),
                        (320, 96), (1024, 4096), (28672, 8192)}):
        if splits(K, N) != len(q.w8_splits(K, N)):
            fail(f"w8_splits({K}, {N}): the kernel cuts {splits(K, N)} slices, "
                 f"ops/quant.py {len(q.w8_splits(K, N))}")
    say("  K slices (kernel = ops/quant.w8_splits): " + ", ".join(
        f"{K}x{N}: {len(q.w8_splits(K, N))}" for K, N in sorted(set(shapes.values()))))
    # float32 at small K: 1e-4 is the summation order's error there
    for M, K, N in [(1, 64, 32), (5, 64, 32), (17, 128, 48), (70, 320, 96), (300, 256, 160)]:
        x, w, s = inputs(M, K, N, f32)
        check_close(f"f32 M{M} K{K} N{N}", q.w8_matmul(x, w, s), q.w8_matmul_plain(x, w, s),
                    "float32")
    xs = {K: torch.from_numpy(rng.normal(size=(max(W8_ROWS), K)).astype(np.float32)).to(
        "cuda", bf16) for K in sorted({K for K, _ in shapes.values()})}
    weights, err = {}, 0.0
    for name, (K, N) in shapes.items():
        _, w, s = inputs(1, K, N, bf16)
        weights[name] = (w, s)
        outs = {}
        for M in sorted({*W8_ROWS, *W8_SAME_CALLS}):
            x = xs[K][:M]
            outs[M] = q.w8_matmul(x, w, s)
            if M in W8_ROWS:
                err = max(err, check_close(f"bf16 {name} {K}->{N} M{M}", outs[M],
                                           q.w8_matmul_plain(x, w, s), "bfloat16"))
        for r in W8_SAME_ROWS:
            one = q.w8_matmul(xs[K][r:r + 1], w, s)[0]
            for M in W8_SAME_CALLS:
                if r < M and not torch.equal(one, outs[M][r]):
                    fail(f"w8_matmul {name}: row {r} alone differs from row {r} of a call of "
                         f"{M} rows (batch invariance)")
        del outs
    say(f"  batch invariance: rows {W8_SAME_ROWS} alone equal them in calls of "
        f"{W8_SAME_CALLS} rows, bit for bit, at every projection (both bodies)")
    x, w, s = inputs(8, 64, 32, bf16)
    x40, w40, s40 = inputs(8, 40, 32, bf16)
    for label, args in (("a CPU tensor", (x, w.cpu(), s)), ("a strided view", (x[:, ::2], w, s)),
                        ("K % 16 != 0", (x40, w40, s40))):
        try:
            q.w8_matmul(*args)
        except ValueError as e:
            say(f"  refuses {label}: {e}")
        else:
            fail(f"w8_matmul took {label}")
    torch.cuda.synchronize()

    timings = {}
    for label, (name, _per_layer) in W8_TIMED.items():
        K, N = shapes[name]
        w, s = weights[name]
        wb = w.to(bf16)        # the bf16 weight bf16 serving holds (exact)
        for M in W8_ROWS:
            x = xs[K][:M]
            t1 = timer(lambda: q.w8_matmul(x, w, s), reps=50)
            o1 = timer(lambda: old(x, w, s), reps=50)
            o2 = timer(lambda: old(x, w, s), reps=50)
            t2 = timer(lambda: q.w8_matmul(x, w, s), reps=50)
            plain = timer(lambda: q.w8_matmul_plain(x, w, s))
            lib = timer(lambda: torch.matmul(x, wb))
            b_ms, b_by = bound_ms(*w8_work(M, K, N), "bfloat16")
            key = f"{label} {K}x{N} M{M}"
            timings[key] = dict(ms=(t1 + t2) / 2, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib, unsplit_ms=(o1 + o2) / 2)
            say(f"  timing w8_matmul {key}: ms={t1:.4f},{t2:.4f} unsplit_ms={o1:.4f},{o2:.4f} "
                f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) library_ms={lib:.4f}")
        del wb
    for model, labels in (("llama-3-8b", ("wq/wo", "wk/wv", "w_gate/w_up", "w_down")),
                          ("phi-3-mini", ("phi3 wqkvo", "phi3 w_gate/w_up", "phi3 w_down"))):
        for M in (8, 64):
            per = {}
            for k in ("ms", "unsplit_ms", "bound_ms", "library_ms"):
                per[k] = 32 * sum(timings[f"{lbl} {shapes[W8_TIMED[lbl][0]][0]}x"
                                          f"{shapes[W8_TIMED[lbl][0]][1]} M{M}"][k]
                                  * W8_TIMED[lbl][1] for lbl in labels)
            say(f"  w8_matmul, a {model} forward's projections at M {M} (32 layers x 7): "
                f"ms={per['ms']:.3f} unsplit_ms={per['unsplit_ms']:.3f} "
                f"bound_ms={per['bound_ms']:.3f} bf16 torch.matmul={per['library_ms']:.3f} "
                f"[{card_line()}]")
    main = timings[W8_MAIN]
    return {"w8_matmul": dict(
        name="w8_matmul", route="cuda", source="llms_on_kubernetes_tpu_torch/csrc/w8_matmul.cu",
        replaces="llms_on_kubernetes_tpu/ops/quant.py:311", max_abs_err=err, **main,
        shape=f"{W8_MAIN} bf16 x, int8 w", other_shapes={k: v for k, v in timings.items()
                                                         if k != W8_MAIN},
        library_note="torch.matmul of x with a bf16 copy of the weight made outside the "
                     "timed region: what bf16 serving pays for the same product",
        unsplit_note=f"unsplit_ms: the kernel before the K split ({W8_VARIANT}), timed in "
                     "turns with this one in the same run")}


# ---------------------------------------------------------------------------
# phase 2, the W4A16 kernel: AWQ's grouped int4 at Qwen3-8B's projections
# ---------------------------------------------------------------------------

# Qwen3-8B's seven projections, name -> (K, N); AWQ's published group, 128
W4_PROJ = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
           "w_gate": (4096, 12288), "w_up": (4096, 12288), "w_down": (12288, 4096)}
W4_GROUP = 128
# the timed shapes: label -> one projection of that shape, and how many a layer has
W4_TIMED = {"wq/wo": ("wq", 2), "wk/wv": ("wk", 2), "w_gate/w_up": ("w_gate", 2),
            "w_down": ("w_down", 1)}
W4_ROWS = (1, 8, 64, 256, 4096)
# rows checked against the plain version: the timed ones and 65, the first
# of the prefill body
W4_CHECK_ROWS = (1, 8, 64, 65, 256, 4096)
W4_SAME_ROWS = (0, 5, 37, 63)
W4_SAME_CALLS = (8, 17, 64, 65, 256, 4096)
# narrow shapes: N off the 128-column slab (16, 48, 1,040), groups of 16 to
# 128 rows, K of one group; (K, N, gs)
W4_NARROW = ((64, 16, 64), (256, 48, 32), (128, 1040, 128), (16, 48, 16), (512, 1040, 16),
             (384, 144, 64), (32, 16, 32))
W4_MAIN = "w_gate/w_up 4096x12288 M8"
# csrc/w4_matmul.cu kMinPrefillBlocks: M > 64 rows take the prefill body
# where it has at least this many 128 x 128 blocks, else the decode body
W4_MIN_PREFILL_BLOCKS = 256


def w4_prefill_rows(N: int) -> int:
    """The fewest rows (a multiple of 128) that put an N-column W4A16 call
    on the prefill body."""
    return 128 * -(-W4_MIN_PREFILL_BLOCKS // -(-N // 128))


def w4_work(M: int, K: int, N: int, gs: int = W4_GROUP) -> tuple[float, float]:
    """FLOPs and bytes of one W4A16 call: the packed int4 weight (half a
    byte a weight), f32 scale and zero_scaled ([G, N], 8 bytes a group and
    column) read once, bf16 x read once and bf16 out written once."""
    return 2.0 * M * K * N, K * N / 2 + 8 * (K // gs) * N + 2 * M * (K + N)


def w4_inputs(torch, rng, K: int, N: int, gs: int = W4_GROUP, packed: bool = True):
    """A random AWQ-like grouped int4 weight on the card: centered values
    -8..7, scales ~ 1 / (4.6 sqrt(K)) and zero points 6..9, as
    ``awq_group_tensors`` leaves them."""
    from llms_on_kubernetes_tpu_torch.ops import quant as q

    G = K // gs
    vals = torch.from_numpy(rng.integers(-8, 8, size=(G, gs, N)).astype(np.int8))
    data = (q.pack_int4_lanes(vals) if packed else vals).cuda()
    s = (rng.uniform(0.8, 1.2, size=(G, N)) / (4.6 * np.sqrt(K))).astype(np.float32)
    z = rng.integers(6, 10, size=(G, N)).astype(np.float32) - 8
    return data, torch.from_numpy(s).cuda(), torch.from_numpy(s * z).cuda()


def w4_one_call(torch, fn, label: str) -> None:
    """One W4A16 call captured in a CUDA graph is one kernel node, its
    replay gives the eager call's bits, and the wrapper allocates nothing
    but the output (peak allocation over the call, eager)."""
    want = fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fn()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    out_bytes = -(-got.numel() * got.element_size() // 512) * 512
    if grown != out_bytes:
        fail(f"w4_matmul {label}: the call allocated {grown} bytes, its output {out_bytes}")
    del got
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # its nodes stay readable
    with torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    nodes = graph_nodes(graph)
    if nodes != {"kernel": 1}:
        fail(f"w4_matmul {label}: a captured call holds {nodes}, not one kernel node")
    if not torch.equal(out, want):
        fail(f"w4_matmul {label}: the graph replay differs from the eager call")
    say(f"  {label}: one kernel node in a captured call, replay bit-equal, "
        f"{grown} bytes allocated (the output's)")
    del graph, out


def w4_kernels(torch, rng, timer, simple) -> dict:
    """Phase 2 for the W4A16 kernel: the K split against its Python mirror;
    float32 at small shapes (1e-4), packed and int8 storage; bfloat16 at
    Qwen3-8B's seven projections (group 128, packed) at M 1, 8, 64, 65, 256
    and 4,096 (the row tolerance), at narrow shapes (N 16, 48, 144, 1,040;
    gs 16 to 128; K of one group) and in int8 storage; rows alone bit-equal
    to them in calls of 8, 17, 64, 65, 256 and 4,096 rows (batch
    invariance, across the decode and prefill bodies); one kernel node in a
    captured call and no workspace; the refusals; then, in turns, the
    kernel, the earlier simple body (``simple``, scripts/w4_matmul_simple.cu), the
    W8A16 kernel at the same shape, bf16 ``torch.matmul`` with a bf16 copy
    of the dequantized weight made outside the timed region, the kernel
    again; and the plain version, beside the bound."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.ops import quant as q

    f32, bf16 = torch.float32, torch.bfloat16
    say("kernel w4_matmul (the port's own: the product JAX ops/quant.py::group_qeinsum "
        "leaves to XLA)")
    splits = kernels.function("w4_splits")
    for K, N, gs in sorted({*((K, N, W4_GROUP) for K, N in W4_PROJ.values()), *W4_NARROW,
                            (64, 32, 16), (256, 64, 32), (4096, 128, 64), (512, 4096, 128),
                            (28672, 8192, 128), (12288, 4096, 64), (4096, 4096, 32)}):
        if splits(K, N, gs) != len(q.w4_splits(K, N, gs)):
            fail(f"w4_splits({K}, {N}, {gs}): the kernel cuts {splits(K, N, gs)} slices, "
                 f"ops/quant.py {len(q.w4_splits(K, N, gs))}")
    say("  K slices (kernel = ops/quant.w4_splits): " + ", ".join(
        f"{K}x{N}: {len(q.w4_splits(K, N, W4_GROUP))}" for K, N in sorted(set(W4_PROJ.values()))))
    for M, K, N, gs in [(1, 64, 32, 16), (5, 256, 48, 32), (17, 256, 64, 128),
                        (70, 384, 96, 128), (300, 512, 160, 256), (3, 16, 1040, 16)]:
        for packed in (True, False):
            data, s, zs = w4_inputs(torch, rng, K, N, gs, packed)
            x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
            check_close(f"f32 M{M} K{K} N{N} gs{gs} {'packed' if packed else 'int8'}",
                        q.w4_matmul(x, data, s, zs, packed),
                        q.group_qeinsum_plain(x, data, s, zs, packed), "float32")
    err = 0.0
    for K, N, gs in W4_NARROW:
        Mp = w4_prefill_rows(N)   # a call on the prefill body
        x = torch.from_numpy(rng.normal(size=(Mp, K)).astype(np.float32)).to("cuda", bf16)
        for packed in (True, False):
            data, s, zs = w4_inputs(torch, rng, K, N, gs, packed)
            full = q.w4_matmul(x, data, s, zs, packed)
            err = max(err, check_close(f"bf16 K{K} N{N} gs{gs} {'packed' if packed else 'int8'}"
                                       f" M{Mp}", full,
                                       q.group_qeinsum_plain(x, data, s, zs, packed),
                                       "bfloat16"))
            for M in (1, 8, 64, 65, 300):
                if not torch.equal(q.w4_matmul(x[:M], data, s, zs, packed), full[:M]):
                    fail(f"w4_matmul K{K} N{N} gs{gs}: a call of {M} rows differs from the "
                         f"first {M} rows of a call of {Mp} (batch invariance)")
    say(f"  narrow shapes {W4_NARROW} (K, N, gs): bf16 within the row tolerance, calls of 1, "
        f"8, 64, 65 and 300 rows (the decode body) bit-equal to the rows of a call on the "
        f"prefill body, packed and int8 storage")
    xs = {K: torch.from_numpy(rng.normal(size=(max(W4_ROWS), K)).astype(np.float32)).to(
        "cuda", bf16) for K in sorted({K for K, _ in W4_PROJ.values()})}
    weights = {}
    for name, (K, N) in W4_PROJ.items():
        data, s, zs = w4_inputs(torch, rng, K, N)
        weights[name] = (data, s, zs)
        outs = {}
        for M in sorted({*W4_CHECK_ROWS, *W4_SAME_CALLS}):
            x = xs[K][:M]
            outs[M] = q.w4_matmul(x, data, s, zs, True)
            if M in W4_CHECK_ROWS:
                err = max(err, check_close(f"bf16 {name} {K}->{N} M{M}", outs[M],
                                           q.group_qeinsum_plain(x, data, s, zs, True),
                                           "bfloat16"))
        for r in W4_SAME_ROWS:
            one = q.w4_matmul(xs[K][r:r + 1], data, s, zs, True)[0]
            for M in W4_SAME_CALLS:
                if r < M and not torch.equal(one, outs[M][r]):
                    fail(f"w4_matmul {name}: row {r} alone differs from row {r} of a call of "
                         f"{M} rows (batch invariance)")
        if not torch.equal(outs[64], outs[4096][:64]) or \
                not torch.equal(outs[65], outs[4096][:65]):
            fail(f"w4_matmul {name}: the first 64 or 65 rows differ from a call of 4,096")
        del outs
    say(f"  batch invariance: rows {W4_SAME_ROWS} alone equal them in calls of "
        f"{W4_SAME_CALLS} rows, and calls of 64 and 65 rows the first rows of 4,096, bit for "
        f"bit, at every projection (the decode and prefill bodies)")
    data8 = q.unpack_int4_lanes(weights["wk"][0]).contiguous()
    for M in (8, 65, 256):
        x = xs[4096][:M]
        got = q.w4_matmul(x, data8, weights["wk"][1], weights["wk"][2], False)
        err = max(err, check_close(f"bf16 wk int8 storage M{M}", got, q.group_qeinsum_plain(
            x, data8, weights["wk"][1], weights["wk"][2], False), "bfloat16"))
        if not torch.equal(got, q.w4_matmul(x, *weights["wk"], True)):
            fail("w4_matmul: int8 storage differs from packed storage of the same values")
    say("  int8 storage equals packed storage of the same values, bit for bit")
    for M in (8, 256):
        x = xs[4096][:M]
        w_gate = weights["w_gate"]
        w4_one_call(torch, lambda: q.w4_matmul(x, *w_gate, True), f"w_gate M{M}")
    data, s, zs = w4_inputs(torch, rng, 256, 64, 32)
    x = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32)).to("cuda", bf16)
    d24, s24, z24 = w4_inputs(torch, rng, 240, 64, 24)
    x24 = torch.from_numpy(rng.normal(size=(8, 240)).astype(np.float32)).to("cuda", bf16)
    for label, args in (("a CPU weight", (x, data.cpu(), s, zs, True)),
                        ("a strided view", (x[:, ::2], data, s, zs, True)),
                        ("gs % 16 != 0", (x24, d24, s24, z24, True))):
        try:
            q.w4_matmul(*args)
        except ValueError as e:
            say(f"  refuses {label}: {e}")
        else:
            fail(f"w4_matmul took {label}")
    torch.cuda.synchronize()

    run_simple, simple_splits = simple["llmk_w4_matmul_simple"], simple["llmk_w4_simple_splits"]

    def old(x, data, s, zs, part):
        M, K = x.shape
        N = data.shape[2]
        out = torch.empty((M, N), dtype=bf16, device="cuda")
        kernels.check("w4_matmul_simple", run_simple(
            x.data_ptr(), data.data_ptr(), s.data_ptr(), zs.data_ptr(), part.data_ptr(),
            out.data_ptr(), M, K, N, W4_GROUP, 1, kernels.DTYPE_CODES[bf16],
            torch.cuda.current_stream().cuda_stream))
        return out

    timings = {}
    for label, (name, _per_layer) in W4_TIMED.items():
        K, N = W4_PROJ[name]
        data, s, zs = weights[name]
        wb = q.GroupQTensor(data, s, zs, (N,), True).dequantize(bf16)   # outside the timing
        w8 = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8)).cuda()
        s8 = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=N).astype(np.float32)).cuda()
        for M in W4_ROWS:
            x = xs[K][:M]
            part = torch.empty((simple_splits(K, N, W4_GROUP), M, N), dtype=f32, device="cuda")
            if M in (8, 4096):
                check_close(f"bf16 {label} M{M} the simple body", old(x, data, s, zs, part),
                            q.w4_matmul(x, data, s, zs, True), "bfloat16")
            t1 = timer(lambda: q.w4_matmul(x, data, s, zs, True), reps=50)
            o1 = timer(lambda: old(x, data, s, zs, part), reps=50)
            w8_ms = timer(lambda: q.w8_matmul(x, w8, s8), reps=50)
            lib = timer(lambda: torch.matmul(x, wb), reps=50)
            t2 = timer(lambda: q.w4_matmul(x, data, s, zs, True), reps=50)
            plain = timer(lambda: q.group_qeinsum_plain(x, data, s, zs, True), reps=5)
            del part
            b_ms, b_by = bound_ms(*w4_work(M, K, N), "bfloat16")
            key = f"{label} {K}x{N} M{M}"
            timings[key] = dict(ms=(t1 + t2) / 2, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib, w8_ms=w8_ms, simple_ms=o1)
            say(f"  timing w4_matmul {key}: ms={t1:.4f},{t2:.4f} simple_ms={o1:.4f} "
                f"w8_matmul_ms={w8_ms:.4f} library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"plain_ms={plain:.4f}")
        del wb, w8
    for M in (8, 64):
        per = {k: 36 * sum(timings[f"{lbl} {W4_PROJ[W4_TIMED[lbl][0]][0]}x"
                                   f"{W4_PROJ[W4_TIMED[lbl][0]][1]} M{M}"][k] * W4_TIMED[lbl][1]
                           for lbl in W4_TIMED)
               for k in ("ms", "simple_ms", "bound_ms", "w8_ms", "library_ms")}
        say(f"  w4_matmul, a Qwen3-8B forward's projections at M {M} (36 layers x 7): "
            f"ms={per['ms']:.3f} simple_ms={per['simple_ms']:.3f} bound_ms={per['bound_ms']:.3f} "
            f"w8_matmul={per['w8_ms']:.3f} bf16 torch.matmul={per['library_ms']:.3f} "
            f"[{card_line()}]")
    main = timings[W4_MAIN]
    return {"w4_matmul": dict(
        name="w4_matmul", route="cuda", source="llms_on_kubernetes_tpu_torch/csrc/w4_matmul.cu",
        replaces="none: llms_on_kubernetes_tpu/ops/quant.py:238 group_qeinsum, left to XLA",
        max_abs_err=err, **main, shape=f"{W4_MAIN} bf16 x, packed int4 w, group {W4_GROUP}",
        other_shapes={k: v for k, v in timings.items() if k != W4_MAIN},
        library_note="torch.matmul of x with a bf16 copy of the dequantized weight made "
                     "outside the timed region: what bf16 serving pays for the product",
        w8_note="w8_ms: the W8A16 kernel at the same shape (int8 weight), in the same turns",
        simple_note=f"simple_ms: the kernel before its Hopper redesign ({W4_VARIANT}: mma.sync, one stage, a second "
                    "launch over an f32 workspace), timed in the same turns")}


# ---------------------------------------------------------------------------
# phase 3: the server, through its normal entry point
# ---------------------------------------------------------------------------

def http(method: str, url: str, body=None, timeout: float = 600.0, headers=None):
    """(status, body bytes)."""
    status, _headers, raw = http_full(method, url, body, timeout, headers)
    return status, raw


def http_full(method: str, url: str, body=None, timeout: float = 600.0, headers=None):
    """(status, response headers, body bytes)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def stream_lines(url: str, body: dict, headers=None, timeout: float = 600.0):
    """POST a streaming request; (status, response headers, [(t, line)] of
    every non-blank line, SSE comments included, t0)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    lines = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if line:
                lines.append((time.perf_counter(), line))
        return r.status, r.headers, lines, t0


def sse_finish(name: str, status: int, lines) -> tuple:
    """(text, finish reason, the final chunk's time) of a streamed
    completion's lines; fails unless it ends in one final chunk and
    [DONE]."""
    if status != 200 or not lines or lines[-1][1] != "data: [DONE]":
        fail(f"{name}: HTTP {status}, last line {lines[-1:]!r}")
    frames = [(t, json.loads(ln[6:])) for t, ln in lines[:-1] if ln.startswith("data: ")]
    finals = [(t, f) for t, f in frames if f["choices"] and f["choices"][0]["finish_reason"]]
    if len(finals) != 1:
        fail(f"{name}: {len(finals)} final chunks")
    text = "".join(f["choices"][0]["text"] for _, f in frames if f["choices"])
    return text, finals[0][1]["choices"][0]["finish_reason"], finals[0][0]


def metric(base: str, name: str, label: str = "") -> float:
    """A series of ``base``'s /metrics: ``name`` (with ``label`` among its
    labels), 0 when absent."""
    status, raw = http("GET", base + "/metrics", timeout=30)
    if status != 200:
        fail(f"{base}/metrics: HTTP {status}")
    for line in raw.decode().splitlines():
        head = line.split(" ", 1)[0]
        if (head == name or head.startswith(name + "{")) and label in head:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def metric_reaches(base: str, name: str, label: str, want: float, within_s: float = 5.0):
    """Poll a series until it reads ``want`` (the engine loop counts a
    step's finishes after it delivered them); fail past ``within_s``."""
    t0 = time.perf_counter()
    while (got := metric(base, name, label)) != want:
        if time.perf_counter() - t0 > within_s:
            fail(f"{name}{{{label}}} reads {got}, expected {want}")
        time.sleep(0.05)
    return got


def kernel_counts(base: str) -> dict:
    return json.loads(http("GET", base + "/debug/kernels")[1])


def stream(url: str, body: dict, timeout: float = 600.0):
    """POST a streaming request; return (status, [(t, data line)], t0)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append((time.perf_counter(), line[6:]))
        return r.status, events, t0


def check_stream(name: str, status: int, events, max_tokens: int) -> list[dict]:
    if status != 200:
        fail(f"{name}: HTTP {status}")
    if not events or events[-1][1] != "[DONE]":
        fail(f"{name}: the stream does not end in [DONE]")
    chunks = [json.loads(d) for _, d in events[:-1]]
    finals = [c for c in chunks if c["choices"] and c["choices"][0]["finish_reason"]]
    if len(finals) != 1 or finals[0]["choices"][0]["finish_reason"] not in ("length", "stop"):
        fail(f"{name}: expected one final chunk with finish_reason length/stop")
    return chunks


def check_graphed(name: str, counts: dict, counts0: dict) -> int:
    """Every decode window between two ``/debug/kernels`` reads ran as one
    CUDA graph replay: replays >= 1, replays x decode_steps == the decode
    forwards, and every decode-kernel launch in that time was added by a
    replay (``replayed_launches``; a wrapper run eagerly counts only in
    ``launches``), with at least one such launch. Returns the replays."""
    replays = counts["graph_replays"] - counts0["graph_replays"]
    forwards = counts["decode_forwards"] - counts0["decode_forwards"]

    def decode_delta(key):
        return {k: n - counts0[key].get(k, 0) for k, n in counts[key].items()
                if k.startswith("paged_decode") and n != counts0[key].get(k, 0)}

    launched, replayed = decode_delta("launches"), decode_delta("replayed_launches")
    say(f"  {name}: {replays} decode windows, each one CUDA graph replay of "
        f"{counts['decode_steps']} steps ({forwards} decode forwards); decode kernel "
        f"launches {launched}, of them by replays {replayed}")
    if replays < 1 or replays * counts["decode_steps"] != forwards:
        fail(f"{name}: {replays} graph replays x {counts['decode_steps']} steps != "
             f"{forwards} decode forwards: a window ran outside the graph")
    if not launched or launched != replayed:
        fail(f"{name}: decode kernel launches {launched} != those of graph replays "
             f"{replayed}: a decode kernel ran eagerly")
    return replays


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Server:
    """``python -m llms_on_kubernetes_tpu_torch serve ARGS`` on the card
    and a free port, its output in ``OUT_DIR/log_name`` and ``env`` added
    to its environment; started at once, waited for by ``wait_health``,
    stopped by ``stop`` (a failure prints the tail of its log)."""

    def __init__(self, args: list, log_name: str, env=None, pool_args=POOL_ARGS):
        port = free_port()
        self.base = f"http://127.0.0.1:{port}"
        os.makedirs(OUT_DIR, exist_ok=True)
        self.log_path = os.path.join(OUT_DIR, log_name)
        cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", *pool_args,
               *args, "--device", "cuda", "--host", "127.0.0.1", "--port", str(port)]
        say(f"serve: {' '.join(cmd[1:])}" + (f" ({env})" if env else ""))
        self.t_start = time.perf_counter()
        self.logf = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, stdout=self.logf, stderr=subprocess.STDOUT,
                                     start_new_session=True, env={**os.environ, **(env or {})})
        self.health_s = None

    def wait_health(self, within_s: float = 420.0) -> float:
        deadline = self.t_start + within_s
        while True:
            if self.proc.poll() is not None:
                self.fail(f"server exited with {self.proc.returncode} before /health answered")
            try:
                status, body = http("GET", self.base + "/health", timeout=5)
                if status == 200 and body == b"OK":
                    break
            except OSError:
                pass
            if time.perf_counter() > deadline:
                self.fail(f"server did not answer /health within {within_s:.0f} s")
            time.sleep(0.25)
        self.health_s = time.perf_counter() - self.t_start
        say(f"  /health OK after {self.health_s:.1f} s ({self.base})")
        return self.health_s

    def tail(self) -> str:
        self.logf.flush()
        with open(self.log_path) as f:
            return "".join(f.readlines()[-40:])

    def fail(self, msg: str) -> None:
        say("server log (tail):\n" + self.tail())
        fail(msg)

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.logf.close()


def with_server(args: list, log_name: str, drive, env=None, pool_args=POOL_ARGS) -> dict:
    """Start a ``Server``, wait for /health (at most 420 s), then return
    ``drive(base URL, process)`` with ``health_s``, the seconds to
    /health, added. The server is stopped however this ends; a failure
    prints the tail of its log."""
    srv = Server(args, log_name, env, pool_args)
    try:
        srv.wait_health()
        return {**drive(srv.base, srv.proc), "health_s": srv.health_s}
    except SystemExit:
        if srv.health_s is not None:        # wait_health printed it already
            say("server log (tail):\n" + srv.tail())
        raise
    finally:
        srv.stop()


def phase_serve(model: str, num_layers: int, kv_cache_dtype=None) -> dict:
    """The server with bf16 KV runs behind ``llkt-router`` (every completion
    through it) and then serves the request surface and the drain; the
    int8-KV server is driven directly."""
    kv = ["--kv-cache-dtype", kv_cache_dtype] if kv_cache_dtype else []
    log = f"chip_smoke_server{'_' + kv_cache_dtype if kv_cache_dtype else ''}.log"
    if kv_cache_dtype:
        return with_server(["--model", model, "--random-weights", *kv], log,
                           lambda base, _proc: _drive_server(base, model, num_layers,
                                                             kv_cache_dtype))
    return with_server(["--model", model, "--random-weights"], log,
                       lambda base, proc: _drive_replica(base, proc, model, num_layers))


def _drive_server(base: str, model: str, num_layers: int, kv_cache_dtype=None,
                  api: str = None) -> dict:
    """The burst, the cache hit and the decode-rate streams; completions go
    to ``api`` (the router in front of the server, or the server)."""
    api = api or base
    status, body = http("GET", base + "/v1/models")
    if status != 200 or json.loads(body)["data"][0]["id"] != model:
        fail(f"/v1/models: {status} {body[:200]!r}")

    max_tokens = 32
    text = SERVE_TEXT
    jobs = {
        "completion greedy 40-token prompt": ("/v1/completions", {
            "model": model, "prompt": text[:40], "max_tokens": max_tokens, "temperature": 0}),
        "completion seeded t=0.8 200-token prompt": ("/v1/completions", {
            "model": model, "prompt": text[:200], "max_tokens": max_tokens,
            "temperature": 0.8, "seed": 1234}),
        "completion greedy 900-token prompt": ("/v1/completions", {
            "model": model, "prompt": PROMPT_900, "max_tokens": max_tokens,
            "temperature": 0}),
        "completion greedy 1500-token prompt (2 chunks)": ("/v1/completions", {
            "model": model, "prompt": PROMPT_1500, "max_tokens": max_tokens,
            "temperature": 0}),
        "chat streamed": ("/v1/chat/completions", {
            "model": model, "messages": [{"role": "user", "content": text[:150]}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}}),
    }
    status, _ = http("POST", base + "/debug/kernels/reset", {})
    if status != 200:
        fail("/debug/kernels/reset failed")
    counts0 = json.loads(http("GET", base + "/debug/kernels")[1])
    results: dict = {}

    def run(name, path, body):
        try:
            if body.get("stream"):
                results[name] = ("stream",) + stream(api + path, body)
            else:
                results[name] = ("full",) + http("POST", api + path, body)
        except Exception as e:  # reported below as this request's failure
            results[name] = ("error", repr(e))

    threads = [threading.Thread(target=run, args=(n, p, b)) for n, (p, b) in jobs.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t0
    # the 900-token prompt again with a 100-character tail: a cache hit of
    # its first 14 pages (896 tokens), the rest through the chunk path
    resend = "completion greedy 900-token prompt again + 100-character tail"
    counts_burst = json.loads(http("GET", base + "/debug/kernels")[1])
    results[resend] = ("full",) + http("POST", api + "/v1/completions", {
        "model": model, "prompt": PROMPT_900 + TAIL_100,
        "max_tokens": max_tokens, "temperature": 0})
    status, body = http("GET", base + "/debug/kernels")
    counts = json.loads(body)
    for name in [*jobs, resend]:
        res = results.get(name)
        if res is None or res[0] == "error":
            fail(f"{name}: {res}")
        if res[0] == "full":
            _, status, raw = res
            if status != 200:
                fail(f"{name}: HTTP {status} {raw[:300]!r}")
            data = json.loads(raw)
            ch = data["choices"][0]
            if ch["finish_reason"] not in ("length", "stop") or not isinstance(ch["text"], str):
                fail(f"{name}: bad choice {ch}")
            n = data["usage"]["completion_tokens"]
            if not (n == max_tokens or (ch["finish_reason"] == "stop" and 0 < n <= max_tokens)):
                fail(f"{name}: completion_tokens={n}, finish_reason={ch['finish_reason']}")
            say(f"  {name}: 200, {data['usage']['prompt_tokens']} prompt tokens, {n} "
                f"tokens, finish_reason={ch['finish_reason']}")
        else:
            _, status, events, _t0 = res
            chunks = check_stream(name, status, events, max_tokens)
            if chunks[0]["choices"][0]["delta"].get("role") != "assistant":
                fail(f"{name}: first chunk carries no assistant role")
            usage = chunks[-1].get("usage") or {}
            n = usage.get("completion_tokens")
            reason = [c for c in chunks if c["choices"] and
                      c["choices"][0]["finish_reason"]][0]["choices"][0]["finish_reason"]
            if not (n == max_tokens or (reason == "stop" and n and n <= max_tokens)):
                fail(f"{name}: completion_tokens={n}, finish_reason={reason}")
            say(f"  {name}: 200, {len(chunks)} chunks ending in [DONE], {n} tokens, "
                f"finish_reason={reason}")
    launches = counts["launches"]
    # the burst's own calls: the server's warm-up ran before counts0
    prefills = counts["prefill_calls"] - counts0["prefill_calls"]
    forwards = counts["decode_forwards"] - counts0["decode_forwards"]
    say(f"  kernel launches over the burst: {launches}; prefill calls {prefills}, decode "
        f"forwards {forwards}, layers {num_layers}; burst wall {burst_s:.2f} s")
    if prefills < 1 or forwards < 1:
        fail("the burst ran no prefill or no decode")
    if launches.get("flash_prefill", 0) < num_layers * prefills:
        fail("flash_prefill launched fewer than num_layers times per prefill call")
    decode_kernel = "paged_decode_int8" if kv_cache_dtype else "paged_decode"
    if launches.get(decode_kernel, 0) < num_layers * forwards:
        fail(f"{decode_kernel} launched fewer than num_layers times per decode step")
    if kv_cache_dtype and launches.get("paged_decode", 0):
        fail("the int8 KV server launched the float decode kernel")
    # the chunk path: one window append a layer per chunk call, by pool kind
    chunk_calls = counts["chunk_calls"] - counts0["chunk_calls"]
    hits = counts["prefix_hit_tokens"] - counts0["prefix_hit_tokens"]
    resend_hit = counts["prefix_hit_tokens"] - counts_burst["prefix_hit_tokens"]
    window, other = (("paged_write_window_int8", "paged_write_window") if kv_cache_dtype
                     else ("paged_write_window", "paged_write_window_int8"))
    say(f"  chunk path: {chunk_calls} chunk calls, {launches.get(window, 0)} {window} "
        f"launches, {hits} prompt tokens from the prefix cache ({resend_hit} by the "
        f"re-sent prompt)")
    if launches.get(window, 0) != num_layers * chunk_calls or launches.get(window, 0) < 96:
        fail(f"{window} launched {launches.get(window, 0)} times for {chunk_calls} chunk "
             f"calls: expected num_layers per call, and at least 96")
    if launches.get(other, 0):
        fail(f"the {kv_cache_dtype or 'bf16'} KV server launched {other}")
    if resend_hit < 896:
        fail(f"the re-sent 900-token prompt adopted {resend_hit} < 896 cached tokens")
    check_graphed("burst", counts, counts0)

    # TTFT and decode rate: 8 concurrent greedy streams (one per slot); TTFT
    # is the first token's chunk (the server sends one per first token even
    # when its text is empty), decode rate the tokens after it over the span
    # from the first of those chunks to the last
    n_dec = 64
    per: list = []

    def one(i):
        body = {"model": model, "prompt": text[i:i + 40], "max_tokens": n_dec,
                "temperature": 0, "stream": True, "stream_options": {"include_usage": True}}
        per.append(stream(api + "/v1/completions", body))

    counts_rate = json.loads(http("GET", base + "/debug/kernels")[1])
    ths = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=600)
    if len(per) != 8:
        fail("decode-rate streams did not all finish")
    check_graphed("decode-rate streams", json.loads(http("GET", base + "/debug/kernels")[1]),
                  counts_rate)
    ttft, firsts, lasts, toks = [], [], [], 0
    for status, events, t0 in per:
        chunks = check_stream("decode-rate stream", status, events, n_dec)
        ttft.append(events[0][0] - t0)
        firsts.append(events[0][0])
        # the chunk that carries the finish reason follows the last token
        lasts.append(next(t for (t, _), c in zip(events, chunks)
                          if c["choices"] and c["choices"][0]["finish_reason"]))
        toks += chunks[-1]["usage"]["completion_tokens"] - 1
    decode_tps = toks / (max(lasts) - min(firsts))
    card = card_line()
    kv = f", {kv_cache_dtype} KV" if kv_cache_dtype else ""
    via = ", through llkt-router" if api != base else ""
    say(f"TTFT (8 concurrent 40-token prompts, median{kv}{via}) ms: "
        f"{1e3 * float(np.median(ttft)):.1f} [{card}]")
    say(f"decode tokens/s (8 concurrent streams of {n_dec} tokens, {model} bf16{kv}{via}): "
        f"{decode_tps:.1f} [{card}]")
    return {"launches": launches, "ttft_ms": 1e3 * float(np.median(ttft)),
            "decode_tps": decode_tps}


# ---------------------------------------------------------------------------
# phase 3, the replica contract: behind llkt-router, the request surface,
# /metrics, /ready and the drain
# ---------------------------------------------------------------------------

ROUTER_BIN = os.path.join("llms_on_kubernetes_tpu_torch", "_build", "llkt-router")
PROBE_S = 0.5           # the router's /ready probe period
# the byte tokenizer decodes ids < 256 only, which a random-weights
# llama-3-8b (128,256 ids) almost never samples: requests whose text is
# held carry +100 on these 29 letters (the map's limit is 32 entries)
BYTE_BIAS = {str(ord(c)): 100 for c in "abcdefghijklmnopqrstuvwxyz .,"}


def start_router_build():
    """g++ native/router/router.cpp into the port's build directory, in
    the background (``make -C native/router`` writes the path the native
    router's tests use)."""
    if shutil.which("g++") is None:
        fail("no g++ to build native/router/router.cpp")
    os.makedirs(os.path.dirname(ROUTER_BIN), exist_ok=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    log = open(os.path.join(OUT_DIR, "router_build.log"), "w")
    return subprocess.Popen(["g++", "-O2", "-std=c++17", "-pthread", "-o", ROUTER_BIN,
                             os.path.join("native", "router", "router.cpp")],
                            stdout=log, stderr=subprocess.STDOUT)


def finish_router_build(proc) -> None:
    if proc.wait(timeout=900) != 0:
        with open(os.path.join(OUT_DIR, "router_build.log")) as f:
            say(f.read()[-3000:])
        fail(f"g++ of native/router/router.cpp exited with {proc.returncode}")


def replica_healthy(router: str, replica: str):
    """The router's llm_replica_healthy for ``replica``, or None (no such
    series yet, or the router not listening yet)."""
    try:
        status, raw = http("GET", router + "/metrics", timeout=10)
    except OSError:
        return None
    if status != 200:
        fail(f"router /metrics: HTTP {status}")
    for line in raw.decode().splitlines():
        if line.startswith("llm_replica_healthy{") and f'replica="{replica}"' in line:
            return float(line.rsplit(" ", 1)[1])
    return None


def _drive_replica(base: str, proc, model: str, num_layers: int) -> dict:
    """Start ``llkt-router`` in front of the server, drive phase 3's
    requests through it, then the request surface, then the drain (which
    ends the server)."""
    port = free_port()
    router = f"http://127.0.0.1:{port}"
    cmd = [ROUTER_BIN, "--models", f"{model}={base}", "--port", str(port),
           "--probe-interval", str(PROBE_S), "--quiet"]
    say(f"router: {' '.join(cmd)}")
    with open(os.path.join(OUT_DIR, "chip_smoke_router.log"), "w") as logf:
        rproc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                 start_new_session=True)
        try:
            t0 = time.perf_counter()
            while replica_healthy(router, base) != 1.0:
                if rproc.poll() is not None:
                    fail(f"llkt-router exited with {rproc.returncode}")
                if time.perf_counter() - t0 > 30:
                    fail("llkt-router did not admit the replica within 30 s")
                time.sleep(0.1)
            out = _drive_server(base, model, num_layers, api=router)
            out["surface"] = _drive_surface(base, router, model, num_layers)
            out["contract"] = _drive_contract(base, router, model)
            out["drain"] = _drive_drain(base, router, proc, model)
            return out
        finally:
            rproc.terminate()
            try:
                rproc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                rproc.kill()
                rproc.wait(timeout=30)


def _post_ok(url: str, body: dict) -> dict:
    status, raw = http("POST", url, body)
    if status != 200:
        fail(f"POST {url} {json.dumps(body)[:200]}: HTTP {status} {raw[:300]!r}")
    return json.loads(raw)


def _streamed_text(name: str, status: int, events) -> tuple[str, str, dict]:
    """(text, finish reason, usage or None) of a streamed completion."""
    chunks = check_stream(name, status, events, 0)
    text = "".join(c["choices"][0]["text"] for c in chunks if c["choices"])
    reason = [c for c in chunks if c["choices"] and
              c["choices"][0]["finish_reason"]][0]["choices"][0]["finish_reason"]
    return text, reason, chunks[-1].get("usage")


def _drive_surface(base: str, router: str, model: str, num_layers: int) -> dict:
    """Stop strings, logprobs, logit_bias, n and echo through the router,
    /metrics linted, /ready with its filter. The launch counters are zeroed
    just before and read just after: flash prefill ran num_layers times a
    prefill call plus once a layer for the echo's scoring, and every decode
    window of these requests was a graph replay."""
    comp, chat = router + "/v1/completions", router + "/v1/chat/completions"
    prompt = SERVE_TEXT[:40]
    card = card_line()
    http("POST", base + "/debug/kernels/reset", {})
    counts0 = json.loads(http("GET", base + "/debug/kernels")[1])
    greedy = {"model": model, "prompt": prompt, "temperature": 0}

    # the reference text: greedy over the 29 biased letters
    ref = _post_ok(comp, {**greedy, "max_tokens": 32, "logit_bias": BYTE_BIAS})
    text = ref["choices"][0]["text"]
    if len(text) != 32 or ref["usage"]["completion_tokens"] != 32:
        fail(f"biased reference: {len(text)} characters {text!r}, usage {ref['usage']}")
    stop = text[10:12]
    cut = text.find(stop)
    body = {**greedy, "max_tokens": 32, "logit_bias": BYTE_BIAS, "stop": [stop]}
    ch = _post_ok(comp, body)["choices"][0]
    if ch["text"] != text[:cut] or ch["finish_reason"] != "stop":
        fail(f"stop {stop!r}: {ch['text']!r} / {ch['finish_reason']}, expected "
             f"{text[:cut]!r} / stop")
    status, events, _t0 = stream(comp, {**body, "stop": stop, "stream": True})
    s_text, s_reason, _ = _streamed_text("stop streamed", status, events)
    if s_text != text[:cut] or s_reason != "stop":
        fail(f"streamed stop {stop!r}: {s_text!r} / {s_reason}")
    say(f"  stop {stop!r}: {len(text[:cut])} of 32 characters, finish_reason stop "
        f"(streamed and not)")

    # logprobs: chat top 5, completions top 3
    d = _post_ok(chat, {"model": model, "messages": [{"role": "user", "content": prompt}],
                        "max_tokens": 8, "temperature": 0, "logprobs": True,
                        "top_logprobs": 5})
    content = d["choices"][0]["logprobs"]["content"]
    if len(content) != d["usage"]["completion_tokens"]:
        fail(f"chat logprobs: {len(content)} entries for {d['usage']} tokens")
    for e in content:
        tops = [t["logprob"] for t in e["top_logprobs"]]
        if (set(e) != {"token", "logprob", "bytes", "top_logprobs"} or e["logprob"] > 0
                or len(tops) != 5 or tops != sorted(tops, reverse=True)
                or tops[0] != e["logprob"]):
            fail(f"chat logprobs entry {e}")
    # the completions map is keyed by token text, so the letters' bias keeps
    # its three keys distinct (every id past 255 decodes to "")
    d = _post_ok(comp, {**greedy, "max_tokens": 8, "logprobs": 3, "logit_bias": BYTE_BIAS})
    lp = d["choices"][0]["logprobs"]
    n = d["usage"]["completion_tokens"]
    if (set(lp) != {"tokens", "token_logprobs", "top_logprobs", "text_offset"}
            or not len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["top_logprobs"])
            == n == 8 or any(v > 0 for v in lp["token_logprobs"])
            or any(list(t.values()) != sorted(t.values(), reverse=True) or len(t) != 3
                   or max(t.values()) != v for t, v in zip(lp["top_logprobs"],
                                                          lp["token_logprobs"]))):
        fail(f"completion logprobs: {lp}")
    say(f"  logprobs: chat {len(content)} entries of top 5, completions {n} of top 3; "
        f"every chosen logprob <= 0 and the top of its sorted list")

    # logit_bias: +100 forces, -100 bans the reference's most common letter
    forced = _post_ok(comp, {**greedy, "max_tokens": 16, "logit_bias": {"81": 100}})
    if forced["choices"][0]["text"] != "Q" * 16:
        fail(f"logit_bias {{Q: 100}}: {forced['choices'][0]['text']!r}")
    common = max(set(text), key=text.count)
    ban = {**BYTE_BIAS, str(ord(common)): -100}
    banned = _post_ok(comp, {**greedy, "max_tokens": 32, "logit_bias": ban})
    b_text = banned["choices"][0]["text"]
    if common in b_text or len(b_text) != 32:
        fail(f"logit_bias {{{common!r}: -100}}: {b_text!r}")
    say(f"  logit_bias: +100 on 'Q' gave 16 x 'Q'; -100 on {common!r} (x{text.count(common)} "
        f"in the reference) never sampled")

    # n = 4 with a seed, twice
    body = {**greedy, "max_tokens": 16, "temperature": 0.8, "seed": 99, "n": 4,
            "logit_bias": BYTE_BIAS}
    a, b = _post_ok(comp, body), _post_ok(comp, body)
    texts = [c["text"] for c in a["choices"]]
    if ([c["index"] for c in a["choices"]] != [0, 1, 2, 3]
            or texts != [c["text"] for c in b["choices"]]
            or a["usage"]["completion_tokens"] != 64 or len(set(texts)) < 2):
        fail(f"n 4: {a['choices']} / {b['choices']}")
    say(f"  n 4 (seed 99, t 0.8): four choices, {len(set(texts))} distinct, the same on a "
        f"repeat")

    # echo with logprobs: the 900-token prompt scored on the engine thread
    t0 = time.perf_counter()
    e = _post_ok(comp, {"model": model, "prompt": PROMPT_900, "max_tokens": 1,
                        "temperature": 0, "echo": True, "logprobs": 1})
    echo_ms = 1e3 * (time.perf_counter() - t0)
    ch = e["choices"][0]
    elp = ch["logprobs"]["token_logprobs"]
    if (not ch["text"].startswith(PROMPT_900) or len(elp) != len(PROMPT_900) + 1
            or elp[0] is not None
            or any(v is None or v > 0 for v in elp[1:])):
        fail(f"echo: {len(elp)} entries, first {elp[:3]}")
    say(f"echo + logprobs (900-token prompt, max_tokens 1) wall ms: {echo_ms:.1f} [{card}]")

    counts = json.loads(http("GET", base + "/debug/kernels")[1])
    launches = counts["launches"]
    prefills = counts["prefill_calls"] - counts0["prefill_calls"]
    if launches.get("flash_prefill", 0) != num_layers * (prefills + 1):
        fail(f"flash_prefill launched {launches.get('flash_prefill', 0)} times: expected "
             f"num_layers x ({prefills} prefill calls + 1 scoring)")
    say(f"  request surface: flash_prefill launched {launches['flash_prefill']} times = "
        f"{num_layers} layers x ({prefills} prefill calls + 1 scoring forward)")
    check_graphed("request surface", counts, counts0)

    # /metrics, linted as a scrape; /ready with its prefix filter
    status, raw = http("GET", base + "/metrics")
    path = os.path.join(OUT_DIR, "metrics_llama.txt")
    with open(path, "wb") as f:
        f.write(raw)
    lint = subprocess.run([sys.executable, os.path.join("scripts", "metrics_lint.py"), path],
                          capture_output=True, text=True, timeout=60)
    if status != 200 or lint.returncode != 0:
        fail(f"/metrics: HTTP {status}; metrics_lint: {lint.stdout[-2000:]}")
    text_m = raw.decode()
    for series in ("llm_requests_total", "llm_ttft_seconds_bucket", "llm_queue_depth",
                   "llm_kv_pages_used", "llm_engine_state 1", "llm_decode_step_seconds_count"):
        if series not in text_m:
            fail(f"/metrics lacks {series}")
    status, raw = http("GET", base + "/ready")
    doc = json.loads(raw) if status == 200 else {}
    pf = doc.get("prefix_filter") or {}
    if status != 200 or doc.get("state") != "serving" or pf.get("bits") != 8192 \
            or not pf.get("count"):
        fail(f"/ready: HTTP {status} {raw[:300]!r}")
    say(f"  /metrics: {len(text_m.splitlines())} lines, {lint.stdout.strip()}; /ready: "
        f"serving, prefix filter of {pf['count']} digests")
    # entries 1..899 score the prompt; the last is the generated token's
    return {"launches": launches, "echo_ms": echo_ms,
            "echo_logprobs": elp[1:len(PROMPT_900)]}


def _drive_drain(base: str, router: str, proc, model: str) -> dict:
    """SIGTERM the server while a stream runs through the router: /ready
    answers 503 at once, the router's llm_replica_healthy turns 0 within two
    probe periods, the stream ends whole and the server exits 0."""
    n = 256
    req = urllib.request.Request(
        router + "/v1/completions", method="POST", headers={"Content-Type": "application/json"},
        data=json.dumps({"model": model, "prompt": SERVE_TEXT[:40], "max_tokens": n,
                         "temperature": 0, "stream": True, "logit_bias": BYTE_BIAS,
                         "stream_options": {"include_usage": True}}).encode())
    resp = urllib.request.urlopen(req, timeout=600)
    first = resp.readline()
    if not first.startswith(b"data: "):
        fail(f"drain stream: first line {first[:200]!r}")
    proc.send_signal(signal.SIGTERM)
    t0 = time.perf_counter()
    status, raw = http("GET", base + "/ready", timeout=10)
    if status != 503 or json.loads(raw).get("state") != "draining":
        fail(f"/ready while draining: HTTP {status} {raw[:200]!r}")
    status, raw = http("POST", base + "/v1/completions", {"model": model, "prompt": "x"})
    if status != 503:
        fail(f"a new request while draining: HTTP {status} {raw[:200]!r}")
    while replica_healthy(router, base) != 0.0:
        if time.perf_counter() - t0 > 2 * PROBE_S:
            fail(f"the router still routes to the draining replica after 2 probe periods")
        time.sleep(0.02)
    eject_s = time.perf_counter() - t0
    events, t_read = [], time.perf_counter()
    for raw_line in [first] + list(resp):
        line = raw_line.decode().strip()
        if line.startswith("data: "):
            events.append((t_read, line[6:]))
    text, reason, usage = _streamed_text("drain stream", 200, events)
    if reason != "length" or (usage or {}).get("completion_tokens") != n or len(text) != n:
        fail(f"the stream in flight at SIGTERM ended with {reason}, {usage}, "
             f"{len(text)} characters")
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        fail("the drained server did not exit within 120 s")
    exit_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"the drained server exited with {rc}")
    card = card_line()
    say(f"drain: SIGTERM -> /ready 503 at once; router ejection s: {eject_s:.3f} (probe "
        f"{PROBE_S} s); the stream in flight ended whole ({n} tokens); exit 0 after "
        f"{exit_s:.2f} s [{card}]")
    return {"eject_s": eject_s, "exit_s": exit_s}


# ---------------------------------------------------------------------------
# phase 3, the rest of the replica contract: deadlines, request ids and
# traces, embeddings, the body cap; a short-lived server with admission held
# (the queue shed, the 429's Retry-After, the keepalive); the stream journal
# behind llkt-router with a replica killed mid-stream
# ---------------------------------------------------------------------------

DEADLINE_MS = 400


def _drive_contract(base: str, router: str, model: str) -> dict:
    """Through the router: a stream with ``X-LLMK-Deadline-Ms: 400`` and
    max_tokens 4,096 ends "timeout" (the ms from the deadline to its final
    chunk printed), the pool's pages come back to idle, every window of it
    was a graph replay (counters zeroed just before, read just after), the
    decode-phase deadline counter reads one more, the request id comes back
    through the router and /debug/traces holds the request with its queue,
    prefill and decode spans. Directly: /v1/embeddings answers 501 and a
    body declared over 32 MiB 413."""
    card = card_line()
    t_phase = time.perf_counter()
    http("POST", base + "/debug/kernels/reset", {})
    counts0 = kernel_counts(base)
    dec0 = metric(base, "llm_deadline_exceeded_total", 'phase="decode"')
    rid = "chip-smoke-deadline-1"
    status, headers, lines, t0 = stream_lines(
        router + "/v1/completions",
        {"model": model, "prompt": SERVE_TEXT[:40], "max_tokens": 4096, "temperature": 0,
         "stream": True, "logit_bias": BYTE_BIAS},
        {"X-LLMK-Deadline-Ms": str(DEADLINE_MS), "X-LLMK-Request-Id": rid})
    text, reason, t_final = sse_finish("deadline stream", status, lines)
    after_ms = 1e3 * (t_final - t0) - DEADLINE_MS
    if reason != "timeout" or not text:
        fail(f"the {DEADLINE_MS} ms deadline stream ended {reason!r} after {len(text)} "
             f"characters, expected timeout mid-decode")
    if headers.get("X-LLMK-Request-Id") != rid:
        fail(f"the router answered request id {headers.get('X-LLMK-Request-Id')!r}, sent {rid}")
    t1 = time.perf_counter()
    while True:
        k = kernel_counts(base)
        if k["free_pages"] + k["evictable_pages"] == k["num_pages"] - 1:
            break
        if time.perf_counter() - t1 > 10:
            fail(f"pages after the deadline abort: {k['free_pages']} free + "
                 f"{k['evictable_pages']} evictable of {k['num_pages'] - 1}")
        time.sleep(0.05)
    idle_s = time.perf_counter() - t1
    counts = kernel_counts(base)
    check_graphed("deadline abort", counts, counts0)
    metric_reaches(base, "llm_deadline_exceeded_total", 'phase="decode"', dec0 + 1)
    say(f"deadline mid-stream ({DEADLINE_MS} ms, max_tokens 4096, through llkt-router): "
        f"finish_reason timeout after {len(text)} characters; deadline to final chunk ms: "
        f"{after_ms:.1f}; pages back to idle {idle_s:.3f} s later; "
        f"llm_deadline_exceeded_total{{phase=\"decode\"}} +1 [{card}]")
    status, raw = http("GET", base + f"/debug/traces?id={rid}")
    traces = json.loads(raw)["traces"] if status == 200 else []
    if len(traces) != 1:
        fail(f"/debug/traces?id={rid}: HTTP {status}, {len(traces)} traces")
    tr = traces[0]
    spans = {sp["name"]: sp for sp in tr["spans"]}
    if not {"queue", "prefill", "decode"} <= set(spans) or tr["status"] != "ok" \
            or len(tr["trace_id"]) != 32 or len(tr["parent_span_id"]) != 16:
        fail(f"the trace of {rid}: {json.dumps(tr)[:600]}")
    say(f"  request id {rid} echoed through the router; /debug/traces: trace "
        f"{tr['trace_id']} under the router's span {tr['parent_span_id']}, spans "
        + ", ".join(f"{n} {spans[n]['duration_ms']:.1f} ms" for n in ("queue", "prefill",
                                                                       "decode"))
        + f", events {[e['name'] + ':' + str(e.get('reason')) for e in tr['events']]}")
    status, raw = http("POST", base + "/v1/embeddings", {"input": "x", "model": model})
    if status != 501 or json.loads(raw)["error"]["type"] != "not_implemented":
        fail(f"/v1/embeddings: HTTP {status} {raw[:200]!r}")
    with socket.create_connection(("127.0.0.1", int(base.rsplit(":", 1)[1])), timeout=30) as so:
        so.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                   b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % (64 << 20))
        head = so.recv(4096).decode(errors="replace")
    if " 413 " not in head.split("\r\n", 1)[0]:
        fail(f"a body declared at 64 MiB: {head[:200]!r}")
    say(f"  /v1/embeddings 501; a body declared at 64 MiB 413 before any of it was read; "
        f"contract checks {time.perf_counter() - t_phase:.1f} s")
    return {"launches": counts["launches"], "deadline_after_ms": after_ms}


def _drive_queue_server(base: str, _proc) -> dict:
    """Admission held (``LLMK_FAULT=queue_stall``), max_waiting 1,
    ``LLMK_SSE_KEEPALIVE_S=0.2``: a waiting stream gets ``: ping`` before
    any data and is shed at its 1,500 ms deadline with finish_reason
    "timeout"; meanwhile a second request gets 429 with Retry-After in
    [1, 60]; then a completion with a 500 ms deadline gets 504; the
    queue-phase deadline counter reads 2."""
    t_phase = time.perf_counter()
    q0 = metric(base, "llm_deadline_exceeded_total", 'phase="queue"')
    req = urllib.request.Request(
        base + "/v1/completions", method="POST",
        data=json.dumps({"prompt": "held", "max_tokens": 8, "stream": True}).encode(),
        headers={"Content-Type": "application/json", "X-LLMK-Deadline-Ms": "1500"})
    t0 = time.perf_counter()
    resp = urllib.request.urlopen(req, timeout=60)
    first = ""
    while not first:
        first = resp.readline().decode().strip()
    ping_s = time.perf_counter() - t0
    if first != ": ping":
        fail(f"the held stream's first line is {first[:200]!r}, expected ': ping'")
    status, headers, raw = http_full("POST", base + "/v1/completions",
                                     {"prompt": "full", "max_tokens": 4})
    retry = headers.get("Retry-After") if headers is not None else None
    if status != 429 or not retry or not 1 <= int(retry) <= 60:
        fail(f"a request past max_waiting: HTTP {status}, Retry-After {retry!r}")
    rest = [(time.perf_counter(), ln) for ln in resp.read().decode().splitlines() if ln.strip()]
    text, reason, t_final = sse_finish("held stream", 200, [(ping_s, first)] + rest)
    if reason != "timeout" or text:
        fail(f"the held stream ended {reason!r} with {text!r}, expected a queue shed")
    t1 = time.perf_counter()
    status, raw = http("POST", base + "/v1/completions", {"prompt": "shed", "max_tokens": 4},
                       headers={"X-LLMK-Deadline-Ms": "500"})
    shed_s = time.perf_counter() - t1
    if status != 504 or json.loads(raw)["error"]["code"] != "deadline_exceeded":
        fail(f"a held completion with a 500 ms deadline: HTTP {status} {raw[:200]!r}")
    metric_reaches(base, "llm_deadline_exceeded_total", 'phase="queue"', q0 + 2)
    say(f"queue server (debug-tiny, admission held): first ': ping' after {ping_s:.3f} s at a "
        f"0.2 s keepalive; a request past max_waiting 429 with Retry-After {retry}; the held "
        f"stream shed 'timeout' at its 1,500 ms deadline; a held completion 504 after "
        f"{shed_s:.3f} s (500 ms deadline); llm_deadline_exceeded_total{{phase=\"queue\"}} +2; "
        f"{time.perf_counter() - t_phase:.1f} s [{card_line()}]")
    return {"ping_s": ping_s, "shed_s": shed_s}


DRILL_ARGS = ["--model", "debug-tiny", "--random-weights", "--dtype", "float32"]
DRILL_KILL_AT = 8
DRILL_BODY = {"model": "debug-tiny", "prompt": "Resume me, router.", "max_tokens": 32,
              "temperature": 0, "stream": True}


def _stream_text(lines) -> str:
    return "".join(json.loads(ln[6:])["choices"][0]["text"] for _, ln in lines
                   if ln.startswith("data: ") and ln != "data: [DONE]"
                   and json.loads(ln[6:])["choices"])


def phase_queue_server() -> dict:
    """A short-lived debug-tiny server in this process (float32,
    max_waiting 1) under ``LLMK_FAULT=queue_stall`` and
    ``LLMK_SSE_KEEPALIVE_S=0.2`` (``_drive_queue_server``)."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

    os.environ.update(LLMK_FAULT="queue_stall", LLMK_SSE_KEEPALIVE_S="0.2")
    srv = None
    try:
        srv = OpenAIServer(Engine(EngineConfig(model="debug-tiny", dtype="float32",
                                               max_waiting=1, device="cuda")),
                           ByteTokenizer(), "debug-tiny")
        return _drive_queue_server(f"http://127.0.0.1:{srv.start()}", None)
    finally:
        for key in ("LLMK_FAULT", "LLMK_SSE_KEEPALIVE_S"):
            os.environ.pop(key, None)
        if srv is not None:
            srv.close()


def phase_contract_servers() -> dict:
    """The queue server (``phase_queue_server``, in this process) while two
    debug-tiny replicas (float32, the same seeded weights) start for
    ``llkt-router``, one with ``LLMK_FAULT=kill_mid_stream:8``. Streams go
    through the router until the victim has been killed once: each equals
    the healthy replica's uninterrupted stream, with no error event, and
    the router counts one resume. The replicas' launch counters are zeroed
    just before and read just after."""
    t_phase = time.perf_counter()
    healthy = Server(DRILL_ARGS, "chip_smoke_drill_healthy.log")
    victim = Server(DRILL_ARGS, "chip_smoke_drill_victim.log",
                    {"LLMK_FAULT": f"kill_mid_stream:{DRILL_KILL_AT}"})
    rproc = None
    try:
        out = {"queue": phase_queue_server()}
        for srv in (healthy, victim):
            srv.wait_health()
        port = free_port()
        router = f"http://127.0.0.1:{port}"
        rlog = open(os.path.join(OUT_DIR, "chip_smoke_drill_router.log"), "w")
        rproc = subprocess.Popen([ROUTER_BIN, "--models",
                                  f"debug-tiny={healthy.base}|{victim.base}", "--port", str(port),
                                  "--probe-interval", str(PROBE_S), "--breaker-threshold", "100",
                                  "--quiet"], stdout=rlog, stderr=subprocess.STDOUT,
                                 start_new_session=True)
        t0 = time.perf_counter()
        while (replica_healthy(router, healthy.base) != 1.0
               or replica_healthy(router, victim.base) != 1.0):
            if rproc.poll() is not None or time.perf_counter() - t0 > 30:
                fail("llkt-router did not admit both drill replicas within 30 s")
            time.sleep(0.1)
        for srv in (healthy, victim):
            http("POST", srv.base + "/debug/kernels/reset", {})
        status, _h, ref_lines, _t = stream_lines(healthy.base + "/v1/completions", DRILL_BODY)
        ref_text, ref_reason, _ = sse_finish("drill reference", status, ref_lines)
        resumes, streams = 0.0, 0
        while resumes < 1.0:
            if streams == 24:
                fail("24 streams through the router and none reached the killed replica")
            status, _h, lines, _t = stream_lines(router + "/v1/completions", DRILL_BODY)
            text, reason, _ = sse_finish("drill stream", status, lines)
            streams += 1
            if (text, reason) != (ref_text, ref_reason) or any(
                    "error" in ln or "llmk-tok" in ln for _, ln in lines):
                fail(f"drill stream {streams}: {text!r} / {reason}, expected {ref_text!r} / "
                     f"{ref_reason}, or an error event came through")
            resumes = metric(router, "llm_stream_resume_total", 'outcome="ok"')
        gave_up = metric(router, "llm_stream_resume_total", 'outcome="gave_up"')
        if resumes != 1.0 or gave_up:
            fail(f"router resumes ok {resumes}, gave up {gave_up}")
        launches: dict = {}
        for srv in (healthy, victim):
            for k, n in kernel_counts(srv.base)["launches"].items():
                launches[k] = launches.get(k, 0) + n
        say(f"resume drill: {streams} streams through llkt-router, the victim replica reset "
            f"one at {DRILL_KILL_AT} tokens; every client stream equal to the uninterrupted "
            f"one ({len(ref_text)} characters, {ref_reason}), no error event; router resume "
            f"count {resumes:g}; {time.perf_counter() - t_phase:.1f} s [{card_line()}]")
        out["drill"] = {"launches": launches, "resumes": resumes, "streams": streams}
        return out
    except SystemExit:
        for srv in (healthy, victim):
            say(f"{srv.log_path} (tail):\n{srv.tail()}")
        raise
    finally:
        if rproc is not None:
            rproc.terminate()
            try:
                rproc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                rproc.kill()
                rproc.wait(timeout=30)
        for srv in (healthy, victim):
            if srv.proc.poll() is None:
                srv.stop()


def check_echo_reference(torch, params, echo_logprobs) -> None:
    """The server's echo prompt logprobs (forward_score, flash prefill)
    against a plain forward_score (plain prefill attention) on the same
    weights on the card: |diff| <= BF16_REL_TOL x the largest |logprob|
    (the bf16 row tolerance, the whole prompt one row)."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
    from llms_on_kubernetes_tpu_torch.models import decoder
    from llms_on_kubernetes_tpu_torch.ops.flash_attention import prefill_attention_plain

    ids = ByteTokenizer().encode(PROMPT_900)
    tokens = torch.zeros((1, 1024), dtype=torch.int32)
    tokens[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    real = decoder.dispatch_prefill_attention
    # the plain version takes the groups alone; their spans are the kernel's
    decoder.dispatch_prefill_attention = (
        lambda *a, group_spans=None, **kw: prefill_attention_plain(*a, **kw))
    try:
        nxt, _ids, _lps = decoder.forward_score(
            params, get_config(MODEL), tokens.cuda(),
            torch.tensor([len(ids)], dtype=torch.int32, device="cuda"), top_k=8)
    finally:
        decoder.dispatch_prefill_attention = real
    ref = nxt[0, :len(ids) - 1].float().cpu().numpy()
    got = np.asarray(echo_logprobs, np.float32)
    err = float(np.abs(got - ref).max())
    tol = BF16_REL_TOL * float(np.abs(ref).max())
    say(f"echo logprobs against a plain forward_score: max |diff| {err:.4f}, mean "
        f"{float(np.abs(got - ref).mean()):.4f} (tolerance {tol:.4f}) over {len(ref)} tokens")
    if err > tol:
        fail(f"echo logprobs differ from the plain forward_score by {err} > {tol}")


# ---------------------------------------------------------------------------
# the stall watchdog on the card
# ---------------------------------------------------------------------------

def phase_watchdog(torch) -> dict:
    """A small engine on the card (debug-tiny, float32) with a 0.5 s
    watchdog and a step estimate of 1 ms, behind a ``torch.cuda._sleep``
    spin of ~3 s on its stream: every request must finish "stalled" well
    before the spin ends, the engine must be wedged and refuse, and the
    process goes on once the spin is over."""
    from llms_on_kubernetes_tpu_torch.engine.engine import (
        Engine, EngineConfig, EngineStallError, SamplingParams,
    )

    if not hasattr(torch.cuda, "_sleep"):
        fail(f"torch.cuda._sleep is missing from torch {torch.__version__}: the watchdog "
             f"check has no way to stall the card")
    # cycles a millisecond, from a timed 50 M-cycle spin
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(50_000_000)
    e.record()
    torch.cuda.synchronize()
    per_ms = 50_000_000 / s.elapsed_time(e)
    eng = Engine(EngineConfig(model="debug-tiny", dtype="float32", device="cuda",
                              watchdog_stall_s=0.5))
    eng._est_step = 1e-3
    budget = eng._stall_budget()
    reqs = [eng.submit(p, SamplingParams(max_tokens=32, temperature=0.0))
            for p in ([1, 2, 3], [4, 5, 6, 7] * 5, list(range(10, 90)))]
    spin_ms = 3000.0
    done = torch.cuda.Event()
    t0 = time.perf_counter()
    torch.cuda._sleep(int(spin_ms * per_ms))
    done.record()
    while not all(r.finished for r in reqs):
        if time.perf_counter() - t0 > 60:
            fail("watchdog: the requests did not finish within 60 s")
        eng.step()
    shed_s = time.perf_counter() - t0
    reasons = [r.finish_reason for r in reqs]
    if reasons != ["stalled"] * 3 or not eng.wedged:
        fail(f"watchdog: reasons {reasons}, wedged {eng.wedged}")
    if done.query():
        fail(f"watchdog: the spin ended before the shed ({shed_s:.2f} s): nothing stalled")
    try:
        eng.submit([1, 2], SamplingParams(max_tokens=2))
        fail("watchdog: a wedged engine took a submission")
    except EngineStallError:
        pass
    torch.cuda.synchronize()
    over_s = time.perf_counter() - t0
    del eng
    say(f"watchdog: 3 requests finished 'stalled' {shed_s:.2f} s into a {spin_ms / 1e3:.1f} s "
        f"spin (budget {budget:.2f} s); wedged, submit refused; the spin ended at "
        f"{over_s:.2f} s and the process goes on [{card_line()}]")
    # the second stall: LLMK_FAULT=engine_stall, a harvester read that never
    # completes (the hook re-reads the environment every second)
    os.environ["LLMK_FAULT"] = "engine_stall"
    try:
        eng = Engine(EngineConfig(model="debug-tiny", dtype="float32", device="cuda",
                                  watchdog_stall_s=0.5))
        eng._est_step = 1e-3
        reqs = [eng.submit(p, SamplingParams(max_tokens=32, temperature=0.0))
                for p in ([1, 2, 3], [4, 5, 6, 7] * 5)]
        t0 = time.perf_counter()
        while not all(r.finished for r in reqs):
            if time.perf_counter() - t0 > 60:
                fail("engine_stall: the requests did not finish within 60 s")
            eng.step()
        fault_shed_s = time.perf_counter() - t0
    finally:
        del os.environ["LLMK_FAULT"]
    if [r.finish_reason for r in reqs] != ["stalled"] * 2 or not eng.wedged:
        fail(f"engine_stall: reasons {[r.finish_reason for r in reqs]}, wedged {eng.wedged}")
    eng._harvester.close()
    del eng
    say(f"watchdog, LLMK_FAULT=engine_stall: 2 requests finished 'stalled' "
        f"{fault_shed_s:.2f} s after submission (budget 0.50 s); wedged [{card_line()}]")
    return {"shed_s": shed_s, "budget_s": budget, "fault_shed_s": fault_shed_s}


# ---------------------------------------------------------------------------
# phase 4: kv_write="fused" in process
# ---------------------------------------------------------------------------

def window_vs_eager(torch, eng, tag: str, prompts, grammars=()) -> None:
    """One decode window replayed (the engine's CUDA graph) and one run
    eagerly (``DecodeWindow._eager``, the same function), from copies of
    one pool and one penalty-count table, on seeded sampled rows with
    penalties: sampled tokens identical, pools (outside each layer's trash
    page 0, which idle rows write) and counts byte-equal, and the packed
    results (logprobs and top alternatives included) identical. With
    ``grammars`` every other row is constrained by the next of them, the
    replay is the FSM graph's and the eager window runs the FSM on a copy
    of the slots' FSM state, which must equal the replay's after. The
    rows' requests are aborted after."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from llms_on_kubernetes_tpu_torch.ops.paged_attention import DecodeWorkspace

    sp = dict(max_tokens=64, temperature=0.7, seed=5, presence_penalty=0.4,
              frequency_penalty=0.3)
    reqs = [eng.submit(p, SamplingParams(**sp, grammar=grammars[(i // 2) % len(grammars)]
                                         if grammars and i % 2 == 0 else None))
            for i, p in enumerate(prompts)]
    eng._admit()                   # sync admission: first tokens read
    K = eng.config.decode_steps
    active = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    if grammars and sum(r.fsm_row >= 0 for _i, r in active) != (len(prompts) + 1) // 2:
        fail(f"{tag}: the constrained rows were not admitted with their grammars")
    base = {i: int(eng.slot_len[i]) + 1 for i, _r in active}
    for i, _r in active:
        eng.allocator.allocate(i, base[i] + K - 1)
    packed = eng._window_rows(active, {i: K for i, _r in active}, base)
    pools = [KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
             for p in (eng.k_pages, eng.v_pages)]
    counts = eng.token_counts.clone()
    fsm = (eng._fsm_state.clone(), *eng._g_dev) if grammars else None
    zeros = torch.zeros(eng.config.max_decode_slots, dtype=torch.int32, device="cuda")
    eager_pack, eager_toks = eng._window._eager(
        torch.from_numpy(packed).cuda(), zeros, zeros[:1], *pools, counts,
        workspace=DecodeWorkspace(), fsm=fsm)
    replays = eng._window.fsm_replays
    pack, toks = eng._window.run(packed, None, None, use_fsm=bool(grammars))
    torch.cuda.synchronize()
    if eng._window.fsm_replays - replays != int(bool(grammars)):
        fail(f"{tag}: the window did not replay the graph it was asked for")
    if not (torch.equal(pack[:, 0], eager_pack[:, 0]) and torch.equal(toks, eager_toks)):
        fail(f"{tag}: sampled tokens differ between the graph replay and the eager window")
    if not torch.equal(eng.token_counts, counts):
        fail(f"{tag}: penalty counts differ between the graph replay and the eager window")
    if grammars and not torch.equal(eng._fsm_state, fsm[0]):
        fail(f"{tag}: FSM states differ between the graph replay and the eager window: "
             f"{eng._fsm_state.tolist()} against {fsm[0].tolist()}")
    P = eng.config.num_pages
    keep = torch.ones(eng.model_config.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False
    for got, want in zip((eng.k_pages, eng.v_pages), pools):
        if not torch.equal(got.data[:, keep], want.data[:, keep]) or (
                want.scale is not None
                and not torch.equal(got.scale[:, keep], want.scale[:, keep])):
            fail(f"{tag}: pools differ between the graph replay and the eager window")
    if not torch.equal(pack, eager_pack):
        fail(f"{tag}: logprobs or top alternatives differ between the graph replay and the "
             f"eager window")
    rows = f"{len(prompts)} sampled rows with penalties"
    if grammars:
        rows += f", {(len(prompts) + 1) // 2} of them constrained"
    say(f"  {tag}: one window ({K} steps, {rows}) replayed equals the eager window: tokens, "
        f"logprobs, pools and counts{', FSM states' if grammars else ''} byte-equal")
    for r in reqs:
        eng.abort(r)
    while eng.has_work():
        eng.step()


def run_engine(eng, prompts, sp, logprobs: bool = False):
    """Every prompt through ``eng`` at once, stepped until it drains;
    returns (output, finish reason) per prompt (and, with ``logprobs``,
    each output's logprob entries beside that list)."""
    reqs = [eng.submit(p, sp) for p in prompts]
    while eng.has_work():
        eng.step()
    out = [(r.output, r.finish_reason) for r in reqs]
    return (out, [r.output_logprobs for r in reqs]) if logprobs else out


def phase_fused(torch, model: str, params, kv_cache_dtype=None) -> dict:
    """The default engine (async, graphed windows) in process on
    ``params``, with the KV pool in bf16 (kv_cache_dtype None) or int8:
    kv_write "fused" against "dus", graph against eager (both), async
    against sync, one decode step fused against dus from copies of one
    pool, and preemption. Each engine is freed before the next starts."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_decode

    cfg = get_config(model)
    int8 = kv_cache_dtype == "int8"
    write_kernel = "paged_decode_write_int8" if int8 else "paged_decode_write"
    tag = f"fused ({kv_cache_dtype or 'bf16'} KV)"
    kw = dict(model=model, kv_cache_dtype=kv_cache_dtype, device="cuda")
    fused = Engine(EngineConfig(kv_write="fused", **kw), params=params)
    prompts = [[1 + i % 200 for i in range(40)], [7 + i % 200 for i in range(200)], [5] * 900]
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    kernels.reset_launches()
    streams = run_engine(fused, prompts, sp)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    replayed = kernels.replayed_counts()
    say(f"{tag}: engine launches: {launches}, of them by graph replays {replayed}; decode "
        f"forwards {fused.decode_forwards}, graph replays {fused.graph_replays}")
    if replayed.get(write_kernel, 0) != launches.get(write_kernel, 0):
        fail(f"{tag}: {write_kernel} launched {launches.get(write_kernel, 0)} times, "
             f"{replayed.get(write_kernel, 0)} of them by graph replays: some ran eagerly")
    if launches.get(write_kernel, 0) != cfg.num_layers * fused.decode_forwards:
        fail(f"{write_kernel} launched {launches.get(write_kernel, 0)} times, expected "
             f"num_layers x decode steps = {cfg.num_layers * fused.decode_forwards}")
    if not fused.graph_replays or (fused.graph_replays * fused.config.decode_steps
                                   != fused.decode_forwards):
        fail(f"{tag}: {fused.graph_replays} graph replays for {fused.decode_forwards} "
             f"decode forwards")
    for other in ("paged_decode", "paged_decode_write", "paged_decode_int8",
                  "paged_decode_write_int8"):
        if other != write_kernel and launches.get(other, 0):
            fail(f"the {tag} engine launched {other}")
    if any(reason not in ("length", "stop") for _out, reason in streams):
        fail(f"{tag} engine finish reasons {streams}")
    window_vs_eager(torch, fused, f"{tag}, graph vs eager", prompts)
    del fused
    torch.cuda.empty_cache()

    dus = Engine(EngineConfig(kv_write="dus", **kw), params=params)
    ref = run_engine(dus, prompts, sp)
    if streams != ref:
        fail(f"{tag}: greedy streams differ between kv_write fused and dus: {streams} vs {ref}")
    say(f"  {tag}: greedy streams equal under kv_write fused and dus")
    window_vs_eager(torch, dus, f"dus ({kv_cache_dtype or 'bf16'} KV), graph vs eager",
                    prompts)

    # one decode step both ways from copies of one pool: prefill three
    # prompts, then decode their first tokens
    B = dus.config.max_decode_slots
    rows = [dus.submit(p, SamplingParams(max_tokens=2, temperature=0.0)) for p in prompts]
    dus._admit()
    tokens = torch.zeros(B, dtype=torch.int32, device="cuda")
    lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
    for r in rows:
        tokens[r.slot] = r.pending_token
        lengths[r.slot] = len(r.prompt) + 1
    table = torch.from_numpy(dus.allocator.page_tables).cuda()
    pools, logits = {}, {}
    for mode in ("dus", "fused"):
        kp, vp = (KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
                  for p in (dus.k_pages, dus.v_pages))
        logits[mode], _, _ = forward_decode(params, cfg, tokens, lengths, kp, vp, table,
                                            kv_write=mode)
        pools[mode] = [t for p in (kp, vp) for t in (p.data, p.scale) if t is not None]
    check_close(f"{tag}: one decode step, logits fused vs dus", logits["fused"],
                logits["dus"], "bfloat16", rows=lengths > 0)
    if int8 and not torch.equal(logits["fused"], logits["dus"]):
        fail(f"{tag}: logits of one decode step differ between fused and dus")
    P = dus.config.num_pages
    keep = torch.ones(cfg.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False          # each layer's trash page; dus writes idle rows there
    for a, b in zip(pools["dus"], pools["fused"]):
        if not torch.equal(a[:, keep], b[:, keep]):
            fail(f"{tag}: pools differ between kv_write dus and fused after one decode step")
    say(f"  {tag}: pools byte-equal outside the trash pages"
        + (" (int8 data and scales); logits identical" if int8 else ""))
    for r in rows:
        dus.abort(r)
    dus.step()
    del pools

    # the preemption check's reference: 8 distinct 900-token prompts in a
    # pool with room for all of them
    long_prompts = [[1 + (7 * i + 13 * j + j // 64) % 250 for j in range(900)] for i in range(8)]
    sp64 = SamplingParams(max_tokens=64, temperature=0.0)
    roomy, roomy_lps = run_engine(dus, long_prompts, sp64, logprobs=True)
    # and of the preemption right after the first token: four 63-token
    # prompts (prompt + 1 fills a page)
    short_prompts = [[3 + (11 * i + j) % 250 for j in range(63)] for i in range(4)]
    sp32 = SamplingParams(max_tokens=32, temperature=0.0)
    short_roomy = run_engine(dus, short_prompts, sp32)
    del dus
    torch.cuda.empty_cache()

    sync = Engine(EngineConfig(kv_write="dus", async_scheduling=False, **kw), params=params)
    if run_engine(sync, prompts, sp) != ref:
        fail(f"{tag}: greedy streams differ between the async (depth 2) and sync engines")
    say(f"  {tag}: greedy streams equal async (depth {EngineConfig().async_depth}) and sync")
    del sync
    torch.cuda.empty_cache()

    # preemption at full width: 8 slots of 900-token prompts, max_tokens 64,
    # in 122 usable pages of 64 rows: admission takes 15 pages each (120),
    # growth needs 16 each (128)
    tight = Engine(EngineConfig(kv_write="dus", num_pages=123, **kw), params=params)
    got = run_engine(tight, long_prompts, sp64)
    say(f"  {tag}: 8 x 900-token prompts, 64 tokens each, in 122 pages: "
        f"{tight.preemptions} preemptions, {tight.graph_replays} graph replays")
    if tight.preemptions < 1:
        fail(f"{tag}: the tight pool preempted nothing")
    if got != roomy:
        fail(f"{tag}: greedy streams changed under preemption")
    say(f"  {tag}: every stream under preemption equals the roomy engine's")
    del tight
    torch.cuda.empty_cache()

    # preemption right after the first token: the four 63-token prompts in
    # 4 usable pages; admission takes all four, the first window's growth
    # needs 8, so the youngest rows are preempted holding one output token
    # and resume with their prompt alone to re-prefill
    first = Engine(EngineConfig(kv_write="dus", num_pages=5, **kw), params=params)
    outputs_at = preempted_output_lengths(first)
    got = run_engine(first, short_prompts, sp32)
    say(f"  {tag}: four 63-token prompts in 4 pages: {first.preemptions} preemptions, the "
        f"victims holding {outputs_at} output tokens")
    if 1 not in outputs_at:
        fail(f"{tag}: no request was preempted holding exactly its first token")
    if got != short_roomy:
        fail(f"{tag}: greedy streams changed under preemption after the first token")
    say(f"  {tag}: every stream equals the roomy engine's")
    del first._preempt_youngest     # the recorder holds the engine: free it now
    del first
    torch.cuda.empty_cache()
    return {"launches": launches, "roomy": (roomy, roomy_lps)}


def preempted_output_lengths(eng) -> list:
    """Record, in the list returned, how many output tokens each request
    that ``eng`` preempts holds at that moment."""
    seen: list = []
    preempt = eng._preempt_youngest

    def recording():
        victim = max((r for r in eng.slots if r is not None), key=lambda r: r.submitted_at)
        seen.append(len(victim.output))
        preempt()

    eng._preempt_youngest = recording
    return seen


def phase_chunk_vs_one_shot(torch, model: str, params) -> None:
    """Printed, not held: a 1,500-token prompt's first-token logits through
    the chunk path (bucket 1,024: two forward_chunk calls, the window
    kernels and the plain chunk attention) against one-shot prefill (bucket
    2,048: flash prefill). The two round differently, so this reports how
    far apart they land and whether the top-1 token agrees."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_chunk, forward_prefill

    cfg = get_config(model)
    n = 1500
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=n).astype(np.int32)
    cc = CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_pages=33,
                     page_size=64, pages_per_slot=32, dtype="bfloat16")
    table = torch.arange(1, 33, dtype=torch.int32, device="cuda")[None]
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device="cuda")
    tokens = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
    tokens[0, :n] = torch.from_numpy(prompt)

    def one_shot():
        k, v = init_pages(cc, device="cuda")
        return forward_prefill(params, cfg, tokens, i32(n), k, v, table)[0]

    def chunked():
        k, v = init_pages(cc, device="cuda")
        for pos in range(0, n, 1024):
            m = min(1024, n - pos)
            chunk = torch.zeros((1, 1024), dtype=torch.int32, device="cuda")
            chunk[0, :m] = tokens[0, pos:pos + m]
            logits = forward_chunk(params, cfg, chunk, i32(pos), i32(m), k, v, table)[0]
        return logits

    wall = {}
    for name, fn in (("one-shot", one_shot), ("chunked", chunked)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = (1e3 * (time.perf_counter() - t0), out)     # the second run stays
    (ms1, ref), (ms2, got) = wall["one-shot"], wall["chunked"]
    err = float((got - ref).abs().max())
    top2 = ref[0].topk(2).values
    same = int(got.argmax()) == int(ref.argmax())
    say(f"chunk vs one-shot ({model} bf16, 1,500-token prompt, buckets 1,024 / 2,048): "
        f"first-token logits max |diff| {err:.4e} (logit scale {float(ref.abs().max()):.3f}), "
        f"top-1 {'equal' if same else 'different'} (one-shot top-1/top-2 gap "
        f"{float(top2[0] - top2[1]):.4e}); wall {ms1:.1f} ms one-shot, {ms2:.1f} ms in two "
        f"chunks [{card_line()}]")
    del wall, ref, got, out
    torch.cuda.empty_cache()


def phase_in_process(torch, model: str, echo_logprobs) -> dict:
    """Phase 4 with bf16 and with int8 KV, on one set of random weights (the
    phase-3 server's); first the server's echo logprobs against a plain
    forward_score on them."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    t0 = time.perf_counter()
    params = init_params(get_config(model), seed=0, dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    say(f"fused: {model} random weights (seed 0) in {time.perf_counter() - t0:.1f} s")
    check_echo_reference(torch, params, echo_logprobs)
    phase_resume(torch, model, params)
    out = {kv: phase_fused(torch, model, params, kv) for kv in (None, "int8")}
    phase_chunk_vs_one_shot(torch, model, params)
    del params
    torch.cuda.empty_cache()
    return out


def resume_streams(torch, eng, prompt, sp) -> list:
    """The uninterrupted stream of ``prompt`` and, for cuts 1, 5 and 11,
    the stream resumed with that prefix (SamplingParams.prefix_tokens):
    [(cut, resumed stream)] and the full stream."""
    import dataclasses

    full = eng.generate(prompt, sp)
    out = [(cut, eng.generate(prompt, dataclasses.replace(sp, prefix_tokens=tuple(full[:cut]))))
           for cut in (1, 5, 11)]
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    return full, out


def phase_resume(torch, model: str, params) -> None:
    """Stream resume at full width: the default engine (async, K 4, each
    window a graph replay), a greedy and a seeded stream (top-k 40,
    penalties) of 16 tokens, each cut after 1, 5 and 11 tokens and resumed
    with that prefix. In float32 every resumed stream must equal the
    uninterrupted one token for token, greedy and seeded; in bfloat16 (on
    ``params``) the greedy ones must, and the seeded ones are counted, not
    held: the resumed request's prefix K/V comes from the prefill kernels,
    the uninterrupted one's from decode steps, and in bf16 their rounding
    differs enough to move a sampled token."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    t0 = time.perf_counter()
    prompt = [1 + (13 * i) % 200 for i in range(40)]
    samplers = (("greedy", SamplingParams(max_tokens=16, temperature=0.0)),
                ("seeded", SamplingParams(max_tokens=16, temperature=0.8, top_k=40, seed=77,
                                          presence_penalty=0.3, frequency_penalty=0.2)))
    for dtype in ("float32", "bfloat16"):
        p = (params if dtype == "bfloat16"
             else init_params(get_config(model), seed=0, dtype="float32", device="cuda"))
        eng = Engine(EngineConfig(model=model, dtype=dtype, num_pages=64, device="cuda"),
                     params=p)
        for name, sp in samplers:
            full, resumed = resume_streams(torch, eng, prompt, sp)
            same = [(cut, next((i for i, (a, b) in enumerate(zip(got, full)) if a != b), None))
                    for cut, got in resumed]
            held = dtype == "float32" or name == "greedy"
            if held and any(at is not None for _cut, at in same):
                fail(f"resume ({dtype}, {name}): resumed streams differ from the "
                     f"uninterrupted one (cut, first differing token): {same}")
            say(f"resume in process ({model} {dtype}, K {eng.config.decode_steps}, graphed "
                f"windows), {name}: cuts 1, 5, 11 -> "
                + ", ".join(f"cut {c}: " + ("equal" if at is None else f"differs at token {at}")
                            for c, at in same)
                + ("" if held else " (counted, not held)"))
        if not eng.graph_replays or (eng.graph_replays * eng.config.decode_steps
                                     != eng.decode_forwards):
            fail(f"resume: {eng.graph_replays} graph replays for {eng.decode_forwards} forwards")
        del eng, p
        torch.cuda.empty_cache()
    say(f"resume in process: {time.perf_counter() - t0:.1f} s [{card_line()}]")


def wide_debug_configs() -> list:
    """debug-tiny cut to head_dim 96 (phi-3 style: one query head a KV
    head, a sliding window) and debug-gemma to 256 (gemma-2 style:
    softcaps, alternating windows), made here and not registered."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import get_config

    return [dataclasses.replace(get_config("debug-tiny"), name="debug-d96", head_dim=96,
                                num_heads=2, num_kv_heads=2, sliding_window=30),
            dataclasses.replace(get_config("debug-gemma"), name="debug-d256", head_dim=256,
                                num_heads=2, num_kv_heads=1, logit_softcap=30.0,
                                attn_softcap=50.0, query_pre_attn_scalar=256.0)]


def phase_reference(torch, cfg=None, page: int = 4, quantized: bool = False) -> None:
    """The model on a small input against a reference: ``cfg`` (debug-tiny
    by default) in float32, the same weights on the card (kernels) and on
    the CPU (plain versions), at a page of ``page`` rows; ``quantized``:
    the weights int8 (quantized on the CPU; the W8A16 kernel on the card).
    Prefill logits within 1e-4 (summation order only), and the engines'
    greedy streams identical, kv_write dus and fused, float and int8 KV,
    with a chunked prompt and a second pass of cache hits."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_prefill, init_params
    from llms_on_kubernetes_tpu_torch.ops.quant import quantize_params

    cfg = cfg or get_config("debug-tiny")
    cpu_params = init_params(cfg, seed=0, dtype="float32", device="cpu")
    if quantized:
        cpu_params = quantize_params(cpu_params)
    weights = "int8 weights" if quantized else "f32"

    def on(dev):
        return {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                    else v.to(dev)) for k, v in cpu_params.items()}

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 32)).astype(np.int32))
    lengths = torch.tensor([32, 17, 5], dtype=torch.int32)
    logits = {}
    pps = -(-32 // page)
    table = torch.arange(1, 3 * pps + 1, dtype=torch.int32).reshape(3, pps)
    for dev in ("cpu", "cuda"):
        cc = CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                         num_pages=3 * pps + 1, page_size=page, pages_per_slot=pps,
                         dtype="float32")
        k, v = init_pages(cc, device=dev)
        logits[dev] = forward_prefill(on(dev), cfg, tokens.to(dev), lengths.to(dev), k, v,
                                      table.to(dev))[0].cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    say(f"reference: {cfg.name} {weights} prefill logits (page {page}), card vs CPU: "
        f"max_abs_err={err:.3e} tol={F32_TOL:.0e}")
    if not err <= F32_TOL:
        fail(f"{cfg.name} prefill logits on the card differ from the CPU reference")
    kw = dict(model=cfg.name, dtype="float32", max_decode_slots=4, page_size=page,
              num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
    # the last prompt passes the largest bucket (two chunks); the second
    # pass over the same engine adopts every prompt's cached full pages
    prompts = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [11] * 30, [100, 42, 5, 1, 9],
               [(7 * i) % 251 for i in range(45)]]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    for kv_dtype in (None, "int8"):
        streams = {}
        for dev, kv_write in (("cpu", "dus"), ("cuda", "dus"), ("cuda", "fused")):
            eng = Engine(EngineConfig(**kw, device=dev, kv_write=kv_write,
                                      kv_cache_dtype=kv_dtype), model_config=cfg,
                         params=on(dev))
            for rnd in ("cold", "hit"):
                reqs = [eng.submit(p, sp) for p in prompts]
                while eng.has_work():
                    eng.step()
                streams[(dev, kv_write, rnd)] = [r.output for r in reqs]
            # cold: the 45-token prompt in two chunks; then cache hits (page
            # 4: 80 tokens and 4 chunk calls; page 24: 48 tokens, the 30- and
            # 45-token prompts' first pages, and 2 chunk calls)
            min_chunks, min_hits = (2 + 4, 80) if page == 4 else (2 + 2, 48)
            if eng.chunk_calls < min_chunks or eng.allocator.hit_tokens_total < min_hits:
                fail(f"{cfg.name} {dev}: {eng.chunk_calls} chunk calls and "
                     f"{eng.allocator.hit_tokens_total} cached tokens: the chunk path or the "
                     f"prefix cache did not run")
        kv = f"{kv_dtype or 'f32'} KV"
        ref = streams[("cpu", "dus", "cold")]
        if any(out != ref for out in streams.values()):
            fail(f"{cfg.name} {kv}: greedy streams differ between the card and the CPU, or "
                 f"between cold and cache-hit runs: {streams}")
        say(f"reference: {cfg.name} {weights}, {kv}: greedy streams equal on the card (dus, "
            f"fused) and the CPU at page {page}, cold, chunked (45 tokens, bucket 32) and on "
            f"cache hits")


def phase_fp8_reference(torch) -> None:
    """A debug-width compressed-tensors fp8 checkpoint (synth_checkpoint:
    debug-tiny, float32 besides the fp8 linears) loaded as int8 QTensors
    and served on the card and on the CPU: the same greedy streams."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.ops.quant import QTensor
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_checkpoint

    cfg = get_config("debug-tiny")
    path = os.path.join(OUT_DIR, "debug-tiny-fp8")
    shutil.rmtree(path, ignore_errors=True)
    write_checkpoint(cfg, path, dtype="float32", quantization="fp8")
    prompts = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [11] * 30, [(7 * i) % 251 for i in range(45)]]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(EngineConfig(model=cfg.name, dtype="float32", max_decode_slots=4,
                                  page_size=4, num_pages=128, pages_per_slot=16,
                                  prefill_buckets=(16, 32), quantization="fp8", device=dev),
                     model_config=cfg, model_dir=path)
        if not isinstance(eng.params["layers"]["w_down"], QTensor):
            fail("the fp8 checkpoint did not load as int8 QTensors")
        reqs = [eng.submit(p, sp) for p in prompts]
        while eng.has_work():
            eng.step()
        streams[dev] = [r.output for r in reqs]
        del eng
    if streams["cuda"] != streams["cpu"]:
        fail(f"fp8 checkpoint: greedy streams differ between the card and the CPU: {streams}")
    say("reference: a debug-tiny fp8 checkpoint (compressed-tensors, per-channel scales) "
        "serves the CPU's greedy streams on the card (int8 weights, W8A16 kernel)")
    shutil.rmtree(path, ignore_errors=True)


def phase_profile(torch, model: str = MODEL, quantization=None) -> None:
    """Where a decode window's time goes: eight greedy requests in decode
    (the sync engine, so nothing else is in flight), then one window as the
    engine runs it (one CUDA graph replay) and one run eagerly (the same
    function, op by op, as the engine ran it before the graph), each timed
    on the host clock and then traced under torch.profiler. Prints each
    window's wall time, the host time to enqueue it, the device busy time
    and the kernels it runs, the W8A16 kernel's share of the device time,
    and the top operators by device and host time. ``quantization="int8"``:
    int8 weights (random, quantized); the chunk call is profiled with bf16
    weights only."""
    from torch.profiler import ProfilerActivity, profile

    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams

    eng = Engine(EngineConfig(model=model, device="cuda", async_scheduling=False,
                              quantization=quantization))
    for i in range(eng.config.max_decode_slots):
        eng.submit([1 + (i * 7 + j) % 200 for j in range(40)],
                   SamplingParams(max_tokens=64, temperature=0.0))
    eng.step()                                   # prefill + first window
    K, B = eng.config.decode_steps, eng.config.max_decode_slots
    active = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    base = {i: int(eng.slot_len[i]) + 1 for i, _r in active}
    for i, _r in active:
        eng.allocator.allocate(i, base[i] + K - 1)
    packed = eng._window_rows(active, {i: K for i, _r in active}, base)
    dev_packed = torch.from_numpy(packed).cuda()
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
    windows = {
        "graphed": lambda: eng._window.run(packed, None, None),
        "eager": lambda: eng._window._eager(dev_packed, zeros, zeros[:1], eng.k_pages,
                                            eng.v_pages, eng.token_counts),
    }
    kv = "int8" if eng.cache_config.kv_dtype == "int8" else "bf16"
    kv = f"{quantization or 'bf16'} weights, {kv}"
    card = card_line()
    cuda = torch.autograd.DeviceType.CUDA
    launch_api = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                  "cuLaunchKernelEx", "cudaGraphLaunch")
    for name, window in windows.items():
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            window()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            say(f"profile: {name} decode window ({model} {kv} KV, {K} steps, {B} slots): "
                f"wall {1e3 * (t2 - t0):.1f} ms, host enqueue {1e3 * (t1 - t0):.1f} ms "
                f"[{card}]")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        kernels_run = sum(e.count for e in ka if e.device_type == cuda)
        launches = sum(e.count for e in ka if e.key in launch_api)
        busy = device_ms(torch, prof)
        w8 = sum(e.self_device_time_total for e in ka
                 if e.device_type == cuda and "w8_matmul" in e.key) / 1e3
        say(f"profile: {name} window ({kv} KV): device busy {busy:.2f} ms, "
            f"{kernels_run} kernels on the device, {launches} launch calls on the host; "
            f"W8A16 kernels {w8:.2f} ms ({100 * w8 / max(busy, 1e-9):.1f}% of the device "
            f"time) [{card}]")
        say(ka.table(sort_by="self_cuda_time_total", row_limit=18))
        say(ka.table(sort_by="self_cpu_time_total", row_limit=12))
    if quantization is None:
        profile_chunk(torch, eng)
    del eng
    torch.cuda.empty_cache()


def device_ms(torch, prof) -> float:
    """The device's own kernel time in a trace (what the table's "Self
    CUDA time total" sums: a CPU operator's entry repeats its kernels)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def profile_chunk(torch, eng) -> None:
    """One chunk call under torch.profiler: the second chunk of a
    1,500-token prompt (base 1,024, 476 tokens in bucket 1,024, as the
    engine runs it), over the engine's pool kind (bf16, or int8 under
    LLMK_KV_DTYPE=int8), in pool pages the decode requests do not use.
    Prints device time by op name, the window appends' kernel time and the
    plain chunk attention's (its calls run inside a record_function
    range), then the same chunk unpadded (W 476): the difference is what
    the padding costs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from llms_on_kubernetes_tpu_torch.models import decoder

    n, base, bucket = 1500, 1024, 1024
    cfg, dev = eng.model_config, "cuda"
    prompt = np.random.default_rng(1).integers(0, 256, size=n).astype(np.int32)
    free = eng.cache_config.num_pages - 33     # the top 32 pages of each layer's pool
    table = torch.arange(free, free + 32, dtype=torch.int32, device=dev)[None]
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    attention = decoder.dispatch_chunk_attention

    def ranged(*a, **k):
        with record_function("chunk_attention"):
            return attention(*a, **k)

    def chunk(pos, m, W):
        tokens = torch.zeros((1, W), dtype=torch.int32, device=dev)
        tokens[0, :m] = torch.from_numpy(prompt[pos:pos + m])
        return decoder.forward_chunk(eng.params, cfg, tokens, i32(pos), i32(m), eng.k_pages,
                                     eng.v_pages, table)[0]

    kv = "int8" if eng.cache_config.kv_dtype == "int8" else "bf16"
    chunk(0, base, bucket)                                  # the first chunk fills the pages
    for label, W in ((f"bucket {bucket}", bucket), ("unpadded W 476", n - base)):
        for _ in range(2):
            chunk(base, n - base, W)                        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(base, n - base, W)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        decoder.dispatch_chunk_attention = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                chunk(base, n - base, W)
                torch.cuda.synchronize()
        finally:
            decoder.dispatch_chunk_attention = attention
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        # the window kernels are launched through ctypes, outside any host
        # op: count them by kernel name; the attention by its host ranges
        appends = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == cuda and "write_window" in e.key) / 1e3
        attn = sum(e.device_time_total for e in prof.events()
                   if e.name == "chunk_attention" and e.device_type == cpu) / 1e3
        say(f"profile: chunk call ({cfg.name} {kv} KV, base {base}, {n - base} tokens, "
            f"{label}): wall {wall:.1f} ms, device {device_ms(torch, prof):.2f} ms, of which "
            f"window append kernels {appends:.3f} ms ({cfg.num_layers} calls) and chunk "
            f"attention {attn:.2f} ms [{card_line()}]")
        if label.startswith("bucket"):
            say(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18))


# ---------------------------------------------------------------------------
# phase 5: a safetensors checkpoint, written, loaded and served
# ---------------------------------------------------------------------------

CKPT_MODEL = "phi-3-mini"
CKPT_DIR = os.path.join(OUT_DIR, "phi-3-mini-synth")
CKPT_PPS = 48          # 3,072 tokens a slot: room for the 2,500-token prompt
# a 2,500-token text past phi-3's 2,047-token window, sharing no page with
# phase 3's prompts (the byte tokenizer: one token a character)
PROMPT_2500 = ("A sliding window keeps the last two thousand and forty seven keys in "
               "view, and the page table still holds every one of them. " * 25)[:2500]


def drop_page_cache(path: str) -> None:
    """Ask the kernel to drop a written file's cached pages (clean pages
    only, so after an fsync), so the next read comes from the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def expected_layer(cfg, i: int, spec: dict) -> dict:
    """Layer i of the decoder's parameters as the writer wrote its HF
    tensors (bfloat16 bits), moved to the decoder's layouts here with
    numpy, independently of the loader: phi-3's fused qkv_proj and
    gate_up_proj split, linears transposed, heads made explicit."""
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import tensor_value

    H, KV, hd, D, F = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size,
                       cfg.intermediate_size)
    p = f"model.layers.{i}."
    hf = lambda name: tensor_value(cfg, p + name, *spec[p + name])
    qkv = hf("self_attn.qkv_proj.weight")
    gate_up = hf("mlp.gate_up_proj.weight")
    return {
        "wq": qkv[:H * hd].T.reshape(D, H, hd),
        "wk": qkv[H * hd:(H + KV) * hd].T.reshape(D, KV, hd),
        "wv": qkv[(H + KV) * hd:].T.reshape(D, KV, hd),
        "wo": hf("self_attn.o_proj.weight").T.reshape(H, hd, D),
        "w_gate": gate_up[:F].T, "w_up": gate_up[F:].T,
        "w_down": hf("mlp.down_proj.weight").T,
        "attn_norm": hf("input_layernorm.weight"),
        "mlp_norm": hf("post_attention_layernorm.weight"),
    }


def bits(t) -> np.ndarray:
    """A bfloat16 tensor's bits as uint16, on the host."""
    import torch
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


def phase_checkpoint(torch) -> dict:
    """Write full-width phi-3-mini as a bf16 safetensors checkpoint
    (testing/synth_checkpoint.py: the family's names, shapes and layouts,
    pattern values), drop it from the page cache, load it in this process
    (cold) and hold layers 0 and 31 (the fused tensors split), the
    embedding, the final norm and the head bit for bit to what was
    written; then serve it through the CLI with bf16 and with int8 KV."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import (
        tensor_specs, tensor_value, write_checkpoint, write_tokenizer,
    )

    t_phase = time.perf_counter()
    cfg = get_config(CKPT_MODEL)
    specs = tensor_specs(cfg)
    need = sum(int(np.prod(shape)) * 2 for _, shape, _ in specs)
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free = shutil.disk_usage(OUT_DIR).free
    if free < need + (1 << 30):
        fail(f"{free} bytes free under {OUT_DIR}: the {CKPT_MODEL} checkpoint needs {need} "
             f"and 1 GiB of room")
    t0 = time.perf_counter()
    index = write_checkpoint(cfg, CKPT_DIR)
    shards = sorted(set(index["weight_map"].values()))
    for shard in shards:
        drop_page_cache(os.path.join(CKPT_DIR, shard))
    write_s = time.perf_counter() - t0
    say(f"checkpoint: {CKPT_MODEL} written, {index['metadata']['total_size']} bytes in "
        f"{len(shards)} shards, {len(index['weight_map'])} tensors, {write_s:.1f} s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_hf_params(cfg, CKPT_DIR, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    say(f"checkpoint: loaded in process from a dropped page cache in {load_s:.2f} s "
        f"({need / load_s / 1e9:.2f} GB/s) [{card_line()}]")
    spec = {name: (shape, kind) for name, shape, kind in specs}
    for i in (0, cfg.num_layers - 1):
        for name, want in expected_layer(cfg, i, spec).items():
            got = params["layers"][name][i]
            if got.dtype != torch.bfloat16 or not np.array_equal(bits(got), want):
                fail(f"checkpoint: layer {i} {name} differs from what was written")
    for name, hf_name in (("embed", "model.embed_tokens.weight"),
                          ("final_norm", "model.norm.weight"), ("lm_head", "lm_head.weight")):
        want = tensor_value(cfg, hf_name, *spec[hf_name])
        if not np.array_equal(bits(params[name]), want.T if name == "lm_head" else want):
            fail(f"checkpoint: {name} differs from what was written")
    say(f"checkpoint: layers 0 and {cfg.num_layers - 1} (qkv_proj and gate_up_proj split), "
        f"embed, final_norm and lm_head equal what was written, bit for bit")
    del params
    torch.cuda.empty_cache()
    # int8 KV from the weights-only directory (the byte tokenizer), then the
    # phi3 tokenizer files written beside the weights and bf16 KV through them
    served = {"int8": serve_checkpoint(cfg, "int8")}
    t0 = time.perf_counter()
    write_tokenizer(CKPT_DIR, "phi3")
    tok_s = time.perf_counter() - t0
    served[None] = serve_checkpoint(cfg, None, tokenizer="phi3")
    phase_checkpoint_int8(torch, cfg)
    say(f"checkpoint phase: {time.perf_counter() - t_phase:.1f} s (write {write_s:.1f}, "
        f"tokenizer files {tok_s:.2f}, cold load {load_s:.2f}, to /health with the phi3 "
        f"tokenizer (bf16 KV) {served[None]['health_s']:.1f} / weights only (int8 KV) "
        f"{served['int8']['health_s']:.1f}, warm load in the server bf16 "
        f"{served[None]['load_s']} / int8 {served['int8']['load_s']}) [{card_line()}]")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return served


def serve_checkpoint(cfg, kv_cache_dtype=None, tokenizer=None) -> dict:
    """``serve --model <checkpoint dir>`` as a user runs it, and a request
    mix through HTTP: prompts in each bucket, a 1,500-token prompt (two
    chunks) and the same again with a tail (a cache hit), a 2,500-token
    prompt past the sliding window (three chunks), sent as token ids (the
    byte tokenizer's, one a character, whatever tokenizer the directory
    has). The launch counters are zeroed just before and read just after.
    With ``tokenizer`` (the directory holds that family's files) the
    tokenizer checks follow (``_drive_tokenizer``)."""
    kv = ["--kv-cache-dtype", kv_cache_dtype] if kv_cache_dtype else []
    log_name = f"chip_smoke_checkpoint_server{'_' + kv_cache_dtype if kv_cache_dtype else ''}.log"

    def drive(base, _proc):
        out = _drive_checkpoint_server(base, cfg, kv_cache_dtype)
        if tokenizer is not None:
            out["tokenizer"] = _drive_tokenizer(base, CKPT_DIR, tokenizer)
        return out

    res = with_server(["--model", CKPT_DIR, "--pages-per-slot", str(CKPT_PPS), *kv], log_name,
                      drive)
    with open(os.path.join(OUT_DIR, log_name)) as f:
        loaded = [line for line in f if "weights from" in line]
    res["load_s"] = loaded[-1].rsplit(" in ", 1)[-1].strip() if loaded else "not printed"
    return res


def _drive_checkpoint_server(base: str, cfg, kv_cache_dtype) -> dict:
    model = CKPT_DIR
    status, body = http("GET", base + "/v1/models")
    if status != 200 or json.loads(body)["data"][0]["id"] != model:
        fail(f"/v1/models: {status} {body[:200]!r}")
    status, _ = http("POST", base + "/debug/kernels/reset", {})
    if status != 200:
        fail("/debug/kernels/reset failed")
    counts0 = json.loads(http("GET", base + "/debug/kernels")[1])
    max_tokens = 16
    burst = {
        "40-token prompt (bucket 64)": SERVE_TEXT[:40],
        "200-token prompt (bucket 256)": SERVE_TEXT[:200],
        "900-token prompt (bucket 1,024)": PROMPT_900,
        "1,500-token prompt (two chunks)": PROMPT_1500,
        "2,500-token prompt past the 2,047-token window (three chunks)": PROMPT_2500,
    }
    results: dict = {}

    def run(name, prompt):
        try:
            results[name] = http("POST", base + "/v1/completions", {
                "model": model, "prompt": list(prompt.encode("utf-8")),
                "max_tokens": max_tokens, "temperature": 0})
        except Exception as e:  # reported below as this request's failure
            results[name] = ("error", repr(e))

    threads = [threading.Thread(target=run, args=item) for item in burst.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts_burst = json.loads(http("GET", base + "/debug/kernels")[1])
    hit = "1,500-token prompt again + 100-character tail (a cache hit)"
    run(hit, PROMPT_1500 + TAIL_100)
    status, chat = http("POST", base + "/v1/chat/completions", {
        "model": model, "messages": [{"role": "user", "content": SERVE_TEXT[:120]}],
        "max_tokens": max_tokens, "temperature": 0})
    results["chat"] = (status, chat)
    counts = json.loads(http("GET", base + "/debug/kernels")[1])
    for name, res in results.items():
        if res[0] == "error" or res[0] != 200:
            fail(f"checkpoint server, {name}: {res[0]} {res[1][:300]!r}")
        data = json.loads(res[1])
        ch = data["choices"][0]
        text = ch["message"]["content"] if name == "chat" else ch["text"]
        n = data["usage"]["completion_tokens"]
        if ch["finish_reason"] not in ("length", "stop") or not isinstance(text, str) or not (
                n == max_tokens or (ch["finish_reason"] == "stop" and 0 < n <= max_tokens)):
            fail(f"checkpoint server, {name}: {ch['finish_reason']}, {n} tokens")
        say(f"  {name}: 200, {data['usage']['prompt_tokens']} prompt tokens, {n} tokens, "
            f"finish_reason={ch['finish_reason']}")
    delta = {k: counts[k] - counts0[k] for k in ("prefill_calls", "chunk_calls",
                                                "decode_forwards", "prefix_hit_tokens")}
    hit_tokens = counts["prefix_hit_tokens"] - counts_burst["prefix_hit_tokens"]
    launches = counts["launches"]
    L = cfg.num_layers
    int8 = kv_cache_dtype == "int8"
    decode = "paged_decode_int8" if int8 else "paged_decode"
    window = "paged_write_window_int8" if int8 else "paged_write_window"
    say(f"  kernel launches: {launches}; calls {delta}; layers {L}; the re-sent prompt "
        f"adopted {hit_tokens} cached tokens")
    expect = {"flash_prefill": L * delta["prefill_calls"], decode: L * delta["decode_forwards"],
              window: L * delta["chunk_calls"]}
    for name, n in expect.items():
        if not n or launches.get(name, 0) != n:
            fail(f"{name} launched {launches.get(name, 0)} times, expected num_layers x its "
                 f"calls = {n}")
    others = set(launches) - set(expect)
    if any(launches[k] for k in others):
        fail(f"the {'int8' if int8 else 'bf16'} KV checkpoint server launched "
             f"{ {k: launches[k] for k in others} }")
    check_graphed("checkpoint server", counts, counts0)
    # 1,500 tokens: 2 chunks; the hit's rest: 1; 2,500 tokens: 3
    if delta["chunk_calls"] < 6 or hit_tokens < 1472:
        fail(f"{delta['chunk_calls']} chunk calls and a hit of {hit_tokens} tokens: the chunk "
             f"path or the prefix cache did not run")
    return {"launches": launches}


def _drive_tokenizer(base: str, model: str, family: str) -> dict:
    """A checkpoint directory served with its own tokenizer files (the
    port's tokenizer.json reader): /tokenize of the probe strings and chat
    equals ``TOKENIZER_PROBES`` (the ids transformers gives over the same
    files), a chat's usage.prompt_tokens is the templated count, and a chat
    with +100 on the end-of-turn token stops at once with no text (the
    tokenizer's eos_ids reach the engine)."""
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import (
        PROBE_CHAT, PROBE_TEXTS, TOKENIZER_PROBES,
    )

    t0 = time.perf_counter()
    want = TOKENIZER_PROBES[family]
    for text, ids in zip(PROBE_TEXTS, want["texts"]):
        got = _post_ok(base + "/tokenize", {"prompt": text})["tokens"]
        if got != ids:
            fail(f"{family} /tokenize {text!r}: {got} != {ids}")
    chat = [dict(m) for m in PROBE_CHAT]
    got = _post_ok(base + "/tokenize", {"messages": chat})["tokens"]
    if got != want["chat"]:
        fail(f"{family} /tokenize of the probe chat: {got} != {want['chat']}")
    d = _post_ok(base + "/v1/chat/completions", {"model": model, "messages": chat,
                                                  "max_tokens": 4, "temperature": 0})
    if d["usage"]["prompt_tokens"] != len(want["chat"]):
        fail(f"{family} chat prompt_tokens {d['usage']['prompt_tokens']} != "
             f"{len(want['chat'])}")
    eos = {"llama3": 128009, "phi3": 32007, "qwen3": 151645}[family]
    d = _post_ok(base + "/v1/chat/completions", {"model": model, "messages": chat,
                                                  "max_tokens": 8, "temperature": 0,
                                                  "logit_bias": {str(eos): 100}})
    ch = d["choices"][0]
    if ch["finish_reason"] != "stop" or ch["message"]["content"] or \
            d["usage"]["completion_tokens"] != 1:
        fail(f"{family} chat with +100 on {eos}: {ch}, usage {d['usage']}")
    say(f"  {family} tokenizer served: /tokenize of {len(PROBE_TEXTS)} probe strings and the "
        f"probe chat equal TOKENIZER_PROBES; chat prompt_tokens {len(want['chat'])}; +100 on "
        f"{eos} stops at once with no text; {time.perf_counter() - t0:.2f} s")
    return {"prompt_tokens": len(want["chat"])}


LLAMA3_TOK_DIR = os.path.join(OUT_DIR, "llama-3-8b-2-layers-llama3-tokenizer")
LLAMA3_TOK_LAYERS = 2


def _drive_guided_cli(base: str, model: str) -> None:
    """Guided decoding through the CLI server with the llama3 tokenizer:
    one json_object chat and one streamed forced tool call, each parsed and
    validated."""
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import JsonTokenizer

    t0 = time.perf_counter()
    reqs = guided_requests(JsonTokenizer(model))
    kind, body = reqs["json_object"]
    guided_answer("CLI json_object", _post_ok(base + "/v1/chat/completions",
                                              {**body, "model": model}), kind)
    kind, body = reqs["forced tool"]
    guided_answer("CLI streamed tool call", chat_stream(base, {**body, "model": model}), kind)
    say(f"  llama3 tokenizer server: a json_object answer and a streamed forced tool call "
        f"parse and validate ({time.perf_counter() - t0:.2f} s with the FSM graph's capture)")


def phase_tokenizer_llama3() -> dict:
    """llama-3-8b's widths cut to 2 layers, written with the llama3
    tokenizer files, served through the CLI: the tokenizer checks, the
    launch counters zeroed just before and read just after."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_checkpoint

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MODEL), num_layers=LLAMA3_TOK_LAYERS)
    shutil.rmtree(LLAMA3_TOK_DIR, ignore_errors=True)
    write_checkpoint(cfg, LLAMA3_TOK_DIR, tokenizer="llama3")
    write_s = time.perf_counter() - t0

    def drive(base, _proc):
        http("POST", base + "/debug/kernels/reset", {})
        out = _drive_tokenizer(base, LLAMA3_TOK_DIR, "llama3")
        _drive_guided_cli(base, LLAMA3_TOK_DIR)
        out["launches"] = kernel_counts(base)["launches"]
        return out

    try:
        res = with_server(["--model", LLAMA3_TOK_DIR], "chip_smoke_llama3_tokenizer.log", drive)
    finally:
        shutil.rmtree(LLAMA3_TOK_DIR, ignore_errors=True)
    say(f"llama3 tokenizer: {MODEL} cut to {LLAMA3_TOK_LAYERS} layers written in {write_s:.1f} s; "
        f"to /health {res['health_s']:.1f} s; {time.perf_counter() - t0:.1f} s [{card_line()}]")
    return res


# ---------------------------------------------------------------------------
# the goodput ledger, /debug/profile and guided decoding, in process
# ---------------------------------------------------------------------------

LEDGER_PATH = f"{MODEL} ledger and guided server"
LLAMA3_FILES_DIR = os.path.join(OUT_DIR, "llama3-tokenizer-files")
# the grammar-free window's kernels on the card: one replay of the 8-slot
# llama-3-8b bf16 window (K 4, "dus", every row idle), as the parent tree's
# graph ran them under torch 2.11 (PERF.md §6)
FREE_WINDOW_KERNELS = 10_038
# the same graph's nodes (cuGraphGetNodes): what every replay runs. Their
# sum and the rows' upload (one memcpy outside the graph) are the 10,038
# device events above; torch.profiler's count of one replay can come out
# lower (PERF.md §6), the nodes cannot
FREE_WINDOW_NODES = {"kernel": 10_020, "memset": 12, "memcpy": 5}
GUIDED_SCHEMA = {"type": "object",
                 "properties": {"color": {"enum": ["red", "green", "blue"]},
                                "count": {"type": "integer"},
                                "name": {"type": "string", "maxLength": 8},
                                "code": {"type": "string", "minLength": 1, "maxLength": 3}},
                 "required": ["color", "count", "name", "code"]}
GUIDED_TOOLS = [{"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 12},
                                  "days": {"type": "integer"}},
                   "required": ["city", "days"]}}}]


def ledger_report(led, tag: str) -> dict:
    """The ledger's conservation error, device-idle share and MFU / MBU
    over its window (unclipped, from the raw FLOPs and bytes; the
    ``utilization()`` gauges clip at 1.0), printed with the card."""
    snap = led.snapshot()
    window = snap["window_ms"]
    if window <= 0:
        fail(f"{tag}: the ledger booked no dispatch")
    total = snap["attributed_ms"] + snap["wasted_ms"] + snap["idle_ms"]
    err = abs(total - window) / window
    secs = window / 1e3
    out = dict(conservation_err=err, idle_share=snap["idle_ms"] / window,
               mfu=snap["flops"] / (led.peak_flops * secs),
               mbu=snap["hbm_bytes"] / (led.peak_bytes_s * secs),
               window_ms=window, dispatches=snap["dispatches"],
               wasted_share=snap["wasted_ms"] / window)
    say(f"ledger {tag}: window {window:.1f} ms over {snap['dispatches']} dispatches, "
        f"conservation error {100 * err:.2e}% of the window, device idle "
        f"{100 * out['idle_share']:.1f}%, wasted {100 * out['wasted_share']:.1f}%, "
        f"MFU {100 * out['mfu']:.2f}%, MBU {100 * out['mbu']:.2f}% (peaks "
        f"{led.peak_flops / 1e12:.0f} TFLOP/s, {led.peak_bytes_s / 1e12:.2f} TB/s) "
        f"[{card_line()}]")
    if err > 0.01:
        fail(f"{tag}: the ledger's phases miss its window by {100 * err:.3f}%")
    return out


def journaled_stream(base: str, body: dict) -> tuple:
    """A streamed completion with ``X-LLMK-Journal``: (token ids, time of
    the first and last chunk, t0)."""
    status, _h, lines, t0 = stream_lines(base + "/v1/completions", body,
                                         headers={"X-LLMK-Journal": "1"})
    sse_finish("journaled stream", status, [x for x in lines
                                            if not x[1].startswith(":")])
    ids = [int(t) for _t, ln in lines if ln.startswith(": llmk-tok ")
           for t in ln[len(": llmk-tok "):].split(",")]
    data = [t for t, ln in lines if ln.startswith("data: {")]
    return ids, data[0], data[-1], t0


def eight_streams(base: str, n_tokens: int, tag: str, eng=None) -> tuple:
    """8 concurrent greedy journaled streams (one a slot): their ids, and
    the decode rate (tokens after the first over the span from the first
    first-chunk to the last chunk). With ``eng`` (the server's engine, in
    this process) admission is held (``LLMK_FAULT=queue_stall``) until all
    8 wait, so they prefill in the same two batches of admit_batch every
    time: a bf16 prefill of one row and of four differ in the last bits,
    and so would the greedy streams."""
    out: dict = {}

    def one(i):
        out[i] = journaled_stream(base, {"model": MODEL, "prompt": SERVE_TEXT[i:i + 40],
                                         "max_tokens": n_tokens, "temperature": 0,
                                         "stream": True})

    ths = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    if eng is not None:
        os.environ["LLMK_FAULT"] = "queue_stall"
    try:
        for t in ths:
            t.start()
        deadline = time.perf_counter() + 60
        while eng is not None and len(eng.waiting) < 8:
            if time.perf_counter() > deadline:
                fail(f"{tag}: {len(eng.waiting)} of 8 requests reached the queue")
            time.sleep(0.005)
    finally:
        os.environ.pop("LLMK_FAULT", None)
    for t in ths:
        t.join(timeout=600)
    if len(out) != 8:
        fail(f"{tag}: the streams did not all finish")
    ids = [out[i][0] for i in range(8)]
    if any(len(x) != n_tokens for x in ids):
        fail(f"{tag}: stream lengths {[len(x) for x in ids]}, expected {n_tokens}")
    span = max(o[2] for o in out.values()) - min(o[1] for o in out.values())
    return ids, sum(len(x) - 1 for x in ids) / span


class WindowTimer:
    """CUDA events around each replay of the engine's two window graphs:
    the device time of windows with constrained rows and without."""

    def __init__(self, torch, win):
        self.torch, self.win = torch, win
        self.events = {"free": [], "fsm": []}
        self._run = win.run

        def run(packed, last, pre, use_fsm=False):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self._run(packed, last, pre, use_fsm=use_fsm)
            e1.record()
            self.events["fsm" if use_fsm else "free"].append((e0, e1))
            return out

        win.run = run

    def close(self) -> dict:
        self.torch.cuda.synchronize()
        del self.win.run
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


def graph_kernel_count(torch, win, use_fsm: bool, times: int = 3,
                       hold=None) -> tuple[list, float]:
    """(device events of each of ``times`` consecutive replays of a window
    graph, the first one's device busy ms), every row idle (a replay runs
    the same kernels whatever its rows hold; idle rows write the trash page
    and change no state), each under its own torch.profiler session (the
    events are kernels, memsets and memcpys, the rows' upload included).
    These replays are the count's own: the launch counters and the
    window's replay counts are put back after. ``hold``: a running
    server's ProfileManager, reserved for the count (the profiler is
    process-global: a capture meanwhile answers busy)."""
    with hold.reserve() if hold is not None else contextlib.nullcontext():
        return _graph_kernel_count(torch, win, use_fsm, times)


def _graph_kernel_count(torch, win, use_fsm: bool, times: int) -> tuple[list, float]:
    from torch.profiler import ProfilerActivity, profile

    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.graphs import idle_rows

    saved = (kernels.LAUNCHES.copy(), kernels.REPLAYED.copy(), win.replays, win.fsm_replays)
    packed = idle_rows(win.B, win.pages_per_slot)
    win.run(packed, None, None, use_fsm=use_fsm)
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    counts, busy, names = [], None, None
    for _ in range(times):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            win.run(packed, None, None, use_fsm=use_fsm)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == cuda]
        counts.append(sum(e.count for e in events))
        if busy is None:
            busy, names = device_ms(torch, prof), {e.key: e.count for e in events}
    for live, old in zip((kernels.LAUNCHES, kernels.REPLAYED), saved[:2]):
        live.clear()
        live.update(old)
    win.replays, win.fsm_replays = saved[2:]
    GRAPH_EVENT_NAMES.append((use_fsm, names))
    return counts, busy


# the device events of each graph_kernel_count point by name, in order:
# (FSM graph, {name: count})
GRAPH_EVENT_NAMES: list = []


def event_name_drift() -> str:
    """The names whose device-event counts differ from the first count of
    the same graph, per later point."""
    first: dict = {}
    out = []
    for j, (use_fsm, names) in enumerate(GRAPH_EVENT_NAMES):
        base = first.setdefault(use_fsm, names)
        diff = {k[:60]: names.get(k, 0) - base.get(k, 0)
                for k in set(base) | set(names) if names.get(k, 0) != base.get(k, 0)}
        if diff:
            out.append(f"point {j} ({'FSM' if use_fsm else 'free'}): {diff}")
    return "; ".join(out) or "none"


# CUgraphNodeType (cuda.h) of the nodes a window graph holds
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_nodes(graph) -> dict:
    """The captured graph's nodes by type, read from the graph itself
    (``cuGraphGetNodes`` / ``cuGraphNodeGetType`` on ``raw_cuda_graph``):
    what every replay runs, independent of any profiler."""
    import collections
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    out: collections.Counter = collections.Counter()
    t = ctypes.c_int()
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            fail("cuGraphNodeGetType failed")
        out[_NODE_TYPES.get(t.value, str(t.value))] += 1
    return dict(out)


def steer_bias(tok) -> dict:
    """logit_bias that makes a random-weights model finish a constrained
    answer: the end of turn, then the closing and separating characters,
    outrank whatever else the grammar allows (the bias is applied before
    the grammar's mask, so it only ranks allowed tokens)."""
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import BYTE_ENCODER

    out = {"128009": 100}
    for ch, v in (("}", 60), (",", 40), ('"', 30), (":", 28), ("{", 25), ("<", 22),
                  ("1", 20)):
        tid = tok.token_to_id(BYTE_ENCODER[ord(ch)])
        if tid is None:
            fail(f"the llama3 tokenizer has no token for {ch!r}")
        out[str(tid)] = v
    return out


def guided_answer(name: str, d: dict, kind: str) -> None:
    """A constrained chat answer parses and validates (the tool call's
    arguments against its parameters), or fail."""
    ch = d["choices"][0]
    msg = ch["message"]
    if kind == "tool":
        calls = msg.get("tool_calls") or []
        if ch["finish_reason"] != "tool_calls" or len(calls) != 1 or \
                calls[0]["function"]["name"] != "get_weather" or (msg.get("content") or "").strip():
            fail(f"{name}: not one get_weather call: {ch}")
        args = json.loads(calls[0]["function"]["arguments"])
        if not (isinstance(args.get("city"), str) and len(args["city"]) <= 12
                and isinstance(args.get("days"), int)):
            fail(f"{name}: arguments {args} do not validate")
        return
    if ch["finish_reason"] != "stop":
        fail(f"{name}: finish_reason {ch['finish_reason']}: {msg.get('content')!r}")
    obj = json.loads(msg["content"])
    if not isinstance(obj, dict):
        fail(f"{name}: {obj!r} is not an object")
    if kind == "schema":
        s = GUIDED_SCHEMA["properties"]
        if not (set(obj) == set(s) and obj["color"] in s["color"]["enum"]
                and isinstance(obj["count"], int) and not isinstance(obj["count"], bool)
                and isinstance(obj["name"], str) and len(obj["name"]) <= 8
                and isinstance(obj["code"], str) and 1 <= len(obj["code"]) <= 3):
            fail(f"{name}: {obj} does not validate against the schema")


def phase_ledger_guided(torch) -> dict:
    """llama-3-8b at full width and depth, bf16, random weights, with the
    128,256-id llama3 tokenizer (the synthetic files). In process on the
    fresh engine: the grammar-free window graph counted twice against the
    parent's, the grammars compiled, the FSM graph held against the eager
    window and against the grammar-free graph, and both graphs counted.
    Then behind the port's server in this process: the goodput ledger (8
    greedy streams, ledger on and off in turns, one /debug/profile
    capture) and guided traffic (constrained and free streams mixed, the
    two graphs timed and counted again). The launch counters are zeroed
    just before the server's traffic and read just after."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import JsonTokenizer
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_tokenizer

    t0 = time.perf_counter()
    shutil.rmtree(LLAMA3_FILES_DIR, ignore_errors=True)
    write_tokenizer(LLAMA3_FILES_DIR, "llama3")
    tok = JsonTokenizer(LLAMA3_FILES_DIR)
    eng = Engine(EngineConfig(model=MODEL, device="cuda"))
    if eng.ledger is None:
        fail("the ledger is off by default")
    led = eng.ledger
    K, L = eng.config.decode_steps, eng.model_config.num_layers
    win = eng._window
    card = card_line()
    out: dict = {}
    counted: dict = {}
    srv = None
    try:
        # the grammar-free graph is the parent's: its hand-written kernel
        # launches, its nodes, and the most device events its replays show
        # under torch.profiler on a fresh engine (before any traffic), as
        # the parent's one showed them
        if win.launches != {"paged_decode": K * L}:
            fail(f"the grammar-free window launches {win.launches}, expected "
                 f"{{'paged_decode': {K * L}}}")
        counted["fresh"], fresh_ms = graph_kernel_count(torch, win, False)
        counted["fresh again"] = graph_kernel_count(torch, win, False)[0]
        nodes = {"free": graph_nodes(win.graph)}
        say(f"grammar-free window graph, fresh engine ({MODEL} bf16, {K} steps, 8 slots, "
            f"every row idle): device events of consecutive replays under torch.profiler "
            f"{counted['fresh']}, then {counted['fresh again']}; {fresh_ms:.2f} ms device busy; "
            f"the parent's {FREE_WINDOW_KERNELS}; the graph's nodes {nodes['free']} [{card}]")
        if nodes["free"] != FREE_WINDOW_NODES or \
                max(counted["fresh"] + counted["fresh again"]) != FREE_WINDOW_KERNELS:
            fail(f"the grammar-free window graph holds {nodes['free']} and its replays showed "
                 f"at most {max(counted['fresh'] + counted['fresh again'])} device events; the "
                 f"parent's: {FREE_WINDOW_NODES}, {FREE_WINDOW_KERNELS}")
        grammars, out["compile"] = compile_grammars(tok)
        # the FSM graph (captured at the first constrained admission) held
        # against the eager window, then against the grammar-free graph
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        window_vs_eager(torch, eng, f"{MODEL} bf16 FSM window, graph vs eager",
                        [tok.encode(SERVE_TEXT[i:i + 40]) for i in range(8)],
                        grammars=list(grammars.values()))
        if win.fsm_launches != win.launches:
            fail(f"the FSM window launches {win.fsm_launches} of the port's kernels, the "
                 f"grammar-free one {win.launches}")
        out["two_graphs"] = guided_rows_vs_free(torch, eng, tok, grammars)
        torch.cuda.empty_cache()
        out["fsm_reserved_mib"] = (torch.cuda.memory_reserved() - mem0) / 2**20
        say(f"  reserved memory, cache emptied before and after: +{out['fsm_reserved_mib']:.1f} "
            f"MiB over the FSM tables, the FSM graph's capture and the in-process runs "
            f"[{card}]")
        counted["free, FSM captured"], free_ms = graph_kernel_count(torch, win, False)
        counted["FSM"], fsm_ms = graph_kernel_count(torch, win, True)
        nodes["FSM"] = graph_nodes(win.fsm_graph)
        fsm_plus = nodes["FSM"].get("kernel", 0) - nodes["free"].get("kernel", 0)
        say(f"window graphs after the FSM capture, before the server ({MODEL} bf16, {K} "
            f"steps, 8 slots, every row idle): grammar-free {counted['free, FSM captured']} "
            f"device events, {free_ms:.2f} ms device busy; FSM {counted['FSM']}, "
            f"{fsm_ms:.2f} ms; the FSM graph's nodes {nodes['FSM']}, {fsm_plus:+d} kernels; "
            f"port kernels a replay {win.launches} [{card}]")
        out["window_ms"] = {"fresh": fresh_ms, "free": free_ms, "fsm": fsm_ms}
        srv = OpenAIServer(eng, tok, MODEL)
        base = f"http://127.0.0.1:{srv.start()}"
        eight_streams(base, 16, "warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        counts0 = kernel_counts(base)
        # ledger on and off in turns on one engine (the ledger is read per
        # step): the same greedy streams, the decode rates side by side;
        # what they time is the ledger's booking, not a profile capture:
        # the turns hold the profiler, so an anomaly capture asked for
        # meanwhile answers busy
        rates, streams = {"on": [], "off": []}, {}
        with srv.profiles.reserve():
            for turn in ("on", "off", "off", "on"):
                eng.ledger = led if turn == "on" else None
                if turn == "on":
                    led.reset()
                ids, tps = eight_streams(base, 64, f"ledger {turn}", eng)
                rates[turn].append(tps)
                if streams.setdefault(turn, ids) != ids:
                    fail(f"ledger {turn}: greedy streams differ between turns")
                if turn == "on":
                    out["ledger"] = ledger_report(led, "8 streams, 8-slot window")
        eng.ledger = led
        if streams["on"] != streams["off"]:
            fail("greedy streams differ with the ledger on and off")
        say(f"ledger on/off: decode tokens/s (8 concurrent streams of 64 tokens, {MODEL} "
            f"bf16, in turns on/off/off/on): on {rates['on'][0]:.1f} / {rates['on'][1]:.1f}, "
            f"off {rates['off'][0]:.1f} / {rates['off'][1]:.1f}; greedy streams equal; "
            f"anomaly triggers so far {srv.loop.auto_profiles} (held: no capture) [{card}]")
        out["auto_profiles"] = srv.loop.auto_profiles
        out["ledger_tps"] = rates
        out["profile"] = profile_round_trip(base, srv.profiles)
        counted["free, after /debug/profile"] = graph_kernel_count(
            torch, win, False, hold=srv.profiles)[0]
        with srv.profiles.reserve():     # the window times are the FSM's, not a capture's
            out["guided"] = drive_guided(torch, eng, base, tok)
        torch.cuda.synchronize()
        counts = kernel_counts(base)
        out["launches"] = counts["launches"]
        check_graphed("ledger and guided server", counts, counts0)
        fsm_replays = counts["fsm_graph_replays"] - counts0["fsm_graph_replays"]
        say(f"  of them FSM window replays: {fsm_replays}")
        if fsm_replays < 1:
            fail("no window with a constrained row replayed the FSM graph")
        counted["free, after the traffic"] = graph_kernel_count(
            torch, win, False, hold=srv.profiles)[0]
        counted["FSM, after the traffic"] = graph_kernel_count(
            torch, win, True, hold=srv.profiles)[0]
        if graph_nodes(win.graph) != nodes["free"] or graph_nodes(win.fsm_graph) != nodes["FSM"]:
            fail("a window graph's nodes changed")
        say(f"  device events by name that differ from the graph's first count: "
            f"{event_name_drift()}")
        say(f"window graphs' device events under torch.profiler, consecutive idle replays, "
            f"in order: " + "; ".join(f"{k} {v}" for k, v in counted.items())
            + f"; their nodes, unchanged throughout: {nodes} [{card}]")
        out["window_kernels"] = {**counted, "nodes": nodes, "fsm_plus_kernels": fsm_plus}
    finally:
        if srv is not None:
            srv.close()
        shutil.rmtree(LLAMA3_FILES_DIR, ignore_errors=True)
        del srv, eng, win
        torch.cuda.empty_cache()
    say(f"phase ledger and guided: {time.perf_counter() - t0:.1f} s")
    return out


def post_profile(base: str, duration_ms: int) -> tuple:
    """``POST /debug/profile``, asked again while it answers 409 (an
    anomaly capture of the server's own is running), for up to 60 s."""
    deadline = time.perf_counter() + 60
    while True:
        status, raw = http("POST", base + "/debug/profile", {"duration_ms": duration_ms})
        if status != 409 or time.perf_counter() > deadline:
            return status, raw
        time.sleep(0.2)


def profile_round_trip(base: str, pm) -> dict:
    """One ``/debug/profile`` capture (300 ms) while 8 streams decode, its
    archive downloaded: it must hold CUDA kernel events, and every stream
    must end whole (the capture started and stopped between steps, never
    inside a graph replay); then a second capture with no traffic. The
    server's own anomaly capture may hold the profiler (``pm``, its
    ProfileManager): the streams start once it is free, and start again
    when the POST still meets one (409), so the capture sees them."""
    import io
    import tarfile

    done: dict = {}

    def traffic():
        done["ids"], done["tps"] = eight_streams(base, 128, "streams under the profiler")

    for attempt in range(4):
        deadline = time.perf_counter() + 60
        while pm.busy and time.perf_counter() < deadline:
            time.sleep(0.05)
        done.clear()
        th = threading.Thread(target=traffic)
        th.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        status, raw = http("POST", base + "/debug/profile", {"duration_ms": 300})
        cap_s = time.perf_counter() - t0
        th.join(timeout=600)
        if status != 409:
            break
        say(f"/debug/profile: 409, an anomaly capture of the server's own held the profiler; "
            f"streams and capture again (attempt {attempt + 2})")
    if status != 200:
        fail(f"/debug/profile: HTTP {status} {raw[:300]!r}")
    meta = json.loads(raw)
    if meta["source"] != "torch-profiler" or "ids" not in done:
        fail(f"/debug/profile: {meta}, streams finished: {'ids' in done}")
    status, data = http("GET", base + f"/debug/profile/{meta['id']}")
    if status != 200:
        fail(f"/debug/profile/{meta['id']}: HTTP {status}")
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        member = next(m for m in tar.getmembers() if m.name.endswith("trace.json"))
        trace = json.load(tar.extractfile(member))
    events = trace.get("traceEvents", [])
    kernels_seen = sum(1 for e in events if e.get("cat") == "kernel")
    say(f"/debug/profile: {meta['id']} ({meta['source']}), 300 ms capture answered in "
        f"{cap_s:.2f} s, archive {len(data) / 1e6:.1f} MB, {len(events)} trace events, "
        f"{kernels_seen} CUDA kernel events; the 8 streams under it ended whole, decoding "
        f"{done['tps']:.1f} tokens/s [{card_line()}]")
    if not kernels_seen:
        fail("the profile archive holds no CUDA kernel event")
    status, raw = post_profile(base, 100)
    if status != 200:
        fail(f"a second /debug/profile: HTTP {status} {raw[:300]!r}")
    return {"kernel_events": kernels_seen, "archive_mb": len(data) / 1e6, "answer_s": cap_s,
            "tps_under_capture": done["tps"]}


def chat_stream(base: str, body: dict) -> dict:
    """A streamed chat completion assembled into the non-streaming shape
    (content, tool_calls from their deltas, finish_reason)."""
    status, _h, lines, _t0 = stream_lines(base + "/v1/chat/completions",
                                          {**body, "stream": True})
    if status != 200 or not lines or lines[-1][1] != "data: [DONE]":
        fail(f"chat stream: HTTP {status}, last line {lines[-1:]!r}")
    content, calls, finish = "", [], None
    for _t, ln in lines:
        if ln.startswith("data: {"):
            for ch in json.loads(ln[6:])["choices"]:
                content += ch["delta"].get("content") or ""
                calls += ch["delta"].get("tool_calls", [])
                finish = ch["finish_reason"] or finish
    return {"choices": [{"message": {"content": content, "tool_calls": calls},
                         "finish_reason": finish}]}


def guided_requests(tok) -> dict:
    """name -> (kind, chat body): json_object, the bounded schema and a
    forced tool call, steered to finish, and free rows."""
    chat = [{"role": "user", "content": "Report the weather as JSON."}]
    steer = steer_bias(tok)
    return {
        "json_object": ("json", {"model": MODEL, "messages": chat, "max_tokens": 64,
                                 "temperature": 0, "logit_bias": steer,
                                 "response_format": {"type": "json_object"}}),
        "schema": ("schema", {"model": MODEL, "messages": chat, "max_tokens": 96,
                              "temperature": 0, "logit_bias": steer,
                              "response_format": {"type": "json_schema", "json_schema": {
                                  "name": "report", "schema": GUIDED_SCHEMA}}}),
        "forced tool": ("tool", {"model": MODEL, "messages": chat, "max_tokens": 128,
                                 "temperature": 0, "logit_bias": steer, "tools": GUIDED_TOOLS,
                                 "tool_choice": {"type": "function",
                                                 "function": {"name": "get_weather"}}}),
        "free": ("free", {"model": MODEL, "messages": chat, "max_tokens": 48,
                          "temperature": 0}),
    }


def compile_grammars(tok) -> tuple[dict, dict]:
    """The three guided kinds' grammars at the 128,256-id vocabulary, each
    compiled cold and then from the cache, timed: (name -> grammar, the
    times)."""
    from llms_on_kubernetes_tpu_torch.engine.grammar import (
        compile_response_format, compile_tool_choice, token_bytes_of,
    )

    card = card_line()
    t0 = time.perf_counter()
    tb = token_bytes_of(tok)
    tb_s = time.perf_counter() - t0
    eos = sorted(tok.eos_ids)
    builds = {
        "json_object": lambda: compile_response_format({"type": "json_object"}, tb, eos),
        "schema": lambda: compile_response_format(
            {"type": "json_schema", "json_schema": {"schema": GUIDED_SCHEMA}}, tb, eos),
        "forced tool": lambda: compile_tool_choice(GUIDED_TOOLS, "get_weather", tb, eos),
    }
    grammars, compile_s = {}, {}
    for name, build in builds.items():
        t0 = time.perf_counter()
        g = build()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        if build() is not g:
            fail(f"grammar {name}: the cache missed")
        grammars[name] = g
        compile_s[name] = (cold, time.perf_counter() - t0, g.n_states, g.n_classes)
        say(f"grammar {name}: compiled in {1e3 * cold:.1f} ms cold, {1e3 * compile_s[name][1]:.3f} "
            f"ms from the cache; {g.n_states} states, {g.n_classes} token classes "
            f"({len(tb)}-id vocabulary; host CPU, {card})")
    say(f"grammar: token byte map of the {len(tb)}-id llama3 vocabulary in {1e3 * tb_s:.1f} ms")
    return grammars, {"compile_s": compile_s, "token_bytes_s": tb_s}


class WindowLog:
    """Each window the engine launches, in order: whether it replayed the
    FSM graph, and whether a row of it read its input token from the
    newest in-flight window (the other graph's, when the kind changed)."""

    def __init__(self, win):
        from llms_on_kubernetes_tpu_torch.engine.graphs import BUD, SRC, SRC_INFLIGHT

        self.win, self.kinds = win, []
        run = win.run

        def logged(packed, last, pre, use_fsm=False):
            chained = last is not None and bool(
                ((packed[:, SRC] == SRC_INFLIGHT) & (packed[:, BUD] > 0)).any())
            self.kinds.append(("fsm" if use_fsm else "free", chained))
            return run(packed, last, pre, use_fsm=use_fsm)

        win.run = logged

    def close(self) -> list:
        del self.win.run
        return self.kinds


def walk_grammar(name: str, tok, req, g) -> None:
    """Every token of a constrained request's output is allowed by its
    grammar from the state the tokens before it reached (host tables),
    and an answer that stopped parses as JSON."""
    st = g.start
    for j, t in enumerate(req.output):
        nxt = g.next_state(st, t)
        if nxt < 0:
            fail(f"{name}: token {j} ({t}) of {req.output} is not allowed by its grammar")
        st = nxt
    if req.finish_reason == "stop" and name.split()[-1] != "tool":
        text = tok.decode([t for t in req.output if t not in tok.eos_ids])
        try:
            json.loads(text)
        except ValueError:
            fail(f"{name}: stopped on {text!r}, which does not parse")


def guided_rows_vs_free(torch, eng, tok, grammars: dict) -> dict:
    """The two window graphs against each other, in process on the fresh
    engine (greedy, the 8 prompts always submitted together so they
    prefill in the same batches): 8 free rows, then the same 8 with every
    other row constrained (the free rows' streams must equal the first
    run's); 4 free rows alone, then the same 4 with 4 constrained rows
    submitted while their windows are in flight, so the windows go
    grammar-free, FSM, grammar-free, each reading the other graph's
    in-flight tokens (the free streams must equal the run alone). Every
    constrained output walks its grammar on the host."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    eos = tuple(sorted(tok.eos_ids))
    steer = tuple((int(k), float(v)) for k, v in steer_bias(tok).items())
    kinds = list(grammars.items())
    prompts = [tok.encode(SERVE_TEXT[i:i + 40]) for i in range(8)]
    free = SamplingParams(max_tokens=32, temperature=0.0, stop_token_ids=eos)
    # the joined free rows outlast the constrained ones that join them
    longer = dataclasses.replace(free, max_tokens=64)

    def guided(j):
        return SamplingParams(max_tokens=16, temperature=0.0, stop_token_ids=eos,
                              logit_bias=steer, grammar=kinds[j % len(kinds)][1])

    def drain(reqs):
        while eng.has_work():
            eng.step()
        return reqs

    t0 = time.perf_counter()
    log = WindowLog(eng._window)
    try:
        alone8 = [r.output for r in drain([eng.submit(p, free) for p in prompts])]
        n_alone8 = len(log.kinds)
        mixed = drain([eng.submit(p, guided(i // 2) if i % 2 == 0 else free)
                       for i, p in enumerate(prompts)])
        n_mixed = len(log.kinds)
        alone4 = [r.output for r in drain([eng.submit(p, longer) for p in prompts[:4]])]
        n_alone4 = len(log.kinds)
        joined = [eng.submit(p, longer) for p in prompts[:4]]
        for _ in range(3):
            eng.step()
        late = [eng.submit(p, guided(j)) for j, p in enumerate(prompts[4:])]
        drain(joined + late)
    finally:
        windows = log.close()
    for i in range(1, 8, 2):
        if mixed[i].output != alone8[i]:
            fail(f"mixed batch: free row {i} differs from the free batch's "
                 f"({mixed[i].output} against {alone8[i]})")
    for i in range(4):
        if joined[i].output != alone4[i]:
            fail(f"free rows joined by constrained ones: row {i} differs from the run "
                 f"alone ({joined[i].output} against {alone4[i]})")
    for i in range(0, 8, 2):
        walk_grammar(f"mixed row {i} {kinds[(i // 2) % len(kinds)][0]}", tok, mixed[i],
                     kinds[(i // 2) % len(kinds)][1])
    for j, r in enumerate(late):
        walk_grammar(f"late row {j} {kinds[j % len(kinds)][0]}", tok, r, kinds[j % len(kinds)][1])
    def letters(ws):
        return "".join("G" if k == "fsm" else "f" for k, _c in ws)

    if "G" in letters(windows[:n_alone8]) or "G" not in letters(windows[n_alone8:n_mixed]):
        fail(f"free batch windows {letters(windows[:n_alone8])}, mixed batch windows "
             f"{letters(windows[n_alone8:n_mixed])}")
    seq = windows[n_alone4:]
    kinds_seq = letters(seq)
    into = any(a[0] == "free" and b == ("fsm", True) for a, b in zip(seq, seq[1:]))
    out_of = any(a[0] == "fsm" and b == ("free", True) for a, b in zip(seq, seq[1:]))
    if not (into and out_of):
        fail(f"the windows never chained grammar-free -> FSM -> grammar-free through "
             f"in-flight tokens: {kinds_seq}")
    say(f"  two window graphs ({MODEL} bf16, greedy): a mixed batch's 4 free rows equal the "
        f"free batch's; 4 free rows joined mid-stream by 4 constrained ones equal the run "
        f"alone, over windows {kinds_seq} (f grammar-free, G FSM; each switch read the "
        f"other graph's in-flight tokens); every constrained output walks its grammar "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"mixed_windows": letters(windows[n_alone8:n_mixed]), "joined_windows": kinds_seq,
            "mixed_outputs": [len(mixed[i].output) for i in range(0, 8, 2)],
            "late_outputs": [len(r.output) for r in late]}


def drive_guided(torch, eng, base: str, tok) -> dict:
    """8 free streams, then 8 mixed (two of each guided kind, two free)
    through the server, every constrained answer parsed and validated;
    each window's device time by graph (CUDA events around the
    replays)."""
    from llms_on_kubernetes_tpu_torch import kernels

    card = card_line()
    reqs = guided_requests(tok)
    timer = WindowTimer(torch, eng._window)
    mem0 = torch.cuda.memory_reserved()
    results: dict = {}

    def run(key, name):
        kind, body = reqs[name]
        try:
            results[key] = chat_stream(base, body)
        except Exception as e:  # reported below
            results[key] = e

    try:
        for batch in ("free", "mixed"):
            names = ["free"] * 8 if batch == "free" else [
                "json_object", "schema", "forced tool", "free"] * 2
            ths = [threading.Thread(target=run, args=((batch, i), n))
                   for i, n in enumerate(names)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            for i, name in enumerate(names):
                d = results.get((batch, i))
                if not isinstance(d, dict):
                    fail(f"guided {batch} {name}: {d!r}")
                kind = reqs[name][0]
                if kind == "free":
                    if d["choices"][0]["finish_reason"] not in ("length", "stop"):
                        fail(f"free row: {d}")
                else:
                    guided_answer(f"guided {name}", d, kind)
            if batch == "free":
                free_only = len(timer.events["free"])
    finally:
        times = timer.close()
    mem = torch.cuda.memory_reserved() - mem0
    capture = [s for k, s in kernels.COMPILES if k == "graph:window_fsm"]
    free_ms = times["free"][:free_only]
    fsm_ms = times["fsm"]
    if not fsm_ms or not free_ms:
        fail(f"window device times: {len(free_ms)} grammar-free, {len(fsm_ms)} FSM")
    f_med, g_med = float(np.median(free_ms)), float(np.median(fsm_ms))
    say(f"guided: 8 free streams, then 8 mixed (2 json_object, 2 schema, 2 forced tool "
        f"calls, 2 free) -- every constrained answer parses and validates; window device "
        f"time, median (CUDA events around the replay): grammar-free {f_med:.2f} ms over "
        f"{len(free_ms)} windows, with constrained rows {g_med:.2f} ms over {len(fsm_ms)} "
        f"(+{100 * (g_med / f_med - 1):.1f}%); the FSM graph captured in "
        f"{capture[0] if capture else float('nan'):.2f} s; reserved memory +{mem / 2**20:.1f} MiB "
        f"over the guided traffic [{card}]")
    return {"free_window_ms": f_med, "fsm_window_ms": g_med, "n_free": len(free_ms), "n_fsm": len(fsm_ms),
            "fsm_capture_s": capture[0] if capture else None, "reserved_mib": mem / 2**20}


# ---------------------------------------------------------------------------
# phase 4b: the host KV tier, the disaggregated handoff and QoS
# ---------------------------------------------------------------------------

TIER_GB = 4.0
# the JAX session_bench shape (bench.py:2191) at full width: sessions x
# turns, round-robin, ~500-token first turns, greedy tokens a turn, in a
# pool below the sessions' combined state
SESSIONS, TURNS, FIRST_TURN, TURN_NEW, USER_NEW = 12, 3, 500, 32, 16
SESSION_PAGES = 97          # 96 usable pages of 64 rows (+ the trash page)
DISAGG_LENS = (200, 450, 700, 900)
DISAGG_NEW = 32
TIER_PATH = f"{MODEL} host tier sessions bf16 KV"
DECODE_PATH = f"{MODEL} disaggregated decode replica"
PREFILL_PATH = f"{MODEL} disaggregated prefill replica"
DRILL_LAYERS = 2
QOS_BATCH_TOKENS = 256
QOS_ENV = {"priorities": {"bulk": "batch", "fe": "interactive"},
           "weights": {"bulk": 1, "fe": 1}, "starvation_s": 60}


def flip_margin(ref, ref_lps, got):
    """None when ``got`` equals ``ref``; else (position, nats between the
    reference's token and ``got``'s at the first difference by the
    reference's own top logprobs (inf when ``got``'s is not among them),
    the bound a near-tie may reach: 2 x BF16_REL_TOL x |the reference
    token's logprob|, the bf16 logprob tolerance on each side). A greedy
    flip between two bf16 prefill paths of the same history (the chunk
    path after an adoption, a one-shot or differently chunked prefill
    without it) is accepted only within that bound: a near-tie, the margin
    rule the port's parity checks use for greedy flips."""
    if got == ref:
        return None
    i = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), min(len(ref), len(got)))
    if i >= len(ref) or i >= len(got) or ref_lps[i] is None:
        return i, float("inf"), 0.0
    lp, top_ids, top_lps = ref_lps[i]
    alt = dict(zip(top_ids, top_lps)).get(got[i])
    return (i, float("inf") if alt is None else round(float(lp - alt), 4),
            round(2 * BF16_REL_TOL * abs(lp), 4))


def session_traffic(eng, sp) -> tuple[list, list]:
    """SESSIONS x TURNS multi-turn sessions through ``eng``: each round
    submits every session's next turn (its history: the last prompt, the
    answer and USER_NEW new tokens), round-robin, and steps until all
    finish. Returns (every (output, its logprobs), the returning turns'
    TTFT in ms)."""
    rng = np.random.default_rng(14)
    hist = [[int(t) for t in rng.integers(1, 128_000, FIRST_TURN + 8 * s)]
            for s in range(SESSIONS)]
    outs, ttft = [], []
    for turn in range(TURNS):
        reqs = [eng.submit(h, sp) for h in hist]
        while eng.has_work():
            eng.step()
        for s, r in enumerate(reqs):
            if r.finish_reason not in ("length", "stop"):
                fail(f"session {s} turn {turn}: finished {r.finish_reason}")
            outs.append((list(r.output), list(r.output_logprobs)))
            if turn:
                ttft.append((r.first_token_at - r.submitted_at) * 1000.0)
            hist[s] = hist[s] + list(r.output) + [int(t) for t in
                                                  rng.integers(1, 128_000, USER_NEW)]
    return outs, ttft


def spill_upload_ms(torch, eng, n_tokens: int = 900, reps: int = 5) -> tuple:
    """Per-page wall ms of a spill's enqueue (the gather and the copy into
    the pinned ring), of its drain (the wait and one host copy a page into
    the tier) and of an upload (one host copy a page into pinned staging,
    the copy to the card, index_copy_ into the pools), each between two
    device syncs, on a slot seated by hand with ``n_tokens`` committed,
    after every earlier spill has landed; the medians of ``reps``."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    page = eng.allocator.page_size
    eng._drain_spills()
    gather, drain, up = [], [], []
    for rep in range(reps):
        prompt = [1 + (13 * rep + 7 * j) % 127_000 for j in range(n_tokens)]
        req = eng.submit(prompt, SamplingParams(max_tokens=4, temperature=0.0))
        with eng._lock:
            slot = eng._seat_next([])[0]
        eng._host_adopt.pop(slot, None)
        eng.slot_len[slot] = n_tokens
        m = n_tokens // page
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._spill_slot(req)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng._drain_spills()
        gather.append((t1 - t0) * 1000.0 / m)
        drain.append((time.perf_counter() - t1) * 1000.0 / m)
        digests = eng.allocator._digests(prompt[:m * page])
        matched, payloads = eng.host_kv.match_chain("", digests, 0)
        if len(matched) != m:
            fail(f"spill timing: {len(matched)} of {m} pages in the tier")
        eng._host_adopt[slot] = (0, matched, payloads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._host_kv_commit(slot, req)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1000.0 / m)
        eng.slot_len[slot] = 0          # nothing to spill again: no prefill ran
        eng.abort(req)
        while eng.has_work():
            eng.step()
    return (float(np.median(gather)), float(np.median(drain)), float(np.median(up)),
            n_tokens // page)


def phase_host_tier(torch, params, roomy) -> dict:
    """A. The host tier in process on ``params`` (llama-3-8b, 32 layers):
    the session traffic with the tier on (``TIER_GB``) and off, bf16 KV
    then int8 KV, in SESSION_PAGES pages. Held: streams equal on and off,
    host hits and uploaded tokens > 0, every decode window a graph replay.
    Printed: the returning turns' TTFT p50 on and off, spill and upload ms
    a page. Then phase 4's preemption case (eight 900-token prompts of 64
    tokens in 122 pages) with the tier on and the requests alternately
    batch and interactive: every victim is of the lowest class running,
    resumed requests upload pages and prefill fewer tokens than their
    re-prefill would, every stream equals phase 4's roomy pool's or first
    differs at a near-tie (``flip_margin``; ``roomy``: its streams and
    their logprobs)."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.engine.qos import priority_rank

    t_phase = time.perf_counter()
    sp = SamplingParams(max_tokens=TURN_NEW, temperature=0.0)
    out: dict = {"timing": {}}
    for kv in (None, "int8"):
        tag = f"{'int8' if kv else 'bf16'} KV"
        runs = {}
        for gb in (TIER_GB, 0.0):
            eng = Engine(EngineConfig(model=MODEL, num_pages=SESSION_PAGES, kv_cache_dtype=kv,
                                      kv_host_cache_gb=gb), params=params)
            kernels.reset_launches()
            t0 = time.perf_counter()
            outs, ttft = session_traffic(eng, sp)
            wall = time.perf_counter() - t0
            if kv is None and gb:
                out["launches"] = kernels.launch_counts()
            if eng.graph_replays < 1 or (eng.graph_replays * eng.config.decode_steps
                                         != eng.decode_forwards):
                fail(f"host tier {tag}: a decode window ran outside the graph")
            hk = eng.host_kv
            runs[gb] = (outs, ttft)
            say(f"  host tier {tag}, tier {'on ' + str(gb) + ' GiB' if gb else 'off'}: "
                f"{SESSIONS} sessions x {TURNS} turns in {SESSION_PAGES - 1} pages, "
                f"{wall:.2f} s; returning turns' TTFT p50 {np.median(ttft):.1f} ms, max "
                f"{max(ttft):.1f} ms; prefix hit tokens {eng.allocator.hit_tokens_total}; "
                + (f"host hits {hk.hits} pages, misses {hk.misses}, evictions "
                   f"{hk.evictions}, spilled {hk.spilled_pages}, uploaded "
                   f"{eng.kv_uploaded_tokens} tokens in {len(eng.kv_upload_obs)} uploads, "
                   f"{hk.used_bytes / 2**20:.0f} MiB held; " if hk else "")
                + f"{eng.graph_replays} graph replays")
            if gb:
                if hk.hits <= 0 or eng.kv_uploaded_tokens <= 0:
                    fail(f"host tier {tag}: no host hit ({hk.hits}) or upload")
                g_ms, d_ms, u_ms, m = spill_upload_ms(torch, eng)
                out["timing"][tag] = (g_ms, d_ms, u_ms)
                say(f"  host tier {tag}: spill {g_ms + d_ms:.3f} ms a page (gather + copy "
                    f"into the pinned ring {g_ms:.3f}, drain into the tier {d_ms:.3f}), "
                    f"upload {u_ms:.3f} ms a page ({m} pages, medians of 5; "
                    f"{eng.cache_config.bytes_per_page / 2**20:.2f} MiB a page) "
                    f"[{card_line()}]")
            del eng
            torch.cuda.empty_cache()
        # the tier-off engine prefills an evicted history one shot (or from
        # its device hit); the tier-on one adopts host pages and prefills
        # the rest through the chunk path: near-tie flips are triaged
        flips = [(k, m) for k, ((ref, lps), (got, _)) in
                 enumerate(zip(runs[0.0][0], runs[TIER_GB][0]))
                 if (m := flip_margin(ref, lps, got)) is not None]
        # the bf16 noise between the two paths: the first token's logprob
        # in both runs, where they chose the same token
        noise = [abs(a[1][0][0] - b[1][0][0]) for a, b in
                 zip(runs[0.0][0][SESSIONS:], runs[TIER_GB][0][SESSIONS:])
                 if a[0][:1] == b[0][:1] and a[1][0] is not None and b[1][0] is not None]
        out.setdefault("ttft", {})[tag] = (float(np.median(runs[TIER_GB][1])),
                                           float(np.median(runs[0.0][1])))
        out.setdefault("flips", {})[tag] = flips
        say(f"  host tier {tag}: {len(runs[0.0][0]) - len(flips)} of {len(runs[0.0][0])} "
            f"streams equal the tier-off engine's; flips (stream, (token, nats, bound)) "
            f"{flips}; the returning turns' first-token logprob on and off differs by "
            f"median {np.median(noise) if noise else 0:.4f}, max "
            f"{max(noise) if noise else 0:.4f} nats over {len(noise)} equal first tokens")
        if any(m[1] > m[2] for _k, m in flips):
            fail(f"host tier {tag}: a stream differs from the tier-off engine's past a "
                 f"near-tie")

    # QoS changes which rows share a prefill call and a window, never a
    # row's result: phase 4's roomy traffic in two classes, no preemption,
    # gives its streams exactly (every prefill call still pads to 4 rows)
    long_prompts = [[1 + (7 * i + 13 * j + j // 64) % 250 for j in range(900)] for i in range(8)]
    sp64 = SamplingParams(max_tokens=64, temperature=0.0)
    classed = Engine(EngineConfig(model=MODEL, kv_write="dus", qos_starvation_s=0),
                     params=params)
    creqs = [classed.submit(p, sp64, priority="batch" if i % 2 else "interactive")
             for i, p in enumerate(long_prompts)]
    while classed.has_work():
        classed.step()
    order = sorted(range(8), key=lambda k: creqs[k].admitted_at)
    if [(r.output, r.finish_reason) for r in creqs] != roomy[0]:
        fail("QoS: greedy streams with two classes differ from phase 4's without them")
    if sorted(order[:4]) != [0, 2, 4, 6]:
        fail(f"QoS: admission order {order}, the interactive requests not first")
    say(f"  QoS on the card: 8 x 900-token prompts in two classes, admitted in the order "
        f"{order} (interactive first): every greedy stream equals phase 4's without classes")
    del classed, creqs
    torch.cuda.empty_cache()

    # phase 4's preemption case with the tier on and two classes
    tight = Engine(EngineConfig(model=MODEL, kv_write="dus", num_pages=123,
                                kv_host_cache_gb=TIER_GB, qos_starvation_s=0), params=params)
    victims, resumed = [], []
    preempt, chunked = tight._preempt_youngest, tight._chunked_prefill

    def spy_preempt():
        seated = [r for r in tight.slots if r is not None]
        lowest = max(priority_rank(r.priority) for r in seated)
        before = {id(r) for r in seated}
        preempt()
        (gone,) = [r for r in seated if id(r) in before - {id(x) for x in tight.slots
                                                             if x is not None}]
        victims.append((gone.priority, priority_rank(gone.priority) == lowest))

    def spy_chunk(req, ptoks, start=0):
        if req.output:
            resumed.append((len(ptoks), start))
        return chunked(req, ptoks, start=start)

    tight._preempt_youngest, tight._chunked_prefill = spy_preempt, spy_chunk
    reqs = [tight.submit(p, sp64, priority="batch" if i % 2 else "interactive")
            for i, p in enumerate(long_prompts)]
    while tight.has_work():
        tight.step()
    flips = [(k, m) for k, (r, (ref, _reason), lps) in enumerate(zip(reqs, *roomy))
             if (m := flip_margin(ref, lps, r.output)) is not None]
    say(f"  tier + QoS preemption: 8 x 900-token prompts (batch and interactive in turns), 64 "
        f"tokens each, in 122 pages: {tight.preemptions} preemptions, victims "
        f"{[p for p, _ in victims]}; resumes (prefill tokens, adopted) {resumed}; uploaded "
        f"{tight.kv_uploaded_tokens} tokens, host hits {tight.host_kv.hits}")
    if tight.preemptions < 1 or not all(ok for _, ok in victims):
        fail("tier + QoS preemption: no preemption, or a victim above the lowest class seated")
    if not resumed or not any(start > 0 for _, start in resumed) or \
            tight.kv_uploaded_tokens <= 0:
        fail("tier + QoS preemption: no resume adopted pages from the host tier")
    if any(r.finish_reason != reason for r, (_o, reason) in zip(reqs, roomy[0])) or \
            any(m[1] > m[2] for _k, m in flips):
        fail(f"tier + QoS preemption: a stream differs from the roomy pool's past a near-tie "
             f"{flips}")
    say(f"  tier + QoS preemption: {8 - len(flips)} of 8 streams equal phase 4's roomy pool's, "
        f"flips (stream, (token, nats, bound)) {flips} (a resume prefills its remainder "
        f"through the chunk path, the roomy run wrote it one shot and by decode); resumes "
        f"prefilled {sum(n - s for n, s in resumed)} tokens, a re-prefill "
        f"{sum(n for n, _ in resumed)}; {time.perf_counter() - t_phase:.1f} s")
    del tight._preempt_youngest, tight._chunked_prefill, tight
    torch.cuda.empty_cache()
    return out


def free_card(torch, tag: str) -> None:
    """Collect what is unreachable (a server and its engine loop hold each
    other: only the cycle collector frees their weights and pools) and
    return the cached blocks; print what this process still holds."""
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  {tag}: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved); the card has "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB free")


def phase_tier_handoff_qos(torch, roomy) -> dict:
    """Phase 4b: A (``phase_host_tier``) and the colocated reference on one
    set of random llama-3-8b weights (seed 0, the servers' own), freed
    before B (``phase_disagg``) starts its two full-width servers; then C
    and D (``phase_drills_qos``)."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    t0 = time.perf_counter()
    free_card(torch, "phase 4b starts")
    params = init_params(get_config(MODEL), seed=0, dtype="bfloat16", device="cuda")
    tier = phase_host_tier(torch, params, roomy)
    refs = colocated_refs(torch, params)
    del params
    free_card(torch, "before the two full-width servers")
    say(f"phase 4b A (host tier): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    disagg = phase_disagg(refs)
    say(f"phase 4b B (disaggregated): {time.perf_counter() - t1:.1f} s")
    drills = phase_drills_qos(torch)
    free_card(torch, "after the drills")
    say(f"phase 4b (host tier, handoff, drills, QoS): {time.perf_counter() - t0:.1f} s")
    return {"tier": tier, "disagg": disagg, "drills": drills}


def disagg_prompts() -> list:
    """DISAGG_LENS-token prompts that share no page (byte-tokenizer ids)."""
    return [[1 + (19 * i + 7 * j + (i * j) % 5) % 250 for j in range(n)]
            for i, n in enumerate(DISAGG_LENS)]


def disagg_body(prompt, model: str = MODEL, **over) -> dict:
    return {"model": model, "prompt": prompt, "max_tokens": DISAGG_NEW, "temperature": 0,
            "stream": True, "logit_bias": BYTE_BIAS, **over}


def streamed(name: str, url: str, body: dict) -> str:
    status, _h, lines, _t = stream_lines(url + "/v1/completions", body)
    if any("error" in ln for _, ln in lines):
        fail(f"{name}: an error event in the stream")
    text, reason, _ = sse_finish(name, status, lines)
    if reason != "length" or not text:
        fail(f"{name}: finished {reason} with {len(text)} characters")
    return text


def colocated_refs(torch, params) -> list:
    """The colocated replica's streams of ``disagg_prompts`` (an in-process
    server on ``params``, the default EngineConfig, each prompt alone):
    (cold, warm) per prompt, the warm one a prefix-cache hit whose
    remainder prefills through the chunk path, as after an adoption."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

    srv = OpenAIServer(Engine(EngineConfig(model=MODEL), params=params), ByteTokenizer(), MODEL)
    try:
        base = f"http://127.0.0.1:{srv.start()}"
        refs = [(streamed(f"colocated {len(p)} cold", base, disagg_body(p)),
                 streamed(f"colocated {len(p)} warm", base, disagg_body(p)))
                for p in disagg_prompts()]
    finally:
        srv.close()
        del srv
    say(f"  colocated reference (in-process server): {sum(c == w for c, w in refs)} of "
        f"{len(refs)} prompts give the same stream cold and warm")
    return refs


def start_router(args: list, log_name: str, replicas: list):
    """``llkt-router ARGS`` on a free port; waits until it finds every
    replica healthy. Returns (process, URL)."""
    port = free_port()
    router = f"http://127.0.0.1:{port}"
    logf = open(os.path.join(OUT_DIR, log_name), "w")
    proc = subprocess.Popen([ROUTER_BIN, *args, "--port", str(port), "--quiet"], stdout=logf,
                            stderr=subprocess.STDOUT, start_new_session=True)
    t0 = time.perf_counter()
    while any(replica_healthy(router, r) != 1.0 for r in replicas):
        if proc.poll() is not None or time.perf_counter() - t0 > 30:
            fail(f"llkt-router ({log_name}) did not admit {replicas} within 30 s")
        time.sleep(0.1)
    return proc, router


def stop_proc(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def roles_config(path: str, model: str, roles: dict) -> str:
    with open(path, "w") as f:
        json.dump({"models": {model: list(roles)}, "roles": roles, "handoff_retries": 2,
                   "probe_interval_s": PROBE_S, "breaker_threshold": 100}, f)
    return path


def handoff_outcomes(router: str) -> dict:
    return {oc: metric(router, "llm_handoff_total", f'outcome="{oc}"')
            for oc in ("ok", "retried", "reprefill", "fallback_colocated")}


def phase_disagg(refs) -> dict:
    """B. Disaggregated at full width: an LLMK_ROLE=prefill and an
    LLMK_ROLE=decode llama-3-8b server (``--kv-host-cache-gb``) behind
    ``llkt-router`` with a roles config; streamed greedy completions of
    DISAGG_LENS-token prompts, one at a time. Held: each stream equals the
    colocated replica's warm stream (``refs``: the same pages, the same
    remainder chunk), the router's ok count rises by one each, the decode
    replica launches no flash prefill and the window kernel num_layers
    times per remainder chunk, its pulled pages all adopted, every decode
    window a graph replay. Printed: the streams equal to the cold ones,
    llm_handoff_seconds, and each pull's bytes and seconds (its kv_pull
    span)."""
    t_phase = time.perf_counter()
    num_layers = 32
    args = ["--model", MODEL, "--random-weights", "--kv-host-cache-gb", str(TIER_GB)]
    pre = Server(args, "chip_smoke_prefill.log", {"LLMK_ROLE": "prefill"})
    dec = Server(args, "chip_smoke_decode.log", {"LLMK_ROLE": "decode"})
    rproc = None
    try:
        for srv in (pre, dec):
            srv.wait_health()
        cfg = roles_config(os.path.join(OUT_DIR, "router_roles.json"), MODEL,
                           {pre.base: "prefill", dec.base: "decode"})
        rproc, router = start_router(["--config", cfg], "chip_smoke_disagg_router.log",
                                     [pre.base, dec.base])
        for srv in (pre, dec):
            http("POST", srv.base + "/debug/kernels/reset", {})
        c_pre0, c_dec0 = kernel_counts(pre.base), kernel_counts(dec.base)
        warm_eq = cold_eq = 0
        for i, (p, (cold, warm)) in enumerate(zip(disagg_prompts(), refs)):
            text = streamed(f"handoff {len(p)}", router, disagg_body(p))
            if text != warm:
                fail(f"handoff {len(p)}: {text[:60]!r} differs from the colocated warm stream "
                     f"{warm[:60]!r}")
            warm_eq += 1
            cold_eq += text == cold
            metric_reaches(router, "llm_handoff_total", 'outcome="ok"', i + 1.0)
        oc = handoff_outcomes(router)
        if oc != {"ok": len(refs), "retried": 0, "reprefill": 0, "fallback_colocated": 0}:
            fail(f"handoff outcomes {oc}")
        c_pre, c_dec = kernel_counts(pre.base), kernel_counts(dec.base)
        pages = sum((n - 1) // 64 for n in DISAGG_LENS)
        chunks = c_dec["chunk_calls"] - c_dec0["chunk_calls"]
        l_dec, l_pre = c_dec["launches"], c_pre["launches"]
        hits = metric_reaches(dec.base, "llm_kv_host_cache_hits_total", "", float(pages))
        say(f"  decode replica: launches {l_dec}, chunk calls {chunks}, prefill calls "
            f"{c_dec['prefill_calls'] - c_dec0['prefill_calls']}, host hits {hits:g} of "
            f"{pages} pages offered; prefill replica: launches {l_pre}, prefill calls "
            f"{c_pre['prefill_calls'] - c_pre0['prefill_calls']}")
        if (l_dec.get("flash_prefill", 0) or chunks != len(refs)
                or l_dec.get("paged_write_window", 0) != num_layers * chunks or hits != pages):
            fail("the decode replica prefilled more than the remainder after adoption")
        if l_pre.get("flash_prefill", 0) != num_layers * len(refs):
            fail(f"the prefill replica launched flash prefill {l_pre.get('flash_prefill')} "
                 f"times, expected {num_layers * len(refs)}")
        check_graphed("decode replica", c_dec, c_dec0)
        n_h = metric(router, "llm_handoff_seconds_count")
        s_h = metric(router, "llm_handoff_seconds_sum")
        traces = json.loads(http("GET", dec.base + f"/debug/traces?limit={len(refs)}")[1])
        pulls = [(s["duration_ms"], s.get("bytes", 0)) for t in traces["traces"]
                 for s in t["spans"] if s["name"] == "kv_pull"]
        say(f"  handoff: {len(refs)} streams of {DISAGG_LENS} tokens through llkt-router, each "
            f"equal to the colocated warm stream ({cold_eq} equal to the cold one too); "
            f"outcomes {oc}; llm_handoff_seconds mean {s_h / max(n_h, 1) * 1000:.1f} ms over "
            f"{n_h:g}; kv_pull (ms, wire bytes) {sorted(pulls, key=lambda x: x[1])}; "
            f"{(n_h and s_h / n_h) or 0:.3f} s; {time.perf_counter() - t_phase:.1f} s "
            f"[{card_line()}]")
        return {"launches": l_dec, "prefill_launches": l_pre, "outcomes": oc,
                "pulls": pulls, "handoff_s": s_h / max(n_h, 1)}
    except SystemExit:
        for srv in (pre, dec):
            say(f"{srv.log_path} (tail):\n{srv.tail()}")
        raise
    finally:
        if rproc is not None:
            stop_proc(rproc)
        for srv in (pre, dec):
            if srv.proc.poll() is None:
                srv.stop()


def drill_server(torch, cfg, role: str, env_qos: bool = False):
    """An in-process server of ``cfg`` (llama-3-8b cut to DRILL_LAYERS) in
    ``role`` with the tier on; ``env_qos`` builds its EngineConfig through
    the CLI's parser, so LLMK_QOS is read as ``serve`` reads it."""
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

    os.environ["LLMK_ROLE"] = role
    try:
        ecfg = engine_config_from_args(build_parser().parse_args(
            ["serve", *POOL_ARGS, "--model", MODEL, "--kv-host-cache-gb", "1"]))
    finally:
        os.environ.pop("LLMK_ROLE", None)
    if not env_qos and ecfg.qos_priorities:
        fail("LLMK_QOS leaked into a drill replica")
    params = init_params(cfg, seed=0, dtype="bfloat16", device="cuda")
    srv = OpenAIServer(Engine(ecfg, model_config=cfg, params=params), ByteTokenizer(), MODEL)
    return srv, f"http://127.0.0.1:{srv.start()}"


def phase_drills_qos(torch) -> dict:
    """C. Drills on llama-3-8b cut to DRILL_LAYERS layers, in-process
    servers behind ``llkt-router``: ``LLMK_FAULT=drop_handoff:2`` (the
    decode replica's first two pulls skipped: outcome "reprefill" twice,
    then "ok"), then ``kill_prefill_replica`` on a fresh prefill replica
    with a decode and a "both" replica beside it ("fallback_colocated").
    Every stream whole and equal to the "both" replica's cold or warm
    stream of its prompt, no error event. D. QoS through the "both"
    server (EngineConfig from ``serve``'s parser under ``LLMK_QOS``): a
    batch flood (tenant "bulk") fills the slots and the queue, then four
    interactive requests (tenant "fe"): each gets its first token before
    any batch request still waiting when they were sent (seated before
    them, first tokens no later);
    ``llm_tenant_admitted_total`` counts both classes, every window a
    graph replay, /metrics lints."""
    from llms_on_kubernetes_tpu_torch import faults, kernels
    from llms_on_kubernetes_tpu_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MODEL), num_layers=DRILL_LAYERS)
    servers, procs = [], []
    os.environ["LLMK_QOS"] = json.dumps(QOS_ENV)
    try:
        both, u_both = drill_server(torch, cfg, "both", env_qos=True)
        os.environ.pop("LLMK_QOS")
        servers.append(both)
        dec, u_dec = drill_server(torch, cfg, "decode")
        servers.append(dec)
        pre, u_pre = drill_server(torch, cfg, "prefill")
        servers.append(pre)
        prompts = [[1 + (23 * i + 5 * j + (i * j) % 3) % 250 for j in range(300 + 97 * i)]
                   for i in range(5)]
        refs = [(streamed(f"drill ref {i} cold", u_both, disagg_body(p)),
                 streamed(f"drill ref {i} warm", u_both, disagg_body(p)))
                for i, p in enumerate(prompts)]
        roles = {u_pre: "prefill", u_dec: "decode", u_both: "both"}
        rproc, router = start_router(
            ["--config", roles_config(os.path.join(OUT_DIR, "router_drill.json"), MODEL,
                                      roles)], "chip_smoke_drill_roles_router.log", list(roles))
        procs.append(rproc)

        def drill_stream(i):
            text = streamed(f"drill {i}", router, disagg_body(prompts[i]))
            if text not in refs[i]:
                fail(f"drill {i}: the stream differs from the colocated ones")
            return "warm" if text == refs[i][1] else "cold"

        kernels.reset_launches()
        faults.reset_claims()
        os.environ["LLMK_FAULT"] = "drop_handoff:2"
        try:
            paths = [drill_stream(i) for i in range(3)]
        finally:
            os.environ.pop("LLMK_FAULT", None)
        oc = handoff_outcomes(router)
        if (oc["reprefill"], oc["ok"], oc["fallback_colocated"]) != (2, 1, 0):
            fail(f"drop_handoff:2: outcomes {oc}")
        say(f"  drill drop_handoff:2: 3 streams whole ({paths}), outcomes {oc}")
        stop_proc(rproc)
        procs.remove(rproc)

        faults.reset_claims()
        os.environ["LLMK_FAULT"] = "kill_prefill_replica:0"
        try:
            killed, u_killed = drill_server(torch, cfg, "prefill")
            servers.append(killed)
            t0 = time.perf_counter()
            while killed.state != "killed":
                if time.perf_counter() - t0 > 10:
                    fail("kill_prefill_replica never fired")
                time.sleep(0.02)
        finally:
            os.environ.pop("LLMK_FAULT", None)
        if http("GET", u_killed + "/health")[0] != 503:
            fail("a killed prefill replica answers /health 200")
        roles = {u_killed: "prefill", u_dec: "decode", u_both: "both"}
        # the killed replica answers /ready 503: wait for the other two
        rproc, router = start_router(
            ["--config", roles_config(os.path.join(OUT_DIR, "router_kill.json"), MODEL,
                                      roles)], "chip_smoke_kill_router.log", [u_dec, u_both])
        procs.append(rproc)
        paths = [drill_stream(i) for i in (3, 4)]
        oc = handoff_outcomes(router)
        if oc["fallback_colocated"] != 2 or oc["ok"]:
            fail(f"kill_prefill_replica: outcomes {oc}")
        drill_launches = kernels.launch_counts()
        say(f"  drill kill_prefill_replica: the prefill replica killed (/health 503), 2 "
            f"streams whole ({paths}), outcomes {oc}; no client-visible drop in either drill; "
            f"{time.perf_counter() - t_phase:.1f} s")

        qos = drive_qos(both)
        say(f"phase 4b C+D (drills, QoS): {time.perf_counter() - t_phase:.1f} s "
            f"[{card_line()}]")
        return {"launches": drill_launches, "qos": qos}
    finally:
        os.environ.pop("LLMK_QOS", None)
        os.environ.pop("LLMK_FAULT", None)
        faults.reset_claims()
        for p in procs:
            stop_proc(p)
        for s in servers:
            s.close()


def drive_qos(srv) -> dict:
    """D (``phase_drills_qos``): the batch flood and the interactive
    requests against the in-process server ``srv``, each stream on a
    thread of its own; admissions recorded on the engine (its first-token
    stamps are what is held, the clients' are printed)."""
    base = f"http://127.0.0.1:{srv.httpd.server_address[1]}"
    eng = srv.engine
    counts0 = kernel_counts(base)
    first: dict = {}
    errors: list = []
    admitted_reqs: list = []
    note = eng._note_admission

    def spy(req):
        if req.admitted_at is None:
            admitted_reqs.append(req)
        note(req)

    def client(i, user, max_tokens):
        name = f"{user}{i}"
        try:
            body = {"model": MODEL, "max_tokens": max_tokens, "temperature": 0, "stream": True,
                    "user": user, "prompt": [1 + (3 * j + 17 * i + 101 * len(user)) % 250
                                             for j in range(96)]}
            req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                for raw in r:
                    if raw.startswith(b"data: {") and name not in first:
                        first[name] = time.perf_counter()
                if r.status != 200:
                    errors.append(f"{name}: HTTP {r.status}")
        except Exception as e:        # reported on the main thread
            errors.append(f"{name}: {e!r}")

    eng._note_admission = spy
    try:
        flood = [threading.Thread(target=client, args=(i, "bulk", QOS_BATCH_TOKENS),
                                  daemon=True) for i in range(20)]
        for t in flood:
            t.start()
        t0 = time.perf_counter()
        while metric(base, "llm_waiting_requests") < 8 or len(first) < 8:
            if time.perf_counter() - t0 > 60:
                fail("the batch flood did not fill the slots and the queue")
            time.sleep(0.01)
        t_sent, t_mono = time.perf_counter(), time.monotonic()
        inter = [threading.Thread(target=client, args=(i, "fe", 16), daemon=True)
                 for i in range(4)]
        for t in inter:
            t.start()
        for t in flood + inter:
            t.join(timeout=600)
    finally:
        del eng._note_admission
    if errors:
        fail(f"QoS drive: {errors[:3]}")
    waiting = [r for r in admitted_reqs if r.tenant == "bulk" and r.admitted_at > t_mono]
    fe = [r for r in admitted_reqs if r.tenant == "fe"]
    if len(fe) != 4 or len(admitted_reqs) != 24 or not waiting:
        fail(f"QoS drive: {len(fe)} interactive, {len(admitted_reqs)} admitted, "
             f"{len(waiting)} batch requests waiting when they were sent")
    # admission order (the spy's list) and the engine's first-token stamps:
    # an interactive request may share a prefill call with a batch one, so
    # its first token is no later than theirs, and seated before them
    order = {id(r): k for k, r in enumerate(admitted_reqs)}
    seated_first = max(order[id(r)] for r in fe) < min(order[id(r)] for r in waiting)
    i_first = max(r.first_token_at for r in fe)
    w_first = min(r.first_token_at for r in waiting)
    admitted = {p: metric(base, "llm_tenant_admitted_total", f'priority="{p}"')
                for p in ("batch", "interactive")}
    say(f"  QoS: 20 batch streams (tenant 'bulk', {QOS_BATCH_TOKENS} tokens) then 4 "
        f"interactive ('fe', 16) "
        f"sent while {len(waiting)} batch requests waited: interactive first tokens "
        f"{sorted(round((r.first_token_at - t_mono) * 1000, 1) for r in fe)} ms after sending "
        f"(clients {sorted(round((first[f'fe{i}'] - t_sent) * 1000, 1) for i in range(4))}), "
        f"the first waiting batch request's {(w_first - t_mono) * 1000:.1f} ms; admitted "
        f"{admitted}")
    if not seated_first or i_first > w_first:
        fail("an interactive request was seated, or got its first token, after a batch "
             "request that was waiting when it was sent")
    if admitted != {"batch": 20.0, "interactive": 4.0}:
        fail(f"llm_tenant_admitted_total {admitted}")
    check_graphed("QoS server", kernel_counts(base), counts0)
    status, raw = http("GET", base + "/metrics")
    path = os.path.join(OUT_DIR, "metrics_qos.txt")
    with open(path, "wb") as f:
        f.write(raw)
    lint = subprocess.run([sys.executable, os.path.join("scripts", "metrics_lint.py"), path],
                          capture_output=True, text=True, timeout=60)
    if status != 200 or lint.returncode != 0:
        fail(f"QoS /metrics: HTTP {status}; metrics_lint: {lint.stdout[-2000:]}")
    return {"waiting": len(waiting), "admitted": admitted}


# ---------------------------------------------------------------------------
# phase 6: the JAX bench's headline configuration, in process
# ---------------------------------------------------------------------------

# bench.py's headline engine (int8 weights; quantization and pace are set
# per run)
HEADLINE = dict(model=MODEL, dtype="bfloat16", max_decode_slots=64, page_size=32,
                pages_per_slot=16, num_pages=1025, prefill_buckets=(64,), async_depth=8)
HEADLINE_EARLY, HEADLINE_LATE, HEADLINE_PROMPT, HEADLINE_NEW = 56, 8, 32, 128
HEADLINE_GAP_S = 0.1
PACE = 3.0
HEADLINE_PATH = f"{MODEL} headline int8 weights pace {PACE:g}"


def param_bytes(params) -> int:
    """Bytes of a parameter tree on its device (a QTensor's data and scale)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_bytes(v) for v in params)
    if hasattr(params, "scale"):
        return params.nbytes()
    return params.numel() * params.element_size()


def headline_prompts() -> list:
    """64 distinct 32-token prompts (a 32-token prompt fills one page and
    leaves no token to prefill after a hit, so none is ever a cache hit)."""
    return [[1 + (37 * i + 11 * j + (i * j) % 7) % 250 for j in range(HEADLINE_PROMPT)]
            for i in range(HEADLINE_EARLY + HEADLINE_LATE)]


def run_headline(torch, eng, pace: float, tag: str) -> dict:
    """One run of the headline traffic through ``eng`` at ``pace``: 56
    concurrent 32-token prompts of 128 greedy tokens, an engine thread
    stepping as the server's does; once every one has its first token, 8
    more arrive 100 ms apart. The launch counters are zeroed just before
    and read just after. Held: every request finishes with its 128 tokens,
    every decode window is one graph replay, every decode-kernel launch a
    replay's, and every quantized projection one W8A16 launch (7 x
    num_layers a forward, the replays' for decode). Returns the streams,
    the launches and the numbers printed."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from llms_on_kubernetes_tpu_torch.ops.quant import QTensor

    eng.config.pace_target_steps = pace       # read at every launch
    prompts = headline_prompts()
    sp = SamplingParams(max_tokens=HEADLINE_NEW, temperature=0.0)
    # "paced" returns, and of them the deferrals: a return before the
    # window is planned (after planning it means every row's budget is in
    # flight, which happens at pace 0 too)
    launch, plan = eng._launch_decode_multi, eng._plan_window
    statuses, planned = {"paced": 0, "deferred": 0}, []

    def counted(admitted, events):
        planned.clear()
        status = launch(admitted, events)
        if status == "paced":
            statuses["paced"] += 1
            statuses["deferred"] += not planned
        return status

    def planning(events):
        planned.append(1)
        return plan(events)

    eng._launch_decode_multi, eng._plan_window = counted, planning
    stop, failed = threading.Event(), []

    def loop():
        try:
            while not stop.is_set():
                if eng.has_work():
                    eng.step()
                else:
                    time.sleep(0.0005)
        except BaseException as e:  # reported on the main thread
            failed.append(e)

    def submit(prompt) -> dict:
        rec = {"t_sub": time.perf_counter(), "t_first": None, "t_last": None}

        def on_event(payload, rec=rec):
            toks = payload[0]
            if toks:
                now = time.perf_counter()
                rec["t_first"] = rec["t_first"] or now
                rec["t_last"] = now

        rec["req"] = eng.submit(prompt, sp, on_event=on_event)
        return rec

    def wait(cond, what):
        deadline = time.perf_counter() + 300
        while not cond():
            if failed:
                fail(f"{tag}: the engine thread failed: {failed[0]!r}")
            if time.perf_counter() > deadline:
                fail(f"{tag}: {what} did not happen within 300 s")
            time.sleep(0.002)

    torch.cuda.synchronize()
    kernels.reset_launches()
    if eng.ledger is not None:
        eng.ledger.reset()
    calls0 = (eng.prefill_calls, eng.chunk_calls, eng.decode_forwards, eng.graph_replays)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        early = [submit(p) for p in prompts[:HEADLINE_EARLY]]
        wait(lambda: all(r["t_first"] for r in early), "the first tokens of 56 prompts")
        late = []
        for p in prompts[HEADLINE_EARLY:]:
            late.append(submit(p))
            time.sleep(HEADLINE_GAP_S)
        wait(lambda: all(r["req"].finished for r in early + late), "every request's end")
    finally:
        stop.set()
        th.join(timeout=60)
        del eng._launch_decode_multi, eng._plan_window
    torch.cuda.synchronize()
    launches, replayed = kernels.launch_counts(), kernels.replayed_counts()
    prefill, chunk, forwards, replays = (now - then for now, then in zip(
        (eng.prefill_calls, eng.chunk_calls, eng.decode_forwards, eng.graph_replays), calls0))
    recs = early + late
    for r in recs:
        req = r["req"]
        if req.finish_reason != "length" or len(req.output) != HEADLINE_NEW:
            fail(f"{tag}: a request finished {req.finish_reason!r} with {len(req.output)} "
                 f"tokens, expected {HEADLINE_NEW}")
    if replays < 1 or replays * eng.config.decode_steps != forwards:
        fail(f"{tag}: {replays} graph replays for {forwards} decode forwards")
    dec = {k: n for k, n in launches.items() if k.startswith("paged_decode")}
    if not dec or dec != {k: replayed.get(k, 0) for k in dec}:
        fail(f"{tag}: decode kernel launches {dec}, by replays {replayed}: some ran eagerly")
    L = eng.model_config.num_layers
    quantized = isinstance(eng.params["layers"]["wq"], QTensor)
    want_w8 = 7 * L * (prefill + chunk + forwards) if quantized else 0
    if launches.get("w8_matmul", 0) != want_w8 or (
            quantized and replayed.get("w8_matmul", 0) != 7 * L * forwards):
        fail(f"{tag}: w8_matmul launched {launches.get('w8_matmul', 0)} times "
             f"({replayed.get('w8_matmul', 0)} by replays), expected 7 x {L} layers x "
             f"{prefill + chunk + forwards} forwards = {want_w8}")
    tokens = sum(len(r["req"].output) - 1 for r in recs)
    span = max(r["t_last"] for r in recs) - min(r["t_first"] for r in recs)
    ttft = [1e3 * (r["t_first"] - r["t_sub"]) for r in late]
    out = dict(decode_tps=tokens / span, ttft_p50_ms=float(np.median(ttft)),
               ttft_max_ms=max(ttft), paced=statuses["paced"],
               deferred=statuses["deferred"], launches=launches,
               streams=[r["req"].output for r in recs], prefill_calls=prefill,
               decode_forwards=forwards, graph_replays=replays,
               est_step_ms=1e3 * eng._est_step)
    say(f"headline {tag}: decode {out['decode_tps']:.1f} tok/s; late-arrival TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms, max {out['ttft_max_ms']:.1f} ms; {statuses['paced']} "
        f"paced returns, {statuses['deferred']} of them pacing deferrals; {prefill} prefill "
        f"calls, {forwards} decode forwards in {replays} graph replays; est step "
        f"{out['est_step_ms']:.2f} ms; w8_matmul launches "
        f"{launches.get('w8_matmul', 0)} [{card_line()}]")
    if eng.ledger is not None:
        out["ledger"] = ledger_report(eng.ledger, f"headline {tag}")
    return out


def phase_headline(torch) -> dict:
    """The JAX bench's headline configuration (bench.py:2998-3037):
    llama-3-8b, int8 weights, 64 slots, page 32, bucket 64, async depth 8,
    pace 3, random weights; runs in turns at pace 3, 0, 0, 3 on one engine,
    then bf16 weights at pace 3; and one int8-weight window replayed
    against the eager window (``window_vs_eager``). Returns the first int8
    pace-3 run (the W8A16 kernel's path) and the numbers."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(**HEADLINE, quantization="int8", pace_target_steps=PACE))
    torch.cuda.synchronize()
    wbytes = param_bytes(eng.params)
    say(f"headline: {MODEL} int8 weights ({wbytes / 1e9:.2f} GB on the card), engine built "
        f"in {time.perf_counter() - t0:.1f} s (random weights, quantization, pool, capture)")
    runs = {}
    for i, pace in enumerate((PACE, 0.0, 0.0, PACE)):
        runs[(pace, i)] = run_headline(torch, eng, pace, f"int8 pace {pace:g} (run {i + 1})")
    window_vs_eager(torch, eng, "headline int8 weights (64 slots, page 32), graph vs eager",
                    headline_prompts()[:3])
    del eng
    torch.cuda.empty_cache()
    bf16 = Engine(EngineConfig(**HEADLINE, pace_target_steps=PACE))
    runs["bf16"] = run_headline(torch, bf16, PACE, f"bf16 weights pace {PACE:g}")
    del bf16
    torch.cuda.empty_cache()
    p3, p0 = runs[(PACE, 0)], runs[(0.0, 1)]
    same = sum(a == b for a, b in zip(p3["streams"], p0["streams"]))
    say(f"headline: int8 streams equal between pace 3 and pace 0: {same} of "
        f"{len(p3['streams'])} (reported, not held: the bf16 attention and LM head follow "
        f"the batch shape)")
    say(f"headline phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": p3["launches"], "runs": runs}


def phase_checkpoint_int8(torch, cfg) -> None:
    """The phase-5 phi-3-mini checkpoint loaded with ``quantization="int8"``
    in process: load seconds, weight bytes on the card, a short greedy
    stream through an engine (every projection a W8A16 launch)."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params
    from llms_on_kubernetes_tpu_torch.ops.quant import QTensor

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_hf_params(cfg, CKPT_DIR, device="cuda", quantization="int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    layers = params["layers"]
    if not all(isinstance(layers[n], QTensor) for n in ("wq", "wk", "wv", "wo", "w_gate",
                                                         "w_up", "w_down")):
        fail("checkpoint int8: the projections did not load as QTensors")
    wbytes = param_bytes(params)
    eng = Engine(EngineConfig(model=CKPT_MODEL, pages_per_slot=CKPT_PPS, quantization="int8",
                              device="cuda"), model_config=cfg, params=params)
    kernels.reset_launches()
    out = eng.generate([1 + (7 * i) % 200 for i in range(40)],
                       SamplingParams(max_tokens=16, temperature=0.0))
    torch.cuda.synchronize()
    w8 = kernels.launch_counts().get("w8_matmul", 0)
    if len(out) != 16 or not w8:
        fail(f"checkpoint int8: {len(out)} tokens, {w8} w8_matmul launches")
    say(f"checkpoint int8: {CKPT_MODEL} loaded with quantization=int8 in {load_s:.2f} s, "
        f"{wbytes / 1e9:.2f} GB of weights on the card; greedy stream of 16 tokens "
        f"{out[:8]}..., {w8} w8_matmul launches [{card_line()}]")
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 7: speculative decoding and GGUF checkpoints
# ---------------------------------------------------------------------------

SPEC_PATH = f"{MODEL} speculation ngram bf16"
SPEC_INT8_PATH = f"{MODEL} speculation ngram int8 weights int8 KV fused"
DRAFT_PATH = f"{MODEL} speculation draft {MODEL}"
GGUF_DRAFT_PATH = f"{MODEL} speculation draft Llama-3.2-1B Q8_0 GGUF"
GGUF_DIR = os.path.join(OUT_DIR, "gguf")
GGUF_SERVED = ("tinyllama-1.1b", "phi-3-mini")
GGUF_SERVED_LAYERS = 4       # the served files' depth, cut for the run's time (widths stay)
SPEC_NEW = 128               # tokens a phase 7 A request generates
DRAFT_NEW = 48               # B: a 16-token prompt and 48 tokens stay in the draft's window
# the dispatches a committed token may cost at full accept (JAX's bound)
SPEC_DISPATCH_BOUND = 0.286
BYTE_EOS = 257
GUIDED_BYTE_STEER = ((BYTE_EOS, 100.0), (ord("}"), 60.0), (ord(","), 40.0),
                     (ord('"'), 30.0), (ord(":"), 28.0), (ord("{"), 25.0), (ord("1"), 20.0))


class SpecTimer:
    """CUDA events around each window replay and each verify replay of one
    engine's ``DecodeWindow``: the device time of a window and of a verify
    (the copy of the rows in, then the replay)."""

    def __init__(self, torch, win):
        self.torch, self.win = torch, win
        self.events = {"window": [], "verify": []}
        for kind, name in (("window", "run"), ("verify", "run_verify")):
            setattr(win, name, self._timed(kind, getattr(win, name)))

    def _timed(self, kind, fn):
        torch = self.torch

        def call(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.events[kind].append((e0, e1))
            return out
        return call

    def close(self) -> dict:
        self.torch.cuda.synchronize()
        del self.win.run, self.win.run_verify
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


class PolicyLog:
    """The draft attempts ``SpecPolicy`` saw (spec dispatches and empty
    drafts) and the attempt at which it first demoted drafting."""

    def __init__(self, policy):
        self.policy, self.attempts, self.demoted_at = policy, 0, None
        for name in ("note", "note_empty"):
            setattr(policy, name, self._logged(getattr(policy, name)))

    def _logged(self, fn):
        def call(*a):
            fn(*a)
            self.attempts += 1
            if self.policy._demoted and self.demoted_at is None:
                self.demoted_at = self.attempts
        return call

    def close(self) -> tuple:
        del self.policy.note, self.policy.note_empty
        return self.attempts, self.demoted_at


def med(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def spec_run(torch, eng, prompts, sps) -> dict:
    """Every prompt through ``eng`` at once (``sps``: one SamplingParams a
    prompt), stepped until it drains, with a fresh ``SpecPolicy`` and the
    launch counters zeroed just before and read just after. Returns the
    streams and their logprobs, decode tokens/s (tokens after each first
    one, over the time from the first first-token to the last finish), the
    engine's speculation counters' deltas, the policy's attempts and
    demotion, the window and verify device ms, and the launches."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.speculation import SpecPolicy

    c0 = (eng.spec_dispatches, eng.spec_drafted_tokens, eng.spec_accepted_tokens,
          eng.verify_replays, eng.decode_dispatches)
    eng.steps_obs.clear()
    plog = None
    if eng._spec is not None:
        eng._spec.policy = SpecPolicy()
        plog = PolicyLog(eng._spec.policy)
    timer = SpecTimer(torch, eng._window)
    kernels.reset_launches()
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    launches, replayed = kernels.launch_counts(), kernels.replayed_counts()
    ev = timer.close()
    attempts, demoted_at = plog.close() if plog is not None else (0, None)
    for r in reqs:
        if r.finish_reason not in ("length", "stop"):
            fail(f"a phase 7 request finished {r.finish_reason}")
    first = min(r.first_token_at for r in reqs)
    last = max(r.finished_at for r in reqs)
    d = [b - a for a, b in zip(c0, (eng.spec_dispatches, eng.spec_drafted_tokens,
                                    eng.spec_accepted_tokens, eng.verify_replays,
                                    eng.decode_dispatches))]
    return {"outs": [(list(r.output), r.finish_reason) for r in reqs],
            "lps": [list(r.output_logprobs) for r in reqs],
            "tok_s": sum(len(r.output) - 1 for r in reqs) / max(last - first, 1e-9),
            "spec": d[0], "drafted": d[1], "accepted": d[2], "verify_replays": d[3],
            "dispatches": d[4], "steps": list(eng.steps_obs), "attempts": attempts,
            "demoted_at": demoted_at, "verify_ms": ev["verify"], "window_ms": ev["window"],
            "launches": launches, "replayed": replayed}


def sampled_flip(ref, ref_lps, got, got_lps, temperature: float, noise_row):
    """``flip_margin`` for a seeded sampled stream: None when ``got`` equals
    ``ref``; else (position, nats, bound) at the first difference. The
    sample is the argmax over the top candidates of logprob / temperature +
    Gumbel noise keyed on the candidate's rank (``noise_row(position)``,
    recomputed on the card); a flip between two rounding paths of the same
    history is a near-tie either in that perturbed score (its gap x
    temperature) or in the rank order itself (``got``'s logprob next to a
    neighbouring rank's, which swaps their noise; a ``got`` outside the
    reference's candidates crossed the top-k cut: its logprob, by ``got``'s
    own run, next to the reference's last candidate's). The smaller gap is
    held to the greedy bound, 2 x BF16_REL_TOL x |logprob|."""
    if got == ref:
        return None
    i = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), min(len(ref), len(got)))
    if i >= len(ref) or i >= len(got) or ref_lps[i] is None:
        return i, float("inf"), 0.0
    lp, top_ids, top_lps = ref_lps[i]
    ids = list(top_ids)
    bound = round(2 * BF16_REL_TOL * abs(lp), 4)
    if ref[i] not in ids:
        return i, float("inf"), bound
    if got[i] not in ids:
        g_lp = got_lps[i][0] if got_lps[i] is not None else float("inf")
        return i, round(float(abs(g_lp - top_lps[-1])), 4), bound
    r_ref, r_got = ids.index(ref[i]), ids.index(got[i])
    g = noise_row(i)
    score = temperature * (top_lps[r_ref] / temperature + g[r_ref]
                           - top_lps[r_got] / temperature - g[r_got])
    swap = min(abs(top_lps[r_got] - top_lps[j]) for j in (r_got - 1, r_got + 1)
               if 0 <= j < len(top_lps))
    return i, round(float(min(abs(score), swap)), 4), bound


def hold_streams(tag: str, ref_run: dict, got_run: dict, sampled=None) -> int:
    """Each stream of ``got_run`` equals ``ref_run``'s, or first differs at
    a near-tie (``flip_margin``, or ``sampled_flip`` for seeded rows:
    ``sampled`` = (temperature, noise_row(stream, position))). Returns the
    streams that differ."""
    flips = []
    for k, ((ref, _fr), lps, (got, _fg), g_lps) in enumerate(
            zip(ref_run["outs"], ref_run["lps"], got_run["outs"], got_run["lps"])):
        if sampled is None:
            m = flip_margin(ref, lps, got)
        else:
            m = sampled_flip(ref, lps, got, g_lps, sampled[0],
                             lambda i, k=k: sampled[1](k, i))
        if m is not None:
            if m[1] > m[2]:
                fail(f"{tag}: stream {k} differs first at token {m[0]} by {m[1]} nats, past "
                     f"the near-tie bound {m[2]}")
            flips.append((k, *m))
    if flips:
        say(f"  {tag}: {len(flips)} of {len(ref_run['outs'])} streams differ, each first at "
            f"a near-tie (stream, token, nats, bound): {flips}")
    return len(flips)


def verify_vs_eager(torch, eng, tag: str, grammar=None) -> None:
    """One verify replayed (the engine's verify graph; with ``grammar`` on
    every other row, the FSM verify graph) and one run eagerly
    (``DecodeWindow._eager_verify``), from copies of one pool and one
    penalty-count table (and FSM state): seeded sampled rows with
    penalties, the even rows pinned by +90 on a token they are drafted
    (accepted), the odd ones drafted random tokens (rejected). Tokens,
    accept counts, logprobs, pools (outside each layer's trash page),
    counts and FSM states byte-equal. The rows are aborted after."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from llms_on_kubernetes_tpu_torch.engine.graphs import unpack_accept, verify_rows

    B, K = eng.config.max_decode_slots, eng.config.decode_steps
    rng = np.random.default_rng(71)
    pins = [int(t) for t in rng.integers(300, 120_000, B)]
    reqs = []
    for i in range(B):
        sp = dict(max_tokens=64, temperature=0.7, seed=5 + i, presence_penalty=0.4,
                  frequency_penalty=0.3)
        if grammar is not None and i % 2:
            sp.update(grammar=grammar, stop_token_ids=(BYTE_EOS,),
                      logit_bias=GUIDED_BYTE_STEER)
        elif i % 2 == 0:
            sp["logit_bias"] = ((pins[i], 90.0),)
        reqs.append(eng.submit([int(t) for t in rng.integers(1, 128_000, 40 + 3 * i)],
                               SamplingParams(**sp)))
    eng._admit()                   # sync admission: first tokens read
    active = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    base = {i: int(eng.slot_len[i]) + 1 for i, _r in active}
    for i, _r in active:
        eng.allocator.allocate(i, base[i] + K - 1)
    packed = eng._window_rows(active, {i: K for i, _r in active}, base)
    drafts = np.full((B, K - 1), -1, np.int32)
    for i, r in active:
        drafts[i] = pins[i] if i % 2 == 0 else rng.integers(300, 120_000, K - 1)
    full = verify_rows(packed, drafts)
    pools = [KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
             for p in (eng.k_pages, eng.v_pages)]
    counts = eng.token_counts.clone()
    fsm = (eng._fsm_state.clone(), *eng._g_dev) if grammar is not None else None
    eager_pack, eager_toks = eng._window._eager_verify(torch.from_numpy(full).cuda(), *pools,
                                                       counts, fsm=fsm)
    n0, f0 = eng._window.verify_replays, eng._window.fsm_verify_replays
    pack, toks = eng._window.run_verify(full, use_fsm=grammar is not None)
    torch.cuda.synchronize()
    if (eng._window.verify_replays - n0, eng._window.fsm_verify_replays - f0) != \
            (1, int(grammar is not None)):
        fail(f"{tag}: the verify did not replay the graph it was asked for")
    if not (torch.equal(pack, eager_pack) and torch.equal(toks, eager_toks)):
        fail(f"{tag}: tokens, accept counts or logprobs differ between the verify replay and "
             f"the eager verify")
    if not torch.equal(eng.token_counts, counts):
        fail(f"{tag}: penalty counts differ between the verify replay and the eager verify")
    if fsm is not None and not torch.equal(eng._fsm_state, fsm[0]):
        fail(f"{tag}: FSM states differ between the verify replay and the eager verify")
    P = eng.config.num_pages
    keep = torch.ones(eng.model_config.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False
    for got, want in zip((eng.k_pages, eng.v_pages), pools):
        if not torch.equal(got.data[:, keep], want.data[:, keep]) or (
                want.scale is not None
                and not torch.equal(got.scale[:, keep], want.scale[:, keep])):
            fail(f"{tag}: pools differ between the verify replay and the eager verify")
    accept = unpack_accept(pack.cpu().numpy(), B)[1]
    if not (accept[0::2] == K).all() or accept[1::2].max() > (1 if grammar is None else K):
        fail(f"{tag}: accept counts {accept.tolist()}: the pinned rows must take every "
             f"draft")
    say(f"  {tag}: one verify ({K} positions, {B} sampled rows with penalties"
        f"{', every other one constrained' if grammar is not None else ''}; accept "
        f"{accept.tolist()}) replayed equals the eager verify: tokens, accept, logprobs, "
        f"pools and counts{', FSM states' if grammar is not None else ''} byte-equal")
    for r in reqs:
        eng.abort(r)
    while eng.has_work():
        eng.step()


def verify_attention_ms(torch, eng) -> float:
    """Device ms of one layer's plain ``chunk_attention`` at the verify's
    shape (every slot, K positions, the full page table: the gather reads
    each slot's ``pages_per_slot`` pages), ``Timer``'d on the engine's
    pool."""
    from llms_on_kubernetes_tpu_torch.ops.attention import dispatch_chunk_attention

    cfg = eng.model_config
    B, K, pps = eng.config.max_decode_slots, eng.config.decode_steps, eng.config.pages_per_slot
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, K, cfg.num_heads, cfg.head_dim), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    table = (1 + torch.arange(B * pps, dtype=torch.int32, device="cuda").view(B, pps)
             % (eng.config.num_pages - 1))
    hist = torch.full((B,), pps * eng.config.page_size - K, dtype=torch.int32, device="cuda")
    w = torch.full((B,), K, dtype=torch.int32, device="cuda")
    return Timer(torch)(lambda: dispatch_chunk_attention(
        q, eng.k_pages, eng.v_pages, table, hist, w, scale=cfg.head_dim ** -0.5))


def pinned_prompts(rng, n: int, length: int, pin_base: int = 1000) -> tuple:
    """``n`` prompts of ``length`` random ids ending in four copies of a
    per-prompt pin, and the pins."""
    pins = [pin_base + 97 * i for i in range(n)]
    return [[int(t) for t in rng.integers(1, 120_000, length - 4)] + [p] * 4
            for p in pins], pins


def spec_turns(torch, off, on, tag: str, prompts, sps, exact: bool,
               sampled=None) -> tuple[list, list]:
    """One case in turns: off, on, on, off (prefix caching makes a second
    run warm: each on run is held against the off run of its temperature,
    cold against cold, warm against warm). ``exact``: streams equal, else
    equal or first apart at a near-tie. Returns (the on runs, the off
    runs)."""
    runs = [spec_run(torch, e, prompts, sps) for e in (off, on, on, off)]
    for ref, got in ((runs[0], runs[1]), (runs[3], runs[2])):
        if exact:
            if got["outs"] != ref["outs"]:
                fail(f"{tag}: the streams with speculation differ from those without")
        else:
            hold_streams(tag, ref, got, sampled)
    for run in (runs[1], runs[2]):
        if run["verify_replays"] != run["spec"]:
            fail(f"{tag}: {run['spec']} verify dispatches, {run['verify_replays']} graph "
                 f"replays")
    say(f"  {tag}: decode tok/s off {runs[0]['tok_s']:.1f}, on {runs[1]['tok_s']:.1f}, on "
        f"{runs[2]['tok_s']:.1f}, off {runs[3]['tok_s']:.1f}; verify dispatches "
        f"{runs[1]['spec']}/{runs[2]['spec']} of {runs[1]['dispatches']}/"
        f"{runs[2]['dispatches']}, drafted {runs[1]['drafted']}, accepted "
        f"{runs[1]['accepted']} (ratio {runs[1]['accepted'] / max(1, runs[1]['drafted']):.3f});"
        f" policy attempts {runs[1]['attempts']}, demoted at attempt "
        f"{runs[1]['demoted_at']}; device ms a verify {med(runs[1]['verify_ms']):.2f} "
        f"(median of {len(runs[1]['verify_ms'])}), a window on {med(runs[1]['window_ms']):.2f}"
        f", off {med(runs[0]['window_ms']):.2f} ({card_line()})")
    return [runs[1], runs[2]], [runs[0], runs[3]]


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def check_verify_launches(tag: str, runs: list, num_layers: int, window_kernel: str) -> dict:
    """The verify path launched ``window_kernel`` num_layers times a verify,
    every one of them a replay's (the chunk path's eager ones aside)."""
    launches, replayed, verifies = {}, {}, 0
    for run in runs:
        add_counts(launches, run["launches"])
        add_counts(replayed, run["replayed"])
        verifies += run["verify_replays"]
    if not verifies or replayed.get(window_kernel, 0) != num_layers * verifies:
        fail(f"{tag}: {window_kernel} replayed {replayed.get(window_kernel, 0)} times over "
             f"{verifies} verifies of {num_layers} layers")
    say(f"  {tag}: launches {launches}, of them by graph replays {replayed} ({verifies} "
        f"verifies)")
    return launches


def seeded_noise(torch, eng, prompts, run):
    """noise_row(stream, position) for ``sampled_flip``: the Gumbel row the
    engine drew for that stream's token (keyed on the engine seed, the
    request's seed and the position prompt length + token index)."""
    from llms_on_kubernetes_tpu_torch.engine.sampling import MAX_CANDIDATES, gumbel_noise

    def row(k: int, i: int) -> list:
        seed = torch.tensor([run["seeds"][k]], dtype=torch.int32, device="cuda")
        pos = torch.tensor([len(prompts[k]) + i], dtype=torch.int32, device="cuda")
        return gumbel_noise(eng.config.seed, seed, pos, MAX_CANDIDATES)[0].tolist()
    return row


def phase_spec_lookup(torch, params) -> dict:
    """A. Prompt-lookup speculation on llama-3-8b bf16, the default
    EngineConfig, in process: an engine without and one with speculation
    on the same weights, each case in turns (off, on, on, off)."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.engine.grammar import (
        compile_response_format, token_bytes_of,
    )
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
    from llms_on_kubernetes_tpu_torch.ops.quant import quantize_params

    L = get_config(MODEL).num_layers
    rng = np.random.default_rng(77)
    off = Engine(EngineConfig(model=MODEL), params=params)
    on = Engine(EngineConfig(model=MODEL, speculation="ngram"), params=params)
    verify_vs_eager(torch, on, "A verify graph against eager")
    out = {}
    # A1: full accept
    p1, pins = pinned_prompts(rng, 8, 32)
    sp1 = [SamplingParams(temperature=0.0, max_tokens=SPEC_NEW, logit_bias=((p, 90.0),))
           for p in pins]
    on_runs, off_runs = spec_turns(torch, off, on, "A1 full accept", p1, sp1, exact=True)
    for run in on_runs:
        ratio = len(run["steps"]) / max(1, sum(run["steps"]))
        if not run["drafted"] or run["accepted"] != run["drafted"]:
            fail(f"A1: accepted {run['accepted']} of {run['drafted']} drafted, not all")
        if ratio > SPEC_DISPATCH_BOUND:
            fail(f"A1: {ratio:.3f} dispatches a committed token, past {SPEC_DISPATCH_BOUND}")
    say(f"  A1: {len(on_runs[0]['steps'])} dispatches for {sum(on_runs[0]['steps'])} row "
        f"tokens: {len(on_runs[0]['steps']) / sum(on_runs[0]['steps']):.3f} a token")
    att = verify_attention_ms(torch, on)
    say(f"  A: the verify's plain chunk_attention (8 slots, 4 positions, 32 pages of 64 a "
        f"slot): {att:.3f} ms a layer, x {L} layers = {att * L:.2f} ms of a verify's "
        f"{med(on_runs[0]['verify_ms']):.2f} (Timer, L2 flushed; {card_line()})")
    out["A1"] = on_runs + off_runs
    # A2: lookup-friendly traffic: ~600 tokens of one repeated 40-token span
    p2 = []
    for _ in range(8):
        span = [int(t) for t in rng.integers(1, 120_000, 40)]
        p2.append(span * 15)
    sp2 = [SamplingParams(temperature=0.0, max_tokens=SPEC_NEW, logprobs=1)] * 8
    on_runs, off_runs = spec_turns(torch, off, on, "A2 lookup-friendly", p2, sp2, exact=False)
    out["A2"] = on_runs + off_runs
    # A3: adversarial: random prompts
    p3 = [[int(t) for t in rng.integers(1, 120_000, 128)] for _ in range(8)]
    on_runs, off_runs = spec_turns(torch, off, on, "A3 adversarial", p3, sp2, exact=False)
    out["A3"] = on_runs + off_runs
    # A4: seeded sampling with penalties on the lookup-friendly prompts
    seeds = [100 + i for i in range(8)]
    sp4 = [SamplingParams(temperature=0.9, top_k=8, seed=s, presence_penalty=0.3,
                          frequency_penalty=0.2, max_tokens=SPEC_NEW) for s in seeds]
    runs4 = {"seeds": seeds}
    on_runs, off_runs = spec_turns(torch, off, on, "A4 seeded sampling", p2, sp4, exact=False,
                                   sampled=(0.9, seeded_noise(torch, off, p2, runs4)))
    out["A4"] = on_runs + off_runs
    # guided: 4 pinned free rows beside 4 rows under a JSON schema (byte grammar)
    g = compile_response_format({"type": "json_schema", "json_schema": {
        "schema": GUIDED_SCHEMA}}, token_bytes_of(ByteTokenizer()), [BYTE_EOS])
    verify_vs_eager(torch, on, "A FSM verify graph against eager", grammar=g)
    f0 = on._window.fsm_verify_replays
    sp_g = [SamplingParams(temperature=0.0, max_tokens=96, grammar=g,
                           stop_token_ids=(BYTE_EOS,), logit_bias=GUIDED_BYTE_STEER)
            if i % 2 else sp1[i] for i in range(8)]
    run_g = spec_run(torch, on, p1, sp_g)
    for k in range(1, 8, 2):
        toks, reason = run_g["outs"][k]
        st = g.start
        for t in toks:
            st = g.next_state(st, t) if st >= 0 else st
        text = bytes(t for t in toks if t < 256).decode("utf-8", errors="replace")
        try:
            obj = json.loads(text)
        except ValueError:
            fail(f"A guided row {k}: {text!r} ({reason}) does not parse")
        if st < 0 or reason != "stop":
            fail(f"A guided row {k}: left its grammar or did not finish: {text!r}")
        guided_answer(f"A guided row {k}", {"choices": [{"finish_reason": reason, "message": {
            "content": json.dumps(obj)}}]}, "schema")
    if on._window.fsm_verify_replays == f0:
        fail("A guided: no verify replayed the FSM verify graph")
    say(f"  A guided: 4 schema answers valid beside 4 pinned rows; FSM verify replays "
        f"{on._window.fsm_verify_replays - f0}, verifies {run_g['spec']}")
    launches = check_verify_launches("A (bf16)", out["A1"][:2] + out["A2"][:2] + out["A3"][:2]
                                     + out["A4"][:2], L, "paged_write_window")
    del off, on
    gc.collect()
    # A5: case 1 with int8 weights, int8 KV and kv_write fused
    q = quantize_params(params)
    kw = dict(model=MODEL, quantization="int8", kv_cache_dtype="int8", kv_write="fused")
    off = Engine(EngineConfig(**kw), params=q)
    on = Engine(EngineConfig(**kw, speculation="ngram"), params=q)
    verify_vs_eager(torch, on, "A5 int8 verify graph against eager")
    on_runs, off_runs = spec_turns(torch, off, on, "A5 full accept, int8", p1, sp1, exact=True)
    for run in on_runs:
        if not run["drafted"] or run["accepted"] != run["drafted"]:
            fail(f"A5: accepted {run['accepted']} of {run['drafted']} drafted, not all")
    launches8 = check_verify_launches("A5 (int8)", on_runs, L, "paged_write_window_int8")
    for k in ("w8_matmul", "paged_decode_write_int8"):
        if not launches8.get(k):
            fail(f"A5: {k} never launched")
    out["A5"] = on_runs + off_runs
    del off, on, q
    free_card(torch, "phase 7 A")
    return {"runs": out, "launches": launches, "launches_int8": launches8}


class TimedGraph:
    """CUDA events around each replay of a captured graph (the draft
    rollout's)."""

    def __init__(self, torch, graph):
        self.torch, self.graph, self.ms = torch, graph, []
        self.events = []

    def replay(self):
        e0, e1 = self.torch.cuda.Event(enable_timing=True), self.torch.cuda.Event(
            enable_timing=True)
        e0.record()
        self.graph.replay()
        e1.record()
        self.events.append((e0, e1))

    def close(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def draft_case(torch, off_run, eng, prompts, sps, tag: str) -> dict:
    """One draft-tier run against the off run: streams equal or first
    apart at a near-tie, every rollout one graph replay (timed) and every
    verify one."""
    drafter = eng._spec.drafter
    drafter.propose(np.asarray(prompts[0], np.int32), 1)     # captures the rollout
    timed = drafter.graph = TimedGraph(torch, drafter.graph)
    r0 = drafter.replays
    run = spec_run(torch, eng, prompts, sps)
    rollout_ms = timed.close()
    drafter.graph = timed.graph
    hold_streams(tag, off_run, run)
    if drafter.replays - r0 != len(rollout_ms) or run["verify_replays"] != run["spec"] or \
            not run["spec"]:
        fail(f"{tag}: {drafter.replays - r0} rollouts, {len(rollout_ms)} timed, "
             f"{run['spec']} verifies, {run['verify_replays']} verify replays")
    say(f"  {tag}: decode tok/s {run['tok_s']:.1f} (off {off_run['tok_s']:.1f}); verifies "
        f"{run['spec']} of {run['dispatches']} dispatches, drafted {run['drafted']}, accepted "
        f"{run['accepted']} (ratio {run['accepted'] / max(1, run['drafted']):.3f}); "
        f"rollouts {len(rollout_ms)}, device ms a rollout {med(rollout_ms):.2f} (median), "
        f"the rollout graph captured in {drafter.capture_s:.2f} s; policy attempts "
        f"{run['attempts']}, demoted at attempt {run['demoted_at']}; device ms a verify "
        f"{med(run['verify_ms']):.2f} ({card_line()})")
    run["rollout_ms"] = rollout_ms
    return run


def phase_spec_draft(torch, params, path: str) -> dict:
    """B. The draft tier: llama-3-8b drafting for itself (by registry name,
    the target's seed: the same weights), then the Llama-3.2-1B-width Q8_0
    GGUF draft at ``path``."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams

    rng = np.random.default_rng(78)
    prompts = [[int(t) for t in rng.integers(1, 120_000, 16)] for _ in range(8)]
    sps = [SamplingParams(temperature=0.0, max_tokens=DRAFT_NEW, logprobs=1)] * 8
    off = Engine(EngineConfig(model=MODEL), params=params)
    off_run = spec_run(torch, off, prompts, sps)
    del off
    gc.collect()
    eng = Engine(EngineConfig(model=MODEL, speculation="draft", draft_model=MODEL),
                 params=params)
    same = draft_case(torch, off_run, eng, prompts, sps, f"B {MODEL} drafting for itself")
    if same["accepted"] < 0.5 * same["drafted"]:
        fail(f"B: the target drafting for itself accepted {same['accepted']} of "
             f"{same['drafted']}")
    del eng
    free_card(torch, "phase 7 B self-draft")
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(model=MODEL, speculation="draft", draft_model=path),
                 params=params)
    say(f"  B: engine with the GGUF draft built in {time.perf_counter() - t0:.1f} s")
    small = draft_case(torch, off_run, eng, prompts, sps, "B Llama-3.2-1B Q8_0 GGUF draft")
    del eng
    os.remove(path)
    free_card(torch, "phase 7 B GGUF draft")
    return {"self": same, "gguf": small}


class RssPeak:
    """This process's resident set sampled every 20 ms on a thread
    (``/proc/self/statm``): ``close()`` gives (GB at the start, the peak's
    GB above it)."""

    def __init__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def close(self) -> tuple:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        return self.start / 1e9, (self.peak - self.start) / 1e9


def hold_gguf_params(torch, path: str, cfg, params) -> None:
    """Layers 0 and L - 1, the embedding, the final norm and the head of
    ``params`` (on the card) equal the file's dequantized values cast to
    bf16, bit for bit."""
    from llms_on_kubernetes_tpu_torch.engine.gguf import GGUFFile, gguf_layer

    gf = GGUFFile(path)

    def same(name: str, got, want: np.ndarray) -> None:
        w = torch.from_numpy(np.ascontiguousarray(want)).to("cuda").to(torch.bfloat16)
        if got.shape != w.shape or not torch.equal(got.view(torch.int16), w.view(torch.int16)):
            fail(f"{path}: {name} differs from the file's values cast to bf16")
    for i in (0, cfg.num_layers - 1):
        for name, want in gguf_layer(gf, cfg, i).items():
            same(f"layer {i} {name}", params["layers"][name][i], want)
    same("embed", params["embed"], gf.tensor("token_embd.weight"))
    same("final_norm", params["final_norm"], gf.tensor("output_norm.weight"))
    if not cfg.tie_word_embeddings:
        same("lm_head", params["lm_head"], gf.tensor("output.weight").T)
    gf.close()


def gguf_in_process(torch, path: str) -> dict:
    """The bf16 server of a .gguf in this process, built by ``serve``'s own
    GGUF branch (``_gguf_engine``: config, weights and the embedded
    tokenizer from the file; timed, with the host's resident set sampled),
    its params held to the file, then driven as ``_drive_gguf`` drives a
    server."""
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer, _gguf_engine

    ecfg = engine_config_from_args(build_parser().parse_args(["serve", *POOL_ARGS, "--model",
                                                              path]))
    rss = RssPeak()
    t0 = time.perf_counter()
    eng, tok, load_s, _src = _gguf_engine(path, ecfg, torch.device("cuda"), False, None)
    srv = OpenAIServer(eng, tok, eng.model_config.name, cold_start={"load": load_s})
    base = f"http://127.0.0.1:{srv.start()}"
    ready_s = time.perf_counter() - t0
    rss_start, rss_peak = rss.close()
    cfg = eng.model_config
    try:
        hold_gguf_params(torch, path, cfg, eng.params)
        out = _drive_gguf(path, cfg, False)(base, None)
        nbytes = param_bytes(eng.params)
    finally:
        srv.close()
    del srv, eng
    free_card(torch, f"{os.path.basename(path)} in process")
    say(f"  {os.path.basename(path)}: {cfg.name} ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, vocab {cfg.vocab_size}) served in process through serve's GGUF "
        f"branch: dequantized and uploaded in {load_s:.1f} s, serving after {ready_s:.1f} s, "
        f"{nbytes / 1e9:.2f} GB on the card, the host's resident set peaking {rss_peak:.2f} GB "
        f"above its {rss_start:.2f} GB at the start; layers 0 and {cfg.num_layers - 1}, the "
        f"embedding, the norm and the head equal the file's values cast to bf16; chat "
        f"{out['usage']}: {out['answer'][:60]!r}; launches {out['launches']} ({card_line()})")
    return {**out, "cfg": cfg, "load_s": load_s, "ready_s": ready_s, "rss_peak_gb": rss_peak}


def _drive_gguf(path: str, cfg, int8: bool):
    """Drive a GGUF server: one chat completion through the embedded
    tokenizer and template (its prompt_tokens the template's count), the
    launch counters zeroed before and read after, every window a graph
    replay; with int8 weights every projection one W8A16 launch."""
    from llms_on_kubernetes_tpu_torch.engine.gguf import GGUFFile
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import GGUFTokenizer

    gf = GGUFFile(path)
    tok = GGUFTokenizer(gf.metadata)
    gf.close()
    msgs = [{"role": "user", "content": "Name three colours of the rainbow."}]
    want_prompt = len(tok.apply_chat_template(msgs))

    def drive(base: str, _proc) -> dict:
        http("POST", base + "/debug/kernels/reset")
        k0 = kernel_counts(base)
        status, body = http("POST", base + "/v1/chat/completions",
                            {"messages": msgs, "max_tokens": 16, "temperature": 0})
        if status != 200:
            fail(f"{path}: chat completion HTTP {status}: {body[:300]!r}")
        d = json.loads(body)
        usage = d["usage"]
        if usage["prompt_tokens"] != want_prompt or usage["completion_tokens"] < 1:
            fail(f"{path}: usage {usage}, the embedded template gives {want_prompt} prompt "
                 f"tokens")
        k1 = kernel_counts(base)
        check_graphed(os.path.basename(path), k1, k0)
        launches = k1["launches"]
        forwards = (k1["prefill_calls"] + k1["chunk_calls"] + k1["decode_forwards"]
                    - k0["prefill_calls"] - k0["chunk_calls"] - k0["decode_forwards"])
        if int8 and launches.get("w8_matmul", 0) != 7 * cfg.num_layers * forwards:
            fail(f"{path} int8: w8_matmul launched {launches.get('w8_matmul', 0)} times for "
                 f"{forwards} forwards of {cfg.num_layers} layers")
        if not int8 and launches.get("w8_matmul"):
            fail(f"{path}: the bf16 server launched w8_matmul")
        return {"launches": launches, "answer": d["choices"][0]["message"]["content"],
                "usage": usage}
    return drive


def start_gguf_writes() -> dict:
    """Write phase 7's GGUF files with ``testing/synth_gguf.py``, one
    process each, started at once (they overlap phase 7 A): preset ->
    (path, process)."""
    os.makedirs(GGUF_DIR, exist_ok=True)
    out = {}
    for preset, seed in (("llama-3.2-1b", 3),) + tuple((p, 1) for p in GGUF_SERVED):
        path = os.path.join(GGUF_DIR, f"{preset}.gguf")
        cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch.testing.synth_gguf",
               preset, path, "--seed", str(seed)]
        if preset in GGUF_SERVED:
            cmd += ["--layers", str(GGUF_SERVED_LAYERS)]
        out[preset] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True),
                       time.perf_counter())
    return out


def gguf_written(writes: dict, preset: str) -> str:
    """Wait for ``preset``'s file; its path."""
    path, proc, t0 = writes[preset]
    out, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        fail(f"synth_gguf {preset} exited {proc.returncode}: {out}")
    say(f"  wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB), done "
        f"{time.perf_counter() - t0:.1f} s after its start")
    return path


def phase_gguf_serve(torch, writes: dict) -> dict:
    """C. TinyLlama-1.1B Q8_0 and Phi-3-mini q4 (``testing/synth_gguf.py``),
    each served in bf16 in this process through serve's GGUF branch (its
    params held to the file), then TinyLlama with ``serve --model
    <file>.gguf --quantization int8``, behind nothing (Phi-3-mini's int8
    serve is cut for the run's time)."""
    out = {}
    for preset in GGUF_SERVED:
        path = gguf_written(writes, preset)
        res = {"bf16": gguf_in_process(torch, path)}
        cfg = res["bf16"]["cfg"]
        if preset == GGUF_SERVED[0]:
            r = with_server(["--model", path, "--quantization", "int8"],
                            f"chip_smoke_gguf_{preset}_int8.log", _drive_gguf(path, cfg, True))
            say(f"  {preset} served int8 (serve --model {os.path.basename(path)} "
                f"--quantization int8): /health after {r['health_s']:.1f} s; chat "
                f"{r['usage']}: {r['answer'][:60]!r}; launches {r['launches']} "
                f"({card_line()})")
            res["int8"] = r
        os.remove(path)
        out[preset] = res
    return out


def phase_spec_gguf(torch) -> dict:
    """Phase 7: A (prompt-lookup speculation), B (the draft tier) on the
    same llama-3-8b random weights, then C (GGUF serving)."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    t0 = time.perf_counter()
    writes = start_gguf_writes()
    try:
        params = init_params(get_config(MODEL), seed=0, dtype="bfloat16", device="cuda")
        a = phase_spec_lookup(torch, params)
        t1 = time.perf_counter()
        say(f"phase 7 A: {t1 - t0:.1f} s")
        b = phase_spec_draft(torch, params, gguf_written(writes, "llama-3.2-1b"))
        t2 = time.perf_counter()
        say(f"phase 7 B: {t2 - t1:.1f} s")
        del params
        free_card(torch, "phase 7 A-B")
        c = phase_gguf_serve(torch, writes)
        say(f"phase 7 C: {time.perf_counter() - t2:.1f} s")
    finally:
        for _path, proc, _t in writes.values():     # a failed phase leaves no writer
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    say(f"phase 7 (speculation, draft tier, GGUF serve): {time.perf_counter() - t0:.1f} s")
    return {"A": a, "B": b, "C": c}


# ---------------------------------------------------------------------------
# phase 8: an AWQ checkpoint at Qwen3-8B's widths, and LoRA adapters on it
# ---------------------------------------------------------------------------

AWQ_MODEL = "qwen3-8b"
# the checkpoint cut to half its 36 layers for the run's time (every path
# of the full-depth run but the layer count)
AWQ_LAYERS = 18
AWQ_DIR = os.path.join(OUT_DIR, "qwen3-8b-awq")
ADAPTER_DIR = os.path.join(OUT_DIR, "adapters")
AWQ_PATH = f"{AWQ_MODEL} AWQ serve"
LORA_PATH = f"{AWQ_MODEL} AWQ serve with 3 LoRA adapters on 2 slots behind llkt-router"
AWQ_NEW = 64                 # greedy tokens a phase-8 stream generates
AWQ_PREFIX = 256             # B: the prompt prefix a base and an adapter request share


def start_awq_write():
    """Write the Qwen3-8B AWQ checkpoint at full width and AWQ_LAYERS layers
    (``synth_checkpoint --awq``) in a
    process of its own, started early so it overlaps earlier phases."""
    cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch.testing.synth_checkpoint",
           AWQ_MODEL, AWQ_DIR, "--awq", "--layers", str(AWQ_LAYERS)]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter())


def awq_written(write) -> str:
    proc, t0 = write
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"synth_checkpoint {AWQ_MODEL} --awq exited {proc.returncode}: {out}")
    size = sum(os.path.getsize(os.path.join(AWQ_DIR, f)) for f in os.listdir(AWQ_DIR))
    say(f"  wrote {AWQ_DIR} ({size / 1e9:.2f} GB), done {time.perf_counter() - t0:.1f} s "
        f"after its start")
    return AWQ_DIR


def hold_awq_params(torch, path: str, cfg, params) -> None:
    """Layers 0 and L - 1 of every grouped projection equal the file's
    tensors unpacked on the CPU (``awq_group_tensors``), their norms, the
    embedding, the final norm and the head the file's bf16 values, bit for
    bit."""
    from llms_on_kubernetes_tpu_torch.engine.safetensors import open_dir
    from llms_on_kubernetes_tpu_torch.engine.weights import awq_sources
    from llms_on_kubernetes_tpu_torch.ops import quant as q

    loaders = open_dir(path)
    L = cfg.num_layers
    for i in (0, L - 1):
        for name, (src, out_shape) in awq_sources(cfg).items():
            base = f"model.layers.{i}.{src[:-len('weight')]}"
            want = q.awq_group_tensors(*(loaders[base + p]() for p in ("qweight", "qzeros",
                                                                          "scales")),
                                       out_shape=out_shape)
            got = params["layers"][name][i]
            for part in ("data", "scale", "zero_scaled"):
                if not torch.equal(getattr(got, part).cpu(), getattr(want, part)):
                    fail(f"AWQ layer {i} {name}.{part} differs from the file's unpacked values")
        for name, hf in (("attn_norm", "input_layernorm"), ("mlp_norm",
                                                            "post_attention_layernorm"),
                         ("q_norm", "self_attn.q_norm"), ("k_norm", "self_attn.k_norm")):
            if not torch.equal(params["layers"][name][i].cpu(),
                               loaders[f"model.layers.{i}.{hf}.weight"]()):
                fail(f"AWQ layer {i} {name} differs from the file")
    for name, hf, t in (("embed", "model.embed_tokens.weight", False),
                        ("final_norm", "model.norm.weight", False),
                        ("lm_head", "lm_head.weight", True)):
        want = loaders[hf]()
        if not torch.equal(params[name].cpu(), want.T if t else want):
            fail(f"AWQ {name} differs from the file")


def awq_prompts(n: int = 8) -> list:
    """8 prompts of 40 byte tokens (the byte tokenizer's ids), distinct."""
    return [[ord(c) for c in SERVE_TEXT[i:i + 40]] for i in range(n)]


def awq_run(torch, eng, prompts, adapters, max_tokens: int = AWQ_NEW) -> dict:
    """Submit every prompt at once (its adapter from ``adapters``) and step
    the engine until all finish: outputs, logprobs, the decode rate
    (tokens after each first one over the span from the first first token
    to the last finish) and the launches and forwards in that time."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    kernels.reset_launches()
    f0 = eng.prefill_calls + eng.chunk_calls + eng.decode_forwards
    r0, d0 = eng.graph_replays, eng.decode_forwards
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens)
    reqs = [eng.submit(p, sp, adapter=a) for p, a in zip(prompts, adapters)]
    while eng.has_work():
        eng.step()
    if any(r.finish_reason != "length" or len(r.output) != max_tokens for r in reqs):
        fail(f"AWQ run: finishes {[(r.finish_reason, len(r.output)) for r in reqs]}")
    span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    return {"outs": [list(r.output) for r in reqs],
            "lps": [list(r.output_logprobs) for r in reqs],
            "tok_s": sum(len(r.output) - 1 for r in reqs) / span,
            "launches": kernels.launch_counts(),
            "forwards": eng.prefill_calls + eng.chunk_calls + eng.decode_forwards - f0,
            "replays": eng.graph_replays - r0, "decode_forwards": eng.decode_forwards - d0}


def check_w4_path(tag: str, run: dict, num_layers: int, steps: int) -> None:
    """Every window a graph replay; every projection one W4A16 launch (7 x
    num_layers a forward); W8A16 never."""
    if run["replays"] < 1 or run["replays"] * steps != run["decode_forwards"]:
        fail(f"{tag}: {run['replays']} replays x {steps} != {run['decode_forwards']} decode "
             f"forwards: a window ran outside the graph")
    w4 = run["launches"].get("w4_matmul", 0)
    if w4 != 7 * num_layers * run["forwards"]:
        fail(f"{tag}: w4_matmul launched {w4} times for {run['forwards']} forwards of "
             f"{num_layers} layers (7 a layer expected)")
    if run["launches"].get("w8_matmul"):
        fail(f"{tag}: the AWQ engine launched w8_matmul")


def awq_in_process(torch, path: str) -> dict:
    """8 A, in process: load the checkpoint as ``serve`` would (timed, the
    host's resident set sampled, the bytes on the card), hold layers 0 and
    L - 1 to the file, then 8 concurrent greedy requests on the engine,
    each window's device time taken by CUDA events."""
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, model_config_for
    from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params

    ecfg = engine_config_from_args(build_parser().parse_args(
        ["serve", *POOL_ARGS, "--model", path, "--quantization", "awq"]))
    cfg = model_config_for(path, path)
    rss = RssPeak()
    t0 = time.perf_counter()
    params = load_hf_params(cfg, path, device="cuda", quantization="awq")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rss_start, rss_peak = rss.close()
    nbytes = param_bytes(params)
    grouped = sum(w.nbytes() for w in params["layers"].values() if hasattr(w, "zero_scaled"))
    int4 = sum(w.data.numel() for w in params["layers"].values() if hasattr(w, "zero_scaled"))
    hold_awq_params(torch, path, cfg, params)
    eng = Engine(ecfg, model_config=cfg, params=params)
    ready_s = time.perf_counter() - t0
    timer = WindowTimer(torch, eng._window)
    run = awq_run(torch, eng, awq_prompts(), [None] * 8)
    win_ms = timer.close()["free"]
    check_w4_path("AWQ in process", run, cfg.num_layers, eng.config.decode_steps)
    say(f"  {AWQ_MODEL} AWQ ({cfg.num_layers} layers, group 128, packed int4) loaded in "
        f"{load_s:.1f} s (engine serving after {ready_s:.1f} s), the host's resident set "
        f"peaking {rss_peak:.2f} GB above its {rss_start:.2f} GB; {nbytes / 1e9:.2f} GB on the "
        f"card: {int4 / 1e9:.2f} GB of int4, {(grouped - int4) / 1e9:.2f} GB of scales and "
        f"zeros, {(params['embed'].numel() + params['lm_head'].numel()) * 2 / 1e9:.2f} GB "
        f"embedding and head; layers 0 and {cfg.num_layers - 1}, the norms, the embedding "
        f"and the head equal the file's values")
    say(f"  AWQ in process, 8 greedy streams of {AWQ_NEW} ({len(set(map(tuple, run['outs'])))} "
        f"distinct; the first's head {run['outs'][0][:8]}): {run['tok_s']:.1f} decode tok/s, "
        f"{run['replays']} windows (each one graph replay), window device ms median "
        f"{float(np.median(win_ms)):.3f} (min {min(win_ms):.3f}, max {max(win_ms):.3f}); "
        f"w4_matmul {run['launches'].get('w4_matmul', 0)} launches = 7 x {cfg.num_layers} x "
        f"{run['forwards']} forwards [{card_line()}]")
    del eng, timer
    return {"cfg": cfg, "ecfg": ecfg, "params": params, "base": run, "load_s": load_s,
            "rss_peak_gb": rss_peak, "nbytes": nbytes, "window_ms": win_ms}


def lora_delta_ms(torch, eng) -> float:
    """Device ms of one layer's four q/k/v/o LoRA deltas at 8 decode rows
    (``ops/lora.lora_delta_rows`` as ``decoder._proj`` calls it, every
    row on a slot), timed by ``Timer``."""
    from llms_on_kubernetes_tpu_torch.ops.lora import lora_delta_rows

    cfg = eng.model_config
    lp = {t: eng.params["layers"]["lora_" + t][0] for t in ("wq", "wk", "wv", "wo")}
    x = torch.randn((8, cfg.hidden_size), device="cuda").to(torch.bfloat16)
    idx = torch.tensor([0, 1] * 4, dtype=torch.int32, device="cuda")

    def four():
        for st in lp.values():
            S, r = st.a.shape[0], st.rank
            lora_delta_rows(x, st.a.reshape(S, -1, r), st.b.reshape(S, r, -1), idx)
    return Timer(torch)(four)


def write_adapters(cfg) -> dict:
    """Three PEFT adapters at Qwen3-8B's widths (rank 16, q/k/v/o, alpha 32,
    seeded), written by ``testing/synth_adapter.py``."""
    from llms_on_kubernetes_tpu_torch.testing.synth_adapter import write_peft

    return {f"ad{i}": write_peft(os.path.join(ADAPTER_DIR, f"ad{i}"), cfg, rank=16, alpha=32,
                                 seed=20 + i, scale=0.02) for i in range(3)}


def graph_captures() -> int:
    from llms_on_kubernetes_tpu_torch import kernels

    return sum(kind.startswith("graph:") for kind, _s in kernels.COMPILES)


def lora_in_process(torch, awq: dict, dirs: dict) -> dict:
    """8 B, in process, on the AWQ weights: engines with the three adapters
    on two slots. A heterogeneous batch (base, ad0, ad1, ad2, twice) against
    each request alone; an ad0 request after a base request sharing its
    256-token prefix against ad0 cold (another engine); evict and reload;
    no capture for an upload; adapter against base decode tok/s."""
    import dataclasses as dc

    from llms_on_kubernetes_tpu_torch.engine.engine import Engine

    cfg, params = awq["cfg"], awq["params"]
    ecfg = dc.replace(awq["ecfg"], adapters=dirs, adapter_slots=2)
    prefix = [ord(c) for c in (PROMPT_900 * 2)[:AWQ_PREFIX]]
    prompt_a = prefix + [ord(c) for c in "and then the adapter asked about the tail"]
    prompt_b = prefix + [ord(c) for c in "while the base model answered otherwise"]
    cold_eng = Engine(ecfg, model_config=cfg, params=params)
    cold = awq_run(torch, cold_eng, [prompt_a], ["ad0"])["outs"][0]
    del cold_eng
    free_card(torch, "the cold-prefix engine freed")
    eng = Engine(ecfg, model_config=cfg, params=params)
    captured = graph_captures()
    awq_run(torch, eng, [prompt_b], [None])
    hits0 = eng.allocator.hit_tokens_total
    warm = awq_run(torch, eng, [prompt_a], ["ad0"])["outs"][0]
    if warm != cold or eng.allocator.hit_tokens_total != hits0:
        fail(f"LoRA: ad0 after a base request with the same {AWQ_PREFIX}-token prefix differs "
             f"from ad0 cold, or adopted the base model's pages")
    say(f"  LoRA salt: ad0 after a base request sharing its {AWQ_PREFIX}-token prefix equals "
        f"ad0 cold ({len(cold)} tokens), no page adopted")
    prompts = awq_prompts()
    names = [None, "ad0", "ad1", "ad2"] * 2
    alone = [awq_run(torch, eng, [p], [a]) for p, a in zip(prompts, names)]
    batch = awq_run(torch, eng, prompts, names)
    flips = []
    for i, ref in enumerate(alone):
        m = flip_margin(ref["outs"][0], ref["lps"][0], batch["outs"][i])
        if m is not None:
            if not m[1] <= m[2]:
                fail(f"LoRA batch row {i} ({names[i]}) first differs from its run alone at "
                     f"{m[0]} by {m[1]} nats, past the near-tie bound {m[2]}")
            flips.append((i, names[i], m))
    # the adapters act: on one prompt, the base model's and each adapter's
    # first token logprob differ (random weights may agree on the token)
    probe = {a: awq_run(torch, eng, [prompts[0]], [a], max_tokens=2)
             for a in (None, "ad0", "ad1", "ad2")}
    firsts = {a: (r["outs"][0][0], round(r["lps"][0][0][0], 5)) for a, r in probe.items()}
    if len(set(firsts.values())) != 4:
        fail(f"LoRA: the base model and the adapters give the same first token and logprob "
             f"on one prompt: {firsts}")
    distinct = len({tuple(a["outs"][0]) for a in alone})
    stack = eng.params["layers"]["lora_wq"]
    ptrs = (stack.a.data_ptr(), stack.b.data_ptr())
    mgr = eng.adapters
    first = awq_run(torch, eng, [prompts[0]], ["ad0"])["outs"][0]
    for a in ("ad1", "ad2"):
        awq_run(torch, eng, [prompts[0]], [a], max_tokens=4)
    if mgr.slot_of("ad0") is not None:
        fail("LoRA: ad0 still resident after ad1 and ad2 ran on two slots")
    ev = mgr.stats["evictions"]
    again = awq_run(torch, eng, [prompts[0]], ["ad0"])["outs"][0]
    slot = mgr.slot_of("ad0")
    a_host, b_host = mgr._host_cache["ad0"].factors["wq"]
    if (again != first or mgr.stats["evictions"] != ev + 1 or slot is None
            or not torch.equal(stack.a[:, slot].cpu(), torch.from_numpy(a_host))
            or not torch.equal(stack.b[:, slot].cpu(), torch.from_numpy(b_host))):
        fail("LoRA: an evicted and reloaded ad0 differs from its first load")
    if graph_captures() != captured or (stack.a.data_ptr(), stack.b.data_ptr()) != ptrs:
        fail("LoRA: an upload recaptured a graph or moved a stack")
    timer = WindowTimer(torch, eng._window)
    base = awq_run(torch, eng, prompts, [None] * 8)
    base_ms = timer.close()["free"]
    timer = WindowTimer(torch, eng._window)
    adapted = awq_run(torch, eng, prompts, ["ad0", "ad1"] * 4)
    adapted_ms = timer.close()["free"]
    delta_ms = lora_delta_ms(torch, eng)
    check_w4_path("LoRA in process", adapted, cfg.num_layers, eng.config.decode_steps)
    say(f"  LoRA first token and logprob on one prompt, base and each adapter: {firsts}")
    say(f"  LoRA heterogeneous batch (base, ad0, ad1, ad2 x 2; 2 slots; {distinct} distinct "
        f"streams of 8): {8 - len(flips)} of 8 streams equal their runs alone, the rest first "
        f"apart at a "
        f"near-tie {flips}; evict and reload of ad0: stream and slot bytes identical "
        f"(evictions {mgr.stats['evictions']}); graph captures unchanged across "
        f"{mgr.stats['misses']} uploads; decode tok/s 8 adapter rows (ad0/ad1) "
        f"{adapted['tok_s']:.1f} against 8 base rows {base['tok_s']:.1f}; window device ms "
        f"median {float(np.median(adapted_ms)):.3f} against {float(np.median(base_ms)):.3f} "
        f"(the adapter-free engine's {float(np.median(awq['window_ms'])):.3f}); one layer's "
        f"four deltas at 8 rows {delta_ms:.4f} ms [{card_line()}]")
    del eng
    free_card(torch, "the LoRA engine freed")
    return {"base_tok_s": base["tok_s"], "adapter_tok_s": adapted["tok_s"], "flips": flips}


def _drive_awq(cfg, tag: str):
    """8 concurrent greedy journaled streams through ``serve``: every window
    a graph replay, every projection one W4A16 launch; the decode rate
    and the server process's peak resident set."""

    def drive(base: str, proc) -> dict:
        http("POST", base + "/debug/kernels/reset")
        k0 = kernel_counts(base)
        out: dict = {}

        def one(i):
            out[i] = journaled_stream(base, {"model": AWQ_MODEL, "prompt": SERVE_TEXT[i:i + 40],
                                             "max_tokens": AWQ_NEW, "temperature": 0,
                                             "stream": True})

        ths = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        if len(out) != 8 or any(len(o[0]) != AWQ_NEW for o in out.values()):
            fail(f"{tag}: the 8 streams did not all finish with {AWQ_NEW} tokens")
        tok_s = (sum(len(o[0]) - 1 for o in out.values())
                 / (max(o[2] for o in out.values()) - min(o[1] for o in out.values())))
        k1 = kernel_counts(base)
        check_graphed(tag, k1, k0)
        run = {"launches": k1["launches"], "replays": k1["graph_replays"] - k0["graph_replays"],
               "decode_forwards": k1["decode_forwards"] - k0["decode_forwards"],
               "forwards": sum(k1[k] - k0[k] for k in ("prefill_calls", "chunk_calls",
                                                       "decode_forwards"))}
        check_w4_path(tag, run, cfg.num_layers, k1["decode_steps"])
        return {"launches": k1["launches"], "tok_s": tok_s, "forwards": run["forwards"]}
    return drive


def _drive_lora_router(cfg, proc_dirs: dict):
    """Behind ``llkt-router --adapters``: /v1/models lists the adapters, an
    adapter completion answers with its id, ``model=qwen3-8b:nope`` gets the
    404 ``adapter_not_found``; every window a graph replay; the adapter
    cache series count the loads."""

    def drive(base: str, _proc) -> dict:
        router_proc, router = start_router(
            ["--models", f"{AWQ_MODEL}={base}", "--adapters",
             f"{AWQ_MODEL}={'|'.join(sorted(proc_dirs))}", "--probe-interval", "0.5"],
            "chip_smoke_lora_router.log", [base])
        try:
            http("POST", base + "/debug/kernels/reset")
            k0 = kernel_counts(base)
            status, body = http("GET", base + "/v1/models")
            ids = [m["id"] for m in json.loads(body)["data"]]
            if ids != [AWQ_MODEL] + [f"{AWQ_MODEL}:{a}" for a in sorted(proc_dirs)]:
                fail(f"LoRA server /v1/models: {ids}")
            texts = {}
            for model in (AWQ_MODEL, f"{AWQ_MODEL}:ad0", f"{AWQ_MODEL}:ad1",
                          f"{AWQ_MODEL}:ad2", f"{AWQ_MODEL}:ad0"):
                status, body = http("POST", router + "/v1/completions", {
                    "model": model, "prompt": SERVE_TEXT[:40], "max_tokens": 16,
                    "temperature": 0})
                d = json.loads(body)
                if status != 200 or d.get("model") != model:
                    fail(f"LoRA via llkt-router {model}: HTTP {status} {body[:200]!r}")
                texts.setdefault(model, []).append(d["choices"][0]["text"])
            if texts[f"{AWQ_MODEL}:ad0"][0] != texts[f"{AWQ_MODEL}:ad0"][1]:
                fail("LoRA via llkt-router: ad0 reloaded answers differently")
            status, body = http("POST", router + "/v1/completions", {
                "model": f"{AWQ_MODEL}:nope", "prompt": "x", "max_tokens": 4})
            err = json.loads(body).get("error", {})
            if status != 404 or err.get("code") != "adapter_not_found":
                fail(f"LoRA via llkt-router model {AWQ_MODEL}:nope: HTTP {status} {body!r}")
            k1 = kernel_counts(base)
            check_graphed("LoRA server", k1, k0)
            misses = metric(base, "llm_adapter_cache_misses_total")
            evictions = metric(base, "llm_adapter_cache_evictions_total")
            if misses < 3 or evictions < 1:
                fail(f"LoRA server: adapter cache misses {misses}, evictions {evictions}")
            say(f"  LoRA behind llkt-router: /v1/models {ids}; base, ad0, ad1, ad2, ad0 "
                f"answered with their ids (ad0 reloaded, same text); {AWQ_MODEL}:nope -> 404 "
                f"adapter_not_found; llm_adapter_cache_misses_total {misses:g}, evictions "
                f"{evictions:g}")
            return {"launches": k1["launches"]}
        finally:
            stop_proc(router_proc)
    return drive


def phase_awq_lora(torch, write) -> dict:
    """Phase 8: A (the AWQ checkpoint in process, then ``serve --model <dir>
    --quantization awq``) and B (LoRA on it: in process, then ``serve
    --adapter`` x 3 behind llkt-router)."""
    t0 = time.perf_counter()
    path = awq_written(write)
    awq = awq_in_process(torch, path)
    dirs = write_adapters(awq["cfg"])
    lora = lora_in_process(torch, awq, dirs)
    cfg = awq["cfg"]
    del awq["params"]
    free_card(torch, "phase 8 in process done")
    args = ["--model", path, "--quantization", "awq", "--served-model-name", AWQ_MODEL]
    served = with_server(args, "chip_smoke_awq.log", _drive_awq(cfg, AWQ_PATH))
    say(f"  serve --model {path} --quantization awq: /health after {served['health_s']:.1f} s; "
        f"8 greedy streams of {AWQ_NEW}: {served['tok_s']:.1f} decode tok/s; w4_matmul "
        f"{served['launches'].get('w4_matmul', 0)} launches = 7 x {cfg.num_layers} x "
        f"{served['forwards']} forwards, w8_matmul none [{card_line()}]")
    ad_args = [x for a, d in sorted(dirs.items()) for x in ("--adapter", f"{a}={d}")]
    routed = with_server(args + ad_args + ["--adapter-slots", "2"], "chip_smoke_lora.log",
                         _drive_lora_router(cfg, dirs))
    say(f"  the LoRA server: /health after {routed['health_s']:.1f} s")
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(ADAPTER_DIR, ignore_errors=True)
    say(f"phase 8 (AWQ and LoRA): {time.perf_counter() - t0:.1f} s")
    return {"A": {**awq, "served": served}, "B": {**lora, "routed": routed}}


# ---------------------------------------------------------------------------
# phase 9: the MoE block (the expert kernel, qwen3-30b-a3b at full width and
# depth in process and through serve behind llkt-router, a Qwen3-MoE
# checkpoint served from its directory)
# ---------------------------------------------------------------------------

MOE_MODEL = "qwen3-30b-a3b"
# expert-major rows the kernel is held at: one claim, then 1, 8 (the 8-slot
# decode step), 64 and 4,096 tokens (a bucket-4,096 prefill) at top-8
MOE_ROWS = (1, 8, 64, 512, 32768)
MOE_MAIN = 64
MOE_NEW = 64                 # greedy tokens a phase-9 stream generates
MOE_LONG = 4000              # C: a long prompt's tokens (bucket 4,096)
MOE_CKPT_LAYERS = 2
# D: the 2-layer checkpoints: bf16 as Qwen3-30B-A3B is published, and each
# pre-quantized format of a published Qwen3-MoE checkpoint (Qwen3-30B-A3B-FP8's
# compressed-tensors fp8, an AWQ one), served int8 as the JAX loader serves them
MOE_CKPT_QUANTS = ("bf16", "fp8", "awq")
MOE_DIRS = {q: os.path.join(OUT_DIR, f"qwen3-30b-a3b-2l-{q}") for q in MOE_CKPT_QUANTS}
MOE_PATH = f"{MOE_MODEL} serve behind llkt-router"
# B (and phase 10 C on its engine) at half depth, cut for the run's time:
# every path of a full-depth build but the layer count
MOE_INPROC_LAYERS = 24
MOE_INPROC_PATH = (f"qwen3-vl-30b-a3b ({MOE_MODEL} backbone, {MOE_INPROC_LAYERS} of 48 layers) "
                   f"text streams in process")
MOE_CKPT_PATHS = {q: f"{MOE_MODEL} {MOE_CKPT_LAYERS} layers "
                     f"{'' if q == 'bf16' else q + ' '}checkpoint serve" for q in MOE_CKPT_QUANTS}
# E, F: Mixtral-8x7B with int8 weights (46.70 B parameters, 93.4 GB in bf16:
# only int8 fits one card) in process and through serve behind llkt-router,
# with serve's pool and buckets
MIXTRAL_INPROC_PATH = "mixtral-8x7b int8 weights in process"
MIXTRAL_PATH = "mixtral-8x7b int8 weights serve behind llkt-router"
MIXTRAL_SERVE = ["--model", "mixtral-8x7b", "--random-weights", "--quantization", "int8"]


def moe_weights(torch, cfg, seed: int = 16):
    """One layer's router and expert stacks at ``cfg``'s widths, bf16, drawn
    on the card with the ``init_params`` scales, and the generator."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    E, D, Fd = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

    def w(*shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    return (w(D, E, scale=D ** -0.5), w(E, D, Fd, scale=D ** -0.5),
            w(E, D, Fd, scale=D ** -0.5), w(E, Fd, D, scale=Fd ** -0.5), gen)


def moe_inputs(torch, cfg, router, gen, R: int, touched: int = 0):
    """(x, src, counts) for R expert-major rows: R / k random tokens routed
    by ``router`` (near-uniform over the experts), or one token's single
    claim on expert 37 (the last where there are fewer) when R is 1.
    ``touched`` > 0: the R rows split as evenly as they go over that many
    experts drawn from ``gen`` instead (each row a random token)."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    D, E, k = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    N = max(1, R // k)
    x = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
    if touched:
        chosen = torch.randperm(E, generator=gen, device="cuda")[:touched].sort().values
        counts = torch.zeros((E,), dtype=torch.int32, device="cuda")
        counts[chosen] = torch.tensor([R // touched + (i < R % touched) for i in range(touched)],
                                      dtype=torch.int32, device="cuda")
        src = torch.randint(0, N, (R,), generator=gen, device="cuda", dtype=torch.int32)
        return x, src, counts
    if R == 1:
        counts = torch.zeros((E,), dtype=torch.int32, device="cuda")
        counts[min(37, E - 1)] = 1
        return x, torch.zeros((1,), dtype=torch.int32, device="cuda"), counts
    r = moe.moe_route(x, router, top_k=k)
    return x, r.src, r.counts


def moe_work(cfg, x, counts, R: int) -> tuple[float, float, int]:
    """FLOPs and bytes the routed expert FFN needs for these rows (x read
    once, src and counts, each touched expert's three matrices read once, y
    written once), and the experts touched."""
    D, Fd, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    touched = int((counts > 0).sum())
    rows = int(counts.sum())
    flops = 6.0 * rows * D * Fd
    nbytes = x.numel() * 2 + 4 * R + 4 * E + touched * 3 * D * Fd * 2 + rows * D * 2
    return flops, nbytes, touched


def moe_library(torch, x, src, counts, wg, wu, wd):
    """The same function through ``torch._grouped_mm`` (the gather, three
    grouped products and the SiLU product): (a function, None), or (None,
    the reason there is none)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    offs = torch.cumsum(counts, 0, dtype=torch.int32)

    def run():
        xs = x.index_select(0, src.long())
        h = torch.nn.functional.silu(torch._grouped_mm(xs, wg, offs=offs)) \
            * torch._grouped_mm(xs, wu, offs=offs)
        return torch._grouped_mm(h, wd, offs=offs)
    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError as e:       # the yardstick only: the port never calls it
        return None, f"torch._grouped_mm refused these inputs: {e}"
    return run, None


# Mixtral-8x7B's one layer (D 4,096, F 14,336, 8 experts top-2; 2.82 GB of
# random bf16): a decode step of 8 tokens and a 4,096-token prefill
MOE_MIXTRAL = "mixtral-8x7b"
MOE_MIXTRAL_ROWS = (16, 8192)


def moe_simple_call(torch, simple, x, src, counts, wg, wu, wd):
    """The earlier mma.sync expert kernel (``scripts/moe_experts_simple.cu``) on the
    same inputs, into buffers of its own."""
    from llms_on_kubernetes_tpu_torch import kernels

    R, (E, D, Fd) = src.shape[0], wg.shape
    h = torch.empty((R, Fd), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((R, D), dtype=torch.bfloat16, device="cuda")
    kernels.check("moe_experts_simple", simple(
        x.data_ptr(), src.data_ptr(), counts.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), h.data_ptr(), y.data_ptr(), R, E, D, Fd,
        torch.cuda.current_stream().cuda_stream))
    return y


def moe_kernel_checks(torch, timer, simple) -> dict:
    """A: the expert kernel against ``moe_experts_plain`` at every R of
    MOE_ROWS at qwen3-30b-a3b's widths and at MOE_MIXTRAL_ROWS at
    mixtral-8x7b's (the bf16 row tolerance), the tile size each R runs on
    and the K split held to their Python mirrors, three rows of each alone
    bit-equal to them (batch invariance; a row alone runs on 8-row tiles,
    so at larger R this holds the tile sizes to each other), the earlier
    mma.sync body within the same tolerance, a refusal; timed in turns
    (kernel, the earlier body, ``torch._grouped_mm``, kernel) beside the
    plain version and the bound of the experts touched."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.ops import moe

    say("kernel moe_experts (the port's own: the routed expert FFN that JAX "
        "ops/moe.py::moe_block writes as one-hot einsums, left to XLA)")
    splits, tile = kernels.function("moe_splits"), kernels.function("moe_rows")
    err, timings, lib_note, tiles_of = 0.0, {}, None, {}
    for model, rows_list in ((MOE_MODEL, MOE_ROWS), (MOE_MIXTRAL, MOE_MIXTRAL_ROWS)):
        cfg = get_config(model)
        E, D, Fd, k = (cfg.num_experts, cfg.hidden_size, cfg.intermediate_size,
                       cfg.num_experts_per_tok)
        for K, Nw in ((D, 2 * Fd), (Fd, D)):
            if splits(K, Nw) != len(moe.moe_splits(K, Nw)):
                fail(f"moe_experts: the kernel cuts K {K} over {Nw} columns into "
                     f"{splits(K, Nw)} slices, ops/moe.moe_splits into "
                     f"{len(moe.moe_splits(K, Nw))}")
        torch.cuda.empty_cache()
        router, wg, wu, wd, gen = moe_weights(torch, cfg)
        for R in rows_list:
            x, src, counts = moe_inputs(torch, cfg, router, gen, R)
            nx = tile(R, x.shape[0], E)
            if nx != moe.moe_rows(R, x.shape[0], E):
                fail(f"moe_experts: R {R} over {x.shape[0]} tokens runs {nx}-row tiles, "
                     f"ops/moe.moe_rows says {moe.moe_rows(R, x.shape[0], E)}")
            tiles_of[f"{model} R{R}"] = f"{nx}-row tiles"
            got = moe.moe_experts(x, src, counts, wg, wu, wd)
            want = moe.moe_experts_plain(x, src, counts, wg, wu, wd)
            rows = int(counts.sum())
            err = max(err, check_close(f"bf16 {model} R{R} ({tiles_of[f'{model} R{R}']})",
                                       got[:rows], want[:rows], "bfloat16"))
            check_close(f"bf16 {model} R{R} the earlier mma.sync body",
                        moe_simple_call(torch, simple, x, src, counts, wg, wu, wd)[:rows],
                        want[:rows], "bfloat16")
            expert_of = torch.repeat_interleave(torch.arange(E, device="cuda"), counts.long())
            for r in sorted({0, rows // 3, rows - 1}):
                one = torch.zeros((E,), dtype=torch.int32, device="cuda")
                one[expert_of[r]] = 1
                alone = moe.moe_experts(x, src[r:r + 1], one, wg, wu, wd)
                if not torch.equal(alone[0], got[r]):
                    fail(f"moe_experts: {model} row {r} alone differs from row {r} of {R} "
                         f"rows (batch invariance)")
            flops, nbytes, touched = moe_work(cfg, x, counts, R)
            b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
            lib_fn, why = moe_library(torch, x, src, counts, wg, wu, wd)
            lib_note = lib_note or why
            reps = 30 if R <= 512 else 10
            t1 = timer(lambda: moe.moe_experts(x, src, counts, wg, wu, wd), reps=reps)
            old = timer(lambda: moe_simple_call(torch, simple, x, src, counts, wg, wu, wd),
                        reps=reps)
            lib = timer(lib_fn, reps=reps) if lib_fn is not None else None
            t2 = timer(lambda: moe.moe_experts(x, src, counts, wg, wu, wd), reps=reps)
            plain = timer(lambda: moe.moe_experts_plain(x, src, counts, wg, wu, wd), reps=3)
            key = (f"{'' if model == MOE_MODEL else model + ' '}R{R} ({max(1, R // k)} tokens x "
                   f"top-{k}) D{D} F{Fd} E{E} bf16")
            timings[key] = dict(ms=(t1 + t2) / 2, simple_ms=old, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib, experts_touched=touched,
                                tiles=tiles_of[f"{model} R{R}"])
            say(f"  timing moe_experts {key}: ms={t1:.4f},{t2:.4f} simple_ms={old:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}, {touched} experts touched) library_ms="
                f"{'none' if lib is None else f'{lib:.4f}'} plain_ms={plain:.4f} "
                f"[{tiles_of[f'{model} R{R}']}]")
            del got, want
        del router, wg, wu, wd
    say(f"  batch invariance: rows alone equal them among {MOE_ROWS} rows ({MOE_MODEL}) and "
        f"{MOE_MIXTRAL_ROWS} ({MOE_MIXTRAL}), bit for bit")
    say("  tiles: " + ", ".join(f"{k} {v}" for k, v in tiles_of.items()))
    if lib_note:
        say(f"  library_ms none: {lib_note}")
    router, wg, wu, wd, gen = moe_weights(torch, get_config("debug-moe"))
    x, src, counts = moe_inputs(torch, get_config("debug-moe"), router, gen, 8)
    try:
        moe.moe_experts(x.float(), src, counts, wg, wu, wd)
    except ValueError as e:
        say(f"  refuses float32 x: {e}")
    else:
        fail("moe_experts took float32 x")
    main_key = next(k for k in timings if k.startswith(f"R{MOE_MAIN} "))
    return dict(
        name="moe_experts", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/moe_experts.cu",
        replaces="none: llms_on_kubernetes_tpu/ops/moe.py:33 moe_block, left to XLA",
        max_abs_err=err, **timings[main_key], shape=main_key,
        other_shapes={k: v for k, v in timings.items() if k != main_key},
        simple_note=(f"simple_ms: the kernel before its Hopper redesign ({MOE_VARIANT}: "
                     f"mma.sync on 64 x 64 tiles, cp.async), in turns in this run"),
        library_note=("the gather, torch._grouped_mm x 3 and the SiLU product (the routed "
                      "function in library calls)" if lib_note is None
                      else f"none: {lib_note}"))


def moe_w8_work(cfg, x, counts, R: int) -> tuple[float, float, int]:
    """FLOPs and bytes the routed expert FFN on int8 stacks needs for these
    rows: ``moe_work``'s, with each touched expert's three matrices at one
    byte a weight plus their f32 column scales (2F + D a expert)."""
    D, Fd, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    touched = int((counts > 0).sum())
    rows = int(counts.sum())
    flops = 6.0 * rows * D * Fd
    nbytes = (x.numel() * 2 + 4 * R + 4 * E + touched * (3 * D * Fd + 4 * (2 * Fd + D))
              + rows * D * 2)
    return flops, nbytes, touched


def moe_w8_stacks(wg, wu, wd):
    """int8 QTensor stacks of bf16 [E, D, F] / [E, F, D] stacks, quantized
    per (expert, output column) as JAX ``quantize_params`` quantizes them."""
    from llms_on_kubernetes_tpu_torch.ops.quant import quantize

    return tuple(quantize(w, (1,)) for w in (wg, wu, wd))


def moe_w8_kernel_checks(torch, timer) -> dict:
    """A, int8: the int8 expert kernel against ``moe_experts_plain`` on the
    same QTensor stacks at every R of MOE_ROWS (qwen3-30b-a3b) and
    MOE_MIXTRAL_ROWS (mixtral-8x7b), the bf16 row tolerance; three rows of
    each alone bit-equal to them among R rows (a row alone runs on 8-row
    tiles); refusals of mixed stacks and float32 x; timed in turns
    (kernel, the bf16 expert kernel and ``torch._grouped_mm`` on bf16
    stacks of the same shape, kernel) beside the plain version and the
    bound of the int8 bytes of the experts touched."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.ops import moe

    from llms_on_kubernetes_tpu_torch import kernels

    say("kernel moe_experts_w8 (the port's own: the routed expert FFN on int8 expert stacks, "
        "which JAX ops/moe.py::moe_block runs as qeinsum, left to XLA)")
    err, timings, lib_note = 0.0, {}, None
    spread = kernels.function("moe_spread")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Mixtral R 16 over 6 experts: the down launch's imbalance case (192
    # items for the SMs), its slices spread over clusters of 8 blocks
    cases = ((MOE_MODEL, [(R, 0) for R in MOE_ROWS]),
             (MOE_MIXTRAL, [(R, 0) for R in MOE_MIXTRAL_ROWS] + [(16, 6)]))
    for model, rows_list in cases:
        cfg = get_config(model)
        E, D, Fd, k = (cfg.num_experts, cfg.hidden_size, cfg.intermediate_size,
                       cfg.num_experts_per_tok)
        blocks = []
        for K, N, gated in ((D, Fd, True), (Fd, D, False)):
            kc = spread(K, N, int(gated), E, sms)
            if kc != moe.moe_spread_blocks(K, N, gated, E, sms):
                fail(f"moe_experts_w8: the decode body spreads K {K}, N {N} over {kc} blocks, "
                     f"ops/moe.moe_spread_blocks says {moe.moe_spread_blocks(K, N, gated, E, sms)}")
            blocks.append(kc)
        say(f"  {model}: the decode body's cluster (gate/up, down) {tuple(blocks)} "
            f"(0: the shared body; {sms} SMs), as ops/moe.moe_spread_blocks")
        torch.cuda.empty_cache()
        router, wg, wu, wd, gen = moe_weights(torch, cfg, seed=18)
        qg, qu, qd = moe_w8_stacks(wg, wu, wd)
        for R, over in rows_list:
            x, src, counts = moe_inputs(torch, cfg, router, gen, R, over)
            tiles = f"{moe.moe_rows(R, x.shape[0], E)}-row tiles"
            got = moe.moe_experts(x, src, counts, qg, qu, qd)
            want = moe.moe_experts_plain(x, src, counts, qg, qu, qd)
            rows = int(counts.sum())
            err = max(err, check_close(f"int8 {model} R{R} ({tiles})", got[:rows], want[:rows],
                                       "bfloat16"))
            expert_of = torch.repeat_interleave(torch.arange(E, device="cuda"), counts.long())
            for r in sorted({0, rows // 3, rows - 1}):
                one = torch.zeros((E,), dtype=torch.int32, device="cuda")
                one[expert_of[r]] = 1
                alone = moe.moe_experts(x, src[r:r + 1], one, qg, qu, qd)
                if not torch.equal(alone[0], got[r]):
                    fail(f"moe_experts_w8: {model} row {r} alone differs from row {r} of {R} "
                         f"rows (batch invariance)")
            flops, nbytes, touched = moe_w8_work(cfg, x, counts, R)
            b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
            lib_fn, why = moe_library(torch, x, src, counts, wg, wu, wd)
            lib_note = lib_note or why
            reps = 30 if R <= 512 else 10
            t1 = timer(lambda: moe.moe_experts(x, src, counts, qg, qu, qd), reps=reps)
            bf16 = timer(lambda: moe.moe_experts(x, src, counts, wg, wu, wd), reps=reps)
            lib = timer(lib_fn, reps=reps) if lib_fn is not None else None
            t2 = timer(lambda: moe.moe_experts(x, src, counts, qg, qu, qd), reps=reps)
            plain = timer(lambda: moe.moe_experts_plain(x, src, counts, qg, qu, qd), reps=3)
            key = (f"{'' if model == MOE_MODEL else model + ' '}R{R} ({max(1, R // k)} tokens x "
                   f"top-{k}{f', rows over {over} experts' if over else ''}) D{D} F{Fd} "
                   f"E{E} int8 weights")
            timings[key] = dict(ms=(t1 + t2) / 2, bf16_kernel_ms=bf16, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                                experts_touched=touched, tiles=tiles)
            say(f"  timing moe_experts_w8 {key}: ms={t1:.4f},{t2:.4f} bf16_kernel_ms={bf16:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}, {touched} experts touched) library_ms="
                f"{'none' if lib is None else f'{lib:.4f}'} plain_ms={plain:.4f} [{tiles}]")
            del got, want
        del router, wg, wu, wd, qg, qu, qd
    say(f"  batch invariance: rows alone equal them among {MOE_ROWS} rows ({MOE_MODEL}) and "
        f"{MOE_MIXTRAL_ROWS} and 16 over 6 experts ({MOE_MIXTRAL}), bit for bit")
    if lib_note:
        say(f"  library_ms none: {lib_note}")
    cfg = get_config("debug-moe")
    router, wg, wu, wd, gen = moe_weights(torch, cfg)
    qg, qu, qd = moe_w8_stacks(wg, wu, wd)
    x, src, counts = moe_inputs(torch, cfg, router, gen, 8)
    for what, call in (("float32 x", lambda: moe.moe_experts(x.float(), src, counts, qg, qu, qd)),
                       ("an int8 gate stack beside bf16 ones",
                        lambda: moe.moe_experts(x, src, counts, qg, wu, wd))):
        try:
            call()
        except ValueError as e:
            say(f"  refuses {what}: {e}")
        else:
            fail(f"moe_experts_w8 took {what}")
    main_key = next(k for k in timings if k.startswith(f"R{MOE_MAIN} "))
    return dict(
        name="moe_experts_w8", route="cuda",
        source="llms_on_kubernetes_tpu_torch/csrc/moe_experts_w8.cu",
        replaces=("none: llms_on_kubernetes_tpu/ops/moe.py:81-82 moe_block's qeinsum on int8 "
                  "expert stacks, left to XLA"),
        max_abs_err=err, **timings[main_key], shape=main_key,
        other_shapes={k: v for k, v in timings.items() if k != main_key},
        bf16_note=("bf16_kernel_ms: the bf16 expert kernel (csrc/moe_experts.cu) on bf16 stacks "
                   "of the same shape, in turns in this run"),
        library_note=("no one PyTorch call computes the int8 product with its scales: the "
                      "gather, torch._grouped_mm x 3 and the SiLU product on bf16 stacks of the "
                      "same shape" if lib_note is None else f"none: {lib_note}"))


def moe_attention_checks(torch, rng, timer) -> tuple[dict, dict]:
    """Kernels 1 and 2 at qwen3-30b-a3b's attention: 32 query heads on 4 KV
    heads (group 8, the decode kernel's largest), d 128. Flash prefill at
    buckets 256 and 1,024 against its plain version and sdpa; paged decode
    at 8 slots (page 64, 32 pages a slot) at the serve shape and at lengths
    over 1..2,048. Returns their other_shapes entries."""
    from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
    from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

    bf16 = torch.bfloat16

    def mk(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", bf16)

    flash = {}
    for T, n in ((256, 200), (1024, 900)):
        q, k, v = mk(1, T, 32, 128), mk(1, T, 4, 128), mk(1, T, 4, 128)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        kw = dict(scale=128 ** -0.5)
        err = check_close(f"flash_prefill group 8 (n_q32 n_kv4 d128) T{T} length {n}",
                          fa.flash_prefill_attention(q, k, v, lengths, **kw)[0, :n],
                          fa.prefill_attention_plain(q, k, v, lengths, **kw)[0, :n],
                          "bfloat16")
        ms = timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw))
        plain = timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, **kw))
        qh, kh, vh = (t[:, :n].transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = timer(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
        b_ms, b_by = bound_ms(*prefill_work([n], 32, 4, 128, 2), "bfloat16")
        flash[f"{MOE_MODEL} group 8: B1 T{T} length {n} n_q32 n_kv4 d128 bf16"] = dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            max_abs_err=err)
        say(f"  timing flash_prefill group 8 T{T} length {n}: ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={b_ms:.4f} library_ms={lib:.4f}")
    decode = {}
    for label, lens in (("lengths 40..47", SERVE_LENS),
                        ("lengths 1,63,64,65,700,1500,2048,0",
                         np.array([1, 63, 64, 65, 700, 1500, 2048, 0]))):
        kp, vp, table = paged_setup(torch, rng, 8, 4, 128, 64, 32, lens, bf16, pool_pages=512)
        q = mk(8, 32, 128)
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        kw = dict(scale=128 ** -0.5)
        err = check_close(f"paged_decode group 8 (n_q32 n_kv4 d128) B8 page64 {label}",
                          pa.paged_decode_attention(q, kp, vp, table, lengths, **kw),
                          pa.paged_decode_attention_plain(q, kp, vp, table, lengths, **kw),
                          "bfloat16", rows=torch.from_numpy(lens > 0).cuda())
        t = decode_timing(timer, lambda: pa.paged_decode_attention(
            q, kp, vp, table, lengths, **kw), lambda: pa.paged_decode_attention_plain(
            q, kp, vp, table, lengths, **kw), lens, write=False, widths=(32, 4, 128, 32))
        decode[f"{MOE_MODEL} group 8: B8 n_q32 n_kv4 d128 page64 {label} bf16"] = dict(
            **t, max_abs_err=err)
        say(f"  timing paged_decode group 8 {label}: ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f}")
    return flash, decode


def check_moe_path(tag: str, launches: dict, replayed: dict, num_layers: int, prefills: int,
                   chunks: int, decode_forwards: int, replays: int, steps: int,
                   kernel: str = "moe_experts") -> None:
    """Every window a graph replay; the expert kernel (``kernel``: the bf16
    one, or ``moe_experts_w8`` for int8 stacks, the other never) twice a
    layer a forward, its decode launches all by replays; flash prefill once
    a layer a prefill call, the decode kernel once a layer a decode step;
    with int8 weights the W8A16 kernel four times a layer a forward (wq,
    wk, wv, wo; an MoE layer's MLP is the expert kernel's)."""
    if replays < 1 or replays * steps != decode_forwards:
        fail(f"{tag}: {replays} replays x {steps} != {decode_forwards} decode forwards: a "
             f"window ran outside the graph")
    forwards = prefills + chunks + decode_forwards
    other = "moe_experts" if kernel == "moe_experts_w8" else "moe_experts_w8"
    want = {kernel: 2 * num_layers * forwards, other: 0,
            "flash_prefill": num_layers * prefills, "paged_decode": num_layers * decode_forwards,
            "w8_matmul": 4 * num_layers * forwards if kernel == "moe_experts_w8" else 0}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            fail(f"{tag}: {name} launched {launches.get(name, 0)} times, expected {n} "
                 f"({prefills} prefill, {chunks} chunk, {decode_forwards} decode forwards of "
                 f"{num_layers} layers)")
    if replayed.get(kernel, 0) != 2 * num_layers * decode_forwards:
        fail(f"{tag}: {kernel} launches by replays {replayed.get(kernel, 0)} != "
             f"2 x {num_layers} x {decode_forwards} decode forwards")


def moe_split(torch, eng, prompts, n_tokens: int) -> dict:
    """The device time of steady decode windows by kernel, under
    torch.profiler: from the step at which every stream has 8 tokens until
    4 more windows were launched. Returns ms by part (experts: the expert
    kernel; attention: flash prefill, paged decode and the window append;
    rest) and the windows launched inside the trace."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from torch.profiler import ProfilerActivity, profile

    sp = SamplingParams(temperature=0.0, max_tokens=n_tokens)
    reqs = [eng.submit(p, sp) for p in prompts]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state, r0, windows = "before", 0, 0
    while eng.has_work():
        if state == "before" and all(len(r.output) >= 8 for r in reqs):
            torch.cuda.synchronize()
            prof.start()
            state, r0 = "on", eng.graph_replays
        eng.step()
        if state == "on" and eng.graph_replays - r0 >= 4:
            torch.cuda.synchronize()
            prof.stop()
            state, windows = "done", eng.graph_replays - r0
    if state != "done":
        fail("phase 9: the profiled streams ended before 4 windows")
    parts = {"experts": 0.0, "attention": 0.0, "rest": 0.0}
    rest_kinds: dict = {}
    rest_ops: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ms = e.self_device_time_total / 1e3
        if "moe_stream" in e.key or "moe_spread" in e.key:    # the expert kernels' bodies
            parts["experts"] += ms
        elif any(k in e.key for k in ("flash_prefill", "paged_decode", "write_window")):
            parts["attention"] += ms
        else:
            parts["rest"] += ms
            kind = rest_kind(e.key)
            rest_kinds[kind] = rest_kinds.get(kind, 0.0) + ms
            n, t = rest_ops.get(e.key, (0, 0.0))
            rest_ops[e.key] = (n + e.count, t + ms)
    return {"parts": parts, "windows": windows, "rest_kinds": rest_kinds,
            "rest_top": sorted(rest_ops.items(), key=lambda kv: -kv[1][1])[:14]}


# the device kernels of a MoE decode window outside the experts and
# attention, by what they do (their names): the projections, the router
# and the LM head are GEMMs; routing is softmax, top-k, cumsum and scatter;
# the combine and the row picks are index and gather kernels; the
# elementwise chain (norms, rope, residual adds, casts, the combine's
# weighting) is elementwise and reduction kernels
REST_KINDS = (("gemm (projections, router, head)", ("gemm", "xmma", "cutlass", "sm90", "gemv",
                                                    "splitk", "cublas", "nvjet")),
              ("routing: softmax, top-k, sort, scan", ("softmax", "topk", "sort", "scan",
                                                       "radix", "bitonic", "cumsum")),
              ("index, gather, scatter (route rows, combine)", ("index", "gather", "scatter")),
              ("reductions (norms, sums)", ("reduce",)),
              ("elementwise (chain, casts, combine arithmetic)", ("elementwise", "vectorized",
                                                                  "unrolled")),
              ("copies and cat", ("copy", "cat", "memcpy", "memset", "fill")))


def rest_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in REST_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (sampling and the rest)"


def moe_in_process(torch) -> dict:
    """B: Qwen3-VL-30B-A3B (its text backbone is qwen3-30b-a3b's widths;
    the published config.json, rope theta 5e6 and interleaved mrope) at
    full width and MOE_INPROC_LAYERS of its 48 layers from ``init_params``
    on the card behind the default Engine: the card's free memory before
    the load and what the model and engine hold; 8 concurrent greedy text
    streams of MOE_NEW tokens, every window a graph replay (device ms each
    by CUDA events), the expert kernel 2 x L times a forward; then the device time of
    steady windows split between the experts, attention and the rest
    (torch.profiler); then phase 10 C's image requests on the same engine."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    cfg = dataclasses.replace(vl_config(QWEN_VL), num_layers=MOE_INPROC_LAYERS)
    free_card(torch, "before the MoE model")
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype="bfloat16", device="cuda")
    eng = Engine(EngineConfig(model=MOE_MODEL), model_config=cfg, params=params)
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    say(f"  {QWEN_VL} (the {MOE_MODEL} backbone: {cfg.num_layers} layers, {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok}): {param_bytes(params) / 1e9:.2f} GB of bf16 "
        f"weights, the tower and mergers among them; the "
        f"card had {free0 / 2**30:.2f} GiB free before the load, the process holds "
        f"{held / 2**30:.2f} GiB with the engine (pool, MoE workspace of "
        f"{eng.moe_workspace.rows} rows, window graph), ready after {ready_s:.1f} s")
    timer = WindowTimer(torch, eng._window)
    run = awq_run(torch, eng, awq_prompts(), [None] * 8, max_tokens=MOE_NEW)
    win_ms = timer.close()["free"]
    check_moe_path(MOE_INPROC_PATH, run["launches"], kernels.replayed_counts(),
                   cfg.num_layers, run["forwards"] - run["decode_forwards"], 0,
                   run["decode_forwards"], run["replays"], eng.config.decode_steps)
    split = moe_split(torch, eng, awq_prompts(), 48)
    parts, nwin = split["parts"], split["windows"]
    total = sum(parts.values())
    say(f"  {MOE_INPROC_PATH}, 8 greedy streams of {MOE_NEW} "
        f"({len(set(map(tuple, run['outs'])))} distinct; the first's head {run['outs'][0][:8]}): "
        f"{run['tok_s']:.1f} decode tok/s, {run['replays']} windows (each one graph replay), "
        f"window device ms median {float(np.median(win_ms)):.3f} (min {min(win_ms):.3f}, max "
        f"{max(win_ms):.3f}); moe_experts {run['launches'].get('moe_experts', 0)} launches = "
        f"2 x {cfg.num_layers} x {run['forwards']} forwards [{card_line()}]")
    say(f"  steady windows under torch.profiler ({nwin} windows launched in the trace): "
        f"device ms a window: experts {parts['experts'] / nwin:.3f}, attention "
        f"{parts['attention'] / nwin:.3f}, rest {parts['rest'] / nwin:.3f} (experts "
        f"{100 * parts['experts'] / max(total, 1e-9):.1f}% of the kernels' time)")
    say("  the rest by kind, device ms a window: " + ", ".join(
        f"{k} {v / nwin:.3f}" for k, v in sorted(split["rest_kinds"].items(),
                                                 key=lambda kv: -kv[1])))
    for name, (n, ms) in split["rest_top"]:
        say(f"    {ms / nwin:8.3f} ms, {n / nwin:6.0f} launches a window: {name[:110]}")
    vision = vl_qwen_images(torch, eng, cfg)
    del eng, params, timer
    return {"launches": run["launches"], "tok_s": run["tok_s"], "window_ms": win_ms,
            "split": split, "free_gib": free0 / 2**30, "held_gib": held / 2**30,
            "vision": vision}


def _drive_moe_router(cfg, model: str = MOE_MODEL, tag: str = MOE_PATH,
                      kernel: str = "moe_experts"):
    """C (F: Mixtral-8x7B's int8 replica): behind ``llkt-router``: a
    streamed chat completion through the router, then 8 concurrent greedy
    journaled streams to the replica; every window a graph replay, the
    expert kernel (``kernel``) 2 x L a forward; the two decode-window series
    of /metrics read; a 4,000-token prompt's TTFT."""

    def drive(base: str, _proc) -> dict:
        router_proc, router = start_router(
            ["--models", f"{model}={base}", "--probe-interval", "0.5"],
            f"chip_smoke_moe_router_{model}.log", [base])
        try:
            http("POST", base + "/debug/kernels/reset")
            k0 = kernel_counts(base)
            chat = chat_stream(router, {
                "model": model, "messages": [{"role": "user", "content": SERVE_TEXT[:60]}],
                "max_tokens": 24, "temperature": 0})
            if chat["choices"][0]["finish_reason"] not in ("length", "stop"):
                fail(f"{tag}: the chat through the router ended {chat['choices'][0]}")
            out: dict = {}

            def one(i):
                out[i] = journaled_stream(base, {"model": model,
                                                 "prompt": SERVE_TEXT[i:i + 40],
                                                 "max_tokens": MOE_NEW, "temperature": 0,
                                                 "stream": True})

            ths = [threading.Thread(target=one, args=(i,)) for i in range(8)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            if len(out) != 8 or any(len(o[0]) != MOE_NEW for o in out.values()):
                fail(f"{tag}: the 8 streams did not all finish with {MOE_NEW} tokens")
            tok_s = (sum(len(o[0]) - 1 for o in out.values())
                     / (max(o[2] for o in out.values()) - min(o[1] for o in out.values())))
            k1 = kernel_counts(base)
            replays = check_graphed(tag, k1, k0)
            d = {k: k1[k] - k0[k] for k in ("prefill_calls", "chunk_calls", "decode_forwards")}
            replayed = {k: n - k0["replayed_launches"].get(k, 0)
                        for k, n in k1["replayed_launches"].items()}
            check_moe_path(tag, k1["launches"], replayed, cfg.num_layers,
                           d["prefill_calls"], d["chunk_calls"], d["decode_forwards"], replays,
                           k1["decode_steps"], kernel)
            _s, raw = http("GET", base + "/metrics")
            names = {ln.split("{")[0].split(" ")[0] for ln in raw.decode().splitlines()
                     if ln and not ln.startswith("#")}
            for name in ("llm_decode_steps_per_dispatch_count", "llm_decode_early_exit_total"):
                if name not in names:
                    fail(f"{tag}: /metrics has no {name}")
            steps_n = metric(base, "llm_decode_steps_per_dispatch_count")
            steps_sum = metric(base, "llm_decode_steps_per_dispatch_sum")
            early = metric(base, "llm_decode_early_exit_total")
            if steps_n < replays:
                fail(f"{tag}: llm_decode_steps_per_dispatch_count {steps_n} < {replays} "
                     f"windows")
            # a long prompt's TTFT (bucket 4,096), twice with other seeded
            # ids (no prefix hit), after the counts above were read
            long_ttft = []
            for seed in (0, 1):
                ids = np.random.default_rng(seed).integers(
                    100, min(50000, cfg.vocab_size), size=MOE_LONG).tolist()
                status, events, t0 = stream(base + "/v1/completions", {
                    "model": model, "prompt": ids, "max_tokens": 4, "temperature": 0,
                    "stream": True})
                if status != 200 or not events:
                    fail(f"{tag}: the {MOE_LONG}-token prompt got HTTP {status}")
                long_ttft.append(1e3 * (events[0][0] - t0))
            say(f"  {tag}: a streamed chat through the router ended whole; 8 greedy "
                f"streams of {MOE_NEW}: {tok_s:.1f} decode tok/s; {kernel} "
                f"{k1['launches'].get(kernel, 0)} launches = 2 x {cfg.num_layers} x "
                f"{sum(d.values())} forwards; /metrics llm_decode_steps_per_dispatch count "
                f"{steps_n:g} sum {steps_sum:g}, llm_decode_early_exit_total {early:g}; a "
                f"{MOE_LONG}-token prompt's TTFT {long_ttft[0]:.1f} ms, then "
                f"{long_ttft[1]:.1f} ms [{card_line()}]")
            return {"launches": k1["launches"], "tok_s": tok_s, "steps": (steps_n, steps_sum),
                    "early_exit": early, "long_ttft_ms": long_ttft}
        finally:
            stop_proc(router_proc)
    return drive


def start_moe_writes() -> dict:
    """Write qwen3-30b-a3b cut to MOE_CKPT_LAYERS layers at full width (the
    Qwen3-MoE tensor names), in bf16 with Qwen3's tokenizer files (the
    ``"qwen3"`` layout), as an fp8 and as an AWQ checkpoint (the routers
    kept in bf16, as published), each in a process of its own."""
    writes = {}
    for q in MOE_CKPT_QUANTS:
        cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch.testing.synth_checkpoint",
               MOE_MODEL, MOE_DIRS[q], "--layers", str(MOE_CKPT_LAYERS),
               *(["--tokenizer", "qwen3"] if q == "bf16" else [f"--{q}"])]
        writes[q] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), time.perf_counter())
    return writes


def expert_from_file(files, q: str, name: str):
    """The int8 QTensor the JAX loader makes of one expert linear of a
    pre-quantized checkpoint (``name`` its HF ``.weight`` name): the
    file's tensor dequantized on the card, transposed to [in, out] and
    quantized over its input axis."""
    from llms_on_kubernetes_tpu_torch.ops.quant import awq_dequantize, fp8_dequantize, quantize

    base = name[:-len("weight")]
    if q == "fp8":
        w = fp8_dequantize(files[name]().cuda(), files[base + "weight_scale"]().cuda()).T
    else:
        w = awq_dequantize(*(files[base + part]().cuda()
                             for part in ("qweight", "qzeros", "scales")))
    return quantize(w, (0,))


def moe_checkpoint(torch, writes: dict) -> dict:
    """D: each 2-layer checkpoint (bf16, fp8, AWQ) loaded in process (layer
    0's router held bit for bit to the file; expert 5's three linears: bf16
    ones to the file, int8 ones to the file's tensors dequantized and
    quantized as the JAX loader does), its greedy stream and logprobs from
    an Engine with ``serve``'s defaults, then ``serve --model <dir>``: the
    same token ids, logprobs within the bf16 tolerance, the bf16 expert
    kernel (bf16) or the int8 expert and W8A16 kernels (fp8, AWQ) launched,
    never the other expert kernel."""
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args
    from llms_on_kubernetes_tpu_torch.engine.engine import (
        Engine, SamplingParams, model_config_for,
    )
    from llms_on_kubernetes_tpu_torch.engine.safetensors import open_dir
    from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params

    out = {}
    for q, (proc, t0) in writes.items():
        path, tag = MOE_DIRS[q], MOE_CKPT_PATHS[q]
        msg, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"synth_checkpoint {MOE_MODEL} --layers {MOE_CKPT_LAYERS} ({q}) exited "
                 f"{proc.returncode}: {msg}")
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        say(f"  wrote {path} ({size / 1e9:.2f} GB), done {time.perf_counter() - t0:.1f} s after "
            f"its start")
        cfg = model_config_for(path, path)
        t1 = time.perf_counter()
        params = load_hf_params(cfg, path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        files = open_dir(path)
        pre = "model.layers.0.mlp."
        if not torch.equal(params["layers"]["router"][0].cpu(), files[pre + "gate.weight"]().T):
            fail(f"{tag}: the router differs from the file's")
        for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            got, name = params["layers"][key][0, 5], pre + f"experts.5.{proj}.weight"
            if q == "bf16":
                if not torch.equal(got.cpu(), files[name]().T):
                    fail(f"{tag}: expert 5's {proj} differs from the file's")
                continue
            want = expert_from_file(files, q, name)
            if not (got.data.dtype == torch.int8 and torch.equal(got.data, want.data)
                    and torch.equal(got.scale, want.scale)):
                fail(f"{tag}: expert 5's {proj} is not the file's tensor quantized to int8")
        ecfg = engine_config_from_args(build_parser().parse_args(["serve", "--model", path]))
        eng = Engine(ecfg, model_config=cfg, params=params)
        prompt = [ord(c) for c in SERVE_TEXT[:40]]
        req = eng.submit(prompt, SamplingParams(temperature=0.0, max_tokens=16, logprobs=1))
        while not req.finished:
            eng.step()
        ref_ids = list(req.output)
        ref_lps = [float(lp[0] if isinstance(lp, (list, tuple)) else lp)
                   for lp in req.output_logprobs]
        del eng, params
        free_card(torch, f"phase 9 D {q} in process done")

        def drive(base: str, _proc, prompt=prompt) -> dict:
            http("POST", base + "/debug/kernels/reset")
            ids, _a, _b, _t = journaled_stream(base, {"model": MOE_MODEL, "prompt": prompt,
                                                      "max_tokens": 16, "temperature": 0,
                                                      "stream": True})
            status, body = http("POST", base + "/v1/completions", {
                "model": MOE_MODEL, "prompt": prompt, "max_tokens": 16, "temperature": 0,
                "logprobs": 1})
            if status != 200:
                fail(f"{tag}: HTTP {status} {body[:200]!r}")
            lps = json.loads(body)["choices"][0]["logprobs"]["token_logprobs"]
            out = {"ids": ids, "lps": lps, "launches": kernel_counts(base)["launches"]}
            if q == "bf16":     # the directory's own Qwen3 tokenizer.json, read by the port
                _drive_tokenizer(base, MOE_MODEL, "qwen3")
            return out

        served = with_server(["--model", path, "--served-model-name", MOE_MODEL],
                             f"chip_smoke_moe_ckpt_{q}.log", drive, pool_args=())
        if served["ids"] != ref_ids:
            fail(f"{tag}: greedy ids {served['ids']} != in process {ref_ids}")
        gap = max(abs(a - b) for a, b in zip(served["lps"], ref_lps))
        if not all(abs(a - b) <= BF16_REL_TOL * max(abs(b), 1.0)
                   for a, b in zip(served["lps"], ref_lps)):
            fail(f"{tag}: logprobs {served['lps']} differ from in process {ref_lps}")
        n = served["launches"]
        want, never = (("moe_experts",), ("moe_experts_w8", "w8_matmul")) if q == "bf16" else \
            (("moe_experts_w8", "w8_matmul"), ("moe_experts",))
        if not all(n.get(k) for k in want) or any(n.get(k) for k in never):
            fail(f"{tag}: launches {n}: {' and '.join(want)} expected, never {never}")
        held = "linears equal the file's" if q == "bf16" else \
            "int8 bytes and scales equal the file's, as the JAX loader makes them"
        say(f"  {tag}: loaded in process in {load_s:.2f} s (layer 0's router and expert 5's "
            f"{held}); serve --model {path}: /health after {served['health_s']:.1f} s, the 16 "
            f"greedy ids equal the in-process engine's, logprobs within {gap:.2e}; " + ", ".join(
                f"{k} {n[k]}" for k in want) + " launches")
        shutil.rmtree(path, ignore_errors=True)
        out[q] = served
    return out


def mixtral_in_process(torch) -> dict:
    """E: Mixtral-8x7B with int8 weights drawn by ``init_params(quantize=
    True)`` (each expert slice quantized as it is drawn: the bf16 model
    never exists) at full width and depth behind the default Engine with
    serve's pool and buckets: the card's free memory and what the model and
    engine hold; 8 concurrent greedy streams of MOE_NEW, every window a
    graph replay (device ms each), the int8 expert kernel 2 x 32 a forward;
    the device time of steady windows split between the experts, attention
    and the rest beside the experts' byte floor; a 4,000-token prompt's
    TTFT, twice."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    cfg = get_config(MOE_MIXTRAL)
    free_card(torch, "before Mixtral-8x7B int8")
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype="bfloat16", device="cuda", quantize=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held_params = torch.cuda.memory_allocated()
    if params["layers"]["w_gate"].data.dtype != torch.int8:
        fail(f"{MIXTRAL_INPROC_PATH}: the expert stacks are not int8")
    ecfg = engine_config_from_args(build_parser().parse_args(["serve", *MIXTRAL_SERVE]))
    eng = Engine(ecfg, model_config=cfg, params=params)
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    say(f"  {MOE_MIXTRAL} ({cfg.num_layers} layers, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}, D {cfg.hidden_size}, F {cfg.intermediate_size}): "
        f"{param_bytes(params) / 1e9:.2f} GB of int8 weights, scales and bf16 embedding and "
        f"head (drawn quantized in {init_s:.1f} s; the process held {held_params / 2**30:.2f} "
        f"GiB then); the card had {free0 / 2**30:.2f} GiB free before, the process holds "
        f"{held / 2**30:.2f} GiB with the engine (pool of {ecfg.num_pages} pages, MoE "
        f"workspace of {eng.moe_workspace.rows} rows, window graph), ready after {ready_s:.1f} s")
    timer = WindowTimer(torch, eng._window)
    run = awq_run(torch, eng, awq_prompts(), [None] * 8, max_tokens=MOE_NEW)
    win_ms = timer.close()["free"]
    check_moe_path(MIXTRAL_INPROC_PATH, run["launches"], kernels.replayed_counts(),
                   cfg.num_layers, run["forwards"] - run["decode_forwards"], 0,
                   run["decode_forwards"], run["replays"], eng.config.decode_steps,
                   kernel="moe_experts_w8")
    split = moe_split(torch, eng, awq_prompts(), 48)
    parts, nwin = split["parts"], split["windows"]
    total = sum(parts.values())
    # the experts' floor a window: each decode step reads every touched
    # expert's int8 matrices (8 tokens x top-2 touch about all 8) a layer
    D, Fd = cfg.hidden_size, cfg.intermediate_size
    floor = (eng.config.decode_steps * cfg.num_layers * cfg.num_experts
             * (3 * D * Fd + 4 * (2 * Fd + D)) / PEAK_BYTES * 1e3)
    say(f"  {MIXTRAL_INPROC_PATH}, 8 greedy streams of {MOE_NEW} "
        f"({len(set(map(tuple, run['outs'])))} distinct; the first's head {run['outs'][0][:8]}): "
        f"{run['tok_s']:.1f} decode tok/s, {run['replays']} windows (each one graph replay), "
        f"window device ms median {float(np.median(win_ms)):.3f} (min {min(win_ms):.3f}, max "
        f"{max(win_ms):.3f}); moe_experts_w8 {run['launches'].get('moe_experts_w8', 0)} "
        f"launches = 2 x {cfg.num_layers} x {run['forwards']} forwards, w8_matmul "
        f"{run['launches'].get('w8_matmul', 0)} = 4 x {cfg.num_layers} x {run['forwards']} "
        f"[{card_line()}]")
    say(f"  steady windows under torch.profiler ({nwin} windows launched in the trace): "
        f"device ms a window: experts {parts['experts'] / nwin:.3f} (their byte floor with all "
        f"{cfg.num_experts} experts touched: {floor:.3f}, {eng.config.decode_steps} steps), "
        f"attention {parts['attention'] / nwin:.3f}, rest {parts['rest'] / nwin:.3f} (experts "
        f"{100 * parts['experts'] / max(total, 1e-9):.1f}% of the kernels' time)")
    say("  the rest by kind, device ms a window: " + ", ".join(
        f"{k} {v / nwin:.3f}" for k, v in sorted(split["rest_kinds"].items(),
                                                 key=lambda kv: -kv[1])))
    for name, (n, ms) in split["rest_top"]:
        say(f"    {ms / nwin:8.3f} ms, {n / nwin:6.0f} launches a window: {name[:110]}")
    ttft = []
    for seed in (0, 1):
        ids = np.random.default_rng(seed).integers(100, cfg.vocab_size, size=MOE_LONG).tolist()
        req = eng.submit(ids, SamplingParams(temperature=0.0, max_tokens=2))
        while not req.finished:
            eng.step()
        ttft.append(1e3 * (req.first_token_at - req.submitted_at))
    say(f"  {MIXTRAL_INPROC_PATH}: a {MOE_LONG}-token prompt's TTFT {ttft[0]:.1f} ms, then "
        f"{ttft[1]:.1f} ms (bucket 4,096, one prefill)")
    del eng, params, timer
    return {"launches": run["launches"], "tok_s": run["tok_s"], "window_ms": win_ms,
            "split": split, "floor_ms": floor, "free_gib": free0 / 2**30,
            "held_gib": held / 2**30, "long_ttft_ms": ttft}


# ---------------------------------------------------------------------------
# phase 10: the vision path
# ---------------------------------------------------------------------------

GEMMA_VL = "google/gemma-3-27b-it"
QWEN_VL = "Qwen/Qwen3-VL-30B-A3B-Instruct"
GEMMA_VL_NAME = "gemma-3-27b-it"
QWEN_VL_NAME = "qwen3-vl-30b-a3b"
VL_NEW = 64                  # greedy tokens a phase-10 stream generates
VL_CKPT_LAYERS = 2
VL_GAP_TOKENS = 96           # tokens of each text stream that an image chat cuts across
VL_TOKENIZERS = {GEMMA_VL: "gemma3", QWEN_VL: "qwen3vl"}
# D's checkpoints, (model, format): pre-quantized as the reference deploys
# the two models (gemma-3-27b-it-FP8-Dynamic, a Qwen3-VL-30B-A3B AWQ
# checkpoint) and served int8 as the JAX loader serves them, and Qwen3-VL
# in bf16 as it is published
VL_CKPTS = ((GEMMA_VL, "fp8"), (QWEN_VL, "bf16"), (QWEN_VL, "awq"))
VL_DIRS = {(m, q): os.path.join(OUT_DIR, f"{m.split('/')[1].lower()}-2l-{q}")
           for m, q in VL_CKPTS}
GEMMA_VL_PATH = f"{GEMMA_VL_NAME} image requests in process"
GEMMA_VL_HTTP_PATH = f"{GEMMA_VL_NAME} image requests through the port's HTTP server"
QWEN_VL_PATH = f"{QWEN_VL_NAME} image requests in process"
VL_CKPT_PATHS = {(m, q): f"{m.split('/')[1]} {VL_CKPT_LAYERS} layers "
                         f"{'' if q == 'bf16' else q + ' '}checkpoint serve behind llkt-router"
                 for m, q in VL_CKPTS}
# A: gemma-3-27b's attention (32 query heads on 16 KV heads, d 128): bucket,
# length, the image runs' first positions (256 soft tokens each)
VL_MASK_CASES = ((1024, 900, (100,)), (4096, 4000, (200, 1200, 2200, 3200)))


def vl_config(repo: str):
    from llms_on_kubernetes_tpu_torch.configs import PUBLISHED_MM_CONFIGS, from_hf_config

    return from_hf_config(PUBLISHED_MM_CONFIGS[repo], repo)


def encode_png(rgb: np.ndarray) -> bytes:
    """An RGB uint8 image as a PNG whose every row uses the Paeth filter
    (the decoder's slowest path; the card's machine has no PIL)."""
    import struct
    import zlib

    H, W, _ = rgb.shape
    cur = rgb.reshape(H, W * 3).astype(np.int32)
    up = np.vstack([np.zeros((1, W * 3), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((H, 3), np.int32), cur[:, :-3]])
    ul = np.hstack([np.zeros((H, 3), np.int32), up[:, :-3]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    rows = np.hstack([np.full((H, 1), 4, np.int32), (cur - pred) & 255]).astype(np.uint8)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def vl_picture(seed: int, h: int, w: int) -> np.ndarray:
    """A photo-like RGB image: smooth gradients and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (1 + seed % 3) + y) % 256, (y * 2 + seed * 40) % 256,
                     (x + y * 3 + seed * 90) % 256], axis=-1)
    return np.clip(base + rng.integers(-8, 9, (h, w, 3)), 0, 255).astype(np.uint8)


def data_url(png: bytes, kind: str = "png") -> str:
    import base64

    return f"data:image/{kind};base64," + base64.b64encode(png).decode()


def mm_mask_work(groups: np.ndarray, T: int, n: int, n_q: int, n_kv: int, d: int, window):
    """FLOPs and bytes kernel 1 needs under the image-block mask, as
    ``prefill_work`` counts them: the visible (query, key) pairs of the n
    valid rows (causal and in the window, or in the query's own image),
    q, k, v and out of n rows moved once, the groups and the length read
    once. Also the 64 x 64 tiles that hold a visible pair, which the
    kernel computes."""
    q, k = np.arange(T)[:, None], np.arange(T)[None, :]
    mask = k <= q
    if window:
        mask &= k > q - window
    mask |= (groups[:, None] >= 0) & (groups[:, None] == groups[None, :])
    mask &= (k < n) & (q < n)
    pairs = int(mask.sum())
    tiles = int(mask.reshape(T // 64, 64, T // 64, 64).any(axis=(1, 3)).sum())
    nbytes = (2 * n * n_q * d + 2 * n * n_kv * d) * 2 + 4 * T + 4
    return 4.0 * d * n_q * pairs, nbytes, pairs, tiles


def vl_mask_checks(torch, timer) -> dict:
    """A: kernel 1 with ``mm_groups`` at gemma-3-27b's attention against its
    plain version (the bf16 row tolerance), window 1,024 and global, one
    image at bucket 1,024 and four at 4,096; ms, plain and sdpa with the
    same boolean mask in turns; bound_ms from the pairs the mask keeps.
    All-text groups give the bits of mm_groups=None."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa

    cfg = vl_config(GEMMA_VL)
    n_q, n_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t_img = cfg.vision.mm_tokens_per_image
    scale = (cfg.query_pre_attn_scalar or d) ** -0.5
    rng = np.random.default_rng(10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for T, n, starts in VL_MASK_CASES:
        def mk(h):
            return torch.from_numpy(rng.normal(size=(1, T, h, d)).astype(np.float32)).to(
                "cuda", torch.bfloat16)
        q, k, v = mk(n_q), mk(n_kv), mk(n_kv)
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        g = np.full((1, T), -1, np.int32)
        for i, s in enumerate(starts):
            g[0, s:s + t_img] = i
        groups = torch.from_numpy(g).cuda()
        text = torch.full_like(groups, -1)
        # the decoder computes the spans once a forward: timed calls take them
        spans = fa.mm_spans(groups)
        for window in (cfg.sliding_window, None):
            kw = dict(scale=scale, sliding_window=window)
            tag = (f"flash_prefill {GEMMA_VL_NAME} mm_groups B1 T{T} length {n} "
                   f"{len(starts)} image(s) of {t_img} window {window or 'global'}")
            kernels.reset_launches()
            got = fa.flash_prefill_attention(q, k, v, lengths, mm_groups=groups,
                                             group_spans=spans, **kw)
            if kernels.launch_counts().get("flash_prefill") != 1:
                fail(f"{tag}: the wrapper did not launch the kernel")
            if not torch.equal(got, fa.flash_prefill_attention(q, k, v, lengths,
                                                               mm_groups=groups, **kw)):
                fail(f"{tag}: the spans computed in the wrapper give other bits")
            err = check_close(tag, got[0, :n], fa.prefill_attention_plain(
                q, k, v, lengths, mm_groups=groups, **kw)[0, :n], "bfloat16")
            if not torch.equal(fa.flash_prefill_attention(q, k, v, lengths, mm_groups=text, **kw),
                               fa.flash_prefill_attention(q, k, v, lengths, **kw)):
                fail(f"{tag}: all-text groups differ from mm_groups=None")
            gm = torch.from_numpy(g[0, :n]).cuda()
            kq = torch.arange(n, device="cuda")
            mask = kq[None, :] <= kq[:, None]
            if window:
                mask &= kq[None, :] > kq[:, None] - window
            mask |= (gm[:, None] >= 0) & (gm[:, None] == gm[None, :])
            qh, kh, vh = (t[:, :n].transpose(1, 2) for t in (q, k, v))
            ms, none, plain, lib, ms2 = (
                timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, mm_groups=groups,
                                                         group_spans=spans, **kw)),
                timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, **kw)),
                timer(lambda: fa.prefill_attention_plain(q, k, v, lengths, mm_groups=groups,
                                                         **kw), reps=3),
                timer(lambda: sdpa(qh, kh, vh, attn_mask=mask[None, None], scale=scale,
                                   enable_gqa=True)),
                timer(lambda: fa.flash_prefill_attention(q, k, v, lengths, mm_groups=groups,
                                                         group_spans=spans, **kw)))
            flops, nbytes, pairs, tiles = mm_mask_work(g[0], T, n, n_q, n_kv, d, window)
            b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
            out[tag[len("flash_prefill "):] + " bf16"] = dict(
                ms=ms, ms_again=ms2, ms_without_groups=none, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by,
                library_ms=lib, max_abs_err=err, visible_pairs=pairs, kept_tiles=tiles)
            say(f"  timing {tag}: ms={ms:.4f} (again {ms2:.4f}; causal without the groups "
                f"{none:.4f}) plain_ms={plain:.4f} "
                f"library_ms={lib:.4f} (sdpa, the same boolean mask) bound_ms={b_ms:.4f} "
                f"({b_by}; {pairs} visible pairs, {tiles} of {(T // 64) ** 2} tiles kept) "
                f"[{card_line()}]")
    return out


def start_vl_writes() -> dict:
    """Write each reference default model cut to VL_CKPT_LAYERS layers at
    full width, with its tokenizer, in each format of VL_CKPTS (fp8 and AWQ:
    the text model's linears; routers and tower kept in bf16), in
    processes of their own."""
    writes = {}
    for (repo, q), path in VL_DIRS.items():
        cmd = [sys.executable, "-m", "llms_on_kubernetes_tpu_torch.testing.synth_checkpoint",
               repo, path, "--layers", str(VL_CKPT_LAYERS), "--tokenizer", VL_TOKENIZERS[repo],
               *([] if q == "bf16" else [f"--{q}"])]
        writes[repo, q] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           time.perf_counter())
    return writes


class TowerTimer:
    """Wraps an engine's ``encode_images``: the device ms of each call
    (synchronized before and after, CUDA events around it)."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.inner = torch, eng, eng.encode_images
        self.ms: list = []
        eng.encode_images = self

    def __call__(self, images):
        torch = self.torch
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.inner(images)
        e.record()
        torch.cuda.synchronize()
        self.ms.append(s.elapsed_time(e))
        return out

    def close(self) -> None:
        self.eng.encode_images = self.inner


def vl_request(eng, cfg, pixels: list, text_ids: list, n_tokens: int, logprobs: int = 0):
    """A prompt of image runs (one an image) and ``text_ids``, submitted."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    run = [cfg.boi_token_id] + [cfg.image_token_id] * cfg.vision.mm_tokens_per_image + [
        cfg.eoi_token_id]
    prompt = [2] + run * len(pixels) + list(text_ids)
    return eng.submit(prompt, SamplingParams(temperature=0.0, max_tokens=n_tokens,
                                             logprobs=logprobs), images=pixels)


def vl_finish(eng, reqs) -> None:
    while not all(r.finished for r in reqs):
        eng.step()


def vl_mixed_streams(torch, eng, cfg, pixels: list, tag: str) -> dict:
    """8 greedy streams of VL_NEW, 4 carrying an image: decode tok/s (the
    tokens after each first one over the span from the first first token
    to the last finish), the image requests' TTFT, the launches."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    kernels.reset_launches()
    m0 = eng.mm_prefill_calls
    sp = SamplingParams(temperature=0.0, max_tokens=VL_NEW)
    reqs = []
    for i in range(8):
        if i % 2 == 0:
            reqs.append(vl_request(eng, cfg, [pixels[i // 2 % len(pixels)]],
                                   [ord(c) for c in SERVE_TEXT[i:i + 24]], VL_NEW))
        else:
            reqs.append(eng.submit([ord(c) for c in SERVE_TEXT[i:i + 40]], sp))
    t_all = None
    while not all(r.finished for r in reqs):
        eng.step()
        if t_all is None and all(r.output for r in reqs):
            # every stream has its first token: all 8 decode from here on,
            # the 4 images' K/V in the pool
            t_all, base = time.monotonic(), sum(len(r.output) for r in reqs)
    if any(len(r.output) != VL_NEW for r in reqs):
        fail(f"{tag}: finishes {[(r.finish_reason, len(r.output)) for r in reqs]}")
    span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    tok_s = sum(len(r.output) - 1 for r in reqs) / span
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for r in reqs[::2]]
    steady = (sum(len(r.output) for r in reqs) - base) / (
        max(r.finished_at for r in reqs) - t_all)
    launches = kernels.launch_counts()
    mm = eng.mm_prefill_calls - m0
    if mm != 4 or launches.get("flash_prefill", 0) < cfg.num_layers * mm:
        fail(f"{tag}: {mm} multimodal prefills, flash_prefill launched "
             f"{launches.get('flash_prefill', 0)} times (< {cfg.num_layers} x {mm})")
    say(f"  {tag}: 8 greedy streams of {VL_NEW}, 4 with an image: {tok_s:.1f} decode tok/s "
        f"over the whole span, {steady:.1f} once all 8 had their first token; the image "
        f"requests' TTFT ms {[round(t, 1) for t in ttft]}; flash_prefill "
        f"{launches.get('flash_prefill', 0)} launches ({mm} multimodal prefills of "
        f"{cfg.num_layers} layers among them) [{card_line()}]")
    return {"tok_s": tok_s, "steady_tok_s": steady, "ttft_ms": ttft, "launches": launches,
            "outs": [list(r.output) for r in reqs]}


def vl_ttft_split(torch, eng, cfg, png: bytes, tag: str) -> dict:
    """One image request from PNG bytes, alone: the host's decode and
    preprocessing, the tower, and the rest of its TTFT (the prefill and
    the first token's read)."""
    from llms_on_kubernetes_tpu_torch.engine import images
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    t0 = time.perf_counter()
    rgb = images.decode_png(png)
    t1 = time.perf_counter()
    if cfg.vision.family == "qwen3vl":
        px = images.preprocess_image_qwen3vl(rgb, cfg.vision)
    else:
        px = images.preprocess_image(rgb, cfg.vision.image_size)
    t2 = time.perf_counter()
    tower = TowerTimer(torch, eng)
    eng.allocator.prefix_caching = False        # both requests below run cold
    try:
        req = vl_request(eng, cfg, [px], [ord(c) for c in "Describe the image."], 4)
        while not req.output:
            eng.step()
        t3 = time.perf_counter()
        vl_finish(eng, [req])
    finally:
        tower.close()
    dec, pre, tw = (t1 - t0) * 1e3, (t2 - t1) * 1e3, tower.ms[0]
    total = (t3 - t0) * 1e3
    # a text request of the same length, for the prefill's share
    text = eng.submit([int(t) for t in np.random.default_rng(7).integers(300, 9000, len(
        req.prompt))], SamplingParams(temperature=0.0, max_tokens=4))
    while not text.output:
        eng.step()
    text_ms = (text.first_token_at - text.submitted_at) * 1e3
    vl_finish(eng, [text])
    eng.allocator.prefix_caching = True
    out = {"decode_ms": dec, "resize_ms": pre, "tower_ms": tw,
           "prefill_ms": total - dec - pre - tw, "ttft_ms": total, "image": rgb.shape[:2],
           "grid": px.shape[:2], "text_ttft_ms": text_ms}
    say(f"  {tag}: an image request from a {rgb.shape[1]}x{rgb.shape[0]} PNG ({len(png)} "
        f"bytes), TTFT {total:.1f} ms = host PNG decode {dec:.1f} + resize and normalise "
        f"{pre:.1f} (to {px.shape[1]}x{px.shape[0]}) + tower {tw:.1f} + prefill and first "
        f"token {out['prefill_ms']:.1f}; a {len(req.prompt)}-token text request's TTFT "
        f"{text_ms:.1f} [{card_line()}]")
    return out


def vl_host_ms(cfg, pngs: dict) -> dict:
    """The host's PNG decode and resize ms of each image (3 runs each, the
    least)."""
    from llms_on_kubernetes_tpu_torch.engine import images

    out = {}
    for label, png in pngs.items():
        dec, res = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            rgb = images.decode_png(png)
            t1 = time.perf_counter()
            if cfg.vision.family == "qwen3vl":
                images.preprocess_image_qwen3vl(rgb, cfg.vision)
            else:
                images.preprocess_image(rgb, cfg.vision.image_size)
            dec.append((t1 - t0) * 1e3)
            res.append((time.perf_counter() - t1) * 1e3)
        out[label] = {"decode_ms": min(dec), "resize_ms": min(res)}
        say(f"  host {label} PNG ({len(png)} bytes, every row Paeth): decode "
            f"{min(dec):.1f} ms, resize and normalise for {cfg.name} {min(res):.1f} ms "
            f"(least of 3)")
    return out


def vl_tower_ms(torch, eng, cfg, pixels: list) -> list:
    """Device ms of the tower an image (CUDA events, after a warm call)."""
    eng.encode_images(pixels[:1])
    out = []
    for px in pixels:
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        eng.encode_images([px])
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return out


def vl_repeat_checks(eng, cfg, px, tag: str) -> dict:
    """One image request's greedy stream: cold, cold again (the prefix
    cache off), then twice through a prefix hit that covers the image (the
    chunk path). The cold runs are equal, the hit runs are equal, and a
    hit run equals the cold one or flips only at a near-tie
    (``flip_margin``)."""
    text = [ord(c) for c in SERVE_TEXT[:70]]
    runs = []
    alloc = eng.allocator
    for caching in (True, False, True, True):
        alloc.prefix_caching = caching
        c0, h0 = eng.chunk_calls, alloc.hit_tokens_total
        r = vl_request(eng, cfg, [px], text, 16, logprobs=1)
        vl_finish(eng, [r])
        runs.append((list(r.output), list(r.output_logprobs), eng.chunk_calls - c0,
                     alloc.hit_tokens_total - h0))
    alloc.prefix_caching = True
    (cold, lps, _, _), (cold2, _, _, _), (hit, _, hc, hh), (hit2, _, _, _) = runs
    if cold2 != cold:
        fail(f"{tag}: the second cold run {cold2} != the first {cold}")
    if hc < 1 or hh < cfg.vision.mm_tokens_per_image + 3:
        fail(f"{tag}: the third run took {hc} chunk calls for a {hh}-token hit, which does "
             f"not cover the image")
    if hit2 != hit:
        fail(f"{tag}: the two prefix-hit runs differ: {hit} != {hit2}")
    flip = flip_margin(cold, lps, hit)
    if flip is not None and not flip[1] <= flip[2]:
        fail(f"{tag}: through the prefix hit the stream flips at {flip[0]} by {flip[1]} nats, "
             f"past the bf16 near-tie bound {flip[2]}")
    say(f"  {tag}: one image request's 16 greedy tokens equal on a second cold submission; "
        f"through a {hh}-token prefix hit covering the image (the chunk path) equal twice, "
        + ("and equal to the cold run" if flip is None else
           f"and against the cold run a near-tie flip at {flip[0]} ({flip[1]} nats <= "
           f"{flip[2]})"))
    return {"ids": cold, "hit_tokens": hh, "flip": flip}


def vl_http_checks(torch, eng, cfg, tok_dir: str, png: bytes, big_png: bytes) -> dict:
    """D (in process): the engine behind the port's HTTP server with the
    family's tokenizer: a streamed image chat whose usage counts the soft
    tokens, and a JPEG, a video_url and a remote URL each answered 400;
    then the text streams' inter-token gaps while ``big_png`` is decoded
    on its request thread (``vl_decode_interference``)."""
    from llms_on_kubernetes_tpu_torch import kernels
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import JsonTokenizer
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

    tok = JsonTokenizer(tok_dir)
    srv = OpenAIServer(eng, tok, cfg.name)
    base = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    try:
        kernels.reset_launches()
        m0 = eng.mm_prefill_calls
        usage = vl_chat_checks(base, cfg.name, png, tok, cfg, GEMMA_VL_HTTP_PATH)
        launches = kernels.launch_counts()
        if eng.mm_prefill_calls - m0 != 1 or not launches.get("flash_prefill"):
            fail(f"{GEMMA_VL_HTTP_PATH}: {eng.mm_prefill_calls - m0} multimodal prefills")
        interference = vl_decode_interference(base, cfg.name, big_png, srv)
    finally:
        srv.close()
    return {"launches": launches, "usage": usage, "interference": interference}


def vl_decode_interference(base: str, model: str, png: bytes, srv) -> dict:
    """4 greedy text chats of VL_GAP_TOKENS streamed through the HTTP
    server, alone and then with an image chat of ``png`` sent 0.4 s after
    them: the text streams' gaps between token frames (client clock)
    overall, and those that end while the image's PNG is decoded, resized
    and normalised on its request thread (``preprocess_images``, timed in
    place) against the gaps of the run without the image."""
    import threading

    window: list = []
    inner = srv.preprocess_images

    def timed(images):
        t0 = time.perf_counter()
        try:
            return inner(images)
        finally:
            window.append((t0, time.perf_counter()))
    srv.preprocess_images = timed

    def run(with_image: bool) -> list:
        frames: list = [None] * 4

        def text(i):
            body = {"model": model, "messages": [{"role": "user",
                                                  "content": SERVE_TEXT[i:i + 40]}],
                    "max_tokens": VL_GAP_TOKENS, "temperature": 0, "stream": True,
                    "logit_bias": BYTE_BIAS}
            status, _h, lines, _t0 = stream_lines(base + "/v1/chat/completions", body)
            frames[i] = [t for t, ln in lines if ln.startswith("data: {")
                         and '"content"' in ln] if status == 200 else None

        ths = [threading.Thread(target=text, args=(i,)) for i in range(4)]
        for t in ths:
            t.start()
        if with_image:
            time.sleep(0.4)
            status, _h, lines, _t0 = stream_lines(base + "/v1/chat/completions",
                                                  vl_chat_body(model, data_url(png)))
            if status != 200 or lines[-1][1] != "data: [DONE]":
                fail(f"{GEMMA_VL_HTTP_PATH}: the image chat beside text streams: HTTP {status}")
        for t in ths:
            t.join(timeout=600)
        if any(f is None or len(f) < VL_GAP_TOKENS // 2 for f in frames):
            fail(f"{GEMMA_VL_HTTP_PATH}: text streams' token frames "
                 f"{[None if f is None else len(f) for f in frames]}")
        return frames

    def gaps(frames):
        return [(b, b - a) for f in frames for a, b in zip(f, f[1:])]

    try:
        alone = run(False)
        beside = run(True)
    finally:
        srv.preprocess_images = inner
    if len(window) != 1:
        fail(f"{GEMMA_VL_HTTP_PATH}: {len(window)} image preprocessings, expected 1")
    w0, w1 = window[0]
    during = [g for t, g in gaps(beside) if w0 < t <= w1]
    # token frames a second: alone once all 4 stream, beside inside the window
    t_all = max(f[0] for f in alone)
    rate_alone = sum(t > t_all for f in alone for t in f) / (max(f[-1] for f in alone) - t_all)
    rate_during = sum(w0 < t <= w1 for f in beside for t in f) / (w1 - w0)
    alone, beside = gaps(alone), gaps(beside)

    def stats(gaps):
        ms = np.array(gaps) * 1e3 if gaps else np.zeros(1)
        return {"n": len(gaps), "median_ms": float(np.median(ms)),
                "p90_ms": float(np.percentile(ms, 90)), "max_ms": float(ms.max())}
    out = {"decode_window_ms": (w1 - w0) * 1e3, "alone": stats([g for _, g in alone]),
           "during_decode": stats(during), "beside_all": stats([g for _, g in beside]),
           "tok_s_alone": rate_alone, "tok_s_during_decode": rate_during}
    say(f"  {GEMMA_VL_HTTP_PATH}: 4 text streams of {VL_GAP_TOKENS}, alone "
        f"{rate_alone:.1f} tok/s, gaps between token frames median "
        f"{out['alone']['median_ms']:.1f} ms, p90 {out['alone']['p90_ms']:.1f}, max "
        f"{out['alone']['max_ms']:.1f}; while a {len(png)}-byte PNG is decoded and resized on "
        f"its request thread ({out['decode_window_ms']:.1f} ms): {rate_during:.1f} tok/s, "
        f"{len(during)} gaps, median {out['during_decode']['median_ms']:.1f}, p90 "
        f"{out['during_decode']['p90_ms']:.1f}, max {out['during_decode']['max_ms']:.1f}; "
        f"over the whole run with the image (its prefill included) max gap "
        f"{out['beside_all']['max_ms']:.1f} [{card_line()}]")
    return out


def vl_chat_body(model: str, url: str, kind: str = "image_url", images: int = 1) -> dict:
    parts = [{"type": "text", "text": "Look at this: "}]
    parts += [{"type": kind, kind: {"url": url}}] * images
    parts.append({"type": "text", "text": " What is in it?"})
    return {"model": model, "messages": [{"role": "user", "content": parts}],
            "max_tokens": 12, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}, "logit_bias": BYTE_BIAS}


def vl_expected_prompt(tok, cfg, images: int = 1) -> int:
    """The prompt tokens an image chat counts: the template's ids, each
    image marker spliced into [boi, soft tokens, eoi]."""
    msgs = [{"role": "user", "content": [{"type": "text", "text": "Look at this: "}]
             + [{"type": "image"}] * images + [{"type": "text", "text": " What is in it?"}]}]
    ids = tok.apply_chat_template(msgs)
    extra = sum(1 for t in ids if t in (cfg.image_token_id, cfg.eoi_token_id))
    return len(ids) - extra + images * (cfg.vision.mm_tokens_per_image + 1)


def vl_chat_checks(base: str, model: str, png: bytes, tok, cfg, tag: str,
                   cap: bool = False) -> dict:
    status, _h, lines, _t0 = stream_lines(base + "/v1/chat/completions",
                                          vl_chat_body(model, data_url(png)))
    if status != 200 or lines[-1][1] != "data: [DONE]":
        fail(f"{tag}: image chat HTTP {status}, last line {lines[-1:]!r}")
    frames = [json.loads(ln[6:]) for _t, ln in lines[:-1] if ln.startswith("data: {")]
    usage = next((f["usage"] for f in frames if f.get("usage")), None)
    want = vl_expected_prompt(tok, cfg)
    if not usage or usage["prompt_tokens"] != want:
        fail(f"{tag}: usage {usage}, expected {want} prompt tokens with the soft tokens")
    text = "".join(ch["delta"].get("content") or "" for f in frames for ch in f["choices"])
    refused = {}
    jpeg = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64)
    cases = {"jpeg": vl_chat_body(model, data_url(jpeg, "jpeg")),
             "video_url": vl_chat_body(model, "data:video/mp4;base64,AAAA", kind="video_url"),
             "remote": vl_chat_body(model, "https://example.invalid/cat.png")}
    if cap:
        cases["2 images over --max-images-per-request 1"] = vl_chat_body(
            model, data_url(png), images=2)
    for name, body in cases.items():
        st, raw = http("POST", base + "/v1/chat/completions", body)
        if st != 400:
            fail(f"{tag}: {name} answered HTTP {st}, not 400: {raw[:200]!r}")
        refused[name] = json.loads(raw)["error"]["message"][:90]
    say(f"  {tag}: a streamed image chat ({usage['prompt_tokens']} prompt tokens, "
        f"{cfg.vision.mm_tokens_per_image} of them soft; {usage['completion_tokens']} "
        f"completion tokens: {text[:40]!r}); 400 for " + "; ".join(
            f"{k} ({v!r})" for k, v in refused.items()))
    return usage


def vl_gemma(torch, pixels_png: dict) -> dict:
    """B (and D's in-process server): gemma-3-27b-it at full width."""
    from llms_on_kubernetes_tpu_torch.engine import images
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_tokenizer

    cfg = vl_config(GEMMA_VL)
    free_card(torch, "before gemma-3-27b-it")
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype="bfloat16", device="cuda")
    # 62 layers x 16 KV heads x 128 x 2 x 2 bytes = 508 KB of KV a token:
    # 288 pages of 64 tokens (9.4 GB) beside the 54 GB of weights
    eng = Engine(EngineConfig(model=GEMMA_VL_NAME, num_pages=288, pages_per_slot=32,
                              prefill_buckets=(64, 512, 1024)), model_config=cfg,
                 params=params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    text_b = param_bytes({k: v for k, v in params.items() if k != "vision"})
    say(f"  {GEMMA_VL_NAME} (config.json of {GEMMA_VL}: {cfg.num_layers} layers of "
        f"{cfg.hidden_size}, SigLIP {cfg.vision.num_layers} x {cfg.vision.hidden_size} at "
        f"{cfg.vision.image_size} px, patch {cfg.vision.patch_size}, "
        f"{cfg.vision.mm_tokens_per_image} soft tokens): {text_b / 1e9:.2f} GB of bf16 text "
        f"weights, {param_bytes(params['vision']) / 1e9:.3f} GB of tower; the card had "
        f"{free0 / 2**30:.2f} GiB free, the process holds {held / 2**30:.2f} GiB with the "
        f"engine, ready after {time.perf_counter() - t0:.1f} s")
    rgb = {k: images.decode_png(v) for k, v in pixels_png.items()}
    pixels = [images.preprocess_image(rgb[k], cfg.vision.image_size) for k in rgb]
    host = vl_host_ms(cfg, pixels_png)
    tower = vl_tower_ms(torch, eng, cfg, pixels)
    say(f"  {GEMMA_VL_NAME} tower, device ms an image: "
        f"{', '.join(f'{t:.2f}' for t in tower)} [{card_line()}]")
    split = [vl_ttft_split(torch, eng, cfg, pixels_png["896x896"], GEMMA_VL_PATH + f" ({k})")
             for k in ("first", "again")]
    mixed = vl_mixed_streams(torch, eng, cfg, pixels, GEMMA_VL_PATH)
    repeat = vl_repeat_checks(eng, cfg, pixels[0], GEMMA_VL_PATH)
    tok_dir = os.path.join(OUT_DIR, "gemma3-tokenizer")
    write_tokenizer(tok_dir, "gemma3")
    served = vl_http_checks(torch, eng, cfg, tok_dir, pixels_png["896x896"],
                            pixels_png["1600x1200"])
    shutil.rmtree(tok_dir, ignore_errors=True)
    del eng, params
    free_card(torch, "gemma-3-27b-it done")
    return {"tower_ms": tower, "host": host, "split": split, "mixed": mixed, "repeat": repeat,
            "served": served, "launches": mixed["launches"]}


def vl_qwen_images(torch, eng, cfg) -> dict:
    """C: the Qwen3-VL engine of phase 9 B with images of two aspect ratios
    (two grids): the tower ms, an image request's TTFT split, 8 streams with
    images in flight."""
    from llms_on_kubernetes_tpu_torch.engine import images

    pngs = {"1600x1200": encode_png(vl_picture(3, 1200, 1600)),
            "600x1000": encode_png(vl_picture(4, 1000, 600))}
    pixels = [images.preprocess_image_qwen3vl(images.decode_png(p), cfg.vision)
              for p in pngs.values()]
    grids = [px.shape[:2] for px in pixels]
    if len(set(grids)) != 2:
        fail(f"{QWEN_VL_PATH}: the two aspect ratios gave grids {grids}")
    host = vl_host_ms(cfg, pngs)
    tower = vl_tower_ms(torch, eng, cfg, pixels)
    say(f"  {QWEN_VL_NAME} tower, device ms an image: " + ", ".join(
        f"{t:.2f} ({g[1]}x{g[0]} px)" for t, g in zip(tower, grids)) + f" [{card_line()}]")
    split = [vl_ttft_split(torch, eng, cfg, pngs["1600x1200"], QWEN_VL_PATH + f" ({k})")
             for k in ("first", "again")]
    mixed = vl_mixed_streams(torch, eng, cfg, pixels, QWEN_VL_PATH)
    return {"tower_ms": tower, "grids": grids, "host": host, "split": split, "mixed": mixed,
            "launches": mixed["launches"]}


def vl_checkpoint_serve(torch, writes: dict) -> dict:
    """D: each 2-layer checkpoint (gemma-3 fp8, Qwen3-VL bf16 and AWQ)
    through ``serve`` behind ``llkt-router`` (``--max-images-per-request
    1``): a streamed image chat, the usage counting the soft tokens, and
    400s for a JPEG, a video_url, a remote URL and two images; a
    pre-quantized text model's int8 weights through the W8A16 kernel;
    Qwen3-VL's experts through the expert kernel of their kind."""
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import JsonTokenizer

    out = {}
    for (repo, q), (proc, t0) in writes.items():
        msg, _ = proc.communicate(timeout=900)
        path = VL_DIRS[repo, q]
        if proc.returncode != 0:
            fail(f"synth_checkpoint {repo} --layers {VL_CKPT_LAYERS} ({q}) exited "
                 f"{proc.returncode}: {msg}")
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        say(f"  wrote {path} ({size / 1e9:.2f} GB with its tokenizer), done "
            f"{time.perf_counter() - t0:.1f} s after its start")
        cfg = vl_config(repo)
        tok = JsonTokenizer(path)
        name = repo.split("/")[1]
        png = encode_png(vl_picture(5, 480, 640))
        tag = VL_CKPT_PATHS[repo, q]

        def drive(base: str, _proc, cfg=cfg, tok=tok, name=name, png=png, tag=tag,
                  q=q) -> dict:
            router_proc, router = start_router(
                ["--models", f"{name}={base}", "--probe-interval", "0.5"],
                f"chip_smoke_vl_router_{name}_{q}.log", [base])
            try:
                http("POST", base + "/debug/kernels/reset")
                usage = vl_chat_checks(router, name, png, tok, cfg, tag, cap=True)
                return {"usage": usage, "launches": kernel_counts(base)["launches"]}
            finally:
                stop_proc(router_proc)

        out[repo, q] = with_server(["--model", path, "--served-model-name", name,
                                    "--max-images-per-request", "1"],
                                   f"chip_smoke_vl_{name}_{q}.log", drive, pool_args=())
        n = out[repo, q]["launches"]
        want = ["flash_prefill"] + ([] if q == "bf16" else ["w8_matmul"])
        never = ["w8_matmul"] if q == "bf16" else []
        if cfg.is_moe:
            want.append("moe_experts" if q == "bf16" else "moe_experts_w8")
            never.append("moe_experts_w8" if q == "bf16" else "moe_experts")
        if not all(n.get(k) for k in want) or any(n.get(k) for k in never):
            fail(f"{tag}: launches {n}: {', '.join(want)} expected, never {never}")
        shutil.rmtree(path, ignore_errors=True)
    return out


def phase_vision(torch, entries: dict, qwen: dict, writes=None) -> dict:
    """Phase 10: A (kernel 1 with mm_groups), B (gemma-3-27b-it at full
    width, its engine behind the port's HTTP server), C (Qwen3-VL-30B-A3B:
    phase 9 B's engine, ``qwen``), D (2-layer checkpoints of both through
    ``serve`` behind llkt-router)."""
    t0 = time.perf_counter()
    writes = writes or start_vl_writes()       # D's checkpoints, started early by main()
    entries["flash_prefill"]["other_shapes"].update(vl_mask_checks(torch, Timer(torch)))
    pngs = {"896x896": encode_png(vl_picture(1, 896, 896)),
            "1600x1200": encode_png(vl_picture(2, 1200, 1600))}
    gemma = vl_gemma(torch, pngs)
    t1 = time.perf_counter()
    ckpt = vl_checkpoint_serve(torch, writes)
    say(f"phase 10 D: {time.perf_counter() - t1:.1f} s")
    say(f"phase 10 (vision): {time.perf_counter() - t0:.1f} s")
    return {"gemma": gemma, "qwen": qwen, "ckpt": ckpt}


def phase_moe(torch, entries: dict, simple, writes=None) -> dict:
    """Phase 9: A (the expert kernels: bf16 in turns with ``simple``, its
    body before the redesign, and int8; kernels 1 and 2 at group 8), B
    (qwen3-30b-a3b in process), C (``serve`` behind llkt-router, /health
    with and without the warm-up, a long prompt's TTFT), D (2-layer bf16,
    fp8 and AWQ checkpoints served), E (Mixtral-8x7B int8 in process), F
    (its ``serve --quantization int8`` behind llkt-router)."""
    from llms_on_kubernetes_tpu_torch.configs import get_config

    t0 = time.perf_counter()
    writes = writes or start_moe_writes()      # D's checkpoints, started early by main()
    entries["moe_experts"] = moe_kernel_checks(torch, Timer(torch), simple)
    entries["moe_experts_w8"] = moe_w8_kernel_checks(torch, Timer(torch))
    flash, decode = moe_attention_checks(torch, np.random.default_rng(9), Timer(torch))
    entries["flash_prefill"]["other_shapes"].update(flash)
    entries["paged_decode"]["other_shapes"].update(decode)
    say(f"phase 9 A: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    inproc = moe_in_process(torch)
    free_card(torch, "phase 9 B done")
    say(f"phase 9 B: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    cfg = get_config(MOE_MODEL)
    served = with_server(["--model", MOE_MODEL, "--random-weights"], "chip_smoke_moe.log",
                         _drive_moe_router(cfg), pool_args=())
    cold = with_server(["--model", MOE_MODEL, "--random-weights", "--no-warmup"],
                       "chip_smoke_moe_nowarmup.log", lambda base, _p: {}, pool_args=())
    say(f"  serve --model {MOE_MODEL} --random-weights (serve's defaults: 2,048 pages, 64 a "
        f"slot, buckets 256/1024/4096): /health after {served['health_s']:.1f} s with the "
        f"warm-up, {cold['health_s']:.1f} s with --no-warmup; phase 9 C "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ckpt = moe_checkpoint(torch, writes)
    say(f"phase 9 D: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mixtral = mixtral_in_process(torch)
    free_card(torch, "phase 9 E done")
    mcfg = get_config(MOE_MIXTRAL)
    mixtral_served = with_server(
        MIXTRAL_SERVE, "chip_smoke_mixtral.log",
        _drive_moe_router(mcfg, MOE_MIXTRAL, MIXTRAL_PATH, "moe_experts_w8"), pool_args=())
    say(f"  serve --model {MOE_MIXTRAL} --random-weights --quantization int8: /health after "
        f"{mixtral_served['health_s']:.1f} s; phase 9 E and F {time.perf_counter() - t1:.1f} s")
    say(f"phase 9 (MoE): {time.perf_counter() - t0:.1f} s")
    return {"inproc": inproc, "served": served, "cold": cold, "ckpt": ckpt,
            "mixtral": mixtral, "mixtral_served": mixtral_served}


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    try:
        from llms_on_kubernetes_tpu_torch import kernels
        from llms_on_kubernetes_tpu_torch.configs import get_config
    except ImportError as e:
        fail(f"run from the root of a checkout: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    if "jax" in sys.modules:
        fail("the port imported jax")
    t_all = time.perf_counter()
    card = card_line()
    say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    router_build = start_router_build()
    kernels.build()
    say(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(kernels.SOURCES)}")
    # the timing variants (scripts/) build while phases 1 and 2 run, apart
    # from the port's own build; each is loaded where it is first timed,
    # and one still building when the run ends is stopped
    variants = {v: start_variant_build(v) for v in (W8_VARIANT, W4_VARIANT, MOE_VARIANT)}
    atexit.register(stop_variant_builds, variants)
    os.makedirs(OUT_DIR, exist_ok=True)
    # every server this run starts (the CLI servers inherit it) captures
    # its profiles, the anomaly detector's too, inside the checkout
    os.environ["LLMK_PROFILE_DIR"] = os.path.abspath(os.path.join(OUT_DIR, "profiles"))
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for name, out in kernels.build_log.items():
            f.write(f"== {name}\n{out}\n")
    for name, out in kernels.build_log.items():
        for func, line in ptxas_report(out):
            say(f"  ptxas {name} {func}: {line}")
    hmma, funcs = sass_mma_count(kernels.library_path("flash_prefill"))
    say(f"sass flash_prefill: {hmma} HMMA instructions in {funcs} tensor-core "
        f"(bf16) functions")
    if not funcs or not hmma:
        fail("the bf16 flash prefill body has no tensor-core (HMMA) instruction")
    for body in ("w4_matmul_decode", "w4_matmul_prefill"):
        hmma, funcs = sass_mma_count(kernels.library_path("w4_matmul"), body, "HGMMA")
        say(f"sass {body}: {hmma} HGMMA instructions in {funcs} tensor-core (bf16) functions")
        if not funcs or not hmma:
            fail(f"the bf16 W4A16 body {body} has no wgmma (HGMMA) instruction")
    hmma, funcs = sass_mma_count(kernels.library_path("moe_experts"), "moe_stream", "HGMMA")
    say(f"sass moe_stream: {hmma} HGMMA instructions in {funcs} tensor-core (bf16) functions")
    if not funcs or not hmma:
        fail("the MoE expert kernel's body moe_stream has no wgmma (HGMMA) instruction")
    hmma, funcs = sass_mma_count(kernels.library_path("moe_experts_w8"), "moe_stream", "HGMMA")
    say(f"sass moe_stream (int8 weights): {hmma} HGMMA instructions in {funcs} tensor-core "
        f"(bf16) functions")
    if not funcs or not hmma:
        fail("the int8 expert kernel's body moe_stream has no wgmma (HGMMA) instruction")
    hmma, funcs = sass_mma_count(kernels.library_path("moe_experts_w8"), "moe_spread", "HGMMA")
    say(f"sass moe_spread (the int8 decode body): {hmma} HGMMA instructions in {funcs} "
        f"tensor-core (bf16) functions")
    if not funcs or not hmma:
        fail("the int8 expert kernel's decode body moe_spread has no wgmma (HGMMA) instruction")
    for lib in ("moe_experts", "moe_experts_w8"):
        moe_faults = ptxas_faults(kernels.build_log.get(lib), "moe_stream")
        if moe_faults:
            fail(f"the MoE expert kernel ({lib}): " + "; ".join(moe_faults))
    for body in ("w8_matmul_decode", "w8_matmul_prefill"):
        hmma, funcs = sass_mma_count(kernels.library_path("w8_matmul"), body)
        say(f"sass {body}: {hmma} HMMA instructions in {funcs} tensor-core (bf16) functions")
        if not funcs or not hmma:
            fail(f"the bf16 W8A16 body {body} has no tensor-core (HMMA) instruction")

    if "--spec-only" in argv:
        phase_spec_gguf(torch)
        fail("--spec-only: phases 2 to 6 skipped, no result")
    if "--awq-only" in argv:
        finish_router_build(router_build)
        os.makedirs(OUT_DIR, exist_ok=True)
        phase_awq_lora(torch, start_awq_write())
        fail("--awq-only: phases 2 to 7 skipped, no result")
    if "--moe-only" in argv:
        finish_router_build(router_build)
        simple_moe = finish_variant_build(variants[MOE_VARIANT])["llmk_moe_experts_simple"]
        phase_moe(torch, {"flash_prefill": {"other_shapes": {}},
                          "paged_decode": {"other_shapes": {}}}, simple_moe)
        fail("--moe-only: phases 2 to 8 skipped, no result")
    if "--vision-only" in argv:
        finish_router_build(router_build)
        os.makedirs(OUT_DIR, exist_ok=True)
        shapes = {"flash_prefill": {"other_shapes": {}}}
        phase_vision(torch, shapes, moe_in_process(torch)["vision"])
        fail("--vision-only: phases 2 to 9 skipped, no result")
    t0 = time.perf_counter()
    entries = phase_kernels(torch)
    for name, shapes in wide_kernels(torch, np.random.default_rng(1), Timer(torch)).items():
        entries[name]["other_shapes"].update(shapes)
    unsplit = finish_variant_build(variants[W8_VARIANT])["llmk_w8_matmul_unsplit"]
    entries.update(w8_kernels(torch, np.random.default_rng(2), Timer(torch), unsplit))
    simple = finish_variant_build(variants[W4_VARIANT])
    entries.update(w4_kernels(torch, np.random.default_rng(3), Timer(torch), simple))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"phase 2 (kernels): {time.perf_counter() - t0:.1f} s")
    if "--profile" in argv:
        phase_profile(torch)
        phase_profile(torch, quantization="int8")
        fail("--profile: profile only, no result")
    if "--kernels-only" in argv:
        say(json.dumps({"kernels": list(entries.values())}))
        fail("--kernels-only: phases 3 to 5 skipped, no result")

    t0 = time.perf_counter()
    phase_reference(torch)
    phase_reference(torch, quantized=True)
    phase_fp8_reference(torch)
    for cfg in wide_debug_configs():
        phase_reference(torch, cfg, page=24)
    num_layers = get_config(MODEL).num_layers
    finish_router_build(router_build)
    served = phase_serve(MODEL, num_layers)
    served_int8 = phase_serve(MODEL, num_layers, kv_cache_dtype="int8")
    contract = phase_contract_servers()
    say(f"phase 3 (reference, serve): {time.perf_counter() - t0:.1f} s")
    phase_watchdog(torch)
    t0 = time.perf_counter()
    fused = phase_in_process(torch, MODEL, echo_logprobs=served["surface"]["echo_logprobs"])
    say(f"phase 4 (fused): {time.perf_counter() - t0:.1f} s")
    ledger = phase_ledger_guided(torch)
    tier = phase_tier_handoff_qos(torch, fused[None]["roomy"])
    ckpt = phase_checkpoint(torch)
    tok_llama3 = phase_tokenizer_llama3()
    headline = phase_headline(torch)
    awq_write = start_awq_write()      # overlaps phase 7
    spec = phase_spec_gguf(torch)
    moe_writes = start_moe_writes()    # overlaps phase 8
    awq = phase_awq_lora(torch, awq_write)
    free_card(torch, "phase 8 done")
    vl_writes = start_vl_writes()      # overlaps phase 9
    simple_moe = finish_variant_build(variants[MOE_VARIANT])["llmk_moe_experts_simple"]
    moe = phase_moe(torch, entries, simple_moe, moe_writes)
    vision = phase_vision(torch, entries, moe["inproc"]["vision"], vl_writes)
    # launches on each path, counted from 0 just before it and read just
    # after; the line's "launches" is the checkpoint server's where the
    # kernel runs there, else phase 4's fused engines, and the W8A16
    # kernel's the headline configuration's (int8 weights, pace 3)
    ckpt_bf16, ckpt_int8 = (f"{CKPT_MODEL} checkpoint serve {kv} KV" for kv in ("bf16", "int8"))
    fused_bf16, fused_int8 = (f"{MODEL} kv_write fused {kv} KV" for kv in ("bf16", "int8"))
    paths = {f"{MODEL} serve bf16 KV": served["launches"],
             f"{MODEL} serve request surface": served["surface"]["launches"],
             f"{MODEL} serve deadline abort": served["contract"]["launches"],
             "debug-tiny resume drill behind llkt-router": contract["drill"]["launches"],
             f"{MODEL} {LLAMA3_TOK_LAYERS} layers llama3 tokenizer serve":
                 tok_llama3["launches"],
             f"{MODEL} serve int8 KV": served_int8["launches"],
             LEDGER_PATH: ledger["launches"],
             fused_bf16: fused[None]["launches"], fused_int8: fused["int8"]["launches"],
             ckpt_bf16: ckpt[None]["launches"], ckpt_int8: ckpt["int8"]["launches"],
             HEADLINE_PATH: headline["launches"], TIER_PATH: tier["tier"]["launches"],
             PREFILL_PATH: tier["disagg"]["prefill_launches"],
             DECODE_PATH: tier["disagg"]["launches"],
             f"{MODEL} {DRILL_LAYERS} layers handoff drills and QoS server":
                 tier["drills"]["launches"],
             SPEC_PATH: spec["A"]["launches"], SPEC_INT8_PATH: spec["A"]["launches_int8"],
             DRAFT_PATH: spec["B"]["self"]["launches"],
             GGUF_DRAFT_PATH: spec["B"]["gguf"]["launches"],
             AWQ_PATH: awq["A"]["served"]["launches"],
             f"{AWQ_MODEL} AWQ in process": awq["A"]["base"]["launches"],
             LORA_PATH: awq["B"]["routed"]["launches"],
             MOE_INPROC_PATH: moe["inproc"]["launches"], MOE_PATH: moe["served"]["launches"],
             **{MOE_CKPT_PATHS[q]: r["launches"] for q, r in moe["ckpt"].items()},
             MIXTRAL_INPROC_PATH: moe["mixtral"]["launches"],
             MIXTRAL_PATH: moe["mixtral_served"]["launches"],
             GEMMA_VL_PATH: vision["gemma"]["launches"],
             GEMMA_VL_HTTP_PATH: vision["gemma"]["served"]["launches"],
             QWEN_VL_PATH: vision["qwen"]["launches"],
             **{VL_CKPT_PATHS[k]: r["launches"] for k, r in vision["ckpt"].items()}}
    for preset, r in spec["C"].items():
        for kind in r:
            paths[f"{preset} GGUF serve {kind} weights"] = r[kind]["launches"]
    main_path = {"flash_prefill": ckpt_bf16, "paged_decode": ckpt_bf16,
                 "paged_write_window": ckpt_bf16, "paged_decode_int8": ckpt_int8,
                 "paged_write_window_int8": ckpt_int8, "paged_decode_write": fused_bf16,
                 "paged_decode_write_int8": fused_int8, "w8_matmul": HEADLINE_PATH,
                 "w4_matmul": AWQ_PATH, "moe_experts": MOE_PATH,
                 "moe_experts_w8": MIXTRAL_PATH}
    for name, e in entries.items():
        e["launches"] = paths[main_path[name]].get(name, 0)
        e["launches_path"] = main_path[name]
        e["launches_by_path"] = {p: c.get(name, 0) for p, c in paths.items() if c.get(name)}
    for e in entries.values():
        if not e["launches"]:
            fail(f"{e['name']} was never launched on its path")
    auto = sorted(os.listdir(os.environ["LLMK_PROFILE_DIR"])) \
        if os.path.isdir(os.environ["LLMK_PROFILE_DIR"]) else []
    say(f"profile captures the servers took (the ledger phase's /debug/profile two, the "
        f"anomaly detector's any others): {auto or 'none'}")
    shutil.rmtree(os.environ["LLMK_PROFILE_DIR"], ignore_errors=True)
    say(f"total: {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": list(entries.values())}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
