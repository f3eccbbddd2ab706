#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--seed N]

Phases (each prints one JSON line; any failure raises and exits nonzero
with no final line). They run in the order 1-3, profiling_train and
profiling_serve (13), 7-9, 4-6d, 10-12, the rest of 13, the two
decode_bench twin phases, 15, 16, 16b/17/17b, 14: the phases whose profiler
traces are counted first, while the process is young (PERF.md section
7).

1. env — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build — compiles every kernel from ``csrc/`` (one nvcc per source, all
   started together), with seconds and each kernel's registers and spilled
   bytes from ptxas; a bf16 flash kernel at head_dim 64 must not spill,
   nor may any of the 48 paged kernel instantiations (head_dim 32, 64 and
   128; 32 is the JAX serving bench's head size).
3. kernel — the paged decode kernels K3 (pages in q's dtype) and K4
   (int8 pages made by the port's ``quantize_kv``, with their f32 scale
   pools) against their plain versions at the GPT-2 124M, Llama-3.2-1B
   and a head_dim-128 decode shape (8 rows, 16-token pages, max_len
   1024), the decode_bench twin's (head_dim 32, max_len 384) and a
   tensor-2 rank's local heads (GPT-2 6 heads, group 1; Llama 16 over 4
   KV heads, group 4: ``TP_SHAPES``), q in
   f32 and bf16 (``TOLERANCES``, ``Q8_TOLERANCES``), with
   the split plan (``chunk_tokens``, ``n_splits``, live CTAs), kernel,
   plain and bound times (CUDA events, median of 25 launches, L2 flushed
   and the device held busy for 2 ms before each: ``time_ms``), after
   the time ``time_ms`` reads for an empty launch (launch_floor); then
   streams — K3 and K4 launched at once on two CUDA streams, each with
   inputs of its own, 25 times: bit-equal to serial launches, every
   workspace counter back at 0 (each stream has its own workspace).
4. serve — GPT-2 124M at full width (random weights from ``--seed``)
   through ``PagedBatchedDecodeEngine``: 16 requests (prompts of 32-512
   tokens, two sharing a 256-token prefix, 64 new tokens each, 12 greedy
   and 4 sampled) on 8 slots, max_len 1024, 16-token pages. Once in f32
   through the kernel and once through the gather path (tokens must agree
   on >= 15 of 16 requests: serve_f32), then once in bf16 (the preset's
   dtype) — the main path of K3, whose launches are counted from zero and
   must equal n_layer x decode ticks (K4's 0), and whose kernel inputs at
   its deepest decode tick are replayed against the plain version for the
   kernels line (with their split plan). The bf16 drive then runs once
   more for the spread of its host-clock metrics (tick ms, tok/s, TTFT:
   serve_spread; twice until slice 14 needed the time); profile —
   ``torch.profiler`` over 10 decode ticks of the bf16 engine (device busy
   share, kernels by device time, host ops by CPU time).
5. int8 serving — the same requests with ``kv_quant="int8",
   weight_quant="int8"``: in f32 through K4 and through the int8 gather
   path (>= 15/16 identical: serve_q8_f32); then in bf16 — the main path
   of K4 (serve_q8, with serve_q8_spread and its kernels-line replay,
   scale pools included): K4 launches == n_layer x decode ticks, K3 0;
   the int8 pool exactly 68/128 of the bf16 pool (serve_q8_pool);
   profile_q8; then q8_quality — the f32 drive's sequences teacher-forced
   through ``decode.forward`` with f32 weights and pool and with int8
   ones: relative logit MSE <= ``Q8_QUALITY`` (argmax agreement printed).
6. serve_llama — Llama-3.2-1B at full width (16 layers, 32 heads over 8
   KV heads, head_dim 64, vocab 128256; weights drawn on the card from
   ``--seed``), 8 slots, max_len 1024, 16-token pages, the same request
   shapes: int8 f32 K4 vs int8 gather (>= 15/16 identical:
   serve_llama_q8_f32), then bf16 through K3 and bf16 int8 through K4,
   each with launches == 16 x decode ticks and the other kernel's 0;
   profile_llama and profile_llama_q8.
6b. the serving tier through its entry points, every number beside the
   card's name and power limit. tier_http — ``serving.serve``'s own
   ``build`` (GPT-2 124M bf16, 2 replicas x 4 slots, max_len 1024, port 0):
   a greedy 64-token SSE stream read with ``http.client`` whose replica
   is killed (/admin/kill) after its first token must end DONE with 64
   tokens; /healthz shows the replica DOWN, /admin/restart brings it back
   HEALTHY, a plain request then runs, and a 48-request burst must meet a
   429 with Retry-After (``--queue-limit 2``); K3 counted from zero over
   the phase, launched from the server's drive thread. tier_storm — ``serving.loadgen``'s
   legs at full width: GPT-2 124M, 4 replicas x 4 slots, max_len 1024,
   ``TIER_REQUESTS`` (24) requests of ``workload.request_stream``
   (prompts 4-341 tokens, 24 new), the twin's kill schedule (ticks 12 and 36, Bernoulli 0.005,
   restart after 40 ticks), rates 0.5 and 2.0 of the calibrated
   capacity, clean and storm, in f32 and bf16: per leg achieved QPS,
   goodput, p50/p99 request seconds, sheds, failovers, restarts,
   ``done_outputs_match_clean``, peak memory, and K3 launches == n_layer
   x (decode ticks over every replica + one warmup per restart), K4 0;
   no lost or duplicated request, every clean request DONE, and in f32
   at most 1 in 16 storm outputs differing from the clean leg, each only
   at or after its failover token (bf16: reported). tier_llama_q8 —
   Llama-3.2-1B with int8 KV pages and weights, 2 replicas, rate 1.0:
   the same gates with K4 in K3's place. failover_paths — where a
   failed-over row's values part from the undisturbed run's: each op of
   GPT-2's block 0 (ln_1, the qkv projection, attention over the same
   paged keys, c_proj, c_fc) on the same rows decode-shaped ([4, 1, E],
   K3) and prefill-shaped ([4, 64, E], the gather path), f32 and bf16:
   largest difference, bit-equality, the first op that differs.
6c. generation outside the paged engine, each phase with K3 and K4
   counted from zero and required to stay at 0 (neither engine below runs
   them), but for the paged spec drives: a speculating paged engine's
   verify forward runs its K+1 queries as kernel rows, one launch a layer
   a decode tick (gated). generate — ``serving.generate``'s functions,
   GPT-2 124M, a 64-token prompt, 64 new tokens: ``decode.generate``,
   ``generate_monolithic`` and ``--stream`` token-equal in f32 (bf16
   reported), ms per token of a warm ``DecodeEngine``, a sampled run
   repeated with its seed equal; MoE GPT-2 (8 experts, top-2) greedy rows
   at B 1 and B 4 equal on >= 7 of 8 in f32. dense — the serve phase's 16
   requests through ``BatchedDecodeEngine`` (8 slots, max_len 1024,
   buckets 64-1024): f32 tokens equal to the paged f32 kernel drive's on
   >= 15 of 16; bf16 tick ms, tok/s, TTFT p50, cache bytes, a profile of
   ten ticks; the dense prefill bit-independent of its neighbours in
   bf16. spec — ``speculative_k=4`` on the dense and paged engines (GPT-2
   f32 and bf16) and on Llama-3.2-1B with int8 pages and weights, over a
   repetitive and a random 16-request stream: spec vs plain equal on >=
   15 of 16 in f32, accept rate, committed tokens per row-tick, ticks,
   tok/s and TTFT against plain; spec_rollback — a published 128-token
   prefix's pages bit-unchanged under speculating borrowers. soak — the
   soak twin at full width (GPT-2 f32, 200 requests), all five invariants.
   serve_dense — ``serve --dense`` (2 GPT-2 bf16 replicas): a stream
   survives /admin/kill of its replica.
6d. multi-tenant LoRA and disaggregated prefill/decode (slice 10).
   lora_kernel — the LoRA delta kernel (``csrc/lora_delta.cu``,
   ``ops/lora_kernel``) against its plain version (the JAX package's
   lowering) at 8 rows x 1 and x 64 tokens in every form the paths hand
   it (``LORA_FORMS``: GPT-2's strided query third and c_proj,
   Llama-3.2-1B's wq and wo, the decode_bench twin's q and c_proj), f32
   and bf16 (``lora_tolerance``), with device times and each call's host
   time.
   lora_float32/lora_bfloat16 — GPT-2 124M on the paged engine (8 slots,
   max_len 1024, 16-token pages, 64-token chunks, K3) with 4 tenants at
   rank 8 from the seed: ``LORA_REQUESTS`` (16) requests striped over the
   tenants and no tenant (prompts 32-512, 64 new, 12 greedy and 4
   sampled); a tenant
   registered after the warmup; gates: every row equal to its tenant
   served alone, untenanted rows equal to the adapter-less engine, some
   tenant row differing from it, compile_count flat, K3 == n_layer x
   decode ticks, the LoRA kernel 2 x n_layer per forward; tok/s against
   the base engine reported. lora_llama_q8 — Llama-3.2-1B with int8 pages
   and weights (K4), 8 requests, the same gates. lora_http — ``serve
   --tenants 2`` (2 GPT-2 bf16 replicas): an SSE request of tenant-1 ends
   DONE, an unregistered tenant is a 400. disagg_float32/disagg_bfloat16
   — a colocated fleet of two GPT-2 124M replicas against a prefill +
   decode fleet on one card, ``workload.disagg_stream`` of 48 requests
   under one Poisson schedule: DONE tokens equal, 48 handoffs, the
   ``kv_handoff`` useful bytes equal to pages x bytes per page, K3 ==
   n_layer x the decode worker's ticks, compile_count flat; export and
   handoff latency p50/p99 and the interactive p99 ratio reported.
   disagg_fault_prefill/disagg_fault_decode — the f32 fleet with the
   prefill worker killed holding parked rows, or the decode worker killed
   mid-decode: every request DONE, outputs equal to the clean leg's (at
   most 1 in 16 only after its failover token). disagg_llama_q8 — the
   int8 Llama pair, 16 requests, K4 on the decode worker. decode_bench_twin
   — ``serving.decode_bench --serving-disagg --serving-scenarios`` at its
   default shapes in a subprocess: exit 0, K3 and the LoRA kernel
   launched in its legs (their counts join the kernels line). It runs
   after phase 13's in-process phases, with the twin's other modes: a
   profiler window opened after another process used the card can lose
   its device rows.
7. flash — the flash forward (K1) and backward (K2) kernels against their
   plain versions at the GPT-2 124M training shape (B=8, H=12, T=1024,
   D=64, causal), a Llama-3.2-1B shape (B=1, H=32, Hkv=8, T=2048, D=64,
   causal) and a head_dim-128 non-causal shape with a ragged T, in f32
   and bf16 (``FLASH_TOLERANCES``; bf16 also against the plain versions
   in f32: ``flash_fwd_bf16_vs_f32``, ``FLASH_BF16_VS_F32``), with kernel,
   plain, bound and ``scaled_dot_product_attention`` (forward; backward)
   times and the names of SDPA's device kernels; then in bf16 at a
   tensor-2 rank's local heads (``TP_FLASH_SHAPES``: GPT-2's 6 heads at
   B 8, T 1024; Llama-3.2-1B's 16 over 4 KV heads at B 1, T 4096), the
   shapes phase 17b's steps give them, and at a seq-2 Ulysses rank's
   (``SEQ_FLASH_SHAPES``: Llama-3.2-1B's 16 over 4 KV heads at the whole
   T 8192; GPT-2's is the tensor-2 shape), the shapes phase 17c's give
   them.
8. train — the training main path: GPT-2 124M at full width, bf16
   activations over f32 params, flash attention, ``names`` remat, bf16
   logits, no dropout, AdamW (lr 3e-4, wd 0.1, cosine), B=8, T=1024, one
   fixed batch from ``--seed``; 3 warmup steps, then 3 timed windows of 10
   steps (tokens/s, ms/step, MFU, loss, grad_norm, peak memory). K1 and K2
   launches are counted from zero over the whole drive and must each
   equal n_layer x steps; the loss must fall. Layer 0's flash inputs at
   the last warmup step are replayed against the plain versions for the
   kernels line.
9. train_profile — ``torch.profiler`` over 2 training steps; then
   train_remat — the same step under remat "none", "full", "dots",
   "dots_no_batch" and "flash" (ms/step, peak memory; K1 launches per
   step n_layer x ``K1_PER_LAYER``, as often as the JAX grad runs its
   flash forward; K2 n_layer).
10. train_parity — one f32 step at full width (B=2, T=1024) through the
   kernels and the same step with naive attention, from the same weights.
11. train_loop — the training entry point's path
   (``train/baseline.py``'s functions, GPT-2 124M with the preset's
   dropout 0.1: A = 4 micro-batches of [8, 1024], 8 steps, a checkpoint
   every 4), a fresh ``Trainer`` resuming step 4 bit for bit, ``evaluate``
   over 4 batches (K1 n_layer x 4, K2 0) and a profile of one step
   (train_loop_profile); train_dropout — keep fractions per site, masks
   distinct across layers, steps and micro-batches, f32 gradients equal
   under all six remat modes; train_fused_ce — ``fused_head_ce`` against
   the unfused step (loss, gradients, ms/step, peak memory, a profile of
   each).
11b. train_guard (slice 12) — the guarded training loop at the main
   path's width (GPT-2 124M, bf16, flash, names, B=8, T=1024, dropout 0):
   one guarded and one unguarded step with the batch on the card under
   ``torch.cuda.set_sync_debug_mode("warn")`` make the same number of
   synchronizing calls; ms/step (the median of four windows of 10 steps
   each, in turns: unguarded, guarded, guarded, unguarded, twice) and
   each side's peak memory; a
   step on a corrupt batch (the bad_batch fault's ids -1 in the first
   eighth of the inputs), and one with targets of V: each leaves params,
   mu, nu and both counts bit-unchanged, counts one anomaly, advances
   ``state.step``, launches K1 and K2 n_layer times, and raises no device
   assert (a clean step runs after them). Then the ``Trainer`` on
   synthetic shards, 4 steps: fault-free with no saves; with a sync save
   every 2 steps and bad_batch faults at steps 3 and 4, whose trip
   (rollback after 2) rolls back to step 2 and replays steps 3-4 with
   losses bit-equal to the fault-free run's and a final state bit-equal
   to it; with async saves every 2 steps, final state bit-equal too. Each run's K1/K2 launches are
   n_layer a step, replayed steps included. Last, a sync and an async
   save of the same state: the async save's blocking time, its finalize
   time, and the in-flight save invisible to ``latest_checkpoint`` until
   finalized.
12. Llama-3.2-1B training at full width (16 layers, E 2048, 32 heads over
   8 KV heads, F 8192, vocab 128256, untied head; weights drawn on the
   card from ``--seed``): train_llama — bench_suite row 6 (B=1, T=4096,
   bf16 activations and params, flash, names, fused head CE, bf16
   logits), 2 warmup and 5 timed steps (ms/step, tok/s, MFU, peak memory,
   K1 == K2 == 16 per step, the loss falls; a one-step profile);
   train_llama_long — row 7 (T=8192, flash remat), 3 timed steps;
   train_llama_loop — the entry point ``--preset llama3-1b`` at its
   defaults for 4 steps (A = 4 x [8, 1024], f32 params, f32 logits
   through the unfused head; the f32 GEMMs' share of device time in its
   profile); train_llama_remat — every remat mode at 4 layers, T=4096
   (K1 4 or 8 per step, K2 4; f32 gradients equal to mode none's; f32
   flash vs naive: train_llama_parity); train_moe — GPT-2 124M with 8
   experts, top-2, B=8, T=1024, and the Llama width at 4 layers with 8
   SwiGLU experts, top-2, B=1, T=4096 (ms/step, peak memory, dropped
   share, two runs of a step bit-equal), and sort vs einsum dispatch on
   the card (train_moe_dispatch). The flash phase adds flash_long: K1/K2
   at the llama shapes T=4096 and T=8192 (bf16, plain versions run by KV
   head).
13. profiling (slice 11), every number beside the card's name and power
    limit; profiling_train and profiling_serve run right after phase 3,
    while the process is young (a scheduled window late in a process that
    has done much work can lose its first launches), the rest after phase
    12. profiling_train — GPT-2 124M at full width (bf16, flash, names,
    B=8, T=1024, seed ``--seed``) through the port's ``Trainer`` for 8
    steps under ``ScheduledProfiler(wait=2, warmup=2, active=4)``
    (``profiling.trace_smoke``'s functions): exactly one trace file;
    ``temporal_breakdown`` compute above 10 % and no communication; K1's
    and each of K2's three device kernels counted by ``op_summary`` as
    often as the wrappers counted over the 4 active steps; the trace's busy
    time within 2 % of the window's kernel time by ``key_averages()``;
    printed: the trace's idle share, the top 10 ops, the window's wall
    clock and ``profile_summary``'s device idle share of the same window.
    profiling_serve — 10 pure decode ticks of the bf16 paged engine (GPT-2
    124M, 8 slots, max_len 1024, 16-token pages) under the profiler, one
    ``step()`` a tick, once with bf16 pages (K3) and once with int8 pages
    and weights (K4): the path's kernel counted in the trace as often as
    its wrapper counted (n_layer x 10), no communication, both idle shares,
    and the share over 10 ticks run just before without the profiler.
    memory — the ``memory_analysis`` twin's functions on the
    profiling_train configuration, allocator history on from before the
    model is built, 3 steps: the analytic breakdown, the measured peak and
    their ratio; the peak between params + grads + optimizer bytes and the
    card's memory; the snapshot pickle holds a segment. throughput —
    ``measure_tokens_per_second`` (5 warmup, 20 timed steps) and
    ``extrapolate_modern_training`` at that configuration, then
    ``compare_batch_sizes`` over (1, 8, X, 8), X the least power of two
    whose analytic breakdown exceeds the card's memory: X's row an OOM,
    the 8 after it within 20 % of the first 8's tokens/s. profiler_cost —
    the training step's device busy time over its profiled window's wall
    and over the throughput phase's unprofiled step, and the same for the
    decode ticks: the profiler's host cost inflates a profiled idle share.
    decode_bench_twin_2 — ``serving.decode_bench``'s other modes in six
    subprocesses at their default shapes: ``--serving-spec`` alone (it
    gates a speedup), here; the default (gpt2 and llama3-1b; 2 timed
    repeats, not 3), ``--speculative 4`` (64 new tokens, not 512),
    ``--serving-batched --chaos`` and ``--serving --serving-batched
    --serving-paged --kv-quant int8 --weight-quant int8`` (one process;
    these two with ``--rank-legs skip``) and ``--serving --serving-spec
    --rank-legs only`` (the two multi-rank sub-legs, each on two gloo
    ranks sharing cuda:0: serving_spec_tp's outputs equal and no steady
    loads, asserted by the twin; zero3_decode's row), which gate nothing
    on time, beside phases 15-17c: each exits 0 (its asserted checks
    held), K3 launched on ``--serving-spec``, on serving_spec_tp and K4 on
    the quant leg.
The decode_bench twin and ``--serving-spec``, which gate times, run
    alone. Then 16-17c run side by side with the storm (15,
    ``storm_in_background``: it gates no time, and its workers are mostly
    torch start-up) and the five untimed decode_bench runs above
    (``late_phases``: none of them gates a time), while this script runs
    the one-rank references of 17, 17b and 17c (a ``side_by_side`` line: the
    block's wall and its children). Every time 15-17c report is
    contended: taken with the others on the same card and host.
15. train_storm (slice 12) — the supervisor twin, ``python -m
    pytorch_distributed_tpu_torch.train.supervisor --dryrun --steps 10``,
    on the card at its default small config (10 steps, the smoke's hotter
    fault rates; its workers are processes of their own): completed,
    final state bit-equal to its
    fault-free leg, every fault kind fired, every crash (exit 43)
    followed by a restart; spawned, restarts, exit codes and wall seconds
    printed.
16. data parallel (slice 13), each rank a subprocess of this script
    (``--ddp-worker``; ddp_gloo2's two ranks are the ``--gloo-worker``
    ranks of 17b, which run its legs first): GPT-2 124M at full width (bf16,
    flash, names), the
    global batch 8 x 1024 split over the ranks, 3 steps a leg through the
    ``DistributedTrainer``'s loop. ddp_nccl — world 1 on NCCL, the four
    strategies: losses and params bit-equal to the single-device
    ``Trainer`` on the same batches, K1/K2 launched as often, collectives
    issued; a Kineto window of two DDP steps: every ``nccl*`` kernel in it
    classed communication (NCCL launches none for a one-rank collective:
    it copies or skips it) and its c10d rows as many as the step's
    collectives. ddp_gloo2 — two ranks on cuda:0 over gloo (NCCL refuses
    two ranks on one card), no_shard over data 2 and full_shard over fsdp
    2: both ranks' losses equal and within ``DDP_GLOO2_LOSS_ATOL`` of
    ddp_nccl's one-rank losses, K1 = K2 = 12 a step on each rank,
    full_shard's resident params and moments (allocator bytes) at most
    ``DDP_RESIDENT_RATIO`` of no_shard's; ms a step and peak bytes
    printed (gloo stages collectives through the host: no NCCL claim).
17. tp_serve (slice 14), each rank a subprocess of this script
    (``--gloo-worker tp_serve``): two gloo ranks sharing cuda:0,
    ``MeshConfig(tensor=2)``, seed 0, against the one-rank paged engine
    on the same weights (run by this script while the ranks run).
    GPT-2 124M (8 slots, max_len 1024, 16-token pages, the 16 requests of
    4): f32 tokens equal in >= 15 of 16 rows and the first decode tick's
    logits within 1e-4; bf16's first-tick relative logit MSE <= 2e-3;
    Llama-3.2-1B widths at 4 layers with int8 pages and weights (K4 at
    Hkv 4, G 4): its MSE against the one-rank int8 engine's <= 2e-3;
    GPT-2 f32 with 4 LoRA tenants at rank 8 (8 requests): every tenanted
    row equal to its tenant served alone on the TP engine, 2 x n_layer
    LoRA launches a forward; the ZeRO-3 serial engine (``MeshConfig(fsdp=
    2)``, 8 new tokens) token-equal to the plain one. In every leg both
    ranks' tokens are identical, the decode tick's kernel (K3; K4 on int8
    pages) launches n_layer times a tick on each rank and the other 0,
    every decode tick issues 2 x n_layer all-reduces (int8 and adapters
    alike), and each rank's pool is half the one-rank pool. Tick ms, the
    all-reduce host time and wall are reported, not gated (gloo stages
    every all-reduce through the host: no NCCL claim). The kernel phase
    (3) also holds K3/K4 at a rank's local heads (``TP_SHAPES``).
17b. tp_train (slice 15), the ``--gloo-worker`` ranks' last part
    (after ddp_gloo2's; a second pair of gloo ranks on cuda:0): training
    through the ``DistributedTrainer`` at ``MeshConfig(tensor=2)`` — GPT-2
    124M at
    full width (bf16, flash, names, dropout 0) on ddp_nccl's 3 batches,
    and Llama-3.2-1B widths at 4 layers, B 1, T 4096, 2 steps. Gates: both
    ranks' losses identical, within ``DDP_GLOO2_LOSS_ATOL`` of one rank
    on the same batches (ddp_nccl's ``Trainer``; the Llama leg's one-rank
    ``Trainer`` run by this script meanwhile), K1 and K2 launched on every
    rank, and the GPT-2 state saved at tensor 2 (the sharded format)
    restored at tensor 1 bit for bit. Reported: K1/K2 launches,
    all-reduces and other collectives a step, ms a step, resident and
    peak bytes against one rank's. The flash phase (7) also holds K1/K2 at
    a rank's local heads (``TP_FLASH_SHAPES``).
17c. seq_train (slice 16), the 17b ranks' third part: sequence
    parallelism through the ``DistributedTrainer`` at ``MeshConfig(seq=
    2)`` (each rank half of every sequence), ring and Ulysses, 2 steps a
    leg — GPT-2 124M at full width (bf16, flash, names, dropout 0) on
    ddp_nccl's first 2 batches, Llama-3.2-1B widths at 4 layers with the
    ring at T 4096 (17b's batches) and Ulysses at T 8192 (the exchanges
    stage each block through the host: gloo on CUDA tensors). Gates: both
    ranks' losses identical and within ``DDP_GLOO2_LOSS_ATOL`` of one rank
    on the same batches (ddp_nccl's ``Trainer``, 17b's one-rank Llama run,
    and a one-rank Llama run at T 8192 by this script meanwhile); K1 and K2
    launches a step on each rank, ring exchanges and all-to-alls a step
    equal to the counts ``seq_counts`` derives (Ulysses: K1 = K2 = n_layer,
    12 n_layer all-to-alls; the ring: 3 n_layer exchanges, no kernel); the
    GPT-2 ring state saved at seq 2 restored at seq 1 bit for bit. ms a
    step reported (contended).
14. The kernels line (K3, K4, K1, K2 and the LoRA delta kernel; K1/K2
    with ``slice13_paths``, their launches in the data-parallel legs, and
    ``slice12_paths``, their launches in train_guard's steps and runs;
    with their launches per step and times on the llama paths, K3/K4 with
    their launches on each tier leg, ``tier_paths``, on the phases of 6c,
    ``slice9_paths``, of 6d, ``slice10_paths``, and of the decode_bench
    twin's other modes, ``slice11_paths``; K1-K4 with ``trace_launches``,
    the launches profiling_train/profiling_serve's trace recorded, beside
    ``trace_window_counted``, the wrapper's count over the same window;
    K3/K4 and the LoRA kernel with ``tp_paths``, their launches on each
    tp_serve leg, and K3/K4 with ``tp_local_shapes``, their times at a
    rank's local heads; K1/K2 with ``tp_train_paths``, their launches on
    each tp_train leg, and ``tp_local_shapes``, and with ``seq_paths``,
    their launches on each seq_train leg, and ``seq_local_shapes``), after
    a ``walls`` line
    (every phase's wall and end, in seconds), then ``{"ok": true,
    "device": {...}}`` last.

Processes. Every child (nvcc, the twins, the supervisor and its workers,
the ranks) starts through the port's launcher (``parallel/mesh``: a
session of its own, its whole group SIGKILLed on a timeout, an error or a
failed rank, and registered). SIGTERM and SIGINT kill every registered
group and end the script nonzero (``install_exit_handlers``), as
``atexit`` does at any other end; the ranks and the twins bind
themselves to their parent (``bind_to_parent``: the kernel SIGKILLs them
when it dies, even by SIGKILL) and join their group with a 120 s timeout.
Every subprocess phase's timeout is cut to the time left before
``DEADLINE_S`` (1150 s from the start), and after each of them and
before the kernels line the script lists its living descendants
(``/proc/<pid>/task/*/children``) and fails if there are any.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# Kernel vs plain version: f32 differs only in summation order. In bf16
# the plain version rounds its softmax weights to bf16 (as the JAX
# reference does) and the kernel keeps them in f32, so the two are held
# to about 3x the largest difference seen at the main path's inputs
# (9.8e-4 on an H100, one bf16 ulp of its largest outputs); and the
# kernel is also held to the plain version run in f32 on the same values
# (bf16 -> f32 is exact), where the only difference left is the kernel's
# one rounding of its output to bf16: at most 2^-8 of the value.
TOLERANCES = {
    torch.float32: dict(atol=1e-5, rtol=0.0),
    torch.bfloat16: dict(atol=3e-3, rtol=1e-2),
}
BF16_VS_F32 = dict(atol=1e-5, rtol=2.0**-8)
# K4 (int8 pages) vs its plain version. f32: the kernel scales q.k_int by
# the token's scale where the plain version dequantizes each element
# first, so only rounding order differs. In bf16 the plain version
# rounds every dequantized K and V element to bf16 (as the JAX reference
# does) and its softmax weights, while K4 keeps all of it in f32: the
# largest differences measured on an H100 are 9.8e-4 at the main path's
# inputs and 7.8e-3 (one bf16 ulp in [1, 2), at outputs below 0.5) at
# the kernel phase's unit-variance pages, so K4 is held to about 3x the
# latter. It is also held tightly to the plain version with q in f32 on
# the same int8 pages and scales (``BF16_VS_F32``), where dequantization
# is exact on both sides and what is left is K4's one bf16 rounding of
# its output.
Q8_TOLERANCES = {
    torch.float32: dict(atol=1e-5, rtol=0.0),
    torch.bfloat16: dict(atol=2.4e-2, rtol=1e-2),
}
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
BF16_UNIT_ROUNDOFF = 2.0**-8  # round-to-nearest into 8 significant bits
# Flash kernels vs their plain versions. f32 differs in summation order
# only (gradients sum over up to T keys or queries, hence their larger
# atol). In bf16 the kernels and the plain versions round the softmax
# weights and dS to bf16 before their products, as the TPU kernels do:
# what is left is f32 summation order and exp2's last bits, and the bf16
# roundings of p, dS or an output that these flip. Measured on an H100
# over the flash phase's shapes and 128 ragged ones (T 1-1000, groups
# 1-8, D 64/128, causal or not): at most one output ulp, 7.8e-3 for o
# (in [1, 2)) and 3.1e-2 for a gradient (in [4, 8)). rtol 1e-2 is above
# one ulp's share of any value (2^-7); atol covers values near zero.
FLASH_TOLERANCES = {
    torch.float32: dict(fwd=dict(atol=1e-5, rtol=1e-5),
                        bwd=dict(atol=1e-4, rtol=1e-5)),
    torch.bfloat16: dict(fwd=dict(atol=5e-3, rtol=1e-2),
                         bwd=dict(atol=1e-2, rtol=1e-2)),
}
# bf16 kernels vs the plain versions run in f32 on the same values (bf16 ->
# f32 is exact). The forward's bound is derived (flash_fwd_bf16_vs_f32).
# The backward's is 3x the largest difference measured on an H100 over the
# same inputs: 3.66e-2 (dv at B 1, H 8, Hkv 1, T 65, D 128, causal, where
# |dv| reaches 11.8; dk 1.98e-2, dq 1.29e-2).
FLASH_BF16_VS_F32 = dict(bwd=dict(atol=0.11, rtol=0.0))
LSE_TOL = dict(atol=1e-5, rtol=1e-5)


def flash_fwd_bf16_vs_f32(v: torch.Tensor) -> dict:
    """Tolerance of a bf16 forward that rounds each softmax weight p to
    bf16 before P V (K1 and the bf16 plain version) against the f32 plain
    version on the same values: |o - o32| <= u (1 + u) max|v| + u |o32|
    + 1e-5, u = 2^-8. Each rounded p is p (1 + d), |d| <= u; the weights
    p / l sum to 1 (l is summed from the unrounded p), so P V / l moves by
    at most u max|v|; rounding o once adds u |o| <= u (|o32| + u max|v|);
    1e-5 covers f32 summation order and exp2's last bits."""
    u = BF16_UNIT_ROUNDOFF
    return dict(atol=u * (1 + u) * float(v.abs().max()) + 1e-5, rtol=u)


T0 = time.perf_counter()
# The script's own deadline, under the 1200 s a run is given: every
# subprocess phase's timeout is cut to the time left before it, so an
# overrun ends the script with its children killed and an error line,
# never cut off from outside with children alive.
DEADLINE_S = 1150.0
_EMITTED: list = []  # (phase, mode, t_s) of every line, for the walls


def emit(**fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    t_s = round(time.perf_counter() - T0, 1)
    _EMITTED.append((fields.get("phase"), fields.get("mode"), t_s))
    print(json.dumps(dict(fields, t_s=t_s)), flush=True)


def phase_timeout(own_s: float, what: str) -> float:
    """A subprocess phase's timeout: its own, or the time left before
    ``DEADLINE_S`` if less; past the deadline the phase does not start."""
    left = T0 + DEADLINE_S - time.perf_counter()
    if left < 1.0:
        raise AssertionError(f"{what}: the script's {DEADLINE_S:.0f} s "
                             "deadline has passed")
    return min(own_s, left)


def check_survivors(where: str) -> None:
    """Raise if any process this script started (at any depth) is still
    alive, but for the children it still runs on purpose (the launcher's
    register: the background storm) and their descendants: their pids
    and command lines."""
    mesh = pmesh()
    running = set(mesh.registered())  # leaders, and their descendants
    for leader in list(running):
        running.update(pid for pid, _ in mesh.live_descendants(leader))
    left = [(pid, cmd) for pid, cmd in mesh.live_descendants()
            if pid not in running]
    if left:
        raise AssertionError(f"{where}: processes of this script still "
                             f"alive: {left}")


def phase_walls() -> list:
    """Each emitted line's phase (and mode) with the seconds since the
    line before it and its end in seconds since the start."""
    out, prev = [], 0.0
    for phase, mode, t_s in _EMITTED:
        out.append(dict(phase=phase if mode is None else f"{phase}/{mode}",
                        wall_s=round(t_s - prev, 1), end_s=t_s))
        prev = t_s
    return out


def spin_cycles(ms: float) -> int:
    """Clock cycles that ``torch.cuda._sleep`` spins for ``ms`` on this
    card, measured once with CUDA events."""
    if not hasattr(spin_cycles, "per_ms"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        spin_cycles.per_ms = 10_000_000 / start.elapsed_time(end)
    return int(spin_cycles.per_ms * ms)


def time_ms(fn, flush: torch.Tensor, n: int = 25) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events).
    Zeroing ``flush`` before each launch evicts the 50 MB L2, as the
    serving loop finds the pools cold. Then the device spins for 2 ms
    (``torch.cuda._sleep``) while the host enqueues the start event and
    the call, so the host's time (autograd's dispatch, a wrapper's
    allocations) stays outside the events and only device time is
    measured: the zeroing alone (~0.1 ms on the device) hid less than
    some calls take to enqueue."""
    fn()
    torch.cuda.synchronize()
    cycles = spin_cycles(2.0)
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paged_bound(q, k_pages, tables, lengths) -> tuple[float, str]:
    """Least time for paged decode attention on these inputs: the keys
    0..lengths[b] of each (row, KV head) read once for K and V (D x
    itemsize bytes each; for int8 pages D bytes plus the token's 4-byte
    scale), q read and o written once, the table entries of those keys'
    pages and the lengths read once, over the HBM rate; or its
    multiply-adds (q.k and p.v, f32 on the CUDA cores) over the f32 rate
    — whichever is larger."""
    b, h, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    n_pages = tables.shape[1]
    lens = np.minimum(lengths.cpu().numpy().astype(np.int64),
                      n_pages * page - 1)
    tokens = int((lens + 1).sum())
    item = q.element_size()
    row_bytes = d * k_pages.element_size()
    if k_pages.dtype == torch.int8:
        row_bytes += 4  # the f32 scale
    nbytes = (
        tokens * hkv * row_bytes * 2 + 2 * q.numel() * item
        + int((lens // page + 1).sum()) * 4 + b * 4
    )
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * h * d * tokens / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def ptxas_summary(log: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each kernel in an
    ``nvcc -Xptxas -v`` log, keyed by the kernel's name and template
    arguments as they appear in its mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"\d+((?:flash|paged|lora)_\w+?)I", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
            if "nv_bfloat16" in mangled:
                name += "[bf16]"
            types = re.search(r"paged_\w+?I(\w*?)Li", mangled)
            if types and types.group(1).endswith("a"):  # KV = int8_t (K4)
                name += "[int8]"
            out[name] = dict(registers=None, spill_bytes=0)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name:
            out[name]["spill_bytes"] = int(spill[1]) + int(spill[2])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out[name]["registers"] = int(regs[1])
    return out


def check_close(got, want, atol, rtol, what) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > limit).any()):
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version, max |diff| "
            f"{float(err.max())} (atol {atol}, rtol {rtol})"
        )
    return float(err.max())


def check_kernel(pk, args, what) -> dict:
    """One launch of the kernel (K3, or K4 when ``args`` carry the scale
    pools) on ``args`` against its plain version on the same inputs
    (``TOLERANCES``, ``Q8_TOLERANCES``), and for bf16 also against the
    plain version in f32 on the same values (``BF16_VS_F32``: bf16 -> f32
    is exact; int8 pages and f32 scales stay as they are). Returns the
    largest differences and the tolerances used."""
    out = pk.paged_decode_attention(*args)
    torch.cuda.synchronize()
    tol = (Q8_TOLERANCES if len(args) > 5 else TOLERANCES)[args[0].dtype]
    err = check_close(out, pk.paged_decode_attention_reference(*args),
                      what=what, **tol)
    res = dict(max_abs_err=err, **tol)
    if args[0].dtype == torch.bfloat16:
        exact = pk.paged_decode_attention_reference(
            *(t.float() if t.dtype == torch.bfloat16 else t for t in args)
        )
        res["max_abs_err_vs_f32_plain"] = check_close(
            out, exact, what=f"{what} vs f32 plain", **BF16_VS_F32
        )
    return res


def split_plan(pk, args) -> dict:
    """The kernel's partition of rows at these inputs: keys per CTA
    (``chunk_tokens``) and CTAs per (row, KV head) (``n_splits``), and
    how many of those CTAs these rows' lengths make active."""
    q, k_pages, tables, lengths = args[0], args[1], args[3], args[4]
    page, n_pages = k_pages.shape[1], tables.shape[1]
    chunk, n_splits = pk._split_plan(page, n_pages, q.shape[2],
                                     k_pages.dtype)
    n_tok = np.minimum(lengths.cpu().numpy().astype(np.int64) + 1,
                       n_pages * page)
    active = int(np.maximum(1, -(-n_tok // chunk)).sum()) * k_pages.shape[2]
    return dict(chunk_tokens=chunk, n_splits=n_splits, active_ctas=active)


def paged_case(dev, seed, b, h, hkv, d, dtype, q8, page=16, n_pages=64):
    """Kernel inputs at a decode shape: rows at lengths 0, page-1, page,
    max_len-1 and random, each over distinct pool pages up to its depth
    (the rest of its table on the scratch page 0); pages from ``randn`` in
    ``dtype``, or for K4 (``q8``) quantized by the port's ``quantize_kv``
    (int8 pages + f32 scale pools). Returns the wrapper's arguments."""
    from pytorch_distributed_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device=dev).manual_seed(seed)
    n_pool = b * n_pages + 1
    k = torch.randn(n_pool, page, hkv, d, generator=g, device=dev)
    v = torch.randn(n_pool, page, hkv, d, generator=g, device=dev)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    lengths = torch.randint(0, n_pages * page, (b,), generator=g,
                            device=dev, dtype=torch.int32)
    lengths[:4] = torch.tensor([0, page - 1, page, n_pages * page - 1])
    ids = (torch.randperm(n_pool - 1, generator=g, device=dev) + 1)
    ids = ids[: b * n_pages].reshape(b, n_pages)
    used = (torch.arange(n_pages, device=dev)[None] * page
            <= lengths[:, None])
    tables = torch.where(used, ids, 0).to(torch.int32).contiguous()
    if not q8:
        return (q, k.to(dtype), v.to(dtype), tables, lengths)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return (q, kq, vq, tables, lengths, ks, vs)


# The decode shapes each rank of a tensor-parallel engine gives K3/K4
# (tp_serve: tensor 2): its local heads, the group unchanged.
TP_SHAPES = ("gpt2-124M-tp2", "llama3.2-1B-tp2")


def kernel_phase(pk, dev, flush, seed) -> dict:
    """K3 and K4 against their plain versions at the decode shapes of the
    paths (GPT-2, Llama-3.2-1B, head_dim 128, the decode_bench twin's
    head_dim 32, and a rank's local heads under tensor 2: ``TP_SHAPES``),
    q in f32 and bf16, with kernel, plain and bound times. Returns the
    ``TP_SHAPES`` rows by kernel, shape and dtype."""
    shapes = [  # (name, B, H, Hkv, D, pages per row of 16 tokens)
        ("gpt2-124M", 8, 12, 12, 64, 64),
        ("llama3.2-1B", 8, 32, 8, 64, 64),
        ("head_dim-128", 8, 32, 8, 128, 64),
        # decode_bench twin's serving model (n_embd 256, 8 heads), max_len
        # 384
        ("decode_bench-twin", 8, 8, 8, 32, 24),
        # tensor 2: GPT-2's 6 heads a rank (group 1), Llama's 16 over 4
        # KV heads (group 4)
        ("gpt2-124M-tp2", 8, 6, 6, 64, 64),
        ("llama3.2-1B-tp2", 8, 16, 4, 64, 64),
    ]
    tp_rows: dict = {}
    page = 16
    # What time_ms reads for a launch that does no work: the floor under
    # every kernel time here.
    emit(phase="launch_floor", empty_launch_ms=time_ms(
        lambda: torch.cuda._sleep(1), flush))
    for kernel, q8 in (("paged_decode_attention", False),
                       ("paged_decode_attention_q8", True)):
        for name, b, h, hkv, d, n_pages in shapes:
            for dtype in TOLERANCES:
                args = paged_case(dev, seed, b, h, hkv, d, dtype, q8, page,
                                  n_pages)
                checked = check_kernel(pk, args, f"{kernel} {name} {dtype}")
                bound_ms, bound_by = paged_bound(args[0], args[1], args[3],
                                                 args[4])
                timed = dict(
                    kernel_ms=time_ms(
                        lambda: pk.paged_decode_attention(*args), flush),
                    plain_ms=time_ms(
                        lambda: pk.paged_decode_attention_reference(*args),
                        flush),
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
                dt = str(dtype).replace("torch.", "")
                emit(
                    phase="kernel", kernel=kernel, shape=name,
                    B=b, H=h, Hkv=hkv, D=d, page=page,
                    max_len=n_pages * page, **split_plan(pk, args),
                    dtype=dt, pages=str(args[1].dtype).replace("torch.", ""),
                    lengths=args[4].tolist(), **checked, **timed,
                )
                if name in TP_SHAPES:
                    tp_rows.setdefault(kernel, {}).setdefault(
                        name, dict(H=h, Hkv=hkv, D=d))[dt] = dict(
                            timed, max_abs_err=checked["max_abs_err"])
    return tp_rows


def streams_phase(pk, dev, seed, rounds: int = 25) -> None:
    """K3 and K4 launched concurrently on two non-default streams, each
    with inputs of its own (the GPT-2 decode shape, bf16 pages and int8
    pages), ``rounds`` times: every output bit-equal to a serial launch on
    one stream, and every workspace counter back at 0. Both streams wait
    on an event recorded after a 20 ms spin on a third stream, so all
    their launches are queued before the first runs."""
    inputs = [[paged_case(dev, seed + s, 8, 12, 12, 64, torch.bfloat16, q8)
               for q8 in (False, True)] for s in (1, 2)]
    want = [[pk.paged_decode_attention(*a) for a in pair] for pair in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    gate, spinner = torch.cuda.Event(), torch.cuda.Stream(dev)
    with torch.cuda.stream(spinner):
        torch.cuda._sleep(spin_cycles(20.0))
        gate.record(spinner)
    got = []
    for stream, pair in zip(streams, inputs):
        stream.wait_event(gate)
        with torch.cuda.stream(stream):
            got.append([[pk.paged_decode_attention(*a) for a in pair]
                        for _ in range(rounds)])
    torch.cuda.synchronize()
    mismatched = sum(not torch.equal(out, ref)
                     for per_stream, refs in zip(got, want)
                     for outs in per_stream for out, ref in zip(outs, refs))
    counters = [c for _, c in pk._workspaces.values()]
    nonzero = sum(int(c.count_nonzero()) for c in counters)
    emit(phase="streams", streams=len(streams), rounds=rounds,
         launches=2 * len(streams) * rounds, mismatched=mismatched,
         workspaces=len(counters), nonzero_counters=nonzero)
    if mismatched or nonzero:
        raise AssertionError(
            f"K3/K4 on two streams: {mismatched} outputs differ from serial "
            f"launches, {nonzero} workspace counters not back at 0")


def requests(cfg, seed) -> list[dict]:
    """16 requests: prompts of 32-512 tokens, 64 new tokens each, every
    fourth one sampled. Requests 0 and 8 share a 256-token prefix; 8
    admits only after a first row retires, when 0's prefix is cached."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 256)
    lens = rng.integers(32, 513, 16)
    out = []
    for i in range(16):
        if i in (0, 8):
            prompt = np.concatenate(
                [shared, rng.integers(0, cfg.vocab_size, 40 + 3 * i)]
            )
        else:
            prompt = rng.integers(0, cfg.vocab_size, int(lens[i]))
        req = dict(prompt=prompt.astype(np.int32), max_new_tokens=64)
        if i % 4 == 3:
            req.update(temperature=0.8, top_k=50, top_p=0.95,
                       seed=seed * 1000 + i)
        out.append(req)
    return out


def serve(cfg, params, reqs, paged_attention, pk, record=None,
          **quant) -> dict:
    """One drive of ``reqs`` through a fresh engine (8 slots, max_len
    1024, 16-token pages; ``quant``: its ``kv_quant``/``weight_quant``).
    K3 and K4 launches count from zero for exactly this drive: the path's
    kernel (K4 for an int8 pool) must have launched n_layer x decode
    ticks times and the other kernel never (neither, on the gather
    path)."""
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024, page_size=16,
                                   paged_attention=paged_attention, **quant)
    eng.warmup(params)
    original = pk.paged_decode_attention
    if record is not None:
        pk.paged_decode_attention = record
    pk.launches = pk.launches_q8 = 0  # count from zero for this drive
    try:
        run = drive_engine(eng, params, reqs)
    finally:
        pk.paged_decode_attention = original
    counts = {"K3": pk.launches, "K4": pk.launches_q8}
    m = run["metrics"]
    if m["generated_tokens"] != 64 * len(reqs):
        raise AssertionError(f"generated {m['generated_tokens']} tokens, "
                             f"want {64 * len(reqs)}")
    ticks = eng.counters["decode_ticks"]
    kernel = "K4" if eng.kv_quant == "int8" else "K3"
    want = {"K3": 0, "K4": 0}
    if paged_attention == "kernel":
        want[kernel] = cfg.n_layer * ticks
    if counts != want:
        raise AssertionError(
            f"{paged_attention} path launches {counts} != {want} (n_layer "
            f"{cfg.n_layer} x decode ticks {ticks} on the path's kernel): "
            f"the decode path did not go through its kernel"
        )
    return dict(
        tokens=dict(enumerate(run["tokens"])),
        launches=counts[kernel],
        metrics=dict(
            model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}",
            dtype=cfg.dtype, paged_attention=paged_attention,
            kv_quant=eng.kv_quant, weight_quant=eng.weight_quant,
            requests=len(reqs), kernel_launches=counts,
            **{k: m[k] for k in (
                "generated_tokens", "decode_ticks", "prefill_ticks",
                "mean_decode_tick_ms", "pure_decode_ticks",
                "generated_tok_per_s", "wall_s", "ttft_p50_ms")},
            prefix_hits=eng.pool.stats["prefix_hits"],
            prefix_hit_tokens=eng.pool.stats["prefix_hit_tokens"],
            preemptions=eng.counters["preemptions"],
            pool_bytes=eng.cache_hbm_bytes()["allocated"],
            pool_peak_in_use_bytes=eng.cache_hbm_bytes()["peak_in_use"],
        ),
        engine=eng,
    )


def device_us(e) -> float:
    """Self device time (us) of a ``key_averages()`` row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_rows(events) -> list:
    """The ``key_averages()`` rows of device work (kernels, copies,
    memsets) with device time: not the annotations a schedule or
    ``record_function`` projects onto the device's timeline
    (``ProfilerStep#n``, ``train_step#n``), which span the work."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("ProfilerStep#", "train_step#"))]


def profile_summary(prof, wall_ms: float,
                    share_of: str | None = None) -> dict:
    """Device busy share of the window, the kernels by device time and the
    host ops by self CPU time, from a finished ``torch.profiler`` run;
    with ``share_of``, the share of the device time spent in kernels whose
    name matches that regex, and their names."""
    events = prof.key_averages()

    # Device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched.
    kernels = sorted(device_rows(events), key=device_us, reverse=True)
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    matched = {}
    if share_of:
        matched = [e for e in kernels if re.search(share_of, e.key)]
        matched = dict(
            matched_regex=share_of,
            matched_device_ms=sum(device_us(e) for e in matched) / 1e3,
            matched_share=(sum(device_us(e) for e in matched) / 1e3
                           / device_ms) if device_ms else None,
            matched_kernels=sorted({e.key[:100] for e in matched}))
    return dict(**matched,
        wall_ms=wall_ms, device_busy_ms=device_ms,
        device_idle_share=(1 - device_ms / wall_ms) if device_ms else None,
        kernels=[dict(name=e.key[:80], calls=e.count,
                      device_ms=device_us(e) / 1e3) for e in kernels[:12]],
        host_ops=[dict(name=e.key[:60], calls=e.count,
                       self_cpu_ms=e.self_cpu_time_total / 1e3)
                  for e in host[:12]],
    )


def profile_phase(cfg, params, reqs, n_ticks: int = 10, phase="profile",
                  engine=None, **quant) -> None:
    """``torch.profiler`` over ``n_ticks`` pure decode ticks of the bf16
    paged engine (``quant``: its ``kv_quant``/``weight_quant``), or of
    ``engine`` (warmed), with all 8 slots decoding."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = engine
    if eng is None:
        eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024,
                                       page_size=16, **quant)
        eng.warmup(params)
    for r in reqs[:8]:
        eng.submit(**r)
    while True:  # until every row has finished its prefill
        before = eng.counters["prefill_ticks"]
        eng.step(params)
        if eng.counters["prefill_ticks"] == before:
            break
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit(phase=phase, decode_ticks=n_ticks, **quant,
         **profile_summary(prof, wall_ms))


PAGED_SOURCE = "pytorch_distributed_tpu_torch/csrc/paged_attention.cu"
Q8 = dict(kv_quant="int8", weight_quant="int8")


def kernel_vs_gather(phase, cfg, params, reqs, pk, **quant) -> dict:
    """The same f32 drive through the kernel and through the gather path:
    tokens identical on >= 15 of the 16 requests. Returns the kernel
    drive's tokens by request id."""
    runs = {impl: serve(cfg, params, reqs, impl, pk, **quant)
            for impl in ("kernel", "gather")}
    a, b = runs["kernel"]["tokens"], runs["gather"]["tokens"]
    same = sum(np.array_equal(a[r], b[r]) for r in a)
    emit(phase=phase, identical_requests=same, of=len(reqs),
         kernel=runs["kernel"]["metrics"], gather=runs["gather"]["metrics"])
    if same < 15:
        raise AssertionError(
            f"{phase}: f32 kernel and gather paths agree on only "
            f"{same}/{len(reqs)} requests"
        )
    return a


def main_path(phase, cfg, params, reqs, pk, flush, spread_runs=1,
              **quant) -> dict:
    """A serving main path: the drive whose kernel launches count
    (``serve``: from zero, exactly n_layer x decode ticks), ``spread_runs``
    more drives for the spread of its host-clock metrics, and its
    kernels-line entry — the deepest decode tick's layer-0 inputs (with
    the scale pools for an int8 pool) replayed against the plain version,
    with kernel, plain and bound times."""
    captured: list = []
    original = pk.paged_decode_attention

    def record(q, k_pages, v_pages, block_tables, lengths, *scales):
        # Keep every decode tick's layer-0 inputs (q, tables, lengths) as
        # device copies, which need no sync; the pools are read back after
        # the run.
        if record.calls % cfg.n_layer == 0:
            captured.append((q.clone(), block_tables.clone(),
                             lengths.clone()))
        record.calls += 1
        return original(q, k_pages, v_pages, block_tables, lengths, *scales)

    record.calls = 0
    run = serve(cfg, params, reqs, "kernel", pk, record=record, **quant)
    emit(phase=phase, **run["metrics"])
    if run["launches"] == 0:
        raise AssertionError(f"{phase}: the main path launched no kernel")
    spread = [run["metrics"]] + [
        serve(cfg, params, reqs, "kernel", pk, **quant)["metrics"]
        for _ in range(spread_runs)
    ]
    emit(phase=f"{phase}_spread", runs=len(spread), **{
        key: [m[key] for m in spread]
        for key in ("mean_decode_tick_ms", "generated_tok_per_s",
                    "ttft_p50_ms", "wall_s")
    })
    cache = run["engine"]._cache
    q, tables, lengths = max(captured, key=lambda c: int(c[2].sum()))
    kargs = (q, cache["k"][0], cache["v"][0], tables, lengths)
    if "k_scale" in cache:
        kargs += (cache["k_scale"][0], cache["v_scale"][0])
    checked = check_kernel(pk, kargs, f"{phase} main-path inputs")
    bound_ms, bound_by = paged_bound(q, kargs[1], tables, lengths)
    entry = dict(
        launches=run["launches"], **checked, **split_plan(pk, kargs),
        ms=time_ms(lambda: pk.paged_decode_attention(*kargs), flush),
        plain_ms=time_ms(lambda: pk.paged_decode_attention_reference(*kargs),
                         flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        inputs=dict(B=q.shape[0], H=q.shape[1], Hkv=kargs[1].shape[2],
                    D=q.shape[2], dtype=cfg.dtype,
                    pages=str(kargs[1].dtype).replace("torch.", ""),
                    lengths=lengths.tolist()),
    )
    return dict(entry=entry, metrics=run["metrics"])


def quality_phase(cfg, params, reqs, tokens, dev) -> None:
    """int8 quality on the card (f32): the served sequences (``tokens``, by
    request id) teacher-forced through ``decode.forward`` once with the
    unquantized params and pool, once with int8 weights and pool. The
    relative logit MSE over the generated positions (mean over requests,
    as the JAX package's quality test) is gated by ``Q8_QUALITY``; the
    teacher-forced argmax agreement is printed, not gated: random
    full-width weights leave near-ties that flip (the CPU tests gate it
    on a tiny model)."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.ops import quant

    seqs = [np.asarray(tokens[r], np.int32)[:-1] for r in sorted(tokens)]
    regions = [(len(reqs[r]["prompt"]) - 1, len(seqs[r]))
               for r in range(len(seqs))]
    n, t_max, page = len(seqs), max(len(x) for x in seqs), 16
    batch = np.zeros((n, t_max), np.int32)
    for i, x in enumerate(seqs):
        batch[i, : len(x)] = x
    n_pp = -(-t_max // page)
    tables = torch.arange(1, 1 + n * n_pp, dtype=torch.int32,
                          device=dev).reshape(n, n_pp)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    logits = {}
    for kv_quant, p in (("none", params),
                        ("int8", quant.quantize_decode_params(params))):
        cache = decode.init_paged_cache(cfg, n * n_pp + 1, page,
                                        device=dev, kv_quant=kv_quant)
        with torch.no_grad():
            out, _ = decode.forward(p, torch.from_numpy(batch).to(dev), cfg,
                                    cache, pos, block_tables=tables,
                                    kv_quant=kv_quant)
        logits[kv_quant] = [out[i, g0:g1].cpu().numpy()
                            for i, (g0, g1) in enumerate(regions)]
        del out, cache
    mse = [quant.relative_logit_mse(a, b)
           for a, b in zip(logits["none"], logits["int8"])]
    agree = [quant.argmax_agreement(a, b)
             for a, b in zip(logits["none"], logits["int8"])]
    budget = quant.Q8_QUALITY["max_relative_logit_mse"]
    res = dict(relative_logit_mse=statistics.fmean(mse),
               max_request_relative_logit_mse=max(mse),
               argmax_agreement=statistics.fmean(agree),
               min_request_argmax_agreement=min(agree),
               positions=sum(g1 - g0 for g0, g1 in regions),
               max_relative_logit_mse=budget)
    emit(phase="q8_quality", **res)
    if not res["relative_logit_mse"] <= budget:
        raise AssertionError(f"int8 relative logit MSE over budget: {res}")


def llama_phase(pk, seed, dev) -> None:
    """Llama-3.2-1B at full width (16 layers, E 2048, 32 heads over 8 KV
    heads: group 4, head_dim 64, vocab 128256), random weights drawn on
    the card from ``seed``, the same request shapes as GPT-2: int8 f32
    kernel vs gather (>= 15/16 identical), then bf16 unquantized through
    K3 and bf16 int8 through K4, each with launches == 16 x decode ticks
    and the other kernel's count 0 (``serve``); then a profile of each
    bf16 engine."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import llama
    from pytorch_distributed_tpu_torch.utils import tree

    cfg = model_config("llama3-1b")  # bf16 activations, f32 params
    t0 = time.perf_counter()
    params = llama.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = requests(cfg, seed)
    kernel_vs_gather("serve_llama_q8_f32", cfg.replace(dtype="float32"),
                     params, reqs, pk, **Q8)
    drives = {name: serve(cfg, params, reqs, "kernel", pk, **quant)["metrics"]
              for name, quant in (("bf16_K3", {}), ("bf16_q8_K4", Q8))}
    emit(phase="serve_llama", init_s=init_s,
         n_params=sum(t.numel() for t in tree.leaves(params)), **drives)
    profile_phase(cfg, params, reqs, phase="profile_llama")
    profile_phase(cfg, params, reqs, phase="profile_llama_q8", **Q8)


def _sse_stream(host, port, body, on_first_token=None):
    """POST ``body`` to /v1/generate with ``stream`` on and read its
    Server-Sent Events with ``http.client``: returns (token events, the
    done event's data, seconds to the first token, seconds to the end).
    ``on_first_token()`` runs once, after the first token arrives."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"SSE request got HTTP {resp.status}")
    tokens, done, first = [], None, None
    event = "message"
    while True:
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode().rstrip("\n")
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data = json.loads(line[len("data:"):])
            if event == "done":
                done = data
            else:
                tokens.append(data["token"])
                if first is None:
                    first = time.perf_counter() - t0
                    if on_first_token is not None:
                        on_first_token()
        elif not line:
            event = "message"
    conn.close()
    return tokens, done, first, time.perf_counter() - t0


def _http_json(host, port, method, path, body=None):
    """One request over ``http.client``: (status, headers, decoded JSON)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, dict(resp.getheaders()), json.loads(resp.read())
    conn.close()
    return out


def _tier_launches(pk, cfg, q8, ticks, warmups) -> dict:
    """The paged kernels' counts against what the tier drove: the path's
    kernel (K4 for int8 pools) n_layer x (``ticks`` decode ticks +
    ``warmups`` engine warmups, one decode forward each), the other 0."""
    want = {"K3": 0, "K4": 0}
    want["K4" if q8 else "K3"] = cfg.n_layer * (ticks + warmups)
    got = {"K3": pk.launches, "K4": pk.launches_q8}
    if got != want:
        raise AssertionError(
            f"tier launches {got} != {want} (n_layer {cfg.n_layer} x "
            f"(decode ticks {ticks} + warmups {warmups})): the tier's "
            "decode did not go through its kernel"
        )
    return dict(launches=got, decode_ticks=ticks, warmups=warmups)


def tier_http_phase(pk, seed, smi) -> dict:
    """The serving twin on the card: ``serving.serve``'s own ``build``, GPT-2
    124M (bf16), 2 replicas x 4 slots, max_len 1024, on 127.0.0.1 port 0.
    A greedy 64-token SSE stream whose replica is killed (/admin/kill)
    after its first token must end in ``event: done``, DONE, with 64
    tokens streamed; /healthz shows the replica DOWN, /admin/restart
    brings it back HEALTHY; a plain request then runs on the restarted
    replica; a burst of 48 concurrent requests must meet at least one 429
    with Retry-After (``--queue-limit 2``: at most two queued requests per
    replica, so the burst overflows whatever the host's speed). K3 counted
    from zero over the whole phase, launched from the server's drive
    thread."""
    from pytorch_distributed_tpu_torch.serving import serve

    args = serve.parse_args([
        "--preset", "gpt2", "--replicas", "2", "--slots", "4",
        "--max-len", "1024", "--host", "127.0.0.1", "--port", "0",
        "--queue-limit", "2", "--seed", str(seed)])
    cfg, params, router, server = serve.build(args)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 48).tolist()
    engines = list(router.engines().values())
    pk.launches = pk.launches_q8 = 0
    with serve.serve_in_thread(server) as (host, port):
        killed = {}

        def kill_serving_replica():
            _, _, health = _http_json(host, port, "GET", "/healthz")
            busy = [int(i) for i, r in health["replicas"].items()
                    if r.get("active_rows", 0) + r.get("queue_depth", 0)]
            status, _, body = _http_json(host, port, "POST", "/admin/kill",
                                         {"replica": busy[0]})
            killed.update(replica=busy[0], status=status,
                          states=body["states"])

        tokens, done, ttft, latency = _sse_stream(
            host, port, dict(prompt=prompt, max_new_tokens=64),
            on_first_token=kill_serving_replica)
        _, _, health = _http_json(host, port, "GET", "/healthz")
        down = health["replicas"][str(killed["replica"])]["state"]
        status, _, restarted = _http_json(
            host, port, "POST", "/admin/restart",
            {"replica": killed["replica"]})
        engines += [router.engines()[killed["replica"]]]
        t0 = time.perf_counter()
        status_plain, _, plain = _http_json(
            host, port, "POST", "/v1/generate",
            dict(prompt=prompt[:16], max_new_tokens=16))
        plain_s = time.perf_counter() - t0
        with ThreadPoolExecutor(48) as pool:
            burst = list(pool.map(
                lambda i: _http_json(host, port, "POST", "/v1/generate",
                                     dict(prompt=prompt[:8],
                                          max_new_tokens=8)),
                range(48)))
        counts = _tier_launches(
            pk, cfg, False,
            sum(e.counters["decode_ticks"] for e in engines), warmups=1)
    shed = [(h, b) for st, h, b in burst if st == 429]
    row = dict(
        phase="tier_http", nvidia_smi=smi, model="gpt2 L12 E768",
        dtype=cfg.dtype, replicas=2, slots=4, max_len=1024,
        stream_tokens=len(tokens), done_state=done and done["state"],
        first_token_s=ttft, request_s=latency, killed=killed,
        state_after_kill=down,
        state_after_restart=restarted["states"][str(killed["replica"])],
        plain_after_restart=dict(status=status_plain,
                                 state=plain.get("state"), seconds=plain_s),
        burst=dict(requests=48, ok=sum(st == 200 for st, _, _ in burst),
                   shed_429=len(shed),
                   retry_after=[h.get("Retry-After") for h, _ in shed[:3]]),
        router_counters=router.counters, **counts,
    )
    emit(**row)
    fails = []
    if killed.get("status") != 200 or down != "DOWN":
        fails.append(f"kill: {killed}, state after {down}")
    if done is None or done["state"] != "DONE" or len(tokens) != 64:
        fails.append(f"stream: {len(tokens)} tokens, done {done}")
    elif done["tokens"][len(prompt):] != tokens:
        fails.append("streamed tokens differ from the done event's")
    if row["state_after_restart"] != "HEALTHY":
        fails.append(f"restart: {restarted}")
    if status_plain != 200 or plain.get("state") != "DONE":
        fails.append(f"plain request after restart: {status_plain} {plain}")
    if router.engines()[killed["replica"]].counters["decode_ticks"] == 0:
        fails.append("the restarted replica decoded nothing")
    if not shed or not all(float(h["Retry-After"]) >= 1 and
                           b["retry_after_s"] > 0 for h, b in shed):
        fails.append(f"no 429 with Retry-After in the burst: {row['burst']}")
    if router.counters["failovers"] != 1:
        fails.append(f"failovers {router.counters['failovers']} != 1")
    if fails:
        raise AssertionError(f"tier_http: {fails}")
    return row


def tier_legs(pk, cfg, params, lg_args, smi, phase, engine_kw=None) -> dict:
    """The loadgen twin's legs on the card (``serving.loadgen``'s
    functions): a clean and a storm fleet, warmed and calibrated, then at
    each of ``lg_args.rates`` a clean and a storm leg on one seeded
    schedule. Each leg is driven with the paged kernels' counts at zero
    and read just after (``_tier_launches``), and its peak memory from a
    reset; the storm's DONE outputs are compared with the clean leg's.
    Gates every leg: no lost or duplicated request, every clean request
    DONE, a storm leg's kill fired. f32 also: at most 1 in 16 storm
    outputs differ from the clean leg's, each only at or after its
    failover token. Other dtypes report the count."""
    from pytorch_distributed_tpu_torch.serving import loadgen
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    engine_kw = engine_kw or {}
    requests = request_stream(
        np.random.default_rng(lg_args.seed), n=lg_args.requests,
        vocab_size=cfg.vocab_size, prompt_len=(4, lg_args.max_len // 3),
        max_new=lg_args.max_new, key_seed=lg_args.seed)
    fleets = {name: loadgen.make_fleet(cfg, lg_args, None, **engine_kw)
              for name in ("clean", "storm")}
    for fleet in fleets.values():
        fleet.warmup(params)
    t0 = time.perf_counter()
    capacity = loadgen.calibrate(list(fleets.values()), params, requests,
                                 lg_args)
    rows, fails = [], []
    for rate_i, mult in enumerate(lg_args.rates):
        offered = capacity * mult
        arrivals = exponential_arrivals(
            np.random.default_rng(lg_args.seed + 101), lg_args.requests,
            1.0 / offered)
        legs = {}
        order = ("clean", "storm") if rate_i % 2 == 0 else ("storm", "clean")
        for name in order:
            fleet = fleets[name]
            restarts0 = fleet.counters["restarts"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pk.launches = pk.launches_q8 = 0
            leg = loadgen.run_leg(fleet, params, requests, arrivals,
                                  lg_args, storm=name == "storm", mult=mult)
            torch.cuda.synchronize()
            leg["row"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            # Decode ticks summed over every engine that ran (``drive``),
            # and each restart's warmup (one decode forward).
            leg["row"].update(_tier_launches(
                pk, cfg, engine_kw.get("kv_quant") == "int8",
                leg["row"]["decode_ticks"],
                fleet.counters["restarts"] - restarts0))
            legs[name] = leg
            loadgen.restore_fleet(fleet, params)
        cmp = loadgen.compare_legs(legs["clean"], legs["storm"], requests)
        gate = loadgen.leg_failures(mult, legs["clean"], legs["storm"],
                                    dict(cmp, mismatches=[]),
                                    lg_args.requests)
        if cfg.dtype == "float32":
            late = [m for m in cmp["mismatches"]
                    if not m["failover_points"]
                    or m["first_diff_token"] < min(m["failover_points"])]
            if len(cmp["mismatches"]) * 16 > cmp["compared"] or late:
                gate.append(
                    f"rate x{mult}: {len(cmp['mismatches'])} of "
                    f"{cmp['compared']} storm outputs differ from the clean "
                    f"leg (bar: 1 in 16, each at or after its failover "
                    f"token): {cmp['mismatches']}")
        row = dict(rate_multiplier=mult, offered_qps=offered,
                   clean=legs["clean"]["row"],
                   storm=dict(legs["storm"]["row"],
                              done_outputs_match_clean=cmp[
                                  "done_outputs_match_clean"],
                              mismatches=cmp["mismatches"]))
        emit(phase=phase, nvidia_smi=smi, dtype=cfg.dtype,
             model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}",
             replicas=lg_args.replicas, slots=lg_args.slots,
             max_len=lg_args.max_len, requests=lg_args.requests,
             max_new=lg_args.max_new, capacity_req_per_s=capacity,
             **engine_kw, **row)
        rows.append(row)
        fails += gate
    if fails:
        raise AssertionError(f"{phase} ({cfg.dtype}): {fails}")
    tier_profile(fleets["clean"], params, requests, smi, phase, cfg)
    return dict(rows=rows, seconds=time.perf_counter() - t0)


def tier_profile(fleet, params, requests, smi, phase, cfg,
                 n_ticks: int = 3) -> None:
    """``torch.profiler`` over ``n_ticks`` router ticks of ``fleet`` with
    every slot of every replica decoding (after their prefills): the
    device's busy share of a tier tick, its kernels and host ops. Three
    ticks: a tick of four replicas traces thousands of host ops, and
    summing ten of them took most of the phase."""
    from torch.profiler import ProfilerActivity, profile

    n = sum(e.slots for e in fleet.engines().values())
    rids = [fleet.submit(**dict(r, max_new_tokens=64))
            for r in requests[:n]]
    while True:
        before = sum(e.counters["prefill_ticks"]
                     for e in fleet.engines().values())
        fleet.step(params)
        if sum(e.counters["prefill_ticks"]
               for e in fleet.engines().values()) == before:
            break
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            fleet.step(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fleet.run(params)
    for rid in rids:
        fleet.pop_result(rid)
    emit(phase=f"{phase}_profile", nvidia_smi=smi, dtype=cfg.dtype,
         model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}",
         router_ticks=n_ticks, replicas=len(fleet.engines()),
         rows_decoding=n, **profile_summary(prof, wall_ms))


def failover_paths_phase(pk, seed, dev, smi) -> dict:
    """Where a failed-over row's values part from an undisturbed run's:
    one GPT-2 124M block (layer 0's weights as the engine places them) on
    the same rows, once decode-shaped ([4, 1, E] — a decode tick of 4
    slots) and once prefill-shaped (the same rows inside a [4, 64, E]
    chunk — the re-prefill after a failover), in f32 and bf16: ln_1, the
    qkv projection, the attention over the same 70 paged keys (K3 for
    the decode shape, the gather path for the chunk), c_proj and the
    MLP's first product, each op fed the decode shape's own input so
    only the shape differs. Prints each op's largest difference and
    whether it is bit-equal, and the first op that differs."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.ops.layers import dense, layer_norm
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    base = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), base)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dtype)
        eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=1024,
                                       page_size=16)
        bp = eng._place_params(params)["blocks"][0]
        dt = getattr(torch, dtype)
        e, h, d = cfg.n_embd, cfg.n_head, cfg.head_dim
        g = torch.Generator(device=dev).manual_seed(seed)
        at = 5  # the row's position inside the prefill chunk
        chunk = torch.randn(4, 64, e, generator=g, device=dev).to(dt)

        def both(fn, x_chunk):
            # The decode shape's input is the chunk's column ``at``.
            small = fn(x_chunk[:, at:at + 1])
            big = fn(x_chunk)[:, at:at + 1]
            diff = (small.float() - big.float()).abs().max().item()
            return dict(max_abs=diff, bit_equal=torch.equal(small, big))

        rows = {}
        rows["ln_1"] = both(
            lambda x: layer_norm(x, bp["ln_1"],
                                 eps=cfg.layer_norm_epsilon), chunk)
        a = layer_norm(chunk, bp["ln_1"], eps=cfg.layer_norm_epsilon)
        rows["c_attn"] = both(lambda x: dense(x, bp["attn"]["c_attn"]), a)
        # Attention: 70 keys per row in pages 1..5 of each row's table;
        # the decode query sits at position 69, the chunk covers 6..69.
        n_pool = 4 * 5 + 1
        kp = torch.randn(n_pool, 16, h, d, generator=g, device=dev).to(dt)
        vp = torch.randn(n_pool, 16, h, d, generator=g, device=dev).to(dt)
        tables = (torch.arange(4 * 5, device=dev).reshape(4, 5) + 1
                  ).to(torch.int32)
        tables = torch.cat([tables, torch.zeros(4, 59, dtype=torch.int32,
                                                device=dev)], 1)
        q = torch.randn(4, 64, h, d, generator=g, device=dev).to(dt)
        dec = pk.paged_decode_attention(
            q[:, 63].contiguous(), kp, vp, tables,
            torch.full((4,), 69, dtype=torch.int32, device=dev))
        pre = pk.gather_attention(
            q, kp, vp, tables,
            torch.full((4,), 6, dtype=torch.int32, device=dev))[:, 63]
        rows["attention"] = dict(
            max_abs=(dec.float() - pre.float()).abs().max().item(),
            bit_equal=torch.equal(dec, pre))
        o = torch.randn(4, 64, e, generator=g, device=dev).to(dt)
        rows["c_proj"] = both(lambda x: dense(x, bp["attn"]["c_proj"]), o)
        rows["c_fc"] = both(lambda x: dense(x, bp["mlp"]["c_fc"]), a)
        first = next((name for name, r in rows.items()
                      if not r["bit_equal"]), None)
        out[dtype] = dict(ops=rows, first_differing=first)
        emit(phase="failover_paths", nvidia_smi=smi, dtype=dtype,
             model="gpt2 L12 E768 block 0", decode_shape=[4, 1, e],
             prefill_shape=[4, 64, e], **out[dtype])
    return out


# Requests a tier leg (tier_storm, tier_llama_q8): 24 (40 earlier), to
# keep the script's last phase within 1000 s on a slow call (its serial
# prefix has spread 1.6x between runs on one machine type); the kill
# schedule's first kill (tick 12) still fires within every storm leg.
TIER_REQUESTS = 24


def tier_storm_args(replicas: int, rates: list[float]):
    from pytorch_distributed_tpu_torch.serving import loadgen

    return loadgen.parse_args([
        "--replicas", str(replicas), "--slots", "4", "--max-len", "1024",
        "--requests", str(TIER_REQUESTS), "--max-new", "24", "--device",
        "cuda", "--rates", *map(str, rates)])


def tier_storm_phase(pk, seed, smi) -> dict:
    """GPT-2 124M at full width, 4 replicas x 4 slots, max_len 1024,
    ``TIER_REQUESTS`` requests (prompts 4-341 tokens, 24 new; the
    workload's greedy/sampled cycle), the loadgen twin's kill schedule, rates 0.5 and 2.0 of the
    calibrated capacity; in f32 and in bf16 (``tier_legs``)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2

    base = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), base)
    lg_args = tier_storm_args(4, [0.5, 2.0])
    return {dtype: tier_legs(pk, base.replace(dtype=dtype), params, lg_args,
                             smi, "tier_storm")
            for dtype in ("float32", "bfloat16")}


def tier_llama_q8_phase(pk, seed, dev, smi) -> dict:
    """Llama-3.2-1B at full width with int8 KV pages and weights (K4),
    2 replicas x 4 slots, max_len 1024, ``TIER_REQUESTS`` requests, rate
    1.0, clean and
    storm (``tier_legs``; bf16, so the output match is reported)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import llama

    cfg = model_config("llama3-1b")
    params = llama.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    return tier_legs(pk, cfg, params, tier_storm_args(2, [1.0]), smi,
                     "tier_llama_q8", engine_kw=Q8)


# -- generation outside the paged engine: generate, dense, spec, soak, ------
# -- serve_dense ------------------------------------------------------------


def _paged_launches(pk, phase) -> dict:
    """K3/K4 launches since the last reset, checked at 0: the dense and
    serial engines never run them."""
    got = {"K3": pk.launches, "K4": pk.launches_q8}
    if got != {"K3": 0, "K4": 0}:
        raise AssertionError(f"{phase}: K3/K4 launched {got}, want 0")
    return got


def _window_launches(pk, phase, kid, ticks, n_layer) -> dict:
    """K3/K4 launches of speculating paged drives since the last reset:
    their verify forward runs each of its K+1 queries as a row of the
    paged kernel (``kid``, K4 under int8 pages), one launch a layer a
    decode tick (``ticks`` in all); prefill chunks take the gather path,
    and the other kernel stays at 0."""
    got = {"K3": pk.launches, "K4": pk.launches_q8}
    want = {"K3": 0, "K4": 0}
    want[kid] = n_layer * ticks
    if got != want:
        raise AssertionError(f"{phase}: K3/K4 launched {got}, want {want}")
    return got


def drive_engine(eng, params, reqs) -> dict:
    """One drive of ``reqs`` through a warmed batched engine: tokens by
    request index, and the host-clock metrics (pure decode tick ms, the
    ms of a step that prefilled, generated tok/s, TTFT p50) with the
    engine's counters."""
    rids = [eng.submit(**r) for r in reqs]
    plen = {rid: len(r["prompt"]) for rid, r in zip(rids, reqs)}
    ttft: dict[int, float] = {}
    decode_ms, prefill_ms = [], []
    t0 = time.perf_counter()
    while eng.has_work():
        c0 = dict(eng.counters)
        s = time.perf_counter()
        eng.step(params)
        e = time.perf_counter()
        if eng.counters["prefill_ticks"] > c0["prefill_ticks"]:
            prefill_ms.append((e - s) * 1e3)
        elif eng.counters["decode_ticks"] > c0["decode_ticks"]:
            decode_ms.append((e - s) * 1e3)
        for rid in rids:
            if rid not in ttft:
                toks = eng.peek_tokens(rid)
                if toks is not None and len(toks) > plen[rid]:
                    ttft[rid] = (e - t0) * 1e3
    wall = time.perf_counter() - t0
    results = [eng.pop_result(rid) for rid in rids]
    bad = [r.state for r in results if r.state != "DONE"]
    if bad:
        raise AssertionError(f"requests not DONE: {bad}")
    generated = sum(len(r.tokens) - plen[rid]
                    for rid, r in zip(rids, results))
    c = eng.counters
    return dict(
        tokens=[np.asarray(r.tokens) for r in results],
        metrics=dict(
            generated_tokens=generated, wall_s=wall,
            generated_tok_per_s=generated / wall,
            mean_decode_tick_ms=(statistics.fmean(decode_ms)
                                 if decode_ms else None),
            pure_decode_ticks=len(decode_ms),
            mean_prefill_step_ms=statistics.fmean(prefill_ms),
            ttft_p50_ms=statistics.median(ttft.values()),
            decode_ticks=c["decode_ticks"], prefill_ticks=c["prefill_ticks"],
            drafted_tokens=c["drafted_tokens"],
            accepted_tokens=c["accepted_tokens"],
            spec_commits=c["spec_commits"],
            accept_rate=eng.stats()["spec_accept_rate"],
            committed_per_row_tick=(
                (c["accepted_tokens"] + c["spec_commits"]) / c["spec_commits"]
                if c["spec_commits"] else None),
            # Each request's first token comes from its prefill.
            committed_per_decode_tick=(generated - len(reqs))
            / max(1, c["decode_ticks"]),
            cache_bytes=eng.cache_hbm_bytes()["allocated"],
        ),
    )


def _same(a, b) -> int:
    return sum(np.array_equal(x, y) for x, y in zip(a, b))


def generate_phase(pk, seed, smi) -> dict:
    """The generation entry point's functions (``serving.generate``) at
    full width: GPT-2 124M, random weights from ``seed``, a 64-token
    prompt, 64 new tokens. In f32 (gated) and bf16 (reported): the twin's
    greedy ``decode.generate``, ``generate_monolithic`` and ``--stream``
    (``DecodeEngine.stream``) token-equal; a warm ``DecodeEngine`` timed
    over three 64-token requests. A sampled run repeated with the same
    seed gives the same tokens. MoE: GPT-2 124M with 8 experts top-2
    (``--n-experts 8 --moe-top-k 2``), 8 prompts of 32 tokens, 32 new
    tokens each, at B 1 and at B 4: f32 rows equal on >= 7 of 8 (a row's
    tokens do not depend on its batch at the no-drop capacity; the card's
    products of another M may round a near-tie the other way), bf16
    reported. K3/K4 launch 0 times."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.serving import generate as gen
    from pytorch_distributed_tpu_torch.serving.engine import DecodeEngine

    rng = np.random.default_rng(seed)
    base = ["--preset", "gpt2", "--max-new-tokens", "64", "--seed",
            str(seed), "--prompt-ids",
            ",".join(str(t) for t in rng.integers(0, 50257, 64))]
    args = gen.parse_args(base)
    cfg, params = gen.load_params(args)
    ids = gen.prompt_ids(args)
    pk.launches = pk.launches_q8 = 0
    rows = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        twin = gen.generate_ids(args, c, params, ids)
        mono = decode.generate_monolithic(params, ids, c, 64)[0]
        streamed = gen.generate_ids(gen.parse_args(base + ["--stream"]), c,
                                    params, ids)
        eng = DecodeEngine(c, max_len=128)
        eng.generate(params, ids, 64)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(params, ids, 64)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        req_s = statistics.median(times)
        rows[dtype] = dict(
            generate_eq_monolithic=bool(np.array_equal(
                twin, mono.cpu().numpy())),
            stream_eq_generate=bool(np.array_equal(streamed, twin)),
            request_s=req_s, ms_per_token=req_s / 64 * 1e3,
            tok_per_s=64 / req_s, request_s_runs=times)
    samp = base + ["--temperature", "0.8", "--top-k", "50", "--top-p",
                   "0.95"]
    a = gen.generate_ids(gen.parse_args(samp), cfg, params, ids)
    b = gen.generate_ids(gen.parse_args(samp), cfg, params, ids)
    sampled = dict(repeat_equal=bool(np.array_equal(a, b)),
                   differs_from_greedy=not np.array_equal(
                       a, gen.generate_ids(args, cfg, params, ids)))
    del params
    margs = gen.parse_args(base + ["--n-experts", "8", "--moe-top-k", "2",
                                   "--max-new-tokens", "32"])
    mcfg, mparams = gen.load_params(margs)
    prompts = rng.integers(0, 50257, (8, 32)).astype(np.int32)
    moe = {}
    for dtype in ("float32", "bfloat16"):
        c = mcfg.replace(dtype=dtype)
        eng = DecodeEngine(c, max_len=64)
        t0 = time.perf_counter()
        b4 = np.concatenate([eng.generate(mparams, prompts[i:i + 4], 32)
                             .cpu().numpy() for i in (0, 4)])
        b4_s = time.perf_counter() - t0
        b1 = [eng.generate(mparams, prompts[i:i + 1], 32)[0].cpu().numpy()
              for i in range(8)]
        moe[dtype] = dict(rows_equal_b1_b4=_same(b1, b4), of=8,
                          b4_tok_per_s=8 * 32 / b4_s)
    del mparams
    row = dict(phase="generate", nvidia_smi=smi, model="gpt2 L12 E768",
               prompt_len=64, new_tokens=64, greedy=rows, sampled=sampled,
               moe=dict(model="gpt2 L12 E768, 8 experts top-2", **moe),
               launches=_paged_launches(pk, "generate"))
    emit(**row)
    fails = []
    f32 = rows["float32"]
    if not (f32["generate_eq_monolithic"] and f32["stream_eq_generate"]):
        fails.append(f"f32 generate/monolithic/stream differ: {f32}")
    if not sampled["repeat_equal"]:
        fails.append("a sampled run repeated with its seed differs")
    if moe["float32"]["rows_equal_b1_b4"] < 7:
        fails.append(f"MoE f32 B 1 vs B 4: {moe['float32']}")
    if fails:
        raise AssertionError(f"generate: {fails}")
    return row


def dense_phase(pk, cfg, params, reqs, paged_f32_tokens, smi) -> dict:
    """The dense ``BatchedDecodeEngine`` at full width (GPT-2 124M, 8 slots,
    max_len 1024, buckets 64-1024): the serve phase's 16 requests in f32,
    token-equal to the paged engine's f32 kernel drive on >= 15 of 16
    (gated), then in bf16 (tick ms, tok/s, TTFT p50, cache bytes); a
    profile of ten decode ticks; the dense prefill's values independent
    of the rows beside it (bf16: a 40-token prompt's K/V alone and beside
    three others, bit-equal). K3/K4 launch 0 times."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
    )

    def engine(c):
        eng = BatchedDecodeEngine(c, slots=8, max_len=1024,
                                  buckets=BucketSpec.powers_of_two(1024, 64))
        eng.warmup(params)
        return eng

    pk.launches = pk.launches_q8 = 0
    f32 = drive_engine(engine(cfg.replace(dtype="float32")), params, reqs)
    same = _same(f32["tokens"], [paged_f32_tokens[r] for r in
                                 sorted(paged_f32_tokens)])
    bf16 = drive_engine(engine(cfg), params, reqs)
    profile_phase(cfg, params, reqs, phase="dense_profile",
                  engine=engine(cfg))
    rng = np.random.default_rng(1)
    x = rng.integers(0, cfg.vocab_size, 40)
    kv = []
    for others in ((), (50, 20, 60)):
        eng = BatchedDecodeEngine(cfg, slots=8, max_len=1024,
                                  buckets=BucketSpec((64,)))
        for n in others:
            eng.submit(rng.integers(0, cfg.vocab_size, n), 4)
        rid = eng.submit(x, 4)
        eng.step(params)
        row = next(i for i, s in enumerate(eng._slots)
                   if s is not None and s.rid == rid)
        kv.append([eng._cache[n][:, row, :40].clone() for n in ("k", "v")])
        del eng
    neighbours = all(torch.equal(a, b) for a, b in zip(*kv))
    out = dict(phase="dense", nvidia_smi=smi, model="gpt2 L12 E768",
               slots=8, max_len=1024, requests=len(reqs),
               f32_identical_to_paged=same, of=len(reqs),
               f32=f32["metrics"], bf16=bf16["metrics"],
               prefill_independent_of_neighbours_bf16=neighbours,
               launches=_paged_launches(pk, "dense"))
    emit(**out)
    if same < 15 or not neighbours:
        raise AssertionError(
            f"dense: f32 dense vs paged {same}/{len(reqs)} identical, "
            f"prefill independent of neighbours: {neighbours}")
    return out


def spec_streams(cfg, seed) -> dict:
    """The spec phase's two greedy streams of 16 requests, 32 new tokens
    each: ``repetitive`` (patterns of 2-5 tokens tiled 3-6 times:
    prompt lookup should win) and ``random`` (prompts of 16-256 random
    tokens: it should lose)."""
    from pytorch_distributed_tpu_torch.serving import workload as wl

    return {
        "repetitive": wl.repetitive_request_stream(
            np.random.default_rng(seed), n=16, vocab_size=cfg.vocab_size,
            max_new=32),
        "random": wl.request_stream(
            np.random.default_rng(seed + 1), n=16,
            vocab_size=cfg.vocab_size, prompt_len=(16, 256), max_new=32,
            sampling_cycle=(dict(),)),
    }


def spec_pair(pk, make, c, params, reqs, phase) -> dict:
    """Plain vs ``speculative_k=4, spec_ngram=2`` on one engine kind, dtype
    and stream: identical requests, the spec drive's K3/K4 launches
    (checked: 0 on the dense engine, one a layer a decode tick of the
    paged engine's kernel), and each drive's metrics."""
    plain = make(c, 0)
    plain.warmup(params)
    p = drive_engine(plain, params, reqs)
    spec = make(c, 4)
    spec.warmup(params)
    pk.launches = pk.launches_q8 = 0
    s = drive_engine(spec, params, reqs)
    if hasattr(spec, "pool"):
        launches = _window_launches(
            pk, phase, "K4" if spec.kv_quant == "int8" else "K3",
            spec.counters["decode_ticks"], c.n_layer)
    else:
        launches = _paged_launches(pk, phase)
    return dict(identical=_same(p["tokens"], s["tokens"]), of=len(reqs),
                launches=launches, plain=p["metrics"], spec=s["metrics"],
                spec_vs_plain_tok_per_s=(
                    s["metrics"]["generated_tok_per_s"]
                    / p["metrics"]["generated_tok_per_s"]))


def spec_phase(pk, seed, dev, smi) -> dict:
    """Batched speculative decoding (``speculative_k=4``, ``spec_ngram=2``)
    at full width: GPT-2 124M on the dense and the paged engine (8 slots,
    max_len 1024) in f32 and bf16, and Llama-3.2-1B on the paged engine
    with int8 KV pages and weights (the JAX test
    ``test_spec_int8_pages_match_plain_int8`` at full width), each on the
    ``repetitive`` and ``random`` streams (``spec_streams``): spec vs
    plain token-equal on >= 15 of 16 in f32 (gated; bf16 reported),
    K3/K4 launched 0 times by every dense spec drive and once a layer a
    decode tick by every paged one (K4 on int8 pages), accept rate, committed
    tokens per row-tick, decode ticks, tok/s and TTFT of spec against
    plain. Then the rollback check: a paged bf16 spec engine publishes a
    128-token prefix (two 64-token chunks), and four borrowers of that
    prefix speculating with mostly rejected drafts leave its pages
    bit-unchanged (gated) and produce the tokens that each borrower gets
    alone from a fresh engine with the same drafts, which shares nothing
    (gated, 4 of 4). The launches line sums the K3/K4 counts of every spec
    drive and of the rollback check."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
        PagedBatchedDecodeEngine,
    )

    def dense(c, k, **kw):
        return BatchedDecodeEngine(c, slots=8, max_len=1024,
                                   buckets=BucketSpec.powers_of_two(1024, 64),
                                   speculative_k=k, **kw)

    def paged(c, k, **kw):
        return PagedBatchedDecodeEngine(c, slots=8, max_len=1024,
                                        page_size=16, speculative_k=k, **kw)

    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    streams = spec_streams(cfg, seed)
    rows, fails = {}, []
    for kind, make in (("dense", dense), ("paged", paged)):
        for dtype in ("float32", "bfloat16"):
            for name, reqs in streams.items():
                key = f"gpt2_{kind}_{dtype}_{name}"
                rows[key] = spec_pair(pk, make, cfg.replace(dtype=dtype),
                                      params, reqs, f"spec {key}")
                emit(phase="spec", run=key, nvidia_smi=smi, **rows[key])
                if dtype == "float32" and rows[key]["identical"] < 15:
                    fails.append(f"{key}: {rows[key]['identical']}/16")

    # Rollback on the in-place pool: published pages stay bit-unchanged.
    c = cfg

    def rejected(h, k):
        return (h[-k:] + 1) % c.vocab_size

    eng = paged(c, 4, draft_hook=rejected)
    eng.warmup(params)
    pk.launches = pk.launches_q8 = 0
    rng = np.random.default_rng(seed + 2)
    prefix = rng.integers(0, c.vocab_size, 128).astype(np.int32)
    eng.run(params, [dict(prompt=prefix, max_new_tokens=4)])
    cached = sorted(eng.pool.cached_page_ids())
    before = {n: t[:, cached].clone() for n, t in eng._cache.items()}
    borrowers = [dict(prompt=np.concatenate(
        [prefix, rng.integers(0, c.vocab_size, 8 + i)]).astype(np.int32),
        max_new_tokens=32) for i in range(4)]
    got = eng.run(params, borrowers)
    unchanged = all(torch.equal(eng._cache[n][:, cached], t)
                    for n, t in before.items())
    alone, ticks = [], eng.counters["decode_ticks"]
    for b in borrowers:
        ref = paged(c, 4, draft_hook=rejected)
        alone.append(next(iter(ref.run(params, [b]).values())).tokens)
        ticks += ref.counters["decode_ticks"]
        del ref
    rollback = dict(
        cached_pages=len(cached), prefix_hits=eng.pool.stats["prefix_hits"],
        drafted=eng.counters["drafted_tokens"],
        accepted=eng.counters["accepted_tokens"],
        published_pages_unchanged=unchanged,
        borrowers_equal_unshared=_same(
            [got[r].tokens for r in sorted(got)], alone),
        launches=_window_launches(pk, "spec_rollback", "K3", ticks,
                                  c.n_layer))
    emit(phase="spec_rollback", nvidia_smi=smi, **rollback)
    if (not unchanged or rollback["prefix_hits"] < 4 or not cached
            or rollback["borrowers_equal_unshared"] != len(borrowers)):
        fails.append(f"rollback: {rollback}")
    del params, eng

    lcfg = model_config("llama3-1b")
    lparams = llama.init(torch.Generator(device=dev).manual_seed(seed), lcfg,
                         device=dev)
    lstreams = spec_streams(lcfg, seed)
    for dtype in ("float32", "bfloat16"):
        for name, reqs in lstreams.items():
            key = f"llama_paged_q8_{dtype}_{name}"
            rows[key] = spec_pair(
                pk, lambda c, k: paged(c, k, **Q8),
                lcfg.replace(dtype=dtype), lparams, reqs, f"spec {key}")
            emit(phase="spec", run=key, nvidia_smi=smi, **rows[key])
            if dtype == "float32" and rows[key]["identical"] < 15:
                fails.append(f"{key}: {rows[key]['identical']}/16")
    del lparams
    if fails:
        raise AssertionError(f"spec: {fails}")
    measured = [r["launches"] for r in rows.values()] + [rollback["launches"]]
    return dict(rows=rows, rollback=rollback,
                launches={kid: sum(m[kid] for m in measured)
                          for kid in ("K3", "K4")})


def soak_phase(pk, seed, smi) -> dict:
    """The soak twin (``serving.soak``'s ``run_soak``) at full width:
    GPT-2 124M in f32, 4 slots, its default storm of 200 requests (the
    JAX script's schedule, max_len 32), an engine loss at tick 60. All
    five invariants gated; K3/K4 0."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.serving import soak

    cfg = model_config("gpt2", dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    args = soak.parse_args(["--seed", str(seed)])
    pk.launches = pk.launches_q8 = 0
    t0 = time.perf_counter()
    report = soak.run_soak(args, cfg=cfg, params=params)
    report.update(wall_s=time.perf_counter() - t0,
                  launches=_paged_launches(pk, "soak"))
    emit(phase="soak", nvidia_smi=smi, model="gpt2 L12 E768 f32", **report)
    if not report["ok"]:
        raise AssertionError(f"soak: {report['invariant_failures']}")
    return report


def serve_dense_phase(pk, seed, smi) -> dict:
    """``serve --dense`` on the card: ``serving.serve``'s own ``build`` with
    2 dense GPT-2 124M bf16 replicas x 4 slots, max_len 1024, on
    127.0.0.1 port 0. A greedy 64-token SSE stream whose replica is
    killed after its first token ends DONE with 64 tokens; /healthz shows
    the replica DOWN, /admin/restart brings it back HEALTHY. K3/K4 0."""
    from pytorch_distributed_tpu_torch.serving import serve

    args = serve.parse_args([
        "--preset", "gpt2", "--dense", "--replicas", "2", "--slots", "4",
        "--max-len", "1024", "--host", "127.0.0.1", "--port", "0",
        "--seed", str(seed)])
    cfg, params, router, server = serve.build(args)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 48).tolist()
    pk.launches = pk.launches_q8 = 0
    with serve.serve_in_thread(server) as (host, port):
        killed = {}

        def kill_serving_replica():
            _, _, health = _http_json(host, port, "GET", "/healthz")
            busy = [int(i) for i, r in health["replicas"].items()
                    if r.get("active_rows", 0) + r.get("queue_depth", 0)]
            status, _, body = _http_json(host, port, "POST", "/admin/kill",
                                         {"replica": busy[0]})
            killed.update(replica=busy[0], status=status)

        tokens, done, ttft, latency = _sse_stream(
            host, port, dict(prompt=prompt, max_new_tokens=64),
            on_first_token=kill_serving_replica)
        _, _, health = _http_json(host, port, "GET", "/healthz")
        down = health["replicas"][str(killed["replica"])]["state"]
        _, _, restarted = _http_json(host, port, "POST", "/admin/restart",
                                     {"replica": killed["replica"]})
        launches = _paged_launches(pk, "serve_dense")
    row = dict(phase="serve_dense", nvidia_smi=smi, model="gpt2 L12 E768",
               dtype=cfg.dtype, replicas=2, slots=4, max_len=1024,
               engine=type(router.engines()[0]).__name__,
               stream_tokens=len(tokens), done_state=done and done["state"],
               first_token_s=ttft, request_s=latency, killed=killed,
               state_after_kill=down,
               state_after_restart=restarted["states"][
                   str(killed["replica"])],
               router_counters=router.counters, launches=launches)
    emit(**row)
    if (killed.get("status") != 200 or down != "DOWN"
            or done is None or done["state"] != "DONE" or len(tokens) != 64
            or row["state_after_restart"] != "HEALTHY"
            or router.counters["failovers"] != 1
            or row["engine"] != "BatchedDecodeEngine"):
        raise AssertionError(f"serve_dense: {row}")
    return row


# -- slice 10: multi-tenant LoRA and disaggregated prefill/decode ----------

LORA_SOURCE = "pytorch_distributed_tpu_torch/csrc/lora_delta.cu"
# The LoRA kernel vs its plain version (the JAX package's lowering through
# cuBLAS, then the add): f32 differs in summation order only (the
# Din-long dot of h, then r terms). bf16: see ``lora_tolerance``.
LORA_F32_TOLERANCE = dict(atol=1e-5, rtol=1e-5)


def lora_tolerance(dtype, y, delta) -> dict:
    """The kernel vs its plain version. f32: ``LORA_F32_TOLERANCE``. bf16:
    both round the f32 delta, then the add y + delta, to bf16; where the
    two f32 deltas straddle a rounding boundary the first roundings part
    by one ulp, and the add may carry that and one more rounding: 2 ulps
    of the largest value the chain holds, 2^-6 (max|y| + max|delta|)."""
    if dtype == torch.float32:
        return dict(LORA_F32_TOLERANCE)
    m = float(y.float().abs().max()) + float(delta.float().abs().max())
    return dict(atol=2.0**-6 * m, rtol=0.0)


LORA_RANK = 8
# B's scale (alpha): large enough that the random-init tenants' tokens
# visibly differ from the base model's.
LORA_SCALE = 64.0


def lora_registry(cfg, seed, n=4, spare=1):
    """``n`` tenants ``tenant-<i>`` at rank 8 from ``seed`` (and room for
    ``spare`` more, registered after a warmup)."""
    from pytorch_distributed_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )
    from pytorch_distributed_tpu_torch.serving.workload import request_seed

    reg = AdapterRegistry(cfg, rank=LORA_RANK, max_tenants=n + spare)
    for i in range(n):
        reg.register(f"tenant-{i}", seed=request_seed(seed, i),
                     scale=LORA_SCALE)
    return reg


# Requests of the GPT-2 LoRA legs: 16 (32 earlier), cut as
# ``TIER_REQUESTS`` was, for the same reason.
LORA_REQUESTS = 16


def lora_requests(cfg, seed, n=LORA_REQUESTS) -> list[dict]:
    """``n`` requests, prompts of 32-512 tokens, 64 new tokens each, every
    fourth sampled; striped over tenant-0..3 and no tenant (i % 5)."""
    rng = np.random.default_rng(seed + 10)
    out = []
    for i in range(n):
        req = dict(prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(32, 513))).astype(np.int32),
            max_new_tokens=64)
        if i % 4 == 3:
            req.update(temperature=0.8, top_k=50, top_p=0.95,
                       seed=seed * 1000 + i)
        if i % 5 < 4:
            req["tenant"] = f"tenant-{i % 5}"
        out.append(req)
    return out


# Every form in which the slice's paths hand the LoRA kernel its output:
# (name, model, target). GPT-2's query ("q") is the strided query third of
# the fused [B, T, 3, H, D] c_attn output, added into in place; the others
# are contiguous: GPT-2's c_proj before its bias, Llama-3.2-1B's wq and wo
# after their (int8 or plain) qdot, the decode_bench twin's n_embd-256
# GPT-2 (``decode_bench._serving_cfg``, 4 tenants: 5 slots).
LORA_FORMS = (
    ("gpt2 q", "gpt2", "q"),
    ("gpt2 c_proj", "gpt2", "c_proj"),
    ("llama3.2-1B wq", "llama3-1b", "wq"),
    ("llama3.2-1B wo", "llama3-1b", "wo"),
    ("decode_bench twin q", "twin", "q"),
    ("decode_bench twin c_proj", "twin", "c_proj"),
)


def lora_case(lp, target, dev, n_rows, t, dtype, seed):
    """The LoRA kernel's inputs at an engine's shape for one layer's
    adapter slice ``lp``: ``n_rows`` x ``t`` tokens over every slot, y in
    the form the block passes for ``target`` (``LORA_FORMS``). Returns (y,
    x, rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = tuple(lp["b"].shape[2:])
    x = torch.randn(n_rows, t, lp["a"].shape[1], generator=g,
                    device=dev).to(dtype)
    if target == "q":
        y = torch.randn(n_rows, t, 3, *out, generator=g,
                        device=dev).to(dtype)[:, :, 0]
    else:
        y = torch.randn(n_rows, t, *out, generator=g, device=dev).to(dtype)
    s_n = lp["a"].shape[0]
    rows = (torch.arange(n_rows * t, device=dev) // t) % s_n
    return y, x, rows


def lora_bound(x, y, lp, rows) -> tuple[float, str]:
    """Least time of the delta: x read, y read and written, the slots'
    factors in use and the rows read once over the HBM rate; or its f32
    multiply-adds over the f32 rate."""
    n, din = rows.numel(), x.shape[-1]
    out = y[0, 0].numel()
    r = lp["a"].shape[-1]
    used = int(torch.unique(rows).numel())
    nbytes = (x.numel() * x.element_size() + 2 * y.numel() * y.element_size()
              + used * (din * r + r * out) * 4 + n * 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * r * (din + out) / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def host_us(fn, n: int = 200) -> float:
    """Wall time of one call on the host, the device kept out of the way
    (synchronized before and after ``n`` calls): what an eager serving
    loop pays per call when its kernels are short."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def lora_kernel_phase(lk, dev, flush, seed) -> dict:
    """The LoRA kernel against its plain version in every form of
    ``LORA_FORMS``, at a decode shape (8 rows x 1 token) and a
    prefill-chunk shape (8 x 64), in f32 and bf16 (``lora_tolerance``),
    layer 0's adapter at rank 8, with kernel, plain and bound device times
    and each call's host time. The kernels line carries the GPT-2 c_proj
    case at the decode shape in bf16 (the serving tier's dtype)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.serving.decode_bench import (
        _serving_cfg,
    )

    cfgs = {"gpt2": model_config("gpt2"),
            "llama3-1b": model_config("llama3-1b"),
            "twin": _serving_cfg(False)}
    trees = {name: lora_registry(c, seed, spare=0 if name == "twin" else 1)
             .device_tree(dev)[0] for name, c in cfgs.items()}

    def plain(y, x, lp, r):
        return y + lk.lora_delta_reference(x, lp, r).to(y.dtype)

    rows, main = [], None
    for form, model, target in LORA_FORMS:
        lp = trees[model][target]
        for t in (1, 64):
            for dtype in (torch.float32, torch.bfloat16):
                y, x, r = lora_case(lp, target, dev, 8, t, dtype, seed + t)
                delta = lk.lora_delta_reference(x, lp, r)
                want = y + delta.to(dtype)
                got = lk.lora_delta_add(y.clone(), x, lp, r)
                tol = lora_tolerance(dtype, y, delta)
                err = check_close(got, want, what=f"lora {form} t={t} "
                                  f"{dtype}", **tol)
                ybuf = y.clone()
                bound, by = lora_bound(x, y, lp, r)
                rows.append(dict(
                    form=form, rows=8, tokens=t, din=x.shape[-1],
                    out=y[0, 0].numel(), slots=lp["a"].shape[0],
                    y_row_stride=y.stride(1), dtype=str(dtype).replace(
                        "torch.", ""), max_abs_err=err, **tol,
                    ms=time_ms(lambda: lk.lora_delta_add(ybuf, x, lp, r),
                               flush),
                    plain_ms=time_ms(lambda: plain(y, x, lp, r), flush),
                    bound_ms=bound, bound_by=by,
                    host_us=host_us(lambda: lk.lora_delta_add(ybuf, x, lp,
                                                              r)),
                    plain_host_us=host_us(lambda: plain(y, x, lp, r)),
                ))
                if (form, t, dtype) == ("gpt2 c_proj", 1, torch.bfloat16):
                    main = rows[-1]
    emit(phase="lora_kernel", cases=rows)
    return dict(rows=rows, main=main)


def _drive_groups(make, params, reqs, groups) -> dict:
    """Each group's requests served alone on a fresh engine: tokens by
    request index."""
    out = {}
    for keep in groups:
        eng = make()
        eng.warmup(params)
        run = drive_engine(eng, params, [reqs[i] for i in keep])
        out.update(zip(keep, run["tokens"]))
    return out


def lora_pins(pk, lk, cfg, params, reqs, reg, smi, phase, **engine_kw):
    """The LoRA main path at ``cfg``: a mixed-tenant drive on a warmed
    engine with K3 (K4 for int8 pages) and the LoRA kernel counted from
    zero, a tenant registered after the warmup (``compile_count`` flat),
    then each tenant's requests (and the untenanted ones) served alone and
    the untenanted requests on an adapter-less engine. Gates: every row
    equal to its isolated run, untenanted rows equal to the base engine,
    some tenant row differs from the base, the paged kernel launched
    n_layer x decode ticks, the LoRA kernel 2 x n_layer per forward."""
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    def make(adapters=reg):
        return PagedBatchedDecodeEngine(
            cfg, slots=8, max_len=1024, page_size=16, prefill_chunk=64,
            adapters=adapters, **engine_kw)

    eng = make()
    warm = eng.warmup(params)
    reg.register("tenant-late", seed=7919, scale=LORA_SCALE)
    pk.launches = pk.launches_q8 = 0
    lk.launches = 0
    mixed = drive_engine(eng, params, reqs)
    kernel = "K4" if eng.kv_quant == "int8" else "K3"
    counts = {"K3": pk.launches, "K4": pk.launches_q8, "lora": lk.launches}
    ticks = eng.counters
    want = {"K3": 0, "K4": 0,
            "lora": 2 * cfg.n_layer * (ticks["decode_ticks"]
                                       + ticks["prefill_ticks"])}
    want[kernel] = cfg.n_layer * ticks["decode_ticks"]
    steady = eng.compile_count() - warm
    base_eng = make(adapters=None)
    base_eng.warmup(params)
    base = drive_engine(base_eng, params, [
        {k: v for k, v in r.items() if k != "tenant"} for r in reqs])
    tenants = sorted({r.get("tenant") for r in reqs}, key=str)
    groups = [[i for i, r in enumerate(reqs) if r.get("tenant") == tid]
              for tid in tenants]
    alone = _drive_groups(make, params, reqs, groups)
    got = mixed["tokens"]
    untenanted = [i for i, r in enumerate(reqs) if "tenant" not in r]
    equal_alone = sum(np.array_equal(got[i], alone[i])
                      for i in range(len(reqs)))
    equal_base = sum(np.array_equal(got[i], base["tokens"][i])
                     for i in untenanted)
    differ = sum(not np.array_equal(got[i], base["tokens"][i])
                 for i, r in enumerate(reqs) if "tenant" in r)
    row = dict(
        phase=phase, nvidia_smi=smi,
        model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}", dtype=cfg.dtype,
        kv_quant=eng.kv_quant, weight_quant=eng.weight_quant,
        tenants=len(reg.tenants()), rank=reg.rank, requests=len(reqs),
        rows_equal_isolated=f"{equal_alone}/{len(reqs)}",
        untenanted_equal_base=f"{equal_base}/{len(untenanted)}",
        tenant_rows_differing_from_base=differ,
        compile_count_steady=steady, launches=counts, want_launches=want,
        tok_per_s=mixed["metrics"]["generated_tok_per_s"],
        base_tok_per_s=base["metrics"]["generated_tok_per_s"],
        tok_per_s_ratio=(mixed["metrics"]["generated_tok_per_s"]
                         / base["metrics"]["generated_tok_per_s"]),
        mean_decode_tick_ms=mixed["metrics"]["mean_decode_tick_ms"],
        base_mean_decode_tick_ms=base["metrics"]["mean_decode_tick_ms"],
    )
    emit(**row)
    if (equal_alone != len(reqs) or equal_base != len(untenanted)
            or not differ or steady or counts != want):
        raise AssertionError(f"{phase}: {row}")
    return row


def lora_phase(pk, lk, seed, dev, smi) -> dict:
    """GPT-2 124M at full width with 4 tenants at rank 8 (``lora_pins``),
    ``LORA_REQUESTS`` requests, in f32 and bf16; then Llama-3.2-1B with int8 pages and
    weights (K4), 8 requests."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama

    out = {}
    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        out[f"lora_{dtype}"] = lora_pins(
            pk, lk, c, params, lora_requests(c, seed), lora_registry(c, seed),
            smi, f"lora_{dtype}")
    del params
    cfg = model_config("llama3-1b")
    params = llama.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    out["lora_llama_q8"] = lora_pins(
        pk, lk, cfg, params, lora_requests(cfg, seed, n=8),
        lora_registry(cfg, seed), smi, "lora_llama_q8", **Q8)
    return out


def lora_http_phase(pk, lk, seed, smi) -> dict:
    """``serve --tenants 2``: ``serving.serve``'s own ``build``, 2 paged
    GPT-2 124M bf16 replicas x 4 slots, max_len 1024, on 127.0.0.1 port
    0. An SSE stream with ``"tenant": "tenant-1"`` ends DONE with its 32
    tokens, through K3 and the LoRA kernel; an unregistered tenant is a
    400 naming it."""
    from pytorch_distributed_tpu_torch.serving import serve

    args = serve.parse_args([
        "--preset", "gpt2", "--replicas", "2", "--slots", "4",
        "--max-len", "1024", "--host", "127.0.0.1", "--port", "0",
        "--tenants", "2", "--seed", str(seed)])
    cfg, params, router, server = serve.build(args)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 48).tolist()
    pk.launches = pk.launches_q8 = 0
    lk.launches = 0
    with serve.serve_in_thread(server) as (host, port):
        tokens, done, ttft, latency = _sse_stream(
            host, port, dict(prompt=prompt, max_new_tokens=32,
                             tenant="tenant-1"))
        status, _, err = _http_json(
            host, port, "POST", "/v1/generate",
            dict(prompt=prompt, max_new_tokens=4, tenant="tenant-9"))
    launches = {"K3": pk.launches, "K4": pk.launches_q8,
                "lora": lk.launches}
    row = dict(phase="lora_http", nvidia_smi=smi, model="gpt2 L12 E768",
               dtype=cfg.dtype, replicas=2, tenants=list(
                   router.engines()[0].adapters.tenants()),
               stream_tokens=len(tokens), done_state=done and done["state"],
               first_token_s=ttft, request_s=latency,
               unregistered=dict(status=status, error=err.get("error")),
               launches=launches)
    emit(**row)
    if (done is None or done["state"] != "DONE" or len(tokens) != 32
            or status != 400 or "unregistered tenant" not in err["error"]
            or not launches["K3"] or not launches["lora"]):
        raise AssertionError(f"lora_http: {row}")
    return row


def disagg_fleets(cfg, **engine_kw):
    """A colocated fleet and a prefill + decode fleet of two paged
    engines each (8 slots, max_len 384, 16-token pages, 32-token chunks),
    both on the card, admission effectively unbounded (the decode_bench
    twin's ``--serving-disagg`` fleets)."""
    from pytorch_distributed_tpu_torch.serving import (
        PagedBatchedDecodeEngine,
        ReplicaRouter,
    )

    def fleet(roles):
        return ReplicaRouter(
            lambda i: PagedBatchedDecodeEngine(
                cfg, slots=8, max_len=384, page_size=16, prefill_chunk=32,
                role=roles[i], **engine_kw),
            2, shed_queue_depth=10**6)

    return fleet(("colocated", "colocated")), fleet(("prefill", "decode"))


def disagg_pair(pk, cfg, params, n, seed, smi, phase, **engine_kw) -> dict:
    """Both fleets on one ``workload.disagg_stream`` of ``n`` requests (the
    JAX bench's default mix) under one Poisson arrival schedule drawn as
    the twin draws it (calibrated on one request). Gates: DONE tokens equal
    request for request, every request handed off, the ``kv_handoff``
    events' useful bytes equal to their pages x the bytes per page, the
    decode worker's paged kernel (K4 for int8 pages) launched n_layer x its
    decode ticks, no steady ``compile_count`` growth. Reports the
    handoffs' export and end-to-end latency and the interactive p99 ratio
    (both fleets share this one card: a handoff is a copy inside it)."""
    from pytorch_distributed_tpu_torch.serving import decode_bench
    from pytorch_distributed_tpu_torch.serving.engine import (
        kv_bytes_per_position,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        disagg_stream,
        exponential_arrivals,
    )

    stream = disagg_stream(seed, n=n, vocab_size=cfg.vocab_size)
    kinds = [r.pop("kind") for r in stream]
    colocated, disagg = disagg_fleets(cfg, **engine_kw)
    colocated.warmup(params)
    disagg.warmup(params)
    t0 = time.perf_counter()
    probe = colocated.submit(**stream[0])
    colocated.run(params)
    colocated.pop_result(probe)
    arrivals = exponential_arrivals(np.random.default_rng(seed + 7), n,
                                    (time.perf_counter() - t0) / 16)
    c_span, c_lat, c_res = decode_bench._drive_router(
        colocated, params, stream, arrivals)
    pk.launches = pk.launches_q8 = 0
    with decode_bench._HandoffTap() as tap:
        d_span, d_lat, d_res = decode_bench._drive_router(
            disagg, params, stream, arrivals)
    torch.cuda.synchronize()
    dec = disagg.engines()[1]
    q8 = dec.kv_quant == "int8"
    got = {"K3": pk.launches, "K4": pk.launches_q8}
    want = {"K3": 0, "K4": 0}
    want["K4" if q8 else "K3"] = cfg.n_layer * dec.counters["decode_ticks"]
    per_page = 16 * kv_bytes_per_position(cfg, dec.kv_quant)
    pages = sum(int(e["pages"]) for e in tap.events)
    useful = sum(int(e["useful_bytes"]) for e in tap.events)
    export = [float(e["export_s"]) * 1e3 for e in tap.events]
    latency = [float(e["latency_s"]) * 1e3 for e in tap.events]
    equal = sum(np.array_equal(c_res[i].tokens, d_res[i].tokens)
                for i in range(n))
    light = [i for i, k in enumerate(kinds) if k == "light"]
    pct = decode_bench._pct
    p99 = [pct([lat[i] for i in light], 0.99) for lat in (c_lat, d_lat)]
    steady = {"colocated": colocated.steady_compiles(),
              "disagg": disagg.steady_compiles()}
    row = dict(
        phase=phase, nvidia_smi=smi,
        model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}", dtype=cfg.dtype,
        kv_quant=dec.kv_quant, requests=n,
        heavy_prefill=n - len(light), light=len(light),
        outputs_equal=f"{equal}/{n}", handoffs=disagg.counters["handoffs"],
        handoff_events=len(tap.events), pages=pages,
        bytes_per_page=per_page, useful_bytes=useful,
        wire_bytes=sum(int(e["bytes"]) for e in tap.events),
        export_ms_p50=pct(export, 0.5), export_ms_p99=pct(export, 0.99),
        handoff_latency_ms_p50=pct(latency, 0.5),
        handoff_latency_ms_p99=pct(latency, 0.99),
        colocated_interactive_p99_s=p99[0], disagg_interactive_p99_s=p99[1],
        interactive_p99_ratio=p99[1] / p99[0],
        colocated_span_s=c_span, disagg_span_s=d_span,
        placement="both fleets on one card",
        launches=got, want_launches=want, steady_compiles=steady,
        pool_ledger=[(e.pool.stats["handoff_pages_in"],
                      e.pool.stats["handoff_pages_out"])
                     for e in disagg.engines().values()],
    )
    emit(**row)
    if (equal != n or row["handoffs"] != n or len(tap.events) != n
            or useful != pages * per_page or got != want or not got[
                "K4" if q8 else "K3"]
            or any(v for legs in steady.values() for v in legs.values())):
        raise AssertionError(f"{phase}: {row}")
    return dict(row, tokens=[c_res[i].tokens for i in range(n)],
                stream=stream)


def disagg_fault_leg(cfg, params, stream, clean, which, smi) -> dict:
    """The f32 fleet with all of ``stream`` submitted at once: the PREFILL
    worker killed as soon as it holds a parked, finished prefill (the
    decode worker cannot adopt its rows: they wait as orphans until the
    restart), or the DECODE worker killed once it has decoded (its rows
    come back as resume entries, re-prefilled on the prefill side and
    handed off again). Gates: every request DONE, no steady compiles, and
    each output equal to the clean leg's, or — for at most 1 in 16 — equal
    up to the token where it failed over (``tier_legs``' gate): a resumed
    row's generated tokens get their K/V from a prefill chunk, whose GEMMs
    have another shape than the decode tick's, so on the card a near-tie
    may round the other way (the failover_paths phase); on the CPU the
    fault legs are exact (tests/test_torch_disagg.py)."""
    _, fleet = disagg_fleets(cfg)
    fleet.warmup(params)
    rids = [fleet.submit(**r) for r in stream]
    pre, dec = fleet.engines()[0], fleet.engines()[1]
    for tick in range(10_000):
        fleet.step(params)
        if which == "prefill" and pre.handoff_ready():
            break
        if which == "decode" and dec.counters["decode_ticks"] >= 3:
            break
    rep = 0 if which == "prefill" else 1
    fleet.kill(rep, reason=f"chaos: {which} worker death")
    orphans = fleet.stats()["orphans"]
    fleet.restart(rep, params)
    fleet.run(params)
    points = {rid: min(fleet.failover_points.get(rid, [10**9]))
              for rid in rids}
    got = [fleet.pop_result(r) for r in rids]
    equal = sum(np.array_equal(g.tokens, c) for g, c in zip(got, clean))
    late = [i for i, (g, c, r) in enumerate(zip(got, clean, stream))
            if not np.array_equal(g.tokens, c) and np.array_equal(
                g.tokens[:len(r["prompt"]) + points[rids[i]]],
                c[:len(r["prompt"]) + points[rids[i]]])
            and points[rids[i]] < 10**9]
    row = dict(phase=f"disagg_fault_{which}", nvidia_smi=smi,
               killed_at_tick=tick + 1, orphans_after_kill=orphans,
               states=sorted({g.state for g in got}),
               outputs_equal_clean=f"{equal}/{len(clean)}",
               differing_after_failover_token=late,
               failovers=fleet.counters["failovers"],
               failover_requests=fleet.counters["failover_requests"],
               handoffs=fleet.counters["handoffs"],
               steady_compiles=fleet.steady_compiles())
    emit(**row)
    if (equal + len(late) != len(clean) or len(late) > len(clean) // 16
            or row["states"] != ["DONE"]
            or any(row["steady_compiles"].values())):
        raise AssertionError(f"disagg_fault_{which}: {row}")
    return row


def disagg_phase(pk, seed, dev, smi) -> dict:
    """GPT-2 124M in f32 and bf16 (``disagg_pair``, 48 requests), the
    int8 Llama-3.2-1B pair (16 requests, K4 on the decode worker), then
    the two f32 fault legs."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama

    out = {}
    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    for dtype in ("float32", "bfloat16"):
        out[f"disagg_{dtype}"] = disagg_pair(
            pk, cfg.replace(dtype=dtype), params, 48, seed, smi,
            f"disagg_{dtype}")
    f32 = out["disagg_float32"]
    for which in ("prefill", "decode"):
        out[f"disagg_fault_{which}"] = disagg_fault_leg(
            cfg.replace(dtype="float32"), params, f32["stream"],
            f32["tokens"], which, smi)
    del params
    lcfg = model_config("llama3-1b")
    lparams = llama.init(torch.Generator(device=dev).manual_seed(seed), lcfg,
                         device=dev)
    out["disagg_llama_q8"] = disagg_pair(pk, lcfg, lparams, 16, seed, smi,
                                         "disagg_llama_q8", **Q8)
    for row in out.values():
        row.pop("tokens", None)
        row.pop("stream", None)
    return out


def pmesh():
    """The port's launcher (``parallel/mesh``): every child process of
    this script starts through it, in a process group of its own that is
    killed on a timeout, an error or this script's end."""
    from pytorch_distributed_tpu_torch.parallel import mesh

    return mesh


def decode_bench_twin_phase(smi) -> dict:
    """The ``decode_bench`` twin's entry point at its default shapes:
    ``--serving-disagg --serving-scenarios`` in a subprocess, exit code 0
    (each leg exits nonzero on a breached invariant); its rows' headline
    numbers, and ``launches``: the K3, K4 and LoRA kernel launches its
    legs counted in that process (each leg row carries its own), which
    must include K3 and the LoRA kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/rows.json"
        t0 = time.perf_counter()
        proc = pmesh().run(
            [sys.executable, "-m",
             "pytorch_distributed_tpu_torch.serving.decode_bench",
             "--serving-disagg", "--serving-scenarios", "--json", out],
            timeout=phase_timeout(900, "decode_bench_twin"))
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(
                f"decode_bench twin exited {proc.returncode}: "
                f"{proc.stdout[-4000:]}")
        with open(out) as f:
            rows = json.load(f)
    keep = ("outputs_match", "interactive_p99_ratio", "handoffs",
            "observed_compile_count_steady", "turn_prefill_hit_rate",
            "turns_bit_equal_oneshot", "rows_bit_equal_isolated",
            "aggregate_tokens_per_sec_ratio", "tokens_per_sec_4_tenant",
            "tokens_per_sec_base", "colocated", "disagg",
            "interactive_p99_ms_unloaded", "interactive_p99_ms_loaded",
            "interactive_p99_ratio_rounds",
            "interactive_p99_ratio_single_pass",
            "aggregate_tokens_per_sec_ratio_pairs",
            "aggregate_tokens_per_sec_ratio_single_pass", "launches")
    launches = {k: sum(r["launches"][k] for r in rows)
                for k in ("K3", "K4", "lora")}
    row = dict(phase="decode_bench_twin", nvidia_smi=smi, wall_s=wall,
               exit_code=proc.returncode, launches=launches,
               legs={r["leg"]: {k: r[k] for k in keep if k in r}
                     for r in rows})
    emit(**row)
    check_survivors("decode_bench_twin")
    if not (launches["K3"] and launches["lora"]):
        raise AssertionError(f"decode_bench twin: {launches}")
    return row


FLASH_SOURCE = "pytorch_distributed_tpu_torch/csrc/flash_attention.cu"


def flash_bound(q, k, causal: bool, backward: bool) -> tuple[float, str]:
    """Least time for flash attention on these inputs: each input read and
    each output written once over the HBM rate (forward: q, k, v in, o and
    lse out; backward: q, k, v, o, do and lse in, dq, dk, dv out), or its
    products over the peak rate for the input type (forward: QK^T and PV;
    backward: the five products of the fused backward), counted over the
    (query, key) pairs the mask keeps — whichever is larger."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    item = q.element_size()
    pairs = t * (t + 1) // 2 if causal else t * t
    rows = b * h * t
    if backward:
        nbytes = (4 * b * h + 4 * b * hkv) * t * d * item + rows * 4
        ops = 10 * b * h * d * pairs
    else:
        nbytes = (2 * b * h + 2 * b * hkv) * t * d * item + rows * 4
        ops = 4 * b * h * d * pairs
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _head_chunks(q, k, chunks: int):
    """``chunks`` slices of the KV heads, each with its query-head group:
    (query-head slice, KV-head slice) pairs."""
    hk = k.shape[1] // chunks
    g = q.shape[1] // k.shape[1]
    return [(slice(i * hk * g, (i + 1) * hk * g), slice(i * hk, (i + 1) * hk))
            for i in range(chunks)]


def plain_forward(fk, q, k, v, causal, chunks: int = 1):
    """The plain version of K1, run on ``chunks`` groups of heads one after
    another (the f32 scores of all 32 heads at T=8192 would take 8.6 GB
    per tensor) and joined: the same values as one call."""
    parts = [fk.flash_forward_reference(q[:, hq], k[:, hk], v[:, hk], causal)
             for hq, hk in _head_chunks(q, k, chunks)]
    return torch.cat([o for o, _ in parts], 1), torch.cat(
        [lse for _, lse in parts], 1)


def plain_backward(fk, q, k, v, o, lse, do, causal, chunks: int = 1):
    """The plain version of K2 by groups of heads, as ``plain_forward``."""
    parts = [fk.flash_backward_reference(q[:, hq], k[:, hk], v[:, hk],
                                         o[:, hq], lse[:, hq], do[:, hq],
                                         causal)
             for hq, hk in _head_chunks(q, k, chunks)]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def check_flash(fk, q, k, v, do, causal, what, chunks: int = 1) -> dict:
    """K1 and K2 once each on the inputs against their plain versions
    (``FLASH_TOLERANCES``; bf16 also against the plain versions in f32 on
    the same values), the plain versions run on ``chunks`` groups of heads
    (``plain_forward``). Returns the largest differences per kernel."""
    tol = FLASH_TOLERANCES[q.dtype]
    o, lse = fk.flash_forward(q, k, v, causal)
    grads = fk.flash_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = plain_forward(fk, q, k, v, causal, chunks)
    k1 = dict(max_abs_err=check_close(o, o_ref, what=f"{what} K1 o",
                                      **tol["fwd"]),
              lse_max_abs_err=check_close(lse, lse_ref, what=f"{what} K1 lse",
                                          **LSE_TOL),
              **tol["fwd"])
    refs = plain_backward(fk, q, k, v, o, lse, do, causal, chunks)
    k2 = dict(max_abs_err=max(
        check_close(g, r, what=f"{what} K2 {n}", **tol["bwd"])
        for n, g, r in zip(("dq", "dk", "dv"), grads, refs)
    ), **tol["bwd"])
    del o_ref, refs
    if q.dtype == torch.bfloat16:
        f = [x.float() for x in (q, k, v)]
        o32, _ = plain_forward(fk, *f, causal, chunks)
        k1["max_abs_err_vs_f32_plain"] = check_close(
            o, o32, what=f"{what} K1 vs f32 plain", **flash_fwd_bf16_vs_f32(v)
        )
        del o32
        refs32 = plain_backward(fk, *f, o.float(), lse, do.float(), causal,
                                chunks)
        k2["max_abs_err_vs_f32_plain"] = max(
            check_close(g, r, what=f"{what} K2 {n} vs f32 plain",
                        **FLASH_BF16_VS_F32["bwd"])
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs32)
        )
    return dict(K1=k1, K2=k2)


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def lost_launches(trace: dict) -> list[dict]:
    """The launch calls of a Kineto trace (kernels, async copies and
    memsets) whose device row is missing: the host's ``cuda_runtime`` /
    ``cuda_driver`` rows whose correlation id matches no ``kernel``,
    ``gpu_memcpy`` or ``gpu_memset`` row."""
    events = trace.get("traceEvents", [])
    device = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    return [e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and e.get("name") in LAUNCH_CALLS
            and (e.get("args") or {}).get("correlation") not in device]


def device_kernels(fn, n: int = 3) -> dict:
    """Each device kernel that ``fn`` launches: the launches a
    ``torch.profiler`` window over ``n`` calls recorded (L2 warm, so a
    little below ``time_ms``), its launches per call, and its mean device
    ms per launch, from the window's Kineto trace
    (``trace_analysis.op_summary``), and ``lost_launches``: the launch
    calls of the window whose device row is missing. CUPTI drops the
    record of a window's first operation, and at times others near its
    edges (PERF.md section 7), so the calls are bracketed by a short spin
    kernel at each end, with the device drained and the host paused after
    each; what it still drops between the spins is counted, and the mean
    is taken over the launches recorded."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.profiling import trace_analysis as ta

    def guard(pause_s):
        torch.cuda._sleep(spin_cycles(0.05))
        torch.cuda.synchronize()
        time.sleep(pause_s)

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            guard(0.2)
            for _ in range(n):
                fn()
            guard(0.05)
        prof.export_chrome_trace(f"{tmp}/window.json")
        trace = ta.load_trace(f"{tmp}/window.json")
    launches = sorted((e for e in trace["traceEvents"]
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e.get("name") in LAUNCH_CALLS),
                      key=lambda e: e["ts"])
    guards = (launches[0], launches[-1])
    lost = [e for e in lost_launches(trace)
            if not any(e is g for g in guards)]
    kernels = {name: dict(launches=r["count"],
                          launches_per_call=r["count"] / n,
                          ms_per_launch=r["mean_us"] / 1e3)
               for name, r in ta.op_summary(trace).items()
               if "spin_kernel" not in name}
    return dict(kernels=kernels, lost_launches=len(lost))


def sdpa_backend(q, k, v, causal: bool, gqa: bool) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (flash, efficient, cudnn or math): its fused kernels do not all show in
    a profiler trace."""
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                         enable_gqa=gqa)
    except (AttributeError, RuntimeError, TypeError) as exc:
        return f"unknown ({type(exc).__name__})"
    return SDPBackend(choice).name


def _breakdown(kernel_fn, library_fn) -> dict:
    """``device_kernels`` of a wrapper call and of its library call."""
    mine, lib = device_kernels(kernel_fn), device_kernels(library_fn)
    return dict(kernels_ms=mine["kernels"],
                kernels_lost_launches=mine["lost_launches"],
                library_kernels=lib["kernels"],
                library_lost_launches=lib["lost_launches"])


def time_flash(fk, q, k, v, do, causal, flush, chunks: int = 1) -> dict:
    """Kernel, plain-version and library times of K1 and K2 on the inputs
    (ms, CUDA events, L2 flushed before each launch). The library call is
    ``scaled_dot_product_attention`` (forward; its backward through
    autograd): a yardstick the port never calls. ``kernels_ms`` and
    ``library_kernels`` break both down by device kernel (one profiler
    window each, ``device_kernels``, with the launches its trace lost);
    ``library_backend`` is the SDPA backend that was timed."""
    import torch.nn.functional as F

    o, lse = fk.flash_forward(q, k, v, causal)
    gqa = q.shape[1] != k.shape[1]
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                           enable_gqa=gqa)

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=gqa)

    def lib_bwd():
        return torch.autograd.grad(lib_o, (lq, lk, lv), do,
                                   retain_graph=True)

    out = dict(
        K1=dict(
            ms=time_ms(lambda: fk.flash_forward(q, k, v, causal), flush),
            plain_ms=time_ms(
                lambda: plain_forward(fk, q, k, v, causal, chunks), flush,
                n=5),
            library_ms=time_ms(lib_fwd, flush),
            **_breakdown(lambda: fk.flash_forward(q, k, v, causal),
                         lib_fwd),
            library_backend=sdpa_backend(q, k, v, causal, gqa),
        ),
        K2=dict(
            ms=time_ms(lambda: fk.flash_backward(q, k, v, o, lse, do, causal),
                       flush),
            plain_ms=time_ms(lambda: plain_backward(
                fk, q, k, v, o, lse, do, causal, chunks), flush, n=5),
            library_ms=time_ms(lib_bwd, flush),
            **_breakdown(
                lambda: fk.flash_backward(q, k, v, o, lse, do, causal),
                lib_bwd),
        ),
    )
    for name, backward in (("K1", False), ("K2", True)):
        out[name]["bound_ms"], out[name]["bound_by"] = flash_bound(
            q, k, causal, backward
        )
    return out


# K1/K2 at a tensor-2 rank's local heads, as the tp_train legs run them
# (bf16): GPT-2 124M's 6 of 12 heads at T 1024; Llama-3.2-1B's 16 of 32
# query heads over 4 of 8 KV heads (group 4) at T 4096.
TP_FLASH_SHAPES = (
    ("gpt2-124M-tp2", 8, 6, 6, 1024, 64),
    ("llama3.2-1B-tp2", 1, 16, 4, 4096, 64),
)
# K1/K2 at a seq-2 Ulysses rank's heads over the whole sequence (phase
# 17c): Llama-3.2-1B at T 8192. GPT-2's is "gpt2-124M-tp2".
SEQ_FLASH_SHAPES = (
    ("llama3.2-1B-ulysses2", 1, 16, 4, 8192, 64),
)
# The kernels line's ``seq_local_shapes``: each Ulysses leg's K1/K2 shape
# and the flash phase's row that holds it.
SEQ_LOCAL_SHAPES = {"gpt2-124M-ulysses2": "gpt2-124M-tp2",
                    "llama3.2-1B-ulysses2": "llama3.2-1B-ulysses2"}


def flash_phase(fk, dev, flush, seed) -> dict:
    """K1 and K2 against their plain versions at the listed shapes in f32
    and bf16, then at ``TP_FLASH_SHAPES`` and ``SEQ_FLASH_SHAPES`` in bf16
    (plain versions by KV head past T 2048), with kernel, plain, bound and
    SDPA times. Returns those shapes' rows by shape and kernel."""
    shapes = [
        ("gpt2-124M", 8, 12, 12, 1024, 64, True),
        ("llama3.2-1B", 1, 32, 8, 2048, 64, True),
        ("head_dim-128 ragged non-causal", 2, 16, 4, 1000, 128, False),
    ]
    cases = [(name, b, h, hkv, t, d, causal, dtype, 1)
             for name, b, h, hkv, t, d, causal in shapes
             for dtype in FLASH_TOLERANCES]
    cases += [(name, b, h, hkv, t, d, True, torch.bfloat16,
               hkv if t > 2048 else 1)
              for name, b, h, hkv, t, d in TP_FLASH_SHAPES
              + SEQ_FLASH_SHAPES]
    tp_rows = {}
    for name, b, h, hkv, t, d, causal, dtype, chunks in cases:
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (
            torch.randn(b, n, t, d, generator=g, device=dev).to(dtype)
            for n in (h, hkv, hkv, h)
        )
        checked = check_flash(fk, q, k, v, do, causal, f"{name} {dtype}",
                              chunks=chunks)
        timed = time_flash(fk, q, k, v, do, causal, flush, chunks=chunks)
        row = {kn: {**checked[kn], **timed[kn]} for kn in ("K1", "K2")}
        emit(phase="flash", shape=name, B=b, H=h, Hkv=hkv, T=t, D=d,
             causal=causal, dtype=str(dtype).replace("torch.", ""), **row)
        if name.endswith(("-tp2", "-ulysses2")):
            tp_rows[name] = dict(B=b, H=h, Hkv=hkv, T=t, D=d,
                                 dtype="bfloat16", **row)
        del q, k, v, do
    return tp_rows


def train_setup(cfg, tcfg, b, t, seed, dev, draw_on="cpu"):
    """Params from ``--seed`` (the family's ``init``, drawn by a generator
    on ``draw_on``: the host for GPT-2, the card for a Llama-3.2-1B
    width), the optimizer, the train state and step, and one fixed batch
    of random token ids."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step

    model = get_model(cfg)
    params = model.init(torch.Generator(device=draw_on).manual_seed(seed),
                        cfg, device=dev)
    tx = make_optimizer(tcfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {key: torch.randint(0, cfg.vocab_size, (1, b, t), generator=g,
                                device=dev)
             for key in ("inputs", "targets")}
    return (init_train_state(params, tx),
            make_train_step(model, cfg, tx, seed=seed), batch)


def train_phase(fk, cfg, seed, dev, warmup=3, windows=3, window_steps=10):
    """The main path (see the module docstring). Returns the step, its
    state and batch, the launches, and layer 0's flash inputs at the last
    warmup step."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.utils import tree

    b, t = 8, 1024
    n_steps = warmup + windows * window_steps
    tcfg = TrainConfig(global_batch_size=b, micro_batch_size=b,
                       num_steps=n_steps, learning_rate=3e-4)
    state, step, batch = train_setup(cfg, tcfg, b, t, seed, dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * t
    captured = {}
    original = fk.flash_backward

    def record(*args):
        # Layer 0's backward is the last of a step: keep the last warmup
        # step's (q, k, v, o, lse, do, ...) as device copies.
        record.calls += 1
        if record.calls == cfg.n_layer * warmup:
            captured["args"] = [a.clone() if torch.is_tensor(a) else a
                                for a in args]
        return original(*args)

    record.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)  # counts from zero for this drive
    fk.flash_backward = record
    try:
        losses = []
        for _ in range(warmup):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    finally:
        fk.flash_backward = original
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "num_sync_all_streams")
    alloc0 = torch.cuda.memory_stats()
    rows = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(window_steps):
            state, m = step(state, batch)
        loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
        elapsed = time.perf_counter() - t0
        tok_s = window_steps * b * t / elapsed
        rows.append(dict(tokens_per_s=tok_s,
                         ms_per_step=elapsed / window_steps * 1e3,
                         mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
                         loss=loss, grad_norm=grad_norm))
    launches = dict(fk.launches)
    peak = torch.cuda.max_memory_allocated()
    alloc1 = torch.cuda.memory_stats()
    allocator = {key: alloc1.get(key, 0) - alloc0.get(key, 0)
                 for key in alloc_keys}
    want = cfg.n_layer * n_steps
    emit(phase="train", B=b, T=t, steps=n_steps, n_params=n_params,
         flops_per_token=flops_per_token, warmup_losses=losses,
         windows=rows, launches=launches, want_launches=want,
         max_memory_allocated=peak, allocator_during_windows=allocator)
    if not launches["forward"] or not launches["backward"]:
        raise AssertionError(f"the training main path launched no flash "
                             f"kernel: {launches}")
    if launches != {"forward": want, "backward": want}:
        raise AssertionError(
            f"flash launches {launches} != n_layer x steps = {want}: the "
            f"training path did not go through the kernels"
        )
    final = rows[-1]["loss"]
    if not all(np.isfinite([*losses, *(r["loss"] for r in rows)])) or \
            not final < losses[0]:
        raise AssertionError(
            f"the loss did not fall on the fixed batch: {losses[0]} -> {final}"
        )
    return dict(step=step, state=state, batch=batch, launches=launches,
                captured=captured["args"])


# K1 launches per layer and step under each remat mode: the JAX package's
# grad has 3 pallas_calls under full, dots and dots_no_batch (the flash
# forward re-runs in backward: it is no dot to checkpoint_dots), 2 under
# none, names and flash (tests/test_torch_remat_modes.py).
K1_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "dots_no_batch": 2,
                "names": 1, "flash": 1}


def train_remat_phase(fk, cfg, seed, dev, warmup=2, steps=10) -> None:
    """The main path's step under every other remat mode beside "names"
    (train phase): ms/step, peak memory, and the flash launches of the
    timed steps — K1 ``K1_PER_LAYER`` x n_layer x steps, K2 n_layer x
    steps."""
    from pytorch_distributed_tpu_torch.config import TrainConfig

    for mode in ("none", "full", "dots", "dots_no_batch", "flash"):
        c = cfg.replace(remat=mode)
        tcfg = TrainConfig(global_batch_size=8, micro_batch_size=8,
                           num_steps=warmup + steps, learning_rate=3e-4)
        state, step, batch = train_setup(c, tcfg, 8, 1024, seed, dev)
        for _ in range(warmup):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        loss = float(m["loss"])
        elapsed = time.perf_counter() - t0
        launches = dict(fk.launches)
        want = {"forward": cfg.n_layer * steps * K1_PER_LAYER[mode],
                "backward": cfg.n_layer * steps}
        emit(phase="train_remat", remat=mode, steps=steps,
             ms_per_step=elapsed / steps * 1e3,
             tokens_per_s=steps * 8 * 1024 / elapsed, loss=loss,
             launches=launches, want_launches=want,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        if launches != want:
            raise AssertionError(
                f"remat {mode}: flash launches {launches} != {want}"
            )
        del state, step, batch


def train_parity_phase(cfg, seed, dev, b=2, t=1024, draw_on="cpu",
                       phase="train_parity") -> None:
    """One f32 step at full width (B=2, T=1024) with the flash kernels and
    with naive attention, from the same weights and batch. Loss within rtol
    1e-5 and grad_norm within rtol 1e-4 (summation order). Adam's first
    update is lr * g / (|g| + eps) per element, about lr * sign(g): where a
    gradient is ~0 the two runs can take opposite signs and differ by up to
    2 lr. So params are held to 2 lr + 1e-6 everywhere, and to 1e-6 on all
    but 1e-4 of the elements."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.utils import tree

    tcfg = TrainConfig(learning_rate=3e-4)
    out = {}
    for impl in ("flash", "naive"):
        c = cfg.replace(dtype="float32", logits_dtype="float32",
                        param_dtype="float32", attention_impl=impl)
        state, step, batch = train_setup(c, tcfg, b, t, seed, dev, draw_on)
        state, m = step(state, batch)
        out[impl] = (float(m["loss"]), float(m["grad_norm"]),
                     tree.leaves(state.params))
        del state, step
    (lf, gf, pf), (ln, gn, pn) = out["flash"], out["naive"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pf, pn)])
    lr = tcfg.learning_rate
    res = dict(loss=[lf, ln], grad_norm=[gf, gn],
               params_max_abs_diff=float(diffs.max()),
               params_share_above_1e_6=float((diffs > 1e-6).float().mean()),
               n_params=diffs.numel())
    emit(phase=phase, B=b, T=t, **res)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(gf - gn) <= 1e-4 * gn
            and res["params_max_abs_diff"] <= 2 * lr + 1e-6
            and res["params_share_above_1e_6"] <= 1e-4):
        raise AssertionError(f"flash and naive f32 steps disagree: {res}")


def train_profile_phase(run, n_steps: int = 2,
                        phase: str = "train_profile",
                        share_of: str | None = None) -> dict:
    """``torch.profiler`` over ``n_steps`` steps of ``run`` (its step,
    state and batch), then one step in CUDA's sync debug mode: the host
    syncs a step makes. ``share_of``: a regex of kernel names whose share
    of the device time is reported (``matched_share``)."""
    from torch.profiler import ProfilerActivity, profile

    step, state, batch = run["step"], run["state"], run["batch"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # One more step with CUDA's sync debug mode on: the host syncs that
    # the step makes (each stalls the host until the device drains).
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0][:120] for w in caught
             if "prototype feature" not in str(w.message)]
    summary = profile_summary(prof, wall_ms, share_of)
    emit(phase=phase, steps=n_steps,
         host_syncs_per_step=len(syncs), host_sync_kinds=sorted(set(syncs)),
         **summary)
    return summary


def train_loop_phase(fk, seed, tmp) -> None:
    """The training entry point's path (``python -m
    pytorch_distributed_tpu_torch.train.baseline``), in process through the
    functions its ``main`` uses: GPT-2 124M with the preset's dropout 0.1
    (so training attention runs the naive path and launches no flash
    kernel), bf16, flash + names, synthetic shards, global batch 32 of
    micro-batches 8 (A = 4), T 1024, 8 steps, a checkpoint every 4, the
    loss logged every 2. Then a fresh ``Trainer`` resumes the step-4
    checkpoint (the step-8 one parked, as if the run had died after step
    4) and runs steps 5-8 again: its window losses must equal the
    uninterrupted run's bit for bit. The loss must fall. Then ``evaluate``
    over 4 validation batches: K1 exactly n_layer x 4 launches, K2 none.
    Then a profile of one loop step."""
    import shutil

    from pytorch_distributed_tpu_torch.data import TokenShardLoader
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train import baseline
    from pytorch_distributed_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_tpu_torch.utils import tree

    args = baseline.parse_args([
        "--preset", "gpt2", "--global-batch-size", "32",
        "--micro-batch-size", "8", "--seq-len", "1024", "--steps", "8",
        "--save-every", "4", "--log-every", "2", "--eval-batches", "4",
        "--num-train-files", "2", "--seed", str(seed),
        "--data-dir", f"{tmp}/data", "--checkpoint-dir", f"{tmp}/ck",
    ])
    model_cfg = baseline.build_model_cfg(args)
    train_cfg = baseline.build_train_cfg(args)
    paths = baseline.shard_paths(args, model_cfg.vocab_size)
    b, t = args.micro_batch_size, args.seq_len

    def run(resume: bool):
        loader = TokenShardLoader(paths, b, t)
        trainer = Trainer(get_model(model_cfg), model_cfg, train_cfg,
                          device=args.device, log_fn=lambda line: None)
        state = trainer.init_state()
        if resume:
            state = trainer.resume_latest(state, loader=loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches.update(forward=0, backward=0)
        state, hist = trainer.train(loader, state=state)
        return trainer, state, hist, dict(fk.launches)

    t0 = time.perf_counter()
    trainer, state, hist, launches = run(resume=False)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * model_cfg.n_layer * \
        model_cfg.n_embd * t
    tokens = train_cfg.global_batch_size * t
    # Window 1 holds the first step's allocations, and a window after a
    # checkpoint its synchronous save: the others are steady.
    steady = [(hist[i]["elapsed_s"] - hist[i - 1]["elapsed_s"]) /
              (hist[i]["step"] - hist[i - 1]["step"])
              for i in range(1, len(hist))
              if hist[i - 1]["step"] % train_cfg.save_every_n_steps]
    ms_step = statistics.median(steady) * 1e3
    tok_s = tokens / (ms_step / 1e3)
    shutil.move(f"{tmp}/ck/checkpoint_step_8", f"{tmp}/parked_step_8")
    _, rstate, rhist, rlaunches = run(resume=True)
    resumed = [h["loss"] for h in rhist]
    uninterrupted = [h["loss"] for h in hist if h["step"] > 4]
    val_loader = TokenShardLoader(
        baseline.val_shard_paths(args, model_cfg.vocab_size), b, t)
    fk.launches.update(forward=0, backward=0)
    val_loss = trainer.evaluate(state, val_loader,
                                max_batches=args.eval_batches)
    eval_launches = dict(fk.launches)
    want_eval = {"forward": model_cfg.n_layer * args.eval_batches,
                 "backward": 0}
    emit(phase="train_loop", preset=args.preset, A=trainer.accum, B=b, T=t,
         steps=train_cfg.num_steps, remat=model_cfg.remat,
         attention_impl=model_cfg.attention_impl,
         pdrop=model_cfg.attn_pdrop, dtype=model_cfg.dtype,
         ms_per_step=ms_step, ms_per_step_windows=[x * 1e3 for x in steady],
         tokens_per_s=tok_s, mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
         flops_per_token=flops_per_token, max_memory_allocated=peak,
         window_losses=[h["loss"] for h in hist], resumed_from_step=4,
         resumed_window_losses=resumed,
         resumed_bitwise=resumed == uninterrupted,
         resumed_max_rel_diff=max(abs(a - c) / abs(c) for a, c in
                                  zip(resumed, uninterrupted)),
         train_launches=launches, resumed_train_launches=rlaunches,
         val_loss=val_loss, eval_launches=eval_launches,
         want_eval_launches=want_eval,
         wall_s=time.perf_counter() - t0)
    if rstate.step != 8 or len(resumed) != len(uninterrupted):
        raise AssertionError(f"the resumed run ended at step {rstate.step} "
                             f"with windows {resumed}")
    if resumed != uninterrupted:
        raise AssertionError(
            f"resumed window losses {resumed} != the uninterrupted run's "
            f"{uninterrupted}: the resumed steps are not bit for bit")
    losses = [h["loss"] for h in hist]
    if not (np.isfinite([*losses, val_loss]).all() and losses[-1] <
            losses[0]):
        raise AssertionError(f"the loop's loss did not fall: {losses}")
    if launches != {"forward": 0, "backward": 0}:
        raise AssertionError(
            f"training with attn_pdrop > 0 launched flash kernels "
            f"{launches}: it must take the naive path")
    if eval_launches != want_eval:
        raise AssertionError(f"eval launched {eval_launches}, want "
                             f"{want_eval}")
    group = next(trainer._grouped_batches(TokenShardLoader(paths, b, t)))
    train_profile_phase(dict(step=trainer.train_step, state=state,
                             batch=trainer.put_batch(group)), n_steps=1,
                        phase="train_loop_profile")


def _dropout_grads(cfg, params, batch, key):
    """Loss and gradients of one forward (training mode with ``key`` the
    dropout stream; ``key`` None: deterministic) with a fresh copy of
    ``params``' leaves."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.trainer import _loss
    from pytorch_distributed_tpu_torch.utils import tree

    leaves = [p.detach().clone().requires_grad_()
              for p in tree.leaves(params)]
    loss = _loss(get_model(cfg), cfg, tree.unflatten(params, leaves),
                 batch["inputs"][0], batch["targets"][0],
                 deterministic=key is None, key=key)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_dropout_phase(cfg, seed, dev) -> None:
    """Dropout at full width (GPT-2 124M, every *_pdrop 0.1). (1) Two steps
    of A = 2 micro-batches of [4, 1024], bf16, names: every mask recorded
    through the seam; each site's keep fraction (embedding, attention,
    residual) within 5 standard errors of 0.9; the masks of two layers,
    two steps and two micro-batches differ. (2) One f32 forward and
    backward ([2, 1024]) under each remat mode: every gradient equals mode
    none's within 1e-5 of that leaf's largest (the recompute draws the
    same masks; measured bit-equal)."""
    from pytorch_distributed_tpu_torch.models import get_model, gpt2
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import prng

    draw = prng.draw_keep_mask
    kept, heads = {}, {}

    def record(sid, shape, keep, device):
        m = draw(sid, shape, keep, device)
        if sid not in heads:  # the recompute draws each block mask again
            site = "resid" if sid.site.startswith("resid") else sid.site
            n, k = kept.get(site, (0, 0))
            kept[site] = (n + m.numel(), k + int(m.sum()))
            heads[sid] = m.reshape(-1)[:1 << 20].clone()
        return m

    c = cfg.replace(remat="names")
    tx = make_optimizer(TrainConfig(learning_rate=3e-4))
    state = init_train_state(
        gpt2.init(torch.Generator().manual_seed(seed), c, device=dev), tx)
    step = make_train_step(get_model(c), c, tx, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    prng.draw_keep_mask = record
    try:
        for _ in range(2):
            batch = {k: torch.randint(0, c.vocab_size, (2, 4, 1024),
                                      generator=g, device=dev)
                     for k in ("inputs", "targets")}
            state, _ = step(state, batch)
    finally:
        prng.draw_keep_mask = draw
    fractions = {site: k / n for site, (n, k) in kept.items()}
    within = {site: abs(f - 0.9) / (0.09 / kept[site][0]) ** 0.5
              for site, f in fractions.items()}
    pairs = {
        "layers": (prng.StreamId(seed, 0, 0, 0, "attn"),
                   prng.StreamId(seed, 0, 0, 1, "attn")),
        "steps": (prng.StreamId(seed, 0, 0, 5, "resid_mlp"),
                  prng.StreamId(seed, 1, 0, 5, "resid_mlp")),
        "micro_batches": (prng.StreamId(seed, 1, 0, -1, "embd"),
                          prng.StreamId(seed, 1, 1, -1, "embd")),
    }
    differ = {name: not torch.equal(heads[a], heads[b])
              for name, (a, b) in pairs.items()}
    n_masks = len(heads)
    del state, step, heads

    f32 = cfg.replace(dtype="float32", logits_dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(seed), f32,
                       device=dev)
    batch = {k: torch.randint(0, f32.vocab_size, (1, 2, 1024), generator=g,
                              device=dev) for k in ("inputs", "targets")}
    key = prng.DropoutKey(seed, 0, 0)
    loss0, ref = _dropout_grads(f32.replace(remat="none"), params, batch,
                                key)
    modes = {}
    for mode in ("full", "dots", "dots_no_batch", "names", "flash"):
        loss, grads = _dropout_grads(f32.replace(remat=mode), params, batch,
                                     key)
        modes[mode] = dict(
            loss=float(loss), bitwise=all(torch.equal(a, b)
                                          for a, b in zip(grads, ref)),
            max_rel_diff=max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(grads, ref)))
        del grads
    emit(phase="train_dropout", keep_fractions=fractions,
         standard_errors_from_keep=within, masks_drawn=n_masks,
         masks_differ=differ, f32_loss_none=float(loss0), remat=modes)
    if any(x > 5 for x in within.values()) or set(within) != {
            "embd", "attn", "resid"}:
        raise AssertionError(f"keep fractions {fractions} ({within} "
                             f"standard errors from 0.9)")
    if not all(differ.values()):
        raise AssertionError(f"masks repeat: {differ}")
    bad = {m: r for m, r in modes.items() if r["max_rel_diff"] > 1e-5}
    if bad:
        raise AssertionError(f"gradients under remat modes differ from "
                             f"none's: {bad}")


def train_fused_ce_phase(cfg, seed, dev, warmup=2, steps=5) -> None:
    """The fused head + cross-entropy at full width (GPT-2 124M, bf16,
    vocab 50257, dropout 0.1, names, one micro-batch [8, 1024]) against
    the unfused step from the same weights and masks: loss within rtol
    1e-3, every gradient within 2e-2 of its norm (both round the block
    logits to bf16; the unfused head's dW is rounded to bf16 once more,
    and cuBLAS may sum in another order). Then ms/step, peak memory and a
    one-step profile of each; the fused step never holds the [8192, 50257]
    logits (823 MB in bf16, 1.65 GB as the f32 copy the loss reads)."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.models import get_model, gpt2
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import prng

    base = cfg.replace(remat="names", logits_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.randint(0, base.vocab_size, (1, 8, 1024), generator=g,
                              device=dev) for k in ("inputs", "targets")}
    params = gpt2.init(torch.Generator().manual_seed(seed), base,
                       device=dev)
    key = prng.DropoutKey(seed, 0, 0)
    out, rows = {}, {}
    for fused in (False, True):
        c = base.replace(fused_head_ce=fused)
        out[fused] = _dropout_grads(c, params, batch, key)
    (lu, gu), (lf, gf) = out[False], out[True]
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(gf, gu)]
    del out, gf, gu, params
    for fused in (False, True):
        c = base.replace(fused_head_ce=fused)
        tx = make_optimizer(TrainConfig(learning_rate=3e-4))
        state = init_train_state(
            gpt2.init(torch.Generator().manual_seed(seed), c, device=dev), tx)
        step = make_train_step(get_model(c), c, tx, seed=seed)
        for _ in range(warmup):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        loss = float(m["loss"])
        elapsed = time.perf_counter() - t0
        name = "fused" if fused else "unfused"
        rows[name] = dict(
            ms_per_step=elapsed / steps * 1e3, loss=loss,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        train_profile_phase(dict(step=step, state=state, batch=batch),
                            n_steps=1, phase=f"train_{name}_ce_profile")
        del state, step
    logits_bytes = 8 * 1024 * base.vocab_size * 2
    emit(phase="train_fused_ce", loss_unfused=float(lu),
         loss_fused=float(lf), grad_rel_l2_max=max(rel),
         grad_rel_l2_wte=rel[0], steps=rows,
         peak_saved_bytes=(rows["unfused"]["max_memory_allocated"]
                           - rows["fused"]["max_memory_allocated"]),
         bf16_logits_bytes=logits_bytes)
    if not (abs(float(lf) - float(lu)) <= 1e-3 * abs(float(lu))
            and max(rel) < 2e-2):
        raise AssertionError(
            f"fused CE {float(lf)} vs unfused {float(lu)}, gradient "
            f"relative L2 differences up to {max(rel)}")

# The long-context Llama-3.2-1B shapes (GQA group 4, head_dim 64, causal,
# bf16) the llama training phases give K1 and K2: bench_suite rows 6 and 7.
LLAMA_FLASH_SHAPES = ((1, 32, 8, 4096, 64), (1, 32, 8, 8192, 64))


def flash_long_phase(fk, dev, flush, seed) -> dict:
    """K1 and K2 at ``LLAMA_FLASH_SHAPES`` in bf16 against their plain
    versions (run by KV head: ``plain_forward``), with kernel, plain, bound
    and SDPA (``enable_gqa``) times. Returns the timings by T."""
    out = {}
    for b, h, hkv, t, d in LLAMA_FLASH_SHAPES:
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (
            torch.randn(b, n, t, d, generator=g, device=dev).to(
                torch.bfloat16) for n in (h, hkv, hkv, h)
        )
        checked = check_flash(fk, q, k, v, do, True, f"llama T={t} bf16",
                              chunks=hkv)
        timed = time_flash(fk, q, k, v, do, True, flush, chunks=hkv)
        emit(phase="flash_long", shape=f"llama3.2-1B T={t}", B=b, H=h,
             Hkv=hkv, T=t, D=d, causal=True, dtype="bfloat16",
             **{kn: {**checked[kn], **timed[kn]} for kn in ("K1", "K2")})
        out[t] = {kn: {key: timed[kn][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for kn in ("K1", "K2")}
        del q, k, v, do
    return out


def llama_cfg(**kw):
    """Llama-3.2-1B at full width (16 layers, E 2048, 32/8 heads, F 8192,
    vocab 128256, untied head) as bench_suite rows 6 and 7 train it: bf16
    activations and params, flash attention, the fused head cross-entropy
    with bf16 logits; ``kw`` overrides."""
    from pytorch_distributed_tpu_torch.config import model_config

    return model_config("llama3-1b", **{**dict(
        param_dtype="bfloat16", attention_impl="flash", remat="names",
        fused_head_ce=True, logits_dtype="bfloat16"), **kw})


def train_llama_phase(fk, cfg, seed, dev, *, b=1, t=4096, warmup=2,
                      steps=5, phase="train_llama", at_init=None) -> dict:
    """``steps`` timed steps after ``warmup`` of ``cfg`` on one fixed
    [b, t] batch (weights drawn on the card from ``--seed``): ms/step,
    tok/s, MFU (bench.py's 6N + 12LET flops per token over the bf16 peak,
    N every parameter, embedding and untied head included), peak memory,
    K1/K2 launches (counted from zero over the whole drive: K1
    ``K1_PER_LAYER`` x n_layer x steps, K2 n_layer x steps); the loss must
    fall. Then a one-step profile (device idle share, top kernels).
    ``at_init(state, batch)``: a measurement of the initial state, returned
    as ``at_init``."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.utils import tree

    n = warmup + steps
    tcfg = TrainConfig(global_batch_size=b, micro_batch_size=b, num_steps=n,
                       learning_rate=3e-4)
    state, step, batch = train_setup(cfg, tcfg, b, t, seed, dev,
                                     draw_on=dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * t
    init = at_init(state, batch) if at_init else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)
    losses = []
    for _ in range(warmup):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
    elapsed = time.perf_counter() - t0
    launches = dict(fk.launches)
    want = {"forward": cfg.n_layer * n * K1_PER_LAYER[cfg.remat],
            "backward": cfg.n_layer * n}
    tok_s = steps * b * t / elapsed
    row = dict(B=b, T=t, n_layer=cfg.n_layer, remat=cfg.remat,
               n_experts=cfg.n_experts, ms_per_step=elapsed / steps * 1e3,
               tokens_per_s=tok_s,
               mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
               n_params=n_params, flops_per_token=flops_per_token,
               warmup_losses=losses, loss=loss, grad_norm=grad_norm,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches, want_launches=want,
               launches_per_step={k: v / n for k, v in launches.items()})
    emit(phase=phase, **row)
    if launches != want:
        raise AssertionError(f"{phase}: flash launches {launches} != {want}")
    if not (np.isfinite([*losses, loss]).all() and loss < losses[0]):
        raise AssertionError(f"{phase}: the loss did not fall on the fixed "
                             f"batch: {losses[0]} -> {loss}")
    row["profile"] = train_profile_phase(
        dict(step=step, state=state, batch=batch), n_steps=1,
        phase=f"{phase}_profile")
    return dict(row, step=step, state=state, batch=batch, at_init=init)


# f32 GEMMs (cuBLAS names them sgemm or gemm_f32f32..., with TF32 off): in
# the llama loop step only the unfused head multiplies in f32.
F32_GEMM = r"(?i)sgemm|gemm_f32f32|f32f32_f32f32"


def train_llama_loop_phase(fk, seed, tmp) -> dict:
    """The entry point ``python -m pytorch_distributed_tpu_torch.train.
    baseline --preset llama3-1b`` at its defaults (f32 params, bf16
    activations, flash + names, f32 logits through the unfused head, A = 4
    micro-batches of [8, 1024], synthetic shards), in process through the
    functions its ``main`` uses, for 4 steps logged one by one: ms/step
    (the median of steps 2-4), tok/s, MFU, peak memory, K1/K2 launches
    (16 x 4 micro-batches each per step); the loss must fall. Then a
    one-step profile with the f32 GEMMs' (the head's) share of device
    time."""
    from pytorch_distributed_tpu_torch.data import TokenShardLoader
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train import baseline
    from pytorch_distributed_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_tpu_torch.utils import tree

    args = baseline.parse_args([
        "--preset", "llama3-1b", "--steps", "4", "--log-every", "1",
        "--num-train-files", "2", "--seed", str(seed),
        "--data-dir", f"{tmp}/data", "--checkpoint-dir", f"{tmp}/ck",
    ])
    model_cfg = baseline.build_model_cfg(args)
    train_cfg = baseline.build_train_cfg(args)
    paths = baseline.shard_paths(args, model_cfg.vocab_size)
    b, t = args.micro_batch_size, args.seq_len
    loader = TokenShardLoader(paths, b, t)
    trainer = Trainer(get_model(model_cfg), model_cfg, train_cfg,
                      device=args.device, log_fn=lambda line: None)
    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)
    state, hist = trainer.train(loader, state=state)
    launches = dict(fk.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = [(hist[i]["elapsed_s"] - hist[i - 1]["elapsed_s"]) * 1e3
             for i in range(1, len(hist))]
    ms_step = statistics.median(steps)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * model_cfg.n_layer * \
        model_cfg.n_embd * t
    tok_s = train_cfg.global_batch_size * t / (ms_step / 1e3)
    accum = trainer.accum
    want = {"forward": model_cfg.n_layer * accum * train_cfg.num_steps,
            "backward": model_cfg.n_layer * accum * train_cfg.num_steps}
    row = dict(preset=args.preset, A=accum, B=b, T=t,
               steps=train_cfg.num_steps, remat=model_cfg.remat,
               attention_impl=model_cfg.attention_impl,
               dtype=model_cfg.dtype, param_dtype=model_cfg.param_dtype,
               logits_dtype=model_cfg.logits_dtype,
               fused_head_ce=model_cfg.fused_head_ce, ms_per_step=ms_step,
               ms_per_step_steps=steps, tokens_per_s=tok_s,
               mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
               n_params=n_params, flops_per_token=flops_per_token,
               max_memory_allocated=peak,
               losses=[h["loss"] for h in hist], launches=launches,
               want_launches=want)
    emit(phase="train_llama_loop", **row)
    losses = row["losses"]
    if launches != want:
        raise AssertionError(f"llama loop: flash launches {launches} != "
                             f"{want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the llama loop's loss did not fall: {losses}")
    group = next(trainer._grouped_batches(TokenShardLoader(paths, b, t)))
    row["profile"] = train_profile_phase(
        dict(step=trainer.train_step, state=state,
             batch=trainer.put_batch(group)), n_steps=1,
        phase="train_llama_loop_profile", share_of=F32_GEMM)
    return row


def train_llama_remat_phase(fk, seed, dev, n_layer=4, t=4096, warmup=1,
                            steps=3) -> dict:
    """Llama-3.2-1B width at ``n_layer`` layers, B=1, T=``t``: (1) the bf16
    step (``llama_cfg``) under every remat mode: ms/step, peak memory, K1
    launches per step n_layer x ``K1_PER_LAYER``, K2 n_layer; (2) one f32
    forward and backward (unfused f32 head) under each mode: every
    gradient equal to mode none's within 1e-5 of that leaf's largest
    (measured bit-equal for GPT-2 on an H100: the recompute repeats the same
    kernels on the same values); (3) one f32 step through the flash
    kernels and one with naive attention from the same weights
    (``train_parity_phase``'s tolerances, both under ``full`` remat so the
    naive step's [1, 32, T, T] f32 scores live one layer at a time)."""
    from pytorch_distributed_tpu_torch.config import TrainConfig

    base = llama_cfg(n_layer=n_layer)
    rows = {}
    for mode in ("none", "full", "dots", "dots_no_batch", "names", "flash"):
        c = base.replace(remat=mode)
        tcfg = TrainConfig(global_batch_size=1, micro_batch_size=1,
                           num_steps=warmup + steps, learning_rate=3e-4)
        state, step, batch = train_setup(c, tcfg, 1, t, seed, dev,
                                         draw_on=dev)
        for _ in range(warmup):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        loss = float(m["loss"])
        elapsed = time.perf_counter() - t0
        launches = dict(fk.launches)
        want = {"forward": n_layer * steps * K1_PER_LAYER[mode],
                "backward": n_layer * steps}
        rows[mode] = dict(ms_per_step=elapsed / steps * 1e3, loss=loss,
                          launches=launches, want_launches=want,
                          max_memory_allocated=(
                              torch.cuda.max_memory_allocated()))
        if launches != want:
            raise AssertionError(
                f"llama remat {mode}: flash launches {launches} != {want}")
        del state, step, batch

    from pytorch_distributed_tpu_torch.models import llama

    f32 = base.replace(dtype="float32", param_dtype="float32",
                       logits_dtype="float32", fused_head_ce=False)
    f32_params = llama.init(torch.Generator(device=dev).manual_seed(seed),
                            f32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.randint(0, f32.vocab_size, (1, 1, t), generator=g,
                              device=dev) for k in ("inputs", "targets")}
    loss0, ref = _dropout_grads(f32.replace(remat="none"), f32_params, batch,
                                None)
    grads = {}
    for mode in ("full", "dots", "dots_no_batch", "names", "flash"):
        loss, gr = _dropout_grads(f32.replace(remat=mode), f32_params, batch,
                                  None)
        grads[mode] = dict(
            loss=float(loss),
            bitwise=bool(torch.equal(loss, loss0)) and all(
                torch.equal(a, b) for a, b in zip(gr, ref)),
            max_rel_diff=max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(gr, ref)))
        del gr
    del ref, f32_params
    emit(phase="train_llama_remat", n_layer=n_layer, B=1, T=t, steps=steps,
         modes=rows, f32_loss_none=float(loss0), f32_grads=grads)
    bad = {m: r for m, r in grads.items() if r["max_rel_diff"] > 1e-5}
    if bad:
        raise AssertionError(f"llama f32 gradients under remat modes differ "
                             f"from none's: {bad}")
    train_parity_phase(base.replace(remat="full"), seed, dev, b=1, t=t,
                       draw_on=dev, phase="train_llama_parity")
    return rows


def moe_dropped_share(model_mod, cfg, params, inputs) -> float:
    """The share of the assignments ``moe_mlp`` drops for capacity, over
    every layer of one forward of ``inputs`` (the block inputs recorded
    through ``model_mod``'s ``moe_mlp``)."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.ops import moe

    real, shares = model_mod.moe_mlp, []

    def recording(x, p, **kw):
        shares.append(moe.dropped_share(
            x, p["router"], top_k=kw["top_k"],
            capacity_factor=kw["capacity_factor"]))
        return real(x, p, **kw)

    model_mod.moe_mlp = recording
    try:
        with torch.no_grad():
            get_model(cfg).apply(params, inputs, cfg)
    finally:
        model_mod.moe_mlp = real
    return float(torch.stack(shares).mean())


def moe_dispatch_agreement(dev, seed) -> dict:
    """``moe_mlp``'s sort and einsum dispatch on the card at shapes where
    "auto" picks einsum (GPT-2 width, 8 dense gelu experts; Llama width, 8
    SwiGLU experts; top-2, capacity 1.25, f32): outputs within 1e-5 of
    their largest magnitude, the aux terms equal (summation order is all
    that differs)."""
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops import moe

    out = {}
    for name, d, f, n, gated in (("gpt2", 768, 3072, 256, False),
                                 ("llama", 2048, 8192, 128, True)):
        g = torch.Generator(device=dev).manual_seed(seed)
        w = {"router": torch.randn(d, 8, generator=g, device=dev),
             "w_in": torch.randn(8, d, f, generator=g, device=dev) * 0.02,
             "w_out": torch.randn(8, f, d, generator=g, device=dev) * 0.02}
        if gated:
            w["w_gate"] = torch.randn(8, d, f, generator=g, device=dev) * 0.02
        x = torch.randn(1, n, d, generator=g, device=dev)
        act = F.silu if gated else (lambda h: F.gelu(h, approximate="tanh"))
        cap = moe.expert_capacity(n * 2, 8, 1.25)
        auto = ("einsum" if n * 2 * 8 * cap <= moe._AUTO_EINSUM_LIMIT
                else "sort")
        res = {impl: moe.moe_mlp(x, w, activation=act, capacity_factor=1.25,
                                 top_k=2, dispatch_impl=impl)
               for impl in ("einsum", "sort")}
        (oe, ae), (os_, as_) = res["einsum"], res["sort"]
        rel = float((oe - os_).abs().max() / oe.abs().max())
        out[name] = dict(tokens=n, capacity=cap, auto_picks=auto,
                         max_rel_diff=rel,
                         aux_equal=bool(torch.equal(ae, as_)))
        if auto != "einsum" or rel > 1e-5 or not out[name]["aux_equal"]:
            raise AssertionError(f"moe sort vs einsum at {name}: {out[name]}")
    return out


def train_moe_phase(fk, seed, dev) -> dict:
    """MoE training at full width: GPT-2 124M (12 layers, 8 dense gelu
    experts, top-2, capacity 1.25, B=8, T=1024, bf16 over f32 params, flash,
    names, bf16 logits: "auto" picks sort) and Llama-3.2-1B width at 4
    layers with 8 SwiGLU experts, top-2 (Mixtral's routing), bf16 params,
    B=1, T=4096 (sort). Each: ms/step, peak memory, the dropped-assignment
    share over the fixed batch at init and after the steps, K1/K2 launches
    and a falling loss (``train_llama_phase``), and
    two runs of one step's loss and gradients bit-equal. Then sort vs
    einsum on the card (``moe_dispatch_agreement``)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama

    moe_kw = dict(n_experts=8, moe_top_k=2, expert_capacity_factor=1.25)
    cases = (
        ("gpt2", gpt2, model_config(
            "gpt2", attention_impl="flash", remat="names",
            logits_dtype="bfloat16", attn_pdrop=0.0, resid_pdrop=0.0,
            embd_pdrop=0.0, **moe_kw), 8, 1024),
        ("llama", llama, llama_cfg(n_layer=4, **moe_kw), 1, 4096),
    )
    out = {}
    for name, mod, cfg, b, t in cases:
        def dropped(state, batch, mod=mod, cfg=cfg):
            return moe_dropped_share(mod, cfg, state.params,
                                     batch["inputs"][0])

        run = train_llama_phase(fk, cfg, seed, dev, b=b, t=t, warmup=2,
                                steps=3, phase=f"train_moe_{name}",
                                at_init=dropped)
        state, batch = run.pop("state"), run.pop("batch")
        run.pop("step")
        share = dropped(state, batch)
        runs = [_dropout_grads(cfg, state.params, batch, None)
                for _ in range(2)]
        (l1, g1), (l2, g2) = runs
        bitwise = bool(torch.equal(l1, l2)) and all(
            torch.equal(a, c) for a, c in zip(g1, g2))
        emit(phase=f"train_moe_{name}_checks", dropped_share_at_init=run[
            "at_init"], dropped_share=share, two_runs_bitwise=bitwise,
             loss=float(l1))
        if not bitwise:
            raise AssertionError(f"moe {name}: two runs of one step differ")
        out[name] = dict(run, dropped_share=share, two_runs_bitwise=bitwise)
        del state, batch, runs, g1, g2
    agree = moe_dispatch_agreement(dev, seed)
    emit(phase="train_moe_dispatch", **agree)
    return out


# Device kernels of the port in a Kineto trace, by op name: K1's forward,
# K2's three kernels (one wrapper launch each), the paged kernel on pages in
# q's dtype (K3) and on int8 pages (K4: ``KV = int8_t`` demangles as
# ``signed char``).
K2_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")


def trace_launches(ops: dict) -> dict:
    """K1..K4 launches in a ``trace_analysis.op_summary``: K1 and K3/K4
    counts, K2 the count of each of its three kernels."""
    def count(match):
        return sum(r["count"] for name, r in ops.items() if match(name))

    return dict(
        K1=count(lambda n: "flash_fwd" in n),
        K2={k: count(lambda n, k=k: k in n) for k in K2_KERNELS},
        K3=count(lambda n: "paged_decode_kernel" in n
                 and "signed char" not in n),
        K4=count(lambda n: "paged_decode_kernel" in n
                 and "signed char" in n),
    )


def _counted_profiler(read_counts):
    """A ``ScheduledProfiler`` that reads ``read_counts()`` (the wrappers'
    launch counters) at both edges of its active window, after the device
    drained, and keeps the window's ``key_averages()`` and its
    ``profile_summary`` over the window's host clock."""
    from pytorch_distributed_tpu_torch.profiling.profiler import (
        ScheduledProfiler,
    )

    class Counted(ScheduledProfiler):
        def _edge(self):
            super()._edge()
            key = "start" if self._window_t0 is not None else "end"
            self.counts[key] = read_counts()

        def _on_trace_ready(self, prof):
            super()._on_trace_ready(prof)
            self.events = prof.key_averages()
            self.summary = profile_summary(prof,
                                           self.window_seconds[-1] * 1e3)

    Counted.counts = {}
    return Counted


def _window_checks(phase, run, prof, counted, traced) -> dict:
    """The gates every profiling phase shares: the trace's counts of the
    port's kernels equal the wrappers' counters over the window, and one
    card shows no communication. Returns the breakdown beside the old
    ``key_averages`` idle share of the same window."""
    tb, summary = run["breakdown"], prof.summary
    if tb["communication_us"] != 0:
        comm = [n[:80] for n, r in run["ops"].items()
                if r["category"] == "communication"]
        raise AssertionError(f"{phase}: communication on one card: {comm}")
    if counted != traced:
        raise AssertionError(f"{phase}: the trace recorded {traced} "
                             f"launches, the wrappers counted {counted}")
    top = sorted(run["ops"].items(), key=lambda kv: -kv[1]["total_us"])[:10]
    return dict(
        trace_idle_pct=tb["idle_pct"], trace_compute_pct=tb["compute_pct"],
        trace_memcpy_pct=tb["memcpy_pct"], trace_busy_us=tb["busy_us"],
        trace_span_us=tb["total_us"],
        window_wall_ms=prof.window_seconds[0] * 1e3,
        key_averages_device_idle_share=summary["device_idle_share"],
        key_averages_device_busy_ms=summary["device_busy_ms"],
        top_ops_ms=[dict(name=n[:80], count=r["count"],
                         ms=r["total_us"] / 1e3) for n, r in top],
        launches_counted=counted, launches_traced=traced,
        lost_launches=len(lost_launches(run["trace"])))


def profiling_train_phase(fk, seed, smi) -> dict:
    """GPT-2 124M at full width through the port's ``Trainer`` under
    ``ScheduledProfiler(wait=2, warmup=2, active=4)`` for 8 steps
    (``profiling.trace_smoke``'s functions): one trace file; compute above
    10 % and no communication; K1's and each of K2's kernels counted in the
    trace as often as the wrappers counted over the 4 active steps; the
    trace's busy time within 2 % of the window's kernel time by
    ``key_averages()``."""
    from pytorch_distributed_tpu_torch.profiling import trace_smoke

    cfg = trace_smoke.smoke_cfg("gpt2")
    cls = _counted_profiler(lambda: dict(fk.launches))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = trace_smoke.profiled_training(
            cfg, tmp, batch=8, seq_len=1024, steps=8, seed=seed,
            device="cuda", profiler_cls=cls)
        wall = time.perf_counter() - t0
    prof = run["profiler"]
    if len(run["files"]) != 1:
        raise AssertionError(f"profiling_train: {len(run['files'])} trace "
                             f"files, want 1")
    trace_smoke.check(run)
    start, end = prof.counts["start"], prof.counts["end"]
    fwd = end["forward"] - start["forward"]
    bwd = end["backward"] - start["backward"]
    traced = trace_launches(run["ops"])
    counted = dict(K1=fwd, K2={k: bwd for k in K2_KERNELS})
    if fwd != cfg.n_layer * 4:
        raise AssertionError(f"profiling_train: K1 counted {fwd}, want "
                             f"{cfg.n_layer} x 4 active steps")
    res = _window_checks("profiling_train", run, prof, counted,
                         {k: traced[k] for k in ("K1", "K2")})
    ka_us = sum(device_us(e) for e in device_rows(prof.events))
    busy = run["breakdown"]["busy_us"]
    res.update(key_averages_device_us=ka_us,
               busy_vs_key_averages=busy / ka_us - 1)
    emit(phase="profiling_train", nvidia_smi=smi, steps=8,
         schedule=trace_smoke.SCHEDULE, B=8, T=1024, phase_wall_s=wall,
         trace_files=len(run["files"]), **res)
    if abs(busy - ka_us) > 0.02 * ka_us:
        raise AssertionError(f"profiling_train: trace busy {busy} us vs "
                             f"key_averages {ka_us} us (> 2 %)")
    return res


def profiling_serve_phase(pk, cfg, params, reqs, smi, **quant) -> dict:
    """10 pure decode ticks of the bf16 paged engine (GPT-2 124M, 8 slots,
    max_len 1024, 16-token pages; ``quant``: int8 pages and weights) under
    ``ScheduledProfiler(wait=0, warmup=2, active=10)``, one ``step()`` a
    tick: the path's kernel (K3, or K4 on int8 pages) counted in the trace
    as often as its wrapper counted, n_layer x 10; no communication; the
    trace's idle share beside ``profile_summary``'s for the same ticks,
    and the share over 10 ticks run just before without the profiler
    (the profiler's own host cost inflates a profiled window's wall)."""
    from pytorch_distributed_tpu_torch.profiling import trace_analysis as ta
    from pytorch_distributed_tpu_torch.profiling.profiler import (
        find_trace_files,
    )
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    kid = "K4" if quant else "K3"
    eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024, page_size=16,
                                   **quant)
    eng.warmup(params)
    for r in reqs[:8]:
        eng.submit(**r)
    while True:  # until every row has finished its prefill
        before = eng.counters["prefill_ticks"]
        eng.step(params)
        if eng.counters["prefill_ticks"] == before:
            break
    # The same number of ticks without the profiler first: what a tick
    # costs the host when nothing records it.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        eng.step(params)
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    cls = _counted_profiler(lambda: {"K3": pk.launches,
                                     "K4": pk.launches_q8})
    with tempfile.TemporaryDirectory() as tmp:
        with cls(tmp, wait=0, warmup=2, active=10, device="cuda") as prof:
            for _ in range(12):
                eng.step(params)
                prof.step()
        files = find_trace_files(tmp)
        trace = ta.load_trace(files[0])
    if eng.counters["prefill_ticks"] != before:
        raise AssertionError("profiling_serve: a prefill ran in the window")
    run = dict(trace=trace, breakdown=ta.temporal_breakdown(trace),
               ops=ta.op_summary(trace))
    counted = {k: prof.counts["end"][k] - prof.counts["start"][k]
               for k in ("K3", "K4")}
    want = {"K3": 0, "K4": 0}
    want[kid] = cfg.n_layer * 10
    if counted != want:
        raise AssertionError(f"profiling_serve: counted {counted}, want "
                             f"{want}")
    traced = trace_launches(run["ops"])
    res = _window_checks(f"profiling_serve_{kid}", run, prof, counted,
                         {k: traced[k] for k in ("K3", "K4")})
    res.update(unprofiled_window_ms=bare_ms, unprofiled_idle_share=(
        1 - run["breakdown"]["busy_us"] / 1e3 / bare_ms))
    emit(phase="profiling_serve", nvidia_smi=smi, kernel=kid,
         decode_ticks=10, trace_files=len(files), **quant, **res)
    return res


def memory_phase(seed, smi) -> dict:
    """The ``memory_analysis`` twin's functions on the profiling_train
    configuration (GPT-2 124M, bf16, flash, names, B 8, T 1024): the
    allocator's history recorded from before the model is built, 3 steps,
    the analytic breakdown against the measured peak. Gates: the peak is
    at least params + grads + optimizer bytes and at most the card's
    memory; the snapshot pickle loads and holds a segment."""
    import pickle

    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.profiling import memory, trace_smoke

    cfg = trace_smoke.smoke_cfg("gpt2")
    est = memory.analytic_memory_breakdown(cfg, batch_size=8, seq_len=1024)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory.start_memory_history()
    try:
        tcfg = TrainConfig(global_batch_size=8, micro_batch_size=8,
                           num_steps=3, learning_rate=3e-4)
        state, step, batch = train_setup(cfg, tcfg, 8, 1024, seed, "cuda")
        for _ in range(3):
            state, m = step(state, batch)
        loss = float(m["loss"])
        meas = memory.measured_memory()
        with tempfile.TemporaryDirectory() as tmp:
            path = memory.save_memory_snapshot(f"{tmp}/snapshot.pickle")
            with open(path, "rb") as f:
                snap = pickle.load(f)
    finally:
        memory.stop_memory_history()
    del state, step, batch
    floor = est["params_bytes"] + est["grads_bytes"] + est["optimizer_bytes"]
    peak = meas["peak_bytes_in_use"]
    res = dict(
        analytic={k: v for k, v in est.items() if k != "config"},
        measured={k: meas[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                       "bytes_limit")},
        measured_over_estimated=peak / est["total_bytes_estimate"],
        params_grads_optimizer_bytes=floor,
        snapshot_segments=len(snap.get("segments", [])),
        snapshot_traces=sum(len(t) for t in snap.get("device_traces", [])),
        loss=loss)
    emit(phase="memory", nvidia_smi=smi, B=8, T=1024, **res)
    if not floor <= peak <= meas["bytes_limit"]:
        raise AssertionError(f"memory: peak {peak} B outside [{floor}, "
                             f"{meas['bytes_limit']}]")
    if not res["snapshot_segments"]:
        raise AssertionError("memory: the snapshot holds no segment")
    return res


def throughput_phase(seed, smi) -> dict:
    """``measure_tokens_per_second`` at GPT-2 124M, B 8, T 1024 (5 warmup
    and 20 timed steps) and ``extrapolate_modern_training``; then
    ``compare_batch_sizes`` over (1, 8, X, 8), X the least power of two
    whose analytic breakdown (the unfused head) exceeds the card's memory.
    Gates: X's row is an OOM, and the 8 after it runs within 20 % of the
    first 8's tokens/s."""
    from pytorch_distributed_tpu_torch.profiling import (
        memory,
        throughput,
        trace_smoke,
    )

    cfg = trace_smoke.smoke_cfg("gpt2")
    r = throughput.measure_tokens_per_second(cfg, batch_size=8,
                                             seq_len=1024, seed=seed)
    ex = throughput.extrapolate_modern_training(r)
    limit = torch.cuda.get_device_properties(0).total_memory
    x = 8
    while memory.analytic_memory_breakdown(
            cfg, batch_size=x, seq_len=1024)["total_bytes_estimate"] <= limit:
        x *= 2
    rows = throughput.compare_batch_sizes(cfg, batch_sizes=(1, 8, x, 8),
                                          seq_len=1024)
    res = dict(measured=r, extrapolation=ex, oom_batch=x,
               oom_batch_estimate_bytes=memory.analytic_memory_breakdown(
                   cfg, batch_size=x, seq_len=1024)["total_bytes_estimate"],
               bytes_limit=limit, sweep=rows)
    emit(phase="throughput", nvidia_smi=smi, **res)
    if not rows[2]["oom"]:
        raise AssertionError(f"throughput: batch {x} did not run out of "
                             f"memory: {rows[2]}")
    first, after = rows[1], rows[3]
    if first["oom"] or after["oom"] or abs(
            after["tokens_per_second"] / first["tokens_per_second"] - 1) \
            > 0.2:
        raise AssertionError(f"throughput: batch 8 after the OOM {after} "
                             f"vs before {first}")
    return res


@dataclasses.dataclass(frozen=True)
class DecodeBenchRun:
    """One run of the decode_bench twin: its flags; ``side_by_side``:
    whether it runs beside phases 15-17c (``late_phases``; none of its
    legs asserts a time ratio) or alone; ``modes``: each mode it runs,
    with the prefix of that mode's rows' ``leg``."""

    flags: tuple
    side_by_side: bool
    modes: dict


DECODE_BENCH_RUNS = {
    # 2 timed repeats where the twin's default is 3, and 64 new tokens
    # where the JAX script's default is 512 (the whole run's time: 512 made
    # the speculative mode 109 s of the card's run, 256 72 s, 128 43 s),
    # to make room for the tensor-parallel phase (17).
    "decode": DecodeBenchRun(("--repeats", "2"), True, {"decode": ""}),
    "speculative": DecodeBenchRun(("--speculative", "4", "--max-new", "64"),
                                  True, {"speculative": ""}),
    "serving_batched_chaos": DecodeBenchRun(
        ("--serving-batched", "--chaos"), True,
        {"serving_batched_chaos": ""}),
    # Three modes in one process (the twin runs every mode flag it is
    # given, each its own rows): one torch start-up, not three.
    "serving_modes": DecodeBenchRun(
        ("--serving", "--serving-batched", "--serving-paged", "--kv-quant",
         "int8", "--weight-quant", "int8", "--rank-legs", "skip"), True,
        {"serving": "serving_stream",
         "serving_batched": "serving_batched_stream",
         "serving_quant": "serving_quant_stream"}),
    # Gates a speedup (the median of five pairs stepped in turns): alone.
    "serving_spec": DecodeBenchRun(("--serving-spec", "--rank-legs",
                                    "skip"), False,
                                   {"serving_spec": "serving_spec_"}),
    # The two multi-rank sub-legs (slice 16), each on two gloo ranks
    # sharing cuda:0: serving_spec_tp's equality and no-steady-load gates
    # (the twin exits nonzero when they break), zero3_decode's row.
    "rank_legs": DecodeBenchRun(("--serving", "--serving-spec",
                                 "--rank-legs", "only", "--repeats", "2"),
                                True,
                                {"serving_spec_tp": "serving_spec_tp",
                                 "zero3_decode": "zero3_decode"}),
}


def decode_bench_child(name: str, workdir: str) -> tuple:
    """(argv, env) of one ``DECODE_BENCH_RUNS`` run, its rows in
    ``workdir``/<name>.json."""
    return ([sys.executable, "-m",
             "pytorch_distributed_tpu_torch.serving.decode_bench",
             *DECODE_BENCH_RUNS[name].flags, "--json",
             f"{workdir}/{name}.json"],
            dict(os.environ))


def decode_bench_spec_phase(smi) -> list:
    """``--serving-spec`` alone (its speedup gate reads host time): exit 0
    and its rows."""
    with tempfile.TemporaryDirectory() as tmp:
        wall, _ = run_children({"serving_spec": decode_bench_child(
            "serving_spec", tmp)}, 300, "decode_bench_twin_2 serving_spec")
        with open(f"{tmp}/serving_spec.json") as f:
            rows = json.load(f)
    emit_decode_bench_run(smi, "serving_spec", rows, wall, False)
    return rows


def emit_decode_bench_run(smi, name: str, rows: list, wall: float,
                          side_by_side: bool) -> None:
    emit(phase="decode_bench_twin_2", nvidia_smi=smi, mode=name,
         flags=list(DECODE_BENCH_RUNS[name].flags), wall_s=wall,
         side_by_side=side_by_side, exit_code=0,
         launches={k: sum(r["launches"][k] for r in rows)
                   for k in ("K3", "K4", "lora")}, rows=rows)


def decode_bench_twin_2_paths(runs: dict) -> dict:
    """Each mode's kernel launches (``DECODE_BENCH_RUNS``' modes) from
    every run's rows (``runs``: name -> rows); K3 must be launched on
    ``--serving-spec``, K4 on the quant leg."""
    legs = {}
    for run, spec in DECODE_BENCH_RUNS.items():
        for mode, prefix in spec.modes.items():
            rows = [r for r in runs[run]
                    if r.get("leg", "").startswith(prefix)]
            if not rows:
                raise AssertionError(f"decode_bench {mode}: no rows in "
                                     f"{run}")
            legs[mode] = {k: sum(r["launches"][k] for r in rows)
                          for k in ("K3", "K4", "lora")}
    if not legs["serving_spec"]["K3"]:
        raise AssertionError(f"--serving-spec launched no K3: "
                             f"{legs['serving_spec']}")
    if not legs["serving_quant"]["K4"]:
        raise AssertionError(f"the quant leg launched no K4: "
                             f"{legs['serving_quant']}")
    if not legs["serving_spec_tp"]["K3"]:
        raise AssertionError(f"serving_spec_tp launched no K3: "
                             f"{legs['serving_spec_tp']}")
    return legs


def _count_syncs(fn) -> list[str]:
    """The synchronizing CUDA calls ``fn`` makes, as CUDA's sync debug mode
    reports them (one warning each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0][:120] for w in caught
            if "prototype feature" not in str(w.message)]


def _bits(state) -> list:
    """Copies of the bit patterns of params, mu, nu and both counts (NaN
    equal to itself, -0.0 not to +0.0)."""
    from pytorch_distributed_tpu_torch.utils import tree

    opt = state.opt_state
    leaves = (tree.leaves(state.params) + tree.leaves(opt["mu"])
              + tree.leaves(opt["nu"]))
    ints = {4: torch.int32, 2: torch.int16}
    return ([t.view(ints[t.element_size()]).clone() for t in leaves]
            + [torch.as_tensor(opt["count"]).clone(),
               torch.as_tensor(opt["schedule_count"]).clone()])


def _step_window(step, state, batch, n):
    """``n`` steps: (state, ms per step, the window's peak allocation above
    what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
    float(m["loss"])
    ms = (time.perf_counter() - t0) / n * 1e3
    return state, ms, dict(
        above_resident=torch.cuda.max_memory_allocated() - base,
        max_memory_allocated=torch.cuda.max_memory_allocated())


def train_guard_phase(fk, cfg, seed, dev, smi, tmp, warmup=2,
                      steps=10) -> dict:
    """The guarded training loop at full width (module docstring, 11b):
    the no-sync property, a corrupt batch, costs, rollback replay and
    async against sync saves."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.data import (
        TokenShardLoader,
        make_synthetic_shards,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train import guard as guard_lib
    from pytorch_distributed_tpu_torch.train.chaos import (
        TrainFault,
        TrainFaultInjector,
    )
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import (
        Trainer,
        make_train_step,
    )

    b, t, n_layer = 8, 1024, cfg.n_layer
    kw = dict(global_batch_size=b, micro_batch_size=b,
              num_steps=warmup + steps + 4, learning_rate=3e-4)
    state, plain_step, batch = train_setup(cfg, TrainConfig(**kw), b, t,
                                           seed, dev)
    # The guarded twin: the same weights (drawn on the host from the seed,
    # as train_setup draws them) and batch.
    tcfg = TrainConfig(**kw, anomaly_guard=True)
    tx = make_optimizer(tcfg)
    model = get_model(cfg)
    gstate = init_train_state(
        model.init(torch.Generator().manual_seed(seed), cfg, device=dev),
        tx, guard=guard_lib.init_guard_state(dev))
    gstep = make_train_step(model, cfg, tx, seed=seed,
                            guard=guard_lib.guard_config_from(tcfg, cfg))
    for _ in range(warmup):
        state, _ = plain_step(state, batch)
        gstate, _ = gstep(gstate, batch)
    out = {}

    def one(step, which):
        def run():
            nonlocal state, gstate
            if which == "plain":
                state, _ = step(state, batch)
            else:
                gstate, _ = step(gstate, batch)
        return run

    syncs = dict(unguarded=_count_syncs(one(plain_step, "plain")),
                 guarded=_count_syncs(one(gstep, "guarded")))
    # Costs in turns (unguarded, guarded, guarded, unguarded, twice), each
    # side's median: one window each read 100.4 against 118.4 ms on one
    # card, and one turn 79.6 / 129.6 against 77.0 / 85.2, where four turns
    # read 3.6 % apart (my chip runs, PR 13, calls 2-4).
    ms = dict(unguarded=[], guarded=[])
    peaks = {}
    for which in ("unguarded", "guarded", "guarded", "unguarded") * 2:
        if which == "unguarded":
            state, t_ms, peaks[which] = _step_window(plain_step, state,
                                                     batch, steps)
        else:
            gstate, t_ms, peaks[which] = _step_window(gstep, gstate, batch,
                                                      steps)
        ms[which].append(t_ms)
    ms_plain, ms_guard = (statistics.median(ms[k])
                          for k in ("unguarded", "guarded"))
    del state, plain_step
    torch.cuda.empty_cache()
    # A corrupt batch (the bad_batch fault's: the first eighth of the ids
    # -1), then one with targets outside [0, V): each a bitwise no-op.
    corrupt = {}
    for where in ("inputs", "targets"):
        bad = {k: v.clone() for k, v in batch.items()}
        flat = bad[where].view(-1)
        flat[:flat.numel() // 8] = -1 if where == "inputs" else cfg.vocab_size
        before, step_before = _bits(gstate), gstate.step
        total_before = int(gstate.guard.total)
        fk.launches.update(forward=0, backward=0)
        gstate, m = gstep(gstate, bad)
        torch.cuda.synchronize()  # a device assert would raise here
        launches = dict(fk.launches)
        same = all(torch.equal(x, y) for x, y in zip(before, _bits(gstate)))
        corrupt[where] = dict(
            loss=float(m["loss"]), anomaly=bool(m["anomaly"]),
            total=int(gstate.guard.total) - total_before,
            step_advanced=gstate.step - step_before,
            state_bit_unchanged=same, launches=launches)
        del before
    gstate, m = gstep(gstate, batch)  # the context still runs a clean step
    clean_after = dict(loss=float(m["loss"]), anomaly=bool(m["anomaly"]))
    del gstate, gstep
    torch.cuda.empty_cache()

    # Rollback replay and async against sync, through the Trainer on
    # synthetic shards: 4 steps, the loss logged every step. The faulted
    # run saves every 2 steps (sync): bad batches at steps 3 and 4 trip
    # the guard (rollback after 2) at step 4, and it replays steps 3-4
    # from step 2's checkpoint. The async run saves as often; both end
    # bit-equal to the clean run, which saves nothing.
    paths = make_synthetic_shards(f"{tmp}/data", num_shards=1,
                                  tokens_per_shard=200_000,
                                  vocab_size=cfg.vocab_size, seed=seed)

    def run(name, faults=(), save_every=2, **kw):
        tc = TrainConfig(global_batch_size=b, micro_batch_size=b,
                         num_steps=4, learning_rate=3e-4,
                         log_every_n_steps=1, save_every_n_steps=save_every,
                         keep_checkpoints=2, seed=seed,
                         checkpoint_dir=f"{tmp}/ck_{name}",
                         anomaly_guard=True, guard_rollback_after=2, **kw)
        trainer = Trainer(model, cfg, tc, device=dev,
                          log_fn=lambda line: None)
        if faults:
            TrainFaultInjector([TrainFault(tick=k, kind="bad_batch")
                                for k in faults]).install(trainer)
        fk.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        state, hist = trainer.train(TokenShardLoader(paths, b, t))
        ckpt.set_save_hook(None)
        return dict(state=state, hist=hist, rollbacks=trainer._rollbacks,
                    launches=dict(fk.launches),
                    wall_s=time.perf_counter() - t0)

    clean = run("clean", save_every=None)  # the reference: no saves
    faulted = run("faulted", faults=(3, 4))  # sync saves
    asynced = run("async", async_checkpoint=True)
    want = [h["loss"] for h in clean["hist"]]
    replayed = [h["loss"] for h in faulted["hist"][-2:]]
    finals = {name: _bits(r["state"]) for name, r in
              (("clean", clean), ("faulted", faulted), ("async", asynced))}
    bit_equal = {name: all(torch.equal(x, y) for x, y in
                           zip(finals["clean"], finals[name]))
                 for name in ("faulted", "async")}
    # The async save's blocking time against the sync save's, on the same
    # state; the in-flight save invisible until finalized.
    final = asynced["state"]
    times = {}
    for mode in ("sync", "async"):
        d = f"{tmp}/blocking_{mode}/checkpoint_step_4"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "sync":
            ckpt.save_checkpoint(d, final, cfg)
        else:
            ckpt.save_checkpoint_async(d, final, cfg)
        times[f"{mode}_blocking_ms"] = (time.perf_counter() - t0) * 1e3
    invisible = ckpt.latest_checkpoint(f"{tmp}/blocking_async") is None
    t0 = time.perf_counter()
    ckpt.finalize_async_save()
    times["async_finalize_ms"] = (time.perf_counter() - t0) * 1e3
    visible = ckpt.latest_checkpoint(f"{tmp}/blocking_async") is not None
    res = dict(
        B=b, T=t, n_layer=n_layer, remat=cfg.remat,
        attention_impl=cfg.attention_impl, dtype=cfg.dtype,
        host_syncs=dict(unguarded=len(syncs["unguarded"]),
                        guarded=len(syncs["guarded"])),
        host_sync_kinds=sorted(set(syncs["guarded"])),
        ms_per_step=dict(unguarded=ms_plain, guarded=ms_guard),
        ms_per_step_windows=ms, guard_cost_ratio=ms_guard / ms_plain,
        step_peak_memory=peaks,
        corrupt=corrupt, clean_after_corrupt=clean_after,
        clean_losses=want, faulted_losses=[h["loss"] for h in
                                           faulted["hist"]],
        replayed_losses=replayed, rollbacks=faulted["rollbacks"],
        anomalies=faulted["hist"][-1]["anomalies"],
        final_bit_equal=bit_equal,
        launches=dict(clean=clean["launches"], faulted=faulted["launches"],
                      async_run=asynced["launches"]),
        wall_s=dict(clean=clean["wall_s"], faulted=faulted["wall_s"],
                    async_run=asynced["wall_s"]),
        inflight_invisible=invisible, visible_after_finalize=visible,
        **times)
    emit(phase="train_guard", nvidia_smi=smi, **res)
    failures = []
    if res["host_syncs"]["guarded"] != res["host_syncs"]["unguarded"]:
        failures.append(f"the guard adds synchronizing calls: "
                        f"{syncs['guarded']} vs {syncs['unguarded']}")
    for where, row in corrupt.items():
        if not (row["anomaly"] and row["state_bit_unchanged"]
                and row["total"] == 1 and row["step_advanced"] == 1):
            failures.append(f"corrupt {where}: {row}")
        if row["launches"] != {"forward": n_layer, "backward": n_layer}:
            failures.append(f"corrupt {where} step launched "
                            f"{row['launches']}, want {n_layer} each")
    if clean_after["anomaly"] or not np.isfinite(clean_after["loss"]):
        failures.append(f"the clean step after them: {clean_after}")
    if replayed != want[-2:] or faulted["rollbacks"] != 1:
        failures.append(f"replay {replayed} vs clean {want[-2:]}, "
                        f"rollbacks {faulted['rollbacks']}")
    if not all(bit_equal.values()):
        failures.append(f"final states not bit-equal: {bit_equal}")
    # 4 steps, and the faulted run 2 more (the replay): n_layer each.
    for name, n in (("clean", 4), ("faulted", 6), ("async_run", 4)):
        got = res["launches"][name]
        if got != {"forward": n_layer * n, "backward": n_layer * n}:
            failures.append(f"{name} launched {got}, want n_layer x {n}")
    if not (invisible and visible):
        failures.append(f"in-flight save visible {not invisible}, after "
                        f"finalize {visible}")
    if failures:
        raise AssertionError(f"train_guard: {failures}")
    return res


# The storm's steps: at 10 the seeded schedule fires every fault kind (a
# crash, a SIGTERM, two bad batches, a corrupt checkpoint, slow steps) in
# 3 chaos attempts, where the dryrun's default 20 takes 5: two fewer
# worker processes, each ~8.4 s of torch start-up on the card's machine.
STORM_STEPS = 10


def _storm_child(workdir: str) -> tuple:
    """The supervisor twin's ``--dryrun`` storm at ``STORM_STEPS`` (argv,
    env), its report in ``workdir``/storm_report.json."""
    return ([sys.executable, "-m", "pytorch_distributed_tpu_torch.train."
             "supervisor", "--dryrun", "--steps", str(STORM_STEPS),
             "--workdir", f"{workdir}/storm", "--json",
             f"{workdir}/storm_report.json"], dict(os.environ))


@contextlib.contextmanager
def storm_in_background():
    """The storm (``_storm_child``) started now, beside the phases run
    inside the block; yields ``finish()``, which waits for it (to the
    script's deadline) and returns (its report, wall s). Its process group
    is killed at the block's end whatever happened."""
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryFile("w+") as err:
        argv, env = _storm_child(tmp)
        t0 = time.perf_counter()
        proc = pmesh().launch(argv, env=env, stdout=subprocess.DEVNULL,
                              stderr=err)

        def finish():
            try:
                proc.wait(timeout=phase_timeout(400, "train_storm"))
            except subprocess.TimeoutExpired:
                raise AssertionError("train_storm: not done by the "
                                     "deadline") from None
            finally:
                pmesh().kill_group(proc)
            if proc.returncode:
                err.seek(0)
                raise AssertionError(f"train_storm exited {proc.returncode}"
                                     f": {err.read()[-3000:]}")
            with open(f"{tmp}/storm_report.json") as f:
                return json.load(f), time.perf_counter() - t0

        try:
            yield finish
        finally:
            pmesh().kill_group(proc)


def train_storm_phase(smi, report: dict, wall: float) -> dict:
    """The storm's report (``_storm_child``) on the card, its workers in
    processes of their own (each a fresh CUDA context; a process spends
    ~8.4 s importing torch on the card's machine: the 64-step storm took
    227 s and the 20-step one 131 on an H100 80GB HBM3). ``wall``: its
    own, beside the phases of ``storm_in_background``'s block."""
    chaos = report.get("chaos", {})
    rcs = chaos.get("exit_codes", [])
    counts = report.get("fault_counts", {})
    res = dict(wall_s=wall,
               spawned=chaos.get("spawned"), restarts=chaos.get("restarts"),
               exit_codes=rcs, fault_counts=counts,
               completed=chaos.get("completed"),
               bit_equal=report.get("bit_equal"),
               chaos_wall_s=chaos.get("wallclock_s"),
               clean_wall_s=report.get("clean", {}).get("wallclock_s"),
               goodput_retention=report.get("goodput_retention"),
               kernel_libraries=sorted({a["compile_count"] for a in
                                        chaos.get("attempts", [])}),
               failures=report.get("failures"))
    emit(phase="train_storm", nvidia_smi=smi, **res)
    kinds = ("crash", "sigterm", "bad_batch", "ckpt_corrupt", "slow_step")
    crashes = sum(rc == 43 for rc in rcs)
    if not report.get("ok") or not res["completed"] \
            or not res["bit_equal"]:
        raise AssertionError(f"train_storm: {res}")
    if not all(counts.get(k) for k in kinds):
        raise AssertionError(f"train_storm: a fault kind never fired: "
                             f"{counts}")
    if crashes != counts["crash"] or rcs[-1] != 0:
        raise AssertionError(f"train_storm: {counts['crash']} crashes, "
                             f"{crashes} attempts exited 43, exit codes "
                             f"{rcs}: not a restart for every crash")
    return res


# A rank on the card joins its group with this timeout (a rank whose peer
# is gone waits no longer in a collective; gloo's default is 600 s).
RANK_GROUP_TIMEOUT_S = 120.0


# Data-parallel training (slice 13): each rank a subprocess of this script
# (``--ddp-worker``), GPT-2 124M at full width (bf16, flash, names), the
# global batch 8 x 1024 split over the ranks.
DDP_STEPS = 3
# One rank of the global batch against two ranks of half of it each, in
# bf16: the same sums taken over other batch shapes and another order of
# the reduction, so each step's loss may move by bf16 rounding (losses
# near 11, logits in bf16): held to 2e-2 absolute.
DDP_GLOO2_LOSS_ATOL = 2e-2
# full_shard's resident params and Adam moments per rank against
# no_shard's: half of every leaf that fsdp 2 divides (all of GPT-2's
# matrices) plus the replicated rest.
DDP_RESIDENT_RATIO = 0.55


def _ddp_model(seed: int, world: int):
    from pytorch_distributed_tpu_torch.config import (
        TrainConfig,
        model_config,
    )

    cfg = model_config("gpt2", attention_impl="flash", remat="names",
                       logits_dtype="bfloat16", attn_pdrop=0.0,
                       resid_pdrop=0.0, embd_pdrop=0.0)
    b, t = 8, 1024
    tcfg = TrainConfig(global_batch_size=b, micro_batch_size=b // world,
                       num_steps=DDP_STEPS, learning_rate=3e-4, seed=seed,
                       log_every_n_steps=1)
    rng = np.random.default_rng(seed)
    loader = [(rng.integers(0, cfg.vocab_size, (b, t)),
               rng.integers(0, cfg.vocab_size, (b, t)))
              for _ in range(DDP_STEPS)]
    return cfg, tcfg, loader


def _ddp_leg(trainer, loader, fk, zero, profiler=None) -> dict:
    """Train ``loader`` through the trainer's loop from a fresh state;
    the launches, collectives, step times, allocator bytes and the final
    state."""
    gc.collect()  # what earlier legs left to the collector goes now
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = trainer.init_state()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)
    c0 = zero.collectives
    state, hist = trainer.train(loader, state=state, profiler=profiler)
    elapsed = [h["elapsed_s"] for h in hist]
    return dict(state=state, losses=[h["loss"] for h in hist],
                ms_per_step=[(b - a) * 1e3 for a, b in
                             zip([0.0] + elapsed[:-1], elapsed)],
                launches=dict(fk.launches),
                collectives=zero.collectives - c0,
                resident_bytes=resident, base_bytes=base,
                peak_bytes=torch.cuda.max_memory_allocated())


def _ddp_legs(model, cfg, tcfg, loader, dev, world: int, strategies,
              ref=None) -> dict:
    """Each strategy's 3 steps through the ``DistributedTrainer``'s loop
    over data (no_shard) or fsdp (the others) of ``world`` ranks on the
    global batches; with ``ref`` (a state) whether the params equal
    its."""
    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.parallel import zero
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.utils import tree

    legs = {}
    for strategy in strategies:
        mcfg = (MeshConfig(data=world, strategy=strategy)
                if strategy == "no_shard" else
                MeshConfig(fsdp=world, strategy=strategy))
        trainer = DistributedTrainer(model, cfg, tcfg,
                                     make_mesh(mcfg, device=dev), mcfg,
                                     log_fn=lambda s: None)
        # The global batches: the trainer's put_batch keeps this rank's
        # rows.
        leg = _ddp_leg(trainer, loader, fk, zero)
        state = leg.pop("state")
        if ref is not None:
            leg["params_equal"] = all(
                torch.equal(a, b) for a, b in zip(tree.leaves(state.params),
                                                  tree.leaves(ref.params)))
        legs[strategy] = leg
        del trainer, state
        torch.cuda.empty_cache()
    return legs


def ddp_worker(workdir: str, seed: int) -> int:
    """The one rank of the ``ddp_nccl`` phase (world 1, NCCL); writes
    ``ddp_nccl_0.json``."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.parallel import zero
    from pytorch_distributed_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.profiling import trace_analysis
    from pytorch_distributed_tpu_torch.profiling.profiler import (
        ScheduledProfiler,
        find_trace_files,
    )
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_distributed(device=dev, backend="nccl",
                           timeout_s=RANK_GROUP_TIMEOUT_S)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg, tcfg, loader = _ddp_model(seed, world)
    model = get_model(cfg)
    quiet = dict(log_fn=lambda s: None)
    out = dict(rank=rank, world=world, backend=dist.get_backend())
    # the single-device Trainer on the same batches
    leg = _ddp_leg(Trainer(model, cfg, tcfg, device=dev, **quiet),
                   loader, fk, zero)
    ref = leg.pop("state")
    out["trainer"] = leg
    out["legs"] = _ddp_legs(model, cfg, tcfg, loader, dev, world,
                            ("no_shard", "full_shard", "shard_grad_op",
                             "shard_opt"), ref)
    del ref
    # A Kineto window over two DDP steps of the trainer's loop.
    mcfg = MeshConfig(data=1, strategy="no_shard")
    trainer = DistributedTrainer(
        model, cfg, dataclasses.replace(tcfg, num_steps=4),
        make_mesh(mcfg, device=dev), mcfg, **quiet)
    prof = ScheduledProfiler(f"{workdir}/trace", wait=1, warmup=1,
                             active=2, device=dev)
    leg = _ddp_leg(trainer, loader + loader[:1], fk, zero,
                   profiler=prof)
    prof.close()
    files = find_trace_files(f"{workdir}/trace")
    trace = trace_analysis.load_trace(files[0])
    events = trace["traceEvents"]
    rows = trace_analysis.device_op_events(trace)
    c10d = sum(1 for e in events if e.get("cat") == "cpu_op"
               and e.get("name", "").startswith("c10d::"))
    nccl_rows = [r for r in rows if r["name"].removeprefix("void ")
                 .lower().startswith("nccl")]
    out["trace"] = dict(
        files=len(files), nccl_kernels=len(nccl_rows),
        nccl_kernel_categories=sorted({r["category"]
                                       for r in nccl_rows}),
        c10d_ops=c10d,
        nccl_stream_annotations=sum(
            1 for e in events if e.get("cat") == "gpu_user_annotation"
            and e.get("name", "").startswith("nccl:")),
        collectives_per_step=leg["collectives"] / 4,
        memcpy_rows=sum(r["category"] == "memcpy" for r in rows),
        breakdown=trace_analysis.temporal_breakdown(trace))
    with open(f"{workdir}/ddp_nccl_{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_children(children: dict, timeout_s: float, what: str, *,
                 while_running=None):
    """Run ``children`` (name -> (argv, env)) side by side through the
    port's launcher (``pmesh().run_group``: each in a process group of its
    own; one that exits nonzero ends the others at once; all end at the
    timeout, cut to the script's deadline), while
    this process runs ``while_running()``. Raises with every failed
    child's exit code and stderr; returns (wall s, ``while_running``'s
    result)."""
    names = list(children)
    box = {}
    t0 = time.perf_counter()
    try:
        out = pmesh().run_group(
            [children[n][0] for n in names], [children[n][1] for n in names],
            timeout_s=phase_timeout(timeout_s, what),
            stdout=subprocess.DEVNULL,
            while_running=None if while_running is None else
            lambda: box.update(result=while_running()))
    except TimeoutError as err:
        raise AssertionError(f"{what}: {err}") from None
    wall = time.perf_counter() - t0
    check_survivors(what)
    failed = {n: (rc, err[-3000:]) for n, (rc, err) in zip(names, out)
              if rc}
    if failed:
        raise AssertionError(f"{what}: exit codes {failed}")
    return wall, box.get("result")


def _rank_children(flags: list, world: int, seed: int, workdir: str,
                   name: str) -> dict:
    """``world`` ranks of this script with ``flags`` (``RANK``,
    ``WORLD_SIZE``, a free 127.0.0.1 port; ``LOCAL_RANK`` 0: they share
    cuda:0), each writing into ``workdir``."""
    port = pmesh().free_port()
    argv = [sys.executable, os.path.abspath(__file__), *flags,
            "--workdir", workdir, "--seed", str(seed)]
    return {f"{name}_rank{r}": (argv, dict(
        os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for r in range(world)}


def _leg_row(leg: dict) -> dict:
    return dict(losses=leg["losses"], ms_per_step=leg["ms_per_step"],
                peak_bytes=leg["peak_bytes"],
                resident_bytes=leg["resident_bytes"] - leg["base_bytes"],
                launches=leg["launches"], collectives=leg["collectives"])


def ddp_nccl_phase(smi, rep: dict, wall: float) -> dict:
    """World 1 on NCCL (``ddp_worker``'s report ``rep``): the four
    strategies' 3 steps through the DistributedTrainer's loop bit-equal to
    the single-device Trainer's (losses and params), K1/K2 launched as
    often; then a Kineto window of two DDP steps: its NCCL kernels (none
    at one rank: NCCL copies or skips a one-rank collective) classed
    communication, its c10d collective rows as many as the step issues.
    ``wall``: the side-by-side run of phases 16-17b (``late_phases``)."""
    ref = rep["trainer"]
    legs = {k: _leg_row(v) for k, v in rep["legs"].items()}
    res = dict(wall_s=wall, backend=rep["backend"],
               trainer=_leg_row(ref), legs=legs, trace=rep["trace"])
    emit(phase="ddp_nccl", nvidia_smi=smi, **res)
    if rep["backend"] != "nccl":
        raise AssertionError(f"ddp_nccl: backend {rep['backend']}")
    for name, leg in rep["legs"].items():
        if leg["losses"] != ref["losses"] or not leg["params_equal"]:
            raise AssertionError(f"ddp_nccl {name}: not bit-equal to the "
                                 f"Trainer: {leg['losses']} vs "
                                 f"{ref['losses']}")
        if leg["launches"] != ref["launches"]:
            raise AssertionError(f"ddp_nccl {name}: K1/K2 {leg['launches']}"
                                 f" vs the Trainer's {ref['launches']}")
        if leg["collectives"] <= 0:
            raise AssertionError(f"ddp_nccl {name}: no collective issued")
    tr = rep["trace"]
    if tr["files"] != 1 or set(tr["nccl_kernel_categories"]) - {
            "communication"}:
        raise AssertionError(f"ddp_nccl trace: {tr}")
    if tr["c10d_ops"] != 2 * tr["collectives_per_step"]:
        raise AssertionError(f"ddp_nccl trace: {tr['c10d_ops']} c10d rows "
                             f"for 2 steps of {tr['collectives_per_step']}"
                             " collectives")
    res["trainer_losses"] = ref["losses"]
    return res


def ddp_gloo2_phase(smi, reps: list, wall: float,
                    one_rank_losses: list) -> dict:
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    card), no_shard over data 2 and full_shard over fsdp 2: both ranks'
    losses equal, each within ``DDP_GLOO2_LOSS_ATOL`` of one rank at the
    same global batch (ddp_nccl's Trainer), K1/K2 12 a step on each rank,
    full_shard's resident params and moments at most
    ``DDP_RESIDENT_RATIO`` of no_shard's on each rank. gloo stages every
    collective through the host: no time here is a claim about NCCL. The
    legs (``_ddp_gloo2_part``) run first in the ranks that then run
    tp_train's (``late_phases``)."""
    legs = {f"{name}_rank{r['rank']}": _leg_row(leg)
            for r in reps for name, leg in r["legs"].items()}
    res = dict(wall_s=wall, backend=reps[0]["backend"], legs=legs,
               one_rank_losses=one_rank_losses,
               max_loss_diff=max(abs(a - b) for leg in legs.values()
                                 for a, b in zip(leg["losses"],
                                                 one_rank_losses)),
               resident_ratio=[
                   legs[f"full_shard_rank{r}"]["resident_bytes"]
                   / legs[f"no_shard_rank{r}"]["resident_bytes"]
                   for r in range(2)])
    emit(phase="ddp_gloo2", nvidia_smi=smi, **res)
    if res["backend"] != "gloo":
        raise AssertionError(f"ddp_gloo2: backend {res['backend']}")
    for name in ("no_shard", "full_shard"):
        a, b = (legs[f"{name}_rank{r}"]["losses"] for r in range(2))
        if a != b:
            raise AssertionError(f"ddp_gloo2 {name}: ranks' losses {a} "
                                 f"vs {b}")
    if res["max_loss_diff"] > DDP_GLOO2_LOSS_ATOL:
        raise AssertionError(f"ddp_gloo2: losses {res['max_loss_diff']} "
                             f"from one rank's {one_rank_losses}")
    want = 12 * DDP_STEPS
    for name, leg in legs.items():
        if leg["launches"] != dict(forward=want, backward=want):
            raise AssertionError(f"ddp_gloo2 {name}: K1/K2 "
                                 f"{leg['launches']}, want {want} each")
    if max(res["resident_ratio"]) > DDP_RESIDENT_RATIO:
        raise AssertionError(f"ddp_gloo2: full_shard resident "
                             f"{res['resident_ratio']} of no_shard's")
    return res


# Tensor-parallel and ZeRO-3 serving (slice 14): two ranks on cuda:0 over
# gloo (NCCL refuses two ranks on one card), each a subprocess of this
# script (``--gloo-worker``). gloo stages every all-reduce through the host:
# no time here is a claim about NCCL or NVLink.
TP_WORLD = 2
# f32: the first decode tick's logits of the TP engine against the
# one-rank engine's (each row-parallel sum split in two: summation order
# only), and the rows whose tokens must be equal (a near-tie may flip).
TP_F32_LOGITS_ATOL = 1e-4
TP_F32_MIN_EQUAL = 15
# bf16 and int8: the relative logit MSE of the first decode tick against
# the one-rank engine's (the int8 quality budget).
TP_MSE_LIMIT = 2e-3
TP_LLAMA_LAYERS = 4  # Llama-3.2-1B widths, depth cut to 4 layers
TP_LORA_REQUESTS = 8
TP_ZERO3_NEW = 8


def _tp_models(seed: int, dev):
    """(GPT-2 124M f32 config, bf16 config, their params; Llama-3.2-1B at
    4 layers and its params): the weights every rank draws alike from
    ``seed``, as the one-rank phases draw them."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama

    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    lcfg = model_config("llama3-1b", n_layer=TP_LLAMA_LAYERS)
    lparams = llama.init(torch.Generator(device=dev).manual_seed(seed),
                         lcfg, device=dev)
    return cfg.replace(dtype="float32"), cfg, params, lcfg, lparams


def _watch_first_tick(eng) -> dict:
    """Keep the live rows' logits of ``eng``'s first decode forward (a
    host copy) and the all-reduces of every decode forward."""
    from pytorch_distributed_tpu_torch.ops import tp

    box = {"decode_allreduces": []}
    forward = eng._forward

    def watched(params, ids, pos, *args, **kw):
        c0 = tp.collectives
        out = forward(params, ids, pos, *args, **kw)
        if kw.get("window"):
            box["decode_allreduces"].append(tp.collectives - c0)
            if "logits" not in box:
                live = torch.from_numpy(np.asarray(pos) > 0)
                box["logits"] = out[live.to(out.device), -1].float().cpu()
        return out

    eng._forward = watched
    return box


def _tp_drive(cfg, params, reqs, pk, lk=None, mesh_cfg=None, **engine_kw):
    """One drive of ``reqs`` through a fresh warmed paged engine (8 slots,
    max_len 1024, 16-token pages, the kernel path), with every kernel
    counter from zero for the drive and the all-reduce host time summed:
    tokens, first-tick logits and counts."""
    from pytorch_distributed_tpu_torch.ops import tp
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024, page_size=16,
                                   paged_attention="kernel",
                                   mesh_cfg=mesh_cfg, **engine_kw)
    eng.warmup(params)
    box = _watch_first_tick(eng)
    all_reduce, held = tp._all_reduce_, [0.0]

    def timed(t, group):
        s = time.perf_counter()
        out = all_reduce(t, group)
        held[0] += time.perf_counter() - s
        return out

    tp._all_reduce_ = timed
    pk.launches = pk.launches_q8 = 0
    if lk is not None:
        lk.launches = 0
    c0 = tp.collectives
    try:
        run = drive_engine(eng, params, reqs)
    finally:
        tp._all_reduce_ = all_reduce
    c = eng.counters
    return dict(
        tokens=[t.tolist() for t in run["tokens"]],
        logits=box.get("logits"),
        counts=dict(K3=pk.launches, K4=pk.launches_q8,
                    lora=None if lk is None else lk.launches,
                    decode_ticks=c["decode_ticks"],
                    prefill_ticks=c["prefill_ticks"],
                    allreduces=tp.collectives - c0,
                    decode_allreduces=sorted(set(box["decode_allreduces"]))),
        pool_bytes=sum(t.numel() * t.element_size()
                       for t in eng._cache.values()),
        metrics={k: run["metrics"][k] for k in (
            "mean_decode_tick_ms", "generated_tok_per_s", "wall_s",
            "ttft_p50_ms", "decode_ticks")},
        allreduce_host_s=held[0],
    )


def gloo_worker(parts: list, workdir: str, seed: int) -> int:
    """One of two gloo ranks on cuda:0 (``late_phases`` runs two such
    pairs side by side): each of ``parts`` (``GLOO_PARTS``) in turn, each
    writing its report, with its own wall, to ``<part>_<rank>.json``."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.parallel.mesh import (
        initialize_distributed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_distributed(device=dev, backend="gloo",
                           timeout_s=RANK_GROUP_TIMEOUT_S)
    rank = dist.get_rank()
    for part in parts:
        t0 = time.perf_counter()
        out = GLOO_PARTS[part](dev, seed, workdir, rank)
        out.update(rank=rank, world=dist.get_world_size(),
                   backend=dist.get_backend(),
                   wall_s=time.perf_counter() - t0)
        with open(f"{workdir}/{part}_{rank}.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _ddp_gloo2_part(dev, seed: int, workdir: str, rank: int) -> dict:
    """ddp_gloo2's legs (``_ddp_legs``): no_shard over data 2, full_shard
    over fsdp 2."""
    from pytorch_distributed_tpu_torch.models import get_model

    cfg, tcfg, loader = _ddp_model(seed, TP_WORLD)
    return dict(legs=_ddp_legs(get_model(cfg), cfg, tcfg, loader, dev,
                               TP_WORLD, ("no_shard", "full_shard")))


def _tp_serve_part(dev, seed: int, workdir: str, rank: int) -> dict:
    """tp_serve's legs: GPT-2 124M f32 and bf16 on the TP paged engine
    (MeshConfig(tensor=2)), Llama-3.2-1B at 4 layers with int8 pages and
    weights, GPT-2 f32 with 4 LoRA tenants (the mix and each tenant
    alone), and the ZeRO-3 serial engine (MeshConfig(fsdp=2)) against the
    plain one; also gloo's all-reduce of CUDA tensors probed in f32 and
    bf16, and the first-tick logits written to ``tp_serve_<rank>.npz``."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.ops import lora_kernel as lk
    from pytorch_distributed_tpu_torch.ops import paged_kernel as pk
    from pytorch_distributed_tpu_torch.serving.engine import DecodeEngine

    # gloo on CUDA tensors: f32 and bf16 sums staged through the host.
    probes = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.full((4,), 1.5, dtype=dtype, device=dev)
        try:
            dist.all_reduce(t)
            probes[str(dtype).replace("torch.", "")] = t.tolist()
        except RuntimeError as err:
            probes[str(dtype).replace("torch.", "")] = repr(err)[:300]
    out = dict(gloo_cuda_all_reduce=probes, legs={})
    f32, bf16, params, lcfg, lparams = _tp_models(seed, dev)
    tp2, z3 = MeshConfig(tensor=TP_WORLD), MeshConfig(fsdp=TP_WORLD)
    logits = {}
    legs = (("gpt2_f32", f32, params, requests(f32, seed), {}),
            ("gpt2_bf16", bf16, params, requests(bf16, seed), {}),
            ("llama_q8", lcfg, lparams, requests(lcfg, seed), Q8))
    for name, cfg, prm, reqs, quant in legs:
        t0 = time.perf_counter()
        leg = _tp_drive(cfg, prm, reqs, pk, mesh_cfg=tp2, device=dev,
                        **quant)
        leg["wall_s"] = time.perf_counter() - t0
        logits[name] = leg.pop("logits").numpy()
        out["legs"][name] = leg
    # LoRA tenants on the TP engine: the mix, then each tenant alone.
    t0 = time.perf_counter()
    reg = lora_registry(f32, seed)
    reqs = lora_requests(f32, seed, n=TP_LORA_REQUESTS)
    mix = _tp_drive(f32, params, reqs, pk, lk, mesh_cfg=tp2, device=dev,
                    adapters=reg)
    mix.pop("logits")
    alone = {}
    for i in range(4):
        tid = f"tenant-{i}"
        rows = [j for j, r in enumerate(reqs) if r.get("tenant") == tid]
        got = _tp_drive(f32, params, [reqs[j] for j in rows], pk, lk,
                        mesh_cfg=tp2, device=dev, adapters=reg)
        alone[tid] = dict(rows=rows, tokens=got["tokens"],
                          counts=got["counts"])
    out["legs"]["lora"] = dict(mix, alone=alone,
                               wall_s=time.perf_counter() - t0)
    # ZeRO-3: the serial engine from this rank's full_shard slices.
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 14)
    prompt = rng.integers(0, f32.vocab_size, (2, 48)).astype(np.int32)
    max_len = prompt.shape[1] + TP_ZERO3_NEW
    from pytorch_distributed_tpu_torch.parallel import zero

    c0 = zero.collectives
    z = DecodeEngine(f32, max_len=max_len, mesh_cfg=z3, device=dev
                     ).generate(params, prompt, TP_ZERO3_NEW)
    gathers = zero.collectives - c0
    plain = DecodeEngine(f32, max_len=max_len, device=dev).generate(
        params, prompt, TP_ZERO3_NEW)
    out["legs"]["zero3"] = dict(tokens=z.tolist(), plain=plain.tolist(),
                                all_gathers=gathers,
                                wall_s=time.perf_counter() - t0)
    np.savez(f"{workdir}/tp_serve_{rank}.npz", **logits)
    return out


def _read_part(tmp: str, part: str) -> list:
    """Each rank's report of ``gloo_worker``'s ``part``."""
    out = []
    for r in range(TP_WORLD):
        with open(f"{tmp}/{part}_{r}.json") as f:
            out.append(json.load(f))
    return out


def _one_rank_refs(pk, seed, dev) -> dict:
    """The one-rank paged engine on the same weights and requests: GPT-2
    f32 (tokens and first-tick logits), GPT-2 bf16 and Llama at 4 layers
    int8 (first-tick logits: their drives stop after the first decode
    tick)."""
    f32, bf16, params, lcfg, lparams = _tp_models(seed, dev)
    full = _tp_drive(f32, params, requests(f32, seed), pk, device=dev)
    refs = dict(gpt2_f32=dict(tokens=full["tokens"], logits=full["logits"],
                              pool_bytes=full["pool_bytes"]))
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    for name, cfg, prm, quant in (("gpt2_bf16", bf16, params, {}),
                                  ("llama_q8", lcfg, lparams, Q8)):
        eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024,
                                       page_size=16,
                                       paged_attention="kernel", **quant)
        eng.warmup(prm)
        box = _watch_first_tick(eng)
        for r in requests(cfg, seed):
            eng.submit(**r)
        while "logits" not in box:
            eng.step(prm)
        refs[name] = dict(logits=box["logits"],
                          pool_bytes=sum(t.numel() * t.element_size()
                                         for t in eng._cache.values()))
        del eng
    del params, lparams
    torch.cuda.empty_cache()
    return refs


def tp_serve_phase(smi, reports: list, logits: list, wall: float,
                   refs: dict, refs_s: float) -> dict:
    """Tensor-parallel serving on two gloo ranks sharing cuda:0
    (``_tp_serve_part``) against the one-rank paged engine on the same weights
    (``_one_rank_refs``). Gates: GPT-2 f32 tokens equal in >= 15 of 16
    rows and the first tick's logits within ``TP_F32_LOGITS_ATOL``; bf16
    and the int8 Llama's first-tick relative logit MSE <= 2e-3; both
    ranks' tokens identical in every leg; each decode tick's kernel (K3,
    K4 for int8 pages) launched n_layer times on each rank, the other 0;
    2 x n_layer all-reduces every decode tick, int8 and adapters alike;
    each rank's pool half the one-rank pool; LoRA rows equal their tenant
    alone with 2 x n_layer LoRA launches a forward; the ZeRO-3 serial
    engine's tokens equal the plain engine's. Tick ms, all-reduce host
    time and wall are reported, not gated (gloo on one card). ``wall``:
    the side-by-side run of phases 16-17b; ``refs``: the one-rank
    engine's, run meanwhile (``late_phases``)."""
    rep = reports[0]
    res = dict(wall_s=wall, refs_s=refs_s,
               rank_legs_s=[sum(leg["wall_s"] for leg in r["legs"].values())
                            for r in reports],
               world=TP_WORLD, backend="gloo",
               gloo_cuda_all_reduce=rep["gloo_cuda_all_reduce"],
               rank_wall_s=[r["wall_s"] for r in reports], legs={})
    failures = []
    n_layer = {"gpt2_f32": 12, "gpt2_bf16": 12, "llama_q8": TP_LLAMA_LAYERS,
               "lora": 12}
    for name, leg in rep["legs"].items():
        same_ranks = all(r["legs"][name].get("tokens")
                         == leg.get("tokens") for r in reports)
        row = dict(ranks_identical=same_ranks,
                   wall_s=[r["legs"][name]["wall_s"] for r in reports])
        if not same_ranks:
            failures.append(f"{name}: the ranks' tokens differ")
        if "counts" in leg:
            c, nl = leg["counts"], n_layer[name]
            kid = "K4" if name == "llama_q8" else "K3"
            other = "K3" if kid == "K4" else "K4"
            row.update(counts=c, metrics=leg["metrics"],
                       allreduce_host_s=[r["legs"][name]["allreduce_host_s"]
                                         for r in reports],
                       pool_bytes=leg["pool_bytes"])
            if c[kid] != nl * c["decode_ticks"] or c[other]:
                failures.append(f"{name}: {kid} {c[kid]} / {other} "
                                f"{c[other]} for {c['decode_ticks']} ticks "
                                f"of {nl} layers")
            if c["decode_allreduces"] != [2 * nl]:
                failures.append(f"{name}: all-reduces a decode tick "
                                f"{c['decode_allreduces']}, want {2 * nl}")
            if c["allreduces"] != 2 * nl * (c["decode_ticks"]
                                            + c["prefill_ticks"]):
                failures.append(f"{name}: {c['allreduces']} all-reduces "
                                f"for {c['decode_ticks']} + "
                                f"{c['prefill_ticks']} forwards")
        if name in refs:
            ref = refs[name]
            ours = logits[0][name]
            row["pool_bytes_one_rank"] = ref["pool_bytes"]
            if 2 * leg["pool_bytes"] != ref["pool_bytes"]:
                failures.append(f"{name}: pool {leg['pool_bytes']} B a "
                                f"rank, one rank {ref['pool_bytes']} B")
            theirs = ref["logits"].numpy()
            if name == "gpt2_f32":
                same = sum(a == b for a, b in zip(leg["tokens"],
                                                  ref["tokens"]))
                err = float(np.abs(ours - theirs).max())
                row.update(equal_rows=same, of=len(ref["tokens"]),
                           first_tick_max_abs_err=err)
                if same < TP_F32_MIN_EQUAL or err > TP_F32_LOGITS_ATOL:
                    failures.append(f"{name}: {same} rows equal, logits "
                                    f"max |diff| {err}")
            else:
                from pytorch_distributed_tpu_torch.ops.quant import (
                    relative_logit_mse,
                )

                mse = relative_logit_mse(theirs, ours)
                row["first_tick_relative_logit_mse"] = mse
                if mse > TP_MSE_LIMIT:
                    failures.append(f"{name}: relative logit MSE {mse}")
        if name == "lora":
            nl = n_layer[name]
            forwards = c["decode_ticks"] + c["prefill_ticks"]
            if c["lora"] != 2 * nl * forwards:
                failures.append(f"lora: {c['lora']} LoRA launches for "
                                f"{forwards} forwards")
            alone_equal = 0
            for tid, a in leg["alone"].items():
                for j, toks in zip(a["rows"], a["tokens"]):
                    alone_equal += toks == leg["tokens"][j]
                ac = a["counts"]
                if ac["lora"] != 2 * nl * (ac["decode_ticks"]
                                           + ac["prefill_ticks"]):
                    failures.append(f"lora {tid} alone: {ac}")
            n_tenanted = sum(len(a["rows"]) for a in leg["alone"].values())
            row.update(rows_equal_alone=alone_equal, tenanted=n_tenanted)
            if alone_equal != n_tenanted:
                failures.append(f"lora: {alone_equal} of {n_tenanted} rows "
                                "equal their tenant alone")
        if name == "zero3":
            row.update(all_gathers=leg["all_gathers"],
                       equal=leg["tokens"] == leg["plain"])
            if leg["tokens"] != leg["plain"]:
                failures.append("zero3: tokens differ from the plain "
                                "DecodeEngine's")
        res["legs"][name] = row
    emit(phase="tp_serve", nvidia_smi=smi, failures=failures, **res)
    if failures:
        raise AssertionError(f"tp_serve: {failures}")
    return res


# Tensor-parallel training (slice 15): the ``--gloo-worker`` ranks' last
# legs, through the ``DistributedTrainer`` at MeshConfig(tensor=2). GPT-2
# 124M at full width on ddp_nccl's batches (ddp_nccl's single-device
# ``Trainer`` is its one-rank reference); Llama-3.2-1B widths at 4 layers,
# T 4096, its one-rank ``Trainer`` run by this script meanwhile.
TP_TRAIN_LLAMA_LAYERS = 4
TP_TRAIN_LLAMA_T = 4096
TP_TRAIN_LLAMA_STEPS = 2


def _tp_train_llama(seed: int, t: int = TP_TRAIN_LLAMA_T):
    """(config, train config, loader) of the Llama leg: ``llama_cfg``
    (bf16 params and activations, flash, names, the fused head CE) at 4
    layers, B 1, T ``t``, 2 steps."""
    from pytorch_distributed_tpu_torch.config import TrainConfig

    cfg = llama_cfg(n_layer=TP_TRAIN_LLAMA_LAYERS)
    n = TP_TRAIN_LLAMA_STEPS
    tcfg = TrainConfig(global_batch_size=1, micro_batch_size=1, num_steps=n,
                       learning_rate=3e-4, seed=seed, log_every_n_steps=1)
    rng = np.random.default_rng(seed + 15)
    loader = [(rng.integers(0, cfg.vocab_size, (1, t)),
               rng.integers(0, cfg.vocab_size, (1, t))) for _ in range(n)]
    return cfg, tcfg, loader


def _tp_checkpoint(trainer, state, cfg, path: str, rank: int) -> dict:
    """``state`` (laid out over the trainer's mesh: tensor 2, or seq 2)
    saved in the port's sharded format by every rank; rank 0 restores it
    on one rank (no sharding: the whole state) into a zeroed state and
    holds it bit for bit to the state gathered over the ranks."""
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    t0 = time.perf_counter()
    ckpt.save_checkpoint(path, state, cfg, format="orbax",
                         sharding=trainer.sharding,
                         metadata={"step": state.step})
    out = dict(save_s=time.perf_counter() - t0,
               files=sorted(os.listdir(f"{path}/tree")))
    full = ckpt.gather_state(state, trainer.sharding)
    if rank == 0:
        zeros = tree.unflatten(full.params, [torch.zeros_like(t) for t in
                                             tree.leaves(full.params)])
        t0 = time.perf_counter()
        got = ckpt.load_checkpoint(path, init_train_state(zeros, trainer.tx),
                                   cfg)
        out["load_s"] = time.perf_counter() - t0

        def leaves(s):
            return tree.leaves([s.params, s.opt_state["mu"],
                                s.opt_state["nu"]])

        out.update(
            leaves=len(leaves(full)), step=got.step,
            bit_equal=(all(torch.equal(a, b) for a, b in
                           zip(leaves(got), leaves(full)))
                       and got.step == full.step
                       and got.opt_state["count"] == full.opt_state["count"]))
    return out


def _tp_train_part(dev, seed: int, workdir: str, rank: int) -> dict:
    """GPT-2 (3 steps) and the Llama leg (2 steps) through the
    ``DistributedTrainer`` at MeshConfig(tensor=2): losses, K1/K2
    launches, all-reduces (``ops/tp``) and other collectives
    (``parallel/zero``), ms a step, resident and peak bytes; GPT-2's
    state then through ``_tp_checkpoint``."""
    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import tp
    from pytorch_distributed_tpu_torch.parallel import zero
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )

    mcfg = MeshConfig(tensor=TP_WORLD, strategy="no_shard")
    legs = {}
    for name, (cfg, tcfg, loader) in (("gpt2", _ddp_model(seed, 1)),
                                      ("llama", _tp_train_llama(seed))):
        t0 = time.perf_counter()
        trainer = DistributedTrainer(get_model(cfg), cfg, tcfg,
                                     make_mesh(mcfg, device=dev), mcfg,
                                     log_fn=lambda s: None)
        c0 = tp.collectives
        leg = _ddp_leg(trainer, loader, fk, zero)
        leg["tp_allreduces"] = tp.collectives - c0
        state = leg.pop("state")
        if name == "gpt2":
            leg["checkpoint"] = _tp_checkpoint(
                trainer, state, cfg, f"{workdir}/tp_ckpt", rank)
        leg["wall_s"] = time.perf_counter() - t0
        legs[name] = leg
        del trainer, state
        torch.cuda.empty_cache()
    return dict(legs=legs)


# Sequence-parallel training (slice 16): phase 17c's legs, each
# ``SEQ_STEPS`` steps through the ``DistributedTrainer`` at
# MeshConfig(seq=2) on the 17b pair of gloo ranks: (name, seq_impl,
# model) — GPT-2 124M on ddp_nccl's batches, the Llama leg of 17b at T
# 4096 (the ring: a block's f32 scores are [1, 32, 2048, 2048], 537 MB)
# and at T 8192 (Ulysses: K1/K2 at 16 over 4 heads, the whole T).
SEQ_STEPS = 2
SEQ_ULYSSES_LLAMA_T = 8192
SEQ_LEGS = (("gpt2_ring", "ring", "gpt2"),
            ("gpt2_ulysses", "ulysses", "gpt2"),
            ("llama_ring", "ring", TP_TRAIN_LLAMA_T),
            ("llama_ulysses", "ulysses", SEQ_ULYSSES_LLAMA_T))


def seq_counts(impl: str, n_layer: int) -> dict:
    """K1 and K2 launches, ring exchanges and all-to-alls a step on each
    rank at seq 2, A = 1, ``names`` remat, as the code gives them. Ulysses
    (``ops/ulysses``): K1 and K2 once a layer (``names`` keeps the flash
    op's (o, lse): the recompute launches no K1), and four all-to-alls a
    layer (q, k, v, the output) in each of the forward, the recompute and
    the backward. The ring (``ops/ring_attention``): no kernel, and n - 1
    = 1 exchange a layer in each of the three."""
    if impl == "ulysses":
        return dict(K1=n_layer, K2=n_layer, exchanges=0,
                    all_to_alls=12 * n_layer)
    return dict(K1=0, K2=0, exchanges=3 * n_layer, all_to_alls=0)


def _seq_model(seed: int, model):
    """(config, train config, loader) of a ``SEQ_LEGS`` model."""
    if model == "gpt2":
        cfg, tcfg, loader = _ddp_model(seed, 1)
        return (cfg, dataclasses.replace(tcfg, num_steps=SEQ_STEPS),
                loader[:SEQ_STEPS])
    return _tp_train_llama(seed, t=model)


def _seq_train_part(dev, seed: int, workdir: str, rank: int) -> dict:
    """Each ``SEQ_LEGS`` leg at MeshConfig(seq=2): losses, K1/K2
    launches, ring exchanges, all-to-alls, ms a step, resident and peak
    bytes; the GPT-2 ring leg's state through ``_tp_checkpoint``."""
    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import ring_attention, ulysses
    from pytorch_distributed_tpu_torch.parallel import zero
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )

    mcfg = MeshConfig(seq=TP_WORLD, strategy="no_shard")
    legs = {}
    for name, impl, model in SEQ_LEGS:
        cfg, tcfg, loader = _seq_model(seed, model)
        cfg = cfg.replace(seq_impl=impl)
        t0 = time.perf_counter()
        trainer = DistributedTrainer(get_model(cfg), cfg, tcfg,
                                     make_mesh(mcfg, device=dev), mcfg,
                                     log_fn=lambda s: None)
        c0 = (ring_attention.exchanges, ulysses.all_to_alls)
        leg = _ddp_leg(trainer, loader, fk, zero)
        leg.update(exchanges=ring_attention.exchanges - c0[0],
                   all_to_alls=ulysses.all_to_alls - c0[1],
                   n_layer=cfg.n_layer, T=loader[0][0].shape[1])
        state = leg.pop("state")
        if name == "gpt2_ring":
            leg["checkpoint"] = _tp_checkpoint(
                trainer, state, cfg, f"{workdir}/seq_ckpt", rank)
        leg["wall_s"] = time.perf_counter() - t0
        legs[name] = leg
        del trainer, state
        torch.cuda.empty_cache()
    return dict(legs=legs)


# ``gloo_worker``'s parts: each phase's legs on a pair of gloo ranks.
GLOO_PARTS = {"tp_serve": _tp_serve_part, "ddp_gloo2": _ddp_gloo2_part,
              "tp_train": _tp_train_part, "seq_train": _seq_train_part}


def _tp_train_llama_ref(fk, seed: int, dev,
                        t: int = TP_TRAIN_LLAMA_T) -> dict:
    """The Llama leg at T ``t`` on one rank: the single-device
    ``Trainer`` on the same batches."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel import zero
    from pytorch_distributed_tpu_torch.train.trainer import Trainer

    cfg, tcfg, loader = _tp_train_llama(seed, t=t)
    leg = _ddp_leg(Trainer(get_model(cfg), cfg, tcfg, device=dev,
                           log_fn=lambda s: None), loader, fk, zero)
    del leg["state"]
    torch.cuda.empty_cache()
    return _leg_row(leg)


def tp_train_phase(smi, reports: list, one_rank: dict) -> dict:
    """Tensor-parallel training on the two gloo ranks sharing cuda:0
    (``_tp_train_part``) against one rank on the same batches
    (``one_rank``: ``_leg_row``s by leg). Gates: both ranks' losses
    identical; each within ``DDP_GLOO2_LOSS_ATOL`` of one rank's (bf16:
    sums over other shapes and orders), finite; K1 and K2 launched on
    every rank; the GPT-2 state saved at tensor 2 restores at tensor 1 bit
    for bit. Reported: K1/K2 launches, all-reduces and other collectives a
    step on each rank (12, 12 and 4 x n_layer expected), ms a step and
    resident bytes against one rank's (gloo stages every all-reduce
    through the host: no NCCL claim)."""
    res = dict(world=TP_WORLD, backend=reports[0]["backend"], legs={})
    failures = []
    for name, ref in one_rank.items():
        rows = [r["legs"][name] for r in reports]
        steps = len(ref["losses"])
        losses = rows[0]["losses"]
        diff = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
        row = dict(
            losses=losses, one_rank_losses=ref["losses"],
            max_loss_diff=diff,
            ranks_identical=all(r["losses"] == losses for r in rows),
            launches=[r["launches"] for r in rows],
            launches_per_step=[{k: v / steps for k, v in
                                r["launches"].items()} for r in rows],
            tp_allreduces_per_step=[r["tp_allreduces"] / steps
                                    for r in rows],
            collectives_per_step=[r["collectives"] / steps for r in rows],
            ms_per_step=[r["ms_per_step"] for r in rows],
            one_rank_ms_per_step=ref["ms_per_step"],
            resident_bytes=[r["resident_bytes"] - r["base_bytes"]
                            for r in rows],
            one_rank_resident_bytes=ref["resident_bytes"],
            peak_bytes=[r["peak_bytes"] for r in rows],
            one_rank_peak_bytes=ref["peak_bytes"],
            wall_s=[r["wall_s"] for r in rows])
        row["resident_ratio"] = [b / ref["resident_bytes"]
                                 for b in row["resident_bytes"]]
        if not row["ranks_identical"]:
            failures.append(f"{name}: the ranks' losses differ: "
                            f"{[r['losses'] for r in rows]}")
        if not np.isfinite(losses).all() or diff > DDP_GLOO2_LOSS_ATOL:
            failures.append(f"{name}: losses {losses} vs one rank's "
                            f"{ref['losses']}")
        if not all(r["launches"]["forward"] and r["launches"]["backward"]
                   for r in rows):
            failures.append(f"{name}: K1/K2 not launched on every rank: "
                            f"{row['launches']}")
        if "checkpoint" in rows[0]:
            ck = row["checkpoint"] = rows[0]["checkpoint"]
            if not ck.get("bit_equal"):
                failures.append(f"{name}: the tensor-2 save restored at "
                                f"tensor 1 is not bit-equal: {ck}")
        res["legs"][name] = row
    emit(phase="tp_train", nvidia_smi=smi, failures=failures, **res)
    if failures:
        raise AssertionError(f"tp_train: {failures}")
    return res


def seq_train_phase(smi, reports: list, one_rank: dict) -> dict:
    """Sequence-parallel training on the two gloo ranks sharing cuda:0
    (``_seq_train_part``) against one rank on the same batches
    (``one_rank``: ``_leg_row``s by leg). Gates: both ranks' losses
    identical, within ``DDP_GLOO2_LOSS_ATOL`` of one rank's, finite; K1/K2
    launches, ring exchanges and all-to-alls a step on each rank equal to
    ``seq_counts``; the GPT-2 ring state saved at seq 2 restored on one
    rank bit for bit. Reported: ms a step (contended) and bytes."""
    res = dict(world=TP_WORLD, backend=reports[0]["backend"], legs={})
    failures = []
    for name, impl, _ in SEQ_LEGS:
        ref = one_rank[name]
        rows = [r["legs"][name] for r in reports]
        steps = len(rows[0]["losses"])
        losses = rows[0]["losses"]
        ref_losses = ref["losses"][:steps]
        diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
        want = seq_counts(impl, rows[0]["n_layer"])
        per_step = [dict(K1=r["launches"]["forward"] / steps,
                         K2=r["launches"]["backward"] / steps,
                         exchanges=r["exchanges"] / steps,
                         all_to_alls=r["all_to_alls"] / steps)
                    for r in rows]
        row = dict(
            seq_impl=impl, T=rows[0]["T"], losses=losses,
            one_rank_losses=ref_losses, max_loss_diff=diff,
            ranks_identical=all(r["losses"] == losses for r in rows),
            launches=[r["launches"] for r in rows],
            per_step=per_step, derived_per_step=want,
            ms_per_step=[r["ms_per_step"] for r in rows],
            one_rank_ms_per_step=ref["ms_per_step"][:steps],
            resident_bytes=[r["resident_bytes"] - r["base_bytes"]
                            for r in rows],
            peak_bytes=[r["peak_bytes"] for r in rows],
            wall_s=[r["wall_s"] for r in rows])
        if not row["ranks_identical"]:
            failures.append(f"{name}: the ranks' losses differ: "
                            f"{[r['losses'] for r in rows]}")
        if not np.isfinite(losses).all() or diff > DDP_GLOO2_LOSS_ATOL:
            failures.append(f"{name}: losses {losses} vs one rank's "
                            f"{ref_losses}")
        if any(p != want for p in per_step):
            failures.append(f"{name}: a step's counts {per_step}, derived "
                            f"{want}")
        if "checkpoint" in rows[0]:
            ck = row["checkpoint"] = rows[0]["checkpoint"]
            if not ck.get("bit_equal"):
                failures.append(f"{name}: the seq-2 save restored on one "
                                f"rank is not bit-equal: {ck}")
        res["legs"][name] = row
    emit(phase="seq_train", nvidia_smi=smi, failures=failures, **res)
    if failures:
        raise AssertionError(f"seq_train: {failures}")
    return res


def late_phases(pk, fk, seed: int, dev, smi) -> dict:
    """Phases 16 (ddp_nccl), 16b (ddp_gloo2), 17 (tp_serve), 17b
    (tp_train) and 17c (seq_train), with the decode_bench twin's runs that
    gate nothing on time (``DecodeBenchRun.side_by_side``), side by side
    (``run_children``): ddp_nccl's NCCL rank, two pairs of gloo ranks on
    cuda:0 (``gloo_worker``: one runs tp_serve, the other ddp_gloo2,
    tp_train then seq_train) and five decode_bench runs — while this
    process runs the one-rank references (tp_serve's engines, the Llama
    training leg at T 4096 and at T 8192). The GPT-2 training legs'
    one-rank reference is ddp_nccl's ``Trainer``.
    The storm (15) runs beside them too (``storm_in_background``, started
    by the caller). Every time these phases report is taken with the
    others beside it: contended, not a measure of one phase alone."""
    def references():
        t0 = time.perf_counter()
        serve = _one_rank_refs(pk, seed, dev)
        serve_s = time.perf_counter() - t0
        return dict(serve=serve, serve_s=serve_s,
                    llama=_tp_train_llama_ref(fk, seed, dev),
                    llama_long=_tp_train_llama_ref(
                        fk, seed, dev, t=SEQ_ULYSSES_LLAMA_T))

    side_by_side = [name for name, run in DECODE_BENCH_RUNS.items()
                    if run.side_by_side]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        children = {**_rank_children(["--ddp-worker", "nccl"], 1, seed, tmp,
                                     "ddp_nccl"),
                    **_rank_children(["--gloo-worker", "tp_serve"],
                                     TP_WORLD, seed, tmp, "tp_serve"),
                    **_rank_children(
                        ["--gloo-worker", "ddp_gloo2,tp_train,seq_train"],
                        TP_WORLD, seed, tmp, "tp_train"),
                    **{name: decode_bench_child(name, tmp)
                       for name in side_by_side}}
        wall, refs = run_children(children, 900, "phases 16-17b",
                                  while_running=references)
        with open(f"{tmp}/ddp_nccl_0.json") as f:
            nccl = json.load(f)
        reports = {part: _read_part(tmp, part) for part in GLOO_PARTS}
        logits = []
        for r in range(TP_WORLD):
            with np.load(f"{tmp}/tp_serve_{r}.npz") as z:
                logits.append({k: z[k] for k in z.files})
        bench = {}
        for name in side_by_side:
            with open(f"{tmp}/{name}.json") as f:
                bench[name] = json.load(f)
    emit(phase="side_by_side", nvidia_smi=smi, wall_s=wall,
         children=list(children))
    for name, rows in bench.items():
        emit_decode_bench_run(smi, name, rows, wall, True)
    out = dict(decode_bench=bench, ddp_nccl=ddp_nccl_phase(smi, nccl, wall))
    out.update(
        ddp_gloo2=ddp_gloo2_phase(smi, reports["ddp_gloo2"], wall,
                                  out["ddp_nccl"]["trainer_losses"]),
        tp=tp_serve_phase(smi, reports["tp_serve"], logits, wall,
                          refs["serve"], refs["serve_s"]),
        tp_train=tp_train_phase(smi, reports["tp_train"], dict(
            gpt2=out["ddp_nccl"]["trainer"], llama=refs["llama"])))
    gpt2 = out["ddp_nccl"]["trainer"]
    out["seq_train"] = seq_train_phase(smi, reports["seq_train"], dict(
        gpt2_ring=gpt2, gpt2_ulysses=gpt2, llama_ring=refs["llama"],
        llama_ulysses=refs["llama_long"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ddp-worker", choices=["nccl"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--gloo-worker", type=lambda v: v.split(","),
                    help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ddp_worker or args.gloo_worker:
        # A rank dies with this script's process (PR_SET_PDEATHSIG).
        pmesh().bind_to_parent()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script measures the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.ddp_worker:
        return ddp_worker(args.workdir, args.seed)
    if args.gloo_worker:
        return gloo_worker(args.gloo_worker, args.workdir, args.seed)
    # SIGTERM / SIGINT kill every child's process group, then end this
    # script nonzero; atexit kills what is left at any other end.
    pmesh().install_exit_handlers("chip_smoke")
    # libtorch symbolizes C++ frames (the memory phase's allocator history)
    # through addr2line helper processes it keeps for the life of the
    # process; dladdr symbolizes in the process, so that no process is
    # left below this one for the survivors checks to find.
    os.environ["TORCH_DISABLE_ADDR2LINE"] = "1"
    os.environ["TORCH_SYMBOLIZE_MODE"] = "dladdr"
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.ops import _build
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import paged_kernel as pk

    # 1. env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    proc = pmesh().run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], timeout=60)
    if proc.returncode:
        raise AssertionError(f"nvidia-smi exited {proc.returncode}: "
                             f"{proc.stdout}")
    smi = proc.stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit(phase="env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    # 2. build: one nvcc per source, all started together
    sources = ("paged_attention", "flash_attention", "lora_delta")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    ptxas = {name: ptxas_summary(built["log"])
             for name, built in builds.items()}
    emit(phase="build", wall_s=time.perf_counter() - t0, kernels={
        name: dict(seconds=built["seconds"], cached=built["cached"],
                   ptxas=ptxas[name])
        for name, built in builds.items()
    })
    spilled = [k for k, v in ptxas["flash_attention"].items()
               if "sm90<64>" in k and v["spill_bytes"]]
    if spilled:
        raise AssertionError(f"bf16 flash kernels spill at D 64: {spilled}")
    paged = ptxas["paged_attention"]
    spilled = [k for k, v in paged.items() if v["spill_bytes"]]
    if (len(paged) != 48 and not builds["paged_attention"]["cached"]) or \
            spilled:
        raise AssertionError(
            f"paged kernels: {len(paged)} of 48 instantiations in the "
            f"ptxas log, spilling: {spilled}"
        )

    # 3. kernel at the listed shapes; K3/K4 on two streams at once
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tp_kernel_rows = kernel_phase(pk, dev, flush, args.seed)
    streams_phase(pk, dev, args.seed)

    # 13a. the profiler's trace windows, first: they are held to the
    # wrappers' launch counters, and a scheduled window late in a process
    # that has done much work can lose its first launches (PERF.md
    # section 7)
    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(args.seed), cfg)
    reqs = requests(cfg, args.seed)
    prof_train = profiling_train_phase(fk, args.seed, smi)
    prof_paged = dict(
        K3=profiling_serve_phase(pk, cfg, params, reqs, smi),
        K4=profiling_serve_phase(pk, cfg, params, reqs, smi, **Q8))
    torch.cuda.empty_cache()

    # 7. flash kernels at the listed shapes, then at the llama training
    # phases' long-context shapes; with 8 and 9, before the serving phases,
    # as their per-kernel profiles (device_kernels) are counted too
    tp_flash_rows = flash_phase(fk, dev, flush, args.seed)
    flash_long = flash_long_phase(fk, dev, flush, args.seed)

    # 8. training: the main path
    tcfg_model = cfg.replace(attention_impl="flash", remat="names",
                             logits_dtype="bfloat16", attn_pdrop=0.0,
                             resid_pdrop=0.0, embd_pdrop=0.0)
    run = train_phase(fk, tcfg_model, args.seed, dev)
    train_launches = run["launches"]
    fq, fkk, fv, fo, flse, fdo, causal = run["captured"][:7]
    checked = check_flash(fk, fq, fkk, fv, fdo, causal,
                          "main-path inputs bf16")
    timed = time_flash(fk, fq, fkk, fv, fdo, causal, flush)

    # 9. profile of the training step, then the step under the other
    # remat modes
    train_profile_phase(run)
    del run, fo, flse
    train_remat_phase(fk, tcfg_model, args.seed, dev)
    torch.cuda.empty_cache()

    # 4. serving at full width: GPT-2 124M, bf16 activations, f32 params
    f32 = cfg.replace(dtype="float32")
    f32_tokens = kernel_vs_gather("serve_f32", f32, params, reqs, pk)
    k3 = main_path("serve", cfg, params, reqs, pk, flush)
    profile_phase(cfg, params, reqs)

    # 5. int8 serving (K4): f32 kernel vs gather, then the bf16 main path
    kernel_vs_gather("serve_q8_f32", f32, params, reqs, pk, **Q8)
    k4 = main_path("serve_q8", cfg, params, reqs, pk, flush, **Q8)
    ratio = (k4["metrics"]["pool_bytes"], k3["metrics"]["pool_bytes"])
    emit(phase="serve_q8_pool", pool_bytes_q8=ratio[0],
         pool_bytes_bf16=ratio[1], ratio=ratio[0] / ratio[1])
    if ratio[0] * 128 != ratio[1] * 68:
        raise AssertionError(
            f"int8 pool {ratio[0]} B is not 68/128 of the bf16 pool "
            f"{ratio[1]} B"
        )
    profile_phase(cfg, params, reqs, phase="profile_q8", **Q8)
    quality_phase(f32, params, reqs, f32_tokens, dev)
    del params

    # 6. Llama-3.2-1B at full width (GQA group 4): K4 and K3 drives
    llama_phase(pk, args.seed, dev)

    # 6b. the serving tier through its entry points: the HTTP/SSE twin,
    # the loadgen twin's clean and storm legs (GPT-2 f32 and bf16), and
    # the int8 Llama fleet (K4)
    tier = dict(http=tier_http_phase(pk, args.seed, smi),
                storm=tier_storm_phase(pk, args.seed, smi),
                llama_q8=tier_llama_q8_phase(pk, args.seed, dev, smi))
    failover_paths_phase(pk, args.seed, dev, smi)

    # 6c. generation outside the paged engine: the serial engine and the
    # generate twin, the dense engine, speculative decoding on both
    # batched engines, the soak twin and serve --dense
    slice9 = dict(
        generate=generate_phase(pk, args.seed, smi),
        dense=dense_phase(pk, cfg, gpt2.init(
            torch.Generator().manual_seed(args.seed), cfg), reqs,
            f32_tokens, smi),
        spec=spec_phase(pk, args.seed, dev, smi),
        soak=soak_phase(pk, args.seed, smi),
        serve_dense=serve_dense_phase(pk, args.seed, smi),
    )
    slice9_paths = {name: row["launches"] for name, row in slice9.items()}

    # 6d. multi-tenant LoRA (the fused delta kernel, K3, K4 on int8 Llama)
    # and disaggregated prefill/decode (K3/K4 on the decode worker); the
    # decode_bench twin's legs run at the end
    from pytorch_distributed_tpu_torch.ops import lora_kernel as lk

    lora_k = lora_kernel_phase(lk, dev, flush, args.seed)
    slice10 = dict(lora_phase(pk, lk, args.seed, dev, smi))
    slice10["lora_http"] = lora_http_phase(pk, lk, args.seed, smi)
    slice10.update(disagg_phase(pk, args.seed, dev, smi))
    # 10. train parity on the card (f32, flash kernels vs naive attention)
    train_parity_phase(tcfg_model, args.seed, dev)

    # 11. the training entry point's loop, dropout and the fused head CE,
    # all with the preset's dropout 0.1
    with tempfile.TemporaryDirectory() as tmp:
        train_loop_phase(fk, args.seed, tmp)
    loop_cfg = cfg.replace(attention_impl="flash")
    train_dropout_phase(loop_cfg, args.seed, dev)
    train_fused_ce_phase(loop_cfg, args.seed, dev)

    # 11b. the guarded training loop with faults (slice 12)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        guard_run = train_guard_phase(fk, tcfg_model, args.seed, dev, smi,
                                      tmp)
    torch.cuda.empty_cache()
    slice12_paths = {
        "train_guard_corrupt_inputs_step":
            guard_run["corrupt"]["inputs"]["launches"],
        "train_guard_corrupt_targets_step":
            guard_run["corrupt"]["targets"]["launches"],
        "train_guard_clean_4_steps": guard_run["launches"]["clean"],
        "train_guard_rollback_4_plus_2_replayed_steps":
            guard_run["launches"]["faulted"],
        "train_guard_async_4_steps": guard_run["launches"]["async_run"],
    }

    # 12. Llama-3.2-1B training at full width: bench_suite rows 6 and 7,
    # the entry point's loop, every remat mode at 4 layers; then MoE
    # training of both families
    llama_paths = {}
    for phase, t, remat, steps in (("train_llama", 4096, "names", 5),
                                   ("train_llama_long", 8192, "flash", 3)):
        run = train_llama_phase(fk, llama_cfg(remat=remat), args.seed, dev,
                                t=t, steps=steps, phase=phase)
        llama_paths[phase] = dict(T=t, launches_per_step=run[
            "launches_per_step"], kernel_times=flash_long[t])
        del run
    with tempfile.TemporaryDirectory() as tmp:
        loop = train_llama_loop_phase(fk, args.seed, tmp)
    llama_paths["train_llama_loop"] = dict(
        T=1024, launches_per_step={k: v / loop["steps"] for k, v in
                                   loop["launches"].items()})
    train_llama_remat_phase(fk, args.seed, dev)
    train_moe_phase(fk, args.seed, dev)

    # 13b. memory and throughput accounting, what the profiler costs, then
    # the decode_bench twin's other modes
    torch.cuda.empty_cache()
    memory_phase(args.seed, smi)
    thr = throughput_phase(args.seed, smi)
    # What the profiler's host cost does to an idle share: the profiled
    # windows' device busy time over their own wall, and over the wall of
    # the same work unprofiled (the throughput phase's step, the ticks
    # timed just before each serving window).
    busy_ms = prof_train["trace_busy_us"] / 4e3
    step_ms = thr["measured"]["seconds_per_step"] * 1e3
    emit(phase="profiler_cost", nvidia_smi=smi,
         train_busy_ms_per_step=busy_ms,
         train_profiled_ms_per_step=prof_train["window_wall_ms"] / 4,
         train_unprofiled_ms_per_step=step_ms,
         train_idle_share_profiled=prof_train[
             "key_averages_device_idle_share"],
         train_idle_share_unprofiled=1 - busy_ms / step_ms,
         serve={kid: {k: row[k] for k in (
             "window_wall_ms", "unprofiled_window_ms",
             "key_averages_device_idle_share", "unprofiled_idle_share")}
             for kid, row in prof_paged.items()})
    # The subprocess phases last: each runs in processes of its own, and
    # a profiler window opened after another process used the card can
    # lose its device rows (PERF.md section 7). The decode_bench runs that
    # gate a time ratio run alone, first.
    torch.cuda.empty_cache()
    slice10["decode_bench_twin"] = decode_bench_twin_phase(smi)
    spec_rows = decode_bench_spec_phase(smi)
    # 16-17b side by side with the decode_bench twin's untimed runs and
    # the storm (15, untimed): data-parallel training (slice 13: world 1
    # on NCCL, two gloo ranks on the one card), then on pairs of gloo
    # ranks tensor-parallel serving (slice 14) and training (slice 15)
    with storm_in_background() as storm_done:
        late = late_phases(pk, fk, args.seed, dev, smi)
        storm_report, storm_wall = storm_done()
    train_storm_phase(smi, storm_report, storm_wall)
    check_survivors("train_storm")
    slice10_paths = {name: row["launches"] for name, row in slice10.items()
                     if "launches" in row}

    tier_paths = {
        "K3": dict(tier_http=tier["http"]["launches"]["K3"], **{
            f"tier_storm_{dtype}_x{row['rate_multiplier']}_{leg}":
                row[leg]["launches"]["K3"]
            for dtype, legs in tier["storm"].items()
            for row in legs["rows"] for leg in ("clean", "storm")}),
        "K4": {f"tier_llama_q8_x{row['rate_multiplier']}_{leg}":
               row[leg]["launches"]["K4"]
               for row in tier["llama_q8"]["rows"]
               for leg in ("clean", "storm")},
    }
    paged_entries = [
        dict(name=name, route="cuda", source=PAGED_SOURCE,
             replaces=f"pytorch_distributed_tpu/ops/paged_kernel.py:{line}",
             **run["entry"], tier_paths=tier_paths[kid],
             slice9_paths={name: counts[kid]
                           for name, counts in slice9_paths.items()},
             slice10_paths={name: counts[kid]
                            for name, counts in slice10_paths.items()})
        for name, line, run, kid in (
            ("paged_decode_attention", 56, k3, "K3"),
            ("paged_decode_attention_q8", 114, k4, "K4"))
    ]

    slice11_paths = decode_bench_twin_2_paths(dict(late["decode_bench"],
                                                   serving_spec=spec_rows))
    ddp_nccl, ddp_gloo2, tp, tp_train, seq_train = (
        late["ddp_nccl"], late["ddp_gloo2"], late["tp"], late["tp_train"],
        late["seq_train"])
    slice13_paths = {
        **{f"ddp_nccl_{name}_{DDP_STEPS}_steps": leg["launches"]
           for name, leg in ddp_nccl["legs"].items()},
        **{f"ddp_gloo2_{name}_{DDP_STEPS}_steps": leg["launches"]
           for name, leg in ddp_gloo2["legs"].items()},
    }
    for entry, kid in zip(paged_entries, ("K3", "K4")):
        entry.update(
            trace_launches=prof_paged[kid]["launches_traced"][kid],
            trace_window_counted=prof_paged[kid]["launches_counted"][kid],
            slice11_paths={name: counts[kid]
                           for name, counts in slice11_paths.items()},
            # Each rank's launches on the TP legs (rank 0's; the ranks'
            # counts are gated equal to n_layer x ticks), and the kernel
            # at a rank's local heads.
            tp_paths={f"tp_serve_{name}": row["counts"][kid]
                      for name, row in tp["legs"].items()
                      if "counts" in row},
            tp_local_shapes=tp_kernel_rows[entry["name"]])

    inputs = dict(B=fq.shape[0], H=fq.shape[1], Hkv=fkk.shape[1],
                  T=fq.shape[2], D=fq.shape[3], causal=causal,
                  dtype=str(fq.dtype).replace("torch.", ""))
    flash_entries = [
        dict(name=name, route="cuda", source=FLASH_SOURCE,
             replaces=f"pytorch_distributed_tpu/ops/flash_kernel.py:{line}",
             launches=train_launches[direction], **checked[kn], **timed[kn],
             inputs=inputs,
             trace_launches=prof_train["launches_traced"][kn],
             trace_window_counted=prof_train["launches_counted"][kn],
             slice12_paths={name: counts[direction]
                            for name, counts in slice12_paths.items()},
             slice13_paths={name: counts[direction]
                            for name, counts in slice13_paths.items()},
             llama_paths={phase: dict(
                 T=row["T"],
                 launches_per_step=row["launches_per_step"][direction],
                 **row.get("kernel_times", {}).get(kn, {}))
                 for phase, row in llama_paths.items()},
             # Each rank's launches on the tensor-parallel training legs
             # (rank 0's, all steps), and the kernel at a tensor-2 rank's
             # local heads.
             tp_train_paths={
                 f"tp_train_{name}_{len(row['losses'])}_steps":
                     row["launches"][0][direction]
                 for name, row in tp_train["legs"].items()},
             tp_local_shapes={shape: dict(
                 {k: v for k, v in row.items() if k not in ("K1", "K2")},
                 **row[kn]) for shape, row in tp_flash_rows.items()
                 if shape.endswith("-tp2")},
             # Each rank's launches on the sequence-parallel legs (rank
             # 0's, all steps; the ring's 0), and the kernel at a seq-2
             # Ulysses rank's heads over the whole sequence.
             seq_paths={
                 f"seq_train_{name}_T{row['T']}_{len(row['losses'])}_steps":
                     row["launches"][0][direction]
                 for name, row in seq_train["legs"].items()},
             seq_local_shapes={shape: dict(
                 {k: v for k, v in tp_flash_rows[src].items()
                  if k not in ("K1", "K2")}, **tp_flash_rows[src][kn],
                 **({"same_as": src} if src != shape else {}))
                 for shape, src in SEQ_LOCAL_SHAPES.items()})
        for name, kn, direction, line in (
            ("flash_forward", "K1", "forward", 92),
            ("flash_backward", "K2", "backward", 221),
        )
    ]
    main = lora_k["main"]
    lora_entry = dict(
        name="lora_delta_add", route="cuda", source=LORA_SOURCE,
        replaces="pytorch_distributed_tpu/models/decode.py:286",
        replaces_note="lora_delta, plain products in the JAX package (no "
                      "pl.pallas_call)",
        launches=slice10["lora_bfloat16"]["launches"]["lora"],
        max_abs_err=main["max_abs_err"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        host_us=main["host_us"], plain_host_us=main["plain_host_us"],
        inputs=dict(form=main["form"], rows=main["rows"],
                    tokens=main["tokens"], dtype=main["dtype"],
                    din=main["din"], out=main["out"], slots=main["slots"],
                    rank=LORA_RANK),
        slice10_paths={name: counts.get("lora", 0)
                       for name, counts in slice10_paths.items()},
        tp_paths={"tp_serve_lora": tp["legs"]["lora"]["counts"]["lora"]})
    check_survivors("before the kernels line")
    emit(phase="walls", walls=phase_walls())
    print(json.dumps(dict(kernels=[*paged_entries, *flash_entries,
                                   lora_entry])), flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
