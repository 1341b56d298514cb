#!/usr/bin/env python3
"""Drive the PyTorch port (``tdfo_tpu_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                # every phase, one card

Phases (each prints its lines; any failure raises, so the script never exits
0 after a failed phase):

0. device — requires ``torch.cuda.is_available()``; prints the card's name,
   the device count and ``nvidia-smi --query-gpu=name,power.limit``.
1. build — compiles every kernel of the port from ``tdfo_tpu_torch/ops/csrc``
   with ``nvcc`` (all at once) and prints the build time and ``-Xptxas -v``.
2. oracle — each kernel against its plain PyTorch version on the card, on
   the same inputs: ``fat_line_update`` for the 4 optimizer kinds x {d=64
   row form on a 500,000-row table with ~8,192 lines, d=16 packed form},
   plus sentinel / out-of-range lines and untouched shared-line slots.
   Touched rows within rtol 1e-6 / atol 1e-7; every other element of the
   table bitwise unchanged.  Then (phase ``timing``) CUDA-event times of the
   kernel and the plain version at the main path's shape, with L2 flushed
   before each launch, the kernel's ``torch.profiler`` device duration
   (CUPTI's kernel start to end) and the floor of both (an empty kernel),
   beside the bound (the larger of bytes / HBM rate and f32 operations /
   peak f32 rate), after holding the kernel against the plain version on
   those same operands; then the same at the kernel's other shapes, each
   on a line of its own with its byte bound: the Bert4Rec item table
   (200,002 rows, adam d = 64, one ``b4r_batch``'s lines) and config.toml's
   packed shape (adam d = 16, R = 2 with the touched mask, the 700,000
   user+item rows, B = 2048).
2b. segsum — ``segment_sum`` (the port's deterministic segment sum, its
   own kernel: every float sum by index) against its plain version
   (``index_add_`` on the CPU) bitwise, at the shapes the main paths give
   it (the TwoTower fat stack's grads with and without the dedupe's plan,
   the lazy tier's zipf ids, the AUC histogram, bf16 rows, f16 embedding
   grads, no rows); then the wrapper, its kernel's device time, the plain
   ``index_add_`` on the card and a deterministic ``index_put_(accumulate=
   True)`` timed at the fat stack's shape beside the byte bound.
3. main path — the library flow of ``bench.py::build_sparse_train_bench``
   at full width (SIZE_MAP of ``bench.py:56-59``, B = 8192, d = 64, sparse
   adam + dense AdamW at lr 3e-4, wd 1e-4, random batches as
   ``bench.py:90-102``): 20 steps on the card with finite losses and one
   ``fat_line_update`` launch per fat array per step (``user`` and ``item``
   share one stacked array) and ``segment_sum`` launched (counted); then
   the first 3 steps again on the port's CPU path from the same initial
   state, holding losses and the touched rows of the ``user`` table to
   rtol 1e-4.
4. CLI — ``launch synth -> preprocess-ctr -> train`` in a temporary
   directory with ``model_parallel = true``, ``embed_dim = 16``,
   ``fused_table_threshold = 0`` (every table fat, packed R = 2 lines),
   ``n_epochs = 1``; ``metrics.jsonl`` must hold eval AUC.  Run twice: f32
   storage, then ``[embeddings] table_dtype = "bfloat16"`` (the packed bf16
   fat stack through the bf16 kernel; every table still bf16 after
   training).
5. flash_oracle — the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain versions on the card, f32 and bf16, T in {20, 100,
   4096} (B = H = 2) and the kernels' tile edges T in {1, 15, 16, 17, 24,
   25, 31, 33, 63, 64, 65, 127, 128, 257} (B = H = 3: 9 heads, not a
   multiple of the heads a block packs), Dh in {32,
   64}, with key padding (a whole first key tile masked at T >= 80), a fully
   masked batch row (output 0, lse = +inf, zero gradients) and ragged last
   tiles.  f32: forward and lse within
   rtol/atol 2e-5, gradients within 1e-4 (summation order only, the JAX
   tests' own bounds).  bf16: compared in bf16, within 2e-2 relative plus
   2e-2 of the largest |value| (the kernel and its plain version round p,
   ds and the result to bf16 at the same places, so a different f32
   summation order can move a rounding by one bf16 ulp, 2^-8); the tile-edge
   cases add 1e-6 absolute, as the card tests do, since at T = 1 dQ is 0
   up to the rounding of dp - delta.
6. flash_timing — CUDA-event times and profiler device durations of each
   flash kernel (and the empty-kernel floor), CUDA-event times of its plain
   version, and CUDA-event times and profiler device durations (every kernel
   of one call, summed) of ``torch.nn.functional.scaled_dot_product_attention``
   with the same boolean mask (the yardstick, timed only; the backward
   kernels' yardstick is SDPA's whole backward), L2 flushed before each
   launch, beside the
   bound (the larger of bytes / HBM rate and 4, 6 or 8 B H T^2 Dh flops /
   peak rate for the operand type), at the Bert4Rec main path's shape (B =
   256, H = 2, T = 20, Dh = 32, f32) and at ``bench_kernels.py:23``'s (B =
   1, H = 8, T = 4096, Dh = 64) in bf16 and f32.
7. b4r_main — Bert4Rec sparse training with ``attn = "flash"`` at the full
   width of ``configs/bert4rec.toml`` (d = 64, 2 heads, 2 layers, ff 256, T =
   20, B = 256, dropout 0.1, adam lr 3e-4, wd 1e-4) over the catalogue of
   ``bench.py::bench_serve_seq`` (200,000 items; a fat item table): 20 steps
   with finite losses, n_layers launches per step of each flash kernel and
   one of ``fat_line_update``; then the first 3 steps at dropout 0 on the
   card and on the port's CPU path from one initial state: losses within
   rtol 1e-4, and the touched item rows too, except at most 0.1% of their
   elements, each within 2 lr per step (Adam's step on a gradient element
   that lies inside the two devices' f32 summation noise may take either
   sign).
8. b4r_cli — ``launch synth -> preprocess-seq -> train`` with ``model =
   "bert4rec"``, ``attn = "flash"``, ``fused_table_threshold = 0``;
   ``metrics.jsonl`` must hold Recall/NDCG@{10,20,50} and ``test_*``, and
   every kernel must have launched.

9. routed_oracle — ``fat_line_update_routed`` against its plain version on
   the card, on the same operands: the 4 kinds at d = 16 (packed, R = 2-8),
   rowwise_adagrad on the full 4.32 GB Criteo fat stack; rowwise_adagrad at
   d = 8 (R = 8); adam at d = 64 (R = 1, two tiles); with negative ids (the
   sentinel row and line), capacity padding rows and distinct rows sharing
   a line; then every line of a case holding R touched rows (rowwise d = 16,
   adam d = 32, sgd d = 8; 100,000-640,000 rows, more than the resident
   grid updates in one pass and a multiple of no row group).  Touched rows within rtol 1e-6 / atol 1e-7, every other element
   bitwise unchanged, and the kernel bitwise equal to ``fat_line_update``
   fed the same update in slot space.
10. routed_timing — CUDA-event times of the routed kernel and its plain
   version at the DLRM main path's shape (the 8 fat tables' 65,536 ids of
   one B = 8192 step on the 4.32 GB stack), L2 flushed before each launch,
   the kernel's profiler device duration and the empty-kernel floor,
   beside the byte bound.
11. dlrm_main — DLRM-Criteo sparse training at full width, the library flow
   of ``bench.py::build_criteo_train_bench`` as the planner bench's
   defaults arm calls it (``bench.py:492-493``): the 26 Criteo-Kaggle tables
   of ``bench.py:64-68`` at d = 16, the 8 tables above 16,384 rows in one
   rowwise-adagrad fat stack (``[8,428,795, 1, 128]`` f32), the 18 others in
   one plain stack, B = 8192 with 13 continuous columns (uniform ids, as
   ``bench.py:248-265``), ``DLRMBackbone`` (bottom (64,), top (128, 64)),
   sparse rowwise_adagrad lr 3e-4, dense AdamW lr 3e-4 wd 1e-4,
   ``dedup_lookup``; f32 compute (the bench computes the dense half in
   bf16; ``mixed_precision`` is not ported).  20 steps with finite losses,
   one routed launch and no ``fat_line_update`` launch per step, median
   step time and peak device memory; then 3 steps on the card and on the
   port's CPU path from one initial state: losses and the touched rows of
   both stacks within rtol 1e-4.
12. dlrm_cli — ``launch synth-criteo -> preprocess-criteo -> train`` with a
   copy of ``configs/dlrm-criteo.toml`` whose ``fused_table_threshold`` is
   lowered so a fat and a plain stack exist; ``metrics.jsonl`` must hold
   eval AUC and the routed kernel must have launched.

13. bf16_oracle — both bf16 kernels against their plain versions on the
   card, same operands and stochastic-rounding seed: ``fat_line_update`` for
   the 4 kinds at d = 64 on a bf16 500,000-row table with ~8,192 lines and
   packed at d = 16 with padding ids, and sentinel / out-of-range lines
   with untouched shared slots; the routed kernel at d = 16 (R = 2-8),
   adagrad and rowwise on the full 2.16 GB bf16 Criteo stack, adam at
   d = 64, and the hand-made edge lines.  Touched elements bitwise the plain version's
   wherever the f32 kernel is bitwise its plain version on the same
   widened operands, else one bf16 ulp apart (counted and printed);
   everything else bitwise unchanged; another seed changes the bits; the
   routed kernel bitwise ``fat_line_update`` given the routed grid's lines
   per block.
14. bf16_timing — both bf16 kernels at their paths' shapes (the TwoTower
   bf16 stack, the DLRM bf16 stack with one step's routing), timed as in
   ``timing`` beside the byte bound (bf16 table and state read and
   written, the f32 grads, the routing).
15. main_bf16 — ``bench.py::build_sparse_train_bench(8192, 64,
   table_dtype="bfloat16")``: every table bf16 (the fat stack with its adam
   state in the line, the small tables with the bench's f32 mu/nu),
   stochastically rounded writes, the backbone in bf16 as the bench
   computes it on a chip; 20 steps (finite losses, one ``fat_line_update``
   launch per step, the tables still bf16), median step time and peak
   memory; then 3 steps on the card and the CPU path from one state:
   losses within ``BF16_LOSS_RTOL``, at most ``BF16_FAR_SHARE`` of the
   touched user elements more than one bf16 ulp apart, none beyond one
   ulp plus 2 lr per step, and the initial rows, as a control, outside
   that share (the note at ``BF16_FAR_SHARE``).
16. dlrm_bf16_main — phase 11 with ``table_dtype = "bfloat16"`` under
   sparse adagrad (``DLRM_BF16_KIND``: the reference refuses bf16 fused
   tables under rowwise_adagrad): the bf16 adagrad fat stack
   ``[8,428,795, 1, 128]`` (2.16 GB) and bf16 plain stack, bf16 compute
   (``bench.py:306``); the same checks on both stacks, one routed launch
   per step.

17. dense_main — the dense TwoTower (``model_parallel = false``, the
   quickstart's regime) at ``bench.py::build_train_bench``'s width
   (SIZE_MAP, B = 8192, d = 64, every parameter under AdamW lr 3e-4 wd
   1e-4; f32 compute, the cut: the bench computes in bf16 on a chip): 20
   eager steps three times (finite losses), 20 steps with
   ``steps_per_execution = 4`` as CUDA-graph replays
   (``train/step.py::CudaGraphStep``) held to the eager runs by the rule of
   phase 18, eager vs graph step ms, a checkpoint of
   the capturable state restored bitwise into a card and a CPU state, and
   the first 3 steps on the port's CPU path (losses and touched user rows
   within rtol 1e-4).  No hand-written kernel is on this path.
18. resume — phases 3, 15 and 7's setups at their widths: 20
   uninterrupted steps three times, then 10 steps, a checkpoint save, a
   restore into a fresh state (bitwise the saved one) and 10 more (R,
   Bert4Rec's dropout drawn per step from ``(seed + 1, step)``).  The
   uninterrupted runs must agree bitwise (the deterministic segment sums
   make card runs repeat) and R must equal them bitwise; each run
   launches ``fat_line_update`` once per step and, for Bert4Rec, each
   flash kernel once per layer per step.
   Prints the checkpoint's bytes and save / restore seconds.
19. quickstart_cli — ``launch synth -> preprocess-ctr -> train`` with a
   copy of ``config.toml`` (only ``data_dir``, ``n_epochs = 1``,
   ``checkpoint_dir``, ``checkpoint_every_n_steps`` changed), the data
   written by the port's ``data/synthetic.py`` with 20,000 users so the
   epoch outlasts the first save; the train process is killed with
   SIGKILL once a mid-epoch checkpoint is committed and run again:
   ``metrics.jsonl`` must show ``resumed_mid_epoch`` and an eval AUC in
   [0, 1].
20. b4r_jagged — the Bert4Rec CLI with a copy of ``configs/bert4rec.toml``
   (its widths; ``jagged = true``, ``attn = "flash"``, one epoch): flash
   launches n_layers per step in each backward kernel; then the jagged
   and the padded step from b4r_main's initial state on the same 3 ragged
   batches and dropout draws, losses within rtol 1e-4.

21. int8_main — ``bench.py::build_sparse_train_bench(8192, 64,
   table_dtype="int8")``: every TwoTower table plain int8 with its
   (scale, offset) sidecar (the arm rebuilds the specs plain), sparse adam
   and AdamW at lr 3e-4, wd 1e-4, bf16 compute: 20 steps (finite losses,
   no fat-line launch, the tables still int8), median step ms and peak
   memory; then 3 steps on the card and the CPU path from one state:
   losses within ``BF16_LOSS_RTOL``, at most ``INT8_FAR_SHARE`` of the
   touched user elements more than one grid step apart, and the initial
   rows, as a control, outside that share.
22. int8_fused — ``bench.py::bench_quant_int8_fused``: 2,000,000 rows at
   d = 64 under adam as int8 byte-container fat lines (640 B a row) and as
   a plain int8 table; fed the same deduped ids, grads and keys for 3
   steps, the fused update must write the plain update's codes, sidecars
   and moments bitwise; then both layouts' whole update timed with CUDA
   events in turns.
23. dlrm_int8_cache — ``configs/dlrm-criteo.toml`` with ``table_dtype =
   "int8"``, ``cache_rows = 131072``, ``flush_every = 64``: the 26 tables
   in one int8 plain stack, rowwise_adagrad, ``dedup_lookup``, zipf ids
   (a = 1.2), B = 8192.  The toml's cache over one interval must overflow
   and fail in the trainer's words (``CACHE_ROWS_STACK``); then 130 steps
   (two flushes) with a stack-sized cache and three times uncached:
   overflow 0 at every flush, the uncached runs bitwise one another and
   the cached run bitwise them (``spread_check``), step ms of both, flush ms, hit rate and peak
   memory beside dlrm_main's.
24. dlrm_hot_cold — ``bench.py::build_criteo_train_bench(hot_vocab=
   16384)``: every table's ``[0, min(16384, V))`` prefix a hot head, zipf
   ids, f32 compute; once with f32 storage and once with the int8 cold
   residual: 20 steps (step ms, peak memory, no fat-line launch), then 3
   steps on the card and the CPU path (f32: losses and cold rows within
   rtol 1e-4; int8: losses within ``BF16_LOSS_RTOL``, cold rows by the
   grid-step rule and its control; the heads of both pooled by the head
   rule: at most ``HEAD_SHARE`` of their elements beyond rtol 1e-4, none
   beyond an update of the other sign, with two controls that must fail).
25. criteo_int8_cli — ``synth-criteo -> preprocess-criteo -> train`` with
   a copy of ``configs/dlrm-criteo.toml`` plus int8, ``cache_rows``,
   ``flush_every`` and ``hot_vocab``: the ETL writes ``hot_ids.json``, the
   train process is SIGKILLed after a save inside a flush interval and
   resumes mid-epoch (eval AUC in [0, 1]), and a run under an edited
   ``hot_ids.json`` refuses to restore in the reference's words.

26. serve_main — TwoTower serving at ``bench.py::bench_serving``'s width
   (SIZE_MAP, d = 64): a bundle exported from the state of 3 DMP steps
   (sparse adam + AdamW, lr 3e-4), loaded with its digest verified and
   scored on the card at B = 8192: logits against the port's CPU scorer
   over the same bundle and against the training eval step over the same
   rows, both within rtol 1e-5 (bitwise printed, not required); score ms
   per batch at the buckets (256, 1024, 8192) (CUDA events); a ragged trace
   of 64 requests through the micro-batcher, at most 3 batch shapes run;
   the 200,000-item corpus from the item tower, exact top-100 for 8,192
   user queries and the int8 two-stage program (coarse_k 1000), each timed
   (queries/s) and held against ``retrieval_reference`` on the card on
   256 queries (scores within rtol 1e-5, ids equal at every rank separated
   from its neighbours by more than that); the two-stage overlap with the
   exact top-100 (at least ``SERVE_OVERLAP_FLOOR`` of the int8 corpus'
   own, its re-ranked scores equal to the exact scan's); corpus bytes f32
   against int8; peak memory; no kernel launched while serving.
27. serve_seq_main — Bert4Rec serving at ``bench.py::bench_serve_seq``'s
   width (200,000 items, T = 64, d = 64, 2 heads, 2 layers, seeded init):
   B = 8192 windows x 101 candidates at the MASK position with peak memory
   under ``SEQ_PEAK_CAP_GB`` (no ``[B, T, V]`` cube), card vs CPU on 256
   rows and served vs the eval forward on 16 rows within rtol 1e-5, the
   bucket timings, the ragged trace, and the output-head corpus retrieval
   with the checks of phase 26.
28. serve_cli — ``synth -> preprocess -> train`` with ``checkpoint_dir``
   then ``python -m tdfo_tpu_torch.launch serve`` on the card (restoring
   the trained step) for a copy of ``config.toml`` (the dense regime),
   the same with ``[serving] coarse_k`` and a copy of
   ``configs/bert4rec.toml``: 64 requests served, 100 retrieved, finite
   p50 / p99 / qps.

29. dist_main — phase 3's regime (SIZE_MAP, B = 8192, d = 64, adam +
   AdamW lr 3e-4 wd 1e-4, ``embedding_sharding = "row"``, the same initial
   state and batches) in rank processes of this script on the card, each
   mode of ``DIST_MODES``: the lookup modes ``gspmd``, ``psum`` and
   ``alltoall``, the grouped exchange (``grouped``: one f32 group of the
   fat stack and the five plain tables) and its pipelined step
   (``pipelined``), and the int8 arm (every table plain int8, per-table
   ``int8_alltoall`` and ``int8_grouped``): world 1 over NCCL (mesh 1 x 1
   x 1, the distributed code path), the f32 modes bitwise the
   single-device step over 3 steps; world 2 over gloo on the one card
   (NCCL refuses two ranks on a device), data 1 x model 2, after probing
   which collectives gloo takes on CUDA tensors (``all_to_all_single`` in
   int32, f32, bf16 and int8 and async; a refusal fails by name):
   ``gspmd`` and ``psum`` bitwise, the split-batch modes within rtol
   1e-4; NCCL at world = the card count where there are several.  At
   every world the grouped forward is bitwise the per-table ``alltoall``
   forward, the pipelined step bitwise the eager grouped one (losses,
   tables, slots), the int8 arm within the narrow-storage rule of the
   single-device int8 step spanning the two runs' grid steps (each draws
   its own rounding bits; the initial rows as the control, which must
   fail), and ``all_to_all_single`` runs as often a step as ``DIST_A2A``
   says.  Each rank prints step ms, the collectives' CUDA-event ms a step,
   ``fat_line_update`` launches on its shard (once a step in the f32
   modes), ``segment_sum`` launches and peak memory.  Then the CTR arms
   (``DIST_CTR_RUNS``: world 1 over NCCL, world 2 over gloo at data 2 x
   model 1, the dlrm-criteo.toml layout, and at data 1 x model 2; NCCL at
   world = the card count where there are several, data-parallel and, on
   four or more, data x model 2): phase 11's
   DLRM-Criteo regime with ``dedup_lookup`` (the routed kernel on the
   replicated fat stack at model 1, ``fat_line_update`` on each shard at
   model 2), phase 23's int8 stack with the 2,097,152-row update cache,
   phase 24's hot/cold regime (f32 and int8 cold), at model 2 phase 3's
   tables column-sharded under rowwise_adagrad, and at world 1 and model 2
   the same with a 65,536-row update cache (each rank caching its
   columns; bitwise the uncached column step); each rank holds its
   arm to the single-device step it also runs (bitwise at world 1 and
   data 1 x model 2; at data 2 x model 1 rtol 1e-4, the int8 rule and
   the head rule), the alternate path (``dedup_lookup`` off, the cache
   off) bitwise the main one, the cache's overflow 0 on every rank, and
   prints step ms, collective ms, peak memory and its launches of both
   fat-line kernels and ``segment_sum`` (a kernel the arm runs launched
   no time fails the run).
30. dist_cli — ``python -m torch.distributed.run --nproc-per-node 1 -m
   tdfo_tpu_torch.launch train --distributed always`` on two DMP TwoTower
   tomls (synthetic data, ``lookup_mode = "alltoall"``; the second with
   ``grouped_a2a`` and ``pipeline_overlap``) and on
   ``configs/dlrm-criteo.toml`` as shipped (its ``data_dir`` set, a save
   cadence), with the update cache and with ``hot_vocab``: each
   SIGKILLed after a mid-epoch save, run again, and its final checkpoint
   bitwise an uninterrupted run's.

31. dist_seq — Bert4Rec across ranks (``DIST_SEQ_RUNS``; ``PERF.md`` §6).
32. dist_dense — phase 17's dense TwoTower (``build_train_bench``'s
   width, 45.2M parameters under AdamW, B = 8192) in rank processes
   (``DIST_DENSE_RUNS``): world 1 over NCCL, eager steps through the
   distributed code and CUDA-graph replays (steps_per_execution 2),
   bitwise the one-process eager and graph runs; world 2 over gloo at data
   1 x model 2 with the PS partition (``ps_min_shard_bytes`` 256 KB:
   ``user``, ``item`` and ``publisher`` held as row blocks, all-gathered
   for each forward), bitwise one device; CUDA-graph steps under gloo
   refused, naming NCCL.  NCCL at world = the card count where there are
   several: data n, and on four or more data n/2 x model 2 with the PS
   partition, graph replays bitwise their eager steps, both within rtol
   1e-4 of one device (at most 0.1% of the parameter elements outside,
   each within 2 lr a step).  ``segment_sum`` must launch in each eager
   run; step ms, all-gather ms and peak memory per rank.
33. dist_serve — phases 26-27's widths over ranks, the corpus sharded
   over the data axis (``DIST_SERVE_RUNS``: world 1 NCCL, world 2 gloo at
   data 2; NCCL at data = the card count where there are several): the
   TwoTower bundle scored on replicated parameters, its 200,000-item
   item-tower corpus built sharded, and the Bert4Rec head corpus, each
   retrieved for 8,192 queries exact (top-100) and int8 two-stage
   (coarse_k 1,000), ids as the one-device programs at every separated
   rank and scores within rtol 1e-5 on the first and the last 256
   queries (the first and the last query chunks), no padding id, no
   kernel launched; queries/s, build s and peak memory per rank.  Then
   ``launch serve`` through ``torch.distributed.run --nproc-per-node 2
   ... --backend gloo`` on ``config.toml`` at ``[mesh] data = 2`` with
   int8 two-stage retrieval: rank 0 alone prints its stats and writes
   ``metrics.jsonl``, and the stats that do not hang on the host's clock
   equal a one-rank serve of the same toml's.
34. fleet — the serving tier at phase 26's widths (SIZE_MAP, d = 64,
   buckets 256 / 1024 / 8192).  (a) a base bundle of 3 DMP steps (they
   and the steps after launch ``fat_line_update`` and ``segment_sum``,
   counted into the kernels line) ingested into a ``BundleStore``; 2 more
   steps, ``export_delta`` with the steps' ids as the touched hint,
   composed, published under CANARY and promoted: the composed bundle
   equals a full export of the new state bitwise; delta against full
   bytes and the export / apply / swap ms; a delta corrupted in memory at
   its read (``corrupt_delta_nth``) is quarantined and the store stays on
   its version.  (b) an in-process ``ServingFleet`` of 2 replicas: the
   canary member follows CANARY while the other serves CURRENT, both the
   promoted version after; ``probe_each`` bitwise across the replicas;
   ``run`` (256 ragged requests) within rtol 1e-5 of one MicroBatcher.
   (c) a ``ProcessFleet`` of 2 replica processes on the card: cold start
   (spawn to the first answered score), 256 requests through the ingress
   with replica 0 SIGKILLed halfway (``kill_replica_signal``), the
   respawn re-following the version, every answer within rtol 1e-5 of
   the in-process fleet's, shed and failed requests counted, the probe
   bitwise across the processes; then the trace again on the healed
   fleet (p50 / p99 / queries/s) and the card's used memory before and
   after the kill and the respawn.  A replica that fails prints its log.
   (d) on a machine with several cards, one replica per card
   (``device = "cuda:k"``), its answers held the same way.
35. serve_fleet_cli — ``launch serve-fleet`` on the quickstart toml with
   ``[serving] replicas = 2`` (replica processes on the card): 64
   requests, every one answered.
36. loadgen_cli — ``launch loadgen --knee-steps 2`` on the same toml:
   closed loop at concurrency 1 and 2, every request completed, a knee.
37. online — the online loop (``train/online.py``) at phase 3's width
   (SIZE_MAP, d = 64, B = 8192, adam + AdamW lr 3e-4 wd 1e-4) over
   request logs written by ``RequestLog`` with rotation on (ragged
   labelled requests of 1-256 rows).  (a) plain, 3 cycles of 2 steps on
   one MicroBatcher: cycle 1's first step through ``fat_line_update``
   against the same step with the plain version in its place (touched
   lines rtol 1e-6 / atol 1e-7, untouched bitwise); after each cycle the
   card's tables against the port's CPU training of the same replayed
   batches (rtol 1e-4, atol 1e-6) and the swapped MicroBatcher's probe
   against a fresh scorer on the new bundle, bitwise; each stage's ms and
   the delta's bytes.  (b) a child process killed by
   ``kill_between_stages`` at cycle 2's export and restarted: bundle
   digest, replay cursor and probe answers bitwise (a)'s.  (c) gated, 3
   cycles over a 2-replica ServingFleet with ``regress_auc_at_cycle = 2``:
   promote, rollback, promote; ``rejections.json``; both replicas bitwise
   on the last good version after each verdict.  (d) Bert4Rec at phase
   7's width with flash attention, 2 plain cycles.  (e) ``[telemetry]
   counters``: a TwoTower step with counters off records as many
   ``torch.profiler`` ops as one with every emit site stripped; the dense
   step's counters as CUDA-graph outputs (``steps_per_execution = 2``)
   equal an eager trainer's bitwise over 3 chunks.  Launches counted over
   (a)'s cycles (``fat_line_update``, ``segment_sum``) and (d)'s (the
   flash kernels) into the kernels line as ``launches_online``.
38. online_cli — ``synth -> preprocess-ctr -> serve`` on ``config.toml``
   (TwoTower d = 16 with ``model_parallel = true``, ``fused_table_threshold
   = 0``: packed fat lines) with ``[serving] log_features``, then ``launch
   online`` over the served requests' log with ``[telemetry] trace`` and
   ``launch obs`` over its trace (launches as ``launches_online_cli``).

Every phase prints ``phase <name>: start`` and ``phase <name>: ok in <s>
s`` around itself, so a failing run names its phase.  The CLI journeys
and the online phase (``JOURNEYS``: phases 19, 25, 28, 30, the toml run
of phase 31, 35-38) run side by side, each in a process of its own, after
phase 31 and beside phase 29, with phases 32 and 33 one after the other
in a thread beside phase 29 too; they print their output when all have
ended, and the online phases hand their launch counts back through a
JSON file each.

``--phases profile`` / ``profile_b4r`` / ``profile_dlrm`` /
``profile_bf16`` / ``profile_dlrm_bf16`` / ``profile_dense`` (not in the
default run) add a ``torch.profiler`` breakdown of steady TwoTower /
Bert4Rec / DLRM-Criteo / bf16 TwoTower / bf16 DLRM-Criteo main-path steps
and of the dense TwoTower's eager steps and CUDA-graph replays;
``hot_head_inits`` (not in the default run) holds phase 24's f32 heads,
card vs CPU, at five inits by the head rule and replays the first head
step on both devices from the same inputs.

Output: the empty-kernel floor of each timing phase, a ``{"kernels":
[...]}`` JSON line (``ms``: CUDA events, ``device_ms``: profiler, the
median over ``device_records`` launches, every one recorded, or null
when the tracer lost records in every profile; ``library_device_ms``: the
same for the library call), the
``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``.  Exits non-zero without a result when CUDA is absent or
the script stands outside the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench.py:56-59 (the headline TwoTower DMP configuration)
SIZE_MAP = {
    "user": 500_000, "item": 200_000, "language": 32, "is_ebook": 2,
    "format": 16, "publisher": 5_000, "pub_decade": 16,
}
BATCH, DIM, LR, WD = 8192, 64, 3e-4, 1e-4
# config.toml's TwoTower quickstart: embed_dim 16 (adam: two rows a line),
# per_device_train_batch_size 2048
CONFIG_DIM, CONFIG_BATCH = 16, 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM f32 outside the tensor cores, same sheet
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense, same sheet
ADAM_FLOP_PER_ELEMENT = 16  # mu 3, nu 4, 2 bias divides, sqrt, eps, divide, wd 2, lr, subtract
KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")

# configs/bert4rec.toml at full width over bench.py::bench_serve_seq's
# catalogue (bench.py:1286)
B4R = dict(n_items=200_000, max_len=20, embed_dim=64, n_heads=2, n_layers=2,
           dropout=0.1)
B4R_BATCH, B4R_SEED, B4R_MASK_PROB = 256, 42, 0.2
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# 4, 6 and 8 B H T^2 Dh flops: QK^T and PV; dQ recomputes QK^T, dO V^T and
# adds dS K; dK/dV recomputes QK^T, dO V^T and adds P^T dO and dS^T Q
FLASH_FLOPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}

# DLRM-Criteo: bench.py:64-68's 26 Criteo-Kaggle vocabularies (33,762,577
# rows), the planner bench's defaults arm (bench.py:492-493, 346-349)
CRITEO_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)
CRITEO_CATS = tuple(f"cat_{i}" for i in range(26))
CRITEO_CONTS = tuple(f"cont_{i}" for i in range(13))
CRITEO_DIM, CRITEO_FUSED_MIN = 16, 16384  # tdfo_tpu/plan/planner.py:94
OOB = 2**31 - 1
# rowwise_adagrad per element: g + wd x (2), g^2 (1), sum (1), then
# x - lr g / denom (3) with g + wd x again (2); per row mean, sqrt, eps (3)
ROWWISE_FLOP_PER_ELEMENT, ROWWISE_FLOP_PER_ROW = 9, 3
# adagrad per element: g + wd x (2), acc + g^2 (2), lr g, sqrt, + eps,
# divide, subtract (5)
ADAGRAD_FLOP_PER_ELEMENT = 9
# DLRM-Criteo with bf16 storage: the reference refuses bf16 fused tables
# under the config's rowwise_adagrad (tdfo_tpu/parallel/embedding.py:307-315:
# the per-row accumulator is f32 by contract), so the bf16 fat stack
# trains with adagrad, whose per-element accumulator rides the bf16 line
# (the same [L, 1, 128] geometry at d = 16, R = 4)
DLRM_BF16_KIND = "adagrad"
_CSRC, _PK = "tdfo_tpu_torch/ops/csrc/", "tdfo_tpu/ops/pallas_kernels.py:"
KERNEL_TABLE = (  # name, source, the TPU kernel it replaces
    ("fat_line_update", _CSRC + "fat_line_update.cu", _PK + "885"),
    ("fat_line_update_routed", _CSRC + "fat_line_update_routed.cu", _PK + "1122"),
    ("flash_fwd", _CSRC + "flash_attn_fwd.cu", _PK + "73"),
    ("flash_bwd_dq", _CSRC + "flash_attn_bwd.cu", _PK + "222"),
    ("flash_bwd_dkv", _CSRC + "flash_attn_bwd.cu", _PK + "261"),
    # the bf16 branches of the two fat-line kernels (the TPU kernels'
    # _sr_writeback, pallas_kernels.py:841)
    ("fat_line_update[bf16]", _CSRC + "fat_line_update.cu", _PK + "885"),
    ("fat_line_update_routed[bf16]", _CSRC + "fat_line_update_routed.cu",
     _PK + "1122"),
    # the port's own kernel: no TPU kernel; it replaces the reference's
    # XLA segment sum (jax.ops.segment_sum) and the port's index_add_
    ("segment_sum", _CSRC + "segment_sum.cu", "tdfo_tpu/ops/sparse.py:104"),
)
DEFAULT_PHASES = ("build", "oracle", "timing", "segsum", "main", "cli", "flash_oracle",
                  "flash_timing", "b4r_main", "b4r_cli", "routed_oracle",
                  "routed_timing", "dlrm_main", "dlrm_cli", "bf16_oracle",
                  "bf16_timing", "main_bf16", "dlrm_bf16_main", "dense_main",
                  "resume", "quickstart_cli", "b4r_jagged", "int8_main",
                  "int8_fused", "dlrm_int8_cache", "dlrm_hot_cold",
                  "criteo_int8_cli", "serve_main", "serve_seq_main", "serve_cli",
                  "dist_main", "dist_cli", "dist_seq", "seq_cli", "dist_dense",
                  "dist_serve", "fleet", "serve_fleet_cli", "loadgen_cli",
                  "online", "online_cli")


def say(*parts) -> None:
    print(*parts, flush=True)


def make_host_batch(rng: np.random.Generator, b: int) -> dict[str, np.ndarray]:
    """bench.py:90-102."""
    return {
        "user_id": rng.integers(0, SIZE_MAP["user"], b, dtype=np.int32),
        "item_id": rng.integers(0, SIZE_MAP["item"], b, dtype=np.int32),
        "language": rng.integers(0, SIZE_MAP["language"], b, dtype=np.int32),
        "is_ebook": rng.integers(0, 2, b, dtype=np.int32),
        "format": rng.integers(0, SIZE_MAP["format"], b, dtype=np.int32),
        "publisher": rng.integers(0, SIZE_MAP["publisher"], b, dtype=np.int32),
        "pub_decade": rng.integers(0, SIZE_MAP["pub_decade"], b, dtype=np.int32),
        "avg_rating": rng.random(b, dtype=np.float32),
        "num_pages": rng.random(b, dtype=np.float32),
        "label": rng.integers(0, 2, b).astype(np.float32),
    }


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2


def random_fat(torch, layout, rows, gen):
    """A fat table with random content in EVERY lane (pad lanes included,
    so a stray write shows); moment/accumulator lanes non-negative."""
    lines = layout.n_lines(rows)
    fat = torch.rand((lines, layout.tiles, 128), generator=gen,
                     device="cuda", dtype=torch.float32)
    view = fat.view(-1, layout.w)
    view[:, :layout.d] -= 0.5
    if layout.kind == "adam":
        view[:, layout.d:2 * layout.d] -= 0.5  # mu may be negative
    return fat


def touched_mask(torch, fat, ulines, touched, layout):
    """[L*R, W] bool: lanes [0, need) of every slot the step may write."""
    n_lines = fat.shape[0]
    mask = torch.zeros((n_lines * layout.r, layout.w), dtype=torch.bool,
                       device=fat.device)
    lines = ulines.to(torch.int64)
    ok = (lines >= 0) & (lines < n_lines)
    slots = (lines[:, None] * layout.r
             + torch.arange(layout.r, device=fat.device)).reshape(-1)
    keep = ok.repeat_interleave(layout.r)
    if touched is not None:
        keep &= touched.reshape(-1) > 0
    mask[slots[keep], :layout.need] = True
    return mask


def oracle_case(torch, kl, name, fat0, ulines, g, touched, corr, layout):
    """Kernel vs plain on clones of ``fat0``; returns max |err|."""
    from tdfo_tpu_torch.interop import TOL

    rtol, atol = TOL["optimizer"]
    kw = dict(layout=layout, lr=0.05, b1=0.9, b2=0.999, eps=1e-8,
              weight_decay=1e-2)
    a = fat0.clone()
    b = fat0.clone()
    kl.fat_line_update_plain(a, ulines, g, touched, corr, **kw)
    kl.fat_line_update(b, ulines, g, touched, corr, **kw)
    torch.cuda.synchronize()
    m = touched_mask(torch, fat0, ulines, touched, layout)
    va, vb, v0 = (t.view(-1, layout.w) for t in (a, b, fat0))
    if not torch.equal(vb[~m].view(torch.int32), v0[~m].view(torch.int32)):
        raise AssertionError(f"{name}: kernel changed untouched elements")
    if not torch.equal(va[~m].view(torch.int32), v0[~m].view(torch.int32)):
        raise AssertionError(f"{name}: plain version changed untouched elements")
    if not torch.isfinite(vb[m]).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(vb[m], va[m], rtol=rtol, atol=atol,
                               msg=lambda s: f"{name}: {s}")
    err = float((vb[m] - va[m]).abs().max()) if m.any() else 0.0
    n_touched = int(m.any(dim=1).sum())
    say(f"  {name}: touched rows {n_touched}, max_abs_err {err:.3e}, "
        f"bitwise-unchanged elements {int((~m).sum())}")
    return err


def phase_oracle(torch, rng) -> dict:
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.tensor(3.0, device="cuda")
    corr = torch.stack([1.0 - 0.9**t, 1.0 - 0.999**t]).to(torch.float32)
    worst = 0.0
    for kind in KINDS:
        # d = 64 row form on a 500,000-row table, ~8,192 touched lines
        lay = line_layout(64, kind)
        if lay.r != 1:  # sgd/adagrad/rowwise pack several d=64 rows a line
            ids = torch.from_numpy(rng.integers(0, 500_000, 8192)).cuda()
            ul, seg, _ = sp.dedupe_ids(ids, vocab=500_000, rows_per_line=lay.r)
            c = ul.shape[0]
            g = sp._segment_sum(torch.randn((8192, 64), generator=gen, device="cuda"),
                                seg, c * lay.r).view(c, lay.r, 64)
            tl = (sp._segment_sum(torch.ones(8192, device="cuda"), seg, c * lay.r)
                  > 0).to(torch.float32).view(c, lay.r)
        else:
            ids = torch.from_numpy(rng.integers(0, 500_000, 8192)).cuda()
            ul, _, _ = sp.dedupe_ids(ids, vocab=500_000)
            g = torch.randn((ul.shape[0], 64), generator=gen, device="cuda")
            tl = None
        fat0 = random_fat(torch, lay, 500_000, gen)
        worst = max(worst, oracle_case(torch, kl, f"{kind} d=64 R={lay.r}",
                                       fat0, ul, g, tl, corr, lay))
        del fat0
        # d = 16 packed form: several rows per line, a touched mask, some
        # padding ids (-1) that dedupe to the sentinel line
        lay = line_layout(16, kind)
        idn = rng.integers(0, 200_000, 8192)
        idn[rng.random(8192) < 0.02] = -1
        ids = torch.from_numpy(idn).cuda()
        ul, seg, _ = sp.dedupe_ids(ids, vocab=200_000, rows_per_line=lay.r)
        c = ul.shape[0]
        g = sp._segment_sum(torch.randn((8192, 16), generator=gen, device="cuda"),
                            seg, c * lay.r).view(c, lay.r, 16)
        tl = (sp._segment_sum((ids >= 0).to(torch.float32), seg, c * lay.r)
              > 0).to(torch.float32).view(c, lay.r)
        fat0 = random_fat(torch, lay, 200_000, gen)
        worst = max(worst, oracle_case(torch, kl, f"{kind} d=16 R={lay.r}",
                                       fat0, ul, g.contiguous(), tl, corr, lay))
        # sentinel, negative and out-of-range lines, untouched shared slots
        lay = line_layout(16, kind)
        fat0 = random_fat(torch, lay, 64 * lay.r, gen)
        ul = torch.tensor([3, 7, 2**31 - 1, 10, -5, 64, 11, 2**31 - 1],
                          dtype=torch.int32, device="cuda")
        g = torch.randn((8, lay.r, 16), generator=gen, device="cuda")
        tl = (torch.rand((8, lay.r), generator=gen, device="cuda") > 0.5
              ).to(torch.float32)
        tl[0] = 1.0
        worst = max(worst, oracle_case(torch, kl, f"{kind} d=16 edge lines",
                                       fat0, ul, g, tl, corr, lay))
    say(f"oracle: fat_line_update passed, worst max_abs_err {worst:.3e}")
    return {"max_abs_err": worst}


def timed_ms(torch, fn, n, flush):
    """Mean CUDA-event time of ``fn`` over ``n`` launches, the 50 MB L2
    flushed (a 256 MB write) before each one."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


EDGE_CALLS = 3  # unmeasured calls before and after a profile's window


def device_ms(torch, fn, n, flush, key=None, tries=4, per_call=False):
    """Median device duration per launch under ``torch.profiler`` (CUPTI's
    kernel start and end, no launch or event overhead) of the one kernel
    that each call of ``fn`` launches, whose name holds ``key`` (``None``:
    whatever ``fn`` launches), the L2 flushed before each call as in
    :func:`timed_ms`.  The ``n`` calls lie between two 4-byte host-to-device
    copies (markers on the device timeline), with ``EDGE_CALLS`` calls more
    before and after them: the tracer has been seen to drop a kernel's
    record, and the records at a profile's edge may go (on one H100 host,
    every profile of ``bf16_timing`` lost a marker and a kernel's record
    when one call padded each side).  Every one of the ``n`` calls
    between the markers must have its record; a profile that lost any is
    taken again, up to ``tries`` times, and then the reading fails.  20 ms
    of host time pad the window at both ends.  With ``per_call`` (a library
    call that launches kernels of its own choosing) a marker precedes each
    call's flush instead, and a call's duration is the sum over every device
    operation between its marker and the next but the first, its flush;
    every call must show the same number of them.  Returns ``(ms,
    records)``, or ``(None, 0)`` (not measured, said with the misses) when
    every profile lost records: the tracer's fault, not the kernel's, and
    seen on one H100 host in every profile of one kernel."""
    from torch.profiler import ProfilerActivity, profile

    mark, one = torch.zeros(1, device="cuda"), torch.ones(1)

    def call():
        flush.zero_()
        fn()

    if per_call:
        return _device_ms_per_call(torch, call, n, mark, one, tries)
    misses = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(EDGE_CALLS):
                call()
            mark.copy_(one)
            for _ in range(n):
                call()
            mark.copy_(one)
            for _ in range(EDGE_CALLS):
                call()
            torch.cuda.synchronize()
            time.sleep(0.02)
        dev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        marks = sorted(e.time_range.start for e in dev
                       if "Memcpy" in e.name and "HtoD" in e.name)
        ks = [e for e in dev if "FillFunctor" not in e.name
              and "Memcpy" not in e.name and (key is None or key in e.name)]
        inside = [e.time_range.elapsed_us() for e in ks if len(marks) == 2
                  and marks[0] < e.time_range.start < marks[1]]
        if len(inside) > n:  # one kernel per call
            raise AssertionError(f"device_ms: {len(inside)} kernels matching "
                                 f"{key!r} in {n} calls")
        if len(inside) == n:
            return float(np.median(inside)) / 1e3, n
        misses.append(f"{len(inside)} between {len(marks)} markers, "
                      f"{len(ks)} of {n + 2 * EDGE_CALLS} in all")
    say(f"  device_ms of {key!r}: not measured, records of the {n} calls "
        f"missing in {tries} profiles: {misses}")
    return None, 0


def _device_ms_per_call(torch, call, n, mark, one, tries):
    """:func:`device_ms` with ``per_call``: ``(median per-call ms, n)``."""
    from torch.profiler import ProfilerActivity, profile

    misses = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(EDGE_CALLS):
                call()
            for _ in range(n):
                mark.copy_(one)
                call()
            mark.copy_(one)
            for _ in range(EDGE_CALLS):
                call()
            torch.cuda.synchronize()
            time.sleep(0.02)
        dev = sorted((e for e in prof.events()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        marks = [e.time_range.start for e in dev
                 if "Memcpy" in e.name and "HtoD" in e.name]
        ops = [e for e in dev if not ("Memcpy" in e.name and "HtoD" in e.name)]
        calls = [[e for e in ops if a < e.time_range.start < b]
                 for a, b in zip(marks, marks[1:])]
        counts = {len(c) for c in calls}
        if (len(calls) == n and len(counts) == 1 and min(counts) > 1
                and all("FillFunctor" in c[0].name for c in calls)):
            return float(np.median([sum(e.time_range.elapsed_us() for e in c[1:])
                                    for c in calls])) / 1e3, n
        misses.append(f"{len(calls)} calls between {len(marks)} markers, "
                      f"device operations per call {sorted(counts)}")
    say(f"  device_ms per call: not measured, {n} calls not all recorded "
        f"alike in {tries} profiles: {misses}")
    return None, 0


def device_readings(torch, fn, n, flush, key=None, most=4, per_call=False):
    """:func:`device_ms` readings, taken until the last two agree within
    25% (at most ``most``; a reading far off its neighbour has been seen
    once); fails if none do.  Returns ``(readings, records per reading)``:
    the value reported is the mean of the last two (:func:`dev_mean`);
    ``([], 0)`` when a profile lost records (:func:`device_ms`)."""
    reads = []
    while len(reads) < 2 or max(reads[-2:]) > 1.25 * min(reads[-2:]):
        if len(reads) == most:
            raise AssertionError(f"device_ms of {key!r}: no two consecutive "
                                 f"readings agree within 25%: {reads} ms")
        ms = device_ms(torch, fn, n, flush, key, per_call=per_call)[0]
        if ms is None:
            return [], 0
        reads.append(ms)
    return reads, n


def dev_mean(ds):
    """The device ms reported from :func:`device_readings`' readings."""
    return sum(ds[-2:]) / 2 if ds else None


def launch_floor(torch, flush, n=50) -> dict:
    """The harness's floor: an empty kernel (``torch.cuda._sleep(0)``, a
    spin kernel of zero cycles) under :func:`timed_ms` and
    :func:`device_ms`."""
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    empty()
    dev, rec = device_ms(torch, empty, n, flush)
    floor = {"ms": timed_ms(torch, empty, n, flush), "device_ms": dev}
    say(f"  launch floor: empty kernel {floor['ms']:.6f} ms (CUDA events), "
        f"{dev} ms (profiler device duration, median of {rec}/{n} records)")
    return floor


def time_in_turns(torch, run_k, run_p, n_k, n_p, flush, key):
    """Kernel and plain version in turns (kernel, plain, kernel, plain) with
    CUDA events, then the kernel's profiler device durations
    (:func:`device_readings`): ``(kernel ms list, plain ms list, device ms
    list, records per device reading)``."""
    ks, ps = [], []
    for _ in range(2):
        ks.append(timed_ms(torch, run_k, n_k, flush))
        ps.append(timed_ms(torch, run_p, n_p, flush))
    ds, rec = device_readings(torch, run_k, n_k, flush, key)
    return ks, ps, ds, rec


def phase_timing(torch, rng) -> dict:
    """Kernel and plain version at the main path's shape: the stacked
    user+item fat array (700,000 rows, d = 64 adam, R = 1) and one batch's
    deduplicated line ids (capacity 2 x 8192) — first held against each
    other on these operands, then timed."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    lay = line_layout(DIM, "adam")
    rows = SIZE_MAP["user"] + SIZE_MAP["item"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    fat = random_fat(torch, lay, rows, gen)
    ids = np.concatenate([rng.integers(0, SIZE_MAP["user"], BATCH),
                          SIZE_MAP["user"] + rng.integers(0, SIZE_MAP["item"], BATCH)])
    ul, _, valid = sp.dedupe_ids(torch.from_numpy(ids).cuda(), vocab=rows)
    g = torch.randn((ul.shape[0], DIM), generator=gen, device="cuda") * 1e-3
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=LR, weight_decay=WD)
    err = oracle_case(torch, kl, "adam d=64 main-path shape", fat, ul, g, None,
                      corr, lay)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    run_k = lambda: kl.fat_line_update(fat, ul, g, None, corr, **kw)  # noqa: E731
    run_p = lambda: kl.fat_line_update_plain(fat, ul, g, None, corr, **kw)  # noqa: E731
    for _ in range(3):
        run_k()
        run_p()
    floor = launch_floor(torch, flush)
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 20, flush,
                                    "fat_line_update_kernel")
    u_real = int(valid.sum())
    nbytes = u_real * (2 * 3 * DIM + DIM) * 4 + ul.shape[0] * 4 + 8
    flops = u_real * DIM * ADAM_FLOP_PER_ELEMENT
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    ms, plain_ms = sum(ks) / len(ks), sum(ps) / len(ps)
    say(f"timing: fat_line_update at the main path's shape (adam d={DIM}, "
        f"{rows} rows, {u_real} touched lines of {ul.shape[0]} slots): "
        f"kernel {ks} ms (profiler device {ds} ms, medians of {rec}/50 "
        f"records), plain {ps} ms; bound "
        f"{bound:.6f} ms by {bound_by} "
        f"({nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s = {bytes_ms:.6f} ms; "
        f"{flops} f32 flop at {F32_FLOP_PER_S / 1e12} TFLOP/s = {ops_ms:.6f} ms)")
    del fat
    torch.cuda.empty_cache()
    # the other shapes the kernel serves, from a stream of their own (the
    # shared one feeds the later phases)
    srng = np.random.default_rng(7)
    shapes = {"bert4rec": fat_timing_shape(
        torch, kl, f"timing: fat_line_update at the Bert4Rec shape (adam d={DIM}, "
        f"{B4R['n_items'] + 2} rows, one b4r_batch's lines)", lay,
        B4R["n_items"] + 2, b4r_batch(srng)["item"].reshape(-1), gen, flush, corr)}
    host = make_host_batch(srng, CONFIG_BATCH)
    ids = np.concatenate([host["user_id"], SIZE_MAP["user"] + host["item_id"]])
    shapes["config_packed"] = fat_timing_shape(
        torch, kl, f"timing: fat_line_update at config.toml's packed shape (adam "
        f"d={CONFIG_DIM} R=2, {rows} rows, B={CONFIG_BATCH})",
        line_layout(CONFIG_DIM, "adam"), rows, ids, gen, flush, corr)
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_mean(ds),
            "device_records": rec, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "floor": floor, "shapes": shapes}


def phase_segsum(torch, rng) -> dict:
    """``segment_sum`` (the port's deterministic segment sum) against its
    plain version (``index_add_`` on the CPU) at every shape the main paths
    give it, bitwise; then timed at the TwoTower fat stack's shape."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum, segment_sum_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = SIZE_MAP["user"] + SIZE_MAP["item"]
    ids = np.concatenate([rng.integers(0, SIZE_MAP["user"], BATCH),
                          SIZE_MAP["user"] + rng.integers(0, SIZE_MAP["item"], BATCH)])
    ids[::7] = ids[1::7][:len(ids[::7])]  # repeated ids: segments of several
    idt = torch.from_numpy(ids).cuda()
    ul, seg, _, plan = sp.dedupe_ids(idt, vocab=rows, with_plan=True)
    x = torch.randn((ids.shape[0], DIM), generator=gen, device="cuda") * 1e-3
    zipf = torch.from_numpy(((rng.zipf(1.2, BATCH) - 1) % 5000).astype(np.int64)).cuda()
    zipf[::50] = -1
    bins = torch.from_numpy(rng.integers(-3, 203, BATCH)).cuda()
    cases = [  # (what, x, seg, n, plan)
        ("fat stack grads, the dedupe's plan", x, seg, ul.shape[0], plan),
        ("fat stack grads, own sort", x, seg, ul.shape[0], None),
        ("lazy tier, zipf ids of a 5,000-row table",
         torch.randn((BATCH, DIM), generator=gen, device="cuda"), zipf, 5000, None),
        ("AUC histogram, 200 bins", torch.rand(BATCH, generator=gen, device="cuda"),
         bins, 200, None),
        ("bf16 rows", x.to(torch.bfloat16), seg, ul.shape[0], None),
        ("f16 embedding grads", x.to(torch.float16), idt, rows, None),
        ("no rows", x[:0], seg[:0], 16, None),
    ]
    for what, xx, ss, n, pl in cases:
        want = segment_sum_plain(xx.cpu(), ss.cpu(), n)
        got = segment_sum(xx, ss, n, pl)
        if not torch.equal(got.cpu().float().view(torch.int32)
                           if got.dtype != torch.float32 else got.cpu(),
                           want.float().view(torch.int32)
                           if want.dtype != torch.float32 else want):
            bad = int((got.cpu().float() != want.float()).sum())
            raise AssertionError(f"segsum: {what}: {bad} elements differ from "
                                 "index_add_ on the CPU")
        say(f"segsum: {what}: {tuple(xx.shape)} -> {n} segments, bitwise the "
            "CPU's index_add_")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    n = ul.shape[0]
    run_k = lambda: segment_sum(x, seg, n, plan)  # noqa: E731
    run_p = lambda: segment_sum_plain(x, seg, n)  # noqa: E731

    def run_lib():
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            torch.zeros((n, DIM), device="cuda").index_put_((seg,), x, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was)

    for _ in range(3):
        run_k()
        run_p()
        run_lib()
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 50, flush,
                                    "segment_sum_kernel")
    lib = [timed_ms(torch, run_lib, 50, flush) for _ in range(2)]
    nbytes = x.numel() * 4 + seg.numel() * 8 + n * DIM * 4
    ops = x.numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    say(f"segsum: at the TwoTower fat stack's shape ({tuple(x.shape)} f32 -> "
        f"{n} segments, the dedupe's plan given): wrapper {ks} ms (kernel "
        f"device {ds} ms, {rec}/50 records), plain index_add_ on the card {ps} "
        f"ms, deterministic index_put_(accumulate=True) {lib} ms; bound "
        f"{bound:.6f} ms by {bound_by} ({nbytes} B, {ops} f32 adds)")
    return {"ms": sum(ks) / len(ks), "plain_ms": sum(ps) / len(ps),
            "device_ms": dev_mean(ds), "device_records": rec,
            "library_ms": sum(lib) / len(lib), "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": 0.0}


def fat_timing_shape(torch, kl, label, lay, rows, ids, gen, flush, corr) -> dict:
    """``fat_line_update`` (f32 adam) on a ``rows``-row table at one step's
    deduplicated ``ids`` (the packed form with its touched mask when a line
    holds several rows): held against the plain version, then timed as at
    the main path's shape beside its byte bound (each touched slot's table
    and moments read and written and its grad read; ``ulines`` and the mask
    read)."""
    from tdfo_tpu_torch.ops import sparse as sp

    fat = random_fat(torch, lay, rows, gen)
    idt = torch.from_numpy(ids).cuda()
    ul, seg, valid = sp.dedupe_ids(idt, vocab=rows, rows_per_line=lay.r)
    c = ul.shape[0]
    if lay.r == 1:
        g = torch.randn((c, lay.d), generator=gen, device="cuda") * 1e-3
        tl, n_touched = None, int(valid.sum())
    else:
        g = sp._segment_sum(torch.randn((idt.shape[0], lay.d), generator=gen,
                                        device="cuda") * 1e-3,
                            seg, c * lay.r).view(c, lay.r, lay.d)
        tl = (sp._segment_sum((idt >= 0).to(torch.float32), seg, c * lay.r)
              > 0).to(torch.float32).view(c, lay.r)
        n_touched = int(tl.sum())
    err = oracle_case(torch, kl, label, fat, ul, g, tl, corr, lay)
    kw = dict(layout=lay, lr=LR, weight_decay=WD)
    run_k = lambda: kl.fat_line_update(fat, ul, g, tl, corr, **kw)  # noqa: E731
    run_p = lambda: kl.fat_line_update_plain(fat, ul, g, tl, corr, **kw)  # noqa: E731
    for _ in range(3):
        run_k()
        run_p()
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 20, flush,
                                    "fat_line_update_kernel")
    per_row = (2 * 3 * lay.d + lay.d) * 4
    nbytes = n_touched * per_row + c * 4 + (0 if tl is None else c * lay.r * 4) + 8
    out = _bound_record(f"{label}, {n_touched} touched slots of {c * lay.r}",
                        ks, ps, ds, rec, nbytes,
                        n_touched * lay.d * ADAM_FLOP_PER_ELEMENT, per_row, err)
    del fat
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 3


def build_main_path(torch, device, tables0, backbone0):
    """The bench.py:510-631 library flow on ``device`` from the given
    initial tables / backbone (copied, never mutated)."""
    import copy

    from tdfo_tpu_torch.models.twotower import ctr_embedding_specs
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_sparse_train_step,
    )

    coll = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    step = make_sparse_train_step(coll, ctr_sparse_forward(backbone))
    return coll, state, step


def to_device(torch, host, device):
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def user_rows(coll, state, user_ids):
    from tdfo_tpu_torch.ops.fat_lines import fat_gather_rows

    aname, _, off = coll.resolve("user_id")
    return fat_gather_rows(state.tables[aname], user_ids + off,
                           coll.fat_layout_for(aname)).cpu()


def phase_main_path(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    # one initial state, made on the CPU from fixed seeds, for both runs
    coll0 = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    tables0 = coll0.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    fat_arrays = sorted(k for k, v in tables0.items() if v.dim() == 3)
    say(f"main path: arrays {sorted(tables0)}; fat {fat_arrays}")
    rng = np.random.default_rng(7)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    touched_users = torch.from_numpy(np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64))

    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum

    coll, state, step = build_main_path(torch, "cuda", tables0, backbone0)
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    kl.fat_line_update.launches = 0
    segment_sum.launches = 0
    losses = []
    t_start = None
    for i, b in enumerate(dev_batches):
        if i == check_steps:
            torch.cuda.synchronize()
            rows_gpu = user_rows(coll, state, touched_users.cuda())
            t_start = time.perf_counter()
        state, loss = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / (steps - check_steps)
    launches = kl.fat_line_update.launches
    seg_launches = segment_sum.launches
    losses = [float(x) for x in losses]
    if seg_launches <= 0:
        raise AssertionError("segment_sum never launched on the main path")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = len(fat_arrays) * steps
    if launches != want:
        raise AssertionError(
            f"fat_line_update launched {launches} times in {steps} steps, "
            f"expected {want} ({len(fat_arrays)} fat array(s) x steps)")
    say(f"main path: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, fat_line_update launches {launches} "
        f"({launches // steps} per step), segment_sum launches {seg_launches} "
        f"({seg_launches / steps:.1f} per step), step_ms {step_ms:.4f} "
        f"(host clock over steps {check_steps + 1}-{steps}) on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    # the same first steps on the CPU path
    _, cstate, cstep = build_main_path(torch, "cpu", tables0, backbone0)
    closs = []
    for h in host[:check_steps]:
        cstate, loss = cstep(cstate, to_device(torch, h, "cpu"))
        closs.append(float(loss))
    rows_cpu = user_rows(coll, cstate, touched_users)
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(losses[:check_steps], closs, rtol=rtol, atol=atol)
    torch.testing.assert_close(rows_gpu, rows_cpu, rtol=rtol, atol=atol)
    err = float((rows_gpu - rows_cpu).abs().max())
    say(f"main path: card vs CPU over {check_steps} steps: losses "
        f"{losses[:check_steps]} vs {closs}; {touched_users.numel()} touched "
        f"user rows, max_abs_err {err:.3e} (rtol {rtol})")
    return {"launches": launches, "segment_sum_launches": seg_launches,
            "step_ms": step_ms, "losses": losses}


def profile_steps(torch, name, state, step, batches, warm, *step_args) -> None:
    """``torch.profiler`` over the steady steps ``batches[warm:]``; prints
    device time by kernel and the device's busy share of the window (host
    clock)."""
    from torch.profiler import ProfilerActivity, profile

    for b in batches[:warm]:
        state, _ = step(state, b, *step_args)
    torch.cuda.synchronize()
    steps = len(batches) - warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[warm:]:
            state, _ = step(state, b, *step_args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    n_kernels = sum(e.count for e in events)
    say(f"profile {name}: {steps} steps, wall {wall_ms:.4f} ms "
        f"({wall_ms / steps:.4f} ms/step), device busy {dev_us / 1e3:.4f} ms "
        f"({100 * dev_us / 1e3 / wall_ms:.2f}% of the window), "
        f"{n_kernels / steps:.1f} device ops per step")
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    for e in top[:15]:
        say(f"  {getattr(e, 'self_device_time_total', 0.0) / steps:10.2f} us/step "
            f"x{e.count // steps:<4d} {e.key[:110]}")


def phase_profile(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile``): the TwoTower main path's steps."""
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    coll0 = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    tables0 = coll0.init(0, device="cuda")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    _, state, step = build_main_path(torch, "cuda", tables0, backbone0)
    del tables0
    rng = np.random.default_rng(11)
    batches = [to_device(torch, make_host_batch(rng, BATCH), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "twotower", state, step, batches, warm)


# ---------------------------------------------------------------- phase 4


def phase_cli(torch) -> dict:
    """The TwoTower CLI journey, f32 storage and then bf16 storage
    (``[embeddings] table_dtype = "bfloat16"``: the packed d = 16, R = 2
    bf16 fat stack through ``fat_line_update``'s bf16 kernel; every table
    still bf16 after training)."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    out = {}
    for storage in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            cfg = tmp / "config.toml"
            cfg.write_text(
                f'data_dir = "{tmp / "data"}"\n'
                'model = "twotower"\nmodel_parallel = true\nembed_dim = 16\n'
                'fused_table_threshold = 0\nn_epochs = 1\n'
                'per_device_train_batch_size = 256\nper_device_eval_batch_size = 256\n'
                'log_every_n_steps = 4\n'
                f'[embeddings]\ntable_dtype = "{storage}"\n')
            for cmd in ("synth", "preprocess-ctr"):
                if launch.main([cmd, "--config", str(cfg)]) != 0:
                    raise AssertionError(f"launch {cmd} failed")
            kl.fat_line_update.launches = 0
            trainer = launch.run(["train", "--config", str(cfg), "--log-dir",
                                  str(tmp / "logs"), "--device", "cuda"])
            launches = kl.fat_line_update.launches
            recs = [json.loads(x) for x in
                    (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
        aucs = [r["auc"] for r in recs if "auc" in r]
        tr = [r for r in recs if "train_auc" in r]
        if not aucs or not (0.0 <= aucs[-1] <= 1.0) or not tr:
            raise AssertionError(f"metrics.jsonl lacks eval/train AUC: {recs}")
        if launches <= 0:
            raise AssertionError("CLI train never launched fat_line_update")
        dtypes = {str(t.dtype) for t in trainer.state.tables.values()}
        if dtypes != {f"torch.{storage}"}:
            raise AssertionError(f"{storage} CLI run ended with tables {dtypes}")
        say(f"cli ({storage} storage): synth -> preprocess-ctr -> train on the "
            f"card: eval auc {aucs[-1]:.4f}, train_auc {tr[-1]['train_auc']:.4f}, "
            f"fat_line_update launches {launches}, tables {sorted(dtypes)} after "
            "training")
        out[storage] = {"launches": launches, "auc": aucs[-1]}
    return out


# ---------------------------------------------------------------- phase 5


def flash_inputs(torch, dtype, b, h, t, dh, gen, masked_row=True):
    """q, k, v, dO on the card and a key mask: ~25% of keys masked at random
    (10% without ``masked_row``); with ``masked_row`` batch row 0 also has
    its first min(40, T/2) keys masked (a whole 32-key tile at T >= 80) and
    the last batch row has every key masked."""
    q, k, v, do = (torch.randn((b, h, t, dh), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    kv = torch.rand((b, t), generator=gen, device="cuda") > (
        0.25 if masked_row else 0.1)
    kv[:, -1] = True
    if masked_row:
        kv[0, :min(40, t // 2)] = False
        kv[-1] = False
    return q, k, v, do, kv


def flash_tol(torch, dtype, ref, f32_tol, floor=0.0):
    """``floor``: an absolute bf16 tolerance below the max-relative one, for
    cases whose exact result is 0 (a single key per row: dQ = 0 up to the
    rounding of ``dp - delta``), as the card tests' ``_flash_tol``."""
    if dtype == torch.float32:
        return dict(rtol=f32_tol, atol=f32_tol)
    return dict(rtol=2e-2, atol=2e-2 * float(ref.float().abs().max()) + floor)


def flash_check(torch, what, got, want, tol) -> float:
    """Kernel vs plain within ``tol`` (inf where the plain version has inf);
    returns the max |err| over the finite elements."""
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda s: f"{what}: {s}")
    fin = torch.isfinite(want)
    return float((got.float()[fin] - want.float()[fin]).abs().max()) if fin.any() else 0.0


def flash_against_plain(torch, fa, name, q, k, v, do, kv, masked_row,
                        floor=0.0) -> dict:
    """Each flash kernel against its plain version on the same operands
    (the backward pair gets the plain forward's lse and delta); returns the
    max |err| per kernel.  ``floor``: see :func:`flash_tol`."""
    f32 = q.dtype == torch.float32
    out, lse = fa.flash_fwd(q, k, v, kv)
    torch.cuda.synchronize()
    out_inf, none = fa.flash_fwd(q, k, v, kv, with_lse=False)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    torch.cuda.synchronize()
    if none is not None or not torch.equal(out_inf, out):
        raise AssertionError(f"{name}: the inference forward differs")
    err = {"flash_fwd": max(
        flash_check(torch, f"{name} out", out, out_p,
                    flash_tol(torch, q.dtype, out_p, 2e-5)),
        flash_check(torch, f"{name} lse", lse, lse_p, dict(rtol=2e-5, atol=2e-5)))}
    delta = (do.float() * out_p.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, kv, lse_p, delta)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    err["flash_bwd_dq"] = flash_check(torch, f"{name} dq", dq, dq_p,
                                      flash_tol(torch, q.dtype, dq_p, 1e-4, floor))
    err["flash_bwd_dkv"] = max(
        flash_check(torch, f"{name} dk", dk, dk_p,
                    flash_tol(torch, q.dtype, dk_p, 1e-4, floor)),
        flash_check(torch, f"{name} dv", dv, dv_p,
                    flash_tol(torch, q.dtype, dv_p, 1e-4, floor)))
    if masked_row and not (bool((out[-1] == 0).all())
                           and bool(torch.isinf(lse[-1]).all())
                           and all(bool((x[-1] == 0).all()) for x in (dq, dk, dv))):
        raise AssertionError(f"{name}: the fully masked row is not 0 / +inf")
    say(f"  {name}: max_abs_err fwd {err['flash_fwd']:.3e} dq "
        f"{err['flash_bwd_dq']:.3e} dkv {err['flash_bwd_dkv']:.3e}"
        f"{' (f32)' if f32 else ' (bf16)'}")
    return err


def phase_flash_oracle(torch) -> dict:
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {dt: dict.fromkeys(FLASH_KERNELS, 0.0) for dt in ("f32", "bf16")}
    # B = 3, H = 3 at the tile edges of the three kernels (T = 1, 15-17,
    # 24, 25, 31, 33, 63-65, 127, 128, 257): 9 heads, not a multiple of the
    # heads one block packs; their gradients may be exactly 0 (T = 1), so
    # bf16 takes the card tests' absolute floor of 1e-6
    cases = [(2, 2, t, dh, 0.0) for t in (20, 100, 4096) for dh in (32, 64)]
    cases += [(3, 3, t, dh, 1e-6)
              for t in (1, 15, 16, 17, 24, 25, 31, 33, 63, 64, 65, 127, 128, 257)
              for dh in (32, 64)]
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for b, h, t, dh, floor in cases:
            ops = flash_inputs(torch, dtype, b, h, t, dh, gen)
            err = flash_against_plain(torch, fa, f"{dt} B={b} H={h} T={t} Dh={dh}",
                                      *ops, masked_row=True, floor=floor)
            for k, e in err.items():
                worst[dt][k] = max(worst[dt][k], e)
    say(f"flash_oracle: passed, worst max_abs_err {worst}")
    return worst


# ---------------------------------------------------------------- phase 6


def flash_bound(torch, name, b, h, t, dh, dtype):
    """(bound ms, "bytes" | "operations"): each input read once, each output
    written once (fwd: q, k, v, mask -> out, lse; dQ: q, k, v, dO, mask, lse,
    delta -> dQ; dK/dV: the same -> dK, dV), flops over the type's peak."""
    es = 2 if dtype == torch.bfloat16 else 4
    tensor = b * h * t * dh * es
    rows = b * h * t * 4
    nbytes = {"flash_fwd": 4 * tensor + b * t + rows,
              "flash_bwd_dq": 5 * tensor + b * t + 2 * rows,
              "flash_bwd_dkv": 6 * tensor + b * t + 2 * rows}[name]
    flops = FLASH_FLOPS[name] * b * h * t * t * dh
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def flash_timing_shape(torch, fa, label, b, h, t, dh, dtype, gen, n_k, n_p,
                       kv=None) -> dict:
    import torch.nn.functional as F

    q, k, v, do, kv_r = flash_inputs(torch, dtype, b, h, t, dh, gen,
                                     masked_row=False)
    kv = kv_r if kv is None else kv
    err = flash_against_plain(torch, fa, f"timing {label}", q, k, v, do, kv,
                              masked_row=False)
    out, lse = fa.flash_fwd(q, k, v, kv)
    delta = (do.float() * out.float()).sum(-1)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    mask = kv[:, None, None, :]
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, kv),
                      lambda: fa.flash_fwd_plain(q, k, v, kv),
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, kv, lse, delta),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, do, kv, lse, delta),
                         None),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, kv, lse, delta),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse, delta),
                          None),
    }
    lib_bwd = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,  # noqa: E731
                                          retain_graph=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for run_k, run_p, _ in fns.values():
        for _ in range(2):
            run_k()
            run_p()
    fns["flash_fwd"][2]()
    lib_bwd()
    lib_bwd_ms = [timed_ms(torch, lib_bwd, n_p, flush) for _ in range(2)]
    lib_dev = {"fwd": device_readings(torch, fns["flash_fwd"][2], n_k, flush,
                                      per_call=True)[0],
               "bwd": device_readings(torch, lib_bwd, n_k, flush, per_call=True)[0]}
    res = {"floor": launch_floor(torch, flush)}
    for name, (run_k, run_p, run_l) in fns.items():
        ks_, ps_, ls_ = [], [], []
        for _ in range(2):  # in turns: kernel, plain, library, kernel, ...
            ks_.append(timed_ms(torch, run_k, n_k, flush))
            ps_.append(timed_ms(torch, run_p, n_p, flush))
            if run_l is not None:
                ls_.append(timed_ms(torch, run_l, n_k, flush))
        ds_, rec = device_readings(torch, run_k, n_k, flush, name)
        bound, by = flash_bound(torch, name, b, h, t, dh, dtype)
        lib = ls_ if run_l is not None else lib_bwd_ms
        lds = lib_dev["fwd" if run_l is not None else "bwd"]
        res[name] = {"ms": sum(ks_) / 2, "plain_ms": sum(ps_) / 2,
                     "device_ms": dev_mean(ds_), "device_records": rec,
                     "library_ms": sum(lib) / 2,
                     "library_device_ms": dev_mean(lds),
                     "bound_ms": bound, "bound_by": by,
                     "max_abs_err": err[name]}
        say(f"flash_timing {label}: {name} kernel {ks_} ms (profiler device "
            f"{ds_} ms, medians of {rec}/{n_k} records), plain {ps_} ms, "
            f"library {lib} ms (profiler device {lds} ms, medians of "
            f"{n_k} calls' summed kernels) "
            f"({'SDPA forward' if run_l is not None else 'SDPA backward, dQ+dK+dV'}); "
            f"bound {bound:.6f} ms by {by} ({FLASH_FLOPS[name]} B H T^2 Dh = "
            f"{FLASH_FLOPS[name] * b * h * t * t * dh} flop)")
    del flush
    return res


def b4r_batch(rng, b: int = B4R_BATCH) -> dict[str, np.ndarray]:
    """A random Bert4Rec training batch: items in [1, n_items], 20% of
    positions replaced by the MASK id and labelled, and every fourth row
    short, PAD-padded at the tail (as preprocess-seq pads train windows) or
    on the left (as it pads eval windows)."""
    n, t = B4R["n_items"], B4R["max_len"]
    item = rng.integers(1, n + 1, (b, t)).astype(np.int32)
    masked = rng.random((b, t)) < B4R_MASK_PROB
    label = np.where(masked, item, 0).astype(np.int32)
    item = np.where(masked, n + 1, item).astype(np.int32)
    for r in range(0, b, 4):
        keep = int(rng.integers(2, t))
        cols = slice(keep, None) if r % 8 else slice(0, t - keep)
        item[r, cols] = 0
        label[r, cols] = 0
    return {"item": item, "label": label}


def phase_flash_timing(torch) -> dict:
    """The JSON line's numbers come from the main path's shape; the
    bench_kernels.py shapes are printed beside them."""
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, hh, t = B4R["embed_dim"], B4R["n_heads"], B4R["max_len"]
    kv = torch.from_numpy(b4r_batch(np.random.default_rng(5))["item"] != 0).cuda()
    main = flash_timing_shape(torch, fa, f"main path B={B4R_BATCH} H={hh} T={t} "
                              f"Dh={d // hh} f32", B4R_BATCH, hh, t, d // hh,
                              torch.float32, gen, 50, 20, kv=kv)
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        flash_timing_shape(torch, fa, f"bench_kernels B=1 H=8 T=4096 Dh=64 {dt}",
                           1, 8, 4096, 64, dtype, gen, 10, 5)
    return main


# ---------------------------------------------------------------- phase 7


def b4r_initial():
    """One initial state, made on the CPU from fixed seeds, for every run."""
    from tdfo_tpu_torch.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec

    return make_sharded_bert4rec(Bert4RecConfig(**B4R), seed=B4R_SEED,
                                 attn="flash", device="cpu")


def b4r_state(torch, coll, tables0, backbone0, device):
    """``(state, step)`` on ``device`` from copies of the initial state."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_sparse_train_step,
    )

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    return state, make_sparse_train_step(coll, bert4rec_sparse_forward(backbone))


def item_slots(coll, state, ids):
    """The whole slots (weights | adam mu | nu | pad) of item rows ``ids``."""
    from tdfo_tpu_torch.ops.fat_lines import fat_view

    aname, _, off = coll.resolve("item")
    table = state.tables[aname]
    if table.dim() != 3:
        raise AssertionError("the Bert4Rec item table is not fat")
    return fat_view(table, coll.fat_layout_for(aname))[ids + off].cpu()


def flash_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    return {"fat_line_update": kl.fat_line_update.launches,
            **{k: getattr(fa, k).launches for k in FLASH_KERNELS}}


def zero_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    kl.fat_line_update.launches = 0
    for k in FLASH_KERNELS:
        getattr(fa, k).launches = 0


def phase_b4r_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    from tdfo_tpu_torch.interop import TOL

    coll, tables0, backbone0 = b4r_initial()
    n_layers = B4R["n_layers"]
    say(f"b4r_main: {B4R}, B {B4R_BATCH}, item array "
        f"{tuple(tables0['item_embedding'].shape)} (fat)")
    rng = np.random.default_rng(8)
    host = [b4r_batch(rng) for _ in range(steps)]
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    state, step = b4r_state(torch, coll, tables0, backbone0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(B4R_SEED + 1)
    torch.cuda.synchronize()
    zero_counts()
    losses = []
    t_start = None
    for i, b in enumerate(dev_batches):
        if i == check_steps:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        state, loss = step(state, b, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / (steps - check_steps)
    counts = flash_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {"fat_line_update": steps, **dict.fromkeys(FLASH_KERNELS, n_layers * steps)}
    if counts != want:
        raise AssertionError(f"launches in {steps} steps {counts}, expected {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"b4r_main: {steps} steps on the card at dropout {B4R['dropout']}, losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, launches {counts} "
        f"({n_layers} per step of each flash kernel), step_ms {step_ms:.4f} "
        f"(host clock over steps {check_steps + 1}-{steps}), peak device "
        f"memory {peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    # the first steps at dropout 0 on the card and on the CPU path
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["item"].ravel() for h in host[:check_steps]])).astype(np.int64))
    runs = {}
    for device in ("cuda", "cpu"):
        st, stp = b4r_state(torch, coll, tables0, backbone0, device)
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, item_slots(coll, st, touched.to(device)))
        del st
    rtol, atol = TOL["trajectory"]
    d = B4R["embed_dim"]
    (lg, sg), (lc, sc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=rtol, atol=atol)
    # Adam divides each gradient element by its own magnitude, so where an
    # element's summed gradient lies inside the f32 noise of the two
    # devices' summation orders its step may take either sign: the weight
    # then moves by up to 2 lr per step.  At most 0.1% of the elements may
    # do so, each within that bound; every other one holds rtol 1e-4.
    rg, rc = sg[:, :d], sc[:, :d]
    diff = (rg - rc).abs()
    out = diff > atol + rtol * rc.abs()
    n_out, bound = int(out.sum()), 2 * LR * check_steps
    worst_out = float(diff[out].max()) if n_out else 0.0
    mu_g, mu_c = sg[:, d:2 * d], sc[:, d:2 * d]
    flips = int((torch.sign(mu_g[out]) != torch.sign(mu_c[out])).sum())
    say(f"b4r_main: card vs CPU over {check_steps} steps at dropout 0: losses "
        f"{lg} vs {lc}; {touched.numel()} touched item rows, "
        f"{rg.numel()} elements: max_abs_err {float(diff[~out].max()):.3e} "
        f"inside rtol {rtol}; {n_out} outside it, max |diff| {worst_out:.3e} "
        f"(bound {bound:.1e}), {flips} of them with the adam first moment of "
        f"opposite sign; median |mu| there "
        f"{float(mu_c.abs()[out].median()) if n_out else 0.0:.3e} vs "
        f"{float(mu_c.abs().median()):.3e} over all elements")
    if n_out > 1e-3 * rg.numel() or worst_out > bound:
        raise AssertionError(
            f"card vs CPU: {n_out} item-row elements outside rtol {rtol} "
            f"(max |diff| {worst_out}); at most {1e-3 * rg.numel():.0f} within "
            f"{bound} allowed")
    return {"launches": counts, "step_ms": step_ms, "losses": losses}


def phase_profile_b4r(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_b4r``): the Bert4Rec main path's steps."""
    coll, tables0, backbone0 = b4r_initial()
    state, step = b4r_state(torch, coll, tables0, backbone0, "cuda")
    rng = np.random.default_rng(12)
    batches = [to_device(torch, b4r_batch(rng), "cuda") for _ in range(warm + steps)]
    gen = torch.Generator(device="cuda").manual_seed(B4R_SEED + 1)
    profile_steps(torch, "bert4rec", state, step, batches, warm, gen)


# ---------------------------------------------------------------- phase 8


def phase_b4r_cli(torch) -> dict:
    from tdfo_tpu_torch import launch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = tmp / "config.toml"
        cfg.write_text(
            f'data_dir = "{tmp / "data"}"\n'
            'model = "bert4rec"\nattn = "flash"\nmodel_parallel = true\n'
            'embed_dim = 16\nfused_table_threshold = 0\nn_epochs = 1\n'
            'per_device_train_batch_size = 32\nper_device_eval_batch_size = 32\n'
            'log_every_n_steps = 4\n')
        for cmd in ("synth", "preprocess-seq"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        zero_counts()
        rc = launch.main(["train", "--config", str(cfg), "--log-dir",
                          str(tmp / "logs"), "--device", "cuda"])
        counts = flash_counts()
        if rc != 0:
            raise AssertionError("launch train failed")
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    keys = [f"{m}@{k}" for k in (10, 20, 50) for m in ("Recall", "NDCG")]
    evals = [r for r in recs if all(k in r for k in keys)]
    tests = [r for r in recs if all(f"test_{k}" in r for k in keys)]
    vals = [r[k] for r in evals for k in keys] + [r[f"test_{k}"] for r in tests
                                                  for k in keys]
    if not evals or not tests or not all(0.0 <= x <= 1.0 for x in vals):
        raise AssertionError(f"metrics.jsonl lacks Recall/NDCG or test_*: {recs}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"CLI train left a kernel unlaunched: {counts}")
    say(f"b4r_cli: synth -> preprocess-seq -> train on the card: "
        f"{ {k: round(evals[-1][k], 4) for k in keys} }, test "
        f"{ {k: round(tests[-1]['test_' + k], 4) for k in keys} }, launches {counts}")
    return {"launches": counts}


# ------------------------------------------------------------ phases 9, 10


def routed_operands(torch, lay, rows, ids, gen, *, pad_rows=8):
    """One step's routed operands on a fat table of ``rows`` vocab rows:
    ``dedupe_rows_and_lines`` over ``ids`` with capacities as the dedup
    step sizes them (+ ``pad_rows`` padding row slots), the forward's line
    gather and random row grads (padding rows included: they must be
    ignored)."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.parallel.embedding import take_fill

    fat = random_fat(torch, lay, rows, gen)
    b = ids.shape[0]
    seg, ul, rl, rs = sp.dedupe_rows_and_lines(
        ids, capacity_rows=b + pad_rows, capacity_lines=b, rows_per_line=lay.r)
    lines = take_fill(fat, torch.where(ul < OOB, ul, 0)).contiguous()
    g_u = torch.randn((b + pad_rows, lay.d), generator=gen, device="cuda")
    return fat, lines, ul, rl, rs, g_u


def routed_case(torch, name, lay, fat0, lines, ul, rl, rs, g_u, corr) -> float:
    """Routed kernel vs its plain version (touched rows within the
    optimizer tolerance, everything else bitwise unchanged) and vs
    ``fat_line_update`` on the same update in slot space (bitwise).
    Clones of ``fat0``; returns the max |err| against the plain version."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    rtol, atol = TOL["optimizer"]
    kw = dict(layout=lay, lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    g_slots, touched = kr.routed_to_slots(ul, rl, rs, g_u, lay)
    m = touched_mask(torch, fat0, ul, touched, lay)
    v0 = fat0.view(-1, lay.w).view(torch.int32)

    def untouched_changed(t):
        return bool(((t.view(-1, lay.w).view(torch.int32) != v0) & ~m).any())

    a = fat0.clone()
    kr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr, **kw)
    torch.cuda.synchronize()
    if untouched_changed(a):
        raise AssertionError(f"{name}: plain version changed untouched elements")
    ref_touched = a.view(-1, lay.w)[m]
    del a
    b = fat0.clone()
    kr.fat_line_update_routed(b, lines, ul, rl, rs, g_u, corr, **kw)
    torch.cuda.synchronize()
    vb = b.view(-1, lay.w)
    if untouched_changed(b):
        raise AssertionError(f"{name}: kernel changed untouched elements")
    if not torch.isfinite(vb[m]).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(vb[m], ref_touched, rtol=rtol, atol=atol,
                               msg=lambda s_: f"{name}: {s_}")
    err = float((vb[m] - ref_touched).abs().max()) if m.any() else 0.0
    c = fat0.clone()
    kl.fat_line_update(c, ul, g_slots, touched, corr, **kw)
    torch.cuda.synchronize()
    if not torch.equal(b.view(torch.int32), c.view(torch.int32)):
        raise AssertionError(f"{name}: routed kernel differs from fat_line_update")
    del b, c
    n_rows = int(m.any(dim=1).sum())
    shared = int((touched.sum(dim=1) > 1).sum())
    say(f"  {name}: touched rows {n_rows} ({shared} lines hold 2+ of them), "
        f"max_abs_err {err:.3e}, bitwise equal to fat_line_update, "
        f"bitwise-unchanged elements {int((~m).sum())}")
    return err


def criteo_fat_rows() -> int:
    return sum(v for v in CRITEO_VOCABS if v > CRITEO_FUSED_MIN)


def phase_routed_oracle(torch, rng) -> dict:
    from tdfo_tpu_torch.ops.fat_lines import line_layout

    gen = torch.Generator(device="cuda").manual_seed(20)
    t = torch.tensor(3.0, device="cuda")
    corr = torch.stack([1.0 - 0.9**t, 1.0 - 0.999**t]).to(torch.float32)
    worst = 0.0
    cases = [(kind, 16, criteo_fat_rows() if kind == "rowwise_adagrad"
              else 2_000_000) for kind in KINDS]
    cases += [("rowwise_adagrad", 8, 2_000_000), ("adam", 64, 2_000_000)]
    for kind, d, rows in cases:
        lay = line_layout(d, kind)
        idn = rng.integers(0, rows, BATCH * 4)
        idn[rng.random(idn.shape[0]) < 0.01] = -1      # the sentinel row
        idn[1::97] = idn[::97][: idn[1::97].shape[0]] ^ 1  # neighbours share lines
        ids = torch.from_numpy(idn).cuda()
        fat, lines, ul, rl, rs, g_u = routed_operands(torch, lay, rows, ids, gen)
        worst = max(worst, routed_case(
            torch, f"{kind} d={d} R={lay.r} rows={rows}", lay, fat, lines, ul,
            rl, rs, g_u, corr))
        del fat, lines
        torch.cuda.empty_cache()
    # every touched line holding R touched rows (all slots of n lines), row
    # counts ragged against the rows per warp and the resident grid's rows
    # per pass (several passes), plus 5 padding rows
    for kind, d, n_lines in (("rowwise_adagrad", 16, 150_001),
                             ("adam", 32, 100_003), ("sgd", 8, 40_001)):
        lay = line_layout(d, kind)
        rows = (n_lines + 9) * lay.r
        ids = torch.from_numpy(rng.permutation(n_lines * lay.r)).cuda()
        fat, lines, ul, rl, rs, g_u = routed_operands(torch, lay, rows, ids, gen,
                                                      pad_rows=5)
        worst = max(worst, routed_case(
            torch, f"{kind} d={d} R={lay.r} full lines, {rl.shape[0]} row slots",
            lay, fat, lines, ul, rl, rs, g_u, corr))
        del fat, lines
    # hand-made edges: sentinel lines, a line past the table, padding rows
    lay = line_layout(16, "rowwise_adagrad")
    fat = random_fat(torch, lay, 64 * lay.r, gen)
    ul = torch.tensor([3, 7, 40, 70, OOB, OOB], dtype=torch.int32, device="cuda")
    rl = torch.tensor([0, 0, 0, 1, 2, 3, 4, 6, 6], dtype=torch.int32, device="cuda")
    rs = torch.tensor([0, 1, 3, 2, 1, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    lines = fat[torch.where(ul < 64, ul, 0).long()].contiguous()
    g_u = torch.randn((9, 16), generator=gen, device="cuda")
    worst = max(worst, routed_case(torch, "rowwise_adagrad d=16 edge lines", lay,
                                   fat, lines, ul, rl, rs, g_u, corr))
    say(f"routed_oracle: fat_line_update_routed passed, worst max_abs_err {worst:.3e}")
    return {"max_abs_err": worst}


def criteo_host_batch(rng: np.random.Generator, b: int = BATCH) -> dict:
    """bench.py:248-265 (uniform ids)."""
    out = {c: rng.integers(0, v, b, dtype=np.int32)
           for c, v in zip(CRITEO_CATS, CRITEO_VOCABS)}
    out.update({c: rng.random(b, dtype=np.float32) for c in CRITEO_CONTS})
    out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return out


def phase_routed_timing(torch, rng) -> dict:
    """The routed kernel at the DLRM main path's shape: one step's fat ids
    (the 8 big features x B, offsets into the stack, dedup capacities)."""
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    lay = line_layout(CRITEO_DIM, "rowwise_adagrad")
    rows = criteo_fat_rows()
    gen = torch.Generator(device="cuda").manual_seed(21)
    big = [v for v in CRITEO_VOCABS if v > CRITEO_FUSED_MIN]
    offs = np.cumsum([0] + big[:-1])
    ids = np.concatenate([o + rng.integers(0, v, BATCH) for o, v in zip(offs, big)])
    fat, lines, ul, rl, rs, g_u = routed_operands(
        torch, lay, rows, torch.from_numpy(ids).cuda(), gen, pad_rows=0)
    g_u *= 1e-3
    corr = torch.zeros(2, device="cuda")
    err = routed_case(torch, "rowwise_adagrad main-path shape", lay, fat, lines,
                      ul, rl, rs, g_u, corr)
    kw = dict(layout=lay, lr=3e-4, eps=1e-8)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    run_k = lambda: kr.fat_line_update_routed(fat, lines, ul, rl, rs, g_u, corr, **kw)  # noqa: E731
    run_p = lambda: kr.fat_line_update_routed_plain(fat, lines, ul, rl, rs, g_u, corr, **kw)  # noqa: E731
    for _ in range(3):
        run_k()
        run_p()
    floor = launch_floor(torch, flush)
    ks, ps, ds, rec = time_in_turns(torch, run_k, run_p, 50, 20, flush,
                                    "fat_line_update_routed")
    c = ul.shape[0]
    lidx = rl.to(torch.int64)
    line_of = torch.where(lidx < c, ul.to(torch.int64)[lidx.clamp(max=c - 1)], OOB)
    n_rows = int(((lidx < c) & (line_of < fat.shape[0])).sum())
    cr = rl.shape[0]
    # per updated row: the slot's need lanes read (from lines) and written,
    # its d grads read, row_lidx + row_slot + its ulines entry; every other
    # row slot reads its row_lidx; corr
    per_row = 2 * lay.need * 4 + lay.d * 4 + 12
    nbytes = n_rows * per_row + (cr - n_rows) * 4 + 8
    flops = n_rows * (lay.d * ROWWISE_FLOP_PER_ELEMENT + ROWWISE_FLOP_PER_ROW)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    ms, plain_ms = sum(ks) / len(ks), sum(ps) / len(ps)
    say(f"routed_timing: fat_line_update_routed at the DLRM main path's shape "
        f"(rowwise_adagrad d={CRITEO_DIM} R={lay.r}, {rows} rows in "
        f"{fat.shape[0]} lines, {n_rows} updated rows of {cr} row slots, "
        f"{c} line slots): kernel {ks} ms (profiler device {ds} ms, medians "
        f"of {rec}/50 records), plain "
        f"{ps} ms; bound {bound:.6f} ms "
        f"by {bound_by} ({per_row} B per row, {nbytes} B at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s = {bytes_ms:.6f} ms; {flops} f32 flop "
        f"at {F32_FLOP_PER_S / 1e12} TFLOP/s = {ops_ms:.6f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_mean(ds),
            "device_records": rec, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "floor": floor}


# ------------------------------------------------------------ phases 11, 12


def dlrm_initial(torch):
    """The main path's collection, initial tables (on the card) and
    backbone (on the CPU), from fixed seeds."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    coll = ShardedEmbeddingCollection(
        generic_embedding_specs(size_map, CRITEO_CATS, CRITEO_DIM, "row",
                                fused_threshold=CRITEO_FUSED_MIN),
        stack_tables=True, fused_kind="rowwise_adagrad")
    tables0 = coll.init(0, device="cuda")
    backbone0 = DLRMBackbone(CRITEO_DIM, cat_columns=CRITEO_CATS,
                             cont_columns=CRITEO_CONTS,
                             generator=torch.Generator().manual_seed(1))
    return coll, tables0, backbone0


def dlrm_state(torch, coll, tables0, backbone0, device, kind="rowwise_adagrad"):
    """``(state, step)`` on ``device`` from copies of the initial state,
    the sparse optimizer ``kind`` (the config's rowwise_adagrad unless
    told)."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_sparse_train_step,
    )

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer(kind, lr=LR),
        learning_rate=LR, weight_decay=WD)
    return state, make_sparse_train_step(coll, ctr_sparse_forward(backbone),
                                         dedup_lookup=True)


def dlrm_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    return {"fat_line_update": kl.fat_line_update.launches,
            "fat_line_update_routed": kr.fat_line_update_routed.launches}


def zero_dlrm_counts():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    kl.fat_line_update.launches = 0
    kr.fat_line_update_routed.launches = 0


def dlrm_touched_rows(torch, coll, state, host):
    """Each stack's touched rows ``[n, W]`` (fat: the whole slot, table and
    state; plain: the row and its accumulator), on the CPU."""
    from tdfo_tpu_torch.ops.fat_lines import fat_view

    out = {}
    for aname, table in state.tables.items():
        feats = [c for c in CRITEO_CATS if coll.resolve(c)[0] == aname]
        ids = np.unique(np.concatenate(
            [h[c].astype(np.int64) + coll.resolve(c)[2] for h in host for c in feats]))
        idx = torch.from_numpy(ids).to(table.device)
        if table.dim() == 3:
            out[aname] = fat_view(table, coll.fat_layout_for(aname))[idx].cpu()
        else:
            acc = state.slots[aname][0][idx]
            out[aname] = torch.cat([table[idx].float(),
                                    acc.view(idx.shape[0], -1).float()], dim=1).cpu()
    return out


def phase_dlrm_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    from tdfo_tpu_torch.interop import TOL

    coll, tables0, backbone0 = dlrm_initial(torch)
    shapes = {k: tuple(v.shape) for k, v in tables0.items()}
    say(f"dlrm_main: arrays {shapes}, B {BATCH}, d {CRITEO_DIM}, "
        f"rowwise_adagrad lr {LR}, dense AdamW lr {LR} wd {WD}, dedup_lookup")
    rng = np.random.default_rng(9)
    host = [criteo_host_batch(rng) for _ in range(steps)]
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda")
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_dlrm_counts()
    losses, times = [], []
    for b in dev_batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = dlrm_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {"fat_line_update": 0, "fat_line_update_routed": steps}
    if counts != want:
        raise AssertionError(f"launches in {steps} steps {counts}, expected {want}")
    steady = times[check_steps:]
    step_ms = float(np.median(steady))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"dlrm_main: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, launches {counts} (1 routed per step), step_ms "
        f"median {step_ms:.4f} mean {float(np.mean(steady)):.4f} min "
        f"{min(steady):.4f} max {max(steady):.4f} (host clock, each step "
        f"synchronised, steps {check_steps + 1}-{steps}; {BATCH / step_ms * 1e3:.0f} "
        f"examples/s), peak device memory {peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    # the first steps on the card and on the CPU path from one initial state
    runs = {}
    for device in ("cuda", "cpu"):
        src = tables0 if device == "cuda" else {k: v.cpu() for k, v in tables0.items()}
        st, stp = dlrm_state(torch, coll, src, backbone0, device)
        del src
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, dlrm_touched_rows(torch, coll, st, host[:check_steps]))
        del st
        torch.cuda.empty_cache()
    rtol, atol = TOL["trajectory"]
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=rtol, atol=atol)
    parts = []
    for aname in rg:
        g, c = rg[aname], rc[aname]
        diff = (g - c).abs()
        out = int((diff > atol + rtol * c.abs()).sum())
        parts.append(f"{aname}: {g.shape[0]} touched rows, {g.numel()} elements, "
                     f"max_abs_err {float(diff.max()):.3e}, {out} outside rtol {rtol}")
        torch.testing.assert_close(g, c, rtol=rtol, atol=atol,
                                   msg=lambda s_, a=aname: f"{a}: {s_}")
    say(f"dlrm_main: card vs CPU over {check_steps} steps: losses {lg} vs {lc}; "
        + "; ".join(parts))
    return {"launches": counts, "step_ms": step_ms, "losses": losses,
            "peak_gb": peak_gb}


def phase_profile_dlrm(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_dlrm``): the DLRM-Criteo main path's steps."""
    coll, tables0, backbone0 = dlrm_initial(torch)
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda")
    del tables0
    rng = np.random.default_rng(13)
    batches = [to_device(torch, criteo_host_batch(rng), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "dlrm-criteo", state, step, batches, warm)


def phase_dlrm_cli(torch) -> dict:
    from tdfo_tpu_torch import launch

    src = (ROOT / "configs" / "dlrm-criteo.toml").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        body = []
        for line in src.splitlines():
            if line.startswith("data_dir ="):
                line = f'data_dir = "{tmp / "data"}"'
            elif line.startswith("fused_table_threshold ="):
                line = "fused_table_threshold = 20"  # fat and plain stacks
            elif line.startswith("per_device_"):
                line = line.split("=")[0] + "= 256"
            body.append(line)
        cfg = tmp / "dlrm-criteo.toml"
        cfg.write_text("\n".join(body) + "\n")
        for cmd in ("synth-criteo", "preprocess-criteo"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        zero_dlrm_counts()
        rc = launch.main(["train", "--config", str(cfg), "--log-dir",
                          str(tmp / "logs"), "--device", "cuda"])
        counts = dlrm_counts()
        if rc != 0:
            raise AssertionError("launch train failed")
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    aucs = [r["auc"] for r in recs if "auc" in r]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    if not aucs or not all(0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"metrics.jsonl lacks eval AUC: {recs}")
    if counts["fat_line_update_routed"] != steps or steps <= 0:
        raise AssertionError(f"routed launches {counts} for {steps} steps")
    say(f"dlrm_cli: synth-criteo -> preprocess-criteo -> train on the card "
        f"(configs/dlrm-criteo.toml, fused_table_threshold 20): eval auc "
        f"{[round(a, 4) for a in aucs]}, {steps} steps, launches {counts}")
    return {"launches": counts}


# ------------------------------------------------------- phases 13-16 (bf16)

# The card-vs-CPU check of the bf16 paths (main_bf16, dlrm_bf16_main).
# Both devices compute the backbone in bf16 but accumulate its products in
# other orders, so a gradient element may differ by a rounding or two;
# the table write that follows is the same function with the same random
# bits on both, so a touched element is bitwise equal unless its f32 value
# straddles a rounding boundary (one ulp apart) or its gradient element is
# so small that the noise moves the optimizer's normalised step (up to
# ``step_bound`` a step: lr for adam and adagrad, whose first step is
# lr sign(g)).  Held: the losses within BF16_LOSS_RTOL; at most
# BF16_FAR_SHARE of the touched table elements more than one bf16 ulp
# apart and none beyond one ulp + 2 step_bound per step; and, as a control
# that must fail, the same share between the initial rows and the CPU's
# (what a card path that wrote no row, or other rows, would leave).
# Readings (NVIDIA H100 80GB HBM3, 700.00 W): losses within 2.8e-6
# (TwoTower) and 1.5e-5 (DLRM) relative; beyond one ulp 0.52% of the user
# elements, 1.44% of the DLRM fat stack's, 1.25% of its plain stack's;
# the control 99.97%, 99.71% and 80.18%.
BF16_LOSS_RTOL = 2e-4
BF16_FAR_SHARE = 0.05
SR_SEED = 1234567


def bf16_ulps(torch, a, b):
    """Distance in bf16 steps between two bf16 tensors of one shape."""
    def order(t):
        x = t.view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(x >= 0x8000, -(x & 0x7FFF), x)
    return (order(a) - order(b)).abs()


def bf16_case(torch, name, lay, fat0, m, run_k, run_p, seed=SR_SEED):
    """One bf16 kernel against its plain version on the card, on clones of
    the bf16 table ``fat0``: ``run_k(fat, seed)`` / ``run_p(fat, seed)``
    update ``fat`` in place (f32 or bf16; seed None for f32).  ``m`` [L*R,
    W]: the lanes the step may write.  Every other element stays bitwise
    ``fat0``; the touched ones are bitwise the plain version's wherever the
    f32 kernel is bitwise the f32 plain version on the same (widened)
    operands, one bf16 ulp apart elsewhere; another seed changes the bits.
    Returns ``(kernel result, max |err|, one-ulp elements)``."""
    w = lay.w
    b16 = fat0.view(-1, w).view(torch.int16)
    k16, p16 = fat0.clone(), fat0.clone()
    run_k(k16, seed)
    run_p(p16, seed)
    torch.cuda.synchronize()
    for t, who in ((k16, "kernel"), (p16, "plain version")):
        if bool(((t.view(-1, w).view(torch.int16) != b16) & ~m).any()):
            raise AssertionError(f"{name}: the {who} changed untouched elements")
    kt, pt = k16.view(-1, w)[m], p16.view(-1, w)[m]
    del p16
    if not torch.isfinite(kt.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    f32 = {}
    for who, run in (("k", run_k), ("p", run_p)):
        t = fat0.float()
        run(t, None)
        torch.cuda.synchronize()
        f32[who] = t.view(-1, w)[m]
        del t
    same32 = f32["k"].view(torch.int32) == f32["p"].view(torch.int32)
    ulps = bf16_ulps(torch, kt, pt)
    n_ulp, n_f32 = int((ulps > 0).sum()), int((~same32).sum())
    if ulps.numel() and (int(ulps.max()) > 1 or bool((ulps[same32] > 0).any())):
        raise AssertionError(f"{name}: kernel vs plain {n_ulp} elements off, "
                             f"max {int(ulps.max())} ulp, {n_f32} f32 results differ")
    o16 = fat0.clone()
    run_k(o16, seed ^ 0x2545F49)
    torch.cuda.synchronize()
    if torch.equal(o16.view(-1, w)[m].view(torch.int16), kt.view(torch.int16)):
        raise AssertionError(f"{name}: another seed gave the same bits")
    del o16
    err = float((kt.float() - pt.float()).abs().max()) if kt.numel() else 0.0
    say(f"  {name}: {kt.numel()} touched elements, {n_ulp} one bf16 ulp from "
        f"the plain version ({n_f32} where the f32 kernel and plain version "
        f"differ), max_abs_err {err:.3e}, bitwise-unchanged elements "
        f"{int((~m).sum())}, another seed changes the bits")
    return k16, err, n_ulp


def phase_bf16_oracle(torch, rng) -> dict:
    """Both bf16 kernels against their plain versions (``bf16_case``): the 4
    kinds of ``fat_line_update`` at d = 64 on a 500,000-row table with
    ~8,192 lines (64 grid blocks) and packed at d = 16 with padding ids,
    plus sentinel / out-of-range lines and untouched shared slots; the
    routed kernel at d = 16 (R = 2-8), adagrad and rowwise on the full bf16
    Criteo stack, adam at d = 64 and the hand-made edge lines, each also bitwise
    ``fat_line_update`` given the routed grid's lines per block."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    gen = torch.Generator(device="cuda").manual_seed(30)
    t = torch.tensor(3.0, device="cuda")
    corr = torch.stack([1.0 - 0.9**t, 1.0 - 0.999**t]).to(torch.float32)
    kw = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    res = {"fat": [0.0, 0], "routed": [0.0, 0]}

    def fat_case(name, lay, rows, ul, g, tl):
        fat0 = random_fat(torch, lay, rows, gen).to(torch.bfloat16)
        m = touched_mask(torch, fat0, ul, tl, lay)
        run_k = lambda f, s: kl.fat_line_update(f, ul, g, tl, corr, layout=lay,  # noqa: E731
                                                sr_seed=s, **kw)
        run_p = lambda f, s: kl.fat_line_update_plain(f, ul, g, tl, corr,  # noqa: E731
                                                      layout=lay, sr_seed=s, **kw)
        _, err, n = bf16_case(torch, name, lay, fat0, m, run_k, run_p)
        res["fat"] = [max(res["fat"][0], err), res["fat"][1] + n]

    for kind in KINDS:
        lay = line_layout(64, kind, "bfloat16")
        ids = torch.from_numpy(rng.integers(0, 500_000, 8192)).cuda()
        ul, seg, _ = sp.dedupe_ids(ids, vocab=500_000, rows_per_line=lay.r)
        c = ul.shape[0]
        g = sp._segment_sum(torch.randn((8192, 64), generator=gen, device="cuda"),
                            seg, c * lay.r)
        if lay.r == 1:
            g, tl = g.view(c, 64), None
        else:
            g = g.view(c, lay.r, 64)
            tl = (sp._segment_sum(torch.ones(8192, device="cuda"), seg, c * lay.r)
                  > 0).to(torch.float32).view(c, lay.r)
        fat_case(f"bf16 {kind} d=64 R={lay.r} ({c} line slots)", lay, 500_000,
                 ul, g, tl)
        lay = line_layout(16, kind, "bfloat16")
        idn = rng.integers(0, 200_000, 8192)
        idn[rng.random(8192) < 0.02] = -1
        ids = torch.from_numpy(idn).cuda()
        ul, seg, _ = sp.dedupe_ids(ids, vocab=200_000, rows_per_line=lay.r)
        c = ul.shape[0]
        g = sp._segment_sum(torch.randn((8192, 16), generator=gen, device="cuda"),
                            seg, c * lay.r).view(c, lay.r, 16).contiguous()
        tl = (sp._segment_sum((ids >= 0).to(torch.float32), seg, c * lay.r)
              > 0).to(torch.float32).view(c, lay.r)
        fat_case(f"bf16 {kind} d=16 R={lay.r}", lay, 200_000, ul, g, tl)
        ul = torch.tensor([3, 7, OOB, 10, -5, 64, 11, OOB], dtype=torch.int32,
                          device="cuda")
        g = torch.randn((8, lay.r, 16), generator=gen, device="cuda")
        tl = (torch.rand((8, lay.r), generator=gen, device="cuda") > 0.5
              ).to(torch.float32)
        tl[0] = 1.0
        fat_case(f"bf16 {kind} d=16 edge lines", lay, 64 * lay.r, ul, g, tl)

    def routed_bf16(name, lay, fat32, ul, rl, rs, g_u):
        fat0 = fat32.to(torch.bfloat16)
        del fat32
        # the forward's gather: sentinel and out-of-range lines read line 0
        pick = torch.where((ul >= 0) & (ul < fat0.shape[0]), ul, 0).long()
        lines = {torch.bfloat16: fat0[pick].contiguous()}
        lines[torch.float32] = lines[torch.bfloat16].float()
        g_slots, touched = kr.routed_to_slots(ul, rl, rs, g_u, lay)
        m = touched_mask(torch, fat0, ul, touched, lay)
        run_k = lambda f, s: kr.fat_line_update_routed(  # noqa: E731
            f, lines[f.dtype], ul, rl, rs, g_u, corr, layout=lay, sr_seed=s, **kw)
        run_p = lambda f, s: kr.fat_line_update_routed_plain(  # noqa: E731
            f, lines[f.dtype], ul, rl, rs, g_u, corr, layout=lay, sr_seed=s, **kw)
        k16, err, n = bf16_case(torch, name, lay, fat0, m, run_k, run_p)
        c = fat0.clone()
        kl.fat_line_update(c, ul, g_slots, touched, corr, layout=lay,
                           sr_seed=SR_SEED,
                           lines_per_step=kr.routed_lines_per_step(lay), **kw)
        torch.cuda.synchronize()
        if not torch.equal(k16.view(torch.int16), c.view(torch.int16)):
            raise AssertionError(f"{name}: routed kernel differs from "
                                 "fat_line_update at the routed grid's lps")
        res["routed"] = [max(res["routed"][0], err), res["routed"][1] + n]
        del k16, c, lines, fat0
        torch.cuda.empty_cache()

    cases = [(kind, 16, criteo_fat_rows() if kind in ("rowwise_adagrad",
                                                      DLRM_BF16_KIND)
              else 2_000_000) for kind in KINDS]
    cases += [("adam", 64, 2_000_000)]
    for kind, d, rows in cases:
        lay = line_layout(d, kind, "bfloat16")
        idn = rng.integers(0, rows, BATCH * 4)
        idn[rng.random(idn.shape[0]) < 0.01] = -1
        idn[1::97] = idn[::97][: idn[1::97].shape[0]] ^ 1
        fat32, _, ul, rl, rs, g_u = routed_operands(
            torch, line_layout(d, kind), rows, torch.from_numpy(idn).cuda(), gen)
        routed_bf16(f"bf16 routed {kind} d={d} R={lay.r} rows={rows}", lay,
                    fat32, ul, rl, rs, g_u)
    lay = line_layout(16, "rowwise_adagrad", "bfloat16")
    fat32 = random_fat(torch, lay, 64 * lay.r, gen)
    ul = torch.tensor([3, 7, 40, 70, OOB, OOB], dtype=torch.int32, device="cuda")
    rl = torch.tensor([0, 0, 0, 1, 2, 3, 4, 6, 6], dtype=torch.int32, device="cuda")
    rs = torch.tensor([0, 1, 3, 2, 1, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    g_u = torch.randn((9, 16), generator=gen, device="cuda")
    routed_bf16("bf16 routed rowwise_adagrad d=16 edge lines", lay, fat32, ul,
                rl, rs, g_u)
    say(f"bf16_oracle: passed; fat_line_update[bf16] max_abs_err "
        f"{res['fat'][0]:.3e}, {res['fat'][1]} one-ulp elements; "
        f"fat_line_update_routed[bf16] max_abs_err {res['routed'][0]:.3e}, "
        f"{res['routed'][1]} one-ulp elements")
    return res


def sr_ops(elements: int) -> int:
    """Integer operations of the stochastic-rounding writeback: the hash
    (2 multiply-adds, 3 shift-xors, 2 multiplies) and the rounding (mask,
    add, mask, shift), 13 per written element."""
    return 13 * elements


def phase_bf16_timing(torch, rng) -> dict:
    """Both bf16 kernels at their paths' shapes: ``fat_line_update`` on the
    TwoTower bf16 stack (700,000 rows, adam d = 64, R = 1) with one batch's
    deduplicated lines, the routed kernel on the bf16 Criteo stack with one
    DLRM step's routing; each held against its plain version on the same
    operands first, then timed like ``timing`` (L2 flushed, events, profiler
    device duration, empty-kernel floor) beside the byte bound."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.fat_lines import line_layout
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    gen = torch.Generator(device="cuda").manual_seed(31)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {}
    # fat_line_update[bf16]: TwoTower
    lay = line_layout(DIM, "adam", "bfloat16")
    rows = SIZE_MAP["user"] + SIZE_MAP["item"]
    fat = random_fat(torch, lay, rows, gen).to(torch.bfloat16)
    ids = np.concatenate([rng.integers(0, SIZE_MAP["user"], BATCH),
                          SIZE_MAP["user"] + rng.integers(0, SIZE_MAP["item"], BATCH)])
    ul, _, valid = sp.dedupe_ids(torch.from_numpy(ids).cuda(), vocab=rows)
    g = torch.randn((ul.shape[0], DIM), generator=gen, device="cuda") * 1e-3
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=LR, weight_decay=WD)
    m = touched_mask(torch, fat, ul, None, lay)
    run_k = lambda f, s: kl.fat_line_update(f, ul, g, None, corr, sr_seed=s, **kw)  # noqa: E731
    run_p = lambda f, s: kl.fat_line_update_plain(f, ul, g, None, corr, sr_seed=s, **kw)  # noqa: E731
    _, err, _ = bf16_case(torch, "bf16 adam d=64 main-path shape", lay, fat, m,
                          run_k, run_p)
    floor = launch_floor(torch, flush)
    ks, ps, ds, rec = time_in_turns(torch, lambda: run_k(fat, SR_SEED),
                                    lambda: run_p(fat, SR_SEED), 50, 20, flush,
                                    "fat_line_update_kernel")
    u_real = int(valid.sum())
    per_row = 2 * lay.need * 2 + DIM * 4
    nbytes = u_real * per_row + ul.shape[0] * 4 + 8
    ops = u_real * (DIM * ADAM_FLOP_PER_ELEMENT) + sr_ops(u_real * lay.need)
    out["fat_line_update[bf16]"] = _bound_record(
        "bf16_timing: fat_line_update[bf16] at the TwoTower shape (adam "
        f"d={DIM}, {rows} rows, {u_real} touched lines of {ul.shape[0]} slots)",
        ks, ps, ds, rec, nbytes, ops, per_row, err)
    del fat, m
    torch.cuda.empty_cache()
    # fat_line_update_routed[bf16]: DLRM-Criteo
    lay32 = line_layout(CRITEO_DIM, DLRM_BF16_KIND)
    lay = line_layout(CRITEO_DIM, DLRM_BF16_KIND, "bfloat16")
    rows = criteo_fat_rows()
    big = [v for v in CRITEO_VOCABS if v > CRITEO_FUSED_MIN]
    offs = np.cumsum([0] + big[:-1])
    ids = np.concatenate([o + rng.integers(0, v, BATCH) for o, v in zip(offs, big)])
    fat32, _, ul, rl, rs, g_u = routed_operands(
        torch, lay32, rows, torch.from_numpy(ids).cuda(), gen, pad_rows=0)
    fat = fat32.to(torch.bfloat16)
    del fat32
    g_u *= 1e-3
    corr = torch.zeros(2, device="cuda")
    kw = dict(layout=lay, lr=3e-4, eps=1e-8)
    lines = {torch.bfloat16: fat[torch.where(ul < OOB, ul, 0).long()].contiguous()}
    lines[torch.float32] = lines[torch.bfloat16].float()
    _, touched = kr.routed_to_slots(ul, rl, rs, g_u, lay)
    m = touched_mask(torch, fat, ul, touched, lay)
    run_k = lambda f, s: kr.fat_line_update_routed(  # noqa: E731
        f, lines[f.dtype], ul, rl, rs, g_u, corr, sr_seed=s, **kw)
    run_p = lambda f, s: kr.fat_line_update_routed_plain(  # noqa: E731
        f, lines[f.dtype], ul, rl, rs, g_u, corr, sr_seed=s, **kw)
    _, err, _ = bf16_case(torch, f"bf16 {DLRM_BF16_KIND} main-path shape", lay,
                          fat, m, run_k, run_p)
    del m
    lines.pop(torch.float32)
    ks, ps, ds, rec = time_in_turns(torch, lambda: run_k(fat, SR_SEED),
                                    lambda: run_p(fat, SR_SEED), 50, 20, flush,
                                    "fat_line_update_routed")
    c, cr = ul.shape[0], rl.shape[0]
    lidx = rl.to(torch.int64)
    line_of = torch.where(lidx < c, ul.to(torch.int64)[lidx.clamp(max=c - 1)], OOB)
    n_rows = int(((lidx < c) & (line_of < fat.shape[0])).sum())
    per_row = 2 * lay.need * 2 + lay.d * 4 + 12
    nbytes = n_rows * per_row + (cr - n_rows) * 4 + 8
    ops = n_rows * lay.d * ADAGRAD_FLOP_PER_ELEMENT + sr_ops(n_rows * lay.need)
    out["fat_line_update_routed[bf16]"] = _bound_record(
        "bf16_timing: fat_line_update_routed[bf16] at the DLRM shape "
        f"({DLRM_BF16_KIND} d={CRITEO_DIM} R={lay.r}, {rows} rows in "
        f"{fat.shape[0]} lines, {n_rows} updated rows of {cr} row slots)",
        ks, ps, ds, rec, nbytes, ops, per_row, err)
    del fat, lines, flush
    torch.cuda.empty_cache()
    out["floor"] = floor
    return out


def _bound_record(label, ks, ps, ds, rec, nbytes, ops, per_row, err) -> dict:
    """Print one timing line and return its kernels-JSON numbers: the bound
    is the larger of the bytes over the HBM rate and the operations (f32
    flops and the rounding's integer operations) over the f32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    say(f"{label}: kernel {ks} ms (profiler device {ds} ms, medians of "
        f"{rec}/50 records), plain {ps} ms; bound {bound:.6f} ms by {by} "
        f"({per_row} B per row, {nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s = "
        f"{bytes_ms:.6f} ms; {ops} operations at {F32_FLOP_PER_S / 1e12} "
        f"TOP/s = {ops_ms:.6f} ms)")
    return {"ms": sum(ks) / len(ks), "plain_ms": sum(ps) / len(ps),
            "device_ms": dev_mean(ds), "device_records": rec,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err}


def _bf16_specs(specs):
    import dataclasses

    import torch

    return [dataclasses.replace(s, dtype=torch.bfloat16) for s in specs]


def _check_bf16_rows(torch, name, g, c, base, step_bound, steps):
    """Card rows ``g`` vs CPU rows ``c`` after ``steps`` steps, and the
    initial rows ``base`` as the control (bf16 table lanes, [n, d]; the
    note at BF16_FAR_SHARE); returns a summary."""
    gf, cf = g.float(), c.float()
    ulp = torch.where(cf == 0, torch.full_like(cf, 2.0**-133),
                      torch.ldexp(torch.ones_like(cf),
                                  torch.frexp(cf.abs()).exponent - 8))
    diff = (gf - cf).abs()
    ceiling = ulp + 2 * step_bound * steps
    over = int((diff > ceiling).sum())
    ulps = bf16_ulps(torch, g, c)
    share = float((ulps > 1).double().mean())
    share0 = float((bf16_ulps(torch, base, c) > 1).double().mean())
    summary = (f"{name}: {g.shape[0]} touched rows, {g.numel()} elements: "
               f"{int((ulps == 0).sum())} bitwise equal, {int((ulps == 1).sum())} "
               f"one ulp apart, {int((ulps > 1).sum())} further ({share:.4%}, "
               f"at most {BF16_FAR_SHARE:.0%}; max |diff| {float(diff.max()):.3e}, "
               f"ceiling one ulp + {2 * step_bound * steps:.2e}); control, the "
               f"initial rows: {share0:.4%} further than one ulp")
    if over or share > BF16_FAR_SHARE:
        raise AssertionError(f"card vs CPU: {over} elements beyond the ceiling; "
                             + summary)
    if share0 <= BF16_FAR_SHARE:
        raise AssertionError(f"card vs CPU: the control passes, so the check "
                             f"cannot fail; {summary}")
    return summary


def twotower_bf16_initial(torch):
    """Path 1's collection (every spec bf16), initial tables (on the CPU)
    and bf16-compute backbone, from fixed seeds."""
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    coll = ShardedEmbeddingCollection(_bf16_specs(ctr_embedding_specs(SIZE_MAP, DIM, "row")))
    tables0 = coll.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1),
                                 dtype=torch.bfloat16)
    return coll, tables0, backbone0


def twotower_bf16_state(torch, coll, tables0, backbone0, device):
    """``(state, step)`` of path 1 on ``device`` from copies of the initial
    state: sparse adam with the bench's f32 slots, dense AdamW."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState, make_sparse_train_step

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    return state, make_sparse_train_step(coll, ctr_sparse_forward(backbone))


def phase_main_bf16(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    """Path 1: ``bench.py::build_sparse_train_bench(8192, 64,
    table_dtype="bfloat16")`` (``bench.py:511-551``): every table bf16 (the
    user+item fat stack with its adam state in the line; the five small
    tables bf16 with f32 mu/nu, the bench's slot dtype), stochastically
    rounded writes, the backbone computing in bf16 as the bench does on a
    chip (``bench.py:534-535``)."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    coll, tables0, backbone0 = twotower_bf16_initial(torch)
    fat_arrays = sorted(k for k, v in tables0.items() if v.dim() == 3)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in tables0.items()}
    say(f"main_bf16: arrays {shapes}; fat {fat_arrays}")

    def build(device):
        return twotower_bf16_state(torch, coll, tables0, backbone0, device)

    rng = np.random.default_rng(17)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    state, step = build("cuda")
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kl.fat_line_update.launches = 0
    losses, times = [], []
    for b in dev_batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = kl.fat_line_update.launches
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    if launches != len(fat_arrays) * steps or len(fat_arrays) != 1:
        raise AssertionError(f"fat_line_update launched {launches} times in "
                             f"{steps} steps, expected one per step")
    if any(t.dtype != torch.bfloat16 for t in state.tables.values()):
        raise AssertionError("a table left bf16 storage")
    steady = times[check_steps:]
    step_ms = float(np.median(steady))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"main_bf16: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, fat_line_update launches {launches} (1 per step), "
        f"the fat array still {state.tables[fat_arrays[0]].dtype}, step_ms "
        f"median {step_ms:.4f} mean {float(np.mean(steady)):.4f} min "
        f"{min(steady):.4f} max {max(steady):.4f} (host clock, each step "
        f"synchronised, steps {check_steps + 1}-{steps}), peak device memory "
        f"{peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    runs = {}
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64))
    for device in ("cuda", "cpu"):
        st, stp = build(device)
        if device == "cpu":
            base = user_rows(coll, st, touched)
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, user_rows(coll, st, touched.to(device)))
        del st
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=BF16_LOSS_RTOL)
    summary = _check_bf16_rows(torch, "user rows", rg.to(torch.bfloat16),
                               rc.to(torch.bfloat16), base.to(torch.bfloat16),
                               LR, check_steps)
    say(f"main_bf16: card vs CPU over {check_steps} steps (bf16 compute): "
        f"losses {lg} vs {lc} (rtol {BF16_LOSS_RTOL}); {summary}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "losses": losses}


def dlrm_bf16_initial(torch):
    """Path 2's collection (every spec bf16), initial tables (on the card)
    and bf16-compute backbone, from fixed seeds."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    coll = ShardedEmbeddingCollection(
        _bf16_specs(generic_embedding_specs(size_map, CRITEO_CATS, CRITEO_DIM, "row",
                                            fused_threshold=CRITEO_FUSED_MIN)),
        stack_tables=True, fused_kind=DLRM_BF16_KIND)
    tables0 = coll.init(0, device="cuda")
    backbone0 = DLRMBackbone(CRITEO_DIM, cat_columns=CRITEO_CATS,
                             cont_columns=CRITEO_CONTS,
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.bfloat16)
    return coll, tables0, backbone0


def phase_dlrm_bf16_main(torch, card: str, steps: int = 20,
                         check_steps: int = 3) -> dict:
    """Path 2: phase 11's DLRM-Criteo flow with ``table_dtype =
    "bfloat16"`` (``configs/dlrm-criteo.toml:66-67``) and the sparse
    optimizer ``DLRM_BF16_KIND`` (its note): the 8 big tables in one bf16
    adagrad fat stack ``[8,428,795, 1, 128]`` (2.16 GB, the accumulator
    lanes bf16 too), the 18 others in one bf16 plain stack (f32
    accumulators), ``dedup_lookup``, the backbone computing in bf16 as the
    bench (``bench.py:306``)."""
    coll, tables0, backbone0 = dlrm_bf16_initial(torch)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in tables0.items()}
    say(f"dlrm_bf16_main: arrays {shapes}, B {BATCH}, d {CRITEO_DIM}, "
        f"{DLRM_BF16_KIND} lr {LR}, dense AdamW lr {LR} wd {WD}, dedup_lookup, "
        "bf16 compute")
    rng = np.random.default_rng(19)
    host = [criteo_host_batch(rng) for _ in range(steps)]
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda",
                             DLRM_BF16_KIND)
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_dlrm_counts()
    losses, times = [], []
    for b in dev_batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = dlrm_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {"fat_line_update": 0, "fat_line_update_routed": steps}
    if counts != want:
        raise AssertionError(f"launches in {steps} steps {counts}, expected {want}")
    if any(t.dtype != torch.bfloat16 for t in state.tables.values()):
        raise AssertionError("a table left bf16 storage")
    steady = times[check_steps:]
    step_ms = float(np.median(steady))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"dlrm_bf16_main: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, launches {counts} (1 routed per step), step_ms "
        f"median {step_ms:.4f} mean {float(np.mean(steady)):.4f} min "
        f"{min(steady):.4f} max {max(steady):.4f} (host clock, each step "
        f"synchronised, steps {check_steps + 1}-{steps}; "
        f"{BATCH / step_ms * 1e3:.0f} examples/s), peak device memory "
        f"{peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    runs = {}
    for device in ("cuda", "cpu"):
        src = tables0 if device == "cuda" else {k: v.cpu() for k, v in tables0.items()}
        st, stp = dlrm_state(torch, coll, src, backbone0, device, DLRM_BF16_KIND)
        del src
        if device == "cpu":
            base = dlrm_touched_rows(torch, coll, st, host[:check_steps])
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, dlrm_touched_rows(torch, coll, st, host[:check_steps]))
        del st
        torch.cuda.empty_cache()
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=BF16_LOSS_RTOL)
    parts = [_check_bf16_rows(torch, aname,
                              rg[aname][:, :CRITEO_DIM].to(torch.bfloat16),
                              rc[aname][:, :CRITEO_DIM].to(torch.bfloat16),
                              base[aname][:, :CRITEO_DIM].to(torch.bfloat16),
                              LR, check_steps) for aname in rg]
    say(f"dlrm_bf16_main: card vs CPU over {check_steps} steps (bf16 compute): "
        f"losses {lg} vs {lc} (rtol {BF16_LOSS_RTOL}); " + "; ".join(parts))
    return {"launches": counts, "step_ms": step_ms, "peak_gb": peak_gb,
            "losses": losses}


def phase_profile_bf16(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_bf16``): path 1's (TwoTower, bf16
    storage and compute) steps."""
    coll, tables0, backbone0 = twotower_bf16_initial(torch)
    state, step = twotower_bf16_state(torch, coll, tables0, backbone0, "cuda")
    del tables0
    rng = np.random.default_rng(11)
    batches = [to_device(torch, make_host_batch(rng, BATCH), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "twotower bf16", state, step, batches, warm)


def phase_profile_dlrm_bf16(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_dlrm_bf16``): path 2's steps."""
    coll, tables0, backbone0 = dlrm_bf16_initial(torch)
    state, step = dlrm_state(torch, coll, tables0, backbone0, "cuda",
                             DLRM_BF16_KIND)
    del tables0
    rng = np.random.default_rng(13)
    batches = [to_device(torch, criteo_host_batch(rng), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "dlrm-criteo bf16", state, step, batches, warm)


# ---------------------------------------------------------- phases 17-20

# steps_per_execution of the dense phase's CUDA-graph run
DENSE_SPE = 4
# quickstart_cli: synthetic users (about 99 train batches of 2048 in the
# one epoch, so the epoch outlasts the first mid-epoch save) and the save
# cadence (PR 14 cut the users from 20,000 to make room for dist_main's
# and dist_cli's CTR arms within the run's time)
QS_USERS, QS_CKPT_EVERY = 4_000, 20
DIST_CLI_USERS, DIST_CLI_EVERY = 2_000, 10


def state_tensors(tree, prefix=""):
    """``{"a/b/0": tensor}`` of a state's tensor-dict form."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in state_tensors(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return state_tensors(dict(enumerate(tree)), prefix)
    return {prefix.rstrip("/"): tree}


def state_diff(torch, a, b) -> float:
    """Largest |a - b| over two states' tensor-dict forms (0.0 when bitwise
    equal, inf when a key, dtype or ``step`` differs)."""
    fa, fb = state_tensors(a), state_tensors(b)
    if fa.keys() != fb.keys():
        return float("inf")
    worst = 0.0
    for k, x in fa.items():
        y = fb[k]
        if not isinstance(x, torch.Tensor):
            if x != y:
                return float("inf")
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return float("inf")
        if torch.equal(x, y.to(x.device)):
            continue
        d = (x.double() - y.to(x.device).double()).abs()
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return worst


def cpu_copy(torch, tree):
    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_tensors(tree).items()}


# uninterrupted runs a resumed (or graph-replayed) run is held against
N_REFS = 3


def spread_check(torch, name, refs, run, what) -> str:
    """``run`` = ``(losses, state_dict)`` against ``refs``, the same steps
    run uninterrupted ``N_REFS`` times.  Every float sum the port computes
    by index is the deterministic segment sum (``ops/kernels/segment_sum.py``),
    so the refs must repeat bitwise (spread S, the largest difference
    between two refs over every loss and state element, is 0) and ``run``
    must equal them bitwise.  Returns the printed line; raises otherwise."""
    flat = [dict(state_tensors(sd), losses=ls) for ls, sd in refs]
    mine = dict(state_tensors(run[1]), losses=run[0])
    if any(f.keys() != mine.keys() for f in flat):
        raise AssertionError(f"{name}: the runs' states have other keys")
    spread, near, differ_at = 0.0, 0.0, {}
    for k, x in mine.items():
        if not isinstance(x, torch.Tensor):
            if any(f[k] != x for f in flat):
                raise AssertionError(f"{name}: {k} differs: {x} vs {[f[k] for f in flat]}")
            continue
        st = torch.stack([f[k].to(x.device).double() for f in flat])
        spread = max(spread, float((st.max(0).values - st.min(0).values).max()))
        d = (x.double() - st[0]).abs()
        near = max(near, float(d.max()))
        if bool((d != 0).any()):
            differ_at[k] = (str(x.dtype), int((d != 0).sum()))
    line = (f"{name}: {what}: {len(flat)} uninterrupted runs, spread {spread:.3e}; "
            f"max |R - ref 0| {near:.3e}; elements of R not bitwise ref 0: "
            f"{differ_at}; rule: the refs repeat bitwise and R equals them")
    if spread > 0.0 or differ_at:
        raise AssertionError(line)
    return line


def dense_initial(torch):
    """One dense ``TwoTower`` at bench.py::build_train_bench's width
    (SIZE_MAP, d = 64, f32), on the CPU from a fixed seed."""
    from tdfo_tpu_torch.models.twotower import init_twotower

    return init_twotower(0, SIZE_MAP, DIM, device="cpu")


def dense_state(torch, model0, device):
    """A fresh ``TrainState`` on ``device`` from a copy of ``model0``
    (AdamW lr 3e-4 wd 1e-4; capturable on the card)."""
    import copy

    from tdfo_tpu_torch.train.state import TrainState

    return TrainState.create(model=copy.deepcopy(model0).to(device),
                             learning_rate=LR, weight_decay=WD,
                             capturable=device == "cuda")


def dense_user_rows(state, ids):
    return state.model.user_embed.weight.detach()[ids].cpu()


def phase_dense_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    """Phase 17: the dense TwoTower (``model_parallel = false``) at
    ``bench.py::build_train_bench``'s width, eager and as CUDA-graph
    replays; card vs CPU; a checkpoint round trip of the capturable state."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager
    from tdfo_tpu_torch.train.step import (
        CudaGraphStep,
        make_multi_step,
        make_train_step,
    )

    model0 = dense_initial(torch)
    n_params = sum(p.numel() for p in model0.parameters())
    say(f"dense_main: TwoTower {SIZE_MAP}, d {DIM}, {n_params} parameters "
        f"(every one under AdamW), B {BATCH}, f32")
    rng = np.random.default_rng(21)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    dev = [to_device(torch, h, "cuda") for h in host]
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64))

    def eager():
        state = dense_state(torch, model0, "cuda")
        step = make_train_step()
        torch.cuda.synchronize()
        losses, rows, t_start = [], None, None
        for i, b in enumerate(dev):
            if i == check_steps:
                torch.cuda.synchronize()
                rows = dense_user_rows(state, touched.cuda())
                t_start = time.perf_counter()
            state, loss = step(state, b)
            losses.append(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3 / (steps - check_steps)
        return state, torch.stack(losses).cpu(), rows, ms

    refs, times, rows_gpu = [], [], None
    for i in range(N_REFS):
        st, ls, rows, ms = eager()
        if i == 0:
            rows_gpu, la = rows, ls
        refs.append((ls, st.state_dict()))
        times.append(ms)
        del st
    if not torch.isfinite(la).all():
        raise AssertionError(f"non-finite losses: {la.tolist()}")
    eager_ms = times[0]
    say(f"dense_main: {steps} eager steps on the card, {N_REFS} runs, losses "
        f"{float(la[0]):.6f} -> {float(la[-1]):.6f}, step_ms "
        f"{', '.join(f'{t:.4f}' for t in times)} (host clock over steps "
        f"{check_steps + 1}-{steps}), on {card}")

    # steps_per_execution = DENSE_SPE: each step of a chunk is one replay
    sg = dense_state(torch, model0, "cuda")
    graphed = CudaGraphStep(make_train_step())
    multi = make_multi_step(graphed)
    chunks = [{k: torch.stack([b[k] for b in dev[i:i + DENSE_SPE]]) for k in dev[0]}
              for i in range(0, steps, DENSE_SPE)]
    torch.cuda.synchronize()
    lg, t_start = [], None
    for j, c in enumerate(chunks):
        if j == 1:  # the first chunk holds the warm-up and the capture
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        sg, losses = multi(sg, c)
        lg.append(losses)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t_start) * 1e3 / (steps - DENSE_SPE)
    lg = torch.cat(lg).cpu()
    if sg.step != steps:
        raise AssertionError(f"graph run counted {sg.step} steps, ran {steps}")
    say(spread_check(torch, "dense_main", refs, (lg, sg.state_dict()),
                     f"CUDA-graph run (steps_per_execution {DENSE_SPE}) vs "
                     "eager, losses and final state"))
    del refs
    say(f"dense_main: eager step_ms {eager_ms:.4f} vs CUDA-graph replay "
        f"step_ms {graph_ms:.4f} (host clock over steps {DENSE_SPE + 1}-"
        f"{steps}) on {card}")

    # the capturable state through a checkpoint, into both forms
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(steps, sg)
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in Path(tmp).rglob("*") if p.is_file())
        for device in ("cuda", "cpu"):
            fresh = dense_state(torch, model0, device)
            t0 = time.perf_counter()
            mgr.restore(fresh)
            if device == "cuda":
                torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            d = state_diff(torch, fresh.state_dict(), sg.state_dict())
            if d != 0.0:
                raise AssertionError(f"dense checkpoint restored into {device} "
                                     f"differs from the saved state by {d}")
            say(f"dense_main: checkpoint of the capturable state: {nbytes} bytes, "
                f"save {save_s:.3f} s, restore into a {device} state "
                f"{restore_s:.3f} s, bitwise equal (AdamW step counter on "
                f"{fresh.optimizer.state[next(fresh.model.parameters())]['step'].device})")
            del fresh
    del sg, graphed, multi, chunks
    torch.cuda.empty_cache()

    # the first steps on the port's CPU path from the same initial model
    cs, step = dense_state(torch, model0, "cpu"), make_train_step()
    closs = []
    for h in host[:check_steps]:
        cs, loss = step(cs, to_device(torch, h, "cpu"))
        closs.append(float(loss))
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(la[:check_steps].numpy(), closs, rtol=rtol, atol=atol)
    rows_cpu = dense_user_rows(cs, touched)
    torch.testing.assert_close(rows_gpu, rows_cpu, rtol=rtol, atol=atol)
    say(f"dense_main: card vs CPU over {check_steps} steps: losses "
        f"{la[:check_steps].tolist()} vs {closs}; {touched.numel()} touched user "
        f"rows, max_abs_err {float((rows_gpu - rows_cpu).abs().max()):.3e} "
        f"(rtol {rtol})")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms}


def phase_profile_dense(torch, warm: int = 3, steps: int = 5) -> None:
    """Optional (``--phases profile_dense``): the dense TwoTower's eager
    steps, then its CUDA-graph replays."""
    from tdfo_tpu_torch.train.step import CudaGraphStep, make_train_step

    model0 = dense_initial(torch)
    rng = np.random.default_rng(14)
    batches = [to_device(torch, make_host_batch(rng, BATCH), "cuda")
               for _ in range(warm + steps)]
    profile_steps(torch, "dense twotower eager", dense_state(torch, model0, "cuda"),
                  make_train_step(), batches, warm)
    profile_steps(torch, "dense twotower CUDA-graph replays",
                  dense_state(torch, model0, "cuda"),
                  CudaGraphStep(make_train_step()), batches, warm)


def resume_setups(torch):
    """``(name, make_state, batches, step_args, expected launches per
    step)`` of the resume phase: phases 3, 15 and 7's setups at their
    widths, each state built fresh from one initial state."""
    from tdfo_tpu_torch.train.seq import dropout_generator

    coll, tables0, backbone0 = b4r_initial()
    two = ShardedTwoTower(torch)
    bf = twotower_bf16_initial(torch)
    return [
        ("main", lambda: two.state(), lambda rng: make_host_batch(rng, BATCH),
         lambda st: (), {"fat_line_update": 1}),
        ("main_bf16", lambda: twotower_bf16_state(torch, *bf, "cuda"),
         lambda rng: make_host_batch(rng, BATCH), lambda st: (),
         {"fat_line_update": 1}),
        ("b4r_main", lambda: b4r_state(torch, coll, tables0, backbone0, "cuda"),
         b4r_batch,
         lambda st: (dropout_generator(B4R_SEED + 1, st.step, "cuda"),),
         {"fat_line_update": 1,
          **dict.fromkeys(FLASH_KERNELS, B4R["n_layers"])}),
    ]


class ShardedTwoTower:
    """Phase 3's initial state, kept on the CPU, for fresh card states."""

    def __init__(self, torch):
        from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
        from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

        self.torch = torch
        self.coll = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
        self.tables0 = self.coll.init(0, device="cpu")
        self.backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))

    def state(self):
        _, state, step = build_main_path(self.torch, "cuda", self.tables0,
                                         self.backbone0)
        return state, step


def phase_resume(torch, card: str, steps: int = 20, cut: int = 10) -> dict:
    """Phase 18: for each setup, ``steps`` uninterrupted steps ``N_REFS``
    times, then a run R that trains ``cut`` steps, saves, restores into a
    fresh state (bitwise the saved one) and trains the rest; R against the
    uninterrupted runs by :func:`spread_check`; every run launches each
    kernel of its path the expected times per step."""
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    counts_of = {"fat_line_update": lambda c: c["fat_line_update"],
                 **{k: (lambda c, k=k: c[k]) for k in FLASH_KERNELS}}
    out = {}
    for name, make, batch_fn, args_fn, per_step in resume_setups(torch):
        rng = np.random.default_rng(31)
        dev = [to_device(torch, batch_fn(rng), "cuda") for _ in range(steps)]

        def run(state, step, batches):
            losses = []
            for b in batches:
                state, loss = step(state, b, *args_fn(state))
                losses.append(loss)
            return state, losses

        def check_counts(what, n):
            counts = flash_counts()
            want = {k: v * n for k, v in per_step.items()}
            got = {k: counts_of[k](counts) for k in want}
            if got != want:
                raise AssertionError(f"resume {name} {what}: launches {got}, "
                                     f"expected {want}")
            return got

        refs = []
        for _ in range(N_REFS):
            state, step = make()
            zero_counts()
            state, losses = run(state, step, dev)
            torch.cuda.synchronize()
            check_counts("uninterrupted run", steps)
            refs.append((torch.stack(losses).cpu(), state.state_dict()))
            del state, step
        # R: cut, save, restore into a fresh state, the rest
        with tempfile.TemporaryDirectory() as tmp:
            state, step = make()
            zero_counts()
            state, l1 = run(state, step, dev[:cut])
            torch.cuda.synchronize()
            mgr = CheckpointManager(tmp)
            t0 = time.perf_counter()
            mgr.save(cut, state, cursor={"epoch": 0, "step": cut,
                                         "epoch_complete": False,
                                         "global_step": cut})
            save_s = time.perf_counter() - t0
            nbytes = sum(p.stat().st_size for p in Path(tmp).rglob("*")
                         if p.is_file())
            saved = cpu_copy(torch, state.state_dict())
            del state, step
            torch.cuda.empty_cache()
            fresh, step = make()
            t0 = time.perf_counter()
            got_step, fresh, cursor = mgr.restore(fresh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            d_restore = state_diff(torch, cpu_copy(torch, fresh.state_dict()), saved)
            if d_restore != 0.0 or got_step != cut or cursor["step"] != cut:
                raise AssertionError(f"resume {name}: the restored state differs "
                                     f"from the saved one by {d_restore}")
            fresh, l2 = run(fresh, step, dev[cut:])
            torch.cuda.synchronize()
        counts = check_counts("cut-save-restore run", steps)
        say(f"resume {name}: {steps} steps cut at {cut}: checkpoint {nbytes} "
            f"bytes, save {save_s:.3f} s, restore {restore_s:.3f} s, the "
            f"restored state bitwise the saved one; launches {counts} over the "
            f"{steps} steps; on {card}")
        say(spread_check(torch, f"resume {name}", refs,
                         (torch.stack(l1 + l2).cpu(), fresh.state_dict()),
                         "resumed run vs uninterrupted, losses and final state"))
        out[name] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                     "launches": counts}
        del fresh, refs
        torch.cuda.empty_cache()
    return out


def phase_quickstart_cli(torch) -> dict:
    """Phase 19: ``launch synth -> preprocess-ctr -> train`` with a copy of
    ``config.toml`` (only ``data_dir``, ``n_epochs = 1``, ``checkpoint_dir``
    and ``checkpoint_every_n_steps`` changed; the dense regime it sets).
    The train process is killed with SIGKILL once a mid-epoch cursor
    exists, then run again: it must resume mid-epoch and log an eval AUC
    in [0, 1].  The data come from the port's ``data/synthetic.py`` with
    ``QS_USERS`` users (``launch synth``'s 120 users give one batch)."""
    import os
    import signal

    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    text = (ROOT / "config.toml").read_text()
    if 'data_dir = "data/goodreads"' not in text or "n_epochs = 2" not in text:
        raise AssertionError("config.toml no longer has the lines this phase edits")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck = tmp / "ckpt"
        cfg = tmp / "config.toml"
        cfg.write_text(
            text.replace('data_dir = "data/goodreads"', f'data_dir = "{tmp / "data"}"')
            .replace("n_epochs = 2", "n_epochs = 1")
            + f'checkpoint_dir = "{ck}"\ncheckpoint_every_n_steps = {QS_CKPT_EVERY}\n')
        t0 = time.perf_counter()
        write_synthetic_goodreads(tmp / "data", n_users=QS_USERS)
        if launch.main(["preprocess-ctr", "--config", str(cfg)]) != 0:
            raise AssertionError("launch preprocess-ctr failed")
        etl_s = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "tdfo_tpu_torch.launch", "train", "--config",
               str(cfg)]
        log1 = tmp / "train1.log"
        with open(log1, "w") as f:
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        mid = None
        deadline = time.monotonic() + 600
        try:
            while mid is None and proc.poll() is None and time.monotonic() < deadline:
                for p in sorted(ck.glob("cursor_*.json")) if ck.exists() else []:
                    # a cursor counts once its step is committed
                    if not (ck / p.stem.split("_", 1)[1] / "state.pt").is_file():
                        continue
                    try:
                        c = json.loads(p.read_text())
                    except (OSError, ValueError):
                        continue
                    if not c.get("epoch_complete"):
                        mid = c
                        break
                time.sleep(0.005)
            if proc.poll() is not None:
                raise AssertionError(
                    f"the train run ended (rc {proc.returncode}) before a "
                    f"mid-epoch checkpoint could be killed; log:\n{log1.read_text()[-3000:]}")
            if mid is None:
                raise AssertionError("no mid-epoch cursor within 600 s")
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        from tdfo_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(ck)
        latest = mgr.read_cursor(mgr.latest_step())
        if latest is None or latest.get("epoch_complete"):
            raise AssertionError(f"the killed run's newest checkpoint is not "
                                 f"mid-epoch: {latest}")
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"the resumed train run failed:\n{res.stdout[-3000:]}"
                                 f"\n{res.stderr[-3000:]}")
        recs = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    resumed = [r for r in recs if "resumed_mid_epoch" in r]
    aucs = [r["auc"] for r in recs if "auc" in r]
    steps = [r["steps"] for r in recs if "train_loss_epoch" in r]
    if not resumed or not aucs or not 0.0 <= aucs[-1] <= 1.0:
        raise AssertionError(f"metrics.jsonl lacks resumed_mid_epoch or an eval "
                             f"AUC: {recs}")
    say(f"quickstart_cli: config.toml (dense TwoTower) on the card: synthetic "
        f"{QS_USERS} users + preprocess-ctr {etl_s:.1f} s; SIGKILL after the "
        f"mid-epoch save at step {mid['step']}; the newest checkpoint at step "
        f"{latest['step']}; the restart resumed mid-epoch at step "
        f"{resumed[0]['step']} and finished the epoch ({steps[-1]} steps), "
        f"eval auc {aucs[-1]:.4f}")
    return {"resumed_at": resumed[0]["step"], "auc": aucs[-1]}


# ---------------------------------------------------------------- several ranks

DIST_STEPS, DIST_TIMED = 3, 3      # compared steps, then timed steps
# the per-table lookup modes, then the grouped exchange (eager and
# pipelined), then the int8 arm (every table plain int8: codes on the wire)
DIST_MODES = ("gspmd", "psum", "alltoall", "grouped", "pipelined",
              "int8_alltoall", "int8_grouped")
# all_to_all_single calls a step: ids + vectors out and back, ids + grads
# for the update; int8 adds the (scale, offset) rows on the return trip
DIST_A2A = {"grouped": 4, "pipelined": 4, "int8_grouped": 5,
            "alltoall": 14, "int8_alltoall": 14}
DIST_TIMEOUT_S = 300
DIST_CTR_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _spawn_ranks(world: int, spec: dict, tag: str,
                 timeout: float = DIST_TIMEOUT_S) -> list[dict]:
    """``world`` processes of ``chip_smoke.py --dist-rank`` on the card
    (torchrun's variables set by hand); each prints its lines and writes
    its results.  Every process is waited for (or killed at ``timeout``
    seconds)."""
    import os

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    spec = dict(spec, out=str(out))
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank", json.dumps(spec)],
        cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        for line in log.strip().splitlines():
            if line.startswith("dist") or "Error" in line or "error" in line:
                say(f"  [{tag} rank {r}] {line}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{tag}: rank(s) {bad} failed:\n" +
                             "\n".join(logs[r][-3000:] for r in bad))
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def _probe_collectives(torch, dist) -> dict:
    """Which of the port's collectives the running backend takes on CUDA
    tensors: the ring's rotation (``ring_shift``: point to point under
    NCCL, an ``all_to_all_single`` to one neighbour under gloo; f32 and
    bool), ``all_to_all_single`` in every dtype the exchanges ship (int32
    ids, f32, bf16 and int8 payloads) and in its async form; a refusal is
    printed and fails the run by name."""
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device="cuda")
    checks = {}

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return float(y[0]) == world * (world + 1) / 2

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [float(q[0]) for q in parts] == [r + 1.0 for r in range(world)]

    def all_gather_into_tensor():
        y = torch.empty(4 * world, device="cuda")
        dist.all_gather_into_tensor(y, x)
        return float(y[-1]) == float(world)

    def all_to_all_single(dtype, async_op=False):
        def check():
            src = (torch.arange(world, device="cuda") + 10 * rank).to(dtype)
            dst = torch.empty_like(src)
            work = dist.all_to_all_single(dst, src, async_op=async_op)
            if async_op:
                work.wait()
            return [float(v) for v in dst.float()] == [rank + 10.0 * r
                                                      for r in range(world)]
        return check

    def ring(dtype):
        def check():
            from tdfo_tpu_torch.parallel.collectives import ring_shift

            src = torch.full((3,), rank + 1, device="cuda").to(dtype)
            got = ring_shift(src, dist.group.WORLD)
            return got.float().tolist() == [float(
                torch.tensor((rank - 1) % world + 1).to(dtype))] * 3
        return check

    for name, fn in (("ring_shift", ring(torch.float32)),
                     ("ring_shift[bool]", ring(torch.bool)),
                     ("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("all_to_all_single", all_to_all_single(torch.float32)),
                     ("all_to_all_single[int32]", all_to_all_single(torch.int32)),
                     ("all_to_all_single[bfloat16]", all_to_all_single(torch.bfloat16)),
                     ("all_to_all_single[int8]", all_to_all_single(torch.int8)),
                     ("all_to_all_single[async]",
                      all_to_all_single(torch.int64, async_op=True))):
        try:
            checks[name] = "ok" if fn() else "wrong result"
        except RuntimeError as e:
            checks[name] = f"refused: {str(e).splitlines()[0][:160]}"
    torch.cuda.synchronize()
    return checks


def _decoded(torch, tables, aname, ids):
    """Rows ``ids`` of the global int8 array ``aname`` decoded (CPU), and
    their grid steps (the scales)."""
    from tdfo_tpu_torch.ops.quant import dequantize_rows
    from tdfo_tpu_torch.parallel.embedding import qscale_name

    idx = torch.from_numpy(ids).to(tables[aname].device)
    qs = tables[qscale_name(aname)][idx]
    return dequantize_rows(tables[aname][idx], qs).cpu(), qs[:, 0].cpu()


def dist_rank_main(spec: dict) -> int:
    """One rank of ``dist_main``: the TwoTower headline regime (phase 3's
    initial state and batches) on this rank's shards through each mode of
    ``DIST_MODES``, held to the single-device step that this rank also
    runs (the int8 arm to the single-device int8 step)."""
    import copy

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tdfo_tpu_torch.core.config import MeshSpec
    from tdfo_tpu_torch.core.mesh import data_slice, initialize_distributed, make_mesh
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        BatchGroup,
        SparseTrainState,
        make_pipelined_sparse_train_step,
        make_sparse_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed("cuda", backend=spec["backend"], force=True)
    rank, world = dist.get_rank(), dist.get_world_size()
    res: dict = {"backend": dist.get_backend(), "world": world}
    if spec.get("probe"):
        res["collectives"] = _probe_collectives(torch, dist)
        print(f"dist probe ({dist.get_backend()}, CUDA tensors): {res['collectives']}",
              flush=True)
        refused = [k for k, v in res["collectives"].items() if v != "ok"]
        if refused:
            raise RuntimeError(f"{dist.get_backend()} refuses CUDA tensors in "
                               f"{refused}: {res['collectives']}")
    mesh = make_mesh(MeshSpec(data=spec["mesh"][0], model=spec["mesh"][1], seq=1),
                     "cuda")
    specs = ctr_embedding_specs(SIZE_MAP, DIM, "row")
    tables0 = ShardedEmbeddingCollection(specs).init(0, device="cpu")
    # the int8 arm: bench.py's int8 TwoTower (every table plain int8)
    specs8 = _with_dtype(ctr_embedding_specs(SIZE_MAP, DIM, "row", fused_threshold=None),
                         torch.int8)
    coll8 = ShardedEmbeddingCollection(specs8)
    tables8 = coll8.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    host = [make_host_batch(rng, BATCH) for _ in range(DIST_STEPS + DIST_TIMED)]
    _, ref, ref_step = build_main_path(torch, "cuda", tables0, backbone0)
    ref_losses = []
    for h in host[:DIST_STEPS]:
        ref, loss = ref_step(ref, to_device(torch, h, "cuda"))
        ref_losses.append(float(loss))
    ref_tables = {k: v.detach().cpu() for k, v in ref.tables.items()}
    ref_bb = {k: v.detach().cpu() for k, v in ref.backbone.state_dict().items()}
    del ref
    # the single-device int8 step: its losses and touched user rows
    modes8 = [m for m in spec["modes"] if m.startswith("int8_")]
    if modes8:
        user8, _, off8 = coll8.resolve("user_id")
        touched = np.unique(np.concatenate(
            [h["user_id"] for h in host[:DIST_STEPS]])).astype(np.int64) + off8
        bb8 = copy.deepcopy(backbone0).cuda()
        st8 = SparseTrainState.create(
            backbone=bb8, tables={k: v.to("cuda", copy=True) for k, v in tables8.items()},
            sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
            learning_rate=LR, weight_decay=WD)
        step8 = make_sparse_train_step(coll8, ctr_sparse_forward(bb8))
        ref8_losses = []
        for h in host[:DIST_STEPS]:
            st8, loss = step8(st8, to_device(torch, h, "cuda"))
            ref8_losses.append(float(loss))
        ref8_rows, ref8_step = _decoded(torch, st8.tables, user8, touched)
        base8, _ = _decoded(torch, tables8, user8, touched)
        del st8, bb8
    torch.cuda.empty_cache()
    rows = data_slice(mesh, BATCH)
    res["modes"] = {}
    grouped_run = None  # the eager grouped run's losses, tables and slots
    for mode in spec["modes"]:
        int8 = mode.startswith("int8_")
        lookup = mode if mode in ("gspmd", "psum") else "alltoall"
        grouped = mode in ("grouped", "pipelined", "int8_grouped")
        mspecs, mtables = (specs8, tables8) if int8 else (specs, tables0)
        coll = ShardedEmbeddingCollection(mspecs, mesh=mesh, grouped_a2a=grouped)
        local, _ = coll.local_arrays({k: v.to("cuda", copy=True)
                                      for k, v in mtables.items()}, {})
        backbone = copy.deepcopy(backbone0).cuda()
        state = SparseTrainState.create(
            backbone=backbone, tables=local,
            sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
            learning_rate=LR, weight_decay=WD)
        fwd = ctr_sparse_forward(backbone)
        batches = [{k: v[rows] for k, v in to_device(torch, h, "cuda").items()}
                   for h in host]
        forward_bitwise = None
        if grouped and mode != "pipelined":
            # the grouped forward against the per-table program's
            per_table = ShardedEmbeddingCollection(mspecs, mesh=mesh)
            share = BatchGroup(mesh, "alltoall").split(batches[0])
            ids = {f: share[f] for f in coll.features()}
            with torch.no_grad():
                a = coll.lookup(state.tables, ids, mode="alltoall")
                b = per_table.lookup(state.tables, ids, mode="alltoall")
            forward_bitwise = all(torch.equal(a[f], b[f]) for f in ids)
            if not forward_bitwise:
                raise AssertionError(f"dist {mode} world {world}: the grouped forward "
                                     "is not bitwise the per-table alltoall forward")
        if mode == "pipelined":
            pipe = make_pipelined_sparse_train_step(coll, fwd)

            def train(st, bs):
                carry, out = pipe.prime(bs[0]), []
                for b in bs[1:]:
                    st, loss, carry = pipe.step(st, b, carry)
                    out.append(loss)
                st, loss = pipe.flush(st, carry)
                return st, out + [loss]
        else:
            step = make_sparse_train_step(coll, fwd, mode=lookup)

            def train(st, bs):
                out = []
                for b in bs:
                    st, loss = step(st, b)
                    out.append(loss)
                return st, out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kl.fat_line_update.launches = 0
        segment_sum.launches = 0
        state, losses = train(state, batches[:DIST_STEPS])
        losses = [float(x) for x in losses]
        got, got_slots = coll.global_arrays(state.tables, state.slots)
        # host copies (at world 1 the gathers return the live shards)
        got = {k: v.to("cpu", copy=True) for k, v in got.items()}
        rec = {"losses": losses, "forward_bitwise": forward_bitwise}
        rtol, atol = TOL["trajectory"]
        if int8:
            np.testing.assert_allclose(losses, ref8_losses, rtol=BF16_LOSS_RTOL)
            # the sharded update draws its own stochastic-rounding bits (the
            # key folds the model index; grouped, the table id too): each
            # run lands within its own grid step of one value, so the rule
            # spans the two runs' steps
            rows8, step8 = _decoded(torch, got, user8, touched)
            rec["rule"] = _check_int8_rows(torch, "user rows", rows8, ref8_rows,
                                           base8, ref8_step + step8,
                                           apart="the two runs' grid steps")
            bitwise = False
            worst = float((rows8.double() - ref8_rows.double()).abs().max())
        else:
            bitwise = losses == ref_losses and all(
                torch.equal(got[k], v) for k, v in ref_tables.items()) and all(
                torch.equal(v.detach().cpu(), ref_bb[k])
                for k, v in backbone.state_dict().items())
            worst = max(float((got[k].double() - v.double()).abs().max())
                        for k, v in ref_tables.items())
            # bitwise at world 1 everywhere, and over model shards where
            # the batch is not split (gspmd, psum); a split batch sums the
            # dense gradients in another order
            want_bitwise = world == 1 or lookup != "alltoall"
            if want_bitwise and not bitwise:
                raise AssertionError(
                    f"dist {mode} world {world}: not bitwise the single-device "
                    f"step (losses {losses} vs {ref_losses}, max |table diff| "
                    f"{worst:.3e})")
            np.testing.assert_allclose(losses, ref_losses, rtol=rtol, atol=atol)
            for k, v in ref_tables.items():
                torch.testing.assert_close(got[k], v, rtol=rtol, atol=atol)
        if mode == "grouped":
            grouped_run = (losses, got, {k: [t.to("cpu", copy=True) for t in v]
                                         for k, v in got_slots.items()})
        if mode == "pipelined":
            gl, gt, gs = grouped_run
            same = losses == gl and all(torch.equal(got[k], v) for k, v in gt.items()) \
                and all(torch.equal(a.cpu(), b) for k, v in gs.items()
                        for a, b in zip(got_slots[k], v))
            if not same:
                raise AssertionError(f"dist pipelined world {world}: not bitwise the "
                                     f"eager grouped step (losses {losses} vs {gl})")
            rec["bitwise_eager_grouped"] = True
        del got, got_slots
        # timed steps, the collectives under CUDA events
        (state, _), ms, coll_ms, calls = _time_steps(
            torch, dist, lambda: train(state, batches[DIST_STEPS:]))
        step_ms = ms / DIST_TIMED
        coll_ms = {k: v / DIST_TIMED for k, v in coll_ms.items()}
        a2a = calls.get("all_to_all_single", 0) / DIST_TIMED
        if mode in DIST_A2A and a2a != DIST_A2A[mode]:
            raise AssertionError(f"dist {mode}: {a2a} all_to_all_single calls a step, "
                                 f"not {DIST_A2A[mode]}")
        launches = kl.fat_line_update.launches
        want = 0 if int8 else DIST_STEPS + DIST_TIMED
        if launches != want:
            raise AssertionError(f"dist {mode}: fat_line_update launched {launches} "
                                 f"times in {DIST_STEPS + DIST_TIMED} steps, not {want}")
        rec.update({
            "bitwise": bitwise, "max_abs_diff": worst,
            "step_ms": step_ms, "collective_ms": coll_ms, "a2a_per_step": a2a,
            "fat_line_update_launches": launches,
            "segment_sum_launches": segment_sum.launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        res["modes"][mode] = rec
        held = (rec["rule"] if int8 else "bitwise" if bitwise
                else f"max |diff| {worst:.3e}")
        print(f"dist {mode} world {world} ({res['backend']}, mesh {spec['mesh']}) "
              f"rank {rank}: {held} against the single-device step over "
              f"{DIST_STEPS} steps; step_ms {step_ms:.3f}, collectives {coll_ms} ms "
              f"a step, all_to_all_single {a2a} a step, fat_line_update launches "
              f"{launches}, segment_sum launches {segment_sum.launches}, peak "
              f"{rec['peak_gb']:.2f} GB", flush=True)
        del state, batches, local
        torch.cuda.empty_cache()
    (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_dist_main(torch, card: str) -> dict:
    """dist_main: (a) world 1 over NCCL, mesh (1, 1, 1), every mode of
    ``DIST_MODES`` (the f32 ones bitwise the single-device step); (b)
    world 2 on the one card over gloo (NCCL refuses two ranks on a
    device), data 1 x model 2, after probing which collectives gloo takes
    on CUDA tensors: ``gspmd`` and ``psum`` bitwise; ``alltoall``,
    ``grouped`` and ``pipelined`` (the batch split over the ranks, the
    dense gradients summed in another order) at the trajectory rung; (c)
    NCCL at world = the card count where there are several cards.  At
    every world: the grouped forward bitwise the per-table ``alltoall``
    forward, the pipelined step bitwise the eager grouped one, the int8
    arm within the narrow-storage rule of the single-device int8 step
    (its control failing), ``all_to_all_single`` calls a step as
    ``DIST_A2A`` says, ``fat_line_update`` once a step on each rank.
    Then (d) the CTR arms (``DIST_CTR_RUNS``, ``_ctr_arm``), and over
    NCCL on several cards."""
    runs = {}
    t0 = time.perf_counter()
    runs["nccl_1"] = _spawn_ranks(1, {"backend": "nccl", "mesh": [1, 1],
                                      "modes": list(DIST_MODES)}, "world 1 nccl")
    runs["gloo_2"] = _spawn_ranks(2, {"backend": "gloo", "mesh": [1, 2], "probe": True,
                                      "modes": list(DIST_MODES)}, "world 2 gloo")
    n = torch.cuda.device_count()
    if n >= 2:
        runs[f"nccl_{n}"] = _spawn_ranks(n, {"backend": "nccl", "mesh": [1, n],
                                             "modes": list(DIST_MODES)}, f"world {n} nccl")
    launches, segsums = {}, {}
    for key, ranks in runs.items():
        for mode in DIST_MODES:
            m = [r["modes"][mode] for r in ranks]
            launches[f"{key}/{mode}"] = [x["fat_line_update_launches"] for x in m]
            segsums[f"{key}/{mode}"] = [x["segment_sum_launches"] for x in m]
            held = ("narrow rule" if mode.startswith("int8_") else "bitwise"
                    if all(x["bitwise"] for x in m) else "rtol 1e-4")
            say(f"dist_main: {key} {mode}: {held}; "
                f"step_ms {[round(x['step_ms'], 3) for x in m]}, collective ms "
                f"{[{k: round(v, 4) for k, v in x['collective_ms'].items()} for x in m]}, "
                f"all_to_all_single a step {[x['a2a_per_step'] for x in m]}, "
                f"fat_line_update launches per rank {launches[f'{key}/{mode}']}, "
                f"segment_sum launches per rank {segsums[f'{key}/{mode}']}, "
                f"peak GB per rank {[round(x['peak_gb'], 2) for x in m]}")
    # the CTR arms (ROADMAP item 12b's CTR half); a world of every card over
    # NCCL where there are several: data-parallel, and with an even count
    # of four or more data x model 2
    ctr_runs = list(DIST_CTR_RUNS)
    if n >= 2:
        ctr_runs.append(("nccl", n, (n, 1), ("criteo",)))
    if n >= 4 and n % 2 == 0:
        ctr_runs.append(("nccl", n, (n // 2, 2), ("criteo", "cache", "hot_f32")))
    ctr_launches: dict = {}
    for backend, world, (d, m), arms in ctr_runs:
        key = f"{backend}_{world}_{d}x{m}"
        ranks = _spawn_ranks(world, {"backend": backend, "mesh": [d, m],
                                     "arms": list(arms)},
                             f"ctr world {world} {backend} mesh {d}x{m}",
                             timeout=DIST_CTR_TIMEOUT_S)
        for arm in arms:
            a = [r["arms"][arm] for r in ranks]
            ctr_launches[f"{key}/{arm}"] = [x["launches"] for x in a]
            say(f"dist_main: ctr {arm} world {world} ({backend}, data {d} x model "
                f"{m}): {a[0]['held']}; {a[0]['alt'] or 'no alternate path'}"
                f"{' bitwise' if a[0]['alt_held'] else ''}; step_ms "
                f"{[round(x['step_ms'], 3) for x in a]}, collective ms "
                f"{[{k: round(v, 4) for k, v in x['collective_ms'].items()} for x in a]}, "
                f"calls a step {[x['collective_calls'] for x in a]}, launches per "
                f"rank in {DIST_STEPS + DIST_TIMED} steps {ctr_launches[f'{key}/{arm}']}, "
                f"peak GB per rank {[round(x['peak_gb'], 2) for x in a]}")
    say(f"dist_main: gloo on CUDA tensors: {runs['gloo_2'][0]['collectives']}; "
        f"{time.perf_counter() - t0:.1f} s; on {card}")
    return {"launches": launches, "segment_sum_launches": segsums,
            "ctr_launches": ctr_launches}


# ------------------------------------------------ dist_main's CTR arms
# ROADMAP item 12b's CTR half under a mesh, each arm held to the
# single-device step that its ranks also run: "criteo" is phase 11's
# DLRM-Criteo regime (dedup_lookup: the routed kernel on the replicated fat
# stack at model 1, fat_line_update on each shard at model 2), "cache"
# phase 23's int8 stack with the 2,097,152-row update cache (zipf ids),
# "hot_f32" / "hot_int8" phase 24's hot/cold regime, "column" phase
# 3's tables column-sharded, plain, under rowwise_adagrad, and
# "column_cache" the same with the update cache (each rank caching its
# columns; the alternate path, the cache off, is the "column" arm).  Each run's rank
# processes take their arms in order: (backend, world, (data, model), arms).
DIST_CTR_RUNS = (
    ("nccl", 1, (1, 1), ("criteo", "cache", "hot_f32", "hot_int8", "column_cache")),
    ("gloo", 2, (2, 1), ("criteo", "cache", "hot_f32", "hot_int8")),
    ("gloo", 2, (1, 2), ("criteo", "cache", "hot_f32", "hot_int8", "column",
                         "column_cache")),
)
# the column arm's update cache: B 8192 uniform ids over user's 500,000
# rows touch at most 16,384 rows in a DIST_CTR_FLUSH-step interval, which
# the retained half must cover
COLUMN_CACHE_ROWS = 65_536
DIST_CTR_FLUSH = 2  # the cache arm's flush cadence, in steps
# the kernels each arm's main path must launch once a step, by model size
DIST_CTR_KERNELS = {("criteo", 1): "fat_line_update_routed",
                    ("criteo", 2): "fat_line_update"}


def _ctr_arm_setup(torch, arm):
    """``(make_coll(mesh), tables0 on the card, backbone0, host batches,
    the alternate path)`` of a CTR arm; the alternate path ("default":
    ``dedup_lookup`` off, f32 storage; "eager": no cache) must train the
    main path's bits."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    n = DIST_STEPS + DIST_TIMED
    rng = np.random.default_rng(31)
    kw = dict(stack_tables=True, fused_kind="rowwise_adagrad")
    if arm.startswith("column"):
        specs = ctr_embedding_specs(SIZE_MAP, DIM, "column", fused_threshold=None)
        kw = dict(fused_kind="rowwise_adagrad")
        host = [make_host_batch(rng, BATCH) for _ in range(n)]
        backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
        alt = None
        if arm == "column_cache":
            kw["cache_rows"], alt = COLUMN_CACHE_ROWS, "eager"
    else:
        backbone0 = DLRMBackbone(CRITEO_DIM, cat_columns=CRITEO_CATS,
                                 cont_columns=CRITEO_CONTS,
                                 generator=torch.Generator().manual_seed(1))
        if arm == "criteo":
            specs = generic_embedding_specs(size_map, CRITEO_CATS, CRITEO_DIM, "row",
                                            fused_threshold=CRITEO_FUSED_MIN)
            host = [criteo_host_batch(rng) for _ in range(n)]
            alt = "default"
        else:
            dtype = torch.float32 if arm == "hot_f32" else torch.int8
            specs = _with_dtype(generic_embedding_specs(
                size_map, CRITEO_CATS, CRITEO_DIM, "row", fused_threshold=None), dtype)
            host = [criteo_zipf_batch(rng) for _ in range(n)]
            if arm == "cache":
                kw["cache_rows"], alt = CACHE_ROWS_STACK, "eager"
            else:
                kw["hot_ids"] = {c: np.arange(min(HOT_VOCAB, v), dtype=np.int32)
                                 for c, v in size_map.items()}
                # int8 rows round with bits drawn over the dedupe's block,
                # whose height differs between the two paths
                alt = "default" if arm == "hot_f32" else None

    def make_coll(mesh, cached=True):
        args = dict(kw, cache_rows=kw.get("cache_rows", 0) if cached else 0)
        return ShardedEmbeddingCollection(specs, mesh=mesh, **args)

    tables0 = make_coll(None).init(0, device="cuda")
    return make_coll, tables0, backbone0, host, alt


def _ctr_rows(torch, coll, state, host):
    """Each array's touched rows over the host batches (the single-device
    row numbering), read from their owners on every rank: ``{name: (rows
    [n, W] f32, grid steps [n] or None)}`` on the CPU (fat: the whole slot,
    table and state; plain: the decoded row and its accumulator; int8 also
    each row's scale), and each hot head's touched rows."""
    from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_group
    from tdfo_tpu_torch.ops.fat_lines import fat_view
    from tdfo_tpu_torch.ops.quant import dequantize_rows
    from tdfo_tpu_torch.parallel.collectives import all_gather_cat
    from tdfo_tpu_torch.parallel.embedding import qscale_name

    ids: dict = {}
    heads: dict = {}
    for f in coll.features():
        aname, spec, off = coll.resolve(f)
        hot, cold = coll.route_ids(f, torch.from_numpy(np.concatenate([h[f] for h in host])))
        ids.setdefault(aname, []).append(cold[cold >= 0].numpy().astype(np.int64) + off)
        if hot is not None:
            heads.setdefault(coll.hot_array_name(spec.name), []).append(
                hot[hot >= 0].numpy().astype(np.int64))
    out = {}
    for aname, parts in ids.items():
        idx = torch.from_numpy(np.unique(np.concatenate(parts))).cuda()
        table, take = state.tables[aname], coll.owner_gather(aname)
        if coll.array_placement(aname) == "column":  # columns all-gathered
            group = axis_group(coll.mesh, MODEL_AXIS)
            take = lambda t, i, g=group: (all_gather_cat(t[i], g, dim=1)  # noqa: E731
                                          if t.dim() == 2 else t[i])
        if table.dim() == 3:
            out[aname] = (take(fat_view(table, coll.fat_layout_for(aname)), idx).cpu(), None)
            continue
        acc = take(state.slots[aname][0], idx).reshape(idx.shape[0], -1).float()
        step = None
        if coll.array_is_int8(aname):
            qs = take(state.tables[qscale_name(aname)], idx)
            rows, step = dequantize_rows(take(table, idx), qs), qs[:, 0].cpu()
        else:
            rows = take(table, idx).float()
        out[aname] = (torch.cat([rows, acc], dim=1).cpu(), step)
    for hname, parts in heads.items():
        idx = torch.from_numpy(np.unique(np.concatenate(parts))).cuda()
        out[hname] = (state.tables[hname][idx].to("cpu", copy=True), None)
    return out


def _ctr_held(torch, what, got, want, base, bitwise):
    """``got`` (the mesh run's :func:`_ctr_rows`) against ``want`` (the
    single-device run's): bitwise where ``bitwise``, else f32 rows within
    rtol 1e-4, int8 rows by the narrow-storage rule spanning the two runs'
    grid steps (``base``: the initial rows, its control) and the hot heads
    pooled by the head rule (``_check_heads``).  Returns a summary."""
    from tdfo_tpu_torch.interop import TOL

    if got.keys() != want.keys():
        raise AssertionError(f"{what}: arrays {sorted(got)} vs {sorted(want)}")
    if bitwise:
        bad = [a for a in want if not torch.equal(got[a][0], want[a][0])]
        if bad:
            worst = {a: float((got[a][0] - want[a][0]).abs().max()) for a in bad}
            raise AssertionError(f"{what}: not bitwise the single-device step: {worst}")
        return "bitwise"
    rtol, atol = TOL["trajectory"]
    parts, heads = [], []
    for a, (g, step_g) in got.items():
        c, step_c = want[a]
        if a.endswith("__hot"):
            heads.append((g, c, base[a][0]))
        elif step_c is not None:
            parts.append(_check_int8_rows(torch, a, g, c, base[a][0], step_c + step_g,
                                          apart="the two runs' grid steps"))
        else:
            torch.testing.assert_close(g, c, rtol=rtol, atol=atol,
                                       msg=lambda s_, a=a: f"{what} {a}: {s_}")
            parts.append(f"{a}: {g.shape[0]} touched rows within rtol {rtol}")
    if heads:
        parts.append(_check_heads(torch, f"{len(heads)} heads",
                                  *(torch.cat(x) for x in zip(*heads)), rtol, atol,
                                  2 * LR * DIST_STEPS))
    return "; ".join(parts)


def _time_steps(torch, dist, run):
    """``run()`` with ``torch.distributed``'s all_reduce, all_gather and
    all_to_all_single timed by CUDA events: ``(run's result, host ms,
    {collective: ms}, {collective: calls})``."""
    events: list = []
    orig = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                          "all_to_all_single")}

    def timed(name, fn):
        def call(*a, **k):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            out = fn(*a, **k)
            s1.record()
            events.append((name, s0, s1))
            return out
        return call

    for n, fn in orig.items():
        setattr(dist, n, timed(n, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in orig.items():
            setattr(dist, n, fn)
    coll_ms: dict = {}
    calls: dict = {}
    for n, s0, s1 in events:
        coll_ms[n] = coll_ms.get(n, 0.0) + s0.elapsed_time(s1)
        calls[n] = calls.get(n, 0) + 1
    return out, ms, coll_ms, calls


def _ctr_arm(torch, dist, mesh, arm, backend) -> dict:
    """One CTR arm on this rank: the single-device step (3 steps), the mesh
    step (3 compared + 3 timed, the kernels' launches counted over them),
    then the alternate path on the mesh (3 steps, bitwise the mesh step)."""
    import copy

    from tdfo_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, axis_size, data_slice
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_cache_flush_fn,
        make_sparse_train_step,
    )
    from tdfo_tpu_torch.train.trainer import _check_cache_overflow

    world, rank = dist.get_world_size(), dist.get_rank()
    n_data, n_model = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    make_coll, tables0, backbone0, host, alt = _ctr_arm_setup(torch, arm)
    int8 = arm in ("cache", "hot_int8")

    def build(coll, dedup, device_tables):
        backbone = copy.deepcopy(backbone0).cuda()
        state = SparseTrainState.create(
            backbone=backbone, tables=device_tables,
            sparse_opt=sparse_optimizer("rowwise_adagrad", lr=LR),
            learning_rate=LR, weight_decay=WD)
        state.slots.update(coll.init_caches(state.tables, state.sparse_opt))
        step = make_sparse_train_step(coll, ctr_sparse_forward(backbone),
                                      dedup_lookup=dedup)
        flush = make_cache_flush_fn(coll) if coll.cache_rows else None

        def train(st, batches, first):
            losses = []
            for i, b in enumerate(batches):
                st, loss = step(st, b)
                losses.append(loss)
                if flush is not None and (first + i + 1) % DIST_CTR_FLUSH == 0:
                    st, over = flush(st)
                    _check_cache_overflow(over, coll.mesh)
            if flush is not None:  # the tables authoritative
                st, over = flush(st)
                _check_cache_overflow(over, coll.mesh)
            return st, [float(x) for x in losses]

        return state, train

    dedup = not arm.startswith("column")
    # the single-device step (the ranks' data slices are its batch)
    one = make_coll(None)
    ref, train = build(one, dedup, {k: v.clone() for k, v in tables0.items()})
    ref, ref_losses = train(ref, [to_device(torch, h, "cuda") for h in host[:DIST_STEPS]], 0)
    want = _ctr_rows(torch, one, ref, host[:DIST_STEPS])
    base = _ctr_rows(torch, one, SparseTrainState.create(
        backbone=copy.deepcopy(backbone0), tables=tables0,
        sparse_opt=sparse_optimizer("rowwise_adagrad", lr=LR), learning_rate=LR,
        weight_decay=WD), host[:DIST_STEPS])
    del ref
    torch.cuda.empty_cache()

    rows = data_slice(mesh, BATCH)
    batches = [{k: v[rows] for k, v in to_device(torch, h, "cuda").items()} for h in host]
    coll = make_coll(mesh)

    def mesh_tables():
        return coll.local_arrays({k: v.clone() for k, v in tables0.items()}, {})[0]

    state, train = build(coll, dedup, mesh_tables())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kl.fat_line_update.launches = kr.fat_line_update_routed.launches = 0
    segment_sum.launches = 0
    state, losses = train(state, batches[:DIST_STEPS], 0)
    got = _ctr_rows(torch, coll, state, host[:DIST_STEPS])
    bitwise = world == 1 or n_data == 1  # gspmd over model only
    rtol, atol = TOL["trajectory"]
    if bitwise and losses != ref_losses:
        raise AssertionError(f"dist {arm}: losses {losses} vs {ref_losses}")
    np.testing.assert_allclose(losses, ref_losses,
                               rtol=BF16_LOSS_RTOL if int8 else rtol, atol=atol)
    held = _ctr_held(torch, f"dist {arm}", got, want, base, bitwise)
    (state, _), ms, coll_ms, calls = _time_steps(
        torch, dist, lambda: train(state, batches[DIST_STEPS:], DIST_STEPS))
    launches = {"fat_line_update": kl.fat_line_update.launches,
                "fat_line_update_routed": kr.fat_line_update_routed.launches,
                "segment_sum": segment_sum.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = DIST_STEPS + DIST_TIMED
    kernel = DIST_CTR_KERNELS.get((arm, n_model))
    fat_want = {k: steps if k == kernel else 0
                for k in ("fat_line_update", "fat_line_update_routed")}
    if {k: launches[k] for k in fat_want} != fat_want or not launches["segment_sum"]:
        raise AssertionError(f"dist {arm}: launches in {steps} steps {launches}, "
                             f"expected {fat_want} and segment_sum")
    del state
    torch.cuda.empty_cache()
    alt_held = None
    if alt is not None:  # the alternate path: the main path's bits
        acoll = make_coll(mesh, cached=alt != "eager")
        st, atrain = build(acoll, dedup and alt != "default", acoll.local_arrays(
            {k: v.clone() for k, v in tables0.items()}, {})[0])
        st, alosses = atrain(st, batches[:DIST_STEPS], 0)
        if alosses != losses:
            raise AssertionError(f"dist {arm}: {alt} losses {alosses} vs {losses}")
        alt_held = _ctr_held(torch, f"dist {arm} {alt}", _ctr_rows(
            torch, acoll, st, host[:DIST_STEPS]), got, None, True)
        del st
        torch.cuda.empty_cache()
    rec = {"losses": losses, "held": held, "alt": alt, "alt_held": alt_held,
           "step_ms": ms / DIST_TIMED,
           "collective_ms": {k: v / DIST_TIMED for k, v in coll_ms.items()},
           "collective_calls": {k: v / DIST_TIMED for k, v in calls.items()},
           "launches": launches, "peak_gb": peak}
    print(f"dist ctr {arm} world {world} ({backend}, mesh data {n_data} x model "
          f"{n_model}) rank {rank}: {held} against the single-device step over "
          f"{DIST_STEPS} steps; {alt or 'no alternate path'}"
          f"{': bitwise' if alt_held else ''}; step_ms {rec['step_ms']:.3f}, "
          f"collectives {rec['collective_ms']} ms a step, launches in {steps} "
          f"steps {launches}, peak {peak:.2f} GB", flush=True)
    del tables0, batches
    torch.cuda.empty_cache()
    return rec


def dist_rank_ctr(spec: dict) -> int:
    """One rank of ``dist_main``'s CTR arms (``DIST_CTR_RUNS``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tdfo_tpu_torch.core.config import MeshSpec
    from tdfo_tpu_torch.core.mesh import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed("cuda", backend=spec["backend"], force=True)
    mesh = make_mesh(MeshSpec(data=spec["mesh"][0], model=spec["mesh"][1], seq=1),
                     "cuda")
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "arms": {arm: _ctr_arm(torch, dist, mesh, arm, spec["backend"])
                    for arm in spec["arms"]}}
    (Path(spec["out"]) / f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _kill_tree(pid: int) -> None:
    """SIGKILL ``pid`` and every process below it (torchrun starts its
    workers in sessions of their own, so a process-group kill misses
    them); children first, read from ``/proc``."""
    import os
    import signal

    kids: dict[int, list[int]] = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        kids.setdefault(ppid, []).append(int(d.name))
    order, todo = [], [pid]
    while todo:
        p = todo.pop()
        order.append(p)
        todo.extend(kids.get(p, []))
    for p in reversed(order):
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


# dist_cli's tomls: the DMP TwoTower per-table alltoall exchange and the
# grouped one pipelined (the next batch's id exchange in flight while one
# trains); then configs/dlrm-criteo.toml as shipped (dedup_lookup,
# rowwise_adagrad, [mesh] data = -1, model = 1), with the update cache and
# with hot/cold tables
DIST_CLI_VARIANTS = {
    "alltoall": "",
    "pipelined": "[embeddings]\ngrouped_a2a = true\n[train]\npipeline_overlap = true\n",
    "criteo": "",
    "criteo_cache": "[embeddings]\ncache_rows = 131072\nflush_every = 4\n",
    "criteo_hot": "[embeddings]\nhot_vocab = 64\n",
}
# synthetic Criteo rows of the dlrm-criteo.toml runs (its batches of 2048,
# two epochs) and their save cadence
DIST_CLI_CRITEO_ROWS, DIST_CLI_CRITEO_EVERY = 20_000, 5


def _mid_checkpoint(ck: Path):
    """The cursor of a committed mid-epoch checkpoint under ``ck``, or
    None."""
    for pth in sorted(ck.glob("cursor_*.json")) if ck.exists() else []:
        if not (ck / pth.stem.split("_", 1)[1] / "state.pt").is_file():
            continue
        try:
            c = json.loads(pth.read_text())
        except (OSError, ValueError):
            continue
        if not c.get("epoch_complete"):
            return c
    return None


def phase_dist_cli(torch) -> dict:
    """dist_cli: ``python -m torch.distributed.run --nproc-per-node 1 -m
    tdfo_tpu_torch.launch train --distributed always`` on two DMP TwoTower
    tomls (synthetic data, ``lookup_mode = "alltoall"``, every table fat;
    the second with ``grouped_a2a`` and ``pipeline_overlap``), each
    SIGKILLed (torchrun and its worker) once a mid-epoch checkpoint is
    committed, run again, and held bitwise to an uninterrupted run: every
    tensor of the final checkpoints.  The same for
    ``configs/dlrm-criteo.toml`` with its ``data_dir`` set (synthetic
    Criteo rows) and a save cadence, as shipped (``dedup_lookup``,
    rowwise_adagrad, ``[mesh] data = -1``), with the update cache and with
    ``hot_vocab`` (``DIST_CLI_VARIANTS``).  The first runs start together,
    then the resumed ones."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import (
        write_synthetic_criteo,
        write_synthetic_goodreads,
    )
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_goodreads(tmp / "data", n_users=DIST_CLI_USERS)
        write_synthetic_criteo(tmp / "criteo", n_rows=DIST_CLI_CRITEO_ROWS)
        body = (f'data_dir = "{tmp / "data"}"\nmodel = "twotower"\n'
                "model_parallel = true\nembed_dim = 16\nn_epochs = 1\n"
                "learning_rate = 3e-4\nweight_decay = 1e-4\n"
                "per_device_train_batch_size = 2048\nper_device_eval_batch_size = 2048\n"
                'lookup_mode = "alltoall"\nfused_table_threshold = 0\n'
                f"log_every_n_steps = 10\ncheckpoint_every_n_steps = {DIST_CLI_EVERY}\n")

        def criteo_toml(ckpt: Path) -> str:
            """configs/dlrm-criteo.toml with its data_dir here and a save
            cadence (the top-level keys before its [mesh] table)."""
            out = []
            for line in (ROOT / "configs" / "dlrm-criteo.toml").read_text().splitlines():
                if line.startswith("data_dir ="):
                    line = f'data_dir = "{tmp / "criteo"}"'
                elif line.startswith("[mesh]"):
                    out += [f'checkpoint_dir = "{ckpt}"',
                            f"checkpoint_every_n_steps = {DIST_CLI_CRITEO_EVERY}"]
                out.append(line)
            return "\n".join(out) + "\n"

        cfgs = {}
        for v, extra in DIST_CLI_VARIANTS.items():
            for name in ("killed", "whole"):
                cfgs[v, name] = tmp / f"{v}_{name}.toml"
                ck = tmp / v / name
                cfgs[v, name].write_text(
                    (criteo_toml(ck) if v.startswith("criteo") else
                     body + f'checkpoint_dir = "{ck}"\n') + extra)
        if launch.main(["preprocess-ctr", "--config",
                        str(cfgs["alltoall", "whole"])]) != 0:
            raise AssertionError("launch preprocess-ctr failed")
        # the Criteo ETL under the hot toml writes hot_ids.json beside the
        # shards every Criteo variant reads
        if launch.main(["preprocess-criteo", "--config",
                        str(cfgs["criteo_hot", "whole"])]) != 0:
            raise AssertionError("launch preprocess-criteo failed")

        def cmd(key):
            return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                    "1", "--master-port", str(_free_port()), "-m",
                    "tdfo_tpu_torch.launch", "train", "--distributed", "always",
                    "--config", str(cfgs[key])]

        t0 = time.perf_counter()
        procs: dict = {}
        try:
            # the uninterrupted runs beside the killed ones (worlds of their own)
            for v in DIST_CLI_VARIANTS:
                procs[v, "whole"] = subprocess.Popen(
                    cmd((v, "whole")), cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                with open(tmp / f"{v}_killed1.log", "w") as log:
                    procs[v, "killed"] = subprocess.Popen(
                        cmd((v, "killed")), cwd=ROOT, stdout=log,
                        stderr=subprocess.STDOUT)
            mids: dict = {}
            deadline = time.monotonic() + 600
            while len(mids) < len(DIST_CLI_VARIANTS) and time.monotonic() < deadline:
                for v in DIST_CLI_VARIANTS:
                    proc = procs[v, "killed"]
                    if v in mids or proc.poll() is not None:
                        continue
                    mid = _mid_checkpoint(tmp / v / "killed")
                    if mid is not None:
                        _kill_tree(proc.pid)
                        proc.wait()
                        mids[v] = mid
                if any(procs[v, "killed"].poll() is not None and v not in mids
                       for v in DIST_CLI_VARIANTS):
                    break
                time.sleep(0.005)
            for v in DIST_CLI_VARIANTS:
                if v not in mids:
                    raise AssertionError(
                        f"dist_cli {v}: no mid-epoch checkpoint to kill at (rc "
                        f"{procs[v, 'killed'].poll()}); log:\n"
                        f"{(tmp / f'{v}_killed1.log').read_text()[-3000:]}")
            for v in DIST_CLI_VARIANTS:
                procs[v, "resumed"] = subprocess.Popen(
                    cmd((v, "killed")), cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            outs = {k: p.communicate(timeout=900)[0] for k, p in procs.items()
                    if k[1] != "killed"}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    _kill_tree(p.pid)
                    p.wait()
        for k, out in outs.items():
            if procs[k].returncode != 0:
                raise AssertionError(f"dist_cli {k[0]} {k[1]} run failed:\n{out[-3000:]}")
        secs = time.perf_counter() - t0
        res = {}
        for v in DIST_CLI_VARIANTS:
            finals = {}
            for name in ("killed", "whole"):
                d = tmp / v / name
                step = CheckpointManager(d).latest_step()
                finals[name] = (step, torch.load(d / str(step) / "state.pt",
                                                 map_location="cpu", weights_only=True))
            recs = [json.loads(x) for x in (tmp / v / "killed" / "metrics.jsonl")
                    .read_text().splitlines()]
            resumed = [r for r in recs if "resumed_mid_epoch" in r]
            if not resumed:
                raise AssertionError(f"dist_cli {v}: the restarted run did not resume "
                                     f"mid-epoch: {recs[-5:]}")
            (sa, a), (sb, b) = finals["killed"], finals["whole"]
            fa, fb = state_tensors(a["state"]), state_tensors(b["state"])
            diff = [k for k in fb if not (k in fa and (torch.equal(fa[k], fb[k])
                                                      if isinstance(fb[k], torch.Tensor)
                                                      else fa[k] == fb[k]))]
            if sa != sb or fa.keys() != fb.keys() or diff:
                raise AssertionError(
                    f"dist_cli {v}: the resumed run's final checkpoint (step {sa}) is "
                    f"not bitwise the uninterrupted one's (step {sb}): {len(diff)} "
                    f"tensors differ, e.g. {diff[:5]}")
            say(f"dist_cli {v}: torchrun --nproc-per-node 1, launch train "
                f"--distributed always: SIGKILL after the mid-epoch save at step "
                f"{mids[v]['step']}, resumed at step {resumed[0]['step']}; final "
                f"checkpoint (step {sa}, {len(fa)} tensors) bitwise the "
                f"uninterrupted run's (run beside the killed one)")
            res[v] = resumed[0]["step"]
    say(f"dist_cli: {len(DIST_CLI_VARIANTS)} tomls killed, resumed and held "
        f"bitwise in {secs:.1f} s")
    return {"resumed_at": res}


# ------------------------------------------------ dist_seq (Bert4Rec)
# ROADMAP item 12b's sequence half: Bert4Rec across ranks at the full width
# of configs/bert4rec.toml (B4R, B4R_BATCH rows a rank, dropout on), each
# arm held to the single-device step (on global rank 0) from the same
# seeds.  Runs: (backend, world, ((arm, (data, model, seq)), ...)), each
# one set of rank processes; two ranks and four share the one card over
# gloo (NCCL refuses two ranks on a device).
DIST_SEQ_RUNS = (
    ("nccl", 1, (("ring_flash", (1, 1, 1)), ("long", (1, 1, 1)))),
    ("gloo", 2, (("data2", (2, 1, 1)), ("gspmd", (1, 2, 1)), ("alltoall", (1, 2, 1)),
                 ("tp", (1, 2, 1)), ("ring", (1, 1, 2)), ("ring_flash", (1, 1, 2)),
                 ("long", (1, 1, 2)))),
    ("gloo", 4, (("tp_heads", (1, 2, 2)),)),
)
# arm -> (make_sharded_bert4rec options, lookup mode, the single-device
# twin's attention); an arm is bitwise its twin where only the item table
# splits (model ranks under gspmd) or the ring has one rank
DIST_SEQ_ARMS = {
    "data2": (dict(attn="flash"), "gspmd", "flash"),
    "gspmd": (dict(attn="flash"), "gspmd", "flash"),
    "alltoall": (dict(attn="flash"), "alltoall", "flash"),
    "tp": (dict(attn="full", tensor_parallel=True), "gspmd", "full"),
    "ring": (dict(attn="ring"), "gspmd", "full"),
    "ring_flash": (dict(attn="ring_flash"), "gspmd", "flash"),
    "tp_heads": (dict(attn="ring_flash", tensor_parallel=True, tp_heads=True),
                 "gspmd", "flash"),
}
DIST_SEQ_TIMEOUT_S = 600
# the attention-only long-context arm: bench_kernels.py:471-511's shape,
# the ring with ring_block_k 512 against ring_flash, forward and backward
LONG_SHAPE, LONG_BLOCK_K, LONG_REPS = (1, 4, 8192, 64), 512, 5


def _b4r_seq_setup(torch, mesh, arm):
    """``(collection, state, step)`` of a Bert4Rec arm on the card (``mesh``
    None: the single-device twin), from B4R_SEED like every other run."""
    from tdfo_tpu_torch.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState, make_sparse_train_step

    opts, mode, twin = DIST_SEQ_ARMS[arm]
    if mesh is None:
        opts = dict(attn=twin)
    coll, tables, backbone = make_sharded_bert4rec(
        Bert4RecConfig(**B4R), seed=B4R_SEED, device="cuda", mesh=mesh, **opts)
    state = SparseTrainState.create(
        backbone=backbone, tables=tables,
        sparse_opt=sparse_optimizer("adam", lr=LR, weight_decay=WD),
        learning_rate=LR, weight_decay=WD)
    return coll, state, make_sparse_train_step(coll, bert4rec_sparse_forward(backbone),
                                               mode=mode)


def _b4r_seq_rows(torch, coll, state, touched):
    """The whole slots (weights | adam mu | nu) of item rows ``touched``,
    from the state's tables gathered into the single-device layout."""
    from tdfo_tpu_torch.ops.fat_lines import fat_view

    tables, _ = coll.global_arrays(state.tables, {})
    aname, _, off = coll.resolve("item")
    return fat_view(tables[aname], coll.fat_layout_for(aname))[touched + off].cpu()


def _b4r_rows_held(torch, what, got, want, steps) -> str:
    """Item rows of a mesh run against the single-device run's: the
    weights within rtol 1e-4 but for at most 0.1% of the elements, each
    within 2 lr a step (Adam's sign on gradients inside the f32 noise of two
    summation orders, phase b4r_main's rule)."""
    from tdfo_tpu_torch.interop import TOL

    rtol, atol = TOL["trajectory"]
    d = B4R["embed_dim"]
    g, c = got[:, :d], want[:, :d]
    diff = (g - c).abs()
    out = diff > atol + rtol * c.abs()
    n_out, bound = int(out.sum()), 2 * LR * steps
    worst = float(diff[out].max()) if n_out else 0.0
    if n_out > 1e-3 * g.numel() or worst > bound:
        raise AssertionError(f"{what}: {n_out} of {g.numel()} item-row elements "
                             f"outside rtol {rtol} (max |diff| {worst}, bound {bound})")
    return (f"rtol {rtol} ({g.shape[0]} touched rows, max |diff| "
            f"{float(diff.max()):.3e}; {n_out} elements outside, each within "
            f"{bound:.1e})")


def _seq_arm(torch, dist, mesh, arm, backend, twins: dict) -> dict:
    """One Bert4Rec arm on this rank: on global rank 0 the single-device
    twin (3 steps on the global batches; ``twins`` keeps each twin's result
    for the arms that share it); then the mesh run, 3 compared and 3 timed
    steps on this rank's data slice, the kernels' launches counted over
    all 8."""
    from tdfo_tpu_torch.core.mesh import AXES, axis_size, data_slice
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.train.seq import dropout_generator

    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = tuple(axis_size(mesh, a) for a in AXES)
    n_data, seq = sizes[0], sizes[2]
    rng = np.random.default_rng(11)
    host = [b4r_batch(rng, B4R_BATCH * n_data) for _ in range(DIST_STEPS + DIST_TIMED)]
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["item"].ravel() for h in host[:DIST_STEPS]])).astype(np.int64)).cuda()

    def gens(i):
        return dropout_generator(B4R_SEED + 1, i, "cuda")

    twin = (DIST_SEQ_ARMS[arm][2], n_data)
    if rank == 0 and twin not in twins:
        one, ref, ref_step = _b4r_seq_setup(torch, None, arm)
        ref_losses = []
        for i, h in enumerate(host[:DIST_STEPS]):
            ref, loss = ref_step(ref, to_device(torch, h, "cuda"), gens(i))
            ref_losses.append(float(loss))
        twins[twin] = (ref_losses, _b4r_seq_rows(torch, one, ref, touched))
        del ref, one
        torch.cuda.empty_cache()
    ref_losses, want = twins.get(twin, (None, None))
    rows = data_slice(mesh, B4R_BATCH * n_data)
    batches = [{k: v[rows] for k, v in to_device(torch, h, "cuda").items()} for h in host]
    coll, state, step = _b4r_seq_setup(torch, mesh, arm)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i, b in enumerate(batches[:DIST_STEPS]):
        state, loss = step(state, b, gens(i))
        losses.append(float(loss))
    got = _b4r_seq_rows(torch, coll, state, touched)
    held = None
    if rank == 0:
        bitwise = world == 1 or (n_data == 1 and seq == 1 and arm == "gspmd")
        if bitwise:
            if losses != ref_losses or not torch.equal(got, want):
                raise AssertionError(
                    f"dist_seq {arm}: not bitwise the single-device step: losses "
                    f"{losses} vs {ref_losses}, rows max |diff| "
                    f"{float((got - want).abs().max())}")
            held = "bitwise"
        else:
            rtol, atol = TOL["trajectory"]
            np.testing.assert_allclose(losses, ref_losses, rtol=rtol, atol=atol)
            held = _b4r_rows_held(torch, f"dist_seq {arm}", got, want, DIST_STEPS)
    del got

    def timed():
        st = state
        for i, b in enumerate(batches[DIST_STEPS:]):
            st, loss = step(st, b, gens(DIST_STEPS + i))
        return float(loss)

    dist.barrier()  # rank 0's checks above: start the window together
    _, ms, coll_ms, calls = _time_steps(torch, dist, timed)
    steps = DIST_STEPS + DIST_TIMED
    counts = flash_counts()
    per_step = {k: v / steps for k, v in counts.items()}
    layers = B4R["n_layers"]
    attn = DIST_SEQ_ARMS[arm][0]["attn"]
    flash_want = layers * (seq if attn == "ring_flash" else 1 if attn == "flash" else 0)
    want_counts = {"fat_line_update": 1, **dict.fromkeys(FLASH_KERNELS, flash_want)}
    if per_step != want_counts:
        raise AssertionError(f"dist_seq {arm}: launches a step {per_step}, "
                             f"expected {want_counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"losses": losses, "held": held, "step_ms": ms / DIST_TIMED,
           "collective_ms": {k: v / DIST_TIMED for k, v in coll_ms.items()},
           "collective_calls": {k: v / DIST_TIMED for k, v in calls.items()},
           "launches_per_step": per_step, "peak_gb": peak}
    print(f"dist seq {arm} world {world} ({backend}, mesh {sizes}) rank {rank}: "
          f"{held or 'compared on rank 0'}; step_ms {rec['step_ms']:.3f}, collectives "
          f"{rec['collective_ms']} ms a step, launches a step {per_step}, peak "
          f"{peak:.2f} GB", flush=True)
    del state, batches
    torch.cuda.empty_cache()
    return rec


def _long_arm(torch, dist, mesh, backend) -> dict:
    """Attention alone at bench_kernels.py:471-511's shape (B 1, H 4, T
    8192, Dh 64, bf16) over this mesh's seq axis: ``ring_flash`` against
    the ring (``block_k`` 512), forward and backward of ``sum(out ** 2)``;
    each timed by CUDA events over LONG_REPS calls."""
    from tdfo_tpu_torch.core.mesh import SEQ_AXIS, axis_size
    from tdfo_tpu_torch.parallel.ring_attention import ring_self_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(LONG_SHAPE, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))

    def run(impl):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ring_self_attention(mesh, *xs, impl=impl,
                                  block_k=LONG_BLOCK_K if impl == "xla" else None)
        return out.detach(), torch.autograd.grad((out.float() ** 2).sum(), xs)

    ring_out, ring_g = run("xla")
    zero_counts()
    flash_out, flash_g = run("flash")
    counts = flash_counts()
    err = float((flash_out.float() - ring_out.float()).abs().max())
    gerr = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(flash_g, ring_g))
    p = axis_size(mesh, SEQ_AXIS)
    if err > 2e-2 or gerr > 5e-2:
        raise AssertionError(f"dist_seq long: ring_flash vs ring max |out diff| {err} "
                             f"(2e-2), largest grad diff / max |grad| {gerr} (5e-2)")
    if [counts[k] for k in FLASH_KERNELS] != [p] * 3:
        raise AssertionError(f"dist_seq long: launches {counts}, expected {p} each")
    ms = {}
    for impl in ("xla", "flash", "flash", "xla"):  # in turns
        dist.barrier()
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        for _ in range(LONG_REPS):
            run(impl)
        s1.record()
        torch.cuda.synchronize()
        ms.setdefault(impl, []).append(s0.elapsed_time(s1) / LONG_REPS)
    rec = {"ring_ms": min(ms["xla"]), "ring_flash_ms": min(ms["flash"]),
           "max_abs_err": err, "grad_rel_err": gerr, "seq": p}
    print(f"dist seq long ({backend}, seq {p}) rank {dist.get_rank()}: ring_flash vs "
          f"ring (block_k {LONG_BLOCK_K}) fwd+bwd at {LONG_SHAPE} bf16: out max |diff| "
          f"{err:.3e}, grads {gerr:.3e} of max; ring {rec['ring_ms']:.3f} ms, "
          f"ring_flash {rec['ring_flash_ms']:.3f} ms a call; flash launches a call "
          f"{counts}", flush=True)
    return rec


def dist_rank_seq(spec: dict) -> int:
    """One rank of ``dist_seq`` (``DIST_SEQ_RUNS``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tdfo_tpu_torch.core.config import MeshSpec
    from tdfo_tpu_torch.core.mesh import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed("cuda", backend=spec["backend"], force=True)
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(), "arms": {}}
    meshes: dict = {}
    twins: dict = {}
    for arm, (d, m, s) in spec["seq_arms"]:
        if (d, m, s) not in meshes:
            meshes[d, m, s] = make_mesh(MeshSpec(data=d, model=m, seq=s), "cuda")
        mesh = meshes[d, m, s]
        res["arms"][f"{arm}@{d}x{m}x{s}"] = (
            _long_arm(torch, dist, mesh, spec["backend"]) if arm == "long"
            else _seq_arm(torch, dist, mesh, arm, spec["backend"], twins))
    (Path(spec["out"]) / f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_dist_seq(torch, card: str) -> dict:
    """dist_seq: the Bert4Rec arms of ``DIST_SEQ_RUNS`` (world 1 over NCCL:
    ring_flash on a ring of one, bitwise flash; worlds 2 and 4 over gloo on
    the one card: data 2, model 2 under gspmd (bitwise) and alltoall, model
    2 tensor parallel, seq 2 ring and ring_flash, seq 2 x model 2 ring_flash
    with tp_heads) and the long-context attention arm at seq 1 and 2; then
    a ring_flash, ``[mesh] seq = 2`` toml through ``torch.distributed.run``
    (``--backend gloo``), killed and resumed bitwise (:func:`_seq_cli`),
    runs as the journey ``seq_cli`` beside it.
    Where there are several cards, NCCL alone: world 1, then the ring,
    ring_flash, the long arm and (at four or more) seq x model 2 with
    tp_heads at world = the card count, one rank a card, the rotation
    NCCL's point-to-point pair."""
    t0 = time.perf_counter()
    out: dict = {"launches": {}}
    runs = list(DIST_SEQ_RUNS)
    n = torch.cuda.device_count()
    if n >= 2:  # one rank a card: NCCL (point-to-point for the ring) in
        # place of the gloo runs that share one card
        arms = [("ring_flash", (1, 1, n)), ("ring", (1, 1, n)), ("long", (1, 1, n))]
        if n >= 4 and n % 2 == 0:
            arms.append(("tp_heads", (1, 2, n // 2)))
        runs = [r for r in runs if r[0] == "nccl"] + [("nccl", n, tuple(arms))]
    for backend, world, arms in runs:
        ranks = _spawn_ranks(world, {"backend": backend, "seq_arms": arms},
                             f"seq world {world} {backend}", timeout=DIST_SEQ_TIMEOUT_S)
        for arm, mesh3 in arms:
            tag = f"{arm}@{'x'.join(map(str, mesh3))}"
            key = f"{backend}_{world}_{'x'.join(map(str, mesh3))}"
            a = [r["arms"][tag] for r in ranks]
            if arm == "long":
                say(f"dist_seq: long attention seq {a[0]['seq']} ({backend}): ring "
                    f"{[round(x['ring_ms'], 3) for x in a]} ms, ring_flash "
                    f"{[round(x['ring_flash_ms'], 3) for x in a]} ms a fwd+bwd per "
                    f"rank; out max |diff| {a[0]['max_abs_err']:.3e}, grads "
                    f"{a[0]['grad_rel_err']:.3e} of max")
                out[f"{key}/long"] = a[0]
                continue
            out["launches"][f"{key}/{arm}"] = [x["launches_per_step"] for x in a]
            say(f"dist_seq: {arm} world {world} ({backend}, data x model x seq "
                f"{mesh3}): {a[0]['held']}; step_ms "
                f"{[round(x['step_ms'], 3) for x in a]}, collective ms "
                f"{[{k: round(v, 4) for k, v in x['collective_ms'].items()} for x in a]}, "
                f"calls a step {[x['collective_calls'] for x in a]}, launches a step "
                f"per rank {out['launches'][f'{key}/{arm}']}, peak GB per rank "
                f"{[round(x['peak_gb'], 2) for x in a]}")
    say(f"dist_seq: {time.perf_counter() - t0:.1f} s; on {card}")
    return out


def phase_seq_cli(torch) -> dict | None:
    """seq_cli: :func:`_seq_cli` on one card (the toml's two ranks share it
    over gloo); on a machine with several cards dist_seq runs NCCL alone
    and this journey has nothing to run."""
    if torch.cuda.device_count() != 1:
        say("seq_cli: several cards: the gloo toml run is a one-card check")
        return None
    return _seq_cli(torch)


# the seq CLI's toml: configs/bert4rec.toml's model (d 64, 2 heads, 2
# layers, T 20, dropout 0.1) under ring_flash on a seq axis of 2, its
# vocabulary the synthetic catalogue's
SEQ_CLI_USERS, SEQ_CLI_BATCH, SEQ_CLI_EVERY = 800, 64, 5


def _seq_cli(torch) -> dict:
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    tdfo_tpu_torch.launch train --backend gloo`` on a Bert4Rec toml with
    ``attn = "ring_flash"`` and ``[mesh] seq = 2``: SIGKILLed (torchrun and
    its workers) once a mid-epoch checkpoint is committed, run again, and
    held bitwise to an uninterrupted run beside it (every tensor of the
    final checkpoints)."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_goodreads(tmp / "data", n_users=SEQ_CLI_USERS)
        cfgs = {}
        for name in ("killed", "whole"):
            cfgs[name] = tmp / f"{name}.toml"
            cfgs[name].write_text(
                f'data_dir = "{tmp / "data"}"\nmodel = "bert4rec"\n'
                'attn = "ring_flash"\nmax_len = 20\nembed_dim = 64\nn_heads = 2\n'
                "n_layers = 2\ndropout = 0.1\nn_epochs = 1\nlearning_rate = 3e-4\n"
                f"per_device_train_batch_size = {SEQ_CLI_BATCH}\n"
                f"per_device_eval_batch_size = {SEQ_CLI_BATCH}\n"
                f'log_every_n_steps = 5\ncheckpoint_dir = "{tmp / name}"\n'
                f"checkpoint_every_n_steps = {SEQ_CLI_EVERY}\n"
                "[mesh]\ndata = 1\nmodel = 1\nseq = 2\n")
        if launch.main(["preprocess-seq", "--config", str(cfgs["whole"])]) != 0:
            raise AssertionError("launch preprocess-seq failed")

        def cmd(name):
            return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                    "2", "--master-port", str(_free_port()), "-m",
                    "tdfo_tpu_torch.launch", "train", "--backend", "gloo",
                    "--config", str(cfgs[name])]

        t0 = time.perf_counter()
        procs: dict = {}
        try:
            procs["whole"] = subprocess.Popen(cmd("whole"), cwd=ROOT,
                                              stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)
            with open(tmp / "killed1.log", "w") as log:
                procs["killed"] = subprocess.Popen(cmd("killed"), cwd=ROOT, stdout=log,
                                                   stderr=subprocess.STDOUT)
            mid = None
            deadline = time.monotonic() + 600
            while mid is None and time.monotonic() < deadline:
                if procs["killed"].poll() is not None:
                    break
                mid = _mid_checkpoint(tmp / "killed")
                if mid is not None:
                    _kill_tree(procs["killed"].pid)
                    procs["killed"].wait()
                time.sleep(0.005)
            if mid is None:
                raise AssertionError(
                    f"dist_seq cli: no mid-epoch checkpoint to kill at (rc "
                    f"{procs['killed'].poll()}); log:\n"
                    f"{(tmp / 'killed1.log').read_text()[-3000:]}")
            procs["resumed"] = subprocess.Popen(cmd("killed"), cwd=ROOT,
                                                stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
            outs = {k: p.communicate(timeout=900)[0] for k, p in procs.items()
                    if k != "killed"}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    _kill_tree(p.pid)
                    p.wait()
        for k, log in outs.items():
            if procs[k].returncode != 0:
                raise AssertionError(f"dist_seq cli {k} run failed:\n{log[-3000:]}")
        secs = time.perf_counter() - t0
        finals = {}
        for name in ("killed", "whole"):
            step = CheckpointManager(tmp / name).latest_step()
            finals[name] = (step, torch.load(tmp / name / str(step) / "state.pt",
                                             map_location="cpu", weights_only=True))
        recs = [json.loads(x) for x in (tmp / "killed" / "metrics.jsonl")
                .read_text().splitlines()]
    resumed = [r for r in recs if "resumed_mid_epoch" in r]
    if not resumed:
        raise AssertionError(f"dist_seq cli: no mid-epoch resume: {recs[-5:]}")
    (sa, a), (sb, b) = finals["killed"], finals["whole"]
    fa, fb = state_tensors(a["state"]), state_tensors(b["state"])
    diff = [k for k in fb if not (k in fa and (torch.equal(fa[k], fb[k])
                                              if isinstance(fb[k], torch.Tensor)
                                              else fa[k] == fb[k]))]
    if sa != sb or fa.keys() != fb.keys() or diff:
        raise AssertionError(
            f"dist_seq cli: the resumed run's final checkpoint (step {sa}) is not "
            f"bitwise the uninterrupted one's (step {sb}): {len(diff)} tensors "
            f"differ, e.g. {diff[:5]}")
    keys = [f"{m}@{k}" for k in (10, 20, 50) for m in ("Recall", "NDCG")]
    tests = [r for r in recs if all(f"test_{k}" in r for k in keys)]
    say(f"dist_seq cli: torchrun --nproc-per-node 2 --backend gloo, ring_flash, "
        f"[mesh] seq = 2: SIGKILL after the mid-epoch save at step {mid['step']}, "
        f"resumed at step {resumed[0]['step']}; final checkpoint (step {sa}, "
        f"{len(fa)} tensors) bitwise the uninterrupted run's; test "
        f"{ {k: round(tests[-1]['test_' + k], 4) for k in keys} if tests else None}; "
        f"{secs:.1f} s")
    return {"resumed_at": resumed[0]["step"], "final_step": sa}


def jagged_rows(rng, b: int = B4R_BATCH):
    """A random ragged Bert4Rec batch: per row a length in [1, T], items in
    [1, n_items], 20% masked and labelled; returned packed (values,
    lengths) and padded at the tail ([B, T])."""
    from tdfo_tpu_torch.data.jagged import pack_rows

    n, t = B4R["n_items"], B4R["max_len"]
    items, labels = [], []
    for _ in range(b):
        k = int(rng.integers(1, t + 1))
        it = rng.integers(1, n + 1, k).astype(np.int32)
        m = rng.random(k) < B4R_MASK_PROB
        m[0] = True
        labels.append(np.where(m, it, 0).astype(np.int32))
        items.append(np.where(m, n + 1, it).astype(np.int32))
    iv, il = pack_rows(items, b * t)
    lv, _ = pack_rows(labels, b * t)
    pad = {"item": np.zeros((b, t), np.int32), "label": np.zeros((b, t), np.int32)}
    for r, (it, lb) in enumerate(zip(items, labels)):
        pad["item"][r, :len(it)] = it
        pad["label"][r, :len(lb)] = lb
    return {"item_values": iv, "item_lengths": il, "label_values": lv}, pad


def phase_b4r_jagged(torch, card: str, check_steps: int = 3) -> dict:
    """Phase 20: the Bert4Rec CLI at configs/bert4rec.toml's width with
    ``jagged = true`` and ``attn = "flash"`` (``synth -> preprocess-seq ->
    train``, the flash launches counted); then the jagged step and the
    padded step from b4r_main's initial state on the same 3 batches (and
    dropout draws): losses within rtol 1e-4."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.jagged import jagged_to_dense_per_host
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.bert4rec import PAD_ID
    from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward, dropout_generator
    from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step

    text = (ROOT / "configs" / "bert4rec.toml").read_text()
    for line in ('data_dir = "data/goodreads"', "n_epochs = 10", 'attn = "full"'):
        if line not in text:
            raise AssertionError(f"configs/bert4rec.toml lost {line!r}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = tmp / "bert4rec.toml"
        cfg.write_text(
            text.replace('data_dir = "data/goodreads"', f'data_dir = "{tmp / "data"}"')
            .replace("n_epochs = 10", "n_epochs = 1")
            .replace('attn = "full"', 'attn = "flash"')
            + "jagged = true\nlog_every_n_steps = 4\n")
        for cmd in ("synth", "preprocess-seq"):
            if launch.main([cmd, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {cmd} failed")
        zero_counts()
        trainer = launch.run(["train", "--config", str(cfg), "--log-dir",
                              str(tmp / "logs"), "--device", "cuda"])
        counts = flash_counts()
        recs = [json.loads(x) for x in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    evals = [r for r in recs if "Recall@10" in r]
    n_layers = trainer.model_cfg.n_layers
    if (not steps or not evals or not all(0.0 <= r["Recall@10"] <= 1.0 for r in evals)
            or counts["flash_bwd_dq"] != n_layers * steps
            or counts["flash_bwd_dkv"] != n_layers * steps
            or counts["flash_fwd"] < n_layers * steps):
        raise AssertionError(f"jagged CLI: {steps} steps, launches {counts}, "
                             f"evals {evals}")
    say(f"b4r_jagged: configs/bert4rec.toml (d {trainer.model_cfg.embed_dim}, "
        f"{n_layers} layers, T {trainer.model_cfg.max_len}, B "
        f"{trainer.config.per_device_train_batch_size}) with jagged = true, attn "
        f"= flash: {steps} steps, Recall@10 {evals[-1]['Recall@10']:.4f}, "
        f"launches {counts}")
    del trainer

    coll, tables0, backbone0 = b4r_initial()
    t_len = B4R["max_len"]

    def to_dense(batch):
        lengths = batch["item_lengths"]
        return {k: jagged_to_dense_per_host(batch[f"{k}_values"], lengths, t_len,
                                            PAD_ID) for k in ("item", "label")}

    rng = np.random.default_rng(41)
    pairs = [jagged_rows(rng) for _ in range(check_steps)]
    runs = {}
    for mode in ("jagged", "padded"):
        state, _ = b4r_state(torch, coll, tables0, backbone0, "cuda")
        step = make_sparse_train_step(
            coll, bert4rec_sparse_forward(state.backbone),
            batch_transform=to_dense if mode == "jagged" else None)
        zero_counts()
        ls = []
        for jag, pad in pairs:
            b = to_device(torch, jag if mode == "jagged" else pad, "cuda")
            gen = dropout_generator(B4R_SEED + 1, state.step, "cuda")
            state, loss = step(state, b, gen)
            ls.append(float(loss))
        runs[mode] = (ls, flash_counts())
        del state
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(runs["jagged"][0], runs["padded"][0], rtol=rtol,
                               atol=atol)
    say(f"b4r_jagged: jagged vs padded step from one state on {check_steps} "
        f"batches at b4r_main's width (dropout {B4R['dropout']}): losses "
        f"{runs['jagged'][0]} vs {runs['padded'][0]} (rtol {rtol}); launches "
        f"{runs['jagged'][1]}, on {card}")
    return {"launches": counts}


# ----------------------------------------------- phases 21-25 (ROADMAP item 13)

# int8 storage, the update cache and hot/cold tables at full width.  No
# hand-written kernel is on these paths (the reference runs them as plain
# XLA); each phase holds the fat-line kernels at zero launches, since int8
# lines and plain tables must never reach them.
INT8_FUSED_ROWS = 2_000_000      # bench.py::bench_quant_int8_fused
CACHE_ROWS, FLUSH_EVERY, CACHE_STEPS = 131_072, 64, 130  # dlrm-criteo.toml:85-103
# the toml's 131,072 rows cover one big table's 64-step working set, but
# stack_tables puts all 26 tables in ONE cached array: at B = 8192 zipf
# traffic a 64-step interval touches about 619,000 distinct rows of the
# stack (numpy count of the phase's draws), so the toml's cache overflows
# and the trainer refuses; the measured runs size the cache to the stack
CACHE_ROWS_STACK = 2_097_152
HOT_VOCAB = 16_384               # docs/BUDGET.md:102-124
ZIPF_A = 1.2                     # bench.py::bench_cache_int8_zipf
# criteo_int8_cli: synthetic rows (about 84 train batches of 256; 60,000
# before PR 14 made room for dist_cli's Criteo tomls), the save cadence and
# a flush interval the save falls inside
CLI_ROWS, CLI_CKPT_EVERY, CLI_FLUSH_EVERY, CLI_HOT_VOCAB = 24_000, 5, 4, 64
# The card-vs-CPU check of the int8 paths: both devices round the same f32
# rows with the same random draws, so a touched code differs only where the
# two devices' f32 rows straddle a rounding boundary; held like the bf16
# paths (BF16_FAR_SHARE): at most INT8_FAR_SHARE of the touched elements
# more than one grid step (the row's scale) apart, losses within
# BF16_LOSS_RTOL, and the initial rows, as a control, must fail the share.
INT8_FAR_SHARE = BF16_FAR_SHARE
# The hot heads, held across devices (dlrm_hot_cold: card vs CPU) and
# across layouts (dist_main's hot arms: a data-split mesh vs one device).
# A head row takes thousands of a zipf batch's ids, whose gradients nearly
# cancel in its sum; rowwise_adagrad divides each row's step by the root
# mean square of that sum, so an ulp-level difference in the summands (two
# devices' GEMMs, or the dense gradients all-reduced in two halves) moves a
# few head elements by up to lr a step, and an int8 cold row a grid step
# apart does the same through the forward.  The rule (``_check_heads``): at
# most HEAD_SHARE of the touched head elements, pooled over the heads, may
# lie beyond rtol 1e-4, none more than an update of the other sign (2 lr a
# step) apart, and two controls must fail it: the initial rows and the
# update's sign flipped on a seeded HEAD_PLANT of the elements.  Readings
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): the int8 pass 0.2522%
# and 0% before the card's sums took the CPU's order (PR 9), 0% in every
# run after (PR 12); the f32 pass 0.0385% (9 of 23,360) on one other init;
# PR 14's five-init study (``--phases hot_head_inits``) in PERF.md.  The
# limit sits above every reading, below the planted control (1.0084%).
HEAD_SHARE = 0.003
HEAD_PLANT = 0.01


def _with_dtype(specs, dtype):
    import dataclasses

    return [dataclasses.replace(s, dtype=dtype) for s in specs]


def fat_launches():
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr

    return kl.fat_line_update.launches + kr.fat_line_update_routed.launches


def int8_rows(torch, state, aname, ids):
    """Decoded rows ``ids`` (numpy, array rows) of int8 array ``aname``
    and each row's grid step (its scale), on the CPU."""
    from tdfo_tpu_torch.ops.quant import dequantize_rows
    from tdfo_tpu_torch.parallel.embedding import qscale_name

    idx = torch.from_numpy(ids).to(state.tables[aname].device)
    qs = state.tables[qscale_name(aname)][idx]
    return dequantize_rows(state.tables[aname][idx], qs).cpu(), qs[:, 0].cpu()


def _check_int8_rows(torch, name, g, c, base, step, apart="one grid step"):
    """Decoded card rows ``g`` vs CPU rows ``c`` ([n, d]) within one grid
    step ``step`` ([n], the CPU rows' scale; or what ``apart`` names), and
    the initial rows ``base`` as the control (the note at INT8_FAR_SHARE);
    returns a summary."""
    diff = (g - c).abs()
    far = diff > step[:, None] * (1 + 1e-6)
    share = float(far.double().mean())
    share0 = float(((base - c).abs() > step[:, None] * (1 + 1e-6)).double().mean())
    summary = (f"{name}: {g.shape[0]} touched rows, {g.numel()} elements: "
               f"{int((diff == 0).sum())} equal, {int(far.sum())} more than {apart} "
               f"apart ({share:.4%}, at most {INT8_FAR_SHARE:.0%}; max "
               f"|diff| {float(diff.max()):.3e}); control, the initial rows: "
               f"{share0:.4%} beyond {apart}")
    if share > INT8_FAR_SHARE:
        raise AssertionError("card vs CPU: " + summary)
    if share0 <= INT8_FAR_SHARE:
        raise AssertionError("card vs CPU: the control passes, so the check "
                             "cannot fail; " + summary)
    return summary


def _check_heads(torch, name, g, c, base, rtol, atol, bound):
    """The hot heads ``g`` against ``c`` (card vs CPU, or a mesh vs one
    device) on their touched rows, pooled (the note at HEAD_SHARE): at
    most HEAD_SHARE of the elements beyond ``rtol`` / ``atol``, none more
    than ``bound`` apart (an update of the other sign, 2 lr per step).  Two
    controls must fail the share: the initial rows ``base`` (a head that
    took no update) and ``g`` with the update's sign flipped on a seeded
    HEAD_PLANT of the elements (a head updated the wrong way in a few
    elements)."""
    def share_of(x):
        return float(((x - c).abs() > atol + rtol * c.abs()).double().mean())

    diff = (g - c).abs()
    far = diff > atol + rtol * c.abs()
    share = float(far.double().mean())
    share0 = share_of(base)
    plant = torch.rand(g.shape, generator=torch.Generator().manual_seed(11)) < HEAD_PLANT
    share_flip = share_of(torch.where(plant, 2 * base - g, g))
    summary = (f"{name}: {g.shape[0]} touched head rows: {int(far.sum())} of "
               f"{g.numel()} elements beyond rtol {rtol} ({share:.4%}, at most "
               f"{HEAD_SHARE:.2%}; max |diff| {float(diff.max()):.3e}, at most "
               f"{bound:.1e}); controls: the initial rows {share0:.4%}, the "
               f"update's sign flipped on {float(plant.double().mean()):.2%} of "
               f"the elements {share_flip:.4%}")
    if share > HEAD_SHARE or float(diff.max()) > bound:
        raise AssertionError("card vs CPU: " + summary)
    if min(share0, share_flip) <= HEAD_SHARE:
        raise AssertionError("card vs CPU: a control passes, so the check "
                             "cannot fail; " + summary)
    return summary


def _steps_on_card(torch, step, state, batches, warm):
    """Each batch through ``step`` with a synchronise after it: ``(state,
    losses, host ms per step)``; the steady steps are ``times[warm:]``."""
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    return state, losses, times


def _ms_line(times, warm):
    steady = times[warm:]
    return (float(np.median(steady)),
            f"median {float(np.median(steady)):.4f} mean {float(np.mean(steady)):.4f} "
            f"min {min(steady):.4f} max {max(steady):.4f} (host clock, each step "
            f"synchronised, steps {warm + 1}-{len(times)})")


def twotower_int8_initial(torch):
    """Phase 21's collection (``build_sparse_train_bench``'s int8 arm: the
    specs rebuilt plain, every table int8), initial tables (on the CPU) and
    bf16-compute backbone, from fixed seeds."""
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    coll = ShardedEmbeddingCollection(_with_dtype(
        ctr_embedding_specs(SIZE_MAP, DIM, "row", fused_threshold=None), torch.int8))
    tables0 = coll.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1),
                                 dtype=torch.bfloat16)
    return coll, tables0, backbone0


def phase_int8_main(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    """Phase 21: ``bench.py::build_sparse_train_bench(8192, 64,
    table_dtype="int8")`` (``bench.py:535-552``): every table plain int8
    with its (scale, offset) sidecar, sparse adam (f32 slots, int8 tables on
    the row path whatever their vocab) and AdamW at lr 3e-4, wd 1e-4,
    uniform ids, the backbone in bf16 as the bench computes on a chip."""
    coll, tables0, backbone0 = twotower_int8_initial(torch)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in tables0.items()}
    say(f"int8_main: arrays {shapes}")

    def build(device):
        return twotower_bf16_state(torch, coll, tables0, backbone0, device)

    rng = np.random.default_rng(21)
    host = [make_host_batch(rng, BATCH) for _ in range(steps)]
    state, step = build("cuda")
    dev_batches = [to_device(torch, h, "cuda") for h in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_dlrm_counts()
    state, losses, times = _steps_on_card(torch, step, state, dev_batches, check_steps)
    if fat_launches():
        raise AssertionError("a fat-line kernel launched on the int8 path")
    if any(t.dtype != torch.int8 for k, t in state.tables.items()
           if not k.startswith("__qscale__/")):
        raise AssertionError("a table left int8 storage")
    step_ms, line = _ms_line(times, check_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"int8_main: {steps} steps on the card, losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, fat-line launches 0, every table still int8, "
        f"step_ms {line}, peak device memory {peak_gb:.2f} GB, on {card}")
    del state, dev_batches
    torch.cuda.empty_cache()

    runs = {}
    aname, _, off = coll.resolve("user_id")
    touched = np.unique(np.concatenate(
        [h["user_id"] for h in host[:check_steps]])).astype(np.int64) + off
    for device in ("cuda", "cpu"):
        st, stp = build(device)
        if device == "cpu":
            base, _ = int8_rows(torch, st, aname, touched)
        ls = []
        for h in host[:check_steps]:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        runs[device] = (ls, int8_rows(torch, st, aname, touched))
        del st
    (lg, (rg, _)), (lc, (rc, sc)) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=BF16_LOSS_RTOL)
    summary = _check_int8_rows(torch, "user rows", rg, rc, base, sc)
    say(f"int8_main: card vs CPU over {check_steps} steps: losses {lg} vs {lc} "
        f"(rtol {BF16_LOSS_RTOL}); {summary}")
    return {"step_ms": step_ms, "peak_gb": peak_gb, "losses": losses}


def phase_int8_fused(torch, card: str, steps: int = 3, timed: int = 10) -> dict:
    """Phase 22: ``bench.py::bench_quant_int8_fused`` (``:1081-1110``):
    2,000,000 rows at d = 64 under adam (lr 1e-2), B = 8192 uniform ids:
    the int8 byte-container fat lines (640-byte lines of 5 tiles: codes,
    the sidecar and the f32 adam state in one line) against the plain int8
    table with its sidecar and f32 moments.  Fed the same deduped ``(uids,
    g)`` and key each step, the fused update must write the plain update's
    codes, sidecars and state bit for bit (nothing after the dedupe uses
    atomics); then each layout's whole update (dedupe included) is timed
    with CUDA events."""
    from tdfo_tpu_torch.ops.fat_lines import fat_pack, fat_unpack, line_layout
    from tdfo_tpu_torch.ops.quant import quantize_rows, sr_key
    from tdfo_tpu_torch.ops.sparse import dedupe_grads, sparse_optimizer

    v, d = INT8_FUSED_ROWS, DIM
    lay = line_layout(d, "adam", "int8")
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = (torch.rand((v, d), generator=gen, device="cuda") * 2 - 1) * 0.05
    codes, qs = quantize_rows(x)
    del x
    mu = torch.zeros((v, d), device="cuda")
    nu = torch.zeros((v, d), device="cuda")
    fat = fat_pack(codes, mu, nu, kind="adam", dtype="int8", qscale=qs)
    opt = sparse_optimizer("adam", lr=1e-2, small_vocab_threshold=0)
    count = lambda: torch.zeros((), dtype=torch.int32, device="cuda")  # noqa: E731
    plain_slots, fused_slots = (mu, nu, count()), (count(),)
    codes0 = codes.clone()
    zero_dlrm_counts()
    for i in range(steps):
        ids = torch.randint(0, v, (BATCH,), generator=gen, device="cuda")
        g = torch.randn((BATCH, d), generator=gen, device="cuda")
        uids, gu, valid = dedupe_grads(ids, g)
        key = sr_key(i, "bench_quant_int8_fused")
        opt.update_unique(codes, plain_slots, uids, gu, valid, qscale=qs, sr_key=key)
        opt.update_unique(fat, fused_slots, uids, gu, valid, embedding_dim=d,
                          sr_key=key)
    torch.cuda.synchronize()
    if fat_launches():
        raise AssertionError("a fat-line kernel launched on int8 lines")
    fc, fq, fmu, fnu = fat_unpack(fat, lay, rows=v)
    same = {"codes": torch.equal(fc, codes),
            "sidecar": torch.equal(fq.view(torch.int32), qs.view(torch.int32)),
            "mu": torch.equal(fmu.view(torch.int32), mu.view(torch.int32)),
            "nu": torch.equal(fnu.view(torch.int32), nu.view(torch.int32))}
    moved = int((codes != codes0).any(dim=1).sum())
    del fc, fq, fmu, fnu
    if not all(same.values()) or moved == 0:
        raise AssertionError(f"fused vs plain int8 after {steps} steps: bitwise "
                             f"{same}, rows moved {moved}")

    def timed_update(table, slots, **kw):
        ids = torch.randint(0, v, (timed + 2, BATCH), generator=gen, device="cuda")
        g = torch.randn((timed + 2, BATCH, d), generator=gen, device="cuda")
        for i in range(2):
            opt.update(table, slots, ids[i], g[i], sr_key=sr_key(100 + i, "t"), **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for i in range(2, timed + 2):
            opt.update(table, slots, ids[i], g[i], sr_key=sr_key(100 + i, "t"), **kw)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / timed

    ms = {}
    for rnd in range(2):  # plain, fused, fused, plain
        for name in (("plain", "fused") if rnd == 0 else ("fused", "plain")):
            kw = (dict(qscale=qs) if name == "plain" else dict(embedding_dim=d))
            t = timed_update(codes if name == "plain" else fat,
                             plain_slots if name == "plain" else fused_slots, **kw)
            ms.setdefault(name, []).append(t)
    plain_ms, fused_ms = (float(np.mean(ms[k])) for k in ("plain", "fused"))
    hbm = {"fused": fat.numel(), "plain": codes.numel() + qs.numel() * 4
           + mu.numel() * 8}
    say(f"int8_fused: {v} rows, d {d}, adam, B {BATCH}: lines {tuple(fat.shape)} "
        f"({lay.w} B a row, {lay.tiles} tiles); {steps} steps from one state "
        f"with the same deduped ids, grads and keys: fused == plain bitwise "
        f"{same} ({moved} rows moved); whole update (dedupe included), CUDA "
        f"events over {timed} steps, turns plain/fused/fused/plain: plain "
        f"{[round(x, 4) for x in ms['plain']]} ms, fused "
        f"{[round(x, 4) for x in ms['fused']]} ms, vs_plain "
        f"{plain_ms / fused_ms:.3f}; table + state bytes {hbm}, on {card}")
    return {"plain_ms": plain_ms, "fused_ms": fused_ms}


def criteo_zipf_batch(rng: np.random.Generator, b: int = BATCH) -> dict:
    """bench.py:248-265 with ``powerlaw``: frequency-ranked zipf ids
    (``data/synthetic.py::zipf_ids``, a = 1.2) per table."""
    from tdfo_tpu_torch.data.synthetic import zipf_ids

    out = {c: zipf_ids(rng, v, b, a=ZIPF_A) for c, v in zip(CRITEO_CATS, CRITEO_VOCABS)}
    out.update({c: rng.random(b, dtype=np.float32) for c in CRITEO_CONTS})
    out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return out


def dlrm_criteo_config(torch, tmp: Path, emb_lines: str):
    """``configs/dlrm-criteo.toml`` with ``emb_lines`` appended as its
    ``[embeddings]`` table, read by the port's config (its refusals are the
    reference's) and checked against the port's unported knobs."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.train.trainer import refuse_unported

    text = (ROOT / "configs" / "dlrm-criteo.toml").read_text()
    path = tmp / "dlrm-criteo.toml"
    path.write_text(text + "\n[embeddings]\n" + emb_lines)
    cfg = read_configs(str(path), size_map=dict(zip(CRITEO_CATS, CRITEO_VOCABS)))
    refuse_unported(cfg)
    return cfg


def dlrm_sparse_state(torch, coll, tables0, backbone0, device, cfg, cached):
    """``(state, step, flush)`` of a DLRM-Criteo collection on ``device``
    from copies of the initial state, the toml's sparse optimizer and
    ``dedup_lookup``; ``cached`` adds the update caches."""
    import copy

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_cache_flush_fn,
        make_sparse_train_step,
    )

    backbone = copy.deepcopy(backbone0).to(device)
    state = SparseTrainState.create(
        backbone=backbone,
        tables={k: v.to(device, copy=True) for k, v in tables0.items()},
        sparse_opt=sparse_optimizer(cfg.sparse_optimizer, lr=cfg.learning_rate),
        learning_rate=cfg.learning_rate, weight_decay=WD)
    if cached:
        state.slots.update(coll.init_caches(state.tables, state.sparse_opt))
    step = make_sparse_train_step(coll, ctr_sparse_forward(backbone),
                                  dedup_lookup=cfg.dedup_lookup)
    return state, step, make_cache_flush_fn()


def _stack_ids(coll, host):
    """Each array's distinct touched rows over the batches ``host``
    (negative ids touch nothing)."""
    out = {}
    for c in CRITEO_CATS:
        aname, _, off = coll.resolve(c)
        out.setdefault(aname, []).extend(h[c][h[c] >= 0].astype(np.int64) + off
                                         for h in host)
    return {a: np.unique(np.concatenate(v)) for a, v in out.items()}


def phase_dlrm_int8_cache(torch, card: str, f32_peak_gb=None) -> dict:
    """Phase 23: ``configs/dlrm-criteo.toml`` with ``table_dtype = "int8"``,
    ``cache_rows = 131072``, ``flush_every = 64`` (``:85-103``): the 26
    Criteo tables (33,762,577 rows, d = 16) in one plain int8 stack
    (``fused_table_threshold = -1``) with its sidecar, rowwise_adagrad,
    ``dedup_lookup``, B = 8192, zipf traffic (a = 1.2, as
    ``bench.py::bench_cache_int8_zipf``).  130 steps (two flushes) cached
    and three times uncached from one initial state: overflow 0 at every
    flush, the uncached runs bitwise one another and the cached run bitwise
    them (``spread_check`` over the losses, the decoded touched rows, their accumulators and the
    backbone), step ms of both, flush ms, the hit rate (the share of each
    step's distinct rows the cache already held) and peak memory."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.ops.quant import dequantize_rows
    from tdfo_tpu_torch.ops.sparse import cache_route
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection, qscale_name

    from tdfo_tpu_torch.train.trainer import _check_cache_overflow

    with tempfile.TemporaryDirectory() as tmp:
        cfg = dlrm_criteo_config(torch, Path(tmp), (
            f'table_dtype = "int8"\ncache_rows = {CACHE_ROWS}\n'
            f'flush_every = {FLUSH_EVERY}\n'))
    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    specs = _with_dtype(generic_embedding_specs(
        size_map, CRITEO_CATS, cfg.embed_dim, "row",
        fused_threshold=cfg.effective_fused_threshold), torch.int8)

    def collection(cache_rows):
        return ShardedEmbeddingCollection(
            specs, stack_tables=cfg.stack_tables, fused_kind=cfg.sparse_optimizer,
            cache_rows=cache_rows)

    coll = collection(cfg.embeddings.cache_rows)
    tables0 = coll.init(0, device="cuda")
    backbone0 = DLRMBackbone(cfg.embed_dim, cat_columns=CRITEO_CATS,
                             cont_columns=CRITEO_CONTS,
                             generator=torch.Generator().manual_seed(1))
    say(f"dlrm_int8_cache: arrays {({k: (tuple(v.shape), str(v.dtype)) for k, v in tables0.items()})}, "
        f"{cfg.sparse_optimizer} lr {cfg.learning_rate}, dedup_lookup "
        f"{cfg.dedup_lookup}, cache_rows {cfg.embeddings.cache_rows}, "
        f"flush_every {cfg.embeddings.flush_every}, B {BATCH}, zipf a {ZIPF_A}")
    rng = np.random.default_rng(23)
    host = [criteo_zipf_batch(rng) for _ in range(CACHE_STEPS)]
    touched = _stack_ids(coll, host)

    def compact(state, losses):
        out = {}
        for aname, ids in touched.items():
            idx = torch.from_numpy(ids).cuda()
            qs = state.tables[qscale_name(aname)][idx]
            out[aname] = dequantize_rows(state.tables[aname][idx], qs)
            out[aname + "/acc"] = state.slots[aname][0][idx]
        out["backbone"] = {k: v.detach().clone()
                           for k, v in state.backbone.state_dict().items()}
        return (torch.tensor(losses, dtype=torch.float64), out)

    def run(cached, n=CACHE_STEPS):
        state, step, flush = dlrm_sparse_state(torch, coll, tables0, backbone0,
                                               "cuda", cfg, cached)
        times, flush_ms, hits, overs, losses = [], [], [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, h in enumerate(host[:n]):
            b = to_device(torch, h, "cuda")
            if cached:  # the share of this step's distinct rows already cached
                for aname in coll.cached_array_names(state.sparse_opt, state.tables):
                    ids = torch.cat([b[c].to(torch.int64) + coll.resolve(c)[2]
                                     for c in CRITEO_CATS if coll.resolve(c)[0] == aname])
                    u = torch.unique(ids)
                    _, hit = cache_route(state.slots["__cache__/" + aname], u)
                    hits.append(float(hit.double().mean()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if cached and ((i + 1) % cfg.embeddings.flush_every == 0
                           or i + 1 == n):
                t0 = time.perf_counter()
                state, over = flush(state)
                torch.cuda.synchronize()
                flush_ms.append((time.perf_counter() - t0) * 1e3)
                overs.append({k: int(v) for k, v in over.items()})
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(x) for x in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite losses: {losses}")
        res = compact(state, losses)
        del state
        torch.cuda.empty_cache()
        return res, times, flush_ms, hits, overs, peak

    zero_dlrm_counts()
    # the toml's cache over one flush interval: its overflow must fail the
    # run in the trainer's words; then the stack-sized cache is measured
    *_, probe, _ = run(True, n=cfg.embeddings.flush_every)
    try:
        _check_cache_overflow(probe[0])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    say(f"dlrm_int8_cache: the toml's cache_rows {cfg.embeddings.cache_rows} over "
        f"{cfg.embeddings.flush_every} steps: overflow {probe}; "
        + (f"refused: {refused[:160]}..." if refused else "no overflow"))
    if refused:
        coll = collection(CACHE_ROWS_STACK)
    refs, ref_times, ref_peak = [], [], 0.0
    for _ in range(N_REFS):
        res, times, _, _, _, peak = run(False)
        refs.append(res)
        ref_times.append(times)
        ref_peak = max(ref_peak, peak)
    mine, times, flush_ms, hits, overs, peak = run(True)
    if fat_launches():
        raise AssertionError("a fat-line kernel launched on the int8 path")
    if len(overs) != 3 or any(v for o in overs for v in o.values()):
        raise AssertionError(f"admission overflow at the flushes: {overs}")
    line = spread_check(torch, "dlrm_int8_cache", refs, mine,
                        f"{CACHE_STEPS} steps cached vs uncached")
    cached_ms, cline = _ms_line(times, 3)
    uncached_ms, uline = _ms_line(ref_times[0], 3)
    hit_rate = float(np.mean(hits[FLUSH_EVERY:])) if len(hits) > FLUSH_EVERY else None
    vs = (f", against dlrm_main's f32 fat stack {f32_peak_gb:.2f} GB"
          if f32_peak_gb else "")
    say(f"dlrm_int8_cache: cache_rows {coll.cache_rows}, overflow at the "
        f"{len(overs)} flushes {overs}; {line}")
    say(f"dlrm_int8_cache: step_ms cached {cline}; uncached {uline}; flush_ms "
        f"{[round(x, 3) for x in flush_ms]}; hit rate {np.mean(hits):.4f} over "
        f"all steps, {hit_rate} after the first flush; peak device memory "
        f"cached {peak:.2f} GB, uncached {ref_peak:.2f} GB{vs}; on {card}")
    return {"cached_ms": cached_ms, "uncached_ms": uncached_ms,
            "flush_ms": flush_ms, "hit_rate": hit_rate, "peak_gb": peak}


def _hot_cold_setup(torch, dtype, seed=0):
    """Phase 24's collection over ``dtype`` storage, its initial tables on
    the card (drawn from ``seed``) and the backbone (from ``seed + 1``)."""
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    size_map = dict(zip(CRITEO_CATS, CRITEO_VOCABS))
    hot = {c: np.arange(min(HOT_VOCAB, v), dtype=np.int32) for c, v in size_map.items()}
    coll = ShardedEmbeddingCollection(
        _with_dtype(generic_embedding_specs(size_map, CRITEO_CATS, CRITEO_DIM,
                                            "row", fused_threshold=None), dtype),
        stack_tables=True, fused_kind="rowwise_adagrad", hot_ids=hot)
    tables0 = coll.init(seed, device="cuda")
    backbone0 = DLRMBackbone(CRITEO_DIM, cat_columns=CRITEO_CATS,
                             cont_columns=CRITEO_CONTS,
                             generator=torch.Generator().manual_seed(seed + 1))
    return coll, tables0, backbone0


HOT_CFG = dict(sparse_optimizer="rowwise_adagrad", learning_rate=LR, dedup_lookup=True)


def _hot_cold_card_vs_cpu(torch, coll, tables0, backbone0, host, dtype):
    """``host``'s steps on the card and on the CPU from one state: ``(card
    losses, CPU losses, {array: (card rows, CPU rows, grid steps, initial
    rows)})`` over the touched cold rows (int8 decoded, with the CPU rows'
    grid steps) and each head's touched rows."""
    cfg = type("Cfg", (), HOT_CFG)
    touched = _stack_ids(coll, [{c: np.where(h[c] < HOT_VOCAB, -1, h[c])
                                 for c in CRITEO_CATS} for h in host])
    runs = {}
    for device in ("cuda", "cpu"):
        src = tables0 if device == "cuda" else {k: v.cpu() for k, v in tables0.items()}
        st, stp, _ = dlrm_sparse_state(torch, coll, src, backbone0, device, cfg, False)
        del src
        if device == "cpu":
            base = {a: int8_rows(torch, st, a, ids) if dtype == torch.int8
                    else (st.tables[a][torch.from_numpy(ids)].clone(), None)
                    for a, ids in touched.items()}
        ls = []
        for h in host:
            st, loss = stp(st, to_device(torch, h, device))
            ls.append(float(loss))
        rows = {a: int8_rows(torch, st, a, ids) if dtype == torch.int8
                else (st.tables[a][torch.from_numpy(ids).to(device)].cpu(), None)
                for a, ids in touched.items()}
        rows.update({k: (v.detach().cpu(), None) for k, v in st.tables.items()
                     if k.endswith("__hot")})
        runs[device] = (ls, rows)
        del st
        torch.cuda.empty_cache()
    (lg, rg), (lc, rc) = runs["cuda"], runs["cpu"]
    out = {}
    for a in rg:
        (g, _), (c, scale) = rg[a], rc[a]
        if a.endswith("__hot"):  # the touched rows of the head
            feat = a.removesuffix("_embed__hot")
            ids = np.unique(np.concatenate([h[feat] for h in host]))
            idx = torch.from_numpy(ids[ids < coll.hot_count(f"{feat}_embed")])
            out[a] = (g[idx], c[idx], None, tables0[a][idx.cuda()].cpu())
        else:
            out[a] = (g, c, scale, base[a][0])
    return lg, lc, out


def phase_dlrm_hot_cold(torch, card: str, steps: int = 20, check_steps: int = 3) -> dict:
    """Phase 24: ``bench.py::build_criteo_train_bench(hot_vocab=16384)``
    (``:268-330``): every table's ``[0, min(16384, V))`` prefix a hot head
    (18 of the 26 tables wholly hot), the cold residuals in one plain stack,
    zipf ids, rowwise_adagrad lr 3e-4, ``dedup_lookup``; f32 compute (the
    bench computes the dense half in bf16).  Once with f32 storage and once
    with the int8 cold residual: 20 steps on the card (step ms, peak
    memory, no fat-line launch), then 3 steps on the card and on the CPU
    from one state: f32 losses and touched cold rows within rtol 1e-4;
    int8 losses within BF16_LOSS_RTOL, cold rows by the grid-step rule with
    its control; the touched head rows of both by the head rule
    (``_check_heads``, the note at HEAD_SHARE)."""
    from tdfo_tpu_torch.interop import TOL

    rng = np.random.default_rng(24)
    host = [criteo_zipf_batch(rng) for _ in range(steps)]
    cfg = type("Cfg", (), HOT_CFG)
    out = {}
    for dtype in (torch.float32, torch.int8):
        name = str(dtype).removeprefix("torch.")
        coll, tables0, backbone0 = _hot_cold_setup(torch, dtype)
        full = sum(coll.hot_full(t) for t in coll.hot_tables())
        heads = sum(coll.hot_count(t) for t in coll.hot_tables())
        state, step, _ = dlrm_sparse_state(torch, coll, tables0, backbone0,
                                           "cuda", cfg, False)
        batches = [to_device(torch, h, "cuda") for h in host]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_dlrm_counts()
        state, losses, times = _steps_on_card(torch, step, state, batches, check_steps)
        if fat_launches():
            raise AssertionError("a fat-line kernel launched on the hot/cold path")
        step_ms, line = _ms_line(times, check_steps)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        say(f"dlrm_hot_cold[{name}]: {len(coll.hot_tables())} hot heads ({full} "
            f"tables wholly hot, {heads} head rows), cold arrays "
            f"{({k: tuple(v.shape) for k, v in tables0.items() if not k.endswith('__hot')})}; "
            f"{steps} steps on the card, losses {losses[0]:.6f} -> {losses[-1]:.6f}, "
            f"step_ms {line}, peak device memory {peak_gb:.2f} GB, on {card}")
        del state, batches, step
        torch.cuda.empty_cache()

        lg, lc, rows = _hot_cold_card_vs_cpu(torch, coll, tables0, backbone0,
                                             host[:check_steps], dtype)
        rtol, atol = TOL["trajectory"]
        if dtype == torch.int8:
            np.testing.assert_allclose(lg, lc, rtol=BF16_LOSS_RTOL)
        else:
            np.testing.assert_allclose(lg, lc, rtol=rtol, atol=atol)
        parts, heads = [], []
        for a, (g, c, scale, base) in rows.items():
            if a.endswith("__hot"):
                heads.append((g, c, base))
            elif scale is not None:
                parts.append(_check_int8_rows(torch, a, g, c, base, scale))
            else:
                torch.testing.assert_close(g, c, rtol=rtol, atol=atol,
                                           msg=lambda s_, a=a: f"{a}: {s_}")
                parts.append(f"{a}: {g.shape[0]} touched cold rows within rtol {rtol}")
        parts.append(_check_heads(
            torch, f"{len(heads)} heads", *(torch.cat(x) for x in zip(*heads)),
            rtol, atol, 2 * LR * check_steps))
        say(f"dlrm_hot_cold[{name}]: card vs CPU over {check_steps} steps: losses "
            f"{lg} vs {lc}; " + "; ".join(parts))
        out[name] = {"step_ms": step_ms, "peak_gb": peak_gb}
        del tables0
        torch.cuda.empty_cache()
    return out


def phase_hot_head_inits(torch, card: str, seeds=(0, 1, 2, 3, 4),
                         check_steps: int = 3) -> dict:
    """Optional (``--phases hot_head_inits``): phase 24's f32 card-vs-CPU
    check of the hot heads at several inits (tables and backbone drawn from
    each seed, the batches phase 24's), each held by the head rule; and
    where the differences come from: the first head step (the dense
    ``[K, D]`` step, ``SparseOptimizer.dense_update``) replayed on the card
    and on the CPU from the CPU run's own inputs (the head, its
    accumulator, positions and gradients): bitwise there means the step's
    sums are not the cause and the heads' differences come in with their
    gradients (the backbone's GEMMs on two devices)."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.ops.sparse import SparseOptimizer

    rng = np.random.default_rng(24)
    host = [criteo_zipf_batch(rng) for _ in range(check_steps)]
    rtol, atol = TOL["trajectory"]
    seen: list = []
    orig = SparseOptimizer.dense_update

    def record(self, table, slots, ids, grads, **kw):
        if table.device.type == "cpu" and not seen:
            seen.append((self, table.clone(), [x.clone() for x in slots],
                         ids.clone(), grads.clone(), kw))
        return orig(self, table, slots, ids, grads, **kw)

    out = {}
    for seed in seeds:
        coll, tables0, backbone0 = _hot_cold_setup(torch, torch.float32, seed)
        seen.clear()
        SparseOptimizer.dense_update = record
        try:
            lg, lc, rows = _hot_cold_card_vs_cpu(torch, coll, tables0, backbone0,
                                                 host, torch.float32)
        finally:
            SparseOptimizer.dense_update = orig
        heads = [(g, c, b) for a, (g, c, _, b) in rows.items() if a.endswith("__hot")]
        g, c, b = (torch.cat(x) for x in zip(*heads))
        diff = (g - c).abs()
        far = diff > atol + rtol * c.abs()
        # the head step replayed on the card and the CPU from the same inputs
        opt, table, slots, ids, grads, kw = seen[0]
        replay = {}
        for device in ("cuda", "cpu"):
            t, sl = table.to(device, copy=True), [x.to(device, copy=True) for x in slots]
            opt.dense_update(t, sl, ids.to(device), grads.to(device), **kw)
            replay[device] = torch.cat([t.cpu(), *(x.cpu().reshape(t.shape[0], -1)
                                                   for x in sl)], dim=1)
        step_diff = float((replay["cuda"] - replay["cpu"]).abs().max())
        rule = _check_heads(torch, f"seed {seed}: {len(heads)} heads", g, c, b, rtol,
                            atol, 2 * LR * check_steps)
        out[seed] = {"beyond": int(far.sum()), "elements": g.numel(),
                     "share": float(far.double().mean()), "max_diff": float(diff.max()),
                     "head_step_bitwise": step_diff == 0.0, "head_step_max_diff": step_diff}
        say(f"hot_head_inits: seed {seed}: losses {lg} vs {lc}; {rule}; the first "
            f"head step replayed from the CPU's inputs: card vs CPU "
            f"{'bitwise' if step_diff == 0.0 else f'max |diff| {step_diff:.3e}'}")
        del tables0
        torch.cuda.empty_cache()
    say(f"hot_head_inits: {json.dumps(out)}; on {card}")
    return out


def phase_criteo_int8_cli(torch) -> dict:
    """Phase 25: the journey ``synth-criteo -> preprocess-criteo -> train``
    with a copy of ``configs/dlrm-criteo.toml`` (``data_dir``, ``n_epochs =
    1``, batches of 256, ``checkpoint_dir``, ``checkpoint_every_n_steps``
    and ``[embeddings]`` ``table_dtype = "int8"``, ``cache_rows``,
    ``flush_every``, ``hot_vocab`` set): the ETL writes ``hot_ids.json``;
    the train process is SIGKILLed once a mid-epoch save (inside a flush
    interval) is committed and run again, which must resume mid-epoch and
    log an eval AUC in [0, 1]; then a run under an edited ``hot_ids.json``
    must refuse to restore, in the reference's words."""
    import os
    import signal

    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_criteo

    src = (ROOT / "configs" / "dlrm-criteo.toml").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck = tmp / "ckpt"
        body = []
        for line in src.splitlines():
            if line.startswith("data_dir ="):
                line = f'data_dir = "{tmp / "data"}"'
            elif line.startswith("n_epochs ="):
                line = "n_epochs = 1"
            elif line.startswith("per_device_"):
                line = line.split("=")[0] + "= 256"
            elif line.startswith("[mesh]"):
                body += [f'checkpoint_dir = "{ck}"',
                         f"checkpoint_every_n_steps = {CLI_CKPT_EVERY}"]
            body.append(line)
        body += ["[embeddings]", 'table_dtype = "int8"', "cache_rows = 131072",
                 f"flush_every = {CLI_FLUSH_EVERY}", f"hot_vocab = {CLI_HOT_VOCAB}"]
        cfg = tmp / "dlrm-criteo.toml"
        cfg.write_text("\n".join(body) + "\n")
        t0 = time.perf_counter()
        write_synthetic_criteo(tmp / "data", n_rows=CLI_ROWS)
        if launch.main(["preprocess-criteo", "--config", str(cfg)]) != 0:
            raise AssertionError("launch preprocess-criteo failed")
        etl_s = time.perf_counter() - t0
        art = json.loads((tmp / "data" / "hot_ids.json").read_text())
        cmd = [sys.executable, "-m", "tdfo_tpu_torch.launch", "train", "--config",
               str(cfg)]
        log1 = tmp / "train1.log"
        with open(log1, "w") as f:
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        mid = None
        deadline = time.monotonic() + 600
        try:
            while mid is None and proc.poll() is None and time.monotonic() < deadline:
                for p in sorted(ck.glob("cursor_*.json")) if ck.exists() else []:
                    if not (ck / p.stem.split("_", 1)[1] / "state.pt").is_file():
                        continue
                    try:
                        c = json.loads(p.read_text())
                    except (OSError, ValueError):
                        continue
                    if not c.get("epoch_complete"):
                        mid = c
                        break
                time.sleep(0.005)
            if proc.poll() is not None:
                raise AssertionError(
                    f"the train run ended (rc {proc.returncode}) before a "
                    f"mid-epoch checkpoint could be killed; log:\n{log1.read_text()[-3000:]}")
            if mid is None:
                raise AssertionError("no mid-epoch cursor within 600 s")
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        from tdfo_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(ck)
        latest = mgr.read_cursor(mgr.latest_step())
        if latest is None or latest.get("epoch_complete"):
            raise AssertionError(f"the killed run's newest checkpoint is not "
                                 f"mid-epoch: {latest}")
        if latest["step"] % CLI_FLUSH_EVERY == 0:
            raise AssertionError(f"the save at step {latest['step']} is not inside "
                                 "a flush interval")
        stamps = json.loads((ck / f"stamps_{mgr.latest_step()}.json").read_text())
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"the resumed train run failed:\n{res.stdout[-3000:]}"
                                 f"\n{res.stderr[-3000:]}")
        recs = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
        # an edited hot set must refuse to restore
        edited = dict(art)
        edited["tables"] = dict(art["tables"])
        edited["tables"]["cat_0"] = art["tables"]["cat_0"][:-1]
        (tmp / "data" / "hot_ids.json").write_text(json.dumps(edited))
        bad = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
    resumed = [r for r in recs if "resumed_mid_epoch" in r]
    aucs = [r["auc"] for r in recs if "auc" in r]
    steps = [r["steps"] for r in recs if "train_loss_epoch" in r]
    if not resumed or not aucs or not 0.0 <= aucs[-1] <= 1.0:
        raise AssertionError(f"metrics.jsonl lacks resumed_mid_epoch or an eval "
                             f"AUC: {recs}")
    refusal = "under a different hot-id set — so resuming is refused"
    if bad.returncode == 0 or refusal not in bad.stderr:
        raise AssertionError(f"the run under an edited hot_ids.json did not refuse "
                             f"(rc {bad.returncode}):\n{bad.stderr[-3000:]}")
    say(f"criteo_int8_cli: configs/dlrm-criteo.toml + int8, cache_rows 131072, "
        f"flush_every {CLI_FLUSH_EVERY}, hot_vocab {CLI_HOT_VOCAB} on the card: "
        f"synthetic {CLI_ROWS} rows + preprocess-criteo {etl_s:.1f} s wrote "
        f"hot_ids.json ({len(art['tables'])} tables, {sum(map(len, art['tables'].values()))} "
        f"hot ids); stamps {sorted(stamps)}; SIGKILL after the mid-epoch save at "
        f"step {mid['step']} (newest checkpoint step {latest['step']}, inside a "
        f"flush interval); the restart resumed at step {resumed[0]['step']} and "
        f"finished the epoch ({steps[-1]} steps), eval auc {aucs[-1]:.4f}; an "
        f"edited hot_ids.json refused: rc {bad.returncode}")
    return {"resumed_at": resumed[0]["step"], "auc": aucs[-1]}


# ------------------------------------------------------------ phases 26-28
# bench.py::bench_serving / bench_serve_seq (bench.py:1166-1405)
SERVE_BUCKETS = (256, 1024, 8192)
SERVE_TOP_K, SERVE_COARSE_K = 100, 1000
SERVE_TRAIN_STEPS = 3          # the DMP state the bundle is exported from
SERVE_REQUESTS = 64            # the ragged trace (launch serve's count)
SERVE_MAX_ROWS = 3000          # largest request of the ragged trace
SERVE_CHECK_QUERIES = 256      # queries held against retrieval_reference
SERVE_OVERLAP_FLOOR = 0.95     # int8 two-stage vs the exact scan of its corpus
SEQ_SERVE = dict(n_items=200_000, max_len=64, embed_dim=64, n_heads=2, n_layers=2)
SEQ_CANDS = 101                # 1 positive + 100 negatives
SEQ_CHECK_ROWS, SEQ_EVAL_ROWS = 256, 16
SEQ_PEAK_CAP_GB = 20.0         # the [B, T, V] cube alone would be 420 GB
SERVE_CLI_USERS = 2_000        # a few train steps of config.toml's batch
SERVE_CLI_COARSE_K = 150       # two-stage over the synthetic 300-item catalogue


def all_launches() -> dict:
    """Every kernel wrapper's launch count."""
    return {**flash_counts(), **dlrm_counts()}


def _event_ms(torch, fn, n=10, warm=2) -> float:
    """Median CUDA-event time of ``fn`` (after ``warm`` calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def _check_retrieval(torch, what, got, ref, k) -> str:
    """The comparison rule against ``retrieval_reference`` (``ref``: its
    scores and ids of the top ``k + 1``): scores within rtol 1e-5, ids
    exactly at every rank whose score is separated from both neighbours by
    more than rtol 1e-5.  Raises on a mismatch."""
    gs, gi = got[0].float().cpu().numpy(), got[1].cpu().numpy()
    rs, ri = ref[0].float().cpu().numpy(), ref[1].cpu().numpy()
    np.testing.assert_allclose(gs, rs[:, :k], rtol=1e-5, atol=1e-6, err_msg=what)
    checked = 0
    for b in range(gs.shape[0]):
        s = rs[b]
        for r in range(k):
            tol = 1e-5 * abs(s[r])
            if (r == 0 or s[r - 1] - s[r] > tol) and s[r] - s[r + 1] > tol:
                if gi[b, r] != ri[b, r]:
                    raise AssertionError(f"{what}: query {b} rank {r}: id {gi[b, r]}"
                                         f" != reference {ri[b, r]}")
                checked += 1
    err = float(np.abs(gs - rs[:, :k]).max())
    return (f"{checked} of {gs.size} ranks separated and equal, scores max_abs_err "
            f"{err:.3e}")


def _overlap(torch, a, b) -> float:
    """Mean share of ``b``'s ids per row that ``a`` also returned."""
    return float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())


def _ragged_trace(torch, scorer, make, rng, what) -> dict:
    """``SERVE_REQUESTS`` requests of 1..``SERVE_MAX_ROWS`` rows through the
    micro-batcher (deadline 0: each ships as its own padded batch); the
    scorer must have run at most ``len(SERVE_BUCKETS)`` batch shapes."""
    from tdfo_tpu_torch.serve.frontend import MicroBatcher

    reqs = [(f"r{i}", make(rng, int(n)))
            for i, n in enumerate(rng.integers(1, SERVE_MAX_ROWS + 1, SERVE_REQUESTS))]
    mb = MicroBatcher(scorer.score, buckets=SERVE_BUCKETS, max_batch=SERVE_BUCKETS[-1],
                      batch_deadline_ms=0.0, program_cache_size=scorer.score_cache_size)
    t0 = time.perf_counter()
    res = mb.run(reqs)
    wall = time.perf_counter() - t0
    stats = mb.stats()
    padded = sorted({p for _, p in mb.shipped})
    if (stats["requests"] != SERVE_REQUESTS or scorer.score_cache_size() > len(SERVE_BUCKETS)
            or any(r is None or not np.isfinite(r).all() for r in res.values())):
        raise AssertionError(f"{what}: ragged trace {stats}, programs "
                             f"{scorer.score_cache_size()}")
    say(f"{what}: ragged trace of {SERVE_REQUESTS} requests (1-{SERVE_MAX_ROWS} rows) "
        f"-> {stats['batches']} batches padded to {padded}, programs "
        f"{scorer.score_cache_size()} (<= {len(SERVE_BUCKETS)}), p50 "
        f"{stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms, "
        f"{SERVE_REQUESTS / wall:.1f} requests/s (host clock)")
    return stats


def _retrieval_round(torch, what, corpus, corpus8, q, *, n_check=SERVE_CHECK_QUERIES):
    """Exact top-k over ``corpus`` and int8 two-stage over ``corpus8`` for
    the queries ``q``: CUDA-event times (queries/s), the checks against
    ``retrieval_reference`` on the card, and the two-stage overlap."""
    from tdfo_tpu_torch.serve.retrieval import make_retrieval, retrieval_reference

    exact = make_retrieval(corpus, top_k=SERVE_TOP_K)
    two = make_retrieval(corpus8, top_k=SERVE_TOP_K, coarse_k=SERVE_COARSE_K)
    ms_e = _event_ms(torch, lambda: exact(q), n=5, warm=1)
    ms_t = _event_ms(torch, lambda: two(q), n=5, warm=1)
    got_e, got_t = exact(q), two(q)
    k = SERVE_TOP_K
    ref = retrieval_reference(q[:n_check], corpus, top_k=k + 1)
    line_e = _check_retrieval(torch, f"{what} exact", (got_e[0][:n_check], got_e[1][:n_check]),
                              ref, k)
    exact8 = make_retrieval(corpus8, top_k=k)(q)
    _check_retrieval(torch, f"{what} int8 exact", (exact8[0][:n_check],
                     exact8[1][:n_check]), retrieval_reference(
                         q[:n_check], corpus8, top_k=k + 1), k)
    ov8 = _overlap(torch, got_t[1], exact8[1])
    ov = _overlap(torch, got_t[1], got_e[1])
    same = got_t[1][:, :, None] == exact8[1][:, None, :]
    s_t = got_t[0][:, :, None].expand_as(same)[same]
    s_8 = exact8[0][:, None, :].expand_as(same)[same]
    torch.testing.assert_close(s_t, s_8, rtol=1e-5, atol=1e-6)
    if ov8 < SERVE_OVERLAP_FLOOR:
        raise AssertionError(f"{what}: int8 two-stage keeps {ov8:.4f} of its corpus' "
                             f"exact top-{k} (floor {SERVE_OVERLAP_FLOOR})")
    nq = q.shape[0]
    b32 = corpus.vectors.numel() * corpus.vectors.element_size()
    b8 = (corpus8.vectors.numel() * corpus8.vectors.element_size()
          + corpus8.qscale.numel() * 4)
    say(f"{what}: exact top-{k} over {corpus.n_items} items x {nq} queries "
        f"{ms_e:.3f} ms ({nq / ms_e * 1e3:.1f} queries/s, CUDA events); vs "
        f"retrieval_reference on {n_check} queries: {line_e}")
    say(f"{what}: int8 two-stage (coarse_k {SERVE_COARSE_K}) {ms_t:.3f} ms "
        f"({nq / ms_t * 1e3:.1f} queries/s); overlap with the f32 exact top-{k} "
        f"{ov:.4f}, with the int8 corpus' exact top-{k} {ov8:.4f} (re-ranked "
        f"scores equal within rtol 1e-5); corpus bytes f32 {b32} vs int8 + "
        f"sidecar {b8} ({b32 / b8:.2f}x)")
    return {"exact_ms": ms_e, "two_stage_ms": ms_t, "overlap": ov,
            "overlap_int8": ov8, "bytes_f32": b32, "bytes_int8": b8}


def phase_serve_main(torch, card: str) -> dict:
    """Phase 26: TwoTower serving at ``bench.py::bench_serving``'s width."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.serve import (
        build_corpus,
        export_bundle,
        load_bundle,
        make_scorer,
        synthetic_item_features,
    )
    from tdfo_tpu_torch.serve.corpus import store_corpus
    from tdfo_tpu_torch.train.ctr import make_ctr_sparse_eval_step

    rtol, atol = TOL["logits"]
    coll0 = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    tables0 = coll0.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    coll, state, step = build_main_path(torch, "cuda", tables0, backbone0)
    del tables0
    rng = np.random.default_rng(26)
    for _ in range(SERVE_TRAIN_STEPS):
        state, _ = step(state, to_device(torch, make_host_batch(rng, BATCH), "cuda"))
    torch.cuda.synchronize()
    before = all_launches()
    torch.cuda.reset_peak_memory_stats()
    cats = ("user_id", "item_id", "language", "is_ebook", "format", "publisher",
            "pub_decade")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = export_bundle(Path(tmp) / "bundle", model="twotower", embed_dim=DIM,
                            cat_columns=cats, cont_columns=("avg_rating", "num_pages"),
                            size_map=SIZE_MAP, step=SERVE_TRAIN_STEPS, coll=coll,
                            tables=state.tables, dense_params=state.backbone)
        export_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in out.iterdir())
        t0 = time.perf_counter()
        bundle = load_bundle(out, verify=True)
        load_s = time.perf_counter() - t0
    scorer = make_scorer(bundle, device="cuda")
    host = make_host_batch(rng, BATCH)
    label = host.pop("label")
    got = scorer.score(host)
    torch.cuda.synchronize()
    cpu = make_scorer(bundle, device="cpu").score(host)
    torch.testing.assert_close(got.cpu(), cpu, rtol=rtol, atol=atol)
    err_cpu = float((got.cpu() - cpu).abs().max())
    _, ev = make_ctr_sparse_eval_step(coll, state.backbone)(
        state, to_device(torch, dict(host, label=label), "cuda"))
    torch.testing.assert_close(got, ev, rtol=rtol, atol=atol)
    err_ev = float((got - ev).abs().max())
    say(f"serve_main: bundle of {SERVE_TRAIN_STEPS} DMP steps (SIZE_MAP, d = {DIM}, "
        f"adam/AdamW {LR}): {nbytes} bytes, export {export_s:.2f} s, load + verify "
        f"{load_s:.2f} s, digest {bundle.digest}; B = {BATCH} logits: card vs CPU "
        f"max_abs_err {err_cpu:.3e}, served vs the eval step {err_ev:.3e} "
        f"(bitwise: {bool(torch.equal(got, ev))}; rtol {rtol})")
    del state, ev
    times = {}
    for b in SERVE_BUCKETS:
        dev = to_device(torch, {k: v for k, v in make_host_batch(rng, b).items()
                                if k != "label"}, "cuda")
        times[b] = _event_ms(torch, lambda: scorer.score(dev))
    say("serve_main: score ms per batch (CUDA events, median of 10): "
        + ", ".join(f"B={b} {ms:.4f}" for b, ms in times.items()) + f" on {card}")

    def make(r, n):
        h = make_host_batch(r, n)
        h.pop("label")
        return h

    stats = _ragged_trace(torch, make_scorer(bundle, device="cuda"), make, rng, "serve_main")
    t0 = time.perf_counter()
    corpus = build_corpus(scorer, synthetic_item_features(SIZE_MAP, SIZE_MAP["item"], seed=0),
                          corpus_batch=8192)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    corpus8 = store_corpus(corpus.vectors, corpus.ids, corpus.n_items, "int8")
    q = scorer.user_embed({"user_id": rng.integers(0, SIZE_MAP["user"], BATCH,
                                                   dtype=np.int32)})
    say(f"serve_main: corpus of {corpus.n_items} items built in {build_s:.2f} s "
        f"(corpus_batch 8192)")
    r = _retrieval_round(torch, "serve_main", corpus, corpus8, q)
    launched = {k: v - before[k] for k, v in all_launches().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(launched.values()):
        raise AssertionError(f"serve_main: kernels launched while serving: {launched}")
    say(f"serve_main: kernel launches while serving {launched}; peak memory "
        f"{peak:.2f} GB")
    return {"score_ms": times, "peak_gb": peak, "stats": stats, **r}


def _seq_panels(rng, n, n_items, max_len):
    from tdfo_tpu_torch.serve.seq_scoring import history_window

    lens = rng.integers(1, 2 * max_len, n)
    seqs = np.stack([history_window(rng.integers(1, n_items + 1, int(m)),
                                    n_items=n_items, max_len=max_len) for m in lens])
    return {"seqs": seqs,
            "cands": rng.integers(1, n_items + 1, (n, SEQ_CANDS)).astype(np.int32)}


def phase_serve_seq_main(torch, card: str) -> dict:
    """Phase 27: Bert4Rec serving at ``bench.py::bench_serve_seq``'s width."""
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.models.bert4rec import (
        Bert4RecConfig,
        key_padding_mask,
        make_sharded_bert4rec,
    )
    from tdfo_tpu_torch.serve import export_bundle, load_bundle, make_scorer
    from tdfo_tpu_torch.serve.seq_scoring import item_corpus
    from tdfo_tpu_torch.train.seq import score_candidates

    rtol, atol = TOL["logits"]
    cfg = Bert4RecConfig(**SEQ_SERVE)
    n, t = cfg.n_items, cfg.max_len
    coll, tables, backbone = make_sharded_bert4rec(cfg, seed=0, fused_threshold=None,
                                                   device="cuda")
    backbone.eval()
    before = all_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = export_bundle(Path(tmp) / "bundle", model="bert4rec",
                            embed_dim=cfg.embed_dim, cat_columns=(), cont_columns=(),
                            size_map={"n_items": n}, coll=coll, tables=tables,
                            dense_params=backbone,
                            seq={"max_len": t, "n_heads": cfg.n_heads,
                                 "n_layers": cfg.n_layers})
        export_s = time.perf_counter() - t0
        bundle = load_bundle(out, verify=True)
    scorer = make_scorer(bundle, device="cuda")
    rng = np.random.default_rng(27)
    panel = _seq_panels(rng, BATCH, n, t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = scorer.score(panel)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(got.shape) != (BATCH, SEQ_CANDS) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"serve_seq_main: scores {tuple(got.shape)}")
    if peak > SEQ_PEAK_CAP_GB:
        raise AssertionError(f"serve_seq_main: peak {peak:.2f} GB scoring B = {BATCH} "
                             f"(cap {SEQ_PEAK_CAP_GB} GB)")
    rows = {k: v[:SEQ_CHECK_ROWS] for k, v in panel.items()}
    cpu = make_scorer(bundle, device="cpu").score(rows)
    # two transformer layers round near-zero logits past the ladder's atol
    # (ROADMAP.md Queue C), so the absolute floor is rtol x the largest logit
    atol = rtol * float(cpu.abs().max())
    torch.testing.assert_close(got[:SEQ_CHECK_ROWS].cpu(), cpu, rtol=rtol, atol=atol)
    err_cpu = float((got[:SEQ_CHECK_ROWS].cpu() - cpu).abs().max())
    ids = torch.from_numpy(panel["seqs"][:SEQ_EVAL_ROWS]).cuda()
    with torch.no_grad():
        embs = coll.lookup(tables, {"item": ids})
        ev = score_candidates(backbone(embs["item"], key_padding_mask(ids)),
                              torch.from_numpy(panel["cands"][:SEQ_EVAL_ROWS]).cuda())
    sub = got[:SEQ_EVAL_ROWS]
    torch.testing.assert_close(sub, ev, rtol=rtol, atol=atol)
    say(f"serve_seq_main: Bert4Rec {SEQ_SERVE} bundle export {export_s:.2f} s; "
        f"B = {BATCH} x {SEQ_CANDS} candidates at the MASK position, peak memory "
        f"{peak:.2f} GB (cap {SEQ_PEAK_CAP_GB}; a [B, T, V] cube is "
        f"{BATCH * t * (n + 2) * 4 / 1e9:.0f} GB); card vs CPU on "
        f"{SEQ_CHECK_ROWS} rows max_abs_err {err_cpu:.3e}; served vs the eval "
        f"forward on {SEQ_EVAL_ROWS} rows {float((sub - ev).abs().max()):.3e} "
        f"(bitwise: {bool(torch.equal(sub, ev))}; rtol {rtol}, atol rtol x the "
        f"largest |logit| = {atol:.3e})")
    del ev, embs
    times = {}
    for b in SERVE_BUCKETS:
        dev = {k: torch.from_numpy(v[:b]).cuda() for k, v in panel.items()}
        times[b] = _event_ms(torch, lambda: scorer.score(dev), n=5)
    say("serve_seq_main: score ms per batch (CUDA events, median of 5): "
        + ", ".join(f"B={b} {ms:.4f}" for b, ms in times.items()) + f" on {card}")
    stats = _ragged_trace(torch, make_scorer(bundle, device="cuda"),
                          lambda r, m: _seq_panels(r, m, n, t), rng, "serve_seq_main")
    corpus = item_corpus(bundle, device="cuda")
    corpus8 = item_corpus(bundle, device="cuda", dtype="int8")
    q = scorer.query_embed({"seqs": panel["seqs"]})
    r = _retrieval_round(torch, "serve_seq_main", corpus, corpus8, q)
    launched = {k: v - before[k] for k, v in all_launches().items()}
    if any(launched.values()):
        raise AssertionError(f"serve_seq_main: kernels launched while serving: {launched}")
    say(f"serve_seq_main: kernel launches while serving {launched}")
    return {"score_ms": times, "peak_gb": peak, "stats": stats, **r}


def _serve_cmd(cfg: Path) -> dict:
    """``python -m tdfo_tpu_torch.launch serve`` (the card is the default):
    its printed stats dict."""
    import ast

    res = subprocess.run([sys.executable, "-m", "tdfo_tpu_torch.launch", "serve",
                          "--config", str(cfg)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"launch serve failed (rc {res.returncode}):\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    family = [x for x in res.stdout.splitlines() if x.startswith("serve: model")]
    stats = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    stats["family"] = family[0] if family else None
    return stats


def phase_serve_cli(torch) -> dict:
    """Phase 28: ``synth -> preprocess -> train`` (with ``checkpoint_dir``)
    then ``python -m tdfo_tpu_torch.launch serve`` on the card, which
    restores the trained step: the quickstart ``config.toml`` (the dense
    regime), the same with ``[serving] coarse_k`` (int8 two-stage
    retrieval), and ``configs/bert4rec.toml``."""
    import math

    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_goodreads(tmp / "data", n_users=SERVE_CLI_USERS)
        runs = []
        for name, src, extra in (("quickstart", "config.toml", ""),
                                 ("bert4rec", "configs/bert4rec.toml", "")):
            text = (ROOT / src).read_text()
            for old in ('data_dir = "data/goodreads"', "n_epochs ="):
                if old not in text:
                    raise AssertionError(f"{src} no longer has the line {old!r}")
            lines = [f'data_dir = "{tmp / "data"}"' if x.startswith("data_dir =")
                     else "n_epochs = 1" if x.startswith("n_epochs =") else x
                     for x in text.splitlines()]
            ck = tmp / f"ck_{name}"
            cfg = tmp / f"{name}.toml"
            cfg.write_text("\n".join(lines) + f'\ncheckpoint_dir = "{ck}"\n')
            etl = "preprocess-seq" if name == "bert4rec" else "preprocess-ctr"
            if launch.main([etl, "--config", str(cfg)]) != 0:
                raise AssertionError(f"launch {etl} failed")
            launch.run(["train", "--config", str(cfg), "--device", "cuda"])
            runs.append((name, cfg, ck))
            if name == "quickstart":
                two = tmp / "quickstart_coarse.toml"
                two.write_text(cfg.read_text()
                               + f"[serving]\ncoarse_k = {SERVE_CLI_COARSE_K}\n")
                runs.append(("quickstart_coarse_k", two, ck))
        for name, cfg, ck in runs:
            trained = CheckpointManager(ck).latest_step()
            stats = _serve_cmd(cfg)
            ok = (stats["requests"] == 64 and stats.get("retrieved") == 100
                  and stats["step"] == trained and trained
                  and all(math.isfinite(stats[k]) for k in ("p50_ms", "p99_ms", "qps")))
            if not ok:
                raise AssertionError(f"serve_cli {name}: {stats} (trained step {trained})")
            say(f"serve_cli {name}: {stats['family']}; restored step {stats['step']}; "
                f"requests {stats['requests']} in {stats['batches']} batches, "
                f"programs {stats['programs']}, p50 {stats['p50_ms']:.3f} ms, p99 "
                f"{stats['p99_ms']:.3f} ms, qps {stats['qps']:.1f}, retrieved "
                f"{stats['retrieved']}")
            out[name] = stats
    return out


# ------------------------------------------------------------------ fleet
# ROADMAP item 15b at phase 26's widths (bench.py::bench_serving: d = 64,
# buckets 256 / 1024 / 8192): the bundle store and its delta swaps, an
# in-process ServingFleet of 2 replicas, and a ProcessFleet of 2 replica
# processes on the card (one replica per card on a machine with several).
FLEET_BASE_STEPS, FLEET_DELTA_STEPS = 3, 2  # the base bundle, then the delta
FLEET_REPLICAS = 2
FLEET_REQUESTS = 256           # the process fleet's trace
FLEET_KILL_AT = 128            # the SIGKILL lands after this many submits
FLEET_MAX_ROWS = 256           # largest request of the fleet traces
FLEET_PROBE = 16               # requests of the bitwise probe
# deadline 0: each request ships as its own padded batch on the next poll,
# so a request meets the same bucket (the same GEMM shape) on every replica
# whatever the host's timing; a deadline makes the batches' make-up, and so
# the bucket, depend on the clock
FLEET_SERVING = {"replicas": FLEET_REPLICAS, "buckets": list(SERVE_BUCKETS),
                 "max_batch": 1024, "batch_deadline_ms": 0.0}
FLEET_CATS = ("user_id", "item_id", "language", "is_ebook", "format",
              "publisher", "pub_decade")
FLEET_CONTS = ("avg_rating", "num_pages")


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _used_gb(torch, dev: str):
    """The card's used memory (every process's), GB; None on the CPU."""
    if not dev.startswith("cuda"):
        return None
    free, total = torch.cuda.mem_get_info(torch.device(dev))
    return (total - free) / 2**30


def _pid_gb(pids) -> dict:
    """``nvidia-smi``'s used memory per replica pid, GB ("not visible" when
    the tool lists no such process)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return {k: "not visible" for k in pids}
    used = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            used[int(parts[0])] = int(parts[1]) / 1024
    return {k: (round(used[p], 3) if p in used else "not visible")
            for k, p in pids.items()}


def _replica_logs(workdir: Path) -> None:
    """Print the tail of every replica process's log under ``workdir``."""
    for log in sorted(Path(workdir).rglob("replica-*.log")):
        say(f"--- {log.name} (tail) ---\n{log.read_text()[-3000:]}")


def _fleet_trace(rng, n, tag):
    """``n`` ragged requests (1..FLEET_MAX_ROWS rows) of phase 3's columns."""
    out = []
    for i in range(n):
        h = make_host_batch(rng, int(rng.integers(1, FLEET_MAX_ROWS + 1)))
        h.pop("label")
        out.append((f"{tag}{i}", h))
    return out


def _held_serving(what, got, want) -> float:
    """The serving rule: every request answered in ``want`` has scores
    within rtol 1e-5 of it; returns the max abs difference."""
    err = 0.0
    for rid, g in got.items():
        w = want[rid]
        if g is None or w is None:
            raise AssertionError(f"{what}: request {rid} unanswered")
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {rid}")
        err = max(err, float(np.abs(np.asarray(g) - np.asarray(w)).max()))
    return err


def phase_fleet(torch, card: str, dev: str = "cuda") -> dict:
    """Phase 34: the serving tier (``serve/{swap,fleet,wire,ingress,
    supervisor,replica_main}.py``) on the card.  (a) a base bundle of
    ``FLEET_BASE_STEPS`` DMP steps ingested into a ``BundleStore``; a delta
    of ``FLEET_DELTA_STEPS`` more (``export_delta`` with the steps' ids as
    the touched hint), composed, published under CANARY and promoted; the
    composed bundle equals a full export of the new state bitwise; one
    delta corrupted in memory (``corrupt_delta_nth``) is quarantined and
    the store stays on its version.  (b) an in-process ``ServingFleet`` of
    2 replicas follows CURRENT and CANARY; ``probe_each`` is bitwise across
    replicas; ``run`` equals one ``MicroBatcher`` by the serving rule.
    (c) a ``ProcessFleet`` of 2 replica processes on the card takes
    ``FLEET_REQUESTS`` requests through the ingress with one replica
    SIGKILLed mid-trace (``kill_replica_signal``); the respawned replica
    follows the same version; every answered score equals the in-process
    fleet's, shed and failed requests counted.  (d) with several cards,
    one replica per card."""
    import shutil

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.obs import trace as _trace
    from tdfo_tpu_torch.obs.aggregate import percentile
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.serve import (
        BundleStore,
        MicroBatcher,
        ServingFleet,
        export_bundle,
        export_delta,
        load_bundle,
        make_scorer,
    )
    from tdfo_tpu_torch.serve.export import read_raw_bundle, touched_rows
    from tdfo_tpu_torch.serve.supervisor import ProcessFleet
    from tdfo_tpu_torch.serve.swap import SwapController
    from tdfo_tpu_torch.utils import faults

    def sync():
        if dev.startswith("cuda"):
            torch.cuda.synchronize()

    coll0 = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
    tables0 = coll0.init(0, device="cpu")
    backbone0 = TwoTowerBackbone(DIM, generator=torch.Generator().manual_seed(1))
    coll, state, step = build_main_path(torch, dev, tables0, backbone0)
    del tables0
    n_fat = sum(1 for v in state.tables.values() if v.dim() == 3)
    rng = np.random.default_rng(31)
    kl.fat_line_update.launches = 0
    segment_sum.launches = 0
    n_steps = 0

    def train(n):
        nonlocal state, n_steps
        hosts = [make_host_batch(rng, BATCH) for _ in range(n)]
        for h in hosts:
            state, loss = step(state, to_device(torch, h, dev))
            if not np.isfinite(float(loss)):
                raise AssertionError(f"fleet: non-finite loss {float(loss)}")
        sync()
        n_steps += n
        return hosts

    exp = dict(model="twotower", embed_dim=DIM, cat_columns=FLEET_CATS,
               cont_columns=FLEET_CONTS, size_map=SIZE_MAP)

    def bundle_of(out, version, **kw):
        return export_bundle(out, step=n_steps, version=version, coll=coll,
                             tables=state.tables, dense_params=state.backbone,
                             **exp, **kw)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        # ---- (a) the store and its deltas
        train(FLEET_BASE_STEPS)
        bundle_of(tmp / "base", 0)
        store = BundleStore(tmp / "store")
        if store.ingest_full(tmp / "base") != 0:
            raise AssertionError("fleet: the base did not ingest as v0")
        hosts = train(FLEET_DELTA_STEPS)
        hint = touched_rows(coll, batches=[{c: h[c] for c in FLEET_CATS}
                                           for h in hosts])
        t0 = time.perf_counter()
        d1 = export_delta(tmp / "chain" / "v000001", tmp / "base", step=n_steps,
                          coll=coll, tables=state.tables,
                          dense_params=state.backbone, touched=hint, **exp)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = bundle_of(tmp / "full1", 1)
        full_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        composed = store.compose_delta(d1)
        apply_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.publish_canary(d1, composed)
        if store.promote_canary() != 1:
            raise AssertionError("fleet: the canary did not promote to v1")
        swap_s = time.perf_counter() - t0
        fm, fa = read_raw_bundle(full)
        cm, ca = read_raw_bundle(store.current_dir())
        if cm["digest"] != fm["digest"] or sorted(ca) != sorted(fa) or any(
                not np.array_equal(ca[k], fa[k]) for k in fa):
            raise AssertionError(f"fleet: composed v1 {cm['digest']} != the "
                                 f"full export {fm['digest']}")
        dm = json.loads((d1 / "bundle.json").read_text())
        d_bytes, f_bytes = _dir_bytes(d1), _dir_bytes(full)
        say(f"fleet (a): delta v1 of {FLEET_DELTA_STEPS} steps over a base of "
            f"{FLEET_BASE_STEPS}: rows {dm['tables_delta']}, dense arrays "
            f"replaced {len(dm['replaced'])}; {d_bytes} bytes vs a full "
            f"export's {f_bytes} ({d_bytes / f_bytes:.4f}); export_delta "
            f"{export_s * 1e3:.1f} ms (host: tables to the host, byte diff, "
            f"digests), full export {full_s * 1e3:.1f} ms, compose (apply) "
            f"{apply_s * 1e3:.1f} ms, publish_canary + promote (swap) "
            f"{swap_s * 1e3:.1f} ms; composed digest {cm['digest']} == the "
            f"full export's, arrays bitwise")
        # one delta corrupted in memory at its read: quarantined, v1 stays
        train(1)
        d2 = export_delta(tmp / "chain" / "v000002", store.current_dir(),
                          step=n_steps, coll=coll, tables=state.tables,
                          dense_params=state.backbone, **exp)
        faults.configure(faults.FaultSpec(corrupt_delta_nth=1))
        try:
            ctl = SwapController(
                store, lambda d: make_scorer(load_bundle(d, verify=True),
                                             device=dev).score)
            swapped = ctl.apply(d2)
        finally:
            faults.configure(None)
        if swapped or store.current_version() != 1 or len(store.quarantined()) != 1:
            raise AssertionError(
                f"fleet: corrupt delta swapped={swapped}, version "
                f"{store.current_version()}, quarantined {store.quarantined()}")
        say(f"fleet (a): corrupt delta v2 (corrupt_delta_nth = 1) quarantined: "
            f"{store.quarantined()[0]['error'][:90]}...; the store stays on v1")
        fat_n, seg_n = kl.fat_line_update.launches, segment_sum.launches
        if fat_n != n_fat * n_steps or seg_n <= 0:
            raise AssertionError(f"fleet: fat_line_update {fat_n} launches in "
                                 f"{n_steps} steps, segment_sum {seg_n}")
        del state
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()

        # ---- (b) the in-process fleet: CURRENT and CANARY
        cfg = read_configs(None, model="twotower", embed_dim=DIM,
                           model_parallel=True, size_map=SIZE_MAP,
                           serving=FLEET_SERVING)
        store.publish_canary(d2)  # the same bytes, read clean: pending v2
        flt = ServingFleet(store, cfg, device=dev)
        follow = flt.sync()
        if follow != {0: 2, 1: 1}:
            raise AssertionError(f"fleet (b): canary member / stable {follow}")
        store.promote_canary()
        follow2 = flt.sync()
        if follow2 != {0: 2, 1: 2}:
            raise AssertionError(f"fleet (b): after promotion {follow2}")
        probe = _fleet_trace(rng, FLEET_PROBE, "p")
        each = flt.probe_each(probe)
        for rid, v in each[0].items():
            if not np.array_equal(v, each[1][rid]):
                raise AssertionError(
                    f"fleet (b): probe {rid} ({v.shape[0]} rows) differs across "
                    f"replicas by {float(np.abs(v - each[1][rid]).max()):.3e}")
        trace = _fleet_trace(rng, FLEET_REQUESTS, "q")
        t0 = time.perf_counter()
        res = flt.run(trace)  # the batchers' results hold the probe's too
        in_s = time.perf_counter() - t0
        in_proc = {rid: res[rid] for rid, _ in trace}
        one = make_scorer(load_bundle(store.current_dir(), verify=True), device=dev)
        mb = MicroBatcher(one.score, buckets=SERVE_BUCKETS,
                          max_batch=FLEET_SERVING["max_batch"],
                          batch_deadline_ms=FLEET_SERVING["batch_deadline_ms"])
        single = mb.run(trace)
        err_b = _held_serving("fleet (b) run vs one MicroBatcher", in_proc, single)
        hb = flt.heartbeat({c: v[:256] for c, v in make_host_batch(rng, 256).items()
                            if c != "label"},
                           rng.integers(0, 2, 256).astype(np.float32))
        say(f"fleet (b): {FLEET_REPLICAS} in-process replicas: canary member "
            f"followed CANARY v2 while the other served v1 ({follow}), both v2 "
            f"after promotion; probe_each bitwise across replicas "
            f"({FLEET_PROBE} requests); run of {FLEET_REQUESTS} requests "
            f"({in_s:.2f} s host) vs one MicroBatcher max_abs_err {err_b:.3e} "
            f"(rtol 1e-5); heartbeat ms "
            f"{[round(r['ms'], 3) for r in hb]}")
        probe_in = each[0]
        flt.close()
        del flt, one, mb

        # ---- (c) the process fleet on the card, one replica SIGKILLed
        faults.configure(faults.FaultSpec(kill_replica_signal=1))
        mem0 = _used_gb(torch, dev)
        t0 = time.perf_counter()
        pf = ProcessFleet(store, cfg, workdir=tmp / "pf", device=dev)
        try:
            pf.sync()
            ing = pf.ingress
            ing.submit("cold", trace[0][1])
            while "cold" not in ing.completed:
                ing.poll(0.5)
            cold_s = time.perf_counter() - t0
            pids0 = {k: pf.supervisor.pid(k) for k in range(FLEET_REPLICAS)}
            mem_up, pid_gb = _used_gb(torch, dev), _pid_gb(pids0)
            sent, routed = set(), {}
            for rid, batch in trace[:FLEET_KILL_AT]:
                routed[rid] = ing.submit(rid, batch)
                sent.add(rid)
                ing.poll(0.0)
            pf.mark_canary_watch()  # SIGKILL replica 0 (kill_replica_signal)
            mem_killed = _used_gb(torch, dev)
            for rid, batch in trace[FLEET_KILL_AT:]:
                routed[rid] = ing.submit(rid, batch)
                sent.add(rid)
                ing.poll(0.0)
            t1 = time.perf_counter()
            versions = pf.sync()  # respawns replica 0, which re-follows
            respawn_s = time.perf_counter() - t1
            for k in pf.alive_ids():
                ing.rpc(k, {"type": "drain"})
            while ing.inflight():
                if ing.poll(1.0) == 0:
                    break
            mem_after = _used_gb(torch, dev)
            pids1 = {k: pf.supervisor.pid(k) for k in range(FLEET_REPLICAS)}
            pid_gb1 = _pid_gb(pids1)
            if pf.supervisor.respawns[0] != 1 or versions != {0: 2, 1: 2}:
                raise AssertionError(f"fleet (c): respawns "
                                     f"{pf.supervisor.respawns}, versions {versions}")
            got = {rid: ing.completed.get(rid) for rid in sent}
            answered = {r: v for r, v in got.items() if v is not None}
            lost = len(sent) - len(answered)
            if lost != ing.sheds + ing.failures or not answered:
                raise AssertionError(f"fleet (c): {lost} unanswered but sheds "
                                     f"{ing.sheds} + failures {ing.failures}")
            err_c = _held_serving("fleet (c) process vs in-process",
                                  answered, in_proc)
            probe_pf = pf.probe_each(probe)
            bitwise_x = all(np.array_equal(probe_pf[k][r], probe_in[r])
                            for k in probe_pf for r in probe_in)
            for k in probe_pf:
                _held_serving(f"fleet (c) probe replica {k}", probe_pf[k], probe_in)
                if any(not np.array_equal(probe_pf[k][r], probe_pf[0][r])
                       for r in probe_in):
                    raise AssertionError(f"fleet (c): probe replica {k} differs "
                                         "from replica 0")
            lat_kill = list(ing.latencies_ms)
            by_replica = [sum(1 for r in answered if routed[r] == k)
                          for k in range(FLEET_REPLICAS)]
            # the same trace again on the healed fleet: the timed pass
            n_lat = len(ing.latencies_ms)
            t0 = time.perf_counter()
            res2 = pf.run([(f"c{rid}", b) for rid, b in trace])
            wall = time.perf_counter() - t0
            lat = ing.latencies_ms[n_lat:]
            again = {rid: res2[f"c{rid}"] for rid, _ in trace}
            if any(v is None for v in again.values()):
                raise AssertionError("fleet (c): the healed fleet left requests "
                                     "unanswered")
            _held_serving("fleet (c) healed pass vs in-process", again, in_proc)
        except BaseException:
            _replica_logs(tmp / "pf")  # a replica that failed names itself
            raise
        finally:
            pf.close()
            faults.configure(None)
        mem_closed = _used_gb(torch, dev)
        p50, p99 = percentile(lat, 50), percentile(lat, 99)
        qps = len(trace) / wall
        fmt = (lambda x: "n/a" if x is None else f"{x:.3f}")  # noqa: E731
        say(f"fleet (c): {FLEET_REPLICAS} replica processes on {dev}: cold start "
            f"(spawn to the first answered score) {cold_s:.2f} s; respawn after "
            f"the SIGKILL to synced {respawn_s:.2f} s, following v2 like the "
            f"survivor; {len(answered)} of {len(sent)} requests answered, "
            f"{ing.sheds} shed, {ing.failures} failed (in flight on the killed "
            f"replica), every answer == the in-process fleet's (max_abs_err "
            f"{err_c:.3e}, rtol 1e-5), probe bitwise across processes, "
            f"bitwise the in-process probe: {bitwise_x}; over that trace (the "
            f"respawn's wait included) p50 {percentile(lat_kill, 50):.3f} ms, p99 "
            f"{percentile(lat_kill, 99):.3f} ms; the trace again on the healed "
            f"fleet, every answer == the in-process fleet's: p50 {p50:.3f} ms, "
            f"p99 {p99:.3f} ms, {qps:.1f} queries/s (host clock, submit to "
            f"reply)")
        per = (None if mem0 is None else
               [(mem_up - mem0) / FLEET_REPLICAS, mem_up - mem_killed,
                mem_after - mem_killed])
        say(f"fleet (c): card used GB: before spawning {fmt(mem0)}, replicas "
            f"up {fmt(mem_up)}, after the SIGKILL {fmt(mem_killed)}, after the "
            f"respawn {fmt(mem_after)}, after close {fmt(mem_closed)}; per "
            f"replica: the mean of the first spawn, the killed one's (freed by "
            f"the kill), the respawned one's "
            f"{'n/a' if per is None else [round(x, 3) for x in per]}; nvidia-smi "
            f"used_memory by pid before {pid_gb}, after the respawn {pid_gb1}; "
            f"answers by replica {by_replica} (the respawned replica 0 answered "
            f"the probe)")
        out = {"fat_launches": fat_n, "segment_sum_launches": seg_n,
               "steps": n_steps, "delta_bytes": d_bytes, "full_bytes": f_bytes,
               "export_ms": export_s * 1e3, "apply_ms": apply_s * 1e3,
               "swap_ms": swap_s * 1e3, "cold_s": cold_s, "respawn_s": respawn_s,
               "p50_ms": p50, "p99_ms": p99, "qps": qps,
               "mem_gb": [mem0, mem_up, mem_killed, mem_after, mem_closed],
               "replica_gb": per, "pid_gb": [pid_gb, pid_gb1]}

        # ---- (d) one replica per card
        n_cards = torch.cuda.device_count() if dev.startswith("cuda") else 1
        if n_cards > 1:
            import dataclasses

            cfg4 = cfg.replace(serving=dataclasses.replace(cfg.serving,
                                                           replicas=n_cards))
            t0 = time.perf_counter()
            pf = ProcessFleet(store, cfg4, workdir=tmp / "pf4",
                              device=[f"cuda:{k}" for k in range(n_cards)])
            try:
                pf.sync()
                up_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                res = pf.run(trace)
                wall4 = time.perf_counter() - t0
                lat4 = list(pf.ingress.latencies_ms)
                err_d = _held_serving("fleet (d) one replica per card",
                                      {r: v for r, v in res.items()}, in_proc)
            except BaseException:
                _replica_logs(tmp / "pf4")
                raise
            finally:
                pf.close()
            say(f"fleet (d): {n_cards} replicas, one per card: up in {up_s:.2f} s; "
                f"{len(res)} requests answered == the in-process fleet (max_abs_err "
                f"{err_d:.3e}); p50 {percentile(lat4, 50):.3f} ms, p99 "
                f"{percentile(lat4, 99):.3f} ms, {len(res) / wall4:.1f} queries/s")
            out["cards"] = n_cards
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fleet_toml(tmp: Path, name: str, extra: str = "") -> Path:
    """The quickstart ``config.toml`` (TwoTower) on a synthetic catalogue,
    with ``[serving] replicas = 2``."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    write_synthetic_goodreads(tmp / "data", n_users=SERVE_CLI_USERS)
    text = (ROOT / "config.toml").read_text()
    if 'data_dir = "data/goodreads"' not in text:
        raise AssertionError("config.toml no longer has its data_dir line")
    lines = [f'data_dir = "{tmp / "data"}"' if x.startswith("data_dir =") else x
             for x in text.splitlines()]
    cfg = tmp / f"{name}.toml"
    cfg.write_text("\n".join(lines) + "\n[serving]\nreplicas = 2\n" + extra)
    if launch.main(["preprocess-ctr", "--config", str(cfg)]) != 0:
        raise AssertionError("launch preprocess-ctr failed")
    return cfg


def _launch_out(argv, timeout=600) -> str:
    res = subprocess.run([sys.executable, "-m", "tdfo_tpu_torch.launch", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"launch {argv[0]} failed (rc {res.returncode}):\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def phase_serve_fleet_cli(torch) -> dict:
    """Phase 35: ``python -m tdfo_tpu_torch.launch serve-fleet`` on the card
    (its replica processes too): the quickstart toml with ``[serving]
    replicas = 2``, a fresh init; 64 requests, every one answered."""
    import ast
    import math

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = _fleet_toml(tmp, "serve_fleet")
        t0 = time.perf_counter()
        out = _launch_out(["serve-fleet", "--config", str(cfg),
                           "--log-dir", str(tmp / "logs")])
        wall = time.perf_counter() - t0
    stats = ast.literal_eval(out.strip().splitlines()[-1])
    if not (stats["requests"] == stats["answered"] == 64 and stats["replicas"] == 2
            and stats["failed"] == 0
            and all(math.isfinite(stats[k]) for k in ("p50_ms", "p99_ms", "qps"))):
        raise AssertionError(f"serve_fleet_cli: {stats}")
    say(f"serve_fleet_cli: launch serve-fleet in {wall:.1f} s: {stats['answered']} "
        f"of {stats['requests']} answered by {stats['replicas']} replica "
        f"processes, shed {stats['shed']}, p50 {stats['p50_ms']:.3f} ms, p99 "
        f"{stats['p99_ms']:.3f} ms, qps {stats['qps']:.1f}")
    return stats


def phase_loadgen_cli(torch) -> dict:
    """Phase 36: ``python -m tdfo_tpu_torch.launch loadgen --knee-steps 2`` on
    the card: closed loop, zipf ids, concurrency 1 then 2, every request
    completed."""
    import re

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = _fleet_toml(tmp, "loadgen", "[loadgen]\nrequests = 64\n"
                          "p99_slo_ms = 1000.0\n")
        t0 = time.perf_counter()
        out = _launch_out(["loadgen", "--config", str(cfg), "--knee-steps", "2",
                           "--log-dir", str(tmp / "logs")])
        wall = time.perf_counter() - t0
    steps = [x for x in out.splitlines() if x.startswith("loadgen closed")]
    knee = [x for x in out.splitlines() if x.startswith("knee:")]
    if (len(steps) != 2 or not knee or any("failed=0" not in x for x in steps)
            or not all(re.search(r"conc=\d+", x) for x in steps)):
        raise AssertionError(f"loadgen_cli:\n{out[-3000:]}")
    say(f"loadgen_cli: launch loadgen in {wall:.1f} s: " + "; ".join(steps)
        + f"; {knee[0]}")
    return {"steps": steps, "knee": knee[0]}

# ------------------------------------------------------------- dist_dense
# ROADMAP item 12b's dense half: phase 17's dense TwoTower over ranks.
# Each run: (backend, world, (data, model), arms).  "graph": eager steps
# through the distributed code, then CUDA-graph replays
# (steps_per_execution DIST_DENSE_SPE) over the same batches; "ps": the PS
# partition (ps_min_shard_bytes DIST_DENSE_PS_BYTES), eager; "graph_ps":
# both; "refuse": CUDA-graph steps under gloo refuse, naming NCCL.
DIST_DENSE_RUNS = (
    ("nccl", 1, (1, 1), ("graph",)),
    ("gloo", 2, (1, 2), ("ps", "refuse")),
)
DIST_DENSE_SPE = 2
DIST_DENSE_PS_BYTES = 256 * 1024  # TF MinSizePartitioner's default


@functools.lru_cache(maxsize=None)
def _dense_model0(torch):
    """``dense_initial``'s model, drawn once a process (runs take copies)."""
    return dense_initial(torch)


def _dense_run(torch, dist, mesh, host, graph: bool, ps: bool, timed: bool):
    """``steps`` dense steps on this rank's slice of each host batch from
    ``dense_initial``: eager, or as CUDA-graph replays of
    ``DIST_DENSE_SPE``-step chunks; the model PS-partitioned when ``ps``.
    Returns ``(losses [n] on the CPU, whole state dict (the PS blocks
    all-gathered), host ms a step over the last chunks or steps, collective
    ms and calls a step, peak GB)``."""
    from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_group, data_slice
    from tdfo_tpu_torch.parallel.collectives import all_gather_cat
    from tdfo_tpu_torch.parallel.sharding import (
        min_size_partitioner_rule,
        ps_shard_module_,
    )
    from tdfo_tpu_torch.train.state import TrainState
    from tdfo_tpu_torch.train.step import (
        CudaGraphStep,
        make_multi_step,
        make_train_step,
    )

    model = copy.deepcopy(_dense_model0(torch)).cuda()
    plan = {}
    if ps:
        plan = ps_shard_module_(model, mesh,
                                min_size_partitioner_rule(mesh, DIST_DENSE_PS_BYTES))
    state = TrainState.create(model=model, learning_rate=LR, weight_decay=WD,
                              capturable=True)
    inner = make_train_step(mesh=mesh)
    rows = data_slice(mesh, BATCH) if mesh is not None else slice(None)
    dev = [{k: v[rows] for k, v in to_device(torch, h, "cuda").items()} for h in host]
    k = DIST_DENSE_SPE if graph else 1
    units = [{n: torch.stack([b[n] for b in dev[i:i + k]]) for n in dev[0]}
             for i in range(0, len(dev), k)] if graph else dev
    run = make_multi_step(CudaGraphStep(inner)) if graph else inner
    warm = (DIST_STEPS + k - 1) // k  # the compared steps (graph: the capture)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for u in units[:warm]:
        state, loss = run(state, u)
        losses.append(loss.reshape(-1))

    def rest():
        nonlocal state
        for u in units[warm:]:
            state, loss = run(state, u)
            losses.append(loss.reshape(-1))

    if timed:
        _, ms, coll_ms, calls = _time_steps(torch, dist, rest)
    else:
        rest()
        ms, coll_ms, calls = 0.0, {}, {}
    n_timed = len(host) - warm * k
    sd = state.state_dict()
    for i, (name, p) in enumerate(model.named_parameters()):
        spec = plan.get(name, ())
        if MODEL_AXIS in spec:  # the whole leaf and its moments
            group, dim = axis_group(mesh, MODEL_AXIS), spec.index(MODEL_AXIS)
            sd["params"][name] = all_gather_cat(p.detach(), group, dim=dim)
            sd["optimizer"][i] = {m: (all_gather_cat(v, group, dim=dim) if v.dim() else v)
                                  for m, v in sd["optimizer"][i].items()}
    return (torch.cat(losses).cpu(), sd, ms / n_timed,
            {n: v / n_timed for n, v in coll_ms.items()},
            {n: v / n_timed for n, v in calls.items()},
            torch.cuda.max_memory_allocated() / 1e9)


def _dense_params_held(torch, what, got, want, steps) -> str:
    """Every parameter of a split-batch run against the single-device run's
    (``b4r_main``'s rule over the whole model): within rtol 1e-4 but for at
    most 0.1% of the elements, each within 2 lr a step (Adam's sign on
    gradients inside the f32 noise of two summation orders)."""
    from tdfo_tpu_torch.interop import TOL

    rtol, atol = TOL["trajectory"]
    n = n_out = 0
    worst = big = 0.0
    for k, c in want.items():
        diff = (got[k] - c).abs()
        out = diff > atol + rtol * c.abs()
        n, n_out = n + c.numel(), n_out + int(out.sum())
        big = max(big, float(diff.max()))
        if bool(out.any()):
            worst = max(worst, float(diff[out].max()))
    bound = 2 * LR * steps
    if n_out > 1e-3 * n or worst > bound:
        raise AssertionError(f"{what}: {n_out} of {n} parameter elements outside "
                             f"rtol {rtol} (max |diff| {worst}, bound {bound})")
    return (f"every parameter within rtol {rtol} of one device (max |diff| "
            f"{big:.3e}; {n_out} of {n} elements outside, each within {bound:.1e})")


def _dense_arm(torch, dist, mesh, arm, host, ref) -> dict:
    """One dense arm on this rank (``DIST_DENSE_RUNS``), held to ``ref``, the
    single-device run (eager: losses and state)."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_size
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.train.step import CudaGraphStep, make_train_step
    from tdfo_tpu_torch.train.trainer import refuse_unported

    if arm == "refuse":  # CUDA-graph steps under gloo: refused by name
        cfg = read_configs(None, model="twotower", model_parallel=False,
                           steps_per_execution=DIST_DENSE_SPE, size_map=SIZE_MAP)
        said = []
        for fn in (lambda: CudaGraphStep(make_train_step(mesh=mesh)),
                   lambda: refuse_unported(cfg, device="cuda")):
            try:
                fn()
            except ValueError as e:
                if "need NCCL" not in str(e):
                    raise
                said.append(str(e))
            else:
                raise AssertionError("dist_dense: CUDA-graph steps under "
                                     f"{dist.get_backend()} did not refuse")
        return {"refused": said[0]}
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum

    ps = arm in ("ps", "graph_ps")
    segment_sum.launches = 0  # the embedding grads' sums, counted over the run
    ls_e, sd_e, ms_e, coll_e, calls_e, peak_e = _dense_run(
        torch, dist, mesh, host, False, ps, True)
    if not segment_sum.launches:
        raise AssertionError(f"dist_dense {arm}: segment_sum launched no time")
    rec = {"eager_ms": ms_e, "collective_ms": coll_e, "collective_calls": calls_e,
           "peak_gb": peak_e, "segment_sum_launches": segment_sum.launches}
    one = axis_size(mesh, DATA_AXIS) == 1  # every rank steps the whole batch
    if one:
        d = state_diff(torch, sd_e, ref[1])
        if d != 0.0 or not torch.equal(ls_e, ref[0]):
            raise AssertionError(f"dist_dense {arm}: not bitwise one device "
                                 f"(state max diff {d})")
        rec["held"] = "bitwise one device"
    else:
        rtol, atol = TOL["trajectory"]
        torch.testing.assert_close(ls_e, ref[0], rtol=rtol, atol=atol)
        rec["held"] = "losses and " + _dense_params_held(
            torch, f"dist_dense {arm}", sd_e["params"], ref[1]["params"], len(host))
    del sd_e
    torch.cuda.empty_cache()
    if arm.startswith("graph"):
        ls_g, sd_g, ms_g, _, _, peak_g = _dense_run(torch, dist, mesh, host, True,
                                                    ps, True)
        if not torch.equal(ls_g, ls_e):
            raise AssertionError(f"dist_dense {arm}: graph losses {ls_g.tolist()} "
                                 f"vs eager {ls_e.tolist()}")
        again = _dense_run(torch, dist, mesh, host, False, ps, False)[1]
        d = state_diff(torch, sd_g, again)
        if d != 0.0:
            raise AssertionError(f"dist_dense {arm}: graph state vs eager: {d}")
        rec.update(graph_ms=ms_g, graph_peak_gb=peak_g,
                   graph_held="replays bitwise the eager steps")
        if one:
            rec["graph_held"] += " and one device"
        del sd_g, again
        torch.cuda.empty_cache()
    return rec


def dist_rank_dense(spec: dict) -> int:
    """One rank of ``dist_dense`` (``DIST_DENSE_RUNS``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tdfo_tpu_torch.core.config import MeshSpec
    from tdfo_tpu_torch.core.mesh import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed("cuda", backend=spec["backend"], force=True)
    mesh = make_mesh(MeshSpec(data=spec["mesh"][0], model=spec["mesh"][1], seq=1),
                     "cuda")
    rng = np.random.default_rng(21)
    host = [make_host_batch(rng, BATCH) for _ in range(DIST_STEPS + DIST_TIMED)]
    # the single-device run on the whole batches (eager, then the graph:
    # at world 1 the distributed runs must be its bits)
    ref = _dense_run(torch, dist, None, host, False, False, False)[:2]
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(), "arms": {}}
    if dist.get_world_size() == 1:
        ls_g, sd_g = _dense_run(torch, dist, None, host, True, False, False)[:2]
        if not torch.equal(ls_g, ref[0]) or state_diff(torch, sd_g, ref[1]) != 0.0:
            raise AssertionError("dist_dense: the one-process graph is not "
                                 "bitwise its eager steps")
        del sd_g
    for arm in spec["dense_arms"]:
        rec = _dense_arm(torch, dist, mesh, arm, host, ref)
        res["arms"][arm] = rec
        print(f"dist dense {arm} world {dist.get_world_size()} ({dist.get_backend()}, "
              f"mesh {spec['mesh']}) rank {dist.get_rank()}: "
              f"{ {k: (round(v, 4) if isinstance(v, float) else v) for k, v in rec.items()} }",
              flush=True)
    (Path(spec["out"]) / f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_dist_dense(torch, card: str) -> dict:
    """dist_dense: the dense TwoTower at ``build_train_bench``'s width over
    ranks (``DIST_DENSE_RUNS``; NCCL at world = the card count where there
    are several: data n and, on four or more, data n/2 x model 2 with the
    PS partition, graph replays bitwise their eager steps and within rtol
    1e-4 of one device)."""
    runs = list(DIST_DENSE_RUNS)
    n = torch.cuda.device_count()
    if n >= 2:
        runs.append(("nccl", n, (n, 1), ("graph",)))
    if n >= 4 and n % 2 == 0:
        runs.append(("nccl", n, (n // 2, 2), ("graph_ps",)))
    out = {}
    t0 = time.perf_counter()
    for backend, world, (d, m), arms in runs:
        key = f"{backend}_{world}_{d}x{m}"
        ranks = _spawn_ranks(world, {"backend": backend, "mesh": [d, m],
                                     "dense_arms": list(arms)},
                             f"dense world {world} {backend} mesh {d}x{m}",
                             timeout=DIST_CTR_TIMEOUT_S)
        for arm in arms:
            a = [r["arms"][arm] for r in ranks]
            out[f"{key}/{arm}"] = a
            if arm == "refuse":
                say(f"dist_dense: {key} CUDA-graph steps refused: {a[0]['refused']}")
                continue
            say(f"dist_dense: {key} {arm}: {a[0]['held']}"
                f"{'; ' + a[0]['graph_held'] if 'graph_held' in a[0] else ''}; "
                f"segment_sum launches per rank in {DIST_STEPS + DIST_TIMED} eager "
                f"steps {[x['segment_sum_launches'] for x in a]}; "
                f"eager step_ms {[round(x['eager_ms'], 3) for x in a]}"
                + (f", graph replay step_ms {[round(x['graph_ms'], 3) for x in a]}"
                   if "graph_ms" in a[0] else "")
                + f", collective ms a step "
                f"{[{k: round(v, 4) for k, v in x['collective_ms'].items()} for x in a]}"
                f" (calls {[x['collective_calls'] for x in a]}), peak GB per rank "
                f"{[round(x['peak_gb'], 2) for x in a]}; on {card}")
    say(f"dist_dense: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------- dist_serve
# ROADMAP item 12b's serving half: phases 26-27's widths over ranks, the
# corpus sharded over the data axis.  (backend, world, data).
DIST_SERVE_RUNS = (("nccl", 1, 1), ("gloo", 2, 2))
# queries held to the one-device retrieval at each end of the batch (in
# the first and the last query chunks)
DIST_SERVE_CHECK = 256
# the launch serve stats that do not depend on the host's clock
SERVE_STABLE = ("requests", "batches", "shed", "swaps", "programs", "step",
                "retrieved")


def _sharded_round(torch, what, make_one, make_mesh_corpus, q, mesh) -> dict:
    """Exact and int8 two-stage top-k over the corpus sharded on ``mesh``
    against the one-device programs on the same rows (ids at every
    separated rank, scores rtol 1e-5): times (CUDA events) and build s."""
    from tdfo_tpu_torch.serve.corpus import store_corpus
    from tdfo_tpu_torch.serve.retrieval import make_retrieval

    k = SERVE_TOP_K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = make_mesh_corpus()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    corpus8 = store_corpus(corpus.vectors, corpus.ids, corpus.n_items, "int8",
                           shard=corpus.shard, n_shards=corpus.n_shards)
    one = make_one()
    one8 = store_corpus(one.vectors, one.ids, one.n_items, "int8")
    rec = {"build_s": build_s, "n_items": corpus.n_items,
           "rows_per_shard": corpus.rows_per_shard}
    c, b = DIST_SERVE_CHECK, q.shape[0]
    held = torch.cat([torch.arange(c), torch.arange(b - c, b)]).to(q.device)
    for name, cp, op, coarse in (("exact", corpus, one, 0),
                                 ("two_stage", corpus8, one8, SERVE_COARSE_K)):
        run = make_retrieval(cp, mesh=mesh, top_k=k, coarse_k=coarse)
        got = run(q)  # the first call warms up; two timed after it
        ms = _event_ms(torch, lambda: run(q), n=2, warm=0)
        ref = make_retrieval(op, top_k=k + 1, coarse_k=coarse)(q[held])
        if bool((got[1] < 0).any()):
            raise AssertionError(f"{what} {name}: a padding id was returned")
        line = _check_retrieval(torch, f"{what} {name}",
                                (got[0][held], got[1][held]), ref, k)
        rec[name] = {"ms": ms, "qps": q.shape[0] / ms * 1e3, "held": line}
    del corpus, corpus8, one, one8
    torch.cuda.empty_cache()
    return rec


def dist_rank_serve(spec: dict) -> int:
    """One rank of ``dist_serve``: the TwoTower bundle (phase 26's
    collection at a seeded init, written by rank 0) scored on replicated
    parameters, its item-tower corpus (200,000 items) built sharded, and
    the Bert4Rec head corpus of phase 27's bundle, each retrieved with
    ``BATCH`` queries, exact and int8 two-stage."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tdfo_tpu_torch.core.config import MeshSpec
    from tdfo_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from tdfo_tpu_torch.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.serve import (
        build_corpus,
        export_bundle,
        load_bundle,
        make_scorer,
        synthetic_item_features,
    )
    from tdfo_tpu_torch.serve.seq_scoring import item_corpus

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed("cuda", backend=spec["backend"], force=True)
    mesh = make_mesh(MeshSpec(data=spec["mesh"][0], model=1, seq=1), "cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = Path(spec["out"])
    if rank == 0:  # the bundles, written once
        coll = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, DIM, "row"))
        export_bundle(out / "twotower", model="twotower", embed_dim=DIM,
                      cat_columns=("user_id", "item_id", "language", "is_ebook",
                                   "format", "publisher", "pub_decade"),
                      cont_columns=("avg_rating", "num_pages"), size_map=SIZE_MAP,
                      coll=coll, tables=coll.init(0, device="cuda"),
                      dense_params=TwoTowerBackbone(
                          DIM, generator=torch.Generator().manual_seed(1)))
        cfg = Bert4RecConfig(**SEQ_SERVE)
        scoll, stables, sbb = make_sharded_bert4rec(cfg, seed=0, fused_threshold=None,
                                                    device="cuda")
        export_bundle(out / "bert4rec", model="bert4rec", embed_dim=cfg.embed_dim,
                      cat_columns=(), cont_columns=(),
                      size_map={"n_items": cfg.n_items}, coll=scoll, tables=stables,
                      dense_params=sbb, seq={"max_len": cfg.max_len,
                                             "n_heads": cfg.n_heads,
                                             "n_layers": cfg.n_layers})
        del coll, scoll, stables, sbb
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    before = all_launches()
    rng = np.random.default_rng(26)
    bundle = load_bundle(out / "twotower")
    scorer = make_scorer(bundle, mesh=mesh, device="cuda")
    feats = synthetic_item_features(SIZE_MAP, SIZE_MAP["item"], seed=0)
    q = scorer.user_embed({"user_id": rng.integers(0, SIZE_MAP["user"], BATCH,
                                                   dtype=np.int32)})
    res = {"backend": dist.get_backend(), "world": world}
    res["twotower"] = _sharded_round(
        torch, "dist_serve twotower",
        lambda: build_corpus(scorer, feats, corpus_batch=8192),
        lambda: build_corpus(scorer, feats, corpus_batch=8192, mesh=mesh), q, mesh)
    seq = load_bundle(out / "bert4rec")
    sscorer = make_scorer(seq, mesh=mesh, device="cuda")
    sq = sscorer.query_embed(_seq_panels(np.random.default_rng(27), BATCH,
                                         SEQ_SERVE["n_items"], SEQ_SERVE["max_len"]))
    res["bert4rec"] = _sharded_round(
        torch, "dist_serve bert4rec", lambda: item_corpus(seq, device="cuda"),
        lambda: item_corpus(seq, mesh=mesh, device="cuda"), sq, mesh)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launched = {k: v - before[k] for k, v in all_launches().items()}
    if any(launched.values()):  # serving runs no kernel of the port
        raise AssertionError(f"dist_serve: kernels launched while serving: {launched}")
    print(f"dist serve world {world} ({dist.get_backend()}, data {spec['mesh'][0]}) "
          f"rank {rank}: {json.dumps(res)}", flush=True)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_dist_serve(torch, card: str) -> dict:
    """dist_serve: ``DIST_SERVE_RUNS`` (and NCCL at data = the card count
    where there are several), then ``launch serve`` through
    ``torch.distributed.run --nproc-per-node 2 ... --backend gloo`` on a
    quickstart toml at ``[mesh] data = 2`` with int8 two-stage retrieval,
    its clock-free stats held to a one-rank serve of the same toml."""
    import ast
    import io

    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    runs = list(DIST_SERVE_RUNS)
    n = torch.cuda.device_count()
    if n >= 2:
        runs.append(("nccl", n, n))
    out = {}
    t0 = time.perf_counter()
    for backend, world, d in runs:
        key = f"{backend}_{world}"
        ranks = _spawn_ranks(world, {"backend": backend, "mesh": [d, 1],
                                     "serve": True}, f"serve world {world} {backend}",
                             timeout=DIST_CTR_TIMEOUT_S)
        out[key] = ranks
        for model in ("twotower", "bert4rec"):
            a = [r[model] for r in ranks]
            say(f"dist_serve: {key} {model}: corpus of {a[0]['n_items']} items over "
                f"{d} shard(s) of {a[0]['rows_per_shard']} rows, built in "
                f"{[round(x['build_s'], 3) for x in a]} s; exact top-{SERVE_TOP_K} "
                f"{[round(x['exact']['qps'], 1) for x in a]} queries/s "
                f"({[round(x['exact']['ms'], 3) for x in a]} ms for {BATCH}); "
                f"int8 two-stage (coarse_k {SERVE_COARSE_K}) "
                f"{[round(x['two_stage']['qps'], 1) for x in a]} queries/s "
                f"({[round(x['two_stage']['ms'], 3) for x in a]} ms); vs one device: "
                f"exact {a[0]['exact']['held']}; two-stage {a[0]['two_stage']['held']}; "
                f"peak GB per rank {[round(r['peak_gb'], 2) for r in ranks]}; on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_goodreads(tmp / "data", n_users=SERVE_CLI_USERS)
        text = (ROOT / "config.toml").read_text()
        lines = [f'data_dir = "{tmp / "data"}"' if x.startswith("data_dir =") else x
                 for x in text.splitlines()]
        for d in (1, 2):
            (tmp / f"serve{d}.toml").write_text(
                "\n".join(lines) + f"\n[mesh]\ndata = {d}\nmodel = 1\n"
                f"[serving]\ncoarse_k = {SERVE_CLI_COARSE_K}\n")
        cfg = tmp / "serve2.toml"
        if launch.main(["preprocess-ctr", "--config", str(cfg)]) != 0:
            raise AssertionError("launch preprocess-ctr failed")
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
             "--master-port", str(_free_port()), "-m", "tdfo_tpu_torch.launch", "serve",
             "--config", str(cfg), "--backend", "gloo", "--log-dir", str(tmp / "cli2")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"launch serve on 2 ranks failed (rc {res.returncode}):"
                                 f"\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        printed = [x for x in res.stdout.splitlines() if x.startswith("{'requests'")]
        if len(printed) != 1:
            raise AssertionError(f"launch serve on 2 ranks printed {len(printed)} "
                                 f"stats lines (rank 0 alone prints):\n{res.stdout[-3000:]}")
        stats = ast.literal_eval(printed[0])
        if stats["requests"] != 64 or stats.get("retrieved") != 100:
            raise AssertionError(f"launch serve on 2 ranks: {stats}")
        recs = [json.loads(x) for x in
                (tmp / "cli2" / "metrics.jsonl").read_text().splitlines()]
        if sum(r.get("event") == "serve_summary" for r in recs) != 1:
            raise AssertionError("launch serve on 2 ranks: rank 0 alone writes "
                                 "one serve_summary")
        with contextlib.redirect_stdout(io.StringIO()):  # its request log
            one = launch.run(["serve", "--config", str(tmp / "serve1.toml"),
                              "--log-dir", str(tmp / "cli1")])
        if {k: stats[k] for k in SERVE_STABLE} != {k: one[k] for k in SERVE_STABLE}:
            raise AssertionError(f"launch serve: 2 ranks {stats} != 1 rank {one}")
        say(f"dist_serve: launch serve on 2 gloo ranks (data 2, int8 two-stage "
            f"coarse_k {SERVE_CLI_COARSE_K}): {stats['requests']} requests in "
            f"{stats['batches']} batches, programs {stats['programs']}, retrieved "
            f"{stats['retrieved']}, p50 {stats['p50_ms']:.3f} ms, p99 "
            f"{stats['p99_ms']:.3f} ms (rank 0); {SERVE_STABLE} equal to one "
            f"rank's; {time.perf_counter() - t1:.1f} s")
        out["cli"] = stats
    say(f"dist_serve: {time.perf_counter() - t0:.1f} s")
    return out


# ----------------------------------------------------------------- online
# ROADMAP item 16 (the online loop, train/online.py) at the headline
# TwoTower DMP width (SIZE_MAP, d = 64, B = 8192, adam + AdamW lr 3e-4,
# wd 1e-4) and configs/bert4rec.toml's (phase 7's model): request logs
# written by the real RequestLog with rotation on, replayed through the
# loop's own ReplayConsumer, trained, checkpointed, exported, published
# and swapped.
ONLINE_CYCLES = 3              # plain (a) and gated (c) cycles
ONLINE_STEPS = 2               # steps_per_cycle
ONLINE_SEQ_CYCLES = 2          # the seq arm (d)
ONLINE_SEGMENT_BYTES = 1 << 20  # request-log rotation
ONLINE_MAX_ROWS = 256          # rows of the largest logged request
ONLINE_PROBE = 8               # requests of the probe after each swap
ONLINE_KILL_STAGE = 10         # stage call 10: cycle 2's export boundary
# the second bucket: the gated heartbeats score the shadow slice (one
# batch) directly on each replica's scorer, a program of its own
ONLINE_SERVING = {"buckets": [ONLINE_MAX_ROWS, BATCH], "max_batch": ONLINE_MAX_ROWS,
                  "batch_deadline_ms": 0.0,
                  "history_buckets": [ONLINE_MAX_ROWS]}
ONLINE_GATED = {"canary_cycles": 1, "canary_fraction": 0.5,
                "max_auc_regression": 0.3, "shadow_eval_batches": 1}


def _online_ctr_log(root: Path, n_batches: int, seed: int) -> Path:
    """A request log of ``n_batches`` training batches plus a sub-batch
    tail: ragged requests of 1-``ONLINE_MAX_ROWS`` rows over SIZE_MAP's
    vocabularies, labels ``avg_rating > 0.5`` (so the canary skew fault,
    which serves ``-avg_rating``, craters held-out AUC)."""
    from tdfo_tpu_torch.data.replay import RequestLog

    log = RequestLog(root, segment_bytes=ONLINE_SEGMENT_BYTES)
    rng = np.random.default_rng(seed)
    total = 0
    while total < n_batches * BATCH + 7:
        n = int(rng.integers(1, ONLINE_MAX_ROWS + 1))
        h = make_host_batch(rng, n)
        feats = {c: h[c].tolist() for c in FLEET_CATS}
        for c in FLEET_CONTS:
            feats[c] = [round(float(v), 6) for v in h[c]]
        feats["label"] = [int(v > 0.5) for v in feats["avg_rating"]]
        log.append({"event": "serve_request", "request": f"r{total}", "rows": n,
                    "outcome": "ok", "features": feats})
        total += n
    log.close()
    return root


def _online_seq_log(root: Path, n_batches: int, seed: int) -> Path:
    """Eval windows (``history_window``, MASK last) with 1 + 100 candidate
    panels over phase 7's catalogue."""
    from tdfo_tpu_torch.data.replay import RequestLog
    from tdfo_tpu_torch.serve.seq_scoring import history_window

    log = RequestLog(root, segment_bytes=ONLINE_SEGMENT_BYTES)
    rng = np.random.default_rng(seed)
    n_items, t_len = B4R["n_items"], B4R["max_len"]
    total = 0
    while total < n_batches * B4R_BATCH + 3:
        n = int(rng.integers(1, 64))
        seqs = [history_window(rng.integers(1, n_items + 1,
                                            size=int(rng.integers(1, 2 * t_len))),
                               n_items=n_items, max_len=t_len).tolist()
                for _ in range(n)]
        cands = rng.integers(1, n_items + 1, size=(n, 101)).tolist()
        log.append({"event": "serve_request", "request": f"s{total}", "rows": n,
                    "outcome": "ok", "features": {"seqs": seqs, "cands": cands}})
        total += n
    log.close()
    return root


def online_kwargs(ck: Path, log: Path, *, seq: bool = False, **extra) -> dict:
    """``read_configs`` keywords of an online run (JSON-able: the kill
    drill's child reads them back)."""
    kw = dict(checkpoint_dir=str(ck), data_dir=str(ck.parent), n_epochs=1,
              learning_rate=LR, weight_decay=WD, log_every_n_steps=1000,
              serving=dict(ONLINE_SERVING),
              online={"request_log": str(log), "steps_per_cycle": ONLINE_STEPS,
                      "max_cycles": 0})
    if seq:
        kw.update(model="bert4rec", model_parallel=True, size_map={
            "n_items": B4R["n_items"]}, max_len=B4R["max_len"],
            embed_dim=B4R["embed_dim"], n_heads=B4R["n_heads"],
            n_layers=B4R["n_layers"], dropout=B4R["dropout"], attn="flash",
            per_device_train_batch_size=B4R_BATCH, seed=B4R_SEED)
    else:
        kw.update(model="twotower", model_parallel=True, size_map=dict(SIZE_MAP),
                  embed_dim=DIM, sparse_optimizer="adam",
                  per_device_train_batch_size=BATCH)
    for k, v in extra.items():
        kw[k] = {**kw[k], **v} if isinstance(kw.get(k), dict) else v
    return kw


def _seed_checkpoints(torch, kw: dict, dirs) -> object:
    """The initial state (the config's seeded init, on the CPU) written as
    the step-0 checkpoint under each of ``dirs``, so every lineage starts
    from it; returns the CPU trainer holding it."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager
    from tdfo_tpu_torch.train.trainer import Trainer

    tr = Trainer(read_configs(None, **dict(kw, checkpoint_dir="", online={})),
                 device="cpu")
    for d in dirs:
        mgr = CheckpointManager(d)
        mgr.save(0, tr.state, force=True, cursor=None, stamps=tr._ckpt_stamps)
        mgr.close()
    return tr


def _ctr_probe(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(ONLINE_PROBE):
        h = make_host_batch(rng, int(rng.integers(1, ONLINE_MAX_ROWS + 1)))
        out.append((f"probe{i}", {c: h[c] for c in (*FLEET_CATS, *FLEET_CONTS)}))
    return out


def _seq_probe(seed: int) -> list:
    from tdfo_tpu_torch.serve.seq_scoring import history_window

    rng = np.random.default_rng(seed)
    out = []
    for i in range(ONLINE_PROBE):
        n = int(rng.integers(1, 32))
        seqs = np.stack([history_window(
            rng.integers(1, B4R["n_items"] + 1, size=int(rng.integers(1, 40))),
            n_items=B4R["n_items"], max_len=B4R["max_len"]) for _ in range(n)])
        out.append((f"probe{i}", {"seqs": seqs, "cands": rng.integers(
            1, B4R["n_items"] + 1, size=(n, 101)).astype(np.int32)}))
    return out


def _copy_trace(trace):
    return [(rid, {k: np.array(v) for k, v in b.items()}) for rid, b in trace]


def _probe_against_fresh(loop, trace, what: str) -> None:
    """The live serving side's answers to ``trace`` against a fresh scorer
    on the store's current bundle behind a fresh MicroBatcher: bitwise."""
    from tdfo_tpu_torch.serve import MicroBatcher, load_bundle, make_scorer

    spec = loop.config.serving
    got = loop.probe(_copy_trace(trace))
    sc = make_scorer(load_bundle(loop.store.current_dir()), device=loop.trainer.device)
    buckets = (spec.history_buckets or spec.buckets) if loop.model_kind == "seq" \
        else spec.buckets
    want = MicroBatcher(sc.score, buckets=buckets, max_batch=spec.max_batch,
                        batch_deadline_ms=spec.batch_deadline_ms).run(_copy_trace(trace))
    for rid, _ in trace:
        if not np.array_equal(np.asarray(got[rid]), np.asarray(want[rid])):
            raise AssertionError(f"online {what}: probe {rid} differs from a fresh "
                                 "scorer on the current bundle")


def _fat_kernel_vs_plain(torch, tr, batch) -> tuple[float, int]:
    """The loop's next step twice from one snapshot: through
    ``fat_line_update`` and with the plain version in its place (the
    sparse ops' call site patched).  Touched lines within rtol 1e-6 /
    atol 1e-7, every untouched line bitwise unchanged in both.  The state
    is put back; returns (max abs error, touched lines)."""
    from tdfo_tpu_torch.ops import sparse as sp
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl

    fats = [n for n, t in tr.state.tables.items() if t.dim() == 3]
    snap = tr.state.snapshot()
    before = {n: tr.state.tables[n].clone() for n in fats}

    def one(fn):
        old = sp.fat_line_update
        sp.fat_line_update = fn
        try:
            tr.state, loss = tr._one_step(tr.state, batch)
        finally:
            sp.fat_line_update = old
        out = {n: tr.state.tables[n].clone() for n in fats}
        tr.state.restore(snap)
        return out

    def plain(fat, ulines, g, touched, corr, **kw):
        return kl.fat_line_update_plain(fat, ulines, g, touched, corr, **kw)

    kern, ref = one(kl.fat_line_update), one(plain)
    worst, n_touched = 0.0, 0
    for n in fats:
        moved = (ref[n] != before[n]).flatten(1).any(1)
        if not torch.equal(kern[n][~moved], before[n][~moved]):
            raise AssertionError(f"online (a): the kernel changed untouched lines of {n}")
        k, r = kern[n][moved].double(), ref[n][moved].double()
        err = (k - r).abs()
        if bool((err > 1e-7 + 1e-6 * r.abs()).any()):
            raise AssertionError(f"online (a): {n} kernel vs plain max err "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        n_touched += int(moved.sum())
    return worst, n_touched


def _profiled_ops(torch, tr, batch, strip: bool) -> int:
    """Operator calls ``torch.profiler`` records over one step of ``tr``
    from a snapshot (the state is put back); ``strip``: every counter
    emit site a no-op (a build with no telemetry code)."""
    from torch.profiler import ProfilerActivity, profile

    from tdfo_tpu_torch.obs import counters as C

    acts = [ProfilerActivity.CPU]
    if tr.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    snap = tr.state.snapshot()
    old = C.emit, C.enabled
    if strip:
        C.emit, C.enabled = (lambda name, value: None), (lambda: False)
    try:
        with profile(activities=acts) as prof:
            tr.state, loss = tr._one_step(tr.state, batch)
            float(loss)
    finally:
        C.emit, C.enabled = old
        tr.state.restore(snap)
    return sum(e.count for e in prof.key_averages())


def _graph_counters(torch, dev: str) -> dict:
    """``[telemetry] counters`` under ``CudaGraphStep``: the dense TwoTower
    (phase 17's regime at SIZE_MAP, d = 64) with ``steps_per_execution =
    2`` replays a graph whose outputs hold the counters; after each chunk
    they equal an eager counters-on trainer's of the same steps, bitwise,
    and move from chunk to chunk (rewritten by each replay)."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.train.step import CudaGraphStep
    from tdfo_tpu_torch.train.trainer import Trainer

    kw = dict(model="twotower", model_parallel=False, size_map=dict(SIZE_MAP),
              embed_dim=DIM, learning_rate=LR, weight_decay=WD,
              per_device_train_batch_size=BATCH, telemetry={"counters": True})
    graph = Trainer(read_configs(None, steps_per_execution=2, **kw), device=dev)
    eager = Trainer(read_configs(None, **kw), device=dev)
    eager.state.load_state_dict(graph.state.state_dict())
    if dev.startswith("cuda") and not isinstance(graph.train_step, CudaGraphStep):
        raise AssertionError("online (e): the dense step is not a CUDA graph")
    rng = np.random.default_rng(61)
    seen = []
    for chunk in range(3):
        hosts = [make_host_batch(rng, BATCH) for _ in range(2)]
        stack = {k: torch.from_numpy(np.stack([h[k] for h in hosts])).to(dev)
                 for k in hosts[0]}
        graph._train_auc = eager._train_auc = None
        graph.state, _ = graph._multi_step(graph.state, stack)
        for h in hosts:
            eager.state, _ = eager._one_step(eager.state, to_device(torch, h, dev))
        g = {k: float(v) for k, v in graph._step_ctrs.items()}
        e = {k: float(v) for k, v in eager._step_ctrs.items()}
        if g != e or not {"grad_norm", "param_norm", "nonfinite_logits"} <= set(g):
            raise AssertionError(f"online (e): chunk {chunk} graph counters {g} "
                                 f"!= eager {e}")
        seen.append(g["grad_norm"])
    if len(set(seen)) != len(seen):
        raise AssertionError(f"online (e): the replayed counters did not move: {seen}")
    return {"grad_norm": seen}


def _stage_line(ms: dict) -> str:
    return ", ".join(f"{k} {v:.1f}" for k, v in ms.items())


def phase_online(torch, dev: str = "cuda") -> dict:
    """The online phase (ROADMAP item 16): (a) the plain loop, 3 cycles of
    2 steps on one MicroBatcher at the headline TwoTower width: after each
    cycle the card's tables against the port's CPU training of the same
    replayed batches (rtol 1e-4, atol 1e-6), the served probe against a
    fresh scorer on the swapped bundle bitwise; before cycle 1 its first
    step through ``fat_line_update`` against the same step with the plain
    version in its place.  (b) the kill drill: a child process killed by
    ``kill_between_stages`` at cycle 2's export boundary and restarted
    with the same command ends on (a)'s bundle digest, replay cursor and
    probe logits bitwise.  (c) the gated loop, 3 cycles over a 2-replica
    ServingFleet with ``regress_auc_at_cycle = 2``: verdicts promote,
    rollback, promote; ``rejections.json``; both replicas back bitwise on
    the last good version.  (d) the seq family: Bert4Rec at phase 7's
    width with flash attention, 2 plain cycles.  (e) counters off the
    path (profiler op counts) and as CUDA-graph outputs.  Launches of
    ``fat_line_update`` and ``segment_sum`` are counted over (a)'s
    cycles and the flash kernels' over (d)'s."""
    import os

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.data.loader import prefetch_to_device
    from tdfo_tpu_torch.data.replay import ReplayConsumer
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum
    from tdfo_tpu_torch.serve.export import read_raw_bundle
    from tdfo_tpu_torch.train.online import OnlineLoop

    def sync():
        if dev.startswith("cuda"):
            torch.cuda.synchronize()

    out: dict = {"stage_ms": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_online_"))
    child = None
    try:
        t0 = time.perf_counter()
        log_a = _online_ctr_log(tmp / "log_a", ONLINE_CYCLES * ONLINE_STEPS, 41)
        log_c = _online_ctr_log(tmp / "log_c", ONLINE_CYCLES * ONLINE_STEPS + 1, 43)
        log_d = _online_seq_log(tmp / "log_d", ONLINE_SEQ_CYCLES * ONLINE_STEPS, 47)
        say(f"online: request logs written in {time.perf_counter() - t0:.1f} s "
            f"({sum(_dir_bytes(p) for p in (log_a, log_c, log_d))} bytes, "
            f"{len(list(log_a.glob('*.seal.json')))} sealed segments in (a)'s)")
        kw_a = online_kwargs(tmp / "ck_a", log_a)
        cpu_tr = _seed_checkpoints(torch, kw_a, [tmp / "ck_a", tmp / "ck_kill",
                                                 tmp / "ck_c"])

        # ---- (a) the plain loop on one MicroBatcher
        loop = OnlineLoop(read_configs(None, **kw_a), log_dir=str(tmp / "m_a"),
                          device=dev)
        tr = loop.trainer
        if not any(t.dim() == 3 for t in tr.state.tables.values()):
            raise AssertionError("online (a): no fat table in the TwoTower state")
        cpu_tr._train_auc = None
        cpu_reader = ReplayConsumer(log_a, schema=loop._replay_schema(),
                                    batch_size=BATCH)
        first = next(prefetch_to_device(iter(loop.consumer.peek_batches(1)), tr.device))
        err, touched = _fat_kernel_vs_plain(torch, tr, first)
        say(f"online (a): cycle 1's first step through fat_line_update vs the "
            f"plain version: {touched} touched lines, max abs err {err:.3g}; "
            "untouched lines bitwise")
        out["max_abs_err"] = err
        probe = _ctr_probe(53)
        rtol, atol = TOL["trajectory"]
        # the CPU trainer beside the loop runs the plain versions, which
        # count no launch
        kl.fat_line_update.launches = 0
        segment_sum.launches = 0
        for c in range(ONLINE_CYCLES):
            rec = loop.run_cycle()
            sync()
            if rec is None or rec["version"] != c + 1:
                raise AssertionError(f"online (a): cycle {c} gave {rec}")
            for _ in range(ONLINE_STEPS):
                b = next(prefetch_to_device(iter([cpu_reader.next_batch()[0]]), "cpu"))
                cpu_tr.state, _ = cpu_tr._one_step(cpu_tr.state, b)
            if cpu_reader.cursor() != loop.consumer.cursor():
                raise AssertionError("online (a): the CPU replay's cursor differs")
            worst = 0.0
            for n, t in tr.state.tables.items():
                got, want = t.cpu().double(), cpu_tr.state.tables[n].double()
                d = (got - want).abs()
                if bool((d > atol + rtol * want.abs()).any()):
                    raise AssertionError(f"online (a): cycle {c} table {n} card vs "
                                         f"CPU max err {float(d.max())}")
                worst = max(worst, float(d.max()))
            _probe_against_fresh(loop, probe, f"(a) cycle {c}")
            out["stage_ms"][f"a{c}"] = loop.last_stage_ms
            say(f"online (a) cycle {c}: v{rec['version']}, loss {rec['loss']:.5f}, "
                f"records {rec['replay/records']:.0f}, delta {loop.last_delta_bytes} "
                f"bytes; ms: {_stage_line(loop.last_stage_ms)}; tables vs CPU max "
                f"err {worst:.3g}; probe bitwise a fresh scorer")
        sync()
        out["fat_launches"] = kl.fat_line_update.launches
        out["segment_sum_launches"] = segment_sum.launches
        n_fat = sum(1 for t in tr.state.tables.values() if t.dim() == 3)
        if out["fat_launches"] != n_fat * ONLINE_CYCLES * ONLINE_STEPS \
                or not out["segment_sum_launches"]:
            raise AssertionError(f"online (a): launches {out}")
        if loop.run_cycle() is not None:
            raise AssertionError("online (a): the drained log gave another cycle")
        # ---- (e) counters off the path, and as CUDA-graph outputs
        ops = [_profiled_ops(torch, tr, first, strip) for strip in (False, True)]
        if ops[0] != ops[1]:
            raise AssertionError(f"online (e): counters off records {ops[0]} ops, "
                                 f"a build without emit sites {ops[1]}")
        g = _graph_counters(torch, dev)
        say(f"online (e): a TwoTower step with counters off records {ops[0]} "
            f"profiler ops, the same with every emit site stripped; the dense "
            f"step's counters as CUDA-graph outputs equal eager's over 3 chunks "
            f"(grad_norm {', '.join(f'{x:.6g}' for x in g['grad_norm'])})")
        ref = dict(digest=read_raw_bundle(loop.store.current_dir())[0]["digest"],
                   cursor=loop.consumer.cursor(), version=loop.store.current_version(),
                   logits={rid: np.asarray(v).tolist()
                           for rid, v in loop.probe(_copy_trace(probe)).items()})
        loop.close()
        del loop, tr, cpu_tr

        # ---- (b) the kill drill, in a child process beside (c) and (d)
        spec = dict(kw=online_kwargs(tmp / "ck_kill", log_a,
                                     faults={"kill_between_stages": ONLINE_KILL_STAGE}),
                    log_dir=str(tmp / "m_kill"), out_json=str(tmp / "kill.json"),
                    device=dev, probe=[(r, {k: v.tolist() for k, v in b.items()})
                                       for r, b in probe])
        spec_path = tmp / "kill_spec.json"
        spec_path.write_text(json.dumps(spec))
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--online-child",
               str(spec_path)]
        child_log = open(tmp / "kill.log", "w")
        child = subprocess.Popen(cmd, cwd=ROOT, stdout=child_log,
                                 stderr=subprocess.STDOUT, env=dict(os.environ))

        # ---- (c) the gated loop over an in-process fleet of 2
        kw_c = online_kwargs(tmp / "ck_c", log_c, online=ONLINE_GATED,
                             serving={"replicas": 2},
                             faults={"regress_auc_at_cycle": 2})
        loop = OnlineLoop(read_configs(None, **kw_c), log_dir=str(tmp / "m_c"),
                          device=dev)
        verdicts = []
        kl.fat_line_update.launches = 0
        segment_sum.launches = 0
        for c in range(ONLINE_CYCLES):
            rec = loop._run_cycle_gated()
            sync()
            verdicts.append(rec["verdict"])
            out["stage_ms"][f"c{c}"] = loop.last_stage_ms
            say(f"online (c) cycle {rec['cycle']}: {rec['verdict']} v{rec['version']}"
                f" (shadow AUC {rec['shadow_auc']:.4f} vs {rec['shadow_auc_base']:.4f}"
                f", canary {rec['canary_auc']}, stable {rec['stable_auc']}); delta "
                f"{loop.last_delta_bytes} bytes; ms: {_stage_line(loop.last_stage_ms)}")
            head = loop.store.current_version()
            if loop.fleet.versions() != {0: head, 1: head}:
                raise AssertionError(f"online (c): replicas {loop.fleet.versions()} "
                                     f"after the verdict, head v{head}")
            each = loop.fleet.probe_each(_copy_trace(probe))
            if any(not np.array_equal(each[0][r], each[1][r]) for r, _ in probe):
                raise AssertionError(f"online (c) cycle {c}: replicas differ")
            _probe_against_fresh(loop, probe, f"(c) cycle {c}")
        rej = loop.store.rejections()
        if (verdicts != ["promote", "rollback", "promote"] or len(rej) != 1
                or rej[0]["version"] != 2 or "canary AUC" not in rej[0]["reason"]
                or loop.store.current_version() != 2):
            raise AssertionError(f"online (c): verdicts {verdicts}, rejections {rej}")
        if loop._run_cycle_gated() is not None:
            raise AssertionError("online (c): the drained log gave another cycle")
        out["gated_launches"] = (kl.fat_line_update.launches, segment_sum.launches)
        say(f"online (c): verdicts {verdicts}; rejections.json "
            f"{[(r['version'], r['reason']) for r in rej]}; both replicas bitwise "
            "on the last good version after the rollback; launches "
            f"fat_line_update {out['gated_launches'][0]}, segment_sum "
            f"{out['gated_launches'][1]}")
        loop.close()
        del loop

        # ---- (d) the seq family: Bert4Rec, flash attention
        kw_d = online_kwargs(tmp / "ck_d", log_d, seq=True)
        loop = OnlineLoop(read_configs(None, **kw_d), log_dir=str(tmp / "m_d"),
                          device=dev)
        sprobe = _seq_probe(59)
        seq_kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                       kl.fat_line_update)
        for f in seq_kernels:
            f.launches = 0
        for c in range(ONLINE_SEQ_CYCLES):
            rec = loop.run_cycle()
            sync()
            if rec is None or not np.isfinite(rec["loss"]):
                raise AssertionError(f"online (d): cycle {c} gave {rec}")
            _probe_against_fresh(loop, sprobe, f"(d) cycle {c}")
            out["stage_ms"][f"d{c}"] = loop.last_stage_ms
            say(f"online (d) cycle {c}: v{rec['version']}, loss {rec['loss']:.5f}, "
                f"delta {loop.last_delta_bytes} bytes; ms: "
                f"{_stage_line(loop.last_stage_ms)}; probe bitwise a fresh scorer")
        counts = [f.launches for f in seq_kernels]
        want = ONLINE_SEQ_CYCLES * ONLINE_STEPS * B4R["n_layers"]
        if counts[:3] != [want] * 3 or not counts[3]:
            raise AssertionError(f"online (d): launches {counts}, want {want} each")
        out["flash_launches"] = dict(zip(FLASH_KERNELS, counts[:3]))
        out["seq_fat_launches"] = counts[3]
        loop.close()
        del loop

        # ---- (b)'s outcome: killed, then the same command again
        rc = child.wait(timeout=600)
        child_log.close()
        from tdfo_tpu_torch.utils.faults import KILL_EXIT_CODE

        if rc != KILL_EXIT_CODE or (tmp / "kill.json").exists():
            raise AssertionError(f"online (b): the child exited {rc}:\n"
                                 + (tmp / "kill.log").read_text()[-3000:])
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"online (b): the restart failed:\n{res.stdout[-3000:]}"
                                 f"\n{res.stderr[-3000:]}")
        got = json.loads((tmp / "kill.json").read_text())
        for k in ("digest", "cursor", "version", "logits"):
            if got[k] != ref[k]:
                raise AssertionError(f"online (b): the restarted run's {k} differs "
                                     "from the uninterrupted run's")
        say(f"online (b): killed at stage call {ONLINE_KILL_STAGE} (cycle 2's "
            f"export), restarted in {time.perf_counter() - t0:.1f} s: v{got['version']}"
            f", digest {got['digest'][:12]}, cursor and {len(got['logits'])} probe "
            "answers bitwise the uninterrupted run's")
    finally:
        if child is not None and child.poll() is None:
            _kill_tree(child.pid)
            child.wait()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    say(f"online: launches over (a)'s cycles: fat_line_update {out['fat_launches']}, "
        f"segment_sum {out['segment_sum_launches']}; over (d)'s: "
        f"{out['flash_launches']}, fat_line_update {out['seq_fat_launches']}")
    return out


def online_child(spec_path: str) -> int:
    """``chip_smoke.py --online-child SPEC``: one online run (the kill
    drill's lineage): the loop drains the log, then the probe; writes
    ``out_json`` (an injected kill exits first and writes nothing)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.serve.export import read_raw_bundle
    from tdfo_tpu_torch.train.online import OnlineLoop

    spec = json.loads(Path(spec_path).read_text())
    loop = OnlineLoop(read_configs(None, **spec["kw"]), log_dir=spec["log_dir"],
                      device=spec["device"])
    try:
        loop.run()
        schema = loop.trainer._eval_schema
        probe = [(r, {k: np.asarray(v, dtype=schema[k]) for k, v in b.items()})
                 for r, b in spec["probe"]]
        logits = loop.probe(probe)
        Path(spec["out_json"]).write_text(json.dumps({
            "digest": read_raw_bundle(loop.store.current_dir())[0]["digest"],
            "cursor": loop.consumer.cursor(),
            "version": loop.store.current_version(),
            "logits": {r: np.asarray(v).tolist() for r, v in logits.items()}}))
    finally:
        loop.close()
    return 0


def phase_online_cli(torch) -> dict:
    """The ``launch online`` journey on ``config.toml`` (TwoTower, d = 16,
    with ``model_parallel = true`` and ``fused_table_threshold = 0``: every
    table a packed fat line, R = 2): ``synth -> preprocess-ctr -> serve``
    with ``[serving] log_features`` (64 requests into the request log),
    then ``launch online`` in this process (its kernel launches counted)
    with ``[telemetry] trace``, and ``launch obs`` over the trace."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_goodreads(tmp / "data", n_users=SERVE_CLI_USERS)
        text = (ROOT / "config.toml").read_text()
        if 'data_dir = "data/goodreads"' not in text:
            raise AssertionError("config.toml no longer has its data_dir line")
        lines = [f'data_dir = "{tmp / "data"}"' if x.startswith("data_dir =") else x
                 for x in text.splitlines()]
        ck = tmp / "ck"
        cfg = tmp / "online.toml"
        cfg.write_text(
            "\n".join(lines) + "\nmodel_parallel = true\nfused_table_threshold = 0\n"
            f'checkpoint_dir = "{ck}"\n[serving]\nlog_features = true\n'
            f'[online]\nrequest_log = "{ck / "request_log"}"\n'
            f"steps_per_cycle = {ONLINE_STEPS}\n[telemetry]\ntrace = true\n")
        if launch.main(["preprocess-ctr", "--config", str(cfg)]) != 0:
            raise AssertionError("launch preprocess-ctr failed")
        t0 = time.perf_counter()
        _serve_cmd(cfg)
        serve_s = time.perf_counter() - t0
        kl.fat_line_update.launches = 0
        segment_sum.launches = 0
        t0 = time.perf_counter()
        stats = launch.run(["online", "--config", str(cfg)])
        online_s = time.perf_counter() - t0
        report = launch.run(["obs", "--config", str(cfg)])
        chrome = ck / "trace" / "chrome_trace.json"
        fat, seg = kl.fat_line_update.launches, segment_sum.launches
        if not (stats["cycles"] >= 1 and stats["version"] == stats["cycles"]
                and fat and fat % stats["global_step"] == 0 and seg
                and chrome.exists()):
            raise AssertionError(f"online_cli: {stats}, launches {fat}/{seg}")
    say(f"online_cli: serve (64 requests logged) {serve_s:.1f} s; launch online "
        f"{online_s:.1f} s: {stats['cycles']} cycles, {stats['global_step']} steps, "
        f"v{stats['version']}, records {stats['replay/records']:.0f}; launches "
        f"fat_line_update {fat}, segment_sum {seg}; launch obs: "
        f"{len(report.get('cycles', []))} cycles assembled, chrome_trace.json written")
    return {"stats": stats, "fat_launches": fat, "segment_sum_launches": seg}


# ------------------------------------------------------------ the journeys
# The CLI journeys drive ``launch`` subprocesses and time no kernel, so they
# run side by side, each in a process of its own, beside dist_main (rank
# processes too, with dist_dense and dist_serve in a thread beside it);
# their host-clock numbers (serve_cli's p50 / p99 / qps, the fleet CLIs')
# and dist_main's, dist_dense's and dist_serve's ms are taken under that
# load.
JOURNEYS = ("quickstart_cli", "criteo_int8_cli", "serve_cli", "dist_cli",
            "seq_cli", "serve_fleet_cli", "loadgen_cli", "online", "online_cli")
JOURNEY_TIMEOUT_S = 900
JOURNEY_THREADS = 2


def journey_main(name: str) -> int:
    """``chip_smoke.py --journey NAME``: one journey between its phase
    markers; its result goes to ``$CHIP_SMOKE_JOURNEY_DIR/NAME.json``."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = {"quickstart_cli": phase_quickstart_cli, "criteo_int8_cli":
          phase_criteo_int8_cli, "serve_cli": phase_serve_cli,
          "dist_cli": phase_dist_cli, "seq_cli": phase_seq_cli,
          "serve_fleet_cli": phase_serve_fleet_cli,
          "loadgen_cli": phase_loadgen_cli, "online": phase_online,
          "online_cli": phase_online_cli}[name]
    say(f"phase {name}: start")
    t0 = time.perf_counter()
    out = fn(torch)
    say(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    where = os.environ.get("CHIP_SMOKE_JOURNEY_DIR")
    if where:  # the result, for the kernels line
        (Path(where) / f"{name}.json").write_text(json.dumps(out, default=str))
    return 0


@contextlib.contextmanager
def journeys_beside(names):
    """Start ``names``, one ``--journey`` process each (output to a file),
    run the body beside them, then wait for them and print their output
    in order.  A journey that fails or outlasts ``JOURNEY_TIMEOUT_S``
    fails the run by name; a body that fails kills them.  Yields a dict
    that holds each journey's result once they have ended."""
    import shutil

    import os

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_journeys_"))
    procs = {}
    # JOURNEY_THREADS intra-op threads a process (its launch children
    # inherit it): many processes share the host's cores side by side
    env = dict(os.environ, OMP_NUM_THREADS=str(JOURNEY_THREADS),
               CHIP_SMOKE_JOURNEY_DIR=str(tmp))
    results: dict = {}
    try:
        for n in names:
            with open(tmp / f"{n}.log", "w") as f:
                procs[n] = subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--journey", n],
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, env=env)
        yield results
        deadline = time.monotonic() + JOURNEY_TIMEOUT_S
        for p in procs.values():
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs.values():
            if p.poll() is None:
                _kill_tree(p.pid)
                p.wait()
        for n in procs:
            print((tmp / f"{n}.log").read_text().rstrip(), flush=True)
            if (tmp / f"{n}.json").exists():
                results[n] = json.loads((tmp / f"{n}.json").read_text())
        shutil.rmtree(tmp, ignore_errors=True)
    bad = {n: p.returncode for n, p in procs.items() if p.returncode != 0}
    if bad:
        raise AssertionError(f"journeys failed (name: rc): {bad}")
    if names:
        say(f"journeys {', '.join(names)}: side by side in "
            f"{time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def phases_beside(run, named, *args):
    """Run each ``(name, fn)`` of ``named`` through ``run(name, fn, *args)``
    in a thread of its own (they spawn rank processes and wait on them)
    beside the body, one after another in that thread; yields the dict the
    results land in once the body and they have ended.  A phase that fails
    fails the run by name, after the body."""
    import threading

    done: dict = {}
    errors: dict = {}

    def work():
        for name, fn in named:
            try:
                done[name] = run(name, fn, *args)
            except BaseException as e:  # noqa: BLE001 (re-raised by name below)
                errors[name] = e
                return

    t = threading.Thread(target=work, name="phases_beside", daemon=True)
    t.start()
    try:
        yield done
    finally:
        t.join()
    if errors:
        name, e = next(iter(errors.items()))
        raise AssertionError(f"phase {name} (beside) failed: {e!r}") from e


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--journey"]:  # one CLI journey (its own process)
        return journey_main(argv[1])
    if argv[:1] == ["--online-child"]:  # the online kill drill's lineage
        return online_child(argv[1])
    if argv[:1] == ["--dist-rank"]:  # one rank of dist_main (its own process)
        spec = json.loads(argv[1])
        return (dist_rank_seq if "seq_arms" in spec else dist_rank_ctr
                if "arms" in spec else dist_rank_dense if "dense_arms" in spec
                else dist_rank_serve if "serve" in spec else dist_rank_main)(spec)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                   help="comma-separated subset of " + ",".join(DEFAULT_PHASES)
                        + ",profile,profile_b4r,profile_dlrm,profile_bf16,"
                        "profile_dlrm_bf16,profile_dense,hot_head_inits "
                        "(default: all but these last seven)")
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import tdfo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    say(f"device: {kind}, count {count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")

    from tdfo_tpu_torch.ops.kernels.build import build_all

    def phase_build():
        t0 = time.perf_counter()
        res = build_all()
        for r in res.values():
            say(f"build: {r.name} -> {r.path.relative_to(ROOT)} in "
                f"{r.seconds:.2f} s\n{r.log.strip()}")
        say(f"build: all kernels in {time.perf_counter() - t0:.2f} s")

    def run(name, fn, *args):
        """One phase between its markers: a failing run names its phase
        (nothing is caught)."""
        say(f"phase {name}: start")
        t0 = time.perf_counter()
        out = fn(*args)
        say(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
        return out

    if "build" in phases:
        run("build", phase_build)
    rng = np.random.default_rng(0)
    recs = {name: {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": None, "max_abs_err": None,
                   "ms": None, "device_ms": None, "device_records": None,
                   "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
                   "library_device_ms": None}
            for name, source, replaces in KERNEL_TABLE}
    fat, routed = recs["fat_line_update"], recs["fat_line_update_routed"]
    floors = {}  # the empty-kernel launch floor of each timing phase
    if "oracle" in phases:
        fat.update(run("oracle", phase_oracle, torch, rng))
    if "timing" in phases:
        t = run("timing", phase_timing, torch, rng)
        floors["timing"] = t["floor"]
        fat.update(ms=t["ms"], device_ms=t["device_ms"],
                   device_records=t["device_records"], plain_ms=t["plain_ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                   max_abs_err=max(fat["max_abs_err"] or 0.0, t["max_abs_err"]),
                   shapes=t["shapes"])
    if "segsum" in phases:
        recs["segment_sum"].update(run("segsum", phase_segsum, torch,
                                       np.random.default_rng(17)))
    if "main" in phases:
        r = run("main", phase_main_path, torch, smi)
        fat["launches"] = r["launches"]
        recs["segment_sum"]["launches"] = r["segment_sum_launches"]
    if "cli" in phases:
        run("cli", phase_cli, torch)
    if "flash_oracle" in phases:
        worst = run("flash_oracle", phase_flash_oracle, torch)
        for k in FLASH_KERNELS:  # f32 is the main path's type
            recs[k].update(max_abs_err=worst["f32"][k],
                           max_abs_err_bf16=worst["bf16"][k])
    if "flash_timing" in phases:
        main = run("flash_timing", phase_flash_timing, torch)
        floors["flash_timing"] = main.pop("floor")
        for k, t in main.items():
            err = t.pop("max_abs_err")
            recs[k].update(t, max_abs_err=max(recs[k]["max_abs_err"] or 0.0, err))
    if "b4r_main" in phases:
        counts = run("b4r_main", phase_b4r_main, torch, smi)["launches"]
        for k in FLASH_KERNELS:
            recs[k]["launches"] = counts[k]
    if "b4r_cli" in phases:
        run("b4r_cli", phase_b4r_cli, torch)
    if "routed_oracle" in phases:
        routed.update(run("routed_oracle", phase_routed_oracle, torch, rng))
    if "routed_timing" in phases:
        t = run("routed_timing", phase_routed_timing, torch, rng)
        floors["routed_timing"] = t.pop("floor")
        err = t.pop("max_abs_err")
        routed.update(t, max_abs_err=max(routed["max_abs_err"] or 0.0, err))
    dlrm_peak = None  # dlrm_main's peak memory, beside dlrm_int8_cache's
    if "dlrm_main" in phases:
        r = run("dlrm_main", phase_dlrm_main, torch, smi)
        routed["launches"] = r["launches"]["fat_line_update_routed"]
        dlrm_peak = r["peak_gb"]
    if "dlrm_cli" in phases:
        run("dlrm_cli", phase_dlrm_cli, torch)
    fat16 = recs["fat_line_update[bf16]"]
    routed16 = recs["fat_line_update_routed[bf16]"]
    if "bf16_oracle" in phases:
        r = run("bf16_oracle", phase_bf16_oracle, torch, rng)
        fat16["max_abs_err"], routed16["max_abs_err"] = r["fat"][0], r["routed"][0]
        fat16["one_ulp_elements"] = r["fat"][1]
        routed16["one_ulp_elements"] = r["routed"][1]
    if "bf16_timing" in phases:
        t = run("bf16_timing", phase_bf16_timing, torch, rng)
        floors["bf16_timing"] = t.pop("floor")
        for rec, key in ((fat16, "fat_line_update[bf16]"),
                         (routed16, "fat_line_update_routed[bf16]")):
            err = t[key].pop("max_abs_err")
            rec.update(t[key], max_abs_err=max(rec["max_abs_err"] or 0.0, err))
    if "main_bf16" in phases:
        fat16["launches"] = run("main_bf16", phase_main_bf16, torch, smi)["launches"]
    if "dlrm_bf16_main" in phases:
        routed16["launches"] = run("dlrm_bf16_main", phase_dlrm_bf16_main, torch,
                                   smi)["launches"]["fat_line_update_routed"]
    if "dense_main" in phases:
        run("dense_main", phase_dense_main, torch, smi)
    if "resume" in phases:
        run("resume", phase_resume, torch, smi)
    if "b4r_jagged" in phases:
        run("b4r_jagged", phase_b4r_jagged, torch, smi)
    if "int8_main" in phases:
        run("int8_main", phase_int8_main, torch, smi)
    if "int8_fused" in phases:
        run("int8_fused", phase_int8_fused, torch, smi)
    if "dlrm_int8_cache" in phases:
        run("dlrm_int8_cache", phase_dlrm_int8_cache, torch, smi, dlrm_peak)
    if "dlrm_hot_cold" in phases:
        run("dlrm_hot_cold", phase_dlrm_hot_cold, torch, smi)
    if "hot_head_inits" in phases:
        run("hot_head_inits", phase_hot_head_inits, torch, smi)
    if "serve_main" in phases:
        run("serve_main", phase_serve_main, torch, smi)
    if "serve_seq_main" in phases:
        run("serve_seq_main", phase_serve_seq_main, torch, smi)
    if "fleet" in phases:
        r = run("fleet", phase_fleet, torch, smi)
        fat["launches_fleet"] = r["fat_launches"]
        recs["segment_sum"]["launches_fleet"] = r["segment_sum_launches"]
    if "dist_seq" in phases:
        r = run("dist_seq", phase_dist_seq, torch, smi)
        for rec, name in ((fat, "fat_line_update"),
                          *((recs[k], k) for k in FLASH_KERNELS)):
            rec["launches_seq_arms"] = {k: [x[name] for x in v]
                                        for k, v in r["launches"].items()}
    beside = [(n, f) for n, f in (("dist_dense", phase_dist_dense),
                                  ("dist_serve", phase_dist_serve)) if n in phases]
    with journeys_beside([j for j in JOURNEYS if j in phases]) as journeyed:
        with phases_beside(run, beside, torch, smi) as done:
            if "dist_main" in phases:
                r = run("dist_main", phase_dist_main, torch, smi)
                fat["launches_sharded"] = r["launches"]
                recs["segment_sum"]["launches_sharded"] = r["segment_sum_launches"]
                for rec, name in ((fat, "fat_line_update"),
                                  (routed, "fat_line_update_routed"),
                                  (recs["segment_sum"], "segment_sum")):
                    rec["launches_ctr_arms"] = {k: [x[name] for x in v]
                                                for k, v in r["ctr_launches"].items()}
    if "online" in journeyed:
        r = journeyed["online"]
        fat["launches_online"] = r["fat_launches"]
        recs["segment_sum"]["launches_online"] = r["segment_sum_launches"]
        for k in FLASH_KERNELS:
            recs[k]["launches_online"] = r["flash_launches"][k]
        if fat["max_abs_err"] is not None:
            fat["max_abs_err"] = max(fat["max_abs_err"], r["max_abs_err"])
    if "online_cli" in journeyed:
        r = journeyed["online_cli"]
        fat["launches_online_cli"] = r["fat_launches"]
        recs["segment_sum"]["launches_online_cli"] = r["segment_sum_launches"]
    if "dist_dense" in done:
        recs["segment_sum"]["launches_dense_arms"] = {
            k: [x["segment_sum_launches"] for x in v]
            for k, v in done["dist_dense"].items() if not k.endswith("/refuse")}
    if "profile" in phases:
        run("profile", phase_profile, torch)
    if "profile_b4r" in phases:
        run("profile_b4r", phase_profile_b4r, torch)
    if "profile_dlrm" in phases:
        run("profile_dlrm", phase_profile_dlrm, torch)
    if "profile_bf16" in phases:
        run("profile_bf16", phase_profile_bf16, torch)
    if "profile_dlrm_bf16" in phases:
        run("profile_dlrm_bf16", phase_profile_dlrm_bf16, torch)
    if "profile_dense" in phases:
        run("profile_dense", phase_profile_dense, torch)
    if floors:
        say(f"launch floor (empty kernel, ms): {json.dumps(floors)}")
    say(json.dumps({"kernels": list(recs.values())}))
    say(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
