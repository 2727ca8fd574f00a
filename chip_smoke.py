#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from anywhere on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device and build -- print the card (nvidia-smi name and power limit)
   and the torch/CUDA versions, then build all eleven kernels (six f32
   and int8, four bf16, one bf16 x against f32 weights) from
   ``src/repro_torch/kernels/*/csrc/*.cu`` with
   nvcc for sm_90a, one compiler per source, in parallel, and print what
   ptxas gives every kernel instance (registers, spills); no instance
   may spill;
2. kernels vs plain -- each kernel against its plain PyTorch version on
   the card, at every shape the vikin-mixed, vikin-kan2 and vikin-mlp3
   stacks give it at buckets 2/4/8/16 (f32, and int8 with scales
   calibrated as the launcher does), at ragged shapes and at one batch
   of 8192: within ``1e-5 * (1 + max|plain|)``, and the int8 matmul
   bitwise.  The kernel-tooling kernels too: the spline-basis kernel
   bitwise for every G x K, on the flattened KAN-layer inputs of
   vikin-mixed and vikin-kan2 at the same batches, at ragged n, on
   inputs outside [-1, 1], at every ``block_n`` candidate (inputs a
   block) and into outputs 4, 8 and 12 bytes past a 16-byte boundary;
   the v1 KAN kernel at the same KAN layers and at a ragged shape, within
   the tolerance of its plain version and of the v2 kernel, and batched
   == single, bitwise.  Both matmul kernels at every candidate tile
   (``autotune.candidates_pattern_matmul``) of vikin-mixed's and
   vikin-mlp3's matmul layers at bucket 8 and batch 8192: bitwise the
   output of the default tile.  Both KAN kernels at every candidate knob
   (``autotune.candidates_kan_fused``) of vikin-mixed's and vikin-kan2's
   KAN layers at bucket 8 and batch 8192: bitwise the default knob's
   output; at ragged widths (37->13, 300->33) within tolerance; and a row
   alone under one knob bitwise equal to it in a batch under another, in
   both precisions.  The v1 kernel the same way, at every candidate of
   its own grid (``candidates_kan_fused(..., version=1)``).
   bf16: the four bf16 kernels against their plain versions on the card
   at the bf16 stacks' shapes (buckets 2/4/8/16 and 8192), at ragged
   shapes (odd n_in and n_out: 77x37->13, 77x301->33, 999x147->301; the
   tensor-core KAN body at 21 fused rows a feature, G16K4 77x37->33, and
   at the silu row alone, nbk = 0) and at every candidate knob: KAN v2
   and v1 within ``1e-5 * (1 + max|plain|)`` at f32 out and one bf16 ulp
   (``2**-8 * (1 + max|plain|)``) at bf16 out, the matmul within one
   bf16 ulp (f32 out within 1e-5), the spline basis bitwise (every G x
   K, in and out of range, every ``block_n``, outputs 2..14 bytes past a
   16-byte boundary; and on all 65 280 finite bf16 inputs, NaN for NaN);
   bf16 v1 (tensor cores) also within one bf16 ulp of bf16 v2; every knob
   bitwise the default's; batched == single bitwise at buckets 2/4/8/16
   and 8192; the mixed kernel (a bf16 x against f32 fused rows, a bf16
   model's: its t is f32) at the KAN drop-in's 896->608->896 and
   1024->512->1024 (M = 1024, and 12000 for whisper's encoder) against
   its plain version, every knob bitwise, batched == single;
3. serve -- 48 requests of vikin-kan2, vikin-mlp3 and vikin-mixed through
   the port's Engine + MultiWorkloadBackend on 8 slots, once in f32 and
   once in int8: every answer against the same stack run through the
   plain versions on the card (``1e-4 * (1 + max|ref|)``; an int8 code
   that a requantization rounds across a half-step must sit at a
   rounding tie), the launch counts against the layer applications the
   served batches imply (and none of the other precision's kernels),
   and vikin-mixed batched == single, bitwise, in both precisions; then
   the same at bf16 through ``make_vikin_backend(precision="bf16")``:
   every answer within ``SERVE_TOL_BF16`` of the bf16 stack through the
   plain versions on the card and only bf16 kernels launched; in each
   precision the served simulated fields equal a CPU engine's on the
   same burst;
4. times -- per kernel at the vikin-mixed shapes, bucket 8 and batch
   8192: median ms of back-to-back calls (CUDA events) and of the same
   calls replayed from a CUDA graph (device time alone), the plain
   version's ms, one PyTorch call's ms where one computes the same
   function (``addmm``; ``torch._int_mm`` where its shape rules allow),
   and the bound max(bytes / 3.35 TB/s, the operations each over the
   peak rate for its type: 67 TFLOP/s f32 on CUDA cores, 989 TFLOP/s
   for products of bf16 operands, 1979 TOP/s for the int8 matmul); the
   spline-basis
   kernel on the vikin-mixed KAN layer's input, flattened, and the v1
   KAN kernel at that layer beside the v2 one; each matmul record names
   the tiles (bm, bk, bn) each launch took, each KAN record (v1 too) the
   knob (bm, bi, bn), the spline-basis record its ``block_n``, and the
   bf16 records their kernels' design (``design``): the matmul's
   persistent grid and the row tiles a block walks, the KAN kernel's
   shared memory a block, its cluster and the multiply-adds its dense
   MMA tile issues beside the useful ones the bound counts; then, per
   arch at bucket
   8 and per precision, where one served batch's time goes (host wall of
   a backend forward, the stack on the card, the kernels alone); the same
   rows for the four bf16 kernels (their multiply-adds at the bf16
   rate, the SPU and spline work at the f32 rate; library ``addmm`` in
   bf16 with f32 accumulation), the mixed kernel on the bf16 stack's
   input against the f32 stack's rows (its multiply-adds at the cheaper
   of two costs, ``mixed_macs``: f32 FMAs at the f32 rate or three bf16
   products at the bf16 rate; with its design, as the bf16 KAN row's),
   and the per-arch breakdown at bf16;
5. the v1 path -- a ``KANLayer`` at ``version=1`` built from the
   vikin-kan2 stack's weights runs forward on the card at buckets
   2/4/8/16, 8192 and 65535 * 16 + 1 (more 16-row tiles than grid.y
   holds: row tiles sit on grid.x), and once more at bucket 8 with
   explicit knobs
   (``KANConfig(version=1, blocks=...)``): exactly one v1 launch per call
   and no other launch, answers within tolerance of the v2 layer and of
   the plain version (and of the layer on the CPU below the big batch);
   and a bf16 v1 layer on the same weights cast to bf16 at buckets
   2/4/8/16 and 8192: one bf16 v1 launch per call, within one bf16 ulp of
   the bf16 v2 layer and of the plain version;
6. the kernel bench -- ``repro_torch.benchmarks.kernel_bench.run`` on
   the card with its own asserts (spline-basis, v1 and v2 KAN and
   matmul kernels against plain versions and oracles, one
   ``tune_spline_basis``, one ``tune_pattern_matmul`` (8192x72->304 relu)
   and two ``tune_kan_fused`` searches (8x304->32, the v2 and the v1
   kernel), each round-tripped through a temporary cache and shown to
   change no bit), with its bf16 rows (v1, v2 and the spline basis), its
   JSON in ``chiprun_out/kernel_bench.json``;
7. open-loop on the card (``runtime/loadgen``), vikin-mlp3 on 8 slots in
   f32 and int8:
   (a) the committed ``openloop:burst:vikin-mlp3`` trace of
   ``BENCH_serving.json`` (its sha256 checked) replayed on the simulated
   clock, unbounded and with ``max_queue=16, admission="shed",
   drop_expired=True``: every report field equal to the committed row at
   f32, and to the same replay on a CPU backend at int8 and at bf16
   (both move other modelled DMA bytes);
   (b) the same backends, and the three-arch multi-workload engine under
   a workload-mixed trace, on the wall clock at rates sized from the
   card: the closed-burst rate C after ``warmup`` (15 bursts of 64, each
   submitted and served in the timed region), Poisson traces of 2000
   arrivals at 0.5, 0.9 and 1.5 C, and for vikin-mlp3 a bursty deadline
   trace (calm 0.5 C, bursts 5 C, deadline four batch times) unbounded
   and shed; offered, achieved and goodput req/s, p50/p95/p99 latency,
   the queue high-water mark and sheds are printed, and the bound, the
   drain, every request's fate and that no kernel is built and no knob
   resolved inside a replay are checked;
   in both, every served answer is held to ``SERVE_TOL`` against the
   plain versions on the card (int8 as in phase 3), and the launches to
   what the served batches imply;
   (c) the port's serving bench's burst, sched and kanffn rows and the
   load bench on the card (``chiprun_out/serving_bench.json``): every
   simulated field equal to the committed rows, batched == single
   bitwise under both policies;
8. training on the card, f32 with TF32 off (asserted):
   (a) one step of vikin-mixed and of vikin-kan2 at batch 64 through
   ``StackTrainer.loss_fn``: every gradient through the kernels'
   autograd Functions within ``1e-5 * (1 + max|plain|)`` a leaf of
   autograd through the plain versions on the card, and the launches
   of the forward and backward exactly ``kan_fused_v2`` x1,
   ``pattern_matmul`` x2, ``spline_basis`` x2 (vikin-kan2: x1, x0, x1);
   (b) ``StackTrainer`` 200 steps of each, twice from one init: the
   validation MSE falls, the two runs are bitwise equal, the launches
   are 200 times one step's, the first 10 losses within 1e-4 relative
   of a CPU run's from the same init; ms a step: host wall, and CUDA
   event spans of the forward, backward and update beside the
   spline-basis launches of one backward (graph-replayed);
   (c) ``python -m repro_torch.launch.train --arch vikin-mixed --steps
   200 --batch 64 --pattern 0.5 --precision int8`` in a subprocess on
   the card, its checkpoint served through ``make_vikin_backend(...,
   ckpt=...)`` at f32 and int8 (answers held as in phase 3), the served
   masks equal to the saved ones and to a calibration of the saved
   params;
   (d) an ``AsyncCheckpointer`` save overlapped with 20 training steps:
   the restored params bitwise the snapshot;
9. the paper's results on the card (``repro_torch.benchmarks.
   table1_models``, ``fig8_grid_scaling``, ``table2_overall``,
   ``fig6_technique``, ``fig7_sparsity``), at the paper's widths on the
   full default Traffic surrogate, into ``chiprun_out/paper/``:
   (a) Table I's four models at 30 epochs, batch 512, lr 1e-3: one
   step's launches (KAN-2: ``kan_fused_v2`` x1, ``spline_basis`` x1;
   KAN-3: x2, x3; the MLPs none), the run's launches equal to its steps'
   and the test split's, every loss finite, a second run bitwise equal,
   the first 10 losses within 1e-4 relative of a CPU run from the same
   init; MSE, RSE, MAE and the params and MSE ratios against the paper's
   0.30x and 0.74; host ms a step and the device ms of a KAN step's
   kernels (graph-replayed);
   (b) KAN-3 at Fig. 8's G = 2, 4, 8, 16 (5 to 19 bases) at batch 512:
   each layer's kernel forward within ``KERNEL_TOL`` of its plain
   version, each leaf's gradient through the kernels within
   ``TRAIN_GRAD_TOL`` of its max of autograd through the plain versions,
   a step's host ms and its kernels' device ms, and the f32 KAN kernel's
   device ms, plain ms and bound at each layer; then the Fig. 8 sweep at
   20 epochs, its hardware half equal to the host's cycle model;
   (c) Table II (the masked fine-tune, 20 epochs, every masked-out weight
   0 after every update; the bf16-cast evaluation) and Figs. 6-7 from
   the card's Table I: every cycle-model and ``EdgeGPU`` field (model
   outputs) equal to the host's computation from the card's nnz rates,
   and the headline lines against the paper's points; the scripts'
   launches equal to their steps';
10. KAN-FFN transformer serving (``kanffn_phase``): ``qwen2-0.5b-kanffn``
   at full width (24 layers, d 896, vocab 151936, 12 "kan" FFNs of
   hidden 1080), bf16 params from seed 0 and their f32 twin: (a) one
   KAN-FFN layer at M = 1, 3, 8, 16, 64, each kernel against its plain
   version; (b) 8 requests x 16 tokens through ``Server`` on 8 slots,
   teacher-forced logits against the plain versions within
   ``TF_TOL_BF16`` (f32 twin ``TF_TOL_F32``), 12 + 12 launches a prefill
   and a decode step, batched == single; (c) ``calibrate_kanffn_masks``
   against a calibration through the plain versions, the masked model
   served and held as in (b), cheaper in simulated cycles; (d) the
   launcher at ``--scale full``, f32 and bf16, in a subprocess; (e) a
   decode step's host and device ms, idle share, profile and kernel
   share, a prefill's ms, the two kernels' rows at the decode shape;
   (f) the ``kanffn:kanffn-ci`` bench row;
11. MoE, RG-LRU and xLSTM serving (``moe_rec_phase``) at full width,
   depth cut where one card cannot hold the arch (``MR_DEPTH``:
   qwen3-moe-235b-a22b 2 of 94 layers, llama4-scout-17b-a16e 2 of 48,
   recurrentgemma-9b 6 of 38, xlstm-125m whole), params drawn on the
   card: (a) one MoE layer of KAN experts at qwen3-moe's widths (d 4096,
   128 experts, top-8, hidden 192), f32 and bf16, at T = 8 and 64: 2 x
   128 fused-KAN launches a call, each held against its plain version,
   the layer within ``MOE_LAYER_TOL``; (b) qwen3-moe with KAN experts at
   bf16 and its f32 twin through ``Server``, 8 requests x 16 tokens on
   8 slots: 512 launches a prefill and a decode step, teacher-forced
   logits within ``MOE_TF_TOL`` of the plain versions' (the plain run
   takes the kernel run's expert choices); (c) qwen3-moe and
   llama4-scout as registered at bf16, (d) recurrentgemma-9b and
   xlstm-125m (cached decode against the full forward at f32 within
   the reference's 2e-3, then bf16): served, logits finite, batched ==
   single, a decode step's host and device ms, idle share and peak
   device memory; (e) the five ``reduce()``d configs, the card against
   the CPU within ``CPU_TOL``; (f) the launcher on the four archs at
   ``--scale smoke`` and xlstm-125m at ``--scale full``;
12. encoder-decoder and prefix-VLM archs (``encdec_vlm_phase``) at full
   width and depth through ``launch/steps``, batches of 8 requests of 16
   tokens, params drawn on the card: (a) a KAN FFN (kept bases 0, 2, 4,
   5, 6) of each arch at the rows its steps give it (whisper-medium-kan's
   encoder FFN, 1024 -> 512 -> 1024, at M = 8 x 1500, f32 and bf16;
   paligemma-3b-kan's, 2048 -> 2048 -> 2048, at 8 x 272 and 8, bf16;
   whisper-medium-kan's decoder FFN at 8 x 16 and 8, bf16), each
   fused-KAN launch against its plain version, its times and bound; (b)
   whisper-medium-kan (24 + 24 layers, frames of 1500 x 1024) at bf16
   and its f32 twin, a prefill step and 16 decode steps: 2 x 24 + 2 x 24
   launches a prefill and 2 x 24 a decode step, teacher-forced logits
   within ``ED_TF_TOL`` of the plain versions', every launch of that
   run within one launch's tolerance of its plain version on the same
   input, and each FFN's input along the layers of ``forward`` against
   the plain versions'; (c) paligemma-3b-kan (18 layers, 256 patches) at
   bf16, the same, 2 x 18 launches a step; (d) both as published:
   ``forward`` + ``lm_loss`` finite and cached decode against
   ``forward`` (whisper) or a longer prefill (paligemma) within
   ``DECODE_TOL`` at f32, then at bf16 a prefill step's and a decode
   step's host and device ms, idle share,
   kernels and peak device memory; (e) the four ``reduce()``d configs,
   the card against the CPU within ``CPU_TOL``; (f) the launcher and
   ``TransformerBackend`` refuse both with the reference's reason.
13. LM training (``lm_train_phase``): qwen2-0.5b with the reference's
   KAN drop-in (896 -> 608 -> 896, kept bases 0, 2, 4, 5, 6) at full
   width, ``SyntheticLM`` batches of 8 x 128 tokens: (a) each KAN layer
   at M = 1024, bf16, mixed (bf16 x, f32 rows) and f32: the forward and
   dx, d wt through the kernels against the plain versions on the card,
   the launches, the fused-KAN and spline-basis times and bounds at these
   shapes; (b) ``Trainer`` at bf16 (its t f32, as the reference's), full
   depth, 8 steps: first loss near ln(vocab), finite losses, 48
   ``kan_fused_v2_mixed`` and 48 ``spline_basis_bf16`` launches a step
   and no other kernel, host and device ms a step, idle share, peak
   memory, and one more step with every mixed launch within one bf16 ulp
   of its plain version on its input; (c) at 4 layers, a run killed at
   step 3 and
   restarted from its checkpoint bitwise equal to a clean run; (d) the
   f32 twin, 2 steps, loss and every gradient leaf against the plain
   versions on the same params; (e) the train launcher at full scale, 4
   steps, as a subprocess; (f) xlstm-125m, 2 deterministic train steps
   of 8 x 128 tokens, twice from seed 0: finite losses, the two runs
   bitwise (the chunkwise mLSTM's scan is ``xlstm.inclusive_scan``);
14. the VIKIN array plans (``array_phase``, ``runtime/sharded``) at the
   paper's Table I widths from seed 0, each array's chips logical chips
   of the one card (``ARRAY_CHIPS`` = 4, ``["cuda:0"] * 4``): (a) the
   data plan, vikin-mixed and vikin-mlp3 at f32, bf16 and int8, 48
   requests on 8 slots and single ticks of 1, 2, 6, 9 and 33 requests
   (per-shard buckets 2, 4 and 16): bitwise the single-device backend's
   answers, held to the plain versions as in phase 3, launches 4 shards
   x the layers a tick, one stack for the four shards, host ms a bucket-8
   batch beside the single-device backend's; (b) the pipeline plan,
   vikin-mixed over 3 chips (even split) and ``stage_map=[2, 1]``, f32
   and bf16: bitwise, one launch a layer a tick; (c) the hetero plan
   over pins pipeline, pipeline, parallel, parallel: vikin-mixed bitwise
   with 0 reconfig cycles, and the vikin-kan2 + vikin-mlp3 engine on an
   interleaved stream bitwise the single-request answers, 0 flips, each
   tick serving the oldest waiting request's workload; (d) the
   refusals (int8 staged, a hetero array missing a mode, more cards than
   visible); (e) ``serving_bench.run`` (every row family) into phase
   7's file: 13 rows, ``check_regression --serving`` exits 0 against
   ``BENCH_serving.json``; (f) ``roofline --engine`` at batch 1 and 8,
   f32, bf16 and int8, equal to a CPU-only process's rows; (g)
   ``python -m repro_torch.examples.serve_batch`` on the card.
15. training and serving on a process mesh (``mesh_phase``,
   ``launch/mesh``, ``launch/sharding``, the mesh step of
   ``launch/steps``): four ranks of this script (``--mesh-worker``)
   share the card over gloo, the kernels built once before they start:
   (a) qwen2-0.5b with the KAN drop-in at full width and depth (bf16, f32
   t) on a 2x2 (data, model) mesh with ZeRO-1, tensor-parallel over
   ``model`` (7 of 14 heads, 304 of 608 KAN lanes, half the vocab a
   rank), 8 x 128 tokens a step, 3
   steps from seed 0: each step's loss within the reference's sharded ==
   dense bound (1e-3 * (1 + |loss|)) of one process's, two runs bitwise,
   48 ``kan_fused_v2_mixed`` and 48 ``spline_basis_bf16`` launches a step
   a rank and nothing else; per rank host, device, kernel and copy ms a
   step, the bytes and collectives it sends, peak memory; one more step
   with every mixed launch (512 x 896 -> 304, and 304 -> 896 with f32
   partials) within one bf16 ulp of its plain version on its input; at
   those shapes on each rank the mixed kernel and the bf16 spline basis
   (n = 512 x 896, 512 x 304, bitwise) against their plain versions,
   their times (device ms from a CUDA graph) and bounds, one rank at a
   time; (e) the same steps with ``activation_mode="sp"`` (the
   sequence split over ``model`` between sub-layers): each loss within
   the same bound of one process's and of (a)'s, the same launches, the
   same figures per rank; (b) the same mesh with ``grad_compression``:
   each rank's dequantized gradients bitwise the host's reduction of the
   same int8 codes; (c) qwen3-moe-235b-a22b (2 of 94 layers, full width,
   bf16) on a 1x4 mesh, 32 experts a rank, its attention and vocab
   tensor-parallel: a prefill of 8 x 16 tokens
   and 8 decode steps teacher-forced on one process's tokens and
   routing, greedy tokens equal but at a checked tie, logits and router
   probs within phase 11's ``MOE_TF_TOL`` of one process's, the ranks'
   own routing one process's but at a routing tie; (d) (a)'s checkpoint restored on 1x2
   and 1x1 bitwise, one more step on each; (f) the tensor-parallel serve
   steps (``launch/steps.make_prefill_step`` / ``make_decode_step`` on
   the mesh, the reference's KV cache layout) on (a)'s 2x2 mesh, model
   and draw: a prefill of 8 x 1024 tokens (the caches 520 of 1040 slots
   a model rank) and 8 decode steps teacher-forced on one process's
   tokens: greedy tokens equal but at a checked tie, logits within 2 x 24
   bf16 ulps, every mixed launch held to its plain version, a second run
   bitwise; per rank against one process: prefill and decode host and
   device ms, bytes and collectives, peak GiB, KV cache bytes; the mixed
   kernel timed at the rank's serve shapes; (g) tensor parallelism in
   the recurrent blocks, the encoder and cross-attention on (a)'s 2x2
   mesh against one process, full width: whisper-medium with the KAN
   drop-in (4 + 4 layers, bf16, 1500 frames, ``ck``/``cv``
   sequence-sharded), recurrentgemma-9b (one unit, bf16) and xlstm-125m
   (whole, at f32 and at its own bf16): train steps (2 replicated, and
   1 sp but at bf16 xlstm) within (a)'s loss bound, a prefill and 4
   decode steps within ``MESH_G_TOL`` -- bf16 xlstm's logits within
   twice, and its losses within (a)'s bound or twice, the distance of
   one process's bf16 run from the f32 run of the same weights,
   measured in the same run --, greedy tokens the argmax of the mesh's
   logits and one process's but at a checked tie (``_checked_ties``;
   not at bf16 xlstm), the replicated state the same bits on every
   ``model`` rank, every mixed fused-KAN and bf16 spline-basis launch
   held to its plain version, a timed serve run bitwise the held one;
   planted faults (one rank's partial dropped from whisper's
   cross-attention decode or encoder sums, ``_g_faults``) outside the
   bound; per rank against one
   process: host and kernel ms, bytes and collectives of each step, peak
   GiB, state and cache bytes; the mixed kernel and the spline basis at
   whisper's rank shapes.
16. the dry run held against the card (``dryrun_phase``,
   ``launch/dryrun``: one rank's step counted on the meta device): (a)
   phase 13's train step in one process, counted on the card and on
   meta: FLOPs, bytes, each kernel's counted launches (and
   ``_build.LAUNCHES``) and the argument bytes equal, argument + temp
   within ``DRYRUN_PEAK_TOL`` of the card's peak over the step, the
   card's memory ``dryrun.CARD_BYTES``; (b) phase 15's (a), (e) and (f)
   cells on an abstract 2x2 mesh for each rank: its collectives' calls
   and bytes and its argument bytes those it recorded on the card in
   phase 15, its predicted peak printed beside the measured one; (c)
   ``DRYRUN_CLIS``: the dry run of qwen2-0.5b decode_32k on both
   production meshes and of xlstm-125m long_500k, ``train --dry-run``,
   then ``roofline`` and ``report`` over their records, each exiting 0
   and printing its table.

No served path launches the spline-basis or v1 kernels, so their
``launches`` in the record are those of phases 6 and 5; the mixed
kernel's are phase 13 (b)'s.  The served rows
also carry ``launches_openloop``, their launches in phase 7's replays,
every row ``launches_train``, its launches in phase 8 (b)'s first
run of each arch, ``launches_paper``, its launches in phase 9's
runs of the paper scripts (Table I, the Fig. 8 sweep, Table II), and
``launches_kanffn``, its launches in phase 10 (b)'s three served runs,
``launches_moe``, its launches in phase 11 (a) and (b),
``launches_encdec``, its launches in phase 12 (a)-(c), and
``launches_lm_train``, its launches in phase 13 (a)-(d),
``launches_array``, its launches in phase 14's served runs, and
``launches_mesh``, rank 0's launches in phase 15 (a)'s first run and
(g)'s train steps, and ``launches_tp_serve``, rank 0's in phase 15 (f)'s
and (g)'s timed prefill and decode steps.

It prints the ``{"kernels": [...]}`` record, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.utils.deterministic as torch_det

# torch reads cuBLAS's workspace setting once, at its first product under
# deterministic algorithms (phase 9), and refuses one in phase 13's train
# steps unless it is one of cuBLAS's deterministic settings
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 on CUDA cores (no tensor cores)
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
# A bf16 activation times an f32 weight is three exact products of bf16
# values (the weight's three bf16 planes, kan_mma.cuh).
MIXED_PLANES = 3
KERNEL_TOL = 1e-5
SERVE_TOL = 1e-4
BF16_ULP = 2.0 ** -8          # one bf16 ulp of (1 + max|ref|)
# A served bf16 answer against the bf16 stack through the plain versions
# on the card: each layer's bf16 output may round one ulp apart, and the
# deepest served stack has three layers.
SERVE_TOL_BF16 = 3 * BF16_ULP
# phase 8: a gradient through the kernels' autograd Functions against
# autograd through the plain versions, a leaf at a time, within
# TRAIN_GRAD_TOL of the leaf's own max|plain| (the loss within it of its
# value); the first CPU_STEPS losses of a card run against a CPU run from
# the same params
TRAIN_GRAD_TOL = 1e-5
TRAIN_LOSS_TOL = 1e-4
TRAIN_STEPS = 200
CPU_STEPS = 10
# phase 9: the paper scripts at the aggregator's --fast epochs (Table I
# and Fig. 8's sweep; the Table II fine-tune runs its own default) and
# Table I's batch
PAPER_EPOCHS = 30
PAPER_BATCH = 512
FIG8_EPOCHS = 20
# phase 10: the KAN-FFN transformer's logits, kernels against their plain
# versions on the card (teacher-forced, the same tokens into both).  A
# token runs 24 kernel launches (a fused-KAN and a pattern-matmul in each
# of the 12 "kan" layers); each may differ from its plain version by its
# per-launch tolerance (f32: KERNEL_TOL; bf16: one ulp), everything else
# runs the same ops on the same inputs, and the residual stream carries
# each difference to the logits without growing it (at a reduced width
# over the same 24 layers, one ulp added to every element of every KAN-FFN
# output moves the logits by 3.6 ulps of 1 + max|logits|, not 12).  So
# 24 launch tolerances, of 1 + max|plain logits|:
TF_LAUNCHES = 24
TF_TOL_F32 = TF_LAUNCHES * KERNEL_TOL
TF_TOL_BF16 = TF_LAUNCHES * BF16_ULP
TF_ARCH = "qwen2-0.5b-kanffn"
TF_SLOTS = 8
TF_MAX_LEN = 128
TF_NEW_TOKENS = 16
TF_LAYER_M = (1, 3, 8, 16, 64)
# phase 11: MoE, RG-LRU and xLSTM archs at full width.  Depth is cut only
# where one card cannot hold the arch (None: whole).  A KAN-expert
# token's logits pass 2 MoE layers of 2 fused-KAN launches in series
# (each expert's up then down; a MoE output is a gate-weighted mean of
# expert outputs, no larger an error than its worst expert's), so 4
# launch tolerances of 1 + max|plain logits|, as phase 10 builds TF_TOL.
# One MoE layer against its plain version: its 2 launches in series, and
# at bf16 one more ulp for the combine's rounding.
MR_DEPTH = {"qwen3-moe-235b-a22b": 2, "llama4-scout-17b-a16e": 2,
            "recurrentgemma-9b": 6, "xlstm-125m": None}
MR_SLOTS = 8
MR_MAX_LEN = 64
MR_NEW_TOKENS = 16
MR_LAYER_T = (8, 64)
MOE_TF_LAUNCHES = 4
MOE_TF_TOL = {torch.float32: MOE_TF_LAUNCHES * KERNEL_TOL,
              torch.bfloat16: MOE_TF_LAUNCHES * BF16_ULP}
MOE_LAYER_TOL = {torch.float32: 2 * KERNEL_TOL,
                 torch.bfloat16: 3 * BF16_ULP}
# phase 12: the encoder-decoder and prefix-VLM archs at full width and
# depth, batches of ED_BATCH requests of ED_PROMPT tokens, ED_NEW_TOKENS
# decode steps.  A KAN drop-in's teacher-forced logits against the same
# model with every KAN FFN through its plain version on the card: the
# launches a token's logits pass in series, each within one launch's
# tolerance, as phase 10 builds TF_TOL.  whisper-medium: the encoder's
# 2 x 24 (every decoder block's cross-attention reads their memory) and
# the decoder's 2 x 24; paligemma-3b: 2 x 18.  A sum over launches in
# series is loose, so the same run also holds every launch to one
# launch's tolerance on the input it is served.
ED_BATCH = 8
ED_PROMPT = 16
ED_NEW_TOKENS = 16
ED_TF_LAUNCHES = {"whisper-medium": 2 * 24 + 2 * 24, "paligemma-3b": 2 * 18}
ED_TF_TOL = {name: {torch.float32: n * KERNEL_TOL,
                    torch.bfloat16: n * BF16_ULP}
             for name, n in ED_TF_LAUNCHES.items()}
# phase 13: LM training of qwen2-0.5b with the KAN drop-in at full width
# (896 -> 608 -> 896, kept bases 0, 2, 4, 5, 6), batches of LM_BATCH x
# LM_SEQ tokens.  A bf16 layer's gradient through the kernels against the
# same backward with the plain spline basis: the bases are bitwise the
# plain version's, so one ulp is margin.  The f32 twin: the kernel path's
# loss and gradients against the plain path's on the same params (the
# closed-form spline derivative against autograd of the recursion, and
# sums in other orders along 24 layers).  The restart runs at
# LM_RESTART_DEPTH layers (each checkpoint of the full state is 3.9 GB).
LM_ARCH = "qwen2-0.5b"
LM_SEQ, LM_BATCH, LM_STEPS = 128, 8, 8
LM_KB = (0, 2, 4, 5, 6)
LM_HIDDEN = 608
LM_LAYER_GRAD_ULPS = 1
LM_FIRST_LOSS_TOL = 0.5
LM_RESTART_DEPTH = 4
LM_F32_STEPS = 2
LM_XLSTM, LM_XLSTM_STEPS = "xlstm-125m", 2   # phase 13 (f)
LM_LOSS_RTOL = 1e-5
LM_GRAD_TOL = 1e-4
DECODE_TOL = 2e-3             # the reference's decode-vs-forward tolerance
CPU_TOL = 1e-4                # the port on the card against it on the CPU
ARCHS = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
BUCKETS = (2, 4, 8, 16)
BIG = 8192
DEVICE = "cuda"
ARRAY_CHIPS = 4               # phase 14: logical chips of one card
# phase 15: training and serving on a process mesh (``mesh_phase``): the
# ranks are processes of this script (``--mesh-worker``) that share the
# one card over gloo (NCCL refuses two ranks on one device).  (a) data
# parallelism with ZeRO-1 against one process: the loss of each step
# within the reference's sharded == dense bound, 1e-3 * (1 + |loss|).
MESH_DP = (2, 2)
MESH_STEPS = 3
MESH_COMP_STEPS = 2
MESH_LOSS_TOL = 1e-3
MESH_EP = (1, 4)
MESH_EP_ARCH = "qwen3-moe-235b-a22b"
MESH_EP_DEPTH = 2
MESH_EP_BATCH, MESH_EP_PROMPT, MESH_EP_NEW = 8, 16, 8
MESH_RESTORE_RANKS = (1, 2)    # (d) on ranks of (a)'s spawn, then 1x1
# (f) tensor-parallel serve steps on (a)'s 2x2 mesh, (a)'s model and
# draw: a prefill of 8 x 1024 tokens (4 rows a data rank; 1040 slots, 520
# a model rank), then decode steps teacher-forced on one process's
# tokens; the logits within the launches a token's logits pass in series
# (2 a layer), each one bf16 ulp, as phase 12 builds ED_TF_TOL
MESH_TP_BATCH, MESH_TP_PROMPT, MESH_TP_NEW = 8, 1024, 8
# (g) tensor parallelism in the recurrent blocks, the encoder and
# cross-attention on (a)'s 2x2 mesh, against one process: whisper-medium
# with the KAN drop-in (bf16, f32 t, 1500 frames), recurrentgemma-9b and
# xlstm-125m at full width; depth cut to keep (g) short (whisper 4 + 4
# of 24 + 24 layers, recurrentgemma one (rec, rec, attn) unit of 38
# layers, xlstm whole); recurrentgemma's loss in one chunk (a rank's 128
# positions' logits are 65 MB; each of four chunks would widen its half
# of the 256000 x 4096 table to f32 and keep it for the backward).
# xlstm-125m runs twice.  At f32 ("xlstm") the mesh's sums in another
# order stay at f32 rounding, so a tight bound holds its TP path.  At its
# own bf16 ("xlstm-bf16") its exponential gates turn the bf16 roundings
# that the mesh's products flip (its gates' columns are a product of
# another width) into ~11 bf16 ulps of its logits and 0.0115 of its
# second loss (H100 80GB HBM3, 700 W), past an ulp count a layer; so it is
# held to its own rounding, measured in the same run (a witness): one
# process's bf16 run against the f32 run of the same weights (its bf16
# draw widened).  Two bf16 runs of one function, each within the
# witness's distance of the f32 run, lie within twice it of each other:
# the mesh's bf16 logits within 2 x the witness's largest logit gap, its
# losses within (a)'s bound or 2 x the witness's loss gap of the step,
# whichever is larger.  MESH_G_STEPS: (train steps replicated, steps with
# activation_mode="sp"), then a prefill of MESH_G_BATCH x MESH_G_PROMPT
# tokens and MESH_G_NEW decode steps fed seeded tokens, held, and again
# timed.  MESH_G_PROFILED: what the profiler measures of each (the last
# replicated step, the sp step, the timed serve run); xlstm's profiled
# train step takes 30-37 s of host time, so its sp step and the bf16
# run are timed on the host only.  Serve logits within the roundings a
# token passes in series that the mesh sums in another order -- each
# tensor-parallel sub-layer's output, one ulp (bf16, or KERNEL_TOL at
# f32) -- twice over, as (f) builds its bound: whisper 4 x 2 (encoder) +
# 4 x 3 (decoder), recurrentgemma 3 x 2, xlstm's 6 mLSTM blocks.
# MESH_G_WITNESS: the archs whose one process also runs the f32 witness
# (whisper-kan's serve steps only, reported beside its bound).  Faults
# planted in each run (``_g_faults``: model rank 1's partial dropped from
# the sums over model of whisper-kan's cross-attention decode steps, or
# of its encoder) must leave its bound.
MESH_G_BATCH, MESH_G_SEQ, MESH_G_PROMPT, MESH_G_NEW = 4, 64, 64, 4
MESH_G_STEPS = {"rgemma": (2, 1), "whisper-kan": (2, 1), "xlstm": (2, 1),
                "xlstm-bf16": (2, 0)}
MESH_G_PROFILED = {"rgemma": ("replicated", "sp", "serve"),
                   "whisper-kan": ("replicated", "sp", "serve"),
                   "xlstm": ("replicated", "serve"), "xlstm-bf16": ()}
MESH_G_TOL = {"whisper-kan": 2 * (4 * 2 + 4 * 3) * BF16_ULP,
              "rgemma": 2 * 3 * 2 * BF16_ULP, "xlstm": 2 * 6 * KERNEL_TOL}
MESH_G_WITNESS = ("whisper-kan", "xlstm-bf16")
MESH_SPAWN_S = 600
MESH_DEV = "cuda:0"
MESH_GIB = 60.0               # the four ranks' peaks together on the card
# phase 16: the dry run (``launch/dryrun``, the step counted on meta) held
# against the card.  (a) phase 13's train step in one process: the
# counts on the card and on meta equal, argument + temp within
# DRYRUN_PEAK_TOL of the card's peak (reset before the step, less what
# the process held before it built the step's inputs); (b) phase 15's
# (a), (e) and (f) cells on an abstract 2x2 mesh, each rank's
# collectives and argument bytes those it recorded on the card; (c) the
# CLIs on production cells, then roofline and report over their records.
# The meta counts run in DRYRUN_WORKERS processes of this script and the
# CLIs in a thread while (a) runs on the card.
DRYRUN_PEAK_TOL = 0.10
DRYRUN_WORKERS = ("one", "0", "1", "2", "3")
DRYRUN_WORKER_S = 300
DRYRUN_CLIS = (
    ["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b", "--shape",
     "decode_32k", "--mesh", "both"],
    ["-m", "repro_torch.launch.dryrun", "--arch", "xlstm-125m", "--shape",
     "long_500k", "--mesh", "single"],
    ["-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b", "--shape",
     "decode_32k", "--dry-run"],
    ["-m", "repro_torch.benchmarks.roofline"],
    ["-m", "repro_torch.benchmarks.report"],
)

KERNEL_INFO = {
    "kan_fused_v2": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:284",
    },
    "pattern_matmul": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul.cu"),
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:119",
    },
    "kan_fused_v2_q8": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_q8.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:338",
    },
    "pattern_matmul_q8": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul_q8.cu"),
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:79",
    },
    "spline_basis": {
        "source": ("src/repro_torch/kernels/spline_basis/csrc/"
                   "spline_basis.cu"),
        "headers": ["src/repro_torch/kernels/spline_basis/csrc/"
                    "spline_basis.cuh"],
        "replaces": "src/repro/kernels/spline_basis/spline_basis.py:68",
    },
    "kan_fused_v1": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_v1.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:227",
    },
    "kan_fused_v2_bf16": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_bf16.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_mma.cuh",
                    "src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh",
                    "src/repro_torch/kernels/pattern_matmul/csrc/"
                    "mma_bf16.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:284",
    },
    "pattern_matmul_bf16": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul_bf16.cu"),
        "headers": ["src/repro_torch/kernels/pattern_matmul/csrc/"
                    "mma_bf16.cuh"],
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:119",
    },
    "spline_basis_bf16": {
        "source": ("src/repro_torch/kernels/spline_basis/csrc/"
                   "spline_basis_bf16.cu"),
        "headers": ["src/repro_torch/kernels/spline_basis/csrc/"
                    "spline_basis.cuh",
                    "src/repro_torch/kernels/kan_fused/csrc/kan_fused.cuh"],
        "replaces": "src/repro/kernels/spline_basis/spline_basis.py:68",
    },
    "kan_fused_v1_bf16": {
        "source": ("src/repro_torch/kernels/kan_fused/csrc/"
                   "kan_fused_v1_bf16.cu"),
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_mma.cuh",
                    "src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh",
                    "src/repro_torch/kernels/pattern_matmul/csrc/"
                    "mma_bf16.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:227",
    },
    # a bf16 x against f32 fused rows: a bf16 model's, whose spline
    # coefficients t are f32 as the reference's kan_init draws them; the
    # rows split into three bf16 planes on the tensor-core body
    "kan_fused_v2_mixed": {
        "source": ("src/repro_torch/kernels/kan_fused/csrc/"
                   "kan_fused_mixed.cu"),
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_mma.cuh",
                    "src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh",
                    "src/repro_torch/kernels/pattern_matmul/csrc/"
                    "mma_bf16.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:284",
    },
}
F32_KERNELS = ("kan_fused_v2", "pattern_matmul")
Q8_KERNELS = ("kan_fused_v2_q8", "pattern_matmul_q8")
TOOLING_KERNELS = ("spline_basis", "kan_fused_v1")
BF16_KERNELS = ("kan_fused_v2_bf16", "pattern_matmul_bf16")
BF16_TOOLING_KERNELS = ("spline_basis_bf16", "kan_fused_v1_bf16")
MIXED = "kan_fused_v2_mixed"     # bf16 x, f32 weights, bf16 or f32 out
PRECISIONS = ("f32", "int8", "bf16")
SERVED_KERNELS = {"f32": F32_KERNELS, "int8": Q8_KERNELS,
                  "bf16": BF16_KERNELS}    # (KAN, matmul) per precision
DTYPE = {k: "bfloat16" if k.endswith("_bf16") else
         "int8" if k.endswith("_q8") else "float32" for k in KERNEL_INFO}
DTYPE[MIXED] = "bfloat16 x, float32 weights"
BF, F32 = torch.bfloat16, torch.float32
SUFFIX = {F32: "", BF: "_bf16"}            # kernel name by operand dtype


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def mixed_macs(flops: float) -> tuple:
    """(operations, rate) of ``flops`` of multiply-adds of bf16
    activations with f32 weights, whichever implements them: the cheaper
    of f32 FMAs on CUDA cores and three bf16-plane products on tensor
    cores."""
    return min(((flops, F32_FLOPS_PER_S),
                (MIXED_PLANES * flops, BF16_FLOPS_PER_S)),
               key=lambda w: w[0] / w[1])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max abs error, allowed-scale 1 + max|ref|, any NaN)."""
    got, ref = got.float(), ref.float()       # bf16: the error in f32
    nan = bool(torch.isnan(got).any() or torch.isnan(ref).any())
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = 1.0 + (float(ref.abs().max()) if ref.numel() else 0.0)
    return err, scale, nan


def host_ms(fn, iters: int = 50, reps: int = 7) -> float:
    """Median over ``reps`` of the mean host wall time of ``iters`` calls
    of ``fn``, which must end in a synchronising copy to the host."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def kan_layer_rows(x: torch.Tensor, wt: torch.Tensor, spec, kb: tuple,
                   prec: str, card: str, layer: str, launches: int,
                   basis_launches: int = 0, out_dtype=None) -> list:
    """Rows of times and bounds of one KAN layer's kernels on the card at
    the layer's operands: the fused-KAN forward (``kan_fused_v2``; the
    mixed kernel for a bf16 x against f32 rows; ``out_dtype`` out, x's
    dtype by default) and, with ``basis_launches``, the spline basis of
    its clipped input (order K, x's dtype); each with its plain
    version's time and its bound.  Also printed, a JSON line each."""
    from repro_torch.benchmarks.kernel_ab import graph_ms, time_ms
    from repro_torch.core.splines import locate_cell, spu_op_count
    from repro_torch.kernels.kan_fused import ops as KO
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.kernels.spline_basis.ops import spline_basis
    from repro_torch.kernels.spline_basis.ref import spline_basis_plain

    M, n_in = x.shape
    n_out = wt.shape[-1]
    dt, dev = x.dtype, x.device
    kname = (MIXED if prec == "mixed" else "kan_fused_v2" + SUFFIX[dt])
    cell = locate_cell(spec.clip(x), spec)[0].long()
    kept = torch.tensor(
        [len(set(range(c, c + spec.n_active)) & set(kb))
         for c in range(spec.grid_size)], device=dev)
    hits = int(kept[cell].sum())
    esz = 2.0 if dt == BF else 4.0
    # bf16 products on tensor cores, the f32 kernel's FMAs on CUDA
    # cores, the mixed kernel's at the cheaper of the two ways
    # (mixed_macs)
    macs = 2.0 * n_out * (M * n_in + hits)
    slot_of = KO.slot_table(kb, spec.n_bases, dev)
    out_esz = esz if out_dtype in (None, dt) else 4.0
    n_bytes = (esz * x.numel() + out_esz * M * n_out
               + wt.element_size() * wt.numel() + 4.0 * slot_of.numel())
    work = [mixed_macs(macs) if prec == "mixed" else
            (macs, BF16_FLOPS_PER_S if prec == "bf16" else F32_FLOPS_PER_S),
            (M * n_in * (spu_op_count(spec) + 4), F32_FLOPS_PER_S)]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / rt for n, rt in work) * 1e3
    xc = spec.clip(x)

    def kern():
        return KO.kan_fused_v2(x, wt, spec, kb, slot_of, out_dtype=out_dtype)

    def kplain():
        return kan_fused_v2_ref(x, wt, spec, kb, out_dtype)

    def basis():
        return spline_basis(xc, spec)

    def bplain():
        return spline_basis_plain(xc.reshape(-1), spec).reshape(
            *xc.shape, spec.n_bases)

    rows = []
    with torch.no_grad():
        rows.append({
            "kernel": kname, "layer": layer, "shape": [M, n_in, n_out],
            "nbk": len(kb), "precision": prec,
            "out_dtype": str(out_dtype or dt).replace("torch.", ""),
            "ms": time_ms(kern, iters=10, reps=5),
            "device_ms": graph_ms(kern, iters=5, reps=5),
            "plain_ms": time_ms(kplain, iters=3, reps=3),
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kept_basis_hits": hits, "launches_a_step": launches,
            "card": card})
        print(json.dumps(rows[-1]))
        if basis_launches:
            n = xc.numel()
            s_bytes = esz * (n + n * spec.n_bases)
            s_ops = n * (spu_op_count(spec) + 4) / F32_FLOPS_PER_S
            s_bytes_ms = s_bytes / HBM_BYTES_PER_S * 1e3
            rows.append({
                "kernel": "spline_basis" + SUFFIX[dt], "layer": layer,
                "shape": [n, spec.n_bases], "precision": prec,
                "ms": time_ms(basis, iters=10, reps=5),
                "device_ms": graph_ms(basis, iters=5, reps=5),
                "plain_ms": time_ms(bplain, iters=3, reps=3),
                "library_ms": None,
                "bound_ms": max(s_bytes_ms, s_ops * 1e3),
                "bound_by": ("bytes" if s_bytes_ms >= s_ops * 1e3
                             else "operations"),
                "launches_a_step": basis_launches, "card": card})
            print(json.dumps(rows[-1]))
    return rows


def kanffn_phase(dev: torch.device, card: str) -> dict:
    """Phase 10: ``qwen2-0.5b-kanffn`` served at full width on the card.

    (a) one KAN-FFN layer at the arch's widths (896 -> 1080 -> 896), bf16
    and f32, dense and with layer 0's calibrated masks, at M in
    ``TF_LAYER_M``: one fused-KAN and one pattern-matmul launch a call,
    each kernel within its per-launch tolerance of its plain version on
    the same input, the layer bitwise its two kernels;
    (b) the whole model through ``Server`` (``TF_SLOTS`` slots,
    ``TF_MAX_LEN``), 8 seeded requests of 3-15 tokens, ``TF_NEW_TOKENS``
    new tokens each, in bf16 and as its f32 twin: 12 + 12 launches a
    prefill and a decode step; teacher-forced, the kernels' logits are the
    served tokens' argmax and within ``TF_TOL_*`` of the plain versions'
    (whose argmax is the served token wherever its top-2 margin exceeds
    that); batched == single, token-exact, at the same slots;
    (c) ``calibrate_kanffn_masks`` on the card from a seeded 4x64 batch
    at keep 2 of 4: the masks equal a calibration through the plain
    versions, a group apart only where its saliencies sit closer than
    the two calibrations differ; the masked model served and held as in
    (b); its simulated cycles below the dense model's;
    (d) the launcher in a subprocess at f32 and bf16 (``--scale full``):
    its simulated cycles the cycle model's on the host;
    (e) times: a decode step at 8 slots (host wall, device from a CUDA
    graph, idle share, the 24 kernel launches' device time and share),
    a prefill, and the two kernels at the decode shape;
    (f) the ``kanffn:kanffn-ci`` serving-bench row on the card.
    Returns what it measured; raises on any fault."""
    from repro_torch.benchmarks import serving_bench
    from repro_torch.benchmarks.kernel_ab import graph_ms, layer_calls, time_ms
    from repro_torch.configs.registry import KANFFN_ARCHS
    from repro_torch.core.calibrate import (
        calibrate_kanffn_masks,
        kan_basis_saliency,
        kanffn_saliencies,
        mlp_input_saliency,
    )
    from repro_torch.core.engine import VikinHW, serving_report
    from repro_torch.core.sparsity import GROUP, magnitude_mask
    from repro_torch.core.splines import locate_cell, spu_op_count
    from repro_torch.kernels import _build
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.models import transformer as TF
    from repro_torch.models.ffn import KanFFN
    from repro_torch.runtime.backends import (
        splice_cache,
        transformer_layer_works,
    )
    from repro_torch.runtime.server import Server
    from repro_torch.utils import host_f32, leaf_paths, tree_map

    t_phase = time.perf_counter()
    cfg_b = KANFFN_ARCHS[TF_ARCH]
    cfg_f = dataclasses.replace(cfg_b, dtype="float32")
    n_kan = cfg_b.ffn_kinds.count("kan")
    t0 = time.perf_counter()
    params_f = TF.init_params(cfg_f, torch.Generator().manual_seed(0), dev)
    params_b = tree_map(lambda a: a.to(BF), params_f)
    n_params = sum(int(a.numel()) for _, a in leaf_paths(params_b))
    print(f"phase 10: {TF_ARCH} at full width: {cfg_b.n_layers} layers, d "
          f"{cfg_b.d_model}, {cfg_b.n_heads} heads ({cfg_b.n_kv_heads} KV), "
          f"d_ff {cfg_b.d_ff}, vocab {cfg_b.vocab_size}, {n_kan} kan FFNs "
          f"(hidden {cfg_b.ffn_cfg(0).kanffn_hidden}); {n_params} params, "
          f"drawn on the host and moved in "
          f"{time.perf_counter() - t0:.2f} s")
    kernels = {F32: ("kan_fused_v2", "pattern_matmul"),
               BF: ("kan_fused_v2_bf16", "pattern_matmul_bf16")}
    tol_layer = {F32: KERNEL_TOL, BF: BF16_ULP}
    tol_model = {F32: TF_TOL_F32, BF: TF_TOL_BF16}

    def launches_only(want: dict, what: str) -> dict:
        got = dict(_build.LAUNCHES)
        full = {k: want.get(k, 0) for k in got}
        check(got == full, f"(phase 10) {what}: launches {got}, want {full}")
        return got

    def plain_ffns(ffns: list) -> list:
        """The KAN-FFN layers of ``ffns`` through the plain versions of
        their two kernels, on the card."""
        def one(f):
            def fn(x):
                h = layer_calls(f.up, x.reshape(-1, x.shape[-1])
                                .contiguous())[3]()
                return layer_calls(f.down, h)[3]().reshape(
                    *x.shape[:-1], -1)
            return fn
        return [None if f is None else one(f) for f in ffns]

    # (c), first half: the masks, calibrated on the card and through the
    # plain versions
    calib = np.random.default_rng(10).integers(
        0, cfg_b.vocab_size, size=(4, 64)).astype(np.int32)
    _build.reset_launches()
    masks = calibrate_kanffn_masks(params_b, cfg_b, calib, keep_per_group=2)
    torch.cuda.synchronize()
    launches_only({"kan_fused_v2_bf16": n_kan, "pattern_matmul_bf16": n_kan,
                   "kan_fused_v2": n_kan},
                  "calibrate_kanffn_masks (the dense bf16 forward, then the "
                  "f32 up-projection a kan layer)")
    sal_k = kanffn_saliencies(params_b, cfg_b, calib)
    ffns_dense = TF.ffn_modules(params_b, cfg_b)
    taps: dict = {}
    with torch.no_grad():
        TF.forward(params_b, cfg_b, torch.as_tensor(calib, device=dev),
                   ffn_taps=taps, ffns=plain_ffns(ffns_dense))
    ties, n_groups = [], 0
    for i, kind in enumerate(cfg_b.ffn_kinds):
        if kind != "kan":
            check(masks[i] is None, f"(c) layer {i} ({kind}) got a mask")
            continue
        f = ffns_dense[i]
        tap = taps[i].reshape(-1, cfg_b.d_model)
        s1 = kan_basis_saliency(params_b["extra"][i]["ffn"]["kan_up"],
                                f.up.cfg.spec, host_f32(tap))
        hid = kan_fused_v2_ref(tap.float(), f.up.wt.float(), f.up.cfg.spec,
                               f.up.kb)
        s2 = mlp_input_saliency(params_b["extra"][i]["ffn"], host_f32(hid))
        for stage, sp, sk, keep in zip(("basis", "hidden"), (s1, s2),
                                       sal_k[i], masks[i]):
            got = np.zeros(sp.shape[0], bool)
            got[list(keep)] = True
            want = magnitude_mask(sp, 2).keep
            for g in range(0, (sp.shape[0] // GROUP) * GROUP, GROUP):
                n_groups += 1
                sl = slice(g, g + GROUP)
                if np.array_equal(got[sl], want[sl]):
                    continue
                moved = np.abs(sk[sl] - sp[sl]).max()
                swap = [j for j in range(g, g + GROUP) if got[j] != want[j]]
                gap = float(np.ptp(sp[swap]))
                ties.append({"layer": i, "stage": stage, "group": g // GROUP,
                             "plain": sp[sl].tolist(), "card": sk[sl].tolist(),
                             "gap": gap, "moved": float(moved)})
                print(f"phase 10: (c) layer {i} {stage} group {g // GROUP}: "
                      f"kept {np.nonzero(got[sl])[0].tolist()} on the card, "
                      f"{np.nonzero(want[sl])[0].tolist()} through the plain "
                      f"versions; saliencies {sp[sl].tolist()} (plain) vs "
                      f"{sk[sl].tolist()}: the swapped pair {gap:.3e} apart, "
                      f"the calibrations up to {moved:.3e}")
                check(gap <= 2.0 * moved,
                      f"(c) layer {i} {stage} group {g // GROUP}: the masks "
                      f"differ beyond a saliency tie ({gap:.3e} > 2 x "
                      f"{moved:.3e})")
    print(f"phase 10: (c) calibrate_kanffn_masks on the card: {n_kan} layers, "
          f"keep 2 of 4 bases ({len(masks[0][0])} of "
          f"{f.up.cfg.spec.n_bases} kept) and hidden lanes "
          f"({len(masks[0][1])} of {cfg_b.ffn_cfg(0).kanffn_hidden}); "
          f"{len(ties)} of {n_groups} groups apart from the plain "
          f"calibration, each at a tie")

    # (a) one KAN-FFN layer at the arch's widths
    gen = torch.Generator().manual_seed(12)
    layer_err = {}
    for dt, params in ((BF, params_b), (F32, params_f)):
        kan_k, mm_k = kernels[dt]
        for label, fcfg in (("dense", cfg_b.ffn_cfg(0)),
                            ("masked", dataclasses.replace(
                                cfg_b.ffn_cfg(0), basis_keep=masks[0][0],
                                hidden_keep=masks[0][1]))):
            f = KanFFN(fcfg, params["extra"][0]["ffn"])
            errs = []
            for m in TF_LAYER_M:
                x = torch.randn((m, cfg_b.d_model), generator=gen).to(dev, dt)
                _build.reset_launches()
                with torch.no_grad():
                    y = f(x)
                torch.cuda.synchronize()
                launches_only({kan_k: 1, mm_k: 1},
                              f"(a) {label} {dt} layer at M={m}")
                _, _, up_k, up_p = layer_calls(f.up, x)
                h = up_k()
                _, _, down_k, down_p = layer_calls(f.down, h)
                check(torch.equal(y, down_k()),
                      f"(a) {label} {dt} M={m}: the layer is not its two "
                      f"kernels, bitwise")
                for what, got, ref in (("up", h, up_p()), ("down", y,
                                                           down_p())):
                    err, scale, nan = rel_err(got, ref)
                    check(not nan and err <= tol_layer[dt] * scale,
                          f"(a) {label} {dt} M={m} {what}: max|kernel - "
                          f"plain| = {err:.3e} vs {tol_layer[dt]:g} * "
                          f"{scale:.4g}")
                    errs.append(err / scale)
            layer_err[f"{label} {'bf16' if dt == BF else 'f32'}"] = max(errs)
    print(f"phase 10: (a) one KAN-FFN layer 896->1080->896 at M = "
          f"{list(TF_LAYER_M)}: one {kernels[BF][0]} / {kernels[F32][0]} and "
          f"one {kernels[BF][1]} / {kernels[F32][1]} a call; each kernel "
          f"within its tolerance of its plain version (max err / (1 + max): "
          + ", ".join(f"{k} {v:.2e}" for k, v in layer_err.items()) + ")")

    # (b) and (c): the whole model through Server
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg_b.vocab_size,
                            size=int(rng.integers(3, 16))).astype(np.int32)
               for _ in range(TF_SLOTS)]

    def serve(cfg, params, masks_, what: str) -> tuple:
        srv = Server(cfg, params, n_slots=TF_SLOTS, max_len=TF_MAX_LEN,
                     masks=masks_, device=DEVICE)
        rids = [srv.submit(p, max_new_tokens=TF_NEW_TOKENS) for p in prompts]
        _build.reset_launches()
        t0 = time.perf_counter()
        out = srv.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dt = srv.backend.params["embed"]["table"].dtype
        n = n_kan * (len(prompts) + int(srv.stats["ticks"]))
        got = launches_only({k: n for k in kernels[dt]}, f"(b) {what} served")
        return srv, [out[r] for r in rids], got, wall

    def teacher(srv, toks: list, ffns: list) -> tuple:
        """Prefill each prompt into its own lane, then decode the served
        tokens in lockstep: (prefill logits (8, V), [step logits (8, V)])."""
        be = srv.backend
        caches = TF.init_caches(be.cfg, TF_SLOTS, TF_MAX_LEN, dev)
        pre, steps = [], []
        with torch.no_grad():
            for s, p in enumerate(prompts):
                lg, c = TF.prefill(be.params, be.cfg,
                                   torch.as_tensor(p[None], device=dev),
                                   max_len=TF_MAX_LEN, ffns=ffns)
                pre.append(lg[:, -1])
                caches = splice_cache(caches, c, s)
            for t in range(TF_NEW_TOKENS - 1):
                tok = torch.as_tensor(np.array([[g[t]] for g in toks],
                                               np.int32), device=dev)
                lg, caches = TF.decode_step(be.params, be.cfg, tok, caches,
                                            ffns=ffns)
                steps.append(lg[:, -1])
        return torch.cat(pre), steps

    def hold(srv, toks: list, what: str) -> dict:
        be = srv.backend
        dt = be.params["embed"]["table"].dtype
        tol = tol_model[dt]
        pre_k, steps_k = teacher(srv, toks, be.ffns)
        pre_p, steps_p = teacher(srv, toks, plain_ffns(be.ffns))
        served = torch.as_tensor(np.array(toks), device=dev)     # (8, 16)
        worst, forced = 0.0, 0
        for t, (lk, lp) in enumerate(zip([pre_k, *steps_k],
                                         [pre_p, *steps_p])):
            check(torch.equal(lk.argmax(-1), served[:, t].long()),
                  f"(b) {what} step {t}: the teacher-forced kernel logits' "
                  f"argmax is not the served token")
            err, scale, nan = rel_err(lk, lp)
            check(not nan and err <= tol * scale,
                  f"(b) {what} step {t}: max|kernel - plain| logits "
                  f"{err:.3e} vs {tol:g} * {scale:.4g}")
            worst = max(worst, err / scale)
            top2 = lp.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol * scale
            same = lp.argmax(-1) == served[:, t].long()
            check(bool((same | ~clear).all()),
                  f"(b) {what} step {t}: the plain argmax differs from the "
                  f"served token where the top-2 margin exceeds {tol:g}")
            forced += int((~clear).sum())
        return {"max_err_over_scale": worst, "tol": tol,
                "near_ties": forced}

    def batched_equals_single(cfg, params, masks_, batched: list,
                              what: str) -> None:
        srv1 = Server(cfg, params, n_slots=TF_SLOTS, max_len=TF_MAX_LEN,
                      masks=masks_, device=DEVICE)
        for i, p in enumerate(prompts):
            rid = srv1.submit(p, max_new_tokens=TF_NEW_TOKENS)
            check(srv1.run_until_done()[rid] == batched[i],
                  f"(b) {what}: request {i} batched != single")

    served = {}
    for what, cfg, params, masks_ in (
            ("bf16", cfg_b, params_b, None),
            ("bf16 masked", cfg_b, params_b, masks),
            ("f32 twin", cfg_f, params_f, None)):
        srv, toks, got, wall = serve(cfg, params, masks_, what)
        held = hold(srv, toks, what)
        if what != "f32 twin":
            batched_equals_single(cfg, params, masks_, toks, what)
        rep = serving_report(srv.backend.layers, srv.backend.hw, batch=1,
                             precision=srv.backend.precision)
        served[what] = {"srv": srv, "launches": got, "wall_s": wall,
                        "ticks": int(srv.stats["ticks"]), **held,
                        "sim_cycles_per_instance": rep["sim_cycles"]}
        print(f"phase 10: (b) {what}: {len(prompts)} requests x "
              f"{TF_NEW_TOKENS} tokens on {TF_SLOTS} slots in "
              f"{served[what]['ticks']} decode steps, wall {wall:.3f} s; "
              f"launches {dict((k, v) for k, v in got.items() if v)}; "
              f"teacher-forced logits within {held['tol']:g} (max "
              f"{held['max_err_over_scale']:.3e} of 1 + max|plain|), "
              f"{held['near_ties']} near-tie positions"
              + ("" if what == "f32 twin" else "; batched == single"))
    dense_c = served["bf16"]["sim_cycles_per_instance"]
    masked_c = served["bf16 masked"]["sim_cycles_per_instance"]
    check(masked_c < dense_c, f"(c) masked serving's simulated cycles "
          f"{masked_c} are not below the dense model's {dense_c}")
    print(f"phase 10: (c) simulated cycles an instance: masked {masked_c:.1f} "
          f"< dense {dense_c:.1f}")

    # (d) the launcher in a subprocess, at full width
    launcher = {}
    for prec in ("f32", "bf16"):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               TF_ARCH, "--scale", "full", "--requests", "4",
               "--new-tokens", "8", "--precision", prec]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600,
                             env=dict(os.environ, PYTHONPATH=str(SRC)))
        secs = time.perf_counter() - t0
        check(run.returncode == 0, f"(d) the launcher at {prec} exited "
              f"{run.returncode}: {run.stderr[-2000:]}")
        check("kan-ffn hybrid" in run.stdout
              and "simulated VIKIN" in run.stdout,
              f"(d) the launcher at {prec} printed no kan-ffn lines")
        line = next(ln for ln in run.stdout.splitlines()
                    if ln.startswith("simulated VIKIN:"))
        printed = float(line.split()[2])
        lrng = np.random.default_rng(0)
        tokens_in = 0
        for _ in range(4):
            n = int(lrng.integers(3, 16))
            lrng.integers(0, cfg_b.vocab_size, size=n)
            tokens_in += n
        instances = tokens_in + 4 * (8 - 1)
        want = instances * serving_report(
            transformer_layer_works(cfg_b), VikinHW(), batch=1,
            precision=prec)["sim_cycles"]
        check(abs(printed - want) <= 1.0,
              f"(d) the launcher at {prec}: {printed:.0f} simulated cycles, "
              f"the host's cycle model {want:.1f}")
        launcher[prec] = {"seconds": secs, "sim_cycles": printed,
                          "host_cycles": want}
        print(f"phase 10: (d) launcher --precision {prec}: exit 0 in "
              f"{secs:.1f} s, {printed:.0f} simulated cycles = the host's "
              f"cycle model ({instances} instances); | {line}")

    # (e) times, bf16 at 8 slots
    srv = served["bf16"]["srv"]
    be = srv.backend
    toks8 = torch.as_tensor(np.array(
        [[p[0]] for p in prompts], np.int32), device=dev)
    with torch.no_grad():
        caches = TF.init_caches(be.cfg, TF_SLOTS, TF_MAX_LEN, dev)
        for s, p in enumerate(prompts):
            _, c = TF.prefill(be.params, be.cfg,
                              torch.as_tensor(p[None], device=dev),
                              max_len=TF_MAX_LEN, ffns=be.ffns)
            caches = splice_cache(caches, c, s)

        def step():
            return TF.decode_step(be.params, be.cfg, toks8, caches,
                                  ffns=be.ffns)[0]

        step()
        step_host = host_ms(lambda: TF.greedy_token(step()).cpu(), iters=10,
                            reps=5)
        step_dev = graph_ms(step, iters=2, reps=5)
        xs = [torch.randn((TF_SLOTS, cfg_b.d_model), generator=gen)
              .to(dev, BF) for _ in be.ffns]
        calls = []
        for f, x in zip(be.ffns, xs):
            if f is None:
                continue
            calls.append(layer_calls(f.up, x)[2])
            calls.append(layer_calls(f.down, calls[-1]())[2])
        torch.cuda.synchronize()
        kern_dev = graph_ms(lambda: [c() for c in calls], iters=2, reps=5)
        prefill_host = host_ms(lambda: TF.prefill(
            be.params, be.cfg, torch.as_tensor(prompts[0][None], device=dev),
            max_len=TF_MAX_LEN, ffns=be.ffns)[0].cpu(), iters=3, reps=5)
        # where a decode step's time goes, by op: device time from the
        # profiler's CUDA activity (CUPTI), host time by torch op
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            TF.greedy_token(step()).cpu()
        ops = prof.key_averages()
        # device rows: the kernels themselves (an aten op's row repeats
        # the device time of the kernels it launched)
        kern = sorted((e for e in ops
                       if str(getattr(e, "device_type", "")).endswith("CUDA")),
                      key=lambda e: -_device_us(e))
        by_host = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
        profile = {
            "device_us_total": sum(_device_us(e) for e in kern),
            "kernel_launches": sum(e.count for e in kern),
            "top_device": [(e.key[:72], _device_us(e), e.count)
                           for e in kern[:8]],
            "top_host_self": [(e.key[:72], e.self_cpu_time_total, e.count)
                              for e in by_host]}
    print("phase 10: (e) a decode step profiled: "
          f"{profile['kernel_launches']} kernels, "
          f"{profile['device_us_total']:.1f} us of device time; by kernel "
          + ", ".join(f"{k} {us:.1f} us x{n}"
                      for k, us, n in profile["top_device"])
          + "; by host self time "
          + ", ".join(f"{k} {us:.1f} us x{n}"
                      for k, us, n in profile["top_host_self"]))
    times = {"decode_step_host_ms": step_host,
             "decode_step_device_ms": step_dev,
             "device_idle_share": 1.0 - step_dev / step_host,
             "kernels_device_ms": kern_dev, "kernel_launches": len(calls),
             "kernels_share_of_step": kern_dev / step_dev,
             "prefill_host_ms": prefill_host,
             "prefill_tokens": int(prompts[0].shape[0]),
             "profile": profile, "card": card}
    print(f"phase 10: (e) a decode step at {TF_SLOTS} slots (bf16): host "
          f"{step_host:.3f} ms, device {step_dev:.4f} ms (idle "
          f"{times['device_idle_share'] * 100:.1f}%); its {len(calls)} "
          f"kernel launches {kern_dev:.4f} ms on the device "
          f"({times['kernels_share_of_step'] * 100:.1f}% of the step); a "
          f"{prompts[0].shape[0]}-token prefill {prefill_host:.3f} ms host "
          f"({card})")

    # the two kernels at the decode shape (bf16, M = 8), layer 0, dense
    f = be.ffns[0]
    x = xs[0]
    spec, n_in, n_out = f.up.cfg.spec, f.up.cfg.n_in, f.up.cfg.n_out
    _, _, up_k, up_p = layer_calls(f.up, x)
    h = up_k()
    _, hc, down_k, down_p = layer_calls(f.down, h)
    kc, n = f.down.w_c.shape
    cell, _ = locate_cell(spec.clip(x.float()), spec)
    slots = f.up.slot_of.long()
    hits = sum(int((slots[(cell + j).long()] >= 0).sum())
               for j in range(spec.n_active))
    rows = []
    for name, kern, plain, library, n_bytes, work in (
            (kernels[BF][0], up_k, up_p, None,
             2.0 * (x.numel() + f.up.wt.numel() + TF_SLOTS * n_out)
             + 4.0 * f.up.slot_of.numel(),
             [(2.0 * n_out * (TF_SLOTS * n_in + hits), BF16_FLOPS_PER_S),
              (TF_SLOTS * n_in * (spu_op_count(spec) + 4), F32_FLOPS_PER_S)]),
            (kernels[BF][1], down_k, down_p,
             lambda: torch.addmm(f.down.b, hc, f.down.w_c),
             2.0 * (hc.numel() + f.down.w_c.numel() + n + TF_SLOTS * n),
             [(2.0 * TF_SLOTS * kc * n, BF16_FLOPS_PER_S),
              (TF_SLOTS * n, F32_FLOPS_PER_S)])):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = sum(o / r for o, r in work) * 1e3
        rows.append({
            "kernel": name, "model": TF_ARCH, "precision": "bf16",
            "batch": TF_SLOTS, "ms": time_ms(kern),
            "device_ms": graph_ms(kern),
            "plain_ms": time_ms(plain, iters=20),
            "library_ms": None if library is None else time_ms(library),
            "library_device_ms": (None if library is None
                                  else graph_ms(library)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "launches_per_decode_step": n_kan, "card": card})
        print(json.dumps(rows[-1]))

    # (f) the serving bench's kanffn row on the card
    committed = json.loads((ROOT / "BENCH_serving.json").read_text())
    key = f"kanffn:{serving_bench.KANFFN_ARCH}"
    row = json.loads(json.dumps(serving_bench.kanffn_dense_vs_kan(
        device=DEVICE)))
    check(all(row[k] == v for k, v in committed[key].items()),
          f"(f) {key} on the card differs from the committed row: {row}")
    print(f"phase 10: (f) {key}: every simulated field equals the committed "
          f"row, batched_equals_single {row['batched_equals_single']}")

    seconds = time.perf_counter() - t_phase
    print(f"phase 10: {seconds:.1f} s")
    launches = {k: sum(sv["launches"][k] for sv in served.values())
                for k in _build.LAUNCHES}
    return {"seconds": seconds, "launches": launches, "times": times,
            "kernel_rows": rows, "layer_err": layer_err, "ties": ties,
            "launcher": launcher, "bench_row": row,
            "served": {k: {f: v for f, v in sv.items() if f != "srv"}
                       for k, sv in served.items()}}


def moe_rec_phase(dev: torch.device, card: str) -> dict:
    """Phase 11: MoE, RG-LRU and xLSTM serving on the card at full width
    (d_model, heads, experts, top-k, d_ff and vocab as registered; depth
    cut to ``MR_DEPTH``), params drawn on the card from seeded generators.

    (a) one MoE layer of KAN experts at qwen3-moe's widths (d 4096, 128
    experts, top-8, hidden 192), f32 and bf16, at T in ``MR_LAYER_T``:
    exactly 2 * 128 fused-KAN launches a call; each expert's two launches
    within ``KERNEL_TOL`` / ``BF16_ULP`` of the plain version on the same
    input, the served output bitwise the expert's kernels; the layer
    within ``MOE_LAYER_TOL`` of the same layer through the plain
    versions; the kernel's times at the expert shapes;
    (b) qwen3-moe with ``ffn_kind="kan"`` at bf16 and its f32 twin, 8
    requests x 16 tokens through ``Server`` on 8 slots: 512 launches a
    prefill and a decode step; teacher-forced logits within
    ``MOE_TF_TOL`` of the plain versions', the plain run taking the
    kernel run's expert choices (a router within an ulp of a tie would
    otherwise pick another expert: another result, not a rounding);
    (c) qwen3-moe and llama4-scout as registered (SwiGLU experts;
    llama4's shared expert) at bf16: 8 x 16 through ``Server``, every
    teacher-forced logit finite and its argmax the served token, each
    request's tokens those it gets served alone, a decode step's host and
    device ms, idle share and peak device memory;
    (d) recurrentgemma-9b and xlstm-125m: at f32, cached decode against
    the full forward within ``DECODE_TOL``; at bf16, served and recorded
    as (c);
    (e) the five ``reduce()``d configs at f32 on the card against the
    same port on the CPU within ``CPU_TOL``;
    (f) the launcher in subprocesses: each arch at ``--scale smoke``,
    ``xlstm-125m`` at ``--scale full``.
    Returns what it measured; raises on any fault."""
    from repro_torch.benchmarks.kernel_ab import graph_ms, time_ms
    from repro_torch.configs.registry import ARCHS as ZOO
    from repro_torch.core.splines import spu_op_count
    from repro_torch.kernels import _build
    from repro_torch.kernels.kan_fused.ops import kan_fused_v2
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.backends import splice_cache
    from repro_torch.runtime.server import Server
    from repro_torch.utils import leaf_paths, tree_map

    t_phase = time.perf_counter()
    qwen, scout = "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"
    rgemma, xlstm = "recurrentgemma-9b", "xlstm-125m"

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def cut(name: str, **over) -> object:
        cfg = ZOO[name]
        if MR_DEPTH[name] is not None:
            cfg = dataclasses.replace(cfg, n_layers=MR_DEPTH[name])
        return dataclasses.replace(cfg, **over)

    def n_params(tree) -> int:
        return sum(int(a.numel()) for _, a in leaf_paths(tree))

    def launches_only(want: dict, what: str) -> dict:
        got = dict(_build.LAUNCHES)
        full = {k: want.get(k, 0) for k in got}
        check(got == full, f"(phase 11) {what}: launches {got}, want {full}")
        return got

    def plain_experts(ex):
        """``ex``'s experts through the fused-KAN kernel's plain version,
        on the card."""
        def fn(h):
            return torch.stack([
                kan_fused_v2_ref(kan_fused_v2_ref(h[e], ex.wt_up[e], ex.spec,
                                                  ex.kb),
                                 ex.wt_down[e], ex.spec, ex.kb)
                for e in range(h.shape[0])])
        return fn

    def free() -> None:
        # a Server sits in reference cycles: collect them, so a freed
        # arch's params leave the device before the next one's peak
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (a) one MoE layer of KAN experts at qwen3-moe's widths
    mcfg = cut(qwen, ffn_kind="kan").moe_cfg()
    E = mcfg.n_experts
    up_cfg, _ = mcfg.kan_cfgs()
    p_f = M.moe_init(gen(20), mcfg, F32)
    layer_err, kernel_rows, launches_moe = {}, [], {}

    def layer_check(dt: torch.dtype, p: dict) -> None:
        """(a) at one dtype; its tensors (and the views and closures that
        hold them) die when it returns."""
        ex = M.KanExperts(mcfg, p["experts"])
        kname = "kan_fused_v2" + SUFFIX[dt]
        errs = []
        for T in MR_LAYER_T:
            x = torch.randn((1, T, mcfg.d_model), generator=gen(21 + T),
                            device=dev).to(dt)
            seen = {}

            def served(h, ex=ex, seen=seen):
                seen["h"], seen["y"] = h, ex(h)
                return seen["y"]

            _build.reset_launches()
            with torch.no_grad():
                r = M.moe_apply(p, x, mcfg, experts=served)
            torch.cuda.synchronize()
            got = launches_only({kname: 2 * E},
                                f"(a) {dt} MoE layer at T={T}")
            launches_moe[kname] = launches_moe.get(kname, 0) + got[kname]
            h, y = seen["h"], seen["y"]
            check(h.shape[1] == mcfg.capacity(T),
                  f"(a) capacity {h.shape[1]} at T={T}, want "
                  f"{mcfg.capacity(T)}")
            with torch.no_grad():
                for e in range(E):
                    mid = kan_fused_v2(h[e], ex.wt_up[e], ex.spec, ex.kb,
                                       ex.slot_of)
                    check(torch.equal(y[e], kan_fused_v2(
                        mid, ex.wt_down[e], ex.spec, ex.kb, ex.slot_of)),
                          f"(a) {dt} T={T} expert {e}: the served output "
                          f"is not its two kernels, bitwise")
                    for what, k_out, ref in (
                            ("up", mid, kan_fused_v2_ref(
                                h[e], ex.wt_up[e], ex.spec, ex.kb)),
                            ("down", y[e], kan_fused_v2_ref(
                                mid, ex.wt_down[e], ex.spec, ex.kb))):
                        err, scale, nan = rel_err(k_out, ref)
                        tol = KERNEL_TOL if dt == F32 else BF16_ULP
                        check(not nan and err <= tol * scale,
                              f"(a) {dt} T={T} expert {e} {what}: max|kernel"
                              f" - plain| {err:.3e} vs {tol:g} * {scale:.4g}")
                        errs.append(err / scale)
                rp = M.moe_apply(p, x, mcfg, experts=plain_experts(ex))
            err, scale, nan = rel_err(r["out"], rp["out"])
            check(not nan and err <= MOE_LAYER_TOL[dt] * scale,
                  f"(a) {dt} T={T}: the layer {err:.3e} from its plain "
                  f"version vs {MOE_LAYER_TOL[dt]:g} * {scale:.4g}")
            check(torch.equal(r["aux_loss"], rp["aux_loss"]),
                  f"(a) {dt} T={T}: the aux loss differs from the plain "
                  f"run's (the router saw the same input)")
            layer_err[f"{'bf16' if dt == BF else 'f32'} T={T}"] = {
                "launch": max(errs), "layer": err / scale}
        # the kernel at the experts' shapes: expert 0's dispatched rows
        # of the last call (M = its capacity) and their up-projection
        xin = seen["h"][0]
        mid = kan_fused_v2(xin, ex.wt_up[0], ex.spec, ex.kb, ex.slot_of)
        esz = 2.0 if dt == BF else 4.0
        mac_rate = BF16_FLOPS_PER_S if dt == BF else F32_FLOPS_PER_S
        for what, xx, wt in (("up", xin, ex.wt_up[0]),
                             ("down", mid, ex.wt_down[0])):
            rows_m, n_in = xx.shape
            n_out = wt.shape[1]
            # every basis is kept: K + 1 local basis values a feature
            hits = rows_m * n_in * ex.spec.n_active
            n_bytes = (esz * (xx.numel() + wt.numel() + rows_m * n_out)
                       + 4.0 * ex.slot_of.numel())
            work = [(2.0 * n_out * (rows_m * n_in + hits), mac_rate),
                    (rows_m * n_in * (spu_op_count(ex.spec) + 4),
                     F32_FLOPS_PER_S)]
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = sum(n / rt for n, rt in work) * 1e3

            def kern(xx=xx, wt=wt):
                return kan_fused_v2(xx, wt, ex.spec, ex.kb, ex.slot_of)

            def plain(xx=xx, wt=wt):
                return kan_fused_v2_ref(xx, wt, ex.spec, ex.kb)

            kernel_rows.append({
                "kernel": kname, "model": f"{qwen} KAN experts",
                "layer": what, "shape": [rows_m, n_in, n_out],
                "precision": "bf16" if dt == BF else "f32",
                "ms": time_ms(kern), "device_ms": graph_ms(kern),
                "plain_ms": time_ms(plain, iters=20), "library_ms": None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "launches_per_moe_layer_call": E,
                "card": card})
            print(json.dumps(kernel_rows[-1]))

    for dt in (BF, F32):
        layer_check(dt, p_f if dt == F32
                    else tree_map(lambda a: a.to(BF), p_f))
        free()
    del p_f
    free()
    print(f"phase 11: (a) one MoE layer of KAN experts (d {mcfg.d_model}, "
          f"{E} experts, top-{mcfg.top_k}, hidden {up_cfg.n_out}) at T = "
          + ", ".join(map(str, MR_LAYER_T))
          + f": 2 x {E} fused-KAN launches a call; each launch within its "
          "tolerance of its plain version, the layer within MOE_LAYER_TOL "
          "(max err / (1 + max): "
          + ", ".join(f"{k} launch {v['launch']:.2e} layer {v['layer']:.2e}"
                      for k, v in layer_err.items()) + ")")

    rng = np.random.default_rng(30)
    prompts = [rng.integers(0, 1 << 30, size=int(rng.integers(3, 16)))
               .astype(np.int64) for _ in range(MR_SLOTS)]

    def prompts_for(cfg) -> list:
        return [(p % cfg.vocab_size).astype(np.int32) for p in prompts]

    def serve(cfg, params, what: str) -> tuple:
        srv = Server(cfg, params, n_slots=MR_SLOTS, max_len=MR_MAX_LEN,
                     device=DEVICE)
        rids = [srv.submit(p, max_new_tokens=MR_NEW_TOKENS)
                for p in prompts_for(cfg)]
        _build.reset_launches()
        t0 = time.perf_counter()
        out = srv.run_until_done()
        torch.cuda.synchronize()
        return srv, [out[r] for r in rids], time.perf_counter() - t0

    def teacher(be, toks: list, ffns) -> list:
        """Each prompt prefilled into its own lane, then the served tokens
        decoded in lockstep: [(8, V) logits a position]."""
        caches = TF.init_caches(be.cfg, MR_SLOTS, MR_MAX_LEN, dev)
        pre, steps = [], []
        with torch.no_grad():
            for s, p in enumerate(prompts_for(be.cfg)):
                lg, c = TF.prefill(be.params, be.cfg,
                                   torch.as_tensor(p[None], device=dev),
                                   max_len=MR_MAX_LEN, ffns=ffns)
                pre.append(lg[:, -1])
                caches = splice_cache(caches, c, s)
            for t in range(MR_NEW_TOKENS - 1):
                tok = torch.as_tensor(np.array([[g[t]] for g in toks],
                                               np.int32), device=dev)
                lg, caches = TF.decode_step(be.params, be.cfg, tok, caches,
                                            ffns=ffns)
                steps.append(lg[:, -1])
        return [torch.cat(pre), *steps]

    def consistent(logits: list, toks: list, what: str) -> None:
        served_t = torch.as_tensor(np.array(toks), device=dev)
        for t, lg in enumerate(logits):
            check(bool(torch.isfinite(lg).all()),
                  f"{what} step {t}: a logit is not finite")
            check(torch.equal(lg.argmax(-1), served_t[:, t].long()),
                  f"{what} step {t}: the teacher-forced logits' argmax is "
                  f"not the served token")

    def alone(cfg, params, toks: list, what: str) -> None:
        for i, p in enumerate(prompts_for(cfg)):
            one = Server(cfg, params, n_slots=MR_SLOTS, max_len=MR_MAX_LEN,
                         device=DEVICE)
            rid = one.submit(p, max_new_tokens=MR_NEW_TOKENS)
            check(one.run_until_done()[rid] == toks[i],
                  f"{what}: request {i} served alone differs from its "
                  f"tokens served in the batch of {MR_SLOTS}")

    class Replay:
        """``moe._route`` recording the kernel run's expert choices and
        replaying them into the plain run (its own gate weights at those
        experts), counting the picks that would have differed."""

        def __init__(self, route) -> None:
            self.route, self.calls, self.mode = route, [], "record"
            self.i = self.differ = self.picks = 0

        def __call__(self, probs, K):
            top_p, top_e = self.route(probs, K)
            if self.mode == "record":
                self.calls.append(top_e)
                return top_p, top_e
            e = self.calls[self.i]
            self.i += 1
            self.picks += int(e.numel())
            self.differ += int((e != top_e).sum())
            tp = probs.gather(1, e)
            return tp / torch.sum(tp, dim=-1, keepdim=True), e

    # (b) qwen3-moe with KAN experts, bf16 and its f32 twin
    cfg_f = cut(qwen, ffn_kind="kan", dtype="float32")
    cfg_b = dataclasses.replace(cfg_f, dtype="bfloat16")
    t0 = time.perf_counter()
    params_f = TF.init_params(cfg_f, gen(0), dev)
    torch.cuda.synchronize()
    print(f"phase 11: (b) {qwen} with KAN experts: {cfg_f.n_layers} of "
          f"{ZOO[qwen].n_layers} layers, d {cfg_f.d_model}, {cfg_f.n_heads} "
          f"heads ({cfg_f.n_kv_heads} KV), {E} experts top-{cfg_f.top_k}, "
          f"expert hidden {up_cfg.n_out}, vocab {cfg_f.vocab_size}; "
          f"{n_params(params_f)} params, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    kan_served = {}
    for what, cfg, dt in (("bf16", cfg_b, BF), ("f32 twin", cfg_f, F32)):
        params = (params_f if dt == F32
                  else tree_map(lambda a: a.to(BF), params_f))
        srv, toks, wall = serve(cfg, params, what)
        kname = "kan_fused_v2" + SUFFIX[dt]
        n_calls = len(prompts) + int(srv.stats["ticks"])
        got = launches_only({kname: 2 * E * cfg.n_layers * n_calls},
                            f"(b) {what} served")
        launches_moe[kname] = launches_moe.get(kname, 0) + got[kname]
        be = srv.backend
        replay = Replay(M._route)
        M._route = replay
        try:
            lk = teacher(be, toks, be.ffns)
            replay.mode = "replay"
            lp = teacher(be, toks, [None if f is None else plain_experts(f)
                                    for f in be.ffns])
        finally:
            M._route = replay.route
        consistent(lk, toks, f"(b) {what}")
        tol = MOE_TF_TOL[dt]
        worst, near = 0.0, 0
        served_t = torch.as_tensor(np.array(toks), device=dev)
        for t, (a, b) in enumerate(zip(lk, lp)):
            err, scale, nan = rel_err(a, b)
            check(not nan and err <= tol * scale,
                  f"(b) {what} step {t}: max|kernel - plain| logits "
                  f"{err:.3e} vs {tol:g} * {scale:.4g}")
            worst = max(worst, err / scale)
            top2 = b.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol * scale
            same = b.argmax(-1) == served_t[:, t].long()
            check(bool((same | ~clear).all()),
                  f"(b) {what} step {t}: the plain argmax differs from the "
                  f"served token where the top-2 margin exceeds {tol:g}")
            near += int((~clear).sum())
        kan_served[what] = {
            "launches": got[kname], "ticks": int(srv.stats["ticks"]),
            "wall_s": wall, "max_err_over_scale": worst, "tol": tol,
            "near_ties": near, "route_picks": replay.picks,
            "route_picks_differing": replay.differ}
        print(f"phase 11: (b) {what}: {len(prompts)} requests x "
              f"{MR_NEW_TOKENS} tokens on {MR_SLOTS} slots in "
              f"{kan_served[what]['ticks']} decode steps, wall {wall:.3f} s; "
              f"{got[kname]} {kname} launches ({2 * E * cfg.n_layers} a "
              f"prefill and a decode step); teacher-forced logits within "
              f"{tol:g} of the plain versions' (max {worst:.3e} of 1 + "
              f"max|plain|), {near} near-tie positions; the plain run took "
              f"the kernel run's {replay.picks} expert picks, "
              f"{replay.differ} of which its own router would have made "
              f"otherwise")
        del srv, be, params, lk, lp, replay
        free()
    del params_f
    free()

    # (c) and (d): the registered archs served at bf16, with times
    def timed(name: str, cfg, params) -> dict:
        free()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        srv, toks, wall = serve(cfg, params, name)
        launches_only({}, f"{name} served (no kernel on this path)")
        consistent(teacher(srv.backend, toks, None), toks, name)
        alone(cfg, params, toks, name)
        be = srv.backend
        p0 = prompts_for(cfg)
        tok8 = torch.as_tensor(np.array([[p[0]] for p in p0], np.int32),
                               device=dev)
        with torch.no_grad():
            caches = TF.init_caches(be.cfg, MR_SLOTS, MR_MAX_LEN, dev)
            for s, p in enumerate(p0):
                _, c = TF.prefill(be.params, be.cfg,
                                  torch.as_tensor(p[None], device=dev),
                                  max_len=MR_MAX_LEN)
                caches = splice_cache(caches, c, s)

            def step():
                return TF.greedy_token(TF.decode_step(
                    be.params, be.cfg, tok8, caches)[0]).cpu()

            step_host = host_ms(step, iters=3, reps=5)
            # device time: the CUDA kernels' own time over 3 steps
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
            kern = sorted((e for e in prof.key_averages()
                           if str(getattr(e, "device_type", ""))
                           .endswith("CUDA")), key=lambda e: -_device_us(e))
            step_dev = sum(_device_us(e) for e in kern) / 3e3
        check(step_dev > 0, f"{name}: the profiler saw no device time")
        peak = torch.cuda.max_memory_allocated()
        rec = {"decode_step_host_ms": step_host,
               "decode_step_device_ms": step_dev,
               "device_idle_share": 1.0 - step_dev / step_host,
               "peak_device_bytes": peak, "resident_bytes": resident,
               "ticks": int(srv.stats["ticks"]),
               "serve_wall_s": wall, "card": card,
               "kernels_a_step": sum(e.count for e in kern) / 3,
               "top_device": [(e.key[:72], _device_us(e) / 3, e.count / 3)
                              for e in kern[:6]]}
        print(f"phase 11: {name} at bf16: {len(prompts)} requests x "
              f"{MR_NEW_TOKENS} tokens on {MR_SLOTS} slots in "
              f"{rec['ticks']} decode steps, wall {wall:.3f} s, logits "
              f"finite, batched == single; a decode step: host "
              f"{step_host:.3f} ms, device {step_dev:.4f} ms (idle "
              f"{rec['device_idle_share'] * 100:.1f}%; "
              f"{rec['kernels_a_step']:.0f} kernels, by device time "
              + ", ".join(f"{k} {us:.0f} us x{n:.0f}"
                          for k, us, n in rec["top_device"])
              + f"), peak device memory {peak / 2**30:.2f} GiB while "
              f"serving, {resident / 2**30:.2f} GiB resident when it "
              f"starts ({card})")
        return rec

    timing = {}
    for name in (qwen, scout):
        cfg = cut(name)
        t0 = time.perf_counter()
        params = TF.init_params(cfg, gen(1), dev)
        torch.cuda.synchronize()
        print(f"phase 11: (c) {name}: {cfg.n_layers} of {ZOO[name].n_layers} "
              f"layers, d {cfg.d_model}, {cfg.n_experts} experts top-"
              f"{cfg.top_k}{' + shared' if cfg.shared_expert else ''}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params(params)} "
              f"{cfg.dtype} params drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        timing[name] = timed(name, cfg, params)
        del params
        free()

    for name in (rgemma, xlstm):
        cfg_f = cut(name, dtype="float32")
        params_f = TF.init_params(cfg_f, gen(2), dev)
        print(f"phase 11: (d) {name}: {cfg_f.n_layers} of "
              f"{ZOO[name].n_layers} layers, pattern {cfg_f.pattern}, d "
              f"{cfg_f.d_model}, d_ff {cfg_f.d_ff}, vocab "
              f"{cfg_f.vocab_size}; {n_params(params_f)} params")
        tok = torch.as_tensor(np.random.default_rng(31).integers(
            0, cfg_f.vocab_size, size=(2, 10)), device=dev)
        with torch.no_grad():
            h, _ = TF.forward(params_f, cfg_f, tok)
            full = TF._logits(params_f, cfg_f, h)[:, 4:10]
            _, caches = TF.prefill(params_f, cfg_f, tok[:, :4], max_len=12)
            got = []
            for t in range(4, 10):
                lg, caches = TF.decode_step(params_f, cfg_f, tok[:, t:t + 1],
                                            caches)
                got.append(lg[:, 0])
        got = torch.stack(got, 1)
        gap = (got - full).abs()
        check(bool((gap <= DECODE_TOL + DECODE_TOL * full.abs()).all()),
              f"(d) {name} f32: cached decode {float(gap.max()):.3e} from "
              f"the full forward, beyond the reference's {DECODE_TOL}")
        print(f"phase 11: (d) {name} f32: cached decode = the full forward "
              f"within {DECODE_TOL} (max |gap| {float(gap.max()):.3e})")
        params_b = tree_map(lambda a: a.to(BF), params_f)
        del params_f, h, full, caches, got
        free()
        timing[name] = timed(name, cut(name), params_b)
        del params_b
        free()

    # (e) the reduced configs: the card against the CPU
    reduced = {}
    for label, name, over in (("qwen3-moe", qwen, {}),
                              ("qwen3-moe-kan", qwen, {"ffn_kind": "kan"}),
                              ("llama4-scout", scout, {}),
                              ("recurrentgemma", rgemma, {}),
                              ("xlstm", xlstm, {})):
        cfg = dataclasses.replace(ZOO[name].reduce(), **over)
        p_cpu = TF.init_params(cfg, torch.Generator().manual_seed(3))
        p_dev = tree_map(lambda a: a.to(dev), p_cpu)
        tok = np.random.default_rng(32).integers(0, cfg.vocab_size,
                                                 size=(2, 8))
        worst = 0.0
        with torch.no_grad():
            outs = []
            for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
                t = torch.as_tensor(tok, device=d)
                h, aux = TF.forward(params, cfg, t)
                seq = [h, aux[None]]
                lg, c = TF.prefill(params, cfg, t[:, :5], max_len=16)
                seq.append(lg)
                for i in range(5, 8):
                    lg, c = TF.decode_step(params, cfg, t[:, i:i + 1], c)
                    seq.append(lg)
                outs.append(seq)
        for a, b in zip(*outs):
            err, scale, nan = rel_err(b.cpu(), a)
            check(not nan and err <= CPU_TOL * scale,
                  f"(e) {label}: the card {err:.3e} from the CPU, vs "
                  f"{CPU_TOL} * {scale:.4g}")
            worst = max(worst, err / scale)
        reduced[label] = worst
    print("phase 11: (e) the reduce()d configs at f32, the card against the "
          f"CPU within {CPU_TOL} (forward, aux, prefill, 3 decode steps): "
          + ", ".join(f"{k} {v:.2e}" for k, v in reduced.items()))

    # (f) the launcher, in parallel subprocesses on the card
    runs = [[name, "--scale", "smoke"] for name in (qwen, scout, rgemma,
                                                     xlstm)]
    runs.append([xlstm, "--scale", "full"])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", a,
         *rest, "--requests", "4", "--new-tokens", "8"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC))) for a, *rest in runs]
    launcher = {}
    for (a, *rest), proc in zip(runs, procs):
        out, err = proc.communicate(timeout=600)
        key = f"{a} {' '.join(rest)}"
        check(proc.returncode == 0,
              f"(f) the launcher at {key} exited {proc.returncode}: "
              f"{err[-2000:]}")
        check("4 requests" in out, f"(f) the launcher at {key} served no "
              f"4 requests: {out[-500:]}")
        launcher[key] = next(ln for ln in out.splitlines()
                             if "4 requests" in ln)
    print(f"phase 11: (f) the launcher in {len(runs)} subprocesses, each "
          f"exit 0, in {time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{k}: {v}" for k, v in launcher.items()))

    seconds = time.perf_counter() - t_phase
    print(f"phase 11: {seconds:.1f} s")
    return {"seconds": seconds, "launches": launches_moe,
            "layer_err": layer_err, "kernel_rows": kernel_rows,
            "kan_served": kan_served, "timing": timing,
            "reduced_vs_cpu": reduced, "launcher": launcher}


def encdec_vlm_phase(dev: torch.device, card: str) -> dict:
    """Phase 12: the encoder-decoder and prefix-VLM archs at full width
    and depth through ``launch/steps``, params drawn on the card from
    seeded generators, batches of ``ED_BATCH`` requests (``ED_PROMPT``
    seeded tokens; whisper: frames of (1500, 1024), paligemma: 256
    patches of 2048, each ``0.1 * N(0, 1)`` in the params' dtype).

    (a) a KAN FFN (kept bases (0, 2, 4, 5, 6)) of each arch at the rows
    its served steps give it: whisper-medium-kan's encoder FFN (1024 ->
    512 -> 1024) at M = 8 x 1500, f32 and bf16, paligemma-3b-kan's (2048
    -> 2048 -> 2048) at M = 8 x 272 and 8, bf16, whisper-medium-kan's
    decoder FFN at M = 8 x 16 and 8, bf16: its two fused-KAN launches,
    each within ``KERNEL_TOL`` / ``BF16_ULP`` of the plain version on
    the same input; device ms (CUDA graph), back to back ms, the plain
    version's ms and the bound;
    (b) whisper-medium-kan (24 + 24 layers) at bf16 and its f32 twin:
    ``make_prefill_step`` then ``ED_NEW_TOKENS`` ``make_decode_step``
    steps, exactly 2 x 24 + 2 x 24 launches a prefill and 2 x 24 a
    decode step; teacher-forced logits within ``ED_TF_TOL`` of the same
    model with every KAN FFN through its plain version on the card, and
    every launch of that teacher-forced run within ``KERNEL_TOL`` /
    ``BF16_ULP`` of the plain version on the input it is served; then
    ``forward`` with the kernels and with the plain versions: each FFN's
    input along the layers, the last hidden state and its logits;
    (c) paligemma-3b-kan (18 layers, vocab 257216) at bf16, as (b): 2 x
    18 launches a prefill and a decode step;
    (d) whisper-medium and paligemma-3b as published (gelu MLP, GeGLU):
    at f32 ``forward`` + ``lm_loss`` finite, cached decode against
    ``forward`` (whisper) or a longer prefill (paligemma: the
    reference's prefill is causal over the patches) within
    ``DECODE_TOL``; at bf16 the host and device ms of a prefill step and
    of a decode step, the idle share, the kernels a step and the peak
    device memory;
    (e) the four ``reduce()``d configs (as published, KAN drop-in) at
    f32 on the card against the CPU within ``CPU_TOL``;
    (f) the launcher and ``TransformerBackend`` refuse both archs on the
    card with the reference's reason.
    Returns what it measured; raises on any fault."""
    from repro_torch.benchmarks.kernel_ab import graph_ms, time_ms
    from repro_torch.configs.registry import ARCHS as ZOO
    from repro_torch.core.splines import locate_cell, spu_op_count
    from repro_torch.kernels import _build
    from repro_torch.kernels.kan_fused.ops import kan_fused_v2
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.launch import steps as ST
    from repro_torch.models import ffn as FF
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.backends import TransformerBackend
    from repro_torch.utils import leaf_paths, tree_map

    t_phase = time.perf_counter()
    whisper, pali = "whisper-medium", "paligemma-3b"
    kan = {"ffn_kind": "kan", "pattern_rate": 0.5}

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def n_params(tree) -> int:
        return sum(int(a.numel()) for _, a in leaf_paths(tree))

    def launches_only(want: dict, what: str) -> dict:
        got = dict(_build.LAUNCHES)
        full = {k: want.get(k, 0) for k in got}
        check(got == full, f"(phase 12) {what}: launches {got}, want {full}")
        return got

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def plain(mod):
        """A ``KanPairFFN`` through the fused-KAN kernel's plain version,
        on the card."""
        def fn(x):
            lead = x.shape[:-1]
            h = x.reshape(-1, mod.up.cfg.n_in)
            for layer in (mod.up, mod.down):
                h = kan_fused_v2_ref(h, layer.wt, layer.cfg.spec, layer.kb)
            return h.reshape(*lead, mod.down.cfg.n_out)
        return fn

    def checked(mod, part: str, tol: float, worst: dict):
        """``mod`` with each of its two launches held to the plain version
        on the same input, within ``tol`` of 1 + max|plain|, the worst
        err / (1 + max) kept in ``worst`` by part and rows; the same
        bits as ``mod``."""
        def fn(x):
            h = x
            for layer in (mod.up, mod.down):
                out = layer(h)
                flat = h.reshape(-1, layer.cfg.n_in)
                err, scale, nan = rel_err(
                    out.reshape(-1, layer.cfg.n_out),
                    kan_fused_v2_ref(flat, layer.wt, layer.cfg.spec,
                                     layer.kb))
                key = f"{part} M = {flat.shape[0]}"
                check(not nan and err <= tol * scale,
                      f"{key}: a served launch {err:.3e} from its plain "
                      f"version, vs {tol:g} * {scale:.4g}")
                worst[key] = max(worst.get(key, 0.0), err / scale)
                h = out
            return h
        return fn

    def probe(fn, taps: list):
        """``fn`` that keeps each input it is given in ``taps``."""
        def g(x):
            taps.append(x)
            return fn(x)
        return g

    launches_ed: dict = {}

    def tally(got: dict) -> None:
        for k, v in got.items():
            launches_ed[k] = launches_ed.get(k, 0) + v

    # (a) a KAN FFN of each arch at the rows its served steps give it:
    # whisper-medium-kan's encoder FFN at a prefill's 8 x 1500 frames (f32
    # and bf16), paligemma-3b-kan's FFN at a prefill's 8 x 272 positions
    # and a decode step's 8, whisper-medium-kan's decoder FFN at a
    # prefill's 8 x 16 and a decode step's 8 (bf16)
    kernel_rows, layer_err = [], {}
    a_cases = (
        (whisper, "encoder FFN, a prefill", (F32, BF),
         ED_BATCH * ZOO[whisper].n_frontend_tokens, ZOO[whisper].n_enc_layers),
        (pali, "FFN, a prefill", (BF,),
         ED_BATCH * (ZOO[pali].n_frontend_tokens + ED_PROMPT),
         ZOO[pali].n_layers),
        (pali, "FFN, a decode step", (BF,), ED_BATCH, ZOO[pali].n_layers),
        (whisper, "decoder FFN, a prefill", (BF,), ED_BATCH * ED_PROMPT,
         ZOO[whisper].n_layers),
        (whisper, "decoder FFN, a decode step", (BF,), ED_BATCH,
         ZOO[whisper].n_layers))
    for name, where, dts, rows, per_step in a_cases:
        fcfg = dataclasses.replace(ZOO[name], **kan).ffn_cfg(0)
        p_f = FF.ffn_init(gen(40), fcfg, F32)
        x_f = torch.randn((rows, fcfg.d_model), generator=gen(41),
                          device=dev)
        for dt in dts:
            mod = FF.KanPairFFN(fcfg, p_f if dt == F32
                                else tree_map(lambda a: a.to(BF), p_f))
            kname = "kan_fused_v2" + SUFFIX[dt]
            prec = "bf16" if dt == BF else "f32"
            label = f"{name}-kan {where} (M = {rows}) {prec}"
            x = x_f.to(dt)
            _build.reset_launches()
            with torch.no_grad():
                y = mod(x)
            torch.cuda.synchronize()
            tally(launches_only({kname: 2}, f"(a) {label}"))
            tol = KERNEL_TOL if dt == F32 else BF16_ULP
            errs = []
            with torch.no_grad():
                mid = mod.up(x)
                check(torch.equal(y, mod.down(mid)),
                      f"(a) {label}: the FFN is not its two layers, bitwise")
                for what, layer, xin in (("up", mod.up, x),
                                         ("down", mod.down, mid)):
                    k_out = layer(xin)
                    ref = kan_fused_v2_ref(xin, layer.wt, layer.cfg.spec,
                                           layer.kb)
                    err, scale, nan = rel_err(k_out, ref)
                    check(not nan and err <= tol * scale,
                          f"(a) {label} {what}: max|kernel - plain| "
                          f"{err:.3e} vs {tol:g} * {scale:.4g}")
                    errs.append(err / scale)
                    rows_m, n_in = xin.shape
                    n_out = layer.wt.shape[1]
                    spec = layer.cfg.spec
                    # the kept bases this run's inputs hit: the K + 1
                    # active bases of each input's cell, those of kb
                    cell = locate_cell(spec.clip(xin), spec)[0].long()
                    kept = torch.tensor(
                        [len(set(range(c, c + spec.n_active))
                             & set(layer.kb))
                         for c in range(spec.grid_size)], device=dev)
                    hits = int(kept[cell].sum())
                    esz = 2.0 if dt == BF else 4.0
                    mac_rate = (BF16_FLOPS_PER_S if dt == BF
                                else F32_FLOPS_PER_S)
                    n_bytes = (esz * (xin.numel() + layer.wt.numel()
                                      + rows_m * n_out)
                               + 4.0 * layer.slot_of.numel())
                    work = [(2.0 * n_out * (rows_m * n_in + hits), mac_rate),
                            (rows_m * n_in * (spu_op_count(spec) + 4),
                             F32_FLOPS_PER_S)]
                    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                    t_ops = sum(n / rt for n, rt in work) * 1e3

                    def kern(xin=xin, layer=layer):
                        return kan_fused_v2(xin, layer.wt, layer.cfg.spec,
                                            layer.kb, layer.slot_of)

                    def plain_fn(xin=xin, layer=layer):
                        return kan_fused_v2_ref(xin, layer.wt,
                                                layer.cfg.spec, layer.kb)

                    kernel_rows.append({
                        "kernel": kname, "model": f"{name}-kan {where}",
                        "layer": what, "shape": [rows_m, n_in, n_out],
                        "nbk": len(layer.kb), "precision": prec,
                        "ms": time_ms(kern, iters=10, reps=5),
                        "device_ms": graph_ms(kern, iters=5, reps=5),
                        "plain_ms": time_ms(plain_fn, iters=3, reps=3),
                        "library_ms": None,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": ("bytes" if t_bytes >= t_ops
                                     else "operations"),
                        "kept_basis_hits": hits,
                        "launches_a_step": per_step, "card": card})
                    print(json.dumps(kernel_rows[-1]))
            layer_err[label] = max(errs)
            del mod, x, y, mid
            free()
        del p_f, x_f
        free()
    print("phase 12: (a) a KAN FFN (kept bases (0, 2, 4, 5, 6)) of each "
          "arch at the rows its steps give it: 2 fused-KAN launches a call, "
          "each within its tolerance of its plain version (max err / (1 + "
          "max): " + ", ".join(f"{k} {v:.2e}"
                               for k, v in layer_err.items()) + ")")

    def batch_for(cfg, seed: int) -> dict:
        rng = np.random.default_rng(seed)
        toks = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, size=(ED_BATCH, ED_PROMPT)).astype(np.int32),
            device=dev)
        stub = 0.1 * torch.randn(
            (ED_BATCH, cfg.n_frontend_tokens, cfg.d_model),
            generator=gen(seed), device=dev)
        key = "frames" if cfg.enc_dec else "patches"
        return {"tokens": toks, key: stub.to(cfg.param_dtype)}

    def modality(batch: dict) -> dict:
        return {k: v for k, v in batch.items() if k in ST.MODALITIES}

    def teacher(cfg, params, batch, toks, ffns, enc) -> list:
        """Prefill's logits, then each served token decoded in turn:
        [(B, V) logits a position]."""
        out = []
        with torch.no_grad():
            lg, caches = TF.prefill(params, cfg, batch["tokens"],
                                    ffns=ffns, enc_ffns=enc,
                                    **modality(batch))
            out.append(lg[:, -1])
            for t in range(ED_NEW_TOKENS):
                lg, caches = TF.decode_step(params, cfg, toks[:, t:t + 1],
                                            caches, ffns=ffns)
                out.append(lg[:, -1])
        return out

    kan_served = {}

    def served_kan(name: str, cfg, params, seed: int) -> None:
        """(b)/(c) at one dtype: the serve steps, launch counts, and the
        teacher-forced logits against the plain versions'."""
        dt = cfg.param_dtype
        kname = "kan_fused_v2" + SUFFIX[dt]
        ffns = TF.ffn_modules(params, cfg)
        enc = TF.encoder_ffn_modules(params, cfg) if cfg.enc_dec else None
        n_enc = cfg.n_enc_layers if cfg.enc_dec else 0
        batch = batch_for(cfg, seed)
        prefill_step = ST.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc)
        decode_step = ST.make_decode_step(cfg, ffns=ffns)
        _build.reset_launches()
        t0 = time.perf_counter()
        tok, caches = prefill_step(params, batch)
        toks = [tok]
        for _ in range(ED_NEW_TOKENS):
            tok, caches = decode_step(params, {"token": tok,
                                               "caches": caches})
            toks.append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_prefill = 2 * (n_enc + cfg.n_layers)
        per_decode = 2 * cfg.n_layers
        got = launches_only(
            {kname: per_prefill + ED_NEW_TOKENS * per_decode},
            f"{name} {dt} served")
        tally(got)
        toks = torch.cat(toks, dim=1)                    # (B, 1 + new)
        del caches
        # the kernel run again, each launch held to its plain version on
        # the input it is served: one launch's tolerance
        per_launch: dict = {}
        one = KERNEL_TOL if dt == F32 else BF16_ULP
        lk = teacher(cfg, params, batch, toks,
                     [None if f is None else
                      checked(f, "decoder", one, per_launch) for f in ffns],
                     None if enc is None else
                     [checked(f, "encoder", one, per_launch) for f in enc])
        lp = teacher(cfg, params, batch, toks,
                     [None if f is None else plain(f) for f in ffns],
                     None if enc is None else [plain(f) for f in enc])
        tol = ED_TF_TOL[name][dt]
        worst, near = 0.0, 0
        for t, (a, b) in enumerate(zip(lk, lp)):
            check(bool(torch.isfinite(a).all()),
                  f"{name} {dt} position {t}: a logit is not finite")
            check(torch.equal(a.argmax(-1), toks[:, t].long()),
                  f"{name} {dt} position {t}: the teacher-forced logits' "
                  f"argmax is not the served token")
            err, scale, nan = rel_err(a, b)
            check(not nan and err <= tol * scale,
                  f"{name} {dt} position {t}: max|kernel - plain| logits "
                  f"{err:.3e} vs {tol:g} * {scale:.4g}")
            worst = max(worst, err / scale)
            top2 = b.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol * scale
            same = b.argmax(-1) == toks[:, t].long()
            check(bool((same | ~clear).all()),
                  f"{name} {dt} position {t}: the plain argmax differs "
                  f"from the served token where the top-2 margin exceeds "
                  f"{tol:g}")
            near += int((~clear).sum())
        del lk, lp
        # where the logits' gap comes from: forward with the kernels and
        # with the plain versions, each FFN's input layer by layer (the
        # encoder's first), the last position's hidden state and logits
        taps_k, taps_p = [], []
        with torch.no_grad():
            h_k, _ = TF.forward(
                params, cfg, batch["tokens"], **modality(batch),
                ffns=[probe(f, taps_k) for f in ffns],
                enc_ffns=None if enc is None else
                [probe(f, taps_k) for f in enc])
            h_p, _ = TF.forward(
                params, cfg, batch["tokens"], **modality(batch),
                ffns=[probe(plain(f), taps_p) for f in ffns],
                enc_ffns=None if enc is None else
                [probe(plain(f), taps_p) for f in enc])

            def gap(a, b) -> float:
                err, scale, _ = rel_err(a, b)
                return err / scale

            depth = [gap(a, b) for a, b in zip(taps_k, taps_p)]
            hidden = gap(h_k[:, -1], h_p[:, -1])
            logits = gap(TF._logits(params, cfg, h_k[:, -1:]),
                         TF._logits(params, cfg, h_p[:, -1:]))
        del taps_k, taps_p, h_k, h_p
        unit = one if dt == BF else 1.0
        what = f"{name}-kan {'bf16' if dt == BF else 'f32'}"
        kan_served[what] = {
            "launches": got[kname], "launches_a_prefill": per_prefill,
            "launches_a_decode_step": per_decode, "wall_s": wall,
            "max_err_over_scale": worst, "tol": tol, "near_ties": near,
            "per_launch": per_launch, "per_launch_tol": one,
            "forward_ffn_input_err_by_layer": depth,
            "forward_hidden_err": hidden, "forward_logits_err": logits,
            "params": n_params(params)}
        print(f"phase 12: {what}: {ED_BATCH} requests of {ED_PROMPT} tokens "
              f"+ {ED_NEW_TOKENS} decode steps through launch/steps, wall "
              f"{wall:.3f} s; {got[kname]} {kname} launches ({per_prefill} "
              f"a prefill, {per_decode} a decode step); teacher-forced "
              f"logits within {tol:g} of the plain versions' (max "
              f"{worst:.3e} of 1 + max|plain|), {near} near-tie positions; "
              f"each served launch within {one:g} of its plain version's (max "
              + ", ".join(f"{k} {v:.2e}" for k, v in per_launch.items())
              + f"); forward, err / (1 + max)"
              + (" in bf16 ulps" if dt == BF else "") + ": FFN inputs by "
              f"layer {' '.join(f'{v / unit:.3g}' for v in depth)}, the last "
              f"hidden state {hidden / unit:.3g}, its logits "
              f"{logits / unit:.3g}")

    # (b) whisper-medium-kan, bf16 and its f32 twin
    cfg_f = dataclasses.replace(ZOO[whisper], dtype="float32", **kan)
    t0 = time.perf_counter()
    params_f = TF.init_params(cfg_f, gen(0), dev)
    torch.cuda.synchronize()
    up_cfg, down_cfg = cfg_f.ffn_cfg(0).kan_cfgs()
    print(f"phase 12: (b) {whisper}-kan: {cfg_f.n_enc_layers} + "
          f"{cfg_f.n_layers} layers, d {cfg_f.d_model}, KAN FFNs "
          f"{up_cfg.n_in} -> {up_cfg.n_out} -> {down_cfg.n_out}, vocab "
          f"{cfg_f.vocab_size}; {n_params(params_f)} params, drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    served_kan(whisper, dataclasses.replace(cfg_f, dtype="bfloat16"),
               tree_map(lambda a: a.to(BF), params_f), 50)
    free()
    served_kan(whisper, cfg_f, params_f, 50)
    del params_f
    free()

    # (c) paligemma-3b-kan at bf16
    cfg_b = dataclasses.replace(ZOO[pali], dtype="bfloat16", **kan)
    t0 = time.perf_counter()
    params_b = tree_map(lambda a: a.to(BF), TF.init_params(
        dataclasses.replace(cfg_b, dtype="float32"), gen(1), dev))
    free()
    pup, _ = cfg_b.ffn_cfg(0).kan_cfgs()
    print(f"phase 12: (c) {pali}-kan: {cfg_b.n_layers} layers, d "
          f"{cfg_b.d_model}, KAN FFNs {pup.n_in} -> {pup.n_out} -> "
          f"{pup.n_in}, vocab {cfg_b.vocab_size}; {n_params(params_b)} "
          f"bf16 params drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    served_kan(pali, cfg_b, params_b, 51)
    del params_b
    free()

    # (d) the archs as published: f32 checks, then bf16 times
    def dev_ms(fn, n: int) -> tuple:
        """(device ms a call, kernels a call, top device ops) over ``n``
        calls, from the profiler."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
        kern = sorted((e for e in prof.key_averages()
                       if str(getattr(e, "device_type", ""))
                       .endswith("CUDA")), key=lambda e: -_device_us(e))
        return (sum(_device_us(e) for e in kern) / n / 1e3,
                sum(e.count for e in kern) / n,
                [(e.key[:72], _device_us(e) / n, e.count / n)
                 for e in kern[:6]])

    timing, checks = {}, {}
    for name, seed in ((whisper, 2), (pali, 3)):
        cfg_f = dataclasses.replace(ZOO[name], dtype="float32")
        params_f = TF.init_params(cfg_f, gen(seed), dev)
        rng = np.random.default_rng(60 + seed)
        toks = torch.as_tensor(rng.integers(0, cfg_f.vocab_size,
                                            size=(2, 17)), device=dev)
        stub = 0.1 * torch.randn((2, cfg_f.n_frontend_tokens,
                                  cfg_f.d_model), generator=gen(70 + seed),
                                 device=dev)
        kw = {"frames" if cfg_f.enc_dec else "patches": stub}
        with torch.no_grad():
            inputs, labels = toks[:, :-1], toks[:, 1:]
            h, aux = TF.forward(params_f, cfg_f, inputs, **kw)
            loss = TF.lm_loss(params_f, cfg_f, h[:, -labels.shape[1]:],
                              labels)
            check(bool(torch.isfinite(loss)) and bool(torch.isfinite(aux)),
                  f"(d) {name} f32: forward + lm_loss not finite")
            got, want, full = [], [], None
            _, caches = TF.prefill(params_f, cfg_f, inputs[:, :4], **kw)
            if cfg_f.enc_dec:
                full = TF._logits(params_f, cfg_f, h)
            for t in range(4, 12):
                lg, caches = TF.decode_step(params_f, cfg_f,
                                            inputs[:, t:t + 1], caches)
                got.append(lg[:, 0])
                if cfg_f.enc_dec:
                    want.append(full[:, t])
                else:
                    want.append(TF.prefill(params_f, cfg_f,
                                           inputs[:, :t + 1], **kw)[0][:, 0])
        got, want = torch.stack(got, 1), torch.stack(want, 1)
        gap = (got - want).abs()
        check(bool((gap <= DECODE_TOL + DECODE_TOL * want.abs()).all()),
              f"(d) {name} f32: cached decode {float(gap.max()):.3e} from "
              f"{'forward' if cfg_f.enc_dec else 'a longer prefill'}, "
              f"beyond the reference's {DECODE_TOL}")
        checks[name] = {"loss": float(loss), "decode_gap": float(gap.max())}
        print(f"phase 12: (d) {name} f32: forward + lm_loss {float(loss):.4f}"
              f" (finite); cached decode = "
              f"{'forward' if cfg_f.enc_dec else 'a longer prefill'} within "
              f"{DECODE_TOL} (max |gap| {float(gap.max()):.3e})")
        del h, caches, got, want, full
        cfg = ZOO[name]
        params = tree_map(lambda a: a.to(BF), params_f)
        del params_f
        free()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        batch = batch_for(cfg, 80 + seed)
        prefill_step = ST.make_prefill_step(cfg)
        decode_step = ST.make_decode_step(cfg)
        _build.reset_launches()
        tok, caches = prefill_step(params, batch)
        step_batch = {"token": tok, "caches": caches}
        for _ in range(ED_NEW_TOKENS):
            tok, caches = decode_step(params, {"token": tok,
                                               "caches": caches})
            check(bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
                  f"(d) {name} bf16: a token out of the vocab")
        torch.cuda.synchronize()
        launches_only({}, f"(d) {name} bf16 (no kernel on this path)")
        del caches

        def pre():
            return prefill_step(params, batch)[0].cpu()

        def step():
            return decode_step(params, step_batch)[0].cpu()

        rec = {"card": card, "resident_bytes": resident}
        for what, fn in (("prefill", pre), ("decode_step", step)):
            host = host_ms(fn, iters=2, reps=3)
            dms, nk, top = dev_ms(fn, 2)
            check(dms > 0, f"(d) {name}: the profiler saw no device time")
            rec.update({f"{what}_host_ms": host, f"{what}_device_ms": dms,
                        f"{what}_idle_share": 1.0 - dms / host,
                        f"{what}_kernels": nk, f"{what}_top_device": top})
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        timing[name] = rec
        print(f"phase 12: (d) {name} at bf16, {ED_BATCH} requests of "
              f"{ED_PROMPT} tokens: a prefill step host "
              f"{rec['prefill_host_ms']:.3f} ms, device "
              f"{rec['prefill_device_ms']:.4f} ms (idle "
              f"{rec['prefill_idle_share'] * 100:.1f}%, "
              f"{rec['prefill_kernels']:.0f} kernels); a decode step host "
              f"{rec['decode_step_host_ms']:.3f} ms, device "
              f"{rec['decode_step_device_ms']:.4f} ms (idle "
              f"{rec['decode_step_idle_share'] * 100:.1f}%, "
              f"{rec['decode_step_kernels']:.0f} kernels; by device time "
              + ", ".join(f"{k} {us:.0f} us x{n:.0f}"
                          for k, us, n in rec["decode_step_top_device"])
              + f"); peak device memory "
              f"{rec['peak_device_bytes'] / 2**30:.2f} GiB, "
              f"{resident / 2**30:.2f} GiB resident ({card})")
        del params, batch, step_batch
        free()

    # (e) the reduced configs: the card against the CPU
    reduced = {}
    for name in (whisper, pali):
        for label, over in ((name, {}), (f"{name}-kan", kan)):
            cfg = dataclasses.replace(ZOO[name].reduce(), **over)
            p_cpu = TF.init_params(cfg, torch.Generator().manual_seed(4))
            p_dev = tree_map(lambda a: a.to(dev), p_cpu)
            rng = np.random.default_rng(33)
            tok = rng.integers(0, cfg.vocab_size, size=(2, 9))
            stub = (0.1 * rng.normal(size=(2, cfg.n_frontend_tokens,
                                           cfg.d_model))).astype(np.float32)
            key = "frames" if cfg.enc_dec else "patches"
            outs = []
            with torch.no_grad():
                for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
                    t = torch.as_tensor(tok, device=d)
                    kw = {key: torch.as_tensor(stub, device=d)}
                    h, aux = TF.forward(params, cfg, t[:, :8], **kw)
                    seq = [h, aux[None], TF.lm_loss(
                        params, cfg, h[:, -8:], t[:, 1:])[None]]
                    if cfg.enc_dec:
                        seq.append(TF.encode(params, cfg, kw[key]))
                    lg, c = TF.prefill(params, cfg, t[:, :5], **kw)
                    seq.append(lg)
                    for i in range(5, 8):
                        lg, c = TF.decode_step(params, cfg, t[:, i:i + 1], c)
                        seq.append(lg)
                    outs.append(seq)
            worst = 0.0
            for a, b in zip(*outs):
                err, scale, nan = rel_err(b.cpu(), a)
                check(not nan and err <= CPU_TOL * scale,
                      f"(e) {label}: the card {err:.3e} from the CPU, vs "
                      f"{CPU_TOL} * {scale:.4g}")
                worst = max(worst, err / scale)
            reduced[label] = worst
    print("phase 12: (e) the reduce()d configs at f32, the card against the "
          f"CPU within {CPU_TOL} (forward, aux, lm_loss, encode, prefill, 3 "
          "decode steps): " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in reduced.items()))

    # (f) token-only serving refuses both archs, as the reference's
    why = "needs modality inputs (frames/patches)"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", a],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC))) for a in (whisper, pali)]
    refusals = {}
    for a, proc in zip((whisper, pali), procs):
        out, err = proc.communicate(timeout=300)
        check(proc.returncode != 0 and why in err,
              f"(f) the launcher at --arch {a} exited {proc.returncode} "
              f"without the reference's refusal: {err[-500:]}")
        refusals[a] = err.strip().splitlines()[-1]
        cfg = ZOO[a].reduce()
        try:
            TransformerBackend(cfg, TF.init_params(cfg), device=DEVICE)
        except NotImplementedError as e:
            check(why in str(e), f"(f) TransformerBackend({a}): {e}")
        else:
            check(False, f"(f) TransformerBackend served {a}")
    print("phase 12: (f) the launcher and TransformerBackend refuse both "
          "archs on the card: " + "; ".join(f"{k}: {v}"
                                            for k, v in refusals.items()))
    # ... and ``python -m repro_torch.launch.steps`` serves both (reduced,
    # KAN drop-in) through the kernels
    runs = {a: subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.steps", "--arch", a,
         "--ffn", "kan", "--pattern", "0.5"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(SRC)))
        for a in (whisper, pali)}
    steps_cli = {}
    for a, r in runs.items():
        check(r.returncode == 0 and "'kan_fused_v2': " in r.stdout,
              f"(f) launch.steps --arch {a} exited {r.returncode} or "
              f"launched no fused-KAN kernel: {r.stdout[-500:]} "
              f"{r.stderr[-1000:]}")
        steps_cli[a] = r.stdout.splitlines()[0]
    print("phase 12: (f) launch.steps on the card: "
          + "; ".join(steps_cli.values()))

    seconds = time.perf_counter() - t_phase
    print(f"phase 12: {seconds:.1f} s")
    return {"seconds": seconds, "launches": launches_ed,
            "layer_err": layer_err, "kernel_rows": kernel_rows,
            "kan_served": kan_served, "checks": checks, "timing": timing,
            "reduced_vs_cpu": reduced, "refusals": refusals,
            "steps_cli": steps_cli}

def lm_train_phase(dev: torch.device, card: str) -> dict:
    """Phase 13: LM training of ``qwen2-0.5b`` with the reference's KAN
    drop-in (``ffn_kind="kan"``, ``pattern_rate=0.5``: every FFN 896 ->
    608 -> 896 through two fused-KAN launches, kept bases (0, 2, 4, 5,
    6)) at full width, ``SyntheticLM`` batches of ``LM_BATCH`` x
    ``LM_SEQ`` tokens (M = 1024 rows a KAN layer).

    (a) each KAN layer of the step at M = 1024 (896 -> 608 and 608 ->
    896), bf16, mixed (bf16 x, f32 fused rows: the train step's) and
    f32: the forward against its plain version (one bf16
    ulp; f32 ``KERNEL_TOL``), dx and d wt through the kernels against
    the same gradient from the plain versions on the card (bf16: the
    same backward with the plain spline basis, ``LM_LAYER_GRAD_ULPS``;
    f32: autograd through the plain version, ``KERNEL_TOL``), the
    launches of one forward and backward; the fused-KAN forward's and
    the spline basis's times and bounds at these shapes;
    (b) ``Trainer`` at bf16, full width and depth, ``LM_STEPS`` steps:
    the first loss near ln(vocab), every loss finite, the launches a
    step by kernel (``kan_fused_v2_mixed`` -- the bf16 model's t is f32,
    as the reference's -- and ``spline_basis_bf16``, 48 each, no other
    kernel of the port), host ms a step, device ms from the profiler,
    idle share, peak device memory, then one more step with each mixed
    launch held to its plain version on its input (one bf16 ulp);
    (c) the same at ``LM_RESTART_DEPTH`` layers, a clean run and one with
    ``failure_at=3``, ``ckpt_every=2``, ``keep=1`` through
    ``run_with_restarts``: the final state (params, moments, step) of
    the two bitwise equal; the time outside the steps (host copies,
    writes, the restore);
    (d) the f32 twin at full width and depth, ``LM_F32_STEPS`` steps
    along the kernel path: at each, the loss and every gradient leaf
    against the same step with every KAN FFN through the plain versions
    (autograd through them) on the same params, within ``LM_LOSS_RTOL``
    and ``LM_GRAD_TOL`` of ``1 + max|plain|``;
    (e) ``python -m repro_torch.launch.train --arch qwen2-0.5b --scale
    full --ffn kan --pattern 0.5 --steps 4 --seq 128 --batch 8``, as a
    subprocess, prints ``final step 4``;
    (f) ``LM_XLSTM_STEPS`` deterministic train steps of xlstm-125m at
    full size, twice from seed 0: finite losses, the two runs bitwise.
    Returns what it measured; raises on any fault."""
    import math
    import shutil
    from unittest import mock

    from repro_torch.configs.registry import ARCHS as ZOO
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.kernels.kan_fused import ops as KO
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.kernels.spline_basis.ref import spline_basis_plain
    from repro_torch.launch import steps as ST
    from repro_torch.models import ffn as FF
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw_update
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.utils import leaf_paths, tree_map

    t_phase = time.perf_counter()
    kan = {"ffn_kind": "kan", "pattern_rate": 0.5}
    cfg = dataclasses.replace(ZOO[LM_ARCH], **kan)
    M = LM_BATCH * LM_SEQ
    launches_lm: dict = {}

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def launched() -> dict:
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    # (a) each KAN layer of the step at M rows
    fcfg = cfg.ffn_cfg(0)
    up_cfg, down_cfg = fcfg.kan_cfgs()
    check(up_cfg.kb == LM_KB and down_cfg.kb == LM_KB
          and (up_cfg.n_in, up_cfg.n_out) == (cfg.d_model, LM_HIDDEN),
          f"(phase 13) the KAN drop-in's layers: {up_cfg}, {down_cfg}")
    p_f = FF.ffn_init(gen(60), fcfg, F32)
    spec = up_cfg.spec
    nbk = len(LM_KB)

    def plain_basis(x, spec, **_):
        return spline_basis_plain(x.reshape(-1), spec).reshape(
            *x.shape, spec.n_bases)

    kernel_rows, layer_err = [], {}
    for what, lcfg, lp in (("up", up_cfg, p_f["kan_up"]),
                           ("down", down_cfg, p_f["kan_down"])):
        n_in, n_out = lcfg.n_in, lcfg.n_out
        wt_f = KO.fuse_wt(lp["w_b"], KO.flatten_t(lp["t"], LM_KB), nbk)
        x_f = torch.randn((M, n_in), generator=gen(61), device=dev)
        g_f = torch.randn((M, n_out), generator=gen(62), device=dev)
        # bf16 fused rows (a model whose every leaf is cast to bf16), f32
        # rows beside a bf16 x (a bf16 model's own draw: f32 t, the train
        # step's path) and the f32 twin
        for prec, dt, wdt in (("bf16", BF, BF), ("mixed", BF, F32),
                              ("f32", F32, F32)):
            label = f"{what} {n_in}->{n_out} {prec}"
            x, wt, g = x_f.to(dt), wt_f.to(wdt).contiguous(), g_f.to(dt)
            xk = x.clone().requires_grad_(True)
            wk = wt.clone().requires_grad_(True)
            _build.reset_launches()
            y = KO.kan_fused_v2(xk, wk, spec, LM_KB)
            y.backward(g)
            torch.cuda.synchronize()
            sfx = SUFFIX[dt]
            kname = MIXED if prec == "mixed" else "kan_fused_v2" + sfx
            want = {kname: 1, "spline_basis" + sfx: 1 if dt == BF else 2}
            check(launched() == want, f"(a) {label}: launches "
                  f"{launched()}, want {want}")
            with torch.no_grad():
                ref = kan_fused_v2_ref(x, wt, spec, LM_KB)
            fwd_tol = BF16_ULP if dt == BF else KERNEL_TOL
            err_y, scale_y, nan = rel_err(y.detach(), ref)
            check(not nan and err_y <= fwd_tol * scale_y,
                  f"(a) {label}: forward {err_y:.3e} from its plain "
                  f"version, vs {fwd_tol:g} * {scale_y:.4g}")
            if dt == BF:
                with mock.patch.object(KO, "spline_basis", plain_basis):
                    dx_p, dwt_p = KO._bf16_grads(x, wt, g, spec, LM_KB,
                                                 True, True)
                grad_tol = LM_LAYER_GRAD_ULPS * BF16_ULP
            else:
                xp = x.clone().requires_grad_(True)
                wp = wt.clone().requires_grad_(True)
                kan_fused_v2_ref(xp, wp, spec, LM_KB).backward(g)
                dx_p, dwt_p = xp.grad, wp.grad
                grad_tol = KERNEL_TOL
            errs = {"y": err_y / scale_y}
            for name, got, want_g, gdt in (("dx", xk.grad, dx_p, dt),
                                           ("dwt", wk.grad, dwt_p, wdt)):
                check(got.dtype == gdt,
                      f"(a) {label}: {name} is {got.dtype}")
                err, scale, nan = rel_err(got, want_g)
                check(not nan and err <= grad_tol * scale,
                      f"(a) {label}: {name} {err:.3e} from the plain "
                      f"versions' gradient, vs {grad_tol:g} * {scale:.4g}")
                errs[name] = err / scale
            layer_err[label] = errs
            for k, v in launched().items():
                launches_lm[k] = launches_lm.get(k, 0) + v
            # times and bounds: the fused-KAN forward at these rows, and
            # the spline basis on the layer's clipped inputs (order K);
            # a step (b) launches the mixed kernel, the f32 twin (d) the
            # f32 one; no train path launches the bf16 kernel here; the
            # bf16 row times the bases the mixed one would
            kernel_rows += kan_layer_rows(
                x, wt, spec, LM_KB, prec, card, what,
                0 if prec == "bf16" else cfg.n_layers,
                0 if prec == "mixed" else cfg.n_layers * (
                    1 if dt == BF else 2))
            del x, wt, g, xk, wk, y, ref, dx_p, dwt_p
            free()
    del p_f
    free()
    print("phase 13: (a) the KAN drop-in's layers at M = "
          f"{M}: one fused-KAN (bf16, mixed or f32) and one (bf16 x) or two "
          "(f32) spline-basis "
          "launches a forward and backward, each within its tolerance of "
          "its plain version (err / (1 + max): " + "; ".join(
              f"{k} " + ", ".join(f"{n} {v:.2e}" for n, v in e.items())
              for k, e in layer_err.items()) + ")")

    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=LM_SEQ, global_batch=LM_BATCH))
    opts = ST.StepOptions(lr=3e-4, total_steps=LM_STEPS, warmup=0)

    def dev_ms(fn) -> tuple:
        """(device ms, kernels, top device ops) of one call of ``fn``,
        from the profiler."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.key_averages()
                       if str(getattr(e, "device_type", ""))
                       .endswith("CUDA")), key=lambda e: -_device_us(e))
        return (sum(_device_us(e) for e in kern) / 1e3,
                sum(e.count for e in kern),
                [(e.key[:72], _device_us(e) / 1e3, e.count)
                 for e in kern[:8]])

    # (b) Trainer at bf16, full width and depth
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, TrainerConfig(max_steps=LM_STEPS, log_every=1), dev,
                 data, opts)
    n_params = sum(int(a.numel()) for _, a in leaf_paths(tr.state["params"]))
    _build.reset_launches()
    out = tr.run()
    torch.cuda.synchronize()
    launches_b = launched()
    per_step = {k: v / LM_STEPS for k, v in launches_b.items()}
    # the bf16 model's t is f32 (the reference's kan_init): its fused rows
    # are f32, so every KAN layer is the mixed kernel, with no cast
    check(all(a.dtype == F32 for k, a in leaf_paths(tr.state["params"])
              if k.endswith("['t']")), "(b) a KAN layer's t is not f32")
    want = {MIXED: 2 * cfg.n_layers, "spline_basis_bf16": 2 * cfg.n_layers}
    check(per_step == want, f"(b) launches a step {per_step}, want {want}")
    for k, v in launches_b.items():
        launches_lm[k] = launches_lm.get(k, 0) + v
    losses = [m["loss"] for m in out["metrics"]]
    check(out["final_step"] == LM_STEPS and all(map(math.isfinite, losses)),
          f"(b) final step {out['final_step']}, losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < LM_FIRST_LOSS_TOL,
          f"(b) first loss {losses[0]:.4f}, ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f}")
    host_steps = [m["step_time_s"] * 1e3 for m in out["metrics"][1:]]
    peak = torch.cuda.max_memory_allocated()
    batch = tr.batch_at(LM_STEPS)
    step_fn = ST.make_train_step(cfg, opts)
    dms, nk, top = dev_ms(lambda: step_fn(tr.state, batch))
    check(dms > 0, "(b) the profiler saw no device time")
    # one more step, each of its mixed launches held to its plain version
    # on the input it is served: one launch's tolerance (one bf16 ulp)
    held = {"n": 0, "worst": 0.0}
    served_v2 = KO.kan_fused_v2

    def held_v2(x, wt, spec, kb, slot_of=None, **kw):
        y = served_v2(x, wt, spec, kb, slot_of, **kw)
        with torch.no_grad():
            ref = kan_fused_v2_ref(x.detach(), wt.detach(), spec, kb,
                                   kw.get("out_dtype"))
        err, scale, nan = rel_err(y.detach(), ref)
        check(not nan and err <= BF16_ULP * scale,
              f"(b) a {MIXED} launch {tuple(x.shape)} -> {tuple(y.shape)}: "
              f"{err:.3e} from its plain version, vs {BF16_ULP:g} * "
              f"{scale:.4g}")
        held["n"] += 1
        held["worst"] = max(held["worst"], err / scale)
        return y

    before = dict(_build.LAUNCHES)
    with mock.patch.object(KO, "kan_fused_v2", held_v2):
        step_fn(tr.state, batch)
    torch.cuda.synchronize()
    check(held["n"] == 2 * cfg.n_layers and _build.LAUNCHES[MIXED] -
          before[MIXED] == held["n"], f"(b) the held step ran {held['n']} "
          f"layer calls, {_build.LAUNCHES[MIXED] - before[MIXED]} launches")
    host_med = statistics.median(host_steps)
    train = {"arch": cfg.name, "params": n_params, "steps": LM_STEPS,
             "losses": losses, "launches_a_step": per_step,
             "mixed_launches_held": held["n"],
             "mixed_worst_err": held["worst"],
             "host_ms_steps": host_steps, "host_ms": host_med,
             "device_ms": dms, "idle_share": 1.0 - dms / host_med,
             "kernels_a_step": nk, "top_device_ops": top,
             "peak_device_bytes": peak,
             "seconds": time.perf_counter() - t0, "card": card}
    print(f"phase 13: (b) {cfg.name} KAN drop-in, bf16, {n_params / 1e6:.1f}"
          f" M params, {LM_STEPS} steps of {LM_BATCH} x {LM_SEQ}: losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; launches a step {per_step}; host {host_med:.3f} ms a step "
          f"(median of steps 1-{LM_STEPS - 1}), device {dms:.3f} ms (idle "
          f"{train['idle_share'] * 100:.1f}%, {nk} kernels), peak "
          f"{peak / 2 ** 30:.2f} GiB; top device ops {top[:4]}; one more "
          f"step's {held['n']} {MIXED} launches within "
          f"{held['worst'] / BF16_ULP:.2f} bf16 ulps of their plain "
          f"versions ({card})")
    del tr, out, batch
    free()

    # (c) restart at LM_RESTART_DEPTH layers, bitwise a clean run
    t0 = time.perf_counter()
    cfg_c = dataclasses.replace(cfg, n_layers=LM_RESTART_DEPTH)
    clean = Trainer(cfg_c, TrainerConfig(max_steps=LM_STEPS, log_every=100),
                    dev, data, opts)
    clean.run()
    ck = tempfile.mkdtemp(prefix="lm_restart_")
    try:
        faulty = Trainer(cfg_c, TrainerConfig(
            max_steps=LM_STEPS, ckpt_dir=ck, ckpt_every=2, keep=1,
            failure_at=3, log_every=100), dev, data, opts)
        t1 = time.perf_counter()
        fout = faulty.run_with_restarts(max_restarts=1)
        wall = time.perf_counter() - t1
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ck) for f in fs)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check(fout["final_step"] == LM_STEPS, f"(c) final step "
          f"{fout['final_step']}")
    a, b = leaf_paths(clean.state), leaf_paths(faulty.state)
    check([k for k, _ in a] == [k for k, _ in b] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, b)),
        "(c) the restarted run's state is not the clean run's, bitwise")
    outside = wall - sum(m["step_time_s"] for m in fout["metrics"])
    restart = {"n_layers": LM_RESTART_DEPTH, "bitwise": True,
               "steps_run": len(fout["metrics"]), "wall_s": wall,
               "outside_steps_s": outside, "checkpoint_bytes": ckpt_bytes,
               "seconds": time.perf_counter() - t0, "card": card}
    print(f"phase 13: (c) {LM_RESTART_DEPTH} of {cfg.n_layers} layers: "
          f"failed at step 3, restored from step 2, final state bitwise "
          f"the clean run's; {len(fout['metrics'])} steps in {wall:.2f} s, "
          f"{outside:.2f} s outside the steps (copies, writes of "
          f"{ckpt_bytes / 2 ** 30:.2f} GiB a step kept, the restore)")
    del clean, faulty
    free()

    # (d) the f32 twin at full width: kernels against plain versions
    t0 = time.perf_counter()
    cfg_f = dataclasses.replace(cfg, dtype="float32")
    state = ST.init_train_state(cfg_f, opts, gen(63), dev)
    opt_cfg = ST.default_opt_cfg(opts)

    def plain_ffns(live):
        def pair(fc, p):
            up, down = fc.kan_cfgs()

            def layer(c, lp, h):
                wt = KO.fuse_wt(lp["w_b"], KO.flatten_t(lp["t"], c.kb),
                                len(c.kb))
                return kan_fused_v2_ref(h, wt, c.spec, c.kb)

            def fn(x):
                lead = x.shape[:-1]
                h = layer(up, p["kan_up"], x.reshape(-1, up.n_in))
                return layer(down, p["kan_down"], h).reshape(
                    *lead, down.n_out)
            return fn
        return [pair(cfg_f.ffn_cfg(0), bp["ffn"])
                for _, _, bp, _ in TF._layers(live, cfg_f)]

    twin = []
    _build.reset_launches()
    for s in range(LM_F32_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(s).items()}
        before = dict(_build.LAUNCHES)
        with ST.deterministic(dev):
            total, ce, grads = ST.value_and_grad(cfg_f, opts,
                                                 state["params"], batch)
        step_launch = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                       if v != before[k]}
        want = {"kan_fused_v2": 2 * cfg.n_layers,
                "spline_basis": 4 * cfg.n_layers}
        check(step_launch == want, f"(d) step {s}: launches {step_launch}, "
              f"want {want}")
        before = dict(_build.LAUNCHES)
        with ST.deterministic(dev):
            ptotal, pce, pgrads = ST.value_and_grad(
                cfg_f, opts, state["params"], batch, ffns_of=plain_ffns)
        check(_build.LAUNCHES == before, "(d) the plain path launched a "
              "kernel")
        loss_err = abs(float(ce) - float(pce)) / abs(float(pce))
        check(loss_err <= LM_LOSS_RTOL, f"(d) step {s}: loss {float(ce)} vs "
              f"plain {float(pce)} ({loss_err:.2e} relative)")
        worst = (0.0, "")
        pg = dict(leaf_paths(pgrads))
        for k, v in leaf_paths(grads):
            err, scale, nan = rel_err(v, pg[k])
            check(not nan and err <= LM_GRAD_TOL * scale,
                  f"(d) step {s}: gradient {k} {err:.3e} from the plain "
                  f"path's, vs {LM_GRAD_TOL:g} * {scale:.4g}")
            worst = max(worst, (err / scale, k))
        twin.append({"step": s, "loss": float(ce), "plain_loss": float(pce),
                     "loss_rel_err": loss_err, "worst_grad": worst})
        new_params, new_opt, _ = adamw_update(grads, state["opt"],
                                              state["params"], opt_cfg)
        state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
        del grads, pgrads, pg
        free()
    for k, v in launched().items():
        launches_lm[k] = launches_lm.get(k, 0) + v
    print(f"phase 13: (d) the f32 twin, {LM_F32_STEPS} steps, kernels "
          f"against plain versions on the same params: " + "; ".join(
              f"step {t['step']} loss {t['loss']:.6f} ({t['loss_rel_err']:.1e}"
              f" rel), worst gradient {t['worst_grad'][0]:.2e} at "
              f"{t['worst_grad'][1]}" for t in twin)
          + f" ({time.perf_counter() - t0:.1f} s)")
    del state
    free()

    # (e) the launcher, as a subprocess
    t0 = time.perf_counter()
    ck = tempfile.mkdtemp(prefix="lm_launcher_")
    try:
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             LM_ARCH, "--scale", "full", "--ffn", "kan", "--pattern", "0.5",
             "--steps", "4", "--seq", str(LM_SEQ), "--batch",
             str(LM_BATCH), "--ckpt-dir", ck],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    check(run.returncode == 0 and tail.startswith("final step 4,"),
          f"(e) the launcher: rc {run.returncode}, last line {tail!r}, "
          f"stderr {run.stderr[-2000:]}")
    print(f"phase 13: (e) python -m repro_torch.launch.train --arch "
          f"{LM_ARCH} --scale full --ffn kan --pattern 0.5 --steps 4: "
          f"{tail!r} ({time.perf_counter() - t0:.1f} s)")

    # (f) xlstm-125m: deterministic train steps on the card, twice
    t0 = time.perf_counter()
    cfg_x = ZOO[LM_XLSTM]
    data_x = SyntheticLM(LMDataConfig(vocab_size=cfg_x.vocab_size,
                                      seq_len=LM_SEQ, global_batch=LM_BATCH))
    step_x = ST.make_train_step(cfg_x, opts)
    runs_x = []
    for _ in range(2):
        st = ST.init_train_state(cfg_x, opts, gen(64), dev)
        losses_x = []
        for s in range(LM_XLSTM_STEPS):
            st, m = step_x(st, {k: torch.from_numpy(v).to(dev)
                                for k, v in data_x.batch_at(s).items()})
            losses_x.append(float(m["loss"]))
        runs_x.append((losses_x, [a.cpu() for _, a in leaf_paths(st)]))
        del st
        free()
    (l1, s1), (l2, s2) = runs_x
    check(all(map(math.isfinite, l1)) and l1 == l2 and all(
        torch.equal(a, b) for a, b in zip(s1, s2)),
        f"(f) {LM_XLSTM}: losses {l1} and {l2}, or states, differ")
    xlstm = {"arch": LM_XLSTM, "losses": l1, "bitwise": True,
             "seconds": time.perf_counter() - t0, "card": card}
    print(f"phase 13: (f) {LM_XLSTM} ({cfg_x.dtype}), {LM_XLSTM_STEPS} "
          f"deterministic train steps of {LM_BATCH} x {LM_SEQ}, twice: "
          f"losses {l1}, the two runs' states bitwise "
          f"({xlstm['seconds']:.1f} s)")
    del runs_x, s1, s2
    print(f"phase 13: LM training passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches_lm}")
    return {"kernel_rows": kernel_rows, "layer_err": layer_err,
            "train": train, "restart": restart, "f32_twin": twin,
            "launcher": tail, "xlstm": xlstm, "launches": launches_lm,
            "launches_b": launches_b,
            "seconds": time.perf_counter() - t_phase}


def array_phase(dev: torch.device, card: str, hold) -> dict:
    """Phase 14: the VIKIN array plans (``runtime/sharded``) on the card,
    at the paper's Table I widths from seed 0, every array's chips
    logical chips of one card (``ARRAY_CHIPS``).

    (a) data plan: vikin-mixed and vikin-mlp3 over 4 chips at f32, bf16
    and int8: 48 requests on 8 slots, and single ticks of 1, 2, 6, 9 and
    33 active requests (per-shard buckets 2, 4 and 16): every answer
    bitwise the single-device ``VikinBackend``'s on the card and held by
    ``hold`` (phase 3's) to the plain versions, the launches equal to
    the per-shard layer applications; host ms a batch at bucket 8
    against the single-device backend's;
    (b) pipeline plan: vikin-mixed over 3 chips (even split) and with
    ``stage_map=[2, 1]``, f32 and bf16: bitwise ``--devices 1``, one
    launch a layer a tick;
    (c) hetero plan: vikin-mixed over pins pipeline, pipeline, parallel,
    parallel, and the two-workload engine vikin-kan2 + vikin-mlp3 of
    hetero arrays on an interleaved stream: bitwise the single-request
    answers, ``reconfig_cycles == 0``, admitted in arrival order;
    (d) refusals: int8 on a staged plan, a hetero array missing a needed
    mode, and more cards than are visible, each with the reference's
    facts;
    (e) ``serving_bench.run`` (every row family) into phase 7's
    ``chiprun_out/serving_bench.json`` beside its open-loop rows: 13
    rows, then ``check_regression --serving`` exits 0 against
    ``BENCH_serving.json``;
    (f) ``roofline --engine`` at batch 1 and 8, f32, bf16 and int8:
    every row equal to a CPU-only process's run of the same call;
    (g) ``python -m repro_torch.examples.serve_batch`` runs to its end.
    Returns what it measured; raises on any fault."""
    from repro_torch.benchmarks import check_regression, roofline
    from repro_torch.benchmarks import serving_bench
    from repro_torch.configs.vikin_models import VIKIN_ARCHS
    from repro_torch.core.modes import ExecMode
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_vikin_backend
    from repro_torch.runtime.backends import MultiWorkloadBackend
    from repro_torch.runtime.server import Engine
    from repro_torch.runtime.sharded import (
        ShardedVikinBackend,
        make_array_backend,
    )

    t_phase = time.perf_counter()
    secs, launches, rec = {}, {}, {"card": card}
    # ["cuda:0"] * ARRAY_CHIPS on the card: the bench's own device list
    chips = [str(d) for d in serving_bench.array_devices(ARRAY_CHIPS,
                                                         DEVICE)]
    rng = np.random.default_rng(0)
    kernels = {"f32": F32_KERNELS, "int8": Q8_KERNELS, "bf16": BF16_KERNELS}

    def serve(backend, xs, n_slots: int) -> tuple:
        """(answers in submission order, engine stats, launches of the
        run) of ``xs`` through an engine over ``backend``."""
        eng = Engine(backend, n_slots=n_slots)
        rids = [eng.submit(x) for x in xs]
        _build.reset_launches()
        out = eng.run_until_done()
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return np.stack([out[r] for r in rids]), dict(eng.stats), got

    def want(model, precision: str, applications: int) -> dict:
        """The launches of ``applications`` passes of every layer."""
        kan_k, mm_k = kernels[precision]
        kinds = model.layer_kinds
        return {k: n * applications for k, n in
                ((kan_k, kinds.count("kan")), (mm_k, kinds.count("mlp")))
                if n}

    # (a) the data plan
    t0 = time.perf_counter()
    rec["data"] = []
    for name in ("vikin-mixed", "vikin-mlp3"):
        model = VIKIN_ARCHS[name]
        xs = [rng.random(model.sizes[0], dtype=np.float32)
              for _ in range(48)]
        for precision in ("f32", "bf16", "int8"):
            single = make_vikin_backend(model, DEVICE, precision=precision)
            multi = make_vikin_backend(model, DEVICE, precision=precision,
                                       devices=chips, plan="data")
            check(isinstance(multi, ShardedVikinBackend)
                  and len(multi.stacks()) == 1,
                  f"(a) {name} {precision}: {len(multi.stacks())} stacks "
                  f"for 4 shards on one card")
            what = f"(a) {name} {precision}"
            y1, s1, _ = serve(single, xs, 8)
            yn, sn, burst = serve(multi, xs, 8)
            implied = want(model, precision, ARRAY_CHIPS * int(sn["ticks"]))
            check(np.array_equal(y1, yn),
                  f"{what}: data-plan answers != the single-device ones")
            check(burst == implied,
                  f"{what}: launched {burst}, {ARRAY_CHIPS} shards x "
                  f"{int(sn['ticks'])} ticks imply {implied}")
            check(abs(sn["sim_cycles"] - sn["chip_cycles"]
                      - sn["comm_cycles"]) <= 1e-6 * sn["sim_cycles"],
                  f"{what}: sim_cycles {sn['sim_cycles']} != chip "
                  f"{sn['chip_cycles']} + comm {sn['comm_cycles']}")
            err, _ = hold(precision, single.stack, np.stack(xs), yn, what)
            buckets = {}
            for n in (1, 2, 6, 9, 33):
                sub = [rng.random(model.sizes[0], dtype=np.float32)
                       for _ in range(n)]
                a1, _, _ = serve(single, sub, n)
                an, _, got = serve(multi, sub, n)
                b = multi.shard_bucket(n)
                check(np.array_equal(a1, an), f"{what}: {n} active "
                      f"(per-shard bucket {b}): answers != single-device")
                check(got == want(model, precision, ARRAY_CHIPS),
                      f"{what}: {n} active launched {got}")
                hold(precision, single.stack, np.stack(sub), an,
                     f"{what} {n} active")
                buckets[n] = b
            check(sorted(set(buckets.values())) == [2, 4, 16],
                  f"{what}: per-shard buckets {buckets}")
            xb = np.stack(xs[:8])
            ms1 = host_ms(lambda: single.forward(xb))
            msn = host_ms(lambda: multi.forward(xb))
            rec["data"].append({
                "arch": name, "precision": precision, "ticks": sn["ticks"],
                "launches": burst, "max_abs_err": err,
                "per_shard_buckets": buckets, "host_ms_single_b8": ms1,
                "host_ms_data_b8": msn, "sim_cycles": sn["sim_cycles"],
                "chip_cycles": sn["chip_cycles"],
                "comm_cycles": sn["comm_cycles"]})
            print(f"phase 14: {what}: 48 requests on 8 slots and 1/2/6/9/33 "
                  f"active (per-shard buckets {buckets}) over {chips}: "
                  f"bitwise the single-device answers, within tolerance of "
                  f"the plain versions (max abs err {err:.3e}), launches "
                  f"{burst} = {ARRAY_CHIPS} shards x the layers a tick; host "
                  f"ms a batch at "
                  f"bucket 8: single {ms1:.4f}, data plan {msn:.4f} ({card})")
    secs["a"] = time.perf_counter() - t0

    # (b) the pipeline plan
    t0 = time.perf_counter()
    mixed = VIKIN_ARCHS["vikin-mixed"]
    xs = [rng.random(mixed.sizes[0], dtype=np.float32) for _ in range(48)]
    rec["pipeline"] = []
    for precision in ("f32", "bf16"):
        single = make_vikin_backend(mixed, DEVICE, precision=precision)
        y1, s1, _ = serve(single, xs, 8)
        for n, stage_map in ((3, None), (3, [2, 1])):
            pipe = make_vikin_backend(mixed, DEVICE, precision=precision,
                                      devices=chips[:n],
                                      plan="pipeline", stage_map=stage_map)
            yp, sp, got = serve(pipe, xs, 8)
            what = f"(b) pipeline {precision} stage_map={stage_map}"
            check(np.array_equal(y1, yp),
                  f"{what}: answers != the single-device ones")
            check(got == want(mixed, precision, int(sp["ticks"])),
                  f"{what}: launched {got}")
            check("bubble_cycles" in sp, f"{what}: no bubble_cycles")
            stages = [(lo, hi) for lo, hi, _ in pipe._stage_ranges()]
            rec["pipeline"].append({"precision": precision,
                                    "stages": stages, "launches": got,
                                    "sim_cycles": sp["sim_cycles"],
                                    "bubble_cycles": sp["bubble_cycles"]})
            print(f"phase 14: {what}: stages {stages}, 48 requests bitwise "
                  f"the single-device answers, launches {got}, bubble "
                  f"{sp['bubble_cycles']:.0f} cycles")
    secs["b"] = time.perf_counter() - t0

    # (c) the hetero plan
    t0 = time.perf_counter()
    pins = ["pipeline", "pipeline", "parallel", "parallel"]
    rec["hetero"] = {}
    for precision in ("f32", "bf16"):
        single = make_vikin_backend(mixed, DEVICE, precision=precision)
        het = make_vikin_backend(mixed, DEVICE, precision=precision,
                                 devices=chips, plan="hetero",
                                 mode_pins=pins)
        y1, s1, _ = serve(single, xs, 8)
        yh, sh, got = serve(het, xs, 8)
        check(np.array_equal(y1, yh) and sh["reconfig_cycles"] == 0
              and s1["reconfig_cycles"] > 0
              and got == want(mixed, precision, int(sh["ticks"])),
              f"(c) hetero {precision}: bitwise {np.array_equal(y1, yh)}, "
              f"reconfig {sh['reconfig_cycles']} (single "
              f"{s1['reconfig_cycles']}), launched {got}")
        rec["hetero"][precision] = {"launches": got,
                                    "sim_cycles": sh["sim_cycles"]}
    pair = ("vikin-kan2", "vikin-mlp3")
    stream = [(a, rng.random(VIKIN_ARCHS[a].sizes[0], dtype=np.float32))
              for a in pair * 16]
    singles = {}
    for a in pair:
        eng = Engine(make_vikin_backend(VIKIN_ARCHS[a], DEVICE), n_slots=8)
        for i, (w, x) in enumerate(stream):
            if w == a:
                rid = eng.submit(x)
                singles[i] = eng.run_until_done()[rid]
    mwb = MultiWorkloadBackend({a: make_vikin_backend(
        VIKIN_ARCHS[a], DEVICE, devices=chips, plan="hetero") for a in pair})
    check(mwb.pinned_modes == frozenset(ExecMode),
          f"(c) the engine's pinned modes {mwb.pinned_modes}")
    admitted, prefill = [], mwb.prefill

    def note_prefill(state, slot, req):
        admitted.append((eng.stats["ticks"], req.rid))
        return prefill(state, slot, req)
    mwb.prefill = note_prefill
    eng = Engine(mwb, n_slots=8, policy="mode-affinity")
    reqs = [eng.submit(x, workload=a) for a, x in stream]
    _build.reset_launches()
    out = eng.run_until_done()
    torch.cuda.synchronize()
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    # arrival order at the queue heads: every tick serves the workload
    # holding the oldest waiting request (one chip per workload under
    # mode-affinity would keep the carried mode's workload instead)
    waiting, heads = set(reqs), []
    for tick in sorted({t for t, _ in admitted}):
        batch = {r for t, r in admitted if t == tick}
        heads.append(min(batch) == min(waiting))
        waiting -= batch
    check(all(heads) and not waiting,
          f"(c) the two-workload hetero engine skipped the oldest waiting "
          f"request: ticks {admitted}")
    check(all(np.array_equal(out[r], singles[i])
              for i, r in enumerate(reqs)),
          "(c) the two-workload hetero engine's answers != single-request")
    check(eng.stats["reconfig_cycles"] == 0
          and eng.stats["mode_switches"] == 0,
          f"(c) the two-workload hetero engine paid "
          f"{eng.stats['reconfig_cycles']} reconfig cycles")
    rec["hetero"]["two_workload"] = {
        "ticks": eng.stats["ticks"], "launches": got,
        "p95_queue_wait_sim_s": eng.stats.get("p95_queue_wait_sim_s")}
    print(f"phase 14: (c) hetero over pins {pins}: vikin-mixed f32 and bf16 "
          f"bitwise --devices 1 with 0 reconfig cycles; vikin-kan2 + "
          f"vikin-mlp3, 32 interleaved requests in {int(eng.stats['ticks'])}"
          f" ticks, each serving the oldest waiting request's workload, "
          f"bitwise the single-request "
          f"answers, 0 flips, launches {got}")
    secs["c"] = time.perf_counter() - t0

    # (d) refusals on the card
    t0 = time.perf_counter()
    params = serving_bench.seeded_params(mixed, 0)
    refusals = {}
    for label, call, text in (
            ("int8 staged", lambda: make_array_backend(
                mixed, params, devices=chips, plan="pipeline",
                precision="int8", scales=object()), "f32/bf16 only"),
            ("hetero missing a mode", lambda: make_array_backend(
                mixed, params, devices=chips, plan="hetero",
                mode_pins=["parallel"] * ARRAY_CHIPS),
             "no chip pinned to 'pipeline'"),
            ("more cards than visible", lambda: ShardedVikinBackend(
                mixed, params, devices=torch.cuda.device_count() + 1),
             "visible")):
        try:
            call()
        except ValueError as e:
            check(text in str(e), f"(d) {label}: {e}")
            refusals[label] = str(e)
            continue
        check(False, f"(d) {label} was not refused")
    rec["refusals"] = refusals
    for label, msg in refusals.items():
        print(f"phase 14: (d) {label}: refused: {msg}")
    secs["d"] = time.perf_counter() - t0

    # (f) and (g) run in other processes beside (e): roofline in a
    # CPU-only process, the example on the card
    env = dict(os.environ, PYTHONPATH=str(SRC))
    rl_dir = ROOT / "chiprun_out" / "roofline"
    rl_dir.mkdir(parents=True, exist_ok=True)
    combos = [(b, p) for b in (1, 8) for p in ("f32", "bf16", "int8")]
    rl_code = ("from repro_torch.benchmarks import roofline\n" + "".join(
        f"roofline.main(['--engine', '--batch', '{b}', '--precision', "
        f"'{p}', '--out', '{rl_dir}/engine_{p}_b{b}.json'])\n"
        for b, p in combos))
    t0 = time.perf_counter()
    rl_proc = subprocess.Popen(
        [sys.executable, "-c", rl_code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, CUDA_VISIBLE_DEVICES=""))
    ex_proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.serve_batch"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    # (e) every bench row, then the gate
    bench_out = ROOT / "chiprun_out" / "serving_bench.json"
    rows = serving_bench.run(DEVICE, bench_out)
    file_rows = json.loads(bench_out.read_text())
    check(len(file_rows) == 13 and all(
              k in file_rows for k in ("openloop:sweep:vikin-mlp3",
                                       "openloop:burst:vikin-mlp3")),
          f"(e) {bench_out} holds {sorted(file_rows)}")
    check(all(r.get("device_list") == chips for k, r in rows.items()
              if k.startswith(("sharded:", "pipe:", "hetero:"))),
          "(e) an array row ran on another device list")
    gate = check_regression.main(["--serving", "--fresh", str(bench_out)])
    check(gate == 0, f"(e) check_regression --serving exited {gate}")
    rec["bench_rows"] = sorted(file_rows)
    secs["e"] = time.perf_counter() - t0

    # (f) the engine roofline, this process against the CPU-only one
    t0 = time.perf_counter()
    out_rl, err_rl = rl_proc.communicate(timeout=300)
    check(rl_proc.returncode == 0,
          f"(f) the roofline process exited {rl_proc.returncode}: "
          f"{err_rl[-2000:]}")
    for b, p in combos:
        cpu_rows = json.loads((rl_dir / f"engine_{p}_b{b}.json").read_text())
        here = json.loads(json.dumps(roofline.engine_rows(b, p)))
        check(here == cpu_rows, f"(f) roofline batch {b} {p}: rows differ "
              f"from the CPU-only run's")
    print(f"phase 14: (f) roofline --engine at batch 1 and 8, f32/bf16/int8: "
          f"{len(cpu_rows)} rows each, equal to a CPU-only process's")
    secs["f"] = time.perf_counter() - t0

    # (g) the batched-serving example on the card
    t0 = time.perf_counter()
    out_ex, err_ex = ex_proc.communicate(timeout=600)
    check(ex_proc.returncode == 0 and "vikin-mixed: 6 requests" in out_ex,
          f"(g) examples/serve_batch exited {ex_proc.returncode}: "
          f"{out_ex[-1000:]} {err_ex[-2000:]}")
    print(f"phase 14: (g) examples/serve_batch on the card: "
          f"{out_ex.strip().splitlines()[-1]}")
    secs["g"] = time.perf_counter() - t0

    rec.update(secs=secs, launches=launches)
    print(f"phase 14: seconds by part " + ", ".join(
        f"({k}) {v:.1f}" for k, v in secs.items())
        + f"; launches of the served runs {launches}; {card}")
    print(f"phase 14: array plans passed in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return rec


def _mesh_lm_cfg():
    """Phase 15 (a)-(b), (d): qwen2-0.5b with the reference's KAN
    drop-in at full width and depth (bf16, its t f32)."""
    from repro_torch.configs.registry import ARCHS as ZOO
    return dataclasses.replace(ZOO[LM_ARCH], ffn_kind="kan",
                               pattern_rate=0.5)


def _mesh_ep_cfg():
    from repro_torch.configs.registry import ARCHS as ZOO
    return dataclasses.replace(ZOO[MESH_EP_ARCH], n_layers=MESH_EP_DEPTH)


def _mesh_data(cfg):
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    return SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=LM_SEQ, global_batch=LM_BATCH))


def _mesh_opts(**over):
    from repro_torch.launch import steps as ST
    return ST.StepOptions(lr=3e-4, total_steps=LM_STEPS, warmup=0, **over)


def _profile_ms(fn) -> dict:
    """Device ms of one call of ``fn`` from the profiler: all of it, the
    host <-> device copies' (``Memcpy``) and the copy kernels' share of
    the kernels' time (the widening ``.to`` copies)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(_device_us(e) for e in dev)
    memcpy = sum(_device_us(e) for e in dev if e.key.startswith("Memcpy"))
    kern = total - memcpy
    copies = sum(_device_us(e) for e in dev
                 if "copy" in e.key.lower() and not e.key.startswith("Memcpy"))
    return {"device_ms": total / 1e3, "memcpy_ms": memcpy / 1e3,
            "kernel_ms": kern / 1e3,
            "copy_share": copies / kern if kern else float("nan")}


def _tap_logits(TF):
    """(a patcher of ``TF.greedy_token``, the list it fills): each greedy
    token the serve steps take records the last position's logits, f32
    (a rank's vocab columns under a vocab-parallel head)."""
    from unittest import mock

    seen, greedy = [], TF.greedy_token

    def tapped(lg, cfg=None):
        seen.append(lg[:, -1].float())
        return greedy(lg, cfg)

    return mock.patch.object(TF, "greedy_token", tapped), seen


def _held_layers(ffns, what: str, stats: dict):
    """A context in which each KAN layer of the held FFN modules ``ffns``
    holds every launch to its plain version on its input (one bf16 ulp of
    1 + max|plain|; a tensor-parallel ``kan_down``'s f32 partial too),
    counting them, the worst err / scale and the shapes in ``stats``."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref

    stack = contextlib.ExitStack()
    for mod in ffns:
        for layer in (mod.up, mod.down):
            def fwd(x, out_dtype=None, layer=layer, run=layer.forward):
                y = run(x, out_dtype)
                xf = x.reshape(-1, layer.cfg.n_in)
                ref = kan_fused_v2_ref(xf, layer.wt, layer.cfg.spec,
                                       layer.kb, out_dtype)
                err, scale, nan = rel_err(y.reshape(ref.shape), ref)
                check(not nan and err <= BF16_ULP * scale,
                      f"{what}: a {MIXED} launch {tuple(xf.shape)} -> "
                      f"{tuple(ref.shape)} {ref.dtype}: {err:.3e} from its "
                      f"plain version, vs {BF16_ULP:g} * {scale:.4g}")
                stats["n"] += 1
                stats["worst"] = max(stats["worst"], err / scale)
                shape = [list(xf.shape), list(layer.wt.shape), str(ref.dtype)]
                if shape not in stats["shapes"]:
                    stats["shapes"].append(shape)
                return y
            stack.enter_context(mock.patch.object(layer, "forward", fwd))
    return stack


def _serve_run(pre, dec, params, batch: dict, fed: list, sync,
               profile: bool = False) -> tuple:
    """A prefill of ``batch`` and a decode step a token of ``fed`` (the
    teacher's): (record, caches).  The record holds each step's greedy
    tokens, host ms, collectives and launches; with ``profile`` also the
    device time of one more prefill and one more decode step from the
    profiler (not counted)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import collectives as COLL

    rec: dict = {"tokens": [], "host_ms": [], "sent": [], "launches": [],
                 "arg_bytes": []}

    def step(fn, *args):
        rec["arg_bytes"].append(_tree_bytes(list(args)))
        sync()
        _build.reset_launches()
        COLL.reset_sent()
        t0 = time.perf_counter()
        tok, caches = fn(*args)
        sync()
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["sent"].append(dict(COLL.SENT))
        rec["launches"].append({k: v for k, v in _build.LAUNCHES.items()
                                if v})
        rec["tokens"].append(tok.cpu())
        return caches

    caches = step(pre, params, batch)
    first = caches
    for tok in fed:
        caches = step(dec, params, {"token": tok, "caches": caches})
    if profile:
        rec["prefill_prof"] = _profile_ms(lambda: pre(params, batch))
        rec["decode_prof"] = _profile_ms(lambda: dec(
            params, {"token": fed[0], "caches": first}))
    return rec, caches


def _ms(v, digits: int) -> str:
    """A profiled time in ms, or "not profiled"."""
    return "not profiled" if v is None else f"{v:.{digits}f} ms"


def _checked_ties(tokens: torch.Tensor, ref: torch.Tensor, bound: float,
                  what: str) -> list:
    """[step, row] of each greedy token (``tokens`` (steps, B)) that is
    not the argmax of the reference's logits ``ref`` (steps, B, V): each
    must be a tie, the reference's top two logits within ``bound`` of
    each other and the token one of them (as phase 3 checks a
    requantization tie)."""
    ties = []
    for st in range(tokens.shape[0]):
        for b, g in enumerate(tokens[st].tolist()):
            want = int(ref[st, b].argmax())
            if g == want:
                continue
            top = torch.topk(ref[st, b], 2)
            gap = float(top.values[0] - top.values[1])
            check(gap <= bound and g in top.indices.tolist(),
                  f"{what} step {st} row {b}: token {g} on the mesh, {want} "
                  f"in one process, top-two gap {gap:.4g} vs {bound:.4g}")
            ties.append([st, b, gap])
    return ties


def _route_tap(MO, forced=None):
    """(a patcher of ``MO._route``, the list it fills with each call's
    (top_e, router probs) on the host).  With ``forced`` (a list of
    another run's records) each call takes that run's experts, gated by
    its own probs renormalised over them (calls past those records route
    themselves): teacher-forced routing, as the decode steps are fed the
    teacher's tokens."""
    from unittest import mock

    seen, route = [], MO._route

    def tapped(probs, K):
        top_p, top_e = route(probs, K)
        seen.append((top_e.cpu(), probs.float().cpu()))
        if forced is not None and len(seen) <= len(forced):
            top_e = forced[len(seen) - 1][0].to(probs.device)
            top_p = torch.gather(probs, -1, top_e)
            top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
        return top_p, top_e

    return mock.patch.object(MO, "_route", tapped), seen


def _routing_ties(mesh_rec: list, one_rec: list, tol: float) -> tuple:
    """(tokens a MoE layer call routed otherwise than one process, the
    largest router-probability gap to it over 1 + max): the probs within
    ``tol`` of 1 + max, and each token routed otherwise at a tie, its
    one-process margin between the k-th and (k+1)-th expert no wider
    than twice its largest probability gap."""
    ties, worst = [], 0.0
    for i, ((e_m, p_m), (e_1, p_1)) in enumerate(zip(mesh_rec, one_rec)):
        err, scale, nan = rel_err(p_m, p_1)
        worst = max(worst, err / scale)
        check(not nan and err <= tol * scale,
              f"(phase 15 c) router call {i}: probs {err:.3e} from one "
              f"process's, vs {tol:g} * {scale:.4g}")
        other = (torch.sort(e_m, -1)[0] != torch.sort(e_1, -1)[0]).any(-1)
        K = e_1.shape[1]
        top = torch.sort(p_1, dim=-1, descending=True)[0]
        for t in torch.nonzero(other)[:, 0].tolist():
            margin = float(top[t, K - 1] - top[t, K])
            gap = float((p_m[t] - p_1[t]).abs().max())
            check(margin <= 2 * gap, f"(phase 15 c) router call {i} token "
                  f"{t}: routed otherwise with a margin {margin:.3e} over "
                  f"twice its probability gap {gap:.3e}")
            ties.append([i, t, margin])
    return ties, worst


def _tree_bytes(tree) -> int:
    from repro_torch.utils import leaf_paths
    return sum(a.numel() * a.element_size() for _, a in leaf_paths(tree))


def _tp_serve_one(dev: torch.device, out: Path) -> dict:
    """Phase 15 (f) in one process on the card: (a)'s model and draw, a
    prefill of ``MESH_TP_BATCH`` x ``MESH_TP_PROMPT`` seeded tokens and
    ``MESH_TP_NEW`` greedy decode steps; writes the prompt, the tokens the
    ranks are fed and the logits to ``out / "tp_feed.pt"``; returns its
    figures."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF

    cfg = _mesh_lm_cfg()
    params = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    rng = np.random.default_rng(15)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (MESH_TP_BATCH, MESH_TP_PROMPT)).astype(np.int32))
    ffns = TF.ffn_modules(params, cfg)
    pre = ST.make_prefill_step(cfg, ffns=ffns)
    dec = ST.make_decode_step(cfg, ffns=ffns)
    batch = {"tokens": prompt.to(dev)}
    sync = torch.cuda.synchronize
    torch.cuda.reset_peak_memory_stats(dev)
    tap, seen = _tap_logits(TF)
    with tap:
        # greedy: each step fed the token the one before it took
        tok, caches = pre(params, batch)
        fed = []
        for _ in range(MESH_TP_NEW):
            fed.append(tok)
            tok, caches = dec(params, {"token": tok, "caches": caches})
        logits = torch.stack([lg.cpu() for lg in seen])
    cache_bytes = _tree_bytes(caches)
    del caches
    rec, _ = _serve_run(pre, dec, params, batch, fed, sync, profile=True)
    torch.save({"prompt": prompt, "fed": [t.cpu() for t in fed],
                "logits": logits}, out / "tp_feed.pt")
    tokens = torch.cat(rec["tokens"], dim=1)
    check(torch.equal(tokens, logits.argmax(-1).T.to(torch.int32)),
          "(phase 15 f) one process: a second run's greedy tokens differ "
          "from the first's")
    return {"rec": rec, "cache_bytes": cache_bytes,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}



def _g_cfgs() -> dict:
    """Phase 15 (g)'s archs, full width, depth cut (``MESH_G_*``)."""
    from repro_torch.configs.registry import ARCHS as ZOO
    return {"rgemma": dataclasses.replace(ZOO["recurrentgemma-9b"],
                                          n_layers=3, loss_chunks=1),
            "whisper-kan": dataclasses.replace(
                ZOO["whisper-medium"], ffn_kind="kan", pattern_rate=0.5,
                n_layers=4, n_enc_layers=4),
            "xlstm": dataclasses.replace(ZOO["xlstm-125m"],
                                         dtype="float32"),
            "xlstm-bf16": ZOO["xlstm-125m"]}


def _widened(params, cfg) -> tuple:
    """(params, config) of the f32 witness: ``params``' floating leaves
    widened to f32 (exact), the config at f32."""
    from repro_torch.utils import tree_map
    return (tree_map(lambda a: a.float() if a.is_floating_point() else a,
                     params), dataclasses.replace(cfg, dtype="float32"))


def _dropped_partial(module, fn: str):
    """A patcher of ``module.fn`` that plants a fault (phase 15 (g)):
    model rank 1's partial is left out of every sum over ``model``
    (``collectives.combine``) the call makes, as a combine that skipped
    one rank would (every rank gets model rank 0's partial)."""
    from unittest import mock

    from repro_torch.launch import collectives as COLL

    real, combine = getattr(module, fn), COLL.combine

    def dropped(x, mesh, *a, **kw):
        if mesh.index_over("model") == 1:
            x = torch.zeros_like(x)
        return combine(x, mesh, *a, **kw)

    def faulty(*a, **kw):
        with mock.patch.object(COLL, "combine", dropped):
            return real(*a, **kw)

    return mock.patch.object(module, fn, faulty)


def _g_faults() -> dict:
    """Phase 15 (g)'s planted faults in whisper-kan's serve steps, by
    name: (module, function) whose sums over ``model`` drop model rank
    1's partial (``_dropped_partial``)."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as TF
    return {"cross-attention decode": (A, "cross_decode"),
            "encoder": (TF, "encode")}


def _g_inputs(cfg) -> tuple:
    """(a train batch, a prompt batch, the tokens the decode steps are
    fed), global and on the host, from seed 16 with numpy; whisper's
    frames 0.1 * N(0, 1) in the params' dtype."""
    rng = np.random.default_rng(16)

    def tok(shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, shape)
                               .astype(np.int32))

    train = {"tokens": tok((MESH_G_BATCH, MESH_G_SEQ + 1))}
    serve = {"tokens": tok((MESH_G_BATCH, MESH_G_PROMPT))}
    fed = [tok((MESH_G_BATCH, 1)) for _ in range(MESH_G_NEW)]
    if cfg.enc_dec:
        train["frames"] = serve["frames"] = torch.as_tensor(
            (0.1 * rng.standard_normal((MESH_G_BATCH, cfg.n_frontend_tokens,
                                        cfg.d_model))).astype(np.float32)
        ).to(cfg.param_dtype)
    return train, serve, fed


def _train_run(step, state, batch: dict, n: int, profile: bool) -> tuple:
    """``n`` steps of ``step`` from ``state`` on ``batch``, the last one
    profiled with ``profile``: (state, record of each step's loss, host
    ms, launches and collectives, and the profile's device ms)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import collectives as COLL

    rec: dict = {"loss": [], "host_ms": [], "launches": [], "sent": []}
    for s in range(n):
        torch.cuda.synchronize()
        # the cached blocks released between steps: four ranks of
        # recurrentgemma's step leave the card no room to fragment
        torch.cuda.empty_cache()
        _build.reset_launches()
        COLL.reset_sent()
        t0 = time.perf_counter()
        if profile and s == n - 1:
            box: dict = {}
            rec.update(_profile_ms(
                lambda: box.update(zip(("s", "m"), step(state, batch)))))
            state, m = box["s"], box["m"]
        else:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss"].append(float(m["loss"]))
        rec["launches"].append({k: v for k, v in _build.LAUNCHES.items()
                                if v})
        rec["sent"].append(dict(COLL.SENT))
    return state, rec


def _rec_tp_one(dev: torch.device, out: Path) -> dict:
    """Phase 15 (g) in one process on the card: each arch's
    ``MESH_G_STEPS`` train steps and its serve steps (``_serve_run``),
    profiled as ``MESH_G_PROFILED`` says, and for the archs of
    ``MESH_G_WITNESS`` the f32 witness (``_widened``: the serve steps,
    and the train steps where the mesh is held to its losses); writes
    the losses and the logits the ranks are held to to ``out /
    "g_ref.pt"``; returns its figures."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF

    def run(cfg, params, train, serve, fed, n, prof):
        rec_t: dict = {"loss": []}
        if n:
            opts = _mesh_opts()
            state = ST.init_train_state(cfg, opts, params=params)
            state, rec_t = _train_run(
                ST.make_train_step(cfg, opts), state,
                {k: v.to(dev) for k, v in train.items()}, n,
                "replicated" in prof)
            del state
            gc.collect()
            torch.cuda.empty_cache()
        ffns = TF.ffn_modules(params, cfg)
        enc = TF.encoder_ffn_modules(params, cfg) if cfg.enc_dec else None
        pre = ST.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc)
        dec = ST.make_decode_step(cfg, ffns=ffns)
        tap, seen = _tap_logits(TF)
        with tap:
            rec_s, caches = _serve_run(
                pre, dec, params, {k: v.to(dev) for k, v in serve.items()},
                [t.to(dev) for t in fed], torch.cuda.synchronize,
                profile="serve" in prof)
        rec_s.pop("tokens")
        logits = torch.stack([lg.cpu() for lg in seen[:1 + MESH_G_NEW]])
        return rec_t, rec_s, logits, _tree_bytes(caches)

    figs, ref = {}, {}
    for name, cfg in _g_cfgs().items():
        torch.cuda.reset_peak_memory_stats(dev)
        params = TF.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        train, serve, fed = _g_inputs(cfg)
        rec_t, rec_s, logits, state_bytes = run(
            cfg, params, train, serve, fed, MESH_G_STEPS[name][0],
            MESH_G_PROFILED[name])
        ref[name] = {"loss": rec_t["loss"], "logits": logits}
        figs[name] = {"train": rec_t, "serve": rec_s,
                      "state_bytes": state_bytes,
                      "peak_gib": torch.cuda.max_memory_allocated(dev)
                      / 2 ** 30}
        if name in MESH_G_WITNESS:
            p32, cfg32 = _widened(params, cfg)
            del params
            held = name == "xlstm-bf16"     # the mesh's losses held to it
            w_t, _, w_lg, _ = run(cfg32, p32, train, serve, fed,
                                  MESH_G_STEPS[name][0] if held else 0, ())
            ref[name]["witness"] = {"loss": w_t["loss"], "logits": w_lg}
            del p32
        else:
            del params
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(ref, out / "g_ref.pt")
    return figs


def _rec_tp_rank(mesh, dev: torch.device, out: Path, card: str,
                 lap) -> dict:
    """Phase 15 (g) on one rank of (a)'s 2x2 mesh: each arch's train
    steps (``MESH_G_STEPS`` replicated, one more with every mixed
    fused-KAN and bf16 spline-basis launch held to its plain version,
    then those with ``activation_mode="sp"``), then a prefill and
    ``MESH_G_NEW`` decode steps held to the plain versions, and again
    timed, bitwise the first (profiled as ``MESH_G_PROFILED`` says);
    whisper-kan's serve steps once more for each of ``_g_faults``, and
    its encoder kernels at the rank's shapes timed on rank 0.  Returns
    its record; rank 0 writes each arch's whole logits and greedy tokens
    (and the faulty runs' logits) to ``out / "g_logits.pt"``."""
    from unittest import mock

    from repro_torch.kernels.kan_fused import ops as KO
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.kernels.spline_basis.ref import spline_basis_plain
    from repro_torch.launch import collectives as COLL
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.utils import leaf_paths

    sync = torch.cuda.synchronize
    res: dict = {}
    logits: dict = {}
    served_v2, served_sb = KO.kan_fused_v2, KO.spline_basis
    for name, cfg in _g_cfgs().items():
        r: dict = {"start_gib": torch.cuda.memory_allocated(dev) / 2 ** 30,
                   "card_free_gib": torch.cuda.mem_get_info(dev)[0]
                   / 2 ** 30}
        torch.cuda.reset_peak_memory_stats(dev)

        def shards_of(what):
            """``what`` of the draw, which is dropped after it (four ranks
            cannot each hold a whole recurrentgemma beside a step)."""
            params = TF.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            out_ = what(params)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            return out_

        train, serve, fed = _g_inputs(cfg)
        tb = {k: v.to(dev) for k, v in ST.local_batch(train, mesh).items()}
        held = {"n": 0, "n_basis": 0, "worst": 0.0, "shapes": []}

        def held_v2(x, wt, spec, kb, slot_of=None, **kw):
            y = served_v2(x, wt, spec, kb, slot_of, **kw)
            with torch.no_grad():
                ref = kan_fused_v2_ref(x.detach(), wt.detach(), spec, kb,
                                       kw.get("out_dtype"))
            err, scale, nan = rel_err(y.detach(), ref)
            check(not nan and err <= BF16_ULP * scale,
                  f"(phase 15 g) {name}: a {MIXED} launch "
                  f"{tuple(x.shape)} -> {tuple(y.shape)} {y.dtype}: "
                  f"{err:.3e} from its plain version")
            held["n"] += 1
            held["worst"] = max(held["worst"], err / scale)
            shape = [list(x.shape), list(wt.shape), str(y.dtype)]
            if shape not in held["shapes"]:
                held["shapes"].append(shape)
            return y

        def held_sb(xc, spec, *a, **kw):
            got = served_sb(xc, spec, *a, **kw)
            want = spline_basis_plain(xc.reshape(-1), spec).reshape(
                got.shape)
            check(torch.equal(got.view(torch.int16), want.view(torch.int16))
                  if got.dtype == BF else torch.equal(got, want),
                  f"(phase 15 g) {name}: a spline-basis launch at n = "
                  f"{xc.numel()} is not bitwise its plain version")
            held["n_basis"] += 1
            return got

        prof = MESH_G_PROFILED[name]
        for mode, n in zip(("replicated", "sp"), MESH_G_STEPS[name]):
            if not n:
                r[mode] = {"loss": [], "launches": []}
                continue
            o = _mesh_opts(activation_mode=mode)
            step = ST.make_train_step(cfg, o, mesh)
            st = shards_of(lambda p: ST.init_train_state(cfg, o, params=p,
                                                         mesh=mesh))
            if mode == "replicated":
                COLL.reset_sent()
                step.gathered(st["params"])
                r["n_tp"] = len(step.tp)
                r["model_gathers"] = COLL.GATHERS.get(("model",), 0)
                r["model_gathers_want"] = sum(
                    "model" in sp.axes() and k not in step.local
                    for k, sp in step.pspecs.items())
            st, r[mode] = _train_run(step, st, tb, n, mode in prof)
            if mode == "replicated" and cfg.ffn_kind == "kan":
                # one more step (not counted), every launch held
                with mock.patch.object(KO, "kan_fused_v2", held_v2), \
                        mock.patch.object(KO, "spline_basis", held_sb):
                    step(st, tb)
                sync()
            del st, step
            gc.collect()
            torch.cuda.empty_cache()
        lap(f"g_{name}_train")
        cp = ST.compute_params(shards_of(
            lambda p: ST.shard_params(p, cfg, mesh)), cfg, mesh)
        with ST.serve_mesh(cfg, mesh):
            ffns = TF.ffn_modules(cp, cfg)
            enc = TF.encoder_ffn_modules(cp, cfg) if cfg.enc_dec else None
            vocab_tp = TF._vocab_shard(cfg) is not None
        mods = [f for f in ffns + (enc or []) if f is not None]
        batch = {k: v.to(dev) for k, v in serve.items()}
        layout = ST.cache_layout(cfg, mesh, batch)
        pre = ST.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc, mesh=mesh)
        dec = ST.make_decode_step(cfg, ffns=ffns, mesh=mesh, layout=layout)
        fed_l = [ST.local_batch({"token": t}, mesh)["token"].to(dev)
                 for t in fed]
        held_s = {"n": 0, "worst": 0.0, "shapes": []}
        tap, seen = _tap_logits(TF)
        with tap, _held_layers(mods, f"(phase 15 g) {name}", held_s):
            rec_h, caches = _serve_run(pre, dec, cp, batch, fed_l, sync)
        def whole(seen):
            return torch.stack([COLL.gather_cat(
                COLL.gather_cat(lg, mesh, "model", -1) if vocab_tp else lg,
                mesh, "data", 0).cpu() for lg in seen])

        got = {"logits": whole(seen),
               "tokens": [COLL.gather_cat(t.to(dev), mesh, "data", 0).cpu()
                          for t in rec_h["tokens"]]}
        r["state_bytes"] = _tree_bytes(caches)
        r["seq_sharded"] = sorted(k for k, sp in leaf_paths(layout)
                                  if "model" in sp.axes())
        # the state and every cache not split over model: the same bits
        # on every model rank
        gathered = [COLL.all_gather_shards(a.contiguous(), mesh, "model")
                    for (_, a), (_, sp) in zip(leaf_paths(caches),
                                               leaf_paths(layout))
                    if "model" not in sp.axes()]
        r["replicas_equal"] = all(torch.equal(parts[0], q)
                                  for parts in gathered for q in parts[1:])
        del gathered
        del caches
        if cfg.enc_dec:
            # the planted faults: their logits must leave the bound
            got["faults"] = {}
            for what, (mod, fn) in _g_faults().items():
                tap, seen = _tap_logits(TF)
                with tap, _dropped_partial(mod, fn):
                    _serve_run(pre, dec, cp, batch, fed_l, sync)
                got["faults"][what] = whole(seen)
        if mesh.rank == 0:
            logits[name] = got
        lap(f"g_{name}_serve_held")
        rec_s, _ = _serve_run(pre, dec, cp, batch, fed_l, sync,
                              profile="serve" in prof)
        r["serve_bitwise"] = all(torch.equal(a, b) for a, b in
                                 zip(rec_h["tokens"], rec_s.pop("tokens")))
        r.update(serve=rec_s, held_train=held, held_serve=held_s,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        lap(f"g_{name}_serve_timed")
        rows = []
        if mesh.rank == 0 and enc:
            # the encoder's KAN layers at the rank's train shapes: its
            # rows x 1500 frames, kan_up's 1024 -> 512 / m (bf16 out),
            # kan_down's 512 / m -> 1024 (f32 partials), each with the
            # spline basis its backward launches
            gen = torch.Generator(device=dev).manual_seed(72)
            M_ = MESH_G_BATCH // mesh.axis_size(SH.dp_axes(mesh)) \
                * cfg.n_frontend_tokens
            for what, layer, out_dt in (("up", enc[0].up, None),
                                        ("down", enc[0].down, F32)):
                x = torch.randn((M_, layer.cfg.n_in), generator=gen,
                                device=dev).to(BF)
                rows += kan_layer_rows(
                    x, layer.wt, layer.cfg.spec, layer.kb, "mixed", card,
                    f"whisper-kan encoder {what} (TP, M = {M_}, rank 0)",
                    cfg.n_enc_layers, cfg.n_enc_layers, out_dtype=out_dt)
                del x
        mesh.barrier()
        r["rows"] = rows
        res[name] = r
        del cp, ffns, enc, mods, pre, dec, rec_h, seen, got
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"g_{name}_kernels")
    if mesh.rank == 0:
        torch.save(logits, out / "g_logits.pt")
    return res



def _mesh_worker(argv: list) -> int:
    """One rank of phase 15 (``python chip_smoke.py --mesh-worker OUT
    CKPT CARD``, started by ``mesh_phase`` through
    ``launch.mesh.spawn_ranks``): (a), its tensor-parallel kernels, (f),
    (e), (b) and (g) on the 2x2 mesh, (d)'s 1x2 restore on ranks 0-1,
    then (c) on the 1x4 mesh, each on a process group of its own; writes
    ``OUT/dp_rank<r>.json`` and ``OUT/ep_rank<r>.json``, with the seconds
    each part took (``laps``)."""
    entry_wall = time.time()
    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from unittest import mock

    from repro_torch.core.kan import KANConfig, kan_init
    from repro_torch.kernels import _build
    from repro_torch.kernels.kan_fused import ops as KO
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.kernels.spline_basis.ops import spline_basis
    from repro_torch.kernels.spline_basis.ref import spline_basis_plain
    from repro_torch.launch import collectives as COLL
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.optim.compression import (
        compress_int8,
        compressed_allreduce,
    )
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.utils import leaf_paths, tree_map

    out, ck, card = Path(argv[0]), argv[1], argv[2]
    dev = torch.device(MESH_DEV)
    laps: dict = {}
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    rank = int(os.environ["RANK"])

    def join(shape: tuple, tag: str):
        m = M.init_process_mesh(shape, rank=rank,
                                world_size=math.prod(shape), device=dev,
                                rendezvous=str(out / f"rv_{tag}"))
        return m, {"rank": rank, "coords": m.coords, "backend": m.backend,
                   "device": str(dev), "entry_wall": entry_wall,
                   "laps": laps}

    # every rank's CUDA context at once (in (c) the ranks draw in turn)
    torch.empty(1, device=dev)
    sync = torch.cuda.synchronize
    mesh, res = join(MESH_DP, "dp")
    lap("init")

    def restore_on(m, ck: str) -> dict:
        """(d): a Trainer on mesh ``m`` restores the checkpoint; each
        rank holds its shards to the same cut of the saved leaves (the
        shards of every rank make each leaf whole), then one more
        step."""
        cfg = _mesh_lm_cfg()
        tr = Trainer(cfg, TrainerConfig(max_steps=MESH_STEPS + 1,
                                        ckpt_dir=ck, log_every=100),
                     dev, _mesh_data(cfg), _mesh_opts(), mesh=m)
        lap("d12_restore")
        target = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                          SP.state_specs(cfg))
        saved, saved_step, _ = restore_checkpoint(ck, target)
        specs = ST.train_state_shardings(cfg, m)
        keys = ("params", "opt", "step")
        want = {k: SH.shard_tree(saved[k], specs[k], m) for k in keys}
        r: dict = {"restored_step": saved_step,
                   "n_leaves": len(leaf_paths(saved)),
                   "bad_leaves": [
                       k for (k, a), (_, b) in zip(
                           leaf_paths({k: tr.state[k] for k in keys}),
                           leaf_paths(want))
                       if not torch.equal(a.cpu(), b)]}
        del saved, want
        lap("d12_check")
        b = tr.batch_at(tr.step)
        tr.state, m_ = tr._step_fn(tr.state, b)
        sync()
        r["step"], r["loss"] = int(tr.state["step"]), float(m_["loss"])
        lap("d12_step")
        return r

    def launched() -> dict:
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    def bits(state) -> list:
        return [a.detach().reshape(-1).view(torch.uint8).cpu()
                if a.dtype == torch.bfloat16 else a.detach().cpu()
                for _, a in leaf_paths(state)]

    cfg = _mesh_lm_cfg()
    data = _mesh_data(cfg)
    opts = _mesh_opts()
    params = TF.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = ST.make_train_step(cfg, opts, mesh)

    def batch(s):
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in data.batch_at(s).items()}
        return {k: v.to(dev) for k, v in ST.local_batch(b, mesh).items()}

    def run(o=opts, stp=step, n=MESH_STEPS, profile=False, state=None):
        if state is None:
            state = ST.init_train_state(cfg, o, params=params, mesh=mesh)
        rec = {"loss": [], "host_ms": [], "launches": [], "sent": [],
               "arg_bytes": []}
        for s in range(int(state["step"]), n):
            b = batch(s)
            rec["arg_bytes"].append(_tree_bytes([state, b]))
            sync()
            _build.reset_launches()
            COLL.reset_sent()
            t0 = time.perf_counter()
            if profile and s == n - 1:   # the last step, profiled
                box = {}
                rec.update(_profile_ms(
                    lambda: box.update(zip(("s", "m"), stp(state, b)))))
                state, m = box["s"], box["m"]
            else:
                state, m = stp(state, b)
            sync()
            rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["loss"].append(float(m["loss"]))
            rec["launches"].append(launched())
            rec["sent"].append(dict(COLL.SENT))
        return state, rec

    torch.cuda.reset_peak_memory_stats(dev)
    state_a, res["a"] = run(n=MESH_STEPS - 1)
    kept = bits(state_a)
    state_a, rec = run(state=state_a)
    for k in res["a"]:
        res["a"][k] += rec[k]
    lap("a_run1")
    # a second run, its last step profiled, bitwise the first's
    state_b, res["b"] = run(n=MESH_STEPS - 1, profile=True)
    res["a_bitwise_b"] = (res["a"]["loss"][:-1] == res["b"]["loss"]
                          and all(torch.equal(x, y) for x, y in
                                  zip(bits(state_b), kept)))
    del state_b, kept
    lap("a_run2_profiled")
    for k in ("device_ms", "memcpy_ms", "kernel_ms", "copy_share"):
        res[k] = res["b"][k]
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # one more tensor-parallel step (not counted): each mixed launch held
    # to its plain version on its input (kan_down's f32 partials too)
    served_v2, held = KO.kan_fused_v2, {"n": 0, "worst": 0.0, "shapes": []}

    def held_v2(x, wt, spec, kb, slot_of=None, **kw):
        y = served_v2(x, wt, spec, kb, slot_of, **kw)
        with torch.no_grad():
            ref = kan_fused_v2_ref(x.detach(), wt.detach(), spec, kb,
                                   kw.get("out_dtype"))
        err, scale, nan = rel_err(y.detach(), ref)
        check(not nan and err <= BF16_ULP * scale,
              f"(phase 15 a) a {MIXED} launch {tuple(x.shape)} -> "
              f"{tuple(y.shape)} {y.dtype}: {err:.3e} from its plain "
              f"version, vs {BF16_ULP:g} * {scale:.4g}")
        held["n"] += 1
        held["worst"] = max(held["worst"], err / scale)
        shape = [list(x.shape), list(wt.shape), str(y.dtype)]
        if shape not in held["shapes"]:
            held["shapes"].append(shape)
        return y

    with mock.patch.object(KO, "kan_fused_v2", held_v2):
        step(state_a, batch(MESH_STEPS))
    sync()
    res["held"] = held
    # the tensor-parallel shapes' kernels on this rank's rows: each held
    # to its plain version (the spline basis bitwise), then timed, one
    # rank at a time
    fcfg = cfg.ffn_cfg(0)
    m = mesh.axis_size("model")
    rows_m = LM_BATCH // mesh.axis_size(SH.dp_axes(mesh)) * LM_SEQ
    tp_rows, gen = [], torch.Generator(device=dev).manual_seed(70 + rank)
    for what, kc, out_dt in (("up", fcfg.kan_cfgs()[0], None),
                             ("down", fcfg.kan_cfgs()[1], F32)):
        kc = dataclasses.replace(
            kc, **({"n_out": kc.n_out // m} if what == "up"
                   else {"n_in": kc.n_in // m}))
        kp = kan_init(KANConfig(kc.n_in, kc.n_out, kc.spec), gen, BF)
        wt = KO.fuse_wt(kp["w_b"], KO.flatten_t(kp["t"], kc.kb),
                        len(kc.kb)).contiguous()
        x = torch.randn((rows_m, kc.n_in), generator=gen,
                        device=dev).to(BF)
        with torch.no_grad():
            err, scale, nan = rel_err(
                KO.kan_fused_v2(x, wt, kc.spec, kc.kb, out_dtype=out_dt),
                kan_fused_v2_ref(x, wt, kc.spec, kc.kb, out_dt))
            check(not nan and err <= BF16_ULP * scale,
                  f"(phase 15 a) {MIXED} {what} {tuple(x.shape)} -> "
                  f"{kc.n_out}: {err:.3e} from its plain version")
            xc = kc.spec.clip(x)
            got = spline_basis(xc, kc.spec)
            want = spline_basis_plain(xc.reshape(-1), kc.spec).reshape(
                got.shape)
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"(phase 15 a) spline_basis_bf16 at n = {xc.numel()}: "
                  f"not bitwise its plain version")
        for r in range(mesh.size):
            if r == rank:
                tp_rows += kan_layer_rows(
                    x, wt, kc.spec, kc.kb, "mixed", card,
                    f"{what} (tensor-parallel, rank {rank})", cfg.n_layers,
                    cfg.n_layers, out_dtype=out_dt)
            mesh.barrier()
        del x, wt, kp
    res["tp_rows"] = tp_rows
    lap("a_tp_kernels")
    # (d)'s checkpoint: whole leaves, written by rank 0
    whole = ST.gather_state(state_a, cfg, mesh, "cpu")
    if mesh.rank == 0:
        save_checkpoint(ck, MESH_STEPS, whole)
    del whole, state_a
    mesh.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    lap("a_checkpoint")
    # (f) tensor-parallel serve steps from (a)'s draw, teacher-forced on
    # one process's tokens: a run with every mixed launch held to its
    # plain version, then a run timed (its last prefill and decode step
    # profiled), bitwise the first
    feed = torch.load(out / "tp_feed.pt")
    torch.cuda.reset_peak_memory_stats(dev)
    COLL.reset_sent()
    cp = ST.compute_params(ST.shard_params(params, cfg, mesh), cfg, mesh)
    pspecs = ST.train_state_shardings(cfg, mesh)["params"]
    tp = ST._tp_paths(cfg, mesh, pspecs)
    res["f"] = {"n_tp": len(tp),
                "model_gathers": COLL.GATHERS.get(("model",), 0),
                "model_gathers_want": sum(
                    "model" in sp.axes() and k not in tp
                    for k, sp in leaf_paths(pspecs))}
    with ST.serve_mesh(cfg, mesh):
        ffns = TF.ffn_modules(cp, cfg)
    batch_f = {"tokens": feed["prompt"].to(dev)}
    layout = ST.cache_layout(cfg, mesh, batch_f)
    pre = ST.make_prefill_step(cfg, ffns=ffns, mesh=mesh)
    dec = ST.make_decode_step(cfg, ffns=ffns, mesh=mesh, layout=layout)
    fed = [ST.local_batch({"token": t.to(dev)}, mesh)["token"]
           for t in feed["fed"]]
    held_f = {"n": 0, "worst": 0.0, "shapes": []}
    tap, seen = _tap_logits(TF)
    with tap, _held_layers([f for f in ffns if f is not None],
                           "(phase 15 f)", held_f):
        rec_h, caches = _serve_run(pre, dec, cp, batch_f, fed, sync)
    whole = [COLL.gather_cat(COLL.gather_cat(lg, mesh, "model", -1), mesh,
                             "data", 0).cpu() for lg in seen]
    res["f"]["cache_bytes"] = _tree_bytes(caches)
    res["f"]["cache_shapes_ok"] = all(
        a.shape == e.shape for (_, a), (_, e) in zip(
            leaf_paths(caches),
            leaf_paths(TF.init_caches(cfg, MESH_TP_BATCH, MESH_TP_PROMPT
                                      + cfg.decode_margin, "meta", mesh))))
    res["f"]["seq_sharded"] = sum("model" in sp.axes()
                                  for _, sp in leaf_paths(layout))
    del caches
    lap("f_held")
    rec_f, _ = _serve_run(pre, dec, cp, batch_f, fed, sync, profile=True)
    res["f"]["bitwise"] = all(torch.equal(a, b) for a, b in
                              zip(rec_h["tokens"], rec_f.pop("tokens")))
    res["f"].update(rec=rec_f, held=held_f,
                    peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if rank == 0:
        torch.save({"logits": torch.stack(whole),
                    "tokens": [COLL.gather_cat(t.to(dev), mesh, "data",
                                               0).cpu()
                               for t in rec_h["tokens"]]},
                   out / "tp_logits.pt")
    else:
        for t in rec_h["tokens"]:
            COLL.gather_cat(t.to(dev), mesh, "data", 0)
    lap("f_timed")
    # the mixed kernel at the rank's serve shapes (kan_up 896 -> 304,
    # kan_down 304 -> 896 with f32 partials; a prefill's rows and a
    # decode step's), on layer 0's fused rows, timed on rank 0 alone
    f_rows = []
    if rank == 0:
        gen = torch.Generator(device=dev).manual_seed(71)
        rows_f = MESH_TP_BATCH // mesh.axis_size(SH.dp_axes(mesh))
        mod = ffns[0]
        for M_ in (rows_f * MESH_TP_PROMPT, rows_f):
            for what, layer, out_dt in (("up", mod.up, None),
                                        ("down", mod.down, F32)):
                x = torch.randn((M_, layer.cfg.n_in), generator=gen,
                                device=dev).to(BF)
                f_rows += kan_layer_rows(
                    x, layer.wt, layer.cfg.spec, layer.kb, "mixed", card,
                    f"{what} (TP serve, M = {M_}, rank 0)", cfg.n_layers,
                    out_dtype=out_dt)
                del x
    mesh.barrier()
    res["f"]["rows"] = f_rows
    del cp, ffns, pre, dec, fed, rec_h, whole, seen
    gc.collect()
    torch.cuda.empty_cache()
    lap("f_kernels")
    # (e) sequence parallelism: the same steps with activation_mode="sp",
    # the last one profiled
    o_sp = _mesh_opts(activation_mode="sp")
    torch.cuda.reset_peak_memory_stats(dev)
    _, res["e"] = run(o_sp, ST.make_train_step(cfg, o_sp, mesh),
                      profile=True)
    res["e"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    lap("e_sp")
    # (b) the int8 compressed all-reduce: the card's dequantized
    # gradients against the same codes reduced on the host
    oc = _mesh_opts(grad_compression=True)
    stc = ST.make_train_step(cfg, oc, mesh)
    st0 = ST.init_train_state(cfg, oc, params=params, mesh=mesh)
    # step 0 by hand: the gradients, their int8 all-reduce held to
    # the host's, then the update; step 1 through the step
    with ST.deterministic(dev):
        _, ce0, g = stc.rank_value_and_grad(st0["params"], batch(0))
    with torch.no_grad():
        deq, new_r = compressed_allreduce(g, st0["ef_residual"],
                                          axis_name=stc.dp, mesh=mesh)
        n = mesh.axis_size(stc.dp)
        bad = []
        res_leaves = dict(leaf_paths(st0["ef_residual"]))
        for (k, gk), (_, dk) in zip(leaf_paths(g), leaf_paths(deq)):
            q, sc = compress_int8(gk.to(torch.float32) + res_leaves[k])
            codes = COLL.all_gather_shards(q.cpu(), mesh, stc.dp)
            scales = COLL.all_gather_shards(sc.reshape(1).cpu(), mesh,
                                            stc.dp)
            acc = codes[0].to(torch.int32)
            for c in codes[1:]:
                acc = acc + c.to(torch.int32)
            smax = torch.max(torch.cat(scales))
            host = (acc.to(torch.float32) * smax
                    / torch.tensor(n, dtype=torch.float32)).to(gk.dtype)
            if not torch.equal(host, dk.cpu()):
                bad.append(k)
    res["comp_bad_leaves"] = bad
    res["comp_leaves"] = len(leaf_paths(g))
    with ST.deterministic(dev):
        upd, _ = stc.apply(st0, stc.zero1_slices(deq))
    st1 = {**upd, "ef_residual": new_r, "step": st0["step"] + 1}
    del g, deq, st0, upd, new_r, res_leaves
    st1, res["comp"] = run(oc, stc, MESH_COMP_STEPS, state=st1)
    res["comp"]["loss"].insert(0, float(stc._mean(ce0)))
    del st1, stc, params
    gc.collect()
    torch.cuda.empty_cache()
    lap("b")
    # (g) tensor parallelism in the recurrent blocks, the encoder and
    # cross-attention (whisper-kan, recurrentgemma, xlstm), once (a)'s
    # model is dropped: four ranks of recurrentgemma's train step take
    # most of the card
    res["g"] = _rec_tp_rank(mesh, dev, out, card, lap)
    # (d) the 1x2 restore on ranks 0 and 1 of this spawn, on a new
    # process group (ranks 2-3 go on to (c)'s rendezvous)
    M.destroy_process_mesh(mesh)
    if rank < math.prod(MESH_RESTORE_RANKS):
        sub, _ = join(MESH_RESTORE_RANKS, "restore")
        res["restore"] = restore_on(sub, ck)
        M.destroy_process_mesh(sub)
    gc.collect()
    torch.cuda.empty_cache()
    (out / f"dp_rank{rank}.json").write_text(json.dumps(res))
    laps = {}
    mesh, res = join(MESH_EP, "ep")
    lap("c_init")
    cfg = _mesh_ep_cfg()
    # each rank draws the whole model in turn and keeps its shards
    for r in range(mesh.size):
        if mesh.rank == r:
            whole = TF.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            shards = ST.shard_params(whole, cfg, mesh)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    lap("c_draw")
    torch.cuda.reset_peak_memory_stats(dev)
    cp = ST.compute_params(shards, cfg, mesh)
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    lap("c_compute_params")
    e = [a for k, a in leaf_paths(cp)
         if k.endswith("['experts']['gate']")]
    res["local_experts"] = int(e[0].shape[-3])
    feed = torch.load(out / "ep_tokens.pt")
    logits = []
    res["n_tp"] = len(ST._tp_paths(cfg, mesh, ST.train_state_shardings(
        cfg, mesh)["params"]))

    def whole_logits(lg):       # the rank's vocab columns, gathered
        return COLL.gather_cat(lg[:, -1].float(), mesh, "model", -1).cpu()

    layout = ST.cache_layout(cfg, mesh, {"tokens": feed["prompt"]})
    from repro_torch.models import moe as MO
    tap, routes = _route_tap(MO, feed["routes"])
    with torch.no_grad(), ST.serve_mesh(cfg, mesh, layout), tap:
        lg, caches = TF.prefill(cp, cfg, feed["prompt"].to(dev))
        logits.append(whole_logits(lg))
        times = []
        for i in range(MESH_EP_NEW):
            tok = feed["fed"][i].to(dev)
            sync()
            t0 = time.perf_counter()
            lg, caches = TF.decode_step(cp, cfg, tok, caches)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            logits.append(whole_logits(lg))
        res["decode_host_ms"] = statistics.median(times)
        lap("c_prefill_decode")
        prof = _profile_ms(lambda: TF.decode_step(
            cp, cfg, feed["fed"][0].to(dev), caches))
        res["decode_device_ms"] = prof["device_ms"]
        res["decode_kernel_ms"] = prof["kernel_ms"]
        res["copy_share"] = prof["copy_share"]
        lap("c_profile")
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if mesh.rank == 0:
        torch.save({"logits": torch.stack(logits),
                    "routes": routes[:len(feed["routes"])]},
                   out / "ep_logits.pt")
    (out / f"ep_rank{rank}.json").write_text(json.dumps(res))
    M.destroy_process_mesh(mesh)
    return 0


def _serve_row(who: str, rec: dict, peak: float, cache_bytes: int) -> dict:
    """A serve run's figures (``_serve_run``'s record) for phase 15's
    per-rank lines; a device time not profiled is None."""
    pre, dec = (rec.get(k, {}) for k in ("prefill_prof", "decode_prof"))
    return {"who": who, "prefill_host_ms": rec["host_ms"][0],
            "prefill_device_ms": pre.get("device_ms"),
            "prefill_kernel_ms": pre.get("kernel_ms"),
            "decode_host_ms": statistics.median(rec["host_ms"][1:]),
            "decode_host_ms_steps": rec["host_ms"][1:],
            "decode_device_ms": dec.get("device_ms"),
            "decode_kernel_ms": dec.get("kernel_ms"),
            "prefill_sent_bytes": rec["sent"][0]["bytes"],
            "prefill_collectives": rec["sent"][0]["calls"],
            "decode_sent_bytes": rec["sent"][-1]["bytes"],
            "decode_collectives": rec["sent"][-1]["calls"],
            "peak_gib": peak, "cache_bytes": cache_bytes}


def _rec_tp_checks(dp: list, one_g: dict, out: Path, card: str) -> tuple:
    """Phase 15 (g)'s checks and figures from the ranks' records ``dp``,
    one process's figures ``one_g`` and the logits files under ``out``
    (``_rec_tp_one``, ``_rec_tp_rank``): (kernel rows, summary by arch);
    raises on any fault."""
    ref_g, got_g = (torch.load(out / n) for n in ("g_ref.pt",
                                                 "g_logits.pt"))
    rows_g, g_summary = [], {}
    for name, cfg_g in _g_cfgs().items():
        kan = cfg_g.ffn_kind == "kan"
        layers = cfg_g.n_layers + (cfg_g.n_enc_layers if kan else 0)
        want_t = ({MIXED: 2 * layers, "spline_basis_bf16": 2 * layers}
                  if kan else {})
        want_p = {MIXED: 2 * layers} if kan else {}
        want_d = {MIXED: 2 * cfg_g.n_layers} if kan else {}
        lo = ref_g[name]["loss"]
        wit = ref_g[name].get("witness")
        # each step's loss bound: (a)'s, or where the mesh is held to the
        # witness, twice its loss gap if that is larger
        tol_l = [max(MESH_LOSS_TOL * (1 + abs(l1)),
                     2 * abs(l1 - wit["loss"][s_]) if wit and wit["loss"]
                     else 0.0) for s_, l1 in enumerate(lo)]
        for r in dp:
            g = r["g"][name]
            for mode in ("replicated", "sp"):
                for s_, (lm, l1) in enumerate(zip(g[mode]["loss"], lo)):
                    check(math.isfinite(lm) and abs(lm - l1) <= tol_l[s_],
                          f"(phase 15 g) {name} rank {r['rank']} {mode} step "
                          f"{s_}: loss {lm} on 2x2 against {l1} in one "
                          f"process (bound {tol_l[s_]:.4g})")
                for s_, got in enumerate(g[mode]["launches"]):
                    check(got == want_t, f"(phase 15 g) {name} rank "
                          f"{r['rank']} {mode} step {s_}: launches {got}, "
                          f"want {want_t}")
            check(g["n_tp"] > 0 and g["model_gathers"]
                  == g["model_gathers_want"] and g["serve_bitwise"]
                  and g["replicas_equal"],
                  f"(phase 15 g) {name} rank {r['rank']}: {g['n_tp']} TP "
                  f"leaves, {g['model_gathers']} gathers along model (want "
                  f"{g['model_gathers_want']}), serve runs bitwise "
                  f"{g['serve_bitwise']}, replicated state equal on the "
                  f"model ranks {g['replicas_equal']}")
            check(g["held_train"]["n"] == (2 * layers if kan else 0)
                  and g["held_train"]["n_basis"]
                  == (2 * layers if kan else 0)
                  and g["held_serve"]["n"] == (
                      2 * layers + MESH_G_NEW * 2 * cfg_g.n_layers
                      if kan else 0),
                  f"(phase 15 g) {name} rank {r['rank']}: held "
                  f"{g['held_train']} in a train step, {g['held_serve']} in "
                  f"the serve run")
            launched_s = g["serve"]["launches"]
            check(launched_s[0] == want_p
                  and all(x == want_d for x in launched_s[1:]),
                  f"(phase 15 g) {name} rank {r['rank']}: serve launches "
                  f"{launched_s}, want {want_p} then {want_d}")
            if name == "whisper-kan":
                check(any(k.endswith("['ck']") for k in g["seq_sharded"]),
                      f"(phase 15 g) whisper-kan rank {r['rank']}: ck/cv "
                      f"not sequence-sharded: {g['seq_sharded']}")
        lg, rf = got_g[name]["logits"], ref_g[name]["logits"]
        scale_g = 1 + float(rf.abs().max())
        # the f32 witness's largest logit gap to one process's bf16 run
        wit_err = (float((wit["logits"] - rf).abs().max()) if wit
                   else None)
        tol_g = MESH_G_TOL.get(name, 2 * (wit_err or 0.0) / scale_g)
        err_g = float((lg - rf).abs().max())
        print(f"phase 15 (g) {name}: logits {err_g:.4e} from one process's "
              f"({err_g / scale_g:.3e} of 1 + max, "
              f"{err_g / scale_g / BF16_ULP:.2f} bf16 ulps; bound {tol_g:g})"
              + ("" if wit is None else
                 f"; f32 witness {wit_err:.4e} from one process's bf16 "
                 f"({wit_err / scale_g / BF16_ULP:.2f} bf16 ulps), losses "
                 f"{wit['loss']}"))
        check(bool(torch.isfinite(lg).all()) and err_g <= tol_g * scale_g,
              f"(phase 15 g) {name}: logits {err_g:.3e} from one process's, "
              f"vs {tol_g:g} * {scale_g:.4g}")
        # the greedy tokens the serve steps returned: the argmax of the
        # mesh's own logits (argmax_over), and one process's but at a
        # checked tie -- not at bf16 xlstm, whose one-process top logits
        # can lie three within its rounding: its logits bound holds it
        toks_g = torch.stack([t[:, 0] for t in got_g[name]["tokens"]])
        check(torch.equal(toks_g, lg.argmax(-1).to(toks_g.dtype)),
              f"(phase 15 g) {name}: the serve steps' greedy tokens are not "
              f"the argmax of the mesh's logits")
        ties_g = ([] if name == "xlstm-bf16" else _checked_ties(
            toks_g, rf, tol_g * scale_g, f"(phase 15 g) {name}"))
        faults = {}
        for what, lg_f in got_g[name].get("faults", {}).items():
            e = float((lg_f - rf).abs().max())
            faults[what] = e / scale_g
            print(f"phase 15 (g) {name}: planted fault (model rank 1's "
                  f"partial dropped from the {what}'s sums over model) "
                  f"{e:.4e} from one process's logits ({e / scale_g:.3e} "
                  f"of 1 + max, {e / scale_g / BF16_ULP:.2f} bf16 ulps; "
                  f"bound {tol_g:g})")
            check(e > tol_g * scale_g,
                  f"(phase 15 g) {name}: the {what} fault's logits {e:.3e} "
                  f"lie within the bound {tol_g:g} * {scale_g:.4g}")
        one = one_g[name]
        per = [{"who": "one process", "train_host_ms": one["train"]["host_ms"],
                "train_kernel_ms": one["train"].get("kernel_ms"),
                "train_sent_bytes": 0, "train_collectives": 0,
                **_serve_row("one process", one["serve"], one["peak_gib"],
                            one["state_bytes"])}]
        for r in dp:
            g = r["g"][name]
            row = {"who": f"rank {r['rank']} {r['coords']}"}
            for mode, key in (("replicated", "train"), ("sp", "sp")):
                if g[mode]["loss"]:
                    row.update({
                        f"{key}_host_ms": g[mode]["host_ms"],
                        f"{key}_kernel_ms": g[mode].get("kernel_ms"),
                        f"{key}_sent_bytes": g[mode]["sent"][-1]["bytes"],
                        f"{key}_collectives": g[mode]["sent"][-1]["calls"]})
            per.append({**row, **_serve_row(
                row["who"], g["serve"], g["peak_gib"], g["state_bytes"])})
        for p_ in per:
            print(f"phase 15 (g) {name} {p_['who']}: train step host "
                  f"{[round(x, 1) for x in p_['train_host_ms']]} ms, "
                  f"kernels {_ms(p_['train_kernel_ms'], 1)}, sends "
                  f"{p_['train_sent_bytes'] / 2 ** 20:.1f} MiB in "
                  f"{p_['train_collectives']} collectives"
                  + (f"; sp host {p_['sp_host_ms'][0]:.1f} ms, kernels "
                     f"{_ms(p_['sp_kernel_ms'], 1)}, "
                     f"{p_['sp_sent_bytes'] / 2 ** 20:.1f} MiB in "
                     f"{p_['sp_collectives']}" if "sp_host_ms" in p_ else "")
                  + f"; prefill {MESH_G_BATCH} x {MESH_G_PROMPT} host "
                  f"{p_['prefill_host_ms']:.1f} ms, kernels "
                  f"{_ms(p_['prefill_kernel_ms'], 2)}, "
                  f"{p_['prefill_sent_bytes'] / 2 ** 20:.2f} MiB in "
                  f"{p_['prefill_collectives']}; a decode step host "
                  f"{p_['decode_host_ms']:.2f} ms, kernels "
                  f"{_ms(p_['decode_kernel_ms'], 3)}, "
                  f"{p_['decode_sent_bytes'] / 2 ** 20:.3f} MiB in "
                  f"{p_['decode_collectives']}; peak {p_['peak_gib']:.2f} "
                  f"GiB; state and caches "
                  f"{p_['cache_bytes'] / 2 ** 20:.2f} MiB; {card}")
        for row in dp[0]["g"][name]["rows"]:
            print(json.dumps(row))
        rows_g += dp[0]["g"][name]["rows"]
        g0 = dp[0]["g"][name]
        worst_t, worst_s = (max(r["g"][name][h]["worst"] for r in dp)
                            / BF16_ULP for h in ("held_train", "held_serve"))
        print(f"phase 15 (g) {name} on 2x2 vs one process: losses "
              f"{g0['replicated']['loss']} (sp {g0['sp']['loss']}) vs {lo}; "
              f"{1 + MESH_G_NEW} serve steps' logits {err_g / scale_g:.3e} "
              f"of 1 + max (bound {tol_g:g}), greedy tokens the argmax of "
              f"the mesh's logits and "
              + ("not held to one process's (bf16 xlstm); "
                 if name == "xlstm-bf16" else
                 f"one process's but at {len(ties_g)} checked ties "
                 f"{ties_g}; ")
              + f"{g0['held_train']['n']} + {g0['held_serve']['n']} held "
              f"{MIXED} launches within {worst_t:.2f} / {worst_s:.2f} "
              f"bf16 ulps, {g0['held_train']['n_basis']} spline bases "
              f"bitwise; {g0['n_tp']} TP leaves; "
              f"{len(g0['seq_sharded'])} cache leaves sequence-sharded")
        g_summary[name] = {"err_rel": err_g / scale_g, "tol": tol_g,
                           "witness_err_rel": None if wit is None
                           else wit_err / scale_g,
                           "witness_losses": None if wit is None
                           else wit["loss"], "loss_tol": tol_l,
                           "fault_err_rel": faults,
                           "ties": ties_g, "per_rank": per,
                           "losses_2x2": g0["replicated"]["loss"],
                           "losses_sp": g0["sp"]["loss"], "losses_1x1": lo}
    return rows_g, g_summary


def mesh_phase(dev: torch.device, card: str) -> dict:
    """Phase 15: training and serving on a ``launch/mesh.ProcessMesh``,
    the ranks processes of this script that share the card over gloo
    (the kernels built once, in phase 1, before any rank starts).

    (a) data parallelism with ZeRO-1 and tensor parallelism on a 2x2
    mesh: qwen2-0.5b with the
    KAN drop-in at full width and depth (bf16, f32 t), ``LM_BATCH`` x
    ``LM_SEQ`` tokens a step globally, ``MESH_STEPS`` steps from seed 0,
    against the same steps in one process: each step's loss within
    ``MESH_LOSS_TOL * (1 + |loss|)``; a second mesh run of ``MESH_STEPS``
    - 1 steps bitwise the first's; each rank
    launches ``kan_fused_v2_mixed`` and ``spline_basis_bf16`` 48 times a
    step and nothing else; per rank host ms a step, device ms (profiler),
    the bytes and collectives it sends a step and peak GiB; one more
    step with each mixed launch held to its plain version on its input;
    the mixed kernel and the bf16 spline basis at the rank's shapes
    against their plain versions, timed one rank at a time;
    (e) the same steps with ``activation_mode="sp"``: losses within
    ``MESH_LOSS_TOL * (1 + |loss|)`` of one process's and of (a)'s, the
    same launches and figures;
    (b) the same mesh for ``MESH_COMP_STEPS`` steps with
    ``grad_compression``: each rank's dequantized gradients bitwise those
    of the same codes reduced on the host, the first loss bitwise (a)'s;
    (c) expert parallelism on a 1x4 mesh: qwen3-moe-235b-a22b, 2 of 94
    layers, full width, bf16, 32 experts a rank, its attention and
    vocab tensor-parallel (the serve steps' context): a prefill of 8 x
    16 tokens and 8 decode steps fed the one-process run's greedy
    tokens and its routing (a token whose k-th and (k+1)-th router
    probabilities differ by less than the mesh's rounding moves them
    would take other experts: each layer call takes the one-process
    experts, gated by its own probs), every step's greedy tokens equal
    to it but at a checked tie (``_checked_ties``) and its logits within
    phase 11's ``MOE_TF_TOL``; the router probs within the same bound,
    and the ranks' own routing the one process's but at a routing tie
    (``_routing_ties``); per rank peak GiB and the copy kernels' share
    of a decode step's device time;
    (d) (a)'s checkpoint restored on 1x2 (ranks) and 1x1 (this process,
    ``Trainer(mesh=make_host_mesh())``): every leaf bitwise the saved one,
    and one more step on each;
    (f) the tensor-parallel serve steps on (a)'s mesh, model and draw: a
    prefill of ``MESH_TP_BATCH`` x ``MESH_TP_PROMPT`` tokens and
    ``MESH_TP_NEW`` decode steps teacher-forced on one process's tokens,
    greedy tokens equal but at a checked tie and logits within 2 bf16
    ulps a layer of one process's, every mixed launch held to its plain
    version, the timed run bitwise the held one; per rank and for one
    process the host and device ms of a prefill and a decode step, the
    bytes and collectives, peak GiB and KV cache bytes; the mixed kernel
    at the rank's serve shapes timed on rank 0.
    (g) tensor parallelism in the recurrent blocks, the encoder and
    cross-attention on (a)'s mesh (``_rec_tp_rank``; module docstring),
    against one process (``_rec_tp_one``).
    One spawn of four ranks runs (a), (f), (e), (b), (g), (d)'s 1x2 and
    (c), each but (f), (e), (b) and (g) on a process group of its own; the
    one-process references run first.
    Returns what it measured, with the seconds of each part; raises on
    any fault."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.utils import leaf_paths, tree_map

    t_phase = time.perf_counter()
    _build.build()       # every rank loads these; none runs nvcc
    out = Path(tempfile.mkdtemp(prefix="mesh_phase_"))
    ck = out / "ckpt"
    env = {"PYTHONPATH": str(SRC)}
    argv0 = [str(ROOT / "chip_smoke.py"), "--mesh-worker"]

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    print(f"phase 15: ranks share {MESH_DEV} over gloo (NCCL refuses two "
          f"ranks on one device); {card}")
    # (a) one process first
    t0 = time.perf_counter()
    free()
    cfg = _mesh_lm_cfg()
    data = _mesh_data(cfg)
    opts = _mesh_opts()
    params = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    state = ST.init_train_state(cfg, opts, params=params)
    step = ST.make_train_step(cfg, opts)
    one = []
    for s in range(MESH_STEPS):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in data.batch_at(s).items()}
        state, m = step(state, b)
        one.append(float(m["loss"]))
    del params, state, b
    free()
    times = {"a_one_process": time.perf_counter() - t0}
    # (c) one process first: the tokens the ranks are fed, the logits
    t0 = time.perf_counter()
    ecfg = _mesh_ep_cfg()
    params = TF.init_params(ecfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    rng = np.random.default_rng(15)
    prompt = torch.as_tensor(rng.integers(
        0, ecfg.vocab_size, (MESH_EP_BATCH, MESH_EP_PROMPT)).astype(np.int32))
    ref, fed = [], []
    from repro_torch.models import moe as MO
    tap, routes = _route_tap(MO)
    with torch.no_grad(), tap:
        lg, caches = TF.prefill(params, ecfg, prompt.to(dev))
        ref.append(lg[:, -1].float().cpu())
        for _ in range(MESH_EP_NEW):
            tok = TF.greedy_token(lg)
            fed.append(tok.cpu())
            lg, caches = TF.decode_step(params, ecfg, tok, caches)
            ref.append(lg[:, -1].float().cpu())
    del params, caches, lg
    free()
    torch.save({"prompt": prompt, "fed": fed, "routes": routes},
               out / "ep_tokens.pt")
    times["c_one_process"] = time.perf_counter() - t0
    # (f) one process first: the prompt, the tokens the ranks are fed,
    # the logits and its figures
    t0 = time.perf_counter()
    one_f = _tp_serve_one(dev, out)
    free()
    times["f_one_process"] = time.perf_counter() - t0
    # (g) one process first: the losses and logits the ranks are held to
    t0 = time.perf_counter()
    one_g = _rec_tp_one(dev, out)
    free()
    times["g_one_process"] = time.perf_counter() - t0
    # one spawn: (a), (b), (d)'s 1x2 restore, then (c)
    print(f"phase 15: this process holds "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB "
          f"({torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} reserved) on "
          f"the card beside the ranks; the card "
          f"{torch.cuda.mem_get_info(dev)[0] / 2 ** 30:.2f} GiB free")
    t0, w0 = time.perf_counter(), time.time()
    n = math.prod(MESH_DP)
    M.spawn_ranks(argv0 + [str(out), str(ck), card], n, str(out / "rv"),
                  timeout_s=MESH_SPAWN_S, env=env)
    times["spawn"] = t_spawn = time.perf_counter() - t0
    dp, ep = ([json.loads((out / f"{tag}_rank{r}.json").read_text())
               for r in range(n)] for tag in ("dp", "ep"))
    times["ranks_start"] = max(r["entry_wall"] for r in dp) - w0
    times.update({f"rank0_{k}": v for r in (dp[0], ep[0])
                  for k, v in r["laps"].items()})
    gaps, gaps_e = [], []
    want = {MIXED: 2 * cfg.n_layers, "spline_basis_bf16": 2 * cfg.n_layers}
    for r in dp:
        check(r["backend"] == "gloo", f"(phase 15 a) rank {r['rank']} on "
              f"backend {r['backend']}")
        for s, (lm, l1) in enumerate(zip(r["a"]["loss"], one)):
            gap = abs(lm - l1)
            gaps.append(gap)
            check(math.isfinite(lm) and gap <= MESH_LOSS_TOL * (1 + abs(l1)),
                  f"(phase 15 a) rank {r['rank']} step {s}: loss {lm} on "
                  f"2x2 against {l1} in one process")
        check(r["a_bitwise_b"], f"(phase 15 a) rank {r['rank']}: two 2x2 "
              f"runs differ")
        for s, got in enumerate(r["a"]["launches"]):
            check(got == want, f"(phase 15 a) rank {r['rank']} step {s}: "
                  f"launches {got}, want {want}")
        check(not r["comp_bad_leaves"] and r["comp_leaves"] > 0,
              f"(phase 15 b) rank {r['rank']}: dequantized gradients differ "
              f"from the host's reduction of the same codes at "
              f"{r['comp_bad_leaves'][:4]}")
        check(r["comp"]["loss"][0] == r["a"]["loss"][0]
              and all(math.isfinite(x) for x in r["comp"]["loss"]),
              f"(phase 15 b) rank {r['rank']}: losses {r['comp']['loss']}")
        check(r["held"]["n"] == 2 * cfg.n_layers,
              f"(phase 15 a) rank {r['rank']}: the held step ran "
              f"{r['held']['n']} {MIXED} calls")
        for s, (le, l1, la) in enumerate(zip(r["e"]["loss"], one,
                                             r["a"]["loss"])):
            for ref_l, what in ((l1, "one process"), (la, "(a)")):
                gap = abs(le - ref_l)
                gaps_e.append(gap)
                check(math.isfinite(le)
                      and gap <= MESH_LOSS_TOL * (1 + abs(ref_l)),
                      f"(phase 15 e) rank {r['rank']} step {s}: loss {le} "
                      f"under sp against {ref_l} of {what}")
        for s, got in enumerate(r["e"]["launches"]):
            check(got == want, f"(phase 15 e) rank {r['rank']} step {s}: "
                  f"launches {got}, want {want}")

    def rank_row(r: dict, run: dict) -> dict:
        return {"rank": r["rank"], "coords": r["coords"],
                "host_ms": statistics.median(run["host_ms"]),
                "host_ms_steps": run["host_ms"],
                "device_ms": run["device_ms"], "memcpy_ms": run["memcpy_ms"],
                "kernel_ms": run["kernel_ms"], "copy_share": run["copy_share"],
                "sent_bytes_a_step": run["sent"][-1]["bytes"],
                "collectives_a_step": run["sent"][-1]["calls"],
                "peak_gib": run["peak_gib"]}

    per_rank = [rank_row(r, {**r["b"], "host_ms": r["a"]["host_ms"],
                             "sent": r["a"]["sent"],
                             "peak_gib": r["peak_gib"]}) for r in dp]
    per_rank_e = [rank_row(r, r["e"]) for r in dp]
    for tag, rows in (("a", per_rank), ("e", per_rank_e)):
        for p in rows:
            print(f"phase 15 ({tag}) rank {p['rank']} {p['coords']}: host "
                  f"{p['host_ms']:.1f} ms a step (median of {MESH_STEPS}), "
                  f"device {p['device_ms']:.1f} ms (profiler: kernels "
                  f"{p['kernel_ms']:.1f}, host <-> device copies "
                  f"{p['memcpy_ms']:.1f}), sends "
                  f"{p['sent_bytes_a_step'] / 2 ** 20:.1f} MiB in "
                  f"{p['collectives_a_step']} collectives a step, peak "
                  f"{p['peak_gib']:.2f} GiB")
        check(sum(p["peak_gib"] for p in rows) <= MESH_GIB,
              f"(phase 15 {tag}) the ranks' peaks sum past {MESH_GIB} GiB")
    tp_rows = [row for r in dp for row in r["tp_rows"]]
    for row in tp_rows:             # the ranks' own prints stay in their files
        print(json.dumps(row))
    print(f"phase 15 (a) tensor-parallel shapes: each rank's "
          f"{2 * cfg.n_layers} {MIXED} calls of a step within "
          f"{max(r['held']['worst'] for r in dp) / BF16_ULP:.2f} bf16 ulps "
          f"of their plain versions, at {dp[0]['held']['shapes']}; "
          f"{len(tp_rows)} kernel rows timed")
    print(f"phase 15 (a) 2x2 vs one process, {MESH_STEPS} steps of "
          f"{LM_BATCH} x {LM_SEQ}: losses {dp[0]['a']['loss']} vs {one}, "
          f"largest gap {max(gaps):.3e} (bound {MESH_LOSS_TOL} * (1 + "
          f"|loss|)); two runs bitwise; {2 * cfg.n_layers} {MIXED} and "
          f"{2 * cfg.n_layers} spline_basis_bf16 launches a step a rank; "
          f"(b) int8 all-reduce bitwise the host's on "
          f"{dp[0]['comp_leaves']} leaves a rank, losses "
          f"{dp[0]['comp']['loss']}; (e) activation_mode=sp losses "
          f"{dp[0]['e']['loss']}, largest gap to one process's or (a)'s "
          f"{max(gaps_e):.3e}")
    # (f) tensor-parallel serve steps against one process
    got_f, feed_f = (torch.load(out / n) for n in ("tp_logits.pt",
                                                  "tp_feed.pt"))
    lf, rf = got_f["logits"], feed_f["logits"]         # (1 + new, B, V)
    tol_f = 2 * cfg.n_layers * BF16_ULP
    scale_f = 1 + float(rf.abs().max())
    err_f = float((lf - rf).abs().max())
    check(bool(torch.isfinite(lf).all()) and err_f <= tol_f * scale_f,
          f"(phase 15 f) logits {err_f:.3e} from one process's, vs "
          f"{tol_f:g} * {scale_f:.4g}")
    ties_f = _checked_ties(torch.stack([t[:, 0] for t in got_f["tokens"]]),
                           rf, tol_f * scale_f, "(phase 15 f)")
    want_f = {MIXED: 2 * cfg.n_layers}
    for r in dp:
        f = r["f"]
        check(f["bitwise"] and f["cache_shapes_ok"] and f["seq_sharded"] > 0
              and f["n_tp"] > 0
              and f["model_gathers"] == f["model_gathers_want"],
              f"(phase 15 f) rank {r['rank']}: bitwise {f['bitwise']}, cache "
              f"shapes {f['cache_shapes_ok']}, {f['seq_sharded']} "
              f"sequence-sharded caches, {f['n_tp']} TP leaves, "
              f"{f['model_gathers']} gathers along model (want "
              f"{f['model_gathers_want']})")
        check(f["held"]["n"] == (1 + MESH_TP_NEW) * 2 * cfg.n_layers,
              f"(phase 15 f) rank {r['rank']}: {f['held']['n']} held "
              f"{MIXED} launches")
        for st, got in enumerate(f["rec"]["launches"]):
            check(got == want_f, f"(phase 15 f) rank {r['rank']} step {st}: "
                  f"launches {got}, want {want_f}")

    rows_f = [_serve_row("one process", one_f["rec"], one_f["peak_gib"],
                         one_f["cache_bytes"])]
    rows_f += [_serve_row(f"rank {r['rank']} {r['coords']}", r["f"]["rec"],
                          r["f"]["peak_gib"], r["f"]["cache_bytes"])
               for r in dp]
    for p in rows_f:
        print(f"phase 15 (f) {p['who']}: prefill {MESH_TP_BATCH} x "
              f"{MESH_TP_PROMPT} host {p['prefill_host_ms']:.1f} ms, device "
              f"{p['prefill_device_ms']:.1f} ms (kernels "
              f"{p['prefill_kernel_ms']:.1f}), sends "
              f"{p['prefill_sent_bytes'] / 2 ** 20:.1f} MiB in "
              f"{p['prefill_collectives']} collectives; a decode step host "
              f"{p['decode_host_ms']:.2f} ms (median of {MESH_TP_NEW}), "
              f"device {p['decode_device_ms']:.3f} ms (kernels "
              f"{p['decode_kernel_ms']:.3f}), sends "
              f"{p['decode_sent_bytes'] / 2 ** 20:.3f} MiB in "
              f"{p['decode_collectives']} collectives; peak "
              f"{p['peak_gib']:.2f} GiB; KV caches "
              f"{p['cache_bytes'] / 2 ** 20:.1f} MiB; {card}")
    for row in dp[0]["f"]["rows"]:
        print(json.dumps(row))
    print(f"phase 15 (f) tensor-parallel serve steps on 2x2 vs one process: "
          f"{1 + MESH_TP_NEW} steps' logits {err_f / scale_f:.3e} of 1 + "
          f"max (bound {tol_f:g}), greedy tokens equal but at "
          f"{len(ties_f)} checked ties {ties_f}; each rank's "
          f"{dp[0]['f']['held']['n']} {MIXED} launches within "
          f"{max(r['f']['held']['worst'] for r in dp) / BF16_ULP:.2f} bf16 "
          f"ulps of their plain versions at {dp[0]['f']['held']['shapes']}; "
          f"{dp[0]['f']['seq_sharded']} cache leaves sequence-sharded")
    # (g) tensor parallelism in the recurrent blocks, the encoder and
    # cross-attention against one process
    rows_g, g_summary = _rec_tp_checks(dp, one_g, out, card)
    # (d) elastic restore: 1x2 on ranks 0-1 of (a)'s spawn, then 1x1 here
    tag12 = "x".join(map(str, MESH_RESTORE_RANKS))
    restores = {tag12: {**dp[0]["restore"], "bad_leaves": sorted({
        k for r in dp[:math.prod(MESH_RESTORE_RANKS)]
        for k in r["restore"]["bad_leaves"]})}}
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainerConfig(max_steps=MESH_STEPS + 1,
                                    ckpt_dir=str(ck), log_every=100),
                 dev, data, opts, mesh=M.make_host_mesh(dev))
    target = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                      SP.state_specs(cfg))
    saved, saved_step, _ = restore_checkpoint(str(ck), target)
    bad = [k for (k, a), (_, b_) in zip(leaf_paths(tr.state),
                                        leaf_paths(saved))
           if not torch.equal(a.cpu(), b_)]
    n_leaves = len(leaf_paths(saved))
    del saved
    tr.state, m = tr._step_fn(tr.state, tr.batch_at(tr.step))
    restores["1x1"] = {"restored_step": saved_step, "bad_leaves": bad,
                       "n_leaves": n_leaves, "step": int(tr.state["step"]),
                       "loss": float(m["loss"])}
    del tr
    free()
    times["d_1x1"] = time.perf_counter() - t0
    for tag, r0 in restores.items():
        check(r0["restored_step"] == MESH_STEPS and not r0["bad_leaves"]
              and r0["step"] == MESH_STEPS + 1
              and math.isfinite(r0["loss"]),
              f"(phase 15 d) restore on {tag}: {r0}")
    print(f"phase 15 (d) the 2x2 checkpoint restored on "
          + ", ".join(f"{t} ({r['n_leaves']} leaves bitwise, one more step "
                      f"loss {r['loss']:.4f})" for t, r in restores.items()))
    shutil.rmtree(ck, ignore_errors=True)
    got_c = torch.load(out / "ep_logits.pt")
    got = got_c["logits"]
    ref = torch.stack(ref)
    tol = MOE_TF_TOL[torch.bfloat16]
    ties_r, worst_r = _routing_ties(got_c["routes"], routes, tol)
    err = float((got - ref).abs().max())
    scale = 1 + float(ref.abs().max())
    check(err <= tol * scale, f"(phase 15 c) logits {err:.3e} from one "
          f"process's, vs {tol:g} * {scale:.4g}")
    ties_c = _checked_ties(got.argmax(-1), ref, tol * scale, "(phase 15 c)")
    for r in ep:
        check(r["n_tp"] > 0, f"(phase 15 c) rank {r['rank']}: no "
              f"tensor-parallel leaf")
        check(r["local_experts"] == ecfg.n_experts // MESH_EP[1],
              f"(phase 15 c) rank {r['rank']} holds {r['local_experts']} "
              f"experts")
        print(f"phase 15 (c) rank {r['rank']}: {r['local_experts']} experts, "
              f"peak {r['peak_gib']:.2f} GiB, a decode step "
              f"{r['decode_host_ms']:.2f} ms host, {r['decode_device_ms']:.3f} "
              f"ms device ({r['decode_kernel_ms']:.3f} in kernels, the copy "
              f"kernels {r['copy_share'] * 100:.1f}% of that)")
    print(f"phase 15 (c) {MESH_EP_ARCH} ({MESH_EP_DEPTH} layers) on 1x4: "
          f"prefill {MESH_EP_BATCH} x {MESH_EP_PROMPT} + {MESH_EP_NEW} decode "
          f"steps, routing teacher-forced (the ranks' own routing one "
          f"process's but at {len(ties_r)} checked ties {ties_r}, router "
          f"probs {worst_r:.3e} of 1 + max), greedy tokens equal to one "
          f"process's but at {len(ties_c)} checked ties {ties_c}, logits "
          f"{err / scale:.3e} of 1 + max (bound {tol:g}); one spawn of "
          f"{n} ranks for (a)-(d) {t_spawn:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"phase 15: {wall:.1f} s; parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    launches: dict = {}
    for got in dp[0]["a"]["launches"]:
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    for name in _g_cfgs():
        g = dp[0]["g"][name]
        for got in g["replicated"]["launches"] + g["sp"]["launches"]:
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
    launches_f: dict = {}
    for got in dp[0]["f"]["rec"]["launches"] + [
            x for name in _g_cfgs()
            for x in dp[0]["g"][name]["serve"]["launches"]]:
        for k, v in got.items():
            launches_f[k] = launches_f.get(k, 0) + v
    # what phase 16 (b) holds the dry run to: each rank's collectives and
    # argument bytes of every step of (a), (e) and (f), and its peaks
    dryrun_ref = [{
        "a": {"sent": r["a"]["sent"], "arg": r["a"]["arg_bytes"],
              "peak_gib": r["peak_gib"]},
        "e": {"sent": r["e"]["sent"], "arg": r["e"]["arg_bytes"],
              "peak_gib": r["e"]["peak_gib"]},
        "f_prefill": {"sent": r["f"]["rec"]["sent"][:1],
                      "arg": r["f"]["rec"]["arg_bytes"][:1],
                      "peak_gib": r["f"]["peak_gib"]},
        "f_decode": {"sent": r["f"]["rec"]["sent"][1:],
                     "arg": r["f"]["rec"]["arg_bytes"][1:],
                     "peak_gib": r["f"]["peak_gib"]}} for r in dp]
    return {"launches": launches, "launches_tp_serve": launches_f,
            "dryrun_ref": dryrun_ref,
            "tp_serve": {"err_rel": err_f / scale_f, "tol": tol_f,
                         "ties": ties_f, "per_rank": rows_f,
                         "kernel_rows": dp[0]["f"]["rows"],
                         "held_shapes": dp[0]["f"]["held"]["shapes"],
                         "held_worst": max(r["f"]["held"]["worst"]
                                           for r in dp)},
            "dp": {"losses_2x2": dp[0]["a"]["loss"], "losses_1x1": one,
                   "max_gap": max(gaps), "per_rank": per_rank,
                   "comp_losses": dp[0]["comp"]["loss"],
                   "held_shapes": dp[0]["held"]["shapes"],
                   "held_worst": max(r["held"]["worst"] for r in dp)},
            "sp": {"losses": dp[0]["e"]["loss"], "max_gap": max(gaps_e),
                   "per_rank": per_rank_e},
            "tp_kernel_rows": tp_rows,
            "rec_tp": {"archs": g_summary, "kernel_rows": rows_g},
            "restore": restores, "times_s": times,
            "ep": {"err_rel": err / scale, "ties": ties_c,
                   "routing_ties": ties_r, "router_err_rel": worst_r,
                   "per_rank": [
                {k: r[k] for k in ("rank", "peak_gib", "decode_host_ms",
                                   "decode_device_ms", "decode_kernel_ms",
                                   "copy_share")}
                for r in ep]},
            "wall_s": wall, "card": card}


def _dryrun_cells() -> dict:
    """Phase 16's cells: tag -> (shape, step options); "one" is (a),
    the others phase 15's (a), (e) and (f) steps on its 2x2 mesh."""
    from repro_torch.configs.base import ShapeSpec
    train = ShapeSpec("lm_train", LM_SEQ, LM_BATCH, "train")
    return {
        "one": (train, _mesh_opts()),
        "a": (train, _mesh_opts()),
        "e": (train, _mesh_opts(activation_mode="sp")),
        "f_prefill": (ShapeSpec("tp_prefill", MESH_TP_PROMPT, MESH_TP_BATCH,
                                "prefill"), _mesh_opts()),
        "f_decode": (ShapeSpec("tp_decode", MESH_TP_PROMPT, MESH_TP_BATCH,
                               "decode"), _mesh_opts())}


def _dryrun_worker(argv: list) -> int:
    """Phase 16's meta counts, in a process of their own (``python
    chip_smoke.py --dryrun-worker OUT WHO``): WHO "one" counts (a)'s step
    on the 1x1 mesh, WHO r rank r's cells of phase 15 on an abstract 2x2
    mesh; writes ``OUT/dryrun_<WHO>.json``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun as DR

    out, who = Path(argv[0]), argv[1]
    cfg = _mesh_lm_cfg()
    res = {}
    for tag, (shape, opts) in _dryrun_cells().items():
        if (tag == "one") != (who == "one"):
            continue
        t0 = time.perf_counter()
        rec = DR.analyze_cell(cfg, shape, opts=opts,
                              rank=0 if who == "one" else int(who),
                              mesh_shape=(1, 1) if who == "one" else MESH_DP)
        rec["wall_s"] = time.perf_counter() - t0
        res[tag] = rec
    (out / f"dryrun_{who}.json").write_text(json.dumps(res))
    return 0


def _dryrun_clis(done: dict) -> None:
    """Phase 16 (c): ``DRYRUN_CLIS`` from the repository's root (their
    records in ``chiprun_out/``): the xlstm cell beside the two qwen2
    ones (which write the same files, one after the other), then roofline
    and report over the records; each one's exit code, output and
    seconds into ``done``."""
    import threading

    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def run(argv: list) -> None:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        done[" ".join(argv[1:])] = {"rc": p.returncode, "out": p.stdout,
                                    "err": p.stderr[-3000:],
                                    "s": time.perf_counter() - t0}

    side = threading.Thread(target=run, args=(DRYRUN_CLIS[1],))
    side.start()
    run(DRYRUN_CLIS[0])
    run(DRYRUN_CLIS[2])
    side.join()
    for argv in DRYRUN_CLIS[3:]:
        run(argv)


def _op_diff(a: dict, b: dict, n: int = 12) -> list:
    """The ``n`` aten ops whose (calls, FLOPs, bytes) differ most between
    two ``by_op`` counts."""
    keys = set(a) | set(b)
    rows = [(k, a.get(k, [0, 0.0, 0.0]), b.get(k, [0, 0.0, 0.0]))
            for k in keys if a.get(k) != b.get(k)]
    rows.sort(key=lambda r: -abs(r[1][2] - r[2][2]) - abs(r[1][1] - r[2][1]))
    return rows[:n]


def dryrun_phase(dev: torch.device, card: str, mesh_rec: dict) -> dict:
    """Phase 16: the dry run (``launch/dryrun``: one rank's step counted
    on meta) held against the card.

    (a) phase 13's train step (qwen2-0.5b with the KAN drop-in at full
    width and depth, bf16 with f32 t, ``LM_BATCH`` x ``LM_SEQ`` tokens) in
    one process, the dry run's cell (``dryrun.cell_inputs``, the 1x1
    mesh), once on the card and once on meta, each under
    ``dryrun.count``: FLOPs, bytes, each kernel's counted launches and the
    argument bytes equal, the card's counted launches those of
    ``_build.LAUNCHES``; the meta argument + temp within
    ``DRYRUN_PEAK_TOL`` of ``torch.cuda.max_memory_allocated()`` over the
    step (the peak stats reset before it, less what the process held
    before the inputs were made); the card's memory the dry run's
    ``CARD_BYTES``;
    (b) phase 15's (a), (e) (``activation_mode="sp"``) and (f) (a prefill
    of ``MESH_TP_BATCH`` x ``MESH_TP_PROMPT`` tokens, a decode step
    after it) cells, ``dryrun.analyze_cell`` on an abstract 2x2 mesh for
    each rank: its collectives' calls and bytes (``SENT``) those the rank
    recorded on the card at every step of phase 15, its argument bytes
    those of the state and batch it stepped; each rank's predicted peak
    printed beside its measured one;
    (c) ``DRYRUN_CLIS``: the dry run of qwen2-0.5b decode_32k on both
    production meshes and of xlstm-125m long_500k, ``train --dry-run``,
    then ``roofline`` and ``report`` over their records: each exits 0 and
    prints its table.
    Returns what it measured; raises on any fault."""
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as TF

    import threading

    t_phase = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="dryrun_phase_"))
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    workers = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-worker",
         str(out), who], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for who in DRYRUN_WORKERS]
    clis: dict = {}
    cli_thread = threading.Thread(target=_dryrun_clis, args=(clis,))
    cli_thread.start()
    total = torch.cuda.get_device_properties(dev).total_memory
    check(total == DR.CARD_BYTES, f"(phase 16) the card's memory {total} "
          f"bytes, the dry run's CARD_BYTES {DR.CARD_BYTES}")

    # (a) the step on the card, counted
    cells = _dryrun_cells()
    shape, opts = cells["one"]
    cfg = _mesh_lm_cfg()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated(dev)
    params = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in _mesh_data(cfg).batch_at(0).items()}
    step, inputs = DR.cell_inputs(cfg, shape, M.make_host_mesh(dev), opts,
                                  params=params, batch=batch)
    del params, batch
    gc.collect()
    torch.cuda.synchronize()
    inputs_alloc = torch.cuda.memory_allocated(dev) - alloc0
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    card_full = DR.count_step(step, inputs)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - alloc0
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    del step, inputs
    gc.collect()
    torch.cuda.empty_cache()

    for w in workers:
        _, err = w.communicate(timeout=DRYRUN_WORKER_S)
        check(w.returncode == 0, f"(phase 16) a dry-run worker exited "
              f"{w.returncode}:\n{err[-3000:]}")
    meta = {who: json.loads((out / f"dryrun_{who}.json").read_text())
            for who in DRYRUN_WORKERS}
    shutil.rmtree(out, ignore_errors=True)
    mfull = meta["one"]["one"]["full"]
    card_launches = {k: v["launches"] for k, v in card_full["kernels"].items()}
    meta_launches = {k: v["launches"] for k, v in mfull["kernels"].items()}
    marg = mfull["memory"]["argument_size_in_bytes"]
    mtemp = mfull["memory"]["temp_size_in_bytes"]
    same = {k: (card_full[k], mfull[k]) for k in ("flops", "bytes_accessed")
            if card_full[k] != mfull[k]}
    if same or card_launches != meta_launches:
        print("phase 16: (a) the aten ops whose counts differ, (calls, "
              "FLOPs, bytes) on the card / on meta: " + "; ".join(
                  f"{k} {c} / {m}" for k, c, m in _op_diff(
                      card_full["by_op"], mfull["by_op"])))
    check(not same, f"(a) card / meta counts differ: {same}")
    check(card_launches == meta_launches == launched,
          f"(a) counted launches: card {card_launches}, meta "
          f"{meta_launches}; _build.LAUNCHES {launched}")
    check(card_full["memory"]["argument_size_in_bytes"] == marg,
          f"(a) argument bytes: card "
          f"{card_full['memory']['argument_size_in_bytes']}, meta {marg}")
    gap = (marg + mtemp) / peak - 1.0
    check(abs(gap) <= DRYRUN_PEAK_TOL,
          f"(a) meta argument + temp {(marg + mtemp) / 2 ** 30:.3f} GiB vs "
          f"the card's peak {peak / 2 ** 30:.3f} GiB: {gap * 100:+.2f}%, "
          f"bound {DRYRUN_PEAK_TOL * 100:.0f}%")
    one = {"flops": mfull["flops"], "bytes": mfull["bytes_accessed"],
           "launches": meta_launches, "argument_bytes": marg,
           "temp_bytes": mtemp,
           "card_temp_bytes": card_full["memory"]["temp_size_in_bytes"],
           "card_inputs_allocated": inputs_alloc, "card_peak_bytes": peak,
           "peak_gap": gap, "aten_ops": [card_full["aten_ops"],
                                         mfull["aten_ops"]],
           "card_s": card_s, "meta_s": meta["one"]["one"]["wall_s"],
           "card_bytes": total}
    print(f"phase 16: (a) {cfg.name} KAN drop-in train step, "
          f"{LM_BATCH} x {LM_SEQ}: card / meta FLOPs {mfull['flops']:.6e}, "
          f"bytes {mfull['bytes_accessed']:.6e} (equal), launches "
          f"{meta_launches} (equal, and _build's), argument "
          f"{marg / 2 ** 30:.4f} GiB (equal); meta argument + temp "
          f"{(marg + mtemp) / 2 ** 30:.4f} GiB vs the card's peak "
          f"{peak / 2 ** 30:.4f} GiB ({gap * 100:+.2f}%; the card's own "
          f"count's temp {card_full['memory']['temp_size_in_bytes'] / 2 ** 30:.4f}"
          f" GiB, inputs allocated {inputs_alloc / 2 ** 30:.4f} GiB); "
          f"{card_full['aten_ops']} / {mfull['aten_ops']} aten ops; counted "
          f"step {card_s:.1f} s on the card, {one['meta_s']:.1f} s on meta "
          f"(card memory {total} bytes; {card})")

    # (b) each rank's cells of phase 15 against what the rank recorded
    ranks = []
    for r, ref in enumerate(mesh_rec["dryrun_ref"]):
        got = meta[str(r)]
        row = {"rank": r}
        for tag in ("a", "e", "f_prefill", "f_decode"):
            f = got[tag]["full"]
            sent = f["sent"]
            arg = f["memory"]["argument_size_in_bytes"]
            check(all(s == sent for s in ref[tag]["sent"])
                  and ref[tag]["sent"],
                  f"(b) rank {r} {tag}: meta sends {sent}, the card "
                  f"{ref[tag]['sent']}")
            check(all(a == arg for a in ref[tag]["arg"]) and ref[tag]["arg"],
                  f"(b) rank {r} {tag}: meta argument {arg} bytes, the card "
                  f"{ref[tag]['arg']}")
            row[tag] = {"sent": sent, "argument_bytes": arg,
                        "predicted_gib": (arg + f["memory"][
                            "temp_size_in_bytes"]) / 2 ** 30,
                        "measured_gib": ref[tag]["peak_gib"],
                        "collectives": f["collectives"],
                        "meta_s": got[tag]["wall_s"]}
        ranks.append(row)
        print(f"phase 16: (b) rank {r}: " + "; ".join(
            f"{tag} {row[tag]['sent']['calls']} collectives, "
            f"{row[tag]['sent']['bytes']} bytes, argument "
            f"{row[tag]['argument_bytes']} bytes (= phase 15's), peak "
            f"predicted {row[tag]['predicted_gib']:.3f} GiB, measured "
            f"{row[tag]['measured_gib']:.3f} (the rank's whole run)"
            for tag in ("a", "e", "f_prefill", "f_decode")))

    # (c) the CLIs
    cli_thread.join(timeout=DRYRUN_WORKER_S)
    check(not cli_thread.is_alive() and len(clis) == len(DRYRUN_CLIS),
          f"(c) the CLIs ran {len(clis)} of {len(DRYRUN_CLIS)}")
    for cmd, r in clis.items():
        check(r["rc"] == 0, f"(c) {cmd} exited {r['rc']}:\n{r['err']}")
        print(f"phase 16: (c) {cmd}: exit 0 in {r['s']:.1f} s")
    outs = [clis[" ".join(argv[1:])] for argv in DRYRUN_CLIS]
    want = [("[OK ] qwen2-0.5b", "decode_32k   16x16", "decode_32k   2x16x16",
             "0 failures"),
            ("[OK ] xlstm-125m", "long_500k    16x16", "0 failures"),
            ("[OK ] qwen2-0.5b", "decode_32k   2x16x16", "0 failures"),
            ("| qwen2-0.5b", "| decode_32k", "| xlstm-125m", "| long_500k"),
            ("| qwen2-0.5b | decode_32k | 16x16 |",
             "| qwen2-0.5b | decode_32k | 2x16x16 |",
             "| xlstm-125m | long_500k | 16x16 |", "worst roofline")]
    for r, need in zip(outs, want):
        for w in need:
            check(w in r["out"], f"(c) {w!r} not in the output:\n"
                  f"{r['out'][-2000:]}")
    print("phase 16: (c) roofline's table:\n" + outs[3]["out"].strip())
    print("phase 16: (c) report's tables:\n" + outs[4]["out"].strip())
    wall = time.perf_counter() - t_phase
    print(f"phase 16: the dry run held against the card in {wall:.1f} s "
          f"({card})")
    return {"one": one, "ranks": ranks,
            "clis": {k: {"rc": v["rc"], "s": v["s"]} for k, v in clis.items()},
            "wall_s": wall, "card": card}


def _device_us(event) -> float:
    """Self device time (us) of a profiler row; the attribute's name moved
    between torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.benchmarks import (
        kernel_bench,
        loadgen_bench,
        serving_bench,
    )
    from repro_torch.benchmarks.kernel_ab import (
        graph_ms,
        layer_calls,
        plain_grads,
        q8_layer_calls,
        stack_calls,
        time_ms,
    )
    from repro_torch.configs.vikin_models import VIKIN_ARCHS
    from repro_torch.core.kan import KANLayer
    from repro_torch.core.quant import (
        QuantKANLayer,
        quantize_static,
        static_reciprocal,
    )
    from repro_torch.core.splines import (
        VALID_G,
        VALID_K,
        SplineSpec,
        locate_cell,
        spu_op_count,
    )
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels.kan_fused.ops import (
        flatten_t,
        fuse_wt,
        kan_fused_v1,
        kan_fused_v2,
        kan_fused_v2_q8,
        kernel_smem,
        kernel_threads,
        slot_table,
        split,
    )
    from repro_torch.kernels.kan_fused.ops import (
        resolve_blocks as kan_blocks,
    )
    from repro_torch.kernels.kan_fused.ref import (
        kan_fused_v1_ref,
        kan_fused_v2_q8_ref,
        kan_fused_v2_ref,
    )
    from repro_torch.kernels.pattern_matmul.ops import (
        bf16_grid,
        matmul_compact,
        matmul_q8,
        resolve_blocks,
    )
    from repro_torch.kernels.pattern_matmul.ref import (
        matmul_compact_ref,
        matmul_q8_ref,
    )
    from repro_torch.kernels.spline_basis.ops import (
        resolve_block_n,
        spline_basis,
    )
    from repro_torch.kernels.spline_basis.ref import spline_basis_plain
    from repro_torch.launch.serve import (
        make_engine,
        make_vikin_backend,
        print_report,
        submit_burst,
    )
    from repro_torch.runtime.backends import MultiWorkloadBackend
    from repro_torch.runtime.loadgen import (
        bursty_trace,
        poisson_trace,
        replay,
    )
    from repro_torch.runtime.server import Engine
    from repro_torch.checkpoint import (
        AsyncCheckpointer,
        restore_checkpoint,
        restore_masks,
    )
    from repro_torch.core.calibrate import stack_saliencies
    from repro_torch.core.sparsity import magnitude_mask
    from repro_torch.data.stack_task import task_for_model
    from repro_torch.models.ffn import vikin_stack_init
    from repro_torch.runtime.trainer import StackTrainer, StackTrainerConfig
    from repro_torch.utils import leaf_paths, tree_map
    from repro_torch.benchmarks import fig6_technique as F6
    from repro_torch.benchmarks import fig7_sparsity as F7
    from repro_torch.benchmarks import fig8_grid_scaling as F8
    from repro_torch.benchmarks import table1_models as T1
    from repro_torch.benchmarks import table2_overall as T2
    from repro_torch.configs.vikin_models import PAPER_MODELS
    from repro_torch.core.kan import KANConfig, kan_init
    from repro_torch.data.traffic import TrafficConfig, load_traffic
    from repro_torch.data.traffic import batches as traffic_batches
    from repro_torch.optim import AdamWConfig, adamw_init, constant_schedule

    # Plain versions run torch.matmul on the card: hold them to IEEE f32,
    # and the bf16 library call (addmm) to f32 accumulation.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(DEVICE)

    # ---------------------------------------------------------------- 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    usage = _build.resource_usage()
    for name, entries in usage.items():
        for e in entries:
            print(f"ptxas {name} {e['entry']}: {e.get('registers')} "
                  f"registers, {e.get('stack')} B stack, "
                  f"{e.get('spill_stores')} B spill stores, "
                  f"{e.get('spill_loads')} B spill loads")
    spills = [f"{name} {e['entry']}" for name in KERNEL_INFO
              for e in usage.get(name, [])
              if e.get("spill_stores") != 0 or e.get("spill_loads") != 0]
    check(all(usage.get(name) for name in KERNEL_INFO) and not spills,
          f"ptxas found no instance of a kernel, or instances spill: "
          f"{spills}")
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 2
    max_err = {name: 0.0 for name in KERNEL_INFO}
    n_checks = {name: 0 for name in KERNEL_INFO}

    def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
                what: str, exact: bool = False,
                tol: float = KERNEL_TOL) -> None:
        err, scale, nan = rel_err(got, ref)
        check(not nan, f"{name} {what}: NaN in kernel or plain output")
        check(got.shape == ref.shape,
              f"{name} {what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        if exact:
            check(torch.equal(got, ref), f"{name} {what}: kernel != plain "
                  f"(max abs err {err:.3e}), bitwise expected")
        check(err <= tol * scale,
              f"{name} {what}: max|kernel - plain| = {err:.3e} > "
              f"{tol:g} * {scale:.4g}")
        max_err[name] = max(max_err[name], err)
        n_checks[name] += 1

    def compare_calls(name: str, run, plain, what: str) -> torch.Tensor:
        """The kernel call ``run`` against the plain call ``plain``, both
        taking an output dtype (None: the input's).  An f32 output within
        ``KERNEL_TOL``; a bf16 one within one bf16 ulp, its f32 output
        within ``KERNEL_TOL`` and the bf16 output the f32 one rounded
        once.  Returns the kernel's output."""
        got = run(None)
        if got.dtype != BF:
            compare(name, got, plain(None), what)
            return got
        got32 = run(F32)
        check(got32.dtype == F32, f"{name} {what}: f32 out is {got32.dtype}")
        compare(name, got, plain(None), f"{what} bf16 out", tol=BF16_ULP)
        compare(name, got32, plain(F32), f"{what} f32 out")
        check(torch.equal(got, got32.to(BF)), f"{name} {what}: the bf16 "
              f"output is not the f32 output rounded once")
        return got

    def check_stack(stack, x: torch.Tensor, what: str) -> None:
        for i, layer in enumerate(stack.layers):
            name, _, kernel, plain = layer_calls(layer, x)
            compare_calls(name, kernel, plain, f"{what} layer {i}")
            x = plain()

    def rand(rng, batch: int, name: str, dtype=F32) -> torch.Tensor:
        """A seeded (batch, n_in) input of arch ``name`` on the card."""
        return torch.from_numpy(rng.random(
            (batch, VIKIN_ARCHS[name].sizes[0]), dtype=np.float32)).to(
                dev, dtype)

    backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE)
                for name in ARCHS}
    # the stacks the launcher serves at --precision bf16: the seed-0 f32
    # weights cast once
    bf_backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE,
                                            precision="bf16")
                   for name in ARCHS}
    by_dtype = {F32: backends, BF: bf_backends}
    rng = np.random.default_rng(0)
    x_big = rand(rng, BIG, "vikin-mixed")
    for dtype, bes in by_dtype.items():
        for name in ARCHS:
            for b in BUCKETS:
                check_stack(bes[name].stack, rand(rng, b, name, dtype),
                            f"{name} {dtype} B={b}")
        check_stack(bes["vikin-mixed"].stack, x_big.to(dtype),
                    f"vikin-mixed {dtype} B={BIG}")
    torch.cuda.synchronize()

    # ragged: kan 1000x304->96 and matmul 1000x152->304 relu
    gen = torch.Generator().manual_seed(1)
    spec = SplineSpec(4, 3)
    kb = (0, 2, 4, 5, 6)
    wt = (torch.randn((304 * (len(kb) + 1), 96), generator=gen) * 0.05).to(dev)
    x = (torch.randn((1000, 304), generator=gen) * 1.5).to(dev)
    slot = slot_table(kb, spec.n_bases, dev)
    compare("kan_fused_v2", kan_fused_v2(x, wt, spec, kb, slot),
            kan_fused_v2_ref(x, wt, spec, kb), "ragged 1000x304->96")
    xm = torch.randn((1000, 152), generator=gen).to(dev)
    wm = (torch.randn((152, 304), generator=gen) * 0.1).to(dev)
    bm = torch.randn((304,), generator=gen).to(dev)
    compare("pattern_matmul", matmul_compact(xm, wm, bm, "relu"),
            matmul_compact_ref(xm, wm, bm, "relu"), "ragged 1000x152->304")
    # the other epilogues on the ragged shape
    for act in (None, "gelu", "silu"):
        compare("pattern_matmul", matmul_compact(xm, wm, bm, act),
                matmul_compact_ref(xm, wm, bm, act),
                f"ragged 1000x152->304 act={act}")
    compare("pattern_matmul", matmul_compact(xm, wm, None, None),
            matmul_compact_ref(xm, wm, None, None), "ragged no bias")
    torch.cuda.synchronize()

    # int8: the stacks the launcher serves at --precision int8 (scales
    # calibrated on the CPU from the seed-0 batch), so the kernels see
    # the codes real quantization gives
    def q8_chain(stack, x: torch.Tensor, use: int, feed=None):
        """The int8 stack layer by layer through the kernels (``use=2``)
        or the plain versions (``use=3``): (output, each hidden layer's
        pre-quantization output, the codes each layer was given).  With
        ``feed``, layer i takes ``feed[i]`` instead of its own codes."""
        h = quantize_static(x, stack.x_scales[0])
        pre, codes = [], [h]
        for i, layer in enumerate(stack.layers):
            calls = q8_layer_calls(layer, h if feed is None else feed[i])
            y = calls[4](calls[use]())
            if i + 1 < len(stack.layers):
                pre.append(y)
                h = quantize_static(y, stack.x_scales[i + 1])
                codes.append(h)
        return y, pre, codes

    def check_stack_q8(stack, x: torch.Tensor, what: str) -> None:
        h = quantize_static(x, stack.x_scales[0])
        for i, layer in enumerate(stack.layers):
            name, _, kernel, plain, finish = q8_layer_calls(layer, h)
            ref = plain()
            compare(name, kernel(), ref, f"{what} int8 layer {i}",
                    exact=name == "pattern_matmul_q8")
            if i + 1 < len(stack.layers):
                h = quantize_static(finish(ref), stack.x_scales[i + 1])

    q8_backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE,
                                            precision="int8")
                   for name in ARCHS}
    for name in ARCHS:
        for b in BUCKETS:
            check_stack_q8(q8_backends[name].stack, rand(rng, b, name),
                           f"{name} B={b}")
    torch.cuda.synchronize()
    # ragged: kan q8 1000x304->96, matmul q8 1000x152->304 and 999x147->301
    xq = torch.randint(-127, 128, (1000, 304), generator=gen,
                       dtype=torch.int8).to(dev)
    wtq = torch.randint(-127, 128, (304 * (len(kb) + 1), 96), generator=gen,
                        dtype=torch.int8).to(dev)
    ssq = (torch.rand((len(kb) + 1,), generator=gen) * 2e-3 + 1e-4).to(dev)
    compare("kan_fused_v2_q8",
            kan_fused_v2_q8(xq, wtq, ssq, spec, kb, 0.01, slot),
            kan_fused_v2_q8_ref(xq, wtq, ssq, spec, kb, 0.01),
            "ragged 1000x304->96")
    for m, k, n in ((1000, 152, 304), (999, 147, 301)):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        compare("pattern_matmul_q8", matmul_q8(a, w), matmul_q8_ref(a, w),
                f"ragged {m}x{k}->{n}", exact=True)
    check_stack_q8(q8_backends["vikin-mixed"].stack, x_big,
                   f"vikin-mixed B={BIG}")
    torch.cuda.synchronize()

    # the kernel-tooling kernels, f32 and bf16: spline_basis bitwise at
    # every block_n candidate; kan_fused_v1 against its plain version (f32:
    # and the v2 kernel on the same weights), and itself one row at a time
    def kan_inputs(stack, x: torch.Tensor):
        """(layer, input) of each KAN layer of ``stack`` on ``x``, the
        stack run layer by layer through the plain versions."""
        out = []
        for layer in stack.layers:
            if isinstance(layer, KANLayer):
                out.append((layer, x))
            x = layer_calls(layer, x)[3]()
        return out

    def t_flat_of(layer) -> torch.Tensor:
        """The v1 kernel's basis weights of a (v2) KANLayer, unfused."""
        return flatten_t(layer.t, layer.cfg.kb).contiguous()

    def check_spline(x: torch.Tensor, spec, what: str,
                     misaligned: bool = False) -> None:
        name = "spline_basis" + SUFFIX[x.dtype]
        flat = x.reshape(-1)
        plain = spline_basis_plain(flat, spec)
        for cand in autotune.candidates_spline_basis(
                flat.numel(), spec.n_bases, flat.dtype):
            bn = cand["block_n"]
            compare(name, spline_basis(flat, spec, block_n=bn), plain,
                    f"{what} block_n={bn}", exact=True)
        if not misaligned:
            return
        # the kernel into an output each element offset past a 16-byte
        # boundary, up to 16 bytes, with a guard on each side (these
        # launches count in no phase's launches)
        n, nb, esz = flat.numel(), spec.n_bases, flat.element_size()
        for off in range(1, 16 // esz):
            buf = torch.full((n * nb + 32 // esz,), -7.0, device=dev,
                             dtype=flat.dtype)
            _build.launch(name, flat.data_ptr(), buf[off:].data_ptr(), n,
                          spec.grid_size, spec.order, float(spec.x0),
                          float(spec.inv_h), 256,
                          torch.cuda.current_stream().cuda_stream)
            compare(name, buf[off:off + n * nb].reshape(n, nb), plain,
                    f"{what} output +{esz * off} bytes", exact=True)
            check(bool((buf[:off] == -7.0).all()) and bool(
                (buf[off + n * nb:] == -7.0).all()),
                f"{name} {what}: a store outside the output")

    v1_v2 = {F32: {"err": 0.0, "n": 0}, BF: {"err": 0.0, "n": 0}}

    def check_v1(x, w_b, t_flat, wt, spec, kb, slot, what: str) -> None:
        """v1 against its plain version and against v2 on the same
        weights (f32 within KERNEL_TOL, bf16 within one ulp)."""
        got = compare_calls(
            "kan_fused_v1" + SUFFIX[x.dtype],
            lambda od=None: kan_fused_v1(x, w_b, t_flat, spec, kb, slot,
                                         out_dtype=od),
            lambda od=None: kan_fused_v1_ref(x, w_b, t_flat, spec, kb, od),
            what)
        tol = KERNEL_TOL if x.dtype == F32 else BF16_ULP
        err, scale, nan = rel_err(got, kan_fused_v2(x, wt, spec, kb, slot))
        check(not nan and err <= tol * scale,
              f"kan_fused_v1{SUFFIX[x.dtype]} {what}: max|v1 - v2| = "
              f"{err:.3e} > {tol:g} * {scale:.4g} (NaN: {nan})")
        v1_v2[x.dtype]["err"] = max(v1_v2[x.dtype]["err"], err)
        v1_v2[x.dtype]["n"] += 1

    rng_sb = np.random.default_rng(3)
    for dtype, bes in by_dtype.items():
        for g in VALID_G:
            for k in VALID_K:
                x = torch.from_numpy(rng_sb.uniform(-2.5, 2.5, 4096).astype(
                    np.float32)).to(dev, dtype)
                check_spline(x, SplineSpec(g, k), f"G{g}K{k} n=4096 in "
                             f"[-2.5, 2.5]", misaligned=True)
        for name in ("vikin-mixed", "vikin-kan2"):
            for b in BUCKETS + (BIG,):
                x = rand(rng, b, name, dtype)
                for layer, xin in kan_inputs(bes[name].stack, x):
                    check_spline(xin, layer.cfg.spec,
                                 f"{name} KAN input B={b}")
                    check_v1(xin, layer.w_b, t_flat_of(layer), layer.wt,
                             layer.cfg.spec, layer.kb, layer.slot_of,
                             f"{name} B={b}")
        for n in (1, 7, 1025, 1000 * 304):
            x = torch.from_numpy(rng_sb.uniform(-2.5, 2.5, n).astype(
                np.float32)).to(dev, dtype)
            check_spline(x, spec, f"ragged n={n} in [-2.5, 2.5]",
                         misaligned=True)
    # ragged 1000x304->96: the ragged v2 weights, unfused
    xr = (torch.randn((1000, 304), generator=gen) * 1.5).to(dev)
    w3 = wt.reshape(304, len(kb) + 1, 96)
    check_v1(xr, w3[:, 0].contiguous(),
             w3[:, 1:].reshape(304 * len(kb), 96).contiguous(), wt, spec,
             kb, slot, "ragged 1000x304->96")
    # batched == single, bitwise, at vikin-mixed's KAN layer
    layer, xin = kan_inputs(backends["vikin-mixed"].stack, x_big[:16])[0]
    t_flat = t_flat_of(layer)
    full = kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec, layer.kb,
                        layer.slot_of)
    for i in range(6):
        one = kan_fused_v1(xin[i:i + 1].contiguous(), layer.w_b, t_flat,
                           layer.cfg.spec, layer.kb, layer.slot_of)
        check(torch.equal(one, full[i:i + 1]),
              f"kan_fused_v1: row {i} alone != row {i} of a batch of 16")
    torch.cuda.synchronize()

    # every candidate tile of the three matmul kernels at vikin-mixed's
    # and vikin-mlp3's matmul layers: bitwise the default tile's output,
    # which is held to the plain version
    knob_checks = {}

    def check_knobs(name: str, xin, run, what: str) -> None:
        ref = run(None)
        M, kc = xin.shape
        n = ref.shape[1]
        for c in autotune.candidates_pattern_matmul(M, kc, n, xin.dtype):
            knob = (c["bm"], c["bk"], c["bn"])
            check(torch.equal(run(knob), ref), f"{name} {what}: tiles "
                  f"{knob} != the default tiles, bitwise")
            knob_checks[name] = knob_checks.get(name, 0) + 1

    for name in ("vikin-mixed", "vikin-mlp3"):
        for b in (8, BIG):
            x = rand(rng, b, name)
            for dtype, bes in by_dtype.items():
                h = x.to(dtype)
                for i, layer in enumerate(bes[name].stack.layers):
                    lname, xin, kernel, plain = layer_calls(layer, h)
                    if not isinstance(layer, KANLayer):
                        compare_calls(lname, kernel, plain, f"{name} B={b} "
                                      f"layer {i} default tiles")
                        check_knobs(lname, xin,
                                    lambda k, xin=xin, layer=layer:
                                    matmul_compact(xin, layer.w_c, layer.b,
                                                   layer.act, blocks=k),
                                    f"{name} B={b} layer {i}")
                    h = plain()
            stack = q8_backends[name].stack
            h = quantize_static(x, stack.x_scales[0])
            for i, layer in enumerate(stack.layers):
                lname, xin, kernel, plain, finish = q8_layer_calls(layer, h)
                ref = plain()
                if lname == "pattern_matmul_q8":
                    compare(lname, kernel(), ref,
                            f"{name} B={b} int8 layer {i} default tiles",
                            exact=True)
                    check_knobs(lname, xin, lambda k, xin=xin, layer=layer:
                                matmul_q8(xin, layer.w_q_c, blocks=k),
                                f"{name} B={b} int8 layer {i}")
                if i + 1 < len(stack.layers):
                    h = quantize_static(finish(ref), stack.x_scales[i + 1])
    torch.cuda.synchronize()
    print(f"phase 2: every candidate tile bitwise the default's at "
          f"vikin-mixed's and vikin-mlp3's matmul layers, B=8 and {BIG}: "
          f"{knob_checks}")

    # every candidate knob (bm, bi, bn) of both KAN kernels at the served
    # KAN layers (vikin-mixed's 304->32, vikin-kan2's 72->96) at bucket 8
    # and batch 8192: bitwise the default knob's output, which is held to
    # the plain version
    def check_kan_knobs(name: str, run, xin, layer, dtype, what: str,
                        version: int = 2):
        ref = run(None)
        B, n_in = xin.shape
        for c in autotune.candidates_kan_fused(B, n_in, layer.cfg.n_out,
                                               len(layer.kb), dtype,
                                               version):
            knob = (c["bm"], c["bi"], c["bn"])
            check(torch.equal(run(knob), ref), f"{name} {what}: knob "
                  f"{knob} != the default knob, bitwise")
            knob_checks[name] = knob_checks.get(name, 0) + 1

    for name in ("vikin-mixed", "vikin-kan2"):
        for b in (8, BIG):
            x = rand(rng, b, name)
            for dtype, bes in by_dtype.items():
                for layer, xin in kan_inputs(bes[name].stack, x.to(dtype)):
                    lname, _, kernel, plain = layer_calls(layer, xin)
                    compare_calls(lname, kernel, plain,
                                  f"{name} B={b} default knob")
                    check_kan_knobs(
                        lname, lambda k, xin=xin, layer=layer:
                        kan_fused_v2(xin, layer.wt, layer.cfg.spec, layer.kb,
                                     layer.slot_of, blocks=k),
                        xin, layer, dtype, f"{name} B={b}")
                    # v1 on the same weights, unfused: every candidate of
                    # its own grid bitwise its default knob, which holds
                    # to the plain version
                    t_flat = t_flat_of(layer)
                    compare_calls(
                        "kan_fused_v1" + SUFFIX[dtype],
                        lambda od=None, xin=xin, layer=layer, t_flat=t_flat:
                        kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec,
                                     layer.kb, layer.slot_of, out_dtype=od),
                        lambda od=None, xin=xin, layer=layer, t_flat=t_flat:
                        kan_fused_v1_ref(xin, layer.w_b, t_flat,
                                         layer.cfg.spec, layer.kb, od),
                        f"{name} B={b} default knob")
                    check_kan_knobs(
                        "kan_fused_v1" + SUFFIX[dtype],
                        lambda k, xin=xin, layer=layer, t_flat=t_flat:
                        kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec,
                                     layer.kb, layer.slot_of, blocks=k),
                        xin, layer, dtype, f"{name} B={b}", version=1)
            stack = q8_backends[name].stack
            h = quantize_static(x, stack.x_scales[0])
            for i, layer in enumerate(stack.layers):
                lname, xin, kernel, plain, finish = q8_layer_calls(layer, h)
                ref = plain()
                if lname == "kan_fused_v2_q8":
                    compare(lname, kernel(), ref,
                            f"{name} B={b} int8 layer {i} default knob")
                    check_kan_knobs(
                        lname, lambda k, xin=xin, layer=layer:
                        kan_fused_v2_q8(xin, layer.wt_q, layer.slot_scales,
                                        layer.cfg.spec, layer.kb,
                                        layer.x_scale, layer.slot_of,
                                        blocks=k),
                        xin, layer, torch.int8, f"{name} B={b} int8 layer {i}")
                if i + 1 < len(stack.layers):
                    h = quantize_static(finish(ref), stack.x_scales[i + 1])
    # ragged widths (n_in not a multiple of the 32-feature chunk, n_out
    # not one of bn), int8 slot scales that differ per slot
    for n_in, n_out in ((37, 13), (300, 33)):
        xr = (torch.randn((77, n_in), generator=gen) * 1.5).to(dev)
        wr = (torch.randn((n_in * (len(kb) + 1), n_out), generator=gen)
              * 0.05).to(dev)
        compare("kan_fused_v2", kan_fused_v2(xr, wr, spec, kb, slot),
                kan_fused_v2_ref(xr, wr, spec, kb),
                f"ragged 77x{n_in}->{n_out}")
        xqr = torch.randint(-127, 128, (77, n_in), generator=gen,
                            dtype=torch.int8).to(dev)
        wqr = torch.randint(-127, 128, tuple(wr.shape), generator=gen,
                            dtype=torch.int8).to(dev)
        compare("kan_fused_v2_q8",
                kan_fused_v2_q8(xqr, wqr, ssq, spec, kb, 0.02, slot),
                kan_fused_v2_q8_ref(xqr, wqr, ssq, spec, kb, 0.02),
                f"ragged 77x{n_in}->{n_out}")
        # v1 on the same weights, unfused, at every candidate of its grid
        w3 = wr.reshape(n_in, len(kb) + 1, n_out)
        w_br = w3[:, 0].contiguous()
        t_r = w3[:, 1:].reshape(n_in * len(kb), n_out).contiguous()
        v1_r = kan_fused_v1(xr, w_br, t_r, spec, kb, slot)
        compare("kan_fused_v1", v1_r, kan_fused_v1_ref(xr, w_br, t_r, spec,
                                                       kb),
                f"ragged 77x{n_in}->{n_out}")
        for c in autotune.candidates_kan_fused(77, n_in, n_out, len(kb),
                                               torch.float32, 1):
            knob = (c["bm"], c["bi"], c["bn"])
            check(torch.equal(kan_fused_v1(xr, w_br, t_r, spec, kb, slot,
                                           blocks=knob), v1_r),
                  f"kan_fused_v1 ragged 77x{n_in}->{n_out}: knob {knob} != "
                  f"the default knob, bitwise")
            knob_checks["kan_fused_v1"] = knob_checks.get(
                "kan_fused_v1", 0) + 1
    # batched == single, bitwise, with one knob for the batch of 16 and
    # another for each row alone, at vikin-mixed's KAN layer
    layer, xin = kan_inputs(backends["vikin-mixed"].stack, x_big[:16])[0]
    q_layer = q8_backends["vikin-mixed"].stack.layers[1]
    q_in = q8_chain(q8_backends["vikin-mixed"].stack, x_big[:16], 3)[2][1]
    full = kan_fused_v2(xin, layer.wt, layer.cfg.spec, layer.kb,
                        layer.slot_of, blocks=(16, 512, 32))
    q_full = kan_fused_v2_q8(q_in, q_layer.wt_q, q_layer.slot_scales,
                             q_layer.cfg.spec, q_layer.kb, q_layer.x_scale,
                             q_layer.slot_of, blocks=(16, 512, 32))
    t_flat = t_flat_of(layer)
    v1_full = kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec, layer.kb,
                           layer.slot_of, blocks=(16, 512, 32))
    for i in range(6):
        one = kan_fused_v1(xin[i:i + 1].contiguous(), layer.w_b, t_flat,
                           layer.cfg.spec, layer.kb, layer.slot_of,
                           blocks=(8, 64, 16))
        check(torch.equal(one, v1_full[i:i + 1]), f"kan_fused_v1: row {i} "
              f"alone at (8, 64, 16) != row {i} of 16 at (16, 512, 32)")
        one = kan_fused_v2(xin[i:i + 1].contiguous(), layer.wt,
                           layer.cfg.spec, layer.kb, layer.slot_of,
                           blocks=(8, 32, 8))
        check(torch.equal(one, full[i:i + 1]), f"kan_fused_v2: row {i} "
              f"alone at (8, 32, 8) != row {i} of 16 at (16, 512, 32)")
        one = kan_fused_v2_q8(q_in[i:i + 1].contiguous(), q_layer.wt_q,
                              q_layer.slot_scales, q_layer.cfg.spec,
                              q_layer.kb, q_layer.x_scale, q_layer.slot_of,
                              blocks=(8, 64, 16))
        check(torch.equal(one, q_full[i:i + 1]), f"kan_fused_v2_q8: row "
              f"{i} alone at (8, 64, 16) != row {i} of 16 at (16, 512, 32)")
    torch.cuda.synchronize()
    print(f"phase 2: every candidate knob of the three KAN kernels (v2 "
          f"f32, v2 int8, v1) bitwise the default's at vikin-mixed's and "
          f"vikin-kan2's KAN layers, B=8 and {BIG}, and (v1) at ragged "
          f"77x37->13 and 77x300->33; ragged widths within tolerance; "
          f"batched == single under different knobs in all three: "
          f"{knob_checks}")
    # ------------------------------------------------------------ 2 bf16
    # the bf16 kernels at ragged shapes, under every knob there, and
    # batched == single (the served bf16 layers are checked above)
    rng_bf = np.random.default_rng(5)
    gen_bf = torch.Generator().manual_seed(11)
    # ragged: odd n_in (x staged an element at a time) and odd n_out
    # (weight rows and outputs an element at a time), every knob of both
    # versions bitwise the default's
    for rb, n_in, n_out in ((77, 37, 13), (77, 301, 33), (1000, 304, 96)):
        xr = (torch.randn((rb, n_in), generator=gen_bf) * 1.5).to(dev, BF)
        wr = (torch.randn((n_in * (len(kb) + 1), n_out), generator=gen_bf)
              * 0.05).to(dev, BF)
        w3 = wr.reshape(n_in, len(kb) + 1, n_out)
        w_br = w3[:, 0].contiguous()
        t_r = w3[:, 1:].reshape(n_in * len(kb), n_out).contiguous()
        what = f"ragged {rb}x{n_in}->{n_out}"
        v2r = compare_calls(
            "kan_fused_v2_bf16",
            lambda od=None: kan_fused_v2(xr, wr, spec, kb, slot,
                                         out_dtype=od),
            lambda od=None: kan_fused_v2_ref(xr, wr, spec, kb, od), what)
        v1r = compare_calls(
            "kan_fused_v1_bf16",
            lambda od=None: kan_fused_v1(xr, w_br, t_r, spec, kb, slot,
                                         out_dtype=od),
            lambda od=None: kan_fused_v1_ref(xr, w_br, t_r, spec, kb, od),
            what)
        if rb == 1000:
            continue
        for version, ref in ((2, v2r), (1, v1r)):
            k = "kan_fused_v2_bf16" if version == 2 else "kan_fused_v1_bf16"
            for c in autotune.candidates_kan_fused(rb, n_in, n_out, len(kb),
                                                   BF, version):
                knob = (c["bm"], c["bi"], c["bn"])
                got = (kan_fused_v2(xr, wr, spec, kb, slot, blocks=knob)
                       if version == 2 else
                       kan_fused_v1(xr, w_br, t_r, spec, kb, slot,
                                    blocks=knob))
                check(torch.equal(got, ref), f"{k} {what}: knob {knob} != "
                      f"the default knob, bitwise")
                knob_checks[k] = knob_checks.get(k, 0) + 1
    # the tensor-core KAN body's edges: 21 fused rows a feature (G=16,
    # K=4, every basis kept) and the silu row alone (nbk = 0: a chunk is
    # two k16 steps), every knob bitwise the default's
    for (g_e, k_e), kb_e, (rb, n_in, n_out) in (
            ((16, 4), tuple(range(20)), (77, 37, 33)),
            ((4, 3), (), (33, 304, 32))):
        spec_e = SplineSpec(g_e, k_e)
        xr = (torch.randn((rb, n_in), generator=gen_bf) * 1.5).to(dev, BF)
        wr = (torch.randn((n_in * (len(kb_e) + 1), n_out), generator=gen_bf)
              * 0.05).to(dev, BF)
        what = f"ragged {rb}x{n_in}->{n_out} G{g_e}K{k_e} nbk={len(kb_e)}"
        ref = compare_calls(
            "kan_fused_v2_bf16",
            lambda od=None: kan_fused_v2(xr, wr, spec_e, kb_e, out_dtype=od),
            lambda od=None: kan_fused_v2_ref(xr, wr, spec_e, kb_e, od), what)
        for c in autotune.candidates_kan_fused(rb, n_in, n_out, len(kb_e),
                                               BF):
            knob = (c["bm"], c["bi"], c["bn"])
            check(torch.equal(kan_fused_v2(xr, wr, spec_e, kb_e,
                                           blocks=knob), ref),
                  f"kan_fused_v2_bf16 {what}: knob {knob} != the default "
                  f"knob, bitwise")
            knob_checks["kan_fused_v2_bf16"] = knob_checks.get(
                "kan_fused_v2_bf16", 0) + 1
    for m, kk, n in ((999, 147, 301), (1000, 152, 304)):
        xm_bf = torch.randn((m, kk), generator=gen_bf).to(dev, BF)
        wm_bf = (torch.randn((kk, n), generator=gen_bf) * 0.1).to(dev, BF)
        bm_bf = torch.randn((n,), generator=gen_bf).to(dev, BF)
        for act in (None, "relu", "gelu", "silu"):
            for bias in (bm_bf, None):
                compare_calls(
                    "pattern_matmul_bf16",
                    lambda od=None: matmul_compact(xm_bf, wm_bf, bias, act,
                                                   out_dtype=od),
                    lambda od=None: matmul_compact_ref(xm_bf, wm_bf, bias,
                                                       act, od),
                    f"ragged {m}x{kk}->{n} act={act} bias={bias is not None}")
    torch.cuda.synchronize()

    # batched == single, bitwise: each row alone, under another knob, is
    # its row in a batch of 2, 4, 8, 16 and 8192
    x_big_bf = x_big.to(BF)
    layer, xin = kan_inputs(bf_backends["vikin-mixed"].stack, x_big_bf)[0]
    t_flat = t_flat_of(layer)
    mm0 = bf_backends["vikin-mixed"].stack.layers[0]
    n_single = 0
    for b in BUCKETS + (BIG,):
        full2 = kan_fused_v2(xin[:b], layer.wt, layer.cfg.spec, layer.kb,
                             layer.slot_of, blocks=(16, 512, 32))
        full1 = kan_fused_v1(xin[:b], layer.w_b, t_flat, layer.cfg.spec,
                             layer.kb, layer.slot_of, blocks=(16, 512, 32))
        fullm = matmul_compact(x_big_bf[:b], mm0.w_c, mm0.b, mm0.act,
                               blocks=(128, 64, 64))
        for i in sorted({0, b // 2, b - 1}):
            xi = xin[i:i + 1].contiguous()
            check(torch.equal(kan_fused_v2(xi, layer.wt, layer.cfg.spec,
                                           layer.kb, layer.slot_of,
                                           blocks=(8, 32, 8)),
                              full2[i:i + 1]),
                  f"kan_fused_v2_bf16: row {i} alone != row {i} of {b}")
            check(torch.equal(kan_fused_v1(xi, layer.w_b, t_flat,
                                           layer.cfg.spec, layer.kb,
                                           layer.slot_of, blocks=(8, 64, 16)),
                              full1[i:i + 1]),
                  f"kan_fused_v1_bf16: row {i} alone != row {i} of {b}")
            check(torch.equal(matmul_compact(
                x_big_bf[i:i + 1].contiguous(), mm0.w_c, mm0.b, mm0.act,
                blocks=(16, 16, 8)), fullm[i:i + 1]),
                f"pattern_matmul_bf16: row {i} alone != row {i} of {b}")
            n_single += 3
    torch.cuda.synchronize()

    # the bf16 spline basis on every bf16 bit pattern but NaN and inf, at
    # every G x K and block_n, and into outputs 2..14 bytes past a 16-byte
    # boundary: bitwise its plain version, NaN for NaN (huge inputs
    # extrapolate to inf and NaN; the kernel's NaN is the card's
    # canonical one, torch's another payload)
    every_bf = torch.arange(1 << 16, dtype=torch.int32).to(
        torch.int16).view(BF)
    every_bf = every_bf[torch.isfinite(every_bf.float())].contiguous().to(
        dev)
    n_every = every_bf.numel()

    def bits_equal(got: torch.Tensor, ref: torch.Tensor) -> bool:
        gn, rn = torch.isnan(got.float()), torch.isnan(ref.float())
        return bool(torch.equal(gn, rn)) and bool(
            ((got.view(torch.int16) == ref.view(torch.int16)) | gn).all())

    n_every_checks = 0
    for g in VALID_G:
        for k in VALID_K:
            spec_a = SplineSpec(g, k)
            nb = spec_a.n_bases
            plain = spline_basis_plain(every_bf, spec_a)
            for bn in sorted({c["block_n"] for c in
                              autotune.candidates_spline_basis(
                                  n_every, nb, BF)} | {32, 64, 128}):
                check(bits_equal(spline_basis(every_bf, spec_a, block_n=bn),
                                 plain),
                      f"spline_basis_bf16 every bf16 input G{g}K{k} "
                      f"block_n={bn}: kernel != plain, bitwise")
                n_every_checks += 1
            for off in range(1, 8):
                buf = torch.full((n_every * nb + 16,), -7.0, device=dev,
                                 dtype=BF)
                _build.launch("spline_basis_bf16", every_bf.data_ptr(),
                              buf[off:].data_ptr(), n_every, g, k,
                              float(spec_a.x0), float(spec_a.inv_h), 256,
                              torch.cuda.current_stream().cuda_stream)
                check(bits_equal(buf[off:off + n_every * nb].reshape(
                    n_every, nb), plain) and bool((buf[:off] == -7.0).all())
                    and bool((buf[off + n_every * nb:] == -7.0).all()),
                    f"spline_basis_bf16 every bf16 input G{g}K{k} output "
                    f"+{2 * off} bytes: kernel != plain, or a stray store")
                n_every_checks += 1
    n_checks["spline_basis_bf16"] += n_every_checks
    del every_bf, plain, buf
    torch.cuda.synchronize()
    print(f"phase 2 bf16: spline_basis_bf16 bitwise its plain version on "
          f"all {n_every} finite bf16 inputs at every G x K, block_n and "
          f"output offset: {n_every_checks} launches")

    # the mixed kernel (a bf16 x against f32 fused rows: a bf16 model's,
    # its t f32 as the reference's kan_init draws it) at the KAN drop-in's
    # layers -- qwen2-0.5b's 896 -> 608 -> 896 and whisper-medium's
    # 1024 -> 512 -> 1024, kept bases 0, 2, 4, 5, 6 -- at M = 1024 under
    # every knob with batched == single, whisper's also at its encoder's
    # M = 8 x 1500; no bf16 kernel and no cast
    n_mixed = 0
    for arch_m, d_m, h_m in (("qwen2-0.5b", 896, 608),
                             ("whisper-medium", 1024, 512)):
        for n_in, n_out in ((d_m, h_m), (h_m, d_m)):
            p_m = kan_init(KANConfig(n_in, n_out, spec, basis_keep=kb),
                           torch.Generator(device=dev).manual_seed(n_in),
                           BF)
            wt_m = fuse_wt(p_m["w_b"], flatten_t(p_m["t"], kb), len(kb))
            check(p_m["w_b"].dtype == BF and wt_m.dtype == F32,
                  f"{MIXED}: a bf16 kan_init gives w_b {p_m['w_b'].dtype} "
                  f"and fused rows {wt_m.dtype}")
            for M in (1024, 8 * 1500) if d_m == 1024 else (1024,):
                xm = (torch.randn((M, n_in), generator=torch.Generator(
                    device=dev).manual_seed(M + n_in), device=dev)
                    * 1.5).to(BF)
                what = f"{arch_m} {M}x{n_in}->{n_out}"
                before = dict(_build.LAUNCHES)
                ref_m = compare_calls(
                    MIXED,
                    lambda od=None: kan_fused_v2(xm, wt_m, spec, kb, slot,
                                                 out_dtype=od),
                    lambda od=None: kan_fused_v2_ref(xm, wt_m, spec, kb, od),
                    what)
                got_l = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                         if v != before[k]}
                check(got_l == {MIXED: 2}, f"{MIXED} {what}: launches "
                      f"{got_l}, want 2 of {MIXED} alone")
                n_mixed += 1
                if M != 1024:
                    continue
                for c in autotune.candidates_kan_fused(M, n_in, n_out,
                                                       len(kb), BF, 2, F32):
                    knob = (c["bm"], c["bi"], c["bn"])
                    check(torch.equal(kan_fused_v2(xm, wt_m, spec, kb, slot,
                                                   blocks=knob), ref_m),
                          f"{MIXED} {what}: knob {knob} != the default "
                          f"knob, bitwise")
                    knob_checks[MIXED] = knob_checks.get(MIXED, 0) + 1
                for i in (0, M // 2, M - 1):
                    one = kan_fused_v2(xm[i:i + 1].contiguous(), wt_m, spec,
                                       kb, slot, blocks=(8, 128, 8))
                    check(torch.equal(one, ref_m[i:i + 1]),
                          f"{MIXED} {what}: row {i} alone != row {i} of {M}")
                    n_single += 1
            del p_m, wt_m, xm, ref_m
    torch.cuda.synchronize()
    print(f"phase 2 bf16: {MIXED} at qwen2-0.5b's and whisper-medium's KAN "
          f"drop-in layers, {n_mixed} shapes within tolerance of the plain "
          f"version, {knob_checks.get(MIXED, 0)} knobs bitwise the "
          f"default's, batched == single")
    print(f"phase 2 bf16: every candidate knob of the bf16 kernels bitwise "
          f"the default's at the served layers (B=8 and {BIG}) and, for "
          f"KAN, at ragged 77x37->13 and 77x301->33, G16K4 nbk=20 "
          f"77x37->33 and nbk=0 33x304->32: "
          f"{ {k: v for k, v in knob_checks.items() if k.endswith('bf16')} }"
          f"; batched == single, bitwise, at batches {BUCKETS + (BIG,)}: "
          f"{n_single} rows")

    for name in KERNEL_INFO:
        how = ("bitwise" if name in ("pattern_matmul_q8", "spline_basis",
                                     "spline_basis_bf16")
               else f"bf16 out within {BF16_ULP:g}*(1+max|plain|), f32 out "
               f"within {KERNEL_TOL:g}*(1+max|plain|)" if name in
               BF16_KERNELS + BF16_TOOLING_KERNELS + (MIXED,)
               else f"within {KERNEL_TOL:g}*(1+max|plain|)")
        print(f"phase 2: {name}: {n_checks[name]} shapes {how}, max abs "
              f"err {max_err[name]:.3e}")
    print(f"phase 2: kan_fused_v1 vs kan_fused_v2: {v1_v2[F32]['n']} "
          f"shapes within {KERNEL_TOL:g}*(1+max|v2|), max abs err "
          f"{v1_v2[F32]['err']:.3e}; bf16 v1 vs bf16 v2: {v1_v2[BF]['n']} "
          f"shapes within {BF16_ULP:g}*(1+max|v2|), max abs err "
          f"{v1_v2[BF]['err']:.3e}; v1 batched == single, bitwise, on 6 "
          f"rows")

    # ---------------------------------------------------------------- 3
    # a 48-request burst of the three archs through the launcher's engine
    # in each precision (bf16 and int8 through make_vikin_backend's
    # precision): the launches against the served batches, every answer
    # against the plain versions, vikin-mixed batched == single, and the
    # simulated fields against a CPU engine's on the same burst
    def hold_int8(stack, xs_np: np.ndarray, served_np: np.ndarray,
                  what: str) -> tuple:
        """Hold the int8 answers ``served_np`` to inputs ``xs_np``: bitwise
        the kernels run layer by layer on the same rows, and within
        ``SERVE_TOL`` of the plain versions on the card, where a
        requantized code may differ only by one step at a rounding tie;
        returns (max abs error, codes rounded across a tie)."""
        xs = torch.from_numpy(xs_np).to(dev)
        served = torch.from_numpy(served_np)
        y_k, _, codes_k = q8_chain(stack, xs, 2)
        check(torch.equal(served, y_k.cpu()),
              f"{what}: served answers != the kernels run layer by "
              f"layer on the same rows")
        y_p, pre_p, codes_p = q8_chain(stack, xs, 3)
        flips = 0
        for i in range(1, len(codes_k)):
            diff = codes_k[i] != codes_p[i]
            if not bool(diff.any()):
                continue
            step = (codes_k[i].int() - codes_p[i].int())[diff].abs()
            u = (pre_p[i - 1] * static_reciprocal(stack.x_scales[i]))[diff]
            tie = ((u.abs() % 1.0) - 0.5).abs()
            check(int(step.max()) == 1 and float(tie.max()) < 1e-3,
                  f"{what}: layer {i} codes differ from the plain "
                  f"stack's by up to {int(step.max())}, "
                  f"{float(tie.max()):.2e} code units from a rounding tie")
            flips += int(diff.sum())
        if flips:
            # compare like with like past the ties: the plain versions on
            # the kernels' codes
            y_p = q8_chain(stack, xs, 3, feed=codes_k)[0]
        err, scale, nan = rel_err(served, y_p.cpu())
        check(not nan and err <= SERVE_TOL * scale,
              f"{what}: max|served - plain| = {err:.3e} vs "
              f"{SERVE_TOL:g} * {scale:.4g} (NaN: {nan})")
        return err, flips

    def hold(precision: str, stack, xs: np.ndarray, served: np.ndarray,
             what: str) -> tuple:
        """Hold the answers ``served`` to inputs ``xs`` of a stack served
        at ``precision``: f32 within ``SERVE_TOL`` and bf16 (widened to
        f32) within ``SERVE_TOL_BF16`` of the stack run through the plain
        versions on the card; int8 as ``hold_int8``.  Returns (max abs
        error, int8 codes rounded across a tie)."""
        if precision == "int8":
            return hold_int8(stack, xs, served, what)
        dtype, tol = ((BF, SERVE_TOL_BF16) if precision == "bf16"
                      else (F32, SERVE_TOL))
        h = torch.from_numpy(xs).to(dev, dtype)
        for layer in stack.layers:
            h = layer_calls(layer, h)[3]()
        err, scale, nan = rel_err(torch.from_numpy(served), h.cpu())
        check(not nan and err <= tol * scale,
              f"{what}: max|served - plain| = {err:.3e} vs "
              f"{tol:g} * {scale:.4g} (NaN: {nan})")
        return err, 0

    models = [VIKIN_ARCHS[n] for n in ARCHS]
    mixed = VIKIN_ARCHS["vikin-mixed"]
    prompts = [rng.random(mixed.sizes[0], dtype=np.float32)
               for _ in range(6)]
    sim_fields = ("served", "ticks", "sim_cycles", "sim_latency_s",
                  "dma_bytes", "mode_switches", "reconfig_cycles")
    served = {}
    for precision in PRECISIONS:
        tol = {"bf16": SERVE_TOL_BF16}.get(precision, SERVE_TOL)
        eng = make_engine(models, slots=8, policy="mode-affinity",
                          device=DEVICE, precision=precision)
        rids = submit_burst(eng, models, 48)
        _build.reset_launches()
        t0 = time.perf_counter()
        out = eng.run_until_done()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        print_report(eng, out, rids)
        check(sorted(out) == sorted(rids),
              f"{precision}: served set != submitted set")
        kan_k, mm_k = SERVED_KERNELS[precision]
        want = {k: 0 for k in KERNEL_INFO}
        ws = eng.per_workload_stats()
        for name in ARCHS:
            kinds = VIKIN_ARCHS[name].layer_kinds
            batches = int(ws[name]["batches"])
            want[kan_k] += batches * kinds.count("kan")
            want[mm_k] += batches * kinds.count("mlp")
        print(f"phase 3 {precision}: launches {launches}, implied by the "
              f"served batches {want}")
        for k in KERNEL_INFO:
            check(launches[k] == want[k]
                  and (want[k] > 0 or k not in (kan_k, mm_k)),
                  f"{precision} {k}: {launches[k]} launches, served "
                  f"batches imply {want[k]}")
        for name in ARCHS:
            rs = [r for r in sorted(rids) if rids[r][0] == name]
            err, flips = hold(precision, eng.backend.backends[name].stack,
                              np.stack([rids[r][1] for r in rs]),
                              np.stack([out[r] for r in rs]),
                              f"{precision} served {name}")
            print(f"phase 3 {precision}: {name}: {len(rs)} answers within "
                  f"{tol:g}*(1+max|ref|) of the plain stack, max abs err "
                  f"{err:.3e}" + (f"; {flips} requantized codes rounded "
                                  f"across a tie" if precision == "int8"
                                  else ""))
        batched_eng = Engine(make_vikin_backend(mixed, DEVICE,
                                                precision=precision),
                             n_slots=4)
        brids = [batched_eng.submit(p) for p in prompts]
        batched = batched_eng.run_until_done()
        solo_eng = Engine(make_vikin_backend(mixed, DEVICE,
                                             precision=precision),
                          n_slots=4)
        for p, rid in zip(prompts, brids):
            srid = solo_eng.submit(p)
            solo = solo_eng.run_until_done()
            check(np.array_equal(batched[rid], solo[srid]),
                  f"{precision} vikin-mixed batched != single for request "
                  f"{rid}")
        c_eng = make_engine(models, slots=8, policy="mode-affinity",
                            device="cpu", precision=precision)
        submit_burst(c_eng, models, 48)
        c_eng.run_until_done()
        for f in sim_fields:
            check(eng.stats[f] == c_eng.stats[f],
                  f"{precision} served {f} {eng.stats[f]} != the CPU "
                  f"engine's {c_eng.stats[f]}")
        s = eng.stats
        print(f"phase 3 {precision}: vikin-mixed batched == single, "
              f"bitwise, on 6 requests (buckets 4/2 vs 2); served "
              f"sim_cycles {s['sim_cycles']:.1f}, dma_bytes "
              f"{s['dma_bytes']:.0f}, mode_switches "
              f"{s['mode_switches']:.0f}, reconfig_cycles "
              f"{s['reconfig_cycles']:.0f}, {', '.join(sim_fields)} equal "
              f"to the CPU engine's; wall {serve_s * 1e3:.2f} ms "
              f"({len(out) / serve_s:.1f} req/s)")
        served[precision] = {"eng": eng, "launches": launches,
                             "wall_s": serve_s,
                             "wall_rps": len(out) / serve_s}

    # ---------------------------------------------------------------- 4
    # Each served kernel at the vikin-mixed stack's shapes in each
    # precision, and the kernel-tooling kernels (the spline basis of its KAN
    # layer's input, flattened; v1 beside v2 on that layer's weights).
    # Bound: the bytes over HBM_BYTES_PER_S against the operations, each at
    # the card's peak rate for its type: multiply-adds of f32 operands (and
    # of int8 codes dequantized to f32, the int8 KAN kernel) at the f32
    # CUDA-core rate, of bf16 operands at the bf16 rate, of int8 operands at
    # the int8 rate; the SPU work (de Boor, silu, location) and epilogues at
    # the f32 rate.  Library: addmm in f32 or bf16 (f32 accumulation),
    # torch._int_mm where its shape rules allow; no single PyTorch call
    # computes a KAN layer or a spline basis.
    records = {}
    n_kan, n_mlp = (mixed.layer_kinds.count(kind) for kind in ("kan", "mlp"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def new_acc() -> dict:
        return {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "library_graph_ms": 0.0, "bytes": 0.0,
                "work": [], "shapes": [], "blocks": [], "design": []}

    def time_into(a: dict, kernel, plain, library=None) -> None:
        a["ms"] += time_ms(kernel)
        a["graph_ms"] += graph_ms(kernel)
        a["plain_ms"] += time_ms(plain, iters=20)
        if library is None or a["library_ms"] is None:
            a["library_ms"] = a["library_graph_ms"] = None
        else:
            a["library_ms"] += time_ms(library)
            a["library_graph_ms"] += graph_ms(library)

    def kan_work(layer, x_real: torch.Tensor, mac_rate: float,
                 spu_extra: int) -> list:
        """(operations, rate) of a KAN layer on the real-valued input
        ``x_real``: the multiply-adds this input needs (the silu term,
        plus one per local basis value whose basis the mask keeps) at
        ``mac_rate``, and the SPU work per (row, feature) at the f32
        rate."""
        spec, n_in, n_out = layer.cfg.spec, layer.cfg.n_in, layer.cfg.n_out
        batch = x_real.shape[0]
        cell, _ = locate_cell(spec.clip(x_real), spec)
        slots = layer.slot_of.long()
        hits = sum(int((slots[(cell + j).long()] >= 0).sum())
                   for j in range(spec.n_active))
        return [(2.0 * n_out * (batch * n_in + hits), mac_rate),
                (batch * n_in * (spu_op_count(spec) + spu_extra),
                 F32_FLOPS_PER_S)]

    def kan_bytes(layer, x: torch.Tensor, esz: float) -> float:
        """Bytes a KAN layer must move: x, the fused weights and the
        output once each at ``esz`` bytes, and the int32 slot table."""
        return (esz * (x.numel() + layer.wt.numel()
                       + x.shape[0] * layer.cfg.n_out)
                + 4.0 * layer.slot_of.numel())

    def bound(n_bytes: float, work: list) -> dict:
        """The least time for ``n_bytes`` and the (operations, rate) list
        ``work``, and which of the two sets it."""
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = sum(n / rate for n, rate in work) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def record(k: str, precision: str, batch: int, a: dict,
               per_batch=None) -> dict:
        rec = {
            "kernel": k, "model": "vikin-mixed", "precision": precision,
            "batch": batch, "shapes": a["shapes"], "ms": a["ms"],
            "graph_ms": a["graph_ms"], "plain_ms": a["plain_ms"],
            "library_ms": a["library_ms"],
            "library_graph_ms": a["library_graph_ms"],
            **bound(a["bytes"], a["work"]),
            "bytes": a["bytes"], "ops": sum(n for n, _ in a["work"]),
            "card": card,
        }
        if per_batch is not None:
            rec["launches_per_batch"] = per_batch
        if a["blocks"]:
            rec["blocks"] = a["blocks"]
        if a["design"]:
            rec["design"] = a["design"]
        records[(k, batch)] = rec
        print(json.dumps(rec))
        return rec

    for precision, bes in (("f32", backends), ("bf16", bf_backends)):
        dtype = BF if precision == "bf16" else F32
        esz = 2.0 if precision == "bf16" else 4.0
        mac_rate = BF16_FLOPS_PER_S if precision == "bf16" else F32_FLOPS_PER_S
        stack = bes["vikin-mixed"].stack
        kan_k, mm_k = SERVED_KERNELS[precision]
        for batch in (8, BIG):
            x = rand(np.random.default_rng(2), batch, "vikin-mixed", dtype)
            acc = {kan_k: new_acc(), mm_k: new_acc()}
            for layer in stack.layers:
                name, xin, kernel, plain = layer_calls(layer, x)
                a = acc[name]
                if isinstance(layer, KANLayer):
                    n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
                    time_into(a, kernel, plain)
                    a["work"] += kan_work(layer, xin, mac_rate, 4)
                    a["bytes"] += kan_bytes(layer, xin, esz)
                    a["shapes"].append(f"{batch}x{n_in}->{n_out} "
                                       f"kb={list(layer.kb)} {precision}")
                    knob = kan_blocks(batch, n_in, n_out, len(layer.kb),
                                      dtype, device=dev)
                    a["blocks"].append(knob)
                    if precision == "bf16":
                        # the tensor-core body's shared memory a block, and
                        # the multiply-adds its dense A tile issues (padded
                        # rows and columns too) beside the useful ones
                        nbk1 = len(layer.kb) + 1
                        outs = (-(-batch // knob["bm"]) * max(16, knob["bm"])
                                * -(-n_out // knob["bn"]) * knob["bn"])
                        a["design"].append({
                            "smem_bytes": kernel_smem(
                                knob["bm"], knob["bi"], knob["bn"], n_in,
                                len(layer.kb), dtype),
                            "cluster": split(n_in, knob["bi"])[2],
                            "mma_flops": 2.0 * outs * split(n_in, 32)[0]
                            * 32 * nbk1,
                            "useful_flops": a["work"][-2][0]})
                else:
                    kc, n = layer.w_c.shape

                    def library(xc=xin, layer=layer):
                        y = torch.addmm(layer.b, xc, layer.w_c)
                        return torch.relu_(y) if layer.act == "relu" else y
                    time_into(a, kernel, plain, library)
                    a["work"] += [(2.0 * batch * kc * n, mac_rate),
                                  (batch * n, F32_FLOPS_PER_S)]
                    a["bytes"] += esz * (xin.numel() + layer.w_c.numel() + n
                                         + batch * n)
                    a["shapes"].append(f"{batch}x{kc}->{n} act={layer.act} "
                                       f"{precision}")
                    tiles = resolve_blocks(batch, kc, n, dtype, device=dev)
                    a["blocks"].append(tiles)
                    if precision == "bf16":
                        # the grid, the row tiles a block walks, and
                        # which kernel: one row tile runs the first
                        # design's, more the persistent one
                        grid = bf16_grid(batch, kc, n, tiles, sms)
                        row_tiles = -(-batch // tiles["bm"])
                        a["design"].append({
                            "kernel": ("one tile" if row_tiles == 1
                                       else "persistent"),
                            "grid": list(grid),
                            "row_tiles_a_block": -(-row_tiles // grid[0])})
                x = kernel()
            torch.cuda.synchronize()
            record(kan_k, precision, batch, acc[kan_k], n_kan)
            record(mm_k, precision, batch, acc[mm_k], n_mlp)

            layer, xin = kan_inputs(stack, rand(np.random.default_rng(2),
                                                batch, "vikin-mixed",
                                                dtype))[0]
            kan_spec = layer.cfg.spec
            n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
            flat = xin.reshape(-1)
            n = flat.numel()
            # each input read once and its G+K values written once; the
            # SPU operations of core/splines.spu_op_count per input
            a = new_acc()
            time_into(a, lambda: spline_basis(flat, kan_spec),
                      lambda: spline_basis_plain(flat, kan_spec))
            a["bytes"] = esz * n * (1 + kan_spec.n_bases)
            a["work"] = [(float(n * spu_op_count(kan_spec)),
                          F32_FLOPS_PER_S)]
            a["shapes"] = [f"n={n} ({batch}x{n_in} flattened) "
                           f"G{kan_spec.grid_size}K{kan_spec.order} "
                           f"{precision}"]
            rec = record("spline_basis" + SUFFIX[dtype], precision, batch, a)
            rec["block_n"] = resolve_block_n(n, kan_spec.n_bases, dtype,
                                             device=dev)
            t_flat = t_flat_of(layer)
            a = new_acc()
            time_into(a, lambda: kan_fused_v1(xin, layer.w_b, t_flat,
                                              kan_spec, layer.kb,
                                              layer.slot_of),
                      lambda: kan_fused_v1_ref(xin, layer.w_b, t_flat,
                                               kan_spec, layer.kb))
            a["bytes"] = (esz * (xin.numel() + layer.w_b.numel()
                                 + t_flat.numel() + batch * n_out)
                          + 4.0 * layer.slot_of.numel())
            a["work"] = kan_work(layer, xin, mac_rate, 4)
            a["shapes"] = [f"{batch}x{n_in}->{n_out} kb={list(layer.kb)} "
                           f"{precision}"]
            a["blocks"] = [kan_blocks(batch, n_in, n_out, len(layer.kb),
                                      dtype, version=1, device=dev)]
            rec = record("kan_fused_v1" + SUFFIX[dtype], precision, batch, a)

            def v2(xin=xin, layer=layer):
                return kan_fused_v2(xin, layer.wt, kan_spec, layer.kb,
                                    layer.slot_of)
            rec["v2_ms"] = time_ms(v2)
            rec["v2_graph_ms"] = graph_ms(v2)
            torch.cuda.synchronize()

    # the mixed kernel at the vikin-mixed KAN layer: the bf16 stack's
    # input against the f32 stack's fused rows (a bf16 model holding the
    # reference's f32 t), its multiply-adds at the cheaper of f32 FMAs and
    # three bf16-plane products (mixed_macs)
    f_layer = next(lay for lay in backends["vikin-mixed"].stack.layers
                   if isinstance(lay, KANLayer))
    for batch in (8, BIG):
        _, xin = kan_inputs(bf_backends["vikin-mixed"].stack,
                            rand(np.random.default_rng(2), batch,
                                 "vikin-mixed", BF))[0]
        n_in, n_out = f_layer.cfg.n_in, f_layer.cfg.n_out
        a = new_acc()
        time_into(a, lambda xin=xin: kan_fused_v2(
            xin, f_layer.wt, f_layer.cfg.spec, f_layer.kb, f_layer.slot_of),
                  lambda xin=xin: kan_fused_v2_ref(
                      xin, f_layer.wt, f_layer.cfg.spec, f_layer.kb))
        a["work"] = kan_work(f_layer, xin, F32_FLOPS_PER_S, 4)
        macs = a["work"][0][0]
        a["work"][0] = mixed_macs(macs)
        a["bytes"] = (2.0 * (xin.numel() + batch * n_out)
                      + 4.0 * (f_layer.wt.numel() + f_layer.slot_of.numel()))
        a["shapes"] = [f"{batch}x{n_in}->{n_out} kb={list(f_layer.kb)} "
                       f"bf16 x, f32 weights"]
        knob = kan_blocks(batch, n_in, n_out, len(f_layer.kb), BF,
                          device=dev, wt_dtype=F32)
        a["blocks"] = [knob]
        # the tensor-core body's shared memory a block (f32 rows and their
        # plane tile), and the multiply-adds its three plane MMAs issue on
        # the dense tile beside the useful ones
        nbk1 = len(f_layer.kb) + 1
        outs = (-(-batch // knob["bm"]) * max(16, knob["bm"])
                * -(-n_out // knob["bn"]) * knob["bn"])
        a["design"] = [{
            "smem_bytes": kernel_smem(knob["bm"], knob["bi"], knob["bn"],
                                      n_in, len(f_layer.kb), BF,
                                      wt_dtype=F32),
            "threads": kernel_threads(knob["bm"], knob["bn"], BF,
                                      wt_dtype=F32),
            "cluster": split(n_in, knob["bi"])[2],
            "mma_flops": MIXED_PLANES * 2.0 * outs * split(n_in, 32)[0]
            * 32 * nbk1,
            "useful_flops": MIXED_PLANES * macs}]
        record(MIXED, "bf16 x, f32 weights", batch, a)
    torch.cuda.synchronize()

    # the int8 kernels at the int8 vikin-mixed stack's shapes
    q_stack = q8_backends["vikin-mixed"].stack
    for batch in (8, BIG):
        x = rand(np.random.default_rng(2), batch, "vikin-mixed")
        h = quantize_static(x, q_stack.x_scales[0])
        acc = {k: new_acc() for k in Q8_KERNELS}
        for i, layer in enumerate(q_stack.layers):
            name, xin, kernel, plain, finish = q8_layer_calls(layer, h)
            a = acc[name]
            if isinstance(layer, QuantKANLayer):
                n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
                time_into(a, kernel, plain)
                # the x dequantization per (row, feature) besides the SPU
                # work, and each weight dequantized once
                a["work"] += kan_work(layer, xin.to(F32) * layer.x_scale,
                                      F32_FLOPS_PER_S, 5)
                a["work"].append((float(layer.wt_q.numel()),
                                  F32_FLOPS_PER_S))
                a["bytes"] += (xin.numel() + layer.wt_q.numel()
                               + 4.0 * (layer.slot_scales.numel()
                                        + layer.slot_of.numel()
                                        + batch * n_out))
                a["shapes"].append(f"{batch}x{n_in}->{n_out} "
                                   f"kb={list(layer.kb)} int8")
                a["blocks"].append(kan_blocks(batch, n_in, n_out,
                                              len(layer.kb), torch.int8,
                                              device=dev))
            else:
                kc, n = layer.w_q_c.shape
                library = None
                # torch._int_mm takes M > 16 and K, N multiples of 8
                if batch > 16 and not kc % 8 and not n % 8:
                    def library(xc=xin, w=layer.w_q_c):
                        return torch._int_mm(xc, w)
                    try:
                        library()
                    except RuntimeError as e:
                        print(f"phase 4: torch._int_mm on {batch}x{kc}->{n} "
                              f"refused: {e}")
                        library = None
                time_into(a, kernel, plain, library)
                a["work"].append((2.0 * batch * kc * n, INT8_OPS_PER_S))
                a["bytes"] += xin.numel() + layer.w_q_c.numel() + 4.0 * (
                    batch * n)
                a["shapes"].append(f"{batch}x{kc}->{n} int8")
                a["blocks"].append(resolve_blocks(batch, kc, n, torch.int8,
                                                  device=dev))
            y = finish(kernel())
            if i + 1 < len(q_stack.layers):
                h = quantize_static(y, q_stack.x_scales[i + 1])
        torch.cuda.synchronize()
        record("kan_fused_v2_q8", "int8", batch, acc["kan_fused_v2_q8"],
               n_kan)
        record("pattern_matmul_q8", "int8", batch, acc["pattern_matmul_q8"],
               n_mlp)

    # Where one served batch's time goes, per precision and arch at bucket
    # 8: the host wall of a backend forward (copy in, every layer, copy out
    # and sync), the stack alone on the card (gathers + kernels, CUDA
    # events), and the kernels alone; each "graph" time is the same work
    # replayed from a CUDA graph, i.e. device time alone.  1 -
    # stack_graph_ms / forward_ms is the share of a served forward the
    # device sits idle.
    breakdown = []
    for precision, bes in (("f32", backends), ("int8", q8_backends),
                           ("bf16", bf_backends)):
        for name in ARCHS:
            be = bes[name]
            xb = rng.random((8, be.n_in), dtype=np.float32)
            x_dev = torch.from_numpy(xb).to(
                dev, BF if precision == "bf16" else F32)
            kernels = [k for _, _, k in
                       stack_calls(precision, be.stack, x_dev)]
            rec = {"arch": name, "precision": precision, "bucket": 8,
                   "forward_ms": host_ms(lambda: be.forward(xb)),
                   "stack_ms": time_ms(lambda: be.stack(x_dev)),
                   "stack_graph_ms": graph_ms(lambda: be.stack(x_dev)),
                   "kernel_ms": sum(time_ms(k) for k in kernels),
                   "kernel_graph_ms": sum(graph_ms(k) for k in kernels),
                   "card": card}
            breakdown.append(rec)
            print(json.dumps({"breakdown": rec}))
    for precision, sv in served.items():
        print(json.dumps({"serve": {"archs": list(ARCHS),
                                    "precision": precision, "requests": 48,
                                    "slots": 8, "wall_s": sv["wall_s"],
                                    "wall_rps": sv["wall_rps"],
                                    "card": card}}))

    # ---------------------------------------------------------------- 5
    # the v1 path: a KAN layer configured at version 1, on vikin-kan2's
    # weights, at the serving buckets, one large batch, a batch of more
    # 16-row tiles than grid.y holds, and once with explicit knobs
    kan2 = VIKIN_ARCHS["vikin-kan2"]
    layer2 = backends["vikin-kan2"].stack.layers[0]
    layer1 = KANLayer(dataclasses.replace(layer2.cfg, version=1),
                      {"w_b": layer2.w_b, "t": layer2.t})
    knob1 = (8, 64, 16)
    layer1k = KANLayer(dataclasses.replace(layer2.cfg, version=1,
                                           blocks=knob1),
                       {"w_b": layer2.w_b, "t": layer2.t})
    huge = 65535 * 16 + 1
    v1_rng = np.random.default_rng(4)
    v1_x = {b: torch.from_numpy(v1_rng.random(
        (b, kan2.sizes[0]), dtype=np.float32)).to(dev)
        for b in BUCKETS + (BIG, huge)}
    _build.reset_launches()
    v1_out = {b: layer1(x) for b, x in v1_x.items()}
    v1_out["knob"] = layer1k(v1_x[8])
    torch.cuda.synchronize()
    v1_launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in v1_launches}
    want["kan_fused_v1"] = len(v1_out)
    check(v1_launches == want, f"v1 path: launches {v1_launches}, the "
          f"{len(v1_out)} layer calls imply {want}")
    cpu_layer = KANLayer(layer1.cfg, {"w_b": layer2.w_b.cpu(),
                                      "t": layer2.t.cpu()})
    v1_err = 0.0
    for b, y in v1_out.items():
        x = v1_x[8 if b == "knob" else b]
        rows = x.shape[0]
        check(y.shape == (rows, kan2.sizes[-1])
              and bool(torch.isfinite(y).all()),
              f"v1 path B={b}: output {tuple(y.shape)} or not finite")
        refs = [("the v2 layer", layer2(x)),
                ("the plain version", kan_fused_v1_ref(
                    x, layer1.w_b, layer1.t_flat, layer1.cfg.spec,
                    layer1.kb))]
        if b != huge:
            refs.append(("the layer on the CPU", cpu_layer(x.cpu()).to(dev)))
        for what, ref in refs:
            err, scale, nan = rel_err(y, ref)
            check(not nan and err <= KERNEL_TOL * scale,
                  f"v1 path B={b}: max|v1 layer - {what}| = {err:.3e} > "
                  f"{KERNEL_TOL:g} * {scale:.4g} (NaN: {nan})")
            v1_err = max(v1_err, err)
        del refs
    check(torch.equal(v1_out["knob"], v1_out[8]),
          f"v1 path: KANConfig(blocks={knob1}) != the default knob, bitwise")
    del v1_x[huge], v1_out[huge]
    torch.cuda.empty_cache()
    print(f"phase 5: v1 KANLayer on vikin-kan2's weights at batches "
          f"{sorted(k for k in v1_out if k != 'knob')} and at B=8 with "
          f"KANConfig(blocks={knob1}) (bitwise the default knob's): "
          f"launches {v1_launches}; within {KERNEL_TOL:g}*(1+max|ref|) of "
          f"the v2 layer, the plain version and (below B={huge}) the layer "
          f"on the CPU, max abs err {v1_err:.3e}")

    # the bf16 v1 path: a version-1 KANLayer on the bf16 vikin-kan2 stack's
    # weights, at the serving buckets and one large batch
    b_layer2 = bf_backends["vikin-kan2"].stack.layers[0]
    b_layer1 = KANLayer(dataclasses.replace(b_layer2.cfg, version=1),
                        {"w_b": b_layer2.w_b, "t": b_layer2.t})
    b_v1_x = {b: v1_x[b].to(BF) for b in BUCKETS + (BIG,)}
    _build.reset_launches()
    b_v1_out = {b: b_layer1(x) for b, x in b_v1_x.items()}
    torch.cuda.synchronize()
    b_v1_launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in b_v1_launches}
    want["kan_fused_v1_bf16"] = len(b_v1_out)
    check(b_v1_launches == want, f"bf16 v1 path: launches {b_v1_launches}, "
          f"the {len(b_v1_out)} layer calls imply {want}")
    b_v1_err = 0.0
    for b, y in b_v1_out.items():
        x = b_v1_x[b]
        check(y.shape == (b, kan2.sizes[-1]) and y.dtype == BF
              and bool(torch.isfinite(y.float()).all()),
              f"bf16 v1 path B={b}: output {tuple(y.shape)} {y.dtype} or "
              f"not finite")
        for what, ref in (("the bf16 v2 layer", b_layer2(x)),
                          ("the plain version", kan_fused_v1_ref(
                              x, b_layer1.w_b, b_layer1.t_flat,
                              b_layer1.cfg.spec, b_layer1.kb))):
            err, scale, nan = rel_err(y, ref)
            check(not nan and err <= BF16_ULP * scale,
                  f"bf16 v1 path B={b}: max|v1 layer - {what}| = {err:.3e} "
                  f"> {BF16_ULP:g} * {scale:.4g} (NaN: {nan})")
            b_v1_err = max(b_v1_err, err)
    print(f"phase 5: bf16 v1 KANLayer on vikin-kan2's bf16 weights at "
          f"batches {sorted(b_v1_out)}: launches {b_v1_launches}; within "
          f"{BF16_ULP:g}*(1+max|ref|) of the bf16 v2 layer and the plain "
          f"version, max abs err {b_v1_err:.3e}")

    # ---------------------------------------------------------------- 6
    _build.reset_launches()
    bench = kernel_bench.run(device=DEVICE,
                             out=ROOT / "chiprun_out" / "kernel_bench.json")
    torch.cuda.synchronize()
    bench_launches = dict(_build.LAUNCHES)
    for k in ("spline_basis", "kan_fused_v1", "kan_fused_v2",
              "pattern_matmul", "spline_basis_bf16", "kan_fused_v1_bf16",
              "kan_fused_v2_bf16"):
        check(bench_launches[k] > 0,
              f"kernel bench: {k} launched {bench_launches[k]} times")
    bf_rows = {f"{sec}.{key}": row for sec in ("spline_basis", "kan_fused")
               for key, row in bench[sec].items() if key.endswith("bfloat16")}
    check(len(bf_rows) == 6, f"kernel bench: bf16 rows {sorted(bf_rows)}")
    for key, row in bf_rows.items():
        print(f"phase 6: bf16 row {key}: "
              + ", ".join(f"{f} {v:.3e}" if isinstance(v, float) else
                          f"{f} {v}" for f, v in row.items()
                          if f.startswith(("max_err", "ms"))
                          or f == "bitwise_plain"))
    check(bench["tuning"]["cache_round_trip"],
          "kernel bench: the tuned block_n did not round-trip")
    tm = bench["tuning"]["pattern_matmul"]
    check(tm["cache_round_trip"],
          "kernel bench: the tuned matmul tiles did not round-trip")
    tk = bench["tuning"]["kan_fused"]
    check(tk["cache_round_trip"],
          "kernel bench: the tuned KAN knobs did not round-trip")
    tk1 = bench["tuning"]["kan_fused_v1"]
    check(tk1["cache_round_trip"] and tk1["cache_key"].startswith(
        "kan_fused_v1|"),
          "kernel bench: the tuned v1 KAN knobs did not round-trip")
    check(bench_launches["kan_fused_v2"] > 0,
          "kernel bench: the KAN tuning launched nothing")
    print(f"phase 6: kernel bench passed its asserts; launches "
          f"{bench_launches}; tuned {bench['tuning']['tuned_blocks']} at "
          f"n={bench['tuning']['n']}; matmul {tm['shape']} relu tuned "
          f"{tm['tuned_blocks']} ({tm['ms_tuned']} ms) vs default "
          f"{tm['default_blocks']} ({tm['ms_default']} ms), bitwise equal; "
          f"KAN {tk['shape']} tuned {tk['tuned_blocks']} ({tk['ms_tuned']} "
          f"ms) vs default {tk['default_blocks']} ({tk['ms_default']} ms), "
          f"bitwise equal; v1 KAN tuned {tk1['tuned_blocks']} "
          f"({tk1['ms_tuned']} ms) vs default {tk1['default_blocks']} "
          f"({tk1['ms_default']} ms), bitwise equal")

    # ---------------------------------------------------------------- 7
    committed = json.loads((ROOT / "BENCH_serving.json").read_text())
    burst_ref = committed["openloop:burst:vikin-mlp3"]
    mlp3 = VIKIN_ARCHS["vikin-mlp3"]
    burst, _, max_queue = loadgen_bench.burst_trace("vikin-mlp3")
    check(burst.sha256() == burst_ref["trace_sha256"],
          f"burst trace sha256 {burst.sha256()} != the committed "
          f"{burst_ref['trace_sha256']}")
    shed_kw = {"max_queue": max_queue, "admission": "shed",
               "drop_expired": True}
    open_launches = {k: 0 for k in KERNEL_INFO}
    openloop = []

    def drive(eng, trace, mode: str, precision: str, what: str) -> dict:
        """Replay ``trace`` through ``eng``; check the drain, the bound,
        every request's fate, that nothing was built or resolved, the
        launches against the served batches and every answer; return the
        report."""
        builds, resolved = dict(_build.BUILDS), set(autotune.RESOLVED)
        _build.reset_launches()
        rep = replay(eng, trace, mode=mode)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        check(not rep["incomplete"] and rep["bound_respected"],
              f"{what}: incomplete {rep['incomplete']}, bound respected "
              f"{rep['bound_respected']}")
        check(rep["offered"] == rep["completed"] + rep["rejected"]
              + rep["shed"] + rep["expired"],
              f"{what}: {rep['offered']} offered, {rep['completed']} "
              f"completed + {rep['rejected']} rejected + {rep['shed']} "
              f"shed + {rep['expired']} expired")
        check(dict(_build.BUILDS) == builds
              and set(autotune.RESOLVED) == resolved,
              f"{what}: a kernel was built or a knob resolved inside the "
              f"replay")
        # a fresh engine (and MultiWorkloadBackend) per replay: its
        # batches are this replay's
        batches = ({n: ws["batches"]
                    for n, ws in eng.per_workload_stats().items()}
                   or {eng.backend.model.name: eng.stats["ticks"]})
        want = {k: 0 for k in KERNEL_INFO}
        kan_k, mm_k = SERVED_KERNELS[precision]
        for name, b in batches.items():
            kinds = VIKIN_ARCHS[name].layer_kinds
            want[kan_k] += int(b) * kinds.count("kan")
            want[mm_k] += int(b) * kinds.count("mlp")
        check(got == want and want[mm_k] > 0,
              f"{what}: launches {got}, the served batches imply {want}")
        for k in KERNEL_INFO:
            open_launches[k] += got[k]
        subs = (eng.backend.backends if hasattr(eng.backend, "backends")
                else {eng.backend.model.name: eng.backend})
        done = [r for r in eng._requests.values() if r.done]
        check(len(done) == rep["completed"],
              f"{what}: {len(done)} answers for {rep['completed']} "
              f"completions")
        err = 0.0
        for name, be in subs.items():
            rs = [r for r in done if r.workload in (name, None)]
            if not rs:
                continue
            xs = np.stack([r.prompt for r in rs]).astype(np.float32)
            answers = np.stack([r.output for r in rs])
            err = max(err, hold(precision, be.stack, xs, answers,
                                f"{what} {name}")[0])
        rep["max_abs_err"] = err
        return rep

    def show(rep: dict, what: str) -> None:
        ms = {q: rep[f"p{q}_latency_s"] * 1e3 for q in (50, 95, 99)}
        print(f"phase 7: {what}: offered {rep['offered_rps']:.1f} req/s, "
              f"achieved {rep['achieved_rps']:.1f}, goodput "
              f"{rep['goodput_rps']:.1f}; latency p50/p95/p99 "
              f"{ms[50]:.4f}/{ms[95]:.4f}/{ms[99]:.4f} ms; completed "
              f"{rep['completed']}/{rep['offered']}, shed {rep['shed']}, "
              f"expired {rep['expired']}, deadline met "
              f"{rep['deadline_met']}, queue hwm {rep['queue_depth_hwm']}; "
              f"max abs err {rep['max_abs_err']:.3e} ({card})")

    # the replay loop synthesizes each arrival's payload on the host, in
    # the thread that serves: above 1 / (this time) arrivals a second the
    # loop falls behind the trace (each request still counts from its
    # trace time)
    t0 = time.perf_counter()
    for i in range(2000):
        np.random.default_rng(i).random(mlp3.sizes[0], dtype=np.float32)
    payload_us = (time.perf_counter() - t0) / 2000 * 1e6
    print(f"phase 7: card {card}; a replayed arrival's payload takes "
          f"{payload_us:.2f} us of host time to synthesize")
    mlp3_be = {}
    # (a) also at bf16 (no wall-clock sweep at bf16: the benchmark takes it)
    for precision in ("f32", "int8", "bf16"):
        be = mlp3_be[precision] = make_vikin_backend(
            mlp3, DEVICE, precision=precision)
        loadgen_bench.warm_buckets(be, 8)
        cpu_be = (make_vikin_backend(mlp3, "cpu", precision=precision)
                  if precision != "f32" else None)
        for label, kw in (("unbounded", {}), ("shed", shed_kw)):
            what = f"(a) {precision} burst trace, {label}, sim clock"
            rep = drive(Engine(be, n_slots=8, **kw), burst, "sim",
                        precision, what)
            fields = {k: rep[k] for k in loadgen_bench.BURST_FIELDS}
            if cpu_be is None:
                ref, whose = burst_ref[label], "the committed row"
            else:
                cpu_rep = replay(Engine(cpu_be, n_slots=8, **kw), burst,
                                 mode="sim")
                ref = {k: cpu_rep[k] for k in loadgen_bench.BURST_FIELDS}
                whose = "the CPU replay"
            check(fields == ref, f"{what}: {fields} != {whose} {ref}")
            print(f"phase 7: {what}: every field equals {whose}")
            show(rep, what)
            openloop.append({"part": "a", "precision": precision,
                             "engine": label, "card": card, **rep})

    multi_be = {p: served[p]["eng"].backend.backends for p in PRECISIONS}
    for precision in ("f32", "int8"):
        engines = {
            "vikin-mlp3": lambda **kw: Engine(mlp3_be[precision], n_slots=8,
                                              **kw),
            "multi": lambda **kw: Engine(
                MultiWorkloadBackend(dict(multi_be[precision])), n_slots=8,
                **kw),
        }
        for target, make in engines.items():
            probe = make()
            loadgen_bench.warm_buckets(probe.backend, 8)
            models = ([mlp3] if target == "vikin-mlp3"
                      else [VIKIN_ARCHS[n] for n in ARCHS])
            # C: 960 requests as 15 closed bursts of 64, each submitted
            # and served in the timed region, as a replay submits in the
            # serving thread; one burst of 960 (submitted first) is timed
            # too, for what a deep queue costs the batch policy
            t0 = time.perf_counter()
            for i in range(15):
                submit_burst(probe, models, 64, seed=7 + i)
                probe.run_until_done()
            cap = 960 / (time.perf_counter() - t0)
            submit_burst(probe, models, 960, seed=7)
            t0 = time.perf_counter()
            probe.run_until_done()
            deep = 960 / (time.perf_counter() - t0)
            batch_s = 8 / cap
            print(f"phase 7: (b) {precision} {target}: closed-burst rate C "
                  f"= {cap:.1f} req/s on 8 slots (bursts of 64, submission "
                  f"timed), one full batch {batch_s * 1e3:.4f} ms; "
                  f"{deep:.1f} req/s serving one burst of 960 ({card})")
            mix = (None if target == "vikin-mlp3"
                   else [(n, 1.0) for n in ARCHS])
            runs = [(f"poisson {m}C", {}, poisson_trace(
                m * cap, 2000, seed=11, workloads=mix))
                for m in (0.5, 0.9, 1.5)]
            if target == "vikin-mlp3":
                deadline = 4 * batch_s
                bt = bursty_trace(
                    0.5 * cap, 5.0 * cap, 2000, mean_calm_s=16 * batch_s,
                    mean_burst_s=48 * batch_s, seed=11,
                    priority_classes=[(0, 0.7, deadline),
                                      (2, 0.3, deadline)])
                runs += [("bursty, unbounded", {}, bt),
                         ("bursty, shed", shed_kw, bt)]
            for label, kw, trace in runs:
                what = f"(b) {precision} {target} {label}, wall clock"
                rep = drive(make(**kw), trace, "wall", precision, what)
                show(rep, what)
                openloop.append({"part": "b", "precision": precision,
                                 "target": target, "run": label,
                                 "closed_rps": cap, "closed_rps_960": deep,
                                 "card": card, **rep})

    bench_out = ROOT / "chiprun_out" / "serving_bench.json"
    bench_out.unlink(missing_ok=True)
    rows = serving_bench.run(DEVICE, bench_out,
                             families=("burst", "sched", "kanffn"))
    rows.update(loadgen_bench.run(DEVICE, bench_out))
    for key, row in json.loads(json.dumps(rows)).items():
        ref = committed[key]
        if key.startswith("openloop:"):
            same = {k: v for k, v in row.items() if k != "device"} == ref
        elif key.startswith("sched:"):
            same = row["bitwise_identical"] and all(
                row["policies"][p][f] == v
                for p, pol in ref["policies"].items()
                for f, v in pol.items() if not f.startswith("wall"))
        else:
            same = all(row[f] == v for f, v in ref.items()
                       if not f.startswith("wall"))
        check(same, f"(c) bench row {key} differs from the committed row "
              f"in a simulated field (or is not bitwise): {row}")
    print(f"phase 7: (c) {sorted(rows)} on the card: every simulated field "
          f"equals the committed row; sched batched == single, bitwise, "
          f"under both policies")
    print(f"phase 7: launches over the replays {open_launches}")

    # ---------------------------------------------------------------- 8
    # training on the card (f32, IEEE products): (a) one vikin-mixed step's
    # gradients through the kernels' autograd Functions against autograd
    # through the plain versions, and its launches; (b) StackTrainer runs of
    # vikin-mixed and vikin-kan2: the validation MSE falls, two runs are
    # bitwise equal, the first losses agree with a CPU run, ms a step;
    # (c) the launcher end to end and its checkpoint served at f32 and int8;
    # (d) an AsyncCheckpointer write overlapped with training steps
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the gradient products must be IEEE f32")
    train_cfg = StackTrainerConfig(steps=TRAIN_STEPS, batch_size=64,
                                   device=DEVICE)
    want_step = {"vikin-mixed": {"kan_fused_v2": 1, "pattern_matmul": 2,
                                 "spline_basis": 2},
                 # the first layer's x needs no gradient: no order K-1 basis
                 "vikin-kan2": {"kan_fused_v2": 1, "spline_basis": 1}}
    tasks = {a: task_for_model(VIKIN_ARCHS[a]) for a in want_step}
    inits = {a: vikin_stack_init(VIKIN_ARCHS[a],
                                 torch.Generator().manual_seed(0))
             for a in want_step}

    train = {}
    for arch in want_step:
        model = VIKIN_ARCHS[arch]
        tr = StackTrainer(model, tasks[arch], train_cfg, params=inits[arch])
        x, y = tr.batch(0)
        _build.reset_launches()
        loss_k, g_k = tr.value_and_grad(x, y)
        torch.cuda.synchronize()
        g_k = dict(leaf_paths(g_k))
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(got == want_step[arch],
              f"(a) {arch}: one step's forward and backward launched {got}, "
              f"expected {want_step[arch]}")
        loss_p, g_p = plain_grads(tr.params, model, x, y)
        errs = {}
        for k in g_p:
            err, scale, nan = rel_err(g_k[k], g_p[k])
            mag = scale - 1.0
            check(not nan and err <= TRAIN_GRAD_TOL * mag,
                  f"(a) {arch} d{k}: max|kernel - plain| = {err:.3e} vs "
                  f"{TRAIN_GRAD_TOL:g} * max|plain| {mag:.4g}")
            errs[k] = {"max_abs_err": err, "max_abs_plain": mag}
        loss_k, loss_p = float(loss_k), float(loss_p)
        check(abs(loss_k - loss_p) <= TRAIN_GRAD_TOL * abs(loss_p),
              f"(a) {arch}: loss {loss_k} vs plain {loss_p}")
        print(f"phase 8: (a) {arch} batch 64: one forward + backward "
              f"launched {got}; loss {loss_k:.6f} (plain {loss_p:.6f}); "
              f"each leaf's gradient within {TRAIN_GRAD_TOL:g}*max|plain| "
              f"of autograd through the plain versions, max abs err / "
              f"max|plain|: " + ", ".join(
                  f"d{k} {e['max_abs_err']:.3e} / {e['max_abs_plain']:.3e}"
                  for k, e in errs.items()))
        train[arch] = {"grad_err": errs, "step_launches": got}

    # (b) two runs from the same init, bitwise; a CPU run's first losses
    train_launches = {k: 0 for k in KERNEL_INFO}
    for arch in want_step:
        model = VIKIN_ARCHS[arch]
        runs = []
        for rep in range(2):
            tr = StackTrainer(model, tasks[arch], train_cfg,
                              params=inits[arch])
            val0 = tr.evaluate()["val_mse"]
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            losses = [tr.train_step(s)[0] for s in range(TRAIN_STEPS)]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            launched = dict(_build.LAUNCHES)
            want = {k: TRAIN_STEPS * want_step[arch].get(k, 0)
                    for k in KERNEL_INFO}
            check(launched == want, f"(b) {arch}: {TRAIN_STEPS} steps "
                  f"launched {launched}, expected {want}")
            if rep == 0:
                for k in KERNEL_INFO:
                    train_launches[k] += launched[k]
            val1 = tr.evaluate()["val_mse"]
            runs.append({"tr": tr, "losses": torch.stack(losses).cpu(),
                         "val0": val0, "val1": val1, "wall_ms": wall_ms})
        a, b = runs
        check(a["val1"] < a["val0"],
              f"(b) {arch}: validation MSE {a['val0']:.6f} -> "
              f"{a['val1']:.6f} after {TRAIN_STEPS} steps")
        same = all(torch.equal(pa, pb) for (_, pa), (_, pb) in zip(
            leaf_paths(a["tr"].params), leaf_paths(b["tr"].params)))
        check(same and torch.equal(a["losses"], b["losses"]),
              f"(b) {arch}: two runs from one seed differ")
        cpu_tr = StackTrainer(model, tasks[arch],
                              dataclasses.replace(train_cfg, device="cpu"),
                              params=inits[arch])
        cpu_losses = torch.stack([cpu_tr.train_step(s)[0]
                                  for s in range(CPU_STEPS)])
        rel = ((a["losses"][:CPU_STEPS] - cpu_losses).abs()
               / cpu_losses.abs())
        check(float(rel.max()) <= TRAIN_LOSS_TOL,
              f"(b) {arch}: the first {CPU_STEPS} losses differ from the "
              f"CPU run's by up to {float(rel.max()):.3e} relative "
              f"(> {TRAIN_LOSS_TOL:g}): card {a['losses'][:CPU_STEPS]}, "
              f"cpu {cpu_losses}")

        # ms a step: host wall (above), and device spans by CUDA events of
        # the forward (run alone, with grad), the forward and backward,
        # and the AdamW update, synchronised between them (a span includes
        # the card's idle gaps waiting on the host), over steps past the
        # measured runs
        tr = a["tr"]
        spans = {"forward": [], "backward": [], "update": []}
        for s in range(TRAIN_STEPS, TRAIN_STEPS + 30):
            x, y = tr.batch(s)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            torch.cuda.synchronize()
            params = tree_map(lambda p: p.detach().requires_grad_(True),
                              tr.params)
            ev[0].record()
            tr.loss_fn(params, x, y)
            ev[1].record()
            torch.cuda.synchronize()
            ev[2].record()
            _, grads = tr.value_and_grad(x, y)
            ev[3].record()
            torch.cuda.synchronize()
            ev[4].record()
            tr.apply(grads)
            ev[5].record()
            torch.cuda.synchronize()
            fwd = ev[0].elapsed_time(ev[1])
            spans["forward"].append(fwd)
            spans["backward"].append(ev[2].elapsed_time(ev[3]) - fwd)
            spans["update"].append(ev[4].elapsed_time(ev[5]))
        span_ms = {k: statistics.median(v) for k, v in spans.items()}
        # the spline-basis launches of one backward alone, device time
        kan_i = model.layer_kinds.index("kan")
        h = torch.from_numpy(tr._batch_at(0)[0]).to(dev)
        with torch.no_grad():
            for layer in range(kan_i):
                p = tr.params[layer]
                h = torch.relu(h @ p["w"] + p["b"])
        spec = model.spec
        hc = spec.clip(h)
        orders = ([spec] + ([SplineSpec(spec.grid_size, spec.order - 1)]
                            if want_step[arch]["spline_basis"] == 2 else []))
        for o in orders:
            spline_basis(hc, o)
        sb_ms = graph_ms(lambda: [spline_basis(hc, o) for o in orders])
        outside = 1.0 - sb_ms / span_ms["backward"]
        train[arch].update({
            "steps": TRAIN_STEPS, "val_mse_before": a["val0"],
            "val_mse_after": a["val1"], "host_ms_per_step": a["wall_ms"],
            "host_ms_per_step_run2": b["wall_ms"],
            "device_span_ms": span_ms,
            "device_span_ms_step": sum(span_ms.values()),
            "spline_basis_backward_ms": sb_ms,
            "backward_share_outside_kernels": outside,
            "first_losses_card": a["losses"][:CPU_STEPS].tolist(),
            "first_losses_cpu": cpu_losses.tolist(),
            "loss_rel_err_vs_cpu": float(rel.max()), "card": card})
        print(f"phase 8: (b) {arch}: {TRAIN_STEPS} steps at batch 64, "
              f"validation MSE {a['val0']:.6f} -> {a['val1']:.6f}; two runs "
              f"bitwise equal; first {CPU_STEPS} losses within "
              f"{float(rel.max()):.3e} relative of the CPU run's; host "
              f"{a['wall_ms']:.4f} ms a step ({b['wall_ms']:.4f} in the "
              f"second run); device spans forward {span_ms['forward']:.4f} "
              f"/ backward {span_ms['backward']:.4f} / update "
              f"{span_ms['update']:.4f} ms; the backward's spline-basis "
              f"launches {sb_ms:.4f} ms alone, {100 * outside:.1f}% of the "
              f"backward span outside them ({card})")

    # (c) the launcher end to end, then its checkpoint served
    mixed_tr = VIKIN_ARCHS["vikin-mixed"]
    val_x = tasks["vikin-mixed"]["val_x"][:24]
    with tempfile.TemporaryDirectory() as ck:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "vikin-mixed", "--steps", str(TRAIN_STEPS), "--batch", "64",
               "--pattern", "0.5", "--precision", "int8", "--device", DEVICE,
               "--ckpt-dir", ck]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ,
                                                   PYTHONPATH=str(SRC)))
        launcher_s = time.perf_counter() - t0
        print("\n".join(f"phase 8: (c) | {line}"
                        for line in run.stdout.strip().splitlines()[-8:]))
        check(run.returncode == 0,
              f"(c) the launcher exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
        saved = restore_masks(ck)
        params_ck, step_ck, extra = restore_checkpoint(
            ck, vikin_stack_init(mixed_tr))
        check(step_ck == TRAIN_STEPS,
              f"(c) the checkpoint is at step {step_ck}, not {TRAIN_STEPS}")
        # the launcher calibrated on the card, its dense forward through
        # the kernels; a calibration of the saved params on the CPU (the
        # plain versions) must give the same masks, except in a group where
        # two saliencies tie within twice the largest card-vs-CPU saliency
        # difference of their layer (each such basis is named)
        calib_x = tasks["vikin-mixed"]["train_x"][:256]
        sal_cpu = stack_saliencies(params_ck, mixed_tr, calib_x)
        sal_card = stack_saliencies(tree_map(lambda p: p.to(dev), params_ck),
                                    mixed_tr, calib_x)
        ties, sal_diff = [], []
        for i, (m, s_c, s_d) in enumerate(zip(saved, sal_cpu, sal_card)):
            if s_c is None:
                check(m is None, f"(c) layer {i}: a saved mask where the "
                      f"calibration keeps the raw features dense")
                continue
            noise = float(np.abs(s_d - s_c).max())
            sal_diff.append(noise / float(np.abs(s_c).max()))
            cpu_keep = magnitude_mask(s_c, 2).keep
            differ = np.nonzero(m.keep != cpu_keep)[0]
            for g in sorted({int(j) // 4 for j in differ}):
                idx = np.arange(4 * g, 4 * g + 4)
                card_only = idx[m.keep[idx] & ~cpu_keep[idx]]
                cpu_only = idx[cpu_keep[idx] & ~m.keep[idx]]
                for a, b in zip(card_only, cpu_only):
                    gap = abs(float(s_c[a]) - float(s_c[b]))
                    check(gap <= 2 * noise,
                          f"(c) layer {i}: the card kept basis {a}, the CPU "
                          f"basis {b}; their saliencies {s_c[a]!r} and "
                          f"{s_c[b]!r} differ by {gap:.3e}, more than twice "
                          f"the card-vs-CPU difference {noise:.3e}")
                    ties.append({"layer": i, "card_kept": int(a),
                                 "cpu_kept": int(b), "gap": gap,
                                 "noise": noise})
        train["calibration"] = {"ties": ties,
                                "saliency_rel_diff_card_cpu": sal_diff}
        print(f"phase 8: (c) masks calibrated on the card by the launcher "
              f"vs a CPU calibration of the saved params: "
              + (f"{len(ties)} bases differ, each in a tie: {ties}" if ties
                 else "equal")
              + f"; card-vs-CPU saliency difference per masked layer, "
              f"relative to its max: "
              + ", ".join(f"{d:.3e}" for d in sal_diff))
        for precision in ("f32", "int8"):
            be = make_vikin_backend(mixed_tr, DEVICE, precision=precision,
                                    ckpt=ck)
            check(all(np.array_equal(m.keep, s_.keep) if m is not None
                      else s_ is None for m, s_ in zip(be.masks, saved)),
                  f"(c) {precision}: the served masks are not the saved ones")
            eng = Engine(be, n_slots=8)
            rids = [eng.submit(r) for r in val_x]
            out = eng.run_until_done()
            err, flips = hold(precision, be.stack, val_x,
                              np.stack([out[r] for r in rids]),
                              f"(c) {precision} trained checkpoint")
            train.setdefault("launcher", {})[precision] = err
            print(f"phase 8: (c) {precision}: the launcher's checkpoint "
                  f"(step {step_ck}, {extra['task']}, val_dense "
                  f"{extra['val_dense']}, val_sparse {extra['val_sparse']}, "
                  f"keep rates {extra['mask_keep_rates']}) served {len(rids)} "
                  f"validation windows, within "
                  f"{SERVE_TOL:g}*(1+max|ref|) of the plain stack, max abs "
                  f"err {err:.3e}; served masks == saved")
        train["launcher"]["seconds"] = launcher_s

    # (d) an asynchronous save overlapped with the next steps
    tr = StackTrainer(mixed_tr, tasks["vikin-mixed"], train_cfg,
                      params=inits["vikin-mixed"])
    for s in range(20):
        tr.train_step(s)
    with tempfile.TemporaryDirectory() as ck:
        saver = AsyncCheckpointer(ck, keep=2)
        snap = tree_map(lambda p: p.detach().cpu().clone(), tr.params)
        saver.save(20, tr.params)
        for s in range(20, 40):
            tr.train_step(s)
        saver.wait()
        back, step_ck, _ = restore_checkpoint(ck, snap)
        same = all(torch.equal(p, q) for (_, p), (_, q) in zip(
            leaf_paths(back), leaf_paths(snap)))
        check(step_ck == 20 and same,
              "(d) the restored params are not the snapshot's bits")
        moved = not all(torch.equal(p.cpu(), q) for (_, p), (_, q) in zip(
            leaf_paths(tr.params), leaf_paths(snap)))
        check(moved, "(d) training did not move the params past the save")
    print("phase 8: (d) AsyncCheckpointer: a save at step 20 written while "
          "steps 20-39 ran on the card restores bitwise equal to the "
          "snapshot")

    # ---------------------------------------------------------------- 9
    # the paper's results on the card (f32, IEEE products), at the paper's
    # widths on the full default Traffic surrogate: (a) Table I's four
    # models at the aggregator's --fast epochs through the port's scripts;
    # (b) KAN-3 at Fig. 8's grids against the plain versions, then the
    # Fig. 8 sweep; (c) Table II and Figs. 6-7; (d) times.  The launches of
    # the scripts' runs (not of the comparisons) are checked against what
    # their steps imply and reported as ``launches_paper``.
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the paper models' products must be IEEE f32")
    # cuBLAS runs the MLP products and the KAN gradient's: ops with a
    # deterministic form take it, one without would warn (two runs are
    # compared bitwise below); no NaN fill of each torch.empty, which would
    # add a launch to every wrapper's output and to the step times
    det_before = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled(),
                  torch_det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch_det.fill_uninitialized_memory = False
    paper_dir = ROOT / "chiprun_out" / "paper"
    traffic = load_traffic(TrafficConfig())
    n_steps = PAPER_EPOCHS * (traffic["train_x"].shape[0] // PAPER_BATCH)
    opt_cfg = AdamWConfig(lr=constant_schedule(1e-3), weight_decay=0.0,
                          grad_clip_norm=None)
    # one step of each paper model, its forward and backward: the f32 KAN
    # kernel once a layer, the spline basis at order K once a layer (d wt)
    # and at order K - 1 where the layer's x needs a gradient (KAN-3's
    # second layer); the MLPs launch no kernel of the port (plain h @ w + b)
    paper_step = {"mlp-4layer": {}, "mlp-3layer": {},
                  "kan-3layer": {"kan_fused_v2": 2, "spline_basis": 3},
                  "kan-2layer": {"kan_fused_v2": 1, "spline_basis": 1}}
    paper = {"card": card, "epochs": PAPER_EPOCHS, "batch": PAPER_BATCH,
             "steps": n_steps, "table1": {}, "fig8": {}}
    paper_launches = {k: 0 for k in KERNEL_INFO}

    def count_launches(what: str, want: dict) -> None:
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(got == {k: v for k, v in want.items() if v},
              f"phase 9 {what}: launched {got}, expected {want}")
        for k, v in got.items():
            paper_launches[k] += v

    def kan_inputs(cfg, params, x: torch.Tensor) -> list:
        """(layer, input) of each layer of the KAN model ``cfg`` in a
        forward on ``x`` (B, 72) in [0, 1], the kernels' outputs chained."""
        pairs, h = [], 2.0 * x - 1.0
        with torch.no_grad():
            for i, p in enumerate(params):
                layer = KANLayer(KANConfig(cfg.sizes[i], cfg.sizes[i + 1],
                                           cfg.spec), p)
                pairs.append((layer, h))
                h = layer(h)
        return pairs

    def step_kernels(spec: SplineSpec, pairs: list) -> list:
        """The kernel launches of one training step over ``pairs``
        (``kan_inputs``), as thunks: each layer's forward, and its
        backward's spline bases (order K; order K - 1 from the second
        layer on, whose x needs a gradient)."""
        calls = []
        lower = SplineSpec(spec.grid_size, spec.order - 1)
        for i, (layer, h) in enumerate(pairs):
            hc = spec.clip(h)
            calls.append(lambda layer=layer, h=h: layer(h))
            calls.append(lambda hc=hc: spline_basis(hc, spec))
            if i > 0:
                calls.append(lambda hc=hc: spline_basis(hc, lower))
        return calls

    # (a) Table I through the script, twice, and a CPU run's first losses
    paper_inits = {n: T1.init_model(c, torch.Generator().manual_seed(0))
                   for n, c in PAPER_MODELS.items()}
    xb0, yb0 = next(iter(traffic_batches(
        traffic["train_x"], traffic["train_y"], PAPER_BATCH, seed=0)))
    xb0, yb0 = torch.from_numpy(xb0).to(dev), torch.from_numpy(yb0).to(dev)
    for name, cfg in PAPER_MODELS.items():
        params = T1.to_device(paper_inits[name], dev)
        _build.reset_launches()
        T1.train_step(params, adamw_init(params), xb0, yb0, cfg, opt_cfg)
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(got == paper_step[name],
              f"(a) {name}: one step launched {got}, expected "
              f"{paper_step[name]}")
        print(f"phase 9: (a) {name}: one training step at batch "
              f"{PAPER_BATCH} launched {got or 'no kernel of the port'}")
    _build.reset_launches()
    t1_res = T1.run(epochs=PAPER_EPOCHS, device=DEVICE, out_dir=paper_dir)
    torch.cuda.synchronize()
    want = {k: 0 for k in KERNEL_INFO}
    for name, cfg in PAPER_MODELS.items():
        for k, v in paper_step[name].items():
            want[k] += n_steps * v
        if cfg.kind == "kan":                 # the test split, no grad
            want["kan_fused_v2"] += cfg.n_layers
    count_launches("(a) Table I", want)
    for name, cfg in PAPER_MODELS.items():
        m = t1_res[name]
        losses = torch.tensor(m["losses"])
        check(len(m["losses"]) == n_steps
              and bool(torch.isfinite(losses).all())
              and all(np.isfinite(m[k]) for k in ("mse", "rse", "mae")),
              f"(a) {name}: a loss or metric is not finite, or "
              f"{len(m['losses'])} steps ran, not {n_steps}")
        params_b, m_b = T1.train_model(cfg, traffic, PAPER_EPOCHS, 0,
                                       device=DEVICE)
        _, params_a = T1.load_trained(name, paper_dir)
        same = m_b["losses"] == m["losses"] and all(
            torch.equal(a_[k], b_[k].cpu()) for a_, b_ in zip(params_a,
                                                              params_b)
            for k in a_)
        check(same, f"(a) {name}: two runs of {n_steps} steps differ")
        cpu_p = T1.to_device(paper_inits[name], torch.device("cpu"))
        cpu_state, cpu_losses = adamw_init(cpu_p), []
        for i, (xb, yb) in enumerate(traffic_batches(
                traffic["train_x"], traffic["train_y"], PAPER_BATCH, seed=0)):
            if i == CPU_STEPS:
                break
            cpu_p, cpu_state, loss = T1.train_step(
                cpu_p, cpu_state, torch.from_numpy(xb), torch.from_numpy(yb),
                cfg, opt_cfg)
            cpu_losses.append(float(loss))
        cpu_losses = np.array(cpu_losses)
        rel = float(np.max(np.abs(np.array(m["losses"][:CPU_STEPS])
                                  - cpu_losses) / np.abs(cpu_losses)))
        check(rel <= TRAIN_LOSS_TOL,
              f"(a) {name}: the first {CPU_STEPS} losses differ from the "
              f"CPU run's by {rel:.3e} relative (> {TRAIN_LOSS_TOL:g})")
        rec = {k: m[k] for k in ("mse", "rse", "mae", "params", "nnz_rates",
                                 "us_per_step", "train_s")}
        rec.update({"first_losses_card": m["losses"][:CPU_STEPS],
                    "first_losses_cpu": cpu_losses.tolist(),
                    "loss_rel_err_vs_cpu": rel,
                    "step_launches": paper_step[name]})
        if cfg.kind == "kan":
            # device time of one step's kernels at batch 512 (graph)
            calls = step_kernels(cfg.spec, kan_inputs(
                cfg, T1.to_device(paper_inits[name], dev), xb0))
            for c in calls:
                c()
            rec["step_kernels_device_ms"] = graph_ms(
                lambda: [c() for c in calls])
        paper["table1"][name] = rec
        print(f"phase 9: (a) {name}: {n_steps} steps, test MSE "
              f"{m['mse']:.4e} RSE {m['rse']:.4f} MAE {m['mae']:.4e}, "
              f"{m['params']} params, nnz {m['nnz_rates']}; two runs "
              f"bitwise equal; first {CPU_STEPS} losses within {rel:.3e} "
              f"relative of the CPU run's; host {m['us_per_step'] / 1e3:.4f}"
              f" ms a step"
              + (f", its kernels {rec['step_kernels_device_ms']:.4f} ms on "
                 f"the device" if cfg.kind == "kan" else "")
              + f" ({card})")
    k3, m4 = t1_res["kan-3layer"], t1_res["mlp-4layer"]
    paper["table1_headline"] = {"params_ratio": k3["params"] / m4["params"],
                                "mse_ratio": k3["mse"] / m4["mse"],
                                "paper_params_ratio": 0.30,
                                "paper_mse_ratio": 0.74}
    print(f"phase 9: (a) KAN-3 vs MLP-4: params "
          f"{k3['params'] / m4['params']:.2f}x (paper 0.30x), MSE ratio "
          f"{k3['mse'] / m4['mse']:.2f} (paper 0.74), "
          f"{PAPER_EPOCHS} epochs")

    # (b) KAN-3 at every Fig. 8 grid: the kernel forward and each leaf's
    # gradient against the plain versions at batch 512, times, the sweep
    for g in F8.GRIDS:
        cfg = dataclasses.replace(PAPER_MODELS["kan-3layer"], grid=g)
        spec = cfg.spec
        params = T1.to_device(T1.init_model(
            cfg, torch.Generator().manual_seed(0)), dev)
        pairs, fwd_err = kan_inputs(cfg, params, xb0), []
        with torch.no_grad():
            for i, (layer, h) in enumerate(pairs):
                err, scale, nan = rel_err(
                    layer(h), kan_fused_v2_ref(h, layer.wt, spec, layer.kb))
                check(not nan and err <= KERNEL_TOL * scale,
                      f"(b) G={g} layer {i}: kernel vs plain {err:.3e} > "
                      f"{KERNEL_TOL:g} * {scale:.4g}")
                fwd_err.append(err)
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in params]
        _build.reset_launches()
        pred, _ = T1.apply_model(leaves, xb0, cfg)
        loss = torch.mean(torch.square(pred - yb0))
        paths = leaf_paths(leaves)
        g_k = dict(zip((k for k, _ in paths), torch.autograd.grad(
            loss, [v for _, v in paths])))
        loss = loss.detach()
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(got == paper_step["kan-3layer"],
              f"(b) G={g}: a step launched {got}")
        loss_p, g_p = plain_grads(params, cfg, 2.0 * xb0 - 1.0, yb0)
        grad_err = {}
        for k in g_p:
            err, scale, nan = rel_err(g_k[k], g_p[k])
            check(not nan and err <= TRAIN_GRAD_TOL * (scale - 1.0),
                  f"(b) G={g} d{k}: {err:.3e} vs {TRAIN_GRAD_TOL:g} * "
                  f"max|plain| {scale - 1.0:.4g}")
            grad_err[k] = {"max_abs_err": err, "max_abs_plain": scale - 1.0}
        check(abs(float(loss) - float(loss_p)) <= TRAIN_GRAD_TOL
              * abs(float(loss_p)), f"(b) G={g}: loss {float(loss)} vs "
              f"plain {float(loss_p)}")
        # ms: host wall of a step (synchronised), device of its kernels
        state = adamw_init(params)
        step = [params, state]

        def one_step(cfg=cfg, step=step):
            step[0], step[1], loss = T1.train_step(step[0], step[1], xb0,
                                                   yb0, cfg, opt_cfg)
            return loss.item()
        calls = step_kernels(spec, pairs)
        for c in calls:
            c()
        rec = {"nbk": spec.n_bases, "forward_max_abs_err": fwd_err,
               "grad_err": grad_err,
               "host_ms_per_step": host_ms(one_step, iters=20),
               "step_kernels_device_ms": graph_ms(
                   lambda: [c() for c in calls])}
        # the kernel alone at each layer: device ms, plain ms, bound
        layers_rec = []
        for i, (layer, h) in enumerate(pairs):
            with torch.no_grad():
                layers_rec.append({
                    "shape": f"{h.shape[0]}x{cfg.sizes[i]}->"
                             f"{cfg.sizes[i + 1]} nbk={spec.n_bases}",
                    "blocks": kan_blocks(h.shape[0], cfg.sizes[i],
                                         cfg.sizes[i + 1], spec.n_bases, F32,
                                         device=dev),
                    "device_ms": graph_ms(lambda layer=layer, h=h: layer(h)),
                    "plain_ms": time_ms(lambda layer=layer, h=h:
                                        kan_fused_v2_ref(h, layer.wt, spec,
                                                         layer.kb), iters=20),
                    **bound(kan_bytes(layer, h, 4.0),
                            kan_work(layer, h, F32_FLOPS_PER_S, 4)),
                    "card": card})
        rec["kan_fused_v2"] = layers_rec
        paper["fig8"][str(g)] = rec
        print(f"phase 9: (b) KAN-3 G={g} (nbk {spec.n_bases}) batch "
              f"{PAPER_BATCH}: kernel vs plain {max(fwd_err):.3e}; a step "
              f"launched {got}; each leaf's gradient within "
              f"{TRAIN_GRAD_TOL:g}*max|plain| (" + ", ".join(
                  f"d{k} {e['max_abs_err']:.2e}/{e['max_abs_plain']:.2e}"
                  for k, e in grad_err.items())
              + f"); host {rec['host_ms_per_step']:.4f} ms a step, its "
              f"kernels {rec['step_kernels_device_ms']:.4f} ms on the "
              f"device; kan_fused_v2 device / plain / bound ms " + ", ".join(
                  f"{r['shape']} {r['blocks']} {r['device_ms']:.4f} / "
                  f"{r['plain_ms']:.4f} / {r['bound_ms']:.6f} "
                  f"({r['bound_by']})" for r in layers_rec)
              + f" ({card})")
    _build.reset_launches()
    f8 = F8.run(FIG8_EPOCHS, device=DEVICE, out_dir=paper_dir)
    torch.cuda.synchronize()
    count_launches("(b) Fig. 8 sweep", {
        "kan_fused_v2": len(F8.GRIDS) * (
            FIG8_EPOCHS * (traffic["train_x"].shape[0] // PAPER_BATCH) * 2
            + 2),
        "spline_basis": len(F8.GRIDS) * FIG8_EPOCHS
        * (traffic["train_x"].shape[0] // PAPER_BATCH) * 3})
    # its hardware half is the cycle model's, computed on the host from G
    # alone; tests/test_torch_paper_fig8.py holds it against the reference
    for g in F8.GRIDS:
        row = f8[str(g)]
        check(np.isfinite(row["mse"]),
              f"(b) Fig. 8 G={g}: the MSE trained on the card is {row['mse']}")
        paper["fig8"][str(g)]["sweep"] = row
    paper["fig8"]["_summary"] = f8["_summary"]
    paper["fig8"]["epochs"] = FIG8_EPOCHS

    # (c) Table II (masked fine-tune, bf16-cast evaluation) and Figs. 6-7
    # from the card's Table I; their cycle-model and EdgeGPU fields are
    # model outputs computed on the host from the card's nnz rates, held
    # against the reference's by tests/test_torch_paper.py.  The launches
    # show Table I was read, not trained again.
    _build.reset_launches()
    t2 = T2.run(PAPER_EPOCHS, device=DEVICE, out_dir=paper_dir)
    f6 = F6.run(PAPER_EPOCHS, device=DEVICE, out_dir=paper_dir)
    f7 = F7.run(PAPER_EPOCHS, device=DEVICE, out_dir=paper_dir)
    torch.cuda.synchronize()
    ft_epochs = inspect.signature(
        T2._masked_quantized_eval).parameters["ft_epochs"].default
    ft_steps = ft_epochs * (traffic["train_x"].shape[0] // PAPER_BATCH)
    count_launches("(c) Table II", {"kan_fused_v2": ft_steps + 1,
                                    "spline_basis": ft_steps})
    for name, row in t2.items():
        check(np.isfinite(row["mse"]),
              f"(c) Table II {name}: the fine-tuned MSE is {row['mse']}")
    k2, m3 = t2["kan-2layer"], t2["mlp-3layer"]
    paper.update({"table2": t2, "fig6": f6, "fig7": f7})
    print(f"phase 9: (c) Table II (cycle-model and EdgeGPU columns are model "
          f"outputs; MSE measured on the card): KAN-2 {k2['latency_us']:.2f} "
          f"us, {k2['speedup_vs_gpu']:.2f}x / "
          f"{k2['energy_ratio_vs_gpu']:.2f}x vs the edge GPU (paper 1.25x / "
          f"4.87x), MSE {k2['mse']:.4e} ({k2['mse_delta_pct']:+.1f}%); "
          f"MLP-3 {m3['latency_us']:.2f} us, {m3['speedup_vs_gpu']:.2f}x / "
          f"{m3['energy_ratio_vs_gpu']:.2f}x (paper 0.72x / 2.20x), MSE "
          f"{m3['mse']:.4e} ({m3['mse_delta_pct']:+.1f}%); KAN replaces MLP: "
          f"{(1 - k2['latency_us'] / m3['latency_us']) * 100:.0f}% latency "
          f"reduction (paper 22%); Fig. 6 avg zero-skip "
          f"{f6['_summary']['avg_zero_skip']:.2f}x (paper 1.30x), max with "
          f"SPU {f6['_summary']['max_spu_as_pe']:.2f}x (paper 2.17x); Fig. 7 "
          f"KAN-2 max {f7['_summary']['kan2_max']:.2f}x (paper 2.50x); "
          f"{ft_steps} masked fine-tune updates of each model")
    paper["launches"] = paper_launches
    torch.use_deterministic_algorithms(det_before[0],
                                       warn_only=det_before[1])
    torch_det.fill_uninitialized_memory = det_before[2]

    # ---------------------------------------------------------------- 10
    # KAN-FFN transformer serving at full width (``kanffn_phase``)
    kanffn = kanffn_phase(dev, card)

    # ---------------------------------------------------------------- 11
    # MoE, RG-LRU and xLSTM serving at full width (``moe_rec_phase``)
    moe_rec = moe_rec_phase(dev, card)

    # ---------------------------------------------------------------- 12
    # encoder-decoder and prefix-VLM archs at full width
    # (``encdec_vlm_phase``)
    encdec = encdec_vlm_phase(dev, card)

    # ---------------------------------------------------------------- 13
    # LM training at full width (``lm_train_phase``)
    lm = lm_train_phase(dev, card)

    # ---------------------------------------------------------------- 14
    # the VIKIN array plans (``array_phase``)
    array = array_phase(dev, card, hold)

    # ---------------------------------------------------------------- 15
    # training and serving on a process mesh (``mesh_phase``)
    mesh = mesh_phase(dev, card)

    # ---------------------------------------------------------------- 16
    # the dry run held against the card (``dryrun_phase``)
    dry = dryrun_phase(dev, card, mesh)

    launched = {k: (served[p]["launches"][k], f"phase 3, {p} burst")
                for p in PRECISIONS for k in SERVED_KERNELS[p]}
    launched["kan_fused_v1_bf16"] = (b_v1_launches["kan_fused_v1_bf16"],
                                     "phase 5, bf16 v1 path")
    launched[MIXED] = (lm["launches_b"][MIXED], "phase 13 (b), LM training")
    launched["spline_basis_bf16"] = (bench_launches["spline_basis_bf16"],
                                     "phase 6, kernel bench")
    launched["kan_fused_v1"] = (v1_launches["kan_fused_v1"],
                                "phase 5, v1 path")
    launched["spline_basis"] = (bench_launches["spline_basis"],
                                "phase 6, kernel bench")
    kernels = []
    for k, info in KERNEL_INFO.items():
        rec = records[(k, 8)]
        kernels.append({
            "name": k, "dtype": DTYPE[k], "route": "cuda",
            "source": info["source"],
            "headers": info.get("headers", []),
            "replaces": info["replaces"], "launches": launched[k][0],
            "launches_phase": launched[k][1],
            "launches_openloop": open_launches[k],
            "launches_train": train_launches[k],
            "launches_paper": paper_launches[k],
            "launches_kanffn": kanffn["launches"][k],
            "launches_moe": moe_rec["launches"].get(k, 0),
            "launches_encdec": encdec["launches"].get(k, 0),
            "launches_lm_train": lm["launches"].get(k, 0),
            "launches_array": array["launches"].get(k, 0),
            "launches_mesh": mesh["launches"].get(k, 0),
            "launches_tp_serve": mesh["launches_tp_serve"].get(k, 0),
            "max_abs_err": max_err[k], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    summary = {"kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": kernels,
         "records": [records[key] for key in sorted(records)],
         "breakdown": breakdown,
         "serve": {p: {"wall_s": sv["wall_s"], "wall_rps": sv["wall_rps"],
                       "stats": dict(sv["eng"].stats)}
                   for p, sv in served.items()},
         "v1_path": {"launches": v1_launches, "max_abs_err": v1_err},
         "v1_path_bf16": {"launches": b_v1_launches,
                          "max_abs_err": b_v1_err},
         "openloop": {"payload_us": payload_us, "replays": openloop},
         "train": train,
         "paper": paper,
         "kanffn": kanffn,
         "moe_rec": moe_rec,
         "encdec": encdec,
         "lm_train": lm,
         "array": array,
         "mesh": mesh,
         "dryrun": dry,
         "ptxas": usage,
         "knob_checks": knob_checks,
         "kernel_bench_launches": bench_launches},
        indent=1, default=str))
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(_mesh_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(_dryrun_worker(sys.argv[2:]))
    sys.exit(main())
