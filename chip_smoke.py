#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which raises (exit code 1) on failure:

1. environment: the card's name and power limit, torch/Triton versions,
   TF32 off;
2. build: the CUDA C++ kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
   and their ``-Xptxas -v`` resource lines; the tensor-core kernels (B5
   bf16, B6's up and down kernels) and B6's rows kernels must not spill;
3. every kernel against its plain torch version on the card, at the shapes
   of the main path, in fp32 and fp64, with its time, the plain version's
   time, one library call's time as a yardstick and its bytes bound:
   B1 (generated Triton stream passes: cg's Ap/pAp and r/rs passes at
   n=4096; in its deferred-finalize mode the same passes at one shard of
   the K=4 mesh, 1024 of 4096 rows with ``p`` gathered whole, bitwise
   against the ordinary pass, beside ``mv`` + ``dot`` on the block), B2 (CSR SpMV, 5-point Laplacian, n=2^20), B3 (tile-staged
   CSR SpMV whose prefix tiles' copies carry an L2 evict_last hint,
   bitwise, on the overbooked path's operand: banded n=131072, bandwidth
   16, the 40 MiB plan's prefix; beside it B3 with no hint (prefix 0), B2
   and cuSPARSE on the same operand, B3 and B2 with the L2 flushed before
   each call, and with the persisting-L2 set-aside raised toward the
   prefix's bytes, then restored; then B3 bitwise against its plain
   version and B2 on the 5-point Laplacian, a random pattern and a skewed
   one whose longest rows exceed a staged window, with prefixes of none,
   part and all rows), B4 (periodic stencil, 4096x4096, timed; bitwise
   also without f, at odd and tiny grids and with an operand not 16-byte
   aligned); off the main path, B1's ``ab,bc->ac`` passes of an FFN phase
   against the reference, also at tiles and a K of 384 columns (walked in
   chunks of 256), and there in fp32 B1's three forms against the plain
   version;
   then B5 (flash attention), B6 (fused MLP) and B7 (RMSNorm) at the LLM
   path's shapes (granite-3-8b: d 4096, 32 heads over 8 kv heads of 128,
   d_ff 12800; 1024 prefill rows and 4 decode rows, in fp32 and bf16;
   phase 11's training step, batch 4 x 1024, 4096 rows, in bf16),
   and a TF32 control that B6's fp32 limit must reject (B5 in bf16 runs
   bf16 ``mma.sync`` with P split in two bf16 halves, B6 from 17 rows up
   3xTF32 ``mma.sync``: each record names its arithmetic, gives its
   achieved TFLOP/s and bounds it at the tensor cores' rate, the fp32
   CUDA-core bound beside it); B5 at
   recurrentgemma-2b's prefill (S 4096, 10 heads over 1 kv head of 256,
   causal, window 2048) and B6 at the recurrent paths' prefill shapes
   (gated tanh-gelu M 4096, D 2560, F 7680; relu² M 1024, D 4096, F
   14336); B5, B6 and B7 at phase 9's shapes (B5: hubert-xlarge's
   bidirectional 16 heads of E 80, also on NaN-padded operands into a
   sentinel-padded output; llama-3.2-vision-11b's cross-attention of 1024
   queries over 6404 image keys and its causal self-attention; the MoE
   archs' causal GQA; B6: hubert's ungated gelu, D 1280, F 5120, and the
   vlm's gated silu, D 4096, F 14336, at 1024 and 4 rows; B7 at d 1024,
   1280, 2048, 2560 and 3072 (``B7_WIDTHS``): each case also bitwise from
   call to call, its time with the L2 warm and, from 1024 rows, emptied
   (the share of its bound taken on the latter), at 4 rows an empty
   kernel's time beside it; the same rows bitwise at
   1, 4, 1024 and 4096 rows; the general path on a view that is not
   16-byte aligned (bitwise the aligned call), at d 1001, and past one
   CTA's registers, walked in chunks, at d 12288 fp32 and 20480 bf16
   (16-byte vectors, 4 and 1024 rows, an unaligned view's scalars
   bitwise) and d 16390 bf16 (scalars), ``B7_GENERAL``); B5 and B6 at
   the shapes of the dense archs that phase 5 serves (B5: gemma-7b's 16
   heads of E 256 at 1x1024 and h2o-danube-1.8b's 32 over 8 heads of E 80
   with its 4096 window at 1x8192, SDPA with a band mask beside it; B6: gemma-7b's gated
   gelu, D 3072, F 24576, and minitron-8b's ungated relu², D 4096, F
   16384, at 1024 and 4 rows); B8 (RG-LRU scan, recurrentgemma-2b: B 1,
   S 4096, D 2560, also phase 11's hybrid training batch) and B9
   (WKV6, rwkv6-7b: B 1, H 64, S 1024, E 64, on the model's strided
   layout; also at phase 11's batch 4), in bf16 and fp32, each with and without an initial state (B8
   also with long memory, Λ over [-12, -7], and at sequences that are no
   multiple of its chunk or below one, each call's CUDA launches counted
   by the profiler and a second call repeating bitwise; B9 also with
   strong decays, w over [-8, 3]);
4. the HPC path, ``Session(device="cuda") -> trace -> analyze -> codesign
   -> lower(backend="cuda") -> run()`` on every workload (``HPC_PATHS``):
   cg(n=4096, iters=64), cg_sparse(n=2^20, iters=64, laplacian5) in fp32
   and fp64, and jacobi2d(n=4096, sweeps=8); then, in fp32 and fp64,
   bicgstab(n=4096, iters=16), gmres(n=4096, restart=6),
   power_iteration(n=4096, iters=64), mttkrp(256^3, rank 64; two torch
   einsums, no kernel of ours), bicgstab_sparse(n=2^20, iters=8,
   laplacian5) and (n=131072, iters=16, random, density 1e-3) (deeper
   gmres and Laplacian bicgstab part any two summation orders by more
   than the limits: ``GMRES_RESTART``); then the overbooked cells,
   ``Session(device="cuda", capacity_bytes=40 << 20)`` with
   cg_sparse(n=131072, iters=64) and jacobi_sparse(n=131072, sweeps=64)
   on a banded operand (bandwidth 16), codesigned with ``overbook=0.25``
   (a prefix pin of 0.80 of the rows: B3, 65 and 64 launches per run())
   and with ``overbook=0`` (the operand streams: B2), in fp32 and fp64;
   then each overbooked plan batched (``plan.batched(backend="cuda")
   .run_many`` of 16 requests: B3's lane form; its overbook-0 twin on B2's),
   every lane bitwise equal to its unbatched run(), one graph replay a
   batch, timed beside 16 sequential run() and the twin's batch.
   Each is held against the port's
   ``reference`` backend on the card and against numpy by its witness
   (``Witness``: the relative residual of the returned x; power
   iteration's lam against the Rayleigh quotient of its x; gmres's
   ‖v_m‖ = 1; mttkrp against ``numpy.einsum`` in fp64; or a numpy replay
   of the sweeps); each Krylov path and mttkrp
   also holds its limits against a control, the reference computed with
   its products' operands cut to TF32 (fp32) or fp32 (fp64), which the
   limits must reject; the launch counts of B1, B2, B3, B4 and B3's lane
   form over these runs must be > 0.  Every path's run() is
   one CUDA-graph replay (``check_dispatch``): bitwise equal to the eager
   walk that its graph captured, at its own feeds and at a second set, run
   1's outputs unchanged by run 2, one capture per float dtype,
   ``dispatches == runs``, launches per run as the eager walk made them, and a
   profiled warm run() with one graph launch and no kernel launch.  The
   warm, synchronized wall time per ``run()``, per eager walk and per
   ``cuda-perunit`` run, and ``cuda-perunit``'s run as one CUDA graph, are
   printed (the overbooked cells' graphs also with the set-aside raised).
   Then cg and jacobi2d run at once on two threads
   (``check_two_threads``): each program's ``stats`` must count its own
   runs, dispatches and launches only;
5. the dense archs' serving paths at full width and depth, one model at
   a time, ``Session("granite-3-8b",
   device="cuda").trace("prefill", batch=1, seq=1024) -> analyze ->
   codesign -> lower() -> serve()``, random fp32 weights from seed 0
   (40 layers, 8.37 B parameters, ~34 GB of card memory), then gemma-7b
   (28 layers), minitron-8b (32) and h2o-danube-1.8b (24; a 1x8192
   prefill, twice its window): one prefill of a
   1x1024 prompt (B5, B6, B7) and ``generate`` of 4 prompts x 16 tokens +
   32 new tokens (decode: B6 at 4 rows, B7), the same again with every
   kernel entry point swapped for its plain version, and the agreements
   of ``LLM_TOL`` and ``DECODE_TOL`` (rwkv6-7b: ``RWKV_TOL``) with the
   controls they must reject; launches per prefill and per decode step,
   prefill and decode times.  ``generate`` decodes through the bundle's
   graphed step (``ServeBundle.jit_decode``): one CUDA-graph replay a
   step, one capture over three ``generate`` calls, tokens equal to the
   eager run's, each graphed step bitwise equal to the eager donating step
   (``check_decode_graph``), ms per step and tokens/s beside the eager
   step's;
6. the same for the recurrent families, one model at a time (each freed
   before the next loads): recurrentgemma-2b (26 layers of
   ``[rglru, rglru, attn]``, d 2560, ~3.4 B parameters), planned on
   ``trace("prefill", batch=1, seq=4096, layer_kind="attn")``, a 1x4096
   prefill (B5 8, B6 26, B7 53, B8 18 launches); rwkv6-7b (its depth
   cut to ``SSM_LAYERS`` = 16 of its 32 rwkv layers, d 4096, ~3.7 B
   parameters), planned on ``trace("prefill", batch=1, seq=1024)``, a
   1x1024 prefill (B6 16, B7 33, B9 16); decode
   steps launch B6 and B7 as the prefill does, and B5, B8, B9 never.
   rwkv6-7b, held to the wider ``RWKV_TOL``, also brings a second witness
   (``serve_witness``): at a second prompt seed, its kernel run against
   its plain run in bf16 and with fp32 activations, the latter within
   ``FP32_WITNESS_TOL``;
7. solver serving: ``Server(PlanRouter(Session(device="cuda")),
   ServeConfig(max_batch_size=16, max_wait_us=2000))`` with
   ``backend="cuda"`` on cg(n=4096, iters=32) fp32, cg_sparse(n=2^20,
   iters=64, laplacian5) fp32 and fp64 and, at ``max_batch_size=4``,
   jacobi2d(n=4096, sweeps=8) fp32 (``SERVE_BUCKETS``): a burst of 32
   requests (seeds 0-31) and one of 5 to paused servers; every lane held
   against its request's unbatched ``run()`` (bitwise, or within
   ``SERVE_TOL`` with the record saying which held) and against numpy
   (the residual of its x, or a replay of the sweeps); one graph replay a
   batch (``dispatches == batches``, one capture per padded lane count,
   a profiled warm batch with one graph launch and no kernel launch) and
   the lane kernels' launches while serving > 0; 32 sequential
   ``run()`` calls against the same 32 served (requests/s, p50/p99, the
   worker's own clock), a warm batch's time from numpy feeds and from
   feeds on the card beside its device busy time; the fallback under
   ``serve.dispatch@cuda=fail`` (the reference on the card, within
   ``PATH_TOL`` of the cuda lanes, the breaker open); then B1, B2, B3 and
   B4's lane forms at 16 lanes on phase 3's operands (B3's: the
   overbooked operand with its plan's prefix) against their plain
   versions and, lane by lane, bitwise against the single-request
   kernels (B1's and B2's also at 1, 5 and 17 lanes, ``LANE_COUNTS``),
   timed beside their bytes bounds and a library yardstick
   (``A @ X`` plus column dots, ``torch.sparse.mm``, batched ``conv2d``);
   last, a write to the cg bucket's operator shows in the next replay,
   bound to the router's plan and copied by an unbound one;
8. the device mesh, ``Session(device="cuda") -> trace -> codesign ->
   lower(mesh=4, backend="cuda") -> run()``: four device slots on the one
   card (``launch.mesh``), each shard's stream passes on B2 and B1's
   deferred-finalize mode, the reductions summed over the shards in shard
   order: cg(n=4096, iters=64) fp32, cg_sparse(n=2^20, iters=64,
   laplacian5) fp32 and fp64, jacobi2d(n=4096, sweeps=8) fp32 (halo rows;
   torch ops, no B4, as the JAX package's sharded plans), and the
   crossover cell, cg under a 32 MiB buffer a slot, where ``A`` streams
   at K=1 and pins at K=4.  Each held to phase 4's limits against the
   port's ``ShardedReference`` on the card and against numpy, one graph
   replay a run (``check_dispatch``), timed beside its eager walk and the
   unsharded plan's run(); cg at K=1 bitwise equal to the unsharded
   run();
9. the MoE, audio and vlm families' serving paths (``FAMILY_PATHS``), as
   phase 5 drives granite-3-8b, one model at a time: granite-moe-1b-a400m
   (24 layers, 32 experts, top-8, ~1.4 B parameters), moonshot-v1-16b-a3b
   at full width (64 experts, top-6, d 2048) with its depth cut to
   ``MOE_WIDE_LAYERS`` of 48 layers (its 27 B fp32 parameters would not
   fit the card), hubert-xlarge (48 layers, ~0.94 B; a 1x1024 prefill of
   stubbed frames of width 1280 to CTC logits over 504, no decode) and
   llama-3.2-vision-11b (40 layers, ~9.8 B; a stubbed 1x6404x4096 image
   that its 8 cross-attention layers attend to).  Each prefill and
   ``generate`` against the plain versions within ``LLM_TOL`` /
   ``DECODE_TOL`` with their shifted controls (an MoE prefill with the
   plain run's routes replayed, ``moe_witness``: its own routes part from
   the plain run's at near ties), launches per prefill and decode step as
   ``FAMILY_PATHS`` lists them (an MoE layer runs no B6); the MoE paths
   print the share of (token, k) pairs their prefill dropped at capacity;
10. the codesign disk cache: a cold and then a fresh ``Session(device=
   "cuda", cache_dir=d)`` codesign cg(n=4096, iters=64); the second
   replays the first's search (``from_cache``), its plan equals the
   first's field for field and its run() is bitwise the first's; both
   ``codesign()`` times are printed;
11. training, ``Session(arch, device="cuda").default_plan(seq=S)
   .train(...)`` for each of ``TRAIN_PATHS``: granite-3-8b at
   ``TRAIN_LAYERS`` = 8 of 40 layers, granite-moe-1b-a400m whole,
   recurrentgemma-2b at 6 of 26 (1 x 4096), rwkv6-7b at 4 of 32,
   hubert-xlarge at 12 of 48 (stubbed frames) and llama-3.2-vision-11b at
   5 of 40 (one ``xattn`` layer, a stubbed 4 x 6404 image), full width
   (fp32 weights, gradients and two moments are 16 B a parameter: 134 GB
   for granite-3-8b's 40 layers), random weights from seed 0, batches of
   4 x 1024 from ``SyntheticLMData``, the plan's remat policy and AdamW;
   the forward on B5-B9 through ``models.autograd``, the backward through
   their plain forms.  One step's gradients: every leaf finite and not
   zero; loss and every leaf within ``max(TRAIN_MIN_TOL, 2 x spread)`` of
   the same step on the plain forms (``plain_forms``; an MoE arch's runs
   on the plain run's routes), the spread that of the plain forms against
   the flags-off plan (an arch without attention: against the same
   function rounded elsewhere, ``other_roundings``); with remat
   bitwise those without (or, if two identical runs differ, within twice
   their spread); launches per step as ``train_launches`` predicts
   (granite-3-8b with remat: B5 16, B6 16, B7 33; without: 8, 8, 17).
   Then the median warm step of the kernel and the plain-forms train
   step (fwd, bwd, donated AdamW), taken in turns, with tokens/s, the
   memory held after the forward (less with remat) and the peak of a step
   with remat on and off, and three
   ``CompiledPlan.train`` steps (the counted main path) with finite
   losses;
12. the LLM mesh (``drive_llm_mesh``): granite-3-8b at ``TRAIN_LAYERS``
   of 40 layers, full width, on ``make_local_mesh(2, 2)``, four slots on
   the card (B5 on 16 of 32 query heads and 4 of 8 kv heads a slot, B6 on
   6400 of 12800 hidden columns, B7 on every slot): a 2 x 1024 prefill
   through ``models.sharded.forward``, ``generate`` of 4 x (16 + 32)
   through ``ServeBundle.jit_decode(mesh, 4, 48)`` (one replay a step),
   one training step's loss and gathered gradients against the unsharded
   step's, then three ``jit_train_step`` steps at 4 x 1024 with ZeRO-1,
   the plan's remat and donation; each held to the unsharded kernel run
   (``LLM_TOL``, ``DECODE_TOL``, ``max(TRAIN_MIN_TOL, 2 x spread)``) with
   the shifted controls rejected, the data replicas bitwise equal after
   each step, launches as ``mesh_launches`` predicts (slots x the
   unsharded pass's); per-slot parameter, moment and cache bytes held to
   the specs' count, each pass's time beside the unsharded one's, and the
   bytes each exchange kind moved.  Then granite-3-8b at the production
   TP (``drive_mesh_tp``): ``MESH_TP_LAYERS`` layers at full width on
   ``make_local_mesh(1, 16)``, where its 8 kv heads do not split 16
   ways, so attention is query-split (B5 on 2 query heads and the kv head
   they read a slot, the head's k / v columns all-gathered from the 2
   slots that hold them), the ``generate`` cache of 4 x 48 entries is
   sequence-sharded (each slot attends its 3 entries, the slots combine
   the softmax by a max, a sum and a psum of the context, and only the
   slot that holds the ring position writes the entry), and the loss is
   vocab-parallel (no logits gathered): a 1 x 1024 prefill, ``generate``
   of 4 x (16 + 32) and one training step's loss and gradients, each
   against the unsharded run as above, each pass's exchanges by kind
   equal to ``query_split_exchanges``' count from the shapes.  Then one
   short check a family (``MESH_FAMILIES``, ``drive_mesh_family``):
   granite-moe (routes replayed), recurrentgemma (B8; its attention
   query-split at TP 2, its decode cache sequence-sharded), rwkv6 (B9),
   hubert (prefill) and llama-vision (an ``xattn`` layer), each sharded
   prefill and decode step against the unsharded one at the same depth.
   No speed is claimed: the slots share one card;
13. the dry run (``launch/dryrun.py``): (a) granite-3-8b's decode_32k and
   prefill_32k cells on the 16 x 16 meta mesh at ``TRAIN_LAYERS`` of 40
   layers, walked by child processes that see no card (started with the
   run), the kernels' calls as ``mesh_launches`` predicts for 256 slots,
   the roofline terms on the H100 data-sheet peaks and the peak estimate
   against 80 GB printed; (b) phase 12's three steps (prefill, decode
   step, ZeRO-1 train step on ``make_local_mesh(2, 2)``) walked on meta
   and eagerly on the card under one ``CostCounter``: contraction flops,
   every kernel's work, the exchanges by kind and the argument bytes
   equal, the card's launches the kernels' calls, the card's memory
   within ``MEMORY_BAND`` of the meta estimate, each step's time beside
   its bound on one card.

Each phase's header, every kernel record and every path record carry the
card's name and power limit as ``nvidia-smi`` gives them.  The last two
lines are the kernel table and the device summary as JSON; the line before
them is ``nvidia-smi``'s name and power limit.  Without CUDA the
script exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import threading
import time
import typing
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.roofline import H100  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, ``launch/roofline.py``'s ``H100``
#: row): HBM3 bandwidth, the non-tensor fp32 / fp64 rates and the dense
#: tensor-core rates (bf16, TF32)
PEAK_BYTES_S = H100.hbm_bw
PEAK_FLOPS = dict(H100.flops)
#: timed run() calls per main path
RUN_REPS = 10
#: the overbooked cells: a banded operand whose CSR triple (35.1 MB in
#: fp32, 52.4 MB in fp64) overflows the 40 MiB buffer's explicit region,
#: so that overbook=0.25 pins a row prefix of it
OB_N, OB_BANDWIDTH, OB_CAPACITY, OB_SWEEPS = 131072, 16, 40 << 20, 64
#: cg_sparse iterations per dtype: the operand is well conditioned, so the
#: recursive residual's rs falls ~1e-9 every 10 iterations and leaves
#: fp32's range near iteration 55 (rs = 0, then beta = 0/0 = NaN, in the
#: reference as in the kernels); fp32 stops at 32 (rs ~ 1e-25)
OB_CG_ITERS = {"float32": 32, "float64": 64}

#: kernel launches per run() of the main paths as counted while run()
#: launched each from the host; a run() now replays them in one CUDA graph
EAGER_LAUNCHES = {
    ("cg(n=4096, iters=64)", "float32"): {"stream": 193,
                                          "stream_finalize": 129},
    ("cg_sparse(n=1048576, iters=64, laplacian5)", "float32"): {
        "stream": 193, "stream_finalize": 128, "spmv": 65},
    ("cg_sparse(n=1048576, iters=64, laplacian5)", "float64"): {
        "stream": 193, "stream_finalize": 128, "spmv": 65},
    ("jacobi2d(n=4096, sweeps=8)", "float32"): {"stencil2d": 8},
}
#: the mesh paths (phase 8): K device slots, all on the one card
MESH_K = 4
#: cg's buffer for the crossover cell: ``A`` (64 MiB in fp32) does not fit
#: one slot's explicit region at 32 MiB and pins at K=4 (128 MiB in all),
#: TABLE 11's crossover
CROSSOVER_CAPACITY = 32 << 20
#: host API calls that launch one kernel, as ``torch.profiler`` names them:
#: ``cudaLaunchKernel*`` (the CUDA C++ kernels), ``cuLaunchKernel*`` (Triton)
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")

#: libcuda enums (cuda.h) for the L2 set-aside of persisting accesses
CU_LIMIT_PERSISTING_L2_CACHE_SIZE = 0x06
CU_DEVICE_ATTRIBUTE_L2_CACHE_SIZE = 38
CU_DEVICE_ATTRIBUTE_MAX_PERSISTING_L2_CACHE_SIZE = 108

#: kernel vs plain version, max |err| <= TOL * max |plain| (B4: bitwise):
#: B1 and B2 sum in another order than their plain versions (a tree over
#: row blocks; cuBLAS's mv and dot; index_add_'s atomics), so they agree up
#: to a few ulps of the sums' scale
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
#: main path vs the reference backend, max |err| <= TOL * scale, scale =
#: max(max |reference|, max |b|), for a solution x max |reference| alone
#: (``_rel_err``): 64 Krylov iterations carry the reduction
#: order's rounding from step to step.  Each Krylov path also runs a
#: control (``tolerance_control``) that these limits must reject.
PATH_TOL = {"float32": 1e-5, "float64": 1e-13}
#: |relative residual of the cuda backend's x - the reference's|
RESIDUAL_GAP = 1e-6
#: the LLM path, full width: granite-3-8b's prefill and decode shapes
LLM_ARCH = "granite-3-8b"
PREFILL_SEQ = 1024
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 16, 32
#: the recurrent families' serving paths: recurrentgemma-2b's prefill is
#: longer than its 2048-token attention window
HYBRID_ARCH, HYBRID_SEQ = "recurrentgemma-2b", 4096
SSM_ARCH, SSM_SEQ = "rwkv6-7b", 1024
#: rwkv6-7b's depth on its serving path: 16 of its 32 layers, every width
#: as published.  Phase 9's four archs took the whole run on one H100
#: from 341.7 s to 433.0 s, past the 90 s that they may add; the cut takes
#: ~8 s back
SSM_LAYERS = 16
#: serving path against its all-plain run on the card, max |Δ| <= TOL x
#: max |plain logits|: the kernels sum in other orders than cuBLAS and
#: torch's reductions, so single bf16 roundings flip in the residual stream
#: and the flips carry through 40 layers (2-5 bf16 ulps of the largest
#: logit); the plain logits one position later must fail it.  A near tie is
#: a top-2 gap of the plain run's logits <= NEAR_TIE x max |logit| at the
#: first token where the two runs part
LLM_TOL = 5e-2
NEAR_TIE = 2e-2
#: decode logits at the last prompt position against prefill logits there,
#: max |Δ| <= TOL x max |prefill logits|: the decode step also rounds its
#: attention probabilities to bf16 before the PV product (as the JAX
#: package's does), where B5 keeps them in fp32; the prefill logits one
#: position earlier must fail it
DECODE_TOL = 5e-2
#: rwkv6-7b's limit for both comparisons above.  Its random-weight
#: time-mix branch (y = r·S, with no norm after it, trilinear in the
#: layer's input and ~9x the MLP branch's output) carries one bf16
#: rounding flip further than attention does: on one H100, at all 32
#: layers, two plain-torch evaluations of the same function, its decode
#: steps and its prefill,
#: disagreed by 6.09e-2 of the largest logit, above ``LLM_TOL``, and the
#: kernel run by 6.19e-2 (prefill vs plain) and 6.46e-2 (decode vs
#: prefill).  Its shifted-position controls read ~1.3, 13x over this limit
RWKV_TOL = 1e-1
#: the second witness that a path held to more than ``LLM_TOL`` /
#: ``DECODE_TOL`` (rwkv6-7b) differs from its plain run by bf16 rounding
#: alone: the same model served with fp32 activations (every kernel of the
#: path takes fp32), prefill logits of the kernel run vs the plain run and
#: decode vs prefill, max |Δ| <= TOL x max |plain logits|.  With no bf16
#: rounding to flip, kernels that compute their plain versions' function
#: agree to fp32 rounding carried through the layers; the bf16 kernel
#: run's logits against the fp32 plain run's are its control and must
#: fail it.  Beside it, the bf16 readings at a second prompt seed
FP32_WITNESS_TOL = 1e-4
#: the dense archs served at full width beside granite-3-8b, at all their
#: layers: gemma-7b (MHA of E 256, gated gelu F 24576, vocab 256 000),
#: minitron-8b (GQA 32/8, ungated relu² F 16384, vocab 256 000) and
#: h2o-danube-1.8b, whose prefill of 8192 tokens is twice its 4096-token
#: window, so that the window bites (as recurrentgemma-2b's 4096 against
#: 2048)
GEMMA_ARCH, MINITRON_ARCH, DANUBE_ARCH = ("gemma-7b", "minitron-8b",
                                          "h2o-danube-1.8b")
DANUBE_SEQ = 8192


def dense_launches(layers):
    """A dense arch's launches per prefill: B5 and B6 once a layer, B7
    twice a layer and once for the final norm."""
    return {"flash_attention": layers, "fused_mlp": layers,
            "rmsnorm": 2 * layers + 1, "rglru": 0, "wkv6": 0}


#: the serving paths, in order: (arch, prefill length, the trace's
#: ``layer_kind``, launches per prefill, (LLM limit, decode limit),
#: layers (None: all)).  A
#: decode step launches B6 and B7 as often as a prefill and B5, B8 and B9
#: never.  recurrentgemma is planned on an attention layer's trace: its
#: default trace is an rglru layer, which has no scores/pv group, and
#: lowers to flash attention off
SERVE_PATHS = (
    (LLM_ARCH, PREFILL_SEQ, None, dense_launches(40),
     (LLM_TOL, DECODE_TOL), None),
    (GEMMA_ARCH, PREFILL_SEQ, None, dense_launches(28),
     (LLM_TOL, DECODE_TOL), None),
    (MINITRON_ARCH, PREFILL_SEQ, None, dense_launches(32),
     (LLM_TOL, DECODE_TOL), None),
    (DANUBE_ARCH, DANUBE_SEQ, None, dense_launches(24),
     (LLM_TOL, DECODE_TOL), None),
    (HYBRID_ARCH, HYBRID_SEQ, "attn", {"flash_attention": 8,
                                       "fused_mlp": 26, "rmsnorm": 53,
                                       "rglru": 18, "wkv6": 0},
     (LLM_TOL, DECODE_TOL), None),
    (SSM_ARCH, SSM_SEQ, None, {"flash_attention": 0,
                               "fused_mlp": SSM_LAYERS,
                               "rmsnorm": 2 * SSM_LAYERS + 1, "rglru": 0,
                               "wkv6": SSM_LAYERS},
     (RWKV_TOL, RWKV_TOL), SSM_LAYERS),
)
#: the MoE, audio and vlm families' serving paths (phase 9), full width
MOE_ARCH, MOE_WIDE_ARCH, AUDIO_ARCH, VLM_ARCH = (
    "granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "hubert-xlarge",
    "llama-3.2-vision-11b")
#: moonshot-v1-16b-a3b's depth cut: at its 48 layers its 27 B parameters
#: are ~110 GB in the port's fp32 ``PARAM_DTYPE``, more than the card
#: holds; 4 layers are ~3 B (~12 GB)
MOE_WIDE_LAYERS = 4
#: (arch, layers (None: all), stubbed input, decode check, launches per
#: prefill, (LLM limit, decode limit)).  An MoE layer runs no B6.  The
#: decode check holds a decode step's logits at the last prompt position
#: against the prefill's there ("prefill", as phases 5 and 6 do) or
#: against the same step on the plain versions ("plain"): the vlm's
#: decode attends no image (an ``xattn`` layer decodes on a ring cache of
#: its own, as in the JAX package), and an MoE prefill of the 4 x 16
#: prompt drops (token, k) pairs at capacity that a 4-token decode step
#: keeps, so neither decode computes its prefill's function.
#: hubert-xlarge is encoder-only: no decode.  An MoE path's prefill logits
#: are held to the LLM limit through ``moe_witness``: its kernel run with
#: the plain run's routes replayed.  Its own routes are data: one bf16
#: rounding flip at a near tie of the router's top-k moves a (token, k)
#: pair to another expert, and at capacity the slots and kept pairs of
#: every later token of both experts, so outputs change outright, not by
#: a rounding (granite-moe-1b-a400m's prefill drops 29% of its pairs on
#: random weights; on an H100 its free kernel run read 7.9e-2 of the
#: largest logit from the plain run, moonshot-v1-16b-a3b's 0.23)
FAMILY_PATHS = (
    (MOE_ARCH, None, None, "plain",
     {"flash_attention": 24, "fused_mlp": 0, "rmsnorm": 49, "rglru": 0,
      "wkv6": 0}, (LLM_TOL, DECODE_TOL)),
    (MOE_WIDE_ARCH, MOE_WIDE_LAYERS, None, "plain",
     {"flash_attention": MOE_WIDE_LAYERS, "fused_mlp": 0,
      "rmsnorm": 2 * MOE_WIDE_LAYERS + 1, "rglru": 0, "wkv6": 0},
     (LLM_TOL, DECODE_TOL)),
    (AUDIO_ARCH, None, "frames", None,
     {"flash_attention": 48, "fused_mlp": 48, "rmsnorm": 97, "rglru": 0,
      "wkv6": 0}, (LLM_TOL, DECODE_TOL)),
    (VLM_ARCH, None, "img", "plain",
     {"flash_attention": 40, "fused_mlp": 40, "rmsnorm": 81, "rglru": 0,
      "wkv6": 0}, (LLM_TOL, DECODE_TOL)),
)

#: phase 11, training: granite-3-8b at full width with its depth cut to
#: ``TRAIN_LAYERS`` of 40 (training holds 16 B a parameter, fp32 weights,
#: gradients and two moments: 134 GB at 40 layers, 32 GB at 8, beside the
#: comparison runs' gradients and the activations), batch 4 x 1024
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
#: ``CompiledPlan.train`` steps on the main path, and timed warm steps of
#: each of the kernel and the plain-forms train step (taken in turns; the
#: other families' paths take ``FAMILY_TIMED``)
TRAIN_LOOP_STEPS, TRAIN_TIMED, FAMILY_TIMED = 3, 3, 2
#: phase 11's paths: (arch, layers (None: all), batch, seq).  Every width
#: as published; the depth cut so that the 16 B a parameter of training
#: (fp32 weights, gradients, two moments) and the comparison runs'
#: gradients fit the card and the run its time: granite-moe-1b-a400m whole
#: (1.39 B parameters); recurrentgemma-2b 6 of 26 layers, two [rglru,
#: rglru, attn] periods, one sequence of 4096 so that the window of 2048
#: bites; rwkv6-7b 4 of 32; hubert-xlarge 12 of 48 on stubbed frames;
#: llama-3.2-vision-11b 5 of 40, its first ``xattn`` layer the fifth, on a
#: stubbed 4 x 6404 image
TRAIN_PATHS = (
    (LLM_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ),
    (MOE_ARCH, None, TRAIN_BATCH, TRAIN_SEQ),
    (HYBRID_ARCH, 6, 1, HYBRID_SEQ),
    (SSM_ARCH, 4, TRAIN_BATCH, TRAIN_SEQ),
    (AUDIO_ARCH, 12, TRAIN_BATCH, TRAIN_SEQ),
    (VLM_ARCH, 5, TRAIN_BATCH, TRAIN_SEQ),
)
#: the least relative tolerance of the training loss and of a gradient
#: leaf (2-norm), kernel path against the plain forms; the limit is
#: ``max(TRAIN_MIN_TOL, 2 x the spread)`` where the spread is that of two
#: plain evaluations of the same function in different rounding orders
#: (chunked attention against naive), as ``tests/test_torch_train.py``
#: sets it from the JAX package's two step forms
TRAIN_MIN_TOL = 1e-3


def log(msg: str = "") -> None:
    print(msg, flush=True)


#: ``nvidia-smi``'s name and power limit of the card, read again at the head
#: of every phase (``card_phase``) and written beside every number
CARD = ""


def card_phase(title: str) -> None:
    """A phase's header, with the card's name and power limit as they are
    now."""
    global CARD
    CARD = smi_line()
    log(f"== phase {title} [{CARD}]")


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per eager call over ``reps`` back-to-back calls, by
    CUDA events after a warm-up: the time a caller sees, host launch
    overhead included where it exceeds the device work."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _captured(fn, inner):
    """``inner`` calls of ``fn`` captured in one CUDA graph (after two
    warm-up calls off-graph, which compile), replayed once."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, inner: int = 10, reps: int = 5) -> float:
    """Device milliseconds per call: ``inner`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so host launch
    overhead drops out."""
    import torch
    graph = _captured(fn, inner)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def measure(kernel_fn, plain_fn, library_fn=None):
    """The kernel's device time (``ms``) and eager per-call time
    (``call_ms``), the plain version's and the library call's device
    times."""
    return dict(ms=graph_ms(kernel_fn), call_ms=cuda_ms(kernel_fn),
                plain_ms=graph_ms(plain_fn),
                library_ms=None if library_fn is None
                else graph_ms(library_fn))


def record(results, label, *, kernel, case, dtype, err, rel_err, tol,
           nbytes, flops, times, peak=None, arith=None, **extra):
    """``peak``: the type whose peak bounds the kernel, when it differs
    from the operands' (fp32 arithmetic on bf16 operands; "bfloat16" or
    "tf32" on the tensor cores, whose bound then has the fp32 CUDA-core
    bound beside it).  The bound counts the function's ``flops``, not
    what a design issues on top of them.  ``arith``: the arithmetic in
    words, kept as ``math``.  Every record gives its achieved TFLOP/s, the
    function's operations over its device time."""
    kind = peak or dtype
    b_ms, b_by = bound_ms(nbytes, flops, kind)
    if kind in ("bfloat16", "tf32"):
        extra["bound_ms_fp32_cuda_cores"] = bound_ms(nbytes, flops,
                                                     "float32")[0]
    if arith:
        extra["math"] = arith
    extra["tflops"] = flops / (times["ms"] * 1e9)
    results.append(dict(kernel=kernel, case=case, dtype=dtype, card=CARD,
                        max_abs_err=err, max_rel_err=rel_err, rel_tol=tol,
                        bound_ms=b_ms, bound_by=b_by,
                        bytes=nbytes, flops=flops, **times, **extra))
    lib = ("n/a" if times["library_ms"] is None
           else f"{times['library_ms']:.4f} ms")
    tol_s = tol if isinstance(tol, str) else f"{tol:g}"
    log(f"  {label} {dtype}: max|err| {err:.3e} (rel {rel_err:.3e}, tol "
        f"{tol_s})  kernel {times['ms']:.4f} ms"
        f" (eager call {times['call_ms']:.4f} ms)  plain "
        f"{times['plain_ms']:.4f} ms  library {lib}  bound {b_ms:.4f} ms "
        f"by {b_by} ({nbytes / 1e6:.2f} MB)  {extra['tflops']:.1f} TFLOP/s"
        + (f"  [{arith}]" if arith else ""))


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def bf16_excess(got, want, rel_tol) -> float:
    """max over elements of |got - want| / (1 bf16 ulp of the element +
    ``rel_tol`` x max |want|): at most 1 where the two agree to one bf16
    rounding of results that agree to ``rel_tol`` in fp32 (the term keeps
    outputs near zero, where an fp32 difference spans many bf16 ulps,
    from counting as misses)."""
    import torch
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    slack = ulp + rel_tol * float(w.abs().max())
    return float(((g - w).abs() / slack).max())


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: the kernels that must not spill (mangled names contain these): B5's
#: bf16 kernel, B6's tensor-core and rows kernels, each an up and a down
#: kernel, and every instantiation of B7's vector and general kernels (the
#: row held in registers)
NO_SPILL = ("flash_bf16_kernel", "mlp_tc_up_kernel", "mlp_tc_down_kernel",
            "mlp_rows_up_kernel", "mlp_rows_down_kernel", "rmsnorm_kernel",
            "rmsnorm_general_kernel")


def ptxas_usage(log_text, names):
    """{entry: {"registers": n, "spill_bytes": stores + loads}} from
    ``-Xptxas -v``, for every instantiation of the kernels ``names``."""
    import re
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1)
                                      for k in names) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            out.setdefault(entry, {})["spill_bytes"] = (int(m.group(1))
                                                        + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
            entry = None
    return out


#: the SASS opcodes counted in a Triton kernel: cross-thread shuffles,
#: barriers, shared-memory and spill (local) traffic beside the loads and
#: the arithmetic
SASS_OPS = ("SHFL", "BAR", "LDS", "STS", "LDL", "STL", "LDG", "STG",
            "FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA")


def triton_resources(jit_fn):
    """Registers, spilled registers and shared bytes of a Triton kernel
    launched at least once, and its SASS's instruction count by opcode
    (``SASS_OPS``); ``{"error": ...}`` when this Triton does not say."""
    import re
    try:
        for store in jit_fn.device_caches.values():
            for part in store:
                for ck in part.values() if isinstance(part, dict) else ():
                    if not hasattr(ck, "asm"):
                        continue
                    ck._init_handles()
                    ops = re.findall(r"^(?:[^\t\n]*\t|\s+/\*[0-9a-f]+\*/\s+)"
                                     r"(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                                     ck.asm["sass"], re.M)
                    return dict(n_regs=ck.n_regs, n_spills=ck.n_spills,
                                shared=ck.metadata.shared,
                                num_warps=ck.metadata.num_warps,
                                sass=len(ops),
                                **{op: ops.count(op) for op in SASS_OPS})
    except Exception as e:               # a Triton that keeps them elsewhere
        return {"error": f"{type(e).__name__}: {e}"}
    return {"error": "no compiled kernel in the JIT function's caches"}


def _cu(name, *args):
    """One libcuda call on the context torch made current."""
    import ctypes
    err = getattr(ctypes.CDLL("libcuda.so.1"), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: libcuda error {err}")


def l2_state():
    """The card's L2 size, the largest set-aside for persisting accesses it
    allows and the set-aside in force, in bytes."""
    import ctypes
    import torch
    dev, l2, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    now = ctypes.c_size_t()
    _cu("cuDeviceGet", ctypes.byref(dev), torch.cuda.current_device())
    _cu("cuDeviceGetAttribute", ctypes.byref(l2),
        CU_DEVICE_ATTRIBUTE_L2_CACHE_SIZE, dev)
    _cu("cuDeviceGetAttribute", ctypes.byref(most),
        CU_DEVICE_ATTRIBUTE_MAX_PERSISTING_L2_CACHE_SIZE, dev)
    _cu("cuCtxGetLimit", ctypes.byref(now), CU_LIMIT_PERSISTING_L2_CACHE_SIZE)
    assert l2.value == torch.cuda.get_device_properties(0).L2_cache_size, (
        l2.value, "libcuda's L2 size disagrees with torch's")
    assert 0 < most.value <= l2.value, (most.value, l2.value)
    return dict(l2_bytes=l2.value, max_persisting_bytes=most.value,
                persisting_bytes=now.value)


@contextlib.contextmanager
def persisting_set_aside(nbytes):
    """The persisting-L2 set-aside raised to ``nbytes`` for the block
    (yields the set-aside in force then); afterwards the persisting lines
    are reset and the earlier set-aside restored.  Only this script sets
    it: the port sets no device state."""
    import ctypes
    import torch
    before = l2_state()["persisting_bytes"]
    torch.cuda.synchronize()
    _cu("cuCtxSetLimit", CU_LIMIT_PERSISTING_L2_CACHE_SIZE,
        ctypes.c_size_t(nbytes))
    try:
        yield l2_state()["persisting_bytes"]
    finally:
        torch.cuda.synchronize()
        _cu("cuCtxResetPersistingL2Cache")
        _cu("cuCtxSetLimit", CU_LIMIT_PERSISTING_L2_CACHE_SIZE,
            ctypes.c_size_t(before))
    assert l2_state()["persisting_bytes"] == before


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _pass_env(kernel, A, rng, dtype, dev):
    """Inputs of one B1 pass: the cg operator for the streamed matrix,
    seeded random vectors and scalars for the rest."""
    import numpy as np
    import torch
    env = {}
    for n in kernel.in_names:
        shape = kernel.shapes[n]
        if len(shape) == 2:
            env[n] = A
        else:
            v = rng.standard_normal(shape) if shape else \
                np.asarray(rng.uniform(0.5, 1.5))
            env[n] = torch.from_numpy(np.asarray(v)).to(dev, dtype)
    return env


def check_stream(cg_prog, A_np, results, dtypes):
    """B1 on the cg template's Ap/pAp pass and r/rs pass."""
    import numpy as np
    import torch
    passes = {}
    for call in cg_prog._tmpl:
        k = getattr(call, "pass_", None)
        if k is None:
            continue
        ops = {nd.op for nd in k.nodes}
        if "matmul" in ops:
            passes.setdefault("Ap/pAp", k)
        elif "dot" in ops and "axpy" in ops:
            passes.setdefault("r/rs", k)
    assert set(passes) == {"Ap/pAp", "r/rs"}, sorted(passes)
    for dt in dtypes:
        tdt = getattr(torch, dt)
        A = torch.from_numpy(A_np).to("cuda", tdt)
        for label, k in passes.items():
            rng = np.random.default_rng(11)
            env = _pass_env(k, A, rng, tdt, "cuda")
            got = k(env)                          # the wrapper: launches
            torch.cuda.synchronize()
            want = k.plain(env)
            err = rel = 0.0
            for n in want:
                scale = max(float(want[n].double().abs().max()), 1e-30)
                e = max_err(got[n], want[n])
                assert e <= KERNEL_TOL[dt] * scale, (label, dt, n, e, scale)
                err, rel = max(err, e), max(rel, e / scale)
            nbytes = sum(env[n].numel() * env[n].element_size()
                         for n in k.in_names)
            nbytes += sum(v.numel() * v.element_size()
                          for v in got.values())
            flops = sum(2 * int(np.prod(k.shapes[nd.inputs[0]]))
                        for nd in k.nodes if nd.op in ("matmul", "dot",
                                                       "norm", "axpy"))
            lib = None              # no one torch call computes r/rs
            if label == "Ap/pAp":
                mv = next(nd for nd in k.nodes if nd.op == "matmul")
                p = env[mv.inputs[1]]

                def lib():
                    return torch.dot(p, torch.mv(A, p))
            times = measure(lambda: k(env), lambda: k.plain(env), lib)
            record(results, f"B1 {label:7s}", kernel="stream",
                   case=f"cg n=4096 {label} pass", dtype=dt, err=err,
                   rel_err=rel, tol=KERNEL_TOL[dt], nbytes=nbytes, flops=flops, times=times,
                   block_r=k.block_r, programs=k.n_prog)


def check_stream_deferred(mesh_prog, A_np, results, dtypes):
    """B1's deferred-finalize mode on the cg template's Ap/pAp and r/rs
    passes of one shard of the K=4 mesh plan (1024 of 4096 rows, ``p``
    gathered whole).  Held bitwise against the ordinary B1 pass on the same
    inputs (the same main kernel and fold: every streamed output equal,
    every raw sum equal to the pass's reduction before its square root)
    and against a second call; the elementwise outputs bitwise against the
    plain version, the rest within ``KERNEL_TOL`` of it (the tree inside a
    program and the matvec's K loop are not the plain version's order).
    Timed beside the bytes bound and ``mv`` + ``dot`` on the same block."""
    import numpy as np
    import torch
    from repro_torch.kernels.stream import StreamKernel
    passes = {}
    for call in mesh_prog._tmpl:
        k = call.unit.pass_
        if k is None:
            continue
        assert k.defer and k.names == ("stream_deferred",
                                       "stream_deferred_finalize")
        ops = {nd.op for nd in k.nodes}
        if "matmul" in ops:
            passes.setdefault("Ap/pAp", k)
        elif "dot" in ops and "axpy" in ops:
            passes.setdefault("r/rs", k)
    assert set(passes) == {"Ap/pAp", "r/rs"}, sorted(passes)
    for dt in dtypes:
        tdt = getattr(torch, dt)
        for label, k in passes.items():
            A = torch.from_numpy(A_np[:k.rows]).to("cuda", tdt)
            rng = np.random.default_rng(11)
            env = _pass_env(k, A, rng, tdt, "cuda")
            ordinary = StreamKernel(k.nodes, k.shapes, set(k.out_names),
                                    k.rows)
            got = k(env)                          # the wrapper: launches
            again = k(env)
            whole = ordinary(env)
            torch.cuda.synchronize()
            want = k.plain(env)
            assert sorted(got) == sorted(k.stream_out + k.red_out)
            for n in got:
                assert torch.equal(got[n], again[n]), (label, dt, n)
                pass_n = (torch.sqrt(got[n]) if n in k.norm_reductions
                          else got[n])
                assert torch.equal(pass_n, whole[n]), (
                    "deferred vs the ordinary pass", label, dt, n)
            contracted = {nd.name for nd in k.nodes
                          if nd.op in ("matmul", "einsum")}
            err = rel = 0.0
            for n in want:
                if n in k.stream_out and not contracted & {n}:
                    assert torch.equal(got[n], want[n]), (label, dt, n)
                scale = max(float(want[n].double().abs().max()), 1e-30)
                e = max_err(got[n], want[n])
                assert e <= KERNEL_TOL[dt] * scale, (label, dt, n, e, scale)
                err, rel = max(err, e), max(rel, e / scale)
            nbytes = sum(env[n].numel() * env[n].element_size()
                         for n in k.in_names)
            nbytes += sum(v.numel() * v.element_size()
                          for v in got.values())
            flops = sum(2 * int(np.prod(k.shapes[nd.inputs[0]]))
                        for nd in k.nodes if nd.op in ("matmul", "dot",
                                                       "norm", "axpy"))
            lib = None              # no one torch call computes r/rs
            if label == "Ap/pAp":
                mv = next(nd for nd in k.nodes if nd.op == "matmul")
                p_g = env[mv.inputs[1]]
                pap = next(nd for nd in k.nodes if nd.op == "dot")
                p_loc = env[next(t for t in pap.inputs if t != mv.name)]

                def lib():
                    return torch.dot(p_loc, torch.mv(A, p_g))
            times = measure(lambda: k(env), lambda: k.plain(env), lib)
            record(results, f"B1 deferred {label:7s}",
                   kernel="stream_deferred",
                   case=f"cg n=4096 K=4 shard ({k.rows} rows) {label} pass",
                   dtype=dt, err=err, rel_err=rel, tol=KERNEL_TOL[dt],
                   nbytes=nbytes, flops=flops, times=times,
                   block_r=k.block_r, programs=k.n_prog,
                   bitwise_vs_pass=True)


def b2_cases(csr, rnd_csr, ob_csr, patterns):
    """B2's operands in phase 3, ``[(label, (indptr, indices, data), cold)]``
    (data float64; ``cold``: timed with the L2 flushed too): the 5-point
    Laplacian at n = 2^20 (cg_sparse's), bicgstab_sparse's random,
    nonsymmetric pattern at n = 131072 (~131 nonzeros a row), the
    overbooked pair's banded operand (B2's at overbook 0; it fits the
    L2, so cold too), and ``b3_patterns``' random pattern with empty rows
    and skewed one (rows longer than a window, than E), their values from
    a seeded generator."""
    import numpy as np
    rng = np.random.default_rng(9)
    cases = [("laplacian5", csr, False),
             ("random density=0.001", rnd_csr, False),
             (f"banded bandwidth={OB_BANDWIDTH}", ob_csr, True)]
    for name in ("random", "skewed"):
        indptr, indices = patterns[name]
        label = "random 0-39 a row" if name == "random" else name
        cases.append((label, (indptr, indices, rng.standard_normal(
            indices.shape[0])), False))
    return cases


def check_spmv(cases, results, dtypes, gather, flush):
    """B2 on each case of ``b2_cases``: bitwise against the ordered plain
    version (``spmv_sliced_plain`` at prefix 0, each row added in entry
    order), within ``KERNEL_TOL`` of ``spmv_plain`` (``index_add_``, whose
    time is the plain time); cuSPARSE beside it, cold where the case says
    so (the L2 emptied by ``flush()``), the form B2 took
    (``spmv_shape``) and the gather floor: the entries' x gathers alone
    (``gather`` at hashed indices into x) and with the operand's indices
    read (``gather`` at those indices).  Returns one summary a case."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmv import (spmv, spmv_plain, spmv_shape,
                                          spmv_sliced_plain)
    out = []
    for label, (indptr_np, indices_np, data_np), cold in cases:
        n = indptr_np.shape[0] - 1
        indptr = torch.from_numpy(indptr_np).cuda()
        indices = torch.from_numpy(indices_np).cuda()
        nnz = indices.numel()
        shape = spmv_shape(n, nnz)
        longest = int(np.diff(indptr_np).max())
        for dt in dtypes:
            tdt = getattr(torch, dt)
            data = torch.from_numpy(data_np).to("cuda", tdt)
            x = torch.from_numpy(np.random.default_rng(5).standard_normal(n)
                                 ).to("cuda", tdt)

            def b2():
                return spmv(indptr, indices, data, x, n)
            got = b2()
            torch.cuda.synchronize()
            ordered = spmv_sliced_plain(indptr, indices, data, x, n, 0)
            assert torch.equal(got, ordered), ("spmv vs ordered plain", label,
                                               dt, max_err(got, ordered))
            want = spmv_plain(indptr, indices, data, x, n)
            err = max_err(got, want)
            scale = float(want.double().abs().max())
            assert err <= KERNEL_TOL[dt] * scale, ("spmv", label, dt, err,
                                                   scale)
            with warnings.catch_warnings():      # beta-state notices
                warnings.simplefilter("ignore")
                A = torch.sparse_csr_tensor(indptr, indices, data, (n, n))

            def library():
                return torch.mv(A, x)
            times = measure(b2, lambda: spmv_plain(indptr, indices, data, x,
                                                   n), library)
            extra = dict(form=shape, longest_row=longest,
                         bitwise_vs_ordered_plain=True,
                         gather_hashed_ms=graph_ms(lambda: gather(x, nnz)),
                         gather_indices_ms=graph_ms(
                             lambda: gather(x, nnz, indices)))
            if cold:
                extra.update(cold_ms=cold_ms(b2, flush),
                             library_cold_ms=cold_ms(library, flush))
            record(results, "B2 spmv   ", kernel="spmv",
                   case=f"{label} n={n} nnz={nnz}", dtype=dt, err=err,
                   rel_err=err / scale, tol=KERNEL_TOL[dt],
                   nbytes=(4 * (n + 1) + 4 * nnz + data.element_size() * nnz
                           + 2 * x.element_size() * n),
                   flops=2 * nnz, times=times, **extra)
            log(f"    {label} {dt}: bitwise equal to the ordered plain "
                f"version; form {shape['form']} ({shape['ctas']} CTAs of "
                f"{shape['threads']}), longest row {longest}; gather floor "
                f"{extra['gather_hashed_ms']:.4f} ms hashed, "
                f"{extra['gather_indices_ms']:.4f} ms at its indices"
                + (f"; cold B2 {extra['cold_ms']:.4f} ms, cuSPARSE "
                   f"{extra['library_cold_ms']:.4f} ms" if cold else ""))
            out.append(dict(case=label, n=n, nnz=nnz, dtype=dt, card=CARD,
                            bitwise=True, **extra, ms=times["ms"],
                            library_ms=times["library_ms"]))
    return out


def cold_ms(fn, flush, inner: int = 10, reps: int = 15) -> float:
    """Device milliseconds per call of ``fn`` with the L2 emptied before
    each call by ``flush()`` (a 256 MB write or read), the flush's own time
    taken off: the graphs of ``inner`` x (``flush()``, ``fn()``) and of
    ``inner`` x ``flush()`` replayed in turns ``reps`` times each, and the
    difference of their medians, a call (a call of a few microseconds is
    of the size of the flush's own jitter)."""
    import statistics
    import torch
    graphs = (_captured(lambda: (flush(), fn()), inner), _captured(flush,
                                                                  inner))
    times = ([], [])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        for graph, out in zip(graphs, times):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
    return (statistics.median(times[0]) - statistics.median(times[1])) / inner


def check_spmv_sliced(csr, prefix_rows, results, dtypes):
    """B3 on the overbooked path's operand with the plan's resident prefix,
    bitwise against its plain version and B2.  Beside it: B2 on the same
    operand, both kernels with the L2 flushed before each call
    (``cold_ms``: what the L2 saves at all), and both with the
    persisting-L2 set-aside raised to the prefix's bytes or the card's
    largest, whichever is less, then restored (B3 with the prefix's rows
    that the set-aside holds marked, and with the whole prefix marked).
    The bound is the bytes a call must read with the prefix in L2; the
    all-operand bound stands beside it.  The plain version's loop length is
    read on the host, so it is timed eagerly."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmv import spmv, spmv_sliced_plain
    indptr_np, indices_np, data_np = csr
    n, nnz = indptr_np.shape[0] - 1, indices_np.shape[0]
    pre_entries = int(indptr_np[prefix_rows])
    indptr = torch.from_numpy(indptr_np).cuda()
    indices = torch.from_numpy(indices_np).cuda()
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def fill():                  # empties the L2 by a 256 MB write
        return flush.fill_(1.0)
    l2 = l2_state()
    for dt in dtypes:
        tdt = getattr(torch, dt)
        data = torch.from_numpy(data_np).to("cuda", tdt)
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(n)
                             ).to("cuda", tdt)

        def b3(rows=prefix_rows):
            return spmv(indptr, indices, data, x, n, rows)

        def b2():
            return spmv(indptr, indices, data, x, n)

        def plain():
            return spmv_sliced_plain(indptr, indices, data, x, n,
                                     prefix_rows)
        got = b3()
        torch.cuda.synchronize()
        want = plain()
        assert torch.equal(got, want), ("spmv_sliced", dt,
                                        max_err(got, want))
        assert torch.equal(got, b2()), ("spmv_sliced vs spmv", dt)
        with warnings.catch_warnings():      # beta-state notices
            warnings.simplefilter("ignore")
            A = torch.sparse_csr_tensor(indptr, indices, data, (n, n))
        times = dict(ms=graph_ms(b3), call_ms=cuda_ms(b3),
                     plain_ms=cuda_ms(plain, reps=5),
                     library_ms=graph_ms(lambda: torch.mv(A, x)))
        es = data.element_size()
        all_bytes = 4 * (n + 1) + (4 + es) * nnz + 2 * es * n
        resident = (4 + es) * pre_entries
        # the set-aside as far as the card allows toward the prefix, and
        # the prefix's rows whose entries fit in it
        want_aside = min(l2["max_persisting_bytes"], resident)
        held_rows = min(prefix_rows, int(np.searchsorted(
            indptr_np, want_aside // (4 + es), side="right")) - 1)
        # B3 with the prefix hinted (``ms``), with no hint (prefix 0), and
        # B2, back to back in turns
        extra = dict(spmv_b2_ms=graph_ms(b2), unhinted_ms=graph_ms(
            lambda: b3(0)), cold_ms=cold_ms(b3, fill),
            unhinted_cold_ms=cold_ms(lambda: b3(0), fill),
            spmv_b2_cold_ms=cold_ms(b2, fill))
        extra.update(hinted_again_ms=graph_ms(b3),
                     unhinted_again_ms=graph_ms(lambda: b3(0)),
                     spmv_b2_again_ms=graph_ms(b2))
        with persisting_set_aside(want_aside) as aside:
            extra.update(set_aside_ms=graph_ms(lambda: b3(held_rows)),
                         set_aside_whole_prefix_ms=graph_ms(b3),
                         set_aside_b2_ms=graph_ms(b2))
        record(results, "B3 sliced ", kernel="spmv_sliced",
               case=f"banded n={n} bandwidth={OB_BANDWIDTH} nnz={nnz} "
               f"prefix {prefix_rows} rows", dtype=dt, err=0.0, rel_err=0.0,
               tol=0.0, nbytes=all_bytes - resident, flops=2 * nnz,
               times=times, all_operand_bytes=all_bytes,
               bound_ms_all_operand=all_bytes / PEAK_BYTES_S * 1e3,
               resident_bytes=resident, prefix_rows=prefix_rows,
               prefix_entries=pre_entries, plain_timing="eager",
               set_aside_bytes=aside, set_aside_hinted_rows=held_rows,
               **l2, **extra)
        log(f"  B3 {dt}: bitwise equal to its plain version and to B2; "
            f"resident prefix {prefix_rows}/{n} rows, {resident / 1e6:.2f} of "
            f"{all_bytes / 1e6:.2f} MB; back to back B3 {times['ms']:.4f} "
            f"/ {extra['hinted_again_ms']:.4f} ms, unhinted (prefix 0) "
            f"{extra['unhinted_ms']:.4f} / {extra['unhinted_again_ms']:.4f}"
            f" ms, B2 {extra['spmv_b2_ms']:.4f} / "
            f"{extra['spmv_b2_again_ms']:.4f} ms, cuSPARSE "
            f"{times['library_ms']:.4f} ms; L2 flushed before each "
            f"call: B3 {extra['cold_ms']:.4f} ms, unhinted "
            f"{extra['unhinted_cold_ms']:.4f} ms, B2 "
            f"{extra['spmv_b2_cold_ms']:.4f} ms; bound with the prefix in L2 "
            f"{(all_bytes - resident) / PEAK_BYTES_S * 1e3:.4f} ms, all "
            f"operand bytes {all_bytes / PEAK_BYTES_S * 1e3:.4f} ms.  L2 "
            f"{l2['l2_bytes']} B, largest persisting set-aside "
            f"{l2['max_persisting_bytes']} B, in force "
            f"{l2['persisting_bytes']} B, which could hold "
            f"{min(1.0, l2['persisting_bytes'] / resident):.3f} of the "
            f"prefix.  Set-aside raised to {aside} B (could hold "
            f"{min(1.0, aside / resident):.3f} of the prefix): B3 with its "
            f"first {held_rows} rows marked {extra['set_aside_ms']:.4f} ms, "
            f"with the whole prefix marked "
            f"{extra['set_aside_whole_prefix_ms']:.4f} ms, B2 "
            f"{extra['set_aside_b2_ms']:.4f} ms; restored")


def b3_patterns(laplacian_csr):
    """B3's further operands, ``{name: (indptr, indices)}``: the 5-point
    Laplacian at n = 2^20 (the cg_sparse path's), a random pattern (0-39
    entries a row, columns drawn with repeats) and a skewed one whose
    first rows are longer than one staged window (``B3_WINDOW``), each
    from a seeded numpy generator."""
    import numpy as np
    from repro_torch.kernels.spmv import B3_WINDOW
    rng = np.random.default_rng(7)

    def with_counts(n, counts):
        indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
        return indptr, rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    n_skew = 16384
    skew = np.clip((4 * B3_WINDOW / np.sqrt(np.arange(n_skew) + 1.0)
                    ).astype(np.int64), 1, n_skew)
    assert skew.max() > B3_WINDOW
    return {"laplacian5": laplacian_csr[:2],
            "random": with_counts(65536, rng.integers(0, 40, 65536)),
            "skewed": with_counts(n_skew, skew)}


def check_spmv_sliced_shapes(patterns, dtypes):
    """B3 bitwise against its plain version and B2 on each pattern, with a
    resident prefix of no rows, about half the rows (whole tiles) and all
    rows.  Returns one record a case."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmv import (B3_TILE_ROWS, B3_WINDOW, spmv,
                                          spmv_sliced_plain)
    out = []
    rng = np.random.default_rng(8)
    for name, (indptr_np, indices_np) in patterns.items():
        n, nnz = indptr_np.shape[0] - 1, indices_np.shape[0]
        longest = int(np.diff(indptr_np).max())
        indptr = torch.from_numpy(indptr_np).cuda()
        indices = torch.from_numpy(indices_np).cuda()
        for dt in dtypes:
            tdt = getattr(torch, dt)
            data = torch.from_numpy(rng.standard_normal(nnz)).to("cuda", tdt)
            x = torch.from_numpy(rng.standard_normal(n)).to("cuda", tdt)
            b2 = spmv(indptr, indices, data, x, n)
            for where, pre in (("none", 0), ("part", n // 2 // B3_TILE_ROWS
                                              * B3_TILE_ROWS), ("all", n)):
                got = spmv(indptr, indices, data, x, n, pre)
                torch.cuda.synchronize()
                want = spmv_sliced_plain(indptr, indices, data, x, n, pre)
                assert torch.equal(got, want), ("spmv_sliced", name, dt, pre,
                                                max_err(got, want))
                assert torch.equal(got, b2), ("spmv_sliced vs spmv", name,
                                              dt, pre)
                out.append(dict(pattern=name, n=n, nnz=nnz, dtype=dt,
                                prefix_rows=pre, longest_row=longest,
                                window=B3_WINDOW, bitwise=True, card=CARD))
        log(f"  B3 {name} n={n} nnz={nnz} (longest row {longest}, window "
            f"{B3_WINDOW}): bitwise equal to its plain version and to B2 "
            f"in {', '.join(dtypes)} with prefixes of none, part and all "
            "rows")
    return out


#: B4's bitwise checks beside the timed 4096² sweep, (n0, n1, what they
#: reach): a width no vector divides, a ragged last column tile on the
#: vector path, a strip cut short, and grids whose neighbours coincide
B4_SHAPES = ((1000, 1003, "scalar path: n1 odd"),
             (37, 1004, "vector path, ragged last tile and strip"),
             (1, 1, "tiny"), (1, 5, "tiny"), (2, 3, "tiny"), (3, 2, "tiny"))


def check_stencil(results, dtypes, n=4096):
    """B4 on one jacobi2d sweep at n x n, timed; then bitwise checks with
    and without f at ``B4_SHAPES``, at n x n without f, and with u or out
    offset by one element (not 16-byte aligned: the scalar path).  Returns
    the bitwise checks' records."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.stencil import stencil2d, stencil2d_plain
    rng = np.random.default_rng(3)
    u_np, f_np = rng.standard_normal((2, n, n))
    w = torch.zeros(1, 1, 3, 3)
    w[0, 0, 0, 1] = w[0, 0, 2, 1] = w[0, 0, 1, 0] = w[0, 0, 1, 2] = 0.25
    shapes = []

    def bitwise(u, f, what, h2=1.0, out=None):
        got = stencil2d(u, f, h2, out=out)
        torch.cuda.synchronize()
        want = stencil2d_plain(u, f, h2)
        assert torch.equal(got, want), ("stencil2d", what, u.dtype,
                                        max_err(got, want))
        shapes.append(dict(shape=list(u.shape), dtype=str(u.dtype)[6:],
                           f=f is not None, case=what, bitwise=True,
                           card=CARD))

    for dt in dtypes:
        tdt = getattr(torch, dt)
        u = torch.from_numpy(u_np).to("cuda", tdt)
        f = torch.from_numpy(f_np).to("cuda", tdt)
        got = stencil2d(u, f, 1.0)
        torch.cuda.synchronize()
        want = stencil2d_plain(u, f, 1.0)
        err = max_err(got, want)
        assert torch.equal(got, want), ("stencil2d", dt, err)
        wt = w.to("cuda", tdt)
        times = measure(
            lambda: stencil2d(u, f, 1.0),
            lambda: stencil2d_plain(u, f, 1.0),
            lambda: torch.add(F.conv2d(
                F.pad(u[None, None], (1, 1, 1, 1), mode="circular"),
                wt)[0, 0], f, alpha=0.25))
        record(results, "B4 stencil", kernel="stencil2d",
               case=f"jacobi2d sweep {n}x{n}", dtype=dt, err=err,
               rel_err=err, tol=0.0, nbytes=3 * u.numel() * u.element_size(),
               flops=6 * u.numel(), times=times)
        bitwise(u, None, "path shape, no f")
        for n0, n1, what in B4_SHAPES:
            a, b = (torch.from_numpy(rng.standard_normal((n0, n1)))
                    .to("cuda", tdt) for _ in range(2))
            bitwise(a, b, what, h2=0.5)
            bitwise(a, None, what)
        m0, m1 = 1000, 1004
        buf = torch.from_numpy(rng.standard_normal(m0 * m1 + 1)).to(
            "cuda", tdt)
        shifted = buf[1:].view(m0, m1)
        assert shifted.data_ptr() % 16, "the offset operand is aligned"
        a = torch.from_numpy(rng.standard_normal((m0, m1))).to("cuda", tdt)
        bitwise(shifted, a, "u offset one element (scalar path)")
        out = torch.empty_like(buf)[1:].view(m0, m1)
        bitwise(a, shifted, "out offset one element (scalar path)", out=out)
    grids = ", ".join(f"{a}x{b}" for a, b, _ in B4_SHAPES)
    log(f"  B4 bitwise equal to its plain version at {len(shapes)} more "
        f"checks: {n}x{n} without f, {grids} with and without f, u or out "
        f"offset one element; {', '.join(dtypes)}")
    return shapes


def relax_program(pkg, n):
    """Stencil sweeps with elementwise ops between them: as one ``block``
    unit, the ops run as a B1 pass over the flattened grids between B4
    sweeps that ping-pong between scratch buffers."""
    p = pkg.Program("relax")
    u = p.input("u0", (n, n))
    f = p.input("f", (n, n))
    w = p.input("w", (), init="const", value=0.6)
    u1 = p.stencil2d(u, f, h2=0.5, name="u1")
    d = p.sub(u1, u, name="d")
    u2 = p.axpy(w, d, u, name="u2")
    u3 = p.stencil2d(u2, f, name="u3")
    u4 = p.stencil2d(u3, name="u4")
    u5 = p.stencil2d(u4, f, name="u5")
    p.output(p.add(u5, d, name="out"), d)
    return p


def ffn_program(pkg, m, d, f):
    """An FFN phase: ``ab,bc->ac`` products with resident weights."""
    p = pkg.Program("ffn")
    x = p.input("x", (m, d))
    h = p.matmul(x, p.operator("w_up", (d, f)), name="up")
    g = p.matmul(x, p.operator("w_gate", (d, f)), name="gate")
    p.output(p.matmul(p.mul(h, g, name="act"),
                      p.operator("w_down", (f, d)), name="ffn_out"))
    return p


def check_off_path(dtypes):
    """Code paths of B1 and B4 that no main-path workload reaches, held
    for correctness only: generated ``ab,bc->ac`` passes (tl.dot, the left
    operand from memory and from the block's own tile), also with tiles
    and a K of 384 columns (walked in chunks of 256) against the reference
    and, in fp32, in all three forms of B1 against the plain version, and
    a block unit with elementwise ops between stencil sweeps."""
    import numpy as np
    import torch
    from repro_torch import frontends
    from repro_torch.api import Session
    from repro_torch.core.lowering import ExecUnit
    from repro_torch.exec.cuda import _BlockUnit
    from repro_torch.kernels.stream import (MAX_TILE_WIDTH, LaneStreamKernel,
                                            StreamKernel)
    ffns = {f: ffn_program(frontends, 4096, 64, f) for f in (128, 384)}
    plans = {f: Session.from_graph(p, device="cuda").codesign().lower()
             for f, p in ffns.items()}
    for plan in plans.values():
        assert any(u.kind == "stream" and {"up", "ffn_out"} <= set(u.ops)
                   for u in plan.exec_plan.units), plan.exec_plan.describe()
    wide = plans[384].compiled()
    wide_pass = next(k for c in (*wide._pro, *wide._tmpl, *wide._epi)
                     for k in [getattr(c, "pass_", None)]
                     if k is not None and "ffn_out" in k.out_names)
    assert max(s[1] for s in wide_pass.shapes.values()
               if len(s) == 2) > MAX_TILE_WIDTH
    args = (wide_pass.nodes, wide_pass.shapes, {"ffn_out"}, wide_pass.rows)
    forms = {"single": StreamKernel(*args),
             "deferred": StreamKernel(*args, defer_finalize=True),
             "lanes": LaneStreamKernel(*args, lanes={"x"})}
    relax = relax_program(frontends, 1024)
    unit = ExecUnit(tuple(relax.schedulable_order()), "block")
    block = _BlockUnit(relax, unit, set(relax.outputs))
    for dt in dtypes:
        for f, plan in plans.items():
            feeds = frontends.feeds_from_numpy(frontends.make_feeds(
                ffns[f], seed=0, dtype=getattr(np, dt)), "cuda")
            got, want = plan.run(feeds), plan.run(feeds, backend="reference")
            torch.cuda.synchronize()
            e = max_err(got["ffn_out"], want["ffn_out"])
            scale = float(want["ffn_out"].double().abs().max())
            assert e <= KERNEL_TOL[dt] * scale, ("ffn", f, dt, e, scale)
        wide_errs, wide_ms = {}, {}
        for form, k in forms.items() if dt == "float32" else ():
            env = {n: feeds[n] for n in k.in_names}
            if form == "lanes":
                env["x"] = torch.stack([feeds["x"], 2.0 * feeds["x"]])
            got, want = k(env), k.plain(env)
            torch.cuda.synchronize()
            for n in want:
                e = max_err(got[n], want[n])
                scale = float(want[n].double().abs().max())
                assert e <= KERNEL_TOL[dt] * scale, ("wide B1", form, dt, n,
                                                     e, scale)
                wide_errs[form] = max(wide_errs.get(form, 0.0), e / scale)
            # the lane form streams nothing without lanes (x carries
            # them), so it runs one lane a program
            wide_ms[form] = graph_ms(lambda: k(env))
        feeds = frontends.feeds_from_numpy(frontends.make_feeds(
            relax, seed=0, dtype=getattr(np, dt)), "cuda")
        got = block(feeds)
        want = frontends.evaluate(relax, feeds)
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), ("block", dt, k,
                                                  max_err(got[k], want[k]))
        log(f"  off the main path {dt}: ffn ab,bc->ac passes (f 128 and "
            f"384) within {KERNEL_TOL[dt]} of the reference; B1's forms at "
            f"tiles and K of 384 columns against the plain version, rel err "
            f"{wide_errs or 'not run'}, ms {wide_ms or 'not run'} (lanes: 2 "
            f"lanes, {forms['lanes'].group} a program); block unit with "
            "elementwise ops between sweeps bitwise equal to the reference")


def _rand(rng, shape, dtype, scale=1.0):
    import torch
    return (torch.from_numpy(rng.standard_normal(shape, dtype="float32"))
            .mul_(scale).to("cuda", dtype))


def _hold(label, got, want, dt):
    """A kernel's output against its plain version: fp32 within
    ``KERNEL_TOL`` of the output's scale, bf16 within one rounding
    (``bf16_excess`` <= 1).  Returns (max |err|, relative err or excess)."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, label
    assert bool(torch.isfinite(got).all()), (label, "non-finite")
    err = max_err(got, want)
    if dt == "float32":
        scale = max(float(want.double().abs().max()), 1e-30)
        assert err <= KERNEL_TOL[dt] * scale, (label, dt, err, scale)
        return err, err / scale
    excess = bf16_excess(got, want, KERNEL_TOL["float32"])
    assert excess <= 1.0, (label, dt, "bf16 excess", excess, err)
    return err, excess


#: B7's widths in phase 3: granite-3-8b, rwkv6-7b, minitron-8b and
#: llama-3.2-vision-11b 4096, granite-moe-1b-a400m 1024, hubert-xlarge
#: 1280, moonshot-v1-16b-a3b 2048, recurrentgemma-2b and h2o-danube-1.8b
#: 2560, gemma-7b 3072
B7_WIDTHS = (4096, 1024, 1280, 2048, 2560, 3072)
#: B7's targets on the cold-L2 time, as shares of its bytes bound: every
#: case of 1024 rows or more, and the training case (4096 x 4096 bf16,
#: 67 MB, beyond the L2)
B7_COLD_SHARE, B7_TRAIN_COLD_SHARE = 0.5, 0.85
#: the floors that phase 3 reads beside kernels: an empty kernel (one
#: launch in ``graph_ms``, B7's floor) and B2's gather floor, random reads
#: x[i] from a table of n entries, ``count`` of them, summed by each thread
#: (one write a thread): at hashed indices (``cello_gather_hash_*``, the
#: gathers alone) or at an operand's own indices (``cello_gather_idx_*``,
#: the gathers and the coalesced read of the indices)
FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void cello_empty_kernel() {}
extern "C" int cello_empty(void* stream) {
  cello_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ unsigned cello_hash(unsigned j, unsigned seed) {
  unsigned h = j * 2654435761u ^ seed;
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  return h;
}

template <typename T, bool kHash>
__global__ void __launch_bounds__(256) cello_gather_kernel(
    const T* __restrict__ x, const int* __restrict__ idx, unsigned n, long long count,
    unsigned seed, T* __restrict__ out) {
  const long long t = blockIdx.x * 256ll + threadIdx.x;
  const long long stride = gridDim.x * 256ll;
  T acc = T(0);
  for (long long i = t; i < count; i += 8 * stride) {
    T v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const long long j = i + q * stride;
      const unsigned c = kHash ? __umulhi(cello_hash(static_cast<unsigned>(j), seed), n)
                               : (j < count ? static_cast<unsigned>(idx[j]) : 0u);
      v[q] = j < count ? x[c] : T(0);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) acc += v[q];
  }
  out[t] = acc;
}

template <typename T, bool kHash>
int cello_gather(const void* x, const void* idx, int n, long long count, int seed, void* out,
                 int blocks, void* stream) {
  cello_gather_kernel<T, kHash><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<unsigned>(n), count,
      static_cast<unsigned>(seed), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int cello_gather_hash_f32(const void* x, int n, long long count, int seed, void* out,
                                     int blocks, void* stream) {
  return cello_gather<float, true>(x, nullptr, n, count, seed, out, blocks, stream);
}
extern "C" int cello_gather_hash_f64(const void* x, int n, long long count, int seed, void* out,
                                     int blocks, void* stream) {
  return cello_gather<double, true>(x, nullptr, n, count, seed, out, blocks, stream);
}
extern "C" int cello_gather_idx_f32(const void* x, const void* idx, long long count, void* out,
                                    int blocks, void* stream) {
  return cello_gather<float, false>(x, idx, 0, count, 0, out, blocks, stream);
}
extern "C" int cello_gather_idx_f64(const void* x, const void* idx, long long count, void* out,
                                    int blocks, void* stream) {
  return cello_gather<double, false>(x, idx, 0, count, 0, out, blocks, stream);
}
"""
#: CTAs of 256 threads an SM in the gather floor (the SM's 2048 threads)
GATHER_CTAS_PER_SM = 8


def start_floors():
    """``nvcc``, started beside phase 2's build, for the floors
    (``FLOOR_CU``), into a library under the build directory.  The process
    is stopped at exit if it still runs."""
    import atexit
    from repro_torch.kernels import build
    out = build.build_dir() / "floors"
    out.mkdir(parents=True, exist_ok=True)
    (out / "floors.cu").write_text(FLOOR_CU)
    lib = out / "libfloors.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS[:-2],
                             "-shared", str(out / "floors.cu"), "-o",
                             str(lib)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, lib


def floors(started):
    """The library of ``start_floors``, built and loaded: ``(empty,
    gather)``, the empty kernel's launcher and ``gather(x, count,
    indices=None)``, which launches the gather floor over x (hashed
    indices when ``indices`` is None) and returns its output."""
    import ctypes
    import torch
    proc, path = started
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the floor kernels:\n{text}")
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cello_empty.argtypes = [vp]
    for sfx in ("f32", "f64"):
        getattr(lib, f"cello_gather_hash_{sfx}").argtypes = [
            vp, i32, i64, i32, vp, i32, vp]
        getattr(lib, f"cello_gather_idx_{sfx}").argtypes = [
            vp, vp, i64, vp, i32, vp]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * GATHER_CTAS_PER_SM
    outs = {}

    def empty():
        err = lib.cello_empty(torch.cuda.current_stream().cuda_stream)
        assert err == 0, ("empty kernel", err)

    def gather(x, count, indices=None):
        sfx = "f32" if x.dtype == torch.float32 else "f64"
        out = outs.setdefault(x.dtype, torch.empty(
            blocks * 256, dtype=x.dtype, device=x.device))
        stream = torch.cuda.current_stream().cuda_stream
        if indices is None:
            err = getattr(lib, f"cello_gather_hash_{sfx}")(
                x.data_ptr(), x.numel(), count, 31, out.data_ptr(), blocks,
                stream)
        else:
            err = getattr(lib, f"cello_gather_idx_{sfx}")(
                x.data_ptr(), indices.data_ptr(), count, out.data_ptr(),
                blocks, stream)
        assert err == 0, ("gather floor", err)
        return out
    return empty, gather


def _turns(new, old, timer):
    """(new, old) by ``timer``, read old, new, new, old: each the mean of
    its two readings, so that a drift of the card's speed cancels."""
    o1, n1, n2, o2 = timer(old), timer(new), timer(new), timer(old)
    return (n1 + n2) / 2, (o1 + o2) / 2


#: B7's device time: 200 calls a reading (a call is 2-30 us)
b7_ms = functools.partial(graph_ms, inner=20, reps=10)


def check_rmsnorm(results, empty, flush, d=4096, eps=1e-6):
    """B7 at the prefill's 1024 rows and a decode step's 4 rows, at width
    ``d`` (``B7_WIDTHS``), in fp32 and bf16; at d 4096 also at the
    training step's 4096 rows (bf16, phase 11).  Each case within one bf16
    rounding / ``KERNEL_TOL`` of the plain version and bitwise from call
    to call; its warm time (``b7_ms``: the model's case, x just written)
    beside ``F.rms_norm``'s.  From 1024 rows also its cold time
    (``cold_ms`` with ``flush``, a 256 MB read that empties the L2,
    so that x comes from HBM and y's lines go back to it), the share of
    the bytes bound on it (above 1: a fault of the measurement, said so),
    and warm and cold the time of ``y.copy_(x)``: the same bytes with no
    arithmetic, what the harness lets any kernel reach.  At 4 rows the
    empty kernel's time (``empty``), the floor.  Then per dtype
    the same rows bitwise at 1, 4, 1024 and 4096 rows and at an offset,
    and the general path on a view that is not 16-byte aligned, bitwise
    the aligned call."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (launch_shape, rmsnorm,
                                             rmsnorm_plain)
    from repro_torch.kernels.rmsnorm import work as rmsnorm_work
    rng = np.random.default_rng(21)
    w = _rand(rng, (d,), torch.float32, 0.1)
    both = ("float32", "bfloat16")
    shapes = [(PREFILL_SEQ, both), (GEN_BATCH, both)]
    if d == 4096:
        shapes.append((TRAIN_BATCH * TRAIN_SEQ, ("bfloat16",)))
    for rows, dts in shapes:
        for dt in dts:
            x = _rand(rng, (rows, d), getattr(torch, dt))
            got = rmsnorm(x, w, eps=eps)
            again = rmsnorm(x, w, eps=eps)
            torch.cuda.synchronize()
            assert torch.equal(got, again), ("B7 run to run", rows, d, dt)
            want = rmsnorm_plain(x, w, eps=eps)
            err, rel = _hold("rmsnorm", got, want, dt)
            w1 = (1.0 + w).to(x.dtype)

            def new():
                return rmsnorm(x, w, eps=eps)

            def library():
                return F.rms_norm(x, (d,), w1, eps)
            y_copy = torch.empty_like(x)

            def copy():
                return y_copy.copy_(x)
            cold = rows >= PREFILL_SEQ
            extra = dict(launch_shape=launch_shape(d, x.dtype)._asdict())
            times = dict(call_ms=cuda_ms(new),
                         plain_ms=graph_ms(lambda: rmsnorm_plain(x, w,
                                                                 eps=eps)))
            times["ms"], times["library_ms"] = _turns(new, library, b7_ms)
            if cold:
                extra["cold_ms"], extra["library_cold_ms"] = _turns(
                    new, library, lambda f: cold_ms(f, flush))
                extra["copy_ms"] = _turns(new, copy, b7_ms)[1]
                extra["copy_cold_ms"] = _turns(
                    new, copy, lambda f: cold_ms(f, flush))[1]
            else:
                extra["floor_ms"] = _turns(new, empty, b7_ms)[1]
            flops, nbytes = rmsnorm_work(x, w)
            b_ms = bound_ms(nbytes, flops, "float32")[0]
            notes = [f"shape {tuple(extra['launch_shape'].values())}"]
            if cold:
                share = b_ms / extra["cold_ms"]
                target = (B7_TRAIN_COLD_SHARE if rows > PREFILL_SEQ
                          else B7_COLD_SHARE)
                extra.update(cold_share=share, cold_share_target=target,
                             cold_share_met=share >= target,
                             cold_share_fault=share > 1.0)
                notes.append(f"cold {extra['cold_ms']:.5f} ms ("
                             f"F.rms_norm {extra['library_cold_ms']:.5f}, "
                             f"a copy of x {extra['copy_cold_ms']:.5f}; "
                             f"warm {extra['copy_ms']:.5f}), "
                             f"{share:.1%} of the bound (target "
                             f"{target:.0%}: "
                             f"{'met' if share >= target else 'MISSED'})")
                if share > 1.0:
                    notes.append("MEASUREMENT FAULT: the cold time is "
                                 "below the bytes bound")
            else:
                notes.append(f"launch-bound: empty kernel "
                             f"{extra['floor_ms']:.5f} ms")
            record(results, "B7 rmsnorm", kernel="rmsnorm",
                   case=f"rows={rows} d={d}", dtype=dt, err=err,
                   rel_err=rel, tol=KERNEL_TOL["float32"] if dt == "float32"
                   else "1 bf16 rounding", nbytes=nbytes,
                   flops=flops, times=times, peak="float32", **extra)
            log(f"    rows={rows} d={d} {dt}: " + "; ".join(notes))
    for dt in both:
        X = _rand(rng, (TRAIN_BATCH * TRAIN_SEQ, d), getattr(torch, dt))
        full = rmsnorm(X, w, eps=eps)
        for lo, hi in ((0, 1), (0, 4), (0, PREFILL_SEQ), (5, 9)):
            assert torch.equal(rmsnorm(X[lo:hi], w, eps=eps), full[lo:hi]), \
                ("B7 rows", lo, hi, d, dt)
        buf = torch.empty(PREFILL_SEQ * d + 1, dtype=X.dtype, device="cuda")
        view = buf[1:].view(PREFILL_SEQ, d)
        view.copy_(X[:PREFILL_SEQ])
        assert view.data_ptr() % 16, "the view should not be aligned"
        got = rmsnorm(view, w, eps=eps)
        _hold("rmsnorm unaligned", got, rmsnorm_plain(view, w, eps=eps), dt)
        assert torch.equal(got, full[:PREFILL_SEQ]), ("B7 unaligned", d, dt)
    log(f"  B7 d={d}: bitwise at 1, 4, {PREFILL_SEQ} and "
        f"{TRAIN_BATCH * TRAIN_SEQ} rows and at rows 5-8; the general path "
        "on an unaligned view bitwise the aligned call")


#: B7 off the vector path's row groups, (d, dtype, rows timed): d 1001, no
#: multiple of the 16-byte vector (the general path), and rows past one
#: CTA's registers (above 8192 in fp32, 16384 in bf16), walked in chunks on
#: 16-byte vectors (d 12288, 20480) or on scalars (d 16390); no registered
#: arch is that wide
B7_GENERAL = ((1001, "float32", (PREFILL_SEQ,)),
              (1001, "bfloat16", (PREFILL_SEQ,)),
              (12288, "float32", (GEN_BATCH, PREFILL_SEQ)),
              (20480, "bfloat16", (GEN_BATCH, PREFILL_SEQ)),
              (16390, "bfloat16", (PREFILL_SEQ,)))


def check_rmsnorm_general(results, eps=1e-6):
    """B7 at each case of ``B7_GENERAL``: within one bf16 rounding /
    ``KERNEL_TOL`` of the plain version, bitwise from call to call, the
    first 1 and 4 rows of a 1024-row call bitwise the same rows alone, and
    where the vector path walks the row in chunks, the general path's
    scalar walk of an unaligned view bitwise the vector walk; timed at each
    row count beside the plain version and, in turns with it,
    ``F.rms_norm``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (MAX_THREADS, launch_shape,
                                             rmsnorm, rmsnorm_plain)
    from repro_torch.kernels.rmsnorm import work as rmsnorm_work
    rng = np.random.default_rng(22)
    for d, dt, timed in B7_GENERAL:
        tdt = getattr(torch, dt)
        shape = launch_shape(d, tdt)
        per = 16 // tdt.itemsize
        chunked = shape.threads * shape.vectors * per < d
        assert shape.vector == (chunked and d % per == 0), (d, dt, shape)
        kind = ("general path" if not chunked else
                f"chunked, {'16-byte vectors' if shape.vector else 'scalars'}")
        w = _rand(rng, (d,), torch.float32, 0.1)
        w1 = (1.0 + w).to(tdt)
        X = _rand(rng, (PREFILL_SEQ, d), tdt)
        full = rmsnorm(X, w, eps=eps)
        for rows in (1, GEN_BATCH):
            assert torch.equal(rmsnorm(X[:rows], w, eps=eps), full[:rows]), \
                ("B7 rows", rows, d, dt)
        if shape.vector:
            buf = torch.empty(PREFILL_SEQ * d + 1, dtype=tdt, device="cuda")
            view = buf[1:].view(PREFILL_SEQ, d)
            view.copy_(X)
            assert view.data_ptr() % 16, "the view should not be aligned"
            assert torch.equal(rmsnorm(view, w, eps=eps), full), (
                "B7 unaligned", d, dt)
        for rows in timed:
            x = X[:rows].contiguous()
            got = rmsnorm(x, w, eps=eps)
            again = rmsnorm(x, w, eps=eps)
            torch.cuda.synchronize()
            assert torch.equal(got, again), ("B7 run to run", rows, d, dt)
            err, rel = _hold("rmsnorm general", got,
                             rmsnorm_plain(x, w, eps=eps), dt)
            flops, nbytes = rmsnorm_work(x, w)
            times = dict(call_ms=cuda_ms(lambda: rmsnorm(x, w, eps=eps)),
                         plain_ms=graph_ms(lambda: rmsnorm_plain(x, w,
                                                                 eps=eps)))
            times["ms"], times["library_ms"] = _turns(
                lambda: rmsnorm(x, w, eps=eps),
                lambda: F.rms_norm(x, (d,), w1, eps), b7_ms)
            log(f"    rows={rows} d={d} {dt} ({kind}): {times['ms']:.5f} "
                f"ms, F.rms_norm {times['library_ms']:.5f} ms")
            record(results, "B7 general", kernel="rmsnorm",
                   case=f"rows={rows} d={d} ({kind})", dtype=dt, err=err,
                   rel_err=rel, tol=KERNEL_TOL["float32"]
                   if dt == "float32" else "1 bf16 rounding",
                   nbytes=nbytes, flops=flops, times=times, peak="float32",
                   launch_shape=shape._asdict())
    log(f"  B7 off the row groups {[c[:2] for c in B7_GENERAL]}: bitwise "
        f"at 1, 4 and {PREFILL_SEQ} rows; past {MAX_THREADS} threads' "
        "registers the unaligned views' scalar walks bitwise the vector "
        "walks")


#: B5's arithmetic per operand type, and the peak that bounds it: bf16 on
#: the tensor cores (the function's operations at the bf16 rate), fp32 on
#: the CUDA cores
B5_MATH = {
    "bfloat16": dict(peak="bfloat16", arith="bf16 mma.sync, P split hi/lo"),
    "float32": dict(peak="float32", arith="fp32 CUDA cores, q scaled "
                    "before the product"),
}


def b6_math(rows, d, f, gated, dt):
    """B6's arithmetic at ``rows`` rows: from ``TC_MIN_ROWS`` up, 3xTF32 on
    the tensor cores, bounded by the function's operations at the TF32
    peak; ``mma_flops`` (data only) counts the MMAs the split issues: two
    terms for x·W with a bf16 x, three with an fp32 x, three for h·Wd.
    Below, exact fp32 on the CUDA cores."""
    from repro_torch.kernels.fused_mlp import TC_MIN_ROWS
    if rows < TC_MIN_ROWS:
        return dict(peak="float32", arith="fp32 CUDA cores (rows kernel)")
    terms = 2 if dt == "bfloat16" else 3
    return dict(peak="tf32", arith="3xTF32 mma.sync",
                mma_flops=2 * rows * d * f * ((2 if gated else 1) * terms
                                              + 3))


def check_flash(results, B=1, H=32, KVH=8, S=PREFILL_SEQ, E=128):
    """B5 at the prefill's shape (granite-3-8b, causal), timed, and at the
    training step's batch of ``TRAIN_BATCH`` (bf16, phase 11); then, for
    correctness only, the code paths the other dense archs reach: E=256
    (gemma-7b), E=80 with a window (h2o-danube-1.8b), T > S, ragged S."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import work as flash_work
    rng = np.random.default_rng(22)
    for B, dt in ((B, "float32"), (B, "bfloat16"),
                  (TRAIN_BATCH, "bfloat16")):
        tdt = getattr(torch, dt)
        q = _rand(rng, (B, H, S, E), tdt)
        k = _rand(rng, (B, KVH, S, E), tdt)
        v = _rand(rng, (B, KVH, S, E), tdt)
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=True)
        err, rel = _hold("flash", got, want, dt)
        kx = k.repeat_interleave(H // KVH, dim=1)
        vx = v.repeat_interleave(H // KVH, dim=1)
        times = measure(
            lambda: flash_attention(q, k, v, causal=True),
            lambda: flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True))
        flops, nbytes = flash_work(q, k, v, causal=True)
        record(results, "B5 flash  ", kernel="flash_attention",
               case=f"B={B} H={H} KVH={KVH} S=T={S} E={E} causal"
               + (" (training batch)" if B == TRAIN_BATCH else ""),
               dtype=dt, err=err, rel_err=rel,
               tol=KERNEL_TOL["float32"] if dt == "float32"
               else "1 bf16 rounding",
               nbytes=nbytes, flops=flops, times=times, **B5_MATH[dt])
    for name, (h, kvh, s, t, e, causal, window) in {
            "E=256 (gemma-7b)": (16, 16, 200, 200, 256, True, None),
            "E=80 window=96 (h2o-danube)": (8, 2, 300, 300, 80, True, 96),
            "T>S (q_offset=64), ragged": (4, 1, 100, 164, 128, True, None),
            "non-causal, E=64": (4, 2, 96, 130, 64, False, None)}.items():
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            q = _rand(rng, (2, h, s, e), tdt)
            k = _rand(rng, (2, kvh, t, e), tdt)
            v = _rand(rng, (2, kvh, t, e), tdt)
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            err, rel = _hold(f"flash {name}", got, want, dt)
            log(f"  B5 off the main path, {name} {dt}: max|err| {err:.3e} "
                f"({'rel' if dt == 'float32' else 'bf16 excess'} {rel:.3e})")


def check_flash_hybrid(results):
    """B5 at recurrentgemma-2b's prefill shape: 10 query heads over one kv
    head (MQA) of E = 256, causal, a 2048-token window that bites at S =
    4096 (213,760 B of dynamic shared memory a block).  SDPA gets the
    window as a boolean mask."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import work as flash_work
    cfg = get_config(HYBRID_ARCH)
    rng = np.random.default_rng(26)
    B, S, W = 1, HYBRID_SEQ, cfg.window
    H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pos = torch.arange(S, device="cuda")
    keep = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - W))
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        q = _rand(rng, (B, H, S, E), tdt)
        k = _rand(rng, (B, KVH, S, E), tdt)
        v = _rand(rng, (B, KVH, S, E), tdt)

        def kernel():
            return flash_attention(q, k, v, causal=True, window=W)

        def plain():
            return flash_attention_plain(q, k, v, causal=True, window=W)
        got = kernel()
        torch.cuda.synchronize()
        err, rel = _hold("flash hybrid", got, plain(), dt)
        kx, vx = k.expand(B, H, S, E), v.expand(B, H, S, E)
        times = measure(kernel, plain, lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=keep))
        flops, nbytes = flash_work(q, k, v, causal=True, window=W)
        record(results, "B5 flash  ", kernel="flash_attention",
               case=f"{HYBRID_ARCH} B={B} H={H} KVH={KVH} S=T={S} E={E} "
               f"causal window={W}", dtype=dt, err=err, rel_err=rel,
               tol=KERNEL_TOL["float32"] if dt == "float32"
               else "1 bf16 rounding",
               nbytes=nbytes, flops=flops, times=times, **B5_MATH[dt])


def check_mlp(results, D=4096, F_=12800):
    """B6 (gated silu, granite-3-8b) at the prefill's 1024 rows and a decode
    step's 4 rows, with fp32 weights, and at the training step's 4096 rows
    (bf16, phase 11); a TF32 control that the fp32 limit must reject;
    relu² without a gate and a ragged M/F for correctness."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_plain
    from repro_torch.kernels.fused_mlp import work as mlp_work
    rng = np.random.default_rng(23)
    wg = _rand(rng, (D, F_), torch.float32, D ** -0.5)
    wu = _rand(rng, (D, F_), torch.float32, D ** -0.5)
    wd = _rand(rng, (F_, D), torch.float32, F_ ** -0.5)
    controls = {}
    both = ("float32", "bfloat16")
    for rows, dts in ((PREFILL_SEQ, both), (GEN_BATCH, both),
                      (TRAIN_BATCH * TRAIN_SEQ, ("bfloat16",))):
        for dt in dts:
            x = _rand(rng, (rows, D), getattr(torch, dt))
            got = fused_mlp(x, wg, wu, wd, activation="silu")
            torch.cuda.synchronize()
            want = fused_mlp_plain(x, wg, wu, wd, activation="silu")
            err, rel = _hold("fused_mlp", got, want, dt)
            if dt == "float32":
                low = fused_mlp_plain(_cut(x), _cut(wg), _cut(wu), _cut(wd),
                                      activation="silu")
                c_rel = max_err(low, want) / float(want.abs().max())
                assert c_rel > KERNEL_TOL["float32"], (
                    "B6's fp32 limit passes a TF32 run", rows, c_rel)
                controls[rows] = c_rel
                log(f"  B6 TF32 control rows={rows}: rel err {c_rel:.3e} > "
                    f"{KERNEL_TOL['float32']:g}: rejected")

            def library():
                xf = x.float()
                return torch.matmul(F.silu(torch.matmul(xf, wg))
                                    * torch.matmul(xf, wu), wd)
            times = measure(lambda: fused_mlp(x, wg, wu, wd),
                            lambda: fused_mlp_plain(x, wg, wu, wd),
                            library)
            flops, nbytes = mlp_work(x, wg, wu, wd)
            record(results, "B6 mlp    ", kernel="fused_mlp",
                   case=f"gated silu M={rows} D={D} F={F_}", dtype=dt,
                   err=err, rel_err=rel,
                   tol=KERNEL_TOL["float32"] if dt == "float32"
                   else "1 bf16 rounding",
                   nbytes=nbytes, flops=flops, times=times,
                   **b6_math(rows, D, F_, True, dt),
                   tf32_control_rel_err=controls.get(rows))
    for name, (m, f, gated, act) in {
            "relu2 no gate (minitron-8b)": (300, 1000, False, "relu2"),
            "gelu gated, ragged M and F (gemma-7b)": (77, 1000, True,
                                                      "gelu"),
            "silu gated, 7 rows (rows kernel, 16-row pad)": (7, 1000, True,
                                                             "silu")}.items():
        for dt in ("float32", "bfloat16"):
            x = _rand(rng, (m, D), getattr(torch, dt))
            g = wg[:, :f].contiguous() if gated else None
            u, dn = wu[:, :f].contiguous(), wd[:f].contiguous()
            got = fused_mlp(x, g, u, dn, activation=act)
            torch.cuda.synchronize()
            want = fused_mlp_plain(x, g, u, dn, activation=act)
            err, rel = _hold(f"fused_mlp {name}", got, want, dt)
            log(f"  B6 off the main path, {name} {dt}: max|err| {err:.3e} "
                f"({'rel' if dt == 'float32' else 'bf16 excess'} {rel:.3e})")


def check_mlp_recurrent(results):
    """B6 at the recurrent serving paths' prefill shapes: gated tanh-gelu
    (recurrentgemma-2b, M 4096, D 2560, F 7680: a 126 MB fp32 hidden
    tensor in scratch) and relu² without a gate (rwkv6-7b, M 1024, D 4096,
    F 14336: 59 MB), fp32 weights."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_plain
    from repro_torch.kernels.fused_mlp import work as mlp_work
    from repro_torch.models.common import is_gated
    rng = np.random.default_rng(27)
    for arch, m in ((HYBRID_ARCH, HYBRID_SEQ), (SSM_ARCH, SSM_SEQ)):
        cfg = get_config(arch)
        D, F_ = cfg.d_model, cfg.d_ff
        gated = is_gated(cfg.activation)
        act = {"geglu": "gelu", "relu2": "relu2"}[cfg.activation]
        wg = _rand(rng, (D, F_), torch.float32, D ** -0.5) if gated else None
        wu = _rand(rng, (D, F_), torch.float32, D ** -0.5)
        wd = _rand(rng, (F_, D), torch.float32, F_ ** -0.5)
        for dt in ("float32", "bfloat16"):
            x = _rand(rng, (m, D), getattr(torch, dt))

            def kernel():
                return fused_mlp(x, wg, wu, wd, activation=act)

            def plain():
                return fused_mlp_plain(x, wg, wu, wd, activation=act)

            def library():
                xf = x.float()
                up = torch.matmul(xf, wu)
                if gated:
                    h = F.gelu(torch.matmul(xf, wg), approximate="tanh") * up
                else:
                    h = torch.relu(up).square()
                return torch.matmul(h, wd)
            got = kernel()
            torch.cuda.synchronize()
            err, rel = _hold(f"fused_mlp {arch}", got, plain(), dt)
            times = measure(kernel, plain, library)
            flops, nbytes = mlp_work(x, wg, wu, wd)
            record(results, "B6 mlp    ", kernel="fused_mlp",
                   case=f"{arch} {'gated ' if gated else ''}{act} M={m} "
                   f"D={D} F={F_}", dtype=dt, err=err, rel_err=rel,
                   tol=KERNEL_TOL["float32"] if dt == "float32"
                   else "1 bf16 rounding",
                   nbytes=nbytes, flops=flops, times=times,
                   **b6_math(m, D, F_, gated, dt))


def _flash_into(q, k, v, out, *, causal, window=None):
    """B5 through its C entry point into a caller's ``out`` (any strides
    over (B, H, S), unit stride over E), as the wrapper launches it; not
    counted: a comparison launch."""
    import ctypes
    import torch
    from repro_torch.kernels.build import check, cuda_library
    B, H, S, E = q.shape
    KVH, T = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *[st for t in (q, k, v, out) for st in t.stride()[:3]])
    fn = (cuda_library().cello_flash_attention_bf16
          if q.dtype == torch.bfloat16
          else cuda_library().cello_flash_attention_f32)
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), B, H, KVH, S, T, E, float(E ** -0.5),
             int(causal), int(window or 0),
             torch.cuda.current_stream().cuda_stream), "flash_attention")


def check_flash_edges(rng, H, KVH, S, T, E, causal, dt, window=None):
    """B5 at a head dim below its instantiation (E 80 runs in the E 128
    one) on operands whose columns E..127 hold NaN (views of wider rows),
    into an output whose columns E..127 hold a sentinel: the staged
    columns past E must read as zero (a NaN read would reach every
    score) and nothing may be written past E."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    tdt = getattr(torch, dt)
    pad = 128

    def padded(heads, rows):
        big = torch.full((1, heads, rows, pad), float("nan"), device="cuda",
                         dtype=tdt)
        big[..., :E] = _rand(rng, (1, heads, rows, E), tdt)
        return big[..., :E]
    q, k, v = padded(H, S), padded(KVH, T), padded(KVH, T)
    out_big = torch.full((1, H, S, pad), 7.0, device="cuda", dtype=tdt)
    out = out_big[..., :E]
    _flash_into(q, k, v, out, causal=causal, window=window)
    torch.cuda.synchronize()
    assert bool((out_big[..., E:] == 7.0).all()), "B5 wrote past E"
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal, window=window)
    return _hold(f"flash E={E} NaN-padded", out.contiguous(), want, dt)


def check_flash_families(results):
    """B5 at the MoE, audio and vlm paths' prefill shapes (1 x 1024
    queries): hubert-xlarge's bidirectional attention (16 heads over 16,
    E = 80, run in the E 128 instantiation; also on NaN-padded operands
    into a sentinel-padded output, ``check_flash_edges``),
    llama-3.2-vision-11b's cross-attention (32 heads over 8, E 128, 1024
    queries against its 6404 image keys: 6404 % 64 = 4 keys in the last kv
    tile, and q_offset = T - S = 5380 must stay out of a mask that is
    neither causal nor windowed) and causal self-attention (granite-3-8b's
    shape), and the MoE archs' causal GQA (granite-moe-1b-a400m 16 over 8
    heads of 64, moonshot-v1-16b-a3b 16 over 16 of 128); then the dense
    archs that phase 5 serves: gemma-7b's MHA of E 256 (16 heads,
    1 x 1024, causal) and h2o-danube-1.8b's GQA of E 80 (32 over 8 heads)
    with its 4096-token window at 1 x 8192, twice the window, so that it
    bites (its E 80 also on padded operands).  SDPA gets the kv heads
    expanded, and a window as a boolean band mask."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import work as flash_work
    rng = np.random.default_rng(28)
    B = 1
    for arch, causal, cross, S in ((AUDIO_ARCH, False, False, PREFILL_SEQ),
                                   (VLM_ARCH, False, True, PREFILL_SEQ),
                                   (VLM_ARCH, True, False, PREFILL_SEQ),
                                   (MOE_ARCH, True, False, PREFILL_SEQ),
                                   (MOE_WIDE_ARCH, True, False, PREFILL_SEQ),
                                   (GEMMA_ARCH, True, False, PREFILL_SEQ),
                                   (DANUBE_ARCH, True, False, DANUBE_SEQ)):
        cfg = get_config(arch)
        H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        T = cfg.vision_seq if cross else S
        W = None if cross else cfg.window
        keep = None
        if W is not None:
            pos = torch.arange(S, device="cuda")
            keep = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - W))
        what = (f"{arch} {'cross-attention ' if cross else ''}B={B} H={H} "
                f"KVH={KVH} S={S} T={T} E={E} "
                f"{'causal' if causal else 'non-causal'}"
                + (f" window={W}" if W else ""))
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            q = _rand(rng, (B, H, S, E), tdt)
            k = _rand(rng, (B, KVH, T, E), tdt)
            v = _rand(rng, (B, KVH, T, E), tdt)

            def kernel():
                return flash_attention(q, k, v, causal=causal, window=W)

            def plain():
                return flash_attention_plain(q, k, v, causal=causal,
                                             window=W)

            def library():
                if keep is not None:
                    return F.scaled_dot_product_attention(q, kx, vx,
                                                          attn_mask=keep)
                return F.scaled_dot_product_attention(q, kx, vx,
                                                      is_causal=causal)
            kx = k.repeat_interleave(H // KVH, dim=1)
            vx = v.repeat_interleave(H // KVH, dim=1)
            got = kernel()
            torch.cuda.synchronize()
            err, rel = _hold(f"flash {what}", got, plain(), dt)
            extra = {}
            if E % 64:
                e_err, e_rel = check_flash_edges(rng, H, KVH, S, T, E,
                                                 causal, dt, window=W)
                extra = dict(nan_padded_max_abs_err=e_err,
                             nan_padded_rel_err=e_rel)
                log(f"  B5 E={E} on NaN-padded operands into a "
                    f"sentinel-padded output {dt}: max|err| {e_err:.3e}, "
                    f"nothing written past E")
            if dt != "bfloat16":          # timed at the paths' dtype
                log(f"  B5 {what} {dt}: max|err| {err:.3e} (rel "
                    f"{rel:.3e})")
                continue
            times = measure(kernel, plain, library)
            flops, nbytes = flash_work(q, k, v, causal=causal, window=W)
            record(results, "B5 flash  ", kernel="flash_attention",
                   case=what, dtype=dt, err=err, rel_err=rel,
                   tol=KERNEL_TOL["float32"] if dt == "float32"
                   else "1 bf16 rounding",
                   nbytes=nbytes, flops=flops, times=times, **B5_MATH[dt],
                   **extra)


def check_mlp_families(results):
    """B6 at the audio and vlm paths' shapes, fp32 weights: hubert-xlarge's
    plain (ungated) tanh-gelu, D 1280, F 5120, at the prefill's 1024 rows,
    and llama-3.2-vision-11b's gated silu, D 4096, F 14336, at 1024 rows
    and a decode step's 4 rows (the rows kernel); then, at 1024 and 4 rows,
    the dense archs that phase 5 serves: gemma-7b's gated tanh-gelu,
    D 3072, F 24576, and minitron-8b's ungated relu², D 4096, F 16384.
    Beside each, the fp32 ``matmul`` + activation."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_plain
    from repro_torch.kernels.fused_mlp import work as mlp_work
    from repro_torch.models.common import is_gated
    rng = np.random.default_rng(29)
    for arch, rows_list in ((AUDIO_ARCH, (PREFILL_SEQ,)),
                            (VLM_ARCH, (PREFILL_SEQ, GEN_BATCH)),
                            (GEMMA_ARCH, (PREFILL_SEQ, GEN_BATCH)),
                            (MINITRON_ARCH, (PREFILL_SEQ, GEN_BATCH))):
        cfg = get_config(arch)
        D, F_ = cfg.d_model, cfg.d_ff
        gated = is_gated(cfg.activation)
        act = {"swiglu": "silu", "gelu": "gelu", "geglu": "gelu",
               "relu2": "relu2"}[cfg.activation]
        wg = _rand(rng, (D, F_), torch.float32, D ** -0.5) if gated else None
        wu = _rand(rng, (D, F_), torch.float32, D ** -0.5)
        wd = _rand(rng, (F_, D), torch.float32, F_ ** -0.5)
        for m in rows_list:
            for dt in ("float32", "bfloat16"):
                x = _rand(rng, (m, D), getattr(torch, dt))

                def kernel():
                    return fused_mlp(x, wg, wu, wd, activation=act)

                def plain():
                    return fused_mlp_plain(x, wg, wu, wd, activation=act)

                def library():
                    xf = x.float()
                    up = torch.matmul(xf, wu)
                    a = torch.matmul(xf, wg) if gated else up
                    a = (F.silu(a) if act == "silu"
                         else torch.relu(a).square() if act == "relu2"
                         else F.gelu(a, approximate="tanh"))
                    return torch.matmul(a * up if gated else a, wd)
                got = kernel()
                torch.cuda.synchronize()
                err, rel = _hold(f"fused_mlp {arch} M={m}", got, plain(), dt)
                if dt != "bfloat16":      # timed at the paths' dtype
                    log(f"  B6 {arch} M={m} {dt}: max|err| {err:.3e} (rel "
                        f"{rel:.3e})")
                    continue
                times = measure(kernel, plain, library)
                flops, nbytes = mlp_work(x, wg, wu, wd)
                record(results, "B6 mlp    ", kernel="fused_mlp",
                       case=f"{arch} {'gated ' if gated else ''}{act} "
                       f"M={m} D={D} F={F_}", dtype=dt, err=err,
                       rel_err=rel,
                       tol=KERNEL_TOL["float32"] if dt == "float32"
                       else "1 bf16 rounding",
                       nbytes=nbytes, flops=flops, times=times,
                       **b6_math(m, D, F_, gated, dt))


def _eager_times(kernel, plain):
    """The kernel's device and eager times; the plain version's eager time
    (Python loops over a chunk's steps and over chunks: the host issues
    its launches, so a CUDA graph of it would hold hundreds of nodes)."""
    return dict(ms=graph_ms(kernel), call_ms=cuda_ms(kernel),
                plain_ms=cuda_ms(plain, reps=2, warmup=1), library_ms=None)


def cuda_launches(fn, needle):
    """The CUDA kernels whose names contain ``needle`` that one call of
    ``fn`` launches, as ``torch.profiler`` traces them on the card.  ``fn``
    must launch no other kernel: a one-element add before and after it
    shows that the trace covered the call, and a trace that lost either
    (CUPTI can miss the first kernels it traces) is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    mark = torch.zeros(1, device="cuda")
    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mark.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            mark.add_(1)
            torch.cuda.synchronize()
        seen = [ev.name for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA]
        if sum(needle not in n for n in seen) == 2:
            return sum(needle in n for n in seen)
    raise AssertionError(("the trace lost its markers", needle, seen))


def check_rglru(results):
    """B8 at recurrentgemma-2b's prefill shape (B 1, S 4096, D 2560, also
    phase 11's training batch of one 4096-step sequence), bf16 and fp32,
    with and without an initial state; then long memory (Λ over
    [-12, -7], a from ~0.993 to ~0.99995: the carries between chunks decide
    the result), a sequence that is no multiple of ``CHUNK`` and one below
    a chunk.  y held as ``_hold`` holds an output, the fp32 final state
    within ``KERNEL_TOL``; a second call must repeat both bitwise; each
    record gives the CUDA launches of one call (two, one below a chunk).
    No one torch call computes the scan."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru import CHUNK, rglru, rglru_plain
    from repro_torch.kernels.rglru import work as rglru_work
    B, D = 1, get_config(HYBRID_ARCH).d_model
    rng = np.random.default_rng(24)
    a_param = _rand(rng, (D,), torch.float32)
    a_long = torch.from_numpy(np.random.default_rng(27).uniform(
        -12.0, -7.0, D).astype(np.float32)).cuda()
    h0 = _rand(rng, (B, D), torch.float32)
    cases = [(dt, HYBRID_SEQ, a_param, init, "")
             for dt in ("bfloat16", "float32") for init in (None, h0)]
    cases += [(dt, HYBRID_SEQ, a_long, h0, " long memory, Λ over [-12, -7]")
              for dt in ("bfloat16", "float32")]
    cases += [("bfloat16", HYBRID_SEQ - 27, a_param, h0,
               f" S no multiple of CHUNK {CHUNK}"),
              ("bfloat16", CHUNK - 27, a_param, h0,
               f" S below CHUNK {CHUNK}")]
    for dt, S, ap, init, what in cases:
        tdt = getattr(torch, dt)
        x, gr, gi = (_rand(rng, (B, S, D), tdt) for _ in range(3))

        def kernel():
            return rglru(x, gr, gi, ap, init)

        def plain():
            return rglru_plain(x, gr, gi, ap, init)
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            ("rglru does not repeat bitwise", dt, S, what)
        want = plain()
        err, rel = _hold("rglru y", got[0], want[0], dt)
        h_err, h_rel = _hold("rglru hT", got[1], want[1], "float32")
        launches = cuda_launches(kernel, "rglru_")
        assert launches == (2 if S > CHUNK else 1), ("rglru launches",
                                                     launches, S)
        times = _eager_times(kernel, plain)
        flops, nbytes = rglru_work(x, gr, gi, ap, init)
        record(results, "B8 rglru  ", kernel="rglru",
               case=f"{HYBRID_ARCH} B={B} S={S} D={D} "
               f"h0={'none' if init is None else 'given'}{what}", dtype=dt,
               err=err, rel_err=rel,
               tol=KERNEL_TOL["float32"] if dt == "float32"
               else "1 bf16 rounding", nbytes=nbytes,
               flops=flops, times=times, peak="float32",
               plain_timing="eager", state_max_abs_err=h_err,
               state_rel_err=h_rel, cuda_launches_per_call=launches,
               repeats_bitwise=True)


def check_wkv6(results):
    """B9 at rwkv6-7b's prefill shape (B 1, H 64, S 1024, E 64) on the
    model's layout (r, k, v, w as (B, H, S, E) views of (B, S, H, E)
    tensors), bf16 and fp32, with and without an initial state, and at
    phase 11's training batch (B 4, bf16, no initial state); y held as
    ``_hold`` holds an output, the fp32 final state within
    ``KERNEL_TOL``.  No one torch call computes the recurrence."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
    from repro_torch.kernels.rwkv6 import work as wkv6_work
    cfg = get_config(SSM_ARCH)
    B, S, H = 1, SSM_SEQ, cfg.n_heads
    E = cfg.d_model // H
    rng = np.random.default_rng(25)
    u = _rand(rng, (H, E), torch.float32, 0.1)
    s0 = _rand(rng, (B, H, E, E), torch.float32, 0.2)
    # the model's log decay: w_bias ~ -0.5 plus a small projection
    w = (_rand(rng, (B, S, H, E), torch.float32, 0.3) - 0.5).transpose(1, 2)
    # strong decays: w over [-8, 3], a step's decay from ~0.9997 to ~2e-9
    w_strong = torch.from_numpy(np.random.default_rng(26).uniform(
        -8.0, 3.0, (B, S, H, E)).astype(np.float32)).cuda().transpose(1, 2)
    w_train = (_rand(rng, (TRAIN_BATCH, S, H, E), torch.float32, 0.3)
               - 0.5).transpose(1, 2)
    for dt, B in (("bfloat16", 1), ("float32", 1),
                  ("bfloat16", TRAIN_BATCH)):
        tdt = getattr(torch, dt)
        r, k, v = (_rand(rng, (B, S, H, E), tdt, sc).transpose(1, 2)
                   for sc in (1.0, 0.3, 1.0))
        cases = ((("model", w, None), ("model", w, s0),
                  ("strong, w over [-8, 3]", w_strong, s0)) if B == 1
                 else (("model, training batch", w_train, None),))
        for decay, w_, init in cases:
            def kernel():
                return wkv6(r, k, v, w_, u, init)

            def plain():
                return wkv6_plain(r, k, v, w_, u, init)
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err, rel = _hold("wkv6 y", got[0], want[0], dt)
            s_err, s_rel = _hold("wkv6 sT", got[1], want[1], "float32")
            times = _eager_times(kernel, plain)
            # the fewest operations (``kernels/rwkv6.py::work``)
            flops, nbytes = wkv6_work(r, k, v, w_, u, init)
            record(results, "B9 wkv6   ", kernel="wkv6",
                   case=f"{SSM_ARCH} B={B} H={H} S={S} E={E} "
                   f"s0={'none' if init is None else 'given'} decay {decay}",
                   dtype=dt,
                   err=err, rel_err=rel,
                   tol=KERNEL_TOL["float32"] if dt == "float32"
                   else "1 bf16 rounding", nbytes=nbytes,
                   flops=flops, times=times, peak="float32",
                   plain_timing="eager", state_max_abs_err=s_err,
                   state_rel_err=s_rel)


# --------------------------------------------------------------------------
# phase 4: the HPC path
# --------------------------------------------------------------------------

def _rel_err(out, ref, scale_extra):
    """max over outputs of max |out - ref| / scale, scale = max(max |ref|,
    ``scale_extra``), but for a solution ``x<k>`` max |ref| alone: the
    floor (max |b|) serves outputs that a solver drives toward 0 (the
    residual) or that sit far below b by construction (a normalized
    vector); on a solution it would hide the error of an x much smaller
    than b, as a strongly diagonal system's is."""
    import re
    return max(max_err(out[k], ref[k])
               / max(float(ref[k].double().abs().max()),
                     0.0 if re.fullmatch(r"x\d+", k) else scale_extra,
                     1e-30)
               for k in ref)


def _compare(out, ref, scale_extra, dt, what):
    import torch
    for k in ref:
        assert bool(torch.isfinite(out[k]).all()), (what, k, "non-finite")
        assert tuple(out[k].shape) == tuple(ref[k].shape), (what, k)
    err = _rel_err(out, ref, scale_extra)
    assert err <= PATH_TOL[dt], (what, err, PATH_TOL[dt])
    return err


def _cut(t):
    """``t`` with fewer significant bits: fp32 rounded to TF32's 10-bit
    mantissa (to nearest, ties away, as ``cvt.rna.tf32.f32``), fp64 rounded
    to fp32."""
    import torch
    if t.dtype == torch.float64:
        return t.float().double()
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _sync_device(outs):
    """Wait for the card where any of ``outs`` (a dict of tensors) is on
    it."""
    import torch
    if any(v.is_cuda for v in outs.values()):
        torch.cuda.synchronize()


def lowered_reference(plan, feeds):
    """The reference backend's rules in the plan's order, with the float
    operands of every product (``matmul``, ``spmv``, ``einsum``) cut by
    ``_cut``: what the path would compute with TF32 products in fp32, or
    fp32 products in fp64."""
    from repro_torch.exec.base import plan_order, plan_program
    from repro_torch.exec.reference import eval_node
    program = plan_program(plan)
    vals = dict(feeds)
    for name in plan_order(plan):
        nd = program.nodes[name]
        ins = [vals[t] for t in nd.inputs]
        if nd.op in ("matmul", "spmv", "einsum"):
            ins = [_cut(v) if v.is_floating_point() else v for v in ins]
        vals[name] = eval_node(nd, ins)
    return {o: vals[o] for o in program.outputs}


def tolerance_control(plan, feeds, feeds_np, ref, scale_extra, dt, witness,
                      ref_value):
    """Hold the path's limits against a run known to compute in lower
    precision (``lowered_reference``): ``PATH_TOL`` must reject it; whether
    the path's witness (``ref_value``: the reference run's reading of it)
    rejects it too is reported."""
    low = lowered_reference(plan, feeds)
    _sync_device(low)
    err = _rel_err(low, ref, scale_extra)
    assert err > PATH_TOL[dt], ("PATH_TOL passes a lower-precision run",
                                dt, err, PATH_TOL[dt])
    value = witness.value(low, feeds_np)
    try:
        witness.check({"cuda": value, "reference": ref_value}, dt)
        rejected = False
    except AssertionError:
        rejected = True
    return {"control_rel_err": err, f"control_{witness.name}": value,
            "control_rejected_by_witness": rejected}


def hold_witness(plan, feeds, feeds_np, out, ref, scale_extra, dt,
                 witness):
    """The path's witness on its run and on the reference run, then
    ``tolerance_control``: the fields of the path's record."""
    rec = witness.check({tag: witness.value(o, feeds_np)
                         for tag, o in (("cuda", out), ("reference", ref))},
                        dt)
    rec.update(tolerance_control(plan, feeds, feeds_np, ref, scale_extra,
                                 dt, witness,
                                 rec[f"{witness.name}_reference"]))
    return rec


def run_timing(run, reps=RUN_REPS):
    """Warm, synchronized wall seconds per ``run()`` call (mean, min)."""
    import torch
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times), min(times)


def profile_fn(fn, top=4):
    """One call of ``fn`` under ``torch.profiler``: device kernel time (sum
    of kernel durations on the one stream), the profiled wall time, the
    busy share and the kernels that take the most device time.  The
    profiler slows the host side, so the share is a lower bound on the busy
    share of an unprofiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, t = per_name.get(ev.name, (0, 0.0))
            per_name[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    busy_us = sum(t for _n, t in per_name.values())
    if not per_name:
        return {"device_time": "not measured (no CUDA events)"}
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_busy_ms": busy_us / 1e3,
            "profiled_wall_ms": wall_us / 1e3,
            "busy_share": busy_us / wall_us,
            "top_kernels": [{"name": k[:60], "calls": n, "ms": t / 1e3}
                            for k, (n, t) in ranked]}


def drive_path(name, plan, feeds_np, dt, paths, seen, *, witness=None,
               replay=None, profile=False, walk_torch_ops=False):
    """One main path.  A Krylov path (and mttkrp) gives its ``witness``
    (``Witness``: the relative residual of a returned x, ...) and runs
    ``tolerance_control``; a sweep path gives ``replay``, a check of the
    outputs against a numpy replay.  ``walk_torch_ops``: the plan runs
    torch ops of its own beside the port's kernels (mttkrp's einsums).  Then
    ``check_dispatch`` holds run()'s one graph replay (``seen`` maps each
    plan to the float dtypes it has run in, one capture each).  Timed side
    by side: run() (one replay, feed copies and output clones included),
    the eager walk that the graph captures (what run() was before it
    dispatched one graph), ``cuda-perunit`` eagerly and that backend's run
    captured in one CUDA graph (the device time alone)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.frontends import feeds_from_numpy
    feeds = feeds_from_numpy(feeds_np, "cuda")
    kernels.reset_launches()
    out = plan.run(feeds)
    torch.cuda.synchronize()
    counts = kernels.launches()
    seen.setdefault(id(plan), set()).add(dt)
    ref = plan.run(feeds, backend="reference")
    torch.cuda.synchronize()
    b = feeds_np.get("b")
    scale_b = float(np.abs(b).max()) if b is not None else 0.0
    rel = _compare(out, ref, scale_b, dt, name)
    if witness is not None:
        extra = hold_witness(plan, feeds, feeds_np, out, ref, scale_b, dt,
                             witness)
    else:
        extra = replay(out, feeds_np)
    extra["dispatch"] = check_dispatch(name, plan, feeds, dt,
                                       len(seen[id(plan)]), walk_torch_ops)
    prog = plan.compiled()
    perunit = plan.compiled("cuda-perunit")
    mean_s, min_s = run_timing(lambda: plan.run(feeds))
    walk_mean, walk_min = run_timing(lambda: prog.walk(feeds))
    pu_mean, pu_min = run_timing(lambda: perunit(feeds))
    ref_mean, _ = run_timing(lambda: plan.run(feeds, backend="reference"),
                             max(1, RUN_REPS // 4))
    # cuda-perunit's run() captured in one CUDA graph: the device time
    # alone, i.e. what a run costs once every launch from the host is gone
    pu_graph = graph_ms(lambda: perunit(feeds), inner=1, reps=3)
    if profile:
        extra["profile"] = prof = profile_fn(lambda: plan.run(feeds))
        log(f"  {name} {dt} profiled: {json.dumps(prof)}")
    ep = plan.exec_plan
    paths.append(dict(path=name, dtype=dt, card=CARD, launches=counts,
                      max_rel_err_vs_reference=rel, units=len(ep.units),
                      rolled=(ep.roll.n_iters if ep.roll else 0),
                      run_ms=mean_s * 1e3, run_ms_min=min_s * 1e3,
                      walk_ms=walk_mean * 1e3, walk_ms_min=walk_min * 1e3,
                      perunit_ms=pu_mean * 1e3, perunit_ms_min=pu_min * 1e3,
                      perunit_graph_ms=pu_graph,
                      reference_run_ms=ref_mean * 1e3, **extra))
    log(f"  {name} {dt}: launches {counts}  max rel err vs reference "
        f"{rel:.3e}  {extra}  run() {mean_s * 1e3:.3f} ms (min "
        f"{min_s * 1e3:.3f}); eager walk {walk_mean * 1e3:.3f} (min "
        f"{walk_min * 1e3:.3f}); cuda-perunit {pu_mean * 1e3:.3f} (min "
        f"{pu_min * 1e3:.3f}), as one CUDA graph {pu_graph:.3f}; "
        f"reference run() {ref_mean * 1e3:.3f} ms")
    return counts


def api_calls(fn):
    """The host API calls that one call of ``fn`` makes, as
    ``torch.profiler`` names them: kernel launches (the CUDA C++ kernels'
    and Triton's), CUDA-graph launches and memcpys."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CPU]
    return {"kernel_launches": sum(n in KERNEL_LAUNCH_CALLS for n in names),
            "graph_launches": sum(n == "cudaGraphLaunch" for n in names),
            "memcpys": sum(n.startswith("cudaMemcpy") for n in names)}


def check_dispatch(name, plan, feeds, dt, traces, walk_torch_ops=False):
    """run()'s one dispatch on one path, against the eager walk that its
    graph captured (``CudaProgram.walk``): run 1 with the path's feeds and
    run 2 with other feeds (seed 1) each bitwise equal to the walk of their
    feeds, run 1's outputs unchanged by run 2, no capture in these runs
    and ``traces`` (one a signature) in all, ``dispatches == runs``, the
    launches of two runs twice the walk's (and ``EAGER_LAUNCHES`` where
    it lists the path), and a profiled warm run() making one graph launch and
    no kernel launch, where the walk's profile shows every launch it
    counts (the control: the profiler sees launches; ``walk_torch_ops``:
    the walk also launches torch's own kernels, the mesh's exchanges and
    scalar chains, so it shows at least the counted ones)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.frontends import feeds_from_numpy, make_feeds
    prog = plan.compiled()
    feeds2 = feeds_from_numpy(make_feeds(plan.trace.program, seed=1,
                                         dtype=getattr(np, dt)), "cuda")
    before = prog.stats
    with kernels.counting() as walked:
        eager = prog.walk(feeds)
    eager2 = prog.walk(feeds2)
    out1 = plan.run(feeds)
    kept = {k: v.clone() for k, v in out1.items()}
    out2 = plan.run(feeds2)
    torch.cuda.synchronize()
    for k in out1:
        assert torch.equal(out1[k], eager[k]), ("run() vs the eager walk",
                                                name, dt, k)
        assert torch.equal(out2[k], eager2[k]), ("run() vs the eager walk, "
                                                 "other feeds", name, dt, k)
        assert torch.equal(out1[k], kept[k]), ("run 2 changed run 1's "
                                               "outputs", name, dt, k)
    after = prog.stats
    grown = {key: after[key] - before[key]
             for key in ("runs", "traces", "dispatches")}
    per_run = {k: v for k, v in walked.items() if v}
    assert grown == {"runs": 2, "traces": 0, "dispatches": 2}, grown
    assert after["traces"] == traces, (name, dt, after, traces)
    assert after["dispatches"] == after["runs"], after
    assert {k: after["launches"][k] - before["launches"][k]
            for k in walked} == {k: 2 * v for k, v in walked.items()}, (
        name, dt, before, after, walked)
    want = EAGER_LAUNCHES.get((name, dt))
    assert want is None or per_run == want, (name, dt, per_run, want)
    run_calls = api_calls(lambda: plan.run(feeds))
    walk_calls = api_calls(lambda: prog.walk(feeds))
    assert run_calls["graph_launches"] == 1, run_calls
    assert run_calls["kernel_launches"] == 0, run_calls
    seen_launches = walk_calls["kernel_launches"]
    assert (seen_launches >= sum(per_run.values()) if walk_torch_ops
            else seen_launches == sum(per_run.values())), (
        "the profiler misses launches", walk_calls, per_run)
    rec = dict(launches_per_run=per_run, stats=after,
               api_calls_run=run_calls, api_calls_walk=walk_calls)
    log(f"  {name} {dt}: run() is one graph replay: bitwise equal to the "
        f"eager walk (two feed sets), run 1's outputs kept, stats {after} "
        f"(traces {traces}, dispatches == runs), launches per run "
        f"{per_run}; profiled run() {run_calls}, walk {walk_calls}")
    return rec


def check_two_threads(cases, reps=4):
    """Compiled ``cuda`` plans run at once, each ``reps`` times on a thread
    of its own and a CUDA stream of its own, released together by a
    barrier.  Each program's ``stats`` must grow by exactly ``reps`` times
    what one lone run of it adds (runs and launches per kernel), the
    process-wide counts by the sum, and every run's outputs must equal the
    lone run's bitwise.  Returns one record a plan."""
    import threading
    import torch
    from repro_torch import kernels
    from repro_torch.frontends import feeds_from_numpy

    def grown(before, after):
        return {**{key: after[key] - before[key]
                   for key in ("runs", "traces", "dispatches")},
                "launches": {k: after["launches"][k] - before["launches"][k]
                             for k in after["launches"]}}
    jobs = []
    for name, plan, feeds_np in cases:
        prog = plan.compiled()
        feeds = feeds_from_numpy(feeds_np, "cuda")
        before = prog.stats
        alone = plan.run(feeds)
        torch.cuda.synchronize()
        one = grown(before, prog.stats)
        assert one["runs"] == one["dispatches"] == 1, one
        assert sum(one["launches"].values()) > 0, one
        jobs.append(dict(name=name, plan=plan, prog=prog, feeds=feeds,
                         alone=alone, one=one))
    barrier = threading.Barrier(len(jobs))
    errors = []

    def work(job):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                barrier.wait()
                t0 = time.perf_counter()
                job["outs"] = [job["plan"].run(job["feeds"])
                               for _ in range(reps)]
                stream.synchronize()
                job["seconds"] = time.perf_counter() - t0
        except BaseException as exc:          # re-raised on the main thread
            errors.append(exc)
            barrier.abort()
    starts = [job["prog"].stats for job in jobs]
    g0 = kernels.launches()
    threads = [threading.Thread(target=work, args=(job,)) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    g1 = kernels.launches()
    records = []
    for job, start in zip(jobs, starts):
        got = grown(start, job["prog"].stats)
        want = {"runs": reps, "traces": 0, "dispatches": reps,
                "launches": {k: reps * v for k, v in
                             job["one"]["launches"].items()}}
        assert got == want, ("stats under two threads", job["name"], got,
                             want)
        for out in job["outs"]:
            for k, v in job["alone"].items():
                assert torch.equal(out[k], v), (job["name"], k)
        records.append(dict(path=job["name"], reps=reps, card=CARD,
                            launches_per_run=job["one"]["launches"],
                            stats_growth=got, thread_seconds=job["seconds"]))
    for k in g1:
        assert g1[k] - g0[k] == sum(r["stats_growth"]["launches"][k]
                                    for r in records), (k, g0, g1)
    log(f"  two threads, {reps} run()s each, at once: "
        + "; ".join(f"{r['path']}: stats grew by {r['reps']} runs and "
                    f"{sum(r['stats_growth']['launches'].values())} launches"
                    f", as {r['reps']} lone runs do, outputs bitwise equal "
                    f"to its lone run ({r['thread_seconds'] * 1e3:.1f} ms)"
                    for r in records)
        + "; process-wide counts grew by the sum")
    return records


def _f64(v):
    """An output as an fp64 numpy array: a torch tensor on any device, or
    an array of the JAX package's."""
    import numpy as np
    if hasattr(v, "detach"):
        return v.detach().double().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def _output(out, prefix):
    """The output whose name starts with ``prefix`` (x, v, lam, ...)."""
    return _f64(out[next(k for k in out if k.startswith(prefix))])


def _solution(out):
    return _output(out, "x")


def dense_residual(x, feeds_np):
    """‖b − A x‖ / ‖b‖ in numpy fp64."""
    import numpy as np
    A = feeds_np["A"].astype(np.float64)
    b = feeds_np["b"].astype(np.float64)
    return float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def sparse_residual(x, feeds_np):
    """‖b − A x‖ / ‖b‖ with A as a scipy CSR matrix, fp64."""
    import numpy as np
    import scipy.sparse as sps
    n = feeds_np["A.indptr"].shape[0] - 1
    A = sps.csr_matrix((feeds_np["A.data"].astype(np.float64),
                        feeds_np["A.indices"], feeds_np["A.indptr"]),
                       shape=(n, n))
    b = feeds_np["b"].astype(np.float64)
    return float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def rayleigh_gap(out, feeds_np):
    """Power iteration's returned x and lam = ‖A x_prev‖: (xᵀ A x − lam) /
    lam in numpy fp64.  For an SPD A it is at least 0 (the moments of x_prev
    under A are log-convex) and falls toward 0 as the iteration converges:
    9.06e-5 at n 4096 after 64 iterations (seed 0, numpy fp64)."""
    import numpy as np
    x = _solution(out)
    lam = float(_output(out, "lam"))
    A = feeds_np["A"].astype(np.float64)
    return float((x @ (A @ x) - lam) / lam)


def unit_norm_err(out, feeds_np):
    """GMRES's last Arnoldi vector v_m: |‖v_m‖₂ − 1| in numpy fp64."""
    import numpy as np
    return float(abs(np.linalg.norm(_output(out, "v")) - 1.0))


def einsum_rel_err(out, feeds_np):
    """MTTKRP's M1 and M2 against ``numpy.einsum`` in fp64 on the same
    feeds (M2 from numpy's M1): the larger of max |M − M_np| / max |M_np|
    over the two."""
    import numpy as np
    X, B, C = (feeds_np[k].astype(np.float64) for k in ("X", "B", "C"))
    m1 = np.einsum("ijk,jr,kr->ir", X, B, C, optimize=True)
    m2 = np.einsum("ijk,ir,kr->jr", X, m1, C, optimize=True)
    return max(float(np.abs(_f64(out[k]) - m).max() / np.abs(m).max())
               for k, m in (("M1", m1), ("M2", m2)))


def _residual_check(res, name="rel_residual"):
    """The cuda backend's run does as well as the reference's by the
    reading ``name``: both finite, below 1 in magnitude, and within
    ``RESIDUAL_GAP`` of each other."""
    import math
    assert all(math.isfinite(v) and abs(v) < 1.0 for v in res.values()), (
        name, res)
    assert abs(res["cuda"] - res["reference"]) <= RESIDUAL_GAP, (name, res)
    return {name: res["cuda"], f"{name}_reference": res["reference"]}


def _path_tol_check(name):
    """Both runs' reading ``name`` (an error) finite and within
    ``PATH_TOL`` at the path's dtype."""
    def check(res, dt):
        import math
        assert all(math.isfinite(v) and v <= PATH_TOL[dt]
                   for v in res.values()), (name, res, PATH_TOL[dt])
        return {name: res["cuda"], f"{name}_reference": res["reference"],
                f"{name}_tol": PATH_TOL[dt]}
    return check


class Witness(typing.NamedTuple):
    """A path's check beside ``PATH_TOL``: ``value(outputs, numpy feeds)``
    reads a run (outputs as torch tensors or numpy arrays), ``check({"cuda":
    value, "reference": value}, dtype)`` asserts and returns the record's
    fields, among them ``<name>_reference``."""
    name: str
    value: typing.Callable
    check: typing.Callable


def _gap(name):
    return lambda res, dt: _residual_check(res, name)


#: the relative residual of the solution x, within ``RESIDUAL_GAP`` of the
#: reference run's (cg, bicgstab; the sparse operators through scipy)
DENSE_RESIDUAL = Witness("rel_residual",
                         lambda out, f: dense_residual(_solution(out), f),
                         _gap("rel_residual"))
SPARSE_RESIDUAL = Witness("rel_residual",
                          lambda out, f: sparse_residual(_solution(out), f),
                          _gap("rel_residual"))
#: power iteration: lam against the Rayleigh quotient of the returned x,
#: the gap within ``RESIDUAL_GAP`` of the reference run's
RAYLEIGH = Witness("rayleigh_gap", rayleigh_gap, _gap("rayleigh_gap"))
#: gmres: ‖v_m‖ = 1 within ``PATH_TOL`` (h_{m,m-1} is held to the reference
#: run's by ``PATH_TOL`` itself)
UNIT_NORM = Witness("unit_norm_err", unit_norm_err,
                    _path_tol_check("unit_norm_err"))
#: mttkrp: M1, M2 against numpy's fp64 einsum within ``PATH_TOL``
NUMPY_EINSUM = Witness("numpy_einsum_rel_err", einsum_rel_err,
                       _path_tol_check("numpy_einsum_rel_err"))


#: the Krylov depths on the card where a longer one parts any two summation
#: orders (``scripts/krylov_sensitivity.py``: the CPU's plain versions
#: against the reference; the JAX package's reference against the port's
#: alike, ``tests/test_torch_full_paths.py``).  gmres's Arnoldi basis
#: amplifies a rounding difference about 2.6x a step: past ~8 steps no two
#: orders agree to ``PATH_TOL``, and at restart 32 the run is further from
#: the reference (fp32 1.5e-3, fp64 1.0e-4 of scale) than the TF32 /
#: fp32-cut control is (1.2e-3, 4.7e-5).  bicgstab_sparse on the 5-point
#: Laplacian, far from converged at n 2^20, parts them past ~12 iterations
#: (16: 3.5e-5 / 1.2e-13).  At the depths kept the plain versions read at
#: most a tenth of the limit, the control 4x the limit or more
GMRES_RESTART = 6
BICGSTAB_LAPLACIAN_ITERS = 8
#: phase 4's paths, in order: (workload, params, dtypes, witness; None: a
#: sweep path, held to a numpy replay).  The first three are also phase 3's
#: and phase 8's operands.  bicgstab, gmres (``GMRES_RESTART`` Arnoldi
#: steps, captured unrolled), power_iteration and
#: bicgstab_sparse (laplacian5 at phase 4's cg_sparse size; and the random,
#: nonsymmetric pattern it exists for, ~131 nonzeros a row) on B1 and B2,
#: the Laplacian's at ``BICGSTAB_LAPLACIAN_ITERS``;
#: mttkrp on no kernel of ours (two torch einsums, as the JAX package's
#: ``jnp`` units)
HPC_PATHS = (
    ("cg", dict(n=4096, iters=64), ("float32",), DENSE_RESIDUAL),
    ("cg_sparse", dict(n=1 << 20, iters=64, pattern="laplacian5"),
     ("float32", "float64"), SPARSE_RESIDUAL),
    ("jacobi2d", dict(n=4096, sweeps=8), ("float32",), None),
    ("bicgstab", dict(n=4096, iters=16), ("float32", "float64"),
     DENSE_RESIDUAL),
    ("gmres", dict(n=4096, restart=GMRES_RESTART), ("float32", "float64"),
     UNIT_NORM),
    ("power_iteration", dict(n=4096, iters=64), ("float32", "float64"),
     RAYLEIGH),
    ("mttkrp", dict(i=256, j=256, k=256, rank=64), ("float32", "float64"),
     NUMPY_EINSUM),
    ("bicgstab_sparse", dict(n=1 << 20, iters=BICGSTAB_LAPLACIAN_ITERS,
                             pattern="laplacian5"),
     ("float32", "float64"), SPARSE_RESIDUAL),
    ("bicgstab_sparse", dict(n=131072, iters=16, pattern="random",
                             density=1e-3), ("float32", "float64"),
     SPARSE_RESIDUAL),
)
#: the paths whose walk launches torch kernels of its own beside the
#: port's (``check_dispatch``'s ``walk_torch_ops``): mttkrp's two einsums,
#: and power_iteration's rolled loop, which seeds its output-only carry
#: (lam) with zeros (``exec/cuda.py``), one fill a walk
WALK_TORCH_OPS = ("mttkrp", "power_iteration")
#: the overbooked pair's workloads (phase 4, ``drive_overbooked``)
OB_WORKLOADS = ("cg_sparse", "jacobi_sparse")


def path_name(wl, params):
    """``cg_sparse(n=1048576, iters=64, laplacian5)``: a path's name in
    the records."""
    return f"{wl}(" + ", ".join(str(v) if k == "pattern" else f"{k}={v}"
                                for k, v in params.items()) + ")"


def jacobi_numpy(sweeps):
    def check(out, feeds_np):
        import numpy as np
        u, f = feeds_np["u0"], feeds_np["f"]
        for _ in range(sweeps):
            u = 0.25 * (np.roll(u, 1, 0) + np.roll(u, -1, 0)
                        + np.roll(u, 1, 1) + np.roll(u, -1, 1)) \
                + u.dtype.type(0.25) * f
        got = out[f"u{sweeps}"].cpu().numpy()
        assert np.array_equal(got, u), float(np.abs(got - u).max())
        return {"numpy_replay": "bitwise"}
    return check


def overbooked_plans(dtypes):
    """The overbooked cells' plans, ``{(workload, overbook, dtype): plan}``,
    and feeds, ``{(workload, dtype): feeds}``: cg_sparse and jacobi_sparse on
    one banded operand under a 40 MiB buffer, codesigned with
    ``overbook=0.25`` (a prefix pin) and 0 (the operand streams)."""
    import numpy as np
    from repro_torch.api import CodesignConfig, Session
    from repro_torch.frontends import make_feeds
    sess = Session(device="cuda", capacity_bytes=OB_CAPACITY)
    plans, feeds, made = {}, {}, {}
    for dt in dtypes:
        for wl, kw in (("cg_sparse", dict(iters=OB_CG_ITERS[dt])),
                       ("jacobi_sparse", dict(sweeps=OB_SWEEPS))):
            traced = sess.trace(workload=wl, n=OB_N, pattern="banded",
                                bandwidth=OB_BANDWIDTH, **kw)
            for overbook in (0.25, 0.0):
                key = (traced.shape_key, wl, overbook)
                if key not in made:
                    made[key] = traced.analyze().codesign(CodesignConfig(
                        overbook=overbook)).lower(backend="cuda")
                plan = plans[wl, overbook, dt] = made[key]
                sliced = [u for u in plan.exec_plan.units
                          if u.sp is not None and u.sp.slices]
                assert bool(sliced) == (overbook > 0), (
                    wl, overbook, "prefix pin expected only with overbook"
                    if overbook else "a prefix pin at overbook=0")
            feeds[wl, dt] = make_feeds(traced.program, seed=0,
                                       dtype=getattr(np, dt))
    return plans, feeds


def prefix_rows(plan) -> int:
    """The resident prefix (rows) that B3 keeps for the plan's spmv ops."""
    from repro_torch.exec.cuda import spmv_prefixes
    program = plan.trace.program
    rows = {r for u in plan.exec_plan.units if u.sp is not None
            for r in spmv_prefixes(program, u.sp).values() if r is not None}
    assert len(rows) == 1, rows
    return rows.pop()


def drive_overbooked(plans, feeds, dtypes, paths, seen, profile=False):
    """The overbooked cells through ``backend="cuda"``: B3 for every spmv
    op at overbook=0.25, B2 at 0, each run held as the other main paths
    are; launches per run() asserted, the two plans' times printed side by
    side, and both plans' graphs timed again with the persisting-L2
    set-aside raised toward the prefix's bytes (then restored).  The port
    itself leaves the set-aside as it finds it.  Returns the launch
    counts."""
    import numpy as np
    from repro_torch.frontends import feeds_from_numpy
    totals = {}
    l2_before = l2_state()
    for wl in OB_WORKLOADS:
        for dt in dtypes:
            cg = wl == "cg_sparse"
            steps = OB_CG_ITERS[dt] if cg else OB_SWEEPS
            n_spmv = steps + cg             # cg's r0 = b - A x0 adds one
            pre = prefix_rows(plans[wl, 0.25, dt])
            indptr = feeds[wl, dt]["A.indptr"]
            es = np.dtype(dt).itemsize
            resident = (4 + es) * int(indptr[pre])
            rows = {}
            for overbook in (0.25, 0.0):
                name = (f"{wl}(n={OB_N}, {'iters' if cg else 'sweeps'}="
                        f"{steps}, banded, bandwidth={OB_BANDWIDTH}) "
                        f"capacity 40 MiB overbook {overbook}")
                counts = drive_path(name, plans[wl, overbook, dt],
                                    feeds[wl, dt], dt, paths, seen,
                                    witness=SPARSE_RESIDUAL,
                                    profile=profile)
                want = ({"spmv_sliced": n_spmv, "spmv": 0} if overbook
                        else {"spmv_sliced": 0, "spmv": n_spmv})
                got = {k: counts[k] for k in want}
                assert got == want, (name, dt, got, want)
                assert l2_state() == l2_before, ("run() changed the L2 "
                                                 "set-aside", name)
                paths[-1].update(overbook=overbook, prefix_rows=(
                    pre if overbook else 0),
                    resident_bytes=resident if overbook else 0)
                rows[overbook] = paths[-1]
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
            dev_feeds = feeds_from_numpy(feeds[wl, dt], "cuda")
            want_aside = min(l2_before["max_persisting_bytes"], resident)
            with persisting_set_aside(want_aside) as aside:
                for overbook, row in rows.items():
                    perunit = plans[wl, overbook, dt].compiled(
                        "cuda-perunit")
                    row.update(set_aside_bytes=aside,
                               perunit_graph_ms_set_aside=graph_ms(
                                   lambda: perunit(dev_feeds), inner=1,
                                   reps=3))
            a, b = rows[0.25], rows[0.0]
            log(f"  {wl} {dt}: overbook 0.25 (B3, prefix {pre}/{OB_N} rows, "
                f"{resident / 1e6:.2f} MB resident) run() {a['run_ms']:.3f} "
                f"ms mean, {a['run_ms_min']:.3f} min, cuda-perunit "
                f"{a['perunit_graph_ms']:.3f} as one CUDA graph; overbook 0 "
                f"(B2) {b['run_ms']:.3f} mean, {b['run_ms_min']:.3f} min, "
                f"cuda-perunit {b['perunit_graph_ms']:.3f} as one CUDA "
                f"graph.  Persisting L2 "
                f"set-aside: in force {l2_before['persisting_bytes']} B "
                f"(could hold "
                f"{min(1.0, l2_before['persisting_bytes'] / resident):.3f} "
                f"of the prefix), largest {l2_before['max_persisting_bytes']}"
                f" B; raised to {aside} B (could hold "
                f"{min(1.0, aside / resident):.3f}): cuda-perunit graphs "
                f"{a['perunit_graph_ms_set_aside']:.3f} ms (0.25) and "
                f"{b['perunit_graph_ms_set_aside']:.3f} ms (0); the share "
                f"actually held is not measurable here (no L2 counters)")
    return totals


def drive_overbooked_batched(plans, feeds, dtypes, paths):
    """The overbooked cells batched: ``plan.batched(backend="cuda")
    .run_many`` of ``LANES`` requests (seeds 0-15; the operator from seed
    0) on each overbooked plan (B3's lane form) and on its overbook-0 twin
    (B2's).  Every lane is bitwise equal to its request's unbatched
    ``run()`` and finite; one capture and one graph replay a batch
    (``dispatches == batches``; for the overbooked plan a profiled warm
    batch with one graph launch and no kernel launch).  Timed: a warm
    batch from feeds on the card (``run_batch``) beside ``LANES``
    sequential ``run()`` and the overbook-0 plan's batch.  Returns the
    launch counts of the overbooked plans' first batches, each read just
    after it with the counts set to 0 just before."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.frontends import feeds_from_numpy, make_feeds
    totals = {}
    for wl in ("cg_sparse", "jacobi_sparse"):
        for dt in dtypes:
            prog = plans[wl, 0.25, dt].trace.program
            shared = {n: v for n, v in feeds[wl, dt].items()
                      if prog.nodes[n].op == "operator"}
            reqs = [make_feeds(prog, seed=s, dtype=getattr(np, dt),
                               only=[nd.name for nd in prog.leaves()
                                     if nd.op != "operator"])
                    for s in range(LANES)]
            dev_shared = feeds_from_numpy(shared, "cuda")
            dev_reqs = [feeds_from_numpy(r, "cuda") for r in reqs]
            stacked = {**dev_shared, **{n: torch.stack([r[n] for r in
                                                        dev_reqs])
                                         for n in dev_reqs[0]}}
            row = dict(path=f"{wl} overbooked, batched", dtype=dt,
                       card=CARD, lanes=LANES)
            for overbook in (0.25, 0.0):
                plan = plans[wl, overbook, dt]
                bp = plan.batched(backend="cuda")
                kernels.reset_launches()
                outs = bp.run_many(dev_reqs, dev_shared)
                torch.cuda.synchronize()
                counts = kernels.launches()
                lane_spmv = "spmv_sliced_lanes" if overbook else "spmv_lanes"
                other = "spmv_lanes" if overbook else "spmv_sliced_lanes"
                assert counts[lane_spmv] > 0 and counts[other] == 0, (
                    wl, dt, overbook, counts)
                if overbook:
                    for k, v in counts.items():
                        totals[k] = totals.get(k, 0) + v
                for i, (r, out) in enumerate(zip(dev_reqs, outs)):
                    one = plan.run({**dev_shared, **r})
                    for k in one:
                        assert torch.equal(out[k], one[k]), (
                            "lane vs run()", wl, dt, overbook, i, k)
                        assert bool(torch.isfinite(out[k]).all()), (
                            wl, dt, overbook, i, k)
                batch_s, batch_min = run_timing(
                    lambda: bp.run_batch(stacked))
                st, pst = bp.stats, bp.program_stats
                assert st["traces"] == 1 and pst["traces"] == 1, (st, pst)
                assert st["dispatches"] == pst["dispatches"] \
                    == pst["runs"] == RUN_REPS + 2, (st, pst)
                tag = "b3" if overbook else "b2"
                row.update({f"{tag}_batch_ms": batch_s * 1e3,
                            f"{tag}_batch_ms_min": batch_min * 1e3,
                            f"{tag}_launches_first_batch": {
                                k: v for k, v in counts.items() if v}})
                if overbook:
                    row["api_calls_batch"] = calls = api_calls(
                        lambda: bp.run_batch(stacked))
                    assert calls["graph_launches"] == 1, calls
                    assert calls["kernel_launches"] == 0, calls
                    seq_s, seq_min = run_timing(lambda: [
                        plan.run({**dev_shared, **r}) for r in dev_reqs],
                        max(1, RUN_REPS // 2))
                    row.update(sequential_ms=seq_s * 1e3,
                               sequential_ms_min=seq_min * 1e3,
                               prefix_rows=prefix_rows(plan))
            paths.append(row)
            log(f"  {wl} {dt} batched, {LANES} lanes: every lane bitwise "
                f"equal to its run(), one graph replay a batch; overbook "
                f"0.25 (B3 lanes) batch {row['b3_batch_ms']:.3f} ms (min "
                f"{row['b3_batch_ms_min']:.3f}), {LANES} sequential run() "
                f"{row['sequential_ms']:.3f} ms (min "
                f"{row['sequential_ms_min']:.3f}), overbook 0 (B2 lanes) "
                f"batch {row['b2_batch_ms']:.3f} ms (min "
                f"{row['b2_batch_ms_min']:.3f}); launches of the first "
                f"batch {row['b3_launches_first_batch']}")
    return totals


# --------------------------------------------------------------------------
# phase 8: the device mesh
# --------------------------------------------------------------------------

def mesh_plans(sess, designs):
    """The mesh paths' plans, ``{name: (mesh plan, unsharded plan)}``: cg,
    cg_sparse and jacobi2d at ``MESH_K`` shards from phase 4's codesign
    (``lower`` codesigns again at K x the capacity), cg at K=1, and the
    crossover cell: cg under ``CROSSOVER_CAPACITY``, where ``A`` streams at
    K=1 and pins at ``MESH_K``."""
    from repro_torch.api import Session
    plans = {}
    for name, (cd, single) in designs.items():
        plans[name] = (cd.lower(mesh=MESH_K, backend="cuda"), single)
    cg_cd, cg_single = designs["cg(n=4096, iters=64)"]
    plans["cg(n=4096, iters=64) K=1"] = (
        cg_cd.lower(mesh=1, backend="cuda"), cg_single)
    x_sess = Session(device="cuda", capacity_bytes=CROSSOVER_CAPACITY)
    x_cd = x_sess.trace(workload="cg", n=4096, iters=64).analyze() \
        .codesign()
    x_single = x_cd.lower(backend="cuda")
    x_mesh = x_cd.lower(mesh=MESH_K, backend="cuda")
    pins = {k: sorted(p.codesigned.best.schedule.pins)
            for k, p in ((1, x_single), (MESH_K, x_mesh))}
    log(f"  crossover, cg(n=4096) at {CROSSOVER_CAPACITY >> 20} MiB a slot: "
        f"K=1 pins {len(pins[1])} tensors, A {'pinned' if 'A' in pins[1] else 'streamed'}; "
        f"K={MESH_K} ({MESH_K * CROSSOVER_CAPACITY >> 20} MiB) pins "
        f"{len(pins[MESH_K])}: {pins[MESH_K]}, A "
        f"{'pinned' if 'A' in pins[MESH_K] else 'streamed'}")
    assert "A" not in pins[1] and "A" in pins[MESH_K], pins
    plans[f"cg(n=4096, iters=64) crossover {CROSSOVER_CAPACITY >> 20} MiB"] \
        = (x_mesh, x_single)
    return plans


def drive_mesh(name, plan, single, feeds_np, dt, paths, seen, *,
               witness=None, replay=None):
    """One mesh path: run() against the port's ``ShardedReference`` on the
    card (``PATH_TOL``) and numpy (the residual of x within
    ``RESIDUAL_GAP`` of the oracle's, with the lower-precision control, or
    a replay of the sweeps), ``check_dispatch`` (one graph replay a run,
    bitwise equal to the eager walk), then run(), the eager walk and the
    unsharded plan's run() timed side by side, and one profiled run()
    (device busy share, the kernels that take the most device time).
    Returns the launch counts of one run()."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.frontends import feeds_from_numpy
    feeds = feeds_from_numpy(feeds_np, "cuda")
    sharded = plan.sharded
    kernels.reset_launches()
    out = plan.run(feeds)
    torch.cuda.synchronize()
    counts = kernels.launches()
    seen.setdefault(id(plan), set()).add(dt)
    prog = plan.compiled()
    oracle = plan.compiled("reference")
    assert type(prog).__name__ == ("ShardedProgram" if sharded.n_shards > 1
                                   else "CudaProgram"), type(prog)
    assert type(oracle).__name__ == ("ShardedReference"
                                     if sharded.n_shards > 1
                                     else "function"), type(oracle)
    ref = plan.run(feeds, backend="reference")
    torch.cuda.synchronize()
    b = feeds_np.get("b")
    scale_b = float(np.abs(b).max()) if b is not None else 0.0
    rel = _compare(out, ref, scale_b, dt, name)
    if witness is not None:
        extra = hold_witness(plan, feeds, feeds_np, out, ref, scale_b, dt,
                             witness)
    else:
        extra = replay(out, feeds_np)
    extra["dispatch"] = check_dispatch(name, plan, feeds, dt,
                                       len(seen[id(plan)]),
                                       walk_torch_ops=True)
    mean_s, min_s = run_timing(lambda: plan.run(feeds))
    walk_mean, walk_min = run_timing(lambda: prog.walk(feeds))
    one_mean, one_min = run_timing(lambda: single.run(feeds))
    extra["profile"] = profile_fn(lambda: plan.run(feeds))
    pins = plan.codesigned.best.schedule.pins
    paths.append(dict(path=name, dtype=dt, card=CARD, shards=sharded.n_shards,
                      mesh=sharded.describe(), pins=len(pins),
                      operator_pinned="A" in pins, launches=counts,
                      max_rel_err_vs_sharded_reference=rel,
                      run_ms=mean_s * 1e3, run_ms_min=min_s * 1e3,
                      walk_ms=walk_mean * 1e3, walk_ms_min=walk_min * 1e3,
                      unsharded_run_ms=one_mean * 1e3,
                      unsharded_run_ms_min=one_min * 1e3, **extra))
    log(f"  {name} {dt} over {sharded.n_shards} slot(s): launches "
        f"{ {k: v for k, v in counts.items() if v} }  max rel err vs "
        f"ShardedReference {rel:.3e}  {extra}  run() {mean_s * 1e3:.3f} ms "
        f"(min {min_s * 1e3:.3f}); eager walk {walk_mean * 1e3:.3f} (min "
        f"{walk_min * 1e3:.3f}); unsharded run() {one_mean * 1e3:.3f} (min "
        f"{one_min * 1e3:.3f})")
    return counts


def check_mesh_of_one(plan, single, feeds_np):
    """K=1 is the unsharded plan: run() bitwise equal to the unsharded
    plan's run()."""
    import torch
    from repro_torch.frontends import feeds_from_numpy
    feeds = feeds_from_numpy(feeds_np, "cuda")
    a, b = plan.run(feeds), single.run(feeds)
    torch.cuda.synchronize()
    for k in b:
        assert torch.equal(a[k], b[k]), ("K=1 vs unsharded", k)
    log("  K=1: run() bitwise equal to the unsharded plan's run()")


# --------------------------------------------------------------------------
# phase 5: the LLM serving path
# --------------------------------------------------------------------------

class plain_kernels:
    """Within the block, every LLM kernel entry point (B5, B6, B7, B8, B9)
    is its plain version: the model imports each wrapper from its module
    at call time, so swapping the module attribute swaps the path.  Only
    this script does this; the package has no such switch."""

    def __enter__(self):
        from repro_torch.kernels import (flash_attention, fused_mlp, rglru,
                                         rmsnorm, rwkv6)
        self._saved = []
        for mod, name, plain in (
                (flash_attention, "flash_attention",
                 flash_attention.flash_attention_plain),
                (fused_mlp, "fused_mlp", fused_mlp.fused_mlp_plain),
                (rmsnorm, "rmsnorm", rmsnorm.rmsnorm_plain),
                (rglru, "rglru", rglru.rglru_plain),
                (rwkv6, "wkv6", rwkv6.wkv6_plain)):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


class compute_dtype:
    """Within the block, the models compute in ``dtype`` instead of bf16:
    each model module reads ``COMPUTE_DTYPE`` at call time, so swapping
    the module attribute swaps the activations' type.  Only this script
    does this (for the fp32 witness); the package has no such switch."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        from repro_torch.models import common, moe, recurrent, transformer
        self._saved = [(m, m.COMPUTE_DTYPE)
                       for m in (common, moe, recurrent, transformer)]
        for m, _ in self._saved:
            m.COMPUTE_DTYPE = self.dtype
        return self

    def __exit__(self, *exc):
        for m, dt in self._saved:
            m.COMPUTE_DTYPE = dt
        return False


def _sync_s(fn):
    """(result, wall seconds) of ``fn()`` ended by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _first_split(toks, toks_plain, plain_logits_at):
    """Tokens equal, or where they first part, the plain run's top-2 gap
    there within ``NEAR_TIE`` of its logits' scale (a near tie)."""
    import torch
    if torch.equal(toks, toks_plain):
        return {"tokens_equal": True}
    col = int((toks != toks_plain).any(0).nonzero()[0])
    lg = plain_logits_at(col)                    # (B, vocab) before col
    top2 = lg.topk(2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    scale = float(lg.abs().max())
    assert gap <= NEAR_TIE * scale, ("generated tokens part at", col,
                                     "top-2 gap", gap, "scale", scale)
    return {"tokens_equal": False, "first_split_col": col,
            "top2_gap": gap, "near_tie_limit": NEAR_TIE * scale}


def _decode_vs_prefill(bundle, params, cfg, gen_prompt):
    """Decode logits at the last prompt position vs prefill logits there,
    and, as a control, vs the prefill logits one position earlier, each
    over max |prefill logits| there."""
    from repro_torch.models import init_cache
    cache = init_cache(cfg, GEN_BATCH, GEN_PROMPT, device="cuda")
    for t in range(GEN_PROMPT):
        dec, cache = bundle.decode_fn(params, cache, gen_prompt[:, t:t + 1],
                                      t)
    pre = bundle.prefill_fn(params, gen_prompt)
    scale = float(pre[:, -1].abs().max())
    return (max_err(dec[:, -1], pre[:, -1]) / scale,
            max_err(dec[:, -1], pre[:, -2]) / scale)


def serve_witness(bundle, params, cfg, seq, llm_tol):
    """The second witness for a path held to more than ``LLM_TOL``: at a
    second prompt seed, the kernel run against the plain run in bf16
    (held to ``llm_tol``) and in fp32 activations (held to
    ``FP32_WITNESS_TOL``, with the bf16 kernel run against the fp32 plain
    run as the control it must reject); decode vs prefill in each, for
    both runs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq))).cuda()
    gen_prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))).cuda()

    def readings():
        logits = bundle.prefill_fn(params, prompt)
        dec, _ = _decode_vs_prefill(bundle, params, cfg, gen_prompt)
        with plain_kernels():
            plain = bundle.prefill_fn(params, prompt)
            dec_plain, _ = _decode_vs_prefill(bundle, params, cfg,
                                              gen_prompt)
        rel = max_err(logits, plain) / float(plain.abs().max())
        return logits, plain, dict(prefill_rel_err_vs_plain=rel,
                                   decode_vs_prefill_rel_err=dec,
                                   decode_vs_prefill_rel_err_plain=dec_plain)
    bf_logits, _, bf = readings()
    with compute_dtype(torch.float32):
        f32_logits, f32_plain, f32 = readings()
    control = (max_err(bf_logits, f32_plain)
               / float(f32_plain.abs().max()))
    out = dict(prompt_seed=1, bf16=bf, fp32=f32, fp32_tol=FP32_WITNESS_TOL,
               bf16_kernel_vs_fp32_plain_rel_err=control)
    log(f"  witness, prompt seed 1: bf16 prefill vs plain "
        f"{bf['prefill_rel_err_vs_plain']:.3e}, decode vs prefill "
        f"{bf['decode_vs_prefill_rel_err']:.3e} (plain run "
        f"{bf['decode_vs_prefill_rel_err_plain']:.3e}; tol {llm_tol:g}); "
        f"fp32 activations: prefill vs plain "
        f"{f32['prefill_rel_err_vs_plain']:.3e}, decode vs prefill "
        f"{f32['decode_vs_prefill_rel_err']:.3e} (plain run "
        f"{f32['decode_vs_prefill_rel_err_plain']:.3e}; tol "
        f"{FP32_WITNESS_TOL:g}; bf16 kernel run vs fp32 plain run "
        f"{control:.3e}, must exceed it)")
    assert bf["prefill_rel_err_vs_plain"] <= llm_tol, ("witness bf16", bf)
    assert bf["decode_vs_prefill_rel_err"] <= llm_tol, ("witness bf16", bf)
    assert max(f32.values()) <= FP32_WITNESS_TOL, ("witness fp32", f32)
    assert control > FP32_WITNESS_TOL, ("the fp32 witness limit passes the "
                                        "bf16 run", control)
    return out


def check_decode_graph(cfg, plan, params, gen_prompt, profile=False):
    """The graphed decode step against the eager donating step, step by
    step over the prompt, from two fresh caches: logits and every cache
    tensor bitwise equal at every step; then a profiled warm step makes
    one graph launch and no kernel launch beyond the tokens' copy and the
    position's fill."""
    import torch
    from repro_torch.launch import jit_decode_step, make_decode_fn
    from repro_torch.models import init_cache
    z = GEN_PROMPT + GEN_NEW
    step = jit_decode_step(cfg, plan, None, GEN_BATCH, z)
    eager = make_decode_fn(cfg, plan, donate=True)
    c_graph = init_cache(cfg, GEN_BATCH, z, device="cuda")
    c_eager = init_cache(cfg, GEN_BATCH, z, device="cuda")
    for t in range(GEN_PROMPT):
        tok = gen_prompt[:, t:t + 1]
        lg, _ = step(params, c_graph, tok, t)
        le, _ = eager(params, c_eager, tok, t)
        assert torch.equal(lg, le), ("graphed step vs eager", t)
        for a, b in zip(c_graph["layers"], c_eager["layers"]):
            for k in a:
                assert torch.equal(a[k], b[k]), ("cache", t, k)
    calls = api_calls(lambda: step(params, c_graph, gen_prompt[:, :1],
                                   GEN_PROMPT))
    assert calls["graph_launches"] == 1 and calls["kernel_launches"] <= 2, \
        calls
    assert step.stats == {"traces": 1, "dispatches": GEN_PROMPT + 1}, \
        step.stats
    out = dict(bitwise_steps=GEN_PROMPT, api_calls_step=calls)
    if profile:
        out["profile_decode_step_graph"] = profile_fn(
            lambda: step(params, c_graph, gen_prompt[:, :1], GEN_PROMPT),
            top=6)
    log(f"  graphed decode step bitwise equal to the eager donating step at "
        f"all {GEN_PROMPT} prompt steps (logits and cache); a warm step "
        f"makes {calls}")
    return out


class recorded_routes:
    """Within the block, every MoE layer's routing (``models.moe.route``)
    is kept, with the router's top-(k+1) probabilities (``probs``);
    ``dropped_share()`` is the share of (token, k) pairs past their
    expert's capacity.  Only this script does this."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._mod, self._route = moe, moe.route
        self.routes, self.probs = [], []

        def route(w_router, x, *, top_k, capacity_factor):
            r = self._route(w_router, x, top_k=top_k,
                            capacity_factor=capacity_factor)
            probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
            self.routes.append(r)
            self.probs.append(torch.topk(probs, top_k + 1, dim=-1).values)
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._mod.route = self._route
        return False

    def dropped_share(self):
        kept = sum(int(r.keep.sum()) for r in self.routes)
        total = sum(r.keep.numel() for r in self.routes)
        return 1.0 - kept / total, len(self.routes)


class replayed_routes:
    """Within the block, the MoE layers take the experts, slots and keep
    masks of ``routes`` (a run's, in layer order), and their gates from
    their own router probabilities at those experts: a run that computes
    the same function as the recorded one then differs from it by
    rounding alone.  Only this script does this."""

    def __init__(self, routes):
        self._routes = list(routes)

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._mod, self._route = moe, moe.route
        queue = iter(self._routes)

        def route(w_router, x, *, top_k, capacity_factor):
            rec = next(queue)
            probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
            gates = probs.gather(-1, rec.idx)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9)
            return moe.Routing(gates, rec.idx, rec.slot, rec.keep,
                               rec.capacity)
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._mod.route = self._route
        return False


def moe_witness(prefill, kernel_routes):
    """The MoE paths' witness that the kernel run differs from the plain
    run by routing alone: the plain run's prefill with its routes
    recorded; the kernel run's prefill with those routes replayed
    (``replayed_routes``) against it, held to ``LLM_TOL`` with the
    shifted-position control that must fail it; and where the kernel
    run's own routes first part from the plain run's, the layer, the
    tokens and the plain run's probability gap between its k-th and
    (k+1)-th expert at those tokens (a near tie reorders)."""
    import torch
    with plain_kernels(), recorded_routes() as plain:
        logits_plain = prefill()
    with replayed_routes(plain.routes):
        routed = prefill()
    scale = float(logits_plain.abs().max())
    rel = max_err(routed, logits_plain) / scale
    control = max_err(routed[:, 1:], logits_plain[:, :-1]) / scale
    out = dict(routed_rel_err_vs_plain=rel,
               routed_shifted_rel_err=control, llm_tol=LLM_TOL)
    for layer, (a, b) in enumerate(zip(kernel_routes.routes, plain.routes)):
        # the sets of experts: an order swap within a token's top-k moves
        # no pair (each expert counts its own earlier pairs)
        parted = (a.idx.sort(-1).values != b.idx.sort(-1).values).any(-1)
        if bool(parted.any()):
            gaps = (plain.probs[layer][:, -2] - plain.probs[layer][:, -1])
            out.update(first_parting_layer=layer,
                       parting_tokens=int(parted.sum()),
                       parting_max_gap=float(gaps[parted].max()),
                       median_gap=float(gaps.median()))
            break
    else:
        out["first_parting_layer"] = None
    parting = {k: v for k, v in out.items()
               if k.startswith(("first_", "parting_", "median_"))}
    log(f"  MoE witness: the kernel run with the plain run's routes "
        f"replayed, prefill logits vs the plain run: rel err {rel:.3e} "
        f"(tol {LLM_TOL:g}; shifted one position {control:.3e}, must "
        f"exceed it); the kernel run's own routes against the plain "
        f"run's: {parting}")
    assert rel <= LLM_TOL, ("MoE prefill with replayed routes", rel)
    assert control > LLM_TOL, ("the LLM limit passes shifted logits",
                               control)
    return out


def _decode_vs_plain(bundle, params, cfg, gen_prompt):
    """Decode logits at the last prompt position, the kernel run's against
    the plain run's there, and, as a control, against the plain run's one
    position earlier, each over max |plain logits| there."""
    from repro_torch.models import init_cache

    def last_two():
        cache = init_cache(cfg, GEN_BATCH, GEN_PROMPT, device="cuda")
        out = []
        for t in range(GEN_PROMPT):
            dec, cache = bundle.decode_fn(params, cache,
                                          gen_prompt[:, t:t + 1], t)
            out = (out + [dec[:, -1]])[-2:]
        return out
    prev, last = last_two()
    with plain_kernels():
        prev_plain, last_plain = last_two()
    scale = float(last_plain.abs().max())
    return (max_err(last, last_plain) / scale,
            max_err(last, prev_plain) / scale)


def drive_serving(arch, seq, layer_kind, want_prefill, tols, results_paths,
                  profile=False, *, n_layers=None, stub=None,
                  decode_check="prefill"):
    """One serving path at full width through ``Session(arch) ->
    trace("prefill", seq=seq, layer_kind=layer_kind) -> ... -> serve()``:
    a 1 x ``seq`` prefill and ``generate``, the launches of each held to
    ``want_prefill`` and its decode-step twin, against the same run on the
    plain versions within ``tols`` (the LLM and decode limits).  Returns
    the launch counts of the kernel run (prefill + generate); frees the
    model before it returns.

    ``n_layers`` cuts the arch's depth (its widths stay); ``stub`` names
    the family's stubbed input, ``"frames"`` or ``"img"``, made on the
    card from a seeded generator; ``decode_check`` holds the decode step
    against the prefill (``"prefill"``) or against the plain versions'
    step (``"plain"``), and ``None`` (an encoder-only arch) runs no
    decode.  An MoE path also prints the share of (token, k) pairs that
    its prefill dropped at capacity."""
    llm_tol, decode_tol = tols
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.launch import greedy_generate
    from repro_torch.models import init_cache, init_params
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        log(f"  {arch}: depth cut to {n_layers} of {cfg.n_layers} layers, "
            "every width as published")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    plan = (Session(cfg, device="cuda")
            .trace("prefill", batch=1, seq=seq, layer_kind=layer_kind)
            .analyze().codesign().lower())
    p = plan.plan
    assert p.use_fused_rmsnorm and (cfg.is_moe or p.use_fused_mlp), p
    assert p.use_flash_attention == (want_prefill["flash_attention"] > 0), p
    log(f"  plan: {plan!r} ({p.notes}), made in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _sync_s(lambda: init_params(cfg, seed=0, device="cuda"))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B fp32 parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB) made in "
        f"{init_s:.2f} s")
    bundle = plan.serve()
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq))).cuda()
    gen_prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))).cuda()
    from repro_torch.launch.train import stub_inputs
    stubbed = stub_inputs(cfg, 1, seq, 7, "cuda")
    assert set(stubbed) == ({stub} if stub else set()), (stub, stubbed)
    decodes = decode_check is not None
    steps = GEN_PROMPT + GEN_NEW - 1

    def prefill():
        return bundle.prefill_fn(params, prompt, **stubbed)

    # the kernel run, counted
    kernels.reset_launches()
    logits, first_prefill_s = _sync_s(prefill)
    per_prefill = kernels.launches()
    assert {k: per_prefill[k] for k in want_prefill} == want_prefill, \
        per_prefill
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    assert logits.shape == (1, seq, cfg.padded_vocab)
    counts = dict(per_prefill)
    out = dict(path=f"serve {cfg.name} prefill 1x{seq}"
               + (f" ({stub} stubbed)" if stub else ""),
               layers=cfg.n_layers, n_params=n_params,
               plan=dataclasses.asdict(p),
               launches_per_prefill={k: per_prefill[k]
                                     for k in want_prefill},
               first_prefill_ms=first_prefill_s * 1e3)
    if cfg.is_moe:
        with recorded_routes() as routes:
            prefill()
        share, layers = routes.dropped_share()
        out["prefill_dropped_share"] = share
        log(f"  MoE prefill 1x{seq}: {share:.4%} of the (token, k) pairs "
            f"dropped at capacity over its {layers} MoE layers (capacity "
            f"factor {p.moe_capacity_factor}, {cfg.n_experts} experts, "
            f"top-{cfg.top_k})")
    if decodes:
        step = bundle.jit_decode(None, GEN_BATCH, GEN_PROMPT + GEN_NEW)

        def gen():            # one CUDA-graph replay a decode step
            return bundle.generate(params, gen_prompt, GEN_NEW)

        def eager_gen():      # the same steps launched from the host
            return greedy_generate(params, cfg, p, gen_prompt, GEN_NEW)
        kernels.reset_launches()
        toks, first_gen_s = _sync_s(gen)
        per_gen = kernels.launches()
        counts = {k: per_prefill[k] + per_gen[k] for k in per_prefill}
        want_step = {k: (n if k in ("fused_mlp", "rmsnorm") else 0)
                     for k, n in want_prefill.items()}
        got_step = {k: per_gen[k] / steps for k in want_step}
        assert got_step == want_step, per_gen
        assert step.stats == {"traces": 1, "dispatches": steps}, step.stats
        toks_eager = eager_gen()
        assert torch.equal(toks, toks_eager), ("graphed generate vs eager",
                                               toks, toks_eager)
        graph_check = check_decode_graph(cfg, p, params, gen_prompt, profile)
        assert toks.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
        assert bool((toks[:, GEN_PROMPT:] < cfg.padded_vocab).all())
        log(f"  launches per prefill {want_prefill}, per decode step "
            f"{want_step} (as expected; {steps} decode steps per generate)")
    else:
        log(f"  launches per prefill {want_prefill} (as expected; "
            f"{cfg.name} is encoder-only: no decode)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def decode_vs():
        if decode_check == "prefill":
            return _decode_vs_prefill(bundle, params, cfg, gen_prompt)
        return _decode_vs_plain(bundle, params, cfg, gen_prompt)
    if decodes:
        dec_err, dec_control = decode_vs()

    # timing, warm
    pre_times = [_sync_s(prefill)[1] for _ in range(3)]
    prefill_s = min(pre_times)
    if decodes:
        gen_times = [_sync_s(gen)[1] for _ in range(2)]
        eager_times = [_sync_s(eager_gen)[1] for _ in range(2)]
        gen_s = min(gen_times)
        step_s, eager_step_s = gen_s / steps, min(eager_times) / steps
        # a second and third generate captured nothing: one replay a step
        assert step.stats == {"traces": 1, "dispatches": 3 * steps}, \
            step.stats

    # the same on the plain versions
    with plain_kernels():
        kernels.reset_launches()
        logits_plain, plain_prefill_s = _sync_s(prefill)
        if decodes:
            toks_plain, plain_gen_s = _sync_s(eager_gen)
            if decode_check == "prefill":
                plain_dec_err, _ = decode_vs()
        plain_launches = {k: kernels.launches()[k] for k in want_prefill}
    scale = float(logits_plain.abs().max())
    rel = max_err(logits, logits_plain) / scale
    rel_control = max_err(logits[:, 1:], logits_plain[:, :-1]) / scale
    agree = (logits.argmax(-1) == logits_plain.argmax(-1)).float().mean()
    smi = smi_line()
    out.update(
        nvidia_smi=smi, launches=counts,
        prefill_ms=prefill_s * 1e3,
        prefill_ms_all=[t * 1e3 for t in pre_times],
        prefill_tokens_per_s=seq / prefill_s,
        plain_prefill_ms=plain_prefill_s * 1e3,
        prefill_rel_err_vs_plain=rel, llm_tol=llm_tol,
        prefill_vs_next_position_rel_err=rel_control,
        prefill_argmax_agreement=float(agree), peak_memory_gb=peak_gb)
    log(f"  {cfg.name} on {smi}: prefill 1x{seq} {prefill_s * 1e3:.1f} ms "
        f"({seq / prefill_s:.0f} tokens/s; plain versions "
        f"{plain_prefill_s * 1e3:.1f} ms)")
    log(f"  prefill logits vs the plain run: rel err {rel:.3e} ("
        + ("routes free: held through the MoE witness below"
           if cfg.is_moe else f"tol {llm_tol:g}")
        + f"; shifted one position: {rel_control:.3e}, must exceed "
        f"{llm_tol:g}), argmax agreement {float(agree):.4f}; peak memory "
        f"{peak_gb:.1f} GB")
    if decodes:
        def plain_logits_at(col):
            with plain_kernels():
                c = init_cache(cfg, GEN_BATCH, GEN_PROMPT + GEN_NEW,
                               device="cuda")
                lg = None
                for t in range(col):
                    lg, c = bundle.decode_fn(params, c,
                                             toks_plain[:, t:t + 1], t)
            return lg[:, -1]

        split = _first_split(toks, toks_plain, plain_logits_at)
        out["path"] += (f", generate {GEN_BATCH}x({GEN_PROMPT}+{GEN_NEW})")
        out.update(
            launches_per_decode_step=got_step,
            decode_ms_per_step=step_s * 1e3,
            decode_tokens_per_s=GEN_BATCH / step_s,
            eager_decode_ms_per_step=eager_step_s * 1e3,
            eager_decode_tokens_per_s=GEN_BATCH / eager_step_s,
            decode_step_stats=step.stats, decode_graph=graph_check,
            generate_ms=gen_s * 1e3, first_generate_ms=first_gen_s * 1e3,
            plain_generate_ms=plain_gen_s * 1e3, decode_check=decode_check,
            decode_tol=decode_tol, **split)
        if decode_check == "prefill":
            out.update(decode_vs_prefill_rel_err=dec_err,
                       decode_vs_prefill_rel_err_plain=plain_dec_err,
                       decode_vs_previous_position_rel_err=dec_control)
            dec_text = (f"decode vs prefill logits at the last prompt "
                        f"position: rel err {dec_err:.3e} (plain run "
                        f"{plain_dec_err:.3e}, tol {decode_tol:g}; against "
                        f"the position before: {dec_control:.3e}, must "
                        "exceed it)")
        else:
            out.update(decode_vs_plain_rel_err=dec_err,
                       decode_vs_plain_previous_position_rel_err=dec_control)
            dec_text = (f"decode logits at the last prompt position vs the "
                        f"plain run's step: rel err {dec_err:.3e} (tol "
                        f"{decode_tol:g}; against its position before: "
                        f"{dec_control:.3e}, must exceed it)")
        log(f"  decode {step_s * 1e3:.2f} ms per step at batch {GEN_BATCH} "
            f"({GEN_BATCH / step_s:.1f} tokens/s), one CUDA-graph replay a "
            f"step (stats {step.stats}); the eager step "
            f"{eager_step_s * 1e3:.2f} ms ({GEN_BATCH / eager_step_s:.1f} "
            f"tokens/s, tokens equal); plain generate "
            f"{plain_gen_s * 1e3:.0f} ms against {gen_s * 1e3:.0f} ms; "
            f"generated tokens {split}; {dec_text}")
    if profile:
        out["profile_prefill"] = profile_fn(prefill, top=6)
        if decodes:
            c0 = init_cache(cfg, GEN_BATCH, GEN_PROMPT + GEN_NEW,
                            device="cuda")
            out["profile_decode_step"] = profile_fn(
                lambda: bundle.decode_fn(params, c0, gen_prompt[:, :1], 0),
                top=6)
    results_paths.append(out)
    assert not any(plain_launches.values()), plain_launches
    # an MoE path's own routes are data (FAMILY_PATHS): its logits are
    # held with the plain run's routes replayed, by moe_witness below
    assert cfg.is_moe or rel <= llm_tol, ("prefill logits vs the plain "
                                          "run", rel)
    assert rel_control > llm_tol, ("the LLM limit passes shifted logits",
                                   rel_control)
    if decodes:
        assert dec_err <= decode_tol, ("decode logits", decode_check,
                                       dec_err)
        assert dec_control > decode_tol, ("the decode limit passes the "
                                          "wrong position", dec_control)
    del logits, logits_plain
    if cfg.is_moe:
        out["witness"] = moe_witness(prefill, routes)
    elif llm_tol > LLM_TOL or decode_tol > DECODE_TOL:
        out["witness"] = serve_witness(bundle, params, cfg, seq,
                                       max(llm_tol, decode_tol))
    del params
    torch.cuda.empty_cache()
    return counts


def check_codesign_cache(results_paths):
    """A cold ``Session(device="cuda", cache_dir=d)`` and then a fresh one
    on the same directory codesign cg(n=4096, iters=64): the second
    replays the first's search (``from_cache``), its plan equals the
    first's field for field, and its ``run()`` on the same feeds is bitwise
    the first's (the same plan gives the same graph).  Prints both
    ``codesign()`` times.  Returns the launch counts of the two runs."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.api.cache import cache_disabled_by_env
    from repro_torch.frontends import make_feeds
    from repro_torch.kernels import build
    assert not cache_disabled_by_env(), "CELLO_NO_CACHE turns the cache off"
    runs = []
    with tempfile.TemporaryDirectory(dir=build.build_dir()) as d:
        for _ in range(2):
            traced = Session(device="cuda", cache_dir=d).trace(
                workload="cg", n=4096, iters=64)
            t0 = time.perf_counter()
            designed = traced.codesign()
            codesign_s = time.perf_counter() - t0
            runs.append((traced, designed, designed.lower(backend="cuda"),
                         codesign_s))
        entries = sorted(os.listdir(d))
        entry_bytes = sum(os.path.getsize(os.path.join(d, e))
                          for e in entries)
    (ta, cold, pa, cold_s), (tb, warm, pb, warm_s) = runs
    assert not cold.from_cache and warm.from_cache, (cold, warm)
    assert len(entries) == 1 and entries[0].endswith(".json"), entries
    sa, sb = cold.best.schedule, warm.best.schedule
    assert sa == sb and cold.best.report == warm.best.report
    assert cold.best.metrics == warm.best.metrics
    assert cold.split_sweep == warm.split_sweep
    assert pa.plan == pb.plan and pa.group_kernels == pb.group_kernels
    assert pa.exec_plan == pb.exec_plan
    rep_a, rep_b = pa.report(), pb.report()
    assert rep_a.pop("from_cache") is False and rep_b.pop("from_cache")
    assert rep_a == rep_b
    feeds = make_feeds(ta.program, seed=0, dtype=np.float32)
    kernels.reset_launches()
    out_a = pa.run(feeds)
    out_b = pb.run(feeds)
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), ("warm run() vs cold", k)
    assert pa.compiled() is not pb.compiled()
    smi = smi_line()
    results_paths.append(dict(
        path="codesign cache cg(n=4096, iters=64) float32", nvidia_smi=smi,
        cold_codesign_s=cold_s, warm_codesign_s=warm_s,
        entry_bytes=entry_bytes, warm_from_cache=True,
        run_bitwise_equal=True, launches=counts))
    log(f"  on {smi}: codesign() cold {cold_s:.3f} s (searched, "
        f"{entry_bytes} B published), warm {warm_s:.3f} s (from_cache="
        f"{warm.from_cache}); the warm plan equals the cold one field for "
        f"field (schedule, report, split sweep, CelloPlan, group kernels, "
        f"execution plan) and its run() is bitwise the cold plan's on "
        f"the same feeds ({sorted(out_a)}), each its own CUDA program")
    return counts


# --------------------------------------------------------------------------
# phase 7: solver serving
# --------------------------------------------------------------------------

#: lanes of the lane forms' checks against their plain versions
LANES = 16
#: lane counts at which phase 7 holds B1's and B2's lane forms bitwise,
#: lane by lane, against the single-request kernels: one lane, a part of a
#: group, a whole group and a ragged second group
LANE_COUNTS = (1, 5, 16, 17)
#: the served buckets, phase 4's shapes: (workload, params, dtype,
#: max_batch_size of their server).  fp32 cg runs 32 iterations: its
#: operator is well conditioned, so rs leaves fp32's range before
#: iteration 64 (rs = 0, then beta = 0/0 = NaN): in the JAX package's
#: reference for every seed, in the port's for seeds 6, 11, 19, 21, 24 and
#: 34 of 0-36 (``tests/test_torch_serve.py::
#: test_fp32_cg_at_the_served_size_breaks_down_by_64_iterations``)
SERVE_BUCKETS = (
    ("cg", dict(n=4096, iters=32), "float32", 16),
    ("cg_sparse", dict(n=1 << 20, iters=64, pattern="laplacian5"),
     "float32", 16),
    ("cg_sparse", dict(n=1 << 20, iters=64, pattern="laplacian5"),
     "float64", 16),
    ("jacobi2d", dict(n=4096, sweeps=8), "float32", 4),
)
#: each bucket's bursts to a paused server: seeds 0-31, then 32-36 (a
#: batch of 5, padded to 8 lanes, at max_batch_size 16; 4 + 1 at 4)
SERVE_BURSTS = (range(32), range(32, 37))
SERVE_WAIT_US = 2000
#: a lane against its request's unbatched run() where the two are not
#: bitwise equal: the JAX package's serving tolerance (rtol, atol), as
#: ``tests/test_serve.py`` holds its batched solves
SERVE_TOL = {"float32": (1e-4, 1e-5), "float64": (1e-9, 1e-12)}


def _bucket_name(wl, params, dt):
    args = ", ".join(f"{k}={v}" for k, v in params.items())
    return f"{wl}({args}) {dt}"


def _pool_map(fn, items):
    """``fn`` over ``items`` on the host's cores (numpy's random draws,
    copies and ufuncs release the GIL on large arrays)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        return list(ex.map(fn, items))


def _lane_vs_single(lane, single, dt):
    """'bitwise', or the largest |Δ| / (atol + rtol |single|) when the two
    differ (which must stay within ``SERVE_TOL``)."""
    import torch
    if all(torch.equal(lane[k], single[k]) for k in single):
        return "bitwise", 0.0
    rtol, atol = SERVE_TOL[dt]
    worst = max(float(((lane[k].double() - single[k].double()).abs()
                       / (atol + rtol * single[k].double().abs())).max())
                for k in single)
    assert worst <= 1.0, ("a lane left SERVE_TOL of its unbatched run()",
                          dt, worst)
    return "serve_tol", worst


def _latencies(lat):
    import numpy as np
    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def drive_solver_serving(results, paths):
    """Phase 7: the buckets of ``SERVE_BUCKETS`` served through
    ``Server(PlanRouter(Session(device="cuda")), ServeConfig(...))`` with
    ``backend="cuda"``; returns the lane kernels' launches while the
    bursts were served."""
    import numpy as np
    import torch
    from repro_torch import kernels, obs
    from repro_torch.api import ServeConfig, Session
    from repro_torch.frontends import make_feeds
    from repro_torch.serve import PlanRouter, Server, request
    from repro_torch.testing import faults

    sess = Session(device="cuda")
    routers = {mbs: PlanRouter(sess) for mbs in {b[3] for b in
                                                  SERVE_BUCKETS}}
    t0 = time.perf_counter()
    feeds = {}                     # bucket -> [per-request numpy feeds]
    for wl, params, dt, mbs in SERVE_BUCKETS:
        key = request(wl, dtype=dt, backend="cuda", **params).bucket()
        program = sess.trace(workload=wl, **params).program
        leaves = [nd.name for nd in program.leaves() if nd.op != "operator"]
        feeds[key] = _pool_map(
            lambda s: make_feeds(program, seed=s, dtype=getattr(np, dt),
                                 only=leaves),
            range(max(SERVE_BURSTS[-1]) + 1))
    log(f"  per-request feeds made in {time.perf_counter() - t0:.1f} s "
        "(the requests carry them)")

    def req(wl, params, dt, s, **kw):
        key = request(wl, dtype=dt, backend="cuda", **params).bucket()
        return request(wl, dtype=dt, backend="cuda", seed=s,
                       feeds=feeds[key][s], **params, **kw)

    # a client thread replays another plan's graph the whole time the
    # worker captures the cold buckets: every run must stay bitwise
    # equal to the first (the program lock, the event after copy-out and
    # thread_local capture mode at work)
    client_plan = sess.trace(workload="cg", n=1024, iters=8).codesign() \
        .lower(backend="cuda")
    client_feeds = make_feeds(client_plan.trace.program, seed=1)
    client_want = client_plan.run(client_feeds)
    torch.cuda.synchronize()
    client = {"runs": 0, "errors": []}
    stop = threading.Event()

    def client_loop():
        try:
            while not stop.is_set():
                got = client_plan.run(client_feeds)
                torch.cuda.current_stream().synchronize()
                assert all(torch.equal(got[k], client_want[k])
                           for k in client_want), "client run changed"
                client["runs"] += 1
        except Exception as e:          # noqa: BLE001 — reported below
            client["errors"].append(repr(e))

    # ---- the bursts, each to a paused server (one per max_batch_size)
    served = {}                    # bucket -> {seed: SolveResult}
    batches = {}                   # bucket label -> batches served
    kernels.reset_launches()
    t0 = time.perf_counter()
    client_before = client_plan.compiled().stats["launches"]
    client_thread = threading.Thread(target=client_loop)
    client_thread.start()
    for seeds in SERVE_BURSTS:
        for mbs, router in routers.items():
            srv = Server(router, ServeConfig(max_batch_size=mbs,
                                             max_wait_us=SERVE_WAIT_US,
                                             autostart=False))
            futs = {}
            for bi, (wl, params, dt, m) in enumerate(SERVE_BUCKETS):
                if m == mbs:
                    futs[bi] = [(s, srv.submit(req(wl, params, dt, s)))
                                for s in seeds]
            srv.start()
            for b, fs in futs.items():
                out = served.setdefault(b, {})
                for s, f in fs:
                    out[s] = f.result(timeout=600)
            st = srv.stats()
            srv.close()
            for lb, bst in st["buckets"].items():
                batches[lb] = batches.get(lb, 0) + bst["batches"]
    stop.set()
    client_thread.join()
    torch.cuda.synchronize()
    counts = kernels.launches()
    client_after = client_plan.compiled().stats["launches"]
    for k in counts:                   # the client's replays are not served
        counts[k] -= client_after[k] - client_before[k]
    assert not client["errors"], client["errors"]
    assert client["runs"] > 0, "the client thread never ran"
    log(f"  bursts of 32 and 5 served in {time.perf_counter() - t0:.1f} s "
        f"(cold: plans, uploads, captures) while a client thread replayed "
        f"cg(n=1024, iters=8) {client['runs']} times, each bitwise equal "
        f"to its first run; launches while serving {counts}")
    paths.append(dict(path="serve: cold captures beside a client thread",
                      card=CARD, client_runs=client["runs"]))

    for bi, res in sorted(served.items()):
        wl, params, dt, mbs = SERVE_BUCKETS[bi]
        name = _bucket_name(wl, params, dt)
        key = request(wl, dtype=dt, backend="cuda", **params).bucket()
        entry = routers[mbs].plan_for(key)
        bplan = entry.bplan
        lb = key.label
        sizes = {}
        for s in sorted(res):
            sizes.setdefault(res[s].batch_size, set()).add(s)
        lanes_seen = {1 << (b - 1).bit_length() for b in sizes}
        # dispatch: one replay a batch, one capture a (lanes, dtype)
        st, pst = bplan.stats, bplan.program_stats
        assert st["dispatches"] == batches[lb], (name, st, batches[lb])
        assert st["traces"] == len(lanes_seen), (name, st, lanes_seen)
        assert pst["traces"] == len(lanes_seen), (name, pst, lanes_seen)
        assert pst["dispatches"] == batches[lb], (name, pst)
        # every lane: against its unbatched run() and against numpy
        t1 = time.perf_counter()
        modes, worst, numpy_checks = set(), 0.0, []
        shared_np = make_feeds(entry.program, seed=0,
                               dtype=getattr(np, dt),
                               only=bplan.shared_leaves)
        singles = {}
        for s in sorted(res):
            got = res[s].outputs
            assert all(bool(torch.isfinite(v).all()) for v in got.values())
            singles[s] = bplan.run_one({**entry.shared_feeds,
                                        **feeds[key][s]})
            mode, w = _lane_vs_single(got, singles[s], dt)
            modes.add(mode)
            worst = max(worst, w)
        torch.cuda.synchronize()
        if wl == "jacobi2d":
            assert modes == {"bitwise"}, (name, modes, worst)
            replay = jacobi_numpy(params["sweeps"])
            numpy_checks = _pool_map(
                lambda s: replay({k: v for k, v in res[s].outputs.items()},
                                 {**shared_np, **feeds[key][s]}),
                sorted(res))
        else:
            residual = (dense_residual if wl == "cg" else sparse_residual)
            for s in sorted(res):
                f_np = {**shared_np, **feeds[key][s]}
                r_lane = residual(_solution(res[s].outputs), f_np)
                r_one = residual(_solution(singles[s]), f_np)
                assert np.isfinite(r_lane) and r_lane < 1.0, (name, s, r_lane)
                assert abs(r_lane - r_one) <= RESIDUAL_GAP, (name, s, r_lane,
                                                             r_one)
                numpy_checks.append(r_lane)
        check_s = time.perf_counter() - t1
        # a warm batch is one graph launch and no kernel launch
        batch = {**entry.shared_feeds,
                 **{n: np.stack([feeds[key][s][n] for s in range(mbs)])
                    for n in bplan.batched_leaves}}
        calls = api_calls(lambda: bplan.run_batch(batch))
        assert calls["graph_launches"] == 1, (name, calls)
        assert calls["kernel_launches"] == 0, (name, calls)
        rec = dict(path=f"serve {name}", card=CARD, max_batch_size=mbs,
                   batch_sizes={k: len(v) for k, v in sorted(sizes.items())},
                   lanes_captured=sorted(lanes_seen), stats=st,
                   program_stats={k: v for k, v in pst.items()
                                  if k != "launches"},
                   lane_vs_single=("bitwise" if modes == {"bitwise"}
                                   else "serve_tol"),
                   lane_vs_single_worst=worst,
                   api_calls_run_batch=calls, check_s=check_s)
        if wl == "jacobi2d":
            rec["numpy_replay"] = "bitwise"
        else:
            rec["rel_residual_max"] = max(numpy_checks)
        log(f"  {name}: {sum(len(v) for v in sizes.values())} requests in "
            f"batches {rec['batch_sizes']}, lanes captured "
            f"{rec['lanes_captured']}, stats {st}; every lane vs its "
            f"unbatched run(): {rec['lane_vs_single']} (worst "
            f"{worst:.3g} of SERVE_TOL); numpy: "
            + ("replay bitwise" if wl == "jacobi2d" else
               f"rel residual <= {rec['rel_residual_max']:.3e}")
            + f"; a warm run_batch: {calls}")
        # throughput: 32 sequential run() against the same 32 served
        if mbs == LANES:
            seq_lat = []
            t1 = time.perf_counter()
            for s in SERVE_BURSTS[0]:
                t2 = time.perf_counter()
                bplan.run_one({**entry.shared_feeds, **feeds[key][s]})
                torch.cuda.synchronize()
                seq_lat.append(time.perf_counter() - t2)
            seq_s = time.perf_counter() - t1
            srv = Server(routers[mbs], ServeConfig(
                max_batch_size=mbs, max_wait_us=SERVE_WAIT_US))

            def burst():
                """The 32 requests to the running server: requests/s,
                latencies and the worker's own clock (routing and feed
                overlays in ``serve.batch_build_s``, run_many and the
                stream's sync in ``serve.dispatch_s``)."""
                def worker_ms():
                    snap = obs.snapshot(srv._scope)
                    return {h: sum(c["value"]["sum"] for c in
                                   snap.get(h, {}).get("cells", ())
                                   if c["labels"].get("bucket") == lb) * 1e3
                            for h in ("serve.batch_build_s",
                                      "serve.dispatch_s")}
                before = worker_ms()
                t1 = time.perf_counter()
                futs = [srv.submit(req(wl, params, dt, s))
                        for s in SERVE_BURSTS[0]]
                lat = [f.result(timeout=600).latency_s for f in futs]
                wall = time.perf_counter() - t1
                after = worker_ms()
                return dict(requests_per_s=len(lat) / wall,
                            wall_ms=wall * 1e3,
                            batch_build_ms=after["serve.batch_build_s"]
                            - before["serve.batch_build_s"],
                            dispatch_ms=after["serve.dispatch_s"]
                            - before["serve.dispatch_s"], **_latencies(lat))

            # the first burst meets a fresh worker thread, whose own stream
            # starts with an empty allocator pool; the second is steady
            rec["served_fresh_worker"] = burst()
            first = srv.stats()["buckets"][lb]["batch_sizes"]
            rec["served"] = burst()
            rec["served"]["batch_sizes"] = {
                k: v - first.get(k, 0) for k, v in
                srv.stats()["buckets"][lb]["batch_sizes"].items()
                if v - first.get(k, 0)}
            srv.close()
            rec["sequential"] = dict(requests_per_s=len(seq_lat) / seq_s,
                                     **_latencies(seq_lat))
            sv, fw = rec["served"], rec["served_fresh_worker"]
            log(f"  {name}: 32 sequential run(): "
                f"{rec['sequential']['requests_per_s']:.1f} requests/s, "
                f"p50 {rec['sequential']['p50_ms']:.3f} ms, p99 "
                f"{rec['sequential']['p99_ms']:.3f} ms; the same 32 served "
                f"(batches {sv['batch_sizes']}): "
                f"{sv['requests_per_s']:.1f} requests/s, p50 "
                f"{sv['p50_ms']:.3f} ms, p99 {sv['p99_ms']:.3f} ms; of its "
                f"{sv['wall_ms']:.1f} ms the worker spent "
                f"{sv['batch_build_ms']:.1f} ms building batches and "
                f"{sv['dispatch_ms']:.1f} ms in run_many (a fresh worker's "
                f"first burst: {fw['requests_per_s']:.1f} requests/s, "
                f"{fw['dispatch_ms']:.1f} ms in run_many)")
        # where a warm batch's time goes: run_batch from the stacked numpy
        # feeds (host stacking and upload included), from feeds already on
        # the card, and the card's busy time in one such call
        dev_batch = {n: torch.as_tensor(v).to("cuda") for n, v in
                     batch.items()}
        mean, best = run_timing(lambda: bplan.run_batch(batch), reps=3)
        rec["run_batch_ms"] = dict(mean=mean * 1e3, min=best * 1e3)
        mean, best = run_timing(lambda: bplan.run_batch(dev_batch), reps=3)
        rec["run_batch_device_feeds_ms"] = dict(mean=mean * 1e3,
                                                min=best * 1e3)
        reqs = [feeds[key][s] for s in range(mbs)]
        mean, best = run_timing(lambda: bplan.run_many(
            reqs, entry.shared_feeds), reps=3)
        rec["run_many_ms"] = dict(mean=mean * 1e3, min=best * 1e3)
        rec["profile_run_batch"] = profile_fn(
            lambda: bplan.run_batch(dev_batch))
        prof = rec["profile_run_batch"]
        busy = (f"{prof['device_busy_ms']:.3f} ms of "
                f"{prof['profiled_wall_ms']:.3f} ms profiled"
                if "device_busy_ms" in prof else prof["device_time"])
        log(f"  {name}: a warm batch of {mbs}: run_many "
            f"{rec['run_many_ms']['mean']:.3f} ms from the requests' numpy "
            f"feeds (pinned staging), run_batch "
            f"{rec['run_batch_ms']['mean']:.3f} ms from stacked numpy feeds, "
            f"{rec['run_batch_device_feeds_ms']['mean']:.3f} ms from feeds "
            f"on the card; device busy {busy}")
        del dev_batch
        paths.append(rec)

    # ---- the fallback: a failing dispatch serves through the reference
    wl, params, dt, mbs = SERVE_BUCKETS[0]
    key = request(wl, dtype=dt, backend="cuda", **params).bucket()
    seeds = range(4)
    with faults.inject_spec("serve.dispatch@cuda=fail"):
        srv = Server(routers[mbs], ServeConfig(
            max_batch_size=mbs, max_wait_us=SERVE_WAIT_US, autostart=False,
            breaker_failures=1))
        futs = [srv.submit(req(wl, params, dt, s)) for s in seeds]
        srv.start()
        fb = [f.result(timeout=600) for f in futs]
        health, st = srv.health(), srv.stats()
        srv.close()
    errs = []
    for s, r in zip(seeds, fb):
        assert r.degraded and r.backend == "reference", r
        assert all(v.device.type == "cuda" for v in r.outputs.values())
        errs.append(_compare(r.outputs, served[0][s].outputs,
                             float(np.abs(feeds[key][s]["b"]).max()), dt,
                             "fallback vs the cuda lanes"))
    assert health["breakers"][key.label] == "open", health
    assert st["buckets"][key.label]["fallbacks"] == len(seeds), st
    paths.append(dict(path=f"serve fallback {_bucket_name(wl, params, dt)}",
                      card=CARD, fault="serve.dispatch@cuda=fail",
                      breaker=health["breakers"][key.label],
                      fallbacks=len(seeds), rel_err_vs_cuda=max(errs)))
    log(f"  fallback: serve.dispatch@cuda=fail -> {len(seeds)} requests "
        f"served by the reference on the card (rel err vs the cuda lanes "
        f"{max(errs):.3e}), breaker {health['breakers'][key.label]}")
    return counts, routers


def check_lanes(routers, results, dtypes, ob_csr, ob_prefix, b3_pats):
    """B1, B2, B3 and B4 in their lane forms at ``LANES`` lanes on phase
    3's operands (the served buckets' own; B3's the overbooked path's
    banded operand, ``ob_csr``, with its plan's resident prefix), each
    against its plain version, each lane bitwise against the
    single-request kernel on it alone, timed beside its bytes bound and a
    library yardstick.  B1, B2 and B3 are also held so at every count of
    ``LANE_COUNTS`` (17: a ragged second group), B3 also on ``b3_pats``
    (``b3_patterns``).  Returns B3's records a pattern."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.build import build_log
    from repro_torch.kernels.spmv import spmv, spmv_lanes, spmv_lanes_plain
    from repro_torch.kernels.stencil import (stencil2d, stencil2d_lanes,
                                             stencil2d_plain)
    from repro_torch.kernels.stream import LaneStreamKernel
    from repro_torch.serve import request
    entries = {(wl, dt): routers[mbs].plan_for(request(
        wl, dtype=dt, backend="cuda", **params).bucket())
        for wl, params, dt, mbs in SERVE_BUCKETS}
    rng = np.random.default_rng(17)

    # B1: cg's Ap/pAp and r/rs passes, A shared, 16 lanes of the rest
    cg = entries["cg", "float32"]
    passes = {}
    for call in cg.bplan.plan.compiled()._tmpl:
        k = getattr(call, "pass_", None)
        if k is None:
            continue
        ops = {nd.op for nd in k.nodes}
        if "matmul" in ops:
            passes.setdefault("Ap/pAp", k)
        elif "dot" in ops and "axpy" in ops:
            passes.setdefault("r/rs", k)
    for dt in dtypes:
        tdt = getattr(torch, dt)
        A = cg.shared_feeds["A"].to(tdt)
        for label, k in passes.items():
            kl = LaneStreamKernel(k.nodes, k.shapes,
                                  set(k.stream_out + k.scalar_out), k.rows,
                                  {n for n in k.in_names if n != "A"})
            err = rel = 0.0
            for n_lanes in LANE_COUNTS:
                env_l = {n: A if n == "A" else torch.from_numpy(np.asarray(
                    rng.standard_normal((n_lanes, *k.shapes[n]))
                    if k.shapes[n] else rng.uniform(0.5, 1.5, n_lanes))
                ).to("cuda", tdt) for n in k.in_names}
                got_l = kl(env_l)
                want = kl.plain(env_l)
                torch.cuda.synchronize()
                for n in want:
                    scale = max(float(want[n].double().abs().max()), 1e-30)
                    e = max_err(got_l[n], want[n])
                    assert e <= KERNEL_TOL[dt] * scale, (label, dt, n_lanes,
                                                         n, e, scale)
                    err, rel = max(err, e), max(rel, e / scale)
                for i in range(n_lanes):
                    one = k({n: env_l[n] if n == "A" else env_l[n][i]
                             for n in k.in_names})
                    for n in one:
                        # a lane adds the single pass's products in its
                        # order and folds them through its tree
                        assert torch.equal(got_l[n][i], one[n]), (
                            "B1 lane vs B1", label, dt, n_lanes, i, n,
                            max_err(got_l[n][i], one[n]))
                if n_lanes == LANES:
                    env, got = env_l, got_l
            nbytes = sum(env[n].numel() * env[n].element_size()
                         for n in k.in_names)
            nbytes += sum(v.numel() * v.element_size() for v in got.values())
            flops = LANES * sum(2 * int(np.prod(k.shapes[nd.inputs[0]]))
                                for nd in k.nodes
                                if nd.op in ("matmul", "dot", "norm", "axpy"))
            lib = None
            if label == "Ap/pAp":
                mv = next(nd for nd in k.nodes if nd.op == "matmul")
                X = env[mv.inputs[1]].t().contiguous()       # (n, 16)

                def lib():
                    return (X * (A @ X)).sum(0)
            times = measure(lambda: kl(env), lambda: kl.plain(env), lib)
            # what bounds the kernel beside its time: registers, spills,
            # shared memory and the SASS mix, of the lane form and of the
            # single-request pass it is bitwise equal to
            res = {form: triton_resources(kern._compiled(tdt)[0])
                   for form, kern in (("lanes", kl), ("single", k))}
            record(results, f"B1 lanes {label:7s}", kernel="stream_lanes",
                   case=f"cg n=4096 {label} pass, {LANES} lanes", dtype=dt,
                   err=err, rel_err=rel, tol=KERNEL_TOL[dt], nbytes=nbytes,
                   flops=flops, times=times, lanes=LANES,
                   lanes_per_program=kl.group, lanes_vs_single="bitwise",
                   bitwise_lane_counts=list(LANE_COUNTS), resources=res)
            log(f"    {label} {dt} compiled: {json.dumps(res)}")

    # B2: the 5-point Laplacian at n = 2^20, 16 right-hand sides
    for dt in dtypes:
        sp = entries["cg_sparse", dt].shared_feeds
        indptr, indices, data = (sp[f"A.{c}"] for c in ("indptr", "indices",
                                                        "data"))
        n = indptr.numel() - 1
        tdt = data.dtype
        err = rel = 0.0
        for n_lanes in LANE_COUNTS:
            X = torch.from_numpy(rng.standard_normal((n_lanes, n))).to(
                "cuda", tdt)
            got = spmv_lanes(indptr, indices, data, X, n)
            want = spmv_lanes_plain(indptr, indices, data, X, n)
            torch.cuda.synchronize()
            for i in range(n_lanes):
                assert torch.equal(got[i], spmv(indptr, indices, data, X[i],
                                                n)), (
                    "B2 lane vs B2", dt, n_lanes, i)
            e = max_err(got, want)
            scale = float(want.double().abs().max())
            assert e <= KERNEL_TOL[dt] * scale, ("spmv_lanes", dt, n_lanes,
                                                 e, scale)
            err, rel = max(err, e), max(rel, e / scale)
            if n_lanes == LANES:
                X16 = X
        X = X16
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            A = torch.sparse_csr_tensor(indptr, indices, data, (n, n))
        XT = X.t().contiguous()
        nnz = data.numel()
        times = measure(lambda: spmv_lanes(indptr, indices, data, X, n),
                        lambda: spmv_lanes_plain(indptr, indices, data, X, n),
                        lambda: torch.sparse.mm(A, XT))
        record(results, "B2 lanes       ", kernel="spmv_lanes",
               case=f"laplacian5 n={n} nnz={nnz}, {LANES} lanes", dtype=dt,
               err=err, rel_err=rel, tol=KERNEL_TOL[dt],
               nbytes=(4 * (n + 1) + (4 + data.element_size()) * nnz
                       + 2 * LANES * X.element_size() * n),
               flops=2 * nnz * LANES, times=times, lanes=LANES,
               lanes_vs_single="bitwise",
               bitwise_lane_counts=list(LANE_COUNTS), resources=next(
                   (u for e, u in ptxas_usage(build_log(), (
                       "csr_spmv_lanes_kernel",)).items()
                    if f"kernelI{'f' if dt == 'float32' else 'd'}E" in e),
                   None))

    b3_lane_shapes = check_spmv_sliced_lanes(ob_csr, ob_prefix, b3_pats,
                                             results, dtypes, rng)

    # B4: 16 grids of 4096^2 with their f
    n = 4096
    for dt in dtypes:
        tdt = getattr(torch, dt)
        U = torch.randn((LANES, n, n), device="cuda", dtype=tdt,
                        generator=torch.Generator("cuda").manual_seed(3))
        Fs = torch.randn((LANES, n, n), device="cuda", dtype=tdt,
                         generator=torch.Generator("cuda").manual_seed(4))
        got = stencil2d_lanes(U, Fs, 1.0, lanes=LANES)
        want = stencil2d_plain(U, Fs, 1.0)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ("B4 lanes vs plain", dt)
        for i in range(LANES):
            assert torch.equal(got[i], stencil2d(U[i], Fs[i], 1.0)), (
                "B4 lane vs B4", dt, i)
        del want
        w = torch.zeros((1, 1, 3, 3), device="cuda", dtype=tdt)
        w[0, 0, 0, 1] = w[0, 0, 2, 1] = w[0, 0, 1, 0] = w[0, 0, 1, 2] = 0.25

        def lib():
            return F.conv2d(F.pad(U[:, None], (1, 1, 1, 1), mode="circular"),
                            w)[:, 0] + 0.25 * Fs
        times = measure(lambda: stencil2d_lanes(U, Fs, 1.0, lanes=LANES),
                        lambda: stencil2d_plain(U, Fs, 1.0), lib)
        record(results, "B4 lanes       ", kernel="stencil2d_lanes",
               case=f"{LANES} lanes of {n}x{n} with f", dtype=dt, err=0.0,
               rel_err=0.0, tol="bitwise", nbytes=3 * U.numel()
               * U.element_size(), flops=7 * U.numel(), times=times,
               lanes=LANES, lanes_vs_single="bitwise")
        del U, Fs, got
        torch.cuda.empty_cache()
    return b3_lane_shapes


def _hold_b3_lanes(indptr, indices, data, X, n, pre, what):
    """B3's lane form on the first k lanes of ``X`` for every k of
    ``LANE_COUNTS`` (``X`` holds the most): bitwise against its plain
    version and, lane by lane, against single-request B3 with the same
    prefix.  The plain version adds every lane on its own, so its result
    for k lanes is its result's first k."""
    import torch
    from repro_torch.kernels.spmv import (spmv, spmv_sliced_lanes,
                                          spmv_sliced_lanes_plain)
    want = spmv_sliced_lanes_plain(indptr, indices, data, X, n, pre)
    singles = [spmv(indptr, indices, data, X[i], n, pre)
               for i in range(X.shape[0])]
    for k in LANE_COUNTS:
        got = spmv_sliced_lanes(indptr, indices, data, X[:k], n, pre)
        torch.cuda.synchronize()
        assert torch.equal(got, want[:k]), ("spmv_sliced_lanes vs plain",
                                            *what, k, max_err(got, want[:k]))
        for i in range(k):
            assert torch.equal(got[i], singles[i]), (
                "B3 lane vs B3", *what, k, i, max_err(got[i], singles[i]))


def check_spmv_sliced_lanes(csr, prefix_rows, patterns, results, dtypes,
                            rng):
    """B3's lane form on the overbooked path's operand with its plan's
    resident prefix, and on each of ``b3_patterns``' operands (rows longer
    than a staged window among them) with a prefix of no rows, about half
    the rows (whole tiles) and all rows, at every count of
    ``LANE_COUNTS``: bitwise against its plain version and, lane by lane,
    against single-request B3 (``_hold_b3_lanes``).  Timed at ``LANES``
    lanes on the overbooked operand beside its bound (as B3's: the bytes a
    call must read with the prefix in L2, here with x and y of every
    lane), ``torch.sparse.mm`` on the 16 right-hand sides, itself with no
    hint (prefix 0), 16 single-request B3 calls and B2's lane form on the
    same operand (the overbook-0 plan's kernel).  The record carries the
    kernel's registers and spill bytes (``-Xptxas -v``) and its launch
    shape (shared bytes a block, blocks an SM).  The plain version's
    loop length is read on the host, so it is timed eagerly.  Returns one
    record a pattern, dtype and prefix."""
    import numpy as np
    import torch
    from repro_torch.kernels.build import build_log
    from repro_torch.kernels.spmv import (B3_LANE_WINDOW, B3_TILE_ROWS,
                                          spmv, spmv_lanes,
                                          spmv_sliced_lanes,
                                          spmv_sliced_lanes_plain,
                                          sliced_lanes_shape)
    indptr_np, indices_np, data_np = csr
    n, nnz = indptr_np.shape[0] - 1, indices_np.shape[0]
    indptr = torch.from_numpy(indptr_np).cuda()
    indices = torch.from_numpy(indices_np).cuda()
    usage = ptxas_usage(build_log(), ("spmv_tiled_lanes_kernel",))
    for dt in dtypes:
        tdt = getattr(torch, dt)
        data = torch.from_numpy(data_np).to("cuda", tdt)
        X17 = torch.from_numpy(rng.standard_normal((max(LANE_COUNTS), n))
                               ).to("cuda", tdt)
        _hold_b3_lanes(indptr, indices, data, X17, n, prefix_rows,
                       ("banded", dt))
        X = X17[:LANES]

        def kernel(rows=prefix_rows):
            return spmv_sliced_lanes(indptr, indices, data, X, n, rows)

        def plain():
            return spmv_sliced_lanes_plain(indptr, indices, data, X, n,
                                           prefix_rows)

        def singles():
            return [spmv(indptr, indices, data, X[i], n, prefix_rows)
                    for i in range(LANES)]
        with warnings.catch_warnings():      # beta-state notices
            warnings.simplefilter("ignore")
            A = torch.sparse_csr_tensor(indptr, indices, data, (n, n))
        XT = X.t().contiguous()
        times = dict(ms=graph_ms(kernel), call_ms=cuda_ms(kernel),
                     plain_ms=cuda_ms(plain, reps=5),
                     library_ms=graph_ms(lambda: torch.sparse.mm(A, XT)))
        es = data.element_size()
        resident = (4 + es) * int(indptr_np[prefix_rows])
        all_bytes = 4 * (n + 1) + (4 + es) * nnz + 2 * LANES * es * n
        extra = dict(unhinted_ms=graph_ms(lambda: kernel(0)),
                     single_b3_x16_ms=graph_ms(singles, inner=2),
                     spmv_b2_lanes_ms=graph_ms(lambda: spmv_lanes(
                         indptr, indices, data, X, n)))
        extra.update(again_ms=graph_ms(kernel),
                     unhinted_again_ms=graph_ms(lambda: kernel(0)))
        shape = sliced_lanes_shape(tdt)
        res = next((u for e, u in usage.items()
                    if f"kernelI{'f' if dt == 'float32' else 'd'}E" in e),
                   None)
        record(results, "B3 lanes       ", kernel="spmv_sliced_lanes",
               case=f"banded n={n} bandwidth={OB_BANDWIDTH} nnz={nnz} "
               f"prefix {prefix_rows} rows, {LANES} lanes", dtype=dt,
               err=0.0, rel_err=0.0, tol=0.0, nbytes=all_bytes - resident,
               flops=2 * nnz * LANES, times=times, lanes=LANES,
               lanes_vs_single="bitwise",
               bitwise_lane_counts=list(LANE_COUNTS),
               all_operand_bytes=all_bytes,
               bound_ms_all_operand=all_bytes / PEAK_BYTES_S * 1e3,
               resident_bytes=resident, prefix_rows=prefix_rows,
               plain_timing="eager", resources=res, launch_shape=shape,
               **extra)
        log(f"  B3 lanes {dt}: bitwise equal to its plain version and, "
            f"lane by lane, to B3 at {list(LANE_COUNTS)} lanes; {LANES} "
            f"lanes {times['ms']:.4f} / {extra['again_ms']:.4f} ms, "
            f"unhinted (prefix 0) {extra['unhinted_ms']:.4f} / "
            f"{extra['unhinted_again_ms']:.4f} ms, {LANES} single-request "
            f"B3 calls {extra['single_b3_x16_ms']:.4f} ms, B2 lanes "
            f"{extra['spmv_b2_lanes_ms']:.4f} ms, torch.sparse.mm "
            f"{times['library_ms']:.4f} ms; {res}, {shape}")
        del X17, X, XT, A
    out = []
    for name, (indptr_np, indices_np) in patterns.items():
        n, nnz = indptr_np.shape[0] - 1, indices_np.shape[0]
        longest = int(np.diff(indptr_np).max())
        indptr = torch.from_numpy(indptr_np).cuda()
        indices = torch.from_numpy(indices_np).cuda()
        for dt in dtypes:
            tdt = getattr(torch, dt)
            data = torch.from_numpy(rng.standard_normal(nnz)).to("cuda", tdt)
            X17 = torch.from_numpy(rng.standard_normal(
                (max(LANE_COUNTS), n))).to("cuda", tdt)
            for where, pre in (("none", 0), ("part", n // 2 // B3_TILE_ROWS
                                              * B3_TILE_ROWS), ("all", n)):
                _hold_b3_lanes(indptr, indices, data, X17, n, pre,
                               (name, dt, where))
                out.append(dict(pattern=name, n=n, nnz=nnz, dtype=dt,
                                prefix_rows=pre, longest_row=longest,
                                window=B3_LANE_WINDOW,
                                lane_counts=list(LANE_COUNTS), bitwise=True,
                                card=CARD))
        log(f"  B3 lanes {name} n={n} nnz={nnz} (longest row {longest}, "
            f"window {B3_LANE_WINDOW}): bitwise equal to its plain version "
            f"and, lane by lane, to B3 at {list(LANE_COUNTS)} lanes in "
            f"{', '.join(dtypes)} with prefixes of none, part and all rows")
    return out


def check_bound_operator(routers):
    """The served cg bucket's operator is bound to its batched plan, whose
    graphs read it in place: a write to it behind its version counter (as
    DLPack or a raw kernel writes) shows in the next replay.  An unbound
    plan (``CompiledPlan.batched()``) copies the operator in on every
    dispatch and shows the write too.  Each lane is held bitwise against
    its unbatched ``run()`` on the written operator; the write is undone
    (a doubling, exactly) at the end."""
    import torch
    from repro_torch.serve import request
    (wl, params, dt, mbs), = [b for b in SERVE_BUCKETS if b[0] == "cg"]
    router = routers[mbs]
    entry = router.plan_for(request(wl, dtype=dt, backend="cuda",
                                    **params).bucket())
    reqs = [router.request_feeds(entry, request(
        wl, dtype=dt, backend="cuda", seed=s, **params)) for s in range(4)]
    A = entry.shared_feeds["A"]
    unbound = entry.bplan.plan.batched(backend="cuda")
    x = f"x{params['iters']}"
    for name, bp in (("bound", entry.bplan), ("copied", unbound)):
        before = bp.run_many(reqs, entry.shared_feeds)
        A.data.mul_(2.0)
        after = bp.run_many(reqs, entry.shared_feeds)
        torch.cuda.synchronize()
        for i, r in enumerate(reqs):
            one = bp.run_one({"A": A, **r})
            for k in one:
                assert torch.equal(after[i][k], one[k]), (name, i, k)
            assert not torch.equal(after[i][x], before[i][x])
        A.data.div_(2.0)
    log(f"  {_bucket_name(wl, params, dt)}: a write to the operator behind "
        "its version counter shows in the next replay, bound (the router's "
        "plan reads it in place) and copied (an unbound batched() plan), "
        "every lane bitwise equal to its run() on the written operator")


# --------------------------------------------------------------------------
# phase 11: training
# --------------------------------------------------------------------------

class plain_forms:
    """Within the block, a training forward runs the five autograd
    Functions' backward forms as its forward too (chunked attention, the
    plain bf16 MLP, the plain norm, the chunked RG-LRU and WKV6 forms):
    the model reads the Functions from its modules at call time, so
    swapping the module attributes swaps the path.  Only this script does
    this; the package has no such switch."""

    def __enter__(self):
        from repro_torch.kernels.rglru import rglru_plain
        from repro_torch.kernels.rwkv6 import wkv6_plain
        from repro_torch.models import recurrent, transformer
        from repro_torch.models.attention import chunked_flash_attention
        from repro_torch.models.autograd import plain_mlp
        from repro_torch.models.common import rms_norm

        class Flash:
            @staticmethod
            def apply(q, k, v, causal, window, kv_block):
                return chunked_flash_attention(q, k, v, causal=causal,
                                               window=window,
                                               kv_block=kv_block)

        class MLP:
            apply = staticmethod(plain_mlp)

        class Norm:
            apply = staticmethod(rms_norm)

        class RGLRU:
            apply = staticmethod(rglru_plain)

        class WKV6:
            apply = staticmethod(wkv6_plain)
        self._saved = [(mod, n, getattr(mod, n)) for mod, n in (
            (transformer, "FlashAttentionFn"), (transformer, "FusedMLPFn"),
            (transformer, "RMSNormFn"), (recurrent, "RGLRUFn"),
            (recurrent, "WKV6Fn"))]
        transformer.FlashAttentionFn = Flash
        transformer.FusedMLPFn = MLP
        transformer.RMSNormFn = Norm
        recurrent.RGLRUFn = RGLRU
        recurrent.WKV6Fn = WKV6
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self._saved:
            setattr(mod, n, fn)
        return False


class other_roundings:
    """Within the block, the plain forms round in other places: the MLP
    runs on its fp32 weights in fp32 and rounds its output to bf16 once
    (where the plain MLP rounds the weights, the products and the hidden
    tensor to bf16; B6 computes this form), and the recurrences' plain
    forms scan in chunks of twice their steps (``rglru_plain`` 128,
    ``wkv6_plain`` 32).  The same function, rounded elsewhere.  Use it
    only with ``plain_forms``: the kernels' wrappers size their buffers by
    ``CHUNK``.  Only this script does this."""

    def __enter__(self):
        from repro_torch.kernels import rglru, rwkv6
        from repro_torch.models import transformer
        from repro_torch.models.common import COMPUTE_DTYPE, activation_fn

        def fp32_mlp(xc, w_gate, w_up, w_down, activation,
                     hidden=lambda h: h):
            act = activation_fn(activation)
            xf = xc.to(torch.float32)
            up = xf @ w_up
            h = act(xf @ w_gate) * up if w_gate is not None else act(up)
            return (hidden(h) @ w_down).to(COMPUTE_DTYPE)
        import torch
        self._saved = [(m, "CHUNK", m.CHUNK) for m in (rglru, rwkv6)]
        self._saved.append((transformer, "plain_mlp", transformer.plain_mlp))
        for m in (rglru, rwkv6):
            m.CHUNK = 2 * m.CHUNK
        transformer.plain_mlp = fp32_mlp
        return self

    def __exit__(self, *exc):
        for m, name, value in self._saved:
            setattr(m, name, value)
        return False


def _leaf_rel(got, want):
    """max over leaves of |got - want| / |want| (2-norms, on the card)."""
    import torch
    worst = 0.0
    for a, b in zip(_leaves(got), _leaves(want)):
        worst = max(worst, float(torch.linalg.vector_norm(a - b)
                                 / torch.linalg.vector_norm(b)))
    return worst


def train_launches(cfg, remat):
    """B5-B9 launches of one training step of ``cfg`` with every kernel
    flag on: each layer's norms (2), MLP (1, none in an MoE layer),
    attention (1 in an ``attn`` / ``xattn`` layer) and scan (1 in an
    ``rglru`` / ``rwkv`` layer), twice with remat (the recompute runs the
    forward kernels again), and the final norm once."""
    kinds = cfg.layer_kinds()
    per = {"flash_attention": sum(k in ("attn", "xattn") for k in kinds),
           "fused_mlp": 0 if cfg.is_moe else len(kinds),
           "rmsnorm": 2 * len(kinds),
           "rglru": sum(k == "rglru" for k in kinds),
           "wkv6": sum(k == "rwkv" for k in kinds)}
    n = 2 if remat else 1
    out = {k: n * v for k, v in per.items()}
    out["rmsnorm"] += 1
    return out


def drive_training(arch, layers, batch_size, seq, results_paths,
                   profile=False):
    """A training path: ``Session(arch, device="cuda").default_plan(seq=
    seq)``, full width at ``layers`` layers, batches of ``batch_size`` x
    ``seq`` from ``SyntheticLMData`` (with ``launch.train.stub_inputs``'s
    frames or image for the audio and vlm families), the plan's remat
    policy and AdamW.  Checks, each failing the run: (a) every gradient
    leaf of one step finite and not zero (an audio model's token
    embedding, which the frames replace, zero); (b) the kernel path's loss
    and every leaf within ``max(TRAIN_MIN_TOL, 2 x spread)`` of the
    plain-forms run (``plain_forms``), the spread that of the plain forms
    against the flags-off plan (naive attention where the plain forms
    chunk it); an arch without attention, whose flags-off plan rounds as
    the plain forms do, takes it against the same function rounded
    elsewhere (``other_roundings``: the MLP in fp32, the recurrences in
    chunks of twice their steps); for an MoE arch every run
    takes the plain-forms run's routes (``replayed_routes``), so that the
    runs differ by rounding alone; (c) gradients with remat bitwise those
    without, or, where two identical no-remat runs differ, within twice
    their spread (the record says which held); (d) B5-B9 launched per step
    as ``train_launches`` predicts; (e) ``TRAIN_LOOP_STEPS`` steps of
    ``CompiledPlan.train`` (donated) from the fresh weights, with finite
    losses, step 0's loss within the loss limit of the one-step loss (for
    an MoE arch, of the non-donated step's, which routes as it does), and
    the weights after step 0 those of a non-donated ``make_train_step``
    (bitwise where (c) held bitwise).  Then records the median warm step
    time and tokens/s of the kernel step, the plain-forms step and the
    kernel step without remat (taken in turns, continuing from the trained
    weights), and the memory of a step with remat on and off (``grads``);
    ``profile`` adds one profiled step of each.  Remat must leave less
    held after the forward than no remat.  Returns the launch counts of
    the ``CompiledPlan.train`` run."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch.train import (TrainConfig, make_loss_fn,
                                          make_train_step, stub_inputs)
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    log(f"  {arch}: depth {cfg.n_layers} of {full.n_layers} layers "
        f"({''.join(k[0] for k in cfg.layer_kinds())}), every width as "
        "published")
    compiled = Session(cfg, device="cuda").default_plan(seq=seq)
    plan = compiled.plan
    assert (plan.use_flash_attention and plan.use_fused_mlp
            and plan.use_fused_rmsnorm), plan
    assert {"attn_out", "mlp_out"} <= set(plan.remat_save_names), plan
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch_size))
    x, y = data.batch_at(0)
    batch = {"tokens": torch.from_numpy(x).cuda(),
             "labels": torch.from_numpy(y).cuda(),
             **stub_inputs(cfg, batch_size, seq, 0, "cuda")}
    tokens = batch_size * seq
    log(f"  plan {plan.remat_save_names} kv_block {plan.kv_block}; "
        f"{n_params / 1e9:.3f} B fp32 parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB); batch "
        f"{batch_size}x{seq}"
        + "".join(f", {k} {tuple(batch[k].shape)}"
                  for k in ("frames", "img") if k in batch))

    grad_bytes = 4 * n_params            # fp32 gradients, one per weight
    names = ("flash_attention", "fused_mlp", "rmsnorm", "rglru", "wkv6")

    def grads(p, remat=True):
        """(loss, grads, launches, memory): ``value_and_grad`` with the
        forward and the backward taken apart, so that the bytes in use
        above the resident state can be read between them.  ``memory``:
        ``held``, what the forward leaves for the backward (the saved
        activations and the logits); ``fwd_peak``, the forward's peak;
        ``peak``, the whole step's; ``peak_less_grads``, that peak less
        the gradients' ``grad_bytes``, which every form of the step must
        hold at its end."""
        loss_fn = make_loss_fn(cfg, p, TrainConfig(remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        leaves, spec = pytree.tree_flatten(params)
        alias = [t.detach().requires_grad_(True) for t in leaves]
        loss = loss_fn(pytree.tree_unflatten(alias, spec), batch)
        torch.cuda.synchronize()
        mem = dict(held=torch.cuda.memory_allocated() - base,
                   fwd_peak=torch.cuda.max_memory_allocated() - base)
        g = pytree.tree_unflatten(list(torch.autograd.grad(
            loss, alias, materialize_grads=True)), spec)
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated() - base
        mem["peak_less_grads"] = mem["peak"] - grad_bytes
        return float(loss.detach()), g, kernels.launches(), mem

    # (b) first the plain forms, whose routes an MoE arch's other runs take
    with plain_forms(), recorded_routes() as plain_routes:
        loss_p, g_p, n_p, _ = grads(plan)
    assert not any(n_p[k] for k in names), n_p
    L = cfg.n_layers
    routes = {True: plain_routes.routes,           # forward, then recompute
              False: plain_routes.routes[:L]}
    moe_note = {}
    if cfg.is_moe:
        share, n_routed = plain_routes.dropped_share()
        moe_note = dict(routes="the plain-forms run's, replayed",
                        dropped_share=share, routed_layers=n_routed)
        log(f"  MoE: the plain-forms run dropped {share:.1%} of its (token, "
            f"k) pairs at capacity; the kernel and flags-off runs replay "
            f"its routes")

    def routed(remat=True):
        return (replayed_routes(routes[remat]) if cfg.is_moe
                else contextlib.nullcontext())

    want = {remat: train_launches(cfg, remat) for remat in (True, False)}
    with routed():
        loss_k, g_k, n_k, mem_remat = grads(plan)
    unused = {id(params["embed"])} if cfg.family == "audio" else set()
    for leaf, w in zip(_leaves(g_k), _leaves(params)):               # (a)
        assert bool(torch.isfinite(leaf).all()), "non-finite gradient"
        assert bool((leaf != 0).any()) != (id(w) in unused), \
            "a gradient leaf is all zero (or an unused one is not)"
    with routed(False):
        loss_nr, g_nr, n_nr, mem_off = grads(plan, remat=False)
    for remat, got in ((True, n_k), (False, n_nr)):                # (d)
        assert {k: got[k] for k in names} == want[remat], (remat, got)
    bitwise = loss_k == loss_nr and all(                           # (c)
        torch.equal(a, b) for a, b in zip(_leaves(g_k), _leaves(g_nr)))
    remat_check = dict(bitwise=bitwise)
    if not bitwise:
        with routed(False):
            _, g_nr2, _, _ = grads(plan, remat=False)
        spread = _leaf_rel(g_nr2, g_nr)
        err = _leaf_rel(g_k, g_nr)
        del g_nr2
        assert spread > 0 and err <= 2 * spread, (
            "remat gradients vs no remat", err, spread)
        remat_check.update(spread=spread, err=err)
    del g_nr
    attends = any(k in ("attn", "xattn") for k in cfg.layer_kinds())
    with routed(), plain_forms(), (contextlib.nullcontext() if attends
                                   else other_roundings()):
        loss_off, g_off, _, _ = grads(dataclasses.replace(
            plan, use_flash_attention=False, use_fused_mlp=False,
            use_fused_rmsnorm=False))
    spread = _leaf_rel(g_off, g_p)
    loss_spread = abs(loss_off - loss_p) / abs(loss_p)
    del g_off
    tol = max(TRAIN_MIN_TOL, 2 * spread)
    loss_tol = max(TRAIN_MIN_TOL, 2 * loss_spread)
    err = _leaf_rel(g_k, g_p)                                      # (b)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  one step: loss {loss_k:.6f} (plain forms {loss_p:.6f}, rel "
        f"{loss_err:.2e}, limit {loss_tol:.2e}); gradients: max leaf rel "
        f"err {err:.3e} against the plain forms (limit {tol:.3e} = 2 x the "
        f"plain forms' spread against the flags-off plan"
        + ("" if attends else " in other roundings") + f", {spread:.3e})")
    assert loss_err <= loss_tol, ("training loss vs plain forms", loss_err)
    assert err <= tol, ("gradients vs plain forms", err, tol)
    held = "bitwise equal to" if bitwise else "within 2x the spread of"
    log(f"  remat gradients {held} the no-remat run's ({remat_check}); "
        f"launches per step with remat {want[True]}, without "
        f"{want[False]} (as predicted)")
    del g_k, g_p, routes
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the main path: CompiledPlan.train, counted, in two calls (one
    # step, then a resume from start_step=1 with its weights and moments).
    # Its first step is held against a non-donated make_train_step from
    # the same weights, fresh moments and batch 0: the loss against the
    # one-step loss above, the weights after the step bitwise (or, where
    # (c) found the card's GEMMs not deterministic, within 2x its spread).
    opt_e = AdamWConfig(total_steps=TRAIN_LOOP_STEPS)
    ref_step = make_train_step(cfg, plan, opt_e, TrainConfig(donate=False))
    p_ref, _, m_ref = ref_step(params, adamw_init(params), batch)
    loss_ref = float(m_ref["loss"])
    loss_one = loss_ref if cfg.is_moe else loss_k
    del m_ref
    gc.collect()
    torch.cuda.empty_cache()
    stream = iter(data)
    loop_kw = dict(opt_cfg=opt_e, log_every=1,
                   train_cfg=TrainConfig(donate=True))
    torch.cuda.synchronize()
    kernels.reset_launches()
    first = compiled.train(data_iter=stream, n_steps=1, params=params,
                           **loop_kw)
    torch.cuda.synchronize()
    if bitwise:
        donated_err = 0.0 if all(torch.equal(a, b) for a, b in zip(
            _leaves(first["params"]), _leaves(p_ref))) else float("inf")
        donated_tol = 0.0
    else:
        donated_err = _leaf_rel(first["params"], p_ref)
        donated_tol = 2 * remat_check["spread"]
    del p_ref
    gc.collect()
    torch.cuda.empty_cache()
    rest = compiled.train(data_iter=stream, n_steps=TRAIN_LOOP_STEPS,
                          start_step=1, params=first["params"],
                          opt_state=first["opt_state"], **loop_kw)
    torch.cuda.synchronize()
    counts = kernels.launches()
    history = first["history"] + rest["history"]
    state = rest["opt_state"]
    del first, rest
    losses = [h["loss"] for h in history]
    first_err = abs(losses[0] - loss_one) / abs(loss_one)
    log(f"  CompiledPlan.train losses {losses}; step 0 against the one-step "
        f"loss {loss_one:.6f}: rel {first_err:.2e} (limit {loss_tol:.2e}); "
        f"the non-donated make_train_step's loss {loss_ref:.6f}, its "
        f"weights after the step against the donated step's: rel err "
        f"{donated_err:.3e} (limit {donated_tol:.3e})")
    assert len(losses) == TRAIN_LOOP_STEPS and all(
        np.isfinite(v) for v in losses), losses
    assert first_err <= loss_tol, ("train_loop step 0 vs one step",
                                   losses[0], loss_one)
    assert abs(loss_ref - losses[0]) / abs(loss_one) <= loss_tol, (
        "donated vs non-donated step loss", losses[0], loss_ref)
    assert donated_err <= donated_tol, ("donated vs non-donated weights",
                                        donated_err, donated_tol)
    assert int(state["count"]) == TRAIN_LOOP_STEPS, state["count"]
    assert {k: counts[k] for k in names} == {
        k: TRAIN_LOOP_STEPS * n for k, n in want[True].items()}, counts
    # timed train steps, in turns: donated (in-place) AdamW, continuing
    # from the main path's weights and moments, each on its own routes
    # (the kernel step also without remat, to price the recompute)
    opt = AdamWConfig(total_steps=100)
    steps = {remat: make_train_step(cfg, plan, opt, TrainConfig(
        remat=remat, donate=True)) for remat in (True, False)}
    times = {"kernel": [], "plain": [], "kernel_no_remat": []}

    def timed(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = steps[name != "kernel_no_remat"]
        if name == "plain":
            with plain_forms():
                _, _, m = step(params, state, batch)
        else:
            _, _, m = step(params, state, batch)
        loss = float(m["loss"])
        times[name].append(time.perf_counter() - t)
        assert np.isfinite(loss), (name, loss)
    for name in times:                               # warm-up
        timed(name)
        times[name].clear()
    for _ in range(TRAIN_TIMED if arch == LLM_ARCH else FAMILY_TIMED):
        for name in times:
            timed(name)
    step_ms = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    profiles = {}
    if profile:
        profiles = {name: profile_fn(lambda: timed(name), top=8)
                    for name in ("kernel", "plain")}
    del state
    gc.collect()
    torch.cuda.empty_cache()

    smi = smi_line()
    record = dict(
        path=f"train {cfg.name} {cfg.n_layers} layers {batch_size}x{seq}",
        nvidia_smi=smi, layers=cfg.n_layers, n_params=n_params,
        plan=dataclasses.asdict(plan),
        loss=loss_k, plain_forms_loss=loss_p, loss_rel_err=loss_err,
        loss_tol=loss_tol, grad_rel_err=err, grad_tol=tol,
        plain_spread=spread, remat=remat_check, moe=moe_note,
        launches_per_step_remat=want[True],
        launches_per_step_no_remat=want[False],
        step_ms=step_ms["kernel"], tokens_per_s=tokens / step_ms["kernel"]
        * 1e3, plain_step_ms=step_ms["plain"],
        plain_tokens_per_s=tokens / step_ms["plain"] * 1e3,
        no_remat_step_ms=step_ms["kernel_no_remat"],
        step_ms_all={k: [t * 1e3 for t in v] for k, v in times.items()},
        memory_gb={"remat": {k: v / 1e9 for k, v in mem_remat.items()},
                   "no_remat": {k: v / 1e9 for k, v in mem_off.items()}},
        grad_gb=grad_bytes / 1e9, one_step_loss_rel_err=first_err,
        donated_weights_rel_err=donated_err, donated_tol=donated_tol,
        undonated_loss=loss_ref, train_loop_losses=losses,
        train_loop_step_ms=[h["time_s"] * 1e3 for h in history],
        profile=profiles, seconds=time.perf_counter() - t0)
    results_paths.append(record)
    log(f"  on {smi}: train step (fwd + bwd + AdamW, donated), median of "
        f"{len(times['kernel'])} warm: kernels {step_ms['kernel']:.1f} ms "
        f"({record['tokens_per_s']:.0f} tokens/s), plain forms "
        f"{step_ms['plain']:.1f} ms ({record['plain_tokens_per_s']:.0f} "
        f"tokens/s), kernels without remat "
        f"{step_ms['kernel_no_remat']:.1f} ms; GB above the resident state "
        f"(gradients {grad_bytes / 1e9:.2f}): remat "
        f"{record['memory_gb']['remat']}, no remat "
        f"{record['memory_gb']['no_remat']}")
    for name, prof in profiles.items():
        log(f"  profiled {name} step: {prof}")
    # remat keeps fewer activations; the step's peak falls in the first
    # layer's backward (scripts/train_memory.py), with nearly every
    # gradient formed, alike in both forms, so it is recorded, not held
    assert mem_remat["held"] < mem_off["held"], (
        "remat does not keep fewer activations", mem_remat, mem_off)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 12: the LLM mesh
# --------------------------------------------------------------------------

#: phase 12's main path: granite-3-8b at full width, ``TRAIN_LAYERS`` of
#: its 40 layers (8.0 GB of fp32 weights; on the mesh its two data
#: replicas hold 16 GB, ZeRO-1's moments 16 GB more and a step's
#: gradients 16 GB, beside the unsharded comparison runs), on
#: ``make_local_mesh(*MESH_LLM)``: four slots on the one card
MESH_LLM = (2, 2)
MESH_PREFILL_BATCH = 2
MESH_TRAIN_STEPS = 3
#: one short check a family: (arch, layers, mesh, decodes).  granite-moe
#: 4 of 24 layers, its routes replayed; recurrentgemma one [rglru, rglru,
#: attn] period (B8 on D/2 channels; 10 heads and 1 kv head at TP 2:
#: attention query-split, B5 on 5 query heads a slot against the kv head
#: whose columns the 2 slots all-gather, and the 48-entry decode cache
#: sequence-sharded, 24 entries a slot); rwkv6 2 of 32
#: (B9 on 32 of 64 heads); hubert 3 of 48, prefill only (encoder-only);
#: llama-vision 5 of 40, its fifth an ``xattn`` layer
MESH_FAMILIES = (
    (MOE_ARCH, 4, (1, 2), True),
    (HYBRID_ARCH, 3, (2, 2), True),
    (SSM_ARCH, 2, (1, 2), True),
    (AUDIO_ARCH, 3, (2, 2), False),
    (VLM_ARCH, 5, (1, 2), True),
)


def _sync(dev):
    import torch
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def _timed(fn, dev):
    """(result, wall seconds) of ``fn()``, synchronized on a card."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def mesh_launches(cfg, slots, mode):
    """B5-B9 launches of one ``mode`` pass over a mesh of ``slots``:
    every slot runs every layer's kernels, split, query-split or gathered
    alike (``models/sharded.py``), so ``slots`` times the unsharded
    pass's: in prefill each layer's norms (2), MLP (1, none in an MoE
    layer), attention (1 in an ``attn`` / ``xattn`` layer) and scan (1 in
    an ``rglru`` / ``rwkv`` layer), and the final norm; a decode step
    only the norms and the MLP; a train step ``train_launches`` with
    remat."""
    if mode == "train":
        per = train_launches(cfg, True)
    else:
        kinds = cfg.layer_kinds()
        dec = mode == "decode"
        per = {"flash_attention": 0 if dec else sum(
                   k in ("attn", "xattn") for k in kinds),
               "fused_mlp": 0 if cfg.is_moe else len(kinds),
               "rmsnorm": 2 * len(kinds) + 1,
               "rglru": 0 if dec else sum(k == "rglru" for k in kinds),
               "wkv6": 0 if dec else sum(k == "rwkv" for k in kinds)}
    return {k: slots * v for k, v in per.items()}


def spec_bytes(shapes, shardings, slot):
    """The bytes slot ``slot`` holds of a tree, counted from the global
    shapes (``meta`` tensors) and the shardings alone."""
    from repro_torch.launch import shardings as shd
    total = 0
    for t, s in zip(shd.tree_leaves(shapes), shd.tree_leaves(shardings)):
        n = 1
        for e in s.shard_shape(tuple(t.shape)):
            n *= e
        total += n * t.element_size()
    return total


def _held_bytes(tree, shapes, shardings, mesh):
    """Per slot: (bytes held, bytes the specs count); they must agree."""
    from repro_torch.launch import shardings as shd
    out = [(shd.slot_bytes(tree, k), spec_bytes(shapes, shardings, k))
           for k in range(mesh.size)]
    assert all(a == b for a, b in out), out
    return [a for a, _ in out]


def _rel_to(got, want):
    return max_err(got, want) / float(want.abs().max())


def drive_llm_mesh(cfg, mesh_shape, results_paths, dev="cuda"):
    """Phase 12's main path: ``cfg`` on ``make_local_mesh(*mesh_shape)``.
    (a) a prefill of ``MESH_PREFILL_BATCH`` x ``PREFILL_SEQ`` through
    ``models.sharded.forward``, logits within ``LLM_TOL`` of the
    unsharded kernel run (``CompiledPlan.serve().prefill_fn``), the
    shifted-position control rejected; (b) ``generate`` of ``GEN_BATCH``
    x (``GEN_PROMPT`` + ``GEN_NEW``) through ``ServeBundle.jit_decode(
    mesh, ...)``, one replay a step, its tokens equal to the unsharded
    bundle's (or parted at a near tie), the decode logits at the last
    prompt position within ``DECODE_TOL`` of the unsharded step's, the
    previous position's rejected; (c) the training loss and every
    gathered gradient leaf of one step within ``max(TRAIN_MIN_TOL, 2 x
    spread)`` of the unsharded step's (the spread: the unsharded kernel
    step's against its flags-off step's); (d) ``MESH_TRAIN_STEPS``
    steps of ``jit_train_step`` (ZeRO-1, the plan's remat, donated):
    finite losses, the first step's gathered params against the unsharded
    step's on the same params and batch (each leaf's update within
    ``max(TRAIN_MIN_TOL, 2 x spread)``, the spread that of AdamW's first
    update from the flags-off gradients against the kernel ones), every
    moment block of its ZeRO-1 shape, the data replicas of every param
    block bitwise equal after each step.  B5-B7
    launches of every pass as ``mesh_launches`` predicts.  Records the
    per-slot parameter, moment and cache bytes (held against the specs'
    count), each pass's time beside the unsharded one's, and the bytes
    each exchange kind moved.  Returns the launch counts of (a), (b) and
    (d)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import greedy_generate, jit_decode_step
    from repro_torch.launch.train import (TrainConfig, jit_train_step,
                                          make_loss_fn, make_mesh_loss_fn,
                                          make_train_step, value_and_grad)
    from repro_torch.models import init_cache, init_params, sharded
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import (clip_scale, global_norm, schedule,
                                         update_leaf)
    t0 = time.perf_counter()
    on_card = str(dev).startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(*mesh_shape, device=dev)
    K = mesh.size
    compiled = Session(cfg, device=dev).default_plan(seq=PREFILL_SEQ)
    plan = compiled.plan
    assert (plan.use_flash_attention and plan.use_fused_mlp
            and plan.use_fused_rmsnorm), plan
    bundle = compiled.serve()
    params = init_params(cfg, seed=0, device=dev)
    p_shapes, p_sh = shd.params_for(cfg, mesh)
    sp = shd.shard_tree(params, p_sh)
    p_bytes = _held_bytes(sp, p_shapes, p_sh, mesh)
    log(f"  {cfg.name}: {cfg.n_layers} layers, every width as published, "
        f"on {mesh!r}; plan {plan.remat_save_names} kv_block "
        f"{plan.kv_block}; parameter bytes a slot {p_bytes} (the specs' "
        f"count; the model {sum(t.numel() * 4 for t in _leaves(params))})")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (MESH_PREFILL_BATCH, PREFILL_SEQ))).to(dev)
    gen_prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))).to(dev)
    out = dict(path=f"mesh {cfg.name} {cfg.n_layers} layers on "
               f"{mesh_shape}", mesh=list(mesh_shape), layers=cfg.n_layers,
               param_bytes_per_slot=p_bytes)
    counts = dict.fromkeys(kernels.LAUNCHES, 0)

    # (a) prefill
    want = mesh_launches(cfg, K, "prefill")
    ref = bundle.prefill_fn(params, prompt)
    mesh.reset_exchanged()
    kernels.reset_launches()
    logits, first_s = _timed(
        lambda: sharded.forward(sp, cfg, plan, prompt)[0], dev)
    got = kernels.launches()
    assert {k: got[k] for k in want} == want, (got, want)
    for k, v in got.items():
        counts[k] += v
    prefill_x = dict(mesh.exchanged)
    assert bool(torch.isfinite(logits).all())
    assert logits.shape == (MESH_PREFILL_BATCH, PREFILL_SEQ, cfg.padded_vocab)
    rel = _rel_to(logits, ref)
    control = max_err(logits[:, 1:], ref[:, :-1]) / float(ref.abs().max())
    pre_ms = min(_timed(lambda: sharded.forward(sp, cfg, plan, prompt),
                        dev)[1] for _ in range(3)) * 1e3
    ref_ms = min(_timed(lambda: bundle.prefill_fn(params, prompt), dev)[1]
                 for _ in range(3)) * 1e3
    del logits, ref
    log(f"  prefill {MESH_PREFILL_BATCH}x{PREFILL_SEQ}: logits vs the "
        f"unsharded kernel run rel err {rel:.3e} (tol {LLM_TOL:g}; shifted "
        f"one position {control:.3e}, must exceed it); launches {want} (as "
        f"predicted); {pre_ms:.1f} ms (unsharded {ref_ms:.1f} ms); "
        f"exchanged bytes {prefill_x}")
    assert rel <= LLM_TOL, ("mesh prefill vs unsharded", rel)
    assert control > LLM_TOL, ("the LLM limit passes shifted logits",
                               control)
    out.update(prefill_rel_err=rel, prefill_shifted_rel_err=control,
               prefill_ms=pre_ms, unsharded_prefill_ms=ref_ms,
               prefill_launches=want, prefill_exchanged_bytes=prefill_x)

    # (b) decode: generate through the bundle's mesh step
    z = GEN_PROMPT + GEN_NEW
    steps = z - 1
    step = bundle.jit_decode(mesh, GEN_BATCH, z)
    assert step is bundle.jit_decode(mesh, GEN_BATCH, z)
    c_shapes, c_sh = shd.cache_for(cfg, mesh, GEN_BATCH, z)
    scache = shd.shard_tree(init_cache(cfg, GEN_BATCH, z, device=dev), c_sh)
    c_bytes = _held_bytes(scache, c_shapes, c_sh, mesh)

    def gen():                 # from a reset cache, as bundle.generate
        for e in scache["layers"]:
            for name, leaf in e.items():
                for p in leaf.parts:
                    p.fill_(-1 if name == "pos_idx" else 0)
        return greedy_generate(sp, cfg, plan, gen_prompt, GEN_NEW,
                               step_fn=step, cache=scache)
    kernels.reset_launches()
    toks, first_gen_s = _timed(gen, dev)
    per_gen = kernels.launches()
    want_step = mesh_launches(cfg, K, "decode")
    got_step = {k: per_gen[k] / steps for k in want_step}
    assert got_step == want_step, (got_step, want_step)
    for k, v in per_gen.items():
        counts[k] += v
    assert step.stats == {"traces": 1, "dispatches": steps}, step.stats
    toks_ref = bundle.generate(params, gen_prompt, GEN_NEW)
    split = _first_split(toks, toks_ref, lambda col: _unsharded_logits_at(
        bundle, params, cfg, toks_ref, col, dev))
    gen_ms = min(_timed(gen, dev)[1] for _ in range(2)) * 1e3
    ref_gen_ms = min(_timed(lambda: bundle.generate(params, gen_prompt,
                                                    GEN_NEW), dev)[1]
                     for _ in range(2)) * 1e3
    assert step.stats == {"traces": 1, "dispatches": 3 * steps}, step.stats
    stats = dict(step.stats)
    calls = (api_calls(lambda: step(sp, scache, gen_prompt[:, :1],
                                    GEN_PROMPT))
             if str(dev).startswith("cuda") else {})
    if calls:
        assert calls["graph_launches"] == 1 and \
            calls["kernel_launches"] <= 2, calls
    # decode logits at the last prompt position, mesh step vs unsharded
    dstep = jit_decode_step(cfg, plan, None, GEN_BATCH, z)
    c_ref = init_cache(cfg, GEN_BATCH, z, device=dev)
    c_mesh = shd.shard_tree(init_cache(cfg, GEN_BATCH, z, device=dev), c_sh)
    last = []
    for t in range(GEN_PROMPT):
        a, _ = step(sp, c_mesh, gen_prompt[:, t:t + 1], t)
        b, _ = dstep(params, c_ref, gen_prompt[:, t:t + 1], t)
        last = (last + [(a.clone(), b.clone())])[-2:]
    dec_rel = _rel_to(last[-1][0], last[-1][1])
    dec_control = (max_err(last[-1][0], last[-2][1])
                   / float(last[-1][1].abs().max()))
    log(f"  generate {GEN_BATCH}x({GEN_PROMPT}+{GEN_NEW}) through "
        f"bundle.jit_decode(mesh, {GEN_BATCH}, {z}): {steps} steps, one "
        f"replay each (stats after three generates {stats}; a warm step "
        f"makes {calls}); "
        f"launches per step {want_step} (as predicted); tokens {split}; "
        f"decode logits at the last prompt position vs the unsharded "
        f"step's rel err {dec_rel:.3e} (tol {DECODE_TOL:g}; against its "
        f"position before {dec_control:.3e}, must exceed it); "
        f"{gen_ms / steps:.2f} ms a step (unsharded {ref_gen_ms / steps:.2f}"
        f" ms); exchanged bytes a step {step.exchanged}; cache bytes a slot "
        f"{c_bytes} (the specs' count)")
    assert dec_rel <= DECODE_TOL, ("mesh decode vs unsharded", dec_rel)
    assert dec_control > DECODE_TOL, ("the decode limit passes the wrong "
                                      "position", dec_control)
    out.update(decode_rel_err=dec_rel, decode_previous_rel_err=dec_control,
               decode_ms_per_step=gen_ms / steps,
               unsharded_decode_ms_per_step=ref_gen_ms / steps,
               decode_launches_per_step=want_step,
               decode_step_stats=stats, api_calls_step=calls,
               decode_exchanged_bytes=dict(step.exchanged),
               cache_bytes_per_slot=c_bytes, **split)
    del scache, c_mesh, c_ref, step, dstep
    bundle._steps.clear()
    bundle._caches.clear()
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()

    # (c) one step's loss and gradients against the unsharded step's
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=PREFILL_SEQ,
                                      global_batch=TRAIN_BATCH))
    x, y = data.batch_at(0)
    batch = {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
    tc = TrainConfig()
    loss_u, g_u = value_and_grad(make_loss_fn(cfg, plan, tc))(params, batch)
    off = dataclasses.replace(plan, use_flash_attention=False,
                              use_fused_mlp=False, use_fused_rmsnorm=False)
    loss_o, g_o = value_and_grad(make_loss_fn(cfg, off, tc))(params, batch)
    spread = _leaf_rel(g_o, g_u)
    loss_spread = abs(float(loss_o) - float(loss_u)) / abs(float(loss_u))
    # the spread of AdamW's first update (fresh moments), the flags-off
    # gradients' against the kernel gradients', leaf by leaf: the limit of
    # (d)'s first mesh step against the unsharded step
    opt = AdamWConfig(total_steps=100)
    lr1, bc1, bc2 = schedule(opt, torch.ones((), dtype=torch.int32,
                                             device=dev))

    def first_updates(g_tree):
        scale = clip_scale(opt, global_norm(g_tree))
        for p_, g_ in zip(_leaves(params), _leaves(g_tree)):
            z = torch.zeros_like(p_, dtype=torch.float32)
            p1, _, _ = update_leaf(opt, g_, z, z.clone(), p_, lr=lr1,
                                   scale=scale, bc1=bc1, bc2=bc2,
                                   inplace=False)
            yield p1 - p_
    with torch.no_grad():
        upd_spread = max(float(torch.linalg.vector_norm(a - b)
                               / torch.linalg.vector_norm(b))
                         for a, b in zip(first_updates(g_o),
                                         first_updates(g_u)))
    del g_o
    gc.collect()
    kernels.reset_launches()
    mesh.reset_exchanged()
    loss_s, g_s = sharded.value_and_grad(make_mesh_loss_fn(cfg, plan, tc))(
        sp, batch)
    got = kernels.launches()
    want_train = mesh_launches(cfg, K, "train")
    assert {k: got[k] for k in want_train} == want_train, (got, want_train)
    err = 0.0
    for s, g in zip(shd.tree_leaves(g_s, lambda v: isinstance(
            v, shd.Sharded)), _leaves(g_u)):
        full = s.gather()
        err = max(err, float(torch.linalg.vector_norm(full - g)
                             / torch.linalg.vector_norm(g)))
        del full
    tol = max(TRAIN_MIN_TOL, 2 * spread)
    loss_tol = max(TRAIN_MIN_TOL, 2 * loss_spread)
    loss_err = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
    log(f"  one training step {TRAIN_BATCH}x{PREFILL_SEQ}: loss "
        f"{float(loss_s):.6f} (unsharded {float(loss_u):.6f}, rel "
        f"{loss_err:.2e}, limit {loss_tol:.2e}); gathered gradients: max "
        f"leaf rel err {err:.3e} (limit {tol:.3e} = 2 x the unsharded "
        f"kernel step's spread against its flags-off step, {spread:.3e}); "
        f"launches {want_train} (as predicted)")
    assert loss_err <= loss_tol, ("mesh loss vs unsharded", loss_err)
    assert err <= tol, ("mesh gradients vs unsharded", err, tol)
    out.update(train_loss=float(loss_s), unsharded_train_loss=float(loss_u),
               train_loss_rel_err=loss_err, train_loss_tol=loss_tol,
               grad_rel_err=err, grad_tol=tol, grad_spread=spread,
               train_launches=want_train)
    del g_s, g_u
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the unsharded step's time (donated; from here on ``params`` is its),
    # its first step's params kept on the host with each leaf's update
    # norm, for (d)'s first step (``sp`` still holds the initial params)
    ref_step = make_train_step(cfg, plan, opt, TrainConfig(donate=True))
    state = adamw_init(params)
    ref_times = []
    for i in range(2):
        (_, _, m), s_ = _timed(lambda: ref_step(params, state, batch), dev)
        ref_times.append(s_)
        assert np.isfinite(float(m["loss"]))
        if i == 0:
            ref_first = []
            for p_, s0 in zip(_leaves(params), shd.tree_leaves(
                    sp, lambda v: isinstance(v, shd.Sharded))):
                norm = float(torch.linalg.vector_norm(p_ - s0.gather()))
                ref_first.append((p_.to("cpu", copy=True), norm))
    del state, params
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()

    # (d) jit_train_step: ZeRO-1, the plan's remat, donated
    specs = shd.input_specs(cfg, ShapeSpec("mesh", PREFILL_SEQ, TRAIN_BATCH,
                                           "train"), mesh)
    tstep = jit_train_step(cfg, plan, opt, mesh, TrainConfig(),
                           batch_specs=specs)
    sp, so = tstep.shard(sp)
    o_sh = tstep.o_shardings
    m_bytes = [a + b for a, b in zip(
        _held_bytes(so["m"], p_shapes, o_sh["m"], mesh),
        _held_bytes(so["v"], p_shapes, o_sh["v"], mesh))]
    for m, sh in zip(shd.tree_leaves(so["m"], lambda v: isinstance(
            v, shd.Sharded)), shd.tree_leaves(o_sh["m"])):
        assert all(tuple(p.shape) == sh.shard_shape(m.shape)
                   for p in m.parts), (m, sh)
    losses, times, xchg = [], [], []
    for i in range(MESH_TRAIN_STEPS):
        kernels.reset_launches()
        (_, _, m), s_ = _timed(lambda: tstep(sp, so, batch), dev)
        got = kernels.launches()
        assert {k: got[k] for k in want_train} == want_train, got
        for k, v in got.items():
            counts[k] += v
        losses.append(float(m["loss"]))
        times.append(s_)
        xchg.append(dict(tstep.exchanged))
        for s in shd.tree_leaves(sp, lambda v: isinstance(v, shd.Sharded)):
            for grp in mesh.groups(("data",)):
                assert all(torch.equal(s.parts[grp[0]], s.parts[j])
                           for j in grp[1:]), ("replicas part", i)
        if i == 0:           # the first update against the unsharded one
            upd_err = 0.0
            for s, (want, norm) in zip(shd.tree_leaves(
                    sp, lambda v: isinstance(v, shd.Sharded)), ref_first):
                full = s.gather()
                upd_err = max(upd_err, float(torch.linalg.vector_norm(
                    full - want.to(full.device))) / norm)
                del full
            del ref_first
    upd_tol = max(TRAIN_MIN_TOL, 2 * upd_spread)
    assert upd_err <= upd_tol, ("mesh first update vs unsharded", upd_err,
                                upd_tol)
    assert all(np.isfinite(v) for v in losses), losses
    assert all(int(c) == MESH_TRAIN_STEPS for c in so["count"].parts)
    step_ms = float(np.median(times[1:])) * 1e3
    ref_ms = float(np.median(ref_times[1:])) * 1e3
    log(f"  jit_train_step x{MESH_TRAIN_STEPS} (ZeRO-1, remat, donated): "
        f"losses {losses}; the first step's gathered params vs the "
        f"unsharded step's: max leaf rel err of the update {upd_err:.3e} "
        f"(limit {upd_tol:.3e} = 2 x the first update's spread, the "
        f"flags-off gradients' against the kernel ones', {upd_spread:.3e});"
        f" the data replicas of every param block bitwise "
        f"equal after each step; every moment block of its ZeRO-1 shape; "
        f"launches a step {want_train}; {step_ms:.1f} ms a warm step "
        f"(unsharded {ref_ms:.1f} ms); exchanged bytes a step {xchg[-1]}; "
        f"moment bytes a slot {m_bytes} (the specs' count)")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    out.update(train_losses=losses, first_update_rel_err=upd_err,
               first_update_tol=upd_tol, first_update_spread=upd_spread,
               train_step_ms=step_ms,
               train_step_ms_all=[t * 1e3 for t in times],
               unsharded_train_step_ms=ref_ms,
               train_exchanged_bytes=xchg[-1],
               moment_bytes_per_slot=m_bytes, peak_memory_gb=peak,
               seconds=time.perf_counter() - t0)
    log(f"  peak memory over the path {peak} GB")
    results_paths.append(out)
    del sp, so, tstep
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    return counts


def _unsharded_logits_at(bundle, params, cfg, toks, col, dev):
    """The unsharded decode step's logits after feeding ``toks[:, :col]``
    (where two runs' tokens part)."""
    from repro_torch.models import init_cache
    c = init_cache(cfg, toks.shape[0], GEN_PROMPT + GEN_NEW, device=dev)
    lg = None
    for t in range(col):
        lg, c = bundle.decode_fn(params, c, toks[:, t:t + 1], t)
    return lg[:, -1]


def drive_mesh_family(arch, layers, mesh_shape, decodes, results_paths,
                      dev="cuda", cfg=None):
    """One family's short check on ``make_local_mesh(*mesh_shape)`` at
    ``layers`` layers: a ``MESH_PREFILL_BATCH`` x ``PREFILL_SEQ`` prefill
    against the unsharded kernel run, and (``decodes``) the mesh decode
    step (``jit_decode_step(cfg, plan, mesh, ...)``, graphed) over a
    ``GEN_BATCH`` x ``GEN_PROMPT`` prompt against the unsharded graphed
    step at the last prompt position, each within ``LLM_TOL`` /
    ``DECODE_TOL`` (rwkv6-7b ``RWKV_TOL``) with the shifted-position
    control rejected.  An MoE arch's sharded runs replay the unsharded
    runs' routes (``recorded_routes`` / ``replayed_routes``), and its
    decode steps run eagerly (``models.sharded.decode_step``): a replay
    would keep the captured step's routes.  Launches as
    ``mesh_launches``.  Returns the launch counts of the sharded runs."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import jit_decode_step
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, sharded)
    t0 = time.perf_counter()
    if cfg is None:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
    mesh = make_local_mesh(*mesh_shape, device=dev)
    K = mesh.size
    plan = Session(cfg, device=dev).default_plan(seq=PREFILL_SEQ).plan
    plan = dataclasses.replace(plan, use_flash_attention=True,
                               use_fused_mlp=True, use_fused_rmsnorm=True)
    tol = RWKV_TOL if cfg.family == "ssm" else LLM_TOL
    dec_tol = RWKV_TOL if cfg.family == "ssm" else DECODE_TOL
    params = init_params(cfg, seed=0, device=dev)
    p_shapes, p_sh = shd.params_for(cfg, mesh)
    sp = shd.shard_tree(params, p_sh)
    p_bytes = _held_bytes(sp, p_shapes, p_sh, mesh)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (MESH_PREFILL_BATCH, PREFILL_SEQ))).to(dev)
    stub = stub_inputs(cfg, MESH_PREFILL_BATCH, PREFILL_SEQ, 7, dev)
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    with recorded_routes() as routes:
        ref = forward(params, cfg, plan, prompt, **stub)[0]
    moe_ctx = ((lambda: replayed_routes(routes.routes)) if cfg.is_moe
               else contextlib.nullcontext)
    kernels.reset_launches()
    mesh.reset_exchanged()
    with moe_ctx():
        logits = sharded.forward(sp, cfg, plan, prompt, **stub)[0]
    got = kernels.launches()
    want = mesh_launches(cfg, K, "prefill")
    assert {k: got[k] for k in want} == want, (got, want)
    for k, v in got.items():
        counts[k] += v
    rel = _rel_to(logits, ref)
    control = max_err(logits[:, 1:], ref[:, :-1]) / float(ref.abs().max())
    out = dict(path=f"mesh family {cfg.name} {cfg.n_layers} layers on "
               f"{mesh_shape}", mesh=list(mesh_shape), layers=cfg.n_layers,
               param_bytes_per_slot=p_bytes, prefill_rel_err=rel,
               prefill_shifted_rel_err=control, tol=tol,
               prefill_launches=want,
               prefill_exchanged_bytes=dict(mesh.exchanged),
               moe_routes="the unsharded run's, replayed" if cfg.is_moe
               else None)
    text = (f"prefill {MESH_PREFILL_BATCH}x{PREFILL_SEQ} vs unsharded rel "
            f"err {rel:.3e} (tol {tol:g}; shifted {control:.3e}, must "
            f"exceed it), launches {want}")
    assert rel <= tol and control > tol, (rel, control, tol)
    del logits, ref
    if decodes:
        z = GEN_PROMPT + GEN_NEW
        gen_prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))).to(dev)
        if cfg.is_moe:
            step = (lambda p, c, tok, t: sharded.decode_step(
                p, c, cfg, plan, tok, t))
            ref_step = (lambda p, c, tok, t: decode_step(
                p, c, cfg, plan, tok, t, donate=True))
        else:
            step = jit_decode_step(cfg, plan, mesh, GEN_BATCH, z)
            ref_step = jit_decode_step(cfg, plan, None, GEN_BATCH, z)
        c_mesh = shd.shard_tree(init_cache(cfg, GEN_BATCH, z, device=dev),
                                shd.cache_for(cfg, mesh, GEN_BATCH, z)[1])
        c_ref = init_cache(cfg, GEN_BATCH, z, device=dev)
        with recorded_routes() as droutes:
            refs = []
            for t in range(GEN_PROMPT):
                b, _ = ref_step(params, c_ref, gen_prompt[:, t:t + 1], t)
                refs = (refs + [b.clone()])[-2:]
        kernels.reset_launches()
        with (replayed_routes(droutes.routes) if cfg.is_moe
              else contextlib.nullcontext()):
            for t in range(GEN_PROMPT):
                a, _ = step(sp, c_mesh, gen_prompt[:, t:t + 1], t)
        got = kernels.launches()
        want_d = mesh_launches(cfg, K, "decode")
        assert {k: got[k] for k in want_d} == {
            k: GEN_PROMPT * v for k, v in want_d.items()}, (got, want_d)
        for k, v in got.items():
            counts[k] += v
        d_rel = _rel_to(a, refs[-1])
        d_control = max_err(a, refs[-2]) / float(refs[-1].abs().max())
        if not cfg.is_moe:
            assert step.stats == {"traces": 1, "dispatches": GEN_PROMPT}
        out.update(decode_rel_err=d_rel, decode_previous_rel_err=d_control,
                   decode_tol=dec_tol, decode_launches_per_step=want_d,
                   decode_graphed=not cfg.is_moe)
        text += (f"; decode over a {GEN_BATCH}x{GEN_PROMPT} prompt "
                 f"({'eager, routes replayed' if cfg.is_moe else 'graphed'})"
                 f" vs unsharded at the last position rel err {d_rel:.3e} "
                 f"(tol {dec_tol:g}; the position before {d_control:.3e}, "
                 f"must exceed it)")
        assert d_rel <= dec_tol and d_control > dec_tol, (d_rel, d_control)
    out["seconds"] = time.perf_counter() - t0
    results_paths.append(out)
    log(f"  {cfg.name} ({cfg.n_layers} layers, "
        f"{''.join(k[0] for k in cfg.layer_kinds())}) on {mesh_shape}: "
        f"{text}; parameter bytes a slot {p_bytes}")
    del params, sp
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    return counts


#: phase 12's production-TP check: granite-3-8b at full width on
#: ``make_local_mesh(*MESH_TP)``, ``MESH_TP_LAYERS`` of its 40 layers (run
#: time).  At TP 16 its 32 query heads split (2 a slot) and its 8 kv heads
#: do not: attention is query-split (B5 on 2 query heads and the 1 kv head
#: they read a slot, that head's k / v columns all-gathered from the 2
#: slots that hold them), and the ``GEN_PROMPT + GEN_NEW`` = 48-entry
#: decode cache is sequence-sharded, 3 entries a slot
MESH_TP = (1, 16)
MESH_TP_LAYERS = 2


def query_split_exchanges(cfg, tp, mode, batch, seq):
    """The bytes and counts by kind that one ``mode`` pass of ``cfg`` (every
    layer ``attn`` with a dense MLP, query-split: TP divides its query
    heads and its kv heads divide TP) exchanges on a (1, ``tp``) mesh,
    from the shapes alone.  ``seq`` is the prefill or train length, or the
    decode cache's; ``train`` is the loss and its gradients under remat
    (each layer's exchanges again in its recompute, which stops early at
    the MLP's psum, whose output no backward reads; then each replicated
    leaf's gradient summed).  Parameters and partials fp32, activations
    bf16; the charges are ``DeviceMesh``'s: a psum or pmax of b bytes
    2(n-1)b, an all-gather n(n-1)b a group of n parts of b bytes, a
    gather the bytes that slot 0 does not hold."""
    n, L, B = tp, cfg.n_layers, batch
    D, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    E, V = cfg.resolved_head_dim, cfg.padded_vocab
    span = n // KVH                  # the slots that hold one kv head
    red = 2 * (n - 1)
    out = dict.fromkeys(("psum", "pmax", "all_gather", "ppermute",
                         "gather"), 0)
    if mode == "decode":
        out["psum"] = red * 4 * (B * D + L * (B * H + B * H * E
                                              + 2 * B * D))
        out["pmax"] = red * 4 * L * B * H
        out["all_gather"] = n * (n - 1) * 2 * L * (
            B * H * E // n + 2 * B * KVH * E // n)
        out["gather"] = (n - 1) * B * V // n * 4
        counts = dict(psum=1 + 4 * L, pmax=L, all_gather=3 * L, gather=1)
    else:
        rows = B * seq
        kv = KVH * span * (span - 1) * rows * (KVH * E // n) * 2
        times = 2 if mode == "train" else 1
        psums = 1 + 2 * L + (L if mode == "train" else 0)
        out["psum"] = red * 4 * rows * D * psums
        out["all_gather"] = 2 * L * times * kv
        counts = dict(psum=psums, pmax=0, all_gather=2 * L * times,
                      gather=0)
        if mode == "train":        # the loss, then the replicas' grads
            out["psum"] += red * 4 * (2 * rows + (2 * L + 1) * D)
            out["pmax"] = red * 4 * rows
            counts.update(psum=counts["psum"] + 2 + 2 * L + 1, pmax=1)
        else:                      # the logits and the cache to slot 0
            out["gather"] = (n - 1) * rows * V // n * 4 + \
                2 * L * (KVH - 1) * rows * E * 2
            counts["gather"] = 1 + 2 * L
    out.update({f"n_{k}": counts.get(k, 0) for k in
                ("psum", "pmax", "all_gather", "ppermute", "gather")})
    return out


def drive_mesh_tp(cfg, mesh_shape, results_paths, dev="cuda"):
    """Phase 12's production-TP check: ``cfg`` on ``make_local_mesh(
    *mesh_shape)``, its attention query-split (``models.sharded``'s
    ``attn_form``), each pass's exchanges by kind equal to
    ``query_split_exchanges``: (a) a 1 x ``PREFILL_SEQ`` prefill within
    ``LLM_TOL`` of the unsharded kernel run, the shifted control
    rejected; (b) ``generate`` of ``GEN_BATCH`` x (``GEN_PROMPT`` +
    ``GEN_NEW``) through ``ServeBundle.jit_decode(mesh, ...)``, its cache
    sequence-sharded, one replay a step, its tokens the unsharded
    bundle's (or parted at a near tie), the logits at the last prompt
    position within ``DECODE_TOL`` of the unsharded step's; (c) one
    training step's loss and gathered gradients of a ``TRAIN_BATCH`` x
    ``PREFILL_SEQ`` batch within ``max(TRAIN_MIN_TOL, 2 x spread)`` of the
    unsharded step's, no logits gathered.  B5-B7 launches as
    ``mesh_launches``.  Returns the launch counts of (a), (b) and (c)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import greedy_generate, jit_decode_step
    from repro_torch.launch.train import (TrainConfig, make_loss_fn,
                                          make_mesh_loss_fn, value_and_grad)
    from repro_torch.models import init_cache, init_params, sharded
    t0 = time.perf_counter()
    mesh = make_local_mesh(*mesh_shape, device=dev)
    K, tp = mesh.size, mesh.shape["model"]
    compiled = Session(cfg, device=dev).default_plan(seq=PREFILL_SEQ)
    plan = compiled.plan
    bundle = compiled.serve()
    params = init_params(cfg, seed=0, device=dev)
    sp = shd.shard_tree(params, shd.params_for(cfg, mesh)[1])
    walk = sharded._Walk(sp, cfg, plan)
    forms = [walk.attn_form(L["attn"]) for L in sp["layers"]]
    assert forms == ["query"] * cfg.n_layers, forms
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    out = dict(path=f"mesh {cfg.name} {cfg.n_layers} layers on "
               f"{mesh_shape} (query-split attention)",
               mesh=list(mesh_shape), layers=cfg.n_layers, forms=forms)
    rng = np.random.default_rng(1)

    def held(what, got, mode, batch, seq):
        want = query_split_exchanges(cfg, tp, mode, batch, seq)
        assert got == want, (what, got, want)
        out[f"{what}_exchanged_bytes"] = dict(got)
        return got

    def launched(mode, per=1):
        got = kernels.launches()
        want = mesh_launches(cfg, K, mode)
        assert {k: got[k] for k in want} == {
            k: per * v for k, v in want.items()}, (mode, got, want)
        for k, v in got.items():
            counts[k] += v

    # (a) prefill
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, PREFILL_SEQ))).to(dev)
    ref = bundle.prefill_fn(params, prompt)
    mesh.reset_exchanged()
    kernels.reset_launches()
    logits = sharded.forward(sp, cfg, plan, prompt)[0]
    launched("prefill")
    pre_x = held("prefill", dict(mesh.exchanged), "prefill", 1,
                 PREFILL_SEQ)
    rel = _rel_to(logits, ref)
    control = max_err(logits[:, 1:], ref[:, :-1]) / float(ref.abs().max())
    assert rel <= LLM_TOL and control > LLM_TOL, (rel, control)
    out.update(prefill_rel_err=rel, prefill_shifted_rel_err=control)
    del logits, ref

    # (b) generate through the bundle's mesh step
    z = GEN_PROMPT + GEN_NEW
    steps = z - 1
    gen_prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))).to(dev)
    step = bundle.jit_decode(mesh, GEN_BATCH, z)
    c_sh = shd.cache_for(cfg, mesh, GEN_BATCH, z)[1]
    scache = shd.shard_tree(init_cache(cfg, GEN_BATCH, z, device=dev), c_sh)
    k_spec = scache["layers"][0]["k"].sharding.spec
    assert k_spec[1] == "model" and \
        scache["layers"][0]["k"].parts[0].shape[1] == z // tp, k_spec
    kernels.reset_launches()
    toks = greedy_generate(sp, cfg, plan, gen_prompt, GEN_NEW,
                           step_fn=step, cache=scache)
    launched("decode", steps)
    assert step.stats == {"traces": 1, "dispatches": steps}, step.stats
    dec_x = held("decode_step", dict(step.exchanged), "decode", GEN_BATCH,
                 z)
    toks_ref = bundle.generate(params, gen_prompt, GEN_NEW)
    split = _first_split(toks, toks_ref, lambda col: _unsharded_logits_at(
        bundle, params, cfg, toks_ref, col, dev))
    dstep = jit_decode_step(cfg, plan, None, GEN_BATCH, z)
    c_ref = init_cache(cfg, GEN_BATCH, z, device=dev)
    c_mesh = shd.shard_tree(init_cache(cfg, GEN_BATCH, z, device=dev), c_sh)
    last = []
    for t in range(GEN_PROMPT):
        a, _ = step(sp, c_mesh, gen_prompt[:, t:t + 1], t)
        b, _ = dstep(params, c_ref, gen_prompt[:, t:t + 1], t)
        last = (last + [(a.clone(), b.clone())])[-2:]
    dec_rel = _rel_to(last[-1][0], last[-1][1])
    dec_control = (max_err(last[-1][0], last[-2][1])
                   / float(last[-1][1].abs().max()))
    assert dec_rel <= DECODE_TOL and dec_control > DECODE_TOL, (
        dec_rel, dec_control)
    out.update(decode_rel_err=dec_rel, decode_previous_rel_err=dec_control,
               cache_k_spec=list(k_spec), **split)
    del scache, c_mesh, c_ref, step, dstep
    bundle._steps.clear()
    bundle._caches.clear()
    gc.collect()

    # (c) one step's loss and gradients against the unsharded step's
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=PREFILL_SEQ,
                                      global_batch=TRAIN_BATCH))
    x, y = data.batch_at(0)
    batch = {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
    tc = TrainConfig()
    loss_u, g_u = value_and_grad(make_loss_fn(cfg, plan, tc))(params, batch)
    off = dataclasses.replace(plan, use_flash_attention=False,
                              use_fused_mlp=False, use_fused_rmsnorm=False)
    loss_o, g_o = value_and_grad(make_loss_fn(cfg, off, tc))(params, batch)
    spread = _leaf_rel(g_o, g_u)
    loss_spread = abs(float(loss_o) - float(loss_u)) / abs(float(loss_u))
    del g_o
    gc.collect()
    mesh.reset_exchanged()
    kernels.reset_launches()
    loss_s, g_s = sharded.value_and_grad(make_mesh_loss_fn(cfg, plan, tc))(
        sp, batch)
    launched("train")
    train_x = held("train", dict(mesh.exchanged), "train", TRAIN_BATCH,
                   PREFILL_SEQ)
    err = 0.0
    for s_, g in zip(shd.tree_leaves(g_s, lambda v: isinstance(
            v, shd.Sharded)), _leaves(g_u)):
        full = s_.gather()
        err = max(err, float(torch.linalg.vector_norm(full - g)
                             / torch.linalg.vector_norm(g)))
        del full
    tol = max(TRAIN_MIN_TOL, 2 * spread)
    loss_tol = max(TRAIN_MIN_TOL, 2 * loss_spread)
    loss_err = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
    assert loss_err <= loss_tol and err <= tol, (loss_err, loss_tol, err,
                                                 tol)
    out.update(train_loss=float(loss_s), unsharded_train_loss=float(loss_u),
               train_loss_rel_err=loss_err, train_loss_tol=loss_tol,
               grad_rel_err=err, grad_tol=tol, grad_spread=spread,
               seconds=time.perf_counter() - t0)
    results_paths.append(out)
    log(f"  {cfg.name} ({cfg.n_layers} layers) on {mesh_shape}, attention "
        f"{forms}: prefill 1x{PREFILL_SEQ} vs unsharded rel err {rel:.3e} "
        f"(tol {LLM_TOL:g}; shifted {control:.3e}, must exceed it); "
        f"generate {GEN_BATCH}x({GEN_PROMPT}+{GEN_NEW}), cache "
        f"{list(k_spec)}, {steps} replays: tokens {split}; decode logits "
        f"at the last prompt position rel err {dec_rel:.3e} (tol "
        f"{DECODE_TOL:g}; the position before {dec_control:.3e}, must "
        f"exceed it); one training step {TRAIN_BATCH}x{PREFILL_SEQ}: loss "
        f"{float(loss_s):.6f} (unsharded {float(loss_u):.6f}, rel "
        f"{loss_err:.2e}, limit {loss_tol:.2e}), gradients max leaf rel err "
        f"{err:.3e} (limit {tol:.3e}); exchanged bytes equal to the "
        f"formula's: prefill {pre_x}; decode step {dec_x}; train step "
        f"{train_x}; {out['seconds']:.1f} s")
    del params, sp, g_s, g_u
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 13: the dry run against the card
# --------------------------------------------------------------------------

#: phase 13 (a): granite-3-8b's production cells (the 16 x 16 meta mesh)
#: at ``TRAIN_LAYERS`` of its 40 layers, walked by ``launch.dryrun`` in
#: child processes that see no card, started with the run and read in
#: phase 13
DRYRUN_SHAPES = ("decode_32k", "prefill_32k")
#: seconds phase 13 waits at most for a child still walking
DRYRUN_WAIT = 600
#: phase 13 (b): the card's memory of a mesh step (the most allocated
#: over the step from a reset, less what the card held beside the step's
#: arguments, plus those) over the dry run's estimate (the slots' argument
#: + output + temp - alias bytes) must lie in this band (PERF.md §6)
MEMORY_BAND = (0.9, 1.15)
#: the card's memory, for the production cells' fit
CARD_BYTES = 80e9


def start_dryrun_cells():
    """One ``python -m repro_torch.launch.dryrun`` a shape of
    ``DRYRUN_SHAPES``, in the background, with no card visible; returns
    [(shape, process, JSON path, log path)].  Every child is stopped at
    exit if it still runs."""
    import atexit
    from repro_torch.kernels import build
    out = build.build_dir() / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src") + (
                   os.pathsep + os.environ["PYTHONPATH"]
                   if os.environ.get("PYTHONPATH") else ""))
    children = []
    for shape in DRYRUN_SHAPES:
        logf = out / f"{shape}.log"
        with open(logf, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 LLM_ARCH, "--shape", shape, "--mesh", "single", "--layers",
                 str(TRAIN_LAYERS), "--outdir", str(out)], cwd=ROOT, env=env,
                stdout=fh, stderr=subprocess.STDOUT)
        children.append((shape, proc,
                         out / f"{LLM_ARCH}__{shape}__single.json", logf))

    def stop():
        for _, proc, _, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    return children


def _terms(r):
    return (f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}")


def check_dryrun_cells(children, results_paths):
    """Phase 13 (a): each child's cell ``ok`` on 256 slots at
    ``TRAIN_LAYERS`` layers, its kernels' calls as ``mesh_launches``
    predicts for 256 slots; prints the roofline terms on the H100
    data-sheet peaks and the peak estimate against the card's memory."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LLM_ARCH), n_layers=TRAIN_LAYERS)
    for shape, proc, path, logf in children:
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=DRYRUN_WAIT)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(("dry-run cell still walking", shape))
        with open(logf) as fh:
            text = fh.read()
        assert rc == 0, (shape, rc, text[-3000:])
        with open(path) as fh:
            res = json.load(fh)
        assert res["status"] == "ok" and res["n_chips"] == 256 and \
            res["layers"] == TRAIN_LAYERS, res
        mode = "decode" if shape.startswith("decode") else "prefill"
        want = mesh_launches(cfg, 256, mode)
        calls = {k: v["calls"] for k, v in res["kernels"].items()}
        assert calls == want, (shape, calls, want)
        r, mem = res["roofline"], res["memory"]
        assert all(r[k] > 0 for k in ("compute_s", "memory_s",
                                      "collective_s")), r
        fits = mem["peak_estimate_bytes"] <= CARD_BYTES
        log(f"  {LLM_ARCH} {shape} on the 16x16 meta mesh, "
            f"{TRAIN_LAYERS} of 40 layers (walked in {res['lower_s']} s, "
            f"waited {time.perf_counter() - t0:.1f} s): {_terms(r)} (H100 "
            f"data-sheet peaks: predictions); a chip's flops "
            f"{res['cost']['flops_per_chip']:.4g}, bytes "
            f"{res['cost']['bytes_per_chip']:.4g}, collective bytes "
            f"{res['collectives']['total']:.4g}; peak estimate "
            f"{mem['peak_estimate_bytes'] / 1e9:.3f} GB a chip "
            f"({'fits' if fits else 'does not fit'} {CARD_BYTES / 1e9:.0f} "
            f"GB); kernel calls {calls}")
        results_paths.append(dict(path=f"dry run {LLM_ARCH} {shape} single "
                                  f"{TRAIN_LAYERS} layers", card=CARD,
                                  **{k: res[k] for k in (
                                      "lower_s", "memory", "cost",
                                      "collectives", "roofline", "kernels",
                                      "ops")}))


def drive_dryrun_vs_card(cfg, results_paths):
    """Phase 13 (b): phase 12's three steps (``cfg`` on
    ``make_local_mesh(*MESH_LLM)``: a ``MESH_PREFILL_BATCH`` x
    ``PREFILL_SEQ`` prefill, a decode step at ``GEN_BATCH`` x
    (``GEN_PROMPT`` + ``GEN_NEW``), a ZeRO-1 train step at ``TRAIN_BATCH``
    x ``PREFILL_SEQ``) walked by ``launch.dryrun.walk_cell`` on meta and
    eagerly on the card under the same counter.  Equal between the two:
    the contractions' flops, every kernel's calls, flops and bytes, the
    exchanges' bytes and counts by kind, the argument bytes; the card's
    launches those calls; the card's memory within ``MEMORY_BAND`` of the
    meta estimate.  Prints each step's time (two more runs, the least)
    beside its roofline bound on one card.  Returns the launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import _plan_for, walk_cell
    from repro_torch.launch.mesh import make_local_mesh
    meta = make_local_mesh(*MESH_LLM, device="meta")
    card = make_local_mesh(*MESH_LLM, device="cuda")
    K = card.size
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    for shape in (ShapeSpec("mesh prefill", PREFILL_SEQ, MESH_PREFILL_BATCH,
                            "prefill"),
                  ShapeSpec("mesh decode", GEN_PROMPT + GEN_NEW, GEN_BATCH,
                            "decode"),
                  ShapeSpec("mesh train", PREFILL_SEQ, TRAIN_BATCH,
                            "train")):
        plan = _plan_for(cfg, shape, "flash")
        m = walk_cell(cfg, shape, meta, plan)
        kernels.reset_launches()
        c = walk_cell(cfg, shape, card, plan, timed_runs=2)
        got = kernels.launches()
        gc.collect()
        torch.cuda.empty_cache()
        what = f"{shape.mode} {shape.global_batch}x{shape.seq_len}"
        for key in ("kernels", "exchanged"):
            assert m[key] == c[key], (what, key, m[key], c[key])
        assert m["counted"]["contraction_flops"] == \
            c["counted"]["contraction_flops"], (what, m["counted"],
                                                c["counted"])
        assert m["memory"]["arguments"] == c["memory"]["arguments"], what
        launched = {k: got[k] for k in kernels.WORK_KERNELS}
        assert launched == {k: 3 * v["calls"] for k, v in
                            c["kernels"].items()}, (what, launched)
        for k, v in got.items():
            counts[k] += v
        dm = c["device_memory"]
        step_bytes = dm["max_allocated"] - dm["allocated_before"]
        est = K * m["memory"]["peak_estimate_bytes"]
        measured = step_bytes + K * c["memory"]["argument_bytes"]
        ratio = measured / est
        walk_est = est - K * m["memory"]["argument_bytes"]
        flops = m["cost"]["flops_per_chip"] * K
        nbytes = m["cost"]["bytes_per_chip"] * K
        bound_s = max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES_S)
        work = {k: (v["calls"], v["flops"], v["bytes"])
                for k, v in m["kernels"].items() if v["calls"]}
        log(f"  {what}: meta and card equal in contraction flops "
            f"{m['counted']['contraction_flops']}, kernel work {work}, "
            f"exchanges {m['exchanged']}, argument bytes a slot "
            f"{m['memory']['arguments']}; ops {m['ops']} / {c['ops']}, "
            f"aten bytes {m['counted']['bytes']} / {c['counted']['bytes']} "
            f"(meta / card); memory: card {measured / 1e9:.3f} GB against "
            f"the estimate {est / 1e9:.3f} GB, ratio {ratio:.4f} (band "
            f"{MEMORY_BAND}); the step's own {step_bytes / 1e9:.3f} GB "
            f"against {walk_est / 1e9:.3f} GB; step "
            f"{c['run_seconds'] * 1e3:.2f} ms on the card against a bound "
            f"of {bound_s * 1e3:.3f} ms on one card (the slots' flops "
            f"{flops:.4g} and bytes {nbytes:.4g} at the H100 data-sheet "
            f"peaks); walks {m['seconds']:.1f} s (meta) / "
            f"{c['seconds']:.1f} s (card) [{CARD}]")
        assert MEMORY_BAND[0] <= ratio <= MEMORY_BAND[1], (what, ratio)
        results_paths.append(dict(
            path=f"dry run vs card {cfg.name} {cfg.n_layers} layers {what} "
            f"on {MESH_LLM}", card=CARD, memory_ratio=ratio,
            memory_band=list(MEMORY_BAND), card_bytes=measured,
            estimate_bytes=est, step_bytes=step_bytes,
            walk_estimate_bytes=walk_est, step_ms=c["run_seconds"] * 1e3,
            bound_ms_one_card=bound_s * 1e3, meta=m,
            card_walk={k: c[k] for k in ("seconds", "run_seconds",
                                         "device_memory", "ops", "counted",
                                         "cost", "roofline")}))
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one run() per main path "
                    "(device busy share, top kernels)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.frontends import make_feeds
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    # the sessions' codesign disk cache, like Triton's, under the build
    # directory of this checkout unless the caller names one
    os.environ.setdefault("CELLO_CACHE_DIR",
                          str(build.build_dir() / "codesign_cache"))
    # phase 13 (a)'s meta walks run on the host while the card works
    dryrun_children = start_dryrun_cells()
    # ---- phase 1: environment
    triton = build.import_triton()
    card_phase("1: environment")
    smi = CARD
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), triton "
        f"{triton.__version__}, repro_torch {repro_torch.__version__}, "
        f"device {torch.cuda.get_device_name(0)}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    log("  TF32 off (cuBLAS, cuDNN), float32 matmul precision 'highest'")

    # ---- phase 2: build
    card_phase("2: build")
    floors_started = start_floors()
    build.cuda_library()
    log(f"  CUDA C++ kernels built in {build.build_seconds:.2f} s "
        f"({build.build_dir()})")
    for line in build.build_log().splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            log(f"  ptxas: {line.strip()}")
    spills = {e: u["spill_bytes"] for e, u in ptxas_usage(
        build.build_log(), NO_SPILL).items()}
    log(f"  spill bytes (stores + loads) of the tensor-core, rows and B7 "
        f"kernels: {spills}")
    assert spills and not any(spills.values()), ("B5/B6/B7 spill", spills)

    dtypes = ("float32", "float64")
    results, paths = [], []
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    # ---- phase 3: kernels vs plain versions
    card_phase("3: kernels vs their plain versions on the card")
    t0 = time.perf_counter()
    sess = Session(device="cuda")
    # phase 4's paths: traced, codesigned, lowered, and feeds at both dtypes
    hpc = {}
    for wl, params, _dts, _check in HPC_PATHS:
        traced = sess.trace(workload=wl, **params)
        cd = traced.analyze().codesign()
        hpc[path_name(wl, params)] = (
            traced, cd, cd.lower(backend="cuda"),
            {dt: make_feeds(traced.program, seed=0, dtype=getattr(np, dt))
             for dt in dtypes})
    # cg, cg_sparse and jacobi2d are phase 3's and phase 8's operands too;
    # the random operand is B2's second case in phase 3
    cg_name, sp_name, jc_name = (path_name(wl, params) for wl, params, _d, _w
                                 in HPC_PATHS[:3])
    rnd_name = path_name(*HPC_PATHS[-1][:2])
    _, cg_cd, cg_plan, cg_feeds = hpc[cg_name]
    _, sp_cd, sp_plan, sp_feeds = hpc[sp_name]
    _, jc_cd, jc_plan, jc_feeds = hpc[jc_name]
    jc_feeds = jc_feeds["float32"]
    ob_plans, ob_feeds = overbooked_plans(dtypes)
    mesh = mesh_plans(sess, {cg_name: (cg_cd, cg_plan),
                             sp_name: (sp_cd, sp_plan),
                             jc_name: (jc_cd, jc_plan)})
    log(f"  plans and feeds made in {time.perf_counter() - t0:.1f} s")
    check_stream(cg_plan.compiled(), cg_feeds["float64"]["A"], results,
                 dtypes)
    check_stream_deferred(mesh[cg_name][0].compiled(),
                          cg_feeds["float64"]["A"], results, dtypes)
    csr = tuple(sp_feeds["float64"][f"A.{c}"]
                for c in ("indptr", "indices", "data"))
    rnd_csr = tuple(hpc[rnd_name][3]["float64"][f"A.{c}"]
                    for c in ("indptr", "indices", "data"))
    ob_csr = tuple(ob_feeds["cg_sparse", "float64"][f"A.{c}"]
                   for c in ("indptr", "indices", "data"))
    b3_pats = b3_patterns(csr)
    floor_empty, floor_gather = floors(floors_started)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    b2_shapes = check_spmv(b2_cases(csr, rnd_csr, ob_csr, b3_pats), results,
                           dtypes, floor_gather, lambda: flush.fill_(1.0))
    del flush
    ob_prefix = prefix_rows(ob_plans["cg_sparse", 0.25, "float64"])
    check_spmv_sliced(ob_csr, ob_prefix, results, dtypes)
    b3_shapes = check_spmv_sliced_shapes(b3_pats, dtypes)
    b4_shapes = check_stencil(results, dtypes)
    t0 = time.perf_counter()
    check_off_path(dtypes)
    log(f"  off-path checks took {time.perf_counter() - t0:.1f} s")
    b7_flush = torch.ones(64 << 20, device="cuda")      # 256 MB, read
    b7_sum = torch.empty((), device="cuda")
    for d in B7_WIDTHS:
        check_rmsnorm(results, floor_empty,
                      lambda: torch.sum(b7_flush, 0, out=b7_sum), d=d)
    check_rmsnorm_general(results)
    del b7_flush
    check_flash(results)
    check_flash_hybrid(results)
    check_flash_families(results)
    check_mlp(results)
    check_mlp_recurrent(results)
    check_mlp_families(results)
    check_rglru(results)
    check_wkv6(results)
    log(f"  kernel checks done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 4: the main path
    card_phase("4: the HPC path, Session(device='cuda') "
               "-> lower(backend='cuda') -> run()")
    seen = {}
    for wl, params, dts, witness in HPC_PATHS:
        name = path_name(wl, params)
        _, _, plan, feeds = hpc[name]
        check = (dict(witness=witness) if witness is not None
                 else dict(replay=jacobi_numpy(params["sweeps"])))
        for dt in dts:
            t0 = time.perf_counter()
            counts = drive_path(name, plan, feeds[dt], dt, paths, seen,
                                profile=args.profile,
                                walk_torch_ops=wl in WALK_TORCH_OPS,
                                **check)
            for k, v in counts.items():
                totals[k] += v
            log(f"  {name} {dt} took {time.perf_counter() - t0:.1f} s")
    counts = drive_overbooked(ob_plans, ob_feeds, dtypes, paths, seen,
                              profile=args.profile)
    for k, v in counts.items():
        totals[k] += v
    t0 = time.perf_counter()
    counts = drive_overbooked_batched(ob_plans, ob_feeds, dtypes, paths)
    for k, v in counts.items():
        totals[k] += v
    log(f"  the batched overbooked plans took {time.perf_counter() - t0:.1f}"
        " s")
    for k in ("stream", "spmv", "spmv_sliced", "stencil2d",
              "spmv_sliced_lanes"):
        assert totals[k] > 0, f"kernel {k} was never launched on the path"
    log(f"  launches over the HPC path: {totals}")
    two_threads = check_two_threads(
        (("cg(n=4096, iters=64) float32", cg_plan, cg_feeds["float32"]),
         ("jacobi2d(n=4096, sweeps=8) float32", jc_plan, jc_feeds)))
    log(f"  phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phases 5 and 6: the LLM serving paths
    for arch, seq, layer_kind, want, tols, layers in SERVE_PATHS:
        phase = ("5: a dense arch's serving path"
                 if get_config(arch).family == "dense" else
                 "6: a recurrent family's serving path")
        card_phase(f"{phase}, Session({arch!r}, device='cuda') -> "
                   f"trace('prefill', seq={seq}, layer_kind={layer_kind!r}) "
                   "-> codesign -> lower -> serve()"
                   + (f", {layers} of its layers" if layers else ""))
        t0 = time.perf_counter()
        counts = drive_serving(arch, seq, layer_kind, want, tols, paths,
                               profile=args.profile, n_layers=layers)
        for k, v in counts.items():
            totals[k] += v
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s, done at "
            f"{time.perf_counter() - t_start:.1f} s")
    for k in ("flash_attention", "fused_mlp", "rmsnorm", "rglru", "wkv6"):
        assert totals[k] > 0, f"kernel {k} was never launched on the path"

    # ---- phase 7: solver serving
    card_phase("7: solver serving, Server(PlanRouter(Session("
               "device='cuda')), ServeConfig(...)) with backend='cuda'")
    t0 = time.perf_counter()
    counts, routers = drive_solver_serving(results, paths)
    for k, v in counts.items():
        totals[k] += v
    for k in ("stream_lanes", "stream_lanes_finalize", "spmv_lanes",
              "stencil2d_lanes"):
        assert counts[k] > 0, f"lane kernel {k} never ran while serving"
    b3_lane_shapes = check_lanes(routers, results, dtypes, ob_csr,
                                 ob_prefix, b3_pats)
    check_bound_operator(routers)
    del routers
    torch.cuda.empty_cache()
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    # ---- phase 8: the device mesh
    card_phase(f"8: the device mesh, Session(device='cuda') -> codesign -> "
               f"lower(mesh={MESH_K}, backend='cuda') -> run(), "
               f"{MESH_K} slots on one card")
    t0 = time.perf_counter()
    seen, mesh_totals = {}, dict.fromkeys(kernels.LAUNCHES, 0)
    crossover = (f"{cg_name} crossover {CROSSOVER_CAPACITY >> 20} MiB")
    for name, feeds, dt, check in (
            (cg_name, cg_feeds["float32"], "float32",
             dict(witness=DENSE_RESIDUAL)),
            (sp_name, sp_feeds["float32"], "float32",
             dict(witness=SPARSE_RESIDUAL)),
            (sp_name, sp_feeds["float64"], "float64",
             dict(witness=SPARSE_RESIDUAL)),
            (jc_name, jc_feeds, "float32", dict(replay=jacobi_numpy(8))),
            (crossover, cg_feeds["float32"], "float32",
             dict(witness=DENSE_RESIDUAL))):
        plan, single = mesh[name]
        counts = drive_mesh(f"{name} mesh={MESH_K}", plan, single, feeds, dt,
                            paths, seen, **check)
        for k, v in counts.items():
            totals[k] += v
            mesh_totals[k] += v
    check_mesh_of_one(*mesh[f"{cg_name} K=1"], cg_feeds["float32"])
    for k in ("stream_deferred", "stream_deferred_finalize", "spmv"):
        assert mesh_totals[k] > 0, f"kernel {k} was never launched on the mesh"
    log(f"  launches over the mesh paths: "
        f"{ {k: v for k, v in mesh_totals.items() if v} }")
    del mesh
    torch.cuda.empty_cache()
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    # ---- phase 9: the MoE, audio and vlm serving paths
    family_totals = dict.fromkeys(kernels.LAUNCHES, 0)
    for arch, layers, stub, decode_check, want, tols in FAMILY_PATHS:
        card_phase(f"9: the {arch} serving path, Session({arch!r}, "
                   f"device='cuda') -> trace('prefill', seq={PREFILL_SEQ}) "
                   "-> codesign -> lower -> serve()"
                   + (f", {layers} of its layers" if layers else ""))
        t0 = time.perf_counter()
        counts = drive_serving(arch, PREFILL_SEQ, None, want, tols, paths,
                               profile=args.profile, n_layers=layers,
                               stub=stub, decode_check=decode_check)
        for k, v in counts.items():
            totals[k] += v
            family_totals[k] += v
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s, done at "
            f"{time.perf_counter() - t_start:.1f} s")
    for k in ("flash_attention", "fused_mlp", "rmsnorm"):
        assert family_totals[k] > 0, f"kernel {k} was never launched"

    # ---- phase 10: the codesign disk cache
    card_phase("10: the codesign disk cache, a cold and a warm "
               "Session(device='cuda', cache_dir=...) on cg(n=4096, "
               "iters=64)")
    counts = check_codesign_cache(paths)
    for k, v in counts.items():
        totals[k] += v

    # ---- phase 11: training
    train_totals = dict.fromkeys(kernels.LAUNCHES, 0)
    t_train = time.perf_counter()
    for arch, layers, batch_size, seq in TRAIN_PATHS:
        card_phase(f"11: the {arch} training path, Session({arch!r}, "
                   f"device='cuda').default_plan(seq={seq}).train(...)"
                   + (f", {layers} of its layers" if layers else ""))
        t0 = time.perf_counter()
        counts = drive_training(arch, layers, batch_size, seq, paths,
                                profile=args.profile)
        for k, v in counts.items():
            totals[k] += v
            train_totals[k] += v
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s, done at "
            f"{time.perf_counter() - t_start:.1f} s")
    for k in ("flash_attention", "fused_mlp", "rmsnorm", "rglru", "wkv6"):
        assert train_totals[k] > 0, \
            f"kernel {k} was never launched in training"
    log(f"  phase 11 took {time.perf_counter() - t_train:.1f} s")

    # ---- phase 12: the LLM mesh
    mesh_totals = dict.fromkeys(kernels.LAUNCHES, 0)
    t_mesh = time.perf_counter()
    card_phase(f"12: the LLM mesh, {LLM_ARCH} ({TRAIN_LAYERS} of its "
               f"layers) on make_local_mesh{MESH_LLM}: models.sharded "
               "prefill, generate through ServeBundle.jit_decode(mesh, ...), "
               "jit_train_step with ZeRO-1")
    runs = [lambda: drive_llm_mesh(dataclasses.replace(
        get_config(LLM_ARCH), n_layers=TRAIN_LAYERS), MESH_LLM, paths),
            lambda: drive_mesh_tp(dataclasses.replace(
                get_config(LLM_ARCH), n_layers=MESH_TP_LAYERS), MESH_TP,
                paths)]
    runs += [functools.partial(drive_mesh_family, arch, layers, shape, dec,
                               paths) for arch, layers, shape, dec
             in MESH_FAMILIES]
    for i, run in enumerate(runs):
        if i == 1:
            card_phase(f"12: {LLM_ARCH} at the production TP, "
                       f"{MESH_TP_LAYERS} of its layers on make_local_mesh"
                       f"{MESH_TP}: query-split attention, the decode cache "
                       "sequence-sharded, the loss vocab-parallel")
        elif i:
            arch, layers, shape, dec = MESH_FAMILIES[i - 2]
            card_phase(f"12: the {arch} mesh check, {layers} of its layers "
                       f"on make_local_mesh{shape}")
        counts = run()
        for k, v in counts.items():
            totals[k] += v
            mesh_totals[k] += v
        log(f"  done at {time.perf_counter() - t_start:.1f} s")
    for k in ("flash_attention", "fused_mlp", "rmsnorm", "rglru", "wkv6"):
        assert mesh_totals[k] > 0, f"kernel {k} was never launched on the mesh"
    log(f"  phase 12 took {time.perf_counter() - t_mesh:.1f} s; launches "
        f"{ {k: v for k, v in mesh_totals.items() if v} }")

    # ---- phase 13: the dry run against the card
    t_dry = time.perf_counter()
    card_phase(f"13: the dry run (launch/dryrun.py) on the meta device: "
               f"{LLM_ARCH} {DRYRUN_SHAPES} on the production mesh, "
               f"{TRAIN_LAYERS} of its layers; then phase 12's three steps "
               f"on meta and on the card under one counter")
    check_dryrun_cells(dryrun_children, paths)
    counts = drive_dryrun_vs_card(dataclasses.replace(
        get_config(LLM_ARCH), n_layers=TRAIN_LAYERS), paths)
    for k, v in counts.items():
        totals[k] += v
    for k in ("flash_attention", "fused_mlp", "rmsnorm"):
        assert counts[k] > 0, f"kernel {k} was never launched in phase 13"
    log(f"  phase 13 took {time.perf_counter() - t_dry:.1f} s")
    log(f"  launches over the main paths: {totals}")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    # ---- results
    # name: (route, source, TPU kernel, the path's dtype)
    meta = {
        "stream": ("triton", "src/repro_torch/kernels/stream.py",
                   "src/repro/exec/pallas.py:427", "float32"),
        "spmv": ("cuda", "src/repro_torch/csrc/spmv.cu",
                 "src/repro/exec/pallas.py:595", "float32"),
        "spmv_sliced": ("cuda", "src/repro_torch/csrc/spmv.cu",
                        "src/repro/exec/pallas.py:616", "float32"),
        "stencil2d": ("cuda", "src/repro_torch/csrc/stencil.cu",
                      "src/repro/exec/pallas.py:687", "float32"),
        "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:30",
                            "bfloat16"),
        "fused_mlp": ("cuda", "src/repro_torch/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp/kernel.py:37",
                      "bfloat16"),
        "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:21", "bfloat16"),
        "rglru": ("cuda", "src/repro_torch/csrc/rglru.cu",
                  "src/repro/kernels/rglru/kernel.py:27", "bfloat16"),
        "wkv6": ("cuda", "src/repro_torch/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6/kernel.py:26", "bfloat16"),
        # the lane forms: what vmap made of the TPU kernels for serving
        # (src/repro/serve/batched.py runs jax.vmap over them)
        "stream_lanes": ("triton", "src/repro_torch/kernels/stream.py",
                         "src/repro/exec/pallas.py:427", "float32"),
        "spmv_lanes": ("cuda", "src/repro_torch/csrc/spmv.cu",
                       "src/repro/exec/pallas.py:595", "float32"),
        "stencil2d_lanes": ("cuda", "src/repro_torch/csrc/stencil.cu",
                            "src/repro/exec/pallas.py:687", "float32"),
        "spmv_sliced_lanes": ("cuda", "src/repro_torch/csrc/spmv.cu",
                              "src/repro/exec/pallas.py:616", "float32"),
        # B1's deferred-finalize mode: each mesh shard's pass
        # (src/repro/exec/sharded.py:366-369 builds _StreamCall with
        # defer_finalize=True)
        "stream_deferred": ("triton", "src/repro_torch/kernels/stream.py",
                            "src/repro/exec/pallas.py:427", "float32"),
    }
    table = []
    for k, (route, source, replaces, path_dt) in meta.items():
        cases = [r for r in results if r["kernel"] == k]
        # the first case at the path's dtype: the main path's (prefill) shape
        head = next(r for r in cases if r["dtype"] == path_dt)
        entry = dict(name=k, route=route, source=source, replaces=replaces,
                     launches=totals[k], max_abs_err=head["max_abs_err"],
                     ms=head["ms"], plain_ms=head["plain_ms"],
                     bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                     library_ms=head["library_ms"], case=head["case"],
                     dtype=head["dtype"], cases=cases)
        if k in ("stream", "stream_lanes", "stream_deferred"):
            entry["finalize_launches"] = totals[f"{k}_finalize"]
        table.append(entry)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"nvidia_smi": smi, "kernels": table, "paths": paths,
                       "b2_shapes": b2_shapes,
                       "b3_shapes": b3_shapes,
                       "b3_lane_shapes": b3_lane_shapes,
                       "b4_shapes": b4_shapes,
                       "two_threads": two_threads,
                       "build_seconds": build.build_seconds}, fh, indent=1)
    log(smi_line())
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "cases"} for e in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
