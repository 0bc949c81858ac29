#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the exit code
is non-zero):

1. environment: the card, its power limit, torch / CUDA / nvcc versions;
2. build: compiles the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at ragged ones, with its time, the plain
   version's, a one-call PyTorch yardstick where there is one, and the
   least time the card could take for the same work (K1's fused MK-MMD
   term, forward and backward, at the CNN's and the LM's pooled features,
   with the whole term's forward + dx against the three-Gram-sum route;
   K3 also over whole messages, scales included, two launches per 64
   leaves: CNN_MNIST's eight leaves, odd, unaligned and zero leaves, 70
   leaves, with offsets and without, timed per message (device ops and
   microseconds too) against the per-leaf route, and at the levels of the
   int8 ladder (4, 8) the adaptive controllers use, the level an int32 the
   kernel reads on the device: both levels against the plain version, one
   captured encode replayed at levels 0, 1, 0, and the message timed at
   level 0 beside the capacity encode; K4 also over whole
   messages, one launch per 64 leaves: CNN_MNIST's eight leaves at int8
   and int4, odd and unaligned leaves, 70 leaves, timed against one
   ``torch._foreach_mul`` and eight ``torch.mul`` calls; the host cost of
   each piece of a K4 wrapper call;
   K5 also against ``hardshrink(x, nextafter(t, 0))``, bit for bit, and
   both timed by device microseconds a call at the FC leaf and at
   smollm-135m's token embedding (``TOPK_BIG``, past the L2), with K5's
   schedule; K5 on NaN, +-inf, -0.0, ties and thresholds 0, < 0, +inf at
   n on each side of its schedule's tile and wave, aligned and 4 bytes
   off, bit for bit; the host cost of each piece of a K5 wrapper call
   beside ``hardshrink``'s; K6 / K7: exact, K7 in place,
   the scratch-row duplicates; K8a flash attention forward (bitwise
   repeatable, with ``flash_attn.fwd_plan``'s modelled makespan) and K9
   flash-decode (one launch) at the serve shapes of gemma3-1b,
   smollm-135m, stablelm-3b (hd 80) and h2o-danube-3-4b (hd 120, its
   4,096 window binding at a 4,608-token prompt) and at rep 16, against
   ``scaled_dot_product_attention`` as the yardstick, with their device
   microseconds a call and their share of the bound; K8b / K8c, the flash
   backward, at the four models' training shapes, h2o-danube-3-4b's
   window-bound 4,608 positions and two ragged ones, against that
   function's backward, and bitwise repeatable, with K8b's and K8c's
   segment plans and device microseconds; K2 at the CNN's shapes and
   smollm-135m's LM fusion (8,192 x 576), against
   ``torch.mm(torch.cat(...))``, with its tiling; then the tensor-parallel
   slice's kernels: K9's ``lse`` at a rank's half of gemma3-1b's and
   stablelm-3b's caches, valid length 0 included, timed with and without
   it by wall and device microseconds, slices merged against one call,
   and K2 on column blocks W [2C, C/2]); K8a, K8b / K8c and K9 at
   recurrentgemma-9b's local layers (16 query heads over one KV head of
   256, window 2,048: its 2,560-token serve prompt, its training batch of
   2 x 1,024, its full 2,048 ring); K8a, K8b / K8c without the causal
   mask at whisper-large-v3's encoder (4 x 1,500 frames, 20 heads of 64)
   and with it at its decoder's training batch (4 x 448), K8a / K8b / K8c
   and K9 at qwen2-vl-7b's heads (28 over 4 KV heads of 128), K9 over
   whisper's 1,500-frame cross cache (no valid length), and K2 at their
   FedFusion-conv steps (1,792 x 1,280 and 2,048 x 3,584);
4. main path: federated training of the paper's CNN_MNIST at full width
   (fig. 4 settings: 100 non-IID clients, 10 per round, 4 local steps of
   10 examples, eval on 2048 test examples every round) through
   ``run_federated_reference`` for FedAvg, FedMMD and FedFusion-conv, then
   with fig. 7's wire codecs (int8, top-k with error feedback, int4 up
   with int8 down); then the engine (``run_federated``, 40 rounds in
   8-round chunks, each a CUDA graph replay, eval folded into the chunk)
   for FedAvg, FedFusion-conv with a top-k uplink on the dense and on the
   host EF store, and FedMMD client-sequential with an int8 uplink, beside
   the same configuration's reference rounds/s over 8 rounds (12 until
   PR 28); each run's
   kernel launch counts must equal the path's formula (K3 twice per
   quantized message, K4 once per message) and its bytes the
   reference's (FedMMD: the fused term once forward and once backward per
   local step); then FedAvg with ``superstep_rounds="auto"`` beside the
   fixed 8;
4b. serve: the transformer LMs at full width and depth through
   ``repro_torch.launch.serve`` (``attn_impl="pallas"``): gemma3-1b,
   smollm-135m and stablelm-3b at batch 4 with 1,024-token prompts, then
   h2o-danube-3-4b at batch 1 with a 4,608-token prompt (its 4,096 window
   binds in prefill and the ring caches roll while decoding), then
   granite-moe-1b (32 experts, top 8) at batch 4 x 1,024, mamba2-130m
   (24 SSD layers: its cache the states and conv windows) at 4 x 1,024
   and recurrentgemma-9b (38 layers, 12 local-attention layers among
   RG-LRU ones) at 1 x 2,560 (its 2,048 window binds), whisper-large-v3
   (32 + 32 layers) at 4 x (1,500 stub frames + a 64-token prompt) and
   qwen2-vl-7b at 4 x 1,024 (the first 256 positions stub patch
   embeddings, three M-RoPE streams), random weights
   from seed 0, 32 greedy tokens, after one warm-up run: prefill ms,
   decode ms per step, tokens/s, peak memory; K8a must launch once per
   attention layer per prefill and K9 once per attention layer per decode
   step; the last decode step's logits must match ``forward_seq`` over the
   same tokens (at full expert capacity for MoE, as decode runs); then a
   second request (prompts from seed 1), and both requests through one
   ``launch.serve.DecodeGraph`` (the decode step captured once as a CUDA
   graph, replayed once a token): tokens equal and logits bit-equal to
   the eager runs', median ms a step both ways, warm-up, capture and
   instantiation seconds, graph pool bytes, and K9 once a layer at the
   warm-up and the capture, once a layer a replay (uncounted by the
   wrappers, added to the table);
4c. train: federated LM training at full width (and full depth, unless
   cut) through ``repro_torch.launch.train`` (``attn_impl="pallas"``,
   random weights from seed 0): smollm-135m at sequence length 1,024,
   global batch 8, 2 rounds each of FedAvg, FedMMD and FedFusion-conv;
   gemma3-1b at 1,024 and batch 4, 2 rounds of FedAvg; stablelm-3b and
   h2o-danube-3-4b and granite-moe-1b at full width with the depth cut to
   4 layers, 1,024 and batch 4, 2 rounds of FedAvg (granite's trained
   Switch aux on 4 x 1,024, finite); recurrentgemma-9b at full width cut
   to one cycle (RG-LRU, RG-LRU, local attention) in its client_sequential
   mode, 1,024 and batch 8; qwen2-vl-7b FedFusion-conv at full width cut
   to 4 of its 28 layers, client_sequential, 1,024 and batch 8 (stub patch
   embeddings); then ``run_federated_reference`` with the smollm-135m
   bundle (FedFusion-conv, 8 clients by source, 4 a round, 2
   local steps of 4 sequences of 512, eval on 8 test sequences): ms per
   local step, tokens/s, peak memory, each round's loss, and K1 / K2 / K8a /
   K8b / K8c launches, which must equal the path's formula; then
   stablelm-3b (32 layers) and h2o-danube-3-4b (24) at full depth, one
   FedAvg round of 1 client x 2 local steps (2 clients until the mesh
   families were added: the script's time limit) (``remat_runs``): the
   memory
   split (weights, the round's client state, the forward's activations),
   ``remat="none"`` and ``"layer"`` at the largest batch of 1,024 that
   ``"none"`` holds, and ``"layer"`` at twice it, peak memory and ms a
   local step each, K8a once more a layer a step under ``"layer"``; then
   whisper-large-v3 at full depth in its client_parallel mode
   (``encdec_train_runs``): one FedAvg and one FedFusion-conv round of 2
   clients x 2 local steps of 4 x 448 tokens beside 1,500 stub frames,
   the memory split, the first round's ms a local step, launches against
   their formula;
4d. the rest of the main path, CNN_MNIST at its published width: fig. 6
   (``benchmarks/fig6_newclient.py``'s settings: 8 permuted clients, 4 a
   round, 4 local steps of 32, lr 0.06, decay 0.99; 15 engine rounds in
   5-round chunks for FedAvg and FedFusion single / multi / conv, then
   the newcomer from ``permuted_partition(..., seed=1234)`` for 6 local
   epochs): per-epoch accuracies, ms per probe epoch and K2's launches
   against their formula; the cost of a local step of each client
   objective (FedAvg, FedL2, FedProx, FedMMD, FedFusion conv / multi /
   single) at the fig. 4 setting, wall ms (the objectives in turns) and
   device ops and µs under ``torch.profiler``, each against FedAvg's; the
   sketch codecs ``mask`` and ``lowrank`` at fig. 7's fraction, at half
   fig. 4's lr, on the reference loop (8 rounds) and the engine (40
   rounds in 8-round chunks): rounds/s, finite losses, and bytes up equal
   to the codec's formula on both; participation with fig. 8's
   chaos on the engine (40 rounds in 8-round chunks): FedFusion-conv with
   a top-k uplink under ``deadline`` (cohort 15) and FedMMD
   client-sequential int8 under ``buffered_async`` (K = 5): steady
   rounds/s, mean ``sim_time`` and ``arrived``, bytes up against the
   ``n_up`` formula and launches against their formulas (over the whole
   cohort: masked clients train, and their EF rows are written back
   unchanged);
4e. observability and the adaptive controllers on the engine, at fig. 4's
   setting (40 rounds in 8-round chunks): FedAvg with a top-k uplink with
   telemetry off and on (bit-equal under cuDNN's deterministic
   algorithms, rounds/s of both); the controllers ``ef_ratio`` and
   ``loss_trend`` on the top-k ladder (1/64, 1/32, 1/16) and
   ``bytes_budget`` on the int8 ladder (4, 8) at 0.75 of capacity:
   rounds/s, the level schedule, each round's bytes against
   ``level_bytes``, launches against their formula (K3 twice a message
   at any level); the ``ef_ratio`` run's run log built into a report that
   renders; a 16-round ``profile_dir=`` run whose trace holds one
   ``superstep`` range per chunk with its ``cudaGraphLaunch``;
   ``halt_on_nonfinite`` on a run made to diverge (NaN rows in the images
   of the first client sampled after the first chunk): it stops at the
   first boundary after the non-finite round with a checkpoint marked
   halted, while the same run without the flag goes on; and the flag's
   rounds/s on a finite run;
4f. the client-sharded engine on one rank of an NCCL group (the one-card
   host shows only S = 1; S > 1 is held on the CPU over gloo,
   ``tests/test_torch_sharded.py``), at fig. 4's setting (24 rounds in
   8-round chunks, 40 until phase 4j; cuDNN deterministic): a 1 x 1
   ``make_engine_mesh()``
   run equal bit for bit to the ``mesh=None`` run (FedFusion-conv top-k);
   the shard-aware supersteps over a one-rank ``ClientSharding``, each
   chunk captured by the engine as one CUDA graph with the NCCL
   all-reduces inside (fused FedAvg with the sharded evaluator, fused
   FedFusion-conv top-k on the dense and the host EF store, unfused
   FedFusion-conv top-k, fused FedMMD client-sequential int8), each within
   rtol 2e-5 / atol 1e-6 of the single-device run (whether bitwise is
   printed), bytes equal, all-reduces a replay (K + 1 fused, plus K with
   the sharded evaluator; the unfused count) and K1 / K2 / K3 / K4 / K6 /
   K7 launches equal to their formulas, steady rounds/s beside the
   single-device run's; the sharded evaluator's metrics equal to the
   replicated one's; the NCCL kernels of one traced replay;
4g. the engine over LM bundles at full width (CUDA-graph supersteps over
   the transformer, K8a-K8c inside the graphs, ``attn_impl="pallas"``,
   random weights from seed 0, lr 0.02): smollm-135m at full width cut to
   4 of its 30 layers (to keep the script within its time limit) at
   phase 4c's reference setting (8 clients by source, 4 a round,
   2 local steps of 4 x 512, eval on 8 test sequences every round, folded
   into the chunk), 4 rounds in 2-round chunks, for FedAvg,
   FedFusion-conv, FedMMD, FedFusion-conv with a top-k 1/16 uplink on the
   host EF store and FedAvg with an int8 uplink, each beside 2 reference
   rounds from the same state: steady rounds/s, ms per local step and
   tokens/s against the reference's, each graph's warm-up, capture and
   instantiation seconds and pool bytes, peak memory, finite losses,
   bytes equal to the reference's, and K1-K4, K6, K7, K8a-K8c launches
   equal to their formulas; the one-rank shard-aware fused FedAvg
   superstep over NCCL, bit-equal to the FedAvg run with K + 1
   all-reduces a replay; gemma3-1b at full width and depth, FedAvg, 2 of 4
   clients a round at 2 x 1,024 (its 512-token local window binds), 4
   rounds in 2-round chunks; ``launch.train --engine`` on smollm-135m at
   its reduced scale (4 rounds at 512, batch 2,
   ``superstep_rounds="auto"``); mamba2-130m at full width, 6 of its 24
   layers, FedAvg and FedFusion-conv (K2 in the graphs), 2 of 4 clients at 4 x
   256, 4 rounds in 2-round chunks, equal bit for bit to the reference
   loop over the same rounds; smollm-135m (4 layers) FedAvg with
   ``remat="none"`` and ``"layer"`` through the engine, each equal to its
   reference loop, the graph pools' bytes side by side;
4h. tensor parallelism on the one card: (b) a one-rank NCCL (1, 1) mesh
   through ``launch.steps``' builders, a smollm-135m launcher round and
   two serving requests, eager and through one captured decode step,
   bit-equal to ``mesh=None``; (a) two worker processes
   (``chip_smoke.py --tp-worker``) on a (1, 2) mesh over gloo: stablelm-3b
   at full width cut to 2 layers (head-parallel) trains FedFusion-conv
   and FedAvg (2 rounds of 2 local steps of 4 x 512) and serves, gemma3-1b
   at full width cut to 13 layers (gathered, its caches halved on L)
   serves, 4 x 1,024 then 8 eager steps each (gloo cannot be captured)
   teacher-forced on the one-device run's tokens;
   states and logits against one device, launches on each rank against
   their formulas, ms beside one device's, labelled "gloo over one card";
4i. the mesh families on the one card: two worker processes
   (``chip_smoke.py --mesh-worker``) over gloo.  On a (1, 2) mesh, the
   model split: mamba2-130m at full width cut to 8 of its 24 layers (all
   24 until phase 4j was added: the script's time limit; each rank the P
   slice of every SSD head) at 2 x 512, recurrentgemma-9b at full width
   cut to one cycle (W blocks of the RG-LRU layers) at 2 x 512,
   whisper-large-v3 at full width cut to 2 encoder and 2 decoder layers
   (its 1,500-frame cross cache split 750 + 750: K9 on each slice with
   no valid length and lse, merged) at 2 x 64, qwen2-vl-7b at full width
   cut to 1 layer (256 stub patch embeddings) at 2 x 512: prefill and 8
   eager decode steps teacher-forced on the one-device run's greedy
   tokens, logits against one device, launches on each rank against
   their formulas.  On a (2, 1) mesh, FSDP: one qwen2-vl-7b FedMMD round
   at full width cut to 1 layer (4 clients in turn x 2 local steps of 2
   x 512, each data rank one row of each client; K1, K8a-K8c at hd 128)
   from the seeded state, the gathered state and the loss against the
   same round on one device: ms a local step, the bytes through gloo a
   step, each rank's persistent and peak bytes beside one device's;
4j. the static analyzer (``repro_torch.analysis``): every point of the
   quick matrix lowered inside the engine's CUDA-graph capture with the
   op recorder on, at K and K + 1 rounds, the sharded points over a
   one-rank NCCL group; every pass clean, the ``kernel:*`` entries'
   launches equal to the kernel counters' deltas over each capture, the
   cost model's FLOPs and bytes equal to the same point lowered on the
   CPU (three ``--analysis-worker`` processes beside the card's loop); a
   planted ``.item()`` caught; one dry-run point (smollm-135m x
   decode_32k on the 16 x 16 mesh over a fake process group) with its
   roofline terms;
5. trace: one round per algorithm, and one int8-coded FedAvg round, under
   ``torch.profiler`` (a separate run): device kernels launched, the
   device's busy share of the wall time, and the kernels taking the most
   device time; then the last (steady) chunk of two engine runs; and one
   gemma3-1b prefill, one eager decode step and one request's 32 graph
   replays, which must show 32 ``cudaGraphLaunch`` calls (taken during
   phase 4b); and one
   smollm-135m FedFusion-conv local step (after phase 4c); and one steady
   1-round LM engine chunk (smollm-135m FedFusion-conv, phase 4g's
   setting): device ops a replay, busy share, the top kernels;
6. card vs CPU: the same initial state and data trained 2 rounds on the
   card (kernels) and on the CPU (plain versions) must agree, with and
   without codecs; then the engine's graph replays against the reference
   loop on the card (cuDNN deterministic; FedFusion-conv top-k on the
   dense and the host EF store 24 rounds, 40 until the analyzer was
   added; FedAvg and FedMMD 16, 40 until the mesh families were added),
   which must be equal; fig. 6's first held probe segment in float64 on
   the CPU beside both float32 paths, their ReLU and max-pool masks
   compared call by call (printed, not held);
   then serving: gemma3-1b at full width cut to 6 layers, a 576-token
   prompt and 4 greedy steps, the same weights on the card and the CPU;
   then LM training: smollm-135m at full width cut to 2 layers,
   FedFusion-conv through the ``launch.train`` loop, one round (two until
   the decode-graph and MoE runs were added), batch 2, sequence length
   128 (256 until the recurrent families were added), from the same
   state on the card and the CPU; then serving (2 layers) and one FedAvg
   round (1 layer; 2 until then)
   for stablelm-3b and h2o-danube-3-4b at full width (hd
   80 and 120), and for granite-moe-1b at full width; mamba2-130m at 2
   SSD layers (both); recurrentgemma-9b at one cycle, its vocabulary cut
   to 16,384 (serving a 256-token prompt, training one sequence of 16);
   whisper-large-v3 at 2 + 2 layers over its 1,500 frames (serving a
   64-token prompt; training at 1 + 1 layers, one sequence of 16) and
   qwen2-vl-7b at 2 layers, its vocabulary cut likewise (serving 300
   positions, 256 of them patch embeddings; training at 1 layer, one
   sequence of 32 with 16 patch embeddings), each check with its seconds, with the share of tokens whose
   top-k expert sets agree between card and CPU and the smallest gate
   margin among those that do not; the card's serving steps are a
   captured ``DecodeGraph``; then ``examples/serve_decode_torch.py``'s
   loop at temperature 0.7 with the same Gumbel noise on the card and the
   CPU (ids equal);
   then the paths of phase 4d, with cuDNN's deterministic algorithms:
   the new-client probe (FedFusion-conv) from phase 4d's trained state,
   4 steps from the CPU probe's state at each of 3 epoch starts within 1%
   of their change (the free-running 3-epoch distance printed beside
   it), the ``deadline`` engine run (2 rounds, fig. 8's chaos) within 1%,
   the ``mask`` codec's indices at CNN_MNIST's leaves equal bit for bit,
   and ``lowrank``'s decode within 1e-5 of its scale; then ``ef_ratio`` on
   the top-k ladder and ``bytes_budget`` on the int8 ladder, 4 engine
   rounds from one state (the int8 run's offsets drawn on the CPU and
   handed to both), equal level schedules and losses within 1%; then the
   LM engine, smollm-135m at full width cut to 2 layers: FedFusion-conv,
   2 rounds in one graph replay against the CPU within 1%, and with a
   top-k uplink on the host EF store, 4 rounds of graph replays against
   the reference loop's eager rounds on the card, equal;
7. the kernel table, after a line naming the TPU kernels still to port
   (none).

The line before the last is the kernel table; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.  float32 products run in full float32: TF32 is switched off
for matmuls and for cuDNN convolutions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

WIDTHS = (1.0, 2.0, 4.0, 8.0, 16.0)
FIG4 = dict(clients_per_round=10, local_steps=4, local_batch=10, lr=0.08,
            mmd_lambda=0.1)
EVAL_EXAMPLES = 2048
TOPK_FRAC = 1 / 16          # benchmarks/fig7_compression.py
SKETCH_LR = 0.04            # phase 4d's sketch runs: half of fig. 4's lr
FC_LEAF = 3136 * 512        # CNN_MNIST's largest leaf (the first FC weight)
# phase 4d: fig. 6's settings (benchmarks/fig6_newclient.py, quick sizes)
FIG6 = dict(clients_per_round=4, local_steps=4, local_batch=32, lr=0.06,
            lr_decay=0.99)
FIG6_ROUNDS, FIG6_EPOCHS, FIG6_CHUNK = 15, 6, 5
FIG6_VARIANTS = (("fedavg", "multi"), ("fedfusion", "single"),
                 ("fedfusion", "multi"), ("fedfusion", "conv"))
# fig. 8's chaos (benchmarks/fig8_stragglers.py)
FIG8_CHAOS = dict(speed_sigma=1.2, jitter=0.15, dropout=0.05,
                  truncation=0.0, seed=17)
# phase 4d's participation runs: algorithm, mode, uplink, policy, knobs
PART_RUNS = [("fedfusion", "client_parallel", "topk", "deadline",
              dict(over_provision=1.5)),
             ("fedmmd", "client_sequential", "int8", "buffered_async",
              dict(buffer_k=5))]
# the client objectives of the "little extra computation" claim
STEP_COST_ALGOS = (("fedavg", "multi"), ("fedl2", "multi"),
                   ("fedprox", "multi"), ("fedmmd", "multi"),
                   ("fedfusion", "conv"), ("fedfusion", "multi"),
                   ("fedfusion", "single"))
# smollm-135m's token embedding (49,152 x 576): K5 past the 50 MB L2
TOPK_BIG = 49152 * 576
# names of the kernels in src/repro_torch/csrc, as the profiler shows them
OUR_KERNELS = ("gram_partial_kernel", "gram_finish_kernel",
               "mk_mmd2_fwd_kernel", "mk_mmd2_bwd_kernel",
               "fusion_conv_kernel", "quant_pack_i",
               "quant_amax_multi_kernel", "quant_pack_multi_kernel",
               "quant_unpack_multi_kernel",
               "topk_select_kernel", "ef_gather_kernel", "ef_scatter_kernel",
               "flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel", "flash_decode_kernel")
ENGINE_CHUNK = 8            # superstep_rounds of the engine runs
# rounds of each engine run (phases 4 and 6): five chunks, so the steady
# rate spans four replays and the fifth chunk refills the first of the
# engine's four pinned staging pools
ENGINE_ROUNDS = 5 * ENGINE_CHUNK
# the reference run beside each engine run (12 until the recurrent families
# and the remat runs were added: the script's time limit)
REF_ROUNDS = 8
# phase 4f's engine runs, and phase 6's FedFusion-conv engine-vs-reference
# runs: three chunks (40 rounds until phase 4j was added: the script's time
# limit), so the steady rate spans two replays
SHORT_ENGINE_ROUNDS = 3 * ENGINE_CHUNK
# the engine runs of phases 4 and 6: algorithm, mode, uplink, EF store
ENGINE_RUNS = [("fedavg", "client_parallel", "identity", "device"),
               ("fedfusion", "client_parallel", "topk", "device"),
               ("fedfusion", "client_parallel", "topk", "host"),
               ("fedmmd", "client_sequential", "int8", "device")]


def ptxas_summary(log):
    """Each kernel's registers and spills from ``nvcc -Xptxas=-v``'s log,
    after the (mangled) name of the kernel they belong to."""
    return [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln
            or "Compiling entry function" in ln]


_T0 = time.perf_counter()


def emit(phase, **fields):
    """One JSON line; ``at_s``: seconds since the script started, so the
    gaps between lines show where a phase spends its time."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - _T0, 2)}),
          flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def time_ms(torch, fn, *, launches=20, repeats=15, warmup=5, sets=1):
    """Median over ``repeats`` of CUDA-event time for ``launches``
    back-to-back calls, divided by ``launches``.  With ``sets > 1`` call
    ``i`` gets ``i % sets`` (input sets that together exceed the L2 cache,
    so each call reads device memory)."""
    for i in range(warmup):
        fn(i % sets) if sets > 1 else fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            fn(i % sets) if sets > 1 else fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def device_per_call(torch, fn, calls=48, sets=8, tries=3):
    """(device ops, device microseconds) a call of ``fn(i)`` under
    ``torch.profiler``, call i taking input set i % ``sets``.  The trace
    now and then loses most of a window's kernels, so the window is taken
    ``tries`` times and the one with the most device activities counts."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(sets):
        fn(i)
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i % sets)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(spans) > len(best):
            best = spans
    return len(best) / calls, sum(best) / calls


def spread(rates):
    """n, min, median and max of a list of rates (None when empty)."""
    if not rates:
        return None
    return dict(n=len(rates), min=min(rates),
                median=statistics.median(rates), max=max(rates))


def chunk_rates(chunk_times):
    """Rounds/s of each engine chunk after the first: its rounds over its
    period on the engine's CUDA events (its start to the next chunk's
    start, the last one's to the end of the run)."""
    ends = [c["start_ms"] for c in chunk_times[1:]] \
        + [chunk_times[-1]["end_ms"]]
    return [1e3 * (c["r1"] - c["r0"]) / (e - c["start_ms"])
            for c, e in zip(chunk_times[1:], ends[1:])]


def bound(n_bytes, n_flops):
    """The least ms the card could take (the larger of bytes over HBM's
    rate and float32 operations over their peak) and which one binds."""
    from repro_torch.roofline import PEAK_BYTES, PEAK_F32_FLOPS
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gram_sum_work(n, m, d, n_widths):
    """Bytes (x, y, sigma in; one scalar out) and float32 operations (dot
    products, norms, the d2 identity and clamp, and per width a scale, a
    divide, an exp and an add) of one Gram sum."""
    n_bytes = 4 * ((n + m) * d + 2)
    n_flops = 2 * n * m * d + 2 * (n + m) * d + n * m * (4 + 5 * n_widths)
    return n_bytes, n_flops


def mk_mmd2_work(n, m, d, n_widths, grad=False):
    """Bytes (x, y in; MMD^2 and sigma out, or sigma and g in and dx out)
    and float32 operations of one fused MK-MMD launch: the n^2 + nm + m^2
    dot products, per pair the d2 identity and clamp and per width a
    scale, a divide and an exp (and for the gradient a multiply), then
    for dx two products of n + m rows per element."""
    pairs = n * n + n * m + m * m
    if not grad:
        return (4 * ((n + m) * d + 2),
                2 * d * pairs + pairs * (4 + 5 * n_widths) + 3 * n * m)
    return (4 * ((n + m) * d + 2 + n * d),
            2 * d * pairs + pairs * (4 + 7 * n_widths)
            + n * d * (2 * (n + m) + 5))


def mmd_term_ms(torch, term, x, y):
    """Wall ms of one MMD term forward and its dx (y detached, as FedMMD's
    global features are) through ``term``, as CUDA-event medians."""
    xr = x.clone().requires_grad_(True)

    def call():
        torch.autograd.grad(term(xr, y, WIDTHS), xr)
    return time_ms(torch, call)


def fusion_conv_work(T, C):
    """Bytes (f_g, f_l, W in; out) and flops (2 T 2C C) of one fusion conv."""
    return 4 * (3 * T * C + 2 * C * C), 4 * T * C * C


def check_kernels(torch, mk_mmd, fusion_conv):
    """Phase 3.  Returns the kernel-table rows (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(*shape, generator=gen) + shift).to(dev)

    rows = {}
    # -- K1: Gram sum ---------------------------------------------------
    k1_err = 0.0
    for n, m, d in [(10, 10, 64), (32, 32, 64), (37, 53, 64)]:
        x, y = randn(n, d), randn(m, d, scale=0.5, shift=1.0)
        sigma = torch.tensor(30.0, device=dev)
        got = mk_mmd.gram_sum_cuda(x, y, sigma, WIDTHS)
        want = mk_mmd.gram_sum_plain(x, y, sigma, WIDTHS)
        again = mk_mmd.gram_sum_cuda(x, y, sigma, WIDTHS)
        torch.cuda.synchronize()
        err = abs(got.item() - want.item())
        # float32 sums of n*m positive terms: a few ulp of the total
        tol = 1e-5 * abs(want.item())
        emit("kernels", kernel="gram_sum", shape=[n, m, d], value=got.item(),
             plain=want.item(), abs_err=err, tol=tol,
             bitwise_repeat=bool(torch.equal(got, again)))
        if err > tol or not torch.equal(got, again):
            raise AssertionError(f"gram_sum kernel disagrees at {(n, m, d)}")
        if (n, m, d) == (10, 10, 64):
            k1_err = err
    # its autograd gradient against autograd through the plain version
    xs, ys = randn(10, 64), randn(10, 64, scale=0.5, shift=1.0)
    sigma = torch.tensor(30.0, device=dev)
    grads = []
    for fn in (mk_mmd.gram_sum, mk_mmd.gram_sum_plain):
        x = xs.clone().requires_grad_(True)
        y = ys.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x, y, sigma, WIDTHS), (x, y)))
    g_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    # the gradient is a difference of two float32 sums that cancel in
    # part: rtol 1e-4, atol 1e-6 of the gradient's scale
    g_ok = all(torch.allclose(a, b, rtol=1e-4,
                              atol=1e-6 * b.abs().max().item())
               for a, b in zip(*grads))
    emit("kernels", kernel="gram_sum_grad", shape=[10, 10, 64],
         abs_err=g_err, rtol=1e-4, ok=g_ok)
    if not g_ok:
        raise AssertionError("gram_sum gradient disagrees with autograd")

    x, y = randn(10, 64), randn(10, 64, scale=0.5, shift=1.0)
    ms = time_ms(torch, lambda: mk_mmd.gram_sum_cuda(x, y, sigma, WIDTHS))
    plain_ms = time_ms(torch, lambda: mk_mmd.gram_sum_plain(x, y, sigma,
                                                            WIDTHS))
    bound_ms, bound_by = bound(*gram_sum_work(10, 10, 64, len(WIDTHS)))
    rows["gram_sum"] = dict(
        name="gram_sum", route="cuda",
        source="src/repro_torch/csrc/gram_sum.cu",
        replaces="src/repro/kernels/mk_mmd.py:74", max_abs_err=k1_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)
    emit("kernels", kernel="gram_sum", shape=[10, 10, 64], kernel_ms=ms,
         plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
         bound_by=bound_by)

    # -- K1 fused: the whole MK-MMD term, one launch each way ------------
    # at the CNN's pooled features (10 x 10 x 64) and the LM's (8 x 8 x
    # 576), and at a ragged and a one-row shape; value and sigma within
    # rtol 1e-5 (atol 1e-6: the term is O(0.1), a difference of three
    # sums), dx and dy as the Gram sum's gradient; bitwise repeatable
    g = torch.tensor([0.37], device=dev)
    err = {"mk_mmd2": 0.0, "mk_mmd2_grad": 0.0}
    for n, m, d in [(10, 10, 64), (8, 8, 576), (37, 53, 64), (1, 1, 64)]:
        x, y = randn(n, d), randn(m, d, scale=0.5, shift=1.0)
        out = mk_mmd.mk_mmd2_cuda(x, y, WIDTHS)
        dx, dy = mk_mmd.mk_mmd2_grad_cuda(x, y, out[1:], g, WIDTHS)
        again = mk_mmd.mk_mmd2_cuda(x, y, WIDTHS)
        dx2, dy2 = mk_mmd.mk_mmd2_grad_cuda(x, y, again[1:], g, WIDTHS)
        value, sigma = mk_mmd.mk_mmd2_plain(x, y, WIDTHS)
        want = mk_mmd.mk_mmd2_grad_plain(x, y, out[1], g, WIDTHS)
        torch.cuda.synchronize()
        v_err = max(abs(out[0].item() - value.item()),
                    abs(out[1].item() - sigma.item()))
        v_ok = (abs(out[0].item() - value.item())
                <= 1e-5 * abs(value.item()) + 1e-6
                and abs(out[1].item() - sigma.item())
                <= 1e-5 * abs(sigma.item()))
        g_err = max((a - b).abs().max().item() for a, b in zip((dx, dy),
                                                                want))
        g_ok = all(torch.allclose(a, b, rtol=1e-4,
                                  atol=1e-6 * b.abs().max().item())
                   for a, b in zip((dx, dy), want))
        repeat = (torch.equal(out, again) and torch.equal(dx, dx2)
                  and torch.equal(dy, dy2))
        line = dict(kernel="mk_mmd2", shape=[n, m, d], value=out[0].item(),
                    plain=value.item(), sigma=out[1].item(),
                    abs_err=v_err, grad_abs_err=g_err, ok=v_ok and g_ok,
                    bitwise_repeat=repeat)
        if (n, m, d) in ((10, 10, 64), (8, 8, 576)):
            line.update(
                kernel_ms=time_ms(torch, lambda: mk_mmd.mk_mmd2_cuda(
                    x, y, WIDTHS)),
                grad_kernel_ms=time_ms(torch, lambda: mk_mmd.mk_mmd2_grad_cuda(
                    x, y, out[1:], g, WIDTHS, True, False)),
                plain_ms=time_ms(torch, lambda: mk_mmd.mk_mmd2_plain(
                    x, y, WIDTHS)),
                grad_plain_ms=time_ms(
                    torch, lambda: mk_mmd.mk_mmd2_grad_plain(
                        x, y, out[1], g, WIDTHS, True, False)),
                # the whole term forward + dx: the fused route against
                # three Gram sums with the closed-form backward
                term_ms=mmd_term_ms(torch, mk_mmd.mk_mmd2, x, y),
                term_gram_ms=mmd_term_ms(torch, mk_mmd.mk_mmd2_gram, x, y))
            line["bound_ms"], line["bound_by"] = bound(
                *mk_mmd2_work(n, m, d, len(WIDTHS)))
            line["grad_bound_ms"], line["grad_bound_by"] = bound(
                *mk_mmd2_work(n, m, d, len(WIDTHS), grad=True))
            if (n, m, d) == (10, 10, 64):
                for name, pre in (("mk_mmd2", ""), ("mk_mmd2_grad", "grad_")):
                    rows[name] = dict(
                        name=name, route="cuda",
                        source="src/repro_torch/csrc/gram_sum.cu",
                        replaces="src/repro/kernels/mk_mmd.py:74",
                        ms=line[pre + "kernel_ms"],
                        plain_ms=line[pre + "plain_ms"],
                        bound_ms=line[pre + "bound_ms"],
                        bound_by=line[pre + "bound_by"], library_ms=None)
        emit("kernels", **line)
        err["mk_mmd2"] = max(err["mk_mmd2"], v_err)
        err["mk_mmd2_grad"] = max(err["mk_mmd2_grad"], g_err)
        if not (v_ok and g_ok and repeat):
            raise AssertionError(f"the fused MK-MMD kernels disagree at "
                                 f"{(n, m, d)}: {line}")
    for name in err:
        rows[name]["max_abs_err"] = err[name]

    # -- K2: fusion conv --------------------------------------------------
    # the CNN's training and eval shapes, smollm-135m's LM fusion, ragged
    # ones, C % 4 != 0 (the kernel's scalar path), and phase 4c's
    # FedFusion-conv steps of whisper-large-v3 (a client's ENCDEC_BATCH x
    # 448 tokens at 1,280) and qwen2-vl-7b (2 x 1,024 at 3,584)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t_enc = ENCDEC_BATCH * ENCDEC_SEQ
    timed = ((490, 64), (100352, 64), (8192, 576), (t_enc, 1280),
             (2048, 3584))
    for T, C in [(490, 64), (100352, 64), (8192, 576), (1001, 64), (77, 40),
                 (33, 30), (t_enc, 1280), (2048, 3584)]:
        fg, fl = randn(T, C), randn(T, C)
        w = randn(2 * C, C, scale=1.0 / math.sqrt(2 * C))
        got = fusion_conv.fusion_conv_cuda(fg, fl, w)
        again = fusion_conv.fusion_conv_cuda(fg, fl, w)
        want = fusion_conv.fusion_conv_plain(fg, fl, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # K = 2C float32 products summed in another order than cuBLAS
        tol = 1e-5 * want.abs().max().item()
        plan = fusion_conv.conv_plan(T, C, n_sm)
        line = dict(kernel="fusion_conv", shape=[T, C], abs_err=err, tol=tol,
                    bitwise_repeat=bool(torch.equal(got, again)),
                    plan=dict(tokens=plan.tokens, channels=plan.channels,
                              k_split=plan.k_split,
                              blocks=plan.blocks(T, C)))
        if (T, C) in timed:
            lib = lambda: torch.mm(torch.cat((fg, fl), -1), w)  # noqa: E731
            line.update(
                kernel_ms=time_ms(torch, lambda: fusion_conv.fusion_conv_cuda(
                    fg, fl, w)),
                plain_ms=time_ms(torch, lambda: fusion_conv.fusion_conv_plain(
                    fg, fl, w)),
                library_ms=time_ms(torch, lib))
            line["bound_ms"], line["bound_by"] = bound(*fusion_conv_work(T, C))
            if T == 490:
                rows["fusion_conv"] = dict(
                    name="fusion_conv", route="cuda",
                    source="src/repro_torch/csrc/fusion_conv.cu",
                    replaces="src/repro/kernels/fusion_conv.py:45",
                    max_abs_err=err, ms=line["kernel_ms"],
                    plain_ms=line["plain_ms"], bound_ms=line["bound_ms"],
                    bound_by=line["bound_by"],
                    library_ms=line["library_ms"])
        emit("kernels", **line)
        if err > tol or not line["bitwise_repeat"]:
            raise AssertionError(f"fusion_conv kernel disagrees at {(T, C)}")
    return rows


def codec_work(kernel, n, bits=8):
    """Bytes each input read once, each output written once, of one K3
    (x, u in; codes out), K4 (codes in; f32 out) or K5 (x in, x out) call
    on n elements, plus the [1] scale or threshold; and its float32
    operations (K3: divide, add, floor, two-sided clamp; a leaf's whole
    encode also an abs and a max; K4: convert, multiply; K5: abs, compare,
    select)."""
    code_b = n if bits == 8 else n // 2
    return {"quant_pack": (8 * n + code_b + 4, 5 * n),
            "quant_encode": (8 * n + code_b + 4, 7 * n),
            "quant_unpack": (code_b + 4 * n + 4, 2 * n),
            "topk_select": (8 * n + 4, 3 * n)}[kernel]


def hardshrink_lambd(torch, t):
    """The float32 just below the threshold t (t > 0, [1] on the card), as
    a Python float: ``hardshrink(x, that)`` is K5's ``|x| >= t ? x : 0``."""
    return torch.nextafter(t, torch.zeros_like(t)).item()


def topk_device_us(torch, kern, lib, sets, bound_ms):
    """Device ops and microseconds a call of K5 (``kern(i)``) and of its
    yardstick ``hardshrink`` (``lib(i)``), input set i % ``sets``, and the
    bound's share of K5's device time."""
    out = {}
    for key, fn in (("", kern), ("library_", lib)):
        ops_, us = device_per_call(torch, fn, sets=sets)
        out[key + "device_ops_per_call"] = ops_
        out[key + "device_us_per_call"] = us
    out["bound_share_of_device"] = bound_ms * 1e3 / out["device_us_per_call"]
    return out


def check_codec_kernels(torch, compress_pack, QuantCodec, leaf_sizes):
    """Phase 3 for K3 / K4 / K5: each against its plain version on the
    card with ``torch.equal`` (the same IEEE float32 operations), at the
    FC leaf's size and ragged ones, with inputs that hit the clamp and
    entries exactly at the top-k threshold; K4 also over whole messages
    (``leaf_sizes``: CNN_MNIST's leaves), as the codecs decode them.
    Returns the table rows (K4's: one CNN_MNIST int8 message)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = {}
    err = dict.fromkeys(("quant_pack", "quant_unpack", "topk_select"), 0.0)

    def inputs(n, bits, clamp=False):
        x = torch.randn(n, generator=gen).to(dev)
        u = torch.rand(n, generator=gen).to(dev)
        scale = x.abs().max() / (127 if bits == 8 else 7)
        return x, u, (scale * (0.5 if clamp else 1.0)).reshape(1)

    for bits, n, clamp in [(8, FC_LEAF, False), (8, FC_LEAF, True),
                           (8, 10, False), (8, 1001, True),
                           (4, FC_LEAF, False), (4, FC_LEAF, True),
                           (4, 10, False), (4, 1002, True)]:
        x, u, scale = inputs(n, bits, clamp)
        q = compress_pack.quant_pack_cuda(x, scale, u, bits=bits)
        q_plain = compress_pack.quant_pack_plain(x, scale, u, bits=bits)
        y = compress_pack.quant_unpack_cuda(q, scale, bits=bits, n=n)
        y_plain = compress_pack.quant_unpack_plain(q, scale, bits=bits, n=n)
        torch.cuda.synchronize()
        ok = torch.equal(q, q_plain) and torch.equal(y, y_plain)
        code_err = (q.int() - q_plain.int()).abs().max().item()
        y_err = (y - y_plain).abs().max().item()
        err["quant_pack"] = max(err["quant_pack"], code_err)
        err["quant_unpack"] = max(err["quant_unpack"], y_err)
        emit("kernels", kernel="quant_pack+quant_unpack", bits=bits, n=n,
             clamped=clamp, equal=ok,
             differing_codes=int((q != q_plain).sum()),
             max_code_err=code_err, max_abs_err=y_err)
        if not ok:
            raise AssertionError(f"quant kernels disagree at bits={bits} "
                                 f"n={n} clamp={clamp}")
    # an odd leaf through the codec: int4 pads it to even
    for bits in (8, 4):
        leaf = torch.randn(4097, generator=gen)
        noise = [torch.rand(4097 + (bits == 4), generator=gen)]
        got = {}
        for d in ("cuda", "cpu"):
            codec = QuantCodec(bits).bind({"v": leaf.to(d)})
            payload, _ = codec.encode({"v": leaf.to(d)}, None,
                                      [noise[0].to(d)])
            got[d] = (payload[0]["q"].cpu(), codec.decode(payload)["v"].cpu())
        ok = all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
        emit("kernels", kernel="QuantCodec", bits=bits, n=4097, equal=ok)
        if not ok:
            raise AssertionError(f"QuantCodec bits={bits} card != CPU")

    # K3 over whole messages, scales included, against the plain version:
    # CNN_MNIST's eight leaves, odd and unaligned leaves (views 4 bytes off
    # the 16-byte boundary), a leaf of zeros, and 70 leaves (two pairs of
    # launches); with offsets and without
    for bits in (8, 4):
        for case, sizes in [("cnn_mnist", list(leaf_sizes)),
                            ("odd_unaligned", [4097, 33, 1000, 1]),
                            ("70_leaves", [37 * i + 1 for i in range(70)])]:
            for with_noise in (True, False):
                xs = [torch.randn(n + 1, generator=gen).to(dev)[1:]
                      if case == "odd_unaligned" else
                      torch.randn(n, generator=gen).to(dev) for n in sizes]
                if case == "odd_unaligned":
                    xs[-1] = torch.zeros(1, device=dev)
                us = [torch.rand(n + (n % 2 if bits == 4 else 0),
                                 generator=gen).to(dev) for n in sizes] \
                    if with_noise else None
                before = compress_pack.quant_pack_cuda.launches
                got = compress_pack.quant_pack_multi_cuda(xs, us, bits=bits)
                launched = compress_pack.quant_pack_cuda.launches - before
                want = compress_pack.quant_pack_multi_plain(xs, us, bits=bits)
                torch.cuda.synchronize()
                equal = all(torch.equal(q, wq) and torch.equal(sc, ws)
                            for (q, sc), (wq, ws) in zip(got, want))
                code_err = max((q.int() - wq.int()).abs().max().item()
                               for (q, _), (wq, _) in zip(got, want))
                err["quant_pack"] = max(err["quant_pack"], code_err)
                ok = equal and launched == 2 * -(-len(sizes) // 64)
                emit("kernels", kernel="quant_pack_multi", case=case,
                     bits=bits, offsets=with_noise, leaves=len(sizes),
                     elements=sum(sizes), launches=launched, equal=equal,
                     max_code_err=code_err)
                if not ok:
                    raise AssertionError(
                        f"quant_pack_multi {case} bits={bits}: equal="
                        f"{equal}, {launched} launches")

    def message(sizes, bits):
        """Codes and a scale a leaf (int4: ceil(n / 2) bytes)."""
        packed, scales = [], []
        for n in sizes:
            x, u, scale = inputs(n + (n % 2 if bits == 4 else 0), bits)
            packed.append(compress_pack.quant_pack_cuda(x, scale, u,
                                                        bits=bits))
            scales.append(scale)
        return packed, scales

    # K4 over whole messages: CNN_MNIST's eight leaves, an odd int4 leaf
    # and views off the 4-byte boundary, and 70 leaves (two launches)
    for bits in (8, 4):
        for case, sizes in [("cnn_mnist", list(leaf_sizes)),
                            ("odd_unaligned", [4097, 33, 1000]),
                            ("70_leaves", [37 * i + 1 for i in range(70)])]:
            packed, scales = message(sizes, bits)
            if case == "odd_unaligned":
                packed = [q[1:] for q in packed]
                sizes = [q.numel() if bits == 8 else 2 * q.numel() - 1
                         for q in packed]
            before = compress_pack.quant_unpack_cuda.launches
            got = compress_pack.quant_unpack_multi_cuda(packed, scales,
                                                        bits=bits, ns=sizes)
            launched = compress_pack.quant_unpack_cuda.launches - before
            want = compress_pack.quant_unpack_multi_plain(packed, scales,
                                                          bits=bits, ns=sizes)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            y_err = max((a - b).abs().max().item() for a, b in zip(got, want))
            err["quant_unpack"] = max(err["quant_unpack"], y_err)
            ok = equal and launched == -(-len(sizes) // 64)
            emit("kernels", kernel="quant_unpack_multi", case=case,
                 bits=bits, leaves=len(sizes), elements=sum(sizes),
                 launches=launched, equal=equal, max_abs_err=y_err)
            if not ok:
                raise AssertionError(f"quant_unpack_multi {case} bits={bits}"
                                     f": equal={equal}, {launched} launches")
    # K5, and its one-call yardstick: hardshrink(x, nextafter(t, 0)) keeps
    # |x| >= t and zeroes the rest, ties at t included (hardshrink(x, t)
    # would drop them); it keeps NaNs where K5 zeroes them, so the inputs
    # hold none
    for n, k in [(FC_LEAF, FC_LEAF // 16), (10, 3), (1001, 40)]:
        x = torch.randn(n, generator=gen)
        t = x.abs().sort().values[-k]
        x[0], x[-1] = -t, t                 # exactly at t: kept
        x, t = x.to(dev), t.reshape(1).to(dev)
        got = compress_pack.topk_select_cuda(x, t)
        want = compress_pack.topk_select_plain(x, t)
        shrunk = F.hardshrink(x, hardshrink_lambd(torch, t))
        torch.cuda.synchronize()
        ok = torch.equal(got, want) and got[0].item() == -t.item()
        lib_equal = torch.equal(got, shrunk)
        err["topk_select"] = max(err["topk_select"],
                                 (got - want).abs().max().item())
        emit("kernels", kernel="topk_select", n=n, k=k, equal=ok,
             hardshrink_equal=lib_equal,
             kept=int((got != 0).sum()), max_abs_err=err["topk_select"])
        if not (ok and lib_equal):
            raise AssertionError(f"topk_select kernel disagrees at n={n} "
                                 f"(plain {ok}, hardshrink {lib_equal})")
    # K5 on NaN, +-inf, -0.0, ties and t = 0, < 0, +inf, bit for bit (as
    # int32), at n on each side of its schedule's tile and wave, 16-byte
    # aligned and 4 bytes off (the scalar path)
    sched = compress_pack.topk_schedule(1)
    tile = 4 * sched["threads"] * sched["unroll"]
    wave = tile * sched["wave"]
    sizes = [1, tile - 1, tile + 1, wave - 4, wave + 3, 2 * wave + 1]
    edge_ok = True
    for n in sizes:
        for case in ("tie", "zero", "negative", "inf"):
            x = torch.randn(n + 1, generator=gen)
            t = {"tie": x.abs().median(), "zero": torch.tensor(0.0),
                 "negative": torch.tensor(-0.5),
                 "inf": torch.tensor(math.inf)}[case]
            special = torch.tensor([math.nan, math.inf, -math.inf, -0.0,
                                    t.item(), -t.item(), 0.0])
            m = min(n + 1, special.numel())
            x[torch.randperm(n + 1, generator=gen)[:m]] = special[:m]
            x, t = x.to(dev), t.reshape(1).to(dev)
            for view in (x[:n], x[1:]):
                got = compress_pack.topk_select_cuda(view, t)
                want = compress_pack.topk_select_plain(view, t)
                edge_ok &= torch.equal(got.view(torch.int32),
                                       want.view(torch.int32))
    torch.cuda.synchronize()
    emit("kernels", kernel="topk_select", case="edges", sizes=sizes,
         schedule=sched, equal=edge_ok)
    if not edge_ok:
        raise AssertionError("topk_select kernel disagrees on the edge set")

    # times at the FC leaf, over 8 input sets (> 50 MB L2 together)
    n, sets = FC_LEAF, 8
    xs = [inputs(n, 8) for _ in range(sets)]
    qs = {b: [compress_pack.quant_pack_cuda(x, s, u, bits=b)
              for x, u, s in xs] for b in (8, 4)}
    ts = [x.abs().kthvalue(n - n // 16 + 1).values.reshape(1)
          for x, _, _ in xs]
    lambds = [hardshrink_lambd(torch, t) for t in ts]
    cases = {
        "quant_pack": (
            lambda i: compress_pack.quant_pack_cuda(xs[i][0], xs[i][2],
                                                    xs[i][1]),
            lambda i: compress_pack.quant_pack_plain(xs[i][0], xs[i][2],
                                                     xs[i][1]),
            None, "src/repro/kernels/compress_pack.py:95"),
        "quant_unpack": (
            lambda i: compress_pack.quant_unpack_cuda(qs[8][i], xs[i][2]),
            lambda i: compress_pack.quant_unpack_plain(qs[8][i], xs[i][2]),
            lambda i: torch.mul(qs[8][i], xs[i][2]),
            "src/repro/kernels/compress_pack.py:140"),
        "topk_select": (
            lambda i: compress_pack.topk_select_cuda(xs[i][0], ts[i]),
            lambda i: compress_pack.topk_select_plain(xs[i][0], ts[i]),
            lambda i: F.hardshrink(xs[i][0], lambds[i]),
            "src/repro/kernels/compress_pack.py:252"),
    }
    leaf, leaf_pack = {}, {}
    for name, (kern, plain, lib, replaces) in cases.items():
        ms = time_ms(torch, kern, sets=sets)
        plain_ms = time_ms(torch, plain, sets=sets)
        library_ms = None if lib is None else time_ms(torch, lib, sets=sets)
        bound_ms, bound_by = bound(*codec_work(name, n))
        if name == "quant_unpack":   # K4's row is the message's, below
            leaf = dict(leaf_kernel_ms=ms, leaf_mul_ms=library_ms)
        elif name == "quant_pack":   # K3's row is the message's, below
            leaf_pack = dict(leaf_kernel_ms=ms, leaf_plain_ms=plain_ms)
        else:
            rows[name] = dict(name=name, route="cuda",
                              source="src/repro_torch/csrc/compress_pack.cu",
                              replaces=replaces, max_abs_err=err[name],
                              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
        extra = {}
        if name == "topk_select":    # device time a call, K5 and hardshrink
            extra = topk_device_us(torch, kern, lib, sets, bound_ms)
            extra["schedule"] = compress_pack.topk_schedule(n)
        emit("kernels", kernel=name, bits=8, n=n, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by=bound_by, **extra)
    # K5 past the L2: smollm-135m's token embedding, 2 sets (226 MB)
    big = [torch.randn(TOPK_BIG, generator=gen).to(dev) for _ in range(2)]
    big_t = [x.abs().kthvalue(TOPK_BIG - TOPK_BIG // 16 + 1).values
             .reshape(1) for x in big]
    big_l = [hardshrink_lambd(torch, t) for t in big_t]

    def big_kern(i):
        return compress_pack.topk_select_cuda(big[i], big_t[i])

    def big_lib(i):
        return F.hardshrink(big[i], big_l[i])

    got = big_kern(0)
    equal = torch.equal(got, compress_pack.topk_select_plain(big[0],
                                                             big_t[0]))
    lib_equal = torch.equal(got, big_lib(0))
    del got
    if not (equal and lib_equal):
        raise AssertionError(f"topk_select disagrees at n={TOPK_BIG} "
                             f"(plain {equal}, hardshrink {lib_equal})")
    bound_ms, bound_by = bound(*codec_work("topk_select", TOPK_BIG))
    emit("kernels", kernel="topk_select", n=TOPK_BIG, sets=2, equal=equal,
         hardshrink_equal=lib_equal,
         kernel_ms=time_ms(torch, big_kern, sets=2),
         library_ms=time_ms(torch, big_lib, sets=2), bound_ms=bound_ms,
         bound_by=bound_by, schedule=compress_pack.topk_schedule(TOPK_BIG),
         **topk_device_us(torch, big_kern, big_lib, 2, bound_ms))
    del big
    # K4 as the codecs call it: one CNN_MNIST int8 message a call (8 sets,
    # > 50 MB together), against eight single-leaf wrapper calls, eight
    # ``torch.mul``s and one ``torch._foreach_mul`` over the leaves (the
    # row's one-call yardstick)
    msgs = [message(leaf_sizes, 8) for _ in range(sets)]
    msg_calls = {
        "foreach_mul_ms": lambda i: torch._foreach_mul(*msgs[i]),
        "kernel_ms": lambda i: compress_pack.quant_unpack_multi_cuda(
            *msgs[i], ns=leaf_sizes),
        "per_leaf_calls_ms": lambda i: [
            compress_pack.quant_unpack_cuda(q, sc, n=m)
            for q, sc, m in zip(*msgs[i], leaf_sizes)],
        "mul_x8_ms": lambda i: [torch.mul(q, sc) for q, sc in zip(*msgs[i])],
        "plain_ms": lambda i: compress_pack.quant_unpack_multi_plain(
            *msgs[i], ns=leaf_sizes),
    }
    msg_ms = {k: time_ms(torch, f, sets=sets) for k, f in msg_calls.items()}
    work = [codec_work("quant_unpack", m) for m in leaf_sizes]
    bound_ms, bound_by = bound(sum(w[0] for w in work),
                               sum(w[1] for w in work))
    rows["quant_unpack"] = dict(
        name="quant_unpack", route="cuda",
        source="src/repro_torch/csrc/compress_pack.cu",
        replaces="src/repro/kernels/compress_pack.py:140",
        max_abs_err=err["quant_unpack"], ms=msg_ms["kernel_ms"],
        plain_ms=msg_ms["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=msg_ms["foreach_mul_ms"])
    emit("kernels", kernel="quant_unpack_multi", case="cnn_mnist", bits=8,
         leaves=len(leaf_sizes), elements=sum(leaf_sizes), **msg_ms,
         library_ms=msg_ms["foreach_mul_ms"], **leaf, bound_ms=bound_ms,
         bound_by=bound_by)
    # K3 as the codecs call it: one CNN_MNIST message a call, scales
    # included (8 sets, > 50 MB together), against the per-leaf route
    # (eager scales, one single-leaf K3 call a leaf) and the plain version
    enc = [([torch.randn(m, generator=gen).to(dev) for m in leaf_sizes],
            [torch.rand(m, generator=gen).to(dev) for m in leaf_sizes])
           for _ in range(sets)]

    def per_leaf(i):
        for x, u in zip(*enc[i]):
            scale = (x.abs().amax().clamp_min(1e-12) / 127).reshape(1)
            compress_pack.quant_pack_cuda(x, scale, u)

    for bits in (8, 4):
        def call(i, bits=bits):
            return compress_pack.quant_pack_multi_cuda(*enc[i], bits=bits)
        enc_ms = {"kernel_ms": time_ms(torch, call, sets=sets),
                  "plain_ms": time_ms(torch, lambda i: compress_pack
                                      .quant_pack_multi_plain(
                                          *enc[i], bits=bits), sets=sets)}
        if bits == 8:
            enc_ms["per_leaf_calls_ms"] = time_ms(torch, per_leaf, sets=sets)
        ops_per_call, us = device_per_call(torch, call)
        work = [codec_work("quant_encode", m + (m % 2) * (bits == 4), bits)
                for m in leaf_sizes]
        bound_ms, bound_by = bound(sum(w[0] for w in work),
                                   sum(w[1] for w in work))
        emit("kernels", kernel="quant_pack_multi", case="cnn_mnist",
             bits=bits, leaves=len(leaf_sizes), elements=sum(leaf_sizes),
             **enc_ms, **(leaf_pack if bits == 8 else {}),
             device_ops_per_message=ops_per_call, device_us_per_message=us,
             bound_ms=bound_ms, bound_by=bound_by,
             bound_share_of_device=bound_ms * 1e3 / us)
        if bits == 8:
            rows["quant_pack"] = dict(
                name="quant_pack", route="cuda",
                source="src/repro_torch/csrc/compress_pack.cu",
                replaces="src/repro/kernels/compress_pack.py:95",
                max_abs_err=err["quant_pack"], ms=enc_ms["kernel_ms"],
                plain_ms=enc_ms["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
    # K3 at a level of the int8 ladder (4, 8), the level a device int32 the
    # kernel reads (the adaptive controllers' path): both levels of
    # CNN_MNIST's, odd / unaligned and 70-leaf messages against the plain
    # version in two launches per 64 leaves; one captured encode replayed
    # at levels 0, 1, 0 (the level written into its buffer between
    # replays); the message timed at level 0 beside the capacity encode,
    # in turns (capacity, level, level, capacity)
    qmax_ladder = (7.0, 127.0)
    for case, sizes in [("cnn_mnist", list(leaf_sizes)),
                        ("odd_unaligned", [4097, 33, 1000, 1]),
                        ("70_leaves", [37 * i + 1 for i in range(70)])]:
        for level in (0, 1):
            lxs = [torch.randn(n + 1, generator=gen).to(dev)[1:]
                  if case == "odd_unaligned" else
                  torch.randn(n, generator=gen).to(dev) for n in sizes]
            lus = [torch.rand(n, generator=gen).to(dev) for n in sizes]
            lv = torch.tensor(level, dtype=torch.int32, device=dev)
            before = compress_pack.quant_pack_cuda.launches
            got = compress_pack.quant_pack_multi_cuda(
                lxs, lus, level=lv, ladder_qmax=qmax_ladder)
            launched = compress_pack.quant_pack_cuda.launches - before
            want = compress_pack.quant_pack_multi_plain(
                lxs, lus, level=lv, ladder_qmax=qmax_ladder)
            torch.cuda.synchronize()
            equal = all(torch.equal(q, wq) and torch.equal(sc, ws)
                        for (q, sc), (wq, ws) in zip(got, want))
            max_code = max(q.abs().max().item() for q, _ in got)
            ok = (equal and launched == 2 * -(-len(sizes) // 64)
                  and (max_code <= 8 if level == 0 else True))
            emit("kernels", kernel="quant_pack_multi", case=case, bits=8,
                 ladder=[4, 8], level=level, leaves=len(sizes),
                 elements=sum(sizes), launches=launched, equal=equal,
                 max_code=max_code)
            if not ok:
                raise AssertionError(f"quant_pack_multi {case} level "
                                     f"{level}: equal={equal}, {launched} "
                                     f"launches, max code {max_code}")
    lxs = [torch.zeros(m, device=dev) for m in leaf_sizes]
    lus = [torch.zeros(m, device=dev) for m in leaf_sizes]
    lv = torch.zeros((), dtype=torch.int32, device=dev)
    compress_pack.quant_pack_multi_cuda(lxs, lus, level=lv,
                                        ladder_qmax=qmax_ladder)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = compress_pack.quant_pack_multi_cuda(lxs, lus, level=lv,
                                                  ladder_qmax=qmax_ladder)
    replay_ok, replay_codes = True, []
    for level in (0, 1, 0):
        for x, u in zip(lxs, lus):
            x.copy_(torch.randn(x.numel(), generator=gen))
            u.copy_(torch.rand(u.numel(), generator=gen))
        lv.fill_(level)
        graph.replay()
        want = compress_pack.quant_pack_multi_plain(lxs, lus, level=lv,
                                                    ladder_qmax=qmax_ladder)
        torch.cuda.synchronize()
        replay_ok &= all(torch.equal(q, wq) and torch.equal(sc, ws)
                         for (q, sc), (wq, ws) in zip(out, want))
        replay_codes.append(max(q.abs().max().item() for q, _ in out))
    del graph, out, lxs, lus
    replay_ok &= replay_codes[0] <= 8 < replay_codes[1] \
        and replay_codes[2] <= 8
    lv0 = torch.zeros((), dtype=torch.int32, device=dev)

    def at_level(i):
        return compress_pack.quant_pack_multi_cuda(
            *enc[i], level=lv0, ladder_qmax=qmax_ladder)

    def at_capacity(i):
        return compress_pack.quant_pack_multi_cuda(*enc[i])

    turns = [time_ms(torch, f, sets=sets)
             for f in (at_capacity, at_level, at_level, at_capacity)]
    ops_per_call, us_per_call = device_per_call(torch, at_level)
    cap_ops, cap_us = device_per_call(torch, at_capacity)
    work = [codec_work("quant_encode", m) for m in leaf_sizes]
    bound_ms, bound_by = bound(sum(w[0] for w in work),
                               sum(w[1] for w in work))
    emit("kernels", kernel="quant_pack_multi", case="cnn_mnist_level",
         bits=8, ladder=[4, 8], level=0, leaves=len(leaf_sizes),
         elements=sum(leaf_sizes), replays_equal=replay_ok,
         replay_max_codes=replay_codes,
         level_ms=[turns[1], turns[2]], capacity_ms=[turns[0], turns[3]],
         device_ops_per_message=ops_per_call,
         device_us_per_message=us_per_call,
         capacity_device_ops_per_message=cap_ops,
         capacity_device_us_per_message=cap_us,
         bound_ms=bound_ms, bound_by=bound_by)
    if not replay_ok:
        raise AssertionError(f"quant_pack_multi: a captured encode does not "
                             f"follow its level buffer ({replay_codes})")
    # int4 pack / unpack at the same size (no one-call yardstick)
    for name, kern, plain in [
            ("quant_pack", lambda i: compress_pack.quant_pack_cuda(
                xs[i][0], xs[i][2], xs[i][1], bits=4),
             lambda i: compress_pack.quant_pack_plain(
                 xs[i][0], xs[i][2], xs[i][1], bits=4)),
            ("quant_unpack", lambda i: compress_pack.quant_unpack_cuda(
                qs[4][i], xs[i][2], bits=4),
             lambda i: compress_pack.quant_unpack_plain(
                 qs[4][i], xs[i][2], bits=4))]:
        bound_ms, bound_by = bound(*codec_work(name, n, 4))
        emit("kernels", kernel=name, bits=4, n=n,
             kernel_ms=time_ms(torch, kern, sets=sets),
             plain_ms=time_ms(torch, plain, sets=sets), library_ms=None,
             bound_ms=bound_ms, bound_by=bound_by)
    return rows


def host_ns(torch, pieces, n_calls=2_000):
    """Host nanoseconds per call of each piece (``time.perf_counter_ns``
    around ``n_calls`` calls of the piece alone, best of three)."""
    split = {}
    for name, piece in pieces.items():
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(n_calls):
                piece()
            t1 = time.perf_counter_ns()
            torch.cuda.synchronize()
            best = (t1 - t0) / n_calls if best is None \
                else min(best, (t1 - t0) / n_calls)
        split[name] = best
    return split


def launch_path_split(torch, compress_pack):
    """Host nanoseconds per call of each piece of a K4 wrapper call: the
    checks, the allocation, the device and stream lookup, the one-leaf
    table, the ctypes launch itself, the whole wrapper call and
    ``torch.mul``.  Pieces that launch decode 1,024 codes, so the device
    keeps up with the host."""
    import array
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1024
    q = torch.zeros(n, dtype=torch.int8, device=dev)
    scale = torch.ones(1, device=dev)
    out = torch.empty(n, device=dev)
    fn = compress_pack._fn("quant_unpack_multi_f32")
    raw = torch._C._cuda_getCurrentRawStream
    stream = raw(dev.index)
    leaf = [q.data_ptr(), scale.data_ptr(), out.data_ptr(), n, 8, 1]
    table = array.array("q", leaf)
    with torch.cuda.device(dev):
        return host_ns(torch, {
            "checks": lambda: (
                compress_pack._cuda_device("k", q),
                compress_pack._check("k", "packed", q, dev, torch.int8),
                compress_pack._check("k", "scale", scale, dev, torch.float32,
                                     1),
                compress_pack._unpack_n(q, 8, None)),
            "torch.empty": lambda: torch.empty(n, device=dev,
                                               dtype=torch.float32),
            "current_device + raw stream": lambda: (
                torch.cuda.current_device() == dev.index and raw(dev.index)),
            "one-leaf table": lambda: array.array("q", leaf).buffer_info(),
            "ctypes launch": lambda: fn(table.buffer_info()[0], 1, stream),
            "quant_unpack_cuda (whole call)": lambda: compress_pack
            .quant_unpack_cuda(q, scale),
            "torch.mul (yardstick)": lambda: torch.mul(q, scale),
        })


def topk_launch_path_split(torch, compress_pack, n=5120):
    """Host nanoseconds per call of each piece of a K5 wrapper call on
    CNN_MNIST's ``fc2`` leaf (5,120 elements, so the device keeps up with
    the host): the combined test that guards the launch and the old
    checks it replaced (``_cuda_device`` and two ``_check``s), the
    allocation, the alignment test and the old ``_aligned``, the
    device and stream lookup of ``build.launch``, the ctypes launch
    itself, the whole call and ``hardshrink`` with a Python-float lambda,
    the yardstick."""
    import torch.nn.functional as F
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(n, device=dev)
    t = x.abs().median().reshape(1)
    lambd = hardshrink_lambd(torch, t)
    out = torch.empty_like(x)
    fn = compress_pack._fn("topk_select_f32")
    raw = torch._C._cuda_getCurrentRawStream
    stream = raw(dev.index)
    f32 = torch.float32
    with torch.cuda.device(dev):
        return host_ns(torch, {
            "combined test": lambda: compress_pack._topk_takes(x, t),
            "the old checks": lambda: (
                compress_pack._cuda_device("k", x),
                compress_pack._check("k", "x", x, dev, f32),
                compress_pack._check("k", "thresh", t, dev, f32, 1)),
            "torch.empty_like": lambda: torch.empty_like(x),
            "alignment test": lambda: not (x.data_ptr()
                                           | out.data_ptr()) & 15,
            "the old _aligned": lambda: compress_pack._aligned(
                (x, 16), (out, 16)),
            "x.device + current_device + raw stream": lambda: (
                torch.cuda.current_device() == x.device.index
                and raw(dev.index)),
            "ctypes launch": lambda: fn(x.data_ptr(), t.data_ptr(),
                                        out.data_ptr(), n, 1, stream),
            "topk_select_cuda (whole call)": lambda: compress_pack
            .topk_select_cuda(x, t),
            "F.hardshrink (yardstick)": lambda: F.hardshrink(x, lambd),
        })


def ef_work(k, n):
    """Bytes of one K6 or K7 call (k rows of n float32 read, k written, k
    int64 ids read) and its operations (none: it only moves data)."""
    return 8 * k * n + 8 * k, 0


def check_ef_kernels(torch, compress_pack):
    """Phase 3 for K6 / K7: each against its plain version on the card
    with ``torch.equal`` (both only move bytes), at the FC leaf's table
    [100, 1,605,632] with 10 ids, an odd trailing shape and a view 4 bytes
    off 16-byte alignment; K7 in place (same storage, the other rows and
    the bytes around the view bit-identical); duplicate ids that target
    a scratch row.  Returns the table rows."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    err = {"ef_gather": 0.0, "ef_scatter": 0.0}
    for shape, k, kind in [((100, FC_LEAF), 10, "aligned"),
                           ((37, 3, 7), 5, "odd trailing shape"),
                           ((9, 1024), 4, "unaligned view")]:
        n_el = math.prod(shape)
        base = torch.randn(n_el + 1, generator=gen).to(dev)
        table = (base[1:] if kind == "unaligned view" else base[:n_el]
                 ).view(shape)
        idx = torch.randperm(shape[0], generator=gen)[:k].to(dev)
        new = torch.randn((k,) + shape[1:], generator=gen).to(dev)
        got = compress_pack.ef_gather_cuda(table, idx)
        want = compress_pack.ef_gather_plain(table, idx)
        before = base.clone()
        want_table = compress_pack.ef_scatter_plain(table.clone(), idx, new)
        ptr = table.data_ptr()
        compress_pack.ef_scatter_cuda(table, idx, new)
        torch.cuda.synchronize()
        keep = torch.ones(shape[0], dtype=torch.bool, device=dev)
        keep[idx] = False
        old = (before[1:] if kind == "unaligned view" else before[:n_el]
               ).view(shape)
        outside = (before[0] == base[0]) if kind == "unaligned view" \
            else (before[n_el] == base[n_el])
        err["ef_gather"] = max(err["ef_gather"],
                               (got - want).abs().max().item())
        err["ef_scatter"] = max(err["ef_scatter"],
                                (table - want_table).abs().max().item())
        ok = dict(gather=torch.equal(got, want),
                  scatter=torch.equal(table, want_table),
                  in_place=table.data_ptr() == ptr,
                  untouched_rows=torch.equal(table[keep], old[keep]),
                  outside_view=bool(outside))
        emit("kernels", kernel="ef_gather+ef_scatter", shape=list(shape),
             k=k, case=kind, vector_path=bool(
                 ptr % 16 == 0 and math.prod(shape[1:]) % 4 == 0), **ok)
        if not all(ok.values()):
            raise AssertionError(f"ef kernels disagree at {shape}: {ok}")
    # duplicate ids may only target a scratch row past the table
    table = torch.randn(5, 40, generator=gen).to(dev)
    scratch = torch.cat([table, torch.zeros(1, 40, device=dev)])
    new = torch.randn(4, 40, generator=gen).to(dev)
    safe_idx = torch.tensor([3, 5, 1, 5], dtype=torch.int32, device=dev)
    out = compress_pack.ef_scatter_cuda(scratch, safe_idx, new)[:5]
    want = table.clone()
    want[torch.tensor([3, 1])] = new[torch.tensor([0, 2])]
    ok = torch.equal(out, want)
    err["ef_scatter"] = max(err["ef_scatter"], (out - want).abs().max().item())
    emit("kernels", kernel="ef_scatter", case="scratch-row duplicates",
         equal=ok, max_abs_err=err)
    if not ok:
        raise AssertionError("ef_scatter: owned rows wrong with scratch-row "
                             "duplicates")

    # times at the FC leaf's table, 8 id sets (different rows each call)
    k, sets = 10, 8
    table = torch.randn(100, FC_LEAF, generator=gen).to(dev)
    ids = [torch.randperm(100, generator=gen)[:k].to(dev)
           for _ in range(sets)]
    news = [torch.randn(k, FC_LEAF, generator=gen).to(dev)
            for _ in range(sets)]
    cases = {
        "ef_gather": (
            lambda i: compress_pack.ef_gather_cuda(table, ids[i]),
            lambda i: compress_pack.ef_gather_plain(table, ids[i]),
            lambda i: torch.index_select(table, 0, ids[i]),
            "src/repro/kernels/compress_pack.py:197"),
        "ef_scatter": (
            lambda i: compress_pack.ef_scatter_cuda(table, ids[i], news[i]),
            lambda i: compress_pack.ef_scatter_plain(table, ids[i], news[i]),
            lambda i: table.index_copy_(0, ids[i], news[i]),
            "src/repro/kernels/compress_pack.py:236"),
    }
    rows = {}
    for name, (kern, plain, lib, replaces) in cases.items():
        ms = time_ms(torch, kern, sets=sets)
        plain_ms = time_ms(torch, plain, sets=sets)
        library_ms = time_ms(torch, lib, sets=sets)
        bound_ms, bound_by = bound(*ef_work(k, FC_LEAF))
        rows[name] = dict(name=name, route="cuda",
                          source="src/repro_torch/csrc/ef_rows.cu",
                          replaces=replaces, max_abs_err=err[name], ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        emit("kernels", kernel=name, shape=[100, FC_LEAF], k=k,
             kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             gbytes_per_s=ef_work(k, FC_LEAF)[0] / ms / 1e6)
    return rows


def visible_pairs(S, window, causal=True):
    """(query, key) pairs an attention over S positions computes: causal
    with a sliding window or without, or bidirectional (all S * S)."""
    if not causal:
        return S * S
    if window is None:
        return S * (S + 1) // 2
    return sum(min(p + 1, window) for p in range(S))


def flash_fwd_work(B, S, H, KV, hd, window, causal=True):
    """Bytes (q, k, v in; o, lse out) and float32 operations (two products
    of hd per visible pair and head: q.k and p.v) of one K8a call."""
    n_bytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd + B * H * S)
    return n_bytes, 4 * B * H * hd * visible_pairs(S, window, causal)


def flash_decode_work(B, valid, H, KV, hd):
    """Bytes (q, the valid rows of both caches, valid_len in; o out) and
    operations (q.k and p.v per valid position and head) of one K9 call."""
    n_bytes = 4 * (2 * B * H * hd + 2 * B * valid * KV * hd + 1)
    return n_bytes, 4 * B * H * hd * valid


# K8a cases of phase 3 (the last field: the causal mask): gemma3-1b's
# global and local layers, smollm-135m's layers, a ragged length; B = 4 and
# S = 1,024 as the serve phase prefills; stablelm-3b's layers (hd 80),
# h2o-danube-3-4b's (hd 120) at its serve prompt of 4,608 (the 4,096 window
# binds) and a ragged hd 80; recurrentgemma-9b's local layers (16 query
# heads over one KV head of 256, window 2,048) at its serve prompt of 2,560
# (the window binds) and at phase 4c's training shape; whisper-large-v3's
# encoder (no causal mask, 1,500 frames = 23 x 64 + 28) and qwen2-vl-7b's
# prefill (28 query heads over 4 KV heads of 128), and whisper-large-v3's
# decoder at phase 4c's training shape (a client's ENCDEC_BATCH x 448)
FLASH_CASES = [("gemma3-1b global", 4, 1024, 4, 1, 256, None, True),
               ("gemma3-1b local", 4, 1024, 4, 1, 256, 512, True),
               ("smollm-135m", 4, 1024, 9, 3, 64, None, True),
               ("gemma3-1b local, ragged", 4, 1000, 4, 1, 256, 512, True),
               ("stablelm-3b", 4, 1024, 32, 32, 80, None, True),
               ("h2o-danube-3-4b", 1, 4608, 32, 8, 120, 4096, True),
               ("stablelm-3b, ragged", 4, 1000, 32, 32, 80, None, True),
               ("recurrentgemma-9b local", 1, 2560, 16, 1, 256, 2048, True),
               ("recurrentgemma-9b local, train", 2, 1024, 16, 1, 256,
                2048, True),
               ("whisper-large-v3 encoder", 4, 1500, 20, 20, 64, None,
                False),
               ("qwen2-vl-7b", 4, 1024, 28, 4, 128, None, True),
               ("whisper-large-v3 decoder, train", 4, 448, 20, 20, 64, None,
                True)]
# K9 cases: gemma3-1b's global cache (max_len 1,056) at several lengths,
# its full local ring, smollm-135m's cache, and recurrentgemma-9b's heads
# (16 query heads over one KV head of 256) on a cache of the same length;
# stablelm-3b's cache (hd 80), h2o-danube-3-4b's full ring (hd 120) and
# its heads on a cache of 1,056; recurrentgemma-9b's full ring of 2,048
# (phase 4b's prompt of 2,560 fills it); whisper-large-v3's cross cache of
# 1,500 frames with no valid length (None: every position) and
# qwen2-vl-7b's self cache (28 query heads over 4 KV heads of 128)
DECODE_CASES = [("gemma3-1b global", 4, 1056, 4, 1, 256, (1, 529, 1025,
                                                          1056)),
                ("gemma3-1b local", 4, 512, 4, 1, 256, (512,)),
                ("smollm-135m", 4, 1056, 9, 3, 64, (1025, 1056)),
                ("rep 16 (recurrentgemma-9b heads)", 4, 1056, 16, 1, 256,
                 (17, 1056)),
                ("stablelm-3b", 4, 1056, 32, 32, 80, (1, 1025, 1056)),
                ("h2o-danube-3-4b ring", 1, 4096, 32, 8, 120, (4096,)),
                ("h2o-danube-3-4b heads", 1, 1056, 32, 8, 120, (529, 1056)),
                ("recurrentgemma-9b ring", 1, 2048, 16, 1, 256, (2048,)),
                ("whisper-large-v3 cross", 4, 1500, 20, 20, 64, (None,)),
                ("qwen2-vl-7b", 4, 1056, 28, 4, 128, (1025, 1056))]
# float32 reorderings over at most 4,096 keys put the kernels' outputs a
# few 1e-7 from the plain versions' (|o| < 4, |lse| < 15): 1e-4 bounds
# them with room; a wrong mask, tile or missing column moves them by O(0.1)
ATTN_TOL = 1e-4


def check_attention_kernels(torch, flash_attn, decode_attn):
    """Phase 3 for K8a / K9: each against its plain version on the card at
    the serve shapes, with its time, the plain version's,
    ``scaled_dot_product_attention``'s on the same function, and its
    bound.  Returns the table rows."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def sdpa_mask(S, window):
        pos = torch.arange(S, device=dev)
        return ((pos[None, :] <= pos[:, None])
                & ((pos[:, None] - pos[None, :]) < window))

    rows, err = {}, {"flash_fwd": 0.0, "flash_decode": 0.0}
    for case, B, S, H, KV, hd, window, causal in FLASH_CASES:
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
        kw = dict(window=window, causal=causal)
        o, lse = flash_attn.flash_fwd_cuda(q, k, v, **kw)
        o2, lse2 = flash_attn.flash_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = flash_attn.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        o_err = (o - o_p).abs().max().item()
        lse_err = (lse - lse_p).abs().max().item()
        repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
        del o2, lse2
        err["flash_fwd"] = max(err["flash_fwd"], o_err, lse_err)
        plan = flash_attn.fwd_plan(B, S, H, KV, hd, causal, window,
                                   n_sm=torch.cuda.get_device_properties(
                                       0).multi_processor_count)
        line = dict(kernel="flash_fwd", case=case, shape=[B, S, H, KV, hd],
                    window=window, causal=causal, o_abs_err=o_err,
                    lse_abs_err=lse_err,
                    tol=ATTN_TOL, bitwise_repeat=repeat,
                    plan=dict(key_tile=plan.key_tile, slots=plan.slots,
                              makespan=plan.makespan, ideal=plan.ideal))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None if window is None else sdpa_mask(S, window)

        def call(i=0):
            return flash_attn.flash_fwd_cuda(q, k, v, **kw)
        line["device_ops_per_call"], line["device_us_per_call"] = \
            device_per_call(torch, call, calls=10, sets=1)
        line.update(
            kernel_ms=time_ms(torch, call, launches=10, repeats=9),
            plain_ms=time_ms(torch, lambda: flash_attn.flash_fwd_plain(
                q, k, v, **kw), launches=3, repeats=5),
            library_ms=time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True),
                launches=10, repeats=9))
        work = flash_fwd_work(B, S, H, KV, hd, window, causal)
        line["bound_ms"], line["bound_by"] = bound(*work)
        line["gflop_per_s"] = work[1] / line["kernel_ms"] / 1e6
        line["bound_share_of_device"] = \
            line["bound_ms"] * 1e3 / line["device_us_per_call"]
        if case == "gemma3-1b global":
            rows["flash_fwd"] = dict(
                name="flash_fwd", route="cuda",
                source="src/repro_torch/csrc/flash_attn.cu",
                replaces="src/repro/kernels/flash_attn.py:125",
                ms=line["kernel_ms"], plain_ms=line["plain_ms"],
                bound_ms=line["bound_ms"], bound_by=line["bound_by"],
                library_ms=line["library_ms"])
        del qt, kt, vt
        emit("kernels", **line)
        if not (o_err <= ATTN_TOL and lse_err <= ATTN_TOL and repeat):
            raise AssertionError(f"flash_fwd kernel disagrees: {case}")

    for case, B, L, H, KV, hd, valids in DECODE_CASES:
        sets = 8                    # 8 caches together exceed the L2 cache
        qs = [randn(B, 1, H, hd) for _ in range(sets)]
        ks = [randn(B, L, KV, hd) for _ in range(sets)]
        vs = [randn(B, L, KV, hd) for _ in range(sets)]
        for valid in valids:
            # None: every position (a cross cache), no valid length passed
            vl = None if valid is None else torch.tensor(
                [valid], dtype=torch.int32, device=dev)
            got = decode_attn.flash_decode_cuda(qs[0], ks[0], vs[0], vl)
            want = decode_attn.flash_decode_plain(qs[0], ks[0], vs[0], vl)
            again = decode_attn.flash_decode_cuda(qs[0], ks[0], vs[0], vl)
            # the valid length as decode_step holds it: int64, 0-d
            as64 = decode_attn.flash_decode_cuda(
                qs[0], ks[0], vs[0],
                None if valid is None else torch.tensor(valid, device=dev))
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err["flash_decode"] = max(err["flash_decode"], e)
            repeat = torch.equal(got, again) and torch.equal(got, as64)
            line = dict(kernel="flash_decode", case=case,
                        shape=[B, L, H, KV, hd], valid_len=valid,
                        abs_err=e, tol=ATTN_TOL, bitwise_repeat=repeat)
            if valid in (L, None):
                mask = None if vl is None else (
                    torch.arange(L, device=dev) < vl)[None, None, None]
                qt = [t.transpose(1, 2).contiguous() for t in qs]
                kt = [t.transpose(1, 2).contiguous() for t in ks]
                vt = [t.transpose(1, 2).contiguous() for t in vs]
                line.update(
                    kernel_ms=time_ms(torch, lambda i: decode_attn
                                      .flash_decode_cuda(qs[i], ks[i],
                                                         vs[i], vl),
                                      sets=sets),
                    plain_ms=time_ms(torch, lambda i: decode_attn
                                     .flash_decode_plain(qs[i], ks[i],
                                                         vs[i], vl),
                                     sets=sets),
                    library_ms=time_ms(
                        torch, lambda i: F.scaled_dot_product_attention(
                            qt[i], kt[i], vt[i], attn_mask=mask,
                            enable_gqa=True), sets=sets))
                line["bound_ms"], line["bound_by"] = bound(
                    *flash_decode_work(B, L, H, KV, hd))
                line["gbytes_per_s"] = flash_decode_work(
                    B, L, H, KV, hd)[0] / line["kernel_ms"] / 1e6
                line["device_ops_per_call"], line["device_us_per_call"] = \
                    device_per_call(torch, lambda i: decode_attn
                                    .flash_decode_cuda(qs[i], ks[i], vs[i],
                                                       vl), sets=sets)
                line["bound_share_of_device"] = \
                    line["bound_ms"] * 1e3 / line["device_us_per_call"]
                if case == "gemma3-1b global":
                    rows["flash_decode"] = dict(
                        name="flash_decode", route="cuda",
                        source="src/repro_torch/csrc/decode_attn.cu",
                        replaces="src/repro/kernels/decode_attn.py:80",
                        ms=line["kernel_ms"], plain_ms=line["plain_ms"],
                        bound_ms=line["bound_ms"],
                        bound_by=line["bound_by"],
                        library_ms=line["library_ms"])
            emit("kernels", **line)
            if not (e <= ATTN_TOL and repeat):
                raise AssertionError(f"flash_decode kernel disagrees: "
                                     f"{case}, valid_len {valid}")
    for name in rows:
        rows[name]["max_abs_err"] = err[name]
    return rows


# K9 with each row's log-sum-exp, at a tensor-parallel rank's slice of the
# cache (phase 4h's (1, 2) mesh halves L): gemma3-1b's global cache (1,056)
# and ring (512), stablelm-3b's cache (1,056, hd 80); valid lengths on each
# side of the slice, the whole slice, and 0 (a rank whose slice holds no
# valid position yet: o = 0 and lse = -1e30, so its merge weight is 0);
# and whisper-large-v3's cross cache as phase 4i's (1, 2) mesh splits it
# (1,500 frames as 750 + 750), with no valid length (None: every frame)
LSE_CASES = [("gemma3-1b global, half", 4, 528, 4, 1, 256, (0, 1, 300, 528)),
             ("gemma3-1b ring, half", 4, 256, 4, 1, 256, (0, 256)),
             ("stablelm-3b, half", 4, 528, 32, 32, 80, (0, 1, 528)),
             ("whisper-large-v3 cross cache, half", 4, 750, 20, 20, 64,
              (None,))]
# K2 on a rank's column block: smollm-135m's LM fusion (8,192 x 576) at
# m = 2 (N = 288) and stablelm-3b's (4 x 1,024 tokens, C = 2,560) at m = 2
FUSION_BLOCK_CASES = [("smollm-135m, m = 2", 8192, 576, 288),
                      ("stablelm-3b, m = 2", 4096, 2560, 1280)]


def check_tp_kernels(torch, decode_attn, fusion_conv):
    """Phase 3 for the tensor-parallel slice: K9's ``lse`` output against
    the plain version's at a rank's cache slices (valid length 0 too), o
    bit-equal to the call without ``lse``, and the two timed in turns
    (with, without, without, with), by wall and by device microseconds; the slices of gemma3-1b's global
    cache merged (``merge_partials``) against one K9 call over the whole;
    K2 on a column block W [2C, N] against the plain version, with its
    time, the plain version's and ``torch.mm(torch.cat(...))``'s."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for case, B, L, H, KV, hd, valids in LSE_CASES:
        sets = 8
        qs = [randn(B, 1, H, hd) for _ in range(sets)]
        ks = [randn(B, L, KV, hd) for _ in range(sets)]
        vs = [randn(B, L, KV, hd) for _ in range(sets)]
        for valid in valids:
            vl = None if valid is None else torch.tensor(valid, device=dev)
            o, lse = decode_attn.flash_decode_cuda(qs[0], ks[0], vs[0], vl,
                                                   want_lse=True)
            bare = decode_attn.flash_decode_cuda(qs[0], ks[0], vs[0], vl)
            po, plse = decode_attn.flash_decode_plain(qs[0], ks[0], vs[0],
                                                      vl, want_lse=True)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(o).all() and torch.isfinite(lse)
                          .all())
            if valid == 0:
                o_err = lse_err = 0.0
                ok = bool((lse == -1e30).all() and (o == 0).all()
                          and (plse < -1e29).all())
            else:
                o_err = (o - po).abs().max().item()
                lse_err = (lse - plse).abs().max().item()
                ok = o_err <= ATTN_TOL and lse_err <= ATTN_TOL
            line = dict(kernel="flash_decode", variant="lse", case=case,
                        shape=[B, L, H, KV, hd], valid_len=valid,
                        o_abs_err=o_err, lse_abs_err=lse_err, tol=ATTN_TOL,
                        finite=finite, o_equal_without_lse=torch.equal(
                            o, bare), empty_slice_weight_zero=(
                            bool((lse == -1e30).all()) if valid == 0
                            else None))
            if valid in (L, None):
                t = {}
                for which in ("lse", "bare", "bare", "lse"):
                    t.setdefault(which, []).append(time_ms(
                        torch, lambda i, w=which: decode_attn
                        .flash_decode_cuda(qs[i], ks[i], vs[i], vl,
                                           want_lse=w == "lse"), sets=sets))
                # the walls of these small calls are the host's (the lse
                # call allocates one more tensor): device time settles it
                us = {w: device_per_call(torch, lambda i, w=w: decode_attn
                                         .flash_decode_cuda(
                                             qs[i], ks[i], vs[i], vl,
                                             want_lse=w == "lse"),
                                         sets=sets)[1]
                      for w in ("lse", "bare")}
                line.update(ms_with_lse=t["lse"], ms_without_lse=t["bare"],
                            ratio=statistics.median(t["lse"])
                            / statistics.median(t["bare"]),
                            device_us_with_lse=us["lse"],
                            device_us_without_lse=us["bare"],
                            device_ratio=us["lse"] / us["bare"])
                line["bound_ms"], line["bound_by"] = bound(
                    *flash_decode_work(B, L, H, KV, hd))
            emit("kernels", **line)
            if not (ok and finite and line["o_equal_without_lse"]):
                raise AssertionError(f"flash_decode lse disagrees: {case}, "
                                     f"valid_len {valid}")
    # gemma3-1b's global cache in 2 and 4 slices, merged
    B, L, H, KV, hd = 4, 1056, 4, 1, 256
    q, k, v = randn(B, 1, H, hd), randn(B, L, KV, hd), randn(B, L, KV, hd)
    for valid in (1, 300, 1056):
        whole = decode_attn.flash_decode_cuda(q, k, v, valid)
        errs = {}
        for n in (2, 4):
            Ll = L // n
            parts = [decode_attn.flash_decode_cuda(
                q, k[:, r * Ll:(r + 1) * Ll].contiguous(),
                v[:, r * Ll:(r + 1) * Ll].contiguous(),
                torch.tensor(max(0, min(valid - r * Ll, Ll)), device=dev),
                want_lse=True) for r in range(n)]
            got = decode_attn.merge_partials(
                torch.stack([a for a, _ in parts]),
                torch.stack([b for _, b in parts]))
            errs[n] = (got - whole).abs().max().item()
        emit("kernels", kernel="flash_decode", variant="merged slices",
             shape=[B, L, H, KV, hd], valid_len=valid, abs_err=errs,
             tol=ATTN_TOL)
        if max(errs.values()) > ATTN_TOL:
            raise AssertionError(f"merged K9 slices disagree at {valid}")
    for case, T, C, N in FUSION_BLOCK_CASES:
        sets = 4
        fgs = [randn(T, C) for _ in range(sets)]
        fls = [randn(T, C) for _ in range(sets)]
        ws = [randn(2 * C, N) / math.sqrt(2 * C) for _ in range(sets)]
        got = fusion_conv.fusion_conv_cuda(fgs[0], fls[0], ws[0])
        want = fusion_conv.fusion_conv_plain(fgs[0], fls[0], ws[0])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        line = dict(kernel="fusion_conv", variant="column block", case=case,
                    T=T, C=C, N=N, abs_err=err, tol=1e-5 * scale,
                    plan=fusion_conv.conv_plan(
                        T, N, torch.cuda.get_device_properties(0)
                        .multi_processor_count).plan,
                    ms=time_ms(torch, lambda i: fusion_conv.fusion_conv_cuda(
                        fgs[i], fls[i], ws[i]), sets=sets),
                    plain_ms=time_ms(torch, lambda i: fusion_conv
                                     .fusion_conv_plain(fgs[i], fls[i],
                                                        ws[i]), sets=sets),
                    library_ms=time_ms(torch, lambda i: torch.mm(
                        torch.cat((fgs[i], fls[i]), 1), ws[i]), sets=sets))
        line["bound_ms"], line["bound_by"] = bound(
            4 * (2 * T * C + 2 * C * N + T * N), 4 * T * C * N)
        emit("kernels", **line)
        if err > 1e-5 * scale:
            raise AssertionError(f"fusion_conv column block disagrees: "
                                 f"{case}")


def flash_bwd_work(B, S, H, KV, hd, window, causal=True):
    """Bytes and float32 operations of one K8b call (q, do, k, v, lse, D
    in; dq out; three products of hd per visible pair and query head: s,
    dp and dq) and of one K8c call (the same inputs; dk, dv out; four
    products: s, dp, dv and dk), by kernel name."""
    pairs = B * H * visible_pairs(S, window, causal)
    q_el, kv_el, row_el = B * S * H * hd, B * S * KV * hd, B * H * S
    return {"flash_bwd_dq": (4 * (3 * q_el + 2 * kv_el + 2 * row_el),
                             6 * hd * pairs),
            "flash_bwd_dkv": (4 * (2 * q_el + 4 * kv_el + 2 * row_el),
                              8 * hd * pairs)}


# K8b / K8c cases of phase 3: phase 4c's training shapes (smollm-135m at
# batch 8, gemma3-1b's global and local layers, stablelm-3b's (hd 80) and
# h2o-danube-3-4b's (hd 120) layers at batch 4, S = 1,024), a ragged
# length at hd 128, gemma3-1b's local layer at a ragged length,
# h2o-danube-3-4b at 4,608 positions, where its 4,096 window binds, and
# recurrentgemma-9b's local layer (rep 16, hd 256, window 2,048) at phase
# 4c's training shape (a client's batch of 2 x 1,024); whisper-large-v3's
# encoder without the causal mask (B 4, 1,500 frames) and its causal
# decoder at phase 4c's client batch of 4 x 448, and qwen2-vl-7b's layers
# (rep 7, hd 128) at phase 4c's client batch of 2 x 1,024 (the last
# field: the causal mask)
FLASH_BWD_CASES = [("smollm-135m", 8, 1024, 9, 3, 64, None, True),
                   ("gemma3-1b global", 4, 1024, 4, 1, 256, None, True),
                   ("gemma3-1b local", 4, 1024, 4, 1, 256, 512, True),
                   ("ragged", 4, 1000, 8, 2, 128, None, True),
                   ("gemma3-1b local ragged", 4, 1000, 4, 1, 256, 512,
                    True),
                   ("stablelm-3b", 4, 1024, 32, 32, 80, None, True),
                   ("h2o-danube-3-4b", 4, 1024, 32, 8, 120, None, True),
                   ("h2o-danube-3-4b window", 1, 4608, 32, 8, 120, 4096,
                    True),
                   ("recurrentgemma-9b local", 2, 1024, 16, 1, 256, 2048,
                    True),
                   ("whisper-large-v3 encoder", 4, 1500, 20, 20, 64, None,
                    False),
                   ("whisper-large-v3 decoder", 4, 448, 20, 20, 64, None,
                    True),
                   ("qwen2-vl-7b", 2, 1024, 28, 4, 128, None, True)]
# dq sums over up to S keys and dk / dv over up to S * rep rows, in another
# order than the plain version's full products: a few 1e-7 of each
# gradient's largest element.  1e-4 of it bounds that with room (target
# 1e-5); a wrong mask, tile or row map moves the gradients by O(1e-2).
BWD_TOL = 1e-4


def check_flash_bwd_kernels(torch, flash_attn):
    """Phase 3 for K8b / K8c: each against the plain backward on the card
    (error relative to each gradient's largest element), run twice on the
    same inputs (bitwise equal), with its time, the plain backward's (all
    three gradients), ``scaled_dot_product_attention``'s backward alone in
    float32 over the same visible pairs (all three gradients), and its
    bound.  Returns the table rows."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    names = ("flash_bwd_dq", "flash_bwd_dkv")
    rows, err = {}, dict.fromkeys(names, 0.0)
    for case, B, S, H, KV, hd, window, causal in FLASH_BWD_CASES:
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
        do = randn(B, S, H, hd)
        kw = dict(window=window, causal=causal)
        o, lse = flash_attn.flash_fwd_cuda(q, k, v, **kw)
        dcap = flash_attn.flash_dcap(do, o, KV)

        def dq_call():
            return flash_attn.flash_bwd_dq_cuda(q, k, v, do, lse, dcap, **kw)

        def dkv_call():
            return flash_attn.flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, **kw)

        def plain_call():
            return flash_attn.flash_bwd_plain(q, k, v, o, lse, do, **kw)

        got = (dq_call(), *dkv_call())
        again = (dq_call(), *dkv_call())
        want = plain_call()
        torch.cuda.synchronize()
        scale = [b.abs().max().item() for b in want]
        abs_err = [(a - b).abs().max().item() for a, b in zip(got, want)]
        rel = [e / m for e, m in zip(abs_err, scale)]
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(t).all()) for t in got + want)
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], rel[0])
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], rel[1], rel[2])
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        plan = flash_attn.dkv_plan(B, S, H, KV, hd, causal, window,
                                   n_sm=n_sm)
        qplan = flash_attn.dq_plan(B, S, H, KV, hd, causal, window,
                                   n_sm=n_sm)
        line = dict(kernel="flash_bwd_dq+flash_bwd_dkv", case=case,
                    shape=[B, S, H, KV, hd], window=window, causal=causal,
                    dq_plan=dict(key_tile=qplan.key_tile, rows=qplan.rows,
                                 seg=qplan.seg, max_segments=qplan.max_ns,
                                 units=qplan.units(B, KV)),
                    dkv_plan=dict(key_tile=plan.key_tile, rows=plan.rows,
                                  seg=plan.seg,
                                  max_segments=plan.max_ns,
                                  units=B * KV * sum(
                                      -(-n // plan.seg)
                                      for n in plan.n_tiles)),
                    rel_err=dict(zip(("dq", "dk", "dv"), rel)),
                    abs_err=dict(zip(("dq", "dk", "dv"), abs_err)),
                    max_abs=dict(zip(("dq", "dk", "dv"), scale)),
                    tol=BWD_TOL, bitwise_repeat=repeat, finite=finite)
        del got, again, want
        if "ragged" not in case:
            work = flash_bwd_work(B, S, H, KV, hd, window, causal)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            mask = None
            if window is not None:
                pos = torch.arange(S, device=dev)
                mask = ((pos[None, :] <= pos[:, None])
                        & ((pos[:, None] - pos[None, :]) < window))
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            timing = dict(
                plain_ms=time_ms(torch, plain_call, launches=3, repeats=5),
                library_ms=time_ms(torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True), launches=5,
                    repeats=7))
            for name, call in zip(names, (dq_call, dkv_call)):
                ms = time_ms(torch, call, launches=10, repeats=9)
                ops_, us = device_per_call(torch, lambda i: call(), calls=10,
                                           sets=1)
                bound_ms, bound_by = bound(*work[name])
                timing[name] = dict(
                    kernel_ms=ms, device_ops_per_call=ops_,
                    device_us_per_call=us, bound_ms=bound_ms,
                    bound_by=bound_by, bound_share_of_device=bound_ms * 1e3
                    / us, gflop_per_s=work[name][1] / ms / 1e6)
                if case == "smollm-135m":
                    rows[name] = dict(
                        name=name, route="cuda",
                        source="src/repro_torch/csrc/flash_attn_bwd.cu",
                        replaces="src/repro/kernels/flash_attn.py:"
                        + ("302" if name == "flash_bwd_dq" else "322"),
                        ms=ms, plain_ms=timing["plain_ms"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=timing["library_ms"])
            line.update(timing)
            del out, qt, kt, vt
        emit("kernels", **line)
        if not (max(rel) <= BWD_TOL and repeat and finite):
            raise AssertionError(f"flash backward kernels disagree: {case}")
    for name in rows:
        rows[name]["max_abs_err"] = err[name]
    return rows


# phase 4c: model, algorithm, sequence length, global batch, rounds, and
# the depth it is cut to (None: full depth).  stablelm-3b (hd 80),
# h2o-danube-3-4b (hd 120) and granite-moe-1b (32 experts, top 8) train at
# full width cut to 4 layers; recurrentgemma-9b at full width cut to 3
# layers (one cycle: RG-LRU, RG-LRU, local attention at hd 256, rep 16,
# window 2,048) in its own client_sequential mode (4 clients visited in
# turn, 2 sequences each); smollm-135m 2 rounds (3 until the VLM and
# encoder-decoder runs were added: the script's time limit); qwen2-vl-7b
# FedFusion-conv at full width cut to
# 4 of its 28 layers (a full-depth client-sequential round holds ~3.3x its
# 30.5 GB of weights: past the card until the FSDP step), 4 clients in
# turn, 2 sequences each of 1,024 positions, the first 256 stub patch
# embeddings (``launch.train``'s draws)
TRAIN_RUNS = [("smollm-135m", "fedavg", 1024, 8, 2, None),
              ("smollm-135m", "fedmmd", 1024, 8, 2, None),
              ("smollm-135m", "fedfusion", 1024, 8, 2, None),
              ("gemma3-1b", "fedavg", 1024, 4, 2, None),
              ("stablelm-3b", "fedavg", 1024, 4, 2, 4),
              ("h2o-danube-3-4b", "fedavg", 1024, 4, 2, 4),
              ("granite-moe-1b-a400m", "fedavg", 1024, 4, 2, 4),
              ("recurrentgemma-9b", "fedavg", 1024, 8, 2, 3),
              ("qwen2-vl-7b", "fedfusion", 1024, 8, 2, 4)]
TRAIN_LR = 0.05             # launch.train's default


def lm_launches(cfg, algorithm, steps, evals=0, *, messages=0, n_leaves=0,
                ef_rounds=0):
    """Kernel launches of ``steps`` local steps and ``evals`` evaluations of
    an LM bundle: K8a once per attention layer per forward (the local
    stream, the frozen global stream of FedMMD and FedFusion, each eval)
    and, under ``cfg.remat == "layer"``, once more per attention layer of
    the checkpointed cycles (not the tail) per backward,
    K8b and K8c once per attention layer per backward, the fused MK-MMD
    term once forward and once backward a FedMMD step (8 pooled rows a
    side: no Gram-sum launch), K2 once a FedFusion-conv step and eval (its
    backward is plain products); with codecs, K3 twice and K4 once per
    quantized message of up to 64 leaves (``messages``), K6 and K7 once
    per EF leaf (``n_leaves``) per top-k round (``ef_rounds``)."""
    from repro_torch.models.transformer import cycle_split
    # the encoder's layers run K8a / K8b / K8c too (without the causal
    # mask), never checkpointed
    L = sum(k.startswith("attn") for k in cfg.block_pattern) \
        + cfg.n_enc_layers
    c, n_full, _ = cycle_split(cfg.block_pattern)
    recomputed = (cfg.remat == "layer") * sum(
        k.startswith("attn") for k in cfg.block_pattern[:c * n_full])
    two_stream = algorithm in ("fedmmd", "fedfusion")
    mmd = steps * (algorithm == "fedmmd")
    groups = -(-n_leaves // 64)
    return {"gram_sum": 0, "mk_mmd2": mmd, "mk_mmd2_grad": mmd,
            "fusion_conv": (steps + evals) * (algorithm == "fedfusion"),
            "quant_pack": 2 * groups * messages,
            "quant_unpack": groups * messages, "topk_select": 0,
            "ef_gather": n_leaves * ef_rounds,
            "ef_scatter": n_leaves * ef_rounds,
            "flash_fwd": L * (steps * (1 + two_stream) + evals)
            + recomputed * steps,
            "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps}


def train_runs(torch, train, counters, get_config, FLConfig, InputShape,
               fl_plan, tree_leaves):
    """Phase 4c's ``launch.train`` runs; returns their summed launches."""
    import dataclasses
    total = dict.fromkeys(counters, 0)
    for name, algorithm, S, B, rounds, layers in TRAIN_RUNS:
        cfg = dataclasses.replace(get_config(name), attn_impl="pallas")
        cuts = []
        if layers is not None:
            cuts.append(f"depth {cfg.n_layers} -> {layers} layers")
            cfg = dataclasses.replace(cfg, n_layers=layers,
                                      block_pattern=cfg.block_pattern[:layers])
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", local_steps=2,
                      lr=TRAIN_LR)
        shape = InputShape("custom_train", S, B, "train")
        plan = fl_plan(cfg, shape)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        for counter in counters.values():
            counter.launches = 0
        t0 = time.perf_counter()
        state, records = train.train_rounds(cfg, fl, shape, rounds=rounds,
                                            device="cuda", log=None)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = {k: c.launches for k, c in counters.items()}
        steps_per_round = plan.n_clients * plan.local_steps
        want = {k: v for k, v in lm_launches(
            cfg, algorithm, rounds * steps_per_round).items()
            if k in counters}
        steady = [r["ms"] for r in records[1:]]
        step_ms = [ms / steps_per_round for ms in steady]
        tokens = steps_per_round * plan.client_batch * S
        losses = [r["loss"] for r in records]
        checks = dict(launches=got == want,
                      finite=all(math.isfinite(x) for x in losses))
        aux = None
        if cfg.n_experts:    # the trained model's Switch aux on 4 x S
            from repro_torch.launch.serve import make_prompts
            from repro_torch.models import transformer as tfm
            with torch.no_grad():
                aux = tfm.forward_seq(cfg, state["model"], {
                    "tokens": make_prompts(cfg, 4, S, device="cuda")},
                    want_logits=False)["aux"].item()
            checks["aux_finite"] = math.isfinite(aux)
        emit("train", model=name, algorithm=algorithm, fusion_op="conv",
             attn_impl=cfg.attn_impl, stub_inputs=cfg.family in (
                 "vlm", "audio"),
             params=sum(t.numel() for t in tree_leaves(state["model"])),
             layers=cfg.n_layers, cuts=cuts, head_dim=cfg.head_dim,
             seq_len=S, global_batch=B, clients=plan.n_clients,
             local_steps=plan.local_steps,
             client_batch=plan.client_batch, rounds=rounds, wall_s=wall,
             round_ms=[r["ms"] for r in records],
             ms_per_local_step=dict(median=statistics.median(step_ms),
                                    min=min(step_ms), max=max(step_ms),
                                    rounds=f"2-{rounds}"),
             tokens_per_s=tokens / statistics.median(steady) * 1e3,
             allocated_at_start_bytes=start, peak_memory_bytes=peak,
             peak_above_start_bytes=peak - start, losses=losses, aux=aux,
             launches=got, expected=want, checks=checks)
        del state
        if not all(checks.values()):
            raise AssertionError(f"train {name}/{algorithm}: {checks}")
        for k in total:
            total[k] += got[k]
    return total


def settle(torch):
    """Frees what can be freed on the card and resets its peak; returns
    the bytes still allocated."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def kept_bytes(torch, cfg, params, batch):
    """Bytes a forward of ``cfg`` over ``batch`` keeps for its backward,
    logits included."""
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    start = settle(torch)
    out = tfm.forward_seq(cfg, p, batch)
    n = torch.cuda.memory_allocated() - start
    del out, p
    return n


# phase 4c: full-depth training with activation checkpointing.  FedAvg,
# one round of 1 client x 2 local steps (2 clients until the mesh
# families were added; a client's batch of B sequences)
# in client_sequential mode (the round holds the running sum, not a stack
# of client models), at stablelm-3b's 32 layers and h2o-danube-3-4b's 24.
# The memory split: the weights (the global model, resident); the round's
# client state, the peak above them of a round on 16 tokens (the running
# sum, the client's model, its gradient); the activations, what a forward
# over the batch keeps for the backward (logits included), measured apart
# before each round.  remat="none" at the first of REMAT_NONE's (B, S)
# that fits (an attempt of that search that runs out of memory is
# recorded as such; any other run that does fails the phase), "layer" at
# the same, with the same loss (JAX's rtol 1e-6) at a lower peak, then
# "layer" at twice that many tokens (S = 1,024), which "none" cannot hold:
# its measured activations per token put the round past the card (the
# line prints the count)
REMAT_MODELS = ("stablelm-3b", "h2o-danube-3-4b")
REMAT_NONE = ((4, 1024), (2, 1024), (1, 1024), (1, 512), (1, 256))


def remat_runs(torch, counters, get_config, FLConfig, make_bundle,
               init_global_state, make_round_fn, token_stream, tree_leaves):
    """Phase 4c's full-depth ``remat`` runs; returns their launches (a
    round of the search that ran out of memory launched kernels that are
    not counted)."""
    import dataclasses
    total = dict.fromkeys(counters, 0)
    cap = torch.cuda.get_device_properties(0).total_memory
    C, ls, S = 1, 2, 1024
    for name in REMAT_MODELS:
        base = dataclasses.replace(get_config(name), attn_impl="pallas")
        fl = FLConfig(algorithm="fedavg", clients_per_round=C,
                      local_steps=ls, lr=TRAIN_LR)
        settle(torch)
        state = init_global_state(make_bundle(base), fl, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        weights = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state["model"]))
        toks = torch.from_numpy(token_stream(C * ls * 32, S,
                                             vocab=base.vocab_size,
                                             n_sources=1)[0]).long().cuda()
        nex = torch.ones((C,), device="cuda")

        def run(remat, B, T, search=False):
            cfg = dataclasses.replace(base, remat=remat)
            round_fn = make_round_fn(make_bundle(cfg), fl,
                                     "client_sequential")
            arr = toks[:C * ls * B, :T + 1].reshape(C, ls, B, T + 1)
            batch = {"tokens": arr[..., :-1], "labels": arr[..., 1:]}
            line = dict(remat=remat, client_batch=B, seq_len=T,
                        tokens_per_step=B * T)
            try:
                line["activation_bytes"] = kept_bytes(
                    torch, cfg, state["model"],
                    {"tokens": batch["tokens"][0, 0]})
                for counter in counters.values():
                    counter.launches = 0
                start = line["resident_bytes"] = settle(torch)
                t0 = time.perf_counter()
                new, metrics = round_fn(state, batch, nex, TRAIN_LR)
                loss = float(metrics["local_loss"])
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                del new, metrics
            except torch.OutOfMemoryError:
                ms = None
            if ms is None:       # out of the handler: its frames are freed
                line.update(out_of_memory=True,
                            peak_bytes=torch.cuda.max_memory_allocated(),
                            ok=search)
                settle(torch)
                emit("train_remat_run", model=name, **line)
                if not search:
                    raise AssertionError(f"train remat {name}: {remat} at "
                                         f"{B} x {T} ran out of memory")
                return line
            peak = torch.cuda.max_memory_allocated()
            got = {k: c.launches for k, c in counters.items()}
            want = {k: v for k, v in lm_launches(cfg, "fedavg",
                                                 C * ls).items()
                    if k in counters}
            for k in total:
                total[k] += got[k]
            line.update(out_of_memory=False, round_ms=ms,
                        ms_per_local_step=ms / (C * ls),
                        tokens_per_s=C * ls * B * T / ms * 1e3,
                        peak_above_resident_bytes=peak - start,
                        peak_bytes=peak, loss=loss, launches=got,
                        expected=want,
                        ok=got == want and math.isfinite(loss))
            emit("train_remat_run", model=name, **line)
            return line

        runs = [run("none", 1, 16)]
        client_state = runs[0]["peak_above_resident_bytes"]
        for B, T in REMAT_NONE:
            runs.append(run("none", B, T, search=True))
            if not runs[-1]["out_of_memory"]:
                break
        fit = runs[-1]
        if fit["out_of_memory"]:
            raise AssertionError(f"{name}: remat='none' runs out of memory "
                                 f"at every size of {REMAT_NONE}")
        runs.append(run("layer", fit["client_batch"], fit["seq_len"]))
        lay = runs[-1]
        big = 2 * fit["tokens_per_step"] // S
        none_per_token = fit["activation_bytes"] / fit["tokens_per_step"]
        none_big = (lay["resident_bytes"] + client_state
                    + none_per_token * big * S)
        runs.append(run("layer", big, S))
        split = dict(
            weights_bytes=weights, client_state_bytes=client_state,
            activation_bytes={f"{r['remat']}@{r['client_batch']}x"
                              f"{r['seq_len']}": r.get("activation_bytes")
                              for r in runs[1:]},
            activation_bytes_per_token={
                "none": none_per_token,
                "layer": lay["activation_bytes"] / lay["tokens_per_step"]},
            none_activations_at_layer_big=none_per_token * big * S)
        same_loss = abs(lay["loss"] - fit["loss"]) <= 1e-6 * abs(fit["loss"])
        lower_peak = lay["peak_bytes"] < fit["peak_bytes"]
        ok = (all(r["ok"] for r in runs) and same_loss and lower_peak
              and none_big > cap)
        emit("train_remat", model=name, layers=base.n_layers,
             params=sum(t.numel() for t in tree_leaves(state["model"])),
             algorithm="fedavg", mode="client_sequential", clients=C,
             local_steps=ls, card_bytes=cap, memory_split=split,
             none_fits=[fit["client_batch"], fit["seq_len"]],
             layer_big=[big, S], none_peak_counted_at_layer_big=none_big,
             layer_vs_none_loss=[lay["loss"], fit["loss"]],
             checks=dict(runs=all(r["ok"] for r in runs),
                         same_loss=same_loss, lower_peak=lower_peak,
                         none_cannot_hold_big=none_big > cap))
        if not ok:
            raise AssertionError(f"train remat {name}: {runs}")
        del state, toks
        settle(torch)
    return total


# phase 4c: whisper-large-v3 at full depth (32 decoder and 32 encoder
# layers) in its client_parallel mode: FedAvg, then FedFusion-conv, one
# round of 2 clients x 2 local steps of ENCDEC_BATCH sequences of
# ENCDEC_SEQ tokens (Whisper's text context) beside 1,500 stub frames each
# (at twice the batch the activations alone, ~9.3 GB an example, pass the
# card).  Its times are the round's first call of ``round_fn`` (the
# kernels are built in phase 3), not a steady round.  The memory split
# (FedAvg): the weights; the activations a local step keeps for its
# backward (a forward over one step's batch, measured apart); the client
# state, the round's peak above the weights less those activations (the
# clients' models stacked, a gradient, the average)
ENCDEC_SEQ = 448
ENCDEC_BATCH = 4


def encdec_train_runs(torch, counters, get_config, FLConfig, make_bundle,
                      init_global_state, make_round_fn, token_stream,
                      tree_leaves):
    """Phase 4c's whisper-large-v3 runs; returns their launches."""
    import dataclasses
    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              attn_impl="pallas")
    total = dict.fromkeys(counters, 0)
    C, ls, B, S = 2, 2, ENCDEC_BATCH, ENCDEC_SEQ
    toks = torch.from_numpy(token_stream(C * ls * B, S, vocab=cfg.vocab_size,
                                         n_sources=1)[0]).long().cuda()
    toks = toks.reshape(C, ls, B, S + 1)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "audio_frames": torch.randn(
                 (C, ls, B, cfg.n_audio_frames, cfg.d_model), device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(1))}
    nex = torch.ones((C,), device="cuda")
    for algorithm in ("fedavg", "fedfusion"):
        fl = FLConfig(algorithm=algorithm, fusion_op="conv",
                      clients_per_round=C, local_steps=ls, lr=TRAIN_LR)
        settle(torch)
        bundle = make_bundle(cfg)
        state = init_global_state(bundle, fl, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        weights = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state["model"]))
        acts = (kept_bytes(torch, cfg, state["model"],
                           {k: v[0, 0] for k, v in batch.items()})
                if algorithm == "fedavg" else None)
        round_fn = make_round_fn(bundle, fl, cfg.fl_mode)
        for counter in counters.values():
            counter.launches = 0
        resident = settle(torch)
        t0 = time.perf_counter()
        new, metrics = round_fn(state, batch, nex, TRAIN_LR)
        loss = float(metrics["local_loss"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        del new, metrics
        got = {k: c.launches for k, c in counters.items()}
        want = {k: v for k, v in lm_launches(cfg, algorithm, C * ls).items()
                if k in counters}
        for k in total:
            total[k] += got[k]
        split = None if acts is None else dict(
            weights_bytes=weights, activation_bytes=acts,
            activation_bytes_per_example=acts / B,
            client_state_bytes=peak - resident - acts)
        checks = dict(launches=got == want, finite=math.isfinite(loss))
        emit("train_encdec", model=cfg.name, algorithm=algorithm,
             fusion_op="conv", mode=cfg.fl_mode, layers=cfg.n_layers,
             encoder_layers=cfg.n_enc_layers,
             params=sum(t.numel() for t in tree_leaves(state["model"])),
             clients=C, local_steps=ls, client_batch=B, seq_len=S,
             audio_frames=cfg.n_audio_frames, rounds=1,
             timed_round="first", round_ms=ms,
             ms_per_local_step=ms / (C * ls),
             tokens_per_s=C * ls * B * S / ms * 1e3,
             card_bytes=torch.cuda.get_device_properties(0).total_memory,
             peak_bytes=peak, peak_above_resident_bytes=peak - resident,
             memory_split=split, loss=loss, launches=got, expected=want,
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"train whisper-large-v3 {algorithm}: "
                                 f"{checks}")
        del state, round_fn
    del toks, batch
    settle(torch)
    return total


def train_reference(torch, counters, get_config, FLConfig, make_bundle,
                    init_global_state, run_federated_reference,
                    FederatedDataset, token_stream, source_partition):
    """Phase 4c's ``run_federated_reference`` run with the smollm-135m
    bundle; returns its launches.  Eval runs on 8 test sequences (its
    default 2,048 would make [2,048, 512, 49,152] logits)."""
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-135m"), attn_impl="pallas")
    bundle = make_bundle(cfg)
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                  clients_per_round=4, local_steps=2, local_batch=4,
                  lr=TRAIN_LR)
    S, rounds, n_test = 512, 2, 8
    toks, src = token_stream(128, S, vocab=cfg.vocab_size, n_sources=8)
    test, _ = token_stream(n_test, S, vocab=cfg.vocab_size, n_sources=8,
                           seed=1)
    data = FederatedDataset(source_partition(toks, src, 8),
                            {"tokens": test}, seed=0)
    state = init_global_state(bundle, fl, torch.Generator(device="cuda")
                              .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for counter in counters.values():
        counter.launches = 0
    stamps = [time.perf_counter()]
    res = run_federated_reference(
        bundle, fl, data, rounds=rounds, eval_examples=n_test,
        global_state=state, device="cuda",
        callback=lambda r, s_, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got = {k: c.launches for k, c in counters.items()}
    steps = rounds * fl.clients_per_round * fl.local_steps
    want = {k: v for k, v in lm_launches(cfg, "fedfusion", steps,
                                         evals=rounds).items()
            if k in counters}
    hist = [{k: h[k] for k in ("round", "local_loss", "acc", "loss")}
            for h in res.comm.history]
    checks = dict(launches=got == want, finite=all(
        math.isfinite(h["local_loss"]) and math.isfinite(h["loss"])
        for h in hist))
    round_s = [b - a for a, b in zip(stamps, stamps[1:])]
    emit("train_reference", model=cfg.name, algorithm="fedfusion",
         fusion_op="conv", clients=8, clients_per_round=4, local_steps=2,
         local_batch=4, seq_len=S, rounds=rounds, eval_sequences=n_test,
         round_s=round_s,
         # round 2's time (its aggregation and eval included) per step
         ms_per_local_step=1e3 * round_s[-1]
         / (fl.clients_per_round * fl.local_steps),
         tokens_per_s=fl.clients_per_round * fl.local_steps * 4 * S
         / round_s[-1], peak_above_start_bytes=peak - start,
         bytes_up=res.comm.bytes_up, history=hist, launches=got,
         expected=want, checks=checks)
    del res, state
    if not all(checks.values()):
        raise AssertionError(f"train reference: {checks}")
    return got


# phase 4g: the LM engine at full width.  smollm-135m, cut to 4 of its 30
# layers to keep the script within its time limit (10 until the decode
# graph and the MoE runs were added to phases 4b, 4c and 6, 6 until phase
# 4j was added), at phase 4c's
# train_reference setting (8 clients by source, 4 a round, 2 local steps of
# 4 x 512, eval on 8 test sequences, here every round, folded into the
# chunk), 4 rounds in 2-round chunks (8 until the recurrent families and
# the remat runs were added), each run beside 2 reference rounds;
# gemma3-1b with 2 of 4 clients a round at 2 x 1,024 (its 512-token local
# window binds; the batch fits beside the stacked client models)
LM_ENGINE = dict(clients=8, clients_per_round=4, local_steps=2,
                 local_batch=4, seq_len=512, eval_sequences=8, rounds=4,
                 chunk=2, ref_rounds=2, layers=4)
LM_ENGINE_RUNS = [("fedavg", "identity", "device"),
                  ("fedfusion", "identity", "device"),
                  ("fedmmd", "identity", "device"),
                  ("fedfusion", "topk", "host"),
                  ("fedavg", "int8", "device")]
LM_GEMMA = dict(clients=4, clients_per_round=2, local_steps=2, local_batch=2,
                seq_len=1024, eval_sequences=4, rounds=4, chunk=2)
# the LM engine runs' lr: from the random init (a loss near 100) FedFusion-
# conv at launch.train's 0.05 diverges within 8 rounds (to NaN at round 8
# on an H100); at 0.02 every algorithm trains
LM_ENGINE_LR = 0.02
# launch.train --engine at full scale (smollm-135m's width and vocab),
# with the registry's entry cut for the call to phase 4g's depth
# (LM_ENGINE["layers"]): at all 30 layers its calibration graphs took
# 53-86 s of phase 4g and the script's time limit
LM_TRAIN_ARGS = ["--engine", "--scale", "full", "--arch", "smollm-135m",
                 "--seq-len", "512", "--global-batch", "2", "--rounds", "4"]


def lm_engine_cfg(get_config):
    """Phase 4g's smollm-135m: full width, ``LM_ENGINE["layers"]`` deep."""
    import dataclasses
    base = get_config("smollm-135m")
    n = LM_ENGINE["layers"]
    return dataclasses.replace(base, n_layers=n,
                               block_pattern=base.block_pattern[:n],
                               attn_impl="pallas")


def lm_token_data(FederatedDataset, token_stream, source_partition, cfg,
                  n_clients, S, n_test):
    """A token federation of ``n_clients`` sources (16 sequences each, at
    least 128 in all) and ``n_test`` test sequences of seed 1."""
    toks, src = token_stream(max(128, 16 * n_clients), S,
                             vocab=cfg.vocab_size, n_sources=n_clients)
    test, _ = token_stream(n_test, S, vocab=cfg.vocab_size,
                           n_sources=n_clients, seed=1)
    return FederatedDataset(source_partition(toks, src, n_clients),
                            {"tokens": test}, seed=0)


def lm_engine_run(torch, runner, counters, bundle, fl, data, **kw):
    """One LM engine run on the card: (result, wall s, peak bytes above
    the start, launches)."""
    for counter in counters.values():
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = runner(bundle, fl, data, seed=0, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    return res, wall, peak, {k: c.launches for k, c in counters.items()}


def graph_lines(graphs):
    """The per-graph figures a phase line prints."""
    return [{k: g[k] for k in ("rounds", "replays", "warmup_s", "capture_s",
                               "instantiate_s", "pool_bytes",
                               "collectives_per_replay")} for g in graphs]


def lm_engine_phase(torch, counters, *, get_config, FLConfig, make_bundle,
                    init_global_state, run_federated,
                    run_federated_reference, FederatedDataset, token_stream,
                    source_partition, tree_leaves, train):
    """Phase 4g: the engine over LM bundles at full width (CUDA-graph
    supersteps over the transformer, K8a-K8c inside the graphs).

    smollm-135m (cut to ``LM_ENGINE["layers"]`` of its 30 layers) for
    FedAvg, FedFusion-conv, FedMMD,
    FedFusion-conv with a top-k 1/16 uplink on the host EF store and
    FedAvg with an int8 uplink, each against 2 reference rounds of the same
    configuration and state; gemma3-1b (26 layers, hd 256, windowed local
    layers) FedAvg; ``launch.train --engine`` at full scale; the one-rank
    shard-aware fused FedAvg superstep over NCCL, against the FedAvg run.
    Each run: steady rounds/s, ms per local step and tokens/s (beside the
    reference loop's), the graphs' warm-up, capture and instantiation
    seconds and pool bytes, peak memory, finite losses, bytes equal to the
    reference's, and every kernel's launches equal to the formula (the
    counters tick in each graph's two warm-ups and its capture).  Returns
    the launches of the measured runs."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.core.aggregate import ClientSharding
    from repro_torch.engine import run_federated_engine
    from repro_torch.launch.mesh import make_engine_mesh
    total = dict.fromkeys(counters, 0)
    byte_keys = ("bytes_up", "bytes_down", "bytes_up_ideal")

    def finite(hist):
        return all(math.isfinite(h[k]) for h in hist
                   for k in ("local_loss", "loss") if k in h)

    def add(got):
        for k in total:
            total[k] += got[k]

    # smollm-135m: five configurations
    E = LM_ENGINE
    cfg = lm_engine_cfg(get_config)
    bundle = make_bundle(cfg)
    C, ls, B, S = (E["clients_per_round"], E["local_steps"],
                   E["local_batch"], E["seq_len"])
    K, rounds = E["chunk"], E["rounds"]
    steps = C * ls                           # local steps a round

    def data():
        return lm_token_data(FederatedDataset, token_stream,
                             source_partition, cfg, E["clients"], S,
                             E["eval_sequences"])

    fedavg = None
    for algorithm, up, store in LM_ENGINE_RUNS:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv",
                      clients_per_round=C, local_steps=ls, local_batch=B,
                      lr=LM_ENGINE_LR, uplink_codec=up, topk_frac=TOPK_FRAC)
        state = init_global_state(bundle, fl, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        n_leaves = len(tree_leaves(state["model"]))
        res, wall, peak, got = lm_engine_run(
            torch, run_federated, counters, bundle, fl, data(),
            rounds=rounds, eval_every=1, eval_examples=E["eval_sequences"],
            superstep_rounds=K, ef_store=store, global_state=state)
        st = res.stats
        graphs = st["graphs"]
        per_replay = lm_launches(
            cfg, algorithm, steps * K, evals=K,
            messages=C * K * (up == "int8"), n_leaves=n_leaves,
            ef_rounds=K * (up == "topk"))
        patch = n_leaves * (st["chunks"] - 1) * (store == "host"
                                                 and up == "topk")
        want = {k: 3 * v + (patch if k == "ef_gather" else 0)
                for k, v in per_replay.items()}
        # the same configuration through the reference loop, same state
        stamps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = run_federated_reference(
            bundle, fl, data(), rounds=E["ref_rounds"], eval_every=1,
            eval_examples=E["eval_sequences"], global_state=state,
            device="cuda",
            callback=lambda r, s_, m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        ref_round_s = [b - a for a, b in zip([t0] + stamps, stamps)]
        for counter in counters.values():
            counter.launches = 0
        steady = st["steady_rounds_per_s"]
        hist = [{k: h[k] for k in ("round", "local_loss", "acc", "loss")}
                for h in res.comm.history]
        checks = dict(
            graphs=st["cuda_graphs"] and len(graphs) == 1
            and graphs[0]["rounds"] == K
            and graphs[0]["replays"] == rounds // K,
            launches_per_replay=graphs[0]["launches_per_replay"] == {
                k: per_replay[k] for k in graphs[0]["launches_per_replay"]},
            launches=got == want,
            bytes=[{k: h[k] for k in byte_keys} for h in
                   res.comm.history[:E["ref_rounds"]]]
            == [{k: h[k] for k in byte_keys} for h in ref.comm.history],
            finite=finite(res.comm.history) and finite(ref.comm.history))
        emit("lm_engine", model=cfg.name, params=sum(
                 t.numel() for t in tree_leaves(state["model"])),
             layers=cfg.n_layers, algorithm=algorithm, fusion_op="conv",
             uplink=up, ef_store=st["ef_store"], clients=E["clients"],
             clients_per_round=C, local_steps=ls, local_batch=B, seq_len=S,
             eval_sequences=E["eval_sequences"], rounds=rounds,
             superstep_rounds=K, wall_s=wall,
             steady_rounds_per_s=steady,
             steady_chunk_rounds_per_s=spread(chunk_rates(
                 st["chunk_times"])),
             ms_per_local_step=1e3 / steady / steps,
             tokens_per_s=steady * steps * B * S,
             reference_round_s=ref_round_s,
             reference_ms_per_local_step=1e3 * ref_round_s[-1] / steps,
             reference_tokens_per_s=steps * B * S / ref_round_s[-1],
             speedup_per_local_step=ref_round_s[-1] * steady,
             graphs=graph_lines(graphs), peak_above_start_bytes=peak,
             ef_page_bytes=st.get("ef_page_bytes"),
             host_wait_s=st["host_wait_s"], history=hist,
             bytes_up=res.comm.bytes_up, launches=got, expected=want,
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"lm engine {algorithm}/{up}/{store}: "
                                 f"{checks}")
        add(got)
        if algorithm == "fedavg" and up == "identity":
            fedavg = (fl, state, res, graphs[0]["launches_per_replay"])
        del ref
        if fedavg is None or res is not fedavg[2]:
            del res, state
        torch.cuda.empty_cache()

    # the one-rank shard-aware fused FedAvg superstep over NCCL, against
    # the FedAvg run above: bit for bit, K + 1 all-reduces a replay
    fl, state, single, single_per = fedavg
    rdzv = ROOT / "build" / "nccl_rdzv_lm"
    rdzv.parent.mkdir(parents=True, exist_ok=True)
    rdzv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    try:
        mesh = make_engine_mesh()
        shard = ClientSharding(("data",), (1,), group=mesh.get_group("data"),
                               position=0)
        res, wall, peak, got = lm_engine_run(
            torch, run_federated_engine, counters, bundle, fl, data(),
            rounds=rounds, eval_every=1, eval_examples=E["eval_sequences"],
            superstep_rounds=K, global_state=state, shard=shard,
            sharded_eval=False)
    finally:
        dist.destroy_process_group()
        rdzv.unlink(missing_ok=True)
    st = res.stats
    graphs = st["graphs"]
    want = {k: 3 * v for k, v in lm_launches(cfg, "fedavg", steps * K,
                                             evals=K).items()}
    checks = dict(
        state=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(res.global_state), tree_leaves(single.global_state))),
        history=res.comm.history == single.comm.history,
        graphs=len(graphs) == 1 and graphs[0]["replays"] == rounds // K,
        collectives_per_replay=graphs[0]["collectives_per_replay"] == K + 1,
        launches_per_replay=graphs[0]["launches_per_replay"] == single_per,
        launches=got == want, stats=st["client_shards"] == 1
        and st["fused_collective"])
    emit("lm_sharded_engine", model=cfg.name, algorithm="fedavg",
         client_shards=1, fused_collective=True, rounds=rounds,
         superstep_rounds=K, steady_rounds_per_s=st["steady_rounds_per_s"],
         single_device_steady_rounds_per_s=single.stats[
             "steady_rounds_per_s"],
         graphs=graph_lines(graphs), peak_above_start_bytes=peak,
         launches=got, expected=want, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"lm sharded engine: {checks}")
    add(got)
    del res, single, state, fedavg
    torch.cuda.empty_cache()

    # gemma3-1b, FedAvg: K8a-K8c at hd 256 with the windowed local layers
    # in the graphs
    G = LM_GEMMA
    cfg = dataclasses.replace(get_config("gemma3-1b"), attn_impl="pallas")
    bundle = make_bundle(cfg)
    C, ls, B, S = (G["clients_per_round"], G["local_steps"],
                   G["local_batch"], G["seq_len"])
    K, rounds, steps = G["chunk"], G["rounds"], C * G["local_steps"]
    fl = FLConfig(algorithm="fedavg", clients_per_round=C, local_steps=ls,
                  local_batch=B, lr=LM_ENGINE_LR)
    state = init_global_state(bundle, fl, torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    res, wall, peak, got = lm_engine_run(
        torch, run_federated, counters, bundle, fl,
        lm_token_data(FederatedDataset, token_stream, source_partition, cfg,
                      G["clients"], S, G["eval_sequences"]),
        rounds=rounds, eval_every=1, eval_examples=G["eval_sequences"],
        superstep_rounds=K, global_state=state)
    st = res.stats
    graphs = st["graphs"]
    want = {k: 3 * v for k, v in lm_launches(cfg, "fedavg", steps * K,
                                             evals=K).items()}
    steady = st["steady_rounds_per_s"]
    checks = dict(graphs=st["cuda_graphs"] and len(graphs) == 1
                  and graphs[0]["replays"] == rounds // K,
                  launches=got == want, finite=finite(res.comm.history))
    emit("lm_engine", model=cfg.name, params=sum(
             t.numel() for t in tree_leaves(state["model"])),
         layers=cfg.n_layers, head_dim=cfg.head_dim,
         window=cfg.sliding_window, algorithm="fedavg", uplink="identity",
         clients=G["clients"], clients_per_round=C, local_steps=ls,
         local_batch=B, seq_len=S, eval_sequences=G["eval_sequences"],
         rounds=rounds, superstep_rounds=K, wall_s=wall,
         steady_rounds_per_s=steady, ms_per_local_step=1e3 / steady / steps,
         tokens_per_s=steady * steps * B * S, graphs=graph_lines(graphs),
         peak_above_start_bytes=peak,
         history=[{k: h[k] for k in ("round", "local_loss", "acc", "loss")}
                  for h in res.comm.history],
         launches=got, expected=want, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"lm engine gemma3-1b: {checks}")
    add(got)
    del res, state
    torch.cuda.empty_cache()

    # launch.train --engine at full scale, LM_ENGINE["layers"] deep
    # (superstep_rounds="auto": a 1- and an 8-round calibration graph, then
    # the run's 2-round chunks, each boundary evaluating 64 sequences
    # eagerly)
    from repro_torch.configs import ARCH_CONFIGS
    cfg = lm_engine_cfg(get_config)
    for counter in counters.values():
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = ARCH_CONFIGS[cfg.name]
    ARCH_CONFIGS[cfg.name] = cfg
    try:
        res = train.main(LM_TRAIN_ARGS)
    finally:
        ARCH_CONFIGS[cfg.name] = full
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    got = {k: c.launches for k, c in counters.items()}
    st = res.stats
    graphs = st["graphs"]
    n_rounds = int(LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--rounds") + 1])
    captured = 1 + 8 + sum(g["rounds"] for g in graphs
                           if g["rounds"] not in (1, 8))
    # 4 clients a round x 2 local steps, in each graph's two warm-ups and
    # capture; the boundary evals (every n_rounds // 2 rounds) eagerly
    want = lm_launches(cfg, "fedavg", 3 * captured * 4 * 2,
                       evals=n_rounds // max(n_rounds // 2, 1))
    checks = dict(graphs=st["cuda_graphs"] and all(
                      g["replays"] >= 1 for g in graphs),
                  launches=got == want, finite=finite(res.comm.history),
                  rounds=len(res.comm.history) == n_rounds)
    emit("lm_launch_train", argv=LM_TRAIN_ARGS, layers=cfg.n_layers,
         vocab=cfg.vocab_size, d_model=cfg.d_model, wall_s=wall,
         chunk_rounds=st["chunk_rounds"],
         calibration_s=st["calibration_s"],
         steady_rounds_per_s=st["steady_rounds_per_s"],
         graphs=graph_lines(graphs), peak_above_start_bytes=peak,
         history=[{k: h[k] for k in ("round", "local_loss", "acc", "loss")
                   if k in h} for h in res.comm.history],
         launches=got, expected=want, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"lm launch.train --engine: {checks}")
    add(got)
    del res
    torch.cuda.empty_cache()
    return total


# phase 4g: mamba2-130m at full width cut to MAMBA_ENGINE_LAYERS of its 24
# SSD layers (all 24 until the VLM and encoder-decoder runs were added, 12
# until phase 4j was added: the script's time limit; phase 4b serves all
# 24) through the LM engine,
# FedAvg and FedFusion-conv (K2 in the graphs), each held
# exactly to the reference loop over the same rounds from the same state;
# and smollm-135m (phase 4g's 6 layers) FedAvg with remat="none" and
# "layer" through the engine (the cycles' recomputation captured in the
# graph), the "layer" run held exactly to its reference loop
LM_MAMBA = dict(clients=4, clients_per_round=2, local_steps=2, local_batch=4,
                seq_len=256, eval_sequences=4, rounds=4, chunk=2)
LM_REMAT = dict(rounds=4, chunk=2)
MAMBA_ENGINE_LAYERS = 6


def recurrent_engine_phase(torch, counters, *, get_config, FLConfig,
                           make_bundle, init_global_state, run_federated,
                           run_federated_reference, FederatedDataset,
                           token_stream, source_partition, tree_leaves):
    """Phase 4g's ``LM_MAMBA`` and ``LM_REMAT`` runs; returns their
    launches (the engine's; the reference loop's are not counted)."""
    import dataclasses
    total = dict.fromkeys(counters, 0)

    def engine_and_reference(cfg, algorithm, R, name_extra):
        M = dict(LM_MAMBA, **R)
        C, ls, B, S = (M["clients_per_round"], M["local_steps"],
                       M["local_batch"], M["seq_len"])
        K, rounds, steps = M["chunk"], M["rounds"], C * M["local_steps"]
        bundle = make_bundle(cfg)
        fl = FLConfig(algorithm=algorithm, fusion_op="conv",
                      clients_per_round=C, local_steps=ls, local_batch=B,
                      lr=LM_ENGINE_LR)

        def data():
            return lm_token_data(FederatedDataset, token_stream,
                                 source_partition, cfg, M["clients"], S,
                                 M["eval_sequences"])

        state = init_global_state(bundle, fl, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        kw = dict(rounds=rounds, eval_every=1,
                  eval_examples=M["eval_sequences"], global_state=state)
        res, wall, peak, got = lm_engine_run(
            torch, run_federated, counters, bundle, fl, data(),
            superstep_rounds=K, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = run_federated_reference(bundle, fl, data(), seed=0,
                                      device="cuda", **kw)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        for counter in counters.values():
            counter.launches = 0
        st = res.stats
        graphs = st["graphs"]
        want = {k: 3 * v for k, v in lm_launches(cfg, algorithm, steps * K,
                                                 evals=K).items()
                if k in counters}
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(res.global_state), tree_leaves(ref.global_state)))
        checks = dict(
            graphs=st["cuda_graphs"] and len(graphs) == 1
            and graphs[0]["replays"] == rounds // K,
            launches=got == want, exact=exact,
            history=res.comm.history == ref.comm.history,
            finite=all(math.isfinite(h["local_loss"])
                       for h in res.comm.history))
        steady = st["steady_rounds_per_s"]
        line = dict(
            model=cfg.name, params=sum(
                t.numel() for t in tree_leaves(state["model"])),
            layers=cfg.n_layers, remat=cfg.remat, algorithm=algorithm,
            fusion_op="conv", clients=M["clients"], clients_per_round=C,
            local_steps=ls, local_batch=B, seq_len=S,
            eval_sequences=M["eval_sequences"], rounds=rounds,
            superstep_rounds=K, wall_s=wall, steady_rounds_per_s=steady,
            ms_per_local_step=None if steady is None
            else 1e3 / steady / steps,
            reference_s=ref_s,
            reference_ms_per_local_step=1e3 * ref_s / (rounds * steps),
            graphs=graph_lines(graphs), peak_above_start_bytes=peak,
            history=[{k: h[k] for k in ("round", "local_loss", "acc",
                                        "loss")}
                     for h in res.comm.history],
            launches=got, expected=want, checks=checks, **name_extra)
        emit("lm_engine", **line)
        if not all(checks.values()):
            raise AssertionError(f"lm engine {cfg.name}/{algorithm}/"
                                 f"{cfg.remat}: {checks}")
        for k in total:
            total[k] += got[k]
        out = (line, res.global_state)
        del res, ref, state
        torch.cuda.empty_cache()
        return out

    base = get_config("mamba2-130m")
    cfg = dataclasses.replace(
        base, attn_impl="pallas", n_layers=MAMBA_ENGINE_LAYERS,
        block_pattern=base.block_pattern[:MAMBA_ENGINE_LAYERS])
    for algorithm in ("fedavg", "fedfusion"):
        engine_and_reference(cfg, algorithm, {}, {})
    # remat: smollm-135m at phase 4g's depth, LM_ENGINE's clients and batch
    E = LM_ENGINE
    R = dict(LM_REMAT, clients=E["clients"],
             clients_per_round=E["clients_per_round"],
             local_steps=E["local_steps"], local_batch=E["local_batch"],
             seq_len=E["seq_len"], eval_sequences=E["eval_sequences"])
    runs = {remat: engine_and_reference(
        dataclasses.replace(lm_engine_cfg(get_config), remat=remat),
        "fedavg", R, {"compare": "remat"}) for remat in ("none", "layer")}
    pools = {r: sum(g["pool_bytes"] for g in line["graphs"])
             for r, (line, _) in runs.items()}
    # the two runs' final models: equal, or at most within JAX's bound on
    # remat's gradients (tests/test_perf_knobs.py: atol 1e-5, rtol 1e-4)
    pairs = list(zip(tree_leaves(runs["none"][1]),
                     tree_leaves(runs["layer"][1])))
    diff = max((a - b).abs().max().item() for a, b in pairs)
    exact = all(torch.equal(a, b) for a, b in pairs)
    close = all(torch.allclose(b, a, rtol=1e-4, atol=1e-5) for a, b in pairs)
    emit("lm_engine_remat", model=runs["layer"][0]["model"],
         layers=runs["layer"][0]["layers"], graph_pool_bytes=pools,
         peak_above_start_bytes={r: line["peak_above_start_bytes"]
                                 for r, (line, _) in runs.items()},
         ms_per_local_step={r: line["ms_per_local_step"]
                            for r, (line, _) in runs.items()},
         layer_vs_none_max_abs_diff=diff, exact=exact,
         checks=dict(within_bound=close))
    if not close:
        raise AssertionError(f"lm engine remat='layer' differs from 'none' "
                             f"by {diff}")
    del runs
    torch.cuda.empty_cache()
    return total


def lm_engine_card_checks(torch, run_federated, run_federated_reference,
                          get_config, FLConfig, make_bundle,
                          init_global_state, FederatedDataset, token_stream,
                          source_partition, tree_leaves):
    """Phase 6 for the LM engine, smollm-135m at full width cut to 2
    layers, 2 of 4 clients a round, 2 local steps of 2 x 256, eval on 4
    sequences every round.  (a) FedFusion-conv, 2 rounds in one chunk from
    one state, on the card (a graph replay, the kernels) and on the CPU
    (eager, their plain versions): within 1% of the change training made,
    largest element and L2, as the other card-vs-CPU checks.  (b)
    FedFusion-conv with a top-k 1/16 uplink on the host EF store, 4 rounds
    in 2-round chunks on the card: the engine's replays against the
    reference loop's eager rounds, final model and history equal."""
    import dataclasses
    base = get_config("smollm-135m")
    cfg = dataclasses.replace(base, n_layers=2,
                              block_pattern=base.block_pattern[:2],
                              attn_impl="pallas")
    bundle = make_bundle(cfg)
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                  clients_per_round=2, local_steps=2, local_batch=2,
                  lr=TRAIN_LR)
    s0 = init_global_state(bundle, fl, torch.Generator(
        device="cuda").manual_seed(7), device="cpu")
    kw = dict(seed=0, eval_every=1, eval_examples=4, global_state=s0)

    def data():
        return lm_token_data(FederatedDataset, token_stream,
                             source_partition, cfg, 4, 256, 4)

    def flat(state):
        return torch.cat([t.cpu().flatten() for t in tree_leaves(state)])

    finals = {}
    for dev in ("cuda", "cpu"):
        res = run_federated(bundle, fl, data(), rounds=2, superstep_rounds=2,
                            device=dev, **kw)
        finals[dev] = (flat(res.global_state), res.comm.history,
                       res.stats["graphs"])
    start = flat(s0)
    diff = finals["cuda"][0] - finals["cpu"][0]
    change = finals["cpu"][0] - start
    ratio_max = diff.abs().max().item() / change.abs().max().item()
    ratio_l2 = (diff.norm() / change.norm()).item()
    replayed = [g["replays"] for g in finals["cuda"][2]] == [1]
    ok = ratio_max <= 0.01 and ratio_l2 <= 0.01 and replayed
    emit("card_vs_cpu", path="lm_engine", model=cfg.name, layers=2,
         algorithm="fedfusion", fusion_op="conv", rounds=2, batch=2,
         seq_len=256, max_abs_diff=diff.abs().max().item(),
         max_change=change.abs().max().item(), ratio_max=ratio_max,
         ratio_l2=ratio_l2, limit=0.01, graph_replays=replayed,
         losses={d: [h["local_loss"] for h in finals[d][1]]
                 for d in finals}, ok=ok)
    if not ok:
        raise AssertionError(f"LM engine: card and CPU disagree (ratios "
                             f"{ratio_max}, {ratio_l2}, replayed "
                             f"{replayed})")
    fl = dataclasses.replace(fl, uplink_codec="topk", topk_frac=TOPK_FRAC)
    ref = run_federated_reference(bundle, fl, data(), rounds=4,
                                  device="cuda", **kw)
    eng = run_federated(bundle, fl, data(), rounds=4, superstep_rounds=2,
                        ef_store="host", device="cuda", **kw)
    got, want = flat(eng.global_state), flat(ref.global_state)
    diff, change = got - want, want - start
    exact = torch.equal(got, want)
    hist_equal = eng.comm.history == ref.comm.history
    replays = sum(g["replays"] for g in eng.stats["graphs"])
    emit("engine_vs_reference", path="lm_engine", model=cfg.name, layers=2,
         algorithm="fedfusion", uplink="topk", ef_store="host", rounds=4,
         replays=replays, exact=exact, history_equal=hist_equal,
         max_abs_diff=diff.abs().max().item(),
         max_change=change.abs().max().item(),
         ratio_max=diff.abs().max().item() / change.abs().max().item(),
         ratio_l2=(diff.norm() / change.norm()).item())
    if not (exact and hist_equal and replays == 2):
        raise AssertionError("the LM engine's replays differ from the "
                             "reference loop on the card")


def trace_local_step(torch, get_config, FLConfig, make_bundle,
                     init_global_state, make_local_trainer, make_algorithm,
                     token_stream):
    """Phase 5 for LM training: one smollm-135m FedFusion-conv local step
    (batch 8, S = 1,024) under ``torch.profiler``, after one untraced."""
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-135m"), attn_impl="pallas")
    bundle = make_bundle(cfg)
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv", local_steps=1,
                  lr=TRAIN_LR)
    state = init_global_state(bundle, fl, torch.Generator(device="cuda")
                              .manual_seed(0), device="cuda")
    toks = torch.from_numpy(token_stream(8, 1024, vocab=cfg.vocab_size,
                                         n_sources=1)[0]).long().cuda()
    batch = {"tokens": toks[None, :, :-1], "labels": toks[None, :, 1:]}
    gx = make_algorithm("fedfusion").extra_from_state(state)
    trainer = make_local_trainer(bundle, fl)
    trainer(state["model"], gx, batch, TRAIN_LR)
    _, summary = trace_call(torch, lambda: trainer(state["model"], gx, batch,
                                                   TRAIN_LR))
    emit("trace_train", model=cfg.name, algorithm="fedfusion",
         fusion_op="conv", batch=8, seq_len=1024, **summary)


def train_card_vs_cpu(torch, train, get_config, FLConfig, InputShape,
                      make_bundle, init_global_state, tree_leaves, moe,
                      name="smollm-135m", algorithm="fedfusion", layers=2,
                      seq_len=128, batch=2, **replace):
    """Phase 6 for LM training: ``name`` at full width cut to ``layers``
    layers (``replace``: other cuts), ``algorithm`` (FedFusion-conv or
    FedAvg) through ``launch.train``'s loop in the config's ``fl_mode``,
    one round of 2 local steps a client at global batch ``batch`` and S =
    ``seq_len`` (256 until the recurrent families were added, 2 rounds until
    the decode graph and the MoE runs were added: the script's time
    limit), from the same state on the card (K8a, K8b, K8c, and K2 for
    FedFusion) and on the CPU (plain versions).  The final parameters must agree within 1%
    of the change training made (largest element and L2 norm), as the FL
    runs above.  For MoE the routing agreement of every router call is
    printed."""
    import dataclasses
    base = get_config(name)
    cfg = dataclasses.replace(base, n_layers=layers,
                              block_pattern=base.block_pattern[:layers],
                              attn_impl="pallas", **replace)
    fl = FLConfig(algorithm=algorithm, fusion_op="conv", local_steps=2,
                  lr=TRAIN_LR)
    shape = InputShape("custom_train", seq_len, batch, "train")
    s0 = init_global_state(make_bundle(cfg), fl,
                           torch.Generator(device="cuda").manual_seed(7),
                           device="cpu")
    t0 = time.perf_counter()
    rounds = 1
    finals, losses, routes = {}, {}, {}
    for dev in ("cuda", "cpu"):
        with recorded_routes(torch, moe) as routes[dev]:
            state, records = train.train_rounds(cfg, fl, shape,
                                                rounds=rounds, device=dev,
                                                global_state=s0, log=None)
        finals[dev] = torch.cat([t.cpu().flatten()
                                 for t in tree_leaves(state)])
        losses[dev] = [r["loss"] for r in records]
    start = torch.cat([t.flatten() for t in tree_leaves(s0)])
    diff = finals["cuda"] - finals["cpu"]
    change = finals["cpu"] - start
    ratio_max = diff.abs().max().item() / change.abs().max().item()
    ratio_l2 = (diff.norm() / change.norm()).item()
    ok = ratio_max <= 0.01 and ratio_l2 <= 0.01
    routing = (routing_agreement(torch, routes["cuda"], routes["cpu"],
                                 cfg.top_k) if cfg.n_experts else None)
    emit("card_vs_cpu_train", model=cfg.name, layers=layers,
         encoder_layers=cfg.n_enc_layers or None, head_dim=cfg.head_dim,
         vocab=cfg.vocab_size, fl_mode=cfg.fl_mode,
         algorithm=algorithm, fusion_op="conv", rounds=rounds, batch=batch,
         seq_len=seq_len, routing=routing,
         seconds=time.perf_counter() - t0,
         max_abs_diff=diff.abs().max().item(),
         max_change=change.abs().max().item(), ratio_max=ratio_max,
         ratio_l2=ratio_l2, limit=0.01, losses=losses, ok=ok)
    if not ok:
        raise AssertionError(f"LM training {cfg.name}: card and CPU disagree "
                             f"(ratios {ratio_max}, {ratio_l2})")


def trace_round(torch, run_federated_reference, bundle, fl, data,
                device="cuda"):
    """One round traced with ``torch.profiler`` after one untraced round:
    wall time, device kernels launched, the share of the wall time during
    which a kernel ran, the kernels taking the most device time, and the
    device time of the repository's own kernels (``csrc/``)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = []

    def after_round(r, state, metrics):
        if r == 0:
            torch.cuda.synchronize()
            prof.start()
            start.append(time.perf_counter())

    run_federated_reference(bundle, fl, data, rounds=2, seed=0,
                            eval_examples=EVAL_EXAMPLES, device=device,
                            callback=after_round)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start[0]
    prof.stop()
    return profile_summary(torch, prof, wall)


def profile_summary(torch, prof, wall):
    """Device kernels a stopped profiler saw over ``wall`` seconds: their
    count, the share of the wall time during which one ran, the kernels
    taking the most device time, and the device time of the repository's
    own kernels (``csrc/``)."""
    spans, by_name = [], {}
    graph_launches = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            graph_launches += e.name == "cudaGraphLaunch"
            continue
        spans.append((e.time_range.start, e.time_range.end))
        count_us = by_name.setdefault(e.name, [0, 0.0])
        count_us[0] += 1
        count_us[1] += e.time_range.end - e.time_range.start
    busy_us = union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    ours = [{"name": n[:80], "count": c, "ms": us / 1e3,
             "us_per_launch": us / c}
            for n, (c, us) in sorted(by_name.items())
            if any(k in n for k in OUR_KERNELS)]
    by_kind = {}
    for n, (c, us) in by_name.items():
        kind = kernel_kind(n)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    return dict(wall_ms=1e3 * wall, device_ops=len(spans),
                cuda_graph_launches=graph_launches,
                device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / 1e6 / wall,
                top=[{"name": n[:80], "count": c, "ms": us / 1e3}
                     for n, (c, us) in top], ours=ours, ms_by_kind=by_kind)


def kernel_kind(name):
    """A device activity's kind, for the traces' time by kind: the
    repository's kernels, matrix products (cuBLAS / CUTLASS), elementwise
    passes, reductions (softmax and norms included), copies, the rest."""
    low = name.lower()
    if any(k in name for k in OUR_KERNELS):
        return "repo_kernels"
    if "gemm" in low or "cutlass" in low:
        return "gemm"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reduce"
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copy"
    return "other"


def trace_call(torch, fn):
    """``fn()`` under ``torch.profiler``: its result and
    :func:`profile_summary` of its run."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    return out, profile_summary(torch, prof, wall)


def union_us(spans):
    """Length of the union of (start, end) intervals."""
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    return busy_us


def trace_engine(torch, run_federated, bundle, fl, data, rounds, store):
    """A whole engine run under ``torch.profiler``, read over its last
    (steady) chunk by :func:`replay_summary`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_federated(bundle, fl, data, rounds=rounds, seed=0,
                            eval_examples=EVAL_EXAMPLES,
                            superstep_rounds=ENGINE_CHUNK, ef_store=store)
        torch.cuda.synchronize()
    path = ROOT / "build" / "traces" / f"engine_{fl.algorithm}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return replay_summary(trace, res.stats["chunk_times"][-1])


def replay_summary(trace, last):
    """A traced engine run read over its last chunk (``last``, the
    engine's ``chunk_times`` entry): the device activities that carry the
    correlation id of the host's last ``cudaGraphLaunch`` (the kernels of
    that replay).  Their union is the replay's busy time; the chunk's
    period (the engine's own CUDA events, from its start to the end of the
    run) is the time it had."""
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in trace
                      if e.get("name") == "cudaGraphLaunch"
                      and "correlation" in e.get("args", {}))
    device = [e for e in trace if e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset")]
    period = last["end_ms"] - last["start_ms"]
    out = dict(graph_launches=len(launches), device_ops_whole_run=len(device),
               event_replay_ms=last["run_ms"], event_chunk_ms=period,
               event_busy_share=last["run_ms"] / period,
               chunk_rounds=last["r1"] - last["r0"])
    if not launches:
        return out
    corr = launches[-1][1]
    replay = [e for e in device if e["args"].get("correlation") == corr]
    out["profiler_sees_graph_kernels"] = bool(replay)
    if not replay:
        return out
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in replay]
    busy = union_us(spans)
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    kernels = {}
    for e in replay:
        c = kernels.setdefault(e["name"][:60], [0, 0.0])
        c[0] += 1
        c[1] += e.get("dur", 0.0) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    out.update(replay_device_ops=len(replay), replay_span_ms=span / 1e3,
               device_busy_ms=busy / 1e3,
               device_busy_share=busy / 1e3 / period,
               top=[{"name": n, "count": c, "ms": ms} for n, (c, ms) in top],
               ours=[{"name": n, "count": c, "ms": ms}
                     for n, (c, ms) in sorted(kernels.items())
                     if any(k in n for k in OUR_KERNELS)],
               nccl=[{"name": n, "count": c, "ms": ms}
                     for n, (c, ms) in sorted(kernels.items())
                     if "nccl" in n.lower()])
    return out


def trace_lm_chunk(torch, run_federated, bundle, fl, data, state, n_eval):
    """Phase 5 for the LM engine: a 2-round run in 1-round chunks (a
    callback forces them) whose callback after the first chunk starts
    ``torch.profiler``, so the trace holds the steady second chunk's graph
    replay (the warm-ups and capture came before), read by
    :func:`replay_summary`."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(r, state_, metrics):
        if r == 0:
            torch.cuda.synchronize()
            prof.start()

    res = run_federated(bundle, fl, data, rounds=2, seed=0, eval_every=1,
                        eval_examples=n_eval, global_state=state,
                        device="cuda", callback=start)
    torch.cuda.synchronize()
    prof.stop()
    path = ROOT / "build" / "traces" / "lm_engine.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return replay_summary(trace, res.stats["chunk_times"][-1])


def sharded_engine_phase(torch, engine_run, per_round_launches,
                         trace_engine_fn, *, bundle, FLConfig, data,
                         n_leaves, cudnn_exact, tree_leaves):
    """Phase 4f: the client-sharded engine on one rank of an NCCL group.

    (1) ``run_federated(mesh=make_engine_mesh())`` with a 1 x 1 mesh runs
    the single-device program: FedFusion-conv top-k equal, bit for bit, to
    the ``mesh=None`` run.  (2) The shard-aware supersteps over a
    one-rank :class:`ClientSharding`, each chunk captured by the engine as
    one CUDA graph with the NCCL all-reduces inside: fused plain (FedAvg,
    with the sharded evaluator), fused compressed (FedFusion-conv top-k,
    dense and paged EF), unfused compressed, FedMMD client-sequential
    int8; each within rtol 2e-5 / atol 1e-6 of the single-device run
    (printed: whether bitwise), bytes equal, all-reduces and launches a
    replay equal to their formulas, steady rounds/s beside the
    single-device run's.  (3) The sharded evaluator at one rank against
    the replicated one: equal.  Then one traced fused FedAvg chunk: the
    NCCL kernels a replay launched (at one rank NCCL may launch none).
    Returns the kernel launches of the measured runs."""
    import torch.distributed as dist
    from repro_torch.core.aggregate import ClientSharding
    from repro_torch.engine import run_federated_engine
    from repro_torch.launch.mesh import make_engine_mesh
    K, rounds = ENGINE_CHUNK, SHORT_ENGINE_ROUNDS
    cp, seq = "client_parallel", "client_sequential"
    fls = {"fedavg": (FLConfig(algorithm="fedavg", **FIG4), cp),
           "fusion-topk": (FLConfig(algorithm="fedfusion", fusion_op="conv",
                                    uplink_codec="topk",
                                    topk_frac=TOPK_FRAC, **FIG4), cp),
           "fedmmd-int8": (FLConfig(algorithm="fedmmd", uplink_codec="int8",
                                    **FIG4), seq)}
    rdzv = ROOT / "build" / "nccl_rdzv"
    rdzv.parent.mkdir(parents=True, exist_ok=True)
    rdzv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    total = None
    try:
        mesh = make_engine_mesh()
        shard = ClientSharding(("data",), (1,), group=mesh.get_group("data"),
                               position=0)

        def sharded_runner(*args, **kw):
            return run_federated_engine(*args, shard=shard, **kw)

        with torch.backends.cudnn.flags(**cudnn_exact):
            single = {name: engine_run(fl, mode, "device", K,
                                       n_rounds=rounds)
                      for name, (fl, mode) in fls.items()}
            # (1) a 1 x 1 mesh: the single-device program
            fl, mode = fls["fusion-topk"]
            m_res, m_line, m_got, m_finite = engine_run(
                fl, mode, "device", K, n_rounds=rounds, mesh=mesh)
            s_res, _, s_got, _ = single["fusion-topk"]
            checks = dict(
                state=all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(m_res.global_state),
                    tree_leaves(s_res.global_state))),
                history=m_res.comm.history == s_res.comm.history,
                client_shards=m_res.stats["client_shards"] == 1
                and not m_res.stats["fused_collective"],
                launches=m_got == s_got, finite=m_finite)
            emit("sharded_mesh", model=bundle.name, algorithm="fedfusion",
                 uplink="topk", mesh=str(mesh), rounds=rounds,
                 steady_rounds_per_s=m_line["steady_rounds_per_s"],
                 single_steady_rounds_per_s=single["fusion-topk"][1][
                     "steady_rounds_per_s"], checks=checks)
            if not all(checks.values()):
                raise AssertionError(f"sharded mesh 1 x 1: {checks}")
            total = {k: m_got[k] + sum(r[2][k] for r in single.values())
                     for k in m_got}
            # (2) the shard-aware supersteps over one NCCL rank
            for name, base, store, opts in [
                    ("fedavg/fused", "fedavg", "device",
                     dict(sharded_eval=True)),
                    ("fusion-topk/fused", "fusion-topk", "device", {}),
                    ("fusion-topk/fused-paged", "fusion-topk", "host", {}),
                    ("fusion-topk/unfused", "fusion-topk", "device",
                     dict(fused_collective=False)),
                    ("fedmmd-int8/fused", "fedmmd-int8", "device", {})]:
                fl, mode = fls[base]
                fused = opts.get("fused_collective", True)
                res, line, got, finite = engine_run(
                    fl, mode, store, K, n_rounds=rounds,
                    runner=sharded_runner,
                    **{"sharded_eval": False, **opts})
                ref_res, ref_line = single[base][:2]
                st = res.stats
                up = fl.uplink_codec
                per_replay = {k: v * K for k, v in per_round_launches(
                    fl.algorithm, up, "identity", 1).items()}
                n_ef = n_leaves * (up == "topk")
                if fused:           # the prologue's gather
                    per_replay["ef_gather"] += n_ef
                patch = n_ef * (st["chunks"] - 1) * (store == "host")
                want = {k: 3 * v + (patch if k == "ef_gather" else 0)
                        for k, v in per_replay.items()}
                extras = 1 if fl.algorithm == "fedfusion" else 0
                evals = K * opts.get("sharded_eval", False)
                coll = (K + 1 + evals if fused else
                        K * (1 + n_leaves + extras + 1 + 2 * n_ef) + evals)
                graphs = st["graphs"]
                diffs = [((a - b).abs() / (1e-6 + 2e-5 * b.abs())).max()
                         .item() for a, b in zip(
                             tree_leaves(res.global_state),
                             tree_leaves(ref_res.global_state))]
                bitwise = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(res.global_state),
                    tree_leaves(ref_res.global_state)))
                byte_keys = ("bytes_up", "bytes_down", "bytes_up_ideal")
                checks = dict(
                    state=max(diffs) <= 1.0,
                    bytes=(res.comm.bytes_up, res.comm.bytes_down)
                    == (ref_res.comm.bytes_up, ref_res.comm.bytes_down)
                    and [{k: h[k] for k in byte_keys}
                         for h in res.comm.history]
                    == [{k: h[k] for k in byte_keys}
                        for h in ref_res.comm.history],
                    graphs=st["cuda_graphs"] and len(graphs) == 1
                    and graphs[0]["rounds"] == K
                    and graphs[0]["replays"] == rounds // K,
                    collectives_per_replay=graphs[0]["collectives_per_replay"]
                    == coll,
                    launches_per_replay=graphs[0]["launches_per_replay"]
                    == per_replay,
                    launches=got == want,
                    stats=st["client_shards"] == 1
                    and st["fused_collective"] == fused
                    and st["sharded_eval"] == opts.get("sharded_eval", False),
                    finite=finite)
                if opts.get("sharded_eval"):
                    # (3) the sharded evaluator at one rank: the replicated
                    # evaluator's metrics
                    checks["sharded_eval_equal"] = [
                        (h["acc"], h["loss"]) for h in res.comm.history] == [
                        (h["acc"], h["loss"]) for h in ref_res.comm.history]
                emit("sharded_engine", model=bundle.name, run=name,
                     algorithm=fl.algorithm, mode=mode, uplink=up,
                     ef_store=st["ef_store"], client_shards=1,
                     fused_collective=fused,
                     sharded_eval=st["sharded_eval"], bitwise=bitwise,
                     max_err_over_tol=max(diffs),
                     collectives_per_replay=graphs[0][
                         "collectives_per_replay"],
                     expected_collectives_per_replay=coll,
                     steady_rounds_per_s=line["steady_rounds_per_s"],
                     single_device_steady_rounds_per_s=ref_line[
                         "steady_rounds_per_s"],
                     steady_ratio=line["steady_rounds_per_s"]
                     / ref_line["steady_rounds_per_s"],
                     rounds_per_s=line["rounds_per_s"],
                     capture_s=graphs[0]["capture_s"],
                     warmup_s=graphs[0]["warmup_s"],
                     pool_bytes=graphs[0]["pool_bytes"],
                     launches=got, expected=want, checks=checks)
                if not all(checks.values()):
                    raise AssertionError(f"sharded engine {name}: {checks}")
                for k in total:
                    total[k] += got[k]
            # one traced fused FedAvg chunk: the replay's NCCL kernels
            fl, mode = fls["fedavg"]
            traced = trace_engine_fn(
                lambda *a, **kw: run_federated_engine(
                    *a, shard=shard, sharded_eval=False, **kw),
                bundle, fl, data(), K, "device")
            emit("sharded_trace", model=bundle.name,
                 algorithm="fedavg", uplink="identity", client_shards=1,
                 nccl_kernels_per_replay=traced.get("nccl"),
                 **{k: v for k, v in traced.items() if k != "nccl"})
    finally:
        dist.destroy_process_group()
        rdzv.unlink(missing_ok=True)
    return total


# phase 4h: tensor parallelism on the one card.  (a) two worker processes,
# a (1, 2) mesh over a gloo group (NCCL refuses two ranks on one device):
# stablelm-3b at full width cut to 2 layers (32 / 32 heads of 80: head-
# parallel; 4 until the mesh families were added: the script's time
# limit) trains one FedFusion-conv and one FedAvg launcher round after a
# warm-up round (2 local steps of 4 x 512) and serves; gemma3-1b at full
# width cut to 13 of its 26 layers (two 5:1 cycles and a local layer; its
# one KV head is split mid-head: gathered; its global cache of 1,056 and
# its 512 rings halved over model) serves.  Serving: prompts of 1,024 at
# batch 4, decode steps teacher-forced on the one-device run's greedy
# tokens, eagerly (gloo's collectives wait on the host: no capture): 8
# for each (32 for stablelm-3b until then; gemma3-1b's gloo steps took
# 350-470 ms each at full depth).  (b) a (1, 1) NCCL mesh through
# build_train_step / build_serve_step, bit-equal to mesh=None, decoding
# eagerly and through a captured decode step.
TP_TRAIN = ("stablelm-3b", 2, 512, 4)      # model, layers, seq_len, batch
TP_SERVE = (("stablelm-3b", 2, 8), ("gemma3-1b", 13, 8))  # + steps
TP_PROMPT, TP_BATCH = 1024, 4
# the mesh's runs against one device: the all-reduces sum in another order
# (and cuBLAS at K halved): states within rtol 1e-4 / atol 1e-5; logits
# divided by the one-device run's largest |logit| (O(100) at the random
# init) within the same
TP_RTOL, TP_ATOL = 1e-4, 1e-5
TP_WORKER_TIMEOUT_S = 600


def _tp_cfg(get_config, name, layers):
    import dataclasses
    cfg = dataclasses.replace(get_config(name), attn_impl="pallas")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  block_pattern=cfg.block_pattern[:layers])
    return cfg


def _close_err(got, want, rtol, atol):
    """The largest excess of |got - want| over atol + rtol |want| (<= 0:
    within), and the largest |got - want|."""
    d = (got.double() - want.double()).abs()
    return ((d - atol - rtol * want.double().abs()).max().item(),
            d.max().item())


def tp_worker(argv):
    """One rank of phase 4h (a): ``chip_smoke.py --tp-worker RANK WORLD
    INIT OUT``.  Rank 0 also runs each case on one device first (rank 1
    waits), hands its greedy tokens over, and compares; each rank writes
    its launches and times to ``OUT/rank<r>.json``."""
    import datetime
    rank, world, init, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import FLConfig, InputShape, get_config
    from repro_torch.kernels import decode_attn, flash_attn, fusion_conv
    from repro_torch.launch import serve, train
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_leaves
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh((1, world), ("data", "model"), device="cuda")
    counters = {"fusion_conv": fusion_conv.fusion_conv_cuda,
                "flash_fwd": flash_attn.flash_fwd_cuda,
                "flash_bwd_dq": flash_attn.flash_bwd_dq_cuda,
                "flash_bwd_dkv": flash_attn.flash_bwd_dkv_cuda,
                "flash_decode": decode_attn.flash_decode_cuda}
    result = {"rank": rank, "train": [], "serve": []}

    def reset():
        for c in counters.values():
            c.launches = 0

    def count():
        return {k: c.launches for k, c in counters.items()}

    def sync():
        torch.cuda.synchronize(dev)

    name, layers, S, B = TP_TRAIN
    cfg = _tp_cfg(get_config, name, layers)
    shape = InputShape("custom_train", S, B, "train")
    for algorithm in ("fedfusion", "fedavg"):
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", local_steps=2,
                      lr=TRAIN_LR)
        line = dict(model=name, layers=layers, algorithm=algorithm,
                    seq_len=S, batch=B, local_steps=2, rounds=2)
        if rank == 0:
            one, rec = train.train_rounds(cfg, fl, shape, rounds=2,
                                          device=dev, log=None)
            line["one_device_ms_per_local_step"] = rec[-1]["ms"] / 2
            line["one_device_losses"] = [r["loss"] for r in rec]
        dist.barrier()
        reset()
        got, rec = train.train_rounds(cfg, fl, shape, rounds=2, device=dev,
                                      log=None, mesh=mesh)
        sync()
        line.update(gloo_ms_per_local_step=rec[-1]["ms"] / 2,
                    losses=[r["loss"] for r in rec], launches=count(),
                    expected={k: v for k, v in lm_launches(
                        cfg, algorithm, 2 * 2).items() if k in counters})
        line["expected"]["flash_decode"] = 0
        if rank == 0:
            errs = [_close_err(a, b, TP_RTOL, TP_ATOL) for a, b in
                    zip(tree_leaves(got), tree_leaves(one))]
            line.update(state_excess=max(e[0] for e in errs),
                        state_max_abs_err=max(e[1] for e in errs),
                        state_within=max(e[0] for e in errs) <= 0,
                        losses_within=all(
                            abs(a - b) <= TP_ATOL + TP_RTOL * abs(b)
                            for a, b in zip(line["losses"],
                                            line["one_device_losses"])))
            del one
        del got
        torch.cuda.empty_cache()
        result["train"].append(line)

    for name, layers, G in TP_SERVE:
        cfg = _tp_cfg(get_config, name, layers)
        P, Bs = TP_PROMPT, TP_BATCH
        prompts = serve.make_prompts(cfg, Bs, P, 0, dev)
        line = dict(model=name, layers=cfg.n_layers, batch=Bs, prompt=P,
                    steps=G, decode="eager (gloo)")
        toks = torch.zeros((Bs, G), dtype=torch.int64, device=dev)
        if rank == 0:
            with torch.no_grad():
                params = serve.tfm.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
                pre, step, _, _ = serve.serve_steps(cfg, Bs, P, G)
                sync()
                t0 = time.perf_counter()
                last, cache = pre(params, {"tokens": prompts})
                sync()
                line["one_device_prefill_ms"] = 1e3 * (time.perf_counter()
                                                       - t0)
                toks, logits, step_ms = serve.greedy_decode(
                    cfg, params, cache, last, P, G, step)
                one_logits = torch.cat([last[:, None], logits], 1)
                line["one_device_median_step_ms"] = statistics.median(
                    step_ms[1:])
                del params, cache, logits
                torch.cuda.empty_cache()
        dist.broadcast(toks, 0)
        with torch.no_grad():
            pre, step, p_layout, t_layout = serve.serve_steps(cfg, Bs, P, G,
                                                              mesh)
            params = serve.sharded_params(cfg, mesh, p_layout, dev)
            local = sh.local_block(prompts, t_layout, mesh).contiguous()
            reset()
            sync()
            t0 = time.perf_counter()
            last, cache = pre(params, {"tokens": local})
            sync()
            line["gloo_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            rows, step_ms = [last], []
            pos = torch.tensor(P, device=dev)
            for i in range(G):
                t0 = time.perf_counter()
                logits, cache = step(params, toks[:, i:i + 1], cache, pos)
                sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                rows.append(logits[:, 0])
                pos += 1
            n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
            line.update(gloo_median_step_ms=statistics.median(step_ms[1:]),
                        launches=count(),
                        expected=dict(fusion_conv=0, flash_fwd=n_attn,
                                      flash_bwd_dq=0, flash_bwd_dkv=0,
                                      flash_decode=n_attn * G))
            if rank == 0:
                got = torch.stack(rows, 1)
                scale = one_logits.abs().max()
                excess, err = _close_err(got / scale, one_logits / scale,
                                         TP_RTOL, TP_ATOL)
                line.update(logits_scale=scale.item(), logits_excess=excess,
                            logits_max_rel_err=err,
                            logits_within=excess <= 0,
                            finite=bool(torch.isfinite(got).all()))
                del one_logits, got
            del params, cache, rows
            torch.cuda.empty_cache()
        result["serve"].append(line)
    dist.barrier()
    dist.destroy_process_group()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(result))


def tp_phase(torch, *, get_config, FLConfig, InputShape, train, serve,
             tree_leaves, card):
    """Phase 4h.  (b) first: a one-rank NCCL group, a (1, 1) mesh; one
    smollm-135m FedFusion-conv launcher round and two serving requests
    (batch 4, 256-token prompts, 8 greedy steps) through the mesh's steps,
    eagerly and through one captured ``DecodeGraph``, each bit-equal to
    ``mesh=None``.  Then (a): two ``--tp-worker`` processes
    over gloo on this card (see ``tp_worker``); their launches against the
    formulas (K2 once a FedFusion local step, K8a / K8b / K8c as phase
    4c's, K8a once a layer in prefill and K9 once a layer a decode step,
    on each rank), their states and logits against one device.  The times
    are "gloo over one card": two processes sharing the card, every
    collective through the host, nothing about NVLink."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    # (b) ------------------------------------------------------------------
    rdzv = ROOT / "build" / "tp_rdzv"
    rdzv.parent.mkdir(parents=True, exist_ok=True)
    rdzv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = _tp_cfg(get_config, "smollm-135m", None)
        fl = FLConfig(algorithm="fedfusion", fusion_op="conv", local_steps=2,
                      lr=TRAIN_LR)
        shape = InputShape("custom_train", 512, 4, "train")
        runs = {}
        for key, m in (("none", None), ("mesh", mesh)):
            runs[key] = train.train_rounds(cfg, fl, shape, rounds=1,
                                           device="cuda", log=None, mesh=m)
        train_equal = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(runs["none"][0]), tree_leaves(runs["mesh"][0]))) \
            and runs["none"][1][0]["loss"] == runs["mesh"][1][0]["loss"]
        del runs
        outs = {}
        with torch.no_grad():
            params = serve.tfm.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
            requests = [serve.make_prompts(cfg, 4, 256, seed, "cuda")
                        for seed in (0, 1)]
            for key, m in (("none", None), ("mesh", mesh)):
                pre, step, _, _ = serve.serve_steps(cfg, 4, 256, 8, m)
                outs[key] = []
                for prompts in requests:
                    last, cache = pre(params, {"tokens": prompts})
                    outs[key].append(serve.greedy_decode(
                        cfg, params, cache, last, 256, 8, step)[:2])
            # both requests through one captured step on the NCCL mesh
            pre, step, _, _ = serve.serve_steps(cfg, 4, 256, 8, mesh)
            loop = serve.DecodeGraph(step, params, 8, mesh=mesh)
            outs["graph"] = []
            for prompts in requests:
                last, cache = pre(params, {"tokens": prompts})
                outs["graph"].append(loop.run(last, cache, 256)[:2])

        def equal(key):
            return all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       for a, b in zip(outs["none"], outs[key]))
        serve_equal, graph_equal = equal("mesh"), equal("graph")
        del params, outs, loop
        emit("tp_one_rank", card=card, backend="nccl", mesh=[1, 1],
             model=cfg.name, train_bitwise_equal=train_equal,
             serve_bitwise_equal=serve_equal,
             graph_decode_bitwise_equal=graph_equal, requests=2)
        if not (train_equal and serve_equal and graph_equal):
            raise AssertionError("phase 4h (b): the (1, 1) mesh's steps "
                                 "differ from mesh=None")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # (a) ------------------------------------------------------------------
    work = ROOT / "build" / "tp_workers"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    init = work / "rdzv"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tp-worker",
         str(r), "2", str(init), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TP_WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        for r, log in enumerate(logs):
            print(f"--- phase 4h worker {r} ---\n{log[-6000:]}", flush=True)
        raise AssertionError(f"phase 4h (a): worker exit codes "
                             f"{[p.returncode for p in procs]}")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    ok = True
    launches = {}
    for kind in ("train", "serve"):
        for i, line in enumerate(ranks[0][kind]):
            other = ranks[1][kind][i]
            both = [line["launches"], other["launches"]]
            good = all(b == line["expected"] for b in both)
            if kind == "train":
                good = good and line["state_within"] and \
                    line["losses_within"]
            else:
                good = good and line["logits_within"] and line["finite"]
            ok = ok and good
            for k, n in line["launches"].items():
                launches[k] = launches.get(k, 0) + n
            emit(f"tp_{kind}", card=card, timing="gloo over one card",
                 backend="gloo", mesh=[1, 2],
                 **{k: v for k, v in line.items() if k != "launches"},
                 launches_rank0=line["launches"],
                 launches_rank1=other["launches"], checks=good)
    emit("tp_workers", wall_s=wall)
    if not ok:
        raise AssertionError("phase 4h (a): a tensor-parallel run disagrees "
                             "with one device or with its launch formula")
    return launches


# phase 4i: the mesh families on the one card, two worker processes over
# gloo (NCCL refuses two ranks on one device), as phase 4h (a).  (1, 2)
# mesh, the model split: each model serves a prompt and MESH_STEPS eager
# decode steps teacher-forced on the one-device run's greedy tokens
# (rank 0 runs it first): mamba2-130m at full width cut to 8 of its 24 SSD
# layers (all 24 until phase 4j was added: the script's time limit; each
# rank the P slice of every head), recurrentgemma-9b at full
# width cut to one cycle (RG-LRU, RG-LRU, local attention: W split, the
# conv output gathered before the gates), whisper-large-v3 at full width
# cut to 2 encoder and 2 decoder layers (its 1,500-frame cross cache split
# 750 + 750: K9 on each slice with lse, merged), qwen2-vl-7b at full width
# cut to 1 layer with its 256 stub patch embeddings.  (2, 1) mesh, FSDP:
# one qwen2-vl-7b FedMMD round (1 layer, 4 clients in turn x 2 local steps
# of 2 x MESH_FSDP_SEQ, each data rank one row of each client) from the
# same seeded state as the one-device round on rank 0: ms a local step,
# the bytes through gloo a step (the collectives' payloads), each rank's
# persistent and peak bytes beside one device's
MESH_SERVE = (("mamba2-130m", 8, 0, 2, 512),         # model, layers,
              ("recurrentgemma-9b", 3, 0, 2, 512),   # encoder layers,
              ("whisper-large-v3", 2, 2, 2, 64),     # batch, prompt
              ("qwen2-vl-7b", 1, 0, 2, 512))
MESH_STEPS = 8
MESH_FSDP = ("qwen2-vl-7b", 1, "fedmmd")
MESH_FSDP_SEQ, MESH_FSDP_BATCH = 512, 8
MESH_WORKER_TIMEOUT_S = 600


def _mesh_cfg(get_config, name, layers, enc_layers):
    import dataclasses
    cfg = _tp_cfg(get_config, name, layers)
    if enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=enc_layers)
    return cfg


class _GlooBytes:
    """Counts the payload bytes of the process's ``all_reduce``,
    ``all_gather`` and ``all_to_all_single`` calls (the tensors handed
    over, one rank's view: an all-gather's whole output, an all-to-all's
    input)."""

    def __init__(self, dist):
        self.bytes = 0
        calls = (dist.all_reduce, dist.all_gather, dist.all_to_all_single)

        def size(t):
            return t.numel() * t.element_size()

        def all_reduce(t, *a, **kw):
            self.bytes += size(t)
            return calls[0](t, *a, **kw)

        def all_gather(parts, t, *a, **kw):
            self.bytes += sum(size(p) for p in parts)
            return calls[1](parts, t, *a, **kw)

        def all_to_all_single(out, t, *a, **kw):
            self.bytes += size(t)
            return calls[2](out, t, *a, **kw)
        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        dist.all_to_all_single = all_to_all_single


def mesh_worker(argv):
    """One rank of phase 4i: ``chip_smoke.py --mesh-worker RANK WORLD INIT
    OUT``.  Rank 0 also runs each case on one device first (rank 1
    waits) and compares; each rank writes its launches, times and bytes
    to ``OUT/rank<r>.json``."""
    import datetime
    rank, world, init, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import FLConfig, InputShape, get_config
    from repro_torch.core.rounds import init_global_state
    from repro_torch.kernels import decode_attn, flash_attn, mk_mmd
    from repro_torch.launch import serve, train
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import make_bundle
    from repro_torch.tree import tree_leaves, tree_map
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    gloo = _GlooBytes(dist)
    meshes = {s: make_mesh(s, ("data", "model"), device="cuda")
              for s in ((1, world), (world, 1))}
    counters = {"mk_mmd2": mk_mmd.mk_mmd2_cuda,
                "mk_mmd2_grad": mk_mmd.mk_mmd2_grad_cuda,
                "flash_fwd": flash_attn.flash_fwd_cuda,
                "flash_bwd_dq": flash_attn.flash_bwd_dq_cuda,
                "flash_bwd_dkv": flash_attn.flash_bwd_dkv_cuda,
                "flash_decode": decode_attn.flash_decode_cuda}
    result = {"rank": rank, "serve": [], "fsdp": []}

    def reset():
        for c in counters.values():
            c.launches = 0

    def count():
        return {k: c.launches for k, c in counters.items()}

    def sync():
        torch.cuda.synchronize(dev)

    def free():
        sync()
        torch.cuda.empty_cache()

    mesh = meshes[(1, world)]
    for name, layers, enc, Bs, P in MESH_SERVE:
        cfg = _mesh_cfg(get_config, name, layers, enc)
        G = MESH_STEPS
        prompts = serve.make_prompts(cfg, Bs, P, 0, dev)
        inputs = serve.make_inputs(cfg, Bs, 0, dev)
        line = dict(model=name, layers=cfg.n_layers,
                    enc_layers=cfg.n_enc_layers, batch=Bs, prompt=P,
                    steps=G, decode="eager (gloo)", mesh=[1, world])
        toks = torch.zeros((Bs, G), dtype=torch.int64, device=dev)
        if rank == 0:
            with torch.no_grad():
                params = serve.tfm.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
                pre, step, _, _ = serve.serve_steps(cfg, Bs, P, G)
                last, cache = pre(params, {"tokens": prompts, **inputs})
                toks, logits, step_ms = serve.greedy_decode(
                    cfg, params, cache, last, P, G, step)
                one_logits = torch.cat([last[:, None], logits], 1)
                line["one_device_median_step_ms"] = statistics.median(
                    step_ms[1:])
                del params, cache, logits
            free()
        dist.broadcast(toks, 0)
        with torch.no_grad():
            pre, step, p_layout, t_layout = serve.serve_steps(cfg, Bs, P, G,
                                                              mesh)
            params = serve.sharded_params(cfg, mesh, p_layout, dev)
            local = {"tokens": sh.local_block(prompts, t_layout, mesh),
                     **{k: sh.local_block(v, t_layout[:1], mesh)
                        for k, v in inputs.items()}}
            reset()
            gloo.bytes = 0
            sync()
            t0 = time.perf_counter()
            last, cache = pre(params, local)
            sync()
            line["gloo_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            line["cache_leaf_shapes"] = sorted({str(list(t.shape)) for t in
                                                tree_leaves(cache)})
            rows, step_ms = [last], []
            pos = torch.tensor(P, device=dev)
            for i in range(G):
                t0 = time.perf_counter()
                logits, cache = step(params, toks[:, i:i + 1], cache, pos)
                sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                rows.append(logits[:, 0])
                pos += 1
            n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
            line.update(gloo_median_step_ms=statistics.median(step_ms[1:]),
                        gloo_bytes=gloo.bytes, launches=count(),
                        expected=dict(
                            mk_mmd2=0, mk_mmd2_grad=0,
                            flash_fwd=n_attn + cfg.n_enc_layers,
                            flash_bwd_dq=0, flash_bwd_dkv=0,
                            flash_decode=(n_attn + n_attn * bool(enc)) * G))
            if rank == 0:
                got = torch.stack(rows, 1)
                scale = one_logits.abs().max()
                excess, err = _close_err(got / scale, one_logits / scale,
                                         TP_RTOL, TP_ATOL)
                line.update(logits_scale=scale.item(), logits_excess=excess,
                            logits_max_rel_err=err,
                            logits_within=excess <= 0,
                            finite=bool(torch.isfinite(got).all()))
                del one_logits, got
            del params, cache, rows
        free()
        result["serve"].append(line)

    # FSDP: the client-sequential round over data ----------------------------
    mesh = meshes[(world, 1)]
    name, layers, algorithm = MESH_FSDP
    cfg = _tp_cfg(get_config, name, layers)
    fl = FLConfig(algorithm=algorithm, fusion_op="conv", local_steps=2,
                  lr=TRAIN_LR)
    shape = InputShape("custom_train", MESH_FSDP_SEQ, MESH_FSDP_BATCH,
                       "train")
    steps = None
    line = dict(model=name, layers=layers, algorithm=algorithm,
                seq_len=MESH_FSDP_SEQ, batch=MESH_FSDP_BATCH,
                mesh=[world, 1], timing="gloo over one card")

    def one_round(m):
        """One launcher round (its draws, its learning rate) on ``m`` (None:
        one device): (state, loss, ms, persistent bytes, peak bytes), the
        state whole."""
        nonlocal steps
        round_fn, _, layouts, _ = build_train_step(cfg, fl, shape, m)
        plan = train.fl_plan(cfg, shape, m)
        steps = plan.n_clients * plan.local_steps
        whole = init_global_state(
            make_bundle(cfg), fl, torch.Generator(device=dev).manual_seed(0),
            dev)
        batch = train.round_batches(cfg, shape, plan)()
        nex = torch.ones((plan.n_clients,), device=dev)
        if m is not None:
            whole = tree_map(lambda t: t.clone(memory_format=torch
                                               .contiguous_format),
                             sh.shard_tree(whole, layouts[0], m))
            batch = sh.shard_tree(batch, layouts[1], m)
            nex = sh.local_block(nex, layouts[2], m).contiguous()
        batch = {k: v.contiguous().to(dev) for k, v in batch.items()}
        state = whole
        del whole
        free()
        torch.cuda.reset_peak_memory_stats(dev)
        persistent = torch.cuda.memory_allocated(dev)
        gloo.bytes = 0
        reset()
        sync()
        t0 = time.perf_counter()
        state, metrics = round_fn(state, batch, nex, train.round_lr(fl)(0))
        loss = float(metrics["local_loss"])
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        if m is not None:
            state = sh.gather_tree(state, layouts[0], m)
        return state, loss, ms, persistent, peak

    if rank == 0:
        one, loss, ms, persistent, peak = one_round(None)
        line.update(one_device_loss=loss, one_device_ms_per_local_step=(
            ms / steps), one_device_persistent_bytes=persistent,
            one_device_peak_bytes=peak)
        one = [t.cpu() for t in tree_leaves(one)]
        free()
    dist.barrier()
    got, loss, ms, persistent, peak = one_round(mesh)
    line.update(loss=loss, gloo_ms_per_local_step=ms / steps,
                gloo_bytes_per_local_step=gloo.bytes / steps,
                persistent_bytes=persistent, peak_bytes=peak,
                launches=count(), local_steps=steps,
                expected={k: v for k, v in lm_launches(
                    cfg, algorithm, steps).items() if k in counters})
    line["expected"]["flash_decode"] = 0
    if rank == 0:
        errs = [_close_err(a.to(dev), b.to(dev), TP_RTOL, TP_ATOL)
                for a, b in zip(tree_leaves(got), one)]
        line.update(state_excess=max(e[0] for e in errs),
                    state_max_abs_err=max(e[1] for e in errs),
                    state_within=max(e[0] for e in errs) <= 0,
                    loss_within=abs(loss - line["one_device_loss"])
                    <= TP_ATOL + TP_RTOL * abs(line["one_device_loss"]))
    result["fsdp"].append(line)
    del got
    free()
    dist.barrier()
    dist.destroy_process_group()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(result))


def mesh_phase(card):
    """Phase 4i: two ``--mesh-worker`` processes over gloo on this card
    (see ``mesh_worker``); their launches against the formulas (K8a once
    a self-attention and encoder layer in prefill, K9 once a
    self-attention and cross-attention layer a decode step; phase 4c's for
    the FedMMD round), logits and the gathered state against one device.
    Returns rank 0's launches."""
    work = ROOT / "build" / "mesh_workers"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    init = work / "rdzv"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), "2", str(init), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=MESH_WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        for r, log in enumerate(logs):
            print(f"--- phase 4i worker {r} ---\n{log[-6000:]}", flush=True)
        raise AssertionError(f"phase 4i: worker exit codes "
                             f"{[p.returncode for p in procs]}")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    ok = True
    launches = {}
    for kind in ("serve", "fsdp"):
        for i, line in enumerate(ranks[0][kind]):
            other = ranks[1][kind][i]
            both = [line["launches"], other["launches"]]
            good = all(b == line["expected"] for b in both)
            if kind == "fsdp":
                good = good and line["state_within"] and line["loss_within"]
                line["rank1_persistent_bytes"] = other["persistent_bytes"]
                line["rank1_peak_bytes"] = other["peak_bytes"]
            else:
                good = good and line["logits_within"] and line["finite"]
            ok = ok and good
            for k, n in line["launches"].items():
                launches[k] = launches.get(k, 0) + n
            emit(f"mesh_{kind}", card=card, backend="gloo",
                 **{k: v for k, v in line.items() if k != "launches"},
                 launches_rank0=line["launches"],
                 launches_rank1=other["launches"], checks=good)
    emit("mesh_workers", wall_s=wall)
    if not ok:
        raise AssertionError("phase 4i: a mesh run disagrees with one device "
                             "or with its launch formula")
    return launches


ANALYSIS_CPU_WORKERS = 3      # phase 4j: CPU lowerings beside the card's
ANALYSIS_TIMEOUT_S = 240
# phase 4j lowers each point at K = 2 and 3 rounds (the matrix's default K
# is 4): its contracts are per round and per chunk, and 4j's time is
# mostly rounds run
ANALYSIS_ROUNDS = 2


def analysis_specs():
    """Phase 4j's points: the quick matrix at ``ANALYSIS_ROUNDS``."""
    from repro_torch.analysis import default_matrix
    return [dataclasses.replace(s, n_rounds=ANALYSIS_ROUNDS)
            for s in default_matrix("quick")]


def cost_line(cost):
    """A cost model's totals as exact JSON numbers."""
    return {"flops": cost.flops, "bytes": cost.bytes,
            "coll_bytes": dict(sorted(cost.coll_bytes.items())),
            "coll_counts": dict(sorted(cost.coll_counts.items()))}


def op_costs(record):
    """``{op name: [flops, bytes]}`` summed over a record's entries: where
    two records' totals part, the ops that part."""
    from repro_torch.roofline import flops_breakdown
    return {n: [f, b] for n, f, b in flops_breakdown(record, top=10_000)}


def analysis_cpu_worker(argv):
    """Phase 4j's CPU side: points ``IDX::N`` of the analyzer's quick
    matrix lowered on the CPU (the sharded ones over a one-rank gloo
    group), their costs at K and K + 1 rounds written to ``OUT``."""
    idx, n, out = int(argv[0]), int(argv[1]), Path(argv[2])
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import lower_superstep
    from repro_torch.roofline import analyze_record
    torch.set_num_threads(1)
    rdzv = out.parent / f"rdzv{idx}"
    rdzv.unlink(missing_ok=True)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    try:
        costs = {}
        for spec in analysis_specs()[idx::n]:
            low = lower_superstep(spec, device="cpu")
            costs[spec.point] = {
                "cost": [cost_line(analyze_record(lw.record))
                         for lw in low.lowerings],
                "ops": op_costs(low.record)}
    finally:
        dist.destroy_process_group()
    out.write_text(json.dumps(costs))


def analysis_sync_worker(argv):
    """Phase 4j's planted sync, in a process of its own (a capture the card
    refuses may leave the caching allocator's capture state behind): the
    quick matrix's top-k point lowered on the card with ``.item()``
    called before its superstep; the host-sync findings and whether the
    card still computes afterwards, written to ``OUT``."""
    out = Path(argv[0])
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.analysis import (SuperstepSpec, lower_superstep,
                                      make_pass)
    from repro_torch.tree import tree_leaves

    def add_sync(fn):
        def g(*args, **kw):
            tree_leaves(args[0])[0].sum().item()
            return fn(*args, **kw)
        return g

    torch.set_num_threads(1)
    spec = SuperstepSpec(codec="topk", n_rounds=ANALYSIS_ROUNDS)
    low = lower_superstep(spec, device="cuda", inner_wrap=add_sync)
    caught = [str(f) for f in make_pass("host-sync").run(low)]
    torch.cuda.synchronize()
    healthy = float(torch.ones(4, device="cuda").sum()) == 4.0
    out.write_text(json.dumps({"point": spec.point, "caught": caught,
                               "healthy": healthy}))


def analysis_phase(torch, card):
    """Phase 4j: the static analyzer on the card.

    Every point of the quick matrix (``repro_torch.analysis``) is lowered
    inside the engine's own CUDA-graph capture with the op recorder on, at
    K and K + 1 rounds (``ANALYSIS_ROUNDS``); the sharded points over a
    one-rank NCCL group.
    Per point: every lowered pass (no finding allowed), the ``kernel:*``
    entries' launches against the kernel counters' deltas over each
    capture (equal), the all-reduces and their bytes, and the cost model's
    FLOPs and bytes against the same point lowered on the CPU (in
    ``ANALYSIS_CPU_WORKERS`` processes running beside the card's loop;
    equal).  A planted ``.item()`` must come back as a host-sync finding
    (``--analysis-sync-worker``, a process of its own), and one dry-run
    point (``launch.dryrun``: smollm-135m x
    decode_32k on the 16 x 16 mesh over a fake process group, ``meta``
    blocks) runs in a subprocess and prints its roofline terms."""
    import torch.distributed as dist
    from repro_torch.analysis import (kernel_launches, lower_superstep,
                                      make_pass, registered_passes)
    from repro_torch.analysis.records import ALL_REDUCE, count_collectives
    from repro_torch.roofline import analyze_record
    work = ROOT / "build" / "analysis"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    here = str(Path(__file__).resolve())
    cpu = [subprocess.Popen(
        [sys.executable, here, "--analysis-worker", str(i),
         str(ANALYSIS_CPU_WORKERS), str(work / f"cpu{i}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(ANALYSIS_CPU_WORKERS)]
    sync = subprocess.Popen(
        [sys.executable, here, "--analysis-sync-worker",
         str(work / "sync.json")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    dry = subprocess.Popen(
        [sys.executable, "-c",
         "import json, sys, torch\n"
         "torch.set_num_threads(1)\n"
         f"sys.path.insert(0, {str(SRC)!r})\n"
         "from repro_torch.launch.dryrun import run_one\n"
         "print(json.dumps(run_one('smollm-135m', 'decode_32k', False, "
         "save=False)))\n"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    lowered = [n for n in registered_passes()
               if make_pass(n).scope == "lowered"]
    lint = make_pass("source-lint").run(None)
    rdzv = ROOT / "build" / "nccl_rdzv_4j"
    rdzv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    rows, bad, ops = [], [], {}
    try:
        for spec in analysis_specs():
            t0 = time.perf_counter()
            low = lower_superstep(spec, device="cuda")
            findings = [str(f) for n in lowered
                        for f in make_pass(n).run(low)]
            kernels = [kernel_launches(lw.record) for lw in low.lowerings]
            deltas = [lw.launches for lw in low.lowerings]
            rows.append(dict(
                point=spec.point, findings=findings,
                kernels=kernels[0], kernels_next=kernels[1],
                launch_deltas=deltas[0], launch_deltas_next=deltas[1],
                kernels_equal_launches=kernels == deltas,
                entries=len(low.record),
                all_reduces=count_collectives(low.record, (ALL_REDUCE,)),
                all_reduces_next=count_collectives(low.record_next,
                                                   (ALL_REDUCE,)),
                all_reduce_bytes=low.lowerings[0].collective_bytes,
                peak_bytes=low.record.peak_bytes,
                graph_launches_per_replay={
                    k: v for k, v in (low.lowerings[0].graph or {}).get(
                        "launches_per_replay", {}).items() if v},
                cost=[cost_line(analyze_record(lw.record))
                      for lw in low.lowerings],
                seconds=time.perf_counter() - t0))
            ops[spec.point] = op_costs(low.record)
            if findings or kernels != deltas:
                bad.append(spec.point)
    finally:
        dist.destroy_process_group()

    costs = {}
    for i, p in enumerate(cpu):
        try:
            log = p.communicate(timeout=ANALYSIS_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            log = p.communicate()[0]
        if p.returncode:
            print(f"--- phase 4j CPU worker {i} ---\n{log[-6000:]}",
                  flush=True)
            raise AssertionError(f"phase 4j: CPU worker {i} exit "
                                 f"{p.returncode}")
        costs.update(json.loads((work / f"cpu{i}.json").read_text()))
    for row in rows:
        cpu_side = costs.get(row["point"], {})
        row["cpu_cost_equal"] = cpu_side.get("cost") == row["cost"]
        if not row["cpu_cost_equal"]:
            # the ops whose [flops, bytes] part between card and CPU (K)
            card_ops, cpu_ops = ops[row["point"]], cpu_side.get("ops", {})
            row["cpu_cost"] = cpu_side.get("cost")
            row["ops_parting"] = {
                n: [card_ops.get(n), cpu_ops.get(n)]
                for n in sorted(set(card_ops) | set(cpu_ops))
                if card_ops.get(n) != cpu_ops.get(n)}
            bad.append(row["point"])
        emit("analysis_point", card=card, **row)
    log = sync.communicate(timeout=ANALYSIS_TIMEOUT_S)[0]
    planted = (json.loads((work / "sync.json").read_text())
               if sync.returncode == 0 else {"caught": [], "healthy": False,
                                             "error": log[-3000:]})
    out = dry.communicate(timeout=ANALYSIS_TIMEOUT_S)[0]
    rec = json.loads(out.strip().splitlines()[-1]) if dry.returncode == 0 \
        else {"status": "error", "error": out[-3000:]}
    roof = rec.get("roofline", {})
    emit("analysis_dryrun", arch=rec.get("arch"), shape=rec.get("shape"),
         mesh=rec.get("mesh"), status=rec["status"],
         error=rec.get("error"), memory=rec.get("memory"),
         t_lower_s=rec.get("t_lower_s"),
         **{k: roof.get(k) for k in ("flops_per_chip", "hbm_bytes_per_chip",
                                     "coll_bytes_per_chip", "t_compute",
                                     "t_memory", "t_collective",
                                     "bottleneck", "useful_ratio",
                                     "mfu_bound")})
    emit("analysis_summary", points=len(rows), lint_findings=len(lint),
         mutation=planted, bad_points=bad)
    if bad or lint or not planted["caught"] or not planted["healthy"] \
            or rec["status"] != "ok":
        raise AssertionError(
            f"phase 4j: points {bad}, lint {lint[:3]}, mutation "
            f"{planted}, dry run {rec['status']}")


def probe_masks(torch, trainer, algo, start, newcomer, *, steps, batch,
                lr, tree_map):
    """Fig. 6's first held segment (phase 6) three ways: float32 on the
    card, float32 on the CPU and float64 on the CPU, from one start state
    and batch.  Each forward ReLU's mask (output > 0) and max-pool's
    argmax indices are taped call by call; returned: the calls a local
    step makes, the first call (and its step and op) where each float32
    path's masks part from the float64 path's and from each other, and
    the differing mask elements by step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Tape(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name == "aten::relu":
                self.calls.append(("relu", (out > 0).cpu()))
            elif name == "aten::max_pool2d_with_indices":
                self.calls.append(("max_pool", out[1].cpu()))
            return out

    runs = {}
    for key, dev, dt in (("cuda_f32", "cuda", torch.float32),
                         ("cpu_f32", "cpu", torch.float32),
                         ("cpu_f64", "cpu", torch.float64)):
        def cast(t):
            t = t.to(dev)
            return t.to(dt) if t.is_floating_point() else t
        st = tree_map(cast, start)
        data = {k: cast(torch.from_numpy(v[:steps * batch].reshape(
            steps, batch, *v.shape[1:]))) for k, v in newcomer.items()}
        tape = Tape()
        with tape:
            trainer(st["model"], algo.extra_from_state(st), data,
                    torch.tensor(lr, device=dev, dtype=dt))
        runs[key] = tape.calls
    per_step = len(runs["cpu_f64"]) // steps

    def parts(a, b):
        first, by_step = None, [0] * steps
        for i, ((op, ma), (_, mb)) in enumerate(zip(a, b)):
            n = int((ma != mb).sum())
            by_step[min(i // per_step, steps - 1)] += n
            if n and first is None:
                first = {"call": i, "step": i // per_step, "op": op,
                         "elements": n, "of": ma.numel()}
        return {"first": first, "differing_by_step": by_step}

    return {"calls_per_step": per_step,
            "cuda_f32_vs_cpu_f64": parts(runs["cuda_f32"], runs["cpu_f64"]),
            "cpu_f32_vs_cpu_f64": parts(runs["cpu_f32"], runs["cpu_f64"]),
            "cuda_f32_vs_cpu_f32": parts(runs["cuda_f32"], runs["cpu_f32"])}


def mnist_data(FederatedDataset, class_images, partition, seed=0,
               chaos=None):
    x, y = class_images(600, shape=(28, 28, 1), seed=0, noise=0.2,
                        template_seed=0)
    xt, yt = class_images(205, shape=(28, 28, 1), seed=1, noise=0.2,
                          template_seed=0)
    return FederatedDataset(partition(x, y, 100, shards_per_client=2),
                            {"x": xt, "y": yt}, seed=seed, chaos=chaos)


def fig6_data(FederatedDataset, class_images, permuted_partition):
    """``benchmarks/fig6_newclient.py``'s data (quick sizes): 8 permuted
    clients of 40 images a class, the union of their permutations of 20
    held-out images a class as the test set, and the newcomer, a fresh
    permutation (seed 1234) of the training images."""
    import numpy as np
    x, y = class_images(40, shape=(28, 28, 1), seed=0, noise=0.2,
                        template_seed=0)
    xt, yt = class_images(20, shape=(28, 28, 1), seed=1, noise=0.2,
                          template_seed=0)
    parts = permuted_partition(x, y, 8)
    flat = xt.reshape(len(xt), -1)
    test = {"x": np.concatenate([flat[:, p["perm"]].reshape(xt.shape)
                                 for p in parts]),
            "y": np.concatenate([yt for _ in parts])}
    new = permuted_partition(x, y, 1, seed=1234)[0]
    return (FederatedDataset(parts, test),
            {"x": new["x"], "y": new["y"]})


def local_step_costs(torch, bundle, fls, make_local_trainer,
                     init_global_state, make_algorithm, batches, rounds=7):
    """Per client objective (``fls``: name -> FLConfig) the cost of a
    local step on the card over ``batches`` ([steps, B, ...] on the card):
    wall ms (CUDA events around 3 back-to-back local trainings, the
    objectives taken in turns, ``rounds`` times; the median) and the
    device ops and µs a step under ``torch.profiler``."""
    calls = {}
    for name, fl in fls.items():
        state = init_global_state(bundle, fl,
                                  torch.Generator().manual_seed(0),
                                  device="cuda")
        trainer = make_local_trainer(bundle, fl)
        extra = make_algorithm(fl.algorithm).extra_from_state(state)
        calls[name] = (lambda trainer=trainer, state=state, extra=extra,
                       lr=fl.lr: trainer(state["model"], extra, batches, lr))
    steps = len(batches["x"])
    walls = {name: [] for name in calls}
    for fn in calls.values():
        fn()
        fn()
    for _ in range(rounds):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fn()
            end.record()
            torch.cuda.synchronize()
            walls[name].append(start.elapsed_time(end) / (3 * steps))
    out = {}
    for name, fn in calls.items():
        ops, us = device_per_call(torch, lambda i, fn=fn: fn(), calls=8,
                                  sets=1, tries=2)
        out[name] = dict(ms=statistics.median(walls[name]),
                         ms_spread=[min(walls[name]), max(walls[name])],
                         device_us=us / steps, device_ops=ops / steps)
    return out


# the serve phase: model, batch, prompt length; 32 greedy tokens each.
# Prompts of 1,024 tokens at batch 4 (longer than gemma3-1b's 512 window,
# so its local caches roll); h2o-danube-3-4b at batch 1 with a prompt of
# 4,608, past its 4,096 window, so the window binds in prefill and the
# ring caches roll during decode; granite-moe-1b (32 experts, top 8) at
# batch 4 x 1,024; mamba2-130m (24 SSD layers: no attention, its cache the
# states and conv windows) at 4 x 1,024; recurrentgemma-9b (38 layers: 12
# cycles of RG-LRU, RG-LRU, local attention and two RG-LRU in the tail) at
# batch 1 with a prompt of 2,560, past its 2,048 window
SERVE_GEN = 32
# whisper-large-v3: 64 prompt tokens beside 1,500 stub frames (prompt and
# generated tokens within its 448-token text context); qwen2-vl-7b: 1,024
# positions, the first 256 stub patch embeddings
SERVE_RUNS = [("gemma3-1b", 4, 1024), ("smollm-135m", 4, 1024),
              ("stablelm-3b", 4, 1024), ("h2o-danube-3-4b", 1, 4608),
              ("granite-moe-1b-a400m", 4, 1024), ("mamba2-130m", 4, 1024),
              ("recurrentgemma-9b", 1, 2560), ("whisper-large-v3", 4, 64),
              ("qwen2-vl-7b", 4, 1024)]
# decode logits vs a forward over the same tokens, and card vs CPU: the
# two sides sum in other orders (cuBLAS at M = 4 and M = 4,096, the kernels
# and the plain versions, oneDNN on the CPU), ~1e-6 of the logits' scale a
# layer; 1e-3 of max |logit| bounds that over 26 layers with room, and a
# wrong mask, cache slot or ring roll moves logits by O(1)
SERVE_TOL = 1e-3
# phase 6's recurrentgemma-9b vocabulary (its own: 256,000)
RG_CPU_VOCAB = 16_384


def serve_params(torch, tfm, get_config, name, **replace):
    """``name``'s config with ``attn_impl="pallas"`` (and ``replace``),
    random weights drawn on the card from seed 0, and its param count."""
    import dataclasses
    cfg = dataclasses.replace(get_config(name), attn_impl="pallas",
                              **replace)
    params = tfm.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
    return cfg, params


def full_capacity(cfg):
    """``cfg`` with an expert capacity that drops no token (MoE decode runs
    every expert at full capacity; a forward over the same tokens must too
    to be compared with it); ``cfg`` itself for a dense model."""
    import dataclasses
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, moe_capacity=cfg.n_experts / cfg.top_k)


def decode_loop(serve, tfm, cfg, params, G, step=None, **kw):
    """A ``DecodeGraph`` of ``G`` steps over ``tfm.decode_step`` (or
    ``step``): captured on the first run."""
    if step is None:
        def step(p, t, c, pos):
            return tfm.decode_step(cfg, p, t, c, pos)
    return serve.DecodeGraph(step, params, G, **kw)


def serve_run(torch, serve, tfm, flash_attn, decode_attn, cfg, params, B,
              P):
    """The serve phase for one model at batch ``B`` and prompts of ``P``
    tokens (seed 0), then a second request (prompts from seed 1; each with
    its stub patch or frame embeddings from ``serve.make_inputs`` at the
    same seed).  Eager:
    prefill and greedy decode once to warm up, then once measured with the
    kernel counts set to 0 just before (prefill ms on the host clock, each
    decode step's period on CUDA events, peak memory), the full-depth check
    (the last decode step's logits against ``forward_seq`` over the same
    tokens, at full expert capacity for MoE) and the second request.
    Graphed: both requests through one ``DecodeGraph`` (captured on the
    first), whose tokens and logits must equal the eager runs' bit for
    bit; its step periods, warm-up, capture and instantiation seconds and
    graph pool bytes.  Launches: K8a once an attention layer (the
    encoder's included) a prefill or forward, K9 once a self and a cross
    attention an eager step and, in the graph, once each at the warm-up
    and at the capture (the counters count Python calls), each replay
    launching them uncounted.  Returns the phase line, the launches
    (replays' K9 counted) and the loop."""
    from repro_torch.tree import tree_leaves
    G = SERVE_GEN
    tokens = serve.make_prompts(cfg, B, P, seed=0, device="cuda")
    tokens2 = serve.make_prompts(cfg, B, P, seed=1, device="cuda")
    inputs = serve.make_inputs(cfg, B, seed=0, device="cuda")
    inputs2 = serve.make_inputs(cfg, B, seed=1, device="cuda")
    n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
    k8_forward = n_attn + cfg.n_enc_layers
    k9_step = n_attn * (2 if cfg.n_enc_layers else 1)

    def counts():
        return {"flash_fwd": flash_attn.flash_fwd_cuda.launches,
                "flash_decode": decode_attn.flash_decode_cuda.launches}

    with torch.no_grad():
        last, cache = serve.prefill(cfg, params, tokens, P + G, inputs)
        serve.greedy_decode(cfg, params, cache, last, P, G)
        del last, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        flash_attn.flash_fwd_cuda.launches = 0
        decode_attn.flash_decode_cuda.launches = 0
        t0 = time.perf_counter()
        last, cache = serve.prefill(cfg, params, tokens, P + G, inputs)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k8_prefill = flash_attn.flash_fwd_cuda.launches
        toks, step_logits, step_ms = serve.greedy_decode(cfg, params, cache,
                                                         last, P, G)
        last_logits = step_logits[:, -1]
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        del cache
        full = full_capacity(cfg)
        out = tfm.forward_seq(full, params,
                              {"tokens": torch.cat([tokens, toks], 1),
                               **inputs}, want_logits=False)
        want = tfm.head_apply(full, params, out["features"][:, -1])
        rel = ((last_logits - want).abs().max() / want.abs().max()).item()
        del out, want
        last2, cache2 = serve.prefill(cfg, params, tokens2, P + G, inputs2)
        eager2 = serve.greedy_decode(cfg, params, cache2, last2, P, G)
        del cache2
        eager_counts = counts()
        # graphed: both requests through one captured step
        loop = decode_loop(serve, tfm, cfg, params, G)
        graphed = []
        for prompts, stub in ((tokens, inputs), (tokens2, inputs2)):
            last_g, cache_g = serve.prefill(cfg, params, prompts, P + G,
                                            stub)
            graphed.append(loop.run(last_g, cache_g, P))
            del last_g, cache_g
        graph_counts = counts()
    graph_ticks = {k: graph_counts[k] - eager_counts[k] for k in launches}
    eager = [(toks, step_logits), eager2[:2]]
    steady = step_ms[1:]
    med = statistics.median(steady)
    g_steady = graphed[0][2][1:] + graphed[1][2][1:]
    g_med = statistics.median(g_steady)
    per_replay = loop.stats["launches_per_replay"]["flash_decode"]
    checks = dict(
        k8a_per_prefill=k8_prefill == k8_forward,
        k8a_in_decode=launches["flash_fwd"] == k8_prefill,
        k9_per_step=launches["flash_decode"] == k9_step * G,
        k8a_total=graph_counts["flash_fwd"] == 5 * k8_forward,
        k9_eager_total=eager_counts["flash_decode"] == 2 * k9_step * G,
        k9_graph_ticks=graph_ticks["flash_decode"] == 2 * k9_step,
        k9_per_replay=per_replay == k9_step,
        replays=loop.replays == 2 * G,
        graph_tokens_equal=all(torch.equal(g[0], e[0]) for g, e in zip(
            graphed, eager)),
        graph_logits_bit_equal=all(torch.equal(g[1], e[1]) for g, e in zip(
            graphed, eager)),
        consistency=rel <= SERVE_TOL,
        finite=bool(torch.isfinite(last_logits).all()),
        tokens_in_vocab=bool(((toks >= 0) & (toks < cfg.vocab_size)).all()))
    line = dict(
        model=cfg.name, attn_impl=cfg.attn_impl,
        params=sum(t.numel() for t in tree_leaves(params)),
        layers=cfg.n_layers, attention_layers=n_attn,
        encoder_layers=cfg.n_enc_layers or None,
        stub_inputs={k: list(v.shape) for k, v in inputs.items()},
        cache_bytes=4 * sum(t.numel() for t in tree_leaves(loop.cache)),
        experts=cfg.n_experts or None, batch=B,
        prompt_len=P, gen_len=G, max_len=P + G, prefill_ms=prefill_ms,
        prefill_tokens_per_s=B * P / prefill_ms * 1e3,
        decode_ms_per_step=dict(median=med, min=min(steady),
                                max=max(steady), steps="2-32"),
        first_step_ms=step_ms[0], decode_ms_total=sum(step_ms),
        decode_tokens_per_s=B / med * 1e3,
        graph_ms_per_step=dict(median=g_med, min=min(g_steady),
                               max=max(g_steady),
                               steps="2-32 of both requests"),
        graph_tokens_per_s=B / g_med * 1e3, eager_over_graph=med / g_med,
        graph=loop.stats, params_bytes=4 * sum(
            t.numel() for t in tree_leaves(params)),
        allocated_at_start_bytes=start_bytes, peak_memory_bytes=peak,
        peak_above_start_bytes=peak - start_bytes,
        k8a_launches_per_prefill=k8_prefill,
        k9_launches_per_step=launches["flash_decode"] / G,
        consistency_rel_err=rel, consistency_limit=SERVE_TOL,
        consistency_forward="full expert capacity" if cfg.n_experts
        else "as served",
        ids0=toks[0].tolist(), checks=checks)
    total = {"flash_fwd": graph_counts["flash_fwd"],
             "flash_decode": graph_counts["flash_decode"]
             + loop.replays * per_replay}
    return line, total, loop


def serve_greedy_logits(torch, serve, tfm, cfg, params, tokens, steps,
                        inputs=None):
    """``serve.prefill`` (with ``inputs``, the stub embeddings) then
    ``steps`` greedy steps, through a captured ``DecodeGraph`` on the card
    and eagerly on the CPU: the last logits of the prefill and of each
    step, on the CPU."""
    P = tokens.shape[1]
    with torch.no_grad():
        last, cache = serve.prefill(cfg, params, tokens, P + steps, inputs)
        loop = decode_loop(serve, tfm, cfg, params, steps,
                           graph=tokens.is_cuda)
        _, logits, _ = loop.run(last, cache, P)
    return [last.cpu()] + list(logits.cpu().unbind(1))


@contextlib.contextmanager
def recorded_routes(torch, moe):
    """Records each call of ``moe.route`` (the MoE router: gates [T, E] and
    each token's top-k experts), on the CPU, while the block runs; not
    while a CUDA graph is being captured (a captured decode step's router
    runs at the eager warm-up step, which is recorded)."""
    calls, route = [], moe.route

    def record(xt, router, top_k):
        out = route(xt, router, top_k)
        if not torch.cuda.is_current_stream_capturing():
            calls.append((out[0].detach().cpu(), out[1].detach().cpu()))
        return out

    moe.route = record
    try:
        yield calls
    finally:
        moe.route = route


def routing_agreement(torch, card, cpu, top_k):
    """Over the router calls of two runs (card and CPU, in order): the
    tokens whose top-k expert sets agree, their share, and among the others
    the smallest gap on the CPU between the k-th and the next gate (a tie
    within rounding flips an expert)."""
    same = total = 0
    margins = []
    for (g_card, i_card), (g_cpu, i_cpu) in zip(card, cpu):
        agree = (i_card.sort(-1).values == i_cpu.sort(-1).values).all(-1)
        same += int(agree.sum())
        total += agree.numel()
        if not agree.all():
            top = g_cpu[~agree].topk(top_k + 1, -1).values
            margins.append((top[:, top_k - 1] - top[:, top_k]).min().item())
    return dict(router_calls=len(cpu), tokens=total, agree=same,
                agree_share=same / max(total, 1),
                min_gate_margin_disagreeing=min(margins) if margins else None)


def serve_card_vs_cpu(torch, serve, tfm, get_config, tree_map, moe,
                      name="gemma3-1b", layers=6, prompt_len=576, **replace):
    """Phase 6 for serving: ``name`` at full width cut to ``layers`` layers
    (gemma3-1b: one cycle of 6, 5 local and 1 global; ``replace``: other
    cuts), batch 1, a ``prompt_len``-token prompt (576: longer than
    gemma3-1b's window) and 4 greedy steps, the same
    weights on the card (kernels, the steps a captured ``DecodeGraph``) and
    on the CPU (plain versions, eager steps).  Step 0 is the prefill's last
    row.  The logits must agree within SERVE_TOL of their scale, and the
    tokens unless the top-2 margin is below it.  For MoE the routing
    agreement of every router call is printed."""
    t0 = time.perf_counter()
    pattern = get_config(name).block_pattern[:layers]
    cfg, params = serve_params(torch, tfm, get_config, name,
                               n_layers=layers, block_pattern=pattern,
                               **replace)
    tokens = serve.make_prompts(cfg, 1, prompt_len, seed=0, device="cpu")
    inputs = serve.make_inputs(cfg, 1, seed=0, device="cpu")
    with recorded_routes(torch, moe) as card_routes:
        card = serve_greedy_logits(torch, serve, tfm, cfg, params,
                                   tokens.cuda(), 4, tree_map(
                                       lambda t: t.cuda(), inputs))
    with recorded_routes(torch, moe) as cpu_routes:
        cpu = serve_greedy_logits(torch, serve, tfm, cfg,
                                  tree_map(lambda t: t.cpu(), params),
                                  tokens, 4, inputs)
    del params
    steps = []
    for i, (a, b) in enumerate(zip(card, cpu)):
        top2 = b.topk(2, -1).values
        steps.append(dict(
            step=i, rel_err=((a - b).abs().max() / b.abs().max()).item(),
            top2_margin=((top2[:, 0] - top2[:, 1]).min()
                         / b.abs().max()).item(),
            same_token=torch.equal(a.argmax(-1), b.argmax(-1))))
        if not steps[-1]["same_token"]:
            break           # the two sides decode other tokens from here
    ok = all(st["rel_err"] <= SERVE_TOL
             and (st["same_token"] or st["top2_margin"] < SERVE_TOL)
             for st in steps)
    routing = (routing_agreement(torch, card_routes, cpu_routes, cfg.top_k)
               if cfg.n_experts else None)
    emit("card_vs_cpu_serve", model=cfg.name, layers=cfg.n_layers,
         encoder_layers=cfg.n_enc_layers or None,
         stub_inputs={k: list(v.shape) for k, v in inputs.items()},
         head_dim=cfg.head_dim, pattern=list(pattern), batch=1,
         vocab=cfg.vocab_size, prompt_len=prompt_len, decode_steps=4,
         card_decode="graph", steps=steps,
         routing=routing, limit=SERVE_TOL, ok=ok,
         seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"serving {cfg.name}: card and CPU disagree: "
                             f"{steps} (routing {routing})")


def twin_card_vs_cpu(torch, tfm, get_config, tree_map, temperature=0.7,
                     arch="gemma3-1b", batch=4, prompt_len=32, gen_len=16):
    """Phase 6 for ``examples/serve_decode_torch.py``: its loop at its
    default size (``arch`` reduced, as the JAX example runs it) at
    ``temperature`` with the same Gumbel noise and the same weights on the
    card (a captured ``DecodeGraph``) and on the CPU (eager steps): the ids
    must be equal, unless the two sides part at a token whose noisy top-2
    margin on the CPU is below SERVE_TOL of the noisy scores' scale."""
    import importlib.util
    from repro_torch.launch import serve
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    cfg = get_config(arch).reduced()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    prompts = serve.make_prompts(cfg, batch, prompt_len, seed=1,
                                 device="cpu")
    noise = serve.gumbel_noise(gen_len, batch, cfg.vocab_size, seed=7,
                               device="cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        ids, _, decode_ms, loop = twin.generate(
            cfg, tree_map(lambda t, d=dev: t.to(d), params), prompts.to(dev),
            gen_len, temperature=temperature, noise=noise.to(dev))
        got[dev] = (ids.cpu(), loop.logits.cpu(), loop.graph_mode,
                    decode_ms)
    same = torch.equal(got["cuda"][0], got["cpu"][0])
    margin = None
    if not same:
        # the first step where a row parts, and the CPU's noisy margin there
        differ = (got["cuda"][0] != got["cpu"][0]).any(0).nonzero()[0, 0]
        i = int(differ)
        scores = (got["cpu"][1][:, i - 1] / temperature + noise[i]
                  if i > 0 else None)
        if scores is not None:
            top2 = scores.topk(2, -1).values
            margin = ((top2[:, 0] - top2[:, 1]).min()
                      / scores.abs().max()).item()
    ok = same or (margin is not None and margin < SERVE_TOL)
    emit("card_vs_cpu_twin", script="examples/serve_decode_torch.py",
         model=cfg.name, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
         temperature=temperature, noise="gumbel, torch.Generator seed 7",
         card_graph=got["cuda"][2], cpu_graph=got["cpu"][2],
         card_decode_ms=got["cuda"][3], ids_equal=same,
         parting_margin=margin, ok=ok)
    if not ok:
        raise AssertionError("serve_decode_torch: card and CPU ids differ")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda finds no CUDA device")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        sys.exit(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
                 "checkout of the repository")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.chaos import ChaosConfig
    from repro_torch.compress import QuantCodec, SketchCodec, make_codec
    from repro_torch.configs import CNN_MNIST, FLConfig, InputShape
    from repro_torch.control import ladder_values
    from repro_torch.core import (init_global_state, make_local_trainer,
                                  make_round_fn)
    from repro_torch.data import (FederatedDataset,
                                  artificial_noniid_partition, class_images,
                                  permuted_partition, source_partition,
                                  token_stream)
    from repro_torch.fl.api import make_algorithm
    from repro_torch.engine import chunk_schedule
    from repro_torch.fl import newclient
    from repro_torch.fl.server import run_federated, run_federated_reference
    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, compress_pack, decode_attn,
                                     flash_attn, fusion_conv, mk_mmd)
    from repro_torch.launch import serve, train
    from repro_torch.launch.specs import fl_plan
    from repro_torch.models import make_bundle, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.obs import RunLog, build_report, render
    from repro_torch.tree import tree_leaves, tree_map

    # 1. environment ------------------------------------------------------
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("environment", card=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=run([build.nvcc_path(), "--version"]).splitlines()[-1],
         triton=triton_version, tf32_matmul=False, tf32_cudnn=False)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    ptxas = {n: ptxas_summary(log) for n, log in build.BUILD_LOG.items()}
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: str(p.relative_to(ROOT)) for n, p in libs.items()},
         ptxas=ptxas)

    t_phase = time.perf_counter()
    # 3. kernels vs plain on the card ------------------------------------
    rows = check_kernels(torch, mk_mmd, fusion_conv)
    mnist_sizes = [t.numel() for t in tree_leaves(
        make_bundle(CNN_MNIST).init(torch.Generator()))]
    rows.update(check_codec_kernels(torch, compress_pack, QuantCodec,
                                    mnist_sizes))
    emit("launch_path", kernel="quant_unpack", n=1024, calls=2_000,
         host_ns_per_call=launch_path_split(torch, compress_pack))
    emit("launch_path", kernel="topk_select", n=5120, calls=2_000,
         host_ns_per_call=topk_launch_path_split(torch, compress_pack))
    rows.update(check_ef_kernels(torch, compress_pack))
    rows.update(check_attention_kernels(torch, flash_attn, decode_attn))
    rows.update(check_flash_bwd_kernels(torch, flash_attn))
    check_tp_kernels(torch, decode_attn, fusion_conv)
    emit("phase_3", seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    # 4. main path --------------------------------------------------------
    bundle = make_bundle(CNN_MNIST)
    n_params = sum(t.numel() for t in tree_leaves(
        bundle.init(torch.Generator().manual_seed(0))))
    steps, clients = FIG4["local_steps"], FIG4["clients_per_round"]
    n_leaves = len(tree_leaves(bundle.init(torch.Generator())))
    counters = {"gram_sum": mk_mmd.gram_sum_cuda,
                "mk_mmd2": mk_mmd.mk_mmd2_cuda,
                "mk_mmd2_grad": mk_mmd.mk_mmd2_grad_cuda,
                "fusion_conv": fusion_conv.fusion_conv_cuda,
                "quant_pack": compress_pack.quant_pack_cuda,
                "quant_unpack": compress_pack.quant_unpack_cuda,
                "topk_select": compress_pack.topk_select_cuda,
                "ef_gather": compress_pack.ef_gather_cuda,
                "ef_scatter": compress_pack.ef_scatter_cuda}
    launches = dict.fromkeys(counters, 0)

    def per_round_launches(algorithm, up, down, eval_rounds, cohort=clients):
        """Kernel launches of one round of this configuration (K3 twice per
        quantized message of up to 64 leaves, K4 once, the fused MK-MMD term once forward and once backward per
        FedMMD local step (10 rows a side: no Gram-sum launch), K2 once
        per local step and once per eval, K6 / K7 once per EF leaf with a
        top-k uplink); the reference loop's EF gather and scatter are
        tensor indexing, so ``ef=False`` there.  ``cohort``: the clients
        sampled a round (a partial-participation cohort trains, encodes
        and writes back its EF rows whole; masked clients' rows are
        written back unchanged).  The sketch codecs launch no kernel."""
        messages = (cohort * (up in ("int8", "int4"))
                    + (down in ("int8", "int4")))
        ef = n_leaves * (up == "topk")
        mmd = steps * cohort * (algorithm == "fedmmd")
        return {"gram_sum": 0, "mk_mmd2": mmd, "mk_mmd2_grad": mmd,
                "fusion_conv": (steps * cohort + eval_rounds)
                * (algorithm == "fedfusion"),
                "quant_pack": 2 * -(-n_leaves // 64) * messages,
                "quant_unpack": -(-n_leaves // 64) * messages,
                "topk_select": 0, "ef_gather": ef, "ef_scatter": ef}
    for algorithm, mode, rounds, up, down in [
            ("fedavg", "client_parallel", 3, "identity", "identity"),
            ("fedmmd", "client_parallel", 3, "identity", "identity"),
            ("fedfusion", "client_parallel", 3, "identity", "identity"),
            ("fedmmd", "client_sequential", 1, "identity", "identity"),
            ("fedfusion", "client_sequential", 1, "identity", "identity"),
            # fig. 7's codecs (benchmarks/fig7_compression.py)
            ("fedavg", "client_parallel", 3, "int8", "identity"),
            ("fedfusion", "client_parallel", 3, "topk", "identity"),
            ("fedmmd", "client_sequential", 2, "int4", "int8")]:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", uplink_codec=up,
                      downlink_codec=down, topk_frac=TOPK_FRAC, **FIG4)
        data = mnist_data(FederatedDataset, class_images,
                          artificial_noniid_partition)
        stamps = []
        for counter in counters.values():
            counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_federated_reference(
            bundle, fl, data, rounds=rounds, seed=0, mode=mode,
            eval_examples=EVAL_EXAMPLES,
            callback=lambda r, s, m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        want = {k: v * rounds for k, v in
                per_round_launches(algorithm, up, down, 1).items()}
        want["ef_gather"] = want["ef_scatter"] = 0
        hist = [{k: h[k] for k in ("round", "local_loss", "acc", "loss",
                                   "bytes_up", "bytes_down")}
                for h in res.comm.history]
        steady = (rounds - 1) / (stamps[-1] - stamps[0]) if rounds > 1 \
            else None
        emit("main_path", model=CNN_MNIST.name, params=n_params,
             algorithm=algorithm, fusion_op="conv", mode=mode,
             uplink=up, downlink=down, rounds=rounds,
             rounds_per_s=rounds / wall, steady_rounds_per_s=steady,
             bytes_up=res.comm.bytes_up, bytes_down=res.comm.bytes_down,
             launches=got, expected=want, history=hist)
        if got != want:
            raise AssertionError(f"{algorithm}/{mode}/{up}/{down}: kernel "
                                 f"launches {got} != {want}")
        if not all(math.isfinite(h["local_loss"]) and math.isfinite(h["loss"])
                   for h in hist):
            raise AssertionError(f"{algorithm}/{mode}/{up}/{down}: "
                                 "non-finite loss")
        for k in launches:
            launches[k] += got[k]

    # the engine: 8-round chunks replayed from captured CUDA graphs, eval
    # folded into the chunk, beside the reference loop's rounds/s of the
    # same configuration (measured in the same call)
    K, rounds = ENGINE_CHUNK, ENGINE_ROUNDS

    def engine_run(fl, mode, store, superstep_rounds, chaos=None,
                   data=None, n_rounds=rounds, runner=None, **options):
        """One engine run (``options``: further keywords of ``runner``,
        ``run_federated`` by default), its phase line, its launches and
        whether its losses stayed finite."""
        for counter in counters.values():
            counter.launches = 0
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        res = (runner or run_federated)(bundle, fl, data or mnist_data(
            FederatedDataset, class_images, artificial_noniid_partition,
            chaos=chaos),
            rounds=n_rounds, seed=0, mode=mode, eval_examples=EVAL_EXAMPLES,
            superstep_rounds=superstep_rounds, ef_store=store, **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = res.stats
        hist = [{k: h[k] for k in ("round", "local_loss", "acc", "loss")}
                for h in res.comm.history]
        line = dict(rounds=len(hist), superstep_rounds=st["chunk_rounds"],
                    chunks=st["chunks"], rounds_per_s=len(hist) / wall,
                    steady_rounds_per_s=st["steady_rounds_per_s"],
                    steady_chunk_rounds_per_s=spread(
                        chunk_rates(st["chunk_times"])),
                    graphs=st["graphs"], chunk_times=st["chunk_times"],
                    memory_reserved_before=reserved0,
                    memory_reserved_after=torch.cuda.memory_reserved(),
                    ef_page_bytes=st.get("ef_page_bytes"),
                    host_wait_s=st["host_wait_s"],
                    metrics_wait_s=st["metrics_wait_s"],
                    staging_pool_hits=st["staging_pool_hits"],
                    bytes_up=res.comm.bytes_up,
                    bytes_down=res.comm.bytes_down, history=hist)
        finite = all(math.isfinite(h["local_loss"]) and math.isfinite(h["loss"])
                     for h in hist)
        got = {k: c.launches for k, c in counters.items()}
        return res, line, got, finite

    byte_keys = ("bytes_up", "bytes_down", "bytes_up_ideal")
    fedavg_k8 = None
    for algorithm, mode, up, store in ENGINE_RUNS:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", uplink_codec=up,
                      topk_frac=TOPK_FRAC, **FIG4)
        res, line, got, finite = engine_run(fl, mode, store, K)
        st = res.stats
        per_replay = {k: v * K for k, v in
                      per_round_launches(algorithm, up, "identity",
                                         1).items()}
        # Python counters tick in the two warm-up runs and the capture of
        # each graph (never on a replay), and once per EF leaf for the
        # host store's patch of every chunk after the first
        patch = n_leaves * (st["chunks"] - 1) * (store == "host"
                                                 and up == "topk")
        want = {k: 3 * v + (patch if k == "ef_gather" else 0)
                for k, v in per_replay.items()}
        graphs = st["graphs"]
        device_launches = {
            k: sum(g["launches_per_replay"][k] * (g["replays"] + 2)
                   for g in graphs) + (patch if k == "ef_gather" else 0)
            for k in counters}
        # the same configuration through the reference loop
        stamps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = run_federated_reference(
            bundle, fl, mnist_data(FederatedDataset, class_images,
                                   artificial_noniid_partition),
            rounds=REF_ROUNDS, seed=0, mode=mode,
            eval_examples=EVAL_EXAMPLES,
            callback=lambda r, s_, m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        ref_bytes = {k: ref.comm.history[0][k] for k in byte_keys}
        bytes_ok = (all({k: h[k] for k in byte_keys} == ref_bytes
                        for h in res.comm.history + ref.comm.history)
                    and res.comm.bytes_up == rounds * ref_bytes["bytes_up"])
        checks = dict(
            graphs=st["cuda_graphs"] and len(graphs) == 1
            and graphs[0]["rounds"] == K
            and graphs[0]["replays"] == rounds // K,
            launches_per_replay=graphs[0]["launches_per_replay"]
            == per_replay,
            launches=got == want, bytes=bytes_ok, finite=finite)
        emit("engine", model=CNN_MNIST.name, algorithm=algorithm,
             fusion_op="conv", mode=mode, uplink=up, ef_store=st["ef_store"],
             **line, reference_rounds=REF_ROUNDS,
             reference_rounds_per_s=REF_ROUNDS / ref_wall,
             reference_steady_rounds_per_s=(REF_ROUNDS - 1)
             / (stamps[-1] - stamps[0]),
             reference_steady_round_rounds_per_s=spread(
                 [1 / (b - a) for a, b in zip(stamps, stamps[1:])]),
             launches=got, expected=want, device_launches=device_launches,
             reference_bytes=ref_bytes, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"engine {algorithm}/{up}/{store}: "
                                 f"{checks}")
        for k in launches:
            launches[k] += got[k]
        if algorithm == "fedavg":
            fedavg_k8 = (res, line)

    # superstep_rounds="auto" against the fixed 8 (FedAvg, the run above):
    # calibration captures a 1- and an 8-round graph and times one replay
    # of each; only the graphs of the run's own chunk lengths remain
    fl = FLConfig(algorithm="fedavg", uplink_codec="identity", **FIG4)
    res, line, got, finite = engine_run(fl, "client_parallel", "device",
                                        "auto")
    st = res.stats
    lengths = [b - a for a, b in chunk_schedule(0, rounds,
                                                st["chunk_rounds"])]
    calib_rounds = 1 + 8 - (8 if st["chunk_rounds"] == 8 else 0)
    want = {k: 3 * v * (calib_rounds + sum(g["rounds"] for g in st["graphs"]))
            for k, v in per_round_launches("fedavg", "identity", "identity",
                                           1).items()}
    checks = dict(
        graphs=sorted(g["rounds"] for g in st["graphs"])
        == sorted(set(lengths)) and all(
            g["replays"] == lengths.count(g["rounds"]) for g in st["graphs"]),
        launches=got == want, finite=finite,
        bytes=[{k: h[k] for k in byte_keys} for h in res.comm.history]
        == [{k: h[k] for k in byte_keys}
            for h in fedavg_k8[0].comm.history])
    emit("engine_auto", model=CNN_MNIST.name, algorithm="fedavg",
         calibration_s=st["calibration_s"], **line,
         fixed_8=dict((k, fedavg_k8[1][k]) for k in (
             "rounds_per_s", "steady_rounds_per_s",
             "steady_chunk_rounds_per_s", "graphs", "memory_reserved_before",
             "memory_reserved_after")),
         launches=got, expected=want, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"engine auto: {checks}")
    emit("phase_4", seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    # 4b. serve: the dense LMs, granite-moe-1b, the recurrent families,
    # whisper-large-v3 and qwen2-vl-7b at full width and depth, eagerly
    # and through a captured decode step (K8a and K9 counted
    # over each run, replays included; phase 5's serving trace is taken
    # while gemma3-1b's weights and decode graph are on the card)
    serve_launches = {"flash_fwd": 0, "flash_decode": 0}
    for name, B, P in SERVE_RUNS:
        cfg, params = serve_params(torch, tfm, get_config, name)
        line, got, loop = serve_run(torch, serve, tfm, flash_attn,
                                    decode_attn, cfg, params, B, P)
        emit("serve", **line)
        if not all(line["checks"].values()):
            raise AssertionError(f"serve {name}: {line['checks']}")
        for k in serve_launches:
            serve_launches[k] += got[k]
        if name == "gemma3-1b":
            tokens = serve.make_prompts(cfg, B, P, seed=0, device="cuda")
            with torch.no_grad():
                (last, cache), pre = trace_call(torch, lambda: serve.prefill(
                    cfg, params, tokens, P + SERVE_GEN))
                _, step = trace_call(torch, lambda: tfm.decode_step(
                    cfg, params, last.argmax(-1)[:, None], cache, P))
                last, cache = serve.prefill(cfg, params, tokens,
                                            P + SERVE_GEN)
                k9 = decode_attn.flash_decode_cuda.launches
                _, replays = trace_call(torch, lambda: loop.run(last, cache,
                                                                P))
                serve_launches["flash_decode"] += (
                    decode_attn.flash_decode_cuda.launches - k9
                    + SERVE_GEN * loop.stats["launches_per_replay"][
                        "flash_decode"])
            per = {k: replays[k] / SERVE_GEN for k in
                   ("wall_ms", "device_ops", "device_busy_ms")}
            emit("trace_serve", model=cfg.name, batch=B,
                 prompt_len=P, prefill=pre, decode_step=step,
                 graph_replays=dict(replays, replays=SERVE_GEN,
                                    per_replay=per))
            if replays["cuda_graph_launches"] != SERVE_GEN:
                raise AssertionError("the traced decode run shows "
                                     f"{replays['cuda_graph_launches']} "
                                     "cudaGraphLaunch calls")
            del last, cache
        del params, loop
        torch.cuda.empty_cache()
    emit("phase_4b", seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    # 4c. train: the LM training path at full width ---------------------
    lm_counters = {"gram_sum": mk_mmd.gram_sum_cuda,
                   "mk_mmd2": mk_mmd.mk_mmd2_cuda,
                   "mk_mmd2_grad": mk_mmd.mk_mmd2_grad_cuda,
                   "fusion_conv": fusion_conv.fusion_conv_cuda,
                   "flash_fwd": flash_attn.flash_fwd_cuda,
                   "flash_bwd_dq": flash_attn.flash_bwd_dq_cuda,
                   "flash_bwd_dkv": flash_attn.flash_bwd_dkv_cuda}
    train_launches = train_runs(torch, train, lm_counters, get_config,
                                FLConfig, InputShape, fl_plan, tree_leaves)
    ref_launches = train_reference(
        torch, lm_counters, get_config, FLConfig, make_bundle,
        init_global_state, run_federated_reference, FederatedDataset,
        token_stream, source_partition)
    for k, n in ref_launches.items():
        train_launches[k] += n
    torch.cuda.empty_cache()
    for k, n in remat_runs(torch, lm_counters, get_config, FLConfig,
                           make_bundle, init_global_state, make_round_fn,
                           token_stream, tree_leaves).items():
        train_launches[k] += n
    for k, n in encdec_train_runs(torch, lm_counters, get_config, FLConfig,
                                  make_bundle, init_global_state,
                                  make_round_fn, token_stream,
                                  tree_leaves).items():
        train_launches[k] += n
    emit("phase_4c", seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    # 4d. the rest of the main path: fig. 6's new-client probe, the cost
    # of a local step per algorithm, the sketch codecs, participation with
    # chaos on the engine -------------------------------------------------
    def reset():
        for counter in counters.values():
            counter.launches = 0

    def count():
        return {k: c.launches for k, c in counters.items()}

    # fig. 6: 15 engine rounds (5-round chunks) per variant, then the
    # newcomer's 6 local epochs from the trained state.  K2: the engine's
    # counters tick in the graph's two warm-up runs and its capture; the
    # probe launches once per local step and once per epoch's eval
    fig6_states = {}
    for algorithm, op in FIG6_VARIANTS:
        fl = FLConfig(algorithm=algorithm, fusion_op=op, **FIG6)
        data, newcomer = fig6_data(FederatedDataset, class_images,
                                   permuted_partition)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_federated(bundle, fl, data, rounds=FIG6_ROUNDS, seed=0,
                            eval_examples=EVAL_EXAMPLES,
                            superstep_rounds=FIG6_CHUNK)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got_train = count()
        conv = algorithm == "fedfusion" and op == "conv"
        fl_steps, cohort = FIG6["local_steps"], FIG6["clients_per_round"]
        want_train = 3 * FIG6_CHUNK * (fl_steps * cohort + 1) * conv
        reset()
        t0 = time.perf_counter()
        accs = newclient.newclient_convergence(
            bundle, fl, res.global_state, newcomer, epochs=FIG6_EPOCHS,
            batch=FIG6["local_batch"], lr=FIG6["lr"])
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        got_probe = count()
        probe_steps = len(newcomer["x"]) // FIG6["local_batch"]
        want_probe = FIG6_EPOCHS * (probe_steps + 1) * conv
        target = 0.8 * max(accs)
        checks = dict(
            launches=got_train["fusion_conv"] == want_train
            and got_probe["fusion_conv"] == want_probe
            and all(got_train[k] == got_probe[k] == 0 for k in counters
                    if k != "fusion_conv"),
            accuracies=len(accs) == FIG6_EPOCHS
            and all(0.0 <= a <= 1.0 for a in accs),
            finite=all(math.isfinite(h["local_loss"])
                       for h in res.comm.history))
        emit("newclient", model=CNN_MNIST.name, algorithm=algorithm,
             fusion_op=op, rounds=FIG6_ROUNDS, **FIG6,
             train_rounds_per_s=FIG6_ROUNDS / train_s,
             steady_rounds_per_s=res.stats["steady_rounds_per_s"],
             final_acc=res.comm.history[-1]["acc"], epochs=FIG6_EPOCHS,
             newcomer_examples=len(newcomer["x"]),
             steps_per_epoch=probe_steps, epoch_acc=accs,
             epochs_to_converge=next(i + 1 for i, a in enumerate(accs)
                                     if a >= target),
             ms_per_probe_epoch=1e3 * probe_s / FIG6_EPOCHS,
             fusion_conv_launches={"train": got_train["fusion_conv"],
                                   "probe": got_probe["fusion_conv"]},
             expected={"train": want_train, "probe": want_probe},
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"newclient {algorithm}/{op}: {checks}")
        launches["fusion_conv"] += (got_train["fusion_conv"]
                                    + got_probe["fusion_conv"])
        fig6_states[op if algorithm == "fedfusion" else algorithm] = (
            fl, res.global_state, newcomer)

    # the cost of a local step (fig. 4 setting: 4 steps of 10 examples),
    # each client objective against FedAvg's
    src = mnist_data(FederatedDataset, class_images,
                     artificial_noniid_partition)
    step_batches, _ = src.round_batch([0], steps, FIG4["local_batch"])
    step_batches = {k: torch.from_numpy(v[0]).cuda()
                    for k, v in step_batches.items()}
    costs = local_step_costs(
        torch, bundle, {f"{algorithm}/{op}" if algorithm == "fedfusion"
                        else algorithm: FLConfig(algorithm=algorithm,
                                                 fusion_op=op, **FIG4)
                        for algorithm, op in STEP_COST_ALGOS},
        make_local_trainer, init_global_state, make_algorithm,
        step_batches)
    base = costs["fedavg"]
    emit("local_step_cost", model=CNN_MNIST.name, card=card,
         local_batch=FIG4["local_batch"], steps_per_call=steps,
         per_step=costs,
         ratio_to_fedavg={k: {m: v[m] / base[m] for m in ("ms", "device_us",
                                                          "device_ops")}
                          for k, v in costs.items()})

    # the sketch codecs at fig. 7's fraction: the reference loop
    # (REF_ROUNDS) and the engine (40 in 8-round chunks); bytes up a round are
    # the codec's wire bytes times the cohort, on both loops.  ``lowrank``
    # sends each matrix update with ~4x its own norm of noise at 1/16
    # (Var X_hat_ij = |X_i|^2 / r, r = cols / 16): at fig. 4's lr of 0.08
    # that leaves training at the edge of stability, and cuDNN's
    # run-to-run differences alone decided whether a 40-round engine run
    # stayed finite.  At half that lr both codecs' losses must stay
    # finite on both loops.  Phase 6 holds the codec's arithmetic to the
    # CPU's
    for codec in ("mask", "lowrank"):
        fl = FLConfig(algorithm="fedavg", uplink_codec=codec,
                      topk_frac=TOPK_FRAC, **dict(FIG4, lr=SKETCH_LR))
        wire = make_codec(codec, topk_frac=TOPK_FRAC).bind(
            bundle.init(torch.Generator())).wire_bytes()
        reset()
        stamps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = run_federated_reference(
            bundle, fl, mnist_data(FederatedDataset, class_images,
                                   artificial_noniid_partition),
            rounds=REF_ROUNDS, seed=0, eval_examples=EVAL_EXAMPLES,
            callback=lambda r, s_, m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        ref_got = count()
        res, line, got, finite = engine_run(fl, "client_parallel", "device",
                                            K)
        zero = dict.fromkeys(counters, 0)
        want = {k: 3 * v * K for k, v in per_round_launches(
            "fedavg", codec, "identity", 1).items()}
        checks = dict(
            launches=got == want == zero and ref_got == zero,
            bytes=all(h["bytes_up"] == clients * wire for h in
                      res.comm.history + ref.comm.history)
            and res.comm.bytes_up == rounds * clients * wire,
            graphs=res.stats["graphs"][0]["replays"] == rounds // K,
            finite=finite and all(math.isfinite(h["local_loss"])
                                  and math.isfinite(h["loss"])
                                  for h in ref.comm.history))
        emit("sketch", model=CNN_MNIST.name, uplink=codec,
             topk_frac=TOPK_FRAC, lr=SKETCH_LR, wire_bytes=wire,
             bytes_up_per_round_formula=clients * wire,
             reference_rounds=REF_ROUNDS,
             reference_rounds_per_s=REF_ROUNDS / ref_wall,
             reference_steady_rounds_per_s=(REF_ROUNDS - 1)
             / (stamps[-1] - stamps[0]),
             reference_final_acc=ref.comm.history[-1]["acc"],
             final_acc=res.comm.history[-1]["acc"],
             **line,
             launches=got, expected=want, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"sketch {codec}: {checks}")

    # participation with fig. 8's chaos on the engine: 40 rounds in 8-round
    # chunks.  Bytes up charge the clients that arrived (n_up); the
    # launches count the whole cohort (masked clients train, encode and
    # have their EF rows written back unchanged)
    for algorithm, mode, up, policy, knobs in PART_RUNS:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", uplink_codec=up,
                      topk_frac=TOPK_FRAC, participation=policy, **knobs,
                      **FIG4)
        res, line, got, finite = engine_run(
            fl, mode, "device", K, chaos=ChaosConfig(**FIG8_CHAOS))
        st = res.stats
        cohort = st["round_cohort"]
        per_replay = {k: v * K for k, v in per_round_launches(
            algorithm, up, "identity", 1, cohort=cohort).items()}
        want = {k: 3 * v for k, v in per_replay.items()}
        wire = make_codec(up, topk_frac=TOPK_FRAC).bind(
            bundle.init(torch.Generator())).wire_bytes()
        fusion_b, model_b = res.comm._fusion_b, res.comm._model_b
        hist = res.comm.history
        checks = dict(
            participation=st["participation"] == policy,
            launches_per_replay=st["graphs"][0]["launches_per_replay"]
            == per_replay,
            launches=got == want,
            bytes_up=all(h["bytes_up"] == int(h["arrived"])
                         * (wire + fusion_b) for h in hist)
            and res.comm.bytes_up == sum(int(h["arrived"]) for h in hist)
            * (wire + fusion_b),
            bytes_down=all(h["bytes_down"] == cohort * (model_b + fusion_b)
                           for h in hist),
            graphs=st["graphs"][0]["replays"] == rounds // K,
            finite=finite)
        emit("participation", model=CNN_MNIST.name, algorithm=algorithm,
             fusion_op="conv", mode=mode, uplink=up, policy=policy,
             **knobs, chaos=FIG8_CHAOS, round_cohort=cohort,
             mean_sim_time=statistics.mean(h["sim_time"] for h in hist),
             mean_arrived=statistics.mean(h["arrived"] for h in hist),
             min_arrived=min(h["arrived"] for h in hist),
             wire_bytes=wire, fusion_bytes=fusion_b,
             final_acc=hist[-1]["acc"], **line, launches=got,
             expected=want, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"participation {algorithm}/{policy}: "
                                 f"{checks}")
        for k in launches:
            launches[k] += got[k]
    emit("phase_4d", seconds=time.perf_counter() - t_phase)

    # 4e. telemetry, run logs, profiling, halt_on_nonfinite and the
    # adaptive compression controllers on the engine, at fig. 4's setting
    # (40 rounds in 8-round chunks) -------------------------------------
    t_4e = time.perf_counter()
    cudnn_exact = dict(enabled=True, deterministic=True, allow_tf32=False)
    fl_topk = FLConfig(algorithm="fedavg", uplink_codec="topk",
                       topk_frac=TOPK_FRAC, **FIG4)
    topk_per_replay = {k: v * K for k, v in per_round_launches(
        "fedavg", "topk", "identity", 1).items()}

    def strip_tele(hist):
        return [{k: v for k, v in h.items() if not k.startswith("tele/")}
                for h in hist]

    # (a) top-k 1/16 with telemetry off and on: bit-equal under cuDNN's
    # deterministic algorithms; the taps add no kernel of ours
    tele = {}
    with torch.backends.cudnn.flags(**cudnn_exact):
        for on in (False, True):
            tele[on] = engine_run(fl_topk, "client_parallel", "device", K,
                                  telemetry=on)
    (off_res, off_line, off_got, off_finite), \
        (on_res, on_line, on_got, on_finite) = tele[False], tele[True]
    tele_keys = sorted(k for k in on_res.comm.history[-1]
                       if k.startswith("tele/"))
    checks = dict(
        state=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(off_res.global_state),
            tree_leaves(on_res.global_state))),
        history=strip_tele(on_res.comm.history) == off_res.comm.history,
        taps=bool(tele_keys) and all(
            all(math.isfinite(h[k]) for k in tele_keys)
            for h in on_res.comm.history),
        launches=off_got == on_got == {k: 3 * v for k, v in
                                       topk_per_replay.items()},
        finite=off_finite and on_finite)
    emit("telemetry", model=CNN_MNIST.name, algorithm="fedavg",
         uplink="topk", topk_frac=TOPK_FRAC, cudnn_deterministic=True,
         rounds=rounds,
         off=dict((k, off_line[k]) for k in (
             "rounds_per_s", "steady_rounds_per_s",
             "steady_chunk_rounds_per_s", "graphs")),
         on=dict((k, on_line[k]) for k in (
             "rounds_per_s", "steady_rounds_per_s",
             "steady_chunk_rounds_per_s", "graphs")),
         steady_ratio_on_off=on_line["steady_rounds_per_s"]
         / off_line["steady_rounds_per_s"],
         taps=tele_keys,
         last_round={k: on_res.comm.history[-1][k] for k in tele_keys},
         launches=on_got, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"telemetry: {checks}")

    # (b) the controllers: ef_ratio and loss_trend on the top-k ladder
    # (1/64, 1/32, 1/16), bytes_budget on the int8 ladder (4, 8) at a
    # budget of 0.75 of capacity (the level then changes inside the
    # replays); the ef_ratio run also writes a run log, read into a report
    runlog_path = ROOT / "build" / "runlogs" / "phase4e_ef_ratio.jsonl"
    for name, up, knobs in [("ef_ratio", "topk", {}),
                            ("loss_trend", "topk", {}),
                            ("bytes_budget", "int8",
                             dict(ctrl_budget_frac=0.75))]:
        fl = FLConfig(algorithm="fedavg", uplink_codec=up,
                      topk_frac=TOPK_FRAC, controller=name, **knobs, **FIG4)
        options = ({"runlog": str(runlog_path)} if name == "ef_ratio"
                   else {})
        res, line, got, finite = engine_run(fl, "client_parallel", "device",
                                            K, **options)
        ladder = ladder_values(fl)
        level_bytes = make_codec(up, topk_frac=TOPK_FRAC).bind(
            bundle.init(torch.Generator())).set_ladder(ladder).level_bytes()
        hist = res.comm.history
        levels = [h["level"] for h in hist]
        per_replay = {k: v * K for k, v in per_round_launches(
            "fedavg", up, "identity", 1).items()}
        eff_key = "eff_topk_frac" if up == "topk" else "eff_quant_bits"
        checks = dict(
            stats=res.stats["controller"] == name
            and res.stats["ladder"] == list(ladder),
            launches_per_replay=res.stats["graphs"][0]["launches_per_replay"]
            == per_replay,
            launches=got == {k: 3 * v for k, v in per_replay.items()},
            bytes=all(h["bytes_up"] == clients * level_bytes[h["level"]]
                      and h["tele/effective_bytes"]
                      == level_bytes[h["level"]]
                      and h[eff_key] == ladder[h["level"]] for h in hist)
            and res.comm.bytes_up == sum(clients * level_bytes[lv]
                                         for lv in levels),
            graphs=res.stats["graphs"][0]["replays"] == rounds // K,
            finite=finite)
        extra = {}
        if up == "int8":
            # K3 twice per message at any level
            checks["k3_two_per_message"] = per_replay["quant_pack"] \
                == 2 * clients * K
        if options:
            report = build_report(RunLog.load(str(runlog_path)),
                                  res.comm.to_records())
            text = render(report)
            checks["report"] = ("round-time breakdown" in text
                                and "compression schedule" in text
                                and report["round_time"]["chunks"]
                                == rounds // K)
            extra = dict(report_round_time=report["round_time"],
                         report_lines=len(text.splitlines()))
        emit("controller", model=CNN_MNIST.name, algorithm="fedavg",
             uplink=up, controller=name, **knobs, ladder=list(ladder),
             level_bytes=list(level_bytes), levels=levels,
             level_rounds={str(v): levels.count(v) for v in set(levels)},
             switches_inside_chunks=sum(
                 1 for r in range(1, len(levels))
                 if levels[r] != levels[r - 1] and r % K),
             cum_effective_bytes_up=res.comm.bytes_up,
             cum_capacity_bytes_up=rounds * clients * level_bytes[-1],
             **line, **extra, launches=got, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"controller {name}: {checks}")
        for k in launches:
            launches[k] += got[k]

    # (c) profile_dir: a 16-round run traced whole, one "superstep" range
    # per chunk holding that chunk's cudaGraphLaunch
    prof_dir = ROOT / "build" / "profile_4e"
    res, line, got, finite = engine_run(fl_topk, "client_parallel",
                                        "device", K, n_rounds=2 * K,
                                        profile_dir=str(prof_dir))
    trace = json.loads(Path(res.stats["profile"]).read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in trace
                    if e.get("name") == "superstep"
                    and e.get("cat") == "user_annotation")
    graph_launches = [e["ts"] for e in trace
                      if e.get("name") == "cudaGraphLaunch"]
    per_range = [sum(a <= t <= b for t in graph_launches)
                 for a, b in ranges]
    checks = dict(ranges=len(ranges) == res.stats["chunks"] == 2,
                  graph_launches=per_range == [1, 1]
                  and len(graph_launches) == 2,
                  device=any(e.get("cat") == "kernel" for e in trace),
                  finite=finite)
    emit("profile", model=CNN_MNIST.name, algorithm="fedavg", uplink="topk",
         rounds=2 * K, trace_events=len(trace), superstep_ranges=len(ranges),
         graph_launches_per_range=per_range,
         trace_bytes=Path(res.stats["profile"]).stat().st_size,
         checks=checks)
    Path(res.stats["profile"]).unlink()
    if not all(checks.values()):
        raise AssertionError(f"profile_dir: {checks}")

    # (d) halt_on_nonfinite: a run made to diverge (a NaN row in every image
    # of the first client sampled after the first chunk) stops at the first
    # chunk boundary after its non-finite round and writes its checkpoint;
    # the same run without the flag goes on; on a finite run, the flag's
    # cost (a drain at every boundary)
    halt_rounds = 3 * K
    probe = mnist_data(FederatedDataset, class_images,
                       artificial_noniid_partition)
    first = {}
    for r0 in range(0, halt_rounds, K):
        cids = probe.round_chunk(K, clients, steps, FIG4["local_batch"])[0]
        for r, row in enumerate(cids):
            for c in row:
                first.setdefault(int(c), r0 + r + 1)
    bad_round, bad_client = min((r, c) for c, r in first.items() if r > K)
    del probe

    def poisoned():
        d = mnist_data(FederatedDataset, class_images,
                       artificial_noniid_partition)
        clients_ = [dict(c) for c in d.clients]
        x = np.array(clients_[bad_client]["x"], copy=True)
        x[:, 0] = np.nan
        clients_[bad_client]["x"] = x
        return FederatedDataset(clients_, d.test, seed=0)

    halt_dir = ROOT / "build" / "halt_4e"
    shutil.rmtree(halt_dir, ignore_errors=True)   # a fresh run, no resume
    halted, h_line, _, _ = engine_run(
        fl_topk, "client_parallel", "device", K, data=poisoned(),
        n_rounds=halt_rounds, halt_on_nonfinite=True,
        checkpoint_dir=str(halt_dir), checkpoint_every=100)
    meta = json.loads((halt_dir / "meta.json").read_text())
    shutil.rmtree(halt_dir, ignore_errors=True)
    free, f_line, _, _ = engine_run(fl_topk, "client_parallel", "device", K,
                                    data=poisoned(), n_rounds=halt_rounds)
    finite_halt, fh_line, fh_got, fh_finite = engine_run(
        fl_topk, "client_parallel", "device", K, halt_on_nonfinite=True)
    boundary = -(-bad_round // K) * K
    first_bad = next(i + 1 for i, h in enumerate(free.comm.history)
                     if not math.isfinite(h["local_loss"]))
    checks = dict(
        halted_at=halted.stats["halted_at"] == boundary
        and len(halted.comm.history) == boundary,
        first_nonfinite=first_bad == bad_round,
        checkpoint=meta.get("halted") is True and meta["round"] == boundary,
        free_runs_on=free.stats["halted_at"] is None
        and len(free.comm.history) == halt_rounds,
        finite_run=fh_finite and finite_halt.stats["halted_at"] is None
        and fh_got == off_got)
    emit("halt_on_nonfinite", model=CNN_MNIST.name, algorithm="fedavg",
         uplink="topk", rounds=halt_rounds, poisoned_client=bad_client,
         first_nonfinite_round=first_bad, halted_at=halted.stats["halted_at"],
         checkpoint_meta=meta,
         finite_run=dict((k, fh_line[k]) for k in (
             "rounds_per_s", "steady_rounds_per_s",
             "steady_chunk_rounds_per_s", "metrics_wait_s")),
         flag_off=dict((k, off_line[k]) for k in (
             "rounds_per_s", "steady_rounds_per_s", "metrics_wait_s")),
         steady_ratio_flag_on_off=fh_line["steady_rounds_per_s"]
         / off_line["steady_rounds_per_s"],
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"halt_on_nonfinite: {checks}")
    for k in launches:
        launches[k] += off_got[k] + on_got[k]
    emit("phase_4e", seconds=time.perf_counter() - t_4e)

    # 4f. the client-sharded engine on one rank (NCCL), at fig. 4's setting
    # (40 rounds in 8-round chunks, cuDNN deterministic) ----------------
    t_4f = time.perf_counter()
    launches_4f = sharded_engine_phase(
        torch, engine_run, per_round_launches, trace_engine_fn=lambda *a:
        trace_engine(torch, *a), bundle=bundle, FLConfig=FLConfig,
        data=lambda: mnist_data(FederatedDataset, class_images,
                                artificial_noniid_partition),
        n_leaves=n_leaves, cudnn_exact=cudnn_exact, tree_leaves=tree_leaves)
    for k in launches:
        launches[k] += launches_4f[k]
    emit("phase_4f", seconds=time.perf_counter() - t_4f)

    # 4g. the engine over LM bundles at full width: CUDA-graph supersteps
    # over the transformer --------------------------------------------------
    t_4g = time.perf_counter()
    launches_4g = lm_engine_phase(
        torch, {**counters, "flash_fwd": flash_attn.flash_fwd_cuda,
                "flash_bwd_dq": flash_attn.flash_bwd_dq_cuda,
                "flash_bwd_dkv": flash_attn.flash_bwd_dkv_cuda},
        get_config=get_config, FLConfig=FLConfig, make_bundle=make_bundle,
        init_global_state=init_global_state, run_federated=run_federated,
        run_federated_reference=run_federated_reference,
        FederatedDataset=FederatedDataset, token_stream=token_stream,
        source_partition=source_partition, tree_leaves=tree_leaves,
        train=train)
    launches_4g_rec = recurrent_engine_phase(
        torch, {**counters, "flash_fwd": flash_attn.flash_fwd_cuda,
                "flash_bwd_dq": flash_attn.flash_bwd_dq_cuda,
                "flash_bwd_dkv": flash_attn.flash_bwd_dkv_cuda},
        get_config=get_config, FLConfig=FLConfig, make_bundle=make_bundle,
        init_global_state=init_global_state, run_federated=run_federated,
        run_federated_reference=run_federated_reference,
        FederatedDataset=FederatedDataset, token_stream=token_stream,
        source_partition=source_partition, tree_leaves=tree_leaves)
    for got in (launches_4g, launches_4g_rec):
        for k, n in got.items():
            train_launches[k] = train_launches.get(k, 0) + n
    emit("phase_4g", seconds=time.perf_counter() - t_4g)

    # 4h. tensor parallelism on the one card: (b) a (1, 1) NCCL mesh, then
    # (a) two ranks over gloo -------------------------------------------
    t_4h = time.perf_counter()
    launches_4h = tp_phase(torch, get_config=get_config, FLConfig=FLConfig,
                           InputShape=InputShape, train=train, serve=serve,
                           tree_leaves=tree_leaves, card=card)
    for k, n in launches_4h.items():
        train_launches[k] = train_launches.get(k, 0) + n
    emit("phase_4h", seconds=time.perf_counter() - t_4h)

    # 4i. the mesh families on the one card: two ranks over gloo, (1, 2)
    # serving and a (2, 1) FSDP round ----------------------------------------
    t_4i = time.perf_counter()
    for k, n in mesh_phase(card).items():
        train_launches[k] = train_launches.get(k, 0) + n
    emit("phase_4i", seconds=time.perf_counter() - t_4i)

    # 4j. the static analyzer on the card: the quick matrix captured with
    # the op recorder on, its costs against the CPU's, a planted sync, one
    # dry-run point ------------------------------------------------------
    t_4j = time.perf_counter()
    analysis_phase(torch, card)
    emit("phase_4j", seconds=time.perf_counter() - t_4j)

    t_phase = time.perf_counter()
    # 5. one traced round per algorithm, and with codecs (torch.profiler;
    # a separate run, so the rounds/s above are untraced); then the steady
    # chunk of two engine runs ---------------------------------------------
    for algorithm, up, down in [("fedavg", "identity", "identity"),
                                ("fedmmd", "identity", "identity"),
                                ("fedfusion", "identity", "identity"),
                                ("fedavg", "int8", "int8"),
                                ("fedmmd", "int4", "int4"),
                                ("fedfusion", "topk", "identity")]:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv",
                      uplink_codec=up, downlink_codec=down,
                      topk_frac=TOPK_FRAC, **FIG4)
        data = mnist_data(FederatedDataset, class_images,
                          artificial_noniid_partition)
        emit("trace", algorithm=algorithm, fusion_op="conv",
             mode="client_parallel", uplink=up, downlink=down,
             **trace_round(torch, run_federated_reference, bundle, fl, data))
    for algorithm, up in [("fedavg", "identity"), ("fedfusion", "topk")]:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", uplink_codec=up,
                      topk_frac=TOPK_FRAC, **FIG4)
        data = mnist_data(FederatedDataset, class_images,
                          artificial_noniid_partition)
        emit("trace_engine", algorithm=algorithm, fusion_op="conv",
             mode="client_parallel", uplink=up, ef_store="device",
             rounds=2 * ENGINE_CHUNK,
             **trace_engine(torch, run_federated, bundle, fl, data,
                            2 * ENGINE_CHUNK, "device"))

    trace_local_step(torch, get_config, FLConfig, make_bundle,
                     init_global_state, make_local_trainer, make_algorithm,
                     token_stream)
    torch.cuda.empty_cache()
    # one steady LM engine chunk (smollm-135m FedFusion-conv, phase 4g's
    # setting, 1-round chunks)
    lm_cfg = lm_engine_cfg(get_config)
    lm_bundle = make_bundle(lm_cfg)
    lm_fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                     clients_per_round=LM_ENGINE["clients_per_round"],
                     local_steps=LM_ENGINE["local_steps"],
                     local_batch=LM_ENGINE["local_batch"], lr=LM_ENGINE_LR)
    emit("trace_lm_engine", model=lm_cfg.name, algorithm="fedfusion",
         fusion_op="conv", clients_per_round=lm_fl.clients_per_round,
         local_steps=lm_fl.local_steps, local_batch=lm_fl.local_batch,
         seq_len=LM_ENGINE["seq_len"], **trace_lm_chunk(
             torch, run_federated, lm_bundle, lm_fl,
             lm_token_data(FederatedDataset, token_stream, source_partition,
                           lm_cfg, LM_ENGINE["clients"], LM_ENGINE["seq_len"],
                           LM_ENGINE["eval_sequences"]),
             init_global_state(lm_bundle, lm_fl, torch.Generator(
                 device="cuda").manual_seed(0), device="cuda"),
             LM_ENGINE["eval_sequences"]))
    del lm_bundle
    torch.cuda.empty_cache()
    emit("phase_5", seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    # 6. card vs CPU ------------------------------------------------------
    # Same initial state and data; 2 rounds x 10 clients x 4 SGD steps.
    # float32 results differ by summation order (cuDNN vs oneDNN convs,
    # cuDNN's run-to-run choices, the kernels vs the plain versions), ~1e-6
    # relative per op, and SGD at lr 0.08 compounds it over 80 steps (the
    # FedMMD loss even rises between these rounds).  The check holds the
    # card-vs-CPU difference to 1% of the change training made, both the
    # largest element and the L2 norm over all parameters: a wrong
    # gradient or a missing loss term differs by the order of the change
    # itself.
    #
    # With codecs: top-k selects from continuous values, so the same 1%
    # holds.  int8 codes are floor(x / scale + u) of each side's own
    # deltas, with the same offsets u (drawn once on the CPU and handed to
    # both through ``noise_fn``): a code flips by one where x / scale + u
    # lies within the two sides' difference of an integer, and one flip is
    # 1/127 of the leaf's largest delta, so that run is held to 1% in L2
    # and 2% for the largest element, and its flipped codes are counted.
    gen = torch.Generator().manual_seed(11)
    sizes = [t.numel() for t in tree_leaves(bundle.init(torch.Generator()))]
    offsets = [([torch.rand(n, generator=gen) for n in sizes],
                [[torch.rand(n, generator=gen) for n in sizes]
                 for _ in range(clients)]) for _ in range(2)]
    for algorithm, up, down, lim_max, lim_l2 in [
            ("fedmmd", "identity", "identity", 0.01, 0.01),
            ("fedfusion", "identity", "identity", 0.01, 0.01),
            ("fedfusion", "topk", "identity", 0.01, 0.01),
            ("fedavg", "int8", "int8", 0.02, 0.01)]:
        fl = FLConfig(algorithm=algorithm, fusion_op="conv", uplink_codec=up,
                      downlink_codec=down, topk_frac=TOPK_FRAC, **FIG4)
        s0 = init_global_state(bundle, fl, torch.Generator().manual_seed(7),
                               device="cpu")
        finals, codes = {}, {}
        for dev in ("cuda", "cpu"):
            data = mnist_data(FederatedDataset, class_images,
                              artificial_noniid_partition)
            noise_fn = (lambda r, n, dev=dev: (
                [t.to(dev) for t in offsets[r][0]],
                [[t.to(dev) for t in c] for c in offsets[r][1][:n]]))
            codes[dev] = []
            pack = compress_pack.quant_pack_multi

            def recording_pack(*args, _log=codes[dev], **kw):
                coded = pack(*args, **kw)
                _log.extend(q.cpu() for q, _ in coded)
                return coded

            compress_pack.quant_pack_multi = recording_pack
            try:
                res = run_federated_reference(
                    bundle, fl, data, rounds=2, global_state=s0, device=dev,
                    eval_examples=EVAL_EXAMPLES, noise_fn=noise_fn)
            finally:
                compress_pack.quant_pack_multi = pack
            finals[dev] = (torch.cat([t.cpu().flatten() for t in
                                      tree_leaves(res.global_state)]),
                           res.comm.history[-1])
        start = torch.cat([t.flatten() for t in tree_leaves(s0)])
        diff = finals["cuda"][0] - finals["cpu"][0]
        change = finals["cpu"][0] - start
        ratio_max = diff.abs().max().item() / change.abs().max().item()
        ratio_l2 = (diff.norm() / change.norm()).item()
        flips = sum(int((a.int() - b.int() != 0).sum())
                    for a, b in zip(codes["cuda"], codes["cpu"]))
        emit("card_vs_cpu", algorithm=algorithm, fusion_op="conv",
             uplink=up, downlink=down, rounds=2,
             max_abs_diff=diff.abs().max().item(),
             max_change=change.abs().max().item(), ratio_max=ratio_max,
             ratio_l2=ratio_l2, limit_max=lim_max, limit_l2=lim_l2,
             codes=sum(c.numel() for c in codes["cpu"]), flipped_codes=flips,
             acc={d: finals[d][1]["acc"] for d in finals},
             loss={d: finals[d][1]["loss"] for d in finals})
        if not ratio_max <= lim_max or not ratio_l2 <= lim_l2:
            raise AssertionError(f"{algorithm}/{up}/{down}: card and CPU "
                                 f"disagree (ratios {ratio_max}, "
                                 f"{ratio_l2})")

    # the engine against the reference loop on the card from the same
    # seed: the FedFusion-conv top-k runs 24 rounds (three 8-round chunks:
    # two replays with refilled static inputs, the host store's patch and
    # write-back between chunks; 40 until phase 4j was added), FedAvg and
    # FedMMD 16 (two chunks: one replay refilled; 40 until the
    # mesh families were added: the script's time limit).  cuDNN's default
    # weight-gradient algorithms differ run to run, so both run with its
    # deterministic algorithms; then the graph replays compute what the
    # eager loop computes.  The CommLog history must be equal, and the
    # final model exactly equal (were it not, it would be held to phase
    # 6's 1% of the training change, with the differing op named).  The
    # host EF store must equal the dense one exactly.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    finals = {}
    try:
        for algorithm, mode, up, store in ENGINE_RUNS:
            fl = FLConfig(algorithm=algorithm, fusion_op="conv",
                          uplink_codec=up, topk_frac=TOPK_FRAC, **FIG4)
            R = SHORT_ENGINE_ROUNDS if algorithm == "fedfusion" \
                else 2 * ENGINE_CHUNK
            out = {}
            for name, fn, kw in [
                    ("reference", run_federated_reference, {}),
                    ("engine", run_federated,
                     dict(superstep_rounds=ENGINE_CHUNK, ef_store=store))]:
                out[name] = fn(bundle, fl, mnist_data(
                    FederatedDataset, class_images,
                    artificial_noniid_partition), rounds=R,
                    seed=0, mode=mode, eval_examples=EVAL_EXAMPLES, **kw)
            replays = sum(g["replays"] for g in
                          out["engine"].stats["graphs"])
            eng, ref = (torch.cat([t.flatten() for t in
                                   tree_leaves(out[k].global_state)]).cpu()
                        for k in ("engine", "reference"))
            s0 = init_global_state(bundle, fl,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
            change = ref - torch.cat([t.flatten() for t in tree_leaves(s0)])
            diff = eng - ref
            exact = torch.equal(eng, ref)
            hist_equal = out["engine"].comm.history == \
                out["reference"].comm.history
            ratio_max = diff.abs().max().item() / change.abs().max().item()
            ratio_l2 = (diff.norm() / change.norm()).item()
            finals[(algorithm, up, store)] = eng
            ok = hist_equal and replays == R // ENGINE_CHUNK \
                and (exact or (ratio_max <= 0.01 and ratio_l2 <= 0.01))
            emit("engine_vs_reference", algorithm=algorithm, mode=mode,
                 uplink=up, ef_store=store, rounds=R,
                 replays=replays,
                 cudnn_deterministic=True, exact=exact,
                 history_equal=hist_equal,
                 max_abs_diff=diff.abs().max().item(),
                 max_change=change.abs().max().item(), ratio_max=ratio_max,
                 ratio_l2=ratio_l2, limit=0.01, ok=ok)
            if not ok:
                raise AssertionError(f"engine {algorithm}/{up}/{store} "
                                     "disagrees with the reference loop")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(finals[("fedfusion", "topk", "host")],
                       finals[("fedfusion", "topk", "device")])
    emit("engine_vs_reference", compare="host EF store vs dense",
         exact=same)
    if not same:
        raise AssertionError("the host EF store differs from the dense one")

    # the slice-12 paths, card against CPU, with cuDNN's deterministic
    # algorithms (TF32 stays off) as the engine runs above.  (a) fig. 6's
    # probe (FedFusion-conv) from the trained state of phase 4d.  Run free
    # for 3 epochs (36 steps of 32 at lr 0.06) it is ill-conditioned: a
    # float32 rounding difference can grow to percent level, and two
    # correct CPU convolutions (oneDNN's, PyTorch's own) part as far as
    # the card does, so its distance (``free_ratios_by_epoch``) is
    # printed, not held.  What is held to the phase's 1%: from the CPU
    # probe's state at each epoch start, one round's local training of
    # fig. 6 (4 steps of 32) on the card against the same on the CPU,
    # relative to the change those steps make; too short for rounding to
    # compound, while a wrong gradient or term differs by its own size
    fl, state, newcomer = fig6_states["conv"]
    state = tree_map(lambda t: t.cpu(), state)
    algo = make_algorithm(fl.algorithm)
    trainer = make_local_trainer(bundle, fl)
    steps, batch = FIG6["local_steps"], FIG6["local_batch"]

    def flat(st):
        return torch.cat([t.cpu().flatten() for t in tree_leaves(
            {k: st[k] for k in ("model",) + algo.extra_state})])

    def ratios(got, want, start):
        diff, change = got - want, want - start
        return (diff.abs().max().item() / change.abs().max().item(),
                (diff.norm() / change.norm()).item())

    cudnn_exact = dict(enabled=True, deterministic=True, allow_tf32=False)
    with torch.backends.cudnn.flags(**cudnn_exact):
        free = {dev: list(newclient.newclient_epochs(
            bundle, fl, tree_map(lambda t: t.to(dev), state), newcomer,
            epochs=3, batch=batch, lr=FIG6["lr"])) for dev in ("cuda", "cpu")}
        segments = []
        for start in [state] + [st for st, _ in free["cpu"][:-1]]:
            out = {}
            for dev in ("cuda", "cpu"):
                st = tree_map(lambda t: t.to(dev), start)
                trained, _ = trainer(
                    st["model"], algo.extra_from_state(st),
                    {k: torch.from_numpy(v[:steps * batch].reshape(
                        steps, batch, *v.shape[1:])).to(dev)
                     for k, v in newcomer.items()},
                    torch.tensor(FIG6["lr"], device=dev))
                out[dev] = flat(trained)
            segments.append(ratios(out["cuda"], out["cpu"], flat(start)))
        # the first held segment in float64 on the CPU beside both float32
        # paths: where their ReLU / max-pool masks part (ROADMAP Queue 3)
        masks = probe_masks(torch, trainer, algo, state, newcomer,
                            steps=steps, batch=batch, lr=FIG6["lr"],
                            tree_map=tree_map)
    emit("probe_masks", path="newclient_probe", segment=0,
         segment_ratios=segments[0], **masks)
    emit("card_vs_cpu", path="newclient_probe", algorithm="fedfusion",
         fusion_op="conv", epochs=3, segment_steps=steps,
         cudnn_deterministic=True, segment_ratios_by_epoch=segments,
         limit_max=0.01, limit_l2=0.01,
         free_ratios_by_epoch=[ratios(flat(g), flat(w), flat(state))
                               for (g, _), (w, _) in zip(free["cuda"],
                                                         free["cpu"])],
         acc={d: [a for _, a in free[d]] for d in free})
    if not max(max(r) for r in segments) <= 0.01:
        raise AssertionError(f"newclient probe: card and CPU disagree "
                             f"(segment ratios {segments})")

    # (b) the mask codec's indices at CNN_MNIST's leaves: the seeded
    # expansion is integer arithmetic, so the card's equal the CPU's bit
    # for bit; (c) lowrank's decode of one delta with the same seeds,
    # within 1e-5 of the decode's scale
    gen = torch.Generator().manual_seed(12)
    model_cpu = bundle.init(gen)
    delta = tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=gen),
                     model_cpu)
    seeds = [(u.reshape(1) * 2.0 ** 31).to(torch.int32)
             for u in torch.rand(4, generator=gen)]
    mask = {d: SketchCodec(TOPK_FRAC).bind(tree_map(lambda t: t.to(d),
                                                    model_cpu))
            for d in ("cuda", "cpu")}
    n_leaves_ = len(tree_leaves(model_cpu))
    equal = [torch.equal(mask["cuda"]._expand(s.cuda(), i).cpu(),
                         mask["cpu"]._expand(s, i))
             for s in seeds for i in range(n_leaves_)]
    noise = [torch.rand(1, generator=gen) for _ in range(n_leaves_)]
    decoded = {}
    for d in ("cuda", "cpu"):
        low = SketchCodec(TOPK_FRAC, mode="lowrank").bind(
            tree_map(lambda t: t.to(d), model_cpu))
        payload, _ = low.encode(tree_map(lambda t: t.to(d), delta),
                                noise=[u.to(d) for u in noise])
        decoded[d] = torch.cat([t.cpu().flatten() for t in
                                tree_leaves(low.decode(payload))])
    low_err = (decoded["cuda"] - decoded["cpu"]).abs().max().item()
    low_scale = decoded["cpu"].abs().max().item()
    emit("card_vs_cpu", path="sketch", mask_index_sets=len(equal),
         mask_equal=sum(equal), lowrank_max_abs_diff=low_err,
         lowrank_scale=low_scale, lowrank_limit=1e-5 * low_scale)
    if not all(equal) or not low_err <= 1e-5 * low_scale:
        raise AssertionError("sketch codecs: card and CPU disagree")

    # (d) the deadline run (FedFusion-conv, top-k uplink, fig. 8's chaos,
    # cohort 15), 2 rounds on the engine, card against CPU, from one state,
    # with cuDNN's deterministic algorithms as above.  Top-k
    # selects from continuous values: where the two sides' deltas order
    # two entries at the k-th magnitude differently, the entry moves
    # between the update and the EF residual, a step of the threshold's
    # size.  Held to the phase's 1%, in L2 and for the largest element
    fl = FLConfig(algorithm="fedfusion", fusion_op="conv",
                  uplink_codec="topk", topk_frac=TOPK_FRAC,
                  participation="deadline", over_provision=1.5, **FIG4)
    s0 = init_global_state(bundle, fl, torch.Generator().manual_seed(7),
                           device="cpu")
    finals = {}
    with torch.backends.cudnn.flags(**cudnn_exact):
        for dev in ("cuda", "cpu"):
            res = run_federated(
                bundle, fl, mnist_data(FederatedDataset, class_images,
                                       artificial_noniid_partition,
                                       chaos=ChaosConfig(**FIG8_CHAOS)),
                rounds=2, seed=0, global_state=s0, device=dev,
                eval_examples=EVAL_EXAMPLES, superstep_rounds=2)
            finals[dev] = (torch.cat([t.cpu().flatten() for t in
                                      tree_leaves(res.global_state)]),
                           res.comm.history)
    start = torch.cat([t.flatten() for t in tree_leaves(s0)])
    diff = finals["cuda"][0] - finals["cpu"][0]
    change = finals["cpu"][0] - start
    ratio_max = diff.abs().max().item() / change.abs().max().item()
    ratio_l2 = (diff.norm() / change.norm()).item()
    same_schedule = [(h["sim_time"], h["arrived"], h["bytes_up"])
                     for h in finals["cuda"][1]] == \
        [(h["sim_time"], h["arrived"], h["bytes_up"])
         for h in finals["cpu"][1]]
    emit("card_vs_cpu", path="engine_deadline", algorithm="fedfusion",
         fusion_op="conv", uplink="topk", policy="deadline", rounds=2,
         cudnn_deterministic=True,
         max_abs_diff=diff.abs().max().item(),
         max_change=change.abs().max().item(), ratio_max=ratio_max,
         ratio_l2=ratio_l2, limit_max=0.01, limit_l2=0.01,
         same_schedule=same_schedule)
    if not (ratio_max <= 0.01 and ratio_l2 <= 0.01 and same_schedule):
        raise AssertionError(f"deadline run: card and CPU disagree "
                             f"(ratios {ratio_max}, {ratio_l2}, schedule "
                             f"{same_schedule})")

    # (e) the adaptive controllers, card against CPU: ef_ratio on the top-k
    # ladder (band (0.2, 0.5) and EMA 0.5, so that its level moves within
    # the run) and bytes_budget on the int8 ladder (0.75 of capacity), 4
    # engine rounds in 2-round chunks from one state, under cuDNN's
    # deterministic algorithms; the int8 run takes offsets drawn on the
    # CPU, the same numbers on both sides.  The level schedules must be
    # equal and every round's loss within 1% of the CPU's (a quant code
    # that rounds the other way on the two sides moves a weight by a whole
    # level-0 step, so the distance grows round by round: 0.76% after 6
    # rounds on an H100)
    def shared_offsets(dev):
        def noise_fn(r, n_clients):
            gen = torch.Generator().manual_seed(4321 + r)
            return None, [[torch.rand(m, generator=gen).to(dev)
                           for m in mnist_sizes] for _ in range(n_clients)]
        return noise_fn

    for name, up, knobs in [("ef_ratio", "topk",
                             dict(ctrl_band=(0.2, 0.5), ctrl_ema=0.5)),
                            ("bytes_budget", "int8",
                             dict(ctrl_budget_frac=0.75))]:
        fl = FLConfig(algorithm="fedavg", uplink_codec=up,
                      topk_frac=TOPK_FRAC, controller=name, **knobs, **FIG4)
        s0 = init_global_state(bundle, fl, torch.Generator().manual_seed(11),
                               device="cpu")
        hists = {}
        with torch.backends.cudnn.flags(**cudnn_exact):
            for dev in ("cuda", "cpu"):
                hists[dev] = run_federated(
                    bundle, fl, mnist_data(FederatedDataset, class_images,
                                           artificial_noniid_partition),
                    rounds=4, seed=0, global_state=s0, device=dev,
                    eval_examples=EVAL_EXAMPLES, superstep_rounds=2,
                    noise_fn=shared_offsets(dev) if up == "int8" else None
                ).comm.history
        levels = {d: [h["level"] for h in hists[d]] for d in hists}
        rel = [abs(a["local_loss"] - b["local_loss"]) / abs(b["local_loss"])
               for a, b in zip(hists["cuda"], hists["cpu"])]
        same = levels["cuda"] == levels["cpu"] and [
            h["bytes_up"] for h in hists["cuda"]] == [
            h["bytes_up"] for h in hists["cpu"]]
        emit("card_vs_cpu", path="controller", controller=name, uplink=up,
             **knobs, rounds=4, superstep_rounds=2, cudnn_deterministic=True,
             levels=levels["cuda"], cpu_levels=levels["cpu"],
             same_schedule=same, max_rel_loss_diff=max(rel), limit=0.01,
             signals={d: [h.get("tele/ef_delta_ratio", h["local_loss"])
                          for h in hists[d]] for d in hists})
        if not (same and max(rel) <= 0.01):
            raise AssertionError(f"controller {name}: card and CPU disagree "
                                 f"(levels {levels}, losses {max(rel)})")

    serve_card_vs_cpu(torch, serve, tfm, get_config, tree_map, moe)
    train_card_vs_cpu(torch, train, get_config, FLConfig, InputShape,
                      make_bundle, init_global_state, tree_leaves, moe)
    # the head dims 80 and 120 at 2 layers, full width; granite-moe-1b
    # (32 experts, top 8) at 2 layers, full width, one FedAvg round;
    # (their rounds at 1 layer since the recurrent families were added:
    # the script's time limit); mamba2-130m at 2 SSD layers, full width;
    # recurrentgemma-9b at full width cut to one cycle (RG-LRU, RG-LRU,
    # local attention) and its 256,000-token vocabulary to RG_CPU_VOCAB
    # (the CPU's head over the whole vocabulary would take most of this
    # phase), a 256-token prompt, S = 16 and one sequence (one client of
    # its client_sequential mode)
    for name in ("stablelm-3b", "h2o-danube-3-4b", "granite-moe-1b-a400m",
                 "mamba2-130m"):
        serve_card_vs_cpu(torch, serve, tfm, get_config, tree_map, moe,
                          name, layers=2)
        train_card_vs_cpu(torch, train, get_config, FLConfig, InputShape,
                          make_bundle, init_global_state, tree_leaves, moe,
                          name, algorithm="fedavg",
                          layers=2 if name == "mamba2-130m" else 1)
    serve_card_vs_cpu(torch, serve, tfm, get_config, tree_map, moe,
                      "recurrentgemma-9b", layers=3, prompt_len=256,
                      vocab_size=RG_CPU_VOCAB)
    train_card_vs_cpu(torch, train, get_config, FLConfig, InputShape,
                      make_bundle, init_global_state, tree_leaves, moe,
                      "recurrentgemma-9b", algorithm="fedavg", layers=3,
                      seq_len=16, batch=1, vocab_size=RG_CPU_VOCAB)
    # whisper-large-v3 at full width cut to 2 decoder and 2 encoder layers
    # over its 1,500 frames, a 64-token prompt, and its FedAvg round at 1 +
    # 1 layers, S = 16; qwen2-vl-7b at 2 layers, full width, its
    # vocabulary cut to RG_CPU_VOCAB, a 300-position prompt (256 patch
    # embeddings), and its FedAvg round at 1 layer, S = 32 with 16 patch
    # embeddings (the CPU's round at 256 would take most of this phase)
    serve_card_vs_cpu(torch, serve, tfm, get_config, tree_map, moe,
                      "whisper-large-v3", layers=2, prompt_len=64,
                      n_enc_layers=2)
    train_card_vs_cpu(torch, train, get_config, FLConfig, InputShape,
                      make_bundle, init_global_state, tree_leaves, moe,
                      "whisper-large-v3", algorithm="fedavg", layers=1,
                      seq_len=16, batch=1, n_enc_layers=1)
    serve_card_vs_cpu(torch, serve, tfm, get_config, tree_map, moe,
                      "qwen2-vl-7b", layers=2, prompt_len=300,
                      vocab_size=RG_CPU_VOCAB)
    train_card_vs_cpu(torch, train, get_config, FLConfig, InputShape,
                      make_bundle, init_global_state, tree_leaves, moe,
                      "qwen2-vl-7b", algorithm="fedavg", layers=1,
                      seq_len=32, batch=1, vocab_size=RG_CPU_VOCAB,
                      n_vision_tokens=16)
    # examples/serve_decode_torch.py at temperature 0.7
    twin_card_vs_cpu(torch, tfm, get_config, tree_map)

    # the LM engine: card vs CPU, and its replays against the reference loop
    lm_engine_card_checks(torch, run_federated, run_federated_reference,
                          get_config, FLConfig, make_bundle,
                          init_global_state, FederatedDataset, token_stream,
                          source_partition, tree_leaves)
    emit("phase_6", seconds=time.perf_counter() - t_phase)

    # 7. kernel table: launches summed over the main paths' measured runs
    # (the CNN FL runs of phase 4, serving, LM training) --------------------
    emit("kernels_to_port", kernels=[])
    launches.update(serve_launches)
    for k, n in train_launches.items():
        launches[k] = launches.get(k, 0) + n
    order = (*counters, "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "flash_decode")
    table = [dict(rows[k], launches=launches[k]) for k in order]
    table = [{k: r[k] for k in ("name", "route", "source", "replaces",
                                "launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}
             for r in table]
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--analysis-worker"]:
        analysis_cpu_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--analysis-sync-worker"]:
        analysis_sync_worker(sys.argv[2:])
    else:
        main()
