#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # one CUDA device; builds the kernels
    python3 chip_smoke.py --b7-times TREE   # B7 of another checkout, timed
    python3 chip_smoke.py --phase recurrent # device, build, recurrent only
    python3 chip_smoke.py --phase moe       # device, build, moe only
    python3 chip_smoke.py --phase vlm_audio # device, build, vlm_audio only
    python3 chip_smoke.py --phase autotune  # device, build, autotune only
    python3 chip_smoke.py --phase dist      # device, build, dist only
    python3 chip_smoke.py --phase tp        # device, build, tp only
    python3 chip_smoke.py --phase pod       # device, build, pod only
    python3 chip_smoke.py --phase shard     # device, build, shard only
    python3 chip_smoke.py --phase sr_kernels  # the index-base cases only

Phases (any failure exits non-zero before the result line):
  1. device   — require CUDA, print the card and its power limit, turn
                TF32 off for matmuls and convolutions;
  2. build    — compile every kernel source (four libraries) with nvcc,
                one process per source, started together, and print each
                kernel's registers, spill bytes and stack (a whole run
                waits for the flash library, the slowest, only after
                the bwd and autotune phases);
  3. bwd      — B1, B2 (dgrad) and B3 (wgrad) against their plain
                versions at gemma2-2b's training shapes (M = 4096 tokens),
                timed with CUDA events beside torch.matmul and, on the
                int8 route, torch._int_mm of the same int8 mantissas
                (yardsticks only), the same shapes again under stochastic
                rounding (train-sr's configuration, routes checked), a
                few small cases (m 8/12, stochastic,
                block 32, narrowed weights), the route cases (M 1, 8, 100,
                4096 on both tensor-core routes, m 4, bk 1024 and 2048
                with near-full mantissas whose int32 sums pass 2^24, f32
                raw weights on the CUDA cores), each launch's route
                checked (B3: bf16 wgmma at m <= 8, block 32 and K 64
                with split M-blocks included, the CUDA cores at m 12 and
                M below one 64-token stage), and the adaptive path's
                weights narrowed at 8 bits in 24 x 24 tiles; the device
                time of one B1, B2 and B3 call by kernel (passes vs GEMM);
                ROADMAP slice 19's index bases: B1, B2 and B3 on every
                route (B3 on its two) at gemma2-2b's wq (M 4096) with
                each operand a part of a larger one-process operand (a
                data shard's rows, a column or row block, rows 2^20
                down so the indices pass 2^31), stochastic, bit for bit
                against the plain version with the same base and the
                plain version of the whole operands, sliced (B3: its
                dequantized operands; dw within its bound), routes
                checked; the seven projections timed stochastic without
                and with a base, in turns;
  3b. autotune — ROADMAP A6, on a temp table (REPRO_AUTOTUNE_TABLE, put
                back after; nothing under results/): gemma2-2b at full
                width, 2 of 26 layers, 2 x 2048 tokens, trained from one
                init (warm-up + 3 steps) on the empty table, its call
                sites' keys read from resolve_spec; B1, B2 and B3 at its
                wq (4096 x 2304 x 2048) and ffn_wo (4096 x 9216 x 2304)
                tuned over the reference's whole menu (32-256 per tile
                edge, 64 candidates an op) through kernels/ops.py, every
                candidate first held to its plain version on the card
                (B1/B2 bit-equal, B3 within its bound) on the route its
                tiles give, one JSON line an op (default and winner
                tiles, times, routes, speedup); B1 tuned at yi-9b's decode
                wq (M = 8 lanes, served bf16 weights); the same training
                on the tuned table (the sites resolve the winners, the
                rest the defaults; launch counts equal the untuned run's;
                every launch on its tiles' route; step-0 loss within 2% of
                fp32), both runs' step times; yi-9b at full width, 2 of 48
                layers, served graphed against eager on the table for 8
                lockstep ticks, bit for bit, the replay's B1 launches on
                their tiles' routes;
  4. flash    — B4 (forward, with and without lse), B5 (dq) and B6 (dk,
                dv) against their plain versions at yi-9b's training
                attention (B·H 32, S 4096, hd 128, bf16, m 8, causal),
                timed, beside SDPA as a yardstick, with each kernel's
                device time by kernel (pre-pass vs main) and its softmax
                bound, and small cases (m 12, m_qk != m_pv, non-causal in
                bf16 and f32, hd 64 with 64-blocks, hd 96 at m 4, S 96 and
                32-blocks in f32), each B4, B5 and B6 launch's route
                checked (yi-9b's must be int8 wgmma);
  5. quantize — B7 against its plain version, bit for bit in all five
                outputs, at yi-9b's tapped and packed shapes (m 8/16 at
                tile 128, m 4 at tile 24, and its bf16 gradients at m 8,
                tile 24), the whole-matrix tile, a bf16
                activation row tap, stochastic rounding, small cases and
                edge cases (exponent clamp, subnormals, zero and padded
                tiles, m 2/16, an unaligned x); each launch's route
                checked against the route table (yi-9b's shapes banded,
                whole-matrix tiles split); timed beside a clone() of x,
                with each case's time over its bound; with an index base
                (a shard's rows, its columns, rows 2^20 down) on banded
                and, one element off alignment, split: bit for bit
                against the plain version with the base and the whole
                operand's, sliced; the five t24 shapes timed stochastic
                without and with a base;
  6. train    — one gemma2 and one yi-9b smoke training step on the card
                agree with the same step on the CPU (yi-9b through flash),
                and so does a stochastic gemma2 step from one key (both
                devices draw the xorshift stream); the closed
                adaptive-precision loop on yi-9b smoke makes the CPU's
                decisions;
  7. train-full — gemma2-2b (8 of 26 layers) and yi-9b (8 of 48 layers) at
                full width trained by the port's Trainer (a warm-up step,
                then 3 steps): finite losses, step-0 loss within 2% of
                fp32, exact launch counts of B1-B6, every B1/B2 and
                B4-B6 launch on the int8 wgmma route and every B3 launch
                on bf16 wgmma, step time, tokens/s, peak memory, and a
                profile of one step;
  7b. train-sr — ROADMAP A5: gemma2-2b (8 of 26 layers, full width) trained as
                train-full does under "8~stochastic; backend=pallas" on
                HBFPConfig(8, 16, tile=24), beside train-full's nearest
                gemma2-2b run, its profiled step making no more host
                scalar copies (_local_scalar_dense) than the nearest one;
                then, at 2 layers: remat on and off bit-equal in loss and
                grads, a stochastic telemetry step bit-equal to the plain
                step (B7's launches exact, banded), and 6 steps
                uninterrupted bit-equal to a run preempted at 3 and
                resumed from its step-2 checkpoint (needs ~18 GB of free
                disk under build/);
  8. adaptive-full — yi-9b at full width (2 of 48 layers) under the
                controller: 8 steps uninterrupted, and 8 steps preempted
                at 6 and resumed from the step-4 checkpoint, which must
                agree bit for bit; exact B7 launches per telemetry step,
                all on the banded route (split for whole-matrix tiles);
                one telemetry and one plain step profiled, B7's device
                time by kernel against the kernels the telemetry adds;
                B1/B2 on int8 wgmma before the first widen and on bf16
                wgmma after it, never on the CUDA cores; B3 on bf16 and
                B4-B6 on int8 wgmma on every step;
                a packed save of the master that loads back bit for bit,
                its B7 launches banded (needs ~25 GB of free disk under
                build/);
   8b. accuracy — the paper's claim, loss against fp32 (ROADMAP A8): the
                13 rows of benchmarks/design_space.py's grid at yi-9b
                smoke, 40 steps from the port's init and data, on the card
                and on the CPU (three processes of two threads at the
                lowest CPU priority, started after the build), each
                row's tail loss (mean of the last 5) and delta against
                fp32 within the CPU test's tolerance (0.01 at fp32 and
                m 8, 0.06 at m 4), with the step at which each row's
                card and CPU losses part and the spread of their
                per-step gaps; then minicpm-2b (8 of 40 layers) and
                phi3-mini (4 of 32 layers) at full width, 40 steps of
                1 x 4096 markov tokens at LR 3e-4 on each family's
                schedule under fp32, "8; backend=pallas", HBFPConfig(8,
                16, tile=24) and HBFPConfig(4, 16, tile=24) on pallas:
                loss curves, deltas, step times and peaks, fp32 falling,
                HBFP8 tile 24's delta within max(0.1, 3 x its smoke delta
                on the card) and no larger than HBFP4 tile 24's plus
                0.06 (the m 4 tolerance), exact B1-B6 launches,
                B1/B2/B4-B6 on int8 wgmma and B3 on bf16 wgmma;
 9. kernels  — B1 against its plain PyTorch version on the card at the
                yi-9b serving shapes;
 10. model    — the yi-9b smoke model served on the card (kernel path)
                agrees with the same model on the CPU (plain path);
 11. serve    — yi-9b at full width, 4 of 48 layers (random seeded
                bf16 weights), served by the port's ServeEngine: 12
                overloading requests, paged and slab, each with the
                generate tick captured as a CUDA graph (the default) and
                eager (cuda_graph=False): equal tokens,
                every tick after the first a replay, B1's launches per
                replay recorded at capture (7L+1, bf16 wgmma) and matched
                by the profiler on one replayed tick, one serve/step span
                a tick; tick wall and device ms, idle share, decode
                tokens/s, TTFT p50/p95 and peak memory of each; graphed
                and eager stepped in lockstep (every tick's logits and the
                KV cache bit for bit); a top-k/top-p sampled trace under
                the graph, each request solo == crowded; one async
                chunked-prefill request; the run-log through the port's
                JSONLSink into chiprun_out/serve_run.jsonl;
 11b. recurrent — ROADMAP A12.1-2: hymba-1.5b (attention and a mamba
                branch in parallel, sliding-window ring) and xlstm-350m
                (mLSTM and sLSTM): (a) each smoke model's training step
                and served trace (hymba paged and slab, xlstm slab) on
                the card against the CPU; B1-B3 against their plain
                versions at the shapes only these paths give them
                (hymba's padded K 1664 and N 6528, xLSTM's N = 8 gate
                projection, whose B2 takes the CUDA cores); (b) hymba
                at full width, 4 of 32 layers, 1 x 4096 tokens, and
                (c) xlstm (4 of 24 layers, 1 x 2048) trained as train-full
                does: exact B1-B3 launches (9 projections a hybrid
                layer, 4 an mLSTM and 2 an sLSTM layer, and the head),
                B1/B2 on int8 wgmma (but xLSTM's gate dgrads), B3 on
                bf16 wgmma; hymba's profiled step split into B1-B3, the
                chunk scan, the sim attention and the rest, xlstm's
                sLSTM loops timed over the counted steps; (d) both served
                at full width (8 lanes, ctx_len 2048, 8 requests, one
                of 1,500 tokens: hymba's chunked prefill through its
                1,024-slot ring), hymba paged and slab, xlstm slab,
                graphed and eager, then in lockstep: tokens, logits, KV
                and recurrent states bit for bit; the run-log in
                chiprun_out/recurrent_serve_run.jsonl;
 11c. moe     — ROADMAP A12.3: llama4-scout-17b-a16e (16 experts, top-1,
                a shared expert) and arctic-480b (128 experts, top-2, a
                dense residual): (a) each smoke model's training step and
                served trace (paged and slab) on the card against the
                CPU; (b) B1 at both archs' served shapes (M = 8, bf16
                wgmma) and B1-B3 at llama4's training shapes (M = 2048,
                the 202,048-word head padded to 202,112) against their
                plain versions, routes checked; (c) llama4 at full width,
                1 of 48 layers, 1 x 2048 tokens, trained as train-full
                does: exact B1-B6 launches (7 projections a layer: the
                3-D expert GEMMs take the sim path, as in the
                reference), no B7 launch, the aux loss per layer within
                (0.5, 2.5), the profiled step split into the expert
                GEMMs, the rest of the MoE layer, the optimizer, the
                narrowing, B1-B6 and the rest; (d) llama4 at 3 of 48
                layers, paged and slab, and (e) arctic at 1 of 35, slab,
                served at full width from one narrowed copy (8 lanes,
                ctx_len 1024, 8 requests of 32-512 tokens, 16 new), each
                graphed and eager, then in lockstep: tokens, logits and
                KV bit for bit, 7L + 1 B1 launches a replay; the run-log
                in chiprun_out/moe_serve_run.jsonl;
 11d. vlm_audio — ROADMAP A12.4-5: qwen2-vl-72b (M-RoPE, embeddings
                input) and musicgen-large (embeddings input, four codebook
                heads): (a) each smoke model's training step (qwen2-vl
                also with an image-grid span, off flash) and the
                serve-step stages (a prefill and 4 decode steps) on the
                card against the CPU; (b) B1 at both archs' served shapes
                (M = 8, bf16 wgmma) and B1-B3 at their training shapes (M
                = 4096 and 3072, qwen2-vl's 152,064-word head included)
                against their plain versions, routes checked; (c)
                qwen2-vl at full width, 3 of 80 layers, 1 x 4096, and (d)
                musicgen at 12 of 48 layers, 2 x 1536 frames, trained as
                train-full does: exact B1-B6 launches (K heads: B1
                2·(P + K·C), or 2P + K in one CE chunk), step-0 loss
                within 2% of fp32, the profiled step split by region; (e)
                both served through the serve-step stages (qwen2-vl at 8
                of 80 layers, musicgen at 12): a prefill of 8 x 512
                seeded frames into a 1,024-slot slab, 32 decode ticks on
                seeded next-frame embeddings, graphed (`GraphedStage`
                over fixed input buffers) and eager from a clone of the
                prefill cache: every tick's logits and the cache bit for
                bit, 7L + K B1 launches a replay (bf16 wgmma), matched by
                the profiler;
 11e. dist    — ROADMAP A13, data-parallel training with ZeRO-1 on two
                ranks of the one card (gloo, by placement: NCCL refuses
                two ranks on one device): (a) B7 against its plain
                version, bit for bit in all five outputs, at the (1, 512)
                tiling of every gradient leaf of gemma2-2b at 2 layers
                (the 256,000 x 2,304 embedding's the largest), routes
                checked, timed; (b) one process's gradients (gemma2-2b
                at full width, 2 of 26 layers, 2 x 2048 markov tokens)
                through the compressed reduce on a one-rank NCCL group
                (B7 on every leaf; N = 1 returns each leaf's dequantized
                packing); (c) two ranks (processes of this script,
                `--dist-rank`, the libraries built here first; every
                later gloo world starts up during the phase before its
                own and waits for its go, `_spawn_ranks`) train it
                on 1 x 2048 tokens each through `make_step(...,
                mesh=make_host_mesh())` and the Trainer, a warm-up step
                and 3 counted: exact B1-B3 launches a rank on their
                training routes, step times, peaks, bytes and host
                seconds a step by collective kind, the collectives
                staged through host memory; `compressed_psum_tree` on
                each rank's gradients of a fifth batch: B7's launches
                and routes, wire bytes int8 against f32, the error
                against the plain mean (<= 0.02), residual +
                decompress(packed) == g exactly; (d) the master gathered
                to rank 0, which then takes the same 4 steps alone on
                the full batch (the other rank waiting): losses and
                updates within tests/test_torch_dp_train.py's bf16
                tolerance; (e) at gemma2-2b smoke width, a run
                preempted at step 3 and resumed from its step-2
                checkpoint bit for bit against the uninterrupted run,
                its step-4 checkpoint (written whole on rank 0) loaded
                in one process (a full-width one is ~18 GB, and one call
                of the card's tool may write 45 GiB, ~37 of them the
                earlier phases' checkpoints);
 11f. tp      — ROADMAP A13's second half, tensor, sequence and expert
                parallelism on {data 1, model 2}: two ranks of the one
                card (gloo; processes of this script, `--tp-rank`) under
                `make_step(..., mesh=make_host_mesh(model=2),
                seq_parallel=)` and the Trainer, "8; backend=pallas",
                seeded weights, a warm-up step and 3 counted: (a)
                gemma2-2b at full width, 2 of 26 layers, 2 x 2048
                tokens, sequence parallelism off and on; (b) yi-9b at
                full width, 2 of 48 layers, 1 x 4096 tokens (B4-B6 on 16
                query and 2 kv heads a rank, a 32,000-column head a
                rank); (c) llama4-scout's .smoke() under expert
                parallelism (one full-width layer needs ~72 GiB in one
                process, more than two ranks can share on one card):
                exact B1-B3 launches a rank on their training routes,
                step times, peaks, bytes and host seconds a step by
                collective kind on each axis, the staged count, the
                ranks' losses and replicated leaves bit-identical; each
                rank first takes the configuration in one process on the
                full batch (both at once), keeps its model part of the
                master on the host and holds the mesh run to it: losses
                and updates within the dist phase's bf16 tolerance; (d) B1-B3 with the row-amax input at
                gemma2-2b's row-parallel shapes a rank (ffn_wo K 4,608,
                attn_wo K 1,024, M 4,096) and at the head's dgrad
                (128,000 columns a rank), at the default tiles (each
                group's own amax: nothing changes) and at one group a
                row on the global amax of a two-rank split, bit for bit
                against their plain versions (B3's dw within its bound),
                timed, and B1/B2 on all three routes (128-tiles, a group
                amax above the groups' own) and B3 on both of its (one
                group a row); (e) the 11g run with SP on;
 11g. sr mesh — ROADMAP slice 19, stochastic rounding under a mesh:
                gemma2-2b at full width, 2 x 2048 tokens, SR_SPEC, the
                Trainer's keys, a warm-up step (step 1) and 3 counted, on
                {data 2} (2 of 26 layers, the dist phase's ranks), on
                {data 1, model 2} with SP (2 layers, the tp phase's
                ranks) and, phase pod, on four gloo ranks of the card
                (`--pod-rank`) on {pod 2, data 1, model 2} (2 layers, 1 x
                2048 tokens a data rank, a telemetry step every 2, so B7
                narrows each shard with its base): step 1's narrow copy
                and every B1-B3 operand printed on each rank (two 64-bit
                sums of its bits, one position-weighted), then rank 0
                takes the same steps alone on the full batch (the others
                waiting, the card freed) and holds them to its own: the
                narrow copy at each rank's model part and each operand
                whose input is one process's part (up to the data size's
                power of two) bit-identical (every weight operand must
                match), losses within 2e-3 and updates within 0.25 of
                one process; the ranks' losses alike; B1-B3 launches a
                rank equal one process's at its tokens, on their
                training routes; bytes and seconds a step by collective
                kind on each axis;
 11h. shard  — ROADMAP slice 20, sharded prefill and decode on the
                reference's serving layouts (`train.serve_step.
                ServeLayout`), yi-9b at full width, "8;
                backend=pallas", gloo ranks of the card
                (`--shard-rank`): (a) {data 2, model 2}, four ranks, 2
                of 48 layers:
                8 prompts x 512 tokens (4 a data rank) prefilled through
                B4 on each rank's 16 query and 2 kv heads, then 16
                greedy ticks on a slab ring of 1,024, every rank first
                taking the same in one process (all at once) and the
                mesh fed its greedy tokens: layer 0's q, k, v and every
                local head's flash output bit-equal to one process's
                slice, logits within SHARD_TOL, greedy tokens equal
                wherever one process's top-2 margin exceeds it, B1
                launches a rank per prefill and per tick (7L + 1, all
                bf16 wgmma) and B4's (L, int8 wgmma); (b) the dry run's
                decode_32k cell at 1 of 48 layers on {data 1, model 8},
                eight ranks: batch 128, a ring of 32,768 slots, 4,096 a
                rank (the kv heads do not divide 8, so the attention is
                replicated and row-parallel over the ring), 128 prompts
                x 64 tokens (B4 on the CUDA cores: 64-token prompts are
                no whole 128-row CTA), 8 ticks, rank 0 first alone in
                one process (the others waiting): every rank's cache
                part printed
                and equal to one process's slice, logits within
                SHARD_TOL; `launch.dryrun.build_cell` on a fake group
                of 8 at the same mesh and depth gives argument bytes
                equal to rank 0's real params + cache + batch, its
                memory track's total beside rank 0's real peak; (c) the
                dry run's train_4k, prefill_32k and decode_32k cells of
                yi-9b at the production mesh on the card's host (a
                process of this script, `--shard-dry`, started at the
                beginning and run beside the other phases), with their
                trace_s;
 12. report   — the `kernels` JSON line (B1-B7), the card line, and the
                last line {"ok": true, "device": {...}}.

Per-case kernel numbers and the training results also go to
chiprun_out/chip_smoke.json.

`--b7-times TREE` runs only B7, as the checkout at TREE builds it (its own
sources into its own build/), at phase 5's timed cases: each call held
bit for bit against that tree's plain version, then timed in the launch
loop and on the device alone (a CUDA-graph replay), one JSON line a case.
Run on two checkouts in turns in one call (parent, change, change,
parent) it compares them on one card.

"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

SERVE_SHAPES = {            # weight: (K, N) at yi-9b full width
    "wq": (4096, 4096), "wk": (4096, 512), "wv": (4096, 512),
    "wo": (4096, 4096), "ffn_wg": (4096, 11008), "ffn_wi": (4096, 11008),
    "ffn_wo": (11008, 4096), "head": (4096, 64000),
}
KERNEL_MS = (1, 8, 256)
# (name, quantize_w, mantissa_bits, block, stochastic)
CONFIGS = (("served", False, 8, 0, False),
           ("qw_m8", True, 8, 0, False),
           ("qw_m12", True, 12, 0, False),
           ("qw_m8_b32", True, 8, 32, False),
           ("qw_m8_stoch", True, 8, 0, True))
# block > 0 sums dequantized operands whose exponents vary inside a
# K-block, in another order than the plain version, and so do weights
# narrowed in tiles finer than the K-block and taken as stored (the
# adaptive path): unless bit-equal, hold them to this fraction of the
# output's largest magnitude
BLOCK_TOL = 1e-5

TRAIN_M = 4096              # gemma2-2b training batch: 2 x 2048 tokens
TRAIN_SHAPES = {            # weight: (K, N) at gemma2-2b full width
    "wq": (2304, 2048), "wk": (2304, 1024), "wv": (2304, 1024),
    "wo": (2048, 2304), "ffn_wg": (2304, 9216), "ffn_wi": (2304, 9216),
    "ffn_wo": (9216, 2304), "head": (2304, 256000),
}
# (name, quantize_w, mantissa_bits, block, stochastic) of the small cases
BWD_SMALL = (("m8", True, 8, 0, False), ("m12", True, 12, 0, False),
             ("m8_b32", True, 8, 32, False), ("m8_stoch", True, 8, 0, True),
             ("narrow_w", False, 8, 0, False))
# B1/B2 route cases: (name, M, K, N, quantize_w, mantissa_bits,
# stochastic, (bk, bn) or None for the default tiles, w dtype, near-full
# mantissas, route of B1 and B2). Non-quantized weights are narrowed at m
# bits in 128 x 128 tiles. Near-full mantissas (|q| ~ 122-127 on every
# element) make bk 2048's int32 K-block sums pass 2^24, where an f32 sum
# would round; bk 1024 stays just below (127^2 * 1024 < 2^24).
ROUTE_CASES = (
    tuple((f"int8_M{M}", M, 2304, 2048, True, 8, False, None, "bfloat16",
           False, "int8_wgmma") for M in (1, 8, 100))
    + tuple((f"bf16_M{M}", M, 2304, 2048, False, 8, False, None,
             "bfloat16", False, "bf16_wgmma") for M in (1, 8, 100, 4096))
    + (("int8_M4096_m4", 4096, 2304, 2048, True, 4, False, None,
        "bfloat16", False, "int8_wgmma"),
       ("int8_m4_stoch", 256, 2304, 2048, True, 4, True, None, "bfloat16",
        False, "int8_wgmma"),
       ("int8_bk1024", 256, 4096, 4096, True, 8, False, (1024, 1024),
        "bfloat16", True, "int8_wgmma"),
       ("int8_bk2048", 256, 4096, 4096, True, 8, False, (2048, 2048),
        "bfloat16", True, "int8_wgmma"),
       ("f32_raw_w", 256, 2304, 2048, False, 8, False, None, "float32",
        False, "cuda_core")))
# B3 sums tokens with varying scales in f32 in another order than its
# plain version: |Δ| <= 2·M·2^-24 · (|x̂|ᵀ|ĝ|) elementwise, twice the f32
# rounding bound of an M-term sum of those products
F32_UNIT = 2.0 ** -24
# card vs CPU training step (gemma2 smoke, f32): the card's and the CPU's
# f32 ops (exp, tanh, rsqrt, reduction orders) differ in the last ulps,
# and now and then an ulp moves a value across a BFP rounding boundary; a
# flip changes every gradient behind it, and AdamW's first step turns a
# near-zero gradient's sign into a ±lr update. Measured on one H100: loss
# 2.7e-4 relative, grads 2.5% and updates 17.5% in relative Frobenius
# norm, no parameter further than 2·lr apart.
TRAIN_TOL = dict(loss=2e-3, grads=0.1, updates=0.5)
TRAIN_LR = 1e-3

# train-sr: gemma2-2b trained stochastically (ROADMAP A5) at full width on
# B1-B3, the weights narrowed in 24 x 24 tiles; the Trainer's seed (every
# full-width run uses it; nearest rounding ignores it)
SR_SPEC = "8~stochastic; backend=pallas"
SR_SEED = 21
# the remat, telemetry and resume proofs: gemma2-2b at full width and
# SR_LAYERS of 26 layers; SR_STEPS steps uninterrupted against a run
# preempted at step 3 and resumed from its step-2 checkpoint (master,
# moments and meta: ~16 GB)
SR_LAYERS = 2
SR_STEPS = 6
SR_DISK_GB = 18.0

# yi-9b's training attention: 1 sequence x 32 heads, 4096 tokens, hd 128
FLASH_SHAPE = (32, 4096, 128)
# yi-9b trains at full width and 8 of its 48 layers (16, ~53 GB of f32
# master, AdamW moments and grads, until PR 30 cut it for the script's
# time; all 48 would need ~140 GB)
YI_LAYERS = 8
# train-full's and train-sr's gemma2-2b: 8 of 26 layers (26 until PR 30,
# cut for the script's time on slower hosts)
GEMMA_LAYERS = 8
# (name, BH, S, hd, dtype, m_bits, m_qk, m_pv, causal, block or None for
# the largest power of two up to 128 dividing S) of the small cases; B4's
# route follows from them (`flash_route`): int8 wgmma at m_qk, m_pv <= 8
# and the tiles it takes, the CUDA cores otherwise
FLASH_SMALL = (("m12", 4, 512, 128, "bfloat16", 12, 0, 0, True, None),
               ("qk10", 4, 512, 128, "bfloat16", 8, 10, 0, True, None),
               ("pv6", 4, 512, 128, "bfloat16", 8, 0, 6, True, None),
               ("qk12_pv6", 4, 512, 128, "bfloat16", 8, 12, 6, True, None),
               ("noncausal", 4, 512, 128, "bfloat16", 8, 0, 0, False, None),
               ("s96_f32", 4, 96, 64, "float32", 8, 0, 0, True, None),
               ("f32_noncausal", 4, 512, 128, "float32", 8, 0, 0, False,
                None),
               ("hd64_b64", 4, 512, 64, "bfloat16", 8, 0, 0, True, 64),
               ("hd96_m4_f32", 4, 384, 96, "float32", 4, 0, 0, True, None),
               ("b32_f32", 4, 256, 64, "float32", 8, 0, 0, True, 32))
# H100 SXM special-function unit: 16 results per clock per SM (the CUDA
# programming guide's throughput table, compute capability 9.0) at the
# 1.98 GHz the data sheet's 67 TFLOP/s f32 implies (132 SMs x 128 lanes x
# 2 flops per FMA): expf's ex2 issues at this rate
SFU_OPS_S = 132 * 16 * 1.98e9
# f32 ops per kept score of B4's int8 route, counted from its code
# (csrc/hbfp_flash_fwd_sm90.cuh): int32 -> f32 (2), scale (2), mask (1),
# row max (1), s - m (1), row sum (1), max |p| (1), the p quantize (divide,
# round, two clamps, convert: 5), plus the PV promotion per output element
# and k-block (convert 2, scale 2, acc * alpha 1, add 1: 6 per (row, d),
# i.e. 6·hd/bk per score)
FLASH_F32_PER_SCORE = 13
FLASH_F32_PER_PV = 6
# the same count for B5's and B6's int8 routes (csrc/hbfp_flash_bwd_sm90.
# cuh), per kept score: s as above (int32 -> f32 2, scale 2, mask 1,
# s - lse 1), dp (int32 -> f32 2, scale 2, dp - D 1), ds = p·(dp - D) (1),
# a row max per quantized operand (1 each), and each quantize (multiply
# by the reciprocal, round, two clamps, times the step: 5) and its bf16
# conversion (1): B5 quantizes ds (20 ops), and promotes dq per output
# element and k-block (multiply by α, add: 2 per (row, d), 2·hd/bk per
# score); B6 quantizes p and ds (28 ops)
FLASH_F32_PER_SCORE_BWD = {"hbfp_flash_dq": 20, "hbfp_flash_dkv": 28}
FLASH_F32_PER_PROMOTE = {"hbfp_flash_dq": 2, "hbfp_flash_dkv": 0}
# B4's scores, probabilities, quantized operands, o and lse equal the
# plain version's bit for bit (the same f32 ops, expf/logf, and the row sum
# of p in the kernel's order). B5/B6 sum dq, dk, dv (exact products with
# varying scales) in another order: |Δ| <= 2·S·2^-24·(Σ|a||b|) elementwise
# before the cast to the output type, plus, for bf16 outputs, one rounding
# of each side (|r(x) - x| <= u·|x| <= u/(1-u)·|r(x)|, u = 2^-8).
BF16_ROUND = 2.0 ** -8 / (1 - 2.0 ** -8)

# yi-9b's tapped and packed weight shapes (R, C) at full width
QUANT_SHAPES = {"wq": (4096, 4096), "wk": (4096, 512),
                "ffn_wg": (4096, 11008), "ffn_wo": (11008, 4096),
                "head": (4096, 64000)}
# B7 cases: (name, R, C, dtype, m, tile_r, tile_c, stochastic, seed,
# block_r, block_c, timed); the "t24" rows are the adaptive path's weight
# taps (HBFPConfig(4, 16, tile=24)), the main-path cost of B7, and the
# "g_t24" rows its gradient taps (bf16 weight gradients at the wgrad
# width, 4 + 4 bits, ADAPT_SPEC)
QUANT_CASES = tuple(
    [(f"{w}_m{m}", R, C, "float32", m, 128, 128, False, 0, 256, 512, True)
     for w, (R, C) in QUANT_SHAPES.items() for m in (8, 16)]
    + [(f"{w}_t24_m4", R, C, "float32", 4, 24, 24, False, 0, 256, 512, True)
       for w, (R, C) in QUANT_SHAPES.items()]
    + [(f"{w}_g_t24_m8", R, C, "bfloat16", 8, 24, 24, False, 0, 256, 512,
        True) for w, (R, C) in QUANT_SHAPES.items()]
    + [("ffn_wg_whole_m16", 4096, 11008, "float32", 16, None, None, False, 0,
        256, 512, True),
       ("act_row_m4", 4096, 4096, "bfloat16", 4, 1, 4096, False, 0, 256,
        512, True)]
    + [c for s in (7, 1234567) for c in (
        (f"stoch_1000_t64_s{s}", 1000, 1000, "float32", 8, 64, 64, True, s,
         256, 512, False),
        (f"stoch_ffn_wg_s{s}", 4096, 11008, "float32", 8, 128, 128, True, s,
         256, 512, s == 7))]
    + [(f"small_{R}x{C}_t{t}_m{m}", R, C, "float32", m, t, t, False, 0, 256,
        512, False) for R, C in ((100, 130), (128, 256)) for t in (32, 64)
       for m in (4, 8, 12)]
    + [("small_blocks_64x96", 100, 130, "float32", 8, 32, 32, False, 0, 64,
        96, False),
       ("small_blocks_32x128", 128, 256, "float32", 4, 32, 64, False, 0, 32,
        128, False)])

# B7 edge cases, bit for bit with edge inputs (_edge_input): (name, R, C,
# dtype, m, tile_r, tile_c, stochastic, seed, x offset in elements);
# 4096 = 170·24 + 16 and 50 = 2·24 + 2 pad the last tiles; the offset
# puts x one element past a 16-byte boundary (split's scalar passes)
QUANT_EDGE_CASES = (
    ("edge_t24_m2", 50, 4096, "float32", 2, 24, 24, False, 0, 0),
    ("edge_t24_m16", 50, 4096, "float32", 16, 24, 24, False, 0, 0),
    ("edge_t24_stoch_s7", 50, 4096, "float32", 8, 24, 24, True, 7, 0),
    ("edge_t24_stoch_sneg", 50, 4096, "float32", 4, 24, 24, True, -123457,
     0),
    ("edge_t24_bf16_m4", 50, 4096, "bfloat16", 4, 24, 24, False, 0, 0),
    ("edge_t128_m16_stoch", 200, 392, "float32", 16, 128, 128, True, 99, 0),
    ("edge_rows_bf16_m4", 10, 4096, "bfloat16", 4, 1, None, False, 0, 0),
    ("edge_whole_m8", 300, 2048, "float32", 8, None, None, False, 0, 0),
    ("edge_whole_c130_m8", 300, 130, "float32", 8, None, None, False, 0, 0),
    ("edge_unaligned_t24_m4", 50, 4096, "float32", 4, 24, 24, False, 0, 1))
# B7 routes: every launch of the adaptive path and the packed save takes one
# of these (split only for tiles larger than a CTA)
B7_MAIN_ROUTES = ("banded", "split")

# the closed adaptive-precision loop (tests/test_numerics.py loop_setup):
# HBFPConfig(4, 16, tile=24), ControllerConfig(patience=1, cooldown=1),
# TapConfig(cadence=2), on the kernels ("pallas") under "4; wgrad+4"
ADAPT_SPEC = "4; wgrad+4; backend=pallas"
ADAPT_STEPS = 6
# yi-9b at full width for the adaptive path: 2 of its 48 layers (0.87 B
# parameters, so one Trainer checkpoint of f32 params and AdamW moments
# is ~10.4 GB on disk) and 8 steps, preempted at 6, resumed at 4
ADAPT_LAYERS = 2
ADAPT_FULL_STEPS = 8
ADAPT_DISK_GB = 25.0
# card vs CPU, adaptive smoke (f32): the step-0 weight taps see identical
# weights, so their stats agree but for the float64 sum order of sqnr_db;
# later taps see weights and grads that the two devices' f32 ops have
# moved apart by a few ulps, which flips a BFP rounding now and then
# (ROADMAP C6): sqnr_db within 1.5 dB, the fractions within 0.05, the
# exponent spread within 2
ADAPT_TOL = dict(sqnr0=1e-3, frac0=1e-6, sqnr=1.5, frac=0.05, spread=2.0,
                 loss=2e-3)


# accuracy: the paper's claim, loss against fp32 (ROADMAP A8).
# (a) the design-space grid of benchmarks/design_space.py at yi-9b smoke,
# card against CPU: (name, mantissa bits, spec); spec a policy string or
# (block, tile) for HBFPConfig(m, 16).with_block(block) / tile=tile
ACC_STEPS = 40
ACC_ROWS = (("fp32", 0, None),) + tuple(
    (f"hbfp{m}_b{b or 'tile'}", m, (b, None))
    for m in (4, 8) for b in (16, 32, 64, None)) + (
    ("sched8_b16_b64@50%", 8, "8; b=16@0,b=64@50%"),
    ("hbfp4_b16_pallas", 4, "4; b=16; backend=pallas"),
    ("hbfp4_16_t24", 4, (None, 24)), ("hbfp8_16_t24", 8, (None, 24)))
# (a)'s CPU half runs beside the card in ACC_CPU_PROCS processes of
# ACC_CPU_THREADS threads, the rows dealt out in turn. One process of the
# default 8 OpenMP threads beside the card's own process oversubscribed
# the H100 machine's 8 cores (342 s for the 13 rows); on that host 2 and
# 4 threads give the losses of 8 bit for bit, 1, 6 and 7 do not
ACC_CPU_PROCS, ACC_CPU_THREADS = 3, 2
# (b) full width: (family, layers; 0 = all), 1 x 4096 markov tokens, one
# LR a family on its own schedule, four policies (name, spec, (m, tile)).
# minicpm-2b at 8 of 40 layers and phi3-mini at 4 of 32 (40 and 8 took
# ~290 s of the script's time limit)
ACC_FULL = (("minicpm-2b", 8), ("phi3-mini-3.8b", 4))
ACC_TOKENS = 4096
ACC_LR = 3e-4
ACC_WARMUP = 4
ACC_POLICIES = (("fp32", "fp32", None),
                ("hbfp8_t128", "8; backend=pallas", None),
                ("hbfp8_16_t24", "8; backend=pallas", (8, 24)),
                ("hbfp4_16_t24", "4; backend=pallas", (4, 24)))
ACC_BOUND_ROW = "hbfp8_16_t24"     # whose full-width delta is bounded
# ... and held no worse than the 4-bit control's plus the noise of an m 4
# tail (the CPU test's m 4 tolerance): a check the bound alone cannot make
ACC_CONTROL_ROW = "hbfp4_16_t24"
ACC_CONTROL_NOISE = 0.06
# dist (ROADMAP A13): gemma2-2b at 2 of 26 layers on two ranks of one card
# (4 until ROADMAP slice 20's shard phase needed the script's time)
DIST_ARCH, DIST_LAYERS, DIST_RANKS = "gemma2-2b", 2, 2
DIST_B, DIST_S = 2, 2048            # global batch: 1 x 2048 tokens a rank
DIST_SPEC = "8; backend=pallas"
DIST_STEPS = 4                      # a warm-up step, then 3 counted
# tests/test_torch_dp_train.py's bf16 tolerance (each rank rounds its
# weight-gradient half to bf16 before the reduce adds the halves)
DIST_TOL = dict(loss=2e-3, updates=0.25)
DIST_COMPRESS_TOL = 0.02            # the reference test's bound


# tp (ROADMAP A13, second half): two ranks of one card on {data 1, model 2}
TP_RANKS = 2
TP_TRAIN = (("gemma2-2b", 2, 2, 2048, (False, True)),   # arch, layers, B, S,
            ("yi-9b", 2, 1, 4096, (False,)))           # sequence parallel
TP_EP = "llama4-scout-17b-a16e"     # its .smoke() under expert parallelism
TP_EP_B, TP_EP_S = 2, 64
# B1-B3 with the row-amax input at gemma2-2b's row-parallel shapes a rank
# (M, K, N): ffn_wo and attn_wo's row-parallel input, the head's dgrad g
TP_AMAX_SHAPES = {"ffn_wo": (4096, 4608, 2304), "attn_wo": (4096, 1024, 2304)}
TP_HEAD_DGRAD = (4096, 2304, 128000)          # M, K, N (N the rank's vocab)

# stochastic rounding under a mesh (ROADMAP slice 19): every rank draws one
# process's numbers at its parts (kernels/common.py: IndexBase).
# B1-B3 at gemma2-2b's wq (M, K, N) on each route, each operand a part of
# a larger one-process operand: (part, route) cases; the wrap part puts
# the rows 2^20 down a one-process operand, so its indices pass 2^31
SR_BASE_SHAPE = (4096, 2304, 2048)
SR_BASE_ROUTES = {"int8_wgmma": (True, 8), "bf16_wgmma": (False, 8),
                  "cuda_core": (True, 12)}
SR_BASE_PARTS = {"hbfp_matmul_fwd": ("data", "col", "data_col", "wrap"),
                 "hbfp_dgrad": ("data", "row", "wrap"),
                 "hbfp_wgrad": ("data", "col_row", "wrap")}
SR_WRAP_ROW = 1 << 20
# B7 with a base: yi-9b's wq (4096 x 4096) at the adaptive path's m 4,
# tile 24 (banded), and one element off its 16-byte alignment (split)
SR_B7_SHAPE = (4096, 4096)
# the mesh runs: gemma2-2b at full width, 2 x 2048 tokens, a warm-up
# (step 1, its operands recorded) and 3 counted steps under SR_SPEC:
# {data 2} in the dist phase's ranks (DIST_LAYERS), {data 1, model 2}
# with SP in the tp phase's ranks (SR_TP_LAYERS); the pod phase's four
# gloo ranks on {pod 2, data 1, model 2} at SR_POD_LAYERS, 1 x 2048
# tokens a data rank, a telemetry step every SR_POD_CADENCE (B7 on the
# shards)
SR_MESH_STEPS = 4
SR_TP_LAYERS = 2          # 4 until ROADMAP slice 20's shard phase
SR_POD_LAYERS, SR_POD_RANKS, SR_POD_CADENCE = 2, 4, 2
# shard (ROADMAP slice 20): sharded prefill and decode on the reference's
# serving layouts, gloo ranks of the card; yi-9b at full width and
# `layers` of 48 layers, "8; backend=pallas"
SHARD_ARCH, SHARD_SPEC = "yi-9b", "8; backend=pallas"
# (a) {data 2, model 2}: heads sharded; 8 prompts x 512 tokens (4 a data
# rank), then 16 greedy ticks on a slab ring of 1,024
SHARD_A = dict(data=2, model=2, layers=2, B=8, S=512, ctx=1024, ticks=16)
# (b) the dry run's decode_32k cell on {data 1, model 8}: the ring's
# 32,768 slots 4,096 a rank; 128 prompts x 64 tokens, 8 ticks (1 layer,
# 2 until the whole script needed the time)
SHARD_B = dict(data=1, model=8, layers=1, B=128, S=64, ctx=32768, ticks=8)
# logits against one process: tests/test_torch_serve.py's bf16 tolerance
# (partial sums added in another order, then bf16 and BFP roundings)
SHARD_TOL = 2e-2
# (c) the dry run's cells at the production mesh, on the card's host
SHARD_DRY = ("train_4k", "prefill_32k", "decode_32k")


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"{name}, power limit not read"
    log(f"[device] {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {card}")
    return name, card


def _demangle(names):
    for tool in ("/usr/local/cuda/bin/cu++filt", "c++filt"):
        try:
            r = subprocess.run([tool], input="\n".join(names),
                               capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        out = r.stdout.splitlines()
        if r.returncode == 0 and len(out) == len(names):
            return out
    return list(names)


def _ptxas_kernels(text: str):
    """(kernel, registers, spill store bytes, spill load bytes, stack
    bytes) for every entry function in nvcc's -Xptxas -v report."""
    rows, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            rows.setdefault(cur, [0, 0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            rows[cur][3], rows[cur][1], rows[cur][2] = map(int, m.groups())
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            rows.setdefault(cur, [0, 0, 0, 0])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            rows[cur][0] = int(m.group(1))
    names = list(rows)
    return [(d, *rows[n]) for d, n in zip(_demangle(names), names)]


def phase_build(later=()):
    """Build every kernel library at once, one nvcc each; load and report
    those not in `later` now. Returns (report, finish): `finish()` waits
    for the libraries in `later`, which build beside what runs meanwhile,
    loads and reports them and returns the whole report."""
    from repro_torch.kernels import hbfp_matmul as hm
    t0 = time.perf_counter()
    ex = ThreadPoolExecutor(len(hm.SOURCES))
    futs = {k: ex.submit(hm.build, k) for k in hm.SOURCES}
    report = {}

    def take(names):
        for k in names:
            info = futs[k].result()
            hm.load(k, info["path"])
            kernels = _ptxas_kernels(info["log"])
            spills = sum(st + ld for _, _, st, ld, _ in kernels)
            regs = [r for _, r, *_ in kernels]
            log(f"[build] {k}: {info['seconds']:.1f} s, {len(kernels)} "
                f"kernels, registers {min(regs)}-{max(regs)}, spill bytes "
                f"{spills}")
            for name, r, st, ld, stack in kernels:
                log(f"[build]   {name}: {r} registers, spill stores {st} B, "
                    f"spill loads {ld} B, stack {stack} B")
            report[k] = [dict(kernel=n, registers=r, spill_store_bytes=st,
                              spill_load_bytes=ld, stack_bytes=sk)
                         for n, r, st, ld, sk in kernels]

    take([k for k in hm.SOURCES if k not in later])
    log(f"[build] {len(report)} libraries in {time.perf_counter() - t0:.1f} "
        f"s")

    def finish():
        take(later)
        ex.shutdown()
        log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
        return report

    return report, finish


def _time_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _reps(fn) -> int:
    """Launch count for ~40 ms of timing, from one timed call."""
    est = _time_ms(fn, 1)
    return max(3, min(200, int(40.0 / max(est, 1e-3))))


def _graph_ms(fn, k: int = 16, reps: int = 3) -> float:
    """Device ms of one call of fn: k calls captured in one CUDA graph and
    replayed, so the kernels run back to back with no host time between
    them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(k):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / (reps * k)


def _kernel_split(fn, n: int = 3) -> dict:
    """Device ms per call of each kernel `fn` launches (torch.profiler
    over n calls after a warm-up), by demangled name up to its argument
    list; {} when the profiler sees no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = {}
    for k, (ms, _) in _device_ms_by_kernel(
            lambda: [fn() for _ in range(n)]).items():
        k = re.sub(r"^void ", "", k.split("(")[0])
        out[k] = out.get(k, 0.0) + ms / n
    return out


def _device_ms_by_kernel(fn) -> dict:
    """{kernel: (device ms, calls)} over one call of fn, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if us and e.device_type.name == "CUDA":
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + us / 1e3, n + e.count)
    return out


def _bound(ops: float, nbytes: float, kind: str) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the type's peak and the bytes over the memory rate."""
    ops_ms = ops / PEAK_OPS_S[kind] * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms > bytes_ms
            else "bytes")


def _bound_ms(M, K, N, x_bytes, w_bytes, kind) -> tuple:
    """B1: 2MKN operations; x and w read once, y (f32) written once."""
    return _bound(2.0 * M * K * N,
                  x_bytes * M * K + w_bytes * K * N + 4 * M * N, kind)


def phase_kernels():
    import torch
    from repro_torch.core import HBFP8_16, bfp
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.kernels import autotune
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = []
    for wname, (K, N) in SERVE_SHAPES.items():
        w_raw = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        w_narrow = bfp.quantize_weight(w_raw, HBFP8_16)
        for M in KERNEL_MS:
            x32 = torch.randn((M, K), generator=gen, device=dev)
            for xdt in (torch.bfloat16, torch.float32):
                x = x32.to(xdt).contiguous()
                for cname, qw, m, block, st in CONFIGS:
                    w = (w_raw if qw else w_narrow).to(xdt).contiguous()
                    bm, bk, bn = autotune.align_tiles(
                        autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N),
                        block)
                    kw = dict(mantissa_bits=m, stochastic=st, quantize_w=qw,
                              block=block, bm=bm, bk=bk, bn=bn)
                    seed = 0x5EED if st else 0
                    run = lambda: hm.hbfp_matmul_fwd(x, w, seed, **kw)
                    plain = lambda: hm.hbfp_matmul_plain(x, w, seed, **kw)
                    route = hm.gemm_route(
                        "fwd", mantissa_bits=m, quantize_w=qw, block=block,
                        bk=bk, bn=bn, N=N, w_dtype=w.dtype)
                    before = hm.hbfp_matmul_fwd.launches_by_route[route]
                    yk = run()
                    yp = plain()
                    torch.cuda.synchronize()
                    if hm.hbfp_matmul_fwd.launches_by_route[route] != \
                            before + 1:
                        fail(f"{wname} M={M} {cname}: not on route {route}")
                    if cname == "served" and xdt == torch.bfloat16 and \
                            route != "bf16_wgmma":
                        fail(f"served {wname} M={M} took {route}")
                    err = float((yk - yp).abs().max())
                    scale = float(yp.abs().max())
                    if not torch.isfinite(yk).all():
                        fail(f"non-finite kernel output {wname} M={M} {cname}")
                    if block == 0:
                        ok = torch.equal(yk, yp)
                    else:
                        ok = err <= BLOCK_TOL * scale
                    xb, wb = x.element_size(), w.element_size()
                    ab = x.to(torch.bfloat16)
                    wbf = w.to(torch.bfloat16)
                    mm = lambda: torch.matmul(ab, wbf)
                    kind = ("int8" if qw and m <= 8 and block == 0 else
                            "bf16" if m <= 8 else "f32")
                    bound, by = _bound_ms(M, K, N, xb, wb, kind)
                    n = _reps(run)
                    kms = _time_ms(run, n)
                    pms = _time_ms(plain, 2)
                    mms = _time_ms(mm, n)
                    if M == 8 and xdt == torch.bfloat16 and cname in (
                            "served", "qw_m8") and wname in ("wk", "ffn_wg"):
                        split = _kernel_split(run)
                        log(f"[kernel]   {wname} M=8 {cname} device ms by "
                            f"kernel: " + ", ".join(
                                f"{k} {v:.4f}" for k, v in split.items()))
                    row = dict(weight=wname, M=M, K=K, N=N,
                               x_dtype=str(xdt).replace("torch.", ""),
                               config=cname, route=route,
                               exact_required=block == 0,
                               ok=bool(ok), max_abs_err=err,
                               max_abs_ref=scale, kernel_ms=kms,
                               bound_ms=bound, bound_by=by, plain_ms=pms,
                               matmul_bf16_ms=mms, reps=n)
                    cases.append(row)
                    log(f"[kernel] {wname} M={M} {row['x_dtype'][:4]} "
                        f"{cname} {route} {'EQ' if block == 0 else 'TOL'} "
                        f"err={err:.2g} kernel_ms={kms:.4f} "
                        f"bound_ms={bound:.4f}({by[0]}) plain_ms={pms:.3f} "
                        f"matmul_bf16_ms={mms:.4f}")
                    if not ok:
                        fail(f"kernel != plain: {row}")
        del w_raw, w_narrow
        torch.cuda.empty_cache()
    for cname, *_ in CONFIGS:
        rows = [c for c in cases if c["config"] == cname]
        log(f"[kernel] {cname:11s}: {len(rows)} cases all ok, max_abs_err="
            f"{max(r['max_abs_err'] for r in rows):.3g}, "
            f"kernel_ms total={sum(r['kernel_ms'] for r in rows):.3f}, "
            f"bound_ms total={sum(r['bound_ms'] for r in rows):.3f}")
    return cases


def _wgrad_ok(dw, dwp, xh, gh, M):
    """B3 against its plain version: |Δ| <= 2·M·u·(|x̂|ᵀ|ĝ|); returns
    (ok, max |Δ|, max |Δ| / bound)."""
    import torch
    bound = 2 * M * F32_UNIT * (xh.abs().T @ gh.abs())
    d = (dw - dwp).abs()
    ratio = float((d / bound.clamp_min(1e-38)).max())
    return bool((d <= bound).all()), float(d.max()), ratio


def _int8_operands(a, w, op, m, bk, bn):
    """B1's (op "fwd") or B2's int8 mantissas of the activation rows and
    the weights as the kernels quantize them, for torch._int_mm: (a8
    [M, C], b8 [C, O] column-major)."""
    import torch
    from repro_torch.kernels.common import STREAM_G, STREAM_X
    from repro_torch.kernels.ref import _quantize_rows, _quantize_w
    af = a.float()
    C = af.shape[1]
    cblk, stream = (bk, STREAM_X) if op == "fwd" else (bn, STREAM_G)
    qa, _ = _quantize_rows(af, 0, C, C, m, cblk, False, 0, stream)
    qw, _ = _quantize_w(w.float(), 0, 0, w.shape[1], bk, bn, m, False, 0)
    a8 = qa.to(torch.int8)
    w8 = qw.to(torch.int8)
    del qa, qw, af
    b8 = w8.t().contiguous().t() if op == "fwd" else w8.t()
    return a8, b8


def _bwd_case(wname, M, K, N, qw, m, block, st, gen, timed,
              w_narrow=None, tiles=None, w_dtype="bfloat16", full=False,
              route=None):
    """B1, B2 and B3 at one shape and configuration against their plain
    versions; returns one row per kernel. `w_narrow` = (bits, tile)
    narrows the weights at their own format, as the adaptive path does
    for a layer the controller widened (B1 and B2 then take them as
    stored). `tiles` = (bk, bn) replaces the default tiles; `full` draws
    every operand from U[1.9, 1.99), so every mantissa is near the top of
    its range; `route` is the route B1 and B2 must take, or a dict of the
    route each must take."""
    import torch
    from repro_torch.core import HBFPConfig, bfp
    from repro_torch.kernels import autotune
    from repro_torch.kernels import hbfp_matmul as hm
    dev = torch.device("cuda")
    draw = (lambda shape: torch.rand(shape, generator=gen, device=dev)
            * 0.09 + 1.9) if full else \
        (lambda shape: torch.randn(shape, generator=gen, device=dev))
    w = draw((K, N)) * (1.0 if full else K ** -0.5)
    if not qw:
        bits, tile = w_narrow or (m, 128)
        w = bfp.quantize_weight(w, HBFPConfig(mantissa_bits=bits, tile=tile))
    w = w.to(getattr(torch, w_dtype))
    x = draw((M, K)).to(torch.bfloat16)
    # the backward's g: the bf16 grad of y, cast to f32 by the Function
    g = (draw((M, N)) * 1e-3).to(torch.bfloat16).float()
    if tiles is None:
        bm, bk, bn = autotune.align_tiles(
            autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N), block)
    else:
        bm, (bk, bn) = min(128, M), tiles
    kw = dict(mantissa_bits=m, stochastic=st, block=block, bm=bm, bk=bk,
              bn=bn)
    seed = 0x5EED if st else 0
    exact_kind = "int8" if qw and m <= 8 and block == 0 else \
        "bf16" if m <= 8 else "f32"
    rows = []
    calls = {
        "hbfp_matmul_fwd": (
            lambda: hm.hbfp_matmul_fwd(x, w, seed, quantize_w=qw, **kw),
            lambda: hm.hbfp_matmul_plain(x, w, seed, quantize_w=qw, **kw),
            lambda: torch.matmul(x, w.to(torch.bfloat16)),
            _bound_ms(M, K, N, 2, w.element_size(), exact_kind)),
        "hbfp_dgrad": (
            lambda: hm.hbfp_dgrad(g, w, seed, quantize_w=qw, **kw),
            lambda: hm.hbfp_dgrad_plain(g, w, seed, quantize_w=qw, **kw),
            lambda: torch.matmul(g.to(torch.bfloat16), w.to(torch.bfloat16).T),
            _bound(2.0 * M * K * N,
                   4 * M * N + w.element_size() * K * N + 4 * M * K,
                   exact_kind)),
        "hbfp_wgrad": (
            lambda: hm.hbfp_wgrad(x, g, seed, **kw),
            lambda: hm.hbfp_wgrad_plain(x, g, seed, **kw),
            lambda: torch.matmul(x.T, g.to(torch.bfloat16)),
            # dequantized m <= 8 operands are exact in bf16
            _bound(2.0 * M * K * N, 2 * M * K + 4 * M * N + 4 * K * N,
                   "bf16" if m <= 8 else "f32")),
    }
    for kname, (run, plain, mm, (bound, by)) in calls.items():
        took = None
        if kname == "hbfp_wgrad":
            before = dict(hm.hbfp_wgrad.launches_by_route)
            yk, xh, gh = hm.hbfp_wgrad(x, g, seed, operands=True, **kw)
            yp, xhp, ghp = hm.hbfp_wgrad_plain(x, g, seed, operands=True,
                                               **kw)
            torch.cuda.synchronize()
            took = [r for r, n in hm.hbfp_wgrad.launches_by_route.items()
                    if n != before[r]]
            took = took[0] if len(took) == 1 else str(took)
            want_route = hm.wgrad_route(mantissa_bits=m, M=M, K=K, N=N,
                                        bm=bm)
            if took != want_route or (timed.startswith("train")
                                      and took != "bf16_wgmma"):
                fail(f"hbfp_wgrad {wname} {timed}: took route {took}, "
                     f"expected {want_route}")
            ok_w, err, ratio = _wgrad_ok(yk, yp, xh, gh, M)
            ok = ok_w and torch.equal(xh, xhp) and torch.equal(gh, ghp)
            exact = "operands EQ, dw TOL"
            if torch.equal(yk, yp):
                exact += " (bit-equal)"
            del xh, gh, xhp, ghp
        else:
            before = dict(getattr(hm, kname).launches_by_route)
            yk, yp = run(), plain()
            torch.cuda.synchronize()
            took = [r for r, n in getattr(hm, kname).launches_by_route.items()
                    if n != before[r]]
            took = took[0] if len(took) == 1 else str(took)
            err = float((yk - yp).abs().max())
            ratio = None
            if block == 0 and w_narrow is None:
                ok, exact = torch.equal(yk, yp), "EQ"
            elif torch.equal(yk, yp):
                ok, exact = True, "EQ"
            else:
                ok = err <= BLOCK_TOL * float(yp.abs().max())
                exact = "TOL"
            want = route.get(kname) if isinstance(route, dict) else route
            if want is not None and took != want:
                fail(f"{kname} {wname} {timed}: took route {took}, expected "
                     f"{want}")
        if not torch.isfinite(yk).all():
            fail(f"non-finite {kname} output {wname} {M}x{K}x{N}")
        del yk, yp
        row = dict(kernel=kname, weight=wname, M=M, K=K, N=N,
                   config=timed, route=took, ok=bool(ok), check=exact,
                   max_abs_err=err, err_over_bound=ratio, bound_ms=bound,
                   bound_by=by)
        if timed == "train":
            n = _reps(run)
            row.update(kernel_ms=_time_ms(run, n), plain_ms=_time_ms(plain, 2),
                       matmul_bf16_ms=_time_ms(mm, n), reps=n)
            if wname == "ffn_wg" or (wname == "head"
                                     and kname == "hbfp_wgrad"):
                row["kernel_split_ms"] = _kernel_split(run)
                log(f"[bwd]   {kname} {wname} device ms by kernel: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in
                                row["kernel_split_ms"].items()))
            if took == "int8_wgmma":
                # yardstick only: PyTorch's int8 GEMM on the same int8
                # mantissas (no scales, no promotion); the port never
                # calls it
                op = "fwd" if kname == "hbfp_matmul_fwd" else "dgrad"
                a8, b8 = _int8_operands(x if op == "fwd" else g, w, op, m,
                                        bk, bn)
                row["int_mm_ms"] = _time_ms(lambda: torch._int_mm(a8, b8),
                                            n)
                del a8, b8
        rows.append(row)
        log(f"[bwd] {kname} {wname} {M}x{K}x{N} {timed} {took or ''} "
            f"{exact} err={err:.3g}" + ("" if ratio is None else
                                        f" err/bound={ratio:.3g}")
            + ("" if timed != "train" else
               f" kernel_ms={row['kernel_ms']:.3f} bound_ms={bound:.4f}"
               f"({by[0]}) plain_ms={row['plain_ms']:.2f} "
               f"matmul_bf16_ms={row['matmul_bf16_ms']:.4f}"
               + (f" int_mm_ms={row['int_mm_ms']:.4f}"
                  if "int_mm_ms" in row else "")))
        if not ok:
            fail(f"{kname} != plain: {row}")
    return rows


def phase_bwd():
    """B1/B2/B3 at gemma2-2b's training shapes (the training
    configuration: quantized bf16 weights, m = 8, nearest, timed; then
    stochastic, the train-sr configuration; B1 and B2 on the int8 wgmma
    route, B3 on bf16 wgmma) plus small cases of the other configurations
    and the route cases."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for wname, (K, N) in TRAIN_SHAPES.items():
        rows += _bwd_case(wname, TRAIN_M, K, N, True, 8, 0, False, gen,
                          "train", route="int8_wgmma")
        torch.cuda.empty_cache()
    for wname, (K, N) in TRAIN_SHAPES.items():
        rows += _bwd_case(wname, TRAIN_M, K, N, True, 8, 0, True, gen,
                          "train_stoch", route="int8_wgmma")
        torch.cuda.empty_cache()
    small_routes = {"m8": "int8_wgmma", "m12": "cuda_core",
                    "m8_b32": "cuda_core", "m8_stoch": "int8_wgmma",
                    "narrow_w": "bf16_wgmma"}
    for cname, qw, m, block, st in BWD_SMALL:
        rows += _bwd_case("wq", 256, 2304, 2048, qw, m, block, st, gen,
                          cname, route=small_routes[cname])
    for cname, M, K, N, qw, m, st, tiles, wdt, full, route in ROUTE_CASES:
        rows += _bwd_case("wq", M, K, N, qw, m, 0, st, gen, cname,
                          tiles=tiles, w_dtype=wdt, full=full, route=route)
        torch.cuda.empty_cache()
    # B3 with K <= 64: one warpgroup, the M-blocks split across CTAs and
    # folded in ascending order (B1/B2's routes are not checked here)
    rows += _bwd_case("k64", 4096, 64, 2048, True, 8, 0, False, gen,
                      "wgrad_k64_split")
    # the adaptive path after a widen: x at m 4 against yi-9b ffn_wg
    # weights narrowed at 8 bits in 24 x 24 tiles, taken as stored
    rows += _bwd_case("ffn_wg", 4096, 4096, 11008, False, 4, 0, False, gen,
                      "adaptive_w8_t24", w_narrow=(8, 24),
                      route="bf16_wgmma")
    torch.cuda.empty_cache()
    rows += _sr_base_cases(gen)
    for k in ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad"):
        tr = [r for r in rows if r["kernel"] == k and r["config"] == "train"]
        im = [r["int_mm_ms"] for r in tr if "int_mm_ms" in r]
        log(f"[bwd] {k}: one layer + head at M={TRAIN_M}: kernel_ms "
            f"{sum(r['kernel_ms'] for r in tr):.2f}, bound_ms "
            f"{sum(r['bound_ms'] for r in tr):.3f}, plain_ms "
            f"{sum(r['plain_ms'] for r in tr):.1f}, matmul_bf16_ms "
            f"{sum(r['matmul_bf16_ms'] for r in tr):.3f}"
            + (f", int_mm_ms {sum(im):.3f}" if len(im) == len(tr) else ""))
    return rows


def _sr_gemm_case(kname, part, route, gen):
    """One B1/B2/B3 launch whose operands are parts of larger one-process
    operands (`SR_BASE_PARTS`), stochastic, on `route`: against its plain
    version with the same bases, bit for bit (B3's dw within its bound),
    and against the plain version of the whole operands, sliced (the
    output where it is a slice of the whole's, B3's dequantized operands
    always); the wrap part against the same-base plain version alone (its
    one-process operand has 2^20 rows). Returns one row."""
    import torch
    from repro_torch.core import HBFPConfig, bfp
    from repro_torch.kernels import autotune
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.kernels.common import IndexBase
    M, K, N = SR_BASE_SHAPE
    qw, m = SR_BASE_ROUTES[route]
    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    # one-process operands twice as large along the split dims
    rows2 = part in ("data", "data_col")
    Mg = 2 * M if rows2 else M
    Kg = 2 * K if part in ("row", "col_row") else K
    Ng = 2 * N if part in ("col", "data_col", "col_row") else N
    W = rnd(Kg, Ng) * Kg ** -0.5
    if not qw:
        W = bfp.quantize_weight(W, HBFPConfig(mantissa_bits=m, tile=128))
    W = W.to(torch.bfloat16)
    X = rnd(Mg, Kg).to(torch.bfloat16)
    G = (rnd(Mg, Ng) * 1e-3).to(torch.bfloat16).float()
    r0 = M if rows2 else 0
    k0, n0 = Kg - K, Ng - N
    rs, ks, ns = slice(r0, r0 + M), slice(k0, k0 + K), slice(n0, n0 + N)
    wrap = part == "wrap"
    rbase = SR_WRAP_ROW if wrap else r0
    Mb = SR_WRAP_ROW + M if wrap else Mg
    xb = IndexBase((Mb, Kg), (rbase, k0 if part == "col_row" else 0))
    gb = IndexBase((Mb, Ng), (rbase, n0))
    wb = IndexBase((Kg, Ng), (k0 if kname == "hbfp_dgrad" else 0, n0))
    bm, bk, bn = autotune.align_tiles(
        autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N), 0)
    kw = dict(mantissa_bits=m, stochastic=True, bm=bm, bk=bk, bn=bn)
    seed = 0x5EED
    g = G[rs, ns].contiguous()
    before = dict(getattr(hm, kname).launches_by_route)
    if kname == "hbfp_matmul_fwd":
        x = X[rs].contiguous()
        w = W[:, ns].contiguous()
        a = dict(x_base=xb, w_base=wb, quantize_w=qw, **kw)
        got = hm.hbfp_matmul_fwd(x, w, seed, **a)
        same = hm.hbfp_matmul_plain(x, w, seed, **a)
        whole = None if wrap else hm.hbfp_matmul_plain(
            X, W, seed, quantize_w=qw, **kw)[rs, ns]
        checks = [("out", got, same, whole)]
    elif kname == "hbfp_dgrad":
        w = W[ks].contiguous()
        g = G[rs].contiguous()
        a = dict(g_base=IndexBase((Mb, Ng), (rbase, 0)), w_base=wb,
                 quantize_w=qw, **kw)
        got = hm.hbfp_dgrad(g, w, seed, **a)
        same = hm.hbfp_dgrad_plain(g, w, seed, **a)
        whole = None if wrap else hm.hbfp_dgrad_plain(
            G, W, seed, quantize_w=qw, **kw)[rs, ks]
        checks = [("out", got, same, whole)]
    else:
        x = X[rs, ks].contiguous()
        a = dict(x_base=xb, g_base=gb, operands=True, **kw)
        dw, xh, gh = hm.hbfp_wgrad(x, g, seed, **a)
        dwp, xhp, ghp = hm.hbfp_wgrad_plain(x, g, seed, **a)
        wx = wg = None
        if not wrap:
            _, wx, wg = hm.hbfp_wgrad_plain(X, G, seed, operands=True,
                                            **kw)
            wx, wg = wx[rs, ks], wg[rs, ns]
        ok_w, err_w, _ = _wgrad_ok(dw, dwp, xh, gh, M)
        checks = [("x_hat", xh, xhp, wx), ("g_hat", gh, ghp, wg)]
        got = dw
    torch.cuda.synchronize()
    took = [r for r, n in getattr(hm, kname).launches_by_route.items()
            if n != before[r]]
    want_route = route if kname != "hbfp_wgrad" else \
        hm.wgrad_route(mantissa_bits=m, M=M, K=K, N=N, bm=bm)
    same_ok = all(torch.equal(k_, p_) for _, k_, p_, _ in checks)
    whole_ok = None if wrap else all(torch.equal(k_, w_)
                                     for _, k_, _, w_ in checks)
    if kname == "hbfp_wgrad":
        same_ok = same_ok and ok_w
    err = max(float((k_ - p_).abs().max()) for _, k_, p_, _ in checks)
    if kname == "hbfp_wgrad":
        err = max(err, err_w)
    row = dict(kernel=kname, case=f"base_{part}_{route}", part=part,
               config="sr_base", route=took[0] if len(took) == 1 else took,
               M=M, K=K, N=N, m=m, base_rows=rbase, ok=bool(
                   same_ok and whole_ok is not False),
               plain_same_base=bool(same_ok), whole_sliced=whole_ok,
               max_abs_err=err,
               check="EQ same base" + ("" if wrap else
                                       ", EQ whole sliced"))
    log(f"[sr base] {kname} {part} {route} ({M}x{K}x{N} of "
        f"{Mb}x{Kg}x{Ng}) route={row['route']} same-base EQ={same_ok} "
        f"whole-sliced EQ={whole_ok} err={err:.3g}")
    if not row["ok"]:
        fail(f"{kname} with an index base != plain: {row}")
    if took != [want_route]:
        fail(f"{kname} with an index base took {took}, expected "
             f"{want_route}: {row}")
    del X, W, G, g, got, checks
    return row


def _sr_base_timing(gen):
    """B1-B3 at gemma2-2b's seven training projections (M = 4096) under
    stochastic rounding on the training routes, timed without and with a
    data shard's index base (the rows 4096 down a one-process operand) in
    turns (none, base, base, none): the base adds two integer adds a
    draw. One row a kernel and shape."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.kernels.common import IndexBase
    M, dev, seed = TRAIN_M, "cuda", 0x5EED
    rows = []
    for wname, (K, N) in TRAIN_SHAPES.items():
        if wname == "head":
            continue
        w = (torch.randn((K, N), generator=gen, device=dev)
             * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        g = (torch.randn((M, N), generator=gen, device=dev)
             * 1e-3).to(torch.bfloat16).float()
        bm, bk, bn = autotune.align_tiles(
            autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N), 0)
        kw = dict(mantissa_bits=8, stochastic=True, bm=bm, bk=bk, bn=bn)
        xb = IndexBase((2 * M, K), (M, 0))
        gb = IndexBase((2 * M, N), (M, 0))
        calls = {
            "hbfp_matmul_fwd": (
                lambda b: hm.hbfp_matmul_fwd(x, w, seed, x_base=xb if b
                                             else None, **kw),
                _bound_ms(M, K, N, 2, 2, "int8")),
            "hbfp_dgrad": (
                lambda b: hm.hbfp_dgrad(g, w, seed, g_base=gb if b else None,
                                        **kw),
                _bound(2.0 * M * K * N, 4 * M * N + 2 * K * N + 4 * M * K,
                       "int8")),
            "hbfp_wgrad": (
                lambda b: hm.hbfp_wgrad(x, g, seed, x_base=xb if b else None,
                                        g_base=gb if b else None, **kw),
                _bound(2.0 * M * K * N, 2 * M * K + 4 * M * N + 4 * K * N,
                       "bf16"))}
        for kname, (fn, (bound, by)) in calls.items():
            n = _reps(lambda: fn(False))
            t = [_time_ms(lambda: fn(b), n) for b in (False, True, True,
                                                      False)]
            row = dict(kernel=kname, weight=wname, config="sr_base_timed",
                       M=M, K=K, N=N, kernel_ms=(t[0] + t[3]) / 2,
                       kernel_base_ms=(t[1] + t[2]) / 2, turns_ms=t,
                       bound_ms=bound, bound_by=by, reps=n)
            rows.append(row)
            log(f"[sr base] {kname} {wname} {M}x{K}x{N} stochastic: "
                f"kernel_ms {row['kernel_ms']:.4f} without a base, "
                f"{row['kernel_base_ms']:.4f} with one (turns "
                f"{[round(v, 4) for v in t]}), bound_ms {bound:.4f}")
        del w, x, g
    torch.cuda.empty_cache()
    for k in GEMM_KERNELS:
        r = [x for x in rows if x["kernel"] == k]
        log(f"[sr base] {k}: one layer at M={M} stochastic: kernel_ms "
            f"{sum(x['kernel_ms'] for x in r):.3f} without a base, "
            f"{sum(x['kernel_base_ms'] for x in r):.3f} with one")
    return rows


def _sr_base_cases(gen) -> list:
    """ROADMAP slice 19's kernel cases: B1, B2 and B3 on every route with
    each part of `SR_BASE_PARTS` (`_sr_gemm_case`), then timed on the
    training route with and without a base (`_sr_base_timing`)."""
    import torch
    rows = []
    for kname, parts in SR_BASE_PARTS.items():
        for route in SR_BASE_ROUTES:
            if kname == "hbfp_wgrad" and route == "bf16_wgmma":
                continue        # B3's routes follow m: the int8 row's
            for part in parts:
                rows.append(_sr_gemm_case(kname, part, route, gen))
                torch.cuda.empty_cache()
    rows += _sr_base_timing(gen)
    return rows


def _flash_work(BH, S, hd, causal):
    """(MACs of one S×S×hd product the mask leaves, exp count): positions
    k <= q only when causal."""
    pairs = BH * (S * (S + 1) // 2 if causal else S * S)
    return pairs * hd, pairs


def _flash_bounds(BH, S, hd, esize, causal, m_qk, m_pv):
    """{kernel: (bound ms, bound_by)} for B4, B5, B6: integral products at
    the int8 rate (f32 above m = 8), f32-path products at the bf16 rate
    (their m <= 8 operands are exact in bf16); bytes: every input read
    once, every output written once."""
    mac, _ = _flash_work(BH, S, hd, causal)
    rate = lambda m: PEAK_OPS_S["int8" if m <= 8 else "f32"]
    frate = PEAK_OPS_S["bf16" if max(m_qk, m_pv) <= 8 else "f32"]
    t = BH * S * hd * esize          # one [BH, S, hd] tensor
    r = BH * S * 4                   # one [BH, S] f32 tensor
    work = {  # kernel: (seconds of operations, bytes)
        "hbfp_flash_fwd": (2 * mac / rate(m_qk) + 2 * mac / rate(m_pv),
                           4 * t + r),
        "hbfp_flash_dq": (2 * mac / rate(m_qk) + 2 * mac / rate(m_pv)
                          + 2 * mac / frate, 5 * t + 2 * r),
        "hbfp_flash_dkv": (2 * mac / rate(m_qk) + 2 * mac / rate(m_pv)
                           + 4 * mac / frate, 6 * t + 2 * r),
    }
    out = {}
    for k, (ops_s, nbytes) in work.items():
        bytes_s = nbytes / HBM_BYTES_S
        out[k] = (max(ops_s, bytes_s) * 1e3,
                  "operations" if ops_s > bytes_s else "bytes")
    return out


def _flash_grad_ok(got, want, bound, S, bf16):
    """|Δ| <= 2·S·u·Σ|a||b| (+ bf16 rounding of both sides); returns (ok,
    max |Δ|, max |Δ| / tolerance, bit-equal)."""
    import torch
    g, w = got.float(), want.float()
    tol = 2 * S * F32_UNIT * bound
    if bf16:
        tol = tol + BF16_ROUND * (g.abs() + w.abs())
    d = (g - w).abs()
    ratio = float((d / tol.clamp_min(1e-38)).max())
    return (bool((d <= tol).all()), float(d.max()), ratio,
            bool(torch.equal(g, w)))


def _flash_softmax_bound(BH, S, hd, bk, causal, kernel="hbfp_flash_fwd"):
    """A flash kernel's second bound: the f32 work around its int8
    products, per kept score an expf at the special-function rate and the
    f32 ops counted from its code (FLASH_F32_PER_SCORE and the PV
    promotion for B4, FLASH_F32_PER_SCORE_BWD and the dq promotion for
    B5/B6) at the f32 rate; the larger of the two times, in ms."""
    _, n_exp = _flash_work(BH, S, hd, causal)
    if kernel == "hbfp_flash_fwd":
        per = FLASH_F32_PER_SCORE + FLASH_F32_PER_PV * hd / bk
    else:
        per = (FLASH_F32_PER_SCORE_BWD[kernel]
               + FLASH_F32_PER_PROMOTE[kernel] * hd / bk)
    return max(n_exp / SFU_OPS_S, n_exp * per / PEAK_OPS_S["f32"]) * 1e3


def _flash_case(name, BH, S, hd, dtype, m, m_qk, m_pv, causal, blk, gen,
                timed):
    """B4, B5 and B6 at one shape against their plain versions on the
    same inputs, each launch's route checked; returns one row per kernel
    (and, timed, the SDPA yardstick and each kernel's device time by
    kernel: pre-pass vs main)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.kernels.ref import flash_delta
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    blk = blk or min(128, S & -S)
    q, k, v = (torch.randn((BH, S, hd), generator=gen, device=dev).to(dt)
               for _ in range(3))
    do = (torch.randn((BH, S, hd), generator=gen, device=dev) * 1e-2).to(dt)
    kw = dict(m_bits=m, m_qk=m_qk, m_pv=m_pv, bq=blk, bk=blk, causal=causal)
    mq, mp = m_qk or m, m_pv or m
    rows, bf16 = [], dt == torch.bfloat16
    route = fa.flash_route(m_qk=mq, m_pv=mp, S=S, hd=hd, bq=blk, bk=blk)
    before = fa.hbfp_flash_fwd.launches_by_route[route]
    ok_k, lse_k = fa.hbfp_flash_fwd(q, k, v, with_lse=True, **kw)
    o_nolse = fa.hbfp_flash_fwd(q, k, v, **kw)
    o_p, lse_p = fa.hbfp_flash_fwd_plain(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    if fa.hbfp_flash_fwd.launches_by_route[route] != before + 2:
        fail(f"flash {name}: B4 not on route {route}")
    fwd_ok = (torch.equal(ok_k, o_p) and torch.equal(lse_k, lse_p)
              and torch.equal(o_nolse, ok_k))
    err = max(float((ok_k.float() - o_p.float()).abs().max()),
              float((lse_k - lse_p).abs().max()))
    rows.append(dict(kernel="hbfp_flash_fwd", ok=fwd_ok, check="EQ",
                     max_abs_err=err, bit_equal=fwd_ok, route=route))
    del ok_k, o_nolse
    delta = flash_delta(o_p, do)
    args = (q, k, v, do, lse_p, delta)
    route = fa.flash_bwd_route(m_qk=mq, m_pv=mp, S=S, hd=hd, bq=blk, bk=blk)
    before = {k_: getattr(fa, k_).launches_by_route[route]
              for k_ in ("hbfp_flash_dq", "hbfp_flash_dkv")}
    dq_k = fa.hbfp_flash_dq(*args, **kw)
    dq_p, bq_ = fa.hbfp_flash_dq_plain(*args, with_bound=True, **kw)
    torch.cuda.synchronize()
    ok, err, ratio, eq = _flash_grad_ok(dq_k, dq_p, bq_, S, bf16)
    rows.append(dict(kernel="hbfp_flash_dq", ok=ok, check="TOL",
                     max_abs_err=err, err_over_tol=ratio, bit_equal=eq,
                     route=route))
    del dq_k, dq_p, bq_
    dk_k, dv_k = fa.hbfp_flash_dkv(*args, **kw)
    dk_p, dv_p, bk_, bv_ = fa.hbfp_flash_dkv_plain(*args, with_bound=True,
                                                  **kw)
    torch.cuda.synchronize()
    rk = _flash_grad_ok(dk_k, dk_p, bk_, S, bf16)
    rv = _flash_grad_ok(dv_k, dv_p, bv_, S, bf16)
    rows.append(dict(kernel="hbfp_flash_dkv", ok=rk[0] and rv[0],
                     check="TOL", max_abs_err=max(rk[1], rv[1]),
                     err_over_tol=max(rk[2], rv[2]),
                     bit_equal=rk[3] and rv[3], route=route))
    for k_, n in before.items():
        if getattr(fa, k_).launches_by_route[route] != n + 1:
            fail(f"flash {name}: {k_} not on route {route}")
    for row in rows:
        row["bound_softmax_ms"] = _flash_softmax_bound(
            BH, S, hd, blk, causal, row["kernel"])
    del dk_k, dv_k, dk_p, dv_p, bk_, bv_
    finite = all(bool(torch.isfinite(t).all()) for t in (o_p, lse_p))
    bounds = _flash_bounds(BH, S, hd, q.element_size(), causal, mq, mp)
    mac, n_exp = _flash_work(BH, S, hd, causal)
    calls = {
        "hbfp_flash_fwd": (lambda: fa.hbfp_flash_fwd(q, k, v, with_lse=True,
                                                     **kw),
                           lambda: fa.hbfp_flash_fwd_plain(
                               q, k, v, with_lse=True, **kw)),
        "hbfp_flash_dq": (lambda: fa.hbfp_flash_dq(*args, **kw),
                          lambda: fa.hbfp_flash_dq_plain(*args, **kw)),
        "hbfp_flash_dkv": (lambda: fa.hbfp_flash_dkv(*args, **kw),
                           lambda: fa.hbfp_flash_dkv_plain(*args, **kw)),
    }
    sdpa = None
    if timed:
        # q, k, v hold one [S, hd] head per B·H (kv heads repeated):
        # SDPA on [1, BH, S, hd]
        q4, k4, v4 = (t.reshape(1, BH, S, hd).to(torch.bfloat16)
                      for t in (q, k, v))
        f = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=causal)
        q4g, k4g, v4g = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
        do4 = do.reshape(1, BH, S, hd).to(torch.bfloat16)

        def fb():
            out = F.scaled_dot_product_attention(q4g, k4g, v4g,
                                                 is_causal=causal)
            torch.autograd.grad(out, (q4g, k4g, v4g), do4)
        sdpa = dict(fwd_ms=_time_ms(f, _reps(f)),
                    fwd_bwd_ms=_time_ms(fb, _reps(fb)))
    for row in rows:
        name_k = row["kernel"]
        bound, by = bounds[name_k]
        row.update(case=name, BH=BH, S=S, hd=hd, dtype=dtype, m_bits=m,
                   m_qk=mq, m_pv=mp, causal=causal, bound_ms=bound,
                   bound_by=by, macs_per_product=mac, exp_count=n_exp)
        if timed:
            run, plain = calls[name_k]
            n = _reps(run)
            row.update(kernel_ms=_time_ms(run, n), plain_ms=_time_ms(plain, 1),
                       reps=n)
            row["kernel_split_ms"] = _kernel_split(run)
            log(f"[flash]   {name_k} {name} device ms by kernel: "
                + ", ".join(f"{k} {v:.4f}" for k, v in
                            row["kernel_split_ms"].items()))
        log(f"[flash] {name_k} {name} BH={BH} S={S} hd={hd} {dtype[:4]} "
            f"blk={blk} {row.get('route', '')} "
            f"m={m}/{mq}/{mp} causal={causal} {row['check']} "
            f"bit_equal={row['bit_equal']} err={row['max_abs_err']:.3g}"
            + (f" err/tol={row['err_over_tol']:.3g}"
               if "err_over_tol" in row else "")
            + (f" kernel_ms={row['kernel_ms']:.3f} bound_ms={bound:.4f}"
               f"({by[0]}) plain_ms={row['plain_ms']:.1f}" if timed else "")
            + f" bound_softmax_ms={row['bound_softmax_ms']:.4f}")
        if not finite:
            row["ok"] = False
    if sdpa:
        log(f"[flash] SDPA yardstick (bf16, is_causal={causal}, another "
            f"function): fwd {sdpa['fwd_ms']:.3f} ms, fwd+bwd "
            f"{sdpa['fwd_bwd_ms']:.3f} ms; MUFU exp per kernel {n_exp:.3g}")
        for row in rows:
            row["sdpa"] = sdpa
    return rows


def phase_flash():
    """B4/B5/B6 against their plain versions on the card: the yi-9b
    training shape (timed, with the SDPA yardstick) and the small cases."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2468)
    BH, S, hd = FLASH_SHAPE
    rows = _flash_case("yi_train", BH, S, hd, "bfloat16", 8, 0, 0, True,
                       None, gen, timed=True)
    off = [r["kernel"] for r in rows if r["route"] != "int8_wgmma"]
    if off:
        fail(f"yi-9b's training attention took another route than int8 "
             f"wgmma in {off}")
    torch.cuda.empty_cache()
    for case in FLASH_SMALL:
        rows += _flash_case(*case, gen, timed=False)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"flash kernels disagree with their plain versions: {bad}")
    return rows


def _quant_bound(R, C, m, tile_r, tile_c, block_r, block_c, x_bytes):
    """B7's least time: x read once; mantissas, exponents, clip counts and
    the per-block exponent min and max written once, at the memory rate."""
    from repro_torch.kernels.ref import bfp_tiles
    tr, tc, Rp, Cp, br, bc = bfp_tiles(R, C, tile_r, tile_c, block_r,
                                       block_c)
    tiles = (Rp // tr) * (Cp // tc)
    blocks = (Rp // br) * (Cp // bc)
    nbytes = x_bytes * R * C + (1 if m <= 8 else 2) * R * C + 5 * tiles \
        + 8 * blocks
    return _bound(0.0, nbytes, "f32")


def _edge_input(R, C, tr, tc, dtype, seed):
    """x with, tile by tile in turn: normal values, an all-zero tile, amax
    below 2^-100 (exponent clamped at -100), amax near 2^127, only
    subnormal inputs, and one 1.5·2^127 element (clamped at 126) over unit
    values (subnormal quotients at m 2)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((R, C), generator=g) * 2.5
    n_tc = -(-C // tc)
    for ti in range(-(-R // tr)):
        for tj in range(n_tc):
            s = x[ti * tr:(ti + 1) * tr, tj * tc:(tj + 1) * tc]
            u = torch.rand(s.shape, generator=g) * 2 - 1
            kind = (ti * n_tc + tj) % 7
            if kind == 1:
                s.zero_()
            elif kind in (2, 3, 4):
                s.copy_(u * {2: 2.0 ** -103, 3: 1.7e38, 4: 1e-39}[kind])
            elif kind == 5:
                s.copy_(u)
                s[0, 0] = 1.5 * 2.0 ** 127
    return x.to(getattr(torch, dtype))


def phase_quantize():
    """B7 against its plain version on the card, bit for bit in all five
    outputs (mantissas, exponents, clip counts, exponent min and max), at
    yi-9b's tapped and packed shapes, the whole-matrix tile, tile 24 with
    padding, an activation row tap in bf16, stochastic rounding, the small
    cases and the edge cases (exponent clamp, subnormals, zero tiles, m 2
    and 16, an unaligned x); each launch's route is counted and must be
    the route table's (every yi-9b shape and row tap banded); timed with
    the plain version and a clone() of x (one read and one write of x) as
    the yardstick, and the kernels' device time alone (`_graph_ms`)."""
    import torch
    from repro_torch.kernels import bfp_quantize as bq
    gen = torch.Generator(device="cuda").manual_seed(97)
    cases = [(*c, "randn", 0) for c in QUANT_CASES] + [
        (n, R, C, dt, m, tr, tc, st, sd, 256, 512, False, "edge", off)
        for n, R, C, dt, m, tr, tc, st, sd, off in QUANT_EDGE_CASES]
    rows = []
    for (name, R, C, dtype, m, tr, tc, st, seed, br, bc, timed, kind,
         off) in cases:
        if kind == "edge":
            xe = _edge_input(R, C, tr or R, tc or C, dtype, R + C + m)
            buf = torch.zeros(R * C + off, dtype=xe.dtype, device="cuda")
            buf[off:] = xe.reshape(-1).cuda()
            x = buf[off:].view(R, C)
        else:
            x = (torch.randn((R, C), generator=gen, device="cuda")
                 * 2.5).to(getattr(torch, dtype))
        kw = dict(mantissa_bits=m, tile_r=tr, tile_c=tc, stochastic=st,
                  block_r=br, block_c=bc, with_stats=True)
        run = lambda: bq.bfp_quantize(x, seed, **kw)
        plain = lambda: bq.bfp_quantize_plain(x, seed, **kw)
        want_route = bq.bfp_quantize_route(R, C, tr, tc, x.dtype, m,
                                           x.data_ptr() % 16 == 0)
        bq.reset_counts()
        got = run()
        route = [r for r, n in bq.bfp_quantize.launches_by_route.items()
                 if n]
        want = plain()
        torch.cuda.synchronize()
        ok = all(a.dtype == b.dtype and torch.equal(a, b)
                 for a, b in zip(got, want)) and len(got) == 5
        err = float((got[0].int() - want[0].int()).abs().max())
        bound, by = _quant_bound(R, C, m, tr, tc, br, bc, x.element_size())
        row = dict(kernel="bfp_quantize", case=name, R=R, C=C, dtype=dtype,
                   m=m, tile=[tr, tc], stochastic=st, seed=seed,
                   block=[br, bc], input=kind, offset=off, ok=bool(ok),
                   route=route[0] if len(route) == 1 else route,
                   check="EQ (5 outputs)", max_abs_err=err, bound_ms=bound,
                   bound_by=by)
        del got, want
        if timed:
            n = _reps(run)
            row.update(kernel_ms=_time_ms(run, n),
                       plain_ms=_time_ms(plain, 2),
                       clone_ms=_time_ms(lambda: x.clone(), n), reps=n)
            row["x_bound"] = row["kernel_ms"] / bound
            # device time alone: the launch loop above also waits on the
            # host's wrapper where the kernel is shorter
            row["device_ms"] = _graph_ms(run)
        rows.append(row)
        log(f"[quantize] {name} {R}x{C} {dtype[:4]} m={m} tile={tr}x{tc} "
            f"stoch={st} route={row['route']} EQ={ok}" + (
                f" kernel_ms={row['kernel_ms']:.4f} bound_ms={bound:.4f}"
                f"({by[0]}) x_bound={row['x_bound']:.2f} device_ms="
                f"{row['device_ms']:.4f} plain_ms="
                f"{row['plain_ms']:.2f} clone_ms={row['clone_ms']:.4f}"
                if timed else ""))
        del x
        if not ok:
            fail(f"bfp_quantize != plain: {row}")
        if route != [want_route]:
            fail(f"bfp_quantize launched on {route}, its route table says "
                 f"{want_route}: {row}")
        if kind == "randn" and R >= 4096 and (tr is not None) != (
                route == ["banded"]):
            fail(f"bfp_quantize: a yi-9b shape off the banded route, or a "
                 f"whole-matrix tile on it: {row}")
    torch.cuda.empty_cache()
    return rows + _sr_b7_cases(gen)


def _sr_b7_cases(gen) -> list:
    """B7 with an index base (ROADMAP slice 19): yi-9b's wq at m 4, tile
    24, stochastic, with stats, as a shard's rows, a shard's columns (each
    at a 24-multiple offset of a larger one-process operand, as a ZeRO
    shard of a weight) and rows 2^20 down (indices past 2^31), on the
    banded route and, one element off 16-byte alignment, the split
    route: all five outputs bit-equal to the plain version with the same
    base; mantissas and exponents to the plain version of the whole
    operand, sliced (the wrap case: the same base only). Then timed at
    yi-9b's five t24 shapes without and with a base, in turns."""
    import torch
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.kernels.common import IndexBase
    R, C = SR_B7_SHAPE
    off = (R // 24 - 1) * 24                    # 4080: a tile-row boundary
    kw = dict(mantissa_bits=4, tile_r=24, tile_c=24, stochastic=True,
              with_stats=True)
    seed = 7
    rows = []
    for route, mis in (("banded", 0), ("split", 1)):
        for part in ("rows", "cols", "wrap"):
            Rg = R + off if part == "rows" else R
            Cg = C + off if part == "cols" else C
            X = torch.randn((Rg, Cg), generator=gen, device="cuda") * 2.5
            r0, c0 = Rg - R, Cg - C
            x = X[r0:, c0:].contiguous()
            buf = torch.zeros(R * C + mis, device="cuda")
            buf[mis:] = x.reshape(-1)
            x = buf[mis:].view(R, C)
            Rgp, Cgp = -(-Rg // 24) * 24, -(-Cg // 24) * 24
            base = IndexBase((SR_WRAP_ROW + R, Cgp), (SR_WRAP_ROW, 0)) \
                if part == "wrap" else IndexBase((Rgp, Cgp), (r0, c0))
            bq.reset_counts()
            got = bq.bfp_quantize(x, seed, base=base, **kw)
            took = [r for r, n in bq.bfp_quantize.launches_by_route.items()
                    if n]
            same = bq.bfp_quantize_plain(x, seed, base=base, **kw)
            ok_same = all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(got, same))
            ok_whole = None
            if part != "wrap":
                wm, we = bq.bfp_quantize_plain(X, seed, **kw)[:2]
                ok_whole = torch.equal(got[0], wm[r0:, c0:]) and \
                    torch.equal(got[1], we[r0 // 24:, c0 // 24:])
            err = float((got[0].int() - same[0].int()).abs().max())
            row = dict(kernel="bfp_quantize", case=f"base_{part}_{route}",
                       R=R, C=C, dtype="float32", m=4, tile=[24, 24],
                       stochastic=True, seed=seed, input="randn",
                       offset=mis, part=part, base=[list(base.shape),
                                                    list(base.offset)],
                       route=took[0] if len(took) == 1 else took,
                       ok=bool(ok_same and ok_whole is not False),
                       plain_same_base=bool(ok_same), whole_sliced=ok_whole,
                       check="EQ (5 outputs) same base" + (
                           "" if part == "wrap" else
                           ", mantissas + exponents EQ whole sliced"),
                       max_abs_err=err)
            rows.append(row)
            log(f"[sr base] bfp_quantize {part} {route} ({R}x{C} of "
                f"{Rg}x{Cg}) route={row['route']} same-base EQ={ok_same} "
                f"whole-sliced EQ={ok_whole}")
            if not row["ok"]:
                fail(f"bfp_quantize with an index base != plain: {row}")
            if took != [route]:
                fail(f"bfp_quantize with an index base took {took}, "
                     f"expected {route}: {row}")
            del X, x, buf, got, same
    for w, (R, C) in QUANT_SHAPES.items():
        x = torch.randn((R, C), generator=gen, device="cuda") * 2.5
        base = IndexBase((-(-R // 24) * 24 * 2, -(-C // 24) * 24),
                         (-(-R // 24) * 24, 0))
        run = lambda b: bq.bfp_quantize(x, seed, base=base if b else None,
                                        **kw)
        n = _reps(lambda: run(False))
        t = [_time_ms(lambda: run(b), n) for b in (False, True, True,
                                                   False)]
        bound, by = _quant_bound(R, C, 4, 24, 24, 256, 512, 4)
        row = dict(kernel="bfp_quantize", case=f"{w}_t24_m4_stoch_timed",
                   R=R, C=C, dtype="float32", m=4, tile=[24, 24],
                   stochastic=True, input="randn", config="sr_base_timed",
                   kernel_ms=(t[0] + t[3]) / 2,
                   kernel_base_ms=(t[1] + t[2]) / 2, turns_ms=t,
                   bound_ms=bound, bound_by=by, reps=n,
                   device_ms=_graph_ms(lambda: run(False)),
                   device_base_ms=_graph_ms(lambda: run(True)))
        rows.append(row)
        log(f"[sr base] bfp_quantize {w} {R}x{C} m 4 t24 stochastic: "
            f"kernel_ms {row['kernel_ms']:.4f} without a base, "
            f"{row['kernel_base_ms']:.4f} with one; device_ms "
            f"{row['device_ms']:.4f} / {row['device_base_ms']:.4f}; "
            f"bound_ms {bound:.4f}")
        del x
    torch.cuda.empty_cache()
    return rows


def b7_times(tree: str) -> int:
    """`--b7-times TREE`: B7 of the checkout at TREE (its
    `repro_torch.kernels.bfp_quantize`) at phase 5's timed cases, each
    call bit-equal to its plain version, ms a call in the launch loop and
    on the device alone; one JSON line a case, then the card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import bfp_quantize as bq
    if not bq.__file__.startswith(tree + os.sep):
        fail(f"--b7-times: imported {bq.__file__}, not from {tree}")
    _, card = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(97)
    for (name, R, C, dtype, m, tr, tc, st, seed, br, bc,
         timed) in QUANT_CASES:
        x = (torch.randn((R, C), generator=gen, device="cuda")
             * 2.5).to(getattr(torch, dtype))
        if not timed:
            continue
        kw = dict(mantissa_bits=m, tile_r=tr, tile_c=tc, stochastic=st,
                  block_r=br, block_c=bc, with_stats=True)
        run = lambda: bq.bfp_quantize(x, seed, **kw)
        got, want = run(), bq.bfp_quantize_plain(x, seed, **kw)
        ok = len(got) == 5 and all(a.dtype == b.dtype and torch.equal(a, b)
                                   for a, b in zip(got, want))
        del got, want
        if not ok:
            fail(f"--b7-times: {name} != plain in {tree}")
        bound, _ = _quant_bound(R, C, m, tr, tc, br, bc, x.element_size())
        print(json.dumps({"tree": tree, "case": name, "bound_ms": bound,
                          "kernel_ms": _time_ms(run, _reps(run)),
                          "device_ms": _graph_ms(run)}), flush=True)
        del x
    print(card)
    return 0


def _smoke_serve(tag: str, arch_name: str, lens, **engine_kw):
    """`arch_name` smoke in f32 served on the card (kernel path) and on the
    CPU (plain path) from the same weights: the prefill logits of the
    longest prompt within 2e-3·max|cpu| and equal greedy tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    from repro_torch.serve import ServeEngine
    arch = dataclasses.replace(get_arch(arch_name).smoke(), dtype="float32")
    pol = parse_policy("8; backend=pallas")
    p_cpu = init_params(7, arch, device="cpu")
    p_gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    prompts = [[int(t) for t in torch.randint(
        0, arch.vocab_size, (n,), generator=torch.Generator().manual_seed(n))]
        for n in lens]
    outs, firsts = {}, {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServeEngine(arch, params, pol, max_batch=2, ctx_len=64,
                          device=dev, **engine_kw)
        toks = eng._ints(prompts[-1])[None]
        logits, _ = eng._prefill(eng.params, toks, plen=len(prompts[-1]))
        firsts[dev] = logits.float().cpu()
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        outs[dev] = eng.drain()
    a, b = firsts["cpu"], firsts["cuda"]
    if tuple(b.shape) != (1, 1, arch.vocab_size) or not torch.isfinite(b).all():
        fail(f"{arch_name}: bad card logits {tuple(b.shape)}")
    diff = float((a - b).abs().max())
    tol = 2e-3 * float(a.abs().max())
    log(f"{tag} {arch_name} smoke f32 {engine_kw} prefill logits card vs "
        f"cpu: max|d|={diff:.3g} (tol {tol:.3g}); tokens equal: "
        f"{outs['cpu'] == outs['cuda']}")
    if diff > tol:
        fail(f"{arch_name}: card logits disagree with the CPU path")
    if outs["cpu"] != outs["cuda"]:
        fail(f"{arch_name}: greedy tokens differ: {outs}")
    return dict(max_abs_diff=diff, tol=tol, tokens=outs["cuda"])


def phase_model():
    """yi-9b smoke in f32: card (kernel) vs CPU (plain) prefill logits and
    greedy decode tokens."""
    _smoke_serve("[model]", "yi-9b", (5, 9, 17))


def _rel_fro(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / a.norm().clamp_min(1e-30))


def phase_train(arch_name: str, spec: str = "8; backend=pallas",
                key=None, grid: bool = False):
    """One smoke step of `arch_name` (f32, `spec`) on the card (the
    kernels) and on the CPU (their plain versions) from the same state,
    batch and key: loss, grads and the parameter updates. yi-9b's
    attention takes flash (B4-B6), gemma2's never does. A stochastic spec
    draws the same xorshift noise from `key` on both devices. `grid`
    gives qwen2-vl's batch an image-grid span of M-RoPE positions, which
    keeps attention off flash."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for_arch
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import OptState, named_leaves
    from repro_torch.train import TrainState, init_train_state, make_step
    arch = dataclasses.replace(get_arch(arch_name).smoke(),
                               dtype="float32", loss_chunk=32)
    sched = make_schedule("constant", base_lr=TRAIN_LR, warmup_steps=0,
                          total_steps=10)
    cpu = init_train_state(7, arch, device="cpu")
    p0 = {n: t.clone() for n, t in named_leaves(cpu.params)}
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.cuda()
    card = TrainState(to(cpu.params), OptState(0, to(cpu.opt.mu),
                                               to(cpu.opt.nu)), 0)
    batch = batch_for_arch(arch, 2, 32, kind="markov", device="cpu")
    if grid:
        batch["positions"] = _grid_positions(2, 32)
    out, flash = {}, {}
    for dev, state in (("cpu", cpu), ("cuda", card)):
        step = make_step(arch, spec, sched, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        fa.reset_counts()
        _, _, grads = step.grads(state, b, key)
        state, m = step(state, b, key)
        flash[dev] = (fa.hbfp_flash_fwd.plain_calls, fa.hbfp_flash_fwd.launches)
        out[dev] = (float(m["loss"]), dict(named_leaves(grads)),
                    dict(named_leaves(state.params)))
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    g_err = max(_rel_fro(gc[n], gg[n]) for n in gc)
    u_err = max(_rel_fro(pc[n] - p0[n], pg[n].cpu() - p0[n]) for n in pc)
    p_err = max(float((pc[n] - pg[n].cpu()).abs().max()) for n in pc)
    log(f"[train] {arch_name} smoke {spec!r}{' image grid' if grid else ''}"
        f" one step card vs cpu: loss "
        f"{lg:.6f} vs "
        f"{lc:.6f}, grads rel-fro {g_err:.3g}, updates rel-fro "
        f"{u_err:.3g}, max |dparam| {p_err:.3g}; B4 plain calls on the "
        f"CPU {flash['cpu'][0]}, launches on the card {flash['cuda'][1]}")
    if not (abs(lg - lc) <= TRAIN_TOL["loss"] * abs(lc)
            and g_err <= TRAIN_TOL["grads"]
            and u_err <= TRAIN_TOL["updates"] and p_err <= 4 * TRAIN_LR):
        fail(f"{arch_name} {spec!r}: card training step disagrees with the "
             f"CPU step")
    takes_flash = (not arch.xlstm and arch.attn_pattern == "global"
                   and arch.attn_softcap is None and not grid)
    if takes_flash != (flash["cpu"][0] > 0 and flash["cuda"][1] > 0):
        fail(f"{arch_name}: flash taken {flash}, expected {takes_flash}")
    return dict(spec=spec, grid=grid, loss_card=lg, loss_cpu=lc,
                grads_rel_fro=g_err,
                updates_rel_fro=u_err, max_abs_param=p_err)


# model regions a profiled step is split by: (module, function) wrapped in
# a torch.profiler range while the step is profiled (never otherwise)
REGIONS = {"chunk scan": ("repro_torch.models.ssm", "_chunk_scan"),
           "sim attention": ("repro_torch.models.attention", "mha"),
           # the MoE layer's expert GEMMs (moe.py calls ctx_matmul only
           # for them), and the layer around them
           "expert GEMMs": ("repro_torch.models.moe", "ctx_matmul"),
           "MoE routing": ("repro_torch.models.moe", "moe_ffn"),
           "optimizer": ("repro_torch.train.train_step", "adamw_update"),
           "narrowing": ("repro_torch.train.train_step", "_narrow_copy")}
# the kernel groups of a profiled step, by kernel name
KERNEL_GROUPS = {
    "B1 gemm (fwd)": r"(^|[^_])gemm_kernel<\d+, \d+, false|"
                     r"tc_gemm_kernel<\d+, \w+, \w+, false, false>",
    "B2 gemm (dgrad)": r"(^|[^_])gemm_kernel<\d+, \d+, true|"
                       r"tc_gemm_kernel<\d+, \w+, \w+, true, false>",
    "B1/B2/B3 split-K fold": r"fold_kernel",
    "B1/B2 quantize passes (int8)":
        r"quantize_(rows|w)_kernel<\w+, signed char",
    "B3 gemm (wgrad)": r"wgrad_gemm_kernel|"
                       r"tc_gemm_kernel<\d+, \w+, \w+, \w+, true>",
    "B3 quantize passes (bf16; B1 bf16 x pass)":
        r"quantize_rows_kernel<\w+, __nv_bfloat16",
    "f32 quantize passes (cuda_core)": r"quantize_(rows|w)_kernel<\w+, float",
    "B4 flash fwd (main)": r"flash_fwd_kernel|flash_tc_kernel",
    "B4-B6 flash pre-passes": r"flash_(rows|vt)_prepass",
    "B5 flash dq (main)": r"flash_dq_kernel|flash_dq_tc_kernel",
    "B6 flash dkv (main)": r"flash_dkv_kernel|flash_dkv_tc_kernel"}


class _Regions:
    """Wrap the named REGIONS' functions in torch.profiler ranges for the
    duration of a `with` block (the modules call them by their global
    names, so the wrapped function is the one that runs)."""

    def __init__(self, names):
        import importlib
        self.fns = [(n, importlib.import_module(REGIONS[n][0]),
                     REGIONS[n][1]) for n in names]
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function
        for name, mod, fn in self.fns:
            f = getattr(mod, fn)
            self.saved.append((mod, fn, f))

            def wrapped(*a, _f=f, _n=name, **k):
                with record_function(_n):
                    return _f(*a, **k)
            setattr(mod, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, fn, f in self.saved:
            setattr(mod, fn, f)
        self.saved = []


def _step_kernels(prof, names=()):
    """One pass over the profiler's raw events (no FunctionEvent tree,
    which takes minutes at ~10^6 events): every device kernel's name and
    ms, and the model region (of `names`) it belongs to, or None. A
    kernel belongs to the region whose range its launching op ran in (the
    forward and the remat recompute), or whose forward op recorded the
    autograd node its launching op ran for (the backward, matched by the
    forward's thread and sequence number). Also returns the host scalar
    copies (`aten::_local_scalar_dense`)."""
    names = set(names)
    cpu, kernels, syncs = {}, [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU":
            if e.is_async():
                continue
            n = e.name()
            if n == "aten::_local_scalar_dense":
                syncs += 1
            cpu.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), n, e.correlation_id(),
                 e.sequence_nr(), e.fwd_thread_id()))
        elif e.name() not in names:          # not a range's device mirror
            kernels.append((e.name(), e.duration_ns() / 1e6,
                            e.linked_correlation_id()))
    # each op's nearest marker: a region range or an evaluate_function
    marker_of, fwd = {}, {}
    for tid, evs in cpu.items():
        evs.sort()
        stack = []                           # (end, marker id)
        for start, neg_end, n, cid, seq, fwd_tid in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            mark = stack[-1][1] if stack else None
            if n in names:
                mark = ("range", n)
            elif n.startswith("autograd::engine::evaluate_function"):
                mark = ("eval", fwd_tid, seq)
            elif seq >= 0 and mark is not None and mark[0] == "range":
                fwd[(tid, seq)] = mark[1]
            marker_of[cid] = mark
            stack.append((-neg_end, mark))
    region = lambda m: None if m is None else (
        m[1] if m[0] == "range" else fwd.get((m[1], m[2])))
    return [(n, ms, region(marker_of.get(link))) for n, ms, link in kernels], \
        syncs


def _profile_step(trainer, steps: int, regions=()):
    """Kernel time by name over one more training step, and the step's
    device-to-host scalar copies (`aten::_local_scalar_dense`), from
    torch.profiler; None when the profiler saw no device time. With
    `regions` (names of REGIONS) the kernels outside KERNEL_GROUPS are
    split further by model region. The step's wall time is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with _Regions(regions), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(steps, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels, syncs = _step_kernels(prof, regions)
    total = sum(ms for _, ms, _ in kernels)
    if not total:
        return None
    share = {g: sum(ms for k, ms, _ in kernels if re.search(p, k)) / total
             for g, p in KERNEL_GROUPS.items()}
    grouped = re.compile("|".join(KERNEL_GROUPS.values()))
    for r in regions:
        share[r] = sum(ms for k, ms, reg in kernels
                       if reg == r and not grouped.search(k)) / total
    share["everything else"] = 1.0 - sum(share.values())
    by_name = {}
    for k, ms, _ in kernels:
        t, c = by_name.get(k, (0.0, 0))
        by_name[k] = (t + ms, c + 1)
    top = sorted(by_name.items(), key=lambda r: -r[1][0])[:15]
    return dict(device_ms=total, wall_ms=wall * 1e3, share=share,
                host_syncs=syncs, kernels=len(kernels),
                analysis_s=time.perf_counter() - t0,
                top=[dict(kernel=k[:120], ms=ms, count=c)
                     for k, (ms, c) in top])


FLASH_KERNELS = ("hbfp_flash_fwd", "hbfp_flash_dq", "hbfp_flash_dkv")
GEMM_KERNELS = ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad")
ROUTED_KERNELS = ("hbfp_matmul_fwd", "hbfp_dgrad")     # B1, B2
# every training launch of B3 and of B4-B6 takes its tensor-core route
TRAIN_ROUTES = {"hbfp_wgrad": "bf16_wgmma", "hbfp_flash_fwd": "int8_wgmma",
                "hbfp_flash_dq": "int8_wgmma",
                "hbfp_flash_dkv": "int8_wgmma"}


def _routes():
    """B1-B6's launches by route since the last reset."""
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.kernels import hbfp_matmul as hm
    out = {k: dict(getattr(hm, k).launches_by_route)
           for k in GEMM_KERNELS}
    out.update({k: dict(getattr(fa, k).launches_by_route)
                for k in FLASH_KERNELS})
    return out


def _all_on(routes: dict, route: str) -> bool:
    """Every counted launch of these kernels took `route`."""
    return all(n == 0 for by in routes.values() for r, n in by.items()
               if r != route)


def _train_routes_ok(routes: dict) -> bool:
    """B3 and B4-B6 launches all on their tensor-core routes."""
    return all(_all_on({k: routes[k]}, r) for k, r in TRAIN_ROUTES.items())


def _projections(arch) -> int:
    """Projections a training step runs through B1-B3, summed over the
    layers: 7 a dense layer (4 attention, 3 ffn), 9 a hybrid one (and 2
    ssm), 4 an mLSTM layer and 2 an sLSTM layer (only the active branch
    runs)."""
    if arch.xlstm:
        n_s = sum(i % arch.slstm_every == arch.slstm_every - 1
                  for i in range(arch.n_layers)) if arch.slstm_every else 0
        return 4 * (arch.n_layers - n_s) + 2 * n_s
    return (9 if arch.ssm else 7) * arch.n_layers


def _train_launches(arch, T: int, steps: int = 3) -> dict:
    """B1-B6 launches of `steps` training steps over T tokens a step under
    "8; backend=pallas" with remat: the P projections and the K heads (K
    codebooks, else 1), each recomputed in the backward (B1 twice), each
    head once a CE chunk; when T fits one loss chunk (or is no whole
    number of chunks) the CE is not chunked and the heads not recomputed.
    Flash (B4 twice a layer, B5 and B6 once) on full-causal attention
    without a softcap."""
    P, lc, K = _projections(arch), arch.loss_chunk, arch.n_codebooks
    C = T // lc if lc and T > lc and T % lc == 0 else 0
    b1 = 2 * (P + K * C) if C else 2 * P + K
    b23 = P + K * (C or 1)
    fl = arch.n_layers if (not arch.xlstm and arch.attn_pattern == "global"
                           and arch.attn_softcap is None) else 0
    return {"hbfp_matmul_fwd": steps * b1, "hbfp_dgrad": steps * b23,
            "hbfp_wgrad": steps * b23, "hbfp_flash_fwd": steps * 2 * fl,
            "hbfp_flash_dq": steps * fl, "hbfp_flash_dkv": steps * fl}


class _WallTimer:
    """Host time spent in one module function over a `with` block, the
    device synchronized before and after each call (so the time is the
    call's own, queued work included); the function is looked up by its
    global name by its callers, so the wrapped one is the one that runs."""

    def __init__(self, module: str, fn: str):
        import importlib
        self.mod, self.fn = importlib.import_module(module), fn
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        import torch
        f = self.orig = getattr(self.mod, self.fn)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        setattr(self.mod, self.fn, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.fn, self.orig)


def _at_depth(arch_name: str, n_layers: int = 0):
    """`arch_name`'s config at `n_layers` of its depth (0: all) and the
    words that say which."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(arch_name)
    arch = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
    L = arch.n_layers
    return arch, (f"{L} of {full.n_layers} layers (depth cut)"
                  if L < full.n_layers else f"{L} layers (no depth cut)")


def phase_train_full(card: str, arch_name: str, B: int, S: int,
                     n_layers: int = 0, spec: str = "8; backend=pallas",
                     base=None, phase: str = "train-full", regions=(),
                     b2_cuda_core: int = 0, profile: bool = True,
                     timed=None):
    """`arch_name` at full width (n_layers > 0 cuts the depth), the policy
    `spec` (on the HBFPConfig `base` when given), B x S tokens of markov
    data (seeded embeddings and uniform labels for an embeddings arch;
    loss_chunk 2048), constant LR 1e-4, through the Trainer (seed
    SR_SEED): a warm-up step, then 3 steps whose launches are counted
    exactly, and a profiled step (split by the model `regions` too;
    none without `profile`). Every B1 launch must take int8 wgmma, every
    B2 launch too but `b2_cuda_core` of them on the CUDA cores, every B3
    bf16 wgmma. `timed` = (module, function): its host time over the 3
    counted steps (`_WallTimer`)."""
    import torch
    from repro_torch.data import batch_for_arch
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import Ctx
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    from repro_torch.train.train_step import _narrow_copy
    arch, depth = _at_depth(arch_name, n_layers)
    L = arch.n_layers
    tag = f"[{phase} {arch_name}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(0, arch)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in named_leaves(state.params))
    log(f"{tag} full width: {depth}, d_model {arch.d_model}, "
        f"{arch.n_heads}/{arch.n_kv_heads} heads x {arch.hd}, d_ff "
        f"{arch.d_ff}, vocab {arch.vocab_size}, {n_params / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    # Markov tokens, or the stub frontend's seeded embeddings with uniform
    # (codebook) labels
    data = lambda i: batch_for_arch(arch, B, S, step=i, kind="markov")
    # fp32 reference: the same weights and batch with plain matmuls and
    # the sim-path attention
    with torch.no_grad():
        ref = _narrow_copy(state.params, None, torch.bfloat16)
        loss_fp32 = float(loss_fn(ref, data(0), arch, Ctx())[0])
        del ref
    torch.cuda.empty_cache()
    sched = make_schedule("constant", base_lr=1e-4, warmup_steps=0,
                          total_steps=100)
    from repro_torch.precision import parse_policy
    step = make_step(arch, spec if base is None else
                     parse_policy(spec, base=base), sched)
    sink = MemorySink()
    trainer = Trainer(train_step=step, init_state=state, data_fn=data,
                      recorder=Recorder([sink]), seed=SR_SEED)
    lines = []
    trainer.run(1, log_every=1, log_fn=lines.append)       # warm-up
    loss0 = float(lines[0].split("loss=")[1].split()[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hm.reset_counts()                        # counts cover the main path
    fa.reset_counts()
    timer = None
    if timed is None:
        trainer.run(4, log_every=1, log_fn=lines.append)
    else:
        with _WallTimer(*timed) as timer:
            trainer.run(4, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    counts = {k: getattr(hm, k).launches for k in GEMM_KERNELS}
    counts.update({k: getattr(fa, k).launches for k in FLASH_KERNELS})
    routes = _routes()
    plain = sum(getattr(hm, k).plain_calls for k in GEMM_KERNELS) + \
        sum(getattr(fa, k).plain_calls for k in FLASH_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    aux = [float(ln.split("aux=")[1].split()[0]) for ln in lines]
    spans = [ev.data["dur_us"] / 1e6 for ev in sink.events
             if ev.kind == "span" and ev.data.get("name") == "train/step"]
    step_s = spans[1:]
    want = _train_launches(arch, B * S)
    tok_s = B * S / (sum(step_s) / len(step_s))
    for ln in lines:
        log(f"{tag} {ln}")
    log(f"{tag} step times {[round(t, 3) for t in step_s]} s, "
        f"{tok_s:.0f} tokens/s, peak {peak:.2f} of {total:.2f} GiB | {card}")
    log(f"{tag} launches over 3 steps {counts} (expected {want}), plain "
        f"calls {plain}; B1-B6 by route {routes}; step-0 loss HBFP "
        f"{loss0:.4f} vs fp32 {loss_fp32:.4f}")
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"{arch_name}: non-finite training loss {losses}")
    if counts != want or plain != 0:
        fail(f"{arch_name}: launch counts {counts} != {want} or plain "
             f"calls {plain}")
    b2 = dict(routes["hbfp_dgrad"])
    if b2["cuda_core"] != b2_cuda_core:
        fail(f"{arch_name}: {b2['cuda_core']} B2 launches on the CUDA "
             f"cores, expected {b2_cuda_core}: {routes}")
    b2["cuda_core"] = 0
    if not _all_on({"hbfp_matmul_fwd": routes["hbfp_matmul_fwd"],
                    "hbfp_dgrad": b2}, "int8_wgmma"):
        fail(f"{arch_name}: a training B1/B2 launch left the int8 wgmma "
             f"route: {routes}")
    if not _train_routes_ok(routes):
        fail(f"{arch_name}: a training B3 launch left bf16 wgmma or a "
             f"B4-B6 launch left int8 wgmma: {routes}")
    if abs(loss0 - loss_fp32) > 0.02 * abs(loss_fp32):
        fail(f"{arch_name}: step-0 HBFP loss {loss0} not within 2% of fp32 "
             f"{loss_fp32}")
    prof = _profile_step(trainer, 5, regions) if profile else None
    if profile and prof is None:
        log(f"{tag} torch.profiler saw no device time")
    elif prof is not None:
        log(f"{tag} profiled step: {prof['wall_ms']:.1f} ms wall, "
            f"{prof['device_ms']:.1f} ms of kernels, "
            f"{prof['host_syncs']} host syncs (_local_scalar_dense); share "
            + ", ".join(f"{k} {v:.1%}" for k, v in prof["share"].items()))
    if timer is not None:
        log(f"{tag} {timed[1]}: {timer.calls} calls, {timer.seconds:.2f} s "
            f"over the 3 steps' {sum(step_s):.2f} s "
            f"({timer.seconds / sum(step_s):.1%}) | {card}")
    result = dict(arch=arch_name, spec=spec,
                  tile=None if base is None else base.tile, layers=L,
                  params=n_params, tokens=B * S,
                  losses=losses, aux=aux, loss_fp32_step0=loss_fp32,
                  step_s=step_s,
                  tokens_per_s=tok_s, peak_gib=peak, total_gib=total,
                  launches=counts, routes=routes, profile=prof,
                  timed=None if timer is None else dict(
                      fn=timed[1], calls=timer.calls,
                      seconds=timer.seconds,
                      share=timer.seconds / sum(step_s)))
    del trainer, state, step
    torch.cuda.empty_cache()
    return result


def _sr_base():
    from repro_torch.core import HBFPConfig
    return HBFPConfig(8, 16, tile=24)


def _first_difference(a: dict, b: dict):
    """(name, max |Δ|) of the first leaf where two {name: tensor} maps
    differ, or None when they are bit-equal."""
    import torch
    for n in a:
        if a[n].dtype != b[n].dtype or not torch.equal(a[n], b[n]):
            return n, float((a[n].float() - b[n].float()).abs().max())
    return None


def _state_differences(a, b) -> dict:
    """The first difference (`_first_difference`) of two TrainStates'
    master params and AdamW moments."""
    from repro_torch.optim.adamw import named_leaves
    trees = lambda s: (("params", s.params), ("mu", s.opt.mu),
                       ("nu", s.opt.nu))
    return {w: _first_difference(dict(named_leaves(ta)),
                                 dict(named_leaves(tb)))
            for (w, ta), (_, tb) in zip(trees(a), trees(b))}


def _b7_telemetry_launches(params, tile: int) -> int:
    """B7 launches of one telemetry step: the weight tap narrows every
    layer slice and the head (one 2-D operand each), the grad tap
    converts each stacked grad whole (one operand when the tiles divide
    its rows, else one a slice: `bfp.b7_layout`), the activation tap two
    row views."""
    from repro_torch.core import bfp
    from repro_torch.core.opt_shell import is_hbfp_weight
    from repro_torch.optim.adamw import named_leaves
    import math
    n = 2
    for name, t in named_leaves(params):
        if not is_hbfp_weight(name, t):
            continue
        slices = math.prod(t.shape[:-2])
        merged = bfp.b7_layout(tuple(t.shape),
                               bfp.weight_tile_shape(t.ndim, tile))[-1]
        n += slices + (1 if merged else slices)
    return n


def phase_train_sr(card: str, nearest: dict):
    """ROADMAP A5 on the card. gemma2-2b at full width, GEMMA_LAYERS,
    SR_SPEC on HBFPConfig(8, 16, tile=24), 2 x 2048 tokens, through the
    Trainer (phase_train_full's checks: finite losses, step-0 loss within
    2% of fp32, exact B1-B3 launches, their routes), beside train-full's
    nearest gemma2-2b run (`nearest`); its profiled step makes no more
    device-to-host scalar copies than the nearest one. Then, at SR_LAYERS
    layers: remat on and off give bit-equal loss and grads; a stochastic
    telemetry step equals the plain step (B7's launches exact, banded);
    a run preempted and resumed equals the uninterrupted run."""
    tr = phase_train_full(card, "gemma2-2b", 2, 2048, n_layers=GEMMA_LAYERS,
                          spec=SR_SPEC, base=_sr_base(), phase="train-sr")
    tag = "[train-sr]"
    for k in ("step_s", "tokens_per_s", "peak_gib"):
        log(f"{tag} {k}: stochastic {tr[k]} vs nearest {nearest[k]}")
    if tr["profile"] is None or nearest["profile"] is None:
        fail("train-sr: torch.profiler saw no device time, so the host "
             "syncs of the steps were not counted")
    syncs = (tr["profile"]["host_syncs"], nearest["profile"]["host_syncs"])
    log(f"{tag} host syncs (_local_scalar_dense) in one profiled step: "
        f"stochastic {syncs[0]} vs nearest {syncs[1]}")
    if syncs[0] > syncs[1]:
        fail(f"train-sr: the stochastic step copied {syncs[0]} scalars to "
             f"the host, the nearest step {syncs[1]}")
    for k in ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad"):
        log(f"{tag} {k} by route over 3 steps: {tr['routes'][k]}")
    return dict(train=tr, host_syncs=syncs, proofs=_sr_proofs(card))


def _sr_proofs(card: str):
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.common import fold_in
    from repro_torch.numerics import TapConfig
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.precision import parse_policy
    from repro_torch.train import Trainer, init_train_state, make_step
    tag = "[train-sr proofs]"
    arch = dataclasses.replace(get_arch("gemma2-2b"), n_layers=SR_LAYERS)
    pol = parse_policy(SR_SPEC, base=_sr_base())
    pipe = SyntheticLM(arch.vocab_size, 2048 + 1, 2, seed=0)
    sched = make_schedule("constant", base_lr=1e-4, warmup_steps=0,
                          total_steps=100)
    key = fold_in(fold_in(0, SR_SEED), 0)
    out = {}
    t0 = time.perf_counter()
    # remat on and off: the recompute draws the forward's noise
    state = init_train_state(0, arch)
    runs = {}
    for remat in (True, False):
        a = dataclasses.replace(arch, remat=remat)
        loss, _, grads = make_step(a, pol, sched).grads(state, pipe.batch(0),
                                                        key)
        runs[remat] = (loss, dict(named_leaves(grads)))
        del grads
    torch.cuda.synchronize()
    diff = _first_difference(runs[True][1], runs[False][1])
    same_loss = torch.equal(runs[True][0], runs[False][0])
    out["remat"] = dict(loss=float(runs[True][0]), loss_equal=same_loss,
                        first_difference=diff,
                        seconds=time.perf_counter() - t0)
    log(f"{tag} {SR_LAYERS} layers, remat on vs off, one key: loss "
        f"{float(runs[True][0]):.6f} vs {float(runs[False][0]):.6f}, "
        f"grads {'bit-equal' if diff is None else f'differ at {diff}'}")
    if not same_loss or diff is not None:
        fail(f"train-sr: remat recompute drew other noise: loss "
             f"{runs[True][0]} vs {runs[False][0]}, first grad difference "
             f"{diff}")
    del runs, state
    torch.cuda.empty_cache()
    # a stochastic telemetry step equals the plain step
    t0 = time.perf_counter()
    steps = {}
    for tap in (TapConfig(cadence=1), None):
        st = init_train_state(0, arch)
        _reset_counts()
        st, m = make_step(arch, pol, sched, tap=tap)(st, pipe.batch(0), key)
        torch.cuda.synchronize()
        steps[tap is not None] = (st, float(m["loss"]), _counts()[0])
    (tel, l_tel, c_tel), (pln, l_pln, _) = steps[True], steps[False]
    want_b7 = _b7_telemetry_launches(tel.params, 24)
    same = _state_differences(tel, pln)
    b7_routes = {r: c_tel[f"bfp_quantize/{r}"] for r in ("banded", "split")}
    out["telemetry"] = dict(loss=(l_tel, l_pln), differences=str(same),
                            b7_launches=c_tel["bfp_quantize"],
                            b7_expected=want_b7, b7_routes=b7_routes,
                            seconds=time.perf_counter() - t0)
    log(f"{tag} stochastic telemetry vs plain step: loss {l_tel:.6f} vs "
        f"{l_pln:.6f}, first differences {same}; B7 launches "
        f"{c_tel['bfp_quantize']} (expected {want_b7}) by route "
        f"{b7_routes}")
    if l_tel != l_pln or any(v is not None for v in same.values()):
        fail(f"train-sr: the stochastic telemetry step differs from the "
             f"plain step: {l_tel} vs {l_pln}, {same}")
    if c_tel["bfp_quantize"] != want_b7 or b7_routes["split"]:
        fail(f"train-sr: B7 launches {c_tel['bfp_quantize']} != {want_b7} "
             f"or not all banded: {b7_routes}")
    del steps, tel, pln
    torch.cuda.empty_cache()
    # resume: SR_STEPS uninterrupted against preempted at 3, resumed at 2
    base = os.path.join(ROOT, "build", "sr_ckpt")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    free = shutil.disk_usage(base).free / 1e9
    log(f"{tag} free disk at {base}: {free:.1f} GB (needs {SR_DISK_GB})")
    if free < SR_DISK_GB:
        fail(f"train-sr needs {SR_DISK_GB} GB of free disk, {free:.1f} GB "
             f"free")
    t0 = time.perf_counter()

    def trainer(**kw):
        return Trainer(train_step=make_step(arch, pol, sched),
                       init_state=init_train_state(0, arch),
                       data_fn=pipe.batch, seed=SR_SEED, **kw)

    straight = trainer().run(SR_STEPS, log_every=0)[0]
    d = os.path.join(base, "run")
    try:
        trainer(ckpt_dir=d, ckpt_every=2, keep=1).run(
            SR_STEPS, fail_at_step=3, log_every=0)
        fail("train-sr: the run was not preempted at step 3")
    except RuntimeError as e:
        if "simulated preemption at step 3" not in str(e):
            raise
    torch.cuda.empty_cache()
    tr_c = trainer(ckpt_dir=d)
    resumed_at = tr_c.start_step
    tr_c.ckpt_dir = None        # resumed: the proof needs no later save
    resumed = tr_c.run(SR_STEPS, log_every=0)[0]
    torch.cuda.synchronize()
    same = _state_differences(straight, resumed)
    out["resume"] = dict(resumed_at=resumed_at, steps=SR_STEPS,
                         differences=str(same),
                         seconds=time.perf_counter() - t0)
    log(f"{tag} {SR_STEPS} steps uninterrupted vs preempted at 3 and "
        f"resumed at {resumed_at}: first differences {same} "
        f"({out['resume']['seconds']:.1f} s with the checkpoints) | {card}")
    del tr_c, straight, resumed
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    if resumed_at != 2 or any(v is not None for v in same.values()):
        fail(f"train-sr: the resumed run (at {resumed_at}) differs from the "
             f"uninterrupted run: {same}")
    return out


# yi-9b serves at full width and 8 of its 48 layers (all 48 took ~115 s
# of the script's time limit, the eager runs host-bound; 16 until the
# stochastic mesh runs needed the time)
SERVE_LAYERS = 4        # 8 until PR 30 (the script's time)
SERVE_LANES, SERVE_CTX, SERVE_NEW = 8, 1024, 32
SERVE_LOCKSTEP = 34     # ticks: past the first completions and refills
# one generate tick's B1 GEMM kernel as the profiler names it (fwd, not
# wgrad: the last two template flags false)
B1_GEMM = r"tc_gemm_kernel<\d+, \w+, \w+, false, false>"


PROFILE_PAD = 4000      # spin kernels before a profiled tick (see below)
# profiled ticks a lockstep may take: the profiler can drop a tick's
# records (a count it reports short), never add any
PROFILE_TRIES = 3


def _profile_tick(stage):
    """One call of the generate stage under torch.profiler: synchronized
    wall ms, the kernels' device ms, B1's device ms (its passes, GEMM and
    fold) and its GEMM launches; returns (stage output, numbers).

    After earlier profiler sessions in the process, a session can miss
    the records of the first kernels it sees (15-571 of a tick's ~9,700,
    graphed and eager alike, on the H100 with torch 2.11). So the window
    opens with PROFILE_PAD spin kernels, and the numbers leave the spins
    out: such a loss falls on the padding, never on the tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stage()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, pad = [], 0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        if "spin_kernel" in e.key:
            pad += e.count
        else:
            dev.append((e.key, getattr(e, "device_time_total", 0), e.count))
    busy = sum(us for _, us, _ in dev) / 1e3
    b1 = sum(us for k, us, _ in dev if "gemm_kernel" in k
             or "quantize_rows" in k or "fold_kernel" in k) / 1e3
    gemms = sum(n for k, _, n in dev if re.search(B1_GEMM, k))
    return out, dict(wall_ms=wall * 1e3, device_ms=busy, b1_ms=b1,
                     b1_gemm_launches=gemms,
                     kernels=sum(n for _, _, n in dev), pad_records=pad)


def _serve_run(tag, engine_kw, arch, params, pol, prompts, n_new, log_sink):
    """Drive one engine over the trace with a run-log (a MemorySink and
    the phase's JSONLSink, every event tagged `run=tag`). Returns the
    tokens, the request stats, the run-log's stage spans, B1's launches
    and the stage's graph counters."""
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.graph import GraphedStage
    mem = MemorySink()
    eng = ServeEngine(arch, params, pol,
                      recorder=Recorder([mem, log_sink], run_id=tag),
                      **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hm.reset_counts()                      # counts cover the main path only
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=n_new)
    res = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = [e.data for e in mem.of_kind("span")]
    fwd = hm.hbfp_matmul_fwd
    stage = eng._tick
    out = dict(tokens=res, stats=dict(eng.request_stats), wall_s=wall,
               step_ms=[d["dur_us"] / 1e3 for d in spans
                        if d["name"] == "serve/step"],
               prefills=sum(d["name"] == "serve/prefill" for d in spans),
               extends=sum(d["name"] == "serve/prefill" and "chunk" in d
                           for d in spans),
               launches=fwd.launches, routes=dict(fwd.launches_by_route),
               plain=fwd.plain_calls,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["ticks"] = len(out["step_ms"])
    if isinstance(stage, GraphedStage):
        out.update(graph_calls=stage.calls, replays=stage.replays,
                   per_replay=stage.per_replay["hbfp_matmul_fwd"])
    # the stage's bound method holds the engine in a reference cycle:
    # collect it, so the next engine does not share the device with it
    del eng, stage
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _check_serve_run(tag, r, arch, n_req, n_new, per_call, graphed):
    """The run's launch, route, span and replay checks: one serve/step
    span a generate tick (the stage's calls), every tick after the first
    a replay, B1's launches per replay recorded at capture."""
    ticks = r["ticks"]
    want = per_call * (r["prefills"] + ticks)
    if len(r["tokens"]) != n_req or any(len(t) != n_new
                                        for t in r["tokens"].values()):
        fail(f"{tag}: not every request completed: "
             f"{ {k: len(t) for k, t in r['tokens'].items()} }")
    if any(not 0 <= t < arch.vocab_size for ts in r["tokens"].values()
           for t in ts):
        fail(f"{tag}: token out of range")
    if r["launches"] != want or r["plain"] != 0 or r["launches"] == 0:
        fail(f"{tag}: B1 launches {r['launches']} != {want} or plain "
             f"{r['plain']}")
    if r["routes"]["bf16_wgmma"] != r["launches"]:
        fail(f"{tag}: a served B1 launch left the bf16 wgmma route: "
             f"{r['routes']}")
    if not graphed:
        return
    per = r["per_replay"]
    if r["graph_calls"] != ticks or r["replays"] != ticks - 1:
        fail(f"{tag}: {ticks} serve/step spans, stage calls "
             f"{r['graph_calls']}, replays {r['replays']}: a tick left no "
             f"span or a tick after the first was no replay")
    if per != (per_call, {"int8_wgmma": 0, "bf16_wgmma": per_call,
                          "cuda_core": 0}):
        fail(f"{tag}: B1 launches per replay {per}, expected {per_call} "
             f"on bf16_wgmma")


def _serve_numbers(r, n_skip=2):
    """Tick wall ms (median of the ticks after the first n_skip: eager
    warm-up and capture), decode tokens/s over every tick, TTFT p50/p95."""
    steady = sorted(r["step_ms"][n_skip:])
    ttft = sorted(s["ttft_s"] for s in r["stats"].values())
    q = lambda xs, f: xs[min(len(xs) - 1, int(f * len(xs)))]
    dec = sum(len(t) - 1 for t in r["tokens"].values())
    return dict(tick_ms=q(steady, 0.5), tick_ms_first=r["step_ms"][:n_skip],
                decode_tok_s=dec / (sum(r["step_ms"]) / 1e3),
                ttft_p50_ms=q(ttft, 0.5) * 1e3,
                ttft_p95_ms=q(ttft, 0.95) * 1e3, peak_gib=r["peak_gib"],
                wall_s=r["wall_s"], ticks=r["ticks"])


def _lane_state(cache):
    """The cache tensors that hold lane state (the KV entry's and the
    recurrent states'): a paged pool without its spare last page, which
    takes the dropped writes of free lanes and unallocated slots in no
    defined order and is never read."""
    from repro_torch.models import PagedKVCache
    for key, c in cache.items():
        names = c._fields if hasattr(c, "_fields") else \
            [f"{key}[{j}]" for j in range(len(c))]
        for name, t in zip(names, c):
            if t is not None:
                spare = isinstance(c, PagedKVCache) and name != "page_table"
                yield name, t[:, :-1] if spare else t


def _lockstep(kw, arch, params, pol, prompts, n_new, ticks, per_call,
              profile_at=20):
    """A graphed and an eager engine stepped together: the step outputs
    and every tick's logits equal, then the lane state of the cache, bit
    for bit. Tick `profile_at` of each (none when None) runs under the
    profiler: the replay must run exactly the recorded B1 launches. A
    profile that reports fewer (the profiler dropped records; every tick
    runs the same launches) is taken again on the next tick, up to
    PROFILE_TRIES ticks; one that reports more fails at once. Returns the
    two profiled ticks' numbers and the graphed stage's launches per
    replay."""
    import torch
    from repro_torch.serve import ServeEngine
    g = ServeEngine(arch, params, pol, **kw)
    e = ServeEngine(arch, params, pol, cuda_graph=False, **kw)
    for eng in (g, e):
        for p in prompts:
            eng.submit(p, max_new_tokens=n_new)
    prof, tries = {}, {"graphed": [], "eager": []}
    for t in range(ticks):
        outs = []
        for tag, eng in (("graphed", g), ("eager", e)):
            stage = eng._tick
            if profile_at is not None and tag not in prof and \
                    profile_at <= t < profile_at + PROFILE_TRIES:
                def profiled(stage=stage, tag=tag):
                    out, n = _profile_tick(stage)
                    tries[tag].append(n["b1_gemm_launches"])
                    if n["b1_gemm_launches"] >= per_call:
                        prof[tag] = n
                    return out
                eng._tick = profiled
            outs.append(eng.step())
            eng._tick = stage
        if outs[0] != outs[1]:
            fail(f"lockstep {kw}: tick {t} tokens differ")
        if not torch.equal(g.tick_logits, e.tick_logits):
            d = float((g.tick_logits - e.tick_logits).abs().max())
            fail(f"lockstep {kw}: tick {t} logits differ by {d}")
    for (name, a), (_, b) in zip(_lane_state(g.cache), _lane_state(e.cache)):
        if not torch.equal(a, b):
            fail(f"lockstep {kw}: cache {name} differs after {ticks} ticks")
    if g._tick.replays != ticks - 1:
        fail(f"lockstep {kw}: {g._tick.replays} replays in {ticks} ticks")
    for tag, n in prof.items():
        if n["b1_gemm_launches"] != per_call:
            fail(f"lockstep {kw}: the profiled {tag} tick ran "
                 f"{n['b1_gemm_launches']} B1 GEMM kernels, recorded "
                 f"{per_call} a tick ({n['kernels']} kernels, "
                 f"{n['pad_records']} of {PROFILE_PAD} padding records)")
        if len(tries[tag]) > 1:
            log(f"lockstep {kw}: the {tag} tick profiled {len(tries[tag])} "
                f"times, B1 GEMM kernels seen {tries[tag]} of {per_call}")
    if profile_at is not None and len(prof) != 2:
        fail(f"lockstep {kw}: no profiled tick from {profile_at} ran the "
             f"recorded {per_call} B1 GEMM kernels: {tries}")
    per_replay = g._tick.per_replay
    del g, e
    gc.collect()
    torch.cuda.empty_cache()
    return prof, per_replay


def _sampled_solo_crowded(arch, params, pol, prompts, n_new):
    """Top-k/top-p sampling under the graph: each request draws the same
    tokens alone (one engine serving the requests one after another, so
    rids match) as in the full batch."""
    import torch
    from repro_torch.serve import SamplingParams, ServeEngine
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=5)
    kw = dict(max_batch=SERVE_LANES, ctx_len=SERVE_CTX, sampling=sp)
    crowded = ServeEngine(arch, params, pol, **kw)
    for p in prompts:
        crowded.submit(p, max_new_tokens=n_new)
    want = crowded.drain()
    solo = ServeEngine(arch, params, pol, **kw)
    for rid, p in enumerate(prompts):
        if solo.submit(p, max_new_tokens=n_new) != rid:
            fail("sampled solo run: rids out of step")
        got = solo.drain()[rid]
        if got != want[rid]:
            fail(f"sampled request {rid}: solo {got} != crowded "
                 f"{want[rid]}")
    n = (crowded._tick.replays, solo._tick.replays)
    distinct = sum(len(set(t)) for t in want.values())
    del crowded, solo
    gc.collect()
    torch.cuda.empty_cache()
    return n, distinct


def phase_serve(card: str):
    import torch
    from repro_torch.models import init_params
    from repro_torch.obs import JSONLSink
    from repro_torch.precision import parse_policy
    arch, depth = _at_depth("yi-9b", SERVE_LAYERS)
    pol = parse_policy("8; backend=pallas")
    t0 = time.perf_counter()
    params = init_params(0, arch)
    torch.cuda.synchronize()
    log(f"[serve] yi-9b full width, {depth}, "
        f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B, "
        f"init {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(42)
    lens = [32 + (512 - 32) * i // 11 for i in range(12)]
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    per_call = 7 * arch.n_layers + 1
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "serve_run.jsonl")
    sink = JSONLSink(log_path, mode="w")
    lanes = dict(max_batch=SERVE_LANES, ctx_len=SERVE_CTX)
    runs, numbers = {}, {}
    for mode, paged in (("paged", True), ("slab", False)):
        for graphed in (True, False):
            tag = f"{mode}-{'graphed' if graphed else 'eager'}"
            r = _serve_run(tag, dict(paged=paged, cuda_graph=graphed,
                                     **lanes), arch, params, pol, prompts,
                           SERVE_NEW, sink)
            _check_serve_run(tag, r, arch, len(prompts), SERVE_NEW,
                             per_call, graphed)
            runs[tag], numbers[tag] = r, _serve_numbers(r)
            n = numbers[tag]
            log(f"[serve] {tag}: {len(r['tokens'])} requests, {r['ticks']} "
                f"generate ticks, {r['prefills']} prefills, B1 launches "
                f"{r['launches']} (all bf16_wgmma), replays "
                f"{r.get('replays', '-')}, per replay "
                f"{r.get('per_replay', ('-',))[0]}")
            log(f"[serve] {tag}: tick {n['tick_ms']:.2f} ms wall (median "
                f"after the first two; first two "
                f"{', '.join(f'{x:.1f}' for x in n['tick_ms_first'])} ms), "
                f"decode {n['decode_tok_s']:.1f} tok/s, TTFT p50 "
                f"{n['ttft_p50_ms']:.1f} ms p95 {n['ttft_p95_ms']:.1f} ms, "
                f"peak {n['peak_gib']:.2f} GiB, wall {n['wall_s']:.2f} s "
                f"| {card}")
    toks = {t: r["tokens"] for t, r in runs.items()}
    if any(v != toks["paged-graphed"] for v in toks.values()):
        fail("graphed and eager, paged and slab, give different tokens")
    log("[serve] graphed == eager == paged == slab greedy tokens on the "
        "whole trace")
    for mode, paged in (("paged", True), ("slab", False)):
        prof, _ = _lockstep(dict(paged=paged, **lanes), arch, params, pol,
                         prompts, SERVE_NEW, SERVE_LOCKSTEP, per_call)
        for kind, n in prof.items():
            numbers[f"{mode}-{kind}"]["profiled_tick"] = n
            log(f"[serve] {mode}-{kind}: profiled tick {n['wall_ms']:.2f} "
                f"ms wall, {n['device_ms']:.2f} ms of kernels (device idle "
                f"{1 - n['device_ms'] / n['wall_ms']:.1%}), B1 "
                f"{n['b1_ms']:.2f} ms in {n['b1_gemm_launches']} GEMM "
                f"launches, {n['kernels']} kernels | {card}")
    log(f"[serve] graphed == eager over {SERVE_LOCKSTEP} lockstep ticks, "
        f"paged and slab: tokens, every tick's logits, the cache's lane "
        f"state bit for bit; the profiled replays ran {per_call} B1 GEMM "
        f"launches each")
    replays, distinct = _sampled_solo_crowded(arch, params, pol, prompts,
                                              SERVE_NEW // 2)
    log(f"[serve] sampled (top-k 40, top-p 0.9, T 0.8), graphed: solo == "
        f"crowded for all {len(prompts)} requests (replays {replays}, "
        f"{distinct} distinct tokens)")
    r = _serve_run("async-graphed", dict(prefill_chunk=128,
                                         async_prefill=True, **lanes),
                   arch, params, pol, [prompts[7]], SERVE_NEW, sink)
    _check_serve_run("async-graphed", r, arch, 1, SERVE_NEW, per_call, True)
    log(f"[serve] async chunked prefill (chunk 128, prompt {lens[7]}): "
        f"{r['extends']} extend calls, {r['ticks']} ticks, {r['replays']} "
        f"replays, B1 launches {r['launches']}")
    if r["extends"] == 0:
        fail("async chunked prefill ran no extend stage")
    sink.close()
    log(f"[serve] run-log: {os.path.relpath(log_path, ROOT)}")
    return runs["paged-graphed"]["launches"], numbers


# recurrent: the hybrid and xLSTM families (ROADMAP A12.1-2) at full
# width, trained and served at 8 of their layers (hymba's 32 and xlstm's
# 24 took ~135 s of the script's time limit; xlstm's 8 hold one sLSTM
# layer, its 8th). hymba-1.5b trains on 1 x 4096 tokens (its 1,024-token
# sliding window on the sim path, the chunk scan in 32 chunks), xlstm-350m
# on 1 x 2048 (its sLSTM scan runs token by token); the profiled step is
# split by these regions
REC_LAYERS = {"hymba-1.5b": 4, "xlstm-350m": 4}     # cut from 8 for time
REC_TRAIN = (("hymba-1.5b", 4096, ("chunk scan", "sim attention")),
             ("xlstm-350m", 2048, ()))
# xlstm's step is timed, not profiled: the time in its sLSTM loops
# (forward, remat recompute and backward through time) over the counted
# steps is its share (profiling its ~10^6 tiny kernels costs minutes)
REC_TIMED = {"xlstm-350m": ("repro_torch.models.xlstm", "_run_loop")}
# both served with 8 lanes at ctx_len 2048 (hymba's lane ring: its 1,024
# window): 8 requests of 16 new tokens; hymba's first prompt is longer
# than the window, so it takes the chunked prefill and its ring wraps
REC_LANES, REC_CTX, REC_NEW = 8, 2048, 16
REC_LENS = (1500,) + tuple(64 + 64 * i for i in range(7))
# B1-B3 at the shapes only these paths give them, held to their plain
# versions: (name, M, K, N, B1/B2 routes). hymba's K 1600 and N 6457 are
# padded to the 128-tiles (1664, 6528) as kernels/linear.py pads them;
# xLSTM's gate projection has N = 8: B1 contracts over K in 128-int8
# stages (int8 wgmma), B2 contracts over N, less than one stage (the CUDA
# cores)
REC_KERNEL_CASES = (
    ("hymba_ssm_in", 4096, 1664, 6528,
     {"hbfp_matmul_fwd": "int8_wgmma", "hbfp_dgrad": "int8_wgmma"}),
    ("hymba_ssm_out", 4096, 3200, 1664,
     {"hbfp_matmul_fwd": "int8_wgmma", "hbfp_dgrad": "int8_wgmma"}),
    ("xlstm_gates", 2048, 1024, 8,
     {"hbfp_matmul_fwd": "int8_wgmma", "hbfp_dgrad": "cuda_core"}))


def _rec_serve(card: str, arch_name: str, n_layers: int, modes,
               sink) -> dict:
    """`arch_name` at full width and `n_layers` of its depth (random seeded
    bf16 weights) served under
    "8; backend=pallas": each of `modes` (paged, slab) graphed and eager
    over the same requests (equal tokens, launches and routes checked),
    then graphed and eager in lockstep (tokens, every tick's logits, the
    KV and recurrent states bit for bit, the profiled replay's B1
    launches)."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    arch, depth = _at_depth(arch_name, n_layers)
    pol = parse_policy("8; backend=pallas")
    t0 = time.perf_counter()
    params = init_params(0, arch)
    torch.cuda.synchronize()
    tag = f"[recurrent serve {arch_name}]"
    log(f"{tag} full width, {depth}, params "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B, init "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(43)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=g).tolist()
               for n in REC_LENS]
    per_call = _projections(arch) + 1
    lanes = dict(max_batch=REC_LANES, ctx_len=REC_CTX)
    runs, numbers = {}, {}
    for paged in modes:
        mode = "paged" if paged else "slab"
        for graphed in (True, False):
            name = f"{arch_name}-{mode}-{'graphed' if graphed else 'eager'}"
            r = _serve_run(name, dict(paged=paged, cuda_graph=graphed,
                                      **lanes), arch, params, pol, prompts,
                           REC_NEW, sink)
            _check_serve_run(name, r, arch, len(prompts), REC_NEW, per_call,
                             graphed)
            if arch.ssm and r["extends"] < 2:
                fail(f"{name}: the {REC_LENS[0]}-token prompt took "
                     f"{r['extends']} extend calls, expected the chunked "
                     f"prefill")
            runs[name], numbers[name] = r, _serve_numbers(r)
            n = numbers[name]
            log(f"{tag} {mode}-{'graphed' if graphed else 'eager'}: "
                f"{r['ticks']} ticks, {r['prefills']} prefill calls "
                f"({r['extends']} chunked-prefill extends), B1 launches "
                f"{r['launches']} (all bf16_wgmma), per replay "
                f"{r.get('per_replay', ('-',))[0]}; tick {n['tick_ms']:.2f}"
                f" ms wall (median after the first two), decode "
                f"{n['decode_tok_s']:.1f} tok/s, TTFT p50 "
                f"{n['ttft_p50_ms']:.1f} ms p95 {n['ttft_p95_ms']:.1f} ms, "
                f"peak {n['peak_gib']:.2f} GiB | {card}")
    toks = [r["tokens"] for r in runs.values()]
    if any(t != toks[0] for t in toks):
        fail(f"{arch_name}: graphed and eager, paged and slab, give "
             f"different tokens")
    for paged in modes:
        mode = "paged" if paged else "slab"
        prof, _ = _lockstep(dict(paged=paged, **lanes), arch, params, pol,
                         prompts, REC_NEW, REC_NEW - 1, per_call,
                         profile_at=REC_NEW // 2)
        for kind, n in prof.items():
            numbers[f"{arch_name}-{mode}-{kind}"]["profiled_tick"] = n
            log(f"{tag} {mode}-{kind}: profiled tick {n['wall_ms']:.2f} ms "
                f"wall, {n['device_ms']:.2f} ms of kernels (device idle "
                f"{1 - n['device_ms'] / n['wall_ms']:.1%}), B1 "
                f"{n['b1_ms']:.2f} ms in {n['b1_gemm_launches']} GEMM "
                f"launches, {n['kernels']} kernels | {card}")
    log(f"{tag} graphed == eager over {REC_NEW - 1} lockstep ticks "
        f"({', '.join('paged' if p else 'slab' for p in modes)}): tokens, "
        f"every tick's logits, the KV and recurrent states bit for bit; "
        f"{per_call} B1 launches a replay")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=sum(r["launches"] for r in runs.values()),
                numbers=numbers)


def phase_recurrent(card: str) -> dict:
    """hymba-1.5b (attention and a mamba branch in parallel) and
    xlstm-350m: (a) each family's smoke model, one training step and a
    served trace on the card against the CPU; B1-B3 at the shapes only
    these paths give them against their plain versions; (b, c) both at
    full width through the Trainer (exact B1-B3 launches and routes;
    hymba's profiled step split by model region, xlstm's sLSTM loops
    timed); (d) both served at full width, graphed against eager."""
    import torch
    t0 = time.perf_counter()
    smoke = {}
    for a in ("hymba-1.5b", "xlstm-350m"):
        smoke[a] = dict(train=phase_train(a))
    smoke["hymba-1.5b"]["serve"] = {
        m: _smoke_serve("[recurrent]", "hymba-1.5b", (5, 9, 21), paged=p)
        for m, p in (("paged", True), ("slab", False))}
    smoke["xlstm-350m"]["serve"] = {
        "slab": _smoke_serve("[recurrent]", "xlstm-350m", (5, 9, 21))}
    gen = torch.Generator(device="cuda").manual_seed(2323)
    kernel_rows = []
    for name, M, K, N, routes in REC_KERNEL_CASES:
        kernel_rows += _bwd_case(name, M, K, N, True, 8, 0, False, gen,
                                 "recurrent", route=routes)
        torch.cuda.empty_cache()
    log(f"[time] recurrent smoke and kernels done at "
        f"{time.perf_counter() - t0:.1f} s of the phase")
    train = {}
    for arch_name, T, regions in REC_TRAIN:
        arch, _ = _at_depth(arch_name, REC_LAYERS[arch_name])
        # xLSTM: every mLSTM layer's gate dgrad (N = 8) takes the CUDA
        # cores, in each of the 3 counted steps
        gates = 3 * sum(i % arch.slstm_every != arch.slstm_every - 1
                        for i in range(arch.n_layers)) if arch.xlstm else 0
        train[arch_name] = phase_train_full(
            card, arch_name, 1, T, n_layers=REC_LAYERS[arch_name],
            phase="recurrent", regions=regions,
            b2_cuda_core=gates, profile=bool(regions),
            timed=REC_TIMED.get(arch_name))
        r = train[arch_name]
        log(f"[time] recurrent {arch_name} training done at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
        if r["profile"] is not None:
            sh = r["profile"]["share"]
            b123 = sum(v for k, v in sh.items() if k.startswith(
                ("B1", "B2", "B3", "f32 quantize")))
            log(f"[recurrent {arch_name}] profiled step by region: "
                + ", ".join(f"{k} {sh[k]:.1%}" for k in regions)
                + f", B1-B3 {b123:.1%}, the rest "
                f"{sh['everything else']:.1%} ({r['profile']['kernels']} "
                f"kernels, analysed in {r['profile']['analysis_s']:.1f} s)")
            for row in r["profile"]["top"][:8]:
                log(f"[recurrent {arch_name}]   {row['ms']:9.2f} ms "
                    f"{row['count']:7d}  {row['kernel']}")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[time] recurrent training done at {time.perf_counter() - t0:.1f} "
        f"s of the phase")
    from repro_torch.obs import JSONLSink
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    sink = JSONLSink(os.path.join(out_dir, "recurrent_serve_run.jsonl"),
                     mode="w")
    serve = {"hymba-1.5b": _rec_serve(card, "hymba-1.5b",
                                      REC_LAYERS["hymba-1.5b"],
                                      (True, False), sink)}
    log(f"[time] recurrent hymba serving done at "
        f"{time.perf_counter() - t0:.1f} s of the phase")
    serve["xlstm-350m"] = _rec_serve(card, "xlstm-350m",
                                     REC_LAYERS["xlstm-350m"], (False,),
                                     sink)
    sink.close()
    log(f"[time] recurrent phase {time.perf_counter() - t0:.1f} s")
    return dict(smoke=smoke, kernel_rows=kernel_rows, train=train,
                serve=serve, seconds=time.perf_counter() - t0)


# moe: the MoE family (ROADMAP A12.3) at full width. llama4-scout (16
# experts, top-1, a shared expert) trains at 1 of its 48 layers on 1 x
# 2048 tokens (its f32 master, moments and grads at ~16 bytes a
# parameter: 4.27 B parameters fill the card) and serves at 3 of 48 (6
# until PR 30);
# arctic-480b (128 experts, top-2, a dense residual) serves at 1 of 35
# (one layer's experts are 27 GB in bf16). The expert GEMMs' weights are
# 3-D and take the sim path, as in the reference; attention, the shared
# expert or dense residual and the head take B1-B6
MOE_TRAIN = ("llama4-scout-17b-a16e", 1, 2048)
MOE_SERVE = (("llama4-scout-17b-a16e", 3, (True, False)),
             ("arctic-480b", 1, (False,)))
MOE_LANES, MOE_CTX, MOE_NEW = 8, 1024, 16
MOE_LENS = tuple(32 + (512 - 32) * i // 7 for i in range(8))
# the training step's profile split: the expert GEMMs (the sim path's
# per-call weight quantization and batched matmuls, their backward
# included), the rest of the MoE layer (routing, dispatch and combine,
# the experts' gating), the optimizer and the narrowing of the weights
MOE_REGIONS = ("expert GEMMs", "MoE routing", "optimizer", "narrowing")
# B1-B3 at the shapes only these paths give them, (K, N) with N padded to
# whole 128-value tiles as kernels/linear.py pads it (202,048 -> 202,112)
MOE_SHAPES = {
    "llama4": {"wq": (5120, 5120), "wkv": (5120, 1024),
               "shared_wgi": (5120, 8192), "shared_wo": (8192, 5120),
               "head": (5120, 202112)},
    "arctic": {"wq": (7168, 7168), "wkv": (7168, 1024),
               "ffn_wgi": (7168, 4864), "ffn_wo": (4864, 7168),
               "head": (7168, 32000)}}
MOE_TRAIN_ROUTES = {"hbfp_matmul_fwd": "int8_wgmma",
                    "hbfp_dgrad": "int8_wgmma"}


def _served_b1_case(name, K, N, gen, phase="moe"):
    """B1 as a generate tick runs it (M = 8 bf16 rows, weights narrowed
    at 8 bits in 128 x 128 tiles and taken as stored) against its plain
    version: bit-equal, on bf16 wgmma, timed."""
    import torch
    from repro_torch.core import HBFP8_16, bfp
    from repro_torch.kernels import autotune
    from repro_torch.kernels import hbfp_matmul as hm
    M = 8
    w = bfp.quantize_weight(torch.randn((K, N), generator=gen,
                                        device="cuda") * K ** -0.5,
                            HBFP8_16).to(torch.bfloat16)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    bm, bk, bn = autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N)
    kw = dict(mantissa_bits=8, stochastic=False, quantize_w=False, block=0,
              bm=bm, bk=bk, bn=bn)
    run = lambda: hm.hbfp_matmul_fwd(x, w, 0, **kw)
    before = dict(hm.hbfp_matmul_fwd.launches_by_route)
    yk, yp = run(), hm.hbfp_matmul_plain(x, w, 0, **kw)
    torch.cuda.synchronize()
    took = [r for r, n in hm.hbfp_matmul_fwd.launches_by_route.items()
            if n != before[r]]
    ok = torch.equal(yk, yp) and torch.isfinite(yk).all()
    err = float((yk - yp).abs().max())
    bound, by = _bound_ms(M, K, N, 2, 2, "bf16")
    kms = _time_ms(run, _reps(run))
    pms = _time_ms(lambda: hm.hbfp_matmul_plain(x, w, 0, **kw), 2)
    row = dict(kernel="hbfp_matmul_fwd", weight=name, M=M, K=K, N=N,
               config=f"{phase}_served", route=took[0] if len(took) == 1
               else str(took), ok=bool(ok), check="EQ", max_abs_err=err,
               err_over_bound=None, kernel_ms=kms, plain_ms=pms,
               bound_ms=bound, bound_by=by)
    log(f"[{phase} kernel] B1 {name} 8x{K}x{N} served {row['route']} EQ "
        f"err={err:.3g} kernel_ms={kms:.4f} bound_ms={bound:.4f}({by[0]}) "
        f"plain_ms={pms:.2f}")
    if not ok or took != ["bf16_wgmma"]:
        fail(f"{phase} served B1 {name}: {row}")
    del w, x, yk, yp
    return row


def _moe_serve(card: str, arch_name: str, n_layers: int, modes, sink):
    """`arch_name` at full width and `n_layers` of its depth (random
    seeded bf16 weights) served under "8; backend=pallas": the serving
    copy narrowed once and the raw weights freed, every engine then
    serving that copy (`narrowed=True`); each of `modes` (paged, slab)
    graphed and eager over the same 8 requests (equal tokens, launches
    and routes checked), then graphed and eager in lockstep (tokens,
    every tick's logits and the KV bit for bit, the profiled replay's B1
    launches). A tick's 8 lanes are one routing group: capacity couples
    them, so no solo == crowded proof is asked."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    from repro_torch.train.serve_step import narrow_serving_params
    full = get_arch(arch_name)
    arch = dataclasses.replace(full, n_layers=n_layers)
    pol = parse_policy("8; backend=pallas")
    tag = f"[moe serve {arch_name}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = init_params(0, arch)
    n_raw = sum(t.numel() for t in _leaves(raw))
    params = narrow_serving_params(raw, arch, pol)
    del raw
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} full width, {n_layers} of {full.n_layers} layers (depth "
        f"cut), {arch.n_experts} experts top-{arch.top_k}, "
        f"{n_raw / 1e9:.3f} B params; init and narrowing "
        f"{time.perf_counter() - t0:.1f} s, peak {load_peak:.2f} GiB "
        f"(raw and narrowed weights together) | {card}")
    g = torch.Generator().manual_seed(44)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=g).tolist()
               for n in MOE_LENS]
    per_call = _projections(arch) + 1
    lanes = dict(max_batch=MOE_LANES, ctx_len=MOE_CTX, narrowed=True)
    runs, numbers = {}, {}
    for paged in modes:
        mode = "paged" if paged else "slab"
        for graphed in (True, False):
            name = f"{arch_name}-{mode}-{'graphed' if graphed else 'eager'}"
            r = _serve_run(name, dict(paged=paged, cuda_graph=graphed,
                                      **lanes), arch, params, pol, prompts,
                           MOE_NEW, sink)
            _check_serve_run(name, r, arch, len(prompts), MOE_NEW, per_call,
                             graphed)
            runs[name], numbers[name] = r, _serve_numbers(r)
            n = numbers[name]
            log(f"{tag} {mode}-{'graphed' if graphed else 'eager'}: "
                f"{r['ticks']} ticks, {r['prefills']} prefills, B1 launches "
                f"{r['launches']} (all bf16_wgmma), per replay "
                f"{r.get('per_replay', ('-',))[0]}; tick {n['tick_ms']:.2f}"
                f" ms wall (median after the first two), decode "
                f"{n['decode_tok_s']:.1f} tok/s, TTFT p50 "
                f"{n['ttft_p50_ms']:.1f} ms p95 {n['ttft_p95_ms']:.1f} ms, "
                f"peak {n['peak_gib']:.2f} GiB | {card}")
    toks = [r["tokens"] for r in runs.values()]
    if any(t != toks[0] for t in toks):
        fail(f"{arch_name}: graphed and eager, paged and slab, give "
             f"different tokens")
    for paged in modes:
        mode = "paged" if paged else "slab"
        prof, _ = _lockstep(dict(paged=paged, **lanes), arch, params, pol,
                         prompts, MOE_NEW, MOE_NEW - 1, per_call,
                         profile_at=MOE_NEW // 2)
        for kind, n in prof.items():
            numbers[f"{arch_name}-{mode}-{kind}"]["profiled_tick"] = n
            log(f"{tag} {mode}-{kind}: profiled tick {n['wall_ms']:.2f} ms "
                f"wall, {n['device_ms']:.2f} ms of kernels (device idle "
                f"{1 - n['device_ms'] / n['wall_ms']:.1%}), B1 "
                f"{n['b1_ms']:.2f} ms in {n['b1_gemm_launches']} GEMM "
                f"launches, {n['kernels']} kernels | {card}")
    log(f"{tag} graphed == eager over {MOE_NEW - 1} lockstep ticks "
        f"({', '.join('paged' if p else 'slab' for p in modes)}): tokens, "
        f"every tick's logits and the KV bit for bit; {per_call} B1 "
        f"launches a replay")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=n_layers, params=n_raw, load_peak_gib=load_peak,
                launches=sum(r["launches"] for r in runs.values()),
                numbers=numbers)


def phase_moe(card: str) -> dict:
    """llama4-scout-17b-a16e and arctic-480b: (a) each smoke model, one
    training step and a served trace (paged and slab) on the card against
    the CPU; (b) B1 at both archs' served shapes (M = 8) and B1-B3 at
    llama4's training shapes (M = 2048) against their plain versions,
    routes checked; (c) llama4 at full width, 1 of 48 layers, trained
    through the Trainer (exact B1-B6 launches and routes, no B7, the aux
    loss per layer near 1, the profiled step split by region); (d, e)
    llama4 (3 of 48 layers) and arctic (1 of 35) served at full width,
    graphed against eager."""
    import torch
    from repro_torch.kernels import bfp_quantize as bq
    t0 = time.perf_counter()
    smoke = {}
    for a in ("llama4-scout-17b-a16e", "arctic-480b"):
        smoke[a] = dict(train=phase_train(a), serve={
            m: _smoke_serve("[moe]", a, (5, 9, 17), paged=p)
            for m, p in (("paged", True), ("slab", False))})
    gen = torch.Generator(device="cuda").manual_seed(2424)
    kernel_rows = []
    for fam, shapes in MOE_SHAPES.items():
        for w, (K, N) in shapes.items():
            kernel_rows.append(_served_b1_case(f"{fam}_{w}", K, N, gen))
            torch.cuda.empty_cache()
    for w, (K, N) in MOE_SHAPES["llama4"].items():
        kernel_rows += _bwd_case(f"llama4_{w}", MOE_TRAIN[2], K, N, True, 8,
                                 0, False, gen, "moe", route=MOE_TRAIN_ROUTES)
        torch.cuda.empty_cache()
    log(f"[time] moe smoke and kernels done at "
        f"{time.perf_counter() - t0:.1f} s of the phase")
    arch_name, layers, T = MOE_TRAIN
    gc.collect()
    torch.cuda.empty_cache()
    bq.reset_counts()
    # the step fills the card (47.7 GiB of f32 master and moments, 8 GiB
    # of grads, GB-sized temporaries of the head and the experts): its
    # allocations map pages of expandable segments, so the temporaries
    # of the backward leave no fragments behind for the optimizer
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        train = phase_train_full(card, arch_name, 1, T, n_layers=layers,
                                 phase="moe", regions=MOE_REGIONS)
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    b7 = bq.bfp_quantize.launches
    per_layer = [a / layers for a in train["aux"]]
    log(f"[moe {arch_name}] aux per layer over the steps "
        f"{[round(a, 4) for a in per_layer]}; B7 launches {b7}")
    if b7 or not all(0.5 < a < 2.5 for a in per_layer):
        fail(f"{arch_name}: B7 launched {b7} times, or an aux per layer "
             f"outside (0.5, 2.5): {per_layer}")
    prof = train["profile"]
    if prof is not None:
        sh = prof["share"]
        kern = sum(v for k, v in sh.items() if k.startswith(
            ("B1", "B2", "B3", "B4", "B5", "B6", "f32 quantize")))
        log(f"[moe {arch_name}] profiled step by region: "
            + ", ".join(f"{k} {sh[k]:.1%}" for k in MOE_REGIONS)
            + f", B1-B6 {kern:.1%}, the rest {sh['everything else']:.1%} "
            f"({prof['kernels']} kernels, analysed in "
            f"{prof['analysis_s']:.1f} s)")
        for row in prof["top"][:8]:
            log(f"[moe {arch_name}]   {row['ms']:9.2f} ms "
                f"{row['count']:7d}  {row['kernel']}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] moe training done at {time.perf_counter() - t0:.1f} s of "
        f"the phase")
    from repro_torch.obs import JSONLSink
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    sink = JSONLSink(os.path.join(out_dir, "moe_serve_run.jsonl"), mode="w")
    serve = {}
    for name, n_layers, modes in MOE_SERVE:
        serve[name] = _moe_serve(card, name, n_layers, modes, sink)
        log(f"[time] moe {name} serving done at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
    sink.close()
    log(f"[time] moe phase {time.perf_counter() - t0:.1f} s")
    return dict(smoke=smoke, kernel_rows=kernel_rows, train=train,
                serve=serve, seconds=time.perf_counter() - t0)


# vlm_audio: the last two families (ROADMAP A12.4-5) at full width, both
# fed embeddings by a stub frontend. qwen2-vl-72b (M-RoPE, GQA 8, d_ff
# 29,568, vocab 152,064) trains at 3 of its 80 layers on 1 x 4096 tokens
# (3.879 B parameters: 0.878 B a layer and a 1.246-B head, ~46.5 GB of f32
# master and moments) and serves at 8 of 80 (16 until PR 30);
# musicgen-large (four codebook heads of 2,048 words) trains and serves
# at 12 of its 48 layers (48, then 24, cut for the script's time), on 2 x
# 1536 frames (MusicGen trains on 30-s segments of 1,500 frames at 50
# Hz). (name, layers (0 = all), B, S)
VA_TRAIN = (("qwen2-vl-72b", 3, 1, 4096), ("musicgen-large", 12, 2, 1536))
VA_SERVE = (("qwen2-vl-72b", 8), ("musicgen-large", 12))
# served: 8 lanes, a slab cache of 1,024 slots, a prefill of 512 seeded
# frames a lane, then VA_TICKS decode ticks on seeded next-frame
# embeddings (no token feedback: the frontend supplies each frame); the
# tick at VA_PROFILE_AT of each run is profiled
VA_LANES, VA_CTX, VA_PROMPT, VA_TICKS, VA_PROFILE_AT = 8, 1024, 512, 32, 16
# B1-B3 at the training shapes only these paths give them, {weight: (M,
# K, N)}: the projections at the step's tokens, a head at its CE chunk's
# (qwen2-vl's 4,096 tokens in two chunks of 2,048; musicgen's 3,072 in
# one, so its four heads share the projections' shape); every N and K is
# a whole number of 128-value stages; B1 also at M = 8 (the generate
# tick) on the same weights
VA_SHAPES = {
    "qwen2vl": {"wq": (4096, 8192, 8192), "wkv": (4096, 8192, 1024),
                "ffn_wgi": (4096, 8192, 29568),
                "ffn_wo": (4096, 29568, 8192),
                "head": (2048, 8192, 152064)},
    "musicgen": {"wqkvo_head": (3072, 2048, 2048),
                 "ffn_wgi": (3072, 2048, 8192),
                 "ffn_wo": (3072, 8192, 2048)}}
VA_REGIONS = ("optimizer", "narrowing")


def _grid_positions(b: int, s: int):
    """[3, b, s] int32 M-RoPE positions of 4 text tokens, a 2 x 4 image
    and text again: text has t = h = w, the image's patches share t and
    take h and w from their row and column, the text after it resumes at
    the largest position + 1 (Qwen2-VL §2.1). s >= 16."""
    import torch
    p = torch.zeros((3, s), dtype=torch.int32)
    p[:, :4] = torch.arange(4)
    r, c = torch.arange(8) // 4, torch.arange(8) % 4
    p[0, 4:12], p[1, 4:12], p[2, 4:12] = 4, 4 + r, 4 + c
    p[:, 12:] = torch.arange(8, 8 + s - 12)
    return p[:, None].expand(3, b, s).contiguous()


def _text_positions(arch, b: int, s: int, device=None):
    """Text positions 0 .. s-1, [b, s] int32 ([3, b, s] under M-RoPE)."""
    import torch
    pos = torch.arange(s, dtype=torch.int32,
                       device=device)[None].expand(b, s)
    return (pos[None].expand(3, b, s) if arch.mrope else pos).contiguous()


def _smoke_stages(arch_name: str, grid: bool = False) -> dict:
    """`arch_name` smoke in f32 served through the serve-step stages on the
    card (kernel path) and on the CPU (plain path) from the same weights:
    a 12-frame prefill of 2 lanes over seeded embeddings (with an
    image-grid span when `grid`), then 4 decode steps on next-frame
    embeddings; every step's logits within 2e-3·max|cpu|."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    from repro_torch.train.serve_step import (make_decode_fn,
                                              make_prefill_fn,
                                              narrow_serving_params,
                                              prefill_to_decode_cache)
    arch = dataclasses.replace(get_arch(arch_name).smoke(), dtype="float32")
    pol = parse_policy("8; backend=pallas")
    B, P, n_dec = 2, 12, 4
    g = torch.Generator().manual_seed(12)
    emb = torch.randn((B, P + n_dec, arch.d_model), generator=g)
    pos = _grid_positions(B, P + n_dec) if grid else \
        _text_positions(arch, B, P + n_dec)
    p_cpu = init_params(7, arch, device="cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.cuda()
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", to(p_cpu))):
        sp = narrow_serving_params(params, arch, pol)
        pre = make_prefill_fn(arch, pol, device=dev)
        dec = make_decode_fn(arch, pol, device=dev)
        b = lambda s0, s1: {"embeds": emb[:, s0:s1].to(dev),
                            "positions": pos[..., s0:s1].to(dev)}
        lg, cache = pre(sp, b(0, P))
        cache = prefill_to_decode_cache(cache, arch, 32)
        steps = [lg.float().cpu()]
        for t in range(P, P + n_dec):
            lg, cache = dec(sp, b(t, t + 1), cache)
            steps.append(lg.float().cpu())
        out[dev] = steps
    K = arch.n_codebooks
    shape = (B, 1, K, arch.vocab_size) if K > 1 else (B, 1, arch.vocab_size)
    errs = []
    for a, c in zip(out["cpu"], out["cuda"]):
        if tuple(c.shape) != shape or not torch.isfinite(c).all():
            fail(f"{arch_name}: bad card logits {tuple(c.shape)}")
        errs.append(float((a - c).abs().max() / a.abs().max()))
    log(f"[vlm_audio] {arch_name} smoke f32 stages{' image grid' if grid else ''}"
        f" card vs cpu: prefill and {n_dec} decode steps max|d|/max|cpu| "
        f"{[f'{e:.3g}' for e in errs]} (tol 2e-3)")
    if max(errs) > 2e-3:
        fail(f"{arch_name}: card stage logits disagree with the CPU path")
    return dict(grid=grid, rel_errs=errs)


def _clone_cache(cache):
    return {k: type(c)(*(None if t is None else t.clone() for t in c))
            for k, c in cache.items()}


def _va_serve(card: str, arch_name: str, n_layers: int) -> dict:
    """`arch_name` at full width and `n_layers` of its depth (0: all;
    random seeded bf16 weights) served through the serve-step stages under
    "8; backend=pallas": the serving copy narrowed once and the raw
    weights freed; a prefill of VA_LANES x VA_PROMPT seeded frames into a
    slab cache of VA_CTX slots; VA_TICKS decode ticks on seeded next-frame
    embeddings, the tick a `GraphedStage` over fixed input buffers
    (embeds [8,1,D], positions [3,8,1] or [8,1]); the same ticks eagerly
    from a clone of the prefill cache. Graphed == eager in every tick's
    logits and the cache, bit for bit; 7L + K B1 launches a replay, all
    bf16 wgmma, matched by the profiler on one replayed tick."""
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    from repro_torch.serve.graph import GraphedStage
    from repro_torch.train.serve_step import (make_decode_fn,
                                              make_prefill_fn,
                                              narrow_serving_params,
                                              prefill_to_decode_cache)
    arch, depth = _at_depth(arch_name, n_layers)
    L, K, D = arch.n_layers, arch.n_codebooks, arch.d_model
    pol = parse_policy("8; backend=pallas")
    tag = f"[vlm_audio serve {arch_name}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = init_params(0, arch)
    n_raw = sum(t.numel() for t in _leaves(raw))
    params = narrow_serving_params(raw, arch, pol)
    del raw
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} full width, {depth}, {n_raw / 1e9:.3f} B params; init and "
        f"narrowing {time.perf_counter() - t0:.1f} s, peak {load_peak:.2f} "
        f"GiB (raw and narrowed weights together) | {card}")
    torch.cuda.reset_peak_memory_stats()
    prefill_fn = make_prefill_fn(arch, pol)
    decode_fn = make_decode_fn(arch, pol)
    B, P = VA_LANES, VA_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(45)
    emb = torch.randn((B, P, D), generator=gen, device="cuda")
    nxt = torch.randn((VA_TICKS, B, 1, D), generator=gen, device="cuda")
    per_call = _projections(arch) + K
    hm.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lg0, cache = prefill_fn(params, {"embeds": emb})   # text positions
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    fwd = hm.hbfp_matmul_fwd
    pre_launches, pre_routes = fwd.launches, dict(fwd.launches_by_route)
    shape = (B, 1, K, arch.vocab_size) if K > 1 else (B, 1, arch.vocab_size)
    if tuple(lg0.shape) != shape or not torch.isfinite(lg0).all():
        fail(f"{arch_name}: bad prefill logits {tuple(lg0.shape)}")
    if pre_launches != per_call or pre_routes["bf16_wgmma"] != per_call:
        fail(f"{arch_name}: prefill B1 launches {pre_routes}, expected "
             f"{per_call} on bf16_wgmma")
    cache = prefill_to_decode_cache(cache, arch, VA_CTX)
    eager_cache = _clone_cache(cache)
    # the graphed tick's fixed input buffers
    e_buf = torch.empty((B, 1, D), device="cuda")
    p_buf = torch.empty_like(_text_positions(arch, B, 1, device="cuda"))
    batch = {"embeds": e_buf, "positions": p_buf}
    stage = GraphedStage(lambda: decode_fn(params, batch, cache)[0])
    runs, prof = {}, {}
    for kind in ("graphed", "eager"):
        hm.reset_counts()
        logits, tick_ms = [], []
        for t in range(VA_TICKS):
            e_buf.copy_(nxt[t])
            p_buf.fill_(P + t)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if kind == "graphed":
                run = stage
            else:
                run = lambda: decode_fn(params, {"embeds": nxt[t],
                                                 "positions": p_buf.clone()},
                                        eager_cache)[0]
            if t == VA_PROFILE_AT:
                out, prof[kind] = _profile_tick(run)
            else:
                out = run()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t1) * 1e3)
            logits.append(out.clone())
        runs[kind] = dict(logits=logits, tick_ms=tick_ms,
                          launches=fwd.launches,
                          routes=dict(fwd.launches_by_route))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g, e = runs["graphed"], runs["eager"]
    for t, (a, b) in enumerate(zip(g["logits"], e["logits"])):
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            fail(f"{arch_name}: bad tick {t} logits {tuple(a.shape)}")
        if not torch.equal(a, b):
            fail(f"{arch_name}: tick {t} logits graphed != eager by "
                 f"{float((a - b).abs().max())}")
    for key in cache:
        for name, a, b in zip(cache[key]._fields, cache[key],
                              eager_cache[key]):
            if a is not None and not torch.equal(a, b):
                fail(f"{arch_name}: cache {key}.{name} graphed != eager")
    want = (per_call, {"int8_wgmma": 0, "bf16_wgmma": per_call,
                       "cuda_core": 0})
    if stage.calls != VA_TICKS or stage.replays != VA_TICKS - 1 \
            or stage.per_replay["hbfp_matmul_fwd"] != want:
        fail(f"{arch_name}: stage calls {stage.calls}, replays "
             f"{stage.replays}, B1 per replay "
             f"{stage.per_replay['hbfp_matmul_fwd']}, expected {want}")
    for kind, r in runs.items():
        n = VA_TICKS * per_call
        if r["launches"] != n or r["routes"]["bf16_wgmma"] != n:
            fail(f"{arch_name} {kind}: B1 launches {r['routes']}, expected "
                 f"{n} on bf16_wgmma")
        if prof[kind]["b1_gemm_launches"] != per_call:
            fail(f"{arch_name} {kind}: the profiled tick ran "
                 f"{prof[kind]['b1_gemm_launches']} B1 GEMM kernels, "
                 f"expected {per_call}")
    numbers = {}
    for kind, r in runs.items():
        steady = sorted(ms for t, ms in enumerate(r["tick_ms"])
                        if t >= 2 and t != VA_PROFILE_AT)
        n = prof[kind]
        numbers[kind] = dict(tick_ms=steady[len(steady) // 2],
                             tick_ms_first=r["tick_ms"][:2],
                             profiled_tick=n)
        log(f"{tag} {kind}: tick {numbers[kind]['tick_ms']:.2f} ms wall "
            f"(median of ticks 2-{VA_TICKS - 1} unprofiled; first two "
            f"{[round(x, 1) for x in r['tick_ms'][:2]]}), profiled tick "
            f"{n['wall_ms']:.2f} ms wall, {n['device_ms']:.2f} ms of "
            f"kernels (device idle {1 - n['device_ms'] / n['wall_ms']:.1%}), "
            f"B1 {n['b1_ms']:.2f} ms in {n['b1_gemm_launches']} GEMM "
            f"launches, {n['kernels']} kernels | {card}")
    log(f"{tag} prefill {B} x {P} frames {prefill_ms:.1f} ms ({per_call} "
        f"B1 launches, bf16_wgmma); graphed == eager over {VA_TICKS} ticks:"
        f" every tick's logits and the cache bit for bit; {per_call} B1 "
        f"launches a replay (7L + K = 7·{L} + {K}); peak {peak:.2f} GiB | "
        f"{card}")
    del params, cache, eager_cache, stage, runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=L, params=n_raw, load_peak_gib=load_peak,
                peak_gib=peak, prefill_ms=prefill_ms, per_replay=per_call,
                launches=pre_launches + 2 * VA_TICKS * per_call,
                numbers=numbers)


def phase_vlm_audio(card: str) -> dict:
    """qwen2-vl-72b and musicgen-large: (a) each smoke model, one training
    step and the serve-step stages (a prefill and 4 decode steps) on the
    card against the CPU, qwen2-vl also with an image-grid span; (b) B1 at
    both archs' served shapes (M = 8) and B1-B3 at their training shapes
    (M = 4096 and 3072, qwen2-vl's head at its CE chunk's 2048, the
    heads included) against their plain versions,
    routes checked; (c) qwen2-vl at full width, 3 of 80 layers, and (d)
    musicgen at 12 of 48, trained through the Trainer (exact B1-B6 launches
    on their tensor-core routes, step-0 loss within 2% of fp32); (e) both
    served at full width through the serve-step stages, the decode tick
    graphed against eager."""
    import torch
    t0 = time.perf_counter()
    smoke = {}
    for a in ("qwen2-vl-72b", "musicgen-large"):
        smoke[a] = dict(train=[phase_train(a)], serve=[_smoke_stages(a)])
    smoke["qwen2-vl-72b"]["train"].append(phase_train("qwen2-vl-72b",
                                                      grid=True))
    smoke["qwen2-vl-72b"]["serve"].append(_smoke_stages("qwen2-vl-72b",
                                                        grid=True))
    gen = torch.Generator(device="cuda").manual_seed(2525)
    kernel_rows = []
    for fam, shapes in VA_SHAPES.items():
        for w, (M, K, N) in shapes.items():
            kernel_rows.append(_served_b1_case(f"{fam}_{w}", K, N, gen,
                                               "vlm_audio"))
            kernel_rows += _bwd_case(f"{fam}_{w}", M, K, N, True, 8, 0,
                                     False, gen, "vlm_audio",
                                     route=MOE_TRAIN_ROUTES)
            torch.cuda.empty_cache()
    log(f"[time] vlm_audio smoke and kernels done at "
        f"{time.perf_counter() - t0:.1f} s of the phase")
    train = {}
    for arch_name, layers, B, S in VA_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        # qwen2-vl's step fills the card as llama4's does (f32 master,
        # moments and grads of 3.9 B parameters, GB-sized head
        # temporaries): expandable segments leave no fragments behind
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        try:
            train[arch_name] = phase_train_full(
                card, arch_name, B, S, n_layers=layers, phase="vlm_audio",
                regions=VA_REGIONS)
        finally:
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
        prof = train[arch_name]["profile"]
        if prof is not None:
            sh = prof["share"]
            kern = sum(v for k, v in sh.items() if k.startswith(
                ("B1", "B2", "B3", "B4", "B5", "B6", "f32 quantize")))
            log(f"[vlm_audio {arch_name}] profiled step by region: "
                + ", ".join(f"{k} {sh[k]:.1%}" for k in VA_REGIONS)
                + f", B1-B6 {kern:.1%}, the rest "
                f"{sh['everything else']:.1%} ({prof['kernels']} kernels)")
            for row in prof["top"][:6]:
                log(f"[vlm_audio {arch_name}]   {row['ms']:9.2f} ms "
                    f"{row['count']:7d}  {row['kernel']}")
        log(f"[time] vlm_audio {arch_name} training done at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
    gc.collect()
    torch.cuda.empty_cache()
    serve = {}
    for arch_name, layers in VA_SERVE:
        serve[arch_name] = _va_serve(card, arch_name, layers)
        log(f"[time] vlm_audio {arch_name} serving done at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
    log(f"[time] vlm_audio phase {time.perf_counter() - t0:.1f} s")
    return dict(smoke=smoke, kernel_rows=kernel_rows, train=train,
                serve=serve, seconds=time.perf_counter() - t0)


# autotune: the tuning table (ROADMAP A6). B1-B3 are tuned over the
# reference's whole menu at two of gemma2-2b's training GEMMs (2 x 2048
# tokens: M = 4096) and B1 at yi-9b's decode wq (M = the served lanes),
# into a temp table; gemma2-2b trains at full width and 2 of its 26
# layers, and yi-9b serves at 2 of its 48, reading that table through
# resolve_spec. Every later phase runs untuned: the table is gone by then
AT_TRAIN = ("gemma2-2b", 2, 2, 2048)      # arch, layers, batch, tokens
AT_SITES = ("wq", "ffn_wo")               # of TRAIN_SHAPES
AT_SERVE = ("yi-9b", 2)                   # arch, layers
AT_DECODE = "wq"                          # of SERVE_SHAPES (wo shares it)
AT_TICKS = 8
AT_NEW = 16                               # tokens a request generates
AT_OPS = {"matmul_fwd": "hbfp_matmul_fwd", "matmul_dgrad": "hbfp_dgrad",
          "matmul_wgrad": "hbfp_wgrad"}


class _GemmLog:
    """While open, records each `kernels/linear.py` call site's
    resolve_spec (its logical M, K, N, the key's dtype, the config and the
    spec it returned) and each B1-B3 launch made from there (the kernel,
    the padded operands' shapes, w's dtype and the tiles), by wrapping the
    names linear.py calls them by."""

    NAMES = ("resolve_spec", "hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad")

    def __enter__(self):
        from repro_torch.kernels import linear
        self.mod = linear
        self.orig = {n: getattr(linear, n) for n in self.NAMES}
        self.specs, self.launches = [], []

        def resolve_spec(cfg, M, K, N, dtype="float32", dgrad_cfg=None,
                         wgrad_cfg=None):
            spec = self.orig["resolve_spec"](cfg, M, K, N, dtype, dgrad_cfg,
                                             wgrad_cfg)
            self.specs.append(dict(shape=(M, K, N), dtype=dtype, cfg=cfg,
                                   spec=spec))
            return spec
        linear.resolve_spec = resolve_spec
        for name in self.NAMES[1:]:
            setattr(linear, name, self._launcher(name))
        return self

    def _launcher(self, name):
        f = self.orig[name]

        def launch(a, b, seed=None, **kw):
            self.launches.append(dict(kernel=name, a=tuple(a.shape),
                                      b=tuple(b.shape), w_dtype=b.dtype,
                                      **kw))
            return f(a, b, seed, **kw)
        return launch

    def __exit__(self, *exc):
        for name, f in self.orig.items():
            setattr(self.mod, name, f)

    def site(self, shape) -> dict:
        """The one key a call site at this logical shape uses: its dtype,
        widths, block and quantize_w (the same on every call)."""
        recs = {(r["dtype"], r["cfg"].mantissa_bits, r["spec"].m_dgrad,
                 r["spec"].m_wgrad, r["spec"].block, r["spec"].quantize_w)
                for r in self.specs if r["shape"] == tuple(shape)}
        if len(recs) != 1:
            fail(f"autotune: the call site at {shape} used keys {recs}")
        dtype, m, m_d, m_w, block, qw = recs.pop()
        if m_d or m_w:
            fail(f"autotune: per-role widths at {shape}: {m_d}, {m_w}")
        w_dtypes = {str(r["w_dtype"]).replace("torch.", "")
                    for r in self.launches
                    if r["kernel"] == "hbfp_matmul_fwd"
                    and _launch_shape(r) == tuple(shape)}
        if len(w_dtypes) != 1:
            fail(f"autotune: B1 at {shape} took weights in {w_dtypes}")
        return dict(dtype=dtype, mantissa_bits=m, block=block,
                    quantize_w=qw, w_dtype=w_dtypes.pop())


def _launch_shape(r) -> tuple:
    """A recorded launch's (M, K, N), padded: B2's g is [M, N] against w
    [K, N], B1's and B3's first operand is [M, K]."""
    if r["kernel"] == "hbfp_dgrad":
        return r["a"][0], r["b"][0], r["a"][1]
    return r["a"][0], r["a"][1], r["b"][1]


def _launch_route(r) -> str:
    """The route `gemm_route` / `wgrad_route` give one recorded launch at
    its clipped tiles."""
    from repro_torch.kernels import hbfp_matmul as hm
    M, K, N = _launch_shape(r)
    if r["kernel"] == "hbfp_wgrad":
        return hm.wgrad_route(mantissa_bits=r["mantissa_bits"], M=M, K=K,
                              N=N, bm=min(r["bm"], M))
    return hm.gemm_route("fwd" if r["kernel"] == "hbfp_matmul_fwd"
                         else "dgrad", mantissa_bits=r["mantissa_bits"],
                         quantize_w=r["quantize_w"], block=r["block"],
                         bk=min(r["bk"], K), bn=min(r["bn"], N), N=N,
                         w_dtype=r["w_dtype"])


def _predicted_routes(launches) -> dict:
    """B1-B3 launches by the route their tiles give."""
    out = {k: {"int8_wgmma": 0, "bf16_wgmma": 0, "cuda_core": 0}
           for k in GEMM_KERNELS}
    for r in launches:
        out[r["kernel"]][_launch_route(r)] += 1
    return out


def _at_operands(M, K, N, quantize_w, w_dtype, gen):
    """x (bf16 activations), w (as the site holds it: the training compute
    copy, or the served copy narrowed at 8 bits in 128 x 128 tiles) and g
    (the bf16 grad of y, cast to f32 as the autograd Function does)."""
    import torch
    from repro_torch.core import HBFP8_16, bfp
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    if not quantize_w:
        w = bfp.quantize_weight(w, HBFP8_16)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    g = (torch.randn((M, N), generator=gen, device="cuda") * 1e-3).to(
        torch.bfloat16).float()
    return x, w.to(w_dtype), g


def _at_check(op, tiles, x, w, g, site):
    """One candidate against its plain version on the card, at its tiles:
    B1/B2 through the ops wrappers, bit-equal at block 0 (else within
    BLOCK_TOL of the largest output), B3 with its dequantized operands
    bit-equal and dw within `_wgrad_ok`'s bound. Returns (route taken,
    route its tiles give, ok, max |Δ|)."""
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.kernels import ops
    bm, bk, bn = tiles
    m, block, qw = site["mantissa_bits"], site["block"], site["quantize_w"]
    kw = dict(mantissa_bits=m, block=block, bm=bm, bk=bk, bn=bn)
    fn = getattr(hm, AT_OPS[op])
    before = dict(fn.launches_by_route)
    M, K, N = x.shape[0], w.shape[0], w.shape[1]
    if op == "matmul_wgrad":
        yk, xh, gh = hm.hbfp_wgrad(x, g, operands=True, **kw)
        yp, xhp, ghp = hm.hbfp_wgrad_plain(x, g, operands=True, **kw)
        ok, err, _ = _wgrad_ok(yk, yp, xh, gh, M)
        ok = ok and torch.equal(xh, xhp) and torch.equal(gh, ghp)
        want = hm.wgrad_route(mantissa_bits=m, M=M, K=K, N=N,
                              bm=min(bm, M))
        del xh, gh, xhp, ghp
    else:
        fwd = op == "matmul_fwd"
        a = x if fwd else g
        yk = (ops.hbfp_matmul if fwd else ops.hbfp_dgrad)(
            a, w, quantize_w=qw, **kw)
        yp = (hm.hbfp_matmul_plain if fwd else hm.hbfp_dgrad_plain)(
            a, w, quantize_w=qw, **kw)
        err = float((yk - yp).abs().max())
        ok = torch.equal(yk, yp) if block == 0 else \
            err <= BLOCK_TOL * float(yp.abs().max())
        want = hm.gemm_route("fwd" if fwd else "dgrad", mantissa_bits=m,
                             quantize_w=qw, block=block, bk=min(bk, K),
                             bn=min(bn, N), N=N, w_dtype=w.dtype)
    torch.cuda.synchronize()
    ok = ok and bool(torch.isfinite(yk).all())
    took = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    del yk, yp
    return (took[0] if len(took) == 1 else str(took)), want, ok, err


def _at_tune(card, name, M, K, N, site, ops_, gen, rec) -> dict:
    """Every candidate of each op at one site checked against its plain
    version (route logged and held to its tiles'), then timed and the
    winner recorded by `autotune_op` through the ops wrappers; one JSON
    line an op."""
    import torch
    from repro_torch.kernels import autotune, ops
    x, w, g = _at_operands(M, K, N, site["quantize_w"],
                           getattr(torch, site["w_dtype"]), gen)
    m, block, qw = site["mantissa_bits"], site["block"], site["quantize_w"]
    runs = {"matmul_fwd": lambda t: ops.hbfp_matmul(
                x, w, mantissa_bits=m, quantize_w=qw, block=block,
                bm=t[0], bk=t[1], bn=t[2]),
            "matmul_dgrad": lambda t: ops.hbfp_dgrad(
                g, w, mantissa_bits=m, quantize_w=qw, block=block,
                bm=t[0], bk=t[1], bn=t[2]),
            "matmul_wgrad": lambda t: ops.hbfp_wgrad(
                x, g, mantissa_bits=m, block=block, bm=t[0], bk=t[1],
                bn=t[2])}
    kind = "int8" if qw and m <= 8 and block == 0 else \
        "bf16" if m <= 8 else "f32"
    ops2 = 2.0 * M * K * N
    bounds = {"matmul_fwd": _bound_ms(M, K, N, 2, w.element_size(), kind),
              "matmul_dgrad": _bound(ops2, 4 * M * N + w.element_size() * K
                                     * N + 4 * M * K, kind),
              "matmul_wgrad": _bound(ops2, 2 * M * K + 4 * M * N + 4 * K * N,
                                     "bf16" if m <= 8 else "f32")}
    out = {}
    for op in ops_:
        default = autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N)
        cands = autotune.candidates(M, K, N)
        if default not in cands:
            cands = (default,) + cands
        routes, errs = {}, []
        for t in cands:
            took, want, ok, err = _at_check(op, t, x, w, g, site)
            log(f"[autotune] {op} {name} {M}x{K}x{N} tiles {t}: {took} "
                f"{'ok' if ok else 'MISMATCH'} err={err:.3g}")
            if took != want or not ok:
                fail(f"autotune {op} {name} tiles {t}: took {took}, its "
                     f"tiles give {want}, matches its plain version: {ok}")
            routes[t] = took
            errs.append(err)
        best, rep = autotune.autotune_op(
            op, runs[op], M, K, N, dtype=site["dtype"], mantissa_bits=m,
            block=block, recorder=rec,
            log=lambda msg: log(f"[autotune time] {msg.strip()}"))
        best, default = tuple(best), tuple(rep["default_tiles"])
        if rep["n_candidates"] != len(cands) or \
                rep["backend"] != torch.cuda.get_device_name(0):
            fail(f"autotune {op} {name}: report {rep}")
        by_route = {}
        for r in routes.values():
            by_route[r] = by_route.get(r, 0) + 1
        line = dict(autotune=op, site=name, shape=[M, K, N],
                    key=autotune.cache_key(op, M, K, N, site["dtype"], m,
                                           block),
                    quantize_w=qw, w_dtype=site["w_dtype"],
                    n_candidates=rep["n_candidates"],
                    candidates_by_route=by_route,
                    default_tiles=list(default), default_us=rep["default_us"],
                    default_route=routes[default], tiles=list(best),
                    us=rep["us"], route=routes[best],
                    speedup=rep["speedup"], max_abs_err=max(errs),
                    bound_us=bounds[op][0] * 1e3, bound_by=bounds[op][1],
                    card=card)
        log(json.dumps(line))
        out[op] = line
    del x, w, g
    torch.cuda.empty_cache()
    return out


def _at_train(card, arch, tag, loss_fp32, tuned, log_sink) -> dict:
    """gemma2-2b from one init (seed 0) under "8; backend=pallas": a
    warm-up step, then 3 counted steps, their resolve_spec calls and
    B1-B3 launches recorded. Checks: exact launch counts, every launch on
    the route its tiles give, the call sites at `tuned` ({shape: {op:
    tiles}}) resolved to those tiles and every other site to the clipped
    defaults, step-0 loss finite and within 2% of fp32. The run's events
    also go to `log_sink`."""
    import torch
    from repro_torch.data import batch_for_arch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.optim import make_schedule
    from repro_torch.train import Trainer, init_train_state, make_step
    _, _, B, S = AT_TRAIN
    data = lambda i: batch_for_arch(arch, B, S, step=i, kind="markov")
    sched = make_schedule("constant", base_lr=1e-4, warmup_steps=0,
                          total_steps=100)
    sink = MemorySink()
    trainer = Trainer(train_step=make_step(arch, "8; backend=pallas", sched),
                      init_state=init_train_state(0, arch), data_fn=data,
                      recorder=Recorder([sink, log_sink], run_id=tag),
                      seed=SR_SEED)
    lines = []
    trainer.run(1, log_every=1, log_fn=lines.append)       # warm-up
    torch.cuda.synchronize()
    hm.reset_counts()
    with _GemmLog() as gl:
        trainer.run(4, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    counts = {k: getattr(hm, k).launches for k in GEMM_KERNELS}
    routes = {k: dict(getattr(hm, k).launches_by_route)
              for k in GEMM_KERNELS}
    plain = sum(getattr(hm, k).plain_calls for k in GEMM_KERNELS)
    want = {k: v for k, v in _train_launches(arch, B * S).items()
            if k in GEMM_KERNELS}
    predicted = _predicted_routes(gl.launches)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    step_s = [ev.data["dur_us"] / 1e6 for ev in sink.events
              if ev.kind == "span" and ev.data.get("name") == "train/step"][1:]
    log(f"[autotune {tag}] launches over 3 steps {counts} (expected "
        f"{want}), by route {routes}; step times "
        f"{[round(t, 3) for t in step_s]} s; step-0 loss {losses[0]:.4f} "
        f"vs fp32 {loss_fp32:.4f} | {card}")
    if counts != want or plain:
        fail(f"autotune {tag}: launches {counts} != {want} or plain {plain}")
    if routes != predicted:
        fail(f"autotune {tag}: launches by route {routes}, their tiles give "
             f"{predicted}")
    for r in gl.specs:
        M, K, N = r["shape"]
        got = (r["spec"].fwd, r["spec"].dgrad, r["spec"].wgrad)
        exp = tuple(tuned[r["shape"]][op] if r["shape"] in tuned else
                    autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N)
                    for op in AT_OPS)
        if got != exp:
            fail(f"autotune {tag}: resolve_spec at {r['shape']} gave {got}, "
                 f"expected {exp}")
    for r in gl.launches:
        shape = _launch_shape(r)
        if shape in tuned:
            op = next(o for o, k in AT_OPS.items() if k == r["kernel"])
            if (r["bm"], r["bk"], r["bn"]) != tuned[shape][op]:
                fail(f"autotune {tag}: {r['kernel']} at {shape} launched "
                     f"tiles {(r['bm'], r['bk'], r['bn'])}")
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"autotune {tag}: non-finite loss {losses}")
    if abs(losses[0] - loss_fp32) > 0.02 * abs(loss_fp32):
        fail(f"autotune {tag}: step-0 loss {losses[0]} not within 2% of "
             f"fp32 {loss_fp32}")
    sites = {s: gl.site((TRAIN_M,) + TRAIN_SHAPES[s]) for s in AT_SITES}
    prof = _profile_step(trainer, 5)
    b13 = None
    if prof is not None:
        b13 = prof["device_ms"] * sum(
            v for k, v in prof["share"].items() if k.startswith(
                ("B1", "B2", "B3", "f32 quantize")))
        log(f"[autotune {tag}] profiled step: {prof['wall_ms']:.1f} ms "
            f"wall, {prof['device_ms']:.1f} ms of kernels, B1-B3 "
            f"{b13:.2f} ms | {card}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=counts, routes=routes, losses=losses,
                loss_fp32_step0=loss_fp32, step_s=step_s,
                sites=sites, n_spec_calls=len(gl.specs), profile=prof,
                b1_b3_device_ms=b13)


def _at_serve(card, tuned_shape, best) -> dict:
    """yi-9b at full width, AT_SERVE's layers: a graphed and an eager
    engine in lockstep for AT_TICKS ticks (tokens, every tick's logits
    and the cache bit for bit), each decode launch at `tuned_shape` on
    the tuned tiles `best`, and the graphed replay's B1 launches on the
    routes the launches' tiles give."""
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    arch, depth = _at_depth(*AT_SERVE)
    pol = parse_policy("8; backend=pallas")
    params = init_params(0, arch)
    g = torch.Generator().manual_seed(42)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=g).tolist()
               for n in (32, 48, 64, 80, 96, 112, 128, 144)]
    per_call = 7 * arch.n_layers + 1
    kw = dict(paged=True, max_batch=SERVE_LANES, ctx_len=512)
    hm.reset_counts()
    with _GemmLog() as gl:
        _, per_replay = _lockstep(kw, arch, params, pol, prompts, AT_NEW,
                                  AT_TICKS, per_call, profile_at=None)
    torch.cuda.synchronize()
    routes = dict(hm.hbfp_matmul_fwd.launches_by_route)
    decode = [r for r in gl.launches if r["a"][0] == SERVE_LANES]
    at_site = [r for r in decode if _launch_shape(r) == tuned_shape]
    ticks = len(decode) // per_call
    pred = {}
    for r in decode:
        rt = _launch_route(r)
        pred[rt] = pred.get(rt, 0) + 1
    per_tick = {rt: n // ticks for rt, n in pred.items()}
    got = per_replay["hbfp_matmul_fwd"]
    log(f"[autotune serve] yi-9b {depth}: graphed == eager over {AT_TICKS} "
        f"lockstep ticks; B1 per replay {got}, the tiles give {per_tick}; "
        f"{len(at_site)} launches at {tuned_shape} on tiles "
        f"{sorted({(r['bm'], r['bk'], r['bn']) for r in at_site})} | "
        f"{card}")
    if len(decode) != ticks * per_call or \
            any(n % ticks for n in pred.values()):
        fail(f"autotune serve: {len(decode)} decode launches in whole "
             f"ticks of {per_call}?")
    if got[0] != per_call or {k: v for k, v in got[1].items() if v} != \
            per_tick:
        fail(f"autotune serve: B1 per replay {got}, expected {per_call} "
             f"on {per_tick}")
    if len(at_site) != 2 * arch.n_layers * ticks or any(
            (r["bm"], r["bk"], r["bn"]) != best for r in at_site):
        fail(f"autotune serve: the launches at {tuned_shape} did not all "
             f"take the tuned tiles {best}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=arch.n_layers, per_replay=got, per_tick=per_tick,
                launches=hm.hbfp_matmul_fwd.launches, routes=routes,
                ticks=AT_TICKS)


def _at_decode_site(arch, params, pol) -> dict:
    """The decode call site's key and weights' dtype, read from
    resolve_spec and B1's launch during one eager tick at full width."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(arch, params, pol, max_batch=SERVE_LANES, ctx_len=64,
                      cuda_graph=False)
    eng.submit(list(range(1, 17)), max_new_tokens=2)
    with _GemmLog() as gl:
        eng.step()
        eng.step()
    K, N = SERVE_SHAPES[AT_DECODE]
    site = gl.site((SERVE_LANES, K, N))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return site


def phase_autotune(card: str) -> dict:
    """ROADMAP A6 on the card, with REPRO_AUTOTUNE_TABLE at a temp file
    (restored after, with the cache dropped; nothing is written under
    results/): (e, untuned) gemma2-2b at full width, AT_TRAIN's layers,
    trained from one init on an empty table, its call sites' keys read
    from resolve_spec; (b, c) B1-B3 at AT_SITES tuned over the reference's
    whole menu through the ops wrappers, every candidate checked against
    its plain version on its route first; (d) B1 tuned at yi-9b's decode
    wq; (e, tuned) the same training on the table; (f) yi-9b served
    graphed against eager on the table."""
    import tempfile
    import torch
    from repro_torch.analysis.report import follow_runlog
    from repro_torch.kernels import autotune
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.layers import Ctx
    from repro_torch.obs import JSONLSink, MemorySink, Recorder
    from repro_torch.precision import parse_policy
    from repro_torch.train import init_train_state
    from repro_torch.train.train_step import _narrow_copy
    from repro_torch.data import batch_for_arch
    t0 = time.perf_counter()
    stat = lambda p: os.stat(p).st_mtime_ns if os.path.exists(p) else None
    results_before = stat(autotune.DEFAULT_TABLE_PATH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    table = os.path.join(tmp, "table.json")
    prev = os.environ.get(autotune.TABLE_ENV)
    os.environ[autotune.TABLE_ENV] = table
    autotune.invalidate_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log_path = os.path.join(ROOT, "chiprun_out", "autotune_run.jsonl")
    log_sink = JSONLSink(log_path, mode="w")
    try:
        arch, depth = _at_depth(AT_TRAIN[0], AT_TRAIN[1])
        _, _, B, S = AT_TRAIN
        with torch.no_grad():
            ref = _narrow_copy(init_train_state(0, arch).params, None,
                               torch.bfloat16)
            loss_fp32 = float(loss_fn(ref, batch_for_arch(
                arch, B, S, step=0, kind="markov"), arch, Ctx())[0])
            del ref
        torch.cuda.empty_cache()
        log(f"[autotune] {AT_TRAIN[0]} full width, {depth}, {B} x {S} "
            f"tokens; table {table}")
        train = {"untuned": _at_train(card, arch, "untuned", loss_fp32, {},
                                      log_sink)}
        log(f"[time] autotune untuned training done at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
        sink = MemorySink()
        rec = Recorder([sink, log_sink], run_id="tune")
        gen = torch.Generator(device="cuda").manual_seed(2626)
        tuned, lines = {}, {}
        for s in AT_SITES:
            K, N = TRAIN_SHAPES[s]
            lines[s] = _at_tune(card, s, TRAIN_M, K, N,
                                train["untuned"]["sites"][s], tuple(AT_OPS),
                                gen, rec)
            tuned[(TRAIN_M, K, N)] = {op: tuple(v["tiles"])
                                      for op, v in lines[s].items()}
        log(f"[time] autotune training GEMMs tuned at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
        train["tuned"] = _at_train(card, arch, "tuned", loss_fp32, tuned,
                                   log_sink)
        if train["tuned"]["launches"] != train["untuned"]["launches"]:
            fail("autotune: tuned and untuned steps launch B1-B3 a "
                 "different number of times")
        log(f"[autotune] gemma2-2b step s untuned "
            f"{[round(t, 3) for t in train['untuned']['step_s']]}, tuned "
            f"{[round(t, 3) for t in train['tuned']['step_s']]} | {card}")
        log(f"[time] autotune tuned training done at "
            f"{time.perf_counter() - t0:.1f} s of the phase")
        sarch, _ = _at_depth(*AT_SERVE)
        pol = parse_policy("8; backend=pallas")
        params = init_params(0, sarch)
        dsite = _at_decode_site(sarch, params, pol)
        del params
        gc.collect()
        K, N = SERVE_SHAPES[AT_DECODE]
        lines["decode_" + AT_DECODE] = _at_tune(
            card, "decode_" + AT_DECODE, SERVE_LANES, K, N, dsite,
            ("matmul_fwd",), gen, rec)
        best = tuple(lines["decode_" + AT_DECODE]["matmul_fwd"]["tiles"])
        serve = _at_serve(card, (SERVE_LANES, K, N), best)
        with open(table) as f:
            entries = json.load(f)
        kinds = [e.kind for e in sink.events]
        if kinds.count("autotune/search") != 7 or \
                kinds.count("autotune/winner") != 7 or len(entries) != 7:
            fail(f"autotune: {len(entries)} table entries, events {kinds}")
    finally:
        log_sink.close()
        if prev is None:
            os.environ.pop(autotune.TABLE_ENV, None)
        else:
            os.environ[autotune.TABLE_ENV] = prev
        autotune.invalidate_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    if stat(autotune.DEFAULT_TABLE_PATH) != results_before:
        fail(f"autotune: {autotune.DEFAULT_TABLE_PATH} was written")
    # the run-log through the port's renderer: every winner, both runs'
    # progress lines
    rendered = []
    counts = follow_runlog(log_path, out=rendered.append)
    for ln in rendered:
        if ln.startswith("[autotune]"):
            log(f"[autotune report] {ln}")
    if counts.get("autotune/winner") != 7 or \
            counts.get("train/progress", 0) < 2 * 4:
        fail(f"autotune: the run-log rendered {counts}")
    log(f"[autotune] run-log {os.path.relpath(log_path, ROOT)}: "
        f"{rendered[-1].strip()}")
    secs = time.perf_counter() - t0
    log(f"[time] autotune phase {secs:.1f} s")
    return dict(train=train, ops=lines, serve=serve, table=entries,
                decode_site=dsite, seconds=secs)


def _adapt_policy():
    from repro_torch.core import HBFPConfig
    from repro_torch.precision import parse_policy
    return parse_policy(ADAPT_SPEC, base=HBFPConfig(4, 16, tile=24))


def _b7_taps(L: int) -> int:
    """B7 launches of one telemetry step of a dense L-layer model at tile
    24: the weight tap narrows each layer slice of the seven projections
    (24 divides none of yi-9b's K, so one launch per slice) and the head,
    the grad tap does the same on the grads, the activation tap two rows
    views (stack entry and exit)."""
    return 2 * (7 * L + 1) + 2


def _snap_diff(a: dict, b: dict, first: bool) -> list:
    """Stats of one snapshot pair outside ADAPT_TOL."""
    bad = []
    for src in ("weights", "grads", "acts"):
        for name, sa in a.get(src, {}).items():
            sb = b[src][name]
            tight = first and src == "weights"
            lim_s = ADAPT_TOL["sqnr0" if tight else "sqnr"]
            lim_f = ADAPT_TOL["frac0" if tight else "frac"]
            lim_e = 0.0 if tight else ADAPT_TOL["spread"]
            if abs(sa["sqnr_db"] - sb["sqnr_db"]) > lim_s \
                    or abs(sa["exp_spread"] - sb["exp_spread"]) > lim_e \
                    or any(abs(sa[k] - sb[k]) > lim_f for k in
                           ("clip_frac", "sat_tile_frac", "ftz_frac")):
                bad.append((src, name, sa, sb))
    return bad


def phase_adaptive_smoke():
    """The closed loop on yi-9b smoke (f32) on the card (B1-B7) and on the
    CPU (their plain versions) from the same state and batches: the same
    decisions at the same steps, at least one widen, stats and losses
    within ADAPT_TOL, exact B7 launches per telemetry step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.numerics import (ControllerConfig, PrecisionController,
                                      TapConfig)
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import OptState
    from repro_torch.train import TrainState, init_train_state, make_step
    arch = dataclasses.replace(get_arch("yi-9b").smoke(), dtype="float32")
    pipe = SyntheticLM(arch.vocab_size, 17, 4, seed=3, device="cpu")
    cpu = init_train_state(0, arch, device="cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.cuda()
    card = TrainState(to(cpu.params), OptState(0, to(cpu.opt.mu),
                                               to(cpu.opt.nu)), 0)
    runs = {}
    for dev, state in (("cpu", cpu), ("cuda", card)):
        lrs = make_schedule("constant", base_lr=2e-3, warmup_steps=2,
                            total_steps=30)
        ctrl = PrecisionController(ControllerConfig(patience=1, cooldown=1),
                                   base_bits=4)
        step = make_step(arch, _adapt_policy(), lrs, controller=ctrl,
                         tap=TapConfig(cadence=2), device=dev)
        losses, b7, snaps, b7_routes = [], [], [], {}
        for i in range(ADAPT_STEPS):
            bq.reset_counts()
            batch = {k: v.to(dev) for k, v in pipe.batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            b7.append((bq.bfp_quantize.launches, bq.bfp_quantize.plain_calls))
            for r, n in bq.bfp_quantize.launches_by_route.items():
                b7_routes[r] = b7_routes.get(r, 0) + n
            if i % 2 == 0:
                snaps.append(step.buffer.latest()[1])
        runs[dev] = dict(losses=losses, b7=b7, snaps=snaps, log=ctrl.log,
                         variants=len(step.variants), b7_routes=b7_routes,
                         n_overrides=float(m["n_overrides"]))
    c, g = runs["cpu"], runs["cuda"]
    dec = lambda r: [(d["step"], d["layer"], d["action"], d["from"], d["to"])
                     for d in r["log"]]
    bad = [d for i, (a, b) in enumerate(zip(c["snaps"], g["snaps"]))
           for d in _snap_diff(a, b, i == 0)]
    want = [(_b7_taps(arch.n_layers), 0) if i % 2 == 0 else (0, 0)
            for i in range(ADAPT_STEPS)]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(c["losses"],
                                                       g["losses"]))
    log(f"[adaptive] yi-9b smoke f32 {ADAPT_SPEC!r} tile 24, 6 steps: "
        f"losses card {[round(v, 5) for v in g['losses']]} cpu "
        f"{[round(v, 5) for v in c['losses']]} (max rel {loss_err:.3g}); "
        f"decisions equal {dec(c) == dec(g)}: {dec(g)}; variants card "
        f"{g['variants']} cpu {c['variants']}; B7 (launches, plain calls) "
        f"per step card {g['b7']} (expected {want}), by route "
        f"{g['b7_routes']}; stats outside tolerance {len(bad)}")
    if dec(c) != dec(g) or not any(d[2] == "widen" for d in dec(g)):
        fail(f"adaptive smoke: decisions differ or no widen: cpu {dec(c)} "
             f"card {dec(g)}")
    if g["b7"] != want or g["variants"] != c["variants"]:
        fail(f"adaptive smoke: B7 launches {g['b7']} != {want} or variants "
             f"{g['variants']} != {c['variants']}")
    if any(n for r, n in g["b7_routes"].items() if r not in B7_MAIN_ROUTES):
        fail(f"adaptive smoke: B7 launches off {B7_MAIN_ROUTES}: "
             f"{g['b7_routes']}")
    if bad or loss_err > ADAPT_TOL["loss"]:
        fail(f"adaptive smoke: stats or losses disagree: {bad[:4]} "
             f"loss rel {loss_err}")
    return dict(decisions=dec(g), losses_card=g["losses"],
                losses_cpu=c["losses"], b7_per_step=g["b7"],
                b7_routes=g["b7_routes"], variants=g["variants"],
                loss_rel_err=loss_err)


def _counts():
    """Launch and plain-call counts of every kernel wrapper."""
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.kernels import hbfp_matmul as hm
    out = {k: getattr(hm, k).launches for k in GEMM_KERNELS}
    out.update({f"{k}/{r}": n for k in GEMM_KERNELS
                for r, n in getattr(hm, k).launches_by_route.items()})
    out.update({k: getattr(fa, k).launches for k in FLASH_KERNELS})
    out.update({f"{k}/{r}": n for k in FLASH_KERNELS
                for r, n in getattr(fa, k).launches_by_route.items()})
    out["bfp_quantize"] = bq.bfp_quantize.launches
    out.update({f"bfp_quantize/{r}": n
                for r, n in bq.bfp_quantize.launches_by_route.items()})
    plain = sum(getattr(hm, k).plain_calls for k in GEMM_KERNELS) \
        + sum(getattr(fa, k).plain_calls for k in FLASH_KERNELS) \
        + bq.bfp_quantize.plain_calls
    return out, plain


def _reset_counts():
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.kernels import hbfp_matmul as hm
    hm.reset_counts()
    fa.reset_counts()
    bq.reset_counts()


# B7's kernels (csrc/bfp_quantize.cu) by name in a profile
B7_KERNEL_RE = (r"banded_kernel|split_(amax|convert|clip)_kernel|"
                r"quantize_tile_kernel|block_minmax_kernel")


def _telemetry_split(tel: dict, pln: dict) -> dict:
    """A telemetry step's kernels against a plain step's: B7's device ms by
    kernel, and the other kernels' net added ms, the largest first."""
    b7 = {k: v[0] for k, v in tel.items() if re.search(B7_KERNEL_RE, k)}
    delta = {k: (tel.get(k, (0.0, 0))[0] - pln.get(k, (0.0, 0))[0],
                 tel.get(k, (0.0, 0))[1], pln.get(k, (0.0, 0))[1])
             for k in set(tel) | set(pln) if k not in b7}
    top = sorted(delta.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(telemetry_ms=sum(v[0] for v in tel.values()),
                plain_ms=sum(v[0] for v in pln.values()),
                b7_ms=sum(b7.values()), b7_by_kernel=b7,
                other_added_ms=sum(d[0] for d in delta.values()),
                top_added=[dict(kernel=k, ms=d[0], calls_tel=d[1],
                                calls_plain=d[2]) for k, d in top])


def _adapt_trainer(arch, pipe, state, rows, ckpt_dir=None, rec=None,
                   **kw):
    """A Trainer over a fresh controller and make_step for the adaptive
    path, its steps recorded into `rows`: (step, loss, synchronized
    seconds, launch counts, plain calls), the counts zeroed just before
    each step. Returns (trainer, controller, step)."""
    import torch
    from repro_torch.numerics import (ControllerConfig, PrecisionController,
                                      TapConfig)
    from repro_torch.optim import make_schedule
    from repro_torch.train import Trainer, make_step
    pol = _adapt_policy()
    ctrl = PrecisionController(ControllerConfig(patience=1, cooldown=1),
                               base_bits=4)
    sched = make_schedule("constant", base_lr=1e-4, warmup_steps=0,
                          total_steps=100)
    step = make_step(arch, pol, sched, controller=ctrl,
                     tap=TapConfig(cadence=2))

    def counted(st, batch, key):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        st, m = step(st, batch, key)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        counts, plain = _counts()
        rows.append(dict(step=st.step - 1, loss=loss,
                         seconds=time.perf_counter() - t0, launches=counts,
                         plain=plain))
        return st, m

    return Trainer(train_step=counted, init_state=state, data_fn=pipe.batch,
                   ckpt_dir=ckpt_dir, hbfp=pol, controller=ctrl,
                   recorder=rec, **kw), ctrl, step


def phase_adaptive_full(card: str):
    """yi-9b at full width, ADAPT_LAYERS layers, trained under the closed
    loop through the Trainer: (a) ADAPT_FULL_STEPS steps uninterrupted;
    (b) checkpointed every 4 steps, preempted at 6 and resumed at 4 by a
    fresh Trainer and controller. (b) must equal (a) bit for bit (losses,
    master params, controller meta), B7 launches must be exact per
    telemetry step, and a packed save of the master must load back bit for
    bit."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import init_train_state
    full = get_arch("yi-9b")
    arch = dataclasses.replace(full, n_layers=ADAPT_LAYERS)
    L = arch.n_layers
    tag = "[adaptive-full]"
    base = os.path.join(ROOT, "build", "adaptive_ckpt")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    free = shutil.disk_usage(base).free / 1e9
    log(f"{tag} free disk at {base}: {free:.1f} GB (needs {ADAPT_DISK_GB})")
    if free < ADAPT_DISK_GB:
        fail(f"adaptive-full needs {ADAPT_DISK_GB} GB of free disk, "
             f"{free:.1f} GB free")
    pipe = SyntheticLM(arch.vocab_size, 4096 + 1, 1, seed=0)
    torch.cuda.reset_peak_memory_stats()
    # (a) uninterrupted
    state = init_train_state(0, arch)
    n_params = sum(t.numel() for _, t in named_leaves(state.params))
    log(f"{tag} yi-9b full width, {L} of {full.n_layers} layers (depth "
        f"cut), {n_params / 1e9:.3f} B params, 1 x 4096 tokens, "
        f"{ADAPT_SPEC!r} on HBFPConfig(4, 16, tile=24), cadence 2")
    rows_a, rows_b1, rows_c = [], [], []
    tr_a, ctrl_a, step_a = _adapt_trainer(arch, pipe, state, rows_a)
    tr_a.run(ADAPT_FULL_STEPS, log_every=0)
    params_a = {n: t.clone() for n, t in named_leaves(tr_a.state.params)}
    meta_a = json.loads(json.dumps(ctrl_a.to_meta()))
    variants_a = len(step_a.variants)
    # where a telemetry step's extra time goes: device ms by kernel over
    # one more telemetry step (8) and one plain step (9), B7 by name
    # against the kernels the telemetry adds (numerics/stats.py's torch
    # reductions, less the plain step's sim narrowing)
    n_rows = len(rows_a)
    tel_k = _device_ms_by_kernel(
        lambda: tr_a.run(ADAPT_FULL_STEPS + 1, log_every=0))
    pln_k = _device_ms_by_kernel(
        lambda: tr_a.run(ADAPT_FULL_STEPS + 2, log_every=0))
    prof_rows = rows_a[n_rows:]
    del rows_a[n_rows:]
    tsplit = _telemetry_split(tel_k, pln_k)
    tsplit["wall_s"] = [r["seconds"] for r in prof_rows]
    log(f"{tag} profiled telemetry step {tsplit['telemetry_ms']:.2f} ms "
        f"of kernels vs plain step {tsplit['plain_ms']:.2f} ms (wall "
        f"{tsplit['wall_s'][0]:.3f} vs {tsplit['wall_s'][1]:.3f} s under "
        f"the profiler): B7 {tsplit['b7_ms']:.3f} ms "
        f"({len(tsplit['b7_by_kernel'])} kernels), the other kernels the "
        f"telemetry adds {tsplit['other_added_ms']:.2f} ms | {card}")
    for k, v in tsplit["b7_by_kernel"].items():
        log(f"{tag}   B7 {v:.3f} ms  {k[:160]}")
    for d in tsplit["top_added"]:
        log(f"{tag}   +{d['ms']:.3f} ms ({d['calls_tel']} vs "
            f"{d['calls_plain']} calls)  {d['kernel'][:160]}")
    del tr_a, state, step_a
    torch.cuda.empty_cache()
    # (b) checkpointed, preempted at 6, resumed at 4 by fresh objects
    d = os.path.join(base, "run")
    events = MemorySink()
    tr_b, _, _ = _adapt_trainer(arch, pipe, init_train_state(0, arch),
                                rows_b1, d, Recorder([events]),
                                ckpt_every=4, keep=1)
    try:
        tr_b.run(ADAPT_FULL_STEPS, fail_at_step=6, log_every=0)
        preempted = False
    except RuntimeError as e:
        if "simulated preemption at step 6" not in str(e):
            raise
        preempted = True
    failed_at = len(rows_b1) if preempted else None
    del tr_b
    torch.cuda.empty_cache()
    tr_c, ctrl_c, _ = _adapt_trainer(arch, pipe, init_train_state(0, arch),
                                     rows_c, d, Recorder([events]),
                                     ckpt_every=4, keep=1)
    resumed_at = tr_c.start_step
    log_at_resume = list(ctrl_c.log)
    tr_c.run(ADAPT_FULL_STEPS, log_every=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params_c = dict(named_leaves(tr_c.state.params))
    same_params = all(torch.equal(params_a[n], params_c[n])
                      for n in params_a)
    loss = {r["step"]: r["loss"] for r in rows_a}
    same_losses = all(r["loss"] == loss[r["step"]]
                      for r in rows_b1 + rows_c)
    same_meta = json.loads(json.dumps(ctrl_c.to_meta())) == meta_a
    pre_log = [e for e in meta_a["log"] if e["step"] < resumed_at]
    # launches: exact B7 taps on telemetry steps, no plain calls
    taps = _b7_taps(L)
    bad_counts = [(r["step"], r["launches"]["bfp_quantize"], r["plain"])
                  for r in rows_a + rows_b1 + rows_c
                  if r["launches"]["bfp_quantize"]
                  != (taps if r["step"] % 2 == 0 else 0) or r["plain"]]
    tel = [r["seconds"] for r in rows_a if r["step"] % 2 == 0 and r["step"]]
    pln = [r["seconds"] for r in rows_a if r["step"] % 2 == 1]
    t_tel, t_pln = sum(tel) / len(tel), sum(pln) / len(pln)
    saves = [e.data for e in events.events if e.kind == "ckpt/save"]
    loads = [e.data for e in events.events if e.kind == "ckpt/load"]
    for r in rows_a:
        log(f"{tag} (a) step {r['step']}: loss {r['loss']:.6f}, "
            f"{r['seconds']:.3f} s, B7 {r['launches']['bfp_quantize']}, "
            f"B1 {r['launches']['hbfp_matmul_fwd']}, B4 "
            f"{r['launches']['hbfp_flash_fwd']}")
    for dd in meta_a["log"]:
        log(f"{tag} decision {dd}")
    log(f"{tag} variants {variants_a}; telemetry step {t_tel:.3f} s vs "
        f"plain {t_pln:.3f} s ({t_tel / t_pln - 1:+.1%}), amortized at "
        f"cadence 2 {(t_tel + t_pln) / (2 * t_pln) - 1:+.1%} | {card}")
    log(f"{tag} (b) preempted at {failed_at}, resumed at {resumed_at}: "
        f"losses equal {same_losses}, master params equal {same_params}, "
        f"controller meta equal {same_meta}; saves "
        f"{[(s['path'][-8:], round(s['dur_s'], 2), s['bytes']) for s in saves]}"
        f", loads {[(round(s['dur_s'], 2), s['bytes']) for s in loads]}; "
        f"peak {peak:.2f} GiB")
    if failed_at != 6 or resumed_at != 4 or log_at_resume != pre_log:
        fail(f"adaptive-full: preempted at {failed_at}, resumed at "
             f"{resumed_at}, restored log {log_at_resume} != {pre_log}")
    if not (same_losses and same_params and same_meta):
        fail("adaptive-full: the resumed run differs from the "
             "uninterrupted one")
    if bad_counts:
        fail(f"adaptive-full: B7 launches (step, launches, plain) "
             f"{bad_counts}, expected {taps} per telemetry step")
    off_b7 = [(r["step"], rt, n) for r in rows_a + rows_b1 + rows_c
              + prof_rows for rt in bq.ROUTES if rt not in B7_MAIN_ROUTES
              and (n := r["launches"][f"bfp_quantize/{rt}"])]
    log(f"{tag} B7 by route " + str({rt: sum(
        r["launches"][f"bfp_quantize/{rt}"] for r in rows_a)
        for rt in bq.ROUTES}))
    if off_b7:
        fail(f"adaptive-full: B7 launches off {B7_MAIN_ROUTES} (step, "
             f"route, launches): {off_b7}")
    # B1/B2: int8 wgmma while every layer requantizes its weights in the
    # kernel, bf16 wgmma on the narrowed weights once the first widen
    # applies (decided at the end of its step), never the CUDA cores
    widen = min((dd["step"] for dd in meta_a["log"]
                 if dd["action"] == "widen"), default=None)
    by_step = {r["step"]: {t: sum(r["launches"][f"{k}/{t}"]
                                  for k in ROUTED_KERNELS)
                           for t in ("int8_wgmma", "bf16_wgmma",
                                     "cuda_core")}
               for r in rows_a}
    for st, by in sorted(by_step.items()):
        log(f"{tag} step {st}: B1+B2 by route {by}")
    # B3 and B4-B6: their tensor-core routes on every step (wgrad at m 8
    # under "4; wgrad+4", flash at m 4)
    off = [(r["step"], k, rt, n) for r in rows_a + rows_b1 + rows_c
           for k, want in TRAIN_ROUTES.items()
           for rt in ("int8_wgmma", "bf16_wgmma", "cuda_core")
           if rt != want and (n := r["launches"].get(f"{k}/{rt}", 0))]
    log(f"{tag} B3 by route {_route_sum(rows_a, 'hbfp_wgrad')}, B4-B6 by "
        f"route " + ", ".join(f"{k} {_route_sum(rows_a, k)}"
                              for k in FLASH_KERNELS))
    if off:
        fail(f"adaptive-full: B3-B6 launches off their tensor-core routes "
             f"(step, kernel, route, launches): {off}")
    bad_routes = [st for st, by in by_step.items()
                  if by["cuda_core"] or (by["int8_wgmma"] and
                                         by["bf16_wgmma"])
                  or (widen is not None and st <= widen
                      and by["bf16_wgmma"])]
    if bad_routes or widen is None or not any(
            by["bf16_wgmma"] for st, by in by_step.items() if st > widen):
        fail(f"adaptive-full: B1/B2 routes by step {by_step} (first widen "
             f"at step {widen})")
    if not any(dd["action"] == "widen" for dd in meta_a["log"]) or not all(
            torch.isfinite(torch.tensor([r["loss"] for r in rows_a]))):
        fail("adaptive-full: no widen or a non-finite loss")
    # packed save of the master at the resolved widths
    packed_dir = os.path.join(base, "packed")
    torch.cuda.synchronize()
    bq.reset_counts()
    t0 = time.perf_counter()
    path = save_checkpoint(packed_dir, ADAPT_FULL_STEPS, tr_c.state.params,
                           hbfp=_adapt_policy(), packed=True)
    save_s = time.perf_counter() - t0
    packed_launches = bq.bfp_quantize.launches
    packed_routes = dict(bq.bfp_quantize.launches_by_route)
    t0 = time.perf_counter()
    back, _ = load_checkpoint(packed_dir, tr_c.state.params)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    exact = all(torch.equal(a, b) for (_, a), (_, b) in
                zip(named_leaves(back), named_leaves(tr_c.state.params)))
    size = lambda p, pre: sum(os.path.getsize(os.path.join(p, f))
                              for f in os.listdir(p) if f.startswith(pre))
    last = os.path.join(d, f"step_{ADAPT_FULL_STEPS:08d}")
    b_packed = size(path, "")
    b_plain = size(last, ".params.")
    want_packed = 7 * L + 1
    log(f"{tag} packed save of the master: {b_packed / 1e9:.3f} GB on disk "
        f"vs {b_plain / 1e9:.3f} GB unpacked ({b_plain / b_packed:.2f}x), "
        f"B7 launches {packed_launches} (expected {want_packed}) by route "
        f"{packed_routes}, save "
        f"{save_s:.2f} s, load {load_s:.2f} s, loads back bit for bit "
        f"{exact}")
    if not exact or packed_launches != want_packed or any(
            n for r, n in packed_routes.items() if r not in B7_MAIN_ROUTES):
        fail("adaptive-full: packed save does not load back bit for bit or "
             "B7 launches differ or leave the banded/split routes")
    del tr_c, back
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(arch="yi-9b", layers=L, params=n_params, steps=rows_a,
                resumed=rows_b1 + rows_c, decisions=meta_a["log"],
                variants=variants_a, telemetry_s=t_tel, plain_s=t_pln,
                saves=saves, loads=loads, peak_gib=peak,
                packed=dict(bytes=b_packed, unpacked_bytes=b_plain,
                            launches=packed_launches,
                            launches_by_route=packed_routes, save_s=save_s,
                            load_s=load_s),
                telemetry_split=tsplit,
                launches_telemetry=sum(
                    r["launches"]["bfp_quantize"] for r in rows_a),
                launches=_sum_counts(rows_a))


def _acc_tol(m: int) -> float:
    """The CPU test's tolerance of a row's tail loss and delta
    (tests/test_torch_design_space.py: tail_tol)."""
    return 0.06 if m == 4 else 0.01


def _acc_policy(spec, m, total_steps):
    from repro_torch.core import HBFPConfig
    from repro_torch.precision import as_policy
    if spec is not None and not isinstance(spec, str):
        block, tile = spec
        spec = HBFPConfig(m, 16, tile=tile) if tile \
            else HBFPConfig(m, 16).with_block(block)
    return as_policy(spec, total_steps=total_steps)


def _tail(losses) -> float:
    return sum(losses[-5:]) / 5


def _acc_smoke_losses(dev: str, names=None, threads: int = 0) -> dict:
    """(a)'s rows on `dev` ("cuda" or "cpu"), all or those `names`: {row:
    its 40 losses} at yi-9b smoke (bf16) from the port's own init (drawn
    on the CPU, copied to the card) and data; on `threads` CPU threads
    when given."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import OptState
    from repro_torch.train import TrainState, init_train_state, make_step
    arch = get_arch("yi-9b").smoke()
    sched = make_schedule("constant", base_lr=2e-3, warmup_steps=2,
                          total_steps=ACC_STEPS)
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(dev)
    pipe = SyntheticLM(arch.vocab_size, 33, 8, seed=0, device=dev)
    if threads:
        torch.set_num_threads(threads)
    losses = {}
    for name, m, spec in ACC_ROWS:
        if names is not None and name not in names:
            continue
        state = init_train_state(0, arch, device="cpu")
        if dev != "cpu":
            state = TrainState(to(state.params), OptState(
                0, to(state.opt.mu), to(state.opt.nu)), 0)
        step = make_step(arch, _acc_policy(spec, m, ACC_STEPS), sched,
                         device=dev)
        ls = []
        for i in range(ACC_STEPS):
            state, met = step(state, pipe.batch(i))
            ls.append(float(met["loss"]))
        losses[name] = ls
    return losses


def _acc_smoke_check(by_dev: dict, counts: dict, routes: dict) -> dict:
    """(a)'s verdict: each row's tail loss and delta on the card within
    the CPU test's tolerance of the CPU's. `by_dev`: {dev: {row:
    losses}}."""
    losses = {(d, n): ls for d, rows in by_dev.items()
              for n, ls in rows.items()}
    rows, bad = [], []
    fp = {d: _tail(losses[(d, "fp32")]) for d in ("cuda", "cpu")}
    for name, m, _ in ACC_ROWS:
        tg, tc = (_tail(losses[(d, name)]) for d in ("cuda", "cpu"))
        dg, dc = tg - fp["cuda"], tc - fp["cpu"]
        tol = _acc_tol(m)
        ok = all(map(lambda v: v == v and abs(v) < 1e30,
                     losses[("cuda", name)])) \
            and abs(tg - tc) <= tol and abs(dg - dc) <= tol
        # where the two runs part, and how far a step's gap strays after
        gaps = [a - b for a, b in zip(losses[("cuda", name)],
                                      losses[("cpu", name)])]
        parts = next((i for i, g in enumerate(gaps) if abs(g) > 1e-3), None)
        late = gaps[10:]
        mean = sum(late) / len(late)
        sd = (sum((g - mean) ** 2 for g in late) / len(late)) ** 0.5
        log(f"[accuracy smoke] {name:20s} tail loss card {tg:.4f} cpu "
            f"{tc:.4f} (gap {tg - tc:+.4f}), delta card {dg:+.4f} cpu "
            f"{dc:+.4f} (tol {tol}); parts at step {parts}, steps 10-39 "
            f"gap mean {mean:+.4f} sd {sd:.4f}"
            f"{'' if ok else '  <-- MISS'}")
        rows.append(dict(name=name, m=m, tail_card=tg, tail_cpu=tc,
                         delta_card=dg, delta_cpu=dc, tol=tol,
                         parts_at=parts, gap_mean=mean, gap_sd=sd,
                         losses_card=losses[("cuda", name)],
                         losses_cpu=losses[("cpu", name)]))
        if not ok:
            bad.append(name)
    if bad:
        fail(f"accuracy smoke: card rows {bad} outside the CPU test's "
             f"tolerance of the CPU losses")
    return dict(rows=rows, launches=counts, routes=routes)


def _acc_full(card: str, family: str, n_layers: int, bound: float) -> dict:
    """(b): `family` at full width (n_layers > 0 cuts the depth), 40 steps
    of 1 x 4096 markov tokens on the family's own LR schedule at ACC_LR
    under ACC_POLICIES (fp32 first) from one init: loss curves, deltas
    against fp32, step times, peak memory, exact launch counts and routes
    of B1-B6."""
    import torch
    from repro_torch.core import HBFPConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.precision import parse_policy
    from repro_torch.train import init_train_state, make_step
    arch, depth = _at_depth(family, n_layers)
    L = arch.n_layers
    tag = f"[accuracy {family}]"
    sched = make_schedule(arch.lr_schedule, base_lr=ACC_LR,
                          warmup_steps=ACC_WARMUP, total_steps=ACC_STEPS)
    pipe = SyntheticLM(arch.vocab_size, ACC_TOKENS + 1, 1, seed=0)
    batches = [pipe.batch(i) for i in range(ACC_STEPS)]
    # seven projections a layer, forward and recompute, and the head once
    # a CE chunk, recomputed too when the tokens take more than one chunk
    lc = arch.loss_chunk
    n = ACC_TOKENS // lc if lc and ACC_TOKENS > lc \
        and ACC_TOKENS % lc == 0 else 1
    per = 7 * L + n
    want = {"hbfp_matmul_fwd": ACC_STEPS * (14 * L + (2 * n if n > 1
                                                      else 1)),
            "hbfp_dgrad": ACC_STEPS * per, "hbfp_wgrad": ACC_STEPS * per,
            "hbfp_flash_fwd": ACC_STEPS * 2 * L,
            "hbfp_flash_dq": ACC_STEPS * L, "hbfp_flash_dkv": ACC_STEPS * L}
    runs, n_params = {}, 0
    for name, spec, base in ACC_POLICIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(0, arch)
        n_params = sum(t.numel() for _, t in named_leaves(state.params))
        pol = spec if base is None else parse_policy(
            spec, base=HBFPConfig(base[0], 16, tile=base[1]))
        step = make_step(arch, pol, sched)
        _reset_counts()
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, met = step(state, b)
            losses.append(float(met["loss"]))
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counts, plain = _counts()
        routes = _routes()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, step
        launched = {k: counts[k] for k in want}
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        runs[name] = dict(spec=spec, tile=None if base is None else base[1],
                          losses=losses, tail=_tail(losses),
                          step_s=times, median_step_s=step_s,
                          tokens_per_s=ACC_TOKENS / step_s, peak_gib=peak,
                          launches=launched, routes=routes, plain=plain)
        log(f"{tag} {name}: losses "
            f"{[round(v, 4) for v in losses]}")
        log(f"{tag} {name}: tail {_tail(losses):.4f}, median step "
            f"{step_s:.3f} s (first {times[0]:.3f} s), "
            f"{ACC_TOKENS / step_s:.0f} tokens/s, peak {peak:.2f} GiB | "
            f"{card}")
        if not all(map(lambda v: v == v and abs(v) < 1e30, losses)):
            fail(f"{family} {name}: non-finite loss {losses}")
        if spec == "fp32":
            if any(launched.values()) or plain:
                fail(f"{family} fp32 ran HBFP kernels: {launched}, plain "
                     f"{plain}")
            continue
        log(f"{tag} {name}: launches over {ACC_STEPS} steps {launched} "
            f"(expected {want}); B1-B6 by route {routes}")
        if launched != want or plain:
            fail(f"{family} {name}: launch counts {launched} != {want} or "
                 f"plain calls {plain}")
        if not (_all_on({k: routes[k] for k in ROUTED_KERNELS}, "int8_wgmma")
                and _train_routes_ok(routes)):
            fail(f"{family} {name}: a launch left its tensor-core route: "
                 f"{routes}")
    fp = runs["fp32"]
    for name in runs:
        runs[name]["delta"] = runs[name]["tail"] - fp["tail"]
    log(f"{tag} full width: {depth}, d_model {arch.d_model}, "
        f"{arch.n_heads}/{arch.n_kv_heads} heads x {arch.hd}, d_ff "
        f"{arch.d_ff}, vocab {arch.vocab_size}, {n_params / 1e9:.3f} B "
        f"params, lr {ACC_LR} {arch.lr_schedule} (warm-up {ACC_WARMUP}); "
        f"delta vs fp32 (tail of 5) "
        + ", ".join(f"{n} {r['delta']:+.4f}" for n, r in runs.items())
        + f"; bound on {ACC_BOUND_ROW} {bound:.4f}")
    if not _tail(fp["losses"]) < sum(fp["losses"][:5]) / 5:
        fail(f"{family}: the fp32 loss did not fall {fp['losses']}")
    if abs(runs[ACC_BOUND_ROW]["delta"]) > bound:
        fail(f"{family}: {ACC_BOUND_ROW} delta "
             f"{runs[ACC_BOUND_ROW]['delta']:+.4f} outside the bound "
             f"{bound:.4f}")
    d8, d4 = runs[ACC_BOUND_ROW]["delta"], runs[ACC_CONTROL_ROW]["delta"]
    if d8 > d4 + ACC_CONTROL_NOISE:
        fail(f"{family}: {ACC_BOUND_ROW} delta {d8:+.4f} above "
             f"{ACC_CONTROL_ROW}'s {d4:+.4f} + {ACC_CONTROL_NOISE}")
    return dict(family=family, layers=L, params=n_params,
                lr=ACC_LR, schedule=arch.lr_schedule, bound=bound,
                runs=runs)


def _acc_cpu_start():
    """Start (a)'s CPU half: the smoke grid's rows dealt out to
    ACC_CPU_PROCS processes of ACC_CPU_THREADS threads at the lowest CPU
    priority; (the pool, the futures of their losses)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(ACC_CPU_PROCS,
                               mp_context=multiprocessing.get_context(
                                   "spawn"), initializer=os.nice,
                               initargs=(19,))
    names = [r[0] for r in ACC_ROWS]
    return pool, [pool.submit(_acc_smoke_losses, "cpu",
                              names[i::ACC_CPU_PROCS], ACC_CPU_THREADS)
                  for i in range(ACC_CPU_PROCS)]


def phase_accuracy(card: str, cpu=None) -> dict:
    """The paper's accuracy claim on the port: (a) the smoke grid on the
    card, (b) minicpm-2b and phi3-mini at full width, the bound on HBFP8
    tile 24's delta max(0.1, 3x its smoke delta on the card) and HBFP8
    tile 24 no worse than HBFP4 tile 24 plus ACC_CONTROL_NOISE; (a)'s CPU
    half runs in ACC_CPU_PROCS processes beside both (`cpu`: started
    earlier by `_acc_cpu_start`, beside the training phases) and is
    checked last."""
    t0 = time.perf_counter()
    pool, on_cpu = cpu if cpu is not None else _acc_cpu_start()
    with pool:
        _reset_counts()
        by_dev = {"cuda": _acc_smoke_losses("cuda")}
        counts, _ = _counts()
        routes = _routes()
        log(f"[accuracy smoke] {len(ACC_ROWS)} rows x {ACC_STEPS} steps on "
            f"the card: {time.perf_counter() - t0:.1f} s")
        d8 = _tail(by_dev["cuda"][ACC_BOUND_ROW]) \
            - _tail(by_dev["cuda"]["fp32"])
        bound = max(0.1, 3 * abs(d8))
        full = {f: _acc_full(card, f, n, bound) for f, n in ACC_FULL}
        log(f"[accuracy] the card's half done by "
            f"{time.perf_counter() - t0:.1f} s")
        by_dev["cpu"] = {n: ls for f in on_cpu for n, ls in
                         f.result().items()}
    log(f"[accuracy smoke] the CPU half ({ACC_CPU_PROCS} processes of "
        f"{ACC_CPU_THREADS} threads) done by "
        f"{time.perf_counter() - t0:.1f} s")
    smoke = _acc_smoke_check(by_dev, counts, routes)
    return dict(smoke=smoke, full=full, bound=bound)


def _dist_setup():
    """(arch, depth words, data_fn, schedule) of the dist phase: every
    process draws the same global batch and init."""
    from repro_torch.data import batch_for_arch
    from repro_torch.optim import make_schedule
    arch, depth = _at_depth(DIST_ARCH, DIST_LAYERS)
    data = lambda i: batch_for_arch(arch, DIST_B, DIST_S, step=i,
                                    kind="markov")
    sched = make_schedule("constant", base_lr=1e-4, warmup_steps=0,
                          total_steps=100)
    return arch, depth, data, sched


def _dist_b7_cases(arch) -> list:
    """B7 at the (1, 512) tiling `core.grad_compress` packs every gradient
    leaf with (f32 after the cast, m 8), one case per distinct 2-D
    operand, against its plain version in all five outputs; timed."""
    import torch
    from repro_torch.core import bfp
    from repro_torch.core.grad_compress import COMPRESS_TILE, _flat_tile
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import named_leaves
    shapes = {}
    for name, t in named_leaves(init_params(0, arch, device="meta")):
        lead, R, C, _, _, merged = bfp.b7_layout(tuple(t.shape),
                                                 _flat_tile(t))
        if not merged:
            fail(f"dist: {name}'s (1, 512) tiles are not one B7 operand")
        rows = R
        for d in lead:
            rows *= d
        shapes.setdefault((rows, C), []).append(name)
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows_out = []
    for (R, C), names in sorted(shapes.items()):
        x = torch.randn((R, C), generator=gen, device="cuda") * 1e-3
        kw = dict(mantissa_bits=8, tile_r=1, tile_c=COMPRESS_TILE,
                  stochastic=False, with_stats=True)
        run = lambda: bq.bfp_quantize(x, 0, **kw)
        plain = lambda: bq.bfp_quantize_plain(x, 0, **kw)
        want_route = bq.bfp_quantize_route(R, C, 1, COMPRESS_TILE, x.dtype,
                                           8, x.data_ptr() % 16 == 0)
        bq.reset_counts()
        got = run()
        route = [r for r, n in bq.bfp_quantize.launches_by_route.items()
                 if n]
        want = plain()
        ok = len(got) == 5 and all(a.dtype == b.dtype and torch.equal(a, b)
                                   for a, b in zip(got, want))
        err = float((got[0].int() - want[0].int()).abs().max())
        del got, want
        bound, by = _quant_bound(R, C, 8, 1, COMPRESS_TILE, 256, 512, 4)
        n = _reps(run)
        row = dict(kernel="bfp_quantize", case=f"grad_{R}x{C}", R=R, C=C,
                   leaves=names, dtype="float32", m=8,
                   tile=[1, COMPRESS_TILE], ok=bool(ok),
                   route=route[0] if len(route) == 1 else route,
                   check="EQ (5 outputs)", max_abs_err=err, bound_ms=bound,
                   bound_by=by, kernel_ms=_time_ms(run, n),
                   plain_ms=_time_ms(plain, 2), device_ms=_graph_ms(run),
                   reps=n)
        rows_out.append(row)
        log(f"[dist b7] {R}x{C} f32 m=8 tile=1x{COMPRESS_TILE} "
            f"({', '.join(names)}) route={row['route']} EQ={ok} "
            f"kernel_ms={row['kernel_ms']:.4f} device_ms="
            f"{row['device_ms']:.4f} bound_ms={bound:.4f} plain_ms="
            f"{row['plain_ms']:.2f}")
        del x
        if not ok:
            fail(f"bfp_quantize != plain at the gradient tiling: {row}")
        if route != [want_route]:
            fail(f"bfp_quantize launched on {route}, its route table says "
                 f"{want_route}: {row}")
    torch.cuda.empty_cache()
    return rows_out


def _dist_compress_checks(grads, tp, mean_tp=None) -> dict:
    """`compressed_psum_tree` of a gradient tree over `tp`'s group: B7's
    launches and routes (one per leaf), its wire bytes (int8 all-gathers)
    against an f32 all-reduce's payload, the error of the mean against
    the plain mean (an f32 all-reduce over `mean_tp`, or the leaf itself
    on one rank), and residual + decompress(packed) == g exactly (the
    packing redone after the counts are read)."""
    import torch
    from repro_torch.core.grad_compress import (compress,
                                                compressed_psum_tree,
                                                decompress)
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.optim.adamw import named_leaves
    leaves = dict(named_leaves(grads))
    torch.cuda.synchronize()
    bq.reset_counts()
    mark = len(tp.records)
    t0 = time.perf_counter()
    red, res = compressed_psum_tree(grads, tp.group, transport=tp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = bq.bfp_quantize.launches
    routes = dict(bq.bfp_quantize.launches_by_route)
    plain = bq.bfp_quantize.plain_calls
    wire = tp.bytes_by_kind(mark)
    numel = sum(g.numel() for g in leaves.values())
    red, res = dict(named_leaves(red)), dict(named_leaves(res))
    rel, exact = 0.0, True
    for name, g in leaves.items():
        gf = g.to(torch.float32) + torch.zeros_like(g, dtype=torch.float32)
        mean = gf.clone() if mean_tp is None else \
            mean_tp.all_reduce_(gf.clone()) / mean_tp.size
        rel = max(rel, float((red[name].to(torch.float32) - mean).abs().max()
                             / mean.abs().max().clamp_min(1e-30)))
        del mean
        exact &= bool(torch.equal(res[name] + decompress(compress(gf)), gf))
        del gf
    out = dict(b7_launches=launches, b7_routes=routes, b7_plain=plain,
               leaves=len(leaves), seconds=seconds,
               wire_int8_bytes=sum(wire.values()), f32_bytes=4 * numel,
               wire_by_kind=wire, rel_err=rel, feedback_exact=exact)
    del red, res
    torch.cuda.empty_cache()
    return out


def _dist_nccl(card: str) -> dict:
    """(b): one process's gradients (gemma2-2b at the phase's depth, the
    full batch, from the seeded init) through `compressed_psum_tree` on a
    one-rank NCCL group."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.transport import Transport, init_process_group
    from repro_torch.train import init_train_state, make_step
    arch, depth, data, sched = _dist_setup()
    state = init_train_state(0, arch)
    _, _, grads = make_step(arch, DIST_SPEC, sched).grads(state, data(0))
    del state
    torch.cuda.empty_cache()
    backend = init_process_group(0, 1, _free_port())
    try:
        out = _dist_compress_checks(grads, Transport())
    finally:
        dist.destroy_process_group()
    del grads
    torch.cuda.empty_cache()
    log(f"[dist one] {DIST_ARCH} {depth}, compressed reduce of one "
        f"process's gradients on a one-rank {backend} group: B7 "
        f"{out['b7_launches']} launches {out['b7_routes']} for "
        f"{out['leaves']} leaves, error against the leaf "
        f"{out['rel_err']:.4g}, residual identity {out['feedback_exact']}, "
        f"{out['seconds']:.2f} s | {card}")
    if backend != "nccl" or out["b7_launches"] != out["leaves"] or \
            out["b7_plain"] or not out["feedback_exact"] or \
            out["rel_err"] > DIST_COMPRESS_TOL:
        fail(f"one-rank {backend} compressed reduce: {out}")
    return dict(out, backend=backend)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_to_host(state):
    """A TrainState with its tensors copied to the host."""
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train.zero import _unflatten
    host = lambda t: _unflatten({n: x.to("cpu", copy=True)
                                 for n, x in named_leaves(t)})
    return type(state)(params=host(state.params),
                       opt=type(state.opt)(step=state.opt.step,
                                           mu=host(state.opt.mu),
                                           nu=host(state.opt.nu)),
                       step=state.step)


def _dist_equal(a, b) -> bool:
    """Two TrainStates equal bit for bit (leaves on one device)."""
    import torch
    from repro_torch.optim.adamw import named_leaves
    pairs = ((a.params, b.params), (a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu))
    return a.step == b.step and a.opt.step == b.opt.step and all(
        torch.equal(x, dict(named_leaves(tb))[k])
        for ta, tb in pairs for k, x in named_leaves(ta))


def _dist_one_process(arch, data, sched, dp_master: dict) -> dict:
    """Rank 0, the card to itself: one process takes the ranks' 4 steps
    on the full batch from the same init; its losses, and its updates
    against the ranks' (p4 - p0, relative Frobenius per leaf, on the
    card)."""
    import torch
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(0, arch)
    p0 = {n: t.to("cpu", copy=True) for n, t in named_leaves(state.params)}
    trainer = Trainer(train_step=make_step(arch, DIST_SPEC, sched),
                      init_state=state, data_fn=data, seed=SR_SEED)
    lines = []
    t0 = time.perf_counter()
    trainer.run(DIST_STEPS, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    upd, dp_master = {}, dict(named_leaves(dp_master))
    for name, b in named_leaves(trainer.state.params):
        a = torch.from_numpy(dp_master[name]).cuda()
        d = torch.linalg.vector_norm((b - p0[name].cuda()).double())
        upd[name] = float(torch.linalg.vector_norm((a - b).double())
                          / d.clamp_min(1e-30))
        del a
    return dict(losses=[float(ln.split("loss=")[1].split()[0])
                        for ln in lines], seconds=seconds,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                update_rel=upd)


def _dist_resume(mesh, out: str, rank: int) -> dict:
    """The preempted resume on two ranks at gemma2-2b smoke width: a run
    checkpointing at step 2 and preempted at 3, the uninterrupted run
    (step 3 from its state), and a run resumed from the step-2
    checkpoint that writes the step-4 one; rank 0 then loads that
    checkpoint in one process. (At full width a checkpoint of gemma2-2b
    at 2 layers is ~16 GB of f32 master and moments, and one call of the
    card's tool may write 45 GiB in all, of which the earlier phases'
    checkpoints take ~37.)"""
    import dataclasses
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for_arch
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    arch = dataclasses.replace(get_arch(DIST_ARCH).smoke(), n_layers=2)
    data = lambda i: batch_for_arch(arch, DIST_B, 64, step=i, kind="markov")
    _, _, _, sched = _dist_setup()
    step = make_step(arch, DIST_SPEC, sched, mesh=mesh)
    ckpt = os.path.join(out, "ckpt")
    kw = dict(train_step=step, data_fn=data, ckpt_every=2, seed=SR_SEED)
    first = Trainer(init_state=init_train_state(0, arch, mesh=mesh),
                    ckpt_dir=ckpt, **kw)
    preempted = None
    try:
        first.run(DIST_STEPS, fail_at_step=3, log_fn=None)
    except RuntimeError as e:
        preempted = str(e)
    whole = Trainer(init_state=first.state, **kw)
    whole.run(DIST_STEPS, log_fn=None)
    resumed = Trainer(init_state=init_train_state(0, arch, mesh=mesh),
                      ckpt_dir=ckpt, **kw)
    resumed_from = resumed.start_step
    resumed.run(DIST_STEPS, log_fn=None)
    exact = _dist_equal(resumed.state, whole.state)
    full = step.layout.gather_state(whole.state)
    loaded = None
    if rank == 0:
        state, meta = load_checkpoint(ckpt, init_train_state(0, arch))
        host = _dist_to_host(state)
        loaded = meta["step"] == DIST_STEPS and all(
            torch.equal(t, torch.from_numpy(dict(named_leaves(w))[n]))
            for tree, w in ((host.params, full.params),
                            (host.opt.mu, full.opt.mu),
                            (host.opt.nu, full.opt.nu))
            for n, t in named_leaves(tree))
    return dict(arch="gemma2-2b smoke, 2 layers", preempted=preempted,
                resumed_from=resumed_from, resume_exact=exact,
                ckpt_loads_in_one_process=loaded)


def dist_rank(rank: int, n: int, port: int, out: str) -> int:
    """`--dist-rank RANK N DIR`: one rank of the dist phase (c) and
    (d); writes DIR/rank<RANK>.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.transport import Transport, init_process_group
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = init_process_group(rank, n, port)
    mesh = make_host_mesh()
    arch, depth, data, sched = _dist_setup()
    step = make_step(arch, DIST_SPEC, sched, mesh=mesh)
    tp = step.layout.transport
    sink, lines = MemorySink(), []
    trainer = Trainer(train_step=step, data_fn=data, seed=SR_SEED,
                      init_state=init_train_state(0, arch, mesh=mesh),
                      recorder=Recorder([sink]))
    trainer.run(1, log_every=1, log_fn=lines.append)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hm.reset_counts()                         # counts cover the main path
    mark, staged0 = len(tp.records), dict(tp.staged)
    trainer.run(DIST_STEPS, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    counts = {k: getattr(hm, k).launches for k in GEMM_KERNELS}
    routes = {k: dict(getattr(hm, k).launches_by_route)
              for k in GEMM_KERNELS}
    plain = sum(getattr(hm, k).plain_calls for k in GEMM_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counted = DIST_STEPS - 1
    step_bytes = {k: v / counted for k, v in tp.bytes_by_kind(mark).items()}
    step_coll_s = {k: v / counted
                   for k, v in tp.seconds_by_kind(mark).items()}
    staged = {k: (v - staged0.get(k, 0)) / counted
              for k, v in tp.staged.items()}
    spans = [ev.data["dur_us"] / 1e6 for ev in sink.events
             if ev.kind == "span" and ev.data.get("name") == "train/step"]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    torch.cuda.reset_peak_memory_stats()
    _, _, grads = step.grads(trainer.state, data(DIST_STEPS))
    compress = _dist_compress_checks(grads, Transport(tp.group),
                                     Transport(tp.group))
    compress["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del grads
    t0 = time.perf_counter()
    master = step.layout.gather(trainer.state.params)
    gather_s = time.perf_counter() - t0
    del trainer, step
    torch.cuda.empty_cache()
    tp.barrier()
    one = None
    if rank == 0:          # the other rank waits with its card memory freed
        one = _dist_one_process(arch, data, sched, master)
    del master
    torch.cuda.empty_cache()
    tp.barrier()
    resume = _dist_resume(mesh, out, rank)
    torch.cuda.empty_cache()
    tp.barrier()
    sr, sr_one = _sr_rank_pair(mesh, arch, data, sched, out, "sr_dist",
                               rank, n, lambda: tp.barrier())
    result = dict(rank=rank, backend=backend, depth=depth,
                  tokens=DIST_B * DIST_S // n, losses=losses,
                  step_s=spans[1:], peak_gib=peak, launches=counts,
                  routes=routes, plain_calls=plain, step_bytes=step_bytes,
                  step_collective_s=step_coll_s, staged_per_step=staged,
                  master_gather_s=gather_s, compress=compress, one=one,
                  resume=resume, sr=dict(sr, one=sr_one))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def phase_dist(card: str) -> dict:
    """ROADMAP A13 on the card (the module docstring's 11e)."""
    arch, depth, _, _ = _dist_setup()
    b7 = _dist_b7_cases(arch)
    nccl = _dist_nccl(card)
    out = _ranks_dir("dist_ranks")
    ranks_s = _run_ranks("--dist-rank", DIST_RANKS, out)
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    T = DIST_B * DIST_S // DIST_RANKS
    want = {k: v for k, v in _train_launches(arch, T).items()
            if k in GEMM_KERNELS}
    for res in ranks:
        r, c, rs = res["rank"], res["compress"], res["resume"]
        log(f"[dist rank {r}] {res['backend']}, {depth}, {T} tokens: "
            f"losses {res['losses']}, step times "
            f"{[round(t, 3) for t in res['step_s']]} s, peak "
            f"{res['peak_gib']:.2f} GiB (compressed reduce "
            f"{c['peak_gib']:.2f}) | {card}")
        log(f"[dist rank {r}] B1-B3 over 3 steps {res['launches']} "
            f"(expected {want}), by route {res['routes']}; a step's "
            f"collectives: bytes {res['step_bytes']}, host seconds "
            f"{res['step_collective_s']}, staged through host "
            f"{res['staged_per_step']}; the master gathered to rank 0 in "
            f"{res['master_gather_s']:.1f} s")
        log(f"[dist rank {r}] compressed reduce: B7 {c['b7_launches']} "
            f"launches {c['b7_routes']} for {c['leaves']} leaves, wire "
            f"{c['wire_int8_bytes'] / 1e9:.3f} GB int8 against "
            f"{c['f32_bytes'] / 1e9:.3f} GB f32 "
            f"({c['f32_bytes'] / c['wire_int8_bytes']:.2f}x), error "
            f"against the plain mean {c['rel_err']:.4g}, residual identity "
            f"{c['feedback_exact']}, {c['seconds']:.2f} s")
        log(f"[dist rank {r}] {rs['arch']}: {rs['preempted']}; resumed "
            f"from step {rs['resumed_from']}, bit-exact "
            f"{rs['resume_exact']}; checkpoint loads in one process "
            f"{rs['ckpt_loads_in_one_process']}")
        if res["backend"] != "gloo":
            fail(f"dist: two ranks on one card took {res['backend']}")
        if res["launches"] != want or res["plain_calls"]:
            fail(f"dist rank {r}: launches {res['launches']} != {want} or "
                 f"plain calls {res['plain_calls']}")
        if not _all_on({k: res["routes"][k] for k in ROUTED_KERNELS},
                       "int8_wgmma") or not _all_on(
                {"hbfp_wgrad": res["routes"]["hbfp_wgrad"]}, "bf16_wgmma"):
            fail(f"dist rank {r}: a launch off its training route: "
                 f"{res['routes']}")
        if not all(abs(x) < float("inf") for x in res["losses"]) or \
                res["losses"] != ranks[0]["losses"]:
            fail(f"dist rank {r}: losses {res['losses']}")
        if rs["preempted"] != "simulated preemption at step 3" or \
                rs["resumed_from"] != 2 or not rs["resume_exact"] or \
                (r == 0 and rs["ckpt_loads_in_one_process"] is not True):
            fail(f"dist rank {r}: the preempted run did not resume "
                 f"bit-exactly, or its checkpoint did not load: {rs}")
        if c["b7_launches"] != c["leaves"] or c["b7_plain"] or \
                not c["feedback_exact"] or c["rel_err"] > DIST_COMPRESS_TOL:
            fail(f"dist rank {r}: compressed reduce {c}")
    one, losses = ranks[0]["one"], ranks[0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       one["losses"]))
    upd = one["update_rel"]
    worst = max(upd, key=upd.get)
    log(f"[dist] {DIST_RANKS} ranks against one process on the full batch "
        f"(peak {one['peak_gib']:.2f} GiB, {DIST_STEPS} steps in "
        f"{one['seconds']:.1f} s): losses {losses} vs {one['losses']} "
        f"(worst rel {loss_rel:.3g}, tol {DIST_TOL['loss']}); updates "
        f"p{DIST_STEPS} - p0 within rel {upd[worst]:.3g} ({worst}; tol "
        f"{DIST_TOL['updates']}); ranks {ranks_s:.1f} s | {card}")
    if loss_rel > DIST_TOL["loss"] or upd[worst] > DIST_TOL["updates"]:
        fail(f"dist: two ranks part from one process: losses {losses} vs "
             f"{one['losses']}, updates {upd}")
    sr = _sr_check("dist", card, [r["sr"] for r in ranks],
                   ranks[0]["sr"]["one"], want, depth)
    return dict(b7_cases=b7, ranks=ranks, ranks_s=ranks_s, nccl=nccl,
                loss_rel=loss_rel, sr=sr)


def _tp_amax_cases(card: str) -> list:
    """(d): B1, B2 and B3 with the row-amax input at gemma2-2b's
    row-parallel shapes a rank (ffn_wo, attn_wo) and at the head's dgrad
    (128,000 columns a rank), on the training routes, against their plain
    versions: at the default tiles with each group's own amax ([M, K/128];
    it must change nothing), and with one exponent group a row (bk the
    rank's K, as the sim path groups) on the global row amax of a
    two-rank split. B1, B2 and B3's operands bit-equal; B3's dw within its
    bound."""
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []

    def check(name, op, got, want, ok_fn=None):
        same = torch.equal(got, want) if ok_fn is None else ok_fn(got, want)
        rows.append(dict(name=name, op=op, ok=bool(same),
                         max_abs_err=float((got - want).abs().max())))
        if not same:
            fail(f"tp amax {name} {op}: kernel != plain version")

    cases = [(n, M, K, N, "row") for n, (M, K, N) in TP_AMAX_SHAPES.items()]
    cases.append(("head_dgrad", *TP_HEAD_DGRAD, "col"))
    for name, M, K, N, kind in cases:
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(K, N, device="cuda", generator=gen)
             * K ** -0.5).to(torch.bfloat16)
        g = (torch.randn(M, N, device="cuda", generator=gen)
             * 1e-3).to(torch.bfloat16)
        other = torch.randn(M, 1, device="cuda", generator=gen).abs() * 4
        for tiling in ("default", "row"):
            if kind == "row":
                bk = 128 if tiling == "default" else K
                own = x.float().abs().reshape(M, K // bk, bk).amax(-1)
                glob = torch.maximum(own, other) if tiling == "row" else own
                kw = dict(bk=bk, bn=128)
                hm.reset_counts()
                y = hm.hbfp_matmul_fwd(x, w, x_amax=glob.contiguous(), **kw)
                ms = _time_ms(lambda: hm.hbfp_matmul_fwd(
                    x, w, x_amax=glob.contiguous(), **kw), 5)
                route = dict(hm.hbfp_matmul_fwd.launches_by_route)
                want = hm.hbfp_matmul_plain(x, w, x_amax=glob, **kw)
                check(f"{name}/{tiling}", "B1", y, want)
                if tiling == "default":
                    check(f"{name}/{tiling}", "B1 own amax", y,
                          hm.hbfp_matmul_fwd(x, w, **kw))
                dw, xh, gh = hm.hbfp_wgrad(x, g, bm=128, bk=bk, bn=128,
                                           operands=True,
                                           x_amax=glob.contiguous())
                dwp, xhp, ghp = hm.hbfp_wgrad_plain(
                    x, g, bm=128, bk=bk, bn=128, operands=True, x_amax=glob)
                check(f"{name}/{tiling}", "B3 x̂", xh, xhp)
                check(f"{name}/{tiling}", "B3 dw", dw, dwp,
                      lambda a, b: _wgrad_ok(a, b, xhp, ghp, M)[0])
                log(f"[tp amax] {name} ({M}x{K}x{N}) {tiling} tiles: B1 "
                    f"{ms:.3f} ms on {route}, bit-equal; B3 x̂ bit-equal, dw "
                    f"within its bound | {card}")
                rows[-1]["ms_b1"] = ms
            else:
                bn = 128 if tiling == "default" else N
                own = g.float().abs().reshape(M, N // bn, bn).amax(-1)
                glob = torch.maximum(own, other * 1e-3) \
                    if tiling == "row" else own
                kw = dict(bk=128, bn=bn)
                hm.reset_counts()
                dx = hm.hbfp_dgrad(g, w, g_amax=glob.contiguous(), **kw)
                ms = _time_ms(lambda: hm.hbfp_dgrad(
                    g, w, g_amax=glob.contiguous(), **kw), 3)
                route = dict(hm.hbfp_dgrad.launches_by_route)
                check(f"{name}/{tiling}", "B2", dx,
                      hm.hbfp_dgrad_plain(g, w, g_amax=glob, **kw))
                if tiling == "default":
                    check(f"{name}/{tiling}", "B2 own amax", dx,
                          hm.hbfp_dgrad(g, w, **kw))
                log(f"[tp amax] {name} ({M}x{K}x{N}) {tiling} tiles: B2 "
                    f"{ms:.3f} ms on {route}, bit-equal | {card}")
                rows[-1]["ms_b2"] = ms
            del glob, own
        del x, w, g
        torch.cuda.empty_cache()
    rows += _tp_amax_routes(card, gen)
    return rows


def _tp_amax_routes(card: str, gen) -> list:
    """B1 and B2 on each of their three routes (int8 wgmma; bf16 wgmma
    on narrowed bf16 weights taken as stored, as served; the CUDA cores
    at m 12) at 128-tiles with a per-group amax above the groups' own,
    and B3 on both of its (bf16 wgmma; the CUDA cores at m 12) with one
    group a row, against their plain versions: B1/B2 bit-equal, B3's
    operands bit-equal and dw within its bound; each launch's route
    checked."""
    import torch
    from repro_torch.core import bfp
    from repro_torch.core.formats import HBFPConfig
    from repro_torch.kernels import hbfp_matmul as hm
    M, K, N = 256, 512, 384
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(M, N, device="cuda", generator=gen).to(torch.bfloat16)
    w = bfp.quantize_weight((torch.randn(K, N, device="cuda", generator=gen)
                             * K ** -0.5), HBFPConfig(8, 16, tile=128)
                            ).to(torch.bfloat16)
    up = 1.0 + torch.rand(M, 1, device="cuda", generator=gen) * 3
    group = lambda a: (a.float().abs().reshape(M, -1, 128).amax(-1)
                       * up).contiguous()
    ax, ag = group(x), group(g)
    rows = []
    for route, m, qw in (("int8_wgmma", 8, True), ("bf16_wgmma", 8, False),
                         ("cuda_core", 12, True)):
        kw = dict(mantissa_bits=m, quantize_w=qw, bk=128, bn=128)
        hm.reset_counts()
        y = hm.hbfp_matmul_fwd(x, w, x_amax=ax, **kw)
        dkw = kw
        dx = hm.hbfp_dgrad(g, w, g_amax=ag, **dkw)
        got = (dict(hm.hbfp_matmul_fwd.launches_by_route),
               dict(hm.hbfp_dgrad.launches_by_route))
        ok = torch.equal(y, hm.hbfp_matmul_plain(x, w, x_amax=ax, **kw)) \
            and torch.equal(dx, hm.hbfp_dgrad_plain(g, w, g_amax=ag, **dkw))
        on = got[0][route] == 1 and got[1][route] == 1
        rows.append(dict(name=f"routes/{route}", op="B1 B2", ok=ok and on))
        log(f"[tp amax] B1/B2 on {route} (m {m}) with a row amax: "
            f"bit-equal {ok}, routes {got} | {card}")
        if not (ok and on):
            fail(f"tp amax: B1/B2 on {route}: bit-equal {ok}, routes {got}")
    ax, ag = ax.amax(-1).contiguous(), ag.amax(-1).contiguous()
    for route, m in (("bf16_wgmma", 8), ("cuda_core", 12)):
        kw = dict(mantissa_bits=m, bm=128, bk=K, bn=N, operands=True)
        hm.reset_counts()
        dw, xh, gh = hm.hbfp_wgrad(x, g, x_amax=ax, g_amax=ag, **kw)
        got = dict(hm.hbfp_wgrad.launches_by_route)
        dwp, xhp, ghp = hm.hbfp_wgrad_plain(x, g, x_amax=ax, g_amax=ag, **kw)
        ok = torch.equal(xh, xhp) and torch.equal(gh, ghp) and \
            _wgrad_ok(dw, dwp, xhp, ghp, M)[0]
        on = got[route] == 1
        rows.append(dict(name=f"routes/{route}", op="B3", ok=ok and on))
        log(f"[tp amax] B3 on {route} (m {m}) with a row amax: operands "
            f"bit-equal and dw within bound {ok}, routes {got} | {card}")
        if not (ok and on):
            fail(f"tp amax: B3 on {route}: {ok}, routes {got}")
    return rows


def _tp_setup(name: str, layers: int, B: int, S: int):
    from repro_torch.data import batch_for_arch
    from repro_torch.optim import make_schedule
    arch, depth = _at_depth(name, layers)
    data = lambda i: batch_for_arch(arch, B, S, step=i, kind="markov")
    sched = make_schedule("constant", base_lr=1e-4, warmup_steps=0,
                          total_steps=100)
    return arch, depth, data, sched


def _tp_ep_setup():
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for_arch
    from repro_torch.optim import make_schedule
    arch = dataclasses.replace(get_arch(TP_EP).smoke(), dtype="float32")
    data = lambda i: batch_for_arch(arch, TP_EP_B, TP_EP_S, step=i,
                                    kind="markov")
    return arch, data, make_schedule("constant", base_lr=1e-3,
                                     warmup_steps=0, total_steps=10)


def _tp_one_process(arch, data, sched, lay, spec=DIST_SPEC,
                    steps=DIST_STEPS) -> dict:
    """One process on the full batch from the same init, run by every
    rank at once (the card holds both): its losses, and this rank's model
    part of its init and final master on the host (`lay`, the mesh
    run's layout, says which part)."""
    import torch
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(0, arch)
    part = lambda tree: {n: lay.part(n, t).to("cpu", copy=True)
                         for n, t in named_leaves(tree)}
    p0 = part(state.params)
    trainer = Trainer(train_step=make_step(arch, spec, sched),
                      init_state=state, data_fn=data, seed=SR_SEED)
    lines = []
    trainer.run(steps, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    out = dict(losses=[float(ln.split("loss=")[1].split()[0])
                       for ln in lines],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               p0=p0, pend=part(trainer.state.params))
    del trainer, state
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_update_rel(lay, params, one) -> dict:
    """The mesh run's updates against one process's, p_end - p0, relative
    Frobenius per leaf: each rank's sums of squares over its model part
    (a replicated leaf on rank 0 only), summed over the model ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim.adamw import named_leaves
    names, sums = [], []
    for n, a in named_leaves(params):
        mine = lay.tp_dims[n] is not None or lay.rank_m == 0
        b = one["pend"][n].to(a.device)
        d = (a - b).double().square().sum() if mine else a.new_zeros(
            (), dtype=torch.float64)
        u = (b - one["p0"][n].to(a.device)).double().square().sum() \
            if mine else d.new_zeros(())
        names.append(n)
        sums.append(torch.stack([d, u]).cpu())
    tot = torch.stack(sums)
    dist.all_reduce(tot, group=lay.model.group)
    return {n: float(tot[i, 0].sqrt() / tot[i, 1].sqrt().clamp_min(1e-30))
            for i, n in enumerate(names)}


def _tp_mesh_run(mesh, arch, data, sched, sp: bool, one: dict,
                 spec=DIST_SPEC, steps=DIST_STEPS) -> dict:
    """A warm-up step and the counted ones on the mesh through the
    Trainer, held to the one-process run `one` (`_tp_one_process`)."""
    import hashlib
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    t0 = time.perf_counter()
    step = make_step(arch, spec, sched, mesh=mesh, seq_parallel=sp)
    lay = step.layout
    sink, lines = MemorySink(), []
    trainer = Trainer(train_step=step, data_fn=data, seed=SR_SEED,
                      init_state=init_train_state(0, arch, mesh=lay),
                      recorder=Recorder([sink]))
    t_init = time.perf_counter() - t0
    trainer.run(1, log_every=1, log_fn=lines.append)         # warm-up
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0 - t_init
    torch.cuda.reset_peak_memory_stats()
    hm.reset_counts()                         # counts cover the main path
    axes = {"data": lay.transport, "model": lay.model}
    marks = {k: (len(t.records), dict(t.staged)) for k, t in axes.items()}
    trainer.run(steps, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    counted = steps - 1
    per_step = lambda d: {k: v / counted for k, v in d.items()}
    coll = {k: dict(bytes=per_step(t.bytes_by_kind(marks[k][0])),
                    seconds=per_step(t.seconds_by_kind(marks[k][0])),
                    staged=per_step({s: v - marks[k][1].get(s, 0)
                                     for s, v in t.staged.items()}))
            for k, t in axes.items()}
    spans = [ev.data["dur_us"] / 1e6 for ev in sink.events
             if ev.kind == "span" and ev.data.get("name") == "train/step"]
    rep = hashlib.sha1()
    params = dict(named_leaves(trainer.state.params))
    for n in sorted(params):
        if lay.tp_dims[n] is None:
            rep.update(params[n].detach().cpu().numpy().tobytes())
    t1 = time.perf_counter()
    upd = _tp_update_rel(lay, trainer.state.params, one)
    res = dict(sp=sp, losses=[float(ln.split("loss=")[1].split()[0])
                              for ln in lines],
               step_s=spans[1:], peak_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30,
               launches={k: getattr(hm, k).launches for k in GEMM_KERNELS},
               routes={k: dict(getattr(hm, k).launches_by_route)
                       for k in GEMM_KERNELS},
               plain_calls=sum(getattr(hm, k).plain_calls
                               for k in GEMM_KERNELS),
               collectives=coll, replicas_sha1=rep.hexdigest(),
               replicated=sorted(lay.replicated), update_rel=upd,
               seconds=dict(init=t_init, warm_up=t_warm,
                            compare=time.perf_counter() - t1,
                            total=time.perf_counter() - t0))
    del trainer, step, lay, params
    torch.cuda.empty_cache()
    return res


def tp_rank(rank: int, n: int, port: int, out: str) -> int:
    """`--tp-rank RANK N DIR`: one rank of the tp phase (a)-(c) on a
    {data 1, model N} mesh of one card; writes DIR/tp<RANK>.json. Both
    ranks first take each configuration in one process at once, keeping
    their model part of its master on the host, then train it on the
    mesh."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.transport import init_process_group
    from repro_torch.train import make_step
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = init_process_group(rank, n, port)
    mesh = make_host_mesh(model=n)
    result = dict(rank=rank, backend=backend, runs={})
    cases = [(name, *_tp_setup(name, layers, B, S), B * S, sps)
             for name, layers, B, S, sps in TP_TRAIN]
    ep_arch, ep_data, ep_sched = _tp_ep_setup()
    cases.append((TP_EP, ep_arch, "smoke", ep_data, ep_sched,
                  TP_EP_B * TP_EP_S, (False,)))
    for name, arch, depth, data, sched, tokens, sps in cases:
        lay = make_step(arch, DIST_SPEC, sched, mesh=mesh).layout
        one = _tp_one_process(arch, data, sched, lay)
        del lay
        dist.barrier()
        runs = [_tp_mesh_run(mesh, arch, data, sched, sp, one)
                for sp in sps]
        result["runs"][name] = dict(
            depth=depth, tokens=tokens, mesh=runs,
            one={k: v for k, v in one.items() if k not in ("p0", "pend")})
        del one
    dist.barrier()
    # ROADMAP slice 19: gemma2-2b under SR_SPEC with SP on the same mesh
    arch, depth, data, sched = _tp_setup("gemma2-2b", SR_TP_LAYERS, 2, 2048)
    sr, sr_one = _sr_rank_pair(mesh, arch, data, sched, out, "sr_tp", rank,
                               n, dist.barrier, sp=True)
    result["sr"] = dict(sr, depth=depth, one=sr_one)
    with open(os.path.join(out, f"tp{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def phase_tp(card: str, world=None) -> dict:
    """ROADMAP A13's second half on the card (the module docstring's
    11f); `world`: its ranks, `_spawn_ranks`'s, or None."""
    t0 = time.perf_counter()
    amax = _tp_amax_cases(card)
    amax_s = time.perf_counter() - t0
    out = _ranks_dir("tp_ranks")
    ranks_s = _run_ranks("--tp-rank", TP_RANKS, out, procs=world)
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(out, f"tp{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    checks = {}
    for name, run0 in ranks[0]["runs"].items():
        if name == TP_EP:
            arch = _tp_ep_setup()[0]
        else:
            spec = next(t for t in TP_TRAIN if t[0] == name)
            arch = _tp_setup(*spec[:4])[0]
        T = run0["tokens"]
        want = {k: v for k, v in _train_launches(arch, T).items()
                if k in GEMM_KERNELS}
        one = run0["one"]
        for i, m0 in enumerate(run0["mesh"]):
            tag = f"{name} sp={m0['sp']}"
            for rank in ranks:
                res = rank["runs"][name]["mesh"][i]
                c = res["collectives"]
                log(f"[tp rank {rank['rank']}] {tag}, {run0['depth']}, {T} "
                    f"tokens: losses {res['losses']}, step times "
                    f"{[round(t, 3) for t in res['step_s']]} s, peak "
                    f"{res['peak_gib']:.2f} GiB; host seconds "
                    f"{ {k: round(v, 1) for k, v in res['seconds'].items()} }"
                    f" | {card}")
                log(f"[tp rank {rank['rank']}] {tag}: B1-B3 over 3 steps "
                    f"{res['launches']} (expected {want}), by route "
                    f"{res['routes']}; a step's collectives: model "
                    f"{c['model']}, data {c['data']}")
                if rank["backend"] != "gloo":
                    fail(f"tp: two ranks on one card took {rank['backend']}")
                if name != TP_EP and (res["launches"] != want
                                      or res["plain_calls"]):
                    fail(f"tp {tag}: launches {res['launches']} != {want} "
                         f"or plain calls {res['plain_calls']}")
                if name != TP_EP and (
                        not _all_on({k: res["routes"][k]
                                     for k in ROUTED_KERNELS}, "int8_wgmma")
                        or not _all_on({"hbfp_wgrad":
                                        res["routes"]["hbfp_wgrad"]},
                                       "bf16_wgmma")):
                    fail(f"tp {tag}: a launch off its training route: "
                         f"{res['routes']}")
                if res["losses"] != m0["losses"] or \
                        res["replicas_sha1"] != m0["replicas_sha1"]:
                    fail(f"tp {tag}: the ranks part: losses {res['losses']} "
                         f"vs {m0['losses']}, replicas {res['replicas_sha1']}"
                         f" vs {m0['replicas_sha1']}")
            loss_rel = max(abs(a - b) / abs(b)
                           for a, b in zip(m0["losses"], one["losses"]))
            upd = m0["update_rel"]
            worst = max(upd, key=upd.get)
            log(f"[tp] {tag} on {TP_RANKS} ranks against one process "
                f"(peak {one['peak_gib']:.2f} GiB, taken by each rank at "
                f"once in {one['seconds']:.1f} s): losses {m0['losses']} vs "
                f"{one['losses']} (worst rel {loss_rel:.3g}, tol "
                f"{DIST_TOL['loss']}); updates within rel {upd[worst]:.3g} "
                f"({worst}; tol {DIST_TOL['updates']}); replicated "
                f"{m0['replicated']}; replicas bit-identical | {card}")
            if loss_rel > DIST_TOL["loss"] or upd[worst] > \
                    DIST_TOL["updates"]:
                fail(f"tp {tag}: the ranks part from one process: losses "
                     f"{m0['losses']} vs {one['losses']}, worst update "
                     f"{worst} {upd[worst]}")
            checks[tag] = dict(loss_rel=loss_rel, update_rel=upd[worst],
                               worst=worst)
    arch = _tp_setup("gemma2-2b", SR_TP_LAYERS, 2, 2048)[0]
    want = {k: v for k, v in _train_launches(arch, 4096).items()
            if k in GEMM_KERNELS}
    sr = _sr_check("tp_sp", card, [r["sr"] for r in ranks],
                   ranks[0]["sr"]["one"], want, ranks[0]["sr"]["depth"])
    log(f"[tp] the B1-B3 row-amax cases {amax_s:.1f} s, the ranks "
        f"{ranks_s:.1f} s | {card}")
    return dict(amax_cases=amax, amax_s=amax_s, ranks=ranks,
                ranks_s=ranks_s, checks=checks, sr=sr)


# -- stochastic rounding under a mesh (ROADMAP slice 19) ---------------------

def _fingerprint(t) -> list:
    """Two 64-bit sums of t's bits, one weighted by a hash of each
    position, taken on the card a chunk at a time, and t's shape: equal
    tensors give equal prints; two that differ in any bit give equal
    prints only by a collision of the weighted sum."""
    import torch
    v = t.detach().contiguous().reshape(-1)
    v = v.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[
        v.element_size()])
    a = b = 0
    step = 1 << 24
    for i0 in range(0, v.numel(), step):
        c = v[i0:i0 + step].to(torch.int64)
        i = torch.arange(i0, i0 + c.numel(), device=c.device,
                         dtype=torch.int64)
        h = (i * -7046029254386353131) ^ (i >> 7)     # 0x9E3779B97F4A7C15
        a += int((c * h).sum())
        b += int(c.sum())
    m = (1 << 64) - 1
    return [a & m, b & m, list(t.shape)]


class _SROperands:
    """Within the block, every operand that B1-B3 quantize: the inputs as
    the kernels get them (padded 2-D), their quantized values (B3's own
    dequantized operands; B1's and B2's from the plain quantize passes,
    which the kernel cases hold the kernels to) and their index bases.
    Mode "rank" keeps (key, base, print of the input, print of the
    quantized operand); mode "one" (one process) takes the ranks' records
    and, for each of its own operands, slices it at each rank record's
    base and compares the prints: a rank's input may be one process's
    times the data size (a rank's loss is the mean of its tokens), a
    power of two that quantization keeps."""

    def __init__(self, ranks=None):
        self.records = []
        self.seen = set()
        self.one = ranks is not None
        self.by_key = {}
        for r, recs in enumerate(ranks or []):
            for rec in recs:
                self.by_key.setdefault(tuple(rec["key"]), []).append(
                    (r, rec))
        self.result = {"matched": {}, "bad": [], "checked": 0}

    def _add(self, what, seed, raw, quantize, base):
        """Record or check one operand; `quantize()` gives its quantized
        value, computed only where it is needed (a remat recompute
        repeats its forward's operands: printed once)."""
        import torch
        key = (what, int(seed))
        b = None if base is None else [list(base.shape), list(base.offset)]
        if not self.one:
            raw_print = _fingerprint(raw.to(torch.float32))
            if (key, tuple(raw_print[:2])) in self.seen:
                return
            self.seen.add((key, tuple(raw_print[:2])))
            self.records.append(dict(
                key=list(key), base=b, raw=raw_print,
                out=_fingerprint(quantize().to(torch.float32))))
            return
        out = None
        for r, rec in self.by_key.get(key, []):
            if rec.get("hit"):
                continue
            shape = rec["raw"][2]
            off = (0, 0) if rec["base"] is None else rec["base"][1]
            if off[0] + shape[0] > raw.shape[0] or \
                    off[1] + shape[1] > raw.shape[1]:
                continue
            sl = (slice(off[0], off[0] + shape[0]),
                  slice(off[1], off[1] + shape[1]))
            for f in (1.0, 2.0, 4.0):
                part = raw[sl].to(torch.float32) * f
                if _fingerprint(part)[:2] != rec["raw"][:2]:
                    continue
                rec["hit"] = True
                if out is None:
                    out = quantize()
                ok = _fingerprint(out[sl].to(torch.float32) * f)[:2] == \
                    rec["out"][:2]
                self.result["checked"] += 1
                self.result["matched"][what] = \
                    self.result["matched"].get(what, 0) + 1
                if not ok:
                    self.result["bad"].append([r, list(key)])
                break

    def __enter__(self):
        import torch
        from repro_torch.kernels import linear
        from repro_torch.kernels import ref
        self._saved = {n: getattr(linear, n) for n in
                       ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad")}
        fwd, dgrad, wgrad = (self._saved[n] for n in
                             ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad"))

        def rows(a, seed, width, kw, name, stream):
            af = a.to(torch.float32)
            out = torch.empty_like(af)
            C = af.shape[1]
            for c0 in range(0, C, width):
                q, d = ref._quantize_rows(
                    af, c0, width, C, kw["mantissa_bits"], kw.get("block", 0),
                    kw["stochastic"], ref._seed_value(seed), stream,
                    kw.get(f"{name}_amax"), kw.get(f"{name}_base"))
                out[:, c0:c0 + width] = q * d
            return out

        def wq(w, seed, kw):
            q, d = ref._quantize_w(w.to(torch.float32), 0, 0, w.shape[1],
                                   kw["bk"], kw["bn"], kw["mantissa_bits"],
                                   kw["stochastic"], ref._seed_value(seed),
                                   kw.get("w_base"))
            return q * d

        def b1(x, w, seed=None, **kw):
            y = fwd(x, w, seed, **kw)
            self._add("fwd.x", seed, x,
                      lambda: rows(x, seed, kw["bk"], kw, "x", 0),
                      kw.get("x_base"))
            if kw.get("quantize_w", True):
                self._add("fwd.w", seed, w, lambda: wq(w, seed, kw),
                          kw.get("w_base"))
            return y

        def b2(g, w, seed=None, **kw):
            dx = dgrad(g, w, seed, **kw)
            self._add("dgrad.g", seed, g,
                      lambda: rows(g, seed, kw["bn"], kw, "g", 0x20000000),
                      kw.get("g_base"))
            if kw.get("quantize_w", True):
                self._add("dgrad.w", seed, w, lambda: wq(w, seed, kw),
                          kw.get("w_base"))
            return dx

        def b3(x, g, seed=None, **kw):
            want = kw.pop("operands", False)
            dw, xh, gh = wgrad(x, g, seed, operands=True, **kw)
            self._add("wgrad.x", seed, x, lambda: xh, kw.get("x_base"))
            self._add("wgrad.g", seed, g, lambda: gh, kw.get("g_base"))
            return (dw, xh, gh) if want else dw

        linear.hbfp_matmul_fwd, linear.hbfp_dgrad, linear.hbfp_wgrad = \
            b1, b2, b3
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import linear
        for n, fn in self._saved.items():
            setattr(linear, n, fn)
        return False


def _sr_narrow_prints(narrow) -> dict:
    """{leaf name: print} of a narrow copy, a stacked leaf's layers
    stacked [L, ...] (as `train_step._narrow_copy` lays out the copy)."""
    import torch
    flat = {f"layers/{k}": torch.stack([lp[k].detach() for lp in
                                        narrow["layers"]])
            for k in narrow["layers"][0]}
    flat.update((k, v.detach()) for k, v in narrow.items() if k != "layers")
    return {k: _fingerprint(v) for k, v in flat.items()}


def _sr_rank_run(mesh, arch, data, sched, out, tag, rank, sp=False,
                 tap=None) -> dict:
    """One rank's stochastic run (the module docstring's 11g): step 1's
    narrow copy printed on the shards' narrowing, a warm-up step whose
    B1-B3 operands are printed (`_SROperands`), the counted steps through
    the Trainer (launches a rank by route, losses, step times, peak, the
    collectives by axis), the master gathered to rank 0's host. Writes
    the records to out/<tag>_rank<RANK>.json for the one-process check
    (`_sr_one_process`, rank 0, after every rank has freed the card)."""
    import torch
    from repro_torch.kernels import bfp_quantize as bq
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.train import Trainer, init_train_state, make_step
    t0 = time.perf_counter()
    step = make_step(arch, SR_SPEC, sched, mesh=mesh, seq_parallel=sp,
                     tap=tap)
    lay = step.layout
    init = init_train_state(0, arch, mesh=lay)
    sink, lines = MemorySink(), []
    trainer = Trainer(train_step=step, data_fn=data, seed=SR_SEED,
                      init_state=init, recorder=Recorder([sink]))
    prints = {}

    def narrow_copy(*a, **kw):                # step 1's narrow copy
        out = type(lay).narrow_copy(lay, *a, **kw)
        prints.update(_sr_narrow_prints(out))
        return out

    lay.narrow_copy = narrow_copy
    with _SROperands() as rec:
        trainer.run(1, log_every=1, log_fn=lines.append)     # step 1
    del lay.narrow_copy
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    hm.reset_counts()
    bq.reset_counts()
    axes = {"data": lay.transport, "model": lay.model}
    axes = {k: t for k, t in axes.items() if t is not None}
    marks = {k: (len(t.records), dict(t.staged)) for k, t in axes.items()}
    trainer.run(SR_MESH_STEPS, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    counted = SR_MESH_STEPS - 1
    per = lambda d: {k: v / counted for k, v in d.items()}
    coll = {k: dict(bytes=per(t.bytes_by_kind(marks[k][0])),
                    seconds=per(t.seconds_by_kind(marks[k][0])),
                    staged=per({s: v - marks[k][1].get(s, 0)
                                for s, v in t.staged.items()}))
            for k, t in axes.items()}
    spans = [ev.data["dur_us"] / 1e6 for ev in sink.events
             if ev.kind == "span" and ev.data.get("name") == "train/step"]
    res = dict(tag=tag, rank=rank, rank_m=lay.rank_m, rank_d=lay.rank,
               m=lay.m, n=lay.n, axis=lay.axis,
               losses=[float(ln.split("loss=")[1].split()[0])
                       for ln in lines],
               step_s=spans[1:],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={k: getattr(hm, k).launches for k in GEMM_KERNELS},
               routes={k: dict(getattr(hm, k).launches_by_route)
                       for k in GEMM_KERNELS},
               plain_calls=sum(getattr(hm, k).plain_calls
                               for k in GEMM_KERNELS)
               + bq.bfp_quantize.plain_calls,
               b7_launches=bq.bfp_quantize.launches,
               b7_routes=dict(bq.bfp_quantize.launches_by_route),
               collectives=coll, records=rec.records, narrow=prints,
               tp_dims={n: d for n, d in lay.tp_dims.items()},
               seconds=dict(warm_up=t_warm))
    t1 = time.perf_counter()
    master = lay.gather(trainer.state.params)
    res["seconds"]["gather"] = time.perf_counter() - t1
    with open(os.path.join(out, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    del trainer, step, lay, init
    torch.cuda.empty_cache()
    return res, master


def _sr_one_process(arch, data, sched, out, tag, n_ranks, master,
                    tap=None) -> dict:
    """Rank 0, the card to itself: one process on the full batch from the
    same init and keys: its narrow copy sliced at each rank's model part
    against the ranks' prints, its step-1 operands sliced at each rank's
    bases against theirs (`_SROperands`), its losses, and its updates
    against the mesh's gathered master (p_end - p0, relative Frobenius
    per leaf)."""
    import torch
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    from repro_torch.train import train_step as train_step_mod
    t0 = time.perf_counter()
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(out, f"{tag}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(0, arch)
    narrow_bad, narrow_checked = [], []

    def narrow_copy(*a, **kw):                # step 1's narrow copy
        whole = plain_narrow(*a, **kw)
        flat = {f"layers/{k}": torch.stack([lp[k].detach() for lp in
                                            whole["layers"]])
                for k in whole["layers"][0]}
        flat.update((k, v.detach()) for k, v in whole.items()
                    if k != "layers")
        for res in ranks:
            for name, t in flat.items():
                d = res["tp_dims"][name]
                if d is not None:
                    k = t.shape[d] // res["m"]
                    t = t.narrow(d, res["rank_m"] * k, k)
                if _fingerprint(t)[:2] != res["narrow"][name][:2]:
                    narrow_bad.append([res["rank"], name])
        narrow_checked.append(len(flat))
        return whole

    p0 = {n: t.to("cpu", copy=True) for n, t in named_leaves(state.params)}
    trainer = Trainer(train_step=make_step(arch, SR_SPEC, sched, tap=tap),
                      init_state=state, data_fn=data, seed=SR_SEED)
    lines = []
    plain_narrow = train_step_mod._narrow_copy
    train_step_mod._narrow_copy = narrow_copy
    try:
        with _SROperands([r["records"] for r in ranks]) as rec:
            trainer.run(1, log_every=1, log_fn=lines.append)
    finally:
        train_step_mod._narrow_copy = plain_narrow
    trainer.run(SR_MESH_STEPS, log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    upd = {}
    mm = dict(named_leaves(master))
    for name, b in named_leaves(trainer.state.params):
        a = torch.from_numpy(mm[name]).cuda()
        dd = torch.linalg.vector_norm((b - p0[name].cuda()).double())
        upd[name] = float(torch.linalg.vector_norm((a - b).double())
                          / dd.clamp_min(1e-30))
        del a
    unmatched = {}
    for recs in rec.by_key.values():
        for r, x in recs:
            if not x.get("hit"):
                unmatched[x["key"][0]] = unmatched.get(x["key"][0], 0) + 1
    out_ = dict(losses=[float(ln.split("loss=")[1].split()[0])
                        for ln in lines],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                update_rel=upd, narrow_bad=narrow_bad,
                narrow_checked=narrow_checked,
                operands=dict(rec.result, unmatched=unmatched,
                              recorded=sum(len(r["records"])
                                           for r in ranks)),
                seconds=time.perf_counter() - t0)
    del trainer, state, p0
    torch.cuda.empty_cache()
    return out_


def _sr_check(tag: str, card: str, ranks: list, one: dict, want: dict,
              depth: str, loss_steps: int = SR_MESH_STEPS) -> dict:
    """The phase's checks of a stochastic mesh run (the module docstring's
    11g): step 1's narrow copy and every B1-B3 operand of one process's
    that a rank's input matches bit-identical to one process's part (the
    weights always match); B1-B3 launches a rank equal one process's at a
    rank's tokens, on their training routes, no plain call; the ranks'
    losses alike; losses within DIST_TOL["loss"] and updates within
    DIST_TOL["updates"] of one process."""
    ops = one["operands"]
    for res in ranks:
        c = res["collectives"]
        log(f"[sr {tag} rank {res['rank']}] {depth}: losses "
            f"{res['losses']}, step times "
            f"{[round(t, 3) for t in res['step_s']]} s, peak "
            f"{res['peak_gib']:.2f} GiB; B1-B3 {res['launches']} (expected "
            f"{want}) by route {res['routes']}; B7 {res['b7_launches']} "
            f"{res['b7_routes']}; a step's collectives {c} | {card}")
        if res["launches"] != want or res["plain_calls"]:
            fail(f"sr {tag} rank {res['rank']}: launches {res['launches']} "
                 f"!= {want} or plain calls {res['plain_calls']}")
        if not _all_on({k: res["routes"][k] for k in ROUTED_KERNELS},
                       "int8_wgmma") or not _all_on(
                {"hbfp_wgrad": res["routes"]["hbfp_wgrad"]}, "bf16_wgmma"):
            fail(f"sr {tag} rank {res['rank']}: a launch off its training "
                 f"route: {res['routes']}")
        if res["losses"] != ranks[0]["losses"] or \
                not all(abs(x) < float("inf") for x in res["losses"]):
            fail(f"sr {tag}: the ranks' losses part: {res['losses']} vs "
                 f"{ranks[0]['losses']}")
    losses = ranks[0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       one["losses"]))
    upd = one["update_rel"]
    worst = max(upd, key=upd.get)
    log(f"[sr {tag}] against one process on the full batch (peak "
        f"{one['peak_gib']:.2f} GiB, {one['seconds']:.1f} s): losses "
        f"{losses} vs {one['losses']} (worst rel {loss_rel:.3g}, tol "
        f"{DIST_TOL['loss']}); updates within rel {upd[worst]:.3g} "
        f"({worst}; tol {DIST_TOL['updates']}); step 1's narrow copy "
        f"{'bit-identical' if not one['narrow_bad'] else one['narrow_bad']}"
        f"; operands {ops['recorded']} recorded, {ops['checked']} matched "
        f"one process's input ({ops['matched']}), {len(ops['bad'])} "
        f"quantized differently, unmatched {ops['unmatched']} | {card}")
    if one["narrow_bad"] or ops["bad"] or len(one["narrow_checked"]) != 1:
        fail(f"sr {tag}: a rank's step-1 narrow copy or quantized operand "
             f"is not one process's part: {one['narrow_bad']} {ops['bad']}")
    if any(ops["unmatched"].get(k) for k in ("fwd.w", "dgrad.w")) or \
            not ops["checked"]:
        fail(f"sr {tag}: a weight operand matched no one-process part: "
             f"{ops}")
    if loss_rel > DIST_TOL["loss"] or upd[worst] > DIST_TOL["updates"]:
        fail(f"sr {tag}: the ranks part from one process: losses {losses} "
             f"vs {one['losses']}, worst update {worst} {upd[worst]}")
    return dict(loss_rel=loss_rel, update_rel=upd[worst], worst=worst,
                operands=ops)


def _sr_rank_pair(mesh, arch, data, sched, out, tag, rank, n, barrier,
                  sp=False, tap=None):
    """`_sr_rank_run` on every rank, then `_sr_one_process` on rank 0 while
    the others wait with the card freed: (this rank's result without its
    records and prints, the one-process result on rank 0 or None)."""
    import torch
    res, master = _sr_rank_run(mesh, arch, data, sched, out, tag, rank,
                               sp=sp, tap=tap)
    barrier()
    one = None
    if rank == 0:
        one = _sr_one_process(arch, data, sched, out, tag, n, master, tap)
    del master
    torch.cuda.empty_cache()
    barrier()
    return {k: v for k, v in res.items()
            if k not in ("records", "narrow", "tp_dims")}, one


def pod_rank(rank: int, n: int, port: int, out: str) -> int:
    """`--pod-rank RANK N DIR`: one rank of the pod phase on
    {pod 2, data 1, model 2} (the module docstring's 11g); writes
    DIR/pod<RANK>.json."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.transport import init_process_group
    from repro_torch.numerics import TapConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = init_process_group(rank, n, port)
    mesh = init_device_mesh("cuda", (2, 1, 2),
                            mesh_dim_names=("pod", "data", "model"))
    arch, depth, data, sched = _tp_setup("gemma2-2b", SR_POD_LAYERS, 2,
                                         2048)
    res, one = _sr_rank_pair(mesh, arch, data, sched, out, "sr_pod", rank,
                             n, dist.barrier,
                             tap=TapConfig(cadence=SR_POD_CADENCE))
    with open(os.path.join(out, f"pod{rank}.json"), "w") as f:
        json.dump(dict(res, backend=backend, depth=depth, one=one), f)
    dist.destroy_process_group()
    return 0


def _ranks_dir(name: str) -> str:
    return os.path.join(ROOT, "build", name)


def _spawn_ranks(flag: str, n: int, out: str) -> list:
    """Start `n` rank processes of this script (`flag` RANK N OUT), two or
    more gloo ranks sharing the card (expandable segments keep each rank's
    freed blocks usable by the next run's other sizes). Each takes the
    card, loads the kernels' libraries and waits in `_await_go` until
    `_run_ranks` lets the world go, so a world started during the phase
    before its own starts up meanwhile. Returns the processes."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(n),
         out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(n)]


def _await_go(out: str) -> int:
    """A rank process's start-up (`_spawn_ranks`): the card, the modules
    the ranks run and the kernels' libraries, then a wait for OUT/go,
    which holds the port of the world's store; returns it. Exits when the
    script that started it is gone."""
    import torch
    import repro_torch.train  # noqa: F401
    from repro_torch.kernels import hbfp_matmul as hm
    torch.zeros(1, device="cuda")
    for name in hm.SOURCES:
        hm.load(name)
    parent = os.getppid()
    go = os.path.join(out, "go")
    while not os.path.exists(go):
        if os.getppid() != parent:
            raise SystemExit("chip_smoke rank: the script that started it "
                             "is gone")
        time.sleep(0.05)
    with open(go) as f:
        return int(f.read())


def _run_ranks(flag: str, n: int, out: str, timeout: int = 600,
               procs=None) -> float:
    """Let a world of `n` rank processes go (`procs`, `_spawn_ranks`'s;
    started now when None) on a free port, and wait for them; returns
    their wall seconds from the go. A rank that fails or outlives
    `timeout` fails the phase (the others are stopped)."""
    import torch
    if procs is None:
        procs = _spawn_ranks(flag, n, out)
    gc.collect()
    torch.cuda.empty_cache()
    go = os.path.join(out, "go")
    with open(go + ".tmp", "w") as f:
        f.write(str(_free_port()))
    os.replace(go + ".tmp", go)
    t0 = time.perf_counter()
    texts = []
    for p in procs:
        try:
            texts.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"{flag}: a rank did not finish in {timeout} s")
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"{flag}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
    return time.perf_counter() - t0


def phase_pod(card: str, world=None) -> dict:
    """ROADMAP slice 19's pod mesh on the card (the module docstring's
    11g): four gloo ranks of the card on {pod 2, data 1, model 2},
    gemma2-2b at full width and SR_POD_LAYERS of 26 layers, 1 x 2048
    tokens a data rank, under SR_SPEC with a telemetry step every
    SR_POD_CADENCE (B7 narrowing each shard), held to one process;
    `world`: its ranks, `_spawn_ranks`'s, or None."""
    out = _ranks_dir("pod_ranks")
    secs = _run_ranks("--pod-rank", SR_POD_RANKS, out, procs=world)
    ranks = []
    for r in range(SR_POD_RANKS):
        with open(os.path.join(out, f"pod{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    arch = _tp_setup("gemma2-2b", SR_POD_LAYERS, 2, 2048)[0]
    want = {k: v for k, v in _train_launches(arch, 2048).items()
            if k in GEMM_KERNELS}
    for res in ranks:
        if res["backend"] != "gloo" or tuple(res["axis"]) != ("pod", "data") \
                or res["n"] != 2 or res["m"] != 2:
            fail(f"pod: rank {res['rank']} on {res['backend']}, data axes "
                 f"{res['axis']} of {res['n']}, model {res['m']}")
        if not res["b7_launches"] or set(
                r for r, k in res["b7_routes"].items() if k) - set(
                B7_MAIN_ROUTES):
            fail(f"pod: B7 on the shards {res['b7_launches']} "
                 f"{res['b7_routes']}")
    check = _sr_check("pod", card, ranks, ranks[0]["one"], want,
                      ranks[0]["depth"])
    log(f"[pod] the ranks {secs:.1f} s | {card}")
    return dict(ranks=ranks, ranks_s=secs, check=check)


# -- sharded serving (ROADMAP slice 20) ---------------------------------------

def _shard_policy():
    from repro_torch.precision import as_policy
    return as_policy(SHARD_SPEC)


class _FlashRec:
    """While open, records layer 0's flash call of each prefill (q, k, v
    and the output, on the host): `models.attention.flash_mha` wrapped."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod, self.orig, self.calls = attention, attention.flash_mha, []

    def __enter__(self):
        def rec(q, k, v, ctx):
            out = self.orig(q, k, v, ctx)
            if not self.calls:
                self.calls.append([t.detach().cpu() for t in (q, k, v, out)])
            return out
        self.mod.flash_mha = rec
        return self

    def __exit__(self, *exc):
        self.mod.flash_mha = self.orig


def _shard_inputs(cfg, vocab, dev):
    """The seeded prompts [B, S] (int32) of a shard run."""
    import torch
    g = torch.Generator(device=dev).manual_seed(2026)
    return torch.randint(0, vocab, (cfg["B"], cfg["S"]), generator=g,
                         device=dev, dtype=torch.int32)


def _shard_run(arch, params, cfg, prompts, dev, layout=None, feed=None):
    """Prefill the prompts and take cfg["ticks"] greedy decode ticks, in one
    process (`layout` None: its own greedy tokens feed the ticks) or as
    this rank's part (`ServeLayout`, its batch rows and shards, the ticks
    fed `feed`, [ticks, B, 1], one process's greedy tokens). Returns
    (logits on the host, one [B_local, 1, V] a stage, the greedy tokens
    [ticks, B_local, 1], the rows of the global batch, the cache, layer
    0's flash record, seconds)."""
    import torch
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.train import serve_step as tss
    B, S, C, T = cfg["B"], cfg["S"], cfg["ctx"], cfg["ticks"]
    batch = {"tokens": prompts}
    if layout is None:
        pctx = dctx = tss._serve_ctx(arch, _shard_policy(), dev)()
        local = lambda b: b
        rows = slice(0, B)
    else:
        pctx = layout.ctx(B, prefill=True)
        dctx = layout.ctx(B, C)
        local = layout.local_batch
        k = B // layout.n if layout.data_part(B) is not None else B
        r0 = layout.rank * k if layout.data_part(B) is not None else 0
        rows = slice(r0, r0 + k)
    logits, greedy = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), _FlashRec() as rec:
        # no positions: the standard layout, so the prefill takes flash
        lg, cache = prefill(params, local(batch), arch, pctx)
    with torch.no_grad():
        cache = tss.prefill_to_decode_cache(cache, arch, C) \
            if layout is None else layout.decode_cache(cache, B, C)
        for t in range(T + 1):
            logits.append(lg.float().cpu())
            if t == T:
                break
            mine = lg.float().argmax(-1).to(torch.int32)      # [b, 1]
            greedy.append(mine)
            tb = {"tokens": mine if feed is None else feed[t],
                  "positions": torch.full((B, 1), S + t, dtype=torch.int32,
                                          device=dev)}
            lg, cache = decode_step(params, local(tb), cache, arch, dctx)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    own = torch.stack(greedy).cpu() if greedy else None
    return logits, own, rows, cache, rec.calls[0] if rec.calls else None, \
        secs


def _margin_ok(one_logits, got_logits, tol):
    """(max |got - one| / max |one| over the stages, the greedy tokens
    equal wherever one process's top-2 margin exceeds tol · max|one|,
    the count of positions so checked)."""
    import torch
    worst, ok, checked = 0.0, True, 0
    for a, b in zip(one_logits, got_logits):
        scale = float(a.abs().max())
        worst = max(worst, float((a - b).abs().max()) / scale)
        top = a.topk(2, dim=-1).values
        sure = (top[..., 0] - top[..., 1]) > tol * scale
        same = a.argmax(-1) == b.argmax(-1)
        ok &= bool(same[sure].all())
        checked += int(sure.sum())
    return worst, ok, checked


def _shard_rank_run(rank, n, out, dev="cuda", arch=None, cfg=None):
    """One rank of the shard phase's (a) (n 4) or (b) (n 8): the body of
    `--shard-rank`, on the default process group already started."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.transformer import init_params
    from repro_torch.train.serve_step import (ServeLayout,
                                              narrow_serving_params)
    cfg = cfg or (SHARD_A if n == 4 else SHARD_B)
    mesh = init_device_mesh(dev, (cfg["data"], cfg["model"]),
                            mesh_dim_names=("data", "model"))
    depth = None
    if arch is None:
        arch, depth = _at_depth(SHARD_ARCH, cfg["layers"])
    B, T = cfg["B"], cfg["ticks"]
    prompts = _shard_inputs(cfg, arch.vocab_size, dev)
    res = dict(rank=rank, n=n, depth=depth, backend=str(dist.get_backend()))

    def whole():
        return narrow_serving_params(init_params(0, arch, device=dev), arch,
                                     _shard_policy())

    # one process: every rank at once in (a); rank 0 alone in (b), the
    # others waiting with nothing on the card (its ring is 17 GB)
    one = None
    feed = torch.zeros((T, B, 1), dtype=torch.int32, device=dev)
    if n == 4 or rank == 0:
        torch.cuda.reset_peak_memory_stats()
        params = whole()
        lg, own, _, cache, flash, secs = _shard_run(arch, params, cfg,
                                                    prompts, dev)
        one = dict(logits=lg, flash=flash, seconds=secs,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        feed.copy_(own.to(dev))
        if n == 8:
            kv = cache["kv"]
            c = kv.k.shape[3] // n
            one["prints"] = {f"kv/{f}": [
                _fingerprint(getattr(kv, f).narrow(3, r * c, c))
                for r in range(n)] for f in ("k", "v")}
            one["prints"]["kv/slot_pos"] = _fingerprint(kv.slot_pos)
            del kv
        del params, cache
        torch.cuda.empty_cache()
    dist.barrier()
    dist.broadcast(feed, src=0)     # (b): one process's tokens to all
    lay = ServeLayout(arch, mesh, _shard_policy(), dev)
    params = lay.shard_params(whole())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    lg, _, rows, cache, flash, secs = _shard_run(arch, params, cfg, prompts,
                                                 dev, lay, feed)
    counts, plain = _counts()
    res.update(seconds=secs, launches=counts, plain_calls=plain,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               kv=lay.cache_layout(B, cfg["ctx"]).kv,
               replicated=sorted(lay.replicated),
               collectives=lay.model.bytes_by_kind() if lay.model else {},
               collective_s=lay.model.seconds_by_kind() if lay.model
               else {})
    if one is not None:
        one_rows = [t[rows] for t in one["logits"]]
        worst, ok, checked = _margin_ok(one_rows, lg, SHARD_TOL)
        res.update(logits_rel=worst, greedy_equal=ok, greedy_checked=checked,
                   one_seconds=one["seconds"], one_peak_gib=one["peak_gib"])
    if n == 4:
        # layer 0's flash inputs and output: this rank's rows and heads
        # (all heads where the layout keeps attention replicated)
        hq, hk = flash[0].shape[1], flash[1].shape[1]
        rm = lay.rank_m if hq < one["flash"][0].shape[1] else 0
        cut = lambda t, h: t[rows, rm * h:(rm + 1) * h]
        res["flash_equal"] = {
            name: bool(torch.equal(flash[i], cut(one["flash"][i],
                                                 hq if i in (0, 3) else hk)))
            for i, name in enumerate(("q", "k", "v", "out"))}
        res["flash_heads"] = [hq, hk]
    else:
        kv = cache["kv"]
        res["prints"] = {"kv/k": _fingerprint(kv.k), "kv/v": _fingerprint(kv.v),
                         "kv/slot_pos": _fingerprint(kv.slot_pos)}
        res["logits_print"] = _fingerprint(torch.cat(lg))
        res["real_bytes"] = tree_bytes(params) + tree_bytes(cache) + \
            tree_bytes(lay.local_batch({
                "tokens": feed[0],
                "positions": torch.zeros((B, 1), dtype=torch.int32,
                                         device=dev)}))
        if one is not None:
            res["one_prints"] = one["prints"]
    del params, cache
    with open(os.path.join(out, f"shard{rank}.json"), "w") as f:
        json.dump(res, f)
    return res


def shard_rank(rank: int, n: int, port: int, out: str) -> int:
    """`--shard-rank RANK N DIR`: one rank of the shard phase's (a)
    (N = 4) or (b) (N = 8); writes DIR/shard<RANK>.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.transport import init_process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group(rank, n, port)
    _shard_rank_run(rank, n, out)
    dist.destroy_process_group()
    return 0


def shard_dry(out: str) -> int:
    """`--shard-dry OUT`: the shard phase's (c), the dry run's SHARD_DRY
    cells of yi-9b at the production mesh (single pod), both tracks, on
    fake tensors on the card's device type; writes OUT."""
    from repro_torch.launch import dryrun
    recs = {}
    for shape in SHARD_DRY:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(SHARD_ARCH, shape, False, device="cuda")
        rec["wall_s"] = round(time.perf_counter() - t0, 1)
        recs[f"{SHARD_ARCH}|{shape}|single"] = rec
        with open(out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


def _shard_dry_start():
    """Start (c) in a process of this script beside the other phases, at
    the lowest CPU priority (one busy core of fake-tensor dispatch for
    ~3-4 min, which would otherwise slow the launch-bound phases it
    overlaps): (the process, its output file; its log beside it)."""
    path = os.path.join(ROOT, "build", "shard_dry.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    with open(path + ".log", "w") as logf:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--shard-dry", path], stdout=logf,
                                stderr=subprocess.STDOUT,
                                preexec_fn=lambda: os.nice(19))
    return proc, path


def _shard_cross_check(card: str, rank0: dict, dev: str = "cuda") -> dict:
    """(b)'s dry-run cross-check: `launch.dryrun.build_cell` of the
    decode_32k cell at SHARD_B's depth on a fake group of its ranks and
    mesh; its argument bytes must equal rank 0's real ones."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.formats import HBFP8_16
    from repro_torch.launch import dryrun
    from repro_torch.launch.transport import init_fake_process_group
    arch = _at_depth(SHARD_ARCH, SHARD_B["layers"])[0]
    init_fake_process_group(SHARD_B["data"] * SHARD_B["model"])
    try:
        mesh = init_device_mesh("cpu", (SHARD_B["data"], SHARD_B["model"]),
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True):
            cell = dryrun.build_cell(arch, "decode_32k", mesh,
                                     _shard_policy(), device=dev)
            args = dryrun.tree_bytes(cell.arguments)
        # its memory track as the dry run runs it (HBFP8_16, the sim path)
        mem = dryrun._run_memory(arch, "decode_32k", mesh, HBFP8_16, None,
                                 torch.device(dev))
        secs = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    log(f"[shard] (b) dry run at {SHARD_B['layers']} layers on {{data "
        f"{SHARD_B['data']}, model {SHARD_B['model']}}}: argument bytes "
        f"{args} vs rank 0's real {rank0['real_bytes']}; its total "
        f"{mem['per_device_total_gib']} GiB (args "
        f"{mem['argument_bytes'] / 2**30:.3f}, outputs "
        f"{mem['output_bytes'] / 2**30:.3f}, temps "
        f"{mem['temp_bytes'] / 2**30:.3f}) beside rank 0's real peak "
        f"{rank0['peak_gib']:.3f} GiB; {secs:.1f} s | {card}")
    if args != rank0["real_bytes"]:
        fail(f"shard (b): the dry run's argument bytes {args} != rank 0's "
             f"{rank0['real_bytes']}")
    return dict(argument_bytes=args, memory=mem, seconds=secs)


def _shard_check(tag: str, card: str, ranks: list, want: dict) -> None:
    """The checks every shard run shares: routes, counts, logits, greedy
    tokens (on the ranks that hold one process's logits)."""
    for res in ranks:
        r = res["rank"]
        log(f"[shard {tag} rank {r}] {res['backend']}, {res['depth']}: "
            f"{res['seconds']:.2f} s, peak {res['peak_gib']:.2f} GiB, cache "
            f"split {res['kv']}; launches {res['launches']}; collectives "
            f"on model {res['collectives']} bytes, "
            f"{ {k: round(v, 2) for k, v in res['collective_s'].items()} } "
            f"s | {card}")
        if res["backend"] != "gloo":
            fail(f"shard {tag}: ranks sharing one card took {res['backend']}")
        got = {k: res["launches"].get(k, 0) for k in want}
        if got != want or res["plain_calls"]:
            fail(f"shard {tag} rank {r}: launches {got} != {want} or plain "
                 f"calls {res['plain_calls']}")
        routes = {k: {x.split("/")[1]: v for x, v in res["launches"].items()
                      if x.startswith(k + "/")}
                  for k in ("hbfp_matmul_fwd", "hbfp_flash_fwd")}
        b4 = next(k.split("/")[1] for k in want
                  if k.startswith("hbfp_flash_fwd/"))
        if not _all_on({"b1": routes["hbfp_matmul_fwd"]}, "bf16_wgmma") or \
                not _all_on({"b4": routes["hbfp_flash_fwd"]}, b4):
            fail(f"shard {tag} rank {r}: a launch off its route "
                 f"{res['launches']}")
        if "logits_rel" in res:
            log(f"[shard {tag} rank {r}] against one process "
                f"({res['one_seconds']:.2f} s, peak "
                f"{res['one_peak_gib']:.2f} GiB): logits within rel "
                f"{res['logits_rel']:.3g} (tol {SHARD_TOL}), greedy tokens "
                f"equal {res['greedy_equal']} at {res['greedy_checked']} "
                f"sure positions | {card}")
            if res["logits_rel"] > SHARD_TOL or not res["greedy_equal"]:
                fail(f"shard {tag} rank {r}: logits {res['logits_rel']} or "
                     f"greedy tokens {res['greedy_equal']}")


def _shard_want(cfg) -> dict:
    """B1 and B4 launches a rank of a shard run: 7L + 1 a prefill and a
    tick, L flash calls a prefill (one a layer, on the rank's heads), B4
    on the route its prompt length gives (`flash_route`: S % 128 == 0
    for int8 wgmma, so (b)'s 64-token prompts take the CUDA cores)."""
    from repro_torch.kernels.hbfp_flash_attn import flash_route
    L, S = cfg["layers"], cfg["S"]
    blk = min(128, S)
    b1 = (7 * L + 1) * (1 + cfg["ticks"])
    b4 = flash_route(m_qk=8, m_pv=8, S=S, hd=128, bq=blk, bk=blk)
    return {"hbfp_matmul_fwd": b1, "hbfp_matmul_fwd/bf16_wgmma": b1,
            "hbfp_flash_fwd": L, f"hbfp_flash_fwd/{b4}": L}


def phase_shard(card: str, dry=None, world=None) -> dict:
    """ROADMAP slice 20 on the card (the module docstring's 11h); `dry`
    (`_shard_dry_start`'s) is stopped if a check fails; `world`: (a)'s
    ranks, `_spawn_ranks`'s, or None."""
    if dry is None:
        dry = _shard_dry_start()
    try:
        return _phase_shard(card, dry, world)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()


def _phase_shard(card: str, dry, world) -> dict:
    t0 = time.perf_counter()
    runs = {}
    worlds = {"a": world}
    for tag, n, cfg in (("a", 4, SHARD_A), ("b", 8, SHARD_B)):
        out = _ranks_dir(f"shard_{tag}")
        if worlds[tag] is None:
            worlds[tag] = _spawn_ranks("--shard-rank", n, out)
        if tag == "a":     # (b)'s ranks start up during (a)
            worlds["b"] = _spawn_ranks("--shard-rank", 8,
                                       _ranks_dir("shard_b"))
        secs = _run_ranks("--shard-rank", n, out, procs=worlds[tag])
        ranks = []
        for r in range(n):
            with open(os.path.join(out, f"shard{r}.json")) as f:
                ranks.append(json.load(f))
        shutil.rmtree(out, ignore_errors=True)
        _shard_check(tag, card, ranks, _shard_want(cfg))
        runs[tag] = dict(ranks=ranks, seconds=secs)
        log(f"[shard] ({tag}) {n} ranks in {secs:.1f} s | {card}")
    for res in runs["a"]["ranks"]:
        log(f"[shard a rank {res['rank']}] layer 0's q, k, v and flash "
            f"output on {res['flash_heads']} query / kv heads bit-equal to "
            f"one process's: {res['flash_equal']}")
        if not all(res["flash_equal"].values()):
            fail(f"shard (a) rank {res['rank']}: {res['flash_equal']}")
    b = runs["b"]["ranks"]
    one = b[0]["one_prints"]
    for res in b:
        r = res["rank"]
        want = {"kv/k": one["kv/k"][r], "kv/v": one["kv/v"][r],
                "kv/slot_pos": one["kv/slot_pos"]}
        if res["prints"] != want or res["kv"] != "seq":
            fail(f"shard (b) rank {r}: cache part {res['prints']} != one "
                 f"process's slice {want} (split {res['kv']})")
        if res["logits_print"] != b[0]["logits_print"]:
            fail(f"shard (b) rank {r}: logits differ from rank 0's")
    log(f"[shard] (b) every rank's cache part (k, v: 4,096 of 32,768 slots) "
        f"and the whole slot_pos bit-equal to one process's slice; the "
        f"ranks' logits alike | {card}")
    cross = _shard_cross_check(card, b[0])
    proc, path = dry
    proc.wait(timeout=900)
    if proc.returncode != 0:
        with open(path + ".log") as f:
            fail(f"shard (c): the dry run exited {proc.returncode}:\n"
                 f"{f.read()[-3000:]}")
    with open(path) as f:
        cells = json.load(f)
    for cell, rec in cells.items():
        m = rec.get("memory", {})
        r = rec.get("roofline", {})
        log(f"[shard] (c) {cell}: {rec['status']}, trace_s {rec.get('trace_s')}"
            f", wall {rec['wall_s']} s; per device args "
            f"{m.get('argument_bytes', 0) / 2**30:.2f} GiB, total "
            f"{m.get('per_device_total_gib')} GiB; roofline bound "
            f"{r.get('bottleneck')} {r.get('step_time_lower_bound_s', 0):.4g}"
            f" s (fake tensors on the card's host) | {card}")
        if rec["status"] != "ok":
            fail(f"shard (c): {cell} {rec}")
    log(f"[shard] phase {time.perf_counter() - t0:.1f} s | {card}")
    return dict(runs=runs, cross=cross, dry=cells)


def phase_sr_kernels(card: str) -> dict:
    """`--phase sr_kernels`: ROADMAP slice 19's kernel cases alone (the
    bwd phase's and the quantize phase's index-base cases)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4321)
    gemm = _sr_base_cases(gen)
    b7 = _sr_b7_cases(torch.Generator(device="cuda").manual_seed(97))
    log(f"[sr base] {len(gemm)} B1-B3 rows and {len(b7)} B7 rows | {card}")
    return dict(gemm=gemm, b7=b7)


def _tp_runs(tp: dict) -> list:
    """Every rank's mesh run of the tp phase."""
    return [m for rank in tp["ranks"] for run in rank["runs"].values()
            for m in run["mesh"]]


def _tp_paths(tp: dict, kernel: str) -> dict:
    """A B1-B3 kernel's launches on the tp phase's paths, both ranks."""
    out = {}
    for rank in tp["ranks"]:
        for name, run in rank["runs"].items():
            for m in run["mesh"]:
                key = f"tp_{name.split('-')[0]}" + ("_sp" if m["sp"] else "")
                out[key] = out.get(key, 0) + m["launches"][kernel]
    return out


def _route_sum(rows, kernel: str) -> dict:
    """A kernel's launches by route summed over the recorded steps."""
    return {rt: sum(r["launches"].get(f"{kernel}/{rt}", 0) for r in rows)
            for rt in ("int8_wgmma", "bf16_wgmma", "cuda_core")}


def _sum_counts(rows) -> dict:
    out = {}
    for r in rows:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _bound_by(rows) -> str:
    """What bounds a sum of per-shape bounds: the side with the larger
    share of it."""
    ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return "operations" if 2 * ops > sum(r["bound_ms"] for r in rows) \
        else "bytes"


def _bwd_entry(name, rows, by_path, replaces, source, by_route=None):
    """One kernel's JSON entry from the bwd phase: times summed over one
    gemma2-2b layer's seven projections and the head at M = 4096; B1/B2
    also carry their main-path launches by route and torch._int_mm on the
    same int8 mantissas (a yardstick, never called by the port)."""
    tr = [r for r in rows if r["kernel"] == name and r["config"] == "train"]
    extra = {} if by_route is None else {"launches_by_route": by_route}
    if any("int_mm_ms" in r for r in tr):
        extra["int_mm_ms"] = sum(r.get("int_mm_ms", 0.0) for r in tr)
    split = {r["weight"]: r["kernel_split_ms"] for r in tr
             if "kernel_split_ms" in r}
    if split:
        extra["kernel_split_ms"] = split
    st = [r for r in rows if r["kernel"] == name
          and r["config"] == "sr_base_timed"]
    if st:
        # stochastic, the seven projections of a layer: without and with
        # a data shard's index base (ROADMAP slice 19)
        extra["stochastic_ms"] = sum(r["kernel_ms"] for r in st)
        extra["stochastic_base_ms"] = sum(r["kernel_base_ms"] for r in st)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "held_against": name + "_plain",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["kernel"] == name and "max_abs_err" in r),
        "ms": sum(r["kernel_ms"] for r in tr),
        "plain_ms": sum(r["plain_ms"] for r in tr),
        "bound_ms": sum(r["bound_ms"] for r in tr),
        "bound_by": _bound_by(tr),
        "library_ms": None,
        "matmul_bf16_ms": sum(r["matmul_bf16_ms"] for r in tr),
        **extra,
    }


def _flash_entry(name, rows, by_path, replaces, source, by_route):
    """One flash kernel's JSON entry: times at the yi-9b training shape;
    max_abs_err over every flash case. No PyTorch call computes the HBFP
    attention, so library_ms is null; SDPA on the same bf16 q/k/v is a
    yardstick of another function, never called by the port. Each also
    carries its main-path launches by route, the flash phase's cases by
    the route each took, its softmax bound and its device time by kernel
    (pre-pass, main)."""
    main = next(r for r in rows
                if r["kernel"] == name and r["case"] == "yi_train")
    cases = {}
    for r in rows:
        if r["kernel"] == name:
            cases.setdefault(r["route"], []).append(r["case"])
    extra = {"launches_by_route": by_route, "cases_by_route": cases,
             "bound_softmax_ms": main["bound_softmax_ms"],
             "kernel_split_ms": main.get("kernel_split_ms")}
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "held_against": name + "_plain",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["kernel"] == name),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "sdpa_ms": main["sdpa"],
        **extra,
    }


def _quant_entry(rows, adapt, train_sr, dist, pod):
    """B7's JSON entry: times summed over yi-9b's five distinct weight
    shapes at the adaptive path's weight-tap format (m 4, tile 24, with
    stats); max_abs_err over every quantize case; launches by path on the
    adaptive run and the stochastic telemetry step of train-sr. No
    PyTorch call packs BFP, so library_ms is null; a clone() of the same
    x (one read, one write) is the yardstick. The dist phase adds its
    compressed reduces' launches (two ranks and the one-rank NCCL group)
    and its times at the gradients' (1, 512) tiling ("grad_tiling_*",
    summed over gemma2-2b's distinct gradient operands at DIST_LAYERS)."""
    main = [r for r in rows
            if r["input"] == "randn" and r["case"].endswith("_t24_m4")]
    tel_sr = train_sr["proofs"]["telemetry"]
    reduces = [r["compress"] for r in dist["ranks"]] + [dist["nccl"]]
    by_path = {"telemetry": adapt["launches_telemetry"],
               "packed_save": adapt["packed"]["launches"],
               "telemetry_stochastic": tel_sr["b7_launches"],
               "dist_compress": sum(c["b7_launches"] for c in reduces[:-1]),
               "dist_compress_nccl": reduces[-1]["b7_launches"],
               "pod_sr_telemetry": sum(r["b7_launches"]
                                       for r in pod["ranks"])}
    by_route = {r: adapt["launches"][f"bfp_quantize/{r}"]
                + adapt["packed"]["launches_by_route"][r]
                + tel_sr["b7_routes"][r]
                + sum(c["b7_routes"][r] for c in reduces)
                + sum(x["b7_routes"][r] for x in pod["ranks"])
                for r in adapt["packed"]["launches_by_route"]}
    grad = dist["b7_cases"]
    st = [r for r in rows if r.get("config") == "sr_base_timed"]
    rows = [r for r in rows if "max_abs_err" in r]
    cases = {}
    for r in rows + grad:
        cases.setdefault(r["route"], []).append(r["case"])
    return {
        "name": "bfp_quantize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bfp_quantize.cu",
        "replaces": "src/repro/kernels/bfp_quantize.py:79",
        "held_against": "bfp_quantize_plain",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows + grad),
        "ms": sum(r["kernel_ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": "bytes", "library_ms": None,
        "clone_ms": sum(r["clone_ms"] for r in main),
        "launches_by_route": by_route, "cases_by_route": cases,
        "telemetry_split": {k: adapt["telemetry_split"][k] for k in
                            ("telemetry_ms", "plain_ms", "b7_ms",
                             "other_added_ms")},
        "grad_tiling_ms": sum(r["kernel_ms"] for r in grad),
        "grad_tiling_device_ms": sum(r["device_ms"] for r in grad),
        "grad_tiling_bound_ms": sum(r["bound_ms"] for r in grad),
        "grad_tiling_plain_ms": sum(r["plain_ms"] for r in grad),
        # stochastic at the five t24 shapes, without and with an index base
        "stochastic_ms": sum(r["kernel_ms"] for r in st),
        "stochastic_base_ms": sum(r["kernel_base_ms"] for r in st),
        "stochastic_device_ms": sum(r["device_ms"] for r in st),
        "stochastic_base_device_ms": sum(r["device_base_ms"] for r in st),
    }


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--b7-times"] and len(sys.argv) == 3:
        return b7_times(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    ranks = {"--dist-rank": dist_rank, "--tp-rank": tp_rank,
             "--pod-rank": pod_rank, "--shard-rank": shard_rank}
    if sys.argv[1:2] and sys.argv[1] in ranks and len(sys.argv) == 5:
        port = _await_go(sys.argv[4])
        return ranks[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), port,
                                  sys.argv[4])
    if sys.argv[1:2] == ["--shard-dry"] and len(sys.argv) == 3:
        return shard_dry(sys.argv[2])
    t0 = time.perf_counter()
    name, card = phase_device()
    # the shard phase's dry-run cells (CPU only) run beside the others
    whole = sys.argv[1:] == []
    shard_dry_proc = _shard_dry_start() if whole else None
    # a whole run builds the flash library, the slowest, beside the bwd
    # and autotune phases, which launch none of its kernels
    build, build_rest = phase_build(("hbfp_flash_attn",) if whole else ())
    if not whole:
        build = build_rest()
    phases = {"recurrent": phase_recurrent, "moe": phase_moe,
              "vlm_audio": phase_vlm_audio, "autotune": phase_autotune,
              "dist": phase_dist, "tp": phase_tp, "pod": phase_pod,
              "shard": phase_shard, "sr_kernels": phase_sr_kernels}
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:] and \
            sys.argv[2] in phases:
        out = phases[sys.argv[2]](card)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               f"chip_smoke_{sys.argv[2]}.json"), "w") as f:
            json.dump(out, f, indent=1)
        log(f"[time] --phase {sys.argv[2]} done at "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    # the accuracy phase's CPU half runs from here on, at the lowest CPU
    # priority, beside the kernel and training phases
    acc_cpu = _acc_cpu_start()
    bwd = phase_bwd()
    log(f"[time] bwd kernels done at {time.perf_counter() - t0:.1f} s")
    at = phase_autotune(card)
    log(f"[time] autotune done at {time.perf_counter() - t0:.1f} s")
    build = build_rest()
    flash = phase_flash()
    log(f"[time] flash kernels done at {time.perf_counter() - t0:.1f} s")
    quant = phase_quantize()
    log(f"[time] quantize kernel done at {time.perf_counter() - t0:.1f} s")
    train_smoke = {a: phase_train(a) for a in ("gemma2-2b", "yi-9b")}
    from repro_torch.kernels.common import fold_in
    train_smoke["gemma2-2b stochastic"] = phase_train(
        "gemma2-2b", SR_SPEC, fold_in(fold_in(0, SR_SEED), 0))
    adapt_smoke = phase_adaptive_smoke()
    log(f"[time] smoke training done at {time.perf_counter() - t0:.1f} s")
    train = phase_train_full(card, "gemma2-2b", 2, 2048,
                             n_layers=GEMMA_LAYERS)
    # yi-9b: YI_LAYERS of 48 layers, so f32 master, AdamW moments and grads fit
    train_yi = phase_train_full(card, "yi-9b", 1, 4096, n_layers=YI_LAYERS)
    log(f"[time] training done at {time.perf_counter() - t0:.1f} s")
    train_sr = phase_train_sr(card, train)
    log(f"[time] stochastic training done at "
        f"{time.perf_counter() - t0:.1f} s")
    adapt = phase_adaptive_full(card)
    log(f"[time] adaptive training done at {time.perf_counter() - t0:.1f} s")
    acc = phase_accuracy(card, acc_cpu)
    log(f"[time] accuracy done at {time.perf_counter() - t0:.1f} s")
    cases = phase_kernels()
    log(f"[time] kernels done at {time.perf_counter() - t0:.1f} s")
    phase_model()
    serve_launches, serve = phase_serve(card)
    log(f"[time] serve done at {time.perf_counter() - t0:.1f} s")
    rec = phase_recurrent(card)
    log(f"[time] recurrent done at {time.perf_counter() - t0:.1f} s")
    moe = phase_moe(card)
    log(f"[time] moe done at {time.perf_counter() - t0:.1f} s")
    va = phase_vlm_audio(card)
    log(f"[time] vlm_audio done at {time.perf_counter() - t0:.1f} s")
    # each gloo world after the first starts up during the phase before
    tp_world = _spawn_ranks("--tp-rank", TP_RANKS, _ranks_dir("tp_ranks"))
    dist = phase_dist(card)
    log(f"[time] dist done at {time.perf_counter() - t0:.1f} s")
    pod_world = _spawn_ranks("--pod-rank", SR_POD_RANKS,
                             _ranks_dir("pod_ranks"))
    tp = phase_tp(card, tp_world)
    log(f"[time] tp done at {time.perf_counter() - t0:.1f} s")
    shard_world = _spawn_ranks("--shard-rank", SHARD_A["data"]
                               * SHARD_A["model"], _ranks_dir("shard_a"))
    pod = phase_pod(card, pod_world)
    log(f"[time] pod done at {time.perf_counter() - t0:.1f} s")
    shard = phase_shard(card, shard_dry_proc, shard_world)
    log(f"[time] shard done at {time.perf_counter() - t0:.1f} s")
    bwd = bwd + rec["kernel_rows"] + moe["kernel_rows"] + va["kernel_rows"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "card": card, "build": build,
                   "cases": cases, "bwd_cases": bwd, "flash_cases": flash,
                   "quantize_cases": quant, "train_smoke": train_smoke,
                   "adaptive_smoke": adapt_smoke, "train_full": train,
                   "train_full_yi": train_yi, "train_sr": train_sr,
                   "adaptive_full": adapt, "accuracy": acc,
                   "serve": serve, "recurrent": rec, "moe": moe,
                   "vlm_audio": va, "autotune": at, "dist": dist,
                   "tp": tp, "pod": pod, "shard": shard},
                  f, indent=1)
    tick = [c for c in cases if c["config"] == "served" and c["M"] == 8
            and c["x_dtype"] == "bfloat16"]
    src = "src/repro_torch/kernels/csrc/"
    sr = train_sr["train"]
    # the accuracy phase's kernel runs: the smoke grid (its one pallas
    # row) and each family's three HBFP policies at full width
    acc_runs = {"accuracy_smoke": [acc["smoke"]]}
    for fam, key in (("minicpm-2b", "accuracy_minicpm"),
                     ("phi3-mini-3.8b", "accuracy_phi3")):
        acc_runs[key] = [r for r in acc["full"][fam]["runs"].values()
                         if r["spec"] != "fp32"]
    acc_paths = lambda k: {p: sum(r["launches"][k] for r in rs)
                           for p, rs in acc_runs.items()}
    acc_route = lambda k, r: sum(run["routes"][k][r]
                                 for rs in acc_runs.values() for run in rs)
    rec_train = rec["train"]
    va_train = {"train_qwen2vl": va["train"]["qwen2-vl-72b"],
                "train_musicgen": va["train"]["musicgen-large"]}
    # the autotune phase's gemma2-2b steps on an empty and a tuned table
    at_train = {f"autotune_gemma2_{t}": r for t, r in at["train"].items()}
    by_path = lambda k: {"train_gemma2": train["launches"][k],
                         "train_yi": train_yi["launches"][k],
                         "train_sr_gemma2": sr["launches"][k],
                         "adaptive_yi": adapt["launches"][k],
                         **acc_paths(k),
                         "train_hymba": rec_train["hymba-1.5b"]["launches"][k],
                         "train_xlstm": rec_train["xlstm-350m"]["launches"][k],
                         "train_llama4": moe["train"]["launches"][k],
                         **{p: t["launches"][k] for p, t in va_train.items()},
                         **{p: t["launches"][k] for p, t in at_train.items()},
                         "dist_gemma2": sum(r["launches"][k]
                                            for r in dist["ranks"]),
                         **_tp_paths(tp, k),
                         **{p: sum(r["launches"][k] for r in rs)
                            for p, rs in sr_runs.items()}}
    # ROADMAP slice 19's stochastic mesh runs, every rank
    sr_runs = {"dist_sr_gemma2": [r["sr"] for r in dist["ranks"]],
               "tp_sr_gemma2_sp": [r["sr"] for r in tp["ranks"]],
               "pod_sr_gemma2": pod["ranks"]}
    rec_served = {f"serve_{a.split('-')[0]}": r["launches"]
                  for a, r in (*rec["serve"].items(),
                               *moe["serve"].items(),
                               *va["serve"].items())}
    # ROADMAP slice 20's sharded serving, every rank: B1 all bf16 wgmma,
    # B4 (the prefills' flash on each rank's heads) all int8 wgmma
    shard_runs = lambda k: {f"shard_{t}": sum(r["launches"][k]
                                              for r in run["ranks"])
                            for t, run in shard["runs"].items()}
    b1_paths = {"serve": serve_launches, **rec_served,
                "autotune_serve_yi": at["serve"]["launches"],
                **by_path("hbfp_matmul_fwd"),
                **shard_runs("hbfp_matmul_fwd")}
    # main-path launches by route: training, the adaptive run and the
    # accuracy runs counted per route; every served launch was checked to
    # be bf16 wgmma
    by_route = lambda k, served=0: {
        r: train["routes"][k][r] + train_yi["routes"][k][r]
        + sr["routes"][k][r] + adapt["launches"][f"{k}/{r}"]
        + acc_route(k, r) + sum(t["routes"][k][r] for t in rec_train.values())
        + moe["train"]["routes"][k][r]
        + sum(t["routes"][k][r] for t in va_train.values())
        + sum(t["routes"][k][r] for t in at_train.values())
        + sum(d["routes"][k][r] for d in dist["ranks"])
        + sum(m["routes"][k][r] for m in _tp_runs(tp))
        + sum(x["routes"][k][r] for rs in sr_runs.values() for x in rs)
        + (served if r == "bf16_wgmma" else 0)
        + (at["serve"]["routes"][r] if k == "hbfp_matmul_fwd" else 0)
        for r in ("int8_wgmma", "bf16_wgmma", "cuda_core")}
    b1_train = _bwd_entry("hbfp_matmul_fwd", bwd, {}, "", "",
                          by_route("hbfp_matmul_fwd", serve_launches
                                   + sum(rec_served.values())
                                   + sum(shard_runs("hbfp_matmul_fwd")
                                         .values())))
    b1 = {
        "name": "hbfp_matmul_fwd", "route": "cuda",
        "source": src + "hbfp_matmul_fwd.cu",
        "replaces": "src/repro/kernels/hbfp_matmul.py:140",
        "held_against": "hbfp_matmul_plain",
        # every main path: yi-9b, hymba-1.5b, xlstm-350m, llama4-scout,
        # arctic-480b, qwen2-vl-72b and musicgen-large serving, and the
        # training paths
        "launches": sum(b1_paths.values()), "launches_by_path": b1_paths,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        # one generate tick's eight served shapes (seven projections of a
        # layer + head) at M = 8, bf16 activations
        "ms": sum(c["kernel_ms"] for c in tick),
        "plain_ms": sum(c["plain_ms"] for c in tick),
        "bound_ms": sum(c["bound_ms"] for c in tick),
        "bound_by": _bound_by(tick),
        "library_ms": None,
        "matmul_bf16_ms": sum(c["matmul_bf16_ms"] for c in tick),
        "launches_by_route": b1_train["launches_by_route"],
        # one gemma2-2b layer + head at M = 4096 (the training forward)
        "train_ms": b1_train["ms"], "train_bound_ms": b1_train["bound_ms"],
        "train_plain_ms": b1_train["plain_ms"],
        "train_int_mm_ms": b1_train["int_mm_ms"],
        "stochastic_ms": b1_train["stochastic_ms"],
        "stochastic_base_ms": b1_train["stochastic_base_ms"],
    }
    b2 = _bwd_entry("hbfp_dgrad", bwd, by_path("hbfp_dgrad"),
                    "src/repro/kernels/hbfp_matmul.py:262",
                    src + "hbfp_matmul_bwd.cu", by_route("hbfp_dgrad"))
    b3 = _bwd_entry("hbfp_wgrad", bwd, by_path("hbfp_wgrad"),
                    "src/repro/kernels/hbfp_matmul.py:352",
                    src + "hbfp_matmul_bwd.cu", by_route("hbfp_wgrad"))
    fref = "src/repro/kernels/hbfp_flash_attn.py:"
    flash_route = lambda k: {r: train_yi["routes"][k][r]
                             + adapt["launches"][f"{k}/{r}"]
                             + acc_route(k, r) + moe["train"]["routes"][k][r]
                             + sum(t["routes"][k][r]
                                   for t in va_train.values())
                             + sum(x["launches"].get(f"{k}/{r}", 0)
                                   for run in shard["runs"].values()
                                   for x in run["ranks"])
                             for r in ("int8_wgmma", "cuda_core")}
    b456 = [_flash_entry(k, flash, {
                "train_yi": train_yi["launches"][k],
                "adaptive_yi": adapt["launches"][k], **acc_paths(k),
                "train_llama4": moe["train"]["launches"][k],
                **{p: t["launches"][k] for p, t in va_train.items()},
                **shard_runs(k)},
                         fref + line,
                         src + ("hbfp_flash_fwd_sm90.cuh"
                                if k == "hbfp_flash_fwd"
                                else "hbfp_flash_bwd_sm90.cuh"),
                         flash_route(k))
            for k, line in (("hbfp_flash_fwd", "128"),
                            ("hbfp_flash_dq", "205"),
                            ("hbfp_flash_dkv", "241"))]
    print(json.dumps({"kernels": [b1, b2, b3, *b456,
                                  _quant_entry(quant, adapt, train_sr,
                                               dist, pod)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
