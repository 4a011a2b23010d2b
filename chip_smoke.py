"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --only effnet   # phases 1, 13 and 14 alone

Drives ``repro_torch`` (never JAX, never the reference package) in phases;
any failure raises and the script exits non-zero:

1. setup    print the card (``nvidia-smi`` name and power limit) and build
            the CUDA kernels K1-K7 and the SE gate from
            ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
2. kernels  hold every kernel against its plain PyTorch version on the card
            (TF32 off, rtol = atol = 1e-4: both are f32, only the summation
            order differs; K1, K3, K4, K5 and K7 flash run their products
            in 3xTF32, which keeps f32's accuracy) at every distinct shape
            the paths
            below launch
            (the CNNs at 224 px and batch 2; Qwen2-0.5B's prefill of 2 x 512
            tokens and its decode steps at cache lengths 513..575), plus
            edge cases (no bias, each activation, residuals, ragged tails,
            stride 2, K5's nonzero expand bias against a zero-padded halo;
            K6 at one row and an odd width; K7 flash at Sq = 37 and 130, a
            chunk against a cache, a padding mask, one query row, D = 8, 20,
            37 and 48 heads on one kv head; K7 decode at ragged ``kv_len``
            and D = 8); time each
            path call on the device (``cuda_time_ms``: CUDA events around
            back-to-back calls, the host's launch overhead held out) beside
            the plain version, a PyTorch library call or chain computing the
            same function (timed here only, never used by the port:
            ``F.rms_norm``, ``scaled_dot_product_attention``) and the least
            time the card could take; each path call again on its own
            core's partition of the split at theta 0.5 (a CNN exec group's
            core, the LM's prefill on c and decode on p), timed there with
            its output bit-equal to the whole card's; K6 also "after its
            producer":
            each call behind the residual add that writes its input on the
            path, the add's own time taken off (K6 may begin while the add
            drains); the plans of K1 and K3 (tile, k-step, cluster, blocks,
            stages, shared memory), K2 (pixel tile, channel block, outputs
            a thread, blocks), K4 and K5 (pixel tile, cluster, blocks), K7
            flash (rows a block, ring, key split, blocks) and K7 decode
            (tensor or CUDA cores, cluster, keys a rank, slots, blocks,
            shared memory) beside them, and at build time their ``-Xptxas -v``
            registers and spills.  K7 is also timed at the head geometry of
            the other registered configs (Qwen2.5-14B 40/8, Granite-20B
            48/1, Command R+ 96/8, Qwen-MoE 16/16, all D 128; Granite-MoE
            24/8 at D 64): decode at 16 rows and a cache of 576, checked
            there with ragged ``kv_len`` down to 0 and 1, and flash at the
            path's prefill of 2 x 512; K6 at their widths over 1024 and 16
            rows.  Then phase 10's path shapes (``block_calls``), timed
            the same way on the whole card: K6 at xLSTM's 1024, Zamba2's
            2560, Whisper's 768 and Qwen2-VL's 8192; K7 flash at Zamba2's
            32/32 heads of D 80 (causal, 2 x 512), Whisper's 12/12 of D 64
            (the encoder's non-causal 1500 x 1500, the decoder's 16 queries
            against 1500 memory keys and its causal prefill) and Qwen2-VL's
            64/8 of D 128 (2 x 320); K7 decode at Zamba2's D 80 (the path's
            rows at the mid cache, and 16 rows at a cache of 576),
            Whisper's one query row against 1500 memory keys and its self
            cache, Qwen2-VL's cache; edge cases at D 80 (ragged ``kv_len``
            down to 0 and 1 on the CUDA and the tensor cores, flash at 37
            rows and as a chunk) and Whisper's ragged cross decode.  Then
            the int8 KV cache's kernels (``flash_attention_int8``,
            ``decode_attention_int8``; ``csrc/flash_attention_int8.cu``)
            against their plain versions at 9(b)'s shapes (Qwen2.5-14B,
            B 2, Hq 40, Hkv 8, D 128: the 2 x 512 prefill into a cache of
            576, and the decode at kv_len 513..576 over the whole cache),
            timed beside the plain version, a ``torch._int_mm`` chain
            (the prefill; the decode's G rows are past its shapes) and
            their bound (the bytes, or the operations at the int8 tensor
            cores' 1,979 TOP/s), and at edges (G 1, 7, 12 and 48; D 64;
            ragged kv_len down to 0 and 1; chunks at q_offset > 0 and
            past sk_valid; cut caches; a cluster of 16): every element
            within rtol = atol = 1e-5 but on the rows a probability's
            rounding tie flips, each such row explained by its ties, and
            those held under 0.1% of the rows;
3. paths    for each of MobileNet v2, MobileNet v1 and SqueezeNet under
            ``balanced`` (``fuse="group"`` exec plans): the eager
            sequential kernel forward (``jit_groups=False``) against the
            all-plain forward at 1e-3 (up to 53 f32 layers, each at 1e-4
            against its plain version, compound), then ``DualCoreEngine``
            over the two cores (green contexts on disjoint SMs of the
            card, split at theta 0.5), 8 requests x batch 2 at 224 px, on
            compiled groups (a CUDA graph per exec group, after one
            untimed warm-up run that captures the lanes) and eagerly:
            outputs of both bit-equal to the eager sequential forward,
            launch counts reset just before each engine run and read just
            after, exactly 8 x the plan's per-request counts, through the
            graphs' replays; one exec group captured again with its graph
            kept, its kernel nodes (``debug_dump``) equal to the plan's
            kernels of the group and to the counts the graph carries; the
            lanes' capture time and device memory; pipelined and
            sequential walls and the host's enqueue time a request, graphs
            and eager in turns, and a request's device time with the host
            held out, the lane's graphs against the same launches made
            eagerly.  Then MobileNet v2's ``fuse=True``
            sequential forward (16 inverted residuals on K5) against the
            plain fused program at 1e-3, its launches counted the same way;
4. fleet    the three CNNs as one fleet (``build_cnn_fleet``, ``balanced``,
            compiled groups) on one pool of the card's two cores: phase
            3's 24 requests (8 a model, all at slot 0, policy
            ``weighted_fair``, burst 4; after one untimed pass that warms
            the new streams and captures the lanes), each output bit-equal
            to its model's sequential kernel forward of phase 3, launches
            reset just before and read just after equal to the sum of the
            plans' per-request counts; the ``compile_fleet`` stream's
            signature equal to the live one, and a fresh fleet's replay of
            it bit-equal; two pools behind a ``MultiPoolRouter`` with a
            forced migration and a REBALANCE (theta 0.7) mid-run, every
            request completed and bit-equal (every fresh fleet warmed first,
            as ``serve fleet`` warms it); aggregate img/s, per-model
            p50/p95, the host's enqueue time a fleet slot (the RUN
            instructions' host windows), the fleet's wall against the same
            requests drained one engine at a time (in turns, 5 each), on
            graphs and eagerly in the same turns, and the Table VII
            planner's rows (the modelled FPGA's fps) beside the measured
            rates;
5. lm       Qwen2-0.5B at its published width (24 layers, d 896, 14/2
            heads, vocab 151936), random weights from seed 0: a 16-token
            prompt's chunked prefill and decode steps on the card against
            the same on the CPU (plain versions) at 1e-3; then
            ``DualMeshEngine`` serves 8 requests of batch 2, prompt 512, 64
            generated tokens, all arriving at slot 0, prefill on the c-core
            and fused decode groups on the p-core (disjoint SMs), each
            decode step
            one CUDA graph replay (after an untimed warm-up at the served
            group width): launch counts reset just before and read just
            after equal the plan (per prefill forward K6 49 and K7 flash 24,
            per decode step K6 49 and K7 decode 24), and the tokens equal
            those of the same engine with both cores on one stream and
            those of the eager decode; tokens/s, p50/p95, the fused sizes,
            the per-stage trace, the host's enqueue time per decode step
            against its device time, graphs and eager in turns (a graph
            step's device time also timed with the host held out, and a
            step's host time with a free launch queue), the
            ``step_floor_base`` the graphs' enqueue implies, K7 decode a
            request over the whole cache against the former cut-to-prefix
            calls, the K6 and K7 device time in a step, and the card's f32
            matmul and copy rates (the cost model's ceilings); the planned
            group size under the cost model's former step floor and its
            current one, and the model's decode step beside the measured
            one.  Then Granite-20B at its published
            width cut to 2 of its 52 layers (f32 at full depth does not
            fit one card), random weights from seed 0: the same prefill,
            chunk and 3 decode steps (K7 decode at G = 48 on the tensor
            cores) on the card against the CPU's plain versions at 1e-3;
6. split    the split of the card's SMs: the SM probe (``csrc/sm_probe.cu``,
            each block writing the SM it ran on) on each core, eagerly and
            in a graph captured on the core and replayed on a plain stream,
            at the fleet planner's theta and at 0.5: the two cores' SM sets
            disjoint and each of its core's size; then, launches counted
            from 0 over the phase, split SMs against shared ones
            (``sm_split=False``) in turns: each CNN engine of phase 3
            (outputs bit-equal to phase 3's sequential forward, pipelined
            and sequential walls, a lane's device ms), the fleet of phase 4
            (outputs bit-equal, walls, then a REBALANCE to theta 0.7 with
            work in flight on the split pool: the c-core's SMs grow and
            every member captures new lanes in the new partitions, outputs
            bit-equal) and Qwen2-0.5B of phase 5 (tokens equal, walls, a
            decode step's graph replay on the p-core's SMs against the
            whole card's); the phase's launches are printed and kept apart
            from the kernels line's;
7. workers  the fleet across processes: the card's compute mode and any
            MPS processes (none is started); two worker processes
            (``start_workers``: ``python -m repro_torch.fleet.worker``, a
            fresh interpreter each, its own CUDA context and its own
            split of the card at theta 0.5, the three CNNs on compiled
            groups, lanes captured before its READY line) behind a
            ``MultiPoolRouter`` over the socket transport: phase 4's 24
            requests cross the wire from the host with a forced migration,
            every output bit-equal to phase 3's and retired once; each
            worker's launches after its warm-up, read from its stderr line
            at shutdown, equal the plans' counts for the requests it
            served (printed apart from the kernels line's); the walls of
            the two workers, two in-process pools and one pool in turns
            (3 each), the coordinator's CPU time a router step, each
            worker's spawn-to-READY time and the bytes on the wire; then a
            fresh pair with ``pool1`` SIGKILLed at router step 2: pool1
            dead, requests recovered, none failed or retired twice,
            outputs bit-equal, the survivor's launches as the plans say,
            and the collected streams replayed on fresh in-process fleets
            on the card with the same signatures and outputs;
8. control  the closed-loop controller (``fleet/control.py``) on the card,
            each run's launches counted from 0 and printed apart from the
            kernels line's: (a) the three CNNs as ``serve fleet`` builds
            them (phase 4's fleet, one pool at theta 0.5), 48 requests one
            a slot whose mix flips from 4:1:1 to 1:1:4 (mbv2:mbv1:sqz) at
            request 24, under ``ControlLoop(interval=8)``: at least one
            Reweight, every output bit-equal to phase 3's, launches as the
            plans say; the stream and the decision log through JSON
            replayed on a fresh warmed fleet with no controller (same
            signature, bit-equal outputs, the log verifying, the same final
            weights); (b) the same fleet and traffic under
            ``ShedPolicy(clock="slot")``, every other request of the first
            24 stale on arrival, on a pool split at theta 0.7: exactly one
            RebalanceTheta, planned by ``plan_fleet`` at one evaluation
            inside the slot (its host seconds printed: the planner's
            stall), the pool re-split at its theta (each core's SMs
            printed) and every member's lanes captured anew there, each
            request served bit-equal or shed once, the stream replayed
            bitwise on a fresh fleet at 0.7; (c) Qwen2-0.5B of phase 5 as a
            ``DualMeshEngine`` member (its own ``split_streams`` at 0.5,
            group size 4, quantum 8, its decode lanes of every reachable
            width captured first) beside the three CNNs, 4 LM requests
            (batch 2, prompt 512, 64 generated) among 24 CNN requests,
            under a controller whose SLO (100 ms) lies below every LM
            latency: Retune halves the width, tokens equal phase 5's, CNN
            outputs bit-equal, K1-K7 launching as the plans say, no lane
            captured during the run, the stream replayed bitwise on a fresh
            uncontrolled fleet; walls, per-model p50/p95, tokens/s and the
            decisions with their reasons;
9. design   the LM design flow and the larger LMs, every earlier phase's
            tensors freed first (green contexts stay): (a) ``search`` on
            the card's SMs for phase 5's traffic (Qwen2-0.5B, 8 x batch
            2, 512 + 64): the visited thetas with their SMs, the chosen
            theta, its planned makespan and the memory check's margin, no
            green context made while it runs; Qwen2-0.5B served at the
            chosen theta and at 0.5 in turns (each warmed first), tokens
            equal, launches as the plan says, walls beside the plans'
            makespans (no ranking claimed); (b) Qwen2.5-14B at full depth
            (48 layers, 59 GB of f32): searched the same way, its weights
            drawn from seed 0 straight to the card (``load_params``; the
            host seconds and the card's memory printed), served 8 x batch
            2, 512 + 64 through ``DualMeshEngine`` at the searched theta,
            K6 97 and K7 48 launches a forward step, tokens on two
            streams equal one stream's; tokens/s, p50/p95, the prefill
            and decode step on their cores' streams and on the whole card
            with the host held out beside the cost model's; K6 and K7 at
            the path's shapes held against their plain versions and
            timed; (c) Qwen-MoE at full depth (57 GB) the same way (K6 49
            and K7 24 a step; the modelled decode step, which prices the
            active parameters, beside the measured one, which reads every
            expert), then Qwen-MoE and Granite-MoE at full width cut to 2
            layers on the card against the CPU's plain versions: the
            16-token prompt (the dense branch) and one 2 x 512 prefill
            (the scatter branch) at 1e-3.  The phase's launches are
            printed apart from the kernels line's, but those of (b)'s
            int8 run: the 14B's ``make_generate(cfg, 64)`` from a seeded
            2 x 512 prompt over an f32 cache and over an int8 cache (576
            positions), launches counted from 0 around each (K6 97 a
            forward; K7 flash 48 in the prefill and K7 decode 48 a step,
            or the int8 kernels in their place and no f32 K7); the int8
            run again with each of its int8 calls held against its plain
            version on the model's own inputs (flips counted, under 0.1%
            of the rows; the same tokens); its tokens equal to a replay
            that launches no int8 kernel (the plain versions, K6 kept)
            and takes the kernel's values on the rows not bit-equal; the
            tokens' agreement with the f32 cache's and with both caches'
            generates through the plain versions, printed and not held
            (the reference's criterion of half does not hold at a
            512-token prompt for the reference either:
            ``tools/int8_agreement.py``); the caches' bytes (a quarter)
            and a decode step's ms on each, and the int8 run's own bytes
            (its peak less the weights, cache and prompt it is given)
            within 10% of the dry run's (``launch/dryrun.py`` on
            ``meta``) at its shapes, the whole peaks printed beside;
10. blocks  the SSM, hybrid, encoder-decoder and M-RoPE families at their
            published widths, every earlier phase's tensors freed first:
            (a) xLSTM-350M (24 mLSTM layers) and (b) Zamba2-2.7B (54
            Mamba2 layers, 9 applications of the shared block; about 10 GB
            of f32 drawn straight to the card by ``load_params``), each
            served through ``DualMeshEngine`` on the split at theta 0.5, 8
            requests x batch 2, prompt 512 + 64 generated, the decode steps
            replayed from captured lanes that hold the SSM states: launches
            as the plan says (``forward_launches``: xLSTM K6 25 a forward
            step and no K7, Zamba2 K6 73 and K7 9), tokens equal to the
            same run on one stream without graphs; walls, tokens/s, a
            prefill on the c-core's stream and a decode step's graph
            replayed with the host held out; (c) Whisper-small (12 encoder
            and 12 decoder layers): ``encode`` over 2 x 1500 seeded frame
            embeddings, ``init_cache(memory=..., params=...)``, a 16-token
            prefill and 64 greedy ``decode_step``s, tokens equal to the
            same run with the plain versions on the card (``plain_kernels``)
            and the prefill's and first step's logits within 1e-3; (d)
            Qwen2-VL-72B at its full width cut to 8 of its 80 layers (38 GB
            of f32): the forward and a prefill by ``decode_step`` over 256
            patch embeddings on a 16 x 16 grid at t = 0 and 64 text tokens
            on M-RoPE, then 16 decode steps with equal position streams
            past the grid, against the plain versions on the card at 1e-3,
            and a text forward on three equal streams bit-equal to the same
            forward on RoPE; for (c) and (d) walls, tokens/s, the prefill's
            device time and a decode step's graph replay.  Each run's
            launches are counted from 0 and count in the kernels line;
11. train   training on the card, every earlier phase's tensors freed
            first: (a) the port's backward kernels (K6's ``rmsnorm_bwd``,
            K7 flash's ``flash_attention_bwd``) and the forwards as
            training launches them (K6 the plain way, K7 flash with its
            log-sum-exp) against their plain versions at the path's
            shapes (K6 4096 x 896; K7 B 8, Hq 14, Hkv 2, S 512, D 64,
            causal) and at edges (non-causal, a chunk, ``sk_valid`` < Sk,
            Sq != Sk, G 1 and 7, D 64, 80 and 128, rows that see no key),
            rtol = atol = 1e-4, each run twice for the same bits, timed
            beside their bounds and the library's backward (autograd of
            ``F.rms_norm``, SDPA's backward); K7 flash's output bit-equal
            with and without the log-sum-exp under every plan; (b)
            Qwen2-0.5B at full width and depth through
            ``launch/train.py``: 8 steps of 8 x 512 tokens, checkpoints
            at steps 0 and 8 into a temporary directory, losses finite
            and falling, launches a step as planned (K6 97, K7 flash 48,
            K6 backward 49, K7 flash backward 24), the step-8 checkpoint
            restored bit-equal to the live state; walls, tokens/s, peak
            memory, each save's seconds and bytes; the run's peak within
            10% of the dry run's tracked peak for the same step on
            ``meta``; (c) the run's first
            step against the plain versions on the card (loss 1e-5,
            gradient norm 1e-4, each leaf within 1e-3 of its largest
            magnitude); (d) recovery at the smoke config, a fault at step
            6, against a clean run;
12. cache   the plan cache (``kernels/autotune.py``) in a temporary
            file: (a) every K1-K5 signature of the zoo's programs and the
            runner's group-fused plans at 224 px, batch 2, tuned on the
            whole card and under each core's stream of the split at theta
            0.5 (``CACHE_REPS`` runs of each candidate); (b) a line a
            signature: the planner's pick's device µs and the winner's on
            each SM count, the candidates that beat the pick and the runs'
            spread, then per kind the sums; (c) MobileNet v1, v2 and
            SqueezeNet ``balanced`` served with the cache on graphs on the
            split cores, eagerly and on shared cores, every K1-K5 lookup a
            hit, every output bit-equal to the same requests served
            without the cache, a request's lane device ms with and without
            it; (d) a config planted outside its signature's candidates
            raises;
13. effnet  EfficientNet-B4 as the benchmark cell ``effb4.offline.b16``
            serves it, every earlier phase's tensors freed first: batch 16
            at 380 px, ``balanced`` (29 exec groups), compiled groups on
            the split the runner measures (``theta=None``), after one
            untimed pipelined run of 4 requests that measures the split
            and captures the lanes: the sequential kernel forward against
            the all-plain forward within 1e-3 of the plain logits' RMS,
            its launches the plan's; ``DualCoreEngine`` over 4 requests,
            launch counts reset just before and read just after, 4 x the
            plan's (K1, K2, K3, ``se_gate``, ``se_scale``), outputs
            bit-equal to the sequential forward, ``runner_se_gates``
            summing to 32, the largest group's kernel nodes the plan's;
            every distinct call (silu epilogues on K1, K2 and K3, K2's
            5x5 window at strides 1 and 2, the SE gate and the scale at
            each block's map, 190x190x144 down to 12x12x2688) against its
            plain version at rtol = atol = 1e-4, timed on the whole card
            and on its core's partition of the measured split (bit-equal
            there) beside the library chain and the bound; edges: sigmoid
            on K1, K2 and K3, the SE kernels' float path;
14. report  one ``[report]`` line for each path and kernel (launches,
            calls, ms, bound, plain and library ms a request), one JSON line
            of the kernels, the card line, and the final
            ``{"ok": true, ...}`` line; the host seconds of each phase.

Per-shape rows also go to ``chiprun_out/chip_smoke.json``.
The same file holds each path's launch counts, walls and kernel sums.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SERVED = ("mobilenet_v2", "mobilenet_v1", "squeezenet")
FUSED = "mobilenet_v2"          # the fuse=True sequential forward
SCHEME = "balanced"
IMAGE = 224
BATCH = 2
REQUESTS = 8
KERNEL_TOL = 1e-4
FORWARD_TOL = 1e-3
DEV = "cuda"
POLICY = "weighted_fair"                # the fleet CLI's defaults
BURST = 4
TURNS = 5                               # fleet / one-at-a-time wall pairs
SPLIT_TURNS = 2                         # split, shared, shared, split
WORKERS = 2                             # phase 7's worker processes
WORKER_TURNS = 3                        # workers / 2 pools / 1 pool walls
WORKER_KILL = ("pool1", 2)              # SIGKILLed at this router step
CONTROL_REQUESTS = 48                   # phase 8's CNN traffic, one a slot
CONTROL_FLIP = 24                       # its mix flips at this request
CONTROL_MIXES = ({"mobilenet_v2": 4, "mobilenet_v1": 1, "squeezenet": 1},
                 {"mobilenet_v2": 1, "mobilenet_v1": 1, "squeezenet": 4})
CONTROL_INTERVAL = 8                    # ControlLoop's default
CONTROL_PLAN_EVALS = 1                  # the planner's budget in 8(b)
# 8(b)'s pool starts here: plan_fleet's theta for phase 8's mixes (0.4952)
# asks the 64 c-core SMs of theta 0.5, and a REBALANCE to the SMs a pool
# already has moves nothing
CONTROL_FROM_THETA = 0.7
MIXED_LM_REQUESTS = 4                   # 8(c): the LM member's requests
MIXED_LM_ARRIVALS = (0, 6, 6, 6)        # ... and their slots
MIXED_GROUP = 4
MIXED_QUANTUM = 8
MIXED_INTERVAL = 4
# below every LM request's latency: its 63 decode steps alone take 390 ms
# or more on the card
MIXED_SLO_MS = 100.0
CNN_KERNELS = ("matmul_bias_act", "depthwise_conv2d", "conv2d_implicit_gemm",
               "fused_dw_pw_conv", "fused_pw_dw_pw_conv")      # K1-K5
CACHE_REPS = 2                  # phase 12: timing runs of each candidate
LM_ARCH = "qwen2_0_5b"
LM_REQUESTS = 8
LM_BATCH = 2
LM_PROMPT = 512
LM_GEN = 64
SPLIT_THETA = 0.5              # phases 3-5's split: each CNN runner's
LM_THETA = SPLIT_THETA         # (given, so none measures) and the LM's
LM_MAX_LEN = LM_PROMPT + LM_GEN + 8    # the CLI's cache length
LM_CHECK_PROMPT = 16                    # card against CPU, full width
# the other registered dense configs, whose decode geometry phase 2 checks
LM_GEOMETRY_ARCHS = ("qwen2_5_14b", "granite_20b", "command_r_plus_104b",
                     "qwen2_moe_a2_7b", "granite_moe_3b_a800m")
LM_GEOMETRY_ROWS = LM_BATCH * 8         # the LM path's decode rows
LM_GEOMETRY_CACHE = 576
GRANITE = "granite_20b"                 # checked at full width, cut depth
# CardModel.step_floor_base before decode steps were graphs (the eager
# enqueue of a step): the planned group size is printed under it too
FORMER_STEP_FLOOR_BASE = 2.79e-3
GRANITE_LAYERS = 2
DESIGN_EVALS = 10                       # serve lm --search's budget
DESIGN_TURNS = 2                        # searched theta / 0.5 wall pairs
BIG_ARCH = "qwen2_5_14b"                # 9(b): served at full depth
BIG_REQUESTS = LM_REQUESTS
MOE_ARCH = "qwen2_moe_a2_7b"            # 9(c): served at full depth
MOE_ARCHS = ("qwen2_moe_a2_7b", "granite_moe_3b_a800m")
MOE_LAYERS = 2                          # 9(c): full width, card vs CPU
WARM_PROMPT = 16                        # 9: warm-up prompts' length
BLOCK_SERVED = ("xlstm_350m", "zamba2_2_7b")    # 10(a), 10(b): served
WHISPER = "whisper_small"                       # 10(c)
WHISPER_PROMPT = 16
WHISPER_GEN = 64                                # greedy decode steps
WHISPER_MAX_LEN = WHISPER_PROMPT + WHISPER_GEN + 8
VL_ARCH = "qwen2_vl_72b"                        # 10(d)
VL_LAYERS = 8                                   # of its 80, full width
VL_GRID = 16                                    # 16 x 16 patches at t = 0
VL_TEXT = 64                                    # text tokens after them
VL_PROMPT = VL_GRID ** 2 + VL_TEXT
VL_STEPS = 16
VL_MAX_LEN = VL_PROMPT + VL_STEPS + 8
EFFNET = "efficientnet_b4"              # phase 13: the benchmark cell's
EFFNET_BATCH = 16                       # model, batch and image size
EFFNET_IMAGE = 380
EFFNET_REQUESTS = 4
SE_KERNELS = ("se_gate", "se_scale")    # phase 13 only
# NVIDIA H100 SXM data sheet (dense, no sparsity): HBM3 3.35 TB/s, f32 on
# the CUDA cores (no tensor cores) 67 TFLOP/s, TF32 on the tensor cores 495
# TFLOP/s, of which 3xTF32 (three products per f32 product) gets a third.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32X3_FLOP_PER_S = 495e12 / 3
FUSED_KERNELS = ("fused_dw_pw_conv", "fused_pw_dw_pw_conv")  # K4, K5
# kernels planned per call on the host; K1, K3, K4, K5 and K7 flash run
# their products in 3xTF32 on the tensor cores, K7 decode where G > 8
PLANNED = ("matmul_bias_act", "depthwise_conv2d", "conv2d_implicit_gemm",
           *FUSED_KERNELS, "flash_attention", "decode_attention")
# the backward kernels, which only training (phase 11) launches
TRAINING_ONLY = ("rmsnorm_bwd", "flash_attention_bwd")
# the sources whose -Xptxas -v report setup prints
PTXAS_SOURCES = ("matmul_bias_act", "depthwise_conv2d",
                 "conv2d_implicit_gemm", *FUSED_KERNELS, "flash_attention",
                 "rmsnorm", "flash_attention_int8", "se_gate")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand(gen: np.random.Generator, shape, scale: float = 1.0,
         device=None) -> torch.Tensor:
    """A standard-normal float32 tensor from ``gen``, times ``scale``, on
    ``device`` (default the card)."""
    a = (gen.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device or DEV)


def bound_ms(nbytes: int, flops: int, tc_flops: int = 0) -> tuple[float,
                                                                  str]:
    """Least time for the work, in ms, and what bounds it.  ``tc_flops`` of
    the ``flops`` run on the tensor cores in 3xTF32, the rest on the CUDA
    cores in f32; the two units may overlap, so the slower one bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max((flops - tc_flops) / PEAK_F32_FLOP_PER_S,
                tc_flops / PEAK_TF32X3_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# the kernels, their plain versions and library yardsticks
# --------------------------------------------------------------------------
def kernel_table():
    """Each ported kernel: wrapper, plain version, source, TPU original."""
    from repro_torch.kernels.conv_gemm.kernel import (conv2d_implicit_gemm,
                                                      matmul_bias_act)
    from repro_torch.kernels.conv_gemm.ref import (conv2d_ref,
                                                   matmul_bias_act_ref)
    from repro_torch.kernels.depthwise.kernel import depthwise_conv2d
    from repro_torch.kernels.depthwise.ref import depthwise_conv2d_ref
    from repro_torch.kernels.fused_block.kernel import (fused_dw_pw_conv,
                                                        fused_pw_dw_pw_conv)
    from repro_torch.kernels.fused_block.ref import (fused_dw_pw_ref,
                                                     fused_pw_dw_pw_ref)
    from repro_torch.kernels.attention.kernel import (decode_attention,
                                                      decode_attention_int8,
                                                      flash_attention,
                                                      flash_attention_int8)
    from repro_torch.kernels.attention.ref import (decode_attention_int8_ref,
                                                   decode_attention_ref,
                                                   flash_attention_int8_ref,
                                                   flash_attention_ref)
    from repro_torch.kernels.attention.kernel import flash_attention_bwd
    from repro_torch.kernels.attention.ref import flash_attention_bwd_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
    from repro_torch.kernels.se.kernel import se_gate, se_scale
    from repro_torch.kernels.se.ref import se_gate_ref, se_scale_ref
    return {
        "matmul_bias_act": dict(
            fn=matmul_bias_act, plain=matmul_bias_act_ref,
            source="src/repro_torch/csrc/matmul_bias_act.cu",
            replaces="src/repro/kernels/conv_gemm/kernel.py:74"),
        "depthwise_conv2d": dict(
            fn=depthwise_conv2d, plain=depthwise_conv2d_ref,
            source="src/repro_torch/csrc/depthwise_conv2d.cu",
            replaces="src/repro/kernels/depthwise/kernel.py:54"),
        "conv2d_implicit_gemm": dict(
            fn=conv2d_implicit_gemm, plain=conv2d_ref,
            source="src/repro_torch/csrc/conv2d_implicit_gemm.cu",
            replaces="src/repro/kernels/conv_gemm/kernel.py:165"),
        "fused_dw_pw_conv": dict(
            fn=fused_dw_pw_conv, plain=fused_dw_pw_ref,
            source="src/repro_torch/csrc/fused_dw_pw_conv.cu",
            replaces="src/repro/kernels/fused_block/kernel.py:96"),
        "fused_pw_dw_pw_conv": dict(
            fn=fused_pw_dw_pw_conv, plain=fused_pw_dw_pw_ref,
            source="src/repro_torch/csrc/fused_pw_dw_pw_conv.cu",
            replaces="src/repro/kernels/fused_block/kernel.py:218"),
        "rmsnorm": dict(
            fn=rmsnorm, plain=rmsnorm_ref,
            source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm/kernel.py:28"),
        "flash_attention": dict(
            fn=flash_attention, plain=flash_attention_ref,
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/attention/kernel.py:74"),
        "decode_attention": dict(
            fn=decode_attention, plain=decode_attention_ref,
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/attention/kernel.py:133"),
        # the int8 cache's kernels: no TPU kernel (the reference's int8
        # attention is jnp); "replaces" names the function they compute
        "flash_attention_int8": dict(
            fn=flash_attention_int8, plain=flash_attention_int8_ref,
            source="src/repro_torch/csrc/flash_attention_int8.cu",
            replaces="src/repro/lm/modules.py:109"),
        "decode_attention_int8": dict(
            fn=decode_attention_int8, plain=decode_attention_int8_ref,
            source="src/repro_torch/csrc/flash_attention_int8.cu",
            replaces="src/repro/lm/modules.py:109"),
        # the port's backward kernels: no TPU kernel is a backward (the
        # reference trains through rmsnorm_ref, XLA's attention and
        # jax.grad); "replaces" names the TPU forward each differentiates
        "rmsnorm_bwd": dict(
            fn=rmsnorm_bwd, plain=rmsnorm_bwd_ref,
            source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm/kernel.py:28"),
        "flash_attention_bwd": dict(
            fn=flash_attention_bwd, plain=flash_attention_bwd_ref,
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/attention/kernel.py:74"),
        # the port's own SE gate (EfficientNet): the TPU system serves no
        # network with SE gates, so it replaces nothing
        "se_gate": dict(
            fn=se_gate, plain=se_gate_ref,
            source="src/repro_torch/csrc/se_gate.cu", replaces=None),
        "se_scale": dict(
            fn=se_scale, plain=se_scale_ref,
            source="src/repro_torch/csrc/se_gate.cu", replaces=None),
    }


def plan_calls(plan, graph, batch: int) -> list[dict]:
    """The kernel calls one request makes through the exec plan."""
    return step_calls([s for g in plan.groups for s in g.steps], graph,
                      batch)


def step_calls(steps, graph, batch: int) -> list[dict]:
    """The kernel calls one request makes through ``steps`` (a program's
    or an exec plan's), derived from the steps and ``graph``'s layer
    specs: one a step, two an SE step's."""
    return [c for s in steps
            for c in se_calls(s, graph, batch) or [step_call(s, graph,
                                                             batch)]]


def se_calls(step, graph, batch: int) -> list[dict]:
    """An EfficientNet SE step's two kernel calls, the gate of its
    block's depthwise output and the scale of that map in place; none for
    another step."""
    if not step.layers[0].endswith("_se_reduce"):
        return []
    r = graph.layer(step.layers[0])
    d = graph.layer(r.name[:-len("_se_reduce")] + "_dw")
    return [dict(kernel="se_gate", n=batch, h=d.H_out, w=d.W_out, c=r.C_i,
                 s=r.C_o),
            dict(kernel="se_scale", n=batch, h=d.H_out, w=d.W_out, c=r.C_i)]


def step_call(step, graph, batch: int) -> dict:
    """The kernel call one step of ``graph``'s program makes, as a dict
    (an SE step's two: :func:`se_calls`)."""
    from repro_torch.dualcore.program import ACT_OF, family
    act = ACT_OF[family(graph.name)]
    if len(step.layers) == 3:
        e, d, p = (graph.layer(n) for n in step.layers)
        return dict(kernel="fused_pw_dw_pw_conv", n=batch, h=e.H, w=e.W,
                    ci=e.C_i, cm=e.C_o, co=p.C_o, k=d.K_h, stride=d.stride,
                    pad=d.pad, exp_act=act(e.name), dw_act=act(d.name),
                    proj_act=act(p.name),
                    res=("add" in p.fused and d.stride == 1
                         and e.C_i == p.C_o))
    if len(step.layers) == 2:
        d, p = (graph.layer(n) for n in step.layers)
        return dict(kernel="fused_dw_pw_conv", n=batch, h=d.H, w=d.W,
                    c=d.C_i, co=p.C_o, k=d.K_h, stride=d.stride, pad=d.pad,
                    dw_act=act(d.name), pw_act=act(p.name), res=False)
    (name,) = step.layers
    l = graph.layer(name)
    if l.op == "dwconv":
        return dict(kernel="depthwise_conv2d", n=batch, h=l.H, w=l.W,
                    c=l.C_i, k=l.K_h, stride=l.stride, pad=l.pad,
                    act=act(name))
    if l.K_h == 1 and l.K_w == 1 and l.stride == 1 and l.pad == 0:
        return dict(kernel="matmul_bias_act", m=batch * l.H * l.W, k=l.C_i,
                    n=l.C_o, act=act(name))
    return dict(kernel="conv2d_implicit_gemm", n=batch, h=l.H, w=l.W,
                ci=l.C_i, co=l.C_o, k=l.K_h, stride=l.stride, pad=l.pad,
                act=act(name))


def edge_calls() -> list[dict]:
    """Edge cases beside the paths' shapes: no bias, each activation, K4
    and K5 with a residual, ragged tails, stride 2, K5's expand bias, K1's
    head without bias and a ragged K split in a cluster."""
    return [
        dict(kernel="matmul_bias_act", m=77, k=13, n=70, act=None,
             bias=False),
        dict(kernel="matmul_bias_act", m=130, k=45, n=129, act="relu"),
        # K1: the M = 2 head without bias; a ragged K split between ranks
        dict(kernel="matmul_bias_act", m=2, k=1280, n=1000, act="relu",
             bias=False),
        dict(kernel="matmul_bias_act", m=37, k=1283, n=130, act="relu6"),
        dict(kernel="depthwise_conv2d", n=1, h=13, w=11, c=37, k=3,
             stride=2, pad=1, act="relu", bias=False),
        dict(kernel="depthwise_conv2d", n=2, h=9, w=9, c=40, k=5, stride=1,
             pad=2, act=None),
        # K2: a ragged C past one channel block; W not a multiple of the
        # outputs a thread
        dict(kernel="depthwise_conv2d", n=2, h=14, w=14, c=1001, k=3,
             stride=2, pad=1, act="relu6"),
        dict(kernel="depthwise_conv2d", n=1, h=10, w=13, c=64, k=3,
             stride=1, pad=1, act="relu6"),
        dict(kernel="conv2d_implicit_gemm", n=2, h=56, w=56, ci=16, co=64,
             k=3, stride=1, pad=1, act="relu"),
        dict(kernel="conv2d_implicit_gemm", n=1, h=15, w=13, ci=5, co=70,
             k=3, stride=2, pad=0, act=None, bias=False),
        dict(kernel="fused_dw_pw_conv", n=2, h=14, w=14, c=96, co=96, k=3,
             stride=1, pad=1, dw_act="relu6", pw_act=None, res=True),
        dict(kernel="fused_dw_pw_conv", n=1, h=11, w=9, c=20, co=70, k=3,
             stride=2, pad=1, dw_act="relu", pw_act="relu", res=False,
             bias=False),
        # K5: no biases; a positive expand bias alone (the halo outside the
        # image must read 0, not act(exp_b)); stride 2 with a ragged Ci;
        # residuals; ragged Cm and Co; each act through None/relu/relu6
        dict(kernel="fused_pw_dw_pw_conv", n=2, h=14, w=14, ci=24, cm=96,
             co=40, k=3, stride=1, pad=1, exp_act="relu6", dw_act="relu6",
             proj_act=None, res=False, bias=False),
        dict(kernel="fused_pw_dw_pw_conv", n=2, h=9, w=13, ci=16, cm=64,
             co=24, k=3, stride=1, pad=1, exp_act="relu6", dw_act=None,
             proj_act=None, res=False, bias="exp"),
        dict(kernel="fused_pw_dw_pw_conv", n=1, h=15, w=17, ci=20, cm=48,
             co=32, k=3, stride=2, pad=1, exp_act=None, dw_act="relu",
             proj_act="relu6", res=False, bias="exp"),
        dict(kernel="fused_pw_dw_pw_conv", n=2, h=12, w=11, ci=24, cm=72,
             co=24, k=3, stride=1, pad=1, exp_act="relu", dw_act="relu6",
             proj_act="relu", res=True),
        dict(kernel="fused_pw_dw_pw_conv", n=1, h=10, w=9, ci=13, cm=37,
             co=70, k=3, stride=2, pad=1, exp_act="relu", dw_act=None,
             proj_act="relu", res=False),
        dict(kernel="fused_pw_dw_pw_conv", n=2, h=9, w=10, ci=12, cm=37,
             co=12, k=3, stride=1, pad=1, exp_act=None, dw_act="relu",
             proj_act="relu6", res=True),
    ]


def make_case(call: dict, gen) -> dict:
    """Inputs, the kernel thunk, the plain thunk, the library thunk, and
    the bytes and operations of one call."""
    kt = kernel_table()[call["kernel"]]
    bias = call.get("bias", True)
    kind = call["kernel"]
    if kind == "matmul_bias_act":
        m, k, n = call["m"], call["k"], call["n"]
        x = rand(gen, (m, k))
        w = rand(gen, (k, n), (2.0 / k) ** 0.5)
        b = rand(gen, (n,), 0.1) if bias else None
        args, kw = (x, w, b), dict(act=call["act"])
        plain = lambda: kt["plain"](x, w, b, call["act"])  # noqa: E731

        def library():
            out = torch.addmm(b, x, w) if b is not None else x @ w
            return _lib_act(out, call["act"])
        nbytes = 4 * (m * k + k * n + (n if bias else 0) + m * n)
        flops = 2 * m * k * n
        return dict(kernel=lambda: kt["fn"](*args, **kw), plain=plain,
                    library=library, nbytes=nbytes, flops=flops,
                    tc_flops=flops)
    elif kind == "depthwise_conv2d":
        n, h, wd, c, kk = call["n"], call["h"], call["w"], call["c"], call["k"]
        s, p = call["stride"], call["pad"]
        x = rand(gen, (n, h, wd, c))
        w = rand(gen, (kk, kk, c), (2.0 / (kk * kk)) ** 0.5)
        b = rand(gen, (c,), 0.1) if bias else None
        args, kw = (x, w, b), dict(stride=s, pad=p, act=call["act"])
        plain = lambda: kt["plain"](x, w, b, stride=s, pad=p,  # noqa: E731
                                    act=call["act"])
        w_oihw = w.permute(2, 0, 1).unsqueeze(1).contiguous()

        def library():
            return _lib_act(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, s, p,
                                     groups=c), call["act"])
        ho, wo = (h + 2 * p - kk) // s + 1, (wd + 2 * p - kk) // s + 1
        nbytes = 4 * (n * h * wd * c + kk * kk * c + (c if bias else 0)
                      + n * ho * wo * c)
        flops = 2 * kk * kk * n * ho * wo * c
    elif kind == "conv2d_implicit_gemm":
        n, h, wd, ci, co = call["n"], call["h"], call["w"], call["ci"], \
            call["co"]
        kk, s, p = call["k"], call["stride"], call["pad"]
        x = rand(gen, (n, h, wd, ci))
        w = rand(gen, (kk, kk, ci, co), (2.0 / (kk * kk * ci)) ** 0.5)
        b = rand(gen, (co,), 0.1) if bias else None
        args, kw = (x, w, b), dict(stride=s, pad=p, act=call["act"])
        plain = lambda: kt["plain"](x, w, b, stride=s, pad=p,  # noqa: E731
                                    act=call["act"])
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def library():
            return _lib_act(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, s, p),
                            call["act"])
        ho, wo = (h + 2 * p - kk) // s + 1, (wd + 2 * p - kk) // s + 1
        nbytes = 4 * (n * h * wd * ci + kk * kk * ci * co
                      + (co if bias else 0) + n * ho * wo * co)
        flops = 2 * n * ho * wo * kk * kk * ci * co
        return dict(kernel=lambda: kt["fn"](*args, **kw), plain=plain,
                    library=library, nbytes=nbytes, flops=flops,
                    tc_flops=flops)
    elif kind == "fused_pw_dw_pw_conv":
        return _fused_ir_case(kt, call, gen)
    elif kind in ("rmsnorm", "flash_attention", "decode_attention"):
        return _lm_case(kt, call, gen)
    elif kind in SE_KERNELS:
        return _se_case(kt, call, gen)
    else:
        n, h, wd, c, co = call["n"], call["h"], call["w"], call["c"], \
            call["co"]
        kk, s, p = call["k"], call["stride"], call["pad"]
        ho, wo = (h + 2 * p - kk) // s + 1, (wd + 2 * p - kk) // s + 1
        x = rand(gen, (n, h, wd, c))
        dw_w = rand(gen, (kk, kk, c), (2.0 / (kk * kk)) ** 0.5)
        dw_b = rand(gen, (c,), 0.1) if bias else None
        pw_w = rand(gen, (c, co), (2.0 / c) ** 0.5)
        pw_b = rand(gen, (co,), 0.1) if bias else None
        res = rand(gen, (n, ho, wo, co)) if call["res"] else None
        acts = dict(dw_act=call["dw_act"], pw_act=call["pw_act"])
        args = (x, dw_w, dw_b, pw_w, pw_b, res)
        kw = dict(stride=s, pad=p, **acts)
        plain = lambda: kt["plain"](*args, **kw)  # noqa: E731
        w_oihw = dw_w.permute(2, 0, 1).unsqueeze(1).contiguous()

        def library():
            d = _lib_act(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, dw_b, s, p,
                                  groups=c), call["dw_act"])
            d = d.permute(0, 2, 3, 1).reshape(n * ho * wo, c)
            out = torch.addmm(pw_b, d, pw_w) if pw_b is not None else d @ pw_w
            out = _lib_act(out, call["pw_act"]).reshape(n, ho, wo, co)
            return out + res if res is not None else out
        nbytes = 4 * (n * h * wd * c + kk * kk * c + c * co
                      + ((c + co) if bias else 0) + n * ho * wo * co
                      * (2 if call["res"] else 1))
        flops = 2 * n * ho * wo * c * (kk * kk + co)
        return dict(kernel=lambda: kt["fn"](*args, **kw), plain=plain,
                    library=library, nbytes=nbytes, flops=flops,
                    tc_flops=2 * n * ho * wo * c * co)
    return dict(kernel=lambda: kt["fn"](*args, **kw), plain=plain,
                library=library, nbytes=nbytes, flops=flops)


def _fused_ir_case(kt: dict, call: dict, gen) -> dict:
    """K5's case.  ``bias``: True (all three), False (none) or "exp" (a
    positive expand bias alone)."""
    n, h, wd, ci, cm, co = (call[k] for k in ("n", "h", "w", "ci", "cm",
                                              "co"))
    kk, s, p = call["k"], call["stride"], call["pad"]
    bias = call.get("bias", True)
    ho, wo = (h + 2 * p - kk) // s + 1, (wd + 2 * p - kk) // s + 1
    x = rand(gen, (n, h, wd, ci))
    exp_w = rand(gen, (ci, cm), (2.0 / ci) ** 0.5)
    exp_b = (rand(gen, (cm,), 0.1) if bias is True
             else rand(gen, (cm,)).abs() + 0.5 if bias == "exp" else None)
    dw_w = rand(gen, (kk, kk, cm), (2.0 / (kk * kk)) ** 0.5)
    dw_b = rand(gen, (cm,), 0.1) if bias is True else None
    proj_w = rand(gen, (cm, co), (2.0 / cm) ** 0.5)
    proj_b = rand(gen, (co,), 0.1) if bias is True else None
    res = rand(gen, (n, ho, wo, co)) if call["res"] else None
    args = (x, exp_w, exp_b, dw_w, dw_b, proj_w, proj_b, res)
    kw = dict(stride=s, pad=p, exp_act=call["exp_act"],
              dw_act=call["dw_act"], proj_act=call["proj_act"])
    w_oihw = dw_w.permute(2, 0, 1).unsqueeze(1).contiguous()

    def library():
        xm = x.reshape(n * h * wd, ci)
        e = torch.addmm(exp_b, xm, exp_w) if exp_b is not None else xm @ exp_w
        e = _lib_act(e, call["exp_act"]).reshape(n, h, wd, cm)
        d = _lib_act(F.conv2d(e.permute(0, 3, 1, 2), w_oihw, dw_b, s, p,
                              groups=cm), call["dw_act"])
        d = d.permute(0, 2, 3, 1).reshape(n * ho * wo, cm)
        out = torch.addmm(proj_b, d, proj_w) if proj_b is not None \
            else d @ proj_w
        out = _lib_act(out, call["proj_act"]).reshape(n, ho, wo, co)
        return out + res if res is not None else out
    nbytes = 4 * sum(t.numel() for t in args if t is not None) \
        + 4 * n * ho * wo * co
    flops = 2 * n * (h * wd * ci * cm + ho * wo * cm * (kk * kk + co))
    return dict(kernel=lambda: kt["fn"](*args, **kw),
                plain=lambda: kt["plain"](*args, **kw), library=library,
                nbytes=nbytes, flops=flops,
                tc_flops=2 * n * (h * wd * ci * cm + ho * wo * cm * co))


def _se_case(kt: dict, call: dict, gen) -> dict:
    """The SE kernels' cases: the gate of an NHWC map (its library chain
    the pool, two ``addmm``, silu and sigmoid), and the scale of a map by
    a gate in place (``fresh`` restores the map before a checked call;
    its library an in-place multiply)."""
    n, h, wd, c = (call[k] for k in ("n", "h", "w", "c"))
    x = rand(gen, (n, h, wd, c))
    if call["kernel"] == "se_gate":
        s = call["s"]
        w1 = rand(gen, (c, s), (2.0 / c) ** 0.5)
        b1 = rand(gen, (s,), 0.1)
        w2 = rand(gen, (s, c), (2.0 / s) ** 0.5)
        b2 = rand(gen, (c,), 0.1)
        args = (x, w1, b1, w2, b2)
        xc = x.permute(0, 3, 1, 2)

        def library():
            pooled = F.adaptive_avg_pool2d(xc, 1).flatten(1)
            return torch.sigmoid(torch.addmm(
                b2, F.silu(torch.addmm(b1, pooled, w1)), w2))
        return dict(kernel=lambda: kt["fn"](*args),
                    plain=lambda: kt["plain"](*args), library=library,
                    nbytes=4 * (n * h * wd * c + 2 * c * s + s + c + n * c),
                    flops=n * h * wd * c + 4 * n * c * s)
    gate = torch.sigmoid(rand(gen, (n, c)))
    y, y_lib = x.clone(), x.clone()
    return dict(kernel=lambda: kt["fn"](y, gate),
                plain=lambda: kt["plain"](x, gate),
                library=lambda: y_lib.mul_(gate[:, None, None, :]),
                fresh=lambda: y.copy_(x),
                nbytes=4 * (2 * n * h * wd * c + n * c), flops=n * h * wd * c)


def _lm_case(kt: dict, call: dict, gen) -> dict:
    """K6's and K7's cases.  K7's k and v are the first ``sk`` rows of a
    cache of ``cap`` rows, as the LM path reads them."""
    kind = call["kernel"]
    if kind == "rmsnorm":
        rows, d = call["rows"], call["d"]
        x = rand(gen, (rows, d))
        w = rand(gen, (d,), 0.5) + 1.0
        # on the path K6 reads the residual sum x + h the add before it
        # wrote: "after" is that add and K6, "producer" the add alone
        h = rand(gen, (rows, d))
        y = torch.empty_like(x)
        return dict(kernel=lambda: kt["fn"](x, w, eps=1e-6),
                    plain=lambda: kt["plain"](x, w, 1e-6),
                    library=lambda: F.rms_norm(x, (d,), w, 1e-6),
                    producer=lambda: torch.add(x, h, out=y),
                    after=lambda: kt["fn"](torch.add(x, h, out=y), w,
                                           eps=1e-6),
                    nbytes=4 * (2 * rows * d + d), flops=4 * rows * d)
    from repro_torch.kernels.attention.plan import plan_decode
    b, hq, hkv, sk, d = (call[k] for k in ("b", "hq", "hkv", "sk", "d"))
    g = hq // hkv
    k = rand(gen, (b, hkv, call["cap"], d))[:, :, :sk]
    v = rand(gen, (b, hkv, call["cap"], d))[:, :, :sk]
    if kind == "decode_attention":
        q = rand(gen, (b, hq, 1, d))
        lens = call.get("kv_len")
        kv_len = (None if lens is None
                  else torch.tensor(lens, dtype=torch.int32, device=DEV))
        mask = (None if lens is None else
                (torch.arange(sk, device=DEV)[None, :]
                 < kv_len[:, None].long())[:, None, None, :])
        seen = (sum(min(max(n, 0), sk) for n in lens) if lens is not None
                else b * sk)
        flops = 4 * hq * d * seen
        return dict(kernel=lambda: kt["fn"](q, k, v, kv_len),
                    plain=lambda: kt["plain"](q, k, v, kv_len),
                    library=_sdpa(q, k, v, mask, False, g),
                    nbytes=4 * (2 * b * hq * d + 2 * hkv * d * seen),
                    flops=flops, tc_flops=flops if plan_decode(
                        b, hq, hkv, sk, d).tc else 0)
    sq, causal, off = call["sq"], call["causal"], call["q_offset"]
    sk_valid = call.get("sk_valid")
    kv_end = sk if sk_valid is None else min(sk, sk_valid)
    q = rand(gen, (b, hq, sq, d))
    kw = dict(causal=causal, q_offset=off, sk_valid=sk_valid)
    qpos = off + torch.arange(sq, device=DEV)[:, None]
    kpos = torch.arange(sk, device=DEV)[None, :]
    vis = kpos < kv_end
    if causal:
        vis = vis & (kpos <= qpos)
    pairs = int(vis.expand(sq, sk).sum().item())     # every query row's
    keys = min(kv_end, off + sq) if causal else kv_end
    plain_causal = causal and off == 0 and sq == sk and sk_valid is None
    flops = 4 * d * pairs * b * hq
    return dict(kernel=lambda: kt["fn"](q, k, v, **kw),
                plain=lambda: kt["plain"](q, k, v, **kw),
                library=_sdpa(q, k, v, None if plain_causal else vis,
                              plain_causal, g),
                nbytes=4 * (2 * b * hq * sq * d + 2 * b * hkv * keys * d),
                flops=flops, tc_flops=flops)


def _sdpa(q, k, v, mask, is_causal: bool, g: int):
    """``scaled_dot_product_attention`` over the same inputs: GQA folded by
    the library where this PyTorch has ``enable_gqa`` (2.5 on), else on k
    and v repeated per group ahead of the timed call."""
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True)
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    return lambda: F.scaled_dot_product_attention(
        q, kr, vr, attn_mask=mask, is_causal=is_causal)


def _lib_act(t: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "relu":
        return torch.relu(t)
    if act == "relu6":
        return torch.clamp(t, 0.0, 6.0)
    if act == "silu":
        return F.silu(t)
    if act == "sigmoid":
        return torch.sigmoid(t)
    return t


def check_and_time(call: dict, gen, timing: bool,
                   parts: dict | None = None) -> dict:
    """Hold one call against its plain version; time it if asked.  On
    each of ``parts`` (core: ``green.Partition``) the call is run and
    timed again on the partition's stream (``c_ms``, ``p_ms``), its output
    bit-equal to the whole card's.  An in-place kernel's case restores its
    input (``fresh``) before each checked call."""
    from repro_torch.kernels.util import cuda_time_ms
    case = make_case(call, gen)

    def checked() -> torch.Tensor:
        if "fresh" not in case:
            return case["kernel"]()
        case["fresh"]()
        return case["kernel"]().clone()
    got = checked()
    want = case["plain"]()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{call}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL):
        raise AssertionError(f"{call}: kernel disagrees with its plain "
                             f"version, max |err| {err:.3e} "
                             f"(rtol = atol = {KERNEL_TOL})")
    row = dict(call, max_abs_err=err)
    if call["kernel"] in PLANNED:
        row["plan"] = kernel_plan(call)
    if timing:
        tc = case.get("tc_flops", 0)
        b_ms, b_by = bound_ms(case["nbytes"], case["flops"], tc)
        row.update(ms=cuda_time_ms(case["kernel"]),
                   plain_ms=cuda_time_ms(case["plain"]),
                   library_ms=cuda_time_ms(case["library"]),
                   bound_ms=b_ms, bound_by=b_by, bytes=case["nbytes"],
                   flops=case["flops"], tc_flops=tc)
        if "after" in case:
            row["after_ms"] = (cuda_time_ms(case["after"])
                               - cuda_time_ms(case["producer"]))
    for core, part in (parts or {}).items():
        with torch.cuda.stream(part.stream):
            again = checked()
            if timing:
                row[f"{core}_ms"] = cuda_time_ms(case["kernel"])
        part.stream.synchronize()
        if not torch.equal(again, got):
            raise AssertionError(f"{call}: on the {core}-core's {part.sms} "
                                 f"SMs the kernel's output differs from "
                                 f"the whole card's")
    return row


def kernel_plan(call: dict) -> dict:
    """The plan K1's, K2's, K3's, K4's, K5's or K7's wrapper launches
    ``call`` with."""
    from repro_torch.kernels.attention.plan import plan_decode, plan_flash
    from repro_torch.kernels.conv_gemm.plan import plan_k1, plan_k3
    from repro_torch.kernels.depthwise.plan import plan_k2
    c = call
    if c["kernel"] in ("matmul_bias_act", "conv2d_implicit_gemm"):
        p = (plan_k1(c["m"], c["k"], c["n"]) if c["kernel"] ==
             "matmul_bias_act" else
             plan_k3(c["n"], c["h"], c["w"], c["ci"], c["co"], c["k"],
                     c["k"], c["stride"], c["pad"], c["ci"] % 4 == 0))
        return dict(tile=f"{p.bm}x{p.bn}", bk=p.bk, warps=f"{p.wm}x"
                    f"{8 // p.wm} ({p.mi}x{p.nj})", cluster=p.cluster,
                    blocks=p.blocks, stages=p.stages, smem=p.smem_bytes)
    if c["kernel"] == "decode_attention":
        p = plan_decode(c["b"], c["hq"], c["hkv"], c["sk"], c["d"])
        return dict(cores="tensor" if p.tc else "cuda", cluster=p.cluster,
                    keys=p.keys, slots=p.slots, blocks=p.blocks,
                    smem=p.smem_bytes)
    if c["kernel"] == "flash_attention":
        p = plan_flash(c["b"], c["hq"], c["hkv"], c["sq"], c["sk"], c["d"],
                       c["causal"], c["q_offset"], c["sk_valid"])
        return dict(rows=p.rows, ring=p.ring, key_split=p.kv_split,
                    blocks=p.blocks, per_sm=p.per_sm, smem=p.smem_bytes)
    if c["kernel"] == "depthwise_conv2d":
        p = plan_k2(c["n"], c["h"], c["w"], c["c"], c["k"], c["k"],
                    c["stride"], c["pad"])
        return dict(tile=f"{p.th}x{p.tw}", channels=4 * p.cq, ow=p.ow,
                    threads=p.threads, blocks=p.blocks, smem=p.smem_bytes)
    return fused_plan(call)


def plan_str(plan: dict) -> str:
    """One line of a plan's fields."""
    return " ".join(f"{k} {v}" for k, v in plan.items())


def fused_plan(call: dict) -> dict:
    """The tiling K4's or K5's wrapper launches ``call`` with."""
    from repro_torch.kernels.fused_block.plan import plan_k4, plan_k5
    c = call
    p = (plan_k4(c["n"], c["h"], c["w"], c["c"], c["co"], c["k"],
                 c["stride"], c["pad"])
         if c["kernel"] == "fused_dw_pw_conv" else
         plan_k5(c["n"], c["h"], c["w"], c["ci"], c["cm"], c["co"], c["k"],
                 c["stride"], c["pad"]))
    return dict(tile=f"{p.th}x{p.tw}", cluster=p.cluster, blocks=p.blocks,
                stages=p.stages, kc=p.kc, group=p.group, smem=p.smem_bytes)


def host_enqueue_ms(runner, images: list[torch.Tensor]) -> float:
    """Host time, in ms per request, to queue every request through every
    exec group back to back, the device running behind; the waits come
    after the clock stops.  Best of 3."""
    from repro_torch.dualcore.runtime import wait_ready
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        envs = []
        for x in images:
            env = runner.place_input(x)
            for h in runner.handles:
                env = h(env)
            envs.append(env)
        best = min(best, time.perf_counter() - t0)
        for env in envs:
            wait_ready(env)
    return best * 1e3 / len(images)


def launch_counts() -> dict[str, int]:
    """Each kernel's launch count."""
    return {name: kt["fn"].launches for name, kt in kernel_table().items()}


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for kt in kernel_table().values():
        kt["fn"].launches = 0


# --------------------------------------------------------------------------
def check_counts(what: str, got: dict[str, int], want: dict[str, int],
                 times: int = 1) -> None:
    """Raise unless ``got`` is ``times`` x ``want`` for every kernel."""
    full = {k: times * want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what}: launches {got} != {full}")


SUMMED = ("ms", "plain_ms", "library_ms", "bytes", "flops", "tc_flops")


def kernel_sums(rows: dict, calls: list[dict],
                cores: list[str] | None = None) -> dict[str, dict]:
    """Per kernel, the phase-2 numbers summed over one request's calls;
    ``partition_ms`` sums each call's time on its core's partition
    (``cores``, one a call), or on the whole card without ``cores``."""
    return weighted_sums(rows, [(c, 1) for c in calls], cores)


# CUDA symbol of each kernel, as a graph's kernel nodes name it, and its
# wrapper (longest first: no symbol is inside a longer one before it)
KERNEL_SYMBOLS = (("fused_pw_dw_pw_kernel", "fused_pw_dw_pw_conv"),
                  ("conv2d_implicit_gemm_kernel", "conv2d_implicit_gemm"),
                  ("decode_attention_kernel", "decode_attention"),
                  ("flash_attention_kernel", "flash_attention"),
                  ("depthwise_conv2d_kernel", "depthwise_conv2d"),
                  ("matmul_bias_act_kernel", "matmul_bias_act"),
                  ("rmsnorm_general_kernel", "rmsnorm"),
                  ("fused_dw_pw_kernel", "fused_dw_pw_conv"),
                  ("rmsnorm_vec_kernel", "rmsnorm"),
                  ("se_gate_kernel", "se_gate"),
                  ("se_scale_kernel", "se_scale"))


def graph_kernel_nodes(graph, name: str) -> tuple[dict[str, int], int]:
    """The kernel nodes of a CUDA graph captured in debug mode, from its
    ``debug_dump`` (written to ``chiprun_out/<name>.dot``): the count of
    each wrapper's kernel, and of the other kernel nodes (PyTorch's)."""
    import re
    path = ROOT / "chiprun_out" / f"{name}.dot"
    path.parent.mkdir(exist_ok=True)
    graph.debug_dump(str(path))
    text = path.read_text()
    starts = [m.start() for m in re.finditer(
        r'"?graph_\d+_node_\d+"?\s*\[', text)]
    ours: Counter = Counter()
    other = 0
    for a, b in zip(starts, starts[1:] + [len(text)]):
        block = text[a:b]
        hit = next((w for sym, w in KERNEL_SYMBOLS if sym in block), None)
        if hit is not None:
            ours[hit] += 1
        elif "KERNEL" in block.upper():
            other += 1
    if not starts:
        raise AssertionError(f"{path}: no graph node in the dump: "
                             f"{text[:400]!r}")
    return dict(ours), other


def group_nodes(runner, graph, tag: str, batch: int = BATCH) -> dict:
    """Capture the runner's largest exec group again with the graph kept,
    and hold its kernel nodes against the plan's kernels of the group and
    against the counts the lane's graph of the group carries."""
    (lane, *_), = runner.lanes.lanes.values()
    gi = max(range(len(runner.groups)),
             key=lambda i: len(runner.groups[i].steps))
    env = {"h": lane.x} if gi == 0 else lane.envs[gi - 1]
    debug, _ = runner._capture(gi, env, torch.cuda.graph_pool_handle(),
                               debug=True)
    want = dict(Counter(c["kernel"] for c in step_calls(
        runner.groups[gi].steps, graph, batch)))
    nodes, other = graph_kernel_nodes(debug.graph,
                                      f"{graph.name}_group{gi}")
    if nodes != want or lane.graphs[gi].launches != want \
            or debug.launches != want:
        raise AssertionError(f"{tag} group {gi}: kernel nodes {nodes}, "
                             f"counted {lane.graphs[gi].launches}, plan "
                             f"{want}")
    return dict(group=gi, steps=len(runner.groups[gi].steps),
                kernel_nodes=nodes, other_kernel_nodes=other)


def chain_device_ms(runner, eager) -> dict[str, float]:
    """Device ms of one request's whole exec-group chain on the current
    stream, the host's launch cost held out (``cuda_time_ms``): the
    lane's graphs replayed one after another (each group's kernels on its
    core's SMs), and the same groups launched eagerly (on every SM)."""
    from repro_torch.kernels.util import cuda_time_ms
    lane = next(iter(runner.lanes.lanes.values()))[0]

    def graphs():
        for g in lane.graphs:
            g.replay()

    def launches():
        env = {"h": lane.x}
        for gi in range(len(eager.groups)):
            env = eager._eager(gi, env)

    return dict(graphs=cuda_time_ms(graphs, reps=10),
                eager=cuda_time_ms(launches, reps=10))


def serve_path(model: str, gen, rows: dict) -> dict:
    """One model's ``balanced`` serving path: the forward check, then the
    engine over the two streams on compiled groups and eagerly, launches
    counted.  Returns the path's numbers."""
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.dualcore.program import build_program
    from repro_torch.dualcore.runtime import DualCoreRunner
    from repro_torch.models.cnn import build_model
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine

    params, _, graph = build_model(model, seed=0, device="cuda")
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), SCHEME)
    runners = {"graphs": DualCoreRunner(model, params, sched, device="cuda",
                                        theta=SPLIT_THETA),
               "eager": DualCoreRunner(model, params, sched, device="cuda",
                                       theta=SPLIT_THETA, jit_groups=False)}
    runner, eager = runners["graphs"], runners["eager"]
    calls = plan_calls(runner.plan, graph, BATCH)
    per_request = dict(Counter(c["kernel"] for c in calls))
    tag = f"[{model}]"
    print(f"{tag} {SCHEME}: {len(runner.groups)} exec groups; launches per "
          f"request {per_request}")

    # the eager sequential kernel forward against the all-plain forward
    x = rand(gen, (BATCH, IMAGE, IMAGE, 3))
    plain_out = build_program(model, plain=True).run(params, x)
    reset_counts()
    (seq_out,) = eager.run_sequential([x])
    counts = launch_counts()
    err = (seq_out - plain_out).abs().max().item()
    if not torch.allclose(seq_out, plain_out, rtol=FORWARD_TOL,
                          atol=FORWARD_TOL):
        raise AssertionError(f"{model}: kernel forward disagrees with the "
                             f"plain forward: max |err| {err:.3e}")
    check_counts(f"{model} forward", counts, per_request)
    print(f"{tag} kernel forward vs plain forward: max |err| {err:.2e} "
          f"(tol {FORWARD_TOL})")

    # serving, on graphs and eagerly
    images = [rand(gen, (BATCH, IMAGE, IMAGE, 3)) for _ in range(REQUESTS)]
    seq = eager.run_sequential(images)
    # warm-up, untimed: the first lane's eager run and capture, then the
    # lanes the traffic holds at once (captures stay out of every window)
    runner.run_pipelined(images)
    served, results = {}, {}
    for name, r in runners.items():
        reset_counts()
        res = replay(DualCoreEngine(r), [Request(im) for im in images])
        served[name] = launch_counts()
        results[name] = res
        check_counts(f"{model} serving on {name}", served[name],
                     per_request, REQUESTS)
        for i, (a, b) in enumerate(zip(res.outputs, seq)):
            if a.shape != (BATCH, 1000) or not torch.isfinite(a).all():
                raise AssertionError(f"{model} request {i}: bad output "
                                     f"{a.shape}")
            if not torch.equal(a, b):
                raise AssertionError(f"{model} request {i}: the engine on "
                                     f"{name} differs from the eager "
                                     f"sequential kernel forward")
    res = results["graphs"]
    nodes = group_nodes(runner, graph, tag)
    lanes = [ln for v in runner.lanes.lanes.values() for ln in v]
    lane_mb = sum(ln.nbytes for ln in lanes) / len(lanes) / 2 ** 20
    print(f"{tag} compiled groups: {len(lanes)} lanes of "
          f"{len(runner.groups)} graphs captured in "
          f"{runner.capture_s * 1e3:.1f} ms, {lane_mb:.1f} MiB a lane; "
          f"group {nodes['group']} ({nodes['steps']} steps) has kernel "
          f"nodes {nodes['kernel_nodes']} (the plan's) and "
          f"{nodes['other_kernel_nodes']} of PyTorch's")
    m = res.metrics
    walls = {(n, mode): [] for n in runners
             for mode in ("pipelined", "sequential")}
    for _ in range(3):                                 # in turns
        for name, r in runners.items():
            for mode in ("pipelined", "sequential"):
                walls[name, mode].append(r.timed(images, mode)[1])
    best = {k: min(v) for k, v in walls.items()}
    print(f"{tag} {REQUESTS} requests x batch {BATCH} @ {IMAGE}px on graphs "
          f"in {res.stats['slots']} slots: {res.stats['wall_s'] * 1e3:.2f} "
          f"ms, {REQUESTS * BATCH / res.stats['wall_s']:.1f} img/s, p50 "
          f"{m.p50_ms():.2f} ms, p95 {m.p95_ms():.2f} ms; outputs on graphs "
          f"and eager bit-equal to the eager sequential kernel forward; "
          f"launches {served['graphs']} on each")
    host = {name: [] for name in runners}
    for name in (*runners, *reversed(runners)):        # in turns
        host[name].append(host_enqueue_ms(runners[name], images))
    sums = kernel_sums(rows, calls, plan_cores(runner.plan, graph))
    device_ms = sum(v["ms"] for v in sums.values())
    chain_ms = chain_device_ms(runner, eager)
    print(f"{tag} device ms a request, the whole chain on one stream with "
          f"the host held out: graphs {chain_ms['graphs']:.4f} (each "
          f"group's kernels on its core's SMs), eager "
          f"{chain_ms['eager']:.4f} (on every SM; K1's launches are "
          f"programmatic dependents, K2-K5's are not)")
    for name in runners:
        print(f"{tag} {name}: pipelined "
              + ", ".join(f"{w * 1e3:.2f}" for w in walls[name, "pipelined"])
              + " ms, sequential "
              + ", ".join(f"{w * 1e3:.2f}"
                          for w in walls[name, "sequential"])
              + f" ms (3 each, in turns); best "
              f"{REQUESTS * BATCH / best[name, 'pipelined']:.1f} and "
              f"{REQUESTS * BATCH / best[name, 'sequential']:.1f} img/s"
              f"; host enqueue a request "
              + ", ".join(f"{h:.3f}" for h in host[name])
              + f" ms ({REQUESTS} requests queued back to back, best of 3 a "
              f"turn) against {device_ms:.3f} ms of device kernel time "
              f"(phase 2, summed over the request's {len(calls)} launches)")
    return dict(model=model, groups=len(runner.groups),
                per_request=per_request, launches=served["graphs"],
                kernels=sums, forward_max_abs_err=err,
                wall_s=res.stats["wall_s"], p50_ms=m.p50_ms(),
                p95_ms=m.p95_ms(),
                pipelined_s=best["graphs", "pipelined"],
                sequential_s=best["graphs", "sequential"],
                host_enqueue_ms=min(host["graphs"]), device_ms=device_ms,
                eager=dict(pipelined_s=walls["eager", "pipelined"],
                           sequential_s=walls["eager", "sequential"],
                           host_enqueue_ms=host["eager"],
                           launches=served["eager"]),
                graphs=dict(pipelined_s=walls["graphs", "pipelined"],
                            sequential_s=walls["graphs", "sequential"],
                            host_enqueue_ms=host["graphs"],
                            lanes=len(lanes), capture_s=runner.capture_s,
                            chain_device_ms=chain_ms,
                            lane_bytes=[ln.nbytes for ln in lanes],
                            group_nodes=nodes),
                io=(images, seq), runner=runner)


def fused_forward_path(gen, rows: dict) -> dict:
    """MobileNet v2's ``fuse=True`` sequential forward (K5 on every
    inverted residual) against the plain fused program, one request."""
    from repro_torch.dualcore.program import build_program
    from repro_torch.models.cnn import FORWARDS, build_model

    params, _, graph = build_model(FUSED, seed=0, device="cuda")
    calls = step_calls(build_program(FUSED, fuse=True).steps, graph, BATCH)
    per_request = dict(Counter(c["kernel"] for c in calls))
    if per_request.get("fused_pw_dw_pw_conv") != 16:
        raise AssertionError(f"fused forward: {per_request}")
    x = rand(gen, (BATCH, IMAGE, IMAGE, 3))
    plain_out = build_program(FUSED, fuse=True, plain=True).run(params, x)
    reset_counts()
    out = FORWARDS[FUSED](params, x, fuse=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_counts(f"{FUSED} fuse=True forward", launches, per_request)
    err = (out - plain_out).abs().max().item()
    if (out.shape != (BATCH, 1000) or not torch.isfinite(out).all()
            or not torch.allclose(out, plain_out, rtol=FORWARD_TOL,
                                  atol=FORWARD_TOL)):
        raise AssertionError(f"{FUSED} fuse=True forward disagrees with the "
                             f"plain fused program: max |err| {err:.3e}")
    sums = kernel_sums(rows, calls)
    device_ms = sum(v["ms"] for v in sums.values())
    print(f"[{FUSED} fuse=True] one request: max |err| {err:.2e} against "
          f"the plain fused program (tol {FORWARD_TOL}); launches "
          f"{launches}; device kernel time {device_ms:.3f} ms (phase 2, "
          f"summed over the request's calls)")
    return dict(model=FUSED, fuse=True, per_request=per_request,
                launches=launches, kernels=sums, forward_max_abs_err=err,
                device_ms=device_ms)


# --------------------------------------------------------------------------
# the LM path
# --------------------------------------------------------------------------
def lm_group_sizes(name: str = LM_ARCH) -> list[int]:
    """The fused decode groups the LM path of ``name`` forms: the card
    cost model's group size for its queue
    (``DualMeshRunner.planned_group_size``), each core priced at its share
    of the SMs of the split at ``LM_THETA`` (made once and kept, so the
    served runners get the same)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.cost import CardModel
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.schedule import plan_admission
    dual = split_streams(DEV, LM_THETA)
    gs = plan_admission(get_arch(name), dual, CardModel(), LM_BATCH,
                        LM_PROMPT, LM_GEN, LM_REQUESTS).group_size
    return [min(gs, LM_REQUESTS - i) for i in range(0, LM_REQUESTS, gs)]


def _k6(rows: int, d: int = 896) -> dict:
    return dict(kernel="rmsnorm", rows=rows, d=d)


def _flash(b, sq, sk, cap, q_offset=0, sk_valid=None, causal=True, d=64,
           hq=14, hkv=2) -> dict:
    return dict(kernel="flash_attention", b=b, hq=hq, hkv=hkv, sq=sq, sk=sk,
                d=d, cap=cap, causal=causal, q_offset=q_offset,
                sk_valid=sk_valid)


def _decode(b, sk, cap, kv_len=None, d=64, hq=14, hkv=2) -> dict:
    return dict(kernel="decode_attention", b=b, hq=hq, hkv=hkv, sk=sk, d=d,
                cap=cap, kv_len=kv_len)


def lm_request_calls(size: int) -> list[tuple[dict, float]]:
    """One LM request's kernel calls with their weights: its prefill
    forward (48 norms over the 2 x 512 prompt rows, the final norm over the
    last position's 2 rows, 24 flash calls), and its share 1/size of the
    63 decode steps of a group of ``size`` requests (49 norms over the
    group's rows and 24 decode calls over the whole cache of 584, masked
    to 513..575 keys)."""
    return lm_prefill_calls() + lm_decode_step_calls(size)


def lm_request_cores(size: int) -> list[str]:
    """The core each of ``lm_request_calls(size)`` runs on: the prefill's
    on the c-core, the decode steps' on the p-core."""
    return (["c"] * len(lm_prefill_calls())
            + ["p"] * len(lm_decode_step_calls(size)))


def lm_prefill_calls() -> list[tuple[dict, float]]:
    """An LM request's prefill calls with their weights."""
    from repro_torch.configs.registry import get_arch
    L = get_arch(LM_ARCH).n_layers
    return [(_k6(LM_BATCH * LM_PROMPT), 2 * L), (_k6(LM_BATCH), 1),
            (_flash(LM_BATCH, LM_PROMPT, LM_PROMPT, LM_MAX_LEN), L)]


def lm_decode_step_calls(size: int) -> list[tuple[dict, float]]:
    """An LM request's share of its decode group's step calls."""
    from repro_torch.configs.registry import get_arch
    L, rows = get_arch(LM_ARCH).n_layers, LM_BATCH * size
    steps = LM_GEN - 1
    return ([(_k6(rows), (2 * L + 1) * steps / size)]
            + [(c, L / size) for c in lm_decode_calls(rows)])


def lm_decode_calls(rows: int, whole: bool = True) -> list[dict]:
    """K7 decode's calls in one layer over the 63 decode steps of a group
    of ``rows`` rows: over the whole cache, masked to ``kv_len`` (the
    shape-static decode the path runs), or cut to the filled prefix (the
    former path's calls)."""
    lens = range(LM_PROMPT + 1, LM_PROMPT + LM_GEN)
    if whole:
        return [_decode(rows, LM_MAX_LEN, LM_MAX_LEN, kv_len=[n] * rows)
                for n in lens]
    return [_decode(rows, n, LM_MAX_LEN) for n in lens]


def lm_edge_calls() -> list[dict]:
    """K6 at one row, at an odd width and past a warp's reach; K7 flash at
    Sq = 37 and 130 (no multiple of a block's rows), a chunk against a
    cache, a padding mask, one query row, D = 8, 20 and 37 (not a multiple
    of 8, nor of 4) and Granite's 48 heads on one kv head; K7 decode at a
    cache of 576, ragged ``kv_len`` and D = 8."""
    return [_k6(1), _k6(16), _k6(16, 897), _k6(3, 12288),
            _flash(1, 37, 37, 37), _flash(2, 130, 130, 130),
            _flash(2, 128, 512, LM_MAX_LEN, 384),
            _flash(1, 64, 200, 200, sk_valid=150, causal=False),
            _flash(2, 1, 100, 100, causal=False),
            _flash(2, 33, 33, 33, d=8), _flash(1, 50, 70, 70, 20, d=20),
            _flash(1, 45, 45, 45, d=37),
            _flash(1, 40, 40, 40, d=128, hq=48, hkv=1),
            _decode(2, 576, LM_MAX_LEN),
            _decode(4, 576, LM_MAX_LEN, kv_len=[513, 1, 576, 300]),
            _decode(3, 100, 100, kv_len=[100, 37, 1], d=8)]


def lm_geometry_calls() -> list[dict]:
    """K7 decode at the head geometry of the other registered configs
    (dense and MoE), at the LM path's decode rows and a cache of 576, and
    K7 flash there at the LM path's prefill (batch 2, 512 tokens); K6 at
    their widths over the prefill's and the decode's rows."""
    from repro_torch.configs.registry import get_arch
    out = [_k6(rows, d) for d in sorted({get_arch(name).d_model
                                         for name in LM_GEOMETRY_ARCHS})
           for rows in (LM_BATCH * LM_PROMPT, LM_GEOMETRY_ROWS)]
    for name in LM_GEOMETRY_ARCHS:
        cfg = get_arch(name)
        out.append(_decode(LM_GEOMETRY_ROWS, LM_GEOMETRY_CACHE, LM_MAX_LEN,
                           d=cfg.d_head, hq=cfg.n_heads,
                           hkv=cfg.n_kv_heads))
    for name in LM_GEOMETRY_ARCHS:
        cfg = get_arch(name)
        out.append(_flash(LM_BATCH, LM_PROMPT, LM_PROMPT, LM_MAX_LEN,
                          d=cfg.d_head, hq=cfg.n_heads, hkv=cfg.n_kv_heads))
    return out


def lm_geometry_edge_calls() -> list[dict]:
    """The decode geometries with ragged ``kv_len``, 0 and 1 among them."""
    return [dict(c, b=4, kv_len=[576, 0, 1, 300])
            for c in lm_geometry_calls() if c["kernel"] == "decode_attention"]


def forward_launches(cfg) -> tuple[int, int]:
    """K6 and K7 launches of one forward step (a prefill or a decode step)
    of ``cfg``'s decoder, as its layers make them: a transformer 2 norms
    and an attention a layer (Whisper's decoder 3 and 2: its
    cross-attention), an SSM layer 1 norm and no attention, Zamba2's
    shared block 2 norms and an attention each time it is applied; and
    the final norm."""
    L = cfg.n_layers
    if cfg.block_type == "transformer":
        cross = 1 if cfg.encoder_decoder else 0
        return (2 + cross) * L + 1, (1 + cross) * L
    apps = L // cfg.attn_every if cfg.attn_every else 0
    return L + 2 * apps + 1, apps


def _geo(cfg) -> dict:
    return dict(d=cfg.d_head, hq=cfg.n_heads, hkv=cfg.n_kv_heads)


def block_request_calls(name: str, size: int) -> list[tuple[dict, float]]:
    """One request's kernel calls with their weights on phase 10's paths.
    xLSTM and Zamba2 served as the LM path is (a request's prefill of 2 x
    512 and its share 1/size of its group's 63 decode steps, K7 decode at
    the mid cache); Whisper's whole run (the encoder over 2 x 1500 frames,
    a 16-token prefill, 64 decode steps: self-attention at the mid cache
    and cross-attention over the 1500 memory keys); Qwen2-VL cut to 8
    layers (its forward and its prefill by ``decode_step`` over the 320
    prompt tokens, 16 decode steps, two text forwards)."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(name)
    d, geo = cfg.d_model, _geo(cfg)
    norms, attn = forward_launches(cfg)
    if name == WHISPER:
        enc, cap = cfg.enc_layers, WHISPER_MAX_LEN
        mid = WHISPER_PROMPT + WHISPER_GEN // 2
        rows = LM_BATCH * WHISPER_PROMPT
        frames = cfg.enc_positions
        L = cfg.n_layers
        return [(_k6(LM_BATCH * frames, d), 2 * enc + 1),
                (_flash(LM_BATCH, frames, frames, frames, causal=False,
                        **geo), enc),
                (_k6(rows, d), norms),
                (_flash(LM_BATCH, WHISPER_PROMPT, WHISPER_PROMPT, cap,
                        **geo), L),
                (_flash(LM_BATCH, WHISPER_PROMPT, frames, frames,
                        causal=False, **geo), L),
                (_k6(LM_BATCH, d), norms * WHISPER_GEN),
                (_decode(LM_BATCH, cap, cap, kv_len=[mid] * LM_BATCH, **geo),
                 L * WHISPER_GEN),
                (_decode(LM_BATCH, frames, frames, **geo), L * WHISPER_GEN)]
    if name == VL_ARCH:
        L = VL_LAYERS
        norms, mid = 2 * L + 1, VL_PROMPT + VL_STEPS // 2
        rows = LM_BATCH * VL_PROMPT
        return [(_k6(rows, d), 4 * norms),
                (_flash(LM_BATCH, VL_PROMPT, VL_PROMPT, VL_PROMPT, **geo),
                 3 * L),
                (_flash(LM_BATCH, VL_PROMPT, VL_PROMPT, VL_MAX_LEN, **geo),
                 L),
                (_k6(LM_BATCH, d), norms * VL_STEPS),
                (_decode(LM_BATCH, VL_MAX_LEN, VL_MAX_LEN,
                         kv_len=[mid] * LM_BATCH, **geo), L * VL_STEPS)]
    rows_dec, steps = LM_BATCH * size, LM_GEN - 1
    mid = LM_PROMPT + LM_GEN // 2
    calls = [(_k6(LM_BATCH * LM_PROMPT, d), norms - 1), (_k6(LM_BATCH, d), 1),
             (_k6(rows_dec, d), norms * steps / size)]
    if attn:
        calls += [(_flash(LM_BATCH, LM_PROMPT, LM_PROMPT, LM_MAX_LEN, **geo),
                   attn),
                  (_decode(rows_dec, LM_MAX_LEN, LM_MAX_LEN,
                           kv_len=[mid] * rows_dec, **geo),
                   attn * steps / size)]
    return calls


def block_calls() -> list[dict]:
    """Phase 10's distinct kernel calls (each served config's at each of
    its planned group sizes), and K7 decode at Zamba2's head geometry at
    the LM path's 16 rows and a cache of 576."""
    from repro_torch.configs.registry import get_arch
    out = []
    for name in BLOCK_SERVED:
        for size in sorted(set(lm_group_sizes(name))):
            out += [c for c, _ in block_request_calls(name, size)]
    out += [c for name in (WHISPER, VL_ARCH)
            for c, _ in block_request_calls(name, 1)]
    out.append(_decode(LM_GEOMETRY_ROWS, LM_GEOMETRY_CACHE, LM_MAX_LEN,
                       **_geo(get_arch("zamba2_2_7b"))))
    return list({json.dumps(c, sort_keys=True): c for c in out}.values())


def block_edge_calls() -> list[dict]:
    """K7 at Zamba2's head width 80 (no power of two): decode with ragged
    ``kv_len`` (0 and 1 among them) on the CUDA cores (G 1) and on the
    tensor cores (G 16), flash at 37 rows and as a chunk against a cache;
    Whisper's cross-attention decode with ragged lengths."""
    from repro_torch.configs.registry import get_arch
    z = _geo(get_arch("zamba2_2_7b"))
    return [_decode(4, 576, LM_MAX_LEN, kv_len=[576, 0, 1, 300], **z),
            _decode(4, 576, LM_MAX_LEN, kv_len=[576, 0, 1, 300], d=80,
                    hq=32, hkv=2),
            _decode(3, 100, 100, kv_len=[100, 37, 1], d=80, hq=8, hkv=8),
            _flash(1, 37, 37, 37, **z),
            _flash(2, 128, 512, LM_MAX_LEN, 384, **z),
            _decode(2, 1500, 1500, kv_len=[1500, 1], d=64, hq=12, hkv=12)]


def weighted_sums(rows: dict, calls: list[tuple[dict, float]],
                  cores: list[str] | None = None) -> dict:
    """Per kernel, the phase-2 numbers summed over weighted calls, as
    :func:`kernel_sums`."""
    out: dict[str, dict] = {}
    for i, (c, wgt) in enumerate(calls):
        r = rows[json.dumps(c, sort_keys=True)]
        acc = out.setdefault(c["kernel"], dict(
            calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
            flops=0, tc_flops=0, max_abs_err=0.0, partition_ms=0.0))
        acc["calls"] += wgt
        for k in SUMMED:
            acc[k] += wgt * r[k]
        acc["partition_ms"] += wgt * (r["ms"] if cores is None
                                      else r[f"{cores[i]}_ms"])
        acc["max_abs_err"] = max(acc["max_abs_err"], r["max_abs_err"])
    return out


def card_rates() -> dict:
    """What the cost model's ceilings would read: the f32 matmul rate at
    the prefill's up projection (1024 x 896 @ 896 x 4864, TF32 off) and a
    1 GiB device copy's rate (read + write)."""
    from repro_torch.kernels.util import cuda_time_ms
    a = torch.randn(LM_BATCH * LM_PROMPT, 896, device=DEV)
    b = torch.randn(896, 4864, device=DEV)
    mm_ms = cuda_time_ms(lambda: a @ b)
    src = torch.empty(2 ** 28, device=DEV)
    dst = torch.empty_like(src)
    cp_ms = cuda_time_ms(lambda: dst.copy_(src), reps=10)
    return dict(matmul_tflops=2 * a.shape[0] * 896 * 4864 / mm_ms / 1e9,
                copy_tb_per_s=2 * 4 * src.numel() / cp_ms / 1e9)


def lm_card_vs_cpu(cfg, params, host) -> float:
    """A 16-token prompt at full width: a 12-token prefill, a 4-token chunk
    against the cache (K7 flash at q_offset 12) and 3 decode steps (K7
    decode), on the card against the plain versions on the CPU, fed the
    CPU's tokens.  Returns the largest logit difference."""
    from repro_torch.dualmesh.runtime import random_prompts
    from repro_torch.lm.model import decode_step, init_cache, \
        params_from_numpy
    cpu = params_from_numpy(host, "cpu")
    tokens = random_prompts(cfg, 1, LM_BATCH, LM_CHECK_PROMPT, seed=2)[0]
    cc = init_cache(cfg, LM_BATCH, 32, "cpu")
    gc = init_cache(cfg, LM_BATCH, 32, DEV)
    feeds = [tokens[:, :12], tokens[:, 12:]]
    worst = 0.0
    for i in range(len(feeds) + 3):
        feed = feeds[i] if i < len(feeds) else nxt
        want, cc = decode_step(cpu, cfg, feed, cc)
        got, gc = decode_step(params, cfg, feed.to(DEV), gc)
        got = got.cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"lm step {i}: logits {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=FORWARD_TOL, atol=FORWARD_TOL):
            raise AssertionError(f"lm step {i}: the card's logits differ "
                                 f"from the CPU's plain ones by {err:.3e}")
        worst = max(worst, err)
        nxt = torch.argmax(want[:, -1, :cfg.vocab], dim=-1)[:, None]
    return worst


def lm_device_ms(cfg, params, rows_dec: int) -> tuple[float, float]:
    """Device ms of one decode step of ``rows_dec`` rows at cache length
    ``LM_PROMPT + LM_GEN // 2`` and of one prefill forward of the path's
    prompt, the host's launch cost held out (``cuda_time_ms``)."""
    from repro_torch.kernels.util import cuda_time_ms
    from repro_torch.lm.model import decode_step, init_cache
    mid = LM_PROMPT + LM_GEN // 2
    cache = init_cache(cfg, rows_dec, LM_MAX_LEN, DEV)._replace(
        pos=mid, pos_dev=torch.tensor(mid, dtype=torch.int32, device=DEV))
    tok = torch.zeros((rows_dec, 1), dtype=torch.int64, device=DEV)
    step = cuda_time_ms(lambda: decode_step(params, cfg, tok, cache), reps=4)
    pcache = init_cache(cfg, LM_BATCH, LM_MAX_LEN, DEV)
    ptok = torch.zeros((LM_BATCH, LM_PROMPT), dtype=torch.int64, device=DEV)
    prefill = cuda_time_ms(lambda: decode_step(params, cfg, ptok, pcache,
                                               last_only=True), reps=2)
    return step, prefill


def served_run(runner, prompts, gs: int):
    """One counted run of ``prompts`` through ``DualMeshEngine`` at group
    size ``gs``: the result, its launches and the stream ms of its
    stages."""
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.lm import DualMeshEngine
    start = len(runner.trace)
    reset_counts()
    res = replay(DualMeshEngine(runner, group_size=gs),
                 [Request(p, gen_steps=LM_GEN) for p in prompts])
    launches = launch_counts()
    return res, launches, runner.trace_stream_ms()[start:]


def check_lm_run(tag: str, cfg, res, launches, prompts) -> int:
    """Launches as the plan says (a forward step: ``forward_launches``,
    for a transformer K6 2L + 1 and K7 L) and well-formed outputs that
    keep their prompts; returns the decode steps."""
    n = len(prompts)
    norms, attn = forward_launches(cfg)
    steps = (LM_GEN - 1) * len(res.stats["fused_sizes"])
    check_counts(tag, launches, {"rmsnorm": (n + steps) * norms,
                                 "flash_attention": n * attn,
                                 "decode_attention": steps * attn})
    for i, (out, p) in enumerate(zip(res.outputs, prompts)):
        if (out.shape != (LM_BATCH, LM_PROMPT + LM_GEN)
                or out.dtype != torch.int64
                or not torch.equal(out[:, :LM_PROMPT], p)
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab):
            raise AssertionError(f"{tag} request {i}: bad output "
                                 f"{tuple(out.shape)} {out.dtype}")
    return steps


def lm_path(rows: dict, former: dict) -> dict:
    """Qwen2-0.5B served through ``DualMeshEngine`` on the two streams, its
    decode steps replayed from CUDA graphs, beside one stream and the
    eager decode.  ``former`` holds phase 2's rows of K7 decode cut to the
    filled prefix (the former path's calls)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.cost import CardModel
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.runtime import DualMeshRunner, random_prompts
    from repro_torch.dualmesh.schedule import plan_admission
    from repro_torch.kernels.util import cuda_time_ms
    from repro_torch.lm.model import init_params, params_from_numpy

    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    host = init_params(cfg, seed=0)
    params = params_from_numpy(host, DEV)
    n_params = sum(a.size for a in _leaves(host))
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab} "
          f"(padded {cfg.padded_vocab}); {n_params / 1e6:.1f} M parameters "
          f"({4 * n_params / 1e9:.2f} GB f32) from seed 0, on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    err = lm_card_vs_cpu(cfg, params, host)
    print(f"[lm] card against CPU plain versions, 16-token prompt (prefill "
          f"12, chunk 4, 3 decode steps): max |logit err| {err:.2e} (tol "
          f"{FORWARD_TOL})")

    prompts = random_prompts(cfg, LM_REQUESTS, LM_BATCH, LM_PROMPT, seed=1,
                             device=DEV)
    runners = {name: DualMeshRunner(
        cfg, params, split_streams(DEV, LM_THETA, one_stream=one),
        max_len=LM_MAX_LEN, jit_groups=jit)
        for name, one, jit in (("two", False, True), ("one", True, True),
                               ("eager", False, False))}
    runner = runners["two"]
    gens = [LM_GEN] * LM_REQUESTS
    gs = runner.planned_group_size(prompts, gens)
    gs_former = runner.planned_group_size(
        prompts, gens, CardModel(step_floor_base=FORMER_STEP_FLOOR_BASE))
    for r in runners.values():       # warm-up: a decode graph at width gs
        r.serve(prompts[:gs], gen_steps=2, group_size=gs)
    torch.cuda.synchronize()
    print(f"[lm] {runner.dual.cores.describe()}; planned group size {gs} "
          f"(step floor {CardModel().step_floor_base * 1e3:.3f} ms; the "
          f"former {FORMER_STEP_FLOOR_BASE * 1e3:.3f} ms gave {gs_former}); "
          f"decode graphs: {runner.lanes.count} lane(s) captured in "
          f"{runner.capture_s * 1e3:.1f} ms, "
          + ", ".join(f"{ln.nbytes / 2 ** 20:.1f}"
                      for v in runner.lanes.lanes.values() for ln in v)
          + " MiB a lane")

    def run(name):
        res, _, stream_ms = served_run(runners[name], prompts, gs)
        return res, stream_ms

    res, launches, stream_ms = served_run(runner, prompts, gs)
    L = cfg.n_layers
    steps = check_lm_run("lm serving", cfg, res, launches, prompts)
    if res.stats["fused_sizes"] != lm_group_sizes():
        raise AssertionError(f"lm serving formed decode groups "
                             f"{res.stats['fused_sizes']}, but phase 2 "
                             f"checked K7 decode at {lm_group_sizes()}")
    runs = {"two": (res, stream_ms)}
    for name in ("one", "eager"):
        runs[name] = run(name)
        for i, (a, b) in enumerate(zip(res.outputs, runs[name][0].outputs)):
            if not torch.equal(a, b):
                raise AssertionError(f"lm request {i}: graphs on two "
                                     f"streams and {name} generated "
                                     f"different tokens")
    walls = {name: [r.stats["wall_s"]] for name, (r, _) in runs.items()}
    per_step = {name: [] for name in ("two", "eager")}

    def step_times(trace, sms) -> tuple[float, float]:
        dec = [(h, d) for (kind, _, h), d in zip(trace, sms)
               if kind == "decode"]
        return (sum(h for h, _ in dec) * 1e3 / steps,
                sum(d for _, d in dec) / steps)

    for name in ("two", "eager"):
        per_step[name].append(step_times(runs[name][0].trace,
                                         runs[name][1]))
    for name in ("eager", "one", "two"):                # in turns
        r, sms = run(name)
        walls[name].append(r.stats["wall_s"])
        if name in per_step:
            per_step[name].append(step_times(r.trace, sms))
    s, m = res.stats, res.metrics
    print(f"[lm] {LM_REQUESTS} requests x batch {LM_BATCH}, prompt "
          f"{LM_PROMPT}, {LM_GEN} generated: {s['wall_s'] * 1e3:.2f} ms, "
          f"{s['tokens_per_s']:.1f} tokens/s ({s['total_tokens']} tokens: "
          f"{s['prefill_tokens']} prefill, {s['decode_tokens']} generated), "
          f"p50 {m.p50_ms():.2f} ms, p95 {m.p95_ms():.2f} ms; fused sizes "
          f"{s['fused_sizes']}; launches {launches} (the plan's, through "
          f"the decode graphs' replays)")
    print(f"[lm] tokens equal on graphs over two streams, one stream and "
          f"the eager decode; walls (runs 1 and 2 of each, in turns) "
          + "; ".join(f"{name} " + ", ".join(f"{w * 1e3:.2f}" for w in v)
                      + " ms" for name, v in walls.items()))
    for (kind, core, host_s), sms in zip(res.trace, stream_ms):
        print(f"[lm]   {kind:<8} on {core}  host {host_s * 1e3:9.2f} ms  "
              f"on its stream {sms:9.2f} ms")
    host_step = min(h for h, _ in per_step["two"])
    stream_step = min(d for _, d in per_step["two"])
    rows_dec = LM_BATCH * gs
    dev_step, dev_prefill = lm_device_ms(cfg, params, rows_dec)
    lane = runner.lanes.lanes[rows_dec, LM_MAX_LEN][0]
    mid = LM_PROMPT + LM_GEN // 2

    def replay_step():
        lane.pos.fill_(mid)          # every replay at the mid position
        lane.graph.replay()

    graph_step = cuda_time_ms(replay_step, reps=4)
    eager_lane = runners["eager"].lanes.lanes[rows_dec, LM_MAX_LEN][0]

    def eager_step():
        eager_lane.pos.fill_(mid)
        runners["eager"]._step(eager_lane)

    launch_ms = {"graphs": launch_host_ms(replay_step),
                 "eager": launch_host_ms(eager_step)}
    k6_step = (2 * L + 1) * rows[json.dumps(_k6(rows_dec),
                                            sort_keys=True)]["ms"]
    k7 = {name: L * sum(table[json.dumps(c, sort_keys=True)]["ms"]
                        for c in lm_decode_calls(rows_dec, whole))
          / (LM_GEN - 1)
          for name, table, whole in (("whole", rows, True),
                                     ("cut", former, False))}
    implied = {"served": 4 * host_step * 1e-3 / L,
               "launch": 4 * launch_ms["graphs"] * 1e-3 / L}
    print(f"[lm] per decode step ({rows_dec} rows): host enqueue graphs "
          + ", ".join(f"{h:.3f}" for h, _ in per_step["two"])
          + " ms, eager "
          + ", ".join(f"{h:.3f}" for h, _ in per_step["eager"])
          + " ms; on the p stream graphs "
          + ", ".join(f"{d:.3f}" for _, d in per_step["two"])
          + " ms, eager "
          + ", ".join(f"{d:.3f}" for _, d in per_step["eager"])
          + f" ms (events around each decode stage, over {steps} steps, "
          f"runs 1 and 2 in turns); device, host held out: one graph "
          f"replay {graph_step:.3f} ms, one eager step {dev_step:.3f} ms "
          f"(cache {mid}); of it K6 {k6_step:.4f} ms (49 calls) and K7 "
          f"decode {k7['whole']:.4f} ms (24 calls over the whole cache; "
          f"cut to the prefix {k7['cut']:.4f} ms, phase 2); one prefill "
          f"forward (2 x {LM_PROMPT}) {dev_prefill:.3f} ms on the device")
    print(f"[lm] host time to queue one decode step with the launch queue "
          f"free (the card held by a sleep; median of 20): graph replay "
          f"{launch_ms['graphs']:.4f} ms, eager {launch_ms['eager']:.4f} ms; "
          f"the served steps' enqueue above includes waits on a full queue")
    gs_launch = runner.planned_group_size(
        prompts, gens, CardModel(step_floor_base=implied["launch"]))
    print(f"[lm] step_floor_base implied by the served graphs' enqueue: 4 x "
          f"{host_step:.3f} ms / {L} = {implied['served']:.4e} s "
          f"(CardModel's {CardModel().step_floor_base:.4e}); by the launch "
          f"alone {implied['launch']:.4e} s, under which the planner picks "
          f"group size {gs_launch}")
    model = step_model(cfg, runner.dual, rows_dec)
    prefills = [d for (kind, _, _), d in zip(res.trace, stream_ms)
                if kind == "prefill"]
    model["prefill_measured_ms"] = sum(prefills) / len(prefills)
    model["makespan_ms"] = plan_admission(
        cfg, runner.dual, CardModel(), LM_BATCH, LM_PROMPT, LM_GEN,
        LM_REQUESTS).est_makespan * 1e3
    print(f"[lm] cost model on the split (c-core {model['c_share']:.4f} of "
          f"the card, p-core {model['p_share']:.4f}), one decode step of "
          f"{rows_dec} rows at cache {mid}: {model['latency_ms']:.3f} ms "
          f"({model['bound']}: the step floor {model['floor_ms']:.3f} ms; "
          f"f32 bytes {model['bytes_ms']:.3f} ms, compute "
          f"{model['compute_ms']:.3f} ms) against {host_step:.3f} ms of "
          f"host enqueue and {graph_step:.3f} ms on the device (a graph "
          f"replay on the p-core), measured; one prefill (2 x {LM_PROMPT}) "
          f"{model['prefill_ms']:.3f} ms ({model['prefill_bound']}) against "
          f"{model['prefill_measured_ms']:.3f} ms on the c-core's stream "
          f"(the served run's mean); the plan's makespan "
          f"{model['makespan_ms']:.1f} ms against the served wall "
          f"{s['wall_s'] * 1e3:.1f} ms")
    k6_after = sum(wgt * rows[json.dumps(c, sort_keys=True)]["after_ms"]
                   for c, wgt in lm_request_calls(s["fused_sizes"][0])
                   if c["kernel"] == "rmsnorm")
    print(f"[lm] K6 a request after its producer (each call timed behind "
          f"the residual add that writes its input, the add's own time "
          f"taken off): {k6_after:.4f} ms")
    rates = card_rates()
    print(f"[lm] card rates: f32 matmul 1024x896x4864 "
          f"{rates['matmul_tflops']:.2f} TFLOP/s "
          f"({rates['matmul_tflops'] / (PEAK_F32_FLOP_PER_S / 1e12):.3f} of "
          f"67), 1 GiB copy {rates['copy_tb_per_s']:.3f} TB/s "
          f"({rates['copy_tb_per_s'] / (PEAK_BYTES_PER_S / 1e12):.3f} of "
          f"3.35)")
    return dict(model=LM_ARCH, launches=launches,
                kernels=weighted_sums(
                    rows, lm_request_calls(s["fused_sizes"][0]),
                    lm_request_cores(s["fused_sizes"][0])),
                group_size=gs, group_size_former_floor=gs_former,
                fused_sizes=s["fused_sizes"],
                wall_s=s["wall_s"], tokens_per_s=s["tokens_per_s"],
                p50_ms=m.p50_ms(), p95_ms=m.p95_ms(), walls=walls,
                trace=[[k, c, h, d] for (k, c, h), d in zip(res.trace,
                                                             stream_ms)],
                per_step=per_step, host_ms_per_step=host_step,
                stream_ms_per_step=stream_step,
                device_ms_per_step=dev_step, graph_ms_per_step=graph_step,
                device_ms_prefill=dev_prefill,
                k6_ms_per_step=k6_step, k7_decode_ms_per_step=k7["whole"],
                k7_decode_cut_ms_per_step=k7["cut"],
                step_floor_base_implied=implied,
                step_launch_host_ms=launch_ms,
                capture_s=runner.capture_s,
                lane_bytes=[ln.nbytes for v in runner.lanes.lanes.values()
                            for ln in v],
                k6_after_producer_ms=k6_after,
                card_vs_cpu_max_abs_err=err, rates=rates,
                step_model=model,
                keep=dict(cfg=cfg, params=params, prompts=prompts,
                          runner=runner, outputs=res.outputs))


def launch_host_ms(fn, n: int = 20) -> float:
    """Median host ms of one ``fn()`` call while a sleep kernel holds the
    card, so no launch waits on a full launch queue."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)              # ~50 ms
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[n // 2]


def step_model(cfg, dual, rows: int) -> dict:
    """The card cost model's decode step of ``rows`` rows at the path's
    mid cache, on the p-core's share of the card: its latency and bound,
    and the terms under it (the bytes term apart from the step floor);
    and its prefill of one request on the c-core's share."""
    from repro_torch.dualmesh.cost import CardModel, decode_cost, prefill_cost
    kv = LM_PROMPT + LM_GEN // 2
    hw = CardModel().share(dual.p_share)
    cost = decode_cost(cfg, rows, kv, dual.p_chips, 1, hw, dual.tp_p)
    bare = decode_cost(cfg, rows, kv, dual.p_chips, 1,
                       dataclasses.replace(hw, step_floor_base=0.0),
                       dual.tp_p)
    pf = prefill_cost(cfg, LM_BATCH, LM_PROMPT, dual.c_chips,
                      CardModel().share(dual.c_share), dual.tp_c)
    return dict(latency_ms=cost.latency * 1e3, bound=cost.bound,
                floor_ms=cfg.n_layers * hw.step_floor(dual.p_chips,
                                                      dual.tp_p) / 4 * 1e3,
                bytes_ms=bare.t_memory * 1e3,
                compute_ms=cost.t_compute * 1e3,
                prefill_ms=pf.latency * 1e3, prefill_bound=pf.bound,
                c_share=dual.c_share, p_share=dual.p_share)


def granite_path() -> dict:
    """Granite-20B at its published width, cut to ``GRANITE_LAYERS``
    layers: its prefill, chunk and 3 decode steps on the card against the
    CPU's plain versions; K7 decode runs at G = 48."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.lm.model import init_params, params_from_numpy
    cfg = get_arch(GRANITE).scaled(name=f"{GRANITE}_{GRANITE_LAYERS}l",
                                   n_layers=GRANITE_LAYERS)
    t0 = time.perf_counter()
    host = init_params(cfg, seed=0)
    params = params_from_numpy(host, DEV)
    n_params = sum(a.size for a in _leaves(host))
    print(f"[granite] {GRANITE} cut to {cfg.n_layers} of 52 layers: d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads (G "
          f"{cfg.n_heads // cfg.n_kv_heads}), d_head {cfg.d_head}, vocab "
          f"{cfg.vocab}; {n_params / 1e6:.1f} M parameters "
          f"({4 * n_params / 1e9:.2f} GB f32) from seed 0, on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    err = lm_card_vs_cpu(cfg, params, host)
    launches = launch_counts()
    want = 3 * cfg.n_layers
    if launches["decode_attention"] != want:
        raise AssertionError(f"granite: K7 decode launched "
                             f"{launches['decode_attention']} times, not "
                             f"{want}")
    print(f"[granite] card against CPU plain versions, 16-token prompt "
          f"(prefill 12, chunk 4, 3 decode steps): max |logit err| "
          f"{err:.2e} (tol {FORWARD_TOL}); launches {launches}")
    return dict(model=GRANITE, layers=cfg.n_layers, params=n_params,
                card_vs_cpu_max_abs_err=err, launches=launches)


def fleet_path(served: dict) -> dict:
    """The three CNNs as one fleet on one pool of the card's two streams:
    phase 3's requests (8 a model, all at slot 0), outputs bit-equal to
    phase 3's sequential kernel forward, launches as the plans say; the
    compiled stream's signature and a fresh fleet's bitwise replay; two
    pools with a forced migration and a REBALANCE; walls in turns against
    the same requests drained one engine at a time, on compiled groups and
    eagerly."""
    from repro_torch.core.arch import DUAL_MULTI
    from repro_torch.fleet import (FleetEngine, MultiPoolRouter, Rebalance,
                                   build_cnn_fleet, compile_fleet,
                                   make_policy, plan_fleet, plan_rows,
                                   stream_signature, validate_stream)
    from repro_torch.fleet.trace import host_enqueue_ms
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine

    models = list(served)
    mix = {m: 1.0 / len(models) for m in models}
    # requests in the mix's order, model by model round-robin
    order = [(m, i) for i in range(REQUESTS) for m in models]
    want = [served[m]["io"][1][i] for m, i in order]
    per_fleet = Counter()
    for m in models:
        for k, v in served[m]["per_request"].items():
            per_fleet[k] += REQUESTS * v

    def requests():
        return [Request(served[m]["io"][0][i], model=m) for m, i in order]

    def build(pool=None, jit_groups=True):
        return build_cnn_fleet(models, pool=pool, device=DEV, seed=0,
                               scheme=SCHEME, policy=make_policy(POLICY),
                               weights=mix, burst=BURST,
                               jit_groups=jit_groups)

    def warm(fl):
        """Warm each member's graphs, as ``serve fleet`` does."""
        for mm in fl.members:
            mm.engine.runner.run_sequential(served[mm.name]["io"][0][:1])
        return fl

    def check_outputs(what: str, outs) -> None:
        if len(outs) != len(want):
            raise AssertionError(f"{what}: {len(outs)} outputs, want "
                                 f"{len(want)}")
        for j, (a, b) in enumerate(zip(outs, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: request {j} ({order[j][0]}) "
                                     f"differs from the sequential kernel "
                                     f"forward of phase 3")

    def over(fl):
        """A fresh fleet over ``fl``'s runners (warm streams, no state)."""
        return FleetEngine({mm.name: DualCoreEngine(mm.engine.runner)
                            for mm in fl.members},
                           policy=make_policy(POLICY), weights=mix,
                           burst=BURST, pool=fl.pool)

    tag = "[fleet]"
    fleet, pool = build()
    # one untimed pass first: the caching allocator keeps its blocks per
    # stream, and the pool's two streams are new
    replay(over(fleet), requests())
    compiled = compile_fleet(fleet, requests())
    validate_stream(compiled)
    reset_counts()
    res = replay(fleet, requests())
    launches = launch_counts()
    check_counts("fleet", launches, dict(per_fleet))
    check_outputs("fleet", res.outputs)
    validate_stream(fleet.stream)
    if stream_signature(compiled) != stream_signature(fleet.stream):
        raise AssertionError("fleet: the compiled stream's signature "
                             "differs from the live stream's")
    st, m = res.stats, res.metrics
    host_ms = host_enqueue_ms(fleet.stream)
    print(f"{tag} {'+'.join(models)} on one pool ({pool.cores.describe()})"
          f": {len(order)} requests x batch {BATCH} @ {IMAGE}px, policy "
          f"{POLICY}, burst {BURST}, in {st['slots']} fleet slots "
          f"({st['dispatches']} member dispatches): {st['wall_s'] * 1e3:.2f}"
          f" ms, {len(order) * BATCH / st['wall_s']:.1f} img/s; outputs "
          f"bit-equal to the sequential kernel forward; launches "
          f"{launches}")
    for name, pm in st["per_model"].items():
        print(f"{tag}   {name:<14} p50 {pm['p50_ms']:.2f} ms, p95 "
              f"{pm['p95_ms']:.2f} ms, {pm['requests_per_s'] * BATCH:.1f} "
              f"img/s")
    print(f"{tag} host enqueue {host_ms:.3f} ms a fleet slot (the RUN "
          f"instructions' host windows over {st['slots']} slots); compiled "
          f"stream signature equal to the live one ({len(compiled)} "
          f"instructions)")

    # a fresh fleet replays the compiled stream bit for bit
    fresh = warm(build()[0])
    reset_counts()
    rep = fresh.executor.replay(compiled, requests())
    check_counts("fleet replay", launch_counts(), dict(per_fleet))
    check_outputs("fleet replay", rep.outputs)
    if stream_signature(fresh.stream) != stream_signature(compiled):
        raise AssertionError("fleet replay: executed stream differs")
    print(f"{tag} a fresh fleet's replay of the compiled stream: every "
          f"output bit-equal")

    # two pools: a forced migration and a REBALANCE with work in flight
    router = MultiPoolRouter({"p0": warm(build()[0]),
                              "p1": warm(build()[0])})
    reset_counts()
    for r in requests():
        router.submit(r)
    moved = router.migrate("p1", "p0", count=4)
    router.step()
    in_flight = router.in_flight
    router.rebalance("p0", mix=mix, theta=0.7)
    two = router.drain()
    check_counts("two pools", launch_counts(), dict(per_fleet))
    if moved != 4 or router.rebalances != [("p0", 0.7)]:
        raise AssertionError(f"two pools: moved {moved}, rebalances "
                             f"{router.rebalances}")
    if [c.status for c in two.completions] != ["ok"] * len(order):
        raise AssertionError("two pools: not every request completed ok")
    check_outputs("two pools", two.outputs)
    rb = [r for r in router.stream() if isinstance(r.instr, Rebalance)]
    print(f"{tag} two pools: {moved} requests migrated p1 -> p0, "
          f"REBALANCE theta 0.7 on p0 at slot {rb[0].slot} with "
          f"{in_flight} requests in flight; {two.metrics.completed} "
          f"completed ok, outputs bit-equal, launches as the plans say")

    # walls, in turns: the fleet, then the same requests drained one
    # engine at a time on standalone runners (each its own two streams),
    # on compiled groups and eagerly
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.dualcore.runtime import DualCoreRunner
    from repro_torch.models.cnn import build_model
    fleets = {"graphs": fleet, "eager": build(jit_groups=False)[0]}
    replay(over(fleets["eager"]), requests())        # warm its streams
    alone: dict[str, dict] = {"graphs": {}, "eager": {}}
    for mname in models:
        params, _, graph = build_model(mname, seed=0, device=DEV)
        sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), SCHEME)
        for name in alone:
            r = alone[name][mname] = DualCoreRunner(
                mname, params, sched, device=DEV, theta=SPLIT_THETA,
                jit_groups=name == "graphs")
            r.run_pipelined(served[mname]["io"][0])   # warm, lanes grown

    def fleet_wall(fl) -> tuple[float, float]:
        fl = over(fl)
        t0 = time.perf_counter()
        out = replay(fl, requests())
        wall = time.perf_counter() - t0
        check_outputs("fleet (timed)", out.outputs)
        return wall, host_enqueue_ms(fl.stream)

    def one_at_a_time(runners) -> float:
        t0 = time.perf_counter()
        outs = {}
        for mname in models:
            eng = DualCoreEngine(runners[mname])
            outs[mname] = replay(eng, [Request(x) for x in
                                       served[mname]["io"][0]]).outputs
        wall = time.perf_counter() - t0
        check_outputs("one engine at a time",
                      [outs[mm][i] for mm, i in order])
        return wall

    walls = {(k, n): [] for k in ("fleet", "alone") for n in fleets}
    hosts: dict[str, list[float]] = {n: [] for n in fleets}
    for _ in range(TURNS):
        for name in fleets:
            w, h = fleet_wall(fleets[name])
            walls["fleet", name].append(w)
            hosts[name].append(h)
            walls["alone", name].append(one_at_a_time(alone[name]))
    n_img = len(order) * BATCH
    for name in fleets:
        t_fleet = min(walls["fleet", name])
        t_alone = min(walls["alone", name])
        print(f"{tag} {name}, in turns, {TURNS} each: fleet "
              + ", ".join(f"{w * 1e3:.2f}" for w in walls["fleet", name])
              + " ms; one engine at a time "
              + ", ".join(f"{w * 1e3:.2f}" for w in walls["alone", name])
              + f" ms; best {n_img / t_fleet:.1f} against "
              f"{n_img / t_alone:.1f} img/s ({t_alone / t_fleet:.3f}x); "
              f"host enqueue a fleet slot "
              + ", ".join(f"{h:.3f}" for h in hosts[name]) + " ms")
    lanes = {mm.name: mm.engine.runner.lanes.count for mm in fleet.members}
    print(f"{tag} compiled groups: lanes a member {lanes}, captured in "
          + ", ".join(f"{mm.engine.runner.capture_s * 1e3:.1f}"
                      for mm in fleet.members) + " ms")

    # the Table VII planner's rows beside the measured per-model rates
    plan = plan_fleet(mix, config=DUAL_MULTI)
    measured = {k: v["requests_per_s"] * BATCH
                for k, v in st["per_model"].items()}
    rows = plan_rows(plan, measured, n_img / st["wall_s"])
    print(f"{tag} Table VII rows, {plan.config} (theta {plan.theta:.2f}): "
          f"model-side and predicted fps on the modelled FPGA, measured "
          f"img/s of the counted fleet run on the card")
    for name, share, fps, pred, meas in rows:
        print(f"{tag}   {name:<14} share {share:.3f}  model-side "
              f"{fps:9.1f}  predicted {pred:9.1f}  measured {meas:9.1f}")
    return dict(model="fleet", per_request={}, launches=launches,
                kernels={}, per_fleet=dict(per_fleet),
                slots=st["slots"], dispatches=st["dispatches"],
                wall_s=st["wall_s"], per_model=st["per_model"],
                host_enqueue_ms=host_ms,
                walls_fleet_s=walls["fleet", "graphs"],
                walls_alone_s=walls["alone", "graphs"],
                host_enqueue_turns_ms=hosts["graphs"],
                eager=dict(walls_fleet_s=walls["fleet", "eager"],
                           walls_alone_s=walls["alone", "eager"],
                           host_enqueue_turns_ms=hosts["eager"]),
                lanes=lanes,
                two_pools=dict(moved=moved, stats={
                    k: two.stats[k] for k in ("steps", "rebalances")}),
                plan=dict(plan.summary(), rows=[list(r) for r in rows]))


# --------------------------------------------------------------------------
# phase 6: the c/p split of the card's SMs against shared SMs
# --------------------------------------------------------------------------
def probe_split(theta: float) -> dict:
    """The SM probe on each core of a split at ``theta``: eagerly on the
    core's stream, and in a graph captured on the core's capture stream and
    replayed on a plain stream.  Raises unless each core's two sets are
    equal and of its size and the two cores' sets are disjoint."""
    from repro_torch.dualcore.runtime import DualCores
    from repro_torch.kernels.green import probe_set
    from repro_torch.kernels.util import resolve_device
    dev = resolve_device(DEV)
    cores = DualCores(dev, theta)
    total = cores.split.total
    plain = torch.cuda.Stream(dev)
    sets = {}
    for core in "cp":
        eager = probe_set(dev, cores.streams[core], 2 * total)
        replayed = probe_set(dev, plain, 2 * total,
                             capture=cores.capture_stream(core))
        n = cores.sms(core)
        if len(eager) != n or replayed != eager:
            raise AssertionError(f"split at theta {theta}: the {core}-core "
                                 f"has {n} SMs; the probe ran on "
                                 f"{len(eager)} eagerly and {len(replayed)} "
                                 f"in a replay (equal sets: "
                                 f"{replayed == eager})")
        sets[core] = dict(sms=n, eager=eager, replay=replayed)
    if set(sets["c"]["eager"]) & set(sets["p"]["eager"]):
        raise AssertionError(f"split at theta {theta}: the cores share SMs")
    return dict(theta=theta, asked=cores.split.asked, realised=cores.theta,
                total=total, cores=sets)


def lane_device_ms(runner) -> float:
    """Device ms of one request's lane: its graphs replayed one after
    another on a plain stream, the host held out (each group's kernels on
    its core's SMs when split)."""
    from repro_torch.kernels.util import cuda_time_ms
    lane = next(iter(runner.lanes.lanes.values()))[0]

    def graphs():
        for g in lane.graphs:
            g.replay()

    with torch.cuda.stream(torch.cuda.Stream()):
        return cuda_time_ms(graphs, reps=10)


def split_cnn(model: str, p: dict) -> dict:
    """Phase 3's engine on split cores (its graphs runner) against the same
    model on shared ones: outputs bit-equal to phase 3's sequential kernel
    forward, pipelined and sequential walls in turns, a lane's device
    ms."""
    from repro_torch.dualcore.runtime import DualCoreRunner, DualCores
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine
    split = p["runner"]
    images, seq = p["io"]
    shared = DualCoreRunner(model, split._params, split.schedule,
                            device=split.device,
                            cores=DualCores(split.device, sm_split=False))
    shared.run_pipelined(images)                # warm: lanes grown
    runners = {"split": split, "shared": shared}
    for name, r in runners.items():
        res = replay(DualCoreEngine(r), [Request(x) for x in images])
        for i, (a, b) in enumerate(zip(res.outputs, seq)):
            if not torch.equal(a, b):
                raise AssertionError(f"split: {model} request {i} on "
                                     f"{name} SMs differs from phase 3's "
                                     f"sequential kernel forward")
    walls = {(n, mode): [] for n in runners
             for mode in ("pipelined", "sequential")}
    lane_ms = {n: [] for n in runners}
    for _ in range(SPLIT_TURNS):
        for name in ("split", "shared", "shared", "split"):   # in turns
            for mode in ("pipelined", "sequential"):
                walls[name, mode].append(runners[name].timed(images,
                                                             mode)[1])
    for name in ("split", "shared", "shared", "split"):
        lane_ms[name].append(lane_device_ms(runners[name]))
    print(f"[split] {model}: outputs on split and shared SMs bit-equal to "
          f"phase 3's sequential kernel forward; "
          + "; ".join(f"{n} pipelined "
                      + ", ".join(f"{w * 1e3:.2f}"
                                  for w in walls[n, "pipelined"])
                      + " ms, sequential "
                      + ", ".join(f"{w * 1e3:.2f}"
                                  for w in walls[n, "sequential"])
                      + " ms, a lane's device ms "
                      + ", ".join(f"{t:.4f}" for t in lane_ms[n])
                      for n in runners))
    return dict(walls={f"{n} {mode}": v for (n, mode), v in walls.items()},
                lane_device_ms=lane_ms,
                sms={c: split.cores.sms(c) for c in "cp"})


def split_fleet(served: dict) -> dict:
    """Phase 4's fleet on a split pool and on a shared one: outputs
    bit-equal, walls in turns; then a REBALANCE to 0.7 on the split pool
    with work in flight, after which every member captures new lanes in
    the new partitions."""
    from repro_torch.fleet import (DevicePool, FleetEngine, Rebalance,
                                   build_cnn_fleet, make_policy)
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine
    models = list(served)
    mix = {m: 1.0 / len(models) for m in models}
    order = [(m, i) for i in range(REQUESTS) for m in models]
    want = [served[m]["io"][1][i] for m, i in order]

    def requests():
        return [Request(served[m]["io"][0][i], model=m) for m, i in order]

    def over(fl):
        return FleetEngine({mm.name: DualCoreEngine(mm.engine.runner)
                            for mm in fl.members},
                           policy=make_policy(POLICY), weights=mix,
                           burst=BURST, pool=fl.pool)

    def check(what, outs):
        if len(outs) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(outs, want)):
            raise AssertionError(f"split: the fleet on {what} differs from "
                                 f"phase 3's sequential kernel forward")

    fleets = {}
    for name, sm_split in (("split", True), ("shared", False)):
        fl, _ = build_cnn_fleet(models, seed=0, scheme=SCHEME,
                                policy=make_policy(POLICY), weights=mix,
                                burst=BURST,
                                pool=DevicePool(DEV, sm_split=sm_split))
        for mm in fl.members:
            mm.engine.runner.run_sequential(served[mm.name]["io"][0][:1])
        check(f"{name} SMs", replay(over(fl), requests()).outputs)
        fleets[name] = fl
    walls = {n: [] for n in fleets}
    for _ in range(SPLIT_TURNS):
        for name in ("split", "shared", "shared", "split"):   # in turns
            fl = over(fleets[name])
            t0 = time.perf_counter()
            out = replay(fl, requests())
            walls[name].append(time.perf_counter() - t0)
            check(f"{name} SMs (timed)", out.outputs)
    # a REBALANCE to 0.7 with work in flight on the split pool
    pool = fleets["split"].pool
    before = {c: pool.cores.sms(c) for c in "cp"}
    runners = [mm.engine.runner for mm in fleets["split"].members]
    old_lanes = [r.lanes for r in runners]
    fl = over(fleets["split"])
    for r in requests():
        fl.submit(r)
    fl.step()
    fl.executor.inject(Rebalance(theta=0.7))
    res = fl.drain()
    check("the split pool across a REBALANCE", res.outputs)
    after = {c: pool.cores.sms(c) for c in "cp"}
    recaptured = [r.lanes.count for r in runners]
    if (after["c"] <= before["c"]
            or any(r.lanes is o for r, o in zip(runners, old_lanes))
            or not all(recaptured)
            or any(r.cores is not pool.cores for r in runners)):
        raise AssertionError(f"split: the REBALANCE left SMs {before} -> "
                             f"{after}, lanes recaptured {recaptured}")
    n_img = len(order) * BATCH
    print(f"[split] fleet ({len(order)} requests): outputs on split and "
          f"shared SMs bit-equal; "
          + "; ".join(f"{n} " + ", ".join(f"{w * 1e3:.2f}" for w in v)
                      + f" ms (best {n_img / min(v):.1f} img/s)"
                      for n, v in walls.items())
          + f"; a REBALANCE to 0.7 mid-run moved the c/p SMs {before} -> "
          f"{after} (theta {pool.cores.theta:.4f} realised), outputs "
          f"bit-equal, {sum(recaptured)} lanes recaptured in the new "
          f"partitions ({dict(zip(models, recaptured))})")
    return dict(walls=walls, rebalance=dict(before=before, after=after,
                                            recaptured=recaptured))


def split_lm(keep: dict) -> dict:
    """Phase 5's Qwen2-0.5B runner (split cores) against one on shared
    SMs: tokens equal, walls in turns, a decode step's graph replay on the
    p-core's SMs against the whole card's."""
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.runtime import DualMeshRunner
    from repro_torch.kernels.util import cuda_time_ms
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.lm import DualMeshEngine
    cfg, prompts = keep["cfg"], keep["prompts"]
    split = keep["runner"]
    gs = split.planned_group_size(prompts, [LM_GEN] * len(prompts))
    shared = DualMeshRunner(cfg, keep["params"],
                            split_streams(DEV, LM_THETA, sm_split=False),
                            max_len=LM_MAX_LEN)
    shared.serve(prompts[:gs], gen_steps=2, group_size=gs)     # warm
    runners = {"split": split, "shared": shared}
    walls = {n: [] for n in runners}
    for name in ("split", "shared", "shared", "split"):        # in turns
        res = replay(DualMeshEngine(runners[name], group_size=gs),
                     [Request(p, gen_steps=LM_GEN) for p in prompts])
        walls[name].append(res.stats["wall_s"])
        for i, (a, b) in enumerate(zip(res.outputs, keep["outputs"])):
            if not torch.equal(a, b):
                raise AssertionError(f"split: lm request {i} on {name} SMs "
                                     f"differs from phase 5's tokens")
    rows_dec = LM_BATCH * gs
    mid = LM_PROMPT + LM_GEN // 2
    step_ms = {n: [] for n in runners}
    for name in ("split", "shared", "shared", "split"):
        lane = runners[name].lanes.lanes[rows_dec, LM_MAX_LEN][0]

        def replay_step():
            lane.pos.fill_(mid)
            lane.graph.replay()

        with torch.cuda.stream(torch.cuda.Stream()):
            step_ms[name].append(cuda_time_ms(replay_step, reps=4))
    sms = {c: split.dual.cores.sms(c) for c in "cp"}
    print(f"[split] {cfg.name}: tokens on split SMs (c {sms['c']}, p "
          f"{sms['p']}) equal those on shared SMs; walls "
          + "; ".join(f"{n} " + ", ".join(f"{w * 1e3:.2f}" for w in v)
                      + " ms" for n, v in walls.items())
          + f"; a decode step of {rows_dec} rows (one graph replay, cache "
          f"{mid}, host held out): "
          + "; ".join(f"{n} " + ", ".join(f"{t:.3f}" for t in v) + " ms"
                      for n, v in step_ms.items()))
    return dict(walls=walls, step_ms=step_ms, sms=sms)


def split_path(served: dict, lm_keep: dict) -> dict:
    """Phase 6: the SM probe at the fleet planner's theta and at 0.5, then
    the CNN engines, the fleet and Qwen2-0.5B on split SMs against shared
    ones, launches counted from 0 over the phase."""
    from repro_torch.core.arch import DUAL_MULTI
    from repro_torch.fleet import plan_fleet
    t0 = time.perf_counter()
    mix = {m: 1.0 / len(served) for m in served}
    planned = plan_fleet(mix, config=DUAL_MULTI).theta
    probes = [probe_split(t) for t in (planned, 0.5)]
    for pr in probes:
        asked = {"c": pr["asked"], "p": pr["total"] - pr["asked"]}
        for core, r in pr["cores"].items():
            print(f"[split] theta {pr['theta']:.4f}: {core}-core {r['sms']} "
                  f"SMs of {pr['total']} ({asked[core]} asked), realised "
                  f"theta {pr['realised']:.4f}; the probe "
                  f"ran on the same {len(r['eager'])} SMs eagerly and in a "
                  f"graph replay: {r['eager']}")
        print(f"[split] theta {pr['theta']:.4f}: the c- and p-cores' SM "
              f"sets are disjoint, eagerly and in a replay")
    reset_counts()
    cnn = {m: split_cnn(m, p) for m, p in served.items()}
    fleet = split_fleet(served)
    lm = split_lm(lm_keep)
    launches = launch_counts()
    idle = [k for k, n in launches.items()   # the int8 kernels: 9(b) only
            if n == 0 and k not in TRAINING_ONLY + INT8_KERNELS + SE_KERNELS]
    if idle:
        raise AssertionError(f"split: {idle} never launched in the phase")
    print(f"[split] launches over the phase {launches} (not in the "
          f"kernels line, whose launches are phases 3-5's counted runs); "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(split_launches=launches, probes=probes, cnn=cnn,
                fleet=fleet, lm=lm)


# --------------------------------------------------------------------------
# phase 7: the fleet across processes
# --------------------------------------------------------------------------
def card_sharing() -> dict:
    """The card's compute mode (``nvidia-smi``) and the MPS processes
    running, by name (``/proc/*/comm``): without an MPS server the kernels
    of two processes are time-sliced on the card, not concurrent."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    mps = []
    for comm in Path("/proc").glob("[0-9]*/comm"):
        try:
            name = comm.read_text().strip()
        except OSError:                  # the process ended meanwhile
            continue
        if name.startswith("nvidia-cuda-mps"):
            mps.append(name)
    return dict(compute_mode=mode, mps=sorted(set(mps)))


def worker_launches(path: Path) -> dict[str, dict[str, int]]:
    """Each worker's launch counts from its shutdown line on stderr."""
    from repro_torch.fleet.net.worker import LAUNCHES_PREFIX
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith(LAUNCHES_PREFIX):
            doc = json.loads(line[len(LAUNCHES_PREFIX):])
            out[doc["pool"]] = doc["launches"]
    return out


def workers_path(served: dict) -> dict:
    """Phase 7: phase 4's 24 requests over ``WORKERS`` worker processes
    (each the three CNNs on compiled groups, split at theta 0.5 in its
    own CUDA context) behind a ``MultiPoolRouter`` over the socket
    transport: a clean run with a forced migration and a run that SIGKILLs
    ``pool1`` at router step 2, every output bit-equal to phase 3's and
    every request retired once, each worker's launches after its warm-up
    as the plans say for the requests it served, the killed run's streams
    replayed bitwise on fresh in-process fleets; then the walls of two
    workers, two in-process pools and one pool in turns."""
    from repro_torch.fleet import (FleetEngine, MultiPoolRouter,
                                   RecoveryConfig, build_cnn_fleet, connect,
                                   make_policy, start_workers, stop_workers,
                                   stream_signature)
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine

    tag = "[workers]"
    models = list(served)
    mix = {m: 1.0 / len(models) for m in models}
    order = [(m, i) for i in range(REQUESTS) for m in models]
    host_in = {m: [x.cpu() for x in served[m]["io"][0]] for m in models}
    want = [served[m]["io"][1][i] for m, i in order]
    want_host = [w.cpu() for w in want]
    pools = [f"pool{i}" for i in range(WORKERS)]
    wargs = ["--models", ",".join(models), "--image-size", str(IMAGE),
             "--batch", str(BATCH), "--device", DEV, "--scheme", SCHEME,
             "--policy", POLICY, "--burst", str(BURST)]
    heartbeat = RecoveryConfig().heartbeat_s
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sharing = card_sharing()
    print(f"{tag} compute mode {sharing['compute_mode']}; MPS processes "
          f"{sharing['mps'] or 'none'} (without an MPS server two "
          f"processes' kernels are time-sliced on the card)")

    def build():
        return build_cnn_fleet(models, device=DEV, seed=0, scheme=SCHEME,
                               policy=make_policy(POLICY), weights=mix,
                               burst=BURST)[0]

    def over(fl):
        """A fresh fleet over ``fl``'s runners (warm streams, no state)."""
        return FleetEngine({mm.name: DualCoreEngine(mm.engine.runner)
                            for mm in fl.members},
                           policy=make_policy(POLICY), weights=mix,
                           burst=BURST, pool=fl.pool)

    def requests(on_host: bool):
        return [Request(host_in[m][i] if on_host else served[m]["io"][0][i],
                        model=m) for m, i in order]

    def check(what: str, res, host: bool) -> None:
        outs = res.outputs
        if (any(c.status not in ("ok", "recovered")
                for c in res.completions)
                or len({c.ticket.rid for c in res.completions})
                != len(order)):
            raise AssertionError(f"{what}: not every request retired once")
        for j, (a, b) in enumerate(zip(outs, want_host if host else want)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: request {j} ({order[j][0]}) "
                                     f"differs from phase 3's sequential "
                                     f"kernel forward")

    def want_launches(served_by: dict) -> dict[str, int]:
        out = Counter()
        for m, n in served_by.items():
            for k, v in served[m]["per_request"].items():
                out[k] += n * v
        return dict(out)

    def check_launches(what: str, got: dict, served_by: dict) -> None:
        mine = {k: got.get(k, 0) for k in CNN_KERNELS}
        exp = {k: want_launches(served_by).get(k, 0) for k in CNN_KERNELS}
        if mine != exp:
            raise AssertionError(f"{what}: launches {mine} != {exp} for "
                                 f"the requests served {served_by}")

    def drive(router, kill=None, procs=None) -> tuple[object, int, float,
                                                      float]:
        """Submit every request at step 0 and step the router until
        drained (SIGKILLing ``kill = (pool, step)``); return the result,
        the router steps, the coordinator's CPU seconds and the wall
        seconds of the submissions (each one RPC carrying a request)."""
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        for r in requests(True):
            router.submit(r)
        submit_s = time.perf_counter() - t0
        steps = 0
        while router.has_work:
            if kill is not None and steps >= kill[1]:
                procs[kill[0]].kill()
                kill = None
            router.step()
            steps += 1
        return (router.result(), steps, time.process_time() - cpu0,
                submit_s)

    # the clean run, then the walls in turns, on one pair of workers
    ready: dict[str, list[float]] = {p: [] for p in pools}
    err_clean = out_dir / "workers_clean.err"
    served_by = {p: Counter() for p in pools}
    with open(err_clean, "w") as err:
        procs = start_workers({p: list(wargs) for p in pools}, stderr=err,
                              ready_timeout_s=300.0)
        for p in pools:
            ready[p].append(procs[p].ready_s)
        fleets = {}
        try:
            fleets = connect(procs, heartbeat_s=heartbeat)
            router = MultiPoolRouter(fleets)
            cpu0 = time.process_time()
            t0 = time.perf_counter()
            for r in requests(True):
                router.submit(r)
            moved = router.migrate("pool1", "pool0", count=2)
            steps = 0
            while router.has_work:
                router.step()
                steps += 1
            clean = router.result()
            wall = time.perf_counter() - t0
            cpu_step = (time.process_time() - cpu0) / steps
            check("workers", clean, host=True)
            if moved != 2:
                raise AssertionError(f"workers: moved {moved}, not 2")
            for p in pools:
                served_by[p].update(clean.stats["pools"][p]["served"])
            wire_bytes = {"coordinator": router.obs.snapshot(
                domain="wall", sources=False)["counters"]["net_bytes_total"]
                ["series"]}
            for p, ex in router.executors.items():
                snap = ex._handle.collect(ex)
                wire_bytes[p] = snap["counters"]["net_bytes_total"]["series"]
            print(f"{tag} {WORKERS} workers ({', '.join(pools)}: "
                  f"{'+'.join(models)} each, spawn to READY "
                  + ", ".join(f"{ready[p][0]:.2f}" for p in pools)
                  + f" s): {len(order)} requests, {moved} migrated pool1 -> "
                  f"pool0 before the first step, in {steps} router steps, "
                  f"{wall * 1e3:.2f} ms; every output bit-equal to phase "
                  f"3's and every request retired once; served "
                  + "; ".join(f"{p} {dict(served_by[p])}" for p in pools)
                  + f"; coordinator CPU {cpu_step * 1e3:.3f} ms a router "
                  f"step; bytes on the wire {wire_bytes}")

            # walls in turns: two workers, two in-process pools, one pool
            local = {"pools2": [build(), build()], "one": [build()]}
            for fls in local.values():          # warm: lanes, streams
                for fl in fls:
                    replay(over(fl), requests(False))
            walls = {n: [] for n in ("workers", "pools2", "one")}
            cpu_steps, submits = [], []
            for _ in range(WORKER_TURNS):
                t0 = time.perf_counter()
                res, n_steps, cpu, sub = drive(MultiPoolRouter(fleets))
                walls["workers"].append(time.perf_counter() - t0)
                cpu_steps.append(cpu / n_steps)
                submits.append(sub)
                check("workers (timed)", res, host=True)
                for p in pools:
                    served_by[p].update(res.stats["pools"][p]["served"])
                t0 = time.perf_counter()
                res = MultiPoolRouter({p: over(fl) for p, fl in zip(
                    pools, local["pools2"])})
                for r in requests(False):
                    res.submit(r)
                res = res.drain()
                walls["pools2"].append(time.perf_counter() - t0)
                check("two in-process pools (timed)", res, host=False)
                t0 = time.perf_counter()
                res = replay(over(local["one"][0]), requests(False))
                walls["one"].append(time.perf_counter() - t0)
                check("one pool (timed)", res, host=False)
        finally:
            stop_workers(fleets, procs)
    launches = worker_launches(err_clean)
    for p in pools:
        check_launches(f"worker {p}", launches.get(p, {}), served_by[p])
    n_img = len(order) * BATCH
    print(f"{tag} walls in turns, {WORKER_TURNS} each: "
          + "; ".join(f"{n} " + ", ".join(f"{w * 1e3:.2f}" for w in v)
                      + f" ms (best {n_img / min(v):.1f} img/s)"
                      for n, v in walls.items())
          + f"; of the workers' walls the {len(order)} submit RPCs "
          + ", ".join(f"{t * 1e3:.2f}" for t in submits)
          + " ms; coordinator CPU a router step (submissions included) "
          + ", ".join(f"{c * 1e3:.3f}" for c in cpu_steps) + " ms")
    print(f"{tag} launches after each worker's warm-up (its stderr line at "
          f"shutdown), as the plans say for the requests it served: "
          + "; ".join(f"{p} {[launches[p].get(k, 0) for k in CNN_KERNELS]}"
                      for p in pools) + " (K1-K5)")

    # the SIGKILL run on a fresh pair, and its streams replayed here
    err_kill = out_dir / "workers_kill.err"
    with open(err_kill, "w") as err:
        procs = start_workers({p: list(wargs) for p in pools}, stderr=err,
                              ready_timeout_s=300.0)
        for p in pools:
            ready[p].append(procs[p].ready_s)
        fleets = {}
        try:
            fleets = connect(procs, heartbeat_s=heartbeat)
            router = MultiPoolRouter(fleets)
            killed, k_steps, _, _ = drive(router, kill=WORKER_KILL,
                                          procs=procs)
            streams = router.streams()
            placements = list(router.placements)
            events = list(router.events)
        finally:
            stop_workers(fleets, procs)
    st = killed.stats
    if (st["dead"] != [WORKER_KILL[0]] or st["recovered"] < 1
            or st["failed"] or st["duplicates_dropped"]):
        raise AssertionError(f"workers: the SIGKILL run left dead "
                             f"{st['dead']}, recovered {st['recovered']}, "
                             f"failed {st['failed']}, duplicates "
                             f"{st['duplicates_dropped']}")
    check("workers after a SIGKILL", killed, host=True)
    survivor = [p for p in pools if p != WORKER_KILL[0]]
    k_launches = worker_launches(err_kill)
    for p in survivor:
        check_launches(f"worker {p} after the SIGKILL", k_launches.get(p, {}),
                       Counter(st["pools"][p]["served"]))
    fresh = MultiPoolRouter({p: build() for p in pools})
    rep = fresh.replay(streams, placements, requests(False), events)
    for p, recs in streams.items():
        if stream_signature(recs) != stream_signature(
                fresh.executors[p].records):
            raise AssertionError(f"workers: the replay of {p}'s stream "
                                 f"diverged")
    check("the SIGKILL run's replay", rep, host=False)
    print(f"{tag} SIGKILL {WORKER_KILL[0]} at router step {WORKER_KILL[1]} "
          f"(spawn to READY "
          + ", ".join(f"{ready[p][1]:.2f}" for p in pools)
          + f" s): dead {st['dead']}, {st['recovered']} recovered, "
          f"{st['failed']} failed, {st['duplicates_dropped']} duplicates, "
          f"{len(killed.completions)}/{len(order)} retired in {k_steps} "
          f"router steps, outputs bit-equal; {sum(map(len, streams.values()))}"
          f" records replay with the same signature on fresh in-process "
          f"fleets on the card, outputs bit-equal; survivor launches as the "
          f"plans say")
    return dict(ready_s=ready, moved=moved, steps=steps, wall_s=wall,
                cpu_ms_per_step=[cpu_step * 1e3] + [c * 1e3
                                                    for c in cpu_steps],
                submit_s=submits,
                wire_bytes=wire_bytes, walls=walls,
                launches=launches, served={p: dict(v)
                                           for p, v in served_by.items()},
                kill=dict(dead=st["dead"], recovered=st["recovered"],
                          steps=k_steps, launches=k_launches),
                sharing=sharing)


# --------------------------------------------------------------------------
# phase 8: the closed-loop controller
# --------------------------------------------------------------------------
def control_picks() -> list[tuple[str, int]]:
    """Phase 8's CNN traffic: ``CONTROL_REQUESTS`` requests, tagged by
    ``mix_schedule`` at ``CONTROL_MIXES[0]`` and, from request
    ``CONTROL_FLIP`` on, at ``CONTROL_MIXES[1]``; each model's requests
    take its phase-3 images in turn.  Returns (model, image index) a
    request."""
    from repro_torch.fleet import mix_schedule
    tags = (mix_schedule(CONTROL_MIXES[0], CONTROL_FLIP)
            + mix_schedule(CONTROL_MIXES[1], CONTROL_REQUESTS - CONTROL_FLIP))
    seen: Counter = Counter()
    out = []
    for t in tags:
        out.append((t, seen[t] % REQUESTS))
        seen[t] += 1
    return out


def plans_launches(served: dict, picks) -> dict[str, int]:
    """The launches the plans say ``picks``' requests make."""
    out: Counter = Counter()
    for m, _ in picks:
        out.update(served[m]["per_request"])
    return dict(out)


def control_fleet(served: dict, theta: float = SPLIT_THETA, shed=False):
    """The three CNNs as ``serve fleet`` builds them with its defaults
    (``balanced``, ``weighted_fair``, burst 4, equal weights), on a pool
    split at ``theta``, under ``ShedPolicy(clock="slot")`` with ``shed``;
    each member warmed as ``serve fleet`` warms it and the lanes the
    traffic holds captured by an uncontrolled pass of phase 8's traffic."""
    from repro_torch.fleet import (DevicePool, FleetEngine, build_cnn_fleet,
                                   make_policy)
    from repro_torch.serving.api import Request, ShedPolicy, replay
    from repro_torch.serving.cnn import DualCoreEngine
    models = list(served)
    mix = {m: 1.0 / len(models) for m in models}
    admission = ({m: ShedPolicy(clock="slot") for m in models} if shed
                 else None)
    fleet, _ = build_cnn_fleet(models, pool=DevicePool(DEV, theta=theta),
                               seed=0, scheme=SCHEME,
                               policy=make_policy(POLICY), weights=mix,
                               burst=BURST, admission=admission)
    for mm in fleet.members:
        mm.engine.runner.run_sequential(served[mm.name]["io"][0][:1])
    warm = FleetEngine({mm.name: DualCoreEngine(mm.engine.runner)
                        for mm in fleet.members}, policy=make_policy(POLICY),
                       weights=mix, burst=BURST, pool=fleet.pool)
    picks = control_picks()
    replay(warm, [Request(served[m]["io"][0][i], model=m) for m, i in picks],
           list(range(len(picks))))
    return fleet


def check_control_outputs(what: str, res, served: dict, picks,
                          shed: set[int] = frozenset()) -> None:
    """Every request retired once: the ``shed`` ones shed with no output,
    the others ok and bit-equal to their model's sequential kernel forward
    of phase 3."""
    comps = res.completions
    if (len(comps) != len(picks)
            or sorted(c.ticket.rid for c in comps) != list(range(len(picks)))):
        raise AssertionError(f"{what}: {len(comps)} completions for "
                             f"{len(picks)} requests")
    for j, (c, (m, i)) in enumerate(zip(comps, picks)):
        if j in shed:
            if c.status != "shed" or c.output is not None:
                raise AssertionError(f"{what}: request {j} should be shed, "
                                     f"is {c.status}")
        elif c.status != "ok" or not torch.equal(c.output,
                                                 served[m]["io"][1][i]):
            raise AssertionError(f"{what}: request {j} ({m}, {c.status}) "
                                 f"differs from phase 3's sequential kernel "
                                 f"forward")


def replay_check(what: str, live, fresh, rep, res) -> None:
    """A replay's stream signature and outputs against the live run's."""
    from repro_torch.fleet import stream_signature
    if stream_signature(fresh.stream) != stream_signature(live.stream):
        raise AssertionError(f"{what}: the replayed stream's signature "
                             f"differs from the live one's")
    for j, (a, b) in enumerate(zip(rep.completions, res.completions)):
        if a.status != b.status or (
                a.output is not None and not torch.equal(a.output, b.output)):
            raise AssertionError(f"{what}: request {j} differs from the "
                                 f"live run's")


def round_trip(fleet, ctl):
    """The stream and the decision log through JSON text."""
    from repro_torch.fleet import (decisions_from_json, decisions_to_json,
                                   stream_from_json, stream_to_json)
    return (stream_from_json(json.loads(json.dumps(
                stream_to_json(fleet.stream, pool="pool0")))),
            decisions_from_json(json.loads(json.dumps(
                decisions_to_json(ctl.decisions)))))


def print_decisions(tag: str, ctl) -> None:
    for d in ctl.decisions:
        print(f"{tag}   slot {d.slot} seq {d.seq} {d.action}: {d.reason}")


def decisions_doc(ctl) -> list[dict]:
    """A controller's decisions for ``chip_smoke.json``."""
    return [dict(slot=d.slot, seq=d.seq, kind=d.action.kind,
                 action=dataclasses.asdict(d.action), reason=d.reason)
            for d in ctl.decisions]


def control_reweight(served: dict) -> dict:
    """8(a): a controlled CNN fleet whose traffic flips from 4:1:1 to
    1:1:4 (mbv2:mbv1:sqz): at least one Reweight, outputs bit-equal,
    launches as the plans say; the stream and the decision log through
    JSON replayed on a fresh warmed fleet with no controller: the same
    signature, bit-equal outputs, the log verifying, the same weights."""
    from repro_torch.fleet import ControlLoop, verify_decisions
    from repro_torch.serving.api import Request, replay
    tag = "[control]"
    picks = control_picks()
    arrivals = list(range(len(picks)))

    def requests():
        return [Request(served[m]["io"][0][i], model=m) for m, i in picks]

    fleet = control_fleet(served)
    ctl = ControlLoop(fleet, interval=CONTROL_INTERVAL)
    want = plans_launches(served, picks)
    reset_counts()
    res = replay(fleet, requests(), arrivals)
    launches = launch_counts()
    check_counts("control reweight", launches, want)
    check_control_outputs("control reweight", res, served, picks)
    kinds = res.stats["control"]["by_kind"]
    if not kinds.get("reweight"):
        raise AssertionError(f"control reweight: no Reweight fired "
                             f"({kinds})")
    stream, log = round_trip(fleet, ctl)
    weights = {mm.name: mm.weight for mm in fleet.members}
    fresh = control_fleet(served)
    reset_counts()
    rep = fresh.executor.replay(stream, requests(), arrivals)
    check_counts("control reweight replay", launch_counts(), want)
    replay_check("control reweight replay", fleet, fresh, rep, res)
    verify_decisions(fresh.stream, log)
    if {mm.name: mm.weight for mm in fresh.members} != weights:
        raise AssertionError("control reweight replay: final weights "
                             "differ")
    st = res.stats
    print(f"{tag} 8(a) reweight: {len(picks)} requests one a slot, mix "
          f"4:1:1 then 1:1:4 (mbv2:mbv1:sqz) from request {CONTROL_FLIP}, "
          f"ControlLoop(interval={CONTROL_INTERVAL}): {st['slots']} fleet "
          f"slots, {st['wall_s'] * 1e3:.2f} ms; {ctl.observations} "
          f"observations, decisions {kinds}; final weights "
          + ", ".join(f"{k} {v:.4f}" for k, v in weights.items())
          + f"; outputs bit-equal, launches as the plans say {launches}")
    print_decisions(tag, ctl)
    print(f"{tag} 8(a) the stream ({len(stream)} records) and the decision "
          f"log through JSON replayed on a fresh warmed fleet with no "
          f"controller: same signature, outputs bit-equal, the log "
          f"verifies, the same final weights; {rep.stats['wall_s'] * 1e3:.2f}"
          f" ms")
    for name, pm in st["per_model"].items():
        print(f"{tag}   {name:<14} p50 {pm['p50_ms']:.2f} ms, p95 "
              f"{pm['p95_ms']:.2f} ms")
    return dict(fleet=fleet, launches=launches, slots=st["slots"],
                wall_s=st["wall_s"], replay_wall_s=rep.stats["wall_s"],
                per_model=st["per_model"], weights=weights,
                decisions=decisions_doc(ctl))


def control_rebalance(served: dict) -> dict:
    """8(b): the fleet of 8(a) under ``ShedPolicy(clock="slot")`` with
    explicit slot deadlines on a pool split at ``CONTROL_FROM_THETA``: the
    stale requests are shed, so exactly one RebalanceTheta fires, planned
    by ``plan_fleet`` at ``CONTROL_PLAN_EVALS`` inside the slot; the pool
    re-splits at its theta and every member captures new lanes there;
    every request completes or is shed once, the served bit-equal; the
    stream replays bitwise on a fresh fleet at the same start."""
    from repro_torch.fleet import ControlLoop, verify_decisions
    from repro_torch.kernels.green import split_count
    from repro_torch.serving.api import Request, replay
    tag = "[control]"
    picks = control_picks()
    arrivals = list(range(len(picks)))
    # a stale request's deadline passed a slot before it arrived
    stale = {j for j in range(CONTROL_FLIP) if j % 2}

    def requests():
        return [Request(served[m]["io"][0][i], model=m,
                        deadline=j - 1 if j in stale
                        else j + CONTROL_REQUESTS)
                for j, (m, i) in enumerate(picks)]

    fleet = control_fleet(served, CONTROL_FROM_THETA, shed=True)
    pool = fleet.pool
    ctl = ControlLoop(fleet, interval=CONTROL_INTERVAL,
                      plan_evals=CONTROL_PLAN_EVALS)
    stalls: list[tuple[int, float]] = []
    on_slot = ctl.on_slot

    def timed_on_slot(done):
        t0 = time.perf_counter()
        on_slot(done)
        stalls.append((fleet._slot, time.perf_counter() - t0))

    ctl.on_slot = timed_on_slot
    runners = [mm.engine.runner for mm in fleet.members]
    old_lanes = [r.lanes for r in runners]
    before = {c: pool.cores.sms(c) for c in "cp"}
    want = plans_launches(served, [p for j, p in enumerate(picks)
                                   if j not in stale])
    reset_counts()
    res = replay(fleet, requests(), arrivals)
    launches = launch_counts()
    check_counts("control rebalance", launches, want)
    check_control_outputs("control rebalance", res, served, picks, stale)
    rb = [d for d in ctl.decisions if d.action.kind == "rebalance"]
    if len(rb) != 1:
        raise AssertionError(f"control rebalance: {len(rb)} RebalanceTheta "
                             f"fired, want exactly 1")
    theta = rb[0].action.theta
    after = {c: pool.cores.sms(c) for c in "cp"}
    recaptured = [r.lanes.count for r in runners]
    if (pool.theta != theta
            or after["c"] != split_count(theta, before["c"] + before["p"])
            or after == before
            or any(r.lanes is o for r, o in zip(runners, old_lanes))
            or not all(recaptured)
            or any(r.cores is not pool.cores for r in runners)):
        raise AssertionError(f"control rebalance: theta {pool.theta} "
                             f"(planned {theta}), SMs {before} -> {after}, "
                             f"lanes recaptured {recaptured}")
    stall_slot, stall_s = max(stalls, key=lambda x: x[1])
    if stall_slot != rb[0].slot:
        raise AssertionError(f"control rebalance: the longest decision was "
                             f"at slot {stall_slot}, the REBALANCE at "
                             f"{rb[0].slot}")
    others = sorted(s for slot, s in stalls if slot != stall_slot)
    stream, log = round_trip(fleet, ctl)
    fresh = control_fleet(served, CONTROL_FROM_THETA, shed=True)
    reset_counts()
    rep = fresh.executor.replay(stream, requests(), arrivals)
    check_counts("control rebalance replay", launch_counts(), want)
    replay_check("control rebalance replay", fleet, fresh, rep, res)
    verify_decisions(fresh.stream, log)
    if {c: fresh.pool.cores.sms(c) for c in "cp"} != after:
        raise AssertionError("control rebalance replay: the pool's SMs "
                             "differ from the live run's")
    st = res.stats
    print(f"{tag} 8(b) rebalance: the same traffic under "
          f"ShedPolicy(clock='slot'), {len(stale)} requests stale on "
          f"arrival, on a pool split at theta {CONTROL_FROM_THETA} (c "
          f"{before['c']} SMs, p {before['p']}), ControlLoop(interval="
          f"{CONTROL_INTERVAL}, plan_evals={CONTROL_PLAN_EVALS}): "
          f"{st['slots']} fleet slots, {st['wall_s'] * 1e3:.2f} ms; decisions"
          f" {st['control']['by_kind']}; one RebalanceTheta at slot "
          f"{rb[0].slot} to theta {theta} (c {after['c']} SMs, p "
          f"{after['p']}; realised {pool.cores.theta:.4f}), decided in "
          f"{stall_s:.3f} s of host (the planner's stall, inside the slot; "
          f"the other observations {others[0] * 1e3:.3f}-"
          f"{others[-1] * 1e3:.3f} ms); {sum(recaptured)} lanes captured in "
          f"the new partitions ({recaptured}); {len(stale)} shed, "
          f"{len(picks) - len(stale)} served bit-equal, each once; launches "
          f"as the plans say {launches}")
    print_decisions(tag, ctl)
    print(f"{tag} 8(b) replayed on a fresh fleet at theta "
          f"{CONTROL_FROM_THETA} with no controller: same signature, the "
          f"same sheds, outputs bit-equal, the log verifies, the pool at "
          f"{after}; {rep.stats['wall_s'] * 1e3:.2f} ms (no planner)")
    return dict(launches=launches, slots=st["slots"], wall_s=st["wall_s"],
                replay_wall_s=rep.stats["wall_s"], theta=theta,
                sms_before=before, sms_after=after,
                realised=pool.cores.theta, decision_s=stall_s,
                other_decisions_s=others, recaptured=recaptured,
                shed=len(stale),
                decisions=decisions_doc(ctl))


def capture_decode_lanes(runner, rows, per_key: int) -> None:
    """Capture ``per_key`` decode lanes of each width in ``rows`` on the
    runner's p-core before a timed run, so a retune reaches only lanes
    already captured (a capture can wait for the card)."""
    with torch.cuda.stream(runner.dual.stream("p")):
        held = [runner.lanes.acquire((r, runner.max_len))
                for r in rows for _ in range(per_key)]
    for lane in held:
        runner.lanes.retire(lane, None)
    runner.dual.cores.synchronize()


def control_mixed(served: dict, lm_keep: dict, cnn_fleet) -> dict:
    """8(c): Qwen2-0.5B as a ``DualMeshEngine`` member (its own
    ``split_streams`` at theta 0.5, a finite quantum, group size 4) beside
    the three CNNs of 8(a)'s runners, no pool (the LM member keeps its own
    cores, so no REBALANCE), under a controller whose SLO lies below every
    LM request's latency: Retune halves the width; tokens equal phase 5's
    for the same prompts, CNN outputs bit-equal, launches as the plans
    say, no lane captured during the run; the recorded stream replayed
    bitwise on a fresh uncontrolled fleet."""
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.runtime import DualMeshRunner
    from repro_torch.fleet import (ControlLoop, FleetEngine, make_policy,
                                   verify_decisions)
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine
    from repro_torch.serving.lm import DualMeshEngine
    tag = "[control]"
    cfg, params = lm_keep["cfg"], lm_keep["params"]
    prompts = lm_keep["prompts"][:MIXED_LM_REQUESTS]
    want_lm = lm_keep["outputs"][:MIXED_LM_REQUESTS]
    runner = DualMeshRunner(cfg, params, split_streams(DEV, LM_THETA),
                            max_len=LM_MAX_LEN)
    # every width the controller can reach (the configured one and its
    # halvings) and every eviction remainder, two lanes each
    capture_decode_lanes(runner, [LM_BATCH * w
                                  for w in range(1, MIXED_GROUP + 1)], 2)
    captures = runner.lanes.count
    models = list(served)
    cnn = {mm.name: mm.engine.runner for mm in cnn_fleet.members}
    weights = {**{m: 1.0 for m in models}, "lm": 1.0}
    order = [(m, i) for i in range(REQUESTS) for m in models]
    # in arrival order (CNN request j at slot j, before an LM request of
    # the same slot), so the fleet's rids follow the list
    traffic = sorted([(j, ("cnn", j)) for j in range(len(order))]
                     + [(a, ("lm", k))
                        for k, a in enumerate(MIXED_LM_ARRIVALS)],
                     key=lambda t: t[0])
    arrivals = [a for a, _ in traffic]
    reqs = [r for _, r in traffic]

    def requests():
        return [Request(served[order[j][0]]["io"][0][order[j][1]],
                        model=order[j][0]) if kind == "cnn"
                else Request(prompts[j], gen_steps=LM_GEN, model="lm")
                for kind, j in reqs]

    def build():
        members = {m: DualCoreEngine(cnn[m]) for m in models}
        members["lm"] = DualMeshEngine(runner, group_size=MIXED_GROUP,
                                       quantum=MIXED_QUANTUM)
        return FleetEngine(members, policy=make_policy(POLICY),
                           weights=weights, burst=BURST)

    fleet = build()
    ctl = ControlLoop(fleet, interval=MIXED_INTERVAL, slo_ms=MIXED_SLO_MS)
    reset_counts()
    res = replay(fleet, requests(), arrivals)
    launches = launch_counts()
    lm = fleet._by_name["lm"].engine
    lm_st = lm.result().stats
    L = cfg.n_layers
    steps = (LM_GEN - 1) * len(lm.fused_sizes)
    want = plans_launches(served, order)
    want.update({"rmsnorm": (MIXED_LM_REQUESTS + steps) * (2 * L + 1),
                 "flash_attention": MIXED_LM_REQUESTS * L,
                 "decode_attention": steps * L})
    check_counts("control mixed", launches, want)
    if runner.lanes.count != captures:
        raise AssertionError(f"control mixed: {runner.lanes.count - captures}"
                             f" decode lanes captured during the run")
    outs = res.outputs
    for j, (kind, k) in enumerate(reqs):
        c = res.completions[j]
        if c.status != "ok":
            raise AssertionError(f"control mixed: request {j} {c.status}")
        ok = (torch.equal(outs[j], want_lm[k]) if kind == "lm" else
              torch.equal(outs[j], served[order[k][0]]["io"][1][order[k][1]]))
        if not ok:
            raise AssertionError(f"control mixed: request {j} ({kind}) "
                                 f"differs from phase {5 if kind == 'lm' else 3}"
                                 f"'s output")
    retunes = [d.action.value for d in ctl.decisions
               if d.action.kind == "retune"]
    lm_p95 = res.stats["per_model"]["lm"]["p95_ms"]
    if not retunes or retunes[0] != MIXED_GROUP // 2 or lm_p95 <= MIXED_SLO_MS:
        raise AssertionError(f"control mixed: retunes {retunes}, LM p95 "
                             f"{lm_p95:.1f} ms against the SLO "
                             f"{MIXED_SLO_MS} ms")
    stream, log = round_trip(fleet, ctl)
    fresh = build()
    reset_counts()
    rep = fresh.executor.replay(stream, requests(), arrivals)
    check_counts("control mixed replay", launch_counts(), want)
    replay_check("control mixed replay", fleet, fresh, rep, res)
    verify_decisions(fresh.stream, log)
    st = res.stats
    print(f"{tag} 8(c) mixed: {cfg.name} (a DualMeshEngine on "
          f"{runner.dual.cores.describe()}, group size {MIXED_GROUP}, "
          f"quantum {MIXED_QUANTUM}, {MIXED_LM_REQUESTS} requests x batch "
          f"{LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} generated, arriving at "
          f"slots {list(MIXED_LM_ARRIVALS)}) beside {len(order)} CNN "
          f"requests one a slot, ControlLoop(interval={MIXED_INTERVAL}, "
          f"slo_ms={MIXED_SLO_MS}): {st['slots']} fleet slots, "
          f"{st['wall_s'] * 1e3:.2f} ms; decisions "
          f"{st['control']['by_kind']}, group size {MIXED_GROUP} -> "
          + " -> ".join(str(v) for v in retunes)
          + f"; fused sizes {lm.fused_sizes}; LM {lm_st['tokens_per_s']:.1f}"
          f" tokens/s; tokens equal phase 5's, CNN outputs bit-equal, "
          f"launches as the plans say {launches}; {captures} decode lanes "
          f"captured before the run, none during it")
    print_decisions(tag, ctl)
    for name, pm in st["per_model"].items():
        print(f"{tag}   {name:<14} p50 {pm['p50_ms']:.2f} ms, p95 "
              f"{pm['p95_ms']:.2f} ms, {pm['requests_per_s']:.2f} requests/s")
    print(f"{tag} 8(c) the recorded stream ({len(stream)} records) replayed "
          f"on a fresh uncontrolled fleet: same signature, tokens and "
          f"outputs bit-equal, the log verifies; "
          f"{rep.stats['wall_s'] * 1e3:.2f} ms")
    return dict(launches=launches, slots=st["slots"], wall_s=st["wall_s"],
                replay_wall_s=rep.stats["wall_s"],
                per_model=st["per_model"], retunes=retunes,
                fused_sizes=lm.fused_sizes,
                lm_tokens_per_s=lm_st["tokens_per_s"], captures=captures,
                decisions=decisions_doc(ctl))


def control_path(served: dict, lm_keep: dict) -> dict:
    """Phase 8: 8(a) Reweight, 8(b) RebalanceTheta, 8(c) the mixed fleet's
    Retune, each run's launches counted from 0 and kept apart from the
    kernels line's."""
    t0 = time.perf_counter()
    a = control_reweight(served)
    b = control_rebalance(served)
    c = control_mixed(served, lm_keep, a.pop("fleet"))
    print(f"[control] launches of the three controlled runs (not in the "
          f"kernels line): 8(a) {a['launches']}; 8(b) {b['launches']}; 8(c) "
          f"{c['launches']}; {time.perf_counter() - t0:.1f} s")
    return dict(reweight=a, rebalance=b, mixed=c)


# --------------------------------------------------------------------------
# phase 9: the design flow, Qwen2.5-14B at full depth, the MoE family
# --------------------------------------------------------------------------
def free_card(what: str) -> None:
    """Drop what nothing refers to, hand the allocator's free blocks back
    and print the card's memory still allocated and reserved."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[design] {what}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def design_search(cfg, n_requests: int) -> tuple:
    """``search`` on the card's SMs for ``n_requests`` x batch 2, 512 +
    64: the visited thetas and their SMs, the chosen theta, its planned
    makespan; no green context made while it runs."""
    from repro_torch.dualmesh.partition import card_split
    from repro_torch.dualmesh.schedule import request_stages
    from repro_torch.dualmesh.search import card_memory, card_model, search
    from repro_torch.kernels import green
    hw = card_model(DEV)
    stages = request_stages(cfg, [(LM_BATCH, LM_PROMPT, LM_GEN)])
    before = len(green._SPLITS)
    t0 = time.perf_counter()
    res = search(stages, cfg, hw=hw, max_evals=DESIGN_EVALS,
                 n_streams=n_requests)
    host_s = time.perf_counter() - t0
    if len(green._SPLITS) != before:
        raise AssertionError(f"the search made {len(green._SPLITS) - before}"
                             f" green context(s)")
    mem = card_memory(stages, cfg, hw)
    visits = [(t, card_split(t, res.sms).c_sms) for t in res.visited]
    print(f"[design] {cfg.name}: search on the card's {res.sms} SMs, "
          f"{n_requests} x batch {LM_BATCH}, {LM_PROMPT} + {LM_GEN}, "
          f"{DESIGN_EVALS} evaluations at most, {host_s * 1e3:.1f} ms of "
          f"host, no green context made: visited "
          + ", ".join(f"{t:.4f} (c {c})" for t, c in visits)
          + f"; chose theta {res.theta:.4f} (c {res.dual.c_sms} SMs, p "
          f"{res.dual.p_sms}), planned makespan {res.makespan * 1e3:.1f} "
          f"ms, {res.tokens_per_s:.0f} tokens/s; memory check: weights "
          f"{mem['weights'] / 1e9:.2f} GB + both cores' KV "
          f"{mem['kv'] / 1e9:.3f} GB against 0.75 x "
          f"{hw.mem_bytes / 1e9:.2f} GB, margin {mem['margin'] / 1e9:.3f} "
          f"GB{' (nothing fits: relaxed)' if res.relaxed else ''}")
    return res, dict(visited=[list(v) for v in visits], theta=res.theta,
                     c_sms=res.dual.c_sms, p_sms=res.dual.p_sms,
                     makespan_ms=res.makespan * 1e3,
                     tokens_per_s=res.tokens_per_s, host_s=host_s,
                     relaxed=res.relaxed, memory=mem,
                     mem_bytes=hw.mem_bytes)


def warm_runner(runner, cfg, n: int, gs: int) -> None:
    """Warm ``runner`` for ``n`` requests fused ``gs`` a group: one short
    prefill through the engine, then a captured decode lane of every
    width the groups take, so the timed run captures nothing."""
    from repro_torch.dualmesh.runtime import random_prompts
    warm = random_prompts(cfg, 1, LM_BATCH, WARM_PROMPT, seed=3, device=DEV)
    runner.serve(warm, gen_steps=2, group_size=1)
    widths = sorted({LM_BATCH * min(gs, n - i) for i in range(0, n, gs)})
    capture_decode_lanes(runner, widths, 1)


def design_walls(cfg) -> dict:
    """9(a): the search on the card's SMs for the LM path's traffic, then
    Qwen2-0.5B served at the searched theta and at 0.5 in turns."""
    from repro_torch.dualmesh.cost import CardModel
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.runtime import DualMeshRunner, random_prompts
    from repro_torch.dualmesh.schedule import plan_admission
    from repro_torch.lm.model import load_params
    res, doc = design_search(cfg, LM_REQUESTS)
    params = load_params(cfg, 0, DEV)
    prompts = random_prompts(cfg, LM_REQUESTS, LM_BATCH, LM_PROMPT, seed=1,
                             device=DEV)
    gens = [LM_GEN] * LM_REQUESTS
    runs = {}
    for name, theta in (("the searched theta", res.theta),
                        ("theta 0.5", SPLIT_THETA)):
        r = DualMeshRunner(cfg, params, split_streams(DEV, theta),
                           max_len=LM_MAX_LEN)
        gs = r.planned_group_size(prompts, gens)
        plan = plan_admission(cfg, r.dual, CardModel(), LM_BATCH, LM_PROMPT,
                              LM_GEN, LM_REQUESTS)
        warm_runner(r, cfg, LM_REQUESTS, gs)
        runs[name] = dict(runner=r, gs=gs, walls=[], tokens_per_s=[],
                          theta=r.dual.theta,
                          makespan_ms=plan.est_makespan * 1e3,
                          sms=(r.dual.cores.sms("c"), r.dual.cores.sms("p")))
    tokens = None
    for _ in range(DESIGN_TURNS):
        for name, run in runs.items():
            out, launches, _ = served_run(run["runner"], prompts, run["gs"])
            check_lm_run(f"design {name}", cfg, out, launches, prompts)
            run["walls"].append(out.stats["wall_s"])
            run["tokens_per_s"].append(out.stats["tokens_per_s"])
            if tokens is None:
                tokens = out.outputs
            elif not all(torch.equal(a, b)
                         for a, b in zip(tokens, out.outputs)):
                raise AssertionError(f"design: {name} generated other "
                                     f"tokens")
    for name, run in runs.items():
        print(f"[design] {cfg.name} at {name} ({run['theta']:.4f} "
              f"realised: c {run['sms'][0]} SMs, p {run['sms'][1]}; group "
              f"size {run['gs']}): walls "
              + ", ".join(f"{w * 1e3:.2f}" for w in run["walls"])
              + f" ms (in turns), {max(run['tokens_per_s']):.1f} tokens/s "
              f"at best; the plan's makespan {run['makespan_ms']:.1f} ms")
        del run["runner"]
    print("[design] tokens equal at both thetas; the walls are reported, "
          "no ranking is claimed")
    return dict(search=doc, runs=runs)


def events_ms(fn, reps: int = 2) -> float:
    """Device ms of one ``fn()`` call: CUDA events around single calls, the
    least of ``reps`` after one untimed call.  For calls of more launches
    than the launch queue holds (a 48-layer forward), where
    ``cuda_time_ms`` cannot keep the host ahead under a sleep; the host's
    enqueue then stays inside the window wherever it is the slower."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def served_model(cfg, params, theta: float, n: int, tag: str) -> dict:
    """``cfg`` served at full depth through ``DualMeshEngine`` on the split
    at ``theta``: ``n`` x batch 2, 512 + 64; launches as the plan says;
    tokens on two streams equal to one stream's; tokens/s, p50/p95, the
    stages' stream ms, a decode step's graph replayed on the p-core with
    the host held out, a prefill forward on the whole card, and the cost
    model's beside them."""
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.runtime import DualMeshRunner, random_prompts
    from repro_torch.kernels.util import cuda_time_ms
    from repro_torch.lm.model import decode_step, init_cache
    prompts = random_prompts(cfg, n, LM_BATCH, LM_PROMPT, seed=1,
                             device=DEV)
    gens = [LM_GEN] * n
    mid = LM_PROMPT + LM_GEN // 2
    outs, walls, peak = {}, {}, {}
    gs = None
    for name, one in (("two", False), ("one", True)):
        r = DualMeshRunner(cfg, params,
                           split_streams(DEV, theta, one_stream=one),
                           max_len=LM_MAX_LEN)
        # the split's plan; one stream fuses the same groups
        gs = gs or r.planned_group_size(prompts, gens)
        torch.cuda.reset_peak_memory_stats()
        warm_runner(r, cfg, n, gs)
        mem = torch.cuda.memory_allocated()
        res, launches, sms = served_run(r, prompts, gs)
        peak[name] = torch.cuda.max_memory_allocated()
        run_steps = check_lm_run(f"{tag} {name}", cfg, res, launches,
                                 prompts)
        outs[name] = res.outputs
        walls[name] = res.stats["wall_s"]
        for (kind, core, host_s), d in zip(res.trace, sms):
            print(f"[design]   {tag} {name}: {kind:<8} on {core}  host "
                  f"{host_s * 1e3:9.2f} ms  on its stream {d:9.2f} ms")
        if name == "two":
            main, main_launches, stream_ms, dual = res, launches, sms, r.dual
            steps, lanes = run_steps, r.lanes.count
            rows_dec = LM_BATCH * res.stats["fused_sizes"][0]
            graph_ms = {}
            for rows in sorted({LM_BATCH * g
                                for g in res.stats["fused_sizes"]}):
                lane = r.lanes.lanes[rows, LM_MAX_LEN][0]

                def replay_step():
                    lane.pos.fill_(mid)      # every replay at mid position
                    lane.graph.replay()

                graph_ms[rows] = cuda_time_ms(replay_step, reps=4)
            graph_step = graph_ms[rows_dec]
            del lane
        r.dual.cores.synchronize()
        del r
        gc.collect()
    for i, (a, b) in enumerate(zip(outs["two"], outs["one"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} request {i}: two streams and one "
                                 f"generated different tokens")
    del outs
    s, m = main.stats, main.metrics
    prefill_ms = [d for (kind, _, _), d in zip(main.trace, stream_ms)
                  if kind == "prefill"]
    decode_ms = sum(d for (kind, _, _), d in zip(main.trace, stream_ms)
                    if kind == "decode") / steps
    free_card(f"{tag} served")
    ptok = torch.zeros((LM_BATCH, LM_PROMPT), dtype=torch.int64, device=DEV)
    pcache = init_cache(cfg, LM_BATCH, LM_MAX_LEN, DEV)
    dev_prefill = events_ms(lambda: decode_step(params, cfg, ptok, pcache,
                                                last_only=True))
    del pcache
    model = step_model(cfg, dual, rows_dec)
    print(f"[design] {cfg.name}: {n} requests x batch {LM_BATCH}, prompt "
          f"{LM_PROMPT}, {LM_GEN} generated, on c {dual.cores.sms('c')} "
          f"SMs and p {dual.cores.sms('p')} (theta {dual.theta:.4f}): "
          f"{s['wall_s'] * 1e3:.1f} ms, {s['tokens_per_s']:.1f} tokens/s "
          f"({s['total_tokens']} tokens), p50 {m.p50_ms():.1f} ms, p95 "
          f"{m.p95_ms():.1f} ms; fused sizes {s['fused_sizes']}; one "
          f"stream {walls['one'] * 1e3:.1f} ms, the same tokens; launches "
          f"{main_launches} (a forward step K6 {2 * cfg.n_layers + 1}, K7 "
          f"{cfg.n_layers}: the plan's); {lanes} decode lane(s), "
          f"{mem / 1e9:.2f} GB allocated before the run, at most "
          f"{peak['two'] / 1e9:.2f} GB in it (one stream "
          f"{peak['one'] / 1e9:.2f})")
    print(f"[design] {cfg.name}: a prefill (2 x {LM_PROMPT}) "
          f"{sum(prefill_ms) / len(prefill_ms):.1f} ms on the c-core's "
          f"stream (the run's mean), {dev_prefill:.1f} ms on the whole "
          f"card (events around one call), modelled "
          f"{model['prefill_ms']:.1f} ms ({model['prefill_bound']}); a "
          f"decode step of {rows_dec} rows at cache {mid} {decode_ms:.2f} "
          f"ms on the p-core's stream (the run's mean), one graph replay on "
          f"the p-core with the host held out "
          + ", ".join(f"{v:.2f} ms at {k} rows" for k, v in graph_ms.items())
          + f", modelled "
          f"{model['latency_ms']:.2f} ms ({model['bound']}; f32 bytes "
          f"{model['bytes_ms']:.2f} ms, compute {model['compute_ms']:.2f} "
          f"ms, step floor {model['floor_ms']:.2f} ms)")
    return dict(model=cfg.name, theta=dual.theta,
                sms=[dual.cores.sms("c"), dual.cores.sms("p")],
                launches=main_launches, fused_sizes=s["fused_sizes"],
                wall_s=s["wall_s"], one_stream_wall_s=walls["one"],
                tokens_per_s=s["tokens_per_s"], p50_ms=m.p50_ms(),
                p95_ms=m.p95_ms(), prefill_stream_ms=prefill_ms,
                decode_stream_ms_per_step=decode_ms,
                device_ms_prefill=dev_prefill, graph_ms_per_step=graph_step,
                graph_ms_by_rows=graph_ms,
                step_model=model, allocated_before_run=mem,
                peak_allocated=peak, rows=rows_dec,
                group_size=main.stats["fused_sizes"][0])


def path_kernels(cfg, rows_dec: int, gen) -> dict:
    """K6 and K7 at the served path's shapes of ``cfg`` (decode at the mid
    of the served cache lengths), each held against its plain version and
    timed, summed over one request: its prefill forward and its share of
    its group's 63 decode steps."""
    L, d = cfg.n_layers, cfg.d_model
    size = rows_dec // LM_BATCH
    mid = LM_PROMPT + LM_GEN // 2
    geo = dict(d=cfg.d_head, hq=cfg.n_heads, hkv=cfg.n_kv_heads)
    steps = LM_GEN - 1
    calls = [(_k6(LM_BATCH * LM_PROMPT, d), 2 * L), (_k6(LM_BATCH, d), 1),
             (_flash(LM_BATCH, LM_PROMPT, LM_PROMPT, LM_MAX_LEN, **geo), L),
             (_k6(rows_dec, d), (2 * L + 1) * steps / size),
             (_decode(rows_dec, LM_MAX_LEN, LM_MAX_LEN,
                      kv_len=[mid] * rows_dec, **geo), L * steps / size)]
    rows = {json.dumps(c, sort_keys=True): check_and_time(c, gen, True)
            for c, _ in calls}
    out = weighted_sums(rows, calls)
    for name, v in out.items():
        b_ms, b_by = bound_ms(v["bytes"], v["flops"], v["tc_flops"])
        v.update(bound_ms=b_ms, bound_by=b_by)
        print(f"[design] {cfg.name}: {name} calls a request {v['calls']:g},"
              f" ms {v['ms']:.4f}, bound {b_ms:.5f} ({b_by}), plain "
              f"{v['plain_ms']:.4f}, library {v['library_ms']:.4f}, err "
              f"{v['max_abs_err']:.1e} (decode at cache {mid})")
    return out


def full_depth(name: str, n: int, gen, int8_rows: dict | None = None
               ) -> dict:
    """9(b)/(c): ``name`` at full depth: the search on the card's SMs and
    its memory check, the weights drawn straight to the card, served at
    the searched theta, and K6 and K7 at its path's shapes; given phase
    2's ``int8_rows``, also the generate over an f32 and an int8 cache
    (``int8_generate``, under ``"int8"``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.lm.model import load_params
    cfg = get_arch(name)
    free_card(f"before {name}")
    res, doc = design_search(cfg, n)
    t0 = time.perf_counter()
    params = load_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    print(f"[design] {name}: {cfg.param_count() / 1e9:.3f} B parameters "
          f"({4 * cfg.param_count() / 1e9:.2f} GB f32) drawn from seed 0 "
          f"straight to the card in {draw_s:.1f} s of host; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    served = served_model(cfg, params, res.theta, n, name)
    mem, peak = doc["memory"], max(served["peak_allocated"].values())
    print(f"[design] {name}: the search's memory check counts "
          f"{(mem['weights'] + mem['kv']) / 1e9:.2f} GB against its limit "
          f"{mem['limit'] / 1e9:.2f} GB; the run peaked at {peak / 1e9:.2f} "
          f"GB allocated, {(peak - mem['limit']) / 1e9:+.2f} GB beside that "
          f"limit (the check leaves out the requests in flight, the decode "
          f"lanes and the prefill logits)")
    kernels = path_kernels(cfg, served["rows"], gen)
    out = dict(search=doc, draw_s=draw_s, served=served, kernels=kernels,
               peak_over_check_limit=peak - mem["limit"])
    if int8_rows is not None:
        free_card(f"{name}: before the int8 generate")
        out["int8"] = int8_generate(cfg, params, int8_rows)
    del params
    free_card(f"after {name}")
    return out


def moe_card_vs_cpu(name: str) -> dict:
    """9(c): ``name`` at full width cut to ``MOE_LAYERS`` layers: the
    16-token prompt's prefill, chunk and 3 decode steps (the dense branch)
    and one 2 x 512 prefill (the scatter branch) on the card against the
    CPU's plain versions."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.runtime import random_prompts
    from repro_torch.lm.model import (decode_step, init_cache, init_params,
                                      params_from_numpy)
    full = get_arch(name)
    cfg = full.scaled(name=f"{name}_{MOE_LAYERS}l", n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    host = init_params(cfg, seed=0)
    params = params_from_numpy(host, DEV)
    draw_s = time.perf_counter() - t0
    reset_counts()
    err = lm_card_vs_cpu(cfg, params, host)
    launches = launch_counts()
    if launches["decode_attention"] != 3 * cfg.n_layers:
        raise AssertionError(f"{name}: K7 decode launched "
                             f"{launches['decode_attention']} times, not "
                             f"{3 * cfg.n_layers}")
    tokens = random_prompts(cfg, 1, LM_BATCH, LM_PROMPT, seed=4)[0]
    if LM_BATCH * LM_PROMPT <= cfg.moe_dense_threshold:
        raise AssertionError("the long prefill would not scatter")
    cpu = params_from_numpy(host, "cpu")
    want, _ = decode_step(cpu, cfg, tokens,
                          init_cache(cfg, LM_BATCH, LM_PROMPT, "cpu"),
                          last_only=True)
    got, _ = decode_step(params, cfg, tokens.to(DEV),
                         init_cache(cfg, LM_BATCH, LM_PROMPT, DEV),
                         last_only=True)
    got = got.cpu()
    scatter_err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=FORWARD_TOL, atol=FORWARD_TOL):
        raise AssertionError(f"{name}: the scatter prefill's logits differ "
                             f"by {scatter_err:.3e}")
    print(f"[design] {name} cut to {cfg.n_layers} of {full.n_layers} "
          f"layers: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"(G {cfg.n_heads // cfg.n_kv_heads}, D {cfg.d_head}), "
          f"{cfg.moe_experts} experts top {cfg.moe_top_k} + "
          f"{cfg.moe_shared} shared; {cfg.param_count() / 1e9:.3f} B "
          f"parameters from seed 0 in {draw_s:.1f} s; card against CPU "
          f"plain versions: 16-token prompt (dense branch) max |logit err| "
          f"{err:.2e}, one {LM_BATCH} x {LM_PROMPT} prefill (the scatter "
          f"branch, t {LM_BATCH * LM_PROMPT} > "
          f"{cfg.moe_dense_threshold}) {scatter_err:.2e} (tol "
          f"{FORWARD_TOL}); launches {launches}")
    return dict(model=name, layers=cfg.n_layers, draw_s=draw_s,
                card_vs_cpu_max_abs_err=err, scatter_max_abs_err=scatter_err,
                launches=launches)


def design_path(int8_rows: dict) -> dict:
    """Phase 9: (a) the design flow on the card's SMs for the LM path;
    (b) Qwen2.5-14B at full depth, and its generate over an int8 cache;
    (c) Qwen-MoE at full depth and both MoE configs at 2 layers of full
    width against the CPU.  Launches are counted per run and printed apart
    from the kernels line, but the int8 generate's, whose path (``big``'s
    ``"int8"``) the kernels line reads."""
    from repro_torch.configs.registry import get_arch
    t0 = time.perf_counter()
    free_card("before phase 9 (green contexts stay)")
    gen = np.random.default_rng(9)
    a = design_walls(get_arch(LM_ARCH))
    b = full_depth(BIG_ARCH, BIG_REQUESTS, gen, int8_rows)
    c = dict(served=full_depth(MOE_ARCH, LM_REQUESTS, gen),
             cut=[moe_card_vs_cpu(name) for name in MOE_ARCHS])
    print(f"[design] {time.perf_counter() - t0:.1f} s")
    return dict(search=a, big=b, moe=c)


# --------------------------------------------------------------------------
# the int8 KV cache: its kernels (phase 2) and the 14B's generate (9(b))
# --------------------------------------------------------------------------
INT8_KERNELS = ("flash_attention_int8", "decode_attention_int8")
INT8_MAX_LEN = LM_PROMPT + LM_GEN       # the generate's cache: 512 + 64
INT8_TOL = 1e-5
INT8_FLIP_SHARE = 1e-3                  # rows a rounding tie may flip
INT8_TIE = 1e-4                         # of max(1, p * 127): a tie
INT8_SCALE = 127 * 32                   # P_SCALE * KV_SCALE
# the int8 tensor cores' dense peak (H100 SXM data sheet): the bound of
# the int8 kernels' operations
PEAK_INT8_OPS_PER_S = 1979e12
MEM_TOL = 0.10                          # the dry run's peak against the card


def _i8(kernel: str, b: int, hq: int, hkv: int, d: int, sk: int, cap: int,
        sq: int = 1, q_offset: int = 0, sk_valid=None, causal=True,
        kv_len=None) -> dict:
    return dict(kernel=kernel, b=b, hq=hq, hkv=hkv, d=d, sq=sq, sk=sk,
                cap=cap, q_offset=q_offset, sk_valid=sk_valid, causal=causal,
                kv_len=kv_len)


def int8_path_calls() -> list[tuple[dict, float]]:
    """The int8 kernels' calls of 9(b)'s generate (Qwen2.5-14B, B 2):
    the 2 x 512 prefill into the cache of 576, L a forward; then the
    64 decode steps over the whole cache at kv_len 513 .. 576, L each."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(BIG_ARCH)
    geo = dict(b=LM_BATCH, hq=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.d_head)
    L = cfg.n_layers
    calls = [(_i8("flash_attention_int8", sq=LM_PROMPT, sk=LM_PROMPT,
                  cap=INT8_MAX_LEN, **geo), L)]
    calls += [(_i8("decode_attention_int8", sk=INT8_MAX_LEN,
                   cap=INT8_MAX_LEN, kv_len=[n] * LM_BATCH, **geo), L)
              for n in range(LM_PROMPT + 1, INT8_MAX_LEN + 1)]
    return calls


def int8_edge_calls() -> list[dict]:
    """G 1, 7, 12 and 48; D 64 and 128; ragged kv_len down to 0 and 1 (a
    row that sees one key); chunks at q_offset > 0 and past sk_valid;
    caches cut to their prefix; a decode cluster of 16 ranks."""
    f, dec = "flash_attention_int8", "decode_attention_int8"
    return [
        _i8(f, 1, 4, 4, 128, 100, 160, sq=37, q_offset=63),
        _i8(dec, 2, 4, 4, 128, 160, 160, kv_len=[1, 97]),
        _i8(f, 2, 14, 2, 64, 130, 200, sq=130),
        _i8(f, 2, 14, 2, 64, 90, 200, sq=16, q_offset=60, sk_valid=70),
        _i8(dec, 2, 14, 2, 64, 576, 576, kv_len=[0, 77]),
        _i8(f, 1, 96, 8, 128, 60, 64, sq=20, q_offset=40),
        _i8(f, 1, 12, 12, 64, 1500, 1500, sq=16, causal=False),
        _i8(dec, 2, 96, 8, 128, 576, 576, kv_len=[576, 5]),
        _i8(dec, 1, 48, 1, 128, 576, 600, kv_len=[300]),
        _i8(dec, 1, 5, 1, 128, 4096, 4096),
    ]


def _int8_tensor(gen, shape) -> torch.Tensor:
    """What the int8 cache holds: round(N(0, 1) * 32), clipped."""
    return torch.clamp(torch.round(rand(gen, shape) * 32), -127,
                       127).to(torch.int8)


def _int_mm_attention(q, k, v, vis):
    """The same function through ``torch._int_mm`` (the library's int8
    GEMM, here only, never in the port): q quantized as the reference
    does, S and P V two int8 products a (batch row, kv head), the softmax
    and the rounding between them."""
    from repro_torch.kernels.attention.ref import NEG_INF
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q / torch.full((1,), d ** 0.5, device=q.device)
    qq = torch.clamp(torch.round(qf * 32), -127, 127).to(torch.int8)
    qq = qq.reshape(b, hkv, g * sq, d)
    out = torch.empty((b, hkv, g * sq, d), device=q.device)
    for i in range(b):
        for h in range(hkv):
            s = torch._int_mm(qq[i, h], k[i, h].t()).float() / 1024
            s = torch.where(vis, s.reshape(g, sq, sk), NEG_INF)
            e = torch.exp(s - s.amax(-1, keepdim=True))
            pq = torch.round(e / e.sum(-1, keepdim=True) * 127)
            acc = torch._int_mm(pq.to(torch.int8).reshape(g * sq, sk),
                                v[i, h])
            out[i, h] = acc.float() / INT8_SCALE
    return out.reshape(b, hq, sq, d)


def int8_case(call: dict, gen) -> dict:
    """Inputs and thunks of an int8 kernel call: k and v the first ``sk``
    rows of int8 caches of ``cap`` rows."""
    from repro_torch.kernels.attention import kernel as k7
    from repro_torch.kernels.attention.ref import (decode_attention_int8_ref,
                                                   flash_attention_int8_ref,
                                                   visible, visible_pairs)
    b, hq, hkv, d, sq, sk = (call[x] for x in ("b", "hq", "hkv", "d", "sq",
                                               "sk"))
    k = _int8_tensor(gen, (b, hkv, call["cap"], d))[:, :, :sk]
    v = _int8_tensor(gen, (b, hkv, call["cap"], d))[:, :, :sk]
    q = rand(gen, (b, hq, sq, d))
    if call["kernel"] == "decode_attention_int8":
        lens = call["kv_len"]
        kv_len = (None if lens is None else
                  torch.tensor(lens, dtype=torch.int32, device=DEV))
        seen = [min(max(n, 0), sk) for n in (lens or [sk] * b)]
        pairs = hq * sum(seen)
        keys = sum(seen)
        kernel = lambda: k7.decode_attention_int8(q, k, v, kv_len)  # noqa
        plain = lambda: decode_attention_int8_ref(  # noqa: E731
            q, k, v, kv_len, with_probs=True)
        library = None             # G rows a product: past _int_mm's > 16
    else:
        kw = dict(causal=call["causal"], q_offset=call["q_offset"],
                  sk_valid=call["sk_valid"])
        pairs = b * hq * visible_pairs(sq, sk, **kw)
        kv_end = sk if kw["sk_valid"] is None else min(sk, kw["sk_valid"])
        keys = b * (min(kv_end, call["q_offset"] + sq) if call["causal"]
                    else kv_end)
        vis = visible(sq, sk, device=DEV, **kw)
        kernel = lambda: k7.flash_attention_int8(q, k, v, **kw)  # noqa
        plain = lambda: flash_attention_int8_ref(  # noqa: E731
            q, k, v, **kw, with_probs=True)
        kc, vc = k.contiguous(), v.contiguous()
        library = lambda: _int_mm_attention(q, kc, vc, vis)  # noqa: E731
    return dict(kernel=kernel, plain=plain, library=library,
                vmax=int(v.abs().max().item()),
                nbytes=2 * 4 * b * hq * sq * d + 2 * hkv * keys * d,
                ops=4 * d * pairs)


def int8_compare(what, got, want, p127, vmax: int) -> dict:
    """An int8 kernel's output ``got`` against its plain version's
    ``want`` (and p * 127 before rounding, ``p127``): every element within
    rtol = atol = INT8_TOL but on the rows a rounding tie flips; such a row
    must have a tie (p * 127 within INT8_TIE of a half) and differ by no
    more than its ties' value rows can move it (``vmax`` / (127 * 32)
    each).  Returns the flipped rows, the rows, and the largest error off
    the flipped rows."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    bad = ~(diff <= INT8_TOL + INT8_TOL * want.abs()).all(-1)
    frac = (p127 - p127.floor() - 0.5).abs()
    ties = (frac < INT8_TIE * p127.clamp_min(1.0)).sum(-1)
    worst = diff.amax(-1)
    if bool((bad & (ties == 0)).any()):
        raise AssertionError(f"{what}: a row off by {worst.max().item():.3e}"
                             f" has no rounding tie")
    reach = ties * vmax / INT8_SCALE + INT8_TOL
    if bool((bad & (worst > reach)).any()):
        raise AssertionError(f"{what}: a flipped row is off past its ties' "
                             f"reach")
    kept = worst[~bad]
    return dict(flips=int(bad.sum().item()), rows=bad.numel(),
                max_abs_err=kept.max().item() if kept.numel() else 0.0)


@contextlib.contextmanager
def _int8_wrapped(wrap):
    """Inside, the model's two int8 attention calls go through
    ``wrap(kernel, plain)``; K6 and everything else stay as they are."""
    import repro_torch.lm.modules as lm_modules
    from repro_torch.kernels.attention.ref import (decode_attention_int8_ref,
                                                   flash_attention_int8_ref)
    saved = (lm_modules.flash_attention_int8,
             lm_modules.decode_attention_int8)
    lm_modules.flash_attention_int8 = wrap(saved[0],
                                           flash_attention_int8_ref)
    lm_modules.decode_attention_int8 = wrap(saved[1],
                                            decode_attention_int8_ref)
    try:
        yield
    finally:
        (lm_modules.flash_attention_int8,
         lm_modules.decode_attention_int8) = saved


@contextlib.contextmanager
def int8_held():
    """Inside, every int8 kernel call the model makes is also held against
    its plain version on the same inputs (``int8_compare``) and the model
    goes on with the kernel's output; yields the tally: calls, flipped
    rows, rows, the largest error, and ``patches``: for each call, the
    (batch, head, query) rows where the kernel's output is not bit-equal to
    the plain version's, with the kernel's values there."""
    tally = dict(calls=0, flips=0, rows=0, max_abs_err=0.0, patches=[])

    def held(kernel, plain):
        def call(q, k, v, *args, **kw):
            got = kernel(q, k, v, *args, **kw)
            want, p127 = plain(q, k, v, *args, **kw, with_probs=True)
            r = int8_compare(kernel.__name__, got, want, p127,
                             int(v.abs().max().item()))
            rows = (got != want).any(-1).nonzero(as_tuple=True)
            tally["patches"].append((rows, got[rows]))
            tally["calls"] += 1
            for key in ("flips", "rows"):
                tally[key] += r[key]
            tally["max_abs_err"] = max(tally["max_abs_err"],
                                       r["max_abs_err"])
            return got
        return call

    with _int8_wrapped(held):
        yield tally


@contextlib.contextmanager
def int8_replayed(patches):
    """Inside, the model's int8 attention calls go to their plain versions
    alone (no int8 kernel is launched; K6 stays), each call's output taking
    the kernel's values on the rows ``patches`` (``int8_held``'s, call by
    call) lists; yields the count of calls."""
    done = dict(calls=0)

    def replay(kernel, plain):
        def call(q, k, v, *args, **kw):
            out = plain(q, k, v, *args, **kw)
            rows, vals = patches[done["calls"]]
            out[rows] = vals
            done["calls"] += 1
            return out
        return call

    with _int8_wrapped(replay):
        yield done


def int8_check(call: dict, gen, timing: bool) -> dict:
    """Hold one int8 call against its plain version (``int8_compare``).
    Returns the row: flips, rows, the largest error off the flipped rows;
    times if asked."""
    from repro_torch.kernels.util import cuda_time_ms
    case = int8_case(call, gen)
    got = case["kernel"]()
    row = dict(call, **int8_compare(call, got, *case["plain"](),
                                    case["vmax"]))
    if timing:
        t_bytes = case["nbytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = case["ops"] / PEAK_INT8_OPS_PER_S * 1e3
        row.update(ms=cuda_time_ms(case["kernel"]),
                   plain_ms=cuda_time_ms(case["plain"]),
                   library_ms=(None if case["library"] is None
                               else cuda_time_ms(case["library"], reps=5)),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=case["nbytes"], flops=case["ops"])
    return row


def int8_kernels(gen) -> dict:
    """Phase 2's int8 part: the path calls (checked and timed) and the
    edges (checked); the flipped rows over all of them held under
    INT8_FLIP_SHARE.  Returns the path rows by key."""
    from repro_torch.kernels.attention.plan import (plan_decode_int8,
                                                    plan_flash_int8)
    rows, flips, n_rows = {}, 0, 0
    for c, _ in int8_path_calls():
        r = rows[json.dumps(c, sort_keys=True)] = int8_check(c, gen, True)
        flips, n_rows = flips + r["flips"], n_rows + r["rows"]
    for c in int8_edge_calls():
        r = int8_check(c, gen, False)
        flips, n_rows = flips + r["flips"], n_rows + r["rows"]
        print(f"[kernels] edge {r['kernel']:<21} {_shape_str(c):<40} err "
              f"{r['max_abs_err']:.1e}  flips {r['flips']}")
    if flips > INT8_FLIP_SHARE * n_rows:
        raise AssertionError(f"int8 kernels: {flips} of {n_rows} rows "
                             f"flipped, past {INT8_FLIP_SHARE:.1%}")
    call = int8_path_calls()[0][0]
    first = rows[json.dumps(call, sort_keys=True)]
    plan = plan_flash_int8(*(call[x] for x in ("b", "hq", "hkv", "sq", "sk",
                                               "d")))
    print(f"[kernels] int8 flash {_shape_str(call)}: ms {first['ms']:.4f} "
          f" plain {first['plain_ms']:.4f}  library (torch._int_mm chain) "
          f"{first['library_ms']:.4f}  bound {first['bound_ms']:.4f} "
          f"({first['bound_by']})  err {first['max_abs_err']:.1e}  flips "
          f"{first['flips']} of {first['rows']} rows  plan {plan}")
    dec = [r for r in rows.values()
           if r["kernel"] == "decode_attention_int8"]
    dplan = plan_decode_int8(*(dec[0][x] for x in ("b", "hq", "hkv", "sk",
                                                   "d")))
    print(f"[kernels] int8 decode at kv_len {LM_PROMPT + 1}..{INT8_MAX_LEN}"
          f" over the whole cache of {INT8_MAX_LEN}: ms "
          f"{min(r['ms'] for r in dec):.4f}..{max(r['ms'] for r in dec):.4f}"
          f" a call (sum {sum(r['ms'] for r in dec):.4f}), plain sum "
          f"{sum(r['plain_ms'] for r in dec):.4f}, bound sum "
          f"{sum(r['bound_ms'] for r in dec):.5f} ({dec[0]['bound_by']}), "
          f"no library call (G rows a product: _int_mm needs more than 16)"
          f", err {max(r['max_abs_err'] for r in dec):.1e}, flips "
          f"{sum(r['flips'] for r in dec)} of "
          f"{sum(r['rows'] for r in dec)} rows; plan {dplan}")
    print(f"[kernels] int8: {flips} of {n_rows} rows flipped by a rounding "
          f"tie (held under {INT8_FLIP_SHARE:.1%}), every other element "
          f"within rtol = atol = {INT8_TOL}")
    return rows


def int8_sums(rows: dict) -> dict:
    """Per int8 kernel, the phase-2 rows summed over the generate's calls
    (its prefill forward and its 64 decode steps)."""
    out: dict[str, dict] = {}
    for c, wgt in int8_path_calls():
        r = rows[json.dumps(c, sort_keys=True)]
        acc = out.setdefault(c["kernel"], dict(
            calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
            flops=0, tc_flops=0, max_abs_err=0.0, partition_ms=0.0,
            flips=0, rows=0))
        acc["calls"] += wgt
        for k in ("ms", "plain_ms", "bytes", "flops"):
            acc[k] += wgt * r[k]
        acc["partition_ms"] += wgt * r["ms"]
        acc["library_ms"] = (None if r["library_ms"] is None
                             or acc["library_ms"] is None
                             else acc["library_ms"] + wgt * r["library_ms"])
        acc["max_abs_err"] = max(acc["max_abs_err"], r["max_abs_err"])
        acc["flips"] += r["flips"]
        acc["rows"] += r["rows"]
    for v in out.values():
        t_ops = v["flops"] / PEAK_INT8_OPS_PER_S * 1e3
        t_bytes = v["bytes"] / PEAK_BYTES_PER_S * 1e3
        v.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def _tree_bytes(tree) -> int:
    from repro_torch.train.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def dry_vs_card(what: str, dry: int, card: int) -> dict:
    """Print the dry run's tracked peak beside the card's; raise past
    MEM_TOL."""
    off = dry / card - 1
    print(f"[dryrun] {what}: the dry run's peak {dry / 1e9:.3f} GB, the "
          f"card's {card / 1e9:.3f} GB ({off:+.1%}; held within "
          f"{MEM_TOL:.0%})")
    if abs(off) > MEM_TOL:
        raise AssertionError(f"{what}: dry run {dry} bytes against the "
                             f"card's {card}")
    return dict(dry_bytes=dry, card_bytes=card, off=off)


def int8_generate(cfg, params, rows: dict) -> dict:
    """9(b): ``make_generate(cfg, 64)`` from a seeded 2 x 512 prompt with
    an f32 cache and with an int8 cache (576 positions each), launches
    counted from 0 around each run: K6 2L + 1 a forward; on the f32 side
    K7 flash L in the prefill and K7 decode L a step, on the int8 side the
    int8 kernels in their place and no f32 K7.  The int8 run's every int8 call held against its plain version on the
    model's inputs (flipped rows counted) and its tokens equal run to run;
    its tokens equal to those of a run that launches no int8 kernel (plain
    versions, K6 kept) but for the kernel's values on the rows where the
    two outputs were not bit-equal.  The tokens' agreement between the
    caches (the reference's criterion, ``tests/test_serving.py``) is
    printed, not held (below).  The caches' bytes; a decode step's device
    time on each; the int8 run's own bytes (its peak less what it was
    given: weights, cache, prompt) against the dry run's at its shapes,
    the whole peaks printed beside.  Returns the int8 run as a path of the
    kernels line."""
    from repro_torch.launch.dryrun import dry_step
    from repro_torch.lm.model import decode_step, init_cache
    from repro_torch.lm.steps import make_generate
    L, steps = cfg.n_layers, LM_GEN
    prompt = torch.from_numpy(np.random.default_rng(27).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(DEV)
    generate = make_generate(cfg, steps)
    weights = _tree_bytes(params)
    runs = {}
    for tag, kvd in (("f32", None), ("int8", torch.int8)):
        cache = init_cache(cfg, LM_BATCH, INT8_MAX_LEN, DEV, kv_dtype=kvd)
        cache_bytes = cache.kv_k.nbytes + cache.kv_v.nbytes
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        toks, cache = generate(params, prompt, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        k7 = (("flash_attention", "decode_attention") if kvd is None
              else INT8_KERNELS)
        check_counts(f"{cfg.name} generate, {tag} cache", launches, {
            "rmsnorm": (2 * L + 1) * (steps + 1), k7[0]: L,
            k7[1]: L * steps})
        last = cache._replace(pos=INT8_MAX_LEN - 1, pos_dev=torch.full(
            (), INT8_MAX_LEN - 1, dtype=torch.int32, device=DEV))
        tok = toks[:, -1:].contiguous()
        step_ms = events_ms(lambda: decode_step(params, cfg, tok, last),
                            reps=3)
        runs[tag] = dict(tokens=toks.cpu(), launches=launches, wall_s=wall,
                         cache_bytes=cache_bytes, step_ms=step_ms,
                         own=peak - before,
                         peak=peak - before + weights + cache_bytes
                         + prompt.nbytes)
        print(f"[design] {cfg.name} make_generate({steps}), {tag} cache of "
              f"{INT8_MAX_LEN}: {cache_bytes / 1e6:.1f} MB of cache, the "
              f"run {wall:.2f} s, a decode step at position "
              f"{INT8_MAX_LEN - 1} {step_ms:.3f} ms (events around one "
              f"eager step, its enqueue inside where slower); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        del cache, last
    # every int8 call of the run held against its plain version on the
    # model's own inputs; the same tokens (the kernels' bits do not vary)
    with int8_held() as held:
        again, _ = generate(params, prompt, init_cache(
            cfg, LM_BATCH, INT8_MAX_LEN, DEV, kv_dtype=torch.int8))
    if held["calls"] != L * (steps + 1) or held["flips"] > (
            INT8_FLIP_SHARE * held["rows"]):
        raise AssertionError(f"{cfg.name} int8 generate: {held}")
    if not torch.equal(again.cpu(), runs["int8"]["tokens"]):
        raise AssertionError(f"{cfg.name}: the int8 generate's tokens "
                             f"differ run to run")
    # the same generate with no int8 kernel launched: what the kernels'
    # outputs do downstream, and anything they touch besides, shows here
    patches = held.pop("patches")
    reset_counts()
    with int8_replayed(patches) as replayed:
        swapped, _ = generate(params, prompt, init_cache(
            cfg, LM_BATCH, INT8_MAX_LEN, DEV, kv_dtype=torch.int8))
    if any(launch_counts().get(k) for k in INT8_KERNELS):
        raise AssertionError("the replayed int8 generate launched an int8 "
                             "kernel")
    patched = sum(int(rows[0].numel()) for rows, _ in patches)
    if replayed["calls"] != held["calls"] or not torch.equal(
            swapped.cpu(), runs["int8"]["tokens"]):
        raise AssertionError(
            f"{cfg.name} int8 generate: the plain versions' tokens (K6 "
            f"kept, the kernel's values on its {patched} rows not "
            f"bit-equal) differ from the kernels' run's")
    # the reference's agreement (half the tokens, tests/test_serving.py)
    # is printed, not held: at a 512-token prompt the static-scale int8
    # cache turns a last-bit difference into another integer (q and p
    # are rounded to 1/32 and 1/127), and this model's random weights
    # leave its logits nearly tied, so the reference's own tokens move
    # (tools/int8_agreement.py).  The tokens of the same generates
    # through the plain versions on the card show it for each cache.
    with plain_kernels():
        plain = {tag: generate(params, prompt, init_cache(
            cfg, LM_BATCH, INT8_MAX_LEN, DEV, kv_dtype=kvd))[0].cpu()
            for tag, kvd in (("f32", None), ("int8", torch.int8))}

    def agree(a, b) -> float:
        return float((a == b).float().mean())

    agreement = dict(
        int8_f32=agree(runs["int8"]["tokens"], runs["f32"]["tokens"]),
        int8_plain=agree(runs["int8"]["tokens"], plain["int8"]),
        f32_plain=agree(runs["f32"]["tokens"], plain["f32"]),
        plain_int8_f32=agree(plain["int8"], plain["f32"]),
        first_int8_f32=agree(runs["int8"]["tokens"][:, 0],
                             runs["f32"]["tokens"][:, 0]))
    print(f"[design] {cfg.name} int8 generate: each of its {held['calls']} "
          f"int8 calls held against its plain version on the model's "
          f"inputs, {held['flips']} of {held['rows']} rows flipped by a "
          f"rounding tie (under {INT8_FLIP_SHARE:.1%}), every other element "
          f"within {INT8_TOL} (max {held['max_abs_err']:.1e}); the tokens "
          f"the same run to run, and all {swapped.numel()} equal to a run "
          f"through the plain versions alone (K6 kept) that took the "
          f"kernel's values on the {patched} rows not bit-equal.  Tokens "
          f"agreeing (printed, not held): int8 "
          f"cache against f32 {agreement['int8_f32']:.3f} (the first "
          f"{agreement['first_int8_f32']:.3f}), the kernels against the "
          f"plain versions of K6 and K7 together "
          f"{agreement['int8_plain']:.3f} on the int8 cache "
          f"and {agreement['f32_plain']:.3f} on the f32 one, the plain "
          f"versions' int8 against their f32 "
          f"{agreement['plain_int8_f32']:.3f}")
    ratio = runs["f32"]["cache_bytes"] / runs["int8"]["cache_bytes"]
    if ratio != 4:
        raise AssertionError(f"the int8 cache is 1/{ratio} of the f32's")
    # the dry run's prefill and last decode step; the bytes held are the
    # step's own (the peak less the weights, cache and tokens it is given),
    # the whole peaks, which share those, printed beside
    dry = [dry_step(cfg, "prefill", LM_PROMPT, LM_BATCH, kv_dtype=torch.int8,
                    max_len=INT8_MAX_LEN),
           dry_step(cfg, "decode", INT8_MAX_LEN, LM_BATCH,
                    kv_dtype=torch.int8)]
    whole = max(d["peak_bytes"] for d in dry)
    print(f"[dryrun] {cfg.name} int8 generate, whole peaks (weights, cache "
          f"and prompt included; printed, not held): the dry run's "
          f"{whole / 1e9:.3f} GB, the card's "
          f"{runs['int8']['peak'] / 1e9:.3f} GB")
    mem = dry_vs_card(f"{cfg.name} int8 generate, its own bytes (the peak "
                      f"less weights, cache and prompt)",
                      max(d["peak_bytes"] - d["base_bytes"] for d in dry),
                      runs["int8"]["own"])
    mem.update(whole_dry_bytes=whole, whole_card_bytes=runs["int8"]["peak"])
    print(f"[design] {cfg.name}: the int8 cache is 1/{ratio:g} of the "
          f"f32's; a decode step {runs['int8']['step_ms']:.3f} ms against "
          f"{runs['f32']['step_ms']:.3f}")
    for r in runs.values():
        r["tokens"] = r["tokens"].tolist()
    return dict(model=f"{cfg.name} int8 generate",
                launches=runs["int8"]["launches"], kernels=int8_sums(rows),
                agreement=agreement, held=held, runs=runs, memory=mem,
                replayed=dict(calls=replayed["calls"], patched_rows=patched))


# --------------------------------------------------------------------------
# phase 10: the SSM, hybrid, encoder-decoder and M-RoPE families
# --------------------------------------------------------------------------
@contextlib.contextmanager
def plain_kernels():
    """The model's K6 and K7 calls go to their plain versions while
    inside, on the card too (the reference run of phase 10(c) and (d))."""
    import repro_torch.lm.model as lm_model
    import repro_torch.lm.modules as lm_modules
    from repro_torch.kernels.attention.ref import (decode_attention_int8_ref,
                                                   decode_attention_ref,
                                                   flash_attention_int8_ref,
                                                   flash_attention_ref)
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    names = ("flash_attention", "decode_attention", "flash_attention_int8",
             "decode_attention_int8")
    saved = (lm_model.rmsnorm, *(getattr(lm_modules, n) for n in names))
    lm_model.rmsnorm = lambda x, w, eps=1e-6: rmsnorm_ref(x, w, eps)
    for n, ref in zip(names, (flash_attention_ref, decode_attention_ref,
                              flash_attention_int8_ref,
                              decode_attention_int8_ref)):
        setattr(lm_modules, n, ref)
    try:
        yield
    finally:
        lm_model.rmsnorm = saved[0]
        for n, fn in zip(names, saved[1:]):
            setattr(lm_modules, n, fn)


def draw_to_card(cfg, tag: str) -> tuple[dict, float]:
    """``load_params(cfg, 0)`` on the card, its host seconds printed."""
    from repro_torch.lm.model import load_params
    t0 = time.perf_counter()
    params = load_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    print(f"[blocks] {tag}: {cfg.param_count() / 1e9:.3f} B parameters "
          f"({4 * cfg.param_count() / 1e9:.2f} GB f32) drawn from seed 0 "
          f"straight to the card in {draw_s:.1f} s of host; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return params, draw_s


def graph_step_ms(params, cfg, cache, rows: int, pos: int,
                  positions3=None) -> float:
    """Device ms of one decode step of ``rows`` rows at position ``pos``,
    captured as a CUDA graph and replayed with the host held out
    (``cuda_time_ms``); the cache is written in place at ``pos``."""
    from repro_torch.kernels.util import capture_graph, cuda_time_ms
    from repro_torch.lm.model import decode_step
    at = torch.tensor(pos, dtype=torch.int32, device=DEV)
    tok = torch.zeros((rows, 1), dtype=torch.int64, device=DEV)
    c = cache._replace(pos=pos, pos_dev=at)

    def body():
        return decode_step(params, cfg, tok, c, positions3=positions3)[0]

    body()                               # the kernels' attributes set
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph, _ = capture_graph(body, stream=side)
    torch.cuda.current_stream().wait_stream(side)

    def replay():
        at.fill_(pos)
        graph.replay()

    return cuda_time_ms(replay, reps=4)


def served_block(name: str, rows: dict) -> dict:
    """10(a)/(b): ``name`` at full depth served through ``DualMeshEngine``
    on the split at ``LM_THETA``, 8 x batch 2, 512 + 64, decode steps
    replayed from captured lanes (the SSM states in them): launches as
    the plan says, tokens equal to the same run on one stream without
    graphs; walls, tokens/s, a prefill on the c-core's stream and a
    decode step's graph replayed with the host held out, beside the card
    cost model's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.cost import CardModel
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.dualmesh.runtime import DualMeshRunner, random_prompts
    from repro_torch.dualmesh.schedule import plan_admission
    from repro_torch.kernels.util import cuda_time_ms
    cfg = get_arch(name)
    free_card(f"before {name}")
    params, draw_s = draw_to_card(cfg, name)
    prompts = random_prompts(cfg, LM_REQUESTS, LM_BATCH, LM_PROMPT, seed=1,
                             device=DEV)
    gens = [LM_GEN] * LM_REQUESTS
    runners = {
        "graphs": DualMeshRunner(cfg, params, split_streams(DEV, LM_THETA),
                                 max_len=LM_MAX_LEN),
        "one stream, eager": DualMeshRunner(
            cfg, params, split_streams(DEV, LM_THETA, one_stream=True),
            max_len=LM_MAX_LEN, jit_groups=False)}
    main = runners["graphs"]
    gs = main.planned_group_size(prompts, gens)
    for r in runners.values():
        warm_runner(r, cfg, LM_REQUESTS, gs)
    res, launches, stream_ms = served_run(main, prompts, gs)
    steps = check_lm_run(f"{name} served", cfg, res, launches, prompts)
    if res.stats["fused_sizes"] != lm_group_sizes(name):
        raise AssertionError(f"{name} formed decode groups "
                             f"{res.stats['fused_sizes']}, but phase 2 "
                             f"checked {lm_group_sizes(name)}")
    walls = {"graphs": [res.stats["wall_s"]]}
    for turn in range(2):
        for tag, r in runners.items():
            if turn == 0 and tag == "graphs":
                continue
            out, _, _ = served_run(r, prompts, gs)
            walls.setdefault(tag, []).append(out.stats["wall_s"])
            for i, (a, b) in enumerate(zip(res.outputs, out.outputs)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} request {i}: {tag} "
                                         f"generated other tokens")
    prefill = [d for (kind, _, _), d in zip(res.trace, stream_ms)
               if kind == "prefill"]
    rows_dec = LM_BATCH * res.stats["fused_sizes"][0]
    mid = LM_PROMPT + LM_GEN // 2
    lane = main.lanes.lanes[rows_dec, LM_MAX_LEN][0]

    def replay_step():
        lane.pos.fill_(mid)
        lane.graph.replay()

    graph_ms = cuda_time_ms(replay_step, reps=4)
    norms, attn = forward_launches(cfg)
    s, m = res.stats, res.metrics
    model = step_model(cfg, main.dual, rows_dec)
    model["makespan_ms"] = plan_admission(
        cfg, main.dual, CardModel(), LM_BATCH, LM_PROMPT, LM_GEN,
        LM_REQUESTS).est_makespan * 1e3
    print(f"[blocks] {name}: {cfg.n_layers} {cfg.block_type} layers"
          + (f" and {attn} applications of the shared block" if attn else "")
          + f", d {cfg.d_model}; {LM_REQUESTS} requests x batch {LM_BATCH},"
          f" prompt {LM_PROMPT}, {LM_GEN} generated on c "
          f"{main.dual.cores.sms('c')} SMs and p {main.dual.cores.sms('p')}"
          f": {s['wall_s'] * 1e3:.2f} ms, {s['tokens_per_s']:.1f} tokens/s "
          f"({s['total_tokens']} tokens), p50 {m.p50_ms():.2f} ms, p95 "
          f"{m.p95_ms():.2f} ms; fused sizes {s['fused_sizes']}; launches "
          f"{launches} (a forward step K6 {norms}, K7 {attn}: the plan's); "
          f"walls (in turns) "
          + "; ".join(f"{k} " + ", ".join(f"{w * 1e3:.2f}" for w in v)
                      + " ms" for k, v in walls.items())
          + "; tokens equal")
    print(f"[blocks] {name}: a prefill (2 x {LM_PROMPT}) "
          f"{sum(prefill) / len(prefill):.2f} ms on the c-core's stream "
          f"(the run's mean); a decode step of {rows_dec} rows "
          f"{graph_ms:.3f} ms (one graph replay on the p-core, host held "
          f"out; {steps} steps served); {main.lanes.count} lane(s) captured "
          f"in {main.capture_s * 1e3:.1f} ms, "
          + ", ".join(f"{ln.nbytes / 2 ** 20:.1f}"
                      for v in main.lanes.lanes.values() for ln in v)
          + " MiB a lane")
    print(f"[blocks] {name}: the card cost model on the split: a prefill "
          f"{model['prefill_ms']:.2f} ms ({model['prefill_bound']}), a "
          f"decode step of {rows_dec} rows {model['latency_ms']:.3f} ms "
          f"({model['bound']}; f32 bytes {model['bytes_ms']:.3f} ms, step "
          f"floor {model['floor_ms']:.3f} ms), the plan's makespan "
          f"{model['makespan_ms']:.1f} ms against the wall "
          f"{s['wall_s'] * 1e3:.1f} ms")
    out = dict(model=name, launches=launches,
               kernels=weighted_sums(rows, block_request_calls(
                   name, s["fused_sizes"][0])),
               draw_s=draw_s, fused_sizes=s["fused_sizes"],
               wall_s=s["wall_s"], walls=walls,
               tokens_per_s=s["tokens_per_s"], p50_ms=m.p50_ms(),
               p95_ms=m.p95_ms(), prefill_stream_ms=prefill,
               graph_ms_per_step=graph_ms, rows=rows_dec,
               capture_s=main.capture_s, step_model=model)
    for r in runners.values():
        r.dual.cores.synchronize()
    del runners, main, lane, params
    return out


def whisper_run(cfg, params, frames, prompt) -> tuple[list, list, float]:
    """Whisper end to end: ``encode`` the frames, ``init_cache`` with the
    memory, a prefill of the prompt, ``WHISPER_GEN`` greedy decode steps.
    Returns each step's logits (the prefill's last position first), the
    tokens and the wall seconds."""
    from repro_torch.lm.model import decode_step, encode, init_cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memory = encode(params, cfg, frames)
    cache = init_cache(cfg, LM_BATCH, WHISPER_MAX_LEN, DEV, memory=memory,
                       params=params)
    logits, cache = decode_step(params, cfg, prompt, cache)
    steps = [logits[:, -1]]
    toks = [torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)]
    for _ in range(WHISPER_GEN):
        logits, cache = decode_step(params, cfg, toks[-1][:, None], cache)
        steps.append(logits[:, -1])
        toks.append(torch.argmax(logits[:, -1, :cfg.vocab], dim=-1))
    torch.cuda.synchronize()
    return steps, toks, time.perf_counter() - t0


def whisper_path(rows: dict) -> dict:
    """10(c): Whisper-small at its published size: ``encode`` over 2 x 1500
    seeded frame embeddings, ``init_cache(memory=..., params=...)``, a
    16-token prefill and 64 greedy ``decode_step``s, the same run with the
    plain versions on the card: tokens equal, the first step's logits
    within 1e-3."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.runtime import random_prompts
    from repro_torch.kernels.util import cuda_time_ms
    from repro_torch.lm.model import decode_step, encode, init_cache
    cfg = get_arch(WHISPER)
    free_card(f"before {WHISPER}")
    params, draw_s = draw_to_card(cfg, WHISPER)
    frames = rand(np.random.default_rng(10),
                  (LM_BATCH, cfg.enc_positions, cfg.d_model), 0.1)
    prompt = random_prompts(cfg, 1, LM_BATCH, WHISPER_PROMPT, seed=5,
                            device=DEV)[0]
    with plain_kernels():
        plain, plain_toks, plain_s = whisper_run(cfg, params, frames, prompt)
    reset_counts()
    got, toks, wall = whisper_run(cfg, params, frames, prompt)
    launches = launch_counts()
    norms, attn = forward_launches(cfg)
    enc = cfg.enc_layers
    check_counts(f"{WHISPER} run", launches, {
        "rmsnorm": 2 * enc + 1 + (1 + WHISPER_GEN) * norms,
        "flash_attention": enc + attn, "decode_attention":
        WHISPER_GEN * attn})
    for i, (a, b) in enumerate(zip(toks, plain_toks)):
        if not torch.equal(a, b):
            raise AssertionError(f"{WHISPER} step {i}: the kernels' tokens "
                                 f"differ from the plain versions'")
    errs = [(a - b).abs().max().item() for a, b in zip(got, plain)]
    for i in (0, 1):                     # the prefill's, the first step's
        if not torch.allclose(got[i], plain[i], rtol=FORWARD_TOL,
                              atol=FORWARD_TOL):
            raise AssertionError(f"{WHISPER} step {i}: the logits differ "
                                 f"from the plain versions' by "
                                 f"{errs[i]:.3e}")
    walls = [wall, whisper_run(cfg, params, frames, prompt)[2]]
    enc_ms = cuda_time_ms(lambda: encode(params, cfg, frames), reps=4)
    memory = encode(params, cfg, frames)
    cache = init_cache(cfg, LM_BATCH, WHISPER_MAX_LEN, DEV, memory=memory,
                       params=params)
    prefill_ms = cuda_time_ms(lambda: decode_step(params, cfg, prompt,
                                                  cache), reps=4)
    mid = WHISPER_PROMPT + WHISPER_GEN // 2
    step_ms = graph_step_ms(params, cfg, cache, LM_BATCH, mid)
    tokens = LM_BATCH * (WHISPER_PROMPT + 1 + WHISPER_GEN)
    print(f"[blocks] {WHISPER}: {enc} encoder and {cfg.n_layers} decoder "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads (D {cfg.d_head}); "
          f"encode 2 x {cfg.enc_positions} frames, a {WHISPER_PROMPT}-token "
          f"prefill and {WHISPER_GEN} greedy decode steps: walls "
          + ", ".join(f"{w * 1e3:.2f}" for w in walls)
          + f" ms ({tokens / min(walls):.1f} tokens/s: prompt and generated "
          f"tokens over the best wall; the plain versions' run "
          f"{plain_s * 1e3:.2f} ms); launches {launches}; tokens equal the "
          f"plain versions' on the card, the prefill's and the first "
          f"step's logits within {max(errs[:2]):.2e} (tol {FORWARD_TOL}), "
          f"every step's within {max(errs):.2e}")
    print(f"[blocks] {WHISPER}: encode {enc_ms:.3f} ms, the prefill "
          f"{prefill_ms:.3f} ms, a decode step {step_ms:.3f} ms (one graph "
          f"replay at position {mid}), each on the device with the host "
          f"held out")
    del params, cache, memory
    return dict(model=WHISPER, launches=launches,
                kernels=weighted_sums(rows, block_request_calls(WHISPER, 1)),
                draw_s=draw_s, walls=walls, plain_wall_s=plain_s,
                tokens_per_s=tokens / min(walls), encode_ms=enc_ms,
                prefill_ms=prefill_ms, graph_ms_per_step=step_ms,
                first_step_max_abs_err=max(errs[:2]),
                max_abs_err_steps=max(errs))


def vl_inputs(cfg) -> dict:
    """The prompt of 10(d): ``VL_GRID`` x ``VL_GRID`` patch embeddings at t
    = 0 (h the row, w the column), then ``VL_TEXT`` text tokens whose
    three position streams are equal and go on past the grid."""
    gen = np.random.default_rng(11)
    tokens = torch.from_numpy(gen.integers(
        0, cfg.vocab, (LM_BATCH, VL_PROMPT))).to(DEV)
    patches = rand(gen, (LM_BATCH, VL_GRID ** 2, cfg.d_model), 0.02)
    cells = torch.arange(VL_GRID ** 2, device=DEV)
    text = VL_GRID + torch.arange(VL_TEXT, device=DEV)
    zero = torch.zeros_like(cells)
    p3 = torch.stack([torch.cat([zero, text]),
                      torch.cat([cells // VL_GRID, text]),
                      torch.cat([cells % VL_GRID, text])])
    return dict(tokens=tokens, patches=patches,
                positions3=p3.expand(LM_BATCH, 3, VL_PROMPT).contiguous())


def vl_run(cfg, params, inp, feed=None) -> tuple[list, list, float]:
    """10(d)'s run: the forward over the prompt, its prefill by
    ``decode_step`` with the patches, then ``VL_STEPS`` decode steps with
    equal position streams past the text, fed ``feed`` (else their own
    argmax).  Returns the logits (the forward's, the prefill's last
    position, each step's), the tokens fed and the wall seconds."""
    from repro_torch.lm.model import decode_step, forward, init_cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd = forward(params, cfg, inp["tokens"], positions3=inp["positions3"],
                  extra_embeds=inp["patches"])
    cache = init_cache(cfg, LM_BATCH, VL_MAX_LEN, DEV)
    pre, cache = decode_step(params, cfg, inp["tokens"], cache,
                             positions3=inp["positions3"],
                             extra_embeds=inp["patches"])
    outs, toks = [fwd, pre[:, -1]], []
    nxt = pre[:, -1]
    start = VL_GRID + VL_TEXT
    for i in range(VL_STEPS):
        tok = (feed[i] if feed is not None
               else torch.argmax(nxt[:, :cfg.vocab], dim=-1))
        toks.append(tok)
        p3 = torch.full((LM_BATCH, 3, 1), start + i, device=DEV)
        logits, cache = decode_step(params, cfg, tok[:, None], cache,
                                    positions3=p3)
        nxt = logits[:, -1]
        outs.append(nxt)
    torch.cuda.synchronize()
    return outs, toks, time.perf_counter() - t0


def vl_path(rows: dict) -> dict:
    """10(d): Qwen2-VL-72B at its full width cut to ``VL_LAYERS`` of its 80
    layers: the forward and the prefill over patches and text on M-RoPE,
    16 decode steps, against the plain versions on the card at 1e-3; a
    text-only forward on three equal streams bit-equal to RoPE's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.lm.model import decode_step, forward, init_cache
    full = get_arch(VL_ARCH)
    cfg = full.scaled(name=f"{VL_ARCH}_{VL_LAYERS}l", n_layers=VL_LAYERS)
    free_card(f"before {VL_ARCH}")
    params, draw_s = draw_to_card(
        cfg, f"{VL_ARCH} cut to {VL_LAYERS} of its {full.n_layers} layers "
        f"(full width: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, d_ff {cfg.d_ff}; {4 * full.param_count() / 1e9:.0f} GB f32"
        f" at full depth does not fit one card)")
    inp = vl_inputs(cfg)
    with plain_kernels():
        plain, plain_toks, plain_s = vl_run(cfg, params, inp)
    reset_counts()
    got, _, wall = vl_run(cfg, params, inp, feed=plain_toks)
    launches = launch_counts()
    norms = 2 * VL_LAYERS + 1
    check_counts(f"{VL_ARCH} run", launches, {
        "rmsnorm": (2 + VL_STEPS) * norms, "flash_attention": 2 * VL_LAYERS,
        "decode_attention": VL_STEPS * VL_LAYERS})
    errs = []
    for i, (a, b) in enumerate(zip(got, plain)):
        errs.append((a - b).abs().max().item())
        if a.shape != b.shape or not torch.allclose(a, b, rtol=FORWARD_TOL,
                                                    atol=FORWARD_TOL):
            raise AssertionError(f"{VL_ARCH} output {i}: the kernels' logits "
                                 f"differ from the plain versions' by "
                                 f"{errs[-1]:.3e}")
    walls = [wall, vl_run(cfg, params, inp, feed=plain_toks)[2]]
    reset_counts()
    same = torch.arange(VL_PROMPT, device=DEV).expand(LM_BATCH, 3, VL_PROMPT)
    a = forward(params, cfg, inp["tokens"], positions3=same)
    b = forward(params, cfg, inp["tokens"])
    text = launch_counts()
    check_counts(f"{VL_ARCH} text forwards", text, {
        "rmsnorm": 2 * norms, "flash_attention": 2 * VL_LAYERS})
    if not torch.equal(a, b):
        raise AssertionError(f"{VL_ARCH}: the text forward on three equal "
                             f"streams differs from RoPE's")
    del a, b
    launches = {k: n + text[k] for k, n in launches.items()}
    fwd_ms = events_ms(lambda: forward(params, cfg, inp["tokens"],
                                       positions3=inp["positions3"],
                                       extra_embeds=inp["patches"]))
    cache = init_cache(cfg, LM_BATCH, VL_MAX_LEN, DEV)
    prefill_ms = events_ms(lambda: decode_step(
        params, cfg, inp["tokens"], cache, positions3=inp["positions3"],
        extra_embeds=inp["patches"]))
    mid = VL_PROMPT + VL_STEPS // 2
    p3 = torch.full((LM_BATCH, 3, 1), VL_GRID + VL_TEXT + VL_STEPS // 2,
                    device=DEV)
    step_ms = graph_step_ms(params, cfg, cache, LM_BATCH, mid, p3)
    tokens = LM_BATCH * (VL_PROMPT + VL_STEPS)
    print(f"[blocks] {VL_ARCH} cut to {VL_LAYERS} of {full.n_layers} "
          f"layers: a prompt of {VL_GRID} x {VL_GRID} patches at t = 0 and "
          f"{VL_TEXT} text tokens on M-RoPE, forward, prefill and "
          f"{VL_STEPS} decode steps: walls "
          + ", ".join(f"{w * 1e3:.2f}" for w in walls)
          + f" ms ({tokens / min(walls):.1f} tokens/s: prompt and generated "
          f"tokens over the best wall; the plain versions' run "
          f"{plain_s * 1e3:.2f} ms); launches {launches}; the kernels' "
          f"logits within {max(errs):.2e} of the plain versions' on the card"
          f" (tol {FORWARD_TOL}); the text forward on three equal streams "
          f"bit-equal to RoPE's")
    print(f"[blocks] {VL_ARCH} cut: the forward {fwd_ms:.2f} ms and the "
          f"prefill {prefill_ms:.2f} ms (events around one call), a decode "
          f"step {step_ms:.3f} ms (one graph replay at position {mid}, host "
          f"held out), on the whole card")
    del params, cache
    return dict(model=f"{VL_ARCH} ({VL_LAYERS} layers)", launches=launches,
                kernels=weighted_sums(rows, block_request_calls(VL_ARCH, 1)),
                layers=VL_LAYERS, draw_s=draw_s, walls=walls,
                plain_wall_s=plain_s, tokens_per_s=tokens / min(walls),
                forward_ms=fwd_ms, prefill_ms=prefill_ms,
                graph_ms_per_step=step_ms, max_abs_err=max(errs))


def blocks_path(rows: dict) -> list[dict]:
    """Phase 10: (a) xLSTM-350M and (b) Zamba2-2.7B served, (c)
    Whisper-small end to end, (d) Qwen2-VL-72B at full width and 8
    layers; each run's launches counted from 0 and kept for the kernels
    line."""
    t0 = time.perf_counter()
    free_card("before phase 10 (green contexts stay)")
    out = [served_block(name, rows) for name in BLOCK_SERVED]
    out.append(whisper_path(rows))
    out.append(vl_path(rows))
    free_card("after phase 10")
    print(f"[blocks] {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 11: training
# --------------------------------------------------------------------------
TRAIN_ARCH = "qwen2_0_5b"
TRAIN_STEPS = 8
TRAIN_BATCH = 8
TRAIN_SEQ = 512
# the backward kernels against their plain versions: both f32; the
# kernels sum in another order (K7's recomputed P from the forward's
# 3xTF32 log-sum-exp, dK and dV over the G heads' 512 rows), which moves
# the last bits of sums of up to G x Sq terms
BWD_TOL = 1e-4
# (c): the step's loss and gradient norm, kernels against plain versions
# on the card, and each leaf's gradient within this share of its largest
# magnitude: 24 layers of f32 backward, each kernel summing in another
# order than its plain version, compound the last bits
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_GRAD_SHARE = 1e-3
RECOVERY = dict(fail_at=6, ckpt_every=4, steps=8)      # 11(d), smoke


def train_per_step(cfg) -> dict[str, int]:
    """Each kernel's launches in one train step of ``cfg`` with remat:
    K6 forward 2L + 1 and again 2L in the recomputed layers, K7 flash L
    and again L, K6's backward 2L + 1, K7 flash's backward L."""
    L = cfg.n_layers
    return {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L,
            "rmsnorm_bwd": 2 * L + 1, "flash_attention_bwd": L}


def train_calls() -> list[dict]:
    """The training path's kernel calls: K6 at the step's 4096 x 896 rows
    and K7 flash at B 8, Hq 14, Hkv 2, S 512, D 64, causal, each forward
    as training launches it (K6 the plain way, K7 with its log-sum-exp)
    and backward."""
    rows = TRAIN_BATCH * TRAIN_SEQ
    flash = dict(b=TRAIN_BATCH, hq=14, hkv=2, sq=TRAIN_SEQ, sk=TRAIN_SEQ,
                 d=64, causal=True, q_offset=0, sk_valid=None)
    return [dict(kernel="rmsnorm", rows=rows, d=896, train=True),
            dict(kernel="rmsnorm_bwd", rows=rows, d=896),
            dict(flash, kernel="flash_attention", train=True),
            dict(flash, kernel="flash_attention_bwd")]


def train_edge_calls() -> list[dict]:
    """The backward kernels at small edge cases: K6 at one row, odd or
    wide widths, rows that are no multiple of a block's warps and more
    blocks than SMs would take; K7 flash non-causal, a chunk (q_offset >
    0), sk_valid < Sk, Sq != Sk, G 1, 7, 8 and 14, D 32, 64, 80 and 128,
    keys that are no multiple of a key tile, fewer blocks than SMs, rows
    that see no key."""
    def fl(b, hq, hkv, sq, sk, d, causal=True, q_offset=0, sk_valid=None):
        return dict(kernel="flash_attention_bwd", b=b, hq=hq, hkv=hkv,
                    sq=sq, sk=sk, d=d, causal=causal, q_offset=q_offset,
                    sk_valid=sk_valid)
    return [dict(kernel="rmsnorm_bwd", rows=1, d=896),
            dict(kernel="rmsnorm_bwd", rows=37, d=1023),
            dict(kernel="rmsnorm_bwd", rows=300, d=2560),
            dict(kernel="rmsnorm_bwd", rows=9, d=8192),
            dict(kernel="rmsnorm_bwd", rows=1037, d=896),
            dict(kernel="rmsnorm_bwd", rows=133, d=1024),
            fl(2, 14, 2, 130, 130, 64), fl(1, 7, 7, 77, 77, 64),
            fl(1, 7, 1, 64, 64, 64), fl(2, 4, 2, 100, 100, 64, causal=False),
            fl(1, 4, 2, 37, 200, 64, q_offset=163),
            fl(1, 4, 2, 70, 70, 64, sk_valid=40),
            fl(1, 4, 2, 40, 90, 64, causal=False),
            fl(1, 4, 2, 70, 70, 80), fl(1, 8, 1, 65, 65, 128),
            fl(1, 4, 2, 20, 30, 64, sk_valid=0),
            fl(1, 4, 2, 100, 100, 64), fl(1, 2, 1, 48, 48, 64),
            fl(2, 8, 2, 96, 96, 32), fl(1, 8, 1, 150, 150, 64),
            fl(1, 14, 1, 90, 90, 64)]


def _train_case(call: dict, gen) -> dict:
    """Inputs and thunks of a training-path call (see make_case)."""
    from repro_torch.kernels.attention import kernel as k7
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                                   flash_attention_ref,
                                                   visible)
    from repro_torch.kernels.rmsnorm import kernel as k6
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
    kind = call["kernel"]
    if kind in ("rmsnorm", "rmsnorm_bwd"):
        rows, d = call["rows"], call["d"]
        x = rand(gen, (rows, d))
        w = rand(gen, (d,), 0.5) + 1.0
        if kind == "rmsnorm":
            return dict(kernel=lambda: k6._forward(x, w, 1e-6, pdl=False),
                        plain=lambda: rmsnorm_ref(x, w, 1e-6),
                        library=lambda: F.rms_norm(x, (d,), w, 1e-6),
                        nbytes=4 * (2 * rows * d + d), flops=4 * rows * d)
        dy = rand(gen, (rows, d))
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        with torch.enable_grad():
            y = F.rms_norm(xl, (d,), wl, 1e-6)
        return dict(kernel=lambda: k6.rmsnorm_bwd(x, w, dy, eps=1e-6),
                    plain=lambda: rmsnorm_bwd_ref(x, w, dy, 1e-6),
                    library=lambda: torch.autograd.grad(
                        y, (xl, wl), dy, retain_graph=True),
                    nbytes=4 * (3 * rows * d + 2 * d),
                    flops=11 * rows * d)
    b, hq, hkv, sq, sk, d = (call[k] for k in ("b", "hq", "hkv", "sq", "sk",
                                               "d"))
    causal, off, skv = call["causal"], call["q_offset"], call["sk_valid"]
    kw = dict(causal=causal, q_offset=off, sk_valid=skv)
    q = rand(gen, (b, hq, sq, d))
    k = rand(gen, (b, hkv, sk, d))
    v = rand(gen, (b, hkv, sk, d))
    vis = visible(sq, sk, causal, off, skv, DEV)
    pairs = int(vis.sum().item()) * b * hq
    kv_end = sk if skv is None else max(0, min(sk, skv))
    keys = min(kv_end, off + sq) if causal else kv_end
    plain_causal = causal and off == 0 and sq == sk and skv is None
    if kind == "flash_attention":
        flops = 4 * d * pairs
        return dict(
            kernel=lambda: k7._flash_forward(q, k, v, causal, off, skv,
                                             True),
            plain=lambda: flash_attention_ref(q, k, v, **kw, with_lse=True),
            library=_sdpa(q, k, v, None if plain_causal else vis,
                          plain_causal, hq // hkv),
            nbytes=4 * (2 * b * hq * sq * d + 2 * b * hkv * keys * d
                        + b * hq * sq), flops=flops, tc_flops=flops)
    out, lse = k7._flash_forward(q, k, v, causal, off, skv, True)
    dout = rand(gen, (b, hq, sq, d))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        mask = None if plain_causal else vis
        if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
            o = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, is_causal=plain_causal,
                enable_gqa=True)
        else:
            g = hq // hkv
            o = F.scaled_dot_product_attention(
                ql, kl.repeat_interleave(g, 1), vl.repeat_interleave(g, 1),
                attn_mask=mask, is_causal=plain_causal)
    # the gradient's own products, each once a visible pair: S = QK^T,
    # dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K (2 D flops each;
    # the kernel's two passes recompute S and dP, which is its cost, not
    # the work's), all of them f32 products the tensor cores can carry in
    # 3xTF32, as the forward's bound counts them
    flops = 10 * d * pairs
    return dict(
        kernel=lambda: k7.flash_attention_bwd(q, k, v, out, dout, lse, **kw),
        plain=lambda: flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw),
        library=lambda: torch.autograd.grad(o, (ql, kl, vl), dout,
                                            retain_graph=True),
        nbytes=4 * (3 * b * hq * sq * d + 2 * 2 * b * hkv * keys * d
                    + b * hq * sq), flops=flops, tc_flops=flops)


def _outs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def check_train_call(call: dict, gen, timing: bool) -> dict:
    """Hold a training-path call against its plain version (each output at
    ``BWD_TOL``), run it twice for the same bits, and time it if asked.
    A flash forward also runs without the log-sum-exp: the same output
    bits."""
    from repro_torch.kernels.util import cuda_time_ms
    case = _train_case(call, gen)
    got, again = _outs(case["kernel"]()), _outs(case["kernel"]())
    want = _outs(case["plain"]())
    torch.cuda.synchronize()
    err = rel = 0.0
    for a, b, c in zip(got, want, again):
        if a.shape != b.shape or not torch.equal(a, c):
            raise AssertionError(f"{call}: shapes {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}, or two runs differ")
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)):
            raise AssertionError(f"{call}: the kernel's infinities differ")
        e = (a - b)[fin].abs().max().item() if fin.any() else 0.0
        scale = b[fin].abs().max().item() if fin.any() else 0.0
        err = max(err, e)
        rel = max(rel, e / scale if scale else e)
        if not torch.allclose(a[fin], b[fin], rtol=BWD_TOL, atol=BWD_TOL):
            raise AssertionError(f"{call}: kernel disagrees with its plain "
                                 f"version, max |err| {e:.3e} (rtol = atol "
                                 f"= {BWD_TOL})")
    row = dict(call, max_abs_err=err, max_rel_err=rel)
    if timing:
        tc = case.get("tc_flops", 0)
        b_ms, b_by = bound_ms(case["nbytes"], case["flops"], tc)
        row.update(ms=cuda_time_ms(case["kernel"]),
                   plain_ms=cuda_time_ms(case["plain"]),
                   library_ms=cuda_time_ms(case["library"]),
                   bound_ms=b_ms, bound_by=b_by, bytes=case["nbytes"],
                   flops=case["flops"], tc_flops=tc)
    return row


def lse_bits(gen) -> int:
    """K7 flash's output with and without the log-sum-exp pointer, bit
    for bit, under every plan ``plan_flash`` weighs at the training path's
    shape and at edge shapes (a key split among them); returns the number
    of (shape, plan) pairs checked."""
    from repro_torch.kernels.attention import kernel as k7
    from repro_torch.kernels.attention.plan import flash_candidates
    shapes = [(TRAIN_BATCH, 14, 2, TRAIN_SEQ, TRAIN_SEQ, 64, True, 0, None),
              (2, 14, 2, 130, 130, 64, True, 0, None),
              (1, 4, 2, 37, 200, 64, True, 163, None),
              (1, 4, 2, 70, 70, 80, True, 0, 40),
              (2, 4, 2, 100, 100, 128, False, 0, None)]
    n = 0
    saved = k7.plan_flash
    try:
        for b, hq, hkv, sq, sk, d, causal, off, skv in shapes:
            q = rand(gen, (b, hq, sq, d))
            k = rand(gen, (b, hkv, sk, d))
            v = rand(gen, (b, hkv, sk, d))
            for _key, plan in flash_candidates(b, hq, hkv, sq, sk, d, causal,
                                               off, skv):
                k7.plan_flash = lambda *a, p=plan: p
                bare = k7._flash_forward(q, k, v, causal, off, skv, False)
                out, _ = k7._flash_forward(q, k, v, causal, off, skv, True)
                torch.cuda.synchronize()
                if not torch.equal(bare, out):
                    raise AssertionError(
                        f"K7 flash {(b, hq, hkv, sq, sk, d, causal, off, skv)}"
                        f" plan {plan}: the output differs with the "
                        f"log-sum-exp pointer")
                n += 1
    finally:
        k7.plan_flash = saved
    return n


def _finite_nonzero(grads) -> tuple[bool, bool]:
    from repro_torch.train.tree import leaves
    ls = leaves(grads)
    return (all(bool(torch.isfinite(g).all()) for g in ls),
            all(bool(g.any()) for g in ls))


def pass_ms(fn, reps: int = 20) -> dict[str, float]:
    """Device ms a call of each kernel that ``fn`` launches, by the
    kernel's name (``torch.profiler`` over ``reps`` calls after one
    warm-up): the passes of a wrapper that launches more than one."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        m = re.search(r"(\w+)(<\d+>)?\(", e.key)
        name = (m.group(1) + (m.group(2) or "")) if m else e.key
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def bwd_plan(call: dict) -> dict:
    """The plan a backward call at the path's shape runs."""
    from repro_torch.kernels.attention.plan import plan_flash_bwd
    from repro_torch.kernels.rmsnorm.kernel import bwd_blocks, bwd_vec
    if call["kernel"] == "rmsnorm_bwd":
        return dict(vec=bwd_vec(call["d"]),
                    blocks=bwd_blocks(call["rows"], call["d"]))
    return dataclasses.asdict(plan_flash_bwd(
        call["b"], call["hq"], call["hkv"], call["sq"], call["sk"],
        call["d"], call["causal"], call["q_offset"], call["sk_valid"]))


def train_kernels(gen) -> dict:
    """11(a): the backward kernels (and the forward as training launches
    it) against their plain versions, at the path's shapes (timed, each
    backward's passes apart under the profiler, with its plan) and the
    edges; the forward's output with and without its log-sum-exp."""
    from repro_torch.kernels.util import ptxas_report
    rows = {}
    for c in train_calls():
        r = rows[c["kernel"]] = check_train_call(c, gen, timing=True)
        print(f"[train] {r['kernel']:<21} {_shape_str(c):<40} ms "
              f"{r['ms']:.4f}  plain {r['plain_ms']:.4f}  library "
              f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})  err {r['max_abs_err']:.1e}")
        if c["kernel"] in ("rmsnorm_bwd", "flash_attention_bwd"):
            r["passes_ms"] = pass_ms(_train_case(c, gen)["kernel"])
            r["plan"] = bwd_plan(c)
            print(f"[train]   {c['kernel']} passes (profiler, ms a call): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in
                              r["passes_ms"].items()))
            print(f"[train]   {c['kernel']} plan: {r['plan']}")
    for c in train_edge_calls():
        r = check_train_call(c, gen, timing=False)
        print(f"[train] edge {r['kernel']:<21} {_shape_str(c):<40} err "
              f"{r['max_abs_err']:.1e}")
    n = lse_bits(gen)
    print(f"[train] the backward kernels agree with their plain versions "
          f"(rtol = atol = {BWD_TOL}) at {len(rows)} path calls and "
          f"{len(train_edge_calls())} edges, the same bits run twice; K7 "
          f"flash's output bit-equal with and without the log-sum-exp "
          f"under {n} (shape, plan) pairs")
    for name in ("rmsnorm", "flash_attention_bwd"):
        for line in ptxas_report(name):
            print(f"[train] ptxas {name}: {line}")
    return rows


def train_cli_run(cfg) -> dict:
    """11(b): ``launch/train.py`` (its ``run``, all of ``main`` but the
    exit code) at full width and depth, into a temporary directory."""
    import tempfile
    from repro_torch.launch import train as train_cli
    from repro_torch.lm.steps import state_shapes
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import leaves
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    try:
        reset_counts()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.run([
            "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--ckpt-every", str(TRAIN_STEPS), "--ckpt-dir", tmp,
            "--device", DEV])
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() - before
        per_step = train_per_step(cfg)
        check_counts("train run", launches, per_step, TRAIN_STEPS)
        losses = [m["loss"] for m in runner.metrics_log]
        walls = [m["step_time_s"] for m in runner.metrics_log]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train run: losses {losses}")
        back = ckpt.restore(tmp, state_shapes(cfg), device=DEV)
        same = all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                     leaves(runner.state)))
        if not same:
            raise AssertionError("train run: the step-8 checkpoint differs "
                                 "from the live state")
        del back
        tokens = TRAIN_BATCH * TRAIN_SEQ
        steady = float(np.median(walls[1:]))
        for i, (l, w) in enumerate(zip(losses, walls)):
            print(f"[train] step {i + 1}: loss {l:.5f}  wall {w * 1e3:.1f} "
                  f"ms")
        for sv in runner.saves:
            print(f"[train] checkpoint at step {sv['step']}: "
                  f"{sv['bytes'] / 1e9:.3f} GB in {sv['seconds']:.2f} s of "
                  f"host")
        print(f"[train] {cfg.name} full width and depth, {TRAIN_STEPS} "
              f"steps of {TRAIN_BATCH} x {TRAIN_SEQ}: {tokens / steady:.0f} "
              f"tokens/s at the median step ({steady * 1e3:.1f} ms; "
              f"{tokens * len(walls) / sum(walls):.0f} over all steps), "
              f"peak {peak / 1e9:.2f} GB allocated, the run {wall:.1f} s; "
              f"launches a step {per_step} as planned; the step-8 "
              f"checkpoint restored bit-equal to the live state")
        from repro_torch.launch.dryrun import dry_step
        dry = dry_step(cfg, "train", TRAIN_SEQ, TRAIN_BATCH,
                       microbatches=1)
        mem = dry_vs_card(f"{cfg.name} train step, {TRAIN_BATCH} x "
                          f"{TRAIN_SEQ}, one microbatch",
                          dry["peak_bytes"], peak)
        return dict(losses=losses, step_s=walls, tokens_per_s=tokens / steady,
                    peak_bytes=peak, saves=runner.saves, wall_s=wall,
                    launches=launches, per_step=per_step, memory=mem)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_vs_plain(cfg) -> dict:
    """11(c): the run's first step (seed-0 state, the step-0 batch) with
    the kernels and with the plain versions on the card (autograd through
    them): loss, gradient norm and every leaf's gradient."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.lm.model import load_params
    from repro_torch.lm.steps import batch_to, loss_and_grads
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.tree import leaves
    params = load_params(cfg, 0, DEV)
    batch = batch_to(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH)).batch_at(0), torch.device(DEV))
    loss, grads = loss_and_grads(params, cfg, batch)
    finite, nonzero = _finite_nonzero(grads)
    if not (finite and nonzero):
        raise AssertionError(f"train step: gradients finite {finite}, "
                             f"every leaf nonzero {nonzero}")
    with plain_kernels():
        ploss, pgrads = loss_and_grads(params, cfg, batch)
    gn, pgn = float(global_norm(grads)), float(global_norm(pgrads))
    worst = max((g - p).abs().max().item() / p.abs().max().item()
                for g, p in zip(leaves(grads), leaves(pgrads)))
    rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    print(f"[train] first step on the card, kernels against plain versions: "
          f"loss {float(loss):.7f} vs {float(ploss):.7f} (rel {rel:.1e}), "
          f"grad norm {gn:.6f} vs {pgn:.6f} (rel {abs(gn - pgn) / pgn:.1e}),"
          f" worst leaf |diff| / max|grad| {worst:.1e}; every leaf's "
          f"gradient finite and nonzero")
    if rel > TRAIN_LOSS_RTOL or abs(gn - pgn) > TRAIN_GNORM_RTOL * pgn \
            or worst > TRAIN_GRAD_SHARE:
        raise AssertionError(f"train step: kernels against plain versions "
                             f"past loss rtol {TRAIN_LOSS_RTOL}, grad norm "
                             f"rtol {TRAIN_GNORM_RTOL} or leaf share "
                             f"{TRAIN_GRAD_SHARE}")
    return dict(loss=float(loss), plain_loss=float(ploss), grad_norm=gn,
                plain_grad_norm=pgn, worst_share=worst)


def train_recovery() -> dict:
    """11(d): recovery on the card at the smoke config: a clean run and
    one that faults at step 6 (checkpoints every 4, 8 steps)."""
    import tempfile
    from repro_torch.configs.registry import get_smoke
    from repro_torch.train.runner import (FaultInjector, RunnerConfig,
                                          TrainRunner)
    from repro_torch.train.tree import leaves
    cfg = get_smoke(TRAIN_ARCH)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_recovery_", dir=ROOT / "build")
    try:
        outs, runners = [], []
        for name, fault in (("clean", None), ("faulted", FaultInjector(
                fail_at=(RECOVERY["fail_at"],)))):
            r = TrainRunner(cfg, RunnerConfig(
                ckpt_dir=f"{tmp}/{name}", ckpt_every=RECOVERY["ckpt_every"],
                max_steps=RECOVERY["steps"]), fault_injector=fault,
                device=DEV)
            outs.append(r.run())
            runners.append(r)
        clean, faulted = outs
        if faulted["recoveries"] != 1 or not np.isclose(
                faulted["final_loss"], clean["final_loss"], rtol=1e-6,
                atol=0):
            raise AssertionError(f"recovery: {faulted['recoveries']} "
                                 f"recoveries, final loss "
                                 f"{faulted['final_loss']} vs "
                                 f"{clean['final_loss']}")
        bits = faulted["final_loss"] == clean["final_loss"] and all(
            torch.equal(a, b) for a, b in zip(leaves(runners[0].state),
                                              leaves(runners[1].state)))
        print(f"[train] recovery at {cfg.name}: a fault at step "
              f"{RECOVERY['fail_at']}, 1 recovery, final loss "
              f"{faulted['final_loss']:.7f} vs {clean['final_loss']:.7f} "
              f"clean (rtol 1e-6); the final state and loss bit-equal: "
              f"{bits}")
        return dict(final_loss=faulted["final_loss"],
                    clean_loss=clean["final_loss"], bits_equal=bits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_path() -> dict:
    """Phase 11: training, every earlier phase's tensors freed first."""
    from repro_torch.configs.registry import get_arch
    t0 = time.perf_counter()
    free_card("before phase 11")
    gen = np.random.default_rng(11)
    cfg = get_arch(TRAIN_ARCH)
    rows = train_kernels(gen)
    free_card("after 11(a)")
    run = train_cli_run(cfg)
    free_card("after 11(b)")
    plain = train_vs_plain(cfg)
    free_card("after 11(c)")
    recovery = train_recovery()
    free_card("after phase 11")
    per_step = run["per_step"]
    kernels = {}
    for name, r in rows.items():
        n = per_step[name]
        kernels[name] = dict(
            calls=n, max_abs_err=r["max_abs_err"],
            **{k: n * r[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bytes", "flops", "tc_flops")},
            partition_ms=n * r["ms"])
    print(f"[train] {time.perf_counter() - t0:.1f} s")
    return dict(model=f"{TRAIN_ARCH} train", launches=run.pop("launches"),
                kernels=kernels, run=run, plain=plain, recovery=recovery,
                rows=list(rows.values()))


# --------------------------------------------------------------------------
# phase 12: the plan cache on the card
# --------------------------------------------------------------------------
def cache_streams() -> list[tuple[str, torch.cuda.Stream]]:
    """The streams phase 12 tunes under: the whole card's, then each
    core's of the split at ``SPLIT_THETA``, labelled by their SMs."""
    from repro_torch.kernels.green import split_sms
    from repro_torch.kernels.util import resolve_device
    split = split_sms(resolve_device(DEV), SPLIT_THETA)
    return [(f"sms{split.total}", torch.cuda.current_stream()),
            *((f"sms{split.sms(c)} ({c})", split.parts[c].stream)
              for c in "cp")]


def cache_row(at, sig, tag: str) -> dict:
    """One signature's sweep on one SM count, from its cache entry: the
    planner's pick's and the winner's device µs (best of its runs), the
    candidates that beat the pick, and the runs' spread (the largest
    (max - min) / min of a candidate's runs)."""
    entry = at.load_cache()["entries"][sig.entry_key(tag)]
    runs = entry["candidates_us"]
    if None in runs:
        raise AssertionError(f"cache: a candidate of {sig.entry_key(tag)} "
                             f"failed: {runs}")
    pick, best = min(runs[0]), entry["us"]
    spread = max((max(r) - min(r)) / min(r) for r in runs)
    return dict(key=sig.key(), kind=sig.kind, tag=tag, pick_us=pick,
                best_us=best, candidates=len(entry["candidates_us"]),
                beat=sum(min(r) < pick for r in runs), spread=spread,
                won=entry["config"] != at.heuristic_config(sig),
                beyond_noise=(pick - best) / pick > spread)


def cache_sweep(at, sigs) -> dict:
    """12(a), (b): every signature tuned on each SM count, rows printed one
    a signature with the three counts side by side."""
    rows: dict[str, list[dict]] = {}
    for label, stream in cache_streams():
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            tag = at.device_tag(DEV)
            for sig in sigs:
                at.tune_layer(sig, device=DEV, reps=CACHE_REPS)
            stream.synchronize()
            rows[label] = [cache_row(at, s, tag) for s in sigs]
        print(f"[cache] tuned {len(sigs)} signatures on {label}, "
              f"{CACHE_REPS} runs of {at.CALLS} calls a candidate, in "
              f"{time.perf_counter() - t0:.1f} s")
    for i, sig in enumerate(sigs):
        print(f"[cache] {sig.entry_key('')[:-1]}: " + " | ".join(
            f"{label.split()[0]} pick {r[i]['pick_us']:.3f} best "
            f"{r[i]['best_us']:.3f} us, {r[i]['beat']} of "
            f"{r[i]['candidates'] - 1} beat it, spread "
            f"{100 * r[i]['spread']:.1f}%" for label, r in rows.items()))
    summary = {}
    for label, r in rows.items():
        kinds = {}
        for kind in dict.fromkeys(x["kind"] for x in r):
            mine = [x for x in r if x["kind"] == kind]
            kinds[kind] = dict(
                signatures=len(mine),
                pick_ms=sum(x["pick_us"] for x in mine) / 1e3,
                cached_ms=sum(x["best_us"] for x in mine) / 1e3,
                won=sum(x["won"] for x in mine),
                beyond_noise=sum(x["beyond_noise"] for x in mine))
        summary[label] = kinds
        print(f"[cache] {label}: " + "; ".join(
            f"{k} {v['signatures']} signatures, pick {v['pick_ms']:.4f} "
            f"ms, cached {v['cached_ms']:.4f} ms, a candidate won "
            f"{v['won']} ({v['beyond_noise']} beyond the runs' spread)"
            for k, v in kinds.items()))
    return dict(rows=rows, summary=summary)


def cache_serve(at, model: str, gen, cache: str, empty: str) -> dict:
    """12(c): ``model``'s ``balanced`` serving path without the cache, then
    with it on graphs and split cores (and eagerly, where every K1-K5
    call resolves a plan) and on shared cores: every lookup a hit, every
    output bit-equal to the uncached run's; a request's lane device ms
    with and without the cache, in turns."""
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.dualcore.runtime import DualCoreRunner, DualCores
    from repro_torch.models.cnn import build_model
    from repro_torch.kernels.util import resolve_device
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine
    params, _, graph = build_model(model, seed=0, device=DEV)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), SCHEME)
    images = [rand(gen, (BATCH, IMAGE, IMAGE, 3)) for _ in range(REQUESTS)]
    dev = resolve_device(DEV)

    def served(path: str, **kw):
        os.environ[at.CACHE_ENV] = path
        at.reset_lookups()
        r = DualCoreRunner(model, params, sched, device=DEV,
                           theta=SPLIT_THETA, **kw)
        r.run_pipelined(images)                 # warm: lanes captured
        reset_counts()
        res = replay(DualCoreEngine(r), [Request(x) for x in images])
        launches = sum(launch_counts()[k] for k in CNN_KERNELS)
        return r, res.outputs, dict(at.LOOKUPS), launches

    plain, want, _, _ = served(empty)
    runs = {"graphs split": served(cache),
            "eager split": served(cache, jit_groups=False),
            "graphs shared": served(cache, cores=DualCores(
                dev, sm_split=False))}
    out = {}
    for name, (r, outs, lookups, launches) in runs.items():
        if lookups["miss"] or not lookups["hit"]:
            raise AssertionError(f"cache: {model} on {name}: lookups "
                                 f"{lookups}, every one should hit")
        if name.startswith("eager") and lookups["hit"] != 2 * launches:
            raise AssertionError(f"cache: {model} eager: {lookups['hit']} "
                                 f"hits for {launches} served launches "
                                 f"and as many warm ones")
        for i, (a, b) in enumerate(zip(outs, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"cache: {model} request {i} on "
                                     f"{name} differs from the uncached "
                                     f"run")
        out[name] = dict(lookups=lookups, launches=launches)
    lane = {"without": [], "with": []}
    for name in ("without", "with", "with", "without"):       # in turns
        r = plain if name == "without" else runs["graphs split"][0]
        lane[name].append(lane_device_ms(r))
    print(f"[cache] {model}: every K1-K5 lookup hit ("
          + ", ".join(f"{n} {v['lookups']['hit']}"
                      for n, v in out.items())
          + f"; eager: {out['eager split']['launches']} served launches, "
          f"as many warm); outputs bit-equal to the uncached run on split "
          f"and shared cores; a request's lane device ms without the cache "
          + ", ".join(f"{t:.4f}" for t in lane["without"]) + ", with "
          + ", ".join(f"{t:.4f}" for t in lane["with"]))
    return dict(runs=out, lane_device_ms=lane)


def cache_refuses(at) -> str:
    """12(d): a config planted outside its signature's candidates makes
    the lookup raise, naming the entry."""
    from repro_torch.kernels.util import resolve_device
    sig = at.LayerSig("pointwise", 56, 56, 64, 128, N=BATCH)
    tag = at.device_tag(DEV)
    data = at.load_cache()
    key = sig.entry_key(tag)
    kept = data["entries"].get(key)
    bad = dict(at.heuristic_config(sig), bm=48)
    data["entries"][key] = {"config": bad, "us": 1.0, "backend": tag}
    at.save_cache(data)
    try:
        at.resolve(sig, resolve_device(DEV))
    except ValueError as err:
        if key not in str(err):
            raise AssertionError(f"cache: the refusal does not name {key}: "
                                 f"{err}") from err
        msg = str(err)
    else:
        raise AssertionError(f"cache: a planted config {bad} was launched")
    finally:
        if kept is None:
            del data["entries"][key]
        else:
            data["entries"][key] = kept
        at.save_cache(data)
    print(f"[cache] a planted config outside the candidates raised: {msg}")
    return msg


def cache_path_run() -> dict:
    """Phase 12: the plan cache on the card, in a temporary file."""
    import tempfile
    from repro_torch.kernels import autotune as at
    t0 = time.perf_counter()
    free_card("before phase 12")
    before = os.environ.get(at.CACHE_ENV)
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_plans_"))
    cache, empty = str(tmp / "plans.json"), str(tmp / "none.json")
    os.environ[at.CACHE_ENV] = cache
    at.clear_memory_cache()
    try:
        sigs = at.zoo_signatures(IMAGE, SERVED, BATCH)
        print(f"[cache] {len(sigs)} signatures of the zoo's programs and "
              f"group-fused plans at {IMAGE} px, batch {BATCH} "
              f"({time.perf_counter() - t0:.1f} s on the host)")
        sweep = cache_sweep(at, sigs)
        gen = np.random.default_rng(12)
        serve = {m: cache_serve(at, m, gen, cache, empty) for m in SERVED}
        os.environ[at.CACHE_ENV] = cache
        at.clear_memory_cache()
        refusal = cache_refuses(at)
    finally:
        if before is None:
            os.environ.pop(at.CACHE_ENV, None)
        else:
            os.environ[at.CACHE_ENV] = before
        at.clear_memory_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[cache] {time.perf_counter() - t0:.1f} s")
    return dict(signatures=len(sigs), sweep=sweep, serve=serve,
                refusal=refusal)


# --------------------------------------------------------------------------
# phase 13: EfficientNet-B4 at the benchmark cell's shapes
# --------------------------------------------------------------------------
def effnet_edge_calls() -> list[dict]:
    """Edges beside B4's path calls: sigmoid on K1, K2 and K3 (the path
    runs it only inside the SE gate), silu without bias, K2's 5x5 window
    on ragged tails, and the SE kernels on channels that are no multiple
    of 4 (their float path) with a cluster of one."""
    return [
        dict(kernel="matmul_bias_act", m=130, k=45, n=129, act="sigmoid"),
        dict(kernel="matmul_bias_act", m=77, k=13, n=70, act="silu",
             bias=False),
        dict(kernel="depthwise_conv2d", n=2, h=13, w=11, c=40, k=5,
             stride=2, pad=2, act="sigmoid"),
        dict(kernel="depthwise_conv2d", n=1, h=10, w=13, c=64, k=5,
             stride=1, pad=2, act="silu", bias=False),
        dict(kernel="conv2d_implicit_gemm", n=2, h=15, w=13, ci=5, co=70,
             k=3, stride=2, pad=1, act="sigmoid"),
        dict(kernel="se_gate", n=2, h=9, w=7, c=37, s=9),
        dict(kernel="se_scale", n=2, h=9, w=7, c=37),
    ]


def effnet_path(gen) -> tuple[dict, dict]:
    """EfficientNet-B4 served as the benchmark cell serves it: batch 16
    at 380 px, ``balanced``, compiled groups on the measured split.
    Returns the path's numbers and its kernel rows (by call)."""
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.dualcore.program import build_program
    from repro_torch.dualcore.runtime import DualCoreRunner
    from repro_torch.models.cnn import build_model
    from repro_torch.obs import Registry
    from repro_torch.serving.api import Request, replay
    from repro_torch.serving.cnn import DualCoreEngine

    t0 = time.perf_counter()
    tag = f"[{EFFNET}]"
    torch.cuda.reset_peak_memory_stats()
    params, _, graph = build_model(EFFNET, seed=0, device="cuda")
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), SCHEME)
    runner = DualCoreRunner(EFFNET, params, sched, device="cuda")
    calls = plan_calls(runner.plan, graph, EFFNET_BATCH)
    cores = plan_cores(runner.plan, graph)
    per_request = dict(Counter(c["kernel"] for c in calls))
    shape = (EFFNET_BATCH, EFFNET_IMAGE, EFFNET_IMAGE, 3)
    images = [rand(gen, shape) for _ in range(EFFNET_REQUESTS)]
    # warm-up, untimed: the split measured, the lanes the traffic holds
    runner.run_pipelined(images)
    split = runner.cores.split
    print(f"{tag} {SCHEME}: {len(runner.groups)} exec groups "
          f"{''.join(g.core for g in runner.groups)}, the measured split c "
          f"{split.sms('c')} / p {split.sms('p')} SMs; launches per request "
          f"{per_request}")

    # the sequential kernel forward against the all-plain forward
    x = rand(gen, shape)
    plain_out = build_program(EFFNET, plain=True).run(params, x)
    reset_counts()
    (seq_out,) = runner.run_sequential([x])
    check_counts(f"{EFFNET} forward", launch_counts(), per_request)
    err = (seq_out - plain_out).abs().max().item()
    rel = err / plain_out.pow(2).mean().sqrt().item()
    if not rel <= FORWARD_TOL:
        raise AssertionError(f"{EFFNET}: kernel forward disagrees with the "
                             f"plain forward: max |err| {err:.3e}, "
                             f"{rel:.3e} of the logits' RMS")
    print(f"{tag} kernel forward vs plain forward: max |err| {err:.2e}, "
          f"{rel:.2e} of the logits' RMS (tol {FORWARD_TOL}: 161 f32 "
          f"layers, each at 1e-4 against its plain version, compound)")

    # serving: the engine over the two cores, launches counted
    seq = runner.run_sequential(images)
    eng = DualCoreEngine(runner, obs=Registry())
    reset_counts()
    res = replay(eng, [Request(im) for im in images])
    served = launch_counts()
    check_counts(f"{EFFNET} serving", served, per_request, EFFNET_REQUESTS)
    for i, (a, b) in enumerate(zip(res.outputs, seq)):
        if not torch.equal(a, b):
            raise AssertionError(f"{EFFNET} request {i}: the engine differs "
                                 f"from the sequential kernel forward")
    gates = eng.snapshot()["gauges"]["runner_se_gates"]["series"]
    if sum(gates.values()) != 32:
        raise AssertionError(f"{EFFNET}: runner_se_gates {gates}")
    nodes = group_nodes(runner, graph, tag, EFFNET_BATCH)
    lanes = [ln for v in runner.lanes.lanes.values() for ln in v]
    wall = res.stats["wall_s"]
    print(f"{tag} {EFFNET_REQUESTS} requests x batch {EFFNET_BATCH} @ "
          f"{EFFNET_IMAGE}px on graphs in {res.stats['slots']} slots: "
          f"{wall * 1e3:.2f} ms, {EFFNET_REQUESTS * EFFNET_BATCH / wall:.1f} "
          f"img/s (a ramp, not the cell's rate); outputs bit-equal to the "
          f"sequential kernel forward; launches {served} (reset just before "
          f"the engine's run); runner_se_gates {gates}; {len(lanes)} lanes "
          f"of {sum(ln.nbytes for ln in lanes) / len(lanes) / 2 ** 30:.2f} "
          f"GiB; group {nodes['group']} ({nodes['steps']} steps) has kernel "
          f"nodes {nodes['kernel_nodes']} (the plan's) and "
          f"{nodes['other_kernel_nodes']} of PyTorch's")

    # every distinct call against its plain version, timed on the whole
    # card and on its core's partition of the measured split
    distinct: dict[str, tuple[dict, set]] = {}
    for c, core in zip(calls, cores):
        distinct.setdefault(json.dumps(c, sort_keys=True), (c, set()))[1].add(
            core)
    rows = {}
    for key, (c, on) in distinct.items():
        r = rows[key] = check_and_time(
            c, gen, timing=True, parts={k: split.parts[k] for k in sorted(on)})
        plan = "" if "plan" not in r else "  plan " + plan_str(r["plan"])
        own = "".join(f"  {k}-core {r[k + '_ms']:.4f}" for k in sorted(on))
        print(f"{tag} kernel {r['kernel']:<21} {_shape_str(c):<40} ms "
              f"{r['ms']:.4f}{own}  plain {r['plain_ms']:.4f}  library "
              f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})  err {r['max_abs_err']:.1e}{plan}")
    for c in effnet_edge_calls():
        r = check_and_time(c, gen, timing=False)
        print(f"{tag} edge {r['kernel']:<21} {_shape_str(c):<40} err "
              f"{r['max_abs_err']:.1e}")
    sums = kernel_sums(rows, calls, cores)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} every kernel agrees with its plain version (rtol = atol "
          f"= {KERNEL_TOL}) at the path's {len(rows)} distinct calls and "
          f"{len(effnet_edge_calls())} edges; device ms a request "
          f"{sum(v['ms'] for v in sums.values()):.4f} over {len(calls)} "
          f"launches; peak memory {peak / 1e9:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(model=EFFNET, batch=EFFNET_BATCH, image=EFFNET_IMAGE,
                groups=len(runner.groups), c_sms=split.sms("c"),
                per_request=per_request, launches=served, kernels=sums,
                forward_max_abs_err=err, forward_rel_err=rel, wall_s=wall,
                se_gates=gates, group_nodes=nodes, lanes=len(lanes),
                peak_bytes=peak), rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv: list[str] | None = None) -> int:
    """Run the phases; return the exit code."""
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the port.")
    ap.add_argument("--only", choices=("effnet",), default=None,
                    help="run the setup, the one phase named (effnet: "
                         "phase 13) and the report alone")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s: dict[str, float] = {}          # host seconds of the phases

    def mark(phase: str) -> None:
        phase_s[phase] = time.perf_counter() - t_start - sum(
            phase_s.values())

    from repro_torch.kernels.autotune import CACHE_ENV
    from repro_torch.kernels.green import split_sms
    from repro_torch.kernels.util import (ptxas_report, resolve_device,
                                          timed_build)
    # phases 1-11 launch the planner's picks, whatever plan cache the
    # checkout holds (the worker processes of phase 7 inherit this);
    # phase 12 points the cache at a file of its own
    os.environ[CACHE_ENV] = os.devnull

    # 1. setup ------------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[setup] nvidia-smi: {card}")
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {kind}, {torch.cuda.device_count()} device(s)")
    print(f"[setup] kernels built and loaded in {timed_build():.1f} s")
    for name in PTXAS_SOURCES:
        for line in ptxas_report(name):
            print(f"[setup] ptxas {name}: {line}")
    mark("1")
    if only == "effnet":
        effnet, effnet_rows = effnet_path(np.random.default_rng(0))
        mark("13")
        return report(card, kind, t_start, phase_s, [effnet],
                      dict(effnet=effnet,
                           effnet_rows=list(effnet_rows.values())))

    # 2. kernels ----------------------------------------------------------
    gen = np.random.default_rng(0)
    distinct: dict[str, dict] = {}
    for c in path_call_list():
        distinct.setdefault(json.dumps(c, sort_keys=True), c)
    split = split_sms(resolve_device(DEV), SPLIT_THETA)
    cores_of = path_cores()
    print(f"[kernels] each path call also on its core's partition of the "
          f"split at theta {SPLIT_THETA} (c {split.sms('c')} SMs, p "
          f"{split.sms('p')}), its output bit-equal to the whole card's")
    rows = {}
    for key, c in distinct.items():
        parts = {core: split.parts[core] for core in
                 sorted(cores_of.get(key, ()))}
        rows[key] = check_and_time(c, gen, timing=True, parts=parts)
        r = rows[key]
        plan = "" if "plan" not in r else "  plan " + plan_str(r["plan"])
        after = ("" if "after_ms" not in r
                 else f"  after its producer {r['after_ms']:.4f}")
        own = "".join(f"  {core}-core {r[core + '_ms']:.4f}"
                      for core in parts)
        print(f"[kernels] {r['kernel']:<21} "
              f"{_shape_str(c):<40} ms {r['ms']:.4f}{own}{after}  plain "
              f"{r['plain_ms']:.4f}  library {r['library_ms']:.4f}  bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})  err "
              f"{r['max_abs_err']:.1e}{plan}")
    geometry = {}
    for c in lm_geometry_calls():
        r = geometry[json.dumps(c, sort_keys=True)] = check_and_time(
            c, gen, timing=True)
        plan = "" if "plan" not in r else "  plan " + plan_str(r["plan"])
        print(f"[kernels] geometry {r['kernel']:<16} {_shape_str(c):<40} ms "
              f"{r['ms']:.4f}  plain {r['plain_ms']:.4f}  library "
              f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})  err {r['max_abs_err']:.1e}{plan}")
    former = {}
    for c in lm_decode_calls(LM_BATCH * max(lm_group_sizes()), whole=False):
        former[json.dumps(c, sort_keys=True)] = check_and_time(c, gen,
                                                               timing=True)
    print(f"[kernels] K7 decode also cut to the filled prefix (the former "
          f"path's calls): {len(former)} shapes checked and timed")
    edges = (edge_calls() + lm_edge_calls() + lm_geometry_edge_calls()
             + block_edge_calls())
    for c in edges:
        r = check_and_time(c, gen, timing=False)
        plan = "" if "plan" not in r else "  plan " + plan_str(r["plan"])
        print(f"[kernels] edge {r['kernel']:<21} {_shape_str(c):<40} err "
              f"{r['max_abs_err']:.1e}{plan}")
    print(f"[kernels] all kernels agree with their plain versions "
          f"(rtol = atol = {KERNEL_TOL}) at {len(rows)} path shapes (phase "
          f"10's {len(block_calls())} among them), "
          f"{len(geometry)} head geometries and {len(edges)} edge cases")
    int8_rows = int8_kernels(gen)
    mark("2")

    # 3. paths ------------------------------------------------------------
    paths = [serve_path(model, gen, rows) for model in SERVED]
    served = {p["model"]: p for p in paths}
    paths.append(fused_forward_path(gen, rows))
    mark("3")

    # 4. fleet ------------------------------------------------------------
    paths.append(fleet_path(served))
    mark("4")

    # 5. lm ---------------------------------------------------------------
    lm = lm_path(rows, former)
    paths.append(lm)
    granite = granite_path()
    mark("5")

    # 6. split ------------------------------------------------------------
    lm_keep = lm.pop("keep")
    split = split_path(served, lm_keep)
    mark("6")

    # 7. workers ----------------------------------------------------------
    workers = workers_path(served)
    mark("7")

    # 8. control ----------------------------------------------------------
    control = control_path(served, lm_keep)
    mark("8")
    for p in served.values():
        del p["io"], p["runner"]
    del lm_keep

    # 9. design -----------------------------------------------------------
    design = design_path(int8_rows)
    paths.append(design["big"].pop("int8"))
    mark("9")

    # 10. blocks ----------------------------------------------------------
    blocks = blocks_path(rows)
    paths += blocks
    mark("10")

    # 11. train -----------------------------------------------------------
    train = train_path()
    paths.append(train)
    mark("11")

    # 12. cache -----------------------------------------------------------
    cache = cache_path_run()
    mark("12")

    # 13. effnet ----------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    effnet, effnet_rows = effnet_path(gen)
    paths.append(effnet)
    mark("13")

    # 14. report ----------------------------------------------------------
    return report(card, kind, t_start, phase_s, paths, dict(
        rows=list(rows.values()), geometry_rows=list(geometry.values()),
        former_decode_rows=list(former.values()),
        granite=granite, split=split, workers=workers,
        control=control, design=design, blocks=blocks,
        train={k: v for k, v in train.items() if k != "kernels"},
        cache=cache, effnet_rows=list(effnet_rows.values())))


def report(card: str, kind: str, t_start: float, phase_s: dict,
           paths: list[dict], doc: dict) -> int:
    """The last phase: ``chiprun_out/chip_smoke.json`` (``doc``, the
    paths, the phases' seconds and the kernels), a line for each path
    and kernel, the kernels' JSON line, the card line and the final
    ``{"ok": true, ...}`` line.  A kernel that no path ran (the phases
    that ran were chosen by ``--only``) has no row."""
    kernels = []
    for name, kt in kernel_table().items():
        mine = [p["kernels"][name] for p in paths if name in p["kernels"]]
        if not mine:
            continue
        b_ms, b_by = bound_ms(*(sum(r[k] for r in mine)
                                for k in ("bytes", "flops", "tc_flops")))
        kernels.append(dict(
            name=name, route="cuda", source=kt["source"],
            replaces=kt["replaces"],
            launches=sum(p["launches"].get(name, 0) for p in paths),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine),
            partition_ms=sum(r["partition_ms"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=_sum_or_none(r["library_ms"] for r in mine)))
        if name in INT8_KERNELS:
            kernels[-1].update(
                bound_ms=sum(r["bound_ms"] for r in mine),
                bound_by=mine[0]["bound_by"],
                flips=sum(r["flips"] for r in mine),
                rows=sum(r["rows"] for r in mine))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, device=kind, torch=torch.__version__, paths=paths,
        **doc, phase_s=phase_s, kernels=kernels), indent=1))
    for p in paths:
        name = p["model"] + (" fuse=True" if p.get("fuse") else "")
        for kname, v in p["kernels"].items():
            b_ms, b_by = (
                (v["bound_ms"], v["bound_by"]) if "bound_ms" in v
                else bound_ms(v["bytes"], v["flops"], v["tc_flops"]))
            lib = ("none" if v["library_ms"] is None
                   else f"{v['library_ms']:.4f}")
            print(f"[report] {name}: {kname} launches {p['launches'][kname]}"
                  f", calls a request {v['calls']:g}, ms {v['ms']:.4f} "
                  f"(on its cores' partitions {v['partition_ms']:.4f}), "
                  f"bound {b_ms:.5f} ({b_by}), plain {v['plain_ms']:.4f}, "
                  f"library {lib}, err {v['max_abs_err']:.1e}")
    print(f"[report] ms / plain_ms / bound_ms / library_ms are sums over one "
          f"request (batch {BATCH}, {IMAGE}px; {EFFNET}'s batch "
          f"{EFFNET_BATCH}, {EFFNET_IMAGE}px) of each path that launches "
          f"the kernel (an LM request: its prefill and its share of its "
          f"decode group's steps; Whisper's and Qwen2-VL's whole phase-10 "
          f"run; training: one step of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens), ms on all of the card's SMs, "
          f"partition_ms each call on its core's partition of the split at "
          f"theta {SPLIT_THETA} (the fuse=True forward's and training's "
          f"on the whole card; {EFFNET}'s on the measured split); launches "
          f"are phases 3-5's, 10's, 11's and 13's counted runs; "
          f"{time.perf_counter() - t_start:.1f} s total (phases "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()) + " s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _sum_or_none(values) -> float | None:
    """The sum, or None where a value is None (no library call)."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def path_call_list() -> list[dict]:
    """Every kernel call of one request of each path, in path order: the
    CNN paths' (``cnn_path_calls``), then the LM's at each planned decode
    group size, then phase 10's (``block_calls``)."""
    calls = cnn_path_calls()
    for size in sorted(set(lm_group_sizes())):
        calls += [c for c, _ in lm_request_calls(size)]
    return calls + block_calls()


def cnn_path_calls() -> list[dict]:
    """Every kernel call of one request of each CNN path, in path order."""
    return [c for calls in cnn_paths().values() for c in calls]


def path_cores() -> dict[str, set[str]]:
    """The cores each distinct path call runs on in phases 3 and 5, by the
    call's key: a CNN exec group's core, the LM's prefill on the c-core
    and its decode steps on the p-core.  The ``fuse=True`` forward's calls
    run on the whole card and are not in it."""
    out: dict[str, set[str]] = {}
    pairs = []
    for model in SERVED:
        plan, graph = served_plan(model)
        pairs += zip(plan_calls(plan, graph, BATCH), plan_cores(plan, graph))
    for size in sorted(set(lm_group_sizes())):
        pairs += zip((c for c, _ in lm_request_calls(size)),
                     lm_request_cores(size))
    for c, core in pairs:
        out.setdefault(json.dumps(c, sort_keys=True), set()).add(core)
    return out


def plan_cores(plan, graph) -> list[str]:
    """The core of each of ``plan_calls(plan, graph, ...)``: its exec
    group's."""
    return [g.core for g in plan.groups
            for _ in step_calls(g.steps, graph, 1)]


def served_plan(model: str):
    """The exec plan and layer graph of ``model`` under ``SCHEME``."""
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.dualcore.program import build_program
    from repro_torch.dualcore.runtime import build_exec_plan
    from repro_torch.models.zoo import get_graph
    graph = get_graph(model)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), SCHEME)
    return (build_exec_plan(build_program(model), sched, group_fusion=True),
            graph)


def cnn_paths() -> dict[str, list[dict]]:
    """Each CNN path's kernel calls for one request: the three CNNs under
    ``balanced``, then MobileNet v2's ``fuse=True`` forward."""
    from repro_torch.dualcore.program import build_program
    from repro_torch.models.zoo import get_graph
    paths = {}
    for model in SERVED:
        plan, graph = served_plan(model)
        paths[f"{model} {SCHEME}"] = plan_calls(plan, graph, BATCH)
    paths[f"{FUSED} fuse=True"] = step_calls(
        build_program(FUSED, fuse=True).steps,
        get_graph(FUSED), BATCH)
    return paths


def _shape_str(c: dict) -> str:
    keys = [k for k in ("m", "k", "n", "h", "w", "c", "ci", "cm", "co",
                        "stride", "res", "rows", "d", "b", "hq", "hkv",
                        "sq", "sk", "q_offset", "sk_valid", "kv_len")
            if k in c and c[k] is not None]
    return " ".join(f"{k}={c[k]}" for k in keys)


if __name__ == "__main__":
    sys.exit(main())
