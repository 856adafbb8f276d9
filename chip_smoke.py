#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and versions;
2. build the CUDA sources in ``src/repro_torch/csrc`` (timed, one nvcc
   per source, all in parallel);
3. time ``encode_delta``, ``decode_apply_ring`` and ``decode_apply_plan``
   as a caller sees them (host clock to a synchronize) and list the
   device operations each makes, by the profiler and by capturing one
   call in a CUDA graph (first, while the process is fresh: the
   profiler's traces lose kernels later on the card's machine); by the
   graph, ``encode_delta`` must copy only on the device, and each decode
   must be one device operation, its kernel;
4. time the floor of the event times (one launch that moves 4 bytes);
   hold every kernel against its plain PyTorch version on the card at the
   shapes its path gives it — B1, B2, B4 and B5 at the quickstart's wire
   shapes (2NN, m=16, ring) at 2, 4, 8 and 16 bits (B1 and B4 keyed,
   drawing their own noise, against ``noise_stacked`` + the plain
   version, and with tensor noise), B3 over all six leaves in one launch
   and on a misaligned view, B6-B8 on one client's flat 2NN vector (B6
   keyed and B8 at 2, 4, 8 and 16 bits; B7 at 2, 4, 8 and 16 bits and
   K = 1, 3, 5 and 9 through its flat entry, its planar entry and its
   flat entry on a misaligned x), and B7 on the SmolLM-135M vector (8
   bits, K = 5 and 3, flat entry) —
   packed words and B1-B5's and B7's floats bitwise equal, B8's floats
   within MAX_ULP (bitwise is expected everywhere: the kernels pin
   rounding with _rn intrinsics and keep the plain version's operation
   order); time kernel, plain version and, for B3, the library's
   multi-tensor SGD step (``torch._fused_sgd_``) with CUDA events; count
   keyed B1's, B4's and B6's compiled instructions by pipe (``cuobjdump
   -sass``) for their operations bounds, and check that B7's (8 bits,
   K = 3) and B8's global loads all come before their first decode;
   check that a B8 call is one device operation; hold T1 and T2 (the
   key chain's threefry split and uniform draw, ``csrc/threefry.cu``)
   bitwise against ``prng.split_plain`` and ``prng.uniform_plain`` (R in
   {1, 16, 96} keys split into 2-96; every 2NN and CNN leaf for 16
   keys), and T3 (its 32-bit draw, the sort keys of ``prng.permutation``)
   against ``prng.random_bits_plain``, time them against the floor and
   T2 and T3 against their ALU bounds, and
   check by graph capture that a split on the card is one T1 node; time
   B7 through its Pallas-shaped entry at both vectors (``plan_times``,
   which another tree's package can run too);
5. one quickstart round on the card against the same round on the CPU,
   and the plan realization against the dense one on the card, for the
   unfused and the fused round;
6. drive three paths through the library API, each with every launch
   counter set to 0 just before and read just after: the quickstart
   round (2NN 784-200-200-10, 16 clients on a ring with self-weight 0.5,
   K=4, batch 32, eta=0.05, theta=0.9, 8-bit stochastic lemma5 gossip)
   for ROUNDS rounds, unfused (B1 keyed, B2, B3 once a local step) and
   fused (B3, B4 keyed, B5), both with T1 once a split (4 a round); then
   the per-tensor ``ops`` entry points once each (B6, B7, B8, B3);
   check the counts, a finite falling loss and the ops against the CPU;
7. profile both rounds (device busy and idle share, time by kernel);
8. the eager round's host time by group (autograd, the key chain, planar
   staging, wrapper checks, the kernel wrappers, metrics, the rest);
9. 12 rounds of each variant through ``core.capture_step`` (one CUDA
   graph a round) against 12 eager rounds from the same state: bitwise
   (else the trajectory contract, with the rounds where they part); the
   graph holds exactly one round's kernel nodes of each kernel (unfused
   B1 = B2 = 1, B3 = 4; fused B4 = B5 = 1, B3 = 2; T1 = 4 in both; named
   by ``cuFuncGetName``), no copy from host memory and no node of the
   int64 tensor threefry;
10. the paper's CNN (1 663 370 parameters, m 16, K 4, batch 32) and
   CharLSTM (820 522, m 8, K 2, batch 8, sequence 40) at full width on
   the quickstart's gossip: 12 eager rounds with their launch counts
   against 12 captured rounds, bitwise; each graph holds exactly B1 = B2
   = 1, B3 = K, T1 = 4 kernel nodes; finite losses, the last
   LOSS_MARGIN below ln(classes) (a model that learns);
10b. "schedules": the quickstart on every TopologySchedule kind
   (SCHEDULE_KINDS: constant, ER edge sampling (K = 11), i.i.d., exact
   (k 10) and capped (k 12) partial participation, a precomputed and a
   stateful random walk (k 2), a ring/torus cycle), unfused, and the
   fused round on edge sampling and i.i.d. partial participation: 12
   eager rounds with exact launch counts derived per kind
   (``round_launches``: B1 = B2 = 1, B3 = K a round; T1, T2, T3 by the
   event's draws), ``active_frac`` equal to the schedule's own event, 3
   rounds against the CPU, 12 captured rounds bitwise with 12 eager (one
   round's kernel nodes, no host copy, no int64 threefry node), a finite
   falling loss; B2 with weights gathered from a sampled W_t at K = 5 and
   11 and 2-16 bits (timed at K = 11); ``bench.topology`` and
   ``bench.timevarying`` at full size, captured equal to eager;
10c. "async": T4 (``jax.random.normal``, ``csrc/threefry.cu``) bitwise
   against ``prng.normal_plain`` on the card at the event clock's [16]
   and at 1 048 576 draws (timed, its ALU bound from the SASS), B3's lane
   entry (an eta a client) bitwise against its plain version at the
   quickstart's 3 187 360 values; the async engine on the quickstart
   under a straggler tail (ASYNC_ARMS: the ring, with the eta decay (the
   lane B3), with ``ready_capacity=1``, on an edge-sampled ring16 at p
   0.7): 12 eager events through ``make_round_step(..., async_cfg=...)``
   with launch counts derived per event (``event_launches``: a round's,
   one more T1 for the clock key, T4 once), 3 against the CPU (the same
   clients fire), 12 captured events bitwise with 12 eager ones (one
   event's kernel nodes, no host copy, no int64 threefry node) and the
   captured engine (``make_async_engine(capture=True)``) bitwise with
   the event loop; a constant speed model bitwise with the synchronous
   round (eta decay off and on); ``ready_capacity=1`` bitwise with full
   width, with the probe of where a lone lane's training would part
   (``capacity_probe``); ``bench.async_compare`` at full size, captured
   equal to eager;
10d. "pool": the virtual client pool at the README's headline (m
   100 000 logical clients, a cohort of 64 on the structural ring's
   exact cohorts, the 2NN, 8-bit stochastic lemma5 on the plan
   realization, data drawn by ``prng.randint`` from the client and the
   round): 12 eager rounds through ``PooledRunner.round`` with exact
   launch counts (``pool_step_launches`` + ``pool_prepare_launches``)
   against 12 captured ones (the step one CUDA graph, captured once at
   the cohort width, prefetch through pinned buffers on a side stream),
   bitwise (the whole store, slots, versions, losses); the step's graph
   holds B1, B2, B3 x 4 and T1 and no host copy; a save at round 6 and a
   restore in a new runner bitwise with the uninterrupted run; the
   round's time by part and the share of the prefetch hidden; 3 rounds
   against the CPU (fp32 and 8-bit); the structural walk (k 2) the same
   way; ``PooledAsyncRunner`` at m 100 000 (capacity 12, dense 8-bit)
   eager against captured; the parity arm (the quickstart's exact k 10:
   pooled against the resident skip path, plan realization and dense,
   fp32 and 8-bit) and the async pool against the resident engine;
   ``bench.pool`` at full size;
10e. "telemetry": the quickstart on the static ring, an edge-sampled
   ring (p 0.5) and an exact cohort (p 0.6), unfused and fused, with
   ``with_telemetry`` off and on, eager and captured, 12 rounds each:
   launches exact (the replay adds one T1 and a T2 a leaf unfused),
   telemetry on bitwise with off, captured bitwise with eager (the
   Telemetry too), each graph's kernel nodes exact, the static ring's
   off graph OFF_GRAPH_NODES, the on graph's extra nodes by group, one
   round's Telemetry against the CPU's (TEL_CPU_RTOL, TEL_CPU_EQUAL);
   the async decay arm's captured events with telemetry (histogram sums
   to m, live + dropped edges == the base's on the ready rows, the
   captured engine's stacked Telemetry the loop's); the pool's headline
   with telemetry and an enabled Tracer (bitwise with telemetry off, a
   RunLog JSONL that ``check_schema`` passes and ``launch.report``
   renders, the span totals beside ``pool_breakdown``'s parts); and
   ``bench.timevarying.telemetry_overhead_compare`` captured and eager,
   its on/off ratios beside the reference's 1.10;
11. captured against eager round time by the host clock, in turns in
   this process, with a profile of 5 replays, a replay's device time and
   the cost of the no-alias clones;
12. the Fig. 6, Figs 2-5, Fig. 8 (CNN) and Fig. 7 (CharLSTM) benches
   (``repro_torch.bench``) at full size, captured and eager, plus the
   ring 8-bit Fig. 6 arm (B1, B2, B3 in its graph): captured equal to
   eager bitwise in every arm, finite losses that fall, accuracy,
   commMB from ``comm_cost`` against the paper's formula, each graph's
   kernel nodes (B3, T1 and, on a dense quantized mix, T2 a leaf) and
   the eager arm's launches;
13. "production": SmolLM-135M at its registered width (bf16, 134 515 008
   params a client, m 8, K 4, batch 4, seq 128) through the LM driver's
   ``launch.train.run_resident`` with the unreduced config, three arms
   (fp32 wire; 8 bits: B1, B2, B3 bf16; 8 bits fused: B4, B5, B3), 5
   rounds each: exact launch counts, finite losses and bf16 leaves, the
   median round, the peak memory, the last round profiled; the 8-bit
   arm's consensus served (batch 4, prompt 32, 16 tokens) and the
   reduced SmolLM's cached decode against a full forward; B1, B2 and B3
   (bf16, f32, its lane entry, a mixed f32/bf16 table: 2 launches)
   bitwise with their plain versions at those shapes and timed; 3
   captured full-width rounds against 3 eager (the largest difference
   reported); the nine other archs reduced, one 8-bit round on the card
   against the CPU (PROD_CPU_RTOL) and 4 greedy tokens; the driver's
   --pool, --async-gossip, partial, --telemetry, --trace and --ckpt-dir
   modes, their JSONL logs held to the schema;
14. "mesh": the 1D client mesh, 4 shards sharing cuda:0
   (``launch.mesh.make_test_mesh``; every boundary transfer a device
   copy on the card): the quickstart unfused and fused, 12 rounds each
   in turns with the one-device plan realization — the sharded mixer
   (fused: the tail at eta 0) fed the same x and z bitwise, the rounds
   bitwise (or, only where local SGD alone parts at the shard's batch
   count, within rtol 1e-5), exact launches (B1 = B2 = 4 a round, B4 =
   B5 = 4 fused), 12 captured rounds bitwise with 12 eager ones and the
   graph's kernel nodes one round's; the boundary lanes moved equal to
   ``comm_cost``'s block bill's lane slots (bytes beside the bill's);
   the placement arm on ER(64, 0.06, seed 2) over 8 shards (placed
   bitwise with contiguous, lane slots at most half); SmolLM-135M as
   registered through the driver's ``run_resident`` on the mesh
   (``--clients-per-shard 2``, 8 bits, 2 rounds) against the one
   device; B2 and B5 at a shard's extended-table shapes bitwise with
   their plain versions and timed (``--only mesh`` runs it alone;
   ``--only cards``, on a machine with 4 cards, runs the quickstart on
   ``make_client_mesh`` with one card a shard, eagerly, then its 2D arm:
   ``make_client_mesh(16, clients_per_shard=8, model_parallel=2)``, one
   card a cell, against the 1D mesh of 2 shards on cuda:0);
15. "mesh2d": the 2D (clients, model) mesh, 4 shards x 2 columns sharing
   cuda:0, under the reference's 2NN hand specs: its predictions first;
   the mixer bitwise with the 1D mesh and the one device in fp32, q8
   lemma5, q8 eq7 and q8 stochastic; 12 unfused 8-bit stochastic rounds
   bitwise with the 1D mesh's, eager and captured (B1 = B2 = 8, B3 = 4 K,
   T2 = 6, T1 = 7 a round, exactly), graph nodes and replay ms of both,
   a column's shipped bytes exactly the bill's lane slots times a cell's
   stream; ``bench.timevarying.mesh2d_compare`` at d 65 536 (fp32 ratio
   exactly 4.0, q8 >= 3.0); SmolLM-135M as registered through the
   driver on a (2, 2) mesh (``--model-parallel 2``: its log lines,
   losses bitwise with the 1D run's, peak GiB); B1 through its
   tensor-noise entry and B2 at a cell's shapes and T2 at SmolLM-135M's
   largest leaf for 8 keys, bitwise with their plain versions and timed;
   and the fused round on 4 x 2 cells with no specs (every column the
   whole model): 12 rounds bitwise with the 1D mesh's fused round,
   eager and captured, B4 = B5 = 8 a round exactly, graph nodes and
   replay ms beside the 1D fused graph's (``--only mesh2d`` runs it
   alone);
16. "mia": ``bench.mia`` at the reference's sizes (m 8, K 4, batch 16,
   the ring, fp32 gossip, rounds 5 and 60), captured: B3 exactly K
   launches a round (eager) and K nodes a round graph, 5 captured rounds
   bitwise with 5 eager ones, the 5-round shadow and target models
   within MIA_CPU_RTOL of the port's CPU run, the AUCs finite in [0, 1]
   and printed beside the CPU's; ``quantize_pytree`` on the 2NN at 8 and
   4 bits (T1, T2) bitwise with the CPU; the attack model's init (T1,
   T4) bitwise with its plain version on the card (``--only mia``);
17. "bench_kernels": ``bench.kernels`` on the card (its rows and the
   entry points' twins), then B6, B8 and B3 at N =
   1 048 576 bitwise and timed against their bounds, B3 beside
   ``torch._fused_sgd_`` (``--only bench_kernels``);
18. "wire": the quickstart's 12 rounds at each of the reference's wire
   codecs (``"auto"``, ``"seq"``, ``"planar"``): every one launches B1
   and B2 12 times, params, losses and consensus bitwise; the driver's
   ``--wire seq`` for 2 rounds against ``--wire planar``, B1 and B2
   twice each, losses equal (``--only wire``);
19. print the kernel table (with the floor; B1-B3 with their full-width
   times, B1-B5 with their mesh launches, B2 and B5 at the mesh's
   extended table, a B3 bf16 row, the 2D rows: B1 tensor noise and B2
   at a cell, T2 at SmolLM-135M's largest leaf, and ``bench.kernels``'
   B6, B8 and B3 at 1M) as one JSON line, then the card again, then
   ``{"ok": true, "device": {...}}`` as the last line.

It needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

M, K, BATCH, ROUNDS = 16, 4, 32, 12
ETA, THETA = 0.05, 0.9
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
SMS, CLOCK_HZ = 132, 1.98e9  # H100 SXM: SMs, boost clock
# Thread instructions one Hopper SM retires per clock, by pipe. Four
# sub-partitions each issue one warp instruction a clock (issue: 128) and
# hold 16 ALU lanes (integer add, logic, shift, compare, select; float
# compare and min/max: 64), 16 FMA-heavy lanes (f32 and IMAD) beside 16
# FMA-lite lanes (f32 only), so 128 f32 but 64 IMAD a clock, and 4 XU
# lanes (MUFU and conversions: 16). 128 f32 lanes x 2 operations x 132 SMs
# x 1.98 GHz is the data sheet's 67 TFLOP/s.
PIPE_PER_CLK = {"issue": 128, "alu": 64, "fma": 128, "imad": 64, "xu": 16}
# SASS opcodes (the part before the first ".") by pipe; any other opcode
# (memory, uniform datapath, control) counts toward issue only.
SASS_PIPE = {
    "alu": {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "FSEL", "PLOP3", "MOV",
            "FMNMX", "FSETP", "LEA", "IABS", "PRMT", "IMNMX", "VIMNMX",
            "BMSK", "FCHK", "P2R", "R2P", "CS2R", "FLO", "BREV", "POPC"},
    "imad": {"IMAD", "IMUL", "IDP", "VIADD"},
    "fp32": {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I",
             "HFMA2", "HADD2", "HMUL2"},
    "xu": {"MUFU", "F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP"},
}
MAX_ULP = 2                  # stated float bound kernel vs plain
# The Noise enumerators of csrc/quantize_pack.cu, as the mangled kernel
# names carry them.
TENSOR_NOISE, KEYED, KEYED_BY_VALUE = 1, 2, 3
# (bits, stochastic) of the wire at which B1, B2, B4 and B5 are checked.
CODECS = ((8, True), (8, False), (4, True), (2, True), (16, True))
REPS, WARMUP = 20, 3
FLAT_2NN = 199210            # one client's 2NN 784-200-200-10 vector
# SmolLM-135M's parameter count: CONFIG.n_params() of the JAX package's
# src/repro/configs/smollm_135m.py (hf:HuggingFaceTB/SmolLM-135M), the
# flat vector at which B7 is bound by bytes, not by a launch.
SMOLLM_N = 134_515_008
HOST_RUNS, HOST_RUN = 100, 3  # host clock: runs of back-to-back calls
OPS_CALLS = 4                # calls a device-operation count profiles
SLEEP_CYCLES = 4_000_000     # ~2 ms of GPU clock: covers the host enqueue
KERNEL_SOURCES = {
    "quantize_pack_buffer": ("src/repro_torch/csrc/quantize_pack.cu",
                             "src/repro/kernels/quantize_pack.py:48"),
    "dequant_mix_buffer": ("src/repro_torch/csrc/dequant_mix.cu",
                           "src/repro/kernels/dequant_mix.py:100"),
    "momentum_sgd": ("src/repro_torch/csrc/momentum_sgd.cu",
                     "src/repro/kernels/momentum_sgd.py:45"),
    "momentum_quantize_pack_buffer": (
        "src/repro_torch/csrc/quantize_pack.cu",
        "src/repro/kernels/quantize_pack.py:121"),
    "dequant_mix_momentum_buffer": ("src/repro_torch/csrc/dequant_mix.cu",
                                    "src/repro/kernels/dequant_mix.py:163"),
    "quantize_pack": ("src/repro_torch/csrc/quantize_pack.cu",
                      "src/repro/kernels/quantize_pack.py:166"),
    "dequant_mix_plan": ("src/repro_torch/csrc/dequant_mix.cu",
                         "src/repro/kernels/dequant_mix.py:203"),
    "dequant_mix": ("src/repro_torch/csrc/dequant_mix.cu",
                    "src/repro/kernels/dequant_mix.py:232"),
    # No Pallas kernel: the JAX package leaves the key chain's
    # jax.random.split and jax.random.uniform to XLA; these name the calls.
    "threefry_split": ("src/repro_torch/csrc/threefry.cu",
                       "src/repro/core/dfedavgm.py:258"),
    "threefry_uniform": ("src/repro_torch/csrc/threefry.cu",
                         "src/repro/core/quantize.py:139"),
    # jax.random.bits inside jax.random.permutation (the exact cohort).
    "threefry_bits": ("src/repro_torch/csrc/threefry.cu",
                      "src/repro/core/topology.py:538"),
    # jax.random.normal: the event clock's durations.
    "threefry_normal": ("src/repro_torch/csrc/threefry.cu",
                        "src/repro/core/event_clock.py:100"),
    # B3 with eta a device [m] (the reference vmaps the Pallas kernel's
    # scalar block over the clients, core/async_gossip.py:326-340).
    "momentum_sgd_lanes": ("src/repro_torch/csrc/momentum_sgd.cu",
                           "src/repro/kernels/momentum_sgd.py:45"),
}
# Further times a row carries where its kernel has them, all measured.
EXTRA_KEYS = ("clean_ms", "host_ms", "plain_call_ms", "plain_host_ms",
              "smollm", "quickstart", "fold_in_each",
              "library_call_ms", "library_host_ms", "library_clean_ms",
              "tensor_noise_ms", "tensor_noise_call_ms",
              "tensor_noise_host_ms", "tensor_noise_clean_ms")
# The path whose launch counts each kernel's row reports.
KERNEL_PATH = {"quantize_pack_buffer": "pool",
               "dequant_mix_buffer": "pool", "momentum_sgd": "pool",
               "momentum_quantize_pack_buffer": "fused",
               "dequant_mix_momentum_buffer": "fused", "quantize_pack": "ops",
               "dequant_mix_plan": "ops", "dequant_mix": "ops",
               "threefry_split": "unfused", "threefry_uniform": "fig8",
               "threefry_bits": "schedules", "threefry_normal": "async",
               "momentum_sgd_lanes": "async"}
# Splits a round makes (round keys, client keys, per-step keys, and the
# per-leaf quantizer keys of a quantized wire), the fused round too.
SPLITS_A_ROUND = 4
# The "schedules" phase: the quickstart on each TopologySchedule kind
# (the README's time-varying scenarios), unfused, and the fused round on
# the two kinds the fused tail gates (sampled W_t, inactive clients).
SCHEDULE_KINDS = ("constant", "edge_sample", "partial", "partial_exact",
                  "partial_cap", "walk", "walk_stateful", "cycle")
FUSED_SCHEDULE_KINDS = ("edge_sample", "partial")
CPU_ROUNDS = 3               # eager card rounds held against the CPU
# A graph node of the int64 tensor threefry (prng.split_plain's mask,
# shifts, or and xor on int64), by its demangled function name.
INT64_THREEFRY = re.compile(
    r"(Bitwise(And|Or|Xor)Functor|[lr]shift_kernel)[^;]*\blong\b")
# The paper's models at full width (configs/paper_models.py), each on the
# quickstart's ring plan with the 8-bit stochastic lemma5 wire. The CNN
# reads 28x28x1 images with low-frequency class templates (the first
# channel of ``classification_dataset(image=True)``): on the MNIST-like
# vectors' per-pixel random class means it stays at chance for 12 rounds,
# the JAX package's CNN too, so its loss would show no gradient at work.
FULL_WIDTH = {"cnn": dict(m=16, K=4, batch=32, eta=0.01, noise=1.0),
              "charlstm": dict(m=8, K=2, batch=8, seq=40, eta=1.0)}
# How far under ln(classes), the loss of a model that guesses, the last
# full-width round's loss must come.
LOSS_MARGIN = 0.2
# The "async" phase: the quickstart under README's straggler tail (one
# client in 16 ten times slower), full width, each arm 12 events.
ASYNC_SPEED = dict(mean=1.0, sigma=0.5, frac=1 / M, factor=10.0)
ASYNC_ARMS = ("straggler", "decay", "capacity", "edge_sample")
# The "pool" phase: the README's virtual-pool headline (``--pool
# --clients 100000 --schedule partial --resident-lanes 64``) on the 2NN.
POOL_M, POOL_K = 100_000, 64
POOL_DATA_N = 8000           # MNIST-like vectors held on the card
POOL_RESUME_AT = 6           # the round the resume arm saves at
# Simultaneous ready clients the async pool's capacity covers: a cohort
# is the ready clients and their two ring neighbours, 3 lanes each.
POOL_ASYNC_READY = 4
POOL_PARITY_P = 0.625        # exact k 10 of 16, PR 19's "exact k 10"
# The async pool (dense, [capacity, capacity]) against the resident
# engine's dense [16, 16] mix after 12 events: 8 ulp in every call so far
# (cuBLAS sums the two shapes apart; the training is bitwise).
POOL_ASYNC_DENSE_ULP = 8
# The parity arm's dense pooled store against the resident skip path,
# each leaf's largest difference over its largest value, by wire: 2.4e-7
# (fp32) and 0.0267 (q8, roundings flipped downstream) in every card run
# so far; a dropped or misrouted mix leaves a leaf by about its scale.
# And one dense mix of the same z at [k, k] against [M, M], any leaf: 374
# ulp (w3; w1 and w2 bitwise).
POOL_DENSE_REL = {"fp32": 1e-6, "q8": 0.1}
POOL_DENSE_MIX_ULP = 1536
# The sync arm's CPU_ROUNDS on the card against the CPU: the share of the
# store's elements more than 1e-5 apart (0.13 % fp32, 0.053 % q8 read on
# the card; a dropped mix moves most of them) and the population's
# consensus distance, relative (3.1e-7 and 4.6e-7 read; a dropped mix
# moves it by orders of magnitude more).
POOL_CPU_SHARE = 0.005
POOL_CPU_CONSENSUS = 2e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 units in the last place."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def time_ms(fn, flush: torch.Tensor, reps: int = REPS,
            host_runs: int = HOST_RUNS) -> tuple[float, float, float, float]:
    """(device ms, call ms, host ms, clean device ms) of one call.

    Device: the L2 is flushed by writing a 128 MB buffer, then the stream
    is held busy (``torch.cuda._sleep``) while the host enqueues the call
    between two events, so the events time the call's kernels alone, not
    the host's Python and launch overhead. The flush leaves the L2 full of
    dirty lines, which the call writes back as its own data evicts them.
    Clean device: the same, with the L2 flushed by reading the buffer, so
    the call finds it cold and clean and the events time its own traffic.
    Call: the dirty flush with
    the stream idle, so the host's launch path is in the time (less what
    overlaps the flush). All three are medians over REPS. Host: the host
    clock around one call — the wrapper's Python, checks and enqueue,
    without the device — as a median over HOST_RUNS runs of HOST_RUN
    back-to-back calls between synchronizes, the first call of each run
    left out (it follows the wait), with no flush or event in between."""
    for _ in range(WARMUP):
        fn()
    dev, call, clean = [], [], []
    for _ in range(reps):
        for held, dirty, out in ((True, True, dev), (False, True, call),
                                 (True, False, clean)):
            if dirty:
                flush.zero_()
            else:
                flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if held:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    host = []
    for _ in range(host_runs):
        torch.cuda.synchronize()
        for i in range(HOST_RUN):
            t0 = time.perf_counter()
            fn()
            if i:
                host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return (statistics.median(dev), statistics.median(call),
            statistics.median(host), statistics.median(clean))


def timed(r: dict, prefix: str, fn, flush: torch.Tensor, **reps) -> None:
    """Store ``time_ms(fn)`` in r as <prefix>ms, <prefix>call_ms,
    <prefix>host_ms and <prefix>clean_ms (``reps``: time_ms's counts)."""
    (r[f"{prefix}ms"], r[f"{prefix}call_ms"], r[f"{prefix}host_ms"],
     r[f"{prefix}clean_ms"]) = time_ms(fn, flush, **reps)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, n_ops: int, ops_ms: float = 0.0
          ) -> tuple[float, str]:
    """Least time in ms for the work: the larger of the bytes over the
    memory rate and the operations over their peak rate — n_ops f32
    operations at the f32 rate, or ``ops_ms`` where the instructions were
    counted by pipe (:func:`sass_ops_ms`)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / F32_OPS_PER_S * 1e3, ops_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_function(sass: str, pattern: str) -> str:
    """The SASS of the one kernel in the ``cuobjdump -sass`` text whose
    mangled name matches ``pattern``."""
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    found = [f for f in funcs if re.search(pattern, f.split()[0])]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} kernels match {pattern}")
    return found[0]


def sass_of(lib: str) -> str:
    """``cuobjdump -sass`` of the built library ``lib``."""
    from repro_torch.kernels import native

    return subprocess.run(
        [native.cuda_tool("cuobjdump"), "-sass", str(native.lib_path(lib))],
        capture_output=True, text=True, check=True, timeout=120).stdout


def sass_counts(sass: str, pattern: str) -> dict[str, int]:
    """Instructions of the one kernel in the ``cuobjdump -sass`` text
    whose mangled name matches ``pattern``, by opcode (the part before
    the first "."), as one thread runs it once through. Left out: the
    subroutines it CALLs and the blocks that set up and make such a call
    (the IEEE division's slow path, taken only for operands out of its
    fast range), NOPs, and the closing branch to itself. A block starts
    at a branch or call target and after a branch, EXIT or RET; a loop's
    body counts once."""
    code, labels, pending = [], {}, []   # code: (address, opcode, operands)
    for line in sass_function(sass, pattern).splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if lab:
            pending.append(lab.group(1))
        elif ins:
            at = int(ins.group(1), 16)
            labels.update((name, at) for name in pending)
            pending = []
            code.append((at, ins.group(2).split(".")[0], ins.group(3)))

    def targets(ops: tuple) -> set[int]:
        """Addresses the instructions ``ops`` branch or call to."""
        out = set()
        for _, op, arg in code:
            if op in ops:
                out.update(int(t, 16) for t in re.findall(r"0x([0-9a-f]+)",
                                                          arg))
                out.update(labels[t] for t in re.findall(r"\.L_x_\d+", arg))
        return out

    called = targets(("CALL",))
    starts = targets(("BRA", "CALL"))
    blocks: list[list[tuple[int, str, str]]] = []
    for k, ins in enumerate(code):
        if not blocks or ins[0] in starts or code[k - 1][1] in ("BRA",
                                                                 "EXIT",
                                                                 "RET"):
            blocks.append([])
        blocks[-1].append(ins)
    counts: dict[str, int] = {}
    in_sub = False
    for body in blocks:
        in_sub = in_sub or body[0][0] in called
        ops = [op for _, op, _ in body]
        if in_sub:
            in_sub = "RET" not in ops
            continue
        if "CALL" in ops or (ops == ["BRA"] and body[0][0] in targets(
                ("BRA",)) and re.search(f"0x0*{body[0][0]:x}\\b",
                                       body[0][2])):
            continue
        for op in ops:
            if op != "NOP":
                counts[op] = counts.get(op, 0) + 1
    return counts


def pipe_ms(counts: dict[str, float]) -> dict[str, float]:
    """Time in ms each pipe needs for ``counts`` thread instructions (by
    opcode) spread over every SM at its peak rate; the f32 and IMAD
    instructions share the FMA pipe."""
    n = {p: sum(v for k, v in counts.items() if k in ops)
         for p, ops in SASS_PIPE.items()}
    n["issue"] = sum(counts.values())
    per_s = {p: PIPE_PER_CLK[p] * SMS * CLOCK_HZ for p in PIPE_PER_CLK}
    return {"issue": n["issue"] / per_s["issue"] * 1e3,
            "alu": n["alu"] / per_s["alu"] * 1e3,
            "fma": max(n["imad"] / per_s["imad"],
                       (n["imad"] + n["fp32"]) / per_s["fma"]) * 1e3,
            "xu": n["xu"] / per_s["xu"] * 1e3}


def keyed_ops(kernel: str, bits: int, threads: int, n_real: int,
              keyed: int = KEYED, cols: int = 4) -> dict:
    """The operations bound of keyed B1 (``kernel`` =
    "quantize_pack_buffer"), keyed B4 ("momentum_quantize_pack_buffer") or
    keyed B6 ("quantize_pack", its key by value: ``keyed`` =
    KEYED_BY_VALUE, one column a thread: ``cols`` = 1) from its compiled
    code. The tensor-noise kernel of the same body gives the work of a
    thread (T, per thread); the keyed kernel's surplus over it, over the
    values a thread packs (``cols`` x per), gives the
    work of one draw (D, per value: the hash, its counter and bounds
    check, a share of the leaf lookup, less the noise loads). This run's
    work is threads x T + real values x D (padding draws nothing, except
    in B6, which draws over the whole padded buffer as encode_delta
    does); the bound is its busiest pipe."""
    sass = sass_of("quantize_pack")
    # The digit is the end of the mangled name's length prefix, so B1's
    # pattern does not match inside B4's name, nor B6's inside B1's.
    name = r"\d" + kernel + r"_kernelILi{}ELN\w*NoiseE{}E"
    per_thread = sass_counts(sass, name.format(bits, TENSOR_NOISE))
    keyed = sass_counts(sass, name.format(bits, keyed))
    values = cols * (32 // bits)        # columns x per rows
    per_draw = {k: (keyed.get(k, 0) - per_thread.get(k, 0)) / values
                for k in set(keyed) | set(per_thread)}
    work = {k: threads * per_thread.get(k, 0) + n_real * per_draw[k]
            for k in per_draw}
    ms = pipe_ms(work)
    pipe = max(ms, key=ms.get)
    return {"ms": ms[pipe], "pipe": pipe, "pipe_ms": ms,
            "threads": threads, "real_values": n_real,
            "instructions": sum(work.values()),
            "tensor_noise_per_thread": per_thread,
            "keyed_per_thread": keyed,
            "per_draw": {k: v for k, v in per_draw.items() if v}}


def load_order(sass: str, pattern: str) -> dict:
    """Where one kernel's global loads stand against its first decode
    (the first integer-to-float conversion of a field) in its SASS (of
    the ``cuobjdump -sass`` text): the loads issued before it, and those
    after."""
    ops = [m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
        sass_function(sass, pattern))]
    first = next((i for i, op in enumerate(ops) if op in ("I2F", "I2FP")),
                 len(ops))
    loads = [i for i, op in enumerate(ops) if op == "LDG"]
    return {"loads_before_first_decode": sum(i < first for i in loads),
            "loads_after": sum(i > first for i in loads),
            "first_decode_at": first, "instructions": len(ops)}


def loads_first(what: str, order: dict) -> dict:
    """Fail unless every global load of a kernel's SASS comes before its
    first decode (:func:`load_order`)."""
    if order["loads_after"] or not order["loads_before_first_decode"]:
        raise AssertionError(f"{what}: global loads after the first "
                             f"decode: {order}")
    return order


def quickstart_setup(dev, fuse_round: bool = False):
    from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                                  make_round_step)
    from repro_torch.data import FederatedDataset, classification_dataset
    from repro_torch.models.paper_nets import (apply_2nn, init_2nn,
                                               softmax_xent)

    data = classification_dataset(n=8000, d=784, seed=0)
    fed = FederatedDataset.make(data, M, iid=True)
    params = init_2nn(0, device=dev)
    stacked = {n: t.unsqueeze(0).expand((M,) + t.shape).contiguous()
               for n, t in params.items()}
    spec = MixingSpec.ring(M, self_weight=0.5)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8), fuse_round=fuse_round)

    def loss_fn(p, b, rng):
        return softmax_xent(apply_2nn(p, b["x"]), b["y"])

    step = make_round_step(loss_fn, cfg, spec, device=dev)
    return data, fed, stacked, spec, cfg, loss_fn, step


def kernel_checks(dev, flush):
    """Phase 3: every kernel against its plain version at main-path
    shapes. Returns {kernel: record} with the main-path configuration's
    times and the largest error over all configurations."""
    from repro_torch import prng
    from repro_torch.core import MixingSpec, WireLayout
    from repro_torch.core.mixing import _quant_leaf_keys
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import (dequant_mix_buffer,
                                                 dequant_mix_buffer_plain)
    from repro_torch.kernels.quantize_pack import quantize_pack_buffer
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(1)
    shapes = {n: t.shape for n, t in init_2nn(0, device="cpu").items()}

    def stacked_randn(scale):
        return {n: (torch.randn((M,) + tuple(s), generator=gen) * scale)
                .to(dev) for n, s in shapes.items()}

    x = stacked_randn(0.05)
    z = {n: t + 0.01 * torch.randn(t.shape, generator=gen).to(dev)
         for n, t in x.items()}
    plan = MixingSpec.ring(M, self_weight=0.5).gossip_plan()
    src = torch.tensor(np.stack([np.arange(M), plan.src[0], plan.src[1]]),
                       dtype=torch.int32, device=dev)
    w = torch.tensor(np.stack([plan.w_self, plan.w_steps[0],
                               plan.w_steps[1]], 1), dtype=torch.float32,
                     device=dev)
    key = prng.PRNGKey(3)
    rec = {k: {"max_abs_err": 0.0, "max_ulp": 0, "checks": []}
           for k in KERNEL_SOURCES}

    for bits, stochastic in CODECS:
        quant = QuantConfig(bits=bits, stochastic=stochastic)
        layout = WireLayout.for_tree(x, bits, stacked=True)
        X = layout.to_planar_stacked(x)
        delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
        sblk = layout.block_scales(layout.leaf_scales(delta, quant))
        r = rec["quantize_pack_buffer"]
        what = f"B1 bits={bits} stochastic={stochastic}"
        if not stochastic:
            words = quantize_pack_buffer(delta, sblk, bits)
            check_words(what, words, ref.quantize_pack_buffer_ref(
                delta, sblk, bits))
            r["checks"].append(f"bits={bits} deterministic "
                               f"shape={list(delta.shape)} words bitwise")
            continue
        keys = _quant_leaf_keys(key, layout.n_leaves, M).to(dev)
        table = layout.noise_table
        noise = layout.noise_stacked(keys)
        words = quantize_pack_buffer(delta, sblk, bits, keys=keys,
                                     table=table)
        words_ref = ref.quantize_pack_buffer_ref(delta, sblk, bits, noise)
        words_tensor = quantize_pack_buffer(delta, sblk, bits, noise)
        noise_ref = ref.keyed_noise_ref(keys, table, layout.per,
                                        layout.total_words)
        torch.cuda.synchronize()
        check_words(f"{what} keyed", words, words_ref)
        check_words(f"{what} tensor noise", words_tensor, words_ref)
        check_words("keyed_noise_ref vs noise_stacked",
                    noise_ref.view(torch.int32), noise.view(torch.int32))
        r["checks"].append(f"bits={bits} stochastic shape="
                           f"{list(delta.shape)} keyed and tensor-noise "
                           "words bitwise vs noise_stacked + plain")
        if bits == 8:
            n_real = sum(layout.sizes) * M
            timed(r, "", lambda: quantize_pack_buffer(
                delta, sblk, bits, keys=keys, table=table), flush)
            timed(r, "plain_", lambda: ref.quantize_pack_buffer_ref(
                delta, sblk, bits, layout.noise_stacked(keys)), flush)
            r["sass"] = keyed_ops("quantize_pack_buffer", bits,
                                  delta.shape[0] * delta.shape[2] // 4,
                                  n_real)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(delta, sblk, keys, words), 0, r["sass"]["ms"])
            r["bound_bytes_ms"] = bound(nbytes(delta, sblk, keys, words),
                                        0)[0]
            timed(r, "tensor_noise_", lambda: quantize_pack_buffer(
                delta, sblk, bits, noise), flush)
            r["tensor_noise_bound_ms"] = bound(
                nbytes(delta, sblk, noise, words), 8 * delta.numel())[0]
            r["shape"] = list(delta.shape)

        out = dequant_mix_buffer(X, words, sblk, w, src, bits)
        out_ref = dequant_mix_buffer_plain(X, words, sblk, w, src, bits)
        torch.cuda.synchronize()
        r = rec["dequant_mix_buffer"]
        check_words(f"B2 bits={bits}", out.view(torch.int32),
                    out_ref.view(torch.int32))
        check_floats(r, f"B2 bits={bits}", [(out, out_ref)])
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           "bitwise")
        if (bits, stochastic) == (8, True):
            timed(r, "", lambda: dequant_mix_buffer(
                X, words, sblk, w, src, bits), flush)
            timed(r, "plain_", lambda: dequant_mix_buffer_plain(
                X, words, sblk, w, src, bits), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(X, words, sblk, w, src, out),
                X.numel() * 3 * src.shape[0])
            r["shape"] = list(X.shape)
            # What the card's memory gives a plain streaming pass under
            # the same timing: base copied into out (B2 less its words).
            timed(r, "copy_", lambda: out.copy_(X), flush)
            r["copy_bound_ms"] = bound(nbytes(X, out), 0)[0]

    momentum_checks(dev, flush, rec["momentum_sgd"], stacked_randn)
    fused_kernel_checks(dev, flush, rec, x, stacked_randn)
    ops_kernel_checks(dev, flush, rec)
    for name, r in rec.items():
        print(json.dumps({"check": name, **r}), flush=True)
    return rec


def momentum_checks(dev, flush, r, stacked_randn):
    """B3 at one local step of the quickstart: all six leaves of the 2NN
    for 16 clients in one launch, bitwise against the plain step, plus a
    leaf that is a misaligned view (the kernel's scalar loop); timed as
    one call of ``momentum_update`` against the plain per-leaf step and
    the library's multi-tensor SGD step over the same leaves."""
    from repro_torch.kernels import momentum_update, ref
    from repro_torch.kernels.momentum_sgd import momentum_sgd

    y, v, g = stacked_randn(0.05), stacked_randn(0.01), stacked_randn(0.1)
    ys, vs = momentum_update(y, v, g, ETA, THETA)
    refs = {n: ref.momentum_sgd_ref(y[n], v[n], g[n], ETA, THETA) for n in y}
    n_mis = y["b2"].numel() + 5
    spare = torch.empty(n_mis + 1, device=dev)
    y_mis = spare[1:].copy_(torch.randn(n_mis, device=dev))
    v_mis, g_mis = torch.randn(n_mis, device=dev), torch.randn(n_mis,
                                                               device=dev)
    mis = momentum_sgd(y_mis, v_mis, g_mis, ETA, THETA)
    mis_ref = ref.momentum_sgd_ref(y_mis, v_mis, g_mis, ETA, THETA)
    torch.cuda.synchronize()
    pairs = [(ys[n], refs[n][0]) for n in y] + [(vs[n], refs[n][1])
                                                for n in y]
    pairs += list(zip(mis, mis_ref))
    for a, b in pairs:
        check_words("B3 vs plain", a.view(torch.int32), b.view(torch.int32))
    check_floats(r, "B3", pairs)
    n_el = sum(t.numel() for t in y.values())
    r["checks"].append(f"6 leaves x {M} clients = {n_el} values in one "
                       f"launch, and a misaligned view of {n_mis} values: "
                       "bitwise")
    timed(r, "", lambda: momentum_update(y, v, g, ETA, THETA), flush)
    timed(r, "plain_", lambda: [ref.momentum_sgd_ref(
        y[n], v[n], g[n], ETA, THETA) for n in y], flush)
    # torch._fused_sgd_ makes the same step in place over a list of
    # tensors (buf' = theta*buf + g; p' = p - eta*buf', i.e. v = -eta*buf)
    # and reads and writes the same five streams: timed only.
    params = [t.clone() for t in y.values()]
    bufs = [t.clone() for t in v.values()]
    grads = list(g.values())
    timed(r, "library_", lambda: torch._fused_sgd_(
        params, grads, bufs, weight_decay=0.0, momentum=THETA, lr=ETA,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False),
        flush)
    r["bound_ms"], r["bound_by"] = bound(5 * 4 * n_el, 3 * n_el)
    r["shape"] = f"one local step: 6 leaves x {M} clients ({n_el} f32)"


def check_floats(rec: dict, what: str, pairs) -> None:
    """Fail if any (kernel, plain) float pair is more than MAX_ULP apart;
    record the largest distance."""
    for a, b in pairs:
        ulp = ulp_diff(a, b)
        if ulp > MAX_ULP:
            raise AssertionError(f"{what}: {ulp} ulp from plain")
        rec["max_ulp"] = max(rec["max_ulp"], ulp)
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 float((a - b).abs().max()))


def check_words(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} words differ from the plain "
                             "version")


def fused_kernel_checks(dev, flush, rec, x, stacked_randn):
    """B4 and B5 at the quickstart's wire shapes, the inputs the fused
    tail gives them: planar y, v, g of the penultimate step, the held x,
    per-leaf scales of the resulting delta, the lemma5 replica base."""
    from repro_torch import prng
    from repro_torch.core import MixingSpec, WireLayout
    from repro_torch.core.mixing import (_plan_tables, _quant_leaf_keys,
                                         _weighted_replica_base)
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import (
        dequant_mix_momentum_buffer, dequant_mix_momentum_buffer_plain)
    from repro_torch.kernels.quantize_pack import (
        momentum_quantize_pack_buffer)

    et = (ETA, THETA)
    eta_f, theta_f = float(np.float32(ETA)), float(np.float32(THETA))
    y = {n: t + 0.01 * torch.randn_like(t) for n, t in x.items()}
    v, g, gk = stacked_randn(0.01), stacked_randn(0.1), stacked_randn(0.1)
    src, w = _plan_tables(MixingSpec.ring(M, self_weight=0.5).gossip_plan(),
                          dev)
    for bits, stochastic in CODECS:
        quant = QuantConfig(bits=bits, stochastic=stochastic)
        layout = WireLayout.for_tree(x, bits, stacked=True)
        X, Y, V, G, GK = (layout.to_planar_stacked(t)
                          for t in (x, y, v, g, gk))
        delta = (Y + (theta_f * V - eta_f * G)) - X
        sblk = layout.block_scales(layout.leaf_scales(delta, quant))
        r = rec["momentum_quantize_pack_buffer"]
        what = f"B4 bits={bits} stochastic={stochastic}"
        keys = table = noise = None
        if stochastic:
            keys = _quant_leaf_keys(prng.PRNGKey(4), layout.n_leaves,
                                    M).to(dev)
            table = layout.noise_table
            noise = layout.noise_stacked(keys)
        want = ref.momentum_quantize_pack_buffer_ref(Y, V, G, X, sblk, bits,
                                                     et, noise)
        runs = {"": momentum_quantize_pack_buffer(
            Y, V, G, X, sblk, bits, et, keys=keys, table=table)}
        if stochastic:
            runs["tensor noise "] = momentum_quantize_pack_buffer(
                Y, V, G, X, sblk, bits, et, noise)
        torch.cuda.synchronize()
        for form, got in runs.items():
            for a, b in zip(got, want):
                check_words(f"{what} {form}", a.view(torch.int32),
                            b.view(torch.int32))
            check_floats(r, what, zip(got[:2], want[:2]))
        y_out, v_out, words = runs[""]
        r["checks"].append(
            f"bits={bits} stochastic={stochastic} shape={list(Y.shape)} "
            + ("keyed and tensor-noise words vs noise_stacked + plain"
               if stochastic else "words") + ", y' and v' bitwise")
        if (bits, stochastic) == (8, True):
            n_real = sum(layout.sizes) * M
            timed(r, "", lambda: momentum_quantize_pack_buffer(
                Y, V, G, X, sblk, bits, et, keys=keys, table=table), flush)
            timed(r, "plain_", lambda: ref.momentum_quantize_pack_buffer_ref(
                Y, V, G, X, sblk, bits, et, layout.noise_stacked(keys)),
                flush)
            timed(r, "tensor_noise_", lambda: momentum_quantize_pack_buffer(
                Y, V, G, X, sblk, bits, et, noise), flush)
            moved = nbytes(Y, V, G, X, sblk, keys, y_out, v_out, words)
            r["sass"] = keyed_ops("momentum_quantize_pack_buffer", bits,
                                  Y.shape[0] * Y.shape[2] // 4, n_real)
            r["bound_ms"], r["bound_by"] = bound(moved, 0, r["sass"]["ms"])
            r["bound_bytes_ms"] = bound(moved, 0)[0]
            r["tensor_noise_bound_ms"] = bound(
                nbytes(Y, V, G, X, noise, sblk, y_out, v_out, words),
                10 * Y.numel())[0]
            r["shape"] = list(Y.shape)

        if not stochastic:
            continue
        base = _weighted_replica_base(X, w, src)
        out = dequant_mix_momentum_buffer(base, words, sblk, w, src, v_out,
                                          GK, et, bits)
        out_ref = dequant_mix_momentum_buffer_plain(base, words, sblk, w, src,
                                                    v_out, GK, et, bits)
        torch.cuda.synchronize()
        r = rec["dequant_mix_momentum_buffer"]
        check_words(f"B5 bits={bits}", out.view(torch.int32),
                    out_ref.view(torch.int32))
        check_floats(r, f"B5 bits={bits}", [(out, out_ref)])
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           "bitwise")
        if bits == 8:
            timed(r, "", lambda: dequant_mix_momentum_buffer(
                base, words, sblk, w, src, v_out, GK, et, bits), flush)
            timed(r, "plain_", lambda: dequant_mix_momentum_buffer_plain(
                base, words, sblk, w, src, v_out, GK, et, bits), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(base, words, sblk, w, src, v_out, GK, out),
                base.numel() * (3 * src.shape[0] + 4))
            r["shape"] = list(X.shape)


def ops_kernel_checks(dev, flush, rec):
    """B6, B7 and B8 on one client's flat 2NN vector (n = 199 210: planar
    [4, 50 176] at 8 bits; k = 3 streams), the inputs the ops entry points
    give them. B6 keyed (its key by value, as a host key goes, and by
    pointer) against ``keyed_noise_ref`` over the one-leaf table + the
    plain encode, and B8 against its plain version, at 2, 4, 8 and 16
    bits; B6 with tensor noise and deterministic at 8 bits; B7 as
    :func:`plan_kernel_checks` says."""
    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import dequant_mix
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(2)
    flat = torch.cat([t.reshape(-1) for _, t in
                      sorted(init_2nn(0, device="cpu").items())])
    n = flat.numel()
    assert n == FLAT_2NN
    delta = (0.01 * torch.randn(n, generator=gen)).to(dev)
    key = prng.split(prng.PRNGKey(6), 2)[1]
    key_dev = key.to(dev)
    r = rec["quantize_pack"]
    at = {}                 # bits -> (x2d, s, noise)
    for bits in (2, 4, 8, 16):
        per, wd = ref.planar_pad_len(n, bits)
        x2d = F.pad(delta, (0, per * wd - n)).reshape(per, wd)
        s = delta.abs().amax() / torch.full((), 2.0 ** (bits - 1) - 1,
                                            device=dev)
        table = ref.NoiseTable((0,), (wd,), (per * wd,))
        noise = ref.keyed_noise_ref(key_dev.reshape(1, 1, 2), table, per,
                                    wd)[0]
        check_words(f"B6 bits={bits} one-leaf table vs prng.uniform",
                    noise.view(torch.int32),
                    prng.uniform(key_dev, (per, wd)).view(torch.int32))
        want = ref.quantize_pack_ref(x2d, s, bits, noise)
        check_words(f"B6 bits={bits} keyed, host key",
                    quantize_pack(x2d, s, bits, key=key), want)
        check_words(f"B6 bits={bits} keyed, device key",
                    quantize_pack(x2d, s, bits, key=key_dev), want)
        r["checks"].append(f"bits={bits} keyed (host and device key) "
                           f"shape={list(x2d.shape)} words bitwise vs "
                           "one-leaf keyed_noise_ref + plain")
        at[bits] = x2d, s, noise
    x2d, s, noise = at[8]
    per, wd = x2d.shape
    for nz in (noise, None):
        check_words(f"B6 stochastic={nz is not None}",
                    quantize_pack(x2d, s, 8, nz),
                    ref.quantize_pack_ref(x2d, s, 8, nz))
        r["checks"].append(f"bits=8 stochastic={nz is not None} "
                           f"shape={list(x2d.shape)} words bitwise")
    words = quantize_pack(x2d, s, 8, key=key)
    timed(r, "", lambda: quantize_pack(x2d, s, 8, key=key), flush)
    timed(r, "plain_", lambda: ref.quantize_pack_ref(
        x2d, s, 8, prng.uniform(key_dev, x2d.shape)), flush)
    timed(r, "tensor_noise_", lambda: quantize_pack(x2d, s, 8, noise), flush)
    r["sass"] = keyed_ops("quantize_pack", 8, wd, per * wd,
                          keyed=KEYED_BY_VALUE, cols=1)
    r["bound_ms"], r["bound_by"] = bound(nbytes(x2d, s, words), 0,
                                         r["sass"]["ms"])
    r["bound_bytes_ms"] = bound(nbytes(x2d, s, words), 0)[0]
    r["tensor_noise_bound_ms"] = bound(nbytes(x2d, s, noise, words),
                                       8 * x2d.numel())[0]
    r["shape"] = list(x2d.shape)

    r = rec["dequant_mix"]
    ring_at = {}            # bits -> (xb, streams, scales)
    for bits in (2, 4, 8, 16):
        per, wd = ref.planar_pad_len(n, bits)
        xb = (torch.randn(per * wd, generator=gen) * 0.05).to(dev).reshape(
            per, wd)
        streams = torch.randint(-2 ** 31, 2 ** 31, (3, wd), generator=gen,
                                dtype=torch.int64).to(torch.int32).to(dev)
        scales = (torch.rand(3, generator=gen) * 1e-3).to(dev)
        out = dequant_mix(xb, streams[0], streams[1], streams[2], scales,
                          bits, 0.5, 0.25)
        check_floats(r, f"B8 bits={bits}", [(out, ref.dequant_mix_ref(
            xb, streams[0], streams[1], streams[2], scales, bits, 0.5,
            0.25))])
        r["checks"].append(f"bits={bits} shape={list(xb.shape)} "
                           f"max_ulp={r['max_ulp']}")
        ring_at[bits] = xb, streams, scales
    xb, streams, scales = ring_at[8]
    q_own, q_left, q_right = streams.unbind()
    call = lambda: dequant_mix(xb, q_own, q_left, q_right,  # noqa: E731
                               scales, 8, 0.5, 0.25)
    ops = device_ops(call)
    r["device_ops_per_call"] = len(ops) / OPS_CALLS
    r["device_ops"] = sorted(set(ops))
    r["graph_ops"] = graph_ops(call)
    if r["graph_ops"] != ["kernel"]:
        raise AssertionError(f"dequant_mix: graph {r['graph_ops']}, "
                             "expected one kernel a call")
    r["sass_load_order"] = loads_first("B8", load_order(
        sass_of("dequant_mix"), r"\ddequant_mix_ring_kernelILi8E"))
    out = dequant_mix(xb, q_own, q_left, q_right, scales, 8, 0.5, 0.25)
    timed(r, "", lambda: dequant_mix(xb, q_own, q_left, q_right, scales, 8,
                                     0.5, 0.25), flush)
    timed(r, "plain_", lambda: ref.dequant_mix_ref(
        xb, q_own, q_left, q_right, scales, 8, 0.5, 0.25), flush)
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(xb, q_own, q_left, q_right, scales, out), 9 * xb.numel())
    r["shape"] = list(xb.shape)
    plan_kernel_checks(dev, flush, rec["dequant_mix_plan"], n, gen)


def threefry_ops(kernel: str, n_draws: int) -> dict:
    """The operations bound of T1, T2 or T3 (``kernel`` = "threefry_split",
    "threefry_uniform" or "threefry_bits") from its compiled code: a thread
    makes one draw,
    so this run's work is ``n_draws`` times the instructions of one
    thread (by opcode); the bound is its busiest pipe."""
    per = sass_counts(sass_of("threefry"), r"\d" + kernel + r"_kernel")
    ms = pipe_ms({k: v * n_draws for k, v in per.items()})
    pipe = max(ms, key=ms.get)
    return {"ms": ms[pipe], "pipe": pipe, "pipe_ms": ms, "draws": n_draws,
            "per_draw": per, "instructions_per_draw": sum(per.values())}


def keychain_checks(dev, flush) -> dict:
    """T1, T2 and T3 against their plain versions on the card, bitwise:
    T3 (``kernels.threefry.bits``) against ``prng.random_bits_plain`` for
    R in {1, 16, 96} keys and 1-4099 draws, timed at the exact cohort's
    permutation of 16 against its plain version and its ALU bound; T1
    (``kernels.threefry.split``) against ``prng.split_plain`` for R keys
    in {1, 16, 96} split into num in {2, 3, 4, 16, 96}; T2
    (``kernels.threefry.uniform``) against ``prng.uniform_plain`` at every
    leaf size of the 2NN and of the paper's CNN for m = 16 keys, and of
    the models the dense quantized benches run at their own key counts:
    Fig. 8's CNN (``bench.cnn``) and Fig. 7's CharLSTM (``bench.charlm``).
    Timed: T1 at the quickstart's per-leaf split (one key into 6 x 16)
    and each of a round's splits; T2 at Fig. 8's w1 (its largest leaf,
    on the path whose launches the kernels line reports), and at the
    2NN's w1 (the Figs 2-5 quantized arms) and the paper CNN's w1 for 16
    clients; both against their plain versions, the launch floor
    (``floor``) and, for T2, its ALU bound from the compiled code. Then,
    by graph capture,
    one ``prng.split`` on a device key is one T1 node, and the int64
    threefry detector finds ``split_plain``'s own nodes."""
    from repro_torch import prng
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.bench import charlm, cnn
    from repro_torch.kernels import threefry
    from repro_torch.models.paper_nets import (init_2nn, init_charlstm,
                                               init_cnn)

    gen = torch.Generator().manual_seed(9)

    def keys(rows):
        return torch.randint(0, 2 ** 32, (rows, 2), generator=gen,
                             dtype=torch.int64).to(dev)

    rec = {k: {"max_abs_err": 0.0, "max_ulp": 0, "checks": []}
           for k in ("threefry_split", "threefry_uniform", "threefry_bits")}
    for rows in (1, 16, 96):
        k = keys(rows)
        for num in (2, 3, 4, 16, 96):
            check_words(f"T1 R={rows} num={num}", threefry.split(k, num),
                        prng.split_plain(k, num))
        rec["threefry_split"]["checks"].append(
            f"R={rows} num=2,3,4,16,96 bitwise")
    sizes = {}
    for model, params, m in (
            ("2nn", init_2nn(0, device="cpu"), M),
            ("cnn", init_cnn(0, device="cpu", **PAPER_MODELS["cnn"]), M),
            ("fig8", init_cnn(0, in_ch=3, img=cnn.IMG, device="cpu"), cnn.M),
            ("fig7", init_charlstm(0, vocab=charlm.VOCAB, device="cpu"),
             charlm.M)):
        k = keys(m)
        for name, t in params.items():
            n = t.numel()
            sizes[f"{model}/{name}"] = (m, n)
            check_words(f"T2 {model}/{name} [{m}, {n}]",
                        threefry.uniform(k, (n,)).view(torch.int32),
                        prng.uniform_plain(k, (n,)).view(torch.int32))
        rec["threefry_uniform"]["checks"].append(
            f"{model}: every leaf, m={m}, bitwise")
    torch.cuda.synchronize()

    r = rec["threefry_split"]
    key = keys(1)[0]
    n_leaf_keys = 6 * M
    timed(r, "", lambda: threefry.split(key, n_leaf_keys), flush)
    timed(r, "plain_", lambda: prng.split_plain(key, n_leaf_keys), flush)
    out = threefry.split(key, n_leaf_keys)
    r["sass"] = threefry_ops("threefry_split", n_leaf_keys)
    r["bound_ms"], r["bound_by"] = bound(nbytes(key, out), 0,
                                         r["sass"]["ms"])
    r["shape"] = [1, n_leaf_keys, 2]
    r["round_splits_ms"] = {}
    for rows, num in ((1, 3), (1, M), (M, K), (1, n_leaf_keys)):
        t = {}
        k = keys(rows)
        timed(t, "", lambda: threefry.split(k, num), flush)
        r["round_splits_ms"][f"[{rows}, 2] -> {num}"] = t["clean_ms"]

    r = rec["threefry_uniform"]
    for tag in ("fig8/w1", "2nn/w1", "cnn/w1"):
        m, n = sizes[tag]
        k = keys(m)
        t = {}
        timed(t, "", lambda: threefry.uniform(k, (n,)), flush)
        timed(t, "plain_", lambda: prng.uniform_plain(k, (n,)), flush)
        out = threefry.uniform(k, (n,))
        ops = threefry_ops("threefry_uniform", m * n)
        t["bound_ms"], t["bound_by"] = bound(nbytes(k, out), 0, ops["ms"])
        t["bound_bytes_ms"] = bound(nbytes(k, out), 0)[0]
        t["sass"] = ops
        t["shape"] = [m, n]
        if tag == "fig8/w1":
            r.update(t)
        else:
            r[tag.replace("/", "_")] = t

    r = rec["threefry_bits"]
    for rows in (1, 16, 96):
        k = keys(rows)
        for n in (1, 16, 257, 4099):
            check_words(f"T3 R={rows} n={n}", threefry.bits(k, (n,)),
                        prng.random_bits_plain(k, (n,)))
        r["checks"].append(f"R={rows} n=1,16,257,4099 bitwise")
    key = keys(1)[0]           # permutation(key, 16): one key, 16 draws
    timed(r, "", lambda: threefry.bits(key, (M,)), flush)
    timed(r, "plain_", lambda: prng.random_bits_plain(key, (M,)), flush)
    out = threefry.bits(key, (M,))
    r["sass"] = threefry_ops("threefry_bits", M)
    r["bound_ms"], r["bound_by"] = bound(nbytes(key, out), 0,
                                         r["sass"]["ms"])
    r["shape"] = [1, M]

    # By graph capture: a device key's split is one T1 node and nothing
    # else; the detector of int64 threefry nodes sees the plain chain's.
    key = prng.PRNGKey(1, device=dev)
    ops = graph_ops(lambda: prng.split(key, 3))
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    prng.split_plain(key, 3)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        prng.split_plain(key, 3)
    plain_nodes = graph_nodes(graph)
    graph.reset()
    rep = {"split_graph_ops": ops,
           "split_plain_graph_nodes": len(plain_nodes),
           "split_plain_int64_threefry_nodes": int64_threefry_nodes(
               plain_nodes)}
    rec["threefry_split"].update(rep)
    for name, r in rec.items():
        print(json.dumps({"check": name, **r}), flush=True)
    if ops != ["kernel"]:
        raise AssertionError(f"prng.split on the card: {ops}, expected one "
                             "kernel")
    if rep["split_plain_int64_threefry_nodes"] < 20:
        raise AssertionError(f"the int64 threefry detector misses "
                             f"split_plain's nodes: {rep}")
    return rec


def plan_operands(dev, n: int, bits: int, k: int, gen):
    """B7's operands for a flat vector of n values: x f32 [n], streams
    int32 [k, W], scales and weights f32 [k], drawn from ``gen`` (a CPU
    generator, or one on the card for a large n)."""
    from repro_torch.kernels.ref import planar_pad_len

    _, wd = planar_pad_len(n, bits)
    on = gen.device
    x = (torch.randn(n, generator=gen, device=on) * 0.05).to(dev)
    streams = torch.randint(-2 ** 31, 2 ** 31, (k, wd), generator=gen,
                            dtype=torch.int64, device=on).to(torch.int32)
    scales = torch.rand(k, generator=gen, device=on) * 1e-3
    weights = torch.rand(k, generator=gen, device=on)
    return x, streams.to(dev), scales.to(dev), weights.to(dev)


def plan_kernel_checks(dev, flush, r, n, gen):
    """B7 bitwise against the plain plan decode of the zero-padded planar
    view (``dequant_mix_plan_ref``): on one client's flat 2NN vector at 2,
    4, 8 and 16 bits and K = 1, 3, 5 and 9 through its flat entry (the
    path of ``decode_apply_plan``), its planar entry and its flat entry on
    an x one float past a 16-byte boundary; its 8-bit K = 3 SASS issues
    every load before the first decode; timed at 8 bits, K = 3 there. Then
    at the SmolLM-135M vector (8 bits, K = 5 and 3) through the flat entry:
    bitwise, and timed with its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import (dequant_mix_plan,
                                                 dequant_mix_plan_flat)

    def held(what, bits, x, streams, scales, weights):
        """Check the flat (and, for an aligned x, the planar) entry; return
        the flat output."""
        nx = x.shape[0]
        want = ref.dequant_mix_plan_ref(ref.pad_planar(x, bits), streams,
                                        scales, weights, bits)
        flat = dequant_mix_plan_flat(x, streams, scales, weights, bits)
        pairs = [(f"{what} flat", flat, want.reshape(-1)[:nx])]
        if nx == n:
            spare = torch.empty(nx + 1, device=dev)
            mis = dequant_mix_plan_flat(spare[1:].copy_(x), streams, scales,
                                        weights, bits)
            planar = dequant_mix_plan(ref.pad_planar(x, bits), streams,
                                      scales, weights, bits)
            pairs += [(f"{what} misaligned flat", mis, want.reshape(-1)[:nx]),
                      (f"{what} planar", planar, want)]
        torch.cuda.synchronize()
        for form, got, exp in pairs:
            check_words(form, got.view(torch.int32), exp.view(torch.int32))
            check_floats(r, form, [(got, exp)])
        return flat

    for bits in (2, 4, 8, 16):
        for k in (1, 3, 5, 9):
            held(f"B7 bits={bits} K={k}", bits,
                 *plan_operands(dev, n, bits, k, gen))
        r["checks"].append(f"bits={bits} K=1,3,5,9 n={n}: flat, misaligned "
                           "flat and planar entries bitwise")
    r["sass_load_order"] = loads_first("B7", load_order(
        sass_of("dequant_mix"), r"\ddequant_mix_plan_kernelILi8ELi3E"))
    x, streams, scales, weights = plan_operands(dev, n, 8, 3, gen)
    out = dequant_mix_plan_flat(x, streams, scales, weights, 8)
    timed(r, "", lambda: dequant_mix_plan_flat(x, streams, scales, weights,
                                               8), flush)
    timed(r, "plain_", lambda: ref.dequant_mix_plan_ref(
        ref.pad_planar(x, 8), streams, scales, weights, 8), flush)
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(x, streams, scales, weights, out), 3 * 3 * n)
    r["shape"] = f"x f32 [{n}] (planar [4, {streams.shape[1]}]), K=3"

    big = torch.Generator(device=dev).manual_seed(16)
    # r["smollm"] holds this run's times and bounds only (it goes on the
    # kernels line); what was derived from them goes on the check line.
    r["smollm"] = {}
    for k in (5, 3):
        x, streams, scales, weights = plan_operands(dev, SMOLLM_N, 8, k, big)
        out = held(f"B7 SmolLM-135M K={k}", 8, x, streams, scales, weights)
        rk = {}
        timed(rk, "", lambda: dequant_mix_plan_flat(x, streams, scales,
                                                    weights, 8), flush)
        timed(rk, "plain_", lambda: ref.dequant_mix_plan_ref(
            ref.pad_planar(x, 8), streams, scales, weights, 8), flush)
        rk["bound_ms"], rk["bound_by"] = bound(
            nbytes(x, streams, scales, weights, out), 3 * k * SMOLLM_N)
        r["smollm"][f"k{k}"] = rk
        r["checks"].append(
            f"SmolLM-135M x f32 [{SMOLLM_N}] (planar [4, {streams.shape[1]}]) "
            f"bits=8 K={k}: flat entry bitwise; clean at "
            f"{rk['bound_ms'] / rk['clean_ms']:.4f} of the byte bound")


def plan_times(dev, flush) -> dict:
    """B7 through its Pallas-shaped entry ``dequant_mix_plan`` (x f32
    [per, W]) at 8 bits: on one client's 2NN vector at K = 3, 5, 9, 13
    and 17 (the quickstart's complete graph has k = m = 16) and
    on the SmolLM-135M vector at K = 5 and 3, its ``kernel`` and ``clean``
    device times (:func:`time_ms`) beside the byte bound of the call. Only
    the entry's public signature is used, so the same function times
    another tree's B7."""
    import torch.nn.functional as F

    from repro_torch.kernels.dequant_mix import dequant_mix_plan
    from repro_torch.kernels.ref import planar_pad_len

    rep = {}
    for name, nx, ks in (("2nn", FLAT_2NN, (3, 5, 9, 13, 17)),
                         ("smollm", SMOLLM_N, (5, 3))):
        per, wd = planar_pad_len(nx, 8)
        gen = torch.Generator(device=dev).manual_seed(nx)
        x, streams, scales, weights = plan_operands(dev, nx, 8, max(ks), gen)
        x2d = F.pad(x, (0, per * wd - nx)).reshape(per, wd)
        del x
        for k in ks:
            args = (x2d, streams[:k], scales[:k].contiguous(),
                    weights[:k].contiguous())
            rk = {}
            out = dequant_mix_plan(*args, 8)
            timed(rk, "", lambda: dequant_mix_plan(*args, 8), flush)
            rk["bound_ms"] = bound(nbytes(*args, out), 0)[0]
            rep[f"{name}_k{k}"] = rk
    return {"plan_times": rep}


def device_ops(fn, calls: int = OPS_CALLS, tries: int = 3) -> list[str]:
    """Names of the device operations (kernels, copies, fills) ``calls``
    calls of ``fn`` make, from a ``torch.profiler`` trace. A first trace,
    around a warm-up call, is left out: the first trace of a process can
    miss its first kernels. A trace can also lose kernels later in a
    process (it never adds one), so ``tries`` traces are taken and the
    longest is returned."""
    from torch.profiler import ProfilerActivity, profile

    best: list[str] = []
    for n in (1,) + (calls,) * tries:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if n == calls and len(names) > len(best):
            best = names
    return best


class _Memcpy3D(ctypes.Structure):
    """``CUDA_MEMCPY3D`` of the CUDA driver API: a copy node's
    parameters."""
    _fields_ = ([(f, ctypes.c_size_t) for f in ("srcX", "srcY", "srcZ",
                                                 "srcLOD")]
                + [("srcType", ctypes.c_int), ("srcHost", ctypes.c_void_p),
                   ("srcDevice", ctypes.c_uint64),
                   ("srcArray", ctypes.c_void_p),
                   ("reserved0", ctypes.c_void_p)]
                + [(f, ctypes.c_size_t) for f in ("srcPitch", "srcHeight",
                                                   "dstX", "dstY", "dstZ",
                                                   "dstLOD")]
                + [("dstType", ctypes.c_int), ("dstHost", ctypes.c_void_p),
                   ("dstDevice", ctypes.c_uint64),
                   ("dstArray", ctypes.c_void_p),
                   ("reserved1", ctypes.c_void_p)]
                + [(f, ctypes.c_size_t) for f in ("dstPitch", "dstHeight",
                                                   "width", "height",
                                                   "depth")])


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the CUDA driver API: a kernel
    node's parameters (its function as a ``CUfunction`` or a
    ``CUkernel``)."""
    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in (
                    "gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                    "blockDimY", "blockDimZ", "sharedMemBytes")]
                + [(f, ctypes.c_void_p) for f in ("kernelParams", "extra",
                                                  "kern", "ctx")])


def graph_nodes(graph) -> list[tuple[str, str]]:
    """Every node of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    as (operation, name): the operation "kernel", "fill", "copy XtoY" (X,
    Y: H host, D device, A array, for the copy's source and destination)
    or "node <CUgraphNodeType>"; the name a kernel node's function name
    (mangled; "?" where CUDA names none), else ""."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphMemcpyNodeGetParams.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Memcpy3D)]
    cuda.cuGraphKernelNodeGetParams_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    cuda.cuPointerGetAttribute.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_uint64]
    get_name = {"func": cuda.cuFuncGetName,
                "kern": getattr(cuda, "cuKernelGetName", None)}
    for fn in get_name.values():
        if fn is not None:
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]

    def memory(kind: int, address: int) -> str:
        """H, D or A for a ``CUmemorytype`` (1 host, 2 device, 3 array,
        4 unified: then the pointer's own; memory CUDA does not know is
        pageable host memory)."""
        if kind == 4:
            own = ctypes.c_uint(0)
            kind = (1 if cuda.cuPointerGetAttribute(  # MEMORY_TYPE
                ctypes.byref(own), 2, address) else own.value)
        return {1: "H", 2: "D", 3: "A"}.get(kind, "?")

    def kernel_name(node) -> str:
        p = _KernelNodeParams()
        if cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)):
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        for field, fn in get_name.items():
            name = ctypes.c_char_p()
            handle = getattr(p, field)
            if fn is not None and handle and not fn(ctypes.byref(name),
                                                    handle):
                return name.value.decode()
        return "?"

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cuda.cuGraphGetNodes(handle, nodes,
                                            ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    out = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value == 0:
            out.append(("kernel", kernel_name(node)))
        elif kind.value == 1:
            p = _Memcpy3D()
            if cuda.cuGraphMemcpyNodeGetParams(node, ctypes.byref(p)):
                raise RuntimeError("cuGraphMemcpyNodeGetParams failed")
            out.append((f"copy {memory(p.srcType, p.srcDevice)}to"
                        f"{memory(p.dstType, p.dstDevice)}", ""))
        else:
            out.append(({2: "fill"}.get(kind.value, f"node {kind.value}"),
                        ""))
    return out


def graph_ops(fn) -> list[str]:
    """The device operations one call of ``fn`` makes, as the nodes of a
    CUDA graph captured around the call (:func:`graph_nodes`). A capture
    holds every operation the call enqueues, a pinned host copy too; a
    profiler trace on the card's machine can lose kernels and copies."""
    fn()                                  # first-use loads outside it
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    ops = [op for op, _ in graph_nodes(graph)]
    graph.reset()
    return ops


def demangle(name: str) -> str:
    """A mangled C++ function name as ``c++filt`` prints it, by the C++
    runtime's ``__cxa_demangle``; a name that is not mangled as it is."""
    lib = ctypes.CDLL("libstdc++.so.6")
    fn = getattr(lib, "__cxa_demangle")
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_void_p
    status = ctypes.c_int(-1)
    out = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value or not out:
        return name
    text = ctypes.string_at(out).decode()
    libc = ctypes.CDLL(None)
    libc.free.argtypes = [ctypes.c_void_p]
    libc.free(out)
    return text


def int64_threefry_nodes(nodes) -> int:
    """Kernel nodes among a graph's nodes (:func:`graph_nodes`) that do the
    int64 tensor threefry's bitwise work (:data:`INT64_THREEFRY`)."""
    return sum(1 for op, name in nodes
               if op == "kernel" and INT64_THREEFRY.search(demangle(name)))


def floor_time(flush) -> dict:
    """The floor of the event times: one launch that moves 4 bytes
    (``zero_`` of a one-element tensor), timed as every kernel is."""
    t = torch.ones(1, device=flush.device)
    r = {}
    timed(r, "", t.zero_, flush)
    return r


def entry_points(dev, runs: int = 200) -> dict:
    """``encode_delta``, ``decode_apply_ring`` and ``decode_apply_plan``
    as a caller sees them, on one client's flat 2NN vector at 8 bits
    (the plan with k = 3): the host clock around one call ended by
    ``torch.cuda.synchronize()`` (median of ``runs`` after a warm-up),
    and the device operations one call makes (profiler). Only the entry
    points' public signatures are used, so the same function times
    another tree's package."""
    from repro_torch import prng
    from repro_torch.kernels import (decode_apply_plan, decode_apply_ring,
                                     encode_delta, ref)

    gen = torch.Generator().manual_seed(4)
    n = FLAT_2NN
    _, wd = ref.planar_pad_len(n, 8)
    x = (torch.randn(n, generator=gen) * 0.05).to(dev)
    delta = (torch.randn(n, generator=gen) * 0.01).to(dev)
    q = (torch.randint(-2 ** 31, 2 ** 31, (3, wd), generator=gen,
                       dtype=torch.int64).to(torch.int32).to(dev))
    q_own, q_left, q_right = (t.clone() for t in q)
    scales = (torch.rand(3, generator=gen) * 1e-3).to(dev)
    weights = torch.tensor([0.5, 0.25, 0.25]).to(dev)
    key = prng.PRNGKey(8)
    calls = {
        "encode_delta": lambda: encode_delta(delta, 8, key=key),
        "decode_apply_ring": lambda: decode_apply_ring(
            x, q_own, q_left, q_right, scales, bits=8, w_self=0.5,
            w_nb=0.25),
        "decode_apply_plan": lambda: decode_apply_plan(
            x, q, scales, weights, bits=8)}
    rep = {}
    for name, fn in calls.items():
        for _ in range(WARMUP):
            fn()
        ms = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ops = device_ops(fn)
        rep[name] = {"call_ms_median": statistics.median(ms),
                     "call_ms_quartiles": statistics.quantiles(ms, n=4),
                     "device_ops_per_call": len(ops) / OPS_CALLS,
                     "device_ops": sorted(set(ops)),
                     "graph_ops": graph_ops(fn)}
    return {"entry_points": rep}


def check_entry_points(entry: dict) -> None:
    """By the nodes of one captured call: ``encode_delta`` copies only
    from the device to the device, and each decode is one device operation a call, a
    kernel. The profiler's names are listed beside them, not checked: its
    traces on the card's machine lose records, so a short list proves
    nothing."""
    calls = entry["entry_points"]
    copies = [op for op in calls["encode_delta"]["graph_ops"]
              if op.startswith("copy") and op != "copy DtoD"]
    if copies:
        raise AssertionError(f"encode_delta copies other than on the "
                             f"device: {copies}")
    for name in ("decode_apply_ring", "decode_apply_plan"):
        got = calls[name]
        if got["graph_ops"] != ["kernel"]:
            raise AssertionError(f"{name}: device operations {got}, "
                                 "expected one kernel a call")


def expected_launches(fuse_round: bool) -> dict:
    """Launch counts of ROUNDS quickstart rounds: one encode and one
    decode a round, B3 once per applied local step over all leaves (K
    unfused, K - 2 fused: B4 and B5 apply the last two), and T1 once a
    split (SPLITS_A_ROUND a round, fused too)."""
    expect = {k: 0 for k in KERNEL_SOURCES}
    expect["threefry_split"] = ROUNDS * SPLITS_A_ROUND
    if fuse_round:
        expect.update(momentum_quantize_pack_buffer=ROUNDS,
                      dequant_mix_momentum_buffer=ROUNDS,
                      momentum_sgd=ROUNDS * (K - 2))
    else:
        expect.update(quantize_pack_buffer=ROUNDS, dequant_mix_buffer=ROUNDS,
                      momentum_sgd=ROUNDS * K)
    return expect


def round_path(dev, fuse_round: bool):
    """Phase 5: ROUNDS quickstart rounds through the library API, with
    the launch counters read around exactly that run."""
    from repro_torch import prng
    from repro_torch.core import init_round_state
    from repro_torch.kernels import launch_counts, reset_launch_counts

    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
        dev, fuse_round)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    state = init_round_state(stacked, prng.PRNGKey(1))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, cons, round_ms = [], [], []
    for t in range(ROUNDS):
        t0 = time.perf_counter()
        state, met = step(state, batches[t])
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        cons.append(float(met["consensus_dist"]))
    counts = launch_counts()
    expect = expected_launches(fuse_round)
    name = "fused" if fuse_round else "unfused"
    print(json.dumps({"path": f"quickstart {name}", "rounds": ROUNDS,
                      "loss": losses, "consensus_dist": cons,
                      "round_ms": round_ms, "launches": counts,
                      "expected_launches": expect}), flush=True)
    if counts != expect:
        raise AssertionError(f"{name} launch counts {counts} != {expect}")
    if not all(math.isfinite(v) for v in losses + cons):
        raise AssertionError(f"{name}: non-finite loss or consensus")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    for n, t in state.params.items():
        if t.shape != stacked[n].shape or not torch.isfinite(t).all():
            raise AssertionError(f"{name} leaf {n}: bad shape or non-finite")
    return counts, statistics.median(round_ms[1:]), losses


def ops_path(dev):
    """Phase 5: each per-tensor ``ops`` entry point once on one client's
    flat 2NN vector, with the launch counters read around exactly those
    calls; then the same calls on the CPU (plain versions) must agree:
    words and scale bitwise, floats within MAX_ULP."""
    from repro_torch import prng
    from repro_torch.kernels import (decode_apply_plan, decode_apply_ring,
                                     encode_delta, launch_counts,
                                     momentum_update_flat, ref,
                                     reset_launch_counts)

    gen = torch.Generator().manual_seed(3)
    n = FLAT_2NN
    _, wd = ref.planar_pad_len(n, 8)
    x, delta, y, v, g = (torch.randn(n, generator=gen) * sc
                         for sc in (0.05, 0.01, 0.05, 0.01, 0.1))
    streams = torch.randint(-2 ** 31, 2 ** 31, (3, wd), generator=gen,
                            dtype=torch.int64).to(torch.int32)
    scales = torch.rand(3, generator=gen) * 1e-3
    weights = torch.tensor([0.5, 0.25, 0.25])
    key = prng.PRNGKey(8)

    def calls(d):
        t = [a.to(d) for a in (x, delta, y, v, g, streams, scales, weights)]
        xd, dd, yd, vd, gd, sd, scd, wtd = t
        return {"encode_delta": encode_delta(dd, 8, key=key),
                "decode_apply_ring": decode_apply_ring(
                    xd, sd[0], sd[1], sd[2], scd, bits=8, w_self=0.5,
                    w_nb=0.25),
                "decode_apply_plan": decode_apply_plan(xd, sd, scd, wtd,
                                                       bits=8),
                "momentum_update_flat": momentum_update_flat(yd, vd, gd, ETA,
                                                             THETA)}

    torch.cuda.synchronize()
    reset_launch_counts()
    got = calls(dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {k: 0 for k in KERNEL_SOURCES}
    expect.update(quantize_pack=1, dequant_mix=1, dequant_mix_plan=1,
                  momentum_sgd=1)
    want = calls("cpu")
    words, s = got["encode_delta"]
    rep = {"path": "ops", "launches": counts, "expected_launches": expect,
           "encode_delta_bitwise": bool(
               torch.equal(words.cpu(), want["encode_delta"][0])
               and s.cpu().numpy().tobytes()
               == want["encode_delta"][1].numpy().tobytes()),
           "max_ulp_vs_cpu": {}}
    for name in ("decode_apply_ring", "decode_apply_plan",
                 "momentum_update_flat"):
        outs = got[name] if isinstance(got[name], tuple) else (got[name],)
        refs = want[name] if isinstance(want[name], tuple) else (want[name],)
        rep["max_ulp_vs_cpu"][name] = max(ulp_diff(a.cpu(), b)
                                          for a, b in zip(outs, refs))
    print(json.dumps(rep), flush=True)
    if counts != expect:
        raise AssertionError(f"ops launch counts {counts} != {expect}")
    if not rep["encode_delta_bitwise"]:
        raise AssertionError("encode_delta on the card differs from the CPU")
    if max(rep["max_ulp_vs_cpu"].values()) > MAX_ULP:
        raise AssertionError(f"ops entry points vs CPU: {rep}")
    return counts


def round_vs_cpu(dev, fuse_round: bool) -> tuple[dict, dict]:
    """One quickstart round on the card against the same round on the
    CPU (plain versions)."""
    from repro_torch import prng
    from repro_torch.core import init_round_state, make_round_step
    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
        dev, fuse_round)
    b = fed.round_batches(0, K=K, batch=BATCH, device="cpu")
    s_gpu, m_gpu = step(init_round_state(stacked, prng.PRNGKey(1)),
                        {n: t.to(dev) for n, t in b.items()})
    step_cpu = make_round_step(loss_fn, cfg, spec, device="cpu")
    s_cpu, m_cpu = step_cpu(init_round_state(
        {n: t.cpu() for n, t in stacked.items()}, prng.PRNGKey(1)), b)
    loss_rel = abs(float(m_gpu["loss"]) / float(m_cpu["loss"]) - 1)
    cons_rel = abs(float(m_gpu["consensus_dist"])
                   / float(m_cpu["consensus_dist"]) - 1)
    far = sum(int(((s_gpu.params[n].cpu() - s_cpu.params[n]).abs()
                   > 1e-5).sum()) for n in stacked)
    total = sum(t.numel() for t in stacked.values())
    rep = {"loss_rel": loss_rel, "consensus_rel": cons_rel,
           "params_off_by_1e-5": far, "params": total}
    if loss_rel > 1e-5 or cons_rel > 1e-3 or far > 1e-3 * total:
        raise AssertionError(f"card round (fuse_round={fuse_round}) "
                             f"disagrees with CPU round: {rep}")
    return rep, s_gpu.params


def reference_checks(dev):
    """Phase 4, at full width: the unfused and the fused round on the
    card against the CPU; the plan mixer against the dense mixer, and
    the fused plan tail against the fused dense tail, on the card."""
    from repro_torch import prng
    from repro_torch.core import MixerConfig, make_mixer
    from repro_torch.core.local_sgd import local_train_deferred
    from repro_torch.core.mixing import make_fused_tail

    rep = {}
    rep["round_vs_cpu"], x = round_vs_cpu(dev, False)
    rep["fused_round_vs_cpu"], _ = round_vs_cpu(dev, True)
    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(dev)
    z = {n: t + 0.01 * torch.randn_like(t) for n, t in x.items()}
    key = prng.PRNGKey(5, device=dev)
    ring = make_mixer(spec, MixerConfig(impl="ring", quant=cfg.quant),
                      device=dev)(x, z, key)
    dense = make_mixer(spec, MixerConfig(impl="dense", quant=cfg.quant),
                       device=dev)(x, z, key)
    rep["ring_vs_dense_mixer_max_abs"] = max(
        float((ring[n] - dense[n]).abs().max()) for n in x)

    ck = prng.split(prng.PRNGKey(6), M)
    b = fed.round_batches(1, K=K, batch=BATCH, device=dev)
    sk = prng.split(ck, K)
    y, v, g, _ = local_train_deferred(loss_fn, x, b, sk, eta=ETA, theta=THETA)
    args = (x, y, v, g, {n: t[:, K - 1] for n, t in b.items()},
            sk[:, K - 1], key)
    tails = [make_fused_tail(loss_fn, M, eta=ETA, theta=THETA,
                             quant=cfg.quant, plan=plan, W=spec.W,
                             device=dev)(*args)
             for plan in (spec.gossip_plan(), None)]
    rep["fused_plan_vs_dense_tail_max_abs"] = max(
        float((tails[0][0][n] - tails[1][0][n]).abs().max()) for n in x)
    print(json.dumps(rep), flush=True)
    for k in ("ring_vs_dense_mixer_max_abs",
              "fused_plan_vs_dense_tail_max_abs"):
        if rep[k] > 1e-5:
            raise AssertionError(f"{k}: {rep[k]}")
    return rep


def _kernel_group(name: str) -> str:
    # Longest names first: "quantize_pack_buffer_kernel" is inside
    # "momentum_quantize_pack_buffer_kernel". T1, T2 and T3 are
    # "threefry_split_kernel", "threefry_uniform_kernel" and
    # "threefry_bits_kernel".
    for kernel in sorted(KERNEL_SOURCES, key=len, reverse=True):
        if f"{kernel}_kernel" in name:
            return kernel
    if any(k in name for k in ("gemm", "xmma", "nvjet", "cutlass")):
        return "matmul"
    if "<long" in name or "long," in name:
        return "int64 elementwise"
    return "other elementwise, reductions, copies"


def profile_rounds(step, state, batches) -> dict:
    """A torch.profiler trace of len(batches) rounds: device busy time,
    idle share, kernels launched and device time by group."""
    from torch.profiler import ProfilerActivity, profile

    n_rounds = len(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    busy_ms = sum(groups.values()) / 1e3
    return {"profile_rounds": n_rounds,
            "profiled_wall_ms_per_round": wall_ms / n_rounds,
            "device_busy_ms_per_round": busy_ms / n_rounds,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ops_per_round": n_kernels / n_rounds,
            "device_us_per_round_by_group": {
                k: v / n_rounds for k, v in
                sorted(groups.items(), key=lambda kv: -kv[1])}}


def round_breakdown(dev, n_rounds: int = 9) -> tuple[dict, dict]:
    """Phase 6, where a quickstart round's time goes: host-clock times of
    the unfused round's phases (each ended by a synchronize; median of
    n_rounds) and of ``noise_stacked`` alone — the plain-torch noise
    that neither round draws any more (keyed B1 and B4 draw it) — with
    an unfused and a fused round timed in turn in every pass, so the two
    share the host's drift; then a profile of 5 unfused and 5 fused
    rounds."""
    from repro_torch import prng
    from repro_torch.core import MixerConfig, init_round_state, make_mixer
    from repro_torch.core.local_sgd import local_train
    from repro_torch.core.mixing import _quant_leaf_keys
    from repro_torch.core.wire_layout import WireLayout

    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(n_rounds + 1)]
    state = init_round_state(stacked, prng.PRNGKey(1))
    state, _ = step(state, batches[-1])              # warm-up
    fstep = quickstart_setup(dev, fuse_round=True)[-1]
    fstate = init_round_state(stacked, prng.PRNGKey(1))
    fstate, _ = fstep(fstate, batches[-1])           # warm-up
    mixer = make_mixer(spec, MixerConfig(quant=cfg.quant), device=dev)
    layout = WireLayout.for_tree(stacked, cfg.quant.bits, stacked=True)
    keys = prng.split(prng.PRNGKey(2, device=dev), M)
    key = prng.PRNGKey(3, device=dev)
    x = state.params
    z, _ = local_train(loss_fn, x, batches[0], keys, eta=ETA, theta=THETA)
    mixer(x, z, key)                                 # warm-up
    phases: dict[str, list] = {"round": [], "fused_round": [],
                               "local_sgd": [], "mix": [],
                               "noise_stacked_alone": []}
    for b in batches[:n_rounds]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, _ = local_train(loss_fn, x, b, keys, eta=ETA, theta=THETA)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mixer(x, z, key)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        layout.noise_stacked(_quant_leaf_keys(key, layout.n_leaves, M))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        fstep(fstate, b)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        phases["local_sgd"].append((t1 - t0) * 1e3)
        phases["mix"].append((t2 - t1) * 1e3)
        phases["noise_stacked_alone"].append((t3 - t2) * 1e3)
        phases["round"].append((t4 - t3) * 1e3)
        phases["fused_round"].append((t5 - t4) * 1e3)

    rep = {"path": "quickstart unfused",
           "phase_ms_median": {k: statistics.median(v)
                               for k, v in phases.items()},
           "phase_ms": phases,
           **profile_rounds(step, state, batches[:5])}
    print(json.dumps(rep), flush=True)
    frep = {"path": "quickstart fused",
            **profile_rounds(fstep, fstate, batches[:5])}
    print(json.dumps(frep), flush=True)
    return rep, frep


def kernel_nodes(nodes) -> dict:
    """Kernel nodes of each of the port's kernels among a graph's
    nodes (:func:`graph_nodes`), by their functions' names."""
    counts = {k: 0 for k in KERNEL_SOURCES}
    for op, name in nodes:
        if op == "kernel" and _kernel_group(name) in counts:
            counts[_kernel_group(name)] += 1
    return counts


def check_round_graph(what: str, nodes, expect: dict) -> dict:
    """A captured round's graph: exactly ``expect`` kernel nodes of each
    of the port's kernels, no copy from host memory and no node of the
    int64 tensor threefry (the key chain is T1 and T2 alone)."""
    got = kernel_nodes(nodes)
    host = [op for op, _ in nodes if op.startswith("copy H")]
    rep = {"graph_nodes": len(nodes), "kernel_nodes": got,
           "expected_kernel_nodes": expect, "host_copies": host,
           "int64_threefry_nodes": int64_threefry_nodes(nodes),
           "ops": {op: sum(1 for o, _ in nodes if o == op)
                   for op in sorted({o for o, _ in nodes})}}
    if got != expect:
        raise AssertionError(f"{what}: kernel nodes {got} != {expect}")
    if host:
        raise AssertionError(f"{what}: copies from host memory {host}")
    if rep["int64_threefry_nodes"]:
        raise AssertionError(f"{what}: {rep['int64_threefry_nodes']} int64 "
                             "threefry nodes")
    return rep


def captured_rounds(dev, fuse_round: bool) -> dict:
    """ROUNDS quickstart rounds eagerly and ROUNDS through
    ``capture_step`` from one state and key (:func:`captured_vs_eager`);
    the graph must hold exactly one round's kernel nodes of each kernel
    (``expected_launches`` / ROUNDS)."""
    from repro_torch import prng
    from repro_torch.core import init_round_state

    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
        dev, fuse_round)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    name = "fused" if fuse_round else "unfused"
    return captured_vs_eager(
        f"captured quickstart {name}", step,
        lambda: quickstart_setup(dev, fuse_round)[-1],
        init_round_state(stacked, prng.PRNGKey(1)), batches,
        {k: v // ROUNDS for k, v in expected_launches(fuse_round).items()})


def captured_vs_eager(what: str, step, make_step, s0, batches,
                      expect_nodes: dict) -> dict:
    """len(batches) rounds of ``step`` eagerly and as many through
    ``capture_step`` of a step of its own (``make_step()``) from one
    state ``s0``, a round of each in turn: parameters, key (and every
    other tensor of the state), ``loss`` and
    ``consensus_dist`` must agree bitwise (else within the trajectory
    contract, with the rounds where they part printed); the graph must
    hold exactly ``expect_nodes`` kernel nodes of each kernel, no copy
    from host memory and no int64 threefry node. Each round is timed by
    the host clock to a synchronize (the eager rounds with their batch
    on the device, the captured ones copying it into the graph's
    buffers), and one replay's device time by events (``replay_ms``);
    the launch counters are read around the eager rounds (a replay
    launches nothing from the host)."""
    from repro_torch.core import capture_step
    from repro_torch.kernels import launch_counts, reset_launch_counts

    # A step of its own that only ``run`` holds, as when a caller writes
    # ``step = capture_step(step, ...)``: the graph reads tensors the step
    # owns, and the eager rounds below reuse any memory freed with it.
    own_step = make_step()
    t0 = time.perf_counter()
    run = capture_step(own_step, s0, batches[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    del own_step
    gc.collect()
    states = {"eager": s0, "captured": s0}
    metrics = {"eager": [], "captured": []}
    round_ms = {"eager": [], "captured": []}
    round_ulp, rng_equal = [], True
    reset_launch_counts()
    for b in batches:
        for mode, fn in (("eager", step), ("captured", run)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[mode], met = fn(states[mode], b)
            torch.cuda.synchronize()
            round_ms[mode].append((time.perf_counter() - t0) * 1e3)
            metrics[mode].append([float(met[k]) for k in (
                "loss", "consensus_dist", "active_frac") if k in met])
        round_ulp.append(max(ulp_diff(states["eager"].params[n],
                                      states["captured"].params[n])
                             for n in s0.params))
        # The key and every other tensor of the state: a stateful
        # schedule's walk token, an async state's clock, versions and
        # clock key.
        for f in s0._fields:
            a, b = getattr(states["eager"], f), getattr(states["captured"], f)
            if isinstance(a, torch.Tensor):
                rng_equal &= torch.equal(a, b)
    counts = launch_counts()
    nodes = graph_nodes(run.graph)
    device_ms = replay_ms(run.graph)
    bitwise = (max(round_ulp) == 0 and rng_equal
               and metrics["eager"] == metrics["captured"])
    rep = {"path": what, "rounds": len(batches),
           "capture_s": capture_s, "bitwise": bitwise,
           "max_ulp_by_round": round_ulp, "rng_equal": rng_equal,
           "loss_consensus": metrics, "eager_launches": counts,
           "round_ms_median": {k: statistics.median(v[1:])
                               for k, v in round_ms.items()},
           "replay_device_ms": device_ms, "round_ms": round_ms,
           **check_round_graph(what, nodes, expect_nodes)}
    if not bitwise:
        rep["first_round_apart"] = next(
            (t for t in range(len(batches)) if round_ulp[t]
             or metrics["eager"][t] != metrics["captured"][t]), None)
    print(json.dumps(rep), flush=True)
    if not rng_equal:
        raise AssertionError(f"{what}: captured key chain or state differs")
    for (le, ce, *_), (lc, cc, *_) in zip(metrics["eager"],
                                          metrics["captured"]):
        if abs(lc / le - 1) > 1e-5 or abs(cc / ce - 1) > 1e-3:
            raise AssertionError(f"{what}: captured rounds leave the "
                                 f"trajectory contract: {metrics}")
    for n, t in states["captured"].params.items():
        if t.shape != s0.params[n].shape or not torch.isfinite(t).all():
            raise AssertionError(f"{what} leaf {n}: bad shape or non-finite")
    return rep


def full_width_setup(dev, model: str):
    """The paper's CNN (``PAPER_MODELS["cnn"]``: 28x28x1, 1 663 370
    parameters, on one channel of 28x28 template images) or CharLSTM
    (``PAPER_MODELS["charlstm"]``: vocab 90, 820 522 parameters, on one
    ``char_stream`` a client) at full width, with FULL_WIDTH's clients,
    local steps and batch, on ``ring(m, 0.5)`` with the 8-bit stochastic
    lemma5 wire on the ring plan (B1, B2, B3, T1). Returns (stacked
    params, step, make_step, batch_of(t) on the device, classes)."""
    import dataclasses

    from repro_torch.bench.charlm import lm_batches
    from repro_torch.bench.common import loss_charlm, loss_cnn, stacked
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                                  make_round_step)
    from repro_torch.data import (FederatedDataset, char_stream,
                                  classification_dataset)
    from repro_torch.models.paper_nets import init_charlstm, init_cnn

    c = FULL_WIDTH[model]
    m, k = c["m"], c["K"]
    if model == "cnn":
        data = classification_dataset(n=8000, image=True, img_side=28,
                                      noise=c["noise"], seed=0)
        fed = FederatedDataset.make(dataclasses.replace(
            data, x=np.ascontiguousarray(data.x[..., :1])), m, iid=True)
        params = stacked(init_cnn(0, device=dev, **PAPER_MODELS["cnn"]), m)
        loss_fn, classes = loss_cnn, PAPER_MODELS["cnn"]["n_classes"]

        def batch_of(t):
            return fed.round_batches(t, K=k, batch=c["batch"], device=dev)
    else:
        vocab = PAPER_MODELS["charlstm"]["vocab"]
        streams = [char_stream(4000, vocab=vocab, bias_seed=i, seed=i)
                   for i in range(m)]
        params = stacked(init_charlstm(0, device=dev,
                                       **PAPER_MODELS["charlstm"]), m)
        loss_fn, classes = loss_charlm, vocab

        def batch_of(t):
            return {n: x.to(dev) for n, x in lm_batches(
                streams, t, K=k, batch=c["batch"], seq=c["seq"]).items()}

    def make_step():
        return make_round_step(loss_fn, DFedAvgMConfig(
            eta=c["eta"], theta=THETA, local_steps=k,
            quant=QuantConfig(bits=8)), MixingSpec.ring(m, self_weight=0.5),
            device=dev)

    return params, make_step(), make_step, batch_of, classes


def full_width(dev) -> dict:
    """The paper's CNN and CharLSTM at full width (:func:`full_width_setup`):
    ROUNDS eager rounds with their launch counts (B1 = B2 = ROUNDS, B3 =
    K x ROUNDS, T1 = SPLITS_A_ROUND x ROUNDS) against ROUNDS captured
    rounds, bitwise (:func:`captured_vs_eager`); each graph holds
    exactly B1 = B2 = 1, B3 = K, T1 = SPLITS_A_ROUND kernel nodes. Losses
    finite, the last LOSS_MARGIN below ln(classes)."""
    from repro_torch import prng
    from repro_torch.core import init_round_state

    out = {}
    for model, c in FULL_WIDTH.items():
        params, step, make_step, batch_of, classes = full_width_setup(
            dev, model)
        batches = [batch_of(t) for t in range(ROUNDS)]
        per_round = dict.fromkeys(KERNEL_SOURCES, 0)
        per_round.update(quantize_pack_buffer=1, dequant_mix_buffer=1,
                         momentum_sgd=c["K"], threefry_split=SPLITS_A_ROUND)
        rep = captured_vs_eager(
            f"full width {model}", step, make_step,
            init_round_state(params, prng.PRNGKey(1)), batches, per_round)
        expect = {k: v * ROUNDS for k, v in per_round.items()}
        losses = [lc[0] for lc in rep["loss_consensus"]["eager"]]
        summary = {"path": f"full width {model}", "config": c,
                   "params_per_client": sum(
                       t[0].numel() for t in params.values()),
                   "param_mb": sum(t.numel() * t.element_size()
                                   for t in params.values()) / 1e6,
                   "round_ms_median": rep["round_ms_median"],
                   "graph_nodes": rep["graph_nodes"],
                   "kernel_nodes": rep["kernel_nodes"],
                   "loss_first_last": [losses[0], losses[-1]],
                   "loss_gate": math.log(classes) - LOSS_MARGIN,
                   "launches": rep["eager_launches"],
                   "expected_launches": expect}
        print(json.dumps(summary), flush=True)
        if rep["eager_launches"] != expect:
            raise AssertionError(f"full width {model}: launches "
                                 f"{rep['eager_launches']} != {expect}")
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < summary["loss_gate"]:
            raise AssertionError(f"full width {model}: losses {losses}")
        out[model] = summary
    return out


def median_round_ms(fn, state, batches, move_to=None) -> float:
    """Median host-clock ms of rounds 2..len(batches) of ``fn(state, b)``
    from ``state``, each round ended by a synchronize; with ``move_to``
    each batch is moved there inside the round's time."""
    times = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if move_to is not None:
            b = {n: x.to(move_to) for n, x in b.items()}
        state, _ = fn(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def replay_ms(graph, reps: int = 20) -> float:
    """Device ms of one replay: CUDA events around ``reps`` back-to-back
    replays (the host enqueues a replay far faster than the card runs
    it), so the gaps between the graph's nodes are in and the host's
    time between rounds is not."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def captured_round_ms(dev) -> dict:
    """The captured quickstart round, unfused and fused: its host-clock
    ms (median of rounds 2..ROUNDS, batches on the device), one replay's
    device ms and the graph's nodes. Public names only, so
    ``chip_turns.py`` can time another tree's round with it."""
    from repro_torch import prng
    from repro_torch.core import capture_step, init_round_state

    out = {}
    for fuse_round in (False, True):
        _, fed, stacked, _, _, _, step = quickstart_setup(dev, fuse_round)
        batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
                   for t in range(ROUNDS)]
        s0 = init_round_state(stacked, prng.PRNGKey(1))
        run = capture_step(step, s0, batches[0])
        out["fused" if fuse_round else "unfused"] = {
            "round_ms": median_round_ms(run, s0, batches),
            "replay_device_ms": replay_ms(run.graph),
            "graph_nodes": len(graph_nodes(run.graph))}
    return out


def round_times(dev, passes: int = 2) -> dict:
    """Round time by the host clock to a synchronize (median of rounds
    2..ROUNDS), eager against captured, unfused and fused, all in turns
    in this process (each pass runs every variant, the next pass in the
    reverse order). Captured: the batch already in the graph's buffers
    (``static``), copied from batches on the device (``device``), or
    from the host (``host``, as a bench loop does); eager: batches on
    the device, or from the host. Then a profile of 5 replays (device
    busy, idle share), the device time of a replay by events, and the
    device cost of the no-alias clones and the copies into the graph's
    buffers."""
    from repro_torch import prng
    from repro_torch.core import capture_step, init_round_state

    variants, rep = {}, {}
    runs = {}
    for fuse_round in (False, True):
        name = "fused" if fuse_round else "unfused"
        data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
            dev, fuse_round)
        host = [fed.round_batches(t, K=K, batch=BATCH, device="cpu")
                for t in range(ROUNDS)]
        on_dev = [{n: x.to(dev) for n, x in b.items()} for b in host]
        s0 = init_round_state(stacked, prng.PRNGKey(1))
        run = capture_step(step, s0, on_dev[0])
        runs[name] = (run, s0, on_dev)
        variants[f"{name} eager"] = (s0, step, on_dev, False)
        variants[f"{name} eager, host batches"] = (s0, step, host, True)
        variants[f"{name} captured, static"] = (
            s0, run, [run.static_batches] * ROUNDS, False)
        variants[f"{name} captured"] = (s0, run, on_dev, False)
        variants[f"{name} captured, host batches"] = (s0, run, host, False)
    order = list(variants)
    ms = {v: [] for v in order}
    for p in range(passes):
        for v in (order if p % 2 == 0 else order[::-1]):
            state, fn, batches, move = variants[v]
            ms[v].append(median_round_ms(fn, state, batches,
                                         dev if move else None))
    rep["round_ms_median_by_pass"] = ms
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    for name, (run, s0, on_dev) in runs.items():
        st, met = run(s0, on_dev[0])
        targets = ({n: torch.empty_like(t) for n, t in st.params.items()},
                   torch.empty_like(st.rng),
                   {n: torch.empty_like(b) for n, b in on_dev[0].items()})

        def copy_in():
            for n, t in st.params.items():
                targets[0][n].copy_(t)
            targets[1].copy_(st.rng)
            for n, b in on_dev[1].items():
                targets[2][n].copy_(b)

        def clone_out():
            return ({n: t.clone() for n, t in st.params.items()},
                    st.rng.clone(), {k: v.clone() for k, v in met.items()})

        r = {}
        timed(r, "clone_out_", clone_out, flush)
        timed(r, "copy_in_", copy_in, flush)
        device_ms = replay_ms(run.graph)
        rep[f"{name} captured"] = {
            "replay_device_ms": device_ms,
            # The device idles only between replays: the host's copy-in,
            # replay launch and clones against the round's host time.
            "idle_share": 1 - device_ms / statistics.median(
                ms[f"{name} captured"]),
            **{k: r[k] for k in ("clone_out_ms", "clone_out_clean_ms",
                                 "clone_out_host_ms", "copy_in_ms",
                                 "copy_in_clean_ms", "copy_in_host_ms")},
            **profile_rounds(run, s0, on_dev[:5])}
    del flush
    print(json.dumps({"round_times": rep}), flush=True)
    return rep


class HostTimer:
    """Host time by group of an eager round: wraps functions so that each
    call adds its own time, less the wrapped calls inside it, to its
    group (wrapping adds ~1 us a call)."""

    def __init__(self):
        self.ms: dict[str, float] = {}
        self._inner: list[float] = []
        self._saved: list = []

    def wrap(self, owner, attr: str, group: str) -> None:
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))

        def timed_call(*args, **kwargs):
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = self._inner.pop()
                self.ms[group] = self.ms.get(group, 0.0) + (dt - inner) * 1e3
                if self._inner:
                    self._inner[-1] += dt
        setattr(owner, attr, timed_call)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def host_groups(dev, n_rounds: int = 9) -> dict:
    """The eager round's host time by group, unfused and fused: autograd
    (forward and backward, ``loss_and_grad``), the key chain
    (``prng.split``), planar staging (the wire layout's flatten, scales
    and block scales), wrapper checks (``native.require*`` and the
    wrappers' shape checks), the kernel wrappers' own time (allocation,
    ctypes call, launch), the metrics, and the rest of the round; ms a
    round, mean of ``n_rounds`` after one warm-up, each round ended by a
    synchronize."""
    import importlib

    from repro_torch import prng
    from repro_torch.core import (dfedavgm, init_round_state, local_sgd,
                                  mixing, wire_layout)
    from repro_torch.kernels import native, ops

    # The package exports functions of these modules' names.
    quantize_pack, dequant_mix = (importlib.import_module(
        f"repro_torch.kernels.{m}") for m in ("quantize_pack", "dequant_mix"))

    rep = {}
    for fuse_round in (False, True):
        data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
            dev, fuse_round)
        batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
                   for t in range(n_rounds + 1)]
        state = init_round_state(stacked, prng.PRNGKey(1))
        state, _ = step(state, batches[-1])
        torch.cuda.synchronize()
        timer = HostTimer()
        W = wire_layout.WireLayout
        for owner, attr, group in (
                (local_sgd, "loss_and_grad", "autograd"),
                (mixing, "loss_and_grad", "autograd"),
                (prng, "split", "key chain"),
                (W, "to_planar_stacked", "planar staging"),
                (W, "from_planar_stacked", "planar staging"),
                (W, "leaf_scales", "planar staging"),
                (W, "block_scales", "planar staging"),
                (native, "require", "wrapper checks"),
                (native, "require_aligned", "wrapper checks"),
                (quantize_pack, "_check_planar", "wrapper checks"),
                (dequant_mix, "_check_operands", "wrapper checks"),
                (wire_layout, "quantize_pack_buffer", "kernel wrappers"),
                (wire_layout, "dequant_mix_buffer", "kernel wrappers"),
                (wire_layout, "momentum_quantize_pack_buffer",
                 "kernel wrappers"),
                (wire_layout, "dequant_mix_momentum_buffer",
                 "kernel wrappers"),
                (ops, "momentum_sgd_leaves", "kernel wrappers"),
                (dfedavgm, "consensus_distance", "metrics")):
            timer.wrap(owner, attr, group)
        total = 0.0
        try:
            for b in batches[:n_rounds]:
                t0 = time.perf_counter()
                state, _ = step(state, b)
                torch.cuda.synchronize()
                total += (time.perf_counter() - t0) * 1e3
        finally:
            timer.restore()
        groups = {g: v / n_rounds for g, v in
                  sorted(timer.ms.items(), key=lambda kv: -kv[1])}
        groups["rest (mixing tensor ops, the loss mean, synchronize)"] = (
            total / n_rounds - sum(groups.values()))
        rep["fused" if fuse_round else "unfused"] = {
            "round_ms": total / n_rounds, "host_ms_by_group": groups}
    print(json.dumps({"eager_host_ms_by_group": rep}), flush=True)
    return rep


def eager_round_ms(dev, passes: int = 2) -> dict:
    """The eager quickstart round by the host clock to a synchronize
    (median of rounds 2..ROUNDS), unfused and fused in turns. Only
    public signatures, so a copy of this file imported in another tree
    times that tree's round (the key chain on the host before it moved
    to the card)."""
    from repro_torch import prng
    from repro_torch.core import init_round_state

    steps = {}
    for fuse_round in (False, True):
        data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
            dev, fuse_round)
        batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
                   for t in range(ROUNDS)]
        steps["fused" if fuse_round else "unfused"] = (
            step, init_round_state(stacked, prng.PRNGKey(1)), batches)
    ms = {name: [] for name in steps}
    for p in range(passes):
        for name in (list(steps) if p % 2 == 0 else list(steps)[::-1]):
            ms[name].append(median_round_ms(*steps[name]))
    return {"eager_round_ms": ms}


def bench_path(dev) -> list[dict]:
    """The port's benches at full size — Fig. 6, Figs 2-5, Fig. 8 (the
    CNN) and Fig. 7 (the CharLSTM) — every arm captured (each round one
    replay) and then eagerly, plus the Fig. 6 DFedAvgM arm on the ring
    realization with the 8-bit wire (B1, B2, B3 in its graph). Gates:
    each captured arm's first and last loss, last consensus distance and
    accuracy (where the bench has one) equal the eager arm's bitwise
    (both start from one seed and one data stream); finite losses that
    fall; each graph's kernel nodes (B3 a local step, T1 a split, T2 a
    leaf of a dense quantized mix), and the eager arm's launches the
    same nodes times its rounds; commMB from the port's ``comm_cost``
    equal to the paper's formula; a 2NN arm's accuracy above a floor set
    by its gradient steps: 0.5 from 100 steps, 0.3 at 50 (25 rounds of
    K = 2) and 0.15 at 25 (K = 1). In those 25 rounds the reference's
    own ``benchmarks/bench_quant_epochs.py`` reaches only 0.23-0.24 at
    K = 1 and 0.46-0.58 at K = 2 on the CPU, the port 0.19-0.20 and
    0.40-0.51 from its own init."""
    from repro_torch.bench import (charlm, cnn, common, fig6_compare,
                                   quant_epochs)
    from repro_torch.core import QuantConfig, dfedavgm_round_bits
    from repro_torch.kernels import launch_counts, reset_launch_counts

    d = 199_210
    m, k, rounds = fig6_compare.M, fig6_compare.K, fig6_compare.ROUNDS
    ring_edges = 2 * m

    def arms(capture: bool):
        yield from fig6_compare.arms(device=dev, capture=capture)
        yield from quant_epochs.arms(device=dev, capture=capture)
        r = common.train_dfedavgm_2nn(
            m=m, K=k, batch=fig6_compare.B, rounds=rounds, bits=8,
            mixer="ring", device=dev, capture=capture)
        bits = dfedavgm_round_bits(r["spec"].graph, r["d"],
                                   QuantConfig(bits=8)) * rounds
        yield "fig6/dfedavgm_ring_q8", dict(
            r, comm_bits=bits, derived=f"acc={r['acc']:.3f};"
            f"commMB={bits/8e6:.0f}")
        yield from cnn.arms(device=dev, capture=capture)
        yield from charlm.arms(device=dev, capture=capture)

    paper_mb = {   # the paper's §3.2 formulas, for the commMB gate
        "fig6/dfedavgm": 32 * d * ring_edges * rounds / 8e6,
        "fig6/fedavg": 2 * 32 * d * m * rounds / 8e6,
        "fig6/dsgd": 32 * d * ring_edges * rounds * k / 8e6,
        "fig6/dfedavgm_ring_q8": (32 + 8 * d) * ring_edges * rounds / 8e6}
    leaves = {"fig6": 6, "fig2345": 6, "fig8": 8, "fig7": 9}

    def arm_plan(name: str) -> tuple[dict, int, int]:
        """(kernel nodes a round, rounds, gradient steps) of an arm."""
        fig = name.split("/")[0]
        if name == "fig6/dsgd":
            kk, n_rounds = 0, rounds * k
        elif fig == "fig8":
            kk, n_rounds = int(name.rsplit("K", 1)[1]), cnn.ROUNDS
        elif fig == "fig7":
            kk, n_rounds = charlm.K, charlm.ROUNDS
        else:
            kk = int(name.rsplit("K", 1)[1]) if "/K" in name else k
            n_rounds = rounds if fig == "fig6" else quant_epochs.ROUNDS
        quantized = not (fig == "fig6" and name != "fig6/dfedavgm_ring_q8"
                         or name.endswith("bits32"))
        nodes = dict.fromkeys(KERNEL_SOURCES, 0)
        nodes["momentum_sgd"] = kk
        # DSGD splits the round key and the client keys; FedAvg and
        # DFedAvgM also the per-step keys; a quantized wire also the
        # per-leaf keys (T2 drawing each leaf's noise on the dense mixer).
        nodes["threefry_split"] = (2 if name == "fig6/dsgd" else
                                   SPLITS_A_ROUND - 1 + quantized)
        if name == "fig6/dfedavgm_ring_q8":
            nodes.update(quantize_pack_buffer=1, dequant_mix_buffer=1)
        elif quantized:
            nodes["threefry_uniform"] = leaves[fig]
        return nodes, n_rounds, max(kk, 1) * n_rounds

    def finals(r: dict) -> dict:
        return {f: r[f] for f in ("first_loss", "loss", "consensus_dist",
                                  "acc") if f in r}

    rows = []
    for name, r in arms(True):
        rows.append({"name": name, "us_per_round": r["us_per_round"],
                     "derived": r["derived"], **finals(r),
                     "capture_s": r["capture_s"],
                     "comm_bits": r.get("comm_bits"),
                     **check_round_graph(name, graph_nodes(r["graph"]),
                                         arm_plan(name)[0])})
        del r
    reset_launch_counts()
    for row, (name, r) in zip(rows, arms(False)):
        if row["name"] != name:
            raise AssertionError(f"eager arm {name} != {row['name']}")
        row["eager_launches"] = launch_counts()
        row["eager_us_per_round"] = r["us_per_round"]
        row["eager"] = finals(r)
        row["captured_equals_eager"] = finals(row) == row["eager"]
        reset_launch_counts()
    for row in rows:
        print(json.dumps({"bench_row": row}), flush=True)
    for row in rows:
        name = row["name"]
        nodes, n_rounds, steps = arm_plan(name)
        floor = 0.5 if steps >= 100 else 0.3 if steps >= 50 else 0.15
        if not row["captured_equals_eager"]:
            raise AssertionError(f"{name}: captured {finals(row)} != eager "
                                 f"{row['eager']}")
        expect = {kn: v * n_rounds for kn, v in nodes.items()}
        if row["eager_launches"] != expect:
            raise AssertionError(f"{name}: eager launches "
                                 f"{row['eager_launches']} != {expect}")
        if not (math.isfinite(row["first_loss"])
                and math.isfinite(row["loss"])):
            raise AssertionError(f"{name}: non-finite loss {row}")
        if not row["loss"] < row["first_loss"]:
            raise AssertionError(f"{name}: loss did not fall {row}")
        if name.startswith(("fig6", "fig2345")) and not row["acc"] > floor:
            raise AssertionError(f"{name}: accuracy {row['acc']} <= {floor}")
        if name in paper_mb:
            mb = dict(f.split("=") for f in row["derived"].split(";"))
            if (row["comm_bits"] / 8e6 != paper_mb[name]
                    or mb["commMB"] != f"{paper_mb[name]:.0f}"):
                raise AssertionError(f"{name}: commMB {mb['commMB']} != "
                                     f"{paper_mb[name]}")
    return rows


def schedule_of(kind: str):
    """The "schedules" phase's TopologySchedule ``kind`` at m = M: the
    bench_timevarying schedules and the README's options (exact cohorts,
    a capped i.i.d. draw, a stateful walk, a ring/torus cycle)."""
    from repro_torch.core import (MixingSpec, TopologySchedule,
                                  erdos_renyi_graph, ring_graph)
    ring = ring_graph(M)
    return {
        "constant": lambda: TopologySchedule.constant(
            MixingSpec.ring(M, self_weight=0.5)),
        "edge_sample": lambda: TopologySchedule.edge_sample(
            erdos_renyi_graph(M, 0.4, seed=0), 0.5),
        "partial": lambda: TopologySchedule.partial(ring, 0.6),
        "partial_exact": lambda: TopologySchedule.partial(ring, 0.6,
                                                          exact=True),
        "partial_cap": lambda: TopologySchedule.partial(ring, 0.6,
                                                        cap_slack=2),
        "walk": lambda: TopologySchedule.random_walk(ring, horizon=64,
                                                     seed=0),
        "walk_stateful": lambda: TopologySchedule.random_walk(
            ring, stateful=True),
        "cycle": lambda: TopologySchedule.cycle(
            [MixingSpec.ring(M), MixingSpec.torus(4, 4)]),
    }[kind]()


def permutation_rounds(n: int) -> int:
    """Sort rounds of ``prng.permutation(key, n)`` (jax's ``_shuffle``):
    one T1 and one T3 launch each."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def round_launches(spec, quantized: bool = True, fuse_round: bool = False,
                   k: int = K) -> dict:
    """Kernel launches of one plan-realization round on ``spec`` (a
    MixingSpec or a TopologySchedule), derived from what the round does:
    the encode and decode (B1 and B2, or fused B4 and B5) on a quantized
    wire; B3 once an applied local step; T1 once a split
    (SPLITS_A_ROUND, less the per-leaf quantizer split of an fp32 wire);
    and the event's draws: a stochastic schedule splits its mixing key
    (T1), edge sampling and i.i.d. participation draw uniforms (T2, one
    launch), the stateful walk's ``choice`` one uniform (T2), an exact
    cohort one ``permutation`` (T1 + T3 a sort round), a cap clamp
    ``fold_in`` (T1) and one ``permutation``."""
    per = dict.fromkeys(KERNEL_SOURCES, 0)
    if quantized and fuse_round:
        per.update(momentum_quantize_pack_buffer=1,
                   dequant_mix_momentum_buffer=1, momentum_sgd=k - 2)
    elif quantized:
        per.update(quantize_pack_buffer=1, dequant_mix_buffer=1,
                   momentum_sgd=k)
    else:
        per["momentum_sgd"] = k
    per["threefry_split"] = SPLITS_A_ROUND - (not quantized)
    if not getattr(spec, "is_stochastic", False):   # static, or no draw
        return per
    per["threefry_split"] += 1
    rounds = permutation_rounds(spec.m)
    if spec.kind == "edge_sample" or spec.is_stateful:
        per["threefry_uniform"] += 1
    elif spec.n_active is not None:
        per["threefry_split"] += rounds
        per["threefry_bits"] += rounds
    else:
        per["threefry_uniform"] += 1
        if spec.n_cap is not None and spec.n_cap < spec.m:
            per["threefry_split"] += 1 + rounds
            per["threefry_bits"] += rounds
    return per


def schedule_rounds(dev, kind: str, fuse_round: bool, setup) -> dict:
    """The quickstart on ``schedule_of(kind)`` (plan realization, 8-bit
    stochastic lemma5): ROUNDS eager rounds with every launch counter
    read (against :func:`round_launches`), their ``active_frac`` against
    the schedule's own event from each round's key, CPU_ROUNDS of them
    against the same rounds on the CPU (the trajectory contract of
    ``round_vs_cpu``), then ROUNDS captured rounds bitwise with ROUNDS
    eager ones (:func:`captured_vs_eager`: one round's kernel nodes, no
    host copy, no int64 threefry node). Losses finite, the last below
    the first."""
    from repro_torch import prng
    from repro_torch.core import (DFedAvgMConfig, QuantConfig,
                                  init_round_state, make_round_step)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    stacked, batches, loss_fn = setup
    sched = schedule_of(kind)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8), fuse_round=fuse_round)
    name = f"schedule {'fused ' if fuse_round else ''}{kind}"

    def make_step(device=dev):
        return make_round_step(loss_fn, cfg, sched, device=device)

    def start(device):
        return init_round_state(
            {n: t.to(device) for n, t in stacked.items()}, prng.PRNGKey(1),
            token=sched.init_token() if sched.is_stateful else None)

    per = round_launches(sched, fuse_round=fuse_round)
    expect = {k: v * ROUNDS for k, v in per.items()}
    step = make_step()
    state = s0 = start(dev)
    keys, mets = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for b in batches:
        keys.append((state.rng, state.token))
        state, met = step(state, b)
        mets.append(met)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(m_["loss"]) for m_ in mets]
    frac = [float(m_["active_frac"]) for m_ in mets]
    own = []
    for t, (rng, token) in enumerate(keys):   # the schedule's own events
        key_mix = prng.split(rng, 3)[1]
        active = (sched.token_event(key_mix, token)[1] if sched.is_stateful
                  else sched.round_event(key_mix, t)[1])
        own.append(float(active.mean()))

    step_cpu = make_step("cpu")
    sc, cpu = start("cpu"), []
    for t in range(CPU_ROUNDS):
        sc, mc = step_cpu(sc, {n: x.cpu() for n, x in batches[t].items()})
        cpu.append({k: float(v) for k, v in mc.items()})
    cpu_rel = [{k: abs(float(mets[t][k]) / v - 1) if v else
                abs(float(mets[t][k])) for k, v in cpu[t].items()}
               for t in range(CPU_ROUNDS)]

    rep = captured_vs_eager(name, step, make_step, s0, batches, per)
    summary = {"path": name, "schedule": sched.name, "rounds": ROUNDS,
               "loss": losses, "active_frac": frac,
               "schedule_active_frac": own, "launches": counts,
               "expected_launches": expect, "vs_cpu_rel": cpu_rel,
               "round_ms_median": rep["round_ms_median"],
               "replay_device_ms": rep["replay_device_ms"],
               "graph_nodes": rep["graph_nodes"],
               "kernel_nodes": rep["kernel_nodes"],
               "bitwise": rep["bitwise"]}
    print(json.dumps(summary), flush=True)
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    if frac != own:
        raise AssertionError(f"{name}: active_frac {frac} != the "
                             f"schedule's {own}")
    for t, rel in enumerate(cpu_rel):
        if rel["loss"] > 1e-5 or rel["consensus_dist"] > 1e-3 or \
                rel["active_frac"] != 0:
            raise AssertionError(f"{name}: round {t} on the card leaves the "
                                 f"CPU's trajectory: {rel}")
    if not rep["bitwise"]:
        raise AssertionError(f"{name}: captured rounds differ from eager")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}")
    return summary


def schedule_kernel_checks(dev, flush, rec) -> None:
    """B2 with a round's weights gathered on the card from a sampled W_t
    (masked edges at weight 0 in the table): the torus support's K = 5
    and the ER support's K = 11 (``edge_sample`` on each), at 2, 4, 8
    and 16 bits, bitwise against its plain version; timed at K = 11 (8
    bits) against its byte bound. Recorded under ``rec["dequant_mix_
    buffer"]["k11"]``."""
    from repro_torch import prng
    from repro_torch.core import (QuantConfig, TopologySchedule,
                                  WireLayout, torus_graph)
    from repro_torch.core.mixing import _PlanTables, _quant_leaf_keys
    from repro_torch.kernels.dequant_mix import (dequant_mix_buffer,
                                                 dequant_mix_buffer_plain)
    from repro_torch.kernels.quantize_pack import quantize_pack_buffer
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(11)
    x = {n: (torch.randn((M,) + tuple(t.shape), generator=gen) * 0.05)
         .to(dev) for n, t in init_2nn(0, device="cpu").items()}
    z = {n: t + 0.01 * torch.randn(t.shape, generator=gen).to(dev)
         for n, t in x.items()}
    r = rec["dequant_mix_buffer"]
    for sched in (TopologySchedule.edge_sample(torus_graph(4, 4), 0.5),
                  schedule_of("edge_sample")):
        tables = _PlanTables(sched.gossip_plan(), dev)
        W, _, key_q = sched.round_event(prng.PRNGKey(7, device=dev), 0)
        w, src = tables.weights(W), tables.src
        k = src.shape[0]
        zeros = int((w == 0).sum())
        for bits in (2, 4, 8, 16):
            quant = QuantConfig(bits=bits)
            layout = WireLayout.for_tree(x, bits, stacked=True)
            X = layout.to_planar_stacked(x)
            delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
            sblk = layout.block_scales(layout.leaf_scales(delta, quant))
            words = quantize_pack_buffer(
                delta, sblk, bits, keys=_quant_leaf_keys(
                    key_q, layout.n_leaves, M), table=layout.noise_table)
            out = dequant_mix_buffer(X, words, sblk, w, src, bits)
            want = dequant_mix_buffer_plain(X, words, sblk, w, src, bits)
            torch.cuda.synchronize()
            what = f"B2 K={k} gathered from W_t bits={bits}"
            check_words(what, out.view(torch.int32), want.view(torch.int32))
            check_floats(r, what, [(out, want)])
            r["checks"].append(f"K={k} weights gathered from a sampled W_t "
                               f"({zeros} zeros) bits={bits} bitwise")
            if k == 11 and bits == 8:
                t = {"shape": list(X.shape), "K": k, "weight_zeros": zeros}
                timed(t, "", lambda: dequant_mix_buffer(
                    X, words, sblk, w, src, bits), flush)
                timed(t, "plain_", lambda: dequant_mix_buffer_plain(
                    X, words, sblk, w, src, bits), flush)
                t["bound_ms"], t["bound_by"] = bound(
                    nbytes(X, words, sblk, w, src, out), X.numel() * 3 * k)
                r["k11"] = t
    print(json.dumps({"check": "dequant_mix_buffer gathered",
                      "k11": r["k11"]}), flush=True)


def schedules_phase(dev) -> dict:
    """Phase "schedules": every TopologySchedule kind (SCHEDULE_KINDS)
    through the unfused quickstart round and FUSED_SCHEDULE_KINDS through
    the fused one (:func:`schedule_rounds`). Returns the summaries and
    the launches of all of their eager counted rounds together."""
    data, fed, stacked, _, _, loss_fn, _ = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    setup = (stacked, batches, loss_fn)
    out = {}
    for kind in SCHEDULE_KINDS:
        out[kind] = schedule_rounds(dev, kind, False, setup)
    for kind in FUSED_SCHEDULE_KINDS:
        out[f"fused {kind}"] = schedule_rounds(dev, kind, True, setup)
    launches = {k: sum(r["launches"][k] for r in out.values())
                for k in KERNEL_SOURCES}
    return out, launches


def schedule_bench_path(dev) -> list[dict]:
    """``bench.topology`` (lambda rows; ring16 against torus4x4 non-IID
    accuracy after 30 rounds) and ``bench.timevarying`` (its five
    schedules, 30 rounds each) at full size, every arm captured and then
    eagerly: finals (first and last loss, consensus, accuracy) equal
    bitwise, each graph's kernel nodes those of one fp32 round
    (:func:`round_launches`), the eager arm's launches those times its
    rounds, finite losses."""
    from repro_torch.bench import timevarying, topology
    from repro_torch.kernels import launch_counts, reset_launch_counts

    print(json.dumps({"topology_lambda_rows": topology.lambda_rows()}),
          flush=True)

    def arms(capture: bool):
        yield from topology.arms(device=dev, capture=capture)
        yield from timevarying.arms(device=dev, capture=capture)

    def finals(r: dict) -> dict:
        return {f: r[f] for f in ("first_loss", "loss", "consensus_dist",
                                  "acc")}

    rows = []
    for name, r in arms(True):
        nodes = round_launches(r["spec"], quantized=False,
                               k=topology.K if name.startswith("topology")
                               else timevarying.K)
        rows.append({"name": name, "us_per_round": r["us_per_round"],
                     "derived": r["derived"], **finals(r),
                     "capture_s": r["capture_s"], "expected_nodes": nodes,
                     **check_round_graph(name, graph_nodes(r["graph"]),
                                         nodes)})
        del r
    reset_launch_counts()
    for row, (name, r) in zip(rows, arms(False)):
        row["eager_launches"] = launch_counts()
        row["eager_us_per_round"] = r["us_per_round"]
        row["eager"] = finals(r)
        row["captured_equals_eager"] = finals(row) == row["eager"]
        reset_launch_counts()
    for row in rows:
        row.pop("expected_nodes")
        print(json.dumps({"bench_row": row}), flush=True)
    for row in rows:
        name = row["name"]
        rounds = (topology.ROUNDS if name.startswith("topology")
                  else timevarying.ROUNDS)
        expect = {k: v * rounds for k, v in row["kernel_nodes"].items()}
        if not row["captured_equals_eager"]:
            raise AssertionError(f"{name}: captured {finals(row)} != eager "
                                 f"{row['eager']}")
        if row["eager_launches"] != expect:
            raise AssertionError(f"{name}: eager launches "
                                 f"{row['eager_launches']} != {expect}")
        if not (math.isfinite(row["first_loss"])
                and math.isfinite(row["loss"])):
            raise AssertionError(f"{name}: non-finite loss {row}")
    return rows

def async_arm(kind: str):
    """(spec, AsyncConfig) of the "async" phase's arm ``kind``: the
    quickstart's ring under ASYNC_SPEED (``max_staleness`` 8, the inverse
    discount); "decay" adds ``eta_staleness_decay`` 0.5 (B3's lane
    entry), "capacity" ``ready_capacity`` 1 (one gathered lane an
    event), "edge_sample" samples the ring's edges at p 0.7 (W_eff from a
    sampled W_t, the schedule's mask composed with the ready mask)."""
    from repro_torch.core import (AsyncConfig, MixingSpec, SpeedModel,
                                  TopologySchedule, ring_graph)
    spec = (TopologySchedule.edge_sample(ring_graph(M), 0.7)
            if kind == "edge_sample" else MixingSpec.ring(M, self_weight=0.5))
    return spec, AsyncConfig(
        speed=SpeedModel.straggler(**ASYNC_SPEED), max_staleness=8,
        discount="inverse",
        eta_staleness_decay=0.5 if kind == "decay" else 0.0,
        ready_capacity=1 if kind == "capacity" else None)


def event_launches(spec, acfg, quantized: bool = True, k: int = K) -> dict:
    """Kernel launches of one async event, derived from what it does: a
    synchronous round's (:func:`round_launches`: the encode and decode,
    B3 a local step, T1 a split, the schedule's draws), one more T1 for
    the clock key's split, T4 once for the durations unless the speed is
    constant, and B3's lane entry in place of B3 under the eta decay."""
    per = round_launches(spec, quantized=quantized, k=k)
    per["threefry_split"] += 1
    per["threefry_normal"] += not acfg.speed.is_constant
    if acfg.eta_staleness_decay > 0.0:
        per["momentum_sgd_lanes"] = per.pop("momentum_sgd")
        per["momentum_sgd"] = 0
    return per


def async_rounds(dev, kind: str, setup) -> dict:
    """The async arm ``kind`` (:func:`async_arm`, 8-bit stochastic lemma5
    on the plan realization) from one state: ROUNDS eager events through
    ``make_round_step(..., async_cfg=...)`` with every launch counter
    read (against :func:`event_launches`), CPU_ROUNDS of them against the
    same events on the CPU (the same clients fire, the versions agree;
    clock within rtol 1e-6, loss 1e-5, consensus 1e-3), ROUNDS captured
    events bitwise with ROUNDS eager ones (:func:`captured_vs_eager`:
    one event's kernel nodes, no host copy, no int64 threefry node), and
    the captured engine (``make_async_engine(capture=True)``, one replay
    an event) over the ROUNDS events bitwise with the eager loop."""
    from repro_torch import prng
    from repro_torch.core import (DFedAvgMConfig, QuantConfig,
                                  init_async_state, make_async_engine,
                                  make_round_step)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    stacked, batches, loss_fn = setup
    spec, acfg = async_arm(kind)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8))
    name = f"async {kind}"

    def make_step(device=dev):
        return make_round_step(loss_fn, cfg, spec, device=device,
                               async_cfg=acfg)

    def start(device):
        return init_async_state({n: t.to(device) for n, t in stacked.items()},
                                prng.PRNGKey(1), acfg.speed)

    per = event_launches(spec, acfg)
    expect = {k: v * ROUNDS for k, v in per.items()}
    step = make_step()
    state = s0 = start(dev)
    mets, versions = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for b in batches:
        state, met = step(state, b)
        mets.append(met)
        versions.append(state.version)
    torch.cuda.synchronize()
    counts = launch_counts()
    eager = {k: [float(m_[k]) for m_ in mets] for k in mets[0]}

    step_cpu = make_step("cpu")
    sc, cpu_rel = start("cpu"), []
    for t in range(CPU_ROUNDS):
        sc, mc = step_cpu(sc, {n: x.cpu() for n, x in batches[t].items()})
        if not torch.equal(sc.version, versions[t].cpu()):
            raise AssertionError(f"{name}: event {t} fires other clients "
                                 f"on the CPU: {sc.version.tolist()} != "
                                 f"{versions[t].tolist()}")
        cpu_rel.append({k: abs(eager[k][t] / float(v) - 1) if float(v)
                        else abs(eager[k][t]) for k, v in mc.items()})

    rep = captured_vs_eager(name, step, make_step, s0, batches, per)
    engine = make_async_engine(loss_fn, cfg, spec, acfg, device=dev,
                               capture=True)
    e_state, e_mets = engine(s0, {n: torch.stack([b[n] for b in batches])
                                  for n in batches[0]})
    engine_bitwise = (
        all(torch.equal(e_state.params[n], state.params[n])
            for n in state.params)
        and all(torch.equal(getattr(e_state, f), getattr(state, f))
                for f in s0._fields if f != "params")
        and all(torch.equal(e_mets[k], torch.stack([m_[k] for m_ in mets]))
                for k in e_mets))
    summary = {"path": name, "spec": getattr(spec, "name", spec.kind),
               "events": ROUNDS, "eager": eager,
               "versions": versions[-1].tolist(), "launches": counts,
               "expected_launches": expect, "vs_cpu_rel": cpu_rel,
               "event_ms_median": rep["round_ms_median"],
               "replay_device_ms": rep["replay_device_ms"],
               "engine_replay_device_ms": replay_ms(engine.graph),
               "graph_nodes": rep["graph_nodes"],
               "kernel_nodes": rep["kernel_nodes"],
               "bitwise": rep["bitwise"], "engine_bitwise": engine_bitwise,
               "state": state}
    print(json.dumps({k: v for k, v in summary.items() if k != "state"}),
          flush=True)
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    for t, rel in enumerate(cpu_rel):
        if rel["clock"] > 1e-6 or rel["loss"] > 1e-5 or \
                rel["consensus_dist"] > 1e-3 or rel["ready_frac"] != 0:
            raise AssertionError(f"{name}: event {t} on the card leaves the "
                                 f"CPU's trajectory: {rel}")
    if not rep["bitwise"] or not engine_bitwise:
        raise AssertionError(f"{name}: captured events differ from eager "
                             f"(step {rep['bitwise']}, engine "
                             f"{engine_bitwise})")
    if not all(math.isfinite(v) for v in eager["loss"]
               + eager["consensus_dist"]) or max(eager["ready_frac"]) <= 0:
        raise AssertionError(f"{name}: {eager}")
    return summary


def async_kernel_checks(dev, flush, rec) -> None:
    """T4 (``kernels.threefry.normal``) bitwise against
    ``prng.normal_plain`` run on the card, at the event clock's [16] (one
    key, and 16 keys) and at 1 048 576 draws; timed at [16] (the path's
    shape) and at 1 048 576 against the plain version and its ALU bound
    from the compiled code (``threefry_ops``). B3's lane entry
    (``momentum_update`` with an eta [M]) bitwise against
    ``momentum_sgd_lanes_ref`` over the quickstart's six leaves for 16
    clients (3 187 360 values) and on a misaligned view, timed against
    the plain version and its byte bound (B3's bytes and the eta)."""
    from repro_torch import prng
    from repro_torch.kernels import momentum_update, threefry
    from repro_torch.kernels.momentum_sgd import (momentum_sgd_leaves,
                                                  momentum_sgd_lanes_ref)
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(13)

    def keys(rows):
        return torch.randint(0, 2 ** 32, (rows, 2), generator=gen,
                             dtype=torch.int64).to(dev)

    r = rec["threefry_normal"]
    for rows, n in ((1, M), (M, M), (1, 2 ** 20), (3, 4099)):
        k = keys(rows)
        check_words(f"T4 R={rows} n={n}",
                    threefry.normal(k, (n,)).view(torch.int32),
                    prng.normal_plain(k, (n,)).view(torch.int32))
        r["checks"].append(f"R={rows} n={n} bitwise")
    key = keys(1)[0]
    timed(r, "", lambda: threefry.normal(key, (M,)), flush)
    timed(r, "plain_", lambda: prng.normal_plain(key, (M,)), flush)
    out = threefry.normal(key, (M,))
    r["sass"] = threefry_ops("threefry_normal", M)
    r["bound_ms"], r["bound_by"] = bound(nbytes(key, out), 0,
                                         r["sass"]["ms"])
    r["shape"] = [1, M]
    big = {"shape": [1, 2 ** 20]}
    timed(big, "", lambda: threefry.normal(key, (2 ** 20,)), flush)
    timed(big, "plain_", lambda: prng.normal_plain(key, (2 ** 20,)), flush)
    ops = threefry_ops("threefry_normal", 2 ** 20)
    big["bound_ms"], big["bound_by"] = bound(
        nbytes(key, threefry.normal(key, (2 ** 20,))), 0, ops["ms"])
    big["sass"] = ops
    r["n1m"] = big

    r = rec["momentum_sgd_lanes"]
    shapes = {n: (M,) + tuple(t.shape)
              for n, t in init_2nn(0, device="cpu").items()}
    y, v, g = ({n: (torch.randn(sh, generator=gen) * sc).to(dev)
                for n, sh in shapes.items()} for sc in (0.05, 0.01, 0.1))
    eta = (ETA / (1.0 + 0.5 * torch.randint(0, 4, (M,), generator=gen)
                  .to(torch.float32))).to(dev)
    ys, vs = momentum_update(y, v, g, eta, THETA)
    pairs = []
    for n in y:
        wy, wv = momentum_sgd_lanes_ref(y[n], v[n], g[n], eta, THETA)
        pairs += [(ys[n], wy), (vs[n], wv)]
    per = 1031
    spare = torch.empty(M * per + 1, device=dev)
    y_mis = spare[1:].copy_(torch.randn(M * per, device=dev)).view(M, per)
    v_mis, g_mis = (torch.randn(M, per, device=dev) for _ in range(2))
    (my,), (mv,) = momentum_sgd_leaves([y_mis], [v_mis], [g_mis], eta, THETA)
    pairs += list(zip((my, mv), momentum_sgd_lanes_ref(y_mis, v_mis, g_mis,
                                                       eta, THETA)))
    torch.cuda.synchronize()
    for a, b in pairs:
        check_words("B3 lanes vs plain", a.view(torch.int32),
                    b.view(torch.int32))
    check_floats(r, "B3 lanes", pairs)
    n_el = sum(t.numel() for t in y.values())
    r["checks"].append(f"6 leaves x {M} clients = {n_el} values, an eta a "
                       f"client, in one launch, and a misaligned [{M}, "
                       f"{per}] view: bitwise")
    timed(r, "", lambda: momentum_update(y, v, g, eta, THETA), flush)
    timed(r, "plain_", lambda: [momentum_sgd_lanes_ref(
        y[n], v[n], g[n], eta, THETA) for n in y], flush)
    r["bound_ms"], r["bound_by"] = bound(5 * 4 * n_el + nbytes(eta),
                                         3 * n_el)
    r["shape"] = f"one local step: 6 leaves x {M} clients ({n_el} f32)"
    for name in ("threefry_normal", "momentum_sgd_lanes"):
        print(json.dumps({"check": name, **rec[name]}), flush=True)


def async_constant_vs_sync(dev, setup) -> dict:
    """A constant speed model fires every client every event: ROUNDS
    async events (``make_round_step(..., async_cfg=...)``, eta decay off
    and on: zero lag scales eta by exactly 1, B3's lane entry then
    carries the scalar's eta) bitwise with ROUNDS synchronous quickstart
    rounds on the card — parameters, key and loss."""
    from repro_torch import prng
    from repro_torch.core import (AsyncConfig, DFedAvgMConfig, MixingSpec,
                                  QuantConfig, SpeedModel, init_async_state,
                                  init_round_state, make_round_step)

    stacked, batches, loss_fn = setup
    spec = MixingSpec.ring(M, self_weight=0.5)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8))
    sync_step = make_round_step(loss_fn, cfg, spec, device=dev)
    s = init_round_state(stacked, prng.PRNGKey(1))
    sync_loss = []
    for b in batches:
        s, met = sync_step(s, b)
        sync_loss.append(met["loss"])
    out = {}
    for decay in (0.0, 0.5):
        acfg = AsyncConfig(speed=SpeedModel.constant(),
                           eta_staleness_decay=decay)
        step = make_round_step(loss_fn, cfg, spec, device=dev,
                               async_cfg=acfg)
        a = init_async_state(stacked, prng.PRNGKey(1), acfg.speed)
        same_loss = True
        for b, want in zip(batches, sync_loss):
            a, met = step(a, b)
            same_loss &= torch.equal(met["loss"], want)
        bitwise = (same_loss and torch.equal(a.rng, s.rng)
                   and all(torch.equal(a.params[n], s.params[n])
                           for n in s.params))
        out[f"decay={decay}"] = {
            "bitwise": bitwise, "max_ulp": max(
                ulp_diff(a.params[n], s.params[n]) for n in s.params),
            "versions": a.version.tolist()}
    print(json.dumps({"check": "async constant speed vs sync", **out}),
          flush=True)
    for k, r in out.items():
        if not r["bitwise"]:
            raise AssertionError(f"async constant speed ({k}) differs from "
                                 f"the synchronous round: {r}")
    return out


def async_bench_path(dev) -> dict:
    """``bench.async_compare`` at full size (m 8, K 2, batch 32, 40
    rounds of 8 events, edge-sampled ring8 at p 0.7, dense fp32),
    captured and then eagerly: both curves, the times to target and the
    final async state equal bitwise; the event graph holds one event's
    kernel nodes (:func:`event_launches`: B3 = K, T1, T2 for the edge
    draw, T4) and the sync round's graph one round's
    (:func:`round_launches`)."""
    from repro_torch.bench import async_compare
    from repro_torch.core import (AsyncConfig, SpeedModel, TopologySchedule,
                                  ring_graph)

    m, k = async_compare.M, async_compare.K
    sched = TopologySchedule.edge_sample(ring_graph(m), 0.7)
    acfg = AsyncConfig(speed=SpeedModel.straggler(
        mean=1.0, sigma=0.5, frac=1.0 / m, factor=10.0))
    res = {}
    for mode, capture in (("captured", True), ("eager", False)):
        t0 = time.perf_counter()
        res[mode] = async_compare.run_compare(device=dev, capture=capture)
        res[mode]["wall_s"] = time.perf_counter() - t0
    cap, eag = res["captured"], res["eager"]
    keys = ("sync_curve", "async_curve", "sync_time_to_target",
            "async_time_to_target", "target_loss")
    equal = all(cap[f] == eag[f] for f in keys) and all(
        torch.equal(cap["async_final_state"].params[n],
                    eag["async_final_state"].params[n])
        for n in cap["async_final_state"].params)
    rep = {"path": "bench async_compare", "captured_equals_eager": equal,
           **{f"{mode}_{f}": r[f] for mode, r in res.items()
              for f in ("us_per_event", "wall_s")},
           **{f: cap[f] for f in ("target_loss", "sync_time_to_target",
                                  "async_time_to_target",
                                  "speedup_virtual_wallclock",
                                  "async_beats_sync", "sync_final",
                                  "async_final", "device")}}
    rep["async_graph"] = check_round_graph(
        "bench async_compare event", graph_nodes(cap["async_graph"]),
        event_launches(sched, acfg, quantized=False, k=k))
    rep["sync_graph"] = check_round_graph(
        "bench async_compare sync round", graph_nodes(cap["sync_graph"]),
        round_launches(sched, quantized=False, k=k))
    print(json.dumps(rep), flush=True)
    if not equal:
        raise AssertionError("bench async_compare: captured differs from "
                             "eager")
    for r in (cap, eag):
        if not all(math.isfinite(v) for _, v in r["sync_curve"]
                   + r["async_curve"]):
            raise AssertionError("bench async_compare: non-finite loss")
    return rep


def capacity_probe(dev) -> dict:
    """Where one gathered lane's local training parts from the same lane
    trained at full width (``ready_capacity=1`` against all M lanes): the
    quickstart's K heavy-ball steps on the first round's batches at width
    M and at width 1 (lane 3 alone) through ``loss_and_grad`` (which runs
    a lone lane as two), each step's gradient and parameters compared
    leaf by leaf (flatten order); the first (step, leaf) where they part,
    or None, and each one's largest ulp."""
    from repro_torch import prng
    from repro_torch.core.local_sgd import heavy_ball_update, loss_and_grad

    _, fed, stacked, _, _, loss_fn, _ = quickstart_setup(dev)
    b = fed.round_batches(0, K=K, batch=BATCH, device=dev)
    keys = prng.split(prng.PRNGKey(1, device=dev), M)
    one = slice(3, 4)

    def trajectory(sl):
        y = {n: t[sl].contiguous() for n, t in stacked.items()}
        v = {n: torch.zeros_like(t) for n, t in y.items()}
        step_keys = prng.split(keys[sl].contiguous(), K)
        out = []
        for k in range(K):
            _, g = loss_and_grad(loss_fn, y, {n: t[sl, k] for n, t in
                                              b.items()}, step_keys[:, k])
            y, v = heavy_ball_update(y, v, g, ETA, THETA)
            out.append((g, y))
        return out

    full, single = trajectory(slice(None)), trajectory(one)
    first, worst = None, {}
    for k, ((gf, yf), (g1, y1)) in enumerate(zip(full, single)):
        for n in sorted(gf):
            for what, a, c in (("grad", gf[n][one], g1[n]),
                               ("params", yf[n][one], y1[n])):
                u = ulp_diff(a, c)
                worst[f"{what} {n}"] = max(worst.get(f"{what} {n}", 0), u)
                if u and first is None:
                    first = {"step": k, "leaf": n, "what": what, "ulp": u}
    return {"lane": 3, "first_difference": first, "max_ulp": worst}


def async_capacity_vs_full(dev, arms: dict) -> dict:
    """One gathered lane an event (the "capacity" arm) against the
    full-width "straggler" arm after ROUNDS events, and
    :func:`capacity_probe`: bitwise (``loss_and_grad`` runs a lone lane
    as two, so cuBLAS never sees a batch of one)."""
    full, one = arms["straggler"]["state"], arms["capacity"]["state"]
    rep = {"max_ulp": max(ulp_diff(full.params[n], one.params[n])
                          for n in full.params),
           "versions_equal": torch.equal(full.version, one.version),
           "probe": capacity_probe(dev)}
    print(json.dumps({"check": "async capacity 1 vs full width", **rep}),
          flush=True)
    if rep["max_ulp"] or not rep["versions_equal"] or rep["probe"][
            "first_difference"]:
        raise AssertionError(f"async capacity: ready_capacity=1 is not "
                             f"bitwise with full width: {rep}")
    return rep


def async_phase(dev, flush, rec) -> tuple[dict, dict]:
    """Phase "async": T4 and B3's lane entry against their plain versions
    (:func:`async_kernel_checks`), the four ASYNC_ARMS at full width
    (:func:`async_rounds`), constant speed against the synchronous round
    (:func:`async_constant_vs_sync`) and ``bench.async_compare`` at full
    size (:func:`async_bench_path`). Returns the summaries and the
    launches of the arms' eager counted events together."""
    async_kernel_checks(dev, flush, rec)
    data, fed, stacked, _, _, loss_fn, _ = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    setup = (stacked, batches, loss_fn)
    out = {kind: async_rounds(dev, kind, setup) for kind in ASYNC_ARMS}
    out["capacity_vs_full"] = async_capacity_vs_full(dev, out)
    out["constant_vs_sync"] = async_constant_vs_sync(dev, setup)
    out["bench"] = async_bench_path(dev)
    launches = {k: sum(out[a]["launches"][k] for a in ASYNC_ARMS)
                for k in KERNEL_SOURCES}
    return out, launches


def pool_setup(dev):
    """The pool arms' problem: the 2NN template (``init_2nn(0)``), the
    MNIST-like set (POOL_DATA_N vectors of 784) held on the device, the
    loss, the quickstart's config (K 4, batch 32, eta 0.05, theta 0.9,
    8-bit stochastic lemma5) and ``batch_fn(ids, c)``: client i's K x
    BATCH rows drawn by ``prng.randint`` from ``fold_in(fold_in(key, i),
    c)``, ``c`` the round (a host int) or each lane's version (a tensor)."""
    from repro_torch import prng
    from repro_torch.core import DFedAvgMConfig, QuantConfig
    from repro_torch.data import classification_dataset
    from repro_torch.models.paper_nets import (apply_2nn, init_2nn,
                                               softmax_xent)

    data = classification_dataset(n=POOL_DATA_N, d=784, seed=0)
    xs = torch.from_numpy(data.x).to(dev)
    ys = torch.from_numpy(data.y).to(dev)
    key = prng.PRNGKey(0, device=dev)

    def batch_fn(ids, c):
        keys = prng.fold_in(key, ids)
        keys = prng.fold_in(keys, c.to(torch.int64) if isinstance(
            c, torch.Tensor) else c)
        rows = prng.randint(keys, (K, BATCH), 0, xs.shape[0]).long()
        return {"x": xs[rows], "y": ys[rows]}

    def loss_fn(p, b, rng):
        return softmax_xent(apply_2nn(p, b["x"]), b["y"])

    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8))
    return init_2nn(0, device="cpu"), loss_fn, cfg, batch_fn


def pool_step_launches(quantized: bool = True, backend: str = "sparse",
                       n_leaves: int = 6) -> dict:
    """Kernel launches of one pooled step (the part a CUDA graph
    captures): B3 a local step and T1 once (the client keys' step keys);
    on a quantized wire B1 and B2 at cohort width (the plan realization),
    or T2 a leaf (the dense mix's noise)."""
    per = dict.fromkeys(KERNEL_SOURCES, 0)
    per.update(momentum_sgd=K, threefry_split=1)
    if quantized and backend == "sparse":
        per.update(quantize_pack_buffer=1, dequant_mix_buffer=1)
    elif quantized:
        per["threefry_uniform"] = n_leaves
    return per


def pool_prepare_launches(psched, quantized: bool = True) -> dict:
    """Kernel launches of preparing one pooled round: ``inputs`` (T1 for
    ``split(rng, 3)`` and ``split(key_round, m)``, the schedule's
    mixing-key split when it draws, the per-leaf quantizer keys at full
    width on a stochastic wire; an exact cohort's ``permutation``, T1 +
    T3 a sort round) and :func:`pool_setup`'s batches (T1 for each
    fold_in and randint's split, T3 for randint's two 32-bit draws)."""
    per = dict.fromkeys(KERNEL_SOURCES, 0)
    per["threefry_split"] = 2 + psched.is_stochastic + quantized + 3
    per["threefry_bits"] = 2
    if psched.kind == "partial":
        rounds = permutation_rounds(psched.m)
        per["threefry_split"] += rounds
        per["threefry_bits"] += rounds
    return per


def pools_equal(a, b) -> bool:
    """Two ClientPools hold the same clients in the same slots, with the
    same versions and the same bits in every materialized row."""
    n = a.materialized
    return (n == b.materialized and np.array_equal(a.versions, b.versions)
            and np.array_equal(a._slot, b._slot)
            and all(np.array_equal(x[:n + 1].view(np.uint8),
                                   y[:n + 1].view(np.uint8))
                    for x, y in zip(a._slabs, b._slabs)))


def pool_run(dev, setup, psched, rounds: int, *, capture: bool,
             backend: str = "sparse", prefetch: bool = True, key: int = 1,
             runner=None):
    """``rounds`` rounds of a PooledRunner (a fresh pool unless ``runner``
    is given): (runner, losses, host ms a round to its return)."""
    from repro_torch import prng
    from repro_torch.core import ClientPool, PooledRunner

    template, loss_fn, cfg, batch_fn = setup
    if runner is None:
        runner = PooledRunner(ClientPool(template, psched.m), psched,
                              loss_fn, cfg, batch_fn, key=prng.PRNGKey(key),
                              backend=backend, device=dev, capture=capture,
                              prefetch=prefetch)
    losses, ms = [], []
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else lambda: None)
    for _ in range(rounds):
        sync()
        t0 = time.perf_counter()
        met = runner.round()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    return runner, losses, ms


def pool_arm(dev, setup, psched, name: str, backend: str = "sparse"
             ) -> dict:
    """A pooled arm at full width: ROUNDS eager rounds (prefetch on) with
    every launch counter read (against ROUNDS steps and ROUNDS + 1
    prepares: the last round prefetches the next), ROUNDS captured rounds
    from a fresh pool bitwise with them (the whole store, slots and
    versions, and every round's loss), the step's graph holding exactly
    its kernel nodes (:func:`pool_step_launches`), no copy from host
    memory and no int64 threefry node; finite losses (each round trains
    a cohort of mostly new clients from the template, so the loss stays
    near its first round's)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    quantized = setup[2].quant is not None and setup[2].quant.enabled
    step = pool_step_launches(quantized, backend)
    prep = pool_prepare_launches(psched, quantized)
    expect = {k: ROUNDS * step[k] + (ROUNDS + 1) * prep[k] for k in step}
    torch.cuda.synchronize()
    reset_launch_counts()
    eager, e_loss, e_ms = pool_run(dev, setup, psched, ROUNDS,
                                   capture=False, backend=backend)
    eager.close()
    torch.cuda.synchronize()
    counts = launch_counts()
    t0 = time.perf_counter()
    cap, c_loss, c_ms = pool_run(dev, setup, psched, ROUNDS, capture=True,
                                 backend=backend)
    wall = time.perf_counter() - t0
    bitwise = pools_equal(eager.pool, cap.pool) and e_loss == c_loss
    rep = {"path": name, "m": psched.m, "cohort": psched.cohort_size,
           "backend": backend, "rounds": ROUNDS, "bitwise": bitwise,
           "loss": c_loss, "launches": counts, "expected_launches": expect,
           "round_ms_median": {"eager": statistics.median(e_ms[1:]),
                               "captured": statistics.median(c_ms[1:])},
           "round_ms": {"eager": e_ms, "captured": c_ms},
           "captured_wall_s": wall,
           "replay_device_ms": replay_ms(cap.graph),
           "materialized": cap.pool.materialized,
           "pool_mbytes": cap.pool.nbytes / 2 ** 20,
           "bits_per_round": cap.bits_per_round,
           **check_round_graph(f"{name} step", graph_nodes(cap.graph),
                               step)}
    print(json.dumps(rep), flush=True)
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    if not bitwise:
        raise AssertionError(f"{name}: captured rounds differ from eager")
    if not all(math.isfinite(v) for v in c_loss):
        raise AssertionError(f"{name}: loss {c_loss}")
    rep["runner"] = cap
    return rep


class _Inline:
    """An executor that runs a submitted call at once (the prefetch made
    serial, for timing each part alone)."""

    def submit(self, fn, *args):
        from concurrent.futures import Future
        f = Future()
        f.set_result(fn(*args))
        return f

    def shutdown(self, wait: bool = True) -> None:
        pass


def pool_breakdown(dev, setup, psched, rounds: int = ROUNDS) -> dict:
    """A captured pooled round's time by part, median of rounds 2..: the
    cohort draw (``inputs`` and the read of the ids), the host gather
    into the pinned buffer, the copy to the card, the batches, the step's
    replay (with the graph's input copies), the copy back and the
    write-back into the slabs, and the overlap patch — each alone, by the
    host clock to a synchronize, with the prefetch run inline; the copies
    also by CUDA events; the write-back's host scatter alone, and the
    same scatter into rows the clients already hold. Then the same rounds
    pipelined (the prefetch on its worker thread and side stream, under
    the step and the write-back): the share of the prefetch hidden is
    (serial round - pipelined round) / the prefetch's parts, unclamped (a
    negative share: the pipeline costs more than it hides)."""
    runner, _, _ = pool_run(dev, setup, psched, 0, capture=True)
    runner.close()
    runner._exec = _Inline()
    parts = {p: [] for p in ("draw", "gather", "upload", "batches", "step",
                             "writeback", "patch")}
    events = {"upload": [], "copy_back": []}

    def timed_part(part, fn):
        def call(*args):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize(dev)
            parts[part].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def evented(what, fn, stream):
        def call(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream())
            out = fn(*args)
            b.record(stream())
            b.synchronize()
            events[what].append(a.elapsed_time(b))
            return out
        return call

    side = lambda: runner._side              # noqa: E731
    compute = lambda: torch.cuda.current_stream(dev)  # noqa: E731
    runner._draw = timed_part("draw", runner._draw)
    runner._gather = timed_part("gather", runner._gather)
    runner._upload = timed_part("upload", evented("upload", runner._upload,
                                                  side))
    runner.batch_fn = timed_part("batches", runner.batch_fn)
    runner._step = timed_part("step", runner._step)
    copy_back = evented("copy_back", runner._copy_back, compute)
    runner._copy_back = copy_back
    runner._writeback = timed_part("writeback", runner._writeback)
    parts["scatter"] = []
    scatter = runner.pool.writeback

    def timed_scatter(*args, **kw):
        t0 = time.perf_counter()
        scatter(*args, **kw)
        parts["scatter"].append((time.perf_counter() - t0) * 1e3)
    runner.pool.writeback = timed_scatter
    runner._patch = timed_part("patch", runner._patch)
    pool_run(dev, setup, psched, rounds, capture=True, runner=runner)
    med = {p: statistics.median(v[2:]) for p, v in parts.items()}
    med_ev = {p: statistics.median(v[2:]) for p, v in events.items()}
    # The same scatter into rows the clients already hold (no first
    # touch of new host pages).
    idx = np.nonzero(runner.pool._slot >= 0)[0][:psched.cohort_size]
    rows = {n: t.numpy() for n, t in runner.pool.fetch(idx).items()}
    again = []
    for _ in range(5):
        t0 = time.perf_counter()
        scatter(idx, rows)
        again.append((time.perf_counter() - t0) * 1e3)
    runner.close()
    piped_runner, _, piped = pool_run(dev, setup, psched, rounds,
                                      capture=True)
    piped_runner.close()
    pipelined = statistics.median(piped[1:])
    prefetch = med["draw"] + med["gather"] + med["upload"] + med["batches"]
    on_path = med["step"] + med["writeback"] + med["patch"]
    serial = prefetch + on_path
    nbytes_ = runner.pool.n_params * 4 * psched.cohort_size
    rep = {"path": "pool breakdown", "m": psched.m,
           "cohort": psched.cohort_size, "part_ms_median": med,
           "scatter_into_held_rows_ms_median": statistics.median(again),
           "copy_event_ms_median": med_ev, "copy_bytes": nbytes_,
           "copy_gb_per_s": {p: nbytes_ / v / 1e6 for p, v in
                             med_ev.items()},
           "gather_gb_per_s": nbytes_ / med["gather"] / 1e6,
           "serial_round_ms": serial,
           "pipelined_round_ms_median": pipelined,
           "prefetch_ms": prefetch, "on_path_ms": on_path,
           "hidden_share": (serial - pipelined) / prefetch,
           "side_stream_is_not_compute": runner._side.stream_id
           != torch.cuda.current_stream(dev).stream_id}
    print(json.dumps(rep), flush=True)
    return rep


def pool_vs_cpu(dev, setup, psched, rounds: int = CPU_ROUNDS) -> dict:
    """CPU_ROUNDS rounds of the full-width sync arm on the card (captured)
    and on the CPU, on the 8-bit wire and on fp32, held as
    :func:`async_rounds` holds its events: the same cohorts (slots and
    versions), loss within rtol 1e-5, the whole population's consensus
    distance within POOL_CPU_CONSENSUS, and at most POOL_CPU_SHARE of the
    store's elements more than 1e-5 from the CPU's (the two devices'
    matmuls sum in other orders, which moves a ReLU's or a rounding's
    decision here and there; the largest difference is reported). A
    misrouted B2 src cannot show here: a cohort of 64 in 10^5 holds
    almost no ring edge, so the parity arm and :func:`pool_kernel_checks`
    hold it."""
    import dataclasses
    template, loss_fn, cfg, batch_fn = setup
    cpu_setup = pool_setup(torch.device("cpu"))
    out = {}
    for wire, quant in (("q8", cfg.quant), ("fp32", None)):
        card, c_loss, _ = pool_run(
            dev, (template, loss_fn, dataclasses.replace(cfg, quant=quant),
                  batch_fn), psched, rounds, capture=True)
        cpu, p_loss, _ = pool_run(
            torch.device("cpu"), cpu_setup[:2] + (dataclasses.replace(
                cpu_setup[2], quant=quant), cpu_setup[3]), psched, rounds,
            capture=False)
        card.close()
        cpu.close()
        n = card.pool.materialized
        same = (n == cpu.pool.materialized
                and np.array_equal(card.pool.versions, cpu.pool.versions)
                and np.array_equal(card.pool._slot, cpu.pool._slot))
        far, total, worst = 0, 0, 0.0
        for a, b in zip(card.pool._slabs, cpu.pool._slabs):
            d = np.abs(a[1:n + 1] - b[1:n + 1])
            far += int((d > 1e-5).sum())
            total += d.size
            worst = max(worst, float(d.max()))
        expected_edges = psched.expected_directed_edges()
        out[wire] = {"same_cohorts": same,
                     "loss_rel": [abs(a / b - 1) for a, b in
                                  zip(c_loss, p_loss)],
                     "consensus_rel": abs(card.pool.consensus_distance()
                                          / cpu.pool.consensus_distance()
                                          - 1),
                     "params_off_by_1e-5": far, "params": total,
                     "share_off": far / total,
                     "params_max_abs_diff": worst,
                     "expected_directed_edges": expected_edges}
    rep = {"path": "pool vs cpu", "rounds": rounds, **out}
    print(json.dumps(rep), flush=True)
    for wire, r in out.items():
        if not r["same_cohorts"] or max(r["loss_rel"]) > 1e-5 or \
                r["consensus_rel"] > POOL_CPU_CONSENSUS or \
                r["share_off"] > POOL_CPU_SHARE:
            raise AssertionError(f"pool {wire} on the card leaves the "
                                 f"CPU's: {r}")
    return rep


def pool_resume(dev, setup, psched, whole) -> dict:
    """Save the full-width sync arm at round POOL_RESUME_AT, restore it in
    a new runner (captured), run to ROUNDS: the store bitwise with the
    uninterrupted run ``whole``, its key and ledger too."""
    import tempfile
    from repro_torch.core import PooledRunner
    template, loss_fn, cfg, batch_fn = setup
    first, _, _ = pool_run(dev, setup, psched, POOL_RESUME_AT, capture=True)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        first.save(d)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = PooledRunner.restore(d, template, psched, loss_fn, cfg,
                                     batch_fn, backend="sparse", device=dev)
        restore_s = time.perf_counter() - t0
    first.close()
    pool_run(dev, setup, psched, ROUNDS - POOL_RESUME_AT, capture=True,
             runner=again)
    again.close()
    ok = (pools_equal(again.pool, whole.pool)
          and torch.equal(again.rng, whole.rng)
          and again.comm_bits == whole.comm_bits and again.t == whole.t)
    rep = {"path": "pool resume", "saved_at": POOL_RESUME_AT,
           "bitwise": ok, "save_s": save_s, "restore_s": restore_s,
           "materialized_at_save": first.pool.materialized}
    print(json.dumps(rep), flush=True)
    if not ok:
        raise AssertionError(f"pool resume differs: {rep}")
    return rep


def pool_async(dev, setup) -> dict:
    """PooledAsyncRunner at m = POOL_M on the structural ring
    (self-weight 0.5) under ASYNC_SPEED's straggler tail (``max_staleness``
    8, inverse), dense 8-bit, capacity 3 x POOL_ASYNC_READY (the ready
    clients and their two neighbours each): ROUNDS eager events with
    their launch counts, then ROUNDS captured events from a fresh pool
    bitwise with them (store, versions, clocks, metrics)."""
    from repro_torch import prng
    from repro_torch.core import (AsyncConfig, ClientPool, PooledAsyncRunner,
                                  SpeedModel)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    template, loss_fn, cfg, batch_fn = setup
    acfg = AsyncConfig(speed=SpeedModel.straggler(**ASYNC_SPEED),
                       max_staleness=8, discount="inverse")
    capacity = 3 * POOL_ASYNC_READY

    def make(capture):
        return PooledAsyncRunner(ClientPool(template, POOL_M), loss_fn, cfg,
                                 acfg, batch_fn, key=prng.PRNGKey(1),
                                 capacity=capacity, ring_self_weight=0.5,
                                 device=dev, capture=capture)

    out = {}
    for mode in ("eager", "captured"):
        runner = make(mode == "captured")
        torch.cuda.synchronize()
        reset_launch_counts()
        mets, ms = [], []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            met = runner.step_event()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append({k: float(v) for k, v in met.items()})
        out[mode] = {"runner": runner, "metrics": mets,
                     "launches": launch_counts(), "ms": ms}
    e, c = out["eager"], out["captured"]
    per = pool_step_launches(True, "dense")
    per["threefry_split"] += 3 + 1 + 3     # keys, clock split, batches
    per["threefry_normal"] = 1
    per["threefry_bits"] = 2
    expect = {k: ROUNDS * v for k, v in per.items()}
    bitwise = (pools_equal(e["runner"].pool, c["runner"].pool)
               and e["metrics"] == c["metrics"]
               and torch.equal(e["runner"].next_ready,
                               c["runner"].next_ready))
    rep = {"path": "pool async", "m": POOL_M, "capacity": capacity,
           "events": ROUNDS, "bitwise": bitwise,
           "launches": e["launches"], "expected_launches": expect,
           "event_ms_median": {m_: statistics.median(out[m_]["ms"][1:])
                               for m_ in out},
           "replay_device_ms": replay_ms(c["runner"].graph),
           "ready_frac": [x["ready_frac"] for x in c["metrics"]],
           "loss": [x["loss"] for x in c["metrics"]],
           "versions_sum": int(c["runner"].pool.versions.sum()),
           **check_round_graph("pool async event",
                               graph_nodes(c["runner"].graph),
                               pool_step_launches(True, "dense"))}
    print(json.dumps(rep), flush=True)
    if e["launches"] != expect:
        raise AssertionError(f"pool async: launches {e['launches']} != "
                             f"{expect}")
    if not bitwise:
        raise AssertionError("pool async: captured events differ")
    return rep


def pool_parity(dev) -> dict:
    """The quickstart (m 16) under PR 19's exact k-10 cohort
    (``partial(ring16, 0.625, exact=True)``): ROUNDS pooled rounds
    (captured; ``from_schedule`` and ``ring_partial``) against the
    resident skip path (eager) on the same key and batches, on the plan
    realization and on the dense mixer, fp32 and 8-bit: the store against
    the resident parameters, in ulp and relative to each leaf's scale;
    the plan realization bitwise, the dense arms each leaf within
    POOL_DENSE_REL of its scale. Then one dense mix of the same z at the
    cohort's [k, k] against [M, M], the cause where the dense arms part:
    each leaf within POOL_DENSE_MIX_ULP."""
    from repro_torch import prng
    from repro_torch.core import (ClientPool, DFedAvgMConfig, PoolSchedule,
                                  PooledRunner, QuantConfig, TopologySchedule,
                                  init_round_state, make_round_step,
                                  mix_dense, ring_graph)

    _, fed, stacked, _, _, loss_fn, _ = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    sched = TopologySchedule.partial(ring_graph(M), POOL_PARITY_P,
                                     exact=True)
    template = {n: t[0].cpu() for n, t in stacked.items()}
    out = {}
    for backend in ("sparse", "dense"):
        for bits in (32, 8):
            cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                                 quant=QuantConfig(bits=bits),
                                 mixer_impl=backend)
            step = make_round_step(loss_fn, cfg, sched, device=dev)
            st = init_round_state(stacked, prng.PRNGKey(1))
            for b in batches:
                st, _ = step(st, b)
            arm = {}
            for pname, ps in (
                    ("from_schedule", PoolSchedule.from_schedule(sched)),
                    ("ring_partial", PoolSchedule.ring_partial(
                        M, POOL_PARITY_P))):
                runner = PooledRunner(
                    ClientPool(template, M), ps, loss_fn, cfg,
                    lambda ids, t: {n: x[ids] for n, x in
                                    batches[t % ROUNDS].items()},
                    key=prng.PRNGKey(1), backend=backend, device=dev)
                runner.run(ROUNDS)
                got = runner.pool.fetch(np.arange(M))
                arm[pname] = max(ulp_diff(got[n].to(dev), st.params[n])
                                 for n in got)
                arm[pname + " rel_to_scale"] = {
                    n: float((got[n].to(dev) - st.params[n]).abs().max()
                             / st.params[n].abs().max()) for n in got}
                runner.close()
            out[f"{backend} {'fp32' if bits == 32 else 'q8'}"] = arm
    # The cause, where the dense mix parts: one mix of the same z, leaf by
    # leaf, at the cohort's [k, k] rows and columns of W_t against the
    # resident's [M, M].
    W_t, active, _ = sched.round_event(prng.PRNGKey(3, device=dev), 0)
    idx = torch.nonzero(active)[:, 0]
    gen = torch.Generator(device=dev).manual_seed(7)
    z = {n: torch.randn(t.shape, generator=gen, device=dev)
         for n, t in stacked.items()}
    full = mix_dense(W_t, z)
    sub = mix_dense(W_t[idx][:, idx].contiguous(),
                    {n: t[idx] for n, t in z.items()})
    out["one dense mix, [k, k] vs [M, M]"] = {
        n: {"max_ulp": ulp_diff(sub[n], full[n][idx]),
            "share_apart": float((sub[n] != full[n][idx]).float().mean())}
        for n in sorted(z)}
    print(json.dumps({"check": "pool parity (max ulp, pooled vs resident "
                      "skip path)", "k": sched.n_active, **out}), flush=True)
    for arm in ("sparse fp32", "sparse q8"):
        if any(v for k_, v in out[arm].items() if "rel" not in k_):
            raise AssertionError(f"pool parity: {arm} is not bitwise with "
                                 f"the resident skip path: {out[arm]}")
    for wire, limit in POOL_DENSE_REL.items():
        arm = out[f"dense {wire}"]
        if any(v > limit for k_, rel in arm.items() if "rel" in k_
               for v in rel.values()):
            raise AssertionError(f"pool parity: dense {wire} leaves the "
                                 f"resident skip path by more than "
                                 f"POOL_DENSE_REL: {arm}")
    if any(r["max_ulp"] > POOL_DENSE_MIX_ULP for r in out[
            "one dense mix, [k, k] vs [M, M]"].values()):
        raise AssertionError("pool parity: one dense mix at [k, k] parts "
                             "from [M, M] by more than POOL_DENSE_MIX_ULP")
    return out


def pool_async_parity(dev) -> dict:
    """The async pool against the resident engine on the card: the
    quickstart (m 16, the ring at self-weight 0.5) under ASYNC_SPEED's
    straggler tail, dense 8-bit (the pool's mix), ROUNDS events from one
    key and the same batches, at capacity M and 6: versions and clocks
    equal, the store within POOL_ASYNC_DENSE_ULP of the resident
    parameters."""
    from repro_torch import prng
    from repro_torch.core import (AsyncConfig, ClientPool, DFedAvgMConfig,
                                  MixingSpec, PooledAsyncRunner, QuantConfig,
                                  SpeedModel, init_async_state,
                                  make_round_step)

    _, fed, stacked, _, _, loss_fn, _ = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    spec = MixingSpec.ring(M, self_weight=0.5)
    acfg = AsyncConfig(speed=SpeedModel.straggler(**ASYNC_SPEED),
                       max_staleness=8, discount="inverse")
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8), mixer_impl="dense")
    step = make_round_step(loss_fn, cfg, spec, device=dev, async_cfg=acfg)
    st = init_async_state(stacked, prng.PRNGKey(1), acfg.speed)
    for b in batches:
        st, _ = step(st, b)
    template = {n: t[0].cpu() for n, t in stacked.items()}
    out = {}
    for capacity in (M, 6):
        holder = {}
        runner = holder["r"] = PooledAsyncRunner(
            ClientPool(template, M), loss_fn, cfg, acfg,
            lambda ids, vers: {n: x[ids] for n, x in
                               batches[holder["r"].round].items()},
            key=prng.PRNGKey(1), capacity=capacity, spec=spec, device=dev)
        runner.run(ROUNDS)
        got = runner.pool.fetch(np.arange(M))
        out[f"capacity {capacity}"] = {
            "max_ulp": max(ulp_diff(got[n].to(dev), st.params[n])
                           for n in got),
            "versions_equal": torch.equal(runner.version, st.version),
            "clock_equal": torch.equal(runner.next_ready, st.next_ready)}
    print(json.dumps({"check": "pool async vs the resident engine",
                      **out}), flush=True)
    for k, r in out.items():
        if not (r["versions_equal"] and r["clock_equal"]):
            raise AssertionError(f"pool async ({k}) fires other clients "
                                 f"than the resident engine: {r}")
        if r["max_ulp"] > POOL_ASYNC_DENSE_ULP:
            raise AssertionError(f"pool async ({k}) leaves the resident "
                                 f"engine by more than "
                                 f"POOL_ASYNC_DENSE_ULP: {r}")
    return out


# The kernels whose rows of the kernels line report the pool path: held
# against their plain versions at its shapes (:func:`pool_kernel_checks`).
POOL_KERNELS = ("quantize_pack_buffer", "dequant_mix_buffer", "momentum_sgd")


def pool_kernel_checks(dev, flush, rec, setup, psched) -> None:
    """B1, B2 and B3 at the shapes the pool path gives them, bitwise
    against their plain versions and timed against their bounds; the
    kernels line's rows of POOL_KERNELS then report these (their launches
    are the pool's) and keep the quickstart's times under ``quickstart``
    (B2's at K = 11 stay under ``k11``).
    Round 0 of the headline (``psched``, cohort POOL_K of POOL_M) gives
    the cohort, W_sub and the per-leaf quantizer keys drawn at the full
    width and gathered ([6, POOL_K, 2]); B1 encodes x [POOL_K, 4, 51 712]
    under them; B2 decodes K 3 with src the cohort's lane map ([3, POOL_K]:
    the lane, then the ring plan's two steps remapped onto the cohort, a
    neighbour outside it read as the lane itself at weight 0); B3 steps
    the 2NN's six leaves for POOL_K clients. Then T1's batched fold_in
    (``threefry_fold_in_each``, counted as T1) at the batches' shapes: the
    cohort's ids into one key, and a counter into each of those POOL_K
    keys (the async pool's versions), against ``prng.fold_in_plain``;
    recorded under ``rec["threefry_split"]["fold_in_each"]``."""
    from repro_torch import prng
    from repro_torch.core import WireLayout
    from repro_torch.core.client_pool import (_cohort_lane_map,
                                              make_pooled_round_step)
    from repro_torch.kernels import momentum_update, ref, threefry
    from repro_torch.kernels.dequant_mix import (dequant_mix_buffer,
                                                 dequant_mix_buffer_plain)
    from repro_torch.kernels.quantize_pack import quantize_pack_buffer

    template, loss_fn, cfg, _ = setup
    quant, k = cfg.quant, psched.cohort_size
    inp = make_pooled_round_step(loss_fn, cfg, psched, template,
                                 backend="sparse", device=dev).inputs(
        prng.PRNGKey(1, device=dev), 0)
    idx, W_sub, keys = inp["idx"], inp["W_sub"], inp["leaf_keys"]
    src_np = psched.plan_src()
    live = [j for j in range(src_np.shape[0])
            if (src_np[j] != np.arange(psched.m)).any()]
    lane_src, w_steps = _cohort_lane_map(torch.as_tensor(
        src_np[live].astype(np.int64), device=dev), idx, W_sub)
    lanes = torch.arange(k, device=dev)
    src = torch.cat([lanes[None], lane_src]).to(torch.int32)
    w = torch.cat([torch.diagonal(W_sub)[None], w_steps]).T.contiguous()
    gen = torch.Generator().manual_seed(21)

    def stacked(scale):
        return {n: (torch.randn((k,) + tuple(t.shape), generator=gen) * scale)
                .to(dev) for n, t in template.items()}

    x = stacked(0.05)
    z = {n: t + 0.01 * torch.randn(t.shape, generator=gen).to(dev)
         for n, t in x.items()}
    layout = WireLayout.for_tree(x, quant.bits, stacked=True)
    X = layout.to_planar_stacked(x)
    delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
    sblk = layout.block_scales(layout.leaf_scales(delta, quant))
    table, bits = layout.noise_table, quant.bits
    words = quantize_pack_buffer(delta, sblk, bits, keys=keys, table=table)
    check_words("B1 pool", words, ref.quantize_pack_buffer_ref(
        delta, sblk, bits, layout.noise_stacked(keys)))
    out = dequant_mix_buffer(X, words, sblk, w, src, bits)
    out_ref = dequant_mix_buffer_plain(X, words, sblk, w, src, bits)
    y, v, g = stacked(0.05), stacked(0.01), stacked(0.1)
    ys, vs = momentum_update(y, v, g, ETA, THETA)
    want = {n: ref.momentum_sgd_ref(y[n], v[n], g[n], ETA, THETA) for n in y}
    torch.cuda.synchronize()
    check_words("B2 pool", out.view(torch.int32), out_ref.view(torch.int32))
    check_floats(rec["dequant_mix_buffer"], "B2 pool", [(out, out_ref)])
    b3 = [(ys[n], want[n][0]) for n in y] + [(vs[n], want[n][1]) for n in y]
    for a, c in b3:
        check_words("B3 pool", a.view(torch.int32), c.view(torch.int32))
    check_floats(rec["momentum_sgd"], "B3 pool", b3)
    reading = int((lane_src != lanes[None]).sum())
    n_el = sum(t.numel() for t in y.values())
    r1 = {"shape": f"x f32 {list(delta.shape)}, keys {list(keys.shape)} "
                   f"gathered from [6, {psched.m}, 2]"}
    timed(r1, "", lambda: quantize_pack_buffer(delta, sblk, bits, keys=keys,
                                               table=table), flush)
    timed(r1, "plain_", lambda: ref.quantize_pack_buffer_ref(
        delta, sblk, bits, layout.noise_stacked(keys)), flush)
    r1["sass"] = keyed_ops("quantize_pack_buffer", bits,
                           delta.shape[0] * delta.shape[2] // 4,
                           sum(layout.sizes) * k)
    r1["bound_ms"], r1["bound_by"] = bound(nbytes(delta, sblk, keys, words),
                                           0, r1["sass"]["ms"])
    r2 = {"shape": f"base {list(X.shape)}, weights {list(w.shape)}, src "
                   f"{list(src.shape)} (the lane map: {reading} plan steps "
                   "read another lane)"}
    timed(r2, "", lambda: dequant_mix_buffer(X, words, sblk, w, src, bits),
          flush)
    timed(r2, "plain_", lambda: dequant_mix_buffer_plain(
        X, words, sblk, w, src, bits), flush)
    r2["bound_ms"], r2["bound_by"] = bound(
        nbytes(X, words, sblk, w, src, out), X.numel() * 3 * src.shape[0])
    r3 = {"shape": f"one local step: 6 leaves x {k} clients ({n_el} f32)"}
    timed(r3, "", lambda: momentum_update(y, v, g, ETA, THETA), flush)
    timed(r3, "plain_", lambda: [ref.momentum_sgd_ref(
        y[n], v[n], g[n], ETA, THETA) for n in y], flush)
    params = [t.clone() for t in y.values()]
    bufs = [t.clone() for t in v.values()]
    timed(r3, "library_", lambda: torch._fused_sgd_(
        params, list(g.values()), bufs, weight_decay=0.0, momentum=THETA,
        lr=ETA, dampening=0.0, nesterov=False, maximize=False,
        is_first_step=False), flush)
    r3["bound_ms"], r3["bound_by"] = bound(5 * 4 * n_el, 3 * n_el)
    for name, new in zip(POOL_KERNELS, (r1, r2, r3)):
        r = rec[name]
        r["quickstart"] = {f: r.pop(f) for f in list(r) if f not in (
            "checks", "max_abs_err", "max_ulp", "k11")}
        r.update(new)
        r["checks"].append(f"pool: {new['shape']}: bitwise")

    key = prng.PRNGKey(0, device=dev)
    data = torch.randint(0, 2 ** 33, (k,), generator=gen).to(dev)
    one = threefry.fold_in(key, idx)
    each = threefry.fold_in(one, data)
    check_words("T1 fold_in_each, one key", one,
                prng.fold_in_plain(key, idx))
    check_words("T1 fold_in_each, a key a row", each,
                prng.fold_in_plain(one, data))
    f = {"shape": f"key [2] and keys [{k}, 2], data [{k}] -> [{k}, 2]"}
    timed(f, "", lambda: threefry.fold_in(key, idx), flush)
    timed(f, "plain_", lambda: prng.fold_in_plain(key, idx), flush)
    f["sass"] = threefry_ops("threefry_fold_in_each", k)
    f["bound_ms"], f["bound_by"] = bound(nbytes(key, idx, one), 0,
                                         f["sass"]["ms"])
    rec.setdefault("threefry_split", {"checks": []})["fold_in_each"] = f
    rec["threefry_split"]["checks"].append(
        f"fold_in_each: one key x [{k}] ids, [{k}] keys x [{k}] counters "
        "(some >= 2^32): bitwise")
    print(json.dumps({"check": "pool kernels", **{
        n: {f_: rec[n][f_] for f_ in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "max_ulp")}
        for n in POOL_KERNELS}, "fold_in_each": f}), flush=True)


def pool_phase(dev, flush=None, rec=None) -> tuple[dict, dict]:
    """Phase "pool": the virtual client pool on the card. The README's
    headline (m POOL_M, cohort POOL_K, the structural ring's exact
    cohorts, the 2NN, 8-bit stochastic lemma5 on the plan realization):
    its kernels at its shapes (:func:`pool_kernel_checks`, into ``rec``;
    alone, with ``--only pool``, into a record of its own), eager and
    captured (:func:`pool_arm`), its round's time by part
    (:func:`pool_breakdown`), CPU_ROUNDS against the CPU
    (:func:`pool_vs_cpu`), a resume from round POOL_RESUME_AT
    (:func:`pool_resume`); the structural walk (k 2); the async pool
    (:func:`pool_async`); the parity arm (:func:`pool_parity`); and
    ``bench.pool`` at full size. Returns the summaries and the headline
    arm's eager launches."""
    from repro_torch.bench import pool as bench_pool
    from repro_torch.core import PoolSchedule

    if rec is None:
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
        rec = {k: {"max_abs_err": 0.0, "max_ulp": 0, "checks": []}
               for k in POOL_KERNELS}
    setup = pool_setup(dev)
    psched = PoolSchedule.ring_partial(POOL_M, POOL_K / POOL_M)
    pool_kernel_checks(dev, flush, rec, setup, psched)
    out = {"sync": pool_arm(dev, setup, psched, "pool sync")}
    out["resume"] = pool_resume(dev, setup, psched, out["sync"]["runner"])
    out["breakdown"] = pool_breakdown(dev, setup, psched)
    out["vs_cpu"] = pool_vs_cpu(dev, setup, psched)
    out["walk"] = pool_arm(dev, setup, PoolSchedule.ring_random_walk(POOL_M),
                           "pool walk")
    out["async"] = pool_async(dev, setup)
    out["parity"] = pool_parity(dev)
    out["async_parity"] = pool_async_parity(dev)
    t0 = time.perf_counter()
    res, rows = bench_pool.run_pool(device=dev)
    out["bench"] = {"wall_s": time.perf_counter() - t0, **res}
    print(json.dumps({"path": "bench pool", **out["bench"]}), flush=True)
    for f in ("bitwise_equal", "billing_equal", "flops_equal"):
        if not res["compare"][f]:
            raise AssertionError(f"bench pool: {f} is false")
    for k in ("sync", "walk"):
        out[k].pop("runner").close()
    return out, out["sync"]["launches"]


# ---------------------------------------------------------------------------
# The "telemetry" phase: the in-graph Telemetry of the sync, fused, async
# and pooled steps on the card, the tracer, the run log and its report.
# ---------------------------------------------------------------------------

# The quickstart on the static ring and two schedules whose telemetry
# differs: sampled edges (live edges change every round) and an exact
# cohort (compute-skip gathers; the replay is weighted by ``active``).
TELEMETRY_SPECS = ("ring", "edge_sample", "partial_exact")
# Nodes of a captured quickstart round on the static ring with telemetry
# off, what this phase's off graph must keep: read on the card from the
# tree before the telemetry slice (``captured_rounds``; 284 and 333 in
# PR 18, one node more since).
OFF_GRAPH_NODES = {"unfused": 285, "fused": 334}
# One telemetry round on the card against the same round on the CPU
# (from the card's state after TEL_CPU_ROUND rounds): relative
# tolerances, and the fields that must be equal.
TEL_CPU_RTOL = {"consensus_dist": 1e-5, "local_drift": 1e-5,
                "quant_err_sq": 1e-4, "quant_bound": 1e-4}
TEL_CPU_EQUAL = ("live_edges", "wire_bits", "quant_sat_frac")
TEL_CPU_ROUND = 3
# The JAX package's gate on with_telemetry's wall clock (its CPU runner):
# printed beside the card's ratios, not a gate here.
REFERENCE_OVERHEAD = 1.10
N_LEAVES_2NN = 6


def telemetry_spec(kind: str):
    """The telemetry phase's spec ``kind`` at m = M (the quickstart's)."""
    from repro_torch.core import MixingSpec, TopologySchedule, ring_graph
    return {"ring": lambda: MixingSpec.ring(M, self_weight=0.5),
            "edge_sample": lambda: TopologySchedule.edge_sample(
                ring_graph(M), 0.5),
            "partial_exact": lambda: TopologySchedule.partial(
                ring_graph(M), 0.6, exact=True)}[kind]()


def telemetry_extra_launches(fuse_round: bool, lanes: int = 1) -> dict:
    """Launches telemetry adds to a quantized round or event: the
    replay's per-leaf keys (one T1 split) and its noise, one T2 launch a
    leaf over the replayed lanes' keys; the fused round replays nothing.
    ``lanes`` 0: the keys are given (the pooled step's gathered keys)."""
    extra = dict.fromkeys(KERNEL_SOURCES, 0)
    if not fuse_round:
        extra["threefry_split"] = 1 if lanes else 0
        extra["threefry_uniform"] = N_LEAVES_2NN
    return extra


def node_label(op: str, name: str) -> str:
    """A graph node's group for the extra-node count: the port's kernels
    and matmuls by :func:`_kernel_group`, any other kernel by its
    demangled function and first template argument, else its operation."""
    if op != "kernel":
        return op
    g = _kernel_group(name)
    if g in KERNEL_SOURCES or g == "matmul":
        return g
    text = demangle(name)
    text = re.sub(r"^void ", "", text).split("(")[0]
    return text[:120]


def extra_nodes(on, off) -> dict:
    """The nodes of graph ``on`` beyond graph ``off``'s, by label."""
    from collections import Counter
    diff = Counter(node_label(*n) for n in on) - Counter(
        node_label(*n) for n in off)
    return dict(sorted(diff.items(), key=lambda kv: -kv[1]))


def tel_host(met) -> dict:
    from repro_torch.telemetry import telemetry_host
    return telemetry_host(met["telemetry"])


def telemetry_equal(a, b) -> bool:
    """Two Telemetry of device tensors equal field by field (None too)."""
    return all((x is None and y is None) or (
        x is not None and y is not None and torch.equal(x, y))
        for x, y in zip(a, b))


def timed_rounds(fn, state, batches, keep: bool = False):
    """Rounds of ``fn`` from ``state``: (final state, metrics by round,
    host ms by round, states by round when ``keep``)."""
    mets, ms, states = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = fn(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        mets.append(met)
        if keep:
            states.append(state)
    return state, mets, ms, states


def telemetry_rounds(dev, kind: str, fuse_round: bool, setup) -> dict:
    """The quickstart on ``telemetry_spec(kind)``, unfused or fused,
    telemetry off and on, eager and captured, ROUNDS rounds each from one
    state: launches exact (a round's, plus :func:`telemetry_extra_launches`
    on); on bitwise with off (parameters, key, every metric) eager and
    captured; captured on bitwise with eager on (the Telemetry too); each
    graph's kernel nodes exact, the static ring's off graph
    OFF_GRAPH_NODES; the on graph's extra nodes by group; round
    TEL_CPU_ROUND against the CPU (TEL_CPU_RTOL, TEL_CPU_EQUAL)."""
    from repro_torch import prng
    from repro_torch.core import (DFedAvgMConfig, QuantConfig, capture_step,
                                  init_round_state, make_round_step)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    stacked, batches, loss_fn = setup
    spec = telemetry_spec(kind)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8), fuse_round=fuse_round)
    variant = "fused" if fuse_round else "unfused"
    name = f"telemetry {variant} {kind}"

    def make(on: bool, device=dev):
        return make_round_step(loss_fn, cfg, spec, device=device,
                               with_telemetry=on)

    s0 = init_round_state(stacked, prng.PRNGKey(1))
    per = round_launches(spec, fuse_round=fuse_round)
    extra = telemetry_extra_launches(fuse_round)
    per_on = {k: per[k] + extra[k] for k in per}
    eager, counts, ms = {}, {}, {}
    for on in (False, True):
        step = make(on)
        torch.cuda.synchronize()
        reset_launch_counts()
        fin, mets, ms[f"eager_{on}"], states = timed_rounds(
            step, s0, batches, keep=True)
        counts[on] = launch_counts()
        eager[on] = (fin, mets, states)
    rep = {"path": name, "rounds": ROUNDS, "launches_on": counts[True],
           "expected_launches_on": {k: ROUNDS * v for k, v in per_on.items()},
           "launches_off": counts[False]}
    if counts[False] != {k: ROUNDS * v for k, v in per.items()}:
        raise AssertionError(f"{name}: off launches {counts[False]}")
    if counts[True] != rep["expected_launches_on"]:
        raise AssertionError(f"{name}: on launches {counts[True]} != "
                             f"{rep['expected_launches_on']}")

    def same_state(a, b) -> bool:
        return torch.equal(a.rng, b.rng) and all(
            torch.equal(a.params[n], b.params[n]) for n in a.params)

    rep["eager_on_equals_off"] = all(
        same_state(a, b) and all(torch.equal(ma[k], mb[k]) for k in ma)
        for a, b, ma, mb in zip(eager[False][2], eager[True][2],
                                eager[False][1], eager[True][1]))

    runs = {on: capture_step(make(on), s0, batches[0]) for on in (False,
                                                                  True)}
    cap = {}
    for on in (False, True):
        fin, mets, ms[f"captured_{on}"], states = timed_rounds(
            runs[on], s0, batches, keep=True)
        cap[on] = (fin, mets, states)
    rep["captured_off_equals_eager_off"] = all(
        same_state(a, b) for a, b in zip(cap[False][2], eager[False][2]))
    rep["captured_on_equals_eager_on"] = all(
        same_state(a, b) and telemetry_equal(ma["telemetry"], mb["telemetry"])
        for a, b, ma, mb in zip(cap[True][2], eager[True][2],
                                cap[True][1], eager[True][1]))
    nodes = {on: graph_nodes(runs[on].graph) for on in (False, True)}
    rep["graph_nodes"] = {"off": len(nodes[False]), "on": len(nodes[True])}
    rep["extra_nodes"] = extra_nodes(nodes[True], nodes[False])
    rep["replay_device_ms"] = {"off": replay_ms(runs[False].graph),
                               "on": replay_ms(runs[True].graph)}
    rep["round_ms_median"] = {k: statistics.median(v[1:])
                              for k, v in ms.items()}
    graph_off = check_round_graph(f"{name} off", nodes[False], per)
    graph_on = check_round_graph(f"{name} on", nodes[True], per_on)
    rep["kernel_nodes_on"] = graph_on["kernel_nodes"]
    rep["telemetry_last"] = tel_host(eager[True][1][-1])

    # One round against the CPU, from the card's state after
    # TEL_CPU_ROUND rounds.
    st = eager[True][2][TEL_CPU_ROUND - 1]
    s_cpu = init_round_state({n: t.cpu() for n, t in st.params.items()},
                             st.rng.cpu())._replace(round=st.round)
    _, m_cpu = make(True, "cpu")(s_cpu, {n: t.cpu() for n, t in
                                         batches[TEL_CPU_ROUND].items()})
    got = tel_host(eager[True][1][TEL_CPU_ROUND])
    want = tel_host(m_cpu)
    rep["vs_cpu_rel"] = {k: abs(got[k] / want[k] - 1) if want[k] else
                         abs(got[k]) for k in TEL_CPU_RTOL if k in want}
    rep["vs_cpu_equal"] = {k: got[k] == want[k] for k in TEL_CPU_EQUAL
                           if k in want}
    rep["vs_cpu"] = {"card": got, "cpu": want}
    print(json.dumps(rep), flush=True)
    if set(got) != set(want):
        raise AssertionError(f"{name}: fields {sorted(got)} on the card, "
                             f"{sorted(want)} on the CPU")
    for k, rel in rep["vs_cpu_rel"].items():
        if rel > TEL_CPU_RTOL[k]:
            raise AssertionError(f"{name}: {k} {got[k]} on the card, "
                                 f"{want[k]} on the CPU")
    if not all(rep["vs_cpu_equal"].values()):
        raise AssertionError(f"{name}: card and CPU differ: "
                             f"{rep['vs_cpu_equal']}")
    for f in ("eager_on_equals_off", "captured_off_equals_eager_off",
              "captured_on_equals_eager_on"):
        if not rep[f]:
            raise AssertionError(f"{name}: {f} is false")
    if kind == "ring" and len(nodes[False]) != OFF_GRAPH_NODES[variant]:
        raise AssertionError(f"{name}: the off graph has {len(nodes[False])}"
                             f" nodes, not {OFF_GRAPH_NODES[variant]}")
    if graph_off["host_copies"] or graph_on["host_copies"]:
        raise AssertionError(f"{name}: a graph copies from the host")
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"{name}: telemetry {got}")
    return rep


def telemetry_async(dev, setup) -> dict:
    """The async phase's decay arm with telemetry: ROUNDS eager events
    (launches: :func:`event_launches` plus the replay's over every lane)
    bitwise with the events without it, ROUNDS captured events bitwise
    with the eager ones (the Telemetry too); each event's histogram sums
    to M, and ``live_edges + dropped_edges`` equals the base matrix's
    live edges on the ready rows; the captured engine's stacked
    Telemetry equals the event loop's."""
    from repro_torch import prng
    from repro_torch.core import (DFedAvgMConfig, QuantConfig, capture_step,
                                  init_async_state, make_async_engine,
                                  make_round_step, next_event)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.telemetry import live_edge_count

    stacked, batches, loss_fn = setup
    spec, acfg = async_arm("decay")
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8))
    name = "telemetry async decay"

    def make(on: bool):
        return make_round_step(loss_fn, cfg, spec, device=dev,
                               async_cfg=acfg, with_telemetry=on)

    s0 = init_async_state(stacked, prng.PRNGKey(1), acfg.speed)
    per = event_launches(spec, acfg)
    extra = telemetry_extra_launches(False)
    expect = {k: ROUNDS * (per[k] + extra[k]) for k in per}
    off_fin, _, _, off_states = timed_rounds(make(False), s0, batches,
                                             keep=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    on_fin, on_mets, on_ms, on_states = timed_rounds(make(True), s0,
                                                     batches, keep=True)
    counts = launch_counts()
    run = capture_step(make(True), s0, batches[0])
    W = torch.as_tensor(spec.W, dtype=torch.float32, device=dev)
    state, hist_ok, invariant, cap_equal, cap_ms = s0, True, True, True, []
    for t, b in enumerate(batches):
        pre = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = run(state, b)
        torch.cuda.synchronize()
        cap_ms.append((time.perf_counter() - t0) * 1e3)
        tel = met["telemetry"]
        hist_ok &= int(tel.staleness_hist.sum()) == M
        _, ready = next_event(pre.next_ready)
        base = live_edge_count(W * ready[:, None])
        invariant &= float(tel.live_edges + tel.dropped_edges) == float(base)
        cap_equal &= (telemetry_equal(tel, on_mets[t]["telemetry"])
                      and all(torch.equal(state.params[n],
                                          on_states[t].params[n])
                              for n in state.params))
    engine = make_async_engine(loss_fn, cfg, spec, acfg, device=dev,
                               with_telemetry=True, capture=True)
    _, e_mets = engine(s0, {n: torch.stack([b[n] for b in batches])
                            for n in batches[0]})
    stacked_loop = type(on_mets[0]["telemetry"])(*(
        None if f is None else torch.stack([m_["telemetry"][i]
                                            for m_ in on_mets])
        for i, f in enumerate(on_mets[0]["telemetry"])))
    nodes_on = graph_nodes(run.graph)
    off_run = capture_step(make(False), s0, batches[0])
    nodes_off = graph_nodes(off_run.graph)
    graph_on = check_round_graph(f"{name} on", nodes_on,
                                 {k: per[k] + extra[k] for k in per})
    rep = {"path": name, "events": ROUNDS, "launches": counts,
           "expected_launches": expect,
           "on_equals_off": all(
               torch.equal(a.params[n], b.params[n]) and torch.equal(
                   a.version, b.version)
               for a, b in zip(on_states, off_states) for n in a.params),
           "captured_equals_eager": cap_equal, "hist_sums_to_m": hist_ok,
           "live_plus_dropped_is_base": invariant,
           "engine_equals_loop": telemetry_equal(e_mets["telemetry"],
                                                 stacked_loop),
           "graph_nodes": {"off": len(nodes_off), "on": len(nodes_on)},
           "extra_nodes": extra_nodes(nodes_on, nodes_off),
           "replay_device_ms": {"off": replay_ms(off_run.graph),
                                "on": replay_ms(run.graph)},
           "event_ms_median": {"eager_on": statistics.median(on_ms[1:]),
                               "captured_on": statistics.median(cap_ms[1:])},
           "kernel_nodes_on": graph_on["kernel_nodes"],
           "telemetry_last": tel_host(on_mets[-1])}
    print(json.dumps(rep), flush=True)
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    for f in ("on_equals_off", "captured_equals_eager", "hist_sums_to_m",
              "live_plus_dropped_is_base", "engine_equals_loop"):
        if not rep[f]:
            raise AssertionError(f"{name}: {f} is false")
    return rep


def telemetry_pool(dev, breakdown: dict | None = None) -> dict:
    """The pool at the README's headline (POOL_M, POOL_K, the 2NN, q8):
    ROUNDS captured rounds with telemetry off, ROUNDS with telemetry on
    and no tracer, ROUNDS with telemetry and an enabled Tracer, each from
    a fresh pool: the stores bitwise; the host fields (cohort size, pool
    hits and misses, the realized bill); the step graph's kernel nodes
    (the replay's T2 a leaf); the traced rounds written through RunLog
    to a JSONL in a temporary directory with the trace saved beside it,
    the log schema-valid (``check_schema``) and rendered by
    ``launch.report``; the span totals beside ``pool_breakdown``'s parts
    (``breakdown``, when the pool phase ran)."""
    import tempfile
    from repro_torch import prng
    from repro_torch.core import ClientPool, PoolSchedule, PooledRunner
    from repro_torch.core.quantize import message_bits
    from repro_torch.launch import report
    from repro_torch.telemetry import RunLog, Tracer, check_schema

    setup = pool_setup(dev)
    template, loss_fn, cfg, batch_fn = setup
    psched = PoolSchedule.ring_partial(POOL_M, POOL_K / POOL_M)
    off, off_loss, off_ms = pool_run(dev, setup, psched, ROUNDS,
                                     capture=True)
    off.close()

    def runner(tracer=None):
        return PooledRunner(ClientPool(template, POOL_M), psched, loss_fn,
                            cfg, batch_fn, key=prng.PRNGKey(1),
                            backend="sparse", device=dev, capture=True,
                            telemetry=True, tracer=tracer)

    plain, plain_loss, plain_ms = pool_run(dev, setup, psched, ROUNDS,
                                           capture=True, runner=runner())
    plain.close()
    tracer = Tracer()
    traced = runner(tracer)
    rounds, ms = [], []
    with tempfile.TemporaryDirectory() as tmp:
        log_path, trace_path = f"{tmp}/run.jsonl", f"{tmp}/trace.json"
        with RunLog(jsonl=log_path, console=False) as log:
            log.start(config={"m": POOL_M, "k": POOL_K, "bits": 8,
                              "rounds": ROUNDS})
            for t in range(ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                met = traced.round()
                loss = float(met.pop("loss"))
                frac = float(met.pop("active_frac"))
                ms.append((time.perf_counter() - t0) * 1e3)
                rounds.append(dict(met, loss=loss))
                log.round(t, loss, console=False, active_frac=frac,
                          comm_bits=traced.comm_bits, **met)
            log.end(ROUNDS, comm_bits=traced.comm_bits, final_loss=loss,
                    final_consensus_dist=rounds[-1]["consensus_dist"])
        tracer.save(trace_path)
        schema_rc = check_schema.main([log_path])
        text = report.telemetry_report(log_path, trace_path)
        log_lines = sum(1 for _ in open(log_path))
    traced.close()
    print(text, flush=True)
    t0 = time.perf_counter()
    for _ in range(3):
        traced.pool.consensus_distance()
    consensus_ms = (time.perf_counter() - t0) / 3 * 1e3
    spans = tracer.durations()
    n_spans = {}
    for ev in tracer.events:
        if ev["ph"] == "X":
            n_spans[ev["name"]] = n_spans.get(ev["name"], 0) + 1
    step = pool_step_launches()
    extra = telemetry_extra_launches(False, lanes=0)
    nodes_on = graph_nodes(traced.graph)
    nodes_off = graph_nodes(off.graph)
    d = traced.pool.n_params
    rep = {"path": "telemetry pool", "m": POOL_M, "cohort": POOL_K,
           "rounds": ROUNDS,
           "bitwise_with_off": pools_equal(off.pool, traced.pool)
           and pools_equal(off.pool, plain.pool)
           and off_loss == plain_loss == [r["loss"] for r in rounds],
           "round_ms_median": {"off": statistics.median(off_ms[1:]),
                               "on": statistics.median(plain_ms[1:]),
                               "on_traced": statistics.median(ms[1:])},
           "consensus_distance_ms": consensus_ms,
           "span_ms_per_round": {k: v / n_spans[k] * 1e3
                                 for k, v in spans.items()},
           "span_counts": n_spans,
           "pool_breakdown_part_ms": (breakdown or {}).get("part_ms_median"),
           "graph_nodes": {"off": len(nodes_off), "on": len(nodes_on)},
           "extra_nodes": extra_nodes(nodes_on, nodes_off),
           "replay_device_ms": {"off": replay_ms(off.graph),
                                "on": replay_ms(traced.graph)},
           "schema_rc": schema_rc, "log_lines": log_lines,
           "last_round": rounds[-1]}
    rep.update(kernel_nodes_on=check_round_graph(
        "telemetry pool step", nodes_on,
        {k: step[k] + extra[k] for k in step})["kernel_nodes"])
    print(json.dumps(rep), flush=True)
    if not rep["bitwise_with_off"]:
        raise AssertionError("telemetry pool: telemetry changed the pool")
    if schema_rc != 0 or log_lines != ROUNDS + 2:
        raise AssertionError(f"telemetry pool: the run log fails its check "
                             f"(rc {schema_rc}, {log_lines} lines)")
    if set(n_spans) != {"pool/prepare", "pool/step", "pool/writeback",
                        "pool/join", "pool/patch"}:
        raise AssertionError(f"telemetry pool: spans {n_spans}")
    for r in rounds:
        if (r["cohort_size"] != POOL_K
                or r["pool_hit"] + r["pool_miss"] != POOL_K
                or r["wire_bits"] != float(np.float32(
                    message_bits(d, cfg.quant)) * np.float32(
                        r["live_edges"]))
                or not all(math.isfinite(v) for v in r.values()
                           if isinstance(v, float))):
            raise AssertionError(f"telemetry pool: round {r}")
    return rep


def telemetry_overhead(dev) -> dict:
    """``bench.timevarying.telemetry_overhead_compare`` captured and
    eager: the on/off ratios beside the reference's REFERENCE_OVERHEAD,
    and the captured arms' graph nodes and extra nodes by group."""
    from repro_torch.bench.timevarying import telemetry_overhead_compare

    out = {}
    for mode, capture in (("captured", True), ("eager", False)):
        r = telemetry_overhead_compare(device=dev, capture=capture)
        graphs = r.pop("graphs")
        if capture:
            nodes = {k: graph_nodes(g) for k, g in graphs.items()}
            r["graph_nodes"] = {k: len(v) for k, v in nodes.items()}
            r["extra_nodes"] = extra_nodes(nodes["on"], nodes["off"])
            r["replay_device_ms"] = {k: replay_ms(g)
                                     for k, g in graphs.items()}
        out[mode] = r
    print(json.dumps({"path": "telemetry overhead",
                      "reference_gate": REFERENCE_OVERHEAD, **out}),
          flush=True)
    for mode, r in out.items():
        if not (math.isfinite(r["overhead_ratio"])
                and r["overhead_ratio"] > 0):
            raise AssertionError(f"telemetry overhead {mode}: {r}")
    return out


def telemetry_phase(dev, breakdown: dict | None = None
                    ) -> tuple[dict, dict]:
    """Phase "telemetry": the quickstart's rounds with telemetry off and
    on on each of TELEMETRY_SPECS, unfused and fused
    (:func:`telemetry_rounds`), the async decay arm
    (:func:`telemetry_async`), the pool with its tracer and run log
    (:func:`telemetry_pool`), and the overhead ratios
    (:func:`telemetry_overhead`). Returns the summaries and the eager
    telemetry rounds' launches together."""
    data, fed, stacked, _, _, loss_fn, _ = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    setup = (stacked, batches, loss_fn)
    out = {f"{'fused' if fuse else 'unfused'} {kind}":
           telemetry_rounds(dev, kind, fuse, setup)
           for fuse in (False, True) for kind in TELEMETRY_SPECS}
    launches = {k: sum(r["launches_on"][k] for r in out.values())
                for k in KERNEL_SOURCES}
    out["async"] = telemetry_async(dev, setup)
    for k in KERNEL_SOURCES:
        launches[k] += out["async"]["launches"][k]
    out["pool"] = telemetry_pool(dev, breakdown)
    out["overhead"] = telemetry_overhead(dev)
    return out, launches


# ---------------------------------------------------------------------------
# The "production" phase: SmolLM-135M at its registered width through the
# LM driver, its kernels at those shapes, serving, the other registered
# architectures and the driver's other modes.
# ---------------------------------------------------------------------------

PROD_ARCH = "smollm-135m"
# The driver's defaults (m 8, K 4, batch 4, seq 128, eta 3e-2, theta 0.9,
# a static ring at self weight 0.5, lm_round_batches): PROD_ROUNDS rounds
# an arm, the last one profiled, the round time the median of rounds 2
# to PROD_ROUNDS - 1.
PROD_ROUNDS = 5
PROD_ARMS = {"fp32": ["--bits", "32"], "q8": ["--bits", "8"],
             "q8_fused": ["--bits", "8", "--fuse-round"]}
PROD_CAPTURED_ROUNDS = 3
# Serving at the reference serve.py's defaults: batch 4, prompt 32, 16
# tokens, caches of 48.
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16
DECODE_RTOL = 1e-4           # cached decode vs a full forward, reduced f32
PROD_CPU_RTOL = 1e-4         # a reduced arch's round, card vs CPU
PROD_CPU_ARGV = ["--clients", "4", "--local-steps", "2", "--batch", "2",
                 "--seq", "16", "--rounds", "1", "--bits", "8"]
PROD_MODES = {"pool": ["--pool", "--resident-lanes", "4"],
              "async": ["--async-gossip", "--speed-model", "straggler"],
              "partial_exact": ["--schedule", "partial", "--exact-partial",
                                "--bits", "8"],
              "telemetry": ["--telemetry", "--bits", "8"],
              "trace": ["--bits", "8"], "ckpt": ["--ckpt-every", "1"]}
PROD_OUT = ROOT / "chiprun_out" / "production"
# Full-width kernels take milliseconds: fewer repetitions of each timing.
PROD_REPS = dict(reps=5, host_runs=5)
# The profiler mirrors record_function ranges onto the device timeline;
# they are not device work.
RANGE_PREFIXES = ("round/", "wire/", "pool/", "model/")


def production_config(reduced_: bool = False):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    cfg = get_config(PROD_ARCH)
    return dataclasses.replace(reduced(cfg) if reduced_ else cfg,
                               remat=False)


def device_profile(prof) -> dict:
    """The device side of a finished ``torch.profiler`` run, read from the
    raw trace (a full-width round launches ~28 000 kernels, and building
    the profiler's event tree for them takes seconds): busy ms (the union
    of the operations' intervals), operations, device ms by kernel group
    and the top kernels by device ms."""
    groups: dict[str, float] = {}
    by_name: dict[str, float] = {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.name().startswith(RANGE_PREFIXES)):
            continue
        ms = e.duration_ns() / 1e6
        g = _kernel_group(e.name())
        groups[g] = groups.get(g, 0.0) + ms
        key = e.name()[:240]
        by_name[key] = by_name.get(key, 0.0) + ms
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            busy += (end - max(start, reach)) / 1e6
            reach = end
    return {"device_busy_ms": busy, "device_ops": len(spans),
            "top_device_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:16]),
            "device_ms_by_group": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1]))}


class ProfilingTracer:
    """A driver tracer (``telemetry.Tracer``) that runs the profiler over
    one round's ``round/step`` span: its device busy share and device time
    by kernel group."""

    def __init__(self, profile_t: int):
        from repro_torch.telemetry import Tracer
        self.tracer = Tracer(enabled=True)
        self.enabled = True
        self.profile_t = profile_t
        self.profile = None

    def __getattr__(self, name):
        return getattr(self.tracer, name)

    def span(self, name: str, **args):
        import contextlib
        if name != "round/step" or args.get("t") != self.profile_t:
            return self.tracer.span(name, **args)

        @contextlib.contextmanager
        def profiled():
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            # Device activity only (device_profile).
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with self.tracer.span(name, **args):
                    yield
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rec = device_profile(prof)
            self.profile = {"wall_ms": wall_ms, **rec,
                            "device_busy_share":
                                rec["device_busy_ms"] / wall_ms}
        return profiled()

    def step_ms(self) -> list[float]:
        return [ev["dur"] / 1e3 for ev in self.tracer.events
                if ev.get("name") == "round/step"]


def prod_expected(extra: list, rounds: int, K: int) -> dict:
    """B1-B5 launches of ``rounds`` full-width rounds of one arm (every
    SmolLM leaf bf16: B3 one launch a local step)."""
    quant = "--bits" in extra and extra[extra.index("--bits") + 1] != "32"
    fused = "--fuse-round" in extra
    exp = {k: 0 for k in ("quantize_pack_buffer", "dequant_mix_buffer",
                          "momentum_sgd", "momentum_quantize_pack_buffer",
                          "dequant_mix_momentum_buffer")}
    exp["momentum_sgd"] = rounds * (K - 2 if fused else K)
    if quant and fused:
        exp["momentum_quantize_pack_buffer"] = rounds
        exp["dequant_mix_momentum_buffer"] = rounds
    elif quant:
        exp["quantize_pack_buffer"] = exp["dequant_mix_buffer"] = rounds
    return exp


def production_arm(dev, name: str, extra: list) -> tuple[dict, object]:
    """One arm at full width through ``launch.train.run_resident`` with
    the unreduced config: round ms (eager, median of rounds 2 to
    PROD_ROUNDS - 1), the last round profiled, exact launch counts, every
    round's loss, the consensus distance and the memory peak. Returns
    (record, final state)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as TT
    from repro_torch.telemetry import RunLog

    cfg = production_config()
    args = TT.build_parser().parse_args(
        ["--rounds", str(PROD_ROUNDS), "--device", str(dev)] + extra)
    PROD_OUT.mkdir(parents=True, exist_ok=True)
    path = PROD_OUT / f"{name}.jsonl"
    log = RunLog(jsonl=str(path), console=False)
    tracer = ProfilingTracer(PROD_ROUNDS - 1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state, metrics = TT.run_resident(args, cfg, log, tracer)
        torch.cuda.synchronize()
    finally:
        log.close()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    expect = prod_expected(extra, PROD_ROUNDS, args.local_steps)
    got = {k: counts[k] for k in expect}
    if got != expect:
        raise AssertionError(f"production {name}: launches {got}, "
                             f"expected {expect}")
    rounds = [json.loads(line) for line in path.read_text().splitlines()
              if '"round"' in line]
    losses = [r["loss"] for r in rounds if r.get("kind") == "round"]
    cdist = float(metrics["consensus_dist"])
    if len(losses) != PROD_ROUNDS or not all(
            math.isfinite(v) for v in losses + [cdist]):
        raise AssertionError(f"production {name}: losses {losses}, "
                             f"consensus {cdist}")
    for n, t in state.params.items():
        if t.dtype != torch.bfloat16 or not torch.isfinite(t).all():
            raise AssertionError(f"production {name}: leaf {n} is "
                                 f"{t.dtype} or not finite")
    steps = tracer.step_ms()
    rec = {"arm": name, "argv": extra, "m": args.clients,
           "K": args.local_steps, "batch": args.batch, "seq": args.seq,
           "round_ms_median": statistics.median(steps[1:-1]),
           "round_ms": steps, "profiled_round": tracer.profile,
           "launches": got, "loss": losses, "consensus_dist": cdist,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "arm_s": seconds}
    print(json.dumps({"production_arm": rec}), flush=True)
    return rec, state


def production_attention(dev, reps: int = 20) -> dict:
    """Attention's device time in a full-width round: one layer's
    streaming attention (``models.attention.attend``) forward and
    backward at the round's shapes (8 clients x batch 4 folded, 128
    tokens, 9 heads over 3 KV heads, head_dim 64, bf16) captured in a CUDA
    graph. ``reps`` replays back to back, timed by CUDA events, give its
    device ms with no host gaps; ``reps`` more under the profiler give
    its kernel ms by group. A round runs it 30 layers x 4 local steps
    times."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.attention import attend

    cfg = production_config()
    calls = cfg.n_layers * 4
    gen = torch.Generator(device=dev).manual_seed(29)
    b, length, hd = 32, 128, cfg.head_dim
    q, k, v = (torch.randn((b, length, n, hd), device=dev, generator=gen,
                           dtype=torch.bfloat16).requires_grad_(True)
               for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    pos = torch.arange(length, dtype=torch.int32, device=dev)
    grad = torch.randn((b, length, cfg.n_heads, hd), device=dev,
                       generator=gen, dtype=torch.bfloat16)

    def once():
        out = attend(q, k, v, pos, pos, causal=True)
        return torch.autograd.grad(out, (q, k, v), grad)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            once()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        once()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    layer_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    p = device_profile(prof)
    rec = {"layer_fwd_bwd_ms": layer_ms, "calls_a_round": calls,
           "round_ms": layer_ms * calls,
           "layer_device_ms_by_group": {
               g: ms / reps for g, ms in p["device_ms_by_group"].items()},
           "layer_device_ops": p["device_ops"] / reps}
    print(json.dumps({"production_attention": rec}), flush=True)
    del graph
    return rec


def production_breakdown(captured: dict, attention: dict) -> dict:
    """Where a captured full-width round's device time goes: the profiled
    replay's kernel ms split into attention (its captured layer's kernel
    ms by group, times its calls a round), the other matmuls, our kernels
    and the rest. The four add up to the replay's kernel ms; the replay's
    ms beyond its busy ms is the device idle inside the graph."""
    groups = captured["replay_profile"]["device_ms_by_group"]
    layer = attention["layer_device_ms_by_group"]
    calls = attention["calls_a_round"]
    att_mm = calls * layer.get("matmul", 0.0)
    att_rest = calls * sum(ms for g, ms in layer.items() if g != "matmul")
    ours = {g: ms for g, ms in groups.items() if g in KERNEL_SOURCES}
    rest = sum(ms for g, ms in groups.items()
               if g not in ours and g != "matmul")
    rec = {"attention_ms": att_mm + att_rest,
           "attention_matmul_ms": att_mm,
           "matmul_ms": groups.get("matmul", 0.0) - att_mm,
           "ours_ms": sum(ours.values()), "ours": ours,
           "other_ms": rest - att_rest,
           "kernel_ms": sum(groups.values()),
           "busy_ms": captured["replay_profile"]["device_busy_ms"],
           "replay_ms": captured["replay_profile"]["wall_ms"]}
    print(json.dumps({"production_breakdown": rec}), flush=True)
    return rec


def production_captured(dev) -> dict:
    """Full-width rounds at 8 bits, unfused: PROD_CAPTURED_ROUNDS eager
    rounds of the driver's step (``core.make_round_step`` on the model's
    loss, built as ``run_resident`` builds it) against as many replays
    of its CUDA graph (``capture_step``). Not gated bitwise: the backward
    of the loss's target gather and of the embedding run through
    scatter-adds; the largest difference of any leaf is reported."""
    from repro_torch import prng
    from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                                  capture_step, init_round_state,
                                  make_round_step)
    from repro_torch.data.synthetic import lm_round_batches
    from repro_torch.models import model as M

    cfg = production_config()
    m, K, b, seq = 8, 4, 4, 128
    key = prng.PRNGKey(0, device=dev)
    k_init, k_state, k_data = prng.split(key, 3)
    p = M.init_model(k_init, cfg, device=dev)
    stacked = {n: t.unsqueeze(0).expand((m,) + tuple(t.shape)).contiguous()
               for n, t in p.items()}
    del p
    step = make_round_step(lambda p_, b_, r: M.loss_fn(p_, cfg, b_, r),
                           DFedAvgMConfig(eta=3e-2, theta=0.9,
                                          local_steps=K,
                                          quant=QuantConfig(bits=8)),
                           MixingSpec.ring(m, self_weight=0.5), device=dev)
    batches = [lm_round_batches(k_data, t, m=m, K=K, batch=b, seq=seq,
                                vocab=cfg.vocab_size)
               for t in range(PROD_CAPTURED_ROUNDS)]
    s_eager = init_round_state(stacked, k_state)
    eager_ms, losses = [], []
    for bt in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_eager, met = step(s_eager, bt)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    eager_params = s_eager.params
    del s_eager
    gc.collect()
    torch.cuda.empty_cache()
    state = init_round_state(stacked, k_state)
    run = capture_step(step, state, batches[0])
    replay_ms, cap_losses = [], []
    for bt in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = run(state, bt)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        cap_losses.append(float(met["loss"]))
    diff = max(float((state.params[n].float() - eager_params[n].float())
                     .abs().max()) for n in eager_params)
    if not all(math.isfinite(v) for v in cap_losses):
        raise AssertionError(f"captured full width: losses {cap_losses}")
    # One more replay under the profiler: the round's device ms by group.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = run(state, batches[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_rec = {"wall_ms": wall_ms, **device_profile(prof)}
    rec = {"rounds": PROD_CAPTURED_ROUNDS, "eager_ms": eager_ms,
           "replay_ms": replay_ms, "eager_loss": losses,
           "captured_loss": cap_losses, "max_abs_diff_vs_eager": diff,
           "bitwise": diff == 0.0, "replay_profile": prof_rec,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    print(json.dumps({"production_captured": rec}), flush=True)
    del run, state, eager_params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def production_kernel_checks(dev, flush, state) -> dict:
    """B1, B2 and B3 (f32 and bf16) at the full-width shapes of the 8-bit
    arm: the wire layout of the final state's bf16 leaves (m 8), its
    planar delta and scales, the per-leaf keys of a mixing key, the ring
    plan's streams. Each kernel bitwise against its plain version (B1 and
    B2 lane by lane, B3 leaf by leaf) and timed. Returns the rows'
    records."""
    from repro_torch import prng
    from repro_torch.core import MixingSpec, QuantConfig, WireLayout
    from repro_torch.core.mixing import _plan_tables, _quant_leaf_keys
    from repro_torch.kernels import momentum_update, ref
    from repro_torch.kernels.dequant_mix import dequant_mix_buffer
    from repro_torch.kernels.momentum_sgd import momentum_sgd_lanes_ref
    from repro_torch.kernels.quantize_pack import quantize_pack_buffer

    quant = QuantConfig(bits=8)
    bits = quant.bits
    x = state.params
    m = next(iter(x.values())).shape[0]
    gen = torch.Generator(device=dev).manual_seed(23)
    layout = WireLayout.for_tree(x, bits, stacked=True)
    X = layout.to_planar_stacked(x)
    z = {n: (t.float() + 1e-3 * torch.randn(t.shape, device=dev,
                                            generator=gen)).to(t.dtype)
         for n, t in x.items()}
    delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
    del z
    sblk = layout.block_scales(layout.leaf_scales(delta, quant))
    keys = _quant_leaf_keys(prng.PRNGKey(5, device=dev), layout.n_leaves, m)
    table = layout.noise_table
    words = quantize_pack_buffer(delta, sblk, bits, keys=keys, table=table)
    # The plain version lane by lane (its noise for all lanes at once
    # would take tens of GB): each lane's words of the one launch over
    # all lanes, its key rows and its offsets into the buffer.
    for c in range(m):
        want = ref.quantize_pack_buffer_ref(
            delta[c:c + 1], sblk[c:c + 1], bits,
            layout.noise_stacked(keys[:, c:c + 1].contiguous()))
        check_words(f"B1 full width lane {c}", words[c:c + 1], want)
        del want
    r1 = {"shape": f"x f32 {list(delta.shape)}, keys {list(keys.shape)}",
          "checks": [f"full width: x f32 {list(delta.shape)}: every lane "
                     "of the launch over all lanes bitwise with the "
                     "plain version"]}
    timed(r1, "", lambda: quantize_pack_buffer(delta, sblk, bits, keys=keys,
                                               table=table), flush,
          **PROD_REPS)
    r1["sass"] = keyed_ops("quantize_pack_buffer", bits,
                           delta.shape[0] * delta.shape[2] // 4,
                           sum(layout.sizes) * m)
    r1["bound_ms"], r1["bound_by"] = bound(nbytes(delta, sblk, keys, words),
                                           0, r1["sass"]["ms"])
    del delta
    gc.collect()

    src, w = _plan_tables(MixingSpec.ring(m, self_weight=0.5).gossip_plan(),
                          dev)
    out = dequant_mix_buffer(X, words, sblk, w, src, bits)
    for c in range(m):
        s = src[:, c].long()
        want = ref.dequant_mix_buffer_ref(X[c], words[s], sblk[s], w[c],
                                          bits)
        check_words(f"B2 full width lane {c}", out[c].view(torch.int32),
                    want.view(torch.int32))
    del want
    r2 = {"shape": f"base {list(X.shape)}, K {src.shape[0]}",
          "checks": [f"full width: base {list(X.shape)}, K "
                     f"{src.shape[0]}: every lane bitwise"]}
    timed(r2, "", lambda: dequant_mix_buffer(X, words, sblk, w, src, bits),
          flush, **PROD_REPS)
    r2["bound_ms"], r2["bound_by"] = bound(
        nbytes(X, words, sblk, w, src, out), X.numel() * 3 * src.shape[0])
    del X, out, words
    gc.collect()
    torch.cuda.empty_cache()

    rows = {"quantize_pack_buffer": r1, "dequant_mix_buffer": r2}
    for dtype, name in ((torch.bfloat16, "momentum_sgd_bf16"),
                        (torch.float32, "momentum_sgd_f32")):
        y = {n: t.to(dtype) for n, t in x.items()}
        v = {n: (0.01 * torch.randn(t.shape, device=dev, generator=gen))
             .to(dtype) for n, t in x.items()}
        g = {n: (0.1 * torch.randn(t.shape, device=dev, generator=gen))
             .to(dtype) for n, t in x.items()}
        ys, vs = momentum_update(y, v, g, 3e-2, 0.9)
        for n in y:
            wy, wv = ref.momentum_sgd_ref(y[n], v[n], g[n], 3e-2, 0.9)
            check_words(f"B3 {name} {n}", ys[n].view(torch.int16),
                        wy.view(torch.int16))
            check_words(f"B3 {name} {n} v", vs[n].view(torch.int16),
                        wv.view(torch.int16))
        del ys, vs, wy, wv
        n_el = sum(t.numel() for t in y.values())
        size = torch.empty((), dtype=dtype).element_size()
        r = {"shape": f"one local step: {len(y)} leaves x {m} clients "
                      f"({n_el} {str(dtype)[6:]})",
             "checks": [f"full width, {len(y)} {str(dtype)[6:]} leaves x "
                        f"{m} clients: bitwise"]}
        timed(r, "", lambda: momentum_update(y, v, g, 3e-2, 0.9), flush,
              **PROD_REPS)
        timed(r, "plain_", lambda: [ref.momentum_sgd_ref(
            y[n], v[n], g[n], 3e-2, 0.9) for n in y], flush, **PROD_REPS)
        r["bound_ms"], r["bound_by"] = bound(5 * size * n_el, 3 * n_el)
        r["max_abs_err"], r["max_ulp"] = 0.0, 0
        # The library's multi-tensor SGD step over the same leaves (in
        # place, buf' = theta*buf + g; p' = p - eta*buf'): timed only.
        params = [t.clone() for t in y.values()]
        bufs = [t.clone() for t in v.values()]
        timed(r, "library_", lambda: torch._fused_sgd_(
            params, list(g.values()), bufs, weight_decay=0.0,
            momentum=0.9, lr=3e-2, dampening=0.0, nesterov=False,
            maximize=False, is_first_step=False), flush, **PROD_REPS)
        del params, bufs
        rows[name] = r
        del y, v, g
        gc.collect()
        torch.cuda.empty_cache()
    # B3's lane entry on the bf16 leaves (an eta a client), and a table
    # mixing bf16 and f32 leaves: one launch a dtype.
    from repro_torch.kernels import launch_counts
    y = dict(x)
    v = {n: (0.01 * torch.randn(t.shape, device=dev, generator=gen))
         .to(t.dtype) for n, t in x.items()}
    g = {n: (0.1 * torch.randn(t.shape, device=dev, generator=gen))
         .to(t.dtype) for n, t in x.items()}
    eta = torch.linspace(0.01, 0.05, m, device=dev)
    ys, vs = momentum_update(y, v, g, eta, 0.9)
    for n in y:
        wy, wv = momentum_sgd_lanes_ref(y[n], v[n], g[n], eta, 0.9)
        check_words(f"B3 lanes bf16 {n}", ys[n].view(torch.int16),
                    wy.view(torch.int16))
        check_words(f"B3 lanes bf16 {n} v", vs[n].view(torch.int16),
                    wv.view(torch.int16))
    del ys, vs
    mixed = {"a_f32": torch.randn(m, 1031, device=dev, generator=gen),
             **{n: t for n, t in list(x.items())[:3]}}
    mv = {n: 0.01 * torch.randn(t.shape, device=dev, generator=gen)
          .to(t.dtype) for n, t in mixed.items()}
    mg = {n: 0.1 * torch.randn(t.shape, device=dev, generator=gen)
          .to(t.dtype) for n, t in mixed.items()}
    before = launch_counts()["momentum_sgd"]
    ys, vs = momentum_update(mixed, mv, mg, 3e-2, 0.9)
    torch.cuda.synchronize()
    if launch_counts()["momentum_sgd"] - before != 2:
        raise AssertionError("B3 on a mixed f32/bf16 table: "
                             f"{launch_counts()['momentum_sgd'] - before} "
                             "launches, expected 2")
    for n in mixed:
        wy, wv = ref.momentum_sgd_ref(mixed[n], mv[n], mg[n], 3e-2, 0.9)
        if not (torch.equal(ys[n], wy) and torch.equal(vs[n], wv)
                and ys[n].dtype == mixed[n].dtype):
            raise AssertionError(f"B3 mixed table: leaf {n}")
    rows["momentum_sgd_bf16"]["checks"] += [
        f"lane entry (eta [{m}]) on the {len(y)} bf16 leaves: bitwise",
        "a table of 1 f32 and 3 bf16 leaves: 2 launches, bitwise"]
    del y, v, g, ys, vs, mixed, mv, mg
    print(json.dumps({"production_kernels": {
        k: {f: r[f] for f in ("shape", "ms", "clean_ms", "call_ms",
                              "host_ms", "bound_ms", "bound_by") + (
            ("plain_ms", "library_ms") if "plain_ms" in r else ())}
        for k, r in rows.items()}}), flush=True)
    return rows


def production_serve(dev, params) -> dict:
    """``serve.greedy_generate`` on the consensus model at the reference
    serve.py's defaults: prefill ms, decode ms a token, tokens a second.
    Then the reduced SmolLM in f32 on the card: the cached decode's logits
    against a full no-cache forward of the same tokens."""
    from repro_torch import prng
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import model as M

    cfg = production_config()
    prompts = prng.randint(prng.PRNGKey(1, device=dev),
                           (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
    s_alloc = SERVE_PROMPT + SERVE_GEN
    greedy_generate(params, cfg, prompts, gen=2, s_alloc=s_alloc)  # warm
    torch.cuda.synchronize()
    with torch.no_grad():
        t0 = time.perf_counter()
        caches = M.init_decode_caches(cfg, SERVE_BATCH, s_alloc, device=dev)
        M.prefill(params, cfg, prompts, caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompts, gen=SERVE_GEN,
                           s_alloc=s_alloc)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serving: tokens {tuple(toks.shape)}")
    rcfg = production_config(reduced_=True)
    rp = M.init_model(prng.PRNGKey(4), rcfg, device=dev)
    tok = prng.randint(prng.PRNGKey(6, device=dev), (2, 24), 0,
                       rcfg.vocab_size)
    worst = 0.0
    with torch.no_grad():
        full, _, _ = M.forward(rp, rcfg, tok)
        caches = M.init_decode_caches(rcfg, 2, 24, device=dev)
        last, caches = M.prefill(rp, rcfg, tok[:, :16], caches)
        pairs = [(last, full[:, 15])]
        for i in range(16, 24):
            step, caches = M.decode_step(rp, rcfg, tok[:, i],
                                         torch.tensor(i, device=dev),
                                         caches)
            pairs.append((step, full[:, i]))
        for a, b in pairs:
            worst = max(worst, float((a - b).abs().max()
                                     / b.abs().max()))
    if not worst <= DECODE_RTOL:
        raise AssertionError(f"reduced decode vs forward: {worst}")
    rec = {"batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
           "prefill_ms": prefill_ms,
           "decode_ms_per_token": (total_ms - prefill_ms) / (SERVE_GEN - 1),
           "total_ms": total_ms,
           "tok_per_s": SERVE_BATCH * SERVE_GEN / total_ms * 1e3,
           "sample": toks[0, :8].tolist(),
           "reduced_decode_vs_forward_rel": worst}
    print(json.dumps({"production_serve": rec}), flush=True)
    return rec


def prod_cpu_archs(path: str) -> None:
    """The CPU side of :func:`production_archs`, run in a process of its
    own (``chip_smoke.py --prod-cpu-archs PATH``) while the card works:
    each arch's round on the CPU, (loss, consensus) written to PATH."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import train as TT

    torch.set_num_threads(4)
    out = {}
    for arch in list_archs():
        if arch != PROD_ARCH:
            _, met = TT.main(["--arch", arch, "--device", "cpu"]
                             + PROD_CPU_ARGV)
            out[arch] = (float(met["loss"]), float(met["consensus_dist"]))
    Path(path).write_text(json.dumps(out))


def start_cpu_archs() -> tuple[subprocess.Popen, Path]:
    PROD_OUT.mkdir(parents=True, exist_ok=True)
    path = PROD_OUT / "cpu_archs.json"
    path.unlink(missing_ok=True)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--prod-cpu-archs", str(path)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, path


def production_archs(dev, cpu=None) -> dict:
    """Every other registered arch, reduced, f32: one driver round at 8
    bits on the card against the same run on the CPU (loss and consensus
    within PROD_CPU_RTOL, TF32 off; the CPU runs in a process of its own,
    ``cpu`` = :func:`start_cpu_archs`), and ``greedy_generate`` of 4
    tokens, in the vocabulary."""
    from repro_torch import prng
    from repro_torch.configs import get_config, list_archs, reduced
    from repro_torch.launch import train as TT
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import model as M
    from repro_torch.models.frontends import stub_frontend_embeddings

    proc, path = cpu if cpu is not None else start_cpu_archs()
    out = {}
    try:
        for arch in list_archs():
            if arch == PROD_ARCH:
                continue
            t0 = time.perf_counter()
            _, met = TT.main(["--arch", arch, "--device", str(dev)]
                             + PROD_CPU_ARGV)
            card = (float(met["loss"]), float(met["consensus_dist"]))
            cfg = reduced(get_config(arch))
            p = M.init_model(prng.PRNGKey(0), cfg, device=dev)
            cross = None
            if cfg.frontend is not None:
                cross = M.cross_states(p, cfg, stub_frontend_embeddings(
                    cfg, 2, device=dev))
            prompts = prng.randint(prng.PRNGKey(1, device=dev), (2, 8), 0,
                                   cfg.vocab_size)
            toks = greedy_generate(p, cfg, prompts, gen=4, s_alloc=12,
                                   cross_states=cross)
            if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"{arch}: tokens {toks.tolist()}")
            out[arch] = {"card": card, "tokens": toks[0].tolist(),
                         "card_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the CPU runs failed:\n{err[-3000:]}")
    cpu_runs = json.loads(path.read_text())
    for arch, rec in out.items():
        rec["cpu"] = c = tuple(cpu_runs[arch])
        d = rec["card"]
        rec["rel"] = {"loss": abs(d[0] - c[0]) / abs(c[0]),
                      "consensus_dist": abs(d[1] - c[1]) / abs(c[1])}
        if not all(math.isfinite(v) for v in d) or max(
                rec["rel"].values()) > PROD_CPU_RTOL:
            raise AssertionError(f"{arch}: card {d}, cpu {c}")
    print(json.dumps({"production_archs": out,
                      "cpu_wait_s": time.perf_counter() - t0}), flush=True)
    return out


def production_modes(dev) -> dict:
    """The driver's other modes on the reduced SmolLM, PROD_MODES, 3
    rounds each: every JSONL log passes ``check_schema``; the trace and
    the checkpoints are written."""
    from repro_torch.launch import train as TT
    from repro_torch.telemetry.check_schema import check_file

    out = {}
    PROD_OUT.mkdir(parents=True, exist_ok=True)
    for name, extra in PROD_MODES.items():
        log = PROD_OUT / f"mode_{name}.jsonl"
        argv = ["--clients", "8", "--local-steps", "2", "--batch", "2",
                "--seq", "32", "--rounds", "3", "--device", str(dev),
                "--log-jsonl", str(log)] + extra
        if name == "trace":
            argv += ["--trace", str(PROD_OUT / "trace.json")]
        if name == "ckpt":
            argv += ["--ckpt-dir", str(PROD_OUT / "ckpt")]
        t0 = time.perf_counter()
        _, met = TT.main(argv)
        problems = check_file(log)
        if problems or not math.isfinite(float(met["loss"])):
            raise AssertionError(f"mode {name}: {problems[:3]}, loss "
                                 f"{met['loss']}")
        out[name] = {"loss": float(met["loss"]),
                     "s": time.perf_counter() - t0}
    steps = sorted(p.name for p in (PROD_OUT / "ckpt").iterdir())
    if not (PROD_OUT / "trace.json").exists() or not steps:
        raise AssertionError("the trace or the checkpoints are missing")
    out["ckpt"]["steps"] = steps
    shutil.rmtree(PROD_OUT / "ckpt")      # tens of MB: not brought back
    print(json.dumps({"production_modes": out}), flush=True)
    return out


def production_phase(dev, flush=None) -> dict:
    """Phase "production": SmolLM-135M at its registered width (30 layers,
    d 576, 9 heads / 3 KV heads, d_ff 1536, vocab 49 152, tied, bf16)
    through the LM driver's ``run_resident`` in PROD_ARMS (fp32 wire:
    the plan realization's f32 gathers and B3 bf16; 8 bits unfused: B1,
    B2, B3; fused: B4, B5, B3) with exact launch counts; B1, B2 and B3
    (bf16 and f32) at those shapes against their plain versions, timed;
    captured full-width rounds; serving the consensus; the other archs
    reduced against the CPU; the driver's other modes. A failure kills the
    CPU side's process, which runs from the captured rounds on (before
    them its threads would slow the eager arms). bf16 products may
    reduce in reduced precision in cuBLAS
    (``allow_bf16_reduced_precision_reduction`` stays at torch's default,
    printed)."""
    from repro_torch.core import average_params
    if flush is None:
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    cpu = None
    try:
        info = {"bf16_reduced_precision_reduction": torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction,
                "tf32": torch.backends.cuda.matmul.allow_tf32}
        arms, state, parts = {}, None, {}
        for name, extra in PROD_ARMS.items():
            arms[name], st = production_arm(dev, name, extra)
            if name == "q8":
                state = st
            del st
            gc.collect()
            torch.cuda.empty_cache()
        parts["arms"] = time.perf_counter() - t0
        serve = production_serve(dev, average_params(state.params))
        attention = production_attention(dev)
        parts["serve"] = time.perf_counter() - t0
        # The CPU side of the archs' check runs beside the card's work from
        # here on (its host threads would slow the eager arms and serving).
        cpu = start_cpu_archs()
        kernels = production_kernel_checks(dev, flush, state)
        parts["kernels"] = time.perf_counter() - t0
        del state
        gc.collect()
        torch.cuda.empty_cache()
        captured = production_captured(dev)
        captured["attention"] = attention
        captured["breakdown"] = production_breakdown(captured, attention)
        parts["captured"] = time.perf_counter() - t0
        archs = production_archs(dev, cpu)
        parts["archs"] = time.perf_counter() - t0
        modes = production_modes(dev)
        parts["modes"] = time.perf_counter() - t0
    finally:
        if cpu is not None and cpu[0].poll() is None:   # a failure before
            cpu[0].kill()
            cpu[0].wait()
    rec = {"info": info, "arms": arms, "kernels": kernels,
           "serve": serve, "captured": captured, "archs": archs,
           "modes": modes, "phase_s": time.perf_counter() - t0,
           "parts_s": parts}
    print(json.dumps({"production": {
        "phase_s": rec["phase_s"], "s_at_end_of": parts, **info,
        "round_ms_median": {k: v["round_ms_median"] for k, v in arms.items()},
        "device_busy_share": {k: v["profiled_round"]["device_busy_share"]
                              for k, v in arms.items()},
        "peak_gib": {k: v["peak_gib"] for k, v in arms.items()}}}),
        flush=True)
    return rec


# The "mesh" phase: the 1D client mesh on one card, its shards sharing
# cuda:0 (``launch.mesh.make_test_mesh``): every transfer is a device copy
# on the card, not NVLink or network traffic.
MESH_SHARDS = 4
MESH_PLACED = dict(m=64, p=0.06, seed=2, shards=8, rounds=4)
MESH_DRIVER_ROUNDS = 2
MESH_DRIVER_ARGV = ["--bits", "8", "--clients", "8",
                    "--clients-per-shard", "2"]


def lanes_of(params) -> dict:
    """A state's parameters as one stacked dict (a mesh's shards joined
    in lane order on the first shard's device, ``join_lanes``)."""
    from repro_torch.core import join_lanes
    if isinstance(params, dict):
        return params
    return join_lanes(params, next(iter(params[0].values())).device)


def sync_all() -> None:
    """Wait for every card (a mesh over several cards runs on all)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_expected(fuse_round: bool, shards: int = MESH_SHARDS,
                  rounds: int = 1) -> dict:
    """Launches of ``rounds`` quickstart rounds on a mesh of ``shards``:
    B1 and B2 (fused: B4 and B5) once a shard, B3 once a local step a
    shard; T1 for the round and client keys, the quantizer's per-leaf
    keys, and the per-step split once a shard unfused (``local_train``
    splits its shard's keys), once for all lanes fused."""
    e = {k: 0 for k in KERNEL_SOURCES}
    if fuse_round:
        e.update(momentum_quantize_pack_buffer=shards,
                 dequant_mix_momentum_buffer=shards,
                 momentum_sgd=(K - 2) * shards, threefry_split=4)
    else:
        e.update(quantize_pack_buffer=shards, dequant_mix_buffer=shards,
                 momentum_sgd=K * shards, threefry_split=3 + shards)
    return {k: v * rounds for k, v in e.items()}


def mesh_mixer_gate(dev, mesh, setup, batch, fuse_round: bool) -> dict:
    """The sharded mixer (fused: the sharded fused tail at eta 0, whose
    output does not read the last gradient) fed the one-device round's x
    and z from one round of training: bitwise the one-device mixer's x'."""
    from repro_torch import prng
    from repro_torch.core import (MixerConfig, local_train, make_fused_tail,
                                  make_mixer, split_lanes)
    from repro_torch.core.local_sgd import local_train_deferred
    data, fed, stacked, spec, cfg, loss_fn, _ = setup
    x = {n: t + 0.01 * torch.randn_like(t) for n, t in stacked.items()}
    key_round, key_mix, _ = prng.split(prng.PRNGKey(3, device=dev), 3)
    keys = prng.split(key_round, M)
    if not fuse_round:
        z, _ = local_train(loss_fn, x, batch, keys, eta=ETA, theta=THETA)
        mcfg = MixerConfig(quant=cfg.quant)
        want = make_mixer(spec, mcfg, device=dev)(x, z, key_mix)
        mixer = make_mixer(spec, mcfg, mesh=mesh)
        got = lanes_of(mixer(mesh.shard(x), mesh.shard(z), key_mix))
        tables = mixer.tables
    else:
        step_keys = prng.split(keys, K)
        y, v, g, _ = local_train_deferred(loss_fn, x, batch, step_keys,
                                          eta=ETA, theta=THETA)
        bl = {n: b[:, K - 1] for n, b in batch.items()}
        kl = step_keys[:, K - 1]
        kw = dict(eta=0.0, theta=THETA, quant=cfg.quant,
                  plan=spec.gossip_plan(), W=spec.W)
        want = make_fused_tail(loss_fn, M, device=dev, **kw)(
            x, y, v, g, bl, kl, key_mix)[0]
        tail = make_fused_tail(loss_fn, M, mesh=mesh, **kw)
        got = lanes_of(tail(*(mesh.shard(t) for t in (x, y, v, g)),
                            mesh.shard(bl),
                            split_lanes(kl, list(mesh.devices)),
                            key_mix)[0])
        tables = tail.tables
    ulp = max(ulp_diff(got[n], want[n]) for n in want)
    if ulp:
        raise AssertionError(f"mesh mixer {'fused' if fuse_round else ''}: "
                             f"{ulp} ulp from the one-device mixer")
    return {"bitwise": True, "tables": tables}


def mesh_boundary(tables, layout_of, quant, spec) -> dict:
    """A round's boundary transfers against ``comm_cost``'s block bill
    (lemma5 replicas counted). ``shipped_bytes``, the bytes of the
    payloads the round's exchange sent (counted from the payloads), must
    be exactly the bill's lane slots times the reference's stream of a
    lane: the words (4 W bytes), the per-leaf scales (4 n_leaves) and,
    for lemma5, the f32 replica row (4 per W); the lanes moved must be
    the bill's lane slots. The ratio to the bill's bytes (which count d
    parameters, not W padded words) is printed."""
    from repro_torch.core import WireLayout, plan_round_bits
    from repro_torch.core.quantize import message_bits
    layout = WireLayout.for_tree(layout_of, quant.bits, stacked=True)
    d = int(sum(layout.sizes))
    bill_bits = plan_round_bits(spec.gossip_plan(), d, quant, True,
                                clients_per_shard=M // MESH_SHARDS)
    per_edge = message_bits(d, quant) + 32 * d
    slots = bill_bits / per_edge
    stream = 4 * (layout.total_words + layout.n_leaves
                  + (layout.per * layout.total_words
                     if quant.delta_mode == "lemma5" else 0))
    rec = {"lanes_moved": tables.lanes_moved, "bill_lane_slots": slots,
           "shipped_bytes": tables.shipped_bytes,
           "expected_bytes": slots * stream, "stream_bytes_a_lane": stream,
           "bill_bytes": bill_bits / 8, "copies": len(tables.transfers)}
    rec["shipped_over_bill"] = rec["shipped_bytes"] / rec["bill_bytes"]
    if (rec["lanes_moved"] != slots
            or rec["shipped_bytes"] != rec["expected_bytes"]):
        raise AssertionError(f"mesh boundary: {rec}")
    return rec


def mesh_rounds(dev, fuse_round: bool, mesh=None) -> dict:
    """The quickstart (2NN 784-200-200-10, m 16, ring 0.5, K 4, batch 32,
    8-bit stochastic lemma5) on MESH_SHARDS shards of cuda:0 (or on
    ``mesh``, one card a shard) against the one-device plan realization:
    the mixer gate, ROUNDS eager rounds of each in turns (exact launches
    of the mesh arm; bitwise, else the first round and leaf apart and
    whether local SGD alone parts), then, on a mesh that shares a card,
    ROUNDS captured rounds of each in turns (the mesh's graph: one
    round's kernel nodes, no host copy; captured bitwise with eager;
    over several cards ``capture_step`` must refuse), round ms, graph
    nodes and replay ms of both, and the boundary bill."""
    from repro_torch import prng
    from repro_torch.core import (capture_step, init_round_state,
                                  local_train, make_round_step, split_lanes)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh

    name = "fused" if fuse_round else "unfused"
    if mesh is None:
        mesh = make_test_mesh(MESH_SHARDS, dev)
    else:
        name += f" on {mesh.n_shards} cards"
    setup = quickstart_setup(dev, fuse_round)
    data, fed, stacked, spec, cfg, loss_fn, one = setup
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    gate = mesh_mixer_gate(dev, mesh, setup, batches[0], fuse_round)
    boundary = mesh_boundary(gate.pop("tables"), stacked, cfg.quant, spec)

    def make_mesh_step():
        return make_round_step(loss_fn, cfg, spec, mesh=mesh)

    sharded = make_mesh_step()
    s0 = init_round_state(stacked, prng.PRNGKey(1))
    m0 = init_round_state(stacked, prng.PRNGKey(1), mesh=mesh)
    states = {"one": s0, "mesh": m0}
    steps = {"one": one, "mesh": sharded}
    ms = {k: [] for k in ("one", "mesh", "one_captured", "mesh_captured")}
    losses, apart, counts = [], None, None
    total = {k: 0 for k in KERNEL_SOURCES}
    for t, b in enumerate(batches):
        for arm in ("one", "mesh"):
            sync_all()
            reset_launch_counts()
            t0 = time.perf_counter()
            states[arm], met = steps[arm](states[arm], b)
            sync_all()
            ms[arm].append((time.perf_counter() - t0) * 1e3)
            if arm == "mesh":
                counts = launch_counts()
                total = {k: total[k] + counts[k] for k in total}
                losses.append(float(met["loss"]))
        got, want = lanes_of(states["mesh"].params), states["one"].params
        diff = {n: ulp_diff(got[n], want[n]) for n in want}
        if apart is None and any(diff.values()):
            apart = {"round": t, "leaf": next(n for n in diff if diff[n]),
                     "ulp": diff}
    expect = mesh_expected(fuse_round, rounds=ROUNDS)
    if total != expect:
        raise AssertionError(f"mesh {name}: launches {total} != {expect}")
    local_equal = None
    if apart is not None:
        # Does local SGD alone part at the shard's batch count?
        keys = prng.split(prng.PRNGKey(5, device=dev), M)
        z1, _ = local_train(loss_fn, stacked, batches[0], keys, eta=ETA,
                            theta=THETA)
        devs = [dev] * MESH_SHARDS
        z4 = [local_train(loss_fn, x, b, k, eta=ETA, theta=THETA)[0]
              for x, b, k in zip(split_lanes(stacked, devs),
                                 split_lanes(batches[0], devs),
                                 split_lanes(keys, devs))]
        local_equal = all(torch.equal(lanes_of(z4)[n], z1[n]) for n in z1)
        rel = max(float(((got[n] - want[n]).abs()
                         / want[n].abs().clamp_min(1e-30)).max())
                  for n in want)
        if local_equal or rel > 1e-5:
            raise AssertionError(f"mesh {name}: rounds part from the "
                                 f"one-device rounds at {apart}, local SGD "
                                 f"bitwise: {local_equal}, rel {rel}")
    rec = {"path": f"mesh {name}", "shards": mesh.n_shards,
           "rounds": ROUNDS, "mixer_bitwise": gate["bitwise"],
           "rounds_bitwise": apart is None, "first_apart": apart,
           "local_sgd_bitwise": local_equal, "launches": total,
           "loss": losses, "boundary": boundary}
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh {name}: non-finite loss")
    if not mesh.shared:
        try:
            capture_step(sharded, m0, batches[0])
        except ValueError as e:
            rec["capture_refused"] = str(e)
        else:
            raise AssertionError(f"mesh {name}: captured over several "
                                 "cards")
        rec["round_ms_median"] = {k: statistics.median(v[1:])
                                  for k, v in ms.items() if v}
        print(json.dumps(rec), flush=True)
        return rec
    # Captured, in turns: each arm from the same state and key.
    runs = {"one": capture_step(quickstart_setup(dev, fuse_round)[-1],
                                s0, batches[0]),
            "mesh": capture_step(make_mesh_step(), m0, batches[0])}
    cap = {"one": s0, "mesh": m0}
    eager_m = m0
    cap_equal = True
    for b in batches:
        for arm in ("one", "mesh"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cap[arm], _ = runs[arm](cap[arm], b)
            torch.cuda.synchronize()
            ms[f"{arm}_captured"].append((time.perf_counter() - t0) * 1e3)
        eager_m, _ = sharded(eager_m, b)
        g, e = lanes_of(cap["mesh"].params), lanes_of(eager_m.params)
        cap_equal &= all(torch.equal(g[n], e[n]) for n in e)
        cap_equal &= torch.equal(cap["mesh"].rng, eager_m.rng)
    if not cap_equal:
        raise AssertionError(f"mesh {name}: captured rounds differ from "
                             "eager ones")
    graph = check_round_graph(f"mesh {name}",
                              graph_nodes(runs["mesh"].graph),
                              mesh_expected(fuse_round))
    rec.update({"captured_bitwise": cap_equal,
                "round_ms_median": {k: statistics.median(v[1:])
                                    for k, v in ms.items()},
                "graph_nodes": graph["graph_nodes"],
                "one_graph_nodes": len(graph_nodes(runs["one"].graph)),
                "kernel_nodes": graph["kernel_nodes"],
                "replay_device_ms": {k: replay_ms(r.graph)
                                     for k, r in runs.items()},
                "replay_profile": {k: replay_profile(r.graph)
                                   for k, r in runs.items()}})
    print(json.dumps(rec), flush=True)
    return rec


def replay_profile(graph) -> dict:
    """One replay of ``graph`` under the profiler: its device busy ms,
    operations and device ms by kernel group (``device_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    rec = device_profile(prof)
    return {k: rec[k] for k in ("device_busy_ms", "device_ops",
                                "device_ms_by_group")}


def mesh_placed(dev) -> dict:
    """The reference's placement arm: ER(64, 0.06, seed 2) over 8 shards
    of cuda:0 (m_local 8), the 2NN at 8-bit stochastic lemma5; the
    placed round (``compute_placement``) against the contiguous one,
    eagerly for MESH_PLACED["rounds"] rounds: the placed parameters,
    gathered back to client order, bitwise the unplaced ones; the placed
    lane slots at most half the contiguous ones."""
    from repro_torch import prng
    from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                                  compute_placement, erdos_renyi_graph,
                                  init_round_state, make_round_step)
    from repro_torch.data import FederatedDataset, classification_dataset
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.paper_nets import (apply_2nn, init_2nn,
                                               softmax_xent)

    p = MESH_PLACED
    m, n = p["m"], p["shards"]
    g = erdos_renyi_graph(m, p["p"], seed=p["seed"])
    spec = MixingSpec.dense(g)
    pl = compute_placement(g, n)
    plan = spec.gossip_plan()
    slots = {"contiguous": plan.block_plan(n).num_wire_lane_slots,
             "placed": plan.block_plan(n, placement=pl).num_wire_lane_slots}
    if 2 * slots["placed"] > slots["contiguous"]:
        raise AssertionError(f"mesh placement: lane slots {slots}")
    fed = FederatedDataset.make(classification_dataset(n=8000, d=784,
                                                       seed=0), m, iid=True)
    params = init_2nn(0, device=dev)
    stacked = {k: t.unsqueeze(0).expand((m,) + t.shape).contiguous()
               + 0.01 * torch.randn((m,) + t.shape, device=dev)
               for k, t in params.items()}
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8))

    def loss_fn(p_, b, rng):
        return softmax_xent(apply_2nn(p_, b["x"]), b["y"])

    mesh = make_test_mesh(n, dev)
    perm = torch.as_tensor(pl.perm.astype(np.int64), device=dev)
    arms = {"contiguous": (make_round_step(loss_fn, cfg, spec, mesh=mesh),
                           init_round_state(stacked, prng.PRNGKey(1),
                                            mesh=mesh)),
            "placed": (make_round_step(loss_fn, cfg, spec, mesh=mesh,
                                       placement=pl),
                       init_round_state({k: v[perm] for k, v in
                                         stacked.items()},
                                        prng.PRNGKey(1), mesh=mesh))}
    states = {k: v[1] for k, v in arms.items()}
    ms = {k: [] for k in arms}
    for t in range(p["rounds"]):
        b = fed.round_batches(t, K=K, batch=BATCH, device=dev)
        for arm, (step, _) in arms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[arm], met = step(states[arm], b)
            torch.cuda.synchronize()
            ms[arm].append((time.perf_counter() - t0) * 1e3)
    inv = torch.as_tensor(pl.inv.astype(np.int64), device=dev)
    placed = {k: v[inv]
              for k, v in lanes_of(states["placed"].params).items()}
    plain = lanes_of(states["contiguous"].params)
    ulp = max(ulp_diff(placed[k], plain[k]) for k in plain)
    rec = {"path": "mesh placement", "m": m, "shards": n,
           "lane_slots": slots, "rounds": p["rounds"],
           "placed_bitwise": ulp == 0,
           "boundary_edges": {"contiguous": g.block_boundary_edges(m // n),
                              "placed": g.block_boundary_edges(m // n,
                                                               perm=pl)},
           "round_ms_median": {k: statistics.median(v[1:])
                               for k, v in ms.items()}}
    print(json.dumps(rec), flush=True)
    if ulp:
        raise AssertionError(f"mesh placement: placed {ulp} ulp from "
                             "unplaced")
    return rec


def mesh_driver(dev) -> dict:
    """SmolLM-135M as registered (bf16, m 8, K 4, batch 4, seq 128, 8
    bits) for MESH_DRIVER_ROUNDS rounds through the LM driver's
    ``run_resident`` on a MESH_SHARDS-shard mesh of cuda:0
    (``--clients-per-shard 2``) and on the one device at the same seed:
    finite losses, B1 = B2 = MESH_SHARDS a round, the same JSONL record
    kinds with the same fields; round ms, peak GiB and the largest
    difference of loss and consensus printed."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.telemetry import RunLog, Tracer

    cfg = production_config()
    PROD_OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for arm in ("one", "mesh"):
        argv = ["--rounds", str(MESH_DRIVER_ROUNDS), "--device", str(dev)]
        argv += MESH_DRIVER_ARGV if arm == "mesh" else ["--bits", "8"]
        args = TT.build_parser().parse_args(argv)
        path = PROD_OUT / f"mesh_driver_{arm}.jsonl"
        log = RunLog(jsonl=str(path), console=False)
        tracer = Tracer(enabled=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        try:
            state, met = TT.run_resident(
                args, cfg, log, tracer,
                mesh=make_test_mesh(MESH_SHARDS, dev) if arm == "mesh"
                else None)
            torch.cuda.synchronize()
        finally:
            log.close()
        recs = [json.loads(line) for line in open(path)]
        out[arm] = {
            "launches": launch_counts(),
            "round_ms": [ev["dur"] / 1e3 for ev in tracer.events
                         if ev.get("name") == "round/step"],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "records": [r for r in recs if r["kind"] != "info"],
            "loss": [r["loss"] for r in recs if r["kind"] == "round"],
            "consensus": [r.get("consensus_dist") for r in recs
                          if r["kind"] == "round"]}
        del state, met
    one, mesh = out["one"], out["mesh"]
    for k in ("quantize_pack_buffer", "dequant_mix_buffer"):
        if mesh["launches"][k] != MESH_SHARDS * MESH_DRIVER_ROUNDS:
            raise AssertionError(f"mesh driver: {k} {mesh['launches'][k]}")
    if not all(math.isfinite(v) for v in mesh["loss"]):
        raise AssertionError(f"mesh driver: losses {mesh['loss']}")
    kinds = [(r["kind"], sorted(r)) for r in one["records"]
             if r["kind"] != "run_start"]
    if kinds != [(r["kind"], sorted(r)) for r in mesh["records"]
                 if r["kind"] != "run_start"]:
        raise AssertionError("mesh driver: records differ in kind or field")
    rec = {"path": "mesh driver", "arch": PROD_ARCH,
           "argv": MESH_DRIVER_ARGV,
           "round_ms": {k: v["round_ms"] for k, v in out.items()},
           "peak_gib": {k: v["peak_gib"] for k, v in out.items()},
           "loss": {k: v["loss"] for k, v in out.items()},
           "max_loss_diff": max(abs(a - b) for a, b in zip(one["loss"],
                                                           mesh["loss"])),
           "max_consensus_diff": max(
               abs(a - b) for a, b in zip(one["consensus"],
                                          mesh["consensus"])),
           "launches": {k: v for k, v in mesh["launches"].items() if v}}
    print(json.dumps(rec), flush=True)
    return rec


def mesh_kernel_checks(dev, flush, tables) -> dict:
    """B2 and B5 at a quickstart shard's extended-table shapes (its 4 own
    rows and the 2 it receives on the ring, K 3, [4, 4, 51 712] at 8
    bits: the table and src of shard 1 of the mesh's plan), bitwise with
    their plain versions on the card and timed against their bounds."""
    from repro_torch.kernels.dequant_mix import (
        dequant_mix_buffer, dequant_mix_buffer_plain,
        dequant_mix_momentum_buffer, dequant_mix_momentum_buffer_plain)
    from repro_torch.kernels.ref import LANE_BLOCK
    gen = torch.Generator().manual_seed(31)
    s, bits, W = 1, 8, 51_712
    src = tables.src[s]
    ml, R, k = tables.m_local, tables.rows[s], src.shape[0]
    per = 32 // bits

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    base, v, g = rand(ml, per, W), rand(ml, per, W, scale=0.01), rand(
        ml, per, W, scale=0.1)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, W), generator=gen,
                          dtype=torch.int32).to(dev)
    sblk = (torch.rand(R, W // LANE_BLOCK, generator=gen) * 1e-2).to(dev)
    w = torch.rand(ml, k, generator=gen).to(dev)
    et = (ETA, THETA)
    rows = int(torch.unique(src).numel())
    out = {}
    for name, fn, plain, extra in (
            ("dequant_mix_buffer", dequant_mix_buffer,
             dequant_mix_buffer_plain, ()),
            ("dequant_mix_momentum_buffer", dequant_mix_momentum_buffer,
             dequant_mix_momentum_buffer_plain, (v, g, et))):
        got = fn(base, words, sblk, w, src, *extra, bits)
        want = plain(base, words, sblk, w, src, *extra, bits)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"mesh {name}: kernel != plain")
        r = {"shape": {"base": [ml, per, W], "rows": R, "K": k,
                       "bits": bits}, "max_abs_err": 0.0}
        timed(r, "", lambda: fn(base, words, sblk, w, src, *extra, bits),
              flush)
        timed(r, "plain_", lambda: plain(base, words, sblk, w, src, *extra,
                                         bits), flush, reps=5, host_runs=3)
        moved = (nbytes(base, got, sblk, w, src) + rows * W * 4
                 + (nbytes(v, g) if extra else 0))
        r["bound_ms"], r["bound_by"] = bound(moved, 2 * k * ml * per * W)
        out[name] = r
    print(json.dumps({"mesh_kernels": out}), flush=True)
    return out


def mesh_phase(dev, flush=None) -> dict:
    """Phase "mesh": the 1D client mesh of MESH_SHARDS shards sharing
    cuda:0 — the quickstart unfused and fused against the one-device
    realization (:func:`mesh_rounds`), the placement arm
    (:func:`mesh_placed`), SmolLM-135M through the driver on the mesh
    (:func:`mesh_driver`) and B2 / B5 at a shard's extended-table shapes
    (:func:`mesh_kernel_checks`). Returns the phase's record, with its
    launches by arm."""
    from repro_torch.core import MixerConfig, make_mixer
    from repro_torch.core import MixingSpec
    from repro_torch.launch.mesh import make_test_mesh
    if flush is None:
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    rounds = {"unfused": mesh_rounds(dev, False),
              "fused": mesh_rounds(dev, True)}
    placed = mesh_placed(dev)
    driver = mesh_driver(dev)
    tables = make_mixer(MixingSpec.ring(M, 0.5), MixerConfig(),
                        mesh=make_test_mesh(MESH_SHARDS, dev)).tables
    kernels = mesh_kernel_checks(dev, flush, tables)
    rec = {"rounds": rounds, "placed": placed, "driver": driver,
           "kernels": kernels, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"mesh": {
        "phase_s": rec["phase_s"],
        "round_ms_median": {k: v["round_ms_median"]
                            for k, v in rounds.items()},
        "replay_device_ms": {k: v["replay_device_ms"]
                             for k, v in rounds.items()},
        "graph_nodes": {k: [v["graph_nodes"], v["one_graph_nodes"]]
                        for k, v in rounds.items()},
        "boundary": rounds["unfused"]["boundary"],
        "placed": {k: placed[k] for k in ("lane_slots", "round_ms_median")},
        "driver": {k: driver[k] for k in ("round_ms", "peak_gib",
                                          "max_loss_diff",
                                          "max_consensus_diff")}}}),
        flush=True)
    return rec


def cards_phase(dev, flush=None) -> dict:
    """Phase "cards" (``--only cards``, on a machine with MESH_SHARDS
    cards or more; not in the default run, which needs one card): the
    quickstart unfused and fused on ``make_client_mesh(16,
    clients_per_shard=4)``, one card a shard, so every boundary transfer
    is a copy between two cards, against the one-device round on cuda:0
    (:func:`mesh_rounds`: bitwise, exact launches; eager, since
    ``capture_step`` refuses a mesh over several cards); then the 2D arm
    on ``make_client_mesh(16, clients_per_shard=8, model_parallel=2)``,
    one card a cell, against the 1D mesh of 2 shards on cuda:0 alone
    (:func:`mesh2d_rounds`: bitwise, exact launches, eager,
    ``capture_step`` refused)."""
    from repro_torch.launch.mesh import make_client_mesh, make_test_mesh
    del flush
    mesh = make_client_mesh(M, clients_per_shard=M // MESH_SHARDS)
    if mesh is None:
        raise AssertionError(f"cards phase: needs {MESH_SHARDS} cards, "
                             f"found {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    rec = {arm: mesh_rounds(dev, arm == "fused", mesh=mesh)
           for arm in ("unfused", "fused")}
    mesh2 = make_client_mesh(M, clients_per_shard=M // 2, model_parallel=2)
    rec["2d"] = mesh2d_rounds(dev, mesh2=mesh2, mesh1=make_test_mesh(2, dev))
    rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"cards": {
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
        "round_ms_median": {k: rec[k]["round_ms_median"]
                            for k in ("unfused", "fused", "2d")},
        "capture_refused_2d": "capture_refused" in rec["2d"],
        "phase_s": rec["phase_s"]}}), flush=True)
    return rec


# The "mesh2d" phase: the 2D (clients, model) mesh on one card, its cells
# sharing cuda:0 (``launch.mesh.make_test_mesh(n, model_parallel=mp)``).
MESH2D_SHARDS, MESH2D_MP = 4, 2
MESH2D_QUANTS = {"fp32": None,
                 "q8_lemma5": dict(bits=8, stochastic=False,
                                   delta_mode="lemma5"),
                 "q8_eq7": dict(bits=8, stochastic=False, delta_mode="eq7"),
                 "q8_stoch": dict(bits=8)}
MESH2D_DRIVER_ROUNDS = 2
MESH2D_DRIVER_ARGV = ["--bits", "8", "--clients", "8",
                      "--clients-per-shard", "4"]
MESH2D_CONSENSUS_RTOL = 1e-5
MESH2D_T2_KEYS = 8
# What this PR's PERF.md predicted before the first run on the card.
MESH2D_PREDICTION = {
    "eager_round_ms": [45, 60], "replay_ms": [4.0, 5.0],
    "graph_nodes": [1600, 1900], "column_bytes_a_round": 4341952,
    "wire_ratio_1d_over_2d": {"32": 4.0, "8": 3.9993},
    "driver_round_ms": [2500, 3500], "driver_peak_gib": [35, 40],
    "b1_tensor_noise_cell_us": [6, 10], "b2_cell_us": [6, 10],
    "t2_smollm_leaf_8_keys_ms": [1.0, 1.5]}


def mesh2d_specs() -> dict:
    """The reference's 2NN hand specs (``tests/test_mesh2d.py``): w1's
    columns, w2's and w3's rows and the biases cut over ``"model"``."""
    from repro_torch.sharding import P
    return {"w1": P("clients", None, "model"), "b1": P("clients", "model"),
            "w2": P("clients", "model", None), "b2": P("clients", "model"),
            "w3": P("clients", "model", None), "b3": P("clients", "model")}


def mesh2d_expected(shards: int = MESH2D_SHARDS, mp: int = MESH2D_MP,
                    rounds: int = 1, n_leaves: int = 6) -> dict:
    """Launches of ``rounds`` unfused quickstart rounds at 8-bit
    stochastic lemma5 on a (shards, mp) mesh: B1 and B2 once a cell, B3
    once a local step a shard (on its joined lanes), T2 once a leaf (the
    full leaf's noise over the m keys), T1 as on the 1D mesh of the same
    shards (round and client keys, the per-leaf keys, a split a shard)."""
    e = {k: 0 for k in KERNEL_SOURCES}
    e.update(quantize_pack_buffer=shards * mp,
             dequant_mix_buffer=shards * mp, momentum_sgd=K * shards,
             threefry_split=3 + shards, threefry_uniform=n_leaves)
    return {k: v * rounds for k, v in e.items()}


def mesh2d_mixer_gate(dev, mesh2, mesh1, setup, batch) -> dict:
    """The 2D mixer against the 1D mesh of the same shards and the one
    device, fed one round's x and z, in fp32, q8 lemma5, q8 eq7 and q8
    stochastic: bitwise. Returns the q8 stochastic 2D mixer's tables
    after its call (the round's shipped bytes)."""
    from repro_torch import prng
    from repro_torch.core import MixerConfig, QuantConfig, local_train
    from repro_torch.core import make_mixer
    data, fed, stacked, spec, cfg, loss_fn, _ = setup
    specs = mesh2d_specs()
    x = {n: t + 0.01 * torch.randn_like(t) for n, t in stacked.items()}
    key_round, key_mix, _ = prng.split(prng.PRNGKey(3, device=dev), 3)
    z, _ = local_train(loss_fn, x, batch, prng.split(key_round, M),
                       eta=ETA, theta=THETA)
    out = {}
    for name, q in MESH2D_QUANTS.items():
        mcfg = MixerConfig(quant=None if q is None else QuantConfig(**q))
        want = make_mixer(spec, mcfg, device=dev)(x, z, key_mix)
        one_d = make_mixer(spec, mcfg, mesh=mesh1)
        two_d = make_mixer(spec, mcfg, mesh=mesh2, param_specs=specs)
        got1 = mesh1.gather(one_d(mesh1.shard(x), mesh1.shard(z), key_mix))
        got2 = mesh2.gather(two_d(mesh2.shard(x, specs),
                                  mesh2.shard(z, specs), key_mix), specs)
        ulp = max(max(ulp_diff(got2[n], want[n]), ulp_diff(got2[n],
                                                           got1[n]))
                  for n in want)
        if ulp:
            raise AssertionError(f"mesh2d mixer {name}: {ulp} ulp from the "
                                 "1D mesh / one device")
        out[name] = {"bitwise": True,
                     "column_bytes": list(two_d.tables.column_bytes),
                     "shipped_1d": one_d.tables.shipped_bytes}
        tables = two_d.tables
    out["tables"] = tables
    return out


def mesh2d_boundary(tables, stacked, quant, spec, mp: int) -> dict:
    """A round's per-column shipped bytes against ``plan_round_bits(...,
    model_parallel=mp)`` (lemma5 replicas counted): a column ships the
    bill's lane slots times a cell's stream (its slices' words, the
    per-leaf scales, the lemma5 replica row), exactly; the ratio to the
    per-column bill (which counts d / mp parameters, not a cell's padded
    words) is printed."""
    from repro_torch.core import WireLayout, plan_round_bits
    specs = mesh2d_specs()
    cps = M // tables.n_shards
    cell = {n: t[:cps] for n, t in stacked.items()}
    for n, spec_ in specs.items():
        d = next(i for i in range(len(spec_)) if "model" in spec_.names(i))
        cell[n] = cell[n].narrow(d, 0, cell[n].shape[d] // mp)
    layout = WireLayout.for_tree(cell, quant.bits, stacked=True)
    d_full = sum(t[0].numel() for t in stacked.values())
    bill = plan_round_bits(spec.gossip_plan(), d_full, quant, True,
                           clients_per_shard=cps, model_parallel=mp) / 8
    slots = tables.lanes_moved
    stream = 4 * (layout.total_words + layout.n_leaves
                  + (layout.per * layout.total_words
                     if quant.delta_mode == "lemma5" else 0))
    rec = {"lanes_moved": slots, "column_bytes": list(tables.column_bytes),
           "expected_column_bytes": slots * stream,
           "stream_bytes_a_lane": stream, "bill_bytes_a_column": bill}
    rec["column_over_bill"] = tables.column_bytes[0] / bill
    if any(b != slots * stream for b in tables.column_bytes):
        raise AssertionError(f"mesh2d boundary: {rec}")
    return rec


def mesh2d_rounds(dev, mesh2=None, mesh1=None) -> dict:
    """The quickstart (2NN, m 16, ring 0.5, K 4, batch 32, 8-bit
    stochastic lemma5) on a (MESH2D_SHARDS, MESH2D_MP) mesh of cuda:0 (or
    ``mesh2``, one card a cell, against ``mesh1`` on cuda:0) under the
    hand specs: the mixer gate in four modes, ROUNDS eager rounds in
    turns with the 1D mesh of the same shards (bitwise each round, exact
    launches of the 2D arm), then on a shared card ROUNDS captured rounds
    of each in turns (captured bitwise with eager; the 2D graph holds
    one round's kernel nodes), graph nodes and replay ms of both, and the
    per-column bytes against the bill; over several cards
    ``capture_step`` must refuse."""
    from repro_torch import prng
    from repro_torch.core import (capture_step, init_round_state,
                                  make_round_step)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh

    if mesh2 is None:
        mesh2 = make_test_mesh(MESH2D_SHARDS, model_parallel=MESH2D_MP,
                               device=dev)
    if mesh1 is None:
        mesh1 = make_test_mesh(mesh2.n_shards, dev)
    name = "2d" if mesh2.shared else f"2d on {mesh2.devices.size} cards"
    specs = mesh2d_specs()
    setup = quickstart_setup(dev)
    data, fed, stacked, spec, cfg, loss_fn, _ = setup
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    gate = mesh2d_mixer_gate(dev, mesh2, mesh1, setup, batches[0])
    boundary = mesh2d_boundary(gate.pop("tables"), stacked, cfg.quant, spec,
                               mesh2.model_parallel)

    def step_2d():
        return make_round_step(loss_fn, cfg, spec, mesh=mesh2,
                               param_specs=specs)

    def step_1d():
        return make_round_step(loss_fn, cfg, spec, mesh=mesh1)

    steps = {"1d": step_1d(), "2d": step_2d()}
    s0 = {"1d": init_round_state(stacked, prng.PRNGKey(1), mesh=mesh1),
          "2d": init_round_state(stacked, prng.PRNGKey(1), mesh=mesh2,
                                 param_specs=specs)}
    states = dict(s0)
    ms = {k: [] for k in ("1d", "2d")}
    total = {k: 0 for k in KERNEL_SOURCES}
    losses, apart = [], None
    for t, b in enumerate(batches):
        for arm in ("1d", "2d"):
            sync_all()
            reset_launch_counts()
            t0 = time.perf_counter()
            states[arm], met = steps[arm](states[arm], b)
            sync_all()
            ms[arm].append((time.perf_counter() - t0) * 1e3)
            if arm == "2d":
                counts = launch_counts()
                total = {k: total[k] + counts[k] for k in total}
                losses.append(float(met["loss"]))
        got = mesh2.gather(states["2d"].params, specs)
        want = mesh1.gather(states["1d"].params)
        diff = {n: ulp_diff(got[n], want[n]) for n in want}
        if apart is None and any(diff.values()):
            apart = {"round": t, "ulp": diff}
    expect = mesh2d_expected(mesh2.n_shards, mesh2.model_parallel,
                             rounds=ROUNDS)
    if total != expect:
        raise AssertionError(f"mesh {name}: launches {total} != {expect}")
    if apart is not None:
        raise AssertionError(f"mesh {name}: rounds part from the 1D mesh's "
                             f"at {apart}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh {name}: non-finite loss {losses}")
    rec = {"path": f"mesh {name}", "cells": list(mesh2.devices.shape),
           "rounds": ROUNDS, "mixer": gate, "rounds_bitwise": True,
           "launches": total, "loss": losses, "boundary": boundary}
    if not mesh2.shared:
        try:
            capture_step(steps["2d"], s0["2d"], batches[0])
        except ValueError as e:
            rec["capture_refused"] = str(e)
        else:
            raise AssertionError(f"mesh {name}: captured over several cards")
        rec["round_ms_median"] = {k: statistics.median(v[1:])
                                  for k, v in ms.items()}
        print(json.dumps(rec), flush=True)
        return rec
    runs = {"1d": capture_step(step_1d(), s0["1d"], batches[0]),
            "2d": capture_step(step_2d(), s0["2d"], batches[0])}
    cap = dict(s0)
    eager = s0["2d"]
    cap_ms = {k: [] for k in runs}
    for b in batches:
        for arm in ("1d", "2d"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cap[arm], _ = runs[arm](cap[arm], b)
            torch.cuda.synchronize()
            cap_ms[arm].append((time.perf_counter() - t0) * 1e3)
        eager, _ = steps["2d"](eager, b)
        g = mesh2.gather(cap["2d"].params, specs)
        e = mesh2.gather(eager.params, specs)
        o = mesh1.gather(cap["1d"].params)
        if not all(torch.equal(g[n], e[n]) and torch.equal(g[n], o[n])
                   for n in e):
            raise AssertionError(f"mesh {name}: captured rounds differ from "
                                 "eager ones or from the 1D mesh's")
    graph = check_round_graph(f"mesh {name}", graph_nodes(runs["2d"].graph),
                              mesh2d_expected(mesh2.n_shards,
                                              mesh2.model_parallel))
    rec.update({"captured_bitwise": True,
                "round_ms_median": {k: statistics.median(v[1:])
                                    for k, v in ms.items()},
                "captured_round_ms_median": {
                    k: statistics.median(v[1:]) for k, v in cap_ms.items()},
                "graph_nodes": graph["graph_nodes"],
                "graph_nodes_1d": len(graph_nodes(runs["1d"].graph)),
                "kernel_nodes": graph["kernel_nodes"],
                "replay_device_ms": {k: replay_ms(r.graph)
                                     for k, r in runs.items()}})
    print(json.dumps(rec), flush=True)
    return rec


def mesh2d_fused(dev) -> dict:
    """The fused quickstart round (8-bit stochastic lemma5, B4 and B5) on
    a (MESH2D_SHARDS, MESH2D_MP) mesh of cuda:0 with no specs, every
    column the whole model, against the 1D mesh of the same shards:
    ROUNDS eager rounds in turns (bitwise every round, every column's
    cells equal, launches exactly B4 = B5 once a cell a round), then
    ROUNDS captured rounds of each (bitwise with eager and with the 1D
    mesh; the graph one round's kernel nodes), graph nodes and replay ms
    of both."""
    from repro_torch import prng
    from repro_torch.core import (capture_step, init_round_state,
                                  make_round_step)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh

    mesh2 = make_test_mesh(MESH2D_SHARDS, model_parallel=MESH2D_MP,
                           device=dev)
    mesh1 = make_test_mesh(MESH2D_SHARDS, dev)
    data, fed, stacked, spec, cfg, loss_fn, _ = quickstart_setup(
        dev, fuse_round=True)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    meshes = {"1d": mesh1, "2d": mesh2}

    def step(arm):
        return make_round_step(loss_fn, cfg, spec, mesh=meshes[arm])

    steps = {arm: step(arm) for arm in meshes}
    s0 = {arm: init_round_state(stacked, prng.PRNGKey(1), mesh=m)
          for arm, m in meshes.items()}
    states = dict(s0)
    ms = {arm: [] for arm in meshes}
    total = {k: 0 for k in KERNEL_SOURCES}
    for t, b in enumerate(batches):
        for arm in meshes:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            states[arm], _ = steps[arm](states[arm], b)
            torch.cuda.synchronize()
            ms[arm].append((time.perf_counter() - t0) * 1e3)
            if arm == "2d":
                counts = launch_counts()
                total = {k: total[k] + counts[k] for k in total}
        cells = states["2d"].params
        for i, cell in enumerate(cells):
            first = cells[i - i % MESH2D_MP]
            if not all(torch.equal(cell[n], first[n]) for n in cell):
                raise AssertionError(f"mesh2d fused: round {t}, cell {i} "
                                     "differs from its row's column 0")
        got = mesh2.gather(cells)
        want = mesh1.gather(states["1d"].params)
        if not all(torch.equal(got[n], want[n]) for n in want):
            raise AssertionError(f"mesh2d fused: round {t} differs from "
                                 "the 1D mesh's fused round")
    one = mesh_expected(True, MESH2D_SHARDS)
    expect = dict(one, momentum_quantize_pack_buffer=MESH2D_SHARDS
                  * MESH2D_MP, dequant_mix_momentum_buffer=MESH2D_SHARDS
                  * MESH2D_MP)
    if total != {k: v * ROUNDS for k, v in expect.items()}:
        raise AssertionError(f"mesh2d fused: launches {total} != "
                             f"{ROUNDS} x {expect}")
    runs = {arm: capture_step(step(arm), s0[arm], batches[0])
            for arm in meshes}
    cap, eager = dict(s0), s0["2d"]
    cap_ms = {arm: [] for arm in meshes}
    for b in batches:
        for arm in meshes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cap[arm], _ = runs[arm](cap[arm], b)
            torch.cuda.synchronize()
            cap_ms[arm].append((time.perf_counter() - t0) * 1e3)
        eager, _ = steps["2d"](eager, b)
        g, e = mesh2.gather(cap["2d"].params), mesh2.gather(eager.params)
        o = mesh1.gather(cap["1d"].params)
        if not all(torch.equal(g[n], e[n]) and torch.equal(g[n], o[n])
                   for n in e):
            raise AssertionError("mesh2d fused: captured rounds differ "
                                 "from eager ones or from the 1D mesh's")
    graph = check_round_graph("mesh2d fused", graph_nodes(runs["2d"].graph),
                              expect)
    rec = {"path": "mesh2d fused, no specs", "cells": [MESH2D_SHARDS,
                                                       MESH2D_MP],
           "rounds": ROUNDS, "rounds_bitwise": True,
           "captured_bitwise": True, "launches": total,
           "round_ms_median": {k: statistics.median(v[1:])
                               for k, v in ms.items()},
           "captured_round_ms_median": {k: statistics.median(v[1:])
                                        for k, v in cap_ms.items()},
           "graph_nodes": graph["graph_nodes"],
           "graph_nodes_1d": len(graph_nodes(runs["1d"].graph)),
           "kernel_nodes": graph["kernel_nodes"],
           "replay_device_ms": {k: replay_ms(r.graph)
                                for k, r in runs.items()}}
    print(json.dumps({"mesh2d_fused": rec}), flush=True)
    return rec


def mesh2d_driver(dev) -> dict:
    """SmolLM-135M as registered (bf16, m 8, K 4, batch 4, seq 128, 8
    bits) for MESH2D_DRIVER_ROUNDS rounds through ``run_resident`` on a
    (2, 2) mesh of cuda:0 (``--clients-per-shard 4 --model-parallel 2``,
    RULES_A) and on the 1D mesh of the same 2 shards: the 2D run's "2D
    mesh:" and per-column wire lines, B1 = B2 = 4 a round, losses bitwise
    the 1D run's, consensus within MESH2D_CONSENSUS_RTOL; round ms, peak
    GiB and its T2 launches printed."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.telemetry import RunLog, Tracer

    cfg = production_config()
    PROD_OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for arm in ("1d", "2d"):
        argv = ["--rounds", str(MESH2D_DRIVER_ROUNDS), "--device", str(dev)]
        argv += MESH2D_DRIVER_ARGV
        mesh = make_test_mesh(2, dev)
        if arm == "2d":
            argv += ["--model-parallel", "2"]
            mesh = make_test_mesh(2, model_parallel=2, device=dev)
        args = TT.build_parser().parse_args(argv)
        path = PROD_OUT / f"mesh2d_driver_{arm}.jsonl"
        log = RunLog(jsonl=str(path), console=False)
        tracer = Tracer(enabled=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        try:
            state, met = TT.run_resident(args, cfg, log, tracer, mesh=mesh)
            torch.cuda.synchronize()
        finally:
            log.close()
        recs = [json.loads(line) for line in open(path)]
        path.unlink()
        out[arm] = {
            "launches": launch_counts(),
            "round_ms": [ev["dur"] / 1e3 for ev in tracer.events
                         if ev.get("name") == "round/step"],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "loss": [r["loss"] for r in recs if r["kind"] == "round"],
            "consensus": [r.get("consensus_dist") for r in recs
                          if r["kind"] == "round"],
            "info": [r.get("msg", "") for r in recs if r["kind"] == "info"]}
        del state, met
    one, two = out["1d"], out["2d"]
    lines = {k: next((m for m in two["info"] if m.startswith(k)), None)
             for k in ("2D mesh:", "per-device wire:")}
    if None in lines.values():
        raise AssertionError(f"mesh2d driver: log lines {two['info']}")
    for k in ("quantize_pack_buffer", "dequant_mix_buffer"):
        if two["launches"][k] != 4 * MESH2D_DRIVER_ROUNDS:
            raise AssertionError(f"mesh2d driver: {k} {two['launches'][k]}")
    if two["loss"] != one["loss"] or not all(
            math.isfinite(v) for v in two["loss"]):
        raise AssertionError(f"mesh2d driver: losses {two['loss']} != "
                             f"{one['loss']}")
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(two["consensus"], one["consensus"]))
    if rel > MESH2D_CONSENSUS_RTOL:
        raise AssertionError(f"mesh2d driver: consensus rel {rel}")
    rec = {"path": "mesh2d driver", "arch": PROD_ARCH,
           "argv": MESH2D_DRIVER_ARGV + ["--model-parallel", "2"],
           "log_lines": lines,
           "round_ms": {k: v["round_ms"] for k, v in out.items()},
           "peak_gib": {k: v["peak_gib"] for k, v in out.items()},
           "loss": two["loss"], "losses_bitwise": True,
           "consensus_rel_diff": rel,
           "launches": {k: v for k, v in two["launches"].items() if v}}
    print(json.dumps(rec), flush=True)
    return rec


def mesh2d_kernel_checks(dev, flush, tables) -> dict:
    """B1 through its tensor-noise entry and B2 at a 2D quickstart cell's
    shapes (cell (1, 0) of the (4, 2) mesh: 4 lanes, the 2NN's slices,
    8 bits; B2 over the cell's R-row table of ``tables``), and T2 at
    SmolLM-135M's largest leaf for MESH2D_T2_KEYS keys (the 2D mesh's
    full-leaf draw): bitwise with their plain versions on the card (T2
    key by key), timed against their bounds."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import QuantConfig, WireLayout
    from repro_torch.kernels import ref, threefry
    from repro_torch.kernels.dequant_mix import (dequant_mix_buffer,
                                                 dequant_mix_buffer_plain)
    from repro_torch.kernels.quantize_pack import quantize_pack_buffer
    from repro_torch.models.model import init_model
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(41)
    bits, quant = 8, QuantConfig(bits=8)
    cell_i = 1 * MESH2D_MP
    ml = tables.m_local
    cell = {}
    for n, t in init_2nn(0, device="cpu").items():
        spec = mesh2d_specs()[n]
        d = next(i for i in range(len(spec)) if "model" in spec.names(i))
        shape = [ml] + list(t.shape)
        shape[d] //= MESH2D_MP
        cell[n] = (torch.randn(shape, generator=gen) * 0.01).to(dev)
    layout = WireLayout.for_tree(cell, bits, stacked=True)
    delta = layout.to_planar_stacked(cell)
    sblk = layout.block_scales(layout.leaf_scales(delta, quant))
    noise = layout.to_planar_stacked(
        {n: torch.rand(t.shape, generator=gen).to(dev)
         for n, t in cell.items()})
    out = {}
    r = {"max_abs_err": 0.0, "max_ulp": 0,
         "shape": {"x": list(delta.shape), "bits": bits}}
    words = quantize_pack_buffer(delta, sblk, bits, noise)
    check_words("mesh2d B1 tensor noise", words,
                ref.quantize_pack_buffer_ref(delta, sblk, bits, noise))
    timed(r, "", lambda: quantize_pack_buffer(delta, sblk, bits, noise),
          flush)
    timed(r, "plain_", lambda: ref.quantize_pack_buffer_ref(
        delta, sblk, bits, noise), flush, reps=5, host_runs=3)
    r["bound_ms"], r["bound_by"] = bound(nbytes(delta, sblk, noise, words),
                                         8 * delta.numel())
    out["quantize_pack_buffer"] = r

    src = tables.src[cell_i]
    R, k, W = tables.rows[cell_i], src.shape[0], layout.total_words
    per = 32 // bits
    base = (torch.randn(ml, per, W, generator=gen)).to(dev)
    wrows = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, W), generator=gen,
                          dtype=torch.int32).to(dev)
    rblk = (torch.rand(R, layout.n_blocks, generator=gen) * 1e-2).to(dev)
    w = torch.rand(ml, k, generator=gen).to(dev)
    got = dequant_mix_buffer(base, wrows, rblk, w, src, bits)
    want = dequant_mix_buffer_plain(base, wrows, rblk, w, src, bits)
    check_words("mesh2d B2", got.view(torch.int32), want.view(torch.int32))
    r = {"max_abs_err": 0.0, "max_ulp": 0,
         "shape": {"base": [ml, per, W], "rows": R, "K": k, "bits": bits}}
    timed(r, "", lambda: dequant_mix_buffer(base, wrows, rblk, w, src,
                                            bits), flush)
    timed(r, "plain_", lambda: dequant_mix_buffer_plain(
        base, wrows, rblk, w, src, bits), flush, reps=5, host_runs=3)
    rows = int(torch.unique(src).numel())
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(base, rblk, w, src, got) + rows * W * 4, 2 * k * ml * per * W)
    out["dequant_mix_buffer"] = r

    meta = init_model(torch.zeros(2, dtype=torch.int64, device="meta"),
                      get_config(PROD_ARCH), device="meta")
    leaf = max(meta, key=lambda n: meta[n].numel())
    n = meta[leaf].numel()
    keys = torch.randint(0, 2 ** 32, (MESH2D_T2_KEYS, 2), generator=gen,
                         dtype=torch.int64).to(dev)
    u = threefry.uniform(keys, (n,))
    for i in range(MESH2D_T2_KEYS):
        check_words(f"mesh2d T2 {leaf} key {i}", u[i].view(torch.int32),
                    prng.uniform_plain(keys[i:i + 1], (n,))[0]
                    .view(torch.int32))
    del u
    r = {"max_abs_err": 0.0, "max_ulp": 0,
         "shape": {"keys": MESH2D_T2_KEYS, "draws": n, "leaf": leaf}}
    timed(r, "", lambda: threefry.uniform(keys, (n,)), flush)
    timed(r, "plain_", lambda: [prng.uniform_plain(keys[i:i + 1], (n,))
                                for i in range(MESH2D_T2_KEYS)],
          flush, reps=3, host_runs=1)
    r["sass"] = threefry_ops("threefry_uniform", MESH2D_T2_KEYS * n)
    r["bound_ms"], r["bound_by"] = bound(4 * MESH2D_T2_KEYS * n
                                         + nbytes(keys), 0, r["sass"]["ms"])
    out["threefry_uniform"] = r
    torch.cuda.empty_cache()
    print(json.dumps({"mesh2d_kernels": out}), flush=True)
    return out


def mesh2d_phase(dev, flush=None) -> dict:
    """Phase "mesh2d": the 2D (clients, model) mesh sharing cuda:0 — the
    predictions, the quickstart's mixer gate and rounds against the 1D
    mesh (:func:`mesh2d_rounds`), the bytes arm
    (``bench.timevarying.mesh2d_compare`` at d 65 536: fp32 exactly 4.0,
    q8 >= 3.0), SmolLM-135M through the driver on a (2, 2) mesh
    (:func:`mesh2d_driver`), and B1 (tensor noise), B2 and T2 at the
    phase's shapes (:func:`mesh2d_kernel_checks`)."""
    from repro_torch.bench.timevarying import mesh2d_compare
    from repro_torch.core import MixerConfig, MixingSpec, make_mixer
    from repro_torch.launch.mesh import make_test_mesh
    if flush is None:
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    print(json.dumps({"mesh2d_prediction": MESH2D_PREDICTION}), flush=True)
    t0 = time.perf_counter()
    rounds = mesh2d_rounds(dev)
    fused = mesh2d_fused(dev)
    compare = mesh2d_compare(smoke=False, device=dev)
    print(json.dumps({"mesh2d_compare": compare}), flush=True)
    driver = mesh2d_driver(dev)
    mesh = make_test_mesh(MESH2D_SHARDS, model_parallel=MESH2D_MP,
                          device=dev)
    tables = make_mixer(MixingSpec.ring(M, 0.5), MixerConfig(),
                        mesh=mesh, param_specs=mesh2d_specs()).tables
    kernels = mesh2d_kernel_checks(dev, flush, tables)
    rec = {"rounds": rounds, "fused": fused, "compare": compare,
           "driver": driver, "kernels": kernels,
           "phase_s": time.perf_counter() - t0}
    print(json.dumps({"mesh2d": {
        "phase_s": rec["phase_s"],
        "round_ms_median": rounds["round_ms_median"],
        "captured_round_ms_median": rounds["captured_round_ms_median"],
        "replay_device_ms": rounds["replay_device_ms"],
        "graph_nodes": [rounds["graph_nodes"], rounds["graph_nodes_1d"]],
        "fused_graph_nodes": [fused["graph_nodes"],
                              fused["graph_nodes_1d"]],
        "fused_replay_device_ms": fused["replay_device_ms"],
        "boundary": rounds["boundary"],
        "wire_ratio_1d_over_2d": {
            b: compare[f"wire_ratio_1d_over_2d_b{b}"] for b in (32, 8)},
        "driver": {k: driver[k] for k in ("round_ms", "peak_gib",
                                          "log_lines",
                                          "consensus_rel_diff")}}}),
        flush=True)
    return rec


# The "mia" phase: the membership-inference probe at the reference's
# sizes (``repro_torch.bench.mia``), ``quantize_pytree`` and the attack
# model's init.
MIA_CPU_ROUNDS = 5
# The card's 5-round shadow and target models against the port's CPU run
# of the same rounds: the card's matmuls reduce in another order.
MIA_CPU_RTOL, MIA_CPU_ATOL = 1e-4, 1e-6
MIA_ATTACK_D = 3             # the attack model's input: top-3 probabilities
# What PERF.md predicted before the phase's first run on the card.
MIA_PREDICTION = {
    "b3_launches_a_round": 4, "b3_nodes_a_round_graph": 4,
    "cpu_max_rel_diff": [1e-7, 1e-5], "auc_rounds5": [0.63, 0.65],
    "auc_rounds60": [0.93, 0.95], "auc_card_minus_cpu": [0.0, 0.01],
    "captured_round_ms": [0.4, 1.0], "phase_s": [20, 60]}
# The "bench_kernels" phase: bench.kernels' vector, and its predictions.
KBENCH_PREDICTION = {
    "b6_us": {"8": [4.5, 7.0], "4": [4.5, 7.0]},
    "b8_us": {"8": [4.5, 8.0], "4": [4.5, 8.0]},
    "b3_us": [8.0, 10.0], "b3_library_us": [9.0, 14.0]}
# The "wire" phase: the seq codec against planar on the quickstart.
WIRES = ("auto", "seq", "planar")
WIRE_PREDICTION = {"b1_b2_launches_each_codec": 12, "bitwise": True,
                   "round_ms_each_codec": [7.5, 9.5]}
WIRE_DRIVER_ARGV = ["--rounds", "2", "--bits", "8", "--clients", "4",
                    "--local-steps", "2", "--batch", "2", "--seq", "16"]


def mia_phase(dev, flush=None) -> dict:
    """Phase "mia": :mod:`repro_torch.bench.mia` on the card, its gates
    and its neighbours: MIA_CPU_ROUNDS eager shadow rounds with their
    launches (B3 exactly K a round, no wire kernel: fp32 gossip) against
    as many captured rounds (bitwise; the graph K B3 nodes a round); the
    captured shadow and target models after MIA_CPU_ROUNDS rounds within
    MIA_CPU_RTOL of the port's CPU run; the bench's two AUC rows at the
    reference's sizes (rounds 5 and 60, captured), finite in [0, 1],
    beside the CPU's; ``quantize_pytree`` on the 2NN at 8 and 4 bits
    bitwise with the CPU; the attack model's init (T1, T4) bitwise with
    its plain version on the card."""
    from repro_torch import prng
    from repro_torch.bench import mia as bmia
    from repro_torch.core import QuantConfig, average_params, quantize_pytree
    from repro_torch.data import classification_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.paper_nets import init_2nn
    from repro_torch.privacy import mia_split
    from repro_torch.privacy.mia import attack_init
    print(json.dumps({"mia_prediction": MIA_PREDICTION}), flush=True)
    t_phase = time.perf_counter()
    data = classification_dataset(n=bmia.N, d=bmia.D, noise=bmia.NOISE,
                                  seed=bmia.DATA_SEED)
    split = mia_split(len(data.y), seed=0)
    rounds = MIA_CPU_ROUNDS
    torch.cuda.synchronize()
    reset_launch_counts()
    eager = bmia.train_run(data, split.shadow_train, rounds, 0, device=dev,
                           capture=False)
    torch.cuda.synchronize()
    launches = launch_counts()
    want_b3 = bmia.K * rounds
    wire = sum(launches[k] for k in (
        "quantize_pack_buffer", "dequant_mix_buffer",
        "momentum_quantize_pack_buffer", "dequant_mix_momentum_buffer"))
    if launches["momentum_sgd"] != want_b3 or wire:
        raise AssertionError(f"mia: {rounds} eager rounds launched "
                             f"{launches}, B3 != {want_b3} or a wire kernel")
    models, graph = {}, None
    for role, seed, idx in (("shadow", 0, split.shadow_train),
                            ("target", 1, split.target_train)):
        run = bmia.train_run(data, idx, rounds, seed, device=dev)
        card = average_params(run["state"].params)
        if role == "shadow":
            graph = kernel_nodes(graph_nodes(run["graph"]))
            if graph["momentum_sgd"] != bmia.K:
                raise AssertionError(f"mia: the round graph holds "
                                     f"{graph['momentum_sgd']} B3 nodes, "
                                     f"not {bmia.K}")
            e = average_params(eager["state"].params)
            if not all(torch.equal(card[n], e[n]) for n in e):
                raise AssertionError("mia: captured rounds differ from "
                                     "eager ones")
        cpu = bmia._train_on(data, idx, rounds, seed, device="cpu")
        rel = max(float((card[n].cpu() - cpu[n]).abs().max()
                        / cpu[n].abs().max().clamp(min=1e-30)) for n in cpu)
        close = all(torch.allclose(card[n].cpu(), cpu[n], rtol=MIA_CPU_RTOL,
                                   atol=MIA_CPU_ATOL) for n in cpu)
        models[role] = {"max_rel_diff_vs_cpu": rel, "within_rtol": close,
                        "us_per_round": run["us_per_round"],
                        "capture_s": run["capture_s"]}
        if not close:
            raise AssertionError(f"mia: the {role} model is {rel} from the "
                                 f"CPU's after {rounds} rounds")
    t0 = time.perf_counter()
    card_aucs = {r: auc for r, auc, _, _ in bmia.aucs(device=dev)}
    bench_s = time.perf_counter() - t0
    cpu_aucs = {r: auc for r, auc, _, _ in bmia.aucs(device="cpu")}
    for r, auc in card_aucs.items():
        if not (math.isfinite(auc) and 0.0 <= auc <= 1.0):
            raise AssertionError(f"mia: AUC {auc} at {r} rounds")
        print(f"mia/dfedavgm/rounds{r},0.0,auc={auc:.3f}", flush=True)
    # quantize_pytree on the 2NN, stochastic: T1 splits the key a leaf,
    # T2 draws each leaf's noise; the CPU runs the plain versions.
    p = init_2nn(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    delta = {n: t + 0.01 * torch.randn(t.shape, device=dev, generator=gen)
             for n, t in p.items()}
    pytree = {}
    for bits in (8, 4):
        cfg = QuantConfig(bits=bits)
        reset_launch_counts()
        wc, sc = quantize_pytree(delta, cfg, prng.PRNGKey(9, device=dev))
        torch.cuda.synchronize()
        counts = launch_counts()
        wp, sp = quantize_pytree({n: t.cpu() for n, t in delta.items()},
                                 cfg, prng.PRNGKey(9))
        same = all(torch.equal(wc[n].cpu(), wp[n])
                   and torch.equal(sc[n].cpu(), sp[n]) for n in wp)
        if not same or counts["threefry_uniform"] != len(p):
            raise AssertionError(f"mia: quantize_pytree at {bits} bits: "
                                 f"bitwise {same}, launches {counts}")
        pytree[bits] = {"bitwise": True, "t1": counts["threefry_split"],
                        "t2": counts["threefry_uniform"]}
    reset_launch_counts()
    init = attack_init(MIA_ATTACK_D, seed=0, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    k1, k2 = prng.split_plain(prng.PRNGKey(0, device=dev))
    plain = {"w1": prng.normal_plain(k1, (MIA_ATTACK_D, 64))
             * float(np.float32(1 / np.sqrt(MIA_ATTACK_D))),
             "w2": prng.normal_plain(k2, (64, 2))
             * float(np.float32(1 / np.sqrt(64)))}
    if not all(torch.equal(init[n], plain[n]) for n in plain) or (
            counts["threefry_normal"] != 2):
        raise AssertionError(f"mia: the attack init differs from its plain "
                             f"version or launched {counts}")
    rec = {"eager_launches": {k: v for k, v in launches.items() if v},
           "graph_kernel_nodes": {k: v for k, v in graph.items() if v},
           "models": models, "auc_card": card_aucs, "auc_cpu": cpu_aucs,
           "bench_s": bench_s, "quantize_pytree": pytree,
           "attack_init": {"bitwise": True,
                           "launches": {k: v for k, v in counts.items()
                                        if v}},
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"mia": rec}), flush=True)
    return rec


def bench_kernels_phase(dev, flush=None) -> dict:
    """Phase "bench_kernels": :mod:`repro_torch.bench.kernels` on the card
    (its rows printed, the reference's and the entry points' twins), its
    launches counted, then its three kernels at
    its N = 1 048 576: B6 (``quantize_pack``, deterministic) at 8 and 4
    bits on the padded planar view, B8 (``decode_apply_ring``, the flat
    entry: one launch) at 8 and 4 bits, B3 (``momentum_update_flat``),
    each bitwise with its plain version and timed (``timed``) against its
    bound; B3 beside ``torch._fused_sgd_`` on the same vector."""
    from repro_torch.bench import kernels as bk
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import (decode_apply_ring, encode_delta,
                                         momentum_update_flat)
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.kernels.ref import (momentum_sgd_ref, pad_planar,
                                         quantize_pack_ref)
    if flush is None:
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    print(json.dumps({"bench_kernels_prediction": KBENCH_PREDICTION}),
          flush=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    rows = bk.run(device=dev)
    torch.cuda.synchronize()
    launches = launch_counts()
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}", flush=True)
    x, v, g = bk.operands(bk.N, dev)
    n = x.numel()
    out = {}

    def new():
        return {"max_abs_err": 0.0, "max_ulp": 0, "checks": []}

    for bits in (8, 4):
        r = new()
        x2d = pad_planar(x, bits)
        _, s = encode_delta(x, bits, stochastic=False)
        words = quantize_pack(x2d, s, bits)
        check_words(f"B6 1M b{bits}", words, quantize_pack_ref(x2d, s, bits))
        timed(r, "", lambda: quantize_pack(x2d, s, bits), flush)
        timed(r, "plain_", lambda: quantize_pack_ref(x2d, s, bits), flush)
        r["bound_ms"], r["bound_by"] = bound(nbytes(x2d, words, s), 4 * n)
        r["library_ms"] = None
        r["shape"] = f"x f32 [{x2d.shape[0]}, {x2d.shape[1]}] ({n}), one " \
                     f"scale -> words [{words.numel()}], {bits} bits"
        r["launches"] = launches["quantize_pack"]
        out[f"quantize_pack_1m_b{bits}"] = r
        r = new()
        sc = torch.stack([s, 0.5 * s, 2 * s])
        got = decode_apply_ring(x, words, words, words, sc, bits=bits,
                                w_self=bk.W_SELF, w_nb=bk.W_NB)
        check_floats(r, f"B8 1M b{bits}",
                     [(got, bk.ring_plain(x, words, sc, bits))])
        if r["max_ulp"]:
            raise AssertionError(f"B8 1M b{bits}: {r['max_ulp']} ulp")

        def ring(b=bits, w=words, c=sc):
            return decode_apply_ring(x, w, w, w, c, bits=b,
                                     w_self=bk.W_SELF, w_nb=bk.W_NB)
        timed(r, "", ring, flush)
        timed(r, "plain_", lambda b=bits, w=words, c=sc: bk.ring_plain(
            x, w, c, b), flush)
        r["bound_ms"], r["bound_by"] = bound(
            nbytes(x, words, words, words, sc, got), 12 * n)
        r["library_ms"] = None
        r["shape"] = f"x f32 [{n}], three streams [{words.numel()}], " \
                     f"{bits} bits -> [{n}]"
        r["launches"] = launches["dequant_mix"]
        out[f"dequant_mix_1m_b{bits}"] = r
    r = new()
    y2, v2 = momentum_update_flat(x, v, g, 0.01, 0.9)
    y_ref, v_ref = momentum_sgd_ref(x, v, g, 0.01, 0.9)
    check_words("B3 1M", torch.cat([y2, v2]).view(torch.int32),
                torch.cat([y_ref, v_ref]).view(torch.int32))
    check_floats(r, "B3 1M", [(y2, y_ref), (v2, v_ref)])
    timed(r, "", lambda: momentum_update_flat(x, v, g, 0.01, 0.9), flush)
    timed(r, "plain_", lambda: momentum_sgd_ref(x, v, g, 0.01, 0.9), flush)
    params, bufs = [x.clone()], [v.clone()]
    timed(r, "library_", lambda: torch._fused_sgd_(
        params, [g], bufs, weight_decay=0.0, momentum=0.9, lr=0.01,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False),
        flush)
    r["bound_ms"], r["bound_by"] = bound(nbytes(x, v, g, y2, v2), 3 * n)
    r["shape"] = f"y, v, g f32 [{n}] -> y', v'"
    r["launches"] = launches["momentum_sgd"]
    out["momentum_sgd_1m"] = r
    rec = {"rows": rows, "launches": {k: c for k, c in launches.items()
                                      if c}, "kernels": out}
    print(json.dumps({"bench_kernels": {
        k: {f: r[f] for f in ("ms", "clean_ms", "call_ms", "host_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_ulp", "launches")}
        for k, r in out.items()}}), flush=True)
    return rec


def wire_phase(dev, flush=None) -> dict:
    """Phase "wire": the codec option on the quickstart (8-bit stochastic
    lemma5 on the ring plan). The port has one codec, so ROUNDS eager
    rounds at each of the reference's values (``"auto"``, ``"seq"``,
    ``"planar"``) from one state launch B1 and B2 once a round each and
    give bitwise the same params, losses and consensus every round; then
    the driver (``launch.train.main``, reduced SmolLM-135M) for 2 rounds
    at ``--wire seq`` and ``--wire planar``: B1 and B2 twice each, the
    same losses."""
    import dataclasses
    from repro_torch import prng
    from repro_torch.core import init_round_state, make_round_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    del flush
    print(json.dumps({"wire_prediction": WIRE_PREDICTION}), flush=True)
    t_phase = time.perf_counter()
    data, fed, stacked, spec, cfg, loss_fn, _ = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    wire_kernels = ("quantize_pack_buffer", "dequant_mix_buffer")
    arms = {}
    for wire in WIRES:
        step = make_round_step(loss_fn, dataclasses.replace(cfg, wire=wire),
                               spec, device=dev)
        st = init_round_state(stacked, prng.PRNGKey(1))
        losses, cons, ms, params = [], [], [], []
        total = {k: 0 for k in KERNEL_SOURCES}
        for b in batches:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            st, met = step(st, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = launch_counts()
            total = {k: total[k] + counts[k] for k in total}
            losses.append(met["loss"])
            cons.append(met["consensus_dist"])
            params.append(st.params)
        if any(total[k] != ROUNDS for k in wire_kernels):
            raise AssertionError(f"wire {wire!r}: launches {total}")
        arms[wire] = {"losses": torch.stack(losses), "cons": torch.stack(cons),
                      "params": params, "launches": total,
                      "round_ms_median": statistics.median(ms[1:])}
    ref = arms["planar"]
    for wire, a in arms.items():
        if not (torch.equal(a["losses"], ref["losses"])
                and torch.equal(a["cons"], ref["cons"])
                and all(torch.equal(x[n], y[n]) for x, y in zip(
                    a["params"], ref["params"]) for n in x)):
            raise AssertionError(f"wire: the {wire!r} rounds differ from "
                                 "the planar ones")
    driver = {}
    for wire in ("seq", "planar"):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, met = train.main(WIRE_DRIVER_ARGV + ["--wire", wire])
        torch.cuda.synchronize()
        counts = launch_counts()
        driver[wire] = {"loss": float(met["loss"]),
                        "consensus_dist": float(met["consensus_dist"]),
                        "s": time.perf_counter() - t0,
                        "b1_b2": [counts[k] for k in wire_kernels]}
    if any(d["b1_b2"] != [2, 2] for d in driver.values()) or (
            driver["seq"]["loss"] != driver["planar"]["loss"]):
        raise AssertionError(f"wire: the driver's runs {driver}")
    rec = {"rounds_bitwise": True,
           "launches": {w: {k: a["launches"][k] for k in wire_kernels}
                        for w, a in arms.items()},
           "round_ms_median": {w: a["round_ms_median"]
                               for w, a in arms.items()},
           "loss_last": float(ref["losses"][-1]), "driver": driver,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"wire": rec}), flush=True)
    return rec


# Phases ``--only`` can run alone (after the build), for work on one path.
ONLY = {"pool": pool_phase, "telemetry": telemetry_phase,
        "production": production_phase, "mesh": mesh_phase,
        "mesh2d": mesh2d_phase, "cards": cards_phase, "mia": mia_phase,
        "bench_kernels": bench_kernels_phase, "wire": wire_phase}


def main() -> int:
    if "--prod-cpu-archs" in sys.argv:      # production_archs' CPU side
        prod_cpu_archs(sys.argv[sys.argv.index("--prod-cpu-archs") + 1])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    t0 = time.perf_counter()
    per_source = native.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": per_source}), flush=True)
    if "--only" in sys.argv:
        for name in sys.argv[sys.argv.index("--only") + 1].split(","):
            t0 = time.perf_counter()
            ONLY[name](dev)
            print(json.dumps({"phase": name,
                              "s": time.perf_counter() - t0}), flush=True)
        print(card)
        return 0

    # First, while the profiler's traces of a fresh process are whole.
    entry = entry_points(dev)
    print(json.dumps(entry), flush=True)
    check_entry_points(entry)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    floor = floor_time(flush)
    print(json.dumps({"floor": floor}), flush=True)
    rec = kernel_checks(dev, flush)
    rec.update(keychain_checks(dev, flush))
    print(json.dumps(plan_times(dev, flush)), flush=True)
    reference_checks(dev)
    counts = {}
    counts["unfused"], unfused_ms, losses = round_path(dev, False)
    counts["fused"], fused_ms, fused_losses = round_path(dev, True)
    counts["ops"] = ops_path(dev)
    round_breakdown(dev)
    host_groups(dev)                  # the eager round's host time first
    captured = {"unfused": captured_rounds(dev, False),
                "fused": captured_rounds(dev, True)}
    wide = full_width(dev)
    sched, counts["schedules"] = schedules_phase(dev)
    captured["schedules"] = sched["partial_exact"]
    schedule_kernel_checks(dev, flush, rec)
    sched_rows = schedule_bench_path(dev)
    asyn, counts["async"] = async_phase(dev, flush, rec)
    captured["async"] = asyn["decay"]
    pool, counts["pool"] = pool_phase(dev, flush, rec)
    captured["pool"] = pool["sync"]
    tel, counts["telemetry"] = telemetry_phase(dev, pool["breakdown"])
    times = round_times(dev)
    rows = bench_path(dev)
    prod = production_phase(dev, flush)
    mesh = mesh_phase(dev, flush)
    mesh2d = mesh2d_phase(dev, flush)
    mia = mia_phase(dev, flush)
    kbench = bench_kernels_phase(dev, flush)
    wire = wire_phase(dev)
    fig8 = [r for r in rows if r["name"].startswith("fig8/")]
    counts["fig8"] = {k: sum(r["eager_launches"][k] for r in fig8)
                      for k in KERNEL_SOURCES}
    captured["fig8"] = fig8[0]

    table = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = rec[name]
        path = KERNEL_PATH[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[path][name],
                      "path": path, "max_abs_err": r["max_abs_err"],
                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                      "library_ms": r.get("library_ms"),
                      "call_ms": r["call_ms"],
                      "max_ulp": r["max_ulp"], "shape": r["shape"],
                      "captured_round_nodes": captured[path]["kernel_nodes"][
                          name] if path in captured else None,
                      "telemetry_launches": counts["telemetry"][name],
                      **{k: r[k] for k in EXTRA_KEYS if k in r}})
        full = prod["kernels"].get({"momentum_sgd": "momentum_sgd_f32"}.get(
            name, name))
        if full is not None:
            table[-1]["smollm_full_width"] = {
                f: full[f] for f in ("shape", "ms", "clean_ms", "call_ms",
                                     "host_ms", "bound_ms", "bound_by")}
            table[-1]["production_launches"] = prod["arms"]["q8"][
                "launches"][name]
        # The mesh phase's eager quickstart rounds (4 shards of cuda:0).
        mesh_counts = {arm: mesh["rounds"][arm]["launches"][name]
                       for arm in ("unfused", "fused")}
        if any(mesh_counts.values()):
            table[-1]["mesh_launches"] = mesh_counts
        if name in mesh["kernels"]:
            table[-1]["mesh_extended"] = {
                f: mesh["kernels"][name][f] for f in (
                    "shape", "ms", "clean_ms", "call_ms", "plain_ms",
                    "bound_ms", "bound_by")}
        mesh2d_counts = mesh2d["rounds"]["launches"][name]
        if mesh2d_counts:
            table[-1]["mesh2d_launches"] = mesh2d_counts
        if mesh2d["fused"]["launches"][name]:
            table[-1]["mesh2d_fused_launches"] = mesh2d["fused"][
                "launches"][name]
    # The 2D mesh's shapes (the mesh2d phase): B1 through its tensor-noise
    # entry and B2 at a quickstart cell, their launches the 2D rounds';
    # T2 at SmolLM-135M's largest leaf for 8 keys, its launches the 2D
    # driver run's.
    for name, kernel, launches in (
            ("quantize_pack_buffer_noise_2d_cell", "quantize_pack_buffer",
             mesh2d["rounds"]["launches"]["quantize_pack_buffer"]),
            ("dequant_mix_buffer_2d_cell", "dequant_mix_buffer",
             mesh2d["rounds"]["launches"]["dequant_mix_buffer"]),
            ("threefry_uniform_smollm_leaf", "threefry_uniform",
             mesh2d["driver"]["launches"].get("threefry_uniform", 0))):
        r = mesh2d["kernels"][kernel]
        table.append({"name": name, "route": "cuda",
                      "source": KERNEL_SOURCES[kernel][0],
                      "replaces": KERNEL_SOURCES[kernel][1],
                      "launches": launches, "path": "mesh2d",
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": None,
                      "call_ms": r["call_ms"], "max_ulp": r["max_ulp"],
                      "shape": r["shape"], "clean_ms": r["clean_ms"],
                      "host_ms": r["host_ms"],
                      "plain_call_ms": r["plain_call_ms"]})
    # bench.kernels' vector (N = 1 048 576): B6 and B8 at 8 and 4 bits, B3;
    # their launches the bench's run on the card.
    for name, kernel in (("quantize_pack_1m_b8", "quantize_pack"),
                         ("quantize_pack_1m_b4", "quantize_pack"),
                         ("dequant_mix_1m_b8", "dequant_mix"),
                         ("dequant_mix_1m_b4", "dequant_mix"),
                         ("momentum_sgd_1m", "momentum_sgd")):
        r = kbench["kernels"][name]
        table.append({"name": name, "route": "cuda",
                      "source": KERNEL_SOURCES[kernel][0],
                      "replaces": KERNEL_SOURCES[kernel][1],
                      "launches": r["launches"], "path": "bench_kernels",
                      **{f: r.get(f) for f in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "call_ms", "max_ulp",
                          "shape", "clean_ms", "host_ms", "plain_call_ms",
                          "library_clean_ms")}})
    b3 = prod["kernels"]["momentum_sgd_bf16"]
    # B3 on bf16 leaves: the same kernel source, its bf16 instantiation;
    # its launches are the 8-bit full-width arm's (every leaf bf16).
    table.append({"name": "momentum_sgd_bf16", "route": "cuda",
                  "source": KERNEL_SOURCES["momentum_sgd"][0],
                  "replaces": KERNEL_SOURCES["momentum_sgd"][1],
                  "launches": prod["arms"]["q8"]["launches"]["momentum_sgd"],
                  "path": "production", "max_abs_err": b3["max_abs_err"],
                  "ms": b3["ms"], "plain_ms": b3["plain_ms"],
                  "bound_ms": b3["bound_ms"], "bound_by": b3["bound_by"],
                  "library_ms": b3["library_ms"], "call_ms": b3["call_ms"],
                  "max_ulp": b3["max_ulp"], "shape": b3["shape"],
                  "clean_ms": b3["clean_ms"], "host_ms": b3["host_ms"],
                  "plain_call_ms": b3["plain_call_ms"],
                  "library_clean_ms": b3["library_clean_ms"]})
    print(json.dumps({"round_ms_median": {"unfused": unfused_ms,
                                          "fused": fused_ms},
                      "round_ms_median_in_turns": times[
                          "round_ms_median_by_pass"],
                      "captured_graph_nodes": {
                          k: v["graph_nodes"] for k, v in captured.items()},
                      "loss_first_last": {
                          "unfused": [losses[0], losses[-1]],
                          "fused": [fused_losses[0], fused_losses[-1]]},
                      "full_width": {
                          k: {f: v[f] for f in ("round_ms_median",
                                                "graph_nodes",
                                                "loss_first_last")}
                          for k, v in wide.items()},
                      "schedules": {
                          k: {"round_ms_median": v["round_ms_median"],
                              "graph_nodes": v["graph_nodes"],
                              "loss_first_last": [v["loss"][0],
                                                  v["loss"][-1]]}
                          for k, v in sched.items()},
                      "schedule_benches": {
                          r["name"]: [r["us_per_round"],
                                      r["eager_us_per_round"]]
                          for r in sched_rows},
                      "b2_k11": rec["dequant_mix_buffer"]["k11"],
                      "async": {
                          k: {"event_ms_median": asyn[k]["event_ms_median"],
                              "replay_device_ms": asyn[k][
                                  "replay_device_ms"],
                              "graph_nodes": asyn[k]["graph_nodes"]}
                          for k in ASYNC_ARMS},
                      "async_bench": {k: asyn["bench"][k] for k in (
                          "captured_us_per_event", "eager_us_per_event",
                          "speedup_virtual_wallclock")},
                      "pool": {
                          "sync_round_ms_median": pool["sync"][
                              "round_ms_median"],
                          "walk_round_ms_median": pool["walk"][
                              "round_ms_median"],
                          "async_event_ms_median": pool["async"][
                              "event_ms_median"],
                          "breakdown_ms": pool["breakdown"][
                              "part_ms_median"],
                          "hidden_share": pool["breakdown"]["hidden_share"],
                          "bench_rounds_per_sec": {
                              r["m"]: r["rounds_per_sec"]
                              for r in pool["bench"]["pool_scaling"]},
                          "bench_pooled_over_resident": pool["bench"][
                              "compare"]["pooled_over_resident_cost"]},
                      "telemetry": {
                          "graph_nodes": {k: tel[k]["graph_nodes"]
                                          for k in tel if k != "overhead"},
                          "overhead_ratio": {
                              k: v["overhead_ratio"]
                              for k, v in tel["overhead"].items()},
                          "reference_gate": REFERENCE_OVERHEAD,
                          "pool_round_ms_median": tel["pool"][
                              "round_ms_median"],
                          "pool_span_ms_per_round": tel["pool"][
                              "span_ms_per_round"]},
                      "production": {
                          "round_ms_median": {
                              k: v["round_ms_median"]
                              for k, v in prod["arms"].items()},
                          "device_busy_share": {
                              k: v["profiled_round"]["device_busy_share"]
                              for k, v in prod["arms"].items()},
                          "loss": {k: v["loss"]
                                   for k, v in prod["arms"].items()},
                          "serve": {k: prod["serve"][k] for k in (
                              "prefill_ms", "decode_ms_per_token",
                              "tok_per_s")},
                          "captured_max_abs_diff": prod["captured"][
                              "max_abs_diff_vs_eager"],
                          "phase_s": prod["phase_s"]},
                      "mesh": {
                          "round_ms_median": {
                              k: v["round_ms_median"]
                              for k, v in mesh["rounds"].items()},
                          "placed_round_ms_median": mesh["placed"][
                              "round_ms_median"],
                          "lane_slots": mesh["placed"]["lane_slots"],
                          "driver_round_ms": mesh["driver"]["round_ms"],
                          "phase_s": mesh["phase_s"]},
                      "mesh2d": {
                          "round_ms_median": mesh2d["rounds"][
                              "round_ms_median"],
                          "replay_device_ms": mesh2d["rounds"][
                              "replay_device_ms"],
                          "graph_nodes": mesh2d["rounds"]["graph_nodes"],
                          "driver_peak_gib": mesh2d["driver"]["peak_gib"],
                          "fused_graph_nodes": mesh2d["fused"][
                              "graph_nodes"],
                          "fused_replay_device_ms": mesh2d["fused"][
                              "replay_device_ms"],
                          "phase_s": mesh2d["phase_s"]},
                      "mia": {k: mia[k] for k in ("auc_card", "auc_cpu",
                                                  "phase_s")},
                      "wire": {k: wire[k] for k in ("round_ms_median",
                                                    "phase_s")}}))
    print(card)
    print(json.dumps({"kernels": table, "floor_ms": floor["ms"],
                      "floor_clean_ms": floor["clean_ms"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
