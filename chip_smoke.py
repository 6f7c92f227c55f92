#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``edl_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's serving and training paths, its elastic runtime,
its serving fleet, its control plane, its fleet market, its model zoo,
its observability (flight journal, profile windows, merged timeline),
its MoE family behind ``edl serve`` and ``edl route``, and its chaos
harness on the card, and exits non-zero on the first failure.  Phases,
in order:

1. **Device** — prints the card's name and power limit (nvidia-smi);
   turns TF32 off for float32 matmuls and convolutions.
2. **Build** — compiles every hand-written kernel from the sources in
   the checkout (``edl_tpu_torch/ops/csrc``), all ``nvcc`` started
   together, and prints the build seconds.
3. **Kernels against their plain versions** — each kernel's wrapper on
   card tensors at the shapes the main paths give it (and ragged,
   masked edge cases), held against the plain PyTorch version on the
   same inputs with a stated tolerance (attention outputs also row by
   row, against each row's own scale; at T=32768 planted faults show
   that the row check rejects a kernel that drops late rows or a
   slot); then timed at the main path's largest shape beside its plain
   version, its bound and, where one exists, one PyTorch library call
   computing the same function.
   B1 flash forward (the edges of its 192-row Q and 128-key K/V tiles,
   keys shorter than one tile, D = 128, f16, each run twice for bit
   identity; also at the long-context shape [1, 32768, 12, 64], against
   its plain version head by head), B2 flash backward, B3
   streaming-K flash backward (forced at small shapes, by dispatch past
   the merged range, with slots that are not a multiple of its 128-key
   tile, each run twice for bit identity, and at [1, 32768, 12, 64]
   against its plain version head by head, beside B2 forced on the same
   inputs), B4-B6 fused tied-vocab cross entropy (also at the
   long-context path's N = 32768; dY and dE also row by row, with
   planted faults the row checks must reject).  B2 and B4-B6 run twice
   for bit identity; B3 is timed forced on B2's inputs and B4-B6 also at
   N = 32768.  B1 and B3 at [1, 32768, 12, 64], B2 at [8, 2048, 12, 64]
   and B4-B6 at N = 16384 must not be slower than their first versions
   (FIRST_VERSION_MS).  ``transformer_base``'s shapes: B1 and B2 at
   [64, 256, 8, 64] under its padding masks (``src != 0`` non-causal,
   ``tgt != 0`` causal), B4-B6 at N = 16320, V = 32000, D = 512, each
   held, run twice and timed beside its bound and a library call (SDPA
   with the boolean mask; ``matmul(Y, E.T)`` for B4).
4. **Serving** — full-width ``transformer_lm`` (seeded random weights)
   behind ``DecodeEngine`` + ``TokenContinuousBatcher`` (monolithic
   prefill) + ``ServingServer`` on loopback; four concurrent
   ``/generate`` requests (one streaming).  Launch counts are zeroed
   just before and read just after, and the served tokens are checked
   against a full-recompute greedy run through the port's own forward.
5. **Training** — full-width ``transformer_lm`` (seeded, float32
   parameters, bf16 compute) in the port's ``Trainer`` (Adam, lr 1e-3)
   at global batch 8 x 2048 tokens from ``ShardedDataIterator`` over
   ``synthetic_dataset``: two runs of step 0 from one state must give
   bit-identical loss and gradients; one warm-up step and five timed
   steps, each with its launch counts zeroed before and read after
   (12 ``flash_fwd``, 12 ``flash_bwd``, one each of ``xent_fwd``,
   ``xent_dy``, ``xent_de``); the loss must be finite and fall; and at
   batch 2 the kernel path's step-0 loss and gradients are held
   against the plain path's (plain attention autograd +
   ``tied_vocab_xent``).
6. **Long-context training** — full-width ``longcontext_lm`` at
   T=32768, global batch 1, in the same ``Trainer``: step 0 twice from
   one state bit-identical; one warm-up step and three timed steps, each
   with 12 ``flash_fwd``, 12 ``flash_bwd_streamk``, no ``flash_bwd`` and
   one each of ``xent_fwd``, ``xent_dy``, ``xent_de``; the loss must
   fall; and at batch 1, T=2048 with B3 forced at 8 slots, the kernel
   path's step-0 loss and gradients are held against the plain path's
   (the plain path cannot run at T=32768).
7. **Elastic** — the training phase's configuration (full-width
   ``transformer_lm``, 8 x 2048, seed 0, Adam at 1e-3) through
   ``ElasticTrainer`` with a ``LocalCoordinator`` and a
   ``HostDRAMStore`` spilling under a temp directory, checkpoint
   interval 4: run A, 12 steps at pipeline depth 2; run B, the same with
   a graceful generation bump at step 6 (a standby member registers, the
   active one leaves: flush, re-form, restore) and the device state
   lost at step 9 (replay from the step-8 checkpoint); run C, as A at
   depth 0; run D, a cold start from B's spill as it stood at the kill.
   B, C and D must give A's loss stream bit for bit, every dispatched
   step 12/12/1/1/1 launches, B's resizes graceful True/False with
   ``restored_step`` 6/8, ``replayed_steps`` 0/1, ``compiles`` 0, and
   no pinned allocation inside the bump's barrier; then one short
   ``launcher.run`` (4 steps, no coordinator address) must match A's
   first steps.  Prints the checkpoint bytes, flush seconds and
   device-to-host GB/s, each resize's phase seconds, the replay and
   cold-start seconds, and steady-state step ms and device busy share
   at depth 2 and 0, with the card's name and power limit.
8. **Serving replica** — the pod entry point, ``serve_run``, serving
   what the port's trainer spills.  ``Trainer`` (the training phase's
   configuration) with a ``HostDRAMStore`` spilling to a temp directory
   spills step 2; ``serve_run(checkpoint_dir=..., coordinator_addr=...)``
   (an in-process ``CoordinatorServer``) loads it, warms and registers.
   Prefix traffic: one cold ``/generate``, then 7 concurrent, all
   sharing a 1536-token prefix (96 blocks) with tails of 64-320 tokens,
   32 new tokens each: every warm receipt reports 96 reused blocks, the
   tokens equal the full-recompute greedy (``_recompute_check``), and
   afterwards no block is owned and at least 96 sit cached.
   Interference: 4 short prompts decode 64 tokens, a 1900-token prompt
   arrives after 8 of theirs, in the replica's chunked posture and in a
   ``chunked_prefill=False`` batcher on the same engine (12 ``flash_fwd``
   a prefill; 0 in the chunked posture): the short sequences'
   inter-token p95 while the long one prefills, its TTFT, and its first
   token the same in both.  Hot swap: 2 more steps spill step 4;
   ``/healthz`` reports it, and the next request reuses 0 blocks and
   equals the recompute on the step-4 weights.  Drain: ``POST /drain``
   with 2 requests in flight; both finish, a later ``/generate`` is 503
   with Retry-After, no block is owned, and the replica has left the
   coordinator's members.  Each part's launch counts are zeroed just
   before it and read just after.
9. **Serving fleet** — a ``CoordinatorServer``, two ``ServingReplica``s
   (A and B: ``DecodeEngine`` of 1025 blocks of 16, chunked posture,
   ``HTTPCoordinator``, telemetry reports) loading one step-4 checkpoint
   of the training configuration from a ``HostDRAMStore``, and the
   router (``route_run``) in front; all traffic through the router's
   port.  Spread and affinity: two groups of a 1536-token prefix with 4
   tails each, 32 new tokens, streamed; the groups land on different
   replicas, at least 3 of 4 of a group on its first request's replica
   with 96 reused blocks each, tokens equal to the full recompute
   (margin rule); the TTFT p50 through the router and straight to the
   replica.  Drain with migration: a 1024-token prompt, 256 new tokens,
   streamed to A; after 16 tokens a drain intent to the router, then
   ``POST /drain {"migrate_to": B}`` on A: the ack comes with 0 in
   flight while the stream is short of 256, the stream is whole and
   equal bit for bit to the unmigrated run decoding alone on B, B's
   imported blocks are A's exported bytes (65 blocks x 589,824 B), the
   router steered before the drain started and absorbed no 503, A left
   the coordinator; prints the drain, gather, push and import seconds
   and GB/s beside the unmigrated run's last 240 tokens.  Re-drive: A
   afresh and B in the monolithic posture; A dies (server severed,
   batchers stopped, no drain) after 16 tokens of a stream; the router
   resumes it on B from prompt + prefix: 12 ``flash_fwd`` for that
   leg, no duplicate, drop or restart line, the recompute check; prints
   the gap at the kill and the phase's peak memory.  Each part's launch
   counts are zeroed just before it and read just after.
10. **Control plane** — a ``Controller`` and its ``Autoscaler`` over a
    FakeKube of two nodes, ``gpu-0`` (this machine: its cards, CPUs and
    memory) and ``gpu-1`` (one GPU, simulated: no process behind it),
    size the ``TrainingJob`` ``lm`` (``transformer_lm`` on ``h100-1``,
    min 1, max 2, global batch 8, checkpoint interval 4, a temp
    checkpoint dir) through an
    in-process ``CoordinatorServer`` found via
    ``EDL_COORD_ADDR_TEMPLATE``.  Its trainer pod is ``python -m
    edl_tpu_torch.launcher`` (12 steps, the card, full width) started
    with exactly the env the job parser rendered, the downward-API
    values and the coordinator's address substituted and a telemetry
    report every 0.1 s (``EDL_TELEMETRY_INTERVAL``) added.  The autoscaler
    grows ``lm`` to 2 (prewarm 2 announced while the trainer is the
    coordinator's only member, so the world stays 1), sheds it to 1
    when the pending ``lm-b`` arrives (placed on ``gpu-1``), and the
    trainer's completion marks ``lm`` Succeed (its coordinator workload
    deleted, its trainer workload kept).  Checks: exit 0; parallelism
    1 -> 2 -> 1; states Running then Succeed; one generation; 12 steps
    of 12/12/1/1/1 launches in the pod; its losses bit-identical to
    ``launcher.run`` in-process; the autoscaler's observed step rate
    (from the trainer's telemetry reports), its mean over the decisions,
    within 20% of the history's over the same reports (the steps the
    history logged between their arrivals, over the time between the
    arrivals on the smoke's clock); ``local-run`` on a YAML of the same
    configuration (``--steps 4``) printing world sizes [1] and the
    in-process run's step-3 loss.  Prints each ``Controller.run_once``
    ms, the PUT-to-retarget ms, submission to the first harvested
    step, the trainer's wall time and peak memory, and the host cost of
    ``Autoscaler.run_once`` over 64 nodes x 8 GPUs, read as
    ``KubectlAPI`` reads a cluster's nodes, with 32 elastic jobs of
    h100-1/8/16.
11. **Fleet market** — four GPUs in a FakeKube: ``gpu-0`` (this
    machine) and three simulated 1-GPU nodes.  A ``Controller`` holds two
    prioritized jobs, so ``_maybe_attach_fleet`` rides the GPU market's
    arbiter on its ``Autoscaler``: ``hi`` (priority 10, min = max = 1,
    the launcher pod on the card at full width, as phase 10 starts it)
    and ``lo`` (priority 1, sizes 1 and 2: two launcher pods in a gloo
    world on the CPU at the tiny size, since a world of two needs two
    NCCL ranks and this machine has one card).  The serving fleet
    ``api`` (replica A by ``serve_run`` from a spilled step-4 checkpoint,
    full width, monolithic prefill, behind ``route_run``; its own
    coordinator and a ``ServingLane`` with a 0.5 s TTFT bound) bids with
    priority 100.  Calm (2 ticks of ``Controller.run_once``, as ``cli
    controller`` ticks, 0.5 s apart) changes nothing; 24 concurrent streams of 1024-1900-token
    prompts (32 new tokens) make the lane ask for 2 replicas: the
    arbiter preempts ``lo`` 2 -> 1 (both members stop at one agreed
    step, the world acks, and ``lo``'s workload shrinks to 1) before
    ``api``'s retarget; the controller's own tick keeps ``lo``'s target
    and workload at 1 through the spike; the glue starts
    replica B on the card from the checkpoint's DRAM copy; once the
    traffic ends, ``api`` sheds B after
    its hold ticks, migrating a live 256-token generation to A
    (bit-identical to the unmigrated run; the router steered first, no
    503), and ``lo`` grows back to 2.  Holdings {api 2, hi 1, lo 1} in
    the spike, {api 1, hi 1, lo 2} at the end, four transitions under
    four trace ids, ``hi`` in one generation at world 1 with its first
    12 losses bit-identical to ``launcher.run``, 12 ``flash_fwd`` a
    prefill on A and B, the tokens of both against the full recompute,
    and A's swap and a planted retry in the serving coordinator's merged
    ``/telemetry``; up to 8 spike streams of each replica, spread over
    its admissions, are held to the full recompute.  Prints the arbiter
    and controller tick ms, spike to B's first
    token, ``lo``'s decision to its world ack, the shed's drain and
    migrated blocks, TTFT p50/p95 before, during and after, GPUs over
    time, and the peak memory.
12. **Model zoo** — the BASELINE families at full width, seed 0, Adam
    at lr 1e-3: ``fit_a_line`` (global batch 64), ``mnist`` (256),
    ``resnet50`` (64 x 224 x 224 x 3) and ``transformer_base`` (64 x
    256 tokens).  Each in a ``Trainer``: step 0 twice from one state
    bit-identical; one warm-up and five timed steps (18 ``flash_fwd``,
    18 ``flash_bwd``, no ``flash_bwd_streamk`` and one each of
    ``xent_fwd``, ``xent_dy``, ``xent_de`` a ``transformer_base`` step,
    none for the others), the loss finite and the batch-0 loss falling;
    step ms, examples/s (tokens/s), MFU from the port's
    ``flops_per_example`` and peak memory.  ``transformer_base``'s
    kernel path against phase 5's plain path and float32 on 16 x 256
    tokens (phase 5's 4096): the step-0 loss at 1e-3 relative, each
    gradient no farther from float32 than twice the plain path's
    distance + 1e-2 of scale, and two planted faults that must break
    that rule (``_zoo_transformer_parity``).  Each through ``ElasticTrainer``
    (``LocalCoordinator``, ``HostDRAMStore``, checkpoint interval 2): run
    A 8 steps; run B a graceful bump at step 3 and the device state lost
    once step 6 has run; B's loss stream A's bit for bit.  Each behind
    ``InferenceEngine``, ``ContinuousBatcher`` and ``ServingServer`` on
    loopback: 16 concurrent ``POST /predict``, the replies equal to
    ``predict_fn`` run directly (labels and tokens past the margin rule,
    ``pred`` to bf16 tolerance); the /predict p50 and p95.
13. **Observability** — phase 7's configuration through
    ``ElasticTrainer`` behind an in-process ``CoordinatorServer``,
    reached over HTTP as a pod reaches it, with the flight recorder's
    JSONL spill on, the launcher's world builder (each generation's
    world formed as one NCCL rank: the process answers for both members
    of the retargeted world), checkpoint interval 4, and profile
    windows of 3 steps (``EDL_PROFILE_DIR``, ``EDL_PROFILE_AT_STEP=1``,
    ``EDL_PROFILE_EACH_RESIZE=1``).  After step 5 a prewarm hint and a
    retarget to 2 go out under one trace id; 10 steps, then 3 timed
    with no window.  Checks: the loss stream equals phase 7's run A bit
    for bit; 12/12/1/1/1 launches a step; no pinned allocation in the
    resize; the coordinator's journal holds ``coord.plan``,
    ``coord.world_acked``, ``resize``, ``checkpoint.save``,
    ``step.first``, ``prewarm.hint`` and two ``profile.window`` pairs
    opening at steps 1 and 5, every kind registered; the member's
    events from the hint to ``step.first`` all carry the trace id, the
    resize with flush, world formation and restore timings; each
    window's file annotates exactly its 3 steps and its device lane
    holds 3 x 12 ``flash_fwd_kernel``, 3 x 12 ``flash_bwd_dkdv_kernel``
    and 3 each of ``xent_fwd_kernel``, ``xent_dy_kernel`` and
    ``xent_de_kernel``, what the wrappers counted while it was open;
    ``edl trace <coordinator> --summary`` writes a trace whose
    traced ``resize`` slice holds its three phase slices and names the
    trace id's chain once; the spill, the coordinator's lane for the
    member and the member's ring hold the same events, and ``edl trace
    --journal`` on the spill renders the live lane's slices; ``edl
    metrics --prom`` shows ``edl_flight_spill_dropped_total``.  Prints
    the step ms with a window open and with none, the resize's phase
    seconds as the timeline reads them, and the trace files' bytes.
14. **MoE** — full-width ``moe_lm`` (vocab 32000, d 768, d_ff 3072, 12
    heads, 12 layers, 8 experts, routing group 256, L 2048; seeded,
    float32 parameters, bf16 compute, Adam at lr 1e-3, seed 0, the
    synthetic corpus).  Training at global batch 8 x 2048: step 0 twice
    from one state bit-identical (loss, aux and every gradient); 2
    warm-up and 8 timed steps of 12 ``flash_fwd``, 12 ``flash_bwd``, no
    ``flash_bwd_streamk`` and one each of ``xent_fwd``, ``xent_dy``,
    ``xent_de``; the batch-0 loss falls; ``moe_drop_rate`` in [0, 1);
    the kernel path against the plain path at 2 x 2048 (loss 1e-3
    relative, every gradient 2e-2 of scale), printing the share of
    tokens each layer routes to another expert; step ms, tokens/s, MFU,
    peak memory, drop rate and aux loss.  The trained state saved once
    to a durable directory.  Elastic as phase 12 runs it (bump at step
    3, state lost after step 6): run B == run A bit for bit.  Serving:
    ``serve_run(entrypoint="moe_lm", checkpoint_dir=...)`` loads the
    save (load seconds); phase 4's traffic through a monolithic front on
    its engine (12 ``flash_fwd`` a prefill, nothing else), the tokens
    against a per-token-routed full recompute (margin rule), each
    prompt alone equal to the batch of four (or parting at a near tie),
    the 1900-token prompt's first token in the replica's chunked
    posture equal to the monolithic one; TTFT p50, tokens/s, peak
    memory.  ``python -m edl_tpu_torch.cli serve --entrypoint moe_lm
    --checkpoint-dir <dir> --port 0`` as a subprocess, registered with
    a ``CoordinatorServer``: its JSON line (the saved step), one
    ``/generate`` equal to the in-process replica's; ``route_run`` over
    that coordinator and ``python -m edl_tpu_torch.cli route`` against
    it, as a table and with ``--json``.  Prints the phase's seconds.
15. **Chaos** — the chaos harness (``edl_tpu_torch.chaos``) at full
    width.  Training soak: phase 7's configuration (``transformer_lm``,
    8 x 2048, seed 0, Adam at 1e-3) through ``ElasticTrainer`` with a
    ``HostDRAMStore(keep=3)`` spilling to a temp directory, reaching a
    ``CoordinatorServer`` (over a ``ChaosCoordinator``) through a
    ``ChaosHTTPCoordinator``, a ``ChaosMonkey`` on its steps: 48 steps at
    checkpoint interval 4 under ``CHAOS_TRAIN_EVENTS`` (the JAX soak's
    cycle compressed: grow to 4 with restarts, refused RPCs, a kill,
    torn RPCs, a death with state loss, a corrupted checkpoint and a
    death, regrow, timeouts, a coordinator restart, a slow RPC, a
    shrink, refused RPCs; the stager's failed and slow batch and the
    flush's slow spill once each).  Checks: nothing pending; the
    transport's injected counts the schedule's; graceful resizes replay
    nothing; the corrupted snapshot skipped for the next older one,
    replaying to the death after it; the loss stream bit-identical to a
    fault-free run; 12/12/0/1/1/1 launches a dispatched step; the
    journal's chaos events the fired ones.  Serving soak: phase 9's two
    replicas (chunked prefill, prefix cache) behind ``route_run`` with
    its prefix groups, then ``CHAOS_SERVE_EVENTS`` in order: A's prefix
    cache evicted, then a forced hash skew; a wedged decode dispatch on
    A; a torn swap candidate in A's store, then a good save; a refused
    backend and a cut stream at the router; A's drain migrating to B
    under a torn chunk (a cold re-prefill on B); a fresh A (monolithic)
    dying mid-stream, the stream resumed on B.  Every stream whole and
    its tokens equal to the full recompute (margin rule), 12
    ``flash_fwd`` a monolithic prefill and none chunked, nothing
    pending.  Prints the resize events, each fault's recovery seconds,
    the soak's wall time against the fault-free run's, TTFT p50/p95
    before and during the faults, the wedge's recovery, the swap's
    seconds to reject and to take, the drain's seconds, the re-drive
    gap, peak memory and the phase's seconds.
16. **Kernels line** — one JSON object listing every ported kernel with
    its launches on the main path, error, times, bound, the shape timed,
    the achieved TFLOP/s and the share of the bound, after a line with
    the whole script's seconds.
17. **Last line** — ``{"ok": true, "device": {...}}``.

Every phase prints its details as one JSON line.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: bf16 tolerance of the repo's flash tests (tests/test_flash_attention.py)
BF16_TOL = 3e-2
#: lse is float32 on both sides; only summation order and exp differ
LSE_TOL = 1e-3
#: served vs full-recompute logits agree within this fraction of the
#: row's largest |logit| (the bf16 scale tolerance of the model parity
#: tests): a top-2 margin above it cannot be flipped by bf16 rounding
MARGIN_FRAC = 2e-2

#: gradients in bf16: kernel and plain versions round dS, P and dL to
#: bf16 at the same points from float32 sums taken in another order, so
#: a rounding can land one ulp apart; held at this fraction of the
#: gradient's largest magnitude (tests/test_torch_cuda_kernels.py)
GRAD_TOL = 2e-2
#: float32 loss statistics (lse, label logit, row max) of the fused
#: cross entropy: sums of exact bf16 products in another order, held at
#: this fraction of the largest |value|
STAT_TOL = 1e-5
#: training at batch 2, kernel path vs plain path (plain attention
#: autograd + tied_vocab_xent): the paths round bf16 at different
#: points through 12 layers; the loss is held at this relative
#: tolerance and each gradient at GRAD_TOL of its largest magnitude
TRAIN_LOSS_TOL = 1e-3
#: every attention output ([B, T, H, D]: O, dQ, dK, dV) is also held row
#: by row: |got - want| over the D values of each (b, t, h) row, as a
#: fraction of that row's own |want|.  At long T a causal row's values
#: shrink about as 1/sqrt(t), so a tolerance of the whole tensor's
#: largest value would pass a kernel that zeroed the late rows; this one
#: follows each row's scale.  Sound kernels differ from their plain
#: versions by bf16 roundings of single elements: at most 5.4e-3 of a
#: row on the H100 at every shape here, while the faults planted at
#: [1, 32768, 12, 64] (late rows zeroed, the last slot's keys dropped)
#: are a whole row off at 1.0e-2 to 4.3e-2 of the tensor's scale
#: (PERF.md section 6).  Rows whose |want| is under ROW_FLOOR of the
#: tensor's largest row are held against that floor: such rows (a first
#: query's dQ, which is rounding residue on both sides) have no scale
#: of their own.
ROW_TOL = 1e-2
ROW_FLOOR = 1e-3

SERVE_PROMPTS = (300, 700, 1200, 1900)
SERVE_NEW_TOKENS = 32
SEED = 0

#: the training phase: global batch 8 at the model's T=2048 (the batch
#: of bench_lib/lm.py's bench_longcontext_lm at T=2048), the launcher's
#: default lr, one warm-up step and five timed steps
TRAIN_BATCH = 8
TRAIN_LR = 1e-3
TRAIN_STEPS = 5
PARITY_BATCH = 2

#: the long-context phase: full-width longcontext_lm at T=32768 (the
#: first D=64 length past the merged backward's range), global batch 1,
#: one warm-up step and three timed ones; its kernel-vs-plain parity at
#: T=2048 with B3 forced at 256-key slots (8 partials)
LONG_T = 32768
LONG_BATCH = 1
LONG_STEPS = 3
LONG_PARITY_T = 2048
LONG_PARITY_SLOT = 256

#: the elastic phase: full-width transformer_lm at the training phase's
#: 8 x 2048, checkpoint interval 4; run B bumps the generation at step 6
#: (graceful: flush, re-form, restore) and loses the device state at
#: step 9 (replay from the step-8 checkpoint); runs A and C then take 8
#: more steps with no checkpoint for their steady-state step time, and
#: 4 under the profiler for the device's busy share
ELASTIC_STEPS = 12
ELASTIC_INTERVAL = 4
ELASTIC_BUMP_AT = 6
ELASTIC_KILL_AT = 9
ELASTIC_TIMED_STEPS = 8
ELASTIC_PROFILE_STEPS = 4
LAUNCHER_STEPS = 4
#: phase 8, the serving replica: the trainer spills step 2 and then step
#: 4; every prompt of the prefix traffic starts with one shared prefix of
#: 96 blocks of 16 tokens, then a tail of its own (the first, cold
#: request's tail 64 tokens, the 7 concurrent ones' 128-320)
REPLICA_SPILL_STEPS = (2, 4)
REPLICA_PREFIX_BLOCKS = 96
REPLICA_COLD_TAIL = 64
REPLICA_WARM_TAILS = (128, 160, 192, 224, 256, 288, 320)
#: interference: four short prompts decode 64 tokens each; a 1900-token
#: prompt arrives once each has 8 (bench_lib/serving.py:602's shape)
REPLICA_SHORT = (24, 40, 56, 72)
REPLICA_SHORT_NEW = 64
REPLICA_LONG = 1900
REPLICA_LONG_AFTER = 8
REPLICA_DRAIN_NEW = 64
#: phase 9, the serving fleet: two replicas behind the router.  Spread
#: and affinity: two groups of 4 prompts, each group one shared prefix of
#: 96 blocks and tails of its own, 32 new tokens each; the router's and
#: a replica's TTFT timed on 4 more warm prompts each.  Drain with
#: migration: a 1024-token prompt, 256 new tokens, the drain after 16.
#: Re-drive: a 1000-token prompt, 64 new tokens, the kill after 16
FLEET_PREFIX_BLOCKS = 96
FLEET_TAILS = (64, 96, 128, 160)
FLEET_NEW = 32
#: router-overhead pairs: one warm prompt (the group's prefix and a tail
#: under one block, so every request reuses exactly the prefix's blocks)
#: once through the router and once straight to the replica
FLEET_TTFT_PAIRS = 32
FLEET_MIGRATE_PROMPT = 1024
FLEET_MIGRATE_NEW = 256
FLEET_MIGRATE_AT = 16
FLEET_REDRIVE_PROMPT = 1000
FLEET_REDRIVE_NEW = 64
FLEET_REDRIVE_AT = 16

#: phase 12, the model zoo: each family's global batch (transformer_base
#: 64 x 256 tokens, bench_lib/lm.py:91-123), five timed steps after one
#: warm-up; the elastic runs take 8 steps at checkpoint interval 2, run
#: B bumps the generation at step 3 and loses the device state once step
#: 6 has run (step 6 replays from its checkpoint); 16 concurrent
#: /predict of one example each
ZOO_FAMILIES = ("fit_a_line", "mnist", "resnet50", "transformer_base")
ZOO_BATCH = {"fit_a_line": 64, "mnist": 256, "resnet50": 64, "transformer_base": 64}
ZOO_STEPS = 5
ZOO_ELASTIC_STEPS = 8
ZOO_ELASTIC_INTERVAL = 2
ZOO_BUMP_AT = 3
ZOO_KILL_AT = 6
ZOO_REQUESTS = 16
#: transformer_base's attention ([B, T, H, D]) and loss (N = B x (T-1),
#: V, D) shapes at its global batch, for phases 3 and xent
ZOO_ATTN = (64, 256, 8, 64)
ZOO_XENT = (64 * 255, 32000, 512)
#: transformer_base's kernel path against the plain path on 16 x 256
#: tokens, phase 5's 4096 (2 x 2048); a planted fault scales dV by this
ZOO_PARITY_BATCH = 16
ZOO_DV_FAULT = 1.05

#: the first (WMMA) versions' times on the H100 (NVIDIA H100 80GB HBM3,
#: 700 W; PERF.md section 6): B1 and B3 at [1, 32768, 12, 64], B2 at
#: [8, 2048, 12, 64] causal, B4, B5 and B6 at N=16384, V=32000, D=768.
#: The wgmma/TMA kernels that replaced them must not be slower
FIRST_VERSION_MS = {"flash_fwd": 27.47, "flash_bwd_streamk": 66.53,
                    "flash_bwd": 2.989, "xent_fwd": 13.37, "xent_dy": 21.16,
                    "xent_de": 22.31}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls (CUDA events, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 --------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi exit {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    log({"device": info})
    return card


# -- phase 2 --------------------------------------------------------------


def phase_build():
    from edl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per = _build.build(_build.KERNELS)
    secs = time.perf_counter() - t0
    ptxas = {
        name: [
            line.strip() for line in _build.build_log(name).splitlines()
            # registers and spills, and ptxas's "wgmma ... serialized"
            # warnings (C75xx), per kernel instantiation
            if "registers" in line or "spill" in line or "Performance Loss" in line
        ]
        for name in _build.KERNELS
    }
    log({"build": {"seconds": round(secs, 3), "per_kernel": per, "ptxas": ptxas}})


# -- phase 3 --------------------------------------------------------------


def _qkv(g, b, t, h, d, tk=None, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16
    return [
        torch.randn((b, t if i == 0 else (tk or t), h, d), generator=g,
                    device="cuda").to(dtype)
        for i in range(3)
    ]


def _flash_case(g, b, t, h, d, causal, mask_kind=None, tk=None, dtype=None):
    """One kernel-vs-plain comparison (``tk`` keys, default ``t``; bf16
    unless ``dtype``); two kernel runs must be bit-identical.  Returns the
    O and lse errors."""
    import torch

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd_cuda

    q, k, v = _qkv(g, b, t, h, d, tk, dtype)
    mask = None
    if mask_kind == "row_masked":
        mask = torch.rand((b, k.shape[1]), generator=g, device="cuda") > 0.25
        mask[-1] = False  # one batch row with every key masked
    elif mask_kind is not None:
        mask = _padding_mask(b, k.shape[1], mask_kind)
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    o2, lse2 = flash_fwd_cuda(q, k, v, causal, scale, mask)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        fail(f"two flash_fwd runs differ at {b=} {t=} {tk=} {d=} {causal=} {mask_kind=}")
    po, plse = flash_attention_plain(q, k, v, causal, scale, mask)
    torch.cuda.synchronize()
    if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
        fail(f"flash_fwd non-finite output at {b=} {t=} {causal=} {mask_kind=}")
    o_err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    row_err = _row_err(o, po)
    o_ok = torch.allclose(o.float(), po.float(), atol=BF16_TOL, rtol=BF16_TOL)
    if not o_ok or lse_err > LSE_TOL or row_err > ROW_TOL:
        fail(f"flash_fwd disagrees with its plain version at {b=} {t=} "
             f"{causal=} {mask_kind=}: O err {o_err}, O row err {row_err} "
             f"(tolerance {ROW_TOL}), lse err {lse_err}")
    if mask_kind == "row_masked":
        if o[-1].float().abs().max().item() != 0.0:
            fail("fully masked row: O is not 0")
        want = float(np.log(np.float32(1e-30)))
        if (lse[-1] - want).abs().max().item() > 1e-4:
            fail("fully masked row: lse is not log(1e-30)")
    return {"B": b, "T": t, "Tk": k.shape[1], "H": h, "D": d, "dtype": str(q.dtype),
            "causal": causal, "mask": mask_kind, "o_max_abs_err": o_err,
            "o_row_err": row_err, "row_tolerance": ROW_TOL, "lse_max_abs_err": lse_err,
            "bit_identical_twice": True}


def _padding_mask(b, t, which):
    """The key padding mask of ``transformer_base``'s batches
    (``src != 0`` or ``tgt != 0`` of its ``synth_batch``, seed SEED):
    rows of T/2 to T tokens, bool ``[B, T]`` on the card."""
    import torch

    from edl_tpu_torch.models import get_model

    batch = get_model("transformer_base", seq_len=t).synth_batch(np.random.RandomState(SEED), b)
    return torch.from_numpy(batch[which] != 0).cuda()


def _kept_pairs(b, t, causal, mask=None) -> int:
    """(query, key) pairs the masks keep, over the batch: what this
    run's data needs of the score products."""
    if mask is None:
        return b * (t * (t + 1) // 2 if causal else t * t)
    keys = mask.cpu().numpy()
    if causal:  # key k is seen by the queries k..t-1
        return int((keys * (t - np.arange(t))[None, :]).sum())
    return int(keys.sum()) * t


def _bound(flops, nbytes) -> tuple:
    """``(bound_ms, bound_by, flops, bytes)``: the larger of the FLOPs
    at the bf16 peak and the bytes at the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def flash_bound_ms(b, t, h, d, causal, mask=None) -> tuple:
    """Least time the card needs for the same attention forward: the
    larger of its tensor-core FLOPs (QK^T and PV over the key pairs the
    masks keep) at the bf16 peak, and its bytes (Q, K, V and the key
    mask read once, O and lse written once) at the memory rate."""
    pairs = _kept_pairs(b, t, causal, mask)
    mask_bytes = 0 if mask is None else b * t
    return _bound(4 * h * d * pairs, 4 * b * t * h * d * 2 + b * h * t * 4 + mask_bytes)


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    cases = []
    # the serving path's prefill shapes (B=1, H=12, D=64, causal), ragged
    # lengths included, then the masked non-causal case and the training
    # path's shape
    for t in (16, 48, 512, 2047, 2048):
        cases.append(_flash_case(g, 1, t, 12, 64, True))
    cases.append(_flash_case(g, 2, 300, 12, 64, False, "row_masked"))
    cases.append(_flash_case(g, TRAIN_BATCH, 2048, 12, 64, True))
    # the edges of the 128-key K/V tile and the 192-row Q tile, keys
    # shorter than one tile, D = 128 (two 64-column TMA boxes per row),
    # f16 with 64-byte rows and a fully masked row
    for t in (127, 128, 129, 130, 191, 193):
        cases.append(_flash_case(g, 2, t, 12, 64, True))
    cases.append(_flash_case(g, 2, 300, 12, 64, False, tk=50))
    cases.append(_flash_case(g, 1, 4096, 4, 128, True))
    cases.append(_flash_case(g, 2, 1000, 4, 32, False, "row_masked", dtype=torch.float16))
    # transformer_base's shape under its padding masks: the encoder's
    # self and the cross attention (src, non-causal), the decoder's self
    # attention (tgt, causal)
    b, t, h, d = ZOO_ATTN
    cases.append(_flash_case(g, b, t, h, d, False, "src"))
    cases.append(_flash_case(g, b, t, h, d, True, "tgt"))
    for c in cases:
        log({"flash_fwd_check": c})

    # timed at the serving path's largest prefill (the kernels line) and
    # at the training path's shape
    timings = []
    for b in (1, TRAIN_BATCH):
        t, h, d = 2048, 12, 64
        q, k, v = _qkv(g, b, t, h, d)
        scale = d ** -0.5
        kernel_ms = cuda_ms(lambda: flash_fwd_cuda(q, k, v, True, scale), iters=50)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True, scale), iters=10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale),
            iters=50,
        )
        bound_ms, bound_by, flops, nbytes = flash_bound_ms(b, t, h, d, True)
        timings.append({
            "name": "flash_fwd", "shape": [b, t, h, d], "causal": True,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        })
        log({"kernel_timing": timings[-1]})
    zoo = [_flash_fwd_zoo_timing(g, causal) for causal in (False, True)]
    max_err = max(c["o_max_abs_err"] for c in cases)
    return {"cases": cases, "timing": timings[0], "zoo_timing": zoo, "max_abs_err": max_err}


def _sdpa_mask(mask, t, causal):
    """SDPA's boolean ``attn_mask`` (True = attend) for a key padding
    mask, under the causal mask where asked."""
    import torch

    keep = mask[:, None, None, :]
    if causal:
        keep = keep & torch.ones((t, t), dtype=torch.bool, device=mask.device).tril()
    return keep


def _flash_fwd_zoo_timing(g, causal):
    """B1 at transformer_base's [64, 256, 8, 64] under its padding mask,
    beside its plain version, its bound (the pairs this mask keeps) and
    SDPA with the same boolean mask."""
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd_cuda

    b, t, h, d = ZOO_ATTN
    q, k, v = _qkv(g, b, t, h, d)
    mask = _padding_mask(b, t, "tgt" if causal else "src")
    scale = d ** -0.5
    kernel_ms = cuda_ms(lambda: flash_fwd_cuda(q, k, v, causal, scale, mask), iters=50)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal, scale, mask), iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    attn_mask = _sdpa_mask(mask, t, causal)
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=scale),
        iters=50)
    bound_ms, bound_by, flops, nbytes = flash_bound_ms(b, t, h, d, causal, mask)
    timing = {
        "name": "flash_fwd", "shape": [b, t, h, d], "causal": causal,
        "mask": "tgt != 0" if causal else "src != 0",
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention, boolean attn_mask",
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12, "bound_share": bound_ms / kernel_ms,
    }
    log({"kernel_timing": timing})
    return timing


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (both as float32)."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _max_abs(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _row_err(got, want) -> float:
    """Largest over the rows of the last axis of |got - want| / |want|
    (2-norms), each row against its own |want| floored at ROW_FLOOR of
    the largest row's."""
    import torch

    want = want.float()
    ref = want.norm(dim=-1)
    err = (got.float() - want).norm(dim=-1)
    floor = ROW_FLOOR * ref.max().clamp_min(1e-30)
    return (err / torch.maximum(ref, floor)).max().item()


def _check_rejects(what, faults, want) -> dict:
    """The row check must reject each planted fault: ``faults`` maps a
    fault's name to outputs of ``what`` with that fault planted, each
    held against ``want``.  Returns both measures for each fault: the
    row error and the error of the whole tensor's scale."""
    out = {}
    for name, bad in faults.items():
        rows = max(_row_err(x, w) for x, w in zip(bad, want))
        of_scale = max(_rel_err(x, w) for x, w in zip(bad, want))
        if not rows > ROW_TOL:
            fail(f"the row check of {what} passes a planted fault ({name}): "
                 f"row error {rows}, tolerance {ROW_TOL}")
        out[name] = {"row_err": rows, "err_of_scale": of_scale}
    return out


def _grad_errors(what, got, want, mask_kind, where):
    """``{name: (max_abs, of_scale, row)}`` of dq, dk, dv against the
    plain version; fails past GRAD_TOL of the scale or ROW_TOL of a row,
    and where the last batch row has every key masked, unless its
    gradients are exactly 0."""
    import torch

    errs = {}
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(x.float()).all():
            fail(f"{what} non-finite {name} at {where}")
        errs[name] = (_max_abs(x, w), _rel_err(x, w), _row_err(x, w))
        if errs[name][1] > GRAD_TOL or errs[name][2] > ROW_TOL:
            fail(f"{what} {name} disagrees with its plain version at {where}: error "
                 f"{errs[name][1]} of its scale (tolerance {GRAD_TOL}), "
                 f"{errs[name][2]} of a row (tolerance {ROW_TOL})")
        if mask_kind == "row_masked" and x[-1].float().abs().max().item() != 0.0:
            fail(f"{what} at {where}, fully masked row: {name} is not 0")
    return errs


def _bwd_case(g, b, t, h, d, causal, mask_kind=None, with_glse=False):
    """One B2 kernel-vs-plain comparison from the B1 kernel's O and lse."""
    import torch

    from edl_tpu_torch.ops.flash_attention import flash_bwd_cuda, flash_bwd_plain, flash_fwd_cuda

    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    mask = None
    if mask_kind == "row_masked":
        mask = torch.rand((b, t), generator=g, device="cuda") > 0.25
        mask[-1] = False  # one batch row with every key masked
    elif mask_kind is not None:
        mask = _padding_mask(b, t, mask_kind)
    g_lse = torch.randn((b, h, t), generator=g, device="cuda") if with_glse else None
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    got = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    again = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    torch.cuda.synchronize()
    where = f"{b=} {t=} {causal=} {mask_kind=} {with_glse=}"
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"two flash_bwd runs differ at {where}")
    del again
    want = flash_bwd_plain(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    torch.cuda.synchronize()
    errs = _grad_errors("flash_bwd", got, want, mask_kind, where)
    return {"B": b, "T": t, "H": h, "D": d, "causal": causal, "mask": mask_kind,
            "g_lse": with_glse, "bit_identical_twice": True, "tolerance_of_scale": GRAD_TOL,
            "max_abs_err": max(e[0] for e in errs.values()),
            "err_of_scale": {k: e[1] for k, e in errs.items()},
            "row_tolerance": ROW_TOL, "row_err": {k: e[2] for k, e in errs.items()}}


def flash_bwd_bound_ms(b, t, h, d, causal, mask=None) -> tuple:
    """Least time for the same attention backward: its five products
    (S, dP, dV, dK, dQ) over the key pairs the masks keep at the bf16
    peak, or its bytes (q, k, v, O, dO, lse and the key mask read once,
    dQ, dK, dV written once) at the memory rate."""
    pairs = _kept_pairs(b, t, causal, mask)
    mask_bytes = 0 if mask is None else b * t
    return _bound(10 * h * d * pairs, 8 * b * t * h * d * 2 + b * h * t * 4 + mask_bytes)


def phase_flash_bwd():
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import (
        flash_bwd_cuda,
        flash_bwd_plain,
        flash_bwd_streamk_cuda,
        flash_fwd_cuda,
        streamk_slot_width,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    cases = [
        # the training path's shape, then ragged T, a key mask with a
        # fully masked row, and the lse cotangent (the ring's merge)
        _bwd_case(g, 8, 2048, 12, 64, True),
        _bwd_case(g, 1, 2047, 12, 64, True, with_glse=True),
        _bwd_case(g, 2, 48, 12, 64, True),
        _bwd_case(g, 2, 300, 12, 64, False, "row_masked", with_glse=True),
        _bwd_case(g, 2, 300, 12, 64, False, "row_masked"),
        # transformer_base's shape under its padding masks
        _bwd_case(g, *ZOO_ATTN, False, "src"),
        _bwd_case(g, *ZOO_ATTN, True, "tgt"),
    ]
    for c in cases:
        log({"flash_bwd_check": c})

    b, t, h, d = TRAIN_BATCH, 2048, 12, 64
    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, True, scale)
    kernel_ms = cuda_ms(
        lambda: flash_bwd_cuda(q, k, v, o, lse, do, None, None, True, scale), iters=20)
    plain_ms = cuda_ms(
        lambda: flash_bwd_plain(q, k, v, o, lse, do, None, None, True, scale),
        iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa_fwd, iters=20)
    library_ms = cuda_ms(sdpa_fwd_bwd, iters=20) - fwd_ms
    # the streaming-K backward (B3) forced on the same inputs, one slot of
    # all 2048 keys: the yardstick of existing wgmma code
    args = (q, k, v, o, lse, do, None, None, True, scale)
    width = streamk_slot_width(t)
    got = flash_bwd_cuda(*args)
    streamk = flash_bwd_streamk_cuda(*args, width)
    torch.cuda.synchronize()
    vs_streamk = {n: _rel_err(x, w) for n, x, w in zip(("dq", "dk", "dv"), got, streamk)}
    rows_streamk = {n: _row_err(x, w) for n, x, w in zip(("dq", "dk", "dv"), got, streamk)}
    if max(vs_streamk.values()) > GRAD_TOL or max(rows_streamk.values()) > ROW_TOL:
        fail(f"B2 and B3 forced disagree at {[b, t, h, d]}: {vs_streamk} of scale, "
             f"{rows_streamk} of a row (tolerance {ROW_TOL})")
    del got, streamk
    streamk_ms = cuda_ms(lambda: flash_bwd_streamk_cuda(*args, width), iters=20)
    bound_ms, bound_by, flops, nbytes = flash_bwd_bound_ms(b, t, h, d, True)
    timing = {
        "name": "flash_bwd", "shape": [b, t, h, d], "causal": True,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "streamk_b3_forced_ms": streamk_ms, "streamk_slot_w": width,
        "b2_vs_b3_forced_err_of_scale": vs_streamk, "b2_vs_b3_forced_row_err": rows_streamk,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "b3_forced_tflops": flops / (streamk_ms * 1e-3) / 1e12,
    }
    log({"kernel_timing": timing})
    zoo = [_flash_bwd_zoo_timing(g, causal) for causal in (False, True)]
    return {"cases": cases, "timing": timing, "zoo_timing": zoo,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def _flash_bwd_zoo_timing(g, causal):
    """B2 at transformer_base's [64, 256, 8, 64] under its padding mask,
    beside its plain version, its bound and SDPA's backward with the
    same boolean mask (fwd+bwd minus fwd)."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import flash_bwd_cuda, flash_bwd_plain, flash_fwd_cuda

    b, t, h, d = ZOO_ATTN
    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    mask = _padding_mask(b, t, "tgt" if causal else "src")
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    args = (q, k, v, o, lse, do, None, mask, causal, scale)
    kernel_ms = cuda_ms(lambda: flash_bwd_cuda(*args), iters=20)
    plain_ms = cuda_ms(lambda: flash_bwd_plain(*args), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)
    attn_mask = _sdpa_mask(mask, t, causal)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=scale)

    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa_fwd, iters=20)
    library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot),
                         iters=20) - fwd_ms
    bound_ms, bound_by, flops, nbytes = flash_bwd_bound_ms(b, t, h, d, causal, mask)
    timing = {
        "name": "flash_bwd", "shape": [b, t, h, d], "causal": causal,
        "mask": "tgt != 0" if causal else "src != 0",
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention backward, boolean attn_mask "
                   "(fwd+bwd minus fwd)",
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12, "bound_share": bound_ms / kernel_ms,
    }
    log({"kernel_timing": timing})
    return timing


def _streamk_case(g, b, t, h, d, causal, slot_w=None, mask_kind=None,
                  with_glse=False, via_autograd=False):
    """One B3 kernel-vs-plain comparison from the B1 kernel's O and lse.
    ``slot_w`` None takes the dispatch's own width; ``via_autograd``
    goes through ``flash_attention_with_lse``'s backward with no
    override, which must pick B3 by itself."""
    import torch

    from edl_tpu_torch.ops.flash_attention import (
        LAUNCHES,
        bwd_impl,
        flash_attention_with_lse,
        flash_bwd_streamk_cuda,
        flash_bwd_streamk_plain,
        flash_fwd_cuda,
        streamk_slot_width,
    )

    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    mask = None
    if mask_kind == "row_masked":
        mask = torch.rand((b, t), generator=g, device="cuda") > 0.25
        mask[-1] = False  # one batch row with every key masked
    elif mask_kind is not None:
        mask = _padding_mask(b, t, mask_kind)
    g_lse = torch.randn((b, h, t), generator=g, device="cuda") if with_glse else None
    scale = d ** -0.5
    width = slot_w or streamk_slot_width(t)
    where = f"{b=} {t=} {h=} {d=} {causal=} slot {width} {mask_kind=} {with_glse=}"
    if via_autograd:
        if bwd_impl(t, d) != "streamk":
            fail(f"the dispatch does not pick B3 at {where}")
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        before = dict(LAUNCHES)
        o, lse = flash_attention_with_lse(qg, kg, vg, causal, scale, mask)
        outs, cots = [o], [do]
        if with_glse:
            outs.append(lse)
            cots.append(g_lse)
        got = torch.autograd.grad(outs, (qg, kg, vg), cots)
        torch.cuda.synchronize()
        if (LAUNCHES["flash_bwd_streamk"] != before["flash_bwd_streamk"] + 1
                or LAUNCHES["flash_bwd"] != before["flash_bwd"]):
            fail(f"autograd at {where} did not launch B3 once and B2 never")
        o, lse = o.detach(), lse.detach()
    else:
        o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
        got = flash_bwd_streamk_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale, width)
        again = flash_bwd_streamk_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale, width)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"two B3 runs differ at {where}")
        del again
    want = flash_bwd_streamk_plain(q, k, v, o, lse, do, g_lse, mask, causal, scale, width,
                                   by_head=True)
    torch.cuda.synchronize()
    errs = _grad_errors("flash_bwd_streamk", got, want, mask_kind, where)
    return {"B": b, "T": t, "H": h, "D": d, "causal": causal, "slot_w": width,
            "slots": -(-t // width), "mask": mask_kind, "g_lse": with_glse,
            "via_autograd": via_autograd, "tolerance_of_scale": GRAD_TOL,
            "max_abs_err": max(e[0] for e in errs.values()),
            "err_of_scale": {k: e[1] for k, e in errs.items()},
            "row_tolerance": ROW_TOL, "row_err": {k: e[2] for k, e in errs.items()}}


def _plain_fwd_by_head(q, k, v, causal, scale):
    """flash_attention_plain one head at a time ([T, T] f32 scores of
    one head at a time)."""
    import torch

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain

    parts = [flash_attention_plain(q[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1],
                                   causal, scale) for i in range(q.shape[2])]
    return torch.cat([p[0] for p in parts], dim=2), torch.cat([p[1] for p in parts], dim=1)


def phase_long_kernels():
    """B1 and B3 at the long-context path's shape, beside B3's edge
    cases, B2 forced on the same inputs and SDPA as the yardstick."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import (
        flash_bwd_cuda,
        flash_bwd_streamk_cuda,
        flash_bwd_streamk_plain,
        flash_fwd_cuda,
        streamk_slot_width,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    cases = [
        _streamk_case(g, 2, 4096, 12, 64, True, slot_w=512),
        _streamk_case(g, 2, 4096, 12, 64, True, slot_w=512, with_glse=True),
        _streamk_case(g, 2, 300, 12, 64, False, slot_w=100, mask_kind="row_masked",
                      with_glse=True),
        _streamk_case(g, 1, 16384, 4, 128, True, via_autograd=True, with_glse=True),
        _streamk_case(g, 1, 16411, 2, 64, True),  # prime T: ragged last slot
        # slots that are not a multiple of the 128-key tile (a tile
        # crosses into the next slot), with and without a key mask
        _streamk_case(g, 2, 512, 12, 64, False, slot_w=130, mask_kind="row_masked",
                      with_glse=True),
        _streamk_case(g, 1, 1000, 12, 64, True, slot_w=333),
    ]
    for c in cases:
        log({"flash_bwd_streamk_check": c})

    b, t, h, d = LONG_BATCH, LONG_T, 12, 64
    scale = d ** -0.5
    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    o, lse = flash_fwd_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    po, plse = _plain_fwd_by_head(q, k, v, True, scale)
    torch.cuda.synchronize()
    o_err, lse_err = _max_abs(o, po), (lse - plse).abs().max().item()
    row_err = _row_err(o, po)
    if (not torch.allclose(o.float(), po.float(), atol=BF16_TOL, rtol=BF16_TOL)
            or lse_err > LSE_TOL or row_err > ROW_TOL):
        fail(f"flash_fwd at {[b, t, h, d]}: O err {o_err}, O row err {row_err} "
             f"(tolerance {ROW_TOL}), lse err {lse_err}")
    # the late half of O zeroed: a fault the row check must reject
    late_zero = o.clone()
    late_zero[:, t // 2:] = 0
    fwd_check = {"B": b, "T": t, "H": h, "D": d, "causal": True,
                 "o_max_abs_err": o_err, "o_row_err": row_err, "row_tolerance": ROW_TOL,
                 "lse_max_abs_err": lse_err,
                 "planted_faults": _check_rejects(
                     "flash_fwd", {"O rows t >= T/2 zeroed": [late_zero]}, [po])}
    log({"flash_fwd_check": fwd_check})
    del po, plse, late_zero
    fwd_ms = cuda_ms(lambda: flash_fwd_cuda(q, k, v, True, scale), iters=5, warmup=1)
    fwd_plain_ms = cuda_ms(lambda: _plain_fwd_by_head(q, k, v, True, scale), iters=1, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        sdpa_fwd_ms = cuda_ms(sdpa_fwd, iters=5)
    sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd, iters=5) - sdpa_fwd_ms
    bound_ms, bound_by, flops, nbytes = flash_bound_ms(b, t, h, d, True)
    fwd_timing = {
        "name": "flash_fwd", "shape": [b, t, h, d], "causal": True,
        "kernel_ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "plain": "flash_attention_plain head by head",
        "library_ms": sdpa_fwd_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes, "tflops": flops / (fwd_ms * 1e-3) / 1e12,
    }
    log({"kernel_timing": fwd_timing})

    width = streamk_slot_width(t)
    args = (q, k, v, o, lse, do, None, None, True, scale)
    got = flash_bwd_streamk_cuda(*args, width)
    again = flash_bwd_streamk_cuda(*args, width)
    torch.cuda.synchronize()
    identical = all(torch.equal(x, y) for x, y in zip(got, again))
    if not identical:
        fail(f"two B3 runs at {[b, t, h, d]} differ")
    del again
    want = flash_bwd_streamk_plain(*args, width, by_head=True)
    torch.cuda.synchronize()
    where = f"{[b, t, h, d]} causal slot {width}"
    errs = _grad_errors("flash_bwd_streamk", got, want, None, where)
    full = {"B": b, "T": t, "H": h, "D": d, "causal": True, "slot_w": width,
            "slots": -(-t // width), "mask": None, "g_lse": False, "via_autograd": False,
            "tolerance_of_scale": GRAD_TOL, "bit_identical_twice": identical,
            "max_abs_err": max(e[0] for e in errs.values()),
            "err_of_scale": {k: e[1] for k, e in errs.items()},
            "row_tolerance": ROW_TOL, "row_err": {k: e[2] for k, e in errs.items()}}
    # faults the row check must reject, each held against the plain
    # version: the last slot's contributions dropped (what a kernel that
    # lost that slot's dQ partial and its keys' dK/dV would give: the
    # plain version with those keys masked), the late half of dQ zeroed,
    # and dV past the first slot zeroed
    but_last = torch.ones((b, t), dtype=torch.bool, device="cuda")
    but_last[:, (t - 1) // width * width:] = False
    dropped = flash_bwd_streamk_plain(q, k, v, o, lse, do, None, but_last, True, scale,
                                      width, by_head=True)
    dq_late, dv_early = got[0].clone(), got[2].clone()
    dq_late[:, t // 2:] = 0
    dv_early[:, width:] = 0
    full["planted_faults"] = _check_rejects("flash_bwd_streamk", {
        "last slot's keys dropped": dropped,
        "dQ rows t >= T/2 zeroed": (dq_late, got[1], got[2]),
        "dV of keys past the first slot zeroed": (got[0], got[1], dv_early),
    }, want)
    del dropped, dq_late, dv_early
    cases.append(full)
    log({"flash_bwd_streamk_check": full})
    del want
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel_ms = cuda_ms(lambda: flash_bwd_streamk_cuda(*args, width), iters=3, warmup=1)
    workspace = torch.cuda.max_memory_allocated()
    plain_ms = cuda_ms(lambda: flash_bwd_streamk_plain(*args, width, by_head=True),
                       iters=1, warmup=1)
    merged = flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    merged_vs = {n: _rel_err(x, w) for n, x, w in zip(("dq", "dk", "dv"), merged, got)}
    merged_rows = {n: _row_err(x, w) for n, x, w in zip(("dq", "dk", "dv"), merged, got)}
    if max(merged_vs.values()) > GRAD_TOL or max(merged_rows.values()) > ROW_TOL:
        fail(f"B2 forced and B3 disagree at {where}: {merged_vs} of scale, "
             f"{merged_rows} of a row (tolerance {ROW_TOL})")
    del merged
    merged_ms = cuda_ms(lambda: flash_bwd_cuda(*args), iters=3, warmup=1)
    bound_ms, bound_by, flops, nbytes = flash_bwd_bound_ms(b, t, h, d, True)
    timing = {
        "name": "flash_bwd_streamk", "shape": [b, t, h, d], "causal": True,
        "slot_w": width, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "plain": "flash_bwd_streamk_plain head by head",
        "library_ms": sdpa_bwd_ms,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "merged_b2_forced_ms": merged_ms, "merged_b2_vs_b3_err_of_scale": merged_vs,
        "merged_b2_vs_b3_row_err": merged_rows,
        "peak_allocated_bytes_with_workspace": workspace,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "b2_forced_tflops": flops / (merged_ms * 1e-3) / 1e12,
    }
    log({"kernel_timing": timing})
    return {"cases": cases, "fwd_check": fwd_check, "fwd_timing": fwd_timing,
            "timing": timing, "max_abs_err": max(c["max_abs_err"] for c in cases)}


def _xent_inputs(g, n, v, d, pad_rows=0):
    """Features and embedding at the training path's scale (LayerNorm
    output and the embedding's N(0, 1) init), labels, and row scales
    with every 7th row at valid 0; the last ``pad_rows`` rows are the
    padding ``fused_vocab_xent`` adds (zero features, label 0, scale 0)."""
    import torch

    y = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
    e = torch.randn((v, d), generator=g, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda", dtype=torch.int32)
    valid = torch.ones(n, device="cuda")
    valid[::7] = 0.0
    if pad_rows:
        y[n - pad_rows:] = 0
        labels[n - pad_rows:] = 0
        valid[n - pad_rows:] = 0.0
    row_scale = valid / valid.sum().clamp_min(1.0)
    return y, e, labels, row_scale


def xent_bound_ms(n, v, d, mode) -> tuple:
    """Least time for one fused cross-entropy kernel: its products (the
    logits, 2*N*V*D, and for dY / dE the product with dL, as much
    again) at the bf16 peak, or its bytes (Y, E, labels and the
    per-row inputs read once, its outputs written once) at the memory
    rate."""
    flops = (2 if mode == "xent_fwd" else 4) * n * v * d
    nbytes = n * d * 2 + v * d * 2 + n * 4
    nbytes += {"xent_fwd": 3 * n * 4, "xent_dy": 2 * n * 4 + n * d * 2,
               "xent_de": 2 * n * 4 + v * d * 4}[mode]
    return _bound(flops, nbytes)


def _xent_case(g, n, v, d, pad_rows=0, plant=False):
    """B4, B5 and B6 against their plain versions on one input, each run
    twice for bit identity; dY and dE also row by row (each row against
    its own norm).  With ``plant``, faults that the row checks must
    reject: for dY, the last 64 Y rows' row_scale zeroed and dY rows
    64-127 zeroed; for dE, the last 64 Y rows dropped (their row_scale
    0) and one 64-row vocab tile past the first zeroed."""
    import torch

    from edl_tpu_torch.ops import fused_xent as fx

    y, e, labels, row_scale = _xent_inputs(g, n, v, d, pad_rows)
    got = fx.xent_fwd_cuda(y, e, labels)
    again = fx.xent_fwd_cuda(y, e, labels)
    torch.cuda.synchronize()
    if not all(torch.equal(x, x2) for x, x2 in zip(got, again)):
        fail(f"two xent_fwd runs differ at {n=} {v=}")
    del again
    want = fx.xent_fwd_plain(y, e, labels)
    out = {"N": n, "V": v, "D": d, "pad_rows": pad_rows}
    errs = {}
    for name, x, w in zip(("lse", "label_logit", "row_max"), got, want):
        errs[name] = (_max_abs(x, w), _rel_err(x, w))
        if not torch.isfinite(x).all() or errs[name][1] > STAT_TOL:
            fail(f"xent_fwd {name} disagrees with its plain version at {n=} {v=}: "
                 f"error {errs[name][1]} of its scale (tolerance {STAT_TOL})")
    out["xent_fwd"] = {"max_abs_err": max(x[0] for x in errs.values()),
                       "err_of_scale": {k: x[1] for k, x in errs.items()},
                       "tolerance_of_scale": STAT_TOL, "bit_identical_twice": True}
    lse = want[0]
    for mode, kern, plain in (("xent_dy", fx.xent_dy_cuda, fx.xent_dy_plain),
                              ("xent_de", fx.xent_de_cuda, fx.xent_de_plain)):
        x = kern(y, e, labels, lse, row_scale)
        torch.cuda.synchronize()
        w = plain(y, e, labels, lse, row_scale)
        rel = _rel_err(x, w)
        if not torch.isfinite(x.float()).all() or rel > GRAD_TOL:
            fail(f"{mode} disagrees with its plain version at {n=} {v=}: error "
                 f"{rel} of its scale (tolerance {GRAD_TOL})")
        if mode == "xent_dy" and x[::7].float().abs().max().item() != 0.0:
            fail("xent_dy: rows with valid 0 have a gradient")
        out[mode] = {"max_abs_err": _max_abs(x, w), "err_of_scale": rel,
                     "tolerance_of_scale": GRAD_TOL}
        again = kern(y, e, labels, lse, row_scale)
        torch.cuda.synchronize()
        if not torch.equal(x, again):
            fail(f"two {mode} runs differ at {n=} {v=}")
        del again
        rows = _row_err(x, w)
        if rows > ROW_TOL:
            fail(f"{mode} disagrees with its plain version at {n=} {v=}: row error "
                 f"{rows} (tolerance {ROW_TOL})")
        out[mode].update({"bit_identical_twice": True, "row_err": rows,
                          "row_tolerance": ROW_TOL})
        if plant:
            late = row_scale.clone()
            late[n - 64:] = 0
            tile = w.clone()
            tile[64:128] = 0
            what = "dY rows" if mode == "xent_dy" else "vocab rows"
            out[mode]["planted_faults"] = _check_rejects(mode, {
                "the last 64 Y rows dropped": [plain(y, e, labels, lse, late)],
                f"{what} 64-127 zeroed": [tile],
            }, [w])
            del late, tile
        del x, w
    return out


def phase_xent():
    import torch

    from edl_tpu_torch.ops import fused_xent as fx

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    n, v, d = TRAIN_BATCH * 2048, 32000, 768
    # the training path's shape, an odd N and V with padding rows, and
    # the long-context path's N = 1 x 32768
    cases = [_xent_case(g, n, v, d, plant=True), _xent_case(g, 300, 32001, d, pad_rows=20),
             _xent_case(g, LONG_BATCH * LONG_T, v, d), _xent_case(g, *ZOO_XENT)]
    for c in cases:
        log({"xent_check": c})
    torch.cuda.empty_cache()
    y, e, labels, row_scale = _xent_inputs(g, n, v, d)
    lse = fx.xent_fwd_cuda(y, e, labels)[0]
    gemm_ms = cuda_ms(lambda: torch.matmul(y, e.t()), iters=10)
    runs = {
        "xent_fwd": (lambda: fx.xent_fwd_cuda(y, e, labels),
                     lambda: fx.xent_fwd_plain(y, e, labels)),
        "xent_dy": (lambda: fx.xent_dy_cuda(y, e, labels, lse, row_scale),
                    lambda: fx.xent_dy_plain(y, e, labels, lse, row_scale)),
        "xent_de": (lambda: fx.xent_de_cuda(y, e, labels, lse, row_scale),
                    lambda: fx.xent_de_plain(y, e, labels, lse, row_scale)),
    }
    timings = {}
    for mode, (kern, plain) in runs.items():
        kernel_ms = cuda_ms(kern, iters=5, warmup=1)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        torch.cuda.empty_cache()
        bound_ms, bound_by, flops, nbytes = xent_bound_ms(n, v, d, mode)
        timings[mode] = {
            "name": mode, "shape": {"N": n, "V": v, "D": d},
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "gemm_ms": gemm_ms, "gemm": "torch.matmul(Y, E.T) bf16, the product it contains",
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        }
        log({"kernel_timing": timings[mode]})
    # B4-B6 at the long-context path's N = 32768 (Y is 50 MB, the size
    # of L2)
    del y, labels, row_scale, lse
    torch.cuda.empty_cache()
    n_long = LONG_BATCH * LONG_T
    y, _, labels, row_scale = _xent_inputs(g, n_long, v, d)
    lse = fx.xent_fwd_cuda(y, e, labels)[0]
    long_gemm_ms = cuda_ms(lambda: torch.matmul(y, e.t()), iters=10)
    long_runs = {
        "xent_fwd": lambda: fx.xent_fwd_cuda(y, e, labels),
        "xent_dy": lambda: fx.xent_dy_cuda(y, e, labels, lse, row_scale),
        "xent_de": lambda: fx.xent_de_cuda(y, e, labels, lse, row_scale),
    }
    for mode, kern in long_runs.items():
        long_ms = cuda_ms(kern, iters=5, warmup=1)
        bound_ms, bound_by, flops, nbytes = xent_bound_ms(n_long, v, d, mode)
        timings[mode]["long"] = {
            "shape": {"N": n_long, "V": v, "D": d}, "kernel_ms": long_ms,
            "gemm_ms": long_gemm_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / (long_ms * 1e-3) / 1e12, "bound_share": bound_ms / long_ms,
        }
        log({"kernel_timing": {"name": mode, **timings[mode]["long"]}})
    del y, labels, row_scale, lse
    torch.cuda.empty_cache()
    zoo = _xent_zoo_timing(g)
    errs = {mode: max(c[mode]["max_abs_err"] for c in cases) for mode in runs}
    return {"cases": cases, "timing": timings, "zoo_timing": zoo, "max_abs_err": errs}


def _xent_zoo_timing(g) -> dict:
    """B4-B6 at transformer_base's loss shape (N = 64 x 255 rows, V =
    32000, D = 512) beside their plain versions and bounds; B4 also
    beside ``matmul(Y, E.T)``, the product it contains."""
    import torch

    from edl_tpu_torch.ops import fused_xent as fx

    n, v, d = ZOO_XENT
    y, e, labels, row_scale = _xent_inputs(g, n, v, d)
    lse = fx.xent_fwd_cuda(y, e, labels)[0]
    gemm_ms = cuda_ms(lambda: torch.matmul(y, e.t()), iters=10)
    runs = {
        "xent_fwd": (lambda: fx.xent_fwd_cuda(y, e, labels),
                     lambda: fx.xent_fwd_plain(y, e, labels)),
        "xent_dy": (lambda: fx.xent_dy_cuda(y, e, labels, lse, row_scale),
                    lambda: fx.xent_dy_plain(y, e, labels, lse, row_scale)),
        "xent_de": (lambda: fx.xent_de_cuda(y, e, labels, lse, row_scale),
                    lambda: fx.xent_de_plain(y, e, labels, lse, row_scale)),
    }
    out = {}
    for mode, (kern, plain) in runs.items():
        kernel_ms = cuda_ms(kern, iters=5, warmup=1)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        torch.cuda.empty_cache()
        bound_ms, bound_by, flops, nbytes = xent_bound_ms(n, v, d, mode)
        out[mode] = {
            "name": mode, "shape": {"N": n, "V": v, "D": d},
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": gemm_ms if mode == "xent_fwd" else None,
            "library": ("torch.matmul(Y, E.T) bf16" if mode == "xent_fwd"
                        else "none: no single PyTorch call computes it"),
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / (kernel_ms * 1e-3) / 1e12, "bound_share": bound_ms / kernel_ms,
        }
        log({"kernel_timing": out[mode]})
    del y, e, labels, row_scale, lse
    torch.cuda.empty_cache()
    return out


# -- phase 3b -------------------------------------------------------------


def phase_speed_guard(kernels, xent) -> dict:
    """The redesigned kernels against their first versions' times
    (FIRST_VERSION_MS) at the same shapes: B1 and B3 at the long-context
    shape, B2 at the training shape, B4-B6 at N=16384.  A slower kernel
    fails the run."""
    long_kernels = kernels["flash_bwd_streamk"]
    timed = {"flash_fwd": long_kernels["fwd_timing"], "flash_bwd_streamk": long_kernels["timing"],
             "flash_bwd": kernels["flash_bwd"]["timing"],
             **{mode: xent["timing"][mode] for mode in ("xent_fwd", "xent_dy", "xent_de")}}
    result = {name: {"ms": t["kernel_ms"], "shape": t["shape"],
                     "first_version_ms": FIRST_VERSION_MS[name],
                     "speedup": FIRST_VERSION_MS[name] / t["kernel_ms"]}
              for name, t in timed.items()}
    log({"speed_guard": result})
    for name, r in result.items():
        if r["ms"] > r["first_version_ms"]:
            fail(f"{name} at {r['shape']} took {r['ms']} ms, slower than its first "
                 f"version's {r['first_version_ms']} ms")
    return result


# -- phase 4 --------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def _generate(base, prompt, stream, out, key):
    body = {"inputs": {"tokens": prompt.tolist()},
            "max_new_tokens": SERVE_NEW_TOKENS, "stream": stream}
    t0 = time.perf_counter()
    try:
        with _post(base + "/generate", body) as r:
            status = r.status
            if stream:
                lines = [json.loads(x) for x in r.read().decode().splitlines() if x]
                done = lines[-1]
                tokens = [ev["token"] for ev in lines if "token" in ev]
                if not done.get("done") or done.get("tokens") != tokens:
                    out[key] = {"status": status, "error": f"bad stream end {done}"}
                    return
                ttft_ms = done["ttft_s"] * 1e3
            else:
                reply = json.loads(r.read())
                tokens, ttft_ms = reply["tokens"], reply["ttft_ms"]
        out[key] = {"status": status, "tokens": tokens, "ttft_ms": ttft_ms,
                    "latency_s": time.perf_counter() - t0, "stream": stream}
    except Exception as e:  # recorded, then failed on by the caller
        out[key] = {"status": getattr(e, "code", None), "error": repr(e)}


def _recompute_check(engine, prompts, served):
    """Teacher-forced full recompute: at every served step, run the
    port's forward over prompt + the tokens served so far (flash kernel
    at the exact length, no KV cache) and compare its greedy token."""
    import torch

    params = engine.current_weights().params
    w = params.logit_weight(torch.bfloat16)
    checked = agreed = near_ties = 0
    with torch.no_grad():
        for prompt, toks in zip(prompts, served):
            seq = torch.tensor(np.concatenate([prompt, toks]), device=engine.device)[None]
            for i in range(len(toks)):
                n = len(prompt) + i
                feats = params(seq[:, :n], return_features=True)[:, -1]
                logits = (feats.to(torch.bfloat16).float() @ w.t())[0]
                top = torch.topk(logits, 2)
                margin = (top.values[0] - top.values[1]).item()
                tol = MARGIN_FRAC * logits.abs().max().item()
                same = int(top.indices[0]) == int(toks[i])
                agreed += same
                checked += 1
                if margin > tol:
                    if not same:
                        fail(f"served token {toks[i]} != full-recompute "
                             f"{int(top.indices[0])} at step {i} of a "
                             f"{len(prompt)}-token prompt (margin {margin}, tol {tol})")
                else:
                    near_ties += 1
    return {"steps": checked, "agreement": agreed / checked, "near_ties": near_ties}


def phase_serving():
    import torch

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts
    from edl_tpu_torch.serving import (
        ContinuousBatcher,
        DecodeEngine,
        ServingServer,
        TokenContinuousBatcher,
    )

    model = get_model("transformer_lm")  # full width, bf16
    t0 = time.perf_counter()
    engine = DecodeEngine(model, device="cuda", max_seqs=8, block_tokens=16)
    engine.install_seeded(SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batcher = ContinuousBatcher(engine).start()
    gen = TokenContinuousBatcher(engine, chunked_prefill=False).start()
    server = ServingServer(batcher, port=0, gen_batcher=gen).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        # warm-up request (library handles, allocator) before the counts
        with _post(base + "/generate", {"inputs": {"tokens": [5, 6, 7]},
                                        "max_new_tokens": 2}) as r:
            if r.status != 200:
                fail(f"warm-up /generate answered {r.status}")
        rng = np.random.RandomState(SEED)
        vocab = model.decode.vocab_size
        prompts = [rng.randint(3, vocab, size=n).astype(np.int32) for n in SERVE_PROMPTS]
        prefills0 = gen.stats["prefills"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        threads = [
            threading.Thread(target=_generate, args=(base, p, i == 3, out, i))
            for i, p in enumerate(prompts)
        ]
        reset_launch_counts()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        prefills = gen.stats["prefills"] - prefills0
        peak = torch.cuda.max_memory_allocated()
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.stop()
        gen.stop()
        batcher.stop()
    for i in range(len(prompts)):
        res = out.get(i)
        if res is None or res.get("status") != 200 or "error" in res:
            fail(f"/generate request {i} failed: {res}")
        if len(res["tokens"]) != SERVE_NEW_TOKENS:
            fail(f"/generate request {i} returned {len(res['tokens'])} tokens")
    layers = model.decode.layers  # 12 at full width
    if prefills < len(prompts) or launches["flash_fwd"] != layers * prefills:
        fail(f"flash_fwd launched {launches['flash_fwd']} times for {prefills} "
             f"prefills on the serving path (want {layers} per prefill)")
    if engine.pool.used_blocks != 0:
        fail(f"{engine.pool.used_blocks} KV blocks still owned after serving")
    served = [out[i]["tokens"] for i in range(len(prompts))]
    check = _recompute_check(engine, prompts, served)
    ttfts = sorted(out[i]["ttft_ms"] for i in range(len(prompts)))
    total_tokens = sum(len(s) for s in served)
    result = {
        "model": "transformer_lm", "prompts": list(SERVE_PROMPTS),
        "new_tokens": SERVE_NEW_TOKENS, "setup_s": setup_s, "wall_s": wall,
        "ttft_ms": ttfts, "ttft_p50_ms": float(np.median(ttfts)),
        "tokens_per_s": total_tokens / wall,
        "latency_s": [out[i]["latency_s"] for i in range(len(prompts))],
        "peak_allocated_bytes": peak, "kv_pool_bytes": engine.pool.nbytes(),
        "prefills": prefills, "launches": launches,
        "recompute": check, "healthz": health,
    }
    log({"serving": result})
    return result


# -- phase 5 --------------------------------------------------------------


def _all_launches() -> dict:
    from edl_tpu_torch.ops import fused_xent
    from edl_tpu_torch.ops.flash_attention import LAUNCHES

    return {**LAUNCHES, **fused_xent.LAUNCHES}


def _reset_launches() -> None:
    from edl_tpu_torch.ops import fused_xent
    from edl_tpu_torch.ops.flash_attention import reset_launch_counts

    reset_launch_counts()
    fused_xent.reset_launch_counts()


def _grads(params) -> dict:
    return {n: p.grad.detach().clone() for n, p in params.named_parameters()}


def _plain_patches() -> tuple:
    """``mock.patch.object`` triples that put the LM family on its plain
    path: flash_attention_plain through torch autograd for the
    attention kernels, tied_vocab_xent for the loss's."""
    import edl_tpu_torch.models.transformer_lm as tlm
    from edl_tpu_torch.ops import tied_vocab_xent
    from edl_tpu_torch.ops.flash_attention import flash_attention_plain

    def plain_attention(q, k, v, causal=False, scale=None, kv_mask=None):
        return flash_attention_plain(q, k, v, causal, scale, kv_mask)[0]

    return ((tlm, "fused_attention", plain_attention), (tlm, "best_vocab_xent", tied_vocab_xent))


def _parity_plain_vs_kernels(trainer, batch, want_launches, kernel_patches=(), state=None,
                             plain_patches=()):
    """Step-0 loss and gradients on ``batch`` from ``state`` (default
    the trainer's initial state): the kernel path (with
    ``kernel_patches``, ``mock.patch.object`` argument triples, applied)
    against the plain path (flash_attention_plain through torch
    autograd, tied_vocab_xent, and ``plain_patches``), which launches no
    kernel."""
    from contextlib import ExitStack
    from unittest import mock

    import torch

    if state is None:
        state = trainer.init_state()
    with ExitStack() as stack:
        for patch in kernel_patches:
            stack.enter_context(mock.patch.object(*patch))
        _reset_launches()
        loss_k, _ = trainer.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        launches = _all_launches()
    if launches != want_launches:
        fail(f"the kernel path launched {launches}, want {want_launches}")
    grads_k = _grads(state.params)
    _reset_launches()
    with ExitStack() as stack:
        for patch in _plain_patches() + tuple(plain_patches):
            stack.enter_context(mock.patch.object(*patch))
        loss_p, _ = trainer.loss_and_grads(state, batch)
    torch.cuda.synchronize()
    if any(_all_launches().values()):
        fail(f"the plain training path launched kernels: {_all_launches()}")
    grads_p = _grads(state.params)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_errs = {n: _rel_err(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(grad_errs, key=grad_errs.get)
    shape = list(batch["tokens"].shape)
    if loss_err > TRAIN_LOSS_TOL or grad_errs[worst] > GRAD_TOL:
        fail(f"tokens {shape} step 0, kernels vs plain: loss error {loss_err} "
             f"(tolerance {TRAIN_LOSS_TOL}), worst gradient {worst} error "
             f"{grad_errs[worst]} of its scale (tolerance {GRAD_TOL})")
    return {"tokens_shape": shape, "launches_kernel_path": launches,
            "loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
            "loss_rel_err": loss_err, "loss_tolerance": TRAIN_LOSS_TOL,
            "worst_grad": worst, "worst_grad_err_of_scale": grad_errs[worst],
            "grad_tolerance_of_scale": GRAD_TOL,
            "median_grad_err_of_scale": float(np.median(list(grad_errs.values())))}


def phase_training():
    import torch

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset

    model = get_model("transformer_lm")  # full width: bf16 compute, f32 params
    layers = model.decode.layers
    want = {"flash_fwd": layers, "flash_bwd": layers, "flash_bwd_streamk": 0,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    t0 = time.perf_counter()
    trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
    state = trainer.init_state()
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH,
        seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # two runs of step 0 from one state: bit-identical loss and gradients
    batch0 = it.device_batch(0, "cuda")
    loss_a, _ = trainer.loss_and_grads(state, batch0)
    grads_a = _grads(state.params)
    loss_b, _ = trainer.loss_and_grads(state, batch0)
    identical = torch.equal(loss_a, loss_b) and all(
        torch.equal(grads_a[n], p.grad) for n, p in state.params.named_parameters())
    if not identical:
        fail("two runs of training step 0 from one state differ")
    del grads_a

    steps = []
    timed_launches = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS + 1):  # one warm-up step, then the timed ones
        batch = it.device_batch(step, "cuda")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _all_launches()
        if launches != want:
            fail(f"training step {step} launched {launches}, want {want} per step")
        if step:
            for k in timed_launches:
                timed_launches[k] += launches[k]
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            fail(f"training step {step}: loss {loss} is not finite")
        steps.append({"step": step, "loss": loss, "ms": wall_ms})
    peak = torch.cuda.max_memory_allocated()
    loss0 = loss_a.item()
    eval0 = trainer.eval_loss(state, batch0).item()
    if not (steps[-1]["loss"] < steps[0]["loss"] and eval0 < loss0):
        fail(f"the loss did not fall over {TRAIN_STEPS} steps: step losses "
             f"{[x['loss'] for x in steps]}, batch-0 loss {loss0} -> {eval0}")
    step_ms = float(np.median([x["ms"] for x in steps[1:]]))
    tokens = TRAIN_BATCH * model.tokens_per_example
    flops = TRAIN_BATCH * model.flops_per_example
    del state, batch0
    torch.cuda.empty_cache()
    parity = _parity_plain_vs_kernels(
        trainer, it.device_batch(0, "cuda", world=TRAIN_BATCH // PARITY_BATCH, rank=0), want)
    result = {
        "model": "transformer_lm", "batch": TRAIN_BATCH, "seq_len": model.tokens_per_example,
        "lr": TRAIN_LR, "setup_s": setup_s, "steps": steps,
        "step_ms_median": step_ms, "tokens_per_s": tokens / (step_ms * 1e-3),
        "mfu": flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
        "flops_per_step": flops, "peak_allocated_bytes": peak,
        "launches_per_step": want,
        "launches_timed_steps": timed_launches,
        "bit_identical_step0": identical, "batch0_loss": [loss0, eval0],
        "parity": parity,
    }
    log({"training": result})
    return result


# -- phase 6 --------------------------------------------------------------


def phase_longcontext_training():
    import importlib

    import torch

    import edl_tpu_torch.models.transformer_lm as tlm
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset

    fa = importlib.import_module("edl_tpu_torch.ops.flash_attention")
    model = get_model("longcontext_lm", seq_len=LONG_T)  # full width
    layers = model.decode.layers
    if fa.bwd_impl(LONG_T, 64) != "streamk":
        fail(f"the dispatch does not send T={LONG_T} to B3")
    want = {"flash_fwd": layers, "flash_bwd": 0, "flash_bwd_streamk": layers,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    t0 = time.perf_counter()
    trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
    state = trainer.init_state()
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 8 * LONG_BATCH, seed=SEED), LONG_BATCH, seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    batch0 = it.device_batch(0, "cuda")
    loss_a, _ = trainer.loss_and_grads(state, batch0)
    grads_a = _grads(state.params)
    loss_b, _ = trainer.loss_and_grads(state, batch0)
    identical = torch.equal(loss_a, loss_b) and all(
        torch.equal(grads_a[n], p.grad) for n, p in state.params.named_parameters())
    if not identical:
        fail("two runs of long-context training step 0 from one state differ")
    del grads_a

    steps = []
    timed_launches = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats()
    for step in range(LONG_STEPS + 1):  # one warm-up step, then the timed ones
        batch = it.device_batch(step, "cuda")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _all_launches()
        if launches != want:
            fail(f"long-context step {step} launched {launches}, want {want} per step")
        if step:
            for k in timed_launches:
                timed_launches[k] += launches[k]
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            fail(f"long-context step {step}: loss {loss} is not finite")
        steps.append({"step": step, "loss": loss, "ms": wall_ms})
    peak = torch.cuda.max_memory_allocated()
    loss0 = loss_a.item()
    eval0 = trainer.eval_loss(state, batch0).item()
    if not (steps[-1]["loss"] < steps[0]["loss"] and eval0 < loss0):
        fail(f"the long-context loss did not fall over {LONG_STEPS} steps: step losses "
             f"{[x['loss'] for x in steps]}, batch-0 loss {loss0} -> {eval0}")
    step_ms = float(np.median([x["ms"] for x in steps[1:]]))
    tokens = LONG_BATCH * model.tokens_per_example
    flops = LONG_BATCH * model.flops_per_example
    del state, batch0, trainer
    torch.cuda.empty_cache()

    # kernel path vs plain path at T=2048, B3 forced at 8 slots
    short = get_model("longcontext_lm", seq_len=LONG_PARITY_T)
    short_trainer = Trainer(short, lr=TRAIN_LR, device="cuda", seed=SEED)
    short_it = ShardedDataIterator(
        synthetic_dataset(short.synth_batch, 8, seed=SEED), LONG_BATCH, seed=SEED)

    def streamk_attention(q, k, v, causal=False, scale=None, kv_mask=None):
        return fa.flash_attention(q, k, v, causal, scale, kv_mask,
                                  bwd_block_k=LONG_PARITY_SLOT)

    parity = _parity_plain_vs_kernels(
        short_trainer, short_it.device_batch(0, "cuda"), want,
        ((fa, "_BWD_IMPL_OVERRIDE", "streamk"), (tlm, "fused_attention", streamk_attention)))
    parity["slot_w"] = LONG_PARITY_SLOT
    parity["slots"] = LONG_PARITY_T // LONG_PARITY_SLOT
    result = {
        "model": "longcontext_lm", "batch": LONG_BATCH, "seq_len": model.tokens_per_example,
        "lr": TRAIN_LR, "setup_s": setup_s, "steps": steps,
        "step_ms_median": step_ms, "tokens_per_s": tokens / (step_ms * 1e-3),
        "mfu": flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
        "flops_per_step": flops, "peak_allocated_bytes": peak,
        "launches_per_step": want,
        "launches_timed_steps": timed_launches,
        "bit_identical_step0": identical, "batch0_loss": [loss0, eval0],
        "parity": parity,
    }
    log({"longcontext_training": result})
    return result


# -- phase 7 --------------------------------------------------------------


def _elastic_trainer(model, it, spill_dir, depth):
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.runtime import ElasticTrainer, LocalCoordinator

    coord = LocalCoordinator(target_world=1, max_world=2)
    coord.register("tr0")
    et = ElasticTrainer(model, it, coord, store=HostDRAMStore(spill_dir=spill_dir),
                        lr=TRAIN_LR, device="cuda", checkpoint_interval=ELASTIC_INTERVAL,
                        seed=SEED)
    et.pipeline_depth = depth
    return et, coord


def _check_run_launches(et, want, what):
    """Every dispatched step launched exactly ``want``: the counts were
    zeroed before the run and are read after it."""
    import torch

    torch.cuda.synchronize()
    n = et.pipeline_stats["dispatched"]
    got, expect = _all_launches(), {k: v * n for k, v in want.items()}
    if got != expect:
        fail(f"elastic run {what}: {n} steps launched {got}, want {expect} ({want} per step)")
    return n


def _check_stream(et, ref, what):
    """The run's loss stream, by step number, bit-identical to run A's."""
    bad = [(r.step, r.loss, ref.get(r.step)) for r in et.history if r.loss != ref.get(r.step)]
    if bad:
        fail(f"elastic run {what} is not bit-identical to run A: (step, loss, A's) {bad[:4]}")


def _steady_state(et, what) -> dict:
    """Steady-state step time and the device's busy share, once the
    run's background checkpoint work has finished: the wall time per
    step of ELASTIC_TIMED_STEPS more steps with no checkpoint (its first
    dispatch and last drain included), then ELASTIC_PROFILE_STEPS under
    torch.profiler for the device's kernel time per step (kernels only:
    copies run on the copy engines).  The lagged StepRecord seconds are
    not used: at depth 2 the window's first harvest waits behind two
    more dispatches, which the launch queue throttles to the device's
    pace, so their mean over a short window reads low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from edl_tpu_torch.tools.profile_serving import _device_us

    et.store.wait()
    interval, et.checkpoint_interval = et.checkpoint_interval, 0
    with_ckpt_ms = float(np.mean([r.seconds for r in et.history[2:ELASTIC_STEPS]])) * 1e3
    stats0 = dict(et.pipeline_stats)
    t0 = time.perf_counter()
    et.run(ELASTIC_STEPS + ELASTIC_TIMED_STEPS)
    step_ms = (time.perf_counter() - t0) * 1e3 / ELASTIC_TIMED_STEPS
    per_step = {k: (et.pipeline_stats[k] - stats0[k]) * 1e3 / ELASTIC_TIMED_STEPS
                for k in ("stage_s", "dispatch_s", "device_wait_s")}
    start = len(et.history)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        et.run(ELASTIC_STEPS + ELASTIC_TIMED_STEPS + ELASTIC_PROFILE_STEPS)
        torch.cuda.synchronize()
    et.checkpoint_interval = interval
    if len(et.history) - start != ELASTIC_PROFILE_STEPS:
        fail(f"elastic run {what}: the profiled window ran {len(et.history) - start} steps")
    kernel_us = sum(
        _device_us(e) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "memcpy" not in e.key.lower() and "memset" not in e.key.lower())
    device_ms = kernel_us / 1e3 / ELASTIC_PROFILE_STEPS
    if device_ms <= 0:
        fail(f"elastic run {what}: the profiler saw no device time")
    return {"step_ms": step_ms, "device_ms_per_step": device_ms,
            "busy_share": device_ms / step_ms,
            # host ms per step: batch staging, dispatch, harvest wait
            "host_ms_per_step": {k[:-2]: v for k, v in per_step.items()},
            # the run itself, checkpoint every ELASTIC_INTERVAL steps
            # (mean lag-corrected step seconds of steps 2-11)
            "step_ms_with_checkpoints": with_ckpt_ms}


def _link_spill(src, dst):
    """The spill directory as it stands now, kept by hard links (the run
    goes on pruning its own names)."""
    import os

    os.makedirs(dst)
    for name in os.listdir(src):
        os.link(os.path.join(src, name), os.path.join(dst, name))


def phase_elastic(card: str):
    """Full-width transformer_lm through ElasticTrainer (LocalCoordinator,
    host-DRAM checkpoints with a spill dir) and through launcher.run."""
    import gc
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch import launcher
    from edl_tpu_torch.checkpoint.hostdram import PINNED
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ShardedDataIterator, synthetic_dataset

    model = get_model("transformer_lm")  # full width: bf16 compute, f32 params
    layers = model.decode.layers
    want = {"flash_fwd": layers, "flash_bwd": layers, "flash_bwd_streamk": 0,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH, seed=SEED)
    out = {"card": card, "model": "transformer_lm", "batch": TRAIN_BATCH,
           "seq_len": model.tokens_per_example, "lr": TRAIN_LR,
           "checkpoint_interval": ELASTIC_INTERVAL}
    tmp = tempfile.mkdtemp(prefix="edl-elastic-")

    def free():
        """Drop a finished run's state, checkpoints and pinned buffers
        (its pinned sets go back to the pool)."""
        gc.collect()
        torch.cuda.empty_cache()

    try:
        # A: fixed world, pipeline depth 2
        _reset_launches()
        t0 = time.perf_counter()
        pinned0 = PINNED.allocations
        a, _ = _elastic_trainer(model, it, f"{tmp}/a", 2)
        a.run(ELASTIC_STEPS)
        a.store.wait()
        out["a_seconds"] = time.perf_counter() - t0
        # the process's first checkpoints pin their host buffers
        out["pinned_allocations_run_a"] = PINNED.allocations - pinned0
        out["a_steps"] = _check_run_launches(a, want, "A")
        ref = {r.step: r.loss for r in a.history}
        losses = [ref[s] for s in range(ELASTIC_STEPS)]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"elastic run A: losses {losses} are not finite or do not fall")
        out["losses"] = losses
        out["steady_depth2"] = _steady_state(a, "A")
        ckpt = a.store.latest()
        n_params = sum(p.numel() for p in a.state.params.parameters())
        n_tensors = len(list(a.state.params.parameters()))
        out["checkpoint_bytes"] = ckpt.nbytes()
        if ckpt.nbytes() != 4 * (3 * n_params + n_tensors):
            fail(f"checkpoint of {ckpt.nbytes()} bytes, want 4 x (3 x {n_params} + {n_tensors})")
        del ckpt
        del a
        free()
        shutil.rmtree(f"{tmp}/a")

        # C: depth 0, every step's launches read on its own
        _reset_launches()

        def per_step(rec):
            got = _all_launches()
            if got != want:
                fail(f"elastic run C step {rec.step} launched {got}, want {want}")
            _reset_launches()

        c, _ = _elastic_trainer(model, it, f"{tmp}/c", 0)
        c.run(ELASTIC_STEPS, on_step=per_step)
        c.store.wait()
        _check_stream(c, ref, "C (depth 0)")
        out["steady_depth0"] = _steady_state(c, "C")
        del c
        free()
        shutil.rmtree(f"{tmp}/c")

        # B: bump at 6 (graceful), kill at 9 (replay from 8)
        _reset_launches()
        b, coord = _elastic_trainer(model, it, f"{tmp}/b", 2)
        b.run(ELASTIC_BUMP_AT)
        b.store.wait()
        pinned = {}
        b.on_resize = lambda ev: pinned.setdefault(ev.generation, PINNED.allocations)
        allocs_before_bump = PINNED.allocations
        coord.register("tr1")
        coord.deregister("tr0")
        b.run(ELASTIC_KILL_AT)
        b.store.wait()
        _link_spill(f"{tmp}/b", f"{tmp}/at_kill")
        b.inject_failure()
        t0 = time.perf_counter()
        b.run(ELASTIC_STEPS)
        out["b_after_kill_seconds"] = time.perf_counter() - t0
        b.store.wait()
        out["b_steps"] = _check_run_launches(b, want, "B")
        _check_stream(b, ref, "B (bump + kill)")
        events = b.resize_events
        got = [(e.graceful, e.restored_step, e.replayed_steps, e.compiles) for e in events]
        expect = [(False, 0, 0, 0), (True, ELASTIC_BUMP_AT, 0, 0),
                  (False, ELASTIC_KILL_AT - 1, 1, 0)]
        if got != expect:
            fail(f"elastic run B resize events (graceful, restored, replayed, compiles) "
                 f"{got}, want {expect}")
        bump, kill = events[1], events[2]
        out["pinned_allocations_in_bump"] = pinned[bump.generation] - allocs_before_bump
        if out["pinned_allocations_in_bump"]:
            fail(f"the graceful flush allocated {out['pinned_allocations_in_bump']} pinned buffers")
        replayed = [r for r in b.history if r.step == ELASTIC_KILL_AT - 1][-1]
        out["resizes"] = [{"generation": e.generation, "graceful": e.graceful,
                           "restored_step": e.restored_step, "replayed_steps": e.replayed_steps,
                           "compiles": e.compiles, "restore_source": e.restore_source,
                           "seconds": e.seconds, "phase_seconds": e.phase_seconds}
                          for e in events]
        out["flush_s"] = bump.phase_seconds["flush"]
        out["d2h_gb_per_s"] = out["checkpoint_bytes"] / bump.phase_seconds["flush"] / 1e9
        out["replay"] = {"resize_s": kill.seconds, "replayed_step_s": replayed.seconds,
                         "seconds": kill.seconds + replayed.seconds}
        del b
        free()

        # D: a cold start from B's spill as it stood at the kill
        _reset_launches()
        t0 = time.perf_counter()
        d, _ = _elastic_trainer(model, it, f"{tmp}/at_kill", 2)
        d.run(ELASTIC_STEPS)
        d.store.wait()
        out["d_seconds"] = time.perf_counter() - t0
        out["d_steps"] = _check_run_launches(d, want, "D")
        _check_stream(d, ref, "D (cold start)")
        ev = d.resize_events[0]
        if (ev.restored_step, ev.restore_source, [r.step for r in d.history]) != (
                ELASTIC_KILL_AT - 1, "local", list(range(ELASTIC_KILL_AT - 1, ELASTIC_STEPS))):
            fail(f"elastic run D restored step {ev.restored_step} ({ev.restore_source}), "
                 f"ran {[r.step for r in d.history]}")
        out["cold_start"] = {"seconds": ev.seconds, "phase_seconds": ev.phase_seconds}
        del d
        free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the entry point: launcher.run, no coordinator address
    _reset_launches()
    t0 = time.perf_counter()
    et = launcher.run("transformer_lm", steps=LAUNCHER_STEPS, seed=SEED,
                      dataset_examples=8 * TRAIN_BATCH, global_batch_size=TRAIN_BATCH,
                      lr=TRAIN_LR, device="cuda")
    out["launcher_seconds"] = time.perf_counter() - t0
    out["launcher_steps"] = _check_run_launches(et, want, "launcher.run")
    _check_stream(et, ref, "launcher.run")
    if len(et.history) != LAUNCHER_STEPS:
        fail(f"launcher.run ran {len(et.history)} steps, want {LAUNCHER_STEPS}")
    del et
    free()
    out["launches_per_step"] = want
    out["pinned_pool"] = {"allocations": PINNED.allocations, "bytes": PINNED.allocated_bytes}
    log({"elastic": out})
    return out


# -- phase 8 --------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _generate_plain(base, prompt, new_tokens, out, key):
    """One non-streaming /generate; its reply (or the failure) in
    ``out[key]``."""
    body = {"inputs": {"tokens": prompt.tolist()}, "max_new_tokens": new_tokens}
    t0 = time.perf_counter()
    try:
        with _post(base + "/generate", body) as r:
            out[key] = {"status": r.status, **json.loads(r.read()),
                        "wall_s": time.perf_counter() - t0}
    except Exception as e:  # recorded, then failed on by the caller
        out[key] = {"status": getattr(e, "code", None), "error": repr(e)}


def _replies_ok(out, keys, new_tokens, what):
    for k in keys:
        res = out.get(k)
        if res is None or res.get("status") != 200 or "error" in res:
            fail(f"{what}: request {k} failed: {res}")
        if len(res["tokens"]) != new_tokens:
            fail(f"{what}: request {k} returned {len(res['tokens'])} tokens")


def _train_and_spill(trainer, state, it, store, upto):
    """Train to step ``upto``, then save and wait for the spill: each
    step's launches zeroed before it and checked after.  Returns the
    state and the seconds the spill took to land."""
    import torch

    want = {"flash_fwd": 12, "flash_bwd": 12, "flash_bwd_streamk": 0,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    while state.step < upto:
        batch = it.device_batch(state.step, "cuda")
        torch.cuda.synchronize()
        _reset_launches()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        got = _all_launches()
        if got != want:
            fail(f"replica's trainer: step {state.step - 1} launched {got}, want {want}")
        if not np.isfinite(metrics["loss"].item()):
            fail(f"replica's trainer: step {state.step - 1} loss is not finite")
    t0 = time.perf_counter()
    store.save_async(state)
    store.wait()
    return state, time.perf_counter() - t0


def _interference(engine, gen, prompts, long_prompt, chunk_times):
    """Four short sequences decode; the long prompt is submitted once
    each has emitted REPLICA_LONG_AFTER tokens.  Returns the short
    sequences' token gaps that overlap the long prompt's prefill (from
    its submission to its first token: in the monolithic posture the
    gap that spans the prefill ends after it), its TTFT, its first
    token, and the launches of the run."""
    import torch

    times = {i: [] for i in range(len(prompts))}
    long_first = {}
    _reset_launches()
    torch.cuda.synchronize()
    short = [
        gen.submit_generate({"tokens": p.tolist()}, max_new_tokens=REPLICA_SHORT_NEW,
                            on_event=(lambda i: lambda ev: "token" in ev
                                      and times[i].append(time.monotonic()))(i))
        for i, p in enumerate(prompts)
    ]
    deadline = time.monotonic() + 120
    while min(len(v) for v in times.values()) < REPLICA_LONG_AFTER:
        if time.monotonic() > deadline:
            fail("interference: the short sequences did not start decoding")
        time.sleep(0.001)
    n_chunk_calls = len(chunk_times)
    t_submit = time.monotonic()
    lt = gen.submit_generate(
        {"tokens": long_prompt.tolist()}, max_new_tokens=2,
        on_event=lambda ev: "token" in ev and long_first.setdefault("t", time.monotonic()))
    toks, meta = lt.result(timeout=300)
    for t in short:
        if len(t.result(timeout=300)[0]) != REPLICA_SHORT_NEW:
            fail("interference: a short sequence was cut short")
    torch.cuda.synchronize()
    launches = _all_launches()
    t_first = long_first["t"]
    gaps = [b - a for v in times.values() for a, b in zip(v, v[1:]) if b > t_submit and a < t_first]
    return {
        "long_ttft_ms": (t_first - t_submit) * 1e3,
        "long_first_token": toks[0],
        "long_prefill_calls": meta["prefill_chunks"],
        "gaps_during_prefill": len(gaps),
        "intertoken_p95_ms": float(np.percentile(gaps, 95)) * 1e3 if gaps else None,
        "intertoken_max_ms": max(gaps) * 1e3 if gaps else None,
        "chunk_calls": len(chunk_times) - n_chunk_calls,
        "launches": launches,
    }


def _served_weights_check(engine, state, what):
    """Every tensor the replica serves equals the trainer's parameter of
    the same name cast to the serving dtype, bit for bit, and the engine
    serves the trainer's step: the spill's leaves mapped, copied to the
    card and cast as training left them."""
    import torch

    served = dict(engine.current_weights().params.named_parameters())
    trained = dict(state.params.named_parameters())
    if set(served) != set(trained):
        fail(f"{what}: served parameters {sorted(set(served) ^ set(trained))} differ "
             "from the trainer's")
    if engine.weights_step != state.step:
        fail(f"{what}: the replica serves step {engine.weights_step}, the trainer is at "
             f"step {state.step}")
    for name, p in trained.items():
        s = served[name]
        if s.device.type != "cuda" or not torch.equal(s, p.detach().to(s.dtype)):
            fail(f"{what}: served {name} ({s.dtype}, {s.device}) is not the trainer's "
                 f"parameter cast to {s.dtype}")
    return {"tensors": len(trained), "dtypes": sorted({str(t.dtype) for t in served.values()}),
            "step": engine.weights_step}


def _swap_breakdown(engine, spill_dir, step):
    """The parts of a spill-directory swap, timed one by one on a fresh
    store: the read of the spill (every leaf, the optimizer's too), the
    CRC of its bytes, and the staging of the parameters on the card."""
    import torch

    from edl_tpu_torch.checkpoint import HostDRAMStore

    names, template = engine.leaf_template()
    t0 = time.perf_counter()
    ckpt = HostDRAMStore(spill_dir=spill_dir).load_from_disk(template, step=step)
    t1 = time.perf_counter()
    ckpt._leaf_crcs()  # the CRC pass that load_from_disk ran, alone
    t2 = time.perf_counter()
    params = engine._stage_params(ckpt)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del params
    read_and_crc = t1 - t0
    return {"read_and_crc_s": read_and_crc, "crc_s": t2 - t1, "read_s": read_and_crc - (t2 - t1),
            "stage_s": t3 - t2, "leaf_bytes": sum(x.nbytes for x in ckpt.leaves),
            "param_bytes": sum(x.nbytes for x in ckpt.leaves[:len(names)])}


def phase_serving_replica(card: str):
    """The serving replica's normal path at full width: serve_run over a
    spill directory the port's trainer writes, with a coordinator."""
    import gc
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        LocalCoordinator,
        ShardedDataIterator,
        Trainer,
        synthetic_dataset,
    )
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer
    from edl_tpu_torch.serving import TokenContinuousBatcher
    from edl_tpu_torch.serving.server import serve_run

    model = get_model("transformer_lm")  # full width: bf16 compute, f32 params
    vocab = model.decode.vocab_size
    layers = model.decode.layers
    out = {"card": card, "model": "transformer_lm", "train_batch": TRAIN_BATCH,
           "seq_len": model.tokens_per_example}
    tmp = tempfile.mkdtemp(prefix="edl-replica-")
    coord = LocalCoordinator(target_world=1, max_world=4)
    cserver = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    replica = None
    try:
        # 1. train and spill step 2
        trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
        state = trainer.init_state()
        it = ShardedDataIterator(
            synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH,
            seed=SEED)
        tstore = HostDRAMStore(spill_dir=tmp)
        state, out["spill_s"] = _train_and_spill(trainer, state, it, tstore, REPLICA_SPILL_STEPS[0])

        # 2. start the replica: load step 2, warm, register
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replica = serve_run(entrypoint="transformer_lm", checkpoint_dir=tmp,
                            coordinator_addr=f"127.0.0.1:{cserver.port}",
                            port=_free_port(), host="127.0.0.1", device="cuda",
                            replica_id="serve-0")
        out["load_s"] = time.perf_counter() - t0
        engine, gen = replica.engine, replica.gen_batcher
        base = f"http://127.0.0.1:{replica.server.port}"
        health = _get(base + "/healthz")
        if not (replica.loaded and health["weights_step"] == REPLICA_SPILL_STEPS[0]
                and health["warm"] and coord.members() == ["serve-0"]):
            fail(f"the replica did not load step {REPLICA_SPILL_STEPS[0]}, warm and "
                 f"register: healthz {health}, members {coord.members()}")
        if not (gen.chunked_prefill and gen.prefix is not None):
            fail("the replica's batcher is not in the chunked posture with the prefix cache")
        out["weights_loaded"] = _served_weights_check(engine, state, "after the load")
        out["pool"] = {"kv_pool_bytes": engine.pool.nbytes(), "blocks": engine.pool.num_blocks,
                       "max_chunk_tokens": engine.max_chunk_tokens,
                       "prefill_token_budget": gen.prefill_token_budget}
        chunk_times = []
        real_chunk = engine.prefill_chunk

        def timed_chunk(*a):
            t = time.perf_counter()
            r = real_chunk(*a)
            chunk_times.append(time.perf_counter() - t)
            return r

        engine.prefill_chunk = timed_chunk

        # 3. prefix traffic: one cold request, then 7 concurrent warm ones
        rng = np.random.RandomState(SEED + 8)
        bt = engine.block_tokens
        prefix = rng.randint(3, vocab, size=REPLICA_PREFIX_BLOCKS * bt).astype(np.int32)
        tails = (REPLICA_COLD_TAIL,) + REPLICA_WARM_TAILS
        prompts = [np.concatenate([prefix, rng.randint(3, vocab, size=n).astype(np.int32)])
                   for n in tails]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        replies = {}
        t0 = time.perf_counter()
        _generate_plain(base, prompts[0], SERVE_NEW_TOKENS, replies, 0)
        threads = [threading.Thread(target=_generate_plain,
                                    args=(base, p, SERVE_NEW_TOKENS, replies, i + 1))
                   for i, p in enumerate(prompts[1:])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _all_launches()
        out["prefix_peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        _replies_ok(replies, range(len(prompts)), SERVE_NEW_TOKENS, "prefix traffic")
        reused = [replies[i]["reused_blocks"] for i in range(len(prompts))]
        if reused != [0] + [REPLICA_PREFIX_BLOCKS] * len(REPLICA_WARM_TAILS):
            fail(f"prefix traffic: reused blocks {reused}, want 0 then "
                 f"{REPLICA_PREFIX_BLOCKS} for each warm request")
        if any(launches.values()):
            fail(f"prefix traffic (chunked posture, plain attention) launched {launches}")
        served = [replies[i]["tokens"] for i in range(len(prompts))]
        pool = engine.pool
        if pool.used_blocks != 0 or pool.cached_blocks < REPLICA_PREFIX_BLOCKS:
            fail(f"after prefix traffic: {pool.used_blocks} blocks owned, "
                 f"{pool.cached_blocks} cached (want 0 and >= {REPLICA_PREFIX_BLOCKS})")
        ttft = [replies[i]["ttft_ms"] for i in range(len(prompts))]
        out["prefix"] = {
            "prompt_tokens": [len(p) for p in prompts], "new_tokens": SERVE_NEW_TOKENS,
            "wall_s": wall, "tokens_per_s": sum(len(t) for t in served) / wall,
            "ttft_cold_ms": ttft[0], "ttft_warm_ms": ttft[1:],
            "ttft_warm_p50_ms": float(np.median(ttft[1:])),
            "prefill_chunks": [replies[i]["prefill_chunks"] for i in range(len(prompts))],
            "reused_blocks": reused, "launches": launches,
            "cached_blocks_after": pool.cached_blocks,
            "recompute": _recompute_check(engine, prompts, served),
        }

        # 4. interference, both postures, on the same engine
        long_prompt = rng.randint(3, vocab, size=REPLICA_LONG).astype(np.int32)
        shorts = [rng.randint(3, vocab, size=n).astype(np.int32) for n in REPLICA_SHORT]
        chunk_times.clear()
        chunked = _interference(engine, gen, shorts, long_prompt, chunk_times)
        chunk_ms = [t * 1e3 for t in chunk_times]
        mono_gen = TokenContinuousBatcher(engine, chunked_prefill=False, refresh=False).start()
        try:
            mono = _interference(engine, mono_gen, shorts, long_prompt, chunk_times)
        finally:
            mono_gen.stop()
        if any(chunked["launches"].values()):
            fail(f"interference, chunked posture: launched {chunked['launches']}, want none")
        prefills = len(REPLICA_SHORT) + 1
        want_mono = dict.fromkeys(chunked["launches"], 0)
        want_mono["flash_fwd"] = layers * prefills
        if mono["launches"] != want_mono:
            fail(f"interference, monolithic posture: launched {mono['launches']}, want "
                 f"{want_mono} ({layers} flash_fwd a prefill, {prefills} prefills)")
        first_check = {"chunked": chunked["long_first_token"],
                       "monolithic": mono["long_first_token"]}
        if chunked["long_first_token"] != mono["long_first_token"]:
            # held to the margin rule of the recompute check: a near tie
            # may go either way, a clear winner may not
            check = _recompute_check(engine, [long_prompt], [[mono["long_first_token"]]])
            first_check["near_tie"] = check["near_ties"] == 1
        out["interference"] = {"short_prompts": list(REPLICA_SHORT), "long_prompt": REPLICA_LONG,
                               "chunked": chunked, "monolithic": mono,
                               "first_token": first_check,
                               "chunk_call_ms_mean": float(np.mean(chunk_ms)),
                               "chunk_call_ms_p50": float(np.median(chunk_ms)),
                               "chunk_calls_timed": len(chunk_ms)}
        if mono["long_first_token"] != chunked["long_first_token"] and not first_check["near_tie"]:
            fail(f"the long prompt's first token differs between postures: {first_check}")

        # 5. hot swap: two more steps spill step 4
        state, out["swap_spill_s"] = _train_and_spill(trainer, state, it, tstore,
                                                      REPLICA_SPILL_STEPS[1])
        t_spilled = time.perf_counter()
        deadline = t_spilled + engine.spill_poll_interval + 60
        while _get(base + "/healthz")["weights_step"] != REPLICA_SPILL_STEPS[1]:
            if time.perf_counter() > deadline:
                fail(f"the replica did not swap to step {REPLICA_SPILL_STEPS[1]}")
            time.sleep(0.02)
        out["swap_seen_s"] = time.perf_counter() - t_spilled
        _reset_launches()
        after = {}
        _generate_plain(base, prompts[0], SERVE_NEW_TOKENS, after, 0)
        out["swap_s"] = time.perf_counter() - t_spilled
        _replies_ok(after, [0], SERVE_NEW_TOKENS, "after the swap")
        if after[0]["weights_step"] != REPLICA_SPILL_STEPS[1] or after[0]["reused_blocks"] != 0:
            fail(f"after the swap: weights step {after[0]['weights_step']}, reused blocks "
                 f"{after[0]['reused_blocks']} (want {REPLICA_SPILL_STEPS[1]} and 0)")
        if any(_all_launches().values()):
            fail(f"the request after the swap launched {_all_launches()}")
        out["weights_swapped"] = _served_weights_check(engine, state, "after the swap")
        out["swap_split"] = _swap_breakdown(engine, tmp, REPLICA_SPILL_STEPS[1])
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        out["swap"] = {"recompute": _recompute_check(engine, [prompts[0]], [after[0]["tokens"]]),
                       "hot_swaps": engine._m_swaps.value(),
                       "rejected": engine._m_swap_rejected.value(),
                       "events": [e.to_dict() for e in engine.recorder.events()
                                  if e.kind.startswith("serve.swap")]}

        # 6. drain with two requests in flight
        inflight = {}
        threads = [threading.Thread(target=_generate_plain,
                                    args=(base, shorts[i], REPLICA_DRAIN_NEW, inflight, i))
                   for i in range(2)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 60
        while gen.active_count < 2:
            if time.monotonic() > deadline:
                fail("drain: the two requests never started decoding")
            time.sleep(0.001)
        t0 = time.perf_counter()
        with _post(base + "/drain", {"budget_ms": 60000}) as r:
            ack = json.loads(r.read())
        out["drain_s"] = time.perf_counter() - t0
        for th in threads:
            th.join(timeout=120)
        _replies_ok(inflight, [0, 1], REPLICA_DRAIN_NEW, "in flight at the drain")
        if not (ack["drained"] and ack["in_flight"] == 0):
            fail(f"drain ack {ack}")
        try:
            _post(base + "/generate", {"inputs": {"tokens": [5, 6, 7]}, "max_new_tokens": 2})
            fail("a /generate after the drain was answered")
        except urllib.error.HTTPError as e:
            if e.code != 503 or float(e.headers.get("Retry-After", 0)) <= 0:
                fail(f"a /generate after the drain got {e.code}, Retry-After "
                     f"{e.headers.get('Retry-After')} (want 503 with one)")
        if engine.pool.used_blocks != 0 or "serve-0" in coord.members():
            fail(f"after the drain: {engine.pool.used_blocks} blocks owned, members "
                 f"{coord.members()}")
        out["drain"] = {"ack": ack, "members_after": coord.members()}
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        if replica is not None:
            replica.stop()
        cserver.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log({"serving_replica": out})
    return out


def _stream(base, prompt, new_tokens, on_token=None):
    """One streamed /generate against ``base`` (a replica or the
    router): every line with its arrival time.  ``on_token(n)`` runs in
    the reading thread after the n-th token line."""
    body = {"inputs": {"tokens": [int(x) for x in prompt]}, "max_new_tokens": new_tokens,
            "stream": True, "deadline_ms": 300000}
    lines, t0 = [], time.perf_counter()
    out = {"status": None, "lines": lines, "t0": t0}
    try:
        with _post(base + "/generate", body) as r:
            out["status"] = r.status
            ntok = 0
            for raw in r:
                if not raw.strip():
                    continue
                ev = json.loads(raw)
                lines.append((time.perf_counter(), ev))
                if "token" in ev:
                    ntok += 1
                    if on_token is not None:
                        on_token(ntok)
    except Exception as e:  # recorded, then failed on by the caller
        out["status"] = getattr(e, "code", out["status"])
        out["error"] = repr(e)
    toks = [ev for _, ev in lines if "token" in ev]
    out["tokens"] = [ev["token"] for ev in toks]
    out["indices"] = [ev["i"] for ev in toks]
    out["done"] = lines[-1][1] if lines and lines[-1][1].get("done") else None
    out["restarts"] = sum(1 for _, ev in lines if ev.get("restart"))
    out["ttft_ms"] = (next(t for t, ev in lines if "token" in ev) - t0) * 1e3 if toks else None
    return out


def _stream_ok(res, new_tokens, what, restarts=0):
    """A whole stream: its done line, ``restarts`` restart lines (a
    restart voids the tokens before it), after the last one the token
    indices 0..n-1 once each (nothing duplicated or dropped), and the
    done line's tokens the streamed ones.  Returns those tokens."""
    if res.get("error") or res["status"] != 200 or res["done"] is None:
        fail(f"{what}: the stream failed: status {res['status']}, {res.get('error')}, "
             f"last lines {[ev for _, ev in res['lines'][-2:]]}")
    lines = [ev for _, ev in res["lines"]]
    last = max([i for i, ev in enumerate(lines) if ev.get("restart")], default=-1)
    toks = [ev for ev in lines[last + 1:] if "token" in ev]
    if res["restarts"] != restarts or [ev["i"] for ev in toks] != list(range(new_tokens)):
        fail(f"{what}: {res['restarts']} restart lines (want {restarts}) "
             f"{[(i, ev) for i, ev in enumerate(lines) if ev.get('restart')]}, "
             f"token indices after the last {[ev['i'] for ev in toks]}, done line {res['done']}")
    if res["done"]["tokens"] != [ev["token"] for ev in toks]:
        fail(f"{what}: the done line's tokens differ from the streamed ones")
    return [ev["token"] for ev in toks]


def _fleet_replica(engine, coord_addr, rid, chunked=True, chaos=None):
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator
    from edl_tpu_torch.serving import (
        ContinuousBatcher,
        ServingReplica,
        ServingServer,
        TokenContinuousBatcher,
    )

    server = ServingServer(ContinuousBatcher(engine), host="127.0.0.1", port=_free_port())
    return ServingReplica(
        engine, server=server, coordinator=HTTPCoordinator(coord_addr), replica_id=rid,
        address=f"127.0.0.1:{server.port}", heartbeat_interval=0.1, telemetry_interval=0.2,
        gen_batcher=TokenContinuousBatcher(engine, chunked_prefill=chunked), chaos=chaos,
    ).start()


def _record_admissions(replica, log_to):
    """Note which replica admitted each prompt (its length and first
    tokens) — the router itself does not say where it sent a request."""
    gen = replica.gen_batcher
    real = gen.submit_generate

    def submit(inputs, *a, **k):
        toks = list(inputs.get("tokens") or [])
        log_to.append((replica.replica_id, len(toks), tuple(toks[:4]), tuple(toks[-4:])))
        return real(inputs, *a, **k)

    gen.submit_generate = submit


def _wait_route(router_base, rid, address=None, timeout=30, first=False):
    """Until the router's table shows ``rid`` healthy (at ``address``);
    with ``first``, until the router also orders it before every other
    replica that can generate (its least-loaded order: by score, then
    by name)."""
    deadline = time.monotonic() + timeout
    while True:
        rows = _get(router_base + "/routes")["replicas"]
        for r in rows:
            if r["replica"] == rid and r["health"] == "healthy" and (
                    address is None or r["address"] == address):
                order = sorted((x for x in rows if x["health"] == "healthy" and x["can_generate"]),
                               key=lambda x: (x["score"], x["replica"]))
                if not first or order[0]["replica"] == rid:
                    return r
        if time.monotonic() > deadline:
            fail(f"the router never listed {rid} healthy at {address}"
                 f"{' and first' if first else ''}: {rows}")
        time.sleep(0.02)


def phase_serving_fleet(card: str):
    """The serving fleet at full width: two replicas behind the router,
    a drain that migrates live KV, a killed replica's stream re-driven."""
    import gc

    import torch

    from edl_tpu_torch import telemetry
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        LocalCoordinator,
        ShardedDataIterator,
        Trainer,
        synthetic_dataset,
    )
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer
    from edl_tpu_torch.serving import DecodeEngine
    from edl_tpu_torch.serving.router import route_run

    model = get_model("transformer_lm")
    spec = model.decode
    vocab, layers = spec.vocab_size, spec.layers
    # K and V of every layer for one block of 16 positions
    block_bytes = (2 * layers * 16 * spec.heads * spec.head_dim
                   * torch.empty((), dtype=spec.cache_dtype).element_size())
    t_phase = time.perf_counter()
    # the phase's wall time, part by part
    out = {"card": card, "model": "transformer_lm", "parts_s": {}}
    coord = LocalCoordinator(target_world=2, max_world=4)
    cserver = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    caddr = f"127.0.0.1:{cserver.port}"
    reps, router, engines = {}, None, []
    try:
        # setup: one step-4 checkpoint in a HostDRAMStore, two replicas
        # loading it, the router in front
        trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
        it = ShardedDataIterator(
            synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH,
            seed=SEED)
        store = HostDRAMStore()
        state, _ = _train_and_spill(trainer, trainer.init_state(), it, store, 4)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out["parts_s"]["checkpoint"] = t0 - t_phase
        engines = [DecodeEngine(model, device="cuda", max_seqs=8, block_tokens=16, store=store)
                   for _ in range(2)]
        admitted = []
        for eng, rid in zip(engines, ("fleet-a", "fleet-b")):
            reps[rid] = _fleet_replica(eng, caddr, rid)
            _record_admissions(reps[rid], admitted)
        router = route_run(caddr, port=_free_port(), host="127.0.0.1", probe_interval_s=0.1)
        rbase = f"http://127.0.0.1:{router.port}"
        for rid in reps:
            _wait_route(rbase, rid)
        out["start_s"] = out["parts_s"]["start"] = time.perf_counter() - t0
        ea, eb = engines
        a_base, b_base = (f"http://{reps[r].address}" for r in ("fleet-a", "fleet-b"))
        if not (ea.weights_step == eb.weights_step == 4
                and ea.pool.num_blocks == 8 * ea.blocks_per_seq + 1
                and ea.pool.nbytes() // ea.pool.num_blocks == block_bytes):
            fail(f"fleet: weights steps {ea.weights_step}/{eb.weights_step}, "
                 f"{ea.pool.num_blocks} blocks of {ea.pool.nbytes() // ea.pool.num_blocks} B")

        # 1. spread and affinity: each group's first request, then the
        # other six at once, every one streamed through the router
        rng = np.random.RandomState(SEED + 9)
        bt = 16
        prefixes = [rng.randint(3, vocab, size=FLEET_PREFIX_BLOCKS * bt) for _ in range(2)]
        groups = [[np.concatenate([pre, rng.randint(3, vocab, size=n)]) for n in FLEET_TAILS]
                  for pre in prefixes]
        _reset_launches()
        res = {}
        first_a = {}

        def first(g):
            res[(g, 0)] = _stream(rbase, groups[g][0], FLEET_NEW,
                                  on_token=lambda n: n == 1 and first_a.setdefault(g, True))

        th = threading.Thread(target=first, args=(0,))
        th.start()
        deadline = time.monotonic() + 120
        while not first_a.get(0):
            if time.monotonic() > deadline or not th.is_alive() and not first_a.get(0):
                fail(f"fleet spread: the first request never streamed: {res.get((0, 0))}")
            time.sleep(0.002)
        # the router's probe must see the first replica busy before the
        # second group's first request goes out: then it goes elsewhere
        while not any(r["in_flight"] > 0 for r in _get(rbase + "/routes")["replicas"]):
            if time.monotonic() > deadline:
                fail("fleet spread: the router never saw the busy replica")
            time.sleep(0.005)
        first(1)
        th.join(timeout=300)
        threads = [threading.Thread(target=lambda g=g, i=i: res.__setitem__(
            (g, i), _stream(rbase, groups[g][i], FLEET_NEW))) for g in (0, 1) for i in (1, 2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches = _all_launches()
        out["parts_s"]["spread"] = time.perf_counter() - t0 - out["parts_s"]["start"]
        if any(launches.values()):
            fail(f"fleet spread (chunked posture) launched {launches}")
        where = {}
        for rid, n, head, tail in admitted:
            for g in (0, 1):
                for i in range(4):
                    p = groups[g][i]
                    if n == len(p) and head == tuple(p[:4]) and tail == tuple(p[-4:]):
                        where[(g, i)] = rid
        placement, reused = {}, {}
        for g in (0, 1):
            for i in range(4):
                _stream_ok(res[(g, i)], FLEET_NEW, f"fleet spread: group {g} request {i}")
                reused[(g, i)] = res[(g, i)]["done"]["reused_blocks"]
            home = where[(g, 0)]
            on_home = [i for i in range(1, 4) if where.get((g, i)) == home]
            placement[g] = {"replica": home, "followers_on_it": len(on_home),
                            "at": [where.get((g, i)) for i in range(4)],
                            "reused": [reused[(g, i)] for i in range(4)]}
            if len(on_home) + 1 < 3 or any(reused[(g, i)] != FLEET_PREFIX_BLOCKS for i in on_home):
                fail(f"fleet affinity: group {g} {placement[g]} (want >= 3 of 4 on "
                     f"{home}, each follower there reusing {FLEET_PREFIX_BLOCKS} blocks)")
        if {placement[0]["replica"], placement[1]["replica"]} != set(reps):
            fail(f"fleet spread: both groups landed on one replica: {placement}")
        prompts = [groups[g][i] for g in (0, 1) for i in range(4)]
        served = [res[(g, i)]["tokens"] for g in (0, 1) for i in range(4)]
        ttft = [res[(g, i)]["ttft_ms"] for g in (0, 1) for i in range(4)]
        out["spread"] = {"placement": placement, "ttft_ms": ttft,
                         "recompute": _recompute_check(ea, prompts, served)}
        # router overhead on TTFT: pairs of one warm prompt of group 0,
        # once through the router and once straight to the replica that
        # holds its prefix, one request at a time, the order alternating
        t_part = time.perf_counter()
        home = placement[0]["replica"]
        direct = f"http://{reps[home].address}"
        pairs = []
        for j in range(FLEET_TTFT_PAIRS):
            p = np.concatenate([prefixes[0], rng.randint(3, vocab, size=rng.randint(1, bt))])
            legs = ("router", "direct") if j % 2 == 0 else ("direct", "router")
            got = {leg: _stream(rbase if leg == "router" else direct, p, 2) for leg in legs}
            for leg, r in got.items():
                _stream_ok(r, 2, f"fleet TTFT pair {j} ({leg})")
                if r["done"]["reused_blocks"] != FLEET_PREFIX_BLOCKS:
                    fail(f"fleet TTFT pair {j} ({leg}): {r['done']['reused_blocks']} reused "
                         f"blocks, want {FLEET_PREFIX_BLOCKS} (the router left {home}?)")
            pairs.append((got["router"]["ttft_ms"], got["direct"]["ttft_ms"]))
        via, straight = np.array(pairs).T
        diff = via - straight
        out["ttft"] = {
            "pairs": FLEET_TTFT_PAIRS, "reused_blocks_each": FLEET_PREFIX_BLOCKS,
            "router_p50_ms": float(np.median(via)), "direct_p50_ms": float(np.median(straight)),
            # router minus direct, pair by pair
            "overhead_p50_ms": float(np.median(diff)),
            "overhead_p10_p90_ms": [float(x) for x in np.percentile(diff, [10, 90])],
            "overhead_min_max_ms": [float(diff.min()), float(diff.max())],
            "router_ms": via.tolist(), "direct_ms": straight.tolist(),
        }
        out["parts_s"]["ttft"] = time.perf_counter() - t_part

        # 2. drain with migration.  First the unmigrated run, alone on
        # the survivor, then the same prompt through the router to A,
        # drained onto B after 16 tokens
        t_part = time.perf_counter()
        mprompt = rng.randint(3, vocab, size=FLEET_MIGRATE_PROMPT)
        times = []
        ref_t = reps["fleet-b"].gen_batcher.submit_generate(
            {"tokens": mprompt.tolist()}, max_new_tokens=FLEET_MIGRATE_NEW,
            deadline_s=600.0,
            on_event=lambda ev: "token" in ev and times.append(time.perf_counter()))
        ref_tokens, _ = ref_t.result(timeout=600)
        unmigrated_rest_s = times[-1] - times[FLEET_MIGRATE_AT - 1]
        exported, imported, adopted = {}, {}, {}
        gb = reps["fleet-b"].gen_batcher
        real_export, real_import, real_adopt = ea.export_kv, eb.import_kv, gb.adopt

        # The wrappers only time and keep references: the read-back of
        # what landed on B comes after the drain's ack, off its clock.
        def export_kv(ids):
            # the device -> pinned host gather, waited on its event
            t = time.perf_counter()
            k, v = real_export(ids)
            exported.update(blocks=len(ids), k=k, v=v, s=time.perf_counter() - t)
            return k, v

        def import_kv(ids, k, v):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            t = time.perf_counter()
            ev[0].record()
            real_import(ids, k, v)
            ev[1].record()
            # k and v view the receiver's own buffer for this push
            imported.update(ids=list(ids), k=k, v=v, s=time.perf_counter() - t, events=ev)

        def adopt(t, *a):
            adopted.update(t=t, length=int(t.length))
            return real_adopt(t, *a)

        ea.export_kv, eb.import_kv, gb.adopt = export_kv, import_kv, adopt
        drain = {}

        def read_back():
            """B's adopted blocks, read while the sequence still decodes
            there: every position written before the freeze (decode
            writes only later ones) against the bytes handed to the
            import."""
            with gb.frozen():
                t, ids = adopted.get("t"), imported.get("ids")
                held = t is not None and (t in gb._active
                                          or any(e[0] is t for e in gb._adopted))
                if not held or ids is None or t.blocks[:len(ids)] != ids:
                    return None
                rk, rv = eb.export_kv(ids)
            n = adopted["length"]

            def positions(x):  # [layers, n, bt, heads, hd] -> the first n positions
                y = x.view(torch.int16)
                return y.reshape(y.shape[0], -1, *y.shape[3:])[:, :n]

            return all(torch.equal(positions(r), positions(g))
                       for r, g in ((rk, imported["k"]), (rv, imported["v"])))
        retries0 = telemetry.get_registry().counter("edl_route_retries_total").value(
            reason="draining")

        def drain_a():
            with _post(rbase + "/drain_intent", {"replicas": ["fleet-a"]}) as r:
                r.read()
            t = time.perf_counter()
            with _post(a_base + "/drain", {"budget_ms": 60000, "migrate_to": reps[
                    "fleet-b"].address}) as r:
                drain["ack"] = json.loads(r.read())
            drain["s"] = time.perf_counter() - t
            drain["tokens_at_ack"] = ntok_seen[0]
            drain["read_back"] = read_back()

        ntok_seen = [0]
        drainer = threading.Thread(target=drain_a)

        def at_token(n):
            ntok_seen[0] = n
            if n == FLEET_MIGRATE_AT:
                drainer.start()

        _reset_launches()
        migrated = _stream(rbase, mprompt, FLEET_MIGRATE_NEW, on_token=at_token)
        drainer.join(timeout=120)
        launches = _all_launches()
        ea.__dict__.pop("export_kv", None)
        eb.__dict__.pop("import_kv", None)
        gb.__dict__.pop("adopt", None)
        torch.cuda.synchronize()
        _stream_ok(migrated, FLEET_MIGRATE_NEW, "fleet drain: the migrated stream")
        ack = drain.get("ack") or fail(f"fleet drain: no ack ({drain})")
        mig = ack.get("migrate") or {}
        if not (ack["drained"] and ack["in_flight"] == 0 and mig.get("migrated") == 1
                and drain["tokens_at_ack"] < FLEET_MIGRATE_NEW):
            fail(f"fleet drain: ack {ack} with {drain['tokens_at_ack']} tokens streamed")
        if [a[0] for a in admitted if a[2] == tuple(mprompt[:4])] != ["fleet-b", "fleet-a"]:
            fail(f"fleet drain: the prompt was admitted by {admitted[-2:]}, want fleet-a "
                 "(after the survivor's unmigrated run)")
        if migrated["tokens"] != ref_tokens:
            first_diff = next(i for i, (x, y) in enumerate(zip(migrated["tokens"], ref_tokens))
                              if x != y)
            fail(f"fleet drain: the migrated stream differs from the unmigrated run from "
                 f"token {first_diff}")
        # A's gather, byte for byte, is what reached B's import, and what
        # landed in B's pool
        if not (exported and imported and exported["blocks"] == len(imported["ids"])
                and torch.equal(exported["k"].view(torch.int16), imported["k"].view(torch.int16))
                and torch.equal(exported["v"].view(torch.int16), imported["v"].view(torch.int16))):
            fail("fleet drain: the survivor's import was not handed the exported bytes")
        if drain.get("read_back") is not True:
            fail(f"fleet drain: B's pool after adoption {drain.get('read_back')} (True: its "
                 f"{adopted.get('length')} written positions are the exported bytes)")
        import_device_s = imported["events"][0].elapsed_time(imported["events"][1]) / 1e3
        nblk = exported["blocks"]
        # the drain goes out when the client sees token 16: the freeze
        # lands after token 16 or 17 (1039 or 1040 positions written: 65
        # blocks), or 18 if the drain came a decode step late (66)
        want_blk = -(-(FLEET_MIGRATE_PROMPT + FLEET_MIGRATE_AT) // bt)
        if mig["bytes"] != nblk * block_bytes or not want_blk <= nblk <= want_blk + 1:
            fail(f"fleet drain: {mig['bytes']} bytes for {nblk} blocks of {block_bytes} B "
                 f"(want {want_blk} blocks, {want_blk + 1} if the freeze came a token late)")
        if any(launches.values()):
            fail(f"fleet drain (chunked posture) launched {launches}")
        steers = [e for e in telemetry.get_recorder().events() if e.kind == "route.steer"
                  and e.data.get("replica") == "fleet-a"]
        starts = [e for e in telemetry.get_recorder().events() if e.kind == "serve.drain"
                  and e.data.get("replica") == "fleet-a" and e.data.get("phase") == "start"]
        retries = telemetry.get_registry().counter("edl_route_retries_total").value(
            reason="draining") - retries0
        if not (steers and starts and steers[0].seq < starts[0].seq) or retries:
            fail(f"fleet drain: the router steered at {[e.seq for e in steers]}, the drain "
                 f"started at {[e.seq for e in starts]}, {retries} 503s absorbed")
        deadline = time.monotonic() + 10
        while "fleet-a" in coord.members():
            if time.monotonic() > deadline:
                fail(f"fleet drain: fleet-a still registered: {coord.members()}")
            time.sleep(0.01)
        after = [_stream(rbase, p, 8) for p in groups[0][:2]]
        for r in after:
            _stream_ok(r, 8, "fleet drain: a request after the drain")
        try:
            _post(a_base + "/generate", {"inputs": {"tokens": [5, 6]}, "max_new_tokens": 2})
            fail("fleet drain: the drained replica still admits")
        except urllib.error.HTTPError as e:
            if e.code != 503:
                fail(f"fleet drain: the drained replica answered {e.code}, want 503")
        out["drain"] = {
            "seconds": drain["s"], "ack": ack, "tokens_at_ack": drain["tokens_at_ack"],
            "blocks": nblk, "bytes": mig["bytes"], "block_bytes": block_bytes,
            # freeze -> every sequence snapshotted (gather, block-major
            # copy, leaf crc32s); connect -> the survivor's adoption ack;
            # the gather and the import alone, each waited on the card
            "freeze_export_s": mig["export_s"], "push_s": mig["push_s"],
            # the import: the call's host wall (what the push waits for)
            # and the card's time between events around it
            "gather_s": exported["s"], "import_s": imported["s"],
            "import_device_s": import_device_s,
            "gather_gb_s": mig["bytes"] / exported["s"] / 1e9,
            "push_gb_s": mig["bytes"] / mig["push_s"] / 1e9,
            "import_gb_s": mig["bytes"] / import_device_s / 1e9,
            "read_back_positions": adopted["length"],
            "unmigrated_rest_s": unmigrated_rest_s,
            "unmigrated_rest_tokens": FLEET_MIGRATE_NEW - FLEET_MIGRATE_AT,
            "bit_identical": True, "kv_round_trip": True, "kv_in_pool": True,
            "steer_seq": steers[0].seq, "drain_start_seq": starts[0].seq,
            "absorbed_503s": retries, "requests_after": [r["status"] for r in after],
        }

        out["parts_s"]["drain"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # 3. re-drive: A afresh and B, both monolithic; A dies mid-stream
        reps.pop("fleet-a").stop()
        reps["fleet-a"] = _fleet_replica(ea, caddr, "fleet-a", chunked=False)
        _record_admissions(reps["fleet-a"], admitted)
        gb = reps["fleet-b"].gen_batcher
        with gb.frozen():
            gb.chunked_prefill = False
        # the router's view of the fresh A keeps the dead A's load
        # figures until its first probe: stream once the router orders
        # A first
        _wait_route(rbase, "fleet-a", reps["fleet-a"].address, first=True)
        routes_before = _get(rbase + "/routes")["replicas"]
        rprompt = rng.randint(3, vocab, size=FLEET_REDRIVE_PROMPT)
        kill = {}

        def at_kill(n):
            if n == FLEET_REDRIVE_AT:
                kill["t"] = time.perf_counter()
                kill["before"] = _all_launches()
                _reset_launches()
                reps["fleet-a"].die()

        _reset_launches()
        redriven = _stream(rbase, rprompt, FLEET_REDRIVE_NEW, on_token=at_kill)
        torch.cuda.synchronize()
        leg = _all_launches()
        _stream_ok(redriven, FLEET_REDRIVE_NEW, "fleet re-drive")
        legs = [a for a in admitted if a[2] == tuple(rprompt[:4])]
        if [a[0] for a in legs] != ["fleet-a", "fleet-b"]:
            fail(f"fleet re-drive: admissions {legs}, want fleet-a then fleet-b; the router's "
                 f"table just before the stream: {routes_before}")
        resumed_len = legs[-1][1]
        if redriven["done"].get("redriven") != 1 or resumed_len <= len(rprompt):
            fail(f"fleet re-drive: done line {redriven['done']}, resumed prompt {resumed_len}")
        if kill["before"]["flash_fwd"] != layers or leg["flash_fwd"] != layers:
            fail(f"fleet re-drive: flash_fwd launched {kill['before']['flash_fwd']} for A's "
                 f"prefill and {leg['flash_fwd']} for the resumed one (want {layers} each)")
        t_after = [t for t, ev in redriven["lines"] if "token" in ev and t > kill["t"]]
        t_before = [t for t, ev in redriven["lines"] if "token" in ev and t <= kill["t"]]
        out["redrive"] = {
            "resumed_prompt": resumed_len, "tokens_before_kill": len(t_before),
            "gap_ms": (t_after[0] - t_before[-1]) * 1e3,
            "launches_a_prefill": kill["before"], "launches_resumed_leg": leg,
            "routes_before": routes_before,
            "recompute": _recompute_check(eb, [rprompt], [redriven["tokens"]]),
        }
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        out["routes"] = _get(rbase + "/routes")
        out["parts_s"]["redrive"] = time.perf_counter() - t_part
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        if router is not None:
            router.stop()
        for r in reps.values():
            if not r._dead:
                r.stop()
        cserver.stop()
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    log({"serving_fleet": out})
    return out


# -- phase 10 -------------------------------------------------------------

#: the trainer pod's process: ``python -m edl_tpu_torch.launcher`` (run
#: through runpy), which at exit writes its kernel launch counts and its
#: peak device memory to the file named by its first argument, and dumps
#: its threads' stacks on SIGUSR1
CP_POD = r"""
import atexit, faulthandler, json, runpy, signal, sys
faulthandler.register(signal.SIGUSR1, all_threads=True)
out = sys.argv.pop(1)

def dump():
    import resource
    import torch
    import chip_smoke
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    with open(out, "w") as f:
        json.dump({"launches": chip_smoke._all_launches(), "peak_bytes": peak,
                   "max_rss_mb": rss}, f)

atexit.register(dump)
runpy.run_module("edl_tpu_torch.launcher", run_name="__main__", alter_sys=True)
"""
#: the trainer pod's arguments beside its env (the card, full width)
CP_POD_ARGS = ()
#: the in-process runs' model (None: the registered full-width one)
CP_MODEL_KWARGS = None
#: seconds between the trainer's telemetry reports (EDL_TELEMETRY_INTERVAL
#: in the pod's env; the launcher's default, 5 s, would not report
#: within a 12-step run)
CP_TELEMETRY_S = 0.1
#: controller ticks: the period, and the bound on the whole loop
CP_TICK_S = 0.05
CP_TIMEOUT_S = 180
#: the host-only autoscaler tick: 64 nodes x 8 GPUs (8 nodepools of 8
#: a3-highgpu-8g-sized nodes, as KubectlAPI reads them: no pool shape,
#: replicas pack by GPU count), 32 elastic jobs
CP_BIG_NODES = 64
CP_BIG_JOBS = 32
CP_BIG_TICKS = 5


def _cp_job_yaml(name, mn, mx, port, checkpoint_dir=""):
    """The control plane's GPU TrainingJob (transformer_lm on h100-1,
    global batch 8, checkpoint interval 4)."""
    return f"""apiVersion: edl.tpu.dev/v1
kind: TrainingJob
metadata: {{name: {name}}}
spec:
  fault_tolerant: {"true" if mn < mx else "false"}
  global_batch_size: {TRAIN_BATCH}
  checkpoint_interval_steps: {ELASTIC_INTERVAL}
  checkpoint_dir: "{checkpoint_dir}"
  port: {port}
  trainer:
    entrypoint: transformer_lm
    min_instance: {mn}
    max_instance: {mx}
    slice_topology: h100-1
    resources:
      requests: {{cpu: "1", memory: 8Gi}}
      limits: {{nvidia.com/gpu: 1}}
"""


def _host_node(name, gpus):
    """A FakeKube node with this host's CPUs and memory."""
    import os

    from edl_tpu_torch.cluster.kube import NodeInfo

    mem_mb = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // (1 << 20)
    return NodeInfo(name=name, cpu_milli=1000 * (os.cpu_count() or 1), memory_mega=mem_mb,
                    gpus=gpus)


def _cp_history(path):
    import os

    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _cp_big_tick() -> dict:
    """Host-only cost of ``Autoscaler.run_once`` over a FakeKube of
    CP_BIG_NODES 8-GPU nodes, each read from its Node object as
    ``KubectlAPI.list_nodes`` reads it, with CP_BIG_JOBS elastic jobs
    of mixed h100-1/8/16 (in-process coordinators; no kernel runs)."""
    from edl_tpu_torch.autoscaler.scaler import Autoscaler
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.fake_kubectl import node_manifest
    from edl_tpu_torch.cluster.kube import FakeKube, NodeInfo, node_from_manifest
    from edl_tpu_torch.resource.training_job import TrainingJob
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator

    kube = FakeKube([node_from_manifest(node_manifest(NodeInfo(
        name=f"a3-{i:02d}", cpu_milli=208000, memory_mega=1_800_000, gpus=8,
        pool=f"pool-{i // 8}"))) for i in range(CP_BIG_NODES)])
    if any(n.gpu_topology for n in kube.list_nodes()):
        fail("a node read from its Node object declared a pool shape")
    cluster = Cluster(kube)
    coords = {}
    a = Autoscaler(cluster, coord_client_factory=lambda job: coords.setdefault(
        job.name, LocalCoordinator(target_world=1, max_world=job.spec.trainer.max_instance)))
    for k in range(CP_BIG_JOBS):
        gpus = (1, 8, 16)[k % 3]
        job = TrainingJob.from_manifest({
            "apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob",
            "metadata": {"name": f"j{k:02d}"},
            "spec": {"fault_tolerant": True, "trainer": {
                "min_instance": 1, "max_instance": 4, "slice_topology": f"h100-{gpus}",
                "resources": {"requests": {"cpu": "8", "memory": "64Gi"}}}}}).validate()
        cluster.create_trainer_workload(job)
        a.on_add(job)
    ms = []
    for _ in range(CP_BIG_TICKS):
        t0 = time.perf_counter()
        plan = a.run_once()
        ms.append((time.perf_counter() - t0) * 1e3)
        if plan is None:
            fail("the 64-node autoscaler tick decided nothing")
    r = cluster.inquiry_resource()
    return {"nodes": CP_BIG_NODES, "gpus": r.gpu_total, "jobs": CP_BIG_JOBS,
            "run_once_ms": ms, "first_tick_ms": ms[0],
            "steady_tick_ms_median": float(np.median(ms[1:])), "gpus_in_use": r.gpu_limit,
            "actuations_first_tick": len(a.plans[0].targets)}


def phase_control_plane(card: str):
    """The control plane sizes a trainer pod on the card: a ``Controller``
    and its ``Autoscaler`` over a FakeKube of this machine (gpu-0) and
    one simulated 1-GPU node (gpu-1) grow ``lm`` 1 -> 2, shed it back to
    1 for the pending ``lm-b``, and mark it Succeed when its trainer (the
    launcher, started with the env the job parser rendered) reports
    completion.  Then ``local-run`` on the same configuration, and the
    host cost of a 64-node autoscaler tick."""
    import contextlib
    import inspect
    import io
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from edl_tpu_torch import cli, launcher
    from edl_tpu_torch.autoscaler.scaler import Autoscaler
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.kube import FakeKube
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.controller.jobparser import parse_to_trainer_manifests
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.resource.training_job import TrainingJob
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator

    layers = get_model("transformer_lm", **(CP_MODEL_KWARGS or {})).decode.layers
    want = {"flash_fwd": layers, "flash_bwd": layers, "flash_bwd_streamk": 0,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    out = {"card": card, "steps": ELASTIC_STEPS, "telemetry_interval_s": CP_TELEMETRY_S}
    tmp = tempfile.mkdtemp(prefix="edl-cp-")
    servers, proc = {}, None
    t_phase = time.perf_counter()
    old_template = os.environ.get("EDL_COORD_ADDR_TEMPLATE")
    try:
        # each job's coordinator, found as 127.0.0.1:<the job's port>
        # (the cluster-DNS stand-in of tests/test_control_plane.py)
        for name, mx in (("lm", 2), ("lm-b", 1)):
            servers[name] = CoordinatorServer(
                LocalCoordinator(target_world=1, max_world=mx, heartbeat_timeout=30),
                host="127.0.0.1", port=0).start()
        os.environ["EDL_COORD_ADDR_TEMPLATE"] = "127.0.0.1:{port}"
        coord = servers["lm"].coordinator
        target_at, put_at = [], []
        real_target = coord.set_target_world

        def timed_target(n, trace_id=""):
            real_target(n, trace_id=trace_id)
            target_at.append((n, time.perf_counter()))

        coord.set_target_world = timed_target
        # the trainer's report arrivals and the autoscaler's telemetry
        # reads, each on this process's wall clock
        reports_at, reads = [], []
        real_report, real_telemetry = coord.report_telemetry, coord.telemetry

        def timed_report(trainer_id, *a, **kw):
            reports_at.append((trainer_id, time.time()))
            return real_report(trainer_id, *a, **kw)

        def timed_telemetry():
            tel = real_telemetry()
            reads.append((time.time(), tel["step_rate"]))
            return tel

        coord.report_telemetry, coord.telemetry = timed_report, timed_telemetry
        kube = FakeKube([_host_node("gpu-0", torch.cuda.device_count()), _host_node("gpu-1", 1)])
        out["nodes"] = {"gpu-0": "this machine", "gpu-1": "simulated: no process behind it"}
        log({"control_plane_nodes": {n.name: {"gpus": n.gpus, "cpu_milli": n.cpu_milli,
                                              "memory_mega": n.memory_mega}
                                     for n in kube.list_nodes()}})
        cluster = Cluster(kube)
        real_put = cluster.update_parallelism

        def timed_put(job, n):
            put_at.append((job.name, n, time.perf_counter()))
            return real_put(job, n)

        cluster.update_parallelism = timed_put
        ctrl = Controller(cluster, Autoscaler(cluster))
        job = TrainingJob.from_yaml(_cp_job_yaml("lm", 1, 2, servers["lm"].port, f"{tmp}/ckpt"))
        t_submit = time.time()
        ctrl.on_add(job)
        pod = [p for p in kube.list_pods() if p.job_name == "lm"]
        if len(pod) != 1 or pod[0].node != "gpu-0":
            fail(f"lm's first pod is not on gpu-0: {pod}")
        pod = pod[0]

        # the trainer pod: exactly the rendered env, with the downward
        # API's values and the coordinator's address substituted
        rendered = parse_to_trainer_manifests(job)[0]["spec"]["template"]["spec"]["containers"][0]
        env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
        for e in rendered["env"]:
            env[e["name"]] = e.get("value", "")
        env.update(EDL_POD_NAME=pod.name, EDL_POD_IP="127.0.0.1",
                   EDL_COORDINATOR_ADDR=f"127.0.0.1:{servers['lm'].port}",
                   EDL_TELEMETRY_INTERVAL=str(CP_TELEMETRY_S))
        out["pod_env"] = {e["name"]: env[e["name"]] for e in rendered["env"]}
        hist = f"{tmp}/history.jsonl"
        pod_out = f"{tmp}/pod.json"
        if rendered["command"] != ["python", "-m", "edl_tpu_torch.launcher"]:
            fail(f"the trainer pod's command is {rendered['command']}")
        t_pod = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", CP_POD, pod_out, "--steps", str(ELASTIC_STEPS),
             "--history-file", hist, *CP_POD_ARGS],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        pod_log = []
        threading.Thread(target=lambda: pod_log.extend(proc.stdout), daemon=True).start()

        ticks, states, parallelism, prewarm_alone, decisions = [], [], [], None, []
        lm_b, n_plans = None, 0
        parallelism.append(kube.get_workload("lm-trainer").parallelism)
        deadline = time.monotonic() + CP_TIMEOUT_S
        while True:
            if time.monotonic() > deadline:
                if proc.poll() is None:
                    proc.send_signal(signal.SIGUSR1)  # the pod's stacks into its log
                    time.sleep(2)
                tail = b"".join(pod_log).decode(errors="replace")[-6000:]
                fail(f"control plane: no Succeed within {CP_TIMEOUT_S} s "
                     f"(trainer rc {proc.poll()}, states {states}, parallelism "
                     f"{parallelism}); the pod's log ends:\n{tail}")
            t0 = time.perf_counter()
            n_reads = len(reads)
            ctrl.run_once()
            ticks.append((time.perf_counter() - t0) * 1e3)
            # each decision on lm that observed a step rate, with the
            # telemetry read of this tick that gave it
            for p in ctrl.autoscaler.plans[n_plans:]:
                for d in p.decisions or ():
                    rate = d["observed"].get("step_rate") if d["job"] == "lm" else None
                    if rate:
                        read = [t for t, r in reads[n_reads:] if r == rate]
                        decisions.append((read[-1] if read else None, rate))
            n_plans = len(ctrl.autoscaler.plans)
            st = ctrl.jobs["lm"].status.state.value
            if not states or states[-1] != st:
                states.append(st)
            w = kube.get_workload("lm-trainer")
            if not parallelism or parallelism[-1] != w.parallelism:
                parallelism.append(w.parallelism)
            plan = coord.plan()
            if (prewarm_alone is None and plan is not None and plan.prewarm == 2
                    and coord.members() == [pod.name]):
                prewarm_alone = {"prewarm": plan.prewarm, "members": coord.members(),
                                 "world_size": plan.world_size, "generation": plan.generation}
            # lm-b arrives once the trainer steps (its first harvested step)
            if (lm_b is None and parallelism == [1, 2]
                    and any("step" in x for x in _cp_history(hist))):
                lm_b = ctrl.on_add(TrainingJob.from_yaml(
                    _cp_job_yaml("lm-b", 1, 1, servers["lm-b"].port)))
                t_lm_b = time.perf_counter()
            if st == "Succeed":
                break
            time.sleep(CP_TICK_S)
        rc = proc.wait(timeout=120)
        out["trainer_wall_s"] = time.perf_counter() - t_pod
        if rc != 0:
            tail = b"".join(pod_log).decode(errors="replace")[-6000:]
            fail(f"the trainer pod exited {rc}; its log ends:\n{tail}")
        with open(pod_out) as f:
            pod_stats = json.load(f)
        out["trainer_peak_gb"] = pod_stats["peak_bytes"] / 1e9
        out["trainer_max_rss_mb"] = pod_stats["max_rss_mb"]
        out["controller_run_once_ms"] = [round(t, 3) for t in ticks]
        out["controller_run_once_ms_p50_p90_max"] = [
            float(np.percentile(ticks, 50)), float(np.percentile(ticks, 90)), max(ticks)]
        out["states"] = states
        out["parallelism"] = parallelism
        out["prewarm_while_alone"] = prewarm_alone
        if states != ["Running", "Succeed"]:
            fail(f"lm's states were {states}, want Running then Succeed")
        if parallelism != [1, 2, 1]:
            fail(f"lm's parallelism went {parallelism}, want 1 -> 2 -> 1")
        if not prewarm_alone or prewarm_alone["members"] != [pod.name]:
            fail("the plan never carried prewarm 2 with the trainer its only member: "
                 f"{prewarm_alone}")
        b_pods = [(p.phase, p.node) for p in kube.list_pods() if p.job_name == "lm-b"]
        if b_pods != [("Running", "gpu-1")]:
            fail(f"lm-b's pods are {b_pods}, want one Running on gpu-1")
        sims = [p.name for p in kube.list_pods() if p.job_name == "lm" and p.node == "gpu-1"]
        if sims:
            fail(f"the simulated lm pod on gpu-1 survived the shed: {sims}")
        if (kube.get_workload("lm-coordinator") is not None
                or kube.get_workload("lm-trainer") is None):
            fail("Succeed must delete lm's coordinator workload and keep its trainer workload")
        grow = [t for name, n, t in put_at if name == "lm" and n == 2]
        retarget = [t for n, t in target_at if n == 2]
        if not grow or not retarget:
            fail(f"no PUT / retarget to 2: {put_at} {target_at}")
        out["put_to_target_ms"] = (retarget[0] - grow[0]) * 1e3
        shed = [t for name, n, t in put_at if name == "lm" and n == 1]
        out["lm_b_to_shed_put_ms"] = (shed[0] - t_lm_b) * 1e3 if shed else None

        # the trainer: one generation, 12 steps, the kernels every step
        h = _cp_history(hist)
        steps = [x for x in h if "step" in x]
        resizes = [x["resize"] for x in h if "resize" in x]
        if [x["step"] for x in steps] != list(range(ELASTIC_STEPS)):
            fail(f"the trainer logged steps {[x['step'] for x in steps]}")
        if len(resizes) != 1 or {x["world_size"] for x in steps} != {1}:
            fail(f"the trainer resized after its first generation: {resizes}")
        out["submit_to_first_step_s"] = steps[0]["t"] - t_submit
        expect = {k: v * ELASTIC_STEPS for k, v in want.items()}
        out["trainer_launches"] = pod_stats["launches"]
        if pod_stats["launches"] != expect:
            fail(f"the trainer pod launched {pod_stats['launches']}, want {expect}")

        # the observed step rate against the trainer's own.  A decision's
        # rate is the reported step count's change over the coordinator's
        # last `rate_window` reports before its read (the aggregator's
        # public default).  The history's rate over the same reports is
        # the steps the trainer logged between their arrivals, divided by
        # the time between those arrivals on this process's clock: the
        # count is the trainer's own, the window and its length the
        # smoke's.  (The steps' own first-to-last span is no rate: the
        # trainer harvests them in bursts.)
        from edl_tpu_torch.telemetry.aggregate import TelemetryAggregator

        window = inspect.signature(TelemetryAggregator).parameters["rate_window"].default
        mine = [t for src, t in reports_at if src == pod.name]
        checked = []
        for t_read, rate in decisions:
            pts = [t for t in mine if t_read is not None and t <= t_read][-window:]
            if len(pts) >= 2:
                k = sum(1 for x in steps if pts[0] < x["t"] <= pts[-1])
                checked.append({"observed": rate, "history": k / (pts[-1] - pts[0]),
                                "steps": k, "reports": len(pts),
                                "reports_span_s": pts[-1] - pts[0]})
        # A step harvested while a report is in flight may fall on the
        # other side of a window's edge; the mean over the decisions is
        # held to the bar, each one printed beside it.
        out["step_rate_decisions"] = len(decisions)
        out["step_rate_unpaired"] = sum(1 for t, _ in decisions if t is None)
        out["step_rate_checked"] = checked
        out["history_steps_per_s"] = (len(steps) - 1) / (steps[-1]["t"] - steps[0]["t"])
        if len(checked) < 3:
            fail(f"{len(checked)} autoscaler decisions observed a step rate from the trainer's "
                 f"reports, want 3 or more ({len(decisions)} with a rate)")
        rates = {"observed": float(np.mean([c["observed"] for c in checked])),
                 "history": float(np.mean([c["history"] for c in checked])),
                 "decisions": len(checked),
                 "worst": max(checked, key=lambda c: abs(c["observed"] - c["history"]))}
        out["step_rate"] = rates
        if abs(rates["observed"] - rates["history"]) > 0.2 * rates["history"]:
            fail(f"the observed step rate {rates['observed']} is not within 20% of the "
                 f"trainer's {rates['history']} over the same reports ({rates})")

        # the same configuration in-process, no coordinator: bit-identical
        _reset_launches()
        ref = launcher.run("transformer_lm", steps=ELASTIC_STEPS, seed=SEED,
                           global_batch_size=TRAIN_BATCH, checkpoint_interval=ELASTIC_INTERVAL,
                           lr=TRAIN_LR, device="cuda", model_kwargs=CP_MODEL_KWARGS)
        ref_losses = [r.loss for r in ref.history]
        _check_run_launches(ref, want, "control plane reference")
        if [x["loss"] for x in steps] != ref_losses:
            fail(f"the trainer pod's losses {[x['loss'] for x in steps]} are not bit-identical "
                 f"to launcher.run's {ref_losses}")
        out["losses"] = ref_losses
        del ref
        torch.cuda.empty_cache()

        # local-run on a YAML of the same configuration
        spec = f"{tmp}/lm.yaml"
        with open(spec, "w") as f:
            f.write(_cp_job_yaml("lm", 1, 2, servers["lm"].port, f"{tmp}/local-run"))
        buf = io.StringIO()
        args = ["local-run", spec, "--steps", "4"] + (
            ["--device", "cpu", "--tiny"] if CP_MODEL_KWARGS else [])
        with contextlib.redirect_stdout(buf):
            if cli.main(args) != 0:
                fail("local-run failed")
        text = buf.getvalue()
        summary = json.loads(text[text.index("{"):])
        out["local_run"] = summary
        if summary["world_sizes_seen"] != [1] or summary["final_loss"] != round(ref_losses[3], 4):
            fail(f"local-run printed {summary}, want world sizes [1] and final loss "
                 f"{round(ref_losses[3], 4)}")
        torch.cuda.empty_cache()
        out["autoscaler_64_nodes"] = _cp_big_tick()
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for s in servers.values():
            s.stop()
        if old_template is None:
            os.environ.pop("EDL_COORD_ADDR_TEMPLATE", None)
        else:
            os.environ["EDL_COORD_ADDR_TEMPLATE"] = old_template
        shutil.rmtree(tmp, ignore_errors=True)
    log({"control_plane": out})
    return out


# -- phase 11 -------------------------------------------------------------

#: the fleet market's trainer pod: CP_POD, and after a SIGUSR2 the same
#: dump at the next step boundary, where every dispatched step's
#: launches are counted (a pod stopped by SIGTERM leaves through
#: ``os._exit``, past atexit)
FM_POD = CP_POD.replace("atexit.register(dump)\n", r"""atexit.register(dump)
from edl_tpu_torch.runtime import elastic
asked = []
signal.signal(signal.SIGUSR2, lambda *a: asked.append(1))
real_maybe_resize = elastic.ElasticTrainer.maybe_resize

def maybe_resize(self):
    if asked:
        asked.clear()
        dump()
    return real_maybe_resize(self)

elastic.ElasticTrainer.maybe_resize = maybe_resize
""")
#: ``hi``'s pod arguments beside its env (the card, full width), and
#: ``lo``'s: two members of a gloo world on the CPU at the tiny size
FM_HI_ARGS = ()
FM_LO_ARGS = ("--device", "cpu", "--tiny")
#: the serving replicas' model and device (None: the full-width one)
FM_MODEL_KWARGS = None
FM_DEVICE = "cuda"
#: controller ticks (Controller.run_once) and the bound on every wait
FM_TICK_S = 0.5
FM_CALM_TICKS = 2
FM_WAIT_S = 120
#: the spike: concurrent streams through the router, prompt lengths,
#: new tokens; the generation running when the lane sheds; the TTFT
#: probes before and after the spike, one at a time
FM_SPIKE_STREAMS = 24
FM_SPIKE_MAX = 600
FM_SPIKE_PROMPTS = (1024, 1900)
FM_SPIKE_NEW = 32
FM_LONG_PROMPT = 1024
FM_LONG_NEW = 256
FM_PROBES = 4
FM_RECOMPUTE = 8  # spike streams held to a full recompute, per replica
FM_PROBE_PROMPT = 1024
#: the serving lane's thresholds (queue_high is the lane's default, 8)
FM_TTFT_HIGH_S = 0.5
FM_HOLD_TICKS = 2
#: hi's first steps held bit for bit against launcher.run
FM_HI_REF_STEPS = 12
#: the trainers' checkpoint interval: a full-width host checkpoint (its
#: copy and crc) every 4 steps would load the host the replicas share
FM_CKPT_INTERVAL = 200


def _fm_job_yaml(name, mn, mx, port, priority):
    """A prioritized GPU TrainingJob: ``_cp_job_yaml``'s configuration
    (transformer_lm on h100-1, global batch 8) with ``spec.priority``
    and a checkpoint every FM_CKPT_INTERVAL steps."""
    return _cp_job_yaml(name, mn, mx, port).replace(
        "spec:\n", f"spec:\n  priority: {priority}\n", 1).replace(
        f"checkpoint_interval_steps: {ELASTIC_INTERVAL}",
        f"checkpoint_interval_steps: {FM_CKPT_INTERVAL}")


def _pod_env(job, pod_name, coord_port, **extra):
    """The env the job parser renders for ``job``'s trainer pod, with the
    downward API's values and the coordinator's address substituted."""
    import os

    from edl_tpu_torch.controller.jobparser import parse_to_trainer_manifests

    rendered = parse_to_trainer_manifests(job)[0]["spec"]["template"]["spec"]["containers"][0]
    if rendered["command"] != ["python", "-m", "edl_tpu_torch.launcher"]:
        fail(f"{job.name}'s pod command is {rendered['command']}")
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    for e in rendered["env"]:
        env[e["name"]] = e.get("value", "")
    env.update(EDL_POD_NAME=pod_name, EDL_POD_IP="127.0.0.1",
               EDL_COORDINATOR_ADDR=f"127.0.0.1:{coord_port}", **extra)
    return env


def _quantiles(xs):
    return ([float(np.percentile(xs, 50)), float(np.percentile(xs, 95))] if xs else None)


def phase_fleet_market(card: str):
    """Phase 11 (``_fleet_market``) with a fresh registry and flight
    recorder: the serving lane's first read of a TTFT series is its
    whole cumulative histogram, which in this process also holds the
    earlier phases' requests."""
    from edl_tpu_torch import telemetry

    with telemetry.scoped():
        return _fleet_market(card)


def _fleet_market(card: str):
    """The fleet market moves a serving spike's GPU between the port's
    trainers and replicas.  A ``Controller`` over a FakeKube of this
    machine (gpu-0) and three simulated 1-GPU nodes holds two prioritized
    jobs, so ``_maybe_attach_fleet`` builds the arbiter: ``hi`` (priority
    10, min = max = 1, full width on the card) and ``lo`` (priority 1,
    sizes 1 and 2, two launcher processes in a gloo world on the CPU at
    the tiny size).  The serving fleet ``api`` (replica A by
    ``serve_run`` from a HostDRAMStore spill, behind ``route_run``; its
    own coordinator and ``ServingLane``) bids with priority 100: 4 GPUs,
    2 + 1 + 1, calm is full.  A spike of streamed requests takes ``lo``'s
    second GPU for replica B (loading the checkpoint's DRAM copy); when
    it clears, ``api`` sheds B, migrating a live generation to A, and
    ``lo`` grows back."""
    import contextlib
    import gc
    import io
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from edl_tpu_torch import cli, launcher, telemetry
    from edl_tpu_torch.autoscaler import serving as serving_lane
    from edl_tpu_torch.autoscaler.scaler import Autoscaler
    from edl_tpu_torch.autoscaler.serving import ServingLane
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.kube import FakeKube, NodeInfo
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.fleet import ServingBidder
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.resource.training_job import TrainingJob
    from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer, HTTPCoordinator
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator
    from edl_tpu_torch.serving import DecodeEngine
    from edl_tpu_torch.serving.router import route_run
    from edl_tpu_torch.serving.server import serve_run

    model = get_model("transformer_lm", **(FM_MODEL_KWARGS or {}))
    spec = model.decode
    vocab, layers = spec.vocab_size, spec.layers
    block_bytes = (2 * layers * 16 * spec.heads * spec.head_dim
                   * torch.empty((), dtype=spec.cache_dtype).element_size())
    hi_layers = get_model("transformer_lm", **(CP_MODEL_KWARGS or {})).decode.layers
    hi_want = {"flash_fwd": hi_layers, "flash_bwd": hi_layers, "flash_bwd_streamk": 0,
               "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    t_phase = time.perf_counter()
    out = {"card": card, "parts_s": {}, "tick_s": FM_TICK_S}
    tmp = tempfile.mkdtemp(prefix="edl-fm-")
    servers, procs, pod_logs, reps, router = {}, {}, {}, {}, None
    old_template = os.environ.get("EDL_COORD_ADDR_TEMPLATE")
    real_post_drain = serving_lane.post_drain
    rng = np.random.RandomState(SEED + 11)
    try:
        # -- setup 1: the control plane and the trainer pods (they start
        # while the checkpoint and the serving fleet are made) ------------
        t_trainers = time.perf_counter()
        for name, mx, legal in (("lo", 2, [1, 2]), ("hi", 1, [1])):
            servers[name] = CoordinatorServer(
                LocalCoordinator(target_world=mx, max_world=mx, heartbeat_timeout=60,
                                 legal_sizes=legal),
                host="127.0.0.1", port=0).start()
        lo_coord, hi_coord = servers["lo"].coordinator, servers["hi"].coordinator
        os.environ["EDL_COORD_ADDR_TEMPLATE"] = "127.0.0.1:{port}"
        kube = FakeKube([_host_node("gpu-0", torch.cuda.device_count())]
                        + [NodeInfo(name=f"gpu-{i}", cpu_milli=8000, memory_mega=65536, gpus=1)
                           for i in (1, 2, 3)])
        cluster = Cluster(kube)
        ctrl = Controller(cluster, Autoscaler(cluster))
        jobs = {"hi": ctrl.on_add(TrainingJob.from_yaml(
                    _fm_job_yaml("hi", 1, 1, servers["hi"].port, 10))),
                "lo": ctrl.on_add(TrainingJob.from_yaml(
                    _fm_job_yaml("lo", 1, 2, servers["lo"].port, 1)))}
        cluster.update_parallelism(jobs["lo"], 2)  # lo's world forms at 2
        pods = {n: sorted(p.name for p in kube.list_pods() if p.job_name == n) for n in jobs}
        placement = {p.name: p.node for p in kube.list_pods()}
        if len(pods["hi"]) != 1 or len(pods["lo"]) != 2 or placement[pods["hi"][0]] != "gpu-0":
            fail(f"fleet market: pods {pods} placed {placement}")
        out["nodes"] = {
            "gpu-0": "this machine: hi's pod, and the serving replicas A and B",
            "gpu-1..3": "simulated 1-GPU nodes; lo's two pods are placed there",
            "bypasses": "lo's two members are launcher processes in a gloo world on the CPU "
                        "at the tiny size (--device cpu --tiny): a world of two members needs "
                        "two NCCL ranks and this machine has one card",
            "placement": placement}
        log({"fleet_market_nodes": out["nodes"]})
        hist = {pod: f"{tmp}/{pod}.jsonl" for pod in pods["hi"] + pods["lo"]}
        hi_pod = pods["hi"][0]
        hi_out = f"{tmp}/hi-pod.json"
        env = _pod_env(jobs["hi"], hi_pod, servers["hi"].port,
                       EDL_TELEMETRY_INTERVAL=str(CP_TELEMETRY_S))
        procs[hi_pod] = subprocess.Popen(
            [sys.executable, "-c", FM_POD, hi_out, "--steps", "1000000",
             "--history-file", hist[hi_pod], *FM_HI_ARGS],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pod in pods["lo"]:
            env = _pod_env(jobs["lo"], pod, servers["lo"].port,
                           EDL_POD_ADDRESS=f"127.0.0.1:{_free_port()}",
                           EDL_TELEMETRY_INTERVAL="0.5", OMP_NUM_THREADS="1",
                           CUDA_VISIBLE_DEVICES="")
            procs[pod] = subprocess.Popen(
                [sys.executable, "-c", FM_POD, f"{tmp}/{pod}.json", "--steps", "1000000",
                 "--history-file", hist[pod], *FM_LO_ARGS],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pod, p in procs.items():
            pod_logs[pod] = []
            threading.Thread(target=lambda p=p, log_to=pod_logs[pod]: log_to.extend(p.stdout),
                             daemon=True).start()

        def steps_at(pod, world):
            return [x["step"] for x in _cp_history(hist[pod])
                    if "step" in x and x["world_size"] == world]

        def wait_for(pred, what):
            deadline = time.monotonic() + FM_WAIT_S
            while not pred():
                for pod, p in procs.items():
                    if p.poll() is not None:
                        tail = b"".join(pod_logs[pod]).decode(errors="replace")[-4000:]
                        fail(f"fleet market: pod {pod} exited {p.returncode} waiting for "
                             f"{what}; its log ends:\n{tail}")
                if time.monotonic() > deadline:
                    fail(f"fleet market: no {what} within {FM_WAIT_S} s")
                time.sleep(0.05)

        # -- setup 2: a step-4 checkpoint of the training configuration,
        # spilled (A loads the spill) and kept in DRAM (B loads it there)
        t_ckpt = time.perf_counter()
        trainer = Trainer(model, lr=TRAIN_LR, device=FM_DEVICE, seed=SEED)
        it = ShardedDataIterator(
            synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH,
            seed=SEED)
        store = HostDRAMStore(spill_dir=f"{tmp}/spill")
        state = trainer.init_state()
        while state.step < 4:
            state, _ = trainer.step(state, it.device_batch(state.step, FM_DEVICE))
        store.save_async(state)
        store.wait()
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["parts_s"]["checkpoint"] = time.perf_counter() - t_ckpt

        # -- setup 3: the serving fleet: coordinator, replica A, router ---
        t_part = time.perf_counter()
        servers["api"] = CoordinatorServer(LocalCoordinator(target_world=1, max_world=2),
                                           host="127.0.0.1", port=0).start()
        serve_coord = servers["api"].coordinator
        serve_addr = f"127.0.0.1:{servers['api'].port}"
        old_tel = os.environ.get("EDL_TELEMETRY_INTERVAL")
        os.environ["EDL_TELEMETRY_INTERVAL"] = "0.2"
        try:
            port_a = _free_port()
            reps["api-a"] = serve_run("transformer_lm", coordinator_addr=serve_addr,
                                      checkpoint_dir=f"{tmp}/spill", port=port_a,
                                      pod_address=f"127.0.0.1:{port_a}", replica_id="api-a",
                                      device=FM_DEVICE, host="127.0.0.1",
                                      **(FM_MODEL_KWARGS or {}))
        finally:
            if old_tel is None:
                os.environ.pop("EDL_TELEMETRY_INTERVAL", None)
            else:
                os.environ["EDL_TELEMETRY_INTERVAL"] = old_tel
        with reps["api-a"].gen_batcher.frozen():
            reps["api-a"].gen_batcher.chunked_prefill = False  # every prefill runs B1
        # C-4: a transient fault on A's coordinator client is retried and
        # journaled; A's next report carries it and A's load (serve.swap)
        # into the serving coordinator's merged /telemetry
        client = reps["api-a"].coordinator
        real_open, faults = client._open, [urllib.error.URLError("planted: connection reset")]

        def flaky_open(req):
            if faults:
                raise faults.pop()
            return real_open(req)

        client._open = flaky_open
        deadline = time.monotonic() + FM_WAIT_S
        while True:
            evs = HTTPCoordinator(serve_addr).telemetry()["events"]
            swap = [e for e in evs if e["kind"] == "serve.swap"
                    and e["data"].get("origin") == "api-a"]
            retry = [e for e in evs if e["kind"] == "retry"
                     and e["data"].get("op") == "coordinator request"]
            if swap and retry:
                break
            if time.monotonic() > deadline:
                fail(f"fleet market: the serving coordinator's /telemetry has swap events "
                     f"{swap} and retry events {retry} (want both, from api-a's reports)")
            time.sleep(0.05)
        client.__dict__.pop("_open", None)
        out["c4_events"] = {"serve.swap": swap[0]["data"], "retry": retry[0]["data"]}
        router = route_run(serve_addr, port=_free_port(), host="127.0.0.1", probe_interval_s=0.1)
        rbase = f"http://127.0.0.1:{router.port}"
        _wait_route(rbase, "api-a")
        admitted = []
        _record_admissions(reps["api-a"], admitted)
        out["parts_s"]["serving_start"] = time.perf_counter() - t_part

        # the generation that will be running when the lane sheds: first
        # unmigrated, alone on A
        long_prompt = rng.randint(3, vocab, size=FM_LONG_PROMPT)
        long_ref, _ = reps["api-a"].gen_batcher.submit_generate(
            {"tokens": long_prompt.tolist()}, max_new_tokens=FM_LONG_NEW,
            deadline_s=600.0).result(timeout=600)

        wait_for(lambda: all(len(steps_at(p, 2)) >= 3 for p in pods["lo"]), "lo stepping at 2")
        wait_for(lambda: len(steps_at(hi_pod, 1)) >= 3, "hi stepping")
        out["parts_s"]["trainers_start_to_stepping"] = time.perf_counter() - t_trainers
        hi_gen0 = hi_coord.generation()

        # -- the market: the controller attaches it, api joins it ----------
        ctrl.run_once()  # two live prioritized jobs: _maybe_attach_fleet builds the arbiter
        arbiter = ctrl.autoscaler.fleet_arbiter
        if arbiter is None or sorted(b.name for b in arbiter.trainers) != ["hi", "lo"]:
            fail(f"fleet market: the controller attached {arbiter}")
        if sorted(ctrl._fleet_managed) != ["hi", "lo"] or ctrl.autoscaler.jobs:
            fail(f"fleet market: market jobs {ctrl._fleet_managed}, single lane "
                 f"{list(ctrl.autoscaler.jobs)}")
        lo_bidder = next(b for b in arbiter.trainers if b.name == "lo")
        stamps = {}
        real_actuate, real_wait = lo_bidder.actuate, lo_bidder.wait_drain

        def lo_actuate(units, trace_id):
            stamps.setdefault("lo_decision", []).append(time.perf_counter())
            return real_actuate(units, trace_id)

        def lo_wait(timeout):
            ok = real_wait(timeout)
            stamps.setdefault("lo_ack", []).append((ok, time.perf_counter()))
            return ok

        lo_bidder.actuate, lo_bidder.wait_drain = lo_actuate, lo_wait
        # what lo's coordinator showed when api's retargets landed
        real_serve_target = serve_coord.set_target_world

        def serve_target(n, trace_id=""):
            stamps.setdefault("api_target", []).append((n, lo_coord.metrics()))
            return real_serve_target(n, trace_id=trace_id)

        serve_coord.set_target_world = serve_target
        drains = []

        def post_drain(address, budget_s, **kw):
            t = time.perf_counter()
            ack = real_post_drain(address, budget_s, **kw)
            drains.append({"address": address, "s": time.perf_counter() - t, "ack": ack, **kw})
            return ack

        serving_lane.post_drain = post_drain
        b_state = {}

        def start_b():
            try:
                t = time.perf_counter()
                eng = DecodeEngine(model, device=FM_DEVICE, max_seqs=8, block_tokens=16,
                                   store=store)
                rep = _fleet_replica(eng, serve_addr, "api-b", chunked=False)
                _record_admissions(rep, admitted)
                reps["api-b"] = rep
                b_state["started_s"] = time.perf_counter() - t
            except Exception as e:  # failed on by the main thread
                b_state["error"] = repr(e)

        def on_scale(old, new):
            # the kube glue: a replica more starts on the card (it warms
            # before it registers), a replica less was drained already
            if new > old:
                threading.Thread(target=start_b, daemon=True).start()
            else:
                # B is drained and deregistered; it stops once the
                # stream it relays from A has ended (below)
                b_state["shed_at"] = time.perf_counter()

        lane = ServingLane(HTTPCoordinator(serve_addr), min_replicas=1, max_replicas=2,
                           router=f"127.0.0.1:{router.port}", ttft_high_s=FM_TTFT_HIGH_S,
                           hold_ticks=FM_HOLD_TICKS, on_scale=on_scale)
        arbiter.add_fleet(ServingBidder("api", lane, priority=100))
        records, timeline, tick_ms, arbiter_ms = [], [], [], []
        real_run = arbiter.run_once

        def run_once():
            t0 = time.perf_counter()
            records.append(real_run())
            arbiter_ms.append((time.perf_counter() - t0) * 1e3)
            return records[-1]

        arbiter.run_once = run_once  # attach_fleet's tick calls it by name

        def tick(phase):
            """One ``Controller.run_once``, as ``cli controller`` ticks
            (the market rides its autoscaler tick): the tick's holdings,
            free GPUs and per-job decision entries, and what lo's
            coordinator and trainer workload show after the whole tick."""
            n = len(records)
            t0 = time.perf_counter()
            ctrl.run_once()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            rec = records[n] if len(records) > n else None
            if rec is None:
                fail(f"fleet market: the {phase} tick saw no bidder")
            timeline.append({"t_s": time.perf_counter() - t_phase, "phase": phase,
                             "holdings": dict(rec["inventory"]["holdings"]),
                             "free": rec["free_chips"],
                             "decisions": {d["job"]: d for d in rec["decisions"]},
                             "lo_after_tick": (lo_coord.target_world(),
                                               kube.get_workload("lo-trainer").parallelism)})
            return timeline[-1]

        def probes(what):
            res = [_stream(rbase, rng.randint(3, vocab, size=FM_PROBE_PROMPT), FM_SPIKE_NEW)
                   for _ in range(FM_PROBES)]
            for r in res:
                _stream_ok(r, FM_SPIKE_NEW, f"fleet market: a probe {what} the spike")
            return [r["ttft_ms"] for r in res]

        # -- 1. calm ------------------------------------------------------
        ttft_before = probes("before")
        for _ in range(FM_CALM_TICKS):
            tick("calm")
            time.sleep(FM_TICK_S)

        # -- 2. spike: 24 streams at once, each replaced when it ends -----
        t_part = time.perf_counter()
        stop_spike = threading.Event()
        spike, lock = [], threading.Lock()
        prompts = iter([rng.randint(3, vocab, size=int(n)) for n in rng.randint(
            FM_SPIKE_PROMPTS[0], FM_SPIKE_PROMPTS[1] + 1, size=FM_SPIKE_MAX)])

        def streamer():
            while not stop_spike.is_set():
                with lock:
                    p = next(prompts, None)
                if p is None:
                    return
                spike.append((p, _stream(rbase, p, FM_SPIKE_NEW)))

        retries0 = telemetry.get_registry().counter("edl_route_retries_total").value(
            reason="draining")
        t_spike = time.perf_counter()
        workers = [threading.Thread(target=streamer) for _ in range(FM_SPIKE_STREAMS)]
        for w in workers:
            w.start()
        window = {}

        def freeze_read():
            """Launches and the two batchers' prefill counts, with both
            workers parked at a token boundary (no prefill half done)."""
            gens = [reps[r].gen_batcher for r in ("api-a", "api-b")]
            with gens[0].frozen(), gens[1].frozen():
                return _all_launches(), [g.stats["prefills"] for g in gens]

        deadline = time.monotonic() + FM_WAIT_S
        while True:
            if time.monotonic() > deadline:
                fail(f"fleet market: the spike never got api to 2 replicas serving from B "
                     f"(timeline {[(x['phase'], x['holdings']) for x in timeline]}, B {b_state})")
            if "error" in b_state:
                fail(f"fleet market: replica B failed to start: {b_state['error']}")
            row = tick("spike")
            if row["holdings"].get("api") != 2:
                row["phase"] = "spike-wait"  # the lane has not seen the queue yet
            if "api-b" in reps and reps["api-b"].engine.warmed and "launches" not in window:
                _wait_route(rbase, "api-b")
                window["launches"], window["prefills"] = freeze_read()
                # B may have taken (and prefilled) its first streams before
                # the window opened: count only what it admits after it
                window["admitted"] = len(admitted)
            on_b = sum(1 for a in admitted[window.get("admitted", len(admitted)):]
                       if a[0] == "api-b")
            if on_b >= 2 and sum(1 for x in timeline if x["phase"] == "spike") >= 3:
                break
            time.sleep(FM_TICK_S)
        stop_spike.set()
        for w in workers:
            w.join(timeout=FM_WAIT_S)
        launches, prefills = freeze_read()
        t_traffic_end = time.perf_counter()
        # lo's survivor and each member's last world-2 step
        survivor = list(lo_coord.plan().members)
        if len(survivor) != 1:
            fail(f"fleet market: lo's plan in the spike has members {survivor}")
        survivor = survivor[0]
        wait_for(lambda: any(s > max(steps_at(survivor, 2)) for s in steps_at(survivor, 1)),
                 "lo's survivor stepping at 1")
        stop = {p: max(steps_at(p, 2)) for p in pods["lo"]}
        # served tokens on both replicas against the full recompute
        where = {}
        for rid, n, head, tail in admitted:
            where.setdefault((n, head, tail), rid)
        served = {"api-a": [], "api-b": []}
        for p, r in spike:
            _stream_ok(r, FM_SPIKE_NEW, "fleet market: a spike stream")
            rid = where.get((len(p), tuple(p[:4]), tuple(p[-4:])))
            if rid in served:
                served[rid].append((p, r))
        if not served["api-b"] or not served["api-a"]:
            fail(f"fleet market: spike streams served by A {len(served['api-a'])}, "
                 f"B {len(served['api-b'])}")
        # up to FM_RECOMPUTE streams of each replica, spread over the
        # order in which that replica admitted them
        order = {tuple(a[1:]): i for i, a in reversed(list(enumerate(admitted)))}
        rc = {}
        for rid in served:
            by_time = sorted(served[rid], key=lambda pr: order[
                (len(pr[0]), tuple(pr[0][:4]), tuple(pr[0][-4:]))])
            at = np.unique(np.linspace(0, len(by_time) - 1, FM_RECOMPUTE).round().astype(int))
            picks = [by_time[i] for i in at]
            rc[rid] = _recompute_check(reps[rid].engine, [p for p, _ in picks],
                                       [r["tokens"] for _, r in picks])
            rc[rid]["streams"] = len(picks)
        out["parts_s"]["spike"] = time.perf_counter() - t_part

        # -- 3. clear: the lane sheds B once idle, migrating a live
        # generation to A; lo grows back ----------------------------------
        t_part = time.perf_counter()
        long_res, long_started = {}, threading.Event()
        long_thread = None
        deadline = time.monotonic() + FM_WAIT_S
        while True:
            if time.monotonic() > deadline:
                fail(f"fleet market: api never shed B "
                     f"({[(x['phase'], x['holdings']) for x in timeline[-6:]]})")
            row = tick("clear")
            reason = row["decisions"]["api"]["observed"].get("slo_reason", "")
            if serve_coord.target_world() == 1:
                break
            if long_thread is None and reason.startswith("idle tick"):
                # one idle tick seen: the next sheds.  The long
                # generation goes to B now, and is running then.
                b_base = f"http://{reps['api-b'].address}"
                long_thread = threading.Thread(target=lambda: long_res.update(_stream(
                    b_base, long_prompt, FM_LONG_NEW,
                    on_token=lambda n: n == 8 and long_started.set())))
                long_thread.start()
                if not long_started.wait(FM_WAIT_S):
                    fail(f"fleet market: the long generation never started on B: {long_res}")
            time.sleep(FM_TICK_S)
        shed_row = row
        mark = len(_cp_history(hist[survivor]))
        wait_for(lambda: any(x.get("world_size") == 2
                             for x in _cp_history(hist[survivor])[mark:]),
                 "lo stepping at 2 again")
        lo_plan = lo_coord.plan()  # the world the restore formed
        tick("restored")
        if long_thread is None:
            fail("fleet market: the lane shed before the long generation started")
        long_thread.join(timeout=FM_WAIT_S)
        reps["api-b"].stop()
        out["parts_s"]["clear"] = time.perf_counter() - t_part
        ttft_after = probes("after")
        hi_stable = hi_coord.generation() == hi_gen0
        retries = telemetry.get_registry().counter("edl_route_retries_total").value(
            reason="draining") - retries0

        # the fleet command over the three coordinators, the pods still up
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            if cli.main(["fleet", "--job", f"lo=127.0.0.1:{servers['lo'].port},priority=1",
                         "--job", f"hi=127.0.0.1:{servers['hi'].port},priority=10",
                         "--serve", f"api={serve_addr},priority=100", "--chips", "4",
                         "--json"]) != 0:
                fail("fleet market: the fleet command failed")
        fleet_cmd = json.loads(text.getvalue())

        # -- stop the pods (hi dumps its launch counts first) --------------
        hi_logged = len(steps_at(hi_pod, 1))
        procs[hi_pod].send_signal(signal.SIGUSR2)
        deadline = time.monotonic() + FM_WAIT_S
        hi_stats = None
        while hi_stats is None:
            try:
                with open(hi_out) as f:
                    hi_stats = json.load(f)
            except (OSError, ValueError):  # not there, or half written
                if time.monotonic() > deadline:
                    fail("fleet market: hi's pod never wrote its launch counts")
                time.sleep(0.05)
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        for p in procs.values():
            p.wait(timeout=FM_WAIT_S)

        # -- checks ---------------------------------------------------------
        calm = [x for x in timeline if x["phase"] == "calm"]
        if any(d["dry_run"]["diff"] for x in calm for d in x["decisions"].values()):
            fail(f"fleet market: a calm tick changed something: {calm}")
        pre_events = [e.data for e in telemetry.get_recorder().events()
                      if e.kind == "fleet.preempt"]
        if not pre_events or any(p["victim"] != "lo" or p["beneficiary"] != "api"
                                 for p in pre_events):
            fail(f"fleet market: preemptions {pre_events}")
        spiked = [x["holdings"] for x in timeline if x["phase"] == "spike"]
        waiting = [x["holdings"] for x in timeline if x["phase"] == "spike-wait"]
        full = {"api": 1, "hi": 1, "lo": 2}
        if not spiked or any(h != {"api": 2, "hi": 1, "lo": 1} for h in spiked) or any(
                h != full for h in waiting):
            fail(f"fleet market: holdings in the spike {spiked}, before the grant {waiting}")
        if timeline[-1]["holdings"] != full:
            fail(f"fleet market: holdings at the end {timeline[-1]['holdings']}, want {full}")
        # the controller's own tick keeps the market's retargets (C-5):
        # lo's target and trainer workload read 1 after every spike tick,
        # and 2 once restored
        lo_ticks = [(x["phase"], x["lo_after_tick"]) for x in timeline]
        if any(v != (1, 1) for ph, v in lo_ticks if ph == "spike") or (
                lo_ticks[-1][1] != (2, 2)):
            fail(f"fleet market: lo's (target, parallelism) after each tick {lo_ticks}")
        grant = next(x for x in timeline if x["phase"] == "spike")
        lo_d, api_d = grant["decisions"]["lo"], grant["decisions"]["api"]
        if not (lo_d["preempted"] and lo_d["preempted_by"] == "api" and lo_d["drained"] is True
                and lo_d["actuated"] and api_d["dry_run"]["proposed"] == 2):
            fail(f"fleet market: the grant tick's entries: lo {lo_d}, api {api_d}")
        up = [m for n, m in stamps.get("api_target", []) if n == 2]
        if not up or not (up[0]["world_acked"] and up[0]["world_size"] == 1):
            fail(f"fleet market: when api's retarget to 2 landed, lo's coordinator showed "
                 f"{up[:1]} (want its world of 1 acked)")
        sizes = [x["resize"] for x in _cp_history(hist[survivor]) if "resize" in x]
        # the survivor's resize from its world of 2 to 1
        down = [r for prev, r in zip(sizes, sizes[1:])
                if prev["world_size"] == 2 and r["world_size"] == 1]
        skew = max(stop.values()) - min(stop.values())
        if skew != 0 or not down or down[0]["stop_step"] != stop[survivor] + 1:
            fail(f"fleet market: lo's members left world 2 after steps {stop} (skew {skew}); "
                 f"the survivor's resize {down[:1]}")
        restore = shed_row["decisions"]
        ids = [lo_d["trace_id"], api_d["trace_id"], restore["api"]["trace_id"],
               restore["lo"]["trace_id"]]
        if not all(ids) or len(set(ids)) != 4 or restore["lo"]["dry_run"]["proposed"] != 2 or (
                restore["api"]["dry_run"]["proposed"] != 1):
            fail(f"fleet market: transitions' trace ids {ids}; the shed tick {restore}")
        if lo_plan.trace_id != ids[3] or lo_plan.world_size != 2:
            fail(f"fleet market: lo's restored plan {lo_plan}, want world 2 under {ids[3]}")
        # hi: never touched; its steps bit-identical to launcher.run
        hi_hist = _cp_history(hist[hi_pod])
        hi_steps = [x for x in hi_hist if "step" in x]
        hi_resizes = [x["resize"] for x in hi_hist if "resize" in x]
        if not hi_stable or len(hi_resizes) != 1 or {x["world_size"] for x in hi_steps} != {1}:
            fail(f"fleet market: hi was touched: generation stable {hi_stable}, resizes "
                 f"{hi_resizes}")
        if [x["step"] for x in hi_steps] != list(range(len(hi_steps))):
            fail("fleet market: hi's steps are not 0..n-1 once each")
        k = hi_stats["launches"]["flash_fwd"] // max(1, hi_want["flash_fwd"])
        if hi_stats["launches"] != {n: v * k for n, v in hi_want.items()} or k < hi_logged:
            fail(f"fleet market: hi's pod launched {hi_stats['launches']} over "
                 f"{len(hi_steps)} logged steps (want {hi_want} a step)")
        d_launch = {n: launches[n] - window["launches"][n] for n in launches}
        d_prefill = [a - b for a, b in zip(prefills, window["prefills"])]
        if d_launch["flash_fwd"] != layers * sum(d_prefill) or min(d_prefill) < 1 or any(
                v for n, v in d_launch.items() if n != "flash_fwd"):
            fail(f"fleet market: with both replicas up, {d_prefill} prefills (A, B) and "
                 f"launches {d_launch} (want {layers} flash_fwd a prefill)")
        t_first_b = min(t for p, r in served["api-b"] for t, ev in r["lines"] if "token" in ev)
        # the shed: router steered first, the drain migrated the live
        # generation to A, which is bit-identical to the unmigrated run
        _stream_ok(long_res, FM_LONG_NEW, "fleet market: the migrated generation")
        if long_res["tokens"] != long_ref:
            fail("fleet market: the migrated generation differs from the unmigrated run")
        shed = [d for d in drains if d["address"] == reps["api-b"].address]
        mig = (shed[0]["ack"].get("migrate") or {}) if shed else {}
        if not shed or not shed[0]["ack"]["drained"] or mig.get("migrated") != 1 or (
                shed[0].get("migrate_to") != reps["api-a"].address):
            fail(f"fleet market: the shed's drain {shed}")
        evs = telemetry.get_recorder().events()
        steers = [e.seq for e in evs
                  if e.kind == "route.steer" and e.data.get("replica") == "api-b"]
        starts = [e.seq for e in evs if e.kind == "serve.drain"
                  and e.data.get("replica") == "api-b" and e.data.get("phase") == "start"]
        if not (steers and starts and steers[0] < starts[0]) or retries:
            fail(f"fleet market: the router steered at {steers}, B's drain started at {starts}, "
                 f"{retries} 503s absorbed")
        statuses = {r["status"] for _, r in spike} | {long_res["status"]}
        if statuses != {200}:
            fail(f"fleet market: request statuses {statuses}")
        # the reference for hi: launcher.run of the same configuration
        torch.cuda.empty_cache()
        ref = launcher.run("transformer_lm", steps=FM_HI_REF_STEPS, seed=SEED,
                           global_batch_size=TRAIN_BATCH, checkpoint_interval=FM_CKPT_INTERVAL,
                           lr=TRAIN_LR, device=FM_DEVICE, model_kwargs=CP_MODEL_KWARGS)
        ref_losses = [r.loss for r in ref.history]
        del ref
        if [x["loss"] for x in hi_steps[:FM_HI_REF_STEPS]] != ref_losses:
            fail(f"fleet market: hi's first {FM_HI_REF_STEPS} losses "
                 f"{[x['loss'] for x in hi_steps[:FM_HI_REF_STEPS]]} are not bit-identical "
                 f"to launcher.run's {ref_losses}")

        # -- the record -------------------------------------------------------
        ttft_during = [r["ttft_ms"] for _, r in spike]
        out.update({
            "arbiter_run_once_ms_p50_max": [float(np.percentile(arbiter_ms, 50)),
                                            max(arbiter_ms)],
            "controller_tick_ms_p50_max": [float(np.percentile(tick_ms, 50)), max(tick_ms)],
            "spike_first_request_to_b_first_token_s": t_first_b - t_spike,
            "b_start_s": b_state.get("started_s"),
            "lo_preempt_decision_to_world_ack_s":
                stamps["lo_ack"][0][1] - stamps["lo_decision"][0],
            "api_shed": {"drain_s": shed[0]["s"], "migrated_sequences": mig.get("migrated"),
                         "migrated_bytes": mig.get("bytes"),
                         "migrated_blocks": (mig.get("bytes") or 0) // block_bytes},
            "ttft_ms_p50_p95": {"before": _quantiles(ttft_before),
                                "during": _quantiles(ttft_during),
                                "after": _quantiles(ttft_after)},
            "spike_streams": len(spike), "served_by": {k: len(v) for k, v in served.items()},
            "prefills_with_both_up": d_prefill, "launches_with_both_up": d_launch,
            "chips_over_time": [(round(x["t_s"], 3), x["phase"], x["holdings"], x["free"],
                                 {"lo_target_parallelism": x["lo_after_tick"]})
                                for x in timeline],
            "preemptions": pre_events, "trace_ids": ids, "stop_steps": stop,
            "traffic_end_to_shed_s": b_state.get("shed_at", t_traffic_end) - t_traffic_end,
            "hi": {"steps": len(hi_steps), "generation": hi_gen0,
                   "launches": hi_stats["launches"], "peak_gb": hi_stats["peak_bytes"] / 1e9,
                   "reference_steps": FM_HI_REF_STEPS},
            "recompute": rc, "fleet_command": fleet_cmd,
            "peak_allocated_gb_smoke_process": torch.cuda.max_memory_allocated() / 1e9,
        })
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        serving_lane.post_drain = real_post_drain
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        if router is not None:
            router.stop()
        for r in reps.values():
            if not r._dead:
                r.stop()
        for s in servers.values():
            s.stop()
        if old_template is None:
            os.environ.pop("EDL_COORD_ADDR_TEMPLATE", None)
        else:
            os.environ["EDL_COORD_ADDR_TEMPLATE"] = old_template
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log({"fleet_market": out})
    return out


# -- phase 12 -------------------------------------------------------------


def _zoo_want(name) -> dict:
    """Launches a training step of ``name`` makes: transformer_base's 6
    encoder self, 6 decoder self and 6 cross attentions run B1 and B2,
    its loss B4-B6; moe_lm's 12 self-attentions B1 and B2, its loss
    B4-B6; the other families run no hand-written kernel
    (convolutions, GroupNorm, pooling and dense layers are cuDNN and
    cuBLAS, as they are XLA in the JAX package)."""
    want = dict.fromkeys(("flash_fwd", "flash_bwd", "flash_bwd_streamk",
                          "xent_fwd", "xent_dy", "xent_de"), 0)
    if name == "transformer_base":
        want.update(flash_fwd=18, flash_bwd=18, xent_fwd=1, xent_dy=1, xent_de=1)
    elif name == "moe_lm":  # the routing and the experts are torch products
        want.update(flash_fwd=12, flash_bwd=12, xent_fwd=1, xent_dy=1, xent_de=1)
    return want


def _zoo_data(model, name):
    from edl_tpu_torch.runtime import ShardedDataIterator, synthetic_dataset

    batch = ZOO_BATCH[name]
    return ShardedDataIterator(synthetic_dataset(model.synth_batch, 4 * batch, seed=SEED), batch,
                               seed=SEED)


def _zoo_training(name, model, it, card) -> dict:
    """Step 0 twice from one state, bit for bit; one warm-up and
    ZOO_STEPS timed steps with their launches; the batch-0 loss falls;
    for transformer_base the kernel path against the plain path at
    ZOO_PARITY_BATCH."""
    import torch

    from edl_tpu_torch.runtime import Trainer

    want = _zoo_want(name)
    batch_size = ZOO_BATCH[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
    state = trainer.init_state()
    batch0 = it.device_batch(0, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    loss_a, _ = trainer.loss_and_grads(state, batch0)
    grads_a = _grads(state.params)
    loss_b, _ = trainer.loss_and_grads(state, batch0)
    differ = [n for n, p in state.params.named_parameters() if not torch.equal(grads_a[n], p.grad)]
    if not torch.equal(loss_a, loss_b) or differ:
        fail(f"{name}: two runs of training step 0 from one state differ: loss "
             f"{loss_a.item()} / {loss_b.item()}, gradients of {differ[:6]}")
    del grads_a
    steps = []
    for step in range(ZOO_STEPS + 1):  # one warm-up step, then the timed ones
        batch = it.device_batch(step, "cuda")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _all_launches()
        if launches != want:
            fail(f"{name} training step {step} launched {launches}, want {want} per step")
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            fail(f"{name} training step {step}: loss {loss} is not finite")
        steps.append({"step": step, "loss": loss, "ms": wall_ms})
    peak = torch.cuda.max_memory_allocated()
    loss0, eval0 = loss_a.item(), trainer.eval_loss(state, batch0).item()
    if not eval0 < loss0:
        fail(f"{name}: the batch-0 loss did not fall over {ZOO_STEPS + 1} steps: "
             f"{loss0} -> {eval0}; step losses {[x['loss'] for x in steps]}")
    step_ms = float(np.median([x["ms"] for x in steps[1:]]))
    out = {
        "card": card, "batch": batch_size, "lr": TRAIN_LR, "setup_s": setup_s, "steps": steps,
        "step_ms_median": step_ms, "examples_per_s": batch_size / (step_ms * 1e-3),
        "flops_per_example": model.flops_per_example,
        "mfu": batch_size * model.flops_per_example / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
        "peak_allocated_bytes": peak, "launches_per_step": want,
        "bit_identical_step0": True, "batch0_loss": [loss0, eval0],
    }
    if model.tokens_per_example:
        out["tokens_per_s"] = batch_size * model.tokens_per_example / (step_ms * 1e-3)
    del state, batch0
    torch.cuda.empty_cache()
    if name == "transformer_base":
        out["parity"] = _zoo_transformer_parity(
            trainer, it.device_batch(0, "cuda", world=batch_size // ZOO_PARITY_BATCH, rank=0), want)
    return out


def _zoo_transformer_parity(trainer, batch, want) -> dict:
    """transformer_base's step-0 loss and gradients on ``batch`` (16 x
    256 tokens, phase 5's 4096): the kernel path, phase 5's plain path
    (plain attention through torch autograd, ``tied_vocab_xent``) and
    that plain path with the model in float32.

    The loss is held at phase 5's 1e-3 relative.  The gradients are not
    held at phase 5's 2e-2 of scale: the two bf16 paths part by 2.9e-2
    at ``decoder.0.cross_attn.query.weight`` here and by 3.7e-2 on 512
    tokens on the H100 (PERF.md section 6), both as far from float32, while
    phase 3 holds the kernels at these shapes within 2.3e-3.  Each
    kernel-path gradient must instead lie no farther from the float32
    one than twice the plain path's distance plus 1e-2 of scale: the
    reading, the largest ratio of the two sides, is at most 1.  The
    kernel path with a planted fault must read above 1: the source key
    mask dropped, or dV scaled by ZOO_DV_FAULT."""
    import contextlib
    from unittest import mock

    import torch

    import edl_tpu_torch.models.transformer as tm
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.ops import fused_attention, tied_vocab_xent
    from edl_tpu_torch.ops.flash_attention import flash_attention_plain
    from edl_tpu_torch.runtime import Trainer

    class ScaleGrad(torch.autograd.Function):
        """x forward, its gradient times ZOO_DV_FAULT backward."""

        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * ZOO_DV_FAULT

    def plain_attention(q, k, v, causal=False, scale=None, kv_mask=None):
        return flash_attention_plain(q, k, v, causal, scale, kv_mask)[0]

    def no_source_mask(q, k, v, causal=False, scale=None, kv_mask=None):
        return fused_attention(q, k, v, causal=causal, kv_mask=kv_mask if causal else None)

    def scaled_dv(q, k, v, causal=False, scale=None, kv_mask=None):
        return fused_attention(q, k, ScaleGrad.apply(v), causal=causal,
                               kv_mask=kv_mask)

    def run(tr, **patches):
        state = tr.init_state()
        with mock.patch.multiple(tm, **patches) if patches else contextlib.nullcontext():
            loss, _ = tr.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        grads = _grads(state.params)
        del state
        return loss.item(), grads

    _reset_launches()
    loss_k, grads_k = run(trainer)
    launches = _all_launches()
    if launches != want:
        fail(f"transformer_base parity: the kernel path launched {launches}, want {want}")
    _reset_launches()
    loss_p, grads_p = run(trainer, fused_attention=plain_attention,
                          best_vocab_xent=tied_vocab_xent)
    f32 = Trainer(get_model("transformer_base", dtype=torch.float32), lr=TRAIN_LR,
                  device="cuda", seed=SEED)
    _, grads_f = run(f32, fused_attention=plain_attention, best_vocab_xent=tied_vocab_xent)
    if any(_all_launches().values()):
        fail(f"the plain transformer_base paths launched kernels: {_all_launches()}")
    plain_from_f32 = {n: _rel_err(grads_p[n], grads_f[n]) for n in grads_f}

    def reading(loss, grads):
        """(loss error, worst leaf, its reading, its distance from float32)."""
        ratio = {n: _rel_err(grads[n], grads_f[n]) / (2 * plain_from_f32[n] + 1e-2)
                 for n in grads_f}
        worst = max(ratio, key=ratio.get)
        return (abs(loss - loss_p) / abs(loss_p), worst, ratio[worst],
                _rel_err(grads[worst], grads_f[worst]))

    loss_err, worst, ratio, dist = reading(loss_k, grads_k)
    vs_plain = {n: _rel_err(grads_k[n], grads_p[n]) for n in grads_p}
    worst_p = max(vs_plain, key=vs_plain.get)
    if loss_err > TRAIN_LOSS_TOL or ratio > 1:
        fail(f"transformer_base {list(batch['src'].shape)} step 0: loss error {loss_err} "
             f"(tolerance {TRAIN_LOSS_TOL}); gradient {worst} {dist} from float32, "
             f"{ratio} of twice the plain path's distance + 1e-2 (limit 1)")
    faults = {}
    for fault, attention in (("source key mask dropped", no_source_mask),
                             (f"dV x {ZOO_DV_FAULT}", scaled_dv)):
        f_loss, f_worst, f_ratio, f_dist = reading(*run(trainer, fused_attention=attention))
        faults[fault] = {"loss_rel_err": f_loss, "worst_grad": f_worst, "reading": f_ratio,
                         "from_float32": f_dist}
        if f_loss <= TRAIN_LOSS_TOL and f_ratio <= 1:
            fail(f"transformer_base parity: the planted fault ({fault}) passes the rule: "
                 f"{faults[fault]}; the sound kernel path read {ratio}")
    return {
        "tokens_shape": list(batch["src"].shape), "launches_kernel_path": launches,
        "loss": {"kernels": loss_k, "plain": loss_p}, "loss_rel_err": loss_err,
        "loss_tolerance": TRAIN_LOSS_TOL,
        "vs_plain": {"worst_grad": worst_p, "err_of_scale": vs_plain[worst_p],
                     "median": float(np.median(list(vs_plain.values())))},
        "rule": "|kernels - float32| <= 2 |plain - float32| + 1e-2, of scale, per gradient",
        "reading": ratio, "worst_grad": worst, "from_float32": dist,
        "plain_from_float32_max": max(plain_from_f32.values()), "planted_faults": faults,
    }


def _zoo_elastic(name, model, it) -> dict:
    """Run A, ZOO_ELASTIC_STEPS steps at checkpoint interval
    ZOO_ELASTIC_INTERVAL; run B, a graceful generation bump at step
    ZOO_BUMP_AT and the device state lost once step ZOO_KILL_AT has run:
    B's loss stream must be A's bit for bit."""
    import gc

    import torch

    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.runtime import ElasticTrainer, LocalCoordinator

    want = _zoo_want(name)

    def elastic():
        coord = LocalCoordinator(target_world=1, max_world=2)
        coord.register("tr0")
        et = ElasticTrainer(model, it, coord, store=HostDRAMStore(), lr=TRAIN_LR,
                            device="cuda", checkpoint_interval=ZOO_ELASTIC_INTERVAL, seed=SEED)
        et.pipeline_depth = 2
        return et, coord

    out = {"checkpoint_interval": ZOO_ELASTIC_INTERVAL}
    _reset_launches()
    t0 = time.perf_counter()
    a, _ = elastic()
    a.run(ZOO_ELASTIC_STEPS)
    a.store.wait()
    out["a_seconds"] = time.perf_counter() - t0
    out["a_steps"] = _check_run_launches(a, want, f"{name} A")
    ref = {r.step: r.loss for r in a.history}
    losses = [ref[s] for s in range(ZOO_ELASTIC_STEPS)]
    if not all(np.isfinite(losses)):
        fail(f"{name} elastic run A: losses {losses} are not finite")
    out["losses"] = losses
    del a
    gc.collect()
    torch.cuda.empty_cache()

    _reset_launches()
    t0 = time.perf_counter()
    b, coord = elastic()
    b.run(ZOO_BUMP_AT)
    b.store.wait()
    coord.register("tr1")
    coord.deregister("tr0")
    b.run(ZOO_KILL_AT + 1)
    b.store.wait()
    b.inject_failure()
    b.run(ZOO_ELASTIC_STEPS)
    b.store.wait()
    out["b_seconds"] = time.perf_counter() - t0
    out["b_steps"] = _check_run_launches(b, want, f"{name} B")
    _check_stream(b, ref, f"{name} B (bump + kill)")
    got = [(e.graceful, e.restored_step, e.replayed_steps, e.compiles) for e in b.resize_events]
    expect = [(False, 0, 0, 0), (True, ZOO_BUMP_AT, 0, 0), (False, ZOO_KILL_AT, 1, 0)]
    if got != expect:
        fail(f"{name} elastic run B resize events (graceful, restored, replayed, compiles) "
             f"{got}, want {expect}")
    out["resizes"] = [{"graceful": e.graceful, "restored_step": e.restored_step,
                       "replayed_steps": e.replayed_steps, "seconds": e.seconds}
                      for e in b.resize_events]
    out["checkpoint_bytes"] = b.store.latest().nbytes()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _zoo_serving(name, card) -> dict:
    """The family behind InferenceEngine, ContinuousBatcher and
    ServingServer on loopback (seeded weights), ZOO_REQUESTS concurrent
    POST /predict of one example each; the replies against predict_fn
    run directly on all of them at once."""
    import torch

    from edl_tpu_torch.serving.server import build_replica

    torch.cuda.reset_peak_memory_stats()
    engine, batcher, _, server = build_replica(name, device="cuda", seed=SEED,
                                               max_batch=ZOO_REQUESTS)
    model = engine.model
    rows = model.synth_batch(np.random.RandomState(SEED + 7), ZOO_REQUESTS)
    inputs = {k: rows[k] for k in model.predict_inputs}
    base = f"http://127.0.0.1:{server.port}"
    replies, seconds, errors = [None] * ZOO_REQUESTS, [0.0] * ZOO_REQUESTS, []

    def ask(i):
        body = {"inputs": {k: v[i].tolist() for k, v in inputs.items()}, "deadline_ms": 600000}
        t0 = time.perf_counter()
        try:
            with _post(f"{base}/predict", body) as r:
                replies[i] = json.loads(r.read())
        except Exception as e:  # reported below, after every request returned
            errors.append(f"request {i}: {e!r}")
        seconds[i] = time.perf_counter() - t0

    try:
        ask(0)  # warm-up: the serving path's libraries and plans
        replies[0] = None
        torch.cuda.synchronize()
        _reset_launches()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(ZOO_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = _all_launches()
    finally:
        server.stop()
        batcher.stop()
    if errors or any(r is None for r in replies):
        fail(f"{name} /predict: {errors or 'a request did not return'}")
    per_forward = _zoo_want(name)["flash_fwd"]
    fwd = launches["flash_fwd"]
    if any(v for k, v in launches.items() if k != "flash_fwd") or (
            (fwd == 0 or fwd % per_forward) if per_forward else fwd):
        fail(f"{name} /predict launched {launches}, want {per_forward} flash_fwd a forward "
             "and nothing else")
    params = engine.current_weights().params
    with torch.no_grad():
        direct = model.predict_fn(
            params, {k: torch.from_numpy(v).to("cuda") for k, v in inputs.items()})
        direct = {k: v.cpu().numpy() for k, v in direct.items()}
        if name == "transformer_base":
            from edl_tpu_torch.models.transformer import tied_logits

            src, tgt = (torch.from_numpy(inputs[k]).to("cuda") for k in ("src", "tgt"))
            logits = tied_logits(params.features(src, tgt), params.embed.weight,
                                 torch.bfloat16).cpu().numpy()
        elif "logits" in direct:
            logits = direct["logits"]
    got = {k: np.concatenate([np.asarray(r["outputs"][k]) for r in replies]) for k in direct}
    out = {"card": card, "requests": ZOO_REQUESTS, "launches": launches,
           "forwards": fwd // per_forward if per_forward else None,
           "latency_ms_p50_p95": [1e3 * x for x in _quantiles(seconds)],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    if name == "fit_a_line":
        err = float(np.abs(got["pred"] - direct["pred"]).max())
        if err > BF16_TOL * float(np.abs(direct["pred"]).max()):
            fail(f"{name} /predict pred differs from predict_fn by {err}")
        out["pred_max_abs_err"] = err
        return out
    key = "tokens" if name == "transformer_base" else "label"
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > MARGIN_FRAC * np.abs(logits).max(axis=-1)
    wrong = int((got[key][sure] != direct[key][sure]).sum())
    if wrong:
        fail(f"{name} /predict: {wrong} of {int(sure.sum())} {key} past the margin differ "
             "from predict_fn")
    out.update({f"{key}_checked": int(sure.sum()), f"{key}_total": int(sure.size),
                f"{key}_agreement": float((got[key] == direct[key]).mean())})
    if "logits" in direct:
        out["logits_err_of_scale"] = _rel_err(torch.from_numpy(got["logits"]),
                                              torch.from_numpy(direct["logits"]))
    return out


def phase_model_zoo(card: str) -> dict:
    """The BASELINE families (fit_a_line, mnist, resnet50,
    transformer_base) at full width: training, elastic, /predict."""
    import gc

    import torch

    from edl_tpu_torch.models import get_model

    t_phase = time.perf_counter()
    out = {}
    for name in ZOO_FAMILIES:
        t0 = time.perf_counter()
        model = get_model(name)
        it = _zoo_data(model, name)
        res = {"model": name, "card": card,
               "training": _zoo_training(name, model, it, card),
               "elastic": _zoo_elastic(name, model, it),
               "serving": _zoo_serving(name, card)}
        res["seconds"] = time.perf_counter() - t0
        log({"model_zoo": res})
        out[name] = res
        del it
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"card": card, "phase_s": time.perf_counter() - t_phase,
               "families": {n: {"step_ms": r["training"]["step_ms_median"],
                                "mfu": r["training"]["mfu"],
                                "predict_ms_p50_p95": r["serving"]["latency_ms_p50_p95"],
                                "seconds": r["seconds"]} for n, r in out.items()}}
    log({"model_zoo_summary": summary})
    return out


# -- phase 14 -------------------------------------------------------------

#: the MoE cell: global batch (``bench_moe_lm``'s), warm-up and timed
#: steps, the kernel-vs-plain batch, new tokens of the CLI replica's check
MOE_BATCH = 8
MOE_WARMUP = 2
MOE_STEPS = 8
MOE_PARITY_BATCH = 2
MOE_CLI_TIMEOUT_S = 240


def _moe_training(model, it, card, spill_dir) -> dict:
    """Step 0 twice from one state (loss, aux and every gradient bit for
    bit); MOE_WARMUP + MOE_STEPS steps with their launches; the batch-0
    loss falls; the drop rate in [0, 1); the trained state saved once to
    ``spill_dir``; the kernel path against the plain path at
    MOE_PARITY_BATCH, with the share of tokens each layer routes to
    another expert."""
    import torch

    from contextlib import ExitStack
    from unittest import mock

    import edl_tpu_torch.models.moe as moe_mod
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.ops import tied_vocab_xent
    from edl_tpu_torch.runtime import Trainer

    want = _zoo_want("moe_lm")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
    state = trainer.init_state()
    batch0 = it.device_batch(0, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    loss_a, aux_a = trainer.loss_and_grads(state, batch0)
    grads_a = _grads(state.params)
    aux_a = aux_a["moe_aux_loss"].detach().clone()
    loss_b, aux_b = trainer.loss_and_grads(state, batch0)
    differ = [n for n, p in state.params.named_parameters() if not torch.equal(grads_a[n], p.grad)]
    if not (torch.equal(loss_a, loss_b) and torch.equal(aux_a, aux_b["moe_aux_loss"])) or differ:
        fail(f"moe_lm: two runs of training step 0 from one state differ: loss "
             f"{loss_a.item()} / {loss_b.item()}, aux {aux_a.item()} / "
             f"{aux_b['moe_aux_loss'].item()}, gradients of {differ[:6]}")
    del grads_a
    steps = []
    for step in range(MOE_WARMUP + MOE_STEPS):
        batch = it.device_batch(step, "cuda")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _all_launches()
        if launches != want:
            fail(f"moe_lm training step {step} launched {launches}, want {want} per step")
        loss, drop = metrics["loss"].item(), metrics["moe_drop_rate"].item()
        if not np.isfinite(loss):
            fail(f"moe_lm training step {step}: loss {loss} is not finite")
        if not 0.0 <= drop < 1.0:
            fail(f"moe_lm training step {step}: drop rate {drop} not in [0, 1)")
        steps.append({"step": step, "loss": loss, "ms": wall_ms,
                      "moe_aux_loss": metrics["moe_aux_loss"].item(), "moe_drop_rate": drop})
    peak = torch.cuda.max_memory_allocated()
    loss0, eval0 = loss_a.item(), trainer.eval_loss(state, batch0).item()
    if not eval0 < loss0:
        fail(f"moe_lm: the batch-0 loss did not fall over {len(steps)} steps: "
             f"{loss0} -> {eval0}; step losses {[x['loss'] for x in steps]}")
    timed = steps[MOE_WARMUP:]
    step_ms = float(np.median([x["ms"] for x in timed]))
    out = {
        "card": card, "batch": MOE_BATCH, "seq_len": model.tokens_per_example, "lr": TRAIN_LR,
        "setup_s": setup_s, "steps": steps, "step_ms_median": step_ms,
        "tokens_per_s": MOE_BATCH * model.tokens_per_example / (step_ms * 1e-3),
        "flops_per_example": model.flops_per_example,
        "mfu": MOE_BATCH * model.flops_per_example / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
        "peak_allocated_bytes": peak, "launches_per_step": want,
        "moe_drop_rate_mean": float(np.mean([x["moe_drop_rate"] for x in timed])),
        "moe_aux_loss_mean": float(np.mean([x["moe_aux_loss"] for x in timed])),
        "bit_identical_step0": True, "batch0_loss": [loss0, eval0],
    }
    store = HostDRAMStore(spill_dir=spill_dir)
    t0 = time.perf_counter()
    store.save_async(state)
    store.wait()
    out["spill"] = {"seconds": time.perf_counter() - t0, "step": state.step,
                    "bytes": store.latest().nbytes()}
    del state, batch0, store
    torch.cuda.empty_cache()

    # Kernel path vs plain path.  Routing is an argmax: the two paths'
    # rounding differs, so a near-tie token may pick another expert and
    # move its whole MLP output (and the router's gradient with it).
    # The gradients are held with the plain path on the kernel path's
    # routes (``moe.top1`` replayed layer by layer); the share of tokens
    # the plain path routes elsewhere on its own is measured apart.
    routes = []

    def record(probs):
        routes.append(torch.argmax(probs, dim=-1))
        return routes[-1]

    replay = iter(routes)
    parity_state = trainer.init_state()
    parity_batch = it.device_batch(0, "cuda", world=MOE_BATCH // MOE_PARITY_BATCH, rank=0)
    out["parity"] = _parity_plain_vs_kernels(
        trainer, parity_batch, want, state=parity_state,
        kernel_patches=((moe_mod, "top1", record),),
        plain_patches=((moe_mod, "best_vocab_xent", tied_vocab_xent),
                       (moe_mod, "top1", lambda probs: next(replay))))
    out["parity"]["routes"] = "the plain path on the kernel path's routes"
    layers = model.decode.layers
    kernel_routes, plain_routes = routes[:layers], []
    with ExitStack() as stack, torch.no_grad():
        for patch in _plain_patches() + (
                (moe_mod, "best_vocab_xent", tied_vocab_xent),
                (moe_mod, "top1", lambda probs: plain_routes.append(
                    torch.argmax(probs, dim=-1)) or plain_routes[-1])):
            stack.enter_context(mock.patch.object(*patch))
        model.loss_fn(parity_state.params, parity_batch)
    if len(routes) != layers or len(plain_routes) != layers:
        fail(f"moe_lm parity: {len(routes)} / {len(plain_routes)} routings, want {layers}")
    flips = [float((a != b).float().mean()) for a, b in zip(kernel_routes, plain_routes)]
    out["parity"]["plain_own_routes_flip_share_by_layer"] = flips
    out["parity"]["plain_own_routes_flip_share"] = float(np.mean(flips))
    del parity_state
    torch.cuda.empty_cache()
    return out


def _moe_logits(engine, prompt, toks):
    """moe_lm's full recompute: one monolithic prefill of prompt + toks
    (minus the last) on a fresh pool, routed per token as every serving
    path routes (never ``predict_fn``, which routes in capacity groups);
    the logits at each position that chose a token of ``toks``."""
    import torch

    params = engine.current_weights().params
    spec, bt, dev = engine.spec, engine.block_tokens, engine.device
    seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)]).astype(np.int32)
    n = len(seq)
    nblk = -(-n // bt)
    shape = (spec.layers, nblk + 1, bt, spec.heads, spec.head_dim)
    kp = torch.zeros(shape, dtype=spec.cache_dtype, device=dev)
    vp = torch.zeros_like(kp)
    tok = torch.zeros((1, nblk * bt), dtype=torch.int32, device=dev)
    tok[0, :n] = torch.from_numpy(seq).to(dev)
    tab = torch.arange(1, nblk + 1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        feats, _, _ = params(tok, kv=(kp, vp, tab, torch.tensor([n], dtype=torch.int32,
                                                                 device=dev), True))
        rows = feats[0, len(prompt) - 1:n].to(torch.bfloat16).float()
        return rows @ params.logit_weight(torch.bfloat16).t()


def _moe_recompute_check(engine, prompts, served):
    """Served tokens against ``_moe_logits`` under phase 4's margin rule."""
    checked = agreed = near_ties = 0
    for prompt, toks in zip(prompts, served):
        logits = _moe_logits(engine, prompt, toks)
        top = logits.topk(2, dim=-1)
        for i, tok in enumerate(toks):
            margin = (top.values[i, 0] - top.values[i, 1]).item()
            tol = MARGIN_FRAC * logits[i].abs().max().item()
            same = int(top.indices[i, 0]) == int(tok)
            agreed += same
            checked += 1
            if margin > tol:
                if not same:
                    fail(f"moe_lm: served token {tok} != full-recompute "
                         f"{int(top.indices[i, 0])} at step {i} of a {len(prompt)}-token "
                         f"prompt (margin {margin}, tol {tol})")
            else:
                near_ties += 1
    return {"steps": checked, "agreement": agreed / checked, "near_ties": near_ties}


def _moe_same_or_near_tie(engine, prompt, a, b, what):
    """Two token streams of one prompt: equal, or parting first where
    the full recompute's top two are within the margin (a near tie may
    go either way on the card, a clear winner may not)."""
    if a == b:
        return None
    i = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
    logits = _moe_logits(engine, prompt, a[:i + 1])[-1]
    top = logits.topk(2)
    margin = (top.values[0] - top.values[1]).item()
    tol = MARGIN_FRAC * logits.abs().max().item()
    if margin > tol:
        fail(f"moe_lm {what}: the streams part at token {i} ({a[i]} / {b[i]}) where the "
             f"recompute's margin {margin} exceeds {tol}")
    return {"parted_at": i, "margin": margin, "tol": tol}


def _moe_serving(card, spill_dir, saved_step) -> dict:
    """``serve_run`` over the durable spill in this process: phase 4's
    traffic through a monolithic front on its engine, each prompt alone,
    the long prompt in the replica's own (chunked) posture; then ``edl
    serve`` as a subprocess registered with a serving coordinator,
    ``route_run`` over it and ``edl route`` against that."""
    import os
    import queue
    import tempfile

    import torch

    from edl_tpu_torch.runtime import LocalCoordinator
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer
    from edl_tpu_torch.serving import ServingServer, TokenContinuousBatcher
    from edl_tpu_torch.serving.router import route_run
    from edl_tpu_torch.serving.server import serve_run

    out = {"card": card, "saved_step": saved_step}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    replica = serve_run(entrypoint="moe_lm", checkpoint_dir=spill_dir, port=_free_port(),
                        host="127.0.0.1", device="cuda", replica_id="moe-0")
    out["load_s"] = time.perf_counter() - t0
    engine = replica.engine
    coord = cserver = router = proc = None
    mono_gen = front = None
    try:
        if not (replica.loaded and engine.weights_step == saved_step):
            fail(f"moe_lm replica: loaded {replica.loaded}, weights step "
                 f"{engine.weights_step} (want the saved step {saved_step})")
        layers = engine.spec.layers
        mono_gen = TokenContinuousBatcher(engine, chunked_prefill=False, refresh=False).start()
        front = ServingServer(replica.batcher, host="127.0.0.1", port=0,
                              gen_batcher=mono_gen).start()
        base = f"http://127.0.0.1:{front.port}"
        with _post(base + "/generate", {"inputs": {"tokens": [5, 6, 7]},
                                        "max_new_tokens": 2}) as r:  # warm-up
            if r.status != 200:
                fail(f"moe_lm warm-up /generate answered {r.status}")
        rng = np.random.RandomState(SEED)
        prompts = [rng.randint(3, engine.spec.vocab_size, size=n).astype(np.int32)
                   for n in SERVE_PROMPTS]
        prefills0 = mono_gen.stats["prefills"]
        torch.cuda.synchronize()
        together = {}
        threads = [threading.Thread(target=_generate, args=(base, p, i == 3, together, i))
                   for i, p in enumerate(prompts)]
        _reset_launches()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _all_launches()
        prefills = mono_gen.stats["prefills"] - prefills0
        for i in range(len(prompts)):
            res = together.get(i)
            if res is None or res.get("status") != 200 or "error" in res:
                fail(f"moe_lm /generate request {i} failed: {res}")
            if len(res["tokens"]) != SERVE_NEW_TOKENS:
                fail(f"moe_lm /generate request {i} returned {len(res['tokens'])} tokens")
        want = dict.fromkeys(launches, 0)
        want["flash_fwd"] = layers * prefills
        if prefills < len(prompts) or launches != want:
            fail(f"moe_lm serving launched {launches} for {prefills} prefills (want "
                 f"{layers} flash_fwd a prefill and nothing else)")
        served = [together[i]["tokens"] for i in range(len(prompts))]
        ttfts = sorted(together[i]["ttft_ms"] for i in range(len(prompts)))
        out["batch_of_four"] = {
            "prompts": list(SERVE_PROMPTS), "new_tokens": SERVE_NEW_TOKENS, "wall_s": wall,
            "ttft_ms": ttfts, "ttft_p50_ms": float(np.median(ttfts)),
            "tokens_per_s": sum(len(s) for s in served) / wall, "prefills": prefills,
            "launches": launches, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "kv_pool_bytes": engine.pool.nbytes(),
        }
        # each sequence alone
        alone, parted = {}, {}
        for i, p in enumerate(prompts):
            _generate(base, p, False, alone, i)
            if alone[i].get("status") != 200 or "error" in alone[i]:
                fail(f"moe_lm /generate of prompt {i} alone failed: {alone[i]}")
            d = _moe_same_or_near_tie(engine, p, served[i], alone[i]["tokens"],
                                      f"prompt {i} alone vs in the batch of four")
            if d is not None:
                parted[i] = d
        out["alone_equals_batch"] = {"equal": len(prompts) - len(parted), "near_ties": parted}
        if engine.pool.used_blocks != 0:
            fail(f"moe_lm: {engine.pool.used_blocks} KV blocks owned after serving")
        out["recompute"] = _moe_recompute_check(engine, prompts, served)
        # the replica's own front, chunked posture: the long prompt's first token
        if not replica.gen_batcher.chunked_prefill:
            fail("moe_lm: serve_run's token batcher is not in the chunked posture")
        chunked = {}
        _reset_launches()
        _generate_plain(f"http://127.0.0.1:{replica.server.port}", prompts[-1], 1, chunked, 0)
        _replies_ok(chunked, [0], 1, "moe_lm chunked posture")
        first = {"chunked": chunked[0]["tokens"][0], "monolithic": served[-1][0],
                 "prefill_chunks": chunked[0]["prefill_chunks"],
                 "launches": _all_launches()}
        if first["chunked"] != first["monolithic"]:
            first["near_tie"] = _moe_same_or_near_tie(
                engine, prompts[-1], [first["monolithic"]], [first["chunked"]],
                "the long prompt's first token, chunked vs monolithic")
        out["long_first_token"] = first

        # edl serve in a subprocess, registered; the router over it; edl route
        coord = LocalCoordinator(target_world=1, max_world=4)
        cserver = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
        port = _free_port()
        log_path = os.path.join(tempfile.gettempdir(), f"edl-serve-{os.getpid()}.log")
        env = dict(os.environ, EDL_SERVE_PORT=str(port), EDL_POD_NAME="moe-cli",
                   EDL_POD_ADDRESS=f"127.0.0.1:{port}")
        argv = [sys.executable, "-m", "edl_tpu_torch.cli", "serve", "--entrypoint", "moe_lm",
                "--checkpoint-dir", spill_dir, "--port", "0", "--coordinator",
                f"127.0.0.1:{cserver.port}", "--duration", str(MOE_CLI_TIMEOUT_S)]
        t0 = time.perf_counter()
        with open(log_path, "w") as errf:
            proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=errf, text=True, env=env)
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()), daemon=True).start()
        try:
            line = lines.get(timeout=MOE_CLI_TIMEOUT_S - 60)
        except queue.Empty:
            line = ""
        if not line:
            with open(log_path) as f:
                fail(f"edl serve printed no line (exit {proc.poll()}): {f.read()[-2000:]}")
        info = json.loads(line)
        out["cli"] = {"argv": argv[3:], "line": info, "start_s": time.perf_counter() - t0}
        if info.get("weights_step") != saved_step or info.get("model") != "moe_lm" or \
                info.get("port") != port or info.get("replica") != "moe-cli":
            fail(f"edl serve printed {info}; want moe_lm, replica moe-cli, port {port}, "
                 f"weights step {saved_step}")
        cli_reply = {}
        _generate_plain(f"http://127.0.0.1:{port}", prompts[0], SERVE_NEW_TOKENS, cli_reply, 0)
        _replies_ok(cli_reply, [0], SERVE_NEW_TOKENS, "edl serve's /generate")
        d = _moe_same_or_near_tie(engine, prompts[0], alone[0]["tokens"],
                                  cli_reply[0]["tokens"], "edl serve vs the in-process replica")
        out["cli"]["tokens_equal"] = d is None
        out["cli"]["near_tie"] = d
        router = route_run(f"127.0.0.1:{cserver.port}", port=0, host="127.0.0.1")
        rbase = f"http://127.0.0.1:{router.port}"
        _wait_route(rbase, "moe-cli", address=f"127.0.0.1:{port}", timeout=60)
        table = subprocess.run([sys.executable, "-m", "edl_tpu_torch.cli", "route",
                                f"127.0.0.1:{router.port}"],
                               capture_output=True, text=True, timeout=120)
        raw = subprocess.run([sys.executable, "-m", "edl_tpu_torch.cli", "route",
                              f"127.0.0.1:{router.port}", "--json"],
                             capture_output=True, text=True, timeout=120)
        if table.returncode or raw.returncode:
            fail(f"edl route exit {table.returncode} / {raw.returncode}: "
                 f"{table.stderr[-800:]} {raw.stderr[-800:]}")
        row = [x for x in table.stdout.splitlines() if "moe-cli" in x]
        rows = json.loads(raw.stdout)["replicas"]
        if not (row and f"127.0.0.1:{port}" in row[0] and "healthy" in row[0]
                and [(r["replica"], r["health"]) for r in rows] == [("moe-cli", "healthy")]):
            fail(f"edl route did not list moe-cli healthy: {table.stdout!r} / {rows}")
        out["route"] = {"table": table.stdout.splitlines(), "json_replicas": rows}
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        if router is not None:
            router.stop()
        if cserver is not None:
            cserver.stop()
        if front is not None:
            front.stop()
        if mono_gen is not None:
            mono_gen.stop()
        replica.stop()
    return out


def phase_moe(card: str) -> dict:
    """Full-width moe_lm (vocab 32000, d 768, d_ff 3072, 12 heads, 12
    layers, 8 experts, routing group 256, L 2048): training, elastic,
    serving behind serve_run, edl serve and edl route."""
    import gc
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ShardedDataIterator, synthetic_dataset

    t_phase = time.perf_counter()
    model = get_model("moe_lm")
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 4 * MOE_BATCH, seed=SEED),
                             MOE_BATCH, seed=SEED)
    out = {"model": "moe_lm", "card": card}
    tmp = tempfile.mkdtemp(prefix="edl-moe-")
    try:
        training = _moe_training(model, it, card, tmp)
        out["training"] = training
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["elastic"] = _zoo_elastic("moe_lm", model, it)
        out["elastic"]["seconds"] = time.perf_counter() - t0
        out["serving"] = _moe_serving(card, tmp, training["spill"]["step"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log({"moe": out})
    s = out["serving"]
    log({"moe_summary": {
        "card": card, "phase_s": out["phase_s"],
        "step_ms": training["step_ms_median"], "tokens_per_s": training["tokens_per_s"],
        "mfu": training["mfu"], "train_peak_allocated_bytes": training["peak_allocated_bytes"],
        "moe_drop_rate": training["moe_drop_rate_mean"],
        "moe_aux_loss": training["moe_aux_loss_mean"],
        "parity_flip_share": training["parity"]["plain_own_routes_flip_share"],
        "spill_s": training["spill"]["seconds"], "spill_bytes": training["spill"]["bytes"],
        "load_s": s["load_s"], "ttft_p50_ms": s["batch_of_four"]["ttft_p50_ms"],
        "serve_tokens_per_s": s["batch_of_four"]["tokens_per_s"],
        "serve_peak_allocated_bytes": s["batch_of_four"]["peak_allocated_bytes"],
        "cli_start_s": s["cli"]["start_s"], "elastic_s": out["elastic"]["seconds"]}})
    return out


# -- main -----------------------------------------------------------------


# -- phase 13 -------------------------------------------------------------

#: the observability run: steps, the retarget's step, the profile
#: windows' first step and length
OBS_STEPS = 10
#: steps timed after the run with no window open (drained to drained,
#: as a window's steps are)
OBS_PLAIN_STEPS = 3
OBS_RETARGET_AT = 5
OBS_WINDOW_AT = 1
OBS_WINDOW_STEPS = 3
#: each wrapper's kernel on the device lane, by its ``__global__``
#: symbol: one launch of the wrapper launches it once (B2 also
#: launches its delta and dQ kernels)
OBS_SYMBOLS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd": "flash_bwd_dkdv_kernel",
               "xent_fwd": "xent_fwd_kernel", "xent_dy": "xent_dy_kernel",
               "xent_de": "xent_de_kernel"}


def _one_rank_worlds(trainer_id, device):
    """The launcher's world builder for a process that answers for every
    member of its plan: each generation's world is formed (torn down,
    initialized, a gloo group beside it) as one rank, the most one card
    holds."""
    import dataclasses

    from edl_tpu_torch import launcher

    inner = launcher.make_world_builder(trainer_id, device)

    def build(plan):
        if trainer_id not in plan.members:
            return inner(plan)
        i = plan.members.index(trainer_id)
        return inner(dataclasses.replace(plan, members=(trainer_id,),
                                         addresses=(plan.addresses[i],), world_size=1))

    build.teardown = inner.teardown
    build.leak_dead_world = inner.leak_dead_world
    return build


def _window_trace(path):
    """A profiler window's Chrome trace: its ``train#<step>`` steps, its
    device kernels counted by wrapper symbol, and the same per step
    where the device lane carries the steps' ranges
    (``gpu_user_annotation``), else None.  A step's range on the device
    spans the kernels its host range launched, the forward; its
    backward runs on autograd's thread, so a step owns every kernel
    from its range's start to the next step's."""
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    steps = sorted({int(e["name"][len("train#"):]) for e in events
                    if str(e.get("name", "")).startswith("train#")})
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def count(ks):
        return {w: sum(1 for k in ks if sym in k["name"]) for w, sym in OBS_SYMBOLS.items()}

    ranges = [e for e in events if e.get("cat") == "gpu_user_annotation"
              and str(e.get("name", "")).startswith("train#")]
    per_step = None
    if ranges:
        ranges.sort(key=lambda r: r["ts"])
        ends = [r["ts"] for r in ranges[1:]] + [float("inf")]
        per_step = {r["name"]: count([k for k in kernels if r["ts"] <= k["ts"] < end])
                    for r, end in zip(ranges, ends)}
    return steps, count(kernels), len(kernels), per_step


def _cli(*argv):
    """``python -m edl_tpu_torch.cli <argv>`` in this process: its exit
    code and what it printed."""
    import contextlib
    import io

    from edl_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def phase_observability(card: str, ref_losses=None) -> dict:
    """Full-width transformer_lm through ElasticTrainer behind the HTTP
    coordinator, with the flight recorder's spill, two profile windows
    and a traced retarget; the journal, the windows and the CLI's
    ``trace`` and ``metrics`` read back."""
    import os
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch import telemetry
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.checkpoint.hostdram import PINNED
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        ElasticTrainer,
        LocalCoordinator,
        ShardedDataIterator,
        synthetic_dataset,
    )
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer, HTTPCoordinator
    from edl_tpu_torch.telemetry import KNOWN_EVENT_KINDS
    from edl_tpu_torch.telemetry.trace import load_journal, member_streams, new_trace_id

    t_phase = time.perf_counter()
    model = get_model("transformer_lm")  # full width: bf16 compute, f32 params
    layers = model.decode.layers
    want = {"flash_fwd": layers, "flash_bwd": layers, "flash_bwd_streamk": 0,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH, seed=SEED)
    tmp = tempfile.mkdtemp(prefix="edl-observability-")
    spill = os.path.join(tmp, "tr0.jsonl")
    env = {"EDL_PROFILE_DIR": os.path.join(tmp, "profile"),
           "EDL_PROFILE_STEPS": str(OBS_WINDOW_STEPS),
           "EDL_PROFILE_AT_STEP": str(OBS_WINDOW_AT), "EDL_PROFILE_EACH_RESIZE": "1"}
    saved_env = {k: os.environ.get(k) for k in env}
    out = {"card": card, "model": "transformer_lm", "batch": TRAIN_BATCH, "steps": OBS_STEPS}
    trace_id = new_trace_id()
    server = et = None
    try:
        os.environ.update(env)
        with telemetry.scoped() as (_, rec):
            rec.spill_to(spill)
            coord = LocalCoordinator(target_world=1, max_world=2)
            server = CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
            addr = f"127.0.0.1:{server.port}"
            client = HTTPCoordinator(addr)
            et = ElasticTrainer(model, it, client, store=HostDRAMStore(), lr=TRAIN_LR,
                                device="cuda", checkpoint_interval=4, seed=SEED,
                                world_builder=_one_rank_worlds("tr0", "cuda"))
            et.heartbeat_ids = ["tr0", "tr1"]
            et.register_address = f"127.0.0.1:{_free_port()}"
            et.telemetry_interval = 0.5
            client.register("tr0", address=et.register_address)
            client.register("tr1", address=f"127.0.0.1:{_free_port()}")  # standby
            # each window: the wrappers' launches while it was open, and
            # its wall time from open to its last step drained
            marks, window_s = [], []
            prof = et.profiler
            real_start, real_stop = prof.maybe_start, prof.stop

            def start(step=None):
                was = prof.tracing
                real_start(step)
                if prof.tracing and not was:
                    marks.append(_all_launches())
                    window_s.append(time.perf_counter())

            def stop():
                was = prof.tracing
                if was:
                    window_s[-1] = time.perf_counter() - window_s[-1]
                real_stop()
                if was:
                    now = _all_launches()
                    marks[-1] = {k: now[k] - marks[-1][k] for k in now}

            prof.maybe_start, prof.stop = start, stop
            pinned = {}
            et.on_resize = lambda ev: pinned.setdefault(ev.generation, PINNED.allocations)
            _reset_launches()
            et.run(OBS_RETARGET_AT)
            # the autoscaler's half: announce, then retarget, under one id
            client.set_prewarm(2, trace_id=trace_id)
            et.run(OBS_RETARGET_AT)  # one poll sees the hint; no step runs
            et.store.wait()
            allocs = PINNED.allocations
            client.set_target_world(2, trace_id=trace_id)
            et.run(OBS_STEPS)
            et.store.wait()
            et.checkpoint_interval = 0
            t0 = time.perf_counter()
            et.run(OBS_STEPS + OBS_PLAIN_STEPS)
            plain_s = time.perf_counter() - t0
            out["steps_dispatched"] = _check_run_launches(et, want, "observability")
            et.stop_heartbeat()
            for _ in range(16):  # a report ships 64 events at most
                if not rec.events_since(et._events_sent_seq):
                    break
                et.flush_telemetry()
            else:
                fail("observability: the member's journal never reached the coordinator")
            mine = [e.to_dict() for e in rec.events()]
            et.world_builder.teardown()

            # -- the loss stream: the profiler changes no math --------------
            got = {r.step: r.loss for r in et.history}
            n = OBS_STEPS + OBS_PLAIN_STEPS
            if sorted(got) != list(range(n)):
                fail(f"observability: steps {sorted(got)}")
            out["losses"] = [got[s] for s in range(n)]
            if ref_losses is not None and out["losses"][:len(ref_losses)] != list(ref_losses):
                fail(f"observability: losses {out['losses']} are not phase 7's run A "
                     f"{list(ref_losses)} bit for bit")
            first_gen = et.resize_events[0].generation
            retarget = [e for e in et.resize_events if e.generation > first_gen]
            if len(retarget) != 1 or not retarget[0].graceful:
                fail(f"observability: resizes {et.resize_events}")
            out["pinned_allocations_in_resize"] = pinned[retarget[0].generation] - allocs
            if out["pinned_allocations_in_resize"]:
                fail(f"observability: the resize allocated {out['pinned_allocations_in_resize']}"
                     " pinned buffers")

            # -- the journal ------------------------------------------------
            tel = client.telemetry()
            journal = tel["events"]
            kinds = [e["kind"] for e in journal]
            for k in ("coord.plan", "coord.world_acked", "resize", "checkpoint.save",
                      "step.first", "prewarm.hint"):
                if k not in kinds:
                    fail(f"observability: no {k} in the coordinator's journal {kinds}")
            unknown = sorted({k for k in kinds if k not in KNOWN_EVENT_KINDS})
            if unknown:
                fail(f"observability: unregistered kinds {unknown}")
            windows = [(e["data"]["phase"], e["data"]["window"], e["step"]) for e in journal
                       if e["kind"] == "profile.window"]
            want_windows = [("open", 1, OBS_WINDOW_AT), ("close", 1, -1),
                            ("open", 2, OBS_RETARGET_AT), ("close", 2, -1)]
            if [(p, w) for p, w, _ in windows] != [(p, w) for p, w, _ in want_windows] or [
                    s for p, _, s in windows if p == "open"] != [OBS_WINDOW_AT, OBS_RETARGET_AT]:
                fail(f"observability: profile windows {windows}")
            plans = [e for e in journal if e["kind"] == "coord.plan" and e.get("trace") == trace_id]
            acked = [e for e in journal if e["kind"] == "coord.world_acked"
                     and e.get("trace") == trace_id]
            if len(plans) != 1 or len(acked) != 1:
                fail(f"observability: plans {plans}, acks {acked} under {trace_id}")
            resize = [e for e in mine if e["kind"] == "resize" and e.get("trace") == trace_id]
            if len(resize) != 1 or not set(resize[0]["timing"]["phases"]) >= {
                    "flush", "world_formation", "restore"}:
                fail(f"observability: the retarget's resize {resize}")
            # the member's own events from the retarget to its first step
            traced = [i for i, e in enumerate(mine) if e.get("trace") == trace_id]
            chain = mine[traced[0]:traced[-1] + 1]
            if {e.get("trace") for e in chain} != {trace_id} or chain[-1]["kind"] != "step.first":
                fail("observability: the member's chain "
                     f"{[(e['kind'], e.get('trace')) for e in chain]}")
            out["chain"] = [e["kind"] for e in chain]
            if [e for e in chain if e["kind"] == "checkpoint.save"] == []:
                fail(f"observability: no flush journaled in the chain {out['chain']}")

            # -- the profile windows ----------------------------------------
            if len(prof.files) != 2:
                fail(f"observability: profile files {prof.files}")
            out["windows"] = []
            for path, first, counted in zip(prof.files, (OBS_WINDOW_AT, OBS_RETARGET_AT), marks):
                steps, kernels, n_kernels, per_step = _window_trace(path)
                if steps != list(range(first, first + OBS_WINDOW_STEPS)):
                    fail(f"observability: window {path} annotates steps {steps}")
                per_window = {w: want[w] * OBS_WINDOW_STEPS for w in OBS_SYMBOLS}
                one_step = {w: want[w] for w in OBS_SYMBOLS}
                if (kernels != per_window or {w: counted[w] for w in OBS_SYMBOLS} != per_window
                        or (per_step is not None
                            and any(c != one_step for c in per_step.values()))):
                    fail(f"observability: window {path} holds kernels {kernels} (by step "
                         f"{per_step}), the wrappers counted {counted}, want {per_window}")
                out["windows"].append({"steps": steps, "kernels": kernels,
                                       "kernels_by_step": per_step,
                                       "device_kernels": n_kernels,
                                       "trace_bytes": os.path.getsize(path)})
            # wall per step from a drained pipeline to the last step
            # drained: each window (the profiler's start included, its
            # export not), and the steps after the run with none open
            out["step_ms"] = {"window_open": [w * 1e3 / OBS_WINDOW_STEPS for w in window_s],
                              "no_window": plain_s * 1e3 / OBS_PLAIN_STEPS}

            # -- edl trace against the live coordinator ---------------------
            live = os.path.join(tmp, "live.json")
            rc, text = _cli("trace", addr, "--out", live, "--summary")
            if rc != 0:
                fail(f"observability: edl trace exited {rc}: {text}")
            doc = json.loads(open(live).read())
            slices = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            (window,) = [e for e in slices if e["name"] == "resize"
                         and e["args"].get("trace") == trace_id]
            children = {e["name"]: e for e in slices if e["pid"] == window["pid"]
                        and e["tid"] == window["tid"] and e["name"].startswith("resize/")
                        and window["ts"] - 1 <= e["ts"] <= window["ts"] + window["dur"] + 1}
            if set(children) != {"resize/flush", "resize/world_formation", "resize/restore"}:
                fail(f"observability: the resize slice's children {sorted(children)}")
            chain_lines = [ln for ln in text.splitlines() if ln.strip().startswith(trace_id)]
            if len(chain_lines) != 1:
                fail(f"observability: edl trace --summary names {trace_id} in {chain_lines}")
            out["timeline_phase_s"] = {k[len("resize/"):]: v["dur"] / 1e6
                                       for k, v in children.items()}
            out["timeline_resize_s"] = window["dur"] / 1e6
            out["summary_chain"] = chain_lines[0].strip()

            # -- edl trace --journal on the spill ---------------------------
            spilled = load_journal(spill)
            lane = member_streams(journal).get("tr0", [])

            def key(e):
                return (e["kind"], e["step"], e["generation"], e.get("trace", ""), e["wall"])

            if [key(e) for e in spilled] != [key(e) for e in mine] or [
                    key(e) for e in lane] != [key(e) for e in mine]:
                fail(f"observability: the spill holds {len(spilled)} events, the coordinator's "
                     f"lane {len(lane)}, the member's ring {len(mine)}")
            post = os.path.join(tmp, "journal.json")
            rc, _ = _cli("trace", "--journal", f"tr0={spill}", "--out", post)
            shape = [(e["name"], e["ph"], e.get("dur")) for e in json.loads(
                open(post).read())["traceEvents"] if e["ph"] != "M"]
            live_shape = [(e["name"], e["ph"], e.get("dur")) for e in doc["traceEvents"]
                          if e["ph"] != "M" and e["pid"] == window["pid"]]
            if rc != 0 or shape != live_shape:
                fail(f"observability: edl trace --journal gave {len(shape)} events, the live "
                     f"member lane {len(live_shape)}")
            out["trace_bytes"] = {"live": os.path.getsize(live), "journal": os.path.getsize(post),
                                  "spill": os.path.getsize(spill)}

            # -- edl metrics --------------------------------------------------
            rc, prom = _cli("metrics", addr, "--prom")
            if rc != 0 or "edl_flight_spill_dropped_total" not in prom:
                fail("observability: edl metrics --prom shows no edl_flight_spill_dropped_total")
            out["spill_dropped"] = rec.spill_dropped
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    del et
    torch.cuda.empty_cache()
    out["launches_per_step"] = want
    out["phase_s"] = time.perf_counter() - t_phase
    log({"observability": out})
    return out


# -- phase 15 -------------------------------------------------------------

#: the training soak: tests/test_chaos.py's 200-step cycle (checkpoint
#: interval 10) compressed to 48 steps at interval 4, its faults in their
#: order, and the stager's and the flush's own faults once each.  A
#: death in step 22 is harvested in the drain before the step-24 save.
CHAOS_STEPS = 48
CHAOS_INTERVAL = 4
CHAOS_TRAIN_EVENTS = (
    (4, "member.restart", "tr2"), (4, "member.restart", "tr3"), (4, "scale.target", 4),
    (4, "flush.spill.slow", 0.5),
    (6, "stage.batch.failed", None),
    (9, "transport.refuse", 2),
    (10, "member.kill", "tr3"),
    (12, "transport.torn", 2),
    (14, "stage.batch.slow", 0.05),
    (16, "member.die_with_state", "tr1"),
    (20, "checkpoint.corrupt", None),
    (22, "member.die_with_state", "tr2"),
    (26, "scale.target", 4), (26, "member.restart", "tr1"), (26, "member.restart", "tr2"),
    (26, "member.restart", "tr3"),
    (31, "transport.timeout", 2),
    (34, "coord.restart", None),
    (36, "transport.slow", 0.05),
    (38, "scale.target", 2),
    (43, "transport.refuse", 2),
)
#: the serving soak's faults, one chaos step each, in order: A's prefix
#: cache (evict, then a forced hash skew), a wedged decode dispatch on
#: A, a torn swap candidate in A's store, the router's refused attempt
#: and cut stream, B's receiver tearing A's migration, and the fresh
#: A's death mid-stream
CHAOS_SERVE_EVENTS = {
    "a": ((1, "serve.prefix.evicted", 100000), (2, "serve.prefix.hash.skew", None),
          (3, "serve.dispatch.wedged", None), (4, "serve.swap.torn", None),
          (8, "serve.replica.die", None)),
    "b": ((7, "serve.migrate.torn", None),),
    "router": ((5, "route.backend.refused", None), (6, "route.stream.cut", None)),
}
#: full-width sizes of the serving soak (phase 9's prefix groups)
CHAOS_SERVE_SIZES = {"prefix_blocks": FLEET_PREFIX_BLOCKS, "tails": FLEET_TAILS,
                     "new": FLEET_NEW, "prompt": 1024, "stream_new": 64, "at": 16,
                     "trainer_steps": (2, 4, 6)}


def _chaos_training_soak(card: str) -> dict:
    """Phase 7's configuration under the compressed soak: a ChaosMonkey
    drives an ElasticTrainer that reaches a CoordinatorServer (over a
    ChaosCoordinator) through a ChaosHTTPCoordinator, against a
    fault-free ElasticTrainer run of the same steps."""
    import gc
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch import telemetry
    from edl_tpu_torch.chaos import (
        ChaosCoordinator,
        ChaosHTTPCoordinator,
        ChaosMonkey,
        FaultEvent,
        FaultSchedule,
    )
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        ElasticTrainer,
        LocalCoordinator,
        ShardedDataIterator,
        synthetic_dataset,
    )
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer

    model = get_model("transformer_lm")
    layers = model.decode.layers
    want = {"flash_fwd": layers, "flash_bwd": layers, "flash_bwd_streamk": 0,
            "xent_fwd": 1, "xent_dy": 1, "xent_de": 1}
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH, seed=SEED)
    out = {"card": card, "model": "transformer_lm", "batch": TRAIN_BATCH,
           "seq_len": model.tokens_per_example, "steps": CHAOS_STEPS,
           "checkpoint_interval": CHAOS_INTERVAL, "events": [list(e) for e in CHAOS_TRAIN_EVENTS]}

    # the fault-free run
    coord = LocalCoordinator(target_world=1, max_world=4)
    coord.register("tr0")
    ref_et = ElasticTrainer(model, it, coord, store=HostDRAMStore(keep=3), lr=TRAIN_LR,
                            device="cuda", checkpoint_interval=CHAOS_INTERVAL, seed=SEED)
    t0 = time.perf_counter()
    ref_et.run(CHAOS_STEPS)
    ref_et.store.wait()
    out["fault_free_s"] = time.perf_counter() - t0
    ref = {r.step: r.loss for r in ref_et.history}
    del ref_et
    gc.collect()
    torch.cuda.empty_cache()

    # the soak
    schedule = FaultSchedule(SEED, [FaultEvent(*e) for e in CHAOS_TRAIN_EVENTS])

    def fresh():
        return LocalCoordinator(target_world=2, max_world=4, heartbeat_timeout=1e9)

    ccoord = ChaosCoordinator(fresh(), schedule)
    ccoord.register("tr0")
    ccoord.register("tr1")
    server = CoordinatorServer(ccoord, host="127.0.0.1", port=0).start(evict=False)
    tmp = tempfile.mkdtemp(prefix="edl-chaos-")
    torch.cuda.reset_peak_memory_stats()
    try:
        with telemetry.scoped() as (_, rec):
            client = ChaosHTTPCoordinator(f"127.0.0.1:{server.port}", schedule, timeout=10.0,
                                          retries=5, retry_base_delay=0.02)
            # each coordinator call that carried an injected fault, timed
            faulted, real_request = [], client._request

            def request(req):
                before = dict(client.injected)
                t = time.perf_counter()
                try:
                    return real_request(req)
                finally:
                    hit = [k for k, v in client.injected.items() if v != before[k]]
                    if hit:
                        faulted.append({"faults": hit, "seconds": time.perf_counter() - t})

            client._request = request
            store = HostDRAMStore(keep=3, spill_dir=tmp, chaos=schedule)
            et = ElasticTrainer(model, it, client, store=store, lr=TRAIN_LR, device="cuda",
                                checkpoint_interval=CHAOS_INTERVAL, seed=SEED)
            monkey = ChaosMonkey(schedule, et, coordinator=ccoord, store=store,
                                 coordinator_factory=lambda: LocalCoordinator(
                                     target_world=4, max_world=4, heartbeat_timeout=1e9))
            monkey.track(["tr0", "tr1"])
            at_corrupt = {}

            def on_step(r):
                n = len(monkey.log)
                monkey.on_step(r)
                for step, verb, arg in monkey.log[n:]:
                    if verb == "checkpoint.corrupt":
                        # the snapshots held when the newest one rotted
                        at_corrupt.update(victim=arg, steps=store.steps())

            _reset_launches()
            t0 = time.perf_counter()
            et.run(CHAOS_STEPS, on_step=on_step)
            store.wait()
            out["soak_s"] = time.perf_counter() - t0
            out["steps_dispatched"] = _check_run_launches(et, want, "chaos soak")
            journal = [(e.data["point"], e.data["scheduled_step"]) for e in rec.events()
                       if e.kind == "chaos"]
        if schedule.pending():
            fail(f"chaos soak: faults never delivered: {schedule.pending()}")
        if client.injected != {"refuse": 4, "timeout": 2, "slow": 1, "torn": 2}:
            fail(f"chaos soak: the transport injected {client.injected}")
        fired = sorted((e.point, e.step) for e in schedule.fired())
        if sorted(journal) != fired:
            fail(f"chaos soak: journaled chaos events {sorted(journal)}, fired {fired}")
        events = et.resize_events
        for e in events:
            if e.graceful and e.replayed_steps:
                fail(f"chaos soak: graceful resize of generation {e.generation} replayed "
                     f"{e.replayed_steps} steps")
        # the rotted snapshot is skipped for the next older one, and the
        # replay runs from there to the death that followed it
        victim = at_corrupt.get("victim")
        older = max((s for s in at_corrupt.get("steps", ()) if s < (victim or 0)), default=None)
        death = next((s for s, v, _ in monkey.log if v == "member.die_with_state"
                      and victim is not None and s > victim), None)
        hit = [e for e in events if not e.graceful and e.restored_step == older
               and e.replayed_steps == (death or 0) + 1 - older]
        if older is None or death is None or len(hit) != 1:
            fail(f"chaos soak: corrupted step {victim} (snapshots {at_corrupt.get('steps')}), "
                 f"death at {death}: resizes {[(e.restored_step, e.replayed_steps, e.graceful) for e in events]}")
        slow = [e for e in events if e.graceful and e.phase_seconds.get("flush_bg", 0) >= 0.5]
        if len(slow) != 1:
            fail(f"chaos soak: flush.spill.slow stalled {len(slow)} graceful flushes")
        bad = [(r.step, r.loss, ref.get(r.step)) for r in et.history if r.loss != ref.get(r.step)]
        if bad or sorted({r.step for r in et.history}) != list(range(CHAOS_STEPS)):
            fail(f"chaos soak: not bit-identical to the fault-free run: {bad[:4]}")
        replayed = sum(e.replayed_steps for e in events)
        out.update({
            "pending": [], "injected": client.injected, "monkey_log": monkey.log,
            "corrupted": {"victim": victim, "snapshots": at_corrupt["steps"],
                          "restored": older, "death_step": death,
                          "replayed": hit[0].replayed_steps},
            "resizes": [{"generation": e.generation, "world_size": e.world_size,
                         "restored_step": e.restored_step, "replayed_steps": e.replayed_steps,
                         "graceful": e.graceful, "source": e.restore_source,
                         "seconds": e.seconds, "phase_seconds": e.phase_seconds}
                        for e in events],
            # a resize recovers from the fault that caused it: the window,
            # plus the replayed steps' time for a failure
            "recovery_s": {
                "resizes": [e.seconds for e in events],
                "replay_steps": replayed,
                "transport_calls": faulted,
            },
            "stager": dict(et._stager.stats) if et._stager is not None else None,
            "bit_identical_to_fault_free": True,
            "launches_per_step": want,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        })
        del et
    finally:
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _chaos_serving_soak(device="cuda", model_kwargs=None, sizes=None) -> tuple:
    """Phase 9's fleet (two replicas, chunked prefill and prefix cache
    on, ``route_run`` in front) through the serving faults of
    ``CHAOS_SERVE_EVENTS``: each replica's engine, batchers, prefix cache
    and receiver read its own schedule, the router its own, and the
    soak moves the three clocks together, waiting for each fault to be
    consumed.  Returns ``(out, log, digest)``: the measurements, the
    soak's log and the flight recorder's digest (both deterministic
    for one seed)."""
    import gc

    import torch

    from edl_tpu_torch import telemetry
    from edl_tpu_torch.chaos import FaultEvent, FaultSchedule
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        LocalCoordinator,
        ShardedDataIterator,
        Trainer,
        synthetic_dataset,
    )
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer
    from edl_tpu_torch.serving import DecodeEngine
    from edl_tpu_torch.serving.router import route_run

    sz = dict(CHAOS_SERVE_SIZES, **(sizes or {}))
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sched = {k: FaultSchedule(SEED, [FaultEvent(*e) for e in v])
             for k, v in CHAOS_SERVE_EVENTS.items()}

    def advance(step):
        for s in sched.values():
            s.advance(step)

    def consumed(name, point, timeout=120):
        deadline = time.monotonic() + timeout
        while any(e.point == point for e in sched[name].pending()):
            if time.monotonic() > deadline:
                fail(f"chaos serving: {point} never consumed")
            time.sleep(0.005)

    def wait_until(what, cond, timeout=120):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                fail(f"chaos serving: timed out waiting for {what}")
            time.sleep(0.005)

    model = get_model("transformer_lm", **(model_kwargs or {}))
    spec = model.decode
    # one flash_fwd a layer for each monolithic prefill (no kernel on the CPU)
    prefill_launches = spec.layers if cuda else 0
    vocab, bt = spec.vocab_size, 16
    log_ = []
    out = {"parts_s": {}, "ttft_ms": {"before": [], "during": [], "before_by_request": []}}
    t_phase = time.perf_counter()
    coord = LocalCoordinator(target_world=2, max_world=4)
    cserver = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    caddr = f"127.0.0.1:{cserver.port}"
    reps, router = {}, None
    with telemetry.scoped() as (reg, rec):
        try:
            trainer = Trainer(model, lr=TRAIN_LR, device=device, seed=SEED)
            it = ShardedDataIterator(
                synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH,
                seed=SEED)

            def train_to(state, upto):
                while state.step < upto:
                    state, _ = trainer.step(state, it.device_batch(state.step, device))
                sync()
                return state

            # A's store is the trainer's; B's holds a copy of what it serves
            store_a, store_b = HostDRAMStore(keep=3), HostDRAMStore(keep=3)
            state = train_to(trainer.init_state(), sz["trainer_steps"][0])
            store_a.save_async(state)
            store_a.wait()
            store_b.put(store_a.latest())
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            ea = DecodeEngine(model, device=device, max_seqs=8, block_tokens=bt, store=store_a,
                              chaos=sched["a"])
            eb = DecodeEngine(model, device=device, max_seqs=8, block_tokens=bt, store=store_b,
                              chaos=sched["b"])
            admitted = []
            for eng, rid in ((ea, "chaos-a"), (eb, "chaos-b")):
                reps[rid] = _fleet_replica(eng, caddr, rid)
                _record_admissions(reps[rid], admitted)
            router = route_run(caddr, port=_free_port(), host="127.0.0.1", probe_interval_s=0.1)
            router.router.chaos = sched["router"]
            rbase = f"http://127.0.0.1:{router.port}"
            for rid in reps:
                _wait_route(rbase, rid)

            def settle():
                """Until the router's probes see no replica busy: its
                order (load, then affinity) is then the same every run."""
                wait_until("the router seeing the fleet idle", lambda: not any(
                    r["in_flight"] for r in _get(rbase + "/routes")["replicas"]
                    if r["health"] == "healthy"))

            def where(prompt):
                p = [int(x) for x in prompt]
                hits = [a[0] for a in admitted if a[1] == len(p) and a[2] == tuple(p[:4])
                        and a[3] == tuple(p[-4:])]
                return hits[0] if hits else None  # (a handoff admits it again elsewhere)

            def recompute(engine, prompt, toks, what):
                got = _recompute_check(engine, [np.asarray(prompt)], [toks])
                log_.append((what, "recompute", got["steps"]))
                return got

            # 0. the prefix groups of phase 9, streamed through the router:
            # group 0 lands on A (the order's tie goes by name), group 1
            # on B while A is busy
            t0 = time.perf_counter()
            rng = np.random.RandomState(SEED + 15)
            prefixes = [rng.randint(3, vocab, size=sz["prefix_blocks"] * bt) for _ in range(2)]
            groups = [[np.concatenate([pre, rng.randint(3, vocab, size=n)]) for n in sz["tails"]]
                      for pre in prefixes]
            _reset_launches()
            res, started = {}, {}

            def first(g):
                res[(g, 0)] = _stream(rbase, groups[g][0], sz["new"],
                                      on_token=lambda n: n == 1 and started.setdefault(g, True))

            th = threading.Thread(target=first, args=(0,))
            th.start()
            wait_until("group 0's first token", lambda: started.get(0) or not th.is_alive())
            wait_until("the router seeing A busy", lambda: any(
                r["in_flight"] > 0 for r in _get(rbase + "/routes")["replicas"]))
            first(1)
            th.join(timeout=600)
            for g in (0, 1):
                for i in range(1, len(groups[g])):
                    settle()
                    res[(g, i)] = _stream(rbase, groups[g][i], sz["new"])
            sync()
            if _all_launches()["flash_fwd"]:
                fail(f"chaos serving: the chunked posture launched {_all_launches()}")
            homes = [where(groups[g][0]) for g in (0, 1)]
            if homes != ["chaos-a", "chaos-b"]:
                fail(f"chaos serving: the groups' first requests landed on {homes}")
            for key, r in sorted(res.items()):
                toks = _stream_ok(r, sz["new"], f"chaos serving: group request {key}")
                out["ttft_ms"]["before"].append(r["ttft_ms"])
                # (group, request, replica, reused blocks, ms): each engine's
                # first request shows apart from the warm ones
                out["ttft_ms"]["before_by_request"].append(
                    [*key, where(groups[key[0]][key[1]]), r["done"]["reused_blocks"],
                     r["ttft_ms"]])
                log_.append(("group", key, where(groups[key[0]][key[1]]),
                             r["done"]["reused_blocks"], toks))
            recompute(ea, groups[0][0], res[(0, 0)]["tokens"], "group")
            out["parts_s"]["groups"] = time.perf_counter() - t0

            def a_request(prompt, what, want_reused):
                """One stream through the router that must land on A."""
                settle()
                r = _stream(rbase, prompt, sz["new"])
                toks = _stream_ok(r, sz["new"], what)
                if where(prompt) != "chaos-a" or r["done"]["reused_blocks"] != want_reused:
                    fail(f"{what}: served by {where(prompt)} reusing "
                         f"{r['done']['reused_blocks']} blocks (want chaos-a, {want_reused})")
                out["ttft_ms"]["during"].append(r["ttft_ms"])
                log_.append((what, r["done"]["reused_blocks"], toks))
                recompute(ea, prompt, toks, what)

            # 1. serve.prefix.evicted: A's cached blocks go at its next
            # busy token boundary, before the next admission claims
            # them: group 0 then prefills cold, correctly
            t0 = time.perf_counter()
            advance(1)
            tail = lambda: np.concatenate([prefixes[0], rng.randint(3, vocab, size=5)])  # noqa: E731
            a_request(tail(), "chaos serving: after serve.prefix.evicted", 0)
            consumed("a", "serve.prefix.evicted", timeout=1)
            # 2. serve.prefix.hash.skew: the republished entry is taken
            # for a collision: a miss, never foreign K/V
            advance(2)
            a_request(tail(), "chaos serving: under serve.prefix.hash.skew", 0)
            consumed("a", "serve.prefix.hash.skew", timeout=1)
            a_request(tail(), "chaos serving: after the prefix faults", sz["prefix_blocks"])
            outcomes = [e.data["outcome"] for e in rec.events() if e.kind == "serve.prefix"
                        and e.data["outcome"] in ("chaos_evicted", "hash_skew_rejected")]
            if outcomes != ["chaos_evicted", "hash_skew_rejected"]:
                fail(f"chaos serving: prefix outcomes journaled {outcomes}")
            out["parts_s"]["prefix"] = time.perf_counter() - t0

            # 3. serve.dispatch.wedged on A's decode dispatch after token 4
            t0 = time.perf_counter()
            wprompt = rng.randint(3, vocab, size=sz["prompt"])
            times = []

            def on_event(ev):
                times.append((time.perf_counter(), ev))
                if ev.get("i") == 3 and not ev.get("restart") and len(times) == 4:
                    advance(3)  # the next dispatch of A is token 4's decode

            t = reps["chaos-a"].gen_batcher.submit_generate(
                {"tokens": wprompt.tolist()}, max_new_tokens=sz["new"], deadline_s=600.0,
                on_event=on_event)
            wtoks, meta = t.result(timeout=600)
            if meta["restarts"] != 1 or reg.counter("edl_serve_dispatch_wedged_total").value() != 1:
                fail(f"chaos serving: the wedge: {meta['restarts']} restarts, "
                     f"{reg.counter('edl_serve_dispatch_wedged_total').value()} trips")
            after = [tt for tt, ev in times if ev.get("restart")]
            resumed = [tt for tt, ev in times if "token" in ev and after and tt > after[0]]
            out["wedge"] = {"recovery_ms": (resumed[0] - times[3][0]) * 1e3,
                            "restarts": meta["restarts"]}
            log_.append(("wedge", meta["restarts"], wtoks))
            recompute(ea, wprompt, wtoks, "wedge")
            out["parts_s"]["wedge"] = time.perf_counter() - t0

            # 4. serve.swap.torn on the trainer's fresh save, then a good one
            t0 = time.perf_counter()
            rejected = reg.counter("edl_serve_swap_rejected_total")
            with ea._refresh_lock:  # no refresh may see the candidate before it rots
                state = train_to(state, sz["trainer_steps"][1])
                store_a.save_async(state)
                store_a.wait()
                advance(4)
            # the refresh a token boundary of A runs (its idle worker
            # would run it within 0.5 s), here at once
            t1 = time.perf_counter()
            ea.refresh()
            reject_s = time.perf_counter() - t1
            if ea.weights_step != sz["trainer_steps"][0] or store_a.latest().step != sz[
                    "trainer_steps"][0]:
                fail(f"chaos serving: after the torn swap A serves step {ea.weights_step}")
            # (the wedge's new cache epoch dropped A's prefix index)
            a_request(tail(), "chaos serving: serving the old step after the torn swap", 0)
            state = train_to(state, sz["trainer_steps"][2])
            store_a.save_async(state)
            store_a.wait()
            t1 = time.perf_counter()
            ea.refresh()
            take_s = time.perf_counter() - t1
            store_b.put(store_a.latest())
            eb.refresh()
            if (ea.weights_step, eb.weights_step) != (sz["trainer_steps"][2],) * 2:
                fail(f"chaos serving: after the good save A serves step {ea.weights_step}, "
                     f"B step {eb.weights_step}")
            if rejected.value() != 1:
                fail(f"chaos serving: {rejected.value()} swap rejections, want 1")
            del state, trainer
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            out["swap"] = {"reject_s": reject_s, "take_s": take_s,
                           "steps": list(sz["trainer_steps"])}
            log_.append(("swap", ea.weights_step, eb.weights_step, rejected.value()))
            out["parts_s"]["swap"] = time.perf_counter() - t0

            # 5. route.backend.refused, 6. route.stream.cut
            t0 = time.perf_counter()
            for step, point in ((5, "route.backend.refused"), (6, "route.stream.cut")):
                advance(step)
                p = rng.randint(3, vocab, size=sz["prompt"])
                settle()
                r = _stream(rbase, p, sz["new"])
                toks = _stream_ok(r, sz["new"], f"chaos serving: {point}")
                consumed("router", point, timeout=1)
                if point == "route.stream.cut" and r["done"].get("redriven") != 1:
                    fail(f"chaos serving: the cut stream's done line {r['done']}")
                out["ttft_ms"]["during"].append(r["ttft_ms"])
                log_.append((point, r["done"].get("redriven", 0), toks))
                recompute(ea, p, toks, point)
            if reg.counter("edl_route_retries_total").value(reason="refused") < 2:
                fail("chaos serving: the router counted no refused attempt")
            out["parts_s"]["router"] = time.perf_counter() - t0

            # 7. a migrating drain of A under serve.migrate.torn at B
            t0 = time.perf_counter()
            advance(7)
            _wait_route(rbase, "chaos-a", first=True)
            mprompt = rng.randint(3, vocab, size=sz["prompt"])
            drain = {}

            def drain_a():
                with _post(rbase + "/drain_intent", {"replicas": ["chaos-a"]}) as r:
                    r.read()
                t = time.perf_counter()
                with _post(f"http://{reps['chaos-a'].address}/drain",
                           {"budget_ms": 120000, "migrate_to": reps["chaos-b"].address}) as r:
                    drain["ack"] = json.loads(r.read())
                drain["s"] = time.perf_counter() - t

            drainer = threading.Thread(target=drain_a)
            migrated = _stream(rbase, mprompt, sz["stream_new"],
                               on_token=lambda n: n == sz["at"] and drainer.start())
            drainer.join(timeout=300)
            consumed("b", "serve.migrate.torn", timeout=1)
            mtoks = _stream_ok(migrated, sz["stream_new"], "chaos serving: the torn migration",
                                  restarts=1)
            mig = (drain.get("ack") or {}).get("migrate") or {}
            if not (drain.get("ack", {}).get("drained") and mig.get("migrated") == 0
                    and mig.get("fallback") == 1 and where(mprompt) == "chaos-a"):
                fail(f"chaos serving: the torn migration's ack {drain.get('ack')}, "
                     f"admitted by {where(mprompt)}")
            out["drain"] = {"seconds": drain["s"], "migrate": mig}
            out["ttft_ms"]["during"].append(migrated["ttft_ms"])
            log_.append(("torn migration", mig.get("fallback"), mtoks))
            recompute(eb, mprompt, mtoks, "torn migration")
            wait_until("A leaving the coordinator", lambda: "chaos-a" not in coord.members())
            out["parts_s"]["migrate"] = time.perf_counter() - t0

            # 8. serve.replica.die mid-stream: A afresh (its pod schedule),
            # both monolithic; the router resumes the stream on B
            t0 = time.perf_counter()
            reps.pop("chaos-a").stop()
            reps["chaos-a"] = _fleet_replica(ea, caddr, "chaos-a", chunked=False,
                                             chaos=sched["a"])
            _record_admissions(reps["chaos-a"], admitted)
            gb = reps["chaos-b"].gen_batcher
            with gb.frozen():
                gb.chunked_prefill = False
            _wait_route(rbase, "chaos-a", reps["chaos-a"].address, first=True)
            rprompt = rng.randint(3, vocab, size=sz["prompt"])
            kill = {}

            def at_kill(n):
                if n == sz["at"]:
                    sync()
                    kill["t"] = time.perf_counter()
                    kill["before"] = _all_launches()
                    _reset_launches()
                    advance(8)  # A's heartbeat loop dies at its next beat

            _reset_launches()
            redriven = _stream(rbase, rprompt, sz["stream_new"], on_token=at_kill)
            sync()
            leg = _all_launches()
            consumed("a", "serve.replica.die", timeout=1)
            rtoks = _stream_ok(redriven, sz["stream_new"], "chaos serving: the killed stream")
            legs = [a[0] for a in admitted if a[2] == tuple(int(x) for x in rprompt[:4])]
            if not reps["chaos-a"]._dead or redriven["done"].get("redriven") != 1 or legs != [
                    "chaos-a", "chaos-b"]:
                fail(f"chaos serving: the killed stream: dead {reps['chaos-a']._dead}, done "
                     f"{redriven['done']}, admissions {legs}")
            if kill["before"]["flash_fwd"] != prefill_launches or leg[
                    "flash_fwd"] != prefill_launches:
                fail(f"chaos serving: monolithic prefills launched {kill['before']['flash_fwd']} "
                     f"and {leg['flash_fwd']} flash_fwd (want {prefill_launches} each)")
            t_after = [tt for tt, ev in redriven["lines"] if "token" in ev and tt > kill["t"]]
            t_before = [tt for tt, ev in redriven["lines"] if "token" in ev and tt <= kill["t"]]
            out["redrive"] = {"gap_ms": (t_after[0] - t_before[-1]) * 1e3,
                              "launches_a_prefill": kill["before"], "launches_resumed": leg}
            out["ttft_ms"]["during"].append(redriven["ttft_ms"])
            log_.append(("killed stream", redriven["done"]["redriven"], rtoks))
            recompute(eb, rprompt, rtoks, "killed stream")
            # the router ejects the dead replica after 3 failed probes
            wait_until("the router ejecting A", lambda: any(
                r["replica"] == "chaos-a" and r["health"] == "ejected"
                for r in _get(rbase + "/routes")["replicas"]))
            out["parts_s"]["die"] = time.perf_counter() - t0

            pending = {k: s.pending() for k, s in sched.items() if s.pending()}
            if pending:
                fail(f"chaos serving: faults never delivered: {pending}")
            fired = sorted((e.point, e.step) for s in sched.values() for e in s.fired())
            journal = sorted((e.data["point"], e.data["scheduled_step"]) for e in rec.events()
                             if e.kind == "chaos")
            if journal != fired:
                fail(f"chaos serving: journaled chaos events {journal}, fired {fired}")
            for k in ("before", "during"):
                v = out["ttft_ms"][k]
                out["ttft_ms"][k + "_p50_p95"] = [float(np.percentile(v, 50)),
                                                  float(np.percentile(v, 95))]
            if cuda:
                out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
            out["phase_s"] = time.perf_counter() - t_phase
            out["pending"] = []
        finally:
            if router is not None:
                router.stop()
            for r in reps.values():
                if not r._dead:
                    r.stop()
            cserver.stop()
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        digest = rec.digest()
    return out, log_, digest


def phase_chaos(card: str) -> dict:
    """The chaos harness on the card: the training soak and the serving
    soak at full width."""
    t0 = time.perf_counter()
    out = {"card": card, "training": _chaos_training_soak(card)}
    serving, log_, digest = _chaos_serving_soak()
    out["serving"] = serving
    out["serving"]["log_entries"] = len(log_)
    out["serving"]["digest"] = digest
    out["phase_s"] = time.perf_counter() - t0
    log({"chaos": out})
    return out


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import edl_tpu_torch  # noqa: F401  (fails here when run without the repo)

    card = phase_device()
    phase_build()
    kernels = {"flash_fwd": phase_kernels(), "flash_bwd": phase_flash_bwd(),
               "flash_bwd_streamk": phase_long_kernels()}
    xent = phase_xent()
    phase_speed_guard(kernels, xent)
    serving = phase_serving()
    training = phase_training()
    long_training = phase_longcontext_training()
    elastic = phase_elastic(card)
    phase_serving_replica(card)
    phase_serving_fleet(card)
    phase_control_plane(card)
    phase_fleet_market(card)
    phase_model_zoo(card)
    phase_observability(card, elastic["losses"])
    phase_moe(card)
    phase_chaos(card)
    timings = {name: kernels[name]["timing"] for name in kernels}
    timings.update(xent["timing"])
    errors = {name: kernels[name]["max_abs_err"] for name in kernels}
    errors.update(xent["max_abs_err"])
    # each kernel's launches on its own path: B1 on the serving run, B2
    # and B4-B6 on the T=2048 training steps, B3 on the long-context ones
    launches = {**training["launches_timed_steps"], "flash_fwd": serving["launches"]["flash_fwd"],
                "flash_bwd_streamk": long_training["launches_timed_steps"]["flash_bwd_streamk"]}
    sources = {
        "flash_fwd": ("edl_tpu_torch/ops/csrc/flash_fwd.cu", "edl_tpu/ops/flash_attention.py:203"),
        "flash_bwd": ("edl_tpu_torch/ops/csrc/flash_bwd.cu", "edl_tpu/ops/flash_attention.py:341"),
        "flash_bwd_streamk": ("edl_tpu_torch/ops/csrc/flash_bwd_streamk.cu",
                              "edl_tpu/ops/flash_attention.py:495"),
        "xent_fwd": ("edl_tpu_torch/ops/csrc/xent_fwd.cu", "edl_tpu/ops/fused_xent.py:54"),
        "xent_dy": ("edl_tpu_torch/ops/csrc/xent_dy.cu", "edl_tpu/ops/fused_xent.py:151"),
        "xent_de": ("edl_tpu_torch/ops/csrc/xent_de.cu", "edl_tpu/ops/fused_xent.py:188"),
    }
    line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errors[name],
        "ms": timings[name]["kernel_ms"],
        "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"],
        "bound_by": timings[name]["bound_by"],
        "library_ms": timings[name]["library_ms"],
        # the shape timed, the achieved rate and the share of the bound
        "shape": timings[name]["shape"], "tflops": timings[name]["tflops"],
        "bound_share": timings[name]["bound_ms"] / timings[name]["kernel_ms"],
    } for name, (source, replaces) in sources.items()]}
    log({"script": {"seconds": time.perf_counter() - t_script}})
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
