#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bigdl_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no
result line:

1. device: the card's name, count, and nvidia-smi's name/power limit;
2. build: the three CUDA sources of bigdl_tpu_torch/csrc (flash
   forward, paged decode, flash backward), one nvcc each, started
   together; prints build seconds and ptxas register and spill lines;
3. kernels: each of the four kernels against its plain PyTorch version
   on the card, at the main paths' shapes and at edge cases, with its
   time, the plain version's time, the least time the card could take
   (bound) and, where one exists, one PyTorch call computing the same
   function as a yardstick (never used by the port); every case also
   checks that a second run on the same inputs gives bitwise equal
   outputs.  The forward is timed at the serve path's largest prefill
   (1,12,1024,64) and at the training step's (8,12,1024,64), in float32
   and bf16; each paged case prints the K/V bytes it read and the TB/s
   that makes;
4. serve: a GPT-2-small-width TransformerLM (random weights from a
   seed, float32) behind LMServingEngine answers 8 requests through the
   flash prefill and paged decode kernels, every device step a replayed
   CUDA graph: ``warmup()`` captures each prefill bucket and the decode
   step, ``warmup_prefix()`` the (suffix bucket, prefix-chain bucket)
   pair of the prompts' radix hit.  Every greedy stream is held against
   the port's offline generate on plain attention, and both kernels'
   launch counters (counted through the replays) must be > 0 for that
   run.  The same requests then run once more on an engine with
   ``cuda_graphs=False`` (the eager path), streams held alike, and both
   runs print TTFT p50, decode tokens/s, captures, replays and the two
   kernels' launches;
5. serve_sampled: the same 8 requests sampled at temperature 0.7,
   request i from the key chain of seed i, through both kernels; every
   stream held against offline generate with the same temperature and
   seed (a mismatch is a tie only where the top two of log-probs / T +
   the step's Gumbel noise lie within 1e-4);
6. spec: the same requests on a speculative engine (k = 4, every decode
   round a verify round), in four arms: (1) linear, greedy, the drafter
   a second TransformerLM holding the target's weights: its accepted
   share must be >= 0.9; (2) linear, sampled, replay acceptance, a
   2-layer drafter (the target's embedding, positions, final norm and
   first two blocks); (3) the same with rejection acceptance, run twice:
   the two runs must agree; (4) tree verify on the default ladder
   (widths 2, 3, 5, 8), sampled, once with the 2-layer drafter started
   and held on the widest rung (the one with alternates): some
   alternate must be accepted, so the accepted-path commit copies rows
   on the card; and with the n-gram drafter on 8 copy-heavy prompts
   that end inside their repeated segment, sampled and then greedy: the
   greedy run must have a match accepted.  Arms 1, 2 and 4 hold every
   stream against offline generate, and the flash forward must launch
   in every arm.  Arm 2 runs once more with ``cuda_graphs=False``;
7. quant: int8 quantization on the same model and requests, every step
   a replayed graph.  Q1: the int8 target (``model.quantize("int8")``,
   dequant compute) served greedily through both kernels, every stream
   held against the quantized model's offline generate, its
   ``quant_report`` bytes exactly the reference's for this model
   (497,759,232 -> 243,237,888), printed beside the float serve run
   (weight bytes, TTFT p50, decode tokens/s, peak memory, graph pool).
   Q2: the float target on int8 KV arenas (``kv_quant="int8"``, the
   gather decode), its streams with graphs equal, bitwise, to its
   streams with ``cuda_graphs=False``; it prints the arena bytes against
   a float pool's, the share of tokens equal to the float streams and
   the first decode step's largest logit difference from float KV.  Q3:
   the default drafter, ``spec=4`` (int8 dequant) and
   ``SpecConfig(k=4, drafter_compute="int8")``, greedy and at 0.7,
   every stream held against offline float32 generate; it prints the
   accepted share, the drafter's compute mode and overflow risk.  The
   kernels phase also times the int8 product (``qmatmul_i8``: per-token
   quantization, ``torch._int_mm``, rescale) against the dequant one at
   the served shapes, with the card's int32 accumulators held bitwise
   against the CPU's: library calls, not kernels of the port;
8. tier: the request lifecycle and the host KV tier on the same model
   and requests, every step a replayed graph, each engine's arena
   addresses held across every tier move and no capture after warmup.
   T1: one request at ``deadline_s=60`` equal to offline generate, one
   at ``deadline_s=0`` shed at enqueue (``ServingDeadlineExceeded``),
   one cancelled after its 4th token (truncated, a prefix of generate's),
   one queued behind the full engine shed when its 2 ms budget runs out;
   ``lifecycle_stats()`` exact and, idle, free blocks plus the trie's
   equal to the pool.  T2: every stream hibernated after its 8th token
   (all at once, into a ``HostBlockStore``) and resumed, greedy and at
   0.7, bitwise equal to the same engine's uninterrupted run and to
   offline generate; the bytes moved exactly the hibernated blocks x
   1,179,648; hibernate and resume ms per session from the tracer's
   spans; ``promote_bandwidth_mbs``.  T3: a tier too small to keep a
   session (every resume re-prefills and replays: 8 re-prefills), then
   a spill directory with one file corrupted (a counted miss), streams
   bitwise unchanged.  T4: int8 KV arenas, 313,344 bytes a block,
   streams bitwise equal to the int8 engine's uninterrupted run.  T5: a
   17-block pool in which the 128-token prompt's blocks are evicted
   (demoted) by a 33-token prompt with 239 new tokens; the 200-token
   prompt then promotes the shared 64-token head and prefills from 64.
   T6: ``serving.verify`` transient at p 0.5 (seed 0) on spec arm 2:
   slots demoted, streams exact; ``serving.enqueue`` transient ->
   ``ServingOverloaded``; the registry's keys by prefix;
9. replicas: serving across several engines of the same model on the
   card, in one process, the engines sharing its parameter tensors, every
   step a replayed graph and no replica capturing after warmup.  P1: one
   engine with ``max_prefill_chunk_tokens=128``, greedy: exactly 19
   prefill passes, decode gaps interrupted by chunks, ITL p99 printed
   beside the serve run's.  D1: a ``DisaggCoordinator`` with one prefill
   and one decode replica, greedy and then at 0.7 (a fresh coordinator
   each): 8 migrations and adoptions, no lost payload, migrated_blocks =
   125 less the blocks the decode radix held, 1,179,648 bytes a block
   down and up, the prefill replica never launching the paged kernel and
   the decode replica never the flash kernel; TTFT p50, tokens/s and the
   median ``lm/migrate`` span printed beside the serve run's.  D2: D1
   greedy under ``serving.migrate:backend_lost:p=0.5`` (seed 3):
   re_prefills == lost_payloads > 0, streams bitwise D1's, the decode
   replica's flash launches 12 a cold re-prefill pass.  Then one
   ``LMReplicaSet`` of 2 with a ``RadixRouter`` and a ``HedgePolicy``:
   R1 a session's two turns on one replica (sticky, a radix hit there);
   R3 the 8 requests at 0.7, hedgeable, behind a seeded trigger window
   (hedges fired and won printed); R2 the 511-token request at 0.7 whose
   replica is killed after its 4th token, replayed bitwise on the
   survivor.  Each run prints its launches and allocated MiB around it;
10. train: the same model, full depth, trained by LocalOptimizer (Adam,
   TimeDistributed(ClassNLL)) on a fixed 8 x 1024 batch through the
   flash forward and both flash backward kernels: step-0 loss and every
   gradient held against plain attention, every bf16-compute gradient
   held against them too, the loss must fall over one optimize() of a
   warm-up and 5 timed steps, one optimize() of a warm-up and 3 timed
   bf16-compute steps, and the train CLI once on a packed,
   document-isolated corpus; the three kernels' launch counters must be
   12 a step;
11. moe: the same widths with every block's MLP a top-1 switch MoE of 8
   experts (capacity 1.25, aux weight 0.01; 2,083,316,736 bytes of
   float32 weights).  M1: the train batch through the three flash
   kernels, step-0 loss within 1e-5 and every gradient leaf (the gate
   and experts included) within 1e-3 of its max |g| against plain
   attention, aux_loss > 0, the gate's gradient non-zero; one optimize()
   of a warm-up and 3 timed steps, exactly 12 launches a step of each
   kernel, the tokens over capacity by layer.  M2: the trained model
   behind LMServingEngine (graphs on, dense routing) on the serve
   prompts, every greedy stream held against offline generate on plain
   attention, both kernels launched, no capture after warmup; TTFT and
   tokens/s beside the dense serve run's;
12. accum: the dense model's gradient on the train batch in 2 and 4
   micro-batches against 1 (loss within 1e-5, leaves within 1e-3), and
   two LocalOptimizer steps at each n with exactly 12 n launches a step
   of each flash kernel and the run's peak;
13. ckpt: C1 a 5-step Adam run against one whose data stream dies while
   step 4's batch is read (checkpoints every 2 iterations, the emergency
   checkpoint at 3), resumed by a fresh model and optimizer: losses
   within 1e-5, each leaf's max |dw| within 1e-5 of its max |w|, the
   pair's bytes and its write and read seconds; C2 SIGTERM mid-run: one
   checkpoint, a clean return, the handler restored, the resilience
   counters; C3 the train CLI with --checkpoint, --resume, and the eval
   CLI with --generate on the newest model (files in a temporary
   directory, removed);
14. gpt2: a GPT-2-small state dict with Hugging Face's names from seed
   0, torch.save'd, imported and decoded by the port's
   ``example/gpt2_import.py --checkpoint`` (16 tokens), held against
   offline generate on plain attention; export then import bitwise;
15. obs: observability, traffic and train summaries on the serve cell's
   model and engine (graphs on, warmed), after ``release``, the memory
   ledger a fresh one, every bundle and incident file in a temporary
   directory.  O1: open-loop poisson traces (3 s, prompts of 17, 64,
   200, 511 tokens, 16, 32 or 64 new, deadlines 1 s, 2 s or none) at 4,
   8, 16, 32 and 64 requests/s, doubled on until ``detect_knee`` reports
   saturation, the time-series sampler at 0.1 s; each rate's row
   (offered, accepted, shed, completed, good, goodput, TTFT p50/p99,
   agreement), the knee; every completed stream at or below the knee,
   and a seeded 16 above it, equal to offline generate, truncated ones
   its prefixes, no accepted request lost.  O2: ``reconcile()`` against
   the CUDA allocator (verdict ``reconciled``), the KV arenas' and the
   staged params' exact bytes, the drift split into the allocator's
   cache and unregistered live tensors; a budget the card crosses defers
   4 admissions and dumps one ``mem_pressure`` bundle with the table;
   lifted, the 4 streams equal offline generate.  O3: a ChaosReplayer
   schedule (``build_schedule`` over an incident log mapping to
   ``serving.verify`` and ``serving.enqueue``) over a poisson trace at
   half the knee on a k = 4 speculative engine, tracer on: no accepted
   loss, every stream exact, one bundle per site with spans, a
   time-series window, the engine's state and requests and
   ``diagnose_cuda``.  O4: 6 Adam steps on the train batch with
   TensorBoard summaries (Loss, Throughput, LearningRate each step,
   Parameters and a validation every 3), the 5th update sleeping past a
   1.5 s watchdog deadline: one stall bundle, an emergency pair at
   iteration 5 bitwise the run's weights there, the Loss scalars equal
   the loop's, one histogram per leaf per Parameters step, and the ms of
   a scalar step and of a Parameters record.  O5: Adam raising inside
   its 3rd update after staging one leaf: the emergency pair is
   iteration 2, resume and finish within C1's tolerances; a user's
   in-place Adam raising inside its 3rd update after writing one leaf:
   the loop restores its snapshot and the pair is iteration 2, the
   weights bitwise the pair's; the step and peak with staged updates
   beside the in-place update (snapshotted), twice each, and the train
   phase's.  Launches: O1 and O2 both serving kernels, O3 the
   flash forward (its decode rounds are verify rounds), O4 and O5 the
   three flash kernels exactly 12 a step (O4's forward also 12 a
   validation);
16. batch: the padded-batch serving stack and the Module core, on the
   serve cell's model (its seed-0 weights, ``attention_impl="auto"``)
   while the plain-attention oracle still holds them.  B1:
   ``ServingEngine(model, input_shape=(128,), max_batch_size=8)``,
   buckets 1, 2, 4, 8, graphs on and warmed (4 captures, none after);
   64 requests of 1-8 rows of random 1-based ids in the sizes of the
   reference's BENCH_SERVE.json mix cut to 8, from 4 threads, then 8
   synchronous ``predict`` calls and 2 oversized requests of 19 rows:
   every returned (n, 128, 50257) block within 1e-3 of the plain
   forward's log-probs, cache hit rate 1.0, flash_fwd exactly 12
   launches a replay; examples/s, latency p50/p99, queue wait against
   device time (``ServingMetrics``), peak, graph pool and the time of
   the top bucket's 205.9 MB copy to the host.  B2: a ``ReplicaSet`` of
   2 over the same model under ``serving.dispatch:die:name=r1,after=4``:
   the B1 requests one at a time, each answer bitwise the single
   engine's, re-dispatches and breaker states printed.  B3:
   ``Sequential(MultiHeadAttention(768, 12, causal=True), Linear(768,
   768)).build(0)`` on 4 x 256 x 768: ``forward``, ``backward`` and
   ``get_parameters()`` through the flash forward and both backward
   kernels, gradInput and every gradient leaf within 1e-3 of its max
   |g| against the same module on plain attention, forward and backward
   ms.

Every serving engine must keep its captures bounded: prefill entries at
most the buckets, one decode graph, one verify graph (one per tree
rung), at most one commit graph, one drafter decode graph (none for the
n-gram drafter), and no capture after warmup on the traffic warmup
covered.  Each run prints its warmup seconds, capture seconds and the
bytes of the engine's graph pool.

``--profile PATH`` adds one more serve run of fresh prompts on each of
the two serve engines, one more run of spec arm 2 on each of its two
engines, one more float32 training step, one more bf16-compute step and
one more MoE training step under torch.profiler and writes their kernel
tables (device busy time, idle share, time by kernel) to PATH and to
PATH with ``_eager``, ``_spec``, ``_spec_eager``, ``_train``,
``_train_bf16`` and ``_moe`` before its extension.

The flash kernels' bounds, forward and backward, take float32 at the
3xTF32 tensor-core rate (495 / 3 TFLOP/s), the rate those kernels run
at; the CUDA-core bound (67 TFLOP/s) is printed beside it.

The last lines are the kernels' JSON object, nvidia-smi's
"name, power.limit" line, and the result object.  Without a CUDA
device, or without the bigdl_tpu_torch package beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import logging
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,        # CUDA-core float32 (no tensor cores)
              "float32_3xtf32": 495e12 / 3,  # float32 as three TF32 products
              "bfloat16": 989e12,      # dense bf16 tensor cores
              "int8": 1979e12}         # dense int8 tensor cores (TOP/s)
TOL_F32 = 1e-4                         # float32: summation order only
TOL_BF16_O, TOL_BF16_LSE = 2e-2, 1e-2  # bf16 rounding of p and o

# GPT-2 small widths; depth kept at the full 12 layers
GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, n_head=12, n_layers=12,
                  ffn_size=3072, max_len=1024, pos_encoding="learned",
                  tie_embeddings=True)
SERVE = dict(slots=8, cache_len=1024, block_len=16, max_new=32,
             prompt_lens=(17, 33, 64, 128, 200, 300, 511, 700),
             shared_head=64, seed=0)
SPEC = dict(k=4, temperature=0.7, draft_layers=2, min_accept_full=0.9,
            ngram_seed=2, ngram_prompts=8, ngram_segment=24, ngram_repeats=4,
            ngram_tail=16,
            # the tree arm's step-down EMA: at the demotion floor, so a
            # slot stays on the widest rung until it would be demoted
            tree_stepdown=0.1)
TIE_GAP = 1e-4  # a mismatch is a tie when the plain top-2 gap is below
# backward kernels, relative to each gradient's max |value|: float32 differs
# by summation order only; bf16 by the rounding of p and ds to bf16
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN = dict(batch=8, seq_len=1024, check_batch=2, warmup=1, steps=5,
             bf16_steps=3, learning_rate=3e-4, seed=0, data_seed=0)
TOL_LOSS = 1e-5       # step-0 loss, flash vs plain attention, relative
TOL_GRAD = 1e-3       # each leaf's max abs error over its max |g|: float32
                      # with the summation order changed through 12 layers
TOL_BF16_STEP = 2e-2  # bf16-compute step-0 loss vs float32's, relative
TOL_BF16_GRAD = 6e-2  # each leaf's bf16-compute gradient: max abs error over
                      # the float32 leaf's max |g|, bf16 rounding of every
                      # product's inputs through 12 layers and back; about
                      # twice the worst leaf measured on an H100 (2.7e-2)
# the JAX reference's quant_report for GPT2_SMALL quantized to int8 (its
# byte counts do not depend on the weights)
QUANT_REPORT_GPT2 = dict(bytes_orig=497_759_232, bytes_quant=243_237_888,
                         quantized_leaves=8, skipped_leaves=12)
# the int8 vs dequant product timings: the served rows (8 decode slots,
# the 8 x 5 verify rows, a 1024-token prefill) by the served (k, n)
QUANT_PRODUCT_ROWS = (8, 40, 1024)
QUANT_PRODUCT_KN = ((768, 768), (768, 3072), (3072, 768))
# the tier phase: hibernation after the 8th token; one block's wire
# payload (k and v, float32 and int8 with its scales) at GPT-2-small width
TIER = dict(hibernate_at=8, cancel_at=4, queued_deadline_s=0.002,
            wire_block_bytes=1_179_648, wire_block_bytes_int8=313_344)
# the replicas phase: P1's chunk cap and its prefill passes (1+1+1+1 for
# the four short prompts, 2, 3, 4 and 6 for the 200-, 300-, 511- and
# 700-token ones); D2's fault; R1's turn-2 tail; R3's seeded hedge window
# (waits well under any TTFT, so the p50 trigger fires); R2's stream and
# the token after which its replica dies
REPLICAS = dict(chunk_cap=128, prefill_passes=19,
                d2_fault="serving.migrate:backend_lost:p=0.5",
                turn2_extra=(3, 5, 2), hedge_seed_waits=8,
                hedge_seed_wait_s=0.0005, r2_prompt=6, r2_kill_at=4)
TRAIN_CLI = ["--synthetic", "-e", "1", "-b", "8", "--hiddenSize", "768",
             "--nHead", "12", "--nLayers", "2", "--seqLength", "128",
             "--packed", "--docIsolate"]
# the moe phase: 8 experts a block, capacity 1.25, aux weight 0.01; the
# float32 weights of GPT2_SMALL so (520,829,184 parameters)
MOE = dict(experts=8, capacity_factor=1.25, aux_weight=0.01, warmup=1,
           steps=3, weight_bytes=2_083_316_736)
ACCUM_MICRO = (2, 4)  # the accum phase's micro-batches a step, beside 1
# the ckpt phase: 16 rows of the training length in batches of 4 (an
# epoch of 4 steps, so step 4 resumes mid-epoch and step 5 starts the
# next); checkpoints every 2 iterations; the failing read (the read-ahead
# during step 3, surfacing as step 4 begins) and the SIGTERM read; C1's
# tolerance on each parameter leaf (max |dw| over its max |w|)
CKPT = dict(rows=16, batch=4, steps=5, every=2, crash_at=4, sigterm_at=3,
            generate=8, tol_param=1e-5)
GPT2 = dict(seed=0, prompt="464,3290,318", new_tokens=16)
# the obs phase.  O1: 3 s poisson traces of the serve cell's model at
# rising rates (extended by doubling up to max_rate until the knee
# saturates), the sampler at 0.1 s, a seeded sample of 16 streams checked
# above the knee; O2: the arenas' and staged params' exact bytes (2 x 12
# layers x 769 blocks x 16 x 12 heads x 64 x 4; quant_report's
# 497,759,232), 4 requests held past the watermark for defer_s; O3: an
# incident log whose stages map to serving.verify ("lm") and
# serving.enqueue (a clean exit), 0.3 s apart, scheduled over 3 s at half
# the knee on a k = 4 speculative engine; O4: 6 Adam steps, Parameters
# and validation every 3, the 5th update sleeping 4 s past a 1.5 s
# watchdog deadline; O5: a failure inside the 3rd update of 1 + 3 steps
OBS = dict(duration_s=3.0, rates=(4, 8, 16, 32, 64), max_rate=1024,
           sample_s=0.1, vocab=GPT2_SMALL["vocab_size"],
           prompt_lens=(17, 64, 200, 511), max_news=(16, 32, 64),
           deadline_menu=(1.0, 2.0, None), agreement_sample=16,
           kv_arena_bytes=907_149_312, params_bytes=497_759_232,
           pressure_requests=4, prompt_seed=3, defer_s=1.0,
           chaos_stages=(("lm", 124), ("profile", 0)), chaos_gap_s=0.3,
           chaos_seed=0, chaos_trace_seed=100, chaos_k=4, steps=6, params_every=3, stall_at=5,
           stall_s=4.0, watchdog_deadline_s=1.5, fail_at=3, o5_steps=3)
# the batch phase: the serve cell's model scoring (n, 128) id blocks
# through ServingEngine (buckets 1, 2, 4, 8): 64 requests in the sizes of
# the reference's BENCH_SERVE.json mix cut to 8, from 4 threads, then 8
# synchronous ones and 2 of 19 rows; B2's fault; B3's (batch, seq) and
# timed steps
BATCH = dict(seq_len=128, max_batch=8, threads=4, requests=64, predicts=8,
             sizes=(1, 2, 4, 3, 8, 5, 7, 1, 6, 2, 4, 1, 8), oversized=19,
             oversized_n=2, id_seed=12, tol=1e-3,
             fault="serving.dispatch:die:name=r1,after=4", b3_shape=(4, 256),
             b3_steps=3, split_reps=3)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call, by CUDA events around ``iters``
    calls.  A device-side sleep is queued first, so every call is
    already enqueued when the device reaches the first event: the time
    is the device's, not the host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def log_allocated(phase: str) -> None:
    """The device bytes allocated as ``phase`` starts (what earlier phases
    left resident)."""
    import torch
    log(f"[memory] before {phase}: {torch.cuda.memory_allocated() / 2**20:.1f}"
        " MiB allocated")


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
def phase_build():
    from bigdl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    info = _build.build(["flash_fwd", "paged_decode", "flash_bwd"])
    log(f"[build] three sources in {time.perf_counter() - t0:.2f} s "
        "(one nvcc each, in parallel)")
    for name, r in info.items():
        log(f"[build] {name}: nvcc {r['seconds']:.2f} s -> {r['path']}")
        for line in r["ptxas"]:
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log(f"[build]   {line}")


def _visible_pairs(tq, tk, causal, seg_q=None, seg_k=None) -> int:
    import numpy as np
    i = np.arange(tq)[:, None]
    j = np.arange(tk)[None, :]
    vis = np.ones((tq, tk), bool)
    if causal:
        vis &= j <= i + (tk - tq)
    if seg_q is None:
        return int(vis.sum())
    total = 0
    for b in range(seg_q.shape[0]):
        total += int((vis & (seg_q[b][:, None] == seg_k[b][None, :])).sum())
    return total


def flash_case(dev, tq, tk, dtype, causal=True, segmented=False, seed=0,
               b=1):
    """The forward kernel at (b, 12, tq, 64) x (b, 12, tk, 64) against
    its plain version: o and lse within tolerance, finite, bitwise equal
    on a second run; timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (flash_attention_reference,
                                     flash_attention_with_lse)
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    h, d = 12, 64
    q = torch.randn((b, h, tq, d), generator=g).to(dev, tdt)
    k = torch.randn((b, h, tk, d), generator=g).to(dev, tdt)
    v = torch.randn((b, h, tk, d), generator=g).to(dev, tdt)
    seg = None
    if segmented:
        cuts = torch.sort(torch.randint(0, tq, (3,), generator=g)).values
        seg_cpu = torch.bucketize(torch.arange(tq), cuts, right=True)[None]
        seg = seg_cpu.to(dev, torch.int32)

    def kernel():
        return flash_attention_with_lse(q, k, v, causal=causal,
                                        q_segment_ids=seg, kv_segment_ids=seg)

    def plain():
        return flash_attention_reference(q, k, v, causal=causal,
                                         q_segment_ids=seg,
                                         kv_segment_ids=seg)

    o, lse = kernel()
    o2, lse2 = kernel()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    name = (f"flash_fwd ({b},12,{tq},64)x({b},12,{tk},64) {dtype} "
            f"{'causal' if causal else 'full'}{' segmented' if seg is not None else ''}")
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{name}: non-finite output")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{name}: o or lse differs between two runs")
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    tol_o, tol_l = ((TOL_F32, TOL_F32) if dtype == "float32"
                    else (TOL_BF16_O, TOL_BF16_LSE))
    if err_o > tol_o or err_l > tol_l:
        raise AssertionError(f"{name}: o err {err_o:.3e} (tol {tol_o}), "
                             f"lse err {err_l:.3e} (tol {tol_l})")
    del o2, lse2, o_ref, lse_ref
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, iters=5 if b > 1 else 20)
    mask = None
    if seg is not None or tq != tk:
        i = torch.arange(tq, device=dev)[:, None]
        j = torch.arange(tk, device=dev)[None, :]
        mask = j <= i + (tk - tq) if causal else torch.ones_like(i == j)
        if seg is not None:
            mask = mask & (seg[0][:, None] == seg[0][None, :])
    if mask is None:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
    else:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
    item = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * item \
        + lse.numel() * 4 + (0 if seg is None else 2 * seg.numel() * 4)
    seg_np = None if seg is None else seg.cpu().numpy()
    flops = 4.0 * b * h * d * _visible_pairs(tq, tk, causal, seg_np, seg_np)
    # the kernel runs float32 on the tensor cores as three TF32 products
    basis = "float32_3xtf32" if dtype == "float32" else dtype
    bound_ms, bound_by = bound(nbytes, flops, basis)
    simt = ""
    if dtype == "float32":
        simt = (f"; {bound(nbytes, flops, 'float32')[0]:.4f} ms at the 67 "
                f"TFLOP/s CUDA-core rate")
    log(f"[kernels] {name}: max_abs_err o {err_o:.3e} lse {err_l:.3e}, "
        f"bitwise repeatable | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {basis} "
        f"{PEAK_FLOPS[basis] / 1e12:.0f} TFLOP/s{simt})")
    return dict(max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def paged_case(dev, pos_list, dtype, seed=0):
    """The paged kernel on the serve engine's arenas: all 12 layers of
    (769, 12, 16, 64), one layer per call in turn, so the timed calls
    read their K/V from device memory and not from the 50 MB L2, as
    decode's layer after layer does."""
    import torch
    from bigdl_tpu_torch.ops import (paged_decode_attention,
                                     paged_decode_attention_reference)
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    gd = torch.Generator(device=dev).manual_seed(seed)
    layers, s, h, d, blen, m = 12, 8, 12, 64, 16, 64
    n = 1 + (s + 4) * m                         # the serve engine's pool
    ka = torch.randn((layers, n, h, blen, d), generator=gd,
                     device=dev).to(tdt)
    va = torch.randn((layers, n, h, blen, d), generator=gd,
                     device=dev).to(tdt)
    q = torch.randn((s, h, 1, d), generator=g).to(dev)
    tables = (torch.randperm(n - 1, generator=g)[:s * m] + 1).reshape(
        s, m).to(dev, torch.int32)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    turn = [0]

    def kernel(layer=None):
        layer = turn[0] = (turn[0] + 1) % layers if layer is None else layer
        return paged_decode_attention(q, ka[layer], va[layer], tables, pos)

    def plain(layer=None):
        layer = turn[0] = (turn[0] + 1) % layers if layer is None else layer
        return paged_decode_attention_reference(q, ka[layer], va[layer],
                                                tables, pos)

    name = f"paged_decode S=8 H=12 D=64 blen=16 M=64 {dtype} pos={pos_list}"
    err = 0.0
    for layer in (0, layers - 1):
        out, again, ref = kernel(layer), kernel(layer), plain(layer)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: output differs between two runs")
        err = max(err, (out - ref).abs().max().item())
    if err > TOL_F32:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} (tol {TOL_F32})")
    ms = cuda_ms(kernel, iters=48)
    plain_ms = cuda_ms(plain, iters=24)
    live = sum(p + 1 for p in pos_list)
    kv_bytes = 2 * live * h * d * ka.element_size()
    nbytes = (q.numel() * 4 + kv_bytes + tables.numel() * 4
              + pos.numel() * 4 + out.numel() * 4)
    flops = 4.0 * h * d * live
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    log(f"[kernels] {name}: max_abs_err {err:.3e}, bitwise repeatable | "
        f"kernel {ms:.4f} ms, live K/V {kv_bytes / 1e6:.3f} MB read at "
        f"{kv_bytes / ms / 1e9:.3f} TB/s, plain {plain_ms:.4f} ms, library "
        f"null (no single PyTorch call), bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def flash_bwd_case(dev, b, tq, tk, d, dtype, causal=True, segmented=False,
                   seed=0, timed=False):
    """Both backward kernels on one set of (q, k, v, o, lse, do, dlse)
    against the plain backward: dq (dq kernel) and dk, dv (dk/dv kernel)
    within TOL_BWD of each gradient's max |value|, finite, zero dq on
    rows that see no key, and bitwise equal on a second run.  With
    ``timed``, the lse cotangent is zero (as on the training path) and
    returns each kernel's time and bound beside the plain backward's
    time and the backward half of scaled_dot_product_attention (both
    computing all three gradients at once, so both stand on both
    kernels' rows)."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (flash_attention_backward_reference,
                                     flash_attention_reference)
    from bigdl_tpu_torch.ops.flash_attention import (BackwardInputs,
                                                     flash_bwd_dkv,
                                                     flash_bwd_dq)
    tdt = getattr(torch, dtype)
    h = 12
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dt=tdt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
    seg = None
    if segmented:
        cuts = torch.sort(torch.randint(0, tq, (b, 3), generator=g,
                                        device=dev), dim=1).values
        seg = (torch.arange(tq, device=dev)[None, :, None]
               >= cuts[:, None, :]).sum(-1).to(torch.int32)
    o, lse = flash_attention_reference(q, k, v, causal=causal,
                                       q_segment_ids=seg, kv_segment_ids=seg)
    do = randn(*o.shape)
    dlse = (torch.zeros_like(lse) if timed
            else randn(*lse.shape, dt=torch.float32))
    scale = 1.0 / d ** 0.5
    x = BackwardInputs(q, k, v, o, lse, do, dlse, seg, seg, causal, scale)

    def run():
        dk, dv = flash_bwd_dkv(x)
        return flash_bwd_dq(x), dk, dv

    def plain():
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
            q_segment_ids=seg, kv_segment_ids=seg)

    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    name = (f"flash_bwd ({b},{h},{tq},{d})x({b},{h},{tk},{d}) {dtype} "
            f"{'causal' if causal else 'full'}"
            f"{' segmented' if segmented else ''}")
    errs = {}
    for gname, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite {gname}")
        if not torch.equal(a, a2):
            raise AssertionError(f"{name}: {gname} differs between two runs")
        ref = w.float().abs().max().item()
        err = (a.float() - w.float()).abs().max().item()
        if err > TOL_BWD[dtype] * max(ref, 1e-6):
            raise AssertionError(f"{name}: {gname} max_abs_err {err:.3e} "
                                 f"over max |{gname}| {ref:.3e} (tol "
                                 f"{TOL_BWD[dtype]} relative)")
        errs[gname] = err
    if causal and tq > tk and not torch.all(got[0][:, :, :tq - tk] == 0):
        raise AssertionError(f"{name}: rows with no visible key got dq != 0")
    msg = (f"[kernels] {name}: max_abs_err dq {errs['dq']:.3e} dk "
           f"{errs['dk']:.3e} dv {errs['dv']:.3e}, bitwise repeatable")
    if not timed:
        log(msg)
        return None
    dkv_ms = cuda_ms(lambda: flash_bwd_dkv(x))
    dq_ms = cuda_ms(lambda: flash_bwd_dq(x))
    plain_ms = cuda_ms(plain, iters=5, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True))
    item = q.element_size()
    n_q, n_k, rows = b * h * tq * d, b * h * tk * d, b * h * tq * 4
    reads = (2 * n_q + 2 * n_k) * item + 3 * rows   # q, do, k, v; lse,
    pairs = b * h * _visible_pairs(tq, tk, causal)   # delta, dlse
    # the kernels run float32 on the tensor cores as three TF32 products;
    # the CUDA-core bound is printed beside it for the earlier kernels' rows
    basis = "float32_3xtf32" if dtype == "float32" else dtype
    dkv_bytes, dkv_ops = reads + 2 * n_k * item, 8.0 * d * pairs
    dq_bytes, dq_ops = reads + n_q * item, 6.0 * d * pairs
    dkv_bound = bound(dkv_bytes, dkv_ops, basis)
    dq_bound = bound(dq_bytes, dq_ops, basis)
    fused_ms, fused_by = bound(reads + (n_q + 2 * n_k) * item,
                               10.0 * d * pairs, basis)
    simt = ""
    if dtype == "float32":
        simt = (f"; at the 67 TFLOP/s CUDA-core rate: dk/dv "
                f"{bound(dkv_bytes, dkv_ops, 'float32')[0]:.4f} ms, dq "
                f"{bound(dq_bytes, dq_ops, 'float32')[0]:.4f} ms")
    log(f"{msg} | dk/dv kernel {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f} "
        f"ms, {dkv_bound[1]}), dq kernel {dq_ms:.4f} ms (bound "
        f"{dq_bound[0]:.4f} ms, {dq_bound[1]}), one-kernel backward bound "
        f"{fused_ms:.4f} ms ({fused_by}); bounds at {basis} "
        f"{PEAK_FLOPS[basis] / 1e12:.0f} TFLOP/s{simt}; plain backward "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms (both: all "
        f"three gradients)")
    common = dict(plain_ms=plain_ms, library_ms=library_ms)
    return (dict(max_abs_err=max(errs["dk"], errs["dv"]), ms=dkv_ms,
                 bound_ms=dkv_bound[0], bound_by=dkv_bound[1], **common),
            dict(max_abs_err=errs["dq"], ms=dq_ms, bound_ms=dq_bound[0],
                 bound_by=dq_bound[1], **common))


def phase_kernels(dev):
    for t in (8, 100, 512):
        for dtype in ("float32", "bfloat16"):
            flash_case(dev, t, t, dtype)
    flash_case(dev, 1024, 1024, "bfloat16")
    flash_case(dev, 256, 256, "float32", segmented=True, seed=1)
    flash_case(dev, 100, 612, "float32", seed=2)
    # the training step's shape, both compute dtypes
    for dtype in ("bfloat16", "float32"):
        flash_case(dev, 1024, 1024, dtype, b=8)
    # the served model's largest prefill bucket (the 700-token prompt)
    flash_main = flash_case(dev, 1024, 1024, "float32")
    mid = [16 * i + 8 for i in range(8)]
    for dtype in ("float32", "bfloat16"):
        paged_case(dev, [0] * 8, dtype)
        paged_case(dev, mid, dtype)
        paged_case(dev, [1023] * 8, dtype)
    # the served slots' positions at their last decode step
    paged_main = paged_case(dev, [t + SERVE["max_new"] - 2
                                  for t in SERVE["prompt_lens"]], "float32")
    for dtype in ("float32", "bfloat16"):
        flash_bwd_case(dev, 2, 300, 200, 64, dtype, seed=3)  # masked rows
        flash_bwd_case(dev, 2, 100, 612, 64, dtype, seed=4)  # Tk > Tq
        flash_bwd_case(dev, 2, 256, 256, 64, dtype, segmented=True, seed=5)
        flash_bwd_case(dev, 2, 1000, 1000, 64, dtype, seed=6)  # unaligned
        flash_bwd_case(dev, 2, 333, 333, 128, dtype, seed=7)  # D = 128
        flash_bwd_case(dev, 2, 77, 77, 128, dtype, segmented=True, seed=8)
        flash_bwd_case(dev, 2, 33, 17, 64, dtype, causal=False, seed=9)
    flash_bwd_case(dev, 8, 1024, 1024, 64, "bfloat16", timed=True)
    # the training step's shape: batch 8 x 1024 tokens, 12 heads of 64
    dkv_main, dq_main = flash_bwd_case(dev, 8, 1024, 1024, 64, "float32",
                                       timed=True)
    return flash_main, paged_main, dkv_main, dq_main


# --------------------------------------------------------------------------- #
def serve_prompts(seed=SERVE["seed"]):
    import numpy as np
    rng = np.random.RandomState(seed)
    vocab = GPT2_SMALL["vocab_size"]
    prompts = [rng.randint(1, vocab + 1, size=n)
               for n in SERVE["prompt_lens"]]
    # the 128- and 200-token prompts share a 64-token head (radix hit)
    head = SERVE["shared_head"]
    prompts[4][:head] = prompts[3][:head]
    return prompts


class Oracle:
    """The port's offline ``generate`` at batch 1 on plain attention,
    on a model built from the served model's seed (so the same weights),
    or the one ``make_model()`` returns when first needed, each stream
    computed once."""

    def __init__(self, dev, config, seed, make_model=None):
        from bigdl_tpu_torch.models.transformer import TransformerLM
        self.dev = dev
        self._make = make_model
        self._model = None
        if make_model is None:
            self._model = TransformerLM(attention_impl="xla", device=dev,
                                        **config).build(seed=seed)
        self._streams = {}

    @property
    def model(self):
        """The plain-attention model (``make_model()``'s on first use)."""
        if self._model is None:
            self._model = self._make()
        return self._model

    def stream(self, prompt, max_new, temperature=0.0, rng=None):
        from bigdl_tpu_torch.models.transformer.generate import generate
        key = (prompt.tobytes(), max_new, temperature,
               rng if temperature > 0 else None)
        if key not in self._streams:
            self._streams[key] = generate(
                self.model, self.model.params, prompt[None], max_new,
                temperature=temperature, rng=rng, device=self.dev).numpy()[0]
        return self._streams[key]

    def check(self, prompt, got, max_new, temperature=0.0, rng=None):
        """A served stream must equal offline generate's.  A difference
        counts as a tie only when, at the first diverging step, the top
        two of the plain path's scores lie within TIE_GAP: its log-probs
        when greedy; log-probs / T + the step key's Gumbel noise (the
        draw's own scores, up to a constant) when sampled.  Returns
        None, or a description of the tie."""
        import numpy as np
        from bigdl_tpu_torch.utils import keychain
        want = self.stream(prompt, max_new, temperature, rng)
        if got.shape == want.shape and np.array_equal(got, want):
            return None
        if got.shape != want.shape:
            raise AssertionError(f"prompt of {len(prompt)} tokens: served "
                                 f"{got.shape}, offline {want.shape}")
        i = int(np.nonzero(got != want)[0][0])
        scores = self.model.f(self.model.params,
                              want[None, :i])[0, -1].cpu().numpy()
        if temperature > 0:
            key, first = keychain.split(keychain.as_key(rng))
            j = i - len(prompt)           # the generated token's index
            if j == 0:
                draw_key, denom = first, temperature
            else:
                draw_key = keychain.split(key, max_new - 1)[j - 1]
                denom = max(temperature, 1e-6)
            scores = (scores / np.float32(denom)
                      + keychain.gumbel(draw_key, (1, scores.shape[0]))[0])
        top = np.sort(scores)[-2:]
        gap = float(top[1] - top[0])
        if gap >= TIE_GAP:
            raise AssertionError(
                f"prompt of {len(prompt)} tokens: served stream diverges "
                f"from offline generate at position {i} (plain top-2 gap "
                f"{gap:.3e})")
        return f"tie at position {i}, plain top-2 gap {gap:.3e}"


def radix_pairs(prompts, block_len):
    """Suffix lengths and cached block counts of the radix hits among
    ``prompts`` admitted in order: a prompt matches the whole blocks it
    shares with an earlier prompt, at most ``(len - 1) // block_len``."""
    import numpy as np
    suffix, blocks = [], []
    for i, p in enumerate(prompts):
        best = 0
        for q in prompts[:i]:
            n, limit = 0, min((len(p) - 1) // block_len, len(q) // block_len)
            while n < limit and np.array_equal(
                    p[n * block_len:(n + 1) * block_len],
                    q[n * block_len:(n + 1) * block_len]):
                n += 1
            best = max(best, n)
        if best:
            suffix.append(len(p) - best * block_len)
            blocks.append(best)
    return suffix, blocks


def warm_engine(engine, prompts):
    """``warmup()``, then ``warmup_prefix()`` for the radix hits of
    ``prompts``; returns the wall seconds and the graph counters."""
    import torch
    t0 = time.perf_counter()
    engine.warmup()
    suffix, blocks = radix_pairs(prompts, engine.block_len)
    engine.warmup_prefix(suffix_lens=suffix, prefix_blocks=blocks)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(engine.graphs.stats(), warm_s=time.perf_counter() - t0,
                pool_bytes=engine.graphs.pool_bytes())


def check_bounded(run, engine, warm):
    """The bounded-captures contract after ``run``: prefill entries at
    most the buckets, one decode graph, one verify graph (one per tree
    rung), at most one commit graph, one drafter decode graph (none for
    the n-gram drafter), and no capture since warmup.  Returns the
    engine's graph counters."""
    st = engine.stats()
    bad = []
    if st["prefill_cache"]["entries"] > len(engine.prefill_buckets):
        bad.append(f"{st['prefill_cache']['entries']} prefill entries for "
                   f"{len(engine.prefill_buckets)} buckets")
    if engine.spec is None:
        if engine._decode_exec.compiles != 1:
            bad.append(f"{engine._decode_exec.compiles} decode graphs")
    else:
        want = len(engine._tree_shapes) if engine.spec.tree else 1
        if engine._verify_compiles != want:
            bad.append(f"{engine._verify_compiles} verify graphs, not {want}")
        if engine._commit_compiles > 1:
            bad.append(f"{engine._commit_compiles} commit graphs")
        want = 0 if engine.spec.drafter_compute == "ngram" else 1
        if engine.draft.decode_compiles != want:
            bad.append(f"{engine.draft.decode_compiles} drafter decode "
                       f"graphs, not {want}")
    graphs = st["cuda_graphs"]
    if graphs["captures"] != warm["captures"]:
        bad.append(f"{graphs['captures'] - warm['captures']} captures after "
                   "warmup on traffic it covered")
    if bad:
        raise AssertionError(f"{run}: unbounded captures: " + "; ".join(bad))
    return graphs


def idle_text(idle):
    return "not measured (no --profile)" if idle is None else f"{idle:.4f}"


def graph_line(out):
    """The graph counters and warmup times of one run, for the log."""
    g, w = out["graphs"], out["warm"]
    pool = ("none" if w["pool_bytes"] is None
            else f"{w['pool_bytes'] / 2**20:.1f} MiB")
    return (f"graphs {'on' if g['enabled'] else 'off'}: {g['captures']} "
            f"captures ({w['capture_s']:.2f} s of capture in a "
            f"{w['warm_s']:.2f} s warmup), {g['replays']} replays, graph "
            f"pool {pool}")


def serve_run(engine, prompts, max_new, temperature=0.0):
    """Submit every prompt at once (request i samples with ``rng=i``)
    and wait for all, the launch counters read from 0 around it.
    Returns the run's numbers with its streams and results."""
    import numpy as np
    _reset_launches()
    t0 = time.perf_counter()
    streams = [engine.submit(p, max_new_tokens=max_new,
                             temperature=temperature, rng=i)
               for i, p in enumerate(prompts)]
    results = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    launches = _launches()
    decode_s = (max(s.finished_at for s in streams)
                - max(s.first_token_at for s in streams))
    decode_tokens = sum(len(s.generated) - 1 for s in streams)
    return dict(results=results, launches=launches, wall_s=wall,
                ttft_p50_s=float(np.median([s.ttft_s for s in streams])),
                decode_tokens_per_s=decode_tokens / decode_s)


def check_streams(phase, oracle, prompts, results, max_new, temperature=0.0):
    """Every stream against offline generate (ties allowed as
    ``Oracle.check`` defines them); returns the ties."""
    ties = []
    for i, (p, r) in enumerate(zip(prompts, results)):
        tie = oracle.check(p, r, max_new, temperature, rng=i)
        if tie is not None:
            ties.append((len(p), tie))
            log(f"[{phase}] prompt of {len(p)} tokens: {tie}")
    return ties


# device kernel -> the port's kernel (C entry point) that launches it
_OUR_KERNELS = {"flash_fwd_kernel": "flash_fwd",
                "paged_chunk_kernel": "paged_decode",
                "paged_combine_kernel": "paged_decode",
                "flash_bwd_dkv_kernel": "flash_bwd_dkv",
                "flash_bwd_dq_kernel": "flash_bwd_dq"}


def _kernel_family(name: str) -> str:
    for kernel, ours in _OUR_KERNELS.items():
        if kernel in name:
            return f"{ours} (ours)"
    if any(t in name for t in ("gemm", "gemv", "xmma", "cutlass", "sm90",
                               "nvjet")):
        return "matmul (cuBLAS)"
    return "other PyTorch kernels"


def profile_device(run, label, out_path):
    """Call ``run()`` once under torch.profiler: device busy time (the
    union of kernel intervals) against the host clock, and the kernels
    by device time.  Writes the table to ``out_path``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kern:
        raise AssertionError("the profiler recorded no device kernel")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    by_name, by_family = {}, {}
    for e in kern:
        t, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], c + 1)
        fam = _kernel_family(e["name"])
        t, c = by_family.get(fam, (0.0, 0))
        by_family[fam] = (t + e["dur"], c + 1)
    idle = 1 - busy / wall_us
    lines = [f"profiled {label}: host wall {wall_us / 1e3:.3f} ms, device "
             f"busy {busy / 1e3:.3f} ms, device idle share {idle:.4f}, "
             f"{len(kern)} kernels"]
    for fam, (t, c) in sorted(by_family.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"  family {fam}: {t / 1e3:.3f} ms in {c} kernels")
    for name, (t, c) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:30]:
        lines.append(f"  {t / 1e3:10.3f} ms {c:7d} x {name[:120]}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:len(by_family) + 1]:
        log(f"[profile] {line}")
    log(f"[profile] kernel table written to {out_path}")
    return idle


def build_lm(dev, config, seed, attention_impl="flash"):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    t0 = time.perf_counter()
    model = TransformerLM(attention_impl=attention_impl, device=dev,
                          **config).build(seed=seed)
    log(f"[model] {config['n_layers']} layers x {config['hidden_size']} "
        f"built from seed {seed} in {time.perf_counter() - t0:.2f} s")
    return model


def make_engine(model, dev, serve, **kw):
    from bigdl_tpu_torch.serving import LMServingEngine
    kw = {"attention_impl": "flash", "decode_attn": "paged_kernel", **kw}
    return LMServingEngine(
        model, slots=serve["slots"], cache_len=serve["cache_len"],
        block_len=serve["block_len"], max_new_tokens=serve["max_new"],
        device=dev, **kw)


def release(dev):
    """Return a closed engine's memory (its graphs and pool) to the card,
    with the cuBLAS workspaces PyTorch keeps for every stream it has seen
    (an engine's graphs capture on a stream of their own), so that each
    phase starts from the bytes the one before it found."""
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()


def serve_once(dev, model, serve, prompts, oracle, label, profile_path=None,
               **engine_kw):
    """One greedy serve run on a fresh engine (warmed, then checked for
    bounded captures), every stream held against offline generate.
    With ``profile_path``, one more run of fresh prompts is traced."""
    import torch
    max_new = serve["max_new"]
    # device bytes held before the engine: the weights and whatever else
    # the run finds resident
    resident = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    engine = make_engine(model, dev, serve, **engine_kw)
    try:
        warm = warm_engine(engine, prompts)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = serve_run(engine, prompts, max_new)
        stats = engine.stats()
        out["graphs"] = check_bounded(label, engine, warm)
        out["idle_share"] = None
        if profile_path:
            more = serve_prompts(serve["seed"] + 1)
            out["idle_share"] = profile_device(
                lambda: serve_run(engine, more, max_new),
                f"{label} run: {len(more)} requests x {max_new} tokens",
                profile_path)
            check_bounded(f"{label} (profiled run)", engine, warm)
    finally:
        engine.close()
        del engine
        release(dev)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    ties = check_streams(label, oracle, prompts, out.pop("results"),
                         max_new)
    hits = stats["kvcache"]["prefix_cache"]["hits"]
    if hits < 1:
        raise AssertionError("the shared-head prompts missed the radix cache")
    out.update(peak_bytes=peak, resident_bytes=resident, ties=ties,
               radix_hits=hits, warm=warm,
               itl_p99_s=stats["metrics"]["itl"]["p99_s"],
               matched_streams=len(prompts) - len(ties),
               prefix_prefill=stats["prefix_prefill_cache"])
    log(f"[{label}] {len(prompts)} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, max_new {max_new}: "
        f"{out['matched_streams']} streams identical to offline generate, "
        f"{len(ties)} ties; radix hits {hits}; {graph_line(out)}")
    return out


def phase_serve(dev, config=GPT2_SMALL, serve=SERVE, prompts=None,
                profile_path=None, oracle=None):
    """Build the model from a seed and serve the prompts greedily, first
    through CUDA graphs (the default), then eagerly (``cuda_graphs=False``)
    on a second engine; check every stream of both.  Returns (graphs
    run, eager run).  With ``profile_path``, one more run of fresh
    prompts is traced on each engine (see profile_device)."""
    model = build_lm(dev, config, serve["seed"])
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    graphs = serve_once(dev, model, serve, prompts, oracle, "serve",
                        profile_path)
    eager_path = None
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        eager_path = f"{root}_eager{ext}"
    eager = serve_once(dev, model, serve, prompts, oracle, "serve eager",
                       eager_path, cuda_graphs=False)
    return graphs, eager


def phase_serve_sampled(dev, config=GPT2_SMALL, serve=SERVE, spec=SPEC,
                        prompts=None, oracle=None):
    """The serve phase's requests sampled at ``spec["temperature"]``,
    request i from the key chain of seed i, through the flash prefill
    and paged decode kernels; every stream held against offline
    generate with the same temperature and seed."""
    model = build_lm(dev, config, serve["seed"])
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    temp, max_new = spec["temperature"], serve["max_new"]
    engine = make_engine(model, dev, serve, temperature=temp)
    try:
        warm = warm_engine(engine, prompts)
        out = serve_run(engine, prompts, max_new, temp)
        out.update(graphs=check_bounded("serve_sampled", engine, warm),
                   warm=warm)
    finally:
        engine.close()
        del engine
        release(dev)
    ties = check_streams("serve_sampled", oracle, prompts,
                         out.pop("results"), max_new, temp)
    out.update(ties=ties, matched_streams=len(prompts) - len(ties),
               draw_ms=host_draw_ms(config["vocab_size"]))
    log(f"[serve_sampled] {len(prompts)} requests at temperature {temp} "
        f"(request i from seed i): {out['matched_streams']} streams "
        f"identical to offline generate, {len(ties)} ties; TTFT p50 "
        f"{out['ttft_p50_s'] * 1e3:.2f} ms, decode "
        f"{out['decode_tokens_per_s']:.1f} tokens/s; launches "
        f"{out['launches']}; one host draw over {config['vocab_size']} "
        f"logits {out['draw_ms']:.3f} ms (host clock, median of 20); "
        f"{graph_line(out)}")
    return out


def host_draw_ms(vocab, n=20):
    """Host milliseconds of one key-chain categorical draw over a (1,
    vocab) logits row, as the engine draws every sampled token."""
    import numpy as np
    from bigdl_tpu_torch.utils import keychain
    row = np.zeros((1, vocab), np.float32)
    keys = keychain.split(keychain.prng_key(0), n)
    times = []
    for key in keys:
        t0 = time.perf_counter()
        keychain.categorical(key, row)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def ngram_prompts(spec=SPEC, vocab=GPT2_SMALL["vocab_size"]):
    """Copy-heavy prompts: a random segment repeated, then its first
    ``ngram_tail`` tokens, so every prompt ends inside the segment and
    its suffix recurs."""
    import numpy as np
    rng = np.random.RandomState(spec["ngram_seed"])
    out = []
    for _ in range(spec["ngram_prompts"]):
        seg = rng.randint(1, vocab + 1, size=spec["ngram_segment"])
        out.append(np.concatenate([seg] * spec["ngram_repeats"]
                                  + [seg[:spec["ngram_tail"]]]))
    return out


def _first_layers(tree, n):
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def phase_spec(dev, config=GPT2_SMALL, serve=SERVE, spec=SPEC, prompts=None,
               oracle=None, profile_path=None):
    """Speculative serving on the served model, four arms (see the
    module docstring).  Returns each run's numbers by arm name."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import SpecConfig

    model = build_lm(dev, config, serve["seed"])
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    temp, max_new, k = spec["temperature"], serve["max_new"], spec["k"]
    full = TransformerLM(attention_impl="flash", device=dev, **config)
    full.params = model.params
    small = TransformerLM(attention_impl="flash", device=dev,
                          **dict(config, n_layers=spec["draft_layers"]))
    small.params = dict(model.params,
                        blocks=_first_layers(model.params["blocks"],
                                             spec["draft_layers"]))
    widest = len(SpecConfig(k=k, draft=small, tree=True).shapes) - 1
    arms = [
        ("linear_full_greedy", SpecConfig(k=k, draft=full), 0.0, prompts,
         True),
        ("linear_2layer_replay", SpecConfig(k=k, draft=small), temp,
         prompts, True),
        # arm 2 once more on the eager path, to measure what capture
        # returns
        ("linear_2layer_replay_eager", SpecConfig(k=k, draft=small), temp,
         prompts, True),
        ("linear_2layer_rejection", SpecConfig(k=k, draft=small,
                                               sampling="rejection"),
         temp, prompts, False),
        ("linear_2layer_rejection_again", SpecConfig(
            k=k, draft=small, sampling="rejection"), temp, prompts, False),
        ("tree_2layer_replay", SpecConfig(
            k=k, draft=small, tree=True, init_rung=widest,
            stepdown_below=spec["tree_stepdown"]), temp, prompts, True),
        ("tree_ngram_replay", SpecConfig(k=k, tree=True,
                                         drafter_compute="ngram"),
         temp, ngram_prompts(spec, config["vocab_size"]), True),
        # random weights sampled at 0.7 emit near-uniform tokens that no
        # context holds; greedy, they repeat, so the drafter's matches
        # (and their acceptance) reach the verify step
        ("tree_ngram_greedy", SpecConfig(k=k, tree=True,
                                         drafter_compute="ngram"),
         0.0, ngram_prompts(spec, config["vocab_size"]), True),
    ]
    runs = {}
    for name, cfg, t, ps, exact in arms:
        eager = name.endswith("_eager")
        engine = make_engine(model, dev, serve, spec=cfg,
                             cuda_graphs=False if eager else None)
        try:
            warm = warm_engine(engine, ps)
            out = serve_run(engine, ps, max_new, t)
            st = engine.stats()["spec"]
            out.update(graphs=check_bounded(f"spec {name}", engine, warm),
                       warm=warm, idle_share=None)
            if profile_path and name.startswith("linear_2layer_replay"):
                root, ext = os.path.splitext(profile_path)
                more = serve_prompts(serve["seed"] + 1)
                out["idle_share"] = profile_device(
                    lambda: serve_run(engine, more, max_new, t),
                    f"spec run {name}: {len(more)} requests x {max_new} "
                    "tokens", f"{root}_spec{'_eager' if eager else ''}{ext}")
                check_bounded(f"spec {name} (profiled run)", engine, warm)
        finally:
            engine.close()
            del engine
            release(dev)
        out["ties"] = (check_streams(f"spec {name}", oracle, ps,
                                     out["results"], max_new, t)
                       if exact else None)
        out["stats"] = st
        widths = cfg.describe().get("tree_widths")
        shape = f"k {k}" + (f", tree widths {widths}" if widths else "")
        log(f"[spec] {name}: {shape}, temperature {t}, sampling "
            f"{cfg.sampling}: verify rounds "
            f"{st['verify_rounds']}, drafter steps {st['draft_steps']}, "
            f"accepted {st['accepted']} of {st['drafted']} drafted "
            f"({st['accepted'] / max(st['verify_rounds'], 1):.3f} a verify "
            f"round), emitted {st['accepted_per_verify_step']:.3f} a verify "
            f"round; TTFT p50 {out['ttft_p50_s'] * 1e3:.2f} ms, decode "
            f"{out['decode_tokens_per_s']:.1f} tokens/s; launches "
            f"{out['launches']}"
            + ("" if not exact else f"; {len(ps) - len(out['ties'])} of "
               f"{len(ps)} streams identical to offline generate")
            + f"; {graph_line(out)}")
        log(f"[spec] {name} stats()['spec']: {json.dumps(st)}")
        runs[name] = out
    a, b = (runs["linear_2layer_rejection"]["results"],
            runs["linear_2layer_rejection_again"]["results"])
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("rejection sampling: two runs of the same "
                             "requests gave different streams")
    share = runs["linear_full_greedy"]["stats"]["acceptance_rate"]
    if not share >= spec["min_accept_full"]:
        raise AssertionError(f"the drafter holding the target's weights had "
                             f"{share} of its drafts accepted, not >= "
                             f"{spec['min_accept_full']}")
    hits = {name: runs[name]["stats"]["draft"]["hit_rate"]
            for name in ("tree_ngram_replay", "tree_ngram_greedy")}
    if not (hits["tree_ngram_greedy"] > 0.0
            and runs["tree_ngram_greedy"]["stats"]["accepted"] > 0):
        raise AssertionError("the greedy n-gram run had no match accepted: "
                             "no n-gram proposal was verified")
    alt_accepts = runs["tree_2layer_replay"]["stats"]["alt_accepts"]
    if not alt_accepts > 0:
        raise AssertionError("the tree arm on its widest rung accepted no "
                             "alternate: the commit copied no row")
    log(f"[spec] rejection sampling: both runs identical; the full drafter's "
        f"accepted share {share:.4f}; tree 2-layer alternates accepted "
        f"{alt_accepts}; n-gram hit rates {hits}")
    for out in runs.values():
        del out["results"]
    return runs


# --------------------------------------------------------------------------- #
def quant_products(dev):
    """The int8 product (``qmatmul_i8``: per-token quantization,
    ``torch._int_mm``, one rescale) against the dequant one (``qmatmul``
    on a dequant-mode QTensor: expand, float32 ``torch.matmul``) at the
    served shapes.  Library calls, timed beside the kernels; the card's
    int32 accumulators must equal the CPU's bitwise.  Returns one row a
    shape."""
    import torch
    from bigdl_tpu_torch.quant import (int_mm, qmatmul, qmatmul_i8,
                                       quantize_array, quantize_per_token)
    g = torch.Generator().manual_seed(0)
    rows = []
    for k, n in QUANT_PRODUCT_KN:
        w = torch.randn(k, n, generator=g) * k ** -0.5
        dq = quantize_array(w, (0,))
        i8 = dq.with_compute("int8")
        dq_dev, i8_dev = dq.to(dev), i8.to(dev)
        for m in QUANT_PRODUCT_ROWS:
            x = torch.randn(m, k, generator=g)
            xq, _ = quantize_per_token(x)
            xq_dev = xq.to(dev)
            acc = int_mm(xq_dev, i8_dev.q)
            if not torch.equal(acc.cpu(), int_mm(xq, i8.q)):
                raise AssertionError(f"int8 product ({m}, {k}) x ({k}, {n}):"
                                     " the card's int32 accumulators differ "
                                     "from the CPU's")
            xd = x.to(dev)
            err = (qmatmul_i8(xd, i8_dev) - qmatmul(xd, dq_dev)).abs().max()
            nbytes = m * k * 4 + k * n + n * 4 + m * n * 4
            flops = 2.0 * m * n * k
            row = dict(m=m, k=k, n=n,
                       i8_ms=cuda_ms(lambda: qmatmul_i8(xd, i8_dev), 50),
                       int_mm_ms=cuda_ms(lambda: int_mm(xq_dev, i8_dev.q), 50),
                       dequant_ms=cuda_ms(lambda: qmatmul(xd, dq_dev), 50),
                       i8_vs_dequant_max_abs=float(err))
            row["i8_bound_ms"], row["i8_bound_by"] = bound(nbytes, flops,
                                                           "int8")
            row["dequant_bound_ms"], row["dequant_bound_by"] = bound(
                nbytes, flops, "float32")
            rows.append(row)
            log(f"[quant] product ({m}, {k}) x ({k}, {n}): qmatmul_i8 "
                f"{row['i8_ms']:.4f} ms (of it torch._int_mm "
                f"{row['int_mm_ms']:.4f}; bound {row['i8_bound_ms']:.4f}, "
                f"{row['i8_bound_by']}), dequant qmatmul "
                f"{row['dequant_ms']:.4f} ms (bound "
                f"{row['dequant_bound_ms']:.4f}, {row['dequant_bound_by']}, "
                f"float32 CUDA cores); accumulators bitwise the CPU's, "
                f"|int8 - dequant| max {row['i8_vs_dequant_max_abs']:.3e}")
    return rows


def first_step_logit_gap(dev, model, prompts, block_len, first_tokens):
    """The first decode step's largest logit difference between int8 and
    float KV: every prompt prefilled once (flash) into a float pool and
    an int8 pool, then one gather decode step over all of them on each,
    the same tokens and positions."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer.generate import (
        _decode_step_paged, _insert_blocks, _prefill_parts)
    from bigdl_tpu_torch.serving.kvcache import BlockPool
    mha = model._mha
    need = [-(-(len(p) + 1) // block_len) for p in prompts]
    width = max(need)
    pools = [BlockPool(n_layers=model.n_layers, n_heads=mha.n_head,
                       head_dim=mha.head_dim, block_len=block_len,
                       num_blocks=1 + sum(need), device=dev, kv_quant=q)
             for q in (None, "int8")]
    tables = np.zeros((len(prompts), width), np.int64)
    nxt = 1
    with torch.no_grad():
        for i, p in enumerate(prompts):
            tables[i, :need[i]] = np.arange(nxt, nxt + need[i])
            nxt += need[i]
            ids0 = torch.as_tensor(p - 1, device=dev)[None]
            _, k, v = _prefill_parts(model, model.params, ids0, len(p) - 1,
                                     attention_impl="flash")
            ids = torch.as_tensor(tables[i, :-(-len(p) // block_len)],
                                  device=dev)
            for pool in pools:
                _insert_blocks(pool.k, pool.v, k, v, ids, pool.ks, pool.vs)
        token = torch.as_tensor(np.asarray(first_tokens) - 1, device=dev)
        pos = torch.as_tensor([len(p) for p in prompts], device=dev)
        tab = torch.as_tensor(tables, device=dev)
        logits = [_decode_step_paged(model, model.params, token, pos, tab,
                                     pool.k, pool.v, pool.ks, pool.vs,
                                     attn_impl="gather")[0]
                  for pool in pools]
    return float((logits[0] - logits[1]).abs().max())


def quant_kv_run(dev, model, serve, prompts, label, **engine_kw):
    """One greedy run of the prompts on a float target with int8 KV
    arenas, warmed and checked for bounded captures; returns the run's
    numbers with its streams."""
    engine = make_engine(model, dev, serve, kv_quant="int8",
                         decode_attn="auto", **engine_kw)
    try:
        warm = warm_engine(engine, prompts)
        if engine.decode_attn != "gather":
            raise AssertionError(f"{label}: kv_quant='int8' decodes through "
                                 f"{engine.decode_attn}, not the gather")
        out = serve_run(engine, prompts, serve["max_new"])
        out.update(graphs=check_bounded(label, engine, warm), warm=warm,
                   arena_bytes=engine.pool.arena_bytes,
                   scale_bytes=engine.pool.scale_arena_bytes,
                   float_arena_bytes=engine.pool.kv_arena_bytes * 4)
    finally:
        engine.close()
        del engine
        release(dev)
    return out


def phase_quant(dev, config=GPT2_SMALL, serve=SERVE, spec=SPEC, prompts=None,
                oracle=None):
    """Int8 quantization on the served model (see the module docstring):
    Q1 the int8 target, Q2 int8 KV arenas, Q3 the default drafter.
    Returns each run's numbers by name."""
    import numpy as np
    from bigdl_tpu_torch.quant import params_nbytes
    from bigdl_tpu_torch.serving import SpecConfig
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    max_new = serve["max_new"]
    runs = {}

    # Q1: the int8 target; the float model goes before the run, so the
    # peak holds the int8 weights where the float serve run held float
    model = build_lm(dev, config, serve["seed"])
    float_bytes = params_nbytes(model.params)
    qmodel = model.quantize("int8")
    del model
    release(dev)
    rep = qmodel.quant_report
    if config == GPT2_SMALL:
        for key, want in QUANT_REPORT_GPT2.items():
            if rep[key] != want:
                raise AssertionError(f"quant_report[{key!r}] {rep[key]}, the "
                                     f"reference's {want}")
    q_oracle = Oracle(dev, config, serve["seed"],
                      make_model=lambda: oracle.model.quantize("int8"))
    q1 = serve_once(dev, qmodel, serve, prompts, q_oracle, "quant Q1")
    q1.update(report={k: rep[k] for k in (
        "bytes_orig", "bytes_quant", "quantized_leaves", "skipped_leaves",
        "payload_ratio", "max_abs_dequant_error", "overflow_risk")},
        weight_bytes=params_nbytes(qmodel.params),
        float_weight_bytes=float_bytes)
    log(f"[quant] Q1 int8 target: quant_report {json.dumps(q1['report'])}")
    runs["q1_int8_target"] = q1
    del qmodel, q_oracle
    release(dev)

    # Q2: the float target on int8 KV arenas, graphs on and off
    model = build_lm(dev, config, serve["seed"])
    q2 = quant_kv_run(dev, model, serve, prompts, "quant Q2")
    q2e = quant_kv_run(dev, model, serve, prompts, "quant Q2 eager",
                       cuda_graphs=False)
    if not all(np.array_equal(a, b)
               for a, b in zip(q2["results"], q2e["results"])):
        raise AssertionError("quant Q2: int8-KV streams with CUDA graphs "
                             "differ from the eager engine's")
    same = total = 0
    for p, r in zip(prompts, q2["results"]):
        want = oracle.stream(p, max_new)
        same += int(np.sum(r[len(p):] == want[len(p):]))
        total += max_new
    q2["float_token_share"] = same / total
    q2["first_step_logit_gap"] = first_step_logit_gap(
        dev, model, prompts, serve["block_len"],
        [oracle.stream(p, max_new)[len(p)] for p in prompts])
    log(f"[quant] Q2 int8 KV: arenas {q2['arena_bytes']} bytes "
        f"({q2['scale_bytes']} of them scales) vs a float pool's {q2['float_arena_bytes']} "
        f"({q2['arena_bytes'] / q2['float_arena_bytes']:.4f}x); graphs on "
        f"and off: every stream bitwise equal; tokens equal to the float "
        f"streams {same}/{total} ({q2['float_token_share']:.4f}); first "
        f"decode step's largest |logit difference| from float KV "
        f"{q2['first_step_logit_gap']:.4e}; {graph_line(q2)}")
    runs["q2_int8_kv"], runs["q2_int8_kv_eager"] = q2, q2e

    # Q3: the default drafter, dequant (spec=k) and int8 compute
    k = spec["k"]
    arms = [("q3_dequant_greedy", k, 0.0),
            ("q3_dequant_sampled", k, spec["temperature"]),
            ("q3_int8_greedy", SpecConfig(k=k, drafter_compute="int8"), 0.0),
            ("q3_int8_sampled", SpecConfig(k=k, drafter_compute="int8"),
             spec["temperature"])]
    for name, cfg, t in arms:
        engine = make_engine(model, dev, serve, spec=cfg)
        try:
            warm = warm_engine(engine, prompts)
            out = serve_run(engine, prompts, max_new, t)
            st = engine.stats()["spec"]
            out.update(graphs=check_bounded(f"quant {name}", engine, warm),
                       warm=warm, stats=st)
        finally:
            engine.close()
            del engine
            release(dev)
        out["ties"] = check_streams(f"quant {name}", oracle, prompts,
                                    out["results"], max_new, t)
        desc = (f"spec={cfg}" if isinstance(cfg, int) else
                 f"SpecConfig(k={cfg.k}, drafter_compute="
                 f"{cfg.drafter_compute!r})")
        log(f"[quant] {name}: {desc}, temperature {t}: drafter {st['draft']['dtype_tag']}, compute "
            f"{st['compute_mode']}, overflow_risk {st['overflow_risk']:.5f}; "
            f"accepted {st['accepted']} of {st['drafted']} drafted (share "
            f"{st['acceptance_rate']}), verify rounds {st['verify_rounds']}, "
            f"demotions {st['demotions']}; TTFT p50 "
            f"{out['ttft_p50_s'] * 1e3:.2f} ms, decode "
            f"{out['decode_tokens_per_s']:.1f} tokens/s; launches "
            f"{out['launches']}; {len(prompts) - len(out['ties'])} of "
            f"{len(prompts)} streams identical to offline generate; "
            f"{graph_line(out)}")
        runs[name] = out
    for name in ("q3_int8_greedy", "q3_int8_sampled"):
        st = runs[name]["stats"]
        if st["compute_mode"] != "int8" or not 0.0 <= st["overflow_risk"] < 1:
            raise AssertionError(f"quant {name}: drafter compute "
                                 f"{st['compute_mode']}, overflow risk "
                                 f"{st['overflow_risk']}")
    for out in runs.values():
        out.pop("results", None)
    return runs


# --------------------------------------------------------------------------- #
class _PathLaunches:
    """The kernels' launch counters summed over a path's runs, each run
    counted from 0 (warmups and checks outside ``run`` do not count)."""

    def __init__(self):
        self.total = {}
        self.last = {}

    def run(self, fn):
        _reset_launches()
        out = fn()
        self.last = _launches()
        for symbol, n in self.last.items():
            self.total[symbol] = self.total.get(symbol, 0) + n
        return out


def _spans(tracer, name, **match):
    """The tracer's complete events called ``name`` whose args hold
    ``match``."""
    return [e for e in tracer.events()
            if e.get("ph") == "X" and e.get("name") == name
            and all(e.get("args", {}).get(k) == v for k, v in match.items())]


def tier_store(name, **kw):
    from bigdl_tpu_torch.serving.kvtier import HostBlockStore
    kw.setdefault("host_bytes", 1 << 30)
    return HostBlockStore(name=name, **kw)


def hibernate_run(engine, prompts, max_new, temperature, at, between=None):
    """Submit every prompt (request i from seed i), hibernate each stream
    after its ``at``-th token from a thread of its own, call
    ``between(streams)`` once all are hibernated, resume them all and
    wait; the arena addresses must hold after the hibernations and after
    the resumes.  Returns the results, each session's hibernated blocks
    and the tier's byte counters moved by the run."""
    import threading
    tier = engine.kvtier
    ptrs = engine.cache_buffer_pointers()
    demoted0 = tier.demoted_bytes.get()[0]
    promoted0 = tier.promoted_bytes.get()[0]
    streams = [engine.submit(p, max_new_tokens=max_new,
                             temperature=temperature, rng=i)
               for i, p in enumerate(prompts)]
    swapped = [None] * len(streams)

    def hold(i):
        it = streams[i].tokens(timeout=600)
        for _ in range(at):
            next(it)
        swapped[i] = engine.hibernate(streams[i], timeout=600)

    threads = [threading.Thread(target=hold, args=(i,))
               for i in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not all(swapped):
        raise AssertionError(f"hibernate refused for streams "
                             f"{[i for i, ok in enumerate(swapped) if not ok]}"
                             f" (finished before their {at}th token?)")
    with engine._cv:
        n_used = [engine._hibernated[s.request_id].n_used for s in streams]
        paused = [len(s.generated) for s in streams]
    if engine.cache_buffer_pointers() != ptrs:
        raise AssertionError("hibernation moved an arena")
    if between is not None:
        between(streams)
    for s in streams:
        if not engine.resume(s):
            raise AssertionError("resume refused for a hibernated stream")
    results = [s.result(timeout=600) for s in streams]
    if engine.cache_buffer_pointers() != ptrs:
        raise AssertionError("a resume moved an arena")
    return dict(results=results, n_used=n_used, paused_at=paused,
                demoted_bytes=tier.demoted_bytes.get()[0] - demoted0,
                promoted_bytes=tier.promoted_bytes.get()[0] - promoted0)


def phase_tier(dev, config=GPT2_SMALL, serve=SERVE, spec=SPEC, prompts=None,
               oracle=None, tier=TIER):
    """The request lifecycle and the host KV tier on the served model
    (see the module docstring): T1 lifecycle, T2 hibernate and resume
    (greedy and sampled), T3 lost payloads (a tier too small to keep a
    session; a corrupted spill file), T4 int8 KV, T5 radix demote and
    promote, T6 fault sites and the registry.  Every arena address is
    held across every tier move and no engine captures after warmup.
    Returns the phase's numbers and its launches."""
    import tempfile

    import numpy as np
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.obs import get_registry, get_tracer
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import (ServingDeadlineExceeded,
                                         ServingOverloaded, SpecConfig)
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    max_new, at = serve["max_new"], tier["hibernate_at"]
    temp = spec["temperature"]
    model = build_lm(dev, config, serve["seed"])
    tracer = get_tracer()
    acc = _PathLaunches()
    out = {}

    def open_engine(label, prompts_warm, **kw):
        engine = make_engine(model, dev, serve, **kw)
        warm = warm_engine(engine, prompts_warm)
        return engine, warm, engine.cache_buffer_pointers()

    def close_engine(label, engine, warm, ptrs):
        """Check and close; the caller drops its reference and calls
        ``release`` so the next engine starts from the same bytes."""
        try:
            if engine.cache_buffer_pointers() != ptrs:
                raise AssertionError(f"{label}: arena addresses moved")
            return check_bounded(label, engine, warm)
        finally:
            engine.close()

    def exact(label, results, want, temperature, ps=prompts, new=max_new):
        """Bitwise equal to ``want`` (the same engine kind's
        uninterrupted streams) and to offline generate (ties as
        Oracle.check defines them)."""
        for i, (p, r) in enumerate(zip(ps, results)):
            if want is not None and not np.array_equal(r, want[i]):
                raise AssertionError(f"{label}: stream {i} differs from the "
                                     "uninterrupted run")
        return check_streams(label, oracle, ps, results, new, temperature)

    # -- T1: deadlines, cancel, the queued shed ----------------------- #
    engine, warm, ptrs = open_engine("tier T1", prompts)
    t1_capacity = engine.pool.capacity
    try:

        def t1():
            import threading
            streams = [engine.submit(p, max_new_tokens=max_new,
                                     deadline_s=60.0 if i == 0 else None)
                       for i, p in enumerate(prompts)]
            try:
                engine.submit(prompts[0], max_new_tokens=max_new,
                              deadline_s=0.0)
                raise AssertionError("deadline_s=0 was not shed at enqueue")
            except ServingDeadlineExceeded:
                pass
            queued = engine.submit(prompts[2], max_new_tokens=max_new,
                                   deadline_s=tier["queued_deadline_s"])

            def cancel_after():
                it = streams[1].tokens(timeout=600)
                for _ in range(tier["cancel_at"]):
                    next(it)
                streams[1].cancel()

            th = threading.Thread(target=cancel_after)
            th.start()
            th.join()
            results = [s.result(timeout=600) for s in streams]
            try:
                queued.result(timeout=600)
                raise AssertionError("the queued request outlived its "
                                     "deadline")
            except ServingDeadlineExceeded:
                pass
            return streams, results

        streams, results = acc.run(t1)
        cut = streams[1].truncation
        if cut is None or cut.reason != "cancelled":
            raise AssertionError(f"tier T1: the cancelled stream finished "
                                 f"with truncation {cut}")
        full = oracle.stream(prompts[1], max_new)
        if not np.array_equal(results[1], full[:len(results[1])]) or \
                cut.at_tokens < tier["cancel_at"]:
            raise AssertionError("tier T1: the cancelled stream is not a "
                                 "prefix of offline generate's")
        whole = [r for i, r in enumerate(results) if i != 1]
        ties = exact("tier T1", whole, None, 0.0,
                     ps=[p for i, p in enumerate(prompts) if i != 1])
        if streams[0].truncation is not None:
            raise AssertionError("tier T1: the 60 s stream was truncated")
        lc = engine.lifecycle_stats()
        want_lc = dict(expired_preadmission=2, expired_midstream=0,
                       cancelled=1)
        if any(lc[k] != v for k, v in want_lc.items()):
            raise AssertionError(f"tier T1: lifecycle_stats {lc}, wanted "
                                 f"{want_lc}")
        deadline = time.perf_counter() + 60
        while engine.stats()["active"] and time.perf_counter() < deadline:
            time.sleep(0.01)
        free, held = engine.pool.free_count, engine.radix.stats()["nodes"]
        if free + held != t1_capacity:
            raise AssertionError(f"tier T1: {free} free + {held} trie "
                                 f"blocks != capacity {t1_capacity}")
    finally:
        t1_graphs = close_engine("tier T1", engine, warm, ptrs)
    del engine
    release(dev)
    out["t1"] = dict(lifecycle=lc, cancelled_at=cut.at_tokens,
                     ties=len(ties))
    log(f"[tier] T1 lifecycle: {len(prompts)} requests (one at deadline_s "
        f"60, one cancelled after its {tier['cancel_at']}th token: "
        f"truncated at {cut.at_tokens}, a prefix of offline generate's), "
        f"deadline_s=0 shed at enqueue, one queued behind the full engine "
        f"at deadline_s={tier['queued_deadline_s']} shed typed; "
        f"lifecycle_stats {json.dumps(lc)}; {len(prompts) - 1 - len(ties)} "
        f"of {len(prompts) - 1} whole streams identical to offline "
        f"generate; free + trie blocks == capacity {t1_capacity}; "
        f"{t1_graphs['captures']} captures, none after warmup")

    # -- T2: hibernate and resume, greedy then sampled ---------------- #
    tier_kw = dict(enable_prefix_cache=False)
    engine, warm, ptrs = open_engine(
        "tier T2", prompts, kvtier=tier_store("smoke-t2"), **tier_kw)
    wire = 2 * engine.pool.wire_block_bytes
    if config == GPT2_SMALL and wire != tier["wire_block_bytes"]:
        raise AssertionError(f"one block's wire payload is {wire} bytes, "
                             f"not {tier['wire_block_bytes']}")
    uninterrupted = {}
    try:
        for label, t in (("greedy", 0.0), ("sampled", temp)):
            uninterrupted[label] = acc.run(
                lambda: serve_run(engine, prompts, max_new, t))["results"]
            tracer.clear()
            tracer.enable()
            try:
                run = acc.run(lambda: hibernate_run(engine, prompts, max_new,
                                                    t, at))
            finally:
                tracer.disable()
            hib_ms = [e["dur"] / 1e3 for e in _spans(tracer,
                                                     "kvtier/hibernate")]
            res_ms = [e["dur"] / 1e3 for e in _spans(tracer, "kvtier/promote",
                                                     session=1)]
            blocks = sum(run["n_used"])
            for key in ("demoted_bytes", "promoted_bytes"):
                if run[key] != blocks * wire:
                    raise AssertionError(f"tier T2 {label}: {key} "
                                         f"{run[key]}, not {blocks} blocks x "
                                         f"{wire}")
            if len(hib_ms) != len(prompts) or len(res_ms) != len(prompts):
                raise AssertionError(f"tier T2 {label}: {len(hib_ms)} "
                                     f"hibernate and {len(res_ms)} resume "
                                     "spans")
            ties = exact(f"tier T2 {label}", run["results"],
                         uninterrupted[label], t)
            bw = engine.kvtier.promote_bandwidth_mbs()
            out[f"t2_{label}"] = dict(
                blocks=blocks, bytes=blocks * wire, paused_at=run["paused_at"],
                hibernate_ms=hib_ms, resume_ms=res_ms,
                promote_bandwidth_mbs=bw, ties=len(ties))
            log(f"[tier] T2 {label}: {len(prompts)} sessions hibernated "
                f"after {run['paused_at']} tokens and resumed; blocks "
                f"{run['n_used']} = {blocks}, {blocks * wire} bytes each way "
                f"({wire} a block); hibernate ms {_ms_list(hib_ms)} (median "
                f"{float(np.median(hib_ms)):.3f}), resume ms "
                f"{_ms_list(res_ms)} (median {float(np.median(res_ms)):.3f}); "
                f"promote_bandwidth_mbs {bw:.1f}; every stream bitwise equal "
                f"to the uninterrupted run, {len(prompts) - len(ties)} of "
                f"{len(prompts)} identical to offline generate")
        if engine.resume_re_prefills:
            raise AssertionError("tier T2: a payload was lost")
    finally:
        t2_graphs = close_engine("tier T2", engine, warm, ptrs)
    del engine
    release(dev)
    log(f"[tier] T2 arena addresses unchanged over {2 * len(prompts)} "
        f"hibernations and resumes; {t2_graphs['captures']} captures, none "
        f"after warmup, {t2_graphs['replays']} replays")

    # -- T3: lost payloads -------------------------------------------- #
    engine, warm, ptrs = open_engine(
        "tier T3 small", prompts,
        kvtier=tier_store("smoke-t3", host_bytes=wire // 2), **tier_kw)
    try:
        run = acc.run(lambda: hibernate_run(engine, prompts, max_new, 0.0, at))
        exact("tier T3 small", run["results"], uninterrupted["greedy"], 0.0)
        small = dict(resume_re_prefills=engine.resume_re_prefills,
                     tier=engine.kvtier.stats())
        if engine.resume_re_prefills != len(prompts):
            raise AssertionError(f"tier T3: {engine.resume_re_prefills} "
                                 f"re-prefills, not {len(prompts)}")
    finally:
        close_engine("tier T3 small", engine, warm, ptrs)
    del engine
    release(dev)
    log(f"[tier] T3 a tier of {wire // 2} bytes with no spill directory: "
        f"every session dropped ({small['tier']['drops']:.0f} drops), "
        f"resume_re_prefills {small['resume_re_prefills']}, every stream "
        "bitwise equal to the uninterrupted run")
    with tempfile.TemporaryDirectory() as spill:
        engine, warm, ptrs = open_engine(
            "tier T3 spill", prompts,
            kvtier=tier_store("smoke-t3-spill", host_bytes=1,
                              spill_dir=spill, disk_bytes=1 << 30),
            **tier_kw)

        def corrupt(streams):
            entry = engine.kvtier._entries[("session",
                                            streams[0].request_id)]
            if entry.where != "disk":
                raise AssertionError("tier T3: session 0 is not on disk")
            with open(entry.path, "wb") as f:
                f.write(b"not a kv block")

        try:
            run = acc.run(lambda: hibernate_run(engine, prompts, max_new,
                                                0.0, at, between=corrupt))
            exact("tier T3 spill", run["results"], uninterrupted["greedy"],
                  0.0)
            spilled = engine.kvtier.stats()
            spilled["resume_re_prefills"] = engine.resume_re_prefills
            if (spilled["corrupt_reads"] != 1
                    or engine.resume_re_prefills != 1
                    or spilled["spills"] != len(prompts)):
                raise AssertionError(f"tier T3 spill: {spilled}")
        finally:
            close_engine("tier T3 spill", engine, warm, ptrs)
        del engine
        release(dev)
    out["t3"] = dict(small=small, spill=spilled)
    log(f"[tier] T3 spill to disk: {spilled['spills']:.0f} sessions spilled, "
        f"one file corrupted: corrupt_reads {spilled['corrupt_reads']:.0f}, "
        f"resume_re_prefills {spilled['resume_re_prefills']}, every stream "
        "bitwise equal to the uninterrupted run")

    # -- T4: int8 KV --------------------------------------------------- #
    engine, warm, ptrs = open_engine(
        "tier T4", prompts, kvtier=tier_store("smoke-t4"), kv_quant="int8",
        decode_attn="auto", **tier_kw)
    try:
        wire8 = 2 * engine.pool.wire_block_bytes
        if config == GPT2_SMALL and wire8 != tier["wire_block_bytes_int8"]:
            raise AssertionError(f"an int8 block's wire payload is {wire8} "
                                 f"bytes, not {tier['wire_block_bytes_int8']}")
        want = acc.run(lambda: serve_run(engine, prompts, max_new))["results"]
        run = acc.run(lambda: hibernate_run(engine, prompts, max_new, 0.0,
                                            at))
        blocks = sum(run["n_used"])
        if run["demoted_bytes"] != blocks * wire8 or \
                run["promoted_bytes"] != blocks * wire8:
            raise AssertionError(f"tier T4: bytes {run['demoted_bytes']} / "
                                 f"{run['promoted_bytes']}, not {blocks} x "
                                 f"{wire8}")
        for i, (a, b) in enumerate(zip(run["results"], want)):
            if not np.array_equal(a, b):
                raise AssertionError(f"tier T4: int8 stream {i} differs "
                                     "from the uninterrupted int8 run")
    finally:
        t4_graphs = close_engine("tier T4", engine, warm, ptrs)
    del engine
    release(dev)
    out["t4"] = dict(blocks=blocks, bytes=blocks * wire8, wire_block=wire8,
                     ratio=wire8 / wire)
    log(f"[tier] T4 int8 KV: {blocks} blocks, {blocks * wire8} bytes each way "
        f"({wire8} a block, {wire8 / wire:.4f}x float's), scale arenas "
        f"moved with their rows; every stream bitwise equal to the same "
        f"engine's uninterrupted run; arena and scale addresses unchanged; "
        f"{t4_graphs['captures']} captures, none after warmup")

    # -- T5: radix demote and promote --------------------------------- #
    bl = serve["block_len"]
    a_p, b_p, f_p = prompts[3], prompts[4], prompts[1]
    head_blocks = serve["shared_head"] // bl

    def need(n):
        return -(-n // bl)

    capacity = max(need(len(a_p) + max_new),
                   need(len(b_p) + max_new) + len(f_p) // bl)
    f_new = capacity * bl - len(f_p)
    engine, warm, ptrs = open_engine(
        "tier T5", [a_p, f_p, b_p], kvtier=tier_store("smoke-t5"),
        num_blocks=1 + capacity)
    try:
        saved0 = engine.radix.matched_tokens
        tracer.clear()
        tracer.enable()
        try:
            a_out = acc.run(lambda: engine.generate(
                a_p, max_new_tokens=max_new, timeout=600))
            f_out = acc.run(lambda: engine.generate(
                f_p, max_new_tokens=f_new, timeout=600))
            b_streams = []

            def b_run():
                # submit and result in one counted run: the worker
                # promotes and prefills while the caller waits
                b_streams.append(engine.submit(b_p, max_new_tokens=max_new))
                return b_streams[0].result(timeout=600)

            b_out = acc.run(b_run)
        finally:
            tracer.disable()
        ts = engine.kvtier.stats()
        promoted = engine.kvtier.promoted_bytes.get()[0]
        prefills = _spans(tracer, "lm/prefill", request_id=b_streams[0].request_id)
        starts = [e["args"]["prefix_len"] for e in prefills]
        saved = engine.radix.matched_tokens - saved0
        if (ts["demotions"] < head_blocks or ts["hits"] < head_blocks
                or promoted != head_blocks * wire
                or starts[:1] != [head_blocks * bl]
                or saved != head_blocks * bl):
            raise AssertionError(f"tier T5: tier {ts}, promoted bytes "
                                 f"{promoted}, B's prefills start at "
                                 f"{starts}, tokens saved {saved}")
        ties = check_streams("tier T5", oracle, [a_p, b_p], [a_out, b_out],
                             max_new)
        ties += check_streams("tier T5", oracle, [f_p], [f_out], f_new)
    finally:
        t5_graphs = close_engine("tier T5", engine, warm, ptrs)
    del engine
    release(dev)
    out["t5"] = dict(tier=ts, pool_blocks=capacity, filler_new=f_new,
                     b_prefill_starts=starts, ties=len(ties))
    log(f"[tier] T5 demote/promote: pool of {capacity} blocks; the "
        f"{len(a_p)}-token prompt, then the {len(f_p)}-token one with "
        f"max_new {f_new} (evicts and demotes the first's "
        f"{len(a_p) // bl} blocks), then the {len(b_p)}-token prompt "
        f"sharing its {serve['shared_head']}-token head: demotions "
        f"{ts['demotions']:.0f}, hits {ts['hits']:.0f}, promotions "
        f"{ts['promotions']:.0f} ({promoted:.0f} bytes = {head_blocks} "
        f"blocks), its prefill starts at {starts}; streams identical to "
        f"offline generate: {3 - len(ties)} of 3; {t5_graphs['captures']} "
        "captures, none after warmup")

    # -- T6: fault sites and the registry ----------------------------- #
    small_lm = TransformerLM(attention_impl="flash", device=dev,
                             **dict(config, n_layers=spec["draft_layers"]))
    small_lm.params = dict(model.params, blocks=_first_layers(
        model.params["blocks"], spec["draft_layers"]))
    env = {faults.ENV_SPEC: "serving.verify:transient:p=0.5",
           faults.ENV_SEED: "0"}
    engine, warm, ptrs = open_engine(
        "tier T6", prompts, spec=SpecConfig(k=spec["k"], draft=small_lm))
    try:
        os.environ.update(env)
        faults.refresh_from_env()
        try:
            run = acc.run(lambda: serve_run(engine, prompts, max_new, temp))
            fired = faults.active().stats()
        finally:
            for key in env:
                os.environ.pop(key, None)
            faults.refresh_from_env()
        st = engine.stats()["spec"]
        if not st["fault_demotions"] > 0:
            raise AssertionError("tier T6: no verify fault demoted a slot")
        ties = exact("tier T6", run["results"], None, temp)
        os.environ[faults.ENV_SPEC] = "serving.enqueue:transient:count=1"
        faults.refresh_from_env()
        try:
            engine.submit(prompts[0], max_new_tokens=max_new)
            raise AssertionError("tier T6: an injected serving.enqueue "
                                 "transient did not shed")
        except ServingOverloaded:
            pass
        finally:
            os.environ.pop(faults.ENV_SPEC, None)
            faults.refresh_from_env()
    finally:
        close_engine("tier T6", engine, warm, ptrs)
    del engine, small_lm
    release(dev)
    snap = get_registry().snapshot()
    by_prefix = {p: sorted(k for k in snap if k.startswith(p))
                 for p in ("serving/lm/", "serving/lm/spec/", "kvcache/",
                           "kvtier/", "quant/", "serving/lifecycle/",
                           "resilience/")}
    missing = [p for p, keys in by_prefix.items() if not keys]
    if missing:
        raise AssertionError(f"tier T6: no registry key under {missing}")
    out["t6"] = dict(fault_demotions=st["fault_demotions"],
                     reprobes=st["reprobes"], fired=fired, ties=len(ties),
                     registry={p: len(k) for p, k in by_prefix.items()})
    log(f"[tier] T6 serving.verify transient p 0.5 seed 0 on spec arm 2: "
        f"fired {json.dumps(fired)}, fault_demotions "
        f"{st['fault_demotions']}, reprobes {st['reprobes']}, "
        f"{len(prompts) - len(ties)} of {len(prompts)} streams identical to "
        f"offline generate; serving.enqueue transient -> ServingOverloaded")
    for p, keys in by_prefix.items():
        log(f"[tier] T6 registry {p}: {len(keys)} keys "
            f"{', '.join(k[len(p):] for k in keys[:12])}"
            + (" ..." if len(keys) > 12 else ""))
    del model
    release(dev)
    out["launches"] = acc.total
    return out


# --------------------------------------------------------------------------- #
def engine_passes(engine):
    """Prefill passes an engine ran: every call of its two prefill caches
    (warmup counts neither hits nor misses)."""
    st = engine.stats()
    return sum(st[c]["hits"] + st[c]["misses"]
               for c in ("prefill_cache", "prefix_prefill_cache"))


def chunk_pairs(prompts, cap, block_len):
    """The (chunk length, prefix blocks) pairs a chunk cap makes: every
    chunk after the first runs the suffix prefill, with the prompt cold
    or with the radix head it shares with another prompt."""
    heads = {0}
    for _, m in zip(*radix_pairs(prompts, block_len)):
        heads.add(m)
    pairs = set()
    for p in prompts:
        for m in heads:
            if m * block_len >= len(p):
                continue
            pos = m * block_len
            while pos < len(p):
                ts = min(len(p) - pos, cap)
                if pos:
                    pairs.add((ts, pos // block_len))
                pos += ts
    return sorted(pairs)


def shared_heads(prompts, block_len):
    """Every (suffix, prefix blocks) pair a replica can meet when any
    subset of ``prompts`` (each prompt itself included, for a repeat)
    was admitted before: each prompt against each whole-block head it
    shares with any of them, at most ``(len - 1) // block_len``."""
    import numpy as np
    B = block_len
    pairs = set()
    for p in prompts:
        for q in prompts:
            n, cap = 0, min((len(p) - 1) // B, len(q) // B)
            while n < cap and np.array_equal(p[n * B:(n + 1) * B],
                                             q[n * B:(n + 1) * B]):
                n += 1
            if n:
                pairs.add((len(p) - n * B, n))
    return sorted(pairs)


def warm_pairs(engine, pairs):
    """``warmup()`` plus one ``warmup_prefix()`` a (suffix, prefix
    blocks) pair; returns the graph counters with the warm seconds."""
    import torch
    t0 = time.perf_counter()
    engine.warmup()
    for s, m in pairs:
        engine.warmup_prefix(suffix_lens=[s], prefix_blocks=[m])
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(engine.graphs.stats(), warm_s=time.perf_counter() - t0,
                pool_bytes=engine.graphs.pool_bytes())


def allocated_mib(dev):
    import torch
    return (torch.cuda.memory_allocated() / 2**20 if dev.type == "cuda"
            else 0.0)


def check_replica(run, engine, warm, ptrs, params_ptr):
    """A replica after its traffic: bounded captures, none since warmup
    (a prefill replica has no decode graph), the arenas where the graphs
    captured them, and the model's parameter tensors shared, not
    copied."""
    if engine.migrate is not None:
        if engine._decode_exec.compiles != 0:
            raise AssertionError(f"{run}: a prefill replica made a decode "
                                 "graph")
        graphs = engine.stats()["cuda_graphs"]
        if graphs["captures"] != warm["captures"]:
            raise AssertionError(f"{run}: {engine.name} captured after "
                                 "warmup")
    else:
        graphs = check_bounded(f"{run} {engine.name}", engine, warm)
    if engine.cache_buffer_pointers() != ptrs:
        raise AssertionError(f"{run}: {engine.name}'s arenas moved")
    if engine._params["embed"].data_ptr() != params_ptr:
        raise AssertionError(f"{run}: {engine.name} copied the params")
    return graphs


def phase_replicas(dev, config=GPT2_SMALL, serve=SERVE, spec=SPEC,
                   prompts=None, oracle=None, replicas=REPLICAS,
                   colocated=None):
    """Serving across replicas on one card (see the module docstring):
    P1 chunked prefill, D1 disaggregation greedy and at 0.7, D2 lost
    payloads, then one routed replica set for R1 routing, R3 hedging and
    R2 failover.  Every stream is held against offline generate, every
    replica against bounded captures (none after warmup) and fixed arena
    addresses.  ``colocated`` is the greedy serve run's numbers, printed
    beside D1's.  Returns the phase's numbers and its launches."""
    import os
    import statistics

    import numpy as np
    from bigdl_tpu_torch.obs import get_tracer
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.resilience.replicaset import HedgePolicy
    from bigdl_tpu_torch.serving import DisaggCoordinator
    from bigdl_tpu_torch.serving.router import LMReplicaSet, RadixRouter
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    max_new, B, temp = serve["max_new"], serve["block_len"], spec["temperature"]
    n_layers = config["n_layers"]
    model = build_lm(dev, config, serve["seed"])
    params_ptr = model.params["embed"].data_ptr()
    tracer = get_tracer()
    cuda = dev.type == "cuda"
    eng_kw = dict(slots=serve["slots"], cache_len=serve["cache_len"],
                  block_len=B, max_new_tokens=max_new, device=dev,
                  attention_impl="flash", decode_attn="paged_kernel")
    prompt_blocks = sum(-(-len(p) // B) for p in prompts)
    acc = _PathLaunches()
    out = {}

    def sub_run(label, fn):
        """``fn()`` with the launches counted from 0 and the allocated
        MiB around it, both printed."""
        before = allocated_mib(dev)
        res = acc.run(fn)
        launches = dict(acc.last)
        log(f"[replicas] {label}: launches {launches}, allocated "
            f"{before:.1f} -> {allocated_mib(dev):.1f} MiB")
        return res, launches

    # -- P1: chunked prefill ------------------------------------------ #
    cap = replicas["chunk_cap"]
    engine = make_engine(model, dev, serve, max_prefill_chunk_tokens=cap)
    try:
        warm = warm_pairs(engine, chunk_pairs(prompts, cap, B))
        ptrs = engine.cache_buffer_pointers()
        run, launches = sub_run("P1", lambda: serve_run(engine, prompts,
                                                        max_new))
        passes = engine_passes(engine)
        st = engine.stats()
        graphs = check_replica("P1", engine, warm, ptrs, params_ptr)
    finally:
        engine.close()
    del engine
    release(dev)
    ties = check_streams("replicas P1", oracle, prompts, run["results"],
                         max_new)
    want = sum(-(-len(p) // cap) for p in prompts)
    if passes != want or (config == GPT2_SMALL
                          and passes != replicas["prefill_passes"]):
        raise AssertionError(f"replicas P1: {passes} prefill passes, not "
                             f"{want}")
    gaps = st["metrics"]["itl_prefill_gap"]["count"]
    if gaps <= 0:
        raise AssertionError("replicas P1: no decode gap was interrupted "
                             "by a prefill chunk")
    if cuda:
        check_launches("replicas P1", launches,
                       ("bigdl_flash_fwd", "bigdl_paged_decode"))
    itl = st["metrics"]["itl"]
    out["p1"] = dict(passes=passes, itl_prefill_gaps=gaps,
                     itl_p99_s=itl["p99_s"], ties=len(ties),
                     ttft_p50_s=run["ttft_p50_s"],
                     decode_tokens_per_s=run["decode_tokens_per_s"])
    log(f"[replicas] P1 max_prefill_chunk_tokens {cap}: {passes} prefill "
        f"passes, itl_prefill_gap count {gaps}, ITL p99 "
        f"{itl['p99_s'] * 1e3:.3f} ms (histogram bucket edge) with the cap"
        + (f", {colocated['itl_p99_s'] * 1e3:.3f} ms without (serve)"
           if colocated else "")
        + f"; TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} ms, decode "
        f"{run['decode_tokens_per_s']:.1f} tokens/s; "
        f"{len(prompts) - len(ties)} of {len(prompts)} streams identical to "
        f"offline generate; {graphs['captures']} captures, none after warmup")

    # -- D1 / D2: disaggregation -------------------------------------- #
    d_pairs = shared_heads(prompts, B)

    def disagg(label, temperature, fault=None):
        co = DisaggCoordinator(model, name=f"replicas-{label}", **eng_kw)
        try:
            engines = co.prefill + co.decode
            co.warmup()
            warm = {e.name: warm_pairs(e, d_pairs) for e in engines}
            ptrs = {e.name: e.cache_buffer_pointers() for e in engines}
            before = {e.name: e.kernel_launches() for e in engines}
            passes0 = {e.name: engine_passes(e) for e in engines}
            tracer.clear()
            tracer.enable()
            env = ({faults.ENV_SPEC: fault, faults.ENV_SEED: "3"}
                   if fault else {})
            os.environ.update(env)
            faults.refresh_from_env()
            try:
                run, launches = sub_run(label, lambda: serve_run(
                    co, prompts, max_new, temperature))
            finally:
                for key in env:
                    os.environ.pop(key, None)
                faults.refresh_from_env()
                tracer.disable()
            st = co.stats()
            own = {e.name: {k: v - before[e.name][k]
                            for k, v in e.kernel_launches().items()}
                   for e in engines}
            passes = {e.name: engine_passes(e) - passes0[e.name]
                      for e in engines}
            plain = {e.name: e.stats()["prefill_cache"] for e in engines}
            radix = co.decode[0].radix.stats()
            for e in engines:
                check_replica(label, e, warm[e.name], ptrs[e.name],
                              params_ptr)
        finally:
            co.close()
        migrate_ms = [e["dur"] / 1e3 for e in _spans(tracer, "lm/migrate")]
        h2d = sum(e.get("args", {}).get("bytes", 0)
                  for e in _spans(tracer, "h2d/chunk"))
        return dict(run=run, launches=launches, stats=st, own=own,
                    passes=passes, plain=plain, radix=radix,
                    migrate_ms=migrate_ms, h2d_bytes=h2d)

    wire = None
    d1 = {}
    for label, t in (("D1 greedy", 0.0), ("D1 sampled", temp)):
        r = disagg(label, t)
        release(dev)    # the coordinator's engines, now garbage
        st, run = r["stats"], r["run"]
        pre, dec = st["engines"]
        ties = check_streams(f"replicas {label}", oracle, prompts,
                             run["results"], max_new, t)
        if (st["migrations"], st["adopted"], st["lost_payloads"]) != (
                len(prompts), len(prompts), 0):
            raise AssertionError(f"replicas {label}: migrations "
                                 f"{st['migrations']}, adopted "
                                 f"{st['adopted']}, lost "
                                 f"{st['lost_payloads']}")
        matched = r["radix"]["prefill_tokens_saved"] // B
        if st["migrated_blocks"] != prompt_blocks - matched:
            raise AssertionError(
                f"replicas {label}: {st['migrated_blocks']} blocks migrated,"
                f" not {prompt_blocks} - {matched} the decode radix held")
        wire = st["migrated_bytes"] // max(1, st["migrated_blocks"])
        if config == GPT2_SMALL and wire != TIER["wire_block_bytes"]:
            raise AssertionError(f"replicas {label}: {wire} bytes a block")
        if r["h2d_bytes"] != st["migrated_bytes"]:
            raise AssertionError(f"replicas {label}: {r['h2d_bytes']} bytes "
                                 f"up, {st['migrated_bytes']} down")
        if cuda:
            if r["own"][pre]["bigdl_paged_decode"] or \
                    r["own"][dec]["bigdl_flash_fwd"]:
                raise AssertionError(f"replicas {label}: per-replica "
                                     f"launches {r['own']}")
            check_launches(f"replicas {label}", r["launches"],
                           ("bigdl_flash_fwd", "bigdl_paged_decode"))
        d1[label] = r
        ms = r["migrate_ms"]
        log(f"[replicas] {label}: migrations {st['migrations']}, adopted "
            f"{st['adopted']}, lost_payloads 0; decode radix hits "
            f"{r['radix']['hits']} ({matched} blocks); migrated_blocks "
            f"{st['migrated_blocks']} = {prompt_blocks} - {matched}, "
            f"{st['migrated_bytes']} bytes down and {r['h2d_bytes']} up "
            f"({wire} a block); launches by replica {r['own']}; TTFT p50 "
            f"{run['ttft_p50_s'] * 1e3:.2f} ms, decode "
            f"{run['decode_tokens_per_s']:.1f} tokens/s, lm/migrate ms "
            f"median {statistics.median(ms):.3f} (min {min(ms):.3f}, max "
            f"{max(ms):.3f})"
            + (f"; co-located serve: TTFT p50 "
               f"{colocated['ttft_p50_s'] * 1e3:.2f} ms, decode "
               f"{colocated['decode_tokens_per_s']:.1f} tokens/s"
               if colocated and t == 0.0 else "")
            + f"; {len(prompts) - len(ties)} of {len(prompts)} streams "
            "identical to offline generate; no capture after warmup")
    out["d1"] = {k: dict(migrated_blocks=v["stats"]["migrated_blocks"],
                         migrated_bytes=v["stats"]["migrated_bytes"],
                         decode_radix_hits=v["radix"]["hits"],
                         migrate_ms=v["migrate_ms"],
                         ttft_p50_s=v["run"]["ttft_p50_s"],
                         decode_tokens_per_s=v["run"]["decode_tokens_per_s"])
                 for k, v in d1.items()}

    r = disagg("D2", 0.0, fault=replicas["d2_fault"])
    release(dev)
    st = r["stats"]
    pre, dec = st["engines"]
    for i, (a, b) in enumerate(zip(r["run"]["results"],
                                   d1["D1 greedy"]["run"]["results"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"replicas D2: stream {i} differs from D1's")
    check_streams("replicas D2", oracle, prompts, r["run"]["results"],
                  max_new)
    lost, re_pf = st["lost_payloads"], st["re_prefills"]
    if not lost > 0 or re_pf != lost or st["migrations"] != len(prompts):
        raise AssertionError(f"replicas D2: lost_payloads {lost}, "
                             f"re_prefills {re_pf}")
    if r["passes"][dec] != re_pf:
        raise AssertionError(f"replicas D2: {r['passes'][dec]} decode-side "
                             f"prefill passes for {re_pf} re-prefills")
    plain = r["plain"][dec]["hits"] + r["plain"][dec]["misses"]
    if cuda and r["own"][dec]["bigdl_flash_fwd"] != n_layers * plain:
        raise AssertionError(f"replicas D2: the decode replica launched "
                             f"flash_fwd {r['own'][dec]['bigdl_flash_fwd']} "
                             f"times for {plain} cold re-prefill passes")
    out["d2"] = dict(lost_payloads=lost, re_prefills=re_pf,
                     decode_flash_fwd=r["own"][dec]["bigdl_flash_fwd"],
                     decode_plain_passes=plain,
                     migrated_blocks=st["migrated_blocks"])
    log(f"[replicas] D2 {replicas['d2_fault']} seed 3: lost_payloads {lost},"
        f" re_prefills {re_pf} ({r['passes'][dec]} decode-side prefill "
        f"passes, {plain} through the flash prefill: decode flash_fwd "
        f"{r['own'][dec]['bigdl_flash_fwd']} = {n_layers} x {plain}); "
        f"migrated_blocks {st['migrated_blocks']}; every stream bitwise "
        "D1's and identical to offline generate")

    # -- R1, R3, R2: one routed replica set ---------------------------- #
    p1, seed1, seed2 = prompts[4], 7, 8
    turn1 = oracle.stream(p1, max_new, temp, rng=seed1)
    p2 = np.concatenate([turn1, replicas["turn2_extra"]])
    pol = HedgePolicy(trigger_quantile=0.5, window=64, min_observations=4,
                      max_hedge_fraction=0.5)
    rs = LMReplicaSet(model, 2, router=RadixRouter(), hedge=pol,
                      name="replicas", **eng_kw)
    engines = [r.engine for r in rs._replicas]
    try:
        pairs = shared_heads(list(prompts) + [p2], B)
        warm = {e.name: warm_pairs(e, pairs) for e in engines}
        ptrs = {e.name: e.cache_buffer_pointers() for e in engines}

        def r1():
            s1 = rs.submit(p1, session_id="chat", max_new_tokens=max_new,
                           temperature=temp, rng=seed1)
            o1 = s1.result(timeout=600)
            s2 = rs.submit(p2, session_id="chat", max_new_tokens=max_new,
                           temperature=temp, rng=seed2)
            return s1, o1, s2, s2.result(timeout=600)

        (s1, o1, s2, o2), l_r1 = sub_run("R1", r1)
        tie1 = oracle.check(p1, o1, max_new, temp, rng=seed1)
        tie2 = oracle.check(p2, o2, max_new, temp, rng=seed2)
        sess = rs.stats()["sessions"]
        holder = next(e for e in engines if e.name == s1.replica_name)
        hits = holder.radix.stats()["hits"]
        if sess["sticky_hits"] < 1 or s2.replica_name != s1.replica_name \
                or hits < 1:
            raise AssertionError(f"replicas R1: sticky_hits "
                                 f"{sess['sticky_hits']}, turns on "
                                 f"{s1.replica_name}/{s2.replica_name}, "
                                 f"radix hits {hits}")
        out["r1"] = dict(sticky_hits=sess["sticky_hits"], radix_hits=hits,
                         ties=[t for t in (tie1, tie2) if t])
        log(f"[replicas] R1 session turns of {len(p1)} and {len(p2)} tokens "
            f"at {temp}: both on {s1.replica_name}, sticky_hits "
            f"{sess['sticky_hits']}, radix hits there {hits}; both streams "
            "identical to offline generate"
            + (f" ({tie1 or tie2})" if tie1 or tie2 else ""))

        for _ in range(replicas["hedge_seed_waits"]):
            pol.observe(replicas["hedge_seed_wait_s"])

        def r3():
            streams = [rs.submit(p, max_new_tokens=max_new, temperature=temp,
                                 rng=i, hedgeable=True)
                       for i, p in enumerate(prompts)]
            return [s.result(timeout=600) for s in streams]

        r3_results, l_r3 = sub_run("R3", r3)
        ties = check_streams("replicas R3", oracle, prompts, r3_results,
                             max_new, temp)
        hst = pol.stats()
        if hst["hedges_won"] + hst["hedges_lost"] != hst["hedges_fired"]:
            raise AssertionError(f"replicas R3: hedge outcomes {hst}")
        out["r3"] = dict(hedges_fired=hst["hedges_fired"],
                         hedges_won=hst["hedges_won"], ties=len(ties))
        log(f"[replicas] R3 hedged dispatch (trigger p50 of a seeded window,"
            f" budget 0.5 of dispatches): hedges_fired {hst['hedges_fired']},"
            f" hedge_wins {hst['hedges_won']}, hedges_lost "
            f"{hst['hedges_lost']}; {len(prompts) - len(ties)} of "
            f"{len(prompts)} streams identical to offline generate")

        i2 = replicas["r2_prompt"]

        def r2():
            s = rs.submit(prompts[i2], session_id="r2",
                          max_new_tokens=max_new, temperature=temp, rng=i2)
            it = s.tokens(timeout=600)
            for _ in range(replicas["r2_kill_at"]):
                next(it)
            victim = s.replica_name
            rs.kill_replica(victim)
            return s, victim, s.result(timeout=600)

        (s, victim, o), l_r2 = sub_run("R2", r2)
        if not np.array_equal(o, r3_results[i2]):
            raise AssertionError("replicas R2: the replayed stream differs "
                                 "from R3's run of the same request")
        tie = oracle.check(prompts[i2], o, max_new, temp, rng=i2)
        sess = rs.stats()["sessions"]
        if sess["re_routes"] < 1 or s.re_dispatches != 1 \
                or s.replica_name == victim:
            raise AssertionError(f"replicas R2: re_routes "
                                 f"{sess['re_routes']}, re_dispatches "
                                 f"{s.re_dispatches}")
        out["r2"] = dict(re_routes=sess["re_routes"], victim=victim,
                         survivor=s.replica_name, tie=tie)
        log(f"[replicas] R2 {victim} killed after the {len(prompts[i2])}-"
            f"token stream's {replicas['r2_kill_at']}th token: replayed on "
            f"{s.replica_name}, bitwise R3's stream and identical to offline "
            f"generate{f' ({tie})' if tie else ''}, re_routes "
            f"{sess['re_routes']}")
        for e in engines:
            check_replica("R1-R3", e, warm[e.name], ptrs[e.name], params_ptr)
    finally:
        rs.close()
    del rs, engines, holder, e
    release(dev)
    if cuda:
        for label, la in (("R1", l_r1), ("R3", l_r3)):
            check_launches(f"replicas {label}", la,
                           ("bigdl_flash_fwd", "bigdl_paged_decode"))
        # the survivor may hold the stream's prompt in its radix (R3 ran
        # it there), and then the replay prefills through the suffix path
        check_launches("replicas R2", l_r2, ("bigdl_paged_decode",))
    del model
    release(dev)
    out["launches"] = acc.total
    return out


def batch_requests(batch, vocab):
    """The batch phase's requests: ``requests`` asynchronous ones in the
    sizes of the reference's BENCH_SERVE mix cut to the top bucket, then
    ``predicts`` synchronous ones continuing the mix, then the oversized
    ones; each (n, seq_len) random 1-based ids as float32, from one
    seed."""
    import numpy as np
    sizes = batch["sizes"]
    ns = [sizes[i % len(sizes)]
          for i in range(batch["requests"] + batch["predicts"])]
    ns += [batch["oversized"]] * batch["oversized_n"]
    rng = np.random.RandomState(batch["id_seed"])
    return [rng.randint(1, vocab + 1, size=(n, batch["seq_len"])).astype(
        np.float32) for n in ns]


def phase_batch(dev, config=GPT2_SMALL, batch=BATCH, oracle=None):
    """The padded-batch serving stack and the Module core (see the
    module docstring): B1 the serve cell's model scored through one
    ServingEngine, B2 the same traffic through a 2-replica ReplicaSet
    with r1 dying, B3 the OO shell's backward through the flash pair.
    Returns the phase's numbers and its launches."""
    import threading

    import numpy as np
    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.obs import get_registry
    from bigdl_tpu_torch.resilience import ReplicaSet, faults
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import pytree
    oracle = oracle or Oracle(dev, config, SERVE["seed"])
    plain = oracle.model
    cuda = dev.type == "cuda"
    T, top, V = batch["seq_len"], batch["max_batch"], config["vocab_size"]
    n_layers = config["n_layers"]
    # the serve cell's seed-0 weights, shared with the plain model
    model = TransformerLM(attention_impl="auto", device=dev, **config)
    model.params = plain.params
    reqs = batch_requests(batch, V)
    n_async = batch["requests"]
    n_sync = n_async + batch["predicts"]
    acc = _PathLaunches()
    out = {}

    def plain_err(x, y):
        """max |dlog-prob| of served rows ``y`` against the plain
        forward of ``x``; raises past the tolerance."""
        with torch.no_grad():
            want = plain.f(plain.params, torch.from_numpy(x).to(dev))
        if y.shape != tuple(want.shape) or not np.isfinite(y).all():
            raise AssertionError(f"batch: served {y.shape}, plain "
                                 f"{tuple(want.shape)}, finite "
                                 f"{bool(np.isfinite(y).all())}")
        err = (torch.from_numpy(y).to(dev) - want).abs().max().item()
        if not err <= batch["tol"]:
            raise AssertionError(f"batch: max |dlog-prob| {err:.3e} > "
                                 f"{batch['tol']} against plain attention")
        return err

    # -- B1: one engine, threads, predicts, oversized ------------------ #
    _peak_reset(dev)
    eng = ServingEngine(model, input_shape=(T,), dtype="float32",
                        max_batch_size=top, device=dev, name="batch")
    n_buckets = len(eng.buckets)
    lat = [None] * len(reqs)
    results = [None] * len(reqs)

    def b1():
        t0 = time.perf_counter()
        made = eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = eng.graphs.captures
        launches0, replays0 = _launches(), eng.graphs.replays
        futs = {}

        def client(k):
            for i in range(k, n_async, batch["threads"]):
                t = time.perf_counter()
                f = eng.submit(reqs[i])
                f.add_done_callback(lambda _f, i=i, t=t: lat.__setitem__(
                    i, time.perf_counter() - t))
                futs[i] = f

        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(batch["threads"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for i in range(n_async):
            results[i] = futs[i].result(timeout=600)
        for i in range(n_async, len(reqs)):
            t = time.perf_counter()
            results[i] = eng.predict(reqs[i], timeout=600)
            lat[i] = time.perf_counter() - t
        wall = time.perf_counter() - t_start
        if cuda:
            torch.cuda.synchronize()
        launches = _launches()
        return dict(made=made, warm_s=warm_s, captures_warm=captures,
                    wall_s=wall, replays=eng.graphs.replays - replays0,
                    fwd_traffic=launches["bigdl_flash_fwd"]
                    - launches0["bigdl_flash_fwd"])

    b1r = acc.run(b1)
    stats = eng.stats()
    snap = stats["metrics"]
    want_caps = n_buckets if cuda else 0
    if b1r["made"] != n_buckets or b1r["captures_warm"] != want_caps or \
            eng.graphs.captures != want_caps:
        raise AssertionError(f"batch B1: {b1r['made']} entries made, "
                             f"{b1r['captures_warm']} captures at warmup, "
                             f"{eng.graphs.captures} after traffic; "
                             f"{n_buckets} buckets")
    if stats["compile_cache"]["hit_rate"] != 1.0:
        raise AssertionError(f"batch B1: hit rate "
                             f"{stats['compile_cache']['hit_rate']}")
    if cuda and b1r["fwd_traffic"] != n_layers * b1r["replays"]:
        raise AssertionError(f"batch B1: {b1r['fwd_traffic']} flash_fwd "
                             f"launches over {b1r['replays']} replays, not "
                             f"{n_layers} a replay")
    peak = _peak(dev)
    worst = 0.0
    for i, x in enumerate(reqs):
        worst = max(worst, plain_err(x, results[i]))
        results[i] = None
    rows = sum(int(x.shape[0]) for x in reqs)
    lat_ms = np.asarray(lat) * 1e3
    d2h_ms, split = None, {}
    top_bytes = top * T * V * 4
    if cuda:
        # each bucket's batch, split as _run_batch runs it: the entry's
        # staging and replay (CUDA events on the replaying stream), then
        # the engine's own copy of the outputs to the host (host clock;
        # the copy synchronises)
        from bigdl_tpu_torch.serving.engine import _to_host
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for bkt in eng.buckets:
            xb = np.zeros((bkt, T), np.float32)
            rep, cp = [], []
            for _ in range(batch["split_reps"]):
                torch.cuda.synchronize()
                ev0.record()
                y = eng.cache(eng._params, eng._buffers, xb)
                ev1.record()
                ev1.synchronize()
                t0 = time.perf_counter()
                _to_host(y)
                cp.append((time.perf_counter() - t0) * 1e3)
                rep.append(ev0.elapsed_time(ev1))
            split[bkt] = dict(replay_ms=float(np.median(rep)),
                              to_host_ms=float(np.median(cp)))
        del y
        d2h_ms = split[top]["to_host_ms"]
    pool = eng.graphs.pool_bytes()
    qw, dt = snap["queue_wait"], snap["device_time"]
    out["b1"] = dict(
        requests=len(reqs), rows=rows, wall_s=b1r["wall_s"],
        examples_per_s=rows / b1r["wall_s"],
        latency_p50_ms=float(np.percentile(lat_ms, 50)),
        latency_p99_ms=float(np.percentile(lat_ms, 99)),
        queue_wait_p50_ms=qw["p50_s"] * 1e3, queue_wait_p99_ms=qw["p99_s"]
        * 1e3, device_p50_ms=dt["p50_s"] * 1e3, device_p99_ms=dt["p99_s"]
        * 1e3, batches=snap["batches"], occupancy=snap["batch_occupancy"],
        replays=b1r["replays"], captures=eng.graphs.captures,
        warmup_s=b1r["warm_s"], max_err=worst, peak_bytes=peak,
        pool_bytes=pool, top_output_bytes=top_bytes, d2h_ms=d2h_ms,
        split=split)
    b = out["b1"]
    log(f"[batch] B1 {b['requests']} requests, {rows} rows of {T} ids "
        f"(4 threads, {batch['predicts']} predicts, {batch['oversized_n']} "
        f"x {batch['oversized']} rows): {b['examples_per_s']:.1f} "
        f"examples/s, latency p50 {b['latency_p50_ms']:.2f} / p99 "
        f"{b['latency_p99_ms']:.2f} ms, queue wait p50 "
        f"{b['queue_wait_p50_ms']:.2f} / p99 {b['queue_wait_p99_ms']:.2f} ms "
        f"against device time p50 {b['device_p50_ms']:.2f} / p99 "
        f"{b['device_p99_ms']:.2f} ms, {b['batches']} batches, occupancy "
        f"{b['occupancy']:.3f}, {b['captures']} captures ({b['warmup_s']:.2f}"
        f" s warmup), {b['replays']} replays, flash_fwd "
        f"{b1r['fwd_traffic']} launches through them, max |dlog-prob| "
        f"{worst:.3e} against plain attention, max_memory_allocated "
        f"{_mib(peak)}, graph pool "
        f"{'none' if pool is None else f'{pool / 2**20:.1f} MiB'}; the top "
        f"bucket's output {top_bytes} bytes, its copy to the host "
        f"{'n/a' if d2h_ms is None else f'{d2h_ms:.2f} ms'}")
    for bkt, sp in split.items():
        log(f"[batch] B1 bucket {bkt}: stage + replay "
            f"{sp['replay_ms']:.3f} ms (CUDA events), the engine's copy of "
            f"its output to the host {sp['to_host_ms']:.3f} ms (host "
            f"clock), medians of {batch['split_reps']}")

    # -- B2: the padded-batch replica set, r1 dying -------------------- #
    failovers = get_registry().counter("resilience/failovers")
    rs = ReplicaSet(model, n_replicas=2, input_shape=(T,), dtype="float32",
                    max_batch_size=top, device=dev)
    os.environ[faults.ENV_SPEC] = batch["fault"]
    os.environ[faults.ENV_SEED] = "0"
    faults.refresh_from_env()
    try:
        def b2():
            rs.warmup()
            f0 = failovers.value
            for i, x in enumerate(reqs):
                want = eng.predict(x, timeout=600)   # one request a batch
                got = rs.predict(x, timeout=600)
                if not np.array_equal(got, want):
                    raise AssertionError(f"batch B2: request {i} differs "
                                         "from the single engine's answer")
            return int(failovers.value - f0)

        redispatches = acc.run(b2)
        st = rs.stats()["replicas"]
        fired = sum(v["fired"] for v in faults.active().stats().values())
    finally:
        os.environ.pop(faults.ENV_SPEC, None)
        os.environ.pop(faults.ENV_SEED, None)
        faults.refresh_from_env()
        rs.close()
    states = {k: v["state"] for k, v in st.items()}
    if redispatches < 1 or fired < 1 or states["r1"] == "healthy":
        raise AssertionError(f"batch B2: {redispatches} re-dispatches, "
                             f"{fired} faults fired, breakers {states}")
    out["b2"] = dict(requests=len(reqs), redispatches=redispatches,
                     fired=fired, states=states,
                     dispatched={k: v["dispatched"] for k, v in st.items()})
    log(f"[batch] B2 ReplicaSet of 2 under {batch['fault']}: "
        f"{len(reqs)} requests all answered, each bitwise the single "
        f"engine's, {redispatches} re-dispatches, {fired} faults fired, "
        f"breakers {states}, dispatched "
        f"{out['b2']['dispatched']}")
    eng.close()
    del rs, eng
    release(dev)

    # -- B3: the OO shell through the flash pair ----------------------- #
    H, heads = config["hidden_size"], config["n_head"]

    def b3_module(impl):
        return nn.Sequential(
            nn.MultiHeadAttention(H, heads, causal=True, attention_impl=impl),
            nn.Linear(H, H)).build(0, device=dev)

    rng = np.random.RandomState(batch["id_seed"])
    x3 = rng.randn(*batch["b3_shape"], H).astype(np.float32)
    g3 = rng.randn(*batch["b3_shape"], H).astype(np.float32)
    fast = b3_module("auto")

    def b3():
        fwd, bwd = [], []
        for _ in range(1 + batch["b3_steps"]):
            fast.zero_grad_parameters()
            t0 = time.perf_counter()
            fast.forward(x3)
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            gi = fast.backward(x3, g3)
            if cuda:
                torch.cuda.synchronize()
            fwd.append((t1 - t0) * 1e3)
            bwd.append((time.perf_counter() - t1) * 1e3)
        flat_w, flat_g, _ = fast.get_parameters()
        return gi, flat_w, flat_g, fwd[1:], bwd[1:]

    gi, flat_w, flat_g, fwd_ms, bwd_ms = acc.run(b3)
    l3 = dict(acc.last)
    plain3 = b3_module("xla")
    gi_ref = plain3.backward(x3, g3)
    got = {"input": gi, **{str(i): leaf for i, leaf in enumerate(
        pytree.tree_leaves(fast.grad_params))}}
    want = {"input": gi_ref, **{str(i): leaf for i, leaf in enumerate(
        pytree.tree_leaves(plain3.grad_params))}}
    ratio, leaf = _check_grads("batch B3", got, want, TOL_GRAD)
    n_params = int(flat_w.numel())
    if flat_g.numel() != n_params or not torch.isfinite(flat_g).all():
        raise AssertionError("batch B3: get_parameters() gradients")
    if cuda:
        check_launches("batch B3", l3, ("bigdl_flash_fwd",
                                        "bigdl_flash_bwd_dkv",
                                        "bigdl_flash_bwd_dq"))
    out["b3"] = dict(fwd_ms=float(np.median(fwd_ms)),
                     bwd_ms=float(np.median(bwd_ms)), worst=ratio,
                     worst_leaf=leaf, params=n_params, launches=l3)
    log(f"[batch] B3 Sequential(MultiHeadAttention({H}, {heads}, causal), "
        f"Linear({H}, {H})) on {tuple(x3.shape)}: forward "
        f"{out['b3']['fwd_ms']:.2f} ms, backward {out['b3']['bwd_ms']:.2f} "
        f"ms (medians of {batch['b3_steps']}, host clock), "
        f"{n_params} parameters flattened, worst gradient {ratio:.2e} of "
        f"its max |g| ({leaf}), launches {l3}")
    del fast, plain3, model
    release(dev)
    out["launches"] = acc.total
    return out


def _ms_list(ms):
    return "[" + ", ".join(f"{m:.3f}" for m in ms) + "]"


# --------------------------------------------------------------------------- #
def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _named_leaves(sub, f"{prefix}/{key}")
    else:
        yield prefix, tree


def _check_grads(run, got, want, tol):
    """Each gradient leaf of ``got`` finite and within ``tol`` of
    ``want``'s: its max abs error over ``want``'s max |g|.  The key
    bias's gradient is zero in exact arithmetic (a constant added to
    every score of a row leaves its softmax unchanged), so it holds
    rounding noise only: each leaf's max |g| has a floor of ``tol``
    times the tree's largest |g|.  Returns (worst ratio, its leaf)."""
    import torch
    floor = tol * max(b.abs().max().item() for _, b in _named_leaves(want))
    worst = (0.0, "")
    for (path, a), (_, b) in zip(_named_leaves(got), _named_leaves(want)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"gradient {path}: non-finite on {run}")
        ratio = (a.float() - b).abs().max().item() / max(
            b.abs().max().item(), floor)
        if not ratio <= tol:
            raise AssertionError(f"gradient {path} on {run}: max_abs_err "
                                 f"over max |g| {ratio:.3e} > {tol}")
        worst = max(worst, (ratio, path))
    return worst


def _reset_launches():
    from bigdl_tpu_torch.ops import KERNELS
    for k in KERNELS:
        k.launches = 0


def _launches():
    from bigdl_tpu_torch.ops import KERNELS
    return {k.symbol: k.launches for k in KERNELS}


def check_launches(run, launches, symbols, exactly=None):
    """Every kernel of ``symbols`` launched in ``run``: at least once, or
    ``exactly`` times."""
    for symbol in symbols:
        n = launches[symbol]
        if n <= 0 or (exactly is not None and n != exactly):
            want = "at least once" if exactly is None else f"{exactly} times"
            raise AssertionError(f"{symbol} was launched {n} times on the "
                                 f"{run}, not {want}")


class _IterationLog(logging.Handler):
    """The wall clock and loss at the end of each LocalOptimizer
    iteration, read from the loop's per-iteration log record (emitted
    after the step's loss fetch, which waits for the update)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.ends, self.losses = [], []

    def emit(self, record):
        if record.msg.startswith("Epoch %d iteration %d"):
            self.ends.append(time.perf_counter())
            self.losses.append(float(record.args[2]))


def run_iterations(opt, n):
    """``opt.optimize()`` for ``n`` more iterations: (losses, seconds
    from each iteration's end to the next's, n - 1 of them)."""
    from bigdl_tpu_torch.optim import Trigger
    opt.set_end_when(Trigger.max_iteration(opt.state.get("neval", 1) + n - 1))
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    level, record = logger.level, _IterationLog()
    logger.setLevel(logging.INFO)
    logger.addHandler(record)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(record)
        logger.setLevel(level)
    if len(record.losses) != n:
        raise AssertionError(f"optimize() logged {len(record.losses)} "
                             f"iterations, not {n}")
    return record.losses, [b - a for a, b in zip(record.ends, record.ends[1:])]


def phase_train(dev, config=GPT2_SMALL, train=TRAIN, cli=TRAIN_CLI,
                profile_path=None):
    """Train the model on one fixed batch of random ids (memorisation:
    the loss must fall) through the public entry points: the float32 and
    bf16-compute gradient checks against plain attention, the timed
    LocalOptimizer steps, one bf16-compute step, and the train CLI.  Returns the train metrics,
    with each run's kernel launch counts."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer import train as train_cli
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, loss_and_grads
    cuda = dev.type == "cuda"
    batch, seq = train["batch"], train["seq_len"]
    ids = np.random.RandomState(train["data_seed"]).randint(
        1, config["vocab_size"] + 1, size=(batch, seq + 1)).astype(np.float32)
    x, y = ids[:, :-1], ids[:, 1:]
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)

    def fresh():
        return TransformerLM(attention_impl="flash", device=dev,
                             **config).build(seed=train["seed"])

    def optimizer(model, compute_dtype=None):
        ds = DataSet.array([Sample(f, l) for f, l in zip(x, y)]) \
            >> SampleToBatch(batch)
        opt = LocalOptimizer(model, ds, crit).set_optim_method(
            Adam(learning_rate=train["learning_rate"]))
        return opt.set_compute_dtype(compute_dtype) if compute_dtype else opt

    # 1. step-0 loss and every gradient leaf: flash kernels vs plain
    t0 = time.perf_counter()
    model = fresh()
    plain = TransformerLM(attention_impl="xla", device=dev, **config)
    cb = train["check_batch"]
    xb, yb = (torch.as_tensor(a[:cb], device=dev) for a in (x, y))
    loss_f, g_f, _ = loss_and_grads(model, crit, model.params, xb, yb)
    loss_p, g_p, _ = loss_and_grads(plain, crit, model.params, xb, yb)
    rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    if not rel <= TOL_LOSS:
        raise AssertionError(f"step-0 loss flash {float(loss_f)} vs plain "
                             f"{float(loss_p)}: relative {rel:.3e} > "
                             f"{TOL_LOSS}")
    worst = _check_grads("flash", g_f, g_p, TOL_GRAD)
    log(f"[train] gradient check at {cb}x{seq}, {config['n_layers']} "
        f"layers: loss flash {float(loss_f):.6f} plain {float(loss_p):.6f} "
        f"(relative {rel:.2e}), every leaf within {TOL_GRAD} of its max |g| "
        f"(worst {worst[0]:.2e} at {worst[1]}) in "
        f"{time.perf_counter() - t0:.2f} s")
    del g_f, plain
    # the same step with bf16 compute (the bf16 flash kernels, forward and
    # backward), held against the float32 gradients
    loss_h, g_h, _ = loss_and_grads(model, crit, model.params, xb, yb,
                                    compute_dtype=torch.bfloat16)
    worst16 = _check_grads("bf16 flash", g_h, g_p, TOL_BF16_GRAD)
    log(f"[train] bf16-compute gradient check at {cb}x{seq}: loss "
        f"{float(loss_h):.6f}, every leaf within {TOL_BF16_GRAD} of the "
        f"float32 leaf's max |g| (worst {worst16[0]:.3e} at {worst16[1]})")
    del g_h, g_p

    # 2. the timed steps
    opt = optimizer(model)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    # one optimize() over every step, as a user runs it; each step is timed
    # from the end of the one before, so the warm-up step has no time
    losses, step_s = run_iterations(opt, train["warmup"] + train["steps"])
    step_s = step_s[train["warmup"] - 1:]
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite and "
                             "falling")
    step_ms = float(np.median(step_s)) * 1e3
    idle = None
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        idle = profile_device(lambda: run_iterations(opt, 1),
                              f"train step ({batch}x{seq})",
                              f"{root}_train{ext}")
    log(f"[train] {batch}x{seq} tokens, Adam lr {train['learning_rate']}: "
        f"losses {[round(v, 4) for v in losses]}; median step "
        f"{step_ms:.2f} ms over {train['steps']} steps "
        f"({[round(s * 1e3, 2) for s in step_s]} ms), "
        f"{batch * seq / step_ms * 1e3:.1f} tokens/s")
    del opt, model

    # 3. bf16 compute on fresh weights, timed as the float32 steps are:
    # one optimize() of a warm-up and the timed steps
    opt16 = optimizer(fresh(), torch.bfloat16)
    _reset_launches()
    losses16, step_s16 = run_iterations(
        opt16, train["warmup"] + train["bf16_steps"])
    launches16 = _launches()
    step_s16 = step_s16[train["warmup"] - 1:]
    loss16 = losses16[0]
    rel16 = abs(loss16 - losses[0]) / abs(losses[0])
    if not rel16 <= TOL_BF16_STEP:
        raise AssertionError(f"bf16 step-0 loss {loss16} vs float32 "
                             f"{losses[0]}: relative {rel16:.3e}")
    if not all(np.isfinite(losses16)):
        raise AssertionError(f"bf16-compute losses {losses16}: not finite")
    step16_ms = float(np.median(step_s16)) * 1e3
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        profile_device(lambda: run_iterations(opt16, 1),
                       f"bf16-compute train step ({batch}x{seq})",
                       f"{root}_train_bf16{ext}")
    log(f"[train] bf16-compute step: loss {loss16:.6f} (float32 "
        f"{losses[0]:.6f}, relative {rel16:.2e}); losses "
        f"{[round(v, 4) for v in losses16]}; median step {step16_ms:.2f} ms "
        f"over {train['bf16_steps']} steps "
        f"({[round(s * 1e3, 2) for s in step_s16]} ms), "
        f"{batch * seq / step16_ms * 1e3:.1f} tokens/s")
    del opt16

    # 4. the train CLI: packed windows, documents isolated (segmented
    # kernels), validation every epoch
    _reset_launches()
    cli_opt = train_cli.main(cli + ["--device", dev.type])
    launches_cli = _launches()
    (method, result), = cli_opt.validation_results
    if not (np.isfinite(cli_opt.state["loss"])
            and np.isfinite(result.result()[0])):
        raise AssertionError(f"train CLI: loss {cli_opt.state['loss']}, "
                             f"validation {result}")
    log(f"[train] CLI {' '.join(cli)}: loss {cli_opt.state['loss']:.6f}, "
        f"validation {method} {result}")
    return dict(losses=losses, step_ms=step_ms,
                tokens_per_s=batch * seq / step_ms * 1e3, peak_bytes=peak,
                idle_share=idle, launches=launches, launches_bf16=launches16,
                launches_cli=launches_cli, step16_ms=step16_ms,
                tokens_per_s16=batch * seq / step16_ms * 1e3,
                steps_run=train["warmup"] + train["steps"],
                steps_run_bf16=train["warmup"] + train["bf16_steps"])


# --------------------------------------------------------------------------- #
def _peak_reset(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(dev):
    import torch
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _mib(nbytes):
    return "n/a (CPU)" if nbytes is None else f"{nbytes / 2**20:.1f} MiB"


def _train_batch(config, train):
    """The train phase's fixed batch of random ids: (x, y) float32."""
    import numpy as np
    ids = np.random.RandomState(train["data_seed"]).randint(
        1, config["vocab_size"] + 1,
        size=(train["batch"], train["seq_len"] + 1)).astype(np.float32)
    return ids[:, :-1], ids[:, 1:]


def _optimizer(model, x, y, batch, lr, **kw):
    """LocalOptimizer (Adam, TimeDistributed(ClassNLL)) over the rows of
    (x, y) in batches of ``batch``."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer
    ds = DataSet.array([Sample(f, l) for f, l in zip(x, y)], **kw) \
        >> SampleToBatch(batch)
    return LocalOptimizer(model, ds, TimeDistributedCriterion(
        ClassNLLCriterion(), True)).set_optim_method(Adam(learning_rate=lr))


def _set_flag(args, flag, value):
    """``args`` with the value after ``flag`` replaced."""
    args = list(args)
    args[args.index(flag) + 1] = value
    return args


def _weight_bytes(params):
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def phase_moe(dev, config=GPT2_SMALL, moe=MOE, train=TRAIN, serve=SERVE,
              prompts=None, dense_serve=None, profile_path=None):
    """M1: the switch-MoE model (every block's MLP replaced by 8 experts,
    capacity 1.25, aux weight 0.01) trained on the train phase's batch
    through the three flash kernels: the step-0 loss and every gradient
    leaf held against plain attention, then one optimize() of a warm-up
    and the timed steps.  M2: the same weights behind LMServingEngine
    (graphs on, dense routing), every greedy stream held against offline
    generate on plain attention.  Returns the two runs' numbers.  With
    ``profile_path``, one more training step is traced (see
    profile_device) into PATH with ``_moe`` before its extension."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import loss_and_grads
    cfg = dict(config, moe_experts=moe["experts"],
               moe_capacity_factor=moe["capacity_factor"],
               moe_aux_weight=moe["aux_weight"])
    x, y = _train_batch(config, train)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    t0 = time.perf_counter()
    model = TransformerLM(attention_impl="flash", device=dev,
                          **cfg).build(seed=train["seed"])
    wbytes = _weight_bytes(model.params)
    if config is GPT2_SMALL and wbytes != moe["weight_bytes"]:
        raise AssertionError(f"MoE weights {wbytes} bytes, not "
                             f"{moe['weight_bytes']}")
    log(f"[moe] {cfg['n_layers']} layers, {moe['experts']} experts a block, "
        f"{wbytes} bytes of float32 weights, built in "
        f"{time.perf_counter() - t0:.2f} s")

    # M1. step-0 loss and every gradient leaf, moe leaves included
    cb = train["check_batch"]
    xb, yb = (torch.as_tensor(a[:cb], device=dev) for a in (x, y))
    plain = TransformerLM(attention_impl="xla", device=dev, **cfg)
    loss_f, g_f, buf = loss_and_grads(model, crit, model.params, xb, yb,
                                      buffers=model.buffers)
    loss_p, g_p, _ = loss_and_grads(plain, crit, model.params, xb, yb,
                                    buffers=model.buffers)
    rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    if not rel <= TOL_LOSS:
        raise AssertionError(f"MoE step-0 loss flash {float(loss_f)} vs plain "
                             f"{float(loss_p)}: relative {rel:.3e}")
    worst = _check_grads("MoE flash", g_f, g_p, TOL_GRAD)
    aux = float(buf["aux_loss"])
    gate_g = float(g_f["blocks"]["moe"]["gate"].abs().max())
    if not (np.isfinite(aux) and aux > 0 and gate_g > 0):
        raise AssertionError(f"MoE aux_loss {aux}, gate max |g| {gate_g}")
    log(f"[moe] M1 gradient check at {cb}x{train['seq_len']}: loss flash "
        f"{float(loss_f):.6f} plain {float(loss_p):.6f} (relative "
        f"{rel:.2e}), every leaf within {TOL_GRAD} of its max |g| (worst "
        f"{worst[0]:.2e} at {worst[1]}); aux_loss {aux:.6f}, gate max |g| "
        f"{gate_g:.3e}")
    del g_f, g_p, plain

    opt = _optimizer(model, x, y, train["batch"], train["learning_rate"])
    model.moe_drops = []
    _peak_reset(dev)
    _reset_launches()
    losses, step_s = run_iterations(opt, moe["warmup"] + moe["steps"])
    launches = _launches()
    peak = _peak(dev)
    drops = [int(d) for d in model.moe_drops[:cfg["n_layers"]]]
    model.moe_drops = None
    step_s = step_s[moe["warmup"] - 1:]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training losses {losses}")
    step_ms = float(np.median(step_s)) * 1e3
    tokens = x.shape[0] * x.shape[1]
    cap = int(np.ceil(moe["capacity_factor"] * tokens / moe["experts"]))
    log(f"[moe] M1 {x.shape[0]}x{x.shape[1]} tokens, Adam lr "
        f"{train['learning_rate']}: losses {[round(v, 4) for v in losses]}; "
        f"median step {step_ms:.2f} ms over {moe['steps']} steps "
        f"({_ms_list([s * 1e3 for s in step_s])} ms), "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, max_memory_allocated "
        f"{_mib(peak)}; tokens over capacity (C = {cap} a expert) by layer "
        f"in the first step {drops} of {tokens}")
    idle = None
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        idle = profile_device(lambda: run_iterations(opt, 1),
                              f"MoE train step ({x.shape[0]}x{x.shape[1]})",
                              f"{root}_moe{ext}")
    m1 = dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens / step_ms
              * 1e3, peak_bytes=peak, launches=launches, drops=drops,
              steps_run=moe["warmup"] + moe["steps"], weight_bytes=wbytes,
              idle_share=idle)
    del opt
    release(dev)

    # M2. the trained weights behind the engine, against plain attention
    prompts = serve_prompts() if prompts is None else prompts
    trained = model.params

    def plain_model():
        m = TransformerLM(attention_impl="xla", device=dev, **cfg)
        m.params = trained
        return m

    oracle = Oracle(dev, cfg, 0, make_model=plain_model)
    m2 = serve_once(dev, model, serve, prompts, oracle, "moe serve")
    line = ""
    if dense_serve is not None:
        line = (f" (dense serve TTFT p50 "
                f"{dense_serve['ttft_p50_s'] * 1e3:.2f} ms, "
                f"{dense_serve['decode_tokens_per_s']:.1f} tokens/s)")
    log(f"[moe] M2 TTFT p50 {m2['ttft_p50_s'] * 1e3:.2f} ms, decode "
        f"{m2['decode_tokens_per_s']:.1f} tokens/s{line}; launches "
        f"{m2['launches']}")
    del oracle, model, trained
    release(dev)
    return dict(m1=m1, m2=m2)


def phase_accum(dev, config=GPT2_SMALL, train=TRAIN, micro=ACCUM_MICRO):
    """A1: the dense model's step on the train batch split into n
    micro-batches (``set_gradient_accumulation(n)``), n = 2 and 4,
    against n = 1: the loss within 1e-5 relative and every gradient leaf
    within 1e-3 of its max |g|; then two LocalOptimizer steps at each n,
    the flash kernels launched exactly 12 n times a step, with each
    run's peak."""
    import torch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import accumulated_loss_and_grads
    x, y = _train_batch(config, train)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    xt, yt = (torch.as_tensor(a, device=dev) for a in (x, y))
    runs = {}
    ref = None
    for n in (1,) + tuple(micro):
        model = TransformerLM(attention_impl="flash", device=dev,
                              **config).build(seed=train["seed"])
        _peak_reset(dev)
        loss, grads, _ = accumulated_loss_and_grads(model, crit,
                                                    model.params, xt, yt, n)
        grad_peak = _peak(dev)
        if ref is None:
            ref = (float(loss), grads)
            rel, worst = 0.0, (0.0, "")
        else:
            rel = abs(float(loss) - ref[0]) / abs(ref[0])
            if not rel <= TOL_LOSS:
                raise AssertionError(f"accumulation {n}: loss {float(loss)} "
                                     f"vs {ref[0]}, relative {rel:.3e}")
            worst = _check_grads(f"accumulation {n}", grads, ref[1], TOL_GRAD)
        del grads
        opt = _optimizer(model, x, y, train["batch"], train["learning_rate"])
        opt.set_gradient_accumulation(n)
        _peak_reset(dev)
        _reset_launches()
        losses, step_s = run_iterations(opt, 2)
        launches = _launches()
        runs[n] = dict(loss=float(loss), rel=rel, worst=worst,
                       grad_peak=grad_peak, peak=_peak(dev),
                       launches=launches, step_ms=step_s[0] * 1e3,
                       losses=losses)
        log(f"[accum] A1 n={n}: loss {float(loss):.6f} (relative {rel:.2e} "
            f"to n=1), worst leaf {worst[0]:.2e} {worst[1]}; peak of the "
            f"gradient {_mib(grad_peak)}, of two optimizer steps "
            f"{_mib(runs[n]['peak'])}; step 2 {runs[n]['step_ms']:.2f} ms; "
            f"launches {launches}")
        del opt, model
        release(dev)
    return runs


class _FaultyData:
    """A dataset whose ``at``-th training-batch read raises, or calls
    ``action`` and goes on when one is given."""

    def __init__(self, inner, at, action=None):
        self.inner, self.at, self.action = inner, at, action
        self.reads = 0

    def size(self):
        return self.inner.size()

    def shuffle(self):
        self.inner.shuffle()

    def data(self, train=True):
        it = self.inner.data(train=train)
        if not train:
            return it

        def gen():
            while True:
                self.reads += 1
                if self.reads == self.at:
                    if self.action is None:
                        raise RuntimeError("the data stream died (injected)")
                    self.action()
                yield next(it)
        return gen()


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def phase_ckpt(dev, config=GPT2_SMALL, ckpt=CKPT, train=TRAIN,
               cli=TRAIN_CLI):
    """C1: a 5-step Adam run of the dense model, uninterrupted, against
    one whose data stream dies while step 4's batch is read (checkpoints
    every 2 iterations; the emergency checkpoint holds step 3), resumed
    by a fresh model and optimizer for steps 4 and 5.  C2: SIGTERM to the
    process during a run: one checkpoint and a clean return.  C3: the
    train CLI with --checkpoint, then --resume, then the eval CLI on the
    newest model with --generate.  Checkpoints go to a temporary
    directory removed at the end."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer import test as eval_cli
    from bigdl_tpu_torch.models.transformer import train as train_cli
    from bigdl_tpu_torch.obs import get_registry
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.utils import file_io
    rng = np.random.RandomState(train["data_seed"] + 1)
    ids = rng.randint(1, config["vocab_size"] + 1,
                      size=(ckpt["rows"], train["seq_len"] + 1)).astype(
        np.float32)
    x, y = ids[:, :-1], ids[:, 1:]
    reg = get_registry()
    counts0 = {k: reg.counter(f"resilience/{k}").value
               for k in ("resumes", "emergency_checkpoints")}
    root = tempfile.mkdtemp(prefix="ckpt_")
    every = Trigger(lambda s: (s["neval"] - 1) % ckpt["every"] == 0,
                    f"every {ckpt['every']} iterations")

    def fresh(seed=train["seed"]):
        return TransformerLM(attention_impl="flash", device=dev,
                             **config).build(seed=seed)

    def opt_for(model, data=None):
        o = _optimizer(model, x, y, ckpt["batch"], train["learning_rate"])
        if data is not None:
            o.dataset = data(o.dataset)
        return o

    out = {}
    _reset_launches()
    try:
        # C1
        model_a = fresh()
        losses_a, _ = run_iterations(opt_for(model_a), ckpt["steps"])
        d1 = os.path.join(root, "c1")
        model_b = fresh()
        opt_b = opt_for(model_b, lambda ds: _FaultyData(ds, ckpt["crash_at"]))
        opt_b.set_checkpoint(d1, every)
        try:
            run_iterations(opt_b, ckpt["steps"])
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        else:
            raise AssertionError("C1: the injected failure did not surface")
        found = file_io.latest_checkpoint(d1)
        if found is None or found[2] != ckpt["crash_at"] - 1:
            raise AssertionError(f"C1: newest checkpoint {found}, not "
                                 f"iteration {ckpt['crash_at'] - 1}")
        written = opt_b.last_checkpoint
        names = sorted(os.listdir(d1))
        del opt_b, model_b
        release(dev)
        model_c = fresh(seed=train["seed"] + 1)
        opt_c = opt_for(model_c)
        t0 = time.perf_counter()
        opt_c.resume_from(d1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        losses_c, _ = run_iterations(opt_c, ckpt["steps"] - found[2])
        rels = [abs(a - c) / abs(a) for a, c in
                zip(losses_a[found[2]:], losses_c)]
        if not max(rels) <= TOL_LOSS:
            raise AssertionError(f"C1: resumed losses {losses_c} vs "
                                 f"uninterrupted {losses_a[found[2]:]}")
        worst, bitwise, leaves = (0.0, ""), 0, 0
        for (path, a), (_, c) in zip(_named_leaves(model_a.params),
                                     _named_leaves(model_c.params)):
            leaves += 1
            bitwise += int(torch.equal(a, c))
            ratio = (a - c).abs().max().item() / max(a.abs().max().item(),
                                                     1e-30)
            if not ratio <= ckpt["tol_param"]:
                raise AssertionError(f"C1: parameter {path} max |dw| over "
                                     f"max |w| {ratio:.3e}")
            worst = max(worst, (ratio, path))
        nbytes = written["bytes"]
        out["c1"] = dict(files=names, bytes=nbytes, dir_bytes=_dir_bytes(d1),
                         write_s=written["seconds"], read_s=read_s,
                         losses=losses_a, resumed=losses_c,
                         worst_rel=max(rels), worst_param=worst,
                         bitwise_leaves=(bitwise, leaves))
        log(f"[ckpt] C1 uninterrupted losses "
            f"{[round(v, 6) for v in losses_a]}; crashed at read "
            f"{ckpt['crash_at']}, files {names}; resumed steps "
            f"{found[2] + 1}-{ckpt['steps']} losses "
            f"{[round(v, 6) for v in losses_c]} (worst relative "
            f"{max(rels):.2e}), every leaf's max |dw| within "
            f"{ckpt['tol_param']} of its max |w| (worst {worst[0]:.2e} at "
            f"{worst[1]}; {bitwise} of {leaves} leaves bitwise equal); one "
            f"pair {nbytes} bytes, written in "
            f"{written['seconds']:.3f} s ({nbytes / written['seconds'] / 1e6:.1f}"
            f" MB/s), read and placed in {read_s:.3f} s "
            f"({nbytes / read_s / 1e6:.1f} MB/s)")
        del opt_c, model_a
        release(dev)

        # C2
        d2 = os.path.join(root, "c2")
        opt_d = opt_for(model_c, lambda ds: _FaultyData(
            ds, ckpt["sigterm_at"],
            action=lambda: os.kill(os.getpid(), signal.SIGTERM)))
        opt_d.set_checkpoint(d2, Trigger.several_iteration(10 ** 9))
        opt_d.handle_preemption()
        before = signal.getsignal(signal.SIGTERM)
        opt_d.set_end_when(Trigger.max_iteration(10 ** 6))
        opt_d.optimize()
        if signal.getsignal(signal.SIGTERM) is not before:
            raise AssertionError("C2: the SIGTERM handler was not restored")
        names2 = sorted(os.listdir(d2))
        if len(names2) != 2:
            raise AssertionError(f"C2: files {names2}, not one pair")
        counts = {k: reg.counter(f"resilience/{k}").value - v
                  for k, v in counts0.items()}
        if counts != {"resumes": 1, "emergency_checkpoints": 1}:
            raise AssertionError(f"C2: resilience counters moved {counts}")
        out["c2"] = dict(files=names2, stopped_at=opt_d.state["neval"] - 1,
                         counters=counts)
        log(f"[ckpt] C2 SIGTERM at read {ckpt['sigterm_at']}: stopped after "
            f"iteration {opt_d.state['neval'] - 1} with {names2}, handler "
            f"restored; resilience counters moved {counts}")
        del opt_d, model_c
        release(dev)

        # C3
        d3 = os.path.join(root, "c3")
        base = cli + ["--device", dev.type]
        first = train_cli.main(base + ["--checkpoint", d3])
        second = train_cli.main(_set_flag(base, "-e", "2")
                                + ["--resume", d3, "--checkpoint", d3])
        n2 = file_io.latest_checkpoint(d3)[2]
        if not (second.state["epoch"] == 3
                and n2 == second.state["neval"] - 1
                and n2 > first.state["neval"] - 1):
            raise AssertionError(f"C3: resumed run ended at epoch "
                                 f"{second.state['epoch']}, iteration "
                                 f"{second.state['neval'] - 1}, newest "
                                 f"checkpoint {n2}")
        seq = cli[cli.index("--seqLength") + 1]
        results, words = eval_cli.main(
            ["--model", os.path.join(d3, f"model.{n2}"), "--dictionary",
             os.path.join(d3, "dictionary.json"), "--synthetic", "--packed",
             "-b", cli[cli.index("-b") + 1], "--seqLength", seq,
             "--generate", str(ckpt["generate"]), "--device", dev.type])
        (_, loss), = results
        if not (np.isfinite(loss.result()[0])
                and len(words) == 1 + ckpt["generate"]):
            raise AssertionError(f"C3: eval loss {loss}, words {words}")
        out["c3"] = dict(first=first.state["neval"] - 1, resumed_to=n2,
                         loss=loss.result()[0])
        log(f"[ckpt] C3 train CLI --checkpoint: {first.state['neval'] - 1} "
            f"iterations; --resume: to iteration {n2} (epoch 2); eval CLI "
            f"{loss}, generated: {' '.join(words)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = _launches()
    release(dev)
    return out


def gpt2_state_dict(config, seed):
    """A GPT-2-shaped state dict with Hugging Face's key names
    (``transformer.`` prefix, a tied ``lm_head``), drawn from ``seed``
    (N(0, 0.02) weights, N(1, 0.02) norm scales)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    h, v, f = config["hidden_size"], config["vocab_size"], config["ffn_size"]

    def w(*shape, mean=0.0):
        return torch.randn(shape, generator=g) * 0.02 + mean

    sd = {"wte.weight": w(v, h), "wpe.weight": w(config["max_len"], h),
          "ln_f.weight": w(h, mean=1.0), "ln_f.bias": w(h)}
    for i in range(config["n_layers"]):
        p = f"h.{i}."
        sd.update({p + "ln_1.weight": w(h, mean=1.0), p + "ln_1.bias": w(h),
                   p + "attn.c_attn.weight": w(h, 3 * h),
                   p + "attn.c_attn.bias": w(3 * h),
                   p + "attn.c_proj.weight": w(h, h),
                   p + "attn.c_proj.bias": w(h),
                   p + "ln_2.weight": w(h, mean=1.0), p + "ln_2.bias": w(h),
                   p + "mlp.c_fc.weight": w(h, f), p + "mlp.c_fc.bias": w(f),
                   p + "mlp.c_proj.weight": w(f, h),
                   p + "mlp.c_proj.bias": w(h)})
    sd = {"transformer." + k: t for k, t in sd.items()}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def phase_gpt2(dev, config=GPT2_SMALL, gpt2=GPT2):
    """G1: a GPT-2-small-shaped state dict from seed 0, torch.save'd to a
    temporary file, imported and decoded by the port's
    ``example/gpt2_import.py --checkpoint`` on the device; the tokens
    held against offline generate on plain attention of the imported
    weights; export then import is bitwise a round trip."""
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch.example import gpt2_import
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.io import (export_gpt2_state_dict,
                                                       load_gpt2_state_dict)
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    sd = gpt2_state_dict(config, gpt2["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt2.pth")
        torch.save(sd, path)
        size = os.path.getsize(path)
        _reset_launches()
        t0 = time.perf_counter()
        got = gpt2_import.main(
            ["--checkpoint", path, "--vocab", str(config["vocab_size"]),
             "--hidden", str(config["hidden_size"]),
             "--layers", str(config["n_layers"]),
             "--heads", str(config["n_head"]),
             "--maxLen", str(config["max_len"]), "--prompt", gpt2["prompt"],
             "--maxNewTokens", str(gpt2["new_tokens"]),
             "--device", dev.type])
        wall = time.perf_counter() - t0
        launches = _launches()
    plain = load_gpt2_state_dict(TransformerLM(
        attention_impl="xla", device=dev, **config), sd)
    oracle = Oracle(dev, config, 0, make_model=lambda: plain)
    prompt = np.array([int(t) + 1 for t in gpt2["prompt"].split(",")])
    tie = oracle.check(prompt, np.concatenate([prompt, np.asarray(got) + 1]),
                       gpt2["new_tokens"])
    clone = load_gpt2_state_dict(TransformerLM(device=dev, **config),
                                 export_gpt2_state_dict(plain))
    for a, b in zip(tree_leaves(plain.params), tree_leaves(clone.params)):
        if not torch.equal(a, b):
            raise AssertionError("G1: export then import is not bitwise")
    log(f"[gpt2] G1 {size} bytes of state dict; example --checkpoint "
        f"generated {got} in {wall:.2f} s (import included), "
        f"{'identical to offline generate' if tie is None else tie}; export "
        f"then import bitwise; launches {launches}")
    del plain, clone, oracle, sd
    release(dev)
    return dict(ids=got, launches=launches, bytes=size, wall_s=wall, tie=tie)


# --------------------------------------------------------------------------- #
def _obs_adam_classes():
    """Adam subclasses for O4 and O5 (defined late: importing the port's
    optim at module level would import torch before the device check)."""
    from bigdl_tpu_torch.optim import Adam

    class SleepyAdam(Adam):
        """Adam whose ``at``-th update sleeps ``s`` seconds while staging:
        inside the loop's step bracket, past the watchdog's deadline."""

        def __init__(self, at, s, **kw):
            super().__init__(**kw)
            self.at, self.s, self.updates = at, s, 0

        def stage(self, grads, state, params, epoch=1):
            self.updates += 1
            if self.updates == self.at:
                time.sleep(self.s)
            return super().stage(grads, state, params, epoch)

    class FailingAdam(Adam):
        """Adam whose ``fail_at``-th update raises after staging one leaf
        (``fail_at`` None: never)."""

        def __init__(self, fail_at=None, **kw):
            super().__init__(**kw)
            self.fail_at, self.updates, self.staged_leaves = fail_at, 0, 0

        def stage(self, grads, state, params, epoch=1):
            self.updates += 1
            self.staged_leaves = 0
            return super().stage(grads, state, params, epoch)

        def _post_step(self, w_new, w_old, lr):
            self.staged_leaves += 1
            if self.updates == self.fail_at and self.staged_leaves == 2:
                raise RuntimeError("injected failure inside update")
            return super()._post_step(w_new, w_old, lr)

    class InPlaceAdam(Adam):
        """The update before stage-then-commit: each leaf's moments and
        weight overwritten in place as the loop walks them (a user's
        in-place method to the loop).  Timed beside the staged update."""

        def update(self, grads, state, params, epoch=1):
            import torch
            from bigdl_tpu_torch.utils.pytree import tree_leaves
            with torch.no_grad():
                lr = self.current_rate(state, epoch)
                t = state["iteration"] + 1
                b1, b2 = self.beta1, self.beta2
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                for w, g, m, v in zip(tree_leaves(params),
                                      tree_leaves(grads),
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"])):
                    g = self._decayed(g, w)
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    w_new = w - lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                  + self.eps)
                    w.copy_(self._post_step(w_new, w, lr))
                state["iteration"] = t
            return params, state

    class FailingInPlaceAdam(InPlaceAdam):
        """InPlaceAdam whose ``fail_at``-th update raises after writing
        its first leaf and the second leaf's moments in place."""

        def __init__(self, fail_at=None, **kw):
            super().__init__(**kw)
            self.fail_at, self.updates, self.leaves = fail_at, 0, 0

        def update(self, grads, state, params, epoch=1):
            self.updates, self.leaves = self.updates + 1, 0
            return super().update(grads, state, params, epoch)

        def _post_step(self, w_new, w_old, lr):
            self.leaves += 1
            if self.updates == self.fail_at and self.leaves == 2:
                raise RuntimeError("injected failure inside update")
            return super()._post_step(w_new, w_old, lr)

    return SleepyAdam, FailingAdam, InPlaceAdam, FailingInPlaceAdam


def obs_prompts(obs, n):
    """``n`` seeded prompts, their lengths cycling ``obs["prompt_lens"]``
    (O2's requests, O3's tail traffic)."""
    import numpy as np
    rng = np.random.RandomState(obs["prompt_seed"])
    lens = obs["prompt_lens"]
    return [rng.randint(1, obs["vocab"] + 1, size=lens[i % len(lens)])
            .astype(np.int32) for i in range(n)]


def _pct_ms(values, q):
    import numpy as np
    return float(np.percentile(values, q)) * 1e3 if values else None


def _flight_recorder(root, name):
    """The process-wide flight recorder armed into a directory of
    ``root`` (bundles and incident log both), and the recorder it
    replaced."""
    from bigdl_tpu_torch.obs import flight
    old = flight.get_flight_recorder()
    d = os.path.join(root, name)
    rec = flight.configure(enabled=True, out_dir=d,
                           incidents_path=os.path.join(d, "INCIDENTS.json"))
    return rec, old


def _bundles(rec):
    import glob
    return [json.load(open(p)) for p in
            sorted(glob.glob(os.path.join(rec.out_dir, "FLIGHT_*.json")))]


def obs_load_point(engine, gen):
    """One open-loop load point (the reference's lifecycle row): replay
    the trace, drain every accepted stream, and sort them into
    completed, truncated, typed shed and lost; ``good`` = completed
    inside its deadline.  Streams are kept for the agreement check."""
    import numpy as np
    from bigdl_tpu_torch.serving import ServingDeadlineExceeded
    t0 = time.perf_counter()
    report = gen.run(lambda a: engine.submit(
        a.prompt, max_new_tokens=a.max_new, deadline_s=a.deadline_s))
    done, truncated, shed_after, lost = [], [], 0, []
    good, ttfts = 0, []
    for a, st in report.accepted:
        try:
            st.result(timeout=600)
        except ServingDeadlineExceeded:
            shed_after += 1
            continue
        except Exception as e:  # noqa: BLE001 - a loss is data here
            lost.append((a.index, repr(e)))
            continue
        if st.truncation is not None:
            truncated.append((a, st.generated.copy()))
            continue
        done.append((a, st.generated.copy()))
        ttfts.append(st.ttft_s)
        lat = st.finished_at - st.submitted_at
        if a.deadline_s is None or lat <= a.deadline_s:
            good += 1
    wall = time.perf_counter() - t0
    s = report.summary()
    return dict(rate_rps=gen.rate_rps, offered=report.offered,
                offered_rps=s["offered_rps"], accepted=len(report.accepted),
                shed=len(report.shed), submit_errors=len(report.errors),
                completed=len(done), truncated=len(truncated),
                shed_after_admission=shed_after, accepted_loss=len(lost),
                lost=lost, good=good, wall_s=wall,
                goodput_rps=good / wall if wall > 0 else None,
                ttft_p50_ms=_pct_ms(ttfts, 50), ttft_p99_ms=_pct_ms(ttfts, 99),
                streams=done, truncated_streams=truncated)


def obs_agreement(row, oracle, sample=None, seed=0):
    """Completed streams (all, or a seeded sample of ``sample``) against
    offline generate at batch 1; truncated ones as prefixes.  Returns
    (checked, agreeing, ties)."""
    import numpy as np
    streams = list(row["streams"])
    if sample is not None and len(streams) > sample:
        pick = np.random.RandomState(seed).choice(len(streams), sample,
                                                  replace=False)
        streams = [streams[i] for i in sorted(pick)]
    checked = agree = 0
    ties = []
    for a, gen in streams:
        checked += 1
        tie = oracle.check(a.prompt, np.concatenate([a.prompt, gen]),
                           a.max_new)
        agree += 1
        if tie is not None:
            ties.append(tie)
    for a, gen in (row["truncated_streams"] if sample is None else []):
        checked += 1
        want = oracle.stream(a.prompt, a.max_new)[len(a.prompt):]
        if not np.array_equal(gen, want[:len(gen)]):
            raise AssertionError(f"O1: a truncated stream of {len(gen)} "
                                 "tokens is not a prefix of offline "
                                 "generate's")
        agree += 1
    return checked, agree, ties


def phase_obs(dev, config=GPT2_SMALL, serve=SERVE, train=TRAIN, obs=None,
              ckpt=CKPT, train_ref=None, oracle=None):
    """O1-O5 (see the module docstring): the load sweep and its knee, the
    memory ledger and its admission gate, chaos over a speculative
    engine, train summaries with the watchdog's escalation, and the
    emergency checkpoint after a failure inside the update.  Every
    bundle and incident file goes to a temporary directory, removed at
    the end.  Returns each part's numbers and launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch.obs import (MemoryLedger, TimeSeriesSampler,
                                     get_registry, get_tracer, set_ledger,
                                     set_sampler)
    from bigdl_tpu_torch.obs import flight
    from bigdl_tpu_torch.traffic import (ChaosReplayer, TraceLoadGenerator,
                                         append_incident, build_schedule,
                                         detect_knee)
    obs = dict(OBS, **(obs or {}))
    release(dev)
    root = tempfile.mkdtemp(prefix="obs_")
    led = MemoryLedger()
    old_ledger = set_ledger(led)
    sampler = TimeSeriesSampler(get_registry(), interval_s=obs["sample_s"],
                                capacity=4096)
    old_sampler = set_sampler(sampler)
    old_rec = flight.get_flight_recorder()
    out = {}
    model = engine = None
    try:
        model = build_lm(dev, config, serve["seed"])
        oracle = oracle or Oracle(dev, config, serve["seed"])
        # the oracle's weights are a second copy on the card: attributed,
        # so the drift is the allocator's slack and nothing else's
        if dev.type == "cuda":
            from bigdl_tpu_torch.quant.transform import params_nbytes
            led.register("params", "oracle/plain_model",
                         params_nbytes(oracle.model.params),
                         note="offline generate's plain-attention copy")
        sampler.start()
        before = led.reconcile(dev)
        engine = make_engine(model, dev, serve, name="obs")
        t0 = time.perf_counter()
        engine.warmup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        captures = engine.graphs.stats()["captures"]
        warm = led.reconcile(dev)
        log(f"[obs] engine warm in {time.perf_counter() - t0:.2f} s, "
            f"{captures} captures; drift before the engine "
            f"{before['drift_bytes']}, after its warmup "
            f"{warm['drift_bytes']} bytes")
        out["o1"] = obs_sweep(engine, oracle, obs, config["vocab_size"])
        if engine.graphs.stats()["captures"] != captures:
            raise AssertionError(f"O1: {engine.graphs.stats()['captures']} "
                                 f"captures after the sweep, {captures} "
                                 "after warmup")
        out["o2"] = obs_ledger(dev, engine, led, oracle, obs, serve, root,
                               before, warm)
        engine.close()
        engine = None
        ws = _cublas_workspace_bytes(dev)
        out["o2"]["cublas_workspace_bytes"] = ws
        log(f"[obs] O2 cuBLAS workspaces held while the engine served "
            f"(freed after it closed): {ws} bytes, of the "
            f"{out['o2']['remainder'].get('unregistered_live')} unregistered "
            f"live bytes")
        release(dev)
        out["o3"] = obs_chaos(dev, model, oracle, obs, serve, root,
                              out["o1"]["knee"]["knee_rps"],
                              config["vocab_size"])
        del model
        model = None
        sampler.stop()
        release(dev)
        out["o4"] = obs_train(dev, config, train, obs, root)
        release(dev)
        out["o5"] = obs_update_failure(dev, config, train, obs, ckpt, root,
                                       train_ref)
    finally:
        if engine is not None:
            engine.close()
        sampler.stop()
        set_sampler(old_sampler)
        set_ledger(old_ledger)
        flight._GLOBAL = old_rec
        get_tracer().disable()
        shutil.rmtree(root, ignore_errors=True)
        release(dev)
    return out


def obs_sweep(engine, oracle, obs, vocab):
    """O1: open-loop poisson traces at rising rates until the knee
    saturates; every completed stream at or below the knee (and a
    seeded sample of 16 above it) held against offline generate."""
    from bigdl_tpu_torch.traffic import TraceLoadGenerator, detect_knee
    rows, rates = [], list(obs["rates"])
    while True:
        rate = rates.pop(0)
        # a seed a rate: the same seed at two rates draws the same
        # prompts, and a repeat is a radix hit no warmup covered
        gen = TraceLoadGenerator(
            kind="poisson", rate_rps=rate, duration_s=obs["duration_s"],
            seed=len(rows), vocab=vocab,
            prompt_lens=obs["prompt_lens"], max_news=obs["max_news"],
            deadline_menu=obs["deadline_menu"])
        _reset_launches()
        row = obs_load_point(engine, gen)
        row["launches"] = _launches()
        if row["accepted_loss"]:
            raise AssertionError(f"O1 at {rate} rps: accepted requests "
                                 f"lost: {row['lost'][:3]}")
        rows.append(row)
        log(f"[obs] O1 {rate} rps: offered {row['offered']} "
            f"({row['offered_rps']} rps), accepted {row['accepted']}, shed "
            f"{row['shed']} + {row['shed_after_admission']} after admission, "
            f"completed {row['completed']}, truncated {row['truncated']}, "
            f"good {row['good']}, goodput {row['goodput_rps']:.3f} rps, "
            f"TTFT p50 {row['ttft_p50_ms']} ms p99 {row['ttft_p99_ms']} ms, "
            f"wall {row['wall_s']:.2f} s")
        knee = detect_knee(rows)
        if not rates:
            if knee["saturated"] or rate * 2 > obs["max_rate"]:
                break
            rates.append(rate * 2)
    if not knee["saturated"]:
        raise AssertionError(f"O1: no saturation up to {rows[-1]['rate_rps']}"
                             f" rps: {knee}")
    ties_all = []
    for row in rows:
        above = row["offered_rps"] > knee["knee_rps"]
        checked, agree, ties = obs_agreement(
            row, oracle, sample=obs["agreement_sample"] if above else None,
            seed=int(row["rate_rps"]))
        row["agreement"] = agree / checked if checked else None
        row["checked"] = checked
        ties_all += ties
        if checked and agree != checked:
            raise AssertionError(f"O1 at {row['rate_rps']} rps: agreement "
                                 f"{agree}/{checked}")
    launches = {}
    for row in rows:
        for k, v in row.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        row.pop("streams")
        row.pop("truncated_streams")
    log(f"[obs] O1 knee {knee}; agreement "
        f"{[(r['rate_rps'], r['checked'], r['agreement']) for r in rows]}; "
        f"ties {ties_all}")
    return dict(rows=rows, knee=knee, launches=launches, ties=ties_all,
                checks=[("obs O1 (load sweep) path", launches,
                         ("bigdl_flash_fwd", "bigdl_paged_decode"), None)])


def obs_ledger(dev, engine, led, oracle, obs, serve, root, before, warm):
    """O2: the ledger against the allocator before the engine
    (``before``), after its warmup (``warm``) and after the sweep, then
    with the allocator's cache emptied, the drift split into cache and
    unregistered live tensors; then the byte-level admission gate: a
    budget the card already crosses defers 4 requests and dumps one
    mem_pressure bundle; lifting it admits them, streams exact."""
    import numpy as np
    import torch
    swept = led.reconcile(dev)
    if dev.type == "cuda":
        # cached free segments go back to the device (the graph pool is
        # private and stays)
        torch.cuda.empty_cache()
    rec = led.reconcile(dev)
    attr = led.attribution()
    rows = {r["name"]: r for r in led.entries()}
    kv = rows["obs/kv_arena"]["nbytes"]
    params = rows["obs/staged"]["nbytes"]
    if kv != obs["kv_arena_bytes"] or params != obs["params_bytes"]:
        raise AssertionError(f"O2: kv arena {kv} / params {params} bytes, "
                             f"not {obs['kv_arena_bytes']} / "
                             f"{obs['params_bytes']}")
    if dev.type == "cuda" and rec["verdict"] != "reconciled":
        raise AssertionError(f"O2: verdict {rec['verdict']} on the card")
    remainder = {}
    if rec["backend_bytes_in_use"] is not None:
        # drift = the allocator's cached free bytes outside the graph
        # pool + live tensors outside it that nobody registered (the
        # pool's segments count whole on both sides)
        pool = attr.get("graphs", 0)
        live_outside = rec["backend_allocated_bytes"] - _pool_live_bytes(
            engine)
        remainder = {
            "allocator_cache": rec["backend_bytes_in_use"] - pool
            - live_outside,
            "unregistered_live": live_outside
            - (rec["ledger_bytes"] - pool)}
    log(f"[obs] O2 drift before the engine {before['drift_bytes']}, after "
        f"warmup {warm['drift_bytes']}, after the sweep "
        f"{swept['drift_bytes']} bytes; with the cache emptied: "
        f"ledger {rec['ledger_bytes']} bytes, backend "
        f"in use (allocator reserved) {rec['backend_bytes_in_use']}, drift "
        f"{rec['drift_bytes']} ({rec['verdict']}); allocated "
        f"{rec.get('backend_allocated_bytes')}, device used "
        f"{rec.get('backend_device_used_bytes')}, limit "
        f"{rec.get('backend_bytes_limit')}; attribution {attr}; kv arena "
        f"{kv}, params {params}; remainder {remainder}")
    rec_f, _ = _flight_recorder(root, "o2")
    prompts = obs_prompts(obs, obs["pressure_requests"])
    try:
        led.budget_bytes = max(1, int(led.backend_stats(dev)["bytes_in_use"])
                               if dev.type == "cuda" else 1)
        _reset_launches()
        streams = [engine.submit(p, max_new_tokens=serve["max_new"])
                   for p in prompts]
        t0 = time.perf_counter()
        while rec_f.bundles_written < 1 and time.perf_counter() - t0 < 30:
            time.sleep(0.01)
        time.sleep(obs["defer_s"])
        deferred = sum(not s.done() for s in streams)
        started = sum(s.first_token_at is not None for s in streams)
        bundles = _bundles(rec_f)
        led.budget_bytes = None
        results = [s.result(timeout=600) for s in streams]
        launches = _launches()
    finally:
        led.budget_bytes = None
    kinds = [b["flight"] for b in bundles]
    if deferred != len(prompts) or started or kinds != ["mem_pressure"]:
        raise AssertionError(f"O2: {deferred} of {len(prompts)} deferred, "
                             f"{started} started, bundles {kinds}")
    table = bundles[0]["detail"]["table"]
    if not {"obs/kv_arena", "obs/staged"} <= {r["name"] for r in table}:
        raise AssertionError("O2: the mem_pressure bundle lacks the table")
    ties = check_streams("obs O2", oracle, prompts, results, serve["max_new"])
    log(f"[obs] O2 gate: {deferred} of {len(prompts)} admissions deferred "
        f"past the watermark, one mem_pressure bundle "
        f"(used_fraction {bundles[0]['detail']['used_fraction']}, "
        f"{len(table)} table rows); budget lifted: {len(results)} streams "
        f"equal offline generate ({len(ties)} ties)")
    return dict(reconcile=rec, before=before, warm=warm, swept=swept,
                attribution=attr, kv_arena_bytes=kv,
                params_bytes=params, remainder=remainder, deferred=deferred,
                bundle=bundles[0]["detail"], ties=ties, launches=launches,
                checks=[("obs O2 (admission gate) path", launches,
                         ("bigdl_flash_fwd", "bigdl_paged_decode"), None)])


def _cublas_workspace_bytes(dev):
    """Bytes of the cuBLAS workspaces (one per handle and stream cuBLAS
    has run on), measured by freeing them: only once no live graph
    captured one."""
    import gc

    import torch
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if dev.type != "cuda" or clear is None:
        return None
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    clear()
    return before - torch.cuda.memory_allocated(dev)


def _pool_live_bytes(engine):
    """Bytes of live blocks inside the engine's graph pool (the pool's
    share of the allocator's allocated bytes)."""
    import torch
    if not engine.graphs.capture:
        return 0
    live = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", ())) == tuple(engine.graphs.pool):
            live += int(seg.get("allocated_size", 0))
    return live


def obs_chaos(dev, model, oracle, obs, serve, root, knee_rps, vocab):
    """O3: serving.verify and serving.enqueue transients, scheduled by
    build_schedule from an incident log, fired by a ChaosReplayer over a
    poisson trace at half the knee on a speculative engine (the target
    drafting itself, greedy), with the tracer and the sampler on: zero
    accepted loss, every stream exact, one bundle per site."""
    import numpy as np
    from bigdl_tpu_torch.obs import get_tracer
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import SpecConfig
    from bigdl_tpu_torch.traffic import (ChaosReplayer, TraceLoadGenerator,
                                         append_incident, build_schedule)
    log_path = os.path.join(root, "o3_incidents.json")
    gap = obs["chaos_gap_s"]
    for i, (stage, rc) in enumerate(obs["chaos_stages"]):
        append_incident(stage, rc, log_path, now=1000.0 + gap * i)
    schedule = build_schedule(obs["duration_s"], path=log_path,
                              seed=obs["chaos_seed"])
    sites = {e["site"] for e in schedule}
    if sites != {"serving.verify", "serving.enqueue"}:
        raise AssertionError(f"O3: schedule sites {sites}")
    rate = max(1.0, knee_rps / 2.0)
    gen = TraceLoadGenerator(
        kind="poisson", rate_rps=rate, duration_s=obs["duration_s"],
        seed=obs["chaos_trace_seed"], vocab=vocab,
        prompt_lens=obs["prompt_lens"],
        max_news=obs["max_news"])
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    rec, _ = _flight_recorder(root, "o3")
    os.environ.pop(faults.ENV_SPEC, None)
    faults.refresh_from_env()
    engine = make_engine(model, dev, serve, name="obs-chaos",
                         spec=SpecConfig(k=obs["chaos_k"], draft=model))
    try:
        engine.warmup()
        _reset_launches()
        with ChaosReplayer(schedule, seed=obs["chaos_seed"]) as chaos:
            report = gen.run(lambda a: engine.submit(
                a.prompt, max_new_tokens=a.max_new))
            results = []
            for a, st in report.accepted:
                results.append((a, st.result(timeout=600)))
            # events armed after the last arrival meet a tail of traffic
            t0 = time.perf_counter()
            extra = 0
            while (chaos.summary()["fired"] < len(schedule)
                   and time.perf_counter() - t0 < 30):
                p = obs_prompts(obs, extra + 1)[extra]
                extra += 1
                try:
                    results.append((None, (p, engine.generate(
                        p, max_new_tokens=8, timeout=600))))
                except Exception as e:  # noqa: BLE001 - typed sheds only
                    from bigdl_tpu_torch.serving import ServingOverloaded
                    if not isinstance(e, ServingOverloaded):
                        raise
            summary = chaos.summary()
        launches = _launches()
    finally:
        engine.close()
        tracer.disable()
    if report.errors or summary["fired"] != len(schedule):
        raise AssertionError(f"O3: submit errors {report.errors[:3]}, "
                             f"fired {summary['fired']} of {len(schedule)}")
    ties = []
    for a, got in results:
        if a is None:
            p, r = got
            tie = oracle.check(p, r, 8)
        else:
            tie = oracle.check(a.prompt, got, a.max_new)
        if tie is not None:
            ties.append(tie)
    bundles = _bundles(rec)
    by_site = {}
    for b in bundles:
        by_site.setdefault(b["detail"].get("site"), []).append(b)
    if sorted(by_site) != ["serving.enqueue", "serving.verify"] or \
            any(len(v) != 1 for v in by_site.values()):
        raise AssertionError(f"O3: bundles by site "
                             f"{ {k: len(v) for k, v in by_site.items()} }")
    for site, (b,) in by_site.items():
        missing = [k for k in ("spans", "timeseries", "diagnose_cuda")
                   if not b[k]]
        if missing or "lm_engine/obs-chaos" not in b["state"] or \
                "lm_engine/obs-chaos" not in b["active_requests"]:
            raise AssertionError(f"O3: the {site} bundle lacks {missing} "
                                 "or the engine's state/requests")
    log(f"[obs] O3 {rate:.1f} rps: offered {report.offered}, accepted "
        f"{len(report.accepted)}, shed {len(report.shed)} (typed), accepted "
        f"loss 0, {len(results)} streams equal offline generate "
        f"({len(ties)} ties); schedule {summary['events']}; fired "
        f"{summary['fired']}; one bundle per site "
        f"({ {k: len(v[0]['spans']) for k, v in by_site.items()} } spans, "
        f"{ {k: len(v[0]['timeseries']) for k, v in by_site.items()} } "
        f"time-series rows); launches {launches}")
    return dict(rate_rps=rate, offered=report.offered,
                accepted=len(report.accepted), shed=len(report.shed),
                streams=len(results), fired=summary["fired"],
                bundles={k: len(v) for k, v in by_site.items()},
                launches=launches, ties=ties,
                checks=[("obs O3 (chaos, speculative) path", launches,
                         ("bigdl_flash_fwd",), None)])


def obs_train(dev, config, train, obs, root):
    """O4: 6 Adam steps on the train batch with Loss, Throughput and
    LearningRate summaries every step, Parameters every 3 and a
    validation summary; the 5th update sleeps past the watchdog's
    deadline: one stall bundle, and an emergency pair at iteration 5
    equal to the run's weights there."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.obs import get_registry
    from bigdl_tpu_torch.optim import Loss, Trigger
    from bigdl_tpu_torch.optim.optimizer import named_leaves
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.visualization import (TrainSummary, ValidationSummary,
                                               list_tags, read_records,
                                               decode_event)
    SleepyAdam = _obs_adam_classes()[0]
    x, y = _train_batch(config, train)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    model = TransformerLM(attention_impl="flash", device=dev,
                          **config).build(seed=train["seed"])
    opt = _optimizer(model, x, y, train["batch"], train["learning_rate"])
    opt.set_optim_method(SleepyAdam(obs["stall_at"], obs["stall_s"],
                                    learning_rate=train["learning_rate"]))
    logdir = os.path.join(root, "tb")
    ts = TrainSummary(logdir, "obs")
    ts.set_summary_trigger("Parameters",
                           Trigger.several_iteration(obs["params_every"]))
    vs = ValidationSummary(logdir, "obs")
    val = DataSet.array([Sample(f, l) for f, l in zip(x, y)]) \
        >> SampleToBatch(train["batch"])
    opt.set_train_summary(ts).set_validation_summary(vs).set_validation(
        Trigger.several_iteration(obs["params_every"]), val, [Loss(crit)])
    ck = os.path.join(root, "o4_ckpt")
    opt.set_checkpoint(ck, Trigger(lambda s: False, "never"))
    rec, _ = _flight_recorder(root, "o4")
    snap = {}
    stall_ckpt = opt._maybe_stall_checkpoint

    def snapshot_then_checkpoint():
        if opt._stall_ckpt_requested:
            snap["iteration"] = opt.state["neval"] - 1
            snap["params"] = {n: t.detach().clone()
                              for n, t in named_leaves(model.params)}
        stall_ckpt()

    opt._maybe_stall_checkpoint = snapshot_then_checkpoint
    env = {"BIGDL_TPU_WATCHDOG": "1",
           "BIGDL_TPU_WATCHDOG_DEADLINE_S": str(obs["watchdog_deadline_s"])}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    emerg = get_registry().counter("resilience/emergency_checkpoints").value
    _reset_launches()
    try:
        losses, step_s = run_iterations(opt, obs["steps"])
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = _launches()
    ts.flush()
    vs.flush()
    emerg = get_registry().counter(
        "resilience/emergency_checkpoints").value - emerg
    stalls = [b for b in _bundles(rec) if b["flight"] == "stall"]
    found = file_io.latest_checkpoint(ck)
    if len(stalls) != 1 or emerg != 1 or found is None or \
            found[2] != obs["stall_at"] or snap.get("iteration") != found[2]:
        raise AssertionError(f"O4: {len(stalls)} stall bundles, emergency "
                             f"+{emerg}, pair {found}, snapshot at "
                             f"{snap.get('iteration')}")
    saved = TransformerLM.load(found[0], device=dev)
    for name, t in named_leaves(saved.params):
        if not torch.equal(t, snap["params"][name]):
            raise AssertionError(f"O4: the pair's {name} differs from the "
                                 "run's weights at that iteration")
    got = [v for _, v, _ in ts.read_scalar("Loss")]
    if got != [float(np.float32(v)) for v in losses]:
        raise AssertionError(f"O4: Loss scalars {got} vs the loop's {losses}")
    hist = {}
    for payload in read_records(ts.writer._event_writer.path):
        ev = decode_event(payload)
        for v in ev.values:
            if v.histo is not None:
                hist.setdefault(ev.step, []).append(v.tag)
    leaves = sorted(n for n, _ in named_leaves(model.params))
    want_steps = [s for s in range(1, obs["steps"] + 1)
                  if s % obs["params_every"] == 0]
    if sorted(hist) != want_steps or any(sorted(t) != leaves
                                         for t in hist.values()):
        raise AssertionError(f"O4: histograms at {sorted(hist)} "
                             f"({ {k: len(v) for k, v in hist.items()} })")
    vloss = vs.read_scalar("Loss")
    n_val = len(vloss)
    per = config["n_layers"]
    sc, pm = opt.summary_ms["scalars"], opt.summary_ms["parameters"]
    log(f"[obs] O4 {obs['steps']} steps, losses "
        f"{[round(v, 4) for v in losses]}; stall bundle "
        f"(inflight {stalls[0]['detail']['inflight_s']} s, threshold "
        f"{stalls[0]['detail']['threshold_s']} s); emergency pair at "
        f"iteration {found[2]} equal to the run's weights; Loss scalars "
        f"equal the loop's; {len(leaves)} histograms at steps {want_steps}; "
        f"{n_val} validation scalars; one scalar step "
        f"{statistics.median(sc):.3f} ms (median of {len(sc)}), one "
        f"Parameters record {statistics.median(pm):.1f} ms (median of "
        f"{len(pm)}); launches {launches}")
    ts.close()
    vs.close()
    del opt, model, saved, snap
    return dict(losses=losses, stall=stalls[0]["detail"], pair=found[2],
                scalar_ms=sc, parameters_ms=pm, launches=launches,
                validations=n_val,
                checks=[("obs O4 training path", launches,
                         ("bigdl_flash_bwd_dkv", "bigdl_flash_bwd_dq"),
                         per * obs["steps"]),
                        ("obs O4 forward (steps and validations)", launches,
                         ("bigdl_flash_fwd",), per * (obs["steps"] + n_val))])


def obs_update_failure(dev, config, train, obs, ckpt, root, train_ref):
    """O5: the train batch, Adam raising inside the update of iteration 3
    after staging one leaf: the emergency pair is iteration 2, and a
    fresh model resuming it and finishing equals the uninterrupted run
    within C1's tolerances.  The uninterrupted run is timed (staged
    updates) beside the same steps with the update in place."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.obs import get_registry
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.utils import file_io
    _, FailingAdam, InPlaceAdam, FailingInPlaceAdam = _obs_adam_classes()
    x, y = _train_batch(config, train)
    lr = train["learning_rate"]
    n = obs["o5_steps"]

    def fresh(seed=train["seed"]):
        return TransformerLM(attention_impl="flash", device=dev,
                             **config).build(seed=seed)

    def opt_for(model, method):
        return _optimizer(model, x, y, train["batch"], lr).set_optim_method(
            method)

    timing = {}
    _reset_launches()
    for label, method in (("in_place", InPlaceAdam), ("staged", Adam),
                          ("in_place_2", InPlaceAdam), ("staged_2", Adam)):
        model = fresh()
        _peak_reset(dev)
        losses, step_s = run_iterations(opt_for(model, method(
            learning_rate=lr)), 1 + n)
        timing[label] = dict(step_ms=float(np.median(step_s)) * 1e3,
                             peak_bytes=_peak(dev), losses=losses)
        if label == "staged":
            model_a, losses_a = model, losses
        else:
            del model
        release(dev)
    d = os.path.join(root, "o5")
    model_b = fresh()
    opt_b = opt_for(model_b, FailingAdam(fail_at=obs["fail_at"],
                                         learning_rate=lr))
    opt_b.set_checkpoint(d, Trigger(lambda s: False, "never"))
    emerg = get_registry().counter("resilience/emergency_checkpoints").value
    try:
        run_iterations(opt_b, 1 + n)
    except RuntimeError as e:
        if "inside update" not in str(e):
            raise
    else:
        raise AssertionError("O5: the failure inside update did not surface")
    emerg = get_registry().counter(
        "resilience/emergency_checkpoints").value - emerg
    found = file_io.latest_checkpoint(d)
    if emerg != 1 or found is None or found[2] != obs["fail_at"] - 1 or \
            opt_b.optim_method.staged_leaves != 2:
        raise AssertionError(f"O5: emergency +{emerg}, pair {found}, "
                             f"{opt_b.optim_method.staged_leaves} leaves "
                             "staged before the failure")
    del opt_b, model_b
    release(dev)
    # a user's in-place method failing midway: the loop rolls its partial
    # writes back to the snapshot and writes the same iteration's pair
    d_ip = os.path.join(root, "o5_in_place")
    model_ip = fresh()
    opt_ip = opt_for(model_ip, FailingInPlaceAdam(fail_at=obs["fail_at"],
                                                  learning_rate=lr))
    opt_ip.set_checkpoint(d_ip, Trigger(lambda s: False, "never"))
    emerg_ip = get_registry().counter(
        "resilience/emergency_checkpoints").value
    try:
        run_iterations(opt_ip, 1 + n)
    except RuntimeError as e:
        if "inside update" not in str(e):
            raise
    else:
        raise AssertionError("O5: the in-place failure did not surface")
    emerg_ip = get_registry().counter(
        "resilience/emergency_checkpoints").value - emerg_ip
    found_ip = file_io.latest_checkpoint(d_ip)
    if emerg_ip != 1 or found_ip is None or \
            found_ip[2] != obs["fail_at"] - 1:
        raise AssertionError(f"O5 in place: emergency +{emerg_ip}, pair "
                             f"{found_ip}")
    saved = file_io.load(found_ip[0])["params"]
    for (path, a), (_, b) in zip(_named_leaves(model_ip.params),
                                 _named_leaves(saved)):
        if not np.array_equal(a.cpu().numpy(), b):
            raise AssertionError(f"O5 in place: leaf {path} differs from "
                                 "the pair's: the partial write survived")
    log(f"[obs] O5 in-place user method failing inside update "
        f"{obs['fail_at']} after writing one leaf: emergency pair at "
        f"{found_ip[2]}, the rolled-back weights bitwise the pair's")
    del opt_ip, model_ip, saved
    release(dev)
    model_c = fresh(seed=train["seed"] + 1)
    opt_c = opt_for(model_c, FailingAdam(learning_rate=lr))
    opt_c.resume_from(d)
    losses_c, _ = run_iterations(opt_c, 1 + n - found[2])
    rels = [abs(a - c) / abs(a) for a, c in
            zip(losses_a[found[2]:], losses_c)]
    if not max(rels) <= TOL_LOSS:
        raise AssertionError(f"O5: resumed losses {losses_c} vs "
                             f"uninterrupted {losses_a[found[2]:]}")
    worst = 0.0
    for (path, a), (_, c) in zip(_named_leaves(model_a.params),
                                 _named_leaves(model_c.params)):
        ratio = (a - c).abs().max().item() / max(a.abs().max().item(),
                                                 1e-30)
        worst = max(worst, ratio)
    if not worst <= ckpt["tol_param"]:
        raise AssertionError(f"O5: a resumed leaf's max |dw| is {worst:.3e} "
                             "of its max |w|")
    launches = _launches()
    # 4 timed runs, the two failing runs' steps to the failure (their
    # forward and backward ran), the resumed run's
    steps = 4 * (1 + n) + 2 * obs["fail_at"] + (1 + n - found[2])

    ref = train_ref or {}
    log(f"[obs] O5 failure inside update at iteration {obs['fail_at']}: "
        f"emergency pair at {found[2]}, resumed losses {losses_c} equal the "
        f"uninterrupted run's within {TOL_LOSS}, worst leaf {worst:.2e}; "
        f"median step staged {timing['staged']['step_ms']:.2f} / "
        f"{timing['staged_2']['step_ms']:.2f} ms, in place "
        f"{timing['in_place']['step_ms']:.2f} / "
        f"{timing['in_place_2']['step_ms']:.2f} ms; peak staged "
        f"{_mib(timing['staged']['peak_bytes'])}, in place "
        f"{_mib(timing['in_place']['peak_bytes'])} (train phase "
        f"{ref.get('step_ms', float('nan')):.2f} ms, "
        f"{_mib(ref.get('peak_bytes'))})")
    del model_a, model_c, opt_c
    return dict(pair=found[2], pair_in_place=found_ip[2], worst_leaf=worst,
                timing=timing,
                launches=launches, steps=steps,
                checks=[("obs O5 training path", launches,
                         ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                          "bigdl_flash_bwd_dq"), config["n_layers"] * steps)])


# --------------------------------------------------------------------------- #
def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
        print("chip_smoke.py: the bigdl_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="trace one more serve run, spec run and training "
                         "step with torch.profiler and write their kernel "
                         "tables to PATH and PATH with _spec and _train "
                         "before its extension")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    from bigdl_tpu_torch import resolve_device
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[device] {kind} | count {count} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    phases = {}
    t0 = time.perf_counter()
    phase_build()
    phases["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash_main, paged_main, dkv_main, dq_main = phase_kernels(dev)
    products = quant_products(dev)
    log(f"[quant] products: {json.dumps(products)} | {smi}")
    phases["kernels"] = time.perf_counter() - t0
    log_allocated("serve")
    t0 = time.perf_counter()
    oracle = Oracle(dev, GPT2_SMALL, SERVE["seed"])
    serve, serve_eager = phase_serve(dev, profile_path=args.profile,
                                     oracle=oracle)
    phases["serve"] = time.perf_counter() - t0
    check_launches("serve path", serve["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    check_launches("eager serve path", serve_eager["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    log(f"[serve] launches on the serve path (through replays): "
        f"{serve['launches']}")
    for label, run in (("graphs", serve), ("eager", serve_eager)):
        log(f"[serve] {label}: TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} ms, "
            f"decode {run['decode_tokens_per_s']:.1f} tokens/s (8 slots), "
            f"flash_fwd {run['launches']['bigdl_flash_fwd']} and "
            f"paged_decode {run['launches']['bigdl_paged_decode']} launches, "
            f"{run['graphs']['captures']} captures, {run['graphs']['replays']}"
            f" replays, device idle share {idle_text(run['idle_share'])}, "
            f"max_memory_allocated {run['peak_bytes'] / 2**20:.1f} MiB, "
            f"wall {run['wall_s']:.2f} s | {smi}")
    torch.cuda.empty_cache()
    log_allocated("serve_sampled")
    t0 = time.perf_counter()
    sampled = phase_serve_sampled(dev, oracle=oracle)
    phases["serve_sampled"] = time.perf_counter() - t0
    check_launches("sampled serve path", sampled["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    log(f"[serve_sampled] TTFT p50 {sampled['ttft_p50_s'] * 1e3:.2f} ms, "
        f"decode {sampled['decode_tokens_per_s']:.1f} tokens/s (8 slots), "
        f"wall {sampled['wall_s']:.2f} s | {smi}")
    torch.cuda.empty_cache()
    log_allocated("spec")
    t0 = time.perf_counter()
    spec = phase_spec(dev, oracle=oracle, profile_path=args.profile)
    phases["spec"] = time.perf_counter() - t0
    spec_launches = {}
    for name, run in spec.items():
        check_launches(f"spec arm {name}", run["launches"],
                       ("bigdl_flash_fwd",))
        for symbol, n in run["launches"].items():
            spec_launches[symbol] = spec_launches.get(symbol, 0) + n
    log(f"[spec] launches over the spec runs: {spec_launches} | {smi}")
    for label, name in (("graphs", "linear_2layer_replay"),
                        ("eager", "linear_2layer_replay_eager")):
        run = spec[name]
        log(f"[spec] arm 2 {label}: TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} "
            f"ms, decode {run['decode_tokens_per_s']:.1f} tokens/s, "
            f"flash_fwd {run['launches']['bigdl_flash_fwd']} launches, "
            f"{run['graphs']['captures']} captures, {run['graphs']['replays']}"
            f" replays, device idle share {idle_text(run['idle_share'])} "
            f"| {smi}")
    log_allocated("quant")
    t0 = time.perf_counter()
    quant = phase_quant(dev, oracle=oracle)
    phases["quant"] = time.perf_counter() - t0
    q1 = quant["q1_int8_target"]
    check_launches("int8 target's serve path", q1["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    quant_launches = {}
    for name, run in quant.items():
        check_launches(f"quant run {name}", run["launches"],
                       ("bigdl_flash_fwd",))
        for symbol, n in run["launches"].items():
            quant_launches[symbol] = quant_launches.get(symbol, 0) + n
    for label, run, wbytes in (
            ("float serve", serve, q1["float_weight_bytes"]),
            ("Q1 int8 target", q1, q1["weight_bytes"])):
        pool = run["warm"]["pool_bytes"]
        log(f"[quant] {label}: weights {wbytes} bytes, TTFT p50 "
            f"{run['ttft_p50_s'] * 1e3:.2f} ms, decode "
            f"{run['decode_tokens_per_s']:.1f} tokens/s, max_memory_allocated "
            f"{run['peak_bytes'] / 2**20:.1f} MiB (allocated before the "
            f"engine {run['resident_bytes'] / 2**20:.1f} MiB), graph pool "
            f"{'none' if pool is None else f'{pool / 2**20:.1f} MiB'}, "
            f"flash_fwd {run['launches']['bigdl_flash_fwd']} and "
            f"paged_decode {run['launches']['bigdl_paged_decode']} launches "
            f"| {smi}")
    for name in ("q2_int8_kv", "q2_int8_kv_eager", "q3_dequant_greedy",
                 "q3_dequant_sampled", "q3_int8_greedy", "q3_int8_sampled"):
        run = quant[name]
        log(f"[quant] {name}: TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} ms, "
            f"decode {run['decode_tokens_per_s']:.1f} tokens/s | {smi}")
    log(f"[quant] launches over the quant runs: {quant_launches} | {smi}")
    log_allocated("tier")
    t0 = time.perf_counter()
    tier = phase_tier(dev, oracle=oracle)
    phases["tier"] = time.perf_counter() - t0
    check_launches("tier path", tier["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    for label in ("greedy", "sampled"):
        run = tier[f"t2_{label}"]
        log(f"[tier] T2 {label}: hibernate ms median "
            f"{statistics.median(run['hibernate_ms']):.3f}, resume ms median "
            f"{statistics.median(run['resume_ms']):.3f}, "
            f"{run['blocks']} blocks, {run['bytes']} bytes each way, "
            f"promote_bandwidth_mbs {run['promote_bandwidth_mbs']:.1f} "
            f"| {smi}")
    log(f"[tier] launches over the tier runs: {tier['launches']} | {smi}")
    log_allocated("replicas")
    t0 = time.perf_counter()
    replicas = phase_replicas(dev, oracle=oracle, colocated=serve)
    phases["replicas"] = time.perf_counter() - t0
    check_launches("replicas path", replicas["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    log(f"[replicas] launches over the replicas runs: "
        f"{replicas['launches']} | {smi}")
    log_allocated("batch")
    t0 = time.perf_counter()
    batch = phase_batch(dev, oracle=oracle)
    phases["batch"] = time.perf_counter() - t0
    check_launches("batch path", batch["launches"],
                   ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                    "bigdl_flash_bwd_dq"))
    b1, b3 = batch["b1"], batch["b3"]
    log(f"[batch] B1 {b1['examples_per_s']:.1f} examples/s, latency p50 "
        f"{b1['latency_p50_ms']:.2f} / p99 {b1['latency_p99_ms']:.2f} ms, "
        f"queue wait p50 {b1['queue_wait_p50_ms']:.2f} ms against device "
        f"p50 {b1['device_p50_ms']:.2f} ms, max_memory_allocated "
        f"{_mib(b1['peak_bytes'])}, graph pool "
        f"{_mib(b1['pool_bytes'])}, per bucket stage + replay / the "
        f"engine's copy to the host "
        + ", ".join(f"{k}: {v['replay_ms']:.3f} / {v['to_host_ms']:.3f} ms"
                    for k, v in b1["split"].items())
        + f"; B3 forward {b3['fwd_ms']:.2f} ms, backward "
        f"{b3['bwd_ms']:.2f} ms; launches over the batch runs "
        f"{batch['launches']} | {smi}")
    del oracle
    release(dev)
    log_allocated("train")
    t0 = time.perf_counter()
    train = phase_train(dev, profile_path=args.profile)
    phases["train"] = time.perf_counter() - t0
    flash_train = ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                   "bigdl_flash_bwd_dq")
    per_run = GPT2_SMALL["n_layers"] * train["steps_run"]
    check_launches("training path", train["launches"], flash_train,
                   exactly=per_run)
    check_launches("bf16-compute training path", train["launches_bf16"],
                   flash_train,
                   exactly=GPT2_SMALL["n_layers"] * train["steps_run_bf16"])
    check_launches("train CLI", train["launches_cli"], flash_train)
    log(f"[train] launches on the training path ({train['steps_run']} "
        f"steps): {train['launches']}; bf16-compute path "
        f"({train['steps_run_bf16']} steps): {train['launches_bf16']}; "
        f"CLI: {train['launches_cli']}")
    idle = idle_text(train["idle_share"])
    log(f"[train] median step {train['step_ms']:.2f} ms, "
        f"{train['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{train['peak_bytes'] / 2**20:.1f} MiB, device idle share {idle}; "
        f"bf16-compute median step {train['step16_ms']:.2f} ms, "
        f"{train['tokens_per_s16']:.1f} tokens/s | {smi}")
    log_allocated("moe")
    t0 = time.perf_counter()
    moe = phase_moe(dev, dense_serve=serve, profile_path=args.profile)
    phases["moe"] = time.perf_counter() - t0
    m1, m2 = moe["m1"], moe["m2"]
    check_launches("MoE training path (M1)", m1["launches"], flash_train,
                   exactly=GPT2_SMALL["n_layers"] * m1["steps_run"])
    check_launches("MoE serve path (M2)", m2["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    log(f"[moe] M1 median step {m1['step_ms']:.2f} ms, "
        f"{m1['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{_mib(m1['peak_bytes'])}, weights {m1['weight_bytes']} bytes, "
        f"device idle share {idle_text(m1['idle_share'])} (dense train step "
        f"{train['step_ms']:.2f} ms); M2 TTFT p50 "
        f"{m2['ttft_p50_s'] * 1e3:.2f} ms, decode "
        f"{m2['decode_tokens_per_s']:.1f} tokens/s (dense serve "
        f"{serve['ttft_p50_s'] * 1e3:.2f} ms, "
        f"{serve['decode_tokens_per_s']:.1f} tokens/s) | {smi}")
    log_allocated("accum")
    t0 = time.perf_counter()
    accum = phase_accum(dev)
    phases["accum"] = time.perf_counter() - t0
    for n, run in accum.items():
        check_launches(f"accumulation {n} path", run["launches"], flash_train,
                       exactly=GPT2_SMALL["n_layers"] * n * 2)
    log("[accum] A1 peaks (two optimizer steps): " + ", ".join(
        f"n={n} {_mib(r['peak'])}" for n, r in accum.items()) + f" | {smi}")
    log_allocated("ckpt")
    t0 = time.perf_counter()
    ckpt = phase_ckpt(dev)
    phases["ckpt"] = time.perf_counter() - t0
    check_launches("checkpoint path", ckpt["launches"], flash_train)
    log_allocated("gpt2")
    t0 = time.perf_counter()
    gpt2 = phase_gpt2(dev)
    phases["gpt2"] = time.perf_counter() - t0
    check_launches("GPT-2 import path", gpt2["launches"], ("bigdl_flash_fwd",))
    log_allocated("obs")
    t0 = time.perf_counter()
    obs = phase_obs(dev, train_ref=train)
    phases["obs"] = time.perf_counter() - t0
    for part in ("o1", "o2", "o3", "o4", "o5"):
        for label, launches, symbols, exactly in obs[part]["checks"]:
            check_launches(label, launches, symbols, exactly=exactly)
    o1, o2, o5 = obs["o1"], obs["o2"], obs["o5"]
    log(f"[obs] O1 rows: " + json.dumps(
        [{k: r[k] for k in ("rate_rps", "offered", "offered_rps", "accepted",
                            "shed", "shed_after_admission", "completed",
                            "truncated", "good", "goodput_rps",
                            "ttft_p50_ms", "ttft_p99_ms", "agreement",
                            "checked", "wall_s")} for r in o1["rows"]])
        + f"; knee {json.dumps(o1['knee'])} | {smi}")
    log(f"[obs] O2 reconcile {json.dumps(o2['reconcile'])}; attribution "
        f"{json.dumps(o2['attribution'])}; remainder "
        f"{json.dumps(o2['remainder'])} | {smi}")
    log(f"[obs] O5 staged vs in place: " + json.dumps(
        {k: {"step_ms": v["step_ms"], "peak_bytes": v["peak_bytes"]}
         for k, v in o5["timing"].items()})
        + f"; train phase {train['step_ms']:.2f} ms, "
        f"{_mib(train['peak_bytes'])} | {smi}")
    log("[done] phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()))

    def total(*runs):
        return {k: sum(r[k] for r in runs) for k in runs[0]}

    # launches: the serve path's (the training path's for the backward
    # pair); by_path: every path's own run, counted from 0
    paths = dict(serve=serve["launches"], serve_sampled=sampled["launches"],
                 spec=spec_launches, quant=quant_launches,
                 tier=tier["launches"], replicas=replicas["launches"],
                 batch=batch["launches"], train=train["launches"],
                 moe=total(m1["launches"], m2["launches"]),
                 accum=total(*(r["launches"] for r in accum.values())),
                 ckpt=ckpt["launches"], gpt2=gpt2["launches"],
                 obs=total(*(obs[p]["launches"]
                             for p in ("o1", "o2", "o3", "o4", "o5"))))

    def by_path(symbol, names):
        return {p: paths[p][symbol] for p in names}

    serving = ("serve", "serve_sampled", "spec", "quant", "tier", "replicas",
               "moe", "obs")
    training = ("train", "moe", "accum", "ckpt", "obs", "batch")
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="bigdl_tpu_torch/csrc/flash_fwd.cu",
             replaces="bigdl_tpu/ops/flash_attention.py:39",
             launches=serve["launches"]["bigdl_flash_fwd"],
             launches_by_path=by_path("bigdl_flash_fwd",
                                      serving + ("batch", "train", "accum",
                                                 "ckpt", "gpt2")),
             **flash_main),
        dict(name="paged_decode", route="cuda",
             source="bigdl_tpu_torch/csrc/paged_decode.cu",
             replaces="bigdl_tpu/ops/paged_attention.py:34",
             launches=serve["launches"]["bigdl_paged_decode"],
             launches_by_path=by_path("bigdl_paged_decode", serving),
             **paged_main),
        dict(name="flash_bwd_dkv", route="cuda",
             source="bigdl_tpu_torch/csrc/flash_bwd.cu",
             replaces="bigdl_tpu/ops/flash_attention.py:199",
             launches=train["launches"]["bigdl_flash_bwd_dkv"],
             launches_by_path=by_path("bigdl_flash_bwd_dkv", training),
             **dkv_main),
        dict(name="flash_bwd_dq", route="cuda",
             source="bigdl_tpu_torch/csrc/flash_bwd.cu",
             replaces="bigdl_tpu/ops/flash_attention.py:262",
             launches=train["launches"]["bigdl_flash_bwd_dq"],
             launches_by_path=by_path("bigdl_flash_bwd_dq", training),
             **dq_main),
    ]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
