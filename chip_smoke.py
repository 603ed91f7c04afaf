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
   that makes.  Every key tile the forward was built for
   (``FLASH_TILES``: float32 64x32 and 64x64, bf16 64x32, 64x64 and
   64x128, at head_dim 64 and 128) is held against the plain version at
   edge shapes, and every head-64 tile is timed at (1,12,1024,64) and
   (8,…) beside its bound and SDPA;
4. serve: a GPT-2-small-width TransformerLM (random weights: the
   reference's ``build(seed)`` tree from the key chain, float32) behind
   LMServingEngine answers 8 requests through the
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

17. tune: the autotune sweeps and the dispatch they steer, at the serve
   and train cell's attention shape (8 x 1024 tokens, 12 heads of 64),
   into this run's own tuning cache (``BIGDL_TPU_TORCH_TUNE_CACHE`` set
   to a fresh temporary file before any phase, so every earlier phase
   dispatches with no cache; the repository's ``TUNE_CUDA.json`` is
   never read or written).  T1 ``autotune_attention`` in float32 and
   bf16, every tile of the kernel (forward + backward through autograd)
   and the plain row, each tile's forward held against the plain
   version; T2 ``autotune_paged_decode`` at the served step (8 slots,
   1024 positions, blocks of 16, float32); T3 ``autotune_qcompute`` at
   m 8 and 256 by GPT-2's (k, n); T4 ``resolve_attention_plan`` naming
   each winner's tile, one ``flash_attention`` call per tuned key
   launching the kernel at that tile and matching the plain version (on
   the card a verdict picks the tile only: a plain core or gather that
   won its duel never takes a call from the kernel), an
   ``LMServingEngine`` with ``attention_impl`` and ``decode_attn`` "auto"
   running the top bucket at T1's float32 tile and decode through the
   paged kernel, its greedy streams held against the oracle, and
   ``compute="auto"`` resolving as T3 says; T5 the float32 T1 sweep
   again: every row reused, the doc's bytes unchanged; T6
   ``attention_bench -t 1024 -b 8 --heads 12 --headDim 64 --naive`` in
   both dtypes and ``lm_perf`` at GPT-2-small widths with and without
   ``--flash``, each line's keys and platform stamp checked.  The phase
   must finish within 90 s.

18. cnn: the image classifiers (cuDNN convolutions, pools and batch
   norms through PyTorch's calls; none of the port's kernels), float32,
   at their published widths, on the perf harness's seeded synthetic
   images.  C1: ResNet-50 (224x224x3, 1000 classes, shortcut B) at batch
   32 through ``perf.run_perf`` (3 warm-up and 10 timed SGD steps), in
   NCHW and in NHWC: median step ms, images/s, peak allocated MiB, the
   ms of one batch's copy from pageable memory (inside every step), the
   step's matmul and convolution FLOPs (``torch.utils.flop_counter``
   over one more step) and their share of 67 TFLOP/s.  C2: Vgg_16 and
   Inception_v1 at batch 32 and VggForCifar10 at 128, NCHW, the same
   numbers.  C3: ResNet-50 at batch 4 built from seed 1 on the card and
   on the CPU (bitwise equal), one float32 training step on the same
   batch: the loss within 1e-5 relative; the card records its ReLU masks
   and max-pool argmaxes (``pinned_decisions``) and the CPU replays them
   in float32 and in float64: every gradient leaf of the card within
   1e-3 of its max |g| of both (each device on its own decisions, a few
   ReLU inputs within rounding of 0 land on different sides, and each
   such flip moves a late weight gradient by a whole term: that
   difference is reported, not held); the 53 convolution biases a batch
   norm follows (gradient 0 in exact arithmetic) at most 1e-4 of the
   tree's largest |g|; the BN running buffers within 1e-5; and
   Top1Accuracy over an eval batch of 8 equal
   (a differing row must be a tie).  C4: the LeNet
   and ResNet-20 train CLIs (``--synthetic -e 1``) with a checkpoint in
   a temporary directory, losses finite and falling, validation
   ``Top1Accuracy``, then their eval CLIs on the checkpoint; the
   repository's ``flight/`` and ``TUNNEL_INCIDENTS.json`` unchanged.

19. rnn: the recurrent and text path (eager PyTorch products and
   elementwise math a step; none of the port's kernels), float32, at
   the reference CLIs' default widths, on seeded inputs.  Every model is
   built from seed 1 on the card and on the CPU (bitwise equal) and
   takes one step on the same batch: the loss within 1e-5 relative and
   every gradient leaf within 1e-3 of its max |g|, the CPU replaying the
   card's ReLU masks and max-pool argmaxes.  Then 1 warm-up and 5 timed
   ``LocalOptimizer`` steps, each printing the median step ms,
   sequences/s and tokens/s, peak allocated MiB, the ms of one batch's
   copy from pageable memory and the step's matmul and convolution
   FLOPs over 67 TFLOP/s.  R1: ``SimpleRNN(4000, 40, 4000)`` and
   ``LstmLM(4000, 128, 4000)`` on 32 x 24 one-hot ids,
   ``TimeDistributedCriterion(ClassNLLCriterion(), True)``, SGD(0.1).
   R2: ``TextClassifier(20, 100, 500)`` with the cnn and the lstm
   (hidden 128) encoder at batch 128, Adagrad(0.01), and one step of
   ``TextClassifierWithEmbedding(4000, 20, 100, 128)`` on ids.  R3:
   ``Autoencoder(32)`` at batch 150 on synthetic MNIST, MSECriterion,
   Adagrad(0.01); then 2 outer iterations of ``LBFGS(max_iter=5,
   line_search=True)`` on one batch of 150 through LocalOptimizer's
   full-batch path, on the card and on the CPU: every loss of the
   history within 1e-4 relative.  R4: the rnn train CLI (``--synthetic
   -e 2``, ``--cell rnn`` and ``lstm``; losses falling) with its
   checkpoint and dictionary in a temporary directory and its eval CLI
   on them; the text classifier's train CLI (``--synthetic -e 1``, both
   encoders) and its eval CLI on the saved model; the autoencoder's
   train CLI (``-e 1``) and eval CLI; every loss finite.  R5: NMS over
   2,000 seeded boxes (IoU 0.5, at most 100): the card's indices and
   count equal the CPU's.  The repository's ``flight/`` and
   ``TUNNEL_INCIDENTS.json`` unchanged; the phase within 240 s.

20. io: model files and import at ImageNet width (host parsing, one
   copy to the card, cuDNN/cuBLAS forwards; none of the port's kernels,
   0 launches).  ResNet-50 (1000 classes, shortcut B) from seed 1 on the
   card: ``save_pytorch``, then ``load_pytorch`` into a ResNet-50 of seed
   2; ``save_torch`` and ``Module.load_torch`` of it and of
   ``Inception_v1(1000)`` (its Concat modules and LRN);
   AlexNet(1000)'s conv1..fc8 written as a caffemodel by the script's
   own protobuf encoder and read by ``load_caffe(..., match_all=False)``
   into an AlexNet of seed 2.  Each format: every loaded leaf bitwise its
   source's, the log-probs of 32 seeded images (224x224, AlexNet
   227x227) within 1e-5 of the source model's on the card (0 expected)
   and within 1e-3 of the port's CPU forward on the same weights with
   top-1 equal; it prints the file MB, save s, load s (host parse plus
   the copy into the card), load MB/s and the copy's ms, and the entry
   point's own seconds.  ``DLClassifier`` on the ResNet-50, batch shape
   (32, 3, 224, 224), over 100 rows (the tail padded): rows/s, classes
   equal to argmax + 1 of the model's forward (a top-2 gap under 1e-5
   is a tie).  The example CLIs: ``load_model`` with ``--modelType``
   bigdl, torch and caffe (``--modelFactory lenet``) on 2,048 synthetic
   IDX MNIST images, the three results equal; ``image_classification``
   on a folder of 8 PNGs.  Last, the seconds of one GPT-2-small
   ``TransformerLM.build(0)`` (its tree equal to the cached one) and the
   count of trees the script drew: every phase takes its LM weights from
   one host draw per (config, seed), copied to the card per model.

21. data: the record-shard ImageNet path and the host library (no
   kernel of the port, 0 launches; cuDNN through the conv layers).
   The host library builds from ``bigdl_tpu_torch/csrc/host_native.cpp``
   with g++.  D1: ``pipeline_bench`` at the reference's defaults (batch
   256, 20 timed steps after 3, 2,048 stored 256x256x3 records in 8
   shards, crop 224): the bf16 ResNet-50 step's images/s on
   device-resident data and fed from the shards (native crop/flip/pack,
   the Prefetcher, the copy from pageable memory), their ratio, the copy
   of one batch, the peak of allocated memory, and the host-only
   delivery rate with its headroom over this run's synthetic rate; the
   first fed batch through the native batcher and the Python path
   (bitwise equal); one step at batch 2 on the card against the port's
   CPU step from the same uint8 batch (loss within 2e-2 relative, every
   float32 master leaf finite).  D2: a seeded PNG tree (4 classes, 96
   train and 32 val images near 256x256) through ``seqfile_generator
   --validate``, the same images as uncompressed, record- and
   block-compressed ``.seq`` files, ``record_files`` over the mixed
   folder equal through the native and the Python index; then the
   CLIs: ``resnet.train --dataset imagenet --depth 50 --shortcutType B
   --classNumber 1000 -b 32 -e 1`` on the mixed folder,
   ``inception.train --modelName inception_v1 -b 32 -i 3`` on the
   shards and ``inception.test`` on its model, ``load_model --dataset
   imagenet`` with the trained ResNet-50; every loss finite, every
   validation printed.  The phase within 120 s.
22. host: the host surface (no kernel of the port, 0 launches).  Z3:
   ResNet-50 (1000 classes, shortcut B, ``build(seed=1)``) quantized
   with ``Module.quantize("int8")`` in the int8 and the dequant compute
   modes, an eval forward at batch 32 of seeded images: each mode's
   top-1 agreement with the float32 forward, the largest logit gap over
   the largest float32 logit, and the three forwards' device ms; every
   quantized convolution (53) on its recorded input's first 4 rows, on
   the card and on the CPU, bitwise equal (per-sample scales, exact
   int32 sums: ``qconv_i8`` through ``F.unfold`` and ``torch._int_mm``).
   Z4: ``utils.profiling`` on the float32 ResNet-50 at batch 32: the
   summed per-layer training FLOPs (forward and weight gradients) beside
   the whole step's products (``perf.step_flops``, 2 FLOPs a
   multiply-add, input gradients included), and the five layers with
   the largest measured standalone training ms (CUDA events).  Z5: a
   1,000,000-draw ``normal_array`` twice from one seed (equal), a
   ``Tensor(1000, 1000).randn()`` fill from ``RNG`` at that seed equal
   to the draws in float32, its round trip through ``to_torch("cuda")``
   and ``from_torch`` bitwise, and the first 10,000 draws of the Python
   path (``BIGDL_TPU_NO_NATIVE=1``) equal to the host library's.
23. dist: data-parallel training through ``DistriOptimizer`` on a world
   of one rank on the card (``parallel.mesh.init_world``: NCCL for the
   card's tensors, over a ``file://`` store).  Z1: ResNet-50 at ImageNet
   width through ``perf.run_perf`` (batch 32, SGD 0.01, 1 warm-up and 5
   timed steps), ``distributed=True`` beside the same model's
   ``LocalOptimizer`` in this run: step ms and images/s of both, and the
   ``collective_footprint`` (2 bytes x the padded parameter count for
   each of the bf16 all-gather and reduce-scatter, the loss and the
   batch-norm buffers' float32 all-reduce); one batch-2 step of
   ``DistriOptimizer`` on the card and on the CPU (a host mesh of the
   same world), the CPU replaying the card's ReLU masks and max-pool
   argmaxes: the loss within 1e-5 relative, each weight leaf's update
   (the published weights less the built ones) within 1e-2 of its max
   (one bf16 step of the gradient the reduce-scatter carries) and each
   BN buffer within 1e-4 of its max.  Z2: the GPT-2-small-width
   model (``build(0)``, float32, flash) trained through
   ``DistriOptimizer`` on the train batch (8 x 1024 ids, Adam 3e-4), 1
   warm-up and 3 timed steps, the flash forward, dK/dV and dQ kernels
   launched exactly 12 times a step; the step-0 loss and every local
   gradient leaf of ``step_gradients`` against the same on plain
   attention (TOL_LOSS, TOL_GRAD), the reduced slice bitwise the bf16
   rounding of the local gradient (a world of one); then the train CLI
   with ``--distributed`` (the train phase's flags).  The phase within
   120 s.
24. par: the model-parallel strategies (``bigdl_tpu_torch.parallel``,
   ``models/transformer/sp.py``, ``example/long_context_lm.py``) on the
   one card.  P1: ``long_context_lm`` at GPT-2-small widths (vocab
   50257, hidden 768, 12 heads of 64, 12 layers), ``--seqLength 4096
   --batchSize 2``, float32, 1 warm-up and 3 timed Adam steps, once with
   ``--flash --remat`` on one device and once with ``--sp 1 --remat``
   over an NCCL world of one (ring attention, "auto" attention: the
   kernels on a card): the step-0 losses within 1e-5 relative, the flash
   forward launched exactly 24 times a step (remat runs each block's
   forward twice) and dK/dV and dQ 12, the paged kernel never; ms/step,
   tokens/s and the peak printed.  P2: a (2, 12, 4096, 64) causal
   problem cut into 4 shards of 1024; for each shard r the hops
   (``parallel.sequence.ring_hop``) in the order rank r receives the
   blocks, (r - i) mod 4 (10 computed, 6 future ones skipped): the
   assembled output and the q/k/v gradients of one scalar loss against
   ``flash_attention`` over the whole 4096 and against the plain
   version, in float32 and bf16 and once with documents that cross the
   shard boundaries; forward + backward ms of the ring beside the
   full-sequence kernels'.  P3, over the world of one:
   ``ring_lm_apply`` and ``ulysses_lm_apply`` against the model's own
   forward, ``transformer_lm_tp_rules`` + ``shard_params`` (model axis
   1, DTensors, the plain attention core) against the unsharded
   forward, ``pipeline_apply`` of one GPT-2-small block and
   ``pipeline_apply_hetero`` of ResNet-20 (one stage) against their
   sequential forward and gradients, ``moe_apply`` (expert axis 1, 8
   experts) against ``switch_mlp``, dense and at capacity 1.25; each
   error printed beside its tolerance.  The par path's launches are
   P1's.  The phase within 240 s.
25. place: serving placement on the one card (runs after replicas).
   P1: ``PlacementPolicy(DeviceTopology.detect(), tp=1)`` carves one
   slot, ``cuda:0``; ``LMServingEngine(placement=slot)`` serves the
   serve phase's model and 8 requests with graphs, then eagerly: every
   greedy stream equal to the unplaced serve run's and to offline
   generate, the flash forward and paged decode launched, the backward
   pair not, captures bounded, ``stats()["placement"]`` slot 0, tp 1,
   ``[0]``; TTFT p50, decode tokens/s and the peak printed beside the
   serve run's.  P2: the batch phase's scoring model behind
   ``ServingEngine(placement=slot)``: its rows bitwise the unplaced
   engine's on the same batches.  P3: ``ReplicaSet(placement=policy)``
   of 1 replica serves P2's rows; packed, ``try_scale_up()`` is falsy;
   2 replicas raise ``PlacementError`` ("exhausted").  P4: a
   ``DisaggCoordinator`` of 1 prefill + 1 decode replica on the one slot
   raises "no free placement slot".  P5: ``MeshSlicer().carve(1, 2)``
   raises ``PlacementError`` (one card: tensor parallelism across cards
   is proven on the CPU, over gloo worlds, not here).  P6: forwarded sets
   (``serving.placement.forward``) over two gloo ranks spawned on the one
   card (``nvidia-smi``'s compute mode printed; ``Exclusive_Process``
   fails the phase), ``PlacementPolicy(DeviceTopology([dev, dev],
   per_rank=True), slots=2, tp=1)``, rank 0 the driver, both ranks
   building from the serve model's tree.  P6a: a ``ReplicaSet`` of 2
   serves P2's batch twice: each replica dispatches once, the rows
   bitwise P2's unplaced rows.  P6b: a ``DisaggCoordinator`` of 1
   prefill + 1 decode replica (decode on rank 0, prefill on rank 1, as
   the coordinator acquires them) serves the 8 prompts greedily with
   graphs: every stream bitwise D1's and offline generate's, 8
   migrations, no lost payload, D1's migrated_blocks, the prefill rank
   never launching the paged kernel and the decode rank never the flash
   forward; TTFT p50, decode tokens/s and the median ``lm/migrate`` span
   (on the prefill rank) printed beside D1's.  Each rank counts its own
   launches from 0 around P6a's and P6b's traffic and sends them back;
   they join the place path's.

Every serving engine must keep its captures bounded: prefill entries at
most the buckets, one decode graph, one verify graph (one per tree
rung), at most one commit graph, one drafter decode graph (none for the
n-gram drafter), and no capture after warmup on the traffic warmup
covered.  Each run prints its warmup seconds, capture seconds and the
bytes of the engine's graph pool.

``--profile PATH`` adds one more serve run of fresh prompts on each of
the two serve engines, one more run of spec arm 2 on each of its two
engines, one more float32 training step, one more bf16-compute step, one
more MoE training step, one more C1 step in each layout and one more
R2 LSTM step under torch.profiler and writes their kernel tables
(device busy time, idle share, kernels launched, time by kernel) to
PATH and to PATH with ``_eager``, ``_spec``, ``_spec_eager``,
``_train``, ``_train_bf16``, ``_moe``, ``_cnn_nchw``, ``_cnn_nhwc``
and ``_rnn_lstm`` before its extension.

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
# the tune phase: the serve and train cell's attention shape (batch 8 x
# 1024 tokens, 12 heads of 64), the sweeps' iterations, the int8 duel's
# token rows (decode slots, a prefill tile), lm_perf's timed steps, and
# the phase's time limit
TUNE = dict(batch=8, seq_len=1024, iters=10, paged_iters=20,
            qcompute_m=(8, 256), qcompute_iters=20, lm_iters=3,
            limit_s=90.0)
BATCH = dict(seq_len=128, max_batch=8, threads=4, requests=64, predicts=8,
             sizes=(1, 2, 4, 3, 8, 5, 7, 1, 6, 2, 4, 1, 8), oversized=19,
             oversized_n=2, id_seed=12, tol=1e-3,
             fault="serving.dispatch:die:name=r1,after=4", b3_shape=(4, 256),
             b3_steps=3, split_reps=3, place_rows=4)
# the image classifiers: C1 ResNet-50 in both layouts, C2 the others in
# NCHW, each through perf.run_perf (warm-up + timed steps); C3 one
# ResNet-50 step on the card against the CPU; C4 the CLIs
CNN = dict(c1=("resnet50", 32), c1_formats=("NCHW", "NHWC"),
           c2=(("vgg16", 32), ("inception_v1", 32), ("vgg_cifar", 128)),
           warmup=3, iters=10, c3_batch=4, c3_eval_batch=8,
           tol_loss=1e-5, tol_grad=1e-3, tol_zero=1e-4,
           tol_buffer=1e-5,
           lenet_cli=["--synthetic", "-e", "1"],
           resnet_cli=["--synthetic", "--depth", "20", "-e", "1"],
           limit_s=150.0)
# the recurrent and text path at the reference CLIs' widths (float32)
RNN = dict(lm=(("simple_rnn", 40), ("lstm_lm", 128)), vocab=4000,
           lm_batch=32, seq_len=24, lm_records=64, lm_lr=0.1,
           text=("cnn", "lstm"), classes=20, embed=100, text_seq=500,
           hidden=128, text_batch=128, text_records=256, text_lr=0.01,
           ae_code=32, ae_batch=150, ae_lr=0.01, warmup=1, iters=5,
           lbfgs_max_iter=5, lbfgs_outer=2,
           nms_boxes=2000, nms_iou=0.5, nms_max=100,
           tol_loss=1e-5, tol_grad=1e-3, tol_lbfgs=1e-4,
           rnn_cli=["--synthetic", "-e", "2"],
           text_cli=["--synthetic", "-e", "1"], text_widths=[],
           ae_cli=["--synthetic", "-e", "1"],
           limit_s=240.0)
# the io phase: model files written and read back at ImageNet width
# (ResNet-50 1000 classes, shortcut B; Inception v1; AlexNet as Caffe),
# held bitwise in every leaf; log-probs on 32 seeded images within
# tol_card of the source on the card (0 expected) and within tol_cpu
# (the JAX package's whole-net import tolerance) of the port's CPU
# forward, top-1 equal; DLClassifier over dlc_rows rows in batches of
# dlc_batch (the tail padded); the example CLIs on mnist_rows synthetic
# IDX images and a folder of png_per_class x 2 PNGs
IO = dict(images=32, src_seed=1, dst_seed=2, tol_card=1e-5, tol_cpu=1e-3,
          dlc_rows=100, dlc_batch=32, mnist_rows=2048, png_per_class=4,
          limit_s=240.0)
# the data phase: D1 pipeline_bench at the reference's defaults
# (pipeline_bench.py main), the batch-2 card-vs-CPU step within tol_loss
# (bf16); D2 a PNG tree of `classes` classes, train_per_class and
# val_per_class images of `image_sizes` (cycled), through the generator,
# three .seq flavors and the ImageNet CLIs at cli_batch
# the host phase: Z3's batch, the rows held bitwise card against CPU and
# Z5's draws; the dist phase: Z1's model and batch, its warm-up and timed
# steps, the batch-2 card-vs-CPU step on the card's decisions: its loss's
# relative tolerance, each leaf's update over its max (the gradient
# travels in bf16, so two values a float32 rounding apart may land one
# bf16 step apart, up to 2^-7 of themselves: 7.8e-3, plus C3's float32
# noise), each buffer's over its max; Z2's steps
HOST = dict(batch=32, bitwise_rows=4, draws=1_000_000, python_draws=10_000,
            seed=7, layer_iters=5, layer_warmup=1, limit_s=120.0)
DIST = dict(z1=("resnet50", 32), warmup=1, iters=5, check_batch=2,
            tol_loss=1e-5, tol_update=1e-2, tol_buffer=1e-4, z2_warmup=1,
            z2_steps=3, limit_s=120.0)
DATA = dict(batch=256, iters=20, warmup=3, records=2048, check_batch=2,
            tol_loss=2e-2, classes=4, train_per_class=24, val_per_class=8,
            image_sizes=((256, 256), (248, 264), (264, 240)), shards=4,
            cli_batch=32, inception_iters=3, limit_s=120.0)
# the par phase: long_context_lm at GPT-2-small widths (T 4096, batch 2,
# 1 warm-up and 3 timed Adam steps a run); the ring's hop schedule
# replayed for 4 shards of a (2, 12, 4096, 64) causal problem; the
# world-of-one checks at 1 x 256 ids (the LM ones), a (4, 256, 768)
# block input, ResNet-20 at batch 32 and 2,048 MoE tokens
#: the place phase's P6: two ranks spawned on the one card, and the most
#: seconds they may take (start, build, serve and close)
PLACE_WORLD = 2
PLACE_LIMIT_S = 420
PAR = dict(cli=["--vocabSize", "50257", "--hiddenSize", "768", "--nHead",
                "12", "--nLayers", "12", "-t", "4096", "-b", "2", "-i", "3"],
           ring=dict(batch=2, heads=12, seq=4096, d=64, shards=4, seed=0,
                     docs=6),
           lm_tokens=256, pipe_rows=4, micro=2, resnet_batch=32,
           moe_tokens=2048, moe_experts=8, tol_loss=1e-5, tol_lm=1e-4,
           tol_ulysses=1e-4, tol_tp=1e-5, tol_pipe=1e-5, tol_moe=1e-6,
           limit_s=240.0)


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
               b=1, block_k=None, d=64, timed=True, reuse=None):
    """The forward kernel at (b, 12, tq, d) x (b, 12, tk, d) against its
    plain version: o and lse within tolerance, finite, bitwise equal on
    a second run; timed beside the plain version and SDPA unless
    ``timed`` is False.  ``block_k`` pins the key tile (the default tile
    when None).  ``reuse``, a timed row of the same inputs, supplies the
    plain and SDPA times (neither depends on the tile)."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (flash_attention_reference,
                                     flash_attention_with_lse)
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    h = 12
    bq = None if block_k is None else 64
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
                                        q_segment_ids=seg, kv_segment_ids=seg,
                                        block_q=bq, block_k=block_k)

    def plain():
        return flash_attention_reference(q, k, v, causal=causal,
                                         q_segment_ids=seg,
                                         kv_segment_ids=seg)

    o, lse = kernel()
    o2, lse2 = kernel()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    name = (f"flash_fwd ({b},12,{tq},{d})x({b},12,{tk},{d}) {dtype} "
            f"{'causal' if causal else 'full'}{' segmented' if seg is not None else ''}"
            + ("" if block_k is None else f" tile 64x{block_k}"))
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
    if not timed:
        log(f"[kernels] {name}: max_abs_err o {err_o:.3e} lse {err_l:.3e}, "
            "bitwise repeatable")
        return dict(max_abs_err=err_o)
    ms = cuda_ms(kernel)
    if reuse is not None:
        plain_ms, library_ms = reuse["plain_ms"], reuse["library_ms"]
    else:
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


def tile_cases(dev, base):
    """Every key tile the forward kernel was built for (``FLASH_TILES``)
    against the plain version at edge shapes (masked rows, Tk > Tq,
    segments, full attention); every head-64 tile timed at the serve
    path's (1,12,1024,64) and the training step's (8,…) shapes.  The
    default tile's rows, and every row's plain and SDPA times, are
    ``base``'s, by (dtype, b): the unpinned runs of the same inputs.
    Returns the timed rows."""
    from bigdl_tpu_torch.ops import FLASH_TILES
    rows = []
    for (dtype, d), tiles in sorted(FLASH_TILES.items()):
        for _, bk in tiles:
            flash_case(dev, 300, 200, dtype, b=2, block_k=bk, d=d, seed=11,
                       timed=False)
            flash_case(dev, 100, 612, dtype, block_k=bk, d=d, seed=12,
                       timed=False)
            flash_case(dev, 256, 256, dtype, segmented=True, block_k=bk,
                       d=d, seed=13, timed=False)
            flash_case(dev, 33, 17, dtype, causal=False, block_k=bk, d=d,
                       seed=14, timed=False)
            if d != 64:
                continue
            for b in (1, 8):
                r = base[(dtype, b)]
                if (64, bk) != tiles[0]:
                    r = flash_case(dev, 1024, 1024, dtype, b=b, block_k=bk,
                                   reuse=r)
                rows.append(dict(dtype=dtype, shape=[b, 12, 1024, 64],
                                 block_q=64, block_k=bk,
                                 default=(64, bk) == tiles[0], **r))
    return rows


def phase_kernels(dev):
    for t in (8, 100, 512):
        for dtype in ("float32", "bfloat16"):
            flash_case(dev, t, t, dtype)
    base = {("bfloat16", 1): flash_case(dev, 1024, 1024, "bfloat16")}
    flash_case(dev, 256, 256, "float32", segmented=True, seed=1)
    flash_case(dev, 100, 612, "float32", seed=2)
    # the training step's shape, both compute dtypes
    for dtype in ("bfloat16", "float32"):
        base[(dtype, 8)] = flash_case(dev, 1024, 1024, dtype, b=8)
    # the served model's largest prefill bucket (the 700-token prompt)
    flash_main = flash_case(dev, 1024, 1024, "float32")
    base[("float32", 1)] = flash_main
    flash_main["tiles"] = tile_cases(dev, base)
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
            self._model = build_lm(dev, config, seed, attention_impl="xla")
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


def profile_device(run, label, out_path, stats=None):
    """Call ``run()`` once under torch.profiler: device busy time (the
    union of kernel intervals) against the host clock, and the kernels
    by device time.  Writes the table to ``out_path``; returns the idle
    share, and fills ``stats`` (a dict) with the wall and busy ms and
    the number of kernels when given one."""
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
    if stats is not None:
        stats.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                     kernels=len(kern), idle_share=idle)
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


#: each (config, seed)'s parameter tree as numpy, drawn once: the key
#: chain runs on the host, about 10 s for GPT-2 small's embedding
_TREES = {}
TREE_DRAWS = {"count": 0, "seconds": 0.0}


def lm_tree(config, seed):
    """The numpy tree of ``TransformerLM(**config).build(seed)``: the
    reference's key chain (``split(prng_key(seed))[0]`` into ``init``),
    drawn on the first call for a (config, seed) and kept."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils import keychain
    key = (tuple(sorted(config.items())), int(seed))
    if key not in _TREES:
        t0 = time.perf_counter()
        init_rng, _ = keychain.split(keychain.prng_key(int(seed)))
        _TREES[key] = TransformerLM(device="cpu", **config).init(init_rng)
        dt = time.perf_counter() - t0
        TREE_DRAWS["count"] += 1
        TREE_DRAWS["seconds"] += dt
        log(f"[model] drew the {config['n_layers']} x "
            f"{config['hidden_size']} tree of seed {seed} on the host in "
            f"{dt:.2f} s (draw {TREE_DRAWS['count']})")
    return _TREES[key]


def build_lm(dev, config, seed, attention_impl="flash"):
    """``TransformerLM(**config).build(seed)`` on ``dev``: the same
    params, buffers and key as ``build``, the tree drawn once per
    (config, seed) and copied to the card for each model."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils import keychain
    from bigdl_tpu_torch.utils.params import params_from_numpy
    t0 = time.perf_counter()
    model = TransformerLM(attention_impl=attention_impl, device=dev,
                          **config)
    model.params = params_from_numpy(lm_tree(config, seed), dev)
    model.buffers = params_from_numpy(model.init_buffers(), dev)
    model._rng = keychain.split(keychain.prng_key(int(seed)))[1]
    log(f"[model] {config['n_layers']} layers x {config['hidden_size']} "
        f"of seed {seed} on {dev} in {time.perf_counter() - t0:.2f} s")
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
    out["streams"] = out.pop("results")
    ties = check_streams(label, oracle, prompts, out["streams"], max_new)
    hits = stats["kvcache"]["prefix_cache"]["hits"]
    if hits < 1:
        raise AssertionError("the shared-head prompts missed the radix cache")
    out.update(peak_bytes=peak, resident_bytes=resident, ties=ties,
               radix_hits=hits, warm=warm,
               itl_p99_s=stats["metrics"]["itl"]["p99_s"],
               placement=stats["placement"],
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
    # the place phase's forwarded pair holds its streams against these
    out["d1_streams"] = d1["D1 greedy"]["run"]["results"]
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


def phase_place(dev, config=GPT2_SMALL, serve=SERVE, prompts=None,
                oracle=None, colocated=None, batch=BATCH, disagg=None):
    """Serving placement on one card (see the module docstring): P1 the
    placed LM engine with graphs, then eagerly, P2 the placed scoring
    engine, P3 the placed replica set, P4 a disaggregated pair on one
    slot, P5 the tensor-parallel guard, P6 forwarded sets over two
    spawned ranks.  ``colocated`` is the greedy serve run: its streams
    are the placed runs' and its numbers are printed beside theirs;
    ``disagg`` is the replicas phase's numbers (D1's streams and hop).
    Returns the phase's numbers and its launches, the ranks' included."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.resilience import ReplicaSet
    from bigdl_tpu_torch.serving import (DeviceTopology, DisaggCoordinator,
                                         MeshSlicer, PlacementError,
                                         PlacementPolicy, ServingEngine)
    oracle = oracle or Oracle(dev, config, serve["seed"])
    prompts = serve_prompts() if prompts is None else prompts
    cuda = dev.type == "cuda"
    topo = DeviceTopology.detect(None if cuda else "cpu")
    policy = PlacementPolicy(topo, tp=1)
    if policy.slots_total != topo.n_devices or topo.degraded:
        raise AssertionError(f"place: {policy!r} from {topo!r}")
    acc = _PathLaunches()
    out = {"topology": topo.describe()}
    log(f"[place] {topo!r}: {json.dumps(topo.describe())}; {policy!r}")

    # -- P1: the placed LM engine, graphs then eager -------------------- #
    model = build_lm(dev, config, serve["seed"])
    slot = policy.acquire()
    if slot.device != dev or slot.describe() != {
            "slot_id": 0, "tp": 1, "device_ids": [0]}:
        raise AssertionError(f"place: slot {slot!r} on {slot.device}")
    for label, kw in (("graphs", {}), ("eager", {"cuda_graphs": False})):
        run = acc.run(lambda: serve_once(dev, model, serve, prompts, oracle,
                                         f"place {label}", placement=slot,
                                         **kw))
        launches = dict(acc.last)
        if colocated is not None:
            for i, (a, b) in enumerate(zip(run["streams"],
                                           colocated["streams"])):
                if not np.array_equal(a, b):
                    raise AssertionError(f"place {label}: stream {i} differs "
                                         "from the unplaced serve run's")
        if run["placement"] != slot.describe():
            raise AssertionError(f"place {label}: stats placement "
                                 f"{run['placement']}")
        if cuda:
            check_launches(f"place {label} path", launches,
                           ("bigdl_flash_fwd", "bigdl_paged_decode"))
            for symbol in ("bigdl_flash_bwd_dkv", "bigdl_flash_bwd_dq"):
                if launches[symbol]:
                    raise AssertionError(f"place {label}: {symbol} launched "
                                         f"{launches[symbol]} times")
        run.pop("streams")
        out[f"p1_{label}"] = dict(run, launches=launches)
        base = colocated or {}
        log(f"[place] P1 {label}: TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} ms "
            f"(serve {base.get('ttft_p50_s', float('nan')) * 1e3:.2f}), "
            f"decode {run['decode_tokens_per_s']:.1f} tokens/s (serve "
            f"{base.get('decode_tokens_per_s', float('nan')):.1f}), "
            f"max_memory_allocated {_mib(run['peak_bytes'])} (serve "
            f"{_mib(base.get('peak_bytes'))}), streams identical to the "
            f"unplaced run's, launches {launches}, {graph_line(run)}")
    del model
    release(dev)

    # -- P2: the placed scoring engine ----------------------------------- #
    T, V, n = batch["seq_len"], config["vocab_size"], batch["place_rows"]
    scorer = TransformerLM(attention_impl="auto", device=dev, **config)
    scorer.params = oracle.model.params
    x = np.random.RandomState(batch["id_seed"]).randint(
        1, V + 1, size=(n, T)).astype(np.float32)
    kw = dict(input_shape=(T,), buckets=(n,), max_batch_size=n,
              max_wait_ms=1.0)
    with ServingEngine(scorer, name="unplaced", device=dev, **kw) as eng:
        eng.warmup()
        want = eng.predict(x, timeout=600)
    with ServingEngine(scorer, name="placed", placement=slot, **kw) as eng:
        eng.warmup()
        got = acc.run(lambda: eng.predict(x, timeout=600))
        st = eng.stats()
    if not np.array_equal(got, want) or st["placement"] != slot.describe():
        raise AssertionError(f"place P2: rows bitwise "
                             f"{np.array_equal(got, want)}, placement "
                             f"{st['placement']}")
    if cuda:
        check_launches("place P2", acc.last, ("bigdl_flash_fwd",))
    out["p2"] = dict(rows=int(got.shape[0]), launches=dict(acc.last),
                     ledger_tag=st["compile_cache"]["ledger_tag"])
    log(f"[place] P2 placed scoring engine: {n} x {T} rows bitwise the "
        f"unplaced engine's, cache {st['compile_cache']['ledger_tag']}, "
        f"launches {acc.last}")
    policy.release(slot)

    # -- P3: the placed replica set --------------------------------------- #
    rs = ReplicaSet(scorer, n_replicas=1, placement=policy, **kw)
    try:
        rs.warmup()
        rows = acc.run(lambda: rs.predict(x, timeout=600))
        packed = rs.try_scale_up()
        st = rs.stats()
    finally:
        rs.close()
    if not np.array_equal(rows, want) or packed or \
            st["placement"]["slots_used"] != 1 or policy.headroom() != 1:
        raise AssertionError(f"place P3: rows bitwise "
                             f"{np.array_equal(rows, want)}, try_scale_up "
                             f"{packed!r}, {st['placement']}")
    try:
        ReplicaSet(scorer, n_replicas=2, placement=policy, **kw)
    except PlacementError as e:
        if "exhausted" not in str(e) or policy.headroom() != 1:
            raise
        exhausted = str(e)
    else:
        raise AssertionError("place P3: 2 replicas on 1 slot did not raise")
    out["p3"] = dict(try_scale_up=packed, exhausted=exhausted,
                     launches=dict(acc.last))
    log(f"[place] P3 replica set: 1 replica serves the P2 rows bitwise, "
        f"try_scale_up() {packed!r} when packed; 2 replicas: "
        f"PlacementError({exhausted!r})")
    del scorer
    release(dev)

    # -- P4: a disaggregated pair on one slot ----------------------------- #
    model = build_lm(dev, config, serve["seed"])
    try:
        DisaggCoordinator(model, prefill_replicas=1, decode_replicas=1,
                          placement=policy, slots=serve["slots"],
                          cache_len=serve["cache_len"],
                          block_len=serve["block_len"],
                          max_new_tokens=serve["max_new"])
    except RuntimeError as e:
        if "no free placement slot" not in str(e) or policy.headroom() != 1:
            raise
        out["p4"] = str(e)
    else:
        raise AssertionError("place P4: a prefill and a decode replica on "
                             "one slot did not raise")
    del model
    release(dev)
    log(f"[place] P4 DisaggCoordinator(1 + 1) on 1 slot: {out['p4']}")

    # -- P5: tensor parallelism needs a slot of several devices ----------- #
    try:
        MeshSlicer().carve(1, 2)
    except PlacementError as e:
        out["p5"] = str(e)
    else:
        raise AssertionError("place P5: carve(1, 2) did not raise")
    log(f"[place] P5 MeshSlicer().carve(1, 2): PlacementError({out['p5']!r})")

    # -- P6: forwarded sets over two ranks on the one card ---------------- #
    d1 = disagg or {}
    out["p6"] = place_forwarded(
        dev, config, serve, prompts, oracle, acc, x=x, want=want,
        d1_streams=d1.get("d1_streams"),
        d1=d1.get("d1", {}).get("D1 greedy"), batch=batch)
    out["launches"] = acc.total
    return out


def _gpu_compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def place_forwarded(dev, config, serve, prompts, oracle, acc, *, x, want,
                    d1_streams, d1, batch=BATCH):
    """P6 (see the module docstring): two gloo ranks spawned on ``dev``,
    ``PlacementPolicy(DeviceTopology([dev, dev], per_rank=True), slots=2,
    tp=1)``, rank 0 the driver.  P6a a forwarded ``ReplicaSet`` of 2
    serving P2's batch ``x`` twice (rows bitwise ``want``, both replicas
    dispatching); P6b a forwarded ``DisaggCoordinator`` of 1 prefill + 1
    decode serving the prompts greedily with graphs (streams bitwise
    ``d1_streams`` and offline generate, D1's hop counters, the flash
    forward only on the prefill rank and the paged kernel only on the
    decode rank).  Each rank's launches join ``acc``."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp
    cuda = dev.type == "cuda"
    if cuda:
        mode = _gpu_compute_mode()
        log(f"[place] P6 compute mode: {mode}")
        if "Exclusive_Process" in mode:
            raise AssertionError(f"place P6: the card's compute mode is "
                                 f"{mode}: two processes cannot share it")
    max_new = serve["max_new"]
    want_streams = [oracle.stream(p, max_new) for p in prompts]
    work = tempfile.mkdtemp(prefix="chip_smoke_place_")
    try:
        job = dict(device=str(dev), config=config, serve=serve,
                   prompts=list(prompts), tree=lm_tree(config, serve["seed"]),
                   seed=serve["seed"], x=x, pairs=shared_heads(
                       prompts, serve["block_len"]),
                   rows=int(x.shape[0]))
        job_path = os.path.join(work, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump(job, f, protocol=pickle.HIGHEST_PROTOCOL)
        del job
        store = f"file://{os.path.join(work, 'store')}"
        t0 = time.perf_counter()
        ctx = mp.start_processes(place_rank, args=(PLACE_WORLD, store,
                                                   job_path, work),
                                 nprocs=PLACE_WORLD, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > PLACE_LIMIT_S:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"place P6: the ranks did not finish "
                                     f"in {PLACE_LIMIT_S} s")
        seconds = time.perf_counter() - t0
        res = []
        for r in range(PLACE_WORLD):
            with open(os.path.join(work, f"p6.{r}.pkl"), "rb") as f:
                got = pickle.load(f)
            if "error" in got:
                raise AssertionError(f"place P6 rank {r}:\n{got['error']}")
            res.append(got["ok"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    drv = res[0]
    for r in res:
        for label in ("p6a", "p6b"):
            for symbol, n in r[label + "_launches"].items():
                acc.total[symbol] = acc.total.get(symbol, 0) + n

    # P6a: both replicas dispatched, every batch's rows bitwise P2's
    a = drv["p6a"]
    if any(not np.array_equal(y, want) for y in a["rows"]) or \
            min(a["dispatched"].values()) < 1:
        raise AssertionError(f"place P6a: rows bitwise "
                             f"{[np.array_equal(y, want) for y in a['rows']]},"
                             f" dispatched {a['dispatched']}")
    if cuda:
        for r in res:
            check_launches(f"place P6a rank {r['rank']}", r["p6a_launches"],
                           ("bigdl_flash_fwd",))
    log(f"[place] P6a forwarded ReplicaSet of 2 over ranks 0 and 1: "
        f"{len(a['rows'])} batches of {x.shape[0]} x {x.shape[1]} rows "
        f"bitwise P2's unplaced rows, dispatched {a['dispatched']}, "
        f"placement {a['placement']}, launches by rank "
        f"{[r['p6a_launches'] for r in res]}")

    # P6b: the forwarded pair, against D1 and offline generate
    b = drv["p6b"]
    for i, got in enumerate(b["results"]):
        if d1_streams is not None and not np.array_equal(got, d1_streams[i]):
            raise AssertionError(f"place P6b: stream {i} differs from D1's")
        if not np.array_equal(got, want_streams[i]):
            raise AssertionError(f"place P6b: stream {i} differs from "
                                 "offline generate")
    st = b["stats"]
    if (st["migrations"], st["adopted"], st["lost_payloads"]) != (
            len(prompts), len(prompts), 0) or (
            d1 is not None and st["migrated_blocks"] != d1["migrated_blocks"]):
        raise AssertionError(f"place P6b: {st}, D1 migrated_blocks "
                             f"{d1 and d1['migrated_blocks']}")
    phase_of = {r["phase"]: r for r in res}
    pre, dec = phase_of["prefill"], phase_of["decode"]
    if cuda:
        if pre["p6b_launches"]["bigdl_paged_decode"] or \
                dec["p6b_launches"]["bigdl_flash_fwd"]:
            raise AssertionError(
                f"place P6b: prefill rank {pre['rank']} launches "
                f"{pre['p6b_launches']}, decode rank {dec['rank']} launches "
                f"{dec['p6b_launches']}")
        check_launches(f"place P6b prefill rank {pre['rank']}",
                       pre["p6b_launches"], ("bigdl_flash_fwd",))
        check_launches(f"place P6b decode rank {dec['rank']}",
                       dec["p6b_launches"], ("bigdl_paged_decode",))
    hop = pre["migrate_ms"]
    run = b["run"]
    d1 = d1 or {}
    log(f"[place] P6b forwarded DisaggCoordinator, prefill on rank "
        f"{pre['rank']}, decode on rank {dec['rank']}: {len(prompts)} greedy "
        f"streams bitwise D1's and offline generate; migrations "
        f"{st['migrations']}, adopted {st['adopted']}, lost_payloads 0, "
        f"migrated_blocks {st['migrated_blocks']} (D1 "
        f"{d1.get('migrated_blocks')}); TTFT p50 "
        f"{run['ttft_p50_s'] * 1e3:.2f} ms (D1 "
        f"{d1.get('ttft_p50_s', float('nan')) * 1e3:.2f}), decode "
        f"{run['decode_tokens_per_s']:.1f} tokens/s (D1 "
        f"{d1.get('decode_tokens_per_s', float('nan')):.1f}), lm/migrate ms "
        f"median {statistics.median(hop):.3f} on the prefill rank (D1 "
        + (f"{statistics.median(d1['migrate_ms']):.3f}"
           if d1.get("migrate_ms") else "nan")
        + f"); launches by rank {[r['p6b_launches'] for r in res]}; ranks "
        f"{seconds:.1f} s | {nvidia_smi_line() if cuda else 'cpu'}")
    return dict(seconds=seconds, p6a_dispatched=a["dispatched"],
                migrated_blocks=st["migrated_blocks"],
                ttft_p50_s=run["ttft_p50_s"],
                decode_tokens_per_s=run["decode_tokens_per_s"],
                migrate_ms=hop,
                launches={r["rank"]: {"p6a": r["p6a_launches"],
                                      "p6b": r["p6b_launches"]}
                          for r in res})


def place_rank(rank, world, store, job_path, out_dir):
    """One rank of P6, spawned (so this module is imported again in the
    child, as ``__mp_main__`` when it runs as a script): runs
    :func:`_place_rank` and pickles its numbers, or its traceback, to
    ``p6.<rank>.pkl``."""
    import pickle
    import traceback
    try:
        res = {"ok": _place_rank(rank, world, store, job_path)}
    except Exception:  # noqa: BLE001 - the parent reports it
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"p6.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _place_rank(rank, world, store, job_path):
    import pickle

    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch import resolve_device
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.obs import get_tracer
    from bigdl_tpu_torch.parallel.mesh import init_world, shutdown_world
    from bigdl_tpu_torch.resilience import ReplicaSet
    from bigdl_tpu_torch.serving import (DeviceTopology, DisaggCoordinator,
                                         PlacementPolicy)
    from bigdl_tpu_torch.utils import keychain
    from bigdl_tpu_torch.utils.params import params_from_numpy
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dev = resolve_device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    config, serve = job["config"], job["serve"]
    # the slots' traffic is host messages: a gloo world, each rank on dev
    init_world("cpu", init_method=store, rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        topo = DeviceTopology([dev] * world, per_rank=True)
        params = params_from_numpy(job["tree"], dev)
        del job["tree"]

        # -- P6a: the scoring model in a forwarded replica set -------- #
        n, x = job["rows"], job["x"]
        scorer = TransformerLM(attention_impl="auto", device=dev, **config)
        scorer.params = params
        rs = ReplicaSet(scorer, n_replicas=2,
                        placement=PlacementPolicy(topo, slots=2, tp=1),
                        input_shape=(x.shape[1],), buckets=(n,),
                        max_batch_size=n, max_wait_ms=1.0)
        try:
            if rank == 0:
                rs.warmup()
            dist.barrier()
            _reset_launches()
            dist.barrier()
            if rank == 0:
                rows = [rs.predict(x, timeout=600) for _ in range(2)]
                st = rs.stats()
                out["p6a"] = dict(
                    rows=rows,
                    dispatched={k: v["dispatched"]
                                for k, v in st["replicas"].items()},
                    placement={k: v["placement"]
                               for k, v in st["replicas"].items()})
            dist.barrier()
            out["p6a_launches"] = _launches()
        finally:
            rs.close()
        del rs, scorer
        release(dev)

        # -- P6b: a forwarded disaggregated pair ---------------------- #
        model = TransformerLM(attention_impl="flash", device=dev, **config)
        model.params = params
        model.buffers = params_from_numpy(model.init_buffers(), dev)
        model._rng = keychain.split(keychain.prng_key(int(job["seed"])))[1]
        co = DisaggCoordinator(
            model, prefill_replicas=1, decode_replicas=1,
            placement=PlacementPolicy(topo, slots=2, tp=1),
            name="place-P6b", slots=serve["slots"],
            cache_len=serve["cache_len"], block_len=serve["block_len"],
            max_new_tokens=serve["max_new"], device=dev,
            attention_impl="flash", decode_attn="paged_kernel")
        tracer = get_tracer()
        try:
            mine = co.prefill + co.decode + list(co._fw.engines.values())
            mine = [e for e in mine if hasattr(e, "warmup_prefix")]
            out["phase"] = mine[0].phase
            if rank != 0:
                warm_pairs(mine[0], job["pairs"])
            dist.barrier()
            if rank == 0:
                co.warmup()
                warm_pairs(mine[0], job["pairs"])
            dist.barrier()
            tracer.clear()
            tracer.enable()
            _reset_launches()
            dist.barrier()
            if rank == 0:
                run = serve_run(co, job["prompts"], serve["max_new"])
                out["p6b"] = dict(results=run.pop("results"), run=run,
                                  stats={k: v for k, v in co.stats().items()
                                         if k != "engines"})
            dist.barrier()
            out["p6b_launches"] = _launches()
            tracer.disable()
            out["migrate_ms"] = [e["dur"] / 1e3
                                 for e in _spans(tracer, "lm/migrate")]
        finally:
            co.close()
        return out
    finally:
        shutdown_world()


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
        return build_lm(dev, config, train["seed"], attention_impl="flash")

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
    model = build_lm(dev, cfg, train["seed"], attention_impl="flash")
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
        model = build_lm(dev, config, train["seed"], attention_impl="flash")
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
        return build_lm(dev, config, seed, attention_impl="flash")

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
    model = build_lm(dev, config, train["seed"], attention_impl="flash")
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
        return build_lm(dev, config, seed, attention_impl="flash")

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
# --------------------------------------------------------------------------- #
def _cli_lines(main_fn, argv):
    """Run a CLI's ``main(argv)`` in this process; its stdout's JSON
    lines."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def _check_stamp(run, row, dev):
    import torch
    if dev.type != "cuda":
        if row.get("platform") != "cpu":
            raise AssertionError(f"{run}: platform {row.get('platform')}")
        return
    want = {"platform": "gpu", "device_name": torch.cuda.get_device_name(dev)}
    got = {k: row.get(k) for k in want}
    if got != want:
        raise AssertionError(f"{run}: platform stamp {got}, not {want}")


def phase_tune(dev, smi, tune=TUNE, config=GPT2_SMALL, serve=SERVE,
               prompts=None):
    """The autotune sweeps at the serve and train cell's widths into this
    run's (temporary) tuning cache, then the dispatchers under it.  T1
    the flash tile sweep (forward + backward through autograd, every
    tile of the kernel and the plain row) in float32 and bf16, each
    tile's forward held against the plain version at the swept shape;
    T2 the paged-decode duel at the served step; T3 the int8 duel at
    GPT-2's layer geometries; T4 the verdicts steering
    ``resolve_attention_plan``, one ``flash_attention`` call per tuned
    key, an "auto" engine (decode and prefill buckets) against the
    oracle, and ``compute="auto"``; T5 a second T1 sweep re-measuring
    nothing; T6 the attention_bench and lm_perf CLIs.  Returns the
    phase's numbers and T4's launches."""
    import torch
    from bigdl_tpu_torch.models.utils import attention_bench, lm_perf
    from bigdl_tpu_torch.ops import (FLASH_TILES, autotune, flash_attention,
                                     flash_attention_reference,
                                     resolve_attention_plan)
    from bigdl_tpu_torch.ops.flash_attention import FLASH_FWD
    from bigdl_tpu_torch.quant.kernels import resolve_compute
    from bigdl_tpu_torch.quant.qtensor import quantize_array
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    path = autotune.cache_path()
    b, h, t, d = tune["batch"], config["n_head"], tune["seq_len"], \
        config["hidden_size"] // config["n_head"]
    out = {"sweeps": {}}
    quiet = dict(log=lambda *_: None)
    # T1: the flash tile sweep, both compute dtypes
    for dtype in ("float32", "bfloat16"):
        doc = autotune.autotune_attention(
            [t], head_dim=d, heads=h, batch=b, causal=True, dtype=dtype,
            iters=tune["iters"], device=dev, **quiet)
        tiles = FLASH_TILES[(dtype, d)]
        rows = [r for r in doc["rows"] if r.get("dtype") == dtype
                and r.get("seq_len") == t]
        for r in rows:
            if r["impl"] == "flash" and "step_s" not in r:
                raise AssertionError(f"[tune] T1 {dtype}: tile "
                                     f"{r['block_q']}x{r['block_k']} has no "
                                     f"step_s: {r.get('error')}")
        if {(r["block_q"], r["block_k"]) for r in rows
                if r["impl"] == "flash"} != set(tiles):
            raise AssertionError(f"[tune] T1 {dtype}: rows do not cover "
                                 f"the tiles {tiles}")
        w = doc["winners"][autotune.attention_key(t, d, dtype, True)]
        out["sweeps"][dtype] = dict(rows=rows, winner=w)
        for r in rows:
            log(f"[tune] T1 {dtype} ({b},{h},{t},{d}) {r['impl']}"
                + (f" 64x{r['block_k']}" if r["impl"] == "flash" else "")
                + f": fwd+bwd {r.get('step_s', 0) * 1e3:.4f} ms, "
                f"{r.get('tokens_per_s')} tokens/s | {smi}")
        log(f"[tune] T1 {dtype} winner: tile {w.get('block_q')}x"
            f"{w.get('block_k')}, use_flash {w.get('use_flash')}, "
            f"flash_speedup_vs_xla {w.get('flash_speedup_vs_xla')} | {smi}")
        # each tile's forward against the plain version at this shape
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((b, h, t, d), generator=g, device=dev).to(
            getattr(torch, dtype)) for _ in range(3))
        o_ref = flash_attention_reference(q, k, v, causal=True)[0]
        tol = TOL_F32 if dtype == "float32" else TOL_BF16_O
        for bq, bk in tiles:
            o = flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
            err = (o.float() - o_ref.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"[tune] T1 {dtype} tile {bq}x{bk}: "
                                     f"max_abs_err {err:.3e} > {tol}")
            log(f"[tune] T1 {dtype} tile {bq}x{bk} forward max_abs_err "
                f"{err:.3e} (tol {tol})")
        del q, k, v, o_ref
    # T2: the paged-decode duel at the served step
    doc = autotune.autotune_paged_decode(
        slots=serve["slots"], heads=h, head_dim=d,
        cache_len=serve["cache_len"], block_len=serve["block_len"],
        dtype="float32", iters=tune["paged_iters"], device=dev, **quiet)
    paged_rows = [r for r in doc["rows"] if r["kind"] == "paged_decode"]
    if not all("step_s" in r for r in paged_rows):
        raise AssertionError(f"[tune] T2: a row has no step_s: {paged_rows}")
    pw = doc["winners"][autotune.paged_key(d, serve["block_len"],
                                           "float32")]
    out["paged"] = dict(rows=paged_rows, winner=pw)
    log(f"[tune] T2 paged decode, {serve['slots']} slots x {h} heads x "
        f"{serve['cache_len']} positions: kernel "
        f"{pw['kernel_step_s'] * 1e3:.4f} ms, gather "
        f"{pw['gather_step_s'] * 1e3:.4f} ms, use_kernel "
        f"{pw['use_kernel']} | {smi}")
    # T3: the int8 duel at GPT-2's geometries
    shapes = [(m, kk, n) for m in tune["qcompute_m"]
              for kk, n in QUANT_PRODUCT_KN]
    doc = autotune.autotune_qcompute(shapes, iters=tune["qcompute_iters"],
                                     device=dev, **quiet)
    qv = {}
    for m, kk, n in shapes:
        qw_ = doc["winners"][autotune.qcompute_key(m, kk, n)]
        if qw_.get("use_int8") is None:
            raise AssertionError(f"[tune] T3 ({m},{kk},{n}): no verdict")
        qv[(m, kk, n)] = "int8" if qw_["use_int8"] else "dequant"
        log(f"[tune] T3 ({m},{kk},{n}): int8 {qw_['int8_step_s'] * 1e3:.4f} "
            f"ms, dequant {qw_['dequant_step_s'] * 1e3:.4f} ms -> "
            f"{qv[(m, kk, n)]} | {smi}")
    out["qcompute"] = {f"{m}x{kk}x{n}": v for (m, kk, n), v in qv.items()}
    if not doc["complete"]:
        raise AssertionError("[tune] the tuning doc is not complete")
    certified = open(path, "rb").read()
    # T4: the verdicts steer the dispatchers
    recorded = []
    real = FLASH_FWD.launch

    def spy(*args):
        recorded.append(args[14])     # block_k
        return real(*args)

    for dtype, sw in out["sweeps"].items():
        w = sw["winner"]
        plan = resolve_attention_plan(t, d, dtype, True, device=dev)
        # the card keeps the kernel at the tuned tile whatever the core
        # verdict; the CPU takes the plain core where it won
        want = (("xla", None, None, "tuned")
                if w["use_flash"] is False and not on_card
                else ("flash", w["block_q"], w["block_k"], "tuned"))
        if tuple(plan) != want:
            raise AssertionError(f"[tune] T4 {dtype}: plan {plan}, winner "
                                 f"{want}")
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn((1, h, t, d), generator=g, device=dev).to(
            getattr(torch, dtype)) for _ in range(3))
        recorded.clear()
        FLASH_FWD.launch = spy
        try:
            o = flash_attention(q, k, v, causal=True)
            if on_card:
                torch.cuda.synchronize()
        finally:
            del FLASH_FWD.launch
        if plan.impl == "xla":
            from bigdl_tpu_torch.nn.attention import dot_product_attention
            ref, tol = dot_product_attention(q, k, v, causal=True), 0.0
            if recorded:
                raise AssertionError(f"[tune] T4 {dtype}: the plain verdict "
                                     f"launched the kernel {recorded}")
        else:
            ref = flash_attention_reference(q, k, v, causal=True)[0]
            tol = TOL_F32 if dtype == "float32" else TOL_BF16_O
            if on_card and recorded != [plan.block_k]:
                raise AssertionError(f"[tune] T4 {dtype}: launches with "
                                     f"tiles {recorded}, not "
                                     f"[{plan.block_k}]")
        err = (o.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"[tune] T4 {dtype}: max_abs_err {err:.3e}"
                                 f" > {tol} against the plain version")
        log(f"[tune] T4 {dtype}: plan {tuple(plan)}, flash_attention "
            f"launched {len(recorded)} time(s) at tiles {recorded}, "
            f"max_abs_err {err:.3e}")
    # an "auto" engine: decode per T2, each prefill bucket per its own
    # verdict (T1's for the 1024 bucket, float32)
    oracle = Oracle(dev, config, serve["seed"])
    model = build_lm(dev, config, serve["seed"], attention_impl="auto")
    prompts = serve_prompts() if prompts is None else prompts
    want_decode = ("paged_kernel" if on_card or pw["use_kernel"]
                   else "gather")
    with make_engine(model, dev, serve, attention_impl="auto",
                     decode_attn="auto") as engine:
        if engine.decode_attn != want_decode:
            raise AssertionError(f"[tune] T4 engine decode_attn "
                                 f"{engine.decode_attn}, not "
                                 f"{want_decode}")
        attn = engine.stats()["prefill_attention"]
        w32 = out["sweeps"]["float32"]["winner"]
        want_top = ("xla" if w32["use_flash"] is False and not on_card
                    else f"flash {w32['block_q']}x{w32['block_k']}")
        if attn.get(str(t)) != want_top:
            raise AssertionError(f"[tune] T4 engine bucket {t}: "
                                 f"{attn.get(str(t))}, T1 says {want_top}")
        warm = warm_engine(engine, prompts)
        run = serve_run(engine, prompts, serve["max_new"])
        check_bounded("tune engine", engine, warm)
    ties = check_streams("tune", oracle, prompts, run["results"],
                         serve["max_new"])
    paged = run["launches"]["bigdl_paged_decode"]
    if on_card and (paged > 0) != (want_decode == "paged_kernel"):
        raise AssertionError(f"[tune] T4 engine: {paged} paged launches "
                             f"with decode_attn {want_decode}")
    log(f"[tune] T4 engine: decode_attn {engine.decode_attn}, prefill "
        f"{json.dumps(attn)}, launches {run['launches']}, TTFT p50 "
        f"{run['ttft_p50_s'] * 1e3:.2f} ms, decode "
        f"{run['decode_tokens_per_s']:.1f} tokens/s, {len(ties)} ties | "
        f"{smi}")
    out["launches"] = run["launches"]
    del engine, model, oracle
    for (m, kk, n), v in qv.items():
        qw_ = quantize_array(torch.ones((kk, n), device=dev), (0,),
                             compute="auto")
        got = resolve_compute(qw_, (m, kk))
        if got != v:
            raise AssertionError(f"[tune] T4 compute auto ({m},{kk},{n}): "
                                 f"{got}, T3 says {v}")
    log(f"[tune] T4 compute='auto' resolves as T3: {out['qcompute']}")
    # T5: the same T1 sweep again re-measures nothing
    doc = autotune.autotune_attention(
        [t], head_dim=d, heads=h, batch=b, causal=True, dtype="float32",
        iters=tune["iters"], device=dev, **quiet)
    mine = [r for r in doc["rows"] if r.get("dtype") == "float32"
            and r.get("kind") == "train_step"]
    if not all(r.get("reused_from_previous_run") for r in mine):
        raise AssertionError("[tune] T5: a row was measured again")
    if open(path, "rb").read() != certified:
        raise AssertionError("[tune] T5: the certified doc was rewritten")
    log(f"[tune] T5: {len(mine)} rows reused, the doc's bytes unchanged")
    # T6: the CLIs at the cell's widths
    out["cli"] = {}
    bench_keys = {"metric", "impl", "seq_len", "batch", "heads", "head_dim",
                  "dtype", "segmented", "block_q", "block_k", "iters",
                  "step_s", "tokens_per_s"}
    for dtype in ("float32", "bfloat16"):
        rows = _cli_lines(attention_bench.main, [
            "-t", str(t), "-b", str(b), "--heads", str(h), "--headDim",
            str(d), "--naive", "--dtype", dtype, "--iters",
            str(tune["iters"]), "--device", dev.type])
        if [r.get("impl") for r in rows] != ["flash", "naive_xla"]:
            raise AssertionError(f"[tune] T6 attention_bench {dtype}: {rows}")
        for r in rows:
            if not bench_keys <= set(r):
                raise AssertionError(f"[tune] T6 attention_bench row lacks "
                                     f"{bench_keys - set(r)}")
            _check_stamp("attention_bench", r, dev)
            log(f"[tune] T6 attention_bench {dtype} {r['impl']} "
                f"64x{r['block_k']}: {r['step_s'] * 1e3:.4f} ms fwd+bwd "
                f"| {smi}")
        out["cli"][f"attention_bench_{dtype}"] = rows
    lm_keys = {"metric", "seq_len", "batch", "vocab", "hidden", "heads",
               "layers", "flash", "remat", "optim", "dtype", "iters",
               "step_s", "tokens_per_s"}
    for flash in (True, False):
        rows = _cli_lines(lm_perf.main, [
            "--vocab", str(config["vocab_size"]), "--hidden", str(
                config["hidden_size"]), "--heads", str(h), "--layers",
            str(config["n_layers"]), "-t", str(t), "-b", str(b), "--dtype",
            "float32", "-i", str(tune["lm_iters"]), "--device", dev.type]
            + (["--flash"] if flash else []))
        if len(rows) != 1 or not lm_keys <= set(rows[0]):
            raise AssertionError(f"[tune] T6 lm_perf: {rows}")
        _check_stamp("lm_perf", rows[0], dev)
        log(f"[tune] T6 lm_perf {'flash' if flash else 'plain'}: step "
            f"{rows[0]['step_s'] * 1e3:.2f} ms, {rows[0]['tokens_per_s']} "
            f"tokens/s | {smi}")
        out["cli"][f"lm_perf_{'flash' if flash else 'plain'}"] = rows[0]
        release(dev)
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > tune["limit_s"]:
        raise AssertionError(f"[tune] the phase took {out['seconds']:.1f} s,"
                             f" over its {tune['limit_s']} s")
    return out


def _repo_files_state(paths):
    """(size, mtime) of each path (a directory: of every file under it),
    to show a phase left the repository's own files as they were."""
    out = {}
    for p in paths:
        full = os.path.join(HERE, p)
        if os.path.isdir(full):
            for root, _, files in os.walk(full):
                for f in files:
                    st = os.stat(os.path.join(root, f))
                    out[os.path.join(root, f)] = (st.st_size, st.st_mtime)
        elif os.path.exists(full):
            st = os.stat(full)
            out[full] = (st.st_size, st.st_mtime)
    return out


def cnn_perf_row(dev, name, batch, data_format, cnn=CNN, label=""):
    """One perf-harness run (warm-up + timed steps) and its numbers: the
    median step, images/s, peak, the input copy and its share of the
    step, the step's FLOPs and their share of the float32 peak."""
    import numpy as np
    from bigdl_tpu_torch.models.utils import perf
    r = perf.run_perf(name, batch, cnn["iters"], warmup=cnn["warmup"],
                      data_format=data_format, device=dev)
    if not np.isfinite(r["loss"]):
        raise AssertionError(f"{name} {data_format}: loss {r['loss']}")
    step_ms = r["median_step_s"] * 1e3
    bound_ms = r["step_flops"] / PEAK_FLOPS["float32"] * 1e3
    row = dict(model=name, batch=batch, data_format=data_format,
               step_ms=step_ms, steps_ms=[t * 1e3 for t in r["step_s"]],
               images_per_s=batch / r["median_step_s"],
               peak_mib=(r["peak_bytes"] / 2**20 if r["peak_bytes"]
                         else None),
               input_copy_ms=r["input_copy_ms"],
               input_mb=r["input_bytes"] / 1e6,
               copy_share=r["input_copy_ms"] / step_ms,
               step_gflop=r["step_flops"] / 1e9, fp32_bound_ms=bound_ms,
               fp32_peak_share=bound_ms / step_ms, loss=r["loss"],
               device=r["nvidia_smi"] or r["device_name"])
    log(f"[cnn] {name} {data_format}{label} batch {batch}: median step "
        f"{step_ms:.3f} ms ({_ms_list(row['steps_ms'])}), "
        f"{row['images_per_s']:.1f} images/s, max_memory_allocated "
        f"{_mib(r['peak_bytes']) if r['peak_bytes'] else 'n/a'}, input "
        f"copy {row['input_copy_ms']:.3f} ms for {row['input_mb']:.1f} MB "
        f"({row['copy_share'] * 100:.1f}% of the step), "
        f"{row['step_gflop']:.1f} GFLOP a step (matmul and convolution "
        f"FLOPs of the forward and backward, torch.utils.flop_counter), "
        f"{row['fp32_peak_share'] * 100:.1f}% of 67 TFLOP/s float32 "
        f"(bound {bound_ms:.3f} ms) | {row['device']}")
    return row


def profile_cnn_step(dev, name, batch, data_format, out_path):
    """One more training step of ``name`` (after two warm-up steps)
    under torch.profiler; returns the device's idle share."""
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer
    model = perf.build_model(name, data_format).build(seed=1, device=dev)
    ds = perf._make_dataset(name, batch, "random", data_format)
    opt = LocalOptimizer(model, ds, ClassNLLCriterion()).set_optim_method(
        SGD(learning_rate=0.01))
    run_iterations(opt, 2)
    return profile_device(lambda: run_iterations(opt, 1),
                          f"{name} {data_format} train step (batch {batch})",
                          out_path)


def phase_cnn(dev, cnn=CNN, profile_path=None):
    """The image-classification path (see the module docstring): C1 and
    C2 through the perf harness, C3 a ResNet-50 training step on the card
    against the port's CPU path, C4 the LeNet and ResNet CLIs with a
    checkpoint in a temporary directory and their eval CLIs on it;
    ``profile_path`` adds one profiled C1 step per layout.  Returns the
    rows and the checks' numbers."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.models.lenet import test as lenet_test
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    from bigdl_tpu_torch.models.resnet import test as resnet_test
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Top1Accuracy, loss_and_grads
    from bigdl_tpu_torch.utils import file_io, keychain
    from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    guarded = _repo_files_state(("flight", "TUNNEL_INCIDENTS.json"))
    _reset_launches()
    out = dict(c1=[], c2=[])
    # C1 and C2
    name, batch = cnn["c1"]
    for df in cnn["c1_formats"]:
        out["c1"].append(cnn_perf_row(dev, name, batch, df, cnn))
        release(dev)
        if profile_path:
            root, ext = os.path.splitext(profile_path)
            out["c1"][-1]["idle_share"] = profile_cnn_step(
                dev, name, batch, df, f"{root}_cnn_{df.lower()}{ext}")
            release(dev)
    for name, batch in cnn["c2"]:
        out["c2"].append(cnn_perf_row(dev, name, batch, "NCHW", cnn))
        release(dev)

    # C3: one ResNet-50 step on the card against the CPU, same params
    cpu = torch.device("cpu")
    card = models.ResNet(1000, depth=50).build(seed=1, device=dev)
    host = models.ResNet(1000, depth=50).build(seed=1, device=cpu)
    for a, b in zip(tree_leaves((card.params, card.buffers)),
                    tree_leaves((host.params, host.buffers))):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("C3: build(seed=1) differs between the "
                                 "card and the CPU")
    ds = perf._make_dataset("resnet50", cnn["c3_batch"], "random", "NCHW")
    b = next(ds.data(train=False))
    crit = ClassNLLCriterion()
    key = keychain.prng_key(0)
    to_cpu = lambda t: tree_map(lambda a: a.cpu(), t)  # noqa: E731

    def step(m, d, dt, pins):
        cast = lambda t: tree_map(lambda a: a.to(dt), t)  # noqa: E731
        with pins:
            loss, g, bufs = loss_and_grads(
                m, crit, cast(m.params),
                torch.as_tensor(b.data, device=d).to(dt),
                torch.as_tensor(b.labels, device=d), buffers=cast(m.buffers),
                rng=key)
        return float(loss), to_cpu(g), to_cpu(bufs)

    # the card's float32 step records its ReLU masks and max-pool argmaxes;
    # the CPU runs the step on its own decisions, and again in float32 and
    # in float64 on the card's
    pins_card, pins_cpu = [], []
    l_card, g_card, buf_card = step(card, dev, torch.float32,
                                    pinned_decisions(record=pins_card))
    l_cpu, g_cpu, buf_cpu = step(host, cpu, torch.float32,
                                 pinned_decisions(record=pins_cpu))
    _, g_cpu_pinned, _ = step(host, cpu, torch.float32,
                              pinned_decisions(replay=pins_card))
    _, g_exact, _ = step(host, cpu, torch.float64,
                         pinned_decisions(replay=pins_card))
    masks = [(a.cpu(), c) for a, c in zip(pins_card, pins_cpu)
             if a.dtype == torch.bool]
    flips = sum(int((a != c).sum()) for a, c in masks)
    n_relu = sum(a.numel() for a, _ in masks)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    if not rel <= cnn["tol_loss"]:
        raise AssertionError(f"C3 step-0 loss card {l_card} vs cpu "
                             f"{l_cpu}: relative {rel:.3e}")
    # the biases ahead of a batch norm have zero gradient in exact
    # arithmetic: each must be noise, at most tol_zero of the tree's
    # largest |g|, on both devices; every other leaf is compared
    zero = biases_ahead_of_bn(card)
    top = max(float(a.abs().max()) for a in tree_leaves(g_cpu))
    noise = max(float(a.abs().max()) / top
                for tree in (g_card, g_cpu)
                for path, a in _named_leaves(tree) if path in zero)
    if not (zero and noise <= cnn["tol_zero"]):
        raise AssertionError(f"C3: the {len(zero)} convolution biases "
                             f"ahead of a batch norm reach {noise:.3e} of "
                             f"the largest |g| (limit {cnn['tol_zero']})")
    g_card = _zeroed(g_card, zero)
    worst = _check_grads("C3 ResNet-50 float32 step, the card's decisions",
                         g_card, _zeroed(g_cpu_pinned, zero),
                         cnn["tol_grad"])
    worst_exact = _check_grads("C3 ResNet-50 float32 step against float64 "
                               "on the card's decisions", g_card,
                               _zeroed(g_exact, zero), cnn["tol_grad"])
    # each device on its own decisions: not held, reported
    unpinned = max((float((a - c).abs().max() / c.abs().max()), path)
                   for (path, a), (_, c) in zip(
                       _named_leaves(g_card), _named_leaves(g_cpu))
                   if path not in zero)
    buf_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                  for a, b in zip(tree_leaves(buf_card), tree_leaves(buf_cpu)))
    if not buf_err <= cnn["tol_buffer"]:
        raise AssertionError(f"C3 BN running buffers: error {buf_err:.3e}")
    # Top1 over an eval batch: labels the CPU's prediction for half the
    # rows and another class for the rest; a differing row must be a tie
    xe = np.random.RandomState(1).randn(cnn["c3_eval_batch"], 3, 224,
                                        224).astype(np.float32)
    with torch.no_grad():
        lp_cpu = host.apply(host.params, torch.from_numpy(xe),
                            buffers=host.buffers)[0]
        lp_card = card.apply(card.params, torch.as_tensor(xe, device=dev),
                             buffers=card.buffers)[0].cpu()
    pred = lp_cpu.argmax(-1)
    half = cnn["c3_eval_batch"] // 2
    labels = torch.cat([pred[:half] + 1, (pred[half:] + 1) % 1000 + 1])
    acc = {k: Top1Accuracy()(v, labels) for k, v in (("cpu", lp_cpu),
                                                     ("card", lp_card))}
    if acc["cpu"].correct != acc["card"].correct:
        top2 = lp_cpu.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1])[lp_card.argmax(-1) != pred]
        if not (gaps < TIE_GAP).all():
            raise AssertionError(f"C3 Top1Accuracy card {acc['card']} vs "
                                 f"cpu {acc['cpu']}")
    logp_err = float((lp_card - lp_cpu).abs().max())
    out["c3"] = dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=rel,
                     worst_grad=worst[0], worst_grad_leaf=worst[1],
                     worst_grad_f64=worst_exact[0],
                     worst_grad_f64_leaf=worst_exact[1],
                     relu_decisions=n_relu, relu_flips=flips,
                     unpinned_worst=unpinned[0],
                     unpinned_worst_leaf=unpinned[1], zero_leaves=len(zero),
                     zero_leaf_noise=noise, buffer_err=buf_err,
                     top1_card=acc["card"].correct,
                     top1_cpu=acc["cpu"].correct, eval_logp_err=logp_err)
    log(f"[cnn] C3 ResNet-50 batch {cnn['c3_batch']} one float32 step, card "
        f"vs CPU: loss {l_card:.7f} / {l_cpu:.7f} (relative {rel:.2e}); on "
        f"the card's ReLU masks and max-pool argmaxes every gradient leaf "
        f"within {cnn['tol_grad']} of its max |g|: against the CPU's float32 "
        f"worst {worst[0]:.2e} at {worst[1]}, against float64 worst "
        f"{worst_exact[0]:.2e} at {worst_exact[1]}; each device on its own "
        f"decisions ({flips} of {n_relu} ReLU masks differ): worst "
        f"{unpinned[0]:.2e} at {unpinned[1]} (not held); the {len(zero)} "
        f"convolution biases ahead of a batch norm (exact gradient 0) at "
        f"most {noise:.2e} of the largest |g|; BN buffers within "
        f"{buf_err:.2e}; eval batch of {cnn['c3_eval_batch']}: max "
        f"|dlog-prob| {logp_err:.2e}, Top1Accuracy {acc['card']} / "
        f"{acc['cpu']}")
    del card, host, g_card, g_cpu, g_cpu_pinned, g_exact, pins_card, pins_cpu
    release(dev)

    # C4: the CLIs, checkpoints in a temporary directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cnn_")
    out["c4"] = {}
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    try:
        for label, train_main, test_main, argv in (
                ("lenet", lenet_train.main, lenet_test.main,
                 cnn["lenet_cli"]),
                ("resnet20", resnet_train.main, resnet_test.main,
                 cnn["resnet_cli"])):
            ck = os.path.join(tmp, label)
            record, level = _IterationLog(), logger.level
            logger.setLevel(logging.INFO)
            logger.addHandler(record)
            try:
                opt = train_main(argv + ["--checkpoint", ck,
                                         "--device", dev.type])
            finally:
                logger.removeHandler(record)
                logger.setLevel(level)
            losses = record.losses
            if not (losses and all(np.isfinite(losses))
                    and losses[-1] < losses[0]):
                raise AssertionError(f"C4 {label} CLI losses {losses}: "
                                     "not finite and falling")
            (method, result), = opt.validation_results
            if str(method) != "Top1Accuracy":
                raise AssertionError(f"C4 {label}: validation {method}")
            found = file_io.latest_checkpoint(ck)
            if found is None:
                raise AssertionError(f"C4 {label}: no checkpoint under {ck}")
            model_path, _, n = found
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                test_main(["--synthetic", "--model", model_path,
                           "--device", dev.type])
            printed = buf.getvalue()
            if "Top1Accuracy is Accuracy(" not in printed:
                raise AssertionError(f"C4 {label} eval CLI printed "
                                     f"{printed!r}")
            out["c4"][label] = dict(losses=losses, validation=str(result),
                                    checkpoint=n, eval=printed.strip())
            log(f"[cnn] C4 {label} CLI {' '.join(argv)}: {len(losses)} "
                f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                f"validation {result}; checkpoint model.{n}, eval CLI: "
                f"{printed.strip()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if _repo_files_state(("flight", "TUNNEL_INCIDENTS.json")) != guarded:
        raise AssertionError("the cnn phase changed the repository's "
                             "flight/ or TUNNEL_INCIDENTS.json")
    out["launches"] = _launches()
    out["seconds"] = time.perf_counter() - t_phase
    if dev.type == "cuda" and out["seconds"] > cnn["limit_s"]:
        raise AssertionError(f"the cnn phase took {out['seconds']:.1f} s, "
                             f"over {cnn['limit_s']} s")
    return out


def biases_ahead_of_bn(module, prefix=""):
    """The leaf paths (``_named_leaves``'s form) of every convolution bias
    that a batch norm follows in a Sequential: the norm subtracts the
    batch mean, so their gradient is zero in exact arithmetic and the
    float32 one is rounding noise."""
    from bigdl_tpu_torch.nn import (BatchNormalization, Container,
                                    Sequential, SpatialConvolution)
    out = set()
    if isinstance(module, Container):
        mods = module.modules
        for i, m in enumerate(mods):
            path = f"{prefix}/{i}"
            if (isinstance(module, Sequential)
                    and isinstance(m, SpatialConvolution) and m.with_bias
                    and i + 1 < len(mods)
                    and isinstance(mods[i + 1], BatchNormalization)):
                out.add(f"{path}/bias")
            out |= biases_ahead_of_bn(m, path)
    return out


class pinned_decisions:
    """While active, every port ``ReLU`` and ``SpatialMaxPooling`` appends
    its decision (the mask ``x >= 0``; each window's argmax) to
    ``record``, or, given ``replay``, takes the next one from it in place
    of its own.  A gradient is only piecewise smooth: a pre-activation
    within rounding of 0 passes or stops its gradient depending on the
    last bit, and each such flip moves a weight gradient summed over few
    positions by a whole term.  Replaying one run's decisions in another
    compares the arithmetic of two runs on the same piece."""

    def __init__(self, record=None, replay=None):
        self.record = record
        self.replay = None if replay is None else iter(replay)

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        from bigdl_tpu_torch.nn import ReLU, SpatialMaxPooling
        from bigdl_tpu_torch.nn.conv import spatial
        pins = self

        def relu(layer, params, x, **kw):
            if pins.replay is not None:
                return x * next(pins.replay).to(x.device, x.dtype)
            pins.record.append((x >= 0).detach())  # clamp_min's backward
            return torch.clamp_min(x, 0)

        @spatial
        def max_pool(layer, params, x):
            if pins.replay is not None:
                idx = next(pins.replay).to(x.device)
                return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            k, s = layer._window()
            y, idx = F.max_pool2d(x, k, s, padding=(layer.pad_h, layer.pad_w),
                                  ceil_mode=layer.ceil_mode,
                                  return_indices=True)
            pins.record.append(idx)
            return y

        self.saved = [(ReLU, ReLU.f), (SpatialMaxPooling, SpatialMaxPooling.f)]
        ReLU.f, SpatialMaxPooling.f = relu, max_pool
        return self

    def __exit__(self, *exc):
        for cls, f in self.saved:
            cls.f = f
        return False


def _zeroed(tree, paths, prefix=""):
    """``tree`` with the leaves at ``paths`` replaced by zeros."""
    import torch
    if isinstance(tree, dict):
        return {k: _zeroed(v, paths, f"{prefix}/{k}") for k, v in tree.items()}
    return torch.zeros_like(tree) if prefix in paths else tree


# --------------------------------------------------------------------------- #
def _lm_records(rnn):
    """The LM phase's seeded records: one-hot inputs of 1-based ids and
    the next ids as labels, (seq_len, vocab) and (seq_len,)."""
    import numpy as np
    ids = np.random.RandomState(0).randint(
        1, rnn["vocab"] + 1, size=(rnn["lm_records"], rnn["seq_len"] + 1))
    eye = np.eye(rnn["vocab"], dtype=np.float32)
    return [(eye[r[:-1] - 1], r[1:].astype(np.float32)) for r in ids]


def _id_records(rnn):
    """TextClassifierWithEmbedding's records: 1-based ids over the
    vocabulary and a class label."""
    import numpy as np
    rng = np.random.RandomState(3)
    ids = rng.randint(1, rnn["vocab"] + 1,
                      (rnn["text_batch"], rnn["text_seq"])).astype(np.float32)
    labels = (np.arange(rnn["text_batch"]) % rnn["classes"] + 1).astype(
        np.float32)
    return list(zip(ids, labels))


def _ae_records(rnn, n):
    """n synthetic MNIST records through the autoencoder CLI's pipeline
    (grey images scaled to [0, 1], the flattened image as the target)."""
    from bigdl_tpu_torch.dataset import DataSet, mnist
    from bigdl_tpu_torch.models.autoencoder.train import image_pipeline
    b = next((DataSet.array(mnist.synthetic(n)) >> image_pipeline(n)).data(
        train=False))
    return list(zip(b.data, b.labels))


def _rnn_cases(rnn):
    """(label, model factory, records, criterion, method factory, batch,
    tokens a record) for every timed case of R1-R3."""
    from bigdl_tpu_torch import models, nn
    from bigdl_tpu_torch.models.textclassifier.train import \
        _synthetic_samples
    from bigdl_tpu_torch.optim import SGD, Adagrad
    v, T = rnn["vocab"], rnn["seq_len"]
    lm_crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True)
    lm = _lm_records(rnn)
    text = [(s.feature, s.label) for s in _synthetic_samples(
        rnn["text_records"], rnn["classes"], rnn["text_seq"], rnn["embed"])]
    cases = []
    for name, hidden in rnn["lm"]:
        factory = models.SimpleRNN if name == "simple_rnn" else models.LstmLM
        cases.append((f"R1 {name}({v}, {hidden}, {v})",
                      lambda f=factory, h=hidden: f(v, h, v), lm, lm_crit,
                      lambda: SGD(learning_rate=rnn["lm_lr"]),
                      rnn["lm_batch"], T))
    for enc in rnn["text"]:
        cases.append((f"R2 TextClassifier({rnn['classes']}, {rnn['embed']}, "
                      f"{rnn['text_seq']}, {enc})",
                      lambda e=enc: models.TextClassifier(
                          rnn["classes"], rnn["embed"], rnn["text_seq"], e,
                          hidden=rnn["hidden"]),
                      text, nn.ClassNLLCriterion(),
                      lambda: Adagrad(learning_rate=rnn["text_lr"]),
                      rnn["text_batch"], rnn["text_seq"]))
    cases.append((f"R2 TextClassifierWithEmbedding({v}, {rnn['classes']}, "
                  f"{rnn['embed']}, {rnn['hidden']})",
                  lambda: models.TextClassifierWithEmbedding(
                      v, rnn["classes"], rnn["embed"], rnn["hidden"]),
                  _id_records(rnn), nn.ClassNLLCriterion(),
                  lambda: Adagrad(learning_rate=rnn["text_lr"]),
                  rnn["text_batch"], rnn["text_seq"]))
    cases.append((f"R3 Autoencoder({rnn['ae_code']})",
                  lambda: models.Autoencoder(rnn["ae_code"]),
                  _ae_records(rnn, 2 * rnn["ae_batch"]), nn.MSECriterion(),
                  lambda: Adagrad(learning_rate=rnn["ae_lr"]),
                  rnn["ae_batch"], 1))
    return cases


def _rnn_optimizer(model, records, criterion, method, batch):
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.optim import LocalOptimizer
    ds = DataSet.array([Sample(f, l) for f, l in records]) \
        >> SampleToBatch(batch)
    return LocalOptimizer(model, ds, criterion).set_optim_method(method)


def rnn_step_check(dev, label, make, records, criterion, batch, rnn):
    """One float32 training step of a model built from seed 1 on the card
    and on the CPU (bitwise equal) on the same batch: the loss within
    ``tol_loss`` relative, every gradient leaf within ``tol_grad`` of its
    max |g|, the CPU replaying the card's ReLU masks and max-pool
    argmaxes.  Returns the numbers."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.optim import loss_and_grads
    from bigdl_tpu_torch.utils import keychain
    from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map
    cpu = torch.device("cpu")
    card, host = make().build(1, device=dev), make().build(1, device=cpu)
    for a, b in zip(tree_leaves(card.params), tree_leaves(host.params)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{label}: build(seed=1) differs between "
                                 f"the card and the CPU")
    x = np.stack([f for f, _ in records[:batch]])
    y = np.stack([l for _, l in records[:batch]])
    key = keychain.prng_key(0)

    def step(m, d, pins):
        with pins:
            loss, g, _ = loss_and_grads(
                m, criterion, m.params, torch.as_tensor(x, device=d),
                torch.as_tensor(y, device=d), buffers=m.buffers, rng=key)
        return float(loss), tree_map(lambda a: a.cpu(), g)

    pins = []
    l_card, g_card = step(card, dev, pinned_decisions(record=pins))
    l_cpu, g_cpu = step(host, cpu, pinned_decisions(replay=pins))
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    if not (np.isfinite(l_card) and rel <= rnn["tol_loss"]):
        raise AssertionError(f"{label} step-0 loss card {l_card} vs cpu "
                             f"{l_cpu}: relative {rel:.3e}")
    worst = _check_grads(f"{label}, the card's decisions", g_card, g_cpu,
                         rnn["tol_grad"])
    return dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=rel,
                worst_grad=worst[0], worst_grad_leaf=worst[1],
                pinned=len(pins))


def rnn_perf_row(dev, label, make, records, criterion, method, batch,
                 tokens, rnn, steps=None):
    """Warm-up and timed LocalOptimizer steps on the card: the median step
    (the loop's computing time: the batch's copy, forward, backward and
    update, up to the loss read), sequences/s and tokens/s, peak, the
    batch's copy from pageable memory alone, and the step's matmul and
    convolution FLOPs over 67 TFLOP/s."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.optim import Trigger
    steps = steps or (rnn["warmup"], rnn["iters"])
    model = make().build(1, device=dev)
    opt = _rnn_optimizer(model, records, criterion, method, batch)
    b = next(opt.dataset.data(train=False))
    copy_ms = perf.input_copy_ms(b.data, dev)
    flops = perf.step_flops(model, criterion,
                            torch.as_tensor(b.data, device=dev),
                            torch.as_tensor(b.labels, device=dev))
    opt.set_end_when(Trigger.max_iteration(sum(steps)))
    times = perf._capture_step_times(opt)
    _peak_reset(dev)
    opt.optimize()
    if not np.isfinite(opt.state["loss"]):
        raise AssertionError(f"{label}: loss {opt.state['loss']}")
    steady = [t * 1e3 for t in times[steps[0]:]]
    step_ms = statistics.median(steady)
    bound_ms = flops / PEAK_FLOPS["float32"] * 1e3
    row = dict(label=label, batch=batch, step_ms=step_ms, steps_ms=steady,
               sequences_per_s=batch / step_ms * 1e3,
               tokens_per_s=batch * tokens / step_ms * 1e3,
               peak_mib=(_peak(dev) / 2**20 if _peak(dev) else None),
               input_copy_ms=copy_ms, input_mb=b.data.nbytes / 1e6,
               step_gflop=flops / 1e9, fp32_bound_ms=bound_ms,
               fp32_peak_share=bound_ms / step_ms, loss=opt.state["loss"])
    log(f"[rnn] {label} batch {batch}: median step {step_ms:.3f} ms "
        f"({_ms_list(steady)}), {row['sequences_per_s']:.1f} sequences/s, "
        f"{row['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{_mib(_peak(dev))}, input copy {copy_ms:.3f} ms for "
        f"{row['input_mb']:.1f} MB, {row['step_gflop']:.2f} GFLOP a step "
        f"(matmul and convolution, torch.utils.flop_counter), "
        f"{row['fp32_peak_share'] * 100:.2f}% of 67 TFLOP/s float32 (bound "
        f"{bound_ms:.3f} ms)")
    return row, opt


def _lbfgs_run(dev, records, rnn):
    """``lbfgs_outer`` iterations of LBFGS(max_iter, line_search=True)
    through LocalOptimizer's full-batch path on the Autoencoder built
    from seed 1: (every loss the method evaluated, in order, and its
    evaluations)."""
    from bigdl_tpu_torch import models, nn
    from bigdl_tpu_torch.optim import LBFGS, Trigger
    method = LBFGS(max_iter=rnn["lbfgs_max_iter"], line_search=True)
    hist = []
    optimize = method.optimize

    def recorded(feval, x, epoch=1):
        x, h = optimize(feval, x, epoch)
        hist.extend(h)
        return x, h
    method.optimize = recorded
    model = models.Autoencoder(rnn["ae_code"]).build(1, device=dev)
    opt = _rnn_optimizer(model, records, nn.MSECriterion(), method,
                         len(records))
    opt.set_end_when(Trigger.max_iteration(rnn["lbfgs_outer"]))
    t0 = time.perf_counter()
    opt.optimize()
    return hist, method._state["func_evals"], time.perf_counter() - t0


def phase_rnn(dev, rnn=RNN, profile_path=None):
    """The recurrent and text path (see the module docstring): R1-R3
    through LocalOptimizer with each model's step held against the CPU,
    LBFGS on the card against the CPU, R4 the CLIs, R5 NMS;
    ``profile_path`` adds one profiled R2 LSTM step.  Returns the rows
    and the checks' numbers."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.autoencoder import test as ae_test
    from bigdl_tpu_torch.models.autoencoder import train as ae_train
    from bigdl_tpu_torch.models.rnn import test as rnn_test
    from bigdl_tpu_torch.models.rnn import train as rnn_train
    from bigdl_tpu_torch.models.textclassifier import test as tc_test
    from bigdl_tpu_torch.models.textclassifier import train as tc_train
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.utils import file_io
    t_phase = time.perf_counter()
    guarded = _repo_files_state(("flight", "TUNNEL_INCIDENTS.json"))
    _reset_launches()
    out = dict(rows=[], checks={})

    # R1-R3: each case's step against the CPU, then its timed steps
    cpu = torch.device("cpu")
    for label, make, records, crit, method, batch, tokens in \
            _rnn_cases(rnn):
        check = rnn_step_check(dev, label, make, records, crit, batch, rnn)
        out["checks"][label] = check
        log(f"[rnn] {label}: one float32 step, card vs CPU: loss "
            f"{check['loss_card']:.7f} / {check['loss_cpu']:.7f} (relative "
            f"{check['loss_rel']:.2e}); every gradient leaf within "
            f"{rnn['tol_grad']} of its max |g|, worst "
            f"{check['worst_grad']:.2e} at {check['worst_grad_leaf']} "
            f"({check['pinned']} ReLU masks and max-pool argmaxes pinned)")
        # one step of the embedding variant, after the others' 1 + 5
        steps = ((0, 1) if label.startswith("R2 TextClassifierWith")
                 else None)
        row, opt = rnn_perf_row(dev, label, make, records, crit, method(),
                                batch, tokens, rnn, steps)
        out["rows"].append(row)
        if profile_path and label.endswith("lstm)"):
            root, ext = os.path.splitext(profile_path)
            stats = {}
            profile_device(lambda: run_iterations(opt, 1),
                           f"{label} train step (batch {batch})",
                           f"{root}_rnn_lstm{ext}", stats)
            row["profile"] = stats
        del opt
        release(dev)

    # R3: LBFGS on the card against the CPU, one batch
    records = _ae_records(rnn, rnn["ae_batch"])
    h_card, evals_card, s_card = _lbfgs_run(dev, records, rnn)
    h_cpu, evals_cpu, _ = _lbfgs_run(cpu, records, rnn)
    worst = max(abs(a - b) / abs(b) for a, b in zip(h_card, h_cpu))
    if not (len(h_card) == len(h_cpu) and all(np.isfinite(h_card))
            and worst <= rnn["tol_lbfgs"] and h_card[-1] < h_card[0]):
        raise AssertionError(f"R3 LBFGS loss history card {h_card} vs cpu "
                             f"{h_cpu}: worst relative {worst:.3e}")
    out["lbfgs"] = dict(history=h_card, history_cpu=h_cpu, rel=worst,
                        evals=evals_card, evals_cpu=evals_cpu,
                        seconds=s_card)
    log(f"[rnn] R3 LBFGS(max_iter={rnn['lbfgs_max_iter']}, line_search) x "
        f"{rnn['lbfgs_outer']} on one batch of {rnn['ae_batch']}: "
        f"{len(h_card)} losses {h_card[0]:.6f} -> {h_card[-1]:.6f}, "
        f"{evals_card} evaluations ({evals_cpu} on the CPU) in "
        f"{s_card:.3f} s; history within {worst:.2e} relative of the CPU's")
    release(dev)

    # R4: the CLIs, checkpoints in a temporary directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rnn_")
    out["cli"] = {}
    logger = logging.getLogger("bigdl_tpu_torch.optim")

    def train_cli(main_fn, argv):
        record, level = _IterationLog(), logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(record)
        try:
            opt = main_fn(argv + ["--device", dev.type])
        finally:
            logger.removeHandler(record)
            logger.setLevel(level)
        if not (record.losses and all(np.isfinite(record.losses))):
            raise AssertionError(f"R4 {argv}: losses {record.losses}")
        return opt, record.losses

    def test_cli(main_fn, argv, want):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main_fn(argv + ["--device", dev.type])
        printed = buf.getvalue().strip()
        if want not in printed:
            raise AssertionError(f"R4 eval CLI {argv} printed {printed!r}")
        return printed

    try:
        for cell in ("rnn", "lstm"):
            ck = os.path.join(tmp, f"rnn_{cell}")
            opt, losses = train_cli(rnn_train.main, rnn["rnn_cli"] + [
                "--cell", cell, "--checkpoint", ck])
            if not losses[-1] < losses[0]:
                raise AssertionError(f"R4 rnn --cell {cell}: loss "
                                     f"{losses[0]} -> {losses[-1]}")
            model_path, _, n = file_io.latest_checkpoint(ck)
            printed = test_cli(rnn_test.main, [
                "--synthetic", "--model", model_path, "--dictionary",
                os.path.join(ck, "dictionary.json")], "Perplexity is")
            out["cli"][f"rnn_{cell}"] = dict(
                losses=losses, validation=str(opt.validation_results[0][1]),
                eval=printed)
        for enc in ("cnn", "lstm"):
            opt, losses = train_cli(tc_train.main, rnn["text_cli"] + rnn[
                "text_widths"] + ["--encoder", enc])
            path = os.path.join(tmp, f"text_{enc}.bin")
            opt.model.save(path)
            printed = test_cli(tc_test.main, ["--synthetic", "--model", path]
                               + rnn["text_widths"],
                               "Top1Accuracy is Accuracy(")
            out["cli"][f"text_{enc}"] = dict(
                losses=losses, validation=str(opt.validation_results[0][1]),
                eval=printed)
        ck = os.path.join(tmp, "autoencoder")
        opt, losses = train_cli(ae_train.main, rnn["ae_cli"] + [
            "--checkpoint", ck])
        model_path, _, n = file_io.latest_checkpoint(ck)
        printed = test_cli(ae_test.main, ["--synthetic", "--model",
                                          model_path], "Loss is")
        out["cli"]["autoencoder"] = dict(losses=losses, validation=None,
                                         eval=printed)
        for name, r in out["cli"].items():
            log(f"[rnn] R4 {name} CLI: {len(r['losses'])} steps, loss "
                f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, validation "
                f"{r['validation']}; eval CLI: {r['eval']!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    release(dev)

    # R5: NMS on the card against the CPU
    rng = np.random.RandomState(5)
    xy = rng.rand(rnn["nms_boxes"], 2) * 1000
    wh = rng.rand(rnn["nms_boxes"], 2) * 100 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.rand(rnn["nms_boxes"]).astype(np.float32)
    args = (rnn["nms_iou"], rnn["nms_max"])
    keep_cpu, count_cpu = nn.nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), *args)
    tb = torch.as_tensor(boxes, device=dev)
    ts = torch.as_tensor(scores, device=dev)
    keep, count = nn.nms(tb, ts, *args)
    if not (torch.equal(keep.cpu(), keep_cpu) and int(count) == int(
            count_cpu) > 0):
        raise AssertionError(f"R5 NMS: card {int(count)} boxes, CPU "
                             f"{int(count_cpu)}, indices differ")
    nms_ms = (cuda_ms(lambda: nn.nms(tb, ts, *args), iters=5, warmup=1)
              if dev.type == "cuda" else None)
    out["nms"] = dict(count=int(count), ms=nms_ms)
    log(f"[rnn] R5 NMS over {rnn['nms_boxes']} boxes (IoU "
        f"{rnn['nms_iou']}, max {rnn['nms_max']}): {int(count)} kept, "
        f"indices equal the CPU's; "
        + ("n/a (CPU)" if nms_ms is None else f"{nms_ms:.3f} ms")
        + " a call on the device")

    if _repo_files_state(("flight", "TUNNEL_INCIDENTS.json")) != guarded:
        raise AssertionError("the rnn phase changed the repository's "
                             "flight/ or TUNNEL_INCIDENTS.json")
    out["launches"] = _launches()
    out["seconds"] = time.perf_counter() - t_phase
    if dev.type == "cuda" and out["seconds"] > rnn["limit_s"]:
        raise AssertionError(f"the rnn phase took {out['seconds']:.1f} s, "
                             f"over {rnn['limit_s']} s")
    return out


def rnn_summary(out):
    """The rnn phase's numbers for its summary line."""
    return {
        "rows": [{k: r[k] for k in ("label", "batch", "step_ms",
                                    "sequences_per_s", "tokens_per_s",
                                    "peak_mib", "input_copy_ms",
                                    "step_gflop", "fp32_peak_share")}
                 | ({"profile": r["profile"]} if "profile" in r else {})
                 for r in out["rows"]],
        "checks": {k: {kk: v[kk] for kk in ("loss_rel", "worst_grad",
                                            "worst_grad_leaf")}
                   for k, v in out["checks"].items()},
        "lbfgs": {k: out["lbfgs"][k] for k in ("history", "rel", "evals",
                                               "seconds")},
        "cli": {k: {"first_loss": v["losses"][0],
                    "last_loss": v["losses"][-1],
                    "validation": v["validation"]}
                for k, v in out["cli"].items()},
        "nms": out["nms"], "port_kernel_launches": out["launches"],
        "seconds": out["seconds"]}


# --------------------------------------------------------------------- #
# io: model files and import                                            #
# --------------------------------------------------------------------- #
def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def caffe_layer(name: str, kind: str, arrays) -> bytes:
    """One V2 ``LayerParameter`` (field 100 of ``NetParameter``): name 1,
    type 2, and a ``BlobProto`` (field 7) per array: its shape (field 7,
    a ``BlobShape`` of packed dims) and packed float32 data (field 5)."""
    import numpy as np
    out = _pb_len(1, name.encode()) + _pb_len(2, kind.encode())
    for a in arrays:
        a = np.ascontiguousarray(a, "<f4")
        dims = b"".join(_pb_varint(int(d)) for d in a.shape)
        out += _pb_len(7, _pb_len(7, _pb_len(1, dims)) + _pb_len(5, a.tobytes()))
    return _pb_len(100, out)


def _named_weights(model):
    """(name, kind, [weight, bias]) of every named conv or linear leaf of
    a container tree, host float32."""
    from bigdl_tpu_torch import nn
    out = []

    def walk(m, p):
        if getattr(m, "modules", None):
            for i, c in enumerate(m.modules):
                walk(c, p[str(i)])
        elif m._name and isinstance(m, (nn.SpatialConvolution, nn.Linear)):
            kind = ("InnerProduct" if isinstance(m, nn.Linear)
                    else "Convolution")
            out.append((m._name, kind, [p["weight"].cpu().numpy(),
                                        p["bias"].cpu().numpy()]))
    walk(model, model.params)
    return out


def write_caffemodel(model, model_path, def_path):
    """A caffemodel of ``model``'s named conv and linear weights and a
    minimal prototxt; returns the layers written."""
    layers = _named_weights(model)
    with open(model_path, "wb") as f:
        f.write(_pb_len(1, b"net") + b"".join(
            caffe_layer(n, k, a) for n, k, a in layers))
    with open(def_path, "w") as f:
        f.write('name: "net"\n')
    return len(layers)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _leaves_equal(a, b):
    """(bitwise equal, leaves) over the params and buffers of two
    modules."""
    import torch
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    la = tree_leaves((a.params, a.buffers))
    lb = tree_leaves((b.params, b.buffers))
    return (len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y.to(x.device))
        for x, y in zip(la, lb))), len(la)


def _logp(model, x, dev):
    import torch
    with torch.no_grad():
        y, _ = model.apply(model.params, torch.as_tensor(x, device=dev),
                           buffers=model.buffers, training=False)
    return y.float().cpu().numpy()


def _io_check(label, src, got, x, dev, tol, host_logp=None, tol_cpu=None):
    """Every leaf bitwise, then the log-probs on ``x``: the loaded model's
    within ``tol`` of the source's on the card, and within ``tol_cpu`` of
    the CPU forward ``host_logp`` with top-1 equal."""
    import numpy as np
    same, n = _leaves_equal(src, got)
    if not same:
        raise AssertionError(f"[io] {label}: a loaded leaf differs from its "
                             f"source ({n} leaves)")
    want, have = _logp(src, x, dev), _logp(got, x, dev)
    diff = float(np.abs(want - have).max())
    if not diff <= tol:
        raise AssertionError(f"[io] {label}: loaded log-probs differ from "
                             f"the source's by {diff} (tolerance {tol})")
    row = dict(leaves=n, card_max_abs=diff)
    if host_logp is not None:
        cpu_diff = float(np.abs(have - host_logp).max())
        top_ok = bool((have.argmax(-1) == host_logp.argmax(-1)).all())
        if not cpu_diff <= tol_cpu or not top_ok:
            raise AssertionError(f"[io] {label}: card vs CPU log-probs "
                                 f"{cpu_diff} (tolerance {tol_cpu}), top-1 "
                                 f"equal {top_ok}")
        row.update(cpu_max_abs=cpu_diff, top1_equal=top_ok)
    return row


def _write_idx(folder, n, seed=0):
    """Synthetic t10k IDX files: random bytes with a label-dependent
    band, labels 0-9."""
    import struct

    import numpy as np
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 50, size=(n, 28, 28)).astype(np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    for i in range(n):
        images[i, labels[i] * 2:labels[i] * 2 + 3, :] += 150
    with open(os.path.join(folder, "t10k-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with open(os.path.join(folder, "t10k-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def phase_io(dev, io=IO, smi=""):
    """Model files and import on ``dev``: a state dict, Torch7 files and a
    caffemodel written and read back at ImageNet width, DLClassifier, the
    two example CLIs and the key-chain build; returns the rows."""
    import contextlib
    import io as sio
    import shutil
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import models, nn
    from bigdl_tpu_torch.example import image_classification, load_model
    from bigdl_tpu_torch.ml import DLClassifier
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils import torch_file, torch_import
    from bigdl_tpu_torch.utils.caffe_loader import CaffeLoader
    from bigdl_tpu_torch.utils.params import params_to_numpy
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    _reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    out = dict(formats={})
    try:
        def resnet(seed):
            return models.ResNet(1000, depth=50, shortcut_type="B",
                                 dataset="imagenet").build(seed=seed,
                                                           device=dev)

        rs = np.random.RandomState(0)
        x224 = rs.rand(io["images"], 3, 224, 224).astype(np.float32) * 2 - 1
        x227 = rs.rand(io["images"], 3, 227, 227).astype(np.float32) * 2 - 1
        src = resnet(io["src_seed"]).evaluate()
        n_params = sum(int(a.numel()) for a in tree_leaves(src.params))
        def host_logp(make, model, x):
            """The port's CPU forward of ``x`` on ``model``'s weights."""
            host = make().load_numpy_tree(
                params_to_numpy(model.params), params_to_numpy(model.buffers),
                device="cpu").evaluate()
            return _logp(host, x, torch.device("cpu"))

        t0 = time.perf_counter()
        resnet_cpu = host_logp(lambda: models.ResNet(
            1000, depth=50, shortcut_type="B", dataset="imagenet"), src, x224)
        log(f"[io] ResNet-50 {n_params} parameters; the CPU forward of "
            f"{io['images']} images took {time.perf_counter() - t0:.2f} s")

        def timed(fn):
            _sync(dev)
            t0 = time.perf_counter()
            r = fn()
            _sync(dev)
            return r, time.perf_counter() - t0

        def record(fmt, path, save_s, parse_s, to_card_s, check):
            mb = os.path.getsize(path) / 1e6
            load_s = parse_s + to_card_s
            row = dict(file_mb=mb, save_s=save_s, load_s=load_s,
                       load_mb_per_s=mb / load_s, parse_s=parse_s,
                       to_card_ms=to_card_s * 1e3, **check)
            out["formats"][fmt] = row
            log(f"[io] {fmt}: file {mb:.3f} MB, save {save_s:.3f} s, load "
                f"{load_s:.3f} s ({row['load_mb_per_s']:.1f} MB/s: host "
                f"parse {parse_s:.3f} s, into the card {to_card_s * 1e3:.1f}"
                f" ms), {check['leaves']} leaves bitwise, log-probs vs "
                f"source max |d| {check['card_max_abs']:.3g}"
                + (f", vs CPU {check['cpu_max_abs']:.3g} top-1 equal"
                   if "cpu_max_abs" in check else "") + f" | {smi}")

        # state dict: save_pytorch, then load_pytorch into seed 2
        sd_path = os.path.join(tmp, "resnet50.pth")
        _, save_s = timed(lambda: src.save_pytorch(sd_path))
        dst = resnet(io["dst_seed"]).evaluate()
        sd, parse_s = timed(lambda: torch_import.read_torch_checkpoint(
            sd_path))
        _, copy_s = timed(lambda: torch_import.load_torch_state_dict(dst, sd))
        del sd
        record("state_dict", sd_path, save_s, parse_s, copy_s,
               _io_check("state dict", src, dst, x224, dev, io["tol_card"],
                         resnet_cpu, io["tol_cpu"]))
        # the entry point a user calls, once more on the same file
        _, entry_s = timed(lambda: dst.load_pytorch(sd_path))
        out["formats"]["state_dict"]["load_pytorch_s"] = entry_s
        del dst
        release(dev)

        # Torch7: save_torch, Module.load_torch on the default device (the
        # card; a CPU rehearsal names the CPU)
        default = None if dev.type == "cuda" else dev
        inception = models.Inception_v1(1000).build(
            seed=io["src_seed"], device=dev).evaluate()
        for fmt, model, x, logp in (
                ("t7_resnet50", src, x224, resnet_cpu),
                ("t7_inception_v1", inception, x224, host_logp(
                    lambda: models.Inception_v1(1000), inception, x224))):
            path = os.path.join(tmp, fmt + ".t7")
            _, save_s = timed(lambda: model.save_torch(path))
            obj, parse_s = timed(lambda: torch_file.load(path))
            got, build_s = timed(
                lambda: torch_file.module_from_torch(obj, default))
            del obj
            if got._device() != dev:
                raise AssertionError(f"[io] load_torch put {fmt} on "
                                     f"{got._device()}, not {dev}")
            record(fmt, path, save_s, parse_s, build_s,
                   _io_check(fmt, model, got.evaluate(), x, dev,
                             io["tol_card"], logp, io["tol_cpu"]))
            _, entry_s = timed(lambda: nn.Module.load_torch(path, default))
            out["formats"][fmt]["load_torch_s"] = entry_s
            del got
            release(dev)
        del inception

        # Caffe: AlexNet's weights as a caffemodel, into seed 2
        alex = models.AlexNet(1000).build(seed=io["src_seed"],
                                          device=dev).evaluate()
        mp, dp = (os.path.join(tmp, "alexnet.caffemodel"),
                  os.path.join(tmp, "deploy.prototxt"))
        n_layers, save_s = timed(lambda: write_caffemodel(alex, mp, dp))
        if n_layers != 8:
            raise AssertionError(f"[io] AlexNet wrote {n_layers} caffe "
                                 f"layers, not 8 (conv1..fc8)")
        dst = models.AlexNet(1000).build(seed=io["dst_seed"],
                                         device=dev).evaluate()
        loader = CaffeLoader(dp, mp, match_all=False)
        _, parse_s = timed(lambda: loader.net)
        _, copy_s = timed(lambda: loader.copy_parameters(dst))
        record("caffe_alexnet", mp, save_s, parse_s, copy_s,
               _io_check("caffe AlexNet", alex, dst, x227, dev,
                         io["tol_card"], host_logp(
                             lambda: models.AlexNet(1000), alex, x227),
                         io["tol_cpu"]))
        _, entry_s = timed(lambda: dst.load_caffe(dp, mp, match_all=False))
        out["formats"]["caffe_alexnet"]["load_caffe_s"] = entry_s
        del alex, dst, loader
        release(dev)

        # DLClassifier over dlc_rows rows, the tail padded
        rows = rs.rand(io["dlc_rows"], 3, 224, 224).astype(np.float32) * 2 - 1
        clf = DLClassifier(src, (io["dlc_batch"], 3, 224, 224))
        calls = []
        fwd = clf._forward_batch
        clf._forward_batch = lambda b: calls.append(b.shape[0]) or fwd(b)
        clf.predict_class(rows[:io["dlc_batch"]])  # warm-up
        calls.clear()
        pred, dlc_s = timed(lambda: clf.predict_class(rows))
        own = np.concatenate([
            _logp(src, rows[i:i + io["dlc_batch"]], dev)
            for i in range(0, len(rows), io["dlc_batch"])])
        if calls != [io["dlc_batch"]] * len(calls) or \
                len(calls) * io["dlc_batch"] < len(rows):
            raise AssertionError(f"[io] DLClassifier batches {calls}")
        srt = np.sort(own, axis=-1)
        ties = srt[:, -1] - srt[:, -2] < 1e-5
        bad = (pred != own.argmax(-1) + 1) & ~ties
        if bad.any():
            raise AssertionError(f"[io] DLClassifier classes differ from the "
                                 f"model's argmax + 1 at rows "
                                 f"{np.nonzero(bad)[0].tolist()}")
        out["dlc"] = dict(rows=len(rows), calls=len(calls),
                          rows_per_s=len(rows) / dlc_s, seconds=dlc_s,
                          ties=int((pred != own.argmax(-1) + 1).sum()))
        log(f"[io] DLClassifier: {len(rows)} rows in {len(calls)} calls of "
            f"{io['dlc_batch']} (tail padded), {out['dlc']['rows_per_s']:.1f}"
            f" rows/s, classes equal to argmax + 1 of the model's forward "
            f"({out['dlc']['ties']} ties) | {smi}")
        del src, clf
        release(dev)

        # the example CLIs on synthetic MNIST and a PNG folder
        _write_idx(tmp, io["mnist_rows"])
        lenet = models.LeNet5(10).build(seed=io["src_seed"], device=dev)
        bigdl_path, t7_path = (os.path.join(tmp, "lenet.bin"),
                               os.path.join(tmp, "lenet.t7"))
        lenet.save(bigdl_path)
        lenet.save_torch(t7_path)
        lmp, ldp = (os.path.join(tmp, "lenet.caffemodel"),
                    os.path.join(tmp, "lenet.prototxt"))
        write_caffemodel(lenet, lmp, ldp)
        cli = {}
        for kind, extra in (("bigdl", ["--model", bigdl_path]),
                            ("torch", ["--model", t7_path]),
                            ("caffe", ["--model", lmp, "--caffeDefPath", ldp,
                                       "--modelFactory", "lenet"])):
            buf = sio.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                results = load_model.main(["--modelType", kind, "-f", tmp,
                                           "--dataset", "mnist", "-b", "128",
                                           "--device", dev.type] + extra)
            cli[kind] = dict(results={str(m): str(r) for m, r in results},
                             seconds=time.perf_counter() - t0,
                             lines=buf.getvalue().strip().splitlines())
            log(f"[io] load_model --modelType {kind}: "
                + "; ".join(cli[kind]["lines"])
                + f" ({cli[kind]['seconds']:.2f} s) | {smi}")
        if not (cli["bigdl"]["results"] == cli["torch"]["results"]
                == cli["caffe"]["results"]):
            raise AssertionError(f"[io] the three model types disagree: "
                                 f"{json.dumps(cli)}")
        from PIL import Image
        folder = os.path.join(tmp, "images")
        prs = np.random.RandomState(1)
        for cls in ("a", "b"):
            os.makedirs(os.path.join(folder, cls))
            for i in range(io["png_per_class"]):
                Image.fromarray(prs.randint(0, 255, size=(40, 40, 3)).astype(
                    np.uint8)).save(os.path.join(folder, cls, f"{i}.png"))
        buf = sio.StringIO()
        with contextlib.redirect_stdout(buf):
            lines = image_classification.main(
                ["--model", bigdl_path, "-f", folder, "--modelType", "lenet",
                 "-b", "4", "--topN", "2", "--device", dev.type])
        printed = buf.getvalue().strip().splitlines()
        if len(lines) != 2 * io["png_per_class"] or len(printed) != len(
                lines) or not all(len(c) == 2 and all(1 <= k <= 10 for k in c)
                                  for _, c in lines):
            raise AssertionError(f"[io] image_classification printed "
                                 f"{printed}")
        log(f"[io] image_classification: {len(printed)} lines, first "
            f"{printed[0]!r} | {smi}")
        cli["image_classification"] = dict(lines=len(printed))
        out["cli"] = cli
        del lenet

        # the repaired build: one GPT-2-small tree from the key chain
        t0 = time.perf_counter()
        lm = TransformerLM(device=dev, **GPT2_SMALL).build(0)
        _sync(dev)
        out["gpt2_build_s"] = time.perf_counter() - t0
        ref = build_lm(dev, GPT2_SMALL, 0)
        same, n = _leaves_equal(lm, ref)
        if not same:
            raise AssertionError("[io] TransformerLM.build(0) differs from "
                                 "the script's cached seed-0 tree")
        del lm, ref
        release(dev)
        out["tree_draws"] = dict(TREE_DRAWS)
        log(f"[io] TransformerLM(**GPT2_SMALL).build(0): "
            f"{out['gpt2_build_s']:.2f} s on the host and the copy "
            f"({n} leaves, equal to the cached tree); the script drew "
            f"{TREE_DRAWS['count']} trees in {TREE_DRAWS['seconds']:.2f} s "
            f"| {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = _launches()
    if any(out["launches"].values()):
        raise AssertionError(f"[io] the port's kernels launched on the io "
                             f"path: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    if dev.type == "cuda" and out["seconds"] > io["limit_s"]:
        raise AssertionError(f"[io] the phase took {out['seconds']:.1f} s, "
                             f"over {io['limit_s']} s")
    return out


def _png_tree(root, data):
    """``<root>/<split>/<class>/<i>.png`` from seed 0: dark noise with
    the class's color channel raised (a learnable tie), sizes cycled
    through ``data["image_sizes"]``."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(0)
    sizes, k = data["image_sizes"], 0
    for split, n in (("train", data["train_per_class"]),
                     ("val", data["val_per_class"])):
        for c in range(data["classes"]):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                h, w = sizes[k % len(sizes)]
                k += 1
                arr = rng.randint(0, 60, size=(h, w, 3)).astype(np.uint8)
                arr[:, :, c % 3] += np.uint8(120)
                Image.fromarray(arr).save(os.path.join(d, f"{i:03d}.png"))


class _python_paths:
    """Inside it, the port takes its Python paths
    (``BIGDL_TPU_NO_NATIVE=1``) in place of the host library."""

    def __enter__(self):
        os.environ["BIGDL_TPU_NO_NATIVE"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("BIGDL_TPU_NO_NATIVE", None)


def _record_pairs(files):
    """(bytes, label) of every record of ``DataSet.record_files(files)``."""
    from bigdl_tpu_torch.dataset import DataSet
    return [(r.data, float(r.label)) for r in
            DataSet.record_files(files).data(train=False)]


def _first_fed_batch(paths, batch):
    """``pipeline_bench.batch_stream``'s first batch."""
    from bigdl_tpu_torch.models.utils import pipeline_bench as pb
    stream = pb.batch_stream(paths, batch)
    try:
        return next(stream)
    finally:
        stream.close()


def _host_stages(paths, batch, repeats=3):
    """Host ms of the feed's stages, one at a time: ``read_shard`` of one
    shard with its index built (every payload's CRC checked) and from
    the index cache, and one native crop/flip/pack of ``batch`` records
    on ``batch_stream``'s threads (median of ``repeats``)."""
    import numpy as np
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.dataset import seqfile
    from bigdl_tpu_torch.models.utils import pipeline_bench as pb

    def ms(fn):
        t0 = time.perf_counter()
        r = fn()
        return (time.perf_counter() - t0) * 1e3, r

    seqfile._INDEX_CACHE.clear()
    cold, recs = ms(lambda: list(seqfile.read_shard(paths[0])))
    warm = statistics.median(ms(lambda: list(seqfile.read_shard(paths[0])))[0]
                             for _ in range(repeats))
    rng = np.random.RandomState(0)
    span = pb.STORED - pb.CROP
    records = [recs[i % len(recs)].data for i in range(batch)]
    cy, cx = rng.randint(0, span + 1, batch), rng.randint(0, span + 1, batch)
    flips = rng.randint(0, 2, batch)
    threads = max(4, (os.cpu_count() or 8) // 2)  # batch_stream's
    lib = native.get()
    packs = [ms(lambda: lib.crop_flip_pack(records, pb.STORED, pb.STORED,
                                           pb.CROP, cy, cx, flips,
                                           threads))[0]
             for _ in range(repeats + 1)][1:]
    return dict(shard_records=len(recs),
                shard_mb=os.path.getsize(paths[0]) / 1e6,
                read_shard_indexing_ms=cold, read_shard_cached_ms=warm,
                pack_ms=statistics.median(packs),
                pack_threads=min(threads, max(1, batch // 8)),
                host_cpus=os.cpu_count())


def phase_data(dev, data=DATA, smi=""):
    """The record-shard ImageNet path on ``dev`` (see the module
    docstring, item 21): D1 ``pipeline_bench`` and its checks, D2 the
    record formats and the ImageNet CLIs.  Returns the rows."""
    import contextlib
    import glob
    import io as sio
    import shutil
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.dataset import hadoop_seqfile as hs
    from bigdl_tpu_torch.dataset import image
    from bigdl_tpu_torch.dataset.types import ByteRecord
    from bigdl_tpu_torch.example import load_model
    from bigdl_tpu_torch.models.inception import test as inception_test
    from bigdl_tpu_torch.models.inception import train as inception_train
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.models.utils import pipeline_bench as pb
    from bigdl_tpu_torch.models.utils import seqfile_generator
    from bigdl_tpu_torch.utils import keychain
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    guarded = _repo_files_state(("flight", "TUNNEL_INCIDENTS.json"))
    _reset_launches()
    t0 = time.perf_counter()
    lib = native.get()
    out = dict(native_build_s=time.perf_counter() - t0,
               native_library=str(native.library_path()))
    if lib is None:
        raise AssertionError("[data] the host library is switched off "
                             "(BIGDL_TPU_NO_NATIVE)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        # D1: pipeline_bench at the reference's defaults
        work = os.path.join(tmp, "pipe")
        os.makedirs(work)
        d1 = pb.run(data["batch"], data["iters"], data["warmup"], work,
                    data["records"], device=dev)
        if not d1["native_batcher"]:
            raise AssertionError("[data] D1 ran without the native batcher")
        losses = list(d1["last_loss"].values())
        if not np.isfinite(losses).all():
            raise AssertionError(f"[data] D1 losses {losses}")
        paths = sorted(glob.glob(os.path.join(work, "imagenet-*")))
        x, y = _first_fed_batch(paths, data["batch"])
        with _python_paths():
            px, py = _first_fed_batch(paths, data["batch"])
        fed_equal = bool(np.array_equal(x, px) and np.array_equal(y, py))
        if not fed_equal:
            raise AssertionError("[data] the first fed batch differs "
                                 "between the native and the Python path")
        host = pb.run_host_only(data["batch"], data["iters"],
                                data["warmup"], work, data["records"],
                                card_rate=d1["synthetic_img_s"])
        stages = _host_stages(paths, data["batch"])
        log(f"[data] D1 pipeline_bench batch {data['batch']}, "
            f"{data['iters']} steps after {data['warmup']}, "
            f"{data['records']} stored records: synthetic_img_s "
            f"{d1['synthetic_img_s']:.2f} ({d1['synthetic_step_ms']:.3f} ms a "
            f"step), pipeline_img_s {d1['pipeline_img_s']:.2f} "
            f"({d1['pipeline_step_ms']:.3f} ms; of it blocked on the "
            f"Prefetcher {d1['pipeline_wait_ms']:.3f} ms, in the copy call "
            f"{d1['pipeline_copy_call_ms']:.3f} ms), ratio "
            f"{d1['ratio']:.4f}; "
            f"batch copy {d1['input_copy_ms']:.3f} ms for "
            f"{d1['input_bytes']} bytes; peak allocated "
            f"{_mib(d1['peak_bytes'])}; native_batcher: "
            f"{str(d1['native_batcher']).lower()} | {smi}")
        log(f"[data] D1 host-only delivery {host['value']:.2f} images/s, "
            f"headroom {host['headroom_vs_card_rate']:.3f} over this run's "
            f"synthetic rate; native_batcher: "
            f"{str(host['native_batcher']).lower()}; first fed batch native "
            f"vs Python bitwise equal: {str(fed_equal).lower()} | {smi}")
        log(f"[data] D1 host stages: read_shard of one "
            f"{stages['shard_mb']:.1f} MB shard ({stages['shard_records']} "
            f"records) {stages['read_shard_indexing_ms']:.3f} ms indexing "
            f"(every CRC checked), {stages['read_shard_cached_ms']:.3f} ms "
            f"from the index cache; pack of {data['batch']} on "
            f"{stages['pack_threads']} threads {stages['pack_ms']:.3f} ms; "
            f"{stages['host_cpus']} host CPUs | {smi}")
        # one step at check_batch on the card against the CPU
        n = data["check_batch"]
        xb, yb = np.ascontiguousarray(x[:n]), np.ascontiguousarray(y[:n])
        key = keychain.prng_key(0)
        losses = {}
        for where in (dev, torch.device("cpu")):
            step, params, buffers, opt_state = pb._train_pieces(n, where)
            params, _, _, loss = step(params, buffers, opt_state,
                                      torch.as_tensor(xb, device=where),
                                      torch.as_tensor(yb, device=where), key)
            losses[where.type] = float(loss)
            bad = [i for i, a in enumerate(tree_leaves(params))
                   if a.dtype != torch.float32 or not torch.isfinite(a).all()]
            if bad:
                raise AssertionError(f"[data] {where.type} step: master "
                                     f"leaves {bad[:5]} not finite float32")
            del step, params, buffers, opt_state
        rel = abs(losses[dev.type] - losses["cpu"]) / abs(losses["cpu"])
        if not rel <= data["tol_loss"]:
            raise AssertionError(f"[data] batch-{n} step loss on the card "
                                 f"{losses[dev.type]} vs the CPU "
                                 f"{losses['cpu']}: {rel:.3e} relative "
                                 f"(tolerance {data['tol_loss']})")
        log(f"[data] D1 batch-{n} step from the first fed batch: loss card "
            f"{losses[dev.type]:.6f}, CPU {losses['cpu']:.6f}, relative "
            f"{rel:.3e} (tolerance {data['tol_loss']}); masters finite "
            f"float32 | {smi}")
        out["d1"] = dict(d1, host_only=host, fed_equal=fed_equal,
                         host_stages=stages, check_losses=losses,
                         check_rel=rel)
        del x, y, px, py
        shutil.rmtree(work, ignore_errors=True)
        release(dev)

        # D2: the record formats and the ImageNet CLIs
        tree = os.path.join(tmp, "tree")
        shards = os.path.join(tmp, "shards")
        mixed = os.path.join(tmp, "mixed")
        _png_tree(tree, data)
        buf = sio.StringIO()
        with contextlib.redirect_stdout(buf):
            counts = seqfile_generator.main(
                ["-f", tree, "-o", shards, "-p", str(data["shards"]),
                 "--validate"])
        want = {"train": data["classes"] * data["train_per_class"],
                "val": data["classes"] * data["val_per_class"]}
        if counts != want:
            raise AssertionError(f"[data] seqfile_generator counts {counts}")
        os.makedirs(mixed)
        for f in sorted(os.listdir(shards)):
            os.symlink(os.path.join(shards, f), os.path.join(mixed, f))
        decode = image.BytesToBGRImg()
        for split in ("train", "val"):
            imgs = []
            for path, label in seqfile_generator._scan_split(
                    os.path.join(tree, split)):
                with open(path, "rb") as f:
                    imgs.append(decode.transform_one(
                        ByteRecord(f.read(), label)))
            hs.SeqFileFolder.write_bgr_images(
                imgs, os.path.join(mixed, f"{split}_raw"), block_size=64)
            pairs = [(str(int(im.label)).encode(),
                      hs.encode_bgr_image(im.data)) for im in imgs]
            for flavor in ("record", "block"):
                hs.write_sequence_file(
                    os.path.join(mixed, f"{split}_{flavor}.seq"), pairs,
                    compression=flavor)
        files = sorted(os.path.join(mixed, f) for f in os.listdir(mixed))
        fast = _record_pairs(files)
        with _python_paths():
            slow = _record_pairs(files)
        n_records = 4 * (want["train"] + want["val"])
        if fast != slow or len(fast) != n_records:
            raise AssertionError(f"[data] record_files over the mixed folder:"
                                 f" {len(fast)} native and {len(slow)} "
                                 f"Python records (want {n_records}), equal "
                                 f"{fast == slow}")
        log(f"[data] D2 seqfile_generator {counts} -> {data['shards']} "
            f"shards a split, validated; mixed folder of {len(files)} files "
            f"(shards, uncompressed, record- and block-compressed .seq): "
            f"{len(fast)} records, native and Python index equal | {smi}")
        logger = logging.getLogger("bigdl_tpu_torch.optim")

        def train_cli(label, main_fn, argv):
            record, level = _IterationLog(), logger.level
            logger.setLevel(logging.INFO)
            logger.addHandler(record)
            try:
                opt = main_fn(argv + ["--device", dev.type])
            finally:
                logger.removeHandler(record)
                logger.setLevel(level)
            if not (record.losses and np.isfinite(record.losses).all()):
                raise AssertionError(f"[data] D2 {label} losses "
                                     f"{record.losses}")
            return opt, record.losses

        def eval_cli(label, main_fn, argv):
            buf = sio.StringIO()
            with contextlib.redirect_stdout(buf):
                results = main_fn(argv + ["--device", dev.type])
            printed = buf.getvalue().strip()
            if "Top1Accuracy is" not in printed or \
                    "Top5Accuracy is" not in printed:
                raise AssertionError(f"[data] D2 {label} printed "
                                     f"{printed!r}")
            return results, printed

        cli = {}
        b = str(data["cli_batch"])
        t0 = time.perf_counter()
        opt, losses = train_cli("resnet.train", resnet_train.main, [
            "--dataset", "imagenet", "-f", mixed, "--depth", "50",
            "--shortcutType", "B", "--classNumber", "1000", "-b", b,
            "-e", "1"])
        (method, result), = opt.validation_results
        if str(method) != "Top1Accuracy":
            raise AssertionError(f"[data] D2 resnet.train validation "
                                 f"{method}")
        cli["resnet_train"] = dict(steps=len(losses), first_loss=losses[0],
                                   last_loss=losses[-1],
                                   validation=str(result),
                                   seconds=time.perf_counter() - t0)
        log(f"[data] D2 resnet.train --dataset imagenet --depth 50 "
            f"--shortcutType B --classNumber 1000 -b {b} -e 1: "
            f"{len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"validation {method} is {result}, "
            f"{cli['resnet_train']['seconds']:.1f} s | {smi}")
        resnet_path = os.path.join(tmp, "resnet50.bin")
        opt.model.save(resnet_path)
        del opt
        t0 = time.perf_counter()
        opt, losses = train_cli("inception.train", inception_train.main, [
            "-f", shards, "--modelName", "inception_v1", "-b", b,
            "-i", str(data["inception_iters"])])
        if len(losses) != data["inception_iters"]:
            raise AssertionError(f"[data] D2 inception.train ran "
                                 f"{len(losses)} steps")
        inception_path = os.path.join(tmp, "inception_v1.bin")
        opt.model.save(inception_path)
        del opt
        results, printed = eval_cli("inception.test", inception_test.main, [
            "-f", shards, "--model", inception_path, "-b", b])
        cli["inception"] = dict(steps=len(losses), first_loss=losses[0],
                                last_loss=losses[-1], test=printed,
                                seconds=time.perf_counter() - t0)
        log(f"[data] D2 inception.train --modelName inception_v1 -b {b} -i "
            f"{data['inception_iters']}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; inception.test: "
            f"{printed.replace(chr(10), '; ')} | {smi}")
        t0 = time.perf_counter()
        results, printed = eval_cli("load_model", load_model.main, [
            "--modelType", "bigdl", "--model", resnet_path, "-f", mixed,
            "--dataset", "imagenet", "-b", b])
        if results[0][1].count != 4 * want["val"]:
            raise AssertionError(f"[data] D2 load_model counted "
                                 f"{results[0][1].count} records")
        cli["load_model"] = dict(results=printed,
                                 seconds=time.perf_counter() - t0)
        log(f"[data] D2 load_model --modelType bigdl --dataset imagenet "
            f"(the trained ResNet-50): {printed.replace(chr(10), '; ')} "
            f"| {smi}")
        out["d2"] = dict(counts=counts, files=len(files), records=len(fast),
                         cli=cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if _repo_files_state(("flight", "TUNNEL_INCIDENTS.json")) != guarded:
        raise AssertionError("the data phase changed the repository's "
                             "flight/ or TUNNEL_INCIDENTS.json")
    out["launches"] = _launches()
    if any(out["launches"].values()):
        raise AssertionError(f"[data] the port's kernels launched on the "
                             f"data path: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    if dev.type == "cuda" and out["seconds"] > data["limit_s"]:
        raise AssertionError(f"[data] the phase took {out['seconds']:.1f} "
                             f"s, over {data['limit_s']} s")
    return out


# --------------------------------------------------------------------------- #
def _int8_convs(records):
    """The recorded (conv, input, params) of every quantized
    SpatialConvolution."""
    from bigdl_tpu_torch.nn import SpatialConvolution
    from bigdl_tpu_torch.quant import is_qtensor
    return [(child, inp, p) for _, _, child, inp, p, _ in records
            if isinstance(child, SpatialConvolution)
            and is_qtensor(p.get("weight"))]


def phase_host(dev, smi, host=HOST):
    """Z3-Z5 (module docstring, phase 22)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.tensor import Tensor
    from bigdl_tpu_torch.utils import profiling
    from bigdl_tpu_torch.utils.params import params_from_numpy, \
        params_to_numpy
    from bigdl_tpu_torch.utils.rng import RNG, RandomGenerator
    t_phase = time.perf_counter()
    _reset_launches()
    out = {}
    batch = host["batch"]
    rs = np.random.RandomState(host["seed"])
    x = torch.as_tensor(rs.randn(batch, 3, 224, 224).astype(np.float32),
                        device=dev)
    labels = torch.as_tensor((rs.randint(0, 1000, batch) + 1).astype(
        np.float32), device=dev)
    model = perf.build_model("resnet50").build(seed=1, device=dev)

    # Z3: the quantized forwards
    def fwd(m):
        with torch.no_grad():
            return m.apply(m.params, x, buffers=m.buffers,
                           training=False)[0]
    model.evaluate()
    y_f = fwd(model)
    z3 = {"float32_ms": cuda_ms(lambda: fwd(model), iters=5, warmup=1)}
    quantized = {}
    for mode in ("int8", "dequant"):
        q = model.quantize("int8", compute=mode)
        quantized[mode] = q
        y = fwd(q)
        if not torch.isfinite(y).all():
            raise AssertionError(f"Z3 {mode}: non-finite logits")
        z3[mode] = dict(
            top1_agreement=float((y.argmax(-1) == y_f.argmax(-1))
                                 .float().mean()),
            max_rel_logit_gap=float((y - y_f).abs().max()
                                    / y_f.abs().max()),
            ms=cuda_ms(lambda: fwd(q), iters=5, warmup=1),
            payload_ratio=q.quant_report["payload_ratio"])
    q = quantized["int8"]
    rows = host["bitwise_rows"]
    records = profiling.record_layer_inputs(q, x[:rows])
    convs = _int8_convs(records)
    unequal = []
    for child, inp, p in convs:
        with torch.no_grad():
            card = child.apply(p, inp)[0].cpu()
            cpu = child.apply(params_from_numpy(params_to_numpy(p), "cpu"),
                              inp.cpu())[0]
        if not torch.equal(card, cpu):
            unequal.append((child.get_name(),
                            float((card - cpu).abs().max())))
    if len(convs) != 53 or unequal:
        raise AssertionError(f"Z3: {len(convs)} int8 convolutions, card vs "
                             f"CPU not bitwise on {unequal}")
    z3["bitwise_convs"] = len(convs)
    del quantized, q, records, convs
    log(f"[host] Z3 ResNet-50 batch {batch} eval forward: float32 "
        f"{z3['float32_ms']:.3f} ms; " + "; ".join(
            f"{m} {z3[m]['ms']:.3f} ms, top-1 agreement "
            f"{z3[m]['top1_agreement']:.4f}, max logit gap / max |logit| "
            f"{z3[m]['max_rel_logit_gap']:.3e}, payload "
            f"{z3[m]['payload_ratio']:.4f}" for m in ("int8", "dequant"))
        + f"; {z3['bitwise_convs']} int8 convolutions bitwise card vs CPU "
        f"on {rows} rows | {smi}")
    out["z3"] = z3

    # Z4: per-layer profiling of the float32 training step
    model.training()
    prof = profiling.profile_layers(model, x, training=True)
    layer_flops = sum(r["flops_train"] for r in prof)
    step_flops = perf.step_flops(model, ClassNLLCriterion(), x, labels)
    timed = profiling.measure_layer_times(model, x, training=True,
                                          iters=host["layer_iters"],
                                          warmup=host["layer_warmup"])
    if any(r["measured_train_s"] is None for r in timed):
        raise AssertionError("Z4: a layer failed to time")
    def label(i, m):
        if hasattr(m, "kernel_h"):
            return (f"{i}:{m.get_name()}({m.n_input_plane}->"
                    f"{m.n_output_plane}, {m.kernel_h}x{m.kernel_w}/"
                    f"{m.stride_h})")
        return f"{i}:{m.get_name()}"
    order = {id(r["module"]): i for i, r in enumerate(timed)}
    top = sorted(timed, key=lambda r: -r["measured_train_s"])[:5]
    z4 = dict(layers=len(prof), layer_train_flops=layer_flops,
              step_flops=step_flops, ratio=layer_flops / step_flops,
              top5=[(label(order[id(r["module"])], r["module"]),
                     r["measured_train_s"] * 1e3,
                     r["measured_fwd_s"] * 1e3) for r in top],
              layer_train_ms_sum=sum(r["measured_train_s"]
                                     for r in timed) * 1e3)
    log(f"[host] Z4 ResNet-50 batch {batch}: {z4['layers']} leaf layers, "
        f"summed training FLOPs (forward + weight gradients) "
        f"{layer_flops / 1e9:.2f} G against the step's products "
        f"{step_flops / 1e9:.2f} G (2 x the multiply-adds, input "
        f"gradients included; ratio {z4['ratio']:.4f}); standalone "
        f"training ms summed {z4['layer_train_ms_sum']:.2f}; top five: "
        + ", ".join(f"{n} {t:.3f} ms (forward {f:.3f})"
                    for n, t, f in z4["top5"]) + f" | {smi}")
    out["z4"] = z4
    del model, prof, timed

    # Z5: the draws and the Tensor facade
    seed, n = host["seed"], host["draws"]
    a = RandomGenerator(seed).normal_array(n)
    b = RandomGenerator(seed).normal_array(n)
    RNG.set_seed(seed)
    t = Tensor(1000, 1000).randn()
    if n != 1_000_000 or not np.array_equal(a, b) or not np.array_equal(
            t.numpy().reshape(-1), a.astype(np.float32)):
        raise AssertionError("Z5: the draws are not one seed's stream")
    back = Tensor.from_torch(t.to_torch(dev))
    if not back == t:
        raise AssertionError("Z5: the round trip through the card changed "
                             "the tensor")
    os.environ["BIGDL_TPU_NO_NATIVE"] = "1"
    try:
        py = RandomGenerator(seed)
        if py._native is not None:
            raise AssertionError("Z5: BIGDL_TPU_NO_NATIVE kept the library")
        py_draws = py.normal_array(host["python_draws"])
    finally:
        del os.environ["BIGDL_TPU_NO_NATIVE"]
    if not np.array_equal(py_draws, a[: host["python_draws"]]):
        raise AssertionError("Z5: the Python path left the stream")
    out["z5"] = dict(draws=n, mean=float(a.mean()), std=float(a.std()))
    log(f"[host] Z5 {n} normal draws of seed {seed}: equal twice, equal to "
        f"the Tensor fill in float32 (mean {a.mean():.5f}, std "
        f"{a.std():.5f}), round trip through {dev} bitwise, the first "
        f"{host['python_draws']} equal on the Python path | {smi}")
    out["launches"] = _launches()
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > host["limit_s"]:
        raise AssertionError(f"host phase took {out['seconds']:.1f} s > "
                             f"{host['limit_s']} s")
    return out


def phase_dist(dev, smi, dist_cfg=DIST, config=GPT2_SMALL, train=TRAIN,
               cli=TRAIN_CLI):
    """Z1 and Z2 (module docstring, phase 23)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer import train as train_cli
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    TimeDistributedCriterion)
    from bigdl_tpu_torch.optim import SGD, Adam, Trigger
    from bigdl_tpu_torch.parallel import (AllReduceParameter,
                                          DistriOptimizer,
                                          data_parallel_mesh, init_world,
                                          shutdown_world)
    from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    init_world(dev.type)
    if dist.get_world_size() != 1 or (
            dev.type == "cuda" and "nccl" not in str(dist.get_backend())):
        raise AssertionError(f"dist: world {dist.get_backend()} of "
                             f"{dist.get_world_size()}")
    out = {}
    try:
        # Z1: ResNet-50 through DistriOptimizer and LocalOptimizer
        _reset_launches()
        name, batch = dist_cfg["z1"]
        z1 = {}
        for label, distributed in (("distri", True), ("local", False)):
            r = perf.run_perf(name, batch, dist_cfg["iters"],
                              distributed=distributed,
                              warmup=dist_cfg["warmup"], device=dev)
            if not np.isfinite(r["loss"]):
                raise AssertionError(f"Z1 {label}: loss {r['loss']}")
            z1[label] = dict(step_ms=r["median_step_s"] * 1e3,
                             steps_ms=[t * 1e3 for t in r["step_s"]],
                             images_per_s=batch / r["median_step_s"],
                             peak_mib=(r["peak_bytes"] or 0) / 2**20)
            if distributed:
                fp, n_params = r["collective_bytes"], r["param_count"]
        if fp.get("all-gather") != 2 * n_params \
                or fp.get("reduce-scatter") != 2 * n_params:
            raise AssertionError(f"Z1 footprint {fp} for {n_params} "
                                 "parameters")
        z1["footprint"], z1["param_count"] = fp, n_params
        # one batch-2 step on the card and on the CPU, the CPU replaying
        # the card's ReLU masks and max-pool argmaxes (pinned_decisions,
        # as C3: on its own decisions a flip moves a late weight's
        # gradient by a whole term): the loss, then each leaf's update
        # (the weights published after the gather, local gradients,
        # reduce-scatter, mean and SGD update) and each buffer after the
        # all-reduce, card against CPU
        losses, moved, bufs, pins = {}, {}, {}, []
        for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
            decisions = pinned_decisions(record=pins) if label == "card" \
                else pinned_decisions(replay=pins)
            m = perf.build_model(name).build(seed=1, device=d)
            w0 = tree_map(lambda t: t.detach().clone(), m.params)
            ds = perf._make_dataset(name, dist_cfg["check_batch"], "random",
                                    "NCHW")
            opt = DistriOptimizer(m, ds, ClassNLLCriterion(),
                                  mesh=data_parallel_mesh(device_type=d.type))
            opt.set_optim_method(SGD(learning_rate=0.01)) \
               .set_end_when(Trigger.max_iteration(1))
            with decisions:
                opt.optimize()
            if label == "cpu" and next(decisions.replay, None) is not None:
                raise AssertionError("Z1 check: the CPU left some of the "
                                     "card's decisions unused")
            losses[label] = opt.state["loss"]
            moved[label] = tree_map(lambda a, b: (a - b).cpu(), m.params, w0)
            bufs[label] = tree_map(lambda t: t.float().cpu(), m.buffers)
            del opt, m, w0
        del pins
        rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        if not rel <= dist_cfg["tol_loss"]:
            raise AssertionError(f"Z1 batch-2 step: card {losses['card']} vs "
                                 f"CPU {losses['cpu']}, relative {rel:.3e}")
        if not any(bool(a.any()) for a in tree_leaves(moved["card"])):
            raise AssertionError("Z1 batch-2 step: the card's step moved no "
                                 "weight")
        worst_w = _check_grads("Z1 update card vs CPU", moved["card"],
                               moved["cpu"], dist_cfg["tol_update"])
        worst_b = _check_grads("Z1 buffers card vs CPU", bufs["card"],
                               bufs["cpu"], dist_cfg["tol_buffer"]) \
            if tree_leaves(bufs["cpu"]) else (0.0, "none")
        z1["check"] = dict(card=losses["card"], cpu=losses["cpu"], rel=rel,
                           worst_update=worst_w, worst_buffer=worst_b)
        del moved, bufs
        z1["launches"] = _launches()
        log(f"[dist] Z1 ResNet-50 batch {batch}: DistriOptimizer median step "
            f"{z1['distri']['step_ms']:.3f} ms "
            f"({_ms_list(z1['distri']['steps_ms'])}), "
            f"{z1['distri']['images_per_s']:.1f} images/s, max_memory_"
            f"allocated {z1['distri']['peak_mib']:.1f} MiB; LocalOptimizer "
            f"{z1['local']['step_ms']:.3f} ms "
            f"({_ms_list(z1['local']['steps_ms'])}), "
            f"{z1['local']['images_per_s']:.1f} images/s, "
            f"{z1['local']['peak_mib']:.1f} MiB; collective_footprint "
            f"{json.dumps(fp)} for {n_params} parameters; batch-2 step on "
            f"the card's decisions: loss card {losses['card']:.7f} CPU "
            f"{losses['cpu']:.7f} (relative {rel:.2e}), the update of every "
            f"leaf within {dist_cfg['tol_update']} of its max (worst "
            f"{worst_w[0]:.2e} at {worst_w[1]}), buffers within "
            f"{dist_cfg['tol_buffer']} (worst {worst_b[0]:.2e} at "
            f"{worst_b[1]}) | {smi}")
        out["z1"] = z1

        # Z2: the GPT-2-small-width LM through DistriOptimizer
        x, y = _train_batch(config, train)
        crit = TimeDistributedCriterion(ClassNLLCriterion(), True)

        def dataset(rows):
            return DataSet.array([Sample(f, l) for f, l in zip(x, y)]) \
                >> SampleToBatch(rows)
        model = build_lm(dev, config, train["seed"], attention_impl="flash")
        opt = DistriOptimizer(model, dataset(train["batch"]), crit) \
            .set_optim_method(Adam(learning_rate=train["learning_rate"]))
        _peak_reset(dev)
        _reset_launches()
        steps = dist_cfg["z2_warmup"] + dist_cfg["z2_steps"]
        z2_losses, step_s = run_iterations(opt, steps)
        launches = _launches()
        peak = _peak(dev)
        step_s = step_s[dist_cfg["z2_warmup"] - 1:]
        if not all(np.isfinite(z2_losses)):
            raise AssertionError(f"Z2 losses {z2_losses}")
        check_launches("dist training path (Z2)", launches,
                       ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                        "bigdl_flash_bwd_dq"),
                       exactly=config["n_layers"] * steps)
        if launches["bigdl_paged_decode"]:
            raise AssertionError("Z2 launched the paged decode kernel")
        fp2 = opt.collective_footprint()
        step_ms = float(np.median(step_s)) * 1e3
        z2 = dict(losses=z2_losses, step_ms=step_ms,
                  steps_ms=[t * 1e3 for t in step_s],
                  tokens_per_s=train["batch"] * train["seq_len"] / step_ms
                  * 1e3, peak_bytes=peak, footprint=fp2, launches=launches)
        del opt, model
        torch.cuda.empty_cache()
        # step 0's loss and local gradients, flash against plain attention
        cb = train["check_batch"]
        xb, yb = (torch.as_tensor(a[:cb], device=dev) for a in (x, y))
        flash = build_lm(dev, config, train["seed"], attention_impl="flash")
        plain = TransformerLM(attention_impl="xla", device=dev, **config)
        plain.params, plain.buffers = flash.params, flash.buffers
        grads = {}
        for label, m in (("flash", flash), ("plain", plain)):
            o = DistriOptimizer(m, dataset(cb), crit)
            grads[label] = o.step_gradients(xb, yb)
        (loss_f, g_f, red_f), (loss_p, g_p, _) = grads["flash"], \
            grads["plain"]
        rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
        if not rel <= TOL_LOSS:
            raise AssertionError(f"Z2 step-0 loss flash {float(loss_f)} vs "
                                 f"plain {float(loss_p)}: {rel:.3e}")
        worst = _check_grads("dist flash", g_f, g_p, TOL_GRAD)
        arp = AllReduceParameter(flash.params, 1)
        want = arp.flatten(g_f).to(torch.bfloat16).float()
        if not torch.equal(red_f, want):
            raise AssertionError("Z2: the reduced slice of a world of one "
                                 "is not the bf16 rounding of its gradient")
        z2["check"] = dict(loss_flash=float(loss_f), loss_plain=float(loss_p),
                           rel=rel, worst=worst)
        del grads, g_f, g_p, red_f, want, flash, plain
        torch.cuda.empty_cache()
        # the train CLI with --distributed
        _reset_launches()
        cli_opt = train_cli.main(cli + ["--distributed", "--device",
                                        dev.type])
        launches_cli = _launches()
        if not isinstance(cli_opt, DistriOptimizer):
            raise AssertionError(f"train CLI --distributed ran "
                                 f"{type(cli_opt).__name__}")
        (method, result), = cli_opt.validation_results
        if not (np.isfinite(cli_opt.state["loss"])
                and np.isfinite(result.result()[0])):
            raise AssertionError(f"train CLI --distributed: loss "
                                 f"{cli_opt.state['loss']}, {result}")
        check_launches("dist train CLI", launches_cli,
                       ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                        "bigdl_flash_bwd_dq"))
        z2["cli"] = dict(loss=cli_opt.state["loss"], validation=str(result),
                         launches=launches_cli)
        log(f"[dist] Z2 {train['batch']}x{train['seq_len']} tokens, Adam lr "
            f"{train['learning_rate']}, {config['n_layers']} layers: losses "
            f"{[round(v, 4) for v in z2_losses]}; median step {step_ms:.2f} "
            f"ms ({_ms_list(z2['steps_ms'])}), {z2['tokens_per_s']:.1f} "
            f"tokens/s, max_memory_allocated {_mib(peak)}; footprint "
            f"{json.dumps(fp2)}; launches {launches}; step-0 loss flash "
            f"{float(loss_f):.6f} plain {float(loss_p):.6f} (relative "
            f"{rel:.2e}), every local gradient leaf within {TOL_GRAD} of its "
            f"max |g| (worst {worst[0]:.2e} at {worst[1]}); CLI "
            f"{' '.join(cli)} --distributed: loss "
            f"{cli_opt.state['loss']:.6f}, validation {method} {result}, "
            f"launches {launches_cli} | {smi}")
        out["z2"] = z2
        out["launches"] = {k: launches[k] + launches_cli[k]
                           for k in launches}
    finally:
        shutdown_world()
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > dist_cfg["limit_s"]:
        raise AssertionError(f"dist phase took {out['seconds']:.1f} s > "
                             f"{dist_cfg['limit_s']} s")
    return out


def ring_replay(dev, ring, dtype, segmented=False):
    """P2: the ring's hop schedule for ``ring['shards']`` shards of one
    causal (b, h, t, d) problem on one card: shard r's queries take the
    blocks in the order rank r receives them, (r - i) mod N, through
    ``parallel.sequence.ring_hop`` (the future ones skipped).  The
    assembled output and the q/k/v gradients of one scalar loss are held
    against ``flash_attention`` over the whole sequence (the kernels) and
    against the plain version (autograd through
    ``flash_attention_reference``); both timed forward + backward."""
    import torch
    from bigdl_tpu_torch.ops import (flash_attention,
                                     flash_attention_reference)
    from bigdl_tpu_torch.parallel.sequence import (ring_finish, ring_hop,
                                                   ring_init)
    b, h, t, d, n = (ring[k] for k in ("batch", "heads", "seq", "d",
                                       "shards"))
    tl = t // n
    tdt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(ring["seed"])
    q, k, v = (torch.randn((b, h, t, d), generator=g, device=dev).to(tdt)
               for _ in range(3))
    w = torch.randn((b, h, t, d), generator=g, device=dev)
    seg = None
    if segmented:
        # documents of random lengths, their boundaries anywhere, so
        # most cross a shard boundary
        cuts = torch.sort(torch.randint(1, t, (b, ring["docs"] - 1),
                                        generator=g, device=dev),
                          dim=1).values
        seg = (torch.arange(t, device=dev)[None, :, None]
               >= cuts[:, None, :]).sum(-1).to(torch.int32)

    def shards(x):
        return [x[:, :, i * tl:(i + 1) * tl].contiguous().requires_grad_()
                for i in range(n)]
    qs, ks, vs = shards(q), shards(k), shards(v)
    sseg = [None if seg is None else seg[:, i * tl:(i + 1) * tl]
            for i in range(n)]
    hops = {"computed": 0, "skipped": 0}

    def ring_run():
        outs = []
        for r in range(n):
            state = ring_init(qs[r], "flash")
            for i in range(n):
                src = (r - i) % n
                hops["skipped" if src > r else "computed"] += 1
                state = ring_hop(state, qs[r], ks[src], vs[src], rank=r,
                                 src=src, causal=True, impl="flash",
                                 segment_ids=sseg[r],
                                 kv_segment_ids=sseg[src])
            outs.append(ring_finish(state, qs[r], "flash"))
        o = torch.cat(outs, dim=2)
        grads = torch.autograd.grad((o.float() * w).sum(), qs + ks + vs)
        return o, [torch.cat(grads[j * n:(j + 1) * n], dim=2)
                   for j in range(3)]

    full = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def full_run():
        o = flash_attention(*full, causal=True, segment_ids=seg)
        return o, torch.autograd.grad((o.float() * w).sum(), full)

    def plain_run():
        o = flash_attention_reference(*full, causal=True, q_segment_ids=seg,
                                      kv_segment_ids=seg)[0]
        return o, torch.autograd.grad((o.float() * w).sum(), full)

    got = ring_run()
    per_call = dict(hops)
    name = (f"ring replay {n} x ({b},{h},{tl},{d}) {dtype}"
            f"{' segmented' if segmented else ''}")
    tol_o = TOL_F32 if dtype == "float32" else TOL_BF16_O
    errs = {}
    for label, fn in (("flash", full_run), ("plain", plain_run)):
        want = fn()
        for gname, a, ref, tol in zip(
                ("o", "dq", "dk", "dv"), [got[0]] + list(got[1]),
                [want[0]] + list(want[1]),
                [tol_o] + [TOL_BWD[dtype]] * 3):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite {gname}")
            top = ref.float().abs().max().item()
            err = (a.float() - ref.float()).abs().max().item()
            if not err <= tol * top:
                raise AssertionError(f"{name}: {gname} against {label} "
                                     f"max_abs_err {err:.3e} over max "
                                     f"|{gname}| {top:.3e} > {tol}")
            errs[f"{gname}_vs_{label}"] = err / top
        del want
    ring_ms = cuda_ms(ring_run, iters=5, warmup=1)
    full_ms = cuda_ms(full_run, iters=5, warmup=1)
    log(f"[par] {name}: {per_call['computed']} hops computed, "
        f"{per_call['skipped']} skipped (of {n * n}); max_abs_err over max "
        f"|x| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol o {tol_o}, gradients {TOL_BWD[dtype]}); forward + "
        f"backward: ring {ring_ms:.3f} ms, full-sequence flash "
        f"{full_ms:.3f} ms")
    return dict(hops=per_call, errs=errs, ring_ms=ring_ms, full_ms=full_ms,
                tol=dict(o=tol_o, grad=TOL_BWD[dtype]))


def _rel_err(got, want):
    got = got.full_tensor() if type(got).__name__ == "DTensor" else got
    top = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / top


def world_of_one(dev, par, config):
    """P3: every strategy over the running world of one, against the
    single-device computation it stands for."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.sp import (ring_lm_apply,
                                                       ulysses_lm_apply)
    from bigdl_tpu_torch.parallel import (constrain_batch, create_mesh,
                                          init_moe_params, moe_apply,
                                          pin_xla_attention, pipeline_apply,
                                          pipeline_apply_hetero,
                                          shard_params, split_sequential,
                                          switch_mlp,
                                          transformer_lm_tp_rules)
    from bigdl_tpu_torch.utils import keychain
    from bigdl_tpu_torch.utils.params import layer_params, params_from_numpy
    from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map
    out = {}

    def held(label, err, tol):
        if not err <= tol:
            raise AssertionError(f"par world of one: {label} error {err:.3e} "
                                 f"> {tol}")
        out[label] = dict(err=err, tol=tol)

    model = build_lm(dev, config, 0, attention_impl="flash")
    t = par["lm_tokens"]
    ids = torch.as_tensor(np.random.RandomState(1).randint(
        1, config["vocab_size"] + 1, size=(1, t)).astype(np.float32),
        device=dev)
    seq = create_mesh({"sequence": 1}, dev.type)
    with torch.no_grad():
        want = model.apply(model.params, ids)[0]
        held("ring_lm_apply", _rel_err(ring_lm_apply(
            model, model.params, ids, seq), want), par["tol_lm"])
        held("ulysses_lm_apply", _rel_err(ulysses_lm_apply(
            model, model.params, ids, seq), want), par["tol_ulysses"])
        plain = TransformerLM(attention_impl="xla", device=dev, **config)
        plain.params = model.params
        pin_xla_attention(plain)
        mesh = create_mesh({"data": 1, "model": 1}, dev.type)
        tp = shard_params(model.params, transformer_lm_tp_rules(mesh), mesh)
        held("tensor_parallel", _rel_err(plain.apply(tp, constrain_batch(
            ids, mesh))[0], plain.apply(plain.params, ids)[0]),
            par["tol_tp"])
        del tp, want
    # GPipe, one stage: a GPT-2-small block (the flash kernels inside)
    pipe = create_mesh({"pipeline": 1}, dev.type)
    stacked = tree_map(lambda a: a[0:1].detach().clone().requires_grad_(),
                       model.params["blocks"])
    positions = torch.arange(t, device=dev)

    def block(bp, x):
        return model._block(bp, x, positions)[0]
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((par["pipe_rows"], t, config["hidden_size"]),
                    generator=g, device=dev, requires_grad=True)
    wy = torch.randn(x.shape, generator=g, device=dev)
    leaves = tree_leaves(stacked) + [x]
    y = pipeline_apply(block, stacked, x, pipe,
                       n_microbatches=par["micro"])
    gp = torch.autograd.grad((y * wy).sum(), leaves)
    y_seq = block(layer_params(stacked, 0), x)
    gs = torch.autograd.grad((y_seq * wy).sum(), leaves)
    held("pipeline_apply", _rel_err(y, y_seq), par["tol_pipe"])
    # TOL_GRAD's floor: bk's gradient is zero in exact arithmetic, and
    # microbatches change the products' shapes, so their rounding
    held("pipeline_apply grads", _check_grads(
        "par pipeline_apply", dict(enumerate(gp)), dict(enumerate(gs)),
        TOL_GRAD)[0], TOL_GRAD)
    del model, plain, stacked, x, y, y_seq, gp, gs
    release(dev)
    # GPipe, one stage of different shapes: ResNet-20 cut by FLOPs
    resnet = ResNet(class_num=10, depth=20, dataset="cifar10").build(
        seed=1, device=dev)
    xr = torch.randn((par["resnet_batch"], 3, 32, 32), generator=g,
                     device=dev)
    fns, stage_params = split_sequential(resnet, 1, xr)
    leaves = tree_leaves(stage_params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    yh = pipeline_apply_hetero(fns, stage_params, xr, pipe,
                               n_microbatches=par["micro"])
    gh = torch.autograd.grad((yh ** 2).mean(), leaves)
    y_seq = resnet.apply(resnet.params, xr, buffers=resnet.buffers,
                         training=False)[0]
    gs = torch.autograd.grad((y_seq ** 2).mean(), leaves)
    held("pipeline_apply_hetero", _rel_err(yh, y_seq), par["tol_pipe"])
    held("pipeline_apply_hetero grads", _check_grads(
        "par pipeline_apply_hetero", dict(enumerate(gh)),
        dict(enumerate(gs)), TOL_GRAD)[0], TOL_GRAD)
    del resnet, yh, gh, y_seq, gs
    # the expert axis: 8 GPT-2-width experts, dense and capacity 1.25
    experts = create_mesh({"expert": 1}, dev.type)
    p = params_from_numpy(init_moe_params(
        keychain.prng_key(0), par["moe_experts"], config["hidden_size"],
        config["ffn_size"]), dev)
    xm = torch.randn((par["moe_tokens"], config["hidden_size"]),
                     generator=g, device=dev)
    with torch.no_grad():
        for cf in (None, 1.25):
            y, aux = moe_apply(p, xm, experts, capacity_factor=cf)
            y_ref, aux_ref = switch_mlp(p, xm, capacity_factor=cf)
            held(f"moe_apply capacity {cf}", max(
                _rel_err(y, y_ref), abs(float(aux) - float(aux_ref))),
                par["tol_moe"])
    log("[par] world of one (error over the reference's max |x|, "
        "tolerance): " + ", ".join(f"{k} {v['err']:.2e} (tol {v['tol']})"
                                   for k, v in out.items()))
    return out


def phase_par(dev, smi, par=PAR, config=GPT2_SMALL):
    """P1-P3 (module docstring, phase 24)."""
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.example import long_context_lm
    from bigdl_tpu_torch.parallel import shutdown_world
    t_phase = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("par: a process world is already running")
    flash3 = ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv", "bigdl_flash_bwd_dq")
    out = {}
    try:
        # P1: long_context_lm on one device and over a world of one
        steps = 1 + int(par["cli"][par["cli"].index("-i") + 1])
        layers = int(par["cli"][par["cli"].index("--nLayers") + 1])
        runs = {}
        for label, flags in (("single", ["--flash", "--remat"]),
                             ("sp1", ["--sp", "1", "--remat"])):
            release(dev)
            _reset_launches()
            run = long_context_lm.main(par["cli"] + flags
                                       + ["--device", dev.type])
            run["launches"] = _launches()
            # remat runs each block's forward twice a step
            check_launches(f"long_context_lm {label}", run["launches"],
                           ("bigdl_flash_fwd",), exactly=2 * layers * steps)
            check_launches(f"long_context_lm {label}", run["launches"],
                           flash3[1:], exactly=layers * steps)
            if run["launches"]["bigdl_paged_decode"]:
                raise AssertionError(f"long_context_lm {label} launched the "
                                     "paged decode kernel")
            runs[label] = run
            log(f"[par] P1 long_context_lm {' '.join(par['cli'])} "
                f"{' '.join(flags)}: {run['mode']}, {run['ms_per_step']:.2f} "
                f"ms/step, {run['tokens_per_s']:.1f} tokens/s, step-0 loss "
                f"{run['first_loss']:.7f}, final loss {run['loss']:.6f}, "
                f"max_memory_allocated {_mib(run['peak_bytes'])}, launches "
                f"{run['launches']} | {smi}")
        if dev.type == "cuda" and not (dist.get_world_size() == 1 and "nccl"
                                       in str(dist.get_backend())):
            raise AssertionError(f"par: world {dist.get_backend()} of "
                                 f"{dist.get_world_size()}")
        a, b = runs["single"]["first_loss"], runs["sp1"]["first_loss"]
        rel = abs(a - b) / abs(a)
        if not rel <= par["tol_loss"]:
            raise AssertionError(f"par P1: step-0 loss single {a} vs sp=1 "
                                 f"{b}: {rel:.3e} > {par['tol_loss']}")
        log(f"[par] P1 step-0 loss single-device {a:.7f}, sp=1 {b:.7f} "
            f"(relative {rel:.2e}, tol {par['tol_loss']})")
        out["p1"] = dict(runs=runs, rel=rel)
        out["launches"] = {k: runs["single"]["launches"][k]
                           + runs["sp1"]["launches"][k]
                           for k in runs["single"]["launches"]}
        release(dev)
        # P2: the ring's hop schedule at 4 shards on one card
        out["p2"] = {
            "float32": ring_replay(dev, par["ring"], "float32"),
            "bfloat16": ring_replay(dev, par["ring"], "bfloat16"),
            "float32_segmented": ring_replay(dev, par["ring"], "float32",
                                             segmented=True)}
        release(dev)
        # P3: each strategy over the world of one
        out["p3"] = world_of_one(dev, par, config)
        release(dev)
    finally:
        shutdown_world()
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > par["limit_s"]:
        raise AssertionError(f"par phase took {out['seconds']:.1f} s > "
                             f"{par['limit_s']} s")
    return out


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
    from bigdl_tpu_torch.ops import autotune
    import tempfile
    t_start = time.perf_counter()
    # every phase before tune dispatches with no tuning cache; the tune
    # phase writes this run's own, and never the repository's
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["BIGDL_TPU_TORCH_TUNE_CACHE"] = os.path.join(tune_dir,
                                                            "TUNE_CUDA.json")
    autotune.clear_cache()
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
    log_allocated("place")
    t0 = time.perf_counter()
    place = phase_place(dev, oracle=oracle, colocated=serve,
                        disagg=replicas)
    phases["place"] = time.perf_counter() - t0
    check_launches("place path", place["launches"],
                   ("bigdl_flash_fwd", "bigdl_paged_decode"))
    log(f"[place] launches over the place runs: {place['launches']} | {smi}")
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
    log_allocated("tune")
    release(dev)
    t0 = time.perf_counter()
    try:
        tune = phase_tune(dev, smi)
    finally:
        import shutil
        shutil.rmtree(tune_dir, ignore_errors=True)
        autotune.clear_cache()
    phases["tune"] = time.perf_counter() - t0
    check_launches("tune path (T4 engine)", tune["launches"],
                   ("bigdl_flash_fwd",))
    log(f"[tune] phase {tune['seconds']:.1f} s; verdicts: " + json.dumps(
        {"attention": {dt: {k: sw["winner"].get(k) for k in (
            "block_q", "block_k", "use_flash", "flash_step_s", "xla_step_s",
            "flash_speedup_vs_xla")} for dt, sw in tune["sweeps"].items()},
         "paged": {k: tune["paged"]["winner"].get(k) for k in (
             "use_kernel", "kernel_step_s", "gather_step_s")},
         "qcompute": tune["qcompute"]}) + f" | {smi}")
    log_allocated("cnn")
    release(dev)
    t0 = time.perf_counter()
    cnn = phase_cnn(dev, profile_path=args.profile)
    phases["cnn"] = time.perf_counter() - t0
    log("[cnn] summary: " + json.dumps(
        {"c1": [{k: r[k] for k in ("data_format", "step_ms", "images_per_s",
                                   "peak_mib", "input_copy_ms", "copy_share",
                                   "step_gflop", "fp32_peak_share")}
                for r in cnn["c1"]],
         "c2": [{k: r[k] for k in ("model", "batch", "step_ms",
                                   "images_per_s", "peak_mib",
                                   "input_copy_ms", "step_gflop",
                                   "fp32_peak_share")} for r in cnn["c2"]],
         "c3": cnn["c3"],
         "c4": {k: {"first_loss": v["losses"][0], "last_loss": v["losses"][-1],
                    "validation": v["validation"]}
                for k, v in cnn["c4"].items()},
         "port_kernel_launches": cnn["launches"], "seconds": cnn["seconds"]})
        + f" | {smi}")
    log_allocated("rnn")
    release(dev)
    t0 = time.perf_counter()
    rnn = phase_rnn(dev, profile_path=args.profile)
    phases["rnn"] = time.perf_counter() - t0
    log("[rnn] summary: " + json.dumps(rnn_summary(rnn)) + f" | {smi}")
    log_allocated("io")
    release(dev)
    t0 = time.perf_counter()
    io = phase_io(dev, smi=smi)
    phases["io"] = time.perf_counter() - t0
    log("[io] summary: " + json.dumps(
        {k: io[k] for k in ("formats", "dlc", "gpt2_build_s", "tree_draws",
                            "launches", "seconds")}) + f" | {smi}")
    log_allocated("data")
    release(dev)
    t0 = time.perf_counter()
    data = phase_data(dev, smi=smi)
    phases["data"] = time.perf_counter() - t0
    d1 = data["d1"]
    log("[data] summary: " + json.dumps(
        {"d1": {k: d1[k] for k in (
            "synthetic_img_s", "pipeline_img_s", "ratio", "input_copy_ms",
            "pipeline_wait_ms", "pipeline_copy_call_ms",
            "peak_bytes", "native_batcher", "fed_equal", "check_rel")},
         "host_only_img_s": d1["host_only"]["value"],
         "host_stages": d1["host_stages"],
         "headroom_vs_card_rate": d1["host_only"]["headroom_vs_card_rate"],
         "d2": data["d2"], "native_build_s": data["native_build_s"],
         "launches": data["launches"], "seconds": data["seconds"]})
        + f" | {smi}")
    log_allocated("host")
    release(dev)
    t0 = time.perf_counter()
    host = phase_host(dev, smi)
    phases["host"] = time.perf_counter() - t0
    log("[host] summary: " + json.dumps(
        {k: host[k] for k in ("z3", "z4", "z5", "launches", "seconds")})
        + f" | {smi}")
    log_allocated("dist")
    release(dev)
    t0 = time.perf_counter()
    dist_run = phase_dist(dev, smi)
    phases["dist"] = time.perf_counter() - t0
    log("[dist] summary: " + json.dumps(
        {"z1": {k: dist_run["z1"][k] for k in (
            "distri", "local", "footprint", "param_count", "check")},
         "z2": {k: dist_run["z2"][k] for k in (
             "step_ms", "tokens_per_s", "footprint", "launches", "check",
             "cli")},
         "launches": dist_run["launches"], "seconds": dist_run["seconds"]},
        default=str) + f" | {smi}")
    log_allocated("par")
    release(dev)
    t0 = time.perf_counter()
    par = phase_par(dev, smi)
    phases["par"] = time.perf_counter() - t0
    log("[par] summary: " + json.dumps(
        {"p1": {k: {f: r[f] for f in ("mode", "first_loss", "loss",
                                      "ms_per_step", "tokens_per_s",
                                      "peak_bytes", "launches")}
                for k, r in par["p1"]["runs"].items()},
         "p1_step0_rel": par["p1"]["rel"],
         "p2": par["p2"], "p3": par["p3"], "launches": par["launches"],
         "seconds": par["seconds"]}) + f" | {smi}")
    log("[done] phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()))

    def total(*runs):
        return {k: sum(r[k] for r in runs) for k in runs[0]}

    # launches: the serve path's (the training path's for the backward
    # pair); by_path: every path's own run, counted from 0
    paths = dict(serve=serve["launches"], serve_sampled=sampled["launches"],
                 spec=spec_launches, quant=quant_launches,
                 tier=tier["launches"], replicas=replicas["launches"],
                 place=place["launches"], batch=batch["launches"],
                 train=train["launches"],
                 moe=total(m1["launches"], m2["launches"]),
                 accum=total(*(r["launches"] for r in accum.values())),
                 ckpt=ckpt["launches"], gpt2=gpt2["launches"],
                 obs=total(*(obs[p]["launches"]
                             for p in ("o1", "o2", "o3", "o4", "o5"))),
                 tune=tune["launches"], cnn=cnn["launches"],
                 rnn=rnn["launches"], io=io["launches"],
                 data=data["launches"], host=host["launches"],
                 dist=dist_run["launches"], par=par["launches"])

    def by_path(symbol, names):
        return {p: paths[p][symbol] for p in names}

    serving = ("serve", "serve_sampled", "spec", "quant", "tier", "replicas",
               "place", "moe", "obs", "tune")
    training = ("train", "moe", "accum", "ckpt", "obs", "batch", "par")
    # the paths on cuDNN and the host, which launch none of the kernels
    hosted = ("cnn", "rnn", "io", "data", "host")
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="bigdl_tpu_torch/csrc/flash_fwd.cu",
             replaces="bigdl_tpu/ops/flash_attention.py:39",
             launches=serve["launches"]["bigdl_flash_fwd"],
             launches_by_path=by_path("bigdl_flash_fwd",
                                      serving + ("batch", "train", "accum",
                                                 "ckpt", "gpt2", "dist",
                                                 "par") + hosted),
             **flash_main),
        dict(name="paged_decode", route="cuda",
             source="bigdl_tpu_torch/csrc/paged_decode.cu",
             replaces="bigdl_tpu/ops/paged_attention.py:34",
             launches=serve["launches"]["bigdl_paged_decode"],
             launches_by_path=by_path("bigdl_paged_decode",
                                      serving + hosted + ("dist", "par")),
             **paged_main),
        dict(name="flash_bwd_dkv", route="cuda",
             source="bigdl_tpu_torch/csrc/flash_bwd.cu",
             replaces="bigdl_tpu/ops/flash_attention.py:199",
             launches=train["launches"]["bigdl_flash_bwd_dkv"],
             launches_by_path=by_path("bigdl_flash_bwd_dkv",
                                      training + ("dist", "place") + hosted),
             **dkv_main),
        dict(name="flash_bwd_dq", route="cuda",
             source="bigdl_tpu_torch/csrc/flash_bwd.cu",
             replaces="bigdl_tpu/ops/flash_attention.py:262",
             launches=train["launches"]["bigdl_flash_bwd_dq"],
             launches_by_path=by_path("bigdl_flash_bwd_dq",
                                      training + ("dist", "place") + hosted),
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
