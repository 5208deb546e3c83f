#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and `nvidia-smi`; exits non-zero on the first
failed phase, with no phase caught.

1. Device and build: prints the card's name and power limit, builds the
   CUDA kernels of `ray_tpu_torch/csrc/`, prints the build time and each
   kernel's registers and spills (the Hopper bodies of all three kernels
   at head dims 192 and 256, in bf16 and float16, and above 256, and the
   float32 bodies of all three at every width of their column chunks,
   must not spill), and checks that the shared memory each C entry point
   asks for is what `attention.kernel_smem_bytes` computes from the tile
   table, and that `flash_attention` refuses float32 d 768, naming 704,
   and 16-bit d 1088, naming 1024.
1b. Runtime: `ray_tpu_torch.init()` must advertise the card (`GPU: 1`);
   runs 16 tasks and an actor, moves a 256 MiB numpy array through
   `put`/`get` in a worker and back (MB/s printed), checks that a CPU task
   sees `CUDA_VISIBLE_DEVICES=""` and a `num_gpus=1` task `"0"` and one
   card, and prints the cold-spawn time of a GPU worker actor. The runtime
   stays up for the training phases.
2. Kernels: holds each kernel (flash forward, dQ with the delta it writes,
   dK/dV reading that delta) against its plain PyTorch version on the
   card, at GPT-2-small's attention shape (bf16, causal and not), at
   Llama's head dim 128 (bf16), on a ragged bf16 case whose last tile ends
   inside the head in several heads, on small float32 and ragged cases, at
   seq 8192 (bh 4), at the attention shapes of phases 10 and 11 (bh 96
   and 64, seq 2048, d 64, bf16, causal) and on the Hopper bodies of all
   three kernels at d 192 and 256 (bf16 and float16: ragged at seq 300 and
   77 in several heads, and non-causal), element by element, printing each
   error beside its limit; then the instances that take head dims 192 and
   256, float16 and float32 (bf16 and float16 at d 192 and 256, bh 24, seq
   2048, causal; float16 at d 64 and 128 at the main shape; float32 at d
   256, small, and at d 64, 128, 192 and 256, bh 24, seq 2048, causal, a
   shape that fills the card), each held the same way and timed beside its
   bound, its plain version and `scaled_dot_product_attention` (K1 beside
   its forward, K2 + K3 beside its backward alone, with each kernel's
   share of its bound; null where it refuses a case); then the wide
   instances above d 256 (bf16 and float16 at d 320, 384 and 512, bh 8,
   seq 1024, and at d 384, 512 and 1024, bh 24, seq 2048, causal; all
   three kernels on their Hopper bodies there; float32 small and at d 384
   and 704, bh 24, seq 2048), held and
   timed the same way, with K2 + K3 beside SDPA's backward and each
   kernel's share of its bound; shows that the same check rejects planted
   faults (a skipped tile, in one of the output's column chunks too where
   a block owns one, for O, dQ, dK and dV, P left unnormalised, delta left
   at 0, each sized from the kernel's own tiles) at the main shape, at bf16
   d 256 (bh 24, seq 2048), at d 384 (bf16) and at float32 d 256 and 704
   (bh 24, seq 2048), and that the float32 limits reject the forward and
   the backward pair in one TF32 pass at every float32 case; names the
   kernels
   `scaled_dot_product_attention` runs for float32 (a profiler trace);
   times each kernel, its plain
   version and
   `scaled_dot_product_attention` (a yardstick the port never calls),
   forward and backward alone.
3. Model check: a small GPT-2 with the flash kernels against the same model
   with plain attention, logits and gradients, on the card.
4. Main path: `TorchTrainer(...).fit()` trains GPT-2-small at full width
   (12 layers, 768 wide, 12 heads, vocab 50304, seq 1024, batch 24, bf16)
   for 2 warm-up and 10 timed steps in a worker actor that the runtime
   granted the card; the loss must be finite and fall, the worker must be
   another process seeing card "0", and each step must launch each kernel
   once per layer (counted in the worker, which reports its counts). The
   same steps run in this process (`profile_train_step.build`, no
   trainer) before and after, as the yardstick for tokens/s through the
   actor.
4e. Tune (run right after phase 4): `tune.Tuner` over
   `TorchTrainer(...).as_trainable()` on phase 4's GPT-2-small, lr on a
   grid of 1e-4 and 3e-3, ASHA (max_t 6, grace 2, factor 2),
   `max_concurrent_trials=1`, each trial's worker granted the card and
   reporting every step. Every trial must end TERMINATED with no error,
   each stop must be ASHA's rung rule on the losses the trials reported,
   each worker another process seeing card "0" that launches each kernel
   once a layer a step (counted there), every earlier trial's worker gone
   when a trial asks for the card (checked in the trial actor, before its
   trainer asks), the best trial's loss finite and falling, and after the
   sweep a `num_gpus=1` task granted the card within 60 s. Prints each
   trial's lr, start, runtime and where it went, steps, last loss and
   tokens/s after step 2, the best config and the sweep's wall time
   against the sum of the trials' runtimes.
4f. A submitted job (after 4e, on phase 1b's runtime): `python
   gpt2_job.py 4` (the script `JOB_SCRIPT`, in a working_dir) goes through
   `JobSubmissionClient.submit_job` with a pip environment of one wheel
   made here (`--no-index --find-links`: nothing is fetched), env_vars and
   metadata; the job's driver runs `TorchTrainer.fit()` on phase 4's
   GPT-2-small for 4 steps in one worker granted the card. Its logs must
   stream through `tail_job_logs` while it runs, its status go SUBMITTED,
   RUNNING, SUCCEEDED, its driver and worker import the wheel, its losses
   be finite and fall, its worker be another process seeing card "0" that
   launches each kernel once a layer a step, and its driver open no CUDA
   context. The same script with 200 steps is stopped once its first
   step's loss is in its logs: it must end STOPPED, its driver's and
   worker's processes exit (waited on by pid), and a `num_gpus=1` task be
   granted the card after. `util.accelerators.detect_local_generation()`
   must be "h100". Prints each job's statuses, its log chunks, where its
   time went and the times from the stop to the exit and to the grant.
4g. The mesh and sequence parallelism (after 4f, on phase 1b's runtime):
   (a) `initialize_distributed(..., device="cuda")` forms a one-rank NCCL
   group in this process and `build_mesh(MeshSpec({"sp": 1}))` a CUDA
   DeviceMesh over it (an all-reduce over its sp group must run);
   `ring_attention_sharded` on it, and the ring of its one rank, must be
   bit-equal to `flash_attention` at GPT-2-small's attention shape ([24,
   12, 1024, 64] bf16, causal), forward and backward. (b) The sp 4 ring
   schedule at full width, bf16, causal, at GPT-2-small's long-context
   shape (bh 4 x 12, seq 8192, d 64) and Llama-7B's attention (bh 32, seq
   8192, d 128): the four ranks' `ring_forward_step` and
   `ring_backward_step` stepped in lockstep in this process, each rank
   handed the chunk it would receive; O, dQ, dK and dV are held element by
   element against `flash_attention` over the whole sequence and against
   the plain versions over it in float64, each error printed beside its
   limit; K1, K2 and K3 must launch 10 times each (the schedule's count);
   the busiest rank's kernel time is printed beside `flash_attention`'s
   over the whole sequence. (c) `TorchTrainer.fit` with
   `ScalingConfig(mesh=MeshSpec({"sp": 1}), use_gpu=True)` trains
   Llama-small (phase 10's model, batch 8, seq 2048) for 2 + 3 steps with
   `sp_mesh=train.get_mesh()` in a worker granted the card, whose mesh must
   be a CUDA DeviceMesh over an NCCL group, then the same steps from the
   same seed without a mesh: the losses must fall and agree within 1e-3
   relative (whether they are bit-equal is printed), and K1, K2 and K3 run
   12 times a step in both. Prints the `{"mesh": {...}}` line in phase 12.
   NCCL at sp > 1 needs more than one card and is not run here.
4h. Pipeline parallelism (after 4g, on phase 1b's runtime): (a)
   `LocalPipelineTrainer` trains Llama-small (phase 10's model, bf16 on
   float32 parameters, the flash kernels) at batch 8, seq 2048, 4
   microbatches, lr 1e-2, 2 Adam steps from `seeded_batch(0, step, ...)`,
   at pp 1, pp 2 and pp 4 under "1f1b" and pp 2 under "sequential", each
   stage on a thread and a CUDA stream of its own: the losses must be
   finite, and the losses and merged weights bit-equal to pp 1's (the
   targets are random tokens, so a loss need not fall), and each step
   launch K2 and K3 48
   times and K1 m * (2 * n_layer - L_last) times (48, 72, 84: the stages
   before the last recompute their forward). Prints ms a step, each
   stage's busy time and bubble_frac beside the analytic bubble, the pp 2
   makespan of 1F1B over sequential, peak memory. (b)
   `make_pipeline_train_fn` at (a)'s width and shape, 2 steps, through
   `BackendExecutor` in a one-worker gang granted the card (pp 1): its
   losses must equal (a)'s pp 1 losses, its worker be another process
   seeing card "0" launching (a)'s pp 1 counts a step, and exit after
   the gang's shutdown (waited on by pid); step 1's stage checkpoint
   (~1.5 GB, under the phase's temporary directory) is restored at pp 1,
   equal to (a)'s pp 1 weights and Adam state after its second step, and
   at pp 2, each stage equal to the pp 1 restore's split, bit for bit.
   (c) GPipe: a one-rank NCCL group, a pp 1 DeviceMesh and
   `make_pp_train_step` at GPT-2-small's width and depth (vocab 50304,
   float32, plain attention), seq 1024, batch 8, 4 microbatches: the
   trunk (`gpipe`) bit-equal to the layers applied microbatch by
   microbatch, the forward within 1e-4 of `sequential_forward` over the
   whole batch (cuBLAS picks another float32 algorithm for the whole
   batch's row count than for a microbatch's); 2 Adam steps finite and
   falling, no kernel of the port launched. Prints the `{"pipeline":
   {...}}` line in phase 12. NCCL at pp > 1 needs more than one card and is
   not run here.
4i. Tensor, data and fully-sharded parallelism (after 4h, on phase 1b's
   runtime): (a) `TorchTrainer.fit` with `ScalingConfig(mesh=MeshSpec(
   {"dp": 1, "fsdp": 1, "tp": 1}), use_gpu=True)` trains GPT-2-small
   (phase 4's model and batch, AdamW(3e-4, wd 0.1)) for 2 + 3 steps on
   the mesh (`GPT2(mesh=, state=init_sharded(...))`, `make_train_step(
   mesh=)`: DTensor parameters, FSDP2 and the vocab-parallel head and
   loss, all at size 1) in a worker granted the card over a one-rank NCCL
   group: the losses must fall and agree within 1e-3 relative with phase
   4's first 5 (the same model, seed, optimizer and batch without a mesh),
   and K1, K2 and K3 run 12 times a step; ms a step and peak memory beside
   phase 4's. (b) The same model at dp 1
   x tp 2 as two processes sharing the card (`CUDA_VISIBLE_DEVICES=0`) over
   a gloo group on CUDA tensors that this script forms (NCCL refuses two
   ranks on one device): one step, its loss within 2^-7 relative of (a)'s
   first, every parameter element within 2 lr of (a)'s after its first
   step and at least 90% of them within lr / 10 (each rank holds its own
   shards against the same slices of (a)'s whole tensors: DTensor's
   `full_tensor()` does not return over gloo on CUDA tensors), K1 at bh 144
   12 times; 1 more step timed (ms a step, peak memory) and the c_attn
   exchange of a step timed alone; then Llama-small at tp 2 (6/2 heads a
   rank), batch 4, seq 2048, one step, held the same way against the same
   step at tp 1.
   Prints the `{"tensor_parallel": {...}}` line in phase 12. NCCL at tp >
   1 needs more than one card and is not run here.
4j. Expert parallelism (after 4i): MoE-small (`MoEConfig.small()`: 8 x
   1024, 8 experts, top-2, capacity 1.25; batch 4, seq 2048, seed 0, bf16
   on float32 parameters, AdamW 3e-4) at ep 2 as two processes sharing
   card 0 over a gloo group this script forms (NCCL takes no two ranks on
   one device), each rank 4 experts (`MoE(mesh=)`,
   `make_moe_train_step(mesh=)`). One checked step, then EP_TIMED timed
   steps, counted (collectives a step, host ms inside them); then each
   rank in turn runs the plain one-card step on the same weights and
   batch, the yardstick. The checked step's loss must be within 2^-7
   relative of the plain step's, every parameter shard after it within 2
   lr with at least 0.9 of its elements moved alike (held shard by shard:
   DTensor's `full_tensor()` over gloo on CUDA tensors does not return),
   layer 0's slots used per expert equal the plain step's (its inputs are
   bit-equal), and K1, K2 and K3 launch 8 times a step on each rank.
   Prints how many routing choices agree in every layer, ms a step, peak
   memory a rank and the `{"expert_parallel": ...}` line in phase 12.
4k. The cluster tier (after 4j; phase 1b's runtime goes down for it and
   comes back after). (a) An in-process `Cluster` (a CPU head, a node with
   the card) and `TorchTrainer(scaling_config=ScalingConfig(num_workers=1,
   use_gpu=True), FailureConfig(max_failures=1))` on phase 4's
   GPT-2-small and batch (seed 0, AdamW) for 6 steps; rank 0 reports a
   checkpoint of the model's and AdamW's state after step 2 and waits
   there. When the driver has seen that checkpoint (its report callback,
   an event), a `ChaosRunner` fires a one-event `worker_kill` schedule
   (`single_event_schedule`, seed 23) through `WorkerKillInjector(cluster,
   actors_only=True)`. The killed pid must be the one the worker reported
   from card 0; the gang must restart in a fresh worker spawned cold (a
   child of this process's raylet, not of the template) with card 0 and
   resume at step 3; steps 0-5's losses must be within 1e-6 relative of
   the same six steps run in this process with no fault (run while the
   worker starts; bit-equal expected, the largest difference printed);
   `assert_recovered()` must pass and a `HangWatchdog` around `fit()`
   report no hang; the killed pid must exit and nvidia-smi's list of
   compute apps come back to this process's entries (the chip machine's
   container lists every process as pid 1, so the count is what is
   held). Prints MTTR by kind, kill to the first resumed step, steps lost
   and K1-K3's launches (12 a step, in both workers). (b) `python -m
   ray_tpu_torch start --head --num-gpus 0` as a daemon (a fresh exec),
   `init(address="auto")`, and a `StandardAutoscaler` over
   `GCEGPUNodeProvider` (a3-highgpu-1g) whose `SubprocessFakeGPUTransport`
   runs each VM's startup script (`start --address=... --num-gpus 1`): a
   pending `num_gpus=1` task boots that node, returns the card's name and
   a bf16 product of two 4096² matrices computed there, held against the
   CPU's float32 product of the same inputs (2^-8 |cpu| + 1e-3 rms); the
   idle node is deleted after idle_timeout_s (2 s) and its daemon exits;
   `python -m ray_tpu_torch stop` leaves no daemon, and nvidia-smi's list
   comes back to this process's entries. Prints the head's start, the task's submit to running split into
   node boot and worker start (and when the node joined), idle to delete,
   and `status`'s `resources_total` before, with the node and after. The
   phase's budget of 60 s is printed.
4l. The rest of the platform (after 4k, on the runtime it brought back):
   (a) an actor asking for `num_gpus=1, resources={"scorer": 1}` must stay
   PENDING_CREATION until `experimental.set_resource("scorer", 1)` makes
   the resource on the head node; it builds GPT-2-small (seed 0, drawn on
   the CPU, moved to the card) and puts its pid, CUDA_VISIBLE_DEVICES and
   parameter count in `internal_kv`, which this process reads back: another
   process, card "0", GPT-2-small's count. A second `set_resource` while
   the actor holds the card must leave the GPU's availability at 0. (b)
   128 windows of 1024 seeded tokens (phase 4d's size) are scored in 8
   batches of 16, each window's mean next-token NLL through K1, through
   `ActorPool([scorer])`: once with `map` (the batches in order) and once
   with `map_unordered` (the same set); both must equal the same windows
   scored in this process on the card by the same model built the same
   way (bit-equal expected, else within 1e-6 relative, the largest gap
   printed), and K1 must launch 12 times a batch in the actor (192, counted
   there), K2 and K3 never. (c) During `map` the actor puts each batch's
   (index, mean NLL) on a `util.queue.Queue`, drained here and held to the
   pool's results, and each pass's `experimental.tqdm_ray.tqdm` bar's final
   line (8/8) must reach this process's log stream. (d) `cpp/examples/
   smoke.cc`, unchanged, built by g++ into `build/xlang/` while the phase
   starts, runs against the port's `xlang` gateway (a named
   `xlang-counter` actor, `tests/xlang_mod.py` by name) while the scorer
   holds the card and must print SMOKE OK; its put is read back here and
   its KV write seen (host-side: this leg bypasses the card). (e) Where
   `transformers`, `xgboost` or `lightgbm` is absent, constructing its
   trainer must raise the ImportError naming it (a present one is reported
   as skipped). The actor is killed and its pid waited on. Prints the
   actor's cold start (ask to ready, and from `set_resource`), its build
   seconds and tokens/s through the pool beside this process's own loop;
   the phase's budget of 30 s is printed.
4m. raylint on the chip machine (after 4l; it starts no GPU worker and
   launches no kernel of the port: its counts must stay 0): (a) `python -m
   ray_tpu_torch.analysis ray_tpu_torch/` in a subprocess must exit 0 with
   no finding (this machine has no JAX, so the run also shows the
   linter's imports are clean); its wall time is printed. (b) The RL020
   and RL021 twins of `tests/torch_lint_fixtures.py` are linted here: each
   known-bad one must draw its rule, each known-good one nothing; then a
   fresh process runs them on CUDA tensors under
   `torch.cuda.set_sync_debug_mode("error")`: each bad twin must raise the
   synchronizing-operation error, each good one must run through (RL021's
   good twin waits once, on an event after a non-blocking copy into pinned
   memory, which the mode does not count), and the mode is reset in a
   `finally` and read back. (c) RL024's twins, linted the same way, run in
   that process: the bad one initialises CUDA and forks a child, whose
   first CUDA call must fail with "Cannot re-initialize CUDA in forked
   subprocess"; the good one spawns its child, which must use the card.
   (a) runs beside (b) and (c). Prints `{"analysis": {...}}` in phase 12:
   the lint's seconds and findings, each check, the phase's seconds
   (predicted 20-40 s; its budget of 45 s is printed, not enforced).
4c. Data-fed training: a corpus of 16 shards of 2^20 int32 tokens from
   seed 0 (the nanoGPT layout; each an `.npz` row with the shard's index)
   goes through `read_numpy`, a `map_batches` that cuts windows of 1,025
   tokens into `ids`, `targets` and the window's index, and
   `random_shuffle(seed=0)`, into
   `TorchTrainer.fit(datasets={"train": ds})` with phase 4's model, batch
   and steps in a worker actor granted the card; the loop reads
   `get_dataset_shard("train").iter_batches(batch_size=24,
   drop_last=True)` for 2 + 10 steps and stops, most of the epoch unread.
   The loss must be finite and fall, the worker be another process seeing
   card "0", each step launch each kernel once a layer, the 288 windows be
   distinct, the shard's `stall_frac` be below 0.10 (the reference's
   bound) and the store hold no more objects than before within 20 s of
   `fit()` returning. Prints tokens/s beside phase 4's, `first_batch_ms`,
   `stall_ms_per_step`, the shuffle's windows and peak memory. The loop
   reports the model's state dict as its checkpoint.
4d. Scoring: `BatchPredictor.from_checkpoint(<4c's checkpoint>,
   <a TorchPredictor that returns each row's summed log-likelihood of its
   targets>, model=<GPT-2-small spec>, input_column="ids")` scores the
   first 128 windows of the last shard, in order, in batches of 16, in one
   pool actor granted the card (`predict(...).with_resources(num_gpus=1)`,
   once 4c's worker has exited). Every row must be scored once, equal to
   the same checkpoint scored in this process at the same batches
   (`SCORE_TOL`), in another process seeing card "0", with K1 12 times a
   batch and K2 and K3 never. Prints rows/s and tokens/s, the actor's
   ready time and peak memory.
6. Llama-7B forward: `LlamaConfig.llama7b()` at full width and depth
   (5,933,109,248 float32 parameters from seed 0, bf16 compute), batch 1,
   seq 2048, through the flash kernel, through plain attention and in
   float32 with the same weights; the kernel's logits must be no further
   from the float32 ones than plain attention's (`MODEL_ERR_RATIO`), and K1
   launched once per layer. Holds K1 alone at that shape (bh 32, seq 2048,
   d 128, causal) against its plain version element by element and times
   it beside its bound and `scaled_dot_product_attention`'s forward.
7. Llama-7B serving: `InferenceEngine` on the same model (8 slots, blocks of
   16, 2,048-token context, a 2 GiB arena, chunks of 512, prefix cache on)
   serves 16 requests from seed 0 (prompts of 256-1024 tokens, 8 sharing a
   512-token prefix, 16 new tokens each, all submitted at once). Checks
   that every request gets its tokens, no block leaks, each program saw one
   shape and the prefix cache hit; prints prefill and decode tokens/s, TTFT
   p50/p99, ms per decode step at 8 busy slots, peak memory, and how far 2
   requests follow a bf16 dense-cache loop. Then a speculative leg on the
   same model (draft length 4, the 16-layer truncated draft, 4 requests of
   16 tokens): no leaks, one shape per program, its accept rate. Last, on
   the same weights computing in float32, the engine's tokens (4 requests
   of 16) against a dense-cache greedy loop through
   `Llama.decode`, and the speculative engine's against the plain one's,
   each up to the reference's first near tie. First of all, on an engine of
   its own (freed before the load's), one prompt of 640 tokens (seed 1) is
   served alone.
7b. Serve: `serve.run(LLMServer.options(num_replicas=1,
   ray_actor_options={"num_gpus": 1}).bind(model_size="7b", ...))` with
   phase 7's engine configuration, once phase 7 has freed the card. The
   replica must be another process seeing card "0", with every GPU worker
   retired for the card exited. Phase 7's solo prompt, served alone first,
   must give exactly phase 7's tokens; then phase 7's 16 requests through
   `handle.generate`, 2 of them again through a handle stream and 2 more
   over HTTP (chunked JSON lines), all at once: all 20 must answer, every
   request 16 tokens after its prompt, the streams equal to generate's, no
   leaked block and one shape per program (read from `metrics()`). Prints
   output tokens/s, TTFT p50/p99 over the 20 requests as the replica's
   engine reports it (submit to first token) and, apart, the client's
   submit-to-first-streamed-token of the 4 streamed ones, replica ready
   time (serve.run to the first reply) and peak memory beside phase 7's;
   the replica must exit after `serve.shutdown()`. Then `GPT2Sampler(
   "small", max_seq=1024)` in a one-GPU replica answers 8 concurrent
   requests of 64 tokens in one padded batch (mean batch size > 1) with
   exactly the tokens of the same padded greedy loop run here, each as long
   as its prompt and budget say and agreeing with a plain unpadded greedy
   loop (one forward of the request's own sequence a token) up to that
   loop's first near tie, and K1 launched in the replica 12 times a
   forward.
7c. Tensor-parallel serving (after 7b has freed the card): Llama-7B at
   full width and depth, tp 2, as two processes sharing card 0
   (`CUDA_VISIBLE_DEVICES=0`) over a gloo group this script forms (NCCL
   refuses two ranks on one device): each rank draws the seed-0 weights
   one parameter at a time and keeps its shard (`Llama(cfg, mesh=)`);
   rank 0's engines schedule and send each step's record, rank 1's
   `follow()`. (a) Phase 7's engine configuration (each rank's arena half
   of the 2 GiB, 4 of the 8 KV heads) serves 8 of phase 7's requests (4
   sharing its prefix), 16 new tokens each, all at once; (b) a
   speculative leg on the same shards, draft length 4, 2 requests of 8
   tokens; (c) the same shards computing in float32 serve phase 7's
   float32 requests, whose tokens must equal phase 7's dense-cache
   float32 loop up to its first near tie (phase 7's references, not run
   again). Every engine, on both ranks: every token, no leaked block, one
   shape a program; each rank's peak memory below phase 7's; no kernel of
   the port launched in either process. Prints output tokens/s, ms a
   decode step at 8 busy slots, the gloo collectives a decode step and the
   host time spent inside them (each crosses loopback TCP), how far each
   request follows phase 7's bf16 tokens, the accept rate, each rank's
   peak memory beside phase 7's and the phase's time beside its 90 s
   budget, which it does not enforce (not met on every host yet). Prints
   the `{"tp_serving": {...}}` line in phase 12.
8. Long context (`bench.py` bench_gpt2_long's first rung): `TorchTrainer.
   fit` trains GPT-2-small at full width and depth at seq 8192 with
   per-block remat, batch 4, for 2 warm-up and 5 timed steps; the loss must
   be finite and fall, and each step launch K1 24 times (12 forwards, 12
   recomputes), K2 and K3 12 times. Then runs K1, K2 and K3 at the leg's
   attention shape (bh 48, seq 8192, d 64, bf16, causal), holds them
   element by element against their plain versions four heads at a time,
   and times them beside their bounds and `scaled_dot_product_attention`'s
   forward and forward + backward. Last, the leg's model at batch 1
   through 3 AdamW steps with the kernels and with plain attention: in
   float32 the losses and first-step gradients agree within the float32
   kernels' limits; in bf16 the losses within 2e-2 and the gradients no
   further from the float32 model's than plain attention's.
9. Remat on the card: the phase-3 GPT-2 in float32 with remat on and off,
   with dropout 0 and 0.1 (the checkpoint restores the generators, so the
   recompute draws the same masks): the loss and every gradient must agree
   within the float32 kernels' 5e-4, and remat launch K1 twice a layer.
   Prints whether the two are bit-equal.
10. Llama-small training (`LlamaConfig.small()`, GQA 12/4 heads):
   `TorchTrainer.fit`, batch 8, seq 2048, 2 + 10 steps; falling loss, K1,
   K2 and K3 12 times a step.
11. MoE-small training (`MoEConfig.small()`, 8 experts, top-2, capacity
   1.25): `TorchTrainer.fit` with `make_moe_train_step`, batch 4, seq
   2048, 2 + 3 steps; falling cross-entropy, a finite router loss, K1, K2
   and K3 8 times a step; prints layer 0's slots used per expert and the
   share of routing choices dropped at capacity in the last step.
11b. RLlib on the card, at the width of the reference's Atari PPO
   configuration (`tuned_examples._atari_ppo_config`: 4 rollout workers x
   8 envs x 100 steps, minibatch 500, 10 SGD epochs, lr 5e-5) on the
   Atari-native synthetic env (210x160x3 uint8 frames, 4 actions, episodes
   of 32 steps; ALE is absent) through `atari_connectors()` (84x84x4 uint8):
   one `PPOLearner.update` of the Nature CNN on the card against the same
   update on the CPU from the same weights and 500-row batch (loss,
   metrics, gradient norm and the largest weight difference, each beside
   its limit; the card runs full float32, TF32 off), with the SGD step's
   wall time, kernel time and launches from a trace; then PPO itself, one
   warm-up and 2 iterations with rollout workers in CPU actors (finite
   losses; env steps/s, learner rows/s as SGD steps x 500 / learn_s, ms an
   SGD step, learn_s's share, peak memory; the learner's parameters on
   cuda:0, every worker at `CUDA_VISIBLE_DEVICES=""`); IMPALA (the Atari
   IMPALA configuration, 4 updates an iteration) with
   `learner_mode="remote"` in an actor granted card "0", and
   `vtrace_returns` on the card against the CPU at its [T, B]; DQN on Catch
   at 84 px for 24 updates on the card, its target synced at 256 env steps.
   No kernel of the port is on this path; the phase must launch none.
11c. Offline BC: 4 CartPole sample batches of 200 rows go through
   `write_batches` (JSON lines) and back through `read_batches`, the same
   rows; then one `BC` update over them on the card and on the CPU from
   the same weights: the loss within 1e-4 relative and the weights within
   lr / 10 (phase 11b's limits), and no kernel of the port launched.
12. Results (phase 5 before phases 6 and 7 came): prints the seconds of
   each phase (`{"phase_seconds": {...}}`), the serving and training
   numbers, the `{"data": {...}}` line (phases 4c, 4d, 11c), the
   `{"tune": {...}}` line (phase 4e), the `{"jobs": {...}}` line (phase
   4f), the `{"mesh": {...}}` line (phase 4g), the `{"pipeline": {...}}`
   line (phase 4h), the `{"tensor_parallel": {...}}` line (phase 4i), the
   `{"expert_parallel": {...}}` line (phase 4j, beside phase 11's peak
   memory), the `{"tp_serving": {...}}` line (phase 7c), the
   `{"cluster": {...}}` line (phase 4k), the `{"platform": {...}}` line
   (phase 4l), the `{"analysis": {...}}` line (phase 4m), the
   `{"rllib": {...}}` line, the
   `{"kernels": [...]}` line (launches summed over the paths of phases 4,
   4e, 4f, 4g, 4h, 4i, 4j, 4k, 4l, 4m, 4c, 4d, 6, 7, 7b, 7c, 8, 10, 11,
   11b and 11c;
   each record also holds its time at the long-context shape under
   `gpt2_long`, K1's at the Llama-7B shape under `llama7b_prefill`, and
   each head-dim and float16 instance
   of phase 2 under `instances`, each with its share of its bound,
   `bound_share`; K1's holds the float32 SDPA kernels under
   `sdpa_float32_kernels`; K2's and K3's records hold
   `scaled_dot_product_attention`'s backward, which does their joint work,
   under `sdpa_backward_ms`, at the main shape, at seq 8192 and at each
   instance of phase 2), then the device line last.

Phases 4c, 4e, 4f, 4g, 4i, 8, 10 and 11 also train in worker actors
through `TorchTrainer`, phase 4h through `BackendExecutor`, and phases 4i
(b) and 4j in two processes of their own, as phase 7c serves. Each phase
frees what it allocated before the next starts, and the script shuts the
runtime and its worker template down before it exits.

Depth cut to pay for phase 4k: phase 7's requests take 16 new tokens (32
before), so phase 7b's requests 16 and phase 7c's float32 requests 16;
phase 7c's requests 16 (32); phase 4h's pipeline runs 2 steps at each pp
(3); phase 4d scores 128 windows (256); phase 11b's PPO times 2
iterations after its warm-up (3). PERF.md §6 (PR 23) has each phase's
seconds before and after.

Depth cut to pay for phase 4j: phase 4i (b) times 1 step after its
checked one (3 before), phase 7c's speculative leg serves 8 new tokens a
request (32 before), phase 11 times 3 steps after its 2 warm-up ones (5
before).

Depth cut to pay for phase 7c (79.1 s; PERF.md §6): phase 7's requests
take 32 new tokens (128 before), its speculative legs 16 (32 before), so
phase 7b's requests 32 and phase 7c's float32 requests 32 and 16: phase 7
ran 41.7 s (166.2 s at 128 and 32 tokens in an earlier run), phase 7b
67.0 s; phase 4e sweeps two learning rates (1e-4, 3e-3; four before):
41.0 s (116.9 s with four). All phases 752.6 s and, on a slower host,
866.6 s (805.3 s before phase 7c and the cuts). Runs on an NVIDIA H100
80GB HBM3 at 700.00 W.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
# Dense tensor-core rates. float32: 495 TFLOP/s of TF32 over the three
# products of 3xTF32, the least time for float32-accurate products on this
# card and the route of torch's float32 attention (the memory-efficient
# kernel's OpMultiplyAddFastF32); the CUDA cores' 67 TFLOP/s is below it.
PEAK_FLOPS = {torch.bfloat16: 989e12,
              torch.float16: 989e12,
              torch.float32: 495e12 / 3}

# Tolerances, element by element: |kernel - plain| <= tol * (typical +
# |plain|), where typical is the rms of the plain tensor's row (see
# `mismatch`). The rms term stands in for an absolute tolerance, so elements
# near zero are held to a share of their row's size, not of the largest
# value. It is taken per row because a row's size follows its position: row
# i of the causal output averages i + 1 values, so early rows of dQ are ~30x
# the late ones, and one rms for the tensor would be too tight for the early
# rows and too loose for the late ones. Its floor, a tenth of the tensor's
# rms, holds a row that is 0 in exact arithmetic (row 0 of dQ, where dP and
# delta cancel) to float32 noise rather than to 0.
# bf16: the kernels round P and dS to bf16 (8 significant bits, up to 2^-9
# relative) to feed the tensor cores where the plain version keeps float32;
# that error is random across a row's terms and a small share of the row's
# size. Both round the result once to bf16, so they may differ by one ulp,
# up to 2^-7 of |plain|. 2e-2 covers both with room.
# float32: the forward's products run in 3xTF32 (each operand split into
# two TF32 parts; the dropped small * small term is about 2^-22 of a
# product, float32's own rounding) and its sums in another order over up
# to 1024 terms: 1e-4 for the forward, which a single TF32 pass (2^-11)
# breaks (check_single_pass_tf32). The backward pair runs its products the
# same way; its gradients go through one more product with cancelling
# terms (dP - delta), so 5e-4, which one TF32 pass breaks too.
# float16: the same rounding of P and dS as bf16, to 11 significant bits
# (2^-12 relative) instead of 8, and one rounding of the result (2^-11):
# 5e-3 covers both with the same room as bf16's 2e-2.
TOL = {(torch.bfloat16, "fwd"): 2e-2, (torch.bfloat16, "bwd"): 2e-2,
       (torch.float16, "fwd"): 5e-3, (torch.float16, "bwd"): 5e-3,
       (torch.float32, "fwd"): 1e-4, (torch.float32, "bwd"): 5e-4}

MAIN = dict(bh=24 * 12, seq=1024, d=64, dtype=torch.bfloat16, causal=True)
CASES = [
    MAIN,
    dict(MAIN, causal=False),
    dict(bh=64, seq=1024, d=128, dtype=torch.bfloat16, causal=True),
    dict(bh=6, seq=200, d=64, dtype=torch.bfloat16, causal=True),
    dict(bh=4, seq=256, d=64, dtype=torch.float32, causal=True),
    dict(bh=3, seq=200, d=128, dtype=torch.float32, causal=False),
    dict(bh=5, seq=130, d=32, dtype=torch.bfloat16, causal=True),
    # The long-context length (phase 8), at bh 4: the plain version's
    # float32 scores take bh x 8192^2 x 4 bytes, 1 GiB here. Phase 8 holds
    # the kernels at the leg's bh 48 four heads at a time.
    dict(bh=4, seq=8192, d=64, dtype=torch.bfloat16, causal=True),
    # The attention shapes of phases 10 and 11: Llama-small at batch 8 x 12
    # heads and MoE-small at batch 4 x 16 heads (after the GQA repeat); the
    # plain scores take 1.5 and 1 GiB.
    dict(bh=96, seq=2048, d=64, dtype=torch.bfloat16, causal=True),
    dict(bh=64, seq=2048, d=64, dtype=torch.bfloat16, causal=True),
    # The backward pair's Hopper bodies at d 192 and 256: ragged, the last
    # streamed tile ending inside the head in several heads (seq 300 and
    # 77), and non-causal.
    *(dict(bh=bh, seq=seq, d=d, dtype=t, causal=causal)
      for d in (192, 256) for t in (torch.bfloat16, torch.float16)
      for bh, seq, causal in ((6, 300, True), (5, 77, True),
                              (3, 256, False))),
]
# The instances that take the head dims 192 and 256 and float16 (the JAX
# package's kernels take any d % 64 == 0 in any float type): each is held
# as CASES are and timed.
F1_CASES = [
    *(dict(bh=24, seq=2048, d=d, dtype=t, causal=True)
      for d in (192, 256) for t in (torch.bfloat16, torch.float16)),
    dict(MAIN, dtype=torch.float16),
    dict(MAIN, d=128, dtype=torch.float16),
    dict(bh=4, seq=256, d=256, dtype=torch.float32, causal=True),
    # float32 at a shape that fills the card (384 row blocks of the forward
    # on 132 SMs), as the 16-bit instances above are timed.
    *(dict(bh=24, seq=2048, d=d, dtype=torch.float32, causal=True)
      for d in (64, 128, 192, 256)),
]
# The wide instances (head dims above 256, d at run time): bf16 and
# float16 at d 320, 384 and 512 (bh 8, seq 1024), float32 small; each held
# and timed as F1_CASES are. The planted faults run again at F3_FAULTS.
# The 16-bit forward's Hopper body there is timed at a shape that fills
# the card too (bh 24, seq 2048; d 384, 512 and 1024).
F3_CASES = [
    *(dict(bh=8, seq=1024, d=d, dtype=t, causal=True)
      for d in (320, 384, 512) for t in (torch.bfloat16, torch.float16)),
    *(dict(bh=2, seq=256, d=d, dtype=torch.float32, causal=True)
      for d in (320, 384, 512)),
    *(dict(bh=24, seq=2048, d=d, dtype=t, causal=True)
      for d in (384, 512, 1024) for t in (torch.bfloat16, torch.float16)),
    # The float32 forward above 256 at a shape that fills the card.
    *(dict(bh=24, seq=2048, d=d, dtype=torch.float32, causal=True)
      for d in (384, 704)),
]
F3_FAULTS = dict(bh=8, seq=1024, d=384, dtype=torch.bfloat16, causal=True)
# The planted faults at the widest Hopper instance, and at the float32
# bodies' widest d <= 256 and widest instance (O's columns in three
# chunks of 256, dQ's, dK's and dV's in six of 128; at d 256 the
# gradients' in two), each filling the card.
F10_FAULTS = dict(F1_CASES[2])
assert F10_FAULTS["d"] == 256 and F10_FAULTS["dtype"] == torch.bfloat16
F32_FAULTS = [dict(bh=24, seq=2048, d=d, dtype=torch.float32, causal=True)
              for d in (256, 704)]
assert all(f in F1_CASES + F3_CASES for f in F32_FAULTS)
# Kernel bodies that must not spill (phase 1), by source: the Hopper bodies
# at d 192 and 256, and those above d 256, whose instances are named by
# the columns of the output a block owns (192 and 256), as ptxas_usage
# names them; and the float32 bodies at every chunk of the output's
# columns (the backward pair's up to 128).
NO_SPILL = {src: [f"{body}<{t}, {d}>" for body in bodies
                  for t in ("bf16", "f16") for d in (192, 256)]
            for src, bodies in (
                ("flash_fwd.cu", ("fwd_kernel_sm90", "fwd_kernel_sm90_wide")),
                ("flash_bwd.cu", ("bwd_dq_kernel_sm90",
                                  "bwd_dkv_kernel_sm90_split",
                                  "bwd_dq_kernel_sm90_wide",
                                  "bwd_dkv_kernel_sm90_wide")))}
NO_SPILL["flash_fwd.cu"] += [f"fwd_kernel_tf32<float, {c}>"
                             for c in (32, 64, 128, 256)]
NO_SPILL["flash_bwd.cu"] += [f"{body}<float, {c}>"
                             for body in ("bwd_dq_kernel_tf32",
                                          "bwd_dkv_kernel_tf32")
                             for c in (32, 64, 128)]
# (kernel, output, tolerance) of each output held against its plain
# version; delta is a float32 sum in both, held to the float32 forward's.
OUTPUTS = [("flash_fwd", "out", "fwd"), ("flash_fwd", "lse", "fwd"),
           ("flash_bwd_dq", "dq", "bwd"), ("flash_bwd_dq", "delta", "delta"),
           ("flash_bwd_dkv", "dk", "bwd"), ("flash_bwd_dkv", "dv", "bwd")]
# Phase 8's attention shape: batch 4 x GPT-2-small's 12 heads, held against
# the plain version LONG_CHUNK heads at a time.
LONG_BATCH, LONG_CHUNK = 4, 4
LONG_SHAPE = dict(bh=LONG_BATCH * 12, seq=8192, d=64, dtype=torch.bfloat16,
                  causal=True)
# Phase 8's model check: the leg's GPT-2 at batch 1 (plain float32
# attention keeps [12, 8192, 8192] float32 scores, 3 GiB, a layer), through
# this many AdamW steps.
LONG_CHECK_BATCH, LONG_CHECK_STEPS = 1, 3
REPLACES = {
    "flash_fwd": "ray_tpu/ops/attention.py:60",
    "flash_bwd_dq": "ray_tpu/ops/attention.py:173",
    "flash_bwd_dkv": "ray_tpu/ops/attention.py:220",
}
SOURCES = {
    "flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "ray_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_bwd.cu",
}
BATCH = 24  # phase 4's batch; MAIN is its attention shape
LLAMA_SEQ = 2048                 # phase 6: Llama-7B prefill, batch 1
# Phase 7: the serving configuration. 8 x 128 blocks of 16 tokens, plus the
# trash block: every slot can hold a full 2,048-token context at once.
SERVE = dict(model_size="7b", batch_slots=8, block_size=16,
             max_blocks_per_seq=128, num_blocks=8 * 128 + 1,
             prefill_chunk=512)
# 32 new tokens a request (128 before phase 7c came: the script's time;
# the float32 agreement ends at the first near tie, 3-40 tokens in).
N_REQUESTS, NEW_TOKENS, SHARED_PREFIX = 16, 16, 512   # 32 before 4k
# Phases 7 and 7b first serve one fresh prompt alone (seed 1, no prefix
# shared with the others): its tokens through Serve must equal the engine's
# driven directly, exactly.
SOLO_LEN = 640
# Phase 7b: the load's requests that also go through a stream (their
# twins through generate, in the same wave) and the ones over HTTP.
STREAMED, OVER_HTTP = (1, 3), (5, 7)
# Phase 7b's GPT2Sampler leg: requests of this many new tokens, prompts of
# 16-256 tokens from seed 2.
SAMPLER_REQUESTS, SAMPLER_NEW = 8, 64
PROMPT_LEN = (256, 1024)
N_COMPARED = 2                   # requests held against the dense loop
# 16 new tokens a speculative request (64 before phase 4i came, 32 before
# phase 7c: the script's time; the float32 agreement ends at the first
# near tie, 3-40 tokens in, PERF.md).
SPEC_DRAFT_LEN, SPEC_REQUESTS, SPEC_TOKENS = 4, 4, 16
# Near-tie rule: greedy tokens are compared up to the first step where the
# reference's top-2 logit gap is below this share of the logit row's rms
# (sums in another order may pick either side of such a tie). It holds the
# engine in float32, where the two sides differ only in summation order.
NEAR_TIE = 2e-2
# Phase 6 holds whole-model logits, 32 bf16 layers deep, against the same
# weights computing in float32: a bf16 model sits ~1.4% (rms) from it after
# 8 layers, and element by element its logits differ from another bf16
# rounding of the same model by 3x the kernels' 2e-2 limit (both measured on
# the CPU, PERF.md). So the kernel's model must be no further from the
# float32 one than the plain-attention model is, within a quarter; the
# kernel itself is held element by element at that shape after.
MODEL_ERR_RATIO = 1.25


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def mismatch(got, want, tol: float) -> float:
    """max |got - want| / (tol * (typical + |want|)), element by element:
    the check holds at <= 1. `typical` is the rms of the element's row (its
    last dimension), and at least a tenth of the whole tensor's rms."""
    g, w = got.float(), want.float()
    typical = torch.maximum(w.square().mean(dim=-1, keepdim=True).sqrt(),
                            w.square().mean().sqrt() / 10)
    limit = tol * (typical + w.abs())
    return ((g - w).abs() / limit.clamp_min(1e-30)).max().item()


def rel_err(got, want) -> float:
    """rms(got - want) / rms(want), in float32."""
    g, w = got.float(), want.float()
    return ((g - w).square().mean().sqrt()
            / w.square().mean().sqrt()).item()


def bound(case, n_products: int, tensors):
    """(ms, "bytes" or "operations"): the least time for the work, the
    larger of the bytes of every input read once and every output written
    once over the HBM rate, and the products' FLOPs over the peak rate of
    the type, counting only the (q, k) pairs the mask keeps."""
    s = case["seq"]
    pairs = s * (s + 1) // 2 if case["causal"] else s * s
    flops = 2.0 * case["bh"] * pairs * case["d"] * n_products
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    byte_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    op_ms = 1e3 * flops / PEAK_FLOPS[case["dtype"]]
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def ptxas_usage(log: str):
    """(kernel, registers, spill line) for each kernel in `nvcc -Xptxas -v`
    output; the kernel is named with its template arguments, read from the
    mangled name (e.g. `bwd_dq_kernel_sm90<bf16, 64>`; the bodies whose d
    is a run-time argument by the columns of the output a block owns,
    `fwd_kernel_sm90_wide<bf16, 256>`, `bwd_dkv_kernel_tf32<float, 128>`)."""
    import re

    types = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\d+(\w+?)I(f|13__nv_bfloat16|"
                      r"6__half)(?:Li(\d+)E)?Ev", line)
        if m:
            fn = f"{m[1]}<{types[m[2]]}, {m[3] or 'd'}>"
        elif "spill" in line:
            spill = line.strip()
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out.append((fn, int(m[1]), spill))
            fn = None
    return out


def check_smem(attn, build) -> None:
    """The shared memory each C entry point asks for must be what the tile
    table gives (`attention.kernel_smem_bytes`); past the largest head dim
    of each type `flash_attention` must refuse, naming it."""
    fwd, bwd = build.load("flash_fwd.cu"), build.load("flash_bwd.cu")
    for dtype, code in attn._DTYPE_CODES.items():
        for d in attn.head_dims(dtype):
            got = {"flash_fwd": fwd.flash_fwd_smem(d, code),
                   "flash_bwd_dq": bwd.flash_bwd_smem(0, d, code),
                   "flash_bwd_dkv": bwd.flash_bwd_smem(1, d, code)}
            want = attn.kernel_smem_bytes(d, dtype)
            if got != want:
                raise AssertionError(f"shared memory at d={d} {dtype}: the "
                                     f"kernels ask for {got}, the tile table "
                                     f"gives {want}")
    largest = max(max(attn.kernel_smem_bytes(d, t).values())
                  for t in attn._DTYPE_CODES for d in attn.head_dims(t))
    most = {str(t).split(".")[-1]: m for t, m in attn.WIDE_MAX_D.items()}
    print(f"  shared memory of every kernel, dtype and head dim matches the "
          f"tile table (largest {largest} B; head dims up to {most})")
    # No block grows with d above 256, so each type's cap is the tile
    # table's own (WIDE_MAX_D); flash_attention must refuse past it, naming
    # it.
    for dtype in attn._DTYPE_CODES:
        d = attn.WIDE_MAX_D[dtype] + 64
        q = torch.zeros(1, 1, 8, d, dtype=dtype, device="cuda")
        try:
            attn.flash_attention(q, q, q)
        except ValueError as err:
            if str(attn.WIDE_MAX_D[dtype]) not in str(err):
                raise AssertionError(f"d={d} {dtype} refused without naming "
                                     f"{attn.WIDE_MAX_D[dtype]}: {err}")
        else:
            raise AssertionError(f"flash_attention took d={d} {dtype}")
    print(f"  past the largest head dims: refused at d "
          f"{attn.WIDE_MAX_D[torch.float32] + 64} in float32, "
          f"{attn.WIDE_MAX_D[torch.bfloat16] + 64} in bf16 and float16")


def run_kernels(attn, q, k, v, do, causal: bool, scale: float) -> dict:
    """K1, then K2 writing delta, then K3 reading it, as on the main path."""
    out, lse = attn._flash_forward(q, k, v, causal, scale)
    dq, delta = attn._bwd_dq(q, k, v, do, out, lse, causal, scale)
    dk, dv = attn._bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "delta": delta, "dk": dk,
            "dv": dv}


def run_plain(attn, q, k, v, do, got, causal: bool, scale: float) -> dict:
    """The plain versions on the same inputs; the backward ones take the
    kernel's out and lse, as K2 and K3 do. float32 cases run them in
    float64: at a causal row's first key dS = P (dP - delta) is 0 in exact
    arithmetic, so that row of dQ is all rounding, held to a tenth of the
    tensor's rms, and the plain versions in float32 miss the float64
    answer there by about the limit itself (check_single_pass_tf32 prints
    how far): no kernel could be judged against them. The limits are the
    same."""
    if q.dtype == torch.float32:
        q, k, v, do = (t.double() for t in (q, k, v, do))
        got = {key: t.double() for key, t in got.items()}
    out, lse = attn.flash_forward_reference(q, k, v, causal, scale)
    delta = attn.bwd_delta(got["out"], do)
    dq = attn.flash_bwd_dq_reference(q, k, v, do, got["lse"], delta, causal,
                                     scale)
    dk, dv = attn.flash_bwd_dkv_reference(q, k, v, do, got["lse"], delta,
                                          causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "delta": delta, "dk": dk,
            "dv": dv}


def compare(got, want, dtype) -> dict:
    """(kernel, output) -> (mismatch, max abs error, tol) for OUTPUTS."""
    res = {}
    for name, what, kind in OUTPUTS:
        tol = (TOL[torch.float32, "fwd"] if kind == "delta"
               else TOL[dtype, kind])
        res[name, what] = (mismatch(got[what], want[what], tol),
                           max_err(got[what], want[what]), tol)
    return res


def worst(values) -> float:
    """The largest value, NaN above all."""
    return max(values, key=lambda x: math.inf if math.isnan(x) else x)


def report(res, label: str) -> dict:
    """Prints each output's error beside its limit and raises on the first
    above it. Returns kernel -> (worst mismatch, worst abs error)."""
    errs = {}
    for (name, what), (ratio, abs_err, tol) in res.items():
        ok = math.isfinite(ratio) and ratio <= 1.0
        print(f"  {name:14s} {what:5s} {label}: max_abs_err={abs_err:.3e}"
              f" mismatch={ratio:.4f} of its limit (tol={tol:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} ({what}) disagrees with its "
                                 f"plain version at {label}")
        w = errs.get(name, (0.0, 0.0))
        errs[name] = (max(w[0], ratio), max(w[1], abs_err))
    return errs


def check_kernels(attn) -> dict:
    """Phase 2. Returns the main-shape record of each kernel."""
    records = {}
    for i, case in enumerate(CASES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        shape = (case["bh"], case["seq"], case["d"])

        def randn():
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=case["dtype"])

        q, k, v, do = randn(), randn(), randn(), randn()
        causal, scale = case["causal"], 1.0 / math.sqrt(case["d"])
        got = run_kernels(attn, q, k, v, do, causal, scale)
        want = run_plain(attn, q, k, v, do, got, causal, scale)
        torch.cuda.synchronize()
        label = case_label(case)
        errs = report(compare(got, want, case["dtype"]), label)
        if case["dtype"] == torch.float32:
            check_single_pass_tf32(attn, q, k, v, do, causal, scale, got,
                                   want, label)
        if case is not MAIN:
            continue
        check_planted_faults(attn, q, k, v, do, got["lse"], want["delta"],
                             scale, got, want, errs)
        out, lse, dq, delta_k, dk, dv = (got[key] for key in (
            "out", "lse", "dq", "delta", "dk", "dv"))
        delta = want["delta"]
        lib_fwd = _sdpa(q, k, v, causal, scale, "forward")
        lib_bwd = _sdpa(q, k, v, causal, scale, "backward")
        lib_fwd_bwd = _sdpa(q, k, v, causal, scale, "both")
        timings = {
            "flash_fwd": (
                lambda: attn._flash_forward(q, k, v, causal, scale),
                lambda: attn.flash_forward_reference(q, k, v, causal, scale),
                2, [q, k, v, out, lse], lib_fwd),
            # K2's plain version includes delta, which the kernel computes.
            "flash_bwd_dq": (
                lambda: attn._bwd_dq(q, k, v, do, out, lse, causal, scale),
                lambda: attn.flash_bwd_dq_reference(
                    q, k, v, do, lse, attn.bwd_delta(out, do), causal, scale),
                3, [q, k, v, do, out, lse, dq, delta_k], None),
            "flash_bwd_dkv": (
                lambda: attn._bwd_dkv(q, k, v, do, lse, delta_k, causal,
                                      scale),
                lambda: attn.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     causal, scale),
                4, [q, k, v, do, lse, delta_k, dk, dv], None),
        }
        for name, (kern, plain, n_prod, tensors, lib_ms) in timings.items():
            b_ms, b_by = bound(case, n_prod, tensors)
            records[name] = b = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": errs[name][1], "ms": time_ms(kern),
                "plain_ms": time_ms(plain, reps=3, rounds=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            }
            if lib_ms is None:
                # No PyTorch call computes dQ alone or dK/dV alone; SDPA's
                # backward computes K2's and K3's work together.
                b["sdpa_backward_ms"] = lib_bwd
            print(f"  {name:14s} main shape: {b['ms']:.4f} ms, plain "
                  f"{b['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}), library {lib_ms}")
        # The plain delta is on no card path now; timed for comparison with
        # the backward before K2 computed it.
        delta_ms = time_ms(lambda: attn.bwd_delta(out, do))
        bwd = records["flash_bwd_dq"]["ms"] + records["flash_bwd_dkv"]["ms"]
        print(f"  attention backward at the main shape: K2 (with delta) + K3 "
              f"{bwd:.4f} ms, scaled_dot_product_attention backward "
              f"{lib_bwd:.4f} ms (plain delta alone {delta_ms:.4f} ms)")
        print(f"  attention fwd+bwd at the main shape: kernels "
              f"{records['flash_fwd']['ms'] + bwd:.4f} ms, "
              f"scaled_dot_product_attention {lib_fwd_bwd:.4f} ms")
    return records


def case_label(case) -> str:
    return (f"bh={case['bh']} seq={case['seq']} d={case['d']} "
            f"{str(case['dtype']).split('.')[-1]} causal={case['causal']}")


def check_instances(attn, records, cases, seed: int) -> None:
    """Phase 2, the head-dim and type instances (F1_CASES, F3_CASES): each
    kernel held element by element against its plain version, then timed
    beside its bound, its plain version and scaled_dot_product_attention
    (forward for K1; forward + backward beside K1 + K2 + K3; its backward
    alone beside K2 + K3). At F3_FAULTS and F10_FAULTS the planted faults
    must be rejected too. Adds one entry per case to each kernel's record
    under `instances`, with its share of its bound (`bound_share`) and, for
    K2 and K3, `sdpa_backward_ms`; an SDPA time is None where SDPA refuses
    the case."""
    for i, case in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        shape = (case["bh"], case["seq"], case["d"])
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=case["dtype"]) for _ in range(4))
        causal, scale = case["causal"], 1.0 / math.sqrt(case["d"])
        got = run_kernels(attn, q, k, v, do, causal, scale)
        want = run_plain(attn, q, k, v, do, got, causal, scale)
        torch.cuda.synchronize()
        label = case_label(case)
        errs = report(compare(got, want, case["dtype"]), label)
        if case in (F3_FAULTS, F10_FAULTS, *F32_FAULTS):
            check_planted_faults(attn, q, k, v, do, got["lse"],
                                 want["delta"], scale, got, want, errs)
        if case["dtype"] == torch.float32:
            check_single_pass_tf32(attn, q, k, v, do, causal, scale, got,
                                   want, label)
        if case == F32_FAULTS[0]:
            records["flash_fwd"]["sdpa_float32_kernels"] = sdpa_kernels(
                q, k, v, causal, scale, label)
        out, lse, dq, delta, dk, dv = (got[key] for key in (
            "out", "lse", "dq", "delta", "dk", "dv"))
        sdpa_fwd, sdpa_both, sdpa_bwd = (
            _sdpa_or_none(q, k, v, causal, scale, part, label)
            for part in ("forward", "both", "backward"))
        work = {
            "flash_fwd": (
                lambda: attn._flash_forward(q, k, v, causal, scale),
                lambda: attn.flash_forward_reference(q, k, v, causal, scale),
                2, [q, k, v, out, lse], sdpa_fwd),
            "flash_bwd_dq": (
                lambda: attn._bwd_dq(q, k, v, do, out, lse, causal, scale),
                lambda: attn.flash_bwd_dq_reference(
                    q, k, v, do, lse, attn.bwd_delta(out, do), causal, scale),
                3, [q, k, v, do, out, lse, dq, delta], None),
            "flash_bwd_dkv": (
                lambda: attn._bwd_dkv(q, k, v, do, lse, delta, causal,
                                      scale),
                lambda: attn.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     causal, scale),
                4, [q, k, v, do, lse, delta, dk, dv], None),
        }
        total, inst = 0.0, {}
        for name, (kern, plain, n_prod, tensors, lib_ms) in work.items():
            b_ms, b_by = bound(case, n_prod, tensors)
            inst[name] = rec = {
                "shape": label, "max_abs_err": errs[name][1],
                "ms": time_ms(kern, reps=5, rounds=3),
                "plain_ms": time_ms(plain, reps=2, rounds=2),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            rec["bound_share"] = b_ms / rec["ms"]
            if name != "flash_fwd":
                rec["sdpa_backward_ms"] = sdpa_bwd
            total += rec["ms"]
            records[name].setdefault("instances", []).append(rec)
            print(f"  {name:14s} {label}: {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{rec['bound_share']:.1%} of it)"
                  + (f", sdpa forward {lib_ms:.4f} ms "
                     f"({rec['ms'] / lib_ms:.3f}x)"
                     if name == "flash_fwd" and lib_ms else ""))
        print(f"  {label}: K1 + K2 + K3 {total:.4f} ms, "
              f"scaled_dot_product_attention forward + backward "
              + (f"{sdpa_both:.4f} ms" if sdpa_both else "refused"))
        if sdpa_bwd is not None:
            pair = inst["flash_bwd_dq"]["ms"] + inst["flash_bwd_dkv"]["ms"]
            print(f"  {label}: K2 + K3 {pair:.4f} ms, "
                  f"scaled_dot_product_attention backward {sdpa_bwd:.4f} ms "
                  f"({pair / sdpa_bwd:.3f}x); K2 at "
                  f"{inst['flash_bwd_dq']['bound_share']:.1%} of its bound, "
                  f"K3 at {inst['flash_bwd_dkv']['bound_share']:.1%}")
        del q, k, v, do, got, want, out, lse, dq, delta, dk, dv, work, inst
        gc.collect()
        torch.cuda.empty_cache()


def check_planted_faults(attn, q, k, v, do, lse, delta, scale, got, want,
                         errs) -> None:
    """The checks above must reject a kernel that is wrong in a small part
    of its output. At the main shape, F3_FAULTS, F10_FAULTS and F32_FAULTS
    (causal), this plants into the
    kernel's own result the rows that a tiled kernel with one of these
    faults would give, computed by the plain math with the fault, and
    requires a mismatch above 1 for each. Each fault is one of the kernel's
    own tiles (`attention.TILES`):
      - forward, the last q-block skips one K/V tile in the middle;
      - forward, the last q-block leaves P unnormalised (acc, not acc / l);
      - dQ, the last q-block skips one K/V tile in the middle;
      - delta, the last q-block leaves its rows at 0;
      - dK and dV, the first key block skips one Q/dO tile in the middle;
      - where a block owns a chunk of the output's columns narrower than
        d (the 16-bit bodies above d 256; in float32 the forward above
        256 and the backward pair above 128, at these shapes), each skipped
        tile again, in chunk 0's block alone (O, dQ, dK and dV).
    The last q-block averages the most keys, and the first key block takes
    rows from every q-block, so one tile is the smallest share there."""
    s, d = q.shape[1], q.shape[2]
    delta = delta.float()  # float64 beside float32 inputs (run_plain)
    fwd, dq_t, dkv = (attn.TILES[name, q.dtype][d] for name in attn.KERNELS)
    tol_f, tol_b = TOL[q.dtype, "fwd"], TOL[q.dtype, "bwd"]
    tol_d = TOL[torch.float32, "fwd"]

    def mid(n):  # the tile of n rows that ends at the middle
        return slice(s // 2 - n, s // 2)

    def planted(t, rows, value):
        t = t.clone()
        t[:, rows] = value
        return t

    def planted_cols(t, rows, cols, value):  # the first `cols` columns
        t = t.clone()
        t[:, rows, :cols] = value[..., :cols]
        return t

    def last_rows_forward(rows, drop, normalise):
        sc = torch.matmul(q[:, rows].float(), k.float().transpose(1, 2))
        keep = (torch.arange(s, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[rows][:, None])
        keep[:, drop] = False
        sc = (sc * scale).masked_fill(~keep, float("-inf"))
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        o = torch.matmul(p, v.float())
        return (o / p.sum(dim=-1, keepdim=True) if normalise else o
                ).to(q.dtype)

    # Keys whose k and v are 0 add nothing to dQ (dS * k = 0); queries whose
    # dO and delta are 0 add nothing to dK and dV (dS = 0, P^T dO = 0).
    last_f, last_q = slice(s - fwd.rows, s), slice(s - dq_t.rows, s)
    first_k = slice(0, dkv.rows)
    drop_f, drop_q = mid(fwd.stream), mid(dq_t.stream)
    drop_k = slice(s // 2, s // 2 + dkv.stream)
    dq_drop = attn.flash_bwd_dq_reference(
        q, planted(k, drop_q, 0), planted(v, drop_q, 0), do, lse, delta, True,
        scale)
    dk_drop, dv_drop = attn.flash_bwd_dkv_reference(
        q, k, v, planted(do, drop_k, 0), lse, planted(delta, drop_k, 0), True,
        scale)

    def rows(r):
        return f"{r.start}..{r.stop - 1}"

    faults = [
        ("flash_fwd", f"out: last q-block skips keys {rows(drop_f)}", "out",
         tol_f, planted(got["out"], last_f,
                        last_rows_forward(last_f, drop_f, True))),
        ("flash_fwd", "out: last q-block leaves P unnormalised", "out", tol_f,
         planted(got["out"], last_f,
                 last_rows_forward(last_f, slice(0, 0), False))),
        *([("flash_fwd", f"out: the last q-block's columns 0..{fwd.cols - 1}"
            f" skip keys {rows(drop_f)}", "out", tol_f,
            planted_cols(got["out"], last_f, fwd.cols,
                         last_rows_forward(last_f, drop_f, True)))]
          if 0 < fwd.cols < d else []),
        ("flash_bwd_dq", f"dQ: last q-block skips keys {rows(drop_q)}", "dq",
         tol_b, planted(got["dq"], last_q, dq_drop[:, last_q])),
        ("flash_bwd_dq", f"delta: last q-block's rows {rows(last_q)} left "
         "at 0", "delta", tol_d, planted(got["delta"], last_q, 0)),
        ("flash_bwd_dkv", f"dK: first key block skips queries "
         f"{rows(drop_k)}", "dk", tol_b,
         planted(got["dk"], first_k, dk_drop[:, first_k])),
        ("flash_bwd_dkv", f"dV: first key block skips queries "
         f"{rows(drop_k)}", "dv", tol_b,
         planted(got["dv"], first_k, dv_drop[:, first_k])),
        *([("flash_bwd_dq", f"dQ: the last q-block's columns 0.."
            f"{dq_t.cols - 1} skip keys {rows(drop_q)}", "dq", tol_b,
            planted_cols(got["dq"], last_q, dq_t.cols, dq_drop[:, last_q]))]
          if 0 < dq_t.cols < d else []),
        *([("flash_bwd_dkv", f"d{key[1].upper()}: the first key block's "
            f"columns 0..{dkv.cols - 1} skip queries {rows(drop_k)}", key,
            tol_b,
            planted_cols(got[key], first_k, dkv.cols, drop[:, first_k]))
           for key, drop in (("dk", dk_drop), ("dv", dv_drop))]
          if 0 < dkv.cols < d else []),
    ]
    for name, what, key, tol, bad in faults:
        ratio = mismatch(bad, want[key], tol)
        print(f"  planted fault, {what}: mismatch={ratio:.4f} of its limit "
              f"(sound {name}: {errs[name][0]:.4f}) "
              f"{'rejected' if ratio > 1.0 else 'NOT REJECTED'}")
        if not ratio > 1.0:
            raise AssertionError(f"the check of {name} passes a planted "
                                 f"fault ({what})")


def check_single_pass_tf32(attn, q, k, v, do, causal, scale, got, want,
                           label: str) -> None:
    """The float32 checks must reject kernels that run their products in
    one TF32 pass: the plain math with every operand rounded to TF32
    (`flash_forward_tf32_reference` and `flash_bwd_tf32_reference` with
    passes=1, the backward on the kernel's out and lse, as `run_plain`'s)
    must mismatch the plain versions (run in float64) above 1 of the
    float32 limits, on out and on each of dQ, dK and dV, which the 3xTF32
    kernels pass. Prints beside them how far the plain versions run in
    float32 land from float64 (`run_plain` says why that is not the
    yardstick)."""
    delta = attn.bwd_delta(got["out"], do)
    out, _ = attn.flash_forward_tf32_reference(q, k, v, causal, scale,
                                               passes=1)
    grads = attn.flash_bwd_tf32_reference(q, k, v, do, got["lse"], delta,
                                          causal, scale, passes=1)
    for key, one, kind in (("out", out, "fwd"),
                           *zip(("dq", "dk", "dv"), grads, ("bwd",) * 3)):
        ratio = mismatch(one, want[key], TOL[torch.float32, kind])
        print(f"  planted fault, {key} in one TF32 pass at {label}: "
              f"mismatch={ratio:.4f} of its limit "
              f"{'rejected' if ratio > 1.0 else 'NOT REJECTED'}")
        if not ratio > 1.0:
            raise AssertionError(f"the float32 check passes single-pass "
                                 f"TF32 ({key}) at {label}")
    args = (q, k, v, do, got["lse"], delta, causal, scale)
    plain = dict(zip(("dq", "dk", "dv"), (
        attn.flash_bwd_dq_reference(*args),
        *attn.flash_bwd_dkv_reference(*args))))
    tol = TOL[torch.float32, "bwd"]
    print(f"  the plain versions in float32 against float64 at {label}: "
          + ", ".join(f"{key} {mismatch(t, want[key], tol):.4f}"
                      for key, t in plain.items()) + " of the limit")


def sdpa_kernels(q, k, v, causal, scale, label: str) -> list:
    """The device kernels scaled_dot_product_attention's forward launches
    on these inputs, from a torch.profiler trace: [name, device ms]."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    q4, k4, v4 = (t.view(1, *t.shape) for t in (q, k, v))
    F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, scale=scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                       scale=scale)
        torch.cuda.synchronize()
    names = [[e.key, e.device_time_total / 1e3]
             for e in prof.key_averages()
             if getattr(e, "device_time_total", 0) > 0]
    print(f"  scaled_dot_product_attention forward at {label} runs: "
          + (", ".join(f"{n} ({ms:.4f} ms)" for n, ms in names)
             or "no device time in the trace"))
    return names


def _sdpa_or_none(q, k, v, causal, scale, part: str, label: str):
    """`_sdpa` on one batch of [bh] heads, or None, printed, where
    scaled_dot_product_attention refuses the case."""
    try:
        return _sdpa(q, k, v, causal, scale, part, batch=1)
    except RuntimeError as err:
        print(f"  {label}: scaled_dot_product_attention refuses the {part}"
              f" ({err}); recorded as null")
        return None


def _sdpa(q, k, v, causal, scale, part: str, batch: int = BATCH) -> float:
    """Time torch's fused attention on the same inputs, as [b, h, s, d]:
    `part` is "forward", "backward" (one backward of a recorded forward) or
    "both"."""
    import torch.nn.functional as F

    shape = (batch, -1, q.shape[1], q.shape[2])
    grad = part != "forward"
    q4, k4, v4 = (t.view(shape).detach().requires_grad_(grad)
                  for t in (q, k, v))

    def forward():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)

    if part == "forward":
        return time_ms(forward)
    if part == "both":
        def run():
            q4.grad = k4.grad = v4.grad = None
            forward().backward(torch.ones_like(q4))
        return time_ms(run)
    o = forward()
    g = torch.ones_like(o)

    def run():
        q4.grad = k4.grad = v4.grad = None
        o.backward(g, retain_graph=True)
    return time_ms(run)


def check_model(gpt2) -> None:
    """Phase 3: flash kernels against plain attention in a small GPT-2 on
    the card, float32 (tolerances as for the float32 kernels)."""
    import dataclasses

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=128,
                          n_layer=2, n_head=2, dtype=torch.float32)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(3)).cuda()
    results = []
    for use_flash in (True, False):
        model = gpt2.GPT2(dataclasses.replace(cfg, use_flash=use_flash),
                          device="cuda", seed=0)
        logits = model(ids)
        gpt2.next_token_loss(logits, ids).backward()
        results.append((logits.detach(), [p.grad for p in model.parameters()]))
    (lf, gf), (lr, gr) = results
    err_logits = mismatch(lf, lr, 1e-4)
    err_grads = max(mismatch(a, b, 5e-4) for a, b in zip(gf, gr))
    print(f"  small GPT-2 flash vs plain attention, mismatch of its limit: "
          f"logits {err_logits:.4f} (tol 1e-4), grads {err_grads:.4f} "
          f"(tol 5e-4)")
    if not (err_logits <= 1.0 and err_grads <= 1.0):
        raise AssertionError("GPT-2 with the kernels disagrees with plain "
                             "attention")


def train_loop(config):
    """The user's loop, run in a worker actor: a named training
    configuration built from seed 0 (`profile_train_step.build`: the model,
    AdamW(3e-4, wd 0.1), a fixed random batch), its warm-up steps, then its
    timed ones (`profile_train_step.MODELS`). For MoE, forward hooks keep
    each step's router loss per layer, and in the last step layer 0's slots
    used per expert (a reduction over its dispatch tensor); the last step's
    are reported. The driver cannot see this process's kernel counters or
    memory, so the last report also holds the kernel launches of the run
    (counted from 0 at the loop's start), this process's pid, its
    CUDA_VISIBLE_DEVICES and its peak memory."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.moe import MoE, expert_capacity
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.profile_train_step import MODELS, build
    from ray_tpu_torch.train import session

    device = session.get_device()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_kernel_launches()
    leg = MODELS[config["model"]]
    model, step, flops_per_token, batch = build(config["model"], device)
    routing = {"last_step": False}
    if isinstance(model, MoE):
        def keep(i):
            def hook(module, inputs, out):
                routing[i] = out[1].detach()
                if i == 0 and routing["last_step"]:
                    routing["slots_used"] = out[2].sum(dim=(0, 2))
            return hook
        for i, blk in enumerate(model.layers):
            blk.moe.register_forward_hook(keep(i))
    b, s = batch["input_ids"].shape
    losses = [step(batch) for _ in range(leg.warmup)]
    losses[-1].item()  # waits for the device
    t0 = time.perf_counter()
    losses += [step(batch) for _ in range(leg.steps - 1)]
    routing["last_step"] = True
    losses.append(step(batch))
    losses[-1].item()
    dt = time.perf_counter() - t0
    tokens = b * s * leg.steps
    for i, loss in enumerate(losses):
        session.report({"step": i, "loss": loss.item()})
    final = {
        "step": len(losses), "loss": losses[-1].item(),
        "batch": b, "seq": s,
        "tokens_per_sec": tokens / dt, "ms_per_step": 1e3 * dt / leg.steps,
        "mfu": flops_per_token * tokens / dt / PEAK_FLOPS[torch.bfloat16],
        "n_params": gpt2.count_params(model),
        "launches": attn.kernel_launches(), "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if "slots_used" in routing:
        cfg = model.config
        used = routing["slots_used"]
        final.update(
            router_loss=sum(routing[i] for i in range(cfg.n_layer)).item(),
            capacity=expert_capacity(cfg, b * s),
            layer0_slots_used=used.tolist(),
            layer0_dropped_share=1 - used.sum().item() / (b * s * cfg.top_k))
    session.report(final)


def train_phase(attn, name: str, per_step: dict, card: str,
                mfu_note: str = "") -> dict:
    """`TorchTrainer(train_loop).fit()` on the named configuration, in a
    worker actor granted the card: the run must not fail, the worker must
    be another process that sees card "0", the loss must be finite and
    fall, and each kernel launch `per_step[kernel]` times a step in the
    worker. Returns the final metrics, with the worker's launches and peak
    memory."""
    from ray_tpu_torch.profile_train_step import MODELS
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    # The worker shares the card with this process: hand back the cache.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    driver_launches = attn.kernel_launches()
    result = TorchTrainer(
        train_loop, train_loop_config={"model": name},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit()
    if result.error is not None:
        raise AssertionError(f"{name}: the training run failed") \
            from result.error
    if attn.kernel_launches() != driver_launches:
        raise AssertionError(f"{name}: this process launched kernels "
                             "while the worker trained")
    m = dict(result.metrics, card=card)
    launches, peak_gib = m["launches"], m["peak_gib"]
    print(f"worker pid {m['pid']} (this process {os.getpid()}), "
          f"CUDA_VISIBLE_DEVICES={m['cuda_visible_devices']!r}")
    if m["pid"] == os.getpid() or m["cuda_visible_devices"] != "0":
        raise AssertionError(f"{name}: the loop did not run in a worker "
                             "granted card 0")
    losses = [r["loss"] for r in result.metrics_history[:-1]]
    print("losses: " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"batch {m['batch']}, seq {m['seq']}: tokens/s "
          f"{m['tokens_per_sec']:.1f}, ms/step {m['ms_per_step']:.3f}, MFU "
          f"{m['mfu']:.4f} (989 TFLOP/s bf16 dense{mfu_note}), peak memory "
          f"{peak_gib:.2f} GiB, params {m['n_params']}, card {card}")
    n_steps = MODELS[name].warmup + MODELS[name].steps
    print(f"launches in {n_steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss not finite and falling: {losses}")
    want = {k: per_step[k] * n_steps for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: expected {per_step} launches a step, "
                             f"got {launches} in {n_steps} steps")
    m["losses"] = losses
    gc.collect()
    torch.cuda.empty_cache()
    return m


def in_driver_steps(name: str) -> float:
    """Phase 4's yardstick: the named configuration's warm-up and timed
    steps in this process (`profile_train_step.build` and its step, no
    trainer, no actor), timed as `train_loop` times them. Returns
    tokens/s."""
    from ray_tpu_torch.profile_train_step import MODELS, build

    leg = MODELS[name]
    model, step, _, batch = build(name, torch.device("cuda"))
    b, s = batch["input_ids"].shape
    losses = [step(batch) for _ in range(leg.warmup)]
    losses[-1].item()
    t0 = time.perf_counter()
    losses = [step(batch) for _ in range(leg.steps)]
    losses[-1].item()
    dt = time.perf_counter() - t0
    del model, step, batch, losses
    gc.collect()
    torch.cuda.empty_cache()
    return b * s * leg.steps / dt


# Phase 4e: a Tune sweep of GPT-2-small trials, one at a time on the card.
# Two trials (four, with 3e-4 and 1e-3, before phase 7c came: the
# script's time); the second stops at ASHA's first rung.
TUNE_LRS = [1e-4, 3e-3]
TUNE_MAX_T, TUNE_GRACE, TUNE_ETA = 6, 2, 2   # ASHA's max_t, grace, factor


def tune_loop(config):
    """Phase 4e's loop, run in each trial's worker actor: phase 4's
    GPT-2-small (`profile_train_step.build`, seed 0, its fixed batch)
    under AdamW at the trial's learning rate, reporting after every step
    its loss, the time, the kernel launches since the loop started
    (counted in this worker), this process's pid and CUDA_VISIBLE_DEVICES,
    and the wall-clock times at which the loop started and the model was
    built. It appends its pid to `pid_file` first, and trains until Tune
    stops the trial."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.profile_train_step import build
    from ray_tpu_torch.train import session

    loop_start = time.time()
    with open(config["pid_file"], "a") as f:
        f.write(f"{os.getpid()}\n")
    device = session.get_device()
    attn.reset_kernel_launches()
    model, _, _, batch = build("gpt2", device)
    step = gpt2.make_train_step(model, gpt2.adamw(model, lr=config["lr"]))
    built = time.time()
    b, s = batch["input_ids"].shape
    while True:
        loss = step(batch).item()  # waits for the device
        session.report({
            "loss": loss, "t": time.perf_counter(), "wall": time.time(),
            "tokens": b * s, "launches": attn.kernel_launches(),
            "pid": os.getpid(), "loop_start": loop_start, "built": built,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")})


def tune_trainable(inner, pid_file: str):
    """`inner` (a TorchTrainer's trainable), run only once every worker an
    earlier trial started has exited: checked in the trial actor before
    the trainer asks for its worker, so before the card is granted to it.
    Each check, with the wall-clock time it was made, is appended to
    `pid_file`.checks."""
    def trainable(config):
        from ray_tpu_torch.train.worker_group import process_exited

        earlier = []
        if os.path.exists(pid_file):
            with open(pid_file) as f:
                earlier = [int(x) for x in f.read().split()]
        alive = [pid for pid in earlier if not process_exited(pid)]
        with open(pid_file + ".checks", "a") as f:
            f.write(json.dumps({"lr": config["lr"], "earlier": earlier,
                                "alive": alive, "wall": time.time()})
                    + "\n")
        if alive:
            raise AssertionError(f"earlier trials' workers {alive} still "
                                 "alive when this trial asks for the card")
        return inner(config)

    trainable.__name__ = "GPT2Trial"
    return trainable


def asha_stops(histories) -> list:
    """The step at which ASHA's rung rule stops each trial, for trials run
    one after another with these losses (one per step): at each rung
    (TUNE_GRACE, TUNE_GRACE * TUNE_ETA, ... below TUNE_MAX_T) a trial's
    loss joins the losses recorded there, and once the rung holds
    TUNE_ETA or more the trial stops unless its loss is within the best
    1/TUNE_ETA of them; every trial stops at TUNE_MAX_T."""
    rungs, r = [], TUNE_GRACE
    while r < TUNE_MAX_T:
        rungs.append(r)
        r *= TUNE_ETA
    recorded = {r: [] for r in rungs}
    stops = []
    for losses in histories:
        stop = TUNE_MAX_T
        for r in rungs:
            if len(losses) < r:
                break
            recorded[r].append(losses[r - 1])
            ranked = sorted(recorded[r])
            if len(ranked) >= TUNE_ETA and losses[r - 1] > \
                    ranked[max(1, int(len(ranked) / TUNE_ETA)) - 1]:
                stop = r
                break
        stops.append(stop)
    return stops


def tune_phase(attn, per_step: dict, card: str, workdir: str) -> dict:
    """Phase 4e: `tune.Tuner` over `TorchTrainer(tune_loop).as_trainable()`
    on GPT-2-small, a grid of TUNE_LRS, ASHA, one trial at a time, each
    trial's worker granted the card. Every trial must end TERMINATED with
    no error, stopped where ASHA's rung rule puts it for the losses the
    trials reported (`asha_stops`); each worker must be another process
    seeing card "0" that launches each kernel `per_step[kernel]` times a
    step, and must have exited before the next trial asks for the card;
    the best trial's loss must be finite and fall; and after the sweep a
    `num_gpus=1` task must be granted the card within 60 s. Returns the
    sweep's record, with the launches of every reported step."""
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    driver_launches = attn.kernel_launches()
    pid_file = os.path.join(workdir, "tune_worker_pids")
    trainer = TorchTrainer(
        tune_loop, train_loop_config={"pid_file": pid_file},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="gpt2_trial", storage_path=workdir))
    t0 = time.perf_counter()
    results = tune.Tuner(
        tune_trainable(trainer.as_trainable(), pid_file),
        param_space={"lr": tune.grid_search(TUNE_LRS)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(
                max_t=TUNE_MAX_T, grace_period=TUNE_GRACE,
                reduction_factor=TUNE_ETA)),
        run_config=RunConfig(name="gpt2_sweep", storage_path=workdir)).fit()
    wall_s = time.perf_counter() - t0
    if attn.kernel_launches() != driver_launches:
        raise AssertionError("this process launched kernels during the "
                             "sweep")
    with open(pid_file + ".checks") as f:
        checks = [json.loads(line) for line in f]
    trials = sorted(results, key=lambda r: r.start_time)
    launches = collections.Counter()
    out = []
    for r, check in zip(trials, checks):
        hist = r.metrics_history
        losses = [m["loss"] for m in hist]
        last = hist[-1] if hist else {}
        timed = hist[2:]
        tps = (sum(m["tokens"] for m in timed)
               / (timed[-1]["t"] - hist[1]["t"]) if timed else None)
        rec = {"lr": r.config["lr"], "status": r.status, "error": r.error,
               "start_time": r.start_time, "runtime_s": r.runtime_s,
               "steps": len(hist), "losses": losses,
               "tokens_per_sec_after_2": tps, "pid": last.get("pid"),
               "cuda_visible_devices": last.get("cuda_visible_devices"),
               "launches": last.get("launches")}
        if hist:
            # Where the trial's time went, by wall clock: the trial actor's
            # start, the worker's (spawn, imports, the trainer's setup),
            # the model's build, the first step, the rest.
            rec["split_s"] = {
                "trial_actor": check["wall"] - r.start_time,
                "worker_start": hist[0]["loop_start"] - check["wall"],
                "build": hist[0]["built"] - hist[0]["loop_start"],
                "first_step": hist[0]["wall"] - hist[0]["built"],
                "later_steps": hist[-1]["wall"] - hist[0]["wall"]}
        out.append(rec)
        print(f"  trial lr {rec['lr']:g}: started {rec['start_time']:.3f}, "
              f"runtime {rec['runtime_s']:.2f} s, {rec['steps']} steps, "
              f"last loss {losses[-1] if losses else float('nan'):.4f}, "
              "tokens/s after step 2 "
              + (f"{tps:.1f}" if tps else "n/a (stopped at step 2)")
              + f", worker pid {rec['pid']} CUDA_VISIBLE_DEVICES="
              f"{rec['cuda_visible_devices']!r}, status {rec['status']}; "
              "s: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                rec.get("split_s", {}).items()))
        if r.status != "TERMINATED" or r.error is not None:
            raise AssertionError(f"trial lr {rec['lr']}: {r.status}, "
                                 f"{r.error}")
        if rec["pid"] == os.getpid() or rec["cuda_visible_devices"] != "0":
            raise AssertionError(f"trial lr {rec['lr']}: not trained in a "
                                 "worker granted card 0")
        for i, m in enumerate(hist, 1):
            want = {k: per_step[k] * i for k in m["launches"]}
            if m["launches"] != want:
                raise AssertionError(
                    f"trial lr {rec['lr']}: {m['launches']} launches after "
                    f"{i} steps, expected {per_step} a step")
        launches.update(rec["launches"])
    want_stops = asha_stops([rec["losses"] for rec in out])
    print(f"  steps run {[rec['steps'] for rec in out]}, ASHA's rung rule "
          f"on the reported losses {want_stops}")
    if [rec["steps"] for rec in out] != want_stops:
        raise AssertionError("the trials' stops disagree with ASHA's rule")
    print(f"  earlier workers at each trial's request for the card: "
          f"{[(c['earlier'], c['alive']) for c in checks]}")
    # Trial i's check must have seen the workers of trials 0..i-1, all
    # gone.
    if [c["earlier"] for c in checks] != \
            [[rec["pid"] for rec in out[:i]] for i in range(len(out))] or \
            any(c["alive"] for c in checks):
        raise AssertionError(f"a trial asked for the card while an earlier "
                             f"worker was alive: {checks}")
    best = results.get_best_result()
    best_losses = [m["loss"] for m in best.metrics_history]
    print(f"  best config {best.config}, loss {best_losses[-1]:.4f} "
          f"(first {best_losses[0]:.4f})")
    if not all(math.isfinite(x) for x in best_losses) or \
            not best_losses[-1] < best_losses[0]:
        raise AssertionError(f"best trial's loss not finite and falling: "
                             f"{best_losses}")
    trial_s = sum(rec["runtime_s"] for rec in out)
    print(f"  sweep wall time {wall_s:.2f} s, sum of the trials' runtimes "
          f"{trial_s:.2f} s")

    def visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    t0 = time.perf_counter()
    grant = ray_tpu_torch.get(
        ray_tpu_torch.remote(num_gpus=1)(visible).remote(), timeout=60)
    grant_s = time.perf_counter() - t0
    print(f"  a num_gpus=1 task after the sweep: CUDA_VISIBLE_DEVICES="
          f"{grant!r} in {grant_s:.2f} s; launches {dict(launches)}, card "
          f"{card}")
    if grant != "0":
        raise AssertionError(f"the card was not granted after the sweep: "
                             f"{grant!r}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"trials": out, "best_config": best.config, "wall_s": wall_s,
            "trials_runtime_s": trial_s, "regrant_s": grant_s,
            "launches": dict(launches), "card": card}


# Phase 4f: a submitted job. Its working_dir holds JOB_SCRIPT, its pip
# environment one wheel made here (a wheel is a zip: nothing is fetched).
JOB_STEPS = 4          # the job that trains to its end
JOB_STOP_STEPS = 200   # the job stopped after its first step
JOB_PKG, JOB_PKG_VALUE = "rtjobpkg", 4242
JOB_SCRIPT = '''\
"""Phase 4f's job: GPT-2-small through TorchTrainer.fit in one worker
granted the card, for argv[1] steps. Prints a JOBDRIVER line at its start,
a JOBSTEP line for each report as it comes and a JOBRESULT line at its
end. It touches no card itself."""
import json
import os
import sys
import time
import traceback

import rtjobpkg  # from the job's pip environment

from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

print("JOBDRIVER " + json.dumps({"pid": os.getpid(), "start": time.time(),
                                 "pip": rtjobpkg.VALUE}), flush=True)


def loop(config):
    import os
    import time

    import rtjobpkg
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.profile_train_step import build
    from ray_tpu_torch.train import session

    loop_start = time.time()
    device = session.get_device()
    attn.reset_kernel_launches()
    _, step, _, batch = build("gpt2", device)
    built = time.time()
    for i in range(config["steps"]):
        loss = step(batch).item()  # waits for the device
        session.report({
            "step": i, "loss": loss, "wall": time.time(),
            "launches": attn.kernel_launches(), "pid": os.getpid(),
            "loop_start": loop_start, "built": built,
            "pip": rtjobpkg.VALUE, "tag": os.environ.get("JOB_TAG"),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")})


def on_report(metrics):
    print("JOBSTEP " + json.dumps(metrics), flush=True)


result = TorchTrainer(
    loop, train_loop_config={"steps": int(sys.argv[1])},
    scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
    run_config=RunConfig(name="gpt2_job",
                         storage_path=os.environ["JOB_STORAGE"],
                         callbacks=[on_report])).fit()
torch = sys.modules.get("torch")
print("JOBRESULT " + json.dumps({
    "error": None if result.error is None else "".join(
        traceback.format_exception(result.error)),
    "losses": [m["loss"] for m in result.metrics_history],
    "torch_imported": torch is not None,
    "cuda_initialized": torch is not None and torch.cuda.is_initialized(),
    "end": time.time()}), flush=True)
sys.exit(0 if result.error is None else 1)
'''


def make_wheel(wheelhouse: str, name: str, value: int) -> str:
    """A pure-Python wheel of one package, `name.VALUE = value`."""
    import zipfile

    os.makedirs(wheelhouse, exist_ok=True)
    whl = os.path.join(wheelhouse, f"{name}-1.0-py3-none-any.whl")
    dist = f"{name}-1.0.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", f"VALUE = {value}\n")
        zf.writestr(f"{dist}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\nVersion: 1.0\n")
        zf.writestr(f"{dist}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: chip_smoke\n"
                    "Root-Is-Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{dist}/RECORD", "")
    return whl


def job_lines(logs: str, tag: str) -> list:
    """The JSON objects of a job's `tag` lines."""
    return [json.loads(line[len(tag) + 1:]) for line in logs.splitlines()
            if line.startswith(tag + " ")]


def follow_job(client, sid: str, submitted: float, stop_after_step=False):
    """Follow a job with `tail_job_logs` to its end: the statuses seen
    (the first read just after the submit, then one after each chunk of
    logs), each chunk's arrival and the status after it, and the time
    `stop_job` was called where `stop_after_step` asks to stop it once
    its first step's loss is in its logs."""
    from ray_tpu_torch.job_submission import JobStatus

    seen = [(client.get_job_status(sid), time.time())]
    chunks, logs, stopped_at = [], "", None
    for chunk in client.tail_job_logs(sid, poll_s=0.05):
        logs += chunk
        status = client.get_job_status(sid)
        now = time.time()
        chunks.append({"at": now - submitted, "status": status,
                       "steps": chunk.count("JOBSTEP ")})
        if status != seen[-1][0]:
            seen.append((status, now))
        if stop_after_step and stopped_at is None and "JOBSTEP " in logs:
            stopped_at = time.time()
            if not client.stop_job(sid):
                raise AssertionError(f"stop_job({sid}) refused")
    status = client.get_job_status(sid)
    if status != seen[-1][0]:
        seen.append((status, time.time()))
    if status not in JobStatus.TERMINAL:
        raise AssertionError(f"job {sid} followed to {status}")
    return seen, chunks, logs, stopped_at


def jobs_phase(attn, per_step: dict, card: str, workdir: str) -> dict:
    """Phase 4f: a GPT-2-small training script submitted as a job through
    `JobSubmissionClient` to the runtime of phase 1b, with a working_dir, a
    pip environment built offline from a local wheel, env_vars and
    metadata. The first job trains JOB_STEPS steps: its logs must stream
    while it runs, its status go SUBMITTED, RUNNING, SUCCEEDED, its driver
    and worker import the wheel, its losses be finite and fall, its worker
    be another process seeing card "0" that launches each kernel
    `per_step[kernel]` times a step, and its driver open no CUDA context.
    The second is stopped once its first step's loss is in its logs: it
    must end STOPPED, its driver and worker processes exit, and the card
    then be granted to a `num_gpus=1` task. Last, `detect_local_generation`
    must name this card. Returns the record of both jobs."""
    import socket

    import ray_tpu_torch as rt
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient
    from ray_tpu_torch.train.worker_group import wait_exited
    from ray_tpu_torch.util.accelerators import detect_local_generation

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    driver_launches = attn.kernel_launches()
    jobdir = os.path.join(workdir, "job")
    os.makedirs(jobdir)
    with open(os.path.join(jobdir, "gpt2_job.py"), "w") as f:
        f.write(JOB_SCRIPT)
    wheelhouse = os.path.join(workdir, "wheels")
    make_wheel(wheelhouse, JOB_PKG, JOB_PKG_VALUE)
    runtime_env = {"working_dir": jobdir, "pip": [JOB_PKG],
                   "pip_wheelhouse": wheelhouse,
                   "env_vars": {"JOB_TAG": "chip-smoke-4f",
                                "JOB_STORAGE": os.path.join(workdir,
                                                            "results")}}
    client = JobSubmissionClient(rt._global_runtime.gcs.address)
    out = {"card": card}
    host = socket.gethostname()

    # The job that trains to its end.
    submitted = time.time()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} gpt2_job.py {JOB_STEPS}",
        runtime_env=runtime_env, metadata={"phase": "4f", "steps": "4"})
    seen, chunks, logs, _ = follow_job(client, sid, submitted)
    info = client.get_job_info(sid)
    statuses = [s for s, _ in seen]
    driver = job_lines(logs, "JOBDRIVER")
    steps = job_lines(logs, "JOBSTEP")
    result = job_lines(logs, "JOBRESULT")
    print(f"  job {sid}: statuses {statuses}, {len(chunks)} chunks of logs "
          f"(at s after submit / status / steps: "
          + ", ".join(f"{c['at']:.2f} {c['status']} {c['steps']}"
                      for c in chunks) + f"), card {card}")
    if info.status != JobStatus.SUCCEEDED or len(driver) != 1 or \
            len(result) != 1:
        raise AssertionError(f"job {sid} {info.status} ({info.message}): "
                             f"{logs[-3000:]}")
    driver, result = driver[0], result[0]
    if statuses[0] not in (JobStatus.PENDING, JobStatus.SUBMITTED) or \
            statuses[1:] != [JobStatus.RUNNING, JobStatus.SUCCEEDED]:
        raise AssertionError(f"job {sid}: statuses {statuses}")
    if not any(c["steps"] and c["status"] == JobStatus.RUNNING
               for c in chunks):
        raise AssertionError("no step's line reached the logs while the "
                             "job ran: the logs did not stream")
    if info.metadata != {"phase": "4f", "steps": "4"} or \
            not info.runtime_env["working_dir"].startswith("kv://"):
        raise AssertionError(f"job {sid}'s record: {info}")
    losses = [m["loss"] for m in steps]
    worker = steps[-1]
    running_at = next(t for s, t in seen if s == JobStatus.RUNNING)
    split = {"to_running": running_at - submitted,
             "driver_start": driver["start"] - submitted,
             "worker_start": worker["loop_start"] - driver["start"],
             "build": worker["built"] - worker["loop_start"],
             "first_step": steps[0]["wall"] - worker["built"],
             "later_steps": steps[-1]["wall"] - steps[0]["wall"],
             "to_end": info.end_time - submitted}
    print(f"  driver pid {driver['pid']} imported {JOB_PKG}.VALUE "
          f"{driver['pip']}; worker pid {worker['pid']} (this process "
          f"{os.getpid()}) CUDA_VISIBLE_DEVICES="
          f"{worker['cuda_visible_devices']!r}, {JOB_PKG}.VALUE "
          f"{worker['pip']}, JOB_TAG {worker['tag']!r}")
    print("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    print("  s after submit: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in split.items())
          + f"; card {card}")
    print(f"  the driver: torch imported {result['torch_imported']}, CUDA "
          f"initialised {result['cuda_initialized']}")
    if driver["pip"] != JOB_PKG_VALUE or worker["pip"] != JOB_PKG_VALUE or \
            worker["tag"] != "chip-smoke-4f":
        raise AssertionError("the job's environment did not reach its "
                             "driver and worker")
    if worker["pid"] in (os.getpid(), driver["pid"]) or \
            worker["cuda_visible_devices"] != "0":
        raise AssertionError("the job did not train in a worker granted "
                             "card 0")
    if result["cuda_initialized"] or result["error"] is not None:
        raise AssertionError(f"the job's driver: {result}")
    if len(losses) != JOB_STEPS or result["losses"] != losses or \
            not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"the job's losses not finite and falling: "
                             f"{losses}")
    for i, m in enumerate(steps, 1):
        if m["launches"] != {k: per_step[k] * i for k in m["launches"]}:
            raise AssertionError(f"the job's worker launched {m['launches']}"
                                 f" in {i} steps, expected {per_step} a "
                                 "step")
    launches = collections.Counter(worker["launches"])
    out["trained"] = {"submission_id": sid, "statuses": statuses,
                      "chunks": chunks, "losses": losses, "split_s": split,
                      "driver_pid": driver["pid"],
                      "worker_pid": worker["pid"],
                      "driver_torch_imported": result["torch_imported"],
                      "driver_cuda_initialized": result["cuda_initialized"],
                      "launches": worker["launches"]}

    # The job stopped after its first step.
    submitted = time.time()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} gpt2_job.py {JOB_STOP_STEPS}",
        runtime_env=runtime_env, metadata={"phase": "4f", "steps": "stop"})
    seen, chunks, logs, stopped_at = follow_job(client, sid, submitted,
                                                stop_after_step=True)
    statuses = [s for s, _ in seen]
    driver = job_lines(logs, "JOBDRIVER")
    steps = job_lines(logs, "JOBSTEP")
    if statuses[-1] != JobStatus.STOPPED or JobStatus.RUNNING not in \
            statuses or stopped_at is None or not driver or not steps:
        raise AssertionError(f"job {sid}: statuses {statuses}: "
                             f"{logs[-3000:]}")
    pids = {"driver": driver[0]["pid"], "worker": steps[-1]["pid"]}
    alive = wait_exited([{"pid": p, "hostname": host}
                         for p in pids.values()], timeout=60)
    exited_s = time.time() - stopped_at
    if alive:
        raise AssertionError(f"{alive} of the stopped job's processes "
                             f"{pids} alive 60 s after the stop")

    def visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    t0 = time.time()
    grant = rt.get(rt.remote(num_gpus=1)(visible).remote(), timeout=60)
    regrant_s = time.time() - stopped_at
    print(f"  job {sid}: statuses {statuses}, {len(steps)} steps before the "
          f"stop (losses {[round(m['loss'], 4) for m in steps]}); driver "
          f"{pids['driver']} and worker {pids['worker']} gone "
          f"{exited_s:.2f} s after stop_job; a num_gpus=1 task then got "
          f"CUDA_VISIBLE_DEVICES={grant!r} in {time.time() - t0:.2f} s, "
          f"{regrant_s:.2f} s after stop_job; card {card}")
    if grant != "0":
        raise AssertionError(f"the card was not granted after the stop: "
                             f"{grant!r}")
    for i, m in enumerate(steps, 1):
        if m["launches"] != {k: per_step[k] * i for k in m["launches"]}:
            raise AssertionError(f"the stopped job's worker launched "
                                 f"{m['launches']} in {i} steps")
    launches.update(steps[-1]["launches"])
    out["stopped"] = {"submission_id": sid, "statuses": statuses,
                      "steps_before_stop": len(steps),
                      "to_running_s": next(t for s, t in seen
                                           if s == JobStatus.RUNNING)
                      - submitted,
                      "stop_to_exit_s": exited_s,
                      "stop_to_regrant_s": regrant_s, "pids": pids}
    client.close()
    if attn.kernel_launches() != driver_launches:
        raise AssertionError("this process launched kernels while the jobs "
                             "trained")

    smi_name = card.split(",")[0].strip()
    generation = detect_local_generation()
    print(f"  detect_local_generation() {generation!r}; nvidia-smi's card "
          f"{smi_name!r}")
    if generation != "h100":
        raise AssertionError(f"detect_local_generation() gave {generation!r}"
                             f" for {smi_name!r}")
    out.update(generation=generation, launches=dict(launches))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 4g: the mesh and sequence parallelism. The card holds one rank, and
# NCCL takes no two ranks on one device, so the card runs what one rank
# can: (a) an sp 1 mesh over a one-rank NCCL group; (b) the work of every
# rank of an sp 4 ring, stepped in lockstep in this process at full width,
# each rank handed the chunk it would receive; (c) the trainer's mesh at sp
# 1. The ring's exchange at sp > 1 is held on the CPU, in gloo processes
# (tests/test_torch_ring_attention.py).
RING_SP = 4
# (label, bh, seq, d), bf16, causal: GPT-2-small at phase 8's long-context
# shape (batch 4 x 12 heads) and Llama-7B's attention (32 heads, d 128).
RING_SHAPES = (("gpt2_small_long", 4 * 12, 8192, 64),
               ("llama7b", 32, 8192, 128))
# The ring is held element by element against flash_attention over the
# whole sequence (`mismatch`, the bf16 kernels' own limit), and against the
# plain versions over the whole sequence in float64 (the backward ones from
# the ring's out and lse, as `run_plain` holds the kernels). Each chunk is
# one kernel call whose bf16 result (O, or a dQ, dK or dV contribution)
# the ring adds in float32, so a ring result carries up to RING_SP
# roundings where one pass carries one. Against float64 it is held to the
# sum of its chunks' own limits: tol * sum over chunks of (typical + |part|),
# part being the chunk's float64 contribution (`ring_plain`); at sp 1 that
# is the kernels' limit. Its mismatch against a single pass's limit is
# printed beside it.
RING_TOL = TOL[torch.bfloat16, "fwd"]
RING_PLAIN_HEADS = 8          # the float64 plain version, heads at a time
MESH_STEPS = 5                # (c): Llama-small, 2 + 3 steps a leg
MESH_LOSS_RTOL = 1e-3


def ring_lockstep(ring, q, k, v, do, sp: int, causal: bool, scale: float):
    """Phase 4g (b): the `sp` ranks of a ring stepped in lockstep in this
    process: at step i rank `my` folds chunk (my - i) mod sp, the one it
    would receive there, into its state (`ring_forward_step`), and in the
    backward adds to that chunk's traveling dK/dV in the order the ring
    does (`ring_backward_step`). q, k, v, do: whole [bh, seq, d]. Returns
    (out, lse, dq, dk, dv), whole, in the inputs' type (lse float32)."""
    c = q.shape[1] // sp
    qs, ks, vs, dos = ([x.contiguous() for x in t.split(c, dim=1)]
                       for t in (q, k, v, do))
    states = [None] * sp
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            states[my] = ring.ring_forward_step(
                states[my], qs[my], ks[src], vs[src], my * c, src * c,
                causal, scale)
    outs = [st[0].to(q.dtype) for st in states]
    grads = [[torch.zeros(qs[0].shape, dtype=torch.float32, device=q.device)
              for _ in range(sp)] for _ in range(3)]
    dq, dk, dv = grads
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            dq_c, dk[src], dv[src] = ring.ring_backward_step(
                dk[src], dv[src], qs[my], ks[src], vs[src], dos[my],
                outs[my], states[my][1], my * c, src * c, causal, scale)
            if dq_c is not None:
                dq[my] += dq_c
    return (torch.cat(outs, dim=1), torch.cat([st[1] for st in states], 1),
            *(torch.cat(g, dim=1).to(q.dtype) for g in grads))


def busiest_rank_ms(ring, q, k, v, do, out, lse, sp: int, scale: float):
    """Phase 4g (b): the kernel time of the ring's busiest rank (the last:
    its own chunk causal, every other one whole), forward steps and
    backward steps, on the shards it holds; no exchange runs on one card.
    Returns (forward ms, backward ms)."""
    c = q.shape[1] // sp
    my = sp - 1
    qs, ks, vs, dos, outs = ([x.contiguous() for x in t.split(c, dim=1)]
                             for t in (q, k, v, do, out))
    lse_my = lse[:, my * c:].contiguous()
    acc = [torch.zeros(qs[0].shape, dtype=torch.float32, device=q.device)
           for _ in range(2 * sp + 1)]

    def fwd():
        state = None
        for i in range(sp):
            src = (my - i) % sp
            state = ring.ring_forward_step(state, qs[my], ks[src], vs[src],
                                           my * c, src * c, True, scale)
        return state

    def bwd():
        for i in range(sp):
            src = (my - i) % sp
            dq_c, _, _ = ring.ring_backward_step(
                acc[2 * src], acc[2 * src + 1], qs[my], ks[src], vs[src],
                dos[my], outs[my], lse_my, my * c, src * c, True, scale)
            acc[-1] += dq_c

    return time_ms(fwd, reps=5, rounds=3), time_ms(bwd, reps=5, rounds=3)


def ring_plain(attn, q, k, v, do, out, lse, sp: int, scale: float):
    """The plain attention over the whole sequence in float64, causal, as
    the sum of the ring's chunk contributions, and each output's limit
    scale (held at <= RING_TOL * it): the sum over the chunks of each
    contribution's `mismatch` scale, typical (its row rms, at least a
    tenth of its rms) + |contribution|. The forward's contributions use
    the float64 lse, the backward's the ring's `out` and `lse` (delta from
    that O). Returns (want, limit, float64 lse), whole [bh, seq, ...]."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    lse64 = torch.empty(lse.shape, dtype=torch.float64, device=q.device)
    lse_r = lse.double()
    delta = attn.bwd_delta(out.double(), dod)
    c = q.shape[1] // sp
    want = {key: torch.zeros_like(qd) for key in ("out", "dq", "dk", "dv")}
    limit = {key: torch.zeros_like(qd) for key in want}

    def add(key, rows, part):
        typical = torch.maximum(part.square().mean(dim=-1, keepdim=True).sqrt(),
                                part.square().mean().sqrt() / 10)
        want[key][:, rows] += part
        limit[key][:, rows] += typical + part.abs()

    mask = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    for my in range(sp):
        mine = slice(my * c, (my + 1) * c)
        s_all = qd[:, mine] @ kd[:, :(my + 1) * c].transpose(1, 2) * scale
        s_all[:, :, my * c:] = s_all[:, :, my * c:].masked_fill(
            ~mask, attn._NEG_INF)
        lse64[:, mine] = torch.logsumexp(s_all, dim=-1)
        for src in range(my + 1):
            theirs = slice(src * c, (src + 1) * c)
            s = s_all[:, :, theirs]
            add("out", mine, torch.exp(s - lse64[:, mine, None])
                @ vd[:, theirs])
            p = torch.exp(s - lse_r[:, mine, None])
            ds = p * (dod[:, mine] @ vd[:, theirs].transpose(1, 2)
                      - delta[:, mine, None]) * scale
            add("dq", mine, ds @ kd[:, theirs])
            add("dk", theirs, ds.transpose(1, 2) @ qd[:, mine])
            add("dv", theirs, p.transpose(1, 2) @ dod[:, mine])
            del s, p, ds
        del s_all
    return want, limit, lse64


def ring_shape(attn, ring, label: str, bh: int, seq: int, d: int) -> dict:
    """Phase 4g (b) at one shape: the sp 4 schedule in lockstep against
    flash_attention over the whole sequence and the plain versions over
    it in float64 (RING_PLAIN_HEADS heads at a time), each error beside its
    limit; its launches against the schedule's; the busiest rank's time
    beside flash_attention's over the whole sequence."""
    gen = torch.Generator(device="cuda").manual_seed(400)
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    torch.cuda.synchronize()
    attn.reset_kernel_launches()
    got = dict(zip(("out", "lse", "dq", "dk", "dv"),
                   ring_lockstep(ring, q, k, v, do, RING_SP, True, scale)))
    torch.cuda.synchronize()
    launches = attn.kernel_launches()
    want = RING_SP * (RING_SP + 1) // 2
    print(f"  {label} (bh {bh}, seq {seq}, d {d}, bf16, causal, sp "
          f"{RING_SP}, chunks of {seq // RING_SP}): launches {launches}, "
          f"the schedule's {want} each (the causal chunk of each rank and "
          "every earlier one)")
    if launches != dict.fromkeys(attn.KERNELS, want):
        raise AssertionError(f"{label}: the ring launched {launches}, not "
                             f"{want} of each kernel")
    flash = run_kernels(attn, q, k, v, do, True, scale)
    errs = {}
    for key in ("out", "dq", "dk", "dv"):
        errs[key] = {"vs_flash": mismatch(got[key], flash[key], RING_TOL),
                     "abs_vs_flash": max_err(got[key], flash[key])}
    plain = collections.defaultdict(list)
    for c in range(0, bh, RING_PLAIN_HEADS):
        h = slice(c, c + RING_PLAIN_HEADS)
        want, limit, lse = ring_plain(attn, q[h], k[h], v[h], do[h],
                                      got["out"][h], got["lse"][h], RING_SP,
                                      scale)
        for key in ("out", "dq", "dk", "dv"):
            g, w = got[key][h].double(), want[key]
            plain[key].append((
                ((g - w).abs() / (RING_TOL * limit[key])).max().item(),
                mismatch(got[key][h], w, RING_TOL), max_err(g, w)))
        plain["lse"].append(max_err(got["lse"][h], lse))
        del want, limit, lse
    for key in ("out", "dq", "dk", "dv"):
        rs = plain[key]
        errs[key].update(vs_float64=worst([r[0] for r in rs]),
                         vs_float64_one_pass=worst([r[1] for r in rs]),
                         abs_vs_float64=max(r[2] for r in rs))
        e = errs[key]
        ok = all(math.isfinite(x) and x <= 1.0
                 for x in (e["vs_flash"], e["vs_float64"]))
        print(f"    {key:3s}: against flash_attention {e['vs_flash']:.4f} "
              f"of its limit (max_abs_err {e['abs_vs_flash']:.3e}); against "
              f"the plain version in float64 {e['vs_float64']:.4f} of the "
              f"chunks' summed limits, {e['vs_float64_one_pass']:.4f} of a "
              f"single pass's (max_abs_err {e['abs_vs_float64']:.3e}); tol "
              f"{RING_TOL:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the ring's {key} is past its "
                                 "limit")
    lse_err = max(plain["lse"])
    print(f"    lse: max_abs_err {lse_err:.3e} against float64")
    if not lse_err < 1e-3:
        raise AssertionError(f"{label}: the ring's lse is off by {lse_err}")
    fwd_ms, bwd_ms = busiest_rank_ms(ring, q, k, v, do, got["out"],
                                     got["lse"], RING_SP, scale)
    flash_fwd = time_ms(lambda: attn._flash_forward(q, k, v, True, scale),
                        reps=5, rounds=3)
    flash_bwd = time_ms(lambda: attn._flash_backward(
        q, k, v, flash["out"], flash["lse"], do, True, scale), reps=5,
        rounds=3)
    print(f"    the busiest rank ({RING_SP - 1}): forward steps "
          f"{fwd_ms:.4f} ms, backward steps {bwd_ms:.4f} ms; "
          f"flash_attention over the whole sequence: forward "
          f"{flash_fwd:.4f} ms, backward {flash_bwd:.4f} ms (ratio "
          f"{(fwd_ms + bwd_ms) / (flash_fwd + flash_bwd):.4f}; the rank's "
          f"share of the causal work is {(2 * RING_SP - 1) / RING_SP ** 2:.4f})")
    del q, k, v, do, got, flash
    torch.cuda.empty_cache()
    return {"bh": bh, "seq": seq, "d": d, "errors": errs,
            "lse_abs_err": lse_err, "launches": launches,
            "busiest_rank_fwd_ms": fwd_ms, "busiest_rank_bwd_ms": bwd_ms,
            "flash_fwd_ms": flash_fwd, "flash_bwd_ms": flash_bwd}


def mesh_train_loop(config):
    """Phase 4g (c)'s loop, in a worker granted the card: Llama-small
    (phase 10's model and batch, seed 0) with `sp_mesh=session.get_mesh()`
    for MESH_STEPS steps, then the same steps from the same seed without a
    mesh. Reports both legs' losses and launches, the mesh's type and axes,
    the group's backend, this process's pid and CUDA_VISIBLE_DEVICES."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.profile_train_step import MODELS
    from ray_tpu_torch.train import session

    mesh = session.get_mesh()
    device = session.get_device()
    leg = MODELS["llama-small"]
    out = {"mesh_type": mesh.device_type,
           "mesh_axes": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": dist.get_backend(), "pid": os.getpid(),
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    for name, sp_mesh in (("mesh", mesh), ("no_mesh", None)):
        cfg = dataclasses.replace(llama.LlamaConfig.small(), sp_mesh=sp_mesh)
        model = llama.Llama(cfg, device=device, seed=0)
        step = gpt2.make_train_step(model, gpt2.adamw(model))
        ids = torch.randint(0, cfg.vocab_size, (leg.batch, leg.seq),
                            generator=torch.Generator().manual_seed(0)
                            ).to(device)
        attn.reset_kernel_launches()
        losses = [step({"input_ids": ids, "labels": ids})
                  for _ in range(MESH_STEPS)]
        out[name] = {"losses": [x.item() for x in losses],
                     "launches": attn.kernel_launches()}
        del model, step, losses
        gc.collect()
        torch.cuda.empty_cache()
    session.report(out)


def mesh_phase(attn, card: str) -> dict:
    """Phase 4g: (a) a one-rank NCCL group and an sp 1 DeviceMesh on the
    card, over which an all-reduce runs, and `ring_attention_sharded` on
    it, and the ring of that one rank, bit-equal to flash_attention at
    GPT-2-small's attention shape, forward and backward; (b) the sp 4 ring
    schedule at RING_SHAPES (`ring_shape`); (c) `TorchTrainer.fit` with
    `ScalingConfig(mesh=MeshSpec({"sp": 1}))`: Llama-small trains through
    the mesh in a worker granted the card, its losses within
    MESH_LOSS_RTOL of the same steps without a mesh, K1, K2 and K3 12
    times a step. Returns the phase's record, with the launches of its
    paths (the ring calls of (a), the schedules of (b), the mesh leg of
    (c)); the comparisons' launches are not counted."""
    import importlib
    import socket

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        distributed as tdist)
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    # The module, which `ray_tpu_torch.ops` shadows with its function.
    ring = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    rec = {"card": card}
    launches = collections.Counter()

    # (a) The mesh on the card.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = tdist.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       device="cuda")
    try:
        mesh = build_mesh(MeshSpec({"sp": 1}))
        t = torch.arange(8.0, device="cuda")
        dist.all_reduce(t, group=mesh.get_group("sp"))
        torch.cuda.synchronize()
        if mesh.device_type != "cuda" or ctx.backend != "nccl" or \
                not torch.equal(t, torch.arange(8.0, device="cuda")):
            raise AssertionError(f"the mesh: {mesh}, backend {ctx.backend}")
        print(f"  (a) {mesh} over a one-rank {ctx.backend} group; an "
              "all-reduce over its sp group ran")
        gen = torch.Generator(device="cuda").manual_seed(401)
        q, k, v, w = (torch.randn(BATCH, 12, 1024, 64, generator=gen,
                                  device="cuda", dtype=torch.bfloat16)
                      for _ in range(4))

        def run(fn):
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*x)
            out.backward(w)
            return [out.detach()] + [t.grad for t in x]

        want = run(lambda *x: attn.flash_attention(*x, True))
        equal = {}
        for name, fn in (
                ("ring_attention_sharded",
                 lambda *x: ring.ring_attention_sharded(*x, mesh)),
                ("ring_of_one",
                 lambda *x: ring.ring_attention(
                     *x, group=mesh.get_group("sp")))):
            attn.reset_kernel_launches()
            got = run(fn)
            torch.cuda.synchronize()
            launches.update(attn.kernel_launches())
            equal[name] = all(torch.equal(g, t) for g, t in zip(got, want))
        print(f"  (a) sp 1 at [{BATCH}, 12, 1024, 64] bf16, causal, bit-equal "
              f"to flash_attention (out, dq, dk, dv): {equal}")
        if not all(equal.values()):
            raise AssertionError("sp 1 differs from flash_attention")
        rec["sp1"] = {"bit_equal": equal, "mesh": str(mesh),
                      "backend": ctx.backend}
        del q, k, v, w, want, got
    finally:
        tdist.shutdown_distributed()
    torch.cuda.empty_cache()

    # (b) The sp 4 ring schedule at full width, on the kernels.
    rec["ring"] = {}
    for label, bh, seq, d in RING_SHAPES:
        r = rec["ring"][label] = ring_shape(attn, ring, label, bh, seq, d)
        launches.update(r["launches"])

    # (c) The trainer's mesh.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    driver_launches = attn.kernel_launches()
    result = TorchTrainer(
        mesh_train_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     mesh=MeshSpec({"sp": 1}))).fit()
    if result.error is not None:
        raise AssertionError("4g: the training run with a mesh failed") \
            from result.error
    if attn.kernel_launches() != driver_launches:
        raise AssertionError("4g: this process launched kernels while the "
                             "worker trained")
    m = result.metrics
    n = llama.LlamaConfig.small().n_layer * MESH_STEPS
    got, base = m["mesh"]["losses"], m["no_mesh"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, base))
    print(f"  (c) worker pid {m['pid']} (this process {os.getpid()}), "
          f"CUDA_VISIBLE_DEVICES={m['cuda_visible_devices']!r}, get_mesh(): "
          f"{m['mesh_type']} {m['mesh_axes']}, group {m['backend']}")
    print("  (c) Llama-small with sp_mesh, losses: "
          + ", ".join(f"{x:.6f}" for x in got))
    print("  (c) the same steps without a mesh:   "
          + ", ".join(f"{x:.6f}" for x in base))
    print(f"  (c) largest relative difference {rel:.3e} (limit "
          f"{MESH_LOSS_RTOL:.0e}); bit-equal: {got == base}; launches "
          f"{m['mesh']['launches']} with the mesh, "
          f"{m['no_mesh']['launches']} without")
    if m["pid"] == os.getpid() or m["cuda_visible_devices"] != "0" or \
            m["mesh_type"] != "cuda" or m["mesh_axes"] != {"sp": 1} or \
            m["backend"] != "nccl":
        raise AssertionError(f"4g: the worker's mesh or card: {m}")
    if not all(math.isfinite(x) for x in got) or not got[-1] < got[0] or \
            not rel <= MESH_LOSS_RTOL:
        raise AssertionError(f"4g: losses {got} against {base}")
    for leg in ("mesh", "no_mesh"):
        if m[leg]["launches"] != dict.fromkeys(attn.KERNELS, n):
            raise AssertionError(f"4g: {leg} launched {m[leg]['launches']}"
                                 f", not {n} of each")
    launches.update(m["mesh"]["launches"])
    rec["trainer"] = {"losses": got, "no_mesh_losses": base,
                      "max_rel_diff": rel, "bit_equal": got == base,
                      "mesh": m["mesh_axes"], "backend": m["backend"],
                      "launches": m["mesh"]["launches"]}
    rec["launches"] = {name: launches[name] for name in attn.KERNELS}
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# Phase 4h: pipeline parallelism. (a) `LocalPipelineTrainer` steps every
# stage of Llama-small in this process, one thread and one CUDA stream a
# stage; (b) `make_pipeline_train_fn` in a one-worker gang granted the card,
# its per-step stage checkpoints restored at pp 2; (c) GPipe over a one-rank
# NCCL group. NCCL at pp > 1 needs more than one card: GPipe's and
# `CollectivePipeTransport`'s exchanges at pp > 1 run in gloo processes on
# the CPU (tests/test_torch_pipeline.py, test_torch_train_pipeline.py).
PIPE_M, PIPE_STEPS, PIPE_LR = 4, 2, 1e-2   # 3 steps before phase 4k
PIPE_BATCH, PIPE_SEQ = 8, 2048           # phase 10's shape
PIPE_RUNS = ((1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (2, "sequential"))
# Eager PyTorch fuses nothing across a stage boundary and the kernels are
# deterministic, so every pp and schedule must give pp 1's bits.
PIPE_GANG_STEPS = 2
# (c): GPT-2-small's width and depth in the JAX package's functional
# blocks (float32, plain attention), batch 8, seq 1024, 4 microbatches.
GPIPE = dict(vocab=50304, d_model=768, n_layer=12, n_head=12, d_ff=3072,
             seq=1024, batch=8, m=4)
# (c)'s limit on the whole batch's logits against the microbatches' (the
# reference's own tests/test_pipeline.py limit); float32 sums over k of up
# to 3072 terms in another order.
GPIPE_ATOL = 1e-4


def pipe_launches_per_step(cfg, pp: int) -> dict:
    """K1 runs twice in every stage but the last (its forward, then the
    recompute in its backward): m * (2 * n_layer - L_last); K2 and K3 once
    a layer a microbatch."""
    from ray_tpu_torch.models.llama import stage_layer_ranges

    a, b = stage_layer_ranges(cfg, pp)[-1]
    return {"flash_fwd": PIPE_M * (2 * cfg.n_layer - (b - a)),
            "flash_bwd_dq": PIPE_M * cfg.n_layer,
            "flash_bwd_dkv": PIPE_M * cfg.n_layer}


def pipeline_run(attn, pipe, cfg, pp: int, schedule: str,
                 snapshot_step: int = -1) -> dict:
    """Phase 4h (a): PIPE_STEPS Adam steps of `LocalPipelineTrainer` at
    `pp`, launches counted a step. Returns the losses, launches, ms a step,
    the last step's stage stats and makespan, peak memory, the merged
    params (on the card) and, after step `snapshot_step`, the merged params
    and Adam state on the host."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = pipe.LocalPipelineTrainer(
        cfg, pp=pp, num_microbatches=PIPE_M, lr=PIPE_LR, seed=0,
        schedule=schedule, batch=PIPE_BATCH, seq=PIPE_SEQ, device="cuda")
    out = {"pp": pp, "schedule": schedule, "losses": [], "launches": [],
           "ms": []}
    for step in range(PIPE_STEPS):
        ids, tg = pipe.seeded_batch(0, step, PIPE_BATCH, PIPE_SEQ,
                                    cfg.vocab_size)
        torch.cuda.synchronize()
        attn.reset_kernel_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(ids, tg)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(attn.kernel_launches())
        out["losses"].append(m["loss"])
        if step == snapshot_step:
            out["snapshot"] = {
                "params": {k: v.cpu() for k, v in
                           trainer.merged_params().items()},
                # Copies: Adam's step counts lie on the host already, and
                # the next step raises them in place.
                "opt": {k: {n: t.to("cpu", copy=True) for n, t in v.items()}
                        for k, v in trainer.merged_adam_state().items()}}
    res = trainer.last_result
    out["stages"] = [st.as_dict() for st in res.stage_stats]
    out["makespan_ms"] = res.makespan_s * 1e3
    out["bubble_frac"] = res.bubble_frac
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["params"] = {k: v.clone() for k, v in trainer.merged_params().items()}
    del trainer, res
    return out


def _tensors_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        _tensors_equal(a[k], b[k]) if isinstance(a[k], dict)
        else torch.equal(a[k].to(b[k].device), b[k]) for k in a)


def pipeline_gang_loop(config):
    """Phase 4h (b)'s loop, in a worker granted the card: the pipeline
    gang's own loop (`make_pipeline_train_fn(**config)`), then one report
    of its kernel launches, this process's pid, CUDA_VISIBLE_DEVICES and
    peak memory."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train import pipeline as pipe
    from ray_tpu_torch.train import session

    attn.reset_kernel_launches()
    pipe.make_pipeline_train_fn(**config)(config)
    session.report({"launches": attn.kernel_launches(), "pid": os.getpid(),
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def pipeline_phase(attn, card: str, workdir: str) -> dict:
    """Phase 4h: (a) Llama-small through `LocalPipelineTrainer` at pp 1,
    2, 4 ("1f1b") and 2 ("sequential"), each against pp 1; (b) the pipeline
    gang (`make_pipeline_train_fn`) at pp 1 in a worker granted the card,
    its losses against (a)'s and its step checkpoint restored at pp 1 and
    pp 2; (c) GPipe over a pp 1 mesh against `sequential_forward`. Returns
    the phase's record, with the launches of (a)'s runs and (b)'s
    worker."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import pipeline as pipe

    cfg = llama.LlamaConfig.small()
    rec = {"card": card, "runs": {}}
    launches = collections.Counter()

    # (a) The stage trainer.
    base = None
    for pp, schedule in PIPE_RUNS:
        r = pipeline_run(attn, pipe, cfg, pp, schedule,
                         snapshot_step=PIPE_GANG_STEPS - 1 if pp == 1 else -1)
        label = f"pp{pp}_{schedule}"
        want = pipe_launches_per_step(cfg, pp)
        if any(step != want for step in r["launches"]):
            raise AssertionError(f"4h {label}: launches {r['launches']}, "
                                 f"not {want} a step")
        if base is None:
            base, snapshot = r, r.pop("snapshot")
        bit_equal = (r["losses"] == base["losses"] and
                     _tensors_equal(r["params"], base["params"]))
        steady = statistics.mean(r["ms"][1:])
        print(f"  (a) {label}: losses "
              + ", ".join(f"{x:.6f}" for x in r["losses"])
              + f"; bit-equal to pp 1 (losses and merged weights): "
              f"{bit_equal}; ms a step "
              f"{', '.join(f'{x:.1f}' for x in r['ms'])} (steady "
              f"{steady:.2f}); peak {r['peak_gib']:.2f} GiB; "
              f"launches a step {r['launches'][-1]}")
        for st in r["stages"]:
            print(f"      stage {st['stage']}: busy {st['busy_s'] * 1e3:.2f} "
                  f"ms of {st['wall_s'] * 1e3:.2f}, bubble_frac "
                  f"{st['bubble_frac']:.4f} (analytic "
                  f"{st['analytic_bubble_frac']:.4f})")
        if not all(math.isfinite(x) for x in r["losses"]) or not bit_equal:
            raise AssertionError(f"4h {label}: losses {r['losses']} against "
                                 f"pp 1's {base['losses']}, bit-equal "
                                 f"(losses and merged weights) {bit_equal}")
        for step in r["launches"]:
            launches.update(step)
        rec["runs"][label] = {
            "losses": r["losses"], "bit_equal": bit_equal, "ms": r["ms"], "steady_ms": steady,
            "makespan_ms": r["makespan_ms"], "bubble_frac": r["bubble_frac"],
            "stages": r["stages"], "peak_gib": r["peak_gib"],
            "launches_per_step": r["launches"][-1]}
        if r is not base:
            del r["params"]
        gc.collect()
        torch.cuda.empty_cache()
    del base["params"]
    runs = rec["runs"]
    rec["makespan_ratio_1f1b_over_sequential_pp2"] = \
        runs["pp2_1f1b"]["makespan_ms"] / runs["pp2_sequential"]["makespan_ms"]
    print(f"  (a) pp 2 makespan, 1F1B / sequential: "
          f"{rec['makespan_ratio_1f1b_over_sequential_pp2']:.4f}")

    # (b) The pipeline gang, one worker granted the card.
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    from ray_tpu_torch.train.checkpoint import sharded_manifest
    from ray_tpu_torch.train.config import ScalingConfig

    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg) if f.name != "sp_mesh"}
    config = dict(steps=PIPE_GANG_STEPS, microbatches=PIPE_M,
                  batch=PIPE_BATCH, seq=PIPE_SEQ, lr=PIPE_LR, seed=0,
                  ckpt_dir=workdir, cfg_overrides=overrides)
    driver_launches = attn.kernel_launches()
    t0 = time.perf_counter()
    ex = BackendExecutor(BackendConfig(),
                         ScalingConfig(num_workers=1, use_gpu=True))
    ex.start()
    pid = ex.worker_group.procs[0]["pid"]
    metrics = []
    try:
        for rnd in ex.run(pipeline_gang_loop, config, device="cuda",
                          experiment_name="chip_smoke_pipeline"):
            metrics += [r["metrics"] for r in rnd]
        final = ex.latest_checkpoint.to_dict()
    finally:
        ex.shutdown()
    worker = metrics.pop()
    gang_s = time.perf_counter() - t0
    exit_s = wait_exited(pid, "the pipeline gang's worker")
    if attn.kernel_launches() != driver_launches:
        raise AssertionError("4h: this process launched kernels while the "
                             "gang trained")
    losses = [m["loss"] for m in metrics]
    want = {k: v * PIPE_GANG_STEPS
            for k, v in pipe_launches_per_step(cfg, 1).items()}
    print(f"  (b) gang worker pid {pid} (this process {os.getpid()}, "
          f"CUDA_VISIBLE_DEVICES={worker['cuda_visible_devices']!r}): "
          f"launches {worker['launches']} (want {want}), peak "
          f"{worker['peak_gib']:.2f} GiB")
    if worker["pid"] != pid or pid == os.getpid() or \
            worker["cuda_visible_devices"] != "0" or \
            worker["launches"] != want:
        raise AssertionError(f"4h (b): the gang's worker {worker}")
    print(f"  (b) gang worker pid {pid} (this process {os.getpid()}): "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}, (a)'s pp 1 "
          f"{', '.join(f'{x:.6f}' for x in runs['pp1_1f1b']['losses'][:2])}"
          f"; {gang_s:.1f} s from start to shutdown, exited "
          f"{exit_s:.2f} s after")
    if losses != runs["pp1_1f1b"]["losses"][:PIPE_GANG_STEPS] or \
            final["step"] != PIPE_GANG_STEPS - 1:
        raise AssertionError(f"4h (b): the gang's losses {losses} or its "
                             f"last checkpoint {final}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(final["path"], f))
                     for f in os.listdir(final["path"]))
    n_params = sum(math.prod(e["shape"]) for k, e in
                   sharded_manifest(final["path"])["entries"].items()
                   if k.startswith("params/"))
    t0 = time.perf_counter()
    whole = pipe.restore_pipeline_stage(final["path"], cfg, 0, 1,
                                        device="cuda")
    equal = {"pp1_params": _tensors_equal(snapshot["params"],
                                          whole["params"]),
             "pp1_adam": _tensors_equal(snapshot["opt"], whole["opt"])}
    want = llama.split_stage_params(whole["params"], cfg, 2)
    want_opt = llama.split_stage_params(whole["opt"], cfg, 2)
    for s in range(2):
        st = pipe.restore_pipeline_stage(final["path"], cfg, s, 2,
                                         device="cuda")
        equal[f"pp2_stage{s}_params"] = _tensors_equal(st["params"], want[s])
        equal[f"pp2_stage{s}_adam"] = _tensors_equal(st["opt"], want_opt[s])
        del st
    restore_s = time.perf_counter() - t0
    print(f"  (b) step {final['step']}'s checkpoint: {n_params} parameters, "
          f"{ckpt_bytes / 2 ** 30:.3f} GiB on disk; restored at pp 1 and "
          f"at pp 2 (each stage) in {restore_s:.2f} s, bit-equal: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"4h (b): a restore differs: {equal}")
    launches.update(worker["launches"])
    rec["gang"] = {"losses": losses, "pid": pid, "seconds": gang_s,
                   "peak_gib": worker["peak_gib"],
                   "exit_s": exit_s, "checkpoint_gib": ckpt_bytes / 2 ** 30,
                   "n_params": n_params, "restore_s": restore_s,
                   "bit_equal": equal}
    del whole, want, want_opt, snapshot
    gc.collect()
    torch.cuda.empty_cache()

    # (c) GPipe over a pp 1 mesh.
    rec["gpipe"] = gpipe_leg(attn)
    rec["launches"] = {name: launches[name] for name in attn.KERNELS}
    return rec


def gpipe_trunk(gp, mesh, params, ids):
    """(c)'s trunk: `gpipe`'s output on the microbatched embeddings, and the
    same layers applied to each microbatch in order, without the pipe."""
    g = GPIPE
    x = params["embed"][ids] + params["pos"][None, :ids.shape[1]]
    x_mb = gp.to_microbatches(x, g["m"])
    run = gp.gpipe(functools.partial(gp.block_apply, n_head=g["n_head"]),
                   mesh, g["m"])
    layers = gp.unstack_stage_params(params["stages"])
    want = []
    for h in x_mb:
        for i in range(g["n_layer"]):
            h = gp.block_apply({k: v[i] for k, v in layers.items()}, h,
                               g["n_head"])
        want.append(h)
    return run(params["stages"], x_mb), torch.stack(want)


def gpipe_leg(attn) -> dict:
    """Phase 4h (c): `make_pp_train_step` at GPIPE's shape over a pp 1
    mesh of a one-rank NCCL group. Its trunk (`gpipe`) must equal the layer
    stack applied to each microbatch bit for bit, and its forward
    `sequential_forward` over the whole batch within GPIPE_ATOL (cuBLAS's
    float32 products pick, for the whole batch's row count, an algorithm
    that splits the sum over k through its workspace, and for a
    microbatch's another). Two Adam steps must give finite, falling
    losses. The blocks use plain attention: no kernel of the port
    launches."""
    import socket

    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        distributed as tdist)
    from ray_tpu_torch.parallel import pipeline as gp

    g = GPIPE
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tdist.initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = build_mesh(MeshSpec({"pp": 1}))
        params = gp.init_pp_lm(0, g["vocab"], g["d_model"], g["n_layer"],
                               g["n_head"], g["d_ff"], g["seq"], 1,
                               device="cuda")
        ids = torch.randint(0, g["vocab"], (g["batch"], g["seq"]),
                            generator=torch.Generator().manual_seed(0)).cuda()
        step, forward = gp.make_pp_train_step(
            mesh, g["n_head"], g["m"],
            functools.partial(torch.optim.Adam, lr=1e-3))
        attn.reset_kernel_launches()
        with torch.no_grad():
            got, want = gpipe_trunk(gp, mesh, params, ids)
            mb_equal = torch.equal(got, want)
            del got, want
            whole_diff = (forward(params, ids) - gp.sequential_forward(
                params, ids, g["n_head"])).abs().max().item()
        state, losses, ms = None, [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state,
                                       {"input_ids": ids, "labels": ids})
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        launched = attn.kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, state
    finally:
        tdist.shutdown_distributed()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (c) GPipe, pp 1 mesh, {g}: the trunk bit-equal to the "
          f"layers applied microbatch by microbatch: {mb_equal}; the forward "
          f"against sequential_forward over "
          f"the whole batch max diff {whole_diff:.3e} (limit {GPIPE_ATOL:.0e})")
    print(f"  (c) losses {', '.join(f'{x:.6f}' for x in losses)}; ms a step "
          f"{', '.join(f'{x:.1f}' for x in ms)}; peak {peak:.2f} GiB; "
          f"launches {launched}")
    if not mb_equal or not whole_diff <= GPIPE_ATOL or \
            not all(math.isfinite(x) for x in losses) or \
            not losses[1] < losses[0] or any(launched.values()):
        raise AssertionError(f"4h (c): microbatch bit-equal {mb_equal}, "
                             f"whole-batch diff {whole_diff}, losses "
                             f"{losses}, launches {launched}")
    return {"trunk_bit_equal_per_microbatch": mb_equal,
            "whole_batch_max_abs_diff": whole_diff,
            "losses": losses, "ms": ms,
            "peak_gib": peak, "shape": g}


# Phase 4i: tensor, data and fully-sharded parallelism on the mesh. (a)
# GPT-2-small through `TorchTrainer` on a (dp 1, fsdp 1, tp 1) mesh over a
# one-rank NCCL group: size-1 axes kept, so DTensor parameters, FSDP2 and
# the vocab-parallel head and loss all run; (b) the same model at dp 1 x tp
# 2 as two processes sharing the card over a gloo group this script forms
# itself (NCCL takes no two ranks on one device), then Llama-small's tp 2
# step against its tp 1 step. NCCL at tp > 1 needs more than one card.
TP_STEPS = 5                  # (a): 2 warm-up + 3 timed steps a leg
TP_TIMED = 3                  # (a): the last steps, timed
TP_RANK_TIMED = 1             # (b): steps timed after the checked one
                              # (3 before phase 4j came: the script's time)
TP_LLAMA_BATCH = 4            # (b)'s Llama-small: batch 4, seq 2048
# A bf16 model split over tp rounds its row products' partial sums to bf16
# before the all-reduce: the loss is held within two bf16 ulps (2^-7
# relative) of the unsplit model's. AdamW's first step moves each element
# by lr * g / (|g| + eps), about lr whatever g's size, so two runs whose
# gradients differ in rounding agree where the signs agree and differ by
# up to 2 lr where a gradient within that rounding of zero flips: every
# element within 2 lr (+ 1e-6), and at least TP_ALIKE of them moved alike
# (within lr / 10).
TP_LOSS_RTOL = 2.0 ** -7
TP_ALIKE = 0.9
TP_LR = 3e-4


def tp_train_loop(config):
    """Phase 4i (a)'s loop, in a worker granted the card: GPT-2-small
    (phase 4's model, optimizer and batch, seed 0) placed on
    `session.get_mesh()` (`GPT2(mesh=, state=init_sharded(...))`,
    `make_train_step(mesh=)`) for TP_STEPS steps, its parameters after the
    first step saved whole for (b). Reports the losses, launches, ms a
    step and peak memory, the mesh, the group's backend, this process's
    pid and CUDA_VISIBLE_DEVICES."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.parallel.sharding import shard_batch
    from ray_tpu_torch.parallel.tensor_parallel import full_state
    from ray_tpu_torch.profile_train_step import MODELS
    from ray_tpu_torch.train import session

    mesh = session.get_mesh()
    device = session.get_device()
    cfg, leg = gpt2.GPT2Config.small(), MODELS["gpt2"]
    ids = torch.randint(0, cfg.vocab_size, (leg.batch, leg.seq),
                        generator=torch.Generator().manual_seed(0)
                        ).to(device)
    out = {"mesh_type": mesh.device_type,
           "mesh_axes": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": dist.get_backend(), "pid": os.getpid(),
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    torch.cuda.reset_peak_memory_stats()
    model = gpt2.GPT2(cfg, mesh=mesh,
                      state=gpt2.init_sharded(cfg, mesh, seed=0))
    step = gpt2.make_train_step(model, gpt2.adamw(model, TP_LR), mesh=mesh)
    batch = shard_batch({"input_ids": ids, "labels": ids}, mesh)
    out["dtensor"] = type(model.wte).__name__
    out["fsdp"] = type(model).__name__
    attn.reset_kernel_launches()
    losses = [step(batch)]
    torch.save({k: v.cpu() for k, v in full_state(model).items()},
               config["first_step"])
    losses += [step(batch) for _ in range(TP_STEPS - TP_TIMED - 1)]
    losses[-1].item()
    t0 = time.perf_counter()
    losses += [step(batch) for _ in range(TP_TIMED)]
    losses[-1].item()
    dt = time.perf_counter() - t0
    out.update(losses=[x.item() for x in losses],
               launches=attn.kernel_launches(),
               ms_per_step=1e3 * dt / TP_TIMED,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    session.report(out)


def _param_limits(model, want: dict, lr: float) -> dict:
    """Element by element, every parameter of `model` (this rank's shard
    of each, against the same slice of the whole tensor in `want`) within
    2 lr (+ 1e-6), and at least TP_ALIKE of the elements within lr / 10
    (moved alike).
    Each rank holds its own shards: no collective."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    worst, alike, total = 0.0, 0, 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape, offset = compute_local_shape_and_global_offset(
                p.shape, p.device_mesh, p.placements)
            w = want[name][tuple(slice(o, o + n)
                                 for o, n in zip(offset, shape))]
            d = (p.to_local().float() - w.to(p.device).float()).abs()
            worst = max(worst, d.max().item())
            alike += (d <= lr / 10).sum().item()
            total += d.numel()
    return {"max_abs_diff": worst, "limit": 2 * lr + 1e-6,
            "moved_alike_share": alike / total,
            "ok": worst <= 2 * lr + 1e-6 and alike / total >= TP_ALIKE}


def tp_rank(rank: int, port: int, first_step: str, result_queue) -> None:
    """Phase 4i (b): one of two tp ranks sharing card 0, over a gloo group
    on CUDA tensors. GPT-2-small at dp 1 x tp 2 takes one AdamW step on
    (a)'s batch (K1 at bh 24 x 6 = 144), held against (a)'s first step,
    then TP_RANK_TIMED more, timed; the c_attn exchange is timed alone;
    then Llama-small (12/4 heads, 6/2 a rank) takes one step at tp 2, held
    against the same step at tp 1. Parameters are held shard by shard
    (no gather: DTensor's `full_tensor()` does not return over gloo on CUDA
    tensors). Puts (rank, error, record)."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    t_start = time.perf_counter()

    def say(what: str) -> None:
        print(f"  (b) tp rank {rank}: {what} "
              f"({time.perf_counter() - t_start:.1f} s)", flush=True)

    try:
        import torch.distributed as dist

        from ray_tpu_torch.models import gpt2, llama
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.parallel import MeshSpec, build_mesh
        from ray_tpu_torch.parallel.sharding import shard_batch
        from ray_tpu_torch.profile_train_step import MODELS

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2)
        mesh = build_mesh(MeshSpec({"dp": 1, "tp": 2}))
        rec = {"mesh": str(mesh), "backend": dist.get_backend()}
        say(f"{mesh} over {dist.get_backend()}")
        shapes = collections.Counter()
        flash = gpt2.flash_attention

        def counted(q, k, v, causal):
            shapes[q.shape[0] * q.shape[1]] += 1
            return flash(q, k, v, causal)

        gpt2.flash_attention = counted
        cfg, leg = gpt2.GPT2Config.small(), MODELS["gpt2"]
        ids = torch.randint(0, cfg.vocab_size, (leg.batch, leg.seq),
                            generator=torch.Generator().manual_seed(0)
                            ).cuda()
        model = gpt2.GPT2(cfg, mesh=mesh, seed=0)
        step = gpt2.make_train_step(model, gpt2.adamw(model, TP_LR),
                                    mesh=mesh)
        batch = shard_batch({"input_ids": ids, "labels": ids}, mesh)
        torch.cuda.reset_peak_memory_stats()
        attn.reset_kernel_launches()
        rec["loss"] = step(batch).item()
        rec["launches"] = attn.kernel_launches()
        say(f"GPT-2-small's step, loss {rec['loss']:.6f}")
        rec["k1_bh"] = dict(shapes)
        want = torch.load(first_step)
        rec["params"] = _param_limits(model, want, TP_LR)
        del want
        say("parameters held against (a)'s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_RANK_TIMED):
            loss = step(batch)
        loss.item()
        rec["ms_per_step"] = (1e3 * (time.perf_counter() - t0)
                              / TP_RANK_TIMED)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"{TP_RANK_TIMED} steps timed")
        # The c_attn exchange of one layer alone, forward (gather) and
        # backward (reduce-scatter), weight and bias: n_layer of them a step.
        ctx, c_attn = model.mesh_ctx, model.h[0].c_attn
        parts = [t.to_local().detach().to(cfg.dtype).requires_grad_()
                 for t in (c_attn.weight, c_attn.bias)]

        def exchange():
            for t in parts:
                g = ctx.gather_rows(t)
                g.backward(torch.ones_like(g))
                t.grad = None

        rec["exchange_ms_per_step"] = cfg.n_layer * time_ms(
            exchange, reps=3, rounds=3)
        del model, step, batch
        gc.collect()
        torch.cuda.empty_cache()

        lcfg = llama.LlamaConfig.small()
        lids = torch.randint(0, lcfg.vocab_size, (TP_LLAMA_BATCH, 2048),
                             generator=torch.Generator().manual_seed(0)
                             ).cuda()
        lbatch = {"input_ids": lids, "labels": lids}
        lmodel = llama.Llama(lcfg, mesh=mesh, seed=0)
        rec["llama_heads"] = lmodel.layers[0].wq.weight.to_local().shape[0] \
            // lcfg.head_dim
        lstep = gpt2.make_train_step(lmodel, gpt2.adamw(lmodel, TP_LR),
                                     mesh=mesh)
        attn.reset_kernel_launches()
        rec["llama_loss"] = lstep(shard_batch(lbatch, mesh)).item()
        say(f"Llama-small's step, loss {rec['llama_loss']:.6f}")
        rec["llama_launches"] = attn.kernel_launches()
        del lstep
        # The same step at tp 1, in each rank (from the same seed): each
        # holds its own shards against that model's.
        one = llama.Llama(lcfg, device="cuda", seed=0)
        rec["llama_tp1_loss"] = gpt2.make_train_step(
            one, gpt2.adamw(one, TP_LR))(lbatch).item()
        rec["llama_params"] = _param_limits(
            lmodel, {k: v.detach() for k, v in one.named_parameters()},
            TP_LR)
        say(f"Llama-small at tp 1, loss {rec['llama_tp1_loss']:.6f}")
        del one, lmodel
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        result_queue.put((rank, None, rec))
    except BaseException:  # noqa: BLE001 — the phase fails on it
        result_queue.put((rank, traceback.format_exc(), None))


def tensor_parallel_phase(attn, card: str, workdir: str, plain: dict
                          ) -> dict:
    """Phase 4i: (a) `TorchTrainer.fit` with `ScalingConfig(mesh=MeshSpec(
    {"dp": 1, "fsdp": 1, "tp": 1}))` trains GPT-2-small through the mesh
    step in a worker granted the card: losses within MESH_LOSS_RTOL of the
    same steps without a mesh (phase 4's, `plain`: the same model, seed,
    optimizer and batch), falling, K1-K3 12 times a step; (b) dp 1 x tp 2
    in two processes on the card (`tp_rank`). Returns the phase's record
    with the launches of its paths ((a), both ranks' tp 2 steps); the
    comparisons' launches are not counted."""
    import multiprocessing
    import socket

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    n_layer = gpt2.GPT2Config.small().n_layer
    rec = {"card": card}
    launches = collections.Counter()
    first_step = os.path.join(workdir, "gpt2_first_step.pt")

    # (a) The trainer's mesh at size 1.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    own_launches = attn.kernel_launches()
    axes = {"dp": 1, "fsdp": 1, "tp": 1}
    result = TorchTrainer(
        tp_train_loop, train_loop_config={"first_step": first_step},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     mesh=MeshSpec(axes))).fit()
    if result.error is not None:
        raise AssertionError("4i (a): the training run on the mesh "
                             "failed") from result.error
    if attn.kernel_launches() != own_launches:
        raise AssertionError("4i: this process launched kernels while the "
                             "worker trained")
    m = result.metrics
    got, base = m["losses"], plain["losses"][:TP_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, base))
    print(f"  (a) worker pid {m['pid']} (this process {os.getpid()}), "
          f"CUDA_VISIBLE_DEVICES={m['cuda_visible_devices']!r}, get_mesh(): "
          f"{m['mesh_type']} {m['mesh_axes']}, group {m['backend']}, "
          f"parameters {m['dtensor']}s in an {m['fsdp']}")
    print("  (a) GPT-2-small on the mesh, losses: "
          + ", ".join(f"{x:.6f}" for x in got))
    print("  (a) phase 4's steps (no mesh):      "
          + ", ".join(f"{x:.6f}" for x in base))
    print(f"  (a) on the mesh: {m['ms_per_step']:.3f} ms a step (steps "
          f"{TP_STEPS - TP_TIMED + 1}-{TP_STEPS}), peak {m['peak_gib']:.2f} "
          f"GiB, launches {m['launches']}; phase 4 without a mesh "
          f"{plain['ms_per_step']:.3f} ms a step, peak "
          f"{plain['peak_gib']:.2f} GiB; {card}")
    print(f"  (a) largest relative difference {rel:.3e} (limit "
          f"{MESH_LOSS_RTOL:.0e}); bit-equal: {got == base}")
    if m["pid"] == os.getpid() or m["cuda_visible_devices"] != "0" or \
            m["mesh_type"] != "cuda" or m["mesh_axes"] != axes or \
            m["backend"] != "nccl" or m["dtensor"] != "DTensor" or \
            not m["fsdp"].startswith("FSDP"):
        raise AssertionError(f"4i (a): the worker's mesh or card: {m}")
    if not all(math.isfinite(x) for x in got) or not got[-1] < got[0] or \
            not rel <= MESH_LOSS_RTOL:
        raise AssertionError(f"4i (a): losses {got} against {base}")
    if m["launches"] != dict.fromkeys(attn.KERNELS, n_layer * TP_STEPS):
        raise AssertionError(f"4i (a): launched {m['launches']}")
    launches.update(m["launches"])
    rec["a"] = {"losses": got, "no_mesh_losses": base, "max_rel_diff": rel,
                "bit_equal": got == base, "mesh": m["mesh_axes"],
                "backend": m["backend"], "ms_per_step": m["ms_per_step"],
                "peak_gib": m["peak_gib"],
                "no_mesh_ms_per_step": plain["ms_per_step"]}

    # (b) dp 1 x tp 2: two processes on the card over gloo.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    procs = [mp.Process(target=tp_rank, args=(r, port, first_step, queue))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        outs = {}
        deadline = time.monotonic() + 600
        while len(outs) < len(procs):
            try:
                rank, error, value = queue.get(timeout=5)
            except Exception:  # queue.Empty: is every rank still alive?
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in outs]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"4i (b): tp ranks ended without a "
                                         f"result (rank, exit code): {dead}")
                continue
            if error is not None:
                raise AssertionError(f"4i (b): tp rank {rank} failed:\n"
                                     f"{error}")
            outs[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    first = got[0]
    for r in (0, 1):
        o = outs[r]
        lrel = abs(o["loss"] - first) / abs(first)
        print(f"  (b) tp rank {r}: {o['mesh']} over {o['backend']} on CUDA "
              f"tensors; loss {o['loss']:.6f} against (a)'s first step "
              f"{first:.6f} (relative {lrel:.3e}, limit {TP_LOSS_RTOL:.3e});"
              f" parameters after the step: max |diff| "
              f"{o['params']['max_abs_diff']:.3e} (limit "
              f"{o['params']['limit']:.3e}), moved alike "
              f"{o['params']['moved_alike_share']:.4f}; K1 at bh "
              f"{o['k1_bh']}; launches {o['launches']}")
        print(f"  (b) tp rank {r}: {o['ms_per_step']:.3f} ms a step (2 "
              f"processes sharing the card, gloo through the host), peak "
              f"{o['peak_gib']:.2f} GiB; the c_attn exchange "
              f"{o['exchange_ms_per_step']:.3f} ms a step; {card}")
        if not (lrel <= TP_LOSS_RTOL and o["params"]["ok"]
                and o["k1_bh"] == {BATCH * 6: n_layer}
                and o["launches"] == dict.fromkeys(attn.KERNELS, n_layer)):
            raise AssertionError(f"4i (b): tp rank {r}: {o}")
        if o["llama_heads"] != 6 or o["llama_launches"] != dict.fromkeys(
                attn.KERNELS, llama.LlamaConfig.small().n_layer):
            raise AssertionError(f"4i (b): tp rank {r}'s Llama-small: "
                                 f"heads {o['llama_heads']}, launches "
                                 f"{o['llama_launches']}")
        launches.update(o["launches"])
        launches.update(o["llama_launches"])
        lrel = abs(o["llama_loss"] - o["llama_tp1_loss"]) / abs(
            o["llama_tp1_loss"])
        print(f"  (b) tp rank {r}: Llama-small at tp 2 (6/2 heads a rank), "
              f"batch {TP_LLAMA_BATCH}, seq 2048: loss "
              f"{o['llama_loss']:.6f}, at tp 1 {o['llama_tp1_loss']:.6f} "
              f"(relative {lrel:.3e}, limit {TP_LOSS_RTOL:.3e}); its "
              f"shards max |diff| {o['llama_params']['max_abs_diff']:.3e}, "
              f"moved alike {o['llama_params']['moved_alike_share']:.4f}; "
              f"launches {o['llama_launches']}")
        if not (lrel <= TP_LOSS_RTOL and o["llama_params"]["ok"]):
            raise AssertionError(f"4i (b): tp rank {r}'s Llama-small at tp "
                                 f"2 against tp 1: {o}")
    print(f"  (b) took {wall:.1f} s")
    rec["b"] = {"ranks": outs, "wall_s": wall}
    rec["launches"] = {name: launches[name] for name in attn.KERNELS}
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# Phase 4j: expert parallelism. MoE-small at ep 2 as two processes sharing
# card 0 over a gloo group (each rank 4 of the 8 experts), held against the
# plain one-card step on the same weights and batch. The limits are phase
# 4i (b)'s: the bf16 model's expert sums are closed in another order.
EP_TIMED = 2                  # steps timed after the checked one


def _routing_hooks(model, record: dict):
    """Forward hooks on every layer's experts that, while record["on"],
    keep each layer's routing choices [T, k] (the router's top-k on the
    experts' input, as the layer computes them) and slots used per expert
    (this rank's experts on a mesh) under record[i]."""
    from ray_tpu_torch.parallel.tensor_parallel import local

    def keep(i):
        def hook(module, inputs, out):
            if not record["on"]:
                return
            h = inputs[0]
            logits = h.reshape(-1, h.shape[-1]).float() @ local(
                module.router).float()
            record[i] = {"choices": torch.topk(torch.softmax(logits, -1),
                                               module.cfg.top_k).indices,
                         "slots": out[2].sum(dim=(0, 2)).long()}
        return hook

    for i, blk in enumerate(model.layers):
        blk.moe.register_forward_hook(keep(i))


def _ep_param_limits(got: dict, want: dict, experts, lr: float,
                     ep_rank: int, ep: int) -> dict:
    """`_param_limits` for an ep model of plain tensors, `got` its
    parameters by name: each expert weight (this rank's slice of the
    experts) against the same slice of the whole one in `want`, every other
    parameter whole."""
    worst, alike, total = 0.0, 0, 0
    with torch.no_grad():
        for name, p in got.items():
            w = want[name]
            if name in experts:
                w = w.chunk(ep)[ep_rank]
            d = (p.float() - w.float()).abs()
            worst = max(worst, d.max().item())
            alike += (d <= lr / 10).sum().item()
            total += d.numel()
    return {"max_abs_diff": worst, "limit": 2 * lr + 1e-6,
            "moved_alike_share": alike / total,
            "ok": worst <= 2 * lr + 1e-6 and alike / total >= TP_ALIKE}


def ep_rank(rank: int, port: int, result_queue) -> None:
    """Phase 4j: one of two ep ranks of MoE-small on card 0, over a gloo
    group on CUDA tensors: one checked AdamW step (routing kept), EP_TIMED
    more, timed with their collectives counted; then, one rank at a time,
    the plain one-card step from the same seed and batch, against which
    this rank holds its loss, its parameter shards and its experts' slots
    in layer 0. Puts (rank, error, record)."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    t_start = time.perf_counter()

    def say(what: str) -> None:
        print(f"  ep rank {rank}: {what} "
              f"({time.perf_counter() - t_start:.1f} s)", flush=True)

    try:
        import torch.distributed as dist

        from ray_tpu_torch.models import gpt2, moe
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.parallel import MeshSpec, build_mesh
        from ray_tpu_torch.parallel.sharding import shard_batch
        from ray_tpu_torch.profile_train_step import MODELS

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2)
        mesh = build_mesh(MeshSpec({"ep": 2}))
        rec = {"mesh": str(mesh), "backend": dist.get_backend()}
        cfg, leg = moe.MoEConfig.small(), MODELS["moe-small"]
        ids = torch.randint(0, cfg.vocab_size, (leg.batch, leg.seq),
                            generator=torch.Generator().manual_seed(0)
                            ).cuda()
        batch = {"input_ids": ids, "labels": ids}
        torch.cuda.reset_peak_memory_stats()
        model = moe.MoE(cfg, mesh=mesh, seed=0)
        ctx = model.mesh_ctx
        rec["experts"] = [ctx.ep_rank * model.layers[0].moe.w_gate.shape[0],
                          model.layers[0].moe.w_gate.shape[0]]
        step = moe.make_moe_train_step(model, gpt2.adamw(model, TP_LR),
                                       mesh=mesh)
        routing = {"on": True}
        _routing_hooks(model, routing)
        local_batch = shard_batch(batch, mesh)
        attn.reset_kernel_launches()
        rec["loss"] = step(local_batch).item()
        routing["on"] = False
        say(f"MoE-small's checked step at ep 2, loss {rec['loss']:.6f}")
        after = {k: v.detach().clone() for k, v in model.named_parameters()}
        experts = set(moe.expert_param_names(model))
        exchanges = count_exchanges(dist)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EP_TIMED):
            loss = step(local_batch)
        loss.item()
        rec["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / EP_TIMED
        rec["collectives_per_step"] = {
            k: v / EP_TIMED for k, v in exchanges.items() if k != "host_s"}
        rec["host_ms_in_collectives_per_step"] = \
            1e3 * exchanges["host_s"] / EP_TIMED
        rec["launches"] = attn.kernel_launches()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"{EP_TIMED} steps timed, {rec['ms_per_step']:.1f} ms a step")
        del model, step, loss
        gc.collect()
        torch.cuda.empty_cache()

        # The yardstick, one rank at a time (each holds a whole model).
        for turn in range(2):
            if turn == rank:
                one = moe.MoE(cfg, device="cuda", seed=0)
                plain = {"on": True}
                _routing_hooks(one, plain)
                rec["plain_loss"] = moe.make_moe_train_step(
                    one, gpt2.adamw(one, TP_LR))(batch).item()
                rec["params"] = _ep_param_limits(
                    after, dict(one.named_parameters()), experts, TP_LR,
                    ctx.ep_rank, ctx.ep_size)
                first, n = rec["experts"]
                rec["layer0_slots"] = routing[0]["slots"].tolist()
                rec["plain_layer0_slots"] = \
                    plain[0]["slots"][first:first + n].tolist()
                rec["plain_layer0_kept"] = plain[0]["slots"].sum().item()
                rec["choices_agree"] = [
                    (routing[i]["choices"] == plain[i]["choices"]).sum()
                    .item() for i in range(cfg.n_layer)]
                rec["choices"] = routing[0]["choices"].numel()
                say(f"plain one-card step, loss {rec['plain_loss']:.6f}")
                del one
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        dist.destroy_process_group()
        result_queue.put((rank, None, rec))
    except BaseException:  # noqa: BLE001 — the phase fails on it
        result_queue.put((rank, traceback.format_exc(), None))


def expert_parallel_phase(attn, card: str) -> dict:
    """Phase 4j: MoE-small at ep 2 in two processes on the card
    (`ep_rank`), held against the plain one-card step. Returns the phase's
    record with the launches of its path (both ranks' ep steps); the plain
    steps' launches are not counted."""
    import multiprocessing
    import socket

    from ray_tpu_torch.models import moe

    cfg = moe.MoEConfig.small()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    procs = [mp.Process(target=ep_rank, args=(r, port, queue))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        outs = {}
        deadline = time.monotonic() + 600
        while len(outs) < len(procs):
            try:
                rank, error, value = queue.get(timeout=5)
            except Exception:  # queue.Empty: is every rank still alive?
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in outs]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"4j: ep ranks ended without a "
                                         f"result (rank, exit code): {dead}")
                continue
            if error is not None:
                raise AssertionError(f"4j: ep rank {rank} failed:\n{error}")
            outs[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    launches = collections.Counter()
    want_launches = dict.fromkeys(attn.KERNELS, cfg.n_layer * (1 + EP_TIMED))
    for r in (0, 1):
        o = outs[r]
        lrel = abs(o["loss"] - o["plain_loss"]) / abs(o["plain_loss"])
        first, n = o["experts"]
        print(f"  ep rank {r}: {o['mesh']} over {o['backend']} on CUDA "
              f"tensors, experts {first}-{first + n - 1}; loss "
              f"{o['loss']:.6f} against the plain step's "
              f"{o['plain_loss']:.6f} (relative {lrel:.3e}, limit "
              f"{TP_LOSS_RTOL:.3e}); parameters after the step: max |diff| "
              f"{o['params']['max_abs_diff']:.3e} (limit "
              f"{o['params']['limit']:.3e}), moved alike "
              f"{o['params']['moved_alike_share']:.4f}")
        print(f"  ep rank {r}: layer 0 slots used by its experts "
              f"{o['layer0_slots']} (plain step {o['plain_layer0_slots']}); "
              f"routing choices agreeing with the plain step's by layer "
              f"{o['choices_agree']} of {o['choices']}")
        print(f"  ep rank {r}: {o['ms_per_step']:.3f} ms a step (2 processes "
              f"sharing the card, gloo through the host), collectives a step "
              f"{o['collectives_per_step']}, host ms inside them "
              f"{o['host_ms_in_collectives_per_step']:.3f}, peak "
              f"{o['peak_gib']:.2f} GiB; launches {o['launches']}; {card}")
        if not (lrel <= TP_LOSS_RTOL and o["params"]["ok"]
                and o["layer0_slots"] == o["plain_layer0_slots"]
                and o["launches"] == want_launches):
            raise AssertionError(f"4j: ep rank {r}: {o}")
        launches.update(o["launches"])
    kept = sum(sum(outs[r]["layer0_slots"]) for r in (0, 1))
    choices = outs[0]["choices"]
    print(f"  layer 0: {choices - kept} of {choices} routing choices dropped "
          f"at capacity over both ranks, the plain step "
          f"{choices - outs[0]['plain_layer0_kept']}")
    if kept != outs[0]["plain_layer0_kept"]:
        raise AssertionError(f"4j: layer 0 kept {kept} choices, the plain "
                             f"step {outs[0]['plain_layer0_kept']}")
    print(f"  4j took {wall:.1f} s")
    keep = ("loss", "plain_loss", "params", "layer0_slots",
            "plain_layer0_slots", "choices_agree", "choices", "ms_per_step",
            "collectives_per_step", "host_ms_in_collectives_per_step",
            "peak_gib", "launches", "experts")
    return {"card": card, "ranks": {r: {k: outs[r][k] for k in keep}
                                    for r in (0, 1)},
            "layer0_dropped": choices - kept, "wall_s": wall,
            "launches": {name: launches[name] for name in attn.KERNELS}}


# Phase 4k: the cluster tier. (a) A GPT-2-small gang under chaos: phase
# 4's model and batch (seed 0) under AdamW for CHAOS_STEPS steps in a
# worker granted the card; rank 0 reports a checkpoint of the model's and
# AdamW's state after step CHAOS_CKPT_STEP, and the driver, once it has
# seen that checkpoint, fires a one-event worker_kill schedule (seed
# CHAOS_SEED). The resumed gang's losses must equal the same steps run
# here without a fault (CHAOS_LOSS_RTOL: the same kernels on the same
# state, so bit-equal is expected). (b) An autoscaled GPU node: a head
# from `python -m ray_tpu_torch start --head`, `init(address="auto")`, and
# `StandardAutoscaler` over `GCEGPUNodeProvider` (a3-highgpu-1g) whose fake
# cloud runs each VM's startup script, booting a worker node with the
# card for a `num_gpus=1` task: a bf16 product of AUTOSCALE_N² matrices,
# held against the CPU's float32 product of the same bf16 inputs.
CHAOS_STEPS, CHAOS_CKPT_STEP = 6, 2
CHAOS_SEED = 23
CHAOS_PARK_S = 120.0      # the first attempt's wait at its checkpoint
CHAOS_LOSS_RTOL = 1e-6
CHAOS_DEADLINE_S = 120.0  # the runner's recovery deadline; the watchdog's
AUTOSCALE_N = 4096
AUTOSCALE_IDLE_S = 2.0    # the autoscaler's idle_timeout_s
# The card's bf16 product rounds each element once, to 8 significant
# bits (2^-8 of it at most), after a float32 sum whose order differs
# from the CPU's (~1e-6 of the row's scale): |card - cpu| must stay
# within 2^-8 |cpu| + 1e-3 rms(cpu).
AUTOSCALE_REL, AUTOSCALE_ABS = 2.0 ** -8, 1e-3
CLUSTER_BUDGET_S = 60.0


def chaos_model(device):
    """Phase 4's GPT-2-small (`profile_train_step.build("gpt2")`: seed 0,
    AdamW(3e-4, wd 0.1), its fixed batch) with its optimizer."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.profile_train_step import MODELS

    b, s = MODELS["gpt2"][:2]
    cfg = gpt2.GPT2Config(n_positions=max(s, 1024))
    model = gpt2.GPT2(cfg, device=device, seed=0)
    opt = gpt2.adamw(model)
    ids = torch.randint(0, cfg.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(0)
                        ).to(device)
    return model, opt, gpt2.make_train_step(model, opt), {
        "input_ids": ids, "labels": ids}


def chaos_train_loop(config):
    """Phase 4k (a)'s loop, in the worker granted the card. A run resumed
    from a checkpoint loads the model's and AdamW's state from it and goes
    on at the step after it. Each report holds the step's loss, the time,
    this process's pid and parent pid, CUDA_VISIBLE_DEVICES and the kernel
    launches since the loop started; the report of step CHAOS_CKPT_STEP
    carries the checkpoint (`torch.save` of both states). The first attempt
    then waits for the fault the driver fires on that report, and fails
    if none comes within `park_s`."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train import Checkpoint, session

    entered = time.time()
    device = session.get_device()
    attn.reset_kernel_launches()
    model, opt, step, batch = chaos_model(device)
    built = time.time()
    ckpt = session.get_checkpoint()
    start = 0
    if ckpt is not None:
        state = ckpt.get_state_dict(map_location=device)
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
        del state
    me = {"start": start, "pid": os.getpid(), "ppid": os.getppid(),
          "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
          "entered": entered, "built": built, "restored": time.time()}
    for i in range(start, CHAOS_STEPS):
        loss = step(batch).item()
        stepped, out = time.time(), None
        if i == CHAOS_CKPT_STEP and session.get_world_rank() == 0:
            out = Checkpoint.from_state_dict(
                {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": i},
                path=os.path.join(config["workdir"], f"step_{i}"))
        session.report(dict(me, step=i, loss=loss, stepped=stepped,
                            time=time.time(),
                            launches=attn.kernel_launches()),
                       checkpoint=out)
        if ckpt is None and i == CHAOS_CKPT_STEP:
            time.sleep(config["park_s"])
            raise RuntimeError("phase 4k: no fault came at the checkpoint")


def compute_apps() -> list:
    """(pid, MiB) of each process `nvidia-smi --query-compute-apps` lists.
    In a container the pids may be of another namespace (the chip machine
    lists each as pid 1, `/process_api`): then only the count is ours."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout
    return [tuple(int(x) for x in line.split(","))
            for line in out.splitlines() if line.strip()]


def wait_off_the_card(pid: int, baseline: int,
                      timeout_s: float = 60.0) -> float:
    """Seconds until `pid` has exited (its CUDA context is freed only once
    the process is gone) and nvidia-smi lists no more than `baseline`
    processes, none of them `pid`."""
    t0 = time.perf_counter()
    wait_exited(pid, f"pid {pid}", timeout_s)
    while True:
        apps = compute_apps()
        if len(apps) <= baseline and pid not in [p for p, _ in apps]:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"nvidia-smi lists {apps} {timeout_s} s "
                                 f"after pid {pid} exited (baseline "
                                 f"{baseline} processes)")
        time.sleep(0.1)


def chaos_gang_leg(card: str, workdir: str) -> dict:
    """Phase 4k (a): TorchTrainer.fit of `chaos_train_loop` on an
    in-process `Cluster` (a CPU head and a node with the card), one worker
    granted the card, FailureConfig(max_failures=1), under a HangWatchdog;
    the uninterrupted steps run meanwhile in this process (the worker's
    start takes seconds of host time, not the card's). Returns the numbers
    printed."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.chaos import (ChaosRunner, HangWatchdog,
                                     WorkerKillInjector,
                                     single_event_schedule)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)

    torch.zeros(1, device="cuda")   # this process's context, then its count
    baseline = compute_apps()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, num_gpus=1)
    cluster.wait_for_nodes()
    cluster.connect()
    try:
        injector = WorkerKillInjector(cluster, actors_only=True)
        runner = ChaosRunner(
            cluster, single_event_schedule(CHAOS_SEED, "worker_kill",
                                           at_s=0.01),
            {"worker_kill": injector}, recovery_deadline_s=CHAOS_DEADLINE_S,
            poll_s=0.02)
        clock = time.time() - time.monotonic()   # monotonic -> wall

        listed, seen = {}, {}

        def on_report(metrics):
            if metrics["step"] == CHAOS_CKPT_STEP and metrics["start"] == 0:
                runner.start()    # the checkpoint is registered: fire
                seen["checkpoint"] = time.time()
                listed["at the checkpoint"] = compute_apps()

        trainer = TorchTrainer(
            chaos_train_loop, train_loop_config={
                "workdir": workdir, "park_s": CHAOS_PARK_S},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="chaos_gang", storage_path=workdir,
                                 failure_config=FailureConfig(max_failures=1),
                                 callbacks=[on_report]))
        fitted = {}
        fit = threading.Thread(target=lambda: fitted.update(
            result=trainer.fit()), name="phase-4k-fit")
        t0, fit_wall = time.perf_counter(), time.time()
        with HangWatchdog(limit_s=CHAOS_DEADLINE_S) as wd:
            fit.start()
            # The yardstick: the same steps here, with no fault.
            model, _, step, batch = chaos_model(torch.device("cuda"))
            want = [step(batch).item() for _ in range(CHAOS_STEPS)]
            del model, step, batch
            gc.collect()
            torch.cuda.empty_cache()
            fit.join()
        fit_s = time.perf_counter() - t0
        result = fitted["result"]
        if result.error is not None:
            raise AssertionError("phase 4k (a): the run failed") \
                from result.error
        if not runner.wait(timeout=CHAOS_DEADLINE_S):
            raise AssertionError("phase 4k (a): the fault never resolved")
        runner.stop()
        runner.assert_recovered()
        wd.assert_no_hangs()
        history = result.metrics_history
        first = [m for m in history if m["start"] == 0]
        resumed = [m for m in history if m["start"] > 0]
        (rec,) = runner.records
        killed = rec.detail.get("pid")
        print(f"  worker_kill (seed {CHAOS_SEED}, draw "
              f"{runner.schedule.events[0].draw}): {rec.detail}; the first "
              f"attempt's worker pid {first[0]['pid']}, CUDA_VISIBLE_DEVICES="
              f"{first[0]['cuda_visible_devices']!r}; resumed in pid "
              f"{resumed[0]['pid']} (parent {resumed[0]['ppid']}, this "
              f"process {os.getpid()}), CUDA_VISIBLE_DEVICES="
              f"{resumed[0]['cuda_visible_devices']!r}")
        if [m["step"] for m in first] != list(range(CHAOS_CKPT_STEP + 1)) \
                or [m["step"] for m in resumed] != list(
                    range(CHAOS_CKPT_STEP + 1, CHAOS_STEPS)) \
                or resumed[0]["start"] != CHAOS_CKPT_STEP + 1:
            raise AssertionError(
                "phase 4k (a): steps "
                f"{[(m['start'], m['step']) for m in history]}, not 0-"
                f"{CHAOS_CKPT_STEP} then {CHAOS_CKPT_STEP + 1}-"
                f"{CHAOS_STEPS - 1} resumed from the checkpoint")
        if killed != first[0]["pid"] or not rec.detail.get("actor"):
            raise AssertionError(f"phase 4k (a): the kill hit {rec.detail}, "
                                 f"not the card's worker {first[0]['pid']}")
        # Cold: a GPU grant is a fresh exec by the raylet, a child of this
        # process (its in-process raylet), never a fork of the template.
        if resumed[0]["pid"] == killed or resumed[0]["ppid"] != os.getpid():
            raise AssertionError("phase 4k (a): the gang did not restart in "
                                 "a fresh worker spawned cold")
        if {m["cuda_visible_devices"] for m in first + resumed} != {"0"}:
            raise AssertionError("phase 4k (a): a worker without card 0")
        got = [m["loss"] for m in first + resumed]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        print("  losses:        " + ", ".join(f"{x:.6f}" for x in got))
        print("  uninterrupted: " + ", ".join(f"{x:.6f}" for x in want))
        print(f"  largest relative difference {max(rel):.3e} (steps "
              f"{CHAOS_CKPT_STEP + 1}-{CHAOS_STEPS - 1}: "
              f"{max(rel[CHAOS_CKPT_STEP + 1:]):.3e}; limit "
              f"{CHAOS_LOSS_RTOL:g}); bit-equal: {got == want}")
        if max(rel) > CHAOS_LOSS_RTOL:
            raise AssertionError("phase 4k (a): the resumed losses are not "
                                 "the uninterrupted ones")
        gone_s = wait_off_the_card(killed, len(baseline))
        listed["after the run"] = compute_apps()
        print(f"  nvidia-smi's compute apps (pid, MiB): before the leg "
              f"{baseline}, " + ", ".join(
                  f"{k} {v}" for k, v in listed.items()))
        kill_wall = rec.injected_at + clock
        first_resumed_s = resumed[0]["time"] - kill_wall
        a0, r0, ck = first[0], resumed[0], first[CHAOS_CKPT_STEP]
        timeline = {  # seconds, each from the event before it
            "first_worker_start": a0["entered"] - fit_wall,
            "first_build": a0["built"] - a0["entered"],
            "steps_0_to_2": ck["stepped"] - a0["restored"],
            "checkpoint_save": ck["time"] - ck["stepped"],
            "driver_sees_checkpoint": seen["checkpoint"] - ck["time"],
            "to_the_kill": kill_wall - seen["checkpoint"],
            "resumed_worker_start": r0["entered"] - kill_wall,
            "resumed_build": r0["built"] - r0["entered"],
            "restore": r0["restored"] - r0["built"],
            "first_resumed_step": r0["time"] - r0["restored"],
            "steps_4_5_and_shutdown": time.perf_counter() - t0
            - (r0["time"] - fit_wall)}
        print("  timeline (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in timeline.items()))
        lost = sum(1 for m in first if m["step"] > CHAOS_CKPT_STEP)
        launches = {k: first[-1]["launches"][k] + resumed[-1]["launches"][k]
                    for k in first[-1]["launches"]}
        print(f"  MTTR by kind {runner.mttr_by_kind()}; kill to the first "
              f"resumed step {first_resumed_s:.2f} s; steps lost {lost}; "
              f"the killed pid gone and nvidia-smi's list back to this "
              f"process's {gone_s:.2f} s after fit() returned; no hang; fit "
              f"{fit_s:.1f} s; launches {launches}; {card}")
        return {"mttr_by_kind": runner.mttr_by_kind(),
                "kill_to_first_resumed_step_s": first_resumed_s,
                "steps_lost": lost, "killed_pid": killed,
                "resumed_pid": resumed[0]["pid"], "losses": got,
                "uninterrupted": want, "max_rel_diff": max(rel),
                "bit_equal": got == want, "fit_s": fit_s,
                "timeline_s": timeline,
                "launches": launches}
    finally:
        cluster.shutdown()


def on_the_card(n: int, seed: int) -> dict:
    """Phase 4k (b)'s task: the card's name and a bf16 product of two
    n x n matrices from `seed`, computed there; the time it started."""
    started = time.time()
    gen = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(n, n, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    c = (a.cuda() @ b.cuda()).cpu()
    return {"started": started, "name": torch.cuda.get_device_name(0),
            "product": c,
            "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


class _TimedTransport:
    """Keeps each REST call's start and end wall time beside the fake
    cloud's record of it."""

    def __init__(self, inner):
        self.inner, self.times = inner, []

    def __call__(self, method, url, body):
        t0 = time.time()
        out = self.inner(method, url, body)
        self.times.append((method, t0, time.time()))
        return out


def autoscaled_node_leg(card: str, workdir: str) -> dict:
    """Phase 4k (b): the CLI's head, `init(address="auto")`, the
    autoscaler booting a worker node with the card for a pending GPU task
    through the VM's startup script, the node terminated when idle, and
    `stop`. Returns the numbers printed."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, GCEGPUConfig,
                                          GCEGPUNodeProvider,
                                          StandardAutoscaler)
    from ray_tpu_torch.autoscaler.gcp import SubprocessFakeGPUTransport
    from ray_tpu_torch.scripts.cluster_cli import read_daemon_records

    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(workdir, "cluster")
    env = {"RAY_TPU_TORCH_TMPDIR": base, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    full_env = dict(os.environ, **env)

    def cli(*args):
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", *args], env=full_env,
            cwd=workdir, capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            raise AssertionError(f"phase 4k (b): `{' '.join(args)}` exited "
                                 f"{out.returncode}: {out.stderr}")
        return out.stdout

    baseline = compute_apps()
    saved_base = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = base
    autoscaler = None
    stop_watch = threading.Event()
    try:
        t0 = time.perf_counter()
        address = cli("start", "--head", "--num-gpus", "0").split(
            "started at ")[1].split()[0]
        head_s = time.perf_counter() - t0
        rt.init(address="auto")
        if rt._global_runtime.gcs.address != address:
            raise AssertionError("phase 4k (b): init(address='auto') did "
                                 "not reach the CLI's head")
        before = json.loads(cli("--address", address, "status"))

        transport = _TimedTransport(SubprocessFakeGPUTransport(env=env))
        provider = GCEGPUNodeProvider(
            GCEGPUConfig(project="chip-smoke", zone="local-a",
                         cluster_name="rtt-smoke", head_address=address,
                         machine_type="a3-highgpu-1g", host="127.0.0.1"),
            transport=transport)
        autoscaler = StandardAutoscaler(
            address, provider, AutoscalerConfig(
                min_workers=0, max_workers=1,
                node_resources=provider.node_resources_for(),
                idle_timeout_s=AUTOSCALE_IDLE_S, launch_grace_s=60.0,
                update_period_s=0.25))
        seen = {}

        def watch():     # when the VM's node joins and when it is gone
            while not stop_watch.wait(0.05):
                alive = [n for n in rt.nodes() if n["Alive"] and n.get(
                    "Labels", {}).get("gpu-vm-name")]
                if alive and "joined" not in seen:
                    seen["joined"] = time.time()
                if not alive and "joined" in seen:
                    seen["gone"] = time.time()
                    return

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        autoscaler.start()
        submitted = time.time()
        task = rt.remote(num_gpus=1)(on_the_card)
        out = rt.get(task.remote(AUTOSCALE_N, 0), timeout=300)
        got_at = time.time()
        during = state.cluster_summary()
        (post,) = [t for t in transport.times if t[0] == "POST"]
        node_pid = next(iter(transport.inner.nodes.values()))["pid"]
        # The node registers with the GCS inside its daemon's start, before
        # the startup script returns: join is counted from the launch.
        split = {"to_launch": post[1] - submitted,
                 "node_boot": post[2] - post[1],
                 "join": seen["joined"] - post[1],
                 "worker_start": out["started"] - max(post[2],
                                                      seen["joined"])}
        split["submit_to_running"] = out["started"] - submitted
        gen = torch.Generator().manual_seed(0)
        a, b = (torch.randn(AUTOSCALE_N, AUTOSCALE_N, generator=gen).to(
            torch.bfloat16) for _ in range(2))
        want = a.float() @ b.float()
        err = (out["product"].float() - want).abs()
        limit = AUTOSCALE_REL * want.abs() + AUTOSCALE_ABS * want.square(
            ).mean().sqrt()
        worst = (err / limit).max().item()
        print(f"  the task ran on {out['name']!r} (pid {out['pid']}, "
              f"CUDA_VISIBLE_DEVICES={out['cuda_visible_devices']!r}); the "
              f"bf16 product of two {AUTOSCALE_N}² matrices: largest |card "
              f"- cpu| {err.max().item():.4f}, {worst:.4f} of its limit "
              f"(2^-8 |cpu| + 1e-3 rms(cpu))")
        if worst > 1 or out["product"].dtype != torch.bfloat16:
            raise AssertionError("phase 4k (b): the product is off")
        if out["name"] != torch.cuda.get_device_name(0) \
                or out["cuda_visible_devices"] != "0":
            raise AssertionError("phase 4k (b): the task was not on card 0")
        deadline = time.monotonic() + 60
        while provider.non_terminated_nodes() and time.monotonic() < deadline:
            time.sleep(0.05)
        if provider.non_terminated_nodes():
            raise AssertionError("phase 4k (b): the idle node lives on")
        (delete,) = [t for t in transport.times if t[0] == "DELETE"]
        wait_exited(node_pid, "the worker node's daemon", 60.0)
        watcher.join(30)
        if "gone" not in seen:
            raise AssertionError("phase 4k (b): the node never left the "
                                 "cluster's view")
        idle_s = delete[1] - got_at
        gone_s = seen["gone"] - got_at
        autoscaler.stop()
        after = json.loads(cli("--address", address, "status"))
        rt.shutdown()
        records = read_daemon_records(base)
        t0 = time.perf_counter()
        stopped = cli("stop")
        stop_s = time.perf_counter() - t0
        if "stopped 1 " not in stopped:
            raise AssertionError(f"phase 4k (b): stop said {stopped!r}")
        for pid in records:
            wait_exited(pid, "a node daemon", 30.0)
        wait_off_the_card(out["pid"], len(baseline))
        left = compute_apps()
        if autoscaler.num_launches != 1 or autoscaler.num_terminations != 1:
            raise AssertionError(
                f"phase 4k (b): {autoscaler.num_launches} launches, "
                f"{autoscaler.num_terminations} terminations (1 each)")
        if during["resources_total"].get("GPU") != 1.0 \
                or after["resources_total"].get("GPU", 0.0) != 0.0:
            raise AssertionError("phase 4k (b): the node's card did not "
                                 "come and go")
        print(f"  head started in {head_s:.2f} s; submit to running "
              f"{split['submit_to_running']:.2f} s = to the launch "
              f"{split['to_launch']:.2f} + node boot (the startup script) "
              f"{split['node_boot']:.2f} + worker start "
              f"{split['worker_start']:.2f}, the node in the cluster's view "
              f"{split['join']:.2f} s after the launch; idle to the delete "
              f"{idle_s:.2f} s"
              f" (idle_timeout_s {AUTOSCALE_IDLE_S}), to the node gone "
              f"{gone_s:.2f} s; stop {stop_s:.2f} s, no daemon left, "
              f"nvidia-smi's compute apps (pid, MiB) before {baseline}, "
              f"after {left}; {card}")
        print(f"  status resources_total before {before['resources_total']},"
              f" with the node {during['resources_total']}, after "
              f"{after['resources_total']}")
        return {"head_s": head_s, **split, "idle_to_delete_s": idle_s,
                "idle_to_gone_s": gone_s, "stop_s": stop_s,
                "product_worst_of_limit": worst,
                "resources_total": {"before": before["resources_total"],
                                    "with_node": during["resources_total"],
                                    "after": after["resources_total"]}}
    finally:
        stop_watch.set()
        if autoscaler is not None:
            autoscaler.stop()
        if rt.is_initialized():
            rt.shutdown()
        if os.path.exists(os.path.join(base, "daemons")):
            subprocess.run([sys.executable, "-m", "ray_tpu_torch", "stop",
                            "--force"], env=full_env, capture_output=True,
                           timeout=60)
        if saved_base is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved_base


def cluster_phase(card: str, workdir: str) -> dict:
    """Phase 4k: phase 1b's runtime goes down (each leg brings its own
    cluster), legs (a) and (b) run, and a runtime like phase 1b's comes
    back up for the phases after. Returns both legs' numbers, the phase's
    seconds and its launches."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    stop_runtime()
    print("  (a) a GPT-2-small gang killed at its checkpoint by a "
          "worker_kill schedule, resumed on the card", flush=True)
    gang = chaos_gang_leg(card, os.path.join(workdir, "a"))
    os.makedirs(os.path.join(workdir, "b"))
    print("  (b) a GPU node the autoscaler boots through a VM's startup "
          "script, for a num_gpus=1 task", flush=True)
    node = autoscaled_node_leg(card, os.path.join(workdir, "b"))
    rt.init()
    wall = time.perf_counter() - t0
    print(f"  phase 4k took {wall:.1f} s (budget {CLUSTER_BUDGET_S:.0f} s)")
    return {"chaos_gang": gang, "autoscaled_node": node, "wall_s": wall,
            "launches": gang["launches"]}


# Phase 4l: the rest of the platform. One actor granted the card (and the
# dynamic resource "scorer") holds GPT-2-small from seed 0 and scores
# PLATFORM_WINDOWS windows of WINDOW seeded tokens, PLATFORM_BATCH at a
# time (phase 4d's size), through an ActorPool, twice. Its scores are held
# against the same windows scored in this process by the same model built
# the same way: the same kernels on the same inputs, so bit-equal is
# expected; were cuBLAS to pick another algorithm in the other process, a
# window's mean NLL (~10.8 nats) would move by its bf16 logits' rounding
# averaged over 1023 tokens, ~1e-5 of it. 1e-6 (relative) holds them
# tighter than that: a miss is printed with the largest gap.
PLATFORM_WINDOWS, PLATFORM_BATCH = 128, 16
PLATFORM_TOL = 1e-6
PLATFORM_BUDGET_S = 30.0
PLATFORM_KV_NS, PLATFORM_KV_KEY = "chip_smoke", "4l/scorer"
HERE = os.path.dirname(os.path.abspath(__file__))
XLANG_BUILD = os.path.join(HERE, "build", "xlang")


def mean_window_nll(model, ids):
    """Each window's mean next-token NLL, in float32, where the ids [b, s]
    (int64) are."""
    with torch.no_grad():
        return window_nll(model(ids)[:, :-1], ids[:, 1:]) / (ids.shape[1] - 1)


def batch_mean(nll) -> float:
    """A batch's mean of its windows' NLLs (float32 on the CPU), in
    float64: the record the scorer puts on the Queue."""
    return float(nll.double().mean())


def platform_config(device: str):
    """Phase 4l's model: GPT-2-small on the card, `tiny` at the windows'
    length where the phase is tried on the CPU."""
    from ray_tpu_torch.models import gpt2

    return gpt2.GPT2Config.small() if device == "cuda" \
        else gpt2.GPT2Config.tiny(seq=WINDOW)


class PlatformScorer:
    """Phase 4l's actor: GPT-2-small (`GPT2(small, device="cuda", seed=0)`:
    drawn on the CPU, moved to the card), its pid, CUDA_VISIBLE_DEVICES
    and parameter count put in the internal KV; `score` returns a batch's
    mean NLLs, adds to a `tqdm_ray` bar and puts (index, the batch's mean)
    on the pass's Queue where it has one."""

    def __init__(self, device: str = "cuda"):
        from ray_tpu_torch.experimental import internal_kv
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.ops import attention

        t0 = time.perf_counter()
        self.device = device
        self.model = gpt2.GPT2(platform_config(device), device=device,
                               seed=0)
        if device == "cuda":
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        internal_kv._internal_kv_put(PLATFORM_KV_KEY, json.dumps({
            "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "params": gpt2.count_params(self.model)}).encode(),
            namespace=PLATFORM_KV_NS)
        attention.reset_kernel_launches()
        self.bar = self.queue = None
        self.ready_at = time.time()

    def ready(self) -> dict:
        return {"pid": os.getpid(), "build_s": self.build_s,
                "ready_at": self.ready_at}

    def begin(self, desc: str, total: int, queue=None) -> None:
        from ray_tpu_torch.experimental import tqdm_ray

        self.bar = tqdm_ray.tqdm(total=total, desc=desc)
        self.queue = queue

    def score(self, index: int, ids: np.ndarray):
        nll = mean_window_nll(
            self.model, torch.from_numpy(ids).to(self.device).long()).cpu()
        if self.queue is not None:
            self.queue.put((index, batch_mean(nll)))
        self.bar.update(1)
        if self.bar.n == self.bar.total:
            self.bar.close()
        return index, nll.numpy()

    def launches(self) -> dict:
        from ray_tpu_torch.ops import attention

        return attention.kernel_launches()


class XlangCounter:
    """The named actor `cpp/examples/smoke.cc` drives."""

    def __init__(self):
        self.x = 0

    def inc(self, n):
        self.x += n
        return self.x


class _StderrTee:
    """sys.stderr that also keeps its lines: the driver prints the
    workers' streamed lines there."""

    def __init__(self, base):
        self.base, self.lines, self._part = base, [], ""

    def write(self, s):
        parts = (self._part + s).split("\n")
        self._part = parts.pop()
        self.lines.extend(parts)
        return self.base.write(s)

    def flush(self):
        self.base.flush()

    def __getattr__(self, attr):
        return getattr(self.base, attr)


def build_smoke_client() -> subprocess.Popen:
    """g++ of the unchanged `cpp/examples/smoke.cc` into XLANG_BUILD,
    started now and waited on when the client runs."""
    os.makedirs(XLANG_BUILD, exist_ok=True)
    return subprocess.Popen(
        ["g++", "-std=c++17", "-O1", "-I", os.path.join(HERE, "cpp", "include"),
         os.path.join(HERE, "cpp", "examples", "smoke.cc"), "-o",
         os.path.join(XLANG_BUILD, "smoke")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def xlang_leg(gxx: subprocess.Popen) -> dict:
    """Phase 4l (d): the C++ smoke client against the port's gateway."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import xlang
    from ray_tpu_torch.core.ids import ObjectID

    tests = os.path.join(HERE, "tests")   # the gateway imports xlang_mod
    if tests not in sys.path:
        sys.path.insert(0, tests)
    t0 = time.perf_counter()
    out, _ = gxx.communicate(timeout=120)
    if gxx.returncode != 0:
        raise AssertionError(f"g++ of cpp/examples/smoke.cc failed: {out}")
    build_wait_s = time.perf_counter() - t0
    address = xlang.start_gateway()
    counter = rt.remote(XlangCounter).options(name="xlang-counter").remote()
    try:
        if rt.get(counter.inc.remote(0), timeout=60) != 0:
            raise AssertionError("xlang-counter did not start at 0")
        py_ref = rt.put({"greeting": "from-python"})
        t1 = time.perf_counter()
        proc = subprocess.run([os.path.join(XLANG_BUILD, "smoke"), address,
                               py_ref.hex()], capture_output=True,
                              text=True, timeout=60)
        client_s = time.perf_counter() - t1
        if proc.returncode != 0 or "SMOKE OK" not in proc.stdout:
            raise AssertionError(f"smoke client: rc {proc.returncode}, "
                                 f"{proc.stdout!r} {proc.stderr[-2000:]!r}")
        runtime = rt._require_runtime()
        put_id = next(line.split()[1] for line in proc.stdout.splitlines()
                      if line.startswith("PUT_ID "))
        value = runtime.get([ObjectID.from_hex(put_id)], timeout=30)[0]
        kv = runtime.gcs.call("kv_get", {"namespace": "xlang-user",
                                         "key": b"cpp-key"})["value"]
        published = runtime.gcs.call("kv_get", {
            "namespace": xlang.GATEWAY_KV_NS,
            "key": xlang.GATEWAY_KV_KEY})["value"].decode()
        if value != {"kind": "from-cpp", "nums": [1, 2, 3], "pi": 3.5} \
                or kv != b"cpp-value" or published != address:
            raise AssertionError(f"C++ put read back {value!r}, KV {kv!r}, "
                                 f"gateway published {published!r}")
    finally:
        rt.kill(counter)
        xlang.stop_gateway()
    print(f"  (d) xlang: cpp/examples/smoke.cc built by g++ ({build_wait_s:.2f}"
          f" s waited on it here), run against the port's gateway at "
          f"{address}: SMOKE OK in {client_s:.2f} s; its put read back in "
          f"Python {value}, its KV write {kv!r} (host-side: the card is "
          "not on this leg)")
    return {"smoke_ok": True, "client_s": client_s,
            "build_wait_s": build_wait_s}


def trainer_gate_leg() -> dict:
    """Phase 4l (e): each framework trainer raises an ImportError naming
    its library where the library is absent."""
    import importlib.util

    from ray_tpu_torch import train

    out = {}
    for name, pkg, make in (
            ("TransformersTrainer", "transformers",
             lambda: train.TransformersTrainer(
                 lambda config: None,
                 scaling_config=train.ScalingConfig(num_workers=1))),
            ("XGBoostTrainer", "xgboost",
             lambda: train.XGBoostTrainer(params={})),
            ("LightGBMTrainer", "lightgbm",
             lambda: train.LightGBMTrainer(params={}))):
        if importlib.util.find_spec(pkg) is not None:
            out[name] = "skipped: installed"
            print(f"  (e) {name}: {pkg} is installed here, so the gate was "
                  "not checked")
            continue
        try:
            make()
        except ImportError as e:
            if pkg not in str(e):
                raise AssertionError(f"{name}'s ImportError does not name "
                                     f"{pkg}: {e}") from e
            out[name] = str(e)
            print(f"  (e) {name}: ImportError: {e}")
        else:
            raise AssertionError(f"{name} was made without {pkg}")
    return out


def platform_phase(card: str, device: str = "cuda") -> dict:
    """Phase 4l, on the runtime phase 4k brought back: (a) the scorer is
    granted only once `set_resource` has made "scorer"; its pid, card and
    parameter count come back through the internal KV; (b) two ActorPool
    passes score the windows, held against this process; (c) a Queue and a
    tqdm_ray bar from the actor; (d) the C++ client against the xlang
    gateway; (e) the framework trainers' gate. The actor is freed and its
    pid waited on. Returns the phase's numbers and the actor's launches.
    `device="cpu"` tries it on the CPU (GPT-2 `tiny`, a runtime with a
    granted-only GPU; no kernel launches)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import experimental, state
    from ray_tpu_torch.experimental import internal_kv
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Queue

    t_phase = time.perf_counter()
    gxx = build_smoke_client()
    cfg = platform_config(device)
    ids = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (PLATFORM_WINDOWS, WINDOW), dtype=np.int32)
    batches = [(i, ids[i * PLATFORM_BATCH:(i + 1) * PLATFORM_BATCH])
               for i in range(PLATFORM_WINDOWS // PLATFORM_BATCH)]

    # (a) Asked for before the resource exists: not granted until it does
    # (a method call would wait for the actor, so its state is read).
    asked = time.time()
    scorer = rt.remote(num_gpus=1, resources={"scorer": 1})(
        PlatformScorer).remote(device)
    time.sleep(0.5)
    pending = [a["State"] for a in state.list_actors(
        [("ActorID", "=", scorer._actor_id.hex())])]
    if pending != ["PENDING_CREATION"]:
        raise AssertionError(f"the scorer is {pending} before 'scorer' "
                             "exists")
    experimental.set_resource("scorer", 1)
    granted_from = time.time()

    # While the actor starts: the same model and windows in this process.
    model = gpt2.GPT2(cfg, device=device, seed=0)
    n_params = gpt2.count_params(model)
    dev_ids = torch.from_numpy(ids).to(device).long()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        passes.append(torch.cat([
            mean_window_nll(model, dev_ids[i:i + PLATFORM_BATCH])
            for i in range(0, PLATFORM_WINDOWS, PLATFORM_BATCH)]).cpu())
        driver_s = time.perf_counter() - t0   # the second pass's
    want = passes[0].numpy()
    if not np.array_equal(want, passes[1].numpy()):
        raise AssertionError("this process's two passes differ")
    del model, dev_ids, passes
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ready = rt.get(scorer.ready.remote(), timeout=180)
    ready_s = ready["ready_at"] - asked         # the actor's own clock
    grant_s = ready["ready_at"] - granted_from
    seen = json.loads(internal_kv._internal_kv_get(
        PLATFORM_KV_KEY, namespace=PLATFORM_KV_NS))
    print(f"  (a) set_resource('scorer', 1) after the ask (the actor "
          f"{pending[0]} 0.5 s after it); the actor ready {ready_s:.2f} s after "
          f"the ask ({grant_s:.2f} s after set_resource; its model built in "
          f"{ready['build_s']:.2f} s); through internal_kv: pid "
          f"{seen['pid']} (this process {os.getpid()}), CUDA_VISIBLE_DEVICES "
          f"{seen['cuda_visible_devices']!r}, {seen['params']:,} parameters")
    if seen["pid"] == os.getpid() or seen["pid"] != ready["pid"] \
            or seen["cuda_visible_devices"] != "0" \
            or seen["params"] != n_params:
        raise AssertionError(f"the scorer is not another process on card 0 "
                             f"holding GPT-2-small: {seen}, {n_params:,} "
                             "parameters here")
    # A second set_resource while the card is granted: the GPU stays held.
    experimental.set_resource("scorer", 2)
    deadline = time.monotonic() + 30
    while rt.cluster_resources().get("scorer") != 2:
        if time.monotonic() > deadline:
            raise AssertionError("set_resource('scorer', 2) not seen")
        time.sleep(0.05)
    gpu_free = rt.available_resources().get("GPU", 0.0)
    if gpu_free != 0.0:
        raise AssertionError(f"set_resource reset the card's grant: GPU "
                             f"{gpu_free} available while the scorer holds it")

    # (b), (c) Two passes through the pool, each with its bar; the first
    # also puts each batch's mean on a Queue.
    tee = _StderrTee(sys.stderr)
    sys.stderr = tee
    queue = Queue()
    try:
        pool = ActorPool([scorer])
        rt.get(scorer.begin.remote("4l map", len(batches), queue))
        t0 = time.perf_counter()
        ordered = list(pool.map(lambda a, b: a.score.remote(*b), batches))
        map_s = time.perf_counter() - t0
        records = [queue.get(timeout=30) for _ in batches]
        leftover = queue.qsize()
        rt.get(scorer.begin.remote("4l unordered", len(batches)))
        t0 = time.perf_counter()
        unordered = list(pool.map_unordered(lambda a, b: a.score.remote(*b),
                                            batches))
        unordered_s = time.perf_counter() - t0
        launches = rt.get(scorer.launches.remote())
        finals = {}
        deadline = time.monotonic() + 20
        while len(finals) < 2 and time.monotonic() < deadline:
            for line in tee.lines:
                for desc in ("4l map", "4l unordered"):
                    if f"[{desc} pid={ready['pid']}] {len(batches)}/" \
                            f"{len(batches)} (100%)" in line \
                            and line.endswith(" done"):
                        finals[desc] = line
            time.sleep(0.05)
    finally:
        sys.stderr = tee.base
        queue.shutdown()
    if len(finals) < 2:
        raise AssertionError(f"the bars' final lines did not reach this "
                             f"process's log stream: {finals}")
    order = [i for i, _ in ordered]
    got = np.concatenate([nll for _, nll in ordered])
    if order != list(range(len(batches))):
        raise AssertionError(f"map returned batches in order {order}")
    if sorted(i for i, _ in unordered) != order or any(
            not np.array_equal(nll, ordered[i][1]) for i, nll in unordered):
        raise AssertionError("map_unordered's batches differ from map's")
    bit_equal = bool(np.array_equal(got, want))
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    want_records = [(i, batch_mean(torch.from_numpy(nll)))
                    for i, nll in ordered]
    print(f"  (b) {PLATFORM_WINDOWS} windows of {WINDOW} tokens in "
          f"{len(batches)} batches of {PLATFORM_BATCH}: map in order "
          f"{order}, map_unordered returned {[i for i, _ in unordered]}; "
          f"against this process: bit-equal {bit_equal}, largest relative "
          f"gap {rel:.3e} (tol {PLATFORM_TOL}); mean NLL {want.mean():.4f}")
    tokens = PLATFORM_WINDOWS * WINDOW
    res = {"card": card, "windows": PLATFORM_WINDOWS,
           "batch": PLATFORM_BATCH, "bit_equal": bit_equal,
           "max_rel_err": rel, "mean_nll": float(want.mean()),
           "actor_ready_s": ready_s, "grant_to_ready_s": grant_s,
           "actor_build_s": ready["build_s"],
           "pool_map_tokens_per_sec": tokens / map_s,
           "pool_unordered_tokens_per_sec": tokens / unordered_s,
           "driver_tokens_per_sec": tokens / driver_s,
           "launches": {k: int(launches[k]) for k in launches},
           "pid": ready["pid"], "params": n_params}
    print(f"  tokens/s through the pool: map {res['pool_map_tokens_per_sec']:.1f}"
          f" (the actor's first pass), map_unordered "
          f"{res['pool_unordered_tokens_per_sec']:.1f}; this process's own "
          f"loop {res['driver_tokens_per_sec']:.1f} (its second pass); "
          f"launches in the actor {res['launches']}, card {card}")
    print(f"  (c) the Queue held {len(records)} records ({leftover} left), "
          f"{records[:2]}...; the bars' last lines here: "
          + "; ".join(finals.values()))
    if not (np.all(np.isfinite(got)) and (bit_equal or rel <= PLATFORM_TOL)):
        raise AssertionError("the pool's scores differ from this process's")
    if sorted(records) != want_records or leftover:
        raise AssertionError(f"the Queue's records {records} are not the "
                             f"pool's {want_records}")
    want_k1 = 2 * len(batches) * cfg.n_layer if device == "cuda" else 0
    if res["launches"] != {"flash_fwd": want_k1, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}:
        raise AssertionError(f"expected K1 {want_k1} times in the actor "
                             f"and no backward kernel: {res['launches']}")

    # (d) The C++ client while the scorer still holds the card; (e).
    res["xlang"] = xlang_leg(gxx)
    res["trainer_gate"] = trainer_gate_leg()

    rt.kill(scorer)
    res["exit_wait_s"] = wait_exited(ready["pid"], "the scorer actor")
    experimental.set_resource("scorer", 0)
    internal_kv._internal_kv_del(PLATFORM_KV_KEY, namespace=PLATFORM_KV_NS)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"  the scorer's pid gone {res['exit_wait_s']:.2f} s after the "
          f"kill; phase 4l took {res['wall_s']:.1f} s (budget "
          f"{PLATFORM_BUDGET_S:.0f} s)")
    return res


# Phases 4c and 4d: the Data-fed path. The corpus is the nanoGPT layout,
# flat int32 token shards, each stored as one `.npz` row (`read_numpy`
# reads an archive's arrays as columns): `tokens` [1, SHARD_TOKENS] and
# `shard`, its index, so a window knows its place in the corpus without a
# read task per file. A row is a window of WINDOW + 1 tokens cut at stride
# WINDOW, `ids` its first WINDOW tokens and `targets` its last.
CORPUS_SHARDS, SHARD_TOKENS, WINDOW = 16, 1 << 20, 1024
DATA_WARMUP, DATA_STEPS = 2, 10          # phase 4's steps
MAX_STALL_FRAC = 0.10    # the reference's bound (bench.py bench_ingest)
LEAK_WAIT_S = 20.0       # store frees are batched (bench.py bench_ingest)
SCORE_ROWS, SCORE_BATCH = 128, 16   # 256 rows before phase 4k
# Phase 4d holds the pool actor's scores against the same checkpoint
# scored in this process on the card, at the same batches: the same
# kernels on the same inputs, so they should be bit-equal. Were cuBLAS to
# pick another algorithm in the other process, the bf16 logits would move
# by their rounding, ~4e-3 a token at random, ~0.13 nats over a row's 1024
# tokens: 1e-5 of a row's ~1.1e4 nats. 1e-4 covers that eight times; a
# row scored with other weights or against other tokens is off by tens of
# nats.
SCORE_TOL = 1e-4          # relative
# Phase 11c: the CartPole sample batches that BC learns from.
BC_BATCHES, BC_ROWS = 4, 200


# Phase 4m: raylint on the chip machine. Its budget (printed): the port's
# lint takes 13-15 s of one CPU core, and the fresh process that runs the
# twins (torch, CUDA, a forked and a spawned child) ~10-20 s beside it.
ANALYSIS_BUDGET_S = 45.0
SYNC_ERROR = "called a synchronizing CUDA operation"
FORK_ERROR = "Cannot re-initialize CUDA in forked subprocess"


def _twins():
    """tests/torch_lint_fixtures.py, the hazard rules' runnable twins."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_lint_fixtures",
        os.path.join(HERE, "tests", "torch_lint_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_twins(twin_dir: str) -> None:
    """Phase 4m's fresh process (`python -c`, with `twin_dir` on sys.path,
    where each twin is the module `twin_<name>`): the RL020/RL021 twins on
    CUDA tensors under sync debug mode "error", then RL024's fork and spawn.
    Prints one JSON object: each twin's outcome."""
    import importlib

    out = {}
    fx = _twins()
    x = torch.randn(4096, device="cuda")
    logits = torch.randn(8, 512, device="cuda")
    args = {"RL020": (x,), "RL021": (logits, list(range(8)))}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, (rid, entry) in fx.ENTRY.items():
            if rid not in args:
                continue
            fn = getattr(importlib.import_module(f"twin_{name.lower()}"),
                         entry)
            try:
                fn(*args[rid])
                out[name] = "ran"
            except RuntimeError as e:
                out[name] = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("sync debug mode was not reset")
    for name in ("RL024_BAD", "RL024_GOOD"):
        status, what = importlib.import_module(
            f"twin_{name.lower()}").launch()
        out[name] = f"{status}: {what}"
    print(json.dumps(out))


def analysis_phase() -> dict:
    """Phase 4m (see the module docstring): the port's lint, and the torch
    hazard rules' twins linted and then run on the card."""
    from ray_tpu_torch.analysis import lint_paths_full
    from ray_tpu_torch.ops import attention as attn

    attn.reset_kernel_launches()
    started = time.perf_counter()
    lint = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch/",
         "--json"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    fx = _twins()
    twin_dir = tempfile.mkdtemp(prefix="chip_smoke_twins_")
    try:
        drawn = {}
        for name, (rid, _entry) in fx.ENTRY.items():
            path = os.path.join(twin_dir, f"twin_{name.lower()}.py")
            with open(path, "w", encoding="utf-8") as f:
                f.write(textwrap.dedent(getattr(fx, name)))
            drawn[name] = [f.rule for f in lint_paths_full([path]).findings]
            want = [rid] if name.endswith("_BAD") else []
            if drawn[name] != want:
                raise AssertionError(f"the lint of twin {name} drew "
                                     f"{drawn[name]}, not {want}")
        code = (f"import sys; sys.path[:0] = [{HERE!r}, {twin_dir!r}]; "
                "import chip_smoke; chip_smoke.run_twins(sys.path[1])")
        child = subprocess.run([sys.executable, "-c", code], cwd=twin_dir,
                               capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"the twins' process failed:\n"
                                 f"{child.stdout}{child.stderr}")
        ran = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(twin_dir, ignore_errors=True)
    lint_out, lint_err = lint.communicate(timeout=300)
    lint_s = time.perf_counter() - started
    findings = json.loads(lint_out) if lint_out.strip() else None
    print(f"  (a) python -m ray_tpu_torch.analysis ray_tpu_torch/: exit "
          f"{lint.returncode}, {len(findings or [])} finding(s), "
          f"{lint_s:.1f} s wall (run beside (b) and (c))")
    if lint.returncode != 0 or findings != []:
        raise AssertionError(f"the port's lint is not clean here:\n"
                             f"{lint_out}{lint_err}")
    checks = {}
    for name, outcome in ran.items():
        if name.startswith("RL024"):
            want = (f"error: {FORK_ERROR}" if name.endswith("_BAD")
                    else "ok: 2.0")
            held = outcome.startswith(want)
        else:
            held = (SYNC_ERROR in outcome if name.endswith("_BAD")
                    else outcome == "ran")
        checks[name] = {"lint": drawn[name], "run": outcome, "held": held}
        print(f"  {name}: lint {drawn[name] or 'quiet'}; on the card: "
              f"{outcome} -> {'held' if held else 'FAILED'}")
    failed = [n for n, c in checks.items() if not c["held"]]
    if failed or set(ran) != set(fx.ENTRY):
        raise AssertionError(f"phase 4m checks failed: {failed or ran}")
    seconds = time.perf_counter() - started
    launches = attn.kernel_launches()
    over = "" if seconds <= ANALYSIS_BUDGET_S else ": OVER its budget"
    print(f"  phase 4m: {seconds:.1f} s (budget {ANALYSIS_BUDGET_S:.0f} s"
          f"{over}); launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 4m launched kernels: {launches}")
    return {"lint_s": lint_s, "lint_findings": len(findings),
            "checks": checks, "seconds": seconds,
            "within_budget": not over, "launches": launches}


def write_corpus(path: str, vocab: int) -> list:
    """CORPUS_SHARDS files of SHARD_TOKENS int32 tokens each, from seed
    0."""
    rng = np.random.default_rng(0)
    files = []
    for i in range(CORPUS_SHARDS):
        files.append(os.path.join(path, f"shard_{i:02d}.npz"))
        np.savez(files[-1], shard=np.array([i], np.int32),
                 tokens=rng.integers(0, vocab, (1, SHARD_TOKENS),
                                     dtype=np.int32))
    return files


def cut_windows(batch, limit=None):
    """One shard (a `read_numpy` row) cut into rows of WINDOW + 1 tokens
    at stride WINDOW: `ids`, `targets` and the window's index in the
    corpus. `limit` keeps the first windows."""
    tokens, shard = batch["tokens"][0], int(batch["shard"][0])
    per_shard = (len(tokens) - 1) // WINDOW
    n = per_shard if limit is None else min(per_shard, limit)
    win = tokens[np.arange(n)[:, None] * WINDOW + np.arange(WINDOW + 1)]
    return {"ids": win[:, :-1], "targets": win[:, 1:],
            "window": shard * per_shard + np.arange(n)}


def corpus_dataset(files: list, limit=None):
    """`read_numpy` of the shards, cut into windows."""
    from ray_tpu_torch import data as rd

    return rd.read_numpy(files).map_batches(
        functools.partial(cut_windows, limit=limit))


def window_nll(logits, targets):
    """Each row's summed negative log-likelihood of its targets, in
    float32 (as `next_token_loss`, without the shift)."""
    logits = logits.float()
    tgt = torch.gather(logits, -1, targets.long().unsqueeze(-1)).squeeze(-1)
    return (torch.logsumexp(logits, dim=-1) - tgt).sum(dim=-1)


def data_train_loop(config):
    """Phase 4c's loop, run in a worker actor: GPT-2 from seed 0 under
    AdamW(3e-4, wd 0.1), fed by `get_dataset_shard("train").iter_batches`
    for the warm-up and timed steps, then it stops with most of the epoch
    unread. Reports each step's loss, then one record with the windows
    trained, tokens/s, the shard's ingest and split accounting, the kernel
    launches of the run (from 0 at the loop's start), this process's pid,
    its CUDA_VISIBLE_DEVICES and peak memory, and the model's state dict
    as the checkpoint."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train import Checkpoint, session

    device = session.get_device()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_kernel_launches()
    model = gpt2.GPT2(config["cfg"], device=device, seed=0)

    def loss_fn(model, batch):
        nll = window_nll(model(batch["ids"]), batch["targets"])
        ce = nll.sum() / batch["targets"].numel()
        return ce, ce

    step = gpt2.make_train_step(model, gpt2.adamw(model), loss_fn=loss_fn)
    shard = session.get_dataset_shard("train")
    n_steps = config["warmup"] + config["steps"]
    losses, windows, t0 = [], [], None
    for batch in shard.iter_batches(batch_size=config["batch"],
                                    drop_last=True):
        if len(losses) == config["warmup"]:
            losses[-1].item()  # waits for the device
            t0 = time.perf_counter()
        losses.append(step({k: torch.tensor(batch[k], device=device)
                            for k in ("ids", "targets")}))
        windows += batch["window"].tolist()
        if len(losses) == n_steps:
            # Timed to the last step's end: leaving the epoch (the
            # prefetch thread's stop, the frees) is not a step.
            losses[-1].item()
            dt = time.perf_counter() - t0
            break
    if len(losses) < n_steps:
        raise AssertionError(f"the shard ran dry after {len(losses)} of "
                             f"{n_steps} batches")
    for i, loss in enumerate(losses):
        session.report({"step": i, "loss": loss.item()})
    ids_per_batch = config["batch"] * config["cfg"].n_positions
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session.report({
        "step": n_steps, "loss": losses[-1].item(), "windows": windows,
        "tokens_per_sec": ids_per_batch * config["steps"] / dt,
        "ms_per_step": 1e3 * dt / config["steps"],
        "ingest": session.get_ingest_stats()["train"],
        "split": shard.split_stats(),
        "launches": attn.kernel_launches(), "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
        checkpoint=Checkpoint.from_state_dict(state,
                                              path=config["ckpt_dir"]))


def store_objects() -> list:
    """Objects in each node's store (this process's head node)."""
    import ray_tpu_torch as rt

    return [rt._global_node.raylet.store.stats()["num_objects"]]


def data_phase(attn, cfg, files: list, workdir: str, card: str):
    """Phase 4c: `TorchTrainer.fit(datasets={"train": ds})` trains GPT-2 on
    the corpus's windows, shuffled (`random_shuffle(seed=0)`), in a worker
    actor granted the card. Checks the loss (finite, falling), the worker
    (another process, card "0"), each kernel once a layer a step, distinct
    windows, the shard's stall_frac and that the store returns to its
    object count within LEAK_WAIT_S of fit() returning. Returns the final
    metrics and the run's checkpoint."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    # The worker shares the card with this process: hand back the cache.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    baseline = store_objects()
    driver_launches = attn.kernel_launches()
    ds = corpus_dataset(files).random_shuffle(seed=0)
    result = TorchTrainer(
        data_train_loop,
        train_loop_config={"cfg": cfg, "batch": BATCH,
                           "warmup": DATA_WARMUP, "steps": DATA_STEPS,
                           "ckpt_dir": os.path.join(workdir, "ckpt")},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="data", storage_path=workdir),
        datasets={"train": ds}).fit()
    fit_done = time.perf_counter()
    if result.error is not None:
        raise AssertionError("the Data-fed run failed") from result.error
    if attn.kernel_launches() != driver_launches:
        raise AssertionError("this process launched kernels while the "
                             "worker trained")
    del ds
    gc.collect()
    now = store_objects()
    while any(n > b for n, b in zip(now, baseline)) \
            and time.perf_counter() - fit_done < LEAK_WAIT_S:
        time.sleep(0.2)
        now = store_objects()
    freed_s = time.perf_counter() - fit_done
    m = dict(result.metrics, card=card)
    ingest, split = m["ingest"], m["split"]
    losses = [r["loss"] for r in result.metrics_history[:-1]]
    print(f"  worker pid {m['pid']} (this process {os.getpid()}), "
          f"CUDA_VISIBLE_DEVICES={m['cuda_visible_devices']!r}")
    print("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"  batch {BATCH}, seq {cfg.n_positions}: tokens/s "
          f"{m['tokens_per_sec']:.1f}, ms/step {m['ms_per_step']:.3f}, "
          f"peak memory {m['peak_gib']:.2f} GiB, card {card}")
    print(f"  ingest: first_batch_ms {ingest['first_batch_ms']}, "
          f"stall_ms_per_step {ingest['stall_ms_per_step']}, stall_frac "
          f"{ingest['stall_frac']} (bound {MAX_STALL_FRAC}), steps "
          f"{ingest['steps']}; shuffle {split.get('shuffle')}")
    print(f"  store objects before {baseline}, {now} after "
          f"{freed_s:.1f} s; launches {m['launches']}")
    if m["pid"] == os.getpid() or m["cuda_visible_devices"] != "0":
        raise AssertionError("the loop did not run in a worker granted "
                             "card 0")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    n_steps = DATA_WARMUP + DATA_STEPS
    want = dict.fromkeys(attn.KERNELS, cfg.n_layer * n_steps)
    if m["launches"] != want:
        raise AssertionError(f"expected {want} launches, got "
                             f"{m['launches']}")
    if len(set(m["windows"])) != BATCH * n_steps:
        raise AssertionError(f"{len(set(m['windows']))} distinct windows "
                             f"of {BATCH * n_steps} trained")
    if not ingest["stall_frac"] < MAX_STALL_FRAC:
        raise AssertionError(f"stall_frac {ingest['stall_frac']} is not "
                             f"below {MAX_STALL_FRAC}")
    if any(n > b for n, b in zip(now, baseline)):
        raise AssertionError(f"store objects {baseline} before the phase, "
                             f"{now} {LEAK_WAIT_S} s after fit()")
    m.update(windows=len(m["windows"]), losses=losses,
             store_freed_s=freed_s)
    return m, result.checkpoint


def window_scorer():
    """Phase 4d's predictor: a `TorchPredictor` that returns each row's
    summed log-likelihood of its targets (`score`; full logits would be
    206 MB a row), how a user scores a corpus. Each output row also
    carries, as of its batch, the actor's pid, its CUDA_VISIBLE_DEVICES,
    its kernel launches since the predictor was built, its peak memory,
    when the predictor was ready (wall clock) and the batch's predict time
    (the scores' copy to the host waits for the card). The class is made
    here so that the pool actor receives it by value."""
    from ray_tpu_torch.train import TorchPredictor

    class WindowScorer(TorchPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            from ray_tpu_torch.ops import attention

            pred = super().from_checkpoint(checkpoint, **kwargs)
            attention.reset_kernel_launches()
            torch.cuda.reset_peak_memory_stats()
            pred.ready_at = time.time()
            return pred

        def predict(self, batch):
            from ray_tpu_torch.ops import attention

            t0 = time.perf_counter()
            with torch.no_grad():
                logits = self.model(self.inputs(batch, self.input_column))
                score = -window_nll(logits, self.inputs(batch, "targets"))
            out = self._passthrough(batch,
                                    {"score": score.cpu().numpy()})
            predict_ms = 1e3 * (time.perf_counter() - t0)
            n, launches = len(out["score"]), attention.kernel_launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out.update({
                "pid": np.full(n, os.getpid()),
                "cuda_visible": np.full(
                    n, os.environ.get("CUDA_VISIBLE_DEVICES", "unset")),
                "peak_gib": np.full(n, peak),
                "ready_at": np.full(n, self.ready_at),
                "predict_ms": np.full(n, predict_ms),
                **{k: np.full(n, v) for k, v in launches.items()}})
            return out

    return WindowScorer


def score_phase(attn, cfg, files: list, checkpoint, card: str,
                train_pid: int) -> dict:
    """Phase 4d: `BatchPredictor` scores the first SCORE_ROWS windows of the
    corpus's last shard, in order, with phase 4c's checkpoint, in one pool
    actor granted the card (once 4c's worker has exited). Every row must
    be scored once, equal to the same checkpoint scored in this process
    at the same batches (SCORE_TOL), in another process seeing card "0",
    with K1 once a layer a batch and no backward kernel."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import BatchPredictor

    exited_s = wait_exited(train_pid, "phase 4c's trainer worker")
    scorer = window_scorer()
    spec = functools.partial(gpt2.GPT2, cfg)
    last = len(files) - 1
    rows, batch = SCORE_ROWS, SCORE_BATCH
    ds = corpus_dataset(files[last:], limit=rows)
    t0 = time.time()
    # The pool's actors take the card; the read tasks upstream stay on CPU
    # workers (with_resources on `ds` would ask the card for them too).
    scored = BatchPredictor.from_checkpoint(
        checkpoint, scorer, model=spec, input_column="ids").predict(
        ds, batch_size=batch, max_scoring_workers=1,
        keep_columns=("window",)).with_resources(num_gpus=1)
    out = collections.defaultdict(list)
    for b in scored.iter_batches(batch_size=rows):
        for k, v in b.items():
            out[k].append(v)
    t_end = time.time()
    out = {k: np.concatenate(v) for k, v in out.items()}
    rows_np = cut_windows(dict(np.load(files[last])), limit=rows)
    want_windows = rows_np["window"]
    got_windows = np.sort(out["window"])
    if not np.array_equal(got_windows, want_windows):
        raise AssertionError(f"{len(out['window'])} rows scored, "
                             f"{len(np.unique(out['window']))} distinct; "
                             f"expected windows {want_windows[0]}.."
                             f"{want_windows[-1]} once each")
    pids = set(out["pid"].tolist())
    visible = set(out["cuda_visible"].tolist())
    ready_s = float(out["ready_at"][0]) - t0
    score_s = t_end - float(out["ready_at"][0])
    k1 = sorted(set(out["flash_fwd"].tolist()))
    # One predict time a batch, in K1-count (batch) order.
    batch_ms = [float(out["predict_ms"][out["flash_fwd"] == c][0])
                for c in k1]
    steady_s = 1e-3 * sum(batch_ms[1:])
    res = {"card": card, "rows": rows, "batch": batch,
           "rows_per_sec": rows / score_s,
           "tokens_per_sec": rows * WINDOW / score_s,
           "rows_per_sec_with_ready": rows / (t_end - t0),
           "first_batch_ms": batch_ms[0],
           "batch_ms_median": statistics.median(batch_ms[1:]),
           "steady_rows_per_sec": (rows - batch) / steady_s,
           "steady_tokens_per_sec": (rows - batch) * WINDOW / steady_s,
           "actor_ready_s": ready_s, "trainer_exit_wait_s": exited_s,
           "peak_gib": float(out["peak_gib"].max()),
           "launches": {k: int(out[k].max()) for k in attn.KERNELS},
           "pid": sorted(pids)}
    print(f"  pool actor pid {sorted(pids)} (this process {os.getpid()}), "
          f"CUDA_VISIBLE_DEVICES {sorted(visible)}; 4c's worker gone "
          f"{exited_s:.2f} s after the wait began")
    print(f"  {rows} rows of {WINDOW} tokens in batches of {batch}: "
          f"rows/s {res['rows_per_sec']:.1f}, tokens/s "
          f"{res['tokens_per_sec']:.1f} (from the predictor's ready time; "
          f"{res['rows_per_sec_with_ready']:.1f} rows/s with it), actor "
          f"ready {ready_s:.2f} s, peak memory {res['peak_gib']:.2f} GiB, "
          f"launches {res['launches']}, card {card}")
    print(f"  predict a batch: first {res['first_batch_ms']:.1f} ms, then "
          f"median {res['batch_ms_median']:.1f} ms: "
          f"{res['steady_rows_per_sec']:.1f} rows/s, "
          f"{res['steady_tokens_per_sec']:.1f} tokens/s past the first")
    if len(pids) != 1 or os.getpid() in pids or visible != {"0"}:
        raise AssertionError("the scoring did not run in one pool actor "
                             "granted card 0")
    n_batches = rows // batch
    want_k1 = [cfg.n_layer * (i + 1) for i in range(n_batches)]
    if k1 != want_k1 or res["launches"]["flash_bwd_dq"] \
            or res["launches"]["flash_bwd_dkv"]:
        raise AssertionError(f"expected K1 {cfg.n_layer} times a batch and "
                             f"no backward kernel; K1 counts {k1}, "
                             f"{res['launches']}")
    # The same checkpoint scored here, at the same batches in order.
    ref = scorer.from_checkpoint(checkpoint, model=spec, input_column="ids")
    want = np.concatenate([ref.predict(
        {k: v[i:i + batch] for k, v in rows_np.items()})["score"]
        for i in range(0, rows, batch)])
    got = out["score"][np.argsort(out["window"])]
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    res.update(score_max_rel_err=err,
               bit_equal=bool(np.array_equal(got, want)),
               mean_score=float(want.mean()))
    print(f"  scores against this process's: max relative error {err:.3e} "
          f"(tol {SCORE_TOL}), bit-equal {res['bit_equal']}, mean "
          f"{res['mean_score']:.2f} nats a row")
    if not (np.all(np.isfinite(got)) and err <= SCORE_TOL):
        raise AssertionError("the pool actor's scores differ from this "
                             "process's")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return res


def runtime_phase() -> dict:
    """Phase 1b: the port's runtime on this machine. `init()` must
    advertise this process's cards as `GPU`; 16 tasks and an actor run; a
    256 MiB array goes to a worker through the object store and another
    comes back; a CPU task sees no card and a `num_gpus=1` task exactly
    card 0, alone. Returns the numbers printed."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init()
    init_s = time.perf_counter() - t0
    res = rt.cluster_resources()
    print(f"  init {init_s:.2f} s, cluster resources {res}")
    if res.get("GPU") != torch.cuda.device_count():
        raise AssertionError(f"the runtime advertises GPU {res.get('GPU')}, "
                             f"this process sees "
                             f"{torch.cuda.device_count()} cards")

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    t0 = time.perf_counter()
    got = rt.get([square.remote(i) for i in range(16)])
    tasks_s = time.perf_counter() - t0
    counter = Counter.remote()
    counts = rt.get([counter.inc.remote() for _ in range(3)])
    if got != [i * i for i in range(16)] or counts != [1, 2, 3]:
        raise AssertionError(f"tasks gave {got}, the actor {counts}")
    rt.kill(counter)
    print(f"  16 tasks in {tasks_s:.3f} s (first ones start workers); an "
          f"actor counted {counts}")

    @rt.remote
    def checksum(arr):
        t0 = time.perf_counter()
        total = int(arr[::4096].sum())
        return total, time.perf_counter() - t0

    @rt.remote
    def make(n):
        return np.full(n, 7, dtype=np.uint8)

    n = 256 << 20
    arr = np.arange(n, dtype=np.uint8)
    rt.get(checksum.remote(rt.put(np.zeros(1 << 20, np.uint8))))  # warm
    t0 = time.perf_counter()
    ref = rt.put(arr)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    total, _ = rt.get(checksum.remote(ref))
    task_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = rt.get(make.remote(n))
    back_s = time.perf_counter() - t0
    if total != int(arr[::4096].sum()) or back.nbytes != n \
            or int(back[::4096].sum()) != 7 * (n // 4096):
        raise AssertionError("a 256 MiB array came through changed")
    mib = n / 2 ** 20
    numbers = {"init_s": init_s, "put_mb_s": mib / put_s,
               "to_worker_mb_s": mib / task_s,
               "from_worker_mb_s": mib / back_s}
    print(f"  256 MiB: put {numbers['put_mb_s']:.0f} MiB/s; to a worker "
          f"task and its reply {numbers['to_worker_mb_s']:.0f} MiB/s; made "
          f"in a worker and got here {numbers['from_worker_mb_s']:.0f} MiB/s")
    del arr, back, ref

    @rt.remote
    def visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @rt.remote(num_gpus=1)
    def gpu_visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES"), \
            torch.cuda.device_count(), os.getpid()

    @rt.remote(num_gpus=1)
    class GpuWorker:
        def ready(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

    cpu_sees = rt.get(visible.remote())
    gpu_sees, n_cards, gpu_pid = rt.get(gpu_visible.remote())
    print(f"  a CPU task sees CUDA_VISIBLE_DEVICES={cpu_sees!r}; a "
          f"num_gpus=1 task {gpu_sees!r} and {n_cards} card (pid {gpu_pid})")
    if cpu_sees != "" or gpu_sees != "0" or n_cards != 1:
        raise AssertionError("a worker saw cards it was not granted")
    t0 = time.perf_counter()
    actor = GpuWorker.remote()
    actor_sees, actor_pid = rt.get(actor.ready.remote())
    numbers["gpu_actor_cold_spawn_s"] = time.perf_counter() - t0
    rt.kill(actor)
    print(f"  GPU worker actor: cold spawn to first reply "
          f"{numbers['gpu_actor_cold_spawn_s']:.2f} s, sees "
          f"{actor_sees!r} (pid {actor_pid})")
    if actor_sees != "0":
        raise AssertionError(f"the GPU actor sees {actor_sees!r}")
    return numbers


def stop_runtime() -> None:
    """Shut the runtime down and stop its worker template."""
    import ray_tpu_torch as rt

    node = rt._global_node
    forge = node.worker_forge if node is not None else None
    proc = forge.proc if forge is not None else None
    rt.shutdown()
    if proc is not None and proc.poll() is None:
        proc.terminate()
        proc.wait(timeout=30)


def time_long_shape(attn) -> dict:
    """Phase 8: K1, K2 and K3 at the long-context shape, run once at the
    whole bh 48 and held element by element against their plain versions
    LONG_CHUNK heads at a time (heads are independent; the plain float32
    scores of all 48 would take 12 GiB), then timed alone, each beside its
    bound and scaled_dot_product_attention's times on the same inputs.
    Returns each kernel's record."""
    case = LONG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(300)
    q, k, v, do = (torch.randn(case["bh"], case["seq"], case["d"],
                               generator=gen, device="cuda",
                               dtype=case["dtype"]) for _ in range(4))
    scale = 1.0 / math.sqrt(case["d"])
    got = run_kernels(attn, q, k, v, do, True, scale)
    res = collections.defaultdict(list)
    for c in range(0, case["bh"], LONG_CHUNK):
        h = slice(c, c + LONG_CHUNK)
        part = {key: t[h] for key, t in got.items()}
        want = run_plain(attn, q[h], k[h], v[h], do[h], part, True, scale)
        for key, r in compare(part, want, case["dtype"]).items():
            res[key].append(r)
        del want
    errs = report({key: (worst([r[0] for r in rs]), max(r[1] for r in rs),
                         rs[0][2]) for key, rs in res.items()},
                  f"bh={case['bh']} seq={case['seq']} d={case['d']} "
                  f"{str(case['dtype']).split('.')[-1]} causal=True (plain "
                  f"{LONG_CHUNK} heads at a time)")
    out, lse, dq, delta, dk, dv = (got[key] for key in (
        "out", "lse", "dq", "delta", "dk", "dv"))
    torch.cuda.synchronize()
    sdpa = {part: _sdpa(q, k, v, True, scale, part, batch=LONG_BATCH)
            for part in ("forward", "backward", "both")}
    shape = (f"bh {case['bh']}, seq {case['seq']}, d {case['d']}, bf16, "
             "causal")
    runs = {
        "flash_fwd": (lambda: attn._flash_forward(q, k, v, True, scale), 2,
                      [q, k, v, out, lse], sdpa["forward"]),
        "flash_bwd_dq": (lambda: attn._bwd_dq(q, k, v, do, out, lse, True,
                                              scale), 3,
                         [q, k, v, do, out, lse, dq, delta], None),
        "flash_bwd_dkv": (lambda: attn._bwd_dkv(q, k, v, do, lse, delta,
                                                True, scale), 4,
                          [q, k, v, do, lse, delta, dk, dv], None),
    }
    recs = {}
    for name, (fn, n_prod, tensors, lib_ms) in runs.items():
        b_ms, b_by = bound(case, n_prod, tensors)
        recs[name] = {"shape": shape, "max_abs_err": errs[name][1],
                      "ms": time_ms(fn), "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms,
                      "sdpa_fwd_bwd_ms": sdpa["both"]}
        if lib_ms is None:  # K2 and K3: SDPA's backward does both
            recs[name]["sdpa_backward_ms"] = sdpa["backward"]
        print(f"  {name:14s} at {shape}: {recs[name]['ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / recs[name]['ms']:.2%} of it")
    fwd, bwd = recs["flash_fwd"]["ms"], (recs["flash_bwd_dq"]["ms"]
                                         + recs["flash_bwd_dkv"]["ms"])
    print(f"  scaled_dot_product_attention at that shape: forward "
          f"{sdpa['forward']:.4f} ms (K1 {fwd / sdpa['forward']:.3f}x), "
          f"backward {sdpa['backward']:.4f} ms (K2 + K3 {bwd:.4f} ms), "
          f"forward + backward {sdpa['both']:.4f} ms (kernels "
          f"{fwd + bwd:.4f} ms)")
    del q, k, v, do, got, out, lse, dq, delta, dk, dv
    torch.cuda.empty_cache()
    return recs


def check_long_model(attn, gpt2) -> dict:
    """Phase 8: the leg's GPT-2 (full width and depth, seq 8192, remat) at
    batch LONG_CHECK_BATCH, from seed 0, through LONG_CHECK_STEPS AdamW
    steps with the kernels and with plain attention, on the same weights
    and tokens; each flash run must launch K1 twice a layer a step, K2 and
    K3 once.
    - float32, where the two differ only in summation order: each step's
      loss within 1e-4 of plain attention's (relative), and every
      first-step gradient within 5e-4 element by element (`mismatch`): the
      float32 kernels' limits.
    - bf16, the leg's kernels: each step's loss within the bf16 kernels'
      2e-2 of plain attention's (relative), and the first-step gradients
      no further from the float32 plain model's than plain attention's in
      bf16 are, within MODEL_ERR_RATIO (over all parameters as one vector).
    Returns the losses and distances."""
    seq = LONG_SHAPE["seq"]
    cfg = gpt2.GPT2Config(n_positions=seq, remat=True)
    ids = torch.randint(0, cfg.vocab_size, (LONG_CHECK_BATCH, seq),
                        generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    n = cfg.n_layer
    want_launches = {"flash_fwd": 2 * n * LONG_CHECK_STEPS,
                     "flash_bwd_dq": n * LONG_CHECK_STEPS,
                     "flash_bwd_dkv": n * LONG_CHECK_STEPS}

    def train(dtype, use_flash: bool):
        model = gpt2.GPT2(dataclasses.replace(cfg, dtype=dtype,
                                              use_flash=use_flash),
                          device="cuda", seed=0)
        step = gpt2.make_train_step(model, gpt2.adamw(model))
        attn.reset_kernel_launches()
        losses = [step(batch)]
        grads = [p.grad.clone() for p in model.parameters()]
        losses += [step(batch) for _ in range(LONG_CHECK_STEPS - 1)]
        losses = [x.item() for x in losses]
        launches = attn.kernel_launches()
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        if use_flash and launches != want_launches:
            raise AssertionError(f"long model check: expected "
                                 f"{want_launches} launches, got {launches}")
        return losses, grads

    out = {}
    runs = {}
    for dtype, tol in ((torch.float32, 1e-4),
                       (torch.bfloat16, TOL[torch.bfloat16, "fwd"])):
        kind = str(dtype).split(".")[-1]
        runs[kind] = (train(dtype, True), train(dtype, False))
        (lf, _), (lp, _) = runs[kind]
        loss_err = worst([abs(a - b) / abs(b) for a, b in zip(lf, lp)])
        out[kind] = {"losses_flash": lf, "losses_plain": lp,
                     "loss_rel_err": loss_err}
        print(f"  {kind}, batch {LONG_CHECK_BATCH}, seq {seq}, remat: losses "
              f"with the kernels {[round(x, 6) for x in lf]}, with plain "
              f"attention {[round(x, 6) for x in lp]}; largest relative "
              f"difference {loss_err:.3e} (tol {tol:.0e})")
        if not loss_err <= tol:
            raise AssertionError(f"long model check, {kind}: the losses "
                                 "with the kernels and with plain attention "
                                 "part")
    (_, g_f32), (_, truth) = runs["float32"]
    grad_err = worst([mismatch(a, b, 5e-4) for a, b in zip(g_f32, truth)])
    (_, g_flash), (_, g_plain) = runs["bfloat16"]
    flat = [torch.cat([g.flatten() for g in grads])
            for grads in (g_flash, g_plain, truth)]
    d_flash, d_plain = (rel_err(g, flat[2]) for g in flat[:2])
    out.update(grad_mismatch_float32=grad_err, bf16_grad_dist_flash=d_flash,
               bf16_grad_dist_plain=d_plain)
    print(f"  float32 first-step gradients, kernels against plain attention: "
          f"mismatch={grad_err:.4f} of its limit (tol 5e-4); bf16 "
          f"first-step gradients' distance to the float32 plain model's "
          f"(rms of the difference over rms): with the kernels "
          f"{d_flash:.5f}, with plain attention {d_plain:.5f} (limit "
          f"{MODEL_ERR_RATIO} x the plain one)")
    del runs, g_f32, truth, g_flash, g_plain, flat
    gc.collect()
    torch.cuda.empty_cache()
    if not grad_err <= 1.0:
        raise AssertionError("long model check: float32 gradients with the "
                             "kernels disagree with plain attention's")
    if not d_flash <= MODEL_ERR_RATIO * d_plain:
        raise AssertionError("long model check: bf16 gradients with the "
                             "kernels are further from the float32 model's "
                             "than plain attention's")
    return out


def check_remat(attn, gpt2) -> dict:
    """Phase 9: the phase-3 GPT-2 (float32) with remat on and off, with
    dropout 0 and 0.1: loss and every gradient within the float32 kernels'
    5e-4, K1 twice a layer under remat. Returns, per dropout, whether the
    two runs are bit-equal."""
    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=128,
                          n_layer=2, n_head=2, dtype=torch.float32)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(3)).cuda()
    n = cfg.n_layer
    bit_equal = {}
    for dropout in (0.0, 0.1):
        runs = []
        for remat in (False, True):
            model = gpt2.GPT2(dataclasses.replace(cfg, dropout=dropout,
                                                  remat=remat),
                              device="cuda", seed=0)
            torch.manual_seed(0)  # the CPU's and every card's generator
            attn.reset_kernel_launches()
            loss = gpt2.next_token_loss(model(ids, deterministic=False), ids)
            loss.backward()
            torch.cuda.synchronize()
            runs.append((loss.detach(), [p.grad for p in model.parameters()],
                         attn.kernel_launches()))
        (loss_p, grads_p, launches_p), (loss_r, grads_r, launches_r) = runs
        err_loss = mismatch(loss_r.view(1), loss_p.view(1), 5e-4)
        err_grads = max(mismatch(a, b, 5e-4)
                        for a, b in zip(grads_r, grads_p))
        bit_equal[dropout] = bool(torch.equal(loss_r, loss_p) and all(
            torch.equal(a, b) for a, b in zip(grads_r, grads_p)))
        want_p = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        want_r = dict(want_p, flash_fwd=2 * n)
        print(f"  dropout {dropout}: remat against no remat, mismatch of "
              f"its limit: loss {err_loss:.4f}, grads {err_grads:.4f} (tol "
              f"5e-4); bit-equal {bit_equal[dropout]}; launches "
              f"{launches_r} with remat, {launches_p} without")
        if not (err_loss <= 1.0 and err_grads <= 1.0):
            raise AssertionError(f"remat changes the loss or gradients at "
                                 f"dropout {dropout}")
        if launches_p != want_p or launches_r != want_r:
            raise AssertionError(f"expected {want_p} launches without remat "
                                 f"and {want_r} with it")
    return bit_equal


def llama_forward(attn, llama):
    """Phase 6. Returns (model, K1 launches of the forward, K1's record at
    the Llama-7B prefill shape)."""
    cfg = llama.LlamaConfig.llama7b()
    t0 = time.perf_counter()
    model = llama.Llama(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  Llama-7B built: {n_params} float32 parameters from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != 5_933_109_248:
        raise AssertionError(f"Llama-7B has {n_params} parameters")
    # The same weights with plain attention, and computing in float32.
    plain, exact = (llama.Llama(dataclasses.replace(cfg, **changes),
                                device="cuda", state=model.state_dict())
                    for changes in (dict(use_flash=False),
                                    dict(use_flash=False,
                                         dtype=torch.float32)))
    ids = torch.randint(0, cfg.vocab_size, (1, LLAMA_SEQ),
                        generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        attn.reset_kernel_launches()
        got = model(ids)
        torch.cuda.synchronize()
        launches = attn.kernel_launches()
        want, truth = plain(ids), exact(ids)
        fwd_ms = time_ms(lambda: model(ids), reps=3, rounds=3)
        plain_ms = time_ms(lambda: plain(ids), reps=3, rounds=3)
    del plain, exact
    err_flash, err_plain = rel_err(got, truth), rel_err(want, truth)
    ok = (bool(torch.isfinite(got).all())
          and err_flash <= MODEL_ERR_RATIO * err_plain)
    print(f"  Llama-7B forward, batch 1, seq {LLAMA_SEQ}, bf16: logits "
          f"{tuple(got.shape)}; distance to the float32 model (rms of the "
          f"difference over rms): with the kernel {err_flash:.5f}, with "
          f"plain attention {err_plain:.5f} (limit {MODEL_ERR_RATIO} x the "
          f"plain one) {'ok' if ok else 'FAIL'}; kernel against plain "
          f"element by element: max_abs_err={max_err(got, want):.3e}, "
          f"mismatch={mismatch(got, want, TOL[torch.bfloat16, 'fwd']):.4f} "
          f"of the kernels' limit (not a check at model depth, PERF.md); "
          f"forward {fwd_ms:.3f} ms with the kernel, {plain_ms:.3f} ms "
          f"plain; launches {launches}")
    if not ok:
        raise AssertionError("Llama-7B with the flash kernel is further from "
                             "the float32 model than with plain attention")
    want_launches = {name: 0 for name in launches}
    want_launches["flash_fwd"] = cfg.n_layer
    if launches != want_launches:
        raise AssertionError(f"expected {cfg.n_layer} launches of K1 in the "
                             f"forward, got {launches}")

    case = dict(bh=cfg.n_head, seq=LLAMA_SEQ, d=cfg.head_dim,
                dtype=torch.bfloat16, causal=True)
    gen = torch.Generator(device="cuda").manual_seed(200)
    q, k, v = (torch.randn(case["bh"], LLAMA_SEQ, case["d"], generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(case["d"])
    out, lse = attn._flash_forward(q, k, v, True, scale)
    out_p, _ = attn.flash_forward_reference(q, k, v, True, scale)
    tol = TOL[torch.bfloat16, "fwd"]
    ratio = mismatch(out, out_p, tol)
    if not ratio <= 1.0:
        raise AssertionError("K1 disagrees with its plain version at the "
                             "Llama-7B shape")
    b_ms, b_by = bound(case, 2, [q, k, v, out, lse])
    rec = {"shape": f"bh {case['bh']}, seq {LLAMA_SEQ}, d {case['d']}, "
                    "bf16, causal",
           "max_abs_err": max_err(out, out_p),
           "ms": time_ms(lambda: attn._flash_forward(q, k, v, True, scale)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": _sdpa(q, k, v, True, scale, "forward", batch=1)}
    print(f"  flash_fwd at the Llama-7B prefill shape ({rec['shape']}): "
          f"{rec['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"scaled_dot_product_attention forward {rec['library_ms']:.4f} ms,"
          f" mismatch={ratio:.4f} of its limit")
    return model, launches, rec


def serve_prompts(vocab: int):
    """Phase 7's traffic from seed 0: N_REQUESTS prompts of PROMPT_LEN
    tokens; the even ones start with one shared SHARED_PREFIX-token prefix
    (and are longer than it), so the radix cache hits once the first of
    them finishes."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        if i % 2 == 0:
            n = int(rng.integers(SHARED_PREFIX + 64, PROMPT_LEN[1] + 1))
            prompts.append(shared + rng.integers(
                0, vocab, n - SHARED_PREFIX).tolist())
        else:
            n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def solo_prompt(vocab: int):
    return np.random.default_rng(1).integers(0, vocab, SOLO_LEN).tolist()


def dense_greedy(llama, model, prompt, n: int):
    """Greedy tokens of a dense-cache loop through `Llama.decode`, each with
    whether the reference's logits were a near tie there (top-2 gap below
    NEAR_TIE of the row's rms)."""
    cache = llama.make_cache(model.config, 1, len(prompt) + n,
                             device=model.device)
    ids = torch.tensor([prompt], device=model.device)
    pos = torch.zeros(1, dtype=torch.long, device=model.device)
    toks, ties = [], []
    for _ in range(n):
        logits, cache = model.decode(ids, cache, pos)
        row = logits[0, -1].float()
        top = row.topk(2).values
        ties.append(bool(top[0] - top[1] < NEAR_TIE * row.square().mean()
                         .sqrt()))
        toks.append(int(row.argmax()))
        pos = pos + ids.shape[1]
        ids = torch.tensor([[toks[-1]]], device=model.device)
    return toks, ties


def agree_until_tie(got, want, ties) -> int:
    """How many leading tokens were compared: all steps before the first
    near tie, and always the first. Raises on a disagreement among them."""
    n = max(1, ties.index(True)) if True in ties else len(want)
    n = min(n, len(got), len(want))
    if got[:n] != want[:n]:
        raise AssertionError(f"tokens disagree before the first near tie: "
                             f"{got[:n]} != {want[:n]}")
    return n


def _timed_calls(engine):
    """Wrap the engine's program calls: each is bracketed by CUDA events
    (no synchronisation added) and logged as (program, rows or tokens it
    wrote, start, end)."""
    calls = []
    run = engine._call

    def timed(name, fn, arenas, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(name, fn, arenas, *args)
        end.record()
        calls.append((name, int(np.count_nonzero(args[3])), start, end))
        return out

    engine._call = timed
    return calls


def _drive(engine, calls):
    """The user's loop: step until idle. Returns (wall s, [(step wall s,
    its program calls)])."""
    steps = []
    t0 = time.perf_counter()
    while engine.has_work():
        first, ts = len(calls), time.perf_counter()
        engine.step()
        steps.append((time.perf_counter() - ts, calls[first:]))
    return time.perf_counter() - t0, steps


def serve_llama(inference, llama, model, card: str) -> dict:
    """Phase 7. Returns the serving numbers."""
    cfg = inference.EngineConfig(**SERVE)
    prompts = serve_prompts(model.config.vocab_size)
    # The solo request, alone on an engine of its own (phase 7b repeats it
    # through Serve), freed before the load's engine starts, so the load's
    # stats, memory and timings are of the load alone.
    t0 = time.perf_counter()
    engine = inference.InferenceEngine(cfg, model=model)
    solo = engine.add_request(solo_prompt(model.config.vocab_size),
                              max_new_tokens=NEW_TOKENS)
    engine.run_until_idle()
    solo_s = time.perf_counter() - t0
    engine.check_no_leaks()
    if len(solo.generated) != NEW_TOKENS:
        raise AssertionError("the solo request did not get its tokens")
    solo_tokens = [int(t) for t in solo.generated]
    print(f"  solo request ({SOLO_LEN} prompt tokens, {NEW_TOKENS} new) on "
          f"an engine of its own: {solo_s:.2f} s")
    del engine, solo
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = inference.InferenceEngine(cfg, model=model)
    arena_gib = sum(k.numel() * k.element_size() * 2
                    for k, _ in engine._arenas) / 2 ** 30
    calls = _timed_calls(engine)
    reqs = [engine.add_request(p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    wall, steps = _drive(engine, calls)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = engine.stats()
    engine.check_no_leaks()
    if any(r.state != "FINISHED" or len(r.generated) != NEW_TOKENS
           for r in reqs):
        raise AssertionError("a request did not get its tokens")
    shapes = {k: stats[f"{k}_compiles"] for k in ("prefill", "decode")}
    hit_rate = stats["prefix_cache"]["hit_rate"]
    if shapes != {"prefill": 1, "decode": 1} or not hit_rate > 0:
        raise AssertionError(f"programs saw {shapes} shapes, prefix hit rate "
                             f"{hit_rate}")
    ms = {name: [] for name in ("prefill", "decode")}
    tokens = dict.fromkeys(ms, 0)
    for name, n, start, end in calls:
        ms[name].append((start.elapsed_time(end), n))
        tokens[name] += n
    decode8 = [t for t, n in ms["decode"] if n == cfg.batch_slots]
    step8 = [1e3 * dt for dt, cs in steps
             if [c[0] for c in cs] == ["decode"]
             and cs[0][1] == cfg.batch_slots]
    ttft = np.asarray([1e3 * (r.first_token_at - r.submitted_at)
                       for r in reqs])
    out = {
        "requests": len(reqs), "new_tokens": NEW_TOKENS,
        "prompt_tokens": sum(map(len, prompts)),
        "prefilled_tokens": tokens["prefill"],
        "cached_tokens": sum(r.cached_tokens for r in reqs),
        "prefix_hit_rate": hit_rate,
        "prefill_tokens_per_s": 1e3 * tokens["prefill"]
        / sum(t for t, _ in ms["prefill"]),
        "decode_tokens_per_s": 1e3 * tokens["decode"]
        / sum(t for t, _ in ms["decode"]),
        "output_tokens_per_s": len(reqs) * NEW_TOKENS / wall,
        "wall_s": wall, "steps": len(steps),
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "decode_ms_at_8_slots": statistics.mean(decode8),
        "decode_step_wall_ms_at_8_slots": statistics.mean(step8),
        "decode_calls_at_8_slots": len(decode8),
        "prefill_chunk_ms": statistics.mean(
            t for t, n in ms["prefill"] if n == cfg.prefill_chunk),
        "peak_gib": peak_gib, "arena_gib": arena_gib, "card": card,
        "solo_tokens": solo_tokens, "solo_s": solo_s,
    }
    print(f"  {len(reqs)} requests served in {wall:.2f} s over {len(steps)} "
          f"steps: "
          f"{out['prompt_tokens']} prompt tokens ({out['cached_tokens']} from "
          f"the prefix cache, hit rate {hit_rate:.3f}), {len(reqs)} x "
          f"{NEW_TOKENS} new; no leaks; one shape per program")
    print(f"  prefill {out['prefill_tokens_per_s']:.1f} tokens/s "
          f"({out['prefill_chunk_ms']:.3f} ms a {cfg.prefill_chunk}-token "
          f"chunk), decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s, output "
          f"{out['output_tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, p99 {out['ttft_p99_ms']:.1f} ms; "
          f"decode step at 8 busy slots {out['decode_ms_at_8_slots']:.3f} ms"
          f" (device span, {len(decode8)} steps; "
          f"{out['decode_step_wall_ms_at_8_slots']:.3f} ms wall a step); "
          f"peak {peak_gib:.2f} GiB (arena {arena_gib:.2f} GiB); card {card}")

    # How far the served bf16 tokens follow a bf16 dense-cache loop: shown,
    # not held. 32 random bf16 layers put the logits ~8% (rms) from the
    # float32 model's (phase 6), far above the near-tie margin, so two bf16
    # orders of the same sums part at ordinary steps; the tokens are held
    # in float32 below.
    follow = []
    for i in range(N_COMPARED):
        toks, ties = dense_greedy(llama, engine._model, prompts[i],
                                  NEW_TOKENS)
        follow.append(leading_agreement(reqs[i].generated, toks))
    plain = [r.generated for r in reqs]
    out["bf16_tokens"] = [[int(t) for t in r] for r in plain]
    print(f"  bf16: requests 0..{N_COMPARED - 1} follow the bf16 dense-cache "
          f"loop for their first {follow} of {NEW_TOKENS} tokens")
    out["bf16_dense_agreement"] = follow
    del engine, reqs, calls
    gc.collect()
    torch.cuda.empty_cache()

    spec = inference.InferenceEngine(dataclasses.replace(
        cfg, spec_decode_draft_len=SPEC_DRAFT_LEN), model=model)
    sreqs = [spec.add_request(prompts[i], max_new_tokens=SPEC_TOKENS)
             for i in range(SPEC_REQUESTS)]
    swall, _ = _drive(spec, [])
    sd = check_spec(spec, sreqs)
    follow = [leading_agreement(r.generated, plain[i])
              for i, r in enumerate(sreqs)]
    out["spec"] = {"draft_len": SPEC_DRAFT_LEN,
                   "draft_layers": spec._draft_model.config.n_layer,
                   "accept_rate": sd["accept_rate"],
                   "mean_accepted": sd["mean_accepted"],
                   "rounds": sd["rounds"], "wall_s": swall,
                   "output_tokens_per_s": SPEC_REQUESTS * SPEC_TOKENS / swall,
                   "bf16_plain_agreement": follow}
    print(f"  speculative leg (draft {SPEC_DRAFT_LEN}, "
          f"{out['spec']['draft_layers']}-layer draft): {SPEC_REQUESTS} x "
          f"{SPEC_TOKENS} tokens in {swall:.2f} s, accept rate "
          f"{sd['accept_rate']:.4f} ({sd['rounds']} rounds); no leaks; one "
          f"shape per program; follows the plain bf16 engine for the first "
          f"{follow} tokens")
    del spec, sreqs
    gc.collect()
    torch.cuda.empty_cache()
    out["float32"] = check_float32(inference, llama, model, prompts)
    return out


# Phase 7c: Llama-7B at tp 2, two processes sharing card 0 over gloo. Its
# bf16 leg serves the first TP_REQUESTS of phase 7's prompts (4 of them
# with the shared prefix) with TP_TOKENS new tokens each (held against
# phase 7's first TP_TOKENS); the speculative leg TP_SPEC_REQUESTS of them
# with TP_SPEC_TOKENS; the float32 leg phase 7's float32 requests
# (`check_float32`'s budgets).
TP_REQUESTS, TP_TOKENS = 8, 16   # 32 before phase 4k came
TP_SPEC_REQUESTS, TP_SPEC_TOKENS = 2, 8   # 32 before phase 4j came
# The phase's time budget, printed beside its time and not enforced: it is
# not met on every host yet (ROADMAP, open items). Every collective of the
# two ranks crosses loopback TCP, and the phase prints the host time spent
# inside them beside the decode step's.
TP_SERVE_BUDGET_S = 90.0


def count_exchanges(dist) -> collections.Counter:
    """Count this process's collectives by name from now on: every
    all-reduce, all-gather and broadcast (a record's `broadcast_object_list`
    is two broadcasts), wherever it is called from, and under "host_s" the
    host seconds spent inside them (a gloo collective on CUDA tensors waits
    for the stream, copies to the host, crosses loopback TCP and copies
    back)."""
    from torch.distributed import distributed_c10d as c10d

    counts = collections.Counter()
    for name in ("all_reduce", "all_gather_into_tensor", "broadcast"):
        real = getattr(c10d, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            counts[_name] += 1
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                counts["host_s"] += time.perf_counter() - t0

        setattr(c10d, name, counted)
        setattr(dist, name, counted)
    return counts


def tp_serve_leg(engine, prompts, budgets, exchanges=None) -> dict:
    """One leg of phase 7c on the leader: serve `prompts` (each its budget
    of new tokens, all submitted at once) to the end, time each program
    call (with `exchanges`, also count the collectives in it and time the
    host inside them), send the stop record. Returns the tokens and the
    leg's numbers."""
    calls = _timed_calls(engine)
    per_call = []
    if exchanges is not None:
        timed = engine._call

        def counted(name, fn, arenas, *args):
            before = dict(exchanges)
            t0 = time.perf_counter()
            out = timed(name, fn, arenas, *args)
            n = sum(v - before.get(k, 0) for k, v in exchanges.items()
                    if k != "host_s")
            per_call.append((name, int(np.count_nonzero(args[3])), n,
                             exchanges["host_s"] - before.get("host_s", 0),
                             time.perf_counter() - t0))
            return out

        engine._call = counted
    reqs = [engine.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    wall, steps = _drive(engine, calls)
    engine.stop_followers()
    torch.cuda.synchronize()
    if any(r.state != "FINISHED" or len(r.generated) != n
           for r, n in zip(reqs, budgets)):
        raise AssertionError("7c: a request did not get its tokens")
    batch = engine.config.batch_slots
    step_full = [1e3 * dt for dt, cs in steps
                 if [c[0] for c in cs] == ["decode"] and cs[0][1] == batch]
    decode = [start.elapsed_time(end) for name, n, start, end in calls
              if name == "decode" and n == min(batch, len(reqs))]
    full = [(inside, took) for name, rows, n, inside, took in per_call
            if name == "decode" and rows == batch]
    programs = {}
    for name, rows, n, inside, took in per_call:
        calls_n, exchanges_n, inside_s, took_s = programs.get(
            name, (0, 0, 0.0, 0.0))
        programs[name] = (calls_n + 1, exchanges_n + n, inside_s + inside,
                          took_s + took)
    return {"tokens": [[int(t) for t in r.generated] for r in reqs],
            "wall_s": wall, "steps": len(steps),
            "output_tokens_per_s": sum(budgets) / wall,
            "decode_step_wall_ms_at_8_slots": (statistics.mean(step_full)
                                               if step_full else None),
            "decode_ms": statistics.mean(decode) if decode else None,
            "decode_calls": len(decode),
            "exchanges_per_decode": sorted({n for name, rows, n, *_
                                            in per_call
                                            if name == "decode"}),
            "decode_call_ms": (1e3 * statistics.mean(w for _, w in full)
                               if full else None),
            "decode_exchange_ms": (1e3 * statistics.mean(i for i, _ in full)
                                   if full else None),
            "programs": programs}


def tp_serve_rank(rank: int, port: int, prompts, budgets,
                  result_queue) -> None:
    """Phase 7c: one of two tp ranks of Llama-7B on card 0, over a gloo
    group (CUDA tensors in its collectives, the step records on the
    CPU). Each rank draws the seed-0 weights one parameter at a time and
    keeps its shard (`Llama(mesh=)`); rank 0's engines schedule, rank 1's
    follow. (a) bf16: phase 7's engine configuration, the arena split in
    two; (b) speculative, draft length SPEC_DRAFT_LEN; (c) the same
    weights computing in float32 on phase 7's float32 requests. Every
    engine: no leaks, one shape a program on both ranks. Puts (rank,
    error, record): rank 0's tokens and times, each rank's KV heads, peak
    memory and kernel launches."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    t_start = time.perf_counter()

    def say(what: str) -> None:
        print(f"  tp serving rank {rank}: {what} "
              f"({time.perf_counter() - t_start:.1f} s)", flush=True)

    try:
        if not torch.cuda.is_available():
            raise RuntimeError("phase 7c: a tp rank without CUDA")
        import datetime

        import torch.distributed as dist

        from ray_tpu_torch import inference
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.parallel import MeshSpec, build_mesh

        torch.cuda.set_device(0)
        exchanges = count_exchanges(dist)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=2, timeout=datetime.timedelta(seconds=300))
        mesh = build_mesh(MeshSpec({"tp": 2}))
        torch.cuda.reset_peak_memory_stats()
        attn.reset_kernel_launches()
        t0 = time.perf_counter()
        model = llama.Llama(llama.LlamaConfig.llama7b(), seed=0, mesh=mesh)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - t0,
               "model_gib": torch.cuda.memory_allocated() / 2 ** 30}
        say(f"Llama-7B's shards from seed 0 in {rec['build_s']:.1f} s, "
            f"{rec['model_gib']:.2f} GiB")
        cfg = inference.EngineConfig(**SERVE)
        legs = (("a", cfg, model, prompts[:TP_REQUESTS],
                 [TP_TOKENS] * TP_REQUESTS),
                ("b", dataclasses.replace(
                    cfg, spec_decode_draft_len=SPEC_DRAFT_LEN), model,
                 prompts[:TP_SPEC_REQUESTS],
                 [TP_SPEC_TOKENS] * TP_SPEC_REQUESTS),
                ("c", inference.EngineConfig(**dict(
                    SERVE, num_blocks=SPEC_REQUESTS
                    * SERVE["max_blocks_per_seq"] + 1)),
                 None, prompts[:len(budgets)], budgets))
        for leg, leg_cfg, leg_model, leg_prompts, leg_budgets in legs:
            if leg_model is None:    # (c): the same shards, in float32
                leg_model = llama.Llama(
                    dataclasses.replace(model.config, dtype=torch.float32),
                    state=model.state_dict(), mesh=mesh)
            engine = inference.InferenceEngine(leg_cfg, model=leg_model,
                                               mesh=mesh)
            arenas = engine._arenas
            out = {"kv_heads": arenas[0][0].shape[2],
                   "arena_gib": sum(k.numel() * k.element_size() * 2
                                    for k, _ in arenas) / 2 ** 30}
            if engine.is_leader:
                out.update(tp_serve_leg(
                    engine, leg_prompts, leg_budgets,
                    exchanges if leg in "ab" else None))
            else:
                out["followed"] = engine.follow()
            st = engine.stats()
            engine.check_no_leaks()
            sd = st["spec_decode"]
            out["shapes"] = [st["prefill_compiles"], st["decode_compiles"],
                             sd["draft_prefill_compiles"],
                             sd["propose_compiles"], sd["verify_compiles"]]
            out["accept_rate"] = sd["accept_rate"]
            rec[leg] = out
            del engine, arenas, leg_model
            gc.collect()
            torch.cuda.empty_cache()
            say(f"leg ({leg}) done")
        rec["launches"] = attn.kernel_launches()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        dist.barrier()
        dist.destroy_process_group()
        result_queue.put((rank, None, rec))
    except BaseException:  # noqa: BLE001 — the phase fails on it
        result_queue.put((rank, traceback.format_exc(), None))


def tp_serving_phase(card: str, serving: dict) -> dict:
    """Phase 7c: Llama-7B served at tp 2 by two processes on card 0
    (`tp_serve_rank`). Holds (a)'s and (b)'s engines to every token, no
    leaks and one shape a program on both ranks, each rank's arena to 4 of
    the 8 KV heads, (c)'s float32 tokens to phase 7's dense-cache float32
    loop up to its first near tie (phase 7's references, not run again),
    each rank's peak memory below phase 7's and no kernel of the port
    launched in either process; prints the phase's time beside
    TP_SERVE_BUDGET_S. Returns the phase's record."""
    import multiprocessing
    import socket

    from ray_tpu_torch.models.llama import LlamaConfig

    t0 = time.perf_counter()
    prompts = serve_prompts(LlamaConfig.llama7b().vocab_size)
    f32 = serving["float32"]
    budgets, refs = f32["budgets"], f32.pop("refs")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    procs = [mp.Process(target=tp_serve_rank,
                        args=(r, port, prompts, budgets, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        outs = {}
        deadline = time.monotonic() + 600
        while len(outs) < len(procs):
            try:
                rank, error, value = queue.get(timeout=5)
            except Exception:  # queue.Empty: is every rank still alive?
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in outs]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"7c: tp ranks ended without a "
                                         f"result (rank, exit code): {dead}")
                continue
            if error is not None:
                raise AssertionError(f"7c: tp rank {rank} failed:\n{error}")
            outs[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    lead, follower = outs[0], outs[1]
    a, b, c = lead["a"], lead["b"], lead["c"]
    plain = serving["bf16_tokens"]
    follow = [leading_agreement(got, plain[i][:TP_TOKENS])
              for i, got in enumerate(a["tokens"])]
    compared = [agree_until_tie(got, ref[0][:n], ref[1][:n])
                for got, ref, n in zip(c["tokens"], refs, budgets)]
    ratio = [o["peak_gib"] / serving["peak_gib"] for o in (lead, follower)]
    print(f"  (a) bf16, {TP_REQUESTS} of phase 7's requests x {TP_TOKENS} "
          f"new tokens at once: {a['wall_s']:.2f} s over {a['steps']} "
          f"steps, output {a['output_tokens_per_s']:.1f} tokens/s (phase 7 "
          f"{serving['output_tokens_per_s']:.1f} at tp 1, 16 x "
          f"{NEW_TOKENS}); a decode step at 8 busy slots "
          f"{a['decode_step_wall_ms_at_8_slots']:.3f} ms wall, "
          f"{a['decode_ms']:.3f} ms between CUDA events on rank 0 "
          f"({a['decode_calls']} steps; phase 7 "
          f"{serving['decode_step_wall_ms_at_8_slots']:.3f} ms wall); "
          f"{a['exchanges_per_decode']} gloo collectives a decode step "
          f"(the record's two broadcasts among them), a decode call "
          f"{a['decode_call_ms']:.3f} ms on rank 0's host clock, "
          f"{a['decode_exchange_ms']:.3f} ms of it inside those "
          f"collectives; follows phase 7's bf16 tokens for the first "
          f"{follow} of {TP_TOKENS}")
    print(f"  (b) speculative, draft {SPEC_DRAFT_LEN}, {TP_SPEC_REQUESTS} x "
          f"{TP_SPEC_TOKENS} tokens: {b['wall_s']:.2f} s, accept rate "
          f"{b['accept_rate']:.4f}; by program (calls, gloo collectives, s "
          f"inside them, s on rank 0's host clock): {b['programs']}")
    print(f"  (c) float32: agrees with phase 7's dense-cache float32 loop on "
          f"{compared} tokens of {budgets} (each up to its first near tie)")
    for r, o in enumerate((lead, follower)):
        print(f"  rank {r}: KV heads {[o[x]['kv_heads'] for x in 'abc']} of "
              f"8, arena {o['a']['arena_gib']:.2f} GiB, shapes a program "
              f"{[o[x]['shapes'] for x in 'abc']}, peak {o['peak_gib']:.2f} "
              f"GiB ({ratio[r]:.4f} of phase 7's {serving['peak_gib']:.2f}), "
              f"model shards {o['model_gib']:.2f} GiB in {o['build_s']:.1f} "
              f"s, launches {o['launches']}")
    print(f"  phase 7c took {wall:.1f} s (budget {TP_SERVE_BUDGET_S:.0f} s"
          f"{'' if wall <= TP_SERVE_BUDGET_S else ', over it'}); {card}")
    for r, o in enumerate((lead, follower)):
        want = {"a": [1, 1, 0, 0, 0], "b": [1, 0, 1, 1, 1],
                "c": [1, 1, 0, 0, 0]}
        if any(o[x]["kv_heads"] != 4 or o[x]["shapes"] != want[x]
               for x in "abc"):
            raise AssertionError(f"7c: rank {r}: KV heads or shapes: {o}")
        if any(o["launches"].values()):
            raise AssertionError(f"7c: rank {r} launched {o['launches']}")
        if not ratio[r] < 1.0:
            raise AssertionError(f"7c: rank {r}'s peak {o['peak_gib']:.2f} "
                                 f"GiB is not below phase 7's")
    return {"card": card, "wall_s": wall, "bf16": {
                k: a[k] for k in ("wall_s", "steps", "output_tokens_per_s",
                                  "decode_step_wall_ms_at_8_slots",
                                  "decode_ms", "exchanges_per_decode",
                                  "decode_call_ms", "decode_exchange_ms")},
            "bf16_phase7_agreement": follow,
            "spec": {"accept_rate": b["accept_rate"], "wall_s": b["wall_s"],
                     "programs": b["programs"]},
            "float32_compared": compared, "budgets": budgets,
            "peak_gib": [lead["peak_gib"], follower["peak_gib"]],
            "phase7_peak_gib": serving["peak_gib"], "peak_ratio": ratio,
            "kv_heads": 4, "records_followed": {
                x: follower[x]["followed"] for x in "abc"},
            "launches": {name: lead["launches"][name]
                         + follower["launches"][name]
                         for name in lead["launches"]}}


def leading_agreement(got, want) -> int:
    n = 0
    while n < min(len(got), len(want)) and got[n] == want[n]:
        n += 1
    return n


def check_spec(spec, sreqs) -> dict:
    """No leaks, one shape per program, every token: the spec stats."""
    st = spec.stats()
    spec.check_no_leaks()
    sd = st["spec_decode"]
    shapes = [st["prefill_compiles"], sd["draft_prefill_compiles"],
              sd["propose_compiles"], sd["verify_compiles"]]
    if shapes != [1, 1, 1, 1] or any(len(r.generated) != SPEC_TOKENS
                                     for r in sreqs):
        raise AssertionError(f"speculative leg: programs saw {shapes} "
                             "shapes, or a request missed tokens")
    return sd


def check_float32(inference, llama, model, prompts) -> dict:
    """The engine's tokens against the dense-cache greedy loop, on the same
    weights computing in float32 (where the two differ only in summation
    order): requests 0..N_COMPARED-1 with NEW_TOKENS each and the rest of
    the first SPEC_REQUESTS with SPEC_TOKENS, served together; then the
    speculative engine's against the plain engine's. Each agrees up to the
    reference's first near tie, the first token always."""
    exact = llama.Llama(dataclasses.replace(model.config,
                                            dtype=torch.float32),
                        device=model.device, state=model.state_dict())
    budgets = [NEW_TOKENS] * N_COMPARED + [SPEC_TOKENS] * (SPEC_REQUESTS
                                                           - N_COMPARED)
    cfg = inference.EngineConfig(**dict(
        SERVE, num_blocks=SPEC_REQUESTS * SERVE["max_blocks_per_seq"] + 1))
    engine = inference.InferenceEngine(cfg, model=exact)
    reqs = [engine.add_request(prompts[i], max_new_tokens=n)
            for i, n in enumerate(budgets)]
    engine.run_until_idle()
    engine.check_no_leaks()
    plain = [r.generated for r in reqs]
    del engine, reqs
    refs = [dense_greedy(llama, exact, prompts[i], n)
            for i, n in enumerate(budgets)]
    compared = [agree_until_tie(got, *ref) for got, ref in zip(plain, refs)]
    print(f"  float32: the engine agrees with the dense-cache greedy loop on "
          f"{compared} tokens of {budgets} (each up to the reference's first "
          f"near tie)")
    spec = inference.InferenceEngine(dataclasses.replace(
        cfg, spec_decode_draft_len=SPEC_DRAFT_LEN), model=exact)
    sreqs = [spec.add_request(prompts[i], max_new_tokens=SPEC_TOKENS)
             for i in range(SPEC_REQUESTS)]
    spec.run_until_idle()
    sd = check_spec(spec, sreqs)
    spec_compared = [agree_until_tie(r.generated, plain[i][:SPEC_TOKENS],
                                     refs[i][1][:SPEC_TOKENS])
                     for i, r in enumerate(sreqs)]
    print(f"  float32: the speculative engine (accept rate "
          f"{sd['accept_rate']:.4f}) agrees with the plain one on "
          f"{spec_compared} tokens of {SPEC_TOKENS}")
    del spec, sreqs, exact
    gc.collect()
    torch.cuda.empty_cache()
    return {"compared": compared, "budgets": budgets,
            "spec_compared": spec_compared,
            "spec_accept_rate": sd["accept_rate"],
            "refs": refs}


def probed(dep):
    """`dep` with one method more on its class, `probe()`: the replica's
    pid, the CUDA_VISIBLE_DEVICES it sees, its peak card memory, its kernel
    launch counts, for a sampler the forwards it ran, and for `LLMServer`
    the engine steps it ran, their wall time and each request's TTFT as the
    engine took it (submit to first token; None before it). The
    deployment's own methods are untouched."""
    from ray_tpu_torch import serve

    base = dep._target

    class Probed(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._steps, self._reqs = [0, 0.0], []
            engine = getattr(self, "_engine", None)
            if engine is not None:
                step, add = engine.step, engine.add_request

                def timed_step():
                    t0 = time.perf_counter()
                    try:
                        return step()
                    finally:
                        self._steps[0] += 1
                        self._steps[1] += time.perf_counter() - t0

                def recorded_add(*args, **kwargs):
                    req = add(*args, **kwargs)
                    self._reqs.append(req)
                    return req

                engine.step, engine.add_request = timed_step, recorded_add

        def probe(self, _=None):
            from ray_tpu_torch.ops import attention

            return {"pid": os.getpid(),
                    "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "launches": attention.kernel_launches(),
                    "forwards": getattr(self, "forwards", None),
                    "steps": self._steps[0], "step_s": self._steps[1],
                    "ttft_ms": [None if r.first_token_at is None else
                                1e3 * (r.first_token_at - r.submitted_at)
                                for r in self._reqs]}

    Probed.__name__ = Probed.__qualname__ = base.__name__
    return serve.Deployment(Probed, dep.name, dep.config)


def check_replica(rt, probe, what: str) -> None:
    """The replica is another process that sees card "0", and every GPU
    worker retired for its card has exited (not only been marked)."""
    if probe["pid"] == os.getpid() or probe["cuda_visible"] != "0":
        raise AssertionError(f"{what} replica: pid {probe['pid']}, sees "
                             f"{probe['cuda_visible']!r}")
    pool = rt._global_node.raylet.pool
    with pool._lock:
        handles = list(pool._workers.values())
    live = [h.pid for h in handles if h.gpu_ids and h.state != "dead"]
    lingering = [h.pid for h in handles if h.gpu_ids and h.state == "dead"
                 and h.proc is not None and h.proc.poll() is None]
    print(f"  {what} replica: pid {probe['pid']} (this process "
          f"{os.getpid()}), CUDA_VISIBLE_DEVICES={probe['cuda_visible']!r}; "
          f"live GPU workers {live}, retired ones still running "
          f"{lingering}")
    if lingering or live != [probe["pid"]]:
        raise AssertionError(f"{what}: GPU workers {live} live and "
                             f"{lingering} retired but running beside the "
                             "replica")


def wait_exited(pid: int, what: str, timeout_s: float = 60.0) -> float:
    """Seconds until process `pid` is gone; raises past the timeout."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return time.perf_counter() - t0
        time.sleep(0.1)
    raise AssertionError(f"{what} (pid {pid}) did not exit within "
                         f"{timeout_s} s")


def _stream(events, submitted):
    """Consume one token stream: (TTFT s, tokens, final event, end time).
    Raises when the stream fails or ends with no token."""
    first, toks, done = None, [], None
    for ev in events:
        if "token" in ev:
            first = first or time.perf_counter()
            toks.append(ev["token"])
        else:
            done = ev
    if first is None:
        raise AssertionError(f"a stream ended with no token: {done}")
    return first - submitted, toks, done, time.perf_counter()


def _http_events(port: int, payload: dict):
    """The proxy's chunked JSON lines for one streamed request."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/LLMServer",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            if line.strip():
                yield json.loads(line)


def serve_llm(card: str, serving: dict) -> dict:
    """Phase 7b, part 1: Llama-7B through `LLMServer` in a one-GPU replica.
    Returns the numbers printed."""
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.inference.api import LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig

    vocab = LlamaConfig.llama7b().vocab_size
    prompts, solo = serve_prompts(vocab), solo_prompt(vocab)
    dep = probed(LLMServer.options(num_replicas=1,
                                   ray_actor_options={"num_gpus": 1}))
    t0 = time.perf_counter()
    handle = serve.run(dep.bind(model_size="7b", engine_config=SERVE,
                                default_new_tokens=NEW_TOKENS),
                       timeout_s=900)
    run_s = time.perf_counter() - t0
    check_replica(rt, rt.get(handle.probe.remote()), "LLMServer")
    out = rt.get(handle.generate.remote({"ids": solo,
                                         "max_new_tokens": NEW_TOKENS}))
    ready_s = time.perf_counter() - t0
    if out["ids"][:SOLO_LEN] != solo \
            or out["ids"][SOLO_LEN:] != serving["solo_tokens"]:
        raise AssertionError("the solo request through Serve gave other "
                             "tokens than the engine driven directly")
    print(f"  serve.run {run_s:.2f} s; first reply (the solo request, "
          f"{NEW_TOKENS} tokens) {ready_s:.2f} s after serve.run: its "
          f"tokens equal phase 7's exactly")

    port = serve.http_port()
    before = rt.get(handle.probe.remote())
    m0 = rt.get(handle.metrics.remote())["prefix_cache"]
    n_req = len(prompts) + len(STREAMED) + len(OVER_HTTP)
    # Each stream is read on a thread of its own; .result() raises what its
    # thread raised, so a failed request fails the phase.
    with ThreadPoolExecutor(len(STREAMED) + len(OVER_HTTP)) as pool:
        submitted = time.perf_counter()
        streams = {("stream", i): pool.submit(
            _stream, handle.options(stream=True).stream.remote(
                {"ids": prompts[i], "max_new_tokens": NEW_TOKENS}),
            submitted) for i in STREAMED}
        refs = [handle.generate.remote({"ids": p,
                                        "max_new_tokens": NEW_TOKENS})
                for p in prompts]
        for i in OVER_HTTP:
            streams["http", i] = pool.submit(
                _stream, _http_events(port, {"ids": prompts[i],
                                             "max_new_tokens": NEW_TOKENS}),
                submitted)
        outs = rt.get(refs)
        results = {key: f.result() for key, f in streams.items()}
    wall = max([time.perf_counter()] + [r[3] for r in results.values()]) \
        - submitted
    if len(outs) + len(results) != n_req:
        raise AssertionError(f"{len(outs) + len(results)} of {n_req} "
                             "requests answered")
    for i, o in enumerate(outs):
        if o["ids"][:len(prompts[i])] != prompts[i] \
                or len(o["ids"]) != len(prompts[i]) + NEW_TOKENS:
            raise AssertionError(f"request {i} through Serve: "
                                 f"{len(o['ids'])} ids")
    for (kind, i), (_, toks, done, _) in results.items():
        if len(toks) != NEW_TOKENS or not done or not done.get("done") \
                or done["ids"] != prompts[i] + toks:
            raise AssertionError(f"{kind} request {i}: {len(toks)} tokens")
        if kind == "stream" and toks != outs[i]["ids"][len(prompts[i]):]:
            raise AssertionError(f"streamed request {i} gave other tokens "
                                 "than generate for the same prompt")
    m = rt.get(handle.metrics.remote())
    probe = rt.get(handle.probe.remote())
    leak = (m["running"], m["queue_depth"], m["kv"]["blocks_in_use"]
            - m["prefix_cache"]["cached_blocks"],
            m["prefix_cache"]["pinned_nodes"])
    shapes = (m["prefill_compiles"], m["decode_compiles"])
    if leak != (0, 0, 0, 0) or shapes != (1, 1):
        raise AssertionError(f"after the drain: running, queued, leaked "
                             f"blocks, pins {leak}; program shapes {shapes}")
    # TTFT of all the load's requests as the replica's engine took it
    # (its add_request to its first token), and apart, the client's submit
    # to first streamed token of the streamed ones.
    ttft = probe["ttft_ms"][len(before["ttft_ms"]):]
    if len(ttft) != n_req or None in ttft:
        raise AssertionError(f"the engine took {len(ttft)} of {n_req} "
                             f"requests, TTFTs {ttft}")
    ttft = np.asarray(ttft)
    client_ttft = {f"{kind} {i}": 1e3 * r[0]
                   for (kind, i), r in results.items()}
    pc = m["prefix_cache"]
    hit_rate = (pc["hits"] - m0["hits"]) / (pc["lookups"] - m0["lookups"])
    steps = probe["steps"] - before["steps"]
    step_s = probe["step_s"] - before["step_s"]
    res = {
        "requests": n_req, "new_tokens": NEW_TOKENS, "wall_s": wall,
        "output_tokens_per_s": n_req * NEW_TOKENS / wall,
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "ttft_ms": ttft.tolist(), "client_stream_ttft_ms": client_ttft,
        "serve_run_s": run_s,
        "replica_ready_s": ready_s, "replica_peak_gib": probe["peak_gib"],
        "prefix_hit_rate": hit_rate,
        "replica_launches": probe["launches"], "card": card,
        "engine_steps": steps, "engine_step_ms": 1e3 * step_s / steps,
        "engine_busy_share": step_s / wall,
        "tokens_per_step": n_req * NEW_TOKENS / steps,
    }
    print(f"  {len(prompts)} requests through handle.generate, "
          f"{len(STREAMED)} streamed through the handle and {len(OVER_HTTP)} "
          f"over HTTP (chunked JSON lines), all at once: every one "
          f"{NEW_TOKENS} tokens after its prompt; streams equal generate's "
          f"tokens; no leaks; one shape per program; prefix hit rate "
          f"{res['prefix_hit_rate']:.3f}; launches in the replica "
          f"{probe['launches']} (the paged path runs no kernel of the port)")
    print(f"  the replica's engine: {steps} steps, "
          f"{res['engine_step_ms']:.3f} ms a step (wall), busy "
          f"{res['engine_busy_share']:.4f} of the load's wall, "
          f"{res['tokens_per_step']:.3f} tokens a step; phase 7: "
          f"{serving['steps']} steps, "
          f"{1e3 * serving['wall_s'] / serving['steps']:.3f} ms a step, "
          f"{serving['requests'] * NEW_TOKENS / serving['steps']:.3f} "
          "tokens a step")
    print(f"  through Serve: {n_req} x {NEW_TOKENS} tokens in {wall:.2f} s, "
          f"output {res['output_tokens_per_s']:.1f} tokens/s; TTFT in the "
          f"replica's engine over the {n_req} requests p50 "
          f"{res['ttft_p50_ms']:.1f} ms, p99 {res['ttft_p99_ms']:.1f} ms; "
          f"client submit to first streamed token "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in client_ttft.items())
          + f"; replica ready {ready_s:.2f} s; replica peak "
          f"{probe['peak_gib']:.2f} GiB; card {card}")
    print(f"  phase 7, the engine driven directly in this process: "
          f"{serving['requests']} x {NEW_TOKENS} tokens in "
          f"{serving['wall_s']:.2f} s, output "
          f"{serving['output_tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{serving['ttft_p50_ms']:.1f} ms, p99 "
          f"{serving['ttft_p99_ms']:.1f} ms; peak "
          f"{serving['peak_gib']:.2f} GiB (Serve / direct tokens/s "
          f"{res['output_tokens_per_s'] / serving['output_tokens_per_s']:.4f}"
          ")")
    serve.shutdown()
    res["replica_exit_s"] = wait_exited(probe["pid"],
                                         "the LLMServer replica")
    print(f"  serve.shutdown(): the replica exited "
          f"{res['replica_exit_s']:.2f} s later")
    return res


def serve_gpt2(gpt2, card: str) -> dict:
    """Phase 7b, part 2: GPT2Sampler("small", max_seq=1024) in a one-GPU
    replica, against a plain greedy loop in this process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.examples import SAMPLER_BATCH, GPT2Sampler

    cfg = gpt2.GPT2Config.small()
    max_seq = 1024
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
               .tolist() for _ in range(SAMPLER_REQUESTS)]
    dep = probed(GPT2Sampler.options(num_replicas=1,
                                     ray_actor_options={"num_gpus": 1}))
    t0 = time.perf_counter()
    handle = serve.run(dep.bind("small", max_seq, SAMPLER_NEW),
                       timeout_s=600)
    check_replica(rt, rt.get(handle.probe.remote()), "GPT2Sampler")
    t1 = time.perf_counter()
    payloads = [{"ids": p, "max_new_tokens": SAMPLER_NEW} for p in prompts]
    outs = rt.get([handle.remote(p) for p in payloads])
    wall = time.perf_counter() - t1
    m = rt.get(handle.metrics.remote())
    probe = rt.get(handle.probe.remote())
    serve.shutdown()
    exit_s = wait_exited(probe["pid"], "the GPT2Sampler replica")
    launches, forwards = probe["launches"], probe["forwards"]
    want = {name: 0 for name in launches}
    want["flash_fwd"] = cfg.n_layer * forwards
    if launches != want or not m["mean_batch_size"] > 1:
        raise AssertionError(f"GPT2Sampler: launches {launches} for "
                             f"{forwards} forwards; mean batch size "
                             f"{m['mean_batch_size']}")

    # A plain greedy loop here on GPT-2-small from seed 0, one request at a
    # time, one forward of the request's own sequence a token, its next
    # token read at its own last position. None of the sampler's code runs
    # in it. The sequence sits in row 0 of an otherwise zero [SAMPLER_BATCH,
    # max_seq] batch only so that every product has the replica's shape
    # and so sums in its order (a row's result does not depend on the other
    # rows, nor, under the causal mask, on the positions after it): the
    # tokens must then agree exactly.
    model = gpt2.GPT2(cfg, device="cuda", seed=0).eval()
    batch = torch.zeros(SAMPLER_BATCH, max_seq, dtype=torch.long,
                        device="cuda")
    ref = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(SAMPLER_NEW):
                batch.zero_()
                batch[0, :len(seq)] = torch.tensor(seq)
                seq.append(int(model(batch)[0, len(seq) - 1].argmax()))
            ref.append(seq)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    got = [o["ids"] for o in outs]
    if got != ref:
        raise AssertionError(
            "GPT2Sampler's tokens differ from the plain greedy loop run "
            f"here: lengths {[len(g) for g in got]} vs "
            f"{[len(r) for r in ref]}, first difference at "
            f"{[leading_agreement(g, r) for g, r in zip(got, ref)]}")
    res = {"requests": len(prompts), "new_tokens": SAMPLER_NEW,
           "wall_s": wall, "serve_run_s": t1 - t0,
           "output_tokens_per_s": len(prompts) * SAMPLER_NEW / wall,
           "mean_batch_size": m["mean_batch_size"],
           "batches": m["batches_served"], "forwards": forwards,
           "launches": launches, "replica_peak_gib": probe["peak_gib"],
           "replica_exit_s": exit_s, "card": card}
    print(f"  GPT2Sampler small, max_seq {max_seq}: {len(prompts)} requests "
          f"of {SAMPLER_NEW} tokens in {wall:.2f} s "
          f"({res['output_tokens_per_s']:.1f} tokens/s) in "
          f"{m['batches_served']} batches (mean size "
          f"{m['mean_batch_size']:.2f}), {forwards} forwards; K1 launched "
          f"{launches['flash_fwd']} times in the replica = {cfg.n_layer} x "
          f"forwards; tokens equal the plain greedy loop here exactly; replica "
          f"peak {probe['peak_gib']:.2f} GiB, exited {exit_s:.2f} s after "
          f"serve.shutdown()")
    return res


def synthetic_atari_env(n_envs: int, seed: int = 0):
    """The Atari-native synthetic env of the reference's Atari test: random
    210x160x3 uint8 frames, 4 actions, reward 1 for action 1, episodes of
    32 steps. Stands in for ALE, which this machine does not have. The
    class is made inside the function, which rollout workers receive by
    value."""
    from ray_tpu_torch.rllib.env import VectorEnv

    class SyntheticAtariEnv(VectorEnv):
        n_actions = 4

        def __init__(self, n_envs: int, seed: int = 0):
            self.n_envs = n_envs
            self._rng = np.random.default_rng(seed)
            self._t = np.zeros(n_envs, dtype=np.int32)

        @property
        def obs_shape(self):
            return (210, 160, 3)

        @property
        def obs_dtype(self):
            return np.uint8

        def reset(self):
            self._t[:] = 0
            return self._obs()

        def _obs(self):
            return self._rng.integers(0, 255,
                                      (self.n_envs, *self.obs_shape),
                                      dtype=np.uint8)

        def step(self, actions):
            self._t += 1
            rewards = (np.asarray(actions) == 1).astype(np.float32)
            dones = self._t >= 32
            infos = {}
            if dones.any():
                infos["final_obs"] = self._obs()
                self._t[dones] = 0
            return self._obs(), rewards, dones, infos

    return SyntheticAtariEnv(n_envs, seed)


# RLlib phase, two updates held against the CPU's. The port's
# resolve_device turns TF32 off, so both sides compute in full float32.
# Float32 against float64 on the CPU, same weights and batch, read 1.4e-7
# relative on the loss and 4.7e-5 on the gradient norm (a norm over 1.7M
# gradients of sums over 500 rows x 400 positions). Adam's first step is lr
# times the sign of each gradient, so the weights after it differ only
# where a gradient is too small to keep its sign: lr/10 (the card read
# 0.04 lr on an H100). The second step is m / sqrt(v) of two gradients,
# which is sensitive where they nearly cancel: lr/2 (the card read 0.19
# lr); a lost or doubled step is ~lr. With TF32 on, the same updates read
# 1.9e-4 on the loss and on the gradient norm and 3.3 lr on the weights:
# the limits must catch that, or they could not tell TF32 from float32.
PPO_ITERS = 2               # timed after the warm-up one (3 before 4k)
RL_LOSS_TOL = 1e-4          # relative, the loss, each metric, the grad norm
RL_WEIGHT_TOLS_LR = (0.1, 0.5)  # after steps 1 and 2, in units of lr
RL_VTRACE_TOL = 1e-5        # |card - cpu| <= tol * (|cpu| + 1)


def sgd_step_flops(module, rows: int) -> float:
    """Floating-point operations of one SGD step of `module`'s net on
    `rows` rows: each layer's multiply-adds in the forward, as many again
    for its weight gradient and, for every layer but the first (the
    observations need no gradient), for its data gradient; two operations
    a multiply-add. Counted on one row of a CPU copy of the net."""
    net = module.build("cpu")
    macs = []

    def count(layer, inputs, out):
        macs.append(out[0].numel() * layer.weight[0].numel())

    for layer in net.modules():
        if isinstance(layer, (torch.nn.Conv2d, torch.nn.Linear)):
            layer.register_forward_hook(count)
    with torch.no_grad():
        net(torch.zeros((1,) + tuple(module.spec.obs_shape),
                        dtype=torch.uint8))
    return 2.0 * rows * (3 * sum(macs) - macs[0])


def _rl_update_profile(learner, stacked) -> dict:
    """Times `update_many` on a stacked epoch (its one copy of the epoch to
    the card included), untraced and then traced: wall ms a step, and per
    step the kernels' ms, the copies' ms, the kernel launches and the
    largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    n = len(next(iter(stacked.values())))
    learner.update_many(stacked)  # warm-up (cuDNN picks its algorithms)
    t0 = time.perf_counter()
    learner.update_many(stacked)  # ends in a sync (its metrics)
    wall = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        learner.update_many(stacked)
    by_name = collections.Counter()
    kernels = copies = 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            by_name[e.name] += e.device_time_total / 1e3 / n
            if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
                copies += 1
            else:
                kernels += 1
    copy_ms = sum(ms for name, ms in by_name.items()
                  if name.startswith(("Memcpy", "Memset")))
    kernel_ms = sum(by_name.values()) - copy_ms
    if kernel_ms <= 0:
        raise AssertionError("the trace of the SGD steps holds no kernel "
                             "time")
    return {"ms_per_sgd_step_untraced": wall,
            "kernels_ms_per_sgd_step": kernel_ms,
            "copies_ms_per_sgd_step": copy_ms,
            "launches_per_sgd_step": kernels / n,
            "copies_per_sgd_step": copies / n,
            "host_share": 1 - (kernel_ms + copy_ms) / wall,
            "top_kernels_ms_per_sgd_step": [
                (name[:90], ms) for name, ms in by_name.most_common(8)]}


def rllib_phase(attn, card: str) -> dict:
    """Phase 11b: RLlib on the card, at the width of the reference's Atari
    PPO configuration (`tuned_examples._atari_ppo_config`) on the synthetic
    Atari env through `atari_connectors()` (84x84x4 uint8 frames)."""
    import dataclasses
    import functools
    import types

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.connectors import atari_connectors
    from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
    from ray_tpu_torch.rllib.env import CatchVectorEnv
    from ray_tpu_torch.rllib.impala import (IMPALA, IMPALALearner,
                                            vtrace_returns)
    from ray_tpu_torch.rllib.ppo import PPO, PPOLearner
    from ray_tpu_torch.rllib.rl_module import ConvPolicyModule, SpecDict
    from ray_tpu_torch.rllib.rollout import WorkerSet
    from ray_tpu_torch.rllib.tuned_examples import (_atari_impala_config,
                                                    _atari_ppo_config)

    before = attn.kernel_launches()
    cfg = _atari_ppo_config("ALE/Breakout-v5")
    cfg.env, cfg.connectors = synthetic_atari_env, atari_connectors()
    mb = cfg.sgd_minibatch_size
    res = {"card": card, "config": {
        k: getattr(cfg, k) for k in (
            "num_rollout_workers", "num_envs_per_worker",
            "rollout_fragment_length", "sgd_minibatch_size", "num_sgd_iter",
            "lr", "clip_param", "vf_clip_param", "entropy_coeff",
            "lambda_")}}

    print(f"  1. two PPOLearner.updates on the card against the CPU's: "
          f"2 x {mb} rows of 84x84x4 uint8 frames, the Nature CNN, in "
          f"float32 and again with TF32 on; the batch sampled by two "
          f"rollout workers on the card")
    workers = WorkerSet(synthetic_atari_env, num_workers=2, n_envs=4,
                        seed=0, device="cuda", connectors=atari_connectors())
    try:
        visible = rt.get([w.cuda_visible_devices.remote()
                          for w in workers.workers])
        frags = workers.sample(-(-mb // 4))
    finally:
        workers.shutdown()
    print(f"    the rollout workers on the card see CUDA_VISIBLE_DEVICES="
          f"{visible}")
    if visible != ["0", "0"]:
        raise AssertionError("a rollout worker on the card was granted no "
                             "card")
    processed = sb.concat_batches([PPO._postprocess(
        types.SimpleNamespace(config=cfg), f) for f in frags])
    processed[sb.ADVANTAGES] = sb.standardize(processed[sb.ADVANTAGES])
    view = PPO._learner_view(processed)
    batches = [{k: v[i * mb:(i + 1) * mb] for k, v in view.items()}
               for i in range(2)]
    batch = batches[0]
    module = ConvPolicyModule(SpecDict(84 * 84 * 4, 4, (84, 84, 4)))
    cpu = PPOLearner(module, dataclasses.replace(cfg, device="cpu"),
                     seed=cfg.seed)
    start = cpu.get_weights()

    def two_updates(learner):
        metrics, weights = [], []
        for b in batches:
            metrics.append(learner.update(b))
            weights.append(learner.get_weights())
        return metrics, weights

    want, w_cpu = two_updates(cpu)
    w_tols = [tol * cfg.lr for tol in RL_WEIGHT_TOLS_LR]
    update = {"cpu": want, "loss_tol": RL_LOSS_TOL, "weight_tols": w_tols,
              "n_params": sum(v.numel() for v in start.values())}
    learners = {}
    for precision in ("float32", "tf32"):
        gpu = learners[precision] = PPOLearner(module, cfg, seed=cfg.seed)
        gpu.set_weights(start)  # resolve_device turned TF32 off
        tf32 = precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            got, w_gpu = two_updates(gpu)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        worst_w = [max((g[k] - w[k]).abs().max().item() for k in w)
                   for g, w in zip(w_gpu, w_cpu)]
        rel = {k: [abs(g[k] - w[k]) / max(abs(w[k]), 1e-2)
                   for g, w in zip(got, want)] for k in want[0]}
        within = all(d <= tol for d, tol in zip(worst_w, w_tols)) and all(
            max(r) <= RL_LOSS_TOL for r in rel.values())
        update[precision] = {"card": got, "relative": rel,
                             "max_weight_diff": worst_w,
                             "within_limits": within}
        print(f"    {precision} ({update['n_params']} parameters), "
              f"relative to the CPU in updates 1, 2 (limit "
              f"{RL_LOSS_TOL:.0e}):")
        for k, r in rel.items():
            print(f"      {k:12s} {r[0]:.2e}, {r[1]:.2e} (cpu "
                  f"{want[0][k]:.7f}, {want[1][k]:.7f})")
        print(f"      largest weight difference after steps 1, 2: "
              f"{worst_w[0]:.3e}, {worst_w[1]:.3e} (limits lr/10, lr/2 = "
              f"{w_tols[0]:.1e}, {w_tols[1]:.1e}; a step moves each weight "
              f"~lr); within every limit: {within}")
    gpu = learners.pop("float32")
    del learners
    if not update["float32"]["within_limits"]:
        raise AssertionError("the card's PPO updates disagree with the CPU's")
    if update["tf32"]["within_limits"]:
        raise AssertionError("TF32 passed every limit: the limits cannot "
                             "tell TF32 from float32")
    # PPO's epoch: 3,200 rows shuffled on the host into 6 minibatches of
    # 500 (and a 200-row tail), copied to the card in one go.
    rows = cfg.num_rollout_workers * cfg.num_envs_per_worker \
        * cfg.rollout_fragment_length
    epoch = {k: np.concatenate([v] * -(-rows // mb))[:rows]
             for k, v in batch.items()}
    t0 = time.perf_counter()
    stacked, _ = sb.stack_minibatches(
        sb.shuffle_batch(epoch, np.random.default_rng(0)), mb)
    update["host_epoch_prep_ms"] = 1e3 * (time.perf_counter() - t0)
    update.update(_rl_update_profile(gpu, stacked))
    flops = sgd_step_flops(module, mb)
    update["sgd_step_gflop"] = flops / 1e9
    update["sgd_step_bound_ms"] = 1e3 * flops / PEAK_FLOPS[torch.float32]
    print(f"    SGD steps at {mb} rows on the card, update_many over "
          f"{len(stacked['obs'])} minibatches: "
          f"{update['ms_per_sgd_step_untraced']:.3f} ms wall a step, of it "
          f"{update['kernels_ms_per_sgd_step']:.3f} ms of kernels "
          f"({update['launches_per_sgd_step']:.0f} launches) and "
          f"{update['copies_ms_per_sgd_step']:.3f} ms of copies (the "
          f"epoch's, {update['copies_per_sgd_step']:.1f} a step); host "
          f"share {update['host_share']:.4f}. Shuffling and stacking the "
          f"{rows}-row epoch on the host first: "
          f"{update['host_epoch_prep_ms']:.1f} ms. Largest device items "
          f"(ms a step):")
    for name, ms in update["top_kernels_ms_per_sgd_step"]:
        print(f"      {ms:.4f}  {name}")
    print(f"    the step's bound: {update['sgd_step_gflop']:.3f} GFLOP at "
          f"float32's peak, {update['sgd_step_bound_ms']:.4f} ms (bound by "
          f"operations); the kernels reach "
          f"{update['sgd_step_bound_ms'] / update['kernels_ms_per_sgd_step']:.4f}"
          f" of the bound, card {card}")
    res["one_update"] = update
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()

    print(f"  2. PPO: {cfg.num_rollout_workers} workers x "
          f"{cfg.num_envs_per_worker} envs x {cfg.rollout_fragment_length} "
          f"steps, 1 warm-up + {PPO_ITERS} iterations")
    algo = PPO(cfg)
    try:
        place = algo.learner_group.call("placement")
        visible = rt.get([w.cuda_visible_devices.remote()
                          for w in algo.workers.workers])
        print(f"    learner {place}; the workers see "
              f"CUDA_VISIBLE_DEVICES={visible}")
        if place["device"] != "cuda:0" or visible != [""] * len(visible):
            raise AssertionError("the learner is not on cuda:0 or a worker "
                                 "sees a card")
        algo.train()
        torch.cuda.reset_peak_memory_stats()
        iters = []
        for _ in range(PPO_ITERS):
            t0 = time.perf_counter()
            m = algo.train()
            m["wall_s"] = time.perf_counter() - t0
            iters.append(m)
            print(f"    iteration {m['training_iteration']}: wall "
                  f"{m['wall_s']:.3f} s, sample {m['sample_s']:.3f} s, learn "
                  f"{m['learn_s']:.3f} s, {m['sgd_steps']} SGD steps, loss "
                  f"{m['total_loss']:.5f}, kl {m['kl']:.5f}, reward "
                  f"{m['episode_reward_mean']}")
            if not all(math.isfinite(m[k]) for k in (
                    "total_loss", "policy_loss", "vf_loss", "entropy",
                    "grad_norm")):
                raise AssertionError(f"PPO losses not finite: {m}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        algo.stop()
    wall = sum(m["wall_s"] for m in iters)
    learn = sum(m["learn_s"] for m in iters)
    steps = sum(m["sgd_steps"] for m in iters)
    # The KL guard stops training only at an epoch's end, so each
    # iteration trained whole epochs of `rows` rows, each of
    # ceil(rows / mb) steps (its last a 200-row tail).
    per_epoch = -(-rows // mb)
    if any(m["sgd_steps"] % per_epoch for m in iters):
        raise AssertionError("a PPO iteration trained part of an epoch")
    res["ppo"] = ppo_res = {
        "env_steps_per_s": 3 * rows / wall,
        "learner_rows_per_s": steps * mb / learn,
        "learner_rows_trained_per_s": steps // per_epoch * rows / learn,
        "ms_per_sgd_step": 1e3 * learn / steps,
        "learn_share": learn / wall, "sgd_steps": steps,
        "peak_gib": peak, "learner": place, "iterations": [
            {k: m[k] for k in ("wall_s", "sample_s", "learn_s", "sgd_steps",
                               "total_loss", "kl")} for m in iters]}
    print(f"    env steps/s {ppo_res['env_steps_per_s']:.1f}; learner rows/s "
          f"{ppo_res['learner_rows_per_s']:.1f} ({steps} SGD steps x {mb} "
          f"rows / learn_s, as bench.py counts; the rows trained: "
          f"{ppo_res['learner_rows_trained_per_s']:.1f} a second); "
          f"{ppo_res['ms_per_sgd_step']:.3f} ms an SGD "
          f"step in learn_s; learn_s {ppo_res['learn_share']:.4f} of the "
          f"iterations; peak memory {peak:.2f} GiB; card {card}")
    gc.collect()
    torch.cuda.empty_cache()

    print("  3. IMPALA with a remote learner in a one-GPU actor")
    icfg = _atari_impala_config("ALE/Breakout-v5")
    icfg.env, icfg.connectors = synthetic_atari_env, atari_connectors()
    icfg.learner_mode, icfg.learner_resources = "remote", {"num_gpus": 1}
    icfg.updates_per_iteration = 4

    class CountedLearner(IMPALALearner):
        def kernel_launches(self):
            """The port's kernel launches in the learner's process."""
            from ray_tpu_torch.ops import attention

            return attention.kernel_launches()

    class CountedIMPALA(IMPALA):
        learner_cls = CountedLearner

    algo = CountedIMPALA(icfg)
    try:
        place = algo.learner_group.call("placement")
        print(f"    learner actor {place} (this process {os.getpid()})")
        if (place["pid"] == os.getpid() or place["device"] != "cuda:0"
                or place["cuda_visible_devices"] != "0"):
            raise AssertionError("the IMPALA learner is not in an actor "
                                 "granted card 0")
        ims = [algo.train() for _ in range(2)]
        remote = algo.learner_group.call("kernel_launches")
    finally:
        algo.stop()
    for m in ims:
        print(f"    iteration {m['training_iteration']}: {m['updates']} "
              f"updates, loss {m['total_loss']:.5f}, learner frames/s "
              f"{m['learner_sps']:.1f}, env frames/s "
              f"{m['env_steps_per_s']:.1f}")
        if not all(math.isfinite(m[k]) for k in ("total_loss", "vf_loss")):
            raise AssertionError(f"IMPALA losses not finite: {m}")
    rng = np.random.default_rng(7)
    T, B = icfg.rollout_fragment_length, 2 * icfg.num_envs_per_worker
    dones = (rng.random((T, B)) < 0.05).astype(np.float32)
    args = dict(
        behavior_logp=np.log(rng.uniform(0.1, 0.9, (T, B))),
        target_logp=np.log(rng.uniform(0.1, 0.9, (T, B))),
        rewards=rng.standard_normal((T, B)), dones=dones,
        terminateds=dones * (rng.random((T, B)) < 0.5),
        values=rng.standard_normal((T, B)),
        next_values=rng.standard_normal((T, B)))
    outs = [vtrace_returns(**{k: torch.tensor(v, dtype=torch.float32,
                                              device=dev)
                              for k, v in args.items()}, gamma=icfg.gamma)
            for dev in ("cuda", "cpu")]
    vt_err = max(((g.cpu() - w).abs() / (w.abs() + 1)).max().item()
                 for g, w in zip(*outs))
    print(f"    vtrace_returns at [T, B] = [{T}, {B}], card against CPU: "
          f"{vt_err:.2e} of |cpu| + 1 (limit {RL_VTRACE_TOL:.0e})")
    if not vt_err <= RL_VTRACE_TOL:
        raise AssertionError("V-trace on the card disagrees with the CPU's")
    res["impala"] = {"learner": place, "vtrace_err": vt_err,
                     "iterations": [{k: m[k] for k in (
                         "updates", "total_loss", "learner_sps",
                         "env_steps_per_s")} for m in ims]}

    print("  4. DQN on Catch at 84 px: updates on the card, sync_target")
    dcfg = DQNConfig(env=functools.partial(CatchVectorEnv, size=84),
                     num_rollout_workers=1, num_envs_per_worker=8,
                     rollout_fragment_length=16, learning_starts=128,
                     train_batch_size=32, updates_per_iteration=8,
                     target_network_update_freq=256, buffer_capacity=10_000)
    algo = DQN(dcfg)
    try:
        learner = algo.learner_group._learner

        def target_is_online():
            net, tgt = learner.net.state_dict(), learner.target_net.state_dict()
            return all(torch.equal(net[k], tgt[k]) for k in net)

        dms = [algo.train() for _ in range(2)]
        synced = algo._last_target_sync == 256 and target_is_online()
        dms.append(algo.train())
        moved = not target_is_online()
        place = learner.placement()
    finally:
        algo.stop()
    for m in dms:
        print(f"    iteration {m['training_iteration']}: {m['updates']} "
              f"updates, td_loss {m['td_loss']:.4e}, q_mean "
              f"{m['q_mean']:.4e}, epsilon {m['epsilon']:.4f}")
    print(f"    learner on {place['device']}; target synced at 256 env steps "
          f"and equal to the net: {synced}; the net moved on after: {moved}")
    if not (synced and moved and place["device"] == "cuda:0" and all(
            math.isfinite(m["td_loss"]) for m in dms)
            and sum(m["updates"] for m in dms) == 24):
        raise AssertionError("DQN on the card did not update and sync")
    res["dqn"] = {"learner": place, "iterations": [
        {k: m[k] for k in ("updates", "td_loss", "q_mean", "epsilon")}
        for m in dms]}
    launches = {k: v - before[k] + remote[k]
                for k, v in attn.kernel_launches().items()}
    print(f"  launches of the port's kernels in this phase, this process "
          f"and IMPALA's learner: {launches} (no kernel of the port is on "
          f"RLlib's path)")
    if any(launches.values()):
        raise AssertionError("RLlib's path launched a kernel of the port")
    res["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def cartpole_batches(n_batches: int = BC_BATCHES, rows: int = BC_ROWS,
                     seed: int = 0) -> list:
    """Sample batches of CartPole under a uniform random policy from
    `seed`: obs, actions, rewards, dones and the behaviour log-probs."""
    from ray_tpu_torch.rllib.env import CartPoleVectorEnv

    env = CartPoleVectorEnv(1, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset()
    out = []
    for _ in range(n_batches):
        cols = collections.defaultdict(list)
        for _ in range(rows):
            action = rng.integers(0, 2, size=1)
            cols["obs"].append(obs[0])
            cols["actions"].append(action[0])
            obs, reward, done, _ = env.step(action)
            cols["rewards"].append(reward[0])
            cols["dones"].append(done[0])
        out.append({"obs": np.asarray(cols["obs"], np.float32),
                    "actions": np.asarray(cols["actions"], np.int64),
                    "rewards": np.asarray(cols["rewards"], np.float32),
                    "dones": np.asarray(cols["dones"], bool),
                    "logp": np.full(rows, np.log(0.5), np.float32)})
    return out


def offline_phase(attn, card: str, workdir: str) -> dict:
    """Phase 11c: offline RL through Data. Writes 4 CartPole sample
    batches of 200 rows with `write_batches` and reads them back with
    `read_batches`: the same rows. Then one `BC` update over them on the
    card and the same on the CPU from the same weights: the loss within
    RL_LOSS_TOL, the weights within lr / 10 (phase 11b's limits). No
    kernel of the port is on this path."""
    from ray_tpu_torch.rllib import BC, BCConfig, read_batches, \
        rows_to_batch, write_batches

    before = attn.kernel_launches()
    batches = cartpole_batches()
    files = write_batches(os.path.join(workdir, "experiences"), batches)
    ds = read_batches(os.path.join(workdir, "experiences"))
    back = rows_to_batch(ds.take_all())
    for k in batches[0]:
        want = np.concatenate([b[k] for b in batches])
        if back[k].dtype != want.dtype or not np.array_equal(back[k], want):
            raise AssertionError(f"{k} came back changed from {files}")
    cfg = BCConfig(obs_dim=4, n_actions=2)
    algos = {"cpu": BC(dataclasses.replace(cfg, device="cpu")),
             "cuda": BC(cfg)}
    algos["cuda"].learner.set_weights(algos["cpu"].learner.get_weights())
    metrics = {k: a.train_on_dataset(ds, batch_size=len(back["obs"]))
               for k, a in algos.items()}
    want, got = metrics["cpu"], metrics["cuda"]
    weights = {k: a.get_policy_weights() for k, a in algos.items()}
    worst = max((weights["cuda"][k] - weights["cpu"][k]).abs().max().item()
                for k in weights["cpu"])
    loss_err = abs(got["total_loss"] - want["total_loss"]) \
        / (abs(want["total_loss"]) + 1e-3)
    launches = {k: attn.kernel_launches()[k] - before[k]
                for k in attn.KERNELS}
    res = {"card": card, "rows": len(back["obs"]), "files": len(files),
           "loss": got["total_loss"], "loss_cpu": want["total_loss"],
           "loss_rel_err": loss_err, "weight_err_lr": worst / cfg.lr,
           "launches": launches,
           "device": str(next(algos["cuda"].learner.net.parameters())
                         .device)}
    print(f"  {res['rows']} rows written to {len(files)} file(s) and read "
          f"back equal; one BC update on {res['device']}: loss "
          f"{got['total_loss']:.6f} (CPU {want['total_loss']:.6f}, rel err "
          f"{loss_err:.2e}, tol {RL_LOSS_TOL}), largest weight difference "
          f"{worst / cfg.lr:.4f} lr (tol {RL_WEIGHT_TOLS_LR[0]} lr); "
          f"launches {launches}")
    if not (loss_err <= RL_LOSS_TOL and worst <= RL_WEIGHT_TOLS_LR[0]
            * cfg.lr):
        raise AssertionError("BC's update on the card differs from the "
                             "CPU's")
    if any(launches.values()):
        raise AssertionError(f"BC launched kernels of the port: {launches}")
    return res


PHASE_STARTS = []    # (phase number, seconds since the script started)


def phase(started: float, title: str) -> None:
    """A phase's header, with the seconds since the script started."""
    at = time.perf_counter() - started
    PHASE_STARTS.append((title.split(".")[0], at))
    print(f"== {title} (at {at:.1f} s)", flush=True)


def phase_seconds(started: float) -> dict:
    """Each phase's wall seconds, from its header to the next one's (the
    last phase's to now)."""
    ends = [at for _, at in PHASE_STARTS[1:]] + [
        time.perf_counter() - started]
    return {name: round(end - at, 1)
            for (name, at), end in zip(PHASE_STARTS, ends)}


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # Phase 4l's C++ client calls `xlang_mod:add` by name: the workers
    # import it from tests/ (every worker, so none started earlier lacks it).
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(HERE, "tests"), os.environ.get("PYTHONPATH"))
        if p)

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    phase(started, "1. device and build")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for src, log in logs.items():
        usage = ptxas_usage(log)
        for fn, regs, spill in usage:
            print(f"  {src}: {fn}: {regs} registers, {spill}")
        for line in log.splitlines():  # e.g. wgmma serialised by ptxas
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"  {src}: {line.strip()}")
        spills = {fn: spill for fn, _, spill in usage}
        bad = [fn for fn in NO_SPILL[src]
               if "0 bytes spill stores, 0 bytes spill loads"
               not in spills.get(fn, "missing")]
        if bad:
            raise AssertionError(f"spilled or not built: {bad}")
        print(f"  {src}: no spills in its {len(NO_SPILL[src])} Hopper "
              f"instances at d 192 and 256 (and above 256) and float32 "
              f"ones")
    check_smem(attn, _build)

    phase(started,
          "1b. runtime: ray_tpu_torch.init, tasks, objects, GPU grants")
    runtime = runtime_phase()

    phase(started, "2. kernels against their plain versions")
    records = check_kernels(attn)
    print("  head dims 192 and 256, float16, float32 filling the card:")
    check_instances(attn, records, F1_CASES, 200)
    print("  head dims above 256 (the wide instances):")
    check_instances(attn, records, F3_CASES, 300)

    phase(started, "3. small GPT-2, kernels against plain attention")
    check_model(gpt2)

    phase(started, "4. main path: TorchTrainer.fit, GPT-2-small, in a worker "
          "actor")
    n_layer = gpt2.GPT2Config.small().n_layer
    yardstick = [in_driver_steps("gpt2")]
    main_leg = train_phase(attn, "gpt2",
                           dict.fromkeys(attn.KERNELS, n_layer), card)
    launches = main_leg["launches"]
    yardstick.append(in_driver_steps("gpt2"))
    ratio = main_leg["tokens_per_sec"] / statistics.mean(yardstick)
    print(f"  tokens/s through the worker actor "
          f"{main_leg['tokens_per_sec']:.1f}; the same steps in this "
          f"process before and after: {yardstick[0]:.1f}, "
          f"{yardstick[1]:.1f} (actor / mean {ratio:.4f})")
    runtime.update(actor_tokens_per_sec=main_leg["tokens_per_sec"],
                   in_driver_tokens_per_sec=yardstick, actor_ratio=ratio)

    phase(started, "4e. Tune: GPT-2-small trials through tune.Tuner and ASHA, "
          "one at a time on the card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        sweep = tune_phase(attn, dict.fromkeys(attn.KERNELS, n_layer), card,
                           d)

    phase(started, "4f. a submitted job: JobSubmissionClient, GPT-2-small "
          "through TorchTrainer.fit, a pip env, a stop")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        jobs = jobs_phase(attn, dict.fromkeys(attn.KERNELS, n_layer), card,
                          d)

    phase(started, "4g. the mesh and sequence parallelism: an sp 1 mesh, "
          "the sp 4 ring schedule at full width, the trainer's mesh")
    meshes = mesh_phase(attn, card)

    phase(started, "4h. pipeline parallelism: LocalPipelineTrainer at pp 1, "
          "2 and 4, the pipeline gang and its stage checkpoints, GPipe")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        pipes = pipeline_phase(attn, card, d)

    phase(started, "4i. tensor, data and fully-sharded parallelism: GPT-2-"
          "small on a (dp, fsdp, tp) mesh of one rank, tp 2 in two "
          "processes")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        tensor_par = tensor_parallel_phase(attn, card, d, main_leg)

    phase(started, "4j. expert parallelism: MoE-small at ep 2, two processes "
          "on the card over gloo")
    expert_par = expert_parallel_phase(attn, card)

    phase(started, "4k. the cluster tier: a GPT-2-small gang killed by the "
          "chaos plane resumes on the card; an autoscaled GPU node from the "
          "CLI")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        cluster = cluster_phase(card, d)

    phase(started, "4l. the rest of the platform: GPT-2-small scored "
          "through an ActorPool in an actor granted the card and a dynamic "
          "resource; Queue, tqdm_ray, internal_kv, the C++ client")
    platform = platform_phase(card)

    phase(started, "4m. raylint on the chip machine: the port's lint, the "
          "torch hazard rules' twins on the card")
    analysis = analysis_phase()

    phase(started, "4c. Data-fed training: TorchTrainer.fit(datasets=), GPT-2-"
          "small on a shuffled token corpus")
    small = gpt2.GPT2Config.small()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        files = write_corpus(workdir, small.vocab_size)
        print(f"  corpus: {len(files)} shards of {SHARD_TOKENS} int32 tokens "
              f"from seed 0, written in {time.perf_counter() - t0:.2f} s")
        data_leg, data_ckpt = data_phase(attn, small, files, workdir, card)
        data_leg["phase4_ratio"] = \
            data_leg["tokens_per_sec"] / main_leg["tokens_per_sec"]
        print(f"  tokens/s fed by Data {data_leg['tokens_per_sec']:.1f}, "
              f"phase 4's synthetic batches {main_leg['tokens_per_sec']:.1f}"
              f" (ratio {data_leg['phase4_ratio']:.4f})")

        phase(started, "4d. BatchPredictor: 4c's checkpoint scored in a pool "
              "actor granted the card")
        scoring = score_phase(attn, small, files, data_ckpt, card,
                              data_leg["pid"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    phase(started, "6. Llama-7B forward, flash kernel against plain attention")
    from ray_tpu_torch import inference
    from ray_tpu_torch.models import llama

    model, llama_launches, records["flash_fwd"]["llama7b_prefill"] = \
        llama_forward(attn, llama)

    phase(started, "7. main path: Llama-7B serving through InferenceEngine")
    attn.reset_kernel_launches()
    serving = serve_llama(inference, llama, model, card)
    serve_launches = attn.kernel_launches()
    print(f"  launches while serving: {serve_launches} (the paged path "
          "runs no kernel of the port)")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    phase(started,
          "7b. Serve: LLMServer (Llama-7B) and GPT2Sampler in one-GPU "
          "replicas")
    print(f"  this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB of the card before the replicas start")
    served = {"llm_server": serve_llm(card, serving),
              "gpt2_sampler": serve_gpt2(gpt2, card)}
    serving.pop("solo_tokens")

    phase(started,
          "7c. tensor-parallel serving: Llama-7B at tp 2, two processes "
          "on the card over gloo, the lockstep engine")
    tp_serving = tp_serving_phase(card, serving)
    serving.pop("bf16_tokens")

    phase(started,
          "8. long context: TorchTrainer.fit, GPT-2-small at seq 8192, "
          "remat")
    legs = {"gpt2-long": train_phase(
        attn, "gpt2-long",
        {"flash_fwd": 2 * n_layer, "flash_bwd_dq": n_layer,
         "flash_bwd_dkv": n_layer}, card,
        ", not counting the recompute, as bench.py")}
    for name, rec in time_long_shape(attn).items():
        records[name]["gpt2_long"] = rec
    long_check = check_long_model(attn, gpt2)

    phase(started,
          "9. remat on the card: small GPT-2, float32, remat on and off")
    remat_bit_equal = check_remat(attn, gpt2)

    phase(started, "10. Llama-small training: TorchTrainer.fit")
    from ray_tpu_torch.models import moe

    n = llama.LlamaConfig.small().n_layer
    legs["llama-small"] = train_phase(
        attn, "llama-small",
        dict.fromkeys(attn.KERNELS, n), card)

    phase(started,
          "11. MoE-small training: TorchTrainer.fit, make_moe_train_step")
    cfg = moe.MoEConfig.small()
    m = legs["moe-small"] = train_phase(
        attn, "moe-small",
        dict.fromkeys(attn.KERNELS, cfg.n_layer), card)
    print(f"  last step: router loss {m['router_loss']:.6f} (summed over "
          f"layers); layer 0 slots used per expert {m['layer0_slots_used']}"
          f" of {m['capacity']}; routing choices dropped at capacity "
          f"{m['layer0_dropped_share']:.4f}")
    if not math.isfinite(m["router_loss"]):
        raise AssertionError(f"router loss not finite: {m['router_loss']}")

    phase(started,
          "11b. RLlib on the card: PPO's learner at Atari width, IMPALA "
          "with a remote learner, DQN")
    rllib = rllib_phase(attn, card)

    phase(started,
          "11c. offline BC through Data: write_batches, read_batches, "
          "one BC update on the card against the CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        offline = offline_phase(attn, card, d)

    stop_runtime()

    phase(started, "12. results")
    print(f"all phases in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"phase_seconds": phase_seconds(started)}))
    print(json.dumps({"runtime": runtime}))
    print(json.dumps({"serving": serving, "serve": served}))
    print(json.dumps({"training": dict(gpt2=main_leg, **legs),
                      "long_model_check": long_check,
                      "remat_bit_equal": {
                          str(k): v for k, v in remat_bit_equal.items()}}))
    print(json.dumps({"data": {"train": data_leg, "score": scoring,
                               "offline": offline}}))
    print(json.dumps({"tune": sweep}))
    print(json.dumps({"jobs": jobs}))
    print(json.dumps({"mesh": meshes}))
    print(json.dumps({"pipeline": pipes}))
    print(json.dumps({"tensor_parallel": tensor_par}))
    print(json.dumps({"expert_parallel": dict(
        expert_par, phase11_peak_gib=legs["moe-small"]["peak_gib"])}))
    print(json.dumps({"tp_serving": tp_serving}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"platform": platform}))
    print(json.dumps({"analysis": analysis}))
    paths = [launches, sweep["launches"], jobs["launches"],
             meshes["launches"], pipes["launches"], tensor_par["launches"],
             expert_par["launches"], cluster["launches"],
             platform["launches"], analysis["launches"],
             tp_serving["launches"],
             data_leg["launches"],
             scoring["launches"],
             llama_launches, serve_launches,
             served["llm_server"]["replica_launches"],
             served["gpt2_sampler"]["launches"], rllib["launches"],
             offline["launches"]] + [
        leg["launches"] for leg in legs.values()]
    for name, rec in records.items():
        rec["launches"] = sum(p[name] for p in paths)
    print(json.dumps({"rllib": rllib}))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
