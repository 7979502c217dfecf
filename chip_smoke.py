#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PULSE on one NVIDIA card and check it.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``:

    python3 chip_smoke.py [--seed 0] [--json PATH]

Phases (any failure exits non-zero before the last line):
  1. device and build: the card's name and power limit, then the five
     kernels built from ``src/repro_torch/csrc`` (one ``nvcc`` each, all
     started together) with their ``-Xptxas -v`` reports (registers, and
     stack frame and spills of every ``paged_decode*`` instantiation);
  2. ``pulse_chase`` against its plain versions, bit for bit (tolerance 0:
     the state is int32), on the same CUDA tensors: the fixed-depth entry
     point (``ops.pulse_chase`` against ``ref.chase_reference``) with the
     four ISA read programs and the seven native bodies (the structures' own
     iterators, ``skiplist_find`` among them), each at a small size and at
     the paper's size (65,536 keys for the skip list); then the
     whole-traversal entry point (``ops.pulse_chase_run`` against
     ``ref.chase_run_reference``) with every body on a faulting case (a
     revoked shard, NULL and out-of-range entries) at budgets on and off
     the depth quantum;
  3. the traversal main path: ``PulseEngine(arena).execute(it, ptr0, scr0,
     max_iters=4096)`` with the default backend ("kernel") on three
     workloads of 65,536 YCSB-Zipfian queries (90% stored keys by rank with
     p ~ rank^-0.99, 10% absent keys), once through the ISA iterator and
     once through the structure's own iterator (its native body); each
     ``execute`` must launch exactly one kernel and its results must equal
     ``backend="reference"`` and the structure's ``ref_find`` oracle;
     lookups/s, the kernel's device ms inside ``execute`` (the profiler's
     kernel timestamps) and the device's busy share are reported, then one
     fixed-depth launch of the whole batch to full depth, timed beside its
     bytes bound (each distinct row the run visits read once) and, on the
     workload whose arena lies beyond L2 (the kernels line's), beside its
     plain version (an interpreter call ~1-1.5 s: the time's cut);
  4. ``flash_attention`` against its plain version (``mha_reference``) on
     the shapes of ``tests/test_kernels.py``, at head dims 112 (kimi's G =
     8, zamba2's G = 1) and 16 (the reduced configs), at zamba2_7b's and
     granite_moe_1b_a400m's prefill shapes, and, with no blocks (the
     models' route, any lengths: the ragged last tiles), at Whisper's
     encoder (B=4, H=20, L=1,500, D=64, full) and cross-attention (128
     queries over 1,500 keys), a causal square shape of 200 and causal
     100 over 300 (the causal offset inside a key tile), in f32 and bf16,
     and timed at the serve shape (B=4, H=16, Hk=8, L=512, D=128, causal,
     f32), kimi's D = 112 shape (B=4, H=64, Hk=8, L=512, causal, f32),
     zamba2's (B=4, H=32, Hk=32, L=512, D=112), granite's (B=4, H=16,
     Hk=8, L=512, D=64), Whisper's encoder and cross-attention and
     internvl2_2b's patch prefill (B=4, H=16, Hk=8, L=768, D=128,
     causal), and the encoder's shape again at L = 1,536, which the 64-row
     tiles divide (what the ragged tiles cost); tolerance 2e-5
     (f32) and 2e-2 (bf16), absolute and relative; timed beside
     ``scaled_dot_product_attention`` (the library yardstick, never used by
     the port), with its bound at the f32 FMA peak and, for the 3xTF32
     products the kernel runs on the tensor cores, at the TF32 peak; then
     the ``autograd.Function`` at Qwen3-0.6B's training shape (B=8, H=16,
     Hk=8, L=512, D=128, causal) against plain autograd of
     ``mha_reference``: the forward within 2e-5, one launch, dq, dk and dv
     bit for bit (the backward is the same recompute; the largest
     difference printed), and the recompute's time beside the forward's;
  5. ``paged_attention`` (two CUDA kernels a call when it splits:
     ``paged_decode_split`` and ``paged_decode_merge``, timed together)
     against its plain version on the shapes of ``tests/test_kernels.py``,
     at head dims 112 and 16, G = H/Hk of 3 and 6, page 8 with lengths on
     split boundaries, a length of 0 among long sequences and one sequence
     over 512 page slots, then timed at Qwen3-0.6B's widths (H=16, Hk=8,
     D=128, page 16, lengths 512-528, f32), at kimi's (H=64, Hk=8, D=112)
     and at one sequence of 8,192 tokens of Qwen's widths, with the split
     count, the blocks launched and the merge kernel's share; same
     tolerances;
  6. the serve path: ``repro_torch.launch.serve.main`` on the full-width
     ``qwen3_0_6b`` (seeded weights; 8 requests, 4 slots, prompt 512, 16
     new tokens): every request finishes and ``flash_attention`` launches
     28 times per prefill call; then the same requests on the plain
     ``attn_backend="chunked"`` with the same weights: prefill logits agree
     within 1e-3 absolute, and the emitted tokens are compared;
  7. paged decode at full width: one prefill's K/V written into a
     ``PagedKVCache`` (28 layers, page 16) through ``write_token``, the
     page tables walked on the card by the PULSE executor, and for every
     layer ``paged_attention`` held against its plain version and dense
     attention over the same KV (2e-5);
  8. ``ssd_scan`` against its plain version (``ssd_chunked_batched``) on
     the shapes of ``tests/test_kernels.py``, the reduced mamba2_780m's
     (N 16, dh 16, chunk = prompt length), the serve shape (B 4, L 512,
     H 48, dh 64, N 128, chunk 128) and zamba2_7b's (H 112, N 64), in f32
     and bf16 x; tolerance 1e-4 (f32) and 2e-2 (bf16), absolute and
     relative; one call runs three CUDA kernels (``SSD_KERNELS``), timed
     together and one by one at the two prefill shapes; then the
     ``autograd.Function`` at Mamba2-780M's training shape (B 8, L 512, H
     48, dh 64, N 128, chunk 128) against plain autograd of
     ``ssd_chunked_batched`` as phase 4's (within 1e-4; dx, ddt, dA, dB,
     dC bit for bit; the final state's gradient None, as in training);
  9. the serve path of the full-width ``mamba2_780m`` (seeded weights; 8
     requests, 4 slots, prompt 512, 16 new tokens): every request
     finishes and ``ssd_scan`` launches 48 times per prefill call; then the
     same requests on the plain ``ssm_backend="chunked"``: prefill logits
     agree within 1e-3 absolute, and the emitted tokens are compared;
 10. the write path: ``PulseEngine(arena).execute`` (default backend) of
     mutating iterators on a CUDA arena, then the same call on a CPU copy
     of the input arena: ``webservice_rw`` (the writable hash table, 200,000
     keys in 4,096 buckets; 65,536 ops: 90% YCSB-Zipfian finds, 5% inserts
     of fresh keys, 5% deletes of stored keys, one per bucket and never a
     chain's tail), ``wiredtiger_update`` (the B+tree of 500,000 keys;
     65,536 updates of distinct keys) and ``skiplist_rw`` (65,536 keys; 4,096
     inserts, then 4,096 deletes of non-adjacent level-0 keys).  Gates: the
     card's and the CPU's records, ``RoutingStats`` and final ``data`` and
     ``heap`` bit-equal; the input arena unchanged; every record DONE and
     every found value right; the committed arena read back through
     ``execute`` on the kernel's native body (``hash_find``, ``btree_find``,
     ``skiplist_find``; exactly one launch each) finds every inserted and
     updated key with its value, no deleted key, and 1,024 untouched keys
     with their old values.  Reported: ops/s, supersteps, commits, epochs,
     the chase's and the commit's wall time, bytes between host and device
     per superstep, peak device memory, the read-back's lookups/s, and the
     ``skiplist_find`` body's full-depth time beside its bound;
 11. routing over the paper's four memory nodes (``pulse_paper.MEM_NODES``)
     emulated on the card: ``PulseEngine(arena, mesh=EmulatedMesh(4,
     "cuda")).execute(it, ptr0, scr0, max_iters=4096, k_local=4,
     compact=True)`` on ``webservice`` (the hash table, 200,000 keys, 4,096
     buckets, placed ``interleaved``: nearly every hop crosses a link),
     ``wiredtiger`` (the B+tree of 500,000 keys, placed ``sequential``:
     range partitioning, crossings rare) and ``wiredtiger`` again with
     ``return_to_cpu=True`` (Fig. 9's ablation), 65,536 YCSB-Zipfian
     queries each.  Gates: exactly one ``pulse_chase`` launch (its
     superstep mode) per superstep; on each batch's first quarter of its
     queries (``ROUTE_CPU_CUT``), the card's results and every
     ``RoutingStats`` field equal the same call on a CPU copy (the plain
     chase); on every query, equal to ``sequential_commit_execute`` on the card but for the
     ``schedule`` field (the ablation: equal results to the compacted run);
     1,024 sampled queries equal the structure's ``ref_find``; the kernel
     equal to its plain version on one superstep of each batch.  Reported:
     lookups/s over the median call, supersteps and local-only steps,
     routed records and wire words, mean crossings, the chase kernel's
     device ms per superstep beside its bound, its share of the call's
     wall time, peak device memory, and a profiled call split by the
     ``routing.*`` spans (placement; each superstep's chase and switch,
     the switch with its counter read; decode);
 12. the write path over the same four memory nodes: phase 10's three
     batches at the same sizes through ``PulseEngine(arena,
     mesh=EmulatedMesh(4, "cuda")).execute(it, ptr0, scr0, max_iters=4096,
     k_local=4, compact=True)``, each superstep's commit phase one
     ``pulse_commit`` call: the ``commit_key`` kernel, one ``torch.sort``,
     the ``commit_apply`` and ``commit_tail`` kernels
     (``csrc/pulse_commit.cu``).
     ``webservice_rw`` and ``skiplist_rw`` are placed ``interleaved`` with
     room on every shard for the inserts of its home records (an ALLOC
     claims a row on its record's home shard, ``id % 4``),
     ``wiredtiger_update`` ``sequential``.  Gates: on each step's first
     eighth of its ops (``WRITE_MESH_CUT``), the card's run equals the
     same calls on a CPU copy (records, every ``RoutingStats`` field, final
     ``data`` and ``heap``) and the sequential commit at P = 4 on the card
     (all but ``schedule``), but for the skip list, cut for the time
     (``WRITE_MESH_UNCHECKED``: ~270 supersteps at any cut); on every op:
     the input arena unchanged and the
     committed arena on the card; every record DONE and every found value
     right; ``pulse_commit`` launched once per mutating superstep and
     ``pulse_chase`` never during a mutating batch; the kernels equal to the
     serial plain version and to the CPU model of their stages on the
     commit phase with the most staged records of each batch, captured
     from the card's run; the
     committed arena read back over the mesh on
     the structure's find iterator (one superstep-mode ``pulse_chase``
     launch per superstep) finds every inserted and updated key with its
     value, no deleted key, and 1,024 untouched keys with their old values.
     Reported: ops/s over the median of three calls (one for the skip
     list, ``WRITE_MESH_TIMED``), supersteps and
     local-only steps, commits and epochs, routed records, wire words, mean
     crossings, a call split by CUDA events on the stream into chase,
     commit (each kernel and the sort) and switch, the commit's ms per
     superstep beside its bound, the captured commit phase's device ms
     (every kernel, the sort's included, by stage) and plain ms beside its
     bound, its serial residue (the longest same-slot run, the free-list
     pops) beside the longest per-shard count, peak device memory and the
     phase's time.

 13. faults and replication over the same four memory nodes, at phase 11's
     size (``webservice`` and ``wiredtiger``, 65,536 queries each; R = 2
     keeps one more copy of each arena on the card, printed): replicated
     reads through ``PulseEngine.execute(..., replication=ReplicaContext)``
     on the dispatched schedule, ``failover`` with each of the four
     primaries dead and ``spread`` and ``primary`` healthy, each with the
     healthy run's payload and one ``pulse_chase`` launch a superstep (the
     replica windows inside it); on ``wiredtiger`` with shard 1 dead, on
     the first eighth of its queries (``FAULTS_CPU_CUT``), card == CPU
     copy (every stat) == the replicated sequential executor (records
     with hops); the replica-window superstep against its plain
     version for the native body of each batch and the ISA ``hash_find``
     program, timed beside the same launch without the windows; fabric loss
     (``FaultPlan(drop_prob=0.4, drop_seed=7)``) on ``webservice`` over the
     five schedule x fabric pairs of ``tests/helpers/ft_checks.py``
     (records equal to the loss-free run, a replay identical, the
     superstep growth reported; on dispatched/dense card == CPU copy in
     every stat, on the first eighth of the queries) and on
     ``webservice_rw`` fused/dense (every record DONE, every find right, a
     replay identical to the arena); a kill of shard 2 before superstep 3
     of ``webservice_rw`` on each schedule (``ShardFailure``, the arena's
     digest unchanged).  Reported: lookups/s healthy against degraded, the
     replica-window superstep's kernel ms and bound, the loss's superstep
     growth, each with the card's name and power limit.
 14. traversal serving: ``PulseService`` (``serving/traversal_service.py``)
     over one heap holding the ``webservice`` hash table (200,000 keys,
     4,096 buckets) and the ``wiredtiger`` B+tree (500,000 keys), with three
     specs (hash finds, B+tree finds, in-place B+tree updates in the finds'
     group) and 32,768 requests of three tenants: 45% hash finds and 45%
     B+tree finds (YCSB Zipfian 0.99, 10% absent keys), 10% updates of
     distinct keys from the 5% of the tree's keys no read draws; 2,048
     slots a structure.  Runs: (a) one node, sync, quantum 16, against the
     same service on a CPU copy, request by request (status, iters, result,
     admit and finish rounds) and in every ``ServiceMetrics`` count, one
     ``pulse_chase`` launch per read engine call; (b) the same async, equal
     to (a); (c) ``EmulatedMesh(4, "cuda")``, interleaved, schedule "auto"
     (pipelined), sync: status, iters and result equal to (a), one capture
     a group; (d) (c)'s mesh async with SLO sizing (quanta 4-256, a 20 ms
     deadline on every request): one capture a group whatever quanta it
     picks (the budget is a device operand of the captured chunk); (e) (c)
     with ``request_reshard(8)`` once a third of the requests retired.
     Every run's reads equal ``ref_find`` and the final tree holds every
     update.  The superstep mode with the budget as a device tensor, at two
     budgets, against its plain version.  Reported for each run: requests/s,
     p50/p99/p999 latency, rounds, engine calls, mean quantum, captures,
     ``pulse_chase`` and ``pulse_commit`` launches and the host's share of
     the run's wall time (outside the engine calls).
 15. fault tolerance and durability: ``PulseService(...,
     fault_tolerance=FaultToleranceConfig(store=ArenaStore(tmp),
     snapshot_every=8))`` over phase 14's heap, specs and requests, the
     stores in a temporary directory on local disk.  Runs: (f) (a) made
     durable (every write quantum's inputs in an fsynced log before it is
     acknowledged, a snapshot every 8 logged quanta), no kill: every request
     and every count equal to (a); (g) (f) with shard 0 killed
     (``FaultPlan(kill_shard=0, kill_call=K, kill_superstep=1)``) at the
     update quantum nearest the middle of (f)'s run whose log since the last
     snapshot is not empty: the card equal to a CPU copy of the same service
     and plan in every request and count, one recovery (the snapshot loaded
     onto the card, the log replayed through the sequential commit, checked
     against the resident arena), ``store.recover()`` after the run equal to
     the resident arena, ``data`` equal to (a)'s; (h) (c)'s mesh with
     failover replication (a log-shipped standby, each quantum replayed over
     its mesh through ``distributed_execute`` and ``pulse_commit``, verified
     after every write quantum) and shard 2 killed before superstep 2 of the read quantum
     nearest the middle of (c)'s run, dead for 6 rounds: one recovery (the
     log replayed over the mesh, as the standby), at
     least one read quantum fanned out to the replica, no read retried, no
     request ended ``STATUS_RETRY``, status, iters and result equal to (a),
     ``data`` equal to (c)'s, the standby equal to the primary, one capture
     a group; (i) the watchdog on a reads-only cut (4,096 reads, 512 a
     round) over the mesh with failover replication, shard 1 delayed
     (``FaultPlan(delay_shard=1, delay_s=...)``) 4x the watchdog's timeout,
     itself 10x the slowest of 20 healthy probes timed first through the
     service's own probe (at least 20 ms): at least one suspect and one fanned-out quantum, no retry, no
     recovery, the probes on ``pulse_chase`` (their launches counted).
     Every run's reads equal ``ref_find``.  Reported: requests/s beside the
     run it extends, the log append's ms (mean and max, fsync included), a
     snapshot's ms and bytes, the snapshots, the recovery's ms (snapshot
     load and replay), the quanta replayed, the retries, the failover and
     shipped quanta, the standby's ms a write quantum, the probe's ms and
     the watchdog's settings, each with the card's name and power limit;
 16. the serve path of the full-width ``zamba2_7b`` (hybrid: 81 mamba2
     layers, one shared attention+MLP block after every 6; 6.75 B
     parameters, 27 GB in f32; phase 6's traffic): every request finishes,
     ``flash_attention`` launches 13 and ``ssd_scan`` 81 times per prefill
     call; then the same requests on the plain route (``attn_backend`` and
     ``ssm_backend`` "chunked"): prefill logits within 1e-3 absolute, the
     residual stream's difference between the routes reported after every
     layer, tokens compared;
 17. the serve path of the full-width ``granite_moe_1b_a400m`` (24 layers,
     32 experts, top-8, capacity factor 1.25): every request finishes,
     ``flash_attention`` launches 24 times per prefill call; on one prefill
     of four prompts, each layer's ``flash_attention`` output within 2e-5
     of ``mha_reference`` on that layer's own q/k/v; every layer's top-k
     on both routes: a token whose expert set differs (a flip) only at a
     near-tie (the plain route's k-th and (k+1)-th probabilities within
     1e-4), each flip printed with its margin; the logits of every token no
     flip or changed drop reached (through causal attention, the rest of
     its sequence from the next layer on) within 1e-3.  Reported: the
     capacity and the dropped copies a layer, and the MoE layers' share of
     a warm prefill;
 18. the serve path of the full-width ``internvl2_2b`` (vlm: 24 layers, d
     2048, 16/8 heads of 128, vocab 92,553; 1.89 B parameters; phase 6's
     traffic, tokens only, as the batcher prefills): every request
     finishes, ``flash_attention`` launches 24 times per prefill call, the
     plain route's logits within 1e-3; then the entry point that carries
     the patches, ``build_model(cfg).prefill(params, {"tokens",
     "patches"}, 1024)`` on 4 prompts of 512 tokens behind 256 seeded patch
     embeddings each (T = 768): 24 launches, the logits of all 768 rows
     and the K/V cache within 1e-3 of the plain route, then 16 greedy
     decode steps from 768 on both routes in lock step (``greedy_pair``: a
     token may differ only where the plain route's top two logits lie
     within 2e-3, and the logits agree within 1e-3 until it does);
 19. the full-width ``whisper_large_v3`` (encdec: 32 encoder and 32
     decoder layers, d 1280, 20 heads of 64, QKV bias, vocab 51,866; 1.53
     B parameters): ``build_model(cfg).prefill(params, {"tokens",
     "frames"}, 448)`` on 4 prompts of 128 tokens and 4 clips of 1,500
     seeded frame embeddings (the encoder's 30 s window; 448 is the
     decoder's published context): 96 ``flash_attention`` launches (32
     encoder, 32 causal, 32 cross over 1,500 frames), the encoder's
     output, the logits and the four caches within 1e-3 of the plain
     route, 16 greedy decode steps on both, held as in phase 18; then
     ``serve.main`` with 4 requests of 8 tokens, 8 new, max_len 448, a
     functional check with no rate: every request finishes in token mode
     (the batcher's for encdec, as in the reference: no prefill call, no
     kernel launch).  Phases 6, 9 and 16-18 report tokens/s, and phases 6,
     9 and 16-19 prefill ms a call, decode ms a step, peak device memory
     and a warm profiled breakdown.

 20. training at full width: ``repro_torch.launch.train.main`` on
     ``qwen3_0_6b`` (seeded weights, AdamW, batch 8 x 512 tokens, 8 steps,
     lr 1e-3 with the launcher's warmup of 5): every loss finite and the
     last below the first, ``flash_attention`` launched 28 times a step;
     the first two of those steps (``PLAIN_TRAIN_STEPS``) on
     ``attn_backend="chunked"`` from the same weights and data: the first
     loss within 1e-5 and its grad norm within 1e-4, the later loss within
     1e-3, relative (the gaps printed); an exact resume at full width and
     an eighth of the layers (``RESUME_DEPTH_CUT``: 4 steps through
     ``TrainLoop``, ``CheckpointManager.save(block=True)`` into a
     temporary directory, a fresh state and ``DataIterator`` restored, 4
     more): the 8 losses equal that model's uninterrupted run's bit for
     bit (within 1e-6 relative where the card is not deterministic, which
     is reported); then the full model from ``train.main``'s seeded state
     through ``TrainLoop``: its first loss equal to ``train.main``'s, and
     one more step under the profiler.  Reported: step ms
     (the median of the 7 warm steps), tokens/s, model FLOP/s (6 x
     ``param_count()`` x tokens a step) and its share of the f32 peak (67
     TFLOP/s) and of the TF32 peak, peak device memory, the checkpoint's
     save and restore, and the profiled step's kernels split by the port's
     spans: forward (the float kernels' own), backward (the plain
     recompute's ``flash_attention.backward``/``ssd_scan.backward``),
     optimizer, and the GEMMs;
 21. the same for ``mamba2_780m`` (``ssm_backend="chunked"`` the plain
     route), ``ssd_scan`` launched 48 times a step, without the exact
     resume (phase 20's holds the checkpoint round trip: the time's cut).
 22. the launch tooling (``repro_torch.launch``): (a) the meta dry run
     (``dryrun.main``) of ``qwen3_0_6b``'s four cells on the single-pod
     H100 mesh (data 32, model 8; the multi-pod mesh's records are the CPU
     test's: the time's cut), their collectives recorded, and its ``report``
     table, printed (counts and datasheet peaks, not measurements); (b)
     ``steps.build_step(cfg, shape, make_test_mesh(), device="cuda")`` for
     the full-width ``qwen3_0_6b`` at the production lengths with the batch
     cut to one card: prefill 1 x 32,768 (``flash_attention`` 28 a call),
     decode 4 over a 32,768-token cache (seeded normal draws), train 1 x
     4,096 (28 a call); (c) ``mamba2_780m``'s prefill at 1 x 32,768
     (``ssd_scan`` 48 a call).  Gates: each step's first call equals the
     direct ``make_train_step`` / ``Model.prefill`` / ``Model.decode_step``
     call on the same arguments bit for bit; the kernel's first call in
     that direct call, on its own inputs at the step's shape, agrees with
     its plain version (``chunked_attention``, ``ssd_chunked_batched``)
     within the f32 tolerance; the prefill and train steps agree with the
     plain route (``attn_backend`` / ``ssm_backend`` "chunked") on the same
     arguments: logits within LOGIT_TOL (the 32k prefills on a step of
     their own at ``LAUNCH_PLAIN_LEN`` = 8,192 tokens, kernel and plain
     route on its arguments), the train step's loss and grad norm
     within TRAIN_LOSS0_TOL and TRAIN_GNORM0_TOL; the launches of the first
     call and of three warm ones exact; a shape that does not fit is cut
     (batch, then length) and the cut logged.  Reported: the median ms of
     the three warm calls, peak device memory beside the specs' argument
     bytes, measured / the floor of the step's own work (``step_floor``:
     its products, each input read once and each output written once), and
     measured / the meta counter's count of the port's own eager traffic
     (``step_roofline``); then ``python -m repro_torch.tools.pulse_verify
     --all --golden tests/golden/pulse_verify``, gated on exit 0;
 23. memory nodes as processes (item 6(e), and items 2-3 of ROADMAP queue
     1): ``distributed.world.spawn``
     starts 4 ranks on ``cuda:0`` (spawn start method, one Gloo process
     group over a loopback TCP store on a free port, joined with a
     timeout: any rank's exception or the timeout fails the phase), each a
     memory node of a ``routing.ProcessGroupMesh``: phase 11's
     ``webservice`` (dense and ring) and ``wiredtiger`` reads and phase
     12's ``webservice_rw`` and ``wiredtiger_update`` writes, freshly
     drawn at the same sizes, through ``distributed_execute(...,
     max_iters=4096, k_local=4, compact=True, schedule="dispatched")``:
     each rank moves only its own rows and heap row to the card, launches
     ``pulse_chase`` and ``pulse_commit`` over its own pool and rows (a
     shard offset), and exchanges records over Gloo (host copies).  Gates:
     every rank's records, ``RoutingStats`` and, for writes, the committed
     arena's digest equal ``EmulatedMesh(4, "cuda")``'s in this process
     bit for bit; each run's first offset launch of ``pulse_chase`` (reads)
     or ``pulse_commit`` (writes) on every rank equals its plain version on
     the same inputs; one such launch a superstep on each rank; the write
     batches' own checks.  Then Granite's MoE layer at full width (d 1024,
     32 experts of d_ff 512, top-8; seeded weights) over 4 x 512 tokens on
     the expert-parallel path (``moe_apply(..., mesh=DeviceMesh)``): on
     (``model`` 2), every rank pair a model-2 mesh (a second dim,
     ``replica``, that the MoE does not use), and on (``data`` 2,
     ``model`` 2), against the single-rank ``moe_apply`` on the card within
     1e-6 of the largest magnitude (the error printed).  Reported beside the
     card's name and power limit: lookups/s and write ops/s of a timed
     second call (the slowest rank's) beside the emulated mesh's in the
     same call, supersteps, ms a superstep and the host-staged fabric's
     share of it (``routing.FABRIC_STATS``).  In the same world (items 2
     and 3 of ROADMAP queue 1): (a) phase 13's replicated reads, R = 2 by
     ``make_replica_plan(4)``, ``failover`` with each primary dead in turn
     and ``spread`` healthy, on the first eighth of each read batch
     (``PG_REP_CUT``): every rank == ``EmulatedMesh(4, "cuda")`` in records
     and ``RoutingStats``, one windowed offset launch of ``pulse_chase`` a
     superstep on each rank (its own rows and its holder slice of the
     replica rows), each rank's first of each batch == its plain version;
     the windowed offset launch timed alone beside the whole-arena one
     (``window_offset_vs_plain``); (b) ``webservice_rw`` with shard 2
     killed before superstep 3: every rank raises ``ShardFailure(2, 3)``
     and keeps its arena; (c) phase 14's run (c) on the first 4,096 of its
     requests (``PG_SERVE_REQUESTS``), ``PulseService`` on rank 0 and
     ``serving.memory_node.follow`` on ranks 1-3, dispatched: every
     request (status, iters, result, rounds) and count == the same service
     over ``EmulatedMesh(4, "cuda")`` in this process, every rank's final
     arena the same; (h) (c) durable with failover replication and shard 2
     killed at the read quantum nearest the middle: == the emulated run,
     one recovery, the standby == the primary, data == (c)'s (no
     acknowledged commit lost); (i) phase 15's watchdog run on the group,
     on the first 2,048 of its reads (``PG_WATCHDOG_READS``), arriving from
     round 2 (``PG_WATCHDOG_IDLE_ROUNDS``, for the time): shard 1 (rank 1 alone) delayed 4x a timeout of 10x the slowest
     healthy probe, suspected and no other shard, reads == ``ref_find``.  The
     service's requests/s, p50/p99/p999 and the fabric's and the leader's
     shares are printed beside the emulated run's, and each part's seconds.
     Then (j), the live reshard (ROADMAP queue 1, item 6), in a world of 8
     ranks of its own (``PG_RESHARD_WORLD``): (c)'s requests, 512 arriving
     a round (``PG_RESHARD_PER_ROUND``, so that some still queue when a
     third have retired), served on ranks 0-3
     (``distributed.world.first_ranks(4)``), ranks 4-7 following
     outside the serving group, ``request_reshard(8)`` once a third have
     retired; at the cutover every rank takes the group of all 8 and rank
     0 installs the remapped arena on it.  Gates: every request and count
     == the same service over ``EmulatedMesh(4, "cuda")`` -> 8, dispatched,
     in this process; one reshard; one arena digest on every rank; ranks
     0-3 joined calls at 4 shards, then at 8, ranks 4-7 only at 8, each
     one's first offset ``pulse_chase`` launch (and ``pulse_commit`` call)
     == its plain version; one
     ``pulse_chase`` launch a read superstep and one ``pulse_commit`` call
     a write superstep on every rank.  Reported beside the card's name and
     power limit: requests/s and p50/p99/p999 beside the emulated run's,
     the cutover's ms and the bytes it installed on each rank, the drain
     rounds, the fabric's and the leader's shares.
 24. training across processes (ROADMAP queue 1, items 4-5): (a) a world
     of 2 Gloo ranks on ``cuda:0`` started as ``torchrun`` starts one
     (``distributed.world.spawn(..., launcher_env=True)``), each running
     ``launch.train.main`` on qwen3_0_6b at published widths (f32), global
     batch 8 x 512 (4 rows a rank), 4 steps, no checkpoint.  Gates: each
     rank's first loss within TRAIN_LOSS0_TOL of the plain route's
     (``attn_backend`` "chunked", remat full) first step from the same
     seeded weights on that rank's rows; the ranks' first losses differ;
     ``flash_attention`` 28 x 4 launches on each rank; no collective of
     ``torch.distributed`` called inside the loop (``_CollectiveSpy``).
     Reported: each rank's warm step ms, tokens/s and peak memory, the
     world's tokens/s over the slowest rank's step.  (b) The dry run's
     collective records of ``qwen3_0_6b|train_4k`` and
     ``mamba2_780m|prefill_32k`` on (data 32, model 8), on meta: nothing
     made off meta, and the train cell has all-gathers and reduce-scatters
     over ``data`` and a collective term above 0; reported: the counts by
     kind and axis, the ring wire bytes, ``collective_s``, ``dominant``
     and each cell's seconds to count and to record.  (c) Which of
     DTensor's collectives (all-gather, reduce-scatter, all-reduce,
     all-to-all) Gloo takes on CUDA tensors of the card: each in a world
     of 2 ranks of its own, one world after another, so that one which
     crashes its processes ends only its world, up to the first that Gloo
     does not take (``GLOO_PROBES``; the rest are not probed); where Gloo
     takes all four, a world of 4 ranks as a (data 2, model 2)
     ``DeviceMesh`` runs qwen3_0_6b's train step at full width and 2
     layers, 4 x 512, sharded as DTensors, gated: every rank's records
     equal the fake world's at the same mesh, the loss and every updated
     parameter within 1e-5 of the largest magnitude of the unsharded
     step's, ``flash_attention`` 2 launches a rank.  Where Gloo does not,
     what it did is reported and no step runs (the CPU test holds the real
     mesh against the fake one).

Each phase logs its seconds.

Phases 11 and 12 then run every batch (each step of a write batch) on the
device-resident schedules, ``schedule="fused"`` and ``"pipelined"`` on the
dense fabric, and ``webservice`` also pipelined on the ring,
``webservice_rw`` also fused on the ring: each call's supersteps replayed
from one captured CUDA graph, ``routing.CHUNK`` a replay, the host reading
one small tensor a chunk.  Gates, against the card's own dispatched run of
the same batch: records bit-equal; supersteps, local-only steps, wire
words, crossings, commits and epochs equal; ``schedule``, ``fabric`` and
``fused`` as asked; the final ``data`` and ``heap`` bit-equal; one capture
in the first call (which launched the kernels: a warm-up superstep and the
captured chunk), none in the second, whose chunk reads are counted
(ceil(supersteps / CHUNK)).  Reported: the rate over the median of three
calls beside the dispatched one, the capture's time, and a profiled call's
kernel time, busy share and each kernel's executions (in phase 12 for
``wiredtiger_update`` only: the traces of ``skiplist_rw``'s ~270-superstep
calls took 33-64 s each to parse, and ``webservice_rw``'s most of the rest
of ~95 s).

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B_MAIN = 65_536  # queries per main-path workload
ZIPF_S = 0.99  # YCSB's Zipfian constant
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor-core peak, dense
TF32X3 = 3  # 3xTF32: three TF32 products per f32 one, for f32 accuracy
TPU_KERNEL = "src/repro/kernels/pulse_chase/kernel.py:38"
KERNEL_SOURCE = "src/repro_torch/csrc/pulse_chase.cu"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:133,177
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_kernels.py:201-202
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")  # one ssd_scan call
# kernel vs chunked prefill logits, absolute: 28 (qwen), 48 (mamba2), 24
# (granite) f32 layers, or zamba2's 81 SSD layers and 13 attention blocks
LOGIT_TOL = 1e-3
SERVE_SHAPE = ["--requests", "8", "--max-batch", "4", "--prompt-len", "512", "--max-len",
               "1024", "--max-new", "16"]
SERVE_ARGS = ["--arch", "qwen3_0_6b", *SERVE_SHAPE]
SSM_SERVE_ARGS = ["--arch", "mamba2_780m", *SERVE_SHAPE]
HYBRID_SERVE_ARGS = ["--arch", "zamba2_7b", *SERVE_SHAPE]
MOE_SERVE_ARGS = ["--arch", "granite_moe_1b_a400m", *SERVE_SHAPE]
VLM_SERVE_ARGS = ["--arch", "internvl2_2b", *SERVE_SHAPE]
VLM_PROMPT, VLM_MAX_LEN, VLM_NEW = 512, 1024, 16  # phase 18's patch prefill: T = 256 + 512
# phase 19: Whisper's 30 s window of 1,500 frames and its published decoder
# context of 448 tokens
WHISPER_PROMPT, WHISPER_MAX_LEN, WHISPER_NEW = 128, 448, 16
WHISPER_SERVE_ARGS = ["--arch", "whisper_large_v3", "--requests", "4", "--max-batch", "4",
                      "--prompt-len", "8", "--max-len", "448", "--max-new", "8"]
ROUTE_TIE = 1e-4  # a top-k flip between the routes is allowed within this margin
# a greedy token may differ between the routes only where the plain route's
# top two logits lie within this: each route's logits within LOGIT_TOL
TOKEN_TIE = 2 * LOGIT_TOL
# phases 20-21: full-width training through repro_torch.launch.train.main
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 512
TRAIN_ARGS = ["--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--lr", "1e-3", "--log-every", "1"]
# kernel route vs the plain ("chunked") route over the same steps: the first
# step's loss and grad norm, then every later loss, relative; the plain
# route runs the first PLAIN_TRAIN_STEPS steps (the first and a later one)
TRAIN_LOSS0_TOL, TRAIN_GNORM0_TOL, TRAIN_LOSS_TOL = 1e-5, 1e-4, 1e-3
PLAIN_TRAIN_STEPS = 2
RESUME_TOL = 1e-6  # relative, only where the card is not deterministic
RESUME_DEPTH_CUT = 8  # the exact resume runs an eighth of the layers, at full width
# phase 22: the launch tooling's steps on the card, each timed over this
# many warm calls after the first, which is compared with the direct call
# and the plain route
LAUNCH_ARCH, LAUNCH_SSM_ARCH, LAUNCH_REPS, LAUNCH_SEED = "qwen3_0_6b", "mamba2_780m", 3, 0
# the 32k prefills' plain-route gate runs on a step of its own at this
# length (its own arguments, kernel and plain route both), for the time
LAUNCH_PLAIN_LEN = 8_192


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------- workloads ----------------------------------


def make_keys(rng, n: int):
    """``n`` distinct non-negative int32 keys in rank order (rank 1 first)."""
    import numpy as np

    # np.unique's result by a sort and a mask: numpy 2.3's np.unique took most
    # of the 2^24-key tree's 51 s set-up on the card's host (9 s since)
    k = np.sort(rng.integers(0, 2**31 - 1, size=n + n // 8 + 1024, dtype=np.int64))
    k = k[np.concatenate(([True], k[1:] != k[:-1]))]
    if len(k) < n:
        raise RuntimeError("key draw came up short")
    return rng.permutation(k)[:n].astype(np.int32)


def make_queries(rng, keys, B: int):
    """90% stored keys drawn by rank with p ~ rank^-ZIPF_S, 10% absent."""
    import numpy as np

    n = len(keys)
    n_hit = int(round(0.9 * B))
    w = np.arange(1, n + 1, dtype=np.float64) ** -ZIPF_S
    hits = keys[rng.choice(n, size=n_hit, p=w / w.sum())]
    stored = np.sort(keys.astype(np.int64))
    cand = rng.integers(0, 2**31 - 1, size=4 * (B - n_hit) + 64, dtype=np.int64)
    pos = np.clip(np.searchsorted(stored, cand), 0, n - 1)
    absent = cand[stored[pos] != cand][: B - n_hit]
    if len(absent) < B - n_hit:
        raise RuntimeError("absent-key draw came up short")
    q = np.concatenate([hits.astype(np.int64), absent])
    return rng.permutation(q).astype(np.int32)


def build_structure(kind: str, n_keys: int, rng, *, n_buckets: int = 0, B: int = B_MAIN):
    """(arena on the card, {route: iterator}, ptr0, scr0, oracle).

    The routes are ``"isa"`` (the structure's find as a PULSE ISA program)
    and ``"native"`` (the structure's own iterator written in torch, which
    the kernel runs on its native body).  ``oracle(res, idx)`` checks lanes
    ``idx`` of an ExecResult against the structure's ``ref_find`` (hash
    table and B+tree; None otherwise)."""
    import numpy as np
    import torch

    from repro_torch.core import isa
    from repro_torch.core.structures import bst, btree, hash_table, isa_programs
    from repro_torch.core.structures import linked_list

    keys = make_keys(rng, n_keys)
    values = rng.integers(0, 2**31 - 1, n_keys).astype(np.int32)
    q = make_queries(rng, keys, B)
    qt = torch.from_numpy(q).cuda()
    oracle = None
    if kind == "list":
        arena, head = linked_list.build(keys, values)
        native = linked_list.find_iterator()
        ptr0, scr0 = native.init(qt, head)
        prog = isa_programs.list_find_program()
    elif kind == "hash":
        arena, heads = hash_table.build(keys, values, n_buckets)
        native = hash_table.find_iterator(n_buckets)
        ptr0, scr0 = native.init(qt, heads)
        prog = isa_programs.hash_find_program()

        def oracle(res, idx):
            want = hash_table.ref_find(keys, values, n_buckets, q[idx])
            return _check_find(res, idx, want, hops=True)
    elif kind == "bst":
        arena, root, _ = bst.build(keys, values)
        native = bst.find_iterator()
        ptr0, scr0 = native.init(qt, root)
        prog = isa_programs.bst_find_program()
    else:
        arena, root, _ = btree.build(keys, values)
        native = btree.find_iterator()
        ptr0, scr0 = native.init(qt, root)
        prog = isa_programs.btree_find_program()

        def oracle(res, idx):
            want = btree.ref_find(keys, values, q[idx])
            return _check_find(res, idx, want, hops=False)
    routes = {"isa": isa.as_pulse_iterator(prog), "native": native}
    return arena, routes, ptr0, scr0, oracle


def build_aggregate(kind: str, n_keys: int, rng, *, B: int = B_MAIN):
    """(arena on the card, iterator, ptr0, scr0) for the two stateful
    iterators: ``list_sum`` over 64 lists of a pooled heap (lane i sums list
    i % 64) and ``btree_range_agg`` over windows of up to 4,096 keys; the
    values span int32, so the sums wrap."""
    import numpy as np
    import torch

    from repro_torch.core.arena import ArenaBuilder
    from repro_torch.core.structures import btree, linked_list

    keys = make_keys(rng, n_keys)
    values = rng.integers(-(2**31), 2**31 - 1, n_keys).astype(np.int32)
    if kind == "list_sum":
        b = ArenaBuilder(n_keys, linked_list.NODE_WORDS)
        cuts = np.sort(rng.choice(np.arange(1, n_keys), 63, replace=False))
        heads = [linked_list.build_into(b, k, v)
                 for k, v in zip(np.split(keys, cuts), np.split(values, cuts))]
        it = linked_list.sum_iterator()
        ptr0, scr0 = it.init(torch.tensor(heads, dtype=torch.int32).cuda().repeat(B // 64 + 1)[:B])
        return b.finish(device="cuda"), it, ptr0, scr0
    arena, root, _ = btree.build(keys, values)
    it = btree.range_aggregate_iterator()
    top = min(2**31 // n_keys * 512, 2**30)  # windows of up to ~512 keys
    lo = torch.from_numpy(rng.integers(0, 2**31 - 1 - top, B).astype(np.int32)).cuda()
    span = torch.from_numpy(rng.integers(0, top, B).astype(np.int32)).cuda()
    ptr0, scr0 = it.init(lo, lo + span, root)
    return arena, it, ptr0, scr0


def build_skiplist(n_keys: int, rng, *, B: int = B_MAIN):
    """(arena on the card, find iterator, ptr0, scr0, (keys, values)) of a
    skip list of ``n_keys`` keys and ``B`` YCSB-Zipfian queries."""
    import numpy as np
    import torch

    from repro_torch.core.structures import skiplist

    keys = make_keys(rng, n_keys)
    values = rng.integers(0, 2**31 - 1, n_keys).astype(np.int32)
    arena, head = skiplist.build(keys, values)
    it = skiplist.find_iterator()
    ptr0, scr0 = it.init(torch.from_numpy(make_queries(rng, keys, B)).cuda(), head)
    return arena, it, ptr0, scr0, (keys, values)


def _check_find(res, idx, want, *, hops: bool) -> bool:
    import numpy as np

    scr = res.scratch.cpu().numpy()[idx]
    got = [(int(s[1]), int(s[2])) for s in scr]
    if got != [(w[0], w[1]) for w in want]:
        return False
    if hops:  # chain walks: iterations == nodes visited
        return list(res.iters.cpu().numpy()[idx]) == [w[2] for w in want]
    return bool(np.all(res.status.cpu().numpy()[idx] == 1))


# ------------------------------ measurement ---------------------------------


def work_bytes(rows: int, B: int, W: int, S: int, T: int) -> int:
    """Bytes the work must move: W*4 per node row read, the lane state
    (ptr, status, iters, scratch) in and out once and the program once.
    The work is all gathers and integer compares, so bytes bound it.
    ``rows`` is the distinct rows the run visits (each input read once), or
    its executed lane-steps for the count that gives no row a second use."""
    return rows * W * 4 + 2 * B * (3 + S) * 4 + T * 16


def visited_rows(arena, logic, ptr0, scr0, depth: int) -> int:
    """Distinct arena rows a run of ``depth`` steps loads: one step at a
    time, the clamped pointer of every lane still active."""
    import torch

    from repro_torch.kernels.pulse_chase import ops

    cap = arena.capacity
    p, s, st = ptr0, scr0, torch.zeros_like(ptr0)
    seen = []
    for _ in range(depth):
        seen.append(torch.where(st == 0, p.clamp(0, cap - 1), -1))
        p, s, st, _ = ops.pulse_chase(arena.data, p, s, st, logic_fn=logic, num_steps=1)
    rows = torch.unique(torch.cat(seen))
    return int((rows >= 0).sum().item())


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cuda_rotating(fns, rounds: int) -> float:
    """Mean milliseconds per call of ``fns`` called in turn, ``rounds``
    times over, by CUDA events: with inputs that together exceed the 50 MB
    L2, each call finds its own inputs cold, as a decode step finds each
    layer's pages."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(fns))


def kernel_device_ms(fns, rounds: int, *names: str):
    """Mean device time per call of ``fns`` of the kernels whose names
    contain any of ``names`` (summed, where one call launches several), over
    ``rounds`` passes of ``fns``, from the profiler's kernel timestamps
    (``kernel_breakdown_ms``): unlike CUDA events around a run, it leaves
    out the gaps where the card waits for the host to launch a short
    kernel.  None when the profiler saw no such kernel."""
    ms = [v for k, v in (kernel_breakdown_ms(fns, rounds, tries=1) or {}).items()
          if any(n in k for n in names)]
    return sum(ms) if ms else None


def profiled_ms(fns, rounds: int, *names: str, tries: int = 3):
    """``kernel_device_ms``, taken again when a profiled window shows none
    of the kernels (the profiler can drop a window's kernel records);
    None when every try misses."""
    for _ in range(tries):
        ms = kernel_device_ms(fns, rounds, *names)
        if ms is not None:
            return ms
    return None


def kernel_name(key: str) -> str:
    """A profiler kernel key without its namespace of no name, template
    arguments, parameters and return type: ``commit_key``,
    ``at_cuda_detail::cub::DeviceRadixSortOnesweepKernel``."""
    key = key.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in key:
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch not in "<>":
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).removeprefix("void ").strip()


def kernel_breakdown_ms(fns, rounds: int, skip=("Memcpy", "Memset"), tries: int = 3):
    """Mean device ms per call of ``fns`` of every kernel the profiler saw,
    by ``kernel_name`` (instantiations of one template summed; copies and
    fills left out), over ``rounds`` passes; taken again when a window
    shows no kernel; None when every try misses."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count and not any(k in e.key for k in skip):
                name = kernel_name(e.key)
                out[name] = out.get(name, 0.0) + e.self_device_time_total / (
                    rounds * len(fns)) / 1e3
        if out:
            return out
    return None


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def kernel_vs_plain(arena, it, ptr0, scr0, num_steps: int):
    """One launch of the fixed-depth kernel and one of its plain version on
    the same CUDA tensors; returns (outputs equal?, max |diff|)."""
    import torch

    from repro_torch.kernels.pulse_chase import ops, ref

    logic = ops.iterator_logic(it)
    st0 = torch.zeros_like(ptr0)
    got = ops.pulse_chase(arena.data, ptr0, scr0, st0, logic_fn=logic, num_steps=num_steps)
    want = ref.chase_reference(arena.data, ptr0, scr0, st0, torch.zeros_like(ptr0), logic,
                               num_steps)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(want, got))
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    return same, err


def run_vs_plain(arena, it, ptr0, scr0, max_steps: int, quantum: int):
    """``pulse_chase_run`` (one launch) against ``chase_run_reference`` on
    the same CUDA tensors, with a fault check that revokes the arena's
    first quarter and lanes that enter NULL or past the arena's end;
    returns (outputs equal?, max |diff|, faulted lanes)."""
    import torch

    from repro_torch.kernels.pulse_chase import ops, ref

    logic = ops.iterator_logic(it)
    cap = arena.capacity
    check = ops.FaultCheck(torch.tensor([0, cap // 4, cap], dtype=torch.int32, device="cuda"),
                           torch.tensor([0, 1], dtype=torch.int32, device="cuda"), cap)
    ptr0 = ptr0.clone()
    ptr0[1], ptr0[5] = -1, cap + 3
    st0 = torch.zeros_like(ptr0)
    st0[7] = 1
    p, s, st, stats = ops.pulse_chase_run(arena.data, ptr0, scr0, st0, logic_fn=logic,
                                          max_steps=max_steps, depth_quantum=quantum,
                                          fault_fn=check)
    want = ref.chase_run_reference(arena.data, ptr0, scr0, st0, logic, max_steps, quantum,
                                   check)
    got = (p, s, st, stats.retire_step, stats.faulted)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(want, got))
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    return same, err, int(stats.faulted.sum().item())


# --------------------------------- phases -----------------------------------


def phase_device():
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.pulse_chase import kernel as chase_kernel
    from repro_torch.kernels.pulse_commit import kernel as commit_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")
    sources = [chase_kernel.SOURCE, flash_kernel.SOURCE, paged_kernel.SOURCE, ssd_kernel.SOURCE,
               commit_kernel.SOURCE]
    t0 = time.perf_counter()
    libs = _build.build_all(sources)
    log(f"built {', '.join(so.name for so in libs)} in {time.perf_counter() - t0:.1f} s")
    report = {}  # kernel -> [(entry function, ptxas's resource line)]
    for src in sources:
        log(f"  {src.name}:")
        entry, report[src.name] = "", []
        for line in src.build_log().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "ptxas info" in line and "Used" in line:
                report[src.name].append((entry, line.split(":", 1)[1].strip()))
            elif "spill" in line and ("paged_decode" in entry
                                      or not line.strip().endswith("0 bytes spill loads")):
                report[src.name].append((entry, line.strip()))
        for entry, info in report[src.name]:
            log(f"    {entry}: {info}")
    return name, smi, report


def ptxas_summary(report, name: str):
    """Registers (least, most) and the largest stack frame and spill bytes
    over the entries of a build report whose names contain ``name``."""
    regs, worst = [], 0
    for entry, info in report:
        if name not in entry:
            continue
        if "registers" in info:
            regs.append(int(info.split("Used")[1].split()[0]))
        if "stack frame" in info:
            worst = max([worst] + [int(n) for n in re.findall(r"(\d+) bytes", info)])
    return dict(instantiations=len(regs), registers=[min(regs), max(regs)] if regs else None,
                max_stack_or_spill_bytes=worst)


def phase_kernel_vs_plain(rng):
    """Both entry points, every body: the four ISA read programs and the six
    native bodies, small and at the paper's size."""
    from repro_torch.kernels.pulse_chase import ops

    cases = [
        # (structure, keys, buckets, lanes, steps)
        ("list", 64, 0, 256, 80),
        ("list", 4096, 0, B_MAIN, 64),
        ("hash", 256, 32, 256, 64),
        ("hash", 200_000, 4096, B_MAIN, 64),
        ("bst", 512, 0, 256, 16),
        ("bst", 500_000, 0, B_MAIN, 24),
        ("btree", 512, 0, 256, 8),
        ("btree", 500_000, 0, B_MAIN, 8),
        ("list_sum", 512, 0, 256, 40),
        ("list_sum", 200_000, 0, B_MAIN, 64),
        ("btree_range_agg", 512, 0, 256, 16),
        ("btree_range_agg", 500_000, 0, B_MAIN, 24),
        ("skiplist_find", 512, 0, 256, 40),
        ("skiplist_find", 65_536, 0, B_MAIN, 64),
    ]
    # whole runs: budgets on and off the depth quantum (small); at the
    # paper's size the default quantum, and for the native bodies a budget
    # the lanes finish within (the interpreter's plain version, the ISA VM
    # in torch, takes ~70 ms a step there)
    runs = {(256, "isa"): ((13, 4), (10, 8), (64, 8)), (256, "native"): ((13, 4), (10, 8), (64, 8)),
            (B_MAIN, "isa"): ((64, 8),), (B_MAIN, "native"): ((64, 8), (4096, 8))}
    before = ops.pulse_chase.launches
    checks = []

    def record(entry, body, n, B, steps, quantum, same, err, faulted=None):
        row = dict(entry=entry, body=body, keys=n, lanes=B, num_steps=steps, quantum=quantum,
                   bit_equal=same, max_abs_err=err, faulted_lanes=faulted)
        checks.append(row)
        log(f"  {entry:16s} {body:16s} keys={n:>7d} lanes={B:>6d} steps={steps:>4d} "
            f"quantum={quantum} bit_equal={same} max_abs_err={err}"
            + ("" if faulted is None else f" faulted={faulted}"))
        if not same:
            raise AssertionError(f"pulse_chase {entry} disagrees with its plain version "
                                 f"on {body}")

    for kind, n, nb, B, steps in cases:
        if kind in ("list_sum", "btree_range_agg"):
            arena, it, ptr0, scr0 = build_aggregate(kind, n, rng, B=B)
            routes = {"native": it}
        elif kind == "skiplist_find":
            arena, it, ptr0, scr0, _ = build_skiplist(n, rng, B=B)
            routes = {"native": it}
        else:
            arena, routes, ptr0, scr0, _ = build_structure(kind, n, rng, n_buckets=nb, B=B)
        for route, it in routes.items():
            body = f"{it.name} ({route})"
            same, err = kernel_vs_plain(arena, it, ptr0, scr0, steps)
            record("pulse_chase", body, n, B, steps, None, same, err)
            for max_steps, quantum in runs[B, route]:
                same, err, faulted = run_vs_plain(arena, it, ptr0, scr0, max_steps, quantum)
                record("pulse_chase_run", body, n, B, max_steps, quantum, same, err, faulted)
        del arena
    n_launch = ops.pulse_chase.launches - before
    log(json.dumps({"phase": "kernel_vs_plain", "name": "pulse_chase",
                    "launches": n_launch, "mismatches": 0, "checks": checks}))
    return checks


def _timed_launches(fn):
    """Run ``fn`` with CUDA events around every kernel launch; returns
    (result, per-launch milliseconds)."""
    import torch

    from repro_torch.kernels.pulse_chase import kernel

    real, events = kernel.launch, []

    def timed(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kwargs)
        b.record()
        events.append((a, b))
        return out

    kernel.launch = timed
    try:
        out = fn()
    finally:
        kernel.launch = real
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in events]


def phase_main(rng, workloads):
    import numpy as np
    import torch

    from repro_torch.core.engine import PulseEngine
    from repro_torch.core.iterator import STATUS_DONE, STATUS_FAULT
    from repro_torch.kernels.pulse_chase import kernel, ops, ref

    l2_size = torch.cuda.get_device_properties(0).L2_cache_size
    rows = []
    for wl in workloads:
        t0 = time.perf_counter()
        arena, routes, ptr0, scr0, oracle = build_structure(
            wl["structure"], wl["n_keys"], rng, n_buckets=wl["n_buckets"])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng = PulseEngine(arena)
        log(f"[{wl['name']}] {wl['n_keys']} keys, arena {arena.capacity} x {arena.node_words} "
            f"words ({arena.capacity * arena.node_words * 4 / 1e6:.1f} MB), set-up "
            f"{setup_s:.1f} s")
        run = dict(max_iters=4096)
        first = None
        for route, it in routes.items():
            decision = eng.dispatch(it)
            # the main path, with the launch count read around it
            torch.cuda.reset_peak_memory_stats()
            ops.pulse_chase.launches = 0
            res = eng.execute(it, ptr0, scr0, **run)
            torch.cuda.synchronize()
            launches = ops.pulse_chase.launches
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            if launches != 1 or not res.offloaded:
                raise AssertionError(f"{wl['name']} ({route}): execute launched {launches} "
                                     f"kernels, not exactly one")
            for f in ("ptr", "scratch", "status", "iters"):
                t = getattr(res, f)
                if not (t.is_cuda and t.dtype == torch.int32 and t.shape[0] == B_MAIN):
                    raise AssertionError(f"{wl['name']}: bad {f} {t.dtype} {tuple(t.shape)}")

            ref_res = eng.execute(it, ptr0, scr0, backend="reference", **run)
            torch.cuda.synchronize()
            for f in ("ptr", "scratch", "status", "iters"):
                if not torch.equal(getattr(res, f), getattr(ref_res, f)):
                    raise AssertionError(f"{wl['name']} ({route}): kernel and reference "
                                         f"backends differ on {f}")
                if first is not None and not torch.equal(getattr(res, f), getattr(first, f)):
                    raise AssertionError(f"{wl['name']}: the ISA and native routes differ on {f}")
            first = first or res
            sample = np.sort(np.random.default_rng(1).choice(B_MAIN, 1024, replace=False))
            if not oracle(res, sample):
                raise AssertionError(f"{wl['name']} ({route}): results disagree with ref_find")
            status = res.status.cpu().numpy()
            if not np.all((status == STATUS_DONE) | (status == STATUS_FAULT)):
                raise AssertionError(f"{wl['name']} ({route}): lanes left unfinished")

            # end-to-end rate: host clock around work that ends in a synchronise
            secs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.execute(it, ptr0, scr0, **run)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            # the kernel's device time inside execute (the profiler's kernel
            # timestamps) over execute's wall time: the device's busy share;
            # CUDA events around the launch also hold the wrapper's host time
            in_execute = profiled_ms(
                [lambda: eng.execute(it, ptr0, scr0, **run)], 5, "chase_kernel")
            if in_execute is None:
                raise AssertionError(f"{wl['name']}: the profiler saw no pulse_chase kernel")
            busy = in_execute / (float(np.median(secs)) * 1e3)
            _, per_launch = _timed_launches(lambda: eng.execute(it, ptr0, scr0, **run))
            grid = kernel.launch.last_grid

            # one fixed-depth launch over the whole batch to full depth:
            # kernel, plain, bound
            iters = res.iters.long()
            depth = int(iters.max().item())
            logic = ops.iterator_logic(it)
            st0 = torch.zeros_like(ptr0)
            scr0c = scr0.reshape(B_MAIN, it.scratch_words).contiguous()
            one = ops.pulse_chase(arena.data, ptr0, scr0c, st0, logic_fn=logic,
                                  num_steps=depth)
            torch.cuda.synchronize()
            lane_steps = int(one[3].long().sum().item())
            full = [lambda: ops.pulse_chase(arena.data, ptr0, scr0c, st0, logic_fn=logic,
                                            num_steps=depth)]
            k_events = time_cuda(full[0], 10)
            k_ms = profiled_ms(full, 10, "chase_kernel")
            ms_source = "events" if k_ms is None else "profiler"
            k_ms = k_events if k_ms is None else k_ms
            n_code = len(logic.program) if logic.program is not None else 0
            rows_seen = visited_rows(arena, logic, ptr0, scr0c, depth)
            nbytes = work_bytes(rows_seen, B_MAIN, arena.node_words, it.scratch_words, n_code)
            nbytes_steps = work_bytes(lane_steps, B_MAIN, arena.node_words, it.scratch_words,
                                      n_code)
            arena_bytes = arena.capacity * arena.node_words * 4
            in_l2 = arena_bytes < l2_size
            # the plain version timed where the arena lies beyond L2 (the
            # kernels line's workload) alone: the time's cut
            p_ms = None if in_l2 else time_cuda(lambda: ref.chase_reference(
                arena.data, ptr0, scr0c, st0, torch.zeros_like(ptr0), logic, depth), 1)
            done = res.status == STATUS_DONE
            body = "isa" if logic.program is not None else logic.native.name
            row = dict(
                workload=wl["name"], route=route, body=body, keys=wl["n_keys"], lanes=B_MAIN,
                arena_mb=arena_bytes / 1e6, setup_s=setup_s,
                launches=launches, chunks=res.stats.chunks, grid_blocks=grid,
                blocks_per_sm=kernel.blocks_per_sm(
                    body, T=n_code, S=it.scratch_words, W=arena.node_words,
                    n_fault_words=arena.bounds.shape[0] + arena.perms.shape[0]),
                kernel_ms_in_execute=in_execute, device_busy_in_execute=busy,
                kernel_ms_in_execute_events=float(np.sum(per_launch)),
                execute_s=secs, lookups_per_s=B_MAIN / min(secs),
                lookups_per_s_each=[B_MAIN / x for x in secs],
                iters_mean=float(iters[done].float().mean().item()),
                iters_max=int(iters.max().item()),
                faulted_lanes=int((res.status == STATUS_FAULT).sum().item()),
                peak_mb=peak_mb,
                full_depth_steps=depth, full_depth_lane_steps=lane_steps,
                full_depth_rows=rows_seen, ms=k_ms, ms_source=ms_source, ms_events=k_events,
                plain_ms=p_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_ms_lane_steps=nbytes_steps / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", bound_rate="HBM", arena_in_l2=in_l2,
                # an arena that fits in L2 is never read from HBM: its least
                # time at the L2 rate lies below this HBM bound, so
                # kernel/bound understates how far the kernel is from the
                # card's limit
                bound_note=("HBM bound; the arena is L2-resident, so the least time is "
                            "below it" if in_l2 else "HBM bound; the gathers come from HBM"),
                dispatch_offload=decision.offload, dispatch_reason=decision.reason,
                offloaded=res.offloaded,
            )
            log(f"[{wl['name']}] {route} ({body}): launches={launches} grid={grid} blocks "
                f"({row['blocks_per_sm']}/SM) lookups/s={row['lookups_per_s']:.4g} "
                f"(execute s {[round(x, 6) for x in secs]}) kernel ms in execute "
                f"{in_execute:.5f} (profiler; CUDA events {row['kernel_ms_in_execute_events']:.4f}), "
                f"device busy {100 * busy:.1f}% iters mean={row['iters_mean']:.2f} "
                f"max={row['iters_max']} peak={peak_mb:.1f} MiB; dispatch model: "
                f"{decision.reason}")
            plain = "not timed" if p_ms is None else f"{p_ms:.4f} ms"
            log(f"[{wl['name']}] {route}: one fixed-depth launch, {depth} steps, {lane_steps} "
                f"lane-steps over {rows_seen} distinct rows: kernel {k_ms:.5f} ms ({ms_source}; "
                f"CUDA events {k_events:.5f}), plain {plain}, bytes bound {row['bound_ms']:.5f} "
                f"ms ({row['bound_note']}; {row['bound_ms_lane_steps']:.5f} ms counting every "
                f"lane-step's row)")
            rows.append(row)
            del res, ref_res
        del arena, eng, first
        torch.cuda.empty_cache()
    return rows


# ------------------------------- write path ---------------------------------

READBACK_SAMPLE = 1024  # untouched keys read back per batch
SKIP_KEYS, SKIP_OPS = 65_536, 4_096  # skiplist_rw: keys, then inserts and deletes


def _digest(arena) -> str:
    """A checksum of an arena's data and heap (read on the host)."""
    import hashlib

    h = hashlib.sha256()
    for t in (arena.data, arena.heap):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _stats_diff(a, b):
    """The names of the RoutingStats fields on which two runs differ."""
    import dataclasses

    import numpy as np

    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        if not same:
            out.append(f.name)
    return out


def _lookup(keys_sorted, vals_sorted, q):
    """(found, value) of each query in a sorted key table."""
    import numpy as np

    i = np.clip(np.searchsorted(keys_sorted, q), 0, len(keys_sorted) - 1)
    found = keys_sorted[i] == q
    return found, np.where(found, vals_sorted[i], 0)


def _arena_fields(b):
    """The host arrays of a builder's arena (data, bounds, perms, heap)."""
    ar = b.finish(device="cpu")
    return [t.numpy().copy() for t in (ar.data, ar.bounds, ar.perms, ar.heap)]


def _untouched(rng, pool, n):
    import numpy as np

    return rng.choice(pool, min(n, len(pool)), replace=False).astype(np.int32)


def _placement(P, policy, used, allocating):
    """``(builder, placement)``: ``builder(W)`` an ``ArenaBuilder`` for
    ``used`` rows over ``P`` shards (``sequential`` at one shard) with room
    on every shard for the ALLOCs of its home records (``allocating``: the
    batch positions of the records that allocate; record ``i``'s home is
    ``i % P``), and the placement's description."""
    import numpy as np

    from repro_torch.core.arena import ArenaBuilder

    policy = policy if P > 1 else "sequential"
    allocs = np.bincount(np.asarray(allocating, np.int64) % P, minlength=P)
    per = -(-used // P) + int(allocs.max())

    def builder(W):
        return ArenaBuilder(per * P, W, num_shards=P, policy=policy)

    return builder, dict(policy=policy, memory_nodes=P, allocs_per_home=allocs.tolist())


def _headroom(fields, placement):
    """Each shard's spare rows after the build, beside its home ALLOCs."""
    from repro_torch.core.arena import H_BUMP

    bounds, heap = fields[1], fields[3]
    return dict(placement, spare_rows=[int(bounds[s + 1] - heap[s, H_BUMP])
                                       for s in range(len(bounds) - 1)])


def _webservice_rw(rng, P=1):
    """The writable hash table (the paper's Table 3 size) under 90% YCSB
    finds, 5% inserts of fresh keys and 5% deletes of stored keys (one per
    bucket, never a chain's tail); over ``P`` shards placed
    ``interleaved``, each with room for its home inserts."""
    import numpy as np
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core.structures import hash_table, linked_list

    ws = pulse_paper.WEBSERVICE
    n, NB, B = ws.n_keys, ws.n_buckets, B_MAIN
    n_ins = n_del = int(round(0.05 * B))
    allk = make_keys(rng, n + 2 * n_ins)
    stored = allk[:n]
    values = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    finds = make_queries(rng, stored, B - n_ins - n_del)
    fresh = allk[n:][~np.isin(allk[n:], finds)][:n_ins]
    fresh_vals = rng.integers(0, 2**31 - 1, n_ins).astype(np.int32)
    # victims: one per bucket, never the chain's tail (the bucket's first
    # key in build order: the build pushes each key in front)
    kb = hash_table._np_hash(stored, NB)
    order = np.argsort(kb, kind="stable")
    starts = np.flatnonzero(np.r_[True, kb[order][1:] != kb[order][:-1]])
    counts = np.diff(np.r_[starts, n])
    pick = rng.choice(np.flatnonzero(counts >= 2), n_del, replace=False)
    offs = 1 + (rng.random(n_del) * (counts[pick] - 1)).astype(np.int64)
    victims = stored[order[starts[pick] + offs]]
    ops = np.concatenate([np.zeros(len(finds)), np.ones(n_ins), np.full(n_del, 2)])
    qk = np.concatenate([finds, fresh, victims]).astype(np.int32)
    qv = np.concatenate([np.zeros(len(finds)), fresh_vals, np.zeros(n_del)]).astype(np.int32)
    perm = rng.permutation(B)
    ops, qk, qv = ops[perm].astype(np.int32), qk[perm], qv[perm]
    builder, placement = _placement(P, "interleaved", NB + n, np.flatnonzero(ops == 1))
    b = builder(hash_table.NODE_WORDS)
    sent = hash_table.build_writable(b, stored, values, NB)
    it = hash_table.rw_iterator(NB)
    p0, s0 = it.init(ops, qk, qv, sent)
    srt = np.argsort(stored)
    ks, vs = stored[srt], values[srt]

    def check(st, scr):
        bad = []
        if not (st == 1).all():
            bad.append(f"{int((st != 1).sum())} records not DONE")
        f = ops == linked_list.OP_FIND
        hit = f & (scr[:, linked_list.RW_RES] == 1)
        known, want = _lookup(ks, vs, qk[hit])
        if not known.all() or not (scr[hit, linked_list.RW_VAL] == want).all():
            bad.append("a find reported a wrong value")
        if not (scr[ops == linked_list.OP_DELETE, linked_list.RW_RES] == 1).all():
            bad.append("a delete of a stored key missed")
        if not (scr[ops == linked_list.OP_INSERT, linked_list.RW_RES] >= 0).all():
            bad.append("an insert holds no address")
        return bad, dict(finds_found=int(hit.sum()), finds=int(f.sum()))

    sample = _untouched(rng, np.setdiff1d(stored, victims), READBACK_SAMPLE)
    rq = np.concatenate([fresh, victims, sample])
    rwant = (np.r_[np.ones(n_ins), np.zeros(n_del), np.ones(len(sample))].astype(bool),
             np.r_[fresh_vals, np.zeros(n_del, np.int32), _lookup(ks, vs, sample)[1]])
    fit = hash_table.find_iterator(NB)
    fields = _arena_fields(b)
    return dict(name="webservice_rw", structure="hash", keys=n, fields=fields,
                placement=_headroom(fields, placement),
                steps=[("rw", it, p0, s0)], check=[check],
                readback=(fit, *fit.init(torch.from_numpy(rq), sent), rwant),
                traffic=dict(finds=len(finds), inserts=n_ins, deletes=n_del))


def _wiredtiger_update(rng, P=1):
    """The B+tree (the paper's Table 3 size) under in-place value updates of
    distinct keys, drawn uniformly without replacement; over ``P`` shards
    placed ``sequential`` (range partitioning; it allocates nothing)."""
    import numpy as np
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core.structures import btree

    n = pulse_paper.WIREDTIGER.n_keys
    keys = make_keys(rng, n)
    values = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    builder, placement = _placement(P, "sequential", btree.node_estimate(n), [])
    b = builder(btree.NODE_WORDS)
    root, height = btree.build_into(b, keys, values)
    upd = rng.choice(n, B_MAIN, replace=False)
    q, nv = keys[upd], rng.integers(0, 2**31 - 1, B_MAIN).astype(np.int32)
    it = btree.update_iterator()
    p0, s0 = it.init(torch.from_numpy(q), torch.from_numpy(nv), root)

    def check(st, scr):
        bad = []
        if not (st == 1).all():
            bad.append("records not DONE")
        if not (scr[:, btree.U_FOUND] == 1).all():
            bad.append("an update missed its key")
        return bad, {}

    sample = _untouched(rng, np.setdiff1d(np.arange(n), upd), READBACK_SAMPLE)
    rq = np.concatenate([q, keys[sample]])
    rwant = (np.ones(len(rq), bool), np.concatenate([nv, values[sample]]))
    fit = btree.find_iterator()
    fields = _arena_fields(b)
    return dict(name="wiredtiger_update", structure="btree", keys=n, fields=fields,
                placement=_headroom(fields, placement),
                steps=[("update", it, p0, s0)], check=[check],
                readback=(fit, *fit.init(torch.from_numpy(rq), root), rwant),
                traffic=dict(updates=B_MAIN, height=height))


def _skiplist_rw(rng, P=1):
    """A skip list of SKIP_KEYS keys: SKIP_OPS inserts of fresh keys, then
    SKIP_OPS deletes of build-time level-0 keys, no two of them neighbours;
    over ``P`` shards placed ``interleaved``, each with room for its home
    inserts."""
    import numpy as np
    import torch

    from repro_torch.core.structures import skiplist

    n, n_op = SKIP_KEYS, SKIP_OPS
    allk = make_keys(rng, n + n_op)
    stored, fresh = allk[:n], allk[n:]
    values = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    fresh_vals = rng.integers(0, 2**31 - 1, n_op).astype(np.int32)
    builder, placement = _placement(P, "interleaved", n + 1, np.arange(n_op))
    b = builder(skiplist.NODE_WORDS)
    head = skiplist.build_into(b, stored, values)
    srt = np.argsort(stored)
    ks, vs = stored[srt], values[srt]
    # level-0 keys at even ranks: no two victims are neighbours
    rank = np.flatnonzero((skiplist._level_of(np.arange(n)) == 0) & (np.arange(n) % 2 == 0))
    victims = ks[rng.choice(rank, n_op, replace=False)]
    ins, dele = skiplist.insert_iterator(), skiplist.delete_iterator()
    pi, si = ins.init(torch.from_numpy(fresh), torch.from_numpy(fresh_vals), head)
    pd, sd = dele.init(torch.from_numpy(victims), head)

    def check_insert(st, scr):
        return ([] if (st == 1).all() else ["insert: records not DONE"]), {}

    def check_delete(st, scr):
        bad = [] if (st == 1).all() else ["delete: records not DONE"]
        if not (scr[:, skiplist.SD_RES] == 1).all():
            bad.append("delete: a delete missed")
        return bad, {}

    sample = _untouched(rng, np.setdiff1d(stored, victims), READBACK_SAMPLE)
    rq = np.concatenate([fresh, victims, sample])
    rwant = (np.r_[np.ones(n_op), np.zeros(n_op), np.ones(len(sample))].astype(bool),
             np.r_[fresh_vals, np.zeros(n_op, np.int32), _lookup(ks, vs, sample)[1]])
    fit = skiplist.find_iterator()
    fields = _arena_fields(b)
    return dict(name="skiplist_rw", structure="skiplist", keys=n, fields=fields,
                placement=_headroom(fields, placement),
                steps=[("insert", ins, pi, si), ("delete", dele, pd, sd)],
                check=[check_insert, check_delete],
                readback=(fit, *fit.init(torch.from_numpy(rq), head), rwant),
                traffic=dict(inserts=n_op, deletes=n_op))


def write_batches(rng, P: int = 1):
    """The three batches of phases 10 (``P = 1``) and 12 (``MEM_NODES``
    shards), each a dict with the host arrays of its input arena
    (``fields``), its placement and each shard's headroom (``placement``),
    its steps (``steps``: name, iterator, ptr0, scr0 on the host), a check
    per step (``check``) and its read-back (``readback``: iterator, ptr0,
    scr0, the (found, value) wanted per lane)."""
    return [_webservice_rw(rng, P), _wiredtiger_update(rng, P), _skiplist_rw(rng, P)]


def _run_batch(wb, device: str):
    """Every step of a batch through ``PulseEngine.execute`` on a fresh
    engine over the batch's input arena on ``device``; returns (input
    arena, its digest before, [(ExecResult, seconds, peak MiB, kernel
    launches)], the engine's final arena)."""
    import torch

    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.kernels.pulse_chase import ops

    arena = arena_from_numpy(*wb["fields"], device=device)
    digest = _digest(arena)
    eng = PulseEngine(arena)
    runs = []
    for _, it, p0, s0 in wb["steps"]:
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = ops.pulse_chase.launches
        t0 = time.perf_counter()
        res = eng.execute(it, p0.to(device), s0.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20 if device == "cuda" else None
        runs.append((res, secs, peak, ops.pulse_chase.launches - before))
    return arena, digest, runs, eng.arena


def _store_class_on_card():
    """The store class on the card: the raw int32 shift past the word
    (reported), and the VM's staged mutation of a W = 40 program equal to
    the CPU's."""
    import numpy as np
    import torch

    from repro_torch.core import isa
    from repro_torch.core.arena import bit32

    k = torch.tensor([0, 31, 32, 33, 40, 63], dtype=torch.int32)
    raw = (torch.ones(6, dtype=torch.int32, device="cuda") << k.cuda()).cpu().tolist()
    raw_cpu = (torch.ones(6, dtype=torch.int32) << k).tolist()
    mask = bit32(k.cuda()).cpu().tolist()
    if mask != [1, -(2**31), 0, 0, 0, 0]:
        raise AssertionError(f"bit32 on the card gives {mask}")
    a = isa.Asm(scratch_words=2, node_words=40, name="wide")
    a.loadn(1, 33)
    for w in (3, 31, 32, 39):
        a.storen(w, 1)
    a.setptr(35, 1, 1)
    a.alloc(1)
    a.getptr(2)
    a.next_iter(2)
    code = a.finish().code
    g = np.random.default_rng(0)
    nodes = torch.from_numpy(g.integers(-9, 9, (64, 40)).astype(np.int32))
    ptr = torch.arange(64, dtype=torch.int32)
    scr = torch.zeros((64, 2), dtype=torch.int32)
    cpu = isa.run_iteration_mut(code, nodes, ptr, scr)
    card = isa.run_iteration_mut(code, nodes.cuda(), ptr.cuda(), scr.cuda())
    def flat(out):
        return [*out[:3], *out[3]]

    if not all(torch.equal(x, y.cpu()) for x, y in zip(flat(cpu), flat(card))):
        raise AssertionError("the store-class VM differs between the card and the CPU")
    row = dict(cuda_int32_shift=dict(zip(map(int, k), raw)),
               cpu_int32_shift=dict(zip(map(int, k), raw_cpu)), bit32=mask, vm_equal=True)
    log(f"  int32 1 << k on the card for k = {k.tolist()}: {raw} (CPU {raw_cpu}); "
        f"arena.bit32: {mask}; W = 40 store-class VM card == CPU")
    return row


def phase_write(rng):
    """Phase 10: the write path on the card, held against the CPU, then the
    committed arenas read back on the kernel."""
    import numpy as np
    import torch

    from repro_torch.core.engine import PulseEngine
    from repro_torch.kernels.pulse_chase import ops, ref

    t_phase = time.perf_counter()
    shift_row = _store_class_on_card()
    rows, readback_launches = [], 0
    body = None
    for wb in write_batches(rng):
        name = wb["name"]
        arena, digest, card, final = _run_batch(wb, "cuda")
        cpu_arena, _, host, cpu_final = _run_batch(wb, "cpu")
        if _digest(arena) != digest or _digest(cpu_arena) != digest:
            raise AssertionError(f"{name}: the input arena changed")
        if not (final.data.is_cuda and final.heap.is_cuda):
            raise AssertionError(f"{name}: the committed arena left the card")
        if not (torch.equal(final.data.cpu(), cpu_final.data)
                and torch.equal(final.heap.cpu(), cpu_final.heap)):
            raise AssertionError(f"{name}: the card's and the CPU's final arenas differ")
        steps = []
        for (sname, *_), check, (g, g_s, peak, g_launch), (c, c_s, _, _) in zip(
                wb["steps"], wb["check"], card, host):
            for f in ("ptr", "scratch", "status", "iters"):
                if not (getattr(g, f).is_cuda and torch.equal(getattr(g, f).cpu(),
                                                              getattr(c, f))):
                    raise AssertionError(f"{name}/{sname}: card and CPU differ on {f}")
            diff = _stats_diff(g.stats, c.stats)
            if diff:
                raise AssertionError(f"{name}/{sname}: RoutingStats differ on {diff}")
            if g_launch != 0:
                raise AssertionError(f"{name}/{sname}: the write path launched the read-only "
                                     f"kernel {g_launch} times")
            bad, extra = check(g.status.cpu().numpy(), g.scratch.cpu().numpy())
            if bad:
                raise AssertionError(f"{name}/{sname}: {'; '.join(bad)}")
            tr = g.commit_trace
            B = g.ptr.shape[0]
            st = dict(step=sname, ops=B, execute_s=g_s, ops_per_s=B / g_s, cpu_execute_s=c_s,
                      supersteps=g.stats.supersteps, commits=g.stats.commits,
                      epochs=g.stats.epochs, chase_s=float(np.sum(tr.chase_s)),
                      commit_s=float(np.sum(tr.commit_s)),
                      h2d_bytes_per_superstep=float(np.mean(tr.h2d_bytes)),
                      d2h_bytes_per_superstep=float(np.mean(tr.d2h_bytes)),
                      rows_written=int(np.sum(tr.rows_written)), peak_mib=peak,
                      iters_max=int(g.iters.max().item()), **extra)
            steps.append(st)
            log(f"[{name}] {sname}: {B} ops in {g_s:.4f} s on the card ({B / g_s:.4g} ops/s; "
                f"CPU copy {c_s:.4f} s): supersteps {st['supersteps']}, commits "
                f"{st['commits']}, epochs {st['epochs']}; chase {st['chase_s']:.4f} s, commit "
                f"{st['commit_s']:.4f} s; host->device {st['h2d_bytes_per_superstep'] / 1e6:.3f} "
                f"MB and device->host {st['d2h_bytes_per_superstep'] / 1e6:.3f} MB per "
                f"superstep, {st['rows_written']} rows written back; peak {peak:.1f} MiB; "
                f"card == CPU (records, stats, arena)")

        # the committed arena read back on the kernel's native body
        fit, rp, rs, (want_found, want_val) = wb["readback"]
        eng = PulseEngine(final)
        rp, rs = rp.cuda(), rs.cuda()
        ops.pulse_chase.launches = 0
        res = eng.execute(fit, rp, rs, max_iters=4096)
        torch.cuda.synchronize()
        launches = ops.pulse_chase.launches
        readback_launches += launches
        if launches != 1:
            raise AssertionError(f"{name}: the read-back launched {launches} kernels, not one")
        found = res.scratch[:, 2].cpu().numpy() == 1
        val = res.scratch[:, 1].cpu().numpy()
        if not (np.array_equal(found, want_found)
                and np.array_equal(val[want_found], want_val[want_found])):
            raise AssertionError(f"{name}: the read-back disagrees with the batch "
                                 f"({int((found != want_found).sum())} lanes found wrong)")
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute(fit, rp, rs, max_iters=4096)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        lanes = rp.shape[0]
        body_name = ops.iterator_logic(fit).native.name
        row = dict(batch=name, structure=wb["structure"], keys=wb["keys"], traffic=wb["traffic"],
                   steps=steps, readback_body=body_name, readback_lanes=lanes,
                   readback_launches=launches, readback_s=secs,
                   readback_lookups_per_s=lanes / min(secs),
                   readback_iters_max=int(res.iters.max().item()))
        log(f"[{name}] read-back of {lanes} keys on {body_name}: 1 launch, inserted/updated "
            f"found with their values, deleted gone, untouched unchanged; "
            f"{row['readback_lookups_per_s']:.4g} lookups/s (execute s "
            f"{[round(x, 6) for x in secs]})")

        if body_name == "skiplist_find":
            # the body at full depth: one fixed-depth launch over the lanes
            logic = ops.iterator_logic(fit)
            depth = int(res.iters.max().item())
            st0 = torch.zeros_like(rp)
            one = ops.pulse_chase(final.data, rp, rs, st0, logic_fn=logic, num_steps=depth)
            torch.cuda.synchronize()
            lane_steps = int(one[3].long().sum().item())
            full = [lambda: ops.pulse_chase(final.data, rp, rs, st0, logic_fn=logic,
                                            num_steps=depth)]
            k_events = time_cuda(full[0], 10)
            k_ms = profiled_ms(full, 10, "chase_kernel")
            p_ms = time_cuda(lambda: ref.chase_reference(final.data, rp, rs, st0,
                                                         torch.zeros_like(rp), logic, depth), 1)
            rows_seen = visited_rows(final, logic, rp, rs, depth)
            nbytes = work_bytes(rows_seen, lanes, final.node_words, fit.scratch_words, 0)
            body = dict(name=body_name, lanes=lanes, full_depth_steps=depth,
                        full_depth_lane_steps=lane_steps, full_depth_rows=rows_seen,
                        ms=k_events if k_ms is None else k_ms,
                        ms_source="events" if k_ms is None else "profiler", ms_events=k_events,
                        plain_ms=p_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes", launches=launches)
            log(f"[{name}] skiplist_find, one fixed-depth launch, {depth} steps, {lane_steps} "
                f"lane-steps over {rows_seen} distinct rows: kernel {body['ms']:.5f} ms "
                f"({body['ms_source']}; CUDA events {k_events:.5f}), plain {p_ms:.4f} ms, bytes "
                f"bound {body['bound_ms']:.5f} ms (the arena is L2-resident: the least time "
                f"is below it)")
        rows.append(row)
        del arena, cpu_arena, final, cpu_final, eng, res, card, host
        torch.cuda.empty_cache()
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s (CPU runs and read-backs "
        f"included)")
    log(json.dumps({"phase": "write_path", "batches": rows, "store_class": shift_row,
                    "skiplist_find": body}))
    return rows, body, readback_launches, shift_row


# ------------------------------ routing -------------------------------------

ROUTE_RUN = dict(max_iters=4096, k_local=4, compact=True,
                 schedule="dispatched")  # phase 11's execute arguments
ROUTE_CPU_CUT = 4  # phase 11's CPU copy runs the first quarter of each batch's queries
# the device-resident (schedule, fabric) pairs phases 11 and 12 run beside the dispatched one
ROUTE_SCHEDULES = [("fused", "dense"), ("pipelined", "dense")]
ROUTE_RING = [("pipelined", "ring")]  # phase 11's webservice
WRITE_RING = [("fused", "ring")]  # phase 12's webservice_rw


def routing_batches(rng, *, B: int = B_MAIN):
    """The batches of phase 11 on the paper's ``MEM_NODES`` memory nodes,
    each a dict with the host arrays of its arena (``fields``), its
    iterator, queries, ptr0, scr0 (on the host), the execute arguments and
    an oracle ``want(q) -> (value, found)``."""
    import numpy as np
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core.structures import btree, hash_table

    P = pulse_paper.MEM_NODES
    ws, wt = pulse_paper.WEBSERVICE, pulse_paper.WIREDTIGER
    out = []
    keys = make_keys(rng, ws.n_keys)
    values = rng.integers(0, 2**31 - 1, ws.n_keys).astype(np.int32)
    q = make_queries(rng, keys, B)
    arena, heads = hash_table.build(keys, values, ws.n_buckets, num_shards=P,
                                    policy="interleaved", device="cpu")
    it = hash_table.find_iterator(ws.n_buckets)
    p0, s0 = it.init(torch.from_numpy(q), torch.as_tensor(heads))
    out.append(dict(name=ws.name, structure="hash", keys=ws.n_keys, policy="interleaved",
                    arena=arena, it=it, q=q, p0=p0, s0=s0, run=dict(ROUTE_RUN),
                    want=lambda x, k=keys, v=values: [
                        w[:2] for w in hash_table.ref_find(k, v, ws.n_buckets, x)]))
    keys = make_keys(rng, wt.n_keys)
    values = rng.integers(0, 2**31 - 1, wt.n_keys).astype(np.int32)
    q = make_queries(rng, keys, B)
    arena, root, _ = btree.build(keys, values, num_shards=P, policy="sequential", device="cpu")
    it = btree.find_iterator()
    p0, s0 = it.init(torch.from_numpy(q), root)
    want = lambda x, k=keys, v=values: [tuple(w[:2]) for w in btree.ref_find(k, v, x)]  # noqa: E731
    base = dict(structure="btree", keys=wt.n_keys, policy="sequential", arena=arena, it=it,
                q=q, p0=p0, s0=s0, want=want)
    out.append(dict(base, name=wt.name, run=dict(ROUTE_RUN)))
    out.append(dict(base, name=f"{wt.name}_return_to_cpu", run=dict(ROUTE_RUN, return_to_cpu=True)))
    return P, out


def superstep_vs_plain(arena, it, p0, s0, P: int, *, advance: int = 2):
    """One superstep's local chase, after ``advance`` routed supersteps from
    the placement, on the kernel and on its plain version (the same CUDA
    tensors), both timed; returns a dict."""
    import torch

    from repro_torch.core import routing
    from repro_torch.kernels.pulse_chase import ops, ref

    pools, _ = routing.place_requests(p0, s0, P)
    step = routing.make_superstep(it, P, k_local=ROUTE_RUN["k_local"],
                                  max_iters=ROUTE_RUN["max_iters"], drain_done=True)
    for _ in range(advance):
        pools = step(pools, arena.data, arena.bounds, arena.perms)[0]
    logic = ops.iterator_logic(it)
    args = (arena.data, pools, arena.bounds, arena.perms)

    def kern():
        return ops.pulse_chase_superstep(*args, logic_fn=logic, k_local=ROUTE_RUN["k_local"],
                                         max_iters=ROUTE_RUN["max_iters"])

    def plain():
        return ref.chase_superstep_reference(*args, logic, ROUTE_RUN["k_local"],
                                             scratch_words=it.scratch_words,
                                             max_iters=ROUTE_RUN["max_iters"])

    got, want = kern(), plain()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    active = int((pools[..., routing.F_STATUS] == 0).sum().item())
    k_ms = profiled_ms([kern], 10, "chase_kernel")
    return dict(bit_equal=same, max_abs_err=max_abs_err(got, want), active_records=active,
                pool_records=int(pools.shape[0] * pools.shape[1]),
                ms=time_cuda(kern, 10) if k_ms is None else k_ms,
                ms_source="events" if k_ms is None else "profiler",
                plain_ms=time_cuda(plain, 3))


def call_breakdown(fn, n_ops: int = 8, warm: bool = True):
    """One profiled call of ``fn`` (after a warm-up call unless ``warm`` is
    False, for a caller that has just called it): its wall ms (host
    clock, ending in a synchronise), the device ms of all its kernels and
    their share of the wall time, the top kernels, the host operators with
    the most self time (ms and calls), and the host ms and calls of each
    ``routing.*`` span (``distributed_execute``'s placement, supersteps and
    decode, and inside a superstep its chase, switch and counter read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms, top = _device_ms(prof, events)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = {e.key: dict(ms=e.cpu_time_total / 1e3, calls=e.count) for e in host
             if e.key.startswith("routing.")}
    host = [e for e in host if not e.key.startswith("routing.")]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:n_ops]
    kernel_calls = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.key.startswith("routing."):
            name = kernel_name(e.key)
            kernel_calls[name] = kernel_calls.get(name, 0) + e.count
    return dict(wall_ms=wall_ms, device_ms=device_ms or 0.0, spans=spans,
                kernel_calls=kernel_calls,
                device_busy=(device_ms or 0.0) / wall_ms, top_kernels=top, host_op_ms=host_ms,
                host_ops=[dict(op=e.key[:60], self_cpu_ms=e.self_cpu_time_total / 1e3,
                               calls=e.count) for e in host])


SPANS = ("routing.place", "routing.superstep", "routing.chase", "routing.switch",
         "routing.counters", "routing.decode")


def log_spans(name, spans, wall_ms, supersteps):
    """Check that a profiled read call shows each ``routing.*`` span, with
    one chase, switch and counter read per superstep, and log the split:
    placement, supersteps (the chase, the switch and the counter read
    inside them), decode and the rest of the call."""
    if sorted(spans) != sorted(SPANS):
        raise AssertionError(f"{name}: the profiled call shows the spans {sorted(spans)}")
    for s in SPANS[1:-1]:
        if spans[s]["calls"] != supersteps:
            raise AssertionError(f"{name}: {spans[s]['calls']} {s} spans in {supersteps} "
                                 f"supersteps")
    rest = wall_ms - sum(spans[s]["ms"] for s in ("routing.place", "routing.superstep",
                                                  "routing.decode"))
    inner = ", ".join(f"{s.split('.')[1]} {spans[s]['ms']:.3f}" for s in SPANS[2:-1])
    log(f"[{name}] the profiled call's spans: placement {spans['routing.place']['ms']:.3f} ms, "
        f"{supersteps} supersteps {spans['routing.superstep']['ms']:.3f} ms ({inner} ms), "
        f"decode {spans['routing.decode']['ms']:.3f} ms, the rest of the call {rest:.3f} ms")


def device_resident_runs(name, engine_for, it, p0, s0, run, ref, combos, ref_arena=None,
                         profile=True):
    """The batch on each device-resident ``(schedule, fabric)`` of
    ``combos``, every call through ``engine_for().execute`` (a fresh
    ``PulseEngine`` on the batch's input arena over the card's mesh), held
    against the card's dispatched run ``ref`` (its ``ExecResult``; for a
    write batch ``ref_arena``, its committed arena): records bit-equal;
    ``supersteps``, ``local_only_steps``, ``total_wire_words``, the
    crossings, ``commits`` and ``epochs`` equal; ``schedule``, ``fabric``
    and ``fused`` as asked; the final ``data`` and ``heap`` bit-equal.  The
    first call captures once (``routing.CACHE_STATS.traces``; the kernels'
    counts set to 0 just before it and read just after: the warm-up
    superstep's launches and the captured chunk's); the second captures
    nothing and its host reads are counted; the rate is over the median of
    three more calls; with ``profile``, one more call is profiled (its
    kernels' device time, the card's busy share, each kernel's executions).
    Returns the rows and the launch counts summed over the first calls."""
    import numpy as np
    import torch

    from repro_torch.core import routing
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.kernels.pulse_commit import ops as commit_ops

    stats, rows = routing.CACHE_STATS, []
    launches = dict(pulse_chase=0, pulse_commit=0)
    B = ref.ptr.shape[0]
    for schedule, fabric in combos:
        kw = dict(run, schedule=schedule, fabric=fabric)
        tag = f"[{name}] {schedule}/{fabric}"
        t_run = time.perf_counter()
        traces, capture_s = stats.traces, stats.capture_s
        chase_ops.pulse_chase.launches = commit_ops.pulse_commit.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = engine_for()
        res = eng.execute(it, p0, s0, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first = dict(pulse_chase=chase_ops.pulse_chase.launches,
                     pulse_commit=commit_ops.pulse_commit.launches)
        captures, capture_s = stats.traces - traces, stats.capture_s - capture_s
        if captures != 1:
            raise AssertionError(f"{tag}: {captures} captures in the first call")
        if not any(first.values()):
            raise AssertionError(f"{tag}: the first call launched no kernel")
        for k, v in first.items():
            launches[k] += v
        st, rst = res.stats, ref.stats
        if (st.schedule, st.fabric, st.fused) != (schedule, fabric, True):
            raise AssertionError(f"{tag}: the stats say {st.schedule}/{st.fabric}/{st.fused}")
        for f in ("ptr", "scratch", "status", "iters"):
            if not torch.equal(getattr(res, f), getattr(ref, f)):
                raise AssertionError(f"{tag}: {f} differs from the dispatched run")
        for f in ("supersteps", "local_only_steps", "total_wire_words", "commits", "epochs"):
            if getattr(st, f) != getattr(rst, f):
                raise AssertionError(f"{tag}: {f} {getattr(st, f)} != {getattr(rst, f)}")
        if not np.array_equal(st.crossings, rst.crossings):
            raise AssertionError(f"{tag}: the crossings differ from the dispatched run")
        if ref_arena is not None and not (torch.equal(eng.arena.data, ref_arena.data)
                                          and torch.equal(eng.arena.heap, ref_arena.heap)):
            raise AssertionError(f"{tag}: the committed arena differs from the dispatched run's")
        # a second call: no capture, and the host's reads counted
        traces, reads = stats.traces, stats.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = engine_for().execute(it, p0, s0, **kw)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        reads = stats.host_reads - reads
        if stats.traces != traces:
            raise AssertionError(f"{tag}: the second call captured again")
        if not torch.equal(again.scratch, res.scratch) or reads != -(-st.supersteps // routing.CHUNK):
            raise AssertionError(f"{tag}: the second call differs ({reads} chunk reads)")
        calls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine_for().execute(it, p0, s0, **kw)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        med = float(np.median(calls))
        t0 = time.perf_counter()
        prof = (call_breakdown(lambda: engine_for().execute(it, p0, s0, **kw), warm=False)
                if profile else None)
        profile_s = time.perf_counter() - t0
        row = dict(schedule=schedule, fabric=fabric, ops=B, per_s=B / med, execute_s=calls,
                   first_call_s=first_s, second_call_s=second_s, capture_s=capture_s,
                   captures_first_call=captures, captures_second_call=0,
                   chunk=routing.CHUNK, chunk_reads=reads, first_call_launches=first,
                   supersteps=st.supersteps, local_only_steps=st.local_only_steps,
                   wire_words=st.total_wire_words, ring_hops=st.ring_hops,
                   kernel_share_of_call=prof and prof["device_ms"] / (med * 1e3),
                   profiled_call=prof and dict(
                       wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                       device_busy=prof["device_busy"], top_kernels=prof["top_kernels"],
                       kernel_calls=prof["kernel_calls"]),
                   equals_dispatched=True, profile_s=profile_s,
                   seconds=time.perf_counter() - t_run)
        rows.append(row)
        profiled = ("no profiled call" if prof is None else
                    f"a profiled call {prof['wall_ms']:.2f} ms wall, kernels "
                    f"{prof['device_ms']:.3f} ms (busy {100 * prof['device_busy']:.1f}% of the "
                    f"profiled call, {100 * row['kernel_share_of_call']:.1f}% of the median "
                    f"call)")
        log(f"{tag}: {B / med:.4g} a second (median of {[round(x, 4) for x in calls]} s; first "
            f"call {first_s:.3f} s with the capture {capture_s:.3f} s, second {second_s:.4f} s); "
            f"{st.supersteps} supersteps ({st.local_only_steps} local-only), {reads} chunk reads "
            f"of {routing.CHUNK} supersteps; captures 1 then 0; first call's launches {first}; "
            f"{profiled}; == the dispatched run; this run {row['seconds']:.1f} s, the profiled "
            f"call's trace {profile_s:.1f} s of it")
    return rows, launches


def phase_routing(rng):
    """Phase 11: PulseEngine.execute on an EmulatedMesh of the paper's four
    memory nodes, on the card (one pulse_chase launch per superstep) and on
    a CPU copy, held against each other, against the sequential executor
    and against the structures' oracles."""
    import numpy as np
    import torch

    from repro_torch.core import commit, routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.core.iterator import STATUS_DONE, STATUS_FAULT
    from repro_torch.kernels.pulse_chase import ops

    t_phase = time.perf_counter()
    P, batches = routing_batches(rng)
    rows, launches_total, seq_by_arena = [], 0, {}
    for b in batches:
        name, it, run = b["name"], b["it"], b["run"]
        fields = [t.numpy() for t in (b["arena"].data, b["arena"].bounds, b["arena"].perms,
                                      b["arena"].heap)]
        card = arena_from_numpy(*fields, device="cuda")
        p0, s0 = b["p0"].cuda(), b["s0"].cuda()
        eng = PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda"))
        # the main path, with the launch count read around it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.pulse_chase.launches = 0
        t0 = time.perf_counter()
        res = eng.execute(it, p0, s0, **run)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = ops.pulse_chase.launches
        peak = torch.cuda.max_memory_allocated() / 2**20
        st = res.stats
        launches_total += launches
        if launches != st.supersteps:
            raise AssertionError(f"{name}: {launches} pulse_chase launches in "
                                 f"{st.supersteps} supersteps")
        B = res.ptr.shape[0]
        for f in ("ptr", "scratch", "status", "iters"):
            t = getattr(res, f)
            if not (t.is_cuda and t.dtype == torch.int32 and t.shape[0] == B):
                raise AssertionError(f"{name}: bad {f} {t.dtype} {tuple(t.shape)}")

        # the first 1/ROUTE_CPU_CUT of the queries on the card and on a CPU
        # copy (the plain chase, step_batch per shard)
        n_cut = B // ROUTE_CPU_CUT
        res_cut = eng.execute(it, p0[:n_cut], s0[:n_cut], **run)
        cpu = arena_from_numpy(*fields, device="cpu")
        t0 = time.perf_counter()
        res_cpu = PulseEngine(cpu, mesh=routing.EmulatedMesh(P, "cpu")).execute(
            it, b["p0"][:n_cut], b["s0"][:n_cut], **run)
        cpu_s = time.perf_counter() - t0
        for f in ("ptr", "scratch", "status", "iters"):
            if not torch.equal(getattr(res_cut, f).cpu(), getattr(res_cpu, f)):
                raise AssertionError(f"{name}: card and CPU copy differ on {f}")
        diff = _stats_diff(res_cut.stats, res_cpu.stats)
        if diff:
            raise AssertionError(f"{name}: RoutingStats of card and CPU copy differ on {diff}")

        # the sequential executor on the card: equal but for the schedule
        seq_note = None
        if not run.get("return_to_cpu"):
            srec, sst = commit.sequential_commit_execute(
                it, card, p0, s0, max_iters=run["max_iters"], k_local=run["k_local"],
                compact=run["compact"])
            diff = _stats_diff(st, sst)
            if diff != ["schedule"]:
                raise AssertionError(f"{name}: against the sequential executor the stats "
                                     f"differ on {diff}")
            for f, col in (("ptr", routing.F_PTR), ("status", routing.F_STATUS),
                           ("iters", routing.F_ITERS)):
                if not np.array_equal(getattr(res, f).cpu().numpy(), srec[:, col]):
                    raise AssertionError(f"{name}: {f} differs from the sequential executor")
            if not np.array_equal(res.scratch.cpu().numpy(), srec[:, routing.F_SCRATCH:]):
                raise AssertionError(f"{name}: scratch differs from the sequential executor")
            seq_by_arena[id(b["arena"])] = res
            seq_note = "equal but for schedule"
        else:  # the ablation changes where records go, never their results
            other = seq_by_arena[id(b["arena"])]
            for f in ("ptr", "scratch", "status", "iters"):
                if not torch.equal(getattr(res, f), getattr(other, f)):
                    raise AssertionError(f"{name}: results differ from the compacted run")
            seq_note = "results equal to the compacted run; crossings differ"

        # the structure's oracle on 1,024 sampled queries
        sample = np.sort(np.random.default_rng(1).choice(B, 1024, replace=False))
        want = b["want"](b["q"][sample])
        scr = res.scratch.cpu().numpy()[sample]
        got = [(int(x[1]), int(x[2])) for x in scr]
        if got != [(int(w[0]), int(w[1])) for w in want]:
            raise AssertionError(f"{name}: results disagree with ref_find")
        status = res.status.cpu().numpy()
        if not np.all((status == STATUS_DONE) | (status == STATUS_FAULT)):
            raise AssertionError(f"{name}: records left unfinished")

        # end-to-end rate over the median call; the chase kernel's device
        # time in a call (the profiler's timestamps) over its wall time
        secs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute(it, p0, s0, **run)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = float(np.median(secs))
        k_call = profiled_ms([lambda: eng.execute(it, p0, s0, **run)], 1, "chase_kernel")
        if k_call is None:
            raise AssertionError(f"{name}: the profiler saw no pulse_chase kernel")
        breakdown = call_breakdown(lambda: eng.execute(it, p0, s0, **run))

        # the bound of a superstep's chase: each distinct row the call reads
        # once, and the records active at a superstep's start read and
        # written once, over the HBM rate, shared out over the supersteps
        logic = ops.iterator_logic(it)
        depth = int(res.iters.max().item())
        rows_seen = visited_rows(card, logic, p0, s0.reshape(B, -1).contiguous(), depth)
        R = routing.record_width(it.scratch_words)
        starts = [B] + st.active_per_step[:-1]
        nbytes = rows_seen * card.node_words * 4 + sum(starts) * R * 4 * 2
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3 / st.supersteps
        one = superstep_vs_plain(card, it, p0, s0, P)
        if not one["bit_equal"]:
            raise AssertionError(f"{name}: the superstep kernel disagrees with its plain version")
        row = dict(
            batch=name, structure=b["structure"], keys=b["keys"], policy=b["policy"],
            memory_nodes=P, lanes=B, execute_args=run, arena_mb=card.capacity * card.node_words
            * 4 / 1e6, launches=launches, supersteps=st.supersteps,
            local_only_steps=st.local_only_steps, routed_records=int(sum(st.routed_per_step)),
            wire_words=st.total_wire_words, mean_crossings=float(st.crossings.mean()),
            execute_s=secs, first_execute_s=first_s, cpu_copy_s=cpu_s,
            lookups_per_s=B / med, kernel_ms_per_call=k_call,
            kernel_ms_per_superstep=k_call / st.supersteps, bound_ms_per_superstep=bound_ms,
            bound_by="bytes", distinct_rows=rows_seen, kernel_share_of_call=k_call / (med * 1e3),
            peak_mib=peak, iters_max=depth, card_equals_cpu=True, sequential=seq_note,
            superstep_check=one, profiled_call=breakdown)
        rows.append(row)
        log(f"[{name}] P={P} ({b['policy']}): {B / med:.4g} lookups/s (median of "
            f"{[round(x, 4) for x in secs]} s; first call {first_s:.3f} s, CPU copy of the first "
            f"1/{ROUTE_CPU_CUT} {cpu_s:.2f} s); "
            f"supersteps {st.supersteps} ({st.local_only_steps} local-only), {launches} launches; "
            f"routed {row['routed_records']} records, {st.total_wire_words} wire words, mean "
            f"crossings {row['mean_crossings']:.3f}; chase kernel {row['kernel_ms_per_superstep']:.5f} "
            f"ms a superstep (profiler; bound {bound_ms:.5f}), {100 * row['kernel_share_of_call']:.1f}% "
            f"of the call; peak {peak:.1f} MiB; card == CPU copy (the first 1/{ROUTE_CPU_CUT}); "
            f"sequential executor: {seq_note}")
        log(f"[{name}] one superstep ({one['active_records']} active of {one['pool_records']} "
            f"records): kernel {one['ms']:.5f} ms ({one['ms_source']}), plain {one['plain_ms']:.3f} "
            f"ms, bit_equal={one['bit_equal']}")
        log(f"[{name}] a profiled call: {breakdown['wall_ms']:.2f} ms wall, kernels "
            f"{breakdown['device_ms']:.3f} ms (device busy {100 * breakdown['device_busy']:.1f}%), "
            f"host operators {breakdown['host_op_ms']:.2f} ms; the most self time: " + ", ".join(
                f"{o['op']} {o['self_cpu_ms']:.2f} ms/{o['calls']}" for o in breakdown["host_ops"]))
        log_spans(name, breakdown["spans"], breakdown["wall_ms"], st.supersteps)

        # the device-resident schedules, each against this dispatched run
        combos = ROUTE_SCHEDULES + (ROUTE_RING if name == "webservice" else [])
        dr_rows, dr_launches = device_resident_runs(
            name, lambda c=card: PulseEngine(c, mesh=routing.EmulatedMesh(P, "cuda")), it, p0,
            s0, run, res, combos)
        row.update(dispatched_lookups_per_s=row["lookups_per_s"], device_resident=dr_rows)
        launches_total += dr_launches["pulse_chase"]
        routing.reset_executable_caches()
        del card, cpu, eng, res, res_cpu, res_cut
        torch.cuda.empty_cache()
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s (CPU copies included)")
    log(json.dumps({"phase": "routing", "batches": rows}))
    return rows, launches_total


# ------------------------- the write path on the mesh -------------------------

WRITE_MESH_RUN = dict(max_iters=4096, k_local=4, compact=True,
                      schedule="dispatched")  # phase 12's execute arguments
# phase 12 holds the card against a CPU copy and the sequential commit on
# each step's first 1/WRITE_MESH_CUT ops (the checks' depth; the card's own
# runs, rates and commit phases take every op)
WRITE_MESH_CUT = 8
# the timed calls a step's rate takes the median of; the skip list's
# ~270-superstep calls take ~5 s each, so one (the time's cut)
WRITE_MESH_TIMED = dict(skiplist_rw=1)
# the batches held against no CPU copy and no sequential commit (the time's
# cut for phase 23 (j)): the skip list's ~270 supersteps cost the same at
# any WRITE_MESH_CUT (its sequential commit alone ~35 s on a slow host)
WRITE_MESH_UNCHECKED = ("skiplist_rw",)
COMMIT_SOURCE = "src/repro_torch/csrc/pulse_commit.cu"
COMMIT_REPLACES = "src/repro/core/routing.py:407 (_commit_phase: XLA, no Pallas kernel)"


def commit_work(pools, data, heap, bounds, perms, out_pools, out_heap, scratch_words: int):
    """What one commit phase must move, counted from its inputs (``pools``,
    ``data``, ``heap`` before the phase) and its result (``out_pools``,
    ``out_heap``): ``(bytes, eligible records, the longest shard's
    eligible count, the longest same-slot run of applied STOREs and CASes,
    the most ALLOCs a shard popped from its free list)``.  The last two are
    the kernels' serial residue: a run is applied in order by one group of
    lanes, and the pops are walked one after another.

    Per eligible record on a writable shard: its 8-byte order index, its
    m_op, m_tgt and m_mask read, a CAS's expected word, the staged words
    its mask selects (a STORE, CAS or ALLOC); its m_op written, and an
    ALLOC's scratch word (the slot) or status (out of rows).  Per row: the
    words the phase writes (the union of the masks of the stores and the
    CAS hits on it, a FREE's whole row, each claimed ALLOC row whole), the
    guard word each CAS reads, and the link of each slot popped from the
    free list.  On a shard without PERM_WRITE: each eligible record's order
    index read, its status and m_op written.  Per shard: its eligible
    count, bounds and perms read, and the four heap registers read and
    written where it commits.  A CAS hit is
    judged on the arena before the phase: exact unless an earlier commit
    of the same phase wrote its guard word."""
    import torch

    from repro_torch.core import routing
    from repro_torch.core.arena import (H_BUMP, M_ALLOC, M_CAS, M_FREE, M_NONE, M_STORE,
                                        PERM_WRITE)
    from repro_torch.core.iterator import STATUS_EMPTY, STATUS_FAULT

    P, L, R = pools.shape
    cap, W = data.shape
    MB = routing.F_SCRATCH + scratch_words
    op, tgt, mask = pools[..., MB], pools[..., MB + 1], pools[..., MB + 2]
    me = torch.arange(P, dtype=torch.int32, device=pools.device)[:, None]
    alloc = op == M_ALLOC
    local = (tgt >= bounds[:-1, None]) & (tgt < bounds[1:, None])
    elig = ((op != M_NONE) & (pools[..., routing.F_STATUS] != STATUS_EMPTY)
            & torch.where(alloc, pools[..., routing.F_HOME] == me, local))
    writable = ((perms & PERM_WRITE) == PERM_WRITE)[:, None]
    applied, denied = elig & writable, elig & ~writable
    # the mask's words, widened by sign past bit 31 as the commit does
    bits = ((mask[..., None] >> torch.arange(W, device=pools.device).clamp(max=31)) & 1) == 1
    store, cas = applied & (op == M_STORE), applied & (op == M_CAS)
    free, alloc = applied & (op == M_FREE), applied & alloc
    row = tgt.clamp(0, cap - 1).long()
    first = bits.int().argmax(-1)  # the lowest masked word, 0 when none is
    hit = cas & (data[row, first] == pools[..., MB + 3])
    written = torch.zeros(cap, W, dtype=torch.int32, device=pools.device)
    sel = store | hit
    written.index_add_(0, row[sel], bits[sel].int())
    written.index_add_(0, row[free], torch.ones(int(free.sum()), W, dtype=torch.int32,
                                                device=pools.device))
    claimed = alloc & (out_pools[..., routing.F_STATUS] != STATUS_FAULT)
    n_claimed = int(claimed.sum())
    pops_per_shard = claimed.sum(1) - (out_heap[:, H_BUMP] - heap[:, H_BUMP])
    pops = int(pops_per_shard.sum())
    run_slot = (me.long() * cap + row)[store | cas]
    longest_run = (int(torch.unique(run_slot, return_counts=True)[1].max())
                   if run_slot.numel() else 0)
    staged_words = int((bits & (store | cas | alloc)[..., None]).sum())
    words = (int(applied.sum()) * 4  # m_op, m_tgt, m_mask read; m_op written
             + int(cas.sum()) * 2 + staged_words + int(alloc.sum())  # expect, staged, slot
             + int((written > 0).sum()) + n_claimed * W + pops  # the rows
             + int(denied.sum()) * 2  # status and m_op
             + 4 * P + 8 * int((applied.any(1)).sum()))  # count, bounds, perms; heap
    per_shard = elig.sum(1)
    n = int(per_shard.sum())
    return (words * 4 + n * 8, n, int(per_shard.max()), longest_run,
            int(pops_per_shard.max()))


def _capture_commits(fn):
    """Run ``fn`` (a run over an emulated mesh) with the superstep's commit
    (``routing._commit``, around ``pulse_commit``) wrapped: returns fn's
    result, clones of the inputs of the commit phase that found the most
    staged records (with its work), and the work (``commit_work``) of
    every commit phase in call order."""
    from repro_torch.core import routing

    orig, best, works = routing._commit, dict(staged=-1), []

    def spy(pools, data, heap, bounds, perms, *, scratch_words, **kw):
        before = [t.clone() for t in (pools, data, heap, bounds, perms)]
        out = orig(pools, data, heap, bounds, perms, scratch_words=scratch_words, **kw)
        work = commit_work(*before, pools, heap, scratch_words)
        works.append(work)
        staged = int((before[0][..., routing.F_SCRATCH + scratch_words] != 0).sum())
        if staged > best["staged"]:
            best.update(staged=staged, scratch_words=scratch_words, args=before, work=work)
        return out

    routing._commit = spy
    try:
        return fn(), best, works
    finally:
        routing._commit = orig


COMMIT_KERNELS = ("commit_key", "commit_apply", "commit_tail")  # csrc/pulse_commit.cu


def commit_vs_plain(best):
    """The kernels and the plain versions on one captured commit phase: the
    card's commit against the serial plain version and the CPU model of
    the kernels' stages (each on CPU copies), all timed; returns a dict.
    The kernels' device time is the sum of every kernel of the phase, the
    sort's included, from the profiler (``stages_ms`` by stage)."""
    import torch

    from repro_torch.kernels.pulse_commit import ops as commit_ops
    from repro_torch.kernels.pulse_commit import ref as commit_ref

    S = best["scratch_words"]
    host = [t.cpu() for t in best["args"]]
    card = [t.cuda() for t in host]

    def kern():
        return commit_ops.pulse_commit(*[t.clone() for t in card], scratch_words=S)

    def plain():
        return commit_ref.pulse_commit_reference(*[t.clone() for t in host], scratch_words=S)

    def staged():
        return commit_ref.pulse_commit_staged(*[t.clone() for t in host], scratch_words=S)

    got, want, model = kern(), plain(), staged()
    torch.cuda.synchronize()
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    model_same = all(torch.equal(a, b) for a, b in zip(model, want))
    err = max(max_abs_err(a.cpu(), b) for a, b in zip(got, want))
    nbytes, n, chain, run, pops = best["work"]
    by_name = kernel_breakdown_ms([kern], 5)
    stages = None
    if by_name is not None:
        stages = {k: sum(v for name, v in by_name.items() if k in name) for k in COMMIT_KERNELS}
        stages["sort"] = sum(v for name, v in by_name.items()
                             if not any(k in name for k in COMMIT_KERNELS))
    wrapper_ms = time_cuda(kern, 5)
    t0 = time.perf_counter()
    plain()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    staged()
    staged_ms = (time.perf_counter() - t0) * 1e3
    return dict(bit_equal=same, staged_model_bit_equal=model_same, max_abs_err=err,
                staged=best["staged"], eligible=n, longest_chain=chain, longest_run=run,
                pops=pops, ms=wrapper_ms if stages is None else sum(stages.values()),
                ms_source="events, the whole wrapper" if stages is None else
                "profiler, every kernel of the phase summed",
                stages_ms=stages, kernels_ms=by_name, wrapper_ms_events=wrapper_ms,
                plain_ms=plain_ms, staged_model_ms=staged_ms, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                pool_records=int(host[0].shape[0] * host[0].shape[1]))


def timed_split(fn):
    """One unprofiled call of ``fn`` (a mutating execute on the card) with
    CUDA events recorded on the stream at the edges of each superstep's
    pieces: the chase (from the superstep's start to the commit's), the
    commit (from its ``commit_key`` launch to the end of its
    ``commit_tail`` launch: the three kernels and the sort between them),
    each kernel alone (events around its C launch call) and the switch.
    The stream reaches an event once it has run all that was enqueued
    before it, so a piece's time is the stream's time from its start to
    its end: the device's work and the gaps where it waited for the host
    to enqueue more (for a kernel alone, the few microseconds of one
    launch call).  Returns the call's wall ms (host clock, ending in a
    synchronise), each piece's ms summed over the supersteps, and the
    superstep count."""
    import types

    import torch

    from repro_torch.core import routing
    from repro_torch.kernels.pulse_commit import kernel as commit_kernel

    stages = ("key", "apply", "tail")
    marks = {k: [] for k in ("chase", "switch", "switched", *stages,
                             *(f"{x}_done" for x in stages))}

    def mark(key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[key].append(e)

    def around(obj, attr, start, end=None):
        orig = getattr(obj, attr)

        def wrapped(*a, **kw):
            mark(start)
            out = orig(*a, **kw)
            if end is not None:
                mark(end)
            return out
        return obj, attr, orig, wrapped

    # the built library, seen by ``kernel.launch`` through a stand-in whose
    # launch calls are bracketed by events
    lib = commit_kernel._library()
    timed_lib = types.SimpleNamespace(
        pulse_commit_error_string=lib.pulse_commit_error_string,
        **{f"pulse_commit_{x}_launch": around(lib, f"pulse_commit_{x}_launch", x,
                                              f"{x}_done")[3] for x in stages})
    patches = [around(routing, "_local_superstep_mut", "chase"),
               (commit_kernel, "_library", commit_kernel._library, lambda: timed_lib),
               around(routing, "_switch", "switch", "switched")]
    for obj, attr, _, wrapped in patches:
        setattr(obj, attr, wrapped)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, orig, _ in patches:
            setattr(obj, attr, orig)
    n = len(marks["chase"])
    if any(len(v) != n for v in marks.values()):
        raise AssertionError(f"timed_split: uneven marks {({k: len(v) for k, v in marks.items()})}")

    def total(a, b):
        return sum(x.elapsed_time(y) for x, y in zip(marks[a], marks[b]))

    pieces = {f"{x}_ms": total(x, f"{x}_done") for x in stages}
    return dict(wall_ms=wall_ms, supersteps=n, chase_ms=total("chase", "key"),
                commit_ms=total("key", "tail_done"), sort_ms=total("key_done", "apply"),
                kernel_ms=sum(pieces.values()), switch_ms=total("switch", "switched"),
                **pieces)


def phase_write_mesh(rng):
    """Phase 12: the write path over the paper's four memory nodes on the
    card (each superstep's commit phase one ``pulse_commit`` launch), held
    against each batch's own checks; on each step's first 1/WRITE_MESH_CUT
    ops, the card against a CPU copy and against the sequential commit;
    then read back over the mesh on ``pulse_chase``."""
    import numpy as np
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core import commit, routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.kernels.pulse_commit import ops as commit_ops

    t_phase = time.perf_counter()
    P = pulse_paper.MEM_NODES
    run = WRITE_MESH_RUN
    rows, commit_launches, readback_launches = [], 0, 0
    for wb in write_batches(rng, P):
        name = wb["name"]
        t_batch = time.perf_counter()
        card = arena_from_numpy(*wb["fields"], device="cuda")
        digest = _digest(card)
        eng = PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda"))
        main = []  # per step: (arena before, result, seconds, peak MiB, launches)

        def main_steps(eng=eng, wb=wb, name=name):
            # the commit phase with the most staged records is captured for
            # the kernel-vs-plain check, and every phase's work counted
            for sname, it, p0, s0 in wb["steps"]:
                before = eng.arena
                p0c, s0c = p0.cuda(), s0.cuda()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                chase_ops.pulse_chase.launches = 0
                commit_ops.pulse_commit.launches = 0
                t0 = time.perf_counter()
                res = eng.execute(it, p0c, s0c, **run)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = commit_ops.pulse_commit.launches
                chases = chase_ops.pulse_chase.launches
                peak = torch.cuda.max_memory_allocated() / 2**20
                if launches != res.stats.supersteps:
                    raise AssertionError(f"{name}/{sname}: {launches} pulse_commit launches in "
                                         f"{res.stats.supersteps} supersteps")
                if chases != 0:
                    raise AssertionError(f"{name}/{sname}: the write path launched the "
                                         f"read-only pulse_chase {chases} times")
                main.append((before, res, secs, peak, launches, p0c, s0c))

        _, best, works = _capture_commits(main_steps)
        commit_launches += sum(m[4] for m in main)
        final = eng.arena
        if _digest(card) != digest:
            raise AssertionError(f"{name}: the input arena changed")
        if not (final.data.is_cuda and final.heap.is_cuda):
            raise AssertionError(f"{name}: the committed arena left the card")

        cpu_s = seq_s = None
        if name in WRITE_MESH_UNCHECKED:
            log(f"[{name}] cut for time: no CPU copy and no sequential commit of its first "
                f"1/{WRITE_MESH_CUT} (~270 supersteps at any cut); its own checks, the commit "
                f"kernel against its plain version and the read-back stay")
        else:
            # each step's first 1/WRITE_MESH_CUT ops, on the card, on a CPU copy
            # and through the sequential commit on the card: records, stats and
            # the final arena equal (the sequential commit's stats but schedule)
            cut = [(sname, it, p0[:p0.shape[0] // WRITE_MESH_CUT],
                    s0[:p0.shape[0] // WRITE_MESH_CUT]) for sname, it, p0, s0 in wb["steps"]]
            cut_eng = PulseEngine(arena_from_numpy(*wb["fields"], device="cuda"),
                                  mesh=routing.EmulatedMesh(P, "cuda"))
            cut_card = [cut_eng.execute(it, p0.cuda(), s0.cuda(), **run) for _, it, p0, s0 in cut]
            cpu_eng = PulseEngine(arena_from_numpy(*wb["fields"], device="cpu"),
                                  mesh=routing.EmulatedMesh(P, "cpu"))
            t0 = time.perf_counter()
            host = [cpu_eng.execute(it, p0, s0, **run) for _, it, p0, s0 in cut]
            cpu_s = time.perf_counter() - t0
            for (sname, *_), g, c in zip(cut, cut_card, host):
                for f in ("ptr", "scratch", "status", "iters"):
                    if not (getattr(g, f).is_cuda and torch.equal(getattr(g, f).cpu(),
                                                                  getattr(c, f))):
                        raise AssertionError(f"{name}/{sname}: card and CPU copy differ on {f}")
                diff = _stats_diff(g.stats, c.stats)
                if diff:
                    raise AssertionError(f"{name}/{sname}: RoutingStats of card and CPU copy "
                                         f"differ on {diff}")
            if not (torch.equal(cut_eng.arena.data.cpu(), cpu_eng.arena.data)
                    and torch.equal(cut_eng.arena.heap.cpu(), cpu_eng.arena.heap)):
                raise AssertionError(f"{name}: the card's and the CPU copy's final arenas differ")

            t0 = time.perf_counter()
            seq_arena = arena_from_numpy(*wb["fields"], device="cuda")
            for (sname, it, p0, s0), g in zip(cut, cut_card):
                srec, sst, seq_arena = commit.sequential_commit_execute(
                    it, seq_arena, p0.cuda(), s0.cuda(), max_iters=run["max_iters"],
                    k_local=run["k_local"], compact=run["compact"])
                diff = _stats_diff(g.stats, sst)
                if diff != ["schedule"]:
                    raise AssertionError(f"{name}/{sname}: against the sequential commit the "
                                         f"stats differ on {diff}")
                S = it.scratch_words
                for f, cols in (("ptr", routing.F_PTR), ("status", routing.F_STATUS),
                                ("iters", routing.F_ITERS),
                                ("scratch", slice(routing.F_SCRATCH, routing.F_SCRATCH + S))):
                    if not np.array_equal(getattr(g, f).cpu().numpy(), srec[:, cols]):
                        raise AssertionError(f"{name}/{sname}: {f} differs from the sequential "
                                             f"commit")
            if not (torch.equal(seq_arena.data, cut_eng.arena.data)
                    and torch.equal(seq_arena.heap, cut_eng.arena.heap)):
                raise AssertionError(f"{name}: the sequential commit's final arena differs")
            del seq_arena, cut_eng, cut_card
            seq_s = time.perf_counter() - t0

        steps = []
        for (sname, it, *_), check, (before, g, secs, peak, launches, p0c, s0c) in zip(
                wb["steps"], wb["check"], main):
            bad, extra = check(g.status.cpu().numpy(), g.scratch.cpu().numpy())
            if bad:
                raise AssertionError(f"{name}/{sname}: {'; '.join(bad)}")
            # the rate over the median of three calls from the same arena (one
            # for the skip list, WRITE_MESH_TIMED)
            calls = []
            for _ in range(WRITE_MESH_TIMED.get(name, 3)):
                e = PulseEngine(before, mesh=routing.EmulatedMesh(P, "cuda"))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.execute(it, p0c, s0c, **run)
                torch.cuda.synchronize()
                calls.append(time.perf_counter() - t0)
            med = float(np.median(calls))

            # one more call, its supersteps split by CUDA events on the stream
            split = timed_split(lambda b=before, i=it, p=p0c, q=s0c: PulseEngine(
                b, mesh=routing.EmulatedMesh(P, "cuda")).execute(i, p, q, **run))
            st = g.stats
            if split["supersteps"] != st.supersteps:
                raise AssertionError(f"{name}/{sname}: the timed call ran {split['supersteps']} "
                                     f"supersteps, the main path {st.supersteps}")
            # this step's commit phases, from the main run of it
            mine, done = works[:st.supersteps], works[st.supersteps:]
            works[:] = done
            B = g.ptr.shape[0]
            row = dict(
                step=sname, ops=B, execute_s=calls, first_execute_s=secs, ops_per_s=B / med,
                cpu_copy_s=cpu_s, sequential_s=seq_s, supersteps=st.supersteps,
                local_only_steps=st.local_only_steps,
                commits=st.commits, epochs=st.epochs, routed_records=int(sum(st.routed_per_step)),
                wire_words=st.total_wire_words, mean_crossings=float(st.crossings.mean()),
                commit_launches=launches, commit_ms_per_call=split["kernel_ms"],
                commit_ms_per_superstep=split["kernel_ms"] / st.supersteps,
                commit_stream_ms_per_superstep=split["commit_ms"] / st.supersteps,
                sort_ms_per_superstep=split["sort_ms"] / st.supersteps,
                commit_bytes_per_call=sum(w[0] for w in mine),
                commit_bound_ms_per_superstep=sum(w[0] for w in mine) / HBM_BYTES_PER_S * 1e3
                / st.supersteps,
                longest_chain_max=max(w[2] for w in mine),
                longest_chain_mean=sum(w[2] for w in mine) / st.supersteps,
                longest_run_max=max(w[3] for w in mine), pops_max=max(w[4] for w in mine),
                peak_mib=peak, timed_call=split, iters_max=int(g.iters.max().item()),
                **extra)
            steps.append(row)
            log(f"[{name}] {sname} over P={P}: {B / med:.4g} ops/s (median of "
                f"{[round(x, 4) for x in calls]} s; first call, its commit phases captured, "
                f"{secs:.3f} s"
                + (f"; for the batch's first 1/{WRITE_MESH_CUT} CPU copy {cpu_s:.2f} s, card "
                   f"and sequential commit {seq_s:.2f} s" if cpu_s is not None else "")
                + f"); supersteps {st.supersteps} "
                f"({st.local_only_steps} local-only) = pulse_commit launches, 0 pulse_chase; "
                f"commits {st.commits}, epochs {st.epochs}; routed {row['routed_records']} "
                f"records, {st.total_wire_words} wire words, mean crossings "
                f"{row['mean_crossings']:.3f}; pulse_commit "
                f"{row['commit_stream_ms_per_superstep']:.5f} ms a superstep on the stream, its "
                f"three kernels {row['commit_ms_per_superstep']:.5f} (CUDA events; bytes bound "
                f"{row['commit_bound_ms_per_superstep']:.6f}; the old walk's chain, the longest "
                f"shard's eligible count, {row['longest_chain_mean']:.1f} a superstep, at most "
                f"{row['longest_chain_max']}; the serial residue: the longest "
                f"same-slot run {row['longest_run_max']}, free-list pops {row['pops_max']}); "
                f"peak {peak:.1f} MiB"
                + (f"; on the first 1/{WRITE_MESH_CUT} of its ops card == CPU copy == "
                   f"sequential commit (but schedule)" if cpu_s is not None else ""))
            rest = split["wall_ms"] - split["chase_ms"] - split["commit_ms"] - split["switch_ms"]
            log(f"[{name}] {sname}: a timed call {split['wall_ms']:.2f} ms wall; on the stream "
                f"the chase {split['chase_ms']:.3f} ms, the commit {split['commit_ms']:.3f} ms "
                f"(commit_key {split['key_ms']:.3f}, the sort {split['sort_ms']:.3f}, "
                f"commit_apply {split['apply_ms']:.3f}, commit_tail {split['tail_ms']:.3f}), "
                f"the switch {split['switch_ms']:.3f} ms, the rest (placement, counter reads, "
                f"decode) {rest:.3f} ms")
        if works:
            raise AssertionError(f"{name}: {len(works)} commit phases of the main run left over")

        # the device-resident schedules, each step against its dispatched run
        t_dr = time.perf_counter()
        for (sname, it, *_), (before, g, *_r, p0c, s0c), row in zip(wb["steps"], main, steps):
            combos = ROUTE_SCHEDULES + (WRITE_RING if name == "webservice_rw" else [])
            # only wiredtiger_update's few-superstep calls are profiled: the
            # trace of one of skiplist_rw's ~270-superstep calls took 33-64 s
            # to parse, and webservice_rw's ~120 supersteps of ~1,000
            # kernels most of the rest of ~95 s
            dr_rows, dr_launches = device_resident_runs(
                f"{name}/{sname}",
                lambda b=before: PulseEngine(b, mesh=routing.EmulatedMesh(P, "cuda")), it, p0c,
                s0c, run, g, combos, ref_arena=g.arena, profile=name == "wiredtiger_update")
            if dr_launches["pulse_chase"]:
                raise AssertionError(f"{name}/{sname}: a device-resident write run launched "
                                     f"pulse_chase")
            row.update(dispatched_ops_per_s=row["ops_per_s"], device_resident=dr_rows)
            commit_launches += dr_launches["pulse_commit"]
        routing.reset_executable_caches()
        log(f"[{name}] the device-resident runs took {time.perf_counter() - t_dr:.1f} s")

        # the kernel against its plain version on the captured commit phase
        one_commit = commit_vs_plain(best)
        if not one_commit["bit_equal"]:
            raise AssertionError(f"{name}: pulse_commit disagrees with its plain version")
        if not one_commit["staged_model_bit_equal"]:
            raise AssertionError(f"{name}: the CPU model of pulse_commit's stages disagrees "
                                 f"with the serial plain version")
        stages = one_commit["stages_ms"] or {}
        log(f"[{name}] one commit phase ({one_commit['eligible']} eligible of "
            f"{one_commit['staged']} staged records; the longest shard's count "
            f"{one_commit['longest_chain']}, the longest same-slot run "
            f"{one_commit['longest_run']}, free-list pops {one_commit['pops']}): kernels "
            f"{one_commit['ms']:.5f} ms "
            f"({one_commit['ms_source']}: "
            + ", ".join(f"{k} {v:.5f}" for k, v in stages.items())
            + f"; the wrapper with its clones {one_commit['wrapper_ms_events']:.4f} ms, CUDA "
            f"events), serial plain {one_commit['plain_ms']:.2f} ms, staged model "
            f"{one_commit['staged_model_ms']:.2f} ms (CPU), bytes bound "
            f"{one_commit['bound_ms']:.6f} ms; card == serial == staged model")

        # the committed arena read back over the mesh on pulse_chase
        fit, rp, rs, (want_found, want_val) = wb["readback"]
        reng = PulseEngine(final, mesh=routing.EmulatedMesh(P, "cuda"))
        chase_ops.pulse_chase.launches = 0
        res = reng.execute(fit, rp.cuda(), rs.cuda(), **ROUTE_RUN)
        torch.cuda.synchronize()
        launches = chase_ops.pulse_chase.launches
        if launches != res.stats.supersteps:
            raise AssertionError(f"{name}: the read-back launched {launches} pulse_chase "
                                 f"kernels in {res.stats.supersteps} supersteps")
        readback_launches += launches
        found = res.scratch[:, 2].cpu().numpy() == 1
        val = res.scratch[:, 1].cpu().numpy()
        if not (np.array_equal(found, want_found)
                and np.array_equal(val[want_found], want_val[want_found])):
            raise AssertionError(f"{name}: the read-back over the mesh disagrees with the "
                                 f"batch ({int((found != want_found).sum())} lanes found wrong)")
        log(f"[{name}] read-back of {rp.shape[0]} keys over the mesh: {launches} superstep "
            f"launches in {res.stats.supersteps} supersteps; inserted/updated found with "
            f"their values, deleted gone, untouched unchanged")
        rows.append(dict(batch=name, structure=wb["structure"], keys=wb["keys"],
                         traffic=wb["traffic"], placement=wb["placement"], execute_args=run,
                         steps=steps, commit_check=one_commit,
                         readback_supersteps=res.stats.supersteps,
                         readback_launches=launches, readback_lanes=int(rp.shape[0])))
        log(f"[{name}] placement {wb['placement']}; the batch took "
            f"{time.perf_counter() - t_batch:.1f} s")
        del card, eng, final, reng, res, main, best
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"  phase 12 took {secs:.1f} s (CPU copies and sequential commits included)")
    log(json.dumps({"phase": "write_mesh", "seconds": secs, "batches": rows}))
    return rows, commit_launches, readback_launches


# ---------------------- faults and replication on the mesh ---------------------

LOSS_PLAN = dict(drop_prob=0.4, drop_seed=7)  # tests/helpers/ft_checks.py:138
FAULTS_CPU_CUT = 8  # phase 13's CPU copies (and sequential executor) run the first eighth
# every (schedule, fabric) of tests/helpers/ft_checks.py:23-29
FT_SCHEDULES = [("dispatched", "dense"), ("fused", "dense"), ("fused", "ring"),
                ("pipelined", "dense"), ("pipelined", "ring")]
RECORDED_SUPERSTEP_MS = 0.030  # phase 11's webservice superstep in a call (PERF.md)


def replica_rows(plan, arena):
    """Holder ``r``'s rows hold ``primary_map[r]``'s, in the arena's layout,
    on the arena's device: R = 2 adds one copy of the arena."""
    import torch

    rows = torch.zeros_like(arena.data)
    b = arena.bounds.tolist()
    for holder, p in enumerate(plan.primary_map):
        if p >= 0:
            rows[b[holder]:b[holder + 1]] = arena.data[b[p]:b[p + 1]]
    return rows


def replica_window_vs_plain(arena, it, p0, s0, P, rep, *, advance: int = 2):
    """One superstep's local chase with the replica windows, after
    ``advance`` routed supersteps, on the kernel and on its plain version
    (the same CUDA tensors), both timed, beside the kernel without the
    windows on the same pools; the bound counts the records active at its
    start read and written once and each distinct row its steps read once
    (from the plain version run one step at a time)."""
    import torch

    from repro_torch.core import routing
    from repro_torch.kernels.pulse_chase import ops, ref

    pools, _ = routing.place_requests(p0, s0, P)
    step = routing.make_superstep(it, P, k_local=ROUTE_RUN["k_local"],
                                  max_iters=ROUTE_RUN["max_iters"], drain_done=True)
    for _ in range(advance):
        pools = step(pools, arena.data, arena.bounds, arena.perms)[0]
    logic = ops.iterator_logic(it)
    args = (arena.data, pools, arena.bounds, arena.perms)
    kw = dict(logic_fn=logic, k_local=ROUTE_RUN["k_local"], max_iters=ROUTE_RUN["max_iters"])

    def kern():
        return ops.pulse_chase_superstep(*args, rep=rep, **kw)

    def healthy():
        return ops.pulse_chase_superstep(*args, **kw)

    def plain(k=ROUTE_RUN["k_local"], pool=pools):
        return ref.chase_superstep_reference(arena.data, pool, arena.bounds, arena.perms, logic,
                                             k, scratch_words=it.scratch_words,
                                             max_iters=ROUTE_RUN["max_iters"], rep=rep)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    F_PTR, F_ITERS = routing.F_PTR, routing.F_ITERS
    cur, seen = pools, []
    for _ in range(ROUTE_RUN["k_local"]):
        nxt = plain(1, cur)
        moved = nxt[..., F_ITERS] > cur[..., F_ITERS]
        seen.append(cur[..., F_PTR][moved])
        cur = nxt
    rows_read = int(torch.unique(torch.cat(seen)).numel())
    active = int((pools[..., routing.F_STATUS] == 0).sum().item())
    R = pools.shape[2]
    bound = (active * R * 4 * 2 + rows_read * arena.node_words * 4) / HBM_BYTES_PER_S * 1e3
    k_ms = profiled_ms([kern], 10, "chase_kernel")
    h_ms = profiled_ms([healthy], 10, "chase_kernel")
    return dict(bit_equal=torch.equal(got, want), max_abs_err=max_abs_err(got, want),
                active_records=active, pool_records=int(pools.shape[0] * pools.shape[1]),
                rows_read=rows_read, ms=k_ms if k_ms is not None else time_cuda(kern, 10),
                ms_source="profiler" if k_ms is not None else "events",
                healthy_ms=h_ms, plain_ms=time_cuda(plain, 3), bound_ms=bound,
                bound_by="bytes")


def _timed(fn, n: int = 3):
    """(result of the first call, the median wall seconds of ``n`` calls)."""
    import numpy as np
    import torch

    out, secs = None, []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out = r if out is None else out
    return out, float(np.median(secs))


def phase_faults(rng, smi):
    """Phase 13: fault injection and replication on an EmulatedMesh of the
    paper's four memory nodes on the card, at phase 11's size: replicated
    reads on the dispatched schedule (one pulse_chase launch a superstep,
    the replica windows in the launch), fabric loss on every schedule and
    fabric, and a kill on each schedule."""
    import numpy as np
    import torch

    from repro_torch.core import commit, routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.core.faults import FaultInjector, FaultPlan, ShardFailure
    from repro_torch.core.isa import as_pulse_iterator
    from repro_torch.core.structures import isa_programs
    from repro_torch.kernels.pulse_chase import ops
    from repro_torch.kernels.pulse_commit import ops as commit_ops

    t_phase = time.perf_counter()
    P, batches = routing_batches(rng)
    batches = [b for b in batches if not b["run"].get("return_to_cpu")]
    run = dict(ROUTE_RUN)
    rows, launches_total, window_checks = [], 0, []
    payload = ("ptr", "scratch", "status", "iters")
    for b in batches:
        name, it = b["name"], b["it"]
        fields = [t.numpy() for t in (b["arena"].data, b["arena"].bounds, b["arena"].perms,
                                      b["arena"].heap)]
        card = arena_from_numpy(*fields, device="cuda")
        p0, s0 = b["p0"].cuda(), b["s0"].cuda()
        eng = PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda"))
        healthy, healthy_s = _timed(lambda: eng.execute(it, p0, s0, **run))
        arena_mb = card.capacity * card.node_words * 4 / 1e6
        row = dict(batch=name, memory_nodes=P, lanes=int(p0.shape[0]), arena_mb=arena_mb,
                   replica_mb=arena_mb, healthy_lookups_per_s=p0.shape[0] / healthy_s,
                   healthy_supersteps=healthy.stats.supersteps, replicated=[])
        log(f"[{name}] R = 2 keeps one more copy of the arena on the card: {arena_mb:.1f} MB "
            f"of replica rows beside the arena's {arena_mb:.1f} MB")

        # replicated reads: every dead primary under failover, spread and
        # primary healthy; each call one launch a superstep
        cases = [("failover", (d,)) for d in range(P)] + [("spread", ()), ("primary", ())]
        rows_by_policy = {}
        for policy, dead in cases:
            plan = routing.make_replica_plan(P, policy=policy)
            if policy not in rows_by_policy:
                rows_by_policy[policy] = replica_rows(plan, card)
            mask = torch.zeros(P, dtype=torch.bool, device="cuda")
            mask[list(dead)] = True
            ctx = routing.ReplicaContext(plan, rows_by_policy[policy], mask)
            # timed as the healthy run is: the median of three calls
            ops.pulse_chase.launches = 0
            res, secs = _timed(lambda: eng.execute(it, p0, s0, replication=ctx, **run))
            launches = ops.pulse_chase.launches
            st = res.stats
            if launches != 3 * st.supersteps or st.schedule != "dispatched":
                raise AssertionError(f"{name} {policy} {dead}: {launches} pulse_chase launches "
                                     f"in three calls of {st.supersteps} supersteps "
                                     f"({st.schedule})")
            launches_total += launches
            for f in payload:
                if not torch.equal(getattr(res, f), getattr(healthy, f)):
                    raise AssertionError(f"{name} {policy} {dead}: {f} differs from the "
                                         "healthy run")
            row["replicated"].append(dict(
                policy=policy, dead=list(dead), supersteps=st.supersteps, launches=launches,
                local_only_steps=st.local_only_steps, mean_crossings=float(st.crossings.mean()),
                lookups_per_s=p0.shape[0] / secs, execute_s=secs))
        degraded = [r["lookups_per_s"] for r in row["replicated"] if r["policy"] == "failover"]
        row["degraded_lookups_per_s"] = dict(min=min(degraded), max=max(degraded))
        log(f"[{name}] P={P}: healthy {row['healthy_lookups_per_s']:.4g} lookups/s "
            f"({healthy.stats.supersteps} supersteps); one primary dead (failover) "
            f"{min(degraded):.4g}-{max(degraded):.4g} lookups/s, supersteps "
            f"{[r['supersteps'] for r in row['replicated'] if r['policy'] == 'failover']}; "
            + "; ".join(f"{r['policy']} healthy {r['lookups_per_s']:.4g} lookups/s, "
                        f"{r['supersteps']} supersteps" for r in row["replicated"][P:])
            + f"; payload == healthy in every case; {smi}")

        # one case on a CPU copy and on the sequential executor, bit for bit,
        # on the first 1/FAULTS_CPU_CUT of the queries
        if name == "wiredtiger":
            plan = routing.make_replica_plan(P, policy="failover")
            dead = np.zeros(P, bool)
            dead[1] = True
            ctx = routing.ReplicaContext(plan, rows_by_policy["failover"],
                                         torch.from_numpy(dead).cuda())
            n_cut = p0.shape[0] // FAULTS_CPU_CUT
            rec, st = routing.distributed_execute(it, card, p0[:n_cut], s0[:n_cut],
                                                  mesh=routing.EmulatedMesh(P, "cuda"),
                                                  replication=ctx, **run)
            cpu = arena_from_numpy(*fields, device="cpu")
            crec, cst = routing.distributed_execute(
                it, cpu, b["p0"][:n_cut], b["s0"][:n_cut], mesh=routing.EmulatedMesh(P, "cpu"),
                replication=routing.ReplicaContext(plan, rows_by_policy["failover"].cpu(),
                                                   dead), **run)
            if not torch.equal(rec.cpu(), crec) or _stats_diff(st, cst):
                raise AssertionError(f"{name}: replicated card and CPU copy differ "
                                     f"({_stats_diff(st, cst)})")
            srec, sst = commit.sequential_commit_execute(
                it, card, p0[:n_cut], s0[:n_cut], max_iters=run["max_iters"],
                k_local=run["k_local"], compact=run["compact"], replication=ctx)
            if not np.array_equal(rec.cpu().numpy(), srec) or _stats_diff(st, sst) != ["schedule"]:
                raise AssertionError(f"{name}: replicated run differs from the sequential "
                                     f"executor ({_stats_diff(st, sst)})")
            row["cpu_copy_and_sequential"] = (f"failover, shard 1 dead, the first {n_cut} "
                                              "queries: bit-equal, hops included")
            log(f"[{name}] failover with shard 1 dead, the first 1/{FAULTS_CPU_CUT} of the "
                f"queries ({n_cut:,}): card == CPU copy (every stat) == the replicated "
                f"sequential executor (records with hops, {sst.supersteps} supersteps)")

        # the replica windows against their plain version, at this size
        plan = routing.make_replica_plan(P, policy="failover")
        mask = torch.zeros(P, dtype=torch.bool, device="cuda")
        mask[1] = True
        rep = (rows_by_policy["failover"], torch.tensor(plan.primary_map, dtype=torch.int32,
                                                         device="cuda"), mask, "failover")
        bodies = [(ops.iterator_logic(it).native.name, it)]
        if name == "webservice":
            bodies.append(("isa", as_pulse_iterator(isa_programs.hash_find_program())))
        for body, bit in bodies:
            one = replica_window_vs_plain(card, bit, p0, s0, P, rep)
            if not one["bit_equal"]:
                raise AssertionError(f"{name}/{body}: the replica window disagrees with its "
                                     "plain version")
            one.update(batch=name, body=body)
            window_checks.append(one)
            log(f"[{name}] one superstep with the replica windows, body {body} "
                f"({one['active_records']} active of {one['pool_records']} records, "
                f"{one['rows_read']} rows read): kernel {one['ms']:.5f} ms ({one['ms_source']}), "
                f"without the windows {one['healthy_ms']} ms, plain {one['plain_ms']:.3f} ms, "
                f"bound {one['bound_ms']:.5f} ms; the recorded phase-11 superstep in a "
                f"call {RECORDED_SUPERSTEP_MS} ms; bit_equal=True; {smi}")

        # fabric loss on every schedule x fabric (webservice), records equal
        # to the loss-free run, a replay identical
        if name == "webservice":
            row["loss"] = []
            for schedule, fabric in FT_SCHEDULES:
                kw = dict(run, schedule=schedule, fabric=fabric)

                def lossy():
                    return PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda"),
                                       fault_injector=FaultInjector(FaultPlan(**LOSS_PLAN))
                                       ).execute(it, p0, s0, **kw)

                ops.pulse_chase.launches = 0
                res, secs = _timed(lossy, n=1)
                launches = ops.pulse_chase.launches
                again = lossy()
                st = res.stats
                for f in payload:
                    if not torch.equal(getattr(res, f), getattr(healthy, f)):
                        raise AssertionError(f"{name} loss {schedule}/{fabric}: {f} differs")
                    if not torch.equal(getattr(again, f), getattr(res, f)):
                        raise AssertionError(f"{name} loss {schedule}/{fabric}: the replay's "
                                             f"{f} differs")
                # loss may lengthen a run or shorten it (a parked record
                # keeps the fabric scheduled, so fewer supersteps are
                # local-only): the supersteps are reported, not gated
                if _stats_diff(st, again.stats):
                    raise AssertionError(f"{name} loss {schedule}/{fabric}: the replay differs "
                                         f"on {_stats_diff(st, again.stats)}")
                if schedule == "dispatched" and launches != st.supersteps:
                    raise AssertionError(f"{name} loss: {launches} launches in "
                                         f"{st.supersteps} supersteps")
                launches_total += launches
                loss_row = dict(schedule=schedule, fabric=fabric, supersteps=st.supersteps,
                                loss_free_supersteps=healthy.stats.supersteps,
                                growth=st.supersteps / healthy.stats.supersteps,
                                launches=launches, first_call_s=secs,
                                mean_crossings=float(st.crossings.mean()))
                if (schedule, fabric) == ("dispatched", "dense"):
                    # the card against a CPU copy on the first 1/FAULTS_CPU_CUT queries
                    n_cut = p0.shape[0] // FAULTS_CPU_CUT
                    cut = [PulseEngine(a, mesh=routing.EmulatedMesh(P, a.data.device.type),
                                       fault_injector=FaultInjector(FaultPlan(**LOSS_PLAN))
                                       ).execute(it, q[:n_cut], t[:n_cut], **kw)
                           for a, q, t in ((card, p0, s0),
                                           (arena_from_numpy(*fields, device="cpu"), b["p0"],
                                            b["s0"]))]
                    diff = _stats_diff(cut[0].stats, cut[1].stats)
                    if diff or not all(torch.equal(getattr(cut[0], f).cpu(), getattr(cut[1], f))
                                       for f in payload):
                        raise AssertionError(f"{name} loss: card and CPU copy differ ({diff})")
                    loss_row["card_equals_cpu"] = f"the first {n_cut} queries"
                row["loss"].append(loss_row)
                log(f"[{name}] loss {LOSS_PLAN} on {schedule}/{fabric}: {st.supersteps} "
                    f"supersteps (loss-free {healthy.stats.supersteps}, x{loss_row['growth']:.3f}),"
                    f" records == loss-free, replay identical, first call {secs:.3f} s, "
                    f"{launches} pulse_chase launches"
                    + (f"; card == CPU copy in every stat on the first 1/{FAULTS_CPU_CUT} "
                       "of the queries" if "card_equals_cpu" in loss_row else ""))
        rows.append(row)
        routing.reset_executable_caches()
        del card, eng, healthy
        torch.cuda.empty_cache()

    # the write path: loss on fused/dense, and a kill on each schedule
    wb = _webservice_rw(rng, P)
    _, wit, wp0, ws0 = wb["steps"][0]
    wp0, ws0 = wp0.cuda(), ws0.cuda()
    card = arena_from_numpy(*wb["fields"], device="cuda")
    digest = _digest(card)
    wrun = dict(WRITE_MESH_RUN, schedule="fused", fabric="dense")
    free = PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda")).execute(wit, wp0, ws0, **wrun)
    lossy = []
    for _ in range(2):
        eng = PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda"),
                          fault_injector=FaultInjector(FaultPlan(**LOSS_PLAN)))
        commit_ops.pulse_commit.launches = 0
        res = eng.execute(wit, wp0, ws0, **wrun)
        lossy.append((res, eng.arena, commit_ops.pulse_commit.launches))
    (res, ar, commits), (res2, ar2, _) = lossy
    bad, _ = wb["check"][0](res.status.cpu().numpy(), res.scratch.cpu().numpy())
    if bad:
        raise AssertionError(f"webservice_rw loss: {bad}")
    if (_stats_diff(res.stats, res2.stats) or not torch.equal(ar.data, ar2.data)
            or not torch.equal(ar.heap, ar2.heap)
            or not all(torch.equal(getattr(res, f), getattr(res2, f)) for f in payload)):
        raise AssertionError("webservice_rw loss: the replay differs")
    write_loss = dict(schedule="fused", fabric="dense", supersteps=res.stats.supersteps,
                      loss_free_supersteps=free.stats.supersteps,
                      growth=res.stats.supersteps / free.stats.supersteps,
                      commits=res.stats.commits, first_call_commit_launches=commits)
    log(f"[webservice_rw] loss {LOSS_PLAN} on fused/dense: {res.stats.supersteps} supersteps "
        f"(loss-free {free.stats.supersteps}), every record DONE and every find right, replay "
        "identical (records, stats, data, heap)")
    kills = []
    for schedule in ("dispatched", "fused", "pipelined"):
        eng = PulseEngine(card, mesh=routing.EmulatedMesh(P, "cuda"),
                          fault_injector=FaultInjector(FaultPlan(kill_shard=2, kill_superstep=3)))
        try:
            eng.execute(wit, wp0, ws0, **dict(wrun, schedule=schedule))
            raise AssertionError(f"webservice_rw {schedule}: the kill did not fire")
        except ShardFailure as e:
            if (e.shard, e.superstep) != (2, 3) or eng.arena is not card:
                raise AssertionError(f"webservice_rw {schedule}: {e} / the engine's arena moved")
        if _digest(card) != digest:
            raise AssertionError(f"webservice_rw {schedule}: the kill changed the arena")
        kills.append(schedule)
    log(f"[webservice_rw] a kill before superstep 3 of shard 2 on {kills}: ShardFailure(2, 3), "
        "the arena's digest unchanged")
    routing.reset_executable_caches()
    del card, free, lossy, res, res2, ar, ar2
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"  phase 13 took {secs:.1f} s (CPU copies and the sequential executor included)")
    out = dict(phase="faults", seconds=secs, batches=rows, window_checks=window_checks,
               write_loss=write_loss, kills=kills)
    log(json.dumps(out))
    return out, launches_total


# --------------------------- traversal serving -------------------------------

SERVE_REQUESTS = 32_768  # phase 14's requests
SERVE_SLOTS = 2_048  # slots_per_structure
SERVE_QUANTUM = 16
SLO_QUANTA = (4, 256)  # run (d)'s min_quantum, max_quantum
SLO_DEADLINE_MS = 20.0
RESERVED = 0.05  # the B+tree's keys only updates draw
# a tenant a kind: a tenant's queue is FIFO, so a tenant mixing the tree's
# reads and writes would block on the write barrier at every change of kind
TENANTS = ("cache-reader", "index-reader", "index-writer")


def serving_heap(rng):
    """Phase 14's heap, drawn from ``rng``: the keys and values of the
    ``webservice`` hash table (200,000 keys, 4,096 buckets) and of the
    ``wiredtiger`` B+tree (500,000 keys), and the rows of one arena that
    holds both (``build_serving_arena``)."""
    import numpy as np

    from repro_torch.configs import pulse_paper
    from repro_torch.core.structures import btree

    ws, wt = pulse_paper.WEBSERVICE, pulse_paper.WIREDTIGER
    hkeys = make_keys(rng, ws.n_keys)
    hvals = rng.integers(0, 2**31 - 1, ws.n_keys).astype(np.int32)
    bkeys = make_keys(rng, wt.n_keys)
    bvals = rng.integers(0, 2**31 - 1, wt.n_keys).astype(np.int32)
    rows = ws.n_keys + btree.node_estimate(wt.n_keys)
    cap = -(-rows // 64) * 64  # even shard ranges at 4 and 8 shards
    return dict(hkeys=hkeys, hvals=hvals, bkeys=bkeys, bvals=bvals, cap=cap,
                n_buckets=ws.n_buckets)


def build_serving_arena(heap, P: int, device: str):
    """The heap of ``serving_heap`` built into an arena of ``P`` shards on
    ``device``: ``(arena, bucket heads, root)``."""
    from repro_torch.core.arena import ArenaBuilder
    from repro_torch.core.structures import btree, hash_table

    b = ArenaBuilder(heap["cap"], btree.NODE_WORDS, num_shards=P,
                     policy="interleaved" if P > 1 else "sequential")
    heads = hash_table.build_into(b, heap["hkeys"], heap["hvals"], heap["n_buckets"])
    root, _ = btree.build_into(b, heap["bkeys"], heap["bvals"])
    return b.finish(device=device), heads, root


def serving_requests(rng, heap, n: int = SERVE_REQUESTS):
    """``n`` requests of three tenants (``TENANTS``): 45% hash finds and 45%
    B+tree finds (YCSB Zipfian 0.99 over the stored keys, 10% absent keys),
    10% updates of distinct keys from the 5% of the tree's keys that no
    read draws, in a seeded order, arriving over the rounds at
    ``SERVE_SLOTS * 3 // 4`` a round.  Returns tuples ``(req_id, structure, query, tenant,
    arrive_round, value)`` and the update map ``{key: value}``."""
    import numpy as np

    bkeys = heap["bkeys"]
    n_res = int(len(bkeys) * RESERVED)
    reserved, readable = bkeys[:n_res], bkeys[n_res:]
    n_up = int(round(0.10 * n))
    n_hash = (n - n_up) // 2
    n_bt = n - n_up - n_hash
    hq = make_queries(rng, heap["hkeys"], n_hash)
    bq = make_queries(rng, readable, n_bt)
    # an absent draw may be a reserved key, whose value the updates change
    clash = np.isin(bq, reserved)
    stored = np.sort(bkeys.astype(np.int64))
    while clash.any():
        cand = rng.integers(0, 2**31 - 1, size=int(clash.sum()), dtype=np.int64)
        pos = np.clip(np.searchsorted(stored, cand), 0, len(stored) - 1)
        ok = stored[pos] != cand
        idx = np.flatnonzero(clash)[: int(ok.sum())]
        bq[idx] = cand[ok][: len(idx)].astype(np.int32)
        clash[idx] = False
    up_keys = rng.choice(reserved, n_up, replace=False)
    up_vals = rng.integers(0, 2**31 - 1, n_up).astype(np.int32)
    kinds = rng.permutation(np.array([0] * n_hash + [1] * n_bt + [2] * n_up))
    cursor = [0, 0, 0]
    src = (hq, bq, up_keys)
    names = ("webservice", "wiredtiger", "wiredtiger_update")
    per_round = SERVE_SLOTS * 3 // 4
    out = []
    for i, k in enumerate(kinds):
        q = int(src[k][cursor[k]])
        v = int(up_vals[cursor[k]]) if k == 2 else 0
        cursor[k] += 1
        out.append((i, names[k], q, TENANTS[k], i // per_round, v))
    return out, dict(zip(up_keys.tolist(), up_vals.tolist()))


def serving_specs(heads, root, device: str):
    """The three specs: ``webservice`` (hash finds), ``wiredtiger`` (B+tree
    finds) and ``wiredtiger_update`` (in-place updates, the finds' group)."""
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core.structures import btree, hash_table
    from repro_torch.serving.traversal_service import StructureSpec

    nb = pulse_paper.WEBSERVICE.n_buckets
    return {
        "webservice": StructureSpec(hash_table.find_iterator(nb),
                                    (torch.as_tensor(heads).to(device),)),
        "wiredtiger": StructureSpec(btree.find_iterator(), (root,), group="wiredtiger"),
        "wiredtiger_update": StructureSpec(btree.update_iterator(), (root,),
                                           group="wiredtiger", takes_value=True),
    }


class _EngineTally:
    """Wraps one engine's ``execute`` to count its calls by iterator kind
    and add up their wall time (the host clock around each call, whose
    result the service then copies to the host).  ``kinds`` is the call
    log: "r" or "w" for each call in order (a fault plan's ``kill_call``
    counts the same calls on one node and on a mesh without a watchdog)."""

    def __init__(self, engine):
        self.reads = self.writes = 0
        self.seconds = 0.0
        self.kinds: list[str] = []
        self._execute = engine.execute
        engine.execute = self

    def __call__(self, it, *args, **kw):
        t0 = time.perf_counter()
        self.kinds.append("w" if it.mutates else "r")
        try:
            return self._execute(it, *args, **kw)
        finally:
            self.seconds += time.perf_counter() - t0
            if it.mutates:
                self.writes += 1
            else:
                self.reads += 1


def serve_run(tag, arena, specs, tuples, *, P: int, deadline_ms=None, reshard_at=None,
              fault_plan=None, on_service=None, extra=None, mesh=None, **svc_kw):
    """One phase-14 (or 15, or 23) run: a ``PulseService`` over ``arena``
    (on ``mesh``, by default an emulated mesh of P when P > 1) serving
    ``tuples``, its engine killing or delaying a shard by ``fault_plan``.  ``on_service(svc)`` runs after the
    service is built, before the launch counts are set to 0 (just before
    the run; they are read just after).  Returns (requests, metrics,
    engine, row); ``extra``, a dict, receives the service and the call
    log."""
    import numpy as np
    import torch

    from repro_torch.core import routing
    from repro_torch.core.engine import PulseEngine
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.kernels.pulse_commit import ops as commit_ops
    from repro_torch.serving.admission import TraversalRequest
    from repro_torch.serving.traversal_service import PulseService

    from repro_torch.core.faults import FaultInjector

    dev = arena.data.device.type
    if mesh is None and P > 1:
        mesh = routing.EmulatedMesh(P, dev)
    eng = PulseEngine(arena, mesh=mesh,
                      fault_injector=FaultInjector(fault_plan) if fault_plan else None)
    tally = _EngineTally(eng)
    svc = PulseService(eng, specs, slots_per_structure=SERVE_SLOTS, quantum=SERVE_QUANTUM,
                       **svc_kw)
    if on_service is not None:
        on_service(svc)
    if extra is not None:
        extra.update(svc=svc, kinds=tally.kinds)
    quanta = []
    pick = svc._quantum_for_round
    svc._quantum_for_round = lambda now: quanta.append(pick(now)) or quanta[-1]
    reqs = [TraversalRequest(i, s, q, tenant=t, arrive_round=a, value=v, deadline_ms=deadline_ms)
            for i, s, q, t, a, v in tuples]
    for r in reqs:
        svc.submit(r)
    retired_at = None
    if dev == "cuda":
        torch.cuda.synchronize()
    traces0 = routing.CACHE_STATS.traces
    chase_ops.pulse_chase.launches = commit_ops.pulse_commit.launches = 0
    t0 = time.perf_counter()
    try:
        while svc._busy():
            if (reshard_at is not None and retired_at is None
                    and svc.metrics.retired >= reshard_at):
                retired_at = svc.metrics.retired
                svc.request_reshard(2 * P)
            if svc.metrics.rounds > 100_000:
                raise RuntimeError(f"{tag}: the service did not drain")
            svc.step()
    finally:
        svc.close()
        svc._drain_emit()
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chase_ops.pulse_chase.launches
    commits = commit_ops.pulse_commit.launches
    m = svc.metrics
    m.wall_s = wall
    lat = np.asarray(m.latencies_ms)
    row = dict(
        run=tag, device=dev, shards=P, requests=len(reqs), completed=m.completed,
        requests_per_s=m.completed / wall, p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)), p999_ms=float(np.percentile(lat, 99.9)),
        rounds=m.rounds, engine_calls=m.engine_calls, read_calls=tally.reads,
        write_calls=tally.writes, mean_quantum=float(np.mean(quanta)),
        quantum_min=min(quanta), quantum_max=max(quanta), distinct_quanta=len(set(quanta)),
        captures=routing.CACHE_STATS.traces - traces0 if dev == "cuda" else None,
        pulse_chase_launches=launches, pulse_commit_launches=commits,
        supersteps=m.supersteps, commits=m.commits, reshards=m.reshards,
        reshard_after_retired=retired_at, wall_s=wall,
        host_share=1.0 - tally.seconds / wall, engine_s=tally.seconds,
        recoveries=m.recoveries, replayed_commits=m.replayed_commits, retries=m.retries,
        mean_recovery_ms=m.mean_recovery_ms if m.recoveries else None,
        failover_quanta=m.failover_quanta, replica_quanta=m.replica_quanta,
        watchdog_probes=m.watchdog_probes, watchdog_suspects=m.watchdog_suspects)
    return reqs, m, eng, row


def _serving_counts(m):
    import dataclasses

    skip = ("wall_s", "latencies_ms", "per_tenant", "recovery_ms_total")
    out = {f.name: getattr(m, f.name) for f in dataclasses.fields(m) if f.name not in skip}
    out["per_tenant"] = {t: v["completed"] for t, v in sorted(m.per_tenant.items())}
    return out


def _same_requests(tag, a, b, *, rounds: bool = True):
    """Request by request: status, iters, result (and the rounds)."""
    import numpy as np

    for x, y in zip(a, b):
        same = (x.status, x.iters) == (y.status, y.iters) and np.array_equal(x.result, y.result)
        if rounds:
            same = same and (x.admit_round, x.finish_round) == (y.admit_round, y.finish_round)
        if not same:
            raise AssertionError(f"{tag}: request {x.req_id} ({x.structure}) differs: "
                                 f"{(x.status, x.iters, x.admit_round, x.finish_round, x.result)}"
                                 f" vs {(y.status, y.iters, y.admit_round, y.finish_round, y.result)}")


def _check_against_oracle(tag, reqs, heap, *, updates: bool = True):
    """Every request DONE, every read equal to its structure's
    ``ref_find``, every update found its key (``updates=False``: a
    reads-only run, which holds none)."""
    import numpy as np

    from repro_torch.core.iterator import STATUS_DONE
    from repro_torch.core.structures import btree, hash_table

    by = {}
    for r in reqs:
        if r.status != STATUS_DONE:
            raise AssertionError(f"{tag}: request {r.req_id} retired with status {r.status}")
        by.setdefault(r.structure, []).append(r)
    q = np.array([r.query for r in by["webservice"]], np.int32)
    want = hash_table.ref_find(heap["hkeys"], heap["hvals"], heap["n_buckets"], q)
    got = [(int(r.result[1]), int(r.result[2])) for r in by["webservice"]]
    if got != [tuple(w[:2]) for w in want]:
        raise AssertionError(f"{tag}: hash finds disagree with ref_find")
    q = np.array([r.query for r in by["wiredtiger"]], np.int32)
    want = btree.ref_find(heap["bkeys"], heap["bvals"], q)
    got = [(int(r.result[1]), int(r.result[2])) for r in by["wiredtiger"]]
    if got != [tuple(w[:2]) for w in want]:
        raise AssertionError(f"{tag}: B+tree finds disagree with ref_find")
    if updates and not all(int(r.result[btree.U_FOUND]) == 1
                           for r in by["wiredtiger_update"]):
        raise AssertionError(f"{tag}: an update missed its key")
    if not updates and "wiredtiger_update" in by:
        raise AssertionError(f"{tag}: a reads-only run served updates")


def _updates_visible(tag, eng, root, updates):
    """The final tree read back through ``eng`` (after the run's counts
    were read): every updated key holds its value."""
    import numpy as np
    import torch

    from repro_torch.core.structures import btree

    keys = np.array(sorted(updates), np.int32)
    it = btree.find_iterator()
    dev = eng.arena.data.device
    p0, s0 = it.init(torch.from_numpy(keys).to(dev), root)
    kw = dict(schedule="dispatched") if eng.mesh is not None else {}
    res = eng.execute(it, p0, s0, max_iters=4096, **kw)
    scr = res.scratch.cpu().numpy()
    if not (scr[:, 2] == 1).all() or scr[:, 1].tolist() != [updates[k] for k in keys.tolist()]:
        raise AssertionError(f"{tag}: the final tree does not hold the updates")


def budget_operand_check(arena, heads, P: int):
    """The superstep mode with the budget as a device tensor, at two
    budgets, against its plain version with the budget as an int, on one
    placed pool of hash finds over the mesh heap.  Returns the check row."""
    import numpy as np
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core import routing
    from repro_torch.core.structures import hash_table
    from repro_torch.kernels.pulse_chase import ops, ref

    nb = pulse_paper.WEBSERVICE.n_buckets
    it = hash_table.find_iterator(nb)
    g = np.random.default_rng(14)
    q = torch.from_numpy(g.integers(0, 2**31 - 1, SERVE_SLOTS).astype(np.int32)).cuda()
    p0, s0 = it.init(q, torch.as_tensor(heads).cuda())
    pools, _ = routing.place_requests(p0, s0, P)
    logic = ops.iterator_logic(it)
    rows, err = [], 0
    for budget in (3, SERVE_QUANTUM):
        dev_budget = torch.tensor(budget, dtype=torch.int32, device="cuda")
        got = ops.pulse_chase_superstep(arena.data, pools, arena.bounds, arena.perms,
                                        logic_fn=logic, k_local=4, max_iters=dev_budget)
        want = ref.chase_superstep_reference(arena.data, pools, arena.bounds, arena.perms,
                                             logic, 4, scratch_words=it.scratch_words,
                                             max_iters=budget)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        maxed = int((got[..., routing.F_STATUS] == 2).sum())
        rows.append(dict(budget=budget, max_abs_err=e, maxed=maxed))
        if e != 0:
            raise AssertionError(f"the device-budget superstep disagrees with its plain version "
                                 f"at budget {budget}: max |err| {e}")
    return dict(name="pulse_chase superstep, budget as a device tensor", budgets=rows,
                max_abs_err=err)


def phase_serving(rng, smi):
    """Phase 14: traversal serving, ``PulseService`` over the port's engine
    on the card, runs (a)-(e); see the module docstring."""
    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy

    t_phase = time.perf_counter()
    heap = serving_heap(rng)
    tuples, updates = serving_requests(rng, heap)
    rows, results = [], {}
    one, heads, root = build_serving_arena(heap, 1, "cuda")
    cpu_fields = [t.cpu().numpy() for t in (one.data, one.bounds, one.perms, one.heap)]

    # (a) one node, sync, the card against a CPU copy of the same service
    ra, ma, ea, row = serve_run("a: one node, sync", one, serving_specs(heads, root, "cuda"),
                                tuples, P=1)
    a_row = row
    rows.append(row)
    cpu = arena_from_numpy(*cpu_fields, device="cpu")
    rc, mc, ec, crow = serve_run("a: CPU copy", cpu, serving_specs(heads, root, "cpu"), tuples,
                                 P=1)
    _same_requests("(a) card vs CPU copy", ra, rc)
    if _serving_counts(ma) != _serving_counts(mc):
        raise AssertionError(f"(a) metrics differ: {_serving_counts(ma)} vs "
                             f"{_serving_counts(mc)}")
    if row["pulse_chase_launches"] != row["read_calls"]:
        raise AssertionError(f"(a): {row['pulse_chase_launches']} pulse_chase launches for "
                             f"{row['read_calls']} read engine calls")
    _check_against_oracle("(a)", ra, heap)
    _updates_visible("(a)", ea, root, updates)
    log(f"  (a) card == CPU copy ({crow['wall_s']:.1f} s on the CPU), reads == ref_find, "
        f"updates visible")

    # (b) the same on the async pipeline
    one_b = arena_from_numpy(*cpu_fields, device="cuda")
    rb, mb, eb, row = serve_run("b: one node, async", one_b, serving_specs(heads, root, "cuda"),
                                tuples, P=1, pipeline="async")
    rows.append(row)
    _same_requests("(b) async vs (a)", ra, rb)
    if _serving_counts(ma) != _serving_counts(mb):
        raise AssertionError("(b) metrics differ from (a)")
    if row["pulse_chase_launches"] != row["read_calls"]:
        raise AssertionError("(b): pulse_chase launches != read engine calls")
    _updates_visible("(b)", eb, root, updates)

    # (c) the mesh of four, interleaved, schedule "auto" (pipelined), sync
    P = 4
    mesh_arena, mheads, mroot = build_serving_arena(heap, P, "cuda")
    mesh_fields = [t.cpu().numpy() for t in (mesh_arena.data, mesh_arena.bounds,
                                             mesh_arena.perms, mesh_arena.heap)]
    routing.reset_executable_caches()
    c_extra = {}
    rcm, mcm, ecm, row = serve_run("c: mesh of 4, sync", mesh_arena,
                                   serving_specs(mheads, mroot, "cuda"), tuples, P=P,
                                   extra=c_extra)
    c_row = row
    rows.append(row)
    _same_requests("(c) mesh vs (a)", ra, rcm, rounds=False)
    if row["captures"] != len(serving_specs(mheads, mroot, "cuda")):
        raise AssertionError(f"(c): {row['captures']} captures for three groups")
    _updates_visible("(c)", ecm, mroot, updates)
    budget_row = budget_operand_check(arena_from_numpy(*mesh_fields, device="cuda"), mheads, P)

    # (d) the mesh, async, SLO sizing with a deadline on every request
    routing.reset_executable_caches()
    rd, md, ed, row = serve_run(
        "d: mesh of 4, async, SLO sizing", arena_from_numpy(*mesh_fields, device="cuda"),
        serving_specs(mheads, mroot, "cuda"), tuples, P=P, pipeline="async",
        min_quantum=SLO_QUANTA[0], max_quantum=SLO_QUANTA[1], deadline_ms=SLO_DEADLINE_MS)
    rows.append(row)
    if row["captures"] != 3:
        raise AssertionError(f"(d): {row['captures']} captures for three groups over "
                             f"{row['distinct_quanta']} quanta: the budget must be a device "
                             f"operand")
    _check_against_oracle("(d)", rd, heap)
    _updates_visible("(d)", ed, mroot, updates)

    # (e) (c) with a live reshard to 8 once a third of the requests retired
    routing.reset_executable_caches()
    re_, me, ee, row = serve_run(
        "e: mesh of 4 -> 8, sync", arena_from_numpy(*mesh_fields, device="cuda"),
        serving_specs(mheads, mroot, "cuda"), tuples, P=P, reshard_at=len(tuples) // 3)
    rows.append(row)
    if me.reshards != 1 or ee.arena.num_shards != 2 * P:
        raise AssertionError(f"(e): {me.reshards} reshards, {ee.arena.num_shards} shards")
    _check_against_oracle("(e)", re_, heap)
    _updates_visible("(e)", ee, mroot, updates)

    for r in rows:
        log(f"  [{r['run']}] {r['requests_per_s']:,.0f} requests/s, p50 {r['p50_ms']:.3f} / "
            f"p99 {r['p99_ms']:.3f} / p999 {r['p999_ms']:.3f} ms, {r['rounds']} rounds, "
            f"{r['engine_calls']} engine calls ({r['read_calls']} read), mean quantum "
            f"{r['mean_quantum']:.2f} ({r['quantum_min']}-{r['quantum_max']}), captures "
            f"{r['captures']}, pulse_chase {r['pulse_chase_launches']}, pulse_commit "
            f"{r['pulse_commit_launches']}, supersteps {r['supersteps']}, host share "
            f"{r['host_share']:.1%} of {r['wall_s']:.2f} s; {smi}")
    log(f"  budget operand: {budget_row['budgets']}")
    secs = time.perf_counter() - t_phase
    log(f"  phase 14 took {secs:.1f} s (the CPU copy included)")
    out = dict(phase="serving", seconds=secs, card=smi, runs=rows, budget_check=budget_row,
               cpu_copy=crow)
    log(json.dumps(out))
    # what phase 15 runs against: (a)'s and (c)'s requests, final data and
    # call log, and the heap they ran on
    ctx = dict(heap=heap, tuples=tuples, updates=updates, heads=heads, root=root,
               cpu_fields=cpu_fields, mesh_fields=mesh_fields, mheads=mheads, mroot=mroot,
               a=(ra, ma, a_row, ea.arena.data.cpu()), c=(rcm, mcm, c_row, ecm.arena.data.cpu(),
                                                           c_extra["kinds"]))
    return out, ctx


# ---------------------- fault tolerance and durability ------------------------

FT_SNAPSHOT_EVERY = 8  # logged write quanta between snapshots in runs (f)-(i)
WATCHDOG_READS = 4_096  # run (i)'s reads-only cut of phase 14's requests
HEALTHY_PROBE_REPS = 5  # run (i)'s timed healthy probes a shard, after a warm-up
WATCHDOG_PER_ROUND = 512  # its arrivals a round: rounds for the watchdog to act in


class _Timed:
    """Wraps a callable, keeping each call's wall seconds."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds: list[float] = []

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.seconds.append(time.perf_counter() - t0)


def _ms(seconds):
    import numpy as np

    if not seconds:
        return dict(n=0, mean_ms=None, max_ms=None)
    a = np.asarray(seconds) * 1e3
    return dict(n=len(a), mean_ms=float(a.mean()), max_ms=float(a.max()))


def _store_hooks(store):
    """Times an ``ArenaStore``'s log appends (the fsync included) and
    snapshots, sizes each snapshot on disk and keeps each recovery's
    ``RecoveryInfo``.  Installed before the service is built, so the
    baseline snapshot is among them."""
    hooks = dict(append=_Timed(store.log.append), snapshot=_Timed(store.snapshot),
                 snapshot_bytes=[], recoveries=[])
    store.log.append = hooks["append"]
    snap, recover = hooks["snapshot"], store.recover

    def snapshot(arena, log_seq=None, **kw):
        seq = snap(arena, log_seq, **kw)
        d = store.dir / f"step_{seq:08d}"
        hooks["snapshot_bytes"].append(sum(f.stat().st_size for f in d.iterdir()))
        return seq

    def recover_and_keep(**kw):
        arena, info = recover(**kw)
        hooks["recoveries"].append(info)
        return arena, info

    store.snapshot = snapshot
    store.recover = recover_and_keep
    return hooks


def _pick_call(kinds, kind: str, *, skip=lambda n: False):
    """The index of the engine call of ``kind`` ("r" or "w") nearest the
    middle of the call log ``kinds``; ``skip(n)`` drops the one with ``n``
    calls of that kind before it."""
    idx, n = [], 0
    for i, k in enumerate(kinds):
        if k == kind:
            if not skip(n):
                idx.append(i)
            n += 1
    if not idx:
        raise AssertionError(f"no engine call of kind {kind!r} to kill in {len(kinds)} calls")
    return min(idx, key=lambda i: abs(i - len(kinds) / 2))


def _same_arena(tag, a, b, fields=("data", "bounds", "perms", "heap")):
    import torch

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{tag}: arena.{f} differs")


def phase_fault_tolerance(ctx, smi):
    """Phase 15: fault tolerance and durability, ``PulseService(...,
    fault_tolerance=FaultToleranceConfig(...))`` over phase 14's heap,
    specs and requests, runs (f)-(i); see the module docstring.  Returns
    the phase's row and its ``pulse_chase`` and ``pulse_commit`` launches."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.core.iterator import STATUS_RETRY
    from repro_torch.distributed.arena_ft import (
        ArenaStore,
        FaultToleranceConfig,
        ReplicationConfig,
    )
    from repro_torch.kernels.pulse_chase import ops as chase_ops

    t_phase = time.perf_counter()
    heap, tuples, updates = ctx["heap"], ctx["tuples"], ctx["updates"]
    heads, root, mheads, mroot = ctx["heads"], ctx["root"], ctx["mheads"], ctx["mroot"]
    ra, ma, a_row, a_data = ctx["a"]
    rcm, mcm, c_row, c_data, c_kinds = ctx["c"]
    P = 4
    rows = {}
    launches = dict(pulse_chase=0, pulse_commit=0)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ft_")
    root_dir = Path(tmp.name)

    def count(row):
        launches["pulse_chase"] += row["pulse_chase_launches"]
        launches["pulse_commit"] += row["pulse_commit_launches"]

    try:
        # (f) (a) made durable: every write quantum logged and fsynced before
        # it is acknowledged, a snapshot every 8 logged quanta, no kill
        store = ArenaStore(root_dir / "f")
        hooks = _store_hooks(store)
        f_extra = {}
        rf, mf, ef, row = serve_run(
            "f: one node, sync, durable", arena_from_numpy(*ctx["cpu_fields"], device="cuda"),
            serving_specs(heads, root, "cuda"), tuples, P=1, extra=f_extra,
            fault_tolerance=FaultToleranceConfig(store=store, snapshot_every=FT_SNAPSHOT_EVERY))
        store.close()
        count(row)
        _same_requests("(f) vs (a)", ra, rf)
        if _serving_counts(mf) != _serving_counts(ma):
            raise AssertionError(f"(f) metrics differ from (a): {_serving_counts(mf)} vs "
                                 f"{_serving_counts(ma)}")
        if not torch.equal(ef.arena.data.cpu(), a_data):
            raise AssertionError("(f): the final data differs from (a)'s")
        row.update(a_requests_per_s=a_row["requests_per_s"],
                   log_append=_ms(hooks["append"].seconds),
                   snapshot=_ms(hooks["snapshot"].seconds),
                   snapshot_bytes=hooks["snapshot_bytes"], snapshots=store.snapshots_taken)
        rows["f"] = row
        log(f"  (f) == (a) in every request and count; {row['requests_per_s']:,.0f} requests/s "
            f"beside (a)'s {a_row['requests_per_s']:,.0f}; log append (fsync included) mean "
            f"{row['log_append']['mean_ms']:.3f} / max {row['log_append']['max_ms']:.3f} ms over "
            f"{row['log_append']['n']} appends; snapshot mean {row['snapshot']['mean_ms']:.1f} / "
            f"max {row['snapshot']['max_ms']:.1f} ms, {hooks['snapshot_bytes'][0]:,} bytes, "
            f"{row['snapshots']} snapshots (the baseline included); {smi}")

        # (g) (f) with shard 0 killed at the update quantum nearest the
        # middle of (f)'s run whose log since the last snapshot is not empty
        K = _pick_call(f_extra["kinds"], "w", skip=lambda n: n % FT_SNAPSHOT_EVERY == 0)
        plan = FaultPlan(kill_shard=0, kill_call=K, kill_superstep=1)
        outs = {}
        for dev in ("cuda", "cpu"):
            store = ArenaStore(root_dir / f"g_{dev}")
            hooks = _store_hooks(store)
            r, m, e, row = serve_run(
                f"g: one node, kill shard 0 at call {K}" + (" (CPU copy)" if dev == "cpu" else ""),
                arena_from_numpy(*ctx["cpu_fields"], device=dev),
                serving_specs(heads, root, dev), tuples, P=1, fault_plan=plan,
                fault_tolerance=FaultToleranceConfig(store=store,
                                                     snapshot_every=FT_SNAPSHOT_EVERY))
            infos = list(hooks["recoveries"])
            rec, _ = store.recover(device=dev)
            store.close()
            _same_arena(f"(g, {dev}) store.recover() after the run vs the resident arena", rec,
                        e.arena)
            outs[dev] = (r, m, e, row, infos)
        rg, mg, eg, row, infos = outs["cuda"]
        count(row)
        _same_requests("(g) card vs CPU copy", rg, outs["cpu"][0])
        if _serving_counts(mg) != _serving_counts(outs["cpu"][1]):
            raise AssertionError(f"(g) metrics differ: {_serving_counts(mg)} vs "
                                 f"{_serving_counts(outs['cpu'][1])}")
        if mg.recoveries != 1 or mg.replayed_commits <= 0 or len(infos) != 1:
            raise AssertionError(f"(g): {mg.recoveries} recoveries, {mg.replayed_commits} "
                                 f"replayed commits")
        if not torch.equal(eg.arena.data.cpu(), a_data):
            raise AssertionError("(g): the final data differs from (a)'s")
        _check_against_oracle("(g)", rg, heap)
        _updates_visible("(g)", eg, root, updates)
        row.update(kill_call=K, quanta_replayed=infos[0].replayed_quanta,
                   snapshot_seq=infos[0].snapshot_seq, cpu_copy_s=outs["cpu"][3]["wall_s"])
        rows["g"] = row
        log(f"  (g) kill of shard 0 at call {K} (an update quantum): card == CPU copy "
            f"({row['cpu_copy_s']:.1f} s), 1 recovery, {row['quanta_replayed']} quanta and "
            f"{mg.replayed_commits} commits replayed from the snapshot at seq "
            f"{row['snapshot_seq']}, {mg.retries} retries, mean recovery "
            f"{mg.mean_recovery_ms:.1f} ms (snapshot load and replay), "
            f"{row['requests_per_s']:,.0f} requests/s; reads == ref_find, updates visible, "
            f"data == (a); {smi}")

        # (h) (c) with failover replication and shard 2 killed at the read
        # quantum nearest the middle of (c)'s run
        Kh = _pick_call(c_kinds, "r")
        store = ArenaStore(root_dir / "h")
        hooks = _store_hooks(store)
        standby = {}

        def time_standby(svc):
            standby["apply"] = _Timed(svc._replicas.apply_quantum)
            svc._replicas.apply_quantum = standby["apply"]

        routing.reset_executable_caches()
        h_extra = {}
        rh, mh, eh, row = serve_run(
            f"h: mesh of 4, failover replication, kill shard 2 at call {Kh}",
            arena_from_numpy(*ctx["mesh_fields"], device="cuda"),
            serving_specs(mheads, mroot, "cuda"), tuples, P=P,
            fault_plan=FaultPlan(kill_shard=2, kill_call=Kh, kill_superstep=2),
            on_service=time_standby, extra=h_extra,
            fault_tolerance=FaultToleranceConfig(
                store=store, snapshot_every=FT_SNAPSHOT_EVERY, dead_rounds=6,
                replication=ReplicationConfig(policy="failover")))
        store.close()
        count(row)
        if mh.recoveries != 1 or mh.failover_quanta < 1:
            raise AssertionError(f"(h): {mh.recoveries} recoveries, {mh.failover_quanta} "
                                 f"failover quanta")
        bad = [r.req_id for r in rh if (not r.structure.endswith("_update") and r.retries)
               or r.status == STATUS_RETRY]
        if bad:
            raise AssertionError(f"(h): {len(bad)} requests retried reads or ended "
                                 f"STATUS_RETRY, first {bad[:5]}")
        _same_requests("(h) vs (a)", ra, rh, rounds=False)
        if not torch.equal(eh.arena.data.cpu(), c_data):
            raise AssertionError("(h): the final data differs from (c)'s")
        reps = h_extra["svc"]._replicas
        reps.verify(eh.arena)
        _same_arena("(h) the standby vs the primary", reps.shadow, eh.arena)
        if row["captures"] != 3:
            raise AssertionError(f"(h): {row['captures']} captures for three groups: the "
                                 f"recovery or the fan-out captured again")
        if mh.replica_quanta != row["write_calls"]:
            raise AssertionError(f"(h): {mh.replica_quanta} quanta shipped for "
                                 f"{row['write_calls']} write calls")
        row.update(kill_call=Kh, c_requests_per_s=c_row["requests_per_s"],
                   standby=_ms(standby["apply"].seconds),
                   quanta_replayed=hooks["recoveries"][0].replayed_quanta)
        rows["h"] = row
        log(f"  (h) kill of shard 2 at call {Kh} (a read quantum): 1 recovery "
            f"({row['quanta_replayed']} quanta replayed, mean {mh.mean_recovery_ms:.1f} ms), "
            f"{mh.failover_quanta} failover quanta, no read retried, (h) == (a) per request, "
            f"data == (c), the standby == the primary, {row['captures']} captures; "
            f"{row['requests_per_s']:,.0f} requests/s beside (c)'s "
            f"{c_row['requests_per_s']:,.0f}; {mh.replica_quanta} write quanta shipped, the "
            f"standby {row['standby']['mean_ms']:.1f} ms a quantum (max "
            f"{row['standby']['max_ms']:.1f}); {smi}")

        # (i) the watchdog on a reads-only cut: a straggler that never raises
        arena_i = arena_from_numpy(*ctx["mesh_fields"], device="cuda")
        reads = [t for t in tuples if t[1] != "wiredtiger_update"][:WATCHDOG_READS]
        reads = [(j, s_, q, t, j // WATCHDOG_PER_ROUND, v)
                 for j, (_, s_, q, t, _, v) in enumerate(reads)]
        probe_launches = [0]
        healthy = []
        ei_svc = {}

        def arm_watchdog(svc):
            # healthy probes of every shard through the service's own probe
            # (warm: no fault injection; a warm-up each, then the reps), not
            # the main path's launches; the watchdog's timeout and shard 1's
            # delay are set from them before the run
            for shard in range(P):
                for rep in range(HEALTHY_PROBE_REPS + 1):
                    dt = svc._probe_shard(shard, warm=True)
                    if rep:
                        healthy.append(dt)
            timeout = max(0.02, 10 * max(healthy))
            svc.ft.watchdog_timeout_s = timeout
            svc.engine.fault_injector = FaultInjector(
                FaultPlan(delay_shard=1, delay_s=4 * timeout))
            probe = svc._probe_shard

            def counted(shard, *, warm=False):
                n0 = chase_ops.pulse_chase.launches
                try:
                    return probe(shard, warm=warm)
                finally:
                    probe_launches[0] += chase_ops.pulse_chase.launches - n0

            svc._probe_shard = counted

        store = ArenaStore(root_dir / "i")
        routing.reset_executable_caches()
        specs_i = {k: v for k, v in serving_specs(mheads, mroot, "cuda").items()
                   if not v.writes}
        ri, mi, ei, row = serve_run(
            "i: mesh of 4, reads only, watchdog, shard 1 delayed", arena_i, specs_i, reads,
            P=P, on_service=arm_watchdog, extra=ei_svc,
            fault_tolerance=FaultToleranceConfig(
                store=store, snapshot_every=FT_SNAPSHOT_EVERY, dead_rounds=1000,
                replication=ReplicationConfig(policy="failover"),
                watchdog_timeout_s=1.0))  # armed; set by arm_watchdog before the run
        store.close()
        timeout_s = ei_svc["svc"].ft.watchdog_timeout_s
        delay_s = ei.fault_injector.plan.delay_s
        count(row)
        if (mi.watchdog_suspects < 1 or mi.failover_quanta < 1 or mi.retries
                or mi.recoveries):
            raise AssertionError(f"(i): {mi.watchdog_suspects} suspects, {mi.failover_quanta} "
                                 f"failover quanta, {mi.retries} retries, {mi.recoveries} "
                                 f"recoveries")
        _check_against_oracle("(i)", ri, heap, updates=False)
        if probe_launches[0] <= 0:
            raise AssertionError("(i): the probes launched no pulse_chase kernel")
        row.update(healthy_probe=_ms(healthy), watchdog_timeout_s=timeout_s, delay_s=delay_s,
                   probe_launches=probe_launches[0])
        rows["i"] = row
        log(f"  (i) healthy probe mean {row['healthy_probe']['mean_ms']:.3f} / max "
            f"{row['healthy_probe']['max_ms']:.3f} ms; watchdog timeout {timeout_s * 1e3:.1f} "
            f"ms, shard 1 delayed {delay_s * 1e3:.1f} ms a superstep: {mi.watchdog_suspects} "
            f"suspect(s) over {mi.watchdog_probes} probes ({probe_launches[0]} pulse_chase "
            f"launches), {mi.failover_quanta} failover quanta, 0 retries, 0 recoveries, reads "
            f"== ref_find; {row['requests_per_s']:,.0f} requests/s over {row['rounds']} "
            f"rounds; {smi}")
    finally:
        tmp.cleanup()

    for r in rows.values():
        log(f"  [{r['run']}] {r['requests_per_s']:,.0f} requests/s, p50 {r['p50_ms']:.3f} / "
            f"p99 {r['p99_ms']:.3f} ms, {r['rounds']} rounds, {r['engine_calls']} engine calls "
            f"({r['read_calls']} read), captures {r['captures']}, pulse_chase "
            f"{r['pulse_chase_launches']}, pulse_commit {r['pulse_commit_launches']}, "
            f"{r['wall_s']:.2f} s; {smi}")
    secs = time.perf_counter() - t_phase
    log(f"  phase 15 took {secs:.1f} s (the CPU copy included)")
    out = dict(phase="fault_tolerance", seconds=secs, card=smi, runs=rows, launches=launches)
    log(json.dumps(out, default=float))
    return out


# --------------------------- attention kernels ------------------------------


def _close(got, want, dtype, tols=TOL):
    """(within tolerance?, max |diff|) of two CUDA tensors, in f32."""
    import torch

    g, w = got.float(), want.float()
    tol = tols[dtype]
    ok = bool(torch.all((g - w).abs() <= tol + tol * w.abs()).item())
    return ok, float((g - w).abs().max().item())


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(
        getattr(torch, dtype))


def bound(flops, nbytes, flop_per_s=F32_FLOP_PER_S):
    """(least ms, what bounds it): the larger of the two times, the
    operations at ``flop_per_s`` (by default the f32 peak outside the
    tensor cores) and the bytes at the HBM rate."""
    t_ops, t_bytes = flops / flop_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tensor_core_bound(flops, nbytes):
    """``bound`` for a kernel whose f32 products run in 3xTF32 on the
    tensor cores (flash_attention, ssd_scan): three TF32 products for each
    f32 one, at the TF32 peak."""
    return bound(flops, nbytes, TF32_FLOP_PER_S / TF32X3)


def time_flash(gen, B, H, Hk, L, D, *, Lk=None, causal=True):
    """Kernel, plain version and SDPA at one f32 shape, on the models' route
    (no blocks: any lengths): a prefill call's attention in one layer, L
    queries over Lk keys (L by default), causal (square) or full."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.work import flash_work

    Lk = L if Lk is None else Lk
    q = _randn(gen, (B, H, L, D), "float32")
    k, v = _randn(gen, (B, Hk, Lk, D), "float32"), _randn(gen, (B, Hk, Lk, D), "float32")

    def kernel():
        return ops.flash_attention(q, k, v, causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    want = ref.mha_reference(q, k, v, causal=causal)
    ok, err = _close(kernel(), want, "float32")
    _, lib_err = _close(library(), want, "float32")
    del want
    what = f"B={B} H={H} Hk={Hk} Lq={L} Lk={Lk} D={D} {'causal' if causal else 'full'} f32"
    log(f"  flash {what}: max_abs_err={err:.3g} ok={ok} (SDPA vs plain {lib_err:.3g})")
    if not ok:
        raise AssertionError("flash_attention kernel disagrees with its plain version")
    events_ms = time_cuda(kernel, 50)
    device_ms = kernel_device_ms([kernel], 20, "flash_fwd")
    ms = events_ms if device_ms is None else device_ms
    plain_ms = time_cuda(lambda: ref.mha_reference(q, k, v, causal=causal), 10)
    library_ms = time_cuda(library, 50)
    flops, nbytes = flash_work(B, H, Hk, L, Lk, D, causal)
    bound_ms, bound_by = tensor_core_bound(flops, nbytes)
    fma_ms = bound(flops, nbytes)[0]
    row = dict(shape=[B, H, Hk, L, Lk, D], causal=causal, dtype="float32", max_abs_err=err,
               ms=ms, ms_source="events" if device_ms is None else "profiler",
               ms_events=events_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=lib_err, flops=flops, bytes=nbytes, bound_ms=bound_ms,
               bound_by=bound_by, bound_ms_f32_fma=fma_ms)
    log(f"  flash {what}: kernel {ms:.4f} ms ({row['ms_source']}; "
        f"CUDA events over 50 launches {events_ms:.4f} ms), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, 3xTF32 on the tensor cores: "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; at the f32 FMA rate {fma_ms:.5f} ms), "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return row


def phase_flash(seed):
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [  # B, H, Hk, Lq, Lk, D, causal, block
        (2, 4, 2, 128, 128, 64, True, 64),
        (1, 4, 4, 256, 256, 32, True, 64),
        (2, 2, 1, 128, 256, 64, True, 64),
        (1, 4, 2, 128, 128, 64, False, 64),
        # head dims 112 (kimi_k2_1t_a32b: G = 8; zamba2_7b: G = 1) and 16
        (1, 64, 8, 200, 200, 112, True, 8),
        (2, 4, 4, 136, 136, 112, False, 8),
        (2, 4, 2, 128, 128, 16, True, 64),
        (1, 4, 4, 64, 200, 16, True, 8),
        # zamba2_7b's prefill (G = 1, D 112, 32 heads) and granite's (G = 2, D 64)
        (4, 32, 32, 512, 512, 112, True, 128),
        (4, 16, 8, 512, 512, 64, True, 128),
        # the models' route, no blocks, at lengths 128 does not divide: the
        # ragged last tiles.  Whisper's encoder and cross-attention (1,500
        # frames, full), a causal square shape, and causal Lq < Lk, whose
        # q_offset (200) falls inside a key tile
        (4, 20, 20, 1500, 1500, 64, False, None),
        (4, 20, 20, 128, 1500, 64, False, None),
        (2, 16, 8, 200, 200, 128, True, None),
        (1, 8, 8, 100, 300, 64, True, None),
    ]
    checks = []
    for dtype in ("float32", "bfloat16"):
        for B, H, Hk, Lq, Lk, D, causal, blk in cases:
            q = _randn(gen, (B, H, Lq, D), dtype)
            k, v = _randn(gen, (B, Hk, Lk, D), dtype), _randn(gen, (B, Hk, Lk, D), dtype)
            got = ops.flash_attention(q, k, v, causal, blk, blk)
            ok, err = _close(got, ref.mha_reference(q, k, v, causal=causal), dtype)
            checks.append(dict(shape=[B, H, Hk, Lq, Lk, D], causal=causal, dtype=dtype,
                               blocks=blk, within_tol=ok, max_abs_err=err))
            log(f"  flash {dtype:8s} B={B} H={H} Hk={Hk} Lq={Lq} Lk={Lk} D={D} "
                f"causal={causal} blocks={blk}: max_abs_err={err:.3g} ok={ok}")
            if not ok:
                raise AssertionError("flash_attention kernel disagrees with its plain version")

    rows = [time_flash(gen, *shape) for shape in ((4, 16, 8, 512, 128),  # the serve shape
                                                  (4, 64, 8, 512, 112),  # kimi's heads
                                                  (4, 32, 32, 512, 112),  # zamba2_7b's
                                                  (4, 16, 8, 512, 64))]  # granite's
    row = rows[0]
    row["d112"], row["zamba"], row["granite"] = rows[1:]
    # Whisper's encoder (1,500 frames) and cross-attention (128 prompt
    # tokens over them), and internvl2_2b's patch prefill (256 + 512)
    row["whisper_enc"] = time_flash(gen, 4, 20, 20, 1500, 64, causal=False)
    row["whisper_cross"] = time_flash(gen, 4, 20, 20, 128, 64, Lk=1500, causal=False)
    row["internvl"] = time_flash(gen, 4, 16, 8, 768, 128)
    # what the ragged last tiles cost: the encoder's shape beside the next
    # length the 64-row tiles divide (1,536), per pair of (query, key) kept
    aligned = time_flash(gen, 4, 20, 20, 1536, 64, causal=False)
    per_pair = (row["whisper_enc"]["ms"] / row["whisper_enc"]["flops"]) / (
        aligned["ms"] / aligned["flops"])
    row["ragged"] = dict(aligned_ms=aligned["ms"], ragged_ms=row["whisper_enc"]["ms"],
                         time_per_pair_ratio=per_pair)
    log(f"  ragged tiles: L 1,500 {row['whisper_enc']['ms']:.4f} ms against L 1,536 "
        f"{aligned['ms']:.4f} ms; time per (query, key) pair kept {per_pair:.4f}x the "
        f"aligned length's (1,536^2 / 1,500^2 = {1536 ** 2 / 1500 ** 2:.4f}x if each ragged "
        f"tile cost a whole one)")
    row["train_backward"] = backward_vs_plain(
        "flash_attention", ("q", "k", "v"),
        lambda: [_randn(gen, shape, "float32") for shape in (
            (8, 16, 512, 128), (8, 8, 512, 128), (8, 8, 512, 128))],
        lambda q, k, v: ops.flash_attention(q, k, v, True),
        lambda q, k, v: ref.mha_reference(q, k, v, causal=True), ops.flash_attention,
        TOL["float32"], ("flash_fwd",),
        what="Qwen3-0.6B's training shape B=8 H=16 Hk=8 L=512 D=128 causal f32")
    log(json.dumps({"phase": "flash_vs_plain", "name": "flash_attention", "checks": checks,
                    "serve_shape": row}))
    return checks, row


def backward_vs_plain(name, names, make_inputs, kernel_fn, plain_fn, op, fwd_tol, kernel_names,
                      *, what):
    """A float kernel's ``autograd.Function`` at a training shape against
    plain autograd of its plain version on the same CUDA inputs: the
    forward within ``fwd_tol`` (absolute and relative), one launch, and
    every input's gradient bit for bit (the Function's backward is the
    same recompute; a difference fails, its size printed); then the times
    of the kernel's forward, the Function's backward (the recompute) and
    the plain forward and backward.  The cotangent of the first output is
    standard normal; a second output (``ssd_scan``'s final state) gets
    none, as in training."""
    import torch

    inputs = make_inputs()

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    g = torch.randn_like(first(plain_fn(*inputs)))

    def run(fn):
        xs = [t.clone().requires_grad_() for t in inputs]
        out = first(fn(*xs))
        return out.detach(), torch.autograd.grad(out, xs, g)

    before = op.launches
    out, grads = run(kernel_fn)
    launched = op.launches - before
    want, wgrads = run(plain_fn)
    ok, fwd_err = _close(out, want, "float32", {"float32": fwd_tol})
    diffs = {n: float((a - b).abs().max().item()) for n, a, b in zip(names, grads, wgrads)}
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads, wgrads))
    log(f"  {name} backward at {what}: forward max_abs_err {fwd_err:.3g} (tolerance {fwd_tol}), "
        f"{launched} launch; gradients vs plain autograd, largest |difference| "
        + ", ".join(f"d{n} {d:.3g}" for n, d in diffs.items())
        + f" (bit-equal: {bit_equal})")
    if not ok or launched != 1 or not bit_equal:
        raise AssertionError(f"{name}: the autograd.Function disagrees with plain autograd")
    xs = [t.clone().requires_grad_() for t in inputs]
    out = first(kernel_fn(*xs))
    backward_ms = time_cuda(lambda: torch.autograd.grad(out, xs, g, retain_graph=True), 5)
    forward_ms = kernel_device_ms([lambda: kernel_fn(*inputs)], 10, *kernel_names)
    px = [t.clone().requires_grad_() for t in inputs]
    pout = first(plain_fn(*px))
    plain_backward_ms = time_cuda(lambda: torch.autograd.grad(pout, px, g, retain_graph=True), 5)
    plain_forward_ms = time_cuda(lambda: plain_fn(*inputs), 5)
    row = dict(route="recompute: plain autograd of the plain version (no backward kernel, as in "
                     "the JAX package)", timed_on=what, forward_max_abs_err=fwd_err,
               grad_max_abs_diff=max(diffs.values()), grad_max_abs_diff_by_input=diffs,
               bit_equal=bit_equal, forward_ms=forward_ms, backward_recompute_ms=backward_ms,
               plain_forward_ms=plain_forward_ms, plain_backward_ms=plain_backward_ms)
    log(f"  {name} at {what}: forward kernel {forward_ms} ms (profiler), the Function's backward "
        f"(the recompute) {backward_ms:.4f} ms, plain forward {plain_forward_ms:.4f} ms, plain "
        f"backward {plain_backward_ms:.4f} ms")
    return row


def paged_inputs(gen, B, H, Hk, D, page, lengths, dtype):
    """Queries, pools and a page table whose pages are distinct, as an
    allocator hands them out (shuffled), and padded with page 0 (the trash
    page, never handed out)."""
    import torch

    P = max(-(-n // page) for n in lengths)
    N = sum(-(-n // page) for n in lengths) + 1
    q = _randn(gen, (B, H, D), dtype)
    kp, vp = _randn(gen, (N, page, Hk, D), dtype), _randn(gen, (N, page, Hk, D), dtype)
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lengths):
        m = -(-n // page)
        pt[b, :m] = perm[used:used + m].int()
        used += m
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln


def paged_work(H, Hk, D, lengths, B, P, elem_bytes=4):
    """(FLOPs, bytes): 4*D per (head, valid token); the valid tokens' K and
    V once, q and o once, the page table and lengths once."""
    toks = sum(lengths)
    flops = 4 * D * H * toks
    nbytes = (2 * toks * Hk * D + 2 * B * H * D) * elem_bytes + (B * P + B) * 4
    return flops, nbytes


def time_paged(gen, B, H, Hk, D, page=16, lengths=(528, 523, 517, 512)):
    """Kernel and plain version at one decode step's shape, f32, every call
    reading its pages from HBM; with the split plan (S splits per sequence
    and KV head, the blocks launched) and the merge kernel's share of the
    call where the kernel splits."""
    from repro_torch.kernels.paged_attention import kernel, ops, ref

    lengths = list(lengths)
    q, kp, vp, pt, ln = paged_inputs(gen, B, H, Hk, D, page, lengths, "float32")
    got = ops.paged_attention(q, kp, vp, pt, ln)
    ok, err = _close(got, ref.paged_attention_reference(q, kp, vp, pt, ln), "float32")
    log(f"  paged B={B} H={H} Hk={Hk} D={D}, lengths {lengths}: max_abs_err={err:.3g} ok={ok}")
    if not ok:
        raise AssertionError("paged_attention kernel disagrees with its plain version")
    # a decode step reads each layer's pages once: time over copies of the
    # pools that together exceed the L2 (8, or 2 where one pool does) so
    # that every call reads from HBM
    copies = 2 if kp.numel() * kp.element_size() > 50e6 else 8
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(copies - 1)]
    launches = [lambda k=k, v=v: ops.paged_attention(q, k, v, pt, ln) for k, v in pools]
    events_ms = time_cuda_rotating(launches, 20)
    device_ms = kernel_device_ms(launches, 10, "paged_decode")
    merge_ms = kernel_device_ms(launches, 10, "paged_decode_merge")
    ms = events_ms if device_ms is None else device_ms
    warm_ms = kernel_device_ms([lambda: ops.paged_attention(q, kp, vp, pt, ln)], 80,
                               "paged_decode")
    plain_ms = time_cuda_rotating(
        [lambda k=k, v=v: ref.paged_attention_reference(q, k, v, pt, ln) for k, v in pools], 2)
    del pools
    plan = getattr(kernel, "launch_plan", None)  # None for a source without a split plan
    S = plan(q.device, B, H, Hk, D, pt.shape[1], q.dtype) if plan else None
    flops, nbytes = paged_work(H, Hk, D, lengths, B, pt.shape[1])
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(shape=[B, H, Hk, D, page], lengths=lengths, dtype="float32", max_abs_err=err,
               ms=ms, ms_source="events" if device_ms is None else "profiler",
               ms_events=events_ms, ms_l2_warm=warm_ms, plain_ms=plain_ms, flops=flops,
               bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by, splits=S,
               blocks=None if S is None else Hk * B * S + (Hk * B if S > 1 else 0),
               merge_ms=merge_ms,
               merge_share=None if merge_ms is None or device_ms is None else merge_ms / device_ms)
    log(f"  paged B={B} H={H} Hk={Hk} D={D}: kernel {ms:.4f} ms from HBM ({row['ms_source']}; "
        f"{warm_ms} ms with the pools in L2; CUDA events over the rotation {events_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB), {nbytes / ms / 1e6:.1f} GB/s; S={S}, blocks {row['blocks']}, "
        f"merge {merge_ms} ms")
    return row


def phase_paged(seed):
    import torch

    from repro_torch.kernels.paged_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = [(2, 4, 2, 64, 16, 4, 32), (1, 8, 8, 32, 8, 8, 64), (3, 4, 1, 64, 16, 3, 16),
             # head dims 112 (kimi: G = 8; zamba2: G = 1) and 16
             (2, 64, 8, 112, 16, 9, 40), (2, 32, 32, 112, 16, 5, 12),
             (3, 4, 2, 16, 16, 9, 40), (2, 8, 1, 16, 8, 6, 20),
             # G = 3 and 6; one sequence over 512 page slots (many splits)
             (2, 6, 2, 64, 16, 9, 40), (2, 48, 8, 112, 16, 9, 40),
             (1, 16, 8, 128, 16, 512, 520),
             # page 8 with lengths on split boundaries; a length 0 among long ones
             (4, 8, 2, 64, 8, 12, 60, (8, 16, 40, 96)),
             (4, 16, 8, 128, 16, 64, 300, (1024, 0, 1000, 517))]
    checks = []
    for dtype in ("float32", "bfloat16"):
        for case in cases:
            B, H, Hk, D, page, P, N = case[:7]
            q = _randn(gen, (B, H, D), dtype)
            kp, vp = _randn(gen, (N, page, Hk, D), dtype), _randn(gen, (N, page, Hk, D), dtype)
            pt = torch.randint(0, N, (B, P), generator=gen, device="cuda", dtype=torch.int32)
            if len(case) > 7:
                ln = torch.tensor(case[7], device="cuda", dtype=torch.int32)
            else:
                ln = torch.randint(1, P * page + 1, (B,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            got = ops.paged_attention(q, kp, vp, pt, ln)
            live = ln > 0  # length 0: the kernel gives 0, the plain version NaN
            ok, err = _close(got[live], ref.paged_attention_reference(q, kp, vp, pt, ln)[live],
                             dtype)
            ok = ok and bool((got[~live] == 0).all().item())
            checks.append(dict(shape=[B, H, Hk, D, page, P, N], dtype=dtype, within_tol=ok,
                               max_abs_err=err, lengths=list(case[7]) if len(case) > 7 else None))
            log(f"  paged {dtype:8s} B={B} H={H} Hk={Hk} D={D} page={page} P={P} N={N}"
                f"{' lengths ' + str(list(case[7])) if len(case) > 7 else ''}: "
                f"max_abs_err={err:.3g} ok={ok}")
            if not ok:
                raise AssertionError("paged_attention kernel disagrees with its plain version")

    # one decode step of 4 sequences of 512-528 tokens at Qwen3-0.6B's widths,
    # then at kimi's heads (64 of 112, G = 8), then one sequence of 8,192
    # tokens at Qwen3-0.6B's widths
    row = time_paged(gen, 4, 16, 8, 128)
    row["d112"] = time_paged(gen, 4, 64, 8, 112)
    row["long"] = time_paged(gen, 1, 16, 8, 128, lengths=(8192,))
    log(json.dumps({"phase": "paged_vs_plain", "name": "paged_attention", "checks": checks,
                    "qwen_widths": row}))
    return checks, row


# ------------------------------- ssd_scan -----------------------------------


def phase_ssd(seed):
    import torch

    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    from repro_torch.kernels.work import ssd_work

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def inputs(Bt, L, H, dh, N, dtype):
        """The distributions of tests/test_kernels.py's ssd test."""
        x = _randn(gen, (Bt, L, H, dh), "float32") * 0.5
        dt = torch.rand((Bt, L, H), generator=gen, device="cuda") * 0.19 + 0.01
        A = -(torch.rand((H,), generator=gen, device="cuda") * 0.9 + 0.1)
        B, C = (_randn(gen, (Bt, L, N), "float32") * 0.5 for _ in range(2))
        return x.to(getattr(torch, dtype)), dt, A, B, C

    def check(case, dtype):
        *shape, chunk = case
        args = inputs(*shape, dtype)
        y, S = ops.ssd_scan(*args, chunk=chunk)
        wy, wS = ref.ssd_chunked_batched(*args, chunk=chunk)
        ok_y, err_y = _close(y, wy, dtype, SSD_TOL)
        ok_s, err_s = _close(S, wS, dtype, SSD_TOL)
        log(f"  ssd {dtype:8s} B={shape[0]} L={shape[1]} H={shape[2]} dh={shape[3]} "
            f"N={shape[4]} chunk={chunk}: max_abs_err y {err_y:.3g} S {err_s:.3g} "
            f"ok={ok_y and ok_s}")
        if not (ok_y and ok_s and y.dtype == args[0].dtype):
            raise AssertionError("ssd_scan kernel disagrees with its plain version")
        return args, dict(shape=shape, chunk=chunk, dtype=dtype, within_tol=True,
                          max_abs_err=max(err_y, err_s))

    cases = [  # B, L, H, dh, N, chunk: tests/test_kernels.py:187-188, then the
        # reduced mamba2_780m (chunk = prompt length, or 128 past it)
        (2, 256, 3, 32, 16, 32), (2, 256, 3, 32, 16, 64),
        (1, 128, 2, 64, 64, 32), (1, 128, 2, 64, 64, 64),
        (4, 5, 8, 16, 16, 5), (4, 100, 8, 16, 16, 100), (4, 256, 8, 16, 16, 128),
    ]
    serve_case = (4, 512, 48, 64, 128, 128)  # mamba2_780m's prefill
    zamba_case = (4, 512, 112, 64, 64, 128)  # zamba2_7b's: 112 heads, N 64
    checks = [check(c, dtype)[1] for dtype in ("float32", "bfloat16") for c in cases]
    checks += [check(c, "bfloat16")[1] for c in (serve_case, zamba_case)]

    def timed(case):
        """One prefill call's scan in one layer at ``case``, checked (f32)
        then timed: kernel, plain version, bound."""
        args, row = check(case, "float32")
        checks.append(dict(row))
        chunk = case[-1]
        events_ms = time_cuda(lambda: ops.ssd_scan(*args, chunk=chunk), 50)
        call = [lambda: ops.ssd_scan(*args, chunk=chunk)]
        device_ms = kernel_device_ms(call, 20, *SSD_KERNELS)
        ms = events_ms if device_ms is None else device_ms
        per_kernel = {name: kernel_device_ms(call, 20, name) for name in SSD_KERNELS}
        plain_ms = time_cuda(lambda: ref.ssd_chunked_batched(*args, chunk=chunk), 10)
        flops, nbytes = ssd_work(*case)
        bound_ms, bound_by = tensor_core_bound(flops, nbytes)
        Bt, L, H, dh, N, Q = case
        nc = L // Q
        full_square = 2 * Bt * nc * Q * Q * N + 2 * Bt * H * nc * (Q * Q * dh + 2 * Q * N * dh)
        per_head = 2 * Bt * H * nc * (Q * Q * N + Q * Q * dh + 2 * Q * N * dh)
        row.update(ms=ms, ms_source="events" if device_ms is None else "profiler",
                   ms_events=events_ms, ms_per_kernel=per_kernel,
                   heads_per_block=kernel.default_heads_per_block(Bt, L, H, Q),
                   plain_ms=plain_ms, flops=flops, bytes=nbytes,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_ms_f32_fma=bound(flops, nbytes)[0],
                   flops_full_square=full_square, flops_per_head_tpu=per_head,
                   bound_ms_full_square=TF32X3 * full_square / TF32_FLOP_PER_S * 1e3,
                   bound_ms_per_head_tpu=TF32X3 * per_head / TF32_FLOP_PER_S * 1e3)
        log(f"  ssd B={Bt} L={L} H={H} dh={dh} N={N} chunk={Q}: {len(SSD_KERNELS)} kernels "
            f"per call, {ms:.4f} ms ({row['ms_source']}; by kernel {per_kernel}; CUDA events "
            f"over 50 calls {events_ms:.4f} ms; {row['heads_per_block']} heads per block), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, 3xTF32 on the tensor "
            f"cores: {flops / 1e9:.3f} GFLOP over the causal half, {nbytes / 1e6:.1f} MB; at the "
            f"f32 FMA rate {row['bound_ms_f32_fma']:.5f} ms; {full_square / 1e9:.3f} "
            f"GFLOP full-square, {per_head / 1e9:.3f} per head as the TPU kernel counts), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        return row

    row = timed(serve_case)
    row["zamba"] = timed(zamba_case)
    # Mamba2-780M's training shape; the inputs as the model gives them
    # (dt and A through the softplus and -exp are leaves here)
    row["train_backward"] = backward_vs_plain(
        "ssd_scan", ("x", "dt", "A", "B", "C"),
        lambda: list(inputs(8, 512, 48, 64, 128, "float32")),
        lambda *a: ops.ssd_scan(*a, chunk=128), lambda *a: ref.ssd_chunked_batched(*a, chunk=128),
        ops.ssd_scan, SSD_TOL["float32"], SSD_KERNELS,
        what="Mamba2-780M's training shape B=8 L=512 H=48 dh=64 N=128 chunk=128 f32")
    log(json.dumps({"phase": "ssd_vs_plain", "name": "ssd_scan", "checks": checks,
                    "serve_shape": row}))
    return checks, row


def phase_ssm_serve():
    """The mamba2_780m serve path through the user's entry point, then the
    plain route."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    layers = get_config("mamba2_780m").n_layers
    row, params = serve_and_compare(SSM_SERVE_ARGS, [(ssd_ops.ssd_scan, layers)],
                                    ("ssm_backend",))
    row["ssd_launches"] = row["launches"]["ssd_scan"]
    del params
    log(json.dumps({"phase": "ssm_serve", **row}))
    return row


# ------------------------------ LM serving ----------------------------------


def phase_serve():
    """The qwen3_0_6b serve path through the user's entry point, then the
    plain route."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops

    layers = get_config("qwen3_0_6b").n_layers
    row, params = serve_and_compare(SERVE_ARGS, [(flash_ops.flash_attention, layers)],
                                    ("attn_backend",))
    row["flash_launches"] = row["launches"]["flash_attention"]
    log(json.dumps({"phase": "serve", **row}))
    return row, params


def logits_within_tol(kmodel, pmodel, params, toks):
    """The default gate of ``serve_and_compare``: the kernel route's and the
    plain route's prefill logits on the same prompts within LOGIT_TOL."""
    import torch

    with torch.no_grad():
        lk, _ = kmodel.prefill(params, {"tokens": toks}, toks.shape[1])
        lp, _ = pmodel.prefill(params, {"tokens": toks}, toks.shape[1])
        err = float((lk - lp).abs().max().item())
        top = float(lp.abs().max().item())
    log(f"  prefill logits kernel vs plain: max_abs_err={err:.3g}, largest |logit| {top:.3g} "
        f"(tolerance {LOGIT_TOL})")
    if err > LOGIT_TOL:
        raise AssertionError("serve: kernel and plain prefill logits disagree")
    return dict(prefill_logit_max_abs_err=err, prefill_logit_max_abs=top,
                prefill_logit_tol=LOGIT_TOL)


def serve_and_compare(serve_args, kernels, backend_fields, compare=logits_within_tol):
    """``serve.main(serve_args)`` with each kernel's ``launches`` counted
    around it (``kernels``: (op, launches per prefill call)), then the same
    requests on the plain route (every field of ``backend_fields`` set to
    "chunked") with the same weights: ``compare`` on the first four prompts, tokens compared, and a warm
    breakdown of the kernel route.  Returns (row, params)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.batching import ContinuousBatcher

    cfg = get_config(serve_args[serve_args.index("--arch") + 1])
    prompt_len = int(serve_args[serve_args.index("--prompt-len") + 1])
    max_new = int(serve_args[serve_args.index("--max-new") + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for op, _ in kernels:
        op.launches = 0
    m, reqs = serve.main(serve_args)
    torch.cuda.synchronize()
    launches = {op.__name__: op.launches for op, _ in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(r.finished_step >= 0 for r in reqs):
        raise AssertionError("serve: requests left unfinished")
    for op, per_call in kernels:
        if m.prefill_calls == 0 or op.launches != per_call * m.prefill_calls:
            raise AssertionError(f"serve: {op.__name__} launched {op.launches} times for "
                                 f"{m.prefill_calls} prefill calls, {per_call} a call")
    row = dict(arch=cfg.arch_id, requests=len(reqs), steps=m.steps, tokens_out=m.tokens_out,
               wall_s=m.wall_s, tokens_per_s=m.tokens_per_s, prefill_calls=m.prefill_calls,
               prefill_ms_per_call=m.prefill_s / m.prefill_calls * 1e3,
               decode_ms_per_step=m.decode_s / m.steps * 1e3, peak_device_gb=peak_gb,
               launches=launches)
    log(f"  serve {cfg.arch_id} (kernel route): {row['tokens_per_s']:.1f} tokens/s, "
        f"prefill {row['prefill_ms_per_call']:.2f} ms/call x {m.prefill_calls}, "
        f"decode {row['decode_ms_per_step']:.2f} ms/step x {m.steps}, wall {m.wall_s:.3f} s, "
        f"peak {peak_gb:.2f} GB, launches {launches}")

    # the plain route on the same weights and prompts
    kmodel = build_model(cfg)
    pmodel = build_model(cfg.replace(**{f: "chunked" for f in backend_fields}))
    params = serve.init_params(kmodel, "cuda")
    preqs = serve.make_requests(cfg, len(reqs), prompt_len, max_new)
    b = ContinuousBatcher(pmodel, max_batch=4, max_len=1024)
    b.model_params = params
    pm = b.serve(preqs)
    toks = torch.from_numpy(np.stack([r.prompt for r in preqs[:4]])).cuda()
    log(f"  serve {cfg.arch_id} (plain route): {pm.tokens_per_s:.1f} tokens/s, prefill "
        f"{pm.prefill_s / pm.prefill_calls * 1e3:.2f} ms/call, decode "
        f"{pm.decode_s / pm.steps * 1e3:.2f} ms/step")
    gate = compare(kmodel, pmodel, params, toks)
    agree = sum(a == c for r, p in zip(reqs, preqs) for a, c in zip(r.output, p.output))
    total = sum(len(r.output) for r in reqs)
    first_diffs = []
    for r, p in zip(reqs, preqs):
        j = next((i for i, (a, c) in enumerate(zip(r.output, p.output)) if a != c), None)
        if j is None:
            continue
        seq = torch.from_numpy(np.concatenate([p.prompt, np.asarray(p.output[:j], np.int32)]))
        with torch.no_grad():
            lg, _ = pmodel.prefill(params, {"tokens": seq[None].cuda()}, len(seq))
        top = lg[0, -1].topk(2).values
        first_diffs.append(dict(req=r.req_id, index=j, margin=float(top[0] - top[1])))
    log(f"  tokens agreeing {agree}/{total}; first differences {first_diffs}")
    row.update(warm_breakdown(kmodel, params, toks))
    row.update(plain_tokens_per_s=pm.tokens_per_s,
               plain_prefill_ms_per_call=pm.prefill_s / pm.prefill_calls * 1e3,
               plain_decode_ms_per_step=pm.decode_s / pm.steps * 1e3,
               tokens_agree=agree, tokens_total=total, first_differences=first_diffs, **gate)
    return row, params


# ------------------------ hybrid and MoE serving ----------------------------


def phase_hybrid_serve():
    """The zamba2_7b serve path through the user's entry point (flash_attention
    once a group, ssd_scan once a layer), then the plain route; the prefill
    logits gate, with each layer's difference between the routes."""
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    routing.reset_executable_caches()  # the captured runners' buffers

    cfg = get_config("zamba2_7b")
    row, params = serve_and_compare(
        HYBRID_SERVE_ARGS, [(flash_ops.flash_attention, cfg.n_layers // cfg.hybrid_attn_every),
                            (ssd_ops.ssd_scan, cfg.n_layers)],
        ("attn_backend", "ssm_backend"), compare=hybrid_compare)
    row["flash_launches"] = row["launches"]["flash_attention"]
    row["ssd_launches"] = row["launches"]["ssd_scan"]
    del params
    log(json.dumps({"phase": "hybrid_serve", **row}))
    return row


def hybrid_compare(kmodel, pmodel, params, toks):
    """Both routes' prefill on the same prompts, the residual stream recorded
    after every mamba layer (with the shared block behind it where a group
    ends): the logits within LOGIT_TOL, and the routes' difference layer by
    layer, each relative to that layer's largest magnitude (how the 94
    blocks grow it)."""
    import torch

    from repro_torch.models import transformer

    real = transformer._ssm_block
    stream = {"kernel": [], "plain": []}

    def spy(key):
        def block(lp, cfg, x, *rest):
            out = real(lp, cfg, x, *rest)
            stream[key].append(out[0])
            return out
        return block

    T = toks.shape[1]
    try:
        with torch.no_grad():
            transformer._ssm_block = spy("kernel")
            lk, _ = kmodel.prefill(params, {"tokens": toks}, T)
            transformer._ssm_block = spy("plain")
            lp, _ = pmodel.prefill(params, {"tokens": toks}, T)
    finally:
        transformer._ssm_block = real
    growth = [float((a - b).abs().max() / b.abs().max())
              for a, b in zip(stream["kernel"], stream["plain"])]
    del stream
    err, top = float((lk - lp).abs().max()), float(lp.abs().max())
    del lk, lp
    every = kmodel.cfg.hybrid_attn_every
    log(f"  prefill logits kernel vs plain: max_abs_err={err:.3g}, largest |logit| {top:.3g} "
        f"(tolerance {LOGIT_TOL}); the residual stream's "
        f"difference / its largest magnitude after layers 1, {every}, 2x{every}, ...: "
        + ", ".join(f"{g:.2e}" for i, g in enumerate(growth)
                    if i == 0 or (i + 1) % every == 0 or i + 1 == len(growth)))
    if err > LOGIT_TOL:
        raise AssertionError("serve: kernel and plain prefill logits disagree")
    return dict(prefill_logit_max_abs_err=err, prefill_logit_max_abs=top,
                prefill_logit_tol=LOGIT_TOL, residual_rel_diff_by_layer=growth)


def phase_moe_serve():
    """The granite_moe_1b_a400m serve path through the user's entry point,
    then the plain route; the routing-aware gate (``moe_compare``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops

    cfg = get_config("granite_moe_1b_a400m")
    row, params = serve_and_compare(MOE_SERVE_ARGS, [(flash_ops.flash_attention, cfg.n_layers)],
                                    ("attn_backend",), compare=moe_compare)
    row["flash_launches"] = row["launches"]["flash_attention"]
    del params
    log(json.dumps({"phase": "moe_serve", **row}))
    return row


def moe_compare(kmodel, pmodel, params, toks):
    """Both routes' prefill of the same prompts with every layer's routing
    recorded (``moe.route``) and, on the kernel route, the q/k/v each
    layer hands ``flash_attention`` with its output.

    Gates: each layer's flash output within TOL of ``mha_reference`` on its
    own inputs; a token whose top-k set differs between the routes (a flip)
    is allowed only at a near-tie, the plain route's k-th and (k+1)-th
    router probabilities within ROUTE_TIE; a flip, or a copy whose drop
    differs, changes that token's layer output, and through causal
    attention every later position of its sequence from the next layer on:
    those tokens are "touched", and the logits of every untouched token are
    within LOGIT_TOL.  Reported: the flips with their margins, the
    capacity and the dropped copies each layer, and the MoE layers' share
    of a warm prefill (CUDA events around each ``moe_apply``)."""
    import torch

    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import attention, moe

    cfg = kmodel.cfg
    B, T = toks.shape
    K, E = cfg.moe_top_k, cfg.n_experts
    C = moe.capacity(cfg, B * T)
    real_route, real_flash = moe.route, attention.flash_attention
    routes = {"kernel": [], "plain": []}
    flash_calls = []

    def spy_route(key):
        def route(p, c, x):
            out = real_route(p, c, x)
            routes[key].append(out)
            return out
        return route

    def spy_flash(q, k, v, *args):
        o = real_flash(q, k, v, *args)
        flash_calls.append((q, k, v, o))
        return o

    try:
        with torch.no_grad():
            moe.route, attention.flash_attention = spy_route("kernel"), spy_flash
            lk, _ = kmodel.prefill(params, {"tokens": toks}, T)
            moe.route, attention.flash_attention = spy_route("plain"), real_flash
            lp, _ = pmodel.prefill(params, {"tokens": toks}, T)
    finally:
        moe.route, attention.flash_attention = real_route, real_flash

    flash_errs = []
    for layer, (q, k, v, o) in enumerate(flash_calls):
        ok, err = _close(o, flash_ref.mha_reference(q, k, v, causal=True), "float32")
        flash_errs.append(err)
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version on layer "
                                 f"{layer}'s prefill inputs (max_abs_err {err:.3g})")
    del flash_calls
    log(f"  flash_attention on each of {len(flash_errs)} layers' prefill q/k/v: max_abs_err "
        f"{max(flash_errs):.3g} (tolerance {TOL['float32']} abs + rel)")

    touched = torch.zeros((B, T), dtype=torch.bool, device=toks.device)
    flips, drops = [], []
    for layer, ((_, _, ek), (pp, _, ep)) in enumerate(zip(routes["kernel"], routes["plain"])):
        flipped = (ek.sort(-1).values != ep.sort(-1).values).any(-1).view(B, T)
        top = pp.topk(K + 1, dim=-1).values
        margin = (top[:, K - 1] - top[:, K]).view(B, T)
        for b, t in (flipped & ~touched).nonzero().tolist():
            flips.append(dict(layer=layer, seq=b, pos=t, margin=float(margin[b, t])))
        kept = []
        for e in (ek, ep):
            fits = (moe.rank_in_expert(e.reshape(-1), E) < C).view(B * T, K)
            kept.append(torch.where(fits, e, -1).sort(-1).values)
        drops.append(int((kept[0] < 0).sum()))
        hit = (flipped | (kept[0] != kept[1]).any(-1).view(B, T))
        first = torch.where(hit.any(-1), hit.float().argmax(-1), T)  # first hit a sequence
        touched |= torch.arange(T, device=toks.device)[None, :] >= first[:, None]
    del routes
    bad = [f for f in flips if f["margin"] > ROUTE_TIE]
    log(f"  routing: capacity C = {C} slots an expert for {B * T} tokens x top-{K}; dropped "
        f"copies a layer {drops} ({sum(drops)} of {B * T * K * len(drops)} in the prefill); "
        f"{len(flips)} flip(s) between the routes, margins "
        f"{[round(f['margin'], 8) for f in flips]} (allowed up to {ROUTE_TIE}): {flips}")
    if bad:
        raise AssertionError(f"moe: a top-k choice differs between the routes away from a "
                             f"near-tie: {bad}")
    keep = ~touched
    n_cmp = int(keep.sum())
    err = float((lk - lp).abs()[keep].max()) if n_cmp else float("nan")
    log(f"  prefill logits kernel vs plain on the {n_cmp} of {B * T} tokens no flip touched: "
        f"max_abs_err={err:.3g} (tolerance {LOGIT_TOL})")
    if n_cmp == 0 or not err <= LOGIT_TOL:
        raise AssertionError("serve: kernel and plain prefill logits disagree")
    del lk, lp
    out = dict(flash_layer_max_abs_err=flash_errs, capacity=C, dropped_copies_by_layer=drops,
               dropped_copies=sum(drops), copies=B * T * K * len(drops), flips=flips,
               tokens_compared=n_cmp, prefill_logit_max_abs_err=err,
               prefill_logit_tol=LOGIT_TOL)
    out.update(moe_share(kmodel, params, toks))
    return out


def moe_share(model, params, toks):
    """The MoE layers' share of a warm prefill: CUDA events around each
    ``moe_apply`` (router, switch, experts and combine) and around the whole
    prefill, on the stream."""
    import torch

    from repro_torch.models import moe

    real = moe.moe_apply
    spans = []

    def timed(*args, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        spans.append((a, b))
        return out

    with torch.no_grad():
        model.prefill(params, {"tokens": toks}, toks.shape[1])  # warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        try:
            moe.moe_apply = timed
            start.record()
            model.prefill(params, {"tokens": toks}, toks.shape[1])
            end.record()
        finally:
            moe.moe_apply = real
    torch.cuda.synchronize()
    moe_ms = sum(a.elapsed_time(b) for a, b in spans)
    total_ms = start.elapsed_time(end)
    log(f"  MoE layers: {moe_ms:.2f} ms of a {total_ms:.2f} ms warm prefill "
        f"({100 * moe_ms / total_ms:.1f}%, CUDA events on the stream, {len(spans)} layers)")
    return dict(moe_ms_in_prefill=moe_ms, prefill_stream_ms=total_ms,
                moe_share_of_prefill=moe_ms / total_ms)


# ------------------------- vlm and encdec serving ---------------------------


def greedy_pair(kmodel, pmodel, params, ck, cp, lk, lp, pos, steps: int):
    """Greedy decoding on both routes in lock step from the prefill's last
    logits ``lk``/``lp`` (B, vocab) and caches ``ck``/``cp``: the
    prefill's token, then ``steps`` decode steps' from positions ``pos``.
    While a sequence's tokens agree, so do its inputs, and its logits are
    compared; at its first difference the plain route's top-2 margin must
    lie within TOKEN_TIE (else AssertionError), and after it the two
    routes decode different text and are no longer compared.  Returns the
    report and the kernel route's decode ms a step (host clock around each
    step, which ends in the argmax's read)."""
    import torch

    B = lk.shape[0]
    first, agree, logit_err, ms = {}, 0, 0.0, []
    pos = pos.clone()
    cur_k, cur_p = lk.argmax(-1).int(), lp.argmax(-1).int()
    for i in range(steps + 1):
        if i:
            t0 = time.perf_counter()
            lk, ck = kmodel.decode_step(params, ck, cur_k, pos)
            cur_k = lk.argmax(-1).int()
            cur_k.cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
            lp, cp = pmodel.decode_step(params, cp, cur_p, pos)
            cur_p = lp.argmax(-1).int()
            pos += 1
        live = [b for b in range(B) if b not in first]
        if not live:
            continue
        logit_err = max(logit_err, float((lk[live] - lp[live]).abs().max()))
        same = (cur_k == cur_p).cpu()
        top = lp.float().topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).cpu()
        for b in live:
            if same[b]:
                agree += 1
            else:
                first[b] = dict(seq=b, index=i, margin=float(margin[b]))
    report = dict(tokens_agree=agree, tokens_compared=agree + len(first),
                  tokens_total=B * (steps + 1), first_differences=list(first.values()),
                  decode_logit_max_abs_err=logit_err, token_tie=TOKEN_TIE)
    log(f"  greedy tokens, kernel vs plain route: {agree} of {agree + len(first)} compared "
        f"agree ({B} x {steps + 1}, each sequence up to its first difference); first "
        f"differences {report['first_differences']} (plain top-2 margin allowed up to "
        f"{TOKEN_TIE}); logits while the tokens agree max_abs_err={logit_err:.3g} "
        f"(tolerance {LOGIT_TOL})")
    bad = [f for f in first.values() if f["margin"] > TOKEN_TIE]
    if bad:
        raise AssertionError(f"greedy tokens differ between the routes where the plain "
                             f"route's margin exceeds {TOKEN_TIE}: {bad}")
    if logit_err > LOGIT_TOL:
        raise AssertionError(f"decode logits differ between the routes by {logit_err:.3g} "
                             f"while their tokens agree")
    return report, ms


def _timed_prefill(model, params, batch, max_len):
    """(logits, cache, ms): one prefill call by the host clock around work
    that ends in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    return logits, cache, (time.perf_counter() - t0) * 1e3


def phase_vlm_serve(seed):
    """internvl2_2b through the user's entry point (``serve_and_compare``:
    the batcher's prompts are tokens, so the dense backbone with no patch
    prefix), then the entry point that carries the patches:
    ``build_model(cfg).prefill`` on 4 prompts of 512 tokens behind 256
    seeded patch embeddings each (T = 768), kernel against plain logits
    over every row, then 16 greedy decode steps from position 768 on both
    routes, tokens compared."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("internvl2_2b")
    flash = flash_ops.flash_attention
    row, params = serve_and_compare(VLM_SERVE_ARGS, [(flash, cfg.n_layers)], ("attn_backend",))
    row["flash_launches"] = row["launches"]["flash_attention"]

    kmodel, pmodel = build_model(cfg), build_model(cfg.replace(attn_backend="chunked"))
    reqs = serve.make_requests(cfg, 4, VLM_PROMPT, VLM_NEW)
    toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    patches = torch.randn((4, cfg.n_patches, cfg.d_model), generator=gen, device="cuda")
    batch = {"tokens": toks, "patches": patches}
    T = cfg.n_patches + VLM_PROMPT
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        flash.launches = 0
        lk, ck, first_ms = _timed_prefill(kmodel, params, batch, VLM_MAX_LEN)
        launches = flash.launches
        lp, cp, plain_ms = _timed_prefill(pmodel, params, batch, VLM_MAX_LEN)
        if tuple(lk.shape) != (4, T, cfg.vocab) or ck["k"].shape[2] != max(VLM_MAX_LEN, T):
            raise AssertionError(f"vlm: patch prefill logits {tuple(lk.shape)}, cache "
                                 f"{tuple(ck['k'].shape)}")
        err, top = float((lk - lp).abs().max()), float(lp.abs().max())
        cache_err = {key: float((ck[key] - cp[key]).abs().max()) for key in ("k", "v")}
        finite = bool(torch.isfinite(lk).all())
        lk_last, lp_last = lk[:, -1].clone(), lp[:, -1].clone()
        del lk, lp
    log(f"  patch prefill ({cfg.n_patches} patches + {VLM_PROMPT} tokens, T = {T}): "
        f"{launches} flash launches (want {cfg.n_layers}); logits over all {T} rows kernel vs "
        f"plain max_abs_err={err:.3g}, largest |logit| {top:.3g}, cache k {cache_err['k']:.3g} "
        f"v {cache_err['v']:.3g} (tolerance {LOGIT_TOL})")
    if launches != cfg.n_layers:
        raise AssertionError(f"vlm: flash_attention launched {launches} times in the patch "
                             f"prefill, {cfg.n_layers} wanted")
    if not finite or max(err, *cache_err.values()) > LOGIT_TOL:
        raise AssertionError(f"vlm: kernel and plain patch prefill disagree: logits {err}, "
                             f"cache {cache_err}")
    with torch.no_grad():
        pos = torch.full((4,), T, dtype=torch.int32, device="cuda")
        tokens, k_ms = greedy_pair(kmodel, pmodel, params, ck, cp, lk_last, lp_last, pos,
                                   VLM_NEW)
        del ck, cp
        _, _, warm_ms = _timed_prefill(kmodel, params, batch, VLM_MAX_LEN)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  patch prefill: first call {first_ms:.2f} ms, warm {warm_ms:.2f} ms (plain "
        f"{plain_ms:.2f} ms); decode {float(np.median(k_ms)):.2f} ms a step (median of "
        f"{VLM_NEW}); peak {peak_gb:.2f} GB")
    row["patch_prefill"] = dict(
        patches=cfg.n_patches, prompt=VLM_PROMPT, T=T, max_len=VLM_MAX_LEN,
        flash_launches=launches, logit_max_abs_err=err, logit_max_abs=top,
        cache_max_abs_err=cache_err, logit_tol=LOGIT_TOL, first_ms=first_ms,
        warm_ms=warm_ms, plain_ms=plain_ms, decode_ms=k_ms, peak_device_gb=peak_gb,
        **tokens)
    row["flash_launches"] += launches
    del params
    log(json.dumps({"phase": "vlm_serve", **row}))
    return row


def phase_whisper_serve(seed):
    """whisper_large_v3 at full width: ``build_model(cfg).prefill`` on 4
    prompts of 128 tokens and 4 clips of 1,500 seeded frame embeddings,
    max_len 448 (one flash_attention launch a layer of the encoder, and two
    a decoder layer: causal self-attention and the cross-attention over
    the frames); the encoder's output, the prefill logits and every cache
    tensor against the plain route; 16 greedy decode steps on both routes;
    the warm breakdown; then ``serve.main`` in token mode (the batcher's,
    as in the reference: no prefill call, no kernel launch)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models import whisper
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("whisper_large_v3")
    flash = flash_ops.flash_attention
    per_call = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    kmodel, pmodel = build_model(cfg), build_model(cfg.replace(attn_backend="chunked"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = serve.init_params(kmodel, "cuda")
    reqs = serve.make_requests(cfg, 4, WHISPER_PROMPT, WHISPER_NEW)
    toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randn((4, cfg.n_audio_frames, cfg.d_model), generator=gen, device="cuda")
    batch = {"tokens": toks, "frames": frames}
    with torch.no_grad():
        flash.launches = 0
        lk, ck, first_ms = _timed_prefill(kmodel, params, batch, WHISPER_MAX_LEN)
        launches = flash.launches
        lp, cp, plain_ms = _timed_prefill(pmodel, params, batch, WHISPER_MAX_LEN)
        errs = {"enc_out": float((whisper.encode(params, kmodel.cfg, frames)
                                  - whisper.encode(params, pmodel.cfg, frames)).abs().max()),
                "logits": float((lk - lp).abs().max())}
        errs.update({key: float((ck[key] - cp[key]).abs().max()) for key in ck})
        top = float(lp.abs().max())
        finite = bool(torch.isfinite(lk).all())
        shapes = {key: tuple(t.shape) for key, t in ck.items()}
        lk_last, lp_last = lk[:, -1].clone(), lp[:, -1].clone()
        del lk, lp
    want = {"k": WHISPER_MAX_LEN, "v": WHISPER_MAX_LEN, "xk": cfg.n_audio_frames,
            "xv": cfg.n_audio_frames}
    log(f"  prefill (4 x {WHISPER_PROMPT} tokens, 4 x {cfg.n_audio_frames} frames, max_len "
        f"{WHISPER_MAX_LEN}): {launches} flash launches (want {per_call}); kernel vs plain "
        f"max_abs_err {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; largest |logit| "
        f"{top:.3g} (tolerance {LOGIT_TOL}); first call {first_ms:.2f} ms (plain "
        f"{plain_ms:.2f} ms); cache {shapes}")
    if launches != per_call:
        raise AssertionError(f"whisper: flash_attention launched {launches} times in a "
                             f"prefill call, {per_call} wanted")
    if any(shapes[k][2] != n for k, n in want.items()):
        raise AssertionError(f"whisper: cache shapes {shapes}")
    if not finite or max(errs.values()) > LOGIT_TOL:
        raise AssertionError(f"whisper: kernel and plain prefill disagree: {errs}")
    with torch.no_grad():
        pos = torch.full((4,), WHISPER_PROMPT, dtype=torch.int32, device="cuda")
        tokens, k_ms = greedy_pair(kmodel, pmodel, params, ck, cp, lk_last, lp_last, pos,
                                   WHISPER_NEW)
        del ck, cp
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  decode {float(np.median(k_ms)):.2f} ms a step (median of {WHISPER_NEW}); peak "
        f"{peak_gb:.2f} GB")
    row = dict(arch=cfg.arch_id, prompts=4, prompt_len=WHISPER_PROMPT,
               frames=cfg.n_audio_frames, max_len=WHISPER_MAX_LEN, flash_launches=launches,
               flash_launches_per_prefill=per_call, max_abs_err=errs, logit_max_abs=top,
               logit_tol=LOGIT_TOL, first_prefill_ms=first_ms, plain_prefill_ms=plain_ms,
               decode_ms=k_ms, peak_device_gb=peak_gb, **tokens)
    row.update(warm_breakdown(kmodel, params, toks, batch=batch, max_len=WHISPER_MAX_LEN))
    del params
    torch.cuda.empty_cache()

    flash.launches = 0
    m, sreqs = serve.main(WHISPER_SERVE_ARGS)
    torch.cuda.synchronize()
    if not all(r.finished_step >= 0 for r in sreqs):
        raise AssertionError("whisper: served requests left unfinished")
    if m.prefill_calls or flash.launches:
        raise AssertionError(f"whisper: token mode made {m.prefill_calls} prefill calls and "
                             f"{flash.launches} flash launches")
    # a functional check of the batcher's token mode at a toy size (4
    # requests of 8 tokens, 8 new), not a serving rate
    row["serve_check"] = dict(requests=len(sreqs), finished=len(sreqs), steps=m.steps,
                              tokens_out=m.tokens_out, prefill_calls=m.prefill_calls,
                              flash_launches=flash.launches)
    log(f"  serve.main in token mode ({len(sreqs)} requests of 8 tokens, 8 new; a functional "
        f"check, not a rate): every request finished in {m.steps} steps, {m.tokens_out} "
        f"tokens out, no prefill call, no flash launch")
    log(json.dumps({"phase": "whisper_serve", **row}))
    return row


def _device_ms(prof, events=None):
    """(kernel ms summed over the profiled window, the top 6 kernels by
    time); (None, []) when the profiler saw no kernel.  Only the kernels'
    own events count: an operator's device time is its kernels' again, and
    a ``record_function`` span's device range (``routing.*``) spans them.
    ``events``: the window's ``key_averages()``, where already read."""
    from torch.autograd import DeviceType

    events = prof.key_averages() if events is None else events
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("routing.")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        return None, []
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return total, [dict(kernel=e.key[:120], device_ms=e.self_device_time_total / 1e3,
                        calls=e.count) for e in top]


def _lm_layers(cfg):
    """(attention layers, SSD layers, SSD heads, state N, head dim) of a
    decoder LM."""
    n_ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.hybrid_attn_every, 1)}.get(
        cfg.family, cfg.n_layers)
    return n_attn, n_ssm, 2 * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim


def lm_flops(cfg, B, T):
    """(matmul FLOPs, attention and SSD FLOPs) of a decoder LM's forward
    over B prompts of T (a token's routed experts only, in a moe; the
    shared block once a group, in a hybrid; the embedding is a gather)."""
    from repro_torch.kernels.work import flash_work, ssd_work

    token_params = cfg.active_param_count() - cfg.vocab * cfg.d_model
    n_attn, n_ssm, H, N, dh = _lm_layers(cfg)
    if cfg.family == "hybrid":
        D, hd = cfg.d_model, cfg.hd
        shared = D * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * D \
            + 3 * D * cfg.d_ff
        token_params += (n_attn - 1) * shared
    mix_flops = n_attn * flash_work(B, cfg.n_heads, cfg.n_kv_heads, T, T, cfg.hd, True)[0]
    if n_ssm:
        mix_flops += n_ssm * ssd_work(B, T, H, dh, N, min(cfg.ssm_chunk, T))[0]
    return 2 * B * T * token_params, mix_flops


def lm_work(cfg, B, T):
    """(prefill FLOPs, decode-step bytes) of a decoder LM on B prompts of T:
    the prefill's ``lm_flops``; a decode step's weights (every expert) and
    live cache (K/V, and the recurrent state read and written) once, in
    f32.  Their least times are these at the f32 peak and at the HBM
    rate."""
    weight_params = cfg.param_count() - cfg.vocab * cfg.d_model
    n_attn, n_ssm, H, N, dh = _lm_layers(cfg)
    cache_bytes = 2 * n_attn * B * (T + 4) * cfg.n_kv_heads * cfg.hd
    if n_ssm:
        cache_bytes += 2 * n_ssm * B * H * N * dh
    return sum(lm_flops(cfg, B, T)), 4 * (weight_params + cache_bytes)


def whisper_work(cfg, B, T):
    """(prefill FLOPs, decode-step bytes) of Whisper on B prompts of T
    tokens and ``n_audio_frames`` frames each: the encoder over the frames
    (projections, full attention, MLP), the decoder over the prompt (self
    and cross projections, the cross K/V over the frames, causal and cross
    attention, MLP) and the tied logits; a decode step's decoder weights
    but the cross K/V projections (the cache holds them), the embedding
    (the tied logits read it whole) and the self and cross caches once, in
    f32.  Biases and norms left out."""
    from repro_torch.kernels.work import flash_work

    D, F, hd = cfg.d_model, cfg.n_audio_frames, cfg.hd
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    q_o, k_v, mlp = 2 * D * H * hd, 2 * D * Hk * hd, 2 * D * cfg.d_ff
    enc = 2 * B * F * (q_o + k_v + mlp) + flash_work(B, H, Hk, F, F, hd, False)[0]
    dec = (2 * B * T * (2 * q_o + k_v + mlp) + 2 * B * F * k_v
           + flash_work(B, H, Hk, T, T, hd, True)[0] + flash_work(B, H, Hk, T, F, hd, False)[0])
    flops = (cfg.n_enc_layers * enc + cfg.n_dec_layers * dec + 2 * B * F * D * D
             + 2 * B * T * D * cfg.vocab)
    weights = cfg.n_dec_layers * (2 * q_o + k_v + mlp) + cfg.vocab * D
    cache = cfg.n_dec_layers * B * 2 * ((T + 4) + F) * Hk * hd
    return flops, 4 * (weights + cache)


def warm_breakdown(model, params, toks, *, batch=None, max_len=1024):
    """The kernel route warm: a prefill call (``batch``, by default the
    prompts ``toks``, 4 x 512) and decode steps by the host clock around
    work that ends in a synchronise, then one profiled window of each for
    the kernels' time.  The device's busy share is given two ways: the
    kernels over the profiled window's own wall time (the profiler slows
    the host, so this reads low), and over the median unprofiled wall time
    of other calls, which can read above 100% by the spread between calls
    (about 1% on a device-bound prefill)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    B, T = toks.shape
    batch = {"tokens": toks} if batch is None else batch

    def prefill():
        logits, cache = model.prefill(params, batch, max_len)
        return logits[:, -1].argmax(-1).int(), cache

    def decode(cur, cache, pos):
        logits, cache = model.decode_step(params, cache, cur, pos)
        return logits.argmax(-1).int(), cache

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        prefill_ms = []
        for _ in range(3):
            (cur, cache), ms = timed(prefill)
            prefill_ms.append(ms)
        pos = torch.full((B,), T, dtype=torch.int32, device="cuda")
        decode_ms = []
        for _ in range(5):
            (cur, cache), ms = timed(decode, cur, cache, pos)
            decode_ms.append(ms)
            pos += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (cur, cache), p_wall = timed(prefill)
        p_dev, p_top = _device_ms(prof)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            d_wall = 0.0
            for _ in range(3):
                (cur, cache), ms = timed(decode, cur, cache, pos)
                d_wall += ms
                pos += 1
        d_dev, d_top = _device_ms(prof)
    p_med, d_med = float(np.median(prefill_ms)), float(np.median(decode_ms))
    work = whisper_work if model.cfg.family == "encdec" else lm_work
    prefill_flops, decode_bytes = work(model.cfg, B, T)
    bounds = dict(prefill_flops=prefill_flops,
                  prefill_bound_ms=prefill_flops / F32_FLOP_PER_S * 1e3,
                  prefill_tflop_per_s=prefill_flops / p_med / 1e9,
                  decode_bytes=decode_bytes,
                  decode_bound_ms=decode_bytes / HBM_BYTES_PER_S * 1e3)
    log(f"  prefill: {prefill_flops / 1e12:.3f} TFLOP, {bounds['prefill_tflop_per_s']:.1f} "
        f"TFLOP/s warm, bound {bounds['prefill_bound_ms']:.2f} ms; decode step: "
        f"{decode_bytes / 1e9:.3f} GB, bound {bounds['decode_bound_ms']:.3f} ms")
    busy = dict(prefill=None if p_dev is None else p_dev / p_med,
                decode=None if d_dev is None else d_dev / 3 / d_med,
                prefill_window=None if p_dev is None else p_dev / p_wall,
                decode_window=None if d_dev is None else d_dev / d_wall)
    out = dict(warm_prefill_ms=prefill_ms, warm_decode_ms=decode_ms,
               profiled_prefill_wall_ms=p_wall, prefill_kernel_ms=p_dev,
               profiled_decode_wall_ms_3_steps=d_wall, decode_kernel_ms_3_steps=d_dev,
               prefill_device_busy=busy["prefill"], decode_device_busy=busy["decode"],
               prefill_device_busy_profiled_window=busy["prefill_window"],
               decode_device_busy_profiled_window=busy["decode_window"],
               prefill_top_kernels=p_top, decode_top_kernels=d_top, **bounds)
    log(f"  warm kernel route: prefill ms {[round(x, 2) for x in prefill_ms]}, decode ms/step "
        f"{[round(x, 2) for x in decode_ms]}")
    for what, dev, per, med, wall, top in (("prefill", p_dev, 1, p_med, p_wall, p_top),
                                           ("decode step", d_dev, 3, d_med, d_wall, d_top)):
        if dev is None:
            log(f"  profiled {what}: the profiler saw no kernel (device time not measured)")
            continue
        log(f"  profiled {what}: kernels {dev / per:.2f} ms of {med:.2f} ms warm wall, device "
            f"busy {100 * dev / per / med:.1f}%, idle {100 * (1 - dev / per / med):.1f}% (over "
            f"the profiled window's own {wall / per:.2f} ms: busy {100 * dev / wall:.1f}%); top "
            + "; ".join(f"{t['kernel'][:60]} {t['device_ms'] / per:.2f} ms x{t['calls'] // per}"
                        for t in top))
    return out


# -------------------------------- training ----------------------------------


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


TRAIN_SPANS = ("train.forward", "train.backward", "train.optimizer", "flash_attention.backward",
               "ssd_scan.backward")  # the port's profiler spans around a train step's parts


def train_step_breakdown(prof):
    """A profiled train step's kernel ms, split: every kernel; those inside
    the ``train.forward`` span (and of them the float kernels' own); those
    inside the kernels' backward spans (``flash_attention.backward``,
    ``ssd_scan.backward``: the recompute) and ``train.optimizer``; the
    backward as the rest; the GEMMs wherever they ran.  A span's kernels
    are its launching operators' (the profiler's device time of a CPU
    span); None where the profiler saw none."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in TRAIN_SPANS
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in kernels) / 1e3

    def span(name):
        ms = sum(e.device_time_total for e in events
                 if e.device_type == DeviceType.CPU and e.key == name) / 1e3
        return ms or None

    def named(*parts):
        return sum(e.self_device_time_total for e in kernels
                   if any(p in e.key.lower() for p in parts)) / 1e3

    out = dict(kernel_ms=total or None, forward_ms=span("train.forward"),
               recompute_ms=(span("flash_attention.backward") or 0.0)
               + (span("ssd_scan.backward") or 0.0) or None,
               optimizer_ms=span("train.optimizer"),
               forward_kernels_ms=named("flash_fwd", *SSD_KERNELS),
               gemm_ms=named("gemm", "xmma", "cutlass", "sm90_", "sm80_"),
               kernels=len(kernels),
               top=[dict(kernel=kernel_name(e.key)[:60], ms=e.self_device_time_total / 1e3,
                         calls=e.count)
                    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                                    reverse=True)[:6]])
    if total and out["forward_ms"] is not None and out["optimizer_ms"] is not None:
        out["backward_ms"] = total - out["forward_ms"] - out["optimizer_ms"]
    return out


class _Trainer:
    """What ``repro_torch.launch.train.main`` builds from ``argv`` (the
    model, train config and data iterator, and the seeded state), for
    ``cfg`` in place of ``--arch``'s config: the plain route's run and the
    resume drive ``TrainLoop`` on it themselves."""

    def __init__(self, cfg, argv):
        from repro_torch.launch import train
        from repro_torch.models.model_zoo import build_model

        self.cfg, self.args = cfg, train.parser().parse_args(argv)
        self.model, self.tcfg = build_model(cfg), train.train_config(cfg, self.args)

    def data(self):
        from repro_torch.launch import train

        return train.data_iterator(self.cfg, self.args, "cuda")

    def state(self, seed=None):
        import torch

        from repro_torch.training.train_loop import init_state

        seed = self.args.seed if seed is None else seed
        return init_state(self.model, self.tcfg, torch.Generator(device="cuda").manual_seed(seed))

    def loop(self, data):
        from repro_torch.training.train_loop import TrainLoop

        return TrainLoop(self.model, self.tcfg, data)


def exact_resume(cfg, argv):
    """Exact resume at full width and an eighth of the depth
    (``RESUME_DEPTH_CUT``: the checkpoint's bytes scale with the layers):
    the cut model's TRAIN_STEPS uninterrupted steps through ``TrainLoop``,
    then four steps from the same seeded init,
    ``CheckpointManager.save(block=True)`` into a temporary directory, a
    fresh state (another seed) and data iterator restored, four more
    steps; all eight losses against the uninterrupted run's."""
    import tempfile

    import torch

    from repro_torch.distributed.checkpoint import CheckpointManager, tree_leaves

    cut = cfg.replace(n_layers=cfg.n_layers // RESUME_DEPTH_CUT)
    trainer = _Trainer(cut, argv)
    _, log_ref = trainer.loop(trainer.data()).run(trainer.state(), 0, TRAIN_STEPS)
    want = [r["loss"] for r in log_ref]
    half = TRAIN_STEPS // 2
    data = trainer.data()
    state, log_a = trainer.loop(data).run(trainer.state(), 0, half)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        ckpt = CheckpointManager(d)
        t0 = time.perf_counter()
        ckpt.save(state, half, extra=data.state_dict(), block=True)
        save_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
        del state
        fresh = trainer.state(trainer.args.seed + 1)
        t0 = time.perf_counter()
        state, extra, step = ckpt.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del fresh
    data_b = trainer.data()
    data_b.load_state_dict(extra)
    state, log_b = trainer.loop(data_b).run(state, step, TRAIN_STEPS - half)
    del state
    got = [r["loss"] for r in log_a + log_b]
    bit_equal = got == want
    worst = max(_rel(a, b) for a, b in zip(got, want))
    log(f"  exact resume at {cut.n_layers} of {cfg.n_layers} layers (full width): {half} steps, "
        f"save {save_s:.2f} s ({nbytes / 1e9:.2f} GB, fsync-free npz), restore onto the card "
        f"{restore_s:.2f} s, {TRAIN_STEPS - half} more steps: losses "
        f"{'bit-equal to' if bit_equal else 'differ from'} the uninterrupted run's (largest "
        f"relative difference {worst:.3g})")
    if not bit_equal and worst > RESUME_TOL:
        raise AssertionError(f"{cfg.arch_id}: the resumed losses {got} differ from {want}")
    torch.cuda.empty_cache()
    return dict(resume_bit_equal=bit_equal, resume_max_rel_diff=worst, resume_losses=got,
                resume_layers=cut.n_layers, resume_reference_losses=want,
                ckpt_save_s=save_s, ckpt_restore_s=restore_s, ckpt_bytes=nbytes)


def profile_step(cfg, argv, losses):
    """The full model from ``train.main``'s seeded state: one step, whose
    loss must equal ``losses[0]`` (the kernel route's through
    ``train.main``) bit for bit, and one more under the profiler
    (``train_step_breakdown``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    full = _Trainer(cfg, argv)
    data = full.data()
    loop = full.loop(data)
    state, first = loop.run(full.state(), 0, 1)
    if first[0]["loss"] != losses[0] and _rel(first[0]["loss"], losses[0]) > RESUME_TOL:
        raise AssertionError(f"{cfg.arch_id}: TrainLoop's first loss {first[0]['loss']} is not "
                             f"train.main's {losses[0]}")
    batch = next(data)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = loop.step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = train_step_breakdown(prof)
    split.update(state_gb=state_gb, step_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del state
    return dict(first_loss_equals_train_main=first[0]["loss"] == losses[0],
                profiled_step_wall_ms=wall_ms, profiled_step=split)


def phase_train(arch, kernels, backend_fields, resume=True):
    """``arch`` trained at full width through ``repro_torch.launch.train.main``
    (seeded weights, the config's optimizer, TRAIN_ARGS), each kernel of
    ``kernels`` ((op, launches a step)) counted around it; then the first
    PLAIN_TRAIN_STEPS steps on the plain route (every field of ``backend_fields`` "chunked",
    with ``remat="full"``: the same values, and room on the card, where
    the plain attention's and the plain scan's saved intermediates would
    not fit beside the state) from the same weights and data, the exact
    resume where ``resume`` (``exact_resume``) and a profiled step
    (``profile_step``).  Gates: every loss finite, the last below
    the first; each kernel's launches a step; the routes within
    TRAIN_LOSS0_TOL (first loss), TRAIN_GNORM0_TOL (first grad norm) and
    TRAIN_LOSS_TOL (later losses), relative; the resume."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config(arch)
    argv = ["--arch", arch, *TRAIN_ARGS]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for op, _ in kernels:
        op.launches = 0
    t0 = time.perf_counter()
    log_k = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {op.__name__: op.launches for op, _ in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in log_k]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the losses {losses} are not finite and falling")
    for op, per_step in kernels:
        if op.launches != per_step * TRAIN_STEPS:
            raise AssertionError(f"{arch}: {op.__name__} launched {op.launches} times in "
                                 f"{TRAIN_STEPS} steps, {per_step} a step")
    step_ms = float(np.median([r["dt"] for r in log_k[1:]])) * 1e3
    n_params = cfg.param_count()
    flop_per_s = 6 * n_params * tokens / (step_ms / 1e3)
    row = dict(arch=arch, optimizer=cfg.optimizer, remat=cfg.remat, steps=TRAIN_STEPS,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, params=n_params, losses=losses,
               grad_norms=[r["grad_norm"] for r in log_k], step_ms=[r["dt"] * 1e3 for r in log_k],
               step_ms_median_warm=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               model_flop_per_s=flop_per_s, f32_peak_share=flop_per_s / F32_FLOP_PER_S,
               tf32_peak_share=flop_per_s / TF32_FLOP_PER_S, peak_device_gb=peak_gb,
               allocated_before_gb=before_gb,
               wall_s=wall_s, launches=launches)
    log(f"  train {arch} (kernel route): losses {[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in row['step_ms']]}; median warm step {step_ms:.1f} ms, "
        f"{row['tokens_per_s']:.0f} tokens/s, model {flop_per_s / 1e12:.2f} TFLOP/s (6 x "
        f"{n_params / 1e9:.3f} B params x {tokens} tokens a step) = "
        f"{100 * row['f32_peak_share']:.1f}% of the f32 peak (67 TFLOP/s), "
        f"{100 * row['tf32_peak_share']:.1f}% of the TF32 peak (495); peak {peak_gb:.2f} GB "
        f"({before_gb:.2f} GB allocated before); "
        f"launches {launches}")

    torch.cuda.empty_cache()
    plain = _Trainer(cfg.replace(remat="full", **{f: "chunked" for f in backend_fields}), argv)
    state, log_p = plain.loop(plain.data()).run(plain.state(), 0, PLAIN_TRAIN_STEPS)
    del state
    loss_gaps = [_rel(a["loss"], b["loss"]) for a, b in zip(log_k, log_p)]
    gnorm_gaps = [_rel(a["grad_norm"], b["grad_norm"]) for a, b in zip(log_k, log_p)]
    log(f"  kernel vs plain route, relative gaps a step: loss {[f'{g:.2e}' for g in loss_gaps]}, "
        f"grad norm {[f'{g:.2e}' for g in gnorm_gaps]}; plain route (remat full) median warm "
        f"step "
        f"{float(np.median([r['dt'] for r in log_p[1:]])) * 1e3:.1f} ms")
    if (loss_gaps[0] > TRAIN_LOSS0_TOL or gnorm_gaps[0] > TRAIN_GNORM0_TOL
            or max(loss_gaps[1:]) > TRAIN_LOSS_TOL):
        raise AssertionError(f"{arch}: the kernel and plain routes' training disagree")
    row.update(plain_losses=[r["loss"] for r in log_p], loss_gaps=loss_gaps,
               grad_norm_gaps=gnorm_gaps,
               plain_step_ms_median_warm=float(np.median([r["dt"] for r in log_p[1:]])) * 1e3)
    torch.cuda.empty_cache()
    if resume:
        row.update(exact_resume(cfg, argv))
    row.update(profile_step(cfg, argv, losses))
    split = row["profiled_step"]
    fmt = lambda v: "not measured" if v is None else f"{v:.1f} ms"  # noqa: E731
    log(f"  profiled warm step: wall {row['profiled_step_wall_ms']:.1f} ms, kernels "
        f"{fmt(split['kernel_ms'])} ({split['kernels']} kernels): forward {fmt(split['forward_ms'])} "
        f"(the float kernels' forward {fmt(split['forward_kernels_ms'])}), backward "
        f"{fmt(split.get('backward_ms'))} (of it the kernels' plain recompute "
        f"{fmt(split['recompute_ms'])}), optimizer {fmt(split['optimizer_ms'])}; GEMMs "
        f"{fmt(split['gemm_ms'])}; memory: the state (params, moments, step) and the batch "
        f"{split['state_gb']:.2f} GB, the step's peak {split['step_peak_gb']:.2f} GB; top "
        + "; ".join(
            f"{t['kernel']} {t['ms']:.1f} ms x{t['calls']}" for t in split["top"]))
    log(json.dumps({"phase": f"train_{arch}", **row}))
    torch.cuda.empty_cache()
    return row


# ------------------------------ launch tooling ------------------------------


def step_roofline(cfg, shape):
    """(least ms, its terms) of ``cfg``'s step at ``shape`` over the port's
    own eager traffic, from the launch tooling's meta counter
    (``dryrun.count_step``, the same step run on meta): the products
    outside the kernels at the f32 peak (the config computes in f32;
    torch's f32 GEMMs run no TF32), the kernels' own work at the 3xTF32
    rate (``tensor_core_bound``'s), and the bytes of every eager op at the
    HBM rate.  Those bytes count the implementation's own copies and
    recomputes, so this reads closer than ``step_floor``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    counter, *_ = dryrun.count_step(cfg, shape, make_test_mesh())
    t_ops = (counter.aten_flops / F32_FLOP_PER_S
             + counter.kernel_flops / (TF32_FLOP_PER_S / TF32X3))
    t_bytes = counter.total_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, dict(
        aten_flops=counter.aten_flops, kernel_flops=counter.kernel_flops,
        bytes=counter.total_bytes, bound_by="operations" if t_ops >= t_bytes else "bytes",
        ops_ms=t_ops * 1e3, bytes_ms=t_bytes * 1e3)


def step_floor(cfg, kind, B, T, args, out):
    """(least ms, its terms) of the step's own work, whatever the
    implementation: the forward's ``lm_flops`` (the matmuls at the f32
    peak, attention or SSD at the 3xTF32 rate), three times them in a train
    step (the backward's two products for each forward one), beside each
    input read once and each output written once at the HBM rate.  A
    prefill or decode step reads only its tokens' embedding rows; a decode
    step reads only the live part of its K/V cache (each sequence's
    ``pos + 1`` positions, all at the f32 peak) and writes one position of
    it."""
    import torch
    from torch.utils._pytree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    f32_flops = 0
    if kind == "train":
        mm, mix = (3 * f for f in lm_flops(cfg, B, T))
        read, written = nbytes(args), nbytes(out)
    else:
        params, table = args[0], args[0]["embed"]
        read = nbytes(params) - nbytes(table) + min(B * T, table.shape[0]) * nbytes(table[0])
        if kind == "prefill":
            mm, mix = lm_flops(cfg, B, T)
            read += nbytes(args[1])
            written = nbytes(out)
        else:
            cache, tok, pos = args[1:]
            live = int((pos.long() + 1).sum())
            mm, mix = 0, 0
            f32_flops = (2 * B * (cfg.active_param_count() - cfg.vocab * cfg.d_model)
                         + 4 * _lm_layers(cfg)[0] * cfg.n_heads * cfg.hd * live)
            read += nbytes(tok) + nbytes(pos)
            written = nbytes(out[0])
            for name, t in cache.items():
                if name in ("k", "v"):  # (layers, B, S, Hk, hd)
                    row = t[:, 0, 0].numel() * t.element_size()
                    read += live * row
                    written += B * row
                else:
                    read += nbytes(t)
                    written += nbytes(t)
    t_ops = (mm + f32_flops) / F32_FLOP_PER_S + mix / (TF32_FLOP_PER_S / TF32X3)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, dict(
        floor_flops=mm + mix + f32_flops, floor_bytes=read + written,
        floor_bound_by="operations" if t_ops >= t_bytes else "bytes",
        floor_ops_ms=t_ops * 1e3, floor_bytes_ms=t_bytes * 1e3)


def _max_abs_diff(a, b, dim=1, piece=4096):
    """max |a - b| over ``dim`` in pieces (a 32k prefill's logits are 20 GB)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.split(piece, dim), b.split(piece, dim)))


def _first_call(mod, attr, seen):
    """Context: ``mod.attr`` wrapped so that its first call's arguments and
    result are kept (detached) in ``seen``."""
    import contextlib

    import torch
    from torch.utils._pytree import tree_map

    real = getattr(mod, attr)

    def keep(t):
        return t.detach() if isinstance(t, torch.Tensor) else t

    def spy(*a, **kw):
        o = real(*a, **kw)
        if not seen:
            seen.append((tree_map(keep, a), kw, tree_map(keep, o)))
        return o

    @contextlib.contextmanager
    def patched():
        setattr(mod, attr, spy)
        try:
            yield
        finally:
            setattr(mod, attr, real)

    return patched()


def _kernel_vs_plain(name, seen):
    """The kernel's first call inside a step, on that call's own inputs,
    against its plain version at the f32 tolerance -> max_abs_err.  Flash
    against ``chunked_attention`` (``mha_reference``'s L x L scores do not
    fit at 32k), ``ssd_scan`` (seen at ``ops._forward``: the wrapper's own
    name counts its launches) against ``ssd_chunked_batched``."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models.attention import chunked_attention

    (a, kw, o), = seen
    with torch.no_grad():
        if name == "flash_attention":
            q, k, v, causal = a[:4]
            want = [chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=causal).transpose(1, 2)]
            got, tols = [o], TOL
        else:  # ssd_ops._forward(x, dt, A, B, C, chunk)
            want = ssd_ref.ssd_chunked_batched(*a[:5], chunk=a[5])
            got, tols = o, SSD_TOL
        errs = [_close(g, w, "float32", tols) for g, w in zip(got, want)]
    err = max(e for _, e in errs)
    shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
    log(f"    {name} on the step's first call's own inputs {shapes}: max_abs_err {err:.3g} "
        f"vs its plain version (tolerance {tols['float32']} abs + rel)")
    if not all(ok for ok, _ in errs):
        raise AssertionError(f"{name} disagrees with its plain version at {shapes} "
                             f"(max_abs_err {err:.3g})")
    return err


def launch_step(arch, kind, batch, length, kernel=None, plain=None):
    """``build_step(cfg, shape, make_test_mesh(), device="cuda")`` for the
    full-width ``arch`` at ``kind``, ``batch`` x ``length``.  The step's
    first call (its peak memory beside the arguments alone) is held bit for
    bit against the direct call (``make_train_step`` / ``Model.prefill`` /
    ``Model.decode_step``) on the same arguments; the direct call's first
    ``kernel`` call against the kernel's plain version on its own inputs
    (``_kernel_vs_plain``); and, where ``plain`` gives the config's plain
    backends, the step against the plain route on the same arguments:
    logits within LOGIT_TOL, a train step's loss and grad norm within
    TRAIN_LOSS0_TOL and TRAIN_GNORM0_TOL relative (its plain route with
    remat "full", which changes no value, for room).  Then LAUNCH_REPS warm
    calls are timed.  ``kernel`` ((op, launches a call)) is counted around
    each step call.  Where the shape does not fit, the batch is cut, then
    the length, by halves, and the cut logged.  A decode step's cache is
    filled with seeded normal draws first (the step and the direct call
    write the same slots with the same values before they read them); it
    launches no kernel, so it has no plain route to hold."""
    import contextlib

    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.dryrun import arg_bytes_per_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import attention
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    cfg = get_config(arch)
    asked = (batch, length)

    def direct(c, args, seq_len=None):
        model = build_model(c)
        if kind == "train":
            return make_train_step(model, TrainConfig(opt=OptimizerConfig(name=c.optimizer)))(
                *args)
        if kind == "prefill":
            return model.prefill(args[0], args[1], seq_len or shape.seq_len)[0]
        return model.decode_step(*args)

    def counted(step, args):
        if kernel:
            kernel[0].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches.append(kernel[0].launches if kernel else 0)
        return out, ms

    while True:
        shape = ShapeSpec(f"{kind}_card", length, batch, kind)
        args = got = want = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        try:
            step, args, in_sh = build_step(cfg, shape, make_test_mesh(), device="cuda",
                                           seed=LAUNCH_SEED)
            if kind == "decode":
                gen = torch.Generator(device="cuda").manual_seed(LAUNCH_SEED)
                for t in args[1].values():
                    t.normal_(generator=gen)
            arg_bytes = arg_bytes_per_device(args, in_sh)
            torch.cuda.synchronize()
            base_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            launches = []
            got, first_ms = counted(step, args)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            floor_ms, floor = step_floor(cfg, kind, batch, length, args, got)
            seen = []
            spy = (_first_call(attention, "flash_attention", seen) if kernel and
                   kernel[0].__name__ == "flash_attention" else
                   _first_call(ssd_ops, "_forward", seen) if kernel else contextlib.nullcontext())
            with spy:
                want = direct(cfg, args)
            g, w = tree_leaves(got), tree_leaves(want)
            same = len(g) == len(w) and all(
                a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(g, w))
            if kind == "decode":
                same = same and got[1] is args[1]
            if not same:
                raise AssertionError(f"{arch} {kind}: build_step's step differs from the "
                                     f"direct call")
            want = g = w = None
            check = {}
            if kernel:
                check["kernel_max_abs_err"] = _kernel_vs_plain(kernel[0].__name__, seen)
            seen.clear()
            if plain and kind == "train":
                got = {k: float(v) for k, v in got[1].items()}
                ref = direct(cfg.replace(remat="full", **plain), args)[1]
                gaps = {k: abs(got[k] - float(ref[k])) / abs(float(ref[k]))
                        for k in ("loss", "grad_norm")}
                ref = None
                check.update(plain_loss_rel_gap=gaps["loss"],
                             plain_grad_norm_rel_gap=gaps["grad_norm"])
                ok = gaps["loss"] <= TRAIN_LOSS0_TOL and gaps["grad_norm"] <= TRAIN_GNORM0_TOL
                what = (f"loss {gaps['loss']:.3g} (tolerance {TRAIN_LOSS0_TOL}), grad norm "
                        f"{gaps['grad_norm']:.3g} ({TRAIN_GNORM0_TOL}) relative")
            elif plain and length > LAUNCH_PLAIN_LEN:
                # the plain route on a step of its own at LAUNCH_PLAIN_LEN tokens
                got = None
                cut = ShapeSpec(f"{kind}_card", LAUNCH_PLAIN_LEN, batch, kind)
                cstep, cargs, _ = build_step(cfg, cut, make_test_mesh(), device="cuda",
                                             seed=LAUNCH_SEED)
                kern = cstep(*cargs)
                ref = direct(cfg.replace(**plain), cargs, LAUNCH_PLAIN_LEN)
                err = _max_abs_diff(kern, ref)
                kern = ref = cstep = cargs = None
                check.update(plain_logit_max_abs_err=err, plain_route_length=LAUNCH_PLAIN_LEN)
                ok, what = err <= LOGIT_TOL, (f"logits {err:.3g} (tolerance {LOGIT_TOL}) "
                                              f"absolute, a step of {batch} x "
                                              f"{LAUNCH_PLAIN_LEN} on its own arguments")
            elif plain:
                ref = direct(cfg.replace(**plain), args)
                err = _max_abs_diff(got, ref)
                ref = None
                check.update(plain_logit_max_abs_err=err)
                ok, what = err <= LOGIT_TOL, f"logits {err:.3g} (tolerance {LOGIT_TOL}) absolute"
            if plain:
                log(f"    the step vs the plain route ({plain}) on the same arguments: {what}")
                if not ok:
                    raise AssertionError(f"{arch} {kind}: the step and the plain route differ: "
                                         f"{what}")
            got = None
            times = [counted(step, args)[1] for _ in range(LAUNCH_REPS)]
            break
        except torch.cuda.OutOfMemoryError:
            args = got = want = ref = None
            if batch > 1:
                batch //= 2
            elif length > 1:
                length //= 2
            else:
                raise
            log(f"  {arch} {kind}: out of memory at {asked[0]} x {asked[1]}; cut to {batch} x "
                f"{length}")
    args = None
    torch.cuda.empty_cache()
    if kernel and launches != [kernel[1]] * (LAUNCH_REPS + 1):
        raise AssertionError(f"{arch} {kind}: {kernel[0].__name__} launched {launches} times "
                             f"a call, {kernel[1]} expected")
    ms = float(np.median(times))
    bound_ms, terms = step_roofline(cfg, shape)
    row = dict(arch=arch, kind=kind, batch=batch, length=length, asked=list(asked),
               cut=(batch, length) != asked, ms=ms, times_ms=times, first_call_ms=first_ms,
               bitwise_equal=True, launches=sum(launches),
               kernel=kernel[0].__name__ if kernel else None, plain_route=plain, **check,
               peak_device_gb=peak_gb, allocated_before_gb=base_gb,
               arg_bytes_gb=arg_bytes / 1e9, floor_ms=floor_ms,
               measured_over_floor=ms / floor_ms, **floor, eager_roofline_ms=bound_ms,
               measured_over_eager_roofline=ms / bound_ms, **terms)
    log(f"  {arch} {kind} B {batch} x {length}: median {ms:.1f} ms of {LAUNCH_REPS} warm calls "
        f"({[round(t, 1) for t in times]}; the first, compared call {first_ms:.1f}); floor "
        f"{floor_ms:.2f} ms from the step's own work ({floor['floor_bound_by']}: "
        f"{floor['floor_flops'] / 1e12:.2f} TFLOP, {floor['floor_bytes'] / 1e9:.2f} GB), "
        f"measured / floor {row['measured_over_floor']:.2f}; over the port's own eager traffic "
        f"{bound_ms:.2f} ms ({terms['bound_by']}: {terms['aten_flops'] / 1e12:.2f} TFLOP "
        f"products at the f32 peak + {terms['kernel_flops'] / 1e12:.2f} TFLOP in the kernels "
        f"at 3xTF32, {terms['bytes'] / 1e9:.1f} GB at the HBM rate), measured / that "
        f"{row['measured_over_eager_roofline']:.2f}; == the direct call bit for bit; launches "
        f"a call {launches}; peak {peak_gb:.2f} GB, arguments {arg_bytes / 1e9:.2f} GB (the "
        f"specs' bytes on one card)")
    return row


def phase_launch(smi):
    """Phase 22, the launch tooling: (a) the meta dry run of qwen3_0_6b's
    four cells on the single-pod H100 mesh and its report table; (b)
    ``build_step`` on the card for the full-width qwen3_0_6b at the
    production lengths, the batch cut to one card (prefill 1 x 32,768,
    decode 4 over a 32,768-token cache, train 1 x 4,096) and (c)
    mamba2_780m's prefill at 1 x 32,768: each step equal to the direct
    call bit for bit, its kernel's launches exact, the median ms beside
    the meta counter's roofline at that shape; then the ``pulse_verify``
    CLI against the golden files."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import dryrun, report

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.json"
        if dryrun.main(["--arch", LAUNCH_ARCH, "--mesh", "single", "--out", str(out)]) != 0:
            raise AssertionError("the meta dry run failed")
        table = report.render(str(out))
        dry = json.loads(out.read_text())
    print(table, flush=True)
    dry_s = time.perf_counter() - t0
    log(f"  (a) meta dry run of {LAUNCH_ARCH}'s 4 cells on 32x8: {dry_s:.1f} s "
        "(counts and datasheet peaks, not measurements)")

    flash = (flash_ops.flash_attention, get_config(LAUNCH_ARCH).n_layers)
    ssd = (ssd_ops.ssd_scan, get_config(LAUNCH_SSM_ARCH).n_layers)
    attn_plain, ssm_plain = {"attn_backend": "chunked"}, {"ssm_backend": "chunked"}
    steps = [launch_step(LAUNCH_ARCH, "prefill", 1, 32768, flash, attn_plain),
             launch_step(LAUNCH_ARCH, "decode", 4, 32768),
             launch_step(LAUNCH_ARCH, "train", 1, 4096, flash, attn_plain),
             launch_step(LAUNCH_SSM_ARCH, "prefill", 1, 32768, ssd, ssm_plain)]

    t1 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.pulse_verify", "--all", "--golden",
         str(ROOT / "tests" / "golden" / "pulse_verify")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
        text=True, timeout=300, check=False)
    log(cli.stdout.rstrip())
    if cli.returncode != 0:
        raise AssertionError(f"pulse_verify --all --golden exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    log(f"  pulse_verify --all --golden tests/golden/pulse_verify: exit 0 "
        f"({time.perf_counter() - t1:.1f} s)")
    return dict(
        dry_run=dict(seconds=dry_s, cells={k: {f: v.get(f) for f in (
            "compute_s", "memory_s", "collective_s", "dominant", "useful_ratio",
            "bytes_per_device", "hlo_flops", "hlo_bytes")} for k, v in dry.items()
            if "skipped" not in v}),
        steps=steps, pulse_verify_rc=cli.returncode, device=smi,
        flash_launches=sum(s["launches"] for s in steps if s["kernel"] == "flash_attention"),
        ssd_launches=sum(s["launches"] for s in steps if s["kernel"] == "ssd_scan"))


# ------------------------- memory nodes as processes -------------------------

PG_RANKS = 4  # the paper's MEM_NODES, one process each on the one card
PG_TIMEOUT = 600.0  # seconds the world may run before it is killed
PG_RUNS = [  # (batch, fabric): phase 11's read batches and phase 12's write batches
    ("webservice", "dense"), ("webservice", "ring"), ("wiredtiger", "dense"),
    ("webservice_rw", "dense"), ("wiredtiger_update", "dense")]
PG_RUN_ARGS = dict(max_iters=4096, k_local=4, compact=True, schedule="dispatched")
# (a): phase 13's replicated reads, R = 2 by make_replica_plan(4), on each
# read batch's first eighth of its queries (the time's cut)
PG_REP_CUT = 8
PG_REP_CASES = [("failover", (d,)) for d in range(PG_RANKS)] + [("spread", ())]
PG_KILL = dict(kill_shard=2, kill_superstep=3)  # (b), on webservice_rw
PG_SERVE_REQUESTS = 4_096  # (c) and (h): the first of phase 14's 32,768 requests
PG_WATCHDOG_READS = 2_048  # (i): the first of phase 15's 4,096 reads
# (i): its reads arrive from this round on, so that the watchdog's two-miss
# window (two rounds of probes) passes before them; a read behind the
# straggler sleeps in every superstep shard 1 serves (on an H100 host whose
# healthy probe takes 30-40 ms, 1.6 s each: minutes for the run)
PG_WATCHDOG_IDLE_ROUNDS = 2
# (j): a world of its own, twice PG_RANKS: rank 0 serves on ranks 0-3 (the
# world's first PG_RANKS, distributed.world.first_ranks) and cuts over to
# all of them once a third of (c)'s requests have retired
PG_RESHARD_WORLD = 2 * PG_RANKS
# (j)'s requests arrive this many a round: at phase 14's 1,536 a round all
# 4,096 are admitted before a third retire, the drain serves every one of
# them and nothing is left for the grown group
PG_RESHARD_PER_ROUND = 512
MOE_EP_ARCH = "granite_moe_1b_a400m"
MOE_EP_MESHES = [  # (id, DeviceMesh shape, dim names): "replica" is no dp dim
    ("model2", (2, 2), ("replica", "model")), ("data2_model2", (2, 2), ("data", "model"))]
MOE_EP_TOL = 1e-6  # of the largest magnitude: only the f32 partial sums' order differs
SERVE_KINDS = ("webservice", "wiredtiger", "wiredtiger_update")


def _pg_iterator(name, n_buckets):
    """The port's iterator of a phase-23 batch, made again on each rank."""
    from repro_torch.core.structures import btree, hash_table

    return {"webservice": lambda: hash_table.find_iterator(n_buckets),
            "wiredtiger": btree.find_iterator,
            "webservice_rw": lambda: hash_table.rw_iterator(n_buckets),
            "wiredtiger_update": btree.update_iterator}[name]()


def _pg_inputs(rng):
    """Phase 11's read batches (``webservice`` interleaved, ``wiredtiger``
    sequential) and phase 12's ``webservice_rw`` and ``wiredtiger_update``
    over four shards, freshly drawn: {name: (arena fields, ptr0, scr0)} as
    numpy, and the write batches' checks."""
    P, reads = routing_batches(rng)
    out = {b["name"]: ([t.numpy() for t in (b["arena"].data, b["arena"].bounds,
                                            b["arena"].perms, b["arena"].heap)],
                       b["p0"].numpy(), b["s0"].numpy()) for b in reads[:2]}
    checks = {}
    for wb in (_webservice_rw(rng, P), _wiredtiger_update(rng, P)):
        (_, _, p0, s0), = wb["steps"]
        out[wb["name"]] = (wb["fields"], p0.numpy(), s0.numpy())
        checks[wb["name"]] = wb["check"][0]
    return out, checks


def _pg_replica_rows(data, bounds):
    """``make_replica_plan(P)``'s replica rows in the arena's layout, as
    numpy: holder r's rows hold its primary's (every policy's plan has the
    same holders)."""
    import numpy as np

    from repro_torch.core import routing

    plan = routing.make_replica_plan(len(bounds) - 1)
    rows = np.zeros_like(data)
    for holder, p in enumerate(plan.primary_map):
        if p >= 0:
            rows[bounds[holder]:bounds[holder + 1]] = data[bounds[p]:bounds[p + 1]]
    return rows


def _pg_first_call_checks(checked):
    """Wrap ``pulse_chase_superstep`` and the superstep's commit
    (``routing._commit``, around ``pulse_commit``, whose launch count the
    wrappers leave alone) so that the first launch of each kind (per key
    of ``checked``: ``pulse_chase``, ``pulse_chase_window`` for a launch
    with replica windows, ``pulse_commit``) is held against its plain
    version on clones of the same inputs, on the card; returns the undo."""
    import torch

    from repro_torch.core import routing
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.kernels.pulse_chase import ref as chase_ref
    from repro_torch.kernels.pulse_commit import ref as commit_ref

    chase, commit = chase_ops.pulse_chase_superstep, routing._commit

    def chase_spy(arena_data, pool, bounds, perms, **kw):
        out = chase(arena_data, pool, bounds, perms, **kw)
        rep = kw.get("rep")
        key = "pulse_chase" if rep is None else "pulse_chase_window"
        if key not in checked:
            want = chase_ref.chase_superstep_reference(
                arena_data, pool, bounds, perms, kw["logic_fn"], kw["k_local"],
                scratch_words=kw["logic_fn"].it.scratch_words, max_iters=kw["max_iters"],
                elide=kw.get("elide_access_check", False), rep=rep,
                shard0=kw.get("shard0", 0), row0=kw.get("row0", 0))
            checked[key] = dict(
                bit_equal=bool(torch.equal(out, want)), max_abs_err=max_abs_err(out, want),
                records=int(pool.shape[0] * pool.shape[1]), shard0=kw.get("shard0", 0),
                row0=kw.get("row0", 0), rows=int(arena_data.shape[0]))
            if rep is not None:
                checked[key].update(policy=rep[3], dead=rep[2].nonzero().flatten().tolist(),
                                    replica_rows=int(rep[0].shape[0]))
        return out

    def commit_spy(pools, data, heap, bounds, perms, **kw):
        before = None if "pulse_commit" in checked else [t.clone() for t in (pools, data, heap)]
        out = commit(pools, data, heap, bounds, perms, **kw)
        if before is not None:
            want = commit_ref.pulse_commit_staged(
                *before, bounds, perms, scratch_words=kw["scratch_words"],
                shard0=kw.get("shard0", 0), row0=kw.get("row0", 0))
            checked["pulse_commit"] = dict(
                bit_equal=all(torch.equal(a, b) for a, b in zip(out, want)),
                max_abs_err=max(max_abs_err(a, b) for a, b in zip(out, want)),
                records=int(pools.shape[0] * pools.shape[1]), shard0=kw.get("shard0", 0),
                row0=kw.get("row0", 0), rows=int(data.shape[0]))
        return out

    chase_ops.pulse_chase_superstep, routing._commit = chase_spy, commit_spy

    def undo():
        chase_ops.pulse_chase_superstep, routing._commit = chase, commit
    return undo


def _pg_rep_runs(d, mesh):
    """(a) on one rank: each read batch's first 1/PG_REP_CUT of its
    queries under every PG_REP_CASES plan, each run's records, stats and
    launches; the batch's first windowed launch against its plain
    version."""
    import numpy as np
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.kernels.pulse_chase import ops as chase_ops

    out = {}
    for name in ("webservice", "wiredtiger"):
        it = _pg_iterator(name, pulse_paper.WEBSERVICE.n_buckets)
        fields = [d[f"{name}/{f}"] for f in ("data", "bounds", "perms", "heap")]
        ar = arena_from_numpy(*fields, device="cpu")
        B = d[f"{name}/p0"].shape[0] // PG_REP_CUT
        p0, s0 = torch.from_numpy(d[f"{name}/p0"][:B]), torch.from_numpy(d[f"{name}/s0"][:B])
        rows = _pg_replica_rows(fields[0], fields[1])
        checked = {}
        for policy, dead in PG_REP_CASES:
            mask = np.zeros(PG_RANKS, bool)
            mask[list(dead)] = True
            ctx = routing.ReplicaContext(routing.make_replica_plan(PG_RANKS, policy=policy),
                                         rows, mask)
            undo = _pg_first_call_checks(checked)
            chase_ops.pulse_chase.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                rec, st = routing.distributed_execute(it, ar, p0, s0, mesh=mesh,
                                                      replication=ctx, **PG_RUN_ARGS)
            finally:
                undo()
            torch.cuda.synchronize()
            out[f"{name}/{policy}{list(dead)}"] = dict(
                records=rec.cpu().numpy(), stats=st, seconds=time.perf_counter() - t0,
                launches=chase_ops.pulse_chase.launches)
        out[f"{name}/window_check"] = checked.get("pulse_chase_window")
    return out


def window_offset_vs_plain(arena, it, p0, s0, P, rep, *, shard: int, advance: int = 2):
    """One superstep's local chase of ``shard``'s pool alone, after
    ``advance`` routed supersteps, over its own rows and its holder slice
    of the replica rows (``shard0``, ``row0``: a memory node's windowed
    launch), on the kernel and on its plain version, held against the
    whole-arena windowed launch's part for that shard; the kernel timed
    beside the whole-arena launch.  The bound counts the shard's records
    active at its start read and written once and each distinct row its
    steps read once."""
    import torch

    from repro_torch.core import routing
    from repro_torch.kernels.pulse_chase import ops, ref

    pools, _ = routing.place_requests(p0, s0, P)
    step = routing.make_superstep(it, P, k_local=ROUTE_RUN["k_local"],
                                  max_iters=ROUTE_RUN["max_iters"], drain_done=True)
    for _ in range(advance):
        pools = step(pools, arena.data, arena.bounds, arena.perms)[0]
    logic = ops.iterator_logic(it)
    lo, hi = arena.bounds[shard:shard + 2].tolist()
    rows, mine = arena.data[lo:hi].contiguous(), pools[shard:shard + 1].contiguous()
    rep_mine = (rep[0][lo:hi].contiguous(), *rep[1:])
    kw = dict(logic_fn=logic, k_local=ROUTE_RUN["k_local"], max_iters=ROUTE_RUN["max_iters"])
    off = dict(shard0=shard, row0=lo)

    def kern():
        return ops.pulse_chase_superstep(rows, mine, arena.bounds, arena.perms, rep=rep_mine,
                                         **kw, **off)

    def whole():
        return ops.pulse_chase_superstep(arena.data, pools, arena.bounds, arena.perms, rep=rep,
                                         **kw)

    def plain(k=ROUTE_RUN["k_local"], pool=mine):
        return ref.chase_superstep_reference(rows, pool, arena.bounds, arena.perms, logic, k,
                                             scratch_words=it.scratch_words,
                                             max_iters=ROUTE_RUN["max_iters"], rep=rep_mine,
                                             **off)

    got, want, all_ = kern(), plain(), whole()
    torch.cuda.synchronize()
    F_PTR, F_ITERS = routing.F_PTR, routing.F_ITERS
    cur, seen = mine, []
    for _ in range(ROUTE_RUN["k_local"]):
        nxt = plain(1, cur)
        moved = nxt[..., F_ITERS] > cur[..., F_ITERS]
        seen.append(cur[..., F_PTR][moved])
        cur = nxt
    rows_read = int(torch.unique(torch.cat(seen)).numel())
    active = int((mine[..., routing.F_STATUS] == 0).sum().item())
    R = pools.shape[2]
    bound = (active * R * 4 * 2 + rows_read * arena.node_words * 4) / HBM_BYTES_PER_S * 1e3
    k_ms = profiled_ms([kern], 10, "chase_kernel")
    w_ms = profiled_ms([whole], 10, "chase_kernel")
    return dict(bit_equal=torch.equal(got, want) and torch.equal(got[0], all_[shard]),
                max_abs_err=max_abs_err(got, want), shard=shard, rows=hi - lo,
                active_records=active, pool_records=int(mine.shape[1]), rows_read=rows_read,
                ms=k_ms if k_ms is not None else time_cuda(kern, 10),
                ms_source="profiler" if k_ms is not None else "events",
                whole_ms=w_ms if w_ms is not None else time_cuda(whole, 10),
                plain_ms=time_cuda(plain, 3), bound_ms=bound, bound_by="bytes")


def _pg_kill_run(d, mesh):
    """(b) on one rank: webservice_rw with shard 2 killed before superstep
    3: what it raised, and whether the caller's arena is unchanged."""
    import torch

    from repro_torch.configs import pulse_paper
    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.faults import FaultInjector, FaultPlan, ShardFailure

    name = "webservice_rw"
    ar = arena_from_numpy(*(d[f"{name}/{f}"] for f in ("data", "bounds", "perms", "heap")),
                          device="cpu")
    digest = _digest(ar)
    raised = None
    try:
        routing.distributed_execute(
            _pg_iterator(name, pulse_paper.WEBSERVICE.n_buckets), ar,
            torch.from_numpy(d[f"{name}/p0"]), torch.from_numpy(d[f"{name}/s0"]), mesh=mesh,
            fault_injector=FaultInjector(FaultPlan(**PG_KILL)), **PG_RUN_ARGS)
    except ShardFailure as e:
        raised = (e.shard, e.superstep)
    return dict(raised=raised, unchanged=_digest(ar) == digest)


def _serve_tuples(a):
    return [(int(i), SERVE_KINDS[int(k)], int(q), TENANTS[int(t)], int(r), int(v))
            for i, k, q, t, r, v in a]


def _pg_serve_runs(rank, d, mesh, tmp):
    """(c), (h) and (i) on one rank: rank 0 serves phase 14's heap on the
    process group (``PulseService`` over ``PulseEngine(arena, mesh=...)``,
    dispatched), the other ranks follow it (``memory_node.follow``) until
    its ``close``.  Rank 0 returns each run's requests, counts and row;
    every rank its final arena's digest."""
    import torch

    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.distributed.arena_ft import (
        ArenaStore,
        FaultToleranceConfig,
        ReplicationConfig,
    )
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.serving import memory_node

    fields = [d[f"serve/{f}"] for f in ("data", "bounds", "perms", "heap")]
    heads, root = d["serve/heads"], int(d["serve/root"])
    tuples, reads = _serve_tuples(d["serve/requests"]), _serve_tuples(d["serve/reads"])
    specs = serving_specs(heads, root, "cuda")
    read_specs = {k: v for k, v in specs.items() if not v.writes}
    out = {}

    def arena():
        return arena_from_numpy(*fields, device="cuda" if rank == 0 else "cpu")

    def follow(tag, sp):
        t0 = time.perf_counter()
        out[tag] = dict(digest=_digest(memory_node.follow(mesh, arena(), sp)),
                        seconds=time.perf_counter() - t0)

    def served(tag, row, reqs, m, eng, extra=None):
        leader = eng.mesh.leader
        row.update(fabric_s=routing.FABRIC_STATS.seconds,
                   fabric_collectives=routing.FABRIC_STATS.collectives,
                   fabric_share=routing.FABRIC_STATS.seconds / row["wall_s"],
                   leader=dict(vars(leader.stats)),
                   leader_share=leader.stats.seconds / row["wall_s"])
        out[tag] = dict(row=row, reqs=reqs, counts=_serving_counts(m),
                        digest=_digest(eng.arena), data=eng.arena.data.cpu(), **(extra or {}))

    # (c): phase 14's run (c), its first PG_SERVE_REQUESTS requests
    if rank:
        follow("c", specs)
    else:
        routing.FABRIC_STATS.reset()
        reqs, m, eng, row = serve_run("c: process group of 4, sync", arena(), specs, tuples,
                                      P=PG_RANKS, mesh=mesh, schedule="dispatched")
        served("c", row, reqs, m, eng)

    # (h): failover replication, shard 2 killed at the middle read quantum
    if rank:
        follow("h", specs)
    else:
        store = ArenaStore(Path(tmp) / "h")
        hooks = _store_hooks(store)
        standby = {}

        def time_standby(svc):
            standby["apply"] = _Timed(svc._replicas.apply_quantum)
            svc._replicas.apply_quantum = standby["apply"]

        extra = {}
        routing.FABRIC_STATS.reset()
        reqs, m, eng, row = serve_run(
            "h: process group of 4, failover replication, kill shard 2", arena(), specs, tuples,
            P=PG_RANKS, mesh=mesh, schedule="dispatched", on_service=time_standby, extra=extra,
            fault_plan=FaultPlan(kill_shard=2, kill_call=int(d["serve/kill_call"]),
                                 kill_superstep=2),
            fault_tolerance=FaultToleranceConfig(
                store=store, snapshot_every=FT_SNAPSHOT_EVERY, dead_rounds=6,
                replication=ReplicationConfig(policy="failover")))
        store.close()
        reps = extra["svc"]._replicas
        reps.verify(eng.arena)
        standby_same = all(torch.equal(getattr(reps.shadow, f).cpu(),
                                       getattr(eng.arena, f).cpu()) for f in ("data", "heap"))
        served("h", row, reqs, m, eng, dict(
            standby_same=standby_same, standby=_ms(standby["apply"].seconds),
            recoveries=[vars(i) for i in hooks["recoveries"]]))

    # (i): the watchdog on a reads-only cut, shard 1 delayed
    if rank:
        follow("i", read_specs)
    else:
        healthy, extra, probes = [], {}, [0]

        def arm_watchdog(svc):
            for shard in range(PG_RANKS):
                for rep in range(HEALTHY_PROBE_REPS + 1):
                    dt = svc._probe_shard(shard, warm=True)
                    if rep:
                        healthy.append(dt)
            timeout = max(0.02, 10 * max(healthy))
            svc.ft.watchdog_timeout_s = timeout
            svc.engine.fault_injector = FaultInjector(FaultPlan(delay_shard=1,
                                                                delay_s=4 * timeout))
            probe = svc._probe_shard

            def counted(shard, *, warm=False):
                n0 = chase_ops.pulse_chase.launches
                try:
                    return probe(shard, warm=warm)
                finally:
                    probes[0] += chase_ops.pulse_chase.launches - n0

            svc._probe_shard = counted

        store = ArenaStore(Path(tmp) / "i")
        routing.FABRIC_STATS.reset()
        reqs, m, eng, row = serve_run(
            "i: process group of 4, reads only, watchdog, shard 1 delayed", arena(), read_specs,
            reads, P=PG_RANKS, mesh=mesh, schedule="dispatched", on_service=arm_watchdog,
            extra=extra, fault_tolerance=FaultToleranceConfig(
                store=store, snapshot_every=FT_SNAPSHOT_EVERY, dead_rounds=1000,
                replication=ReplicationConfig(policy="failover"), watchdog_timeout_s=1.0))
        store.close()
        svc = extra["svc"]
        served("i", row, reqs, m, eng, dict(
            healthy_probe=_ms(healthy), watchdog_timeout_s=svc.ft.watchdog_timeout_s,
            delay_s=eng.fault_injector.plan.delay_s, probe_launches=probes[0],
            suspected=sorted(svc._detector.dead_shards())))
    return out


def _joined_calls():
    """Wrap ``routing.distributed_execute`` to log every call this rank
    joins: (the arena's shards, whether it writes, its supersteps); returns
    the log and the undo."""
    from repro_torch.core import routing

    execute, log_ = routing.distributed_execute, []

    def logged(it, arena, *args, **kw):
        out = execute(it, arena, *args, **kw)
        log_.append((int(arena.num_shards), bool(it.mutates), int(out[1].supersteps)))
        return out

    routing.distributed_execute = logged

    def undo():
        routing.distributed_execute = execute
    return log_, undo


def _pg_reshard_rank(rank, world_size, in_path, out_path):
    """(j) on one rank of a world of PG_RESHARD_WORLD on ``cuda:0``: rank 0
    serves (c)'s requests (PG_RESHARD_PER_ROUND arriving a round) on ranks
    0-3 (``ProcessGroupMesh(world.first_ranks(PG_RANKS))``, dispatched) and
    asks for the reshard to all of them once a third have retired (the
    cutover timed, and the bytes it installed); every other rank follows
    from the start, ranks 4-7 outside the serving group until the cutover,
    where their first offset launches are held against their plain
    versions.  Every rank logs the calls it joined and its launches; writes
    to ``out_path % rank``."""
    import numpy as np
    import torch

    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.distributed import world
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.kernels.pulse_commit import ops as commit_ops
    from repro_torch.serving import memory_node

    torch.cuda.set_device(0)
    d = dict(np.load(in_path))
    fields = [d[f"serve/{f}"] for f in ("data", "bounds", "perms", "heap")]
    tuples = _serve_tuples(d["serve/reshard"])
    specs = serving_specs(d["serve/heads"], int(d["serve/root"]), "cuda")
    mesh = routing.ProcessGroupMesh(world.first_ranks(PG_RANKS), device="cuda")
    calls, undo = _joined_calls()
    checked = {}
    undo_checks = _pg_first_call_checks(checked) if rank >= PG_RANKS else (lambda: None)
    out = dict(rank=rank)
    t0 = time.perf_counter()
    try:
        if rank == 0:
            cut = {}

            def time_cutover(svc):
                leader, cutover = svc.engine.mesh.leader, svc._cutover

                def timed(rnd):
                    b0, t_cut = leader.stats.arena_bytes, time.perf_counter()
                    cutover(rnd)
                    cut.update(ms=(time.perf_counter() - t_cut) * 1e3,
                               bytes=leader.stats.arena_bytes - b0, round=rnd,
                               leader_ms=leader.stats.cutover_s * 1e3)
                svc._cutover = timed

            routing.FABRIC_STATS.reset()
            reqs, m, eng, row = serve_run(
                f"j: process group of {PG_RANKS} -> {PG_RESHARD_WORLD} in a world of "
                f"{PG_RESHARD_WORLD}, sync", arena_from_numpy(*fields, device="cuda"), specs,
                tuples, P=PG_RANKS, mesh=mesh, schedule="dispatched",
                reshard_at=len(tuples) // 3, on_service=time_cutover)
            leader = eng.mesh.leader
            row.update(fabric_s=routing.FABRIC_STATS.seconds,
                       fabric_collectives=routing.FABRIC_STATS.collectives,
                       fabric_share=routing.FABRIC_STATS.seconds / row["wall_s"],
                       leader=dict(vars(leader.stats)),
                       leader_share=leader.stats.seconds / row["wall_s"],
                       drain_rounds=m.reshard_drain_rounds, cutover=cut)
            out.update(row=row, reqs=reqs, counts=_serving_counts(m), digest=_digest(eng.arena),
                       launches=dict(pulse_chase=row["pulse_chase_launches"],
                                     pulse_commit=row["pulse_commit_launches"]))
        else:
            chase_ops.pulse_chase.launches = commit_ops.pulse_commit.launches = 0
            got = memory_node.follow(mesh, arena_from_numpy(*fields, device="cpu"), specs)
            torch.cuda.synchronize()
            out.update(digest=None if got is None else _digest(got),
                       launches=dict(pulse_chase=chase_ops.pulse_chase.launches,
                                     pulse_commit=commit_ops.pulse_commit.launches))
    finally:
        undo_checks()
        undo()
    out.update(calls=calls, checks=checked, seconds=time.perf_counter() - t0)
    torch.save(out, out_path % rank)


def _pg_rank(rank, world_size, in_path, out_path):
    """One memory node of phase 23 on ``cuda:0``: every PG_RUNS batch
    through ``distributed_execute`` on the ``ProcessGroupMesh`` (its first
    superstep's ``pulse_chase`` and ``pulse_commit`` launches held against
    their plain versions), a second call of each timed with the fabric's
    share; (a) the replicated reads, (b) the kill, (c), (h) and (i) the
    service (``_pg_serve_runs``); then Granite's MoE layer under both
    MOE_EP_MESHES.  Writes its results to ``out_path % rank``."""
    import tempfile

    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, pulse_paper
    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.kernels.pulse_chase import ops as chase_ops
    from repro_torch.kernels.pulse_commit import ops as commit_ops
    from repro_torch.models import moe

    torch.cuda.set_device(0)
    d = dict(np.load(in_path))
    mesh = routing.ProcessGroupMesh(device="cuda")
    out = dict(rank=rank, runs={}, moe={}, seconds={})
    t_part = time.perf_counter()
    for name, fabric in PG_RUNS:
        it = _pg_iterator(name, pulse_paper.WEBSERVICE.n_buckets)
        ar = arena_from_numpy(*(d[f"{name}/{f}"] for f in ("data", "bounds", "perms", "heap")),
                              device="cpu")
        p0, s0 = torch.from_numpy(d[f"{name}/p0"]), torch.from_numpy(d[f"{name}/s0"])
        run = dict(PG_RUN_ARGS, fabric=fabric)
        checked = {}
        undo = _pg_first_call_checks(checked)
        chase0, commit0 = chase_ops.pulse_chase.launches, commit_ops.pulse_commit.launches
        try:
            got = routing.distributed_execute(it, ar, p0, s0, mesh=mesh, **run)
        finally:
            undo()
        torch.cuda.synchronize()
        launches = dict(pulse_chase=chase_ops.pulse_chase.launches - chase0,
                        pulse_commit=commit_ops.pulse_commit.launches - commit0)
        row = dict(records=got[0].cpu().numpy(), stats=got[1], launches=launches,
                   checks=checked)
        if len(got) == 3:
            row["digest"] = _digest(got[2])
        del got
        torch.distributed.barrier()
        routing.FABRIC_STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = routing.distributed_execute(it, ar, p0, s0, mesh=mesh, **run)
        torch.cuda.synchronize()
        row.update(seconds=time.perf_counter() - t0, fabric_s=routing.FABRIC_STATS.seconds,
                   collectives=routing.FABRIC_STATS.collectives,
                   same_again=bool(torch.equal(again[0].cpu(), torch.from_numpy(
                       row["records"]))))
        del again
        out["runs"][f"{name}/{fabric}"] = row
        torch.distributed.barrier()
    out["seconds"]["reads and writes"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    out["rep"] = _pg_rep_runs(d, mesh)
    out["seconds"]["a: replicated reads"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    out["kill"] = _pg_kill_run(d, mesh)
    out["seconds"]["b: kill"] = time.perf_counter() - t_part
    torch.distributed.barrier()
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_ft_") as tmp:
        out["serve"] = _pg_serve_runs(rank, d, mesh, tmp)
    out["seconds"]["c, h, i: the service"] = time.perf_counter() - t_part
    torch.distributed.barrier()

    t_part = time.perf_counter()
    cfg = get_config(MOE_EP_ARCH)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator().manual_seed(1))
    for mid, shape, names in MOE_EP_MESHES:
        # a mesh of the Gloo group's ranks; its tensors live on cuda:0 and
        # its collectives go through the host (distributed.world.on_host)
        dm = init_device_mesh("cpu", shape, mesh_dim_names=names)
        mine = _to_device(moe.shard_moe_params(p, dm), "cuda")
        dp = dm["data"] if "data" in names else None
        n_dp, i_dp = (dp.size(), dp.get_local_rank()) if dp is not None else (1, 0)
        rows = x.shape[0] // n_dp
        xs = x[i_dp * rows:(i_dp + 1) * rows].cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = moe.moe_apply(mine, cfg, xs, mesh=dm)
        torch.cuda.synchronize()
        out["moe"][mid] = dict(y=y.cpu(), dp=i_dp, model=dm["model"].get_local_rank(),
                               ms=(time.perf_counter() - t0) * 1e3)
        del mine, y
    out["seconds"]["moe"] = time.perf_counter() - t_part
    torch.save(out, out_path % rank)


def _to_device(p, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in p.items()}


def _pg_serving_inputs(ctx):
    """(c)/(h)/(i)/(j)'s inputs from phase 14's: the mesh arena's fields,
    the heads and root, the first PG_SERVE_REQUESTS requests, the first
    PG_WATCHDOG_READS of phase 15's reads-only cut and (j)'s requests (the
    same as (c)'s, PG_RESHARD_PER_ROUND arriving a round), as numpy arrays
    for the ranks; and (c)'s and (j)'s tuples."""
    import numpy as np

    tuples = ctx["tuples"][:PG_SERVE_REQUESTS]
    reads = [t for t in ctx["tuples"] if t[1] != "wiredtiger_update"][:PG_WATCHDOG_READS]
    reads = [(j, s_, q, t, PG_WATCHDOG_IDLE_ROUNDS + j // WATCHDOG_PER_ROUND, v)
             for j, (_, s_, q, t, _, v) in enumerate(reads)]

    def arr(ts):
        return np.array([(i, SERVE_KINDS.index(s_), q, TENANTS.index(t), r, v)
                         for i, s_, q, t, r, v in ts], np.int64)

    reshard = [(i, s_, q, t, j // PG_RESHARD_PER_ROUND, v)
               for j, (i, s_, q, t, _, v) in enumerate(tuples)]
    arrays = {f"serve/{f}": a for f, a in zip(("data", "bounds", "perms", "heap"),
                                             ctx["mesh_fields"])}
    arrays.update({"serve/heads": np.asarray(ctx["mheads"]), "serve/root": np.asarray(
        int(ctx["mroot"])), "serve/requests": arr(tuples), "serve/reads": arr(reads),
        "serve/reshard": arr(reshard)})
    return arrays, tuples, reshard


def _pg_reshard_gates(ranks, want, smi):
    """(j)'s gates on the world of 8's outputs against the emulated run
    ``want`` = (requests, metrics, row, digest): every request and count
    equal, one reshard, one arena digest on every rank; ranks 0-3 joined
    calls at 4 shards, then at 8, ranks 4-7 only at 8 (at least one read),
    each of them with its first offset ``pulse_chase`` launch (and
    ``pulse_commit`` call, if it ran one) == plain;
    every rank one ``pulse_chase`` launch a superstep of the reads it
    joined and one ``pulse_commit`` call a superstep of the writes.  Logs
    the rates, the cutover and the shares; returns the row."""
    rw, mw, w_row, w_digest = want
    lead = ranks[0]
    _same_requests("phase 23 (j) process group vs EmulatedMesh(4) -> 8", lead["reqs"], rw)
    if lead["counts"] != _serving_counts(mw) or lead["counts"]["reshards"] != 1:
        raise AssertionError(f"phase 23 (j): the counts differ from the emulated service's: "
                             f"{lead['counts']} vs {_serving_counts(mw)}")
    if {r["digest"] for r in ranks} != {w_digest}:
        raise AssertionError("phase 23 (j): the ranks' final arenas differ from each other or "
                             "from the emulated service's")
    launches = dict(pulse_chase=0, pulse_commit=0)
    for r in ranks:
        widths = [w for w, _, _ in r["calls"]]
        if r["rank"] < PG_RANKS:
            ok = (widths == sorted(widths) and PG_RANKS in widths
                  and PG_RESHARD_WORLD in widths and widths == [w for w, _, _ in lead["calls"]])
        else:
            ok = (widths and set(widths) == {PG_RESHARD_WORLD}
                  and any(not wr for _, wr, _ in r["calls"]))
            bad = [k for k, c in r["checks"].items() if not c["bit_equal"]]
            if "pulse_chase" not in r["checks"] or bad:
                raise AssertionError(f"phase 23 (j): rank {r['rank']}'s first offset launches "
                                     f"after the cutover ({sorted(r['checks'])}) disagree with "
                                     f"their plain versions: {bad}")
        if not ok:
            raise AssertionError(f"phase 23 (j): rank {r['rank']} joined calls of widths "
                                 f"{widths}")
        for kernel, writes in (("pulse_chase", False), ("pulse_commit", True)):
            steps = sum(n for _, wr, n in r["calls"] if wr == writes)
            if r["launches"][kernel] != steps:
                raise AssertionError(f"phase 23 (j): rank {r['rank']} launched {kernel} "
                                     f"{r['launches'][kernel]} times in {steps} supersteps")
            launches[kernel] += r["launches"][kernel]
    row = dict(lead["row"], launches=launches,
               first_launch_checks={f"{r['rank']}/{k}": c for r in ranks
                                    if r["rank"] >= PG_RANKS for k, c in r["checks"].items()},
               seconds_per_rank=[r["seconds"] for r in ranks],
               calls_per_rank=[len(r["calls"]) for r in ranks],
               emulated_requests_per_s=w_row["requests_per_s"], emulated_p50_ms=w_row["p50_ms"],
               emulated_p99_ms=w_row["p99_ms"], emulated_p999_ms=w_row["p999_ms"],
               emulated_wall_s=w_row["wall_s"])
    cut = row["cutover"]
    log(f"  (j) [{row['run']}] {row['requests']:,} requests: {row['requests_per_s']:,.0f} "
        f"requests/s, p50 {row['p50_ms']:.3f} / p99 {row['p99_ms']:.3f} / p999 "
        f"{row['p999_ms']:.3f} ms, {row['rounds']} rounds, {row['engine_calls']} engine calls, "
        f"{row['supersteps']} supersteps; the reshard asked for after "
        f"{row['reshard_after_retired']:,} retired, {row['drain_rounds']} drain rounds, the "
        f"cutover at round {cut['round']} {cut['ms']:.1f} ms (the leader's switch and install "
        f"{cut['leader_ms']:.1f} ms, {cut['bytes']:,} bytes installed on each rank of the new "
        f"group); the fabric (host-staged collectives) {100 * row['fabric_share']:.1f}% of the "
        f"run, the leader's headers and installs {100 * row['leader_share']:.1f}% "
        f"({row['leader']}); EmulatedMesh({PG_RANKS}, 'cuda') -> {PG_RESHARD_WORLD} dispatched "
        f"in this call: {row['emulated_requests_per_s']:,.0f} requests/s, p50 "
        f"{row['emulated_p50_ms']:.3f} / p99 {row['emulated_p99_ms']:.3f} / p999 "
        f"{row['emulated_p999_ms']:.3f} ms; {smi}")
    log(f"  (j) == EmulatedMesh({PG_RANKS}) -> {PG_RESHARD_WORLD} request by request and in every "
        f"count (one reshard), every rank's final arena the same; ranks 0-3 joined calls at 4 "
        f"then at 8 shards, ranks 4-7 only at 8, each one's first offset launches after the "
        f"cutover == plain ({sorted(ranks[-1]['checks'])}); one pulse_chase launch a read "
        f"superstep ({launches['pulse_chase']})"
        f" and one pulse_commit call a write superstep ({launches['pulse_commit']}) on every "
        f"rank; calls joined a rank {row['calls_per_rank']}")
    return row


def phase_memory_nodes(rng, smi, serving_ctx):
    """Phase 23, memory nodes as processes (items 6(e), 2 and 3 of queue
    1): P = 4 ranks of one Gloo process group on ``cuda:0`` (spawned, a
    loopback TCP store), each running ``distributed_execute`` on a
    ``ProcessGroupMesh`` over its own rows and pool (``pulse_chase`` and
    ``pulse_commit`` launched over one shard), held bit for bit against
    ``EmulatedMesh(4, "cuda")`` in this process: records, ``RoutingStats``
    and the committed arena's digest; (a) replicated reads (the replica
    window over each rank's holder slice), (b) a kill, (c) phase 14's
    service with rank 0 serving and the others following, (h) its durable
    failover and (i) its watchdog; then Granite's MoE layer at full width
    on the expert-parallel path against the single-rank ``moe_apply``; then
    (j), the live reshard from ranks 0-3 to all of a world of 8 of its own
    (``_pg_reshard_rank``, ``_pg_reshard_gates``).  The rates are those of
    a host-staged fabric (Gloo on one card)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config, pulse_paper
    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.faults import FaultInjector, FaultPlan, ShardFailure
    from repro_torch.distributed import world
    from repro_torch.distributed.arena_ft import (
        ArenaStore,
        FaultToleranceConfig,
        ReplicationConfig,
    )
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    inputs, checks = _pg_inputs(rng)
    serve_arrays, serve_tuples, reshard_tuples = _pg_serving_inputs(serving_ctx)
    rows, launches = [], dict(pulse_chase=0, pulse_commit=0)
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        in_path = Path(tmp) / "inputs.npz"
        # the emulated mesh on the card, each run's first call and a timed second
        t_part = time.perf_counter()
        want = {}
        for name, fabric in PG_RUNS:
            fields, p0, s0 = inputs[name]
            ar = arena_from_numpy(*fields, device="cuda")
            it = _pg_iterator(name, pulse_paper.WEBSERVICE.n_buckets)
            run = dict(PG_RUN_ARGS, fabric=fabric)
            mesh = routing.EmulatedMesh(PG_RANKS, "cuda")
            got = routing.distributed_execute(it, ar, torch.from_numpy(p0).cuda(),
                                              torch.from_numpy(s0).cuda(), mesh=mesh, **run)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routing.distributed_execute(it, ar, torch.from_numpy(p0).cuda(),
                                        torch.from_numpy(s0).cuda(), mesh=mesh, **run)
            torch.cuda.synchronize()
            want[f"{name}/{fabric}"] = dict(
                records=got[0].cpu().numpy(), stats=got[1], seconds=time.perf_counter() - t0,
                digest=_digest(got[2]) if len(got) == 3 else None)
            if name in checks:
                S = it.scratch_words
                bad, _ = checks[name](got[0][:, routing.F_STATUS].cpu().numpy(),
                                      got[0][:, routing.F_SCRATCH:routing.F_SCRATCH + S]
                                      .cpu().numpy())
                if bad:
                    raise AssertionError(f"phase 23 {name}: {'; '.join(bad)}")
            del ar, got
        # (a) on the emulated mesh: the same cut, plans and dead sets
        want_rep = {}
        for name in ("webservice", "wiredtiger"):
            fields, p0, s0 = inputs[name]
            ar = arena_from_numpy(*fields, device="cuda")
            it = _pg_iterator(name, pulse_paper.WEBSERVICE.n_buckets)
            B = p0.shape[0] // PG_REP_CUT
            rep_rows = torch.from_numpy(_pg_replica_rows(fields[0], fields[1])).cuda()
            healthy = routing.distributed_execute(
                it, ar, torch.from_numpy(p0[:B]).cuda(), torch.from_numpy(s0[:B]).cuda(),
                mesh=routing.EmulatedMesh(PG_RANKS, "cuda"), **PG_RUN_ARGS)[0]
            for policy, dead in PG_REP_CASES:
                mask = torch.zeros(PG_RANKS, dtype=torch.bool, device="cuda")
                mask[list(dead)] = True
                ctx = routing.ReplicaContext(routing.make_replica_plan(PG_RANKS, policy=policy),
                                             rep_rows, mask)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec, st = routing.distributed_execute(
                    it, ar, torch.from_numpy(p0[:B]).cuda(), torch.from_numpy(s0[:B]).cuda(),
                    mesh=routing.EmulatedMesh(PG_RANKS, "cuda"), replication=ctx, **PG_RUN_ARGS)
                torch.cuda.synchronize()
                cols = [routing.F_PTR, routing.F_STATUS, routing.F_ITERS]
                if not (torch.equal(rec[:, cols], healthy[:, cols]) and torch.equal(
                        rec[:, routing.F_SCRATCH:], healthy[:, routing.F_SCRATCH:])):
                    raise AssertionError(f"phase 23 (a) {name} {policy} {dead}: the replicated "
                                         "run's payload differs from the healthy run's")
                want_rep[f"{name}/{policy}{list(dead)}"] = dict(
                    records=rec.cpu().numpy(), stats=st, seconds=time.perf_counter() - t0)
            if name == "webservice":
                # the windowed offset launch alone, timed: holder 3's pool over its own
                # rows and holder slice with shard 1 dead (failover), beside the
                # whole-arena windowed launch of the same pools
                mask = torch.zeros(PG_RANKS, dtype=torch.bool, device="cuda")
                mask[1] = True
                plan = routing.make_replica_plan(PG_RANKS, policy="failover")
                window = window_offset_vs_plain(
                    ar, it, torch.from_numpy(p0).cuda(), torch.from_numpy(s0).cuda(), PG_RANKS,
                    (rep_rows, torch.tensor(plan.primary_map, dtype=torch.int32, device="cuda"),
                     mask, "failover"), shard=3)
                if not window["bit_equal"]:
                    raise AssertionError(f"phase 23: the windowed offset launch disagrees: "
                                         f"{window}")
                log(f"  the windowed offset launch (webservice, hash_find; holder 3's pool of "
                    f"{window['pool_records']:,} records, {window['active_records']:,} active, "
                    f"over its {window['rows']:,} rows and holder slice, shard 1 dead): "
                    f"{window['ms']:.5f} ms ({window['ms_source']}), plain "
                    f"{window['plain_ms']:.3f} ms, bound {window['bound_ms']:.5f} ms; the "
                    f"whole-arena windowed launch of the same pools {window['whole_ms']:.5f} ms;"
                    f" == plain and the whole launch's part; {smi}")
            del ar, rep_rows, healthy
        # (b) on the emulated mesh
        fields, p0, s0 = inputs["webservice_rw"]
        ar = arena_from_numpy(*fields, device="cuda")
        try:
            routing.distributed_execute(
                _pg_iterator("webservice_rw", pulse_paper.WEBSERVICE.n_buckets), ar,
                torch.from_numpy(p0).cuda(), torch.from_numpy(s0).cuda(),
                mesh=routing.EmulatedMesh(PG_RANKS, "cuda"),
                fault_injector=FaultInjector(FaultPlan(**PG_KILL)), **PG_RUN_ARGS)
            want_kill = None
        except ShardFailure as e:
            want_kill = (e.shard, e.superstep)
        del ar
        # (c) and (h) on the emulated mesh, dispatched: (c)'s call log picks
        # (h)'s kill, the read quantum nearest the middle
        specs = serving_specs(serving_ctx["mheads"], serving_ctx["mroot"], "cuda")
        mfields = serving_ctx["mesh_fields"]
        c_extra = {}
        rc, mc, ec, c_row = serve_run("c: EmulatedMesh(4), sync, dispatched",
                                      arena_from_numpy(*mfields, device="cuda"), specs,
                                      serve_tuples, P=PG_RANKS, schedule="dispatched",
                                      extra=c_extra)
        _check_against_oracle("phase 23 (c) emulated", rc, serving_ctx["heap"])
        kill_call = _pick_call(c_extra["kinds"], "r")
        serve_arrays["serve/kill_call"] = np.asarray(kill_call)
        store = ArenaStore(Path(tmp) / "h_emulated")
        rh, mh, eh, h_row = serve_run(
            "h: EmulatedMesh(4), failover, kill shard 2", arena_from_numpy(*mfields, device="cuda"),
            specs, serve_tuples, P=PG_RANKS, schedule="dispatched",
            fault_plan=FaultPlan(kill_shard=2, kill_call=kill_call, kill_superstep=2),
            fault_tolerance=FaultToleranceConfig(
                store=store, snapshot_every=FT_SNAPSHOT_EVERY, dead_rounds=6,
                replication=ReplicationConfig(policy="failover")))
        store.close()
        if mh.recoveries != 1 or mh.failover_quanta < 1:
            raise AssertionError(f"phase 23 (h) emulated: {mh.recoveries} recoveries, "
                                 f"{mh.failover_quanta} failover quanta")
        # (j) on the emulated mesh: 4 -> 8 once a third retired, dispatched
        rj, mj, ej, j_row = serve_run(
            f"j: EmulatedMesh({PG_RANKS}) -> {PG_RESHARD_WORLD}, sync, dispatched",
            arena_from_numpy(*mfields, device="cuda"), specs, reshard_tuples, P=PG_RANKS,
            schedule="dispatched", reshard_at=len(reshard_tuples) // 3)
        if mj.reshards != 1 or ej.arena.num_shards != PG_RESHARD_WORLD:
            raise AssertionError(f"phase 23 (j) emulated: {mj.reshards} reshards, "
                                 f"{ej.arena.num_shards} shards")
        _check_against_oracle("phase 23 (j) emulated", rj, serving_ctx["heap"])
        want_serve = dict(c=(rc, mc, c_row, _digest(ec.arena)), h=(rh, mh, h_row, _digest(eh.arena)),
                          j=(rj, mj, j_row, _digest(ej.arena)))
        del ec, eh, ej
        seconds["emulated runs"] = time.perf_counter() - t_part
        cfg = get_config(MOE_EP_ARCH)
        p = _to_device(moe.moe_init(torch.Generator().manual_seed(0), cfg), "cuda")
        x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator().manual_seed(1)).cuda()
        moe_want = {1: moe.moe_apply(p, cfg, x).cpu(),
                    2: torch.cat([moe.moe_apply(p, cfg, h) for h in x.chunk(2)]).cpu()}
        del p, x
        torch.cuda.empty_cache()
        np.savez(in_path, **{f"{name}/{f}": a for name, (fields, p0, s0) in inputs.items()
                             for f, a in zip(("data", "bounds", "perms", "heap", "p0", "s0"),
                                             (*fields, p0, s0))}, **serve_arrays)

        t0 = time.perf_counter()
        world_s = world.spawn(_pg_rank, PG_RANKS, (str(in_path), str(Path(tmp) / "rank%d.pt")),
                              timeout=PG_TIMEOUT)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(PG_RANKS)]
        # (j): a world of its own, rank 0 serving on ranks 0-3 until the cutover
        reshard_world_s = world.spawn(_pg_reshard_rank, PG_RESHARD_WORLD,
                                      (str(in_path), str(Path(tmp) / "reshard%d.pt")),
                                      timeout=PG_TIMEOUT)
        seconds["j: the world of 8"] = reshard_world_s
        reshard_ranks = [torch.load(Path(tmp) / f"reshard{r}.pt", weights_only=False)
                         for r in range(PG_RESHARD_WORLD)]
    for key, w in want.items():
        name, fabric = key.split("/")
        B = w["records"].shape[0]
        secs, fabric_s, steps = [], [], w["stats"].supersteps
        for r in ranks:
            g = r["runs"][key]
            if not np.array_equal(g["records"], w["records"]):
                raise AssertionError(f"phase 23 {key}: rank {r['rank']}'s records differ from "
                                     f"the emulated mesh's")
            diff = _stats_diff(g["stats"], w["stats"])
            if diff:
                raise AssertionError(f"phase 23 {key}: rank {r['rank']}'s RoutingStats differ "
                                     f"on {diff}")
            if g.get("digest") != w["digest"]:
                raise AssertionError(f"phase 23 {key}: rank {r['rank']}'s committed arena "
                                     f"differs from the emulated mesh's")
            if not g["same_again"]:
                raise AssertionError(f"phase 23 {key}: rank {r['rank']}'s second call differs")
            for kernel, c in g["checks"].items():
                if not c["bit_equal"]:
                    raise AssertionError(f"phase 23 {key}: rank {r['rank']}'s first {kernel} "
                                         f"launch over its shard disagrees with its plain "
                                         f"version")
            want_checks = {"pulse_chase"} if name not in ("webservice_rw", "wiredtiger_update") \
                else {"pulse_commit"}
            if set(g["checks"]) != want_checks:
                raise AssertionError(f"phase 23 {key}: rank {r['rank']} checked "
                                     f"{sorted(g['checks'])}, expected {sorted(want_checks)}")
            kernel = next(iter(want_checks))
            if g["launches"][kernel] != steps:
                raise AssertionError(f"phase 23 {key}: rank {r['rank']} launched {kernel} "
                                     f"{g['launches'][kernel]} times in {steps} supersteps")
            for k in launches:
                launches[k] += g["launches"][k]
            secs.append(g["seconds"])
            fabric_s.append(g["fabric_s"])
        wall = max(secs)
        writes = name in ("webservice_rw", "wiredtiger_update")
        row = dict(run=key, lanes=B, supersteps=steps,
                   local_only_steps=w["stats"].local_only_steps,
                   wire_words=w["stats"].total_wire_words, seconds_per_rank=secs,
                   fabric_s_per_rank=fabric_s, rate=B / wall,
                   rate_unit="write ops/s" if writes else "lookups/s",
                   emulated_seconds=w["seconds"], emulated_rate=B / w["seconds"],
                   ms_per_superstep=wall * 1e3 / steps,
                   fabric_share=float(np.mean([f / s for f, s in zip(fabric_s, secs)])),
                   collectives_per_rank=ranks[0]["runs"][key]["collectives"],
                   first_superstep_checks={r["rank"]: r["runs"][key]["checks"] for r in ranks},
                   launches={k: sum(r["runs"][key]["launches"][k] for r in ranks)
                             for k in launches})
        rows.append(row)
        log(f"[{key}] P={PG_RANKS} ranks (Gloo, cuda:0; {smi}): {row['rate']:.6g} "
            f"{row['rate_unit']} (the slowest rank's timed call, {wall:.4f} s) vs "
            f"{row['emulated_rate']:.6g} on EmulatedMesh({PG_RANKS}, 'cuda') in this call; "
            f"{steps} supersteps ({row['local_only_steps']} local-only), "
            f"{row['ms_per_superstep']:.3f} ms a superstep, the fabric (host-staged "
            f"collectives) {100 * row['fabric_share']:.1f}% of it; every rank == the "
            f"emulated mesh (records, RoutingStats"
            + (", the committed arena" if writes else "") + "); the first offset launch == "
            "its plain version on every rank")

    # (a) replicated reads: every rank == the emulated mesh; one windowed
    # offset launch a superstep on every rank, the first of each batch == plain
    rep_rows, window_launches, window_checks = [], 0, {}
    for key, w in want_rep.items():
        steps = w["stats"].supersteps
        secs = []
        for r in ranks:
            g = r["rep"][key]
            if not np.array_equal(g["records"], w["records"]):
                raise AssertionError(f"phase 23 (a) {key}: rank {r['rank']}'s records differ "
                                     "from the emulated mesh's")
            diff = _stats_diff(g["stats"], w["stats"])
            if diff:
                raise AssertionError(f"phase 23 (a) {key}: rank {r['rank']}'s RoutingStats "
                                     f"differ on {diff}")
            if g["launches"] != steps:
                raise AssertionError(f"phase 23 (a) {key}: rank {r['rank']} launched "
                                     f"pulse_chase {g['launches']} times in {steps} supersteps")
            window_launches += g["launches"]
            secs.append(g["seconds"])
        B = w["records"].shape[0]
        rep_rows.append(dict(run=key, lanes=B, supersteps=steps, rate=B / max(secs),
                             emulated_rate=B / w["seconds"], seconds_per_rank=secs))
    for name in ("webservice", "wiredtiger"):
        for r in ranks:
            c = r["rep"][f"{name}/window_check"]
            if c is None or not c["bit_equal"]:
                raise AssertionError(f"phase 23 (a) {name}: rank {r['rank']}'s first windowed "
                                     f"offset launch of pulse_chase disagrees with its plain "
                                     f"version ({c})")
            window_checks.setdefault(name, {})[r["rank"]] = c
    log(f"  (a) replicated reads, R = 2 (make_replica_plan(4)), on each read batch's first "
        f"1/{PG_REP_CUT} ({rep_rows[0]['lanes']:,} queries): "
        + "; ".join(f"{x['run']} {x['rate']:.6g} lookups/s ({x['supersteps']} supersteps; "
                    f"emulated {x['emulated_rate']:.6g})" for x in rep_rows)
        + f"; every rank == EmulatedMesh(4, 'cuda') in records and RoutingStats; "
          f"{window_launches} windowed offset launches of pulse_chase (one a superstep on "
          f"each rank), each rank's first of each batch == its plain version; {smi}")

    # (b) the kill
    for r in ranks:
        k = r["kill"]
        if k["raised"] != tuple(want_kill or ()) or want_kill != (2, 3) or not k["unchanged"]:
            raise AssertionError(f"phase 23 (b): rank {r['rank']} raised {k['raised']} "
                                 f"(emulated {want_kill}), arena unchanged {k['unchanged']}")
    log(f"  (b) webservice_rw with shard 2 killed before superstep 3: every rank raised "
        f"ShardFailure(2, 3), as the emulated mesh did; every rank's arena unchanged")

    # (c), (h), (i): the service on rank 0, the others following
    serve_rows = {}
    for tag in ("c", "h"):
        rw, mw, w_row, w_digest = want_serve[tag]
        got = ranks[0]["serve"][tag]
        _same_requests(f"phase 23 ({tag}) process group vs EmulatedMesh(4)", got["reqs"], rw)
        if got["counts"] != _serving_counts(mw):
            raise AssertionError(f"phase 23 ({tag}): the counts differ from the emulated "
                                 f"service's: {got['counts']} vs {_serving_counts(mw)}")
        digests = [r["serve"][tag]["digest"] for r in ranks]
        if set(digests) != {w_digest}:
            raise AssertionError(f"phase 23 ({tag}): the ranks' final arenas differ from each "
                                 f"other or from the emulated service's")
        row = got["row"]
        row.update(emulated_requests_per_s=w_row["requests_per_s"], emulated_p99_ms=w_row["p99_ms"],
                   emulated_p50_ms=w_row["p50_ms"], emulated_p999_ms=w_row["p999_ms"],
                   emulated_wall_s=w_row["wall_s"])
        serve_rows[tag] = row
    h = ranks[0]["serve"]["h"]
    if not h["standby_same"] or len(h["recoveries"]) != 1:
        raise AssertionError(f"phase 23 (h): standby == primary {h['standby_same']}, "
                             f"{len(h['recoveries'])} recoveries")
    if not torch.equal(h["data"], ranks[0]["serve"]["c"]["data"]):
        raise AssertionError("phase 23 (h): the final data differs from (c)'s: an acknowledged "
                             "commit was lost")
    serve_rows["h"].update(standby=h["standby"], recoveries=h["recoveries"])
    i = ranks[0]["serve"]["i"]
    im = i["counts"]
    if (i["suspected"] != [1] or im["watchdog_suspects"] != 1 or im["failover_quanta"] < 1
            or im["retries"] or im["recoveries"]):
        raise AssertionError(f"phase 23 (i): suspected {i['suspected']}, {im['watchdog_suspects']}"
                             f" suspects, {im['failover_quanta']} failover quanta, "
                             f"{im['retries']} retries, {im['recoveries']} recoveries")
    _check_against_oracle("phase 23 (i)", i["reqs"], serving_ctx["heap"], updates=False)
    if len({r["serve"]["i"]["digest"] for r in ranks}) != 1:
        raise AssertionError("phase 23 (i): the ranks' arenas differ")
    serve_rows["i"] = dict(i["row"], healthy_probe=i["healthy_probe"],
                           watchdog_timeout_s=i["watchdog_timeout_s"], delay_s=i["delay_s"],
                           probe_launches=i["probe_launches"], suspected=i["suspected"])
    for tag, r in serve_rows.items():
        log(f"  ({tag}) [{r['run']}] {r['requests']:,} requests: {r['requests_per_s']:,.0f} "
            f"requests/s, p50 {r['p50_ms']:.3f} / p99 {r['p99_ms']:.3f} / p999 "
            f"{r['p999_ms']:.3f} ms, {r['rounds']} rounds, {r['engine_calls']} engine calls, "
            f"{r['supersteps']} supersteps; the fabric (host-staged collectives) "
            f"{100 * r['fabric_share']:.1f}% of the run, the leader's headers and installs "
            f"{100 * r['leader_share']:.1f}% ({r['leader']})"
            + (f"; EmulatedMesh(4, 'cuda') dispatched in this call: "
               f"{r['emulated_requests_per_s']:,.0f} requests/s, p50 {r['emulated_p50_ms']:.3f}"
               f" / p99 {r['emulated_p99_ms']:.3f} / p999 {r['emulated_p999_ms']:.3f} ms"
               if "emulated_requests_per_s" in r else "") + f"; {smi}")
    log(f"  (c) == EmulatedMesh(4) request by request (status, iters, result, rounds) and in "
        f"every count, every rank's final arena == the emulated one's ({len(serve_tuples):,} "
        f"of phase 14's {len(serving_ctx['tuples']):,} requests)")
    log(f"  (h) kill of shard 2 at call {int(serve_arrays['serve/kill_call'])} (a read quantum): "
        f"== EmulatedMesh(4) request by request and in every count (1 recovery, "
        f"{serve_rows['h']['failover_quanta']} failover quanta, "
        f"{serve_rows['h']['replica_quanta']} write quanta shipped, the standby "
        f"{h['standby']['mean_ms']:.1f} ms a quantum), data == (c)'s, the standby == the "
        f"primary, every rank's arena the same")
    log(f"  (i) healthy probe mean {i['healthy_probe']['mean_ms']:.3f} / max "
        f"{i['healthy_probe']['max_ms']:.3f} ms; timeout {1e3 * i['watchdog_timeout_s']:.1f} ms,"
        f" shard 1 delayed {1e3 * i['delay_s']:.1f} ms a superstep on rank 1 alone: suspected "
        f"{i['suspected']} ({im['watchdog_probes']} probes, {i['probe_launches']} pulse_chase "
        f"launches), {im['failover_quanta']} failover quanta, 0 retries, 0 recoveries, reads "
        f"== ref_find")

    reshard_row = _pg_reshard_gates(reshard_ranks, want_serve["j"], smi)

    moe_rows = {}
    for mid, shape, names in MOE_EP_MESHES:
        n_dp = shape[0] if "data" in names else 1
        ref = moe_want[n_dp]
        errs = []
        for r in ranks:
            m = r["moe"][mid]
            part = ref.chunk(n_dp)[m["dp"]]
            errs.append(float((m["y"] - part).abs().max()))
        scale = float(ref.abs().max())
        err = max(errs)
        moe_rows[mid] = dict(mesh=dict(zip(names, shape)), max_abs_err=err, scale=scale,
                             tol=MOE_EP_TOL * scale, ms_per_rank=[r["moe"][mid]["ms"]
                                                                  for r in ranks])
        log(f"[moe {mid}] {MOE_EP_ARCH} layer at full width (d 1024, 32 experts of d_ff 512, "
            f"top-8) over 4 x 512 tokens, {dict(zip(names, shape))}: max |EP - single rank| "
            f"{err:.3g} against {MOE_EP_TOL:g} x {scale:.4g} (the largest magnitude); "
            f"{[round(r['moe'][mid]['ms'], 1) for r in ranks]} ms a rank")
        if err > MOE_EP_TOL * scale:
            raise AssertionError(f"phase 23 moe {mid}: the expert-parallel layer is {err:.3g} "
                                 f"off the single rank's, over {MOE_EP_TOL:g} of {scale:.4g}")
    seconds.update({f"world: {k}": v for k, v in ranks[0]["seconds"].items()})
    secs = time.perf_counter() - t_phase
    log(f"  phase 23 took {secs:.1f} s (the world {world_s:.1f} s of it, its start included; "
        f"{time.perf_counter() - t0:.1f} s from its spawn); by part "
        + ", ".join(f"{k}: {v:.1f} s" for k, v in seconds.items()))
    out = dict(phase="memory_nodes", seconds=secs, world_s=world_s, card=smi, runs=rows,
               moe=moe_rows, launches=launches, replicated=rep_rows,
               window_launches=window_launches, window_checks=window_checks,
               window_offset=window, kill=dict(raised=want_kill), serving=serve_rows,
               reshard=reshard_row, part_seconds=seconds)
    log(json.dumps(out, default=str))
    return out


def phase_paged_decode(params):
    """Paged decode at full width on one prefill's K/V."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_reference
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.kv_cache import PagedKVCache

    cfg = get_config("qwen3_0_6b")
    L, H, Hk, D, page, B, T = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 16, 4, 512
    lengths = [512, 509, 500, 487]
    reqs = serve.make_requests(cfg, B, T, 1)
    toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).cuda()
    with torch.no_grad():
        _, kv = build_model(cfg).prefill(params, {"tokens": toks}, T)
    n_pages = sum(-(-n // page) for n in lengths) + 1
    cache = PagedKVCache(cfg, n_pages=n_pages, page_size=page, max_batch=B, device="cuda")
    t0 = time.perf_counter()
    for t in range(T):
        active = np.array([t < n for n in lengths])
        for b in np.flatnonzero(active):
            cache.ensure_capacity(int(b), t + 1)
        cache.write_token((kv["k"][:, :, t], kv["v"][:, :, t]), active=active)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    max_pages = -(-max(lengths) // page)
    t0 = time.perf_counter()
    pt, ln = cache.walk_page_tables(max_pages)
    torch.cuda.synchronize()
    walk_ms = (time.perf_counter() - t0) * 1e3
    if ln.tolist() != lengths or not pt.is_cuda:
        raise AssertionError("paged decode: walked lengths differ")
    for b in range(B):  # the walk against the host's chains
        want, p = [], int(cache.heads[b])
        while p != -1:
            want.append(int(cache.builder.data[p, 0]))
            p = int(cache.builder.data[p, 1])
        if pt[b, :len(want)].tolist() != want:
            raise AssertionError(f"paged decode: walked page table of slot {b} differs")

    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, H, D), generator=gen, device="cuda")
    ops.paged_attention.launches = 0
    errs, dense_errs = [], []
    for layer in range(L):
        got = ops.paged_attention(q, cache.k_pages[layer], cache.v_pages[layer], pt, ln)
        want = ref.paged_attention_reference(q, cache.k_pages[layer], cache.v_pages[layer],
                                             pt, ln)
        ok, err = _close(got, want, "float32")
        for b, n in enumerate(lengths):
            kd = kv["k"][layer, b, :n].transpose(0, 1)[None]  # (1, Hk, n, D)
            vd = kv["v"][layer, b, :n].transpose(0, 1)[None]
            dense = mha_reference(q[b][None, :, None], kd, vd, causal=False)[0, :, 0]
            ok_d, err_d = _close(got[b], dense, "float32")
            ok, dense_errs = ok and ok_d, dense_errs + [err_d]
        errs.append(err)
        if not ok:
            raise AssertionError(f"paged decode: layer {layer} disagrees "
                                 f"(plain {err:.3g}, dense {max(dense_errs):.3g})")
    torch.cuda.synchronize()
    launches = ops.paged_attention.launches
    if launches != L:
        raise AssertionError(f"paged decode: {launches} kernel launches for {L} layers")
    # the decode step's order: every layer once, each layer's pages cold
    sweep = [lambda i=i: ops.paged_attention(q, cache.k_pages[i], cache.v_pages[i], pt, ln)
             for i in range(L)]
    events_ms = time_cuda_rotating(sweep, 10)
    device_ms = kernel_device_ms(sweep, 5, "paged_decode")
    ms = events_ms if device_ms is None else device_ms
    flops, nbytes = paged_work(H, Hk, D, lengths, B, pt.shape[1])
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(layers=L, lengths=lengths, page=page, launches=launches,
               max_abs_err=max(errs), dense_max_abs_err=max(dense_errs), ms_per_layer=ms,
               ms_source="events" if device_ms is None else "profiler",
               ms_per_layer_events=events_ms,
               bound_ms_per_layer=bound_ms, bound_by=bound_by, write_s=write_s,
               walk_ms=walk_ms)
    log(f"  paged decode: {L} layers, lengths {lengths}, launches {launches}, max_abs_err "
        f"{max(errs):.3g} (dense {max(dense_errs):.3g}), kernel {ms:.4f} ms/layer "
        f"({row['ms_source']}; CUDA events {events_ms:.4f}) "
        f"(bound {bound_ms:.5f}), write {write_s:.2f} s, walk {walk_ms:.1f} ms")
    log(json.dumps({"phase": "paged_decode", **row}))
    return row


def native_bodies(checks, rows, write_rows, skip_body):
    """Each native body of ``pulse_chase``: its checks against the plain
    version (phase 2), its launches on the main paths (phases 3 and 10) and,
    where a full-depth launch was timed, its time beside its bound."""
    from repro_torch.kernels.pulse_chase import kernel

    out = []
    for name in kernel.NATIVE_BODIES:
        errs = [c["max_abs_err"] for c in checks if c["body"] == f"{name} (native)"]
        timed = [r for r in rows if r["body"] == name]
        timed = [r for r in timed if not r["arena_in_l2"]] or timed
        row = dict(name=name, checks=len(errs), max_abs_err=max(errs) if errs else None,
                   launches=sum(r["launches"] for r in rows if r["body"] == name)
                   + sum(w["readback_launches"] for w in write_rows
                         if w["readback_body"] == name),
                   ms=None, plain_ms=None, bound_ms=None, timed_on=None)
        if timed:
            r = timed[0]
            row.update(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                       timed_on=f"{r['workload']}, full depth ({r['full_depth_steps']} steps)")
        elif skip_body is not None and skip_body["name"] == name:
            row.update(ms=skip_body["ms"], plain_ms=skip_body["plain_ms"],
                       bound_ms=skip_body["bound_ms"],
                       timed_on=f"skiplist_rw read-back, {skip_body['lanes']} lanes, full "
                                f"depth ({skip_body['full_depth_steps']} steps)")
        out.append(row)
    return out


# ------------------------ training across processes -------------------------

# phase 24 (a): launch.train.main on a world of MH_WORLD Gloo ranks on the
# card, started as torchrun starts them (the launcher's variables set), each
# rank MH_BATCH / MH_WORLD rows of every global batch
MH_WORLD, MH_STEPS, MH_BATCH, MH_SEQ = 2, 4, 8, 512
MH_ARGS = ["--arch", "qwen3_0_6b", "--steps", str(MH_STEPS), "--batch", str(MH_BATCH),
           "--seq", str(MH_SEQ), "--lr", "1e-3", "--log-every", "1"]
MH_TIMEOUT = 300.0
# (b): the dry run's cells whose collectives phase 24 records at full width
DRY_CELLS = (("qwen3_0_6b", "train_4k"), ("mamba2_780m", "prefill_32k"))
# (c): a train step sharded as DTensors on a real (data 2, model 2) mesh of
# SHARDED_WORLD Gloo ranks on the card, at full width and SHARDED_DEPTH
# layers, against the unsharded step (loss and parameters within
# SHARDED_TOL of the largest magnitude)
SHARDED_WORLD, SHARDED_DEPTH, SHARDED_BATCH, SHARDED_SEQ = 4, 2, 4, 512
SHARDED_TOL = 1e-5
# torch.distributed's collectives, each counted by _CollectiveSpy
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
                    "barrier", "all_gather_object", "broadcast_object_list", "gather",
                    "scatter", "reduce", "send", "recv", "isend", "irecv")


class _CollectiveSpy:
    """While active, counts the calls of every collective of
    ``torch.distributed`` (``DIST_COLLECTIVES``, on the package and on its
    ``distributed_c10d`` module) in ``n``."""

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        self.n, self._saved = 0, []
        for mod in (dist, distributed_c10d):
            for name in DIST_COLLECTIVES:
                fn = getattr(mod, name, None)
                if fn is None:
                    continue

                def counted(*a, _fn=fn, **kw):
                    self.n += 1
                    return _fn(*a, **kw)

                self._saved.append((mod, name, fn))
                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _mh_rank(rank, world_size, out_dir):
    """One rank of phase 24 (a): ``launch.train.main`` (which joins the
    group from the launcher's variables), the collectives inside its loop
    counted; then the plain route's first step (``attn_backend``
    "chunked", remat full) from the same seeded weights on this rank's rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training import train_loop

    spied, run = [], train_loop.TrainLoop.run

    def counted_run(self, *a, **kw):
        with _CollectiveSpy() as spy:
            out = run(self, *a, **kw)
        spied.append(spy.n)
        return out

    train_loop.TrainLoop.run = counted_run
    torch.cuda.reset_peak_memory_stats()
    flash_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    log_k = train.main(MH_ARGS)
    wall_s = time.perf_counter() - t0
    launches = flash_ops.flash_attention.launches
    train_loop.TrainLoop.run = run
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    args = train.parser().parse_args(MH_ARGS)
    cfg = get_config("qwen3_0_6b").replace(remat="full", attn_backend="chunked")
    model = build_model(cfg)
    tcfg = train.train_config(cfg, args)
    data = train.data_iterator(cfg, args, "cuda", num_hosts=world_size, host_id=rank)
    state = train_loop.init_state(model, tcfg, torch.Generator(device="cuda").manual_seed(
        args.seed))
    _, log_p = train_loop.TrainLoop(model, tcfg, data).run(state, 0, 1)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, losses=[r["loss"] for r in log_k], step_ms=[r["dt"] * 1e3 for r in log_k],
        plain_loss0=log_p[0]["loss"], flash_launches=launches, loop_collectives=spied,
        peak_gb=peak_gb, wall_s=wall_s)))


GLOO_PROBES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
               "all_to_all_single")  # DTensor's collectives in a train step


def _gloo_probe_rank(rank, world_size, name, out_dir):
    """One rank of phase 24 (c)'s probe of collective ``name``: DTensor's
    redistribute that issues it, once, on CUDA tensors over a 1-D mesh of
    the world's Gloo ranks on the card; writes "ok" or what it raised."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    torch.cuda.set_device(0)
    dm = init_device_mesh("cuda", (world_size,), mesh_dim_names=("x",))
    x = torch.arange(64.0, device="cuda").reshape(8, 8)
    try:
        if name == "all_gather_into_tensor":
            distribute_tensor(x, dm, [Shard(0)], src_data_rank=None).full_tensor()
        elif name == "all_to_all_single":
            distribute_tensor(x, dm, [Shard(0)], src_data_rank=None).redistribute(
                dm, [Shard(1)]).to_local()
        else:
            want = Shard(0) if name == "reduce_scatter_tensor" else Replicate()
            DTensor.from_local(x, dm, [Partial()]).redistribute(dm, [want]).to_local()
        torch.cuda.synchronize()
        result = "ok"
    except Exception as e:  # noqa: BLE001 -- the finding: what Gloo raises
        result = f"{type(e).__name__}: {str(e)[:300]}"
    Path(out_dir, f"{name}.rank{rank}").write_text(result)


def _gloo_cuda_findings(tmp):
    """GLOO_PROBES in turn, each in a world of 2 Gloo ranks of its own (a
    collective that crashes its processes ends only its world), up to the
    first that Gloo does not take -> {name: "ok", what it raised, or how
    its world ended}; the probes after that one are left out."""
    from repro_torch.distributed import world

    found = {}
    for name in GLOO_PROBES:
        out = Path(tmp, name)
        out.mkdir()
        try:
            world.spawn(_gloo_probe_rank, 2, (name, str(out)), timeout=MH_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            found[name] = f"the world ended: {str(e)[:300]}"
            break
        results = {Path(out, f"{name}.rank{r}").read_text() for r in range(2)}
        found[name] = "ok" if results == {"ok"} else " / ".join(sorted(results - {"ok"}))
        if found[name] != "ok":
            break
    return found


def _sharded_setup():
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_test_mesh

    cfg = get_config("qwen3_0_6b").replace(n_layers=SHARDED_DEPTH)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=SHARDED_SEQ,
                                global_batch=SHARDED_BATCH)
    return cfg, shape, make_test_mesh((2, 2))


def _sharded_rank(rank, world_size, out_dir):
    """One rank of phase 24 (c): the train step sharded as DTensors on the
    real mesh (its collectives recorded), and on rank 0 the unsharded step
    beside it."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.checkpoint import tree_leaves
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_step, distribute_step_args

    torch.cuda.set_device(0)
    cfg, shape, mesh = _sharded_setup()
    dm = init_device_mesh("cuda", mesh.axis_sizes, mesh_dim_names=mesh.axis_names)
    step, args, in_sh = build_step(cfg, shape, mesh, device="cuda", device_mesh=dm)
    args = distribute_step_args(args, in_sh, dm)
    torch.cuda.synchronize()
    flash_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    with dryrun.CollectiveRecorder(dm) as rec, implicit_replication():
        state, metrics = step(*args)
    torch.cuda.synchronize()
    out = dict(rank=rank, step_s=time.perf_counter() - t0, records=rec.records,
               flash_launches=flash_ops.flash_attention.launches)
    loss = float(metrics["loss"].full_tensor())
    params = [p.full_tensor() for p in tree_leaves(state["params"])]
    out["loss"] = loss
    if rank == 0:  # the unsharded step on the same seeded arguments
        step, args, _ = build_step(cfg, shape, mesh, device="cuda")
        want_state, want = step(*args)
        w_loss = float(want["loss"])
        out["loss_rel_err"] = abs(loss - w_loss) / max(1.0, abs(w_loss))
        out["param_rel_err"] = max(
            float((g.float() - w.float()).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(params, tree_leaves(want_state["params"])))
        out["unsharded_loss"] = w_loss
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def phase_multihost(smi):
    """Phase 24: training across processes (ROADMAP queue 1, items 4-5):
    (a) ``launch.train.main`` on MH_WORLD Gloo ranks of the card; (b) the
    dry run's collective records of DRY_CELLS at full width on the meta
    device; (c) a train step sharded as DTensors on a real Gloo mesh of the
    card, where Gloo takes DTensor's collectives on CUDA tensors."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import world
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_production_mesh

    row = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        world_s = world.spawn(_mh_rank, MH_WORLD, (tmp,), timeout=MH_TIMEOUT,
                              launcher_env=True)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(MH_WORLD)]
    per_rank = MH_BATCH // MH_WORLD * MH_SEQ
    for r in ranks:
        gap = _rel(r["losses"][0], r["plain_loss0"])
        r.update(loss0_gap=gap, step_ms_median_warm=float(np.median(r["step_ms"][1:])))
        r["tokens_per_s"] = per_rank / (r["step_ms_median_warm"] / 1e3)
        if gap > TRAIN_LOSS0_TOL or not all(np.isfinite(r["losses"])):
            raise AssertionError(f"rank {r['rank']}: first loss {r['losses'][0]} against the "
                                 f"plain route's {r['plain_loss0']} on its rows ({gap:.2e})")
        want = get_config("qwen3_0_6b").n_layers * MH_STEPS
        if r["flash_launches"] != want:
            raise AssertionError(f"rank {r['rank']}: flash_attention launched "
                                 f"{r['flash_launches']} times, not {want}")
        if any(r["loop_collectives"]):
            raise AssertionError(f"rank {r['rank']}: collectives in the loop: "
                                 f"{r['loop_collectives']}")
    if ranks[0]["losses"][0] == ranks[1]["losses"][0]:
        raise AssertionError("the ranks' first losses are equal: their rows are not their own")
    slowest = max(r["step_ms_median_warm"] for r in ranks)
    row["multihost"] = dict(
        world=MH_WORLD, batch=MH_BATCH, seq=MH_SEQ, steps=MH_STEPS, ranks=ranks,
        world_tokens_per_s=MH_BATCH * MH_SEQ / (slowest / 1e3), world_s=world_s,
        flash_launches=sum(r["flash_launches"] for r in ranks))
    log(f"  (a) {MH_WORLD} Gloo ranks on the card, launch.train.main qwen3_0_6b f32 "
        f"{MH_BATCH} x {MH_SEQ} a step ({MH_BATCH // MH_WORLD} rows a rank), {MH_STEPS} steps: "
        + "; ".join(f"rank {r['rank']} losses {[round(x, 4) for x in r['losses']]}, first "
                    f"vs plain {r['loss0_gap']:.2e}, warm step {r['step_ms_median_warm']:.1f} "
                    f"ms, {r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} GB, "
                    f"flash launches {r['flash_launches']}, loop collectives "
                    f"{r['loop_collectives']}" for r in ranks)
        + f"; the world {row['multihost']['world_tokens_per_s']:.0f} tokens/s (the slowest "
          f"rank's step), {world_s:.1f} s with its start; {smi}")

    mesh = make_production_mesh()
    cells = []
    for arch, shape_name in DRY_CELLS:
        cfg, shape = dryrun._dryrun_cfg(arch), SHAPES[shape_name]
        t1 = time.perf_counter()
        counter, _out, args, in_sh = dryrun.count_step(cfg, shape, mesh)
        t2 = time.perf_counter()
        rec = dryrun.record_collectives(cfg, shape, mesh)
        t3 = time.perf_counter()
        if counter.real_outputs or rec.real_outputs:
            raise AssertionError(f"{arch}|{shape_name}: {counter.real_outputs} + "
                                 f"{rec.real_outputs} tensors made off meta")
        rep = rl.analyze(
            arch=arch, shape_name=shape_name, mesh_name=mesh.name, chips=mesh.size,
            cost={"flops": counter.flops / mesh.size,
                  "bytes accessed": counter.total_bytes / mesh.size},
            collectives=rec.records, bytes_per_device=dryrun.arg_bytes_per_device(args, in_sh),
            model_flops=rl.model_flops_for(cfg, shape))
        by = collections.Counter(f"{k}/{a}" for k, _, _, a in rec.records)
        cells.append(dict(cell=f"{arch}|{shape_name}|{mesh.name}", counts=dict(by),
                          wire_bytes=rep.collective_bytes, collective_s=rep.collective_s,
                          compute_s=rep.compute_s, memory_s=rep.memory_s,
                          dominant=rep.dominant, count_s=t2 - t1, record_s=t3 - t2))
        if shape.kind == "train" and not (by["all-gather/data"] and by["reduce-scatter/data"]
                                          and rep.collective_s > 0):
            raise AssertionError(f"{arch}|{shape_name}: no FSDP gathers and reduce-scatters "
                                 f"over data: {dict(by)}")
        log(f"  (b) {cells[-1]['cell']}: collectives {dict(by)}, wire {rep.collective_bytes:.3e} "
            f"B a GPU, collective {rep.collective_s * 1e3:.3f} ms (compute "
            f"{rep.compute_s * 1e3:.3f}, memory {rep.memory_s * 1e3:.3f}), dominant "
            f"{rep.dominant}; counted in {t2 - t1:.1f} s, recorded in {t3 - t2:.1f} s")
    row["dry_run_records"] = cells

    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        gloo = _gloo_cuda_findings(tmp)
    sharded = dict(world=SHARDED_WORLD, depth=SHARDED_DEPTH, batch=SHARDED_BATCH,
                   seq=SHARDED_SEQ, gloo_on_cuda=gloo, probe_s=time.perf_counter() - t1)
    log(f"  (c) Gloo on CUDA tensors, DTensor's collectives each in a world of 2 ranks of its "
        f"own, up to the first it does not take: {gloo} ({sharded['probe_s']:.1f} s)")
    if any(gloo.get(n) != "ok" for n in GLOO_PROBES):
        log("  (c) Gloo does not take every collective of DTensor's on the card: no real "
            "sharded step here (the CPU test holds the real mesh against the fake one)")
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
            sharded["world_s"] = world.spawn(_sharded_rank, SHARDED_WORLD, (tmp,),
                                             timeout=MH_TIMEOUT)
            sranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                      for r in range(SHARDED_WORLD)]
        cfg, shape, smesh = _sharded_setup()
        fake = [list(r) for r in dryrun.record_collectives(cfg, shape, smesh).records]
        zero = sranks[0]
        if any(r["records"] != fake for r in sranks):
            raise AssertionError("the real mesh's records differ from the fake world's")
        if zero["loss_rel_err"] > SHARDED_TOL or zero["param_rel_err"] > SHARDED_TOL:
            raise AssertionError(f"the sharded step is off the unsharded one: loss "
                                 f"{zero['loss_rel_err']:.2e}, params {zero['param_rel_err']:.2e}")
        if any(r["flash_launches"] != SHARDED_DEPTH for r in sranks):
            raise AssertionError(f"flash_attention launches a rank: "
                                 f"{[r['flash_launches'] for r in sranks]}")
        sharded.update(records=len(fake), loss=zero["loss"], loss_rel_err=zero["loss_rel_err"],
                       param_rel_err=zero["param_rel_err"],
                       step_s=max(r["step_s"] for r in sranks),
                       flash_launches=sum(r["flash_launches"] for r in sranks))
        log(f"  (c) a train step sharded on a real (data 2, model 2) Gloo mesh of the card, "
            f"qwen3_0_6b at full width and {SHARDED_DEPTH} layers, {SHARDED_BATCH} x "
            f"{SHARDED_SEQ}: {len(fake)} collectives, equal to the fake world's; loss "
            f"{zero['loss']:.6f} ({zero['loss_rel_err']:.2e} off the unsharded step's), "
            f"params {zero['param_rel_err']:.2e}; the step {sharded['step_s']:.1f} s; {smi}")
    row["sharded_step"] = sharded
    row["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": "multihost", **row}))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import pulse_paper
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    import numpy as np

    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    seconds = {}

    def phase(num, title, fn, *fn_args):
        log(f"== phase {num}: {title}")
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[num] = time.perf_counter() - t0
        log(f"  phase {num}: {seconds[num]:.1f} s")
        return out

    name, smi, build_report = phase(1, "device and build", phase_device)
    checks = phase(2, "pulse_chase kernel against its plain version", phase_kernel_vs_plain,
                   rng)
    ws, wt = pulse_paper.WEBSERVICE, pulse_paper.WIREDTIGER
    workloads = [
        dict(name=ws.name, structure="hash", n_keys=ws.n_keys, n_buckets=ws.n_buckets),
        dict(name=wt.name, structure="btree", n_keys=wt.n_keys, n_buckets=0),
        dict(name="wiredtiger_2p24", structure="btree", n_keys=2**24, n_buckets=0),
    ]
    rows = phase(3, "PulseEngine.execute, backend='kernel'", phase_main, rng, workloads)

    # the headline is the workload whose gathers come from HBM, where the
    # bytes bound at the HBM rate is the card's own
    head = {r["route"]: r for r in rows if not r["arena_in_l2"]}
    entry = dict(
        name="pulse_chase", route="cuda", source=KERNEL_SOURCE, replaces=TPU_KERNEL,
        launches=sum(r["launches"] for r in rows),
        max_abs_err=max(c["max_abs_err"] for c in checks), mismatches=0,
        ms=head["isa"]["ms"], plain_ms=head["isa"]["plain_ms"],
        bound_ms=head["isa"]["bound_ms"], bound_by="bytes", library_ms=None,
        ms_native=head["native"]["ms"], plain_ms_native=head["native"]["plain_ms"],
        bound_ms_native=head["native"]["bound_ms"],
        timed_on=f"{head['isa']['workload']}, one fixed-depth launch of the whole batch "
                 f"(ms: the interpreter; ms_native: the native btree_find body)",
        launches_note="one per PulseEngine.execute: three workloads x two routes",
        workloads=rows,
    )
    flash_checks, flash_row = phase(4, "flash_attention kernel against its plain version",
                                    phase_flash, args.seed)
    paged_checks, paged_row = phase(5, "paged_attention kernel against its plain version",
                                    phase_paged, args.seed)
    serve_row, params = phase(6, "the serve path, qwen3_0_6b at full width", phase_serve)
    decode_row = phase(7, "paged decode at full width", phase_paged_decode, params)
    del params
    torch.cuda.empty_cache()
    ssd_checks, ssd_row = phase(8, "ssd_scan kernel against its plain version", phase_ssd,
                                args.seed)
    ssm_row = phase(9, "the serve path, mamba2_780m at full width", phase_ssm_serve)
    write_rows, skip_body, write_launches, store_class = phase(
        10, "the write path on the card, against the CPU; read-back on the kernel",
        phase_write, rng)
    entry["launches"] += write_launches
    entry["launches_note"] = ("one per PulseEngine.execute: three workloads x two routes "
                              "(phase 3) and one read-back per write batch (phase 10)")
    entry["native_bodies"] = native_bodies(checks, rows, write_rows, skip_body)
    route_rows, route_launches = phase(
        11, "routing over four emulated memory nodes, card against a CPU copy", phase_routing,
        rng)
    entry["launches"] += route_launches
    entry["launches_note"] = ("one per PulseEngine.execute: three workloads x two routes "
                              "(phase 3) and one read-back per write batch (phase 10); one "
                              "superstep-mode launch per superstep of each routed batch "
                              "(phase 11), and on its fused and pipelined schedules the first "
                              "call's launches: the warm-up superstep's and the captured "
                              "chunk's (1 and 8 a fused call, 2 and 16 a pipelined one; the "
                              "replays run the captured ones)")
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [r["superstep_check"]["max_abs_err"] for r in route_rows])
    entry["superstep"] = dict(
        timed_on="one superstep's local chase of each phase-11 batch (4 shards x 65,536 "
                 "records), kernel vs plain; per superstep in a call from the profiler",
        **{r["batch"]: dict(ms=r["superstep_check"]["ms"],
                            plain_ms=r["superstep_check"]["plain_ms"],
                            ms_per_superstep_in_call=r["kernel_ms_per_superstep"],
                            bound_ms_per_superstep=r["bound_ms_per_superstep"],
                            launches=r["launches"], supersteps=r["supersteps"])
           for r in route_rows})

    mesh_rows, commit_launches, mesh_readback = phase(
        12, "the write path over four emulated memory nodes, card against a CPU copy",
        phase_write_mesh, rng)
    entry["launches"] += mesh_readback
    entry["launches_note"] += ("; one superstep-mode launch per superstep of each phase-12 "
                               "read-back")
    faults_row, fault_launches = phase(
        13, "faults and replication over four emulated memory nodes", phase_faults, rng, smi)
    entry["launches"] += fault_launches
    entry["launches_note"] += ("; one superstep-mode launch per superstep of each of three "
                               "timed calls of each phase-13 replicated read (the replica "
                               "windows in the launch) and of each lossy "
                               "dispatched read, and the lossy fused and pipelined reads' first "
                               "calls' launches")
    serving_row, serving_ctx = phase(
        14, "traversal serving, PulseService over the engine on the card", phase_serving, rng,
        smi)
    serve_runs = serving_row["runs"]
    entry["launches"] += sum(r["pulse_chase_launches"] for r in serve_runs)
    entry["launches_note"] += ("; in phase 14, one per read engine call of each one-node "
                               "service run (a, b), and on the mesh runs (c, d, e) the first "
                               "call's launches of each group's device loop (its warm-up "
                               "superstep and captured chunk)")
    entry["max_abs_err"] = max(entry["max_abs_err"], serving_row["budget_check"]["max_abs_err"])
    entry["budget_operand"] = serving_row["budget_check"]
    ft_row = phase(15, "fault tolerance and durability, PulseService(..., fault_tolerance=...)",
                   phase_fault_tolerance, serving_ctx, smi)
    entry["launches"] += ft_row["launches"]["pulse_chase"]
    entry["launches_note"] += ("; in phase 15, one per read engine call of the one-node runs "
                               "(f, g), and on the mesh the read group's first call's "
                               "launches (h, i), one a superstep of each replica-window read "
                               "while a shard was dead (h, i) and of each watchdog probe (i)")
    hybrid_row = phase(16, "the serve path, zamba2_7b at full width (hybrid)", phase_hybrid_serve)
    torch.cuda.empty_cache()
    moe_row = phase(17, "the serve path, granite_moe_1b_a400m at full width (moe)",
                    phase_moe_serve)
    torch.cuda.empty_cache()
    vlm_row = phase(18, "the serve path and the patch prefill, internvl2_2b at full width (vlm)",
                    phase_vlm_serve, args.seed)
    torch.cuda.empty_cache()
    whisper_row = phase(19, "whisper_large_v3 at full width (encdec): prefill over 1,500 frames, "
                            "decode, token-mode serving", phase_whisper_serve, args.seed)
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    train_qwen = phase(20, "training, qwen3_0_6b at full width", phase_train, "qwen3_0_6b",
                       [(flash_ops.flash_attention, get_config("qwen3_0_6b").n_layers)],
                       ("attn_backend",))
    train_mamba = phase(21, "training, mamba2_780m at full width", phase_train, "mamba2_780m",
                        [(ssd_ops.ssd_scan, get_config("mamba2_780m").n_layers)],
                        ("ssm_backend",), False)  # no exact resume: phase 20's holds it
    torch.cuda.empty_cache()
    launch_row = phase(22, "the launch tooling: meta dry run, build_step's steps on the card, "
                           "pulse_verify", phase_launch, smi)
    torch.cuda.empty_cache()
    pg_row = phase(23, "memory nodes as processes: distributed_execute on a ProcessGroupMesh of "
                       "4 Gloo ranks on the card, replicated reads, a kill, PulseService served "
                       "from rank 0; the MoE's expert-parallel path",
                   phase_memory_nodes, rng, smi, serving_ctx)
    del serving_ctx
    torch.cuda.empty_cache()
    mh_row = phase(24, "training across processes: launch.train on 2 Gloo ranks of the card, "
                       "the dry run's collective records, a step sharded as DTensors",
                   phase_multihost, smi)
    entry["launches"] += (pg_row["launches"]["pulse_chase"] + pg_row["window_launches"]
                          + pg_row["reshard"]["launches"]["pulse_chase"])
    entry["launches_note"] += ("; in phase 23, one offset launch (the rank's own pool and rows) "
                               "per superstep on each of the 4 ranks of each process-group read "
                               "run's first call, one windowed offset launch (its holder "
                               "slice of the replica rows too) per superstep on each rank of "
                               "each of (a)'s ten replicated reads, and in (j) one offset "
                               "launch per read superstep on each serving rank, before the "
                               "cutover on ranks 0-3 and after it on all 8")
    entry["shard_offset"] = {r["run"]: r["first_superstep_checks"] for r in pg_row["runs"]
                             if r["launches"]["pulse_chase"]}
    entry["shard_offset_window"] = dict(
        first_launch_checks=pg_row["window_checks"], launches=pg_row["window_launches"],
        **{k: pg_row["window_offset"][k] for k in (
            "ms", "ms_source", "whole_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "active_records", "pool_records", "rows_read", "rows", "shard")},
        timed_on="webservice (hash_find), one superstep of holder 3's pool over its own rows "
                 "and holder slice, shard 1 dead (failover); whole_ms: the whole-arena "
                 "windowed launch of the same pools")

    def offset_err(kernel):  # phase 23: each rank's first offset launch against plain
        return max(c[kernel]["max_abs_err"] for r in pg_row["runs"]
                   for c in r["first_superstep_checks"].values() if kernel in c)

    entry["max_abs_err"] = max(entry["max_abs_err"], offset_err("pulse_chase"),
                               pg_row["window_offset"]["max_abs_err"],
                               *(c["max_abs_err"] for k, c in
                                 pg_row["reshard"]["first_launch_checks"].items()
                                 if k.endswith("/pulse_chase")),
                               *(c["max_abs_err"] for per in pg_row["window_checks"].values()
                                 for c in per.values()))
    checks13 = faults_row["window_checks"]
    entry["max_abs_err"] = max([entry["max_abs_err"]] + [c["max_abs_err"] for c in checks13])
    entry["replica_window"] = dict(
        timed_on="one superstep's local chase with the replica windows (failover, shard 1 "
                 "dead) of each phase-13 batch (4 shards x 65,536 records), kernel vs plain; "
                 "healthy_ms: the same launch without the windows",
        **{f"{c['batch']}/{c['body']}": {k: c[k] for k in (
            "ms", "healthy_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "active_records", "rows_read")} for c in checks13})

    head_commit = next(r for r in mesh_rows if r["batch"] == "wiredtiger_update")["commit_check"]
    commit_entry = dict(
        name="pulse_commit", route="cuda", source=COMMIT_SOURCE, replaces=COMMIT_REPLACES,
        launches=commit_launches + sum(r["pulse_commit_launches"] for r in serve_runs)
        + ft_row["launches"]["pulse_commit"] + pg_row["launches"]["pulse_commit"]
        + pg_row["reshard"]["launches"]["pulse_commit"],
        max_abs_err=max([r["commit_check"]["max_abs_err"] for r in mesh_rows]
                        + [offset_err("pulse_commit")]
                        + [c["max_abs_err"] for k, c in
                           pg_row["reshard"]["first_launch_checks"].items()
                           if k.endswith("/pulse_commit")]),
        ms=head_commit["ms"], plain_ms=head_commit["plain_ms"], bound_ms=head_commit["bound_ms"],
        bound_by="bytes", library_ms=None, stages_ms=head_commit["stages_ms"],
        timed_on="the wiredtiger_update commit phase with the most staged records "
                 f"({head_commit['eligible']} eligible, {head_commit['longest_chain']} on the "
                 f"longest shard, the longest same-slot run {head_commit['longest_run']}); "
                 "every kernel of the phase summed: commit_key, the sort, commit_apply, "
                 "commit_tail",
        launches_note="one per mutating superstep of phase 12 (three batches, four steps), "
                      "and on the fused and pipelined schedules each step's first call's: "
                      "the warm-up superstep's and the captured chunk's (1 and 8; the "
                      "replays run the captured ones); in phase 14, those of each update "
                      "group's device loop on the mesh runs (c, d, e), and in phase 15 on "
                      "run (h) those of the update group's loop and one a superstep of "
                      "the standby's and the recovery's dispatched replays; in phase 23, one "
                      "offset call (the rank's own pool, heap row and rows) per superstep on "
                      "each of the 4 ranks of each process-group write run's first call, and "
                      "in (j) one per write superstep on each serving rank",
        shard_offset={r["run"]: r["first_superstep_checks"] for r in pg_row["runs"]
                      if r["launches"]["pulse_commit"]},
        batches={r["batch"]: dict(commit_check=r["commit_check"], steps=[
            dict(step=x["step"], supersteps=x["supersteps"], launches=x["commit_launches"],
                 ms_per_superstep=x["commit_ms_per_superstep"],
                 stream_ms_per_superstep=x["commit_stream_ms_per_superstep"],
                 bound_ms_per_superstep=x["commit_bound_ms_per_superstep"],
                 longest_chain_max=x["longest_chain_max"],
                 longest_run_max=x["longest_run_max"], pops_max=x["pops_max"])
            for x in r["steps"]]) for r in mesh_rows},
        ms_per_superstep_source="CUDA events around each of the three launches in one timed "
                                "call a step (stream: from commit_key's launch to the end of "
                                "commit_tail's, the sort included)",
    )

    def f32_err(cks, row):
        return max([c["max_abs_err"] for c in cks if c["dtype"] == "float32"]
                   + [row["max_abs_err"]])

    def bf16_err(cks):
        return max(c["max_abs_err"] for c in cks if c["dtype"] == "bfloat16")

    def launch_errs(kernel):  # phase 22: each step's first call, on its own inputs
        return [r["kernel_max_abs_err"] for r in launch_row["steps"] if r["kernel"] == kernel]

    flash_entry = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:26",
        launches=serve_row["flash_launches"] + hybrid_row["flash_launches"]
        + moe_row["flash_launches"] + vlm_row["flash_launches"]
        + whisper_row["flash_launches"] + train_qwen["launches"]["flash_attention"]
        + launch_row["flash_launches"] + mh_row["multihost"]["flash_launches"]
        + mh_row["sharded_step"].get("flash_launches", 0),
        launches_note="one per layer of each prefill call of phase 6 (28 x 2), one per group "
                      "of phase 16's (13 x 2), one per layer of phase 17's (24 x 2) and of "
                      "phase 18's (24 x 2 served, 24 in the patch prefill), one per encoder "
                      "layer and two per decoder layer of phase 19's prefill call (32 + 64); "
                      "one per layer of each training step of phase 20's train.main (28 x 8; "
                      "the backward recomputes the plain version and launches none); one per "
                      "layer of each call of phase 22's build_step prefill and train steps "
                      "(28 x 4 each: the compared call and three warm ones); one per layer of "
                      "each training step on each rank of phase 24 (a) (28 x 4 x 2), and, "
                      "where Gloo takes DTensor's collectives on the card, one per layer of "
                      "(c)'s sharded step on each rank (2 x 4, on the rank's heads and rows)",
        max_abs_err=max(f32_err(flash_checks, flash_row), *moe_row["flash_layer_max_abs_err"],
                        *launch_errs("flash_attention"),
                        *(flash_row[k]["max_abs_err"] for k in (
                            "d112", "zamba", "granite", "whisper_enc", "whisper_cross",
                            "internvl"))),
        training_launches=train_qwen["launches"]["flash_attention"],
        backward=dict(flash_row["train_backward"], training_phase=20),
        max_abs_err_bf16=bf16_err(flash_checks), ms=flash_row["ms"],
        plain_ms=flash_row["plain_ms"], bound_ms=flash_row["bound_ms"],
        bound_by=flash_row["bound_by"], library_ms=flash_row["library_ms"],
        bound_ms_f32_fma=flash_row["bound_ms_f32_fma"],
        library="torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        timed_on="serve shape B=4 H=16 Hk=8 L=512 D=128 causal f32", serve=serve_row,
        **{f"{k}_d112": flash_row["d112"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                        "library_ms", "bound_ms_f32_fma")},
        timed_on_d112="B=4 H=64 Hk=8 L=512 D=112 causal f32 (kimi_k2_1t_a32b's heads)",
        **{f"{k}_{shape}": flash_row[shape][k] for shape in ("zamba", "granite")
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "bound_ms_f32_fma")},
        timed_on_zamba="B=4 H=32 Hk=32 L=512 D=112 causal f32 (zamba2_7b's prefill)",
        timed_on_granite="B=4 H=16 Hk=8 L=512 D=64 causal f32 (granite_moe_1b_a400m's)",
        **{f"{k}_{shape}": flash_row[shape][k]
           for shape in ("whisper_enc", "whisper_cross", "internvl")
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "bound_ms_f32_fma")},
        timed_on_whisper_enc="B=4 H=20 Hk=20 L=1500 D=64 full f32 (whisper_large_v3's encoder; "
                             "no blocks, ragged last tiles)",
        timed_on_whisper_cross="B=4 H=20 Hk=20 Lq=128 Lk=1500 D=64 full f32 (its "
                               "cross-attention)",
        timed_on_internvl="B=4 H=16 Hk=8 L=768 D=128 causal f32 (internvl2_2b's patch prefill: "
                          "256 patches + 512 tokens)",
        ragged=flash_row["ragged"],
        serve_hybrid=hybrid_row, serve_moe=moe_row, serve_vlm=vlm_row,
        whisper=whisper_row,
    )
    paged_entry = dict(
        name="paged_attention", route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:33",
        launches=decode_row["launches"],
        max_abs_err=max(f32_err(paged_checks, paged_row), decode_row["max_abs_err"]),
        max_abs_err_bf16=bf16_err(paged_checks), ms=paged_row["ms"],
        plain_ms=paged_row["plain_ms"], bound_ms=paged_row["bound_ms"],
        bound_by=paged_row["bound_by"], library_ms=None,
        timed_on="Qwen3-0.6B widths, B=4, lengths 512-528, f32, one layer",
        paged_decode=decode_row,
        **{f"{k}_d112": paged_row["d112"][k] for k in ("ms", "plain_ms", "bound_ms")},
        timed_on_d112="B=4 H=64 Hk=8 D=112 (kimi_k2_1t_a32b's heads), lengths 512-528, f32",
        **{f"{k}_long": paged_row["long"][k] for k in ("ms", "plain_ms", "bound_ms")},
        timed_on_long="B=1 H=16 Hk=8 D=128 (Qwen3-0.6B widths), 8,192 tokens, f32",
        splits={k: paged_row[k]["splits"] for k in ("d112", "long")} | {"qwen": paged_row["splits"]},
        merge_share={k: paged_row[k]["merge_share"] for k in ("d112", "long")}
        | {"qwen": paged_row["merge_share"]},
        ptxas=ptxas_summary(build_report["paged_attention"], "paged_decode"),
    )
    ssd_entry = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:24",
        launches=ssm_row["ssd_launches"] + hybrid_row["ssd_launches"]
        + train_mamba["launches"]["ssd_scan"] + launch_row["ssd_launches"],
        launches_note="one call (three kernels) per layer of each prefill call of phase 9 "
                      "(48 x 2) and of phase 16 (81 x 2), and of each training step of phase "
                      "21's train.main (48 x 8; the backward recomputes the plain version and "
                      "launches none), and of each call of phase 22's build_step prefill (48 x "
                      "4: the compared call and three warm ones)",
        training_launches=train_mamba["launches"]["ssd_scan"],
        backward=dict(ssd_row["train_backward"], training_phase=21),
        max_abs_err=max(f32_err(ssd_checks, ssd_row), *launch_errs("ssd_scan")),
        max_abs_err_bf16=bf16_err(ssd_checks), ms=ssd_row["ms"], plain_ms=ssd_row["plain_ms"],
        bound_ms=ssd_row["bound_ms"], bound_by=ssd_row["bound_by"], library_ms=None,
        bound_ms_f32_fma=ssd_row["bound_ms_f32_fma"],
        ms_per_kernel=ssd_row["ms_per_kernel"],
        timed_on="serve shape B=4 L=512 H=48 dh=64 N=128 chunk=128 f32, one layer",
        serve=ssm_row,
        **{f"{k}_zamba": ssd_row["zamba"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_f32_fma", "ms_per_kernel",
            "heads_per_block")},
        timed_on_zamba="B=4 L=512 H=112 dh=64 N=64 chunk=128 f32 (zamba2_7b's prefill), one "
                       "layer",
    )
    summary = {"kernels": [entry, flash_entry, paged_entry, ssd_entry, commit_entry],
               "launch_tooling": {k: launch_row[k] for k in ("steps", "pulse_verify_rc")}}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(
            device=name, nvidia_smi=smi, seed=args.seed, build=build_report, checks=checks,
            flash_checks=flash_checks, paged_checks=paged_checks, ssd_checks=ssd_checks,
            write_path=dict(batches=write_rows, store_class=store_class), routing=route_rows,
            write_mesh=mesh_rows, faults=faults_row, serving=serving_row,
            fault_tolerance=ft_row, hybrid_serve=hybrid_row, moe_serve=moe_row,
            vlm_serve=vlm_row, whisper_serve=whisper_row, train_qwen=train_qwen,
            train_mamba=train_mamba, memory_nodes=pg_row, training_across_processes=mh_row,
            **summary | {"launch_tooling": launch_row},
            phase_seconds=seconds,
            seconds=time.perf_counter() - t_start), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase "
        + ", ".join(f"{k}: {v:.1f}" for k, v in seconds.items()))
    log(smi)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
