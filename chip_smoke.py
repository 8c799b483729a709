#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports nothing
of JAX and nothing of the JAX package ``repro``. Phases, each raising on
failure:

1. card and build — the card's name and power limit, then the hand
   kernels compiled from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel), ptxas's registers and spills of every kernel,
   and of the kernels the last slice extended (the flash forward's and
   backward's ``wgmma`` instances, which now take hymba's meta-token
   sinks) on a line of their own;
2. sampled serving at full width — reddit at scale 1 (232,965 nodes,
   602 features, 41 classes), GraphSAGE-mean, 2 layers, hidden 256,
   fanouts (10, 25) outermost first, a 65,536-row feature cache, fp32,
   weights from the port's init under a fixed ``torch.Generator``. Four
   client threads send zipf-skewed 4-seed requests, a warm-up volley and
   then a measured one; kernel launch counts are zeroed just before the
   measured volley and read just after it. If the tuner's plans left the
   ELL or the SELL kernel unlaunched in it (the flush sizes follow the
   clients' timing), layer 1 is pinned to that kernel and both volleys
   run again. Eight of its flushes are recomputed by the port on the CPU
   and compared;
3. full-neighbor serving — 2-seed requests on the same graph (two zipf,
   two uniform), with its own launch counts; flushes whose outermost block
   has at most 2 M edges are recomputed on the CPU;
4. kernels against their plain versions on the card — first every
   packed block that a flush of phases 2 and 3 launched a kernel on,
   exactly as served (as many operands as launches); then, per kernel,
   the largest served block of phase 2, and ELL and SELL (C = 8, 16, 32)
   packed into the buckets of real flushes of phases 2 and 3, at K = 602
   (layer 0) and K = 256 (layer 1), each timed beside its plain version,
   its bound and ``torch.sparse.mm`` on the same matrix in CSR (timed as a
   yardstick only; the port never calls it). Each output element must
   agree within 2 d eps sum|terms|, d being its row's real slots;
6. full-graph training on reddit at scale 1 — GraphSAGE-mean, hidden 256,
   lr 1e-2, weight decay 5e-4, tuned (the tuner picks SELL; the plan is
   logged). From the same weights, one step patched and one unpatched
   must agree (loss within rtol 1e-5, every parameter gradient within
   1e-4 of its largest element); every SELL operand that step launched
   (A at K = 602 and 256 forward, the cached A^T at K = 256 backward) is
   held against the plain version on the step's own inputs with phase
   4's per-row bound. Then ``train_gnn`` runs patched and unpatched for a
   few epochs each, launch counts zeroed just before the patched run and
   read just after it (split into forward on A and backward on A^T); the
   unpatched run must launch no kernel. Every SELL launch of the patched
   run must have taken the split route (reddit's hub slices are cut into
   chunks across warps); the split chunks of A and A^T and the largest
   workspace are logged;
8. (run after phase 6) device-sampled minibatch training on the same
   graph — GraphSAGE-mean, hidden 256, fanouts (10, 25), batches of 1024
   seeds, lr 1e-2, weight decay 5e-4, the trainer's probed capacities
   and plans. ``train_gnn_minibatch(sampler="device")`` runs 2 epochs and
   the layer-wise evaluation first, checkpointing every 50 steps and at
   the end (the run is also phase 13 (a)'s clean run; a save is a sync
   and a host copy, ~2 ms, outside the sync-checked steps), launch counts
   zeroed just before and
   read just after (and around each step): every hop is one
   ``sample_hop`` launch (``n_hops`` a step, the standalone
   ``segment_sample`` / ``expand_indptr`` / ``flat_gather`` none) and
   the block backward launches the ordered ``segment_sum``. Batch 0
   sampled on the card must equal the plain CPU run bit for bit (every
   block field and the overflow count); the first step is recorded and
   each ``sample_hop`` launch must equal ``sample_hop_plain`` and the
   recorded output bit for bit, and on that hop's plain intermediates
   each standalone kernel its plain version; the ELL forward and the
   block backward stay within the per-row bound; the first step run twice
   more from the same weights, state, seeds and round gives the same
   loss, gradients and parameters bit for bit; eight steps of the run
   passed under ``torch.cuda.set_sync_debug_mode("error")`` (any host
   sync raises); step 0's buckets packed with the trusted plan
   (``BlockPlanCache(tune=False)``), GraphSAGE-mean and -max: the step
   twice from the same weights bit for bit, through the ordered
   ``segment_sum``, and within phase 6's tolerances of the CPU; one step
   is traced for the device busy share; host
   sampling + packing of 8 batches is timed beside ``sample_blocks`` on
   the card; the sampling wrappers' host µs a call are logged;
13. (run after phase 8) fault tolerance at phase 8's cell: (a)
   phase 8's run, which checkpointed every 50 steps and at the end,
   then the same run killed before step
   ``steps_per_epoch + 36`` (epoch 1, off the cadence) by a
   ``FaultPlan``, then resumed: the resume must start at the last
   multiple of 50, and the losses, final params and every leaf of the
   final checkpoint (params, the Adam step and moments) must equal the
   clean run's bit for bit; launch counts zeroed just before the resumed
   run and read just after (``sample_hop`` once a hop every step,
   ``ell_spmm``, ``segment_sum`` and the evaluation's ``sell_spmm``), one
   launch of each held against its plain version as phase 8 holds them;
   the checkpoint's bytes, each ``train.ckpt`` span's ms and the resume's
   set-up seconds logged; (b) a NaN added to the gradients at step 60:
   exactly one step skipped, every loss and param finite; (c) the host
   sampler over a window of 7 steps around the epoch boundary (a host
   batch takes ~1.8 s to sample at this scale, so a whole host epoch
   would take minutes): resumed from (b)'s checkpoint 2 steps before
   epoch 1 and stopped by an injected kill, once clean and once with the
   prefetch worker killed before item 4 and a 0.5 s straggler at epoch
   1's batch 4 under a ``StragglerWatchdog``: the checkpoints at the
   stop equal bit for bit, one prefetch restart, the straggler flagged;
7. the same on ogbn-proteins, cut to scale 1/2 for device memory (the
   GCN bundle's two 128 x 128 BSR operands, Â and Â^T, take ~15 GB each
   there and would take ~51 GB each at scale 1), GCN, hidden 256, with
   the plan pinned to BSR 128 x 128 through ``build_bundle(plan=...)``
   (the tuner's own pick is logged beside both estimates): BSR on Â at
   K = 256 and 112 forward and on the cached Â^T backward, each launch
   held to the split-TF32 bound (``kernels.bsr_spmm.split_tf32_bound``)
   and timed beside its fp32, TF32 and split-TF32 tile bounds and its
   hᵀ pre-pass;
9. (run after phase 7 has freed its bundle) full-graph dot-product GAT
   training on ogbn-proteins, cut to scale 1/4 for device memory (the
   gat bundle's BSR A and A^T take 4.05 GB each there, and the unpatched
   baseline's plain autograd keeps ~31 GB of per-edge tensors; both
   double at scale 1/2), hidden 256, lr 1e-2, weight decay 5e-4, A
   pinned to BSR 128 x 128 (the tuner's pick is logged). The first step
   patched against unpatched with phase 6's tolerances, its fused launch
   (layer 1, K = 256; layer 2, K = 112, takes the trusted composition)
   held against ``fusedmm_bsr_plain`` on its own inputs (atol 1e-4 x
   max|h|) and required to have taken the per-edge route on some tiles
   (the kernel counts tiles by route), its three per-edge SDDMM
   launches (``edge_dots``: layer 2's forward scores and one dual launch
   in each layer's backward) each held against the plain version on its
   own inputs within 2 (D + 1) eps sum_d |x_d y_d| a score, and no plain
   ``edge_dots`` run on a card tensor inside the step; ``train_gnn``
   patched and unpatched for 5 epochs, counts zeroed just before and
   read just after each (the unpatched run must launch nothing, the
   patched run's fused launches must have taken the per-edge route, and
   it must have launched ``edge_dots`` and the ordered ``segment_sum``),
   peak memory logged; the patched first step
   run twice from the same weights (gat, and GraphSAGE-max on the same
   graph: the max subgradient) gives the same gradients bit for bit;
   then ``ops.sddmm_bsr`` on A with layer 1's q and k (scale_by_a True
   and False, its own counted path: the scaled call must run the
   per-nonzero instance, the unscaled one the tile instance), checked in
   chunks of tiles within 2 (D + 1) eps sum|x_d y_d| (|a|); both kernels
   timed at D = K = 256 (fusedmm for softmax, sigmoid and none)
   beside their dense-tile bound, the per-edge bound of the same
   function, the plain versions and a library yardstick the port never
   calls (``torch.sparse.sampled_addmm``, for the unscaled SDDMM over
   the real tiles' full pattern; for softmax
   ``F.scaled_dot_product_attention`` with the dense boolean mask); the
   ordered segment sum as layer 1's backward runs it for dh (at K = 256
   and 112), checked against its plain version (2 d eps sum|terms|),
   launched twice for bitwise repeats and timed beside its bound and
   ``torch.sparse.mm`` on the same CSR; the per-edge SDDMM on A at D = 256, single and dual, checked, repeated
   bitwise and timed beside its bound, the plain version and
   ``torch.sparse.sampled_addmm``;
10. (run last) LM serving of phi3.5-moe-42b-a6.6b at full width
   (d_model 4096, 32 / 8 heads of 128, 16 experts top-2 of d_ff 6400,
   bf16), cut to 4 of 32 layers (the 84 GB of bf16 weights exceed the
   card), random weights from a seeded generator on the card: 4 prompts
   of 2,048 tokens from ``data/tokens``, ``prefill`` into a 2,088-slot
   cache, then 32 greedy ``decode_step``s. Launch counts are zeroed just
   before and read just after the prefill (4 flash attention + 12 ragged
   GEMM), the first decode step (12 ragged) and the other 31, and every
   ragged launch must have run the ``wgmma`` instance; every launch of
   the prefill and of the first decode step is held against its plain
   version on its own inputs (max |diff| within 2^-7 x max|plain|) and,
   row by row, against an fp32 oracle (2^-7 x the row's max); logits
   finite. Then prefill and decode times, peak memory and the device
   busy share, both kernels timed at the main path's shapes beside their
   bounds, plain versions, the host µs a call takes to enqueue, and a
   library yardstick the port never calls (``torch.bmm`` over the
   (E, C, D) buffer, ``scaled_dot_product_attention``), and the smoke
   config in fp32 on the card (the kernels' fp32 instances) against the
   port's CPU run, prefill + 4 decode steps within atol 1e-4;
11. measured tuning (``autotune(measure=True)``: CUDA events around the
   hand kernels, on the card by default): (a, run after phase 8) on
   reddit at scale 1, sage-mean's A and gcn's Â at K = 256 through
   ``build_cached_graph(measure=True)`` into a fresh ``TuningDB``, each
   candidate's measured ms logged beside its H100-model estimate and the
   measured pick beside the analytic one; a second build of A served by
   the DB with no launch; ``train_gnn(measure_tuning=True)`` for 3
   epochs on that DB, the kernel it runs held against its plain version
   on A at K = 256 (phase 4's per-row bound); (e) ``patch_fn`` on the
   card: a decorated forward equals ``patched(True)`` bit for bit and
   restores the patch state; (b) the measured ``tuning_curve`` on reddit
   over K = 16..1024 beside the analytic one, each with its
   ``suggest_embedding_size``; (d) one epoch of
   ``train_gnn_minibatch(sampler="device", measure_tuning=True)``,
   every bucket's measured pick logged, then again from the filled DB,
   measuring nothing; (c, run in phase 7 before its bundle) the measured
   pass on ogbn-proteins' Â at K = 256, logged against phase 7's pinned
   BSR and the analytic pick. The launches inside the timed passes join
   the kernels line;
12. (run after phase 10 has freed its weights) LM training of
   phi3.5-moe-42b-a6.6b at full width (as phase 10), cut to 2 of 32
   layers (bf16 params and grads and fp32 Adam moments of 3 layers would
   hold ~50 GB before any update or activation), remat "full" (the
   config's own), ``make_train_step``'s defaults (AdamW lr 3e-4, weight
   decay 0.1, clip 1.0), seeded random init on the card, 4 x 2,048
   tokens from ``data/tokens``. Launch counts zeroed just before step 0
   and read just after: 4 flash forwards (2 and 2 recomputed), 2 flash
   backwards (the ``wgmma`` instance), 18 ragged GEMMs (12 forward, 6 dX
   reading W transposed in place), all ``wgmma``; every
   launch of step 0 held against its plain version on its own inputs
   and, row by row, an fp32 oracle (as phase 10), the flash LSE within
   1e-3 of the oracle's, and no plain flash or ragged version run on a
   card tensor inside the step; the metrics finite; step 0 run again
   from the same state gives the same loss, gradients and updated
   params bit for bit; 8 steps on one fixed batch with the loss at step
   7 below step 0's; ms a step, tokens/s, the busy share of a traced
   step, peak memory; the flash backward timed at this shape beside its
   five- and seven-product bounds, its plain version and SDPA's
   backward, a dX launch as the backward makes it beside ``torch.bmm``
   on the transposed weights. Then gemma-7b at full width (d_model
   3,072, 16 / 16 heads of 256, GeGLU d_ff 24,576, vocab 256,000, tied
   embeddings, bf16), cut to 1 of 28 layers (1.06 B params), remat
   "full", the same defaults and checks, 1 x 2,048 tokens: step 0
   launches 2 flash forwards (1 recomputed) and 1 flash backward, on the
   ``wgmma`` instance (the D = 256 design: the head dim split across the
   warpgroups), no ragged GEMM; every launch held against its plain
   version and the fp32 oracle (the backward's rows past
   ``flash_bwd_row_floors``); step 0 twice bit for bit; 5 steps on one
   batch with a falling loss; ms a step, tokens/s, busy share, peak
   memory and the backward's kernels' device ms in the traced step;
   phase 13 (d): its whole train state (10.6 GB: bf16 params, fp32
   moments) saved by an asynchronous ``Checkpointer`` under
   ``chiprun_out/``, one in-place step at once while the write runs, the
   restore equal to a device clone taken before the save bit for bit and
   the next step from both bit for bit, the free disk, the host copy and
   write seconds and the step's ms with and without a write in flight
   logged, the directory removed;
   gemma-7b's attention shape (B 1, 16 / 16 heads of 256, S = T =
   2,048, causal, bf16) as a kernel case: the flash forward with its LSE
   and the backward (launched twice, bitwise equal), each against its
   plain version and the fp32 oracle and timed (CUDA events and the
   device trace by kernel); the smoke config in
   fp32 on the card for 3 steps against the port's CPU run (losses
   rtol 1e-4, params within the CPU tests' stated tolerance);
14. (run after phase 12 has freed its state) the ssm and hybrid
   families at full width, bf16, seeded random weights on the card: (a)
   mamba2-1.3b (48 layers, d_model 2,048, 64 SSD heads of 64, d_state
   128, chunk 256, vocab 50,280 tied) and hymba-1.5b (32 layers, d_model
   1,600, 25 / 5 heads of 64, window 1,024 with global layers 0, 15 and
   31, 128 meta tokens, 50 SSD heads of 64, d_state 16), whole: 4 prompts
   of 2,048 tokens, ``prefill`` into a cache of prompt + meta + 32 slots,
   32 greedy ``decode_step``s; counts zeroed just before hymba's prefill
   and read just after (32 flash launches, one a layer, all on the
   ``wgmma`` instance with the sinks; none for mamba2), each launch held
   against its plain version and, row by row, the fp32 oracle, no plain
   flash version on a card tensor, logits finite; prefill and decode
   times, tokens/s, peak memory, the busy share, the SSD's share of a
   traced prefill's device time; ``ssd_chunked`` against
   ``ssd_reference`` on layer 0's real inputs in fp32; in fp32 at one
   prompt, a prefill of 2,048 tokens and 8 decode steps of the prompt's
   next tokens against a prefill of 2,056 (the last logits); (b) hymba's
   SWA attention shape (B 4, 25 / 5 heads of 64, S = T = 2,176, window
   1,024, 128 sinks, bf16): the flash forward with its LSE and the
   backward, each against its plain version and the fp32 oracle,
   launched twice for the same bits, timed beside its bound over the
   kept pairs, its plain version and SDPA with a boolean mask of the
   same pairs; (c) both trained at full width cut to 4 layers (hymba
   with ``global_layers=(0,)``) through phase 12's checks, 4 x 2,048
   tokens; (d) the fp32 smoke configs on the card against the port's
   CPU run: prefill + 4 decode steps within atol 1e-4, 3 train steps;
15. (run after phase 14 has freed its state) the audio and vlm front
   ends at full width and full depth, bf16, seeded random weights on the
   card: (a) hubert-xlarge (48 layers, d_model 1,280, 16 heads of 80,
   d_ff 5,120, layer norm, gelu, non-causal, vocab 504): an encoder
   forward (``forward_hidden``, then the cluster logits) over 4 clips of
   4,096 seeded-normal frames, counts zeroed just before and read just
   after (48 flash launches, all on the ``wgmma`` instance at D 80, none
   causal), each held against its plain version and, row by row, the
   fp32 oracle, no plain flash version on a card tensor, logits finite;
   its time, frames/s, peak memory and busy share; (b) internvl2-2b (24
   layers, d_model 2,048, 16 / 8 heads of 128, d_ff 8,192, vocab 92,553,
   RoPE theta 1e6): 4 prompts of 1,024 image embeddings + 2,048 tokens,
   ``prefill`` into a cache of 3,072 + 32 slots, 32 greedy
   ``decode_step``s, the prefill's 24 flash launches (causal, S = T =
   3,072) checked as in (a), prefill and decode times, tokens/s, busy
   share, peak memory, and in fp32 at one prompt a prefill of 3,072
   positions and 8 decode steps of the prompt's next tokens against a
   prefill of 3,080 (the last logits within 1e-3 x their max); (c)
   hubert's attention shape (B 4, 16 / 16 heads of 80, S = T = 4,096,
   non-causal, bf16) as a kernel case: the forward with its LSE and the
   backward, each against its plain version and the fp32 oracle,
   launched twice for the same bits, timed (CUDA events and a device
   trace) beside its bound over the kept pairs, the bound of the work
   the design runs (the backward's seven products), its plain version
   and SDPA (``is_causal=False``);
   (d) both trained whole at full width through phase 12's checks:
   hubert on 4 x 4,096 frames with cluster targets, internvl2 on 4 x
   (1,024 image + 2,048 text) positions; (e) the fp32 smoke configs on
   the card against the port's CPU run: hubert's forward and internvl2's
   prefill + 4 decode steps within atol 1e-4, then 3 train steps;
16. (run after phase 15 has freed its state) data parallelism on the one
   card: two ranks on cuda:0, started by ``dist.run_ranks`` (spawned;
   they load the kernels phase 1 built and build none), reduce through
   gloo (NCCL refuses two ranks on one device; gloo stages card tensors
   through the host, so the times are the wire's staging and the ranks'
   contention for one card, nothing about scaling across cards). (b)
   ``train_gnn_minibatch(mesh=)`` at phase 8's cell with the train seeds
   cut to 2 x 1,024 x 37 + 1 = 75,777 (the shards take 38 and 37
   batches; the short one is padded to the lockstep count), one epoch
   with the fp32 wire and one with the int8 wire, a NaN injected on rank
   1 at step 5, the tracer on: 38 steps on both ranks, ``skipped == 1``
   on both, the replicas bitwise equal after the last step, finite
   losses that fall, the step ms from the ``train.step`` spans,
   ``sync_bytes_per_step`` beside the bytes a rank hands ``all_reduce``;
   (e) each rank writes ``chiprun_out/trace_rank{r}.json`` (pid = rank)
   and a ``metrics_to_jsonl`` line, and the parent merges the two traces
   into ``trace_ranks.json``, which must validate with both ranks'
   ``train.*`` spans; (a) one full-width step on the two shards' first
   batches (the trainer's own sampler): each rank's synced gradients and
   updated params bitwise (g_0 + g_1) / 2 and its update, from both
   shards' 1-rank gradients computed on the rank, the replicas equal;
   both ranks on one batch bitwise the 1-rank step; the int8 wire within
   amax / 127 a leaf; the wire's ms and the step's ms with 2 ranks, with
   both ranks running 1-rank steps and with one rank alone; (c)
   ``make_data_parallel_step`` on qwen2-1.5b at full width (d_model
   1,536, 12 / 2 heads of 128: the flash kernels' first run at a GQA
   group of 6, d_ff 8,960, vocab 151,936, tied) cut to 4 of 28 layers,
   bf16, remat "full", a global batch of 4 x 2,048 tokens (2 a rank):
   the first step's synced gradients bitwise the mean of the two halves'
   1-rank gradients and its loss their mean, every flash launch of it
   held against its plain version and the fp32 oracle as phase 12 holds
   them (8 forwards and 4 backwards a rank), three more steps with the
   replicas bitwise equal after each, one step with ``compression=True``
   within amax / 127 a leaf of the fp32 mean; the wire's ms a step; (d)
   meanwhile, in this process, a one-rank mesh with a card of its own
   (so NCCL) runs (a)'s step bitwise equal to the no-mesh step;
17. (run after phase 16) distributed GNN message passing on the one
   card: four ranks on cuda:0 through gloo, spawned as in phase 16, on
   reddit at scale 1 (phase 8's graph) at K = D = 256. The parent picks
   the largest reddit scale whose four 2 x 2 ELL tiles (padded to the
   widest in-tile degree) fit ``DG_ELL_BUDGET`` side by side, computes
   the one-card results (SpMM by ``core.spmm`` on a ``CachedGraph``,
   SDDMM by the plain per-edge dot product, FusedMM by
   ``kernels.ref.fusedmm_coo_ref`` and its autograd, the ring by a dense
   product) and hands them to the ranks by file. Each rank builds its
   own band and tiles (``dist.build_band``, ``build_tile``) and, with
   the launch counts zeroed just before and read just after, runs the
   1-D SpMM on 4 SELL bands (C = 8), the 2 x 2 SpMM on SELL tiles (sum,
   mean, ``compress=True``), SDDMM, FusedMM's three edge ops and the
   softmax backward, ``ring_allgather_matmul`` on a dense 8,192 x 8,192
   case and the 2 x 2 SpMM on the ELL tiles (sum, mean); then it times
   each op (CUDA events, the wire's ms apart), holds every result's rows
   against the one-card result (the stated rtol 1e-5 / atol 1e-6 x
   max(1, max|ref|); compressed within pc x amax / 127 more; FusedMM
   and its gradients, where a score's fp32 rounding passes through the
   edge op, within ``FUSED_TOL`` / ``GRAD_TOL`` of the largest element;
   the ring within 2 d eps sum|terms|; every case's ratio to the stated
   tolerance logged), checks the bytes it handed the backend against
   ``comm_volume`` / ``comm_volume_2d`` x 4 (only the ring's hops
   staged through the host), and holds one launch of each kernel (SELL,
   ELL on a few hundred of its rows, E, S) on its own operands against
   the plain version; then, in the same four ranks, the GPipe pipeline
   (``dist.pipeline_apply`` over a ``('pipe',)`` mesh of the four: 4
   stages of ``tanh(a @ w)`` at width 4,096, fp32, 8 microbatches, the
   hops staged through the host) held to the sequential composition on
   the card within 1e-5, its outputs bitwise on every rank;
19. (run after phase 17) the manual expert-parallel MoE on the one card:
   phi3.5-moe at full width on a ``'model'`` axis of 16 (one expert a
   rank; sixteen ranks on cuda:0 through gloo, spawned as in phase 16),
   the attention kept whole on every rank (``WHOLE_ATTENTION_RULES``: 8
   KV heads do not split over 16), the experts and the vocabulary split.
   The parent first runs the one-card oracle (the same model with its MoE
   layers ``moe_manual_reference`` of 16 virtual ranks) and frees it; the
   ranks draw their slices in turns (a whole layer is drawn before its
   slices are kept), then (a) train 1 layer on 2 x 512 tokens, step 0
   and one more, and (b) serve 4 layers: a 2 x 1,024-token prefill
   through the manual path and 4 decode steps through the split einsum.
   Every flash, flash backward and ragged launch is held against its
   plain version; the loss, sampled gradients and updates, routing and
   logits against the oracle within the bounds stated before the first
   card run (PERF.md §6); the whole leaves bitwise on all sixteen;
   the bytes each rank hands gloo exactly ``ep_wire_bytes``; and, with
   no code of the manual path shared, layer 0's MoE through the manual
   path on the sixteen ranks at a capacity where no slot drops against
   the einsum route (the ragged GEMM kernel) on one card;
5. last, the kernels line (one JSON object: the sampling kernels and the
   fused hop as timed in phase 8, the ordered segment sum and the
   per-edge SDDMM as timed in phase 9, the serving kernels as timed in phase 4, BSR as timed in
   phase 7, SDDMM and FusedMM as timed in phase 9, the ragged GEMM and
   flash attention as timed in phase 10, with phase 12's launches and
   dX timing, and the flash backward as timed in phase 12, its ``d256_*``
   keys from gemma-7b's kernel case and step; both flash entries with
   phase 14's launches and ``meta_*`` keys from its sink case, and phase
   15's launches and ``d80_*`` keys from hubert's kernel case; each
   entry's ``launches_resume`` the launches of phase 13's resumed run
   and ``launches_dp`` those of phase 16's ranks, ``launches_dist``
   those of phase 17's, ``launches_pp`` its pipeline's, ``launches_ep``
   those of phase 19's, all added to its ``launches``), the script's
   seconds, the card line, and
   ``{"ok": true, "device": {...}}``.

Details of every case go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pickle
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH, HIDDEN, FANOUTS = "sage-mean", 256, (10, 25)
CACHE_ROWS = 65_536
N_REQUESTS, REQ_SIZE, CLIENTS = 128, 4, 4
FULL_REQUESTS, FULL_EDGE_CAP = 2, 2_000_000
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)   # card vs CPU logits, fp32
EPS32 = 2.0 ** -24
DEVICE = "cuda"
KERNEL_META = {
    "ell_spmm": dict(source="src/repro_torch/csrc/ell_spmm.cu",
                     replaces="src/repro/kernels/ell_spmm.py:42"),
    "sell_spmm": dict(source="src/repro_torch/csrc/sell_spmm.cu",
                      replaces="src/repro/kernels/sell_spmm.py:50"),
    "bsr_spmm": dict(source="src/repro_torch/csrc/bsr_spmm.cu",
                     replaces="src/repro/kernels/bsr_spmm.py:53"),
    "segment_sample": dict(source="src/repro_torch/csrc/sample.cu",
                           replaces="src/repro/kernels/sample.py:158"),
    "expand_indptr": dict(source="src/repro_torch/csrc/sample.cu",
                          replaces="src/repro/kernels/sample.py:218"),
    "flat_gather": dict(source="src/repro_torch/csrc/sample.cu",
                        replaces="src/repro/kernels/sample.py:263"),
    # one launch for the hop of the three kernels above (lines 158, 218
    # and 263 there)
    "sample_hop": dict(source="src/repro_torch/csrc/sample.cu",
                       replaces="src/repro/kernels/sample.py:158"),
    # no Pallas kernel: the reference's backwards sum in XLA
    # (jax.ops.segment_sum, as its trusted reduce does)
    "segment_sum": dict(source="src/repro_torch/csrc/segment_sum.cu",
                        replaces="src/repro/core/semiring.py:68"),
    # no Pallas kernel: the reference's per-edge dot products are XLA
    # (the FusedMM backward's recompute, and sddmm_coo_ref)
    "edge_dots": dict(source="src/repro_torch/csrc/edge_dots.cu",
                      replaces="src/repro/core/fusedmm.py:80"),
    "sddmm_bsr": dict(source="src/repro_torch/csrc/sddmm.cu",
                      replaces="src/repro/kernels/sddmm.py:35"),
    "fusedmm_bsr": dict(source="src/repro_torch/csrc/fusedmm.cu",
                        replaces="src/repro/kernels/fusedmm.py:78"),
    "ragged_gemm": dict(source="src/repro_torch/csrc/ragged_gemm.cu",
                        replaces="src/repro/kernels/ragged_gemm.py:29"),
    "flash_attention": dict(source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:78"),
    # no Pallas kernel: the reference differentiates chunked_attention in
    # XLA (flash_attention_pallas has no custom_vjp)
    "flash_attention_bwd": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none, port-only: the reference's XLA gradient of "
                 "chunked_attention, src/repro/models/lm/attention.py:37"),
}
SERVE_KERNELS = ("ell_spmm", "sell_spmm")   # what serving launches
TRAIN_EPOCHS, TRAIN_LR, TRAIN_WD = 5, 1e-2, 5e-4
LOSS_RTOL = 1e-5        # patched vs unpatched first-step loss, fp32
GRAD_TOL = 1e-4         # max |diff| / max |unpatched| of each gradient
PROTEINS_SCALE = 1 / 2  # device memory: two ~15 GB BSR operands
GAT_SCALE = 1 / 4       # device memory: BSR A, A^T and the baseline's edges
FUSED_TOL = 1e-4        # fusedmm atol over max|h| (softmax) or max|plain|
TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor-core peak
# H100 SXM int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, one
# operation a lane a clock (the Hopper white paper's SM: 64 INT32 units)
INT32_OPS = 132 * 64 * 1.98e9
MB_BATCH, MB_EPOCHS = 1024, 2   # PyG's / DGL's Reddit minibatch setting
MB_SYNC_STEPS = 8               # steps run under the host-sync check
MB_INFER_BATCH = 4096           # layer-wise inference dst rows per block


def log(*args):
    print(*args, flush=True)


def ptxas_function(line: str) -> str:
    """The kernel and template arguments a ptxas "Function properties
    for <mangled name>" line names, as ``fusedmm_kernel<4,2>``: of the
    mangled name's ``<length><identifier>`` parts that name a kernel, the
    shortest (the enclosing namespaces' names are longer)."""
    name = line.split()[-1]
    found = []
    for m in re.finditer(r"\d+", name):
        digits = m.group()
        for k in range(len(digits)):            # the length may follow
            n = int(digits[k:])                 # other digits
            ident = name[m.end():m.end() + n]
            if n and len(ident) == n and \
                    re.fullmatch(r"[A-Za-z]\w*_kernel(_[A-Za-z]+)*", ident):
                found.append((n, m.end()))
    if not found:
        return name[:60]
    n, at = min(found)
    args = re.match(r"I((?:Li-?\d+E)*)E", name[at + n:])
    vals = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
    return name[at:at + n] + (f"<{','.join(vals)}>" if vals else "")


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} of every function
    in nvcc's ``-Xptxas -v`` output, ptxas's warnings under
    ``"warnings"``, and under ``"performance_loss"`` its "Potential
    Performance Loss" notes as "(code) kernel" (C7511 / C7512: the
    kernel's wgmmas serialised for want of registers; the notes are
    ptxas info lines, not warnings)."""
    out: dict = {"warnings": [], "performance_loss": []}
    fn = ""
    for line in text.splitlines():
        if "Function properties for" in line:
            base = fn = ptxas_function(line)
            for i in range(2, 1000):    # instances whose template arguments
                if fn not in out:       # are types share a name: number them
                    break
                fn = f"{base}#{i}"
            out[fn] = {}
        elif "spill stores" in line and fn:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            out[fn].update(spill_stores=nums[1], spill_loads=nums[2])
        elif "Used" in line and "registers" in line and fn:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
        elif "Potential Performance Loss" in line:
            code = re.search(r"\(C\d+\)", line)
            name = re.search(r"function '([^']+)'", line)
            out["performance_loss"].append(
                f"{code.group() if code else '(?)'} "
                f"{ptxas_function('in ' + name.group(1)) if name else line.strip()[:150]}")
        elif "warning" in line.lower():
            out["warnings"].append(line.strip()[:200])
    return out


# the kernels this slice redesigned (the flash forward and backward
# instances at hubert-xlarge's head dim 80, at its true width; the
# forward's two warpgroups in ping-pong): phase 1 logs their registers
# and spills on a line of their own
NEW_KERNELS = ("flash_attention_wgmma_d80_kernel",
               "flash_bwd_dkdv_wgmma_kernel<80>",
               "flash_bwd_dq_wgmma_kernel<80>")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def zipf_requests(rng, n_nodes: int, n_requests: int, req_size: int):
    """Zipf-skewed unique-seed requests (popular vertices dominate)."""
    reqs = []
    for _ in range(n_requests):
        ids: set = set()
        while len(ids) < req_size:
            ids.add(min(int(rng.zipf(1.3)) - 1, n_nodes - 1))
        reqs.append(np.asarray(sorted(ids), np.int64))
    return reqs


def closed_loop(srv, reqs, concurrency: int) -> float:
    """``concurrency`` clients replay their slice of ``reqs`` back to back;
    returns the wall-clock seconds of the volley. A client error raises."""
    chunks = [reqs[i::concurrency] for i in range(concurrency)]
    errs: list = []

    def client(chunk):
        try:
            for r in chunk:
                srv.predict(r, timeout=300.0)
        except Exception as exc:          # surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=client, args=(c,)) for c in chunks]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client thread did not finish")
    return time.perf_counter() - t0


def make_recording_server(GNNServer):
    """A GNNServer that keeps, per flush, its seeds/index/bucket, sampled
    blocks, layer buckets, the packed blocks it launched on the card and
    the served logits: what a CPU recompute and the kernel checks need."""

    class Recording(GNNServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.records = []
            self._rec_lock = threading.Lock()

        def pack_flush(self, blocks, fo, bucket):
            pbs, buckets = super().pack_flush(blocks, fo, bucket)
            self._last = dict(blocks=blocks, buckets=buckets, pbs=pbs)
            return pbs, buckets

        def run_flush(self, flush):
            out = super().run_flush(flush)
            with self._rec_lock:
                self.records.append(dict(
                    seeds=flush.seeds.copy(), index=flush.index,
                    bucket=flush.bucket, out=out.copy(), **self._last))
            return out

    return Recording


def recompute_on_cpu(cpu_srv, records, tol) -> float:
    """Max |card - CPU| over the recorded flushes; raises past ``tol``."""
    from repro_torch.serving.batcher import Flush
    worst = 0.0
    for r in records:
        fl = Flush(tickets=[], seeds=r["seeds"], bucket=r["bucket"],
                   index=r["index"])
        want = cpu_srv.run_flush(fl)
        np.testing.assert_allclose(r["out"], want, **tol)
        worst = max(worst, float(np.abs(r["out"] - want).max()))
    return worst


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profiled(fn, reps: int = 1):
    """Device-side µs by name of ``reps`` calls of ``fn``, and their wall
    seconds, from a ``torch.profiler`` trace (CUPTI). A trace misses the
    device work of its first tens of milliseconds (on the H100 machine it
    lost 15–35 ms of kernels, a whole 12 ms SpMM among them), so one
    traced warm-up call runs first and is discarded, and the measured
    window opens with a quarter second in which nothing is launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    got = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.setdefault(
                     "events", p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.25)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return kernel_times(got["events"]), wall


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def fmt_us(us) -> str:
    return "none" if us is None else f"{us:.1f}"


def device_us(fn, reps: int):
    """Device time (µs) of the kernels ``reps`` calls of ``fn`` run, by
    kernel name."""
    return profiled(fn, reps)[0]


def traced_ms(fn, reps: int, name: str, tries: int = 3):
    """Device ms a call of the kernels whose names contain ``name``, from
    :func:`device_us` over ``reps`` calls; a trace that records none of
    them (a late trace in a long process sometimes records no kernel) is
    taken again, at most ``tries`` traces in all; None if none did."""
    for _ in range(tries):
        us = sum(v for key, v in device_us(fn, reps).items() if name in key)
        if us:
            return us / reps / 1e3
    return None


def kernel_times(events) -> dict:
    """{name: self device µs} of every device-side entry (kernels, copies,
    memsets) of a profiler's key averages. Host-side ops and the
    ``ProfilerStep`` annotation are skipped: their device time repeats
    that of the kernels inside them."""
    from torch.autograd import DeviceType
    out = {}
    for e in events:
        if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CUDA \
                or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + float(us)
    return out


def kernel_fns(name):
    """(hand kernel, plain version) of ``name``."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda, bsr_spmm_plain
    from repro_torch.kernels.ell_spmm import ell_spmm_cuda, ell_spmm_plain
    from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain
    return {"ell_spmm": (ell_spmm_cuda, ell_spmm_plain),
            "sell_spmm": (sell_spmm_cuda, sell_spmm_plain),
            "bsr_spmm": (bsr_spmm_cuda, bsr_spmm_plain)}[name]


def operand(pb):
    """(kernel name, packed matrix) a PackedBlock's plan launches."""
    return ("ell_spmm", pb.ell) if pb.plan_kind == "ell" else \
        ("sell_spmm", pb.sell)


def real_slots_per_row(name, a):
    """Per output row (original order), the slots holding a real edge
    (``idx < ncols``; for BSR the nonzero tile entries): sentinel slots
    and zero entries add no term and so no rounding."""
    import torch
    if name == "bsr_spmm":
        nz = (a.blocks != 0).sum(dim=2, dtype=torch.int32)
        per = torch.zeros((a.n_block_rows, a.br), dtype=torch.int32,
                          device=nz.device)
        per.index_add_(0, a.blk_row.long(), nz)
        return per.reshape(-1)
    real = (a.idx < a.ncols).to(torch.int32)
    if name == "ell_spmm":
        return real.sum(1)
    per = torch.zeros((a.nslices, a.c), dtype=torch.int32,
                      device=real.device)
    per.index_add_(0, a.slice_of.long(), real)
    return per.reshape(-1)[a.inv_perm.long()]


def check_kernel(name, a, h, tag, out=None):
    """Run the kernel (or take ``out``, what it already gave on these
    operands) and its plain version on the same card tensors and raise
    unless every element agrees. Tolerance: two fp32 sums of the
    same d terms in different orders differ by at most 2 d eps sum|terms|,
    d being the row's real slots. BSR computes its tile products in split
    TF32 and is held to ``split_tf32_bound`` instead: (13 + 8 d) eps
    sum|terms| (split error under 13 eps a product, 3 d truncating fp32
    additions in the tensor cores, 2 d eps for the plain sum; the
    derivation is that function's docstring). Returns (max |diff|, max d,
    the largest ratio of |diff| to its bound)."""
    import torch
    from repro_torch.kernels.bsr_spmm import split_tf32_bound
    kernel, plain = kernel_fns(name)
    if out is None:
        out = kernel(a, h)
    want = plain(a, h)
    mag = plain(dataclasses.replace(a, blocks=a.blocks.abs())
                if name == "bsr_spmm" else
                dataclasses.replace(a, val=a.val.abs()), h.abs())
    d = real_slots_per_row(name, a)
    err = (out - want).abs()
    terms = d.to(torch.float32)[:, None]
    bound = (split_tf32_bound(terms, mag) if name == "bsr_spmm" else
             2 * EPS32 * terms * mag) + 1e-30
    if not bool((err <= bound).all()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name} {tag}: kernel disagrees with plain, "
                             f"max err {float(err.max())}, worst ratio "
                             f"{float((err / bound).max())}")
    return (float(err.max()), int(d.max()) if d.numel() else 0,
            float((err / bound).max()))


def random_h(n, k, gen):
    import torch
    return torch.randn((n, k), generator=gen, device=DEVICE,
                       dtype=torch.float32)


def check_served(records, dims, gen) -> dict:
    """Hold the kernel against its plain version on every packed block
    that a recorded flush launched a kernel on, exactly as served."""
    stats: dict = {}
    for i, r in enumerate(records):
        for layer, (pb, k) in enumerate(zip(r["pbs"], dims[:-1])):
            if pb.plan_kind not in ("ell", "sell"):
                continue
            name, a = operand(pb)
            err, _, ratio = check_kernel(name, a,
                                         random_h(pb.n_src, k, gen),
                                         f"flush {i} layer {layer}")
            st = stats.setdefault(name, dict(operands=0, max_abs_err=0.0,
                                             max_err_over_bound=0.0))
            st["operands"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["max_err_over_bound"] = max(st["max_err_over_bound"], ratio)
    return stats


def time_case(pb, k, tag, gen):
    """Check one packed block's kernel against its plain version, then
    time both, the kernel's device time and ``torch.sparse.mm`` on the
    same matrix in CSR (a yardstick the port never calls)."""
    import torch
    from repro_torch.core.autotune import H100
    name, a = operand(pb)
    kernel, plain = kernel_fns(name)
    h = random_h(pb.n_src, k, gen)
    err, width, ratio = check_kernel(name, a, h, tag)

    n = pb.nnz_real
    row, col = pb.row[:n].long().cpu(), pb.col[:n].long().cpu()
    order = torch.argsort(row * pb.n_src + col)
    crow = torch.zeros(pb.n_dst + 1, dtype=torch.int64)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=pb.n_dst), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        csr = torch.sparse_csr_tensor(
            crow, col[order], pb.val[:n].float().cpu()[order],
            size=(pb.n_dst, pb.n_src), check_invariants=True).to(DEVICE)
    lib_err = float((torch.sparse.mm(csr, h) - plain(a, h)).abs().max())

    by_kernel = device_us(lambda: kernel(a, h), reps=20)
    kernel_us = sum(us for key, us in by_kernel.items()
                    if f"{name}_kernel" in key)
    # bytes it must move: each real edge's (idx, val), each distinct
    # source row once, each output row once
    n_unique_src = int(torch.unique(col).numel())
    nbytes = n * 8 + n_unique_src * k * 4 + a.nrows * k * 4
    flops = 2.0 * n * k
    t_bytes, t_ops = H100.mem_time(nbytes), H100.vpu_time(flops)
    return dict(
        name=name, tag=tag, k=k, n_dst=pb.n_dst, n_src=pb.n_src, nnz=n,
        c=getattr(a, "c", None), width=width,
        n_steps=getattr(a, "n_steps", None), max_abs_err=err,
        max_err_over_bound=ratio,
        ms=cuda_ms(lambda: kernel(a, h)),
        device_ms=kernel_us / 20 / 1e3 if kernel_us else None,
        plain_ms=cuda_ms(lambda: plain(a, h), reps=5, warmup=1),
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, h)),
        library_max_abs_diff=lib_err,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops)


def span_breakdown(spans, n_flushes: int) -> dict:
    """Mean ms per flush of each ``serve.*`` span."""
    tot: dict = {}
    for sp_ in spans:
        if sp_.name.startswith("serve."):
            tot[sp_.name] = tot.get(sp_.name, 0.0) + sp_.dur_ns / 1e6
    return {k: v / max(n_flushes, 1) for k, v in sorted(tot.items())}


def device_busy(srv, reqs) -> dict:
    """Share of a serving window in which the card runs kernels or copies:
    Σ device time in a ``torch.profiler`` trace over the window's wall."""
    times, window = profiled(lambda: closed_loop(srv, reqs, CLIENTS))
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    return dict(window_s=window, requests=len(reqs),
                device_s=sum(times.values()) / 1e6,
                busy_share=sum(times.values()) / 1e6 / window,
                top=[[k[:60], round(us / 1e3, 3)] for k, us in top])


def pinned_plans_db(path, kind: str):
    """A TuningDB that pins every layer-1 (K = HIDDEN) bucket key of this
    configuration to ``kind``; layer 0 stays with the tuner."""
    from repro_torch.core.autotune import KernelPlan, TuningDB
    from repro_torch.sampling import BlockPlanCache
    db = TuningDB(str(path))
    plan = KernelPlan(kind=kind, k_hint=HIDDEN, sell_c=8)
    for n_dst in (16, 32, 64):
        for i in range(12):
            db.put_key(BlockPlanCache.key(n_dst, 128 << i,
                                          FANOUTS[-1] * n_dst, HIDDEN,
                                          "mean"), plan)
    db.save()
    return db


# -- full-graph training (phases 6 and 7) --------------------------------

def operand_ptr(a) -> int:
    """Storage of a packed operand (its tiles or its slot table): a
    CachedGraph moved to the card keeps it, whatever wraps it."""
    return (a.blocks if hasattr(a, "blocks") else a.idx).data_ptr()


@contextlib.contextmanager
def record_spmm(keep_inputs: bool):
    """Record every ``sell_spmm`` / ``bsr_spmm`` dispatch the training path
    makes (kernel name, operand, K and, with ``keep_inputs``, a copy of
    h). The dispatchers and their launch counts are unchanged."""
    from repro_torch.kernels import ops as kops
    calls: list = []
    saved = {n: getattr(kops, n) for n in ("sell_spmm", "bsr_spmm")}

    def wrap(name, fn):
        def recorded(a, h):
            calls.append(dict(name=name, a=a, k=h.shape[1],
                              ptr=operand_ptr(a),
                              h=h.detach().clone() if keep_inputs else None))
            return fn(a, h)
        return recorded
    for name, fn in saved.items():
        setattr(kops, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


def device_csr(coo):
    """``coo`` as a CSR tensor on the card, for ``torch.sparse.mm`` (a
    yardstick the port never calls). Rows are sorted already."""
    import torch
    n = coo.nse
    row = coo.row[:n].long()
    crow = torch.zeros(coo.nrows + 1, dtype=torch.int64, device=row.device)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=coo.nrows), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        return torch.sparse_csr_tensor(crow, coo.col[:n].long(),
                                       coo.val[:n].float(),
                                       size=(coo.nrows, coo.ncols))


def tile_pattern_csr(a):
    """Every position of every real tile of the BSR ``a`` as a CSR pattern
    on the card (int32 indices, values 1, shape ``a.shape``): the
    positions the unscaled SDDMM writes, so ``torch.sparse.sampled_addmm``
    over it computes the same scores (a yardstick the port never calls).
    Returns (csr, tiles of block row 0)."""
    import torch
    dev = a.blk_row.device
    nb, br, bc = a.n_real_blocks, a.br, a.bc
    blk_row, blk_col = a.blk_row[:nb].long(), a.blk_col[:nb].long()
    counts = torch.bincount(blk_row, minlength=a.nrows // br)
    off = torch.zeros_like(counts)
    off[1:] = torch.cumsum(counts, 0)[:-1]
    crow = torch.zeros(a.nrows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(counts.repeat_interleave(br) * bc, 0)
    nnz = int(crow[-1])
    tile_cols = (blk_col[:, None] * bc + torch.arange(
        bc, device=dev)).reshape(-1).to(torch.int32)
    col = torch.empty(nnz, dtype=torch.int32, device=dev)
    at = 0
    for o, c in zip(off.tolist(), counts.tolist()):
        seg = tile_cols[o * bc:(o + c) * bc]
        col[at:at + br * c * bc] = seg.repeat(br)
        at += br * c * bc
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        csr = torch.sparse_csr_tensor(
            crow.to(torch.int32), col,
            torch.ones(nnz, dtype=torch.float32, device=dev),
            size=(a.nrows, a.ncols))
    return csr, int(counts[0])


def time_full(name, a, coo, k, tag, gen) -> dict:
    """Check a whole-graph operand's kernel against its plain version on a
    random h, then time both, the kernel's device time and
    ``torch.sparse.mm`` on ``coo`` (the same matrix) in CSR. The bound
    counts each input byte once: the stored tiles (BSR) or real edges'
    (index, value) pairs, each h row the operand reads, each output row;
    and the operations the product needs on this data, 2 K per real edge
    in every format. For BSR, ``bound_tile_ms`` / ``bound_tc_ms`` /
    ``bound_split_tf32_ms`` count the dense tile work the kernel does (2 K
    per tile entry) at the fp32 CUDA-core rate, the TF32 tensor-core rate
    and a third of it (three TF32 passes), and ``prepass_ms`` times the
    kernel's hᵀ pre-pass alone."""
    import torch
    from repro_torch.core.autotune import H100
    kernel, plain = kernel_fns(name)
    h = random_h(coo.ncols, k, gen)
    err, width, ratio = check_kernel(name, a, h, tag)
    csr = device_csr(coo)
    lib_err = float((torch.sparse.mm(csr, h)
                     - plain(a, h)[: coo.nrows]).abs().max())
    reps = 10
    by_kernel = device_us(lambda: kernel(a, h), reps=reps)
    kernel_us = sum(us for key, us in by_kernel.items()
                    if f"{name}_kernel" in key)
    n_rows_out = coo.nrows
    if name == "bsr_spmm":
        src_rows = min(int(torch.unique(a.blk_col).numel()) * a.bc, coo.ncols)
        nbytes = a.nblocks * (a.br * a.bc * 4 + 8)
    else:
        src_rows = int(torch.unique(coo.col[: coo.nse]).numel())
        nbytes = coo.nse * 8
    flops = 2.0 * coo.nse * k
    nbytes += src_rows * k * 4 + n_rows_out * k * 4
    t_bytes, t_ops = H100.mem_time(nbytes), H100.vpu_time(flops)
    case = dict(
        name=name, tag=tag, k=k, n_dst=coo.nrows, n_src=coo.ncols,
        nnz=coo.nse, width=width, max_abs_err=err, max_err_over_bound=ratio,
        ms=cuda_ms(lambda: kernel(a, h), reps=reps),
        device_ms=kernel_us / reps / 1e3 if kernel_us else None,
        plain_ms=cuda_ms(lambda: plain(a, h), reps=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, h), reps=reps),
        library_max_abs_diff=lib_err,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops)
    if name == "bsr_spmm":
        from repro_torch.kernels.bsr_spmm import transpose_h_cuda
        tile_flops = 2.0 * a.nblocks * a.br * a.bc * k
        case.update(tiles=a.nblocks, tile=f"{a.br}x{a.bc}",
                    tile_flops=tile_flops,
                    bound_tile_ms=max(t_bytes, H100.vpu_time(tile_flops)) * 1e3,
                    bound_tc_ms=max(t_bytes, tile_flops / TF32_FLOPS) * 1e3,
                    bound_split_tf32_ms=max(
                        t_bytes, 3 * tile_flops / TF32_FLOPS) * 1e3,
                    prepass_ms=cuda_ms(lambda: transpose_h_cuda(h),
                                       reps=reps))
    del csr
    return case


def step_profile(fn) -> dict:
    """Device busy share and the device time by kernel of one call of
    ``fn`` (a training step) from a ``torch.profiler`` trace."""
    times, wall = profiled(fn)
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    by_name: dict = {}      # names cut to 90 characters may coincide: sum
    for key, us in ranked:
        by_name[key[:90]] = by_name.get(key[:90], 0.0) + us / 1e3
    return dict(wall_s=wall, device_s=sum(times.values()) / 1e6,
                busy_share=sum(times.values()) / 1e6 / wall,
                top=[[key[:60], round(us / 1e3, 3)] for key, us in ranked[:6]],
                device_ms=by_name)


def compare_first_step(tag, loss_t, g_t, loss_b, g_b) -> dict:
    """Raise unless one step patched (``loss_t``, gradients ``g_t``) and
    one unpatched agree: loss within ``LOSS_RTOL``, every gradient within
    ``GRAD_TOL`` of its largest element. Returns each gradient's error
    over its max."""
    import torch
    from repro_torch.optim.optimizer import tree_map
    torch.cuda.synchronize()
    if abs(float(loss_t) - float(loss_b)) > LOSS_RTOL * abs(float(loss_b)):
        raise AssertionError(f"{tag}: first-step loss {float(loss_t)} "
                             f"patched vs {float(loss_b)} unpatched")
    grad_err = {}

    def compare(name):
        def check(a, b):
            rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            grad_err[f"{name}.{len(grad_err)}"] = rel
            if not rel <= GRAD_TOL or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{tag}: gradient {name} differs, "
                                     f"{rel:.3e} of its max")
        return check
    for layer in g_t:
        tree_map(compare(layer), g_t[layer], g_b[layer])
    log(f"{tag}: first step loss {float(loss_t):.6f} patched, "
        f"{float(loss_b):.6f} unpatched; gradients agree to "
        f"{max(grad_err.values()):.2e} of their max (tolerance {GRAD_TOL})")
    return grad_err


def train_phase(tag, ds, arch, bundle, kernel) -> dict:
    """Phases 6 and 7 on a device ``bundle``: the first step patched
    against unpatched from the same weights, every operand that step
    launched against the plain version, then ``train_gnn`` patched (the
    main path, launch counts zeroed just before and read just after) and
    unpatched. Raises on any disagreement."""
    import torch
    from repro_torch.core.patch import patched
    from repro_torch.kernels import ops as kops
    from repro_torch.models.gnn import make_gnn
    from repro_torch.train.gnn import loss_and_grads, train_gnn

    g = bundle.graph(arch)
    fmt = "bsr" if kernel == "bsr_spmm" else "sell"
    way = {operand_ptr(getattr(g, fmt)): "fwd", operand_ptr(
        getattr(g, fmt + "_t")): "bwd"}
    init, apply = make_gnn(arch, ds.num_features, HIDDEN, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=DEVICE)
    x, y, m = (t.to(DEVICE) for t in (ds.x, ds.y, ds.train_mask))

    # (a) one step from the same weights, patched against unpatched
    with record_spmm(keep_inputs=True) as calls, patched(True):
        loss_t, g_t = loss_and_grads(apply, params, bundle, x, y, m)
    with patched(False):
        loss_b, g_b = loss_and_grads(apply, params, bundle, x, y, m)
    grad_err = compare_first_step(tag, loss_t, g_t, loss_b, g_b)

    # (b) every operand that step launched, on its own inputs
    operand_checks = []
    for c in calls:
        err, _, ratio = check_kernel(c["name"], c["a"], c["h"],
                                     f"{tag} {way[c['ptr']]} k{c['k']}")
        operand_checks.append(dict(kernel=c["name"], way=way[c["ptr"]],
                                   k=c["k"], max_abs_err=err,
                                   max_err_over_bound=ratio))
    del calls
    ways = sorted((o["way"], o["k"]) for o in operand_checks)
    log(f"{tag}: {len(operand_checks)} operands held against the plain "
        f"version {ways}, worst err/bound "
        f"{max(o['max_err_over_bound'] for o in operand_checks):.3f}")
    with patched(True):
        prof_t = step_profile(lambda: loss_and_grads(apply, params, bundle,
                                                     x, y, m))
    with patched(False):
        prof_b = step_profile(lambda: loss_and_grads(apply, params, bundle,
                                                     x, y, m))

    # (c) the main path: train_gnn patched, counts read around it
    kops.reset_kernel_launches()
    with record_spmm(keep_inputs=False) as calls:
        res_t = train_gnn(arch, ds, hidden=HIDDEN, epochs=TRAIN_EPOCHS,
                          lr=TRAIN_LR, weight_decay=TRAIN_WD, bundle=bundle,
                          params=params, use_isplib=True, device=DEVICE)
    launches = kops.kernel_launches()
    wrapper = kops._CUDA_WRAPPERS[kernel]
    by_route = dict(getattr(wrapper, "launches_by_instance", {}))
    workspace = getattr(wrapper, "workspace_bytes", 0)
    split = {w: sum(1 for c in calls if c["name"] == kernel
                    and way.get(c["ptr"]) == w) for w in ("fwd", "bwd")}
    if launches[kernel] == 0 or split["fwd"] == 0 or split["bwd"] == 0 or \
            launches[kernel] != len(calls):
        raise AssertionError(f"{tag}: {kernel} launches {launches}, "
                             f"dispatches {len(calls)}, split {split}")
    del calls
    kops.reset_kernel_launches()
    res_b = train_gnn(arch, ds, hidden=HIDDEN, epochs=TRAIN_EPOCHS,
                      lr=TRAIN_LR, weight_decay=TRAIN_WD, bundle=bundle,
                      params=params, use_isplib=False, device=DEVICE)
    if any(kops.kernel_launches().values()):
        raise AssertionError(f"{tag}: the unpatched run launched "
                             f"{kops.kernel_launches()}")
    for res in (res_t, res_b):
        if len(res.losses) != TRAIN_EPOCHS or \
                not np.isfinite(res.losses).all():
            raise AssertionError(f"{tag}: losses {res.losses}")
    log(f"{tag}: epoch {res_t.epoch_time_s * 1e3:.2f} ms tuned vs "
        f"{res_b.epoch_time_s * 1e3:.2f} ms baseline "
        f"({res_b.epoch_time_s / res_t.epoch_time_s:.2f}x); first epoch "
        f"{res_t.first_epoch_s:.2f} / {res_b.first_epoch_s:.2f} s")
    log(f"{tag}: losses tuned {[round(v, 5) for v in res_t.losses]}, "
        f"baseline {[round(v, 5) for v in res_b.losses]}; accuracy train "
        f"{res_t.train_acc:.4f} / {res_b.train_acc:.4f}, test "
        f"{res_t.test_acc:.4f} / {res_b.test_acc:.4f} (tuned / baseline)")
    mat = "Â" if arch == "gcn" else "A"
    log(f"{tag}: {kernel} launches {launches[kernel]} over "
        f"{TRAIN_EPOCHS} epochs + eval: forward on {mat} {split['fwd']}, "
        f"backward on the cached {mat}^T {split['bwd']}")
    own_ms = sum(ms for key, ms in prof_t["device_ms"].items()
                 if f"{kernel}_kernel" in key)
    log(f"{tag}: one step, device busy {prof_t['busy_share']:.3f} tuned "
        f"({prof_t['device_s'] * 1e3:.2f} ms of device time in "
        f"{prof_t['wall_s'] * 1e3:.2f} ms, {own_ms:.2f} ms of it in "
        f"{kernel}; top {prof_t['top'][:3]}), {prof_b['busy_share']:.3f} "
        f"baseline ({prof_b['device_s'] * 1e3:.2f} ms in "
        f"{prof_b['wall_s'] * 1e3:.2f} ms; top {prof_b['top'][:3]})")
    return dict(arch=arch, hidden=HIDDEN, epochs=TRAIN_EPOCHS, lr=TRAIN_LR,
                weight_decay=TRAIN_WD, plan=g.plan.to_json(),
                first_step=dict(loss_patched=float(loss_t),
                                loss_unpatched=float(loss_b),
                                grad_err_over_max=grad_err),
                operand_checks=operand_checks, launches=launches[kernel],
                launches_fwd=split["fwd"], launches_bwd=split["bwd"],
                launches_by_route=by_route, workspace_bytes=workspace,
                tuned={k: v for k, v in dataclasses.asdict(res_t).items()},
                baseline={k: v for k, v in
                          dataclasses.asdict(res_b).items()},
                speedup=res_b.epoch_time_s / res_t.epoch_time_s,
                step_profile=dict(tuned=prof_t, baseline=prof_b))


# -- full-graph GAT training through FusedMM (phase 9) ---------------------

@contextlib.contextmanager
def record_fusedmm():
    """Record every ``fusedmm_bsr`` dispatch (operand, copies of x, y, h,
    the edge op and of the output it returned); the dispatcher and its
    launch count are unchanged."""
    from repro_torch.kernels import ops as kops
    calls: list = []
    real = kops.fusedmm_bsr

    def recorded(a, x, y, h, *, edge_op="softmax"):
        out = real(a, x, y, h, edge_op=edge_op)
        calls.append(dict(a=a, x=x.detach().clone(), y=y.detach().clone(),
                          h=h.detach().clone(), edge_op=edge_op,
                          out=out.detach().clone()))
        return out
    kops.fusedmm_bsr = recorded
    try:
        yield calls
    finally:
        kops.fusedmm_bsr = real


def _holders(fn) -> list:
    """(module, name) of every loaded module of the port that holds ``fn``
    under a name (a function imported by name is patched there too)."""
    return [(m, name) for key, m in list(sys.modules.items())
            if key.startswith("repro_torch") and m is not None
            for name, v in list(vars(m).items()) if v is fn]


@contextlib.contextmanager
def record_edge_dots():
    """Record every per-edge SDDMM dispatch on ``DEVICE`` (copies of
    its operands and outputs; the edge ids are the graph's own): the
    dispatcher is wrapped wherever a module holds it, and it and the
    kernel's launch count are unchanged."""
    from repro_torch.kernels import edge_dots as ked
    calls: list = []
    real = ked.edge_dots

    def recorded(x, y, row, col, x2=None, y2=None):
        out = real(x, y, row, col, x2, y2)
        if x.device.type == DEVICE:
            outs = out if x2 is not None else (out,)
            calls.append(dict(
                args=tuple(None if t is None else
                           t.detach().float().contiguous().clone()
                           for t in (x, y, x2, y2)),
                row=row, col=col, out=tuple(o.clone() for o in outs)))
        return out
    holders = _holders(real)
    for m, name in holders:
        setattr(m, name, recorded)
    try:
        yield calls
    finally:
        for m, name in holders:
            setattr(m, name, real)


@contextlib.contextmanager
def count_plain_edge_dots():
    """Record the shapes of every call of the plain per-edge dot products
    (``kernels.ref.edge_dots``, under each name a loaded module of the
    port holds it by) on CUDA tensors."""
    from repro_torch.kernels import ref
    real = ref.edge_dots
    calls: list = []

    def counted(x, y, row, col):
        if x.is_cuda:
            calls.append(tuple(x.shape))
        return real(x, y, row, col)
    holders = _holders(real)
    for m, name in holders:
        setattr(m, name, counted)
    try:
        yield calls
    finally:
        for m, name in holders:
            setattr(m, name, real)


def check_edge_dots(c, tag) -> dict:
    """One recorded per-edge SDDMM launch against ``edge_dots_plain`` on
    the same card tensors: each score within 2 (D + 1) eps sum_d |x_d
    y_d| (two fp32 sums of the same D products in other orders)."""
    import torch
    from repro_torch.kernels.ref import edge_dots
    x, y, x2, y2 = c["args"]
    worst = ratio = 0.0
    for (a, b), got in zip(((x, y), (x2, y2)), c["out"]):
        want = edge_dots(a, b, c["row"], c["col"])
        mag = edge_dots(a.abs(), b.abs(), c["row"], c["col"])
        err = (got - want).abs()
        bound = 2 * (a.shape[1] + 1) * EPS32 * mag + 1e-30
        if not bool((err <= bound).all()) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"edge_dots {tag}: kernel disagrees with "
                                 f"plain, max err {float(err.max())}, worst "
                                 f"ratio {float((err / bound).max())}")
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / bound).max()))
    return dict(tag=tag, d=x.shape[1], k=None if x2 is None else x2.shape[1],
                edges=int(c["row"].shape[0]), dual=x2 is not None,
                max_abs_err=worst, max_err_over_bound=ratio)


def edge_dots_case(g, q, k, v) -> dict:
    """The per-edge SDDMM on A's edges at layer 1's widths (D = K =
    HIDDEN): single (the scores, as the forward and ``sddmm`` launch it)
    and dual (the backward's scores and dw_e = dout_row . h_col, ``q``
    standing in for dout): checked against the plain version, launched
    twice for bitwise repeats, timed beside the bound (each used row of
    the operands read once, 8 bytes of ids and 4 of output an edge; 2 D
    operations an edge and product), the plain version and
    ``torch.sparse.sampled_addmm`` on the same CSR for the same work
    (one call single, two dual; timed only)."""
    import torch
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.edge_dots import edge_dots_cuda, edge_dots_plain
    coo = g.coo
    n = coo.nse
    row, col = coo.row[:n], coo.col[:n]
    rows_used = int(torch.unique(row).numel())
    cols_used = int(torch.unique(col).numel())
    csr, kt, vt = device_csr(coo), k.t().contiguous(), v.t().contiguous()
    out: dict = dict(edges=n, d=HIDDEN)
    for way, args in (("single", (q, k)), ("dual", (q, k, q, v))):
        run = lambda: edge_dots_cuda(q, k, row, col, *args[2:])  # noqa: E731
        got, again = run(), run()
        torch.cuda.synchronize()
        got = got if way == "dual" else (got,)
        again = again if way == "dual" else (again,)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"edge_dots {way}: two launches on the same "
                                 "inputs differ")
        chk = check_edge_dots(dict(args=tuple(args) + (None,) * (4 - len(
            args)), row=row, col=col, out=got), f"A/{way}/d{HIDDEN}")
        del got, again
        prods = len(args) // 2
        nbytes = n * 8 + prods * (n * 4 + (rows_used + cols_used) * HIDDEN
                                  * 4)
        t_bytes = H100.mem_time(nbytes)
        t_ops = H100.vpu_time(2.0 * HIDDEN * n * prods)
        reps = 10
        libs = [(csr, q, kt)] if way == "single" else \
            [(csr, q, kt), (csr, q, vt)]
        out[way] = dict(
            ms=cuda_ms(run, reps=reps),
            device_ms=traced_ms(run, reps, "edge_dots_kernel"),
            plain_ms=cuda_ms(lambda: edge_dots_plain(q, k, row, col,
                                                     *args[2:]),
                             reps=3, warmup=1),
            library_ms=cuda_ms(lambda: [torch.sparse.sampled_addmm(
                *a, beta=0.0) for a in libs], reps=reps),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, **{key: chk[key] for key in
                             ("max_abs_err", "max_err_over_bound")})
    del csr, kt, vt
    return out


def check_fused(a, x, y, h, edge_op, tag, out=None) -> dict:
    """The fused kernel (or ``out``, what it already gave on these
    operands) against ``fusedmm_bsr_plain`` on the same card tensors.
    Tolerance: softmax rows are convex combinations of h rows, so atol
    ``FUSED_TOL`` x max|h|; sigmoid and none sum up to max-degree
    weighted rows, so atol ``FUSED_TOL`` x max|plain|."""
    import torch
    from repro_torch.kernels.fusedmm import fusedmm_bsr_cuda, fusedmm_bsr_plain
    if out is None:
        out = fusedmm_bsr_cuda(a, x, y, h, edge_op=edge_op)
    want = fusedmm_bsr_plain(a, x, y, h, edge_op=edge_op)
    scale = (h if edge_op == "softmax" else want).abs().max()
    atol = FUSED_TOL * float(scale) + 1e-30
    err = float((out - want).abs().max())
    if not err <= atol or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"fusedmm_bsr {tag}: kernel disagrees with "
                             f"plain, max err {err}, atol {atol}")
    return dict(edge_op=edge_op, max_abs_err=err, atol=atol,
                max_err_over_atol=err / atol)


def check_sddmm(a, x, y, out, scale_by_a, tag) -> dict:
    """The SDDMM kernel's ``out`` against the plain tile products, in
    chunks of tiles (the output alone is gigabytes). Each element must
    agree within 2 (D + 1) eps sum_d |x_i,d y_j,d| (|a_ij|): two fp32
    sums of the same D products in different orders, and the product
    with A."""
    import torch
    from repro_torch.kernels.ref import bsr_tile_chunks
    d = x.shape[1]
    worst, ratio = 0.0, 0.0
    for (lo, hi, s), (_, _, mag) in zip(
            bsr_tile_chunks(a, x, y, d),
            bsr_tile_chunks(a, x.abs(), y.abs(), d)):
        if scale_by_a:
            s = s * a.blocks[lo:hi]
            mag = mag * a.blocks[lo:hi].abs()
        err = (out[lo:hi] - s).abs()
        bound = 2 * (d + 1) * EPS32 * mag + 1e-30
        if not bool((err <= bound).all()) or \
                not bool(torch.isfinite(out[lo:hi]).all()):
            raise AssertionError(f"sddmm_bsr {tag}: kernel disagrees with "
                                 f"plain in tiles {lo}..{hi}, max err "
                                 f"{float(err.max())}, worst ratio "
                                 f"{float((err / bound).max())}")
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / bound).max()))
    return dict(scale_by_a=scale_by_a, max_abs_err=worst,
                max_err_over_bound=ratio)


def edge_case_times(name, kernel, plain, library, nbytes, flops,
                    tile_flops, edge_bytes, edge_flops) -> dict:
    """CUDA-event ms of the kernel, its plain version and the library
    call, the kernel's device ms from a profiler trace, and its bounds:
    ``bound_ms`` of the function on this run's data (``nbytes``, each
    input read and each output written once; ``flops``, the operations
    its output needs), ``bound_tile_ms`` / ``bound_tc_ms`` of the dense
    tile work the kernel does (``tile_flops``) at the fp32 / TF32 rate,
    and ``bound_edge_ms`` of the per-edge product read from an edge list
    (``edge_bytes``, ``edge_flops``), what a gather design would move."""
    from repro_torch.core.autotune import H100
    t_bytes, t_ops = H100.mem_time(nbytes), H100.vpu_time(flops)
    reps = 10
    by_kernel = device_us(kernel, reps=reps)
    kernel_us = sum(us for key, us in by_kernel.items()
                    if f"{name}_" in key and "kernel" in key)
    return dict(
        ms=cuda_ms(kernel, reps=reps),
        device_ms=kernel_us / reps / 1e3 if kernel_us else None,
        plain_ms=cuda_ms(plain, reps=3, warmup=1),
        library_ms=None if library is None else cuda_ms(library, reps=reps),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_tile_ms=max(t_bytes, H100.vpu_time(tile_flops)) * 1e3,
        bound_tc_ms=max(t_bytes, tile_flops / TF32_FLOPS) * 1e3,
        bound_edge_ms=max(H100.mem_time(edge_bytes),
                          H100.vpu_time(edge_flops)) * 1e3,
        bytes=nbytes, flops=flops, tile_flops=tile_flops,
        edge_bytes=edge_bytes, edge_flops=edge_flops)


def dense_mask(coo):
    """A's nonzero pattern as a dense (n, n) bool matrix on the card, for
    ``scaled_dot_product_attention`` (a yardstick the port never
    calls)."""
    import torch
    n = coo.nse
    mask = torch.zeros((coo.nrows, coo.ncols), dtype=torch.bool,
                       device=coo.row.device)
    mask[coo.row[:n].long(), coo.col[:n].long()] = coo.val[:n] != 0
    return mask


def repeat_step_bitwise(tag, apply, params, bundle, x, y, m, loss, grads
                        ) -> dict:
    """The patched first step once more from the same weights: the loss
    and every gradient must equal the first run's bit for bit."""
    import torch
    from repro_torch.core.patch import patched
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train.gnn import loss_and_grads
    with patched(True):
        loss2, grads2 = loss_and_grads(apply, params, bundle, x, y, m)
    same: list = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), grads, grads2)
    if not torch.equal(loss, loss2) or not same or not all(same):
        raise AssertionError(f"{tag}: the first step run twice from the "
                             f"same weights differs (loss {float(loss)} / "
                             f"{float(loss2)}, {same.count(False)} of "
                             f"{len(same)} gradients)")
    log(f"{tag}: the first step run twice from the same weights: loss and "
        f"all {len(same)} gradients equal bit for bit")
    return dict(gradients=len(same), loss=float(loss))


def sage_max_repeat(ds) -> dict:
    """GraphSAGE-max on the same graph (hidden 256, untuned: the max
    semiring takes the trusted path whatever the plan, its backward the
    subgradient's ordered sum): the patched first step twice from the
    same weights, bitwise."""
    import torch
    from repro_torch.core.patch import patched
    from repro_torch.kernels import ops as kops
    from repro_torch.models.gnn import build_bundle, make_gnn
    from repro_torch.train.gnn import loss_and_grads
    bundle = build_bundle(ds, k_hint=HIDDEN, tune=False,
                          arch="sage-max").to(DEVICE)
    init, apply = make_gnn("sage-max", ds.num_features, HIDDEN,
                           ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=DEVICE)
    x, y, m = (t.to(DEVICE) for t in (ds.x, ds.y, ds.train_mask))
    kops.reset_kernel_launches()
    with patched(True):
        loss, grads = loss_and_grads(apply, params, bundle, x, y, m)
    launched = kops.kernel_launches()["segment_sum"]
    if launched == 0:
        raise AssertionError("sage-max: the patched step launched no "
                             "segment_sum (the subgradient's scatter)")
    out = repeat_step_bitwise("sage-max", apply, params, bundle, x, y, m,
                              loss, grads)
    out["segment_sum_launches"] = launched
    del bundle
    torch.cuda.empty_cache()
    return out


def segment_sum_case(g, x, y, h) -> dict:
    """The ordered segment sum as layer 1's backward runs it for dh (K =
    HIDDEN): A's edges in the cached column order, gathering h[row] by
    the order's cached index, the softmax weights of x, y read through
    its ``perm``: checked against the plain version (2 d eps sum|terms|
    a target of d slots), launched twice for bitwise repeats, timed
    beside its bound and ``torch.sparse.mm`` on the same CSR (timed only),
    also at K = 112 (layer 2's width)."""
    import torch
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.edge_dots import edge_dots
    from repro_torch.kernels.ref import edge_weights
    from repro_torch.kernels.segment_sum import (segment_sum_sorted_cuda,
                                                 segment_sum_sorted_plain)
    coo, order = g.coo, g.col_order
    n = coo.nse
    with torch.no_grad():
        w = edge_weights(edge_dots(x, y, coo.row[:n], coo.col[:n]),
                         coo.row[:n], coo.nrows, None, "softmax",
                         order=g.row_order).float().contiguous()
    perm, index, offsets = order.perm, order.src, order.offsets
    t = offsets.shape[0] - 1
    weight = w.index_select(0, perm)
    rows_read = int(torch.unique(index).numel())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        csr = torch.sparse_csr_tensor(offsets, index.long(), weight,
                                      size=(t, h.shape[0]))
    reps = 10
    out: dict = {}
    for k in (HIDDEN, 112):
        src = h[:, :k].float().contiguous()
        run = (lambda: segment_sum_sorted_cuda(src, offsets, index=index,
                                               weight=w, weight_index=perm),
               lambda: segment_sum_sorted_plain(src, offsets, index=index,
                                                weight=weight))
        got, again = run[0](), run[0]()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("segment_sum: two launches on the same "
                                 "inputs differ")
        want = run[1]()
        mag = segment_sum_sorted_plain(src.abs(), offsets, index=index,
                                       weight=weight.abs())
        d = torch.diff(offsets).to(torch.float32)[:, None]
        err = (got - want).abs()
        bound = 2 * EPS32 * d * mag + 1e-30
        if not bool((err <= bound).all()) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"segment_sum k{k}: max err "
                                 f"{float(err.max())}, worst ratio "
                                 f"{float((err / bound).max())}")
        del want, mag
        nbytes = n * 8 + (t + 1) * 8 + rows_read * k * 4 + t * k * 4
        t_bytes, t_ops = H100.mem_time(nbytes), H100.vpu_time(2.0 * n * k)
        case = dict(tag=f"gat dh, A^T by column/{t}x{k}/{n} slots",
                    max_abs_err=float(err.max()),
                    max_err_over_bound=float((err / bound).max()),
                    ms=cuda_ms(run[0], reps=reps),
                    device_ms=traced_ms(run[0], reps, "segment_sum_kernel"),
                    plain_ms=cuda_ms(run[1], reps=3, warmup=1),
                    library_ms=cuda_ms(lambda: torch.sparse.mm(csr, src),
                                       reps=reps),
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, max_slots=int(d.max()))
        if k == HIDDEN:
            out.update(case)
        else:
            out["k112"] = case
        del got, again, src
    del csr, index, weight
    return out


def gat_phase() -> dict:
    """Phase 9: full-graph GAT training on ogbn-proteins at GAT_SCALE with
    A pinned to BSR 128 x 128: the first step patched against unpatched
    (every fused launch held against the plain version on its own
    inputs), ``train_gnn`` patched (launch counts zeroed just before and
    read just after) and unpatched, then the SDDMM op on A's tiles (its
    own path, counted the same way), and both kernels checked and timed
    at D = K = HIDDEN on layer 1's own q, k, v."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.autotune import KernelPlan, autotune
    from repro_torch.core.patch import patched
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fusedmm import (fusedmm_bsr_cuda,
                                             fusedmm_bsr_plain,
                                             tiles_by_route)
    from repro_torch.kernels.ref import edge_dots
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda, sddmm_bsr_plain
    from repro_torch.models.gnn import build_bundle, make_gnn
    from repro_torch.train.gnn import loss_and_grads, train_gnn

    t0 = time.perf_counter()
    ds = make_dataset("ogbn-proteins", scale=GAT_SCALE)
    cut = (f"ogbn-proteins at scale 1/{round(1 / GAT_SCALE)} "
           f"({ds.num_nodes} nodes, {ds.coo.nse} edges): at scale 1/2 the "
           f"gat bundle's two 128x128 BSR operands (A, A^T) take 29.4 GB "
           f"and the unpatched baseline's plain autograd keeps ~3 (E, 256) "
           f"and ~3 (E, 112) fp32 edge tensors, ~66 GB: more than the "
           f"card's 80 GB together; at 1/4 ~8 + ~31 GB")
    log(f"cut: {cut}")
    would = autotune(ds.coo, HIDDEN)
    log(f"gat: the tuner would pick {would.kind} (br={would.br}, "
        f"bc={would.bc}, C={would.sell_c}) for A at K={HIDDEN}; pinned to "
        f"bsr 128x128")
    plan = KernelPlan(kind="bsr", br=128, bc=128, fk=64, k_hint=HIDDEN)
    bundle = build_bundle(ds, k_hint=HIDDEN, plan=plan,
                          arch="gat").to(DEVICE)
    g = bundle.graph("gat")
    a = g.bsr
    log(f"gat: {ds.num_nodes} nodes, {ds.coo.nse} edges, "
        f"{ds.num_features} features, {ds.num_classes} classes, max degree "
        f"{int(g.degrees.max())}; A has {a.nblocks} tiles of 128x128 "
        f"({a.density:.4f} of all, {a.blocks.numel() * 4 / 1e9:.2f} GB, "
        f"fill {ds.coo.nse / a.blocks.numel():.5f}), built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    init, apply = make_gnn("gat", ds.num_features, HIDDEN, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=DEVICE)
    x, y, m = (t.to(DEVICE) for t in (ds.x, ds.y, ds.train_mask))

    # (1) the first step, patched against unpatched, every fused and
    # per-edge SDDMM launch against the plain version on its own inputs,
    # and no plain per-edge dot product on a card tensor
    kops.reset_kernel_launches()
    with record_fusedmm() as calls, record_edge_dots() as e_calls, \
            count_plain_edge_dots() as plain_dots, patched(True):
        loss_t, g_t = loss_and_grads(apply, params, bundle, x, y, m)
    step_launches = kops.kernel_launches()
    if plain_dots:
        raise AssertionError(f"gat: the patched step ran the plain "
                             f"edge_dots on card tensors {plain_dots}")
    if sorted(len(c["out"]) for c in e_calls) != [1, 2, 2] or \
            step_launches["edge_dots"] != len(e_calls):
        raise AssertionError(
            f"gat: the patched step launched edge_dots "
            f"{step_launches['edge_dots']} times, recorded "
            f"{[(len(c['out']), c['args'][0].shape[1]) for c in e_calls]}: "
            f"expected layer 2's forward scores and one dual launch in "
            f"each layer's backward")
    e_checks = [check_edge_dots(c, f"first step {i} d{c['args'][0].shape[1]}"
                                f"{' dual' if len(c['out']) == 2 else ''}")
                for i, c in enumerate(e_calls)]
    del e_calls
    log(f"gat: {len(e_checks)} edge_dots launches of the first step held "
        f"against the plain version: {e_checks}; plain edge_dots on card "
        f"tensors in the step: none")
    step_routes = tiles_by_route()
    if not step_routes["edge"]:
        raise AssertionError(f"gat: the first step's fused launch took the "
                             f"per-edge route on no tile: {step_routes}")
    with patched(False):
        loss_b, g_b = loss_and_grads(apply, params, bundle, x, y, m)
    grad_err = compare_first_step("gat", loss_t, g_t, loss_b, g_b)
    repeat = repeat_step_bitwise("gat", apply, params, bundle, x, y, m,
                                 loss_t, g_t)
    if [c["h"].shape[1] for c in calls] != [HIDDEN]:
        raise AssertionError(f"gat: the patched step dispatched fusedmm at "
                             f"K = {[c['h'].shape[1] for c in calls]}, "
                             f"expected layer 1 only (K = {HIDDEN})")
    step_checks = [check_fused(c["a"], c["x"], c["y"], c["h"], c["edge_op"],
                               f"first step k{c['h'].shape[1]}", out=c["out"])
                   for c in calls]
    del calls
    log(f"gat: {len(step_checks)} fused launch(es) of the first step held "
        f"against the plain version: {step_checks}; tiles by route "
        f"{step_routes} (32-row slices)")
    with patched(True):
        prof_t = step_profile(lambda: loss_and_grads(apply, params, bundle,
                                                     x, y, m))
    with patched(False):
        prof_b = step_profile(lambda: loss_and_grads(apply, params, bundle,
                                                     x, y, m))

    # (2) the main path: train_gnn patched, counts read around it
    runs = {}
    for use in (True, False):
        torch.cuda.reset_peak_memory_stats()
        kops.reset_kernel_launches()
        res = train_gnn("gat", ds, hidden=HIDDEN, epochs=TRAIN_EPOCHS,
                        lr=TRAIN_LR, weight_decay=TRAIN_WD, bundle=bundle,
                        params=params, use_isplib=use, device=DEVICE)
        runs[use] = (res, kops.kernel_launches(),
                     torch.cuda.max_memory_allocated() / 1e9)
        if use:
            main_routes = tiles_by_route()
            main_instances = dict(getattr(
                kops._CUDA_WRAPPERS["fusedmm_bsr"], "launches_by_instance",
                {}))
        if len(res.losses) != TRAIN_EPOCHS or \
                not np.isfinite(res.losses).all():
            raise AssertionError(f"gat: losses {res.losses}")
    (res_t, launches, peak_t), (res_b, launches_b, peak_b) = \
        runs[True], runs[False]
    if launches["fusedmm_bsr"] == 0 or any(launches_b.values()) or \
            main_instances != {"edge": launches["fusedmm_bsr"]} or \
            not main_routes["edge"] or launches["segment_sum"] == 0 or \
            launches["edge_dots"] == 0:
        raise AssertionError(f"gat: launches {launches} patched "
                             f"({main_instances}, tiles by route "
                             f"{main_routes}), {launches_b} unpatched")
    log(f"gat: epoch {res_t.epoch_time_s * 1e3:.2f} ms tuned vs "
        f"{res_b.epoch_time_s * 1e3:.2f} ms baseline "
        f"({res_b.epoch_time_s / res_t.epoch_time_s:.2f}x); first epoch "
        f"{res_t.first_epoch_s:.2f} / {res_b.first_epoch_s:.2f} s; peak "
        f"device memory {peak_t:.2f} / {peak_b:.2f} GB")
    log(f"gat: losses tuned {[round(v, 5) for v in res_t.losses]}, "
        f"baseline {[round(v, 5) for v in res_b.losses]}; accuracy train "
        f"{res_t.train_acc:.4f} / {res_b.train_acc:.4f}, test "
        f"{res_t.test_acc:.4f} / {res_b.test_acc:.4f} (tuned / baseline)")
    log(f"gat: fusedmm_bsr launches {launches['fusedmm_bsr']} over "
        f"{TRAIN_EPOCHS} epochs + eval (layer 1, K = {HIDDEN}), all of the "
        f"per-edge kernel, tiles by route {main_routes}; segment_sum "
        f"launches {launches['segment_sum']} (the ordered sums of the "
        f"backward and of layer 2); edge_dots launches "
        f"{launches['edge_dots']} (layer 2's scores, both backwards); "
        f"unpatched {launches_b}")
    own_ms = sum(ms for key, ms in prof_t["device_ms"].items()
                 if "fusedmm_" in key and "kernel" in key)
    log(f"gat: one step, device busy {prof_t['busy_share']:.3f} tuned "
        f"({prof_t['device_s'] * 1e3:.2f} ms of device time in "
        f"{prof_t['wall_s'] * 1e3:.2f} ms, {own_ms:.2f} ms of it in "
        f"fusedmm; top {prof_t['top'][:4]}), {prof_b['busy_share']:.3f} "
        f"baseline ({prof_b['device_s'] * 1e3:.2f} ms in "
        f"{prof_b['wall_s'] * 1e3:.2f} ms; top {prof_b['top'][:4]})")

    # layer 1's own operands at D = K = HIDDEN (as dot_gat_conv builds them)
    with torch.no_grad():
        p1 = params["l1"]
        hid = x @ params["proj"]
        q = (hid @ p1["wq"]) * (1.0 / HIDDEN ** 0.5)
        k, v = hid @ p1["wk"], hid @ p1["wv"]

    # (3) the SDDMM op on A's tiles: layer 1's attention logits, its own
    # path, counts read around it
    kops.reset_kernel_launches()
    s_out = {sc: kops.sddmm_bsr(a, q, k, scale_by_a=sc) for sc in (True, False)}
    sddmm_launches = kops.kernel_launches()["sddmm_bsr"]
    sddmm_instances = dict(sddmm_bsr_cuda.launches_by_instance)
    if sddmm_launches != 2 or sddmm_instances != {"nnz": 1, "tile": 1}:
        raise AssertionError(f"gat: sddmm_bsr launches {sddmm_launches}, "
                             f"by instance {sddmm_instances}: the scaled "
                             f"call must run the per-nonzero kernel, the "
                             f"unscaled one the tile kernel")
    sddmm_checks = [check_sddmm(a, q, k, s_out[sc], sc, f"A scale_by_a={sc}")
                    for sc in (True, False)]
    del s_out
    log(f"gat: sddmm_bsr on A (D = {HIDDEN}), {sddmm_launches} launches "
        f"{sddmm_instances}, held against the plain tile products: "
        f"{sddmm_checks}")

    # (4) both kernels timed at D = K = HIDDEN beside their bounds, plain
    # versions and one library call each (timed only)
    n_real = ds.num_nodes
    nb, tile = a.nblocks, a.br * a.bc
    used = min(int(torch.unique(a.blk_col).numel()) * a.bc, ds.num_nodes)
    e = ds.coo.nse
    row, col = g.coo.row[:e], g.coo.col[:e]
    csr, kt = device_csr(g.coo), k.t().contiguous()
    cases = []
    # unscaled, the function is every real tile position's score: one
    # sampled_addmm over the tiles' full pattern computes it
    pattern, tiles0 = tile_pattern_csr(a)
    qp = torch.zeros(a.nrows, HIDDEN, device=q.device)
    qp[:q.shape[0]] = q
    kp = torch.zeros(a.ncols, HIDDEN, device=k.device)
    kp[:k.shape[0]] = k
    kpt = kp.t().contiguous()
    for sc in (True, False):
        # scaled by A, a position with A_ij = 0 stores 0: the output needs
        # one dot product per edge; unscaled, every tile position's
        nbytes = nb * tile * 4 * (2 if sc else 1) + nb * 8 + \
            (n_real + used) * HIDDEN * 4
        tile_flops = 2.0 * nb * tile * HIDDEN + (nb * tile if sc else 0)
        edge_bytes = e * 8 * (2 if sc else 1) + (n_real + used) * HIDDEN * 4
        if sc:
            library = (lambda: torch.sparse.sampled_addmm(csr, q, kt,
                                                          beta=0.0))
            lib_name = "torch.sparse.sampled_addmm (CSR, edges only)"
            lib_err = float((library().values() - edge_dots(
                q, k, row, col)).abs().max())
        else:
            library = (lambda: torch.sparse.sampled_addmm(
                pattern, qp, kpt, beta=0.0))
            lib_name = (f"torch.sparse.sampled_addmm (CSR over the "
                        f"{a.n_real_blocks} real tiles' full pattern, "
                        f"{pattern._nnz()} positions)")
            got = library().values()[: a.br * tiles0 * a.bc].reshape(
                a.br, tiles0, a.bc).permute(1, 0, 2)
            lib_err = float((got - sddmm_bsr_cuda(
                a, q, k, scale_by_a=False)[:tiles0]).abs().max())
            del got
        case = dict(name="sddmm_bsr", tag=f"A/d{HIDDEN}/scale_by_a={sc}",
                    instance="nnz" if sc else "tile",
                    **edge_case_times(
                        "sddmm", lambda: sddmm_bsr_cuda(a, q, k, scale_by_a=sc),
                        lambda: sddmm_bsr_plain(a, q, k, scale_by_a=sc),
                        library,
                        nbytes, (2.0 * HIDDEN + 1) * e if sc else tile_flops,
                        tile_flops, edge_bytes, 2.0 * e * HIDDEN),
                    library=lib_name, library_max_abs_diff=lib_err,
                    **next(c for c in sddmm_checks if c["scale_by_a"] == sc))
        cases.append(case)
    del csr, kt, pattern, qp, kp, kpt
    mask = dense_mask(g.coo)
    has = mask.any(dim=1)
    for op in ("softmax", "sigmoid", "none"):
        kops.reset_kernel_launches()
        chk = check_fused(a, q, k, v, op, f"A/d{HIDDEN}/k{HIDDEN}")
        chk["tiles_by_route"] = tiles_by_route()
        library = lib_err = lib_note = None
        if op == "softmax":
            def library():
                return F.scaled_dot_product_attention(
                    q[None, None], k[None, None], v[None, None],
                    attn_mask=mask, scale=1.0)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    got = library()[0, 0]
                lib_err = float((got[has] - fusedmm_bsr_plain(
                    a, q, k, v)[: n_real][has]).abs().max())
                del got
            except RuntimeError as err:        # no SDPA kernel for it
                lib_note, library = f"{type(err).__name__}: {err}"[:200], None
        nbytes = nb * tile * 4 + nb * 8 + (n_real + 2 * used) * HIDDEN * 4 \
            + a.nrows * HIDDEN * 4
        edge_bytes = e * 8 + (n_real + 2 * used) * HIDDEN * 4 + \
            n_real * HIDDEN * 4
        case = dict(name="fusedmm_bsr", tag=f"A/d{HIDDEN}/k{HIDDEN}/{op}",
                    **edge_case_times(
                        "fusedmm",
                        lambda: fusedmm_bsr_cuda(a, q, k, v, edge_op=op),
                        lambda: fusedmm_bsr_plain(a, q, k, v, edge_op=op),
                        library, nbytes, 2.0 * e * (2 * HIDDEN),
                        2.0 * nb * tile * (2 * HIDDEN), edge_bytes,
                        2.0 * e * (2 * HIDDEN)),
                    library=("F.scaled_dot_product_attention (dense "
                             f"{ds.num_nodes}^2 bool mask)"
                             if op == "softmax" else None),
                    library_max_abs_diff=lib_err, library_note=lib_note,
                    **chk)
        cases.append(case)
    del mask
    seg_case = segment_sum_case(g, q, k, v)
    for c in (seg_case, seg_case["k112"]):
        log(f"  segment_sum {c['tag']}: ms {c['ms']:.4f} device "
            f"{fmt_ms(c['device_ms'])} plain {c['plain_ms']:.4f} bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']}) sparse.mm "
            f"{fmt_ms(c['library_ms'])}; err/bound "
            f"{c['max_err_over_bound']:.3f}; bitwise repeatable")
    e_case = edge_dots_case(g, q, k, v)
    for way in ("single", "dual"):
        c = e_case[way]
        log(f"  edge_dots A/{way}/d{HIDDEN} ({e_case['edges']} edges): ms "
            f"{c['ms']:.4f} device {fmt_ms(c['device_ms'])} plain "
            f"{c['plain_ms']:.4f} bound {c['bound_ms']:.4f} "
            f"({c['bound_by']}) sampled_addmm {fmt_ms(c['library_ms'])}; "
            f"err/bound {c['max_err_over_bound']:.3f}; bitwise repeatable")
    sage_max = sage_max_repeat(ds)
    for c in cases:
        log(f"  {c['name']:11s} {c['tag']:30s} ms {c['ms']:.4f} device "
            f"{fmt_ms(c['device_ms'])} plain {c['plain_ms']:.4f} bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']}; dense tiles "
            f"{c['bound_tile_ms']:.4f}, TF32 {c['bound_tc_ms']:.4f}; edge "
            f"list {c['bound_edge_ms']:.4f}) "
            f"library {fmt_ms(c['library_ms'])} err {c['max_abs_err']:.2e}")
    return dict(arch="gat", hidden=HIDDEN, epochs=TRAIN_EPOCHS, lr=TRAIN_LR,
                weight_decay=TRAIN_WD, cut=cut, pinned=True,
                tuner_pick=would.to_json(), plan=g.plan.to_json(), tiles=nb,
                nodes=ds.num_nodes, edges=e,
                first_step=dict(loss_patched=float(loss_t),
                                loss_unpatched=float(loss_b),
                                grad_err_over_max=grad_err,
                                repeat_bitwise=repeat),
                sage_max_repeat=sage_max, segment_sum_case=seg_case,
                segment_sum_launches=launches["segment_sum"],
                edge_dots_case=e_case, edge_dots_checks=e_checks,
                edge_dots_launches=launches["edge_dots"],
                edge_dots_step_launches=step_launches["edge_dots"],
                step_checks=step_checks, sddmm_checks=sddmm_checks,
                launches=launches["fusedmm_bsr"],
                launches_by_instance=main_instances,
                tiles_by_route=dict(first_step=step_routes,
                                    main_path=main_routes),
                sddmm_launches=sddmm_launches,
                sddmm_instances=sddmm_instances,
                tuned=dataclasses.asdict(res_t),
                baseline=dataclasses.asdict(res_b),
                speedup=res_b.epoch_time_s / res_t.epoch_time_s,
                peak_gb=dict(tuned=peak_t, baseline=peak_b),
                step_profile=dict(tuned=prof_t, baseline=prof_b),
                cases=cases)


# -- device-sampled minibatch training (phase 8) ---------------------------

SAMPLE_KERNELS = ("segment_sample", "expand_indptr", "flat_gather")
HOP_KERNEL = "sample_hop"        # the three fused: one launch a hop


@contextlib.contextmanager
def record_sampling():
    """Record the inputs and output of every fused sampling hop, ELL
    forward and block backward the device sampler and the block SpMM
    dispatch run (copies, so later steps cannot touch them), and of any
    standalone sampling primitive (the main path runs none). The
    dispatchers and their launch counts are unchanged."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sample as ks
    from repro_torch.sampling import blocks as bl
    calls: list = []
    saved = [(ks, n, getattr(ks, n)) for n in SAMPLE_KERNELS + (HOP_KERNEL,)
             ] + [(kops, "ell_spmm", kops.ell_spmm),
                  (bl, "ell_transpose_reduce", bl.ell_transpose_reduce)]

    def clone(v):
        if isinstance(v, tuple):
            return tuple(clone(t) for t in v)
        return v.detach().clone() if hasattr(v, "detach") else v

    def wrap(name, fn):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            calls.append(dict(name=name, args=[clone(v) for v in a],
                              kw=dict(kw), out=clone(out)))
            return out
        return recorded
    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_sample_call(c) -> dict:
    """Run a recorded sampling primitive's kernel and its plain version on
    the card on the recorded inputs: they must equal each other (and the
    recorded output, where there is one) bit for bit."""
    import torch
    from repro_torch.kernels import sample as ks
    a, kw = c["args"], c["kw"]
    if c["name"] == HOP_KERNEL:
        run = (lambda: ks.sample_hop_cuda(*a, **kw),
               lambda: ks.sample_hop_plain(*a, **kw))
    elif c["name"] == "segment_sample":
        opts = dict(width=kw["width"], seed=kw["seed"], hop=kw["hop"],
                    replace=kw["replace"])
        run = (lambda: ks.segment_sample_cuda(a[0], a[1], a[2], **opts),
               lambda: ks.segment_sample_plain(a[0], a[1], a[2], **opts))
    elif c["name"] == "expand_indptr":
        run = (lambda: ks.expand_indptr_cuda(a[0], a[1], a[2], **kw),
               lambda: ks.expand_indptr_plain(a[0], a[1], a[2], **kw))
    else:
        run = (lambda: ks.flat_gather_cuda(a[0], a[1]),
               lambda: ks.flat_gather_plain(a[0], a[1]))
    got, want = run[0](), run[1]()
    torch.cuda.synchronize()
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    pairs = list(zip(gots, wants))
    if c.get("out") is not None:
        outs = c["out"] if isinstance(c["out"], tuple) else (c["out"],)
        pairs += list(zip(gots, outs))
    if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs):
        shapes = [tuple(t.shape) for t in a if hasattr(t, "shape")]
        raise AssertionError(f"{c['name']}: kernel and plain version differ "
                             f"on the step's inputs {shapes}")
    return dict(run=run, out=got)


def hop_primitive_calls(c) -> list:
    """The three standalone primitives' calls on one recorded hop's plain
    intermediates (degrees and ids; start, ranks and the mask; the two
    arrays and the positions), built on the card the way the plain hop
    builds them; each has no recorded output (its plain version is the
    reference)."""
    import torch
    from repro_torch.kernels import sample as ks
    indptr, indices, val, frontier, rnd = c["args"]
    kw = c["kw"]
    n, nse = indptr.shape[0] - 1, indices.shape[0] - 1
    start = indptr[frontier.clamp(0, n).long()].contiguous()
    deg = (indptr[(frontier + 1).clamp(0, n).long()] - start).contiguous()
    ranks = ks.segment_sample_plain(deg, frontier, rnd, width=kw["width"],
                                    seed=kw["seed"], hop=kw["hop"],
                                    replace=kw["replace"])
    valid = ks.sample_valid_mask(deg, width=kw["width"], fanout=kw["fanout"],
                                 replace=kw["replace"]).contiguous()
    pos = ks.expand_indptr_plain(start, ranks, valid, sentinel=nse)
    sample_kw = dict(width=kw["width"], fanout=kw["fanout"], seed=kw["seed"],
                     hop=kw["hop"], replace=kw["replace"])
    return [dict(name="segment_sample", args=[deg, frontier, rnd],
                 kw=sample_kw, out=None),
            dict(name="expand_indptr", args=[start, ranks, valid],
                 kw=dict(sentinel=nse), out=None),
            dict(name="flat_gather", args=[indices, pos], kw={}, out=None),
            dict(name="flat_gather", args=[val, pos], kw={}, out=None)]


def old_hop(c):
    """The hop as the device sampler ran it before the fused kernel: two
    indptr gathers and a subtraction, ``segment_sample``, the mask,
    ``expand_indptr`` and two ``flat_gather`` launches (a yardstick: the
    port no longer calls it this way)."""
    from repro_torch.kernels import sample as ks
    indptr, indices, val, frontier, rnd = c["args"]
    kw = c["kw"]
    n, nse = indptr.shape[0] - 1, indices.shape[0] - 1

    def run():
        start = indptr[frontier.clamp(0, n).long()]
        deg = indptr[(frontier + 1).clamp(0, n).long()] - start
        ranks = ks.segment_sample(deg, frontier, rnd, width=kw["width"],
                                  fanout=kw["fanout"], seed=kw["seed"],
                                  hop=kw["hop"], replace=kw["replace"])
        valid = ks.sample_valid_mask(deg, width=kw["width"],
                                     fanout=kw["fanout"],
                                     replace=kw["replace"])
        pos = ks.expand_indptr(start, ranks, valid, sentinel=nse)
        return ks.flat_gather(indices, pos), ks.flat_gather(val, pos), valid
    return run


def segment_sample_ops(deg, *, width: int, replace: bool) -> int:
    """Integer operations the draws need on these degrees, counted from
    a per-thread design of ``segment_sample``, one thread scanning its
    row's override table (the warp design of
    ``src/repro_torch/csrc/sample.cu`` spreads the same compares across
    lanes, so it issues more): 9 per hash
    (3 shifts, 3 xors and 2 multiplies in the avalanche, the xor that
    feeds it), four hashes for a row's prefix, one hash and 8 operations
    per draw (convert, scale, subtract, floor, convert, clamp, add), and
    without replacement 3 table writes per step and 2 compares per
    override slot scanned (step j scans j slots). Rows with ``deg <=
    width`` (without replacement) write identity ranks: one operation a
    slot."""
    import torch
    n = int(deg.numel())
    per_hash, per_draw = 9, 9 + 8
    row_prefix = 4 * per_hash
    if replace:
        return n * (row_prefix + width * per_draw)
    n_fy = int((deg.to(torch.int64) > width).sum())
    fy_row = row_prefix + width * (per_draw + 3) + width * (width - 1)
    return n_fy * fy_row + (n - n_fy) * width


def sample_case(c, hop: int) -> dict:
    """Time one recorded sampling primitive or fused hop (kernel, plain,
    library where one call computes it; the fused hop beside the
    unfused hop it replaced) and its bound from this call's inputs, and
    the host µs its wrapper takes to enqueue a launch."""
    import torch
    from repro_torch.core.autotune import H100
    run = check_sample_call(c)["run"]
    a = c["args"]
    name = c["name"]
    library_ms = old_ms = None
    if name == HOP_KERNEL:
        indptr, indices, val, frontier, _ = a
        f, width = frontier.shape[0], c["kw"]["width"]
        n = indptr.shape[0] - 1
        start = indptr[frontier.clamp(0, n).long()]
        deg = indptr[(frontier + 1).clamp(0, n).long()] - start
        real = int(torch.clamp(deg, max=width).sum())
        # the frontier, two indptr reads a row, each output once, each
        # real slot's index and value gathered once
        nbytes = f * 12 + f * width * 9 + real * 8
        ops = segment_sample_ops(deg, width=width,
                                 replace=c["kw"]["replace"]) + 2 * f * width
        old_ms = cuda_ms(old_hop(c))
        dtype = "int32/fp32/bool"
    elif name == "segment_sample":
        deg, width = a[0], c["kw"]["width"]
        f = deg.shape[0]
        nbytes = f * 8 + f * width * 4
        ops = segment_sample_ops(deg, width=width,
                                 replace=c["kw"]["replace"])
        dtype = "int32"
    elif name == "expand_indptr":
        f, width = a[1].shape
        nbytes = f * 4 + f * width * (4 + 1 + 4)
        ops = 2 * f * width
        dtype = "int32"
        # the yardstick: each row's start expanded to its slots
        library_ms = cuda_ms(lambda: torch.repeat_interleave(
            a[0], width, output_size=f * width))
    else:
        arr, pos = a
        f, width = pos.shape
        n_read = int(torch.unique(pos).numel())
        nbytes = f * width * 8 + n_read * 4
        ops = f * width
        library_ms = cuda_ms(lambda: torch.take(arr, pos.long()))
        dtype = str(arr.dtype)
    t_bytes, t_ops = H100.mem_time(nbytes), ops / INT32_OPS
    reps = 20
    kernel_key = f"{name}_kernel"
    dev_us = sum(us for key, us in device_us(run[0], reps).items()
                 if kernel_key in key)
    return dict(name=name, hop=hop, f=f, width=width, dtype=dtype,
                max_abs_err=0.0, ms=cuda_ms(run[0]),
                device_ms=dev_us / reps / 1e3 if dev_us else None,
                plain_ms=cuda_ms(run[1], reps=5, warmup=1),
                library_ms=library_ms, unfused_hop_ms=old_ms,
                host_us=host_us(run[0]),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, int_ops=ops)


def check_block_backward(c) -> dict:
    """The block backward (``dh = Aᵀ dout`` by ``index_add_``) on the card
    against the same function on the CPU, on the step's own inputs: each
    element within 2 d eps sum|terms|, d its real slots."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.kernels.ref import ell_transpose_reduce
    a, dout = c["args"]
    got = c["out"]
    cpu_a = sp.to_device(a, "cpu")
    want = ell_transpose_reduce(cpu_a, dout.cpu())
    mag = ell_transpose_reduce(dataclasses.replace(cpu_a, val=cpu_a.val.abs()),
                               dout.abs().cpu())
    idx = cpu_a.idx.long().reshape(-1)
    d = torch.bincount(idx[idx < a.ncols], minlength=a.ncols)
    err = (got.cpu() - want).abs()
    bound = 2 * EPS32 * d.to(torch.float32)[:, None] * mag + 1e-30
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"block backward disagrees with the CPU: max "
                             f"err {float(err.max())}, worst ratio "
                             f"{float((err / bound).max())}")
    return dict(k=dout.shape[1], rows=a.nrows, width=a.max_deg,
                max_abs_err=float(err.max()),
                max_err_over_bound=float((err / bound).max()))


def sparse_csr(row, col, val, shape):
    """A CSR tensor on the card (``torch.sparse.mm``'s operand, a
    yardstick the port never calls) from COO triplets in any order."""
    import torch
    order = torch.argsort(row.long() * shape[1] + col.long())
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=row.device)
    crow[1:] = torch.cumsum(torch.bincount(row.long(), minlength=shape[0]), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        return torch.sparse_csr_tensor(crow, col.long()[order],
                                       val.float()[order], size=shape)


def block_cases(a, h, dout=None) -> list:
    """Time the ELL forward (``a @ h``) and, given ``dout``, the block
    backward (``aᵀ @ dout``, ``index_add_``) of a minibatch step's block
    beside the plain version, the bound (each real slot's index and value,
    each distinct row read, each output row) and ``torch.sparse.mm``."""
    import torch
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.ref import ell_transpose_reduce
    kernel, plain = kernel_fns("ell_spmm")
    real = a.idx < a.ncols
    row = torch.arange(a.nrows, device=a.idx.device)[:, None].expand(
        a.idx.shape)[real]
    col, val = a.idx[real], a.val[real]
    n = int(col.numel())
    n_src = int(torch.unique(col).numel())
    fwd_lib = sparse_csr(row, col, val, (a.nrows, a.ncols))
    ways = [("fwd", h.shape[1], (lambda: kernel(a, h), lambda: plain(a, h)),
             lambda: torch.sparse.mm(fwd_lib, h), n_src, a.nrows)]
    if dout is not None:
        bwd_lib = sparse_csr(col, row, val, (a.ncols, a.nrows))
        ways.append(("bwd", dout.shape[1],
                     (lambda: ell_transpose_reduce(a, dout), None),
                     lambda: torch.sparse.mm(bwd_lib, dout), a.nrows, n_src))
    cases = []
    for way, k, fns, lib, rows_in, rows_out in ways:
        nbytes = n * 8 + rows_in * k * 4 + rows_out * k * 4
        t_bytes, t_ops = H100.mem_time(nbytes), H100.vpu_time(2.0 * n * k)
        # the forward's kernel alone; everything the backward launches
        dev_us = sum(us for key, us in device_us(fns[0], 20).items()
                     if way == "bwd" or "ell_spmm_kernel" in key)
        cases.append(dict(
            way=way, k=k, rows=a.nrows, width=a.max_deg, nnz=n,
            ms=cuda_ms(fns[0]),
            device_ms=dev_us / 20 / 1e3 if dev_us else None,
            plain_ms=cuda_ms(fns[1], reps=5, warmup=1) if fns[1] else None,
            library_ms=cuda_ms(lib), bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations"))
    return cases


def trusted_step(arch, ds, params, device) -> tuple:
    """Seed batch 0 of epoch 0 (``MB_BATCH`` seeds), host-sampled, each
    block packed with the plan ``BlockPlanCache(tune=False)`` gives (the
    trusted one), and one patched minibatch step over it on ``device``:
    ((params, opt state, loss, grads), launch counts, the plan kinds)."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.core.patch import patched
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.optimizer import adamw
    from repro_torch.sampling import (BlockPlanCache, NeighborSampler,
                                      pack_block, plan_buckets, seed_batches)
    from repro_torch.train import gnn_minibatch as mb
    seed_ids, n_real = next(iter(seed_batches(
        np.nonzero(ds.train_mask.numpy())[0], MB_BATCH, seed=0, epoch=0)))
    blocks = NeighborSampler(sp.csr_from_coo(ds.coo), FANOUTS,
                             seed=0).sample(seed_ids[:n_real], round=0)
    _, _, apply_blocks, dims = mb.make_block_model(
        arch, ds.num_features, HIDDEN, ds.num_classes, len(FANOUTS))
    cache = BlockPlanCache(semiring=arch.split("-")[1], tune=False)
    pbs, kinds = [], []
    for blk, bk, k in zip(blocks, plan_buckets(
            blocks, batch_size=MB_BATCH, fanouts=FANOUTS), dims):
        plan = cache.plan_for(blk, n_dst=bk.n_dst, n_src=bk.n_src,
                              nnz=bk.nnz, k_hint=k)
        kinds.append(plan.kind)
        pbs.append(sp.to_device(pack_block(
            blk, n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz, plan=plan,
            ell_width=bk.ell_width, sell_steps=bk.sell_steps), device))
    opt = adamw(TRAIN_LR, weight_decay=TRAIN_WD)
    step = mb.make_minibatch_step(apply_blocks, opt, batch_size=MB_BATCH)
    params = {l: {k: v.to(device) for k, v in p.items()}
              for l, p in params.items()}
    kops.reset_kernel_launches()
    with patched(True):
        p, st, loss, grads, _ = step(
            params, opt.init(params), pbs,
            torch.from_numpy(seed_ids).to(device), n_real, ds.x.to(device),
            ds.y.to(device), mb.init_step_stats(device))
    if device != "cpu":
        torch.cuda.synchronize()
    return (p, st._asdict(), loss, grads), kops.kernel_launches(), kinds


def trusted_bucket_check(ds) -> dict:
    """Phase 8 (c3): step 0's buckets with the trusted plan, GraphSAGE-mean
    and -max at full width: the step run twice from the same weights
    gives the same loss, gradients, parameters and optimizer state bit
    for bit, launches the ordered ``segment_sum`` (and no ELL / SELL),
    and agrees with the same step on the CPU (loss within ``LOSS_RTOL``,
    every gradient within ``GRAD_TOL`` of its largest element)."""
    import torch
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import gnn_minibatch as mb
    out = {}
    for arch in ("sage-mean", "sage-max"):
        init, _, _, _ = mb.make_block_model(
            arch, ds.num_features, HIDDEN, ds.num_classes, len(FANOUTS))
        params = init(torch.Generator().manual_seed(0), device="cpu")
        (a, launched, kinds), (b, again, _) = (
            trusted_step(arch, ds, params, DEVICE) for _ in range(2))
        same: list = []
        for x, y in zip(a, b):      # params, opt state, loss, grads
            tree_map(lambda p, q: same.append(torch.equal(p, q)), x, y)
        if set(kinds) != {"trusted"} or launched != again or \
                not launched["segment_sum"] or launched["ell_spmm"] or \
                launched["sell_spmm"] or not same or not all(same):
            raise AssertionError(
                f"minibatch {arch}, trusted plans {kinds}: launches "
                f"{launched} / {again}, {same.count(False)} of {len(same)} "
                f"tensors differ between two runs of the first step")
        (cp, _, closs, cgrads), _, _ = trusted_step(arch, ds, params, "cpu")
        loss_err = abs(float(a[2]) - float(closs)) / abs(float(closs))
        worst: list = []
        tree_map(lambda g, c: worst.append(float(
            (g.cpu() - c).abs().max() / max(float(c.abs().max()), 1e-30))),
            a[3], cgrads)
        if not loss_err <= LOSS_RTOL or not max(worst) <= GRAD_TOL:
            raise AssertionError(f"minibatch {arch} trusted step: card "
                                 f"against CPU, loss rel err {loss_err}, "
                                 f"gradients {max(worst)}")
        out[arch] = dict(plans=kinds, segment_sum_launches=launched[
            "segment_sum"], tensors=len(same), loss=float(a[2]),
            loss_rel_err_vs_cpu=loss_err, grad_err_over_max=max(worst))
        log(f"minibatch {arch}: step 0's buckets with trusted plans {kinds}: "
            f"the step run twice from the same weights equal bit for bit "
            f"({len(same)} tensors, {launched['segment_sum']} segment_sum "
            f"launches a step); against the CPU loss rel err "
            f"{loss_err:.2e}, gradients {max(worst):.2e} of their max")
    return out


@contextlib.contextmanager
def trainer_hooks():
    """Hooks into ``train_gnn_minibatch``'s own device-sampled steps that
    launch nothing themselves: the first step runs under
    :func:`record_sampling` (its sampler, step function, arguments and
    recorded primitives are kept for the checks, and the host clock when
    it began as ``t_first``), the next ``MB_SYNC_STEPS`` steps under
    ``set_sync_debug_mode("error")``, and each step's launches are read
    from the counters around it."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.train import gnn_minibatch as mb
    hooks: dict = dict(first=None, per_step=[])
    make = mb.make_device_minibatch_step

    def make_hooked(apply_blocks, opt, dev_sampler, **kw):
        step = make(apply_blocks, opt, dev_sampler, **kw)

        def hooked(*args, **kw):
            i = len(hooks["per_step"])
            before = kops.kernel_launches()
            if i == 0:
                hooks["t_first"] = time.perf_counter()
                with record_sampling() as calls:
                    res = step(*args, **kw)
                hooks["first"] = dict(sampler=dev_sampler, step=step,
                                      args=args, calls=calls)
            elif i <= MB_SYNC_STEPS:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    res = step(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                res = step(*args, **kw)
            after = kops.kernel_launches()
            hooks["per_step"].append({k: after[k] - before[k] for k in after})
            return res
        return hooked

    mb.make_device_minibatch_step = make_hooked
    try:
        yield hooks
    finally:
        mb.make_device_minibatch_step = make


@contextlib.contextmanager
def record_inference_sell():
    """Keep, by reference, every SELL launch of layer-wise inference: the
    packed operand, the kernel's output, and the full-layer matrix and
    source ids its dense operand was gathered from (keeping every gathered
    operand would hold tens of GB; the check gathers each again). Launches
    nothing of its own."""
    from repro_torch.kernels import ops as kops
    from repro_torch.train import gnn_minibatch as mb
    calls: list = []
    block: dict = {}
    glob, sell = mb.block_spmm_global, kops.sell_spmm

    def block_spmm_global(pb, h_full, *a, **kw):
        block.update(src_ids=pb.src_ids, h_full=h_full)
        try:
            return glob(pb, h_full, *a, **kw)
        finally:
            block.clear()

    def sell_spmm(a, h):
        out = sell(a, h)
        if block:
            calls.append(dict(a=a, out=out, **block))
        return out

    mb.block_spmm_global, kops.sell_spmm = block_spmm_global, sell_spmm
    try:
        yield calls
    finally:
        mb.block_spmm_global, kops.sell_spmm = glob, sell


def check_inference_sell(calls) -> dict:
    """Hold the output of every recorded SELL launch of layer-wise
    inference, as the main path produced it, against the plain version on
    the same operands (``check_kernel``'s per-row bound)."""
    from repro_torch.sampling import gather_rows
    st: dict = dict(operands=0, max_abs_err=0.0, max_err_over_bound=0.0,
                    k=[], max_width=0)
    for i, c in enumerate(calls):
        h = gather_rows(c["h_full"], c["src_ids"])
        err, width, ratio = check_kernel("sell_spmm", c["a"], h,
                                         f"inference launch {i}",
                                         out=c["out"])
        st["operands"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["max_err_over_bound"] = max(st["max_err_over_bound"], ratio)
        st["max_width"] = max(st["max_width"], width)
        if h.shape[1] not in st["k"]:
            st["k"].append(h.shape[1])
    return st


def minibatch_phase(ds, ckpt_dir: Path) -> dict:
    """Phase 8: device-sampled minibatch training at full width. The main
    path runs first, with hooks that record its own first step and its
    inference's SELL launches; every check then holds what it recorded.
    The main path checkpoints under ``ckpt_dir`` every FT_CKPT_EVERY steps
    and at the end: it is also phase 13 (a)'s clean run, handed over in
    ``out["clean_run"]`` (its result, wall seconds and ``train.ckpt``
    spans). Raises on the first failed check."""
    import copy

    import torch
    from repro_torch import obs
    from repro_torch.core import sparse as sp
    from repro_torch.kernels import ops as kops
    from repro_torch.sampling import (BlockPlanCache, NeighborSampler,
                                      device_graph_from_csr, pack_block,
                                      plan_buckets, seed_batches)
    from repro_torch.train import gnn_minibatch as mb
    out: dict = dict(arch=ARCH, hidden=HIDDEN, fanouts=FANOUTS,
                     batch_size=MB_BATCH, epochs=MB_EPOCHS, lr=TRAIN_LR,
                     weight_decay=TRAIN_WD, sampler="device")
    init, _, _, dims = mb.make_block_model(
        ARCH, ds.num_features, HIDDEN, ds.num_classes, len(FANOUTS))
    params = init(torch.Generator().manual_seed(0), device=DEVICE)

    # (a) the main path: train_gnn_minibatch, counts zeroed and read
    # around it
    with trainer_hooks() as hooks, record_inference_sell() as sell_calls, \
            obs.profiled(ops=False) as tracer:
        kops.reset_kernel_launches()
        t0 = time.perf_counter()
        res = mb.train_gnn_minibatch(
            ARCH, ds, fanouts=FANOUTS, batch_size=MB_BATCH, hidden=HIDDEN,
            epochs=MB_EPOCHS, lr=TRAIN_LR, weight_decay=TRAIN_WD,
            sampler="device", params=params, infer_batch=MB_INFER_BATCH,
            device=DEVICE, ckpt_dir=str(ckpt_dir), ckpt_every=FT_CKPT_EVERY)
        launches = kops.kernel_launches()
        wall = time.perf_counter() - t0
    out["clean_run"] = dict(result=res, seconds=wall,
                            save_ms=span_ms(tracer, "train.ckpt"))
    for name in (HOP_KERNEL, "segment_sum", "ell_spmm", "sell_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"minibatch: {name} was not launched on the "
                                 f"main path ({launches})")
    if any(launches[name] for name in SAMPLE_KERNELS):
        raise AssertionError(f"minibatch: a standalone sampling kernel ran "
                             f"on the main path, where each hop is one "
                             f"{HOP_KERNEL} launch ({launches})")
    if len(res.losses) != MB_EPOCHS or not np.isfinite(res.losses).all() or \
            not 0.0 <= res.test_acc <= 1.0:
        raise AssertionError(f"minibatch: losses {res.losses}, test "
                             f"accuracy {res.test_acc}")
    per_step = hooks["per_step"]
    n_steps = res.steps_per_epoch * MB_EPOCHS
    n_hops = len(FANOUTS)
    if len(per_step) != n_steps or any(
            s[HOP_KERNEL] != n_hops or any(s[name] for name in SAMPLE_KERNELS)
            for s in per_step):
        raise AssertionError(f"minibatch: {len(per_step)} hooked steps of "
                             f"{n_steps}, or a step did not launch "
                             f"{HOP_KERNEL} once a hop ({n_hops}) and no "
                             f"standalone sampling kernel")
    per_step_mean = {k: sum(s[k] for s in per_step) / n_steps
                     for k in per_step[0]}
    out.update(launches=launches, launches_per_step=per_step_mean,
               steps=n_steps, wall_s=wall,
               sync_free_steps=min(MB_SYNC_STEPS, n_steps - 1),
               result={k: v for k, v in dataclasses.asdict(res).items()
                       if k != "final_params"})
    log(f"minibatch: train_gnn_minibatch {MB_EPOCHS} epochs of "
        f"{res.steps_per_epoch} steps: epoch 2 {res.epoch_time_s * 1e3:.1f} "
        f"ms ({res.epoch_time_s / res.steps_per_epoch * 1e3:.2f} ms a step), "
        f"epoch 1 {res.first_epoch_s * 1e3:.1f} ms; losses "
        f"{[round(v, 5) for v in res.losses]}; test accuracy "
        f"{res.test_acc:.4f} (train {res.train_acc:.4f}); layer-wise "
        f"inference {res.infer_time_s:.1f} s; sample stage of an epoch "
        f"{res.sample_time_s * 1e3:.1f} ms")
    log(f"minibatch: capacities probed {list(res.probed_caps)}, final "
        f"{list(res.src_caps)}; overflow edges {res.overflow_edges}, "
        f"escalations {res.capacity_escalations}, skipped steps "
        f"{res.skipped_steps}; plans {res.plan_kinds}; launches {launches} "
        f"({per_step_mean} a step over its {n_steps} steps); {wall:.1f} s in "
        "all")
    log(f"minibatch: steps 2-{out['sync_free_steps'] + 1} of the run passed "
        "under set_sync_debug_mode('error'): no host sync inside a step")

    first = hooks["first"]
    dev = first["sampler"]
    p0, s0, seeds0, n_real0, rnd0, x, y, _ = first["args"]
    out["signature"] = [list(e) for e in dev.signature]

    # (b) the trainer's first batch sampled on the card equals the same
    # sampler's plain run on the CPU
    t0 = time.perf_counter()
    cpu = copy.copy(dev)
    cpu.graph = device_graph_from_csr(sp.csr_from_coo(ds.coo), device="cpu")
    masked = torch.where(torch.arange(MB_BATCH, device=DEVICE) < n_real0,
                         seeds0, ds.num_nodes)
    with torch.no_grad():
        got_b, got_ovf = dev.sample_blocks_stats(masked, rnd0)
        want_b, want_ovf = cpu.sample_blocks_stats(masked.cpu(), rnd0)
    fields = ("src_ids", "dst_pos", "row", "col", "val", "degrees")
    for layer, (g, w) in enumerate(zip(got_b, want_b)):
        pairs = [(f, getattr(g, f), getattr(w, f)) for f in fields]
        pairs.append(("n_dst_real", g.n_dst_real, w.n_dst_real))
        if w.ell is not None:
            pairs += [("ell.idx", g.ell.idx, w.ell.idx),
                      ("ell.val", g.ell.val, w.ell.val)]
        for f, a, b in pairs:
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                raise AssertionError(f"minibatch: layer {layer} {f} sampled "
                                     "on the card differs from the CPU")
    if int(got_ovf) != int(want_ovf):
        raise AssertionError(f"minibatch: overflow {int(got_ovf)} on the "
                             f"card, {int(want_ovf)} on the CPU")
    out["cross_device"] = dict(
        blocks=len(got_b), overflow=int(got_ovf),
        n_src=[b.n_src for b in got_b],
        edges=[int((b.col < b.n_src).sum()) for b in got_b],
        seconds=time.perf_counter() - t0)
    log(f"minibatch: the trainer's batch 0 sampled on the card equals the "
        f"CPU run bit for bit (every field of {len(got_b)} blocks, overflow "
        f"{int(got_ovf)}; real edges {out['cross_device']['edges']}; "
        f"buckets {dev.signature})")
    del cpu, got_b, want_b

    # (c) the trainer's first step, recorded: each fused hop against its
    # plain version (and the recorded output) on that step's own inputs,
    # and each standalone primitive on that hop's plain intermediates
    by_name: dict = {}
    for c in first["calls"]:
        by_name.setdefault(c["name"], []).append(c)
    # hops run innermost first: hop 1 (the outer, larger frontier) second
    hops = by_name.get(HOP_KERNEL, [])
    if len(hops) != n_hops or any(by_name.get(n) for n in SAMPLE_KERNELS):
        raise AssertionError(f"minibatch: {len(hops)} {HOP_KERNEL} calls in "
                             f"a step, expected {n_hops}, and no standalone "
                             f"primitive ({sorted(by_name)})")
    cases = []
    for hop, c in enumerate(hops):
        cases.append(sample_case(c, hop))
        cases += [sample_case(p, hop) for p in hop_primitive_calls(c)]
    ell_checks = []
    for c in by_name.get("ell_spmm", []):
        a, h = c["args"]
        err, width, ratio = check_kernel("ell_spmm", a, h,
                                         f"minibatch k{h.shape[1]}")
        ell_checks.append(dict(k=h.shape[1], rows=a.nrows, width=width,
                               max_abs_err=err, max_err_over_bound=ratio))
    back_checks = [check_block_backward(c)
                   for c in by_name.get("ell_transpose_reduce", [])]
    if len(ell_checks) != n_hops or len(back_checks) != 1:
        raise AssertionError(f"minibatch: {len(ell_checks)} ELL forwards, "
                             f"{len(back_checks)} block backwards in a step")
    # the layer with a backward (the seeds' block, layer 1) and layer 0
    back = by_name["ell_transpose_reduce"][0]["args"]
    layer0 = by_name["ell_spmm"][0]["args"]
    timed = block_cases(back[0], by_name["ell_spmm"][1]["args"][1],
                        back[1]) + block_cases(layer0[0], layer0[1])
    del by_name
    hooks["first"]["calls"] = None
    out.update(kernel_cases=cases, ell_checks=ell_checks,
               backward_checks=back_checks, block_cases=timed)
    for c in timed:
        # the backward is plain PyTorch itself: it has no other version
        plain = "-" if c["plain_ms"] is None else f"{c['plain_ms']:.4f}"
        log(f"  block {c['way']} k {c['k']} ({c['rows']} x {c['width']}, "
            f"{c['nnz']} real slots): ms {c['ms']:.4f} device "
            f"{fmt_ms(c['device_ms'])} plain {plain} bound "
            f"{c['bound_ms']:.5f} ({c['bound_by']}) sparse.mm "
            f"{c['library_ms']:.4f}")
    for c in cases:
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        unfused = "" if c["unfused_hop_ms"] is None else \
            f" unfused hop {c['unfused_hop_ms']:.4f}"
        log(f"  {c['name']:14s} hop {c['hop']} ({c['f']} x {c['width']}, "
            f"{c['dtype']}): bitwise equal; ms {c['ms']:.4f} device "
            f"{fmt_ms(c['device_ms'])} plain "
            f"{c['plain_ms']:.4f} bound {c['bound_ms']:.5f} "
            f"({c['bound_by']}) library {lib}{unfused}; host "
            f"{c['host_us']:.1f} us a call")

    # (c2) the trainer's first step twice more from the same weights,
    # state, seeds and round: loss, gradients and updated parameters bit
    # for bit (the block backward is the ordered segment sum)
    from repro_torch.core.patch import patched
    from repro_torch.optim.optimizer import tree_map
    with patched(True):
        reps = [first["step"](p0, s0, seeds0, n_real0, rnd0, x, y,
                              mb.init_step_stats(DEVICE)) for _ in range(2)]
    torch.cuda.synchronize()
    same: list = []
    for i in range(4):          # params, opt state, loss, grads
        tree_map(lambda a, b: same.append(torch.equal(a, b)),
                 reps[0][i] if i != 1 else reps[0][i]._asdict(),
                 reps[1][i] if i != 1 else reps[1][i]._asdict())
    if not same or not all(same):
        raise AssertionError(f"minibatch: the first step run twice from the "
                             f"same weights differs ({same.count(False)} of "
                             f"{len(same)} tensors)")
    out["repeat_bitwise"] = dict(tensors=len(same),
                                 loss=float(reps[0][2]))
    log(f"minibatch: the trainer's first step run twice from the same "
        f"weights, state, seeds and round: loss, gradients, parameters and "
        f"optimizer state equal bit for bit ({len(same)} tensors; loss "
        f"{float(reps[0][2]):.7f})")
    del reps
    # (c3) step 0's buckets with the trusted plan, sage-mean and sage-max
    out["trusted_buckets"] = trusted_bucket_check(ds)
    log("minibatch: ELL forward (k, rows, width) "
        f"{[(e['k'], e['rows'], e['width']) for e in ell_checks]} within the "
        "per-row bound (worst "
        f"{max(e['max_err_over_bound'] for e in ell_checks):.3f}); block "
        f"backward (k, rows) {[(b['k'], b['rows']) for b in back_checks]} "
        f"within it (worst "
        f"{max(b['max_err_over_bound'] for b in back_checks):.3f})")

    # (d) every SELL launch of the run's layer-wise inference, as launched
    if len(sell_calls) != launches["sell_spmm"]:
        raise AssertionError(f"minibatch: {len(sell_calls)} SELL launches "
                             f"recorded in inference, {launches['sell_spmm']} "
                             "counted")
    t0 = time.perf_counter()
    out["inference_sell_checks"] = sell = check_inference_sell(sell_calls)
    del sell_calls
    torch.cuda.empty_cache()
    log(f"minibatch: all {sell['operands']} SELL launches of layer-wise "
        f"inference (k {sell['k']}, up to {sell['max_width']} real slots a "
        f"row) within the per-row bound of the plain version (worst "
        f"{sell['max_err_over_bound']:.3f}, max err "
        f"{sell['max_abs_err']:.3g}), checked in "
        f"{time.perf_counter() - t0:.1f} s")

    # (e) the yardstick: host sample + pack against the trainer's device
    # sampler, on epoch 0's first 8 seed batches
    train_ids = np.nonzero(ds.train_mask.numpy())[0]
    batches = list(seed_batches(train_ids, MB_BATCH, seed=0, epoch=0))[:8]
    seeds = torch.from_numpy(np.stack([b[0] for b in batches])
                             .astype(np.int32)).to(DEVICE)
    ar = torch.arange(MB_BATCH, device=DEVICE)
    with torch.no_grad():
        dev.sample_blocks(torch.where(ar < batches[0][1], seeds[0],
                                      ds.num_nodes), 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bi, (_, nr) in enumerate(batches):
            dev.sample_blocks(torch.where(ar < nr, seeds[bi], ds.num_nodes),
                              bi)
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    host = NeighborSampler(sp.csr_from_coo(ds.coo), FANOUTS, seed=0)
    cache = BlockPlanCache(semiring="mean", tune=True)
    t0 = time.perf_counter()
    for bi, (sids, nr) in enumerate(batches):
        blocks = host.sample(sids[:nr], round=bi)
        for blk, bk, k in zip(blocks, plan_buckets(
                blocks, batch_size=MB_BATCH, fanouts=FANOUTS), dims):
            plan = cache.plan_for(blk, n_dst=bk.n_dst, n_src=bk.n_src,
                                  nnz=bk.nnz, k_hint=k)
            pack_block(blk, n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                       plan=plan, ell_width=bk.ell_width,
                       sell_steps=bk.sell_steps)
    host_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    out["yardstick"] = dict(batches=len(batches), device_sample_ms=dev_ms,
                            host_sample_pack_ms=host_ms)
    log(f"minibatch: sampling a batch of {MB_BATCH} seeds, "
        f"{len(batches)} batches: {dev_ms:.3f} ms on the card "
        f"(sample_blocks), {host_ms:.1f} ms on the host "
        f"(NeighborSampler.sample + pack_block)")

    # (f) one traced step of the trainer's own step function
    st = mb.init_step_stats(DEVICE)
    with patched(True):
        prof = step_profile(lambda: first["step"](
            p0, s0, seeds[1], batches[1][1], 1, x, y, st))
    out["step_profile"] = prof
    log(f"minibatch: one traced step, device busy {prof['busy_share']:.3f} "
        f"({prof['device_s'] * 1e3:.2f} ms of device time in "
        f"{prof['wall_s'] * 1e3:.2f} ms; top {prof['top'][:4]})")
    del hooks, first, dev, p0, s0, x, y, seeds
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: fault tolerance on the card
# ---------------------------------------------------------------------------

FT_CKPT_EVERY = 50      # the trainer's default cadence
FT_KILL_AFTER = 36      # the kill: step steps_per_epoch + 36 (epoch 1)
FT_NAN_STEP = 60        # nan_grad_at's step (epoch 0)
FT_HOST_STEPS = 7       # host-sampled steps a run of (c), from the
FT_HOST_BEFORE = 2      # checkpoint this many steps before epoch 1
FT_PREFETCH_ITEM = 4    # (c): the prefetch worker dies before item 4
FT_STRAGGLER = 4        # (c): the straggler, epoch 1's batch 4
FT_DELAY_S = 0.5


def ckpt_dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def final_state_leaves(base, step: int, params) -> list:
    """Every leaf of the checkpoint at ``step`` under ``base`` (params,
    the Adam step count and moments), restored on the card."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizer import tree_leaves
    like = {"params": params, "opt_state": adamw(TRAIN_LR).init(params)}
    got = restore_checkpoint(str(base), like, step=step)[0]
    s = got["opt_state"]
    return tree_leaves(got["params"]) + [s.step] + tree_leaves(s.mu) + \
        tree_leaves(s.nu)


def span_ms(tracer, name: str) -> list:
    return [s.dur_ns / 1e6 for s in tracer.snapshot() if s.name == name]


def fault_phase(ds, base: Path, clean_run: dict) -> dict:
    """Phase 13 at phase 8's cell: (a) phase 8's run, which checkpointed
    under ``base / "clean"`` (``clean_run``: its result, seconds and save
    spans), the same run killed in epoch 1 off the cadence, and the
    run resumed: losses, every final param and Adam moment bit for bit,
    the resumed run's launches counted and one of each held against its
    plain version; (b) a NaN gradient injected and skipped; (c) the host
    sampler over a window of steps resumed from (b)'s checkpoint, clean
    and with a dead prefetch worker and a straggler under the watchdog,
    bitwise equal. Checkpoints go under ``base`` (the caller removes it).
    Raises on the first failed check."""
    import torch
    from repro_torch import obs
    from repro_torch.ckpt import checkpoint_extra, committed_steps
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.testing import FaultPlan, expect_kill
    from repro_torch.train import gnn_minibatch as mb
    from repro_torch.train.fault_tolerance import StragglerWatchdog

    t_phase = time.perf_counter()
    kw = dict(fanouts=FANOUTS, batch_size=MB_BATCH, hidden=HIDDEN,
              epochs=MB_EPOCHS, lr=TRAIN_LR, weight_decay=TRAIN_WD,
              infer_batch=MB_INFER_BATCH, device=DEVICE)
    dev_kw = dict(kw, sampler="device", ckpt_every=FT_CKPT_EVERY)
    out: dict = dict(ckpt_every=FT_CKPT_EVERY)

    # -- (a) clean (phase 8's run), killed, resumed ---------------------------
    clean, clean_s = clean_run["result"], clean_run["seconds"]
    spe = clean.steps_per_epoch
    total = spe * MB_EPOCHS
    kill = spe + FT_KILL_AFTER
    resume_at = kill // FT_CKPT_EVERY * FT_CKPT_EVERY
    if kill % FT_CKPT_EVERY == 0 or clean.ckpt_saves != \
            total // FT_CKPT_EVERY + 1:
        raise AssertionError(f"fault phase: kill {kill} on the cadence, or "
                             f"{clean.ckpt_saves} saves in the clean run")
    save_ms = clean_run["save_ms"]
    final_dir = base / "clean" / f"step_{total:09d}"
    ckpt_bytes = ckpt_dir_bytes(final_dir)
    log(f"fault (a): clean run (phase 8's) {MB_EPOCHS} epochs of {spe} "
        f"steps with a checkpoint every {FT_CKPT_EVERY} steps and at the end: "
        f"{clean.ckpt_saves} saves, {ckpt_bytes} bytes a checkpoint; the "
        f"train.ckpt span ms (the counters' read and the host copy; the "
        f"last, blocking, also the write) "
        f"{[round(v, 3) for v in save_ms]}; epoch 2 "
        f"{clean.epoch_time_s * 1e3:.1f} ms; {clean_s:.1f} s")
    exc = expect_kill(mb.train_gnn_minibatch, ARCH, ds,
                      ckpt_dir=str(base / "killed"),
                      faults=FaultPlan(step_exception_at=kill), **dev_kw)
    steps = committed_steps(str(base / "killed"))
    if not steps or steps[-1] != resume_at:
        raise AssertionError(f"fault (a): killed at {kill} ({exc}); "
                             f"checkpoints {steps}, expected the newest at "
                             f"{resume_at}")
    with trainer_hooks() as hooks, record_inference_sell() as sell_calls, \
            obs.profiled(ops=False) as tracer:
        kops.reset_kernel_launches()
        t_call = time.perf_counter()
        res = mb.train_gnn_minibatch(ARCH, ds, ckpt_dir=str(base / "killed"),
                                     **dev_kw)
        launches = kops.kernel_launches()
    setup_s = hooks["t_first"] - t_call
    restore_ms = span_ms(tracer, "train.restore")
    resume_save_ms = span_ms(tracer, "train.ckpt")
    if res.resumed_step != resume_at or res.losses != clean.losses:
        raise AssertionError(f"fault (a): resumed at {res.resumed_step} "
                             f"(expected {resume_at}), losses {res.losses} "
                             f"against the clean run's {clean.losses}")
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves(clean.final_params), tree_leaves(res.final_params))]
    got = final_state_leaves(base / "killed", total, res.final_params)
    want = final_state_leaves(base / "clean", total, clean.final_params)
    same_state = [a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(got, want)]
    if not same or not all(same) or len(got) != len(want) or \
            not all(same_state):
        raise AssertionError(f"fault (a): the resumed run's final params "
                             f"({same.count(False)} differ) or final "
                             f"checkpoint ({same_state.count(False)} of "
                             f"{len(same_state)} leaves differ) is not the "
                             "clean run's")
    per_step = hooks["per_step"]
    n_hops = len(FANOUTS)
    if len(per_step) != total - resume_at or any(
            s[HOP_KERNEL] != n_hops for s in per_step) or any(
            launches[n] == 0 for n in (HOP_KERNEL, "ell_spmm", "segment_sum",
                                       "sell_spmm")):
        raise AssertionError(f"fault (a): {len(per_step)} steps resumed of "
                             f"{total - resume_at}; launches {launches}")
    # one launch of each kernel against its plain version
    by_name: dict = {}
    for c in hooks["first"]["calls"]:
        by_name.setdefault(c["name"], []).append(c)
    check_sample_call(by_name[HOP_KERNEL][0])
    a, h = by_name["ell_spmm"][0]["args"]
    ell_err, _, ell_ratio = check_kernel("ell_spmm", a, h, "resumed step")
    back = check_block_backward(by_name["ell_transpose_reduce"][0])
    sell = check_inference_sell(sell_calls[:1])
    del by_name, hooks, sell_calls
    checks = dict(sample_hop="bitwise", ell_spmm=dict(
        max_abs_err=ell_err, max_err_over_bound=ell_ratio),
        segment_sum=back, sell_spmm=sell)
    out["kill_resume"] = dict(
        steps_per_epoch=spe, kill=kill, resumed_step=res.resumed_step,
        losses=res.losses, leaves_bitwise=len(got),
        params_bitwise=len(same), ckpt_bytes=ckpt_bytes,
        save_ms=save_ms, resume_save_ms=resume_save_ms,
        restore_ms=restore_ms, setup_s=setup_s, launches=launches,
        resumed_steps=len(per_step), checks=checks,
        clean_epoch_ms=clean.epoch_time_s * 1e3,
        resumed_first_epoch_ms=res.first_epoch_s * 1e3)
    log(f"fault (a): killed before step {kill} ({exc}); resumed from step "
        f"{res.resumed_step}, {len(per_step)} steps replayed: losses, "
        f"{len(same)} final params and {len(got)} leaves of the final "
        f"checkpoint (params, Adam step and moments) equal the clean run's "
        f"bit for bit; set-up {setup_s:.2f} s to the first step (restore "
        f"{[round(v, 3) for v in restore_ms]} ms); launches {launches}; "
        f"one launch each against its plain version: sample_hop bitwise, "
        f"ELL {ell_ratio:.3f} and the block backward (segment_sum) "
        f"{back['max_err_over_bound']:.3f} of the per-row bound, an "
        f"evaluation SELL launch {sell['max_err_over_bound']:.3f}")
    like = res.final_params          # shapes and devices of a restore
    del clean, res, got, want
    torch.cuda.empty_cache()

    # -- (b) a NaN gradient, skipped ------------------------------------------
    nan_every = spe - FT_HOST_BEFORE      # a checkpoint for (c) to start from
    nan = mb.train_gnn_minibatch(
        ARCH, ds, sampler="device", ckpt_dir=str(base / "nan"),
        ckpt_every=nan_every, faults=FaultPlan(nan_grad_at=(FT_NAN_STEP, 0)),
        **kw)
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(nan.final_params))
    extra = checkpoint_extra(str(base / "nan"), nan_every)
    if nan.skipped_steps != 1 or not np.isfinite(nan.losses).all() or \
            not finite or extra["skipped"] != 1:
        raise AssertionError(f"fault (b): skipped {nan.skipped_steps}, "
                             f"losses {nan.losses}, params finite {finite}, "
                             f"checkpointed skips {extra['skipped']}")
    out["nan"] = dict(step=FT_NAN_STEP, skipped=nan.skipped_steps,
                      losses=nan.losses, test_acc=nan.test_acc)
    log(f"fault (b): NaN injected into the gradients at step {FT_NAN_STEP}: "
        f"1 step skipped, losses {[round(v, 5) for v in nan.losses]}, every "
        f"param finite; the checkpoint at {nan_every} counts the skip")
    del nan

    # -- (c) the host sampler: a dead prefetch worker and a straggler ---------
    stop = spe + FT_HOST_STEPS - FT_HOST_BEFORE   # the kill ends each window
    host_kw = dict(kw, sampler="host", ckpt_every=5)
    runs = {}
    for name, plan, wd in (
            ("clean", FaultPlan(step_exception_at=stop), None),
            ("faulted", FaultPlan(step_exception_at=stop,
                                  prefetch_death_at=FT_PREFETCH_ITEM,
                                  straggler_at=spe + FT_STRAGGLER,
                                  straggler_delay_s=FT_DELAY_S),
             StragglerWatchdog())):
        d = base / f"host_{name}"
        shutil.copytree(base / "nan" / f"step_{nan_every:09d}",
                        d / f"step_{nan_every:09d}")
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            expect_kill(mb.train_gnn_minibatch, ARCH, ds, ckpt_dir=str(d),
                        faults=plan, watchdog=wd, **host_kw)
        restarts = sum("prefetch worker died" in str(w.message)
                       for w in caught)
        runs[name] = dict(dir=d, restarts=restarts, wd=wd,
                          seconds=time.perf_counter() - t0)
    last = stop // 5 * 5
    got, want = (final_state_leaves(runs[n]["dir"], last, like)
                 for n in ("faulted", "clean"))
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    wd = runs["faulted"]["wd"]
    flagged = [e.step for e in wd.events if e.straggler]
    losses_same = checkpoint_extra(str(runs["faulted"]["dir"]), last)[
        "losses"] == checkpoint_extra(str(runs["clean"]["dir"]), last)[
        "losses"]
    if not all(same) or not same or not losses_same or \
            runs["faulted"]["restarts"] != 1 or \
            runs["clean"]["restarts"] != 0 or \
            spe + FT_STRAGGLER not in flagged:
        raise AssertionError(f"fault (c): {same.count(False)} of "
                             f"{len(same)} leaves differ at step {last}, "
                             f"losses equal {losses_same}, restarts "
                             f"{runs['faulted']['restarts']}, flagged "
                             f"{flagged}")
    out["host"] = dict(
        start=nan_every, stop=stop, compared_step=last,
        leaves_bitwise=len(same), prefetch_restarts=1, flagged=flagged,
        watchdog=wd.summary(),
        seconds={n: r["seconds"] for n, r in runs.items()})
    log(f"fault (c): host sampler resumed at step {nan_every} from (b)'s "
        f"checkpoint and stopped before step {stop} by an injected kill, "
        f"clean and with the prefetch worker dead before item "
        f"{FT_PREFETCH_ITEM} (1 restart) and a {FT_DELAY_S} s straggler at "
        f"step {spe + FT_STRAGGLER}: the {len(same)} leaves of both "
        f"checkpoints at step {last} and their losses equal bit for bit; "
        f"the watchdog flagged {flagged} (EMA "
        f"{wd.summary()['ema_s'] * 1e3:.2f} ms over {wd.total_steps} "
        f"steps); {runs['clean']['seconds']:.1f} / "
        f"{runs['faulted']['seconds']:.1f} s")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 11: measured tuning on the card
# ---------------------------------------------------------------------------

TUNE_K = 256                                  # the training paths' width
CURVE_KS = (16, 32, 64, 128, 256, 512, 1024)  # the reference's tuning curve


@contextlib.contextmanager
def measured_launches():
    """Count the hand kernels launched inside the tuner's timed callables
    (``core.autotune._time_callable``: the untimed first call and the
    timed ones) by kernel name, into the yielded dict."""
    import importlib
    from repro_torch.kernels import ops as kops
    tat = importlib.import_module("repro_torch.core.autotune")
    counts: dict = {}
    real = tat._time_callable

    def counted(fn, *args, **kw):
        before = kops.kernel_launches()
        try:
            return real(fn, *args, **kw)
        finally:
            for name, n in kops.kernel_launches().items():
                if n - before[name]:
                    counts[name] = counts.get(name, 0) + n - before[name]
    tat._time_callable = counted
    try:
        yield counts
    finally:
        tat._time_callable = real


def traced(fn):
    """``fn()`` in a trace: (its result, the ``tuning.measure`` and
    ``tuning.plan`` instants it emitted, seconds)."""
    from repro_torch import obs
    t0 = time.perf_counter()
    with obs.profiled(ops=False) as tracer:
        out = fn()
    spans = tracer.snapshot()
    return (out, [s.attrs for s in spans if s.name == "tuning.measure"],
            [s.attrs for s in spans if s.name == "tuning.plan"],
            time.perf_counter() - t0)


def measure_record(tag, rec) -> dict:
    """One measured pass as logged: every candidate's measured ms beside
    its analytic estimate (H100 model), the measured and analytic picks."""
    est = dict(rec["estimated"])
    cands = [dict(name=n, ms=t * 1e3, est_ms=est[n] * 1e3)
             for n, t in rec["candidates"]]
    if not all(np.isfinite(c["ms"]) and c["ms"] > 0 for c in cands) or \
            rec["device"] != DEVICE:
        raise AssertionError(f"{tag}: measured pass malformed: {rec}")
    log(f"  {tag} K={rec['k']} ({rec['semiring']}): measured pick "
        f"{rec['winner']}, analytic pick {rec['analytic']}; " + ", ".join(
            f"{c['name']} {c['ms']:.4f} ms (est {c['est_ms']:.4f})"
            for c in cands))
    return dict(tag=tag, graph=rec["graph"], k=rec["k"],
                semiring=rec["semiring"], measured_pick=rec["winner"],
                analytic_pick=rec["analytic"], candidates=cands)


def plan_operand(g):
    """(kernel name, operand) a cached graph's plan runs A through, or
    (None, None) for trusted."""
    p = g.plan
    if p.wants_bsr:
        return "bsr_spmm", g.bsr
    if p.wants_sell:
        return "sell_spmm", g.sell
    if p.wants_ell:
        return "ell_spmm", g.ell
    return None, None


def tuning_phase(ds, gen) -> dict:
    """Phase 11 on reddit (a, b, d, e; (c) runs in phase 7): measured
    picks for sage-mean's A and gcn's Â at K = 256 into a fresh
    ``TuningDB``, a second build served by it with no launch,
    ``train_gnn(measure_tuning=True)`` on it and its kernel held to its
    plain version, the measured and analytic tuning curves, one epoch of
    device-sampled minibatch training measured per bucket and again from
    the filled DB, and ``patch_fn`` on the card."""
    import torch
    from repro_torch import obs
    from repro_torch.core import sparse as sp
    from repro_torch.core.autotune import (TuningDB, suggest_embedding_size,
                                           tuning_curve)
    from repro_torch.core.cache import build_cached_graph
    from repro_torch.core.patch import is_patched, patch_fn, patched
    from repro_torch.kernels import ops as kops
    from repro_torch.models.gnn import GraphBundle, make_gnn
    from repro_torch.train import gnn_minibatch as mb
    from repro_torch.train.gnn import train_gnn

    t_phase = time.perf_counter()
    out: dict = {}
    db_path = ROOT / "build" / "chip_smoke_measured.json"
    db_path.unlink(missing_ok=True)
    a_norm = sp.gcn_normalize(ds.coo, add_self_loops=True)

    # (a) measured picks on A (sage-mean) and Â (gcn), the DB, train_gnn
    picks, graphs = [], {}
    with measured_launches() as counts_a:
        for tag, a in (("reddit/A", ds.coo), ("reddit/Â", a_norm)):
            g, recs, plans, secs = traced(lambda: build_cached_graph(
                a, k_hint=TUNE_K, measure=True, db=TuningDB(str(db_path)),
                device=DEVICE))
            if len(recs) != 1 or plans[-1]["source"] != "measure":
                raise AssertionError(f"{tag}: {len(recs)} measured passes, "
                                     f"plan source {plans[-1]['source']}")
            picks.append(dict(measure_record(tag, recs[0]), build_s=secs))
            graphs[tag] = g
    # the filled DB serves A's measured plan: its row read back, and
    # train_gnn's own build of A takes it from the DB with no measured pass
    t0 = time.perf_counter()
    db = TuningDB(str(db_path))
    served = db.get_key(db.key(ds.coo, TUNE_K, "sum"), device=DEVICE)
    if served != graphs["reddit/A"].plan:
        raise AssertionError(f"the filled DB's row for reddit/A {served}, "
                             f"measured {graphs['reddit/A'].plan}")
    row_s = time.perf_counter() - t0
    with measured_launches() as counts_served:
        res, recs, plans, secs = traced(lambda: train_gnn(
            ARCH, ds, hidden=TUNE_K, epochs=3, measure_tuning=True,
            tuning_db=TuningDB(str(db_path)), device=DEVICE))
    hit_launches = sum(counts_served.values())
    if recs or hit_launches or not plans or any(
            (p["source"], p["kind"]) != ("db", served.kind) for p in plans) \
            or not np.isfinite(res.losses).all():
        raise AssertionError(f"train_gnn(measure_tuning=True): "
                             f"{len(recs)} passes, {hit_launches} launches "
                             f"to measure, plans {plans}, losses "
                             f"{res.losses}")
    log(f"  reddit/A again with the filled DB: its row is the measured plan "
        f"({served.kind}, read in {row_s:.1f} s); train_gnn's build served "
        f"from it, {len(recs)} measured passes, {hit_launches} launches to "
        f"measure")
    g = graphs["reddit/A"]
    name, a_op = plan_operand(g)
    trained = dict(plan=res.plan_kind, losses=res.losses,
                   epoch_ms=res.epoch_time_s * 1e3,
                   plan_source=plans[-1]["source"] if plans else None)
    if name is None:
        log("  train_gnn(measure_tuning=True): trusted won on A; no hand "
            "SpMM kernel to hold (the trusted path's ordered segment sum "
            "is held in phase 9)")
    else:
        h = random_h(g.ncols, TUNE_K, gen)
        err, width, ratio = check_kernel(
            name, sp.to_device(a_op, DEVICE), h, "reddit/A/measured")
        trained.update(kernel=name, max_abs_err=err, max_err_over_bound=ratio)
        del h
    log(f"  train_gnn({ARCH}, hidden {TUNE_K}, measure_tuning=True): plan "
        f"{res.plan_kind} from the {trained['plan_source']}, epoch "
        f"{trained['epoch_ms']:.2f} ms, losses "
        f"{[round(x, 4) for x in res.losses]}" + (
            f"; {name} on A at K={TUNE_K} against its plain version: max "
            f"|diff| {trained['max_abs_err']:.2e} (/bound "
            f"{trained['max_err_over_bound']:.3f})" if name else ""))
    out.update(picks=picks, db_hit_launches=hit_launches, train=trained)
    torch.cuda.empty_cache()

    # (e) patch_fn on the card: a decorated forward, bit for bit
    g_dev = graphs["reddit/A"].to(DEVICE)
    bundle = GraphBundle(tuned=g_dev, tuned_norm=None,
                         raw=sp.to_device(ds.coo, DEVICE),
                         raw_sl=sp.to_device(ds.coo_sl, DEVICE))
    init, apply = make_gnn(ARCH, ds.num_features, TUNE_K, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=DEVICE)
    x = ds.x.to(DEVICE)

    @patch_fn
    def forward():
        return apply(params, bundle, x), is_patched()
    with torch.no_grad():
        with patched(False):
            dec, inside = forward()
            after = is_patched()
        with patched(True):
            want = apply(params, bundle, x)
    if not (inside and not after and torch.equal(dec, want)):
        raise AssertionError(f"patch_fn: patched inside {inside}, after "
                             f"{after}, max |diff| "
                             f"{float((dec - want).abs().max())}")
    log(f"  patch_fn: the decorated forward equals patched(True) bit for "
        f"bit ({tuple(dec.shape)}), patch state restored")
    out["patch_fn"] = dict(bitwise=True, restored=True)
    del bundle, g_dev, params, x, dec, want, graphs, g, a_op
    torch.cuda.empty_cache()

    # (b) the tuning curve, measured on the card beside the analytic one
    t0 = time.perf_counter()
    with measured_launches() as counts_b:
        measured, recs, _, _ = traced(lambda: tuning_curve(
            ds.coo, CURVE_KS, measure=True, device=DEVICE))
    analytic = tuning_curve(ds.coo, CURVE_KS)
    curve = dict(ks=list(CURVE_KS), measured=measured, analytic=analytic,
                 suggested_measured=suggest_embedding_size(measured),
                 suggested_analytic=suggest_embedding_size(analytic),
                 passes=[measure_record(f"curve/K={r['k']}", r)
                         for r in recs],
                 seconds=time.perf_counter() - t0)
    log(f"  tuning curve on reddit/A ({curve['seconds']:.1f} s): "
        + "; ".join(f"K={m['k']} measured {m['kind']} {m['speedup']:.3f}x, "
                    f"analytic {a['kind']} {a['speedup']:.3f}x"
                    for m, a in zip(measured, analytic))
        + f"; suggested K: measured {curve['suggested_measured']}, "
          f"analytic {curve['suggested_analytic']}")
    out["curve"] = curve

    # (d) one epoch of device-sampled minibatch training, measured per
    # bucket, then again from the filled DB
    kw = dict(fanouts=FANOUTS, batch_size=MB_BATCH, hidden=HIDDEN, epochs=1,
              lr=TRAIN_LR, weight_decay=TRAIN_WD, sampler="device",
              infer_batch=MB_INFER_BATCH, measure_tuning=True,
              device=DEVICE)
    mb_db = ROOT / "build" / "chip_smoke_measured_mb.json"
    mb_db.unlink(missing_ok=True)
    with measured_launches() as counts_d:
        res, recs, plans, secs = traced(lambda: mb.train_gnn_minibatch(
            ARCH, ds, tuning_db=TuningDB(str(mb_db)), **kw))
    buckets = [dict(key=p["key"], source=p["source"], kind=p["kind"])
               for p in plans if p.get("site") == "block_plan_cache"]
    passes = [measure_record(f"minibatch/{r['graph']}", r) for r in recs]
    if not recs or len(recs) != sum(b["source"] == "measure"
                                    for b in buckets):
        raise AssertionError(f"minibatch: {len(recs)} measured passes for "
                             f"buckets {buckets}")
    log(f"  minibatch (device sampler, 1 epoch, {secs:.1f} s): "
        f"{len(buckets)} bucket plans, "
        f"{sum(b['source'] == 'measure' for b in buckets)} measured; "
        f"plans {res.plan_kinds}; loss {res.losses}")
    for b in buckets:
        log(f"    {b['key']}: {b['kind']} ({b['source']})")
    before = obs.metrics().counter("tuning.measured").value
    res2, recs2, plans2, secs2 = traced(lambda: mb.train_gnn_minibatch(
        ARCH, ds, tuning_db=TuningDB(str(mb_db)), **kw))
    measured_again = obs.metrics().counter("tuning.measured").value - before
    if recs2 or measured_again or any(
            p["source"] != "db" for p in plans2
            if p.get("site") == "block_plan_cache"):
        raise AssertionError(f"minibatch from the filled DB measured "
                             f"{measured_again} times")
    log(f"  minibatch again from the filled DB: nothing measured "
        f"({secs2:.1f} s), plans {res2.plan_kinds}")
    out["minibatch"] = dict(buckets=buckets, passes=passes,
                            plans=list(res.plan_kinds), seconds=secs,
                            seconds_from_db=secs2)
    launches: dict = {}
    for c in (counts_a, counts_b, counts_d):
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return out


def proteins_tuning(a_norm, stats, tuning: dict) -> dict:
    """Phase 11 (c), run in phase 7 before its pinned bundle exists: the
    measured pass on ogbn-proteins' Â at K = 256."""
    import torch
    from repro_torch.core.autotune import autotune
    t0 = time.perf_counter()
    with measured_launches() as counts:
        plan, recs, _, _ = traced(lambda: autotune(
            a_norm, TUNE_K, stats=stats, measure=True, device=DEVICE))
    rec = measure_record("proteins/Â", recs[0])
    rec.update(seconds=time.perf_counter() - t0, plan=plan.to_json())
    for k, v in counts.items():
        tuning["launches"][k] = tuning["launches"].get(k, 0) + v
    tuning["seconds"] += rec["seconds"]
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 10: LM serving (prefill + decode) of phi3.5-moe at full width
# ---------------------------------------------------------------------------

LM_ARCH = "phi3.5-moe-42b-a6.6b"
LM_LAYERS = 4           # of 32: 84 GB of bf16 weights exceed one 80 GB card
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_CAPACITY = LM_PROMPT + LM_DECODE + 8
LM_TOL = 2.0 ** -7      # max|kernel - plain| / max|plain|: two bf16 ulps,
                        # and per output row against the fp32 oracle
LM_SMOKE_ATOL = 1e-4    # fp32 smoke config, card (kernels) vs CPU (plain)
LM_SMOKE_DECODE = 4
LM_KERNELS = ("ragged_gemm", "flash_attention")


def check_lm_launch(entry, out, want, oracle, row_floor=None):
    """Hold one LM kernel launch's output (1) against the plain version's
    ``want``, max |diff| within ``LM_TOL`` x max|plain| over the whole
    output, and (2) row by row against ``oracle``, the same function of
    the same inputs widened to fp32: each output row's max |diff| within
    ``LM_TOL`` x that row's max |oracle| (plus a floor of 2^-24 x the
    output's max, for rows near zero), after ``row_floor`` (a per-row
    absolute rounding floor, where the function cancels) is taken off.
    Records the errors in ``entry``, with the plain version's own worst
    row against the oracle (the rounding the two share, for comparison);
    raises past either bound or on a value that is not finite."""
    import torch
    err = float((out.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ratio = err / max(scale, 1e-30)
    width = out.shape[-1]
    row_max = oracle.abs().reshape(-1, width).amax(-1)
    row_max = row_max.clamp(min=max(2.0 ** -24 * float(row_max.max()),
                                    1e-30))

    def worst_row(x):
        row_err = (x.float() - oracle).abs().reshape(-1, width).amax(-1)
        if row_floor is not None:
            row_err = (row_err - row_floor).clamp(min=0.0)
        return float((row_err / row_max).max())
    row_ratio = worst_row(out)
    entry.update(max_abs_err=err, max_plain=scale, err_over_max=ratio,
                 median_plain=float(want.float().abs().median()),
                 median_row_max=float(row_max.median()),
                 row_err_over_row_max=row_ratio,
                 plain_row_err_over_row_max=worst_row(want))
    if not ratio <= LM_TOL or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{entry['name']} {entry['shape']}: kernel "
                             f"disagrees with plain, max err {err} of "
                             f"max|plain| {scale} (ratio {ratio:.3e} > "
                             f"{LM_TOL})")
    if not row_ratio <= LM_TOL:
        raise AssertionError(f"{entry['name']} {entry['shape']}: a row "
                             f"of the kernel's output disagrees with "
                             f"the fp32 oracle: max|diff| / max|row| "
                             f"{row_ratio:.3e} > {LM_TOL}")


def ragged_oracle(x, w, tile_expert, tm=128, transpose_w=False):
    """The ragged GEMM in fp32, one expert's tiles at a time (with
    ``transpose_w`` x @ w[e]ᵀ, the backward's dX)."""
    import torch
    xt = x.view(-1, tm, x.shape[1])
    width = w.shape[1] if transpose_w else w.shape[2]
    out = torch.empty((xt.shape[0], tm, width),
                      dtype=torch.float32, device=x.device)
    te = tile_expert.cpu()
    for e in te.unique().tolist():
        idx = (te == e).nonzero()[:, 0].to(x.device)
        we = w[e].float()
        out[idx] = xt[idx].float() @ (we.T if transpose_w else we)
    return out.view(x.shape[0], width)


@contextlib.contextmanager
def record_lm_kernels(check: bool):
    """While on, every ``ragged_gemm`` / ``flash_attention`` dispatch is
    recorded with its inputs; with ``check`` its output is held right away
    by :func:`check_lm_launch` against the plain version on the same card
    tensors and, row by row, against the fp32 oracle. The row check sees
    a fault confined to rows of small magnitude, such as the late query
    rows of a long causal prefill, which average over thousands of keys.
    The dispatchers and their launch counts are unchanged; the plain
    versions and the oracles launch no kernel."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ragged_gemm import ragged_gemm_plain
    import torch
    calls: list = []
    real = {"ragged_gemm": kops.ragged_gemm,
            "flash_attention": kops.flash_attention}

    def ragged(x, w, tile_expert, *, tm=128, n_groups=None):
        out = real["ragged_gemm"](x, w, tile_expert, tm=tm,
                                  n_groups=n_groups)
        entry = dict(name="ragged_gemm",
                     shape=f"{x.shape[0]}x{x.shape[1]}x{w.shape[2]}",
                     inputs=(x, w, tile_expert))
        if check:
            check_lm_launch(entry, out,
                            ragged_gemm_plain(x, w, tile_expert, tm=tm),
                            ragged_oracle(x, w, tile_expert, tm))
        calls.append(entry)
        return out

    def flash(q, k, v, *, causal=True, window=None, meta_len=0):
        out = real["flash_attention"](q, k, v, causal=causal, window=window,
                                      meta_len=meta_len)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        entry = dict(name="flash_attention",
                     shape=f"{tuple(q.shape)}/{tuple(k.shape)}",
                     inputs=(q, k, v), causal=causal, window=window,
                     meta_len=meta_len)
        if check:
            kw = dict(causal=causal, window=window, meta_len=meta_len)
            check_lm_launch(entry, out, flash_attention_plain(q, k, v, **kw),
                            flash_attention_plain(q.float(), k.float(),
                                                  v.float(), **kw))
        calls.append(entry)
        return out

    kops.ragged_gemm, kops.flash_attention = ragged, flash
    try:
        yield calls
    finally:
        kops.ragged_gemm = real["ragged_gemm"]
        kops.flash_attention = real["flash_attention"]


def attention_pairs(s: int, t: int, causal: bool, window,
                    meta_len: int = 0) -> int:
    """Kept (query, key) pairs of one head: the work the masks leave (the
    window's band and, below it, the sink keys under ``meta_len``)."""
    qpos = np.arange(s, dtype=np.int64) + (t - s)
    hi = np.minimum(qpos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(s, np.int64)
    sinks = np.minimum(np.minimum(meta_len, lo), hi + 1) \
        if window is not None else 0
    return int((np.maximum(hi - lo + 1, 0) + np.maximum(sinks, 0)).sum())


def lm_kernel_case(call, device_ms) -> dict:
    """One recorded launch of the main path, timed: the kernel (CUDA
    events), its plain version, a library yardstick the port never calls
    (``torch.bmm`` over the (E, C, D) buffer for the ragged GEMM,
    ``scaled_dot_product_attention`` for flash), and the bound of the
    function on these inputs: the larger of one read of each input and
    one write of the output at 3.35 TB/s and its operations at 989
    TFLOP/s (bf16 tensor cores). ``device_ms`` comes from the caller's
    trace of the whole prefill or decode step: a trace of these lone
    launches after phases 2–9 records no device work on the H100 machine
    (the same calls in a fresh process do)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                                 ragged_gemm_plain)
    name = call["name"]
    if name == "ragged_gemm":
        x, w, te = call["inputs"]
        t, d = x.shape
        e, f = w.shape[0], w.shape[2]
        used = int(torch.unique(te).numel())
        flops = 2 * t * d * f
        nbytes = (t * d + used * d * f + t * f) * x.element_size()

        def kernel():
            return ragged_gemm_cuda(x, w, te)

        def plain():
            return ragged_gemm_plain(x, w, te)

        xb = x.view(e, t // e, d)         # experts in order, C rows each

        def library():
            return torch.bmm(xb, w)
    else:
        q, k, v = call["inputs"]
        b, hq, s, d = q.shape
        t = k.shape[2]
        kw = dict(causal=call["causal"], window=call["window"],
                  meta_len=call.get("meta_len", 0))
        flops = 4 * d * attention_pairs(s, t, **kw) * b * hq
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()

        def kernel():
            return flash_attention_cuda(q, k, v, **kw)

        def plain():
            return flash_attention_plain(q, k, v, **kw)

        library = None
        if kw["window"] is None and kw["causal"] and s == t:
            def library():
                try:
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
                except TypeError:         # a torch without enable_gqa
                    rep = hq // k.shape[1]
                    return F.scaled_dot_product_attention(
                        q, k.repeat_interleave(rep, 1),
                        v.repeat_interleave(rep, 1), is_causal=True)
    t_bytes, t_ops = H100.mem_time(nbytes), flops / H100.peak_flops
    reps = 10
    return dict(
        name=name, shape=call["shape"],
        ms=cuda_ms(kernel, reps=reps), device_ms=device_ms,
        host_us=host_us(kernel),
        library_host_us=None if library is None else host_us(library),
        plain_ms=cuda_ms(plain, reps=3, warmup=1),
        library_ms=None if library is None else cuda_ms(library, reps=reps),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops)


def host_us(fn, reps: int = 50) -> float:
    """Host µs a call of ``fn`` takes to enqueue its work (no sync in the
    loop; the device runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def lm_smoke_check(arch: str = LM_ARCH, prompt: dict | None = None) -> list:
    """``arch``'s smoke config in fp32 (the kernels' fp32 instances):
    prefill + LM_SMOKE_DECODE decode steps on the card against the port's
    CPU run (plain versions) from the same weights and ``prompt`` (a CPU
    batch; by default 2 x 64 tokens from ``data/tokens``). Returns the max
    |logit diff| of each call; raises past LM_SMOKE_ATOL."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p_card = tree_to(p_cpu, DEVICE)
    if prompt is None:
        prompt = {"tokens": torch.from_numpy(
            synthetic_lm_batch(2, 64, cfg.vocab, step=1)[0])}
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, LM_SMOKE_DECODE)).astype(np.int32))
    cap = batch_positions(prompt) // prompt["tokens"].shape[0] + \
        cfg.n_meta_tokens + LM_SMOKE_DECODE
    c_card, l_card = lm.prefill(cfg, p_card, tree_to(prompt, DEVICE), cap)
    c_cpu, l_cpu = lm.prefill(cfg, p_cpu, prompt, cap)
    errs = [float((l_card.cpu() - l_cpu).abs().max())]
    for i in range(LM_SMOKE_DECODE):
        l_card, c_card = lm.decode_step(cfg, p_card, c_card,
                                        nxt[:, i:i + 1].to(DEVICE))
        l_cpu, c_cpu = lm.decode_step(cfg, p_cpu, c_cpu, nxt[:, i:i + 1])
        errs.append(float((l_card.cpu() - l_cpu).abs().max()))
    if not max(errs) <= LM_SMOKE_ATOL:
        raise AssertionError(f"{arch} fp32 smoke logits, card vs CPU: "
                             f"{errs} (atol {LM_SMOKE_ATOL})")
    return errs


def lm_phase() -> dict:
    """Phase 10: phi3.5-moe at full width cut to LM_LAYERS layers, bf16,
    random weights from a seeded generator on the card; 4 prompts of
    2,048 tokens from ``data/tokens``, ``prefill`` into a 2,088-slot
    cache, then 32 greedy ``decode_step``s. Launch counts are zeroed just
    before and read just after the prefill, the first decode step and the
    other 31; every kernel launch of the prefill and of the first decode
    step is held against its plain version on its own inputs. Then the
    serving times, the kernels at the main path's shapes, and the smoke
    config in fp32 on the card against the port's CPU run."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    from repro_torch.models import lm

    full = get_config(LM_ARCH)
    cfg = dc.replace(full, n_layers=LM_LAYERS)
    cut = (f"{LM_ARCH} at full width, {LM_LAYERS} of {full.n_layers} "
           f"layers: {full.param_count() / 1e9:.2f} B parameters take "
           f"{full.param_count() * 2 / 1e9:.1f} GB in bf16, more than the "
           f"card's 80 GB; {LM_LAYERS} layers take "
           f"{cfg.param_count() * 2 / 1e9:.2f} GB")
    log(f"cut: {cut}")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
    torch.cuda.synchronize()
    log(f"lm: {cfg.param_count() / 1e9:.3f} B parameters drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    toks, _ = synthetic_lm_batch(LM_BATCH, LM_PROMPT, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(DEVICE)}

    def launches():
        return {n: kops.kernel_launches()[n] for n in LM_KERNELS}

    def ragged_instances():
        return dict(ragged_gemm_cuda.launches_by_instance)

    # -- the main path: prefill, then greedy decode --------------------------
    counts, instances = {}, {}
    kops.reset_kernel_launches()
    # every routing is recorded for phase 18's digest
    with record_routing() as routes:
        with record_lm_kernels(check=True) as pre_calls:
            cache, logits = lm.prefill(cfg, params, batch, LM_CAPACITY)
            torch.cuda.synchronize()
        counts["prefill"] = launches()
        instances["prefill"] = ragged_instances()
        if tuple(logits.shape) != (LM_BATCH, 1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits malformed: "
                                 f"{tuple(logits.shape)}")
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        generated = [tok]
        all_logits = [logits.float()]
        kops.reset_kernel_launches()
        with record_lm_kernels(check=True) as dec_calls:
            logits, cache = lm.decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
        all_logits.append(logits.float())
        counts["decode_1"] = launches()
        instances["decode_1"] = ragged_instances()
        kops.reset_kernel_launches()
        t0 = time.perf_counter()
        for _ in range(LM_DECODE - 1):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            generated.append(tok)
            logits, cache = lm.decode_step(cfg, params, cache, tok)
            all_logits.append(logits.float())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    (ROOT / "build").mkdir(exist_ok=True)
    torch.save(dict(
        tokens=torch.cat(generated, dim=1).cpu().numpy(),
        logits=torch.stack(all_logits).cpu().numpy(),
        pre_routes=routes_np(routes, LM_LAYERS),
        dec_routes=routes_np(routes[LM_LAYERS:], LM_LAYERS * LM_DECODE,
                             layer0_logits=False)),
        ROOT / "build" / TP_SERVE_DIGEST)
    del routes, all_logits
    counts["decode_rest"] = launches()
    instances["decode_rest"] = ragged_instances()
    want = {"prefill": {"ragged_gemm": 3 * LM_LAYERS,
                        "flash_attention": LM_LAYERS},
            "decode_1": {"ragged_gemm": 3 * LM_LAYERS, "flash_attention": 0},
            "decode_rest": {"ragged_gemm": 3 * LM_LAYERS * (LM_DECODE - 1),
                            "flash_attention": 0}}
    if counts != want:
        raise AssertionError(f"lm launch counts {counts}, want {want}")
    for run, by in instances.items():
        if by != {"wgmma": want[run]["ragged_gemm"], "wmma": 0, "f32": 0}:
            raise AssertionError(f"lm {run}: ragged GEMM launches by "
                                 f"instance {by}: every one must run the "
                                 f"wgmma kernel")
    if not bool(torch.isfinite(logits).all()) or \
            int(cache["pos"][0]) != LM_PROMPT + LM_DECODE:
        raise AssertionError("decode ended malformed")
    checks = [{k: v for k, v in c.items() if k != "inputs"}
              for c in pre_calls + dec_calls]
    worst = {n: max(c["err_over_max"] for c in checks if c["name"] == n)
             for n in LM_KERNELS}
    worst_abs = {n: max(c["max_abs_err"] for c in checks if c["name"] == n)
                 for n in LM_KERNELS}
    worst_row = {n: max(c["row_err_over_row_max"] for c in checks
                        if c["name"] == n) for n in LM_KERNELS}
    medians = {n: (min(c["median_plain"] for c in checks if c["name"] == n),
                   max(c["max_plain"] for c in checks if c["name"] == n))
               for n in LM_KERNELS}
    log(f"lm launches: prefill {counts['prefill']}, first decode step "
        f"{counts['decode_1']}, steps 2..{LM_DECODE} "
        f"{counts['decode_rest']}; ragged GEMM by instance {instances}")
    log(f"lm: {len(checks)} launches of the prefill and the first decode "
        f"step held against the plain versions; worst max|diff| / "
        f"max|plain| {worst} (tolerance {LM_TOL}); worst row max|diff| / "
        f"row max|fp32 oracle| {worst_row} (tolerance {LM_TOL}); "
        f"(least median |plain|, largest max|plain|) {medians}")
    gen_toks = torch.cat(generated, dim=1).cpu().numpy()
    log(f"lm: generated {gen_toks.shape[1]} tokens a request, request 0 "
        f"starts {gen_toks[0, :8].tolist()}")

    # -- serving times (peak memory: the timed prefills, the decode cache
    # live; the checked runs above hold the plain versions and oracles) ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = cuda_ms(lambda: lm.prefill(cfg, params, batch, LM_CAPACITY),
                         reps=2, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = decode_s / (LM_DECODE - 1) * 1e3
    pre_prof = step_profile(
        lambda: lm.prefill(cfg, params, batch, LM_CAPACITY))
    dec_prof = step_profile(lambda: lm.decode_step(cfg, params, cache, tok))
    serve = dict(
        prefill_ms=prefill_ms,
        prefill_tokens_s=LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
        decode_ms_per_step=step_ms,
        decode_tokens_s=LM_BATCH / step_ms * 1e3,
        peak_gb=peak_gb, prefill_profile=pre_prof, decode_profile=dec_prof)
    log(f"lm serving: prefill {prefill_ms:.2f} ms "
        f"({serve['prefill_tokens_s']:.0f} tokens/s), decode "
        f"{step_ms:.3f} ms a step ({serve['decode_tokens_s']:.1f} tokens/s "
        f"at batch {LM_BATCH}), peak {peak_gb:.2f} GB; device busy "
        f"{pre_prof['busy_share']:.3f} in a prefill, "
        f"{dec_prof['busy_share']:.3f} in a decode step")
    log(f"  top prefill kernels (ms) {pre_prof['top']}")
    log(f"  top decode kernels (ms) {dec_prof['top']}")

    # -- the kernels at the main path's shapes -------------------------------
    ragged_pre = [c for c in pre_calls if c["name"] == "ragged_gemm"]
    picks = {
        "prefill gate D->F": ragged_pre[0],
        "prefill down F->D": next(c for c in ragged_pre
                                  if c["inputs"][0].shape[1] == cfg.d_ff),
        "decode gate D->F": next(c for c in dec_calls
                                 if c["name"] == "ragged_gemm"),
        "prefill attention": next(c for c in pre_calls
                                  if c["name"] == "flash_attention")}

    def launch_ms(prof, name, launches):
        """Device ms a launch of ``name`` in a traced prefill or decode
        step: the mean over its ``launches`` there (the ragged GEMM's
        gate, up and down products alike)."""
        ms = sum(t for key, t in prof["device_ms"].items()
                 if f"{name}_" in key and "kernel" in key)
        return ms / launches if ms else None

    traced = {"prefill gate D->F": (pre_prof, "ragged_gemm", 3 * LM_LAYERS),
              "prefill down F->D": (pre_prof, "ragged_gemm", 3 * LM_LAYERS),
              "decode gate D->F": (dec_prof, "ragged_gemm", 3 * LM_LAYERS),
              "prefill attention": (pre_prof, "flash_attention", LM_LAYERS)}
    cases = {}
    for tag, call in picks.items():
        case = lm_kernel_case(call, launch_ms(*traced[tag]))
        case["tag"] = tag
        cases[tag] = case
        log(f"  {case['name']:15s} {tag:18s} {case['shape']:30s} ms "
            f"{case['ms']:.4f} device {fmt_ms(case['device_ms'])} plain "
            f"{case['plain_ms']:.4f} bound {case['bound_ms']:.4f} "
            f"({case['bound_by']}) library {fmt_ms(case['library_ms'])}; "
            f"host µs a call {case['host_us']:.1f} (library "
            f"{fmt_us(case['library_host_us'])})")
    del pre_calls, dec_calls, picks, cache, params, batch
    torch.cuda.empty_cache()

    # -- the smoke config in fp32: card (kernels) vs CPU (plain) -------------
    smoke = lm_smoke_check()
    log(f"lm smoke config fp32, prefill + {LM_SMOKE_DECODE} decode steps: "
        f"card vs CPU max |logit diff| {max(smoke):.3e} "
        f"(atol {LM_SMOKE_ATOL})")
    return dict(cut=cut, layers=LM_LAYERS, batch=LM_BATCH, prompt=LM_PROMPT,
                decode_steps=LM_DECODE, launches=counts,
                ragged_instances=instances, checks=checks,
                worst_err_over_max=worst, worst_abs_err=worst_abs,
                worst_row_err_over_row_max=worst_row,
                serve=serve, cases=cases, smoke_fp32_max_abs_diff=smoke)


# ---------------------------------------------------------------------------
# Phase 12: LM training of phi3.5-moe at full width
# ---------------------------------------------------------------------------

LM_TRAIN_LAYERS = 2     # of 32: bf16 params and grads and fp32 moments of
                        # 3 layers leave too little of the 80 GB (see below)
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 2048
LM_TRAIN_STEPS = 8      # on one fixed batch: the loss must fall
LM_TRAIN_SMOKE_STEPS = 3
LM_TRAIN_KERNELS = ("ragged_gemm", "flash_attention", "flash_attention_bwd")
GEMMA_ARCH = "gemma-7b"
GEMMA_TRAIN_LAYERS = 1  # of 28 (gemma_train_phase logs why)
GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ = 1, 2048
GEMMA_TRAIN_STEPS = 5   # step 0 and 4 more on one batch: the loss must fall
LSE_ATOL = 1e-3         # the forward's LSE against the fp32 oracle's: fp32
                        # sums of D products in another order, scores ~10


@contextlib.contextmanager
def record_train_kernels(check: bool):
    """While on, every launch of the three LM training kernels (the
    ragged GEMM forward and its dX, the flash forward with its LSE, the
    flash backward) is recorded by wrapping the ``*_cuda`` names in
    ``kernels.ops``; with ``check`` each is held right away against its
    plain version on its own inputs and, row by row, against the fp32
    oracle (:func:`check_lm_launch`), the LSE against the oracle's within
    ``LSE_ATOL``. The plain versions that ``kernels.ops`` would run on the
    CPU raise if they are given a card tensor meanwhile: none may run
    inside a step on the card. The launch counts are the wrappers'
    own."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, flash_attention_plain_lse)
    from repro_torch.kernels.ragged_gemm import ragged_gemm_plain
    names = ("ragged_gemm_cuda", "flash_attention_cuda",
             "flash_attention_bwd_cuda")
    real = {n: getattr(kops, n) for n in names}
    calls: list = []

    def ragged(x, w, tile_expert, *, tm=128, direction="forward"):
        out = real["ragged_gemm_cuda"](x, w, tile_expert, tm=tm,
                                       direction=direction)
        trans = direction == "backward"
        entry = dict(name="ragged_gemm", direction=direction,
                     shape=f"{x.shape[0]}x{x.shape[1]}x{out.shape[1]}")
        if trans and not any(
                "inputs" in c for c in calls if c["name"] == "ragged_gemm"):
            entry["inputs"] = (x, w, tile_expert)    # the dX timed later
        if check:
            check_lm_launch(entry, out,
                            ragged_gemm_plain(x, w, tile_expert, tm=tm,
                                              transpose_w=trans),
                            ragged_oracle(x, w, tile_expert, tm, trans))
        calls.append(entry)
        return out

    def flash(q, k, v, *, causal=True, window=None, return_lse=False,
              meta_len=0):
        res = real["flash_attention_cuda"](q, k, v, causal=causal,
                                           window=window,
                                           return_lse=return_lse,
                                           meta_len=meta_len)
        out, lse = res if return_lse else (res, None)
        entry = dict(name="flash_attention", shape=f"{tuple(q.shape)}/"
                     f"{tuple(k.shape)}", causal=causal, window=window,
                     meta_len=meta_len)
        if check:
            kw = dict(causal=causal, window=window, meta_len=meta_len)
            want_o, want_lse = flash_attention_plain_lse(
                q.float(), k.float(), v.float(), **kw)
            check_lm_launch(entry, out, flash_attention_plain(q, k, v, **kw),
                            want_o)
            if lse is not None:
                err = float((lse - want_lse).abs().max())
                entry["lse_max_abs_err"] = err
                if not err <= LSE_ATOL:
                    raise AssertionError(f"flash LSE off the fp32 oracle's "
                                         f"by {err} (atol {LSE_ATOL})")
        calls.append(entry)
        return res

    def flash_bwd(q, k, v, o, do, lse, *, causal=True, window=None,
                  meta_len=0):
        out = real["flash_attention_bwd_cuda"](q, k, v, o, do, lse,
                                               causal=causal, window=window,
                                               meta_len=meta_len)
        entry = dict(name="flash_attention_bwd", shape=f"{tuple(q.shape)}/"
                     f"{tuple(k.shape)}", causal=causal, window=window,
                     meta_len=meta_len)
        if not any("inputs" in c for c in calls
                   if c["name"] == "flash_attention_bwd"):
            entry["inputs"] = (q, k, v, o, do, lse)   # timed later
        if check:
            entry.update(check_flash_bwd(
                q, k, v, o, do, lse, out, dict(causal=causal, window=window,
                                               meta_len=meta_len),
                entry["shape"], plant=False))
        calls.append(entry)
        return out

    kops.ragged_gemm_cuda, kops.flash_attention_cuda = ragged, flash
    kops.flash_attention_bwd_cuda = flash_bwd
    try:
        with refuse_plain_on_card(PLAIN_LM, "the train step"):
            yield calls
    finally:
        for n, fn in real.items():
            setattr(kops, n, fn)


# the plain versions ``kernels.ops`` runs for the LM kernels on the CPU
PLAIN_LM = ("ragged_gemm_plain", "flash_attention_plain",
            "flash_attention_plain_lse", "flash_attention_bwd_plain")


@contextlib.contextmanager
def refuse_plain_on_card(names, where: str):
    """While on, the ``kernels.ops`` plain versions ``names`` raise if
    they are given a card tensor: none may run ``where`` on the card."""
    import torch
    from repro_torch.kernels import ops as kops
    real = {n: getattr(kops, n) for n in names}

    def refuse(name):
        def plain(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
                   for a in args):
                raise AssertionError(f"{name} ran on a card tensor inside "
                                     f"{where}")
            return real[name](*args, **kw)
        return plain

    for n in names:
        setattr(kops, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(kops, n, fn)


@contextlib.contextmanager
def record_grads(sink):
    """While on, ``train.lm.loss_and_grads`` (the step's gradient pass)
    hands its (loss, metrics, grads) to ``sink`` as well."""
    from repro_torch.train import lm as TL
    real = TL.loss_and_grads

    def recorded(cfg, params, batch, **kw):
        res = real(cfg, params, batch, **kw)
        sink(res)
        return res

    TL.loss_and_grads = recorded
    try:
        yield
    finally:
        TL.loss_and_grads = real


def adam_params_close(got: dict, want: dict, lr: float, steps: int,
                      tag: str) -> float:
    """The port's stated tolerance of a train step's params against
    another run of it (tests/test_torch_lm_train.py): all but 0.1 % of
    all the elements within 1e-4 relative (of the element and of its
    leaf's largest), every element within 3 lr a step taken (AdamW's
    direction does not shrink with the gradient). Returns the largest
    difference over lr."""
    from repro_torch.optim.optimizer import tree_leaves
    worst, off, total = 0.0, 0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float().cpu(), b.float().cpu()
        d = (a - b).abs()
        off += int((d > 1e-4 * (b.abs().max() + b.abs())).sum())
        total += d.numel()
        worst = max(worst, float(d.max()) / lr)
    if not off <= 1e-3 * total or not worst <= 3 * steps:
        raise AssertionError(f"{tag}: params differ beyond the stated "
                             f"tolerance ({off} of {total} elements off, "
                             f"max {worst:.3f} lr against 3 lr x {steps})")
    return worst


def batch_positions(batch: dict) -> int:
    """Positions a batch runs through the model: its tokens, an audio
    batch's frames, a vlm batch's image prefix."""
    return sum(batch[key].shape[0] * batch[key].shape[1]
               for key in ("tokens", "frames", "image_emb") if key in batch)


def lm_train_smoke_check(arch: str = LM_ARCH, make_batch=None) -> dict:
    """``arch``'s smoke config in fp32 (the kernels' fp32 instances):
    LM_TRAIN_SMOKE_STEPS train steps on the card against the port's CPU
    run from the same weights and batches (``make_batch(cfg, step)``, a
    CPU batch; by default 2 x 64 tokens from ``data/tokens``); losses
    within rtol 1e-4, params within the tolerance the CPU tests state."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    cfg = get_smoke_config(arch)
    step, opt = TL.make_train_step(cfg)
    lr = 3e-4                                  # make_train_step's default
    cpu = TL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                              device="cpu")
    card_params = tree_map(lambda p: p.to(DEVICE, copy=True), cpu.params)
    card = TL.TrainState(card_params, opt.init(card_params), None)
    losses = []
    for i in range(LM_TRAIN_SMOKE_STEPS):
        if make_batch is None:
            toks, tgts = synthetic_lm_batch(2, 64, cfg.vocab, step=i)
            b = {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(tgts)}
        else:
            b = make_batch(cfg, i)
        card, m_card = step(card, {k: v.to(DEVICE) for k, v in b.items()})
        cpu, m_cpu = step(cpu, b)
        lc, lp = float(m_card["loss"]), float(m_cpu["loss"])
        losses.append((lc, lp))
        if not abs(lc - lp) <= 1e-4 * abs(lp):
            raise AssertionError(f"{arch} smoke train step {i}: loss {lc} "
                                 f"on the card, {lp} on the CPU (rtol "
                                 f"1e-4)")
    worst = adam_params_close(card.params, cpu.params, lr,
                              LM_TRAIN_SMOKE_STEPS,
                              f"{arch} smoke train card vs CPU")
    return dict(losses=losses, param_max_diff_over_lr=worst)


def flash_bwd_case(call, device_ms) -> dict:
    """The flash backward at the main path's shape: the kernel (CUDA
    events), its plain version, SDPA's backward with ``enable_gqa`` (a
    yardstick the port never calls), and the bound: five products of 2 D
    flops a kept pair at 989 TFLOP/s against one read of q, k, v, o, dO
    and the LSE and one write of dq, dk, dv at 3.35 TB/s; beside it the
    bound of the work the kernel does, seven products (S and dP again in
    the dQ kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    q, k, v, o, do, lse = call["inputs"]
    b, hq, s, d = q.shape
    t = k.shape[2]
    kw = dict(causal=call["causal"], window=call["window"],
              meta_len=call.get("meta_len", 0))
    flops = 10 * d * attention_pairs(s, t, **kw) * b * hq
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + lse.numel() * 4
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         enable_gqa=True)

    def library():
        return torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    t_bytes, t_ops = H100.mem_time(nbytes), flops / H100.peak_flops
    return dict(
        name="flash_attention_bwd", shape=call["shape"],
        ms=cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                    **kw), reps=10),
        device_ms=device_ms,
        plain_ms=cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, do, lse, **kw), reps=2, warmup=1),
        library_ms=cuda_ms(library, reps=10),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_7_ms=max(t_bytes, t_ops * 7 / 5) * 1e3,
        bytes=nbytes, flops=flops)


def ragged_dx_case(call, device_ms) -> dict:
    """A dX launch of the step at its shape, as the backward makes it
    (the kernel reading the forward's W transposed in place), its plain
    version, ``torch.bmm`` over the (E, C, F) buffer and the transposed
    weights (a yardstick the port never calls) and the GEMM's bound."""
    import torch
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                                 ragged_gemm_plain)
    dy, w, te = call["inputs"]                 # w: the forward's (E, D, F)
    t, f = dy.shape
    e, d = w.shape[0], w.shape[1]
    flops = 2 * t * f * d
    nbytes = (t * f + e * f * d + t * d) * dy.element_size()
    yb = dy.view(e, t // e, f)
    wt = w.transpose(1, 2)                     # a view: cuBLAS transposes
    t_bytes, t_ops = H100.mem_time(nbytes), flops / H100.peak_flops
    return dict(
        name="ragged_gemm dX", shape=call["shape"],
        ms=cuda_ms(lambda: ragged_gemm_cuda(dy, w, te,
                                            direction="backward"), reps=10),
        device_ms=device_ms,
        plain_ms=cuda_ms(lambda: ragged_gemm_plain(dy, w, te,
                                                   transpose_w=True),
                         reps=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.bmm(yb, wt), reps=10),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops)


def planted_bwd_faults(q, k, v, o, do, lse, grads, kw: dict):
    """Faults a backward kernel could make, each a small part of its
    work, planted in its outputs ``grads`` (dq, dk, dv): the dQ kernel
    skipping two keys (T-66 and T-65, missing from every query's sum) or
    one 64-key tile (keys T-128..T-65) for one 64-query tile (the last),
    the dK / dV kernel skipping that query tile for that key tile, or two
    queries (S-66 and S-65) for every key. Yields (name, index in
    ``grads``, the faulted output in fp32); the missing terms are
    computed in fp32 from the inputs, as the oracle's are, under the mask
    ``kw`` (causal, window, meta_len)."""
    import torch
    from repro_torch.kernels.flash_attention import _kept
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g, scale = hq // hkv, 1.0 / d ** 0.5

    def terms(rows, cols):
        qf, dof, of = (x[:, :, rows].float().reshape(b, hkv, g, -1, d)
                       for x in (q, do, o))
        kf, vf = k[:, :, cols].float(), v[:, :, cols].float()
        qpos = torch.arange(s, device=q.device)[rows] + (t - s)
        mask = _kept(torch.arange(t, device=q.device)[cols][None, :],
                     qpos[:, None], t, **kw)
        sc = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
        p = torch.where(mask, torch.exp(
            sc - lse[:, :, rows].reshape(b, hkv, g, -1, 1)), 0.0)
        ds = p * (torch.einsum("bkgsd,bktd->bkgst", dof, vf)
                  - (dof * of).sum(-1, keepdim=True))
        return (scale * torch.einsum("bkgst,bktd->bkgsd", ds, kf)
                .reshape(b, hq, -1, d),
                scale * torch.einsum("bkgst,bkgsd->bktd", ds, qf),
                torch.einsum("bkgst,bkgsd->bktd", p, dof))

    every_q, every_k = slice(0, s), slice(0, t)
    q_tile, k_tile = slice(s - 64, s), slice(t - 128, t - 64)
    two_q, two_k = slice(s - 66, s - 64), slice(t - 66, t - 64)
    for name, part, rows, cols in (
            ("dq without keys T-66, T-65", 0, every_q, two_k),
            ("dq without one 64 x 64 tile", 0, q_tile, k_tile),
            ("dk without one 64 x 64 tile", 1, q_tile, k_tile),
            ("dv without one 64 x 64 tile", 2, q_tile, k_tile),
            ("dk without queries S-66, S-65", 1, two_q, every_k),
            ("dv without queries S-66, S-65", 2, two_q, every_k)):
        faulted = grads[part].float().clone()
        at = rows if part == 0 else cols
        faulted[:, :, at] -= terms(rows, cols)[part]
        yield name, part, faulted


def check_flash_bwd(q, k, v, o, do, lse, grads, kw: dict, shape: str,
                    plant: bool = True) -> dict:
    """Hold a flash backward's outputs ``grads`` (dq, dk, dv) for inputs
    q, k, v, o, do, lse under the mask ``kw`` by :func:`check_lm_launch`:
    against the plain version and, row by row past
    ``flash_bwd_row_floors``, the fp32 oracle. With ``plant``, then plant
    the faults of :func:`planted_bwd_faults` in them: each must fail the
    row check (its whole-tensor error against the plain version, which
    may pass, is recorded). Returns the worst errors over the three
    outputs and, by fault, the row and whole-tensor ratios; raises if the
    outputs fail or a fault passes."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_bwd_row_floors)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    oracle = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), do.float(), lse, **kw)
    floors = flash_bwd_row_floors(q, k, v, o, do, lse, **kw)
    out: dict = {}
    for part, g_, w_, orc, fl in zip(("dq", "dk", "dv"), grads, want,
                                     oracle, floors):
        entry = dict(name=f"flash_attention_bwd {part}", shape=shape)
        check_lm_launch(entry, g_, w_, orc, row_floor=fl)
        for key in ("max_abs_err", "max_plain", "err_over_max",
                    "row_err_over_row_max", "plain_row_err_over_row_max"):
            out[key] = max(out.get(key, 0.0), entry[key])
    if not plant:
        return out
    out["planted_faults"] = {}
    for name, part, faulted in planted_bwd_faults(q, k, v, o, do, lse,
                                                  grads, kw):
        entry = dict(name=f"planted fault: {name}", shape=shape)
        try:        # held against itself: only the row check can fail
            check_lm_launch(entry, faulted, faulted, oracle[part],
                            row_floor=floors[part])
        except AssertionError as err:
            if "a row" not in str(err):
                raise
        else:
            raise AssertionError(f"{shape}: the row check passed a planted "
                                 f"fault ({name}): worst row "
                                 f"{entry['row_err_over_row_max']:.3e}")
        out["planted_faults"][name] = dict(
            row=entry["row_err_over_row_max"],
            whole_vs_plain=float((faulted - want[part].float()).abs().max())
            / max(float(want[part].float().abs().max()), 1e-30))
    caught = "; ".join(f"{n} {r['row']:.2e} ({r['whole_vs_plain']:.2e})"
                       for n, r in out["planted_faults"].items())
    log(f"  {shape}: planted backward faults, each failing the row check "
        f"(worst row ratio, tolerance {LM_TOL}; in brackets the whole-"
        f"tensor ratio against the plain version): {caught}")
    return out


GEMMA_ATTN = dict(b=1, hq=16, hkv=16, s=2048, t=2048, d=256,
                  causal=True)                               # gemma-7b


def attention_case(c: dict, seed: int, bwd_kernels: tuple) -> dict:
    """One attention shape as a kernel case: ``c`` holds b, hq, hkv, s, t,
    d and the mask (``causal``, ``window``, ``meta_len``); bf16 inputs
    drawn from ``seed`` on the card. The flash forward with its LSE and
    the backward, each launched twice for the same bits on the ``wgmma``
    instance, each held against its plain version and, row by row, the
    fp32 oracle (:func:`check_lm_launch`; the LSE within ``LSE_ATOL``; the
    backward by :func:`check_flash_bwd`, planted faults included), then
    each timed: CUDA
    events, the device trace (the backward's kernels ``bwd_kernels`` one
    by one), its bound over the kept pairs (the larger of its operations
    at 989 TFLOP/s and its bytes at 3.35 TB/s; the backward's also over
    the seven products it runs, ``bound_7_ms``),
    its plain version, and SDPA given the same mask (``is_causal``
    without a window, else a boolean mask of the kept pairs; a yardstick
    the port never calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.autotune import H100
    from repro_torch.kernels.flash_attention import (
        _kept, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain,
        flash_attention_plain_lse)
    d = c["d"]
    kw = dict(causal=c.get("causal", True), window=c.get("window"),
              meta_len=c.get("meta_len", 0))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).bfloat16()
    q, do = randn(c["b"], c["hq"], c["s"], d), randn(c["b"], c["hq"], c["s"], d)
    k, v = randn(c["b"], c["hkv"], c["t"], d), randn(c["b"], c["hkv"], c["t"], d)
    shape = f"{tuple(q.shape)}/{tuple(k.shape)}" + (
        "" if kw["causal"] else " non-causal") + (
        "" if kw["window"] is None else f" w{kw['window']} m{kw['meta_len']}")
    by_inst = dict(flash_attention_cuda.launches_by_instance)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    fwd_inst = {n: m - by_inst[n] for n, m in
                flash_attention_cuda.launches_by_instance.items()}
    if not torch.equal(o, o2) or not torch.equal(lse, lse2) or \
            fwd_inst != {"wgmma": 2, "f32": 0}:
        raise AssertionError(f"{shape} forward: two launches differ, or ran "
                             f"{fwd_inst}")
    del o2, lse2
    fwd = dict(name="flash_attention", shape=shape)
    want_o, want_lse = flash_attention_plain_lse(q.float(), k.float(),
                                                 v.float(), **kw)
    check_lm_launch(fwd, o, flash_attention_plain(q, k, v, **kw), want_o)
    fwd["lse_max_abs_err"] = float((lse - want_lse).abs().max())
    if not fwd["lse_max_abs_err"] <= LSE_ATOL:
        raise AssertionError(f"{shape} flash LSE off the fp32 oracle's by "
                             f"{fwd['lse_max_abs_err']} (atol {LSE_ATOL})")
    del want_o, want_lse
    by_inst = dict(flash_attention_bwd_cuda.launches_by_instance)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    bwd_inst = {n: m - by_inst[n] for n, m in
                flash_attention_bwd_cuda.launches_by_instance.items()}
    if bwd_inst != {"wgmma": 2, "wmma": 0, "f32": 0} or \
            not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{shape} backward: ran {bwd_inst}, or two "
                             f"launches differ")
    del again
    bwd = dict(name="flash_attention_bwd", shape=shape, instance="wgmma",
               **check_flash_bwd(q, k, v, o, do, lse, got, kw, shape))
    del got
    torch.cuda.synchronize()
    pairs = attention_pairs(c["s"], c["t"], **kw) * c["b"] * c["hq"]
    elem = q.element_size()
    for case, flops, nbytes in (
            (fwd, 4 * d * pairs, (2 * q.numel() + 2 * k.numel()) * elem),
            (bwd, 10 * d * pairs,
             (4 * q.numel() + 4 * k.numel()) * elem + lse.numel() * 4)):
        t_bytes, t_ops = H100.mem_time(nbytes), flops / H100.peak_flops
        case.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    flops=flops, bytes=nbytes, pairs=pairs)
    bwd["bound_7_ms"] = max(H100.mem_time(bwd["bytes"]),
                            bwd["flops"] * 7 / 5 / H100.peak_flops) * 1e3
    fwd["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, return_lse=True,
                                                     **kw))
    fwd["device_ms"] = traced_ms(lambda: flash_attention_cuda(
        q, k, v, return_lse=True, **kw), 10, "flash_attention_wgmma")
    fwd["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                              reps=2, warmup=1)
    bwd["ms"] = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                         **kw))
    parts = {}
    for _ in range(3):      # a late trace may lose kernels: take it again
        us = device_us(lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                        **kw), 10)
        parts = {part: sum(t for name, t in us.items()
                           if f"flash_bwd_{part}" in name) / 10 / 1e3 or None
                 for part in bwd_kernels}
        if all(parts.values()):
            break
    bwd["kernel_device_ms"] = parts
    bwd["device_ms"] = sum(parts.values()) if all(parts.values()) else None
    bwd["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, do, lse, **kw), reps=2, warmup=1)
    sdpa = dict(enable_gqa=True)
    if kw["window"] is None:
        sdpa["is_causal"] = kw["causal"]
    else:
        qpos = torch.arange(c["s"], device=DEVICE) + (c["t"] - c["s"])
        sdpa["attn_mask"] = _kept(torch.arange(c["t"], device=DEVICE)[None, :],
                                  qpos[:, None], c["t"], **kw)
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    try:
        fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, **sdpa))
        out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
        bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
    except (RuntimeError, TypeError) as err:   # no SDPA route for it
        fwd["library_ms"] = bwd["library_ms"] = None
        fwd["library_error"] = str(err)[:200]
    return dict(forward=fwd, backward=bwd, launches=dict(
        forward=fwd_inst, backward=bwd_inst))


def train_checks(tag: str, cfg, batch: dict, n_steps: int,
                 want: dict, keep_state: bool = False,
                 digest: bool = False) -> dict:
    """One model's training on the card as phase 12 checks it:
    ``make_train_step``'s defaults, seeded random init on the card. Step 0
    with its launch counts (``want``: ``launches`` by kernel, the ragged
    GEMM's ``ragged_directions`` and ``ragged_instances``, the flash
    backward's ``bwd_instances``), every launch held against its plain
    version and the fp32 oracle (:func:`record_train_kernels`); step 0
    again from the same state, bit for bit; ``n_steps`` steps on the one
    batch with a falling loss; ms a step and tokens/s (host clock over
    steps 1 ..), the busy share and device ms by kernel of a traced step,
    peak memory. ``inputs`` holds the first flash backward's and ragged
    dX's records with their inputs, by kernel name, for timing; with
    ``keep_state`` the result also holds ``step_fn``, the trained
    ``state`` and the ``batch``; with ``digest``, step 0's
    :func:`train_digest` (phase 18 holds its split step against it)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import lm as TL

    step_fn, opt = TL.make_train_step(cfg)
    n = cfg.param_count()
    t0 = time.perf_counter()
    state = TL.make_train_state(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), opt,
        device=DEVICE)
    torch.cuda.synchronize()
    log(f"{tag} train: {n / 1e9:.3f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    p0 = tree_map(torch.clone, state.params)

    # -- step 0: counts, every launch checked, gradients kept ----------------
    run1: list = []
    torch.cuda.synchronize()
    kops.reset_kernel_launches()
    with record_train_kernels(check=True) as calls, \
            record_grads(lambda r: run1.append(
                (r[0].clone(), tree_map(torch.clone, r[2])))), \
            record_routing() as routes:
        state, m0 = step_fn(state, batch)
        torch.cuda.synchronize()
    got = dict(launches={name: kops.kernel_launches()[name]
                         for name in LM_TRAIN_KERNELS},
               ragged_directions=dict(ragged_gemm_cuda.launches_by_direction),
               ragged_instances=dict(ragged_gemm_cuda.launches_by_instance),
               bwd_instances=dict(
                   flash_attention_bwd_cuda.launches_by_instance))
    if got != want:
        raise AssertionError(f"{tag} train step 0 launched {got}, want "
                             f"{want}")
    metrics0 = {k: float(v) for k, v in m0.items()}
    if not all(np.isfinite(list(metrics0.values()))):
        raise AssertionError(f"{tag} train step 0 metrics {metrics0}")
    checks = [{k: v for k, v in c.items() if k != "inputs"} for c in calls]
    worst, worst_row, plain_row = {}, {}, {}
    for c in checks:
        key = c["name"] + (" dX" if c.get("direction") == "backward" else "")
        worst[key] = max(worst.get(key, 0.0), c["err_over_max"])
        worst_row[key] = max(worst_row.get(key, 0.0),
                             c["row_err_over_row_max"])
        plain_row[key] = max(plain_row.get(key, 0.0),
                             c["plain_row_err_over_row_max"])
    log(f"{tag} train step 0: {got}; metrics {metrics0}")
    log(f"{tag} train step 0: {len(checks)} launches held against their "
        f"plain versions; worst max|diff| / max|plain| {worst} (tolerance "
        f"{LM_TOL}); worst row against the fp32 oracle {worst_row} (the "
        f"plain version's own {plain_row}); flash LSE "
        f"{max((c.get('lse_max_abs_err', 0.0) for c in checks), default=0):.2e}"
        f" (atol {LSE_ATOL})")
    inputs = {c["name"]: c for c in calls if "inputs" in c}
    del calls

    # -- step 0 again from the same state: the same bits ---------------------
    p1 = tree_map(torch.clone, state.params)
    loss1, g1 = run1.pop()
    dig = train_digest(loss1, p0, g1, p1, routes, cfg.n_layers) \
        if digest else None
    del routes
    mismatched = []

    def compare(res):
        if not torch.equal(res[0], loss1):
            mismatched.append("loss")
        for i, (a, b) in enumerate(zip(tree_leaves(res[2]),
                                       tree_leaves(g1))):
            if not torch.equal(a, b):
                mismatched.append(f"grad {i}")

    with torch.no_grad():
        tree_map(lambda p, q: p.copy_(q), state.params, p0)
        tree_map(torch.Tensor.zero_, state.opt_state.mu)
        tree_map(torch.Tensor.zero_, state.opt_state.nu)
    state = TL.TrainState(state.params, state.opt_state._replace(
        step=torch.zeros_like(state.opt_state.step)), None)
    with record_grads(compare):
        state, m0b = step_fn(state, batch)
    for i, (a, b) in enumerate(zip(tree_leaves(state.params),
                                   tree_leaves(p1))):
        if not torch.equal(a, b):
            mismatched.append(f"param {i}")
    if mismatched or float(m0b["loss"]) != metrics0["loss"]:
        raise AssertionError(f"{tag} train step 0 twice from the same "
                             f"state: not the same bits in {mismatched[:8]}")
    n_leaves = len(tree_leaves(p1))
    log(f"{tag} train step 0 twice from the same state: loss, {n_leaves} "
        f"gradients and {n_leaves} updated params equal bit for bit")
    del p0, p1, g1, loss1

    # -- n_steps steps on one fixed batch ------------------------------------
    losses = [metrics0["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_metrics = []
    for _ in range(n_steps - 1):
        state, m = step_fn(state, batch)
        step_metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses += [float(m["loss"]) for m in step_metrics]
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} train: loss did not fall on a fixed "
                             f"batch: {losses}")
    step_ms = wall / (n_steps - 1) * 1e3
    tokens_s = batch_positions(batch) / step_ms * 1e3
    prof = step_profile(lambda: step_fn(state, batch))
    log(f"{tag} train: losses over {n_steps} steps on one batch "
        f"{[round(x, 4) for x in losses]}; {step_ms:.1f} ms a step "
        f"({tokens_s:.0f} positions/s, host clock over steps "
        f"1..{n_steps - 1})"
        f", device busy {prof['busy_share']:.3f} in a traced step, peak "
        f"{peak_gb:.2f} GB")
    log(f"  top step kernels (ms) {prof['top']}")
    res = dict(launches=got["launches"],
               ragged_by_direction=got["ragged_directions"],
               ragged_instances=got["ragged_instances"],
               flash_bwd_instances=got["bwd_instances"],
               metrics_step0=metrics0, checks=checks,
               worst_err_over_max=worst, worst_row=worst_row,
               plain_worst_row=plain_row,
               losses=losses, step_ms=step_ms, tokens_s=tokens_s,
               peak_gb=peak_gb, profile=prof, inputs=inputs)
    if keep_state:
        res.update(step_fn=step_fn, state=state, batch=batch)
    if digest:
        res["digest"] = dig
    return res


def lm_checkpoint_case(tag: str, step_fn, state, batch, base: Path) -> dict:
    """Phase 13 (d): an asynchronous ``Checkpointer.save`` of a whole LM
    train state on the card (bf16 params, fp32 moments) under
    ``base``, one in-place step at once while the write runs, a
    restore that must equal a device clone taken before the save bit for
    bit, and the next step from both, bit for bit. Logs the free disk
    before the save, the host copy and write seconds, whether the write
    outlasted the step, and the step's ms with and without a write in
    flight. The caller removes ``base``."""
    import torch
    from repro_torch.ckpt import Checkpointer
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import lm as TL

    def leaves(st):
        return (tree_leaves(st.params) + [st.opt_state.step] +
                tree_leaves(st.opt_state.mu) + tree_leaves(st.opt_state.nu))

    def timed_step(st):
        """(state, metrics, wall ms, ms until the step had enqueued its
        work: the step reads nothing back, so that is its host time)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step_fn(st, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return st, m, ((time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3)

    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    free_gb = shutil.disk_usage(base).free / 1e9
    nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
    state, _, (plain_ms, plain_host_ms) = timed_step(state)   # no write
    clone = TL.TrainState(
        tree_map(torch.clone, state.params),
        state.opt_state._replace(step=state.opt_state.step.clone(),
                                 mu=tree_map(torch.clone, state.opt_state.mu),
                                 nu=tree_map(torch.clone, state.opt_state.nu)),
        None)
    torch.cuda.synchronize()
    ck = Checkpointer(str(base), keep=1)
    t0 = time.perf_counter()
    ck.save(1, state)
    t_copy = time.perf_counter()
    # in place, while the write runs
    state, _, (during_ms, during_host_ms) = timed_step(state)
    overlapped = ck.in_flight
    ck.wait()
    t_written = time.perf_counter()
    on_disk = ckpt_dir_bytes(base / "step_000000001")
    changed = sum(not torch.equal(a, b)
                  for a, b in zip(leaves(state), leaves(clone)))
    del state
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    restored, step = ck.restore(clone)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    same = [a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(leaves(restored), leaves(clone))]
    if step != 1 or not same or not all(same) or not changed:
        raise AssertionError(f"{tag} checkpoint: restored step {step}, "
                             f"{same.count(False)} of {len(same)} leaves "
                             f"differ from the clone; the in-place step "
                             f"changed {changed} leaves")
    s1, m1 = step_fn(restored, batch)
    s2, m2 = step_fn(clone, batch)
    next_same = [torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2))]
    if float(m1["loss"]) != float(m2["loss"]) or not all(next_same):
        raise AssertionError(f"{tag} checkpoint: the next step from the "
                             f"restored state and from the clone differ "
                             f"({next_same.count(False)} leaves)")
    del s1, s2, restored, clone
    torch.cuda.empty_cache()
    out = dict(state_bytes=nbytes, bytes_on_disk=on_disk, free_gb=free_gb,
               host_copy_s=t_copy - t0, write_s=ck.last_write_s,
               save_to_durable_s=t_written - t0,
               write_outlasted_step=overlapped, restore_s=restore_s,
               step_ms_writing=during_ms, step_ms_plain=plain_ms,
               step_host_ms_writing=during_host_ms,
               step_host_ms_plain=plain_host_ms,
               leaves=len(same), leaves_changed_by_step=changed)
    log(f"{tag} checkpoint: {nbytes / 1e9:.2f} GB of state ({len(same)} "
        f"leaves; {on_disk / 1e9:.2f} GB on disk, {free_gb:.1f} GB free "
        f"before): host copy {out['host_copy_s']:.2f} s, then the write "
        f"{out['write_s']:.2f} s in the background (outlasted the step: "
        f"{overlapped}; durable {out['save_to_durable_s']:.2f} s after the "
        f"call), restore {restore_s:.2f} s; the in-place step "
        f"{during_ms:.1f} ms with the write in flight, {plain_ms:.1f} ms "
        f"without (enqueued in {during_host_ms:.1f} / {plain_host_ms:.1f} "
        f"ms of host time); restored state and the next step from it equal "
        f"the clone's bit for bit")
    return out


def traced_launch_ms(prof: dict, key: str, launches: int):
    """Device ms a launch of the kernels whose names contain ``key`` in a
    traced step (:func:`step_profile`), None where the trace has none."""
    ms = sum(t for name, t in prof["device_ms"].items() if key in name)
    return ms / launches if ms else None


def gemma_train_phase() -> dict:
    """gemma-7b at full width cut to GEMMA_TRAIN_LAYERS layers through
    :func:`train_checks`, B GEMMA_TRAIN_BATCH x GEMMA_TRAIN_SEQ tokens
    from ``data/tokens``: step 0 launches the flash forward twice (once
    recomputed under remat "full"), the flash backward once on the
    ``wgmma`` instance (head dim 256: the head dim split across the
    warpgroups) and no ragged GEMM (the dense GeGLU MLP is ``matmul``);
    the backward's kernels' device ms are read from the traced step."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch
    full = get_config(GEMMA_ARCH)
    cfg = dc.replace(full, n_layers=GEMMA_TRAIN_LAYERS)
    n = cfg.param_count()
    emb = dc.replace(full, n_layers=0).param_count()
    cut = (f"{GEMMA_ARCH} at full width (d_model {cfg.d_model}, "
           f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, "
           f"GeGLU d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied embeddings), "
           f"{GEMMA_TRAIN_LAYERS} of {full.n_layers} layers, remat "
           f"{cfg.remat!r}: {n / 1e6:.1f} M parameters ({emb / 1e6:.1f} M "
           f"of embedding, {(n - emb) / 1e6:.1f} M a layer); bf16 params "
           f"and grads {2 * n / 1e9:.2f} GB each, fp32 moments "
           f"{8 * n / 1e9:.2f} GB; all {full.n_layers} layers would hold "
           f"{12 * full.param_count() / 1e9:.1f} GB of the card's 80 before "
           f"any activation; each further layer repeats the same launches "
           f"and adds ~{12 * (n - emb) / 1e9:.1f} GB and its AdamW passes "
           f"to a phase the script's time limit bounds")
    log(f"cut: {cut}")
    toks, tgts = synthetic_lm_batch(GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ,
                                    cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(DEVICE),
             "targets": torch.from_numpy(tgts).to(DEVICE)}
    want = dict(launches={"ragged_gemm": 0,
                          "flash_attention": 2 * GEMMA_TRAIN_LAYERS,
                          "flash_attention_bwd": GEMMA_TRAIN_LAYERS},
                ragged_directions={"forward": 0, "backward": 0},
                ragged_instances={"wgmma": 0, "wmma": 0, "f32": 0},
                bwd_instances={"wgmma": GEMMA_TRAIN_LAYERS, "wmma": 0,
                               "f32": 0})
    res = train_checks(GEMMA_ARCH, cfg, batch, GEMMA_TRAIN_STEPS, want,
                       keep_state=True)
    del res["inputs"]
    # phase 13 (d): the whole train state checkpointed while a step runs,
    # under chiprun_out/ (removed whatever happens: it holds 10.6 GB)
    ckpt_dir = ROOT / "chiprun_out" / "phase13_lm_ckpt"
    try:
        res["checkpoint"] = lm_checkpoint_case(
            GEMMA_ARCH, res.pop("step_fn"), res.pop("state"),
            res.pop("batch"), ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    res["bwd_device_ms"] = {
        part: traced_launch_ms(res["profile"], f"flash_bwd_{part}",
                               GEMMA_TRAIN_LAYERS)
        for part in ("delta", "dkdv_split", "dq_split")}
    log(f"  gemma-7b step's flash backward device ms by kernel "
        f"{res['bwd_device_ms']}")
    res.update(cut=cut, layers=GEMMA_TRAIN_LAYERS, batch=GEMMA_TRAIN_BATCH,
               seq=GEMMA_TRAIN_SEQ)
    return res


def lm_train_phase() -> dict:
    """Phase 12: LM training of phi3.5-moe at full width cut to
    LM_TRAIN_LAYERS layers, bf16 params, fp32 Adam moments, remat "full",
    4 x 2,048 tokens from ``data/tokens``, through :func:`train_checks`
    (8 steps); the flash backward and a dX launch timed at its shapes;
    then gemma-7b at full width cut to 1 layer through the same checks
    (its head dim 256: the split backward instance), gemma's attention
    as a kernel case, and the smoke config in fp32 on the card against
    the CPU."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch

    t_phase = time.perf_counter()
    full = get_config(LM_ARCH)
    cfg = dc.replace(full, n_layers=LM_TRAIN_LAYERS)
    n = cfg.param_count()
    per_layer = n - dc.replace(full, n_layers=LM_TRAIN_LAYERS - 1
                               ).param_count()
    expert_leaf = cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff
    cut = (f"{LM_ARCH} at full width, {LM_TRAIN_LAYERS} of "
           f"{full.n_layers} layers, remat {cfg.remat!r}: "
           f"{n / 1e6:.1f} M parameters ({per_layer / 1e6:.1f} M a layer, "
           f"{(n - LM_TRAIN_LAYERS * per_layer) / 1e6:.1f} M of embedding "
           f"and head); bf16 params {2 * n / 1e9:.1f} GB, bf16 grads "
           f"{2 * n / 1e9:.1f} GB, fp32 moments {8 * n / 1e9:.1f} GB; an "
           f"fp32 temporary of an expert leaf {4 * expert_leaf / 1e9:.1f} "
           f"GB; 3 layers would hold "
           f"{12 * dc.replace(full, n_layers=3).param_count() / 1e9:.1f} GB "
           f"of the card's 80 before any activation or update")
    log(f"cut: {cut}")
    toks, tgts = synthetic_lm_batch(LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(DEVICE),
             "targets": torch.from_numpy(tgts).to(DEVICE)}
    n_ragged = 3 * LM_TRAIN_LAYERS
    want = dict(launches={"ragged_gemm": 3 * n_ragged,
                          "flash_attention": 2 * LM_TRAIN_LAYERS,
                          "flash_attention_bwd": LM_TRAIN_LAYERS},
                ragged_directions={"forward": 2 * n_ragged,
                                   "backward": n_ragged},
                ragged_instances={"wgmma": 3 * n_ragged, "wmma": 0, "f32": 0},
                bwd_instances={"wgmma": LM_TRAIN_LAYERS, "wmma": 0,
                               "f32": 0})
    phi = train_checks(LM_ARCH, cfg, batch, LM_TRAIN_STEPS, want,
                       digest=True)
    del batch
    (ROOT / "build").mkdir(exist_ok=True)
    torch.save(phi.pop("digest"), ROOT / "build" / TP_TRAIN_DIGEST)
    inputs = phi.pop("inputs")
    prof = phi["profile"]

    # -- the kernels at the main path's shapes -------------------------------
    bwd = flash_bwd_case(inputs["flash_attention_bwd"], traced_launch_ms(
        prof, "flash_bwd_d", LM_TRAIN_LAYERS))
    # the step's 18 ragged launches do equal work (20,480 rows, 4,096 x
    # 6,400 either way round), so their traced mean is a dX launch's
    dx = ragged_dx_case(inputs["ragged_gemm"], traced_launch_ms(
        prof, "ragged_gemm", 3 * n_ragged))
    for case in (bwd, dx):
        log(f"  {case['name']:20s} {case['shape']:30s} ms {case['ms']:.4f} "
            f"device {fmt_ms(case['device_ms'])} plain "
            f"{case['plain_ms']:.4f} bound {case['bound_ms']:.4f} "
            f"({case['bound_by']}) library {fmt_ms(case['library_ms'])}")
    log(f"  flash backward's seven-product bound {bwd['bound_7_ms']:.4f} ms")
    del inputs
    torch.cuda.empty_cache()

    gemma_train = gemma_train_phase()
    torch.cuda.empty_cache()
    gemma = attention_case(GEMMA_ATTN, 7, ("delta", "dkdv_split",
                                           "dq_split"))
    for case in (gemma["forward"], gemma["backward"]):
        log(f"  gemma-7b {case['name']:20s} {case['shape']:30s} ms "
            f"{case['ms']:.4f} device {fmt_ms(case['device_ms'])} plain "
            f"{case['plain_ms']:.4f} bound {case['bound_ms']:.4f} "
            f"({case['bound_by']}) library {fmt_ms(case['library_ms'])}; "
            f"max|diff| / max|plain| {case['err_over_max']:.2e}, row "
            f"{case['row_err_over_row_max']:.2e} (tolerance {LM_TOL})")
    log(f"  gemma-7b backward by instance {gemma['launches']['backward']}, "
        f"seven-product bound {gemma['backward']['bound_7_ms']:.4f} ms, "
        f"two launches bitwise equal")
    torch.cuda.empty_cache()

    smoke = lm_train_smoke_check()
    log(f"lm train smoke config fp32, {LM_TRAIN_SMOKE_STEPS} steps card vs "
        f"CPU: losses {smoke['losses']}; params' largest difference "
        f"{smoke['param_max_diff_over_lr']:.3f} lr")
    return dict(phi, cut=cut, layers=LM_TRAIN_LAYERS, batch=LM_TRAIN_BATCH,
                seq=LM_TRAIN_SEQ, gemma_train=gemma_train,
                gemma_attention=gemma, flash_bwd_case=bwd, dx_case=dx,
                smoke=smoke, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Phase 14: the ssm (mamba2) and hybrid (hymba) families on the card
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-1.3b", "hymba-1.5b")
SSM_BATCH, SSM_PROMPT, SSM_DECODE = 4, 2048, 32
SSM_RECUR = 8           # decode steps held against a prefill that long
SSM_RECUR_TOL = 1e-3    # fp32: max|decoded - prefilled last logits| over
                        # max|prefilled|: the recurrence against the chunked
                        # SSD and decode attention against the flash path,
                        # fp32 sums in another order through every layer
SSD_TOL = 1e-3          # fp32: max|chunked - sequential SSD| over max|y|
                        # on one layer's inputs (2,048 tokens, chunk 256)
SSM_TRAIN_LAYERS = 4    # of 48 (mamba2) and of 32 (hymba)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 4, 2048, 5
# hymba-1.5b's sliding-window attention with its meta-token sinks
SINK_ATTN = dict(b=4, hq=25, hkv=5, s=2176, t=2176, d=64, causal=True,
                 window=1024, meta_len=128)


@contextlib.contextmanager
def ssd_capture(sink):
    """While on, each ``ssd_chunked`` call of the mixers hands its inputs
    (x, dt, a, b, c, init_state, chunk) to ``sink`` and runs inside a
    ``torch.profiler.record_function("ssd_chunked")`` range, so that a
    trace attributes its device time."""
    import torch
    from repro_torch.models.lm import mamba2 as M
    real = M.ssd_chunked

    def ssd(x, dt, a, b, c, *, chunk, init_state=None):
        sink((x, dt, a, b, c, init_state, chunk))
        with torch.profiler.record_function("ssd_chunked"):
            return real(x, dt, a, b, c, chunk=chunk, init_state=init_state)

    M.ssd_chunked = ssd
    try:
        yield
    finally:
        M.ssd_chunked = real


def ssd_profile(fn) -> dict:
    """A traced call of ``fn`` (:func:`profiled`: a discarded warm-up, an
    idle gap) with every ``ssd_chunked`` in a range of its own: the
    device ms of all kernels and of those the SSD launched, and the
    SSD's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    got = {}
    with ssd_capture(lambda _: None):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.setdefault(
                         "events", p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.25)
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = got["events"]
    times = kernel_times(events)
    total = sum(us for key, us in times.items() if key != "ssd_chunked")
    # the range's device time: its kernels' sum (the host-side range's
    # device total), else the device-side annotation's span
    ssd = sum(float(getattr(e, "device_time_total", 0.0) or
                    getattr(e, "cuda_time_total", 0.0))
              for e in events if e.key == "ssd_chunked" and
              str(getattr(e, "device_type", "")).endswith("CPU")) or \
        times.get("ssd_chunked", 0.0)
    return dict(device_ms=total / 1e3, ssd_ms=ssd / 1e3 if ssd else None,
                ssd_share=ssd / total if ssd and total else None)


def serve_times(arch: str, cfg, params, prompt: dict, cap: int, tok,
                decode_step_s: float) -> dict:
    """The serving times of a model whose main path has run: the prefill
    of ``prompt`` into ``cap`` slots (CUDA events, 2 calls after 1),
    positions/s, peak memory, a traced prefill's and decode step's busy
    share and top kernels, a decode step's host ms to enqueue (``tok``
    fed again), and the main path's decode step (``decode_step_s``)
    as ms and tokens/s. Logs them."""
    import torch
    from repro_torch.models import lm

    def pre():
        return lm.prefill(cfg, params, prompt, cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = cuda_ms(pre, reps=2, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre_prof = step_profile(pre)
    one = [pre()[0]]

    def dec():
        _, one[0] = lm.decode_step(cfg, params, one[0], tok)
    dec_prof = step_profile(dec)
    dec_host_ms = host_us(dec, reps=5) / 1e3
    del one
    step_ms = decode_step_s * 1e3
    batch_size = tok.shape[0]
    serve = dict(prefill_ms=prefill_ms,
                 prefill_tokens_s=batch_positions(prompt) / prefill_ms * 1e3,
                 decode_ms_per_step=step_ms,
                 decode_tokens_s=batch_size / step_ms * 1e3,
                 decode_host_ms=dec_host_ms,
                 decode_device_ms=dec_prof["device_s"] * 1e3,
                 peak_gb=peak_gb, prefill_profile=pre_prof,
                 decode_profile=dec_prof)
    log(f"{arch} serving: prefill {prefill_ms:.2f} ms "
        f"({serve['prefill_tokens_s']:.0f} positions/s), decode "
        f"{step_ms:.3f} ms a step ({serve['decode_tokens_s']:.1f} tokens/s "
        f"at batch {batch_size}; {dec_host_ms:.3f} ms to enqueue, "
        f"{serve['decode_device_ms']:.3f} ms on the device), peak "
        f"{peak_gb:.2f} GB; busy {pre_prof['busy_share']:.3f} in a prefill, "
        f"{dec_prof['busy_share']:.3f} in a decode step")
    log(f"  top prefill kernels (ms) {pre_prof['top']}")
    log(f"  top decode kernels (ms) {dec_prof['top']}")
    return serve


def ssm_serve_case(arch: str) -> dict:
    """Phase 14 (a) for one model at full width and full depth, bf16,
    seeded random weights on the card: 4 prompts of 2,048 tokens,
    ``prefill`` into a cache of prompt + meta + 32 slots, 32 greedy
    ``decode_step``s. Launch counts zeroed just before the prefill and
    read just after: hymba one flash launch a layer, every one on the
    ``wgmma`` instance with its sinks, each held against its plain version
    and, row by row, the fp32 oracle; no plain flash version on a card
    tensor; mamba2 none. Logits finite. Then the serving times, the busy
    share, the SSD's share of a traced prefill's device time, the SSD
    oracle on layer 0's inputs (fp32), and, in fp32 at one prompt, a
    prefill of S tokens and SSM_RECUR decode steps against a prefill of S
    + SSM_RECUR."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.models.lm import mamba2 as M
    from repro_torch.optim.optimizer import tree_map

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
    torch.cuda.synchronize()
    n = cfg.param_count()
    log(f"{arch}: {n / 1e9:.3f} B parameters ({2 * n / 1e9:.2f} GB bf16, all "
        f"{cfg.n_layers} layers) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    toks, _ = synthetic_lm_batch(SSM_BATCH, SSM_PROMPT, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(DEVICE)}
    cap = SSM_PROMPT + cfg.n_meta_tokens + SSM_DECODE
    n_attn = cfg.n_layers if cfg.has_attention else 0

    # -- the main path: prefill, then greedy decode --------------------------
    kops.reset_kernel_launches()
    with record_lm_kernels(check=True) as calls, \
            refuse_plain_on_card(PLAIN_LM, f"{arch}'s prefill"):
        cache, logits = lm.prefill(cfg, params, batch, cap)
        torch.cuda.synchronize()
    got = lm_counts()
    want = dict(launches={"ragged_gemm": 0, "flash_attention": n_attn,
                          "flash_attention_bwd": 0},
                flash_instances={"wgmma": n_attn, "f32": 0})
    if got != want or any(c["meta_len"] != cfg.n_meta_tokens for c in calls):
        raise AssertionError(f"{arch} prefill launched {got}, want {want}; "
                             f"meta_len {[c['meta_len'] for c in calls]}")
    if tuple(logits.shape) != (SSM_BATCH, 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill logits malformed")
    checks = [{k: v for k, v in c.items() if k != "inputs"} for c in calls]
    del calls
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    generated = [tok]
    kops.reset_kernel_launches()
    t0 = time.perf_counter()
    for _ in range(SSM_DECODE):
        logits, cache = lm.decode_step(cfg, params, cache, tok)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if any(kops.kernel_launches().values()) or \
            not bool(torch.isfinite(logits).all()) or \
            int(cache["pos"][0]) != SSM_PROMPT + cfg.n_meta_tokens + \
            SSM_DECODE:
        raise AssertionError(f"{arch} decode malformed: launches "
                             f"{kops.kernel_launches()}, pos "
                             f"{int(cache['pos'][0])}")
    worst = max((c["err_over_max"] for c in checks), default=0.0)
    worst_row = max((c["row_err_over_row_max"] for c in checks), default=0.0)
    log(f"{arch} serving: prefill launched {got}; {len(checks)} flash "
        f"launches held against the plain version (worst max|diff| / "
        f"max|plain| {worst:.3e}) and the fp32 oracle by row ({worst_row:.3e},"
        f" tolerance {LM_TOL}); {SSM_DECODE} greedy decode steps, request 0 "
        f"{torch.cat(generated, 1)[0, :8].tolist()}...")
    del cache

    # -- serving times, busy share, the SSD's share --------------------------
    serve = serve_times(arch, cfg, params, batch, cap, tok,
                        decode_s / SSM_DECODE)
    serve["ssd"] = share = ssd_profile(
        lambda: lm.prefill(cfg, params, batch, cap))
    log(f"{arch}: the SSD {fmt_ms(share['ssd_ms'])} of "
        f"{share['device_ms']:.2f} device ms of a traced prefill (share "
        f"{share['ssd_share']})")

    # -- the SSD oracle on layer 0's real inputs, fp32 -----------------------
    first: list = []
    with ssd_capture(lambda a: first.append(a) if not first else None):
        lm.prefill(cfg, params, batch, cap)
    x, dt, a, b_in, c_in, _, chunk = first[0]
    del first
    y, st = M.ssd_chunked(x.float(), dt, a, b_in.float(), c_in.float(),
                          chunk=chunk)
    y_ref, st_ref = M.ssd_reference(x.float(), dt, a, b_in.float(),
                                    c_in.float())
    ssd_err = float((y - y_ref).abs().max()) / float(y_ref.abs().max())
    st_err = float((st - st_ref).abs().max()) / float(st_ref.abs().max())
    if not ssd_err <= SSD_TOL or not st_err <= SSD_TOL:
        raise AssertionError(f"{arch} ssd_chunked against ssd_reference on "
                             f"layer 0's inputs {tuple(x.shape)}: {ssd_err:.3e}"
                             f" (y), {st_err:.3e} (state) > {SSD_TOL}")
    del x, dt, a, b_in, c_in, y, st, y_ref, st_ref

    # -- chunked against recurrent, fp32, full width -------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    full, _ = synthetic_lm_batch(1, SSM_PROMPT + SSM_RECUR, cfg.vocab, step=1)
    full = torch.from_numpy(full).to(DEVICE)
    cap32 = SSM_PROMPT + SSM_RECUR + cfg.n_meta_tokens
    cache, _ = lm.prefill(cfg32, p32, {"tokens": full[:, :SSM_PROMPT]}, cap32)
    for i in range(SSM_PROMPT, SSM_PROMPT + SSM_RECUR):
        dec_logits, cache = lm.decode_step(cfg32, p32, cache, full[:, i:i + 1])
    _, pre_logits = lm.prefill(cfg32, p32, {"tokens": full}, cap32)
    recur_err = float((dec_logits - pre_logits).abs().max()) / float(
        pre_logits.abs().max())
    if not recur_err <= SSM_RECUR_TOL:
        raise AssertionError(f"{arch}: {SSM_RECUR} decode steps after a "
                             f"{SSM_PROMPT}-token prefill against a "
                             f"{SSM_PROMPT + SSM_RECUR}-token prefill, fp32: "
                             f"{recur_err:.3e} > {SSM_RECUR_TOL}")
    log(f"{arch}: ssd_chunked against ssd_reference on layer 0's inputs "
        f"(fp32, chunk {chunk}): {ssd_err:.3e} (y), {st_err:.3e} (final "
        f"state) of the largest (tolerance {SSD_TOL}); fp32 prefill of "
        f"{SSM_PROMPT} + {SSM_RECUR} decode steps against a prefill of "
        f"{SSM_PROMPT + SSM_RECUR}: last logits {recur_err:.3e} of the "
        f"largest (tolerance {SSM_RECUR_TOL})")
    del p32, cache
    torch.cuda.empty_cache()
    return dict(params=n, layers=cfg.n_layers, launches=got, checks=checks,
                worst_err_over_max=worst, worst_row=worst_row,
                max_abs_err=max((c["max_abs_err"] for c in checks),
                                default=0.0),
                serve=serve, ssd_err=ssd_err, ssd_state_err=st_err,
                recur_err=recur_err)


def ssm_train_case(arch: str) -> dict:
    """Phase 14 (c): ``arch`` at full width cut to SSM_TRAIN_LAYERS layers
    (hymba with ``global_layers=(0,)``: its (0, 15, 31) index past 4
    layers, so one global layer and three SWA layers, with the meta
    tokens) through :func:`train_checks`, B SSM_TRAIN_BATCH x
    SSM_TRAIN_SEQ tokens: hymba's step 0 launches 2 flash forwards a layer
    (remat "full" recomputes them) and a ``wgmma`` backward a layer, all
    with the sinks; mamba2's none."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch
    full = get_config(arch)
    kw = dict(n_layers=SSM_TRAIN_LAYERS)
    if full.hybrid:
        kw["global_layers"] = (0,)
    cfg = dataclasses.replace(full, **kw)
    n = cfg.param_count()
    cut = (f"{arch} at full width, {SSM_TRAIN_LAYERS} of {full.n_layers} "
           f"layers{' (global layers (0,))' if full.hybrid else ''}, remat "
           f"{cfg.remat!r}: {n / 1e6:.1f} M parameters; each further layer "
           f"repeats the same launches in a phase the script's time limit "
           f"bounds")
    log(f"cut: {cut}")
    toks, tgts = synthetic_lm_batch(SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(DEVICE),
             "targets": torch.from_numpy(tgts).to(DEVICE)}
    n_attn = SSM_TRAIN_LAYERS if cfg.has_attention else 0
    want = dict(launches={"ragged_gemm": 0, "flash_attention": 2 * n_attn,
                          "flash_attention_bwd": n_attn},
                ragged_directions={"forward": 0, "backward": 0},
                ragged_instances={"wgmma": 0, "wmma": 0, "f32": 0},
                bwd_instances={"wgmma": n_attn, "wmma": 0, "f32": 0})
    res = train_checks(arch, cfg, batch, SSM_TRAIN_STEPS, want)
    del res["inputs"]
    metas = {c.get("meta_len") for c in res["checks"]}
    if cfg.has_attention and metas != {cfg.n_meta_tokens}:
        raise AssertionError(f"{arch} train: flash launches with meta_len "
                             f"{metas}, want {cfg.n_meta_tokens}")
    res.update(cut=cut, layers=SSM_TRAIN_LAYERS, batch=SSM_TRAIN_BATCH,
               seq=SSM_TRAIN_SEQ)
    return res


def ssm_phase() -> dict:
    """Phase 14: mamba2-1.3b and hymba-1.5b served at full width and depth
    (:func:`ssm_serve_case`), hymba's sink attention as a kernel case
    (:func:`attention_case`), both trained at full width cut in depth
    (:func:`ssm_train_case`), and their smoke configs in fp32 on the card
    against the port's CPU run (prefill + decode, train steps)."""
    import torch
    t_phase = time.perf_counter()
    out: dict = {"serve": {}, "train": {}, "smoke": {}}
    for arch in SSM_ARCHS:
        out["serve"][arch] = ssm_serve_case(arch)
        torch.cuda.empty_cache()
    sink = attention_case(SINK_ATTN, 11, ("delta", "dkdv_wgmma", "dq_wgmma"))
    for c in (sink["forward"], sink["backward"]):
        log(f"  hymba sinks {c['name']:20s} {c['shape']:40s} ms "
            f"{c['ms']:.4f} device {fmt_ms(c['device_ms'])} plain "
            f"{c['plain_ms']:.4f} bound {c['bound_ms']:.4f} "
            f"({c['bound_by']}) SDPA with the mask "
            f"{fmt_ms(c['library_ms'])}; max|diff| / max|plain| "
            f"{c['err_over_max']:.2e}, row {c['row_err_over_row_max']:.2e} "
            f"(tolerance {LM_TOL}); two launches bitwise equal")
    out["sink_attention"] = sink
    torch.cuda.empty_cache()
    for arch in SSM_ARCHS:
        out["train"][arch] = ssm_train_case(arch)
        torch.cuda.empty_cache()
    for arch in SSM_ARCHS:
        serve = lm_smoke_check(arch)
        train = lm_train_smoke_check(arch)
        out["smoke"][arch] = dict(serve_max_abs_diff=serve, train=train)
        log(f"{arch} smoke config fp32, card vs CPU: prefill + "
            f"{LM_SMOKE_DECODE} decode steps max |logit diff| "
            f"{max(serve):.3e} (atol {LM_SMOKE_ATOL}); {LM_TRAIN_SMOKE_STEPS}"
            f" train steps' losses {train['losses']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 15: the audio (hubert) and vlm (internvl2) front ends on the card
# ---------------------------------------------------------------------------

HUBERT_ARCH, VLM_ARCH = "hubert-xlarge", "internvl2-2b"
# 4 clips of 4,096 frames: the reference's own train_4k length
HUBERT_BATCH, HUBERT_FRAMES = 4, 4096
VLM_BATCH, VLM_TEXT, VLM_DECODE = 4, 2048, 32   # after 1,024 image positions
VLM_RECUR = 8           # decode steps held against a prefill that long
VLM_RECUR_TOL = 1e-3    # fp32: max|decoded - prefilled last logits| over
                        # max|prefilled|, decode attention against the flash
                        # path, fp32 sums in another order through 24 layers
FRONT_TRAIN_STEPS = 4   # step 0 and 3 more on one batch: the loss must fall
# hubert-xlarge's attention: 16 / 16 heads of 80, no causal mask
HUBERT_ATTN = dict(b=4, hq=16, hkv=16, s=4096, t=4096, d=80, causal=False)


def frontend_batch(cfg, batch_size: int, seq_len: int, seed: int,
                   device=None) -> dict:
    """A batch with ``train/lm.shaped_batch``'s keys, shapes and dtypes:
    ``frames`` / ``image_emb`` drawn seeded-normal on ``device``, tokens
    and their next-token targets from ``data/tokens``; hubert's targets
    are cluster ids drawn uniformly (seeded)."""
    import torch
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.train import lm as TL
    device = DEVICE if device is None else device
    specs = TL.shaped_batch(cfg, batch_size, seq_len)
    out = {}
    if "tokens" in specs:
        toks, tgts = synthetic_lm_batch(batch_size, specs["tokens"].shape[1],
                                        cfg.vocab, step=seed)
        out["tokens"] = torch.from_numpy(toks).to(device)
        out["targets"] = torch.from_numpy(tgts).to(device)
    else:
        out["targets"] = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, tuple(specs["targets"].shape)).astype(np.int32)
        ).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for key in ("frames", "image_emb"):
        if key in specs:
            out[key] = torch.randn(tuple(specs[key].shape), generator=gen,
                                   device=device).to(specs[key].dtype)
    return out


def lm_counts() -> dict:
    """The LM kernels' launches since the last reset, and the flash
    forward's by instance."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    return dict(launches={k: kops.kernel_launches()[k]
                          for k in LM_TRAIN_KERNELS},
                flash_instances=dict(flash_attention_cuda.launches_by_instance))


def checked_main_path(tag: str, fn, n_attn: int, causal: bool, d: int):
    """``fn()`` (an encoder forward or a prefill) with the launch counts
    zeroed just before and read just after: ``n_attn`` flash launches,
    all on the ``wgmma`` instance at head dim ``d`` with ``causal``, each
    held against its plain version and, row by row, the fp32 oracle
    (:func:`record_lm_kernels`), no plain flash version on a card tensor.
    -> (fn's result, counts, the checks without their inputs)."""
    import torch
    from repro_torch.kernels import ops as kops
    kops.reset_kernel_launches()
    with torch.no_grad(), record_lm_kernels(check=True) as calls, \
            refuse_plain_on_card(PLAIN_LM, f"{tag}'s main path"):
        res = fn()
        torch.cuda.synchronize()
    got = lm_counts()
    want = dict(launches={"ragged_gemm": 0, "flash_attention": n_attn,
                          "flash_attention_bwd": 0},
                flash_instances={"wgmma": n_attn, "f32": 0})
    how = {(c["causal"], c["inputs"][0].shape[-1]) for c in calls}
    if got != want or how != {(causal, d)}:
        raise AssertionError(f"{tag} launched {got}, want {want}; (causal, "
                             f"head dim) {how}, want {(causal, d)}")
    checks = [{k: v for k, v in c.items() if k != "inputs"} for c in calls]
    return res, got, checks


def worst_of(checks: list) -> dict:
    return dict(worst_err_over_max=max(c["err_over_max"] for c in checks),
                worst_row=max(c["row_err_over_row_max"] for c in checks),
                max_abs_err=max(c["max_abs_err"] for c in checks))


def hubert_encode_case() -> dict:
    """Phase 15 (a): hubert-xlarge whole, an encoder forward over
    HUBERT_BATCH clips of HUBERT_FRAMES seeded-normal frames, then the
    cluster logits; 48 non-causal flash launches at D 80, each checked;
    the time, frames/s, peak memory and busy share."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.lm import transformer as TT
    cfg = get_config(HUBERT_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
    torch.cuda.synchronize()
    n = cfg.param_count()
    log(f"{HUBERT_ARCH}: {n / 1e9:.3f} B parameters ({2 * n / 1e9:.2f} GB "
        f"bf16, all {cfg.n_layers} layers) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    frames = {"frames": frontend_batch(cfg, HUBERT_BATCH, HUBERT_FRAMES,
                                       seed=21)["frames"]}

    def encode():
        with torch.no_grad():
            h, _ = lm.forward_hidden(cfg, params, frames)
            return TT._unembed(cfg, params, h)
    logits, got, checks = checked_main_path(HUBERT_ARCH, encode, cfg.n_layers,
                                            False, cfg.head_dim)
    if tuple(logits.shape) != (HUBERT_BATCH, HUBERT_FRAMES,
                               cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{HUBERT_ARCH} logits malformed: "
                             f"{tuple(logits.shape)}")
    del logits
    worst = worst_of(checks)
    log(f"{HUBERT_ARCH} encoder: launched {got}; {len(checks)} flash "
        f"launches (non-causal, D {cfg.head_dim}) held against the plain "
        f"version (worst max|diff| / max|plain| "
        f"{worst['worst_err_over_max']:.3e}) and the fp32 oracle by row "
        f"({worst['worst_row']:.3e}, tolerance {LM_TOL}); logits finite")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(encode, reps=3, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = step_profile(encode)
    frames_s = HUBERT_BATCH * HUBERT_FRAMES / ms * 1e3
    log(f"{HUBERT_ARCH} encoder: {ms:.2f} ms for {HUBERT_BATCH} x "
        f"{HUBERT_FRAMES} frames ({frames_s:.0f} frames/s), peak "
        f"{peak_gb:.2f} GB, busy {prof['busy_share']:.3f} in a traced call")
    log(f"  top encoder kernels (ms) {prof['top']}")
    del params
    torch.cuda.empty_cache()
    return dict(params=n, layers=cfg.n_layers, launches=got, checks=checks,
                ms=ms, frames_s=frames_s, peak_gb=peak_gb, profile=prof,
                **worst)


def vlm_serve_case() -> dict:
    """Phase 15 (b): internvl2-2b whole, VLM_BATCH prompts of 1,024 image
    embeddings + VLM_TEXT tokens, ``prefill`` into a cache of the prompt
    + VLM_DECODE slots, VLM_DECODE greedy ``decode_step``s; the prefill's
    24 causal flash launches at D 128 checked as in (a); prefill and
    decode times, tokens/s, busy share, peak memory; in fp32 at one
    prompt, a prefill and VLM_RECUR decode steps of the prompt's next
    tokens against a prefill VLM_RECUR longer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import tree_map
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
    torch.cuda.synchronize()
    n = cfg.param_count()
    log(f"{VLM_ARCH}: {n / 1e9:.3f} B parameters ({2 * n / 1e9:.2f} GB bf16, "
        f"all {cfg.n_layers} layers) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    s = cfg.n_prefix_tokens + VLM_TEXT
    batch = frontend_batch(cfg, VLM_BATCH, s, seed=22)
    prompt = {k: batch[k] for k in ("tokens", "image_emb")}
    cap = s + VLM_DECODE

    def pre():
        return lm.prefill(cfg, params, prompt, cap)
    (cache, logits), got, checks = checked_main_path(
        VLM_ARCH, pre, cfg.n_layers, True, cfg.head_dim)
    if tuple(logits.shape) != (VLM_BATCH, 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()) or \
            int(cache["pos"][0]) != s:
        raise AssertionError(f"{VLM_ARCH} prefill malformed")
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    generated = [tok]
    kops.reset_kernel_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(VLM_DECODE):
            logits, cache = lm.decode_step(cfg, params, cache, tok)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if any(kops.kernel_launches().values()) or \
            not bool(torch.isfinite(logits).all()) or \
            int(cache["pos"][0]) != s + VLM_DECODE:
        raise AssertionError(f"{VLM_ARCH} decode malformed: launches "
                             f"{kops.kernel_launches()}, pos "
                             f"{int(cache['pos'][0])}")
    worst = worst_of(checks)
    log(f"{VLM_ARCH} serving: prefill launched {got}; {len(checks)} flash "
        f"launches (causal over the image prefix and the text) held "
        f"against the plain version (worst {worst['worst_err_over_max']:.3e}"
        f") and the fp32 oracle by row ({worst['worst_row']:.3e}, tolerance "
        f"{LM_TOL}); {VLM_DECODE} greedy decode steps, request 0 "
        f"{torch.cat(generated, 1)[0, :8].tolist()}...")
    del cache

    with torch.no_grad():
        serve = serve_times(VLM_ARCH, cfg, params, prompt, cap, tok,
                            decode_s / VLM_DECODE)

    # -- prefill + decode against a longer prefill, fp32, full width ---------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    full = frontend_batch(cfg32, 1, s + VLM_RECUR, seed=23)
    cap32 = s + VLM_RECUR
    with torch.no_grad():
        cache, _ = lm.prefill(cfg32, p32, {
            "tokens": full["tokens"][:, :VLM_TEXT],
            "image_emb": full["image_emb"]}, cap32)
        for i in range(VLM_TEXT, VLM_TEXT + VLM_RECUR):
            dec_logits, cache = lm.decode_step(cfg32, p32, cache,
                                               full["tokens"][:, i:i + 1])
        _, pre_logits = lm.prefill(cfg32, p32, {
            "tokens": full["tokens"], "image_emb": full["image_emb"]}, cap32)
    recur_err = float((dec_logits - pre_logits).abs().max()) / float(
        pre_logits.abs().max())
    if not recur_err <= VLM_RECUR_TOL:
        raise AssertionError(f"{VLM_ARCH}: {VLM_RECUR} decode steps after a "
                             f"{s}-position prefill against a "
                             f"{s + VLM_RECUR}-position prefill, fp32: "
                             f"{recur_err:.3e} > {VLM_RECUR_TOL}")
    log(f"{VLM_ARCH}: fp32 prefill of {s} positions ({cfg.n_prefix_tokens} "
        f"image + {VLM_TEXT} text) + {VLM_RECUR} decode steps against a "
        f"prefill of {s + VLM_RECUR}: last logits {recur_err:.3e} of the "
        f"largest (tolerance {VLM_RECUR_TOL})")
    del p32, cache
    torch.cuda.empty_cache()
    return dict(params=n, layers=cfg.n_layers, launches=got, checks=checks,
                serve=serve, recur_err=recur_err, **worst)


def front_train_case(arch: str) -> dict:
    """Phase 15 (d): ``arch`` whole (full width and depth) through
    :func:`train_checks`: hubert on HUBERT_BATCH x HUBERT_FRAMES frames
    with cluster targets, internvl2 on VLM_BATCH x (1,024 image +
    VLM_TEXT text) positions (the loss reads the text). Step 0 launches 2
    flash forwards a layer (remat "full" recomputes them) and a ``wgmma``
    backward a layer, hubert's without the causal mask, and no ragged
    GEMM."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    seq = HUBERT_FRAMES if cfg.family == "audio" \
        else cfg.n_prefix_tokens + VLM_TEXT
    bsz = HUBERT_BATCH if cfg.family == "audio" else VLM_BATCH
    batch = frontend_batch(cfg, bsz, seq, seed=24)
    n = cfg.param_count()
    log(f"{arch} train: whole, {cfg.n_layers} layers, remat {cfg.remat!r}: "
        f"bf16 params and grads {2 * n / 1e9:.2f} GB each, fp32 moments "
        f"{8 * n / 1e9:.2f} GB; batch {bsz} x {seq} positions "
        f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
    layers = cfg.n_layers
    want = dict(launches={"ragged_gemm": 0, "flash_attention": 2 * layers,
                          "flash_attention_bwd": layers},
                ragged_directions={"forward": 0, "backward": 0},
                ragged_instances={"wgmma": 0, "wmma": 0, "f32": 0},
                bwd_instances={"wgmma": layers, "wmma": 0, "f32": 0})
    res = train_checks(arch, cfg, batch, FRONT_TRAIN_STEPS, want)
    del res["inputs"]
    causal = {c.get("causal") for c in res["checks"]
              if c["name"].startswith("flash")}
    if causal != {cfg.causal}:
        raise AssertionError(f"{arch} train: flash launches with causal "
                             f"{causal}, want {cfg.causal}")
    res.update(layers=layers, batch=bsz, seq=seq)
    return res


def frontend_smoke_check(arch: str) -> dict:
    """Phase 15 (e): ``arch``'s smoke config in fp32 (the kernels' fp32
    instances) on the card against the port's CPU run from the same
    weights and batch: hubert's forward (its cluster logits), internvl2's
    prefill of an image prefix and tokens + LM_SMOKE_DECODE decode steps,
    within LM_SMOKE_ATOL; then LM_TRAIN_SMOKE_STEPS train steps
    (:func:`lm_train_smoke_check`)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.lm import transformer as TT
    cfg = get_smoke_config(arch)
    batch = frontend_batch(cfg, 2, 80, seed=25, device="cpu")
    if cfg.family != "audio":
        errs = lm_smoke_check(arch, prompt={
            k: batch[k] for k in ("tokens", "image_emb")})
    else:
        p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        p_card = tree_to(p_cpu, DEVICE)
        with torch.no_grad():
            h_card, _ = lm.forward_hidden(cfg, p_card, tree_to(batch, DEVICE))
            h_cpu, _ = lm.forward_hidden(cfg, p_cpu, batch)
        errs = [float((TT._unembed(cfg, p_card, h_card).cpu()
                       - TT._unembed(cfg, p_cpu, h_cpu)).abs().max())]
        if not errs[0] <= LM_SMOKE_ATOL:
            raise AssertionError(f"{arch} fp32 smoke logits, card vs CPU: "
                                 f"{errs} (atol {LM_SMOKE_ATOL})")
    train = lm_train_smoke_check(arch, make_batch=lambda c, i: frontend_batch(
        c, 2, 80, seed=30 + i, device="cpu"))
    return dict(serve_max_abs_diff=errs, train=train)


def frontends_phase() -> dict:
    """Phase 15: hubert-xlarge's encoder and internvl2-2b's serving whole
    at full width (:func:`hubert_encode_case`, :func:`vlm_serve_case`),
    hubert's attention as a kernel case (:func:`attention_case`),
    both trained whole (:func:`front_train_case`), and their smoke
    configs in fp32 on the card against the port's CPU run
    (:func:`frontend_smoke_check`)."""
    import torch
    t_phase = time.perf_counter()
    out: dict = {"serve": {}, "train": {}, "smoke": {}}
    marks = [("start", t_phase)]
    out["serve"][HUBERT_ARCH] = hubert_encode_case()
    torch.cuda.empty_cache()
    marks.append(("(a)", time.perf_counter()))
    out["serve"][VLM_ARCH] = vlm_serve_case()
    torch.cuda.empty_cache()
    marks.append(("(b)", time.perf_counter()))
    attn = attention_case(HUBERT_ATTN, 13, ("delta", "dkdv_wgmma",
                                            "dq_wgmma"))
    for c in (attn["forward"], attn["backward"]):
        log(f"  hubert D 80 {c['name']:20s} {c['shape']:44s} ms "
            f"{c['ms']:.4f} device {fmt_ms(c['device_ms'])} plain "
            f"{c['plain_ms']:.4f} bound {c['bound_ms']:.4f} "
            f"({c['bound_by']}) SDPA {fmt_ms(c['library_ms'])}; "
            f"max|diff| / max|plain| {c['err_over_max']:.2e}, row "
            f"{c['row_err_over_row_max']:.2e} (tolerance {LM_TOL}); two "
            f"launches bitwise equal")
    log(f"  hubert D 80 backward by kernel (device ms) "
        f"{attn['backward']['kernel_device_ms']}, seven-product bound "
        f"{attn['backward']['bound_7_ms']:.4f} ms")
    out["attention"] = attn
    torch.cuda.empty_cache()
    marks.append(("(c)", time.perf_counter()))
    for arch in (HUBERT_ARCH, VLM_ARCH):
        out["train"][arch] = front_train_case(arch)
        torch.cuda.empty_cache()
        marks.append((f"(d) {arch}", time.perf_counter()))
    for arch in (HUBERT_ARCH, VLM_ARCH):
        out["smoke"][arch] = frontend_smoke_check(arch)
        sm = out["smoke"][arch]
        log(f"{arch} smoke config fp32, card vs CPU: max |logit diff| "
            f"{max(sm['serve_max_abs_diff']):.3e} (atol {LM_SMOKE_ATOL}); "
            f"{LM_TRAIN_SMOKE_STEPS} train steps' losses "
            f"{sm['train']['losses']}")
    marks.append(("(e)", time.perf_counter()))
    out["seconds_by_case"] = {tag: t - marks[i][1]
                              for i, (tag, t) in enumerate(marks[1:])}
    log(f"front-ends phase by case (s): "
        f"{ {k: round(v, 1) for k, v in out['seconds_by_case'].items()} }")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 16: data parallelism on the one card (two ranks through gloo)
# ---------------------------------------------------------------------------

DP_RANKS = 2            # two ranks on cuda:0: NCCL refuses them, gloo stages
DP_SEEDS = 2 * MB_BATCH * 37 + 1   # 75,777 seeds: 38 and 37 batches a shard
DP_NAN = (5, 1)         # nan_grad_at: step 5, on rank 1's shard
DP_TIMED = 10           # steps a timing of (a) takes the median of
DP_TIMEOUT_S = 720.0    # the rank helper's join limit for the two ranks
                        # (phase 16, then phase 18 in the same ranks)
QWEN_ARCH, QWEN_LAYERS = "qwen2-1.5b", 4   # of 28: see dp_phase's cut
QWEN_BATCH, QWEN_SEQ = 4, 2048             # the global batch, 2 a rank
QWEN_MORE_STEPS = 3


def dp_spec() -> dict:
    """Phase 16's sizes, handed to the ranks (a spawned rank imports this
    script afresh: it sees the module's constants, not the parent's)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    full = get_config(QWEN_ARCH)
    return dict(arch=ARCH, hidden=HIDDEN, fanouts=FANOUTS, batch=MB_BATCH,
                seeds=DP_SEEDS, nan=DP_NAN, lr=TRAIN_LR, wd=TRAIN_WD,
                infer_batch=MB_INFER_BATCH, timed=DP_TIMED,
                lm_cfg=dc.replace(full, n_layers=QWEN_LAYERS),
                lm_full_layers=full.n_layers, lm_batch=QWEN_BATCH,
                lm_seq=QWEN_SEQ, lm_more=QWEN_MORE_STEPS, **tp_spec())


def pack_dataset(ds) -> tuple:
    """A ``GraphDataset`` as numpy arrays and plain values (its dataclass
    fields, nested), which pickle as bytes (CPU tensors would pickle
    through shared memory)."""
    import torch
    if dataclasses.is_dataclass(ds):
        return (type(ds), {f.name: pack_dataset(getattr(ds, f.name))
                           for f in dataclasses.fields(ds)})
    return ("tensor", ds.numpy()) if isinstance(ds, torch.Tensor) else ds


def unpack_dataset(packed):
    import torch
    if isinstance(packed, tuple) and len(packed) == 2:
        kind, body = packed
        if kind == "tensor":
            return torch.from_numpy(body)
        if isinstance(kind, type) and dataclasses.is_dataclass(kind):
            return kind(**{k: unpack_dataset(v) for k, v in body.items()})
    return packed


def dp_bitwise(a, b) -> bool:
    """Every leaf of two trees (nested dicts of 2- and 4-byte tensors)
    equal bit for bit (unlike ``torch.equal``, -0.0 is not 0.0)."""
    import torch
    from repro_torch.optim.optimizer import tree_leaves

    def bits(x):
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def within_quantum(got, mean, amaxes) -> float:
    """The worst leaf's max |int8 wire - fp32 mean| over its shared
    quantum (amax / 127, amax the larger of the ranks' absmax); raises
    past 1."""
    from repro_torch.optim.optimizer import tree_leaves
    worst = 0.0
    for g, m, a in zip(tree_leaves(got), tree_leaves(mean), amaxes):
        q = max(float(a) / 127, 1e-30)
        worst = max(worst, float((g.float() - m.float()).abs().max()) / q)
    if not worst <= 1.0:
        raise AssertionError(f"the int8 wire is off the fp32 mean by "
                             f"{worst:.3f} shared quanta")
    return worst


def moved_bytes(tree, wire: str) -> int:
    """Bytes a rank hands ``all_reduce`` in one ``sync_grads`` of
    ``tree``: each leaf in its own dtype (fp32 wire), or as int32 plus one
    fp32 absmax a leaf (int8 wire: the sum runs in int32)."""
    from repro_torch.optim.optimizer import tree_leaves
    leaves = tree_leaves(tree)
    if wire == "int8":
        return sum(4 * x.numel() for x in leaves) + 4 * len(leaves)
    return sum(x.numel() * x.element_size() for x in leaves)


@contextlib.contextmanager
def timed_syncs(module):
    """While on, ``module.sync_grads`` (the step's gradient sync) is timed
    on the host clock between two device synchronisations, and its
    outputs are kept: ``rec`` lists ``(ms, synced tree)``."""
    import torch
    real = module.sync_grads
    rec: list = []

    def timed(tree, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(tree, *args, **kw)
        torch.cuda.synchronize()
        rec.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    module.sync_grads = timed
    try:
        yield rec
    finally:
        module.sync_grads = real


@contextlib.contextmanager
def record_trainer_steps():
    """While on, the device-sampled steps ``train_gnn_minibatch`` builds
    keep each step's loss tensor (read once the run is over) under
    ``"losses"``, and the trainer's ``DeviceSampler`` is kept under
    ``"sampler"``."""
    from repro_torch.train import gnn_minibatch as mb
    make = mb.make_device_minibatch_step
    rec: dict = dict(losses=[], sampler=None)

    def make_recording(apply_blocks, opt, dev_sampler, **kw):
        step = make(apply_blocks, opt, dev_sampler, **kw)
        rec["sampler"] = dev_sampler

        def recording(*a, **k):
            res = step(*a, **k)
            rec["losses"].append(res[2].detach().clone())
            return res
        return recording

    mb.make_device_minibatch_step = make_recording
    try:
        yield rec
    finally:
        mb.make_device_minibatch_step = make


def dp_gnn_setup(spec, ds, device, sampler=None, caps=None) -> dict:
    """(a)'s step at phase 8's cell: ``sampler`` (the trainer's), or a
    device sampler with the trainer's capacities ``caps`` and ELL pinned
    on both layers, seeded params, and the first batch of epoch 0 of each
    of the two shards."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.optim import adamw
    from repro_torch.sampling import (DeviceSampler, device_graph_from_csr,
                                      seed_batches)
    from repro_torch.train.gnn_minibatch import make_block_model
    if sampler is None:
        sampler = DeviceSampler(
            device_graph_from_csr(sp.csr_from_coo(ds.coo), device=device),
            spec["fanouts"], batch_size=spec["batch"], seed=0, base=128,
            src_caps=None if caps is None else list(caps))
        sampler.set_plans([KernelPlan(kind="ell")] * len(spec["fanouts"]))
    init, _, apply, _ = make_block_model(spec["arch"], ds.num_features,
                                         spec["hidden"], ds.num_classes,
                                         len(spec["fanouts"]))
    params = init(torch.Generator().manual_seed(0), device=device)
    opt = adamw(spec["lr"], weight_decay=spec["wd"])
    train_ids = np.nonzero(ds.train_mask.numpy())[0]
    firsts = [next(iter(seed_batches(train_ids, spec["batch"], seed=0,
                                     epoch=0, num_shards=DP_RANKS,
                                     shard_index=s)))
              for s in range(DP_RANKS)]
    return dict(sampler=sampler, apply=apply, params=params, opt=opt,
                state=opt.init(params),
                seeds=[torch.from_numpy(b[0].astype(np.int32)).to(device)
                       for b in firsts],
                n_real=[b[1] for b in firsts], x=ds.x.to(device),
                y=ds.y.to(device), device=device)


def dp_gnn_step(setup, step, shard: int, rnd: int):
    """One step of ``step`` on shard ``shard``'s batch with round ``rnd``
    (a mesh step adds the rank's shard to it) from the setup's params."""
    from repro_torch.core.patch import patched
    from repro_torch.train.gnn_minibatch import init_step_stats
    with patched(True):
        return step(setup["params"], setup["state"], setup["seeds"][shard],
                    setup["n_real"][shard], rnd, setup["x"], setup["y"],
                    init_step_stats(setup["device"]), step_idx=0)


def dp_lockstep_case(mesh, spec, ds, out_dir) -> dict:
    """(b) and (e): ``train_gnn_minibatch(mesh=)`` on the train seeds cut
    to ``DP_SEEDS``, one epoch with each wire, a NaN on rank 1 at step 5,
    the tracer on (``profile``: a device sync after every step); then this
    rank's trace (pid = its rank) and a JSONL metrics line."""
    import torch
    from repro_torch import obs
    from repro_torch.dist import replicas_equal
    from repro_torch.kernels import ops as kops
    from repro_torch.testing import FaultPlan
    from repro_torch.train.gnn_minibatch import train_gnn_minibatch
    r = mesh.index("data")
    train = np.nonzero(ds.train_mask.numpy())[0][:spec["seeds"]]
    mask = torch.zeros_like(ds.train_mask)
    mask[train] = True
    cut = dataclasses.replace(ds, train_mask=mask)
    obs.reset()
    obs.metrics().reset()
    obs.enable(ops=False)
    runs, launches, sampler = {}, {}, None
    try:
        for wire in ("fp32", "int8"):
            kops.reset_kernel_launches()
            n0 = len(obs.get_tracer().snapshot())
            t0 = time.perf_counter()
            with record_trainer_steps() as rec:
                res = train_gnn_minibatch(
                    spec["arch"], cut, fanouts=spec["fanouts"],
                    batch_size=spec["batch"], hidden=spec["hidden"],
                    epochs=1, lr=spec["lr"], weight_decay=spec["wd"],
                    seed=0, mesh=mesh, grad_sync=wire, sampler="device",
                    infer_batch=spec["infer_batch"],
                    faults=FaultPlan(nan_grad_at=tuple(spec["nan"])),
                    device_caps=(None if not runs else
                                 runs["fp32"]["src_caps"]),
                    profile=True)
            wall = time.perf_counter() - t0
            got = kops.kernel_launches()
            launches = {k: launches.get(k, 0) + v for k, v in got.items()}
            step_ms = [s.dur_ns / 1e6 for s in
                       obs.get_tracer().snapshot()[n0:]
                       if s.name == "train.step"]
            vals = [float(v) for v in rec["losses"]]
            sampler = sampler or rec["sampler"]
            runs[wire] = dict(
                losses=vals, steps=len(step_ms),
                steps_per_epoch=res.steps_per_epoch,
                skipped=res.skipped_steps, src_caps=list(res.src_caps),
                sync_bytes_per_step=res.sync_bytes_per_step,
                moved_bytes_per_step=moved_bytes(res.final_params, wire),
                step_ms_median=float(np.median(step_ms[2:])),
                step_ms=step_ms, test_acc=res.test_acc,
                infer_s=res.infer_time_s, wall_s=wall,
                launches=got,
                replicas_equal=replicas_equal(res.final_params, mesh))
    finally:
        obs.disable()
    trace = Path(out_dir) / f"trace_rank{r}.json"
    obs.write_chrome_trace(str(trace), pid=r)
    obs.metrics_to_jsonl(str(Path(out_dir) / f"metrics_rank{r}.jsonl"),
                         rank=r, phase=16, skipped=runs["fp32"]["skipped"])
    return dict(runs=runs, launches=launches, trace=str(trace),
                sampler=sampler)


def dp_step_case(mesh, spec, ds, sampler) -> dict:
    """(a): one step on the two shards' batches with each wire against
    the 1-rank steps of both batches on this rank, the identical-batch
    step against the 1-rank step, and the timings; ``sampler`` is (b)'s
    trainer's."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import replicas_equal, sync_grads
    from repro_torch.optim import apply_updates
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import gnn_minibatch as mb
    r = mesh.index("data")
    su = dp_gnn_setup(spec, ds, mesh.device, sampler=sampler)
    kw = dict(batch_size=spec["batch"])
    one = mb.make_device_minibatch_step(su["apply"], su["opt"],
                                        su["sampler"], **kw)
    local = [dp_gnn_step(su, one, s, s) for s in range(DP_RANKS)]
    mean = tree_map(lambda a, b: (a + b) / 2, local[0][3], local[1][3])
    amax = [torch.maximum(a.abs().max(), b.abs().max()) for a, b in zip(
        tree_leaves(local[0][3]), tree_leaves(local[1][3]))]
    upd, _ = su["opt"].update(mean, su["state"], su["params"])
    want_p = apply_updates(su["params"], upd)
    steps = {wire: mb.make_device_minibatch_step(
        su["apply"], su["opt"], su["sampler"], mesh=mesh, grad_sync=wire,
        **kw) for wire in ("fp32", "int8")}
    got = dp_gnn_step(su, steps["fp32"], r, 0)     # the rank adds its shard
    same = dp_gnn_step(su, steps["fp32"], 0, -r)   # every rank on shard 0
    got8 = dp_gnn_step(su, steps["int8"], r, 0)
    out = dict(
        synced_is_local_mean=dp_bitwise(got[3], mean),
        params_are_mean_update=dp_bitwise(got[0], want_p),
        loss_is_mean=bool(got[2] == (local[0][2] + local[1][2]) / 2),
        replicas_equal=replicas_equal(got[0], mesh),
        same_is_one_rank=dp_bitwise(same[3], local[0][3])
        and dp_bitwise(same[0], local[0][0])
        and bool(same[2] == local[0][2]),
        int8_quanta=within_quantum(got8[3], mean, amax),
        skipped=[int(s[4].drain()["skipped"]) for s in (got, same, got8)],
        param_elements=sum(x.numel() for x in tree_leaves(su["params"])),
        moved_bytes={w: moved_bytes(mean, w) for w in ("fp32", "int8")})

    def ms_of(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    n = spec["timed"]
    out["sync_ms"] = {w: ms_of(lambda: sync_grads(local[r][3], mesh,
                                                   wire=w), 2 * n)
                      for w in ("fp32", "int8")}
    out["dp_step_ms"] = ms_of(lambda: dp_gnn_step(su, steps["fp32"], r, 0),
                              n)
    out["concurrent_one_rank_step_ms"] = ms_of(
        lambda: dp_gnn_step(su, one, r, r), n)
    dist.barrier()
    if r == 0:              # the other rank waits at the barrier
        out["alone_one_rank_step_ms"] = ms_of(
            lambda: dp_gnn_step(su, one, 0, 0), n)
    dist.barrier()
    return out


def dp_lm_case(mesh, spec) -> dict:
    """(c): ``make_data_parallel_step`` at qwen2-1.5b's full width cut to
    ``QWEN_LAYERS`` layers, the global batch split over the ranks."""
    import torch
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.dist import replicas_equal
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import lm as TL
    cfg, dev = spec["lm_cfg"], mesh.device
    toks, tgts = synthetic_lm_batch(spec["lm_batch"], spec["lm_seq"],
                                    cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "targets": torch.from_numpy(tgts).to(dev)}
    half = spec["lm_batch"] // DP_RANKS
    halves = [{k: v[i * half:(i + 1) * half] for k, v in batch.items()}
              for i in range(DP_RANKS)]

    def fresh(compression):
        step, opt = TL.make_data_parallel_step(cfg, mesh,
                                               compression=compression)
        return step, TL.make_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), opt,
            compression=compression, device=dev)

    step, state = fresh(False)
    if not replicas_equal(state.params, mesh):
        raise AssertionError("qwen2: the ranks' initial params differ")
    local = [TL.loss_and_grads(cfg, state.params, h) for h in halves]
    local_loss = [l[0] for l in local]
    amax = [torch.maximum(a.abs().max(), b.abs().max()).float()
            for a, b in zip(tree_leaves(local[0][2]),
                            tree_leaves(local[1][2]))]
    mean = tree_map(lambda a, b: (a + b) / 2, local[0][2], local[1][2])
    del local
    torch.cuda.synchronize()
    kops.reset_kernel_launches()
    with timed_syncs(TL) as syncs, record_train_kernels(check=True) as calls:
        state, m0 = step(state, batch)
        torch.cuda.synchronize()
    launches = kops.kernel_launches()
    checks = [{k: v for k, v in c.items() if k != "inputs"} for c in calls]
    del calls
    out = dict(launches=launches, checks=checks, sync_ms=[syncs[0][0]],
               synced_is_local_mean=dp_bitwise(syncs[0][1], mean),
               loss_is_mean=bool(m0["loss"] == (local_loss[0].float() +
                                                local_loss[1].float()) / 2),
               losses=[float(m0["loss"])],
               grad_elements=sum(x.numel() for x in tree_leaves(mean)),
               moved_bytes={w: moved_bytes(mean, w)
                            for w in ("fp32", "int8")},
               replicas=[replicas_equal(state.params, mesh)])
    syncs.clear()
    step_ms = []
    with timed_syncs(TL) as syncs:
        for _ in range(spec["lm_more"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(float(m["loss"]))
            out["replicas"].append(replicas_equal(state.params, mesh))
    out["sync_ms"] += [ms for ms, _ in syncs]
    out["step_ms"] = step_ms
    del state, step, syncs
    torch.cuda.empty_cache()
    step8, state8 = fresh(True)
    with timed_syncs(TL) as syncs:
        state8, m8 = step8(state8, batch)
        torch.cuda.synchronize()
    out.update(int8_quanta=within_quantum(syncs[0][1], mean, amax),
               int8_sync_ms=syncs[0][0], int8_loss=float(m8["loss"]),
               int8_replicas=replicas_equal(state8.params, mesh))
    return out


def dp_rank(mesh, spec, dataset_file, out_dir) -> dict:
    """One rank of phase 16 (``dist.run_ranks``' body): (b) and (e), (a),
    then (c), on the dataset the parent wrote to ``dataset_file``
    (:func:`pack_dataset`, pickled); then phase 18 in the same ranks
    (:func:`tp_case`: the rank start is paid once). It loads the kernels
    the parent built and builds none. Returns numbers, lists, flags and
    numpy arrays only (no tensors)."""
    import pickle

    import torch
    from repro_torch.kernels.build import build_kernels
    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = build_kernels()
    if built:
        raise AssertionError(f"rank {mesh.index('data')} built {sorted(built)}"
                             ": the parent builds every kernel first")
    t0 = time.perf_counter()
    with open(dataset_file, "rb") as f:
        ds = unpack_dataset(pickle.load(f))
    out = dict(rank=mesh.index("data"), backend=mesh.backend,
               t_enter=t_enter, load_s=time.perf_counter() - t0,
               device=str(mesh.device), name=torch.cuda.get_device_name(
                   mesh.device) if mesh.device.type == "cuda" else "cpu")
    out["lockstep"] = dp_lockstep_case(mesh, spec, ds, out_dir)
    t1 = time.perf_counter()
    out["step"] = dp_step_case(mesh, spec, ds,
                               out["lockstep"].pop("sampler"))
    out["step_s"] = time.perf_counter() - t1
    del ds
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["lm"] = dp_lm_case(mesh, spec)
    out["lm_s"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["tp"] = tp_case(mesh, spec)           # phase 18
    out["tp_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


def merged_trace(paths) -> dict:
    """The ranks' traces as one: their events concatenated, each rank's
    timestamps shifted onto the earliest rank's epoch."""
    objs = [json.loads(Path(p).read_text()) for p in paths]
    t0 = min(o["otherData"]["epoch_unix_s"] for o in objs)
    events = []
    for o in objs:
        shift = (o["otherData"]["epoch_unix_s"] - t0) * 1e6
        for ev in o["traceEvents"]:
            if "ts" in ev:
                ev = dict(ev, ts=ev["ts"] + shift)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"ranks": [o["otherData"] for o in objs]}}


def nccl_case(spec, ds, caps) -> dict:
    """(d): a one-rank mesh in this process, which has a card of its own
    (so NCCL, by the backend rule), runs (a)'s step (with the device
    capacities ``caps``, or the worst case without them): bitwise the
    no-mesh step."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import choose_backend, init_ranks
    from repro_torch.train import gnn_minibatch as mb
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    store = Path(build) / f"nccl_rendezvous_{time.time_ns()}"
    store.mkdir()
    try:
        mesh = init_ranks(0, 1, store_dir=str(store), device=DEVICE)
        try:
            su = dp_gnn_setup(spec, ds, mesh.device, caps=caps)
            kw = dict(batch_size=spec["batch"])
            plain = dp_gnn_step(su, mb.make_device_minibatch_step(
                su["apply"], su["opt"], su["sampler"], **kw), 0, 0)
            got = dp_gnn_step(su, mb.make_device_minibatch_step(
                su["apply"], su["opt"], su["sampler"], mesh=mesh, **kw), 0, 0)
            res = dict(backend=mesh.backend,
                       grads=dp_bitwise(got[3], plain[3]),
                       params=dp_bitwise(got[0], plain[0]),
                       loss=bool(got[2] == plain[2]))
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    # the rule's pick for one rank with a card of its own: NCCL
    want = choose_backend(DEVICE, 1, torch.cuda.device_count())
    if res != dict(backend=want, grads=True, params=True, loss=True):
        raise AssertionError(f"(d) the one-rank {want} step: {res}")
    return res


def dp_phase(ds, caps=None) -> dict:
    """Phase 16: data parallelism on the one card. Two ranks on cuda:0
    (gloo: NCCL refuses two ranks on one device), started by
    ``dist.run_ranks`` (from a helper thread), run (a)-(c) and (e)
    (:func:`dp_rank`); meanwhile this process runs (d) itself (with
    ``caps``, phase 8's probed capacities), then checks what the ranks
    return against each other and merges and validates their traces.
    Raises on the first failed check."""
    import torch
    from repro_torch import obs
    from repro_torch.dist import run_ranks
    t_phase = time.perf_counter()
    spec = dp_spec()
    cfg = spec["lm_cfg"]
    n = cfg.param_count()
    cut = (f"{QWEN_ARCH} (arXiv:2407.10671) at full width (d_model "
           f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
           f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied), "
           f"{QWEN_LAYERS} of {spec['lm_full_layers']} layers, remat "
           f"{cfg.remat!r}: {n / 1e6:.1f} M parameters a replica, whose "
           f"bf16 gradient ({2 * n / 1e9:.2f} GB) crosses gloo's host "
           f"staging every step; each further layer repeats the same "
           f"launches and adds its gradient to the wire")
    log(f"cut: {cut}")
    out_dir = ROOT / "chiprun_out"
    traces = [out_dir / f"trace_rank{r}.json" for r in range(DP_RANKS)]
    for r in range(DP_RANKS):
        traces[r].unlink(missing_ok=True)
        (out_dir / f"metrics_rank{r}.jsonl").unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    handoff = build / "dp_dataset.pkl"      # a file: both ranks start at once
    with open(handoff, "wb") as f:
        pickle.dump(pack_dataset(ds), f, protocol=5)
    write_s = time.perf_counter() - t0
    t_spawn = time.time()
    box: dict = {}

    def start_ranks():
        try:
            box["ranks"] = run_ranks(dp_rank, DP_RANKS, str(build),
                                     device=DEVICE, timeout_s=DP_TIMEOUT_S,
                                     args=(spec, str(handoff), str(out_dir)))
        except BaseException as exc:        # re-raised below
            box["error"] = exc

    helper = threading.Thread(target=start_ranks, name="dp-ranks")
    helper.start()
    try:
        # (d) a one-rank NCCL mesh in this process, while the ranks run
        t1 = time.perf_counter()
        nccl = nccl_case(spec, ds, caps)
        nccl["seconds"] = time.perf_counter() - t1
        log(f"(d) one-rank mesh on {nccl['backend']}: the step bitwise the "
            f"no-mesh step ({nccl['seconds']:.1f} s, beside the ranks)")
    finally:
        helper.join()
        handoff.unlink(missing_ok=True)
    digests = tp_digests(spec)                # phase 18's, then removed
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    ranks_s = time.perf_counter() - t0
    on = "cuda:0" if DEVICE == "cuda" else DEVICE   # every rank on one card
    for r, got in enumerate(ranks):
        if (got["rank"], got["backend"], got["device"]) != (r, "gloo", on):
            raise AssertionError(f"rank {r}: {got['backend']} on "
                                 f"{got['device']}")

    # (b) lockstep: equal counts, one skip, equal replicas, falling losses
    lock = {}
    for wire in ("fp32", "int8"):
        runs = [got["lockstep"]["runs"][wire] for got in ranks]
        for r, run in enumerate(runs):
            real = run["losses"][:-1]       # the last: shard 1's empty tail
            if not (run["steps"] == run["steps_per_epoch"] == 38 ==
                    len(run["losses"]) and run["skipped"] == 1 and
                    run["replicas_equal"] and np.isfinite(run["losses"]).all()
                    and np.mean(real[-5:]) < np.mean(real[:5])):
                raise AssertionError(f"(b) {wire} rank {r}: steps "
                                     f"{run['steps']} of "
                                     f"{run['steps_per_epoch']}, skipped "
                                     f"{run['skipped']}, replicas "
                                     f"{run['replicas_equal']}, losses "
                                     f"{run['losses']}")
        if runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError(f"(b) {wire}: the ranks' losses differ")
        lock[wire] = {k: v for k, v in runs[0].items() if k != "step_ms"}
        lock[wire]["step_ms_median_by_rank"] = [
            run["step_ms_median"] for run in runs]
        log(f"(b) {wire} wire: {runs[0]['steps']} lockstep steps on both "
            f"ranks ({DP_SEEDS} seeds: 38 and 37 batches, the short shard "
            f"padded), skipped {[run['skipped'] for run in runs]}, replicas "
            f"bitwise equal; loss {runs[0]['losses'][0]:.4f} -> "
            f"{runs[0]['losses'][-2]:.4f}; step ms (median, traced, synced) "
            f"{[round(run['step_ms_median'], 3) for run in runs]}; "
            f"sync_bytes_per_step {runs[0]['sync_bytes_per_step']}, moved "
            f"{runs[0]['moved_bytes_per_step']}; test acc "
            f"{runs[0]['test_acc']:.4f}; inference "
            f"{runs[0]['infer_s']:.1f} s; run {runs[0]['wall_s']:.1f} s")
    launches_gnn = [got["lockstep"]["launches"] for got in ranks]
    for r, la in enumerate(launches_gnn):
        missing = [k for k in ("sample_hop", "ell_spmm", "sell_spmm",
                               "segment_sum") if la[k] <= 0]
        if missing:
            raise AssertionError(f"(b) rank {r} launched no {missing}: {la}")

    # (a) one step, distinct shards and identical batches
    steps = [got["step"] for got in ranks]
    for r, st in enumerate(steps):
        flags = {k: st[k] for k in ("synced_is_local_mean",
                                    "params_are_mean_update", "loss_is_mean",
                                    "replicas_equal", "same_is_one_rank")}
        if not all(flags.values()) or st["skipped"] != [0, 0, 0]:
            raise AssertionError(f"(a) rank {r}: {flags}, skipped "
                                 f"{st['skipped']}")
    a = steps[0]
    log(f"(a) full-width step, fp32 wire: synced gradients and updated "
        f"params bitwise (g_0 + g_1) / 2 and its update on both ranks, "
        f"replicas equal; identical batches bitwise the 1-rank step; int8 "
        f"within {max(s['int8_quanta'] for s in steps):.3f} of a shared "
        f"quantum; sync ms fp32 {[round(s['sync_ms']['fp32'], 3) for s in steps]}"
        f", int8 {[round(s['sync_ms']['int8'], 3) for s in steps]} "
        f"({a['param_elements']} parameters; moved {a['moved_bytes']} bytes a "
        f"rank); step ms 2 ranks {[round(s['dp_step_ms'], 3) for s in steps]},"
        f" 1-rank steps on both at once "
        f"{[round(s['concurrent_one_rank_step_ms'], 3) for s in steps]}, one "
        f"rank alone {a['alone_one_rank_step_ms']:.3f}")

    # (c) the LM step
    lms = [got["lm"] for got in ranks]
    want_lm = {"flash_attention": 2 * QWEN_LAYERS,
               "flash_attention_bwd": QWEN_LAYERS}
    for r, lm in enumerate(lms):
        got_lm = {k: lm["launches"][k] for k in want_lm}
        if not (lm["synced_is_local_mean"] and lm["loss_is_mean"] and
                all(lm["replicas"]) and lm["int8_replicas"] and
                np.isfinite(lm["losses"] + [lm["int8_loss"]]).all() and
                got_lm == want_lm):
            raise AssertionError(f"(c) rank {r}: synced mean "
                                 f"{lm['synced_is_local_mean']}, loss mean "
                                 f"{lm['loss_is_mean']}, replicas "
                                 f"{lm['replicas']}, losses {lm['losses']}, "
                                 f"launches {got_lm} (want {want_lm})")
    if lms[0]["losses"] != lms[1]["losses"]:
        raise AssertionError("(c) the ranks' losses differ")
    worst, worst_abs = {}, {}
    for c in (c for lm in lms for c in lm["checks"]):
        worst[c["name"]] = max(worst.get(c["name"], 0.0), c["err_over_max"])
        worst_abs[c["name"]] = max(worst_abs.get(c["name"], 0.0),
                                   c["max_abs_err"])
    log(f"(c) {QWEN_ARCH} x {QWEN_LAYERS} layers, {QWEN_BATCH} x "
        f"{QWEN_SEQ} tokens (2 a rank): synced gradients bitwise "
        f"(g_0 + g_1) / 2, loss the halves' mean, replicas equal after "
        f"every step; losses {[round(x, 4) for x in lms[0]['losses']]}; "
        f"flash launches a rank {want_lm}, each held against its plain "
        f"version (worst max|diff| / max|plain| {worst}, tolerance "
        f"{LM_TOL}); int8 within {max(lm['int8_quanta'] for lm in lms):.3f} "
        f"of a shared quantum; wire ms fp32 "
        f"{[[round(x, 1) for x in lm['sync_ms']] for lm in lms]}, int8 "
        f"{[round(lm['int8_sync_ms'], 1) for lm in lms]} "
        f"({lms[0]['grad_elements']} gradient elements, moved "
        f"{lms[0]['moved_bytes']} bytes a rank); step ms "
        f"{[[round(x, 1) for x in lm['step_ms']] for lm in lms]}")

    # phase 18, in the same two ranks after (c)
    tp = tp_checks([got["tp"] for got in ranks], spec, *digests)
    tp["rank_s"] = [round(got["tp_s"], 1) for got in ranks]
    tp_log(tp)

    # (e) the two ranks' traces as one
    merged = merged_trace(traces)
    errs = obs.validate_chrome_trace(merged)
    spans = {r: sum(ev["pid"] == r and ev["name"].startswith("train.")
                    for ev in merged["traceEvents"])
             for r in range(DP_RANKS)}
    if errs or not all(spans.values()):
        raise AssertionError(f"(e) merged trace: {errs[:5]}, train.* spans "
                             f"by rank {spans}")
    (out_dir / "trace_ranks.json").write_text(json.dumps(merged))
    log(f"(e) the ranks' traces merged into chiprun_out/trace_ranks.json: "
        f"{len(merged['traceEvents'])} events, no violation, train.* spans "
        f"by rank {spans}")

    launches_dp = {k: sum(g["lockstep"]["launches"].get(k, 0) +
                          g["lm"]["launches"].get(k, 0) for g in ranks)
                   for k in ranks[0]["lm"]["launches"]}
    seconds = time.perf_counter() - t_phase
    split = {k: [round(g[k], 1) for g in ranks]
             for k in ("load_s", "step_s", "lm_s", "tp_s", "seconds")}
    split["start_s"] = [round(g["t_enter"] - t_spawn, 1) for g in ranks]
    split["lockstep_s"] = [round(sum(r["wall_s"] for r in g["lockstep"][
        "runs"].values()), 1) for g in ranks]
    log(f"data-parallel phase: {seconds:.1f} s (dataset file {write_s:.1f} "
        f"s, ranks {ranks_s:.1f} s: {split}); launches in the ranks "
        f"{launches_dp}")
    return dict(cut=cut, ranks=DP_RANKS, backend="gloo", seeds=DP_SEEDS,
                lockstep=lock, step=steps, lm=[
                    {k: v for k, v in lm.items() if k != "checks"}
                    for lm in lms], lm_worst_err_over_max=worst,
                lm_worst_abs_err=worst_abs,
                trace_spans=spans, nccl=nccl, launches_dp=launches_dp,
                ranks_s=ranks_s, split_s=split, seconds=seconds, tp=tp)


# --------------------------------------------------------------------------
# phase 18: tensor and expert parallelism, two model ranks on the one card
# --------------------------------------------------------------------------

TP_RANKS = 2            # one 'model' axis of 2, in phase 16's two ranks
TP_SAMPLES = 4096       # a leaf's seeded sample of entries in the digests
TP_TRAIN_DIGEST = "tp_train_digest.pt"   # phase 12's step 0, under build/
TP_SERVE_DIGEST = "tp_serve_digest.pt"   # phase 10's serving, under build/
TP_MORE_STEPS = 2       # after step 0; replicated leaves checked after each
TP_WIRE_DECODE = 4      # decode steps timed with the wire synced
# The bounds, stated before the first card run (PERF.md §6, PR 31). A split
# product (wo, the MoE's combine, the vocabulary's sums) adds at most one
# bf16 rounding before its sum: 2^-8 of the product. Where that moves a
# router logit across a near-tie of the top-k, the token's experts change
# and with them its whole contribution (the experts' outputs dominate the
# residual: their fan-in rule takes E, not D). So: the loss, a mean over
# every token, within TP_LOSS_TOL of its size; a routing change in the
# first MoE layer only where phase 12's (phase 10's) top-k margin is within
# twice this run's largest router-logit difference there; each leaf's
# gradient (its seeded samples, and its norm) within TP_GRAD_BASE (four
# bf16 ulps) + 2 sqrt(f) in relative L2, f the share of token-layers whose
# experts changed (f N of N token contributions replaced moves a sum of
# random-direction terms by sqrt(2 f) of its norm); each updated param
# within 2 lr (1 + 2^-7) + 2 bf16 ulps of phase 12's (AdamW's first step
# moves an entry by at most lr; the update is rounded to bf16, then the
# sum, either side of a binade at worst); a logit row whose own routing matched in every layer within
# TP_ROW_BASE + 2 f_ctx of its largest (a decode row averages over the
# context, of which f_ctx changed experts somewhere), at most
# TP_FLIPPED_ROWS of the rows with a routing change of their own.
TP_LOSS_TOL = 2.0 ** -8
TP_GRAD_BASE = 2.0 ** -5
TP_ROW_BASE = 2.0 ** -6
TP_FLIPPED_ROWS = 0.25


@contextlib.contextmanager
def record_routing():
    """While on, every ``dispatch.route_topk`` call (one an MoE layer, in
    order; a recomputed layer again) is recorded: its router logits and
    its top-k experts."""
    from repro_torch.core import dispatch as D
    real = D.route_topk
    calls: list = []

    def recorded(logits, k, **kw):
        r = real(logits, k, **kw)
        calls.append((logits.detach().float().clone(),
                      r.expert_idx.detach().clone(), k))
        return r

    D.route_topk = recorded
    try:
        yield calls
    finally:
        D.route_topk = real


def routes_np(calls, n: int, layer0_logits: bool = True) -> dict:
    """The first ``n`` recorded routings as numpy: each token's expert set
    (sorted ids) and its top-k margin (the k-th router logit minus the
    (k+1)-th), and the first call's router logits."""
    import torch
    ids, margins = [], []
    for logits, idx, k in calls[:n]:
        top = torch.topk(logits, k + 1, dim=-1).values
        margins.append((top[:, k - 1] - top[:, k]).cpu().numpy())
        ids.append(torch.sort(idx, -1).values.to(torch.int16).cpu().numpy())
    out = dict(ids=ids, margins=margins)
    if layer0_logits:
        out["logits0"] = calls[0][0].cpu().numpy()
    return out


def leaf_sample(i: int, numel: int) -> np.ndarray:
    """Leaf ``i``'s seeded sample of flat indices (sorted)."""
    rng = np.random.default_rng([18, i])
    return np.sort(rng.choice(numel, min(TP_SAMPLES, numel), replace=False))


def take(t, idx) -> np.ndarray:
    """``t``'s flat entries at ``idx``, in fp32, on the host."""
    import torch
    return t.reshape(-1)[torch.from_numpy(np.asarray(idx)).to(
        t.device)].float().cpu().numpy()


def sum_sq(t) -> float:
    """The sum of ``t``'s squares: fp32 over slices of 2^26 entries,
    summed in fp64 (no whole fp32 copy of an expert leaf)."""
    flat, total = t.reshape(-1), 0.0
    for lo in range(0, flat.numel(), 1 << 26):
        total += float(flat[lo:lo + (1 << 26)].float().square().sum())
    return total


def train_digest(loss, p0, grads, p1, routes, n_layers: int) -> dict:
    """Phase 12's step 0 for phase 18: the loss, each leaf's gradient sum
    of squares, a seeded sample of each leaf's initial and updated params
    and gradient, and the routing of the step's forward."""
    from repro_torch.optim.optimizer import tree_leaves
    leaves = []
    for i, (a, g, b) in enumerate(zip(tree_leaves(p0), tree_leaves(grads),
                                      tree_leaves(p1))):
        idx = leaf_sample(i, a.numel())
        leaves.append(dict(shape=tuple(a.shape), idx=idx, p0=take(a, idx),
                           g=take(g, idx), p1=take(b, idx), g_sq=sum_sq(g)))
    return dict(loss=float(loss), leaves=leaves,
                routes=routes_np(routes, n_layers))


def local_samples(idx, shape, sh) -> tuple:
    """The positions in a leaf's sample that this rank holds, and their
    flat indices into its slice (``sh`` the leaf's sharding)."""
    multi = np.unravel_index(idx, shape)
    lshape = sh.local_shape(shape)
    keep = np.ones(len(idx), bool)
    local = []
    for d in range(len(shape)):
        blk = multi[d] // lshape[d]
        keep &= blk == sh.block(d)
        local.append(multi[d] - blk * lshape[d])
    pos = np.nonzero(keep)[0]
    return pos, np.ravel_multi_index(tuple(m[pos] for m in local), lshape)


def tp_wire_bytes(cfg, b: int, s: int, m: int, what: str) -> int:
    """The bytes a rank hands the backend (the gathered buffers of
    ``dist.collectives``' sums: m x each rank's part) in one train step
    (remat "full"), one prefill or one decode step of the split model at
    (b, s) positions: the embedding's sum, then a layer's two split
    products (``wo``, the MoE's combine) forward; the recompute of a
    layer's backward runs ``wo``'s sum again but not the MoE's, the
    block's last collective (the non-reentrant checkpoint stops its
    recompute once the saved tensors are back, and that sum saves none);
    backward, the ranks' gradients of the head's input, a layer's
    attention input and MoE input (bf16 (b, s, d_model) each), and its
    router logits (fp32 (b s, E)); the cross-entropy's max, sum and
    target logit a chunk (fp32 (b, c)); the global norm's scalar. Serving
    gathers the last position's logits (bf16 vocab)."""
    n = cfg.n_layers
    act = m * b * s * cfg.d_model * 2
    if what == "train":
        recompute = n if cfg.remat == "full" else 0
        return ((1 + 2 * n + recompute + 1 + 2 * n) * act
                + n * m * b * s * cfg.n_experts * 4 + 3 * m * 4 * b * s
                + m * 4)
    return (1 + 2 * n) * act + b * cfg.vocab_padded * 2


def tp_spec() -> dict:
    """Phase 18's sizes for the ranks (phase 16's spawned ranks import this
    script afresh)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    full = get_config(LM_ARCH)
    build = ROOT / "build"
    return dict(tp_train_cfg=dc.replace(full, n_layers=LM_TRAIN_LAYERS),
                tp_serve_cfg=dc.replace(full, n_layers=LM_LAYERS),
                tp_train_digest=str(build / TP_TRAIN_DIGEST),
                tp_serve_digest=str(build / TP_SERVE_DIGEST),
                lm_train_batch=LM_TRAIN_BATCH, lm_train_seq=LM_TRAIN_SEQ,
                serve_batch=LM_BATCH, serve_prompt=LM_PROMPT,
                serve_decode=LM_DECODE, serve_capacity=LM_CAPACITY)


def tp_train_case(tp, spec) -> dict:
    """(a) on one rank: phi3.5-moe x 2 layers split over the 'model' axis
    of ``tp``, seeded as phase 12; step 0 with every launch held against
    its plain version, the rank's samples of its params and gradients,
    the wire's bytes; then TP_MORE_STEPS steps (one with the wire synced),
    the replicated leaves compared across the ranks after each."""
    import torch
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.dist import replicas_equal, reset_wire_stats, wire_stats
    from repro_torch.dist.partition import param_shardings
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import lm as TL
    cfg, dev = spec["tp_train_cfg"], tp.device
    dig = torch.load(spec["tp_train_digest"], weights_only=False)
    step_fn, opt = TL.make_train_step(cfg, mesh=tp)
    t0 = time.perf_counter()
    state = TL.make_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt, mesh=tp)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    like = TL.full_param_shapes(cfg)
    shards = tree_leaves(param_shardings(tp, like))
    shapes = [tuple(t.shape) for t in tree_leaves(like)]
    maps = [local_samples(l["idx"], shp, s)
            for l, shp, s in zip(dig["leaves"], shapes, shards)]
    p0 = [take(p, lidx) for p, (_, lidx) in zip(tree_leaves(state.params),
                                                maps)]
    toks, tgts = synthetic_lm_batch(spec["lm_train_batch"],
                                    spec["lm_train_seq"], cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "targets": torch.from_numpy(tgts).to(dev)}
    got: list = []
    torch.cuda.synchronize()
    kops.reset_kernel_launches()
    reset_wire_stats()
    t0 = time.perf_counter()
    with record_train_kernels(check=True) as calls, \
            record_grads(got.append), record_routing() as routes:
        state, m0 = step_fn(state, batch)
        torch.cuda.synchronize()
    step0_s = time.perf_counter() - t0
    wire0 = wire_stats()
    counts = dict(launches={n: kops.kernel_launches()[n]
                            for n in LM_TRAIN_KERNELS},
                  ragged_directions=dict(
                      ragged_gemm_cuda.launches_by_direction),
                  ragged_instances=dict(ragged_gemm_cuda.launches_by_instance),
                  bwd_instances=dict(
                      flash_attention_bwd_cuda.launches_by_instance))
    loss, _, grads = got.pop()
    t0 = time.perf_counter()
    leaves = []
    for i, (g, p1, (pos, lidx), s) in enumerate(zip(
            tree_leaves(grads), tree_leaves(state.params), maps, shards)):
        leaves.append(dict(pos=pos, p0=p0[i], g=take(g, lidx),
                           p1=take(p1, lidx), sq=sum_sq(g), split=s.is_split))
    samples_s = time.perf_counter() - t0
    del grads, got
    checks = [{k: v for k, v in c.items() if k != "inputs"} for c in calls]
    del calls
    sh_tree = param_shardings(tp, like)

    def whole(params):                  # the leaves every model rank holds
        out: list = []
        tree_map(lambda p, s: None if s.is_split else out.append(p),
                 params, sh_tree)
        return {str(j): p for j, p in enumerate(out)}

    replicated = [replicas_equal(whole(state.params), tp, "model")]
    losses, step_ms = [float(m0["loss"])], []
    for k in range(TP_MORE_STEPS):
        reset_wire_stats(timing=k == TP_MORE_STEPS - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        replicated.append(replicas_equal(whole(state.params), tp, "model"))
    wire_timed = wire_stats()
    res = dict(loss=float(loss), metrics0={k: float(v) for k, v in
                                           m0.items()},
               leaves=leaves, counts=counts, checks=checks, wire=wire0,
               wire_timed=wire_timed, routes=routes_np(routes,
                                                       cfg.n_layers),
               replicated=replicated, losses=losses, step_ms=step_ms,
               init_s=init_s, step0_s=step0_s,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else 0.0)
    del state, step_fn, opt, batch
    torch.cuda.empty_cache()
    return res


def tp_serve_case(tp, spec) -> dict:
    """(b) on one rank: phi3.5-moe x 4 layers split over ``tp``, seeded as
    phase 10: prefill of phase 10's prompts, then its 32 decode steps fed
    phase 10's tokens; every launch of the prefill and the first decode
    step held against its plain version; the logits of each step, the
    routing, the wire's bytes; the prefill's and a decode step's ms, and
    their wire's ms apart."""
    import torch
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.dist import reset_wire_stats, wire_stats
    from repro_torch.dist.partition import shard_params
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    from repro_torch.models import lm
    cfg, dev = spec["tp_serve_cfg"], tp.device
    sd = torch.load(spec["tp_serve_digest"], weights_only=False)
    t0 = time.perf_counter()
    params = shard_params(tp, lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, _ = synthetic_lm_batch(spec["serve_batch"], spec["serve_prompt"],
                                 cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    fed = torch.from_numpy(sd["tokens"]).to(dev)
    cap, n_dec = spec["serve_capacity"], spec["serve_decode"]

    def launches():
        return {n: kops.kernel_launches()[n] for n in LM_KERNELS}

    counts, instances, wire, logits_all = {}, {}, {}, []
    with tp, torch.no_grad(), record_routing() as routes:
        kops.reset_kernel_launches()
        reset_wire_stats()
        with record_lm_kernels(check=True) as pre_calls:
            cache, logits = lm.prefill(cfg, params, batch, cap)
            torch.cuda.synchronize()
        counts["prefill"], wire["prefill"] = launches(), wire_stats()
        instances["prefill"] = dict(ragged_gemm_cuda.launches_by_instance)
        logits_all.append(logits.float())
        kops.reset_kernel_launches()
        reset_wire_stats()
        with record_lm_kernels(check=True) as dec_calls:
            logits, cache = lm.decode_step(cfg, params, cache, fed[:, :1])
            torch.cuda.synchronize()
        counts["decode_1"], wire["decode_1"] = launches(), wire_stats()
        instances["decode_1"] = dict(ragged_gemm_cuda.launches_by_instance)
        logits_all.append(logits.float())
        kops.reset_kernel_launches()
        reset_wire_stats()
        t0 = time.perf_counter()
        for i in range(1, n_dec):
            logits, cache = lm.decode_step(cfg, params, cache,
                                           fed[:, i:i + 1])
            logits_all.append(logits.float())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / (n_dec - 1) * 1e3
        counts["decode_rest"], wire["decode_rest"] = launches(), \
            wire_stats()
        instances["decode_rest"] = dict(
            ragged_gemm_cuda.launches_by_instance)
        n_routes = len(routes)
    # the times: a prefill, then one with the wire synced; decode steps
    # with the wire synced (the cache keeps TP_WIRE_DECODE spare slots)
    with tp, torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(cfg, params, batch, cap)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        reset_wire_stats(timing=True)
        lm.prefill(cfg, params, batch, cap)
        wire["prefill_timed"] = wire_stats()
        reset_wire_stats(timing=True)
        for _ in range(TP_WIRE_DECODE):
            logits, cache = lm.decode_step(cfg, params, cache, fed[:, -1:])
        torch.cuda.synchronize()
        wire["decode_timed"] = wire_stats()
    reset_wire_stats()
    checks = [{k: v for k, v in c.items() if k != "inputs"}
              for c in pre_calls + dec_calls]
    n = cfg.n_layers
    res = dict(logits=torch.stack(logits_all).cpu().numpy(),
               counts=counts, instances=instances, checks=checks,
               wire=wire, init_s=init_s, prefill_ms=prefill_ms,
               decode_ms=decode_ms, n_routes=n_routes,
               pre_routes=routes_np(routes, n),
               dec_routes=routes_np(routes[n:], n * n_dec,
                                    layer0_logits=False))
    del params, cache, routes, pre_calls, dec_calls
    torch.cuda.empty_cache()
    return res


def tp_case(mesh, spec) -> dict:
    """Phase 18 on one of phase 16's ranks: the two ranks as one 'model'
    axis (every rank creates the mesh), (a) then (b)."""
    import torch
    from repro_torch.dist import make_data_mesh
    tp = make_data_mesh(1, model=TP_RANKS, device=mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    train = tp_train_case(tp, spec)
    t1 = time.perf_counter()
    serve = tp_serve_case(tp, spec)
    return dict(coords=(tp.index("data"), tp.index("model")), train=train,
                serve=serve, train_s=t1 - t0,
                serve_s=time.perf_counter() - t1)


def tp_rank(mesh, spec) -> dict:
    """Phase 18 alone in two spawned ranks (``tp_phase``; the whole script
    runs :func:`tp_case` in phase 16's ranks instead)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.build import build_kernels
    if build_kernels():
        raise AssertionError("a rank built kernels: the parent builds them")
    t1 = time.perf_counter()
    out = tp_case(mesh, spec)
    out["tp_s"] = time.perf_counter() - t1
    return out


def tp_phase() -> dict:
    """Phase 18 alone (after phases 10 and 12 wrote their digests): two
    ranks on the card, its checks, its log. ``tools/tp_probe.py`` runs
    it."""
    import torch
    from repro_torch.dist import run_ranks
    spec = tp_spec()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build = ROOT / "build"
    t0 = time.perf_counter()
    try:
        tps = run_ranks(tp_rank, TP_RANKS, str(build), device=DEVICE,
                        timeout_s=DP_TIMEOUT_S, args=(spec,))
    except BaseException:
        for key in ("tp_train_digest", "tp_serve_digest"):
            Path(spec[key]).unlink(missing_ok=True)
        raise
    digests = tp_digests(spec)
    tp = tp_checks(tps, spec, *digests)
    tp["rank_s"] = [round(t["tp_s"], 1) for t in tps]
    tp["seconds"] = time.perf_counter() - t0
    tp_log(tp)
    return tp


def tp_log(tp: dict) -> None:
    tr, sv, tm = tp["train"], tp["serve"], tp["times"]
    w0 = tp["wire"][0]
    log(f"phase 18 (a) phi3.5-moe x {LM_TRAIN_LAYERS} layers on a 'model' "
        f"axis of {TP_RANKS}: loss {tr['loss']:.6f} against phase 12's "
        f"{tr['loss_one_card']:.6f} (tolerance {TP_LOSS_TOL} of it); "
        f"routing changes by layer {tr['flips_by_layer']} (share "
        f"{tr['flipped_share']:.5f}), layer 0's at margins <= "
        f"{tr['layer0']['worst_flip_margin']:.3e} against its router "
        f"logits' largest difference {tr['layer0']['max_logit_diff']:.3e}; "
        f"gradients' worst relative L2 {tr['grad_rel_l2']:.3e}, norm "
        f"{tr['grad_norm_rel']:.3e} (bound {tr['grad_bound']:.3e}); "
        f"updates {tr['update_over_bound']:.3f} of 2 lr (1 + 2^-7) + 2 "
        f"ulps; the "
        f"initial slices phase 12's bits; replicated leaves bitwise on both "
        f"ranks after {1 + TP_MORE_STEPS} steps; losses {tp['losses']}")
    log(f"phase 18 (b) phi3.5-moe x {LM_LAYERS} layers: prefill and "
        f"{LM_DECODE} decode steps fed phase 10's tokens; rows with a "
        f"routing change of their own {sv['rows_own_flip']} of {sv['rows']} "
        f"(worst {sv['worst_flipped_row']:.3e}); the others' worst "
        f"max|diff| / max|row| {sv['worst_clean_row']:.3e}, median "
        f"{sv['median_clean_row']:.3e} (bound {sv['row_bound']:.3e}, the "
        f"context's changed share {sv['context_flipped_share']:.5f}); "
        f"prefill routing changes by layer {sv['prefill_flips_by_layer']}")
    log(f"phase 18 kernels: {tp['checks']} launches held against their "
        f"plain versions (worst max|diff| / max|plain| "
        f"{tp['worst_err_over_max']}, tolerance {LM_TOL}); launches "
        f"{tp['launches_tp']}, every ragged GEMM wgmma")
    log(f"phase 18 wire, rank 0: train step {w0['train']['bytes']} bytes in "
        f"{w0['train']['calls']} calls (worked out from the shapes: equal), "
        f"prefill {w0['prefill']['bytes']}, decode step "
        f"{w0['decode']['bytes']}; step ms {tm['step_ms']} (wire "
        f"{[round(x, 1) for x in tm['step_wire_ms']]} ms in the synced "
        f"step); prefill ms {[round(x, 1) for x in tm['prefill_ms']]} (wire "
        f"{[round(x, 1) for x in tm['prefill_wire_ms']]}); decode ms a step "
        f"{[round(x, 2) for x in tm['decode_ms']]} (wire "
        f"{[round(x, 2) for x in tm['decode_wire_ms']]}); init s "
        f"{tm['init_s']}, train s {[round(x, 1) for x in tm['train_s']]}, "
        f"serve s {[round(x, 1) for x in tm['serve_s']]}, peak GB "
        f"{[round(x, 2) for x in tm['peak_gb']]}; ranks {tp['rank_s']} s")


def tp_rel(got, want) -> float:
    """The relative L2 difference of two sample vectors."""
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def tp_flips(ids_got, ids_want) -> np.ndarray:
    """Tokens whose expert set differs."""
    return (ids_got != ids_want).any(-1)


def tp_layer0(got: dict, want: dict) -> dict:
    """The first MoE layer's routing changes against the one-card run's:
    each must sit at a near-tie, phase 10's or 12's top-k margin within
    twice this run's largest router-logit difference on the tokens whose
    experts matched."""
    flip = tp_flips(got["ids"][0], want["ids"][0])
    diff = np.abs(got["logits0"] - want["logits0"]).max(-1)
    delta = float(diff[~flip].max()) if (~flip).any() else 0.0
    worst = float(want["margins"][0][flip].max()) if flip.any() else 0.0
    if flip.any() and not worst <= 2 * delta:
        raise AssertionError(f"phase 18: a first-layer routing change at a "
                             f"top-k margin of {worst:.3e}, past twice the "
                             f"router logits' largest difference "
                             f"{delta:.3e}")
    return dict(flips=int(flip.sum()), tokens=int(flip.size),
                max_logit_diff=delta, worst_flip_margin=worst)


def leaf_checks(ranks: list, want: list, lr: float, bound: float,
                tag: str) -> dict:
    """Each leaf's samples assembled from the ranks (a split leaf's from
    the rank that holds each entry, a replicated leaf's equal on every
    rank) and held against the one-card digest's ``want``: the initial
    params bitwise, the gradient and its norm within ``bound`` in relative
    L2, each update within 2 lr (1 + 2^-7) + 2 bf16 ulps. -> the worst of
    each."""
    worst = dict(grad_rel_l2=0.0, grad_norm_rel=0.0, update_over_bound=0.0)
    for i, w in enumerate(want):
        parts = [t[i] for t in ranks]
        n = len(w["idx"])
        p0, g, p1 = (np.full(n, np.nan, np.float32) for _ in range(3))
        for part in parts:
            pos = part["pos"]
            if parts[0]["split"]:
                if not np.isnan(p0[pos]).all():
                    raise AssertionError(f"{tag} leaf {i}: two ranks hold "
                                         f"one sampled entry")
            elif not (np.array_equal(part["g"], parts[0]["g"]) and
                      np.array_equal(part["p1"], parts[0]["p1"])):
                raise AssertionError(f"{tag} leaf {i}: a replicated leaf "
                                     f"differs across the ranks")
            p0[pos], g[pos], p1[pos] = part["p0"], part["g"], part["p1"]
        if np.isnan(p0).any():
            raise AssertionError(f"{tag} leaf {i}: sampled entries held by "
                                 f"no rank")
        if not np.array_equal(p0, w["p0"]):
            raise AssertionError(f"{tag} leaf {i} {w['shape']}: the initial "
                                 f"slices are not the one-card draw's bits")
        sq = sum(p["sq"] for p in parts) if parts[0]["split"] \
            else parts[0]["sq"]
        rel = tp_rel(g, w["g"])
        norm_rel = abs(sq ** 0.5 - w["g_sq"] ** 0.5) / max(
            w["g_sq"] ** 0.5, 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w["p1"]),
                                                  2.0 ** -126))) - 7)
        upd = float((np.abs(p1 - w["p1"]) /
                     (2 * lr * (1 + 2.0 ** -7) + 2 * ulp)).max())
        worst = dict(grad_rel_l2=max(worst["grad_rel_l2"], rel),
                     grad_norm_rel=max(worst["grad_norm_rel"], norm_rel),
                     update_over_bound=max(worst["update_over_bound"], upd))
        if not (rel <= bound and norm_rel <= bound and upd <= 1.0):
            raise AssertionError(
                f"{tag} leaf {i} {w['shape']}: gradient relative L2 "
                f"{rel:.3e}, norm {norm_rel:.3e} (bound {bound:.3e}); "
                f"update {upd:.3f} of its bound")
    return worst


def tp_train_checks(ranks: list, dig: dict, cfg, lr: float) -> dict:
    """(a)'s checks against phase 12's step 0 (the bounds above)."""
    want_counts = dict(
        launches={"ragged_gemm": 9 * cfg.n_layers,
                  "flash_attention": 2 * cfg.n_layers,
                  "flash_attention_bwd": cfg.n_layers},
        ragged_directions={"forward": 6 * cfg.n_layers,
                           "backward": 3 * cfg.n_layers},
        ragged_instances={"wgmma": 9 * cfg.n_layers, "wmma": 0, "f32": 0},
        bwd_instances={"wgmma": cfg.n_layers, "wmma": 0, "f32": 0})
    for r, t in enumerate(ranks):
        if t["counts"] != want_counts:
            raise AssertionError(f"phase 18 (a) rank {r} launched "
                                 f"{t['counts']}, want {want_counts}")
        if t["replicated"] != [True] * (1 + TP_MORE_STEPS):
            raise AssertionError(f"phase 18 (a): the replicated leaves "
                                 f"parted across the ranks: "
                                 f"{t['replicated']}")
        if t["loss"] != ranks[0]["loss"] or \
                t["losses"] != ranks[0]["losses"]:
            raise AssertionError("phase 18 (a): the ranks' losses differ")
        for key in ("ids", "margins"):
            if any(not np.array_equal(a, b) for a, b in zip(
                    t["routes"][key], ranks[0]["routes"][key])):
                raise AssertionError("phase 18 (a): the ranks routed "
                                     "differently")
    loss, want = ranks[0]["loss"], dig["loss"]
    if not abs(loss - want) <= TP_LOSS_TOL * abs(want):
        raise AssertionError(f"phase 18 (a): loss {loss} against phase "
                             f"12's {want} (tolerance {TP_LOSS_TOL} of it)")
    routes, wroutes = ranks[0]["routes"], dig["routes"]
    flips = [tp_flips(a, b) for a, b in zip(routes["ids"], wroutes["ids"])]
    f = float(np.mean([x.mean() for x in flips]))
    layer0 = tp_layer0(routes, wroutes)
    bound = TP_GRAD_BASE + 2 * f ** 0.5
    worst = leaf_checks([t["leaves"] for t in ranks], dig["leaves"], lr,
                        bound, "phase 18 (a)")
    return dict(loss=loss, loss_one_card=want, flips_by_layer=[
        int(x.sum()) for x in flips], flipped_share=f, layer0=layer0,
        grad_bound=bound, **worst)


def tp_serve_checks(ranks: list, sd: dict, cfg) -> dict:
    """(b)'s checks against phase 10's serving (the bounds above)."""
    n, n_dec = cfg.n_layers, len(sd["logits"]) - 1
    want_counts = {"prefill": {"ragged_gemm": 3 * n, "flash_attention": n},
                   "decode_1": {"ragged_gemm": 3 * n, "flash_attention": 0},
                   "decode_rest": {"ragged_gemm": 3 * n * (n_dec - 1),
                                   "flash_attention": 0}}
    for r, s in enumerate(ranks):
        if s["counts"] != want_counts or any(
                by != {"wgmma": want_counts[run]["ragged_gemm"], "wmma": 0,
                       "f32": 0} for run, by in s["instances"].items()):
            raise AssertionError(f"phase 18 (b) rank {r}: launches "
                                 f"{s['counts']} by instance "
                                 f"{s['instances']}, want {want_counts}, "
                                 "every ragged launch wgmma")
        if not np.array_equal(s["logits"], ranks[0]["logits"]):
            raise AssertionError("phase 18 (b): the ranks' logits differ")
    got, want = ranks[0]["logits"][:, :, 0], sd["logits"][:, :, 0]
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"phase 18 (b): logits {got.shape}, want "
                             f"{want.shape}, finite {np.isfinite(got).all()}")
    pre, wpre = ranks[0]["pre_routes"], sd["pre_routes"]
    layer0 = tp_layer0(pre, wpre)
    pflips = [tp_flips(a, b) for a, b in zip(pre["ids"], wpre["ids"])]
    f_ctx = float(np.mean([x.mean() for x in pflips]))
    b = got.shape[1]
    s_len = pflips[0].size // b
    # a row's own routing: the prompt's last position, then each step's
    own = np.zeros((n_dec + 1, b), bool)
    for l in range(n):
        own[0] |= pflips[l].reshape(b, s_len)[:, -1]
    dec, wdec = ranks[0]["dec_routes"]["ids"], sd["dec_routes"]["ids"]
    for step in range(n_dec):
        for l in range(n):
            own[step + 1] |= tp_flips(dec[step * n + l],
                                      wdec[step * n + l])
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    bound = TP_ROW_BASE + 2 * f_ctx
    clean = err[~own]
    if own.mean() > TP_FLIPPED_ROWS or (clean.size and
                                         not clean.max() <= bound):
        raise AssertionError(f"phase 18 (b): {int(own.sum())} of {own.size} "
                             f"rows changed experts (at most "
                             f"{TP_FLIPPED_ROWS}); the others' worst "
                             f"max|diff| / max|row| "
                             f"{clean.max() if clean.size else 0:.3e} "
                             f"(bound {bound:.3e})")
    return dict(layer0=layer0, prefill_flips_by_layer=[
        int(x.sum()) for x in pflips], context_flipped_share=f_ctx,
        rows=int(own.size), rows_own_flip=int(own.sum()), row_bound=bound,
        worst_clean_row=float(clean.max()) if clean.size else 0.0,
        worst_flipped_row=float(err[own].max()) if own.any() else 0.0,
        median_clean_row=float(np.median(clean)) if clean.size else 0.0)


def tp_wire_check(stats: dict, want: int, what: str) -> dict:
    """The bytes a rank handed the backend (``wire_stats``) against the
    count worked out from the shapes; their calls and ms, and the
    exchanges' (``all_to_all``) ms and bytes apart."""
    got = sum(v["bytes"] for v in stats.values())
    if got != want:
        raise AssertionError(f"{what}: a rank handed the backend {got} "
                             f"bytes, worked out {want} ({stats})")
    return dict(bytes=got, calls=sum(v["calls"] for v in stats.values()),
                ms=sum(v["ms"] for v in stats.values()),
                exchange_ms=stats.get("all_to_all", {}).get("ms", 0.0),
                exchange_bytes=stats.get("all_to_all", {}).get("bytes", 0))


def tp_digests(spec: dict) -> tuple:
    """Phases 12's and 10's digests, read, and their files removed."""
    import torch
    out = []
    for key in ("tp_train_digest", "tp_serve_digest"):
        path = Path(spec[key])
        try:
            out.append(torch.load(path, weights_only=False))
        finally:
            path.unlink(missing_ok=True)
    return tuple(out)


def tp_checks(tps: list, spec: dict, dig: dict, sd: dict) -> dict:
    """Phase 18's checks in the parent, on what the two ranks returned,
    against phase 12's digest ``dig`` and phase 10's ``sd``."""
    cfg, cfg4 = spec["tp_train_cfg"], spec["tp_serve_cfg"]
    if sorted(t["coords"] for t in tps) != [(0, 0), (0, 1)]:
        raise AssertionError(f"phase 18: mesh coordinates "
                             f"{[t['coords'] for t in tps]}")
    train = tp_train_checks([t["train"] for t in tps], dig, cfg, 3e-4)
    serve = tp_serve_checks([t["serve"] for t in tps], sd, cfg4)
    b, s = spec["lm_train_batch"], spec["lm_train_seq"]
    pb, ps = spec["serve_batch"], spec["serve_prompt"]
    wire = {}
    for r, t in enumerate(tps):
        wire[r] = dict(
            train=tp_wire_check(t["train"]["wire"], tp_wire_bytes(
                cfg, b, s, TP_RANKS, "train"), "phase 18 train step 0"),
            train_timed=tp_wire_check(t["train"]["wire_timed"], tp_wire_bytes(
                cfg, b, s, TP_RANKS, "train"), "phase 18 a timed train step"),
            prefill=tp_wire_check(t["serve"]["wire"]["prefill"], tp_wire_bytes(
                cfg4, pb, ps, TP_RANKS, "serve"), "phase 18 prefill"),
            decode=tp_wire_check(t["serve"]["wire"]["decode_1"], tp_wire_bytes(
                cfg4, pb, 1, TP_RANKS, "serve"), "phase 18 decode step"),
            prefill_timed=tp_wire_check(
                t["serve"]["wire"]["prefill_timed"], tp_wire_bytes(
                    cfg4, pb, ps, TP_RANKS, "serve"), "phase 18 prefill"),
            decode_timed=tp_wire_check(
                t["serve"]["wire"]["decode_timed"], TP_WIRE_DECODE *
                tp_wire_bytes(cfg4, pb, 1, TP_RANKS, "serve"),
                "phase 18 decode"))
    checks = [c for t in tps for c in t["train"]["checks"] +
              t["serve"]["checks"]]
    worst, worst_abs = {}, {}
    for c in checks:
        worst[c["name"]] = max(worst.get(c["name"], 0.0), c["err_over_max"])
        worst_abs[c["name"]] = max(worst_abs.get(c["name"], 0.0),
                                   c["max_abs_err"])
    launches_tp = {}
    for t in tps:
        for name, v in t["train"]["counts"]["launches"].items():
            launches_tp[name] = launches_tp.get(name, 0) + v
        for run in t["serve"]["counts"].values():
            for name, v in run.items():
                launches_tp[name] = launches_tp.get(name, 0) + v
    times = dict(
        step_ms=[t["train"]["step_ms"] for t in tps],
        step_wire_ms=[t["train"]["wire_timed"] and sum(
            v["ms"] for v in t["train"]["wire_timed"].values()) for t in tps],
        prefill_ms=[t["serve"]["prefill_ms"] for t in tps],
        prefill_wire_ms=[wire[r]["prefill_timed"]["ms"] for r in wire],
        decode_ms=[t["serve"]["decode_ms"] for t in tps],
        decode_wire_ms=[wire[r]["decode_timed"]["ms"] / TP_WIRE_DECODE
                        for r in wire],
        init_s=[(t["train"]["init_s"], t["serve"]["init_s"]) for t in tps],
        train_s=[t["train_s"] for t in tps],
        serve_s=[t["serve_s"] for t in tps],
        peak_gb=[t["train"]["peak_gb"] for t in tps])
    return dict(train=train, serve=serve, wire=wire, times=times,
                worst_err_over_max=worst, worst_abs_err=worst_abs,
                launches_tp=launches_tp, checks=len(checks),
                losses=tps[0]["train"]["losses"])


# --------------------------------------------------------------------------
# phase 19: the manual expert-parallel MoE, sixteen model ranks on the card
# --------------------------------------------------------------------------

EP_RANKS = 16           # a 'model' axis of phi3.5-moe's 16 experts: one a rank
EP_TRAIN_LAYERS = 1     # of 32: trained, step 0 and EP_MORE_STEPS more
EP_SERVE_LAYERS = 4     # of 32: served (phase 10's cut)
EP_TRAIN_BATCH, EP_TRAIN_SEQ = 2, 512       # 64 tokens a rank, 16 slots a peer
EP_BATCH, EP_PROMPT, EP_DECODE = 2, 1024, 4  # 128 tokens a rank, 24 slots
EP_CAPACITY = EP_PROMPT + EP_DECODE + 8
EP_MORE_STEPS = 1       # after step 0, timed with the wire synced
EP_DRAW_TURN = 1        # ranks that draw their params at once: a rank holds
#                         one whole layer (~4.3 GB with its fp32 temporary)
#                         while it draws, so the sixteen take turns
EP_TIMEOUT_S = 600.0    # the rank helper's join limit for the sixteen ranks
EP_TRAIN_DIGEST = "ep_train_digest.pt"   # the one-card oracle, under build/
EP_SERVE_DIGEST = "ep_serve_digest.pt"
EP_DECODE_SEED = 19     # the decode steps' fed tokens
EP_EINSUM_SEED = 23     # the no-drop check's input (EP_BATCH x EP_PROMPT)
EP_EINSUM_CF = 8.0      # = E / k: Cs = the 128 tokens a rank holds, so no
#                         peer's slots overflow; the einsum's capacity is
#                         every token, so no expert's do
EP_EINSUM_ROW_TOL = 2.0 ** -6   # max|manual - einsum| / max|einsum row|
EP_EINSUM_AUX_TOL = 1e-5        # relative, with no routing change
# The bounds, stated before the first card run (PERF.md §6). The
# oracle is the ranks' own arithmetic in one process: the one-card model
# whose MoE layers run ``moe_manual_reference`` for a 'model' axis of 16.
# The attention is whole on every rank (the same kernels on the same
# inputs), the embedding's vocab-parallel sum adds zeros, the manual path
# runs the products each rank runs at the oracle's shapes: the forward up
# to the head is predicted bitwise. What adds rounding is the vocabulary's
# split: the head's partial logits and the cross-entropy's fp32 sums in
# another order, and in the backward the head's input gradient, a sum of
# 16 bf16 partials. So phase 18's bounds hold it (TP_*): the loss within
# TP_LOSS_TOL; a first-layer routing change only at a near-tie of the
# oracle's top-k; each sampled gradient within TP_GRAD_BASE + 2 sqrt(f)
# in relative L2 (f the share of token-layers whose experts changed, 0
# predicted); each update within 2 lr (1 + 2^-7) + 2 bf16 ulps; each logit
# row without a routing change of its own within TP_ROW_BASE + 2 f_ctx of
# its largest, at most TP_FLIPPED_ROWS of the rows with one; the leaves
# every rank holds bitwise equal on all sixteen; the bytes each rank hands
# gloo exactly ``ep_wire_bytes``.
# The no-drop check holds the ranks' arithmetic against code it does not
# share: layer 0's MoE of the served model through the manual path on the
# sixteen ranks (one ``moe_layer`` call at EP_EINSUM_CF, where neither
# route drops a slot) against the einsum route on the one card
# (``moe._moe_einsum``: ``route_topk``, the dispatch buffer, the ragged
# GEMM kernel, ``dispatch.combine``). Both round to bf16 at the same
# points (the three products, the gated rows, their sum), but the fp32
# sums before each rounding run in other orders (the kernel's tiles,
# cuBLAS's), so a rounding may fall the other way at each of three
# points: each token's row within EP_EINSUM_ROW_TOL of its largest
# value; a token whose top-k changed (the router's fp32 product on 128
# rows against 2,048) only at a top-k logit margin within twice the
# logits' largest difference, and left out of the row check; the aux
# loss within EP_EINSUM_AUX_TOL relative plus what the changed picks can
# move it.


@contextlib.contextmanager
def manual_reference_layers(model: int):
    """While on, the one-card model's MoE layers compute what the ranks of
    a 'model' axis of ``model`` compute: ``moe_manual_reference`` where
    the ranks take the manual path (the sequence dividing over
    ``model``), the einsum route elsewhere (decode's one position). The
    transformer's ``moe_layer`` is swapped, as ``record_manual_routing``
    swaps ``route_manual``."""
    from repro_torch.models.lm import moe as M
    from repro_torch.models.lm import transformer as T
    real = T.moe_layer

    def layer(cfg, p, x):
        if cfg.moe_sparse_dispatch and x.shape[1] % model == 0 and \
                cfg.n_experts * cfg.n_expert_replicas == model:
            return M.moe_manual_reference(cfg, p, x, model)
        return real(cfg, p, x)

    T.moe_layer = layer
    try:
        yield
    finally:
        T.moe_layer = real


@contextlib.contextmanager
def record_manual_routing():
    """While on, every ``moe.route_manual`` call (one a rank an MoE layer
    of the manual path, in order; a recomputed layer again; the one-card
    oracle's one a virtual rank) is recorded: its router logits and its
    top-k experts."""
    from repro_torch.models.lm import moe as M
    real = M.route_manual
    calls: list = []

    def recorded(logits, k):
        out = real(logits, k)
        calls.append((logits.detach().float().clone(),
                      out[2].detach().clone(), k))
        return out

    M.route_manual = recorded
    try:
        yield calls
    finally:
        M.route_manual = real


def ep_routes(calls, n: int, with_logits: int) -> dict:
    """The first ``n`` recorded routings as numpy (``routes_np``'s expert
    sets and top-k margins) and the router logits of the first
    ``with_logits``."""
    out = routes_np(calls, n, layer0_logits=False)
    out["logits"] = [c[0].cpu().numpy() for c in calls[:with_logits]]
    return out


def ep_wire_bytes(cfg, b: int, s: int, m: int, what: str) -> int:
    """The bytes a rank hands the backend (each collective's filled
    buffer) on a 'model' axis of ``m`` = E ranks with the attention whole,
    the MoE layers through the manual path: one train step (remat
    "full"), one prefill, or one decode step of (b, s) positions. A
    layer's manual path: the sequence's gather (``gather_from_axis``,
    the whole (b, s, d_model) bf16) and the two exchanges (the (E, Cs,
    d_model) send buffer each way, Cs = ``manual_capacity`` of b s / m
    tokens), the stats' sum (m x (2E + 1) fp32); its backward: the two
    exchanges again, the sequence split's gather of the gradient, the
    router's gradient summed over the ranks (m x d_model x E fp32); the
    recompute of a layer's backward runs its forward's two exchanges and
    the stats' sum again but not the sequence's gather (the non-reentrant
    checkpoint stops once the saved tensors are back, and the gather saves
    none). The embedding's
    vocab-parallel sum (m x (b, s, d_model) bf16), the cross-entropy's
    max, sum and target logit a chunk (m x (b, c) fp32 each), the head
    input's gradient summed over the ranks (m x (b, s, d_model) bf16),
    the global norm's scalar (m x 4). Serving: the embedding's sum, each
    layer's forward, the last position's logits gathered (b x vocab
    bf16); a decode step's MoE takes the split einsum, its partial
    outputs summed (m x (b, d_model) bf16 a layer)."""
    from repro_torch.models.lm.moe import manual_capacity
    n, d, e = cfg.n_layers, cfg.d_model, cfg.n_experts
    act = b * s * d * 2
    stats = m * (2 * e + 1) * 4
    if what == "decode":
        return m * act + n * m * act + b * cfg.vocab_padded * 2
    exchange = e * manual_capacity(cfg, b * s // m) * d * 2
    layer = act + 2 * exchange + stats
    if what == "prefill":
        return m * act + n * layer + b * cfg.vocab_padded * 2
    recompute = 2 * exchange + stats if cfg.remat == "full" else 0
    backward = 2 * exchange + act + m * d * e * 4
    return (m * act + n * (layer + recompute + backward)
            + 3 * m * b * s * 4 + m * act + m * 4)


def ep_spec() -> dict:
    """Phase 19's sizes and rules for the ranks (spawned: they import this
    script afresh)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.dist import WHOLE_ATTENTION_RULES
    full = get_config(LM_ARCH)
    build = ROOT / "build"
    return dict(train_cfg=dc.replace(full, n_layers=EP_TRAIN_LAYERS),
                serve_cfg=dc.replace(full, n_layers=EP_SERVE_LAYERS),
                rules=WHOLE_ATTENTION_RULES,
                train_digest=str(build / EP_TRAIN_DIGEST),
                serve_digest=str(build / EP_SERVE_DIGEST),
                go=str(build / "ep_go"),
                train_batch=EP_TRAIN_BATCH, train_seq=EP_TRAIN_SEQ,
                batch=EP_BATCH, prompt=EP_PROMPT, decode=EP_DECODE,
                capacity=EP_CAPACITY, more_steps=EP_MORE_STEPS,
                draw_turn=EP_DRAW_TURN)


def ep_batches(spec, dev) -> tuple:
    """(the train batch, the prompt, the decode steps' fed tokens), on
    ``dev``."""
    import torch
    from repro_torch.data import synthetic_lm_batch
    cfg = spec["train_cfg"]
    toks, tgts = synthetic_lm_batch(spec["train_batch"], spec["train_seq"],
                                    cfg.vocab)
    train = {"tokens": torch.from_numpy(toks).to(dev),
             "targets": torch.from_numpy(tgts).to(dev)}
    ptoks, _ = synthetic_lm_batch(spec["batch"], spec["prompt"], cfg.vocab,
                                  step=1)
    fed = np.random.default_rng(EP_DECODE_SEED).integers(
        0, cfg.vocab, (spec["batch"], spec["decode"])).astype(np.int32)
    return train, {"tokens": torch.from_numpy(ptoks).to(dev)}, \
        torch.from_numpy(fed).to(dev)


def ep_einsum_cfg(spec):
    """The served config at the no-drop check's capacity factor."""
    import dataclasses as dc
    return dc.replace(spec["serve_cfg"], capacity_factor=EP_EINSUM_CF)


def ep_einsum_input(spec, dev):
    """The no-drop check's input: (EP_BATCH, EP_PROMPT, d_model) bf16 from
    EP_EINSUM_SEED, the same on every rank."""
    import torch
    cfg = spec["serve_cfg"]
    x = np.random.default_rng(EP_EINSUM_SEED).standard_normal(
        (spec["batch"], spec["prompt"], cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x).to(dev).to(torch.bfloat16)


def ep_layer0_moe(params) -> dict:
    """Layer 0's MoE leaves of stacked (L, ...) params (a rank's slices on
    a rank)."""
    return {k: v[0] for k, v in params["layers"]["moe"].items()}


def ep_einsum_reference(spec, params, dev) -> dict:
    """The no-drop check's oracle on the one card: layer 0's MoE of the
    whole served params through the einsum route (``moe._moe_einsum``,
    no mesh) on ``ep_einsum_input`` at EP_EINSUM_CF. -> the output, the
    aux loss, each token's top-k experts, its top-k logit margin (the
    k-th logit less the next), its router logits, and max(me) / n."""
    import torch
    from repro_torch.models.lm import moe as M
    cfg, k = ep_einsum_cfg(spec), spec["serve_cfg"].top_k
    x, p = ep_einsum_input(spec, dev), ep_layer0_moe(params)
    out, aux = M._moe_einsum(cfg, p, x)
    logits = x.reshape(-1, cfg.d_model).float() @ p["router"]
    top = torch.topk(logits, k + 1, dim=-1, sorted=True)
    probs = torch.softmax(logits, dim=-1)
    res = dict(out=out.float().cpu().numpy(), aux=float(aux),
               ids=top.indices[:, :k].cpu().numpy(),
               margin=(top.values[:, k - 1] - top.values[:, k]).cpu().numpy(),
               logits=logits.cpu().numpy(),
               me_max=float(probs.sum(0).max()) / probs.shape[0])
    del out, x, logits, probs
    return res


def ep_oracle(spec) -> dict:
    """Phase 19's one-card oracle, in this process before the ranks start:
    the one-card model under ``manual_reference_layers(EP_RANKS)`` (its
    MoE layers ``moe_manual_reference`` of a 'model' axis of 16), drawn
    from the ranks' seed. Train: step 0's loss, sampled params and
    gradients, routing, then EP_MORE_STEPS losses; serve: the prefill's
    and decode steps' logits and routing, and the no-drop check's einsum
    route (:func:`ep_einsum_reference`). Written under ``build/`` and
    freed."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg, cfg4 = spec["train_cfg"], spec["serve_cfg"]
    train, prompt, fed = ep_batches(spec, dev)
    got: list = []
    with manual_reference_layers(EP_RANKS):
        step_fn, opt = TL.make_train_step(cfg)
        state = TL.make_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
        p0 = tree_map(torch.clone, state.params)
        with record_grads(got.append), record_manual_routing() as routes:
            state, m0 = step_fn(state, train)
        loss, _, grads = got.pop()
        dig = train_digest(loss, p0, grads, state.params, routes,
                           cfg.n_layers * EP_RANKS)
        dig["routes"] = ep_routes(routes, cfg.n_layers * EP_RANKS, EP_RANKS)
        del p0, grads, routes
        losses = [float(m0["loss"])]
        for _ in range(spec["more_steps"]):
            state, m = step_fn(state, train)
            losses.append(float(m["loss"]))
        dig["losses"] = losses
        del state, step_fn, opt
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        with torch.no_grad():
            params = lm.init_params(
                cfg4, torch.Generator(device=dev).manual_seed(0), device=dev)
            with record_manual_routing() as pre, record_routing() as dec:
                cache, logits = lm.prefill(cfg4, params, prompt,
                                           spec["capacity"])
                out = [logits.float()]
                for i in range(spec["decode"]):
                    logits, cache = lm.decode_step(cfg4, params, cache,
                                                   fed[:, i:i + 1])
                    out.append(logits.float())
            sd = dict(logits=torch.stack(out).cpu().numpy(),
                      pre_routes=ep_routes(pre, cfg4.n_layers * EP_RANKS,
                                           EP_RANKS),
                      dec_routes=routes_np(dec, cfg4.n_layers
                                           * spec["decode"],
                                           layer0_logits=False))
            sd["einsum"] = ep_einsum_reference(spec, params, dev)
        del params, cache, out, pre, dec
    torch.save(dig, spec["train_digest"])
    torch.save(sd, spec["serve_digest"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(train_s=t1 - t0, serve_s=time.perf_counter() - t1,
                losses=losses)


def host_available_gb() -> float:
    """The host's ``MemAvailable`` in GB (``/proc/meminfo``; 0 where the
    file is missing)."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0


def ep_in_turns(ep, turn: int, fn):
    """``fn()`` on every rank of ``ep``'s 'model' axis, ``turn`` ranks at
    a time (a barrier between turns), the card's cache emptied after each:
    what a rank draws whole before it keeps its slices never sits on the
    card beside sixteen others."""
    import torch
    import torch.distributed as dist
    r, out = ep.index("model"), None
    for t in range(0, int(ep.shape["model"]), turn):
        if t <= r < t + turn:
            out = fn()
            if ep.device.type == "cuda":
                torch.cuda.synchronize(ep.device)
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def ep_train_case(ep, spec) -> dict:
    """(a) on one rank: phi3.5-moe x 1 layer on the 'model' axis of 16, the
    MoE through the manual path; step 0 with every launch held against its
    plain version, the rank's samples of its params and gradients, its
    routing, the wire's bytes; then EP_MORE_STEPS steps (the last timed
    with the wire synced), the leaves every rank holds compared after
    each; the case's timeline."""
    import torch
    from repro_torch.dist import replicas_equal, reset_wire_stats, wire_stats
    from repro_torch.dist.partition import param_shardings
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import lm as TL
    cfg, dev = spec["train_cfg"], ep.device
    t_case, tl = time.perf_counter(), {}

    def mark(name):
        tl[name] = round(time.perf_counter() - t_case, 2)

    step_fn, opt = TL.make_train_step(cfg, mesh=ep)
    mark("step_fn")
    t0 = time.perf_counter()
    state = ep_in_turns(ep, spec["draw_turn"], lambda: TL.make_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt, mesh=ep))
    init_s = time.perf_counter() - t0
    mark("drawn")
    draw_gb = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    like = TL.full_param_shapes(cfg)
    shards = tree_leaves(param_shardings(ep, like))
    shapes = [tuple(t.shape) for t in tree_leaves(like)]
    maps = [local_samples(leaf_sample(i, int(np.prod(shp))), shp, s)
            for i, (shp, s) in enumerate(zip(shapes, shards))]
    p0 = [take(p, lidx) for p, (_, lidx) in zip(tree_leaves(state.params),
                                                maps)]
    train, _, _ = ep_batches(spec, dev)
    mark("samples_mapped")
    got: list = []
    torch.cuda.synchronize()
    kops.reset_kernel_launches()
    reset_wire_stats()
    tl["host_available_gb_before"] = round(host_available_gb(), 1)
    t0, cpu0 = time.perf_counter(), time.process_time()
    with record_train_kernels(check=True) as calls, \
            record_grads(got.append), record_manual_routing() as routes:
        state, m0 = step_fn(state, train)
        torch.cuda.synchronize()
    step0_s = time.perf_counter() - t0
    tl["step0_cpu_s"] = round(time.process_time() - cpu0, 2)
    tl["host_available_gb"] = round(host_available_gb(), 1)
    if dev.type == "cuda":
        tl["alloc_retries"] = torch.cuda.memory_stats(dev).get(
            "num_alloc_retries", 0)
    mark("step0")
    wire0 = wire_stats()
    counts = {n: kops.kernel_launches()[n] for n in LM_TRAIN_KERNELS}
    loss, _, grads = got.pop()
    t0 = time.perf_counter()
    leaves = []
    for i, (g, p1, (pos, lidx), s) in enumerate(zip(
            tree_leaves(grads), tree_leaves(state.params), maps, shards)):
        leaves.append(dict(pos=pos, p0=p0[i], g=take(g, lidx),
                           p1=take(p1, lidx), sq=sum_sq(g), split=s.is_split))
    samples_s = time.perf_counter() - t0
    mark("samples")
    del grads, got
    checks = [{k: v for k, v in c.items() if k != "inputs"} for c in calls]
    del calls
    sh_tree = param_shardings(ep, like)

    def whole(params):                  # the leaves every model rank holds
        out: list = []
        tree_map(lambda p, s: None if s.is_split else out.append(p),
                 params, sh_tree)
        return {str(j): p for j, p in enumerate(out)}

    t0 = time.perf_counter()
    replicated = [replicas_equal(whole(state.params), ep, "model")]
    replicas_s = time.perf_counter() - t0
    losses, step_ms = [float(m0["loss"])], []
    for k in range(spec["more_steps"]):
        reset_wire_stats(timing=k == spec["more_steps"] - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, train)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        wire_timed = wire_stats()
        t0 = time.perf_counter()
        replicated.append(replicas_equal(whole(state.params), ep, "model"))
        replicas_s += time.perf_counter() - t0
    mark("steps")
    res = dict(loss=float(loss), metrics0={k: float(v) for k, v in
                                           m0.items()},
               leaves=leaves, counts=counts, checks=checks, wire=wire0,
               wire_timed=wire_timed,
               routes=ep_routes(routes, cfg.n_layers, cfg.n_layers),
               replicated=replicated, losses=losses, step_ms=step_ms,
               init_s=init_s, step0_s=step0_s, draw_gb=draw_gb,
               replicas_s=replicas_s, samples_s=samples_s, timeline=tl,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else 0.0)
    del state, step_fn, opt, train
    torch.cuda.empty_cache()
    mark("freed")
    return res


def ep_serve_case(ep, spec) -> dict:
    """(b) on one rank: phi3.5-moe x 4 layers on the 'model' axis of 16:
    the prefill through the manual path, then EP_DECODE decode steps
    through the split einsum fed the oracle's tokens; every launch of the
    prefill and the first decode step held against its plain version; the
    logits, the routing, the wire's bytes; a decode step's ms, and a
    prefill's with the wire synced, the wire's ms apart; then the no-drop
    check's manual layer (layer 0's MoE at EP_EINSUM_CF), its block of
    the output, its aux loss and routing."""
    import torch
    from repro_torch.dist import reset_wire_stats, wire_stats
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    from repro_torch.models import lm
    from repro_torch.models.lm import moe as M
    cfg, dev = spec["serve_cfg"], ep.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = ep_in_turns(ep, spec["draw_turn"], lambda: lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        mesh=ep))
    init_s = time.perf_counter() - t0
    _, prompt, fed = ep_batches(spec, dev)
    cap, n_dec = spec["capacity"], spec["decode"]
    t_checked = time.perf_counter()

    def launches():
        return {n: kops.kernel_launches()[n] for n in LM_KERNELS}

    counts, instances, wire, logits_all = {}, {}, {}, []
    with ep, torch.no_grad(), record_manual_routing() as pre, \
            record_routing() as dec:
        kops.reset_kernel_launches()
        reset_wire_stats()
        with record_lm_kernels(check=True) as pre_calls:
            cache, logits = lm.prefill(cfg, params, prompt, cap)
            torch.cuda.synchronize()
        counts["prefill"], wire["prefill"] = launches(), wire_stats()
        instances["prefill"] = dict(ragged_gemm_cuda.launches_by_instance)
        logits_all.append(logits.float())
        kops.reset_kernel_launches()
        reset_wire_stats()
        with record_lm_kernels(check=True) as dec_calls:
            logits, cache = lm.decode_step(cfg, params, cache, fed[:, :1])
            torch.cuda.synchronize()
        counts["decode_1"], wire["decode_1"] = launches(), wire_stats()
        instances["decode_1"] = dict(ragged_gemm_cuda.launches_by_instance)
        logits_all.append(logits.float())
        kops.reset_kernel_launches()
        reset_wire_stats()
        t0 = time.perf_counter()
        for i in range(1, n_dec):
            logits, cache = lm.decode_step(cfg, params, cache,
                                           fed[:, i:i + 1])
            logits_all.append(logits.float())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / (n_dec - 1) * 1e3
        counts["decode_rest"], wire["decode_rest"] = launches(), \
            wire_stats()
        instances["decode_rest"] = dict(
            ragged_gemm_cuda.launches_by_instance)
        n = cfg.n_layers
        pre_routes = ep_routes(pre, n, 1)
        dec_routes = routes_np(dec, n * n_dec, layer0_logits=False)
    del pre, dec
    checked_s = time.perf_counter() - t_checked
    # the time: a prefill with the wire synced (its ms and the wire's)
    with ep, torch.no_grad():
        torch.cuda.synchronize()
        reset_wire_stats(timing=True)
        t0 = time.perf_counter()
        lm.prefill(cfg, params, prompt, cap)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        wire["prefill_timed"] = wire_stats()
    # the no-drop check: layer 0's MoE alone through the manual path
    cfg_e, x = ep_einsum_cfg(spec), ep_einsum_input(spec, dev)
    with ep, torch.no_grad(), record_manual_routing() as calls:
        took = M._manual_ok(cfg_e, x.shape[1], ep)
        out, aux = M.moe_layer(cfg_e, ep_layer0_moe(params), x)
    j, sl = ep.index("model"), x.shape[1] // int(ep.shape["model"])
    einsum_case = dict(took=took, aux=float(aux),
                       out=out[:, j * sl:(j + 1) * sl].float().cpu().numpy(),
                       logits=calls[0][0].cpu().numpy(),
                       ids=calls[0][1].cpu().numpy(), calls=len(calls),
                       cs=M.manual_capacity(cfg_e, x.shape[0] * sl))
    del x, out, calls
    reset_wire_stats()
    checks = [{k: v for k, v in c.items() if k != "inputs"}
              for c in pre_calls + dec_calls]
    res = dict(logits=torch.stack(logits_all).cpu().numpy(), counts=counts,
               einsum_case=einsum_case,
               instances=instances, checks=checks, wire=wire, init_s=init_s,
               prefill_ms=prefill_ms, decode_ms=decode_ms,
               pre_routes=pre_routes, dec_routes=dec_routes,
               checked_s=checked_s,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else 0.0)
    del params, cache, pre_calls, dec_calls
    torch.cuda.empty_cache()
    return res


def ep_rank(mesh, spec) -> dict:
    """One of phase 19's sixteen ranks (``dist.run_ranks``' body): the
    kernels phase 1 built loaded, none built; (a) then (b) under the
    whole-attention rules."""
    import torch
    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import use_rules
    from repro_torch.kernels.build import build_kernels
    if build_kernels():
        raise AssertionError("a rank built kernels: the parent builds them")
    wait_s = dg_wait_for(spec["go"], spec["go"])    # the oracle freed
    with use_rules(spec["rules"]):
        t0 = time.perf_counter()
        train = ep_train_case(mesh, spec)
        t1 = time.perf_counter()
        serve = ep_serve_case(mesh, spec)
    return dict(coords=(mesh.index("data"), mesh.index("model")),
                backend=mesh.backend, device=str(mesh.device),
                train=train, serve=serve, train_s=t1 - t0,
                serve_s=time.perf_counter() - t1, t_enter=t_enter,
                wait_s=wait_s)


def ep_flips(ranks: list, want: dict, n_layers: int) -> tuple:
    """Each rank's routing changes against the oracle's virtual rank, layer
    by layer (``want``'s calls are layer-major, EP_RANKS a layer), and the
    first layer's near-tie check on every rank (phase 18's rule). ->
    (flip masks [layer][rank], the first layer's worst margin and largest
    logit difference)."""
    flips = [[tp_flips(r["ids"][l], want["ids"][l * EP_RANKS + j])
              for j, r in enumerate(ranks)] for l in range(n_layers)]
    worst, delta = 0.0, 0.0
    for j, r in enumerate(ranks):
        f = flips[0][j]
        diff = np.abs(r["logits"][0] - want["logits"][j]).max(-1)
        d = float(diff[~f].max()) if (~f).any() else 0.0
        w = float(want["margins"][j][f].max()) if f.any() else 0.0
        if f.any() and not w <= 2 * d:
            raise AssertionError(f"phase 19: rank {j}'s first-layer routing "
                                 f"changed at a top-k margin of {w:.3e}, "
                                 f"past twice its router logits' largest "
                                 f"difference {d:.3e}")
        worst, delta = max(worst, w), max(delta, d)
    return flips, worst, delta


def ep_train_checks(ranks: list, dig: dict, cfg, lr: float) -> dict:
    """(a)'s checks against the oracle (the bounds above)."""
    want_counts = {"ragged_gemm": 0, "flash_attention": 2 * cfg.n_layers,
                   "flash_attention_bwd": cfg.n_layers}
    for r, t in enumerate(ranks):
        if t["counts"] != want_counts:
            raise AssertionError(f"phase 19 (a) rank {r} launched "
                                 f"{t['counts']}, want {want_counts}")
        if t["replicated"] != [True] * (1 + EP_MORE_STEPS):
            raise AssertionError(f"phase 19 (a): the whole leaves parted "
                                 f"across the ranks: {t['replicated']}")
        if t["loss"] != ranks[0]["loss"] or \
                t["losses"] != ranks[0]["losses"]:
            raise AssertionError("phase 19 (a): the ranks' losses differ")
    for got, want in zip(ranks[0]["losses"], dig["losses"]):
        if not abs(got - want) <= TP_LOSS_TOL * abs(want):
            raise AssertionError(f"phase 19 (a): losses {ranks[0]['losses']}"
                                 f" against the oracle's {dig['losses']} "
                                 f"(tolerance {TP_LOSS_TOL} of it)")
    flips, margin, delta = ep_flips([t["routes"] for t in ranks],
                                    dig["routes"], cfg.n_layers)
    f = float(np.mean([x.mean() for row in flips for x in row]))
    bound = TP_GRAD_BASE + 2 * f ** 0.5
    worst = leaf_checks([t["leaves"] for t in ranks], dig["leaves"], lr,
                        bound, "phase 19 (a)")
    return dict(loss=ranks[0]["loss"], loss_oracle=dig["losses"][0],
                losses=ranks[0]["losses"], losses_oracle=dig["losses"],
                flips_by_layer=[int(sum(x.sum() for x in row))
                                for row in flips], flipped_share=f,
                worst_flip_margin=margin, max_logit_diff=delta,
                grad_bound=bound, **worst)


def ep_serve_checks(ranks: list, sd: dict, cfg) -> dict:
    """(b)'s checks against the oracle (the bounds above)."""
    n, n_dec = cfg.n_layers, len(sd["logits"]) - 1
    want_counts = {"prefill": {"ragged_gemm": 0, "flash_attention": n},
                   "decode_1": {"ragged_gemm": 3 * n, "flash_attention": 0},
                   "decode_rest": {"ragged_gemm": 3 * n * (n_dec - 1),
                                   "flash_attention": 0}}
    for r, s in enumerate(ranks):
        if s["counts"] != want_counts or any(
                by != {"wgmma": want_counts[run]["ragged_gemm"], "wmma": 0,
                       "f32": 0} for run, by in s["instances"].items()):
            raise AssertionError(f"phase 19 (b) rank {r}: launches "
                                 f"{s['counts']} by instance "
                                 f"{s['instances']}, want {want_counts}, "
                                 "every ragged launch wgmma")
        if not np.array_equal(s["logits"], ranks[0]["logits"]):
            raise AssertionError("phase 19 (b): the ranks' logits differ")
        for key in ("ids", "margins"):
            if any(not np.array_equal(a, b) for a, b in zip(
                    s["dec_routes"][key], ranks[0]["dec_routes"][key])):
                raise AssertionError("phase 19 (b): the ranks routed the "
                                     "decode steps differently")
    got, want = ranks[0]["logits"][:, :, 0], sd["logits"][:, :, 0]
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"phase 19 (b): logits {got.shape}, want "
                             f"{want.shape}, finite {np.isfinite(got).all()}")
    flips, margin, delta = ep_flips([s["pre_routes"] for s in ranks],
                                    sd["pre_routes"], n)
    f_ctx = float(np.mean([x.mean() for row in flips for x in row]))
    b = got.shape[1]
    # a row's own routing: the prompt's last position (the last rank's
    # block, each batch row's last token), then each decode step's
    own = np.zeros((n_dec + 1, b), bool)
    for l in range(n):
        last = flips[l][EP_RANKS - 1]
        own[0] |= last.reshape(b, -1)[:, -1]
    dec, wdec = ranks[0]["dec_routes"]["ids"], sd["dec_routes"]["ids"]
    for step in range(n_dec):
        for l in range(n):
            own[step + 1] |= tp_flips(dec[step * n + l], wdec[step * n + l])
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    bound = TP_ROW_BASE + 2 * f_ctx
    clean = err[~own]
    if own.mean() > TP_FLIPPED_ROWS or (clean.size and
                                         not clean.max() <= bound):
        raise AssertionError(f"phase 19 (b): {int(own.sum())} of {own.size} "
                             f"rows changed experts (at most "
                             f"{TP_FLIPPED_ROWS}); the others' worst "
                             f"max|diff| / max|row| "
                             f"{clean.max() if clean.size else 0:.3e} "
                             f"(bound {bound:.3e})")
    return dict(prefill_flips_by_layer=[int(sum(x.sum() for x in row))
                                        for row in flips],
                context_flipped_share=f_ctx, worst_flip_margin=margin,
                max_logit_diff=delta, rows=int(own.size),
                rows_own_flip=int(own.sum()), row_bound=bound,
                worst_clean_row=float(clean.max()) if clean.size else 0.0,
                worst_flipped_row=float(err[own].max()) if own.any()
                else 0.0,
                median_clean_row=float(np.median(clean)) if clean.size
                else 0.0)


def ep_einsum_check(ranks: list, want: dict, cfg) -> dict:
    """The no-drop check in the parent (the bounds above): every rank took
    the manual path and dropped nothing, the ranks' aux losses equal;
    against the one-card einsum route, each token's row, its routing and
    the aux loss."""
    k, e = cfg.top_k, cfg.n_experts
    b, s = want["out"].shape[:2]
    sl = s // len(ranks)
    ids_w = np.sort(want["ids"].reshape(b, s, k), -1)
    logits_w = want["logits"].reshape(b, s, e)
    margin = want["margin"].reshape(b, s)
    flipped, delta, outs = np.zeros((b, s), bool), 0.0, []
    for j, r in enumerate(ranks):
        c = r["einsum_case"]
        load = int(np.bincount(c["ids"].ravel(), minlength=e).max())
        if not c["took"] or c["calls"] != 1 or load > c["cs"] or \
                c["aux"] != ranks[0]["einsum_case"]["aux"]:
            raise AssertionError(
                f"phase 19 no-drop check, rank {j}: manual path {c['took']} "
                f"({c['calls']} routings), {load} picks of one peer against "
                f"{c['cs']} slots, aux {c['aux']} against rank 0's "
                f"{ranks[0]['einsum_case']['aux']}")
        blk = slice(j * sl, (j + 1) * sl)
        f = (np.sort(c["ids"].reshape(b, sl, k), -1) != ids_w[:, blk]).any(-1)
        d = float(np.abs(c["logits"].reshape(b, sl, e)
                         - logits_w[:, blk]).max())
        if f.any() and not float(margin[:, blk][f].max()) <= 2 * d:
            raise AssertionError(
                f"phase 19 no-drop check, rank {j}: {int(f.sum())} tokens "
                f"routed otherwise than the einsum route, at a top-k logit "
                f"margin up to {float(margin[:, blk][f].max()):.3e}, past "
                f"twice the logits' largest difference {d:.3e}")
        flipped[:, blk], delta = f, max(delta, d)
        outs.append(c["out"])
    got, ref = np.concatenate(outs, 1), want["out"]
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"phase 19 no-drop check: output {got.shape}, "
                             f"want {ref.shape}")
    err = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1),
                                                 1e-30)
    clean = err[~flipped]
    n = b * s
    aux_bound = EP_EINSUM_AUX_TOL * abs(want["aux"]) + \
        2 * e * int(flipped.sum()) * want["me_max"] / n
    aux = ranks[0]["einsum_case"]["aux"]
    if (clean.size and not clean.max() <= EP_EINSUM_ROW_TOL) or \
            not abs(aux - want["aux"]) <= aux_bound:
        raise AssertionError(
            f"phase 19 no-drop check: the manual path against the einsum "
            f"route, worst row max|diff| / max|row| "
            f"{clean.max() if clean.size else 0:.3e} (tolerance "
            f"{EP_EINSUM_ROW_TOL:.3e}), aux {aux} against {want['aux']} "
            f"(bound {aux_bound:.3e})")
    return dict(rows=int(n), rows_flipped=int(flipped.sum()),
                worst_row=float(clean.max()) if clean.size else 0.0,
                median_row=float(np.median(clean)) if clean.size else 0.0,
                row_tol=EP_EINSUM_ROW_TOL, aux=aux, aux_einsum=want["aux"],
                aux_rel=abs(aux - want["aux"]) / abs(want["aux"]),
                aux_bound=aux_bound, max_logit_diff=delta,
                slots_a_peer=ranks[0]["einsum_case"]["cs"])


def ep_checks(eps: list, spec: dict, dig: dict, sd: dict) -> dict:
    """Phase 19's checks in the parent, on what the sixteen ranks
    returned, against the oracle's digests."""
    cfg, cfg4 = spec["train_cfg"], spec["serve_cfg"]
    on = "cuda:0" if DEVICE == "cuda" else DEVICE
    if [t["coords"] for t in eps] != [(0, j) for j in range(EP_RANKS)] or \
            any((t["backend"], t["device"]) != ("gloo", on) for t in eps):
        got = [(t["coords"], t["backend"], t["device"]) for t in eps]
        raise AssertionError(f"phase 19: ranks {got}")
    train = ep_train_checks([t["train"] for t in eps], dig, cfg, 3e-4)
    serve = ep_serve_checks([t["serve"] for t in eps], sd, cfg4)
    einsum = ep_einsum_check([t["serve"] for t in eps], sd["einsum"], cfg4)
    b, s = spec["train_batch"], spec["train_seq"]
    pb, ps = spec["batch"], spec["prompt"]
    wire = {}
    for r, t in enumerate(eps):
        w = t["serve"]["wire"]
        wire[r] = dict(
            train=tp_wire_check(t["train"]["wire"], ep_wire_bytes(
                cfg, b, s, EP_RANKS, "train"), "phase 19 train step 0"),
            train_timed=tp_wire_check(t["train"]["wire_timed"],
                                      ep_wire_bytes(cfg, b, s, EP_RANKS,
                                                    "train"),
                                      "phase 19 a timed train step"),
            prefill=tp_wire_check(w["prefill"], ep_wire_bytes(
                cfg4, pb, ps, EP_RANKS, "prefill"), "phase 19 prefill"),
            prefill_timed=tp_wire_check(w["prefill_timed"], ep_wire_bytes(
                cfg4, pb, ps, EP_RANKS, "prefill"),
                "phase 19 a timed prefill"),
            decode=tp_wire_check(w["decode_1"], ep_wire_bytes(
                cfg4, pb, 1, EP_RANKS, "decode"), "phase 19 decode step"),
            decode_rest=tp_wire_check(w["decode_rest"], (spec["decode"] - 1)
                                      * ep_wire_bytes(cfg4, pb, 1, EP_RANKS,
                                                      "decode"),
                                      "phase 19 decode steps"))
    checks = [c for t in eps for c in t["train"]["checks"] +
              t["serve"]["checks"]]
    worst, worst_abs = {}, {}
    for c in checks:
        worst[c["name"]] = max(worst.get(c["name"], 0.0), c["err_over_max"])
        worst_abs[c["name"]] = max(worst_abs.get(c["name"], 0.0),
                                   c["max_abs_err"])
    launches_ep = {}
    for t in eps:
        for name, v in t["train"]["counts"].items():
            launches_ep[name] = launches_ep.get(name, 0) + v
        for run in t["serve"]["counts"].values():
            for name, v in run.items():
                launches_ep[name] = launches_ep.get(name, 0) + v
    step_ms = [t["train"]["step_ms"] for t in eps]
    times = dict(
        step_ms=step_ms,
        step_exchange_share=[wire[r]["train_timed"]["exchange_ms"]
                             / t["train"]["step_ms"][-1]
                             for r, t in enumerate(eps)],
        step_wire_share=[wire[r]["train_timed"]["ms"]
                         / t["train"]["step_ms"][-1]
                         for r, t in enumerate(eps)],
        prefill_ms=[t["serve"]["prefill_ms"] for t in eps],
        prefill_wire_ms=[wire[r]["prefill_timed"]["ms"] for r in wire],
        prefill_exchange_ms=[wire[r]["prefill_timed"]["exchange_ms"]
                             for r in wire],
        decode_ms=[t["serve"]["decode_ms"] for t in eps],
        init_s=[(t["train"]["init_s"], t["serve"]["init_s"]) for t in eps],
        train_split_s=[dict(step0=t["train"]["step0_s"],
                            samples=t["train"]["samples_s"],
                            replicas=t["train"]["replicas_s"]) for t in eps],
        serve_checked_s=[t["serve"]["checked_s"] for t in eps],
        train_timeline=eps[0]["train"]["timeline"],
        train_s=[t["train_s"] for t in eps],
        serve_s=[t["serve_s"] for t in eps],
        peak_gb=[dict(draw=t["train"]["draw_gb"],
                      train=t["train"]["peak_gb"],
                      serve=t["serve"]["peak_gb"]) for t in eps])
    return dict(train=train, serve=serve, einsum=einsum, wire=wire,
                times=times, worst_err_over_max=worst,
                worst_abs_err=worst_abs, launches_ep=launches_ep,
                checks=len(checks))


def ep_phase() -> dict:
    """Phase 19: the manual expert-parallel MoE on sixteen model ranks of
    the one card (gloo, spawned as in phases 16 and 17). The ranks start
    (imports, their card contexts, the rendezvous) beside the parent's
    one-card oracle and wait for its go file, written once the oracle is
    freed; then they (:func:`ep_rank`) train and serve, and the parent
    checks what they return. Raises on the first failed check."""
    import torch
    from repro_torch.dist import run_ranks
    t_phase = time.perf_counter()
    spec = ep_spec()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    go = Path(spec["go"])
    files = (go, Path(f"{go}.failed"), Path(spec["train_digest"]),
             Path(spec["serve_digest"]))
    for f in files:
        f.unlink(missing_ok=True)
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    card = dict(parent_allocated_gb=torch.cuda.memory_allocated() / 1e9,
                parent_reserved_gb=torch.cuda.memory_reserved() / 1e9,
                host_available_gb=host_available_gb())
    if DEVICE == "cuda":
        free, total = torch.cuda.mem_get_info()
        card.update(free_gb=free / 1e9, total_gb=total / 1e9)
    t_spawn = time.time()
    t_ranks = time.perf_counter()
    box: dict = {}

    def start_ranks():
        try:
            box["ranks"] = run_ranks(ep_rank, EP_RANKS, str(build),
                                     device=DEVICE, timeout_s=EP_TIMEOUT_S,
                                     args=(spec,), model=EP_RANKS)
        except BaseException as exc:        # re-raised below
            box["error"] = exc

    helper = threading.Thread(target=start_ranks, name="ep-ranks")
    helper.start()
    try:
        try:
            oracle = ep_oracle(spec)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            go.touch()                      # the ranks draw and run now
        except BaseException:
            Path(f"{go}.failed").touch()    # the waiting ranks stop
            raise
        finally:
            helper.join()
        if "error" in box:
            raise box["error"]
        eps = box["ranks"]
        ranks_s = time.perf_counter() - t_ranks
        dig = torch.load(spec["train_digest"], weights_only=False)
        sd = torch.load(spec["serve_digest"], weights_only=False)
    finally:
        for f in files:
            f.unlink(missing_ok=True)
    log(f"(19) the one-card oracle (moe_manual_reference for a 'model' axis "
        f"of {EP_RANKS}, beside the ranks' start): train "
        f"{oracle['train_s']:.1f} s, losses {oracle['losses']}; serve "
        f"{oracle['serve_s']:.1f} s")
    ep = ep_checks(eps, spec, dig, sd)
    ep.update(oracle=oracle, ranks_s=ranks_s, card_at_start=card,
              start_s=[round(t["t_enter"] - t_spawn, 1) for t in eps],
              wait_s=[round(t["wait_s"], 1) for t in eps],
              seconds=time.perf_counter() - t_phase)
    ep_log(ep)
    return ep


def ep_log(ep: dict) -> None:
    tr, sv, tm = ep["train"], ep["serve"], ep["times"]
    w0, split = ep["wire"][0], tm["train_split_s"]
    log(f"phase 19 (a) phi3.5-moe x {EP_TRAIN_LAYERS} layer on a 'model' "
        f"axis of {EP_RANKS}, the MoE through the manual path, "
        f"{EP_TRAIN_BATCH} x {EP_TRAIN_SEQ} tokens: losses {tr['losses']} "
        f"against the oracle's {tr['losses_oracle']} (tolerance "
        f"{TP_LOSS_TOL} of it); routing changes by layer "
        f"{tr['flips_by_layer']} (share {tr['flipped_share']:.5f}; worst "
        f"margin {tr['worst_flip_margin']:.3e}, largest router-logit "
        f"difference {tr['max_logit_diff']:.3e}); gradients' worst "
        f"relative L2 {tr['grad_rel_l2']:.3e}, norm "
        f"{tr['grad_norm_rel']:.3e} (bound {tr['grad_bound']:.3e}); updates "
        f"{tr['update_over_bound']:.3f} of 2 lr (1 + 2^-7) + 2 ulps; the "
        f"initial slices the oracle's bits; whole leaves bitwise on all "
        f"{EP_RANKS} ranks after {1 + EP_MORE_STEPS} steps")
    log(f"phase 19 (b) phi3.5-moe x {EP_SERVE_LAYERS} layers: prefill of "
        f"{EP_BATCH} x {EP_PROMPT} through the manual path, {EP_DECODE} "
        f"decode steps through the split einsum; rows with a routing change "
        f"of their own {sv['rows_own_flip']} of {sv['rows']}; the others' "
        f"worst max|diff| / max|row| {sv['worst_clean_row']:.3e}, median "
        f"{sv['median_clean_row']:.3e} (bound {sv['row_bound']:.3e}); "
        f"prefill routing changes by layer {sv['prefill_flips_by_layer']}")
    ei = ep["einsum"]
    log(f"phase 19 no-drop check: layer 0's MoE through the manual path on "
        f"the {EP_RANKS} ranks ({ei['slots_a_peer']} slots a peer, capacity "
        f"factor {EP_EINSUM_CF}) against the einsum route on one card: "
        f"tokens routed otherwise {ei['rows_flipped']} of {ei['rows']} "
        f"(router logits' largest difference {ei['max_logit_diff']:.3e}); "
        f"the others' worst max|diff| / max|row| {ei['worst_row']:.3e}, "
        f"median {ei['median_row']:.3e} (tolerance {ei['row_tol']:.3e}); "
        f"aux {ei['aux']} against {ei['aux_einsum']} (relative "
        f"{ei['aux_rel']:.3e}, bound {ei['aux_bound']:.3e})")
    log(f"phase 19 kernels: {ep['checks']} launches held against their "
        f"plain versions (worst max|diff| / max|plain| "
        f"{ep['worst_err_over_max']}, tolerance {LM_TOL}); launches "
        f"{ep['launches_ep']}")
    log(f"phase 19 wire, rank 0 (= ep_wire_bytes on every rank): train step "
        f"{w0['train']['bytes']} bytes in {w0['train']['calls']} calls, "
        f"{w0['train']['exchange_bytes']} of them the exchanges; prefill "
        f"{w0['prefill']['bytes']} ({w0['prefill']['exchange_bytes']}); "
        f"decode step {w0['decode']['bytes']}")
    log(f"phase 19 times: step ms "
        f"{[[round(x, 1) for x in r] for r in tm['step_ms']]}; the "
        f"exchanges' share of "
        f"the synced step {[round(x, 3) for x in tm['step_exchange_share']]}"
        f", the wire's {[round(x, 3) for x in tm['step_wire_share']]}; "
        f"prefill ms {[round(x, 1) for x in tm['prefill_ms']]} (wire "
        f"{[round(x, 1) for x in tm['prefill_wire_ms']]}, exchanges "
        f"{[round(x, 1) for x in tm['prefill_exchange_ms']]}); decode ms a "
        f"step {[round(x, 2) for x in tm['decode_ms']]}; init s (train, "
        f"serve) {[(round(a, 1), round(b, 1)) for a, b in tm['init_s']]}; "
        f"train s {[round(x, 1) for x in tm['train_s']]} (step 0, the "
        f"samples, the replica checks: "
        f"{[tuple(round(v, 1) for v in d.values()) for d in split]}"
        f"), "
        f"rank 0's train timeline (s) {tm['train_timeline']}; "
        f"serve s {[round(x, 1) for x in tm['serve_s']]} (the checked "
        f"prefill and decode steps "
        f"{[round(x, 1) for x in tm['serve_checked_s']]}); peak GB a rank "
        f"(train draw, train steps, serve with its draw) "
        f"{[tuple(round(v, 2) for v in p.values()) for p in tm['peak_gb']]}"
        f"; ranks started "
        f"{ep['start_s']} s after the spawn and waited {ep['wait_s']} s for "
        f"the oracle, {ep['ranks_s']:.1f} s in all; the card at the spawn "
        f"{ {k: round(v, 2) for k, v in ep['card_at_start'].items()} }; "
        f"phase {ep['seconds']:.1f} s")


# --------------------------------------------------------------------------
# phase 17: distributed GNN message passing, four ranks on the one card
# --------------------------------------------------------------------------

DG_RANKS = 4            # four ranks on cuda:0: NCCL refuses them, gloo carries
DG_K = 256              # the width of phases 8 and 9 (K = D)
DG_SELL_C = 8           # the measured tuner's pick on reddit (phase 11)
DG_ELL_SCALES = (1, 1 / 2, 1 / 4, 1 / 8)
DG_ELL_BUDGET = 40e9    # bytes of the four ELL tiles side by side on the card
DG_RING_N = 8192        # the ring's dense case: A (8,192 x 8,192) @ H (., K)
DG_TIMED = 3            # timed calls an op (the median is kept)
DG_TIMEOUT_S = 300.0    # the rank helper's join limit for the four ranks
DG_RTOL, DG_ATOL = 1e-5, 1e-6   # fp32 sums reordered across the ranks
DG_ELL_ROWS = 256       # ELL tile rows held against the plain version
DG_SEEDS = dict(h=171, x=172, y=173, g=174, he=175, ring_a=176, ring_h=177)
DG_EDGE_OPS = ("softmax", "sigmoid", "none")


def dg_matrix(name: str, n: int, k: int):
    """Phase 17's input ``name`` (``DG_SEEDS``), made on the host from its
    seed: every rank makes the same and takes its rows."""
    import torch
    gen = torch.Generator().manual_seed(DG_SEEDS[name])
    return torch.randn((n, k), generator=gen, dtype=torch.float32)


def coo_arrays(coo) -> dict:
    """A COO's real entries as numpy arrays and its sizes (pickles as
    bytes)."""
    return dict(row=coo.row[: coo.nse].numpy(), col=coo.col[: coo.nse].numpy(),
                val=coo.val[: coo.nse].numpy(), nrows=coo.nrows,
                ncols=coo.ncols)


def coo_of(arrays: dict):
    """The COO of :func:`coo_arrays` (already sorted by row and column)."""
    import torch
    from repro_torch.core import sparse as sp
    n = int(arrays["row"].shape[0])
    return sp.COO(row=torch.from_numpy(arrays["row"]),
                  col=torch.from_numpy(arrays["col"]),
                  val=torch.from_numpy(arrays["val"]),
                  nrows=arrays["nrows"], ncols=arrays["ncols"], nse=n)


def dg_tolerance(want, scale: float):
    """Phase 17's stated per-element tolerance: rtol 1e-5 and atol 1e-6 x
    max(1, max|ref|) (fp32 sums reordered across the ranks)."""
    return DG_RTOL * want.abs() + DG_ATOL * max(1.0, scale)


def dg_compare(got, want, scale: float, extra=None, bound=None) -> dict:
    """``got`` (a rank's piece) against ``want`` (the same rows of the
    one-card result). Every case reports its worst ratio to the stated
    tolerance (:func:`dg_tolerance`); it passes within that tolerance
    plus ``extra`` (the compressed wire's quanta), or, where ``bound`` is
    given, within ``bound``: the repo's bound for that kind of result
    (FusedMM and its gradients: ``FUSED_TOL`` / ``GRAD_TOL`` of the
    largest element, as phases 6 and 9 hold them, where a score's fp32
    rounding passes through ``exp``; a dense product: two fp32 sums of d
    terms, 2 d eps sum|terms|)."""
    import torch
    got = got.float()
    err = (got - want).abs()
    stated = dg_tolerance(want, scale)
    tol = stated + (0.0 if extra is None else extra) if bound is None \
        else bound
    finite = bool(torch.isfinite(got).all())
    if not err.numel():
        return dict(max_abs_err=0.0, max_err_over_stated=0.0,
                    max_err_over_tol=0.0, finite=finite, ok=finite)
    return dict(max_abs_err=float(err.max()),
                max_err_over_stated=float((err / stated).max()),
                max_err_over_tol=float((err / tol).max()),
                finite=finite, ok=bool((err <= tol).all()) and finite)


def dg_timed(fn, dev) -> dict:
    """Median of ``DG_TIMED`` calls of ``fn``: CUDA events around each
    call, and the wire's ms (the collectives' host time, the device
    synced before and after each; ``wire_stats``) separated out."""
    import torch
    from repro_torch.dist import reset_wire_stats, wire_stats
    ms, wire = [], []
    for _ in range(DG_TIMED):
        reset_wire_stats(timing=True)
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize(dev)
        ms.append(e0.elapsed_time(e1))
        wire.append(sum(v["ms"] for v in wire_stats().values()))
    reset_wire_stats()
    m, w = float(np.median(ms)), float(np.median(wire))
    return dict(ms=m, wire_ms=w, compute_ms=m - w, all_ms=ms)


def dg_kernel_checks(tile, tile_e, hg, hg_e, xg, yg, dout, rng) -> list:
    """Each kernel of the ranks' path launched once on this rank's own
    operands (the SELL tile at K, kernel E over the tile's slots, kernel S
    over its column order; the ELL tile's launch held on ``DG_ELL_ROWS``
    of its rows, the widest among them) against its plain version on the
    same card tensors, with phase 4's per-row bounds."""
    import torch
    from repro_torch.kernels import segment_sum as kseg
    from repro_torch.kernels.edge_dots import edge_dots_cuda
    from repro_torch.kernels.ell_spmm import ell_spmm_cuda
    out = []
    err, d, ratio = check_kernel("sell_spmm", tile.op, hg, "tile")
    out.append(dict(name="sell_spmm", shape=f"tile {tile.op.n_steps} x "
                    f"{tile.op.c} steps, K {hg.shape[1]}", max_abs_err=err,
                    max_err_over_bound=ratio, width=d))
    full = ell_spmm_cuda(tile_e.op, hg_e)
    deg = (tile_e.op.idx < tile_e.op.ncols).sum(1)
    rows = torch.cat([torch.topk(deg, DG_ELL_ROWS // 4).indices,
                      torch.from_numpy(rng.choice(
                          tile_e.op.nrows, DG_ELL_ROWS - DG_ELL_ROWS // 4,
                          replace=False)).to(deg.device)])
    sub = dataclasses.replace(tile_e.op, idx=tile_e.op.idx[rows].contiguous(),
                              val=tile_e.op.val[rows].contiguous(),
                              nrows=int(rows.numel()))
    err, d, ratio = check_kernel("ell_spmm", sub, hg_e, "tile rows",
                                 out=full[rows])
    out.append(dict(name="ell_spmm", shape=f"tile {tile_e.op.nrows} x "
                    f"{tile_e.op.max_deg}, {DG_ELL_ROWS} rows held, K "
                    f"{hg_e.shape[1]}", max_abs_err=err,
                    max_err_over_bound=ratio, width=d))
    del full
    c = check_edge_dots(dict(args=(xg, yg, None, None), row=tile.rows,
                             col=tile.cols, out=(edge_dots_cuda(
                                 xg, yg, tile.rows, tile.cols),)),
                        "tile slots")
    out.append(dict(name="edge_dots", shape=f"{c['edges']} slots, D "
                    f"{c['d']}", max_abs_err=c["max_abs_err"],
                    max_err_over_bound=c["max_err_over_bound"]))
    order, w = tile.col_order, tile.weight
    got = kseg.segment_sum_sorted_cuda(dout, order.offsets, index=order.src,
                                       weight=w, weight_index=order.perm)
    want = kseg.segment_sum_sorted_plain(dout, order.offsets,
                                         index=order.src, weight=w,
                                         weight_index=order.perm)
    mag = kseg.segment_sum_sorted_plain(dout.abs(), order.offsets,
                                        index=order.src, weight=w.abs(),
                                        weight_index=order.perm)
    terms = torch.diff(order.offsets).to(torch.float32)[:, None]
    err = (got - want).abs()
    bound = 2 * EPS32 * terms * mag + 1e-30
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"segment_sum tile transpose: kernel disagrees "
                             f"with plain, max err {float(err.max())}")
    out.append(dict(name="segment_sum", shape=f"tile transpose, "
                    f"{order.perm.numel()} slots, K {dout.shape[1]}",
                    max_abs_err=float(err.max()),
                    max_err_over_bound=float((err / bound).max())))
    return out


def dg_wait_for(path, refs_file) -> float:
    """Seconds a rank waited for the parent's ``path``; raises when the
    parent marked its failure (``<refs_file>.failed``) or DG_TIMEOUT_S
    passed."""
    t0 = time.perf_counter()
    while not Path(path).exists():
        if Path(f"{refs_file}.failed").exists() or \
                time.perf_counter() - t0 > DG_TIMEOUT_S:
            raise AssertionError(f"no {path}: the parent failed or took "
                                 f"over {DG_TIMEOUT_S} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


PP_STAGES = 4           # the pipeline's stages: phase 17's four ranks
PP_WIDTH = 4096         # tanh(a @ w), w (4,096 x 4,096) fp32 a stage
PP_MICRO = 8            # microbatches
PP_BATCH = PP_MICRO * 64
PP_ATOL = 1e-5          # against the one-card composition (outputs in
#                         [-1, 1]): the reference test's own tolerance


def pp_case(dev) -> dict:
    """Phase 17's pipeline, in each of its four ranks: ``pipeline_apply``
    over a ``('pipe',)`` mesh of the four, PP_STAGES stages of ``tanh(a @
    w)`` at width PP_WIDTH (the fp32 stage stack drawn from a seed on
    every rank), PP_MICRO microbatches, the launch counts zeroed just
    before and read just after (the stages are plain products: no hand
    kernel runs); held to the sequential composition on the same card
    within PP_ATOL, the drained outputs bitwise equal on every rank."""
    import torch
    from repro_torch import dist as tdist
    from repro_torch.kernels import ops as kops
    pipe = tdist.make_pipe_mesh(device=DEVICE)
    g = torch.Generator(device=dev).manual_seed(20)
    w = torch.randn((PP_STAGES, PP_WIDTH, PP_WIDTH), generator=g,
                    device=dev) / PP_WIDTH ** 0.5
    x = torch.randn((PP_BATCH, PP_WIDTH), generator=g, device=dev)

    def stage(wi, a):
        return torch.tanh(a @ wi)

    with torch.no_grad():
        torch.cuda.synchronize(dev)
        kops.reset_kernel_launches()
        tdist.reset_wire_stats()
        t0 = time.perf_counter()
        y = tdist.pipeline_apply(stage, pipe, w, x, microbatches=PP_MICRO)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in kops.kernel_launches().items() if v}
        wire = tdist.wire_stats()
        ref = x
        for i in range(PP_STAGES):
            ref = stage(w[i], ref)
        err = float((y - ref).abs().max())
        same = tdist.replicas_equal({"y": y}, pipe, "pipe")
    return dict(max_abs_err=err, ms=ms, launches=launches, wire=wire,
                replicated=same, on_card=y.device == dev,
                shape=f"{PP_STAGES} stages x ({PP_BATCH}, {PP_WIDTH}) fp32, "
                      f"{PP_MICRO} microbatches")


def dg_rank(mesh, spec, graphs_file, refs_file) -> dict:
    """One rank of phase 17 (``dist.run_ranks``' body): its band and
    tiles built on the host and taken to its device, the main path run
    once with the launch counts zeroed just before and read just after
    (1-D SELL SpMM; the 2 x 2 SELL SpMM sum, mean and compressed; SDDMM;
    FusedMM's three edge ops and the softmax backward; the ring; the ELL
    tiles' SpMM), then each op timed, each result held against the
    one-card result's rows (``refs_file``, written by the parent), and
    each kernel against its plain version on this rank's operands.
    Returns numbers and flags only."""
    import pickle

    import torch
    from repro_torch import dist as tdist
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.build import build_kernels
    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    if build_kernels():
        raise AssertionError("a rank built kernels: the parent builds them")
    r, dev = mesh.index("data"), mesh.device
    grid = tdist.make_grid_mesh(device=DEVICE)
    p = grid.index("row") * grid.shape["col"] + grid.index("col")
    # the ranks start while the parent writes the graphs and then computes
    # the one-card results: each file is renamed into place when whole
    wait_s = dg_wait_for(graphs_file, refs_file)
    t0 = time.perf_counter()
    with open(graphs_file, "rb") as f:
        graphs = pickle.load(f)
    coo, coo_e = coo_of(graphs["scale1"]), coo_of(graphs["ell"])
    n, m, n_e = coo.nrows, coo.ncols, coo_e.nrows
    k = spec["k"]
    mats = {name: dg_matrix(name, *shape)
            for name, shape in (("h", (m, k)), ("x", (n, k)), ("y", (m, k)),
                                ("g", (n, k)), ("he", (n_e, k)))}
    nb = DG_RING_N // DG_RANKS
    ring_a = dg_matrix("ring_a", DG_RING_N, DG_RING_N)[r * nb:(r + 1) * nb]
    ring_h = dg_matrix("ring_h", DG_RING_N, k)[r * nb:(r + 1) * nb]
    load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sell = KernelPlan(kind="sell", sell_c=DG_SELL_C)
    geo1, band = tdist.build_band(coo, DG_RANKS, r, plan=sell, device=dev)
    grid2, tile = tdist.build_tile(coo, 2, 2, p, plan=sell, device=dev)
    h1 = tdist.shard_rows(mats["h"], DG_RANKS, r).to(dev)
    hc = tdist.col_shard(grid2, mats["h"], p).to(dev)
    xr = tdist.row_shard(grid2, mats["x"], p).to(dev)
    yc = tdist.col_shard(grid2, mats["y"], p).to(dev)
    gr = tdist.row_shard(grid2, mats["g"], p).to(dev)
    a_band, h_ring = ring_a.to(dev), ring_h.to(dev)
    # the graph-static slot lists and orders, built once (as a
    # CachedGraph's are) before the path runs
    _ = (tile.rows, tile.row_order, tile.col_order)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0

    outs, wires = {}, {}

    def case(name, fn):
        tdist.reset_wire_stats()
        outs[name] = fn()
        wires[name] = tdist.wire_stats()

    ring = (lambda: tdist.ring_allgather_matmul(
        lambda s: a_band[:, s * nb:(s + 1) * nb], h_ring, mesh, "data"))
    # -- the main path, counted -------------------------------------------
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_kernel_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for red in ("sum", "mean"):
            case(f"spmm1d_sell_{red}", lambda: tdist.distributed_spmm(
                band, h1, mesh, reduce=red))
            case(f"spmm2d_sell_{red}", lambda: tdist.distributed_spmm_2d(
                tile, hc, grid, reduce=red))
        case("spmm2d_sell_compressed", lambda: tdist.distributed_spmm_2d(
            tile, hc, grid, compress=True))
        case("sddmm", lambda: tdist.distributed_sddmm_2d(tile, xr, yc, grid))
        for op in DG_EDGE_OPS:
            case(f"fused_{op}", lambda: tdist.distributed_fusedmm_2d(
                tile, xr, yc, hc, grid, edge_op=op))
        case("ring", ring)
    leaves = [t.clone().requires_grad_() for t in (xr, yc, hc)]
    tdist.reset_wire_stats()
    tdist.distributed_fusedmm_2d(tile, *leaves, grid).backward(gr)
    wires["fused_softmax_bwd"] = tdist.wire_stats()
    outs.update(dx=leaves[0].grad, dy=leaves[1].grad, dh=leaves[2].grad)
    torch.cuda.synchronize(dev)
    sell_s = time.perf_counter() - t0
    t1 = time.perf_counter()     # the ELL tiles: built, then driven
    grid_e, tile_e = tdist.build_tile(coo_e, 2, 2, p, device=dev)
    hce = tdist.col_shard(grid_e, mats["he"], p).to(dev)
    torch.cuda.synchronize(dev)
    build_ell_s = time.perf_counter() - t1
    with torch.no_grad():
        for red in ("sum", "mean"):
            case(f"spmm2d_ell_{red}", lambda: tdist.distributed_spmm_2d(
                tile_e, hce, grid, reduce=red))
    torch.cuda.synchronize(dev)
    main_s = time.perf_counter() - t0
    launches = kops.kernel_launches()
    sell_routes = dict(kops._CUDA_WRAPPERS["sell_spmm"].launches_by_instance)
    peak_main = torch.cuda.max_memory_allocated(dev)

    # -- the bytes each op handed the backend, against comm_volume x 4 ------
    vol1 = 4 * tdist.comm_volume(geo1, k)["elements"]
    vol2 = 4 * tdist.comm_volume_2d(grid2, k)["elements"]
    vol_e = 4 * tdist.comm_volume_2d(grid_e, k)["elements"]
    wire_bytes_ok = {}
    for name, w in wires.items():      # (compressed: the amax's pmax aside)
        got = sum(v["bytes"] for op, v in w.items()
                  if op in ("all_gather", "psum_scatter"))
        want = (vol1 if name.startswith("spmm1d") else
                vol_e if name.startswith("spmm2d_ell") else
                vol2 if name.startswith("spmm2d") else None)
        if want is not None:
            wire_bytes_ok[name] = (got, want)
    staged = {name: sum(v["staged_bytes"] for v in w.values())
              for name, w in wires.items()}

    # -- timings (not counted) ----------------------------------------------
    timings = {}
    with torch.no_grad():
        timings["spmm1d_sell"] = dg_timed(lambda: tdist.distributed_spmm(
            band, h1, mesh), dev)
        timings["spmm2d_sell"] = dg_timed(lambda: tdist.distributed_spmm_2d(
            tile, hc, grid), dev)
        timings["spmm2d_sell_compressed"] = dg_timed(
            lambda: tdist.distributed_spmm_2d(tile, hc, grid, compress=True),
            dev)
        timings["spmm2d_ell"] = dg_timed(lambda: tdist.distributed_spmm_2d(
            tile_e, hce, grid), dev)
        timings["sddmm"] = dg_timed(lambda: tdist.distributed_sddmm_2d(
            tile, xr, yc, grid), dev)
        timings["fused_softmax"] = dg_timed(
            lambda: tdist.distributed_fusedmm_2d(tile, xr, yc, hc, grid),
            dev)
        timings["ring"] = dg_timed(ring, dev)

    def fwd_bwd():
        lv = [t.clone().requires_grad_() for t in (xr, yc, hc)]
        tdist.distributed_fusedmm_2d(tile, *lv, grid).backward(gr)
    timings["fused_softmax_fwd_bwd"] = dg_timed(fwd_bwd, dev)

    # -- every result against the one-card result's rows ---------------------
    checks = {}
    wait_s += dg_wait_for(refs_file, refs_file)  # built, run: now the refs
    refs = torch.load(refs_file, mmap=True, map_location="cpu")
    scale = refs["max_abs"]

    def rows_of(ref, lo, cnt, limit):
        hi = min(lo + cnt, limit)
        return ref[lo:max(hi, lo)].to(dev), max(hi - lo, 0)

    rp = geo1.rows_per_part
    for red in ("sum", "mean"):
        want, cnt = rows_of(refs[f"spmm_{red}"], r * rp, rp, n)
        checks[f"spmm1d_sell_{red}"] = dg_compare(
            outs[f"spmm1d_sell_{red}"][:cnt], want, scale[f"spmm_{red}"])
    nr = grid2.rows_per_tile // grid2.pc
    for red in ("sum", "mean"):
        want, cnt = rows_of(refs[f"spmm_{red}"], p * nr, nr, n)
        checks[f"spmm2d_sell_{red}"] = dg_compare(
            outs[f"spmm2d_sell_{red}"][:cnt], want, scale[f"spmm_{red}"])
    # the compressed wire: pc quanta of the shared grid (the max over the
    # column blocks of |partial product|), as the reference bounds it
    with torch.no_grad():
        part = kops.sell_spmm(tile.op, tdist.all_gather(hc, grid, "row"))
        amax = float(tdist.pmax(part.abs().amax().reshape(1), grid,
                                "col")[0])
    del part
    want, cnt = rows_of(refs["spmm_sum"], p * nr, nr, n)
    checks["spmm2d_sell_compressed"] = dg_compare(
        outs["spmm2d_sell_compressed"][:cnt], want, scale["spmm_sum"],
        extra=grid2.pc * amax / 127)
    checks["spmm2d_sell_compressed"]["quantum"] = amax / 127
    for op in DG_EDGE_OPS:
        want, cnt = rows_of(refs[f"fused_{op}"], p * nr, nr, n)
        checks[f"fused_{op}"] = dg_compare(
            outs[f"fused_{op}"][:cnt], want, scale[f"fused_{op}"],
            bound=FUSED_TOL * scale["h" if op == "softmax" else f"fused_{op}"])
    want, cnt = rows_of(refs["dx"], p * nr, nr, n)
    checks["dx"] = dg_compare(outs["dx"][:cnt], want, scale["dx"],
                              bound=GRAD_TOL * scale["dx"])
    i, j = divmod(p, grid2.pc)
    nc = grid2.cols_per_tile // grid2.pr
    for key in ("dy", "dh"):
        want, cnt = rows_of(refs[key], j * grid2.cols_per_tile + i * nc, nc,
                            m)
        checks[key] = dg_compare(outs[key][:cnt], want, scale[key],
                                 bound=GRAD_TOL * scale[key])
    # SDDMM: each real slot's score against the edge's, pad slots 0
    s = outs["sddmm"].reshape(-1)
    valid = tile.cols < tile.op.ncols
    keys = (i * grid2.rows_per_tile + tile.rows[valid].long()) * m + \
        j * grid2.cols_per_tile + tile.cols[valid].long()
    coo_keys = (coo.row.to(dev).long() * m + coo.col.to(dev).long())
    at = torch.searchsorted(coo_keys, keys).clamp(max=coo_keys.numel() - 1)
    found = bool((coo_keys[at] == keys).all())
    checks["sddmm"] = dg_compare(s[valid], refs["sddmm"].to(dev)[at],
                                 scale["sddmm"])
    checks["sddmm"].update(found=found, slots=int(valid.sum()),
                           pad_zero=bool((s[~valid] == 0).all()))
    checks["sddmm"]["ok"] &= found and checks["sddmm"]["pad_zero"]
    del coo_keys, at, keys
    want, cnt = rows_of(refs["ring"], r * nb, nb, DG_RING_N)
    mag, _ = rows_of(refs["ring_mag"], r * nb, nb, DG_RING_N)
    checks["ring"] = dg_compare(outs["ring"], want, scale["ring"],
                                bound=2 * DG_RING_N * EPS32 * mag + 1e-30)
    nr_e = grid_e.rows_per_tile // grid_e.pc
    for red in ("sum", "mean"):
        want, cnt = rows_of(refs[f"ell_{red}"], p * nr_e, nr_e, n_e)
        checks[f"spmm2d_ell_{red}"] = dg_compare(
            outs[f"spmm2d_ell_{red}"][:cnt], want, scale[f"ell_{red}"])
    on_card = all(t.device == dev for t in outs.values())
    del outs, refs

    # -- each kernel against its plain version on this rank's operands -------
    with torch.no_grad():
        hg = tdist.all_gather(hc, grid, "row")
        hg_e = tdist.all_gather(hce, grid, "row")
        xg = tdist.all_gather(xr, grid, "col")
        yg = tdist.all_gather(yc, grid, "row")
        kchecks = dg_kernel_checks(tile, tile_e, hg, hg_e, xg, yg,
                                   dg_matrix("g", tile.op.nrows, k).to(dev),
                                   np.random.default_rng(r))
    torch.cuda.synchronize(dev)
    pp = pp_case(dev)
    return dict(pp=pp,
        rank=r, tile=p, coords=(grid.index("row"), grid.index("col")),
        backend=mesh.backend, device=str(dev), t_enter=t_enter,
        load_s=load_s, wait_s=wait_s, build_s=build_s, build_ell_s=build_ell_s,
        sell_s=sell_s, main_s=main_s, launches=launches,
        sell_routes=sell_routes,
        peak_main_gb=peak_main / 1e9,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        wire_bytes=wire_bytes_ok, staged_bytes=staged,
        wires=wires,
        timings=timings, checks=checks, kernel_checks=kchecks,
        on_card=on_card, ell_tile=dict(rows=tile_e.op.nrows,
                                       width=tile_e.op.max_deg,
                                       bytes=tile_e.op.idx.numel() * 8),
        sell_tile=dict(steps=tile.op.n_steps, c=tile.op.c,
                       slots=int(valid.numel())),
        band=dict(steps=band.op.n_steps, rows=band.op.nrows))


def dg_ell_scale(ds) -> tuple:
    """The largest reddit scale of ``DG_ELL_SCALES`` whose four 2 x 2 ELL
    tiles (8 bytes a slot, padded to the widest in-tile degree) fit
    ``DG_ELL_BUDGET`` together and index in int32: (scale, its COO, the
    sizes considered)."""
    from repro_torch.data import make_dataset
    from repro_torch.dist import ell_tile_width
    sizes = []
    for scale in DG_ELL_SCALES:
        coo = ds.coo if scale == 1 else make_dataset("reddit",
                                                     scale=scale).coo
        grid, width = ell_tile_width(coo, 2, 2)
        slots = grid.rows_per_tile * width
        sizes.append(dict(scale=scale, nodes=coo.nrows, edges=coo.nse,
                          tile_rows=grid.rows_per_tile, tile_width=width,
                          tile_gb=slots * 8 / 1e9,
                          four_tiles_gb=4 * slots * 8 / 1e9))
        if 4 * slots * 8 <= DG_ELL_BUDGET and slots < 2 ** 31:
            return scale, coo, sizes
    raise AssertionError(f"no reddit scale's ELL tiles fit: {sizes}")


def dg_references(coo, coo_e, k) -> dict:
    """The one-card results phase 17's ranks are held against, on the
    card: SpMM by ``core.spmm`` on a ``CachedGraph`` (its trusted plan:
    the ordered segment sum), SDDMM by the plain per-edge dot product,
    FusedMM by ``kernels.ref.fusedmm_coo_ref`` and its autograd, the ring
    by one dense product. CPU tensors, and each one's max |value|."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.core.cache import build_cached_graph
    from repro_torch.core.spmm import spmm
    from repro_torch.kernels.ref import edge_dots, fusedmm_coo_ref
    dev = torch.device(DEVICE)
    n, m = coo.nrows, coo.ncols
    refs = {}
    for tag, a, h in (("spmm", coo, dg_matrix("h", m, k)),
                      ("ell", coo_e, dg_matrix("he", coo_e.nrows, k))):
        cg = build_cached_graph(a, plan=KernelPlan.trusted(), tune=False
                                ).to(dev)
        h = h.to(dev)
        for red in ("sum", "mean"):
            refs[f"{tag}_{red}"] = spmm(cg, h, red).cpu()
        del cg, h
    a = sp.to_device(coo, dev)
    x, y, h = (dg_matrix(name, rows, k).to(dev)
               for name, rows in (("x", n), ("y", m), ("h", m)))
    with torch.no_grad():
        s = edge_dots(x, y, a.row[: a.nse], a.col[: a.nse])
        refs["sddmm"] = (s * a.val[: a.nse]).cpu()
        for op in DG_EDGE_OPS:
            refs[f"fused_{op}"] = fusedmm_coo_ref(a, x, y, h,
                                                  edge_op=op).cpu()
    leaves = [t.clone().requires_grad_() for t in (x, y, h)]
    fusedmm_coo_ref(a, *leaves).backward(dg_matrix("g", n, k).to(dev))
    refs.update(dx=leaves[0].grad.cpu(), dy=leaves[1].grad.cpu(),
                dh=leaves[2].grad.cpu())
    del leaves, x, y, h, a
    ra = dg_matrix("ring_a", DG_RING_N, DG_RING_N).to(dev)
    rh = dg_matrix("ring_h", DG_RING_N, k).to(dev)
    refs["ring"] = (ra @ rh).cpu()
    refs["ring_mag"] = (ra.abs() @ rh.abs()).cpu()    # sum |terms| a row
    del ra, rh
    torch.cuda.empty_cache()
    refs["max_abs"] = {key: float(v.abs().max()) for key, v in refs.items()}
    refs["max_abs"]["h"] = float(dg_matrix("h", m, k).abs().max())
    return refs


def dg_phase(ds) -> dict:
    """Phase 17: distributed GNN message passing, four ranks on the one
    card (gloo, spawned as in phase 16). The parent picks the ELL scale,
    computes the one-card results and writes them and the graphs to
    files; the ranks (:func:`dg_rank`) run, check and time; the parent
    checks what they return. Raises on the first failed check."""
    import pickle

    import torch
    from repro_torch.dist import run_ranks
    t_phase = time.perf_counter()
    k = DG_K
    ell_scale, coo_e, sizes = dg_ell_scale(ds)
    cut = (f"ELL tiles on reddit at scale {ell_scale} ({coo_e.nrows} nodes, "
           f"{coo_e.nse} edges): the 2 x 2 ELL tiles pad every row to the "
           f"widest in-tile degree (R-MAT's hub), "
           + "; ".join(f"scale {s['scale']}: {s['tile_rows']} x "
                       f"{s['tile_width']} slots, {s['four_tiles_gb']:.1f} "
                       f"GB for four" for s in sizes)
           + f" (budget {DG_ELL_BUDGET / 1e9:.0f} GB, int32 slot ids); the "
             f"SELL bands and tiles, SDDMM, FusedMM run at scale 1")
    log(f"cut: {cut}")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    graphs_file, refs_file = build / "dg_graphs.pkl", build / "dg_refs.pt"
    for f in (graphs_file, refs_file):
        f.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the ranks start now, beside the parent's writing of the graphs and
    # its one-card results; each builds its pieces and runs once the
    # graphs are in place, and waits for the references only to check
    t_spawn = time.time()
    t_ranks = time.perf_counter()
    box: dict = {}

    def start_ranks():
        try:
            box["ranks"] = run_ranks(
                dg_rank, DG_RANKS, str(build), device=DEVICE,
                timeout_s=DG_TIMEOUT_S,
                args=(dict(k=k), str(graphs_file), str(refs_file)))
        except BaseException as exc:        # re-raised below
            box["error"] = exc

    helper = threading.Thread(target=start_ranks, name="dg-ranks")
    helper.start()
    try:
        t0 = time.perf_counter()
        part = build / "dg_graphs.pkl.part"
        with open(part, "wb") as f:
            pickle.dump(dict(scale1=coo_arrays(ds.coo),
                             ell=coo_arrays(coo_e)), f, protocol=5)
        part.replace(graphs_file)       # the ranks build their pieces now
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        refs = dg_references(ds.coo, coo_e, k)
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        part = build / "dg_refs.pt.part"
        torch.save(refs, part)
        part.replace(refs_file)
        write_s += time.perf_counter() - t0
        del refs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    except BaseException:
        Path(f"{refs_file}.failed").touch()  # the waiting ranks stop
        raise
    finally:
        helper.join()
        for f in (graphs_file, refs_file, Path(f"{refs_file}.failed"),
                  build / "dg_graphs.pkl.part", build / "dg_refs.pt.part"):
            f.unlink(missing_ok=True)
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    ranks_s = time.perf_counter() - t_ranks
    on = "cuda:0" if DEVICE == "cuda" else DEVICE
    failed = []
    for r, got in enumerate(ranks):
        if (got["rank"], got["tile"], got["backend"], got["device"]) != \
                (r, r, "gloo", on) or not got["on_card"]:
            failed.append(f"rank {r}: {got['backend']} on {got['device']}, "
                          f"tile {got['tile']}, on card {got['on_card']}")
        bad = {k: v for k, v in got["checks"].items() if not v["ok"]}
        if bad:
            failed.append(f"rank {r} disagrees with the one-card result: "
                          f"{bad}")
        wb = {k: v for k, v in got["wire_bytes"].items() if v[0] != v[1]}
        if wb:
            failed.append(f"rank {r}: bytes handed the backend against "
                          f"comm_volume x 4: {wb}")
        # gloo carries card tensors itself but for the ring's hops
        staged = {k: v for k, v in got["staged_bytes"].items()
                  if (v != 0) != (k == "ring" and DEVICE == "cuda")}
        if staged:
            failed.append(f"rank {r}: host-staged bytes where none (or "
                          f"where the ring's) were due: {staged}")
        missing = [kk for kk in ("sell_spmm", "ell_spmm", "edge_dots",
                                 "segment_sum") if got["launches"][kk] <= 0]
        if missing:
            failed.append(f"rank {r} launched no {missing}: "
                          f"{got['launches']}")
    pp_hops = PP_STAGES + PP_MICRO - 1
    for r, got in enumerate(ranks):
        pp = got["pp"]
        if not (pp["max_abs_err"] <= PP_ATOL and pp["replicated"]
                and pp["on_card"] and not pp["launches"]
                and pp["wire"]["ppermute"]["calls"] == pp_hops):
            failed.append(f"rank {r}: the pipeline {pp['max_abs_err']:.3e} "
                          f"off the one-card composition (atol {PP_ATOL}), "
                          f"replicated {pp['replicated']}, launches "
                          f"{pp['launches']}, hops "
                          f"{pp['wire']['ppermute']['calls']} (want "
                          f"{pp_hops})")
    launches_dist = {kk: sum(g["launches"][kk] for g in ranks)
                     for kk in ranks[0]["launches"]}
    worst = {}
    for g in ranks:
        for name, c in g["checks"].items():
            w = worst.setdefault(name, dict(max_abs_err=0.0,
                                            max_err_over_tol=0.0,
                                            max_err_over_stated=0.0))
            for kk in w:
                w[kk] = max(w[kk], c[kk])
    kworst = {}
    for g in ranks:
        for c in g["kernel_checks"]:
            w = kworst.setdefault(c["name"], dict(shape=c["shape"],
                                                  max_abs_err=0.0,
                                                  max_err_over_bound=0.0))
            w["max_abs_err"] = max(w["max_abs_err"], c["max_abs_err"])
            w["max_err_over_bound"] = max(w["max_err_over_bound"],
                                          c["max_err_over_bound"])
    times = {op: [round(g["timings"][op]["ms"], 3) for g in ranks]
             for op in ranks[0]["timings"]}
    wire_ms = {op: [round(g["timings"][op]["wire_ms"], 3) for g in ranks]
               for op in ranks[0]["timings"]}
    seconds = time.perf_counter() - t_phase
    split = {kk: [round(g[kk], 1) for g in ranks]
             for kk in ("wait_s", "load_s", "build_s", "sell_s",
                        "build_ell_s",
                        "main_s")}
    split["start_s"] = [round(g["t_enter"] - t_spawn, 1) for g in ranks]
    g0 = ranks[0]
    log(f"(17) four gloo ranks on {on} against the one-card result: worst "
        f"ratio to the stated tolerance (rtol {DG_RTOL}, atol {DG_ATOL} x "
        f"max(1, max|ref|)) "
        f"{ {kk: round(v['max_err_over_stated'], 3) for kk, v in worst.items()} }"
        f"; to the tolerance each case is held to (the stated one; "
        f"compressed: plus pc x amax / 127; FusedMM: FUSED_TOL x max|h| "
        f"(softmax) or max|ref|; gradients: GRAD_TOL x max|ref|; the ring: "
        f"2 d eps sum|terms|) "
        f"{ {kk: round(v['max_err_over_tol'], 3) for kk, v in worst.items()} }"
        f"; max |diff| "
        f"{ {kk: '%.3g' % v['max_abs_err'] for kk, v in worst.items()} }")
    log(f"(17) bytes a rank handed the backend = comm_volume x 4: "
        f"{ {kk: v[0] for kk, v in g0['wire_bytes'].items()} }; the ring's "
        f"hops staged through the host ({g0['staged_bytes']['ring']} bytes "
        f"a rank), nothing else staged")
    log(f"(17) ms a rank (CUDA events, median of {DG_TIMED}) {times}; of "
        f"it the wire {wire_ms}")
    log(f"(17) kernels against plain on the ranks' operands: {kworst}; "
        f"launches in the ranks {launches_dist}; SELL routes (rank 0) "
        f"{g0['sell_routes']}")
    log(f"(17) peak GB a rank: main path "
        f"{[round(g['peak_main_gb'], 2) for g in ranks]}, with the checks "
        f"{[round(g['peak_gb'], 2) for g in ranks]}; ELL tile "
        f"{g0['ell_tile']}, SELL tile {g0['sell_tile']}, band {g0['band']}")
    pps = [g["pp"] for g in ranks]
    log(f"(17) the pipeline ({pps[0]['shape']}) on the four ranks: max "
        f"|diff| to the one-card composition "
        f"{[float('%.3g' % p['max_abs_err']) for p in pps]} (atol "
        f"{PP_ATOL}), the outputs bitwise on every rank, {pp_hops} "
        f"host-staged hops a rank ({pps[0]['wire']['ppermute']['bytes']} "
        f"bytes); ms a rank {[round(p['ms'], 1) for p in pps]}; hand "
        f"kernels launched: none (plain products)")
    log(f"distributed GNN phase: {seconds:.1f} s (one-card results "
        f"{refs_s:.1f} s and files {write_s:.1f} s, beside the ranks' start "
        f"and builds; ranks {ranks_s:.1f} s from the spawn: {split})")
    if failed:
        (ROOT / "chiprun_out" / "dist_gnn_failed.json").write_text(
            json.dumps(ranks, indent=1, default=str))
        raise AssertionError("phase 17: " + "; ".join(failed))
    return dict(cut=cut, ell_scale=ell_scale, ell_sizes=sizes,
                ranks=DG_RANKS, backend="gloo", k=k, worst=worst,
                kernel_checks=kworst, launches_dist=launches_dist,
                timings=[g["timings"] for g in ranks],
                wires=[g["wires"] for g in ranks],
                wire_bytes=g0["wire_bytes"], staged_bytes=g0["staged_bytes"],
                peak_main_gb=[g["peak_main_gb"] for g in ranks],
                peak_gb=[g["peak_gb"] for g in ranks],
                ell_tile=g0["ell_tile"], sell_tile=g0["sell_tile"],
                band=g0["band"], sell_routes=g0["sell_routes"],
                refs_s=refs_s, write_s=write_s, ranks_s=ranks_s,
                split_s=split, seconds=seconds,
                pipeline=[{k: v for k, v in p.items()} for p in pps])


def d80_keys(case: dict) -> dict:
    """The kernels line's ``d80_*`` keys of a phase 15 (c) case (hubert's
    attention at head dim 80, non-causal)."""
    keys = ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_7_ms", "library_ms", "err_over_max",
            "row_err_over_row_max", "max_abs_err")
    return {f"d80_{k}": case.get(k) for k in keys}


def meta_keys(case: dict) -> dict:
    """The kernels line's ``meta_*`` keys of a phase 14 (b) case (hymba's
    sink attention)."""
    keys = ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "err_over_max", "row_err_over_row_max")
    return {f"meta_{k}": case.get(k) for k in keys}


def proteins_host() -> dict:
    """Phase 7's first host work, which needs no card: the ogbn-proteins
    dataset at PROTEINS_SCALE and its Â with the analytic tuner's
    statistics and pick. ``main`` runs it in a thread beside phase 11
    (it emits no span phase 11 reads: the analytic tuner's sweep instants
    only; the bundle, whose build emits ``tuning.plan``, is built in
    phase 7)."""
    from repro_torch.core import sparse as sp
    from repro_torch.core.autotune import autotune, graph_stats
    from repro_torch.data import make_dataset
    t0 = time.perf_counter()
    pds = make_dataset("ogbn-proteins", scale=PROTEINS_SCALE)
    split = {"dataset": time.perf_counter() - t0}
    a_norm = sp.gcn_normalize(pds.coo)
    stats = graph_stats(a_norm)
    would = autotune(a_norm, HIDDEN, stats=stats)
    split["normalize_tune"] = time.perf_counter() - t0 - sum(split.values())
    return dict(pds=pds, a_norm=a_norm, stats=stats, would=would,
                split=split)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import obs
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.build import KERNELS, build_kernels, build_log
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.serving import GNNServer
    from repro_torch.train.gnn_minibatch import make_block_model

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {}
    t_start = time.perf_counter()

    # -- phase 1: card and build ---------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    # phase 2's dataset is host work: it is made beside the build
    made: dict = {}

    def make_reddit():
        try:
            made["ds"] = make_dataset("reddit", scale=1)
        except BaseException as exc:        # re-raised in phase 2
            made["error"] = exc
        made["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    maker = threading.Thread(target=make_reddit, name="reddit")
    maker.start()
    per_kernel = build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{n} {s:.1f} s' for n, s in per_kernel.items())})")
    ptxas = {}
    for name in KERNELS:
        kops.load_kernel(name)
        ptxas[name] = ptxas_report(build_log(name))
        log(f"  ptxas {name}: {ptxas[name]}")
    new_fns = {fn: v for rep in ptxas.values() for fn, v in rep.items()
               if fn.startswith(NEW_KERNELS)}
    if not all(any(fn.startswith(k) for fn in new_fns) for k in NEW_KERNELS):
        raise AssertionError(f"ptxas reported no function of {NEW_KERNELS}: "
                             f"{sorted(new_fns)}")
    losses = [n for rep in ptxas.values() for n in rep["performance_loss"]]
    log(f"ptxas, this slice's kernels: {new_fns}; warnings "
        f"{[w for rep in ptxas.values() for w in rep['warnings']]}; "
        f"performance notes {losses}")
    serialised = [n for n in losses if n.split()[-1].startswith(NEW_KERNELS)]
    if serialised:
        raise AssertionError(f"ptxas serialises this slice's kernels: "
                             f"{serialised}")
    report["card"] = card
    report["ptxas"] = ptxas

    # -- phase 2: sampled serving at full width ------------------------------
    maker.join()
    if "error" in made:
        raise made["error"]
    ds = made["ds"]
    log(f"dataset reddit scale=1: {ds.num_nodes} nodes, {ds.coo.nse} edges, "
        f"{ds.num_features} features, {ds.num_classes} classes "
        f"({made['seconds']:.1f} s, beside the build)")
    init, _, _, dims = make_block_model(ARCH, ds.num_features, HIDDEN,
                                        ds.num_classes, len(FANOUTS))
    params = init(torch.Generator().manual_seed(0), device=DEVICE)
    Recording = make_recording_server(GNNServer)
    reqs = zipf_requests(np.random.default_rng(0), ds.num_nodes,
                         N_REQUESTS, REQ_SIZE)
    common = dict(arch=ARCH, fanouts=FANOUTS, tune=True, max_batch=32,
                  max_delay_s=0.005)
    on_card = dict(common, device=DEVICE)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)

    pinned = {"ell_spmm": False, "sell_spmm": False}
    db = None
    srv = Recording(params, ds, mode="sampled", cache_capacity=CACHE_ROWS,
                    **on_card)
    try:
        for attempt in range(2):
            kops.reset_kernel_launches()
            closed_loop(srv, reqs, CLIENTS)                  # warm-up volley
            log(f"warm-up volley: plans {srv.plan_cache.kinds()}, "
                f"launches {kops.kernel_launches()}")
            with srv._lock:
                srv.latencies_s.clear()
                srv.queue_waits_s.clear()
                srv.flush_sizes.clear()
            srv.records.clear()
            kops.reset_kernel_launches()
            with obs.profiled(ops=False) as tracer:
                wall = closed_loop(srv, reqs, CLIENTS)       # the main path
            launches = kops.kernel_launches()
            sell_routes = dict(getattr(kops._CUDA_WRAPPERS["sell_spmm"],
                                       "launches_by_instance", {}))
            missing = [n for n in SERVE_KERNELS if launches[n] == 0]
            if not missing or attempt:
                break
            # the tuner left a kernel unlaunched in this volley (the flush
            # sizes, so the buckets and their plans, follow the clients'
            # timing): pin layer 1 to it and serve both volleys again
            assert len(missing) == 1, launches
            kind_pin = "ell" if missing[0] == "ell_spmm" else "sell"
            pinned[missing[0]] = True
            srv.stop()
            db = pinned_plans_db(build_dir / "chip_smoke_tuning.json",
                                 kind_pin)
            srv = Recording(params, ds, mode="sampled",
                            cache_capacity=CACHE_ROWS, tuning_db=db,
                            **on_card)
            log(f"measured volley launched {launches}: pinned layer 1 to "
                f"{kind_pin}")
        st = srv.latency_stats()
        sampled_records = list(srv.records)
        spans = span_breakdown(tracer.snapshot(), len(sampled_records))
        busy = device_busy(srv, reqs[: N_REQUESTS // 4])
    finally:
        srv.stop()
    sampled = dict(requests=N_REQUESTS, clients=CLIENTS, req_size=REQ_SIZE,
                   wall_s=wall, qps=N_REQUESTS / wall, p50_ms=st["p50_ms"],
                   p99_ms=st["p99_ms"], mean_ms=st["mean_ms"],
                   hit_rate=st["cache_hit_rate"],
                   flushes=len(sampled_records),
                   mean_flush_size=st["mean_flush_size"],
                   plans=list(srv.plan_cache.kinds()), launches=launches,
                   sell_routes=sell_routes, spans_ms_per_flush=spans,
                   device=busy)
    log(f"sampled serving: p50 {st['p50_ms']:.3f} ms, p99 "
        f"{st['p99_ms']:.3f} ms, {sampled['qps']:.1f} QPS, cache hit rate "
        f"{st['cache_hit_rate']:.4f}, {len(sampled_records)} flushes of "
        f"{st['mean_flush_size']:.1f} seeds, launches {launches}, SELL by "
        f"route {sell_routes}")
    log("  per flush (ms, obs spans): " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))
    log(f"  device busy share {busy['busy_share']:.4f} over a "
        f"{busy['window_s']:.3f} s window ({busy['requests']} requests); "
        f"top kernels {busy['top']}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the serving "
                                 f"path ({launches})")

    cpu_params = {l: {k: v.cpu() for k, v in p.items()}
                  for l, p in params.items()}
    cpu_srv = GNNServer(cpu_params, ds, mode="sampled", cache_capacity=
                        CACHE_ROWS, device="cpu", start=False,
                        tuning_db=db, **common)
    t0 = time.perf_counter()
    checked = sampled_records[:: max(len(sampled_records) // 8, 1)][:8]
    if len(checked) < 8:
        raise AssertionError(f"only {len(checked)} flushes to recompute")
    worst = recompute_on_cpu(cpu_srv, checked, SERVE_TOL)
    sampled["cpu_check"] = dict(flushes=len(checked), max_abs_diff=worst)
    log(f"sampled: {len(checked)} flushes recomputed on the CPU, max |diff| "
        f"{worst:.3e} (atol 1e-4, rtol 1e-4) "
        f"({time.perf_counter() - t0:.1f} s)")
    report["sampled"] = sampled

    # -- phase 3: full-neighbor serving ---------------------------------------
    # popular (zipf) seeds, whose 2-hop neighborhoods run to millions of
    # edges, and uniform ones, small enough to recompute on the CPU
    frng = np.random.default_rng(1)
    full_reqs = zipf_requests(frng, ds.num_nodes, FULL_REQUESTS, 2) + [
        np.sort(frng.choice(ds.num_nodes, 2, replace=False))
        for _ in range(FULL_REQUESTS)]
    fsrv = Recording(params, ds, mode="full", cache_capacity=CACHE_ROWS,
                     start=False, tuning_db=db, **on_card)
    kops.reset_kernel_launches()
    t0 = time.perf_counter()
    for r in full_reqs:
        out = fsrv.predict(r, timeout=600.0)
        if out.shape != (2, ds.num_classes) or not np.isfinite(out).all():
            raise AssertionError(f"full-mode logits malformed: {out.shape}")
    full_launches = kops.kernel_launches()
    fsrv.stop()
    full_edges = [r["pbs"][0].nnz_real for r in fsrv.records]
    small = [r for r in fsrv.records if r["pbs"][0].nnz_real <= FULL_EDGE_CAP]
    fcpu = GNNServer(cpu_params, ds, mode="full", cache_capacity=CACHE_ROWS,
                     device="cpu", start=False, tuning_db=db, **common)
    fworst = recompute_on_cpu(fcpu, small, SERVE_TOL) if small else None
    report["full"] = dict(requests=len(full_reqs), outer_edges=full_edges,
                          plans=list(fsrv.plan_cache.kinds()),
                          launches=full_launches,
                          cpu_checked=len(small), max_abs_diff=fworst,
                          wall_s=time.perf_counter() - t0)
    log(f"full serving: {len(full_reqs)} requests, outer-block edges "
        f"{full_edges}, plans {fsrv.plan_cache.kinds()}, launches "
        f"{full_launches}; {len(small)} flush(es) with <= {FULL_EDGE_CAP} "
        f"outer edges recomputed on the CPU, max |diff| {fworst}")

    # -- phase 4: kernels against their plain versions on the card -----------
    from repro_torch.core import sparse as sp
    from repro_torch.sampling import pack_block
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    # (a) every block a recorded flush launched a kernel on, as served
    served = {"sampled": check_served(sampled_records, dims, gen),
              "full": check_served(fsrv.records, dims, gen)}
    for mode, counts in (("sampled", launches), ("full", full_launches)):
        checked = {n: served[mode].get(n, {}).get("operands", 0)
                   for n in SERVE_KERNELS}
        if checked != {n: counts[n] for n in SERVE_KERNELS} or \
                counts["bsr_spmm"]:
            raise AssertionError(f"{mode}: operands checked {checked} are "
                                 f"not the launches {counts}")
        log(f"served {mode} operands held against the plain versions: "
            f"{served[mode]}")
    report["served_checks"] = served

    def log_case(case):
        dev = case["device_ms"]
        log(f"  {case['name']:9s} {case['tag']:28s} nnz {case['nnz']:>9d} "
            f"ms {case['ms']:.4f} device "
            f"{'not measured' if dev is None else f'{dev:.4f}'} "
            f"plain {case['plain_ms']:.4f} bound {case['bound_ms']:.4f} "
            f"sparse.mm {case['library_ms']:.4f} "
            f"err {case['max_abs_err']:.2e} "
            f"(/bound {case['max_err_over_bound']:.3f})")

    # (b) per kernel, the largest block of the sampled run that launched it,
    # timed as served: the kernels line reports these
    main_cases = {}
    for name in SERVE_KERNELS:
        layer, pb = max(((l, pb) for r in sampled_records
                         for l, pb in enumerate(r["pbs"])
                         if operand(pb)[0] == name
                         and pb.plan_kind in ("ell", "sell")),
                        key=lambda lp: lp[1].nnz_real)
        k = dims[layer]
        tag = f"sampled/served/l{layer}/k{k}" + (
            f"/c{pb.sell.c}" if pb.plan_kind == "sell" else "")
        main_cases[name] = time_case(pb, k, tag, gen)
        log_case(main_cases[name])

    # (c) every plan on real flushes, packed into the flush's own buckets
    # as the server packs them
    biggest = max(sampled_records, key=lambda r: r["pbs"][0].nnz_real)
    by_size = sorted(fsrv.records, key=lambda r: r["pbs"][0].nnz_real)
    sources = [("sampled", biggest), ("full-small", by_size[0])]
    if len(by_size) > 1:
        sources.append(("full-big", by_size[-1]))
    cases = list(main_cases.values())
    for src_tag, rec in sources:
        for layer, (blk, bk, k) in enumerate(zip(
                rec["blocks"], rec["buckets"], dims[:-1])):
            plans = [KernelPlan(kind="sell", sell_c=c) for c in (8, 16, 32)]
            if bk.ell_width * bk.n_dst <= 1 << 26:
                plans.insert(0, KernelPlan(kind="ell"))
            for plan in plans:
                pb = sp.to_device(pack_block(
                    blk, n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                    plan=plan, ell_width=bk.ell_width,
                    sell_steps=bk.sell_steps), DEVICE)
                tag = f"{src_tag}/l{layer}/k{k}" + (
                    f"/c{plan.sell_c}" if plan.kind == "sell" else "")
                cases.append(time_case(pb, k, tag, gen))
                log_case(cases[-1])
                del pb
    report["cases"] = cases

    # -- phase 6: full-graph training on reddit at scale 1 -------------------
    from repro_torch.core.autotune import (H100, autotune,
                                           estimate_plan_time, graph_stats)
    from repro_torch.models.gnn import build_bundle
    t0 = time.perf_counter()
    bundle = build_bundle(ds, k_hint=HIDDEN, arch=ARCH).to(DEVICE)
    plan = bundle.tuned.plan
    log(f"reddit: bundle built in {time.perf_counter() - t0:.1f} s; tuned "
        f"plan {plan.kind} (C={plan.sell_c}, sigma={plan.sell_sigma}) at "
        f"K={HIDDEN}, predicted {plan.predicted_speedup:.2f}x over trusted; "
        f"max degree {int(bundle.tuned.degrees.max())} in A, "
        f"{int(bundle.tuned.degrees_t.max())} in A^T")
    train_pinned = plan.kind != "sell"
    if train_pinned:
        # the tuner left SELL off this path: pin it, as phase 2 pins ELL
        bundle = build_bundle(ds, k_hint=HIDDEN, arch=ARCH, plan=KernelPlan(
            kind="sell", sell_c=8, k_hint=HIDDEN)).to(DEVICE)
        log("reddit: pinned the plan to SELL C=8")
    reddit = train_phase("reddit", ds, ARCH, bundle, "sell_spmm")
    reddit["pinned"] = train_pinned
    reddit["cases"] = []
    g = bundle.tuned
    from repro_torch.kernels.sell_spmm import CHUNK_STEPS, split_chunks
    chunks = {"A": split_chunks(g.sell), "A^T": split_chunks(g.sell_t)}
    if reddit["launches_by_route"] != {"row": 0,
                                       "split": reddit["launches"]} or \
            not all(chunks.values()):
        raise AssertionError(f"reddit: SELL launches by route "
                             f"{reddit['launches_by_route']} of "
                             f"{reddit['launches']}, split chunks {chunks}: "
                             f"every launch must cut the hub slices")
    reddit.update(split_chunks=chunks, chunk_steps=CHUNK_STEPS)
    log(f"reddit: every SELL launch took the split route "
        f"{reddit['launches_by_route']}; slices longer than {CHUNK_STEPS} "
        f"steps cut into {chunks['A']} chunks in A ({g.sell.n_steps} steps, "
        f"{g.sell.nslices} slices), {chunks['A^T']} in A^T; largest "
        f"workspace {reddit['workspace_bytes'] / 1e6:.1f} MB")
    for a, coo, k, tag in ((g.sell, g.coo, ds.num_features, "A"),
                           (g.sell, g.coo, HIDDEN, "A"),
                           (g.sell_t, g.coo_t, HIDDEN, "A^T")):
        reddit["cases"].append(time_full("sell_spmm", a, coo, k,
                                         f"reddit/{tag}/k{k}", gen))
        log_case(reddit["cases"][-1])
    report["train_reddit"] = reddit
    del bundle, g, a, coo
    torch.cuda.empty_cache()

    # -- phase 8: device-sampled minibatch training on reddit, which is also
    # phase 13 (a)'s clean run --------------------------------------------
    ft_dir = out_dir / "phase13_ckpt"
    shutil.rmtree(ft_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        minibatch = minibatch_phase(ds, ft_dir / "clean")
        minibatch["seconds"] = time.perf_counter() - t0
        log(f"minibatch phase: {minibatch['seconds']:.1f} s")
        clean_run = minibatch.pop("clean_run")
        report["train_minibatch"] = minibatch

        # -- phase 13 (a-c): fault tolerance at phase 8's cell ---------------
        fault = fault_phase(ds, ft_dir, clean_run)
        del clean_run
    finally:
        shutil.rmtree(ft_dir, ignore_errors=True)
    log(f"fault phase: {fault['seconds']:.1f} s")
    report["fault_tolerance"] = fault

    # -- phase 11 (a, b, d, e): measured tuning on reddit ------------------
    # phase 7's host work runs beside it (it needs no card)
    prep: dict = {}

    def prepare_proteins():
        try:
            prep.update(proteins_host())
        except BaseException as exc:        # re-raised in phase 7
            prep["error"] = exc

    prep_thread = threading.Thread(target=prepare_proteins,
                                   name="proteins-host")
    prep_thread.start()
    log("phase 11: measured tuning (CUDA events over the hand kernels; "
        "estimates from the H100 model)")
    tuning = tuning_phase(ds, gen)
    log(f"phase 11 on reddit: {tuning['seconds']:.1f} s")
    torch.cuda.empty_cache()    # reddit's host arrays stay for phase 16

    # -- phase 7: full-graph training on ogbn-proteins, BSR pinned -----------
    t0 = time.perf_counter()
    prep_thread.join()
    if "error" in prep:
        raise prep["error"]
    pds, a_norm, stats, would = (prep.pop(k) for k in ("pds", "a_norm",
                                                      "stats", "would"))
    split = prep.pop("split")
    split["waited"] = time.perf_counter() - t0
    from repro_torch.kernels.bsr_spmm import K_TILE
    bsr_plan = KernelPlan(kind="bsr", br=128, bc=128, fk=K_TILE,
                          k_hint=HIDDEN)
    cut = (f"ogbn-proteins at scale 1/{round(1 / PROTEINS_SCALE)} "
           f"({pds.num_nodes} nodes, {pds.coo.nse} edges): the GCN "
           f"bundle's two 128x128 BSR operands (Â, Â^T) must fit the "
           f"card's memory, ~51 GB each at scale 1")
    log(f"cut: {cut}")
    # phase 11 (c): the measured pass on Â, before the pinned bundle
    tuning["proteins"] = proteins_tuning(a_norm, stats, tuning)
    split["measured_pass"] = time.perf_counter() - t0 - split["waited"]
    del a_norm
    est_would = estimate_plan_time(stats, HIDDEN, would, H100)
    est_bsr = estimate_plan_time(stats, HIDDEN, bsr_plan, H100)
    log(f"proteins: the tuner would pick {would.kind} "
        f"(br={would.br}, bc={would.bc}, C={would.sell_c}) for Â at "
        f"K={HIDDEN}, estimated {est_would * 1e3:.3f} ms, against "
        f"{est_bsr * 1e3:.3f} ms for the pinned bsr 128x128 (split TF32 "
        f"at {H100.bsr_flops / 1e12:.0f} TFLOP/s)")
    t1 = time.perf_counter()
    bundle = build_bundle(pds, k_hint=HIDDEN, plan=bsr_plan, arch="gcn")
    split["build"] = time.perf_counter() - t1
    bundle = bundle.to(DEVICE)
    torch.cuda.synchronize()
    split["move"] = time.perf_counter() - t1 - split["build"]
    g = bundle.tuned_norm
    log(f"proteins: {pds.num_nodes} nodes, {pds.coo.nse} edges, "
        f"{pds.num_features} features, {pds.num_classes} classes; Â has "
        f"{g.bsr.nblocks} tiles of 128x128 ({g.bsr.density:.4f} of all, "
        f"{g.bsr.blocks.numel() * 4 / 1e9:.2f} GB), built and moved in "
        f"{time.perf_counter() - t0:.1f} s, the dataset and Â made beside "
        f"phase 11 ({ {k: round(v, 1) for k, v in split.items()} })")
    torch.cuda.reset_peak_memory_stats()
    proteins = train_phase("proteins", pds, "gcn", bundle, "bsr_spmm")
    proteins["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"proteins: peak device memory {proteins['peak_gb']:.2f} GB")
    proteins.update(cut=cut, pinned=True, tuner_pick=would.to_json(),
                    tuner_est_ms=est_would * 1e3,
                    pinned_est_ms=est_bsr * 1e3, tiles=g.bsr.nblocks,
                    cases=[])
    for a, coo, k, tag in ((g.bsr, g.coo, HIDDEN, "Â"),
                           (g.bsr, g.coo, pds.num_classes, "Â"),
                           (g.bsr_t, g.coo_t, HIDDEN, "Â^T")):
        proteins["cases"].append(time_full("bsr_spmm", a, coo, k,
                                           f"proteins/{tag}/k{k}", gen))
        log_case(proteins["cases"][-1])
        last = proteins["cases"][-1]
        log(f"    dense tile work bound {last['bound_tile_ms']:.4f} ms fp32, "
            f"{last['bound_tc_ms']:.4f} ms TF32, "
            f"{last['bound_split_tf32_ms']:.4f} ms split TF32; hᵀ pre-pass "
            f"{last['prepass_ms']:.4f} ms; err/bound "
            f"{last['max_err_over_bound']:.4f}")
    report["train_proteins"] = proteins
    mp = tuning["proteins"]
    timed = {c["name"]: c for c in mp["candidates"]}
    log(f"phase 11 (c) proteins Â K={HIDDEN}: measured pick "
        f"{mp['measured_pick']} {timed[mp['measured_pick']]['ms']:.4f} ms; "
        f"phase 7's pinned bsr128x128 {proteins['cases'][0]['ms']:.4f} ms; "
        f"analytic pick {mp['analytic_pick']} estimated "
        f"{timed[mp['analytic_pick']]['est_ms']:.4f} ms, measured "
        f"{timed[mp['analytic_pick']]['ms']:.4f} ms "
        f"({mp['seconds']:.1f} s)")
    tuning["proteins"]["pinned_bsr_ms"] = proteins["cases"][0]["ms"]
    log(f"phase 11: {tuning['seconds']:.1f} s in all; launches in the "
        f"measured passes {tuning['launches']}")
    report["measured_tuning"] = tuning
    del bundle, g, a, coo, pds
    torch.cuda.empty_cache()

    # -- phase 9: full-graph GAT training through FusedMM --------------------
    t0 = time.perf_counter()
    gat = gat_phase()
    gat["seconds"] = time.perf_counter() - t0
    log(f"gat phase: {gat['seconds']:.1f} s")
    report["train_gat"] = gat
    torch.cuda.empty_cache()

    # -- phase 10: LM serving of phi3.5-moe at full width --------------------
    t0 = time.perf_counter()
    lmr = lm_phase()
    lmr["seconds"] = time.perf_counter() - t0
    log(f"lm phase: {lmr['seconds']:.1f} s")
    report["serve_lm"] = lmr
    torch.cuda.empty_cache()

    # -- phase 12: LM training of phi3.5-moe and gemma-7b at full width -------
    lmt = lm_train_phase()
    log(f"lm train phase: {lmt['seconds']:.1f} s")
    report["train_lm"] = lmt
    torch.cuda.empty_cache()

    # -- phase 14: the ssm and hybrid families (mamba2-1.3b, hymba-1.5b) -----
    ssm = ssm_phase()
    log(f"ssm phase: {ssm['seconds']:.1f} s")
    report["ssm_hybrid"] = ssm
    torch.cuda.empty_cache()

    # -- phase 15: the audio and vlm front ends (hubert-xlarge, internvl2-2b)
    front = frontends_phase()
    log(f"front-ends phase: {front['seconds']:.1f} s")
    report["frontends"] = front
    torch.cuda.empty_cache()

    # -- phase 16: data parallelism, two ranks on the one card; then, in the
    # same two ranks, phase 18: tensor and expert parallelism over 'model'
    dp = dp_phase(ds, minibatch["result"]["probed_caps"])
    report["data_parallel"] = dp
    torch.cuda.empty_cache()

    # -- phase 17: distributed GNN message passing, four ranks on the card --
    dg = dg_phase(ds)
    report["dist_gnn"] = dg
    del ds
    torch.cuda.empty_cache()

    # -- phase 19: the manual expert-parallel MoE, sixteen model ranks ------
    ep = ep_phase()
    report["expert_parallel"] = ep
    torch.cuda.empty_cache()

    # -- phase 5: the kernels line ------------------------------------------
    kernels = []
    for name in SAMPLE_KERNELS + (HOP_KERNEL,):
        rep = max((c for c in minibatch["kernel_cases"] if c["name"] == name),
                  key=lambda c: c["f"] * c["width"])
        entry = dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=minibatch["launches"][name], max_abs_err=0.0,
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], host_us=rep["host_us"],
            shape=f"hop{rep['hop']}/{rep['f']}x{rep['width']}/{rep['dtype']}",
            launches_per_step=minibatch["launches_per_step"][name])
        if name == HOP_KERNEL:
            entry["unfused_hop_ms"] = rep["unfused_hop_ms"]
        else:
            # the main path runs each hop as one sample_hop launch; this
            # kernel is checked and timed on that hop's plain intermediates
            entry["main_path_via"] = HOP_KERNEL
        kernels.append(entry)
    seg = gat["segment_sum_case"]
    kernels.append(dict(
        name="segment_sum", route="cuda", **KERNEL_META["segment_sum"],
        launches=minibatch["launches"]["segment_sum"]
        + gat["segment_sum_launches"],
        launches_minibatch=minibatch["launches"]["segment_sum"],
        launches_gat=gat["segment_sum_launches"],
        max_abs_err=max(seg["max_abs_err"], max(
            b["max_abs_err"] for b in minibatch["backward_checks"])),
        max_err_over_bound=seg["max_err_over_bound"], ms=seg["ms"],
        device_ms=seg["device_ms"], plain_ms=seg["plain_ms"],
        bound_ms=seg["bound_ms"], bound_by=seg["bound_by"],
        library_ms=seg["library_ms"], shape=seg["tag"],
        k112_ms=seg["k112"]["ms"],
        k112_library_ms=seg["k112"]["library_ms"],
        k112_bound_ms=seg["k112"]["bound_ms"]))
    ec = gat["edge_dots_case"]
    kernels.append(dict(
        name="edge_dots", route="cuda", **KERNEL_META["edge_dots"],
        launches=gat["edge_dots_launches"],
        launches_first_step=gat["edge_dots_step_launches"],
        max_abs_err=max([ec[w]["max_abs_err"] for w in ("single", "dual")]
                        + [c["max_abs_err"] for c in gat["edge_dots_checks"]]),
        max_err_over_bound=max(
            [ec[w]["max_err_over_bound"] for w in ("single", "dual")] +
            [c["max_err_over_bound"] for c in gat["edge_dots_checks"]]),
        ms=ec["dual"]["ms"], device_ms=ec["dual"]["device_ms"],
        plain_ms=ec["dual"]["plain_ms"], bound_ms=ec["dual"]["bound_ms"],
        bound_by=ec["dual"]["bound_by"], library_ms=ec["dual"]["library_ms"],
        single_ms=ec["single"]["ms"], single_bound_ms=ec["single"]["bound_ms"],
        single_plain_ms=ec["single"]["plain_ms"],
        single_library_ms=ec["single"]["library_ms"],
        shape=f"gat A/{ec['edges']} edges/d{ec['d']} dual (library: two "
              f"sampled_addmm)"))
    for name in ("ell_spmm", "sell_spmm", "bsr_spmm"):
        if name == "bsr_spmm":
            rep = proteins["cases"][0]
            kernels.append(dict(
                name=name, route="cuda", **KERNEL_META[name],
                launches=proteins["launches"],
                max_abs_err=max([c["max_abs_err"]
                                 for c in proteins["cases"]] +
                                [o["max_abs_err"]
                                 for o in proteins["operand_checks"]]),
                ms=rep["ms"], device_ms=rep["device_ms"],
                plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                bound_by=rep["bound_by"], bound_tile_ms=rep["bound_tile_ms"],
                bound_tc_ms=rep["bound_tc_ms"],
                bound_split_tf32_ms=rep["bound_split_tf32_ms"],
                prepass_ms=rep["prepass_ms"],
                max_err_over_bound=max(
                    [c["max_err_over_bound"] for c in proteins["cases"]] +
                    [o["max_err_over_bound"]
                     for o in proteins["operand_checks"]]),
                library_ms=rep["library_ms"], shape=rep["tag"],
                launches_fwd=proteins["launches_fwd"],
                launches_bwd=proteins["launches_bwd"], pinned=True))
            continue
        rep = main_cases[name]
        entry = dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=launches[name],
            max_abs_err=max([c["max_abs_err"] for c in cases
                             if c["name"] == name] +
                            [st[name]["max_abs_err"]
                             for st in served.values() if name in st]),
            ms=rep["ms"], device_ms=rep["device_ms"],
            plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], shape=rep["tag"],
            launches_full=full_launches[name], pinned=pinned[name])
        if name == "sell_spmm":
            entry["launches_minibatch"] = minibatch["launches"][name]
        if name == "ell_spmm":
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]] +
                [e["max_abs_err"] for e in minibatch["ell_checks"]])
            entry.update(launches_minibatch=minibatch["launches"][name],
                         launches_minibatch_per_step=minibatch[
                             "launches_per_step"][name])
        if name == "sell_spmm":
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]] +
                [c["max_abs_err"] for c in reddit["cases"]] +
                [o["max_abs_err"] for o in reddit["operand_checks"]] +
                [minibatch["inference_sell_checks"]["max_abs_err"]])
            routes = {r: sampled["sell_routes"].get(r, 0)
                      + reddit["launches_by_route"].get(r, 0)
                      for r in ("row", "split")}
            entry.update(launches_train=reddit["launches"],
                         launches_train_fwd=reddit["launches_fwd"],
                         launches_train_bwd=reddit["launches_bwd"],
                         instance="/".join(r for r, v in routes.items() if v),
                         launches_by_route=dict(
                             serving=sampled["sell_routes"],
                             train=reddit["launches_by_route"]),
                         split_chunks=reddit["split_chunks"],
                         workspace_bytes=reddit["workspace_bytes"],
                         train_ms=reddit["cases"][0]["ms"],
                         train_bound_ms=reddit["cases"][0]["bound_ms"],
                         train_library_ms=reddit["cases"][0]["library_ms"])
        kernels.append(entry)
    for name in ("sddmm_bsr", "fusedmm_bsr"):
        own = [c for c in gat["cases"] if c["name"] == name]
        rep = own[0]
        entry = dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=gat["launches" if name == "fusedmm_bsr"
                         else "sddmm_launches"],
            max_abs_err=max([c["max_abs_err"] for c in own] +
                            ([c["max_abs_err"] for c in gat["step_checks"]]
                             if name == "fusedmm_bsr" else [])),
            ms=rep["ms"], device_ms=rep["device_ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], bound_tile_ms=rep["bound_tile_ms"],
            bound_tc_ms=rep["bound_tc_ms"], bound_edge_ms=rep["bound_edge_ms"],
            library_ms=rep["library_ms"], shape=rep["tag"], pinned=True)
        if name == "sddmm_bsr":
            tile = next(c for c in own if c["instance"] == "tile")
            entry.update(instance=rep["instance"], unscaled_ms=tile["ms"],
                         unscaled_bound_ms=tile["bound_ms"],
                         unscaled_plain_ms=tile["plain_ms"],
                         unscaled_library_ms=tile["library_ms"])
        else:
            entry.update(instance="edge",
                         tiles_by_route=gat["tiles_by_route"]["main_path"])
        kernels.append(entry)
    for name in LM_KERNELS:
        rep = lmr["cases"]["prefill gate D->F" if name == "ragged_gemm"
                           else "prefill attention"]
        entry = dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=sum(c[name] for c in lmr["launches"].values()),
            max_abs_err=lmr["worst_abs_err"][name],
            err_over_max_plain=lmr["worst_err_over_max"][name],
            row_err_over_row_max=lmr["worst_row_err_over_row_max"][name],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], shape=f"{rep['tag']} {rep['shape']}",
            launches_prefill=lmr["launches"]["prefill"][name],
            launches_decode=lmr["launches"]["decode_1"][name]
            + lmr["launches"]["decode_rest"][name], host_us=rep["host_us"])
        gt = lmt["gemma_train"]
        entry["launches_train"] = lmt["launches"][name] + gt["launches"][name]
        entry["launches_train_gemma"] = gt["launches"][name]
        entry["launches"] += entry["launches_train"]
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [
            c["max_abs_err"] for c in lmt["checks"] + gt["checks"]
            if c["name"] == name])
        # phase 14: the ssm / hybrid models' serving and training launches
        entry["launches_ssm_serve"] = sum(
            r["launches"]["launches"][name] for r in ssm["serve"].values())
        entry["launches_ssm_train"] = sum(
            r["launches"][name] for r in ssm["train"].values())
        entry["launches"] += entry["launches_ssm_serve"] + \
            entry["launches_ssm_train"]
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [
            c["max_abs_err"] for r in ssm["train"].values()
            for c in r["checks"] if c["name"] == name] + (
            [r["max_abs_err"] for r in ssm["serve"].values()]
            if name == "flash_attention" else []))
        # phase 15: the front ends' serving and training launches
        entry["launches_frontends_serve"] = sum(
            r["launches"]["launches"][name] for r in front["serve"].values())
        entry["launches_frontends_train"] = sum(
            r["launches"][name] for r in front["train"].values())
        entry["launches"] += entry["launches_frontends_serve"] + \
            entry["launches_frontends_train"]
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [
            c["max_abs_err"] for r in front["train"].values()
            for c in r["checks"] if c["name"] == name] + (
            [r["max_abs_err"] for r in front["serve"].values()]
            if name == "flash_attention" else []))
        if name == "ragged_gemm":
            entry["instance"] = "/".join(
                k for k, v in lmr["ragged_instances"]["prefill"].items() if v)
            dx = lmt["dx_case"]
            entry.update(launches_train_dx=lmt["ragged_by_direction"][
                "backward"], dx_shape=dx["shape"], dx_ms=dx["ms"],
                dx_device_ms=dx["device_ms"], dx_plain_ms=dx["plain_ms"],
                dx_bound_ms=dx["bound_ms"], dx_library_ms=dx["library_ms"])
        else:
            g = lmt["gemma_attention"]["forward"]
            entry.update(d256_shape=g["shape"], d256_ms=g["ms"],
                         d256_plain_ms=g["plain_ms"],
                         d256_bound_ms=g["bound_ms"],
                         d256_library_ms=g["library_ms"],
                         d256_err_over_max=g["err_over_max"])
            entry.update(meta_keys(ssm["sink_attention"]["forward"]),
                         meta_max_abs_err=ssm["sink_attention"]["forward"][
                             "max_abs_err"])
            entry.update(d80_keys(front["attention"]["forward"]))
        kernels.append(entry)
    bwd = lmt["flash_bwd_case"]
    gt = lmt["gemma_train"]
    g256 = lmt["gemma_attention"]["backward"]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        **KERNEL_META["flash_attention_bwd"],
        launches=lmt["launches"]["flash_attention_bwd"]
        + gt["launches"]["flash_attention_bwd"],
        launches_phi=lmt["launches"]["flash_attention_bwd"],
        launches_gemma=gt["launches"]["flash_attention_bwd"],
        max_abs_err=max(c["max_abs_err"] for c in lmt["checks"] + gt["checks"]
                        if c["name"] == "flash_attention_bwd"),
        err_over_max_plain=max(
            lmt["worst_err_over_max"]["flash_attention_bwd"],
            gt["worst_err_over_max"]["flash_attention_bwd"]),
        ms=bwd["ms"], device_ms=bwd["device_ms"], plain_ms=bwd["plain_ms"],
        bound_ms=bwd["bound_ms"], bound_by=bwd["bound_by"],
        bound_7_ms=bwd["bound_7_ms"], library_ms=bwd["library_ms"],
        shape=bwd["shape"], instance="wgmma",
        launches_by_instance={
            k: v + gt["flash_bwd_instances"][k]
            for k, v in lmt["flash_bwd_instances"].items()},
        d256_shape=g256["shape"], d256_instance=g256["instance"],
        d256_ms=g256["ms"], d256_device_ms=g256["device_ms"],
        d256_kernel_device_ms=g256["kernel_device_ms"],
        d256_step_kernel_device_ms=gt["bwd_device_ms"],
        d256_plain_ms=g256["plain_ms"], d256_bound_ms=g256["bound_ms"],
        d256_bound_7_ms=g256["bound_7_ms"],
        d256_library_ms=g256["library_ms"],
        d256_err_over_max=max(g256["err_over_max"], gt["worst_err_over_max"][
            "flash_attention_bwd"]),
        d256_row_err_over_row_max=max(
            g256["row_err_over_row_max"],
            gt["worst_row"]["flash_attention_bwd"]),
        **meta_keys(ssm["sink_attention"]["backward"])))
    bwd_entry = kernels[-1]
    ssm_bwd = [c for r in ssm["train"].values() for c in r["checks"]
               if c["name"] == "flash_attention_bwd"]
    bwd_entry["launches_ssm_train"] = sum(
        r["launches"]["flash_attention_bwd"] for r in ssm["train"].values())
    bwd_entry["launches"] += bwd_entry["launches_ssm_train"]
    bwd_entry["max_abs_err"] = max(
        [bwd_entry["max_abs_err"], ssm["sink_attention"]["backward"][
            "max_abs_err"]] + [c["max_abs_err"] for c in ssm_bwd])
    for k, v in ssm["train"]["hymba-1.5b"]["flash_bwd_instances"].items():
        bwd_entry["launches_by_instance"][k] += v
    front_bwd = [c for r in front["train"].values() for c in r["checks"]
                 if c["name"] == "flash_attention_bwd"]
    bwd_entry["launches_frontends_train"] = sum(
        r["launches"]["flash_attention_bwd"] for r in front["train"].values())
    bwd_entry["launches"] += bwd_entry["launches_frontends_train"]
    bwd_entry["max_abs_err"] = max(
        [bwd_entry["max_abs_err"], front["attention"]["backward"][
            "max_abs_err"]] + [c["max_abs_err"] for c in front_bwd])
    for r in front["train"].values():
        for k, v in r["flash_bwd_instances"].items():
            bwd_entry["launches_by_instance"][k] += v
    hb = front["attention"]["backward"]
    bwd_entry.update(d80_keys(hb), d80_kernel_device_ms=hb[
        "kernel_device_ms"], d80_bound_7_ms=hb["bound_7_ms"])
    for entry in kernels:       # phase 11: launches inside the timed passes
        entry["launches_measured_tuning"] = tuning["launches"].get(
            entry["name"], 0)
    resumed = fault["kill_resume"]
    for entry in kernels:       # phase 13 (a): the resumed run's launches
        n = resumed["launches"].get(entry["name"], 0)
        entry["launches_resume"] = n
        entry["launches"] += n
        check = resumed["checks"].get(entry["name"])
        if isinstance(check, dict):
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       check["max_abs_err"])
    for entry in kernels:       # phase 16: the two ranks' launches
        n = dp["launches_dp"].get(entry["name"], 0)
        entry["launches_dp"] = n
        entry["launches"] += n
        if entry["name"] in dp["lm_worst_err_over_max"]:
            entry["err_over_max_plain"] = max(
                entry.get("err_over_max_plain", 0.0),
                dp["lm_worst_err_over_max"][entry["name"]])
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       dp["lm_worst_abs_err"][entry["name"]])
    tpr = dp["tp"]
    report["tensor_parallel"] = tpr
    for entry in kernels:       # phase 18: the two model ranks' launches
        n = tpr["launches_tp"].get(entry["name"], 0)
        entry["launches_tp"] = n
        entry["launches"] += n
        if entry["name"] in tpr["worst_err_over_max"]:
            entry["err_over_max_plain"] = max(
                entry.get("err_over_max_plain", 0.0),
                tpr["worst_err_over_max"][entry["name"]])
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       tpr["worst_abs_err"][entry["name"]])
    for entry in kernels:       # phase 17: the four ranks' launches
        n = dg["launches_dist"].get(entry["name"], 0)
        entry["launches_dist"] = n
        entry["launches"] += n
        if entry["name"] in dg["kernel_checks"]:
            kc = dg["kernel_checks"][entry["name"]]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       kc["max_abs_err"])
            entry["dist_shape"] = kc["shape"]
    for entry in kernels:       # phase 19: the sixteen model ranks' launches
        n = ep["launches_ep"].get(entry["name"], 0)
        entry["launches_ep"] = n
        entry["launches"] += n
        if entry["name"] in ep["worst_err_over_max"]:
            entry["err_over_max_plain"] = max(
                entry.get("err_over_max_plain", 0.0),
                ep["worst_err_over_max"][entry["name"]])
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       ep["worst_abs_err"][entry["name"]])
        # phase 17's pipeline: plain products, no hand kernel (counted all
        # the same, zeroed just before it and read just after)
        n = sum(p["launches"].get(entry["name"], 0) for p in dg["pipeline"])
        entry["launches_pp"] = n
        entry["launches"] += n
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"chip_smoke: {report['seconds']:.1f} s in all, the build included "
        f"({report['seconds'] / 1200:.1%} of a 1,200 s limit)")
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
